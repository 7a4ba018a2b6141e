"""Backward reachability of detector-relevant sites.

Every PC gets a uint32 mask: bit i is set when an instruction of
anchor-opcode class i is reachable (including the instruction AT the
pc). The anchor universe is the fixed set of opcodes at which any
built-in detection module can mint an Issue or PotentialIssue; the
per-module anchor sets below keep only the ISSUE-PRODUCING hooks —
annotation-maintaining hooks (e.g. the Exceptions module's JUMP
tracker) are excluded, which is sound because a dropped annotation can
only matter at an issue-producing site, and those carry their own bit.

Bit 31 is reserved: OPEN-STATE TERMINATOR — a STOP/RETURN/SELFDESTRUCT
is reachable, i.e. the path can still end a transaction successfully
and mint a world state that seeds later rounds (and discharges pending
PotentialIssues). A lane may only retire when its detector mask is
dead AND either no terminator is reachable or no later round will run
(and nothing is pending) — see docs/static_pass.md for the full
soundness argument.
"""

from typing import Dict, Iterable, List

import numpy as np

from .cfg import CFG

#: anchor-opcode universe -> bit index (<= 31 entries; bit 31 reserved)
OP_BITS: Dict[str, int] = {op: i for i, op in enumerate((
    "CALL", "CALLCODE", "DELEGATECALL", "STATICCALL",
    "SELFDESTRUCT", "CREATE", "CREATE2",
    "SSTORE", "SLOAD",
    "ORIGIN", "TIMESTAMP", "NUMBER", "COINBASE", "DIFFICULTY",
    "GASLIMIT", "BLOCKHASH",
    "JUMP", "JUMPI",
    "LOG1", "MSTORE",
    "STOP", "RETURN", "REVERT", "INVALID",
    "ADD", "SUB", "MUL", "EXP",
))}

TERMINATOR_BIT = np.uint32(1 << 31)
ALL_BITS = np.uint32(0xFFFFFFFF)

_TERMINATORS = ("STOP", "RETURN", "SELFDESTRUCT")

#: issue-producing opcodes per module class name. Derived from the
#: modules' hook lists minus the annotation-only hooks; a module
#: missing here (user-registered) falls back to its declared hooks,
#: and any hook outside OP_BITS makes that module's mask ALL_BITS
#: (it can then never be declared statically dead — conservative).
MODULE_ANCHORS: Dict[str, tuple] = {
    "ArbitraryJump": ("JUMP", "JUMPI"),
    "ArbitraryStorage": ("SSTORE",),
    "ArbitraryDelegateCall": ("DELEGATECALL",),
    "TxOrigin": ("JUMPI",),
    "PredictableVariables": ("JUMPI", "BLOCKHASH"),
    "EtherThief": ("CALL", "STATICCALL"),
    "Exceptions": ("INVALID", "REVERT"),
    "ExternalCalls": ("CALL",),
    "IntegerArithmetics": ("SSTORE", "JUMPI", "STOP", "RETURN",
                           "CALL"),
    "MultipleSends": ("CALL", "DELEGATECALL", "STATICCALL",
                      "CALLCODE", "RETURN", "STOP"),
    "AccidentallyKillable": ("SELFDESTRUCT",),
    "UnboundedLoopGas": ("JUMPI",),
    "UncheckedRetval": ("STOP", "RETURN"),
    "UserAssertions": ("LOG1", "MSTORE"),
}


def bits_for_ops(ops: Iterable[str]) -> np.uint32:
    """OR of the anchor bits for `ops`; an op outside the universe
    yields ALL_BITS (the caller can never prove it dead)."""
    mask = np.uint32(0)
    for op in ops:
        bit = OP_BITS.get(op)
        if bit is None:
            return ALL_BITS
        mask |= np.uint32(1 << bit)
    return mask


def active_mask_for_modules(modules) -> np.uint32:
    """The run's active-detector mask: OR over the loaded modules'
    anchor sets."""
    mask = np.uint32(0)
    for m in modules:
        name = type(m).__name__
        anchors = MODULE_ANCHORS.get(name)
        if anchors is None:
            anchors = tuple(getattr(m, "pre_hooks", None) or ()) \
                + tuple(getattr(m, "post_hooks", None) or ())
        mask |= bits_for_ops(anchors)
    return mask


def _gen_bits(op: str) -> np.uint32:
    mask = np.uint32(0)
    bit = OP_BITS.get(op)
    if bit is not None:
        mask |= np.uint32(1 << bit)
    if op in _TERMINATORS:
        mask |= TERMINATOR_BIT
    return mask


def _site_bits(ins, drops) -> np.uint32:
    """Gen bits of one instruction minus any taint-refinement drops at
    its site (drops never touch TERMINATOR_BIT — only anchor-op bits
    the refinement rules cleared)."""
    g = _gen_bits(ins.op)
    if drops:
        d = drops.get(ins.pc)
        if d:
            g = np.uint32(g & ~np.uint32(d & ~int(TERMINATOR_BIT)))
    return g


def reach_mask(code: bytes, cfg: CFG, drops=None) -> np.ndarray:
    """(len(code)+1,) uint32 table of reachable anchor classes per PC.

    Non-instruction offsets (bytes inside PUSH immediates) hold
    ALL_BITS — no lane legitimately sits there, and an illegitimate
    one must never be retired on a garbage lookup. Index len(code) is
    the implicit trailing STOP.

    ``drops`` ({byte pc: uint32 bits to clear from that site's gen
    set}) is the taint-refinement hook (taint.py / refined_mask): a
    site whose trigger operands are provably attacker-independent
    stops generating its anchor bit, and the backward fixpoint then
    computes reachability of *influenceable* anchors only."""
    n = len(code)
    table = np.full(n + 1, ALL_BITS, dtype=np.uint32)
    table[n] = _gen_bits("STOP")
    if not cfg.blocks:
        return table

    nb = len(cfg.blocks)
    gen = np.zeros(nb, dtype=np.uint32)
    for bi, block in enumerate(cfg.blocks):
        g = np.uint32(0)
        for ins in block.instrs:
            g |= _site_bits(ins, drops)
        # a block that runs off the end of code executes the implicit
        # STOP (blocks.recover_blocks gives it no successors)
        if not cfg.succ[bi] and block.last.op not in (
                "JUMP", "JUMPI", "RETURN", "REVERT", "INVALID",
                "SELFDESTRUCT", "STOP"):
            g |= _gen_bits("STOP")
        gen[bi] = g

    # block-level backward fixpoint: in[b] = gen[b] | OR(in[succ(b)])
    inm = gen.copy()
    changed = True
    while changed:
        changed = False
        for bi in range(nb - 1, -1, -1):
            out = np.uint32(0)
            for si in cfg.succ[bi]:
                out |= inm[si]
            new = gen[bi] | out
            if new != inm[bi]:
                inm[bi] = new
                changed = True

    # per-pc refinement: scan each block backward from its successors'
    # joined mask
    for bi, block in enumerate(cfg.blocks):
        out = np.uint32(0)
        for si in cfg.succ[bi]:
            out |= inm[si]
        if gen[bi] & _gen_bits("STOP") and not cfg.succ[bi] \
                and block.last.op not in ("JUMP", "JUMPI", "RETURN",
                                          "REVERT", "INVALID",
                                          "SELFDESTRUCT", "STOP"):
            out |= _gen_bits("STOP")
        mask = out
        for ins in reversed(block.instrs):
            mask = mask | _site_bits(ins, drops)
            table[ins.pc] = mask
    return table


# -- taint-refined planes ----------------------------------------------------


def refinable(module_names) -> bool:
    """May the taint-refined plane serve this active-module set? Only
    when every module's anchor semantics are known (MODULE_ANCHORS):
    an unknown module could anchor on JUMP/JUMPI with a trigger
    predicate the refinement rules do not model."""
    return all(name in MODULE_ANCHORS for name in module_names)


def refinement_drops(cfg: CFG, sites, module_names) -> dict:
    """{byte pc: uint32 bits to clear} for the active-module set: an
    anchor-op bit drops at a site when NO active module anchored on
    that op can fire there under the converged operand taints
    (taint.module_can_fire). Requires ``refinable(module_names)``."""
    from . import taint as taint_mod

    drops = {}
    anchored = {}  # op -> [module names anchored on it]
    for name in module_names:
        for op in MODULE_ANCHORS.get(name, ()):
            anchored.setdefault(op, []).append(name)
    for block in cfg.blocks:
        last = block.last
        if last.op not in ("JUMP", "JUMPI"):
            continue
        st = sites.get(last.pc)
        if st is None:
            continue
        mods = anchored.get(last.op)
        if not mods:
            continue
        if not any(taint_mod.module_can_fire(m, last.op, st)
                   for m in mods):
            drops[last.pc] = int(1 << OP_BITS[last.op])
    return drops
