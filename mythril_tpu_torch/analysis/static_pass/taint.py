"""Per-PC taint dataflow: which anchor sites can the attacker reach
AND influence.

The PR-7 reach mask answers *where* a detector anchor is reachable; it
cannot say whether the trigger operand at that anchor can ever depend
on attacker-controlled input, so a JUMPI guarding a constant-folded
branch keeps lanes alive exactly like one guarding
``calldataload(4) == x``.  This pass runs a forward taint lattice over
the recovered CFG (dataflow.forward) and *refines* the reach mask:
an anchor site whose trigger operands are provably independent of
every taint source drops its gen bit before the backward reachability
fixpoint, so statically-uninfluenceable regions go detector-dead and
lanes retire earlier through the existing seams with zero new engine
code.

Lattice
-------
A taint value is an int bitmask over SOURCES (below) or ``TOP``
(``None`` — unknown provenance, treated as every source at once).
Join is bitwise OR with TOP absorbing.  The abstract state per block
entry is ``(stack suffix, memory taint, storage taint)`` where memory
and storage are single summary cells (any tainted write taints the
whole summary — sound, imprecise).

Soundness
---------
The drop rule must guarantee: *if the analysis marks an operand
untainted (mask 0, not TOP), no concrete execution can make the
runtime value of that operand depend on any taint source.*  Three
design rules enforce it:

* every value-producing opcode that is not explicitly modeled pushes
  TOP (the closed untainted set is PUSH/PC/MSIZE/CODESIZE/ADDRESS/
  GASPRICE-free arithmetic over untainted inputs — anything else,
  including CALL results, BALANCE, GAS, BLOCKHASH and COINBASE-class
  env reads, is TOP);
* unresolved-jump edges and entry-unreachable blocks carry the full
  TOP state (dataflow.JUMP_TOP);
* a blown fixpoint budget refines nothing (``drops`` empty).

Symbolic values in the engine originate only from calldata, the
transaction environment, storage and call results — all of which are
taint sources or TOP here — so "untainted" additionally implies the
operand is runtime-concrete, which is what lets per-module trigger
predicates (reach.py REFINABLE) treat an untainted trigger as "this
module can never mint an issue at this site".
"""

from typing import Dict, List, NamedTuple, Optional, Tuple

from . import dataflow
from .blocks import BasicBlock, Instr, stack_arity
from .cfg import CFG

#: taint-source bit indices
SOURCES: Dict[str, int] = {name: i for i, name in enumerate((
    "CALLDATA",    # CALLDATALOAD / CALLDATACOPY / CALLDATASIZE
    "CALLER",
    "ORIGIN",
    "CALLVALUE",
    "TIMESTAMP",
    "NUMBER",
    "SLOAD",       # storage-dependent (attacker-writable across txs)
))}

CALLDATA = 1 << SOURCES["CALLDATA"]
CALLER = 1 << SOURCES["CALLER"]
ORIGIN = 1 << SOURCES["ORIGIN"]
CALLVALUE = 1 << SOURCES["CALLVALUE"]
TIMESTAMP = 1 << SOURCES["TIMESTAMP"]
NUMBER = 1 << SOURCES["NUMBER"]
SLOAD = 1 << SOURCES["SLOAD"]

TOP: Optional[int] = None   # unknown provenance — every source at once
CLEAN = 0

#: source opcodes -> the bit their result carries
_SOURCE_OPS = {
    "CALLDATALOAD": CALLDATA,
    "CALLDATASIZE": CALLDATA,
    "CALLER": CALLER,
    "ORIGIN": ORIGIN,
    "CALLVALUE": CALLVALUE,
    "TIMESTAMP": TIMESTAMP,
    "NUMBER": NUMBER,
}

#: value-producing opcodes that are provably attacker-independent
#: (concrete per-analysis constants). Everything value-producing and
#: not listed in _SOURCE_OPS, _COMBINE_OPS or here pushes TOP.
_CLEAN_OPS = frozenset((
    "PC", "MSIZE", "CODESIZE", "ADDRESS", "JUMPDEST",
))

#: pure combinators: result taint = OR of operand taints
_COMBINE_OPS = frozenset((
    "ADD", "SUB", "MUL", "DIV", "SDIV", "MOD", "SMOD", "ADDMOD",
    "MULMOD", "EXP", "SIGNEXTEND",
    "LT", "GT", "SLT", "SGT", "EQ", "ISZERO",
    "AND", "OR", "XOR", "NOT", "BYTE", "SHL", "SHR", "SAR",
))

#: abstract-stack depth cap, matching the VSA's
_STACK_DEPTH = 32


class TaintState(NamedTuple):
    """Block-entry abstract state. ``stack`` tracks a top-aligned
    suffix (entries beyond it are TOP); ``mem``/``storage`` are the
    single summary cells."""

    stack: Tuple[Optional[int], ...]
    mem: Optional[int]
    storage: Optional[int]


ENTRY = TaintState((), CLEAN, SLOAD)
#: full-unknown state pushed along unresolved edges
TOP_STATE = TaintState((), TOP, TOP)


def _join_v(a: Optional[int], b: Optional[int]) -> Optional[int]:
    if a is TOP or b is TOP:
        return TOP
    return a | b


def join(a: TaintState, b: TaintState) -> TaintState:
    n = min(len(a.stack), len(b.stack))
    stack = tuple(_join_v(a.stack[len(a.stack) - n + i],
                          b.stack[len(b.stack) - n + i])
                  for i in range(n))
    return TaintState(stack, _join_v(a.mem, b.mem),
                      _join_v(a.storage, b.storage))


def transfer_instr(stack: List[Optional[int]], mem, storage, ins: Instr):
    """One instruction over the mutable abstract stack; returns the
    new (mem, storage) pair. Mirrors cfg.transfer's structural cases
    so the two analyses agree on stack shape."""
    op = ins.op

    def pop(k: int) -> List[Optional[int]]:
        got = []
        for _ in range(k):
            got.append(stack.pop() if stack else TOP)
        return got

    if op.startswith("PUSH"):
        stack.append(CLEAN)
    elif op.startswith("DUP"):
        n = int(op[3:])
        stack.append(stack[-n] if n <= len(stack) else TOP)
    elif op.startswith("SWAP"):
        n = int(op[4:])
        if n < len(stack):
            stack[-1], stack[-n - 1] = stack[-n - 1], stack[-1]
        elif stack:
            stack[-1] = TOP
    elif op == "POP":
        pop(1)
    elif op in _SOURCE_OPS:
        pops, _ = stack_arity(op)
        args = pop(pops)
        bit = _SOURCE_OPS[op]
        # reading at an attacker-chosen offset makes the read VALUE
        # attacker-dependent even when the underlying data is not
        taint = bit
        for a in args:
            taint = _join_v(taint, a)
        stack.append(taint)
    elif op == "SLOAD":
        (slot,) = pop(1)
        stack.append(_join_v(_join_v(SLOAD, slot), storage))
    elif op == "SSTORE":
        slot, val = pop(2)
        storage = _join_v(storage, _join_v(slot, val))
    elif op == "MLOAD":
        (off,) = pop(1)
        stack.append(_join_v(mem, off))
    elif op in ("MSTORE", "MSTORE8"):
        off, val = pop(2)
        mem = _join_v(mem, _join_v(off, val))
    elif op == "CALLDATACOPY":
        args = pop(3)
        t = CALLDATA
        for a in args:
            t = _join_v(t, a)
        mem = _join_v(mem, t)
    elif op == "CODECOPY":
        args = pop(3)
        t = CLEAN
        for a in args:
            t = _join_v(t, a)
        mem = _join_v(mem, t)
    elif op in ("RETURNDATACOPY", "EXTCODECOPY"):
        pops, _ = stack_arity(op)
        pop(pops)
        mem = TOP
    elif op in ("SHA3", "KECCAK256"):
        args = pop(2)
        t = mem
        for a in args:
            t = _join_v(t, a)
        stack.append(t)
    elif op in ("CALL", "CALLCODE", "DELEGATECALL", "STATICCALL",
                "CREATE", "CREATE2"):
        pops, pushes = stack_arity(op)
        pop(pops)
        # the callee writes returndata into memory and can re-enter:
        # both summaries and the result are unknown afterwards
        mem = TOP
        storage = TOP
        for _ in range(pushes):
            stack.append(TOP)
    elif op in _COMBINE_OPS:
        pops, pushes = stack_arity(op)
        args = pop(pops)
        t = CLEAN
        for a in args:
            t = _join_v(t, a)
        for _ in range(pushes):
            stack.append(t)
    elif op in _CLEAN_OPS:
        pops, pushes = stack_arity(op)
        pop(pops)
        for _ in range(pushes):
            stack.append(CLEAN)
    else:
        # JUMP/JUMPI/LOG/terminators pop without pushing; any unmodeled
        # value producer pushes TOP (the sound default)
        pops, pushes = stack_arity(op)
        pop(pops)
        for _ in range(pushes):
            stack.append(TOP)
    if len(stack) > _STACK_DEPTH:
        del stack[: len(stack) - _STACK_DEPTH]
    return mem, storage


def _run_block(block: BasicBlock, entry: TaintState) -> TaintState:
    stack = list(entry.stack)
    mem, storage = entry.mem, entry.storage
    for ins in block.instrs:
        mem, storage = transfer_instr(stack, mem, storage, ins)
    return TaintState(tuple(stack), mem, storage)


class SiteTaint(NamedTuple):
    """Converged operand taints at a JUMP/JUMPI site (the refinement
    triggers reach.py consumes). ``None`` entries are TOP."""

    dest: Optional[int]
    cond: Optional[int]   # JUMPI only; TOP for JUMP


def analyze(cfg: CFG) -> Tuple[Dict[int, SiteTaint], bool]:
    """Run the fixpoint; returns (byte pc -> SiteTaint for every
    JUMP/JUMPI site, converged). A non-converged run returns an empty
    site table — callers refine nothing."""
    if not cfg.blocks:
        return {}, True
    res = dataflow.forward(
        cfg,
        entry_fact=ENTRY,
        top_fact=TOP_STATE,
        transfer=lambda bi, f: _run_block(cfg.blocks[bi], f),
        join=join,
        equal=lambda a, b: a == b,
        unreached=TOP_STATE,
    )
    if not res.converged:
        return {}, False
    sites: Dict[int, SiteTaint] = {}
    for bi, block in enumerate(cfg.blocks):
        last = block.last
        if last.op not in ("JUMP", "JUMPI"):
            continue
        # replay the block to the final instruction's operand stack
        stack = list(res.entry[bi].stack)
        mem, storage = res.entry[bi].mem, res.entry[bi].storage
        for ins in block.instrs[:-1]:
            mem, storage = transfer_instr(stack, mem, storage, ins)
        dest = stack[-1] if stack else TOP
        cond = TOP
        if last.op == "JUMPI":
            cond = stack[-2] if len(stack) >= 2 else TOP
        sites[last.pc] = SiteTaint(dest, cond)
    return sites, True


def _has(taint: Optional[int], bits: int) -> bool:
    """Can `taint` carry any of `bits`? TOP carries everything."""
    return taint is TOP or bool(taint & bits)


#: per-(module, anchor-op) trigger predicates over the converged site
#: taints: True = "this module might still mint an issue at this
#: site". A (module, op) pair NOT listed always fires (no refinement).
#: Soundness notes per rule live in docs/static_pass.md:
#: * ArbitraryJump's issue predicate IS dest symbolicness, and every
#:   symbolic-value origin is a taint source or TOP — an untainted
#:   dest is runtime-concrete, so the module cannot fire.
#: * TxOrigin fires on a condition carrying the ORIGIN term
#:   annotation; origin can only reach the condition directly
#:   (ORIGIN bit), through storage (SLOAD bit) or through unmodeled
#:   flow (TOP).
#: * PredictableVariables fires on TIMESTAMP/NUMBER/COINBASE/GASLIMIT/
#:   BLOCKHASH flow; COINBASE/GASLIMIT/BLOCKHASH are unmodeled (TOP)
#:   here, so the tracked bits + SLOAD + TOP cover every path.
SITE_RULES = {
    ("ArbitraryJump", "JUMP"):
        lambda st: st.dest != CLEAN,
    ("ArbitraryJump", "JUMPI"):
        lambda st: st.dest != CLEAN,
    ("TxOrigin", "JUMPI"):
        lambda st: _has(st.cond, ORIGIN | SLOAD),
    ("PredictableVariables", "JUMPI"):
        lambda st: _has(st.cond, TIMESTAMP | NUMBER | SLOAD),
    # UnboundedLoopGas fires only on conditions PROVABLY carrying
    # attacker-drivable flow (unbounded_loop_gas._attacker_tainted:
    # CALLDATA/CALLVALUE/SLOAD, TOP excluded) — the refinement rule
    # here must over-approximate that predicate, so TOP keeps the site
    ("UnboundedLoopGas", "JUMPI"):
        lambda st: _has(st.cond, CALLDATA | CALLVALUE | SLOAD),
}


def module_can_fire(module_name: str, op: str, site: SiteTaint) -> bool:
    rule = SITE_RULES.get((module_name, op))
    if rule is None:
        return True
    try:
        return bool(rule(site))
    except Exception:
        return True
