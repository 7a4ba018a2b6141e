"""Push-data-aware basic-block recovery over raw EVM bytecode.

This is the static-analysis twin of the linear sweep both consumers of
bytecode already run (disassembler/asm.py host-side,
ops/stepper.compile_code device-side): one pass decodes instruction
starts — bytes inside PUSH immediates are data, never instruction
starts and never JUMPDESTs — and a second pass cuts the instruction
stream into basic blocks at leaders (code entry, every valid JUMPDEST,
every instruction after a control transfer).

Unlike asm.disassemble, the sweep here does NOT strip the swarm-hash
metadata tail: the device code plane (compile_code) keeps it too, and
the per-PC tables the static pass emits are indexed by device PCs.
"""

from typing import Dict, List, NamedTuple, Optional, Tuple

from ...support.opcodes import ADDRESS, ADDRESS_OPCODE_MAPPING, OPCODES, STACK

#: opcodes that end a basic block
_JUMP_OPS = ("JUMP", "JUMPI")
_TERMINAL_OPS = ("STOP", "RETURN", "REVERT", "INVALID", "SELFDESTRUCT")

_OP_JUMPDEST = OPCODES["JUMPDEST"][ADDRESS]


class Instr(NamedTuple):
    """One decoded instruction: byte pc, opcode name, and the PUSH
    immediate (None for non-PUSH; a truncated trailing PUSH keeps the
    bytes it has, zero-extended like the EVM pads code reads)."""

    pc: int
    op: str
    push_value: Optional[int]


class BasicBlock(NamedTuple):
    start: int                 # byte pc of the first instruction
    instrs: Tuple[Instr, ...]  # non-empty
    #: byte pc of the next sequential instruction, or None when the
    #: block ends in a control transfer / terminator / end of code
    fallthrough: Optional[int]

    @property
    def last(self) -> Instr:
        return self.instrs[-1]


def decode(code: bytes) -> List[Instr]:
    """Linear sweep; undecodable bytes render as INVALID (the device
    stepper and the host disassembler agree on that rendering)."""
    out: List[Instr] = []
    i, length = 0, len(code)
    while i < length:
        op = code[i]
        name = ADDRESS_OPCODE_MAPPING.get(op, "INVALID")
        if 0x60 <= op <= 0x7F:
            n = op - 0x5F
            arg = code[i + 1: i + 1 + n]
            out.append(Instr(i, name, int.from_bytes(arg, "big")
                             << 8 * (n - len(arg))))
            i += 1 + n
        else:
            out.append(Instr(i, name, None))
            i += 1
    return out


def valid_jumpdests(code: bytes) -> frozenset:
    """Byte addresses a JUMP may legally target: a 0x5B opcode at an
    instruction START — a 0x5B inside a PUSH immediate is data."""
    return frozenset(ins.pc for ins in decode(code)
                     if ins.op == "JUMPDEST")


def recover_blocks(code: bytes) -> Tuple[List[BasicBlock], Dict[int, int]]:
    """Cut the instruction stream into basic blocks. Returns the block
    list (in address order) and the start-pc -> block-index map."""
    instrs = decode(code)
    if not instrs:
        return [], {}
    leaders = {instrs[0].pc}
    for i, ins in enumerate(instrs):
        if ins.op == "JUMPDEST":
            leaders.add(ins.pc)
        if ins.op in _JUMP_OPS or ins.op in _TERMINAL_OPS:
            if i + 1 < len(instrs):
                leaders.add(instrs[i + 1].pc)
    blocks: List[BasicBlock] = []
    cur: List[Instr] = []
    for i, ins in enumerate(instrs):
        if ins.pc in leaders and cur:
            blocks.append(BasicBlock(cur[0].pc, tuple(cur), ins.pc))
            cur = []
        cur.append(ins)
        if ins.op in _JUMP_OPS or ins.op in _TERMINAL_OPS:
            nxt = instrs[i + 1].pc if i + 1 < len(instrs) else None
            # JUMPI falls through; JUMP and terminators do not
            ft = nxt if ins.op == "JUMPI" else None
            blocks.append(BasicBlock(cur[0].pc, tuple(cur), ft))
            cur = []
    if cur:
        # code runs off the end: the EVM executes an implicit STOP
        blocks.append(BasicBlock(cur[0].pc, tuple(cur), None))
    return blocks, {b.start: i for i, b in enumerate(blocks)}


def stack_arity(op: str) -> Tuple[int, int]:
    """(pops, pushes) for the abstract-stack transfer. The OPCODES
    table's DUP/SWAP rows encode the underflow-precheck convention,
    not the net effect — special-cased here."""
    if op.startswith("DUP"):
        return 0, 1        # duplicates the n-th entry on top
    if op.startswith("SWAP"):
        return 0, 0        # net no-op; handled structurally by the VSA
    data = OPCODES.get(op)
    if data is None:       # INVALID and friends: block-terminal anyway
        return 0, 0
    return data[STACK]
