"""Conservative CFG construction with static jump resolution.

Jump targets resolve through a tiny value-set analysis: every abstract
stack slot is either TOP (unknown) or a small set of concrete words
seeded by PUSH immediates and propagated through the stack-shuffling
ops (DUP/SWAP/POP) plus a few constant-folding arithmetic cases. The
fixpoint runs over block entry states joined elementwise, so the
push-jump idiom resolves whether the PUSH sits next to the JUMP or in
a predecessor (the internal-function call/return pattern: the caller
pushes the return address, the callee jumps back through the stack).

Soundness contract: a resolved target SET over-approximates every
value a concrete execution can place in that slot — anything the
transfer functions do not model becomes TOP, and a TOP jump is
"unresolved": its successors are ALL valid JUMPDESTs. Reachability,
loop heads and storage summaries computed over this graph therefore
over-approximate every real execution, which is what lets consumers
retire work when the graph says a site is unreachable.
"""

from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

from .blocks import BasicBlock, Instr, stack_arity

#: value-set width cap: a slot tracking more than this many concrete
#: candidates widens to TOP (None)
VSA_K = 8
#: abstract stack depth cap (deeper entries are untracked == TOP)
STACK_DEPTH = 32
#: fixpoint budget: total block transfers before giving up and marking
#: every jump unresolved (still sound — maximally conservative)
_TRANSFER_BUDGET_PER_BLOCK = 64

TOP = None  # a slot about which nothing is known

_WORD_MASK = (1 << 256) - 1


class CFG(NamedTuple):
    blocks: List[BasicBlock]
    block_at: Dict[int, int]            # start pc -> block index
    succ: List[Tuple[int, ...]]         # block index -> successor indices
    #: jump/jumpi byte pc -> resolved concrete target tuple, or None
    #: when the value-set widened to TOP (conservatively: any JUMPDEST)
    jump_table: Dict[int, Optional[Tuple[int, ...]]]
    jumpdests: frozenset                # valid JUMPDEST byte addresses
    entry_stacks: Dict[int, list]       # converged VSA entry state
    complete: bool                      # every jump site resolved


def _join_value(a, b):
    if a is TOP or b is TOP:
        return TOP
    u = a | b
    return u if len(u) <= VSA_K else TOP


def _join_stack(a: Optional[list], b: list) -> list:
    """Elementwise join aligned at the top of stack; depth truncates to
    the shorter tracked suffix (untracked == TOP)."""
    if a is None:
        return list(b)
    n = min(len(a), len(b))
    out = [_join_value(a[len(a) - n + i], b[len(b) - n + i])
           for i in range(n)]
    return out


def _stacks_equal(a: Optional[list], b: list) -> bool:
    return a is not None and a == b


def _fold(op: str, args: Sequence) -> Optional[frozenset]:
    """Constant-fold a handful of pure binary ops over small value
    sets; anything else is TOP. Folding only ever *narrows* what the
    slot can hold relative to TOP, so unmodeled ops stay sound."""
    if any(a is TOP for a in args):
        return TOP
    out = set()
    for x in args[0]:
        for y in (args[1] if len(args) > 1 else (0,)):
            if op == "ADD":
                out.add((x + y) & _WORD_MASK)
            elif op == "SUB":
                out.add((x - y) & _WORD_MASK)
            elif op == "AND":
                out.add(x & y)
            elif op == "OR":
                out.add(x | y)
            elif op == "XOR":
                out.add(x ^ y)
            elif op == "NOT":
                out.add(x ^ _WORD_MASK)
            else:
                return TOP
            if len(out) > VSA_K:
                return TOP
    return frozenset(out)


_FOLDABLE = frozenset(("ADD", "SUB", "AND", "OR", "XOR", "NOT"))


def transfer(stack: list, ins: Instr):
    """Apply one instruction to an abstract stack IN PLACE. Returns the
    value at the jump-destination slot for JUMP/JUMPI (before the pop),
    else None."""
    op = ins.op
    dest = None
    if op.startswith("PUSH"):
        stack.append(frozenset((ins.push_value,)))
    elif op.startswith("DUP"):
        n = int(op[3:])
        stack.append(stack[-n] if n <= len(stack) else TOP)
    elif op.startswith("SWAP"):
        n = int(op[4:])
        if n < len(stack):
            stack[-1], stack[-n - 1] = stack[-n - 1], stack[-1]
        elif stack:
            # the deep slot is untracked: after the swap the top holds
            # its (unknown) value and the untracked slot needs no write
            stack[-1] = TOP
    elif op == "POP":
        if stack:
            stack.pop()
    else:
        pops, pushes = stack_arity(op)
        if op in ("JUMP", "JUMPI"):
            dest = stack[-1] if stack else TOP
        if op in _FOLDABLE and len(stack) >= pops:
            args = [stack[-1 - i] for i in range(pops)]
            result = _fold(op, args)
        else:
            result = TOP
        del stack[len(stack) - min(pops, len(stack)):]
        for i in range(pushes):
            stack.append(result if (pushes == 1 and i == 0) else TOP)
    if len(stack) > STACK_DEPTH:
        del stack[: len(stack) - STACK_DEPTH]
    return dest


def _block_exit(block: BasicBlock, entry: list):
    """Run the abstract stack through a whole block; returns
    (exit_stack, dest_value_at_final_jump_or_None)."""
    stack = list(entry)
    dest = None
    for ins in block.instrs:
        dest = transfer(stack, ins)
    return stack, dest


def build_cfg(code: bytes, blocks: List[BasicBlock],
              block_at: Dict[int, int], jumpdests: frozenset) -> CFG:
    if not blocks:
        return CFG([], {}, [], {}, jumpdests, {}, True)
    dest_block = {pc: block_at[pc] for pc in jumpdests if pc in block_at}
    all_dest_idx = tuple(sorted(dest_block.values()))

    entry_stacks: Dict[int, Optional[list]] = {0: []}
    jump_values: Dict[int, object] = {}
    budget = _TRANSFER_BUDGET_PER_BLOCK * len(blocks)
    work = [0]
    blown = False
    while work:
        budget -= 1
        if budget < 0:
            blown = True
            break
        bi = work.pop()
        block = blocks[bi]
        exit_stack, dest = _block_exit(block, entry_stacks[bi])
        last = block.last
        outs: List[Tuple[int, list]] = []
        if last.op == "JUMP" or last.op == "JUMPI":
            jump_values[last.pc] = dest
            if dest is TOP:
                # unresolved: every JUMPDEST is a possible successor;
                # propagate a fully-unknown (empty tracked) stack
                outs.extend((di, []) for di in all_dest_idx)
            else:
                for t in dest:
                    di = dest_block.get(t)
                    if di is not None:
                        outs.append((di, exit_stack))
            if last.op == "JUMPI" and block.fallthrough in block_at:
                outs.append((block_at[block.fallthrough], exit_stack))
        elif block.fallthrough is not None \
                and block.fallthrough in block_at:
            outs.append((block_at[block.fallthrough], exit_stack))
        for di, st in outs:
            joined = _join_stack(entry_stacks.get(di), st)
            if not _stacks_equal(entry_stacks.get(di), joined):
                entry_stacks[di] = joined
                if di not in work:
                    work.append(di)

    # second sweep: blocks the fixpoint never reached (only reachable
    # through data we cannot follow, or dead code) get TOP entries so
    # every block has a successor set and a summary
    for bi in range(len(blocks)):
        if bi not in entry_stacks:
            entry_stacks[bi] = []

    jump_table: Dict[int, Optional[Tuple[int, ...]]] = {}
    succ: List[Tuple[int, ...]] = []
    complete = not blown
    for bi, block in enumerate(blocks):
        last = block.last
        outs: List[int] = []
        if last.op in ("JUMP", "JUMPI"):
            if blown:
                dest = TOP
            elif last.pc in jump_values:
                dest = jump_values[last.pc]
            else:
                # entry-unreachable block (dead code, or only reachable
                # through data flow we cannot follow): the within-block
                # push-jump idiom still resolves from a TOP entry stack
                dest = _block_exit(block, entry_stacks[bi])[1]
            if dest is TOP:
                jump_table[last.pc] = None
                complete = False
                outs.extend(all_dest_idx)
            else:
                targets = tuple(sorted(t for t in dest
                                       if t in dest_block))
                jump_table[last.pc] = targets
                outs.extend(dest_block[t] for t in targets)
            if last.op == "JUMPI" and block.fallthrough in block_at:
                outs.append(block_at[block.fallthrough])
        elif last.op in ("STOP", "RETURN", "REVERT", "INVALID",
                         "SELFDESTRUCT"):
            pass
        elif block.fallthrough is not None \
                and block.fallthrough in block_at:
            outs.append(block_at[block.fallthrough])
        succ.append(tuple(sorted(set(outs))))
    return CFG(blocks, block_at, succ, jump_table, jumpdests,
               entry_stacks, complete)
