"""Function-selector recovery: the dispatcher's selector -> entry-pc
map, walked off the same abstract machinery the VSA uses.

Solidity (and most hand-rolled) dispatchers load the first calldata
word, shift/divide it down to the 4-byte selector, and run a chain of
``EQ(selector, PUSH4 c) -> PUSH dest -> JUMPI`` tests — either linear
or as a GT/LT binary-search tree over sub-chains.  The walk tracks a
tiny abstract stack whose values are ``const``, the raw first calldata
word, the extracted selector, or a selector comparison, follows BOTH
arms of every dispatcher-internal branch, and records
``selector -> JUMPI target`` at every comparison branch.  A recorded
target is a *function entry block*; the walk does not descend into it.

The map is used for reporting-grade metadata AND as the key space of
the interprocedural dependence relation (deps.py), whose consumers
prune work.  Soundness there does NOT rest on this walk being
complete: deps.py only acts on selectors the walk recovered and a
transaction provably routed through (svm tags finished transactions
with the function entry the path visited), so a missed or spurious
selector degrades to "no pruning", never to a wrong prune — the
write/read sets consulted are the CFG-reachable aggregates from the
recorded entry block, which over-approximate every path through the
real function body.
"""

from typing import Dict, List, NamedTuple, Optional, Tuple

from .cfg import CFG

#: walk budgets — dispatchers are tiny; these bound pathological codes
_MAX_BLOCKS = 128
_MAX_SELECTORS = 512

_SHIFT_224 = 224
_DIV_2_224 = 1 << 224
_SEL_MASK = 0xFFFFFFFF

# abstract values
_OTHER = "other"


class _Const(NamedTuple):
    val: int


class _RawCD(NamedTuple):      # CALLDATALOAD(0)
    pass


class _Selector(NamedTuple):   # the 4-byte selector expression
    pass


class _Cmp(NamedTuple):        # EQ(selector, const)
    sel: int


def _step(stack: List, ins) -> None:
    """One instruction over the dispatcher-abstract stack."""
    op = ins.op

    def popn(k):
        got = []
        for _ in range(k):
            got.append(stack.pop() if stack else _OTHER)
        return got

    if op.startswith("PUSH"):
        stack.append(_Const(ins.push_value))
    elif op.startswith("DUP"):
        n = int(op[3:])
        stack.append(stack[-n] if n <= len(stack) else _OTHER)
    elif op.startswith("SWAP"):
        n = int(op[4:])
        if n < len(stack):
            stack[-1], stack[-n - 1] = stack[-n - 1], stack[-1]
        elif stack:
            stack[-1] = _OTHER
    elif op == "POP":
        popn(1)
    elif op == "CALLDATALOAD":
        (off,) = popn(1)
        stack.append(_RawCD() if off == _Const(0) else _OTHER)
    elif op == "DIV":
        a, b = popn(2)
        stack.append(_Selector()
                     if isinstance(a, _RawCD) and b == _Const(_DIV_2_224)
                     else _OTHER)
    elif op == "SHR":
        shift, val = popn(2)
        stack.append(_Selector()
                     if isinstance(val, _RawCD)
                     and shift == _Const(_SHIFT_224)
                     else _OTHER)
    elif op == "AND":
        a, b = popn(2)
        masked = (isinstance(a, _Selector) and b == _Const(_SEL_MASK)) \
            or (isinstance(b, _Selector) and a == _Const(_SEL_MASK))
        stack.append(_Selector() if masked else _OTHER)
    elif op == "EQ":
        a, b = popn(2)
        if isinstance(a, _Selector) and isinstance(b, _Const):
            stack.append(_Cmp(b.val & _SEL_MASK))
        elif isinstance(b, _Selector) and isinstance(a, _Const):
            stack.append(_Cmp(a.val & _SEL_MASK))
        else:
            stack.append(_OTHER)
    else:
        from .blocks import stack_arity

        pops, pushes = stack_arity(op)
        popn(pops)
        for _ in range(pushes):
            stack.append(_OTHER)


def recover(cfg: CFG) -> Dict[int, int]:
    """{selector (uint32) -> function entry byte pc}. Empty when the
    code has no recognizable dispatcher."""
    if not cfg.blocks:
        return {}
    out: Dict[int, int] = {}
    # (block index, entry stack) worklist; dispatcher stacks are tiny
    seen = set()
    work: List[Tuple[int, tuple]] = [(0, ())]
    visited_blocks = 0
    while work and visited_blocks < _MAX_BLOCKS \
            and len(out) < _MAX_SELECTORS:
        bi, entry = work.pop()
        if bi in seen:
            continue
        seen.add(bi)
        visited_blocks += 1
        block = cfg.blocks[bi]
        stack = list(entry)
        for ins in block.instrs[:-1]:
            _step(stack, ins)
        last = block.last
        if last.op == "JUMPI":
            dest = stack[-1] if stack else _OTHER
            cond = stack[-2] if len(stack) >= 2 else _OTHER
            if isinstance(cond, _Cmp) and isinstance(dest, _Const) \
                    and dest.val in cfg.jumpdests:
                # a selector match: record the entry, do NOT walk into
                # the function body; keep scanning the fallthrough
                out.setdefault(cond.sel, dest.val)
            elif isinstance(dest, _Const) and dest.val in cfg.block_at:
                # a GT/LT split (binary-search dispatcher) or a
                # size-check branch: both arms stay in the dispatcher
                taken = list(stack)
                _step_jumpi_fall(taken, last)
                work.append((cfg.block_at[dest.val], tuple(taken)))
            _step_jumpi_fall(stack, last)
            if block.fallthrough in cfg.block_at:
                work.append((cfg.block_at[block.fallthrough],
                             tuple(stack)))
        elif last.op == "JUMP":
            dest = stack[-1] if stack else _OTHER
            if isinstance(dest, _Const) and dest.val in cfg.block_at \
                    and _dispatcherish(stack):
                work.append((cfg.block_at[dest.val], ()))
        elif block.fallthrough is not None \
                and block.fallthrough in cfg.block_at:
            _step(stack, last)
            work.append((cfg.block_at[block.fallthrough], tuple(stack)))
    return out


def _step_jumpi_fall(stack: List, last) -> None:
    """Consume JUMPI's two operands for the fallthrough continuation
    (only when not already consumed by a split continuation)."""
    for _ in range(2):
        if stack:
            stack.pop()


def _dispatcherish(stack: List) -> bool:
    """Follow an unconditional JUMP only while the stack still smells
    like dispatch plumbing (selector/raw-calldata value live) — keeps
    the walk out of arbitrary code while supporting the
    jump-over-payable-check prologue shape."""
    return any(isinstance(v, (_Selector, _RawCD, _Cmp)) for v in stack)
