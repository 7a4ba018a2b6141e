"""Helpers of the screen tests: the all-opcode wave
(``screen_waves.layered_sets``, which takes either package's term
module, ``mythril_tpu.smt.terms`` or ``mythril_tpu_torch.smt.terms``, so
both packages screen structurally identical systems) and a term key
independent of term ids."""

from mythril_tpu_torch.support.screen_waves import layered_sets  # noqa: F401


#: ops whose constructors order their operands by term id
_COMMUTATIVE = frozenset(("add", "mul", "band", "bor", "bxor", "eq", "and",
                          "or", "xor"))


def canon(term, memo=None) -> str:
    """A printed key of ``term`` that does not depend on term ids: the
    operands of commutative ops are sorted (their constructors order
    them by id, and ids depend on what a process interned before)."""
    memo = {} if memo is None else memo
    got = memo.get(term.tid)
    if got is None:
        if not term.args:
            got = repr(term)
        else:
            args = [canon(a, memo) for a in term.args]
            if term.op in _COMMUTATIVE:
                args.sort()
            params = ",".join(map(str, term.params)) if term.params else ""
            got = (f"{term.op}{'<' + params + '>' if params else ''}"
                   f"({', '.join(args)})")
        memo[term.tid] = got
    return got
