"""Uninterpreted function facade (reference parity:
mythril/laser/smt/function.py:7-36). Used by the keccak and exponent
function managers."""

from typing import List, Sequence, Union

from . import terms as T
from .bitvec import BitVec


class Function:
    """An uninterpreted function over bitvector sorts."""

    def __init__(self, name: str, domain: Union[int, Sequence[int]],
                 value_range: int):
        if isinstance(domain, int):
            domain = (domain,)
        self.domain = tuple(domain)
        self.range = value_range
        self.name = name
        self.decl = T.func_decl(name, self.domain, value_range)

    def __call__(self, *items: BitVec) -> BitVec:
        args = []
        ann = set()
        for item, width in zip(items, self.domain):
            if not isinstance(item, BitVec):
                item = BitVec(T.bv_const(item, width))
            t = item.raw
            if t.width < width:
                t = T.mk_zext(width - t.width, t)
            elif t.width > width:
                t = T.mk_extract(width - 1, 0, t)
            args.append(t)
            ann |= item.annotations
        return BitVec(T.apply_func(self.decl, *args), ann)

    def __hash__(self):
        return hash((self.name, self.domain, self.range))

    def __eq__(self, other):
        return (
            isinstance(other, Function)
            and self.name == other.name
            and self.domain == other.domain
            and self.range == other.range
        )
