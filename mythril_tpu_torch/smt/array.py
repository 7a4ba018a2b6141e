"""Array facade over the term DAG (reference parity:
mythril/laser/smt/array.py:14-76).

`Array` is a named symbolic array, `K` a constant-default array. Reads over
store chains reduce to ITE chains at term construction (mythril_tpu_torch/smt/
terms.py mk_select); the solver ackermannizes the residual base reads.
"""

from typing import Optional, Set

from . import terms as T
from .bitvec import BitVec, _coerce


class BaseArray:
    """Base array class with read/write/substitute."""

    def __init__(self, raw: "T.Term"):
        self.raw = raw

    @property
    def domain(self) -> int:
        return self.raw.width[0]

    @property
    def range(self) -> int:
        return self.raw.width[1]

    def __getitem__(self, item: BitVec) -> BitVec:
        if not isinstance(item, BitVec):
            item = BitVec(T.bv_const(item, self.domain))
        idx = item.raw
        if idx.width != self.domain:
            if idx.width < self.domain:
                idx = T.mk_zext(self.domain - idx.width, idx)
            else:
                idx = T.mk_extract(self.domain - 1, 0, idx)
        return BitVec(T.mk_select(self.raw, idx), item.annotations)

    def __setitem__(self, key: BitVec, value: BitVec) -> None:
        if not isinstance(key, BitVec):
            key = BitVec(T.bv_const(key, self.domain))
        if not isinstance(value, BitVec):
            value = BitVec(T.bv_const(value, self.range))
        idx = key.raw
        if idx.width != self.domain:
            if idx.width < self.domain:
                idx = T.mk_zext(self.domain - idx.width, idx)
            else:
                idx = T.mk_extract(self.domain - 1, 0, idx)
        val = value.raw
        if val.width != self.range:
            if val.width < self.range:
                val = T.mk_zext(self.range - val.width, val)
            else:
                val = T.mk_extract(self.range - 1, 0, val)
        self.raw = T.mk_store(self.raw, idx, val)

    def substitute(self, original_expression, new_expression) -> None:
        """Parity: array.py:32-42."""
        self.raw = T.substitute_term(
            self.raw, {original_expression.raw.tid: new_expression.raw}
        )


class Array(BaseArray):
    """A named symbolic smt array."""

    def __init__(self, name: str, domain: int, value_range: int):
        self.name = name
        super().__init__(T.array_var(name, domain, value_range))


class K(BaseArray):
    """A constant-default smt array (z3 K parity)."""

    def __init__(self, domain: int, value_range: int, value: int):
        self._default = T.bv_const(value, value_range)
        super().__init__(T.const_array(domain, value_range, self._default))
