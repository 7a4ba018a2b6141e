"""Calldata models: concrete and symbolic, array-backed and list-backed
(capability parity: mythril/laser/ethereum/state/calldata.py:26-319)."""

import logging
from typing import Any, List, Union

from ...smt import (
    Array,
    BitVec,
    Concat,
    Expression,
    If,
    K,
    Solver,
    sat,
    simplify,
    symbol_factory,
)

log = logging.getLogger(__name__)


class BaseCalldata:
    """Base calldata class: word reads, slicing, model-concretization."""

    def __init__(self, tx_id: str) -> None:
        self.tx_id = tx_id

    @property
    def calldatasize(self) -> BitVec:
        result = self.size
        if isinstance(result, int):
            return symbol_factory.BitVecVal(result, 256)
        return result

    def get_word_at(self, offset: int) -> BitVec:
        """32-byte big-endian word at byte offset."""
        parts = self[offset : offset + 32]
        return simplify(Concat(parts))

    def __getitem__(self, item: Union[int, slice, BitVec]) -> Any:
        if isinstance(item, int) or isinstance(item, Expression):
            return self._load(item)
        if isinstance(item, slice):
            start = 0 if item.start is None else item.start
            step = 1 if item.step is None else item.step
            stop = self.size if item.stop is None else item.stop
            try:
                current_index = (
                    start
                    if isinstance(start, BitVec)
                    else symbol_factory.BitVecVal(start, 256)
                )
                parts = []
                if isinstance(stop, int):
                    stop_val = stop
                else:
                    stop_val = stop.value
                if stop_val is None:
                    # enumerate a concrete stop with the solver (reference
                    # calldata.py:62-95 behavior)
                    s = Solver()
                    s.add(self.calldatasize == stop)
                    if s.check() != sat:
                        raise ValueError("unsolvable symbolic slice")
                    stop_val = (
                        s.model().eval(self.calldatasize, True).value
                    )
                if isinstance(start, BitVec) and start.value is None:
                    raise ValueError("symbolic slice start unsupported")
                start_val = (
                    start if isinstance(start, int) else start.value
                )
                i = start_val
                while i < stop_val:
                    parts.append(self._load(current_index))
                    i += step
                    current_index = simplify(current_index + step)
                return parts
            except ValueError:
                log.debug("symbolic slice fallback empty")
                return []
        raise ValueError

    def _load(self, item: Union[int, BitVec]) -> Any:
        raise NotImplementedError()

    @property
    def size(self) -> Union[BitVec, int]:
        raise NotImplementedError()

    def concrete(self, model) -> list:
        """Concrete bytes under a model."""
        raise NotImplementedError()


class ConcreteCalldata(BaseCalldata):
    """Concrete calldata backed by a K-array with byte stores."""

    def __init__(self, tx_id: str, calldata: list) -> None:
        self._concrete_calldata = calldata
        self._calldata = K(256, 8, 0)
        for i, element in enumerate(calldata, 0):
            element = (
                symbol_factory.BitVecVal(element, 8)
                if isinstance(element, int)
                else element
            )
            self._calldata[symbol_factory.BitVecVal(i, 256)] = element
        super().__init__(tx_id)

    def _load(self, item: Union[int, BitVec]) -> BitVec:
        item = (
            symbol_factory.BitVecVal(item, 256)
            if isinstance(item, int)
            else item
        )
        return simplify(self._calldata[item])

    def concrete(self, model) -> list:
        return self._concrete_calldata

    @property
    def size(self) -> int:
        return len(self._concrete_calldata)


class BasicConcreteCalldata(BaseCalldata):
    """Concrete calldata backed by a plain list with an If-chain for
    symbolic indices."""

    def __init__(self, tx_id: str, calldata: list) -> None:
        self._calldata = calldata
        super().__init__(tx_id)

    def _load(self, item: Union[int, BitVec]) -> Any:
        if isinstance(item, int):
            try:
                return self._calldata[item]
            except IndexError:
                return 0
        value = symbol_factory.BitVecVal(0x0, 8)
        for i in range(self.size):
            value = If(
                item == i,
                symbol_factory.BitVecVal(self._calldata[i], 8)
                if isinstance(self._calldata[i], int)
                else self._calldata[i],
                value,
            )
        return value

    def concrete(self, model) -> list:
        return self._calldata

    @property
    def size(self) -> int:
        return len(self._calldata)


class SymbolicCalldata(BaseCalldata):
    """Fully symbolic calldata: an SMT array plus a symbolic size; reads
    beyond the size are zero."""

    def __init__(self, tx_id: str) -> None:
        self._size = symbol_factory.BitVecSym(str(tx_id) + "_calldatasize",
                                              256)
        self._calldata = Array("{}_calldata".format(tx_id), 256, 8)
        super().__init__(tx_id)

    def _load(self, item: Union[int, BitVec]) -> Any:
        item = (
            symbol_factory.BitVecVal(item, 256)
            if isinstance(item, int)
            else item
        )
        return simplify(
            If(
                item < self._size,
                simplify(self._calldata[item]),
                symbol_factory.BitVecVal(0, 8),
            )
        )

    def concrete(self, model) -> list:
        concrete_length = model.eval(self.size, model_completion=True).value
        result = []
        for i in range(concrete_length):
            value = self._load(i)
            c_value = model.eval(value, model_completion=True).value
            result.append(c_value)
        return result

    @property
    def size(self) -> BitVec:
        return self._size


class BasicSymbolicCalldata(BaseCalldata):
    """Symbolic calldata as a read-over-write list."""

    def __init__(self, tx_id: str) -> None:
        self._reads: List = []
        self._size = symbol_factory.BitVecSym(str(tx_id) + "_calldatasize",
                                              256)
        super().__init__(tx_id)

    def _load(self, item: Union[int, BitVec], clean=False) -> Any:
        expr_item = (
            symbol_factory.BitVecVal(item, 256)
            if isinstance(item, int)
            else item
        )
        symbolic_base_value = If(
            expr_item >= self._size,
            symbol_factory.BitVecVal(0, 8),
            symbol_factory.BitVecSym(
                "{}_calldata_{}".format(self.tx_id, str(item)), 8
            ),
        )
        return_value = symbolic_base_value
        for r_index, r_value in self._reads:
            return_value = If(r_index == expr_item, r_value, return_value)
        if not clean:
            self._reads.append((expr_item, symbolic_base_value))
        return simplify(return_value)

    def concrete(self, model) -> list:
        concrete_length = model.eval(self.size, model_completion=True).value
        result = []
        for i in range(concrete_length):
            value = self._load(i, clean=True)
            c_value = model.eval(value, model_completion=True).value
            result.append(c_value)
        return result

    @property
    def size(self) -> BitVec:
        return self._size
