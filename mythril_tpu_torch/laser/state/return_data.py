"""Return data container (reference parity:
mythril/laser/ethereum/state/return_data.py:10-32)."""

from typing import List, Union

from ...smt import BitVec, symbol_factory


class ReturnData:
    def __init__(self, return_data: List[Union[int, BitVec]],
                 return_data_size: Union[int, BitVec]) -> None:
        self.return_data = return_data
        if isinstance(return_data_size, int):
            return_data_size = symbol_factory.BitVecVal(
                return_data_size, 256
            )
        self.return_data_size = return_data_size

    @property
    def size(self) -> int:
        if hasattr(self.return_data, "__len__"):
            return len(self.return_data)
        return 0
