"""Source registry for reports (reference parity:
mythril/support/source_support.py)."""

from typing import List

from .support_utils import get_code_hash


class Source:
    """Tracks the source descriptors of analyzed contracts."""

    def __init__(self, source_type=None, source_format=None,
                 source_list=None):
        self.source_type = source_type
        self.source_format = source_format
        self.source_list: List[str] = source_list or []
        self._source_hash: List[str] = []

    def get_source_from_contracts_list(self, contracts) -> None:
        if contracts is None or len(contracts) == 0:
            return
        first = contracts[0]
        # SolidityContract exposes .solidity_files; EVMContract only code
        if hasattr(first, "solidity_files"):
            self.source_type = "solidity-file"
            self.source_format = "text"
            for contract in contracts:
                self.source_list.extend(
                    [file.filename for file in contract.solidity_files]
                )
                self._source_hash.append(contract.bytecode_hash)
                self._source_hash.append(contract.creation_bytecode_hash)
        elif hasattr(first, "bytecode"):
            self.source_type = "raw-bytecode"
            self.source_format = "evm-byzantium-bytecode"
            for contract in contracts:
                if contract.creation_code:
                    self.source_list.append(
                        get_code_hash(contract.creation_code)
                    )
                if contract.code:
                    self.source_list.append(get_code_hash(contract.code))
                self._source_hash = self.source_list

    def get_source_index(self, bytecode_hash: str) -> int:
        try:
            return self._source_hash.index(bytecode_hash)
        except ValueError:
            self._source_hash.append(bytecode_hash)
            return len(self._source_hash) - 1
