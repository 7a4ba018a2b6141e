"""Solidity source-level contract container (capability parity:
mythril/solidity/soliditycontract.py:168-386 — compile via solc
standard-JSON, hold deployedBytecode + bytecode + srcmaps per contract,
map instruction addresses to source lines, constructor srcmaps handled
separately).

The source map decoder implements solc's compressed srcmap format
(s:l:f:j:m entries with empty-field inheritance) directly; mapping from
instruction *index* to address reuses the disassembler's instruction list.
"""

import logging
from typing import Dict, List, Optional

from ..disassembler.disassembly import Disassembly
from ..ethereum.evmcontract import EVMContract
from .util import SolcError, get_solc_json

log = logging.getLogger(__name__)


class SolidityFile:
    def __init__(self, filename: str, data: str, full_contract_src_maps):
        self.filename = filename
        self.data = data
        self.full_contract_src_maps = full_contract_src_maps


class SourceMapping:
    def __init__(self, solidity_file_idx: int, offset: int, length: int,
                 lineno: Optional[int], solc_mapping: str):
        self.solidity_file_idx = solidity_file_idx
        self.offset = offset
        self.length = length
        self.lineno = lineno
        self.solc_mapping = solc_mapping


class SourceCodeInfo:
    def __init__(self, filename, lineno, code, solc_mapping):
        self.filename = filename
        self.lineno = lineno
        self.code = code
        self.solc_mapping = solc_mapping


def decode_srcmap(srcmap: str) -> List[List[str]]:
    """solc compressed srcmap -> list of [s, l, f, j, m] with inheritance
    of empty fields from the previous entry."""
    entries = []
    prev = ["0", "0", "0", "-", "0"]
    for raw in srcmap.split(";"):
        fields = raw.split(":")
        cur = list(prev)
        for i, val in enumerate(fields[:5]):
            if val != "":
                cur[i] = val
        entries.append(cur)
        prev = cur
    return entries


class SolidityContract(EVMContract):
    """One named contract out of a compiled Solidity unit."""

    def __init__(self, input_file: str, name: Optional[str] = None,
                 solc_settings_json: Optional[str] = None,
                 solc_binary: str = "solc", solc_args=None):
        data = get_solc_json(
            input_file, solc_binary=solc_binary,
            solc_settings_json=solc_settings_json, solc_args=solc_args,
        )

        self.solc_indices = self.get_solc_indices(input_file, data)
        self.solc_json = data
        self.input_file = input_file

        contract = None
        contract_name = name
        for filename, contracts in data.get("contracts", {}).items():
            for cname, cdata in contracts.items():
                runtime = cdata["evm"]["deployedBytecode"]["object"]
                if not runtime:
                    continue  # interfaces/abstract contracts
                if name is None or cname == name:
                    contract = cdata
                    contract_name = cname
        if contract is None:
            raise SolcError(
                f"no deployable contract "
                f"{'named ' + name if name else ''} in {input_file}"
            )

        code = contract["evm"]["deployedBytecode"]["object"]
        creation_code = contract["evm"]["bytecode"]["object"]
        self.srcmap = decode_srcmap(
            contract["evm"]["deployedBytecode"].get("sourceMap", "")
        )
        self.constructor_srcmap = decode_srcmap(
            contract["evm"]["bytecode"].get("sourceMap", "")
        )
        self.abi = contract.get("abi", [])

        super().__init__(code=code, creation_code=creation_code,
                         name=contract_name)

    @staticmethod
    def get_solc_indices(input_file: str, data: dict) -> Dict[int, SolidityFile]:
        """file-index -> SolidityFile for every source in the unit."""
        indices: Dict[int, SolidityFile] = {}
        for filename, source in data.get("sources", {}).items():
            idx = source.get("id", 0)
            try:
                with open(filename) as f:
                    content = f.read()
            except OSError:
                content = ""
            indices[idx] = SolidityFile(filename, content, set())
        return indices

    # -- source mapping -----------------------------------------------------

    def get_source_mapping(self, constructor: bool = False) -> List[SourceMapping]:
        srcmap = self.constructor_srcmap if constructor else self.srcmap
        mappings = []
        for entry in srcmap:
            offset, length = int(entry[0]), int(entry[1])
            file_idx = int(entry[2]) if entry[2] not in ("-1", "-") else -1
            lineno = None
            if file_idx in self.solc_indices:
                content = self.solc_indices[file_idx].data
                lineno = content.count("\n", 0, offset) + 1
            mappings.append(
                SourceMapping(file_idx, offset, length, lineno,
                              ":".join(entry[:3]))
            )
        return mappings

    def get_source_info(self, address: int,
                        constructor: bool = False) -> Optional[SourceCodeInfo]:
        """Instruction address -> (file, line, source snippet)."""
        disas = (self.creation_disassembly if constructor
                 else self.disassembly)
        srcmap = self.constructor_srcmap if constructor else self.srcmap
        index = None
        for i, instr in enumerate(disas.instruction_list):
            if instr["address"] == address:
                index = i
                break
        if index is None or index >= len(srcmap):
            return None
        entry = srcmap[index]
        offset, length = int(entry[0]), int(entry[1])
        file_idx = int(entry[2]) if entry[2] not in ("-1", "-") else -1
        if file_idx not in self.solc_indices:
            return None
        sfile = self.solc_indices[file_idx]
        code = sfile.data[offset : offset + length]
        lineno = sfile.data.count("\n", 0, offset) + 1
        return SourceCodeInfo(sfile.filename, lineno, code,
                              ":".join(entry[:3]))


def get_contracts_from_file(input_file: str, **kwargs) -> List[SolidityContract]:
    """All deployable contracts in a file, one SolidityContract each."""
    data = get_solc_json(
        input_file,
        solc_binary=kwargs.get("solc_binary", "solc"),
        solc_settings_json=kwargs.get("solc_settings_json"),
        solc_args=kwargs.get("solc_args"),
    )
    out = []
    for filename, contracts in data.get("contracts", {}).items():
        for cname, cdata in contracts.items():
            if cdata["evm"]["deployedBytecode"]["object"]:
                out.append(
                    SolidityContract(
                        input_file, name=cname,
                        solc_binary=kwargs.get("solc_binary", "solc"),
                        solc_settings_json=kwargs.get("solc_settings_json"),
                    )
                )
    return out
