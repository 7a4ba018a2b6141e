"""Contract loading + disassembly orchestration (capability parity:
mythril/mythril/mythril_disassembler.py:43-400 — load_from_bytecode,
load_from_address, load_from_solidity, load_from_foundry, solc binary
selection, read-storage helpers incl. mapping-slot keccak math,
hash_for_function_signature)."""

import logging
import os
import re
import subprocess
from typing import List, Optional, Tuple

from ..disassembler.disassembly import Disassembly
from ..ethereum.evmcontract import EVMContract
from ..solidity.soliditycontract import (
    SolidityContract,
    get_contracts_from_file,
)
from ..solidity.util import SolcError, parse_pragma, solc_exists
from ..support.loader import DynLoader
from ..support.signatures import SignatureDB
from ..support.support_utils import sha3

log = logging.getLogger(__name__)


class MythrilDisassembler:
    def __init__(self, eth=None, solc_version: Optional[str] = None,
                 solc_settings_json: Optional[str] = None,
                 enable_online_lookup: bool = False,
                 solc_args=None):
        self.eth = eth
        self.solc_settings_json = solc_settings_json
        self.solc_args = solc_args
        self.enable_online_lookup = enable_online_lookup
        self.sigs = SignatureDB(enable_online_lookup=enable_online_lookup)
        self.solc_binary = self._init_solc_binary(solc_version)
        self.contracts: List[EVMContract] = []

    @staticmethod
    def _init_solc_binary(version: Optional[str]) -> str:
        """Pick a solc binary for `version` (exact install if available,
        else the system binary; actual availability is checked at compile
        time so bytecode-only analyses never require solc)."""
        found = solc_exists(version)
        return found or "solc"

    # -- loading ------------------------------------------------------------

    def load_from_bytecode(
        self, code: str, bin_runtime: bool = False,
        address: Optional[str] = None,
    ) -> Tuple[str, EVMContract]:
        if code.startswith("0x"):
            code = code[2:]
        if bin_runtime:
            contract = EVMContract(
                code=code, name="MAIN",
                enable_online_lookup=self.enable_online_lookup,
            )
        else:
            contract = EVMContract(
                creation_code=code, name="MAIN",
                enable_online_lookup=self.enable_online_lookup,
            )
        self.contracts.append(contract)
        return address or "0x" + "0" * 40, contract

    def load_from_address(self, address: str) -> Tuple[str, EVMContract]:
        if not re.match(r"0x[a-fA-F0-9]{40}$", address):
            raise ValueError(
                "invalid address: expected 40-digit hex with 0x prefix"
            )
        if self.eth is None:
            raise ValueError(
                "loading from address requires an RPC client (--rpc)"
            )
        code = self.eth.eth_getCode(address)
        if not code or code == "0x":
            raise ValueError(f"no on-chain code at {address}")
        contract = EVMContract(
            code=code[2:], name=address,
            enable_online_lookup=self.enable_online_lookup,
        )
        self.contracts.append(contract)
        return address, contract

    def load_from_solidity(
        self, solidity_files: List[str]
    ) -> Tuple[str, List[SolidityContract]]:
        contracts: List[SolidityContract] = []
        for file in solidity_files:
            file, _, name = file.partition(":")
            file = os.path.expanduser(file)
            # re-pick the solc binary if the file pins a version
            try:
                with open(file) as f:
                    pragma_version = parse_pragma(f.read())
            except OSError as e:
                raise ValueError(f"cannot open {file}: {e}") from e
            solc_binary = self.solc_binary
            if pragma_version:
                solc_binary = solc_exists(pragma_version) or solc_binary
            if name:
                contracts.append(
                    SolidityContract(
                        file, name=name, solc_binary=solc_binary,
                        solc_settings_json=self.solc_settings_json,
                        solc_args=self.solc_args,
                    )
                )
            else:
                contracts.extend(
                    get_contracts_from_file(
                        file, solc_binary=solc_binary,
                        solc_settings_json=self.solc_settings_json,
                        solc_args=self.solc_args,
                    )
                )
            self.sigs.import_solidity_abi(
                getattr(contracts[-1], "abi", []) if contracts else []
            )
        self.contracts.extend(contracts)
        address = "0x" + "0" * 40
        return address, contracts

    def load_from_foundry(self) -> Tuple[str, List[EVMContract]]:
        """Compile the cwd's foundry project via `forge build` and load
        every artifact with deployed bytecode."""
        proc = subprocess.run(
            ["forge", "build", "--build-info", "--force"],
            capture_output=True,
        )
        if proc.returncode != 0:
            raise ValueError(
                f"forge build failed: {proc.stderr.decode()[:400]}"
            )
        import json

        contracts = []
        out_dir = os.path.join(os.getcwd(), "out")
        for root, _, files in os.walk(out_dir):
            for fn in files:
                if not fn.endswith(".json") or fn == "build-info":
                    continue
                try:
                    with open(os.path.join(root, fn)) as f:
                        artifact = json.load(f)
                    runtime = artifact.get("deployedBytecode", {}).get(
                        "object", ""
                    )
                    creation = artifact.get("bytecode", {}).get("object", "")
                    if runtime and runtime != "0x":
                        contracts.append(
                            EVMContract(
                                code=runtime[2:],
                                creation_code=creation[2:] if creation else "",
                                name=fn[:-5],
                            )
                        )
                except (ValueError, KeyError):
                    continue
        self.contracts.extend(contracts)
        return "0x" + "0" * 40, contracts

    # -- helpers ------------------------------------------------------------

    @staticmethod
    def hash_for_function_signature(sig: str) -> str:
        return "0x" + sha3(sig.encode())[:4].hex()

    def get_state_variable_from_storage(
        self, address: str, params: Optional[List[str]] = None
    ) -> str:
        """read-storage helper: position / position,length / mapping slot
        math (keccak(key ++ slot)) like the reference's
        get_state_variable_from_storage (mythril_disassembler.py:319)."""
        params = params or []
        if self.eth is None:
            raise ValueError("read-storage requires an RPC client (--rpc)")
        loader = DynLoader(self.eth)
        outtxt = []
        try:
            if len(params) < 1:
                raise ValueError("storage position required")
            if len(params) >= 2 and params[1] == "mapping":
                # position, "mapping", key1, key2...
                position = int(params[0])
                for key in params[2:]:
                    slot = int.from_bytes(
                        sha3(
                            int(key).to_bytes(32, "big")
                            + position.to_bytes(32, "big")
                        ),
                        "big",
                    )
                    outtxt.append(
                        f"{position}: mapping({key}): "
                        f"{loader.read_storage(address, slot)}"
                    )
            else:
                position = int(params[0])
                length = int(params[1]) if len(params) > 1 else 1
                for i in range(position, position + length):
                    outtxt.append(f"{i}: {loader.read_storage(address, i)}")
        except ValueError as e:
            raise ValueError(f"invalid read-storage parameters: {e}") from e
        return "\n".join(outtxt)
