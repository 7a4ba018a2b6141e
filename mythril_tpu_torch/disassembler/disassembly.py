"""Disassembly container with function-selector discovery (capability
parity: mythril/disassembler/disassembly.py:9-115)."""

import logging
from typing import Dict, List, Tuple

from ..support.signatures import SignatureDB
from . import asm

log = logging.getLogger(__name__)


class Disassembly(object):
    """Disassembly object: bytecode, instruction list, and the jump-table
    mapping between function selectors/names and entry addresses."""

    def __init__(self, code: str, enable_online_lookup: bool = False) -> None:
        self.bytecode = code
        if isinstance(code, str):
            self.instruction_list = asm.disassemble(
                bytes.fromhex(code.replace("0x", ""))
            )
        else:
            self.instruction_list = asm.disassemble(code)
        self.func_hashes: List[str] = []
        self.function_name_to_address: Dict[str, int] = {}
        self.address_to_function_name: Dict[int, str] = {}
        self.enable_online_lookup = enable_online_lookup
        self.assign_bytecode(bytecode=code)

    def assign_bytecode(self, bytecode):
        self.bytecode = bytecode
        if isinstance(bytecode, tuple):
            # runtime code returned by a creation tx: elements may be
            # ints, concrete BitVec(8)s (memory stores Extracts of
            # MSTOREd words), or genuinely symbolic bytes. Fold concrete
            # values; map symbolic bytes to an out-of-range sentinel the
            # linear sweep renders as INVALID (reference behavior:
            # asm.disassemble KeyError -> INVALID).
            from ..support.support_utils import fold_concrete_bytes

            norm = fold_concrete_bytes(bytecode)
            if all(isinstance(b, int) for b in norm):
                self.instruction_list = asm.disassemble(bytes(norm))
            else:
                self.instruction_list = asm.disassemble(norm)
        else:
            self.instruction_list = asm.disassemble(bytecode)
        # open from default locations
        # control flow errors are ignored because we don't yet have a
        # reliable way to handle invalid code
        jump_table_indices = asm.find_op_code_sequence(
            [("PUSH1", "PUSH2", "PUSH3", "PUSH4"), ("EQ",)],
            self.instruction_list,
        )
        signature_database = SignatureDB(
            enable_online_lookup=self.enable_online_lookup
        )

        for index in jump_table_indices:
            function_hash, jump_target, function_name = get_function_info(
                index, self.instruction_list, signature_database
            )
            if function_hash is not None:
                self.func_hashes.append(function_hash)
            if jump_target is not None and function_name is not None:
                self.function_name_to_address[function_name] = jump_target
                self.address_to_function_name[jump_target] = function_name

    def get_easm(self) -> str:
        return asm.instruction_list_to_easm(self.instruction_list)


def get_function_info(
    index: int, instruction_list: list, signature_database: SignatureDB
) -> Tuple[str, int, str]:
    """Resolve selector, jump target and name for a jump-table entry:
    `PUSHn <selector> EQ PUSH <target> JUMPI` (reference
    disassembly.py:65-115)."""
    function_hash = instruction_list[index]["argument"]
    if isinstance(function_hash, (bytes, tuple)):
        function_hash = "0x" + bytes(function_hash).hex()
    if not isinstance(function_hash, str):
        # PUSH argument containing symbolic bytes (list slice from a
        # partially-symbolic runtime code): not a selector entry
        return None, None, None
    # normalize to 4-byte selector hex
    function_hash = "0x" + function_hash[2:].rjust(8, "0")

    function_names = signature_database.get(function_hash)
    if len(function_names) > 0:
        function_name = function_names[0]
    else:
        function_name = "_function_" + function_hash

    try:
        offset = instruction_list[index + 2]["argument"]
        if isinstance(offset, (bytes, tuple)):
            offset = "0x" + bytes(offset).hex()
        entry_point = int(offset, 16)
    except (KeyError, IndexError, TypeError, ValueError):
        return function_hash, None, None

    return function_hash, entry_point, function_name
