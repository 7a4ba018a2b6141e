"""Linear-sweep EVM disassembler (capability parity:
mythril/disassembler/asm.py:19-148 — same EvmInstruction dict shape,
swarm-hash tail handling, easm printing, opcode-sequence pattern search)."""

import re
from typing import Dict, Iterable, List

from ..support.opcodes import ADDRESS, ADDRESS_OPCODE_MAPPING, OPCODES

regex_PUSH = re.compile(r"^PUSH(\d*)$")


class EvmInstruction:
    """One disassembled instruction; to_dict matches the engine's expected
    {address, opcode, argument} shape."""

    def __init__(self, address, op_code, argument=None):
        self.address = address
        self.op_code = op_code
        self.argument = argument

    def to_dict(self) -> Dict:
        result = {"address": self.address, "opcode": self.op_code}
        if self.argument is not None:
            result["argument"] = self.argument
        return result


def instruction_list_to_easm(instruction_list: List[Dict]) -> str:
    result = ""
    for instruction in instruction_list:
        result += "{} {}".format(instruction["address"], instruction["opcode"])
        if "argument" in instruction:
            result += " " + instruction["argument"]
        result += "\n"
    return result


def get_opcode_from_name(operation_name: str) -> int:
    if operation_name in OPCODES:
        return OPCODES[operation_name][ADDRESS]
    raise RuntimeError("Unknown opcode")


def find_op_code_sequence(pattern: List[List[str]],
                          instruction_list: List[Dict]) -> Iterable[int]:
    """Yield indices where the pattern (list of alternative-opcode lists)
    matches consecutively."""
    for i in range(0, len(instruction_list) - len(pattern) + 1):
        if is_sequence_match(pattern, instruction_list, i):
            yield i


def is_sequence_match(pattern: List[List[str]], instruction_list: List[Dict],
                      index: int) -> bool:
    for index2, pattern_slot in enumerate(pattern, start=index):
        try:
            if instruction_list[index2]["opcode"] not in pattern_slot:
                return False
        except IndexError:
            return False
    return True


def disassemble(bytecode) -> List[EvmInstruction]:
    """Linear sweep; PUSH arguments sliced inline; stops at the swarm-hash
    metadata tail when present."""
    instruction_list = []
    address = 0
    length = len(bytecode)
    if isinstance(bytecode, str):
        bytecode = bytes.fromhex(bytecode.replace("0x", ""))
        length = len(bytecode)
    part_code = bytecode[-43:]
    if isinstance(part_code, bytes) and b"bzzr" in part_code:
        # ignore swarm hash tail
        length -= 43

    while address < length:
        cur = bytecode[address]
        if not isinstance(cur, int):
            # symbolic byte (runtime code from a creation tx that wasn't
            # fully concrete): undecodable -> INVALID, like the
            # reference's KeyError path (asm.py:127-131)
            instruction_list.append(EvmInstruction(address, "INVALID"))
            address += 1
            continue
        try:
            op_code = ADDRESS_OPCODE_MAPPING[cur]
        except KeyError:
            instruction_list.append(EvmInstruction(address, "INVALID"))
            address += 1
            continue

        current_instruction = EvmInstruction(address, op_code)

        match = re.search(regex_PUSH, op_code)
        if match:
            argument_bytes = bytecode[address + 1 : address + 1
                                      + int(match.group(1))]
            if isinstance(argument_bytes, bytes):
                current_instruction.argument = "0x" + argument_bytes.hex()
            else:
                current_instruction.argument = argument_bytes
            address += int(match.group(1))

        instruction_list.append(current_instruction)
        address += 1

    # We use a to_dict() here for compatibility reasons
    return [element.to_dict() for element in instruction_list]
