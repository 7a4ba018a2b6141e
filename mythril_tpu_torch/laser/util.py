"""LASER utilities (reference parity: mythril/laser/ethereum/util.py:16-173)."""

import re
from typing import Dict, List, Optional, Union

from ..smt import BitVec, Bool, Expression, If, simplify, symbol_factory

TT256 = 2**256
TT256M1 = 2**256 - 1
TT255 = 2**255


def safe_decode(hex_encoded_string: str) -> bytes:
    if hex_encoded_string.startswith("0x"):
        hex_encoded_string = hex_encoded_string[2:]
    if len(hex_encoded_string) % 2:
        hex_encoded_string += "0"
    return bytes.fromhex(hex_encoded_string)


def to_signed(i: int) -> int:
    return i if i < TT255 else i - TT256


def get_instruction_index(
    instruction_list: List[Dict], address: int
) -> Optional[int]:
    """Index of the instruction at byte offset `address`."""
    index = 0
    for instr in instruction_list:
        if instr["address"] >= address:
            return index
        index += 1
    return None


def get_trace_line(instr: Dict, state) -> str:
    stack = str(state.stack[::-1])
    stack = re.sub("\n", "", stack)
    return str(instr["address"]) + " " + instr["opcode"] + "\tSTACK: " + stack


def pop_bitvec(state) -> BitVec:
    """Pop a stack item coerced to a 256-bit BitVec (shared coercion:
    laser/alu.py to_bitvec, also used by the lane-engine drain)."""
    from . import alu

    return alu.to_bitvec(state.stack.pop())


def get_concrete_int(item: Union[int, Expression]) -> int:
    """Concrete value or TypeError (reference util.py:95-114)."""
    if isinstance(item, int):
        return item
    if isinstance(item, BitVec):
        if item.value is None:
            raise TypeError("Got a symbolic BitVecRef")
        return item.value
    if isinstance(item, Bool):
        value = item.value
        if value is None:
            raise TypeError("Symbolic boolref encountered")
        return int(value)
    raise TypeError(f"cannot concretize {type(item)}")


def concrete_int_from_bytes(
    concrete_bytes: Union[List[Union[BitVec, int]], bytes], start_index: int
) -> int:
    """Big-endian 32-byte word from a byte list (reference util.py:117-133)."""
    concrete_bytes = [
        byte.value if isinstance(byte, BitVec) and not byte.symbolic else byte
        for byte in concrete_bytes
    ]
    integer_bytes = concrete_bytes[start_index : start_index + 32]
    for b in integer_bytes:
        if not isinstance(b, int):
            raise TypeError("Invalid symbolic byte")
    return int.from_bytes(bytes(integer_bytes), byteorder="big")


def concrete_int_to_bytes(val) -> bytes:
    """32-byte big-endian encoding (reference util.py:136-146)."""
    if isinstance(val, int):
        return val.to_bytes(32, byteorder="big")
    return simplify(val).value.to_bytes(32, byteorder="big")


def extract_copy(data: bytearray, mem: bytearray, memstart: int,
                 datastart: int, size: int) -> None:
    for i in range(size):
        if datastart + i < len(data):
            mem[memstart + i] = data[datastart + i]
        else:
            mem[memstart + i] = 0


def extract32(data: bytearray, i: int) -> int:
    if i >= len(data):
        return 0
    o = data[i : min(i + 32, len(data))]
    o += bytearray(32 - len(o))
    return int.from_bytes(o, byteorder="big")


def insert_ret_val(global_state):
    """Push a fresh symbolic retval pinned to 1 (success) in the path
    constraints (reference util.py:166-173; used by native/cheat-code
    calls, which always succeed when they return)."""
    retval = push_unconstrained_ret_val(global_state)
    global_state.world_state.constraints.append(retval == 1)


def push_unconstrained_ret_val(global_state):
    """Push and return a fresh UNCONSTRAINED call-success flag
    (reference parity: the call-family empty-callee/unresolvable paths
    push new_bitvec with no constraint, so UncheckedRetval can branch
    both ways; native/cheat-code calls pin success via
    insert_ret_val)."""
    retval = global_state.new_bitvec(
        "retval_" + str(global_state.get_current_instruction()["address"]),
        256,
    )
    global_state.mstate.stack.append(retval)
    return retval
