"""EVM opcode table: name -> gas interval, stack effect, byte value.

The port's own copy of ``mythril_tpu/support/opcodes.py`` (the port
imports nothing of the JAX package); the two tables must stay equal,
which tests/test_torch_imports.py checks.

Capability parity with the reference table (mythril/support/opcodes.py:16-141):
same opcode set (Istanbul/Berlin era + EIP-2315 subroutines), same
(min_gas, max_gas) interval convention used by the interval gas accountant,
same (pops, pushes) stack metadata used for the pre-execution underflow check
(reference svm.py:391).

The table here is generated from compact spec rows rather than a literal dict;
the exported structures (OPCODES, ADDRESS_OPCODE_MAPPING, GAS/STACK/ADDRESS
keys) match the reference's public shape so detectors, the disassembler and
tests can consume it identically.
"""

from typing import Dict, Tuple

GAS = "gas"
STACK = "stack"
ADDRESS = "address"

# (name, byte, pops, pushes, min_gas, max_gas)
# Gas intervals follow the reference's accounting bounds (not exact dynamic
# gas): dynamic-cost opcodes carry a [min, max] envelope.
_SPEC: Tuple[Tuple[str, int, int, int, int, int], ...] = (
    ("STOP", 0x00, 0, 0, 0, 0),
    ("ADD", 0x01, 2, 1, 3, 3),
    ("MUL", 0x02, 2, 1, 5, 5),
    ("SUB", 0x03, 2, 1, 3, 3),
    ("DIV", 0x04, 2, 1, 5, 5),
    ("SDIV", 0x05, 2, 1, 5, 5),
    ("MOD", 0x06, 2, 1, 5, 5),
    ("SMOD", 0x07, 2, 1, 5, 5),
    ("ADDMOD", 0x08, 2, 1, 8, 8),
    ("MULMOD", 0x09, 3, 1, 8, 8),
    ("EXP", 0x0A, 2, 1, 10, 340),  # exponent byte cost capped at 2^32 exponents
    ("SIGNEXTEND", 0x0B, 2, 1, 5, 5),
    ("LT", 0x10, 2, 1, 3, 3),
    ("GT", 0x11, 2, 1, 3, 3),
    ("SLT", 0x12, 2, 1, 3, 3),
    ("SGT", 0x13, 2, 1, 3, 3),
    ("EQ", 0x14, 2, 1, 3, 3),
    ("ISZERO", 0x15, 1, 1, 3, 3),
    ("AND", 0x16, 2, 1, 3, 3),
    ("OR", 0x17, 2, 1, 3, 3),
    ("XOR", 0x18, 2, 1, 3, 3),
    ("NOT", 0x19, 1, 1, 3, 3),
    ("BYTE", 0x1A, 2, 1, 3, 3),
    ("SHL", 0x1B, 2, 1, 3, 3),
    ("SHR", 0x1C, 2, 1, 3, 3),
    ("SAR", 0x1D, 2, 1, 3, 3),
    ("SHA3", 0x20, 2, 1, 30, 30 + 6 * 8),  # bounded at 8 words of input
    ("ADDRESS", 0x30, 0, 1, 2, 2),
    ("BALANCE", 0x31, 1, 1, 700, 700),
    ("ORIGIN", 0x32, 0, 1, 2, 2),
    ("CALLER", 0x33, 0, 1, 2, 2),
    ("CALLVALUE", 0x34, 0, 1, 2, 2),
    ("CALLDATALOAD", 0x35, 1, 1, 3, 3),
    ("CALLDATASIZE", 0x36, 0, 1, 2, 2),
    ("CALLDATACOPY", 0x37, 3, 0, 2, 2 + 3 * 768),  # 24k copy envelope
    ("CODESIZE", 0x38, 0, 1, 2, 2),
    ("CODECOPY", 0x39, 3, 0, 2, 2 + 3 * 768),
    ("GASPRICE", 0x3A, 0, 1, 2, 2),
    ("EXTCODESIZE", 0x3B, 0, 1, 700, 700),
    ("EXTCODECOPY", 0x3C, 4, 0, 700, 700 + 3 * 768),
    ("RETURNDATASIZE", 0x3D, 0, 1, 2, 2),
    ("RETURNDATACOPY", 0x3E, 3, 0, 3, 3),
    ("EXTCODEHASH", 0x3F, 1, 1, 700, 700),
    ("BLOCKHASH", 0x40, 1, 1, 20, 20),
    ("COINBASE", 0x41, 0, 1, 2, 2),
    ("TIMESTAMP", 0x42, 0, 1, 2, 2),
    ("NUMBER", 0x43, 0, 1, 2, 2),
    ("DIFFICULTY", 0x44, 0, 1, 2, 2),
    ("GASLIMIT", 0x45, 0, 1, 2, 2),
    ("CHAINID", 0x46, 0, 1, 2, 2),
    ("SELFBALANCE", 0x47, 0, 1, 2, 2),
    ("BASEFEE", 0x48, 0, 1, 2, 2),
    ("POP", 0x50, 1, 0, 2, 2),
    ("MLOAD", 0x51, 1, 1, 3, 96),  # 1KB memory-extension envelope
    ("MSTORE", 0x52, 2, 0, 3, 98),
    ("MSTORE8", 0x53, 2, 0, 3, 98),
    ("SLOAD", 0x54, 1, 1, 800, 800),
    ("SSTORE", 0x55, 1, 0, 5000, 25000),
    ("JUMP", 0x56, 1, 0, 8, 8),
    ("JUMPI", 0x57, 2, 0, 10, 10),
    ("PC", 0x58, 0, 1, 2, 2),
    ("MSIZE", 0x59, 0, 1, 2, 2),
    ("GAS", 0x5A, 0, 1, 2, 2),
    ("JUMPDEST", 0x5B, 0, 0, 1, 1),
    ("BEGINSUB", 0x5C, 0, 0, 2, 2),
    ("RETURNSUB", 0x5D, 0, 0, 5, 5),
    ("JUMPSUB", 0x5E, 1, 0, 10, 10),
    ("LOG0", 0xA0, 2, 0, 375, 375 + 8 * 32),
    ("LOG1", 0xA1, 3, 0, 2 * 375, 2 * 375 + 8 * 32),
    ("LOG2", 0xA2, 4, 0, 3 * 375, 3 * 375 + 8 * 32),
    ("LOG3", 0xA3, 5, 0, 4 * 375, 4 * 375 + 8 * 32),
    ("LOG4", 0xA4, 6, 0, 5 * 375, 5 * 375 + 8 * 32),
    ("CREATE", 0xF0, 3, 1, 32000, 32000),
    ("CALL", 0xF1, 7, 1, 700, 700 + 9000 + 25000),
    ("CALLCODE", 0xF2, 7, 1, 700, 700 + 9000 + 25000),
    ("RETURN", 0xF3, 2, 0, 0, 0),
    ("DELEGATECALL", 0xF4, 6, 1, 700, 700 + 9000 + 25000),
    ("CREATE2", 0xF5, 4, 1, 32000, 32000),
    ("STATICCALL", 0xFA, 6, 1, 700, 700 + 9000 + 25000),
    ("REVERT", 0xFD, 2, 0, 0, 0),
    ("INVALID", 0xFE, 0, 0, 0, 0),
    ("SELFDESTRUCT", 0xFF, 1, 0, 5000, 30000),
)


def _build() -> Dict[str, Dict]:
    table: Dict[str, Dict] = {}
    for name, byte, pops, pushes, gmin, gmax in _SPEC:
        table[name] = {GAS: (gmin, gmax), STACK: (pops, pushes), ADDRESS: byte}
    for i in range(1, 33):
        table[f"PUSH{i}"] = {GAS: (3, 3), STACK: (0, 1), ADDRESS: 0x5F + i}
    for i in range(1, 17):
        # DUPn peeks n and pushes 1 (net stack metadata matches the reference:
        # the underflow precheck uses the dedicated logic in instruction_data).
        table[f"DUP{i}"] = {GAS: (3, 3), STACK: (0, 0), ADDRESS: 0x7F + i}
        table[f"SWAP{i}"] = {GAS: (3, 3), STACK: (0, 1), ADDRESS: 0x8F + i}
    return table


OPCODES: Dict[str, Dict] = _build()

ADDRESS_OPCODE_MAPPING: Dict[int, str] = {
    data[ADDRESS]: name for name, data in OPCODES.items()
}
