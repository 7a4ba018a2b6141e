"""The concrete-execution harness of ``tests/harness.py`` over the port
(``mythril_tpu_torch``): assemble a program, run one concrete message
call through the port's engine, inspect what it left."""

from mythril_tpu_torch.disassembler.disassembly import Disassembly
from mythril_tpu_torch.laser.state.world_state import WorldState
from mythril_tpu_torch.laser.svm import LaserEVM
from mythril_tpu_torch.laser.transaction.concolic import (
    execute_message_call,
)
from mythril_tpu_torch.smt import symbol_factory
from mythril_tpu_torch.support.opcodes import ADDRESS, OPCODES

ADDR = 0x0901F2C0AB0C0A0101010101010101010101F2C1
CALLER = 0xACE


def asm(*parts) -> bytearray:
    """Opcode names and raw byte payloads to bytecode."""
    out = bytearray()
    for p in parts:
        if isinstance(p, str):
            out.append(OPCODES[p][ADDRESS])
        else:
            out.extend(p)
    return out


def push(v: int, n: int = 32) -> bytearray:
    return asm(f"PUSH{n}", v.to_bytes(n, "big"))


def run_concrete(code: bytes, calldata=b"", value=0, balance=10**18):
    """Run ``code`` concretely on the port; returns (final states,
    laser)."""
    laser = LaserEVM(requires_statespace=False, execution_timeout=60)
    world_state = WorldState()
    account = world_state.create_account(address=ADDR,
                                         concrete_storage=True)
    account.set_balance(balance)
    account.code = Disassembly(code.hex())
    laser.open_states = [world_state]
    final_states = execute_message_call(
        laser,
        callee_address=symbol_factory.BitVecVal(ADDR, 256),
        caller_address=symbol_factory.BitVecVal(CALLER, 256),
        origin_address=symbol_factory.BitVecVal(CALLER, 256),
        code=code.hex(),
        data=list(calldata),
        gas_limit=8000000,
        gas_price=10,
        value=value,
        track_gas=True,
    )
    return final_states, laser
