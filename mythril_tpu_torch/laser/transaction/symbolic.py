"""Symbolic transaction executors over entry waves (capability parity:
mythril/laser/ethereum/transaction/symbolic.py:29-247 — redesigned
wave-first; see transaction/entry.py for the planner)."""

import logging

from ...disassembler.disassembly import Disassembly
from ...smt import BitVec, symbol_factory
from ..state.world_state import WorldState
from .entry import ACTORS, Actors, EntryWave, FUNCTION_HASH_BYTE_LENGTH
from .transaction_models import (
    Account,
    ContractCreationTransaction,
)

__all__ = [
    "ACTORS",
    "Actors",
    "FUNCTION_HASH_BYTE_LENGTH",
    "execute_contract_creation",
    "execute_message_call",
    "execute_transaction",
]

log = logging.getLogger(__name__)


def execute_message_call(laser_evm, callee_address: BitVec,
                         func_hashes=None) -> None:
    """Plan one wave of symbolic message calls — one entry per open
    world state whose callee is alive — then run the engine once over
    the whole wave (the lane sweep flood-seeds it in one window)."""
    states = laser_evm.open_states[:]
    del laser_evm.open_states[:]

    live = []
    for ws in states:
        if ws[callee_address].deleted:
            log.debug("Can not execute dead contract, skipping.")
            continue
        live.append(ws)

    wave = EntryWave(laser_evm, len(live), func_hashes)
    for i, ws in enumerate(live):
        wave.spawn_call(i, ws, ws[callee_address])
    laser_evm.exec()


def execute_contract_creation(
    laser_evm,
    contract_initialization_code,
    contract_name=None,
    world_state=None,
    origin=ACTORS["CREATOR"],
    caller=ACTORS["CREATOR"],
) -> Account:
    """Run the creation transaction; returns the new account."""
    del laser_evm.open_states[:]
    wave = EntryWave(laser_evm, 1)
    tid = str(wave.base)
    transaction = ContractCreationTransaction(
        world_state=world_state or WorldState(),
        identifier=tid,
        gas_price=symbol_factory.BitVecSym(f"gas_price{tid}", 256),
        gas_limit=8000000,  # block gas limit
        origin=origin,
        code=Disassembly(contract_initialization_code),
        caller=caller,
        contract_name=contract_name,
        call_data=None,
        call_value=symbol_factory.BitVecSym(f"call_value{tid}", 256),
    )
    wave.enqueue(transaction)
    laser_evm.exec(True)
    return transaction.callee_account


def execute_transaction(laser_evm, callee_address: str = "",
                        data: str = "", **kwargs) -> None:
    """Dispatch a symbolic transaction by callee address: '' = creation
    from `data`, else a symbolic message call to that address (reference
    transaction/symbolic.py:246-264; used by concolic branch flipping,
    where the re-run must be symbolic so JUMPIs fork and the deviating
    path carries the negated branch constraint)."""
    if callee_address == "":
        for ws in laser_evm.open_states[:]:
            execute_contract_creation(
                laser_evm=laser_evm,
                contract_initialization_code=data,
                world_state=ws,
            )
        return
    execute_message_call(
        laser_evm=laser_evm,
        callee_address=symbol_factory.BitVecVal(int(callee_address, 16),
                                                256),
    )
