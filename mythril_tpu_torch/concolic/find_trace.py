"""Concrete replay with trace recording (capability parity:
mythril/concolic/find_trace.py:22-92).

Unlike the reference — which requires the external `myth_concolic_execution`
pip plugin for its trace recorder (find_trace.py:56) — the recorder here is
built in: a laser plugin hooked on the `execute_state` channel that logs
each executed instruction address, split per top-level transaction."""

import binascii
import logging
from typing import List, Tuple

from ..disassembler.disassembly import Disassembly
from ..laser.plugin.interface import LaserPlugin
from ..laser.state.world_state import WorldState
from ..laser.svm import LaserEVM
from ..laser.transaction.concolic import execute_transaction
from ..smt import symbol_factory

log = logging.getLogger(__name__)


class TraceRecorder(LaserPlugin):
    """Records the (instruction address) trace of each top-level
    transaction; `tx_traces` is a list of per-transaction address lists.

    The concrete replay path drives `laser_evm.exec()` directly (it
    bypasses `_execute_transactions`, so the `start_sym_trans` hook
    channel never fires); the per-transaction split is done explicitly by
    calling `start_transaction()` before each replayed tx."""

    def __init__(self):
        self.tx_traces: List[List[int]] = []

    def start_transaction(self) -> None:
        self.tx_traces.append([])

    def initialize(self, symbolic_vm: LaserEVM) -> None:
        @symbolic_vm.laser_hook("execute_state")
        def trace_jumpi_hook(global_state):
            if not self.tx_traces:
                self.tx_traces.append([])
            self.tx_traces[-1].append(
                global_state.get_current_instruction()["address"]
            )


def _to_int(value, default=0) -> int:
    if value is None:
        return default
    if isinstance(value, int):
        return value
    return int(value, 0)


def setup_concrete_initial_state(concrete_data) -> WorldState:
    """Build a WorldState from the JSON `initialState.accounts` section
    (reference find_trace.py:22-41)."""
    world_state = WorldState()
    for address, details in concrete_data["initialState"]["accounts"].items():
        account = world_state.create_account(
            balance=_to_int(details.get("balance")),
            address=int(address, 16),
            concrete_storage=True,
            nonce=details.get("nonce", 0),
        )
        code = details.get("code", "") or ""
        if code.startswith("0x"):
            code = code[2:]
        account.code = Disassembly(code)
        for key, value in (details.get("storage") or {}).items():
            account.storage[symbol_factory.BitVecVal(_to_int(key), 256)] = (
                symbol_factory.BitVecVal(_to_int(value), 256)
            )
    return world_state


def concrete_execution(concrete_data) -> Tuple[WorldState, List[List[int]]]:
    """Replay every step concretely, recording the instruction trace
    (reference find_trace.py:44-92). Returns (initial world state, per-tx
    address traces)."""
    init_state = setup_concrete_initial_state(concrete_data)
    laser_evm = LaserEVM(
        execution_timeout=1000, requires_statespace=False,
        use_reachability_check=False,
    )
    laser_evm.open_states = [init_state.__copy__()]
    recorder = TraceRecorder()
    recorder.initialize(laser_evm)

    for transaction in concrete_data["steps"]:
        recorder.start_transaction()
        data = transaction.get("input", "")
        if data.startswith("0x"):
            data = data[2:]
        try:
            data_bytes = list(binascii.unhexlify(data))
        except binascii.Error:
            raise ValueError(f"invalid transaction input hex: {data[:40]}")
        execute_transaction(
            laser_evm,
            callee_address=transaction.get("address", ""),
            caller_address=symbol_factory.BitVecVal(
                _to_int(transaction.get("origin")), 256
            ),
            origin_address=symbol_factory.BitVecVal(
                _to_int(transaction.get("origin")), 256
            ),
            code=None,
            gas_limit=_to_int(transaction.get("gasLimit"), 0x7FFFFFF),
            data=data_bytes,
            gas_price=_to_int(transaction.get("gasPrice")),
            value=_to_int(transaction.get("value")),
            track_gas=False,
        )

    log.debug("recorded %d tx traces", len(recorder.tx_traces))
    return init_state, recorder.tx_traces
