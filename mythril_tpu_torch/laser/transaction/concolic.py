"""Concrete transaction executors used for conformance replay and concolic
execution (capability parity:
mythril/laser/ethereum/transaction/concolic.py:23-174)."""

import logging
from typing import List

from ...exceptions import IllegalArgumentError
from ...smt import symbol_factory
from ..cfg import Edge, JumpType, Node
from ..state.calldata import ConcreteCalldata
from ..state.world_state import WorldState
from ..time_handler import time_handler
from .transaction_models import (
    BaseTransaction,
    ContractCreationTransaction,
    MessageCallTransaction,
    tx_id_manager,
)

log = logging.getLogger(__name__)


def execute_message_call(
    laser_evm,
    callee_address,
    caller_address,
    origin_address,
    code,
    data,
    gas_limit,
    gas_price,
    value,
    track_gas=False,
):
    """Run a concrete message call from every open state; returns final
    states when track_gas is set (used by the conformance harness)."""
    open_states = laser_evm.open_states[:]
    del laser_evm.open_states[:]

    for open_world_state in open_states:
        next_transaction_id = tx_id_manager.get_next_tx_id()
        transaction = MessageCallTransaction(
            world_state=open_world_state,
            identifier=next_transaction_id,
            gas_price=gas_price,
            gas_limit=gas_limit,
            origin=origin_address,
            code=laser_evm_code(code, open_world_state, callee_address),
            caller=caller_address,
            callee_account=open_world_state[callee_address],
            call_data=ConcreteCalldata(next_transaction_id, data),
            call_value=value,
        )
        _setup_global_state_for_execution(laser_evm, transaction)

    import datetime

    laser_evm.time = datetime.datetime.now()
    time_handler.start_execution(laser_evm.execution_timeout)
    return laser_evm.exec(track_gas=track_gas)


def laser_evm_code(code, world_state, callee_address):
    from ...disassembler.disassembly import Disassembly

    if code is None:
        return world_state[callee_address].code
    return Disassembly(code)


def execute_contract_creation(
    laser_evm,
    contract_initialization_code,
    caller_address,
    origin_address,
    data,
    gas_limit,
    gas_price,
    value,
    contract_name=None,
    world_state=None,
    track_gas=False,
):
    """Run a concrete creation transaction."""
    from ...disassembler.disassembly import Disassembly

    world_state = world_state or WorldState()
    open_states = [world_state]
    del laser_evm.open_states[:]
    final_states = []
    for open_world_state in open_states:
        next_transaction_id = tx_id_manager.get_next_tx_id()
        transaction = ContractCreationTransaction(
            world_state=open_world_state,
            identifier=next_transaction_id,
            gas_price=gas_price,
            gas_limit=gas_limit,
            origin=origin_address,
            code=Disassembly(contract_initialization_code),
            caller=caller_address,
            contract_name=contract_name,
            call_data=ConcreteCalldata(next_transaction_id, data),
            call_value=value,
        )
        _setup_global_state_for_execution(laser_evm, transaction)
    time_handler.start_execution(laser_evm.execution_timeout)
    result = laser_evm.exec(True, track_gas=track_gas)
    return result


def execute_transaction(*args, **kwargs) -> List:
    """Dispatch to creation or message-call execution based on the callee
    address (reference concolic.py:121-174)."""
    laser_evm = args[0]
    if kwargs["callee_address"] == "":
        return execute_contract_creation(
            laser_evm=laser_evm,
            contract_initialization_code=kwargs["data"],
            caller_address=kwargs["caller_address"],
            origin_address=kwargs["origin_address"],
            data=[],
            gas_limit=kwargs["gas_limit"],
            gas_price=kwargs["gas_price"],
            value=kwargs["value"],
            track_gas=kwargs.get("track_gas", False),
        )
    try:
        callee_address = symbol_factory.BitVecVal(
            int(kwargs["callee_address"], 16), 256
        )
    except ValueError:
        raise IllegalArgumentError(
            "invalid callee address: {}".format(kwargs["callee_address"])
        )
    return execute_message_call(
        laser_evm=laser_evm,
        callee_address=callee_address,
        caller_address=kwargs["caller_address"],
        origin_address=kwargs["origin_address"],
        code=kwargs.get("code"),
        data=kwargs["data"],
        gas_limit=kwargs["gas_limit"],
        gas_price=kwargs["gas_price"],
        value=kwargs["value"],
        track_gas=kwargs.get("track_gas", False),
    )


def _setup_global_state_for_execution(laser_evm,
                                      transaction: BaseTransaction) -> None:
    global_state = transaction.initial_global_state()
    global_state.transaction_stack.append((transaction, None))

    new_node = Node(
        global_state.environment.active_account.contract_name,
        function_name=global_state.environment.active_function_name,
    )
    if laser_evm.requires_statespace:
        laser_evm.nodes[new_node.uid] = new_node
    if transaction.world_state.node:
        if laser_evm.requires_statespace:
            laser_evm.edges.append(
                Edge(
                    transaction.world_state.node.uid,
                    new_node.uid,
                    edge_type=JumpType.Transaction,
                    condition=None,
                )
            )
        new_node.constraints = global_state.world_state.constraints

    global_state.world_state.transaction_sequence.append(transaction)
    global_state.node = new_node
    new_node.states.append(global_state)
    laser_evm.work_list.append(global_state)
