"""CALL-family parameter extraction and native-contract routing
(capability parity: mythril/laser/ethereum/call.py:36-257)."""

import logging
import re
from typing import List, Optional, Union

from ..smt import BitVec, Expression, If, simplify, symbol_factory
from ..support.eth_constants import GAS_CALLSTIPEND
from . import natives, util
from .cheat_code import handle_cheat_codes, hevm_cheat_code
from .instruction_data import calculate_native_gas
from .natives import PRECOMPILE_COUNT, PRECOMPILE_FUNCTIONS
from .state.account import Account
from .state.calldata import BaseCalldata, ConcreteCalldata, SymbolicCalldata
from .state.global_state import GlobalState
from .util import insert_ret_val

log = logging.getLogger(__name__)

SYMBOLIC_CALLDATA_SIZE = 320  # bound used when copying symbolic calldata


def get_call_parameters(global_state: GlobalState, dynamic_loader,
                        with_value=False):
    """Pop CALL parameters and resolve callee/calldata/value/gas."""
    gas, to = global_state.mstate.pop(2)
    value = global_state.mstate.pop() if with_value else 0
    (
        memory_input_offset,
        memory_input_size,
        memory_out_offset,
        memory_out_size,
    ) = global_state.mstate.pop(4)

    callee_address = get_callee_address(global_state, dynamic_loader, to)

    callee_account = None
    call_data = get_call_data(
        global_state, memory_input_offset, memory_input_size
    )
    if isinstance(callee_address, BitVec) or (
        isinstance(callee_address, str)
        and (
            int(callee_address, 16) > PRECOMPILE_COUNT
            or int(callee_address, 16) == 0
        )
    ):
        callee_account = get_callee_account(
            global_state, callee_address, dynamic_loader
        )

    gas = gas + If(
        value > 0, symbol_factory.BitVecVal(GAS_CALLSTIPEND, gas.size()), 0
    )
    return (
        callee_address,
        callee_account,
        call_data,
        value,
        gas,
        memory_out_offset,
        memory_out_size,
    )


def _padded_hex_address(address: int) -> str:
    return "0x{:040x}".format(address)


def get_callee_address(global_state: GlobalState, dynamic_loader,
                       symbolic_to_address: Expression):
    """Resolve the callee address: concrete, storage-indirected via the
    dynamic loader, or left symbolic."""
    environment = global_state.environment
    try:
        return _padded_hex_address(
            util.get_concrete_int(symbolic_to_address)
        )
    except TypeError:
        log.debug("Symbolic call encountered")

    match = re.search(
        r"Storage\[(\d+)\]", str(simplify(symbolic_to_address))
    )
    if match is None or dynamic_loader is None:
        return symbolic_to_address

    index = int(match.group(1))
    try:
        callee_address = dynamic_loader.read_storage(
            "0x{:040X}".format(environment.active_account.address.value),
            index,
        )
    except Exception:
        return symbolic_to_address
    if not re.match(r"^0x[0-9a-f]{40}$", callee_address):
        callee_address = "0x" + callee_address[26:]
    return callee_address


def get_callee_account(global_state: GlobalState,
                       callee_address: Union[str, BitVec],
                       dynamic_loader):
    """The callee's account (fresh symbolic account for symbolic
    addresses)."""
    if isinstance(callee_address, BitVec):
        if callee_address.symbolic:
            return Account(
                callee_address, balances=global_state.world_state.balances
            )
        callee_address = hex(callee_address.value)[2:]
    return global_state.world_state.accounts_exist_or_load(
        callee_address, dynamic_loader
    )


def get_call_data(global_state: GlobalState,
                  memory_start: Union[int, BitVec],
                  memory_size: Union[int, BitVec]):
    """Build callee calldata from caller memory; symbolic layout degrades
    to fully symbolic calldata."""
    state = global_state.mstate
    transaction_id = "{}_internalcall".format(
        global_state.current_transaction.id
    )
    if isinstance(memory_start, int):
        memory_start = symbol_factory.BitVecVal(memory_start, 256)
    if isinstance(memory_size, int):
        memory_size = symbol_factory.BitVecVal(memory_size, 256)
    if memory_size.symbolic:
        memory_size = SYMBOLIC_CALLDATA_SIZE
    try:
        calldata_from_mem = state.memory[
            util.get_concrete_int(memory_start) : util.get_concrete_int(
                memory_start + memory_size
            )
        ]
        return ConcreteCalldata(transaction_id, calldata_from_mem)
    except TypeError:
        log.debug("Unsupported symbolic memory offset and size")
        return SymbolicCalldata(transaction_id)


def native_call(
    global_state: GlobalState,
    callee_address: Union[str, BitVec],
    call_data: BaseCalldata,
    memory_out_offset: Union[int, Expression],
    memory_out_size: Union[int, Expression],
) -> Optional[List[GlobalState]]:
    """Route calls to precompiles 1-9 and the hevm cheat address; returns
    None when the callee is a regular contract."""
    if isinstance(callee_address, BitVec) or not (
        0 < int(callee_address, 16) <= PRECOMPILE_COUNT
        or hevm_cheat_code.is_cheat_address(callee_address)
    ):
        return None

    if hevm_cheat_code.is_cheat_address(callee_address):
        log.info("HEVM cheat code address triggered")
        handle_cheat_codes(
            global_state,
            callee_address,
            call_data,
            memory_out_offset,
            memory_out_size,
        )
        return [global_state]

    log.debug("Native contract called: %s", callee_address)
    try:
        mem_out_start = util.get_concrete_int(memory_out_offset)
        mem_out_sz = util.get_concrete_int(memory_out_size)
    except TypeError:
        insert_ret_val(global_state)
        log.debug("CALL with symbolic start or offset not supported")
        return [global_state]

    call_address_int = int(callee_address, 16)
    native_gas_min, native_gas_max = calculate_native_gas(
        global_state.mstate.calculate_extension_size(
            mem_out_start, mem_out_sz
        ),
        PRECOMPILE_FUNCTIONS[call_address_int - 1].__name__,
    )
    global_state.mstate.min_gas_used += native_gas_min
    global_state.mstate.max_gas_used += native_gas_max
    global_state.mstate.mem_extend(mem_out_start, mem_out_sz)

    try:
        data = natives.native_contracts(call_address_int, call_data)
    except natives.NativeContractException:
        for i in range(mem_out_sz):
            global_state.mstate.memory[
                mem_out_start + i
            ] = global_state.new_bitvec(
                PRECOMPILE_FUNCTIONS[call_address_int - 1].__name__
                + "("
                + str(call_data)
                + ")",
                8,
            )
        insert_ret_val(global_state)
        return [global_state]

    for i in range(min(len(data), mem_out_sz)):
        global_state.mstate.memory[mem_out_start + i] = data[i]
    insert_ret_val(global_state)
    return [global_state]
