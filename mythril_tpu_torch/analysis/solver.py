"""Counterexample generation: concrete transaction sequences from path
constraints (capability parity: mythril/analysis/solver.py:54-259)."""

import logging
from typing import Any, Dict, List, Tuple, Union

from ..exceptions import UnsatError
from ..laser.function_managers import keccak_function_manager
from ..laser.state.constraints import Constraints
from ..laser.state.global_state import GlobalState
from ..laser.transaction import BaseTransaction
from ..laser.transaction.transaction_models import (
    ContractCreationTransaction,
)
from ..smt import UGE, symbol_factory
from ..support.model import get_model

log = logging.getLogger(__name__)


def pretty_print_model(model) -> str:
    """Human-readable model dump."""
    ret = ""
    for name in model.decls():
        value = model[name]
        if isinstance(value, bool):
            ret += "%s: %s\n" % (name, value)
        else:
            ret += "%s: 0x%x\n" % (name, value)
    return ret


def get_transaction_sequence(
    global_state: GlobalState, constraints: Constraints
) -> Dict[str, Any]:
    """Generate a concrete transaction sequence reproducing the state.

    Only the given constraints are considered (they may differ from the
    global state's own constraints)."""
    transaction_sequence = global_state.world_state.transaction_sequence
    concrete_transactions = []
    tx_constraints, minimize = _set_minimisation_constraints(
        transaction_sequence,
        constraints.copy(),
        [],
        5000,
        global_state.world_state,
    )

    model = get_model(tx_constraints, minimize=minimize)

    if isinstance(transaction_sequence[0], ContractCreationTransaction):
        initial_world_state = transaction_sequence[0].prev_world_state
    else:
        initial_world_state = transaction_sequence[0].world_state
    initial_accounts = initial_world_state.accounts

    for transaction in transaction_sequence:
        concrete_transactions.append(
            _get_concrete_transaction(model, transaction)
        )

    min_price_dict: Dict[str, int] = {}
    for address in initial_accounts.keys():
        balance = model.eval(
            initial_world_state.starting_balances[
                symbol_factory.BitVecVal(address, 256)
            ],
            model_completion=True,
        )
        min_price_dict[address] = balance.value if balance else 0

    concrete_initial_state = _get_concrete_state(
        initial_accounts, min_price_dict
    )
    if isinstance(transaction_sequence[0], ContractCreationTransaction):
        code = transaction_sequence[0].code
        _replace_with_actual_sha(concrete_transactions, model, code)
    else:
        _replace_with_actual_sha(concrete_transactions, model)
    _add_calldata_placeholder(concrete_transactions, transaction_sequence)
    return {
        "initialState": concrete_initial_state,
        "steps": concrete_transactions,
    }


def _add_calldata_placeholder(
    concrete_transactions: List[Dict[str, str]],
    transaction_sequence: List[BaseTransaction],
):
    """calldata view of input (input minus creation code for tx 0)."""
    for tx in concrete_transactions:
        tx["calldata"] = tx["input"]
    if not isinstance(
        transaction_sequence[0], ContractCreationTransaction
    ):
        return
    if type(transaction_sequence[0].code.bytecode) == tuple:
        code_len = len(transaction_sequence[0].code.bytecode) * 2
    else:
        code_len = len(transaction_sequence[0].code.bytecode)
    concrete_transactions[0]["calldata"] = concrete_transactions[0][
        "input"
    ][code_len + 2 :]


def _replace_with_actual_sha(
    concrete_transactions: List[Dict[str, str]], model, code=None
):
    """Swap interval-placeholder hash values in concrete calldata for the
    real keccak of the recovered preimage."""
    concrete_hashes = keccak_function_manager.get_concrete_hash_data(model)
    for tx in concrete_transactions:
        if not keccak_function_manager.might_contain_placeholder(
                tx["input"]):
            continue
        if code is not None and code.bytecode in tx["input"]:
            s_index = len(code.bytecode) + 2
        else:
            s_index = 10
        for i in range(s_index, len(tx["input"])):
            data_slice = tx["input"][i : i + 64]
            if (
                len(data_slice) != 64
                or not keccak_function_manager
                .might_contain_placeholder(data_slice)
            ):
                continue
            find_input = symbol_factory.BitVecVal(
                int(data_slice, 16), 256
            )
            input_ = None
            for size in concrete_hashes:
                if find_input.value not in concrete_hashes[size]:
                    continue
                inverse = keccak_function_manager.inverse_for(size)
                inv_value = model.eval(
                    inverse(find_input), model_completion=True
                )
                if inv_value is None:
                    continue
                input_ = symbol_factory.BitVecVal(inv_value.value, size)
            if input_ is None:
                continue
            keccak = keccak_function_manager.find_concrete_keccak(input_)
            hex_keccak = hex(keccak.value)[2:].zfill(64)
            tx["input"] = tx["input"][:s_index] + tx["input"][
                s_index:
            ].replace(tx["input"][i : 64 + i], hex_keccak)


def _get_concrete_state(initial_accounts: Dict,
                        min_price_dict: Dict[str, int]):
    accounts = {}
    for address, account in initial_accounts.items():
        data: Dict[str, Union[int, str]] = {
            "nonce": account.nonce,
            "code": account.serialised_code(),
            "storage": str(account.storage.printable_storage),
            "balance": hex(min_price_dict.get(address, 0)),
        }
        accounts[hex(address)] = data
    return {"accounts": accounts}


def _get_concrete_transaction(model, transaction: BaseTransaction):
    address = hex(transaction.callee_account.address.value)
    value_eval = model.eval(
        transaction.call_value, model_completion=True
    )
    value = value_eval.value if value_eval else 0
    caller_eval = model.eval(transaction.caller, model_completion=True)
    caller = "0x" + (
        "%x" % (caller_eval.value if caller_eval else 0)
    ).zfill(40)

    input_ = ""
    if isinstance(transaction, ContractCreationTransaction):
        address = ""
        input_ += transaction.code.bytecode

    input_ += "".join(
        [
            "%02x" % b
            for b in transaction.call_data.concrete(model)
        ]
    )
    return {
        "input": "0x" + input_,
        "value": "0x%x" % value,
        "origin": caller,
        "address": "%s" % address,
    }


def _set_minimisation_constraints(
    transaction_sequence, constraints, minimize, max_size, world_state
) -> Tuple[Constraints, tuple]:
    """Bound calldata sizes and balances; minimize calldata size and call
    value per transaction."""
    for transaction in transaction_sequence:
        max_calldata_size = symbol_factory.BitVecVal(max_size, 256)
        constraints.append(
            UGE(max_calldata_size, transaction.call_data.calldatasize)
        )
        minimize.append(transaction.call_data.calldatasize)
        minimize.append(transaction.call_value)
        constraints.append(
            UGE(
                symbol_factory.BitVecVal(1000000000000000000000, 256),
                world_state.starting_balances[transaction.caller],
            )
        )
    for account in world_state.accounts.values():
        # each account starts with less than 100 ETH: prevents balance
        # overflow artifacts in generated sequences
        constraints.append(
            UGE(
                symbol_factory.BitVecVal(100000000000000000000, 256),
                world_state.starting_balances[account.address],
            )
        )
    return constraints, tuple(minimize)
