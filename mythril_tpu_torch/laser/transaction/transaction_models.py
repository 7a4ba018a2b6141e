"""Transaction models and control-flow signals (capability parity:
mythril/laser/ethereum/transaction/transaction_models.py:21-284 —
restructured wave-first: ids come from a block-reserving manager so a
whole entry wave shares one allocation, symbolic defaults are minted
from a descriptor table, and both transaction kinds share a single
entry-state spawner parameterized by an environment builder)."""

import logging
from copy import deepcopy
from typing import Optional

from ...smt import BitVec, UGE, symbol_factory
from ...support.support_utils import Singleton
from ..state.account import Account
from ..state.calldata import BaseCalldata, ConcreteCalldata, SymbolicCalldata
from ..state.environment import Environment
from ..state.global_state import GlobalState
from ..state.return_data import ReturnData
from ..state.world_state import WorldState

log = logging.getLogger(__name__)


class TxIdManager(object, metaclass=Singleton):
    """Monotone transaction-id source. The wave-based entry layer
    (transaction/entry.py) reserves CONTIGUOUS BLOCKS so one allocation
    serves a whole wave of open states; single-id callers (CALL-family
    sub-transactions, concolic replays) draw blocks of one."""

    def __init__(self):
        self._next = 0

    def reserve_block(self, size: int) -> int:
        """First id of a fresh block of `size` consecutive ids."""
        base = self._next + 1
        self._next += size
        return base

    def get_next_tx_id(self) -> str:
        return str(self.reserve_block(1))

    def restart_counter(self):
        self._next = 0

    def set_counter(self, tx_id):
        self._next = tx_id


tx_id_manager = TxIdManager()


class TransactionEndSignal(Exception):
    """Raised when a transaction is finalized."""

    def __init__(self, global_state: GlobalState, revert=False) -> None:
        self.global_state = global_state
        self.revert = revert


class TransactionStartSignal(Exception):
    """Raised when a nested transaction starts (CALL/CREATE family)."""

    def __init__(self, transaction, op_code: str,
                 global_state: GlobalState) -> None:
        self.transaction = transaction
        self.op_code = op_code
        self.global_state = global_state


#: tx fields minted as fresh symbols when the caller leaves them None:
#: attribute name -> symbol-name prefix (suffixed with the tx id)
_SYMBOLIC_FIELDS = (
    ("gas_price", "gasprice"),
    ("base_fee", "basefee"),
    ("origin", "origin"),
    ("call_value", "callvalue"),
)


class BaseTransaction:
    """Common transaction data. Subclasses declare the entry function
    name and how the entry Environment is built; id/symbol minting, the
    value transfer, and entry-state spawning live here once."""

    entry_function = "fallback"

    def __init__(
        self,
        world_state: WorldState,
        callee_account: Account = None,
        caller: BitVec = None,
        call_data=None,
        identifier: Optional[str] = None,
        gas_price=None,
        gas_limit=None,
        origin=None,
        code=None,
        call_value=None,
        init_call_data=True,
        static=False,
        base_fee=None,
    ) -> None:
        assert isinstance(world_state, WorldState)
        self.world_state = world_state
        self.id = identifier or tx_id_manager.get_next_tx_id()
        self.gas_limit = gas_limit
        self.code = code
        self.caller = caller
        self.callee_account = callee_account
        self.static = static
        self.return_data: Optional[ReturnData] = None

        given = dict(gas_price=gas_price, base_fee=base_fee,
                     origin=origin, call_value=call_value)
        for field, prefix in _SYMBOLIC_FIELDS:
            value = given[field]
            if value is None:
                value = symbol_factory.BitVecSym(
                    f"{prefix}{identifier}", 256
                )
            setattr(self, field, value)

        if call_data is None and init_call_data:
            self.call_data: BaseCalldata = SymbolicCalldata(self.id)
        else:
            self.call_data = (
                call_data
                if isinstance(call_data, BaseCalldata)
                else ConcreteCalldata(self.id, [])
            )

    # -- entry-state spawning ---------------------------------------------

    def _entry_environment(self) -> Environment:
        raise NotImplementedError

    def initial_global_state(self) -> GlobalState:
        """Entry GlobalState: build this kind's environment, apply the
        value transfer to the world state (with the solvency
        constraint), spawn."""
        environment = self._entry_environment()
        global_state = GlobalState(self.world_state, environment, None)
        global_state.environment.active_function_name = \
            self.entry_function

        value = environment.callvalue
        if not isinstance(value, BitVec):
            value = symbol_factory.BitVecVal(value, 256)
        world_state = global_state.world_state
        sender = environment.sender
        world_state.constraints.append(
            UGE(world_state.balances[sender], value)
        )
        world_state.balances[environment.active_account.address] += value
        world_state.balances[sender] -= value
        return global_state

    def __str__(self) -> str:
        callee = self.callee_account
        if callee is not None and callee.address.symbolic is False:
            to = "{:#42x}".format(callee.address.value)
        elif callee is not None:
            to = str(callee.address)
        else:
            to = "{:#42x}".format(-1)
        return "{} {} from {} to {}".format(
            self.__class__.__name__, self.id, self.caller, to
        )


class MessageCallTransaction(BaseTransaction):
    """A message call into an existing account."""

    def _entry_environment(self) -> Environment:
        return Environment(
            self.callee_account,
            self.caller,
            self.call_data,
            self.gas_price,
            self.call_value,
            self.origin,
            self.base_fee,
            code=self.code or self.callee_account.code,
            static=self.static,
        )

    def end(self, global_state: GlobalState, return_data=None,
            revert=False) -> None:
        self.return_data = return_data
        raise TransactionEndSignal(global_state, revert)


class ContractCreationTransaction(BaseTransaction):
    """Contract creation; snapshots the pre-state and assigns returned
    runtime code to the new account at end()."""

    entry_function = "constructor"

    def __init__(
        self,
        world_state: WorldState,
        caller: BitVec = None,
        call_data=None,
        identifier: Optional[str] = None,
        gas_price=None,
        gas_limit=None,
        origin=None,
        code=None,
        call_value=None,
        contract_name=None,
        contract_address=None,
        base_fee=None,
    ) -> None:
        self.prev_world_state = deepcopy(world_state)
        contract_address = (
            contract_address if isinstance(contract_address, int) else None
        )
        callee_account = world_state.create_account(
            0,
            concrete_storage=True,
            creator=caller.value,
            address=contract_address,
        )
        callee_account.contract_name = (
            contract_name or callee_account.contract_name
        )
        # calldata stays symbolic; codecopy/codesize handle constructor
        # arguments appended past the creation code
        super().__init__(
            world_state=world_state,
            callee_account=callee_account,
            caller=caller,
            call_data=call_data,
            identifier=identifier,
            gas_price=gas_price,
            gas_limit=gas_limit,
            origin=origin,
            code=code,
            call_value=call_value,
            init_call_data=True,
            base_fee=base_fee,
        )

    def _entry_environment(self) -> Environment:
        return Environment(
            active_account=self.callee_account,
            sender=self.caller,
            calldata=self.call_data,
            gasprice=self.gas_price,
            callvalue=self.call_value,
            origin=self.origin,
            basefee=self.base_fee,
            code=self.code,
        )

    def end(self, global_state: GlobalState, return_data=None,
            revert=False):
        if return_data is None or return_data.size == 0:
            self.return_data = None
            raise TransactionEndSignal(global_state, revert=revert)

        global_state.environment.active_account.code.assign_bytecode(
            tuple(return_data.return_data)
        )
        return_bytes = str(
            hex(global_state.environment.active_account.address.value)
        )
        self.return_data = ReturnData(
            return_bytes, len(return_bytes) // 2
        )
        assert (
            global_state.environment.active_account.code.instruction_list
            != []
        )
        raise TransactionEndSignal(global_state, revert=revert)
