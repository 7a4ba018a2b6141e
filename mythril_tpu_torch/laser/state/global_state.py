"""GlobalState: the complete state of one execution path (capability
parity: mythril/laser/ethereum/state/global_state.py:21-184)."""

from copy import copy, deepcopy
from typing import Dict, Iterable, List, Optional, Union

from ...smt import BitVec, symbol_factory
from ...support.eth_constants import FRAME_GAS_LIMIT
from .annotation import StateAnnotation
from .environment import Environment
from .machine_state import MachineState
from .world_state import WorldState


class GlobalState:
    """One path's full state: world state, environment, machine state, the
    transaction call stack, and annotations."""

    def __init__(
        self,
        world_state: WorldState,
        environment: Environment,
        node=None,
        machine_state=None,
        transaction_stack=None,
        last_return_data=None,
        annotations=None,
    ) -> None:
        self.node = node
        self.world_state = world_state
        self.environment = environment
        self.mstate = (
            machine_state
            if machine_state
            else MachineState(gas_limit=FRAME_GAS_LIMIT)
        )
        self.transaction_stack = transaction_stack if transaction_stack else []
        self.op_code = ""
        self.last_return_data = last_return_data
        self._annotations = annotations or []

    def add_annotations(self, annotations: List[StateAnnotation]):
        self._annotations += annotations

    def __copy__(self) -> "GlobalState":
        """Copy for sequential stepping: world/env shallow-copied (storage
        logs fork internally), machine state deep-copied."""
        world_state = copy(self.world_state)
        environment = copy(self.environment)
        mstate = deepcopy(self.mstate)
        transaction_stack = copy(self.transaction_stack)
        environment.active_account = world_state[
            environment.active_account.address
        ]
        return GlobalState(
            world_state,
            environment,
            self.node,
            mstate,
            transaction_stack=transaction_stack,
            last_return_data=self.last_return_data,
            annotations=[copy(a) for a in self._annotations],
        )

    def __deepcopy__(self, _) -> "GlobalState":
        """Fork copy (JUMPI): identical to copy in this build — world-state
        copy already forks accounts/storage; constraints are copied lists of
        immutable terms."""
        return self.__copy__()

    @property
    def accounts(self) -> Dict:
        return self.world_state.accounts

    def get_current_instruction(self) -> Dict:
        instructions = self.environment.code.instruction_list
        return instructions[self.mstate.pc]

    @property
    def current_transaction(self):
        try:
            return self.transaction_stack[-1][0]
        except IndexError:
            return None

    @property
    def instruction(self) -> Dict:
        return self.get_current_instruction()

    def new_bitvec(self, name: str, size=256, annotations=None) -> BitVec:
        """Fresh tx-scoped symbol: '{txid}_{name}'."""
        transaction_id = self.current_transaction.id
        return symbol_factory.BitVecSym(
            "{}_{}".format(transaction_id, name), size,
            annotations=annotations,
        )

    def annotate(self, annotation: StateAnnotation) -> None:
        self._annotations.append(annotation)
        if annotation.persist_to_world_state:
            self.world_state.annotate(annotation)

    @property
    def annotations(self) -> List[StateAnnotation]:
        return self._annotations

    def get_annotations(self, annotation_type: type) -> Iterable:
        return filter(
            lambda x: isinstance(x, annotation_type), self._annotations
        )
