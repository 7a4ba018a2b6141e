"""Path-condition container (reference parity:
mythril/laser/ethereum/state/constraints.py:13-131)."""

from copy import copy
from typing import Iterable, List, Optional, Union

from ...exceptions import SolverTimeOutException, UnsatError
from ...smt import Bool, simplify, symbol_factory


class Constraints(list):
    """A list of path constraints with feasibility helpers. The keccak
    axioms (function-manager conditions) are appended on demand by
    get_all_constraints/as_list."""

    def __init__(self, constraint_list: Optional[List[Bool]] = None) -> None:
        constraint_list = constraint_list or []
        constraint_list = self._get_smt_bool_list(constraint_list)
        super(Constraints, self).__init__(constraint_list)

    def is_possible(self, solver_timeout=None) -> bool:
        """True iff the constraint set has a solution within the timeout
        (timeout -> False for the default analysis timeout, True for a
        short custom one — same pessimism policy as the reference)."""
        from ...support.model import get_model

        try:
            get_model(self, solver_timeout=solver_timeout)
        except SolverTimeOutException:
            return solver_timeout is not None
        except UnsatError:
            return False
        return True

    def get_model(self, solver_timeout=None):
        from ...support.model import get_model

        try:
            return get_model(self, solver_timeout=solver_timeout)
        except (SolverTimeOutException, UnsatError):
            return None

    def append(self, constraint: Union[bool, Bool]) -> None:
        constraint = (
            simplify(constraint)
            if isinstance(constraint, Bool)
            else symbol_factory.Bool(constraint)
        )
        # trivially-true constraints (e.g. a concrete JUMPI's folded
        # condition) carry no information: dropping them keeps solver
        # input minimal and makes the interpreter's constraint list
        # identical to the lane engine's, which never records concrete
        # branches
        if constraint.is_true:
            return
        super(Constraints, self).append(constraint)

    @property
    def as_list(self) -> List[Bool]:
        from ..function_managers import keccak_function_manager

        return self[:] + [keccak_function_manager.create_conditions()]

    def get_all_constraints(self) -> List[Bool]:
        from ..function_managers import keccak_function_manager

        return self[:] + [keccak_function_manager.create_conditions()]

    def __copy__(self) -> "Constraints":
        constraint_list = list(self)
        return Constraints(constraint_list)

    def copy(self) -> "Constraints":
        return self.__copy__()

    def __deepcopy__(self, memodict=None) -> "Constraints":
        # Bool wrappers are immutable-by-convention; a shallow copy is safe
        return self.__copy__()

    def __add__(self, constraints: Iterable[Union[bool, Bool]]):
        constraints_list = self._get_smt_bool_list(constraints)
        return Constraints(constraint_list=super().__add__(constraints_list))

    def __iadd__(self, constraints: Iterable[Union[bool, Bool]]):
        list.__iadd__(self, self._get_smt_bool_list(constraints))
        return self

    @staticmethod
    def _get_smt_bool_list(constraints) -> List[Bool]:
        return [
            constraint
            if isinstance(constraint, Bool)
            else symbol_factory.Bool(constraint)
            for constraint in constraints
        ]

    def __hash__(self):
        return tuple(c.raw.tid for c in self).__hash__()
