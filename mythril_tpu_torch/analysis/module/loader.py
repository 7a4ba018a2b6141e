"""Detection-module registry (capability parity:
mythril/analysis/module/loader.py:31-115)."""

from typing import List, Optional

from ...exceptions import DetectorNotFoundError
from ...support.support_args import args
from ...support.support_utils import Singleton
from .base import DetectionModule, EntryPoint
from .modules.arbitrary_jump import ArbitraryJump
from .modules.arbitrary_write import ArbitraryStorage
from .modules.delegatecall import ArbitraryDelegateCall
from .modules.dependence_on_origin import TxOrigin
from .modules.dependence_on_predictable_vars import PredictableVariables
from .modules.ether_thief import EtherThief
from .modules.exceptions import Exceptions
from .modules.external_calls import ExternalCalls
from .modules.integer import IntegerArithmetics
from .modules.multiple_sends import MultipleSends
from .modules.state_change_external_calls import StateChangeAfterCall
from .modules.suicide import AccidentallyKillable
from .modules.unbounded_loop_gas import UnboundedLoopGas
from .modules.unchecked_retval import UncheckedRetval
from .modules.user_assertions import UserAssertions


class ModuleLoader(object, metaclass=Singleton):
    """Singleton registry of the built-in (and user-registered) detection
    modules."""

    def __init__(self):
        self._modules: List[DetectionModule] = []
        self._register_mythril_modules()

    def register_module(self, detection_module: DetectionModule):
        if not isinstance(detection_module, DetectionModule):
            raise ValueError(
                "The passed variable is not a valid detection module"
            )
        self._modules.append(detection_module)

    def get_detection_modules(
        self,
        entry_point: Optional[EntryPoint] = None,
        white_list: Optional[List[str]] = None,
    ) -> List[DetectionModule]:
        result = self._modules[:]
        if white_list:
            available_names = [
                type(module).__name__ for module in result
            ]
            for name in white_list:
                if name not in available_names:
                    raise DetectorNotFoundError(
                        "Invalid detection module: {}".format(name)
                    )
            result = [
                module
                for module in result
                if type(module).__name__ in white_list
            ]
        if args.use_integer_module is False:
            result = [
                module
                for module in result
                if type(module).__name__ != "IntegerArithmetics"
            ]
        if entry_point:
            result = [
                module
                for module in result
                if module.entry_point == entry_point
            ]
        return result

    def _register_mythril_modules(self):
        self._modules.extend(
            [
                ArbitraryJump(),
                ArbitraryStorage(),
                ArbitraryDelegateCall(),
                PredictableVariables(),
                TxOrigin(),
                EtherThief(),
                Exceptions(),
                ExternalCalls(),
                IntegerArithmetics(),
                MultipleSends(),
                StateChangeAfterCall(),
                AccidentallyKillable(),
                UnboundedLoopGas(),
                UncheckedRetval(),
                UserAssertions(),
            ]
        )
