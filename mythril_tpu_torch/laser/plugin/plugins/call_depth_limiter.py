"""Call-depth limit plugin (capability parity:
mythril/laser/plugin/plugins/call_depth_limiter.py:16-30)."""

from ...state.global_state import GlobalState
from ..builder import PluginBuilder
from ..interface import LaserPlugin
from ..signals import PluginSkipState


class CallDepthLimitBuilder(PluginBuilder):
    name = "call-depth-limit"

    def __call__(self, *args, **kwargs):
        return CallDepthLimit(kwargs["call_depth_limit"])


class CallDepthLimit(LaserPlugin):
    def __init__(self, call_depth_limit: int):
        self.call_depth_limit = call_depth_limit

    def initialize(self, symbolic_vm):
        @symbolic_vm.pre_hook("CALL")
        def call_depth_hook(global_state: GlobalState):
            if (
                len(global_state.transaction_stack) - 1
                == self.call_depth_limit
            ):
                raise PluginSkipState
