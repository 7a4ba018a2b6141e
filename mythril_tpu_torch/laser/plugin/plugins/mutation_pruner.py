"""Mutation pruner plugin (capability parity:
mythril/laser/plugin/plugins/mutation_pruner.py:22-89): world states whose
transaction made no mutation and provably transferred no value are not
re-queued — kills clean-path explosion."""

from ....exceptions import UnsatError
from ....smt import UGT, symbol_factory
from ....support.model import get_model
from ...state.global_state import GlobalState
from ...transaction.transaction_models import ContractCreationTransaction
from ..builder import PluginBuilder
from ..interface import LaserPlugin
from ..signals import PluginSkipWorldState
from .plugin_annotations import MutationAnnotation


class MutationPrunerBuilder(PluginBuilder):
    name = "mutation-pruner"

    def __call__(self, *args, **kwargs):
        return MutationPruner()


class MutationPruner(LaserPlugin):
    """Hooks mutating instructions to annotate states; filters un-mutated
    end states at add_world_state."""

    def initialize(self, symbolic_vm):
        # these hooks are lane_engine_safe: the lane bridge replicates
        # the annotation for device-executed SSTOREs
        # (laser/lane_engine.py materialize), and CALL/STATICCALL always
        # park to the host where the hook fires normally
        @symbolic_vm.pre_hook("SSTORE")
        def sstore_mutator_hook(global_state: GlobalState):
            global_state.annotate(MutationAnnotation())

        @symbolic_vm.pre_hook("CALL")
        def call_mutator_hook(global_state: GlobalState):
            global_state.annotate(MutationAnnotation())

        @symbolic_vm.pre_hook("STATICCALL")
        def staticcall_mutator_hook(global_state: GlobalState):
            global_state.annotate(MutationAnnotation())

        sstore_mutator_hook.lane_engine_safe = True
        call_mutator_hook.lane_engine_safe = True
        staticcall_mutator_hook.lane_engine_safe = True

        @symbolic_vm.laser_hook("add_world_state")
        def world_state_filter_hook(global_state: GlobalState):
            if isinstance(
                global_state.current_transaction,
                ContractCreationTransaction,
            ):
                return
            # a state is skipped only when it has NO mutation annotation
            # AND a positive callvalue is infeasible — so test the
            # annotation first: storage-mutated end states (the common
            # case, and EVERY lane-retired terminal in a fork storm)
            # keep their world state without any solver query. The
            # reference solves first (mutation_pruner.py:49-66); the
            # outcome is identical, but one get_model per end state was
            # the single largest host cost of a 32k-path terminal storm
            if list(global_state.get_annotations(MutationAnnotation)):
                return
            if isinstance(global_state.environment.callvalue, int):
                callvalue = symbol_factory.BitVecVal(
                    global_state.environment.callvalue, 256
                )
            else:
                callvalue = global_state.environment.callvalue
            try:
                constraints = global_state.world_state.constraints + [
                    UGT(callvalue, symbol_factory.BitVecVal(0, 256))
                ]
                get_model(constraints)
                return  # balance mutation possible
            except UnsatError:
                pass
            raise PluginSkipWorldState
