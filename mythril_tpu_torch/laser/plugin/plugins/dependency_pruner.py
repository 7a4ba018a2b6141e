"""Dependency pruner plugin (capability parity:
mythril/laser/plugin/plugins/dependency_pruner.py:80-308).

Capability: from transaction 2 on, a basic block the engine has already
explored only re-executes when a storage slot read on some path through
it MAY alias a slot written by the previous transaction (or a CALL
taints the path). Everything else about the re-visit is provably
identical, so the state is skipped.

Re-designed around a per-block dependency index and a memoized
may-alias oracle rather than the reference's parallel path->list maps:

- ``_BlockDeps`` holds, per jump-target address, the slots read and
  written by any path through the block and whether a CALL taints it;
- ``_may_alias`` answers "can these two slot terms be equal" with a
  concrete fast path (no solver for two literals) and a symmetric
  verdict memo — the same (read, write) term pair recurs across
  hundreds of block re-visits in a sweep and the reference re-proved
  it each time.
"""

import logging
from typing import Dict, Iterable, List, Set

from ....exceptions import UnsatError
from ....support.model import get_model
from ...state.global_state import GlobalState
from ...transaction.transaction_models import ContractCreationTransaction
from ..builder import PluginBuilder
from ..interface import LaserPlugin
from ..signals import PluginSkipState
from .plugin_annotations import DependencyAnnotation, WSDependencyAnnotation

log = logging.getLogger(__name__)


def get_dependency_annotation(state: GlobalState) -> DependencyAnnotation:
    annotations = list(state.get_annotations(DependencyAnnotation))
    if annotations:
        return annotations[0]
    # fresh tx entry: adopt the annotation the previous transaction's
    # end state stacked on the world state, if any
    try:
        annotation = get_ws_dependency_annotation(
            state).annotations_stack.pop()
    except IndexError:
        annotation = DependencyAnnotation()
    state.annotate(annotation)
    return annotation


def get_ws_dependency_annotation(state: GlobalState
                                 ) -> WSDependencyAnnotation:
    annotations = list(
        state.world_state.get_annotations(WSDependencyAnnotation)
    )
    if annotations:
        return annotations[0]
    annotation = WSDependencyAnnotation()
    state.world_state.annotate(annotation)
    return annotation


class _BlockDeps:
    """Dependency summary of one jump-target block: which storage
    slots any path through it reads, whether any such path writes
    storage, and whether a CALL makes its effects unskippable."""

    __slots__ = ("reads", "writes", "call_tainted")

    def __init__(self):
        # dict-as-ordered-set keyed by term identity: slot TERMS are
        # hash-consed, so identity dedup is exact and insertion order
        # keeps the alias probes deterministic
        self.reads: Dict[object, None] = {}
        self.writes: bool = False
        self.call_tainted: bool = False


def _tid(term) -> object:
    raw = getattr(term, "raw", None)
    return raw.tid if raw is not None else term


class DependencyPruner(LaserPlugin):
    """See module docstring."""

    def __init__(self):
        self._reset()

    def _reset(self):
        self.iteration = 0
        self._deps: Dict[int, _BlockDeps] = {}
        # every slot term read anywhere this run (the reference's
        # storage_accessed_global — membership tests against it keep
        # the set's hash-then-eq semantics, see _must_rerun)
        self._slots_read_anywhere: Set = set()
        # symmetric may-alias verdict memo over term identities
        self._alias_memo: Dict[frozenset, bool] = {}

    # -- dependency index --------------------------------------------------

    def _block(self, address: int) -> _BlockDeps:
        deps = self._deps.get(address)
        if deps is None:
            deps = self._deps[address] = _BlockDeps()
        return deps

    def _record_read(self, path: List[int], slot) -> None:
        for address in path:
            self._block(address).reads.setdefault(slot)

    def _record_write(self, path: List[int]) -> None:
        for address in path:
            self._block(address).writes = True

    def _record_call(self, path: List[int]) -> None:
        # a CALL only pins blocks that also write storage: the
        # reference's calls_on_path is keyed on sstores_on_path entries
        for address in path:
            deps = self._deps.get(address)
            if deps is not None and deps.writes:
                deps.call_tainted = True

    # -- the may-alias oracle ----------------------------------------------

    def _may_alias(self, a, b) -> bool:
        va = getattr(a, "value", None)
        vb = getattr(b, "value", None)
        if va is not None and vb is not None:
            return va == vb  # two literals: no solver
        key = frozenset((_tid(a), _tid(b)))
        verdict = self._alias_memo.get(key)
        if verdict is None:
            try:
                get_model((a == b,))
                verdict = True
            except UnsatError:
                verdict = False
            except Exception:
                verdict = True  # unknown must not prune
            self._alias_memo[key] = verdict
        return verdict

    def _any_alias(self, slots: Iterable, others: Iterable) -> bool:
        others = list(others)
        return any(
            self._may_alias(s, o) for s in slots for o in others
        )

    # -- the skip decision -------------------------------------------------

    @staticmethod
    def _concrete_values(terms):
        """Concrete ints of a term collection, or None when any term
        is symbolic (the static fast path then stands down)."""
        out = set()
        for t in terms:
            v = getattr(t, "value", None)
            if v is None:
                return None
            out.add(v)
        return out

    def _function_entry(self, annotation: DependencyAnnotation,
                        static_info) -> int:
        """The recovered function entry this transaction's path routed
        through, or None. The dispatcher visits the entry within its
        first few jump targets, so the scan is bounded."""
        func_deps = getattr(static_info, "func_deps", None)
        if not func_deps:
            return None
        for addr in annotation.path[:8]:
            if addr in func_deps:
                return addr
        return None

    def _static_no_rerun(self, address: int,
                         annotation: DependencyAnnotation,
                         static_info) -> bool:
        """Static wake-up fast path (analysis/static_pass block
        summaries): when every previous-tx write slot and every slot
        loaded so far this tx is CONCRETE, the block's complete
        concrete reachable-read set is known, no CALL is reachable,
        and the write values are disjoint from both the reachable
        reads and the loaded slots, the pairwise may-alias walk (|W| x
        |R| probes) is provably all-False — the block skips without
        it. Reachable reads over-approximate every slot value any
        execution through this block can load (the value-set analysis'
        soundness contract), so a concrete write outside the set can
        never alias a recorded read.

        PR 8 adds the INTERPROCEDURAL tier first: when the path's
        function entry is recovered, the whole-function aggregate
        (deps.FunctionDeps — reads of every block reachable from the
        entry, a superset of reads reachable from `address`) answers
        the same question without the per-block read table, and the
        block-address conservatism check narrows from the whole-code
        read union to the function's own reads."""
        if static_info is None:
            return False
        writes = self._concrete_values(
            annotation.get_storage_write_cache(self.iteration - 1))
        if writes is None or not writes:
            return False
        loaded = self._concrete_values(annotation.storage_loaded)
        if loaded is None or writes & loaded:
            return False

        hit = False
        try:
            from ....analysis import static_pass

            taint_on = static_pass.taint_enabled()
        except Exception:
            taint_on = False
        if taint_on:
            entry = self._function_entry(annotation, static_info)
            fd = static_info.func_deps.get(entry) \
                if entry is not None else None
            if fd is not None and fd.reads is not None \
                    and not fd.has_effects \
                    and address not in fd.reads \
                    and not (writes & fd.reads):
                hit = True
        if not hit:
            rr = static_info.reach_reads.get(address)
            if rr is None or static_info.reach_calls.get(address, True):
                return False
            # check (3)'s conservatism, statically: the block-address-
            # as-read-slot rule can only fire when `address` is a read
            # slot SOMEWHERE — the complete whole-code read union rules
            # that out without touching term hashes
            all_reads = static_info.all_read_slots
            if all_reads is None or address in all_reads:
                return False
            if writes & rr:
                return False
        try:
            from ....smt.solver.solver_statistics import SolverStatistics

            SolverStatistics().bump(static_pruner_skips=1)
        except Exception:
            pass
        return True

    def _must_rerun(self, address: int,
                    annotation: DependencyAnnotation,
                    static_info=None) -> bool:
        """Does re-executing the (previously seen) block at `address`
        possibly observe the previous transaction's writes?"""
        deps = self._deps.get(address)
        if deps is not None and deps.call_tainted:
            return True
        if deps is None or not deps.reads:
            return False  # no read on any path through it: pure
        if self._static_no_rerun(address, annotation, static_info):
            return False
        prev_writes = annotation.get_storage_write_cache(
            self.iteration - 1)
        # reference conservatism (storage_accessed_global): a block
        # whose own address shows up as a read slot AND whose paths
        # write storage reruns unconditionally. The membership test
        # deliberately keeps the original set semantics (hash first,
        # term __eq__ on collision).
        if deps.writes and address in self._slots_read_anywhere:
            return True
        if self._any_alias(prev_writes, deps.reads):
            return True
        return self._any_alias(prev_writes, annotation.storage_loaded)

    def initialize(self, symbolic_vm) -> None:
        self._reset()

        @symbolic_vm.laser_hook("start_sym_trans")
        def start_sym_trans_hook():
            self.iteration += 1

        def _visit_jump_target(state: GlobalState):
            try:
                address = state.get_current_instruction()["address"]
            except IndexError:
                raise PluginSkipState
            annotation = get_dependency_annotation(state)
            annotation.path.append(address)
            if self.iteration < 2:
                return
            if address not in annotation.blocks_seen:
                annotation.blocks_seen.add(address)
                return
            static_info = None
            try:
                from ....analysis import static_pass

                static_info = static_pass.info_for_code_obj(
                    state.environment.code)
            except Exception:
                pass
            if self._must_rerun(address, annotation, static_info):
                return
            log.debug(
                "Skipping state: previous-tx writes %s cannot reach a "
                "read in block at address %d",
                annotation.get_storage_write_cache(self.iteration - 1),
                address,
            )
            raise PluginSkipState

        for opcode in ("JUMP", "JUMPI"):
            symbolic_vm.post_hook(opcode)(_visit_jump_target)

        @symbolic_vm.pre_hook("SSTORE")
        def sstore_hook(state: GlobalState):
            annotation = get_dependency_annotation(state)
            self._record_write(annotation.path)
            annotation.extend_storage_write_cache(
                self.iteration, state.mstate.stack[-1]
            )

        @symbolic_vm.pre_hook("SLOAD")
        def sload_hook(state: GlobalState):
            annotation = get_dependency_annotation(state)
            slot = state.mstate.stack[-1]
            annotation.storage_loaded.add(slot)
            # backwards-annotate immediately: execution may never reach
            # a clean STOP/RETURN on this path
            self._record_read(annotation.path, slot)
            self._slots_read_anywhere.add(slot)

        def _call_hook(state: GlobalState):
            annotation = get_dependency_annotation(state)
            self._record_call(annotation.path)
            annotation.has_call = True

        for opcode in ("CALL", "STATICCALL"):
            symbolic_vm.pre_hook(opcode)(_call_hook)

        def _transaction_end(state: GlobalState) -> None:
            annotation = get_dependency_annotation(state)
            for slot in annotation.storage_loaded:
                self._record_read(annotation.path, slot)
            if annotation.storage_written:
                self._record_write(annotation.path)
            if annotation.has_call:
                self._record_call(annotation.path)

        for opcode in ("STOP", "RETURN"):
            symbolic_vm.pre_hook(opcode)(_transaction_end)

        @symbolic_vm.laser_hook("add_world_state")
        def world_state_filter_hook(state: GlobalState):
            if isinstance(
                state.current_transaction, ContractCreationTransaction
            ):
                self.iteration = 0
                return
            world_state_annotation = get_ws_dependency_annotation(state)
            annotation = get_dependency_annotation(state)
            # keep storage_written across transactions; reset the rest
            annotation.path = [0]
            annotation.storage_loaded = set()
            world_state_annotation.annotations_stack.append(annotation)


class DependencyPrunerBuilder(PluginBuilder):
    name = "dependency-pruner"

    def __call__(self, *args, **kwargs):
        return DependencyPruner()
