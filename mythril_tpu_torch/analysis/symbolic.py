"""SymExecWrapper: facade wiring the engine, strategies, plugins and
detectors together (capability parity: mythril/analysis/symbolic.py:40-290).
"""

import copy
import logging
from typing import List, Optional, Type, Union

from ..laser import svm
from ..laser.natives import PRECOMPILE_COUNT
from ..laser.plugin.loader import LaserPluginLoader
from ..laser.plugin.plugins import (
    CallDepthLimitBuilder,
    CoveragePluginBuilder,
    DependencyPrunerBuilder,
    InstructionProfilerBuilder,
    MutationPrunerBuilder,
)
from ..laser.state.account import Account
from ..laser.state.world_state import WorldState
from ..laser.strategy import BasicSearchStrategy
from ..laser.strategy.basic import (
    BreadthFirstSearchStrategy,
    DepthFirstSearchStrategy,
    ReturnRandomNaivelyStrategy,
    ReturnWeightedRandomStrategy,
)
from ..laser.strategy.beam import BeamSearch
from ..laser.strategy.constraint_strategy import DelayConstraintStrategy
from ..laser.strategy.extensions.bounded_loops import BoundedLoopsStrategy
from ..laser.transaction.symbolic import ACTORS
from ..smt import BitVec, symbol_factory
from ..support.support_args import args
from .module import (
    EntryPoint,
    ModuleLoader,
    get_detection_module_hooks,
)
from .ops import Call, VarType, get_variable

log = logging.getLogger(__name__)


def _device_exec_ok() -> bool:
    """The lane engine imports and its device executes
    (support.devices.device_exec_ok — one executed-op probe per
    device). A missing or broken card raises: the analysis never
    falls back to the host because the device was not found."""
    from ..laser.lane_engine import LaneEngine  # noqa: F401
    from ..support.devices import device_exec_ok

    return device_exec_ok()


class SymExecWrapper:
    """Symbolically executes the code and pre-parses the statespace."""

    def __init__(
        self,
        contract,
        address: Union[int, str, BitVec],
        strategy: str,
        dynloader=None,
        max_depth: int = 22,
        execution_timeout: Optional[int] = None,
        loop_bound: int = 3,
        create_timeout: Optional[int] = None,
        transaction_count: int = 2,
        modules: Optional[List[str]] = None,
        compulsory_statespace: bool = True,
        disable_dependency_pruning: bool = False,
        run_analysis_modules: bool = True,
        custom_modules_directory: str = "",
    ):
        if isinstance(address, str):
            address = symbol_factory.BitVecVal(int(address, 16), 256)
        if isinstance(address, int):
            address = symbol_factory.BitVecVal(address, 256)

        beam_width = None
        if strategy == "dfs":
            s_strategy: Type[BasicSearchStrategy] = (
                DepthFirstSearchStrategy
            )
        elif strategy == "bfs":
            s_strategy = BreadthFirstSearchStrategy
        elif strategy == "naive-random":
            s_strategy = ReturnRandomNaivelyStrategy
        elif strategy == "weighted-random":
            s_strategy = ReturnWeightedRandomStrategy
        elif "beam-search: " in strategy:
            beam_width = int(strategy.split("beam-search: ")[1])
            s_strategy = BeamSearch
        elif "delayed" in strategy:
            s_strategy = DelayConstraintStrategy
        else:
            raise ValueError("Invalid strategy argument supplied")

        creator_account = Account(
            hex(ACTORS.creator.value), "", dynamic_loader=None,
            contract_name=None,
        )
        attacker_account = Account(
            hex(ACTORS.attacker.value), "", dynamic_loader=None,
            contract_name=None,
        )

        requires_statespace = (
            compulsory_statespace
            or len(
                ModuleLoader().get_detection_modules(
                    EntryPoint.POST, modules
                )
            )
            > 0
        )
        if not contract.creation_code:
            self.accounts = {
                hex(ACTORS.attacker.value): attacker_account
            }
        else:
            self.accounts = {
                hex(ACTORS.creator.value): creator_account,
                hex(ACTORS.attacker.value): attacker_account,
            }

        self.laser = svm.LaserEVM(
            dynamic_loader=dynloader,
            max_depth=max_depth,
            execution_timeout=execution_timeout,
            strategy=s_strategy,
            create_timeout=create_timeout,
            transaction_count=transaction_count,
            requires_statespace=requires_statespace,
            beam_width=beam_width,
        )

        if loop_bound is not None:
            self.laser.extend_strategy(
                BoundedLoopsStrategy,
                loop_bound=loop_bound,
                beam_width=beam_width,
            )

        plugin_loader = LaserPluginLoader()
        plugin_loader.load(CoveragePluginBuilder())
        plugin_loader.load(MutationPrunerBuilder())
        plugin_loader.load(CallDepthLimitBuilder())
        plugin_loader.load(InstructionProfilerBuilder())
        plugin_loader.add_args(
            "call-depth-limit", call_depth_limit=args.call_depth_limit
        )
        # the dependency pruner's per-basic-block maps are built from
        # SLOAD/SSTORE/JUMP hooks the lane engine would bypass; it is a
        # prune-only optimization, so it is dropped when the lane engine
        # will actually run — and kept when a selected module pins JUMPI
        # to the host (no lane adapter), which idles the sweep
        # (svm._lane_engine_sweep) and pruning is all the help we get
        from ..support.devices import effective_tpu_lanes

        lane_engine_active = bool(effective_tpu_lanes()) \
            and not args.use_issue_annotations
        if lane_engine_active and run_analysis_modules:
            # mirror of svm._lane_engine_sweep's hook gate: a module
            # hooking JUMPI idles the sweep (every branch parks) UNLESS
            # its lane adapter serves that hook at drain time
            from .module.lane_adapters import get_adapter

            cb_modules = ModuleLoader().get_detection_modules(
                EntryPoint.CALLBACK, modules
            )
            for m in cb_modules:
                hooks = set(m.pre_hooks or []) | set(m.post_hooks or [])
                if "JUMPI" not in hooks:
                    continue
                ad = get_adapter(m)
                if ad is None or "JUMPI" not in ad.lifted_hooks:
                    lane_engine_active = False
                    break
        if lane_engine_active and not _device_exec_ok():
            lane_engine_active = False
        if lane_engine_active:
            # mirror of the sweep's link-aware engagement gate
            # (lane_engine.device_break_even): on a tunneled backend a
            # contract not known to fork wide will have its small
            # waves declined anyway — dropping the dependency pruner
            # for such a run would be the worst of both (no device, no
            # pruning). Keep the pruner; its JUMPI hook idles the
            # sweep, which is exactly the routing the gate would pick.
            try:
                from ..laser.lane_engine import (
                    code_to_bytes,
                    device_break_even,
                )

                code_bytes = code_to_bytes(contract.disassembly)
                if (
                    code_bytes is not None
                    and device_break_even(code_bytes) > 1
                ):
                    # PATH_HISTORY for this code also fills from HOST
                    # exploration (svm records the worklist peak), so
                    # an in-process re-analysis of a wide-forking
                    # contract flips this decision — no bootstrap
                    # deadlock with the pruner
                    lane_engine_active = False
            except Exception:
                pass  # unknown code shape: keep lane routing as-is
        if not disable_dependency_pruning and not lane_engine_active:
            plugin_loader.load(DependencyPrunerBuilder())
        elif lane_engine_active:
            # the loader is a process-wide singleton: a pruner loaded by
            # an earlier host-path analysis in this process would hook
            # JUMPI and idle the lane sweep — unload it for this run
            plugin_loader.laser_plugin_builders.pop(
                DependencyPrunerBuilder.name, None)
        plugin_loader.instrument_virtual_machine(self.laser, None)

        world_state = WorldState()
        for account in self.accounts.values():
            world_state.put_account(account)

        if run_analysis_modules:
            analysis_modules = ModuleLoader().get_detection_modules(
                EntryPoint.CALLBACK, modules
            )
            self.laser.register_hooks(
                hook_type="pre",
                hook_dict=get_detection_module_hooks(
                    analysis_modules, hook_type="pre"
                ),
            )
            self.laser.register_hooks(
                hook_type="post",
                hook_dict=get_detection_module_hooks(
                    analysis_modules, hook_type="post"
                ),
            )

        # cross-run warm store (support/warm_store.py): adopt a prior
        # run's banks for this code hash ONCE, before execution —
        # verdicts/facts/bounds replay like a migration sidecar, the
        # static memo fills cold slots, the cost model seeds
        # pick_width, and the learned routing table arms. Inert
        # unless a store directory is configured (MTPU_WARM_DIR or a
        # corpus/bench --out-dir) and MTPU_WARM=1 (default).
        try:
            from ..support import warm_store

            warm_store.begin_analysis(contract)
        except Exception as e:  # best-effort, never the analysis
            log.debug("warm-store load failed: %s", e)

        # transaction-boundary checkpointing (support/checkpoint.py):
        # install the per-round sink, arm the SIGTERM/fatal live dump,
        # and divert to resume_exec when a loadable snapshot exists
        resumed = False
        if args.checkpoint_file:
            from ..support.checkpoint import (
                arm_live_dump, code_identity, load_checkpoint,
                save_checkpoint,
            )

            path = args.checkpoint_file
            # bind snapshots to the analyzed code: multi-contract runs
            # sharing one checkpoint file must not resume each other
            code_id = code_identity(contract)

            def _save_ckpt_verdicts(open_states):
                # verdict-bank sidecar beside the snapshot: a resumed
                # run replays the proofs this run already settled, so
                # its screens start warm instead of re-proving
                # (docs/checkpoint.md; same format migration batches
                # ship — best-effort, never blocks the snapshot)
                try:
                    from ..parallel.migrate import MigrationBus
                    from ..smt.solver import verdicts as verdict_mod
                    from ..support.checkpoint import (
                        save_verdict_sidecar,
                    )

                    vc = verdict_mod.cache()
                    if vc is None:
                        return
                    entries = MigrationBus._entries_for(
                        list(open_states), vc)
                    if entries:
                        save_verdict_sidecar(str(path) + ".verdicts",
                                             entries)
                except Exception as e:
                    log.debug("checkpoint verdict sidecar failed: %s",
                              e)

            def _sink(next_round, open_states, addr):
                save_checkpoint(
                    path, next_round, open_states,
                    addr.value if isinstance(addr, BitVec) else addr,
                    code_id)
                _save_ckpt_verdicts(open_states)

            self.laser.checkpoint_sink = _sink
            # a rank dying with this analysis mid-round leaves a LIVE
            # checkpoint (open states + the in-flight plane) in
            # flightrec/ and refreshes `path` — the contract re-enters
            # the queue as resumable work (docs/checkpoint.md)
            arm_live_dump(self.laser, path, code_id)
            payload = load_checkpoint(path, code_id)
            if payload is not None:
                # warm the verdict/fact banks from the sidecar the
                # sink (or live dump) wrote beside the snapshot
                try:
                    from ..smt.solver import verdicts as verdict_mod
                    from ..support.checkpoint import (
                        load_verdict_sidecar,
                    )

                    vc = verdict_mod.cache()
                    entries = load_verdict_sidecar(
                        str(path) + ".verdicts") if vc is not None else []
                    if entries:
                        replayed = vc.import_entries(entries)
                        log.info("checkpoint resume: replayed %d "
                                 "banked verdicts", replayed)
                except Exception as e:
                    log.debug("checkpoint verdict replay failed: %s",
                              e)
                self.laser.resume_exec(
                    payload["open_states"],
                    payload["target_address"],
                    payload["round"],
                    inflight=payload.get("inflight"),
                )
                resumed = True

        if resumed:
            pass  # analysis continues on the restored states
        elif contract.creation_code and create_timeout != 0:
            self.laser.sym_exec(
                creation_code=contract.creation_code,
                contract_name=contract.name,
                world_state=world_state,
            )
        else:
            account = Account(
                address,
                contract.disassembly,
                dynamic_loader=dynloader,
                contract_name=contract.name,
                balances=world_state.balances,
                concrete_storage=bool(
                    dynloader is not None and dynloader.active
                ),
            )
            if dynloader is not None:
                try:
                    addr_hex = (
                        "{0:#0{1}x}".format(address.value, 42)
                        if isinstance(address, BitVec)
                        else "{0:#0{1}x}".format(address, 42)
                    )
                    account.set_balance(
                        dynloader.read_balance(addr_hex)
                    )
                except Exception:
                    pass  # balance stays symbolic
            world_state.put_account(account)
            self.laser.sym_exec(
                world_state=world_state, target_address=address.value
            )

        self.execution_info = self.laser.execution_info

        if not requires_statespace:
            return

        self.nodes = self.laser.nodes
        self.edges = self.laser.edges

        # Parse CALL-family ops into an easily accessible list for POST
        # modules
        self.calls: List[Call] = []
        for key in self.nodes:
            state_index = 0
            for state in self.nodes[key].states:
                instruction = state.get_current_instruction()
                op = instruction["opcode"]
                if op in (
                    "CALL", "CALLCODE", "DELEGATECALL", "STATICCALL",
                ):
                    stack = state.mstate.stack
                    if op in ("CALL", "CALLCODE"):
                        gas, to, value, meminstart, meminsz = (
                            get_variable(stack[-1]),
                            get_variable(stack[-2]),
                            get_variable(stack[-3]),
                            get_variable(stack[-4]),
                            get_variable(stack[-5]),
                        )
                        if (
                            to.type == VarType.CONCRETE
                            and 0 < to.val <= PRECOMPILE_COUNT
                        ):
                            continue
                        if (
                            meminstart.type == VarType.CONCRETE
                            and meminsz.type == VarType.CONCRETE
                        ):
                            self.calls.append(
                                Call(
                                    self.nodes[key],
                                    state,
                                    state_index,
                                    op,
                                    to,
                                    gas,
                                    value,
                                    state.mstate.memory[
                                        meminstart.val : meminsz.val
                                        + meminstart.val
                                    ],
                                )
                            )
                        else:
                            self.calls.append(
                                Call(
                                    self.nodes[key],
                                    state,
                                    state_index,
                                    op,
                                    to,
                                    gas,
                                    value,
                                )
                            )
                    else:
                        gas, to = (
                            get_variable(stack[-1]),
                            get_variable(stack[-2]),
                        )
                        if (
                            to.type == VarType.CONCRETE
                            and 0 < to.val <= PRECOMPILE_COUNT
                        ):
                            continue
                        self.calls.append(
                            Call(
                                self.nodes[key],
                                state,
                                state_index,
                                op,
                                to,
                                gas,
                            )
                        )
                state_index += 1
