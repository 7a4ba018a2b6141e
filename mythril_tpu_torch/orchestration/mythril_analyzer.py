"""Analysis orchestration (capability parity:
mythril/mythril/mythril_analyzer.py:29-193 — copies CLI args into the
global Args flags, runs SymExecWrapper + fire_lasers per contract with
per-contract exception capture and KeyboardInterrupt partial results,
statespace dump and graph HTML exports)."""

import logging
import traceback
from typing import List, Optional

from ..analysis.callgraph import generate_graph
from ..analysis.report import Issue, Report
from ..analysis.security import fire_lasers
from ..analysis.symbolic import SymExecWrapper
from ..analysis.traceexplore import get_serializable_statespace
from ..smt.solver import SolverStatistics
from ..support.loader import DynLoader
from ..support.source_support import Source
from ..support.support_args import args

log = logging.getLogger(__name__)


def reset_analysis_state() -> None:
    """Reset per-analysis global state (solver session, keccak axioms,
    execution deadline) between independent contract analyses. The
    deadline clear matters beyond hygiene: the previous analysis's
    window otherwise leaks into any solver call made before the next
    engine run re-arms it — once the wall passes the stale deadline,
    get_model raises UnsatError unconditionally."""
    from ..laser.function_managers import keccak_function_manager
    from ..laser.time_handler import time_handler
    from ..smt.solver.core import reset_session

    reset_session()
    keccak_function_manager.reset()
    time_handler.clear()


def _resume_checkpoint_path(resume_dir: str) -> str:
    """The checkpoint file `--resume DIR` binds to: the newest
    flight-recorder live dump (flightrec/resume_rank<r>.ckpt — what a
    SIGTERM'd or crashed rank leaves behind) when one exists, else
    DIR/resume.ckpt (also the path future round snapshots land on, so
    an interrupted resumed run stays resumable)."""
    import glob
    import os

    candidates = sorted(
        glob.glob(os.path.join(str(resume_dir), "flightrec",
                               "resume_rank*.ckpt")),
        key=lambda p: os.path.getmtime(p), reverse=True)
    if candidates:
        return candidates[0]
    return os.path.join(str(resume_dir), "resume.ckpt")


class MythrilAnalyzer:
    def __init__(
        self,
        disassembler,
        cmd_args,
        strategy: str = "bfs",
        address: Optional[str] = None,
    ):
        from ..support.start_time import StartTime

        StartTime()  # anchor issue discovery_time to analysis start
        self.eth = disassembler.eth
        self.contracts = disassembler.contracts or []
        self.enable_online_lookup = disassembler.enable_online_lookup
        self.use_onchain_data = not getattr(cmd_args, "no_onchain_data", True)
        self.strategy = strategy
        self.address = address
        self.max_depth = getattr(cmd_args, "max_depth", 128)
        self.execution_timeout = getattr(cmd_args, "execution_timeout", 86400)
        self.loop_bound = getattr(cmd_args, "loop_bound", 3)
        self.create_timeout = getattr(cmd_args, "create_timeout", 10)
        self.disable_dependency_pruning = getattr(
            cmd_args, "disable_dependency_pruning", False
        )
        self.custom_modules_directory = getattr(
            cmd_args, "custom_modules_directory", ""
        )
        # mirror analysis-relevant flags into the process-global Args
        # (reference mythril_analyzer.py:62-70)
        args.pruning_factor = getattr(cmd_args, "pruning_factor", None)
        args.solver_timeout = getattr(cmd_args, "solver_timeout", 10000)
        args.parallel_solving = getattr(cmd_args, "parallel_solving", False)
        args.unconstrained_storage = getattr(
            cmd_args, "unconstrained_storage", False
        )
        args.call_depth_limit = getattr(cmd_args, "call_depth_limit", 3)
        args.disable_dependency_pruning = self.disable_dependency_pruning
        args.solver_log = getattr(cmd_args, "solver_log", None)
        args.transaction_sequences = getattr(
            cmd_args, "transaction_sequences", None
        )
        args.tpu_lanes = getattr(cmd_args, "tpu_lanes", args.tpu_lanes)
        args.tpu_mesh = getattr(cmd_args, "tpu_mesh", args.tpu_mesh)
        args.checkpoint_file = getattr(cmd_args, "checkpoint", None)
        # --resume DIR (docs/checkpoint.md): continue from the live
        # checkpoint a crashed/preempted run left under DIR — the
        # flight recorder's SIGTERM/fatal resume_rank*.ckpt when
        # present, else DIR/resume.ckpt — and keep checkpointing
        # there. An explicit --checkpoint FILE wins.
        resume_dir = getattr(cmd_args, "resume", None)
        if resume_dir and not args.checkpoint_file:
            args.checkpoint_file = _resume_checkpoint_path(resume_dir)
            from ..support import telemetry

            # re-arm the flight recorder against the same dir so a
            # second preemption refreshes the same artifact set
            telemetry.configure(out_dir=resume_dir)
        args.migration_bus = getattr(cmd_args, "migration_bus", None)
        # --no-warm-store (docs/warm_store.md): stand the cross-run
        # warm store down for this process, bit-for-bit like
        # MTPU_WARM=0
        args.no_warm_store = getattr(cmd_args, "no_warm_store",
                                     args.no_warm_store)
        # run-wide observability (docs/observability.md): --trace-out
        # arms span tracing and the at-exit Chrome trace export
        args.trace_out = getattr(cmd_args, "trace_out", None)
        if args.trace_out:
            from ..support import telemetry

            telemetry.configure(trace_out=args.trace_out, enable=True)
        from ..support.devices import effective_tpu_lanes

        effective_tpu_lanes()  # resolve the auto sentinel for this run
        if args.pruning_factor is None:
            args.pruning_factor = 1 if self.execution_timeout > 600 else 0
        # per-run context (SURVEY §5): this analyzer's keccak axioms,
        # model caches, solver session, detector issue lists, and Args
        # values live in its own context — two analyzers in one process
        # stay independent with no manual cache clearing
        from ..support.run_context import RunContext

        self._run_context = RunContext()
        self._run_context.snapshot_args()

    def _sym_exec(self, contract, modules, transaction_count):
        self._run_context.activate()
        return SymExecWrapper(
            contract,
            self.address,
            self.strategy,
            dynloader=DynLoader(self.eth, active=self.use_onchain_data),
            max_depth=self.max_depth,
            execution_timeout=self.execution_timeout,
            loop_bound=self.loop_bound,
            create_timeout=self.create_timeout,
            transaction_count=transaction_count,
            modules=modules or [],
            compulsory_statespace=False,
            disable_dependency_pruning=self.disable_dependency_pruning,
            custom_modules_directory=self.custom_modules_directory,
        )

    def dump_statespace(self, contract=None) -> str:
        sym = self._sym_exec_statespace(contract or self.contracts[0])
        return get_serializable_statespace(sym)

    def _sym_exec_statespace(self, contract):
        self._run_context.activate()
        return SymExecWrapper(
            contract,
            self.address,
            self.strategy,
            dynloader=DynLoader(self.eth, active=self.use_onchain_data),
            max_depth=self.max_depth,
            execution_timeout=self.execution_timeout,
            create_timeout=self.create_timeout,
            compulsory_statespace=True,
            run_analysis_modules=False,
        )

    def graph_html(self, contract=None, enable_physics: bool = False,
                   phrackify: bool = False, transaction_count: int = 2) -> str:
        sym = self._sym_exec_statespace(contract or self.contracts[0])
        return generate_graph(sym, physics=enable_physics,
                              phrackify=phrackify)

    def fire_lasers(self, modules: Optional[List[str]] = None,
                    transaction_count: int = 2) -> Report:
        """Analyze every loaded contract; issues and per-contract crashes
        both land in the report."""
        self._run_context.activate()
        all_issues: List[Issue] = []
        exceptions = []
        execution_info = None
        from ..support import warm_store

        for contract in self.contracts:
            try:
                # fresh solver session + keccak axioms per contract:
                # another contract's clauses and hash conditions only
                # slow this one down (the reference runs one contract
                # per process, so its global singletons never face a
                # sweep). Done here — not in SymExecWrapper — so wrapper
                # construction stays side-effect-free for live
                # statespaces (e.g. graph_html after fire_lasers).
                reset_analysis_state()
                sym = self._sym_exec(contract, modules, transaction_count)
                issues = fire_lasers(sym, modules)
                execution_info = sym.execution_info
                for issue in issues:
                    # source-map against the contract that produced the
                    # issue (reference mythril_analyzer.py:168)
                    issue.add_code_info(contract)
                all_issues += issues
            except KeyboardInterrupt:
                log.critical("keyboard interrupt: flushing partial results")
                break
            except Exception:
                log.exception(
                    "exception during %s analysis", contract.name
                )
                exceptions.append(traceback.format_exc())
            finally:
                # warm-store final save: the detector-phase proofs
                # (fired during execution) are settled by now, so the
                # entry under this code's hash is complete
                # (support/warm_store.py; no-op when inactive)
                try:
                    warm_store.end_analysis()
                except Exception as e:
                    log.debug("warm-store save failed: %s", e)
        stats = SolverStatistics()
        if getattr(stats, "enabled", False):
            log.info("solver statistics: %s", stats)

        source_data = Source()
        source_data.get_source_from_contracts_list(self.contracts)
        report = Report(
            contracts=self.contracts,
            exceptions=exceptions,
            execution_info=execution_info,
        )
        for issue in all_issues:
            report.append_issue(issue)
        return report
