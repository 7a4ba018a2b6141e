"""Process-global analysis flag singleton (reference parity:
mythril/support/support_args.py:5-26). Written once by MythrilAnalyzer,
read across the engine."""

from typing import List, Optional

from .support_utils import Singleton


class Args(object, metaclass=Singleton):
    """Cross-module analysis flags."""

    def __init__(self):
        self.solver_log: Optional[str] = None
        self.transaction_sequences: Optional[List[List]] = None
        self.use_integer_module = True
        self.use_issue_annotations = False
        self.solver_timeout = 10000
        self.parallel_solving = False
        self.unconstrained_storage = False
        self.call_depth_limit = 3
        self.iprof = None
        self.solc_args = None
        self.disable_dependency_pruning = False
        self.disable_coverage_strategy = False
        self.disable_mutation_pruner = False
        self.incremental_txs = True
        self.epic = False
        # get_model memo entries (support/model.py; MYTHRIL_TPU_MODEL_LRU
        # env overrides, 0 disables). The seed's 2**23 was an OOM risk
        # on corpus runs — every entry pins a Model and its eval memos.
        self.model_lru_size = 2 ** 14
        self.pruning_factor: Optional[float] = None
        # persistent solver pool width (smt/solver/pool.py): None =
        # auto (MTPU_SOLVER_WORKERS env, else min(4, cpu)); 1 = serial
        # fallback (today's single-context behavior, bit-for-bit);
        # >1 = that many long-lived solver worker threads
        self.solver_workers: Optional[int] = None
        # TPU lane-engine knobs (new in this build)
        # -1 = auto (batched lanes on a local accelerator, host-only
        # otherwise — support/devices.default_tpu_lanes); 0 = host-only
        # engine; >0 = batched lane engine with that width
        self.tpu_lanes = -1
        # -1 = auto (shard the lane planes over all local devices when
        # more than one exists and the width divides evenly); 0 = single
        # device; >0 = shard over that many devices (parallel/mesh.py)
        self.tpu_mesh = -1
        self.tpu_prefilter = True
        # transaction-boundary checkpoint/resume (support/checkpoint.py)
        self.checkpoint_file = None
        # corpus-mode path-batch migration bus (parallel/migrate.py)
        self.migration_bus = None
        # --trace-out: Chrome trace-event JSON export path for the
        # run-wide span tracer (support/telemetry/,
        # docs/observability.md); None = no export
        self.trace_out = None
        # --no-warm-store: force the cross-run warm store off for
        # this process (support/warm_store.py, docs/warm_store.md) —
        # same effect as MTPU_WARM=0, bit-for-bit cold behavior
        self.no_warm_store = False


args = Args()
