"""Shared default analyzer argument scaffold.

`MythrilAnalyzer` consumes a cmd_args object shaped like the CLI's
argparse namespace (reference mythril/mythril_analyzer.py:41-70);
benches, corpus mode, and tests each need one with a handful of
overrides — one canonical constructor keeps the field list in ONE
place so a new analyzer flag cannot silently drift between harnesses.
"""

from types import SimpleNamespace


def make_cmd_args(**overrides) -> SimpleNamespace:
    base = dict(
        execution_timeout=60,
        max_depth=128,
        solver_timeout=10000,
        no_onchain_data=True,
        loop_bound=3,
        create_timeout=10,
        pruning_factor=None,
        unconstrained_storage=False,
        parallel_solving=False,
        call_depth_limit=3,
        disable_dependency_pruning=False,
        custom_modules_directory="",
        solver_log=None,
        transaction_sequences=None,
        tpu_lanes=0,
        tpu_mesh=-1,
        checkpoint=None,
        resume=None,
        migration_bus=None,
        no_warm_store=False,
    )
    unknown = set(overrides) - set(base)
    if unknown:
        raise TypeError(f"unknown analyzer args: {sorted(unknown)}")
    base.update(overrides)
    return SimpleNamespace(**base)
