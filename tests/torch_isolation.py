"""Keep a test that runs an analysis from leaking process-wide state
into the tests a worker runs after it."""

from contextlib import contextmanager


@contextmanager
def isolated_analysis():
    """Restore both packages' analysis flags (``support_args.args``,
    which every analyzer writes from its arguments: a lane width left
    behind would send a later test's states through the lane engine)
    and clear the port's execution deadline (its own ``time_handler``,
    which the suite's autouse fixture for the JAX package does not
    reach: once a finite timeout passes, every later solver call in the
    worker fails)."""
    from mythril_tpu.support.support_args import args as j_args
    from mythril_tpu_torch.laser.time_handler import time_handler
    from mythril_tpu_torch.support.support_args import args as p_args

    saved = [(a, dict(vars(a))) for a in (j_args, p_args)]
    try:
        yield
    finally:
        for a, d in saved:
            vars(a).clear()
            vars(a).update(d)
        time_handler.clear()
