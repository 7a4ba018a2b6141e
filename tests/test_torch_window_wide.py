"""The port's window dispatch against the JAX package's at 1024 lanes,
where one window forks more than FB times and the whole fork table is
pulled (``_gather_full_flog``)."""

from mythril_tpu_torch.laser import lane_engine as TL
from mythril_tpu_torch.support import contracts

from .test_torch_window import _one_torch_thread, drive, seed  # noqa: F401


def test_more_forks_than_the_fork_pull_budget():
    code, _ = contracts.build_symbolic_contract(10)
    objs = TL.ObjectTable()
    seen = drive(code, [seed(objs, 1)], n=1024, window=160)
    assert seen["full_flog"] >= 1
    assert seen["forks"] > TL.FB
