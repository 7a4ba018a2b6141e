"""The port's screen waves (mythril_tpu_torch/support/screen_waves.py)
against the constructions they copy: bench.py's bench_prefilter wave
(with a fresh keccak manager) and the sets of bench.py's
_smoke_propagate, built with the JAX package's facade and terms. Both
linearize to the same encoding once rows are keyed by a term key that
does not depend on term ids (``canon``); only the JAX
``linearize`` runs, no JAX kernel."""

import pytest
import torch

from mythril_tpu.laser.function_managers.keccak_function_manager import (
    KeccakFunctionManager,
)
from mythril_tpu.ops import intervals as JI
from mythril_tpu.smt import UGE, ULE, symbol_factory
from mythril_tpu.smt import terms as JT
from mythril_tpu_torch.ops import intervals as I
from mythril_tpu_torch.ops import propagate as P
from mythril_tpu_torch.support import screen_waves as W

from .test_torch_intervals import describe
from .torch_screen_common import canon


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def bench_prefilter_systems(n):
    """bench.py:421-470, the systems of bench_prefilter, with a keccak
    manager of its own."""
    km = KeccakFunctionManager()
    x = symbol_factory.BitVecSym("pf_x", 256)
    y = symbol_factory.BitVecSym("pf_y", 256)
    h = km.create_keccak(symbol_factory.BitVecSym("pf_d", 512))
    axioms = [km.create_conditions()]
    pool = []
    for j in range(256):
        pool.append(UGE(x, symbol_factory.BitVecVal(j, 256)))
        pool.append(ULE(y, symbol_factory.BitVecVal(1 << (j % 200 + 8),
                                                    256)))
    probes = [h == symbol_factory.BitVecVal(324345425435 + j, 256)
              for j in range(64)]
    contras = [(UGE(x, symbol_factory.BitVecVal(5000 + j, 256)),
                ULE(x, symbol_factory.BitVecVal(10 + j, 256)))
               for j in range(64)]
    systems = []
    for i in range(n):
        prefix = [pool[(i * 7 + k) % len(pool)] for k in range(24)]
        kind = i % 3
        if kind == 0:
            c = prefix
        elif kind == 1:
            c = prefix + list(contras[i % len(contras)])
        else:
            c = prefix + axioms + [probes[i % len(probes)]]
        systems.append([t.raw for t in c])
    return systems


def smoke_propagate_sets():
    """bench.py:1048-1075, the sets of _smoke_propagate, as terms."""
    bv = lambda v, w=256: JT.bv_const(v, w)  # noqa: E731
    x = JT.bv_var("prop_smoke_x", 256)
    y = JT.bv_var("prop_smoke_y", 256)
    a, b = JT.bool_var("prop_smoke_a"), JT.bool_var("prop_smoke_b")
    sets = []
    for j in range(4):
        sets.append([
            JT.mk_eq(JT.mk_and(x, bv(0xFF << (8 * j))), bv(0x42 << (8 * j))),
            JT.mk_eq(JT.mk_and(x, bv(0xFF << (8 * j))), bv(0x43 << (8 * j))),
        ])
    sets.append([JT.mk_not(JT.mk_bool_or(a, b)), a])
    for j in range(4):
        sets.append([
            JT.mk_eq(JT.mk_and(x, bv(0xFF)), bv(0x40 | j)),
            JT.mk_ule(x, bv(1 << 20)), JT.mk_ule(y, x),
        ])
    return sets


def test_prefilter_wave_encodes_as_bench_prefilter():
    systems, keep = W.prefilter_wave(48)
    assert describe(I.linearize(systems)) == describe(
        JI.linearize(bench_prefilter_systems(48)))
    assert sum(keep) == 16 and keep == [i % 3 == 0 for i in range(48)]


def test_prefilter_wave_keeps_one_third():
    """The screens keep exactly the i % 3 == 0 systems (bench.py:498
    asserts the same count at 8192), with propagation on and off."""
    systems, keep = W.prefilter_wave(48)
    assert list(P.screen(systems, device="cpu").keep) == keep
    assert list(I.prefilter_feasible(systems, device="cpu")) == keep


def test_propagation_mix_starts_with_the_smoke_sets():
    got, keep = W.propagation_mix(W.MIX_PERIOD)
    want = smoke_propagate_sets()
    assert [[canon(t) for t in s] for s in got] == \
        [[canon(t) for t in s] for s in want]
    assert describe(I.linearize(got)) == describe(JI.linearize(want))
    assert keep == [False] * 5 + [True] * 4


def test_propagation_mix_varies_per_set():
    sets, keep = W.propagation_mix(8 * W.MIX_PERIOD)
    assert len({tuple(map(canon, s)) for s in sets}) == len(sets)
    assert len(keep) == len(sets) and sum(keep) == 4 * 8
