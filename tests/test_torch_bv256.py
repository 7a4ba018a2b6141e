"""The port's bv256 ops (mythril_tpu_torch/ops/bv256.py, plain PyTorch on
the CPU) against the JAX package's, bit for bit, on tests/test_bv256.py's
edge values and seeded random words."""

import numpy as np
import pytest
import torch

from mythril_tpu.ops import bv256 as J
from mythril_tpu_torch.ops import bv256 as T

from .test_bv256 import EDGE

_JAX = {
    "add": J.add, "sub": J.sub, "neg": J.neg, "mul": J.mul,
    "mul_hi": lambda a, b: J.mul_full(a, b)[1], "div": J.div,
    "mod": J.mod, "sdiv": J.sdiv, "smod": J.smod, "addmod": J.addmod,
    "mulmod": J.mulmod, "exp": J.exp, "shl": J.shl, "shr": J.shr,
    "sar": J.sar, "byte": J.byte_op, "signextend": J.signextend,
    "lt": lambda a, b: J.bool_to_word(J.ult(a, b)),
    "gt": lambda a, b: J.bool_to_word(J.ugt(a, b)),
    "slt": lambda a, b: J.bool_to_word(J.slt(a, b)),
    "sgt": lambda a, b: J.bool_to_word(J.sgt(a, b)),
    "eq": lambda a, b: J.bool_to_word(J.eq(a, b)),
    "iszero": lambda a: J.bool_to_word(J.is_zero(a)),
    "and": lambda a, b: a & b, "or": lambda a, b: a | b,
    "xor": lambda a, b: a ^ b, "not": lambda a: ~a,
}


def _operands():
    """Three (N, 8) uint32 batches: every pair of edge values (and small
    shift/byte amounts) plus seeded random words of mixed widths."""
    rng = np.random.default_rng(1234)
    extra = [31, 32, 30, 8, 248, 255, 257]
    edge = list(EDGE) + extra
    a = [x for x in edge for _ in edge]
    b = [y for _ in edge for y in edge]
    for _ in range(64):
        bits = int(rng.choice([8, 32, 64, 128, 256]))
        a.append(int.from_bytes(rng.bytes(32), "big") >> (256 - bits))
        b.append(int.from_bytes(rng.bytes(32), "big") >> (256 - bits))
    c = [edge[i % len(edge)] if i % 3 else
         int.from_bytes(rng.bytes(32), "big") for i in range(len(a))]
    return [np.stack([J.int_to_limbs(v) for v in xs]) for xs in (a, b, c)]


A, B, C = _operands()


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain versions run on tiny tensors: one intra-op thread is
    faster there and leaves the other test workers their cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_op_table_matches_the_jax_ops():
    assert set(T.OPS) == set(_JAX)


@pytest.mark.parametrize("op", list(T.OPS))
def test_op_equals_jax(op):
    arity = T.OPS[op][0]
    args = (A, B, C)[:arity]
    want = np.asarray(_JAX[op](*args)).astype(np.uint32)
    got = T.bv256_apply(op, *[torch.from_numpy(x.view(np.int32))
                              for x in args])
    assert got.dtype == torch.int32 and got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)


def test_limb_conversions_round_trip():
    for v in EDGE:
        assert T.limbs_to_int(T.int_to_limbs(v)) == v
        np.testing.assert_array_equal(T.int_to_limbs(v), J.int_to_limbs(v))
