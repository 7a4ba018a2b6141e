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


# ---------------------------------------------------------------------------
# the division edges: the plain version against JAX, and algorithm D as
# csrc/bv256.cuh runs it, replayed on 32-bit digits in Python integers
# ---------------------------------------------------------------------------

EA, EB, EC = (np.stack([J.int_to_limbs(v) for v in col])
              for col in zip(*T.DIV_EDGES))
M32 = (1 << 32) - 1
M256 = (1 << 256) - 1


@pytest.mark.parametrize("op", list(T.OPS))
def test_div_edges_equal_jax(op):
    arity = T.OPS[op][0]
    args = (EA, EB, EC)[:arity]
    want = np.asarray(_JAX[op](*args)).astype(np.uint32)
    got = T.bv256_apply(op, *[torch.from_numpy(x.view(np.int32))
                              for x in args])
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)


def test_div_edge_planes_hold_the_edges():
    planes = T.div_edge_planes()
    for plane, col in zip(planes, (EA, EB, EC)):
        assert plane.dtype == torch.int32 and plane.shape == col.shape
        np.testing.assert_array_equal(plane.numpy().view(np.uint32), col)


def _reciprocal(d):
    """bv::reciprocal: 2**64 / d in double (__drcp_rn rounds as Python's
    1.0 / d does), truncated, then one remainder test."""
    t = int((1.0 / d) * 18446744073709551616.0)
    rem = ((1 << 64) - 1 - t * d) % (1 << 64)
    if rem >= 1 << 63:
        t -= 1
    elif rem >= d:
        t += 1
    return t & M32


def _div2by1(u1, u0, d, v):
    """bv::div2by1 (Moller and Granlund's 2-by-1 step): (q, r)."""
    p = v * u1 + ((u1 << 32) | u0)
    q = ((p >> 32) + 1) & M32
    r = (u0 - q * d) & M32
    if r > (p & M32):
        q, r = (q - 1) & M32, (r + d) & M32
    if r >= d:
        q, r = q + 1, r - d
    return q, r


def _digits(x, n):
    return [(x >> (32 * i)) & M32 for i in range(n)]


def _value(ds):
    return sum(v << (32 * i) for i, v in enumerate(ds))


def _divrem(lo, hi, d, seen):
    """bv::divrem step for step: (q mod 2**256, r) of (hi, lo) by d, each
    branch taken added to ``seen``."""
    if d == 0:
        seen.add("zero")
        return 0, 0
    wide = hi != 0
    if not wide and lo < d:
        seen.add("below")
        return 0, lo
    L = next(i for i in range(8) if d >> (32 * (7 - i)))
    top = (d >> (32 * (7 - L))) & M32
    s = 32 - top.bit_length()
    if bin(d).count("1") == 1:
        seen.add("pow2")
        return lo >> (32 * (7 - L) + 31 - s), lo & (d - 1)
    seen.update({f"limbs{8 - L}", f"shift{s}"})
    u = _digits(((hi << 256) | lo) << s, 17)
    if L == 7:
        seen.add("short")
        dn = top << s
        v = _reciprocal(dn)
        rem, q = (u[16] if wide else u[8]), 0
        for t in range(0 if wide else 8, 16):
            qd, rem = _div2by1(rem, u[15 - t], dn, v)
            if t >= 8:
                q |= qd << (32 * (15 - t))
        return q, rem >> s
    seen.add("knuth")
    sh = 32 * L + s
    dv = (d << sh) & M256
    d7, d6 = dv >> 224, (dv >> 192) & M32
    v = _reciprocal(d7)
    if not wide:
        u = [0] * 8 + u[:9]
    q = 0
    for t in range((9 if wide else 1) + L):
        if t:
            u = [0] + u[:16]
        if u[16] < d7:
            qh, rh = _div2by1(u[16], u[15], d7, v)
            big = False
        else:
            seen.add("cap")
            qh, rh = M32, u[15] + d7
            big, rh = rh > M32, rh & M32
        n = 0
        for _ in range(2):
            if not big and qh * d6 > ((rh << 32) | u[14]):
                qh, rh, n = qh - 1, rh + d7, n + 1
                big, rh = rh > M32, rh & M32
        if n:
            seen.add(f"corr{n}")
        if qh:
            w = _value(u[8:17]) - qh * dv
            if w < 0:
                seen.add("addback")
                qh, w = qh - 1, w + dv
            u[8:17] = _digits(w, 9)
        q = ((q << 32) | qh) & M256
    return q, _value(u[8:16]) >> sh


def _signed(x):
    return x - (1 << 256) if x >> 255 else x


def _replay(op, a, b, m, seen):
    """One division op on Python ints through ``_divrem``, as
    bv::divide routes it."""
    if op in ("div", "mod"):
        return _divrem(a, 0, b, seen)[op == "mod"]
    if op in ("sdiv", "smod"):
        sa, sb = a >> 255, b >> 255
        q, r = _divrem(-a & M256 if sa else a, 0, -b & M256 if sb else b,
                       seen)
        if op == "sdiv":
            return -q & M256 if sa != sb else q
        return -r & M256 if sa else r
    x = a + b if op == "addmod" else a * b
    return _divrem(x & M256, x >> 256, m, seen)[1]


def _exact(op, a, b, m):
    """The EVM's result from Python's own arithmetic."""
    if op in ("div", "mod", "sdiv", "smod") and b == 0 or \
            op in ("addmod", "mulmod") and m == 0:
        return 0
    if op == "div":
        return a // b
    if op == "mod":
        return a % b
    x, y = _signed(a), _signed(b)
    if op == "sdiv":
        q = abs(x) // abs(y)
        return (q if (x < 0) == (y < 0) else -q) & M256
    if op == "smod":
        r = abs(x) % abs(y)
        return (-r if x < 0 else r) & M256
    return (a + b if op == "addmod" else a * b) % m


_DIV_OPS = ("div", "mod", "sdiv", "smod", "addmod", "mulmod")


def _random_triples(n):
    """Words of random lengths whose digits are often 0, 1, 2**31 - 1,
    2**31, 2**31 + 1, 2**32 - 2 or 2**32 - 1 (the digits that push
    algorithm D's estimate off)."""
    rng = np.random.default_rng(18)
    special = [0, 1, 2, 0x7FFFFFFF, 0x80000000, 0x80000001, 0xFFFFFFFE,
               0xFFFFFFFF]

    def word():
        k = int(rng.integers(1, 9))
        return _value([int(rng.choice(special)) if rng.random() < 0.7
                       else int(rng.integers(0, 1 << 32)) for _ in range(k)])

    return [(word(), word(), word()) for _ in range(n)]


def test_digit_division_replay_is_exact():
    """The card's division, replayed, gives the exact result on every
    edge triple and on 3000 seeded triples."""
    for a, b, m in list(T.DIV_EDGES) + _random_triples(3000):
        for op in _DIV_OPS:
            assert _replay(op, a, b, m, set()) == _exact(op, a, b, m), \
                (op, hex(a), hex(b), hex(m))


@pytest.mark.parametrize("ops", [("div", "mod", "sdiv", "smod"),
                                 ("addmod", "mulmod")],
                         ids=["256-bit dividends", "512-bit dividends"])
def test_div_edges_reach_every_branch(ops):
    """DIV_EDGES drive the card's division through every fast path,
    short division, every divisor length, normalisation shifts of 0 and
    31, and algorithm D's one and two corrections, its cap and its
    add-back, so chip_smoke.py's check on them exercises each."""
    seen = set()
    for a, b, m in T.DIV_EDGES:
        for op in ops:
            _replay(op, a, b, m, seen)
    want = {"zero", "below", "pow2", "short", "knuth", "shift0", "shift31",
            "corr1", "corr2", "cap", "addback"}
    want |= {f"limbs{n}" for n in range(1, 9)}
    assert want <= seen, sorted(want - seen)


def test_reciprocal_and_two_by_one_step_are_exact():
    rng = np.random.default_rng(7)
    ds = [1 << 31, (1 << 31) + 1, (1 << 32) - 1, (1 << 32) - 2,
          0xAAAAAAAA, 0x80000000 | 0x55555555] + \
        [int(x) | (1 << 31) for x in rng.integers(0, 1 << 32, 2000)]
    for d in ds:
        v = _reciprocal(d)
        assert v == ((1 << 64) - 1) // d - (1 << 32)
        for u1 in (0, d - 1, int(rng.integers(0, d))):
            for u0 in (0, M32, int(rng.integers(0, 1 << 32))):
                assert _div2by1(u1, u0, d, v) == divmod((u1 << 32) | u0, d)


@pytest.mark.parametrize("base, e, want", [
    (3, 0, 1),                           # an exponent 0
    (1 << 8, (1 << 255) | 1, 8),         # a base 2^k: a shift
    (3, (1 << 255) | 1, 255 * 40 + 72),  # 255 squares, 1 product
    (3, (1 << 256) - 1, 255 * 40 + 255 * 72),
])
def test_bv_ops_counts_exp_at_its_least_products(base, e, want):
    """chip_smoke.py's row-1 bound counts an EXP square as the low half
    of a square (20 digit products, 2 operations each), not a full
    low-half product (36)."""
    import chip_smoke

    assert chip_smoke.bv_ops("exp", base, e, 0) == want
