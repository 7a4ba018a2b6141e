"""256-bit EVM words as 8 little-endian 32-bit limbs, in PyTorch.

The counterpart of ``mythril_tpu/ops/bv256.py``. The lane-state planes
keep the JAX layout ``(..., 8)`` and hold each limb's 32-bit pattern in
an ``int32`` tensor; the CUDA kernels read the same memory as
``uint32_t``. PyTorch has no unsigned 32-bit arithmetic on the CPU, so
the plain functions here compute on ``int64`` limbs holding values in
``[0, 2**32)`` (``u32`` turns a plane into that form, ``i32`` back).
Every function broadcasts over leading batch dimensions and gives the
EVM results bit for bit: ``x/0 = x%0 = 0``, ``SDIV(-2**255, -1) =
-2**255``, shifts of 256 or more, ``SIGNEXTEND`` with ``k >= 31``.

``bv256_apply`` runs one op over a batch of words: on a CPU tensor
through these plain functions, on a CUDA tensor through the device
functions of ``csrc/bv256.cuh`` (the same ones the stepper kernel
inlines), which is how ``chip_smoke.py`` holds them against each other.
"""

import ctypes

import numpy as np
import torch

NLIMBS = 8
NDIGITS = 16
WORD_BITS = 256
M32 = 0xFFFFFFFF
M16 = 0xFFFF
I64 = torch.int64


# ---------------------------------------------------------------------------
# host conversions and plane <-> arithmetic forms
# ---------------------------------------------------------------------------

def int_to_limbs(value: int) -> np.ndarray:
    """Python int -> (8,) little-endian uint32 limbs."""
    value &= (1 << 256) - 1
    return np.array([(value >> (32 * i)) & M32 for i in range(NLIMBS)],
                    dtype=np.uint32)


def limbs_to_int(limbs) -> int:
    arr = np.asarray(limbs).astype(np.uint64) & M32
    return sum(int(arr[..., i]) << (32 * i) for i in range(NLIMBS))


def u32(x: torch.Tensor) -> torch.Tensor:
    """int32 bit patterns (or any int tensor) -> int64 in [0, 2**32)."""
    return x.to(I64) & M32


def i32(x: torch.Tensor) -> torch.Tensor:
    """int64 values -> int32 tensor holding their low 32 bits."""
    x = x & M32
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)


def _zeros_like_lane(a):
    return torch.zeros(a.shape[:-1], dtype=I64, device=a.device)


def from_u32(x: torch.Tensor) -> torch.Tensor:
    """(...,) value -> (..., 8) word with the value in limb 0."""
    x = x.to(I64) & M32
    rest = torch.zeros(x.shape + (NLIMBS - 1,), dtype=I64, device=x.device)
    return torch.cat([x[..., None], rest], dim=-1)


def bool_to_word(m: torch.Tensor) -> torch.Tensor:
    return from_u32(m.to(I64))


# ---------------------------------------------------------------------------
# add / sub
# ---------------------------------------------------------------------------

_POW2 = {}


def _limb_weights(device):
    """1, 2, 4, ... 128: a sum of +-1 flags weighted by these has the
    sign of its most significant nonzero flag."""
    key = str(device)
    if key not in _POW2:
        _POW2[key] = 1 << torch.arange(NLIMBS, device=device, dtype=I64)
    return _POW2[key]


def _carries(up, down, device):
    """Carry into each limb of a limb-wise sum: a limb that overflows
    (``up``) sends a carry, one that cannot absorb one (``down``) stops
    it, any other passes the incoming carry on."""
    v = (up.to(I64) - down.to(I64)) * _limb_weights(device)
    run = torch.cumsum(v, dim=-1) > 0
    return torch.cat([torch.zeros_like(run[..., :1]), run[..., :-1]],
                     dim=-1).to(I64)


def add(a, b):
    s = a + b
    return (s + _carries(s > M32, s < M32, s.device)) & M32


def sub(a, b):
    d = a - b
    return (d - _carries(d < 0, d > 0, d.device)) & M32


def neg(a):
    return sub(torch.zeros_like(a), a)


# ---------------------------------------------------------------------------
# comparisons
# ---------------------------------------------------------------------------

def is_zero(a):
    return (a != 0).sum(dim=-1) == 0


def eq(a, b):
    return (a != b).sum(dim=-1) == 0


def ult(a, b):
    v = ((a < b).to(I64) - (a > b).to(I64)) * _limb_weights(a.device)
    return v.sum(dim=-1) > 0


def ugt(a, b):
    return ult(b, a)


def sign_bit(a):
    return (a[..., NLIMBS - 1] >> 31) != 0


def slt(a, b):
    sa, sb = sign_bit(a), sign_bit(b)
    return torch.where(sa == sb, ult(a, b), sa & ~sb)


def sgt(a, b):
    return slt(b, a)


# ---------------------------------------------------------------------------
# multiplication: 16-bit digit schoolbook with column sums
# ---------------------------------------------------------------------------

def _to_digits(a):
    return torch.stack([a & M16, a >> 16], dim=-1).reshape(
        a.shape[:-1] + (NDIGITS,))


_COLS = {}


def _col_index(device):
    key = str(device)
    if key not in _COLS:
        i = torch.arange(NDIGITS, device=device)
        _COLS[key] = (i[:, None] + i[None, :]).reshape(-1)
    return _COLS[key]


def _mul_digits(a, b, out_digits):
    """Carry-propagated 16-bit digits of a*b, the low ``out_digits``."""
    da, db = _to_digits(a), _to_digits(b)
    prods = (da[..., :, None] * db[..., None, :]).reshape(
        a.shape[:-1] + (NDIGITS * NDIGITS,))
    idx = _col_index(a.device).expand(prods.shape)
    cols = torch.zeros(a.shape[:-1] + (2 * NDIGITS,), dtype=I64,
                       device=a.device)
    cols.scatter_add_(-1, idx, prods)   # each column < 16 * 2**32
    out, carry = [], _zeros_like_lane(a)
    for k in range(out_digits):
        t = cols[..., k] + carry
        out.append(t & M16)
        carry = t >> 16
    return torch.stack(out, dim=-1)


def _from_digits(d):
    d = d.reshape(d.shape[:-1] + (NLIMBS, 2))
    return d[..., 0] | (d[..., 1] << 16)


def mul(a, b):
    return _from_digits(_mul_digits(a, b, NDIGITS))


def mul_full(a, b):
    d = _mul_digits(a, b, 2 * NDIGITS)
    return _from_digits(d[..., :NDIGITS]), _from_digits(d[..., NDIGITS:])


# ---------------------------------------------------------------------------
# shifts, byte, signextend
# ---------------------------------------------------------------------------

def _word_shift_oob(shift):
    return (shift[..., 0] >= WORD_BITS) | (shift[..., 1:] != 0).any(dim=-1)


def _gather_limb(a, idx):
    idx = idx.clamp(0, NLIMBS - 1).to(I64)
    return torch.gather(a, -1, idx[..., None])[..., 0]


def shl(a, shift):
    """a << shift (``shift`` a word; 256 or more gives 0)."""
    big = _word_shift_oob(shift)
    s = torch.where(shift[..., 0] >= WORD_BITS, 0, shift[..., 0])
    ls, bs = s >> 5, s & 31
    out = []
    for i in range(NLIMBS):
        src = i - ls
        lo = torch.where(src >= 0, _gather_limb(a, src), 0)
        lo2 = torch.where(src - 1 >= 0, _gather_limb(a, src - 1), 0)
        hi_part = torch.where(bs == 0, 0, lo2 >> ((32 - bs) & 31))
        out.append(((lo << bs) | hi_part) & M32)
    res = torch.stack(out, dim=-1)
    return torch.where(big[..., None], 0, res)


def shr(a, shift):
    big = _word_shift_oob(shift)
    s = torch.where(shift[..., 0] >= WORD_BITS, 0, shift[..., 0])
    ls, bs = s >> 5, s & 31
    out = []
    for i in range(NLIMBS):
        src = i + ls
        lo = torch.where(src < NLIMBS, _gather_limb(a, src), 0)
        hi = torch.where(src + 1 < NLIMBS, _gather_limb(a, src + 1), 0)
        hi_part = torch.where(bs == 0, 0, (hi << ((32 - bs) & 31)) & M32)
        out.append((lo >> bs) | hi_part)
    res = torch.stack(out, dim=-1)
    return torch.where(big[..., None], 0, res)


def sar(a, shift):
    logical = shr(a, shift)
    fill = M32 ^ shr(torch.full_like(a, M32), shift)
    return torch.where(sign_bit(a)[..., None], logical | fill, logical)


def byte_op(pos, x):
    """EVM BYTE: byte ``pos`` of ``x``, 0 = most significant."""
    oob = _word_shift_oob(pos) | (pos[..., 0] >= 32)
    p = torch.where(oob, 0, pos[..., 0])
    bi = 31 - p
    val = (_gather_limb(x, bi >> 2) >> ((bi & 3) * 8)) & 0xFF
    return from_u32(torch.where(oob, 0, val))


def signextend(k, x):
    """EVM SIGNEXTEND from byte ``k`` (0 = lowest)."""
    oob = _word_shift_oob(k) | (k[..., 0] >= 31)
    kk = torch.where(oob, 31, k[..., 0])
    top = kk * 8 + 7
    limb = top >> 5
    off = top & 31
    sign = (_gather_limb(x, limb) >> off) & 1
    li = torch.arange(NLIMBS, device=x.device)
    lm = limb[..., None]
    partial_mask = torch.where(off[..., None] == 31, M32,
                               (1 << ((off[..., None] + 1) & 31)) - 1)
    keep = torch.where(li < lm, M32, 0) | torch.where(li == lm,
                                                      partial_mask, 0)
    keep = torch.where(li > lm, 0, keep)
    ext = torch.where(sign[..., None] != 0, M32 ^ keep, 0)
    res = (x & keep) | ext
    return torch.where(oob[..., None], x, res)


# ---------------------------------------------------------------------------
# division (restoring shift-subtract)
# ---------------------------------------------------------------------------

def _shl_one(a):
    hi = torch.cat([torch.zeros_like(a[..., :1]), a[..., :-1] >> 31],
                   dim=-1)
    return ((a << 1) & M32) | hi


def _reduce_bits(bits, m):
    """Remainder of the number whose bits (most significant first) are
    the columns of ``bits`` (..., nbits) modulo the word ``m``."""
    rem = torch.zeros_like(m)
    quot_bits = []
    for i in range(bits.shape[-1]):
        carry257 = (rem[..., NLIMBS - 1] >> 31) != 0
        rem = _shl_one(rem)
        rem[..., 0] |= bits[..., i]
        ge = carry257 | ~ult(rem, m)
        rem = torch.where(ge[..., None], sub(rem, m), rem)
        quot_bits.append(ge.to(I64))
    return quot_bits, rem


def _bits_msb_first(a):
    sh = torch.arange(31, -1, -1, device=a.device)
    per = (a[..., :, None] >> sh) & 1          # (..., 8, 32) msb-first
    return per.flip(-2).reshape(a.shape[:-1] + (WORD_BITS,))


def divmod_u(a, b):
    """Unsigned (a // b, a % b); division by zero gives (0, 0)."""
    qbits, rem = _reduce_bits(_bits_msb_first(a), b)
    q = torch.stack(qbits, dim=-1)              # msb first
    q = q.flip(-1).reshape(a.shape[:-1] + (NLIMBS, 32))
    sh = torch.arange(32, device=a.device)
    quot = (q << sh).sum(dim=-1)
    bz = is_zero(b)[..., None]
    return torch.where(bz, 0, quot), torch.where(bz, 0, rem)


def div(a, b):
    return divmod_u(a, b)[0]


def mod(a, b):
    return divmod_u(a, b)[1]


def sdiv(a, b):
    sa, sb = sign_bit(a), sign_bit(b)
    q = div(torch.where(sa[..., None], neg(a), a),
            torch.where(sb[..., None], neg(b), b))
    return torch.where((sa ^ sb)[..., None], neg(q), q)


def smod(a, b):
    sa, sb = sign_bit(a), sign_bit(b)
    r = mod(torch.where(sa[..., None], neg(a), a),
            torch.where(sb[..., None], neg(b), b))
    return torch.where(sa[..., None], neg(r), r)


def _mod_512(lo, hi, m):
    bits = torch.cat([_bits_msb_first(hi), _bits_msb_first(lo)], dim=-1)
    _, rem = _reduce_bits(bits, m)
    return torch.where(is_zero(m)[..., None], 0, rem)


def addmod(a, b, m):
    s = add(a, b)
    return _mod_512(s, from_u32(ult(s, a).to(I64)), m)


def mulmod(a, b, m):
    lo, hi = mul_full(a, b)
    return _mod_512(lo, hi, m)


def exp(base, exponent):
    """base ** exponent mod 2**256 by square-and-multiply over all 256
    exponent bits."""
    result = torch.zeros_like(base)
    result[..., 0] = 1
    acc = base
    for i in range(WORD_BITS):
        bit = ((exponent[..., i >> 5] >> (i & 31)) & 1) != 0
        result = torch.where(bit[..., None], mul(result, acc), result)
        acc = mul(acc, acc)
    return result


# ---------------------------------------------------------------------------
# one op over a batch: plain on the CPU, csrc/bv256.cu on the card
# ---------------------------------------------------------------------------

#: op name -> (arity, plain function of u32-form words); the index is
#: the op code the CUDA entry takes (csrc/bv256.cu keeps the same order)
OPS = {
    "add": (2, add), "sub": (2, sub), "neg": (1, neg), "mul": (2, mul),
    "mul_hi": (2, lambda a, b: mul_full(a, b)[1]),
    "div": (2, div), "mod": (2, mod), "sdiv": (2, sdiv),
    "smod": (2, smod), "addmod": (3, addmod), "mulmod": (3, mulmod),
    "exp": (2, exp), "shl": (2, shl), "shr": (2, shr), "sar": (2, sar),
    "byte": (2, byte_op), "signextend": (2, signextend),
    "lt": (2, lambda a, b: bool_to_word(ult(a, b))),
    "gt": (2, lambda a, b: bool_to_word(ugt(a, b))),
    "slt": (2, lambda a, b: bool_to_word(slt(a, b))),
    "sgt": (2, lambda a, b: bool_to_word(sgt(a, b))),
    "eq": (2, lambda a, b: bool_to_word(eq(a, b))),
    "iszero": (1, lambda a: bool_to_word(is_zero(a))),
    "and": (2, lambda a, b: a & b), "or": (2, lambda a, b: a | b),
    "xor": (2, lambda a, b: a ^ b), "not": (1, lambda a: M32 ^ a),
}
OP_CODES = {name: i for i, name in enumerate(OPS)}


def bv256_plain(op: str, a, b=None, c=None) -> torch.Tensor:
    """``op`` over (N, 8) int32 limb planes, in plain PyTorch."""
    arity, fn = OPS[op]
    args = [u32(x) for x in (a, b, c)[:arity]]
    return i32(fn(*args))


def bv256_apply(op: str, a, b=None, c=None) -> torch.Tensor:
    """``op`` over (N, 8) int32 limb planes: the plain version for CPU
    tensors, the ``csrc/bv256.cu`` kernel for CUDA tensors. Unused
    operands may be None."""
    arity, _ = OPS[op]
    if a.device.type == "cpu":
        return bv256_plain(op, a, b, c)
    from .. import _build

    a = a.contiguous()
    b = a if b is None else b.contiguous()
    c = a if c is None else c.contiguous()
    for name, t in (("a", a), ("b", b), ("c", c)):
        _build.need_cuda(t, torch.int32, name)
        if t.shape != a.shape or t.shape[-1] != NLIMBS:
            raise ValueError(f"{name}: expected shape {tuple(a.shape)}")
    out = torch.empty_like(a)
    lib = _build.lib("bv256.cu", {"bv256_apply": [
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]})
    n = a.numel() // NLIMBS
    rc = lib.bv256_apply(OP_CODES[op], _build.ptr(a), _build.ptr(b),
                         _build.ptr(c), _build.ptr(out), n,
                         _build.stream(a.device))
    _build.LAUNCHES["bv256"] += 1
    _build.check(lib, rc, f"bv256_apply({op})")
    return out
