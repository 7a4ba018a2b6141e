"""Self-contained crypto for the precompile set.

Role parity with the wheels the reference links against (reference
natives.py:5-12: coincurve/libsecp256k1, py_ecc bn128, blake2b-py): pure
Python here — precompiles execute on the host for concrete inputs only
(symbolic inputs degrade to fresh symbols at the call site), so these paths
are rare and never hot.
"""

from typing import List, Optional, Tuple

# --- secp256k1 --------------------------------------------------------------

P = 2**256 - 2**32 - 977
N = 0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEBAAEDCE6AF48A03BBFD25E8CD0364141
Gx = 0x79BE667EF9DCBBAC55A06295CE870B07029BFCDB2DCE28D959F2815B16F81798
Gy = 0x483ADA7726A3C4655DA4FBFC0E1108A8FD17B448A68554199C47D08FFB10D4B8


def _inv(a: int, m: int) -> int:
    return pow(a, -1, m)


def _ec_add(p1, p2):
    if p1 is None:
        return p2
    if p2 is None:
        return p1
    x1, y1 = p1
    x2, y2 = p2
    if x1 == x2 and (y1 + y2) % P == 0:
        return None
    if p1 == p2:
        lam = (3 * x1 * x1) * _inv(2 * y1, P) % P
    else:
        lam = (y2 - y1) * _inv(x2 - x1, P) % P
    x3 = (lam * lam - x1 - x2) % P
    y3 = (lam * (x1 - x3) - y1) % P
    return (x3, y3)


def _ec_mul(point, scalar: int):
    result = None
    addend = point
    while scalar:
        if scalar & 1:
            result = _ec_add(result, addend)
        addend = _ec_add(addend, addend)
        scalar >>= 1
    return result


def secp256k1_recover(msg_hash: bytes, v: int,
                      r: int, s: int) -> Optional[Tuple[int, int]]:
    """Recover the public key point from an ECDSA signature
    (ecrecover precompile core)."""
    if r >= N or s >= N or v < 27 or v > 28:
        return None
    recid = v - 27
    x = r
    alpha = (pow(x, 3, P) + 7) % P
    beta = pow(alpha, (P + 1) // 4, P)
    if beta * beta % P != alpha:
        return None
    y = beta if (beta & 1) == (recid & 1) else P - beta
    e = int.from_bytes(msg_hash, "big")
    R = (x, y)
    rinv = _inv(r, N)
    # Q = r^-1 (s*R - e*G)
    sR = _ec_mul(R, s)
    eG = _ec_mul((Gx, Gy), e % N)
    neg_eG = None if eG is None else (eG[0], (-eG[1]) % P)
    Q = _ec_mul(_ec_add(sR, neg_eG), rinv)
    return Q


# --- alt_bn128 (G1 only; pairing deferred to precompile fallback) ----------

BN_P = (
    21888242871839275222246405745257275088696311157297823662689037894645226208583
)
BN_N = (
    21888242871839275222246405745257275088548364400416034343698204186575808495617
)


def _bn_inv(a: int) -> int:
    return pow(a, -1, BN_P)


def bn128_is_on_curve(pt) -> bool:
    if pt is None:
        return True
    x, y = pt
    return (y * y - (x * x * x + 3)) % BN_P == 0


def bn128_add(p1, p2):
    if p1 is None:
        return p2
    if p2 is None:
        return p1
    x1, y1 = p1
    x2, y2 = p2
    if x1 == x2 and (y1 + y2) % BN_P == 0:
        return None
    if p1 == p2:
        lam = (3 * x1 * x1) * _bn_inv(2 * y1) % BN_P
    else:
        lam = (y2 - y1) * _bn_inv((x2 - x1) % BN_P) % BN_P
    x3 = (lam * lam - x1 - x2) % BN_P
    y3 = (lam * (x1 - x3) - y1) % BN_P
    return (x3, y3)


def bn128_mul(pt, scalar: int):
    result = None
    addend = pt
    scalar %= BN_N
    while scalar:
        if scalar & 1:
            result = bn128_add(result, addend)
        addend = bn128_add(addend, addend)
        scalar >>= 1
    return result


def bn128_decode_point(x: int, y: int):
    """Validate and decode an affine point; (0,0) is infinity."""
    if x == 0 and y == 0:
        return None
    if x >= BN_P or y >= BN_P:
        raise ValueError("point coordinate out of field")
    pt = (x, y)
    if not bn128_is_on_curve(pt):
        raise ValueError("point not on curve")
    return pt


def bn128_encode_point(pt) -> Tuple[int, int]:
    if pt is None:
        return (0, 0)
    return pt


# --- bn128 pairing (EIP-197 ecPairing) -------------------------------------
# Optimal-ate pairing over alt_bn128 with the standard tower:
# Fq2 = Fq[u]/(u^2+1), Fq12 = Fq[w]/(w^12 - 18 w^6 + 82), G2 on the
# sextic twist y^2 = x^3 + 3/(9+u). Pure big-int polynomial arithmetic —
# ecPairing calls are rare (one per concrete CALL to precompile 8), so
# clarity beats speed here. Capability parity:
# mythril/laser/ethereum/natives.py:204-236 (py_ecc-backed ec_pair).


class _FQP:
    """Element of Fq[x]/(modulus); coeffs are ints mod BN_P."""

    degree = 0
    modulus_coeffs: Tuple[int, ...] = ()

    __slots__ = ("coeffs",)

    def __init__(self, coeffs):
        self.coeffs = tuple(c % BN_P for c in coeffs)
        assert len(self.coeffs) == self.degree

    @classmethod
    def one(cls):
        return cls((1,) + (0,) * (cls.degree - 1))

    @classmethod
    def zero(cls):
        return cls((0,) * cls.degree)

    def __eq__(self, other):
        return type(self) is type(other) and self.coeffs == other.coeffs

    def __hash__(self):
        return hash(self.coeffs)

    def __add__(self, other):
        return type(self)(
            [a + b for a, b in zip(self.coeffs, other.coeffs)])

    def __sub__(self, other):
        return type(self)(
            [a - b for a, b in zip(self.coeffs, other.coeffs)])

    def __neg__(self):
        return type(self)([-a for a in self.coeffs])

    def __mul__(self, other):
        d = self.degree
        if isinstance(other, int):
            return type(self)([a * other for a in self.coeffs])
        prod = [0] * (2 * d - 1)
        for i, a in enumerate(self.coeffs):
            if not a:
                continue
            for j, b in enumerate(other.coeffs):
                prod[i + j] += a * b
        # reduce by x^d = -(modulus_coeffs)
        for i in range(2 * d - 2, d - 1, -1):
            top = prod[i]
            if not top:
                continue
            base = i - d
            for j, m in enumerate(self.modulus_coeffs):
                if m:
                    prod[base + j] -= top * m
        return type(self)(prod[:d])

    __rmul__ = __mul__

    def inv(self):
        """Extended Euclid over Fq[x] against the modulus polynomial."""
        d = self.degree
        lm, hm = [1] + [0] * d, [0] * (d + 1)
        low = list(self.coeffs) + [0]
        high = list(self.modulus_coeffs) + [1]

        def deg(p):
            for i in range(len(p) - 1, -1, -1):
                if p[i]:
                    return i
            return 0

        def poly_rounded_div(a, b):
            dega, degb = deg(a), deg(b)
            temp = list(a)
            out = [0] * len(a)
            binv = pow(b[degb], -1, BN_P)
            for i in range(dega - degb, -1, -1):
                out[i] = (out[i] + temp[degb + i] * binv) % BN_P
                for c in range(degb + 1):
                    temp[c + i] = (temp[c + i] - out[i] * b[c]) % BN_P
            return out[: deg(out) + 1]

        while deg(low):
            r = poly_rounded_div(high, low)
            r += [0] * (d + 1 - len(r))
            nm = list(hm)
            new = list(high)
            for i in range(d + 1):
                for j in range(d + 1 - i):
                    nm[i + j] -= lm[i] * r[j]
                    new[i + j] -= low[i] * r[j]
            nm = [x % BN_P for x in nm]
            new = [x % BN_P for x in new]
            lm, low, hm, high = nm, new, lm, low
        inv0 = pow(low[0], -1, BN_P)
        return type(self)([c * inv0 % BN_P for c in lm[:d]])

    def __truediv__(self, other):
        if isinstance(other, int):
            return self * pow(other, -1, BN_P)
        return self * other.inv()

    def __pow__(self, exponent: int):
        result = type(self).one()
        base = self
        while exponent:
            if exponent & 1:
                result = result * base
            base = base * base
            exponent >>= 1
        return result

    def __repr__(self):
        return f"{type(self).__name__}{self.coeffs}"


class FQ2(_FQP):
    degree = 2
    modulus_coeffs = (1, 0)  # u^2 = -1


class FQ12(_FQP):
    degree = 12
    modulus_coeffs = (82, 0, 0, 0, 0, 0, -18, 0, 0, 0, 0, 0)
    # w^12 = -82 + 18 w^6


# G2 generator (standard alt_bn128 constants; coeffs are (real, imag))
BN_G2 = (
    FQ2((
        10857046999023057135944570762232829481370756359578518086990519993285655852781,
        11559732032986387107991004021392285783925812861821192530917403151452391805634,
    )),
    FQ2((
        8495653923123431417604973247489272438418190587263600148770280649306958101930,
        4082367875863433681332203403145435568316851327593401208105741076214120093531,
    )),
)
BN_B2 = FQ2((3, 0)) / FQ2((9, 1))  # twist curve coefficient

_ATE_LOOP_COUNT = 29793968203157093288
_LOG_ATE = 63


def _ec2_is_on_curve(pt) -> bool:
    if pt is None:
        return True
    x, y = pt
    return y * y - x * x * x == BN_B2


def _ecf_add(p1, p2):
    """Affine addition, generic over the field (FQ2/FQ12 points)."""
    if p1 is None:
        return p2
    if p2 is None:
        return p1
    x1, y1 = p1
    x2, y2 = p2
    if x1 == x2:
        if y1 == y2:
            lam = (3 * (x1 * x1)) / (2 * y1)
        else:
            return None
    else:
        lam = (y2 - y1) / (x2 - x1)
    x3 = lam * lam - x1 - x2
    return (x3, lam * (x1 - x3) - y1)


def _ecf_mul(pt, scalar: int):
    result = None
    addend = pt
    while scalar:
        if scalar & 1:
            result = _ecf_add(result, addend)
        addend = _ecf_add(addend, addend)
        scalar >>= 1
    return result


def _ecf_neg(pt):
    if pt is None:
        return None
    return (pt[0], -pt[1])


_W2 = FQ12((0, 0, 1) + (0,) * 9)   # w^2
_W3 = FQ12((0, 0, 0, 1) + (0,) * 8)  # w^3


def _twist(pt):
    """G2 (FQ2) -> curve over FQ12 via the sextic untwist."""
    if pt is None:
        return None
    x, y = pt
    xc = (x.coeffs[0] - 9 * x.coeffs[1], x.coeffs[1])
    yc = (y.coeffs[0] - 9 * y.coeffs[1], y.coeffs[1])
    nx = FQ12((xc[0],) + (0,) * 5 + (xc[1],) + (0,) * 5)
    ny = FQ12((yc[0],) + (0,) * 5 + (yc[1],) + (0,) * 5)
    return (nx * _W2, ny * _W3)


def _cast_g1_fq12(pt):
    if pt is None:
        return None
    x, y = pt
    return (FQ12((x,) + (0,) * 11), FQ12((y,) + (0,) * 11))


def _linefunc(p1, p2, t):
    x1, y1 = p1
    x2, y2 = p2
    xt, yt = t
    if x1 != x2:
        m = (y2 - y1) / (x2 - x1)
        return m * (xt - x1) - (yt - y1)
    if y1 == y2:
        m = (3 * (x1 * x1)) / (2 * y1)
        return m * (xt - x1) - (yt - y1)
    return xt - x1


def _miller_loop(q, p):
    if q is None or p is None:
        return FQ12.one()
    r = q
    f = FQ12.one()
    for i in range(_LOG_ATE, -1, -1):
        f = f * f * _linefunc(r, r, p)
        r = _ecf_add(r, r)
        if _ATE_LOOP_COUNT & (2 ** i):
            f = f * _linefunc(r, q, p)
            r = _ecf_add(r, q)
    # Frobenius endomorphism steps (coordinates are FQ12 already)
    q1 = (q[0] ** BN_P, q[1] ** BN_P)
    nq2 = (q1[0] ** BN_P, -(q1[1] ** BN_P))
    f = f * _linefunc(r, q1, p)
    r = _ecf_add(r, q1)
    f = f * _linefunc(r, nq2, p)
    return f


def bn128_pairing_factor(q2, p1) -> FQ12:
    """Miller-loop factor (no final exponentiation) of e(p1, q2):
    q2 an FQ2 G2 point (or None), p1 an int-pair G1 point (or None)."""
    return _miller_loop(_twist(q2), _cast_g1_fq12(p1))


def bn128_final_exponentiate(f: FQ12) -> FQ12:
    return f ** ((BN_P ** 12 - 1) // BN_N)


def bn128_g2_decode(x_r: int, x_i: int, y_r: int, y_i: int):
    """Validate and decode a G2 point; (0,0) is infinity. Raises
    ValueError off-curve / out-of-field / outside the r-torsion."""
    for v in (x_r, x_i, y_r, y_i):
        if v >= BN_P:
            raise ValueError("G2 coordinate out of field")
    if x_r == x_i == y_r == y_i == 0:
        return None
    pt = (FQ2((x_r, x_i)), FQ2((y_r, y_i)))
    if not _ec2_is_on_curve(pt):
        raise ValueError("G2 point not on curve")
    if _ecf_mul(pt, BN_N) is not None:
        raise ValueError("G2 point not in the r-torsion subgroup")
    return pt


def bn128_pairing_check(pairs) -> bool:
    """EIP-197 product check: prod e(p1_i, q2_i) == 1."""
    f = FQ12.one()
    for p1, q2 in pairs:
        f = f * bn128_pairing_factor(q2, p1)
    return bn128_final_exponentiate(f) == FQ12.one()


# --- blake2b compression (EIP-152 F function) ------------------------------

_B2B_IV = [
    0x6A09E667F3BCC908, 0xBB67AE8584CAA73B, 0x3C6EF372FE94F82B,
    0xA54FF53A5F1D36F1, 0x510E527FADE682D1, 0x9B05688C2B3E6C1F,
    0x1F83D9ABFB41BD6B, 0x5BE0CD19137E2179,
]

_B2B_SIGMA = [
    [0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15],
    [14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3],
    [11, 8, 12, 0, 5, 2, 15, 13, 10, 14, 3, 6, 7, 1, 9, 4],
    [7, 9, 3, 1, 13, 12, 11, 14, 2, 6, 5, 10, 4, 0, 15, 8],
    [9, 0, 5, 7, 2, 4, 10, 15, 14, 1, 11, 12, 6, 8, 3, 13],
    [2, 12, 6, 10, 0, 11, 8, 3, 4, 13, 7, 5, 15, 14, 1, 9],
    [12, 5, 1, 15, 14, 13, 4, 10, 0, 7, 6, 3, 9, 2, 8, 11],
    [13, 11, 7, 14, 12, 1, 3, 9, 5, 0, 15, 4, 8, 6, 2, 10],
    [6, 15, 14, 9, 11, 3, 0, 8, 12, 2, 13, 7, 1, 4, 10, 5],
    [10, 2, 8, 4, 7, 6, 1, 5, 15, 11, 9, 14, 3, 12, 13, 0],
]

_M64 = (1 << 64) - 1


def _rotr64(x: int, n: int) -> int:
    return ((x >> n) | (x << (64 - n))) & _M64


def blake2b_compress(
    rounds: int, h: List[int], m: List[int], t: Tuple[int, int], f: bool
) -> List[int]:
    """The blake2b F compression function (EIP-152 semantics)."""
    v = h[:] + _B2B_IV[:]
    v[12] ^= t[0] & _M64
    v[13] ^= t[1] & _M64
    if f:
        v[14] ^= _M64

    def g(a, b, c, d, x, y):
        v[a] = (v[a] + v[b] + x) & _M64
        v[d] = _rotr64(v[d] ^ v[a], 32)
        v[c] = (v[c] + v[d]) & _M64
        v[b] = _rotr64(v[b] ^ v[c], 24)
        v[a] = (v[a] + v[b] + y) & _M64
        v[d] = _rotr64(v[d] ^ v[a], 16)
        v[c] = (v[c] + v[d]) & _M64
        v[b] = _rotr64(v[b] ^ v[c], 63)

    for r in range(rounds):
        s = _B2B_SIGMA[r % 10]
        g(0, 4, 8, 12, m[s[0]], m[s[1]])
        g(1, 5, 9, 13, m[s[2]], m[s[3]])
        g(2, 6, 10, 14, m[s[4]], m[s[5]])
        g(3, 7, 11, 15, m[s[6]], m[s[7]])
        g(0, 5, 10, 15, m[s[8]], m[s[9]])
        g(1, 6, 11, 12, m[s[10]], m[s[11]])
        g(2, 7, 8, 13, m[s[12]], m[s[13]])
        g(3, 4, 9, 14, m[s[14]], m[s[15]])

    return [h[i] ^ v[i] ^ v[i + 8] for i in range(8)]
