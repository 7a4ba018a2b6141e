"""Constraint waves for the device feasibility screens, built at the term
level (smt/terms.py).

- ``prefilter_wave``: the fork-sibling wave of the JAX package's
  ``bench.py`` ``bench_prefilter`` (8192 systems by default): systems
  share a pool of bound conditions on two 256-bit symbols and differ in
  which slice of the pool and which verdict-deciding tail they carry.
  One third is feasible, one third has contradictory bounds, one third
  probes a keccak hash against small constants under the keccak axioms.
  The keccak terms are those of ``laser/function_managers/
  keccak_function_manager.py`` (``create_keccak``, ``_axiom_for``,
  ``create_conditions``) for a manager whose first input width is 512
  bits: the width's uninterpreted function applied to the input, and
  the axiom pinning the hash 64-aligned into the width's slab of the
  placeholder region.
- ``propagation_mix``: the sets of ``bench.py`` ``_smoke_propagate``,
  replicated to n sets with the byte position and the constants varied
  per set: bit conflicts (one masked byte pinned to two values) that
  only propagation refutes, bool unit-propagation chains
  (``not(a or b) and a``), and satisfiable tails whose known bits and
  bounds are harvestable facts.
- ``layered_sets``: eight sets that together reach every forward
  opcode and every backward rule of the screens, for holding the
  kernels against their plain versions on every branch. It takes a
  term module, so the JAX package's can build the same sets.

The first two builders return (systems, expected keep).
"""

from ..smt import terms as T

#: the keccak placeholder region and its slabs
#: (keccak_function_manager.py: PREFIX_BITS, SLAB_BITS, ALIGN)
PREFIX_BITS = 28
REGION_LO = ((1 << PREFIX_BITS) - 1) << (256 - PREFIX_BITS)
SLAB = 1 << 212
ALIGN = 64


def _bv(v: int, w: int = 256):
    return T.bv_const(v, w)


def keccak_terms(data):
    """(hash term, axiom conjunction) of a keccak manager whose first
    and only symbolic input is ``data``: ``create_keccak(data)`` and
    ``create_conditions()``."""
    w = data.width
    uf = T.func_decl(f"kec{w}", (w,), 256)
    inverse = T.func_decl(f"unkec{w}", (256,), w)
    h = T.apply_func(uf, data)
    slab_lo, slab_hi = REGION_LO, REGION_LO + SLAB
    in_slab = T.mk_bool_and(
        T.mk_ule(_bv(slab_lo), h),
        T.mk_ult(h, _bv(slab_hi)),
        T.mk_eq(T.mk_urem(h, _bv(ALIGN)), _bv(0)),
    )
    axiom = T.mk_bool_and(T.mk_eq(T.apply_func(inverse, h), data),
                          T.mk_bool_or(in_slab, T.bool_t(False)))
    return h, T.mk_bool_and(axiom)


def prefilter_wave(n: int = 8192):
    """``bench_prefilter``'s n systems and which of them may be kept
    (the i % 3 == 0 ones)."""
    x = T.bv_var("pf_x", 256)
    y = T.bv_var("pf_y", 256)
    h, axioms = keccak_terms(T.bv_var("pf_d", 512))
    pool = []
    for j in range(256):
        pool.append(T.mk_ule(_bv(j), x))                     # UGE(x, j)
        pool.append(T.mk_ule(y, _bv(1 << (j % 200 + 8))))   # ULE(y, ..)
    probes = [T.mk_eq(h, _bv(324345425435 + j)) for j in range(64)]
    contras = [(T.mk_ule(_bv(5000 + j), x), T.mk_ule(x, _bv(10 + j)))
               for j in range(64)]
    systems, keep = [], []
    for i in range(n):
        prefix = [pool[(i * 7 + k) % len(pool)] for k in range(24)]
        kind = i % 3
        if kind == 0:  # feasible
            systems.append(prefix)
        elif kind == 1:  # contradictory bounds: lo > hi
            systems.append(prefix + list(contras[i % len(contras)]))
        else:  # detector-style probe against the hash interval
            systems.append(prefix + [axioms, probes[i % len(probes)]])
        keep.append(kind == 0)
    return systems, keep


#: the smoke's sets, in its order: four bit conflicts, one unit chain,
#: four satisfiable tails
MIX_PERIOD = 9
#: groups of the mix with symbols of their own; group g + MIX_GROUPS
#: repeats group g
MIX_GROUPS = 64


def propagation_mix(n: int = 8192):
    """``_smoke_propagate``'s sets replicated to n: set i is the smoke's
    set i % 9 in group g = (i // 9) % MIX_GROUPS, over symbols of the
    group's own, with the conflicts' byte positions shifted by 4 g and
    the constants by g. Bit conflicts and unit chains are UNSAT (only
    propagation refutes them), satisfiable tails are kept.

    Each group has its own symbols because the backward pass refines a
    node from at most four parents per level (``MAX_BACK_ROUNDS``): one
    masked byte shared by many groups' equalities would be pinned only
    by the first four. Group 0 is the smoke's sets themselves."""
    systems, keep = [], []
    for i in range(n):
        r, g = i % MIX_PERIOD, (i // MIX_PERIOD) % MIX_GROUPS
        tag = str(g) if g else ""
        x = T.bv_var(f"prop_smoke_x{tag}", 256)
        if r < 4:
            # a masked byte pinned to two values
            p = (r + 4 * g) % 32
            c = 0x42 + g % 16
            m = _bv(0xFF << (8 * p))
            systems.append([T.mk_eq(T.mk_and(x, m), _bv(c << (8 * p))),
                            T.mk_eq(T.mk_and(x, m),
                                    _bv((c + 1) << (8 * p)))])
            keep.append(False)
        elif r == 4:
            a = T.bool_var(f"prop_smoke_a{tag}")
            b = T.bool_var(f"prop_smoke_b{tag}")
            systems.append([T.mk_not(T.mk_bool_or(a, b)), a])
            keep.append(False)
        else:
            # the byte stays below 2**20, so x <= 2**20 holds
            j, p = r - 5, g % 2
            c = ((0x40 | j) + 4 * (g % 16)) & 0xFF
            y = T.bv_var(f"prop_smoke_y{tag}", 256)
            systems.append([
                T.mk_eq(T.mk_and(x, _bv(0xFF << (8 * p))), _bv(c << (8 * p))),
                T.mk_ule(x, _bv(1 << 20)), T.mk_ule(y, x)])
            keep.append(True)
    return systems, keep


def layered_sets(T=T):
    """Eight assertion sets over one DAG of four op levels, each 16 wide
    after padding and each holding MUL, UDIV and UREM, so the JAX
    package compiles one level kernel for all four. Together the levels
    reach every forward opcode and every backward rule; the opcodes
    without a device transfer (SLT, SLE) make the roots that read the
    last level's MUL, UDIV and UREM, and add no level. A 264-bit
    CONCAT compared with 264-bit constants is the wide case (topped,
    never truncated). Set 0 has contradictory
    bounds on ``la`` (dead on arrival); sets 2 (a bool unit chain) and
    6 (a known-bit conflict) are refuted only by propagation."""
    a, b = T.bv_var("la", 256), T.bv_var("lb", 256)
    e = T.bv_var("le", 64)
    f, g = T.bv_var("lf", 8), T.bv_var("lg", 8)
    p, q = T.bool_var("lp"), T.bool_var("lq")

    def c(v, w=256):
        return T.bv_const(v, w)

    # depth 2: bounds that seed, the expensive three, and one node of
    # most transfers over the leaves
    lo_a = T.mk_ule(c(3000), a)
    hi_a = T.mk_ult(a, c(1000))
    hi_f = T.mk_ule(f, c(0x7F, 8))
    mul1, div1, rem1 = (T.mk_mul(a, c(3)), T.mk_udiv(a, b),
                        T.mk_urem(e, c(10, 64)))
    add1, sub1 = T.mk_add(a, c(5)), T.mk_sub(a, b)
    and1, or1 = T.mk_and(e, c(0xF0, 64)), T.mk_or(e, c(3, 64))
    xor1, not1, neg1 = T.mk_xor(f, g), T.mk_bnot(f), T.mk_neg(g)
    shl1, shr1 = T.mk_shl(e, c(4, 64)), T.mk_lshr(a, c(8))
    ext1 = T.mk_extract(7, 0, b)
    # depth 3
    mul2, div2 = T.mk_mul(div1, c(3)), T.mk_udiv(mul1, shr1)
    rem2 = T.mk_urem(rem1, shl1)
    zext2, sext2 = T.mk_zext(56, ext1), T.mk_sext(56, ext1)
    cat2 = T.mk_concat(ext1, xor1)
    ite2 = T.mk_ite(hi_f, add1, sub1)
    eq2 = T.mk_eq(and1, c(0x40, 64))
    ult2 = T.mk_ult(not1, neg1)
    eq2b = T.mk_eq(or1, c(0x40, 64))  # bit 0 is known 1: a conflict
    wide = T.mk_concat(c(0, 8), add1)  # 264 bits: NOP, topped
    band2 = T.mk_bool_and(lo_a, hi_f)
    bor2 = T.mk_bool_or(hi_a, p)
    bnot2 = T.mk_not(hi_f)
    bxor2 = T.mk_bool_xor(lo_a, q)
    bite2 = T.mk_bool_ite(p, hi_a, lo_a)
    # depth 4
    mul3, div3 = T.mk_mul(div2, c(2)), T.mk_udiv(mul2, c(3))
    rem3 = T.mk_urem(rem2, c(10, 64))
    eq3 = T.mk_eq(zext2, c(0x42, 64))
    sgn3 = T.mk_ule(sext2, c(0x7F, 64))
    ult3 = T.mk_ult(cat2, c(0x1234, 16))
    ule3 = T.mk_ule(ite2, c(2000))
    wide3 = T.mk_ult(wide, c(1 << 260, 264))
    wide3b = T.mk_ult(c(1 << 260, 264), wide)
    shl3 = T.mk_shl(rem2, c(2, 64))
    shr3 = T.mk_lshr(zext2, c(1, 64))
    and3 = T.mk_bool_and(bor2, eq2)
    or3 = T.mk_bool_or(bnot2, ult2)
    not3 = T.mk_not(bor2)
    xor3 = T.mk_bool_xor(bxor2, eq2b)
    ite3 = T.mk_bool_ite(bite2, eq2, ult2)
    # depth 5: the roots, and the expensive three for depth-6 roots
    # whose opcode has no device transfer (SLT: NOP, so no level)
    tops = [T.mk_slt(T.mk_mul(shr3, c(3, 64)), c(9, 64)),
            T.mk_slt(T.mk_udiv(mul3, c(5)), c(77)),
            T.mk_sle(T.mk_urem(div3, c(6)), c(2))]
    r = [
        T.mk_ule(mul3, c(1 << 20)), T.mk_ult(div3, c(400)),
        T.mk_eq(rem3, c(1, 64)), T.mk_ule(c(8, 64), shl3),
        T.mk_eq(shr3, c(0x21, 64)), T.mk_bool_and(and3, eq3),
        T.mk_bool_or(or3, ult3), T.mk_not(and3),
        T.mk_bool_xor(xor3, ule3), T.mk_bool_ite(ite3, sgn3, ule3),
        T.mk_bool_and(not3, sgn3), T.mk_bool_or(ite3, eq3),
    ]
    return [
        [lo_a, hi_a, r[0], r[1], r[2]],
        [hi_f, r[3], r[4], r[5]],
        [r[7], bor2, eq2],
        [r[6], r[8], r[9], hi_f],
        [r[10], r[11], wide3, tops[0]],
        [wide3b, hi_a, bite2],
        [eq2, ult2, eq2b, xor3],
        [not3, r[1], lo_a, tops[1], tops[2]],
    ]
