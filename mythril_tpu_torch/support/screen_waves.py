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
- ``edge_sets`` and ``k5_edge_cases``: the edge inputs of K6 and K7, and
  of K5 (encodings, some with their levels or seeds edited past what
  ``linearize`` makes: negative indices, a level that reads a row it
  writes); ``k5_edge_plans``: the propagation plans of the latter, the
  edge inputs of K6's staged level and of K11.

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


#: the pairs of the staging edge case: 2 x 1000 EQ entries with numeric
#: targets stage 256 KB a state, past a block's shared memory
STAGE_PAIRS = 1000


def edge_sets(T=T):
    """The edge inputs of K6 and K7 (``ops/propagate`` ``fwd_level``,
    ``back_round``), by name, each a list of assertion sets over one
    DAG; it takes a term module as ``layered_sets`` does.

    - ``sibling``: ADD(x, y) refines x and y in one round, each entry's
      target the other's sibling;
    - ``ite_cond``: in one round an ITE's branches and a bool AND's
      arguments, one of which is the ITE's condition;
    - ``one_entry``: a NOT over a comparison, a round of one entry;
    - ``staging``: ``STAGE_PAIRS`` EQs of two fresh 256-bit variables
      and an AND of a bool variable and a NOT, one round of 2000
      numeric targets and one bool target (an odd count of 2-word
      slots);
    - ``heavy``: a level of UDIV, UREM and MUL beside ULE nodes;
    - ``bool_num``: a round with bool targets (an AND of bool variables)
      and numeric ones (a ULE).
    """
    x, y, u, v = (T.bv_var(f"ex{n}", 256) for n in "xyuv")
    p, q, r = T.bool_var("ep"), T.bool_var("eq"), T.bool_var("er")

    def c(val, w=256):
        return T.bv_const(val, w)

    total = T.mk_eq(T.mk_add(x, y), c(10))
    cond = T.mk_ult(u, c(5))
    pick = T.mk_eq(T.mk_ite(cond, x, y), c(7))
    xs = [T.bv_var(f"es{i}", 256) for i in range(STAGE_PAIRS)]
    ys = [T.bv_var(f"et{i}", 256) for i in range(STAGE_PAIRS)]
    pairs = [T.mk_eq(a, b) for a, b in zip(xs, ys)]
    heavy = [T.mk_ule(T.mk_udiv(x, y), c(9)), T.mk_ule(T.mk_urem(x, y), c(3)),
             T.mk_ule(T.mk_mul(x, c(3)), c(600)), T.mk_ule(x, c(100))]
    return {
        "sibling": [[total, T.mk_ult(x, c(4))], [total, T.mk_ult(y, c(4))],
                    [total]],
        "ite_cond": [[pick, T.mk_bool_and(cond, T.mk_ult(v, c(3)))],
                     [pick, T.mk_bool_and(T.mk_not(cond), p)], [pick]],
        "one_entry": [[T.mk_not(T.mk_ult(x, c(5)))],
                      [T.mk_not(T.mk_ult(x, c(5))), T.mk_ule(c(9), x)]],
        "staging": [pairs + [T.mk_ult(xs[0], c(9)),
                             T.mk_bool_and(r, T.mk_not(q))],
                    pairs + [T.mk_ule(c(4), ys[1])]],
        "heavy": [heavy, heavy[:2] + [T.mk_ule(c(200), x)], heavy[2:]],
        "bool_num": [[T.mk_bool_and(p, q), T.mk_ule(x, c(7))],
                     [T.mk_bool_or(p, q), T.mk_not(p), T.mk_ule(c(5), x)]],
    }


#: K5's edge case of many states (past the card's resident blocks, so a
#: block takes several states) and its level wider than one block
K5_MANY_STATES = 8192
K5_WIDE = 300


def _edited(enc, **levels):
    """A copy of an encoding whose levels are replaced by ``levels``
    (``l<index>`` -> level dict); its seed slots are a copy to edit. It
    keeps the host arrays of ``linearize`` (``propagate.build_plan``
    reads them), not the layouts cached beside them."""
    import copy

    import numpy as np

    out = copy.copy(enc)
    out.levels = [dict(lv) for lv in enc.levels]
    out.seed_idx = np.array(enc.seed_idx)
    for key, lv in levels.items():
        out.levels[int(key[1:])] = lv
    out.host = {k: v for k, v in enc.host.items() if isinstance(k, str)}
    return out


def _ops_present(op):
    from ..ops.intervals import NOP, _canonical_ops

    return _canonical_ops(set(op.tolist()) - {NOP})


def k5_edge_cases() -> dict:
    """The edge inputs of K5 (``ops/intervals`` ``eval_levels_kernel``), by
    name, each an encoding of ``ops/intervals.linearize`` (numpy arrays:
    the JAX ``_eval_level`` takes them as they are), some with their
    levels or seed slots edited:

    - ``pads_only``: a level of pads only (every op NOP) before a level
      of one ULT;
    - ``one_entry``: levels of one entry each (a ULT, then a NOT of it),
      one state;
    - ``every_class``: one level holding every op class (comparisons,
      ADD, SUB, AND, shifts, MUL, UDIV, UREM, OR, XOR), 3 states;
    - ``negative_index``: the all-opcode wave (``layered_sets``, T
      rows) with level 1 edited: a CONCAT's first operand row -T + r
      (wraps to a leaf's row r), a MUL's second -T - 5 (wraps to -5,
      clamps to row 0), an ITE's third -T + r, an EQ's node -T + its
      row (wraps onto itself) and a ULT's node -T - 1 (dropped); seed
      slots -T + r (wraps) and -T - 3 (dropped); no level reads a row
      it writes;
    - ``reads_own_level``: the all-opcode wave with the MUL's second
      operand of level 1 wrapped onto the CONCAT's node of the same
      level, so the level reads a row it writes (JAX reads every
      operand first);
    - ``one_state``: one system of bounds on a 64-bit variable, an ADD
      and a NOT;
    - ``many_states``: ``K5_MANY_STATES`` states of four bound systems
      over one 64-bit variable (seeds differ by state);
    - ``wide_level``: a level of ``K5_WIDE`` comparisons, wider than
      K5's block of 256 threads, 2 states;
    - ``bool_operands``: the bool connectives (AND, OR, NOT, XOR, a bool
      ITE) and an ITE over bool conditions, on comparisons and bool
      variables, 4 states.
    """
    import numpy as np

    from ..ops import intervals as I

    x, y = T.bv_var("kx", 256), T.bv_var("ky", 256)
    w = T.bv_var("kw", 64)
    p, q = T.bool_var("kp"), T.bool_var("kq")

    def c(v, width=256):
        return T.bv_const(v, width)

    cases = {}
    base = I.linearize([[T.mk_ult(x, c(9))]])
    pads = dict(base.levels[0])
    pads["op"] = np.zeros_like(pads["op"])
    pads["ops_present"] = _ops_present(pads["op"])
    cases["pads_only"] = _edited(base)
    cases["pads_only"].levels = [pads] + cases["pads_only"].levels
    cases["one_entry"] = I.linearize([[T.mk_not(T.mk_ult(x, c(5)))]])
    mixed = [T.mk_ule(T.mk_add(x, y), c(50)), T.mk_ule(T.mk_sub(x, y), c(9)),
             T.mk_ult(T.mk_and(x, y), c(7)), T.mk_ule(T.mk_shl(x, c(2)), c(99)),
             T.mk_ule(T.mk_lshr(x, c(1)), c(3)), T.mk_ule(T.mk_mul(x, c(3)), c(60)),
             T.mk_ule(T.mk_udiv(x, y), c(4)), T.mk_ule(T.mk_urem(x, y), c(2)),
             T.mk_ult(T.mk_or(x, y), c(64)), T.mk_ult(T.mk_xor(x, y), c(64))]
    cases["every_class"] = I.linearize([mixed + [T.mk_ule(x, c(20))],
                                        mixed + [T.mk_ule(c(3), y)], mixed])

    layered = I.linearize(layered_sets())
    n_rows = layered.init_lo.shape[0]
    lv = {k: np.array(v) for k, v in layered.levels[1].items()
          if k != "ops_present"}
    real = np.nonzero(lv["op"] != I.NOP)[0]
    by_op = {int(lv["op"][j]): j for j in real}
    leaf = int(layered.levels[0]["args"][0, 0])  # a row no level writes
    lv["args"][by_op[I.CONCAT2], 0] = leaf - n_rows
    lv["args"][by_op[I.MUL], 1] = -n_rows - 5
    lv["args"][by_op[I.ITE], 2] = leaf - n_rows
    lv["node"][by_op[I.EQ]] -= n_rows
    lv["node"][by_op[I.ULT]] = -n_rows - 1
    lv["ops_present"] = layered.levels[1]["ops_present"]
    neg = _edited(layered, l1=lv)
    seeded = np.nonzero(neg.seed_idx[:, 0] < layered.n_nodes)[0]
    neg.seed_idx[seeded[0], 0] -= n_rows
    neg.seed_idx[seeded[-1], 0] = -n_rows - 3
    cases["negative_index"] = neg
    own = {k: np.array(v) for k, v in layered.levels[1].items()
           if k != "ops_present"}
    own["args"][by_op[I.MUL], 1] = int(own["node"][by_op[I.CONCAT2]]) - n_rows
    own["ops_present"] = layered.levels[1]["ops_present"]
    cases["reads_own_level"] = _edited(layered, l1=own)

    bounds = [[T.mk_ule(c(3, 64), w), T.mk_ult(w, c(40, 64)),
               T.mk_ule(T.mk_add(w, c(1, 64)), c(30, 64))],
              [T.mk_ult(w, c(2, 64)), T.mk_ule(c(7, 64), T.mk_add(w, c(1, 64)))],
              [T.mk_ule(c(41, 64), w), T.mk_ule(T.mk_add(w, c(1, 64)), c(30, 64))],
              [T.mk_ule(T.mk_add(w, c(1, 64)), c(30, 64))]]
    cases["one_state"] = I.linearize([bounds[0] + [T.mk_not(
        T.mk_ult(w, c(5, 64)))]])
    cases["many_states"] = I.linearize(
        [bounds[i % 4] for i in range(K5_MANY_STATES)])
    wide = [T.mk_ule(x, c(1000 + i)) for i in range(K5_WIDE)]
    cases["wide_level"] = I.linearize([wide, wide[:7] + [T.mk_ult(x, c(3))]])
    lt, le = T.mk_ult(x, c(5)), T.mk_ule(c(2), y)
    bools = [T.mk_bool_and(lt, p), T.mk_bool_or(le, q), T.mk_not(lt),
             T.mk_bool_xor(p, le), T.mk_bool_ite(q, lt, le),
             T.mk_ule(T.mk_ite(lt, x, y), c(8)),
             T.mk_ult(T.mk_ite(p, c(4), y), c(3))]
    cases["bool_operands"] = I.linearize(
        [bools, bools[:3], [T.mk_ult(x, c(2))] + bools[3:], [p, q]])
    return cases


#: the comparisons of ``k5_edge_plans``' ``staged_wide`` level: its
#: staging (128 bytes a node) past a block's 227 KB of shared memory
K6_STAGED_WIDE = 2048


def k5_edge_plans() -> dict:
    """The propagation plan (``ops/propagate.build_plan``, numpy arrays)
    of each encoding of ``k5_edge_cases``, by name, and ``staged_wide``:
    the edge inputs of K6 (level by level) and K11 (the whole fixpoint),
    which ``chip_smoke.py`` holds to their plain versions.
    ``reads_own_level``'s level 1 reads a row it writes: K6 and K11 stage
    it. ``build_plan`` flags each node's row by indexing with it, which
    ``negative_index``'s ULT node -T - 1 is below, so that case's plan is
    the all-opcode wave's with level 1's nodes and operands and the seed
    slots edited as the encoding's (level 1's row flags those of its
    nodes before the edit, as ``tests/test_torch_k5_edges.py`` edits a
    plan). ``staged_wide``: a level of ``K6_STAGED_WIDE`` comparisons
    over one variable, 2 states, whose first comparison's operand wraps
    onto its second's node (a level that reads a row it writes, staged
    past a block's shared memory, in K6's global buffer)."""
    import numpy as np

    from ..ops import intervals as I
    from ..ops.propagate import build_plan

    cases = k5_edge_cases()
    out = {name: build_plan(enc) for name, enc in cases.items()
           if name != "negative_index"}
    x = T.bv_var("kx", 256)
    wide = [T.mk_ule(x, T.bv_const(5000 + i, 256))
            for i in range(K6_STAGED_WIDE)]
    enc = I.linearize([wide, wide[::-1]])
    n_rows = enc.init_lo.shape[0]
    lv = {k: np.array(v) for k, v in enc.levels[0].items()
          if k != "ops_present"}
    real = np.nonzero(lv["op"] != I.NOP)[0]
    lv["args"][real[0], 0] = int(lv["node"][real[1]]) - n_rows
    lv["ops_present"] = enc.levels[0]["ops_present"]
    out["staged_wide"] = build_plan(_edited(enc, l0=lv))
    neg = cases["negative_index"]
    plan = build_plan(I.linearize(layered_sets()))
    levels = list(plan.arrays["levels"])
    for li, (lv, ed) in enumerate(zip(levels, neg.levels)):
        levels[li] = dict(lv, **{k: np.asarray(ed[k]) for k in (
            "node", "op", "args", "mask", "aux")})
    plan.arrays = dict(plan.arrays, levels=tuple(levels),
                       seed_idx=np.asarray(neg.seed_idx))
    out["negative_index"] = plan
    return out
