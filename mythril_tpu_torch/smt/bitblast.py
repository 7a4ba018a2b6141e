"""Bit-blaster: lowers the word-level term DAG onto the native CDCL core.

Replaces the role z3's internal bit-vector theory plays for the reference
(reference mythril/laser/smt/solver/solver.py delegates everything to z3).
Terms arrive array- and UF-free (the solver facade ackermannizes first,
mythril_tpu_torch/smt/solver/core.py); this module encodes each BV term as a vector
of CNF literals (LSB-first) with constant short-circuiting, so mixed
concrete/symbolic terms only pay for their symbolic cone.

Encoding notes:
- constants are the literals +T / -T of a dedicated always-true variable;
- adders are ripple-carry with Tseitin XOR/MAJ gates;
- mul is schoolbook shift-add (rows with constant-false multiplier bits are
  free, so concrete*symbolic stays linear);
- udiv/urem introduce fresh quotient/remainder vectors constrained via a
  double-width multiply, guarded by the SMT-LIB divide-by-zero semantics;
- sdiv/srem/slt/sle lower through sign-magnitude composition;
- shifts are log-stage barrel shifters with a >=width overflow guard.
"""

from typing import Dict, List, Sequence

from . import terms as T


class Blaster:
    def __init__(self, sat):
        self.sat = sat
        self.T = sat.new_var()
        sat.add_clause([self.T])
        self.F = -self.T
        self._bv: Dict[int, List[int]] = {}
        self._bool: Dict[int, int] = {}
        # structural gate caches: repeated subterms (carry chains,
        # comparison ladders) re-request identical gates constantly
        self._and_cache: Dict[tuple, int] = {}
        self._xor_cache: Dict[tuple, int] = {}
        self._ite_cache: Dict[tuple, int] = {}

    # -- gate layer ---------------------------------------------------------

    def is_true(self, l):
        return l == self.T

    def is_false(self, l):
        return l == self.F

    def new_lit(self):
        return self.sat.new_var()

    def g_not(self, a):
        return -a

    def g_and(self, a, b):
        if self.is_false(a) or self.is_false(b):
            return self.F
        if self.is_true(a):
            return b
        if self.is_true(b):
            return a
        if a == b:
            return a
        if a == -b:
            return self.F
        key = (a, b) if a < b else (b, a)
        v = self._and_cache.get(key)
        if v is not None:
            return v
        v = self.new_lit()
        self.sat.emit_flat((-v, a, 0, -v, b, 0, v, -a, -b, 0))
        self._and_cache[key] = v
        return v

    def g_or(self, a, b):
        return -self.g_and(-a, -b)

    def g_xor(self, a, b):
        if self.is_false(a):
            return b
        if self.is_true(a):
            return -b
        if self.is_false(b):
            return a
        if self.is_true(b):
            return -a
        if a == b:
            return self.F
        if a == -b:
            return self.T
        # canonicalize under XOR symmetries: xor(a,b)=xor(b,a) and
        # xor(-a,b) = -xor(a,b)
        neg = (a < 0) ^ (b < 0)
        a_c, b_c = abs(a), abs(b)
        key = (a_c, b_c) if a_c < b_c else (b_c, a_c)
        v = self._xor_cache.get(key)
        if v is None:
            a_p, b_p = key
            v = self.new_lit()
            self.sat.emit_flat(
                (-v, a_p, b_p, 0, -v, -a_p, -b_p, 0,
                 v, a_p, -b_p, 0, v, -a_p, b_p, 0)
            )
            self._xor_cache[key] = v
        return -v if neg else v

    def g_ite(self, c, a, b):
        if self.is_true(c):
            return a
        if self.is_false(c):
            return b
        if a == b:
            return a
        if self.is_true(a) and self.is_false(b):
            return c
        if self.is_false(a) and self.is_true(b):
            return -c
        key = (c, a, b)
        v = self._ite_cache.get(key)
        if v is not None:
            return v
        v = self.new_lit()
        self.sat.emit_flat(
            (-v, -c, a, 0, v, -c, -a, 0, -v, c, b, 0, v, c, -b, 0)
        )
        self._ite_cache[key] = v
        return v

    def g_and_many(self, lits):
        acc = self.T
        for l in lits:
            acc = self.g_and(acc, l)
        return acc

    def g_or_many(self, lits):
        acc = self.F
        for l in lits:
            acc = self.g_or(acc, l)
        return acc

    def full_adder(self, a, b, c):
        s = self.g_xor(self.g_xor(a, b), c)
        carry = self.g_or(self.g_and(a, b), self.g_and(c, self.g_xor(a, b)))
        return s, carry

    # -- word layer ---------------------------------------------------------

    def const_bits(self, value: int, width: int) -> List[int]:
        return [self.T if (value >> i) & 1 else self.F for i in range(width)]

    def fresh_bits(self, width: int) -> List[int]:
        return [self.new_lit() for _ in range(width)]

    def add_vec(self, a, b, cin=None):
        cin = self.F if cin is None else cin
        out = []
        c = cin
        for ai, bi in zip(a, b):
            s, c = self.full_adder(ai, bi, c)
            out.append(s)
        return out, c

    def sub_vec(self, a, b):
        nb = [-x for x in b]
        out, _ = self.add_vec(a, nb, self.T)
        return out

    def neg_vec(self, a):
        out, _ = self.add_vec([-x for x in a], self.const_bits(0, len(a)),
                              self.T)
        return out

    def mul_vec(self, a, b):
        w = len(a)
        acc = self.const_bits(0, w)
        for i in range(w):
            ai = a[i]
            if self.is_false(ai):
                continue
            row = [self.F] * i + [self.g_and(ai, b[j]) for j in range(w - i)]
            acc, _ = self.add_vec(acc, row)
        return acc

    def mul_vec_ext(self, a, b):
        """Full 2w-bit product (for division soundness)."""
        w = len(a)
        az = a + [self.F] * w
        acc = self.const_bits(0, 2 * w)
        for i in range(w):
            bi = b[i]
            if self.is_false(bi):
                continue
            row = [self.F] * i + [self.g_and(bi, az[j]) for j in range(2 * w - i)]
            acc, _ = self.add_vec(acc, row)
        return acc

    def eq_vec(self, a, b):
        return self.g_and_many(
            [-self.g_xor(x, y) for x, y in zip(a, b)]
        )

    def ult_vec(self, a, b):
        lt = self.F
        for ai, bi in zip(a, b):  # LSB to MSB; MSB decides last
            eq = -self.g_xor(ai, bi)
            lt_here = self.g_and(-ai, bi)
            lt = self.g_or(lt_here, self.g_and(eq, lt))
        return lt

    def slt_vec(self, a, b):
        # flip sign bits and compare unsigned
        a2 = a[:-1] + [-a[-1]]
        b2 = b[:-1] + [-b[-1]]
        return self.ult_vec(a2, b2)

    def shift_vec(self, a, amt, kind: str):
        """kind in {'shl','lshr','ashr'}; barrel shifter."""
        w = len(a)
        fill = a[-1] if kind == "ashr" else self.F
        cur = list(a)
        stages = 0
        while (1 << stages) < w:
            stages += 1
        for s in range(stages):
            sh = 1 << s
            sel = amt[s] if s < len(amt) else self.F
            nxt = []
            for i in range(w):
                if kind == "shl":
                    src = cur[i - sh] if i - sh >= 0 else self.F
                else:
                    src = cur[i + sh] if i + sh < w else fill
                nxt.append(self.g_ite(sel, src, cur[i]))
            cur = nxt
        # amount >= w (or any high amount bit set) -> fill
        high = self.g_or_many(amt[stages:])
        if (1 << stages) != w:
            # non-power-of-two width: also catch amounts in [w, 2^stages)
            wconst = self.const_bits(w, len(amt))
            high = self.g_or(high, -self.ult_vec(amt, wconst))
        return [self.g_ite(high, fill, x) for x in cur]

    def ite_vec(self, c, a, b):
        return [self.g_ite(c, x, y) for x, y in zip(a, b)]

    # -- term dispatch ------------------------------------------------------

    def bool_lit(self, t: "T.Term") -> int:
        r = self._bool.get(t.tid)
        if r is not None:
            return r
        op = t.op
        if op == T.TRUE:
            v = self.T
        elif op == T.FALSE:
            v = self.F
        elif op == T.BOOL_VAR:
            v = self.new_lit()
        elif op == T.EQ:
            if t.args[0].is_bool:
                v = -self.g_xor(
                    self.bool_lit(t.args[0]), self.bool_lit(t.args[1])
                )
            else:
                v = self.eq_vec(
                    self.bits(t.args[0]), self.bits(t.args[1])
                )
        elif op == T.ULT:
            v = self.ult_vec(self.bits(t.args[0]), self.bits(t.args[1]))
        elif op == T.ULE:
            v = -self.ult_vec(self.bits(t.args[1]), self.bits(t.args[0]))
        elif op == T.SLT:
            v = self.slt_vec(self.bits(t.args[0]), self.bits(t.args[1]))
        elif op == T.SLE:
            v = -self.slt_vec(self.bits(t.args[1]), self.bits(t.args[0]))
        elif op == T.AND:
            v = self.g_and_many([self.bool_lit(a) for a in t.args])
        elif op == T.OR:
            v = self.g_or_many([self.bool_lit(a) for a in t.args])
        elif op == T.NOT:
            v = -self.bool_lit(t.args[0])
        elif op == T.XOR:
            v = self.g_xor(self.bool_lit(t.args[0]), self.bool_lit(t.args[1]))
        elif op == T.BOOL_ITE:
            v = self.g_ite(
                self.bool_lit(t.args[0]),
                self.bool_lit(t.args[1]),
                self.bool_lit(t.args[2]),
            )
        else:
            raise NotImplementedError(f"bool op {op}")
        self._bool[t.tid] = v
        return v

    def bits(self, t: "T.Term") -> List[int]:
        r = self._bv.get(t.tid)
        if r is not None:
            return r
        op = t.op
        w = t.width
        if op == T.BV_CONST:
            v = self.const_bits(t.val, w)
        elif op == T.BV_VAR:
            v = self.fresh_bits(w)
        elif op == T.ADD:
            v, _ = self.add_vec(self.bits(t.args[0]), self.bits(t.args[1]))
        elif op == T.SUB:
            v = self.sub_vec(self.bits(t.args[0]), self.bits(t.args[1]))
        elif op == T.MUL:
            v = self.mul_vec(self.bits(t.args[0]), self.bits(t.args[1]))
        elif op in (T.UDIV, T.UREM):
            v = self._divmod(t)
        elif op in (T.SDIV, T.SREM):
            v = self._signed_divmod(t)
        elif op == T.BAND:
            v = [
                self.g_and(x, y)
                for x, y in zip(self.bits(t.args[0]), self.bits(t.args[1]))
            ]
        elif op == T.BOR:
            v = [
                self.g_or(x, y)
                for x, y in zip(self.bits(t.args[0]), self.bits(t.args[1]))
            ]
        elif op == T.BXOR:
            v = [
                self.g_xor(x, y)
                for x, y in zip(self.bits(t.args[0]), self.bits(t.args[1]))
            ]
        elif op == T.BNOT:
            v = [-x for x in self.bits(t.args[0])]
        elif op == T.NEG:
            v = self.neg_vec(self.bits(t.args[0]))
        elif op == T.SHL:
            v = self.shift_vec(self.bits(t.args[0]), self.bits(t.args[1]),
                               "shl")
        elif op == T.LSHR:
            v = self.shift_vec(self.bits(t.args[0]), self.bits(t.args[1]),
                               "lshr")
        elif op == T.ASHR:
            v = self.shift_vec(self.bits(t.args[0]), self.bits(t.args[1]),
                               "ashr")
        elif op == T.CONCAT:
            v = []
            for part in reversed(t.args):  # LSB-side part is the last arg
                v.extend(self.bits(part))
        elif op == T.EXTRACT:
            hi, lo = t.params
            v = self.bits(t.args[0])[lo : hi + 1]
        elif op == T.ZEXT:
            v = self.bits(t.args[0]) + [self.F] * t.params[0]
        elif op == T.SEXT:
            inner = self.bits(t.args[0])
            v = inner + [inner[-1]] * t.params[0]
        elif op == T.ITE:
            v = self.ite_vec(
                self.bool_lit(t.args[0]),
                self.bits(t.args[1]),
                self.bits(t.args[2]),
            )
        else:
            raise NotImplementedError(f"bv op {op} (arrays/UF must be "
                                      "eliminated before blasting)")
        self._bv[t.tid] = v
        return v

    def _divmod(self, t):
        n = self.bits(t.args[0])
        d = self.bits(t.args[1])
        w = len(n)
        # cache by the (n, d) pair so udiv and urem share the circuit
        key = ("divmod", t.args[0].tid, t.args[1].tid)
        cached = self._bv.get(key)  # type: ignore[arg-type]
        if cached is None:
            q = self.fresh_bits(w)
            r = self.fresh_bits(w)
            dz = self.eq_vec(d, self.const_bits(0, w))
            prod = self.mul_vec_ext(q, d)
            total, carry = self.add_vec(prod[:w], r)
            high_zero = self.g_and_many([-x for x in prod[w:]] + [-carry])
            sum_eq = self.eq_vec(total, n)
            r_lt_d = self.ult_vec(r, d)
            valid = self.g_and_many([high_zero, sum_eq, r_lt_d])
            self.sat.add_clause([dz, valid])
            qf = self.ite_vec(dz, self.const_bits((1 << w) - 1, w), q)
            rf = self.ite_vec(dz, n, r)
            cached = (qf, rf)
            self._bv[key] = cached  # type: ignore[index]
        return cached[0] if t.op == T.UDIV else cached[1]

    def _signed_divmod(self, t):
        a = self.bits(t.args[0])
        b = self.bits(t.args[1])
        w = len(a)
        sa, sb = a[-1], b[-1]
        abs_a = self.ite_vec(sa, self.neg_vec(a), a)
        abs_b = self.ite_vec(sb, self.neg_vec(b), b)
        # reuse unsigned circuit on the magnitude terms via direct vectors
        q = self.fresh_bits(w)
        r = self.fresh_bits(w)
        dz = self.eq_vec(abs_b, self.const_bits(0, w))
        prod = self.mul_vec_ext(q, abs_b)
        total, carry = self.add_vec(prod[:w], r)
        high_zero = self.g_and_many([-x for x in prod[w:]] + [-carry])
        sum_eq = self.eq_vec(total, abs_a)
        r_lt_d = self.ult_vec(r, abs_b)
        valid = self.g_and_many([high_zero, sum_eq, r_lt_d])
        self.sat.add_clause([dz, valid])
        ones = self.const_bits((1 << w) - 1, w)
        q_dz = self.ite_vec(sa, self.const_bits(1, w), ones)  # sdiv by 0
        uq = self.ite_vec(dz, ones, q)
        ur = self.ite_vec(dz, abs_a, r)
        if t.op == T.SDIV:
            signed_q = self.ite_vec(self.g_xor(sa, sb), self.neg_vec(uq), uq)
            return self.ite_vec(dz, q_dz, signed_q)
        signed_r = self.ite_vec(sa, self.neg_vec(ur), ur)
        return signed_r

    # -- top level ----------------------------------------------------------

    def _ensure_blasted(self, t: "T.Term") -> None:
        """Iterative post-order pre-pass so the recursive bits()/bool_lit()
        dispatch only ever recurses one level (deep EVM term chains exceed
        Python's recursion limit otherwise)."""
        done = set()
        stack = [t]
        while stack:
            cur = stack[-1]
            if cur.tid in done:
                stack.pop()
                continue
            pending = [a for a in cur.args if a.tid not in done]
            if pending:
                stack.extend(pending)
                continue
            stack.pop()
            done.add(cur.tid)
            if cur.is_array:
                continue
            if cur.is_bool:
                self.bool_lit(cur)
            else:
                self.bits(cur)

    def assert_term(self, t: "T.Term") -> None:
        """Assert a Bool term as a unit constraint."""
        if t.op == T.AND:
            for a in t.args:
                self.assert_term(a)
            return
        self._ensure_blasted(t)
        self.sat.add_clause([self.bool_lit(t)])

    def model_value(self, t: "T.Term") -> int:
        """Read a blasted term's value from the SAT model (term must have
        been blasted)."""
        if t.is_bool:
            l = self._bool.get(t.tid)
            if l is None:
                return 0
            return 1 if self._lit_val(l) else 0
        bits = self._bv.get(t.tid)
        if bits is None:
            return 0
        v = 0
        for i, l in enumerate(bits):
            if self._lit_val(l):
                v |= 1 << i
        return v

    def _lit_val(self, l: int) -> bool:
        val = self.sat.value(abs(l))
        return val if l > 0 else (not val)


# ---------------------------------------------------------------------------
# native term-tape blaster
# ---------------------------------------------------------------------------

# tape opcodes (keep in sync with mythril_tpu_torch/native/blaster.cpp TapeOp)
(TP_CONST, TP_VAR, TP_ADD, TP_SUB, TP_MUL, TP_UDIV, TP_UREM, TP_SDIV,
 TP_SREM, TP_BAND, TP_BOR, TP_BXOR, TP_BNOT, TP_NEG, TP_SHL, TP_LSHR,
 TP_ASHR, TP_CONCAT, TP_EXTRACT, TP_ZEXT, TP_SEXT, TP_ITE) = range(1, 23)
TP_TRUE, TP_FALSE, TP_BOOLVAR, TP_EQ_BV, TP_EQ_BOOL, TP_ULT, TP_ULE, \
    TP_SLT, TP_SLE, TP_AND_B, TP_OR_B, TP_NOT_B, TP_XOR_B, TP_BITE = \
    range(30, 44)
TP_ASSERT = 50

_BV_BINOP = {
    T.ADD: TP_ADD, T.SUB: TP_SUB, T.MUL: TP_MUL, T.UDIV: TP_UDIV,
    T.UREM: TP_UREM, T.SDIV: TP_SDIV, T.SREM: TP_SREM, T.BAND: TP_BAND,
    T.BOR: TP_BOR, T.BXOR: TP_BXOR, T.SHL: TP_SHL, T.LSHR: TP_LSHR,
    T.ASHR: TP_ASHR,
}
_BOOL_CMP = {T.ULT: TP_ULT, T.ULE: TP_ULE, T.SLT: TP_SLT, T.SLE: TP_SLE}


class NativeBlaster:
    """Drop-in replacement for Blaster executing the word-level encoding
    in C++ (native/blaster.cpp). The tape is a faithful serialization of
    the same post-order walk Blaster._ensure_blasted performs, and the
    C++ side is a gate-for-gate port, so the emitted CNF stream — and
    therefore the CDCL search, results and models — is identical to the
    Python blaster's. Per-gate Python overhead (the dominant solver-side
    cost) collapses into one FFI crossing per assertion batch.

    `_bv`/`_bool` are membership maps (tid -> True) kept for the model
    extractor's scope filtering; literal vectors live in C++."""

    def __init__(self, sat):
        import ctypes

        from ..native import get_lib

        self.sat = sat
        self._lib = get_lib()
        self._nv = ctypes.c_int64(sat.nvars)
        # creation order parity: Python Blaster buffers [T] before any
        # other clause — flush pending clauses, then let C++ emit
        sat.flush()
        self.T = sat.nvars + 1  # the var the C++ side allocates first
        self._h = self._lib.mtpu_blaster_new(
            sat._h, ctypes.byref(self._nv))
        sat.nvars = self._nv.value
        self.F = -self.T
        self._bv: Dict[int, bool] = {}
        self._bool: Dict[int, bool] = {}
        self._bool_lits: Dict[int, int] = {}
        self._pending_bv: List[int] = []
        self._pending_bool: List[int] = []
        self._ctypes = ctypes

    def __del__(self):
        try:
            if self._h:
                self._lib.mtpu_blaster_free(self._h)
                self._h = None
        except Exception:
            pass

    # -- tape construction --------------------------------------------------

    def _append_term(self, tape, t):
        op = t.op
        tid = t.tid
        if t.is_bool:
            if op == T.TRUE:
                tape += (TP_TRUE, tid)
            elif op == T.FALSE:
                tape += (TP_FALSE, tid)
            elif op == T.BOOL_VAR:
                tape += (TP_BOOLVAR, tid)
            elif op == T.EQ:
                if t.args[0].is_array or t.args[1].is_array:
                    # parity with Blaster.bool_lit -> eq_vec -> bits():
                    # array terms cannot be blasted; raising here keeps
                    # the tape free of undefined operand references
                    raise NotImplementedError(
                        "array equality must be eliminated before "
                        "blasting")
                if t.args[0].is_bool:
                    tape += (TP_EQ_BOOL, tid, t.args[0].tid,
                             t.args[1].tid)
                else:
                    tape += (TP_EQ_BV, tid, t.args[0].tid, t.args[1].tid)
            elif op in _BOOL_CMP:
                tape += (_BOOL_CMP[op], tid, t.args[0].tid,
                         t.args[1].tid)
            elif op == T.AND:
                tape += (TP_AND_B, tid, len(t.args))
                tape += tuple(a.tid for a in t.args)
            elif op == T.OR:
                tape += (TP_OR_B, tid, len(t.args))
                tape += tuple(a.tid for a in t.args)
            elif op == T.NOT:
                tape += (TP_NOT_B, tid, t.args[0].tid)
            elif op == T.XOR:
                tape += (TP_XOR_B, tid, t.args[0].tid, t.args[1].tid)
            elif op == T.BOOL_ITE:
                tape += (TP_BITE, tid, t.args[0].tid, t.args[1].tid,
                         t.args[2].tid)
            else:
                raise NotImplementedError(f"bool op {op}")
            self._pending_bool.append(tid)
            return
        w = t.width
        if op == T.BV_CONST:
            nwords = (w + 31) // 32
            tape += (TP_CONST, tid, w, nwords)
            v = t.val
            tape += tuple((v >> (32 * i)) & 0xFFFFFFFF
                          for i in range(nwords))
        elif op == T.BV_VAR:
            tape += (TP_VAR, tid, w)
        elif op in _BV_BINOP:
            tape += (_BV_BINOP[op], tid, w, t.args[0].tid, t.args[1].tid)
        elif op == T.BNOT:
            tape += (TP_BNOT, tid, w, t.args[0].tid)
        elif op == T.NEG:
            tape += (TP_NEG, tid, w, t.args[0].tid)
        elif op == T.CONCAT:
            tape += (TP_CONCAT, tid, w, len(t.args))
            tape += tuple(a.tid for a in t.args)
        elif op == T.EXTRACT:
            hi, lo = t.params
            tape += (TP_EXTRACT, tid, w, t.args[0].tid, hi, lo)
        elif op == T.ZEXT:
            tape += (TP_ZEXT, tid, w, t.args[0].tid, t.params[0])
        elif op == T.SEXT:
            tape += (TP_SEXT, tid, w, t.args[0].tid, t.params[0])
        elif op == T.ITE:
            tape += (TP_ITE, tid, w, t.args[0].tid, t.args[1].tid,
                     t.args[2].tid)
        else:
            raise NotImplementedError(
                f"bv op {op} (arrays/UF must be eliminated before "
                "blasting)")
        self._pending_bv.append(tid)

    def _tape_for(self, t, tape):
        """Append post-order entries for t's not-yet-blasted cone (the
        same walk as Blaster._ensure_blasted). Terms are only marked
        blasted after the tape EXECUTES successfully (_exec) — a
        NotImplementedError mid-serialization must not poison the
        session with marked-but-never-blasted tids."""
        self._pending_bv.clear()
        self._pending_bool.clear()
        known_bv, known_bool = self._bv, self._bool
        stack = [t]
        done = set()
        while stack:
            cur = stack[-1]
            tid = cur.tid
            if tid in done or tid in known_bv or tid in known_bool:
                stack.pop()
                continue
            if cur.is_array:
                done.add(tid)
                stack.pop()
                continue
            pending = [
                a for a in cur.args
                if a.tid not in done and a.tid not in known_bv
                and a.tid not in known_bool
            ]
            if pending:
                stack.extend(pending)
                continue
            stack.pop()
            done.add(tid)
            if not cur.is_array:
                self._append_term(tape, cur)

    def _exec(self, tape):
        import array

        self._snap = None  # any new tape invalidates a model snapshot
        if not tape:
            self._pending_bv.clear()
            self._pending_bool.clear()
            return
        ct = self._ctypes
        buf = array.array("i", [x - (1 << 32) if x >= (1 << 31) else x
                                for x in tape])
        addr, n = buf.buffer_info()
        # clause-order parity: earlier Python-side adds go first
        self.sat.flush()
        self._nv.value = self.sat.nvars
        r = self._lib.mtpu_blaster_exec(
            self._h, ct.cast(addr, ct.POINTER(ct.c_int32)), n,
            ct.byref(self._nv))
        self.sat.nvars = self._nv.value
        if r == -2:
            self._pending_bv.clear()
            self._pending_bool.clear()
            raise RuntimeError("malformed blaster tape")
        # success (or latched-unsat): the tape's terms are now blasted
        for tid in self._pending_bv:
            self._bv[tid] = True
        for tid in self._pending_bool:
            self._bool[tid] = True
        self._pending_bv.clear()
        self._pending_bool.clear()
        if r == -1:
            self.sat._latched_unsat = True

    # -- Blaster-compatible interface ----------------------------------------

    def _ensure_blasted(self, t) -> None:
        tape = []
        self._tape_for(t, tape)
        self._exec(tape)

    def bool_lit(self, t) -> int:
        lit = self._bool_lits.get(t.tid)
        if lit is not None:
            return lit
        if t.tid not in self._bool:
            self._ensure_blasted(t)
        lit = self._lib.mtpu_blaster_bool_lit(self._h, t.tid)
        assert lit != 0, f"term {t.tid} not blasted"
        self._bool_lits[t.tid] = lit
        return lit

    def bits(self, t) -> List[int]:
        if t.tid not in self._bv:
            self._ensure_blasted(t)
        ct = self._ctypes
        cap = 1024
        while True:
            out = (ct.c_int32 * cap)()
            w = self._lib.mtpu_blaster_get_bits(self._h, t.tid, out,
                                                cap)
            assert w >= 0, f"term {t.tid} not blasted"
            if w <= cap:
                return list(out[:w])
            cap = w  # wide concats (e.g. long keccak inputs): retry

    def assert_term(self, t) -> None:
        if t.op == T.AND:
            for a in t.args:
                self.assert_term(a)
            return
        tape = []
        self._tape_for(t, tape)
        tape.append(TP_ASSERT)
        tape.append(t.tid)
        self._exec(tape)

    def snapshot_model(self) -> None:
        """Capture the full SAT assignment in one native call; later
        model_value calls read the snapshot instead of crossing the FFI
        per word. The extractor clears it under try/finally, and _exec
        defensively invalidates on any new tape execution."""
        self._snap = self.sat.assignment_snapshot()

    def model_value(self, t) -> int:
        if t.is_bool:
            if t.tid not in self._bool:
                return 0
            return 1 if self._lit_val(self.bool_lit(t)) else 0
        if t.tid not in self._bv:
            return 0
        lits = self.bits(t)
        snap = getattr(self, "_snap", None)
        v = 0
        if snap is not None:
            ns = len(snap)
            for i, l in enumerate(lits):
                var = (l if l > 0 else -l) - 1
                va = snap[var] if 0 <= var < ns else -1
                # unassigned (-1) mirrors _lit_val: False for positive
                # literals, True for negated ones
                if (va == 1) if l > 0 else (va != 1):
                    v |= 1 << i
            return v
        vals = self.sat.values_bulk(lits)  # one native call per word
        if vals is None:  # stale library without the bulk symbol
            for i, l in enumerate(lits):
                if self._lit_val(l):
                    v |= 1 << i
            return v
        for i in range(len(lits)):
            # C reports lit truth when assigned, -1 when not; unassigned
            # negated literals count as true (_lit_val parity)
            if vals[i] == 1 or (vals[i] == -1 and lits[i] < 0):
                v |= 1 << i
        return v

    def _lit_val(self, l: int) -> bool:
        val = self.sat.value(abs(l))
        return val if l > 0 else (not val)

    # gate-level helpers the Optimize binary search uses
    def is_true(self, l) -> bool:
        return l == self.T

    def is_false(self, l) -> bool:
        return l == self.F

    def const_bits(self, value: int, width: int) -> List[int]:
        return [self.T if (value >> i) & 1 else self.F
                for i in range(width)]

    def ult_vec(self, a, b) -> int:
        ct = self._ctypes
        n = min(len(a), len(b))
        aa = (ct.c_int32 * n)(*a[:n])
        bb = (ct.c_int32 * n)(*b[:n])
        self.sat.flush()
        self._nv.value = self.sat.nvars
        lit = self._lib.mtpu_blaster_ult(
            self._h, aa, bb, n, ct.byref(self._nv))
        self.sat.nvars = self._nv.value
        return lit


import os as _os

_FORCE_PY = _os.environ.get("MTPU_PY_BLASTER") == "1"
_native_ok = None


def make_blaster(sat):
    """Native term-tape blaster when the shared library is available,
    Python fallback otherwise (or with MTPU_PY_BLASTER=1)."""
    global _native_ok
    if _FORCE_PY:
        return Blaster(sat)
    if _native_ok is None:
        try:
            from ..native import get_lib

            lib = get_lib()
            _native_ok = hasattr(lib, "mtpu_blaster_new")
        except Exception:
            _native_ok = False
    return NativeBlaster(sat) if _native_ok else Blaster(sat)
