// Native term-tape bit-blaster: executes a serialized term DAG and emits
// Tseitin CNF straight into the in-process CDCL core.
//
// This is a faithful C++ port of the Python reference implementation in
// mythril_tpu/smt/bitblast.py (class Blaster) — gate for gate, clause for
// clause, variable-allocation order included — so the emitted CNF stream
// is bit-identical and the CDCL search (hence results, models, stats)
// matches the Python blaster exactly. The Python side serializes only
// not-yet-blasted terms in post-order (NativeBlaster._ensure_blasted) and
// ships them through one FFI crossing; per-gate Python overhead (the
// dominant solver-side cost on analysis workloads) disappears.

#include <cstdint>
#include <cstring>
#include <unordered_map>
#include <vector>

extern "C" int32_t mtpu_sat_add_clauses(void* sp, const int32_t* stream,
                                        int32_t n);

namespace {

// tape opcodes (keep in sync with mythril_tpu/smt/bitblast.py TAPE_*)
enum TapeOp : int32_t {
  TP_CONST = 1,   // tid, width, nwords, words...
  TP_VAR = 2,     // tid, width
  TP_ADD = 3,     // tid, width, a, b
  TP_SUB = 4,
  TP_MUL = 5,
  TP_UDIV = 6,
  TP_UREM = 7,
  TP_SDIV = 8,
  TP_SREM = 9,
  TP_BAND = 10,
  TP_BOR = 11,
  TP_BXOR = 12,
  TP_BNOT = 13,   // tid, width, a
  TP_NEG = 14,
  TP_SHL = 15,
  TP_LSHR = 16,
  TP_ASHR = 17,
  TP_CONCAT = 18, // tid, width, nargs, args... (MSB-side first)
  TP_EXTRACT = 19, // tid, width, a, hi, lo
  TP_ZEXT = 20,   // tid, width, a, ext
  TP_SEXT = 21,   // tid, width, a, ext
  TP_ITE = 22,    // tid, width, c, a, b
  TP_TRUE = 30,   // tid
  TP_FALSE = 31,
  TP_BOOLVAR = 32,
  TP_EQ_BV = 33,  // tid, a, b
  TP_EQ_BOOL = 34,
  TP_ULT = 35,
  TP_ULE = 36,
  TP_SLT = 37,
  TP_SLE = 38,
  TP_AND_B = 39,  // tid, nargs, args...
  TP_OR_B = 40,
  TP_NOT_B = 41,  // tid, a
  TP_XOR_B = 42,  // tid, a, b
  TP_BITE = 43,   // tid, c, a, b
  TP_ASSERT = 50, // tid (bool): unit clause
};

struct Key3 {
  int32_t a, b, c;
  bool operator==(const Key3& o) const {
    return a == o.a && b == o.b && c == o.c;
  }
};
struct Key3Hash {
  size_t operator()(const Key3& k) const {
    uint64_t h = (uint64_t)(uint32_t)k.a;
    h = h * 1000003u ^ (uint32_t)k.b;
    h = h * 1000003u ^ (uint32_t)k.c;
    return (size_t)h;
  }
};

typedef std::vector<int32_t> Vec;

struct Blaster {
  void* sat;
  int32_t T, F;
  int64_t nvars;
  bool latched_unsat = false;
  bool bad = false;  // malformed tape (missing operand tid)
  std::unordered_map<int64_t, Vec> bv;
  std::unordered_map<int64_t, int32_t> bools;
  std::unordered_map<uint64_t, int32_t> and_cache;
  std::unordered_map<uint64_t, int32_t> xor_cache;
  std::unordered_map<Key3, int32_t, Key3Hash> ite_cache;
  std::unordered_map<uint64_t, std::pair<Vec, Vec>> divmod_cache;
  std::vector<int32_t> cbuf;  // pending clause stream (0-terminated)

  int32_t new_lit() { return (int32_t)++nvars; }

  // checked operand lookups: a tid the tape never defined is a
  // serialization bug — fail the tape instead of fabricating an empty
  // vector (eq over empty vectors would be trivially true)
  const Vec& getbv(int32_t tid) {
    static const Vec empty;
    auto it = bv.find(tid);
    if (it == bv.end()) {
      bad = true;
      return empty;
    }
    return it->second;
  }

  int32_t getbool(int32_t tid) {
    auto it = bools.find(tid);
    if (it == bools.end()) {
      bad = true;
      return T;  // placeholder; exec aborts on `bad`
    }
    return it->second;
  }

  void emit(std::initializer_list<int32_t> lits) {
    cbuf.insert(cbuf.end(), lits);
  }

  bool flush() {
    if (latched_unsat) return false;
    if (cbuf.empty()) return true;
    int32_t r = mtpu_sat_add_clauses(sat, cbuf.data(),
                                     (int32_t)cbuf.size());
    cbuf.clear();
    if (r < 0) {
      latched_unsat = true;
      return false;
    }
    return true;
  }

  bool is_true(int32_t l) const { return l == T; }
  bool is_false(int32_t l) const { return l == F; }

  int32_t g_and(int32_t a, int32_t b) {
    if (is_false(a) || is_false(b)) return F;
    if (is_true(a)) return b;
    if (is_true(b)) return a;
    if (a == b) return a;
    if (a == -b) return F;
    int32_t x = a < b ? a : b, y = a < b ? b : a;
    uint64_t key = ((uint64_t)(uint32_t)x << 32) | (uint32_t)y;
    auto it = and_cache.find(key);
    if (it != and_cache.end()) return it->second;
    int32_t v = new_lit();
    emit({-v, a, 0, -v, b, 0, v, -a, -b, 0});
    and_cache.emplace(key, v);
    return v;
  }

  int32_t g_or(int32_t a, int32_t b) { return -g_and(-a, -b); }

  int32_t g_xor(int32_t a, int32_t b) {
    if (is_false(a)) return b;
    if (is_true(a)) return -b;
    if (is_false(b)) return a;
    if (is_true(b)) return -a;
    if (a == b) return F;
    if (a == -b) return T;
    bool neg = (a < 0) ^ (b < 0);
    int32_t ac = a < 0 ? -a : a, bc = b < 0 ? -b : b;
    int32_t x = ac < bc ? ac : bc, y = ac < bc ? bc : ac;
    uint64_t key = ((uint64_t)(uint32_t)x << 32) | (uint32_t)y;
    int32_t v;
    auto it = xor_cache.find(key);
    if (it != xor_cache.end()) {
      v = it->second;
    } else {
      v = new_lit();
      emit({-v, x, y, 0, -v, -x, -y, 0, v, x, -y, 0, v, -x, y, 0});
      xor_cache.emplace(key, v);
    }
    return neg ? -v : v;
  }

  int32_t g_ite(int32_t c, int32_t a, int32_t b) {
    if (is_true(c)) return a;
    if (is_false(c)) return b;
    if (a == b) return a;
    if (is_true(a) && is_false(b)) return c;
    if (is_false(a) && is_true(b)) return -c;
    Key3 key{c, a, b};
    auto it = ite_cache.find(key);
    if (it != ite_cache.end()) return it->second;
    int32_t v = new_lit();
    emit({-v, -c, a, 0, v, -c, -a, 0, -v, c, b, 0, v, c, -b, 0});
    ite_cache.emplace(key, v);
    return v;
  }

  int32_t g_and_many(const Vec& lits) {
    int32_t acc = T;
    for (int32_t l : lits) acc = g_and(acc, l);
    return acc;
  }

  int32_t g_or_many(const Vec& lits) {
    int32_t acc = F;
    for (int32_t l : lits) acc = g_or(acc, l);
    return acc;
  }

  void full_adder(int32_t a, int32_t b, int32_t c, int32_t& s,
                  int32_t& carry) {
    s = g_xor(g_xor(a, b), c);
    carry = g_or(g_and(a, b), g_and(c, g_xor(a, b)));
  }

  Vec const_bits_words(const int32_t* words, int32_t width) {
    Vec out((size_t)width);
    for (int32_t i = 0; i < width; ++i) {
      uint32_t w = (uint32_t)words[i / 32];
      out[(size_t)i] = (w >> (i % 32)) & 1 ? T : F;
    }
    return out;
  }

  Vec const_bits_val(uint64_t value, int32_t width) {
    Vec out((size_t)width);
    for (int32_t i = 0; i < width; ++i)
      out[(size_t)i] = (i < 64 && ((value >> i) & 1)) ? T : F;
    return out;
  }

  Vec fresh_bits(int32_t width) {
    Vec out((size_t)width);
    for (int32_t i = 0; i < width; ++i) out[(size_t)i] = new_lit();
    return out;
  }

  Vec add_vec(const Vec& a, const Vec& b, int32_t cin, int32_t* cout) {
    Vec out;
    out.reserve(a.size());
    int32_t c = cin;
    for (size_t i = 0; i < a.size() && i < b.size(); ++i) {
      int32_t s;
      full_adder(a[i], b[i], c, s, c);
      out.push_back(s);
    }
    if (cout) *cout = c;
    return out;
  }

  Vec sub_vec(const Vec& a, const Vec& b) {
    Vec nb(b.size());
    for (size_t i = 0; i < b.size(); ++i) nb[i] = -b[i];
    return add_vec(a, nb, T, nullptr);
  }

  Vec neg_vec(const Vec& a) {
    Vec na(a.size());
    for (size_t i = 0; i < a.size(); ++i) na[i] = -a[i];
    Vec zero = const_bits_val(0, (int32_t)a.size());
    return add_vec(na, zero, T, nullptr);
  }

  Vec mul_vec(const Vec& a, const Vec& b) {
    size_t w = a.size();
    Vec acc = const_bits_val(0, (int32_t)w);
    for (size_t i = 0; i < w; ++i) {
      int32_t ai = a[i];
      if (is_false(ai)) continue;
      Vec row;
      row.reserve(w);
      for (size_t j = 0; j < i; ++j) row.push_back(F);
      for (size_t j = 0; j < w - i; ++j) row.push_back(g_and(ai, b[j]));
      acc = add_vec(acc, row, F, nullptr);
    }
    return acc;
  }

  Vec mul_vec_ext(const Vec& a, const Vec& b) {
    size_t w = a.size();
    Vec az = a;
    az.resize(2 * w, F);
    Vec acc = const_bits_val(0, (int32_t)(2 * w));
    for (size_t i = 0; i < w; ++i) {
      int32_t bi = b[i];
      if (is_false(bi)) continue;
      Vec row;
      row.reserve(2 * w);
      for (size_t j = 0; j < i; ++j) row.push_back(F);
      for (size_t j = 0; j < 2 * w - i; ++j)
        row.push_back(g_and(bi, az[j]));
      acc = add_vec(acc, row, F, nullptr);
    }
    return acc;
  }

  int32_t eq_vec(const Vec& a, const Vec& b) {
    Vec parts;
    parts.reserve(a.size());
    for (size_t i = 0; i < a.size() && i < b.size(); ++i)
      parts.push_back(-g_xor(a[i], b[i]));
    return g_and_many(parts);
  }

  int32_t ult_vec(const Vec& a, const Vec& b) {
    int32_t lt = F;
    for (size_t i = 0; i < a.size() && i < b.size(); ++i) {
      int32_t eq = -g_xor(a[i], b[i]);
      int32_t lt_here = g_and(-a[i], b[i]);
      lt = g_or(lt_here, g_and(eq, lt));
    }
    return lt;
  }

  int32_t slt_vec(const Vec& a, const Vec& b) {
    Vec a2 = a, b2 = b;
    a2.back() = -a2.back();
    b2.back() = -b2.back();
    return ult_vec(a2, b2);
  }

  // kind: 0 = shl, 1 = lshr, 2 = ashr
  Vec shift_vec(const Vec& a, const Vec& amt, int kind) {
    size_t w = a.size();
    int32_t fill = kind == 2 ? a.back() : F;
    Vec cur = a;
    int stages = 0;
    while (((size_t)1 << stages) < w) ++stages;
    for (int s = 0; s < stages; ++s) {
      size_t sh = (size_t)1 << s;
      int32_t sel = (size_t)s < amt.size() ? amt[(size_t)s] : F;
      Vec nxt((size_t)w);
      for (size_t i = 0; i < w; ++i) {
        int32_t src;
        if (kind == 0)
          src = i >= sh ? cur[i - sh] : F;
        else
          src = i + sh < w ? cur[i + sh] : fill;
        nxt[i] = g_ite(sel, src, cur[i]);
      }
      cur = nxt;
    }
    Vec high_parts(amt.begin() + (stages < (int)amt.size()
                                      ? stages
                                      : (int)amt.size()),
                   amt.end());
    int32_t high = g_or_many(high_parts);
    if (((size_t)1 << stages) != w) {
      Vec wconst = const_bits_val((uint64_t)w, (int32_t)amt.size());
      high = g_or(high, -ult_vec(amt, wconst));
    }
    Vec out((size_t)w);
    for (size_t i = 0; i < w; ++i) out[i] = g_ite(high, fill, cur[i]);
    return out;
  }

  Vec ite_vec(int32_t c, const Vec& a, const Vec& b) {
    Vec out(a.size());
    for (size_t i = 0; i < a.size(); ++i) out[i] = g_ite(c, a[i], b[i]);
    return out;
  }

  // unsigned divmod circuit shared by UDIV/UREM of the same operands
  const std::pair<Vec, Vec>& divmod(int32_t a_tid, int32_t b_tid) {
    uint64_t key =
        ((uint64_t)(uint32_t)a_tid << 32) | (uint32_t)b_tid;
    auto it = divmod_cache.find(key);
    if (it != divmod_cache.end()) return it->second;
    const Vec& n = getbv(a_tid);
    const Vec& d = getbv(b_tid);
    int32_t w = (int32_t)n.size();
    Vec q = fresh_bits(w);
    Vec r = fresh_bits(w);
    int32_t dz = eq_vec(d, const_bits_val(0, w));
    Vec prod = mul_vec_ext(q, d);
    Vec prod_lo(prod.begin(), prod.begin() + w);
    int32_t carry;
    Vec total = add_vec(prod_lo, r, F, &carry);
    Vec hz_parts;
    for (int32_t i = w; i < 2 * w; ++i) hz_parts.push_back(-prod[(size_t)i]);
    hz_parts.push_back(-carry);
    int32_t high_zero = g_and_many(hz_parts);
    int32_t sum_eq = eq_vec(total, n);
    int32_t r_lt_d = ult_vec(r, d);
    int32_t valid = g_and_many({high_zero, sum_eq, r_lt_d});
    emit({dz, valid, 0});
    Vec ones = const_bits_val(0, w);
    for (auto& x : ones) x = T;
    Vec qf = ite_vec(dz, ones, q);
    Vec rf = ite_vec(dz, n, r);
    auto res = divmod_cache.emplace(key,
                                    std::make_pair(std::move(qf),
                                                   std::move(rf)));
    return res.first->second;
  }

  Vec signed_divmod(int32_t a_tid, int32_t b_tid, bool is_div) {
    const Vec& a = getbv(a_tid);
    const Vec& b = getbv(b_tid);
    int32_t w = (int32_t)a.size();
    int32_t sa = a.back(), sb = b.back();
    Vec abs_a = ite_vec(sa, neg_vec(a), a);
    Vec abs_b = ite_vec(sb, neg_vec(b), b);
    Vec q = fresh_bits(w);
    Vec r = fresh_bits(w);
    int32_t dz = eq_vec(abs_b, const_bits_val(0, w));
    Vec prod = mul_vec_ext(q, abs_b);
    Vec prod_lo(prod.begin(), prod.begin() + w);
    int32_t carry;
    Vec total = add_vec(prod_lo, r, F, &carry);
    Vec hz_parts;
    for (int32_t i = w; i < 2 * w; ++i) hz_parts.push_back(-prod[(size_t)i]);
    hz_parts.push_back(-carry);
    int32_t high_zero = g_and_many(hz_parts);
    int32_t sum_eq = eq_vec(total, abs_a);
    int32_t r_lt_d = ult_vec(r, abs_b);
    int32_t valid = g_and_many({high_zero, sum_eq, r_lt_d});
    emit({dz, valid, 0});
    Vec ones = const_bits_val(0, w);
    for (auto& x : ones) x = T;
    Vec q_dz = ite_vec(sa, const_bits_val(1, w), ones);
    Vec uq = ite_vec(dz, ones, q);
    Vec ur = ite_vec(dz, abs_a, r);
    if (is_div) {
      Vec signed_q = ite_vec(g_xor(sa, sb), neg_vec(uq), uq);
      return ite_vec(dz, q_dz, signed_q);
    }
    return ite_vec(sa, neg_vec(ur), ur);
  }
};

}  // namespace

extern "C" {

void* mtpu_blaster_new(void* sat, int64_t* nvars_inout) {
  Blaster* b = new Blaster();
  b->sat = sat;
  b->nvars = *nvars_inout;
  b->T = b->new_lit();
  b->F = -b->T;
  b->emit({b->T, 0});
  *nvars_inout = b->nvars;
  return b;
}

void mtpu_blaster_free(void* bp) { delete (Blaster*)bp; }

// executes a tape; returns 0 (ok) or -1 (formula latched unsat).
int32_t mtpu_blaster_exec(void* bp, const int32_t* tape, int64_t n,
                          int64_t* nvars_inout) {
  Blaster* b = (Blaster*)bp;
  b->nvars = *nvars_inout;
  b->bad = false;  // per-tape fault isolation
  int64_t i = 0;
  while (i < n) {
    int32_t op = tape[i++];
    switch (op) {
      case TP_CONST: {
        int32_t tid = tape[i++];
        int32_t width = tape[i++];
        int32_t nwords = tape[i++];
        b->bv[tid] = b->const_bits_words(tape + i, width);
        i += nwords;
        break;
      }
      case TP_VAR: {
        int32_t tid = tape[i++];
        int32_t width = tape[i++];
        b->bv[tid] = b->fresh_bits(width);
        break;
      }
      case TP_ADD: case TP_SUB: case TP_MUL: case TP_BAND:
      case TP_BOR: case TP_BXOR: case TP_SHL: case TP_LSHR:
      case TP_ASHR: {
        int32_t tid = tape[i++];
        i++;  // width (implied by args)
        const Vec& a = b->getbv(tape[i]); i++;
        const Vec& bb = b->getbv(tape[i]); i++;
        Vec v;
        switch (op) {
          case TP_ADD: v = b->add_vec(a, bb, b->F, nullptr); break;
          case TP_SUB: v = b->sub_vec(a, bb); break;
          case TP_MUL: v = b->mul_vec(a, bb); break;
          case TP_BAND: {
            v.resize(a.size());
            for (size_t j = 0; j < a.size(); ++j)
              v[j] = b->g_and(a[j], bb[j]);
            break;
          }
          case TP_BOR: {
            v.resize(a.size());
            for (size_t j = 0; j < a.size(); ++j)
              v[j] = b->g_or(a[j], bb[j]);
            break;
          }
          case TP_BXOR: {
            v.resize(a.size());
            for (size_t j = 0; j < a.size(); ++j)
              v[j] = b->g_xor(a[j], bb[j]);
            break;
          }
          case TP_SHL: v = b->shift_vec(a, bb, 0); break;
          case TP_LSHR: v = b->shift_vec(a, bb, 1); break;
          case TP_ASHR: v = b->shift_vec(a, bb, 2); break;
        }
        b->bv[tid] = std::move(v);
        break;
      }
      case TP_UDIV: case TP_UREM: {
        int32_t tid = tape[i++];
        i++;  // width
        int32_t at = tape[i++], bt = tape[i++];
        const auto& qr = b->divmod(at, bt);
        b->bv[tid] = op == TP_UDIV ? qr.first : qr.second;
        break;
      }
      case TP_SDIV: case TP_SREM: {
        int32_t tid = tape[i++];
        i++;
        int32_t at = tape[i++], bt = tape[i++];
        b->bv[tid] = b->signed_divmod(at, bt, op == TP_SDIV);
        break;
      }
      case TP_BNOT: {
        int32_t tid = tape[i++];
        i++;
        const Vec& a = b->getbv(tape[i]); i++;
        Vec v(a.size());
        for (size_t j = 0; j < a.size(); ++j) v[j] = -a[j];
        b->bv[tid] = std::move(v);
        break;
      }
      case TP_NEG: {
        int32_t tid = tape[i++];
        i++;
        b->bv[tid] = b->neg_vec(b->getbv(tape[i])); i++;
        break;
      }
      case TP_CONCAT: {
        int32_t tid = tape[i++];
        i++;
        int32_t nargs = tape[i++];
        Vec v;
        // LSB-side part is the LAST arg
        for (int32_t j = nargs - 1; j >= 0; --j) {
          const Vec& part = b->getbv(tape[i + j]);
          v.insert(v.end(), part.begin(), part.end());
        }
        i += nargs;
        b->bv[tid] = std::move(v);
        break;
      }
      case TP_EXTRACT: {
        int32_t tid = tape[i++];
        i++;
        const Vec& a = b->getbv(tape[i]); i++;
        int32_t hi = tape[i++], lo = tape[i++];
        b->bv[tid] = Vec(a.begin() + lo, a.begin() + hi + 1);
        break;
      }
      case TP_ZEXT: {
        int32_t tid = tape[i++];
        i++;
        const Vec& a = b->getbv(tape[i]); i++;
        int32_t ext = tape[i++];
        Vec v = a;
        v.resize(a.size() + (size_t)ext, b->F);
        b->bv[tid] = std::move(v);
        break;
      }
      case TP_SEXT: {
        int32_t tid = tape[i++];
        i++;
        const Vec& a = b->getbv(tape[i]); i++;
        int32_t ext = tape[i++];
        Vec v = a;
        v.resize(a.size() + (size_t)ext, a.back());
        b->bv[tid] = std::move(v);
        break;
      }
      case TP_ITE: {
        int32_t tid = tape[i++];
        i++;
        int32_t c = b->getbool(tape[i]); i++;
        const Vec& a = b->getbv(tape[i]); i++;
        const Vec& bb = b->getbv(tape[i]); i++;
        b->bv[tid] = b->ite_vec(c, a, bb);
        break;
      }
      case TP_TRUE: b->bools[tape[i++]] = b->T; break;
      case TP_FALSE: b->bools[tape[i++]] = b->F; break;
      case TP_BOOLVAR: b->bools[tape[i++]] = b->new_lit(); break;
      case TP_EQ_BV: {
        int32_t tid = tape[i++];
        const Vec& a = b->getbv(tape[i]); i++;
        const Vec& bb = b->getbv(tape[i]); i++;
        b->bools[tid] = b->eq_vec(a, bb);
        break;
      }
      case TP_EQ_BOOL: {
        int32_t tid = tape[i++];
        int32_t a = b->getbool(tape[i]); i++;
        int32_t bb = b->getbool(tape[i]); i++;
        b->bools[tid] = -b->g_xor(a, bb);
        break;
      }
      case TP_ULT: case TP_ULE: case TP_SLT: case TP_SLE: {
        int32_t tid = tape[i++];
        const Vec& a = b->getbv(tape[i]); i++;
        const Vec& bb = b->getbv(tape[i]); i++;
        int32_t v;
        if (op == TP_ULT) v = b->ult_vec(a, bb);
        else if (op == TP_ULE) v = -b->ult_vec(bb, a);
        else if (op == TP_SLT) v = b->slt_vec(a, bb);
        else v = -b->slt_vec(bb, a);
        b->bools[tid] = v;
        break;
      }
      case TP_AND_B: case TP_OR_B: {
        int32_t tid = tape[i++];
        int32_t nargs = tape[i++];
        Vec lits((size_t)nargs);
        for (int32_t j = 0; j < nargs; ++j)
          lits[(size_t)j] = b->getbool(tape[i + j]);
        i += nargs;
        b->bools[tid] =
            op == TP_AND_B ? b->g_and_many(lits) : b->g_or_many(lits);
        break;
      }
      case TP_NOT_B: {
        int32_t tid = tape[i++];
        b->bools[tid] = -b->getbool(tape[i]); i++;
        break;
      }
      case TP_XOR_B: {
        int32_t tid = tape[i++];
        int32_t a = b->getbool(tape[i]); i++;
        int32_t bb = b->getbool(tape[i]); i++;
        b->bools[tid] = b->g_xor(a, bb);
        break;
      }
      case TP_BITE: {
        int32_t tid = tape[i++];
        int32_t c = b->getbool(tape[i]); i++;
        int32_t a = b->getbool(tape[i]); i++;
        int32_t bb = b->getbool(tape[i]); i++;
        b->bools[tid] = b->g_ite(c, a, bb);
        break;
      }
      case TP_ASSERT: {
        int32_t tid = tape[i++];
        b->emit({b->getbool(tid), 0});
        break;
      }
      default:
        *nvars_inout = b->nvars;
        return -2;  // malformed tape
    }
    if (b->bad) {
      *nvars_inout = b->nvars;
      return -2;
    }
  }
  *nvars_inout = b->nvars;
  return b->flush() ? 0 : -1;
}

int32_t mtpu_blaster_bool_lit(void* bp, int32_t tid) {
  Blaster* b = (Blaster*)bp;
  auto it = b->bools.find(tid);
  return it == b->bools.end() ? 0 : it->second;
}

// unsigned-less-than over two raw literal vectors (the Optimize
// binary-search probes); flushes emitted gate clauses before returning
int32_t mtpu_blaster_ult(void* bp, const int32_t* a, const int32_t* b,
                         int32_t n, int64_t* nvars_inout) {
  Blaster* bl = (Blaster*)bp;
  bl->nvars = *nvars_inout;
  Vec va(a, a + n), vb(b, b + n);
  int32_t lit = bl->ult_vec(va, vb);
  *nvars_inout = bl->nvars;
  bl->flush();
  return lit;
}

// copies the literal vector for tid; returns width or -1 if unknown
int32_t mtpu_blaster_get_bits(void* bp, int32_t tid, int32_t* out,
                              int32_t cap) {
  Blaster* b = (Blaster*)bp;
  auto it = b->bv.find(tid);
  if (it == b->bv.end()) return -1;
  int32_t w = (int32_t)it->second.size();
  for (int32_t i = 0; i < w && i < cap; ++i) out[i] = it->second[(size_t)i];
  return w;
}

}  // extern "C"
