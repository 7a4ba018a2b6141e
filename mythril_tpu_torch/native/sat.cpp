// CDCL SAT solver — the native decision core of mythril_tpu's SMT stack.
//
// Role parity: the reference discharges every constraint query to the z3-solver
// wheel (reference mythril/laser/smt/solver/solver.py:18-121). This environment
// has no SMT wheel, so this build carries its own solver: 256-bit terms are
// bit-blasted host-side (mythril_tpu/smt/bitblast.py) into CNF solved here.
//
// Classic architecture: two-watched-literal propagation, VSIDS decision heap,
// phase saving, first-UIP conflict analysis with recursive clause
// minimization, Luby restarts, LBD-aware learnt-clause reduction, incremental
// solving under assumptions, conflict/time budgets (maps to the reference's
// solver-timeout semantics, mythril/support/model.py:41-44).
#include <algorithm>
#include <chrono>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

typedef int32_t Lit;  // 2*var + sign  (sign=1 means negated)
typedef int32_t Var;
enum : int8_t { U = 0, T = 1, F = -1 };  // lbool

inline Lit mklit(Var v, bool sign) { return (v << 1) | (Lit)sign; }
inline Var var_of(Lit l) { return l >> 1; }
inline bool sign_of(Lit l) { return l & 1; }
inline Lit neg(Lit l) { return l ^ 1; }

// Clause metadata; literals live in one flat arena (clauses of a
// Tseitin-blasted instance are small and access-heavy — per-clause
// heap vectors made every propagation step a pointer chase; the arena
// keeps the hot loop cache-resident). Binary clauses never enter the
// arena at all: they are stored inline in their watch lists and
// propagate without touching clause memory.
struct Clause {
  uint32_t off = 0;
  uint32_t size = 0;
  float act = 0.f;
  uint32_t lbd = 0;
  bool learnt = false;
};

struct Watch {
  int cref;
  Lit blocker;
};

// conflict "cref" marker for a binary-clause conflict (lits in
// Solver::bin_confl); reason[] marker for a binary-implied literal
// (antecedent in Solver::reason_bin)
enum { CREF_NONE = -1, CREF_BIN = -2 };

struct Solver {
  std::vector<Clause> clauses;        // problem + learnt (metadata)
  std::vector<Lit> arena;             // all non-binary clause literals
  size_t arena_waste = 0;             // freed literals awaiting compact
  std::vector<int> free_crefs;        // recycled metadata slots
  std::vector<std::vector<Watch>> watches;  // per literal (len >= 3)
  std::vector<std::vector<Lit>> bin_watches;  // per literal: the OTHER
  //                                             lit of each binary
  std::vector<int8_t> assign;         // per var
  std::vector<int> level;
  std::vector<int> reason;            // cref, CREF_NONE or CREF_BIN
  std::vector<Lit> reason_bin;        // antecedent lit when CREF_BIN
  std::vector<Lit> trail;
  std::vector<int> trail_lim;
  std::vector<double> activity;
  std::vector<int8_t> saved_phase;
  std::vector<int> heap;              // binary max-heap of vars
  std::vector<int> heap_pos;          // var -> heap index or -1
  std::vector<uint8_t> seen;
  Lit bin_confl[2] = {0, 0};          // conflict lits when CREF_BIN
  double var_inc = 1.0;
  double cla_inc = 1.0;
  int qhead = 0;
  bool ok = true;
  int64_t conflicts = 0, propagations = 0, decisions = 0;
  int64_t learnt_count = 0;
  std::vector<Lit> assumptions;
  std::vector<Lit> add_tmp;

  inline Lit* lits(int cref) { return arena.data() + clauses[cref].off; }
  // literal view of a conflict/reason reference. `implied` is the
  // clause's first literal (the implied one) — only meaningful for
  // CREF_BIN reasons, where the stored antecedent supplies lits[1].
  inline const Lit* ref_lits(int ref, Lit implied, int& sz) {
    if (ref == CREF_BIN) {
      bin_scratch[0] = implied;
      bin_scratch[1] = reason_bin[var_of(implied)];
      sz = 2;
      return bin_scratch;
    }
    sz = (int)clauses[ref].size;
    return arena.data() + clauses[ref].off;
  }
  Lit bin_scratch[2] = {0, 0};

  // --- variable order heap -------------------------------------------------
  bool heap_lt(Var a, Var b) { return activity[a] > activity[b]; }
  void heap_up(int i) {
    Var v = heap[i];
    while (i > 0) {
      int p = (i - 1) >> 1;
      if (!heap_lt(v, heap[p])) break;
      heap[i] = heap[p];
      heap_pos[heap[i]] = i;
      i = p;
    }
    heap[i] = v;
    heap_pos[v] = i;
  }
  void heap_down(int i) {
    Var v = heap[i];
    int n = (int)heap.size();
    for (;;) {
      int c = 2 * i + 1;
      if (c >= n) break;
      if (c + 1 < n && heap_lt(heap[c + 1], heap[c])) ++c;
      if (!heap_lt(heap[c], v)) break;
      heap[i] = heap[c];
      heap_pos[heap[i]] = i;
      i = c;
    }
    heap[i] = v;
    heap_pos[v] = i;
  }
  void heap_insert(Var v) {
    if (heap_pos[v] >= 0) return;
    heap.push_back(v);
    heap_pos[v] = (int)heap.size() - 1;
    heap_up((int)heap.size() - 1);
  }
  Var heap_pop() {
    Var v = heap[0];
    heap_pos[v] = -1;
    heap[0] = heap.back();
    heap.pop_back();
    if (!heap.empty()) {
      heap_pos[heap[0]] = 0;
      heap_down(0);
    }
    return v;
  }

  Var new_var() {
    Var v = (Var)assign.size();
    assign.push_back(U);
    level.push_back(0);
    reason.push_back(CREF_NONE);
    reason_bin.push_back(0);
    activity.push_back(0.0);
    saved_phase.push_back(F);  // default polarity false: zeros-biased models
    heap_pos.push_back(-1);
    seen.push_back(0);
    watches.emplace_back();
    watches.emplace_back();
    bin_watches.emplace_back();
    bin_watches.emplace_back();
    heap_insert(v);
    return v;
  }

  inline int8_t value(Lit l) const {
    int8_t a = assign[var_of(l)];
    return (int8_t)(sign_of(l) ? -a : a);
  }

  void var_bump(Var v) {
    activity[v] += var_inc;
    if (activity[v] > 1e100) {
      for (auto& a : activity) a *= 1e-100;
      var_inc *= 1e-100;
    }
    if (heap_pos[v] >= 0) heap_up(heap_pos[v]);
  }
  void cla_bump(Clause& c) {
    c.act += (float)cla_inc;
    if (c.act > 1e20f) {
      for (auto& cl : clauses)
        if (cl.learnt) cl.act *= 1e-20f;
      cla_inc *= 1e-20;
    }
  }

  void attach(int cref) {
    Lit* cl = lits(cref);
    watches[neg(cl[0])].push_back({cref, cl[1]});
    watches[neg(cl[1])].push_back({cref, cl[0]});
  }

  void attach_binary(Lit a, Lit b) {
    bin_watches[neg(a)].push_back(b);
    bin_watches[neg(b)].push_back(a);
  }

  void uncheck_enqueue(Lit l, int from) {
    assign[var_of(l)] = sign_of(l) ? F : T;
    level[var_of(l)] = (int)trail_lim.size();
    reason[var_of(l)] = from;
    trail.push_back(l);
  }
  void enqueue_binary(Lit l, Lit antecedent) {
    assign[var_of(l)] = sign_of(l) ? F : T;
    level[var_of(l)] = (int)trail_lim.size();
    reason[var_of(l)] = CREF_BIN;
    reason_bin[var_of(l)] = antecedent;
    trail.push_back(l);
  }

  int propagate() {  // returns conflicting cref, CREF_BIN or CREF_NONE
    while (qhead < (int)trail.size()) {
      Lit p = trail[qhead++];
      ++propagations;
      // binary clauses first: no clause memory touched at all
      const std::vector<Lit>& bs = bin_watches[p];
      for (size_t i = 0; i < bs.size(); ++i) {
        Lit other = bs[i];
        int8_t v = value(other);
        if (v == F) {
          bin_confl[0] = other;
          bin_confl[1] = neg(p);
          qhead = (int)trail.size();
          return CREF_BIN;
        }
        if (v == U) enqueue_binary(other, neg(p));
      }
      std::vector<Watch>& ws = watches[p];
      size_t i = 0, j = 0;
      while (i < ws.size()) {
        Watch w = ws[i];
        if (value(w.blocker) == T) {
          ws[j++] = ws[i++];
          continue;
        }
        Clause& c = clauses[w.cref];
        Lit* cl = arena.data() + c.off;
        Lit false_lit = neg(p);
        if (cl[0] == false_lit) std::swap(cl[0], cl[1]);
        Lit first = cl[0];
        if (first != w.blocker && value(first) == T) {
          ws[j++] = {w.cref, first};
          ++i;
          continue;
        }
        bool moved = false;
        for (uint32_t k = 2; k < c.size; ++k) {
          if (value(cl[k]) != F) {
            std::swap(cl[1], cl[k]);
            watches[neg(cl[1])].push_back({w.cref, first});
            moved = true;
            break;
          }
        }
        if (moved) {
          ++i;
          continue;
        }
        // unit or conflict
        ws[j++] = {w.cref, first};
        ++i;
        if (value(first) == F) {
          // conflict: copy remaining watches and bail
          while (i < ws.size()) ws[j++] = ws[i++];
          ws.resize(j);
          qhead = (int)trail.size();
          return w.cref;
        }
        uncheck_enqueue(first, w.cref);
      }
      ws.resize(j);
    }
    return CREF_NONE;
  }

  void cancel_until(int lvl) {
    if ((int)trail_lim.size() <= lvl) return;
    for (int i = (int)trail.size() - 1; i >= trail_lim[lvl]; --i) {
      Var v = var_of(trail[i]);
      saved_phase[v] = assign[v];
      assign[v] = U;
      reason[v] = -1;
      heap_insert(v);
    }
    trail.resize(trail_lim[lvl]);
    qhead = (int)trail.size();
    trail_lim.resize(lvl);
  }

  std::vector<Var> minimize_marked;  // memoized marks to clear after analyze

  bool lit_redundant(Lit l, uint32_t levels_mask) {
    // recursive minimization (iterative with explicit stack)
    std::vector<Lit> stack{l};
    std::vector<Var> cleared;
    while (!stack.empty()) {
      Lit cur = stack.back();
      stack.pop_back();
      int r = reason[var_of(cur)];
      if (r == CREF_NONE) {
        for (Var v : cleared) seen[v] = 0;
        return false;
      }
      // the implied literal of cur's reason clause is the trail
      // assignment of cur's var (cur may appear negated here)
      Lit implied = mklit(var_of(cur), assign[var_of(cur)] == F);
      int sz;
      const Lit* cl = ref_lits(r, implied, sz);
      for (int i = 1; i < sz; ++i) {
        Lit q = cl[i];
        Var v = var_of(q);
        if (seen[v] || level[v] == 0) continue;
        if (reason[v] == CREF_NONE ||
            !((levels_mask >> (level[v] & 31)) & 1)) {
          for (Var vv : cleared) seen[vv] = 0;
          return false;
        }
        seen[v] = 1;
        cleared.push_back(v);
        stack.push_back(q);
      }
    }
    // success: marks stay set for memoization across the minimization pass;
    // record them for targeted clearing at the end of analyze()
    minimize_marked.insert(minimize_marked.end(), cleared.begin(),
                           cleared.end());
    return true;
  }

  void analyze(int confl, std::vector<Lit>& out_learnt, int& out_btlevel,
               uint32_t& out_lbd) {
    out_learnt.clear();
    out_learnt.push_back(0);  // placeholder for asserting literal
    int path_c = 0;
    Lit p = -1;
    int idx = (int)trail.size() - 1;
    do {
      if (confl != CREF_BIN && clauses[confl].learnt)
        cla_bump(clauses[confl]);
      int sz;
      const Lit* cl;
      if (p == -1 && confl == CREF_BIN) {
        // initial conflict in a binary clause: both lits false
        bin_scratch[0] = bin_confl[0];
        bin_scratch[1] = bin_confl[1];
        sz = 2;
        cl = bin_scratch;
      } else {
        cl = ref_lits(confl, p, sz);
      }
      for (int i = (p == -1 ? 0 : 1); i < sz; ++i) {
        Lit q = cl[i];
        Var v = var_of(q);
        if (!seen[v] && level[v] > 0) {
          seen[v] = 1;
          var_bump(v);
          if (level[v] >= (int)trail_lim.size())
            ++path_c;
          else
            out_learnt.push_back(q);
        }
      }
      while (!seen[var_of(trail[idx])]) --idx;
      p = trail[idx];
      confl = reason[var_of(p)];
      seen[var_of(p)] = 0;
      --path_c;
    } while (path_c > 0);
    out_learnt[0] = neg(p);

    // minimize
    uint32_t levels_mask = 0;
    for (size_t i = 1; i < out_learnt.size(); ++i)
      levels_mask |= 1u << (level[var_of(out_learnt[i])] & 31);
    size_t j = 1;
    for (size_t i = 1; i < out_learnt.size(); ++i) {
      Var v = var_of(out_learnt[i]);
      if (reason[v] == CREF_NONE ||
          !lit_redundant(out_learnt[i], levels_mask))
        out_learnt[j++] = out_learnt[i];
      else
        minimize_marked.push_back(v);  // dropped literal still has seen=1
    }
    out_learnt.resize(j);

    // LBD
    out_lbd = 0;
    {
      std::vector<int> lvls;
      for (Lit l : out_learnt) lvls.push_back(level[var_of(l)]);
      std::sort(lvls.begin(), lvls.end());
      lvls.erase(std::unique(lvls.begin(), lvls.end()), lvls.end());
      out_lbd = (uint32_t)lvls.size();
    }

    if (out_learnt.size() == 1) {
      out_btlevel = 0;
    } else {
      int max_i = 1;
      for (size_t i = 2; i < out_learnt.size(); ++i)
        if (level[var_of(out_learnt[i])] > level[var_of(out_learnt[max_i])])
          max_i = (int)i;
      std::swap(out_learnt[1], out_learnt[max_i]);
      out_btlevel = level[var_of(out_learnt[1])];
    }
    // clear marks: learnt-clause vars + minimization-memoized vars only
    for (Lit l : out_learnt) seen[var_of(l)] = 0;
    for (Var v : minimize_marked) seen[v] = 0;
    minimize_marked.clear();
  }

  int alloc_clause(const std::vector<Lit>& cl, bool learnt) {
    int cref;
    if (!free_crefs.empty()) {
      cref = free_crefs.back();
      free_crefs.pop_back();
      clauses[cref] = Clause();
    } else {
      cref = (int)clauses.size();
      clauses.emplace_back();
    }
    clauses[cref].off = (uint32_t)arena.size();
    clauses[cref].size = (uint32_t)cl.size();
    clauses[cref].learnt = learnt;
    arena.insert(arena.end(), cl.begin(), cl.end());
    return cref;
  }

  bool add_clause(const Lit* lits, int n) {
    if (!ok) return false;
    cancel_until(0);
    add_tmp.assign(lits, lits + n);
    std::sort(add_tmp.begin(), add_tmp.end());
    add_tmp.erase(std::unique(add_tmp.begin(), add_tmp.end()), add_tmp.end());
    // taut / false-literal removal at level 0
    std::vector<Lit> cl;
    for (size_t i = 0; i < add_tmp.size(); ++i) {
      Lit l = add_tmp[i];
      if (i + 1 < add_tmp.size() && add_tmp[i + 1] == neg(l)) return true;
      if (i > 0 && add_tmp[i - 1] == neg(l)) return true;
      int8_t v = value(l);
      if (v == T && level[var_of(l)] == 0) return true;
      if (v == F && level[var_of(l)] == 0) continue;
      cl.push_back(l);
    }
    if (cl.empty()) {
      ok = false;
      return false;
    }
    if (cl.size() == 1) {
      if (value(cl[0]) == F) {
        ok = false;
        return false;
      }
      if (value(cl[0]) == U) uncheck_enqueue(cl[0], CREF_NONE);
      ok = (propagate() == CREF_NONE);
      return ok;
    }
    if (cl.size() == 2) {
      attach_binary(cl[0], cl[1]);
      return true;
    }
    int cref = alloc_clause(cl, false);
    attach(cref);
    return true;
  }

  void detach(int cref) {
    Lit* cl = lits(cref);
    for (int wi = 0; wi < 2; ++wi) {
      std::vector<Watch>& ws = watches[neg(cl[wi])];
      for (size_t i = 0; i < ws.size(); ++i)
        if (ws[i].cref == cref) {
          ws[i] = ws.back();
          ws.pop_back();
          break;
        }
    }
  }

  bool locked(int cref) {
    Lit first = lits(cref)[0];
    return value(first) == T && reason[var_of(first)] == cref;
  }

  void compact_arena() {
    std::vector<Lit> fresh;
    fresh.reserve(arena.size() - arena_waste);
    for (auto& c : clauses) {
      if (c.size == 0) continue;
      uint32_t off = (uint32_t)fresh.size();
      fresh.insert(fresh.end(), arena.begin() + c.off,
                   arena.begin() + c.off + c.size);
      c.off = off;
    }
    arena.swap(fresh);
    arena_waste = 0;
  }

  void reduce_db() {
    std::vector<int> learnts;
    for (int i = 0; i < (int)clauses.size(); ++i)
      if (clauses[i].learnt && clauses[i].size) learnts.push_back(i);
    std::sort(learnts.begin(), learnts.end(), [&](int a, int b) {
      const Clause& x = clauses[a];
      const Clause& y = clauses[b];
      if (x.lbd != y.lbd) return x.lbd < y.lbd;
      return x.act > y.act;
    });
    size_t keep = learnts.size() / 2;
    for (size_t i = keep; i < learnts.size(); ++i) {
      int cref = learnts[i];
      if (locked(cref) || clauses[cref].lbd <= 3) continue;
      detach(cref);
      arena_waste += clauses[cref].size;
      clauses[cref].size = 0;
      free_crefs.push_back(cref);
      --learnt_count;
    }
    if (arena_waste > arena.size() / 2) compact_arena();
  }

  static double luby(double y, int x) {
    int size, seq;
    for (size = 1, seq = 0; size < x + 1; ++seq, size = 2 * size + 1) {
    }
    while (size - 1 != x) {
      size = (size - 1) >> 1;
      --seq;
      x = x % size;
    }
    return std::pow(y, seq);
  }

  // Failed-assumption core of the last UNSAT-under-assumptions result
  // (MiniSat analyzeFinal): the subset of the query's assumption
  // literals the permanent clauses refute. Any later query whose
  // assumption set contains a recorded core is unsat without search —
  // the incremental session caches cores for exactly that subsumption
  // test. Empty after a level-0 (assumption-free) refutation.
  std::vector<Lit> core;

  // Walk the implication graph from a seed (conflict clause or a
  // falsified assumption) back to decision literals. While solve() is
  // establishing assumptions, every decision level IS an assumption,
  // so the collected decisions are precisely the core.
  void final_core_walk() {
    for (int i = (int)trail.size() - 1; i >= 0; --i) {
      Var v = var_of(trail[i]);
      if (!seen[v]) continue;
      seen[v] = 0;
      if (reason[v] == CREF_NONE) {
        core.push_back(trail[i]);
      } else {
        int rsz;
        const Lit* rl = ref_lits(reason[v], trail[i], rsz);
        for (int j = 0; j < rsz; ++j) {
          Var u = var_of(rl[j]);
          if (u != v && level[u] > 0) seen[u] = 1;
        }
      }
    }
  }

  void analyze_final_clause(int confl) {
    core.clear();
    seen.assign(assign.size(), 0);
    int sz;
    const Lit* cl;
    if (confl == CREF_BIN) {
      cl = bin_confl;
      sz = 2;
    } else {
      sz = (int)clauses[confl].size;
      cl = lits(confl);
    }
    for (int i = 0; i < sz; ++i) {
      Var v = var_of(cl[i]);
      if (level[v] > 0) seen[v] = 1;
    }
    final_core_walk();
  }

  void analyze_final_lit(Lit a) {
    core.clear();
    core.push_back(a);  // the assumption that failed to establish
    Var av = var_of(a);
    if (level[av] == 0) return;  // refuted by level-0 units alone
    seen.assign(assign.size(), 0);
    seen[av] = 1;
    final_core_walk();
  }

  // returns: 1 sat, 0 unsat, -1 unknown (budget exhausted)
  // true iff the trail's propagation closure is complete (only a SAT
  // exit guarantees it; conflict bails fast-forward qhead past pending
  // original-clause propagations, so their trails must not be reused)
  bool trail_clean = true;

  int solve(const Lit* assumps, int n_assumps, double timeout_s,
            int64_t conflict_budget) {
    if (!ok) return 0;
    // Assumption-trail reuse: consecutive queries in an incremental
    // session share long assumption prefixes (path-feasibility storms
    // differ in a suffix), and each assumption occupies exactly one
    // decision level — keep the levels whose assumption decisions
    // match the new prefix instead of re-deciding and re-propagating
    // the whole prefix closure. Clause additions between queries reset
    // the trail (add_clause cancels to level 0), so a kept level's
    // propagation closure is still current.
    int keep = 0;
    if (trail_clean) {
      while (keep < n_assumps && keep < (int)trail_lim.size() &&
             keep < (int)assumptions.size() &&
             assumptions[keep] == assumps[keep]) {
        ++keep;
      }
    }
    cancel_until(keep);
    assumptions.assign(assumps, assumps + n_assumps);
    trail_clean = false;
    auto t0 = std::chrono::steady_clock::now();
    int64_t confl_limit =
        conflict_budget > 0 ? conflicts + conflict_budget : INT64_MAX;
    int restart_n = 0;
    int64_t next_restart = conflicts + (int64_t)(100 * luby(2.0, restart_n));
    int64_t next_reduce = 4000;
    std::vector<Lit> learnt_cl;

    for (;;) {
      int confl = propagate();
      if (confl != CREF_NONE) {
        ++conflicts;
        // A conflict while only assumption decisions are on the trail (each
        // assumption occupies exactly one decision level) means the formula
        // is unsat under the given assumptions. At level 0 the formula is
        // unsat outright: latch ok=false, because the conflict handler
        // fast-forwarded qhead past pending propagations and the solver
        // state must not be reused for further queries.
        if (trail_lim.empty()) {
          ok = false;
          core.clear();  // refuted with no assumptions: empty core
          return 0;
        }
        if ((int)trail_lim.size() <= (int)assumptions.size()) {
          analyze_final_clause(confl);
          return 0;
        }
        int btlevel;
        uint32_t lbd;
        analyze(confl, learnt_cl, btlevel, lbd);
        cancel_until(btlevel);
        if (learnt_cl.size() == 1) {
          // btlevel == 0 here; assumptions get re-asserted by the loop below
          if (value(learnt_cl[0]) == U)
            uncheck_enqueue(learnt_cl[0], CREF_NONE);
        } else if (learnt_cl.size() == 2) {
          // learnt binaries join the inline watch lists (never
          // reduced: lbd <= 2 clauses were kept by reduce_db anyway)
          attach_binary(learnt_cl[0], learnt_cl[1]);
          enqueue_binary(learnt_cl[0], learnt_cl[1]);
        } else {
          int cref = alloc_clause(learnt_cl, true);
          clauses[cref].lbd = lbd;
          attach(cref);
          ++learnt_count;
          uncheck_enqueue(learnt_cl[0], cref);
        }
        var_inc *= (1.0 / 0.95);
        cla_inc *= (1.0 / 0.999);
        if (conflicts >= confl_limit) return -1;
        if ((conflicts & 255) == 0 && timeout_s > 0) {
          double el = std::chrono::duration<double>(
                          std::chrono::steady_clock::now() - t0)
                          .count();
          if (el > timeout_s) return -1;
        }
        if (conflicts >= next_restart) {
          ++restart_n;
          next_restart = conflicts + (int64_t)(100 * luby(2.0, restart_n));
          cancel_until((int)assumptions.size());
        }
        if (learnt_count >= next_reduce) {
          reduce_db();
          next_reduce += 2000;
        }
      } else {
        // establish assumptions (one decision level each), then decide
        if ((int)trail_lim.size() < (int)assumptions.size()) {
          Lit a = assumptions[trail_lim.size()];
          if (value(a) == F) {  // assumptions conflict
            analyze_final_lit(a);
            return 0;
          }
          trail_lim.push_back((int)trail.size());
          if (value(a) == U) uncheck_enqueue(a, -1);
          continue;
        }
        ++decisions;
        Var next = -1;
        while (!heap.empty()) {
          Var v = heap_pop();
          if (assign[v] == U) {
            next = v;
            break;
          }
        }
        if (next < 0) {
          trail_clean = true;
          return 1;  // all assigned: SAT
        }
        trail_lim.push_back((int)trail.size());
        uncheck_enqueue(mklit(next, saved_phase[next] != T), -1);
      }
    }
  }
};

}  // namespace

extern "C" {
void* mtpu_sat_new() { return new Solver(); }
void mtpu_sat_free(void* s) { delete (Solver*)s; }
int32_t mtpu_sat_new_var(void* s) { return ((Solver*)s)->new_var(); }
// DIMACS-style literals: +v / -v with v >= 1
int32_t mtpu_sat_add_clause(void* sp, const int32_t* lits, int32_t n) {
  Solver* s = (Solver*)sp;
  std::vector<Lit> internal(n);
  for (int i = 0; i < n; ++i) {
    int32_t l = lits[i];
    Var v = (l > 0 ? l : -l) - 1;
    while (v >= (int32_t)s->assign.size()) s->new_var();
    internal[i] = mklit(v, l < 0);
  }
  return s->add_clause(internal.data(), n) ? 1 : 0;
}
// Bulk clause stream: literals with 0 terminating each clause
// (DIMACS body layout). One FFI crossing for an arbitrary number of
// clauses — the per-call ctypes overhead dominates when the bit-blaster
// emits hundreds of thousands of Tseitin clauses.
// Returns the number of clauses added, or -1 on immediate UNSAT.
int32_t mtpu_sat_add_clauses(void* sp, const int32_t* stream, int32_t n) {
  Solver* s = (Solver*)sp;
  std::vector<Lit> internal;
  internal.reserve(8);
  int32_t added = 0;
  for (int i = 0; i < n; ++i) {
    int32_t l = stream[i];
    if (l == 0) {
      if (!s->add_clause(internal.data(), (int32_t)internal.size()))
        return -1;
      ++added;
      internal.clear();
      continue;
    }
    Var v = (l > 0 ? l : -l) - 1;
    while (v >= (int32_t)s->assign.size()) s->new_var();
    internal.push_back(mklit(v, l < 0));
  }
  if (!internal.empty()) {
    if (!s->add_clause(internal.data(), (int32_t)internal.size()))
      return -1;
    ++added;
  }
  return added;
}
int32_t mtpu_sat_solve(void* sp, const int32_t* assumps, int32_t n,
                       double timeout_s, int64_t conflict_budget) {
  Solver* s = (Solver*)sp;
  std::vector<Lit> internal(n);
  for (int i = 0; i < n; ++i) {
    int32_t l = assumps[i];
    Var v = (l > 0 ? l : -l) - 1;
    while (v >= (int32_t)s->assign.size()) s->new_var();
    internal[i] = mklit(v, l < 0);
  }
  int r = s->solve(internal.data(), n, timeout_s, conflict_budget);
  return r;
}
// Failed-assumption core of the last UNSAT-under-assumptions solve, in
// DIMACS form matching the literals passed as assumptions. Returns the
// core size (may exceed cap; only min(n, cap) entries are written).
int32_t mtpu_sat_core(void* sp, int32_t* out, int32_t cap) {
  Solver* s = (Solver*)sp;
  int n = (int)s->core.size();
  for (int i = 0; i < n && i < cap; ++i) {
    Lit l = s->core[i];
    out[i] = (var_of(l) + 1) * (sign_of(l) ? -1 : 1);
  }
  return n;
}
// model value of DIMACS var v (>=1): 1 true, 0 false, -1 unassigned
int32_t mtpu_sat_value(void* sp, int32_t v) {
  Solver* s = (Solver*)sp;
  Var var = v - 1;
  if (var < 0 || var >= (int32_t)s->assign.size()) return -1;
  int8_t a = s->assign[var];
  return a == T ? 1 : (a == F ? 0 : -1);
}
// bulk model values of signed DIMACS literals: out[i] = 1 lit true,
// 0 lit false, -1 unassigned (one call instead of one per bit)
void mtpu_sat_values(void* sp, const int32_t* lits, int32_t n,
                     int8_t* out) {
  Solver* s = (Solver*)sp;
  for (int32_t i = 0; i < n; i++) {
    int32_t l = lits[i];
    Var var = (l > 0 ? l : -l) - 1;
    if (var < 0 || var >= (int32_t)s->assign.size()) {
      out[i] = -1;
      continue;
    }
    int8_t a = s->assign[var];
    if (a != T && a != F) {
      out[i] = -1;
    } else {
      bool v = (a == T);
      out[i] = (l > 0 ? v : !v) ? 1 : 0;
    }
  }
}
// dump the full assignment: out[i] = value of var i+1 (1/0/-1).
// Returns the number of vars written (min(assign.size(), cap)).
int32_t mtpu_sat_assignment(void* sp, int8_t* out, int32_t cap) {
  Solver* s = (Solver*)sp;
  int32_t n = (int32_t)s->assign.size();
  if (n > cap) n = cap;
  for (int32_t i = 0; i < n; i++) {
    int8_t a = s->assign[i];
    out[i] = a == T ? 1 : (a == F ? 0 : -1);
  }
  return n;
}
// Seed saved phases from a known-good assignment (DIMACS vars with
// 0/1 values): decisions then walk toward that assignment first, so a
// quick-sat/repaired model turns a cold 100k-variable instance into a
// near-propagation-only first solve. Purely a search bias — never
// affects satisfiability or soundness.
void mtpu_sat_seed_phases(void* sp, const int32_t* vars,
                          const int8_t* vals, int32_t n) {
  Solver* s = (Solver*)sp;
  for (int32_t i = 0; i < n; ++i) {
    Var v = vars[i] - 1;
    if (v < 0) continue;
    while (v >= (int32_t)s->assign.size()) s->new_var();
    s->saved_phase[v] = vals[i] ? T : F;
    // decide seeded INPUT vars before the zero-activity Tseitin gate
    // vars: gates decided first (default-false) would propagate input
    // bits away from the hint with no conflict, silently discarding
    // the warm start (verified empirically in review)
    s->activity[v] = 1.0;
    if (s->heap_pos[v] >= 0) s->heap_up(s->heap_pos[v]);
  }
}

int64_t mtpu_sat_stats(void* sp, int32_t which) {
  Solver* s = (Solver*)sp;
  switch (which) {
    case 0:
      return s->conflicts;
    case 1:
      return s->propagations;
    case 2:
      return s->decisions;
    case 3:
      return (int64_t)s->assign.size();
    default:
      return 0;
  }
}
}
