"""Verified closed-form loop summaries (docs/static_pass.md §loop
summaries, ROADMAP item 4).

The bounded-loops strategy re-executes counter loops lane-by-lane and
iteration-by-iteration even though the static pass already knows every
back-edge loop head (loops.py) and the dominant real-contract loop
shape is a counter walked by a constant stride under a comparison
bound.  This module is a dataflow client over the PR-7 CFG that, once
per memoized code hash:

1. RECOGNIZES that shape per loop head: a single-back-edge loop whose
   iteration path (head block + branch-free body chain) leaves the
   abstract stack unchanged except ONE slot updated by ``+= stride``
   (a concrete constant), with the head JUMPI's condition a comparison
   between that slot and a loop-invariant bound (a constant or another
   untouched slot);
2. SYNTHESIZES a closed-form summary: exit counter value, iteration
   count, aggregate gas interval, depth/trace accounting and the
   (empty, for pure templates) storage-write footprint;
3. VERIFIES the closed form with ONE solver query per loop through the
   ``batch.discharge`` seam — the generate-cheap/check-with-a-machine
   pattern (LLM-Vectorizer, PAPERS.md).  The query asserts the loop's
   side conditions and entry condition and asks for a counterexample
   to the conjunction of exit/last-iteration/no-wrap claims over
   SYMBOLIC entry counter and bound; UNSAT proves the closed form for
   every instance, and the proof lands in the run-wide verdict cache
   (a thief re-verifying a shipped template answers from the bank).

Application (bounded_loops strategy on the host path, the window
boundary on the lane path — the device parks lanes at verified heads
via the CompiledCode ``loopsum_park`` plane) is restricted to
instances whose counter and bound are runtime-CONCRETE: the applied
state is then bit-identical to the state full unrolling would produce
(same stack, same gas interval, same constraints — concrete branch
conditions are never recorded), except it is reached without
executing ``n * iter_instrs`` instructions.  Instances the loop bound
would have pruned (``n > bound``) retire immediately instead of
burning ``bound+1`` wasted iterations first.  Anything else — symbolic
counter or bound, annotation-carrying operands, projected out-of-gas,
an unverifiable template — DECLINES and degrades to today's
unrolling, bit-for-bit.

Unbounded iteration hulls are the second product: a recognized
counter loop whose bound is not a static constant has an unbounded
hull, and when the head condition is additionally attacker-tainted
(PR-8 ``site_taints``) the UnboundedLoopGas detection module
(analysis/module/modules/unbounded_loop_gas.py) fires on it.

Gate: ``MTPU_LOOPSUM`` (default on; ``=0`` turns every consumer off
bit-for-bit — templates are still computed into the memo like the
taint products, but nothing reads them).

Solver access policy: this package may ONLY verify through
``smt.solver.batch.discharge`` (lint rule 7,
``solver-import-in-static-pass``) so verdict caching, subset kills
and pooling apply to verification queries like any other.
"""

import logging
import os
import threading
from typing import Dict, FrozenSet, List, NamedTuple, Optional, Tuple

from .blocks import BasicBlock, Instr, stack_arity
from .cfg import CFG

log = logging.getLogger(__name__)

#: tri-state override for tests/bench (None = read MTPU_LOOPSUM)
FORCE: Optional[bool] = None

WORD = 1 << 256
_MASK = WORD - 1

#: recognition caps: body chains longer than this, or codes with more
#: candidate heads, keep their tails unsummarized (cost ceiling only —
#: a skipped loop unrolls exactly as before)
_MAX_BODY_BLOCKS = 32
_MAX_TEMPLATES = 64
#: abstract slots tracked at head entry (DUP16/SWAP16 reach depth 16)
_TRACK = 17
#: strides past this are not "counter walks" (and leave no room for
#: the no-wrap side conditions)
_MAX_STRIDE = 1 << 128

#: solver budget for the one verification query per loop
_VERIFY_TIMEOUT_S = 3.0

#: instruction whitelist for PURE iteration paths (plus PUSH*/DUP*/
#: SWAP* and the structural JUMP/JUMPI/JUMPDEST).  Everything here has
#: a static gas tuple (no dynamic components in instructions.py) and
#: no effect outside the stack, so skipping the execution skips
#: nothing observable.
_PURE_OPS = frozenset((
    "POP", "ADD", "SUB", "MUL", "AND", "OR", "XOR", "NOT",
    "LT", "GT", "SLT", "SGT", "EQ", "ISZERO", "SHL", "SHR",
))
#: the integer module annotates results of exactly these — a pure
#: template allows ONE of them (the counter increment, proven
#: wrap-free by the verified claim) so summarization can never drop
#: an overflow annotation unrolling would have minted
_ANNOT_ARITH = frozenset(("ADD", "SUB", "MUL", "EXP"))


def enabled() -> bool:
    """The MTPU_LOOPSUM gate (default on).  Callers pair this with
    static-pass availability (info_for returns None when MTPU_STATIC
    is off, which turns this layer off transitively)."""
    if FORCE is not None:
        return FORCE
    return os.environ.get("MTPU_LOOPSUM", "1") != "0"


class LoopTemplate(NamedTuple):
    """One recognized counter loop (plain picklable data — rides the
    StaticInfo memo and the migration sidecar; never terms)."""

    head_pc: int                 # byte pc of the head JUMPDEST
    head_jumpi_pc: int           # byte pc of the head block's JUMPI
    exit_pc: int                 # byte pc execution lands on at exit
    continue_pc: int             # byte pc of the body arm
    body_starts: Tuple[int, ...]  # body block start pcs (may be empty)
    counter_depth: int           # stack depth (from top) at head entry
    stride: int                  # concrete increment per iteration
    cmp: str                     # "ULT" | "ULE": continue while
    #                              counter <cmp> bound
    bound_depth: Optional[int]   # bound's stack depth, or None
    bound_const: Optional[int]   # concrete bound, or None
    iter_gas: Tuple[int, int]    # (min,max) gas per iteration
    exit_gas: Tuple[int, int]    # (min,max) gas of the exiting check
    iter_depth: int              # mstate.depth bumps per iteration
    exit_depth: int              # depth bump of the exiting check
    iter_instrs: int             # instructions per iteration
    need_height: int             # min runtime stack height at head
    pure: bool                   # iteration path in the pure whitelist,
    #                              slots preserved, one arith site
    storage_writes: Tuple[int, ...] = ()  # body footprint (pure: ())

    @property
    def unbounded(self) -> bool:
        """No static concrete bound: the iteration hull's upper end is
        open (the UnboundedLoopGas trigger predicate)."""
        return self.bound_const is None


# ---------------------------------------------------------------------------
# recognition: symbolic-slot abstract interpretation of one iteration
# ---------------------------------------------------------------------------
#
# Exprs are tiny tuples over the head-entry stack symbols:
#   ("sym", d)        entry slot at depth d (0 = top of stack)
#   ("const", v)      concrete word
#   ("aff", d, c)     sym_d + c (mod 2**256), c != 0
#   ("cmp", k, a, b)  comparison word (k in LT/GT/SLT/SGT/EQ)
#   ("not", x)        ISZERO of a cmp/not
#   None              TOP (anything else)


def _gas_of(op: str) -> Tuple[int, int]:
    from ...support.opcodes import GAS, OPCODES

    data = OPCODES.get(op)
    return tuple(data[GAS]) if data else (0, 0)


class _Interp:
    """Mutable abstract machine for one walk over instructions."""

    def __init__(self):
        # bottom of list = deepest tracked entry; top at the end
        self.stack: List[object] = [("sym", _TRACK - 1 - i)
                                    for i in range(_TRACK)]
        self.pure = True
        self.arith = 0            # _ANNOT_ARITH instruction count
        self.need = 0             # min runtime height at head entry
        self.gas_min = 0
        self.gas_max = 0
        self.instrs = 0
        self.cond = None          # expr at the head JUMPI, if seen
        self.ok = True

    def _require(self, k: int) -> None:
        """k items must exist on the runtime stack right now."""
        self.need = max(self.need, k - (len(self.stack) - _TRACK))

    def _pop(self, k: int) -> List[object]:
        self._require(k)
        out = []
        for _ in range(k):
            out.append(self.stack.pop() if self.stack else None)
        return out

    def step(self, ins: Instr, is_head_jumpi: bool = False) -> None:
        if not self.ok:
            return
        op = ins.op
        st = self.stack
        self.instrs += 1
        g = _gas_of(op)
        self.gas_min += g[0]
        self.gas_max += g[1]
        if op in _ANNOT_ARITH:
            self.arith += 1
        if op.startswith("PUSH"):
            st.append(("const", (ins.push_value or 0) & _MASK))
            return
        if op.startswith("DUP"):
            n = int(op[3:])
            self._require(n)
            st.append(st[-n] if n <= len(st) else None)
            return
        if op.startswith("SWAP"):
            n = int(op[4:])
            self._require(n + 1)
            if n < len(st):
                st[-1], st[-n - 1] = st[-n - 1], st[-1]
            else:
                self.ok = False
            return
        if op == "JUMPDEST":
            return
        if op == "JUMPI":
            if not is_head_jumpi:
                self.ok = False
                return
            self._require(2)
            dest = st.pop() if st else None  # noqa: F841 (concrete)
            self.cond = st.pop() if st else None
            return
        if op == "JUMP":
            self._pop(1)
            return
        if op == "POP":
            self._pop(1)
            return
        if op not in _PURE_OPS:
            # impure/unknown op: apply arity with TOP results; the
            # template (if any) degrades to detector-only
            self.pure = False
            pops, pushes = stack_arity(op)
            self._pop(pops)
            for _ in range(pushes):
                st.append(None)
            return
        # pure ALU/compare ops
        pops, pushes = stack_arity(op)
        args = self._pop(pops)
        st.append(self._alu(op, args))

    @staticmethod
    def _alu(op: str, args: List[object]) -> object:
        def const(x):
            return x[1] if isinstance(x, tuple) and x[0] == "const" \
                else None

        a = args[0] if args else None
        b = args[1] if len(args) > 1 else None
        ca, cb = const(a), const(b)
        if op == "ADD":
            if ca is not None and cb is not None:
                return ("const", (ca + cb) & _MASK)
            for x, c in ((a, cb), (b, ca)):
                if c is not None and isinstance(x, tuple):
                    if x[0] == "sym":
                        return ("aff", x[1], c & _MASK) if c & _MASK \
                            else x
                    if x[0] == "aff":
                        nc = (x[2] + c) & _MASK
                        return ("aff", x[1], nc) if nc \
                            else ("sym", x[1])
            return None
        if op == "SUB":  # a - b, a = top of stack
            if ca is not None and cb is not None:
                return ("const", (ca - cb) & _MASK)
            if cb is not None and isinstance(a, tuple):
                if a[0] == "sym":
                    nc = (-cb) & _MASK
                    return ("aff", a[1], nc) if nc else a
                if a[0] == "aff":
                    nc = (a[2] - cb) & _MASK
                    return ("aff", a[1], nc) if nc else ("sym", a[1])
            return None
        if op == "NOT":
            return ("const", ca ^ _MASK) if ca is not None else None
        if op == "ISZERO":
            if ca is not None:
                return ("const", 0 if ca else 1)
            if isinstance(a, tuple) and a[0] in ("cmp", "not"):
                return ("not", a)
            return None
        if op in ("LT", "GT", "SLT", "SGT", "EQ"):
            if ca is not None and cb is not None:
                if op == "LT":
                    r = ca < cb
                elif op == "GT":
                    r = ca > cb
                elif op == "EQ":
                    r = ca == cb
                else:
                    sa = ca - WORD if ca >> 255 else ca
                    sb = cb - WORD if cb >> 255 else cb
                    r = sa < sb if op == "SLT" else sa > sb
                return ("const", 1 if r else 0)
            if a is None or b is None:
                return None
            return ("cmp", op, a, b)
        # MUL/AND/OR/XOR/SHL/SHR: constant folds only
        if ca is not None and cb is not None:
            if op == "MUL":
                return ("const", (ca * cb) & _MASK)
            if op == "AND":
                return ("const", ca & cb)
            if op == "OR":
                return ("const", ca | cb)
            if op == "XOR":
                return ("const", ca ^ cb)
            if op == "SHL":  # shift = a, value = b
                return ("const", (cb << ca) & _MASK if ca < 256 else 0)
            if op == "SHR":
                return ("const", cb >> ca if ca < 256 else 0)
        return None


def _normalize_cond(cond, continue_on_true: bool):
    """Resolve the head JUMPI condition to ``counter <cmp> bound``
    (continue direction).  Returns (cmp, counter_expr, bound_expr) or
    None; cmp in {"ULT", "ULE"} — increasing counter shapes only."""
    neg = not continue_on_true
    while isinstance(cond, tuple) and cond[0] == "not":
        neg = not neg
        cond = cond[1]
    if not (isinstance(cond, tuple) and cond[0] == "cmp"):
        return None
    _, k, a, b = cond
    if k not in ("LT", "GT"):
        return None  # signed/EQ shapes: v1 rejects
    # resolve to an unsigned predicate P(x, y) over the operand pair
    if k == "GT":                    # a > b  ==  b < a
        a, b = b, a
    # now: raw predicate is a < b, negated iff neg
    if not neg:
        return ("ULT", a, b)         # continue while a < b
    # !(a < b) == b <= a: continue while b <= a
    return ("ULE", b, a)


def _sym_depth(x) -> Optional[int]:
    return x[1] if isinstance(x, tuple) and x[0] == "sym" else None


def _chain(cfg: CFG, head_bi: int, start_addr: int
           ) -> Optional[List[int]]:
    """Follow the single-successor block chain from ``start_addr``
    back to the head; None when it branches, leaves, or overruns."""
    cur = cfg.block_at.get(start_addr)
    path: List[int] = []
    seen = set()
    while cur is not None and cur != head_bi:
        if cur in seen or len(path) >= _MAX_BODY_BLOCKS:
            return None
        seen.add(cur)
        block = cfg.blocks[cur]
        if block.last.op == "JUMPI":
            return None
        succs = cfg.succ[cur]
        if len(succs) != 1:
            return None
        path.append(cur)
        cur = succs[0]
    return path if cur == head_bi else None


def _recognize_head(cfg: CFG, per_block, head_pc: int
                    ) -> Optional[LoopTemplate]:
    bi = cfg.block_at.get(head_pc)
    if bi is None:
        return None
    head = cfg.blocks[bi]
    if head.instrs[0].op != "JUMPDEST" or head.last.op != "JUMPI":
        return None
    jpc = head.last.pc
    targets = cfg.jump_table.get(jpc)
    if not targets or len(targets) != 1:
        return None
    jump_t = targets[0]
    fall = head.fallthrough
    if fall is None or fall not in cfg.block_at:
        return None

    body = _chain(cfg, bi, jump_t)
    if body is not None and _chain(cfg, bi, fall) is not None:
        return None  # both arms loop back: no exit through this head
    if body is not None:
        continue_pc, exit_pc, continue_on_true = jump_t, fall, True
    else:
        body = _chain(cfg, bi, fall)
        if body is None:
            return None
        continue_pc, exit_pc, continue_on_true = fall, jump_t, False

    # one full iteration: head block, then the body chain
    it = _Interp()
    for ins in head.instrs:
        it.step(ins, is_head_jumpi=(ins is head.instrs[-1]))
    for bix in body:
        for ins in cfg.blocks[bix].instrs:
            it.step(ins)
    if not it.ok or it.cond is None:
        return None
    norm = _normalize_cond(it.cond, continue_on_true)
    if norm is None:
        return None
    cmp_kind, counter_e, bound_e = norm
    dc = _sym_depth(counter_e)
    if dc is None:
        return None
    bound_depth = _sym_depth(bound_e)
    bound_const = bound_e[1] if isinstance(bound_e, tuple) \
        and bound_e[0] == "const" else None
    if bound_depth == dc:
        return None

    # the iteration's net stack effect: counter slot += stride, rest?
    if len(it.stack) != _TRACK:
        return None
    stride = None
    others_unchanged = True
    for idx, expr in enumerate(it.stack):
        depth = len(it.stack) - 1 - idx
        if depth == dc:
            if isinstance(expr, tuple) and expr[0] == "aff" \
                    and expr[1] == dc:
                stride = expr[2]
            continue
        if expr != ("sym", depth):
            others_unchanged = False
    if stride is None or not (0 < stride < _MAX_STRIDE):
        return None
    if bound_depth is not None and bound_depth >= _TRACK:
        return None

    # the exiting evaluation runs the head block ALONE; pure
    # application requires it stack-neutral (entry shape preserved)
    ex = _Interp()
    for ins in head.instrs:
        ex.step(ins, is_head_jumpi=(ins is head.instrs[-1]))
    exit_neutral = (
        ex.ok and len(ex.stack) == _TRACK
        and all(expr == ("sym", len(ex.stack) - 1 - i)
                for i, expr in enumerate(ex.stack))
    )

    # body storage-write footprint (pure paths have none by whitelist)
    writes: Optional[set] = set()
    for bix in body + [bi]:
        summ = per_block.get(cfg.blocks[bix].start) if per_block \
            else None
        w = getattr(summ, "writes", None) if summ is not None else \
            frozenset()
        if w is None:
            writes = None
            break
        writes.update(w)

    pure = bool(it.pure and others_unchanged and exit_neutral
                and it.arith <= 1 and it.need <= 16
                and ex.need <= 16)
    return LoopTemplate(
        head_pc=head_pc,
        head_jumpi_pc=jpc,
        exit_pc=exit_pc,
        continue_pc=continue_pc,
        body_starts=tuple(cfg.blocks[bix].start for bix in body),
        counter_depth=dc,
        stride=stride,
        cmp=cmp_kind,
        bound_depth=bound_depth,
        bound_const=bound_const,
        iter_gas=(it.gas_min, it.gas_max),
        exit_gas=(ex.gas_min, ex.gas_max),
        iter_depth=1,   # one JUMPI arm taken per iteration
        exit_depth=1,   # the exiting JUMPI arm
        iter_instrs=it.instrs,
        need_height=max(it.need, ex.need, dc + 1,
                        (bound_depth + 1) if bound_depth is not None
                        else 0),
        pure=pure,
        storage_writes=tuple(sorted(writes)) if writes else (),
    )


def recognize(cfg: CFG, per_block, loop_heads
              ) -> Tuple[LoopTemplate, ...]:
    """All recognized counter-loop templates of a code (called once
    per memoized code hash from static_pass.analyze)."""
    out: List[LoopTemplate] = []
    for head_pc in sorted(loop_heads)[:_MAX_TEMPLATES]:
        try:
            t = _recognize_head(cfg, per_block, head_pc)
        except Exception as e:  # recognition is a refinement
            log.debug("loop recognition failed at %d: %s", head_pc, e)
            t = None
        if t is not None:
            out.append(t)
    return tuple(out)


# ---------------------------------------------------------------------------
# template lookup
# ---------------------------------------------------------------------------


def templates_for(info) -> Tuple[LoopTemplate, ...]:
    return tuple(getattr(info, "loop_templates", ()) or ())


def template_at_head(info, byte_pc: int) -> Optional[LoopTemplate]:
    for t in templates_for(info):
        if t.head_pc == byte_pc:
            return t
    return None


def template_at_jumpi(info, byte_pc: int) -> Optional[LoopTemplate]:
    for t in templates_for(info):
        if t.head_jumpi_pc == byte_pc:
            return t
    return None


# ---------------------------------------------------------------------------
# closed form + the one-query verification
# ---------------------------------------------------------------------------


def predict(t: LoopTemplate, c0: int, bound: int
            ) -> Optional[Tuple[int, int]]:
    """(iteration count, exit counter value) for a concrete instance,
    or None when the side conditions exclude it (counter wrap — the
    caller degrades to unrolling).  The Python arithmetic here is the
    integer-exact twin of the BV closed form _verify proves."""
    s = t.stride
    if t.cmp == "ULT":
        if bound > WORD - s:
            return None
        if not c0 < bound:
            return (0, c0)
        n = (bound - 1 - c0) // s + 1
    else:  # ULE
        if bound > WORD - 1 - s:
            return None
        if not c0 <= bound:
            return (0, c0)
        n = (bound - c0) // s + 1
    return (n, (c0 + n * s) & _MASK)


def _verify_query(t: LoopTemplate, code_hash: str, bound: int):
    """Build the one refutation query for an instance class: side
    conditions + entry condition + NOT(closed-form claims), with the
    bound pinned concrete and the entry counter SYMBOLIC.  UNSAT
    proves the closed form for every entry value of this loop at this
    bound (the per-instance Python ``predict`` is the same formula
    over concrete values).  The bound is substituted rather than left
    symbolic deliberately: the fully-universal query is a hard
    bit-blast (measured 10-60s+) while the pinned one discharges in
    well under a second, and application only ever serves
    runtime-concrete bounds anyway."""
    from ...smt import terms as T

    tag = "lsum_%s_%d" % (code_hash[:12], t.head_pc)
    i = T.bv_var(tag + "_i", 256)
    b = T.bv_const(bound, 256)
    s = T.bv_const(t.stride, 256)
    one = T.bv_const(1, 256)
    zero = T.bv_const(0, 256)

    if t.cmp == "ULT":
        entry = T.mk_ult(i, b)
        n = T.mk_add(T.mk_udiv(T.mk_sub(T.mk_sub(b, one), i), s), one)
        side = T.mk_ule(b, T.bv_const(WORD - t.stride, 256))

        def cont(x):
            return T.mk_ult(x, b)
    else:
        entry = T.mk_ule(i, b)
        n = T.mk_add(T.mk_udiv(T.mk_sub(b, i), s), one)
        side = T.mk_ule(b, T.bv_const(WORD - 1 - t.stride, 256))

        def cont(x):
            return T.mk_ule(x, b)

    last = T.mk_add(i, T.mk_mul(T.mk_sub(n, one), s))
    exitv = T.mk_add(last, s)
    claim = T.mk_bool_and(
        T.mk_not(T.mk_eq(n, zero)),      # at least one iteration runs
        T.mk_not(cont(exitv)),           # the exit value fails the test
        cont(last),                      # the last iteration entered
        T.mk_ule(i, last),               # accumulated stride: no wrap
        T.mk_ule(last, exitv),           # final stride: no wrap
    )
    return [side, entry, T.mk_not(claim)]


#: (code_hash, head_pc, bound) -> verified bool: one solver query per
#: instance class per process (cross-process reuse rides the verdict
#: cache the query itself populates)
_VERIFIED: Dict[Tuple[str, int, int], bool] = {}
#: (code_hash, head_pc) -> distinct bounds attempted; an adversarial
#: contract walking the bound through fresh values must not buy a
#: fresh solver query per iteration family
_ATTEMPTS: Dict[Tuple[str, int], int] = {}
_MAX_BOUND_ATTEMPTS = 8
_VERIFIED_CAP = 4096
_VERIFY_LOCK = threading.Lock()


def verified_instance(info, t: LoopTemplate,
                      bound: Optional[int] = None) -> bool:
    """Is the closed form solver-verified for this instance class
    (this loop at this concrete bound)?  Lazily runs (and caches) the
    one discharge query; any non-UNSAT outcome or error REJECTS — the
    instance keeps unrolling."""
    if not t.pure:
        return False
    b = t.bound_const if t.bound_const is not None else bound
    if b is None:
        return False
    key = (info.code_hash, t.head_pc, b)
    akey = (info.code_hash, t.head_pc)
    with _VERIFY_LOCK:
        cached = _VERIFIED.get(key)
        if cached is None:
            if _ATTEMPTS.get(akey, 0) >= _MAX_BOUND_ATTEMPTS \
                    or len(_VERIFIED) >= _VERIFIED_CAP:
                return False
            _ATTEMPTS[akey] = _ATTEMPTS.get(akey, 0) + 1
    if cached is not None:
        return cached
    ok = False
    try:
        from ...smt.solver import batch

        query = _verify_query(t, info.code_hash, b)
        verdict = batch.discharge([query],
                                  timeout_s=_VERIFY_TIMEOUT_S)[0]
        ok = verdict == batch.UNSAT
    except Exception as e:
        log.debug("loop-summary verification errored at %d: %s",
                  t.head_pc, e)
        ok = False
    with _VERIFY_LOCK:
        prior = _VERIFIED.get(key)
        if prior is not None:
            return prior
        _VERIFIED[key] = ok
    try:
        from ...smt.solver.solver_statistics import SolverStatistics

        if ok:
            SolverStatistics().bump(loop_summaries_verified=1)
        else:
            SolverStatistics().bump(loop_summaries_rejected=1)
    except Exception:
        pass
    log.info("loop summary at %d bound=%d (%s): %s", t.head_pc, b,
             info.code_hash[:12], "verified" if ok else "rejected")
    return ok


def reset_for_tests() -> None:
    """Drop the process-wide verification registry (bench/tests re-run
    counter gates on fresh state)."""
    with _VERIFY_LOCK:
        _VERIFIED.clear()
        _ATTEMPTS.clear()


def summarizable_heads(info) -> FrozenSet[int]:
    """Head byte pcs with a pure template (the device park plane keys
    on this; verification is per applied instance — see
    verified_instance)."""
    if info is None:
        return frozenset()
    return frozenset(t.head_pc for t in templates_for(info) if t.pure)


def device_park_pcs(info):
    """(length+1,) bool plane marking summarizable heads, or None when
    the layer is off / nothing to mark.  Ships to device as the
    CompiledCode ``loopsum_park`` column: lanes arriving at a marked
    JUMPDEST park (NEEDS_HOST) so the host applies the verified
    summary instead of the device unrolling the loop.  An instance
    the host then declines annotates its state (LoopsumDecline) and
    the sweep keeps that family off the device."""
    if not enabled() or info is None:
        return None
    heads = summarizable_heads(info)
    if not heads:
        return None
    import numpy as np

    plane = np.zeros(info.length + 1, dtype=bool)
    for pc in heads:
        if pc <= info.length:
            plane[pc] = True
    return plane


# ---------------------------------------------------------------------------
# host application
# ---------------------------------------------------------------------------


class LoopsumDecline:
    """State annotation: a verified-head summary declined for this
    state (symbolic counter/bound, annotated operands, projected OOG).
    The family unrolls host-side; svm's lane sweep keeps it off the
    device so parked-at-head round trips don't repeat per iteration."""

    # StateAnnotation protocol (laser/state/annotation.py) by duck
    # typing — importing the laser package here would defeat the
    # static pass's light-import contract
    persist_to_world_state = False
    persist_over_calls = False
    search_importance = 1

    def __copy__(self):
        return self

    def __deepcopy__(self, memo=None):
        return self


def _decline(gs) -> str:
    try:
        if not any(isinstance(a, LoopsumDecline)
                   for a in gs.annotations):
            gs.annotate(LoopsumDecline())
    except Exception:
        pass
    return "declined"


def state_declined(gs) -> bool:
    try:
        return any(isinstance(a, LoopsumDecline)
                   for a in gs.annotations)
    except Exception:
        return False


def _concrete_operand(x) -> Optional[int]:
    """Concrete value of a stack entry, or None; entries carrying
    annotations are treated as symbolic (unrolling may propagate the
    annotation into a detector — summarization must not drop it)."""
    if isinstance(x, int):
        return x
    try:
        if getattr(x, "annotations", None):
            return None
        return x.value
    except Exception:
        return None


def maybe_apply(gs, loop_bound: Optional[int] = None
                ) -> Optional[str]:
    """Apply a verified summary to a state sitting at a loop-head
    JUMPDEST.  Returns:

    * ``"applied"`` — the state now sits at the loop exit with the
      summarized counter/gas/depth effects (bit-identical to full
      unrolling of this concrete instance);
    * ``"retire"``  — the instance iterates past the loop bound: the
      caller drops the state exactly like the bounded-loops prune,
      without executing ``bound+1`` iterations first;
    * ``"declined"`` — summary exists but cannot serve this instance
      (state annotated; degrade to unrolling);
    * ``None`` — no verified summary at this pc (nothing to do).
    """
    if not enabled():
        return None
    try:
        from . import info_for_code_obj

        info = info_for_code_obj(gs.environment.code)
    except Exception:
        return None
    if info is None or not templates_for(info):
        return None
    try:
        ilist = gs.environment.code.instruction_list
        pc = gs.mstate.pc
        if pc >= len(ilist):
            return None
        byte_pc = ilist[pc]["address"]
    except Exception:
        return None
    t = template_at_head(info, byte_pc)
    if t is None or not t.pure:
        return None

    ms = gs.mstate
    stack = ms.stack
    if len(stack) < t.need_height:
        return _decline(gs)
    c0 = _concrete_operand(stack[-1 - t.counter_depth])
    if c0 is None:
        return _decline(gs)
    if t.bound_const is not None:
        bound = t.bound_const
    else:
        if t.bound_depth is None:
            return _decline(gs)
        bound = _concrete_operand(stack[-1 - t.bound_depth])
        if bound is None:
            return _decline(gs)
    # every trusted summary is backed by a recorded solver
    # verification of its instance class (memoized; the query's UNSAT
    # proof lands in the run-wide verdict cache)
    if not verified_instance(info, t, bound):
        return _decline(gs)
    pred = predict(t, c0, bound)
    if pred is None:
        return _decline(gs)
    n, exit_value = pred

    # the loop bound's prune regime: what unrolling would do is burn
    # eff_bound+1 iterations and then drop the state — skip straight
    # to the drop (creation code gets the strategy's higher bound)
    eff_bound = loop_bound
    if eff_bound is not None:
        try:
            from ...laser.transaction import ContractCreationTransaction

            if isinstance(gs.current_transaction,
                          ContractCreationTransaction):
                eff_bound = max(128, eff_bound)
        except Exception:
            pass
    if eff_bound is not None and n > eff_bound:
        _bump(loops_summarized_lanes=1,
              unroll_iters_saved=eff_bound + 1)
        return "retire"

    # projected out-of-gas mid-loop raises inside the unrolled run
    # (an exception path we must not silently skip) — decline
    gmin = ms.min_gas_used + n * t.iter_gas[0] + t.exit_gas[0]
    try:
        if gmin > ms.gas_limit:
            return _decline(gs)
        txg = getattr(gs.current_transaction, "gas_limit", None)
        txg = getattr(txg, "value", txg)
        if isinstance(txg, int) and gmin >= txg:
            return _decline(gs)
    except Exception:
        return _decline(gs)

    try:
        from ...laser import util as laser_util

        exit_idx = laser_util.get_instruction_index(ilist, t.exit_pc)
    except Exception:
        exit_idx = None
    if exit_idx is None:
        return _decline(gs)

    # ---- commit ----------------------------------------------------
    if n:
        from ...smt import symbol_factory

        stack[-1 - t.counter_depth] = symbol_factory.BitVecVal(
            exit_value, 256)
    ms.min_gas_used = gmin
    ms.max_gas_used += n * t.iter_gas[1] + t.exit_gas[1]
    ms.depth += n * t.iter_depth + t.exit_depth
    ms.pc = exit_idx
    _bump(loops_summarized_lanes=1, unroll_iters_saved=n)
    log.debug("loop summary applied at %d: n=%d exit=%d", byte_pc, n,
              exit_value)
    return "applied"


def apply_to_states(states, loop_bound: Optional[int] = None):
    """Summary application over a worklist batch (the lane path's
    parked-state return seam): applied states move to their loop
    exits, retired ones drop, declined ones annotate and stay."""
    if not enabled() or not states:
        return states
    out = []
    for gs in states:
        try:
            action = maybe_apply(gs, loop_bound)
        except Exception as e:  # application is an optimization
            log.debug("loop-summary application failed: %s", e)
            action = None
        if action == "retire":
            continue
        out.append(gs)
    return out


def _bump(**deltas) -> None:
    try:
        from ...smt.solver.solver_statistics import SolverStatistics

        SolverStatistics().bump(**deltas)
    except Exception:
        pass
