"""Static bytecode pre-analysis (docs/static_pass.md).

One pass per code hash, before (and independent of) symbolic
execution: basic-block recovery with a push-data-aware JUMPDEST table,
a conservative CFG with value-set jump resolution, backward
reachability of detector-relevant sites as a per-PC uint32 mask plane,
dominator/SCC loop-head detection, and block-level storage-slot
summaries. Consumers:

* the lane engine retires lanes whose remaining reachable-detector
  mask is dead at the window boundary (``statically_retired``) and
  consults the jump table before handing a symbolic-dest JUMP park to
  the host interpreter;
* svm applies the same mask test to parked states at the sweep
  boundary (the host-side twin of the window seam);
* the bounded-loops strategy skips its trailing-cycle scan at
  JUMPDESTs that cannot lie on any cycle;
* the dependency pruner answers wake-up probes by concrete
  set-disjointness against reachable read slots;
* migration batches ship the memoized results like verdict sidecars.

The taint/dependence dataflow layer (dataflow.py, taint.py,
selectors.py, deps.py — PR 8) rides the same pass and sidecars:

* ``refined_plane`` refines the reach mask per active-module set —
  anchor sites whose trigger operands are provably
  attacker-independent stop counting, so lanes retire earlier through
  the SAME seams;
* the recovered selector map + per-function storage dependence hand
  svm's transaction sequencer a static independence relation
  (``static_tx_prunes``) and the dependency pruner an interprocedural
  fast path;
* complete write summaries open the static fact gate: bounded
  storage-ITE chains seed the propagation pass and hint Z3
  (``static_facts_seeded``).

Gates: ``MTPU_STATIC`` (default on; ``=0`` restores pre-pass behavior
bit-for-bit — no analysis runs, every consumer falls back) and
``MTPU_TAINT`` (default on; ``=0`` keeps the PR-7 pass but disables
every taint/dependence consumer bit-for-bit).
"""

import logging
import os
from typing import Dict, FrozenSet, List, NamedTuple, Optional, Tuple

import numpy as np

from . import blocks as blocks_mod
from . import cfg as cfg_mod
from . import loops as loops_mod
from . import memo
from . import reach as reach_mod
from . import summaries as summaries_mod


def _lazy_taint_mods():
    """taint/selectors/deps import lazily: they import this package's
    gate helpers back, and the base pass must stay importable even if
    the dataflow layer ever grows heavier deps."""
    from . import deps as deps_mod
    from . import selectors as selectors_mod
    from . import taint as taint_mod

    return taint_mod, selectors_mod, deps_mod
from .reach import (  # noqa: F401  (re-exported consumer API)
    ALL_BITS,
    MODULE_ANCHORS,
    OP_BITS,
    TERMINATOR_BIT,
    active_mask_for_modules,
    bits_for_ops,
)

log = logging.getLogger(__name__)

#: tri-state override for tests/bench (None = read MTPU_STATIC)
FORCE: Optional[bool] = None

#: tri-state override for the taint/dependence layer (None = read
#: MTPU_TAINT)
FORCE_TAINT: Optional[bool] = None

#: codes beyond this many bytes skip the pass (the fixpoints are
#: linear-ish but the mask plane and VSA state are per-pc/per-block;
#: nothing in the corpus comes close)
MAX_CODE_BYTES = 1 << 20


def enabled() -> bool:
    """The MTPU_STATIC gate (default on)."""
    if FORCE is not None:
        return FORCE
    return os.environ.get("MTPU_STATIC", "1") != "0"


def taint_enabled() -> bool:
    """The MTPU_TAINT gate (default on; requires the base pass)."""
    if not enabled():
        return False
    if FORCE_TAINT is not None:
        return FORCE_TAINT
    return os.environ.get("MTPU_TAINT", "1") != "0"


class StaticInfo(NamedTuple):
    code_hash: str
    length: int
    n_blocks: int
    block_starts: Tuple[int, ...]
    #: jump/jumpi byte pc -> resolved target tuple | None (unresolved)
    jump_table: Dict[int, Optional[Tuple[int, ...]]]
    jumps_resolved: int
    jumps_total: int
    #: (length+1,) uint32 per-PC reachable-anchor mask (reach.OP_BITS
    #: bits + TERMINATOR_BIT); non-instruction offsets hold ALL_BITS
    reach_mask: np.ndarray
    #: JUMPDESTs that can lie on a cycle (SCC membership)
    cycle_pcs: FrozenSet[int]
    #: dominator back-edge targets (reducible loop heads)
    loop_heads: FrozenSet[int]
    complete: bool
    #: block start -> BlockSummary (summaries_mod)
    block_summaries: Dict[int, object]
    #: block start -> complete concrete reachable SLOAD slots | None
    reach_reads: Dict[int, Optional[FrozenSet[int]]]
    #: block start -> CALL-family op reachable
    reach_calls: Dict[int, bool]
    #: whole-code complete concrete read-slot union | None
    all_read_slots: Optional[FrozenSet[int]]
    #: block start pc for every instruction pc (mask-plane consumers
    #: index per-pc; summary consumers index per-block)
    block_of_pc: Dict[int, int]
    # -- taint/dependence layer (PR 8; all plain picklable data, rides
    # -- the same memo + migration sidecar) ---------------------------
    #: the conservative CFG itself (plain namedtuples; refined planes
    #: rebuild from it per active-module set)
    cfg: object = None
    #: byte pc -> taint.SiteTaint for every JUMP/JUMPI site
    site_taints: Dict[int, object] = {}
    #: taint fixpoint converged (False => refine nothing)
    taint_converged: bool = False
    #: recovered selector (uint32) -> function entry byte pc
    selector_map: Dict[int, int] = {}
    #: function entry byte pc -> deps.FunctionDeps
    func_deps: Dict[int, object] = {}
    #: whole-code complete write-slot union | None
    all_write_slots: Optional[FrozenSet[int]] = None
    #: every SSTORE slot AND value proved concrete (fact-seeding gate)
    writes_complete: bool = False
    # -- verified closed-form loop summaries (PR 12; loop_summary.py,
    # -- MTPU_LOOPSUM — plain picklable templates, verification state
    # -- stays process-local beside the solver) ----------------------
    #: recognized counter-loop templates (loop_summary.LoopTemplate)
    loop_templates: Tuple[object, ...] = ()

    def mask_at(self, byte_pc: int, plane=None) -> int:
        table = self.reach_mask if plane is None else plane
        if 0 <= byte_pc < table.shape[0]:
            return int(table[byte_pc])
        return int(reach_mod._gen_bits("STOP"))  # past-end implicit STOP

    def block_start_of(self, byte_pc: int) -> Optional[int]:
        return self.block_of_pc.get(byte_pc)


def analyze(code: bytes) -> StaticInfo:
    """Run the full pass on raw runtime bytecode (unconditional — the
    MTPU_STATIC gate lives in info_for)."""
    blocks, block_at = blocks_mod.recover_blocks(code)
    jumpdests = blocks_mod.valid_jumpdests(code)
    cfg = cfg_mod.build_cfg(code, blocks, block_at, jumpdests)
    mask = reach_mod.reach_mask(code, cfg)
    per_block = summaries_mod.summarize_blocks(cfg)
    agg = summaries_mod.aggregate(cfg, per_block)
    block_of_pc: Dict[int, int] = {}
    for b in blocks:
        for ins in b.instrs:
            block_of_pc[ins.pc] = b.start
    resolved = sum(1 for t in cfg.jump_table.values() if t is not None)
    # the taint/dependence layer (computed unconditionally — pure in
    # the code bytes, memoized with the rest; every CONSUMER is gated
    # by MTPU_TAINT so =0 stays bit-for-bit off)
    taint_mod, selectors_mod, deps_mod = _lazy_taint_mods()
    try:
        sites, converged = taint_mod.analyze(cfg)
    except Exception as e:  # a refinement, never an error path
        log.debug("taint fixpoint failed (%s); refining nothing", e)
        sites, converged = {}, False
    try:
        selector_map = selectors_mod.recover(cfg)
        func_deps = deps_mod.analyze(cfg, per_block, selector_map)
    except Exception as e:
        log.debug("selector/deps recovery failed (%s)", e)
        selector_map, func_deps = {}, {}
    # counter-loop templates (loop_summary.py) — recognition is pure
    # static data like the taint products; verification (the one
    # solver query per loop) stays lazy at the consumer seams so the
    # MTPU_LOOPSUM=0 path never touches the solver
    loop_heads = loops_mod.loop_heads(cfg)
    try:
        from . import loop_summary as loopsum_mod

        loop_templates = loopsum_mod.recognize(cfg, per_block,
                                               loop_heads)
    except Exception as e:
        log.debug("loop-summary recognition failed (%s)", e)
        loop_templates = ()
    info = StaticInfo(
        code_hash=memo.code_hash(code),
        length=len(code),
        n_blocks=len(blocks),
        block_starts=tuple(b.start for b in blocks),
        jump_table=dict(cfg.jump_table),
        jumps_resolved=resolved,
        jumps_total=len(cfg.jump_table),
        reach_mask=mask,
        cycle_pcs=loops_mod.cycle_pcs(cfg),
        loop_heads=loop_heads,
        complete=cfg.complete,
        block_summaries=per_block,
        reach_reads=agg.reach_reads,
        reach_calls=agg.reach_calls,
        all_read_slots=agg.all_read_slots,
        block_of_pc=block_of_pc,
        cfg=cfg,
        site_taints=sites,
        taint_converged=converged,
        selector_map=selector_map,
        func_deps=func_deps,
        all_write_slots=agg.all_write_slots,
        writes_complete=agg.writes_complete,
        loop_templates=loop_templates,
    )
    return info


def info_for(code: bytes) -> Optional[StaticInfo]:
    """Gated + memoized entry point every consumer goes through."""
    if not enabled() or not code or len(code) > MAX_CODE_BYTES:
        return None
    key = memo.code_hash(code)
    info = memo.get(key)
    if info is None:
        try:
            from ...support.telemetry import trace

            with trace.span("static.analyze", code_len=len(code)):
                info = analyze(code)
        except Exception as e:  # a screen, never an error path
            log.warning("static pass failed (%s); consumers fall back",
                        e)
            return None
        memo.put(key, info)
        try:
            from ...smt.solver.solver_statistics import SolverStatistics

            SolverStatistics().bump(
                static_blocks=info.n_blocks,
                static_jumps_resolved=info.jumps_resolved)
        except Exception:
            pass
        log.info(
            "static pass: %d blocks, %d/%d jumps resolved, %d cycle "
            "pcs (%s)", info.n_blocks, info.jumps_resolved,
            info.jumps_total, len(info.cycle_pcs), key[:12])
    return info


def code_bytes_of(code_obj) -> Optional[bytes]:
    """Concrete runtime bytes of a Disassembly-like object, or None
    (symbolic runtime code from a creation tx). Lightweight twin of
    lane_engine.code_to_bytes — this module must be importable without
    jax."""
    raw = getattr(code_obj, "bytecode", code_obj)
    if isinstance(raw, bytes):
        return raw
    if isinstance(raw, str):
        try:
            return bytes.fromhex(raw.replace("0x", ""))
        except ValueError:
            return None
    return None


def info_for_code_obj(code_obj) -> Optional[StaticInfo]:
    """info_for keyed through a host Disassembly, memoized ON the
    object — per-state consumers (strategy pops, pruner hooks) cannot
    afford a content hash per call."""
    cached = getattr(code_obj, "_mtpu_static_info", _MISSING)
    if cached is not _MISSING:
        return cached if enabled() else None
    info = None
    if enabled():
        code = code_bytes_of(code_obj)
        if code:
            info = info_for(code)
    try:
        code_obj._mtpu_static_info = info
    except Exception:
        pass
    return info


_MISSING = object()


def cycle_pcs_for(code_obj) -> Optional[FrozenSet[int]]:
    """The bounded-loops strategy's cycle-candidate set, or None when
    the pass is off/unavailable (caller keeps its unfiltered scan)."""
    info = info_for_code_obj(code_obj)
    return info.cycle_pcs if info is not None else None


# -- taint-refined reach planes (docs/static_pass.md) ------------------------

#: (code_hash, frozenset(module names)) -> refined per-PC plane; a run
#: uses ONE module set, so this stays a handful of entries per code
_REFINED: Dict[tuple, np.ndarray] = {}
_REFINED_CAP = 512


def refined_plane(info: StaticInfo, module_names) -> Optional[np.ndarray]:
    """The taint-refined reach plane for an active-module set, or None
    when refinement cannot serve it (taint off, fixpoint not
    converged, or a module with unknown anchor semantics). Memoized
    per (code, module set); a fresh build bumps ``taint_mask_drops``
    by the number of anchor sites whose gen bits dropped."""
    if not taint_enabled() or info is None or not info.taint_converged \
            or info.cfg is None:
        return None
    names = frozenset(str(n) for n in module_names)
    if not reach_mod.refinable(names):
        return None
    key = (info.code_hash, names)
    plane = _REFINED.get(key)
    if plane is None:
        try:
            drops = reach_mod.refinement_drops(
                info.cfg, info.site_taints, names)
        except Exception as e:
            log.debug("refinement drops failed (%s)", e)
            return None
        if not drops:
            plane = info.reach_mask
        else:
            plane = reach_mod.reach_mask(
                bytes(info.length), info.cfg, drops)
            try:
                from ...smt.solver.solver_statistics import (
                    SolverStatistics,
                )

                SolverStatistics().bump(taint_mask_drops=len(drops))
            except Exception:
                pass
            log.info("taint refinement dropped %d anchor sites (%s)",
                     len(drops), info.code_hash[:12])
        if len(_REFINED) >= _REFINED_CAP:
            _REFINED.pop(next(iter(_REFINED)))
        _REFINED[key] = plane
    return plane


# -- host-side state screen (svm's twin of the window-boundary retire) ------


def _pending_potential_issues(gs) -> bool:
    try:
        from ..potential_issues import PotentialIssuesAnnotation

        for a in gs.annotations:
            if isinstance(a, PotentialIssuesAnnotation) \
                    and a.potential_issues:
                return True
    except Exception:
        return True  # cannot prove clean: keep the state
    return False


def state_retirable(gs, active_mask: int, final_tx: bool,
                    info: Optional[StaticInfo] = None,
                    module_names=None) -> bool:
    """Would retiring this mid-transaction state lose any analysis
    value? True only when provably not: no active detector's anchor
    site is reachable from its pc, AND either no open-state terminator
    (STOP/RETURN/SELFDESTRUCT) is reachable or no later round consumes
    open states (final_tx) with nothing pending on the state. Applies
    to top-level message-call states only. ``module_names`` (the
    active detection modules) swaps in the taint-refined plane for
    the state's own code when refinement can serve that set."""
    try:
        tx_stack = gs.transaction_stack
        if len(tx_stack) != 1 or tx_stack[-1][1] is not None:
            return False
        from ...laser.transaction import MessageCallTransaction

        if not isinstance(tx_stack[-1][0], MessageCallTransaction):
            return False
        if info is None:
            info = info_for_code_obj(gs.environment.code)
        if info is None:
            return False
        plane = None
        if module_names is not None:
            plane = refined_plane(info, module_names)
        ilist = gs.environment.code.instruction_list
        pc = gs.mstate.pc
        byte_pc = ilist[pc]["address"] if pc < len(ilist) else info.length
        mask = info.mask_at(byte_pc, plane)
        if mask & int(active_mask):
            return False
        if mask & int(TERMINATOR_BIT):
            if not final_tx or _pending_potential_issues(gs):
                return False
        return True
    except Exception:
        return False


def screen_states(states: List, active_mask: int, final_tx: bool,
                  counter_hook=None, module_names=None) -> List:
    """Drop statically-dead states from a host worklist batch; bumps
    the run-wide static_retired_lanes counter."""
    if not enabled() or not states:
        return states
    out = [gs for gs in states
           if not state_retirable(gs, active_mask, final_tx,
                                  module_names=module_names)]
    dropped = len(states) - len(out)
    if dropped:
        try:
            from ...smt.solver.solver_statistics import SolverStatistics

            SolverStatistics().bump(static_retired_lanes=dropped)
        except Exception:
            pass
        log.info("static screen retired %d host states", dropped)
        if counter_hook is not None:
            counter_hook(dropped)
    return out
