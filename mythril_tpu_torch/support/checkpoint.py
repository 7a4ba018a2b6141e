"""Transaction-boundary checkpoint/resume for long analyses.

The reference ships nothing comparable (SURVEY §5 lists checkpoint/
resume as worth adding; an interrupted multi-hour audit restarts from
zero there).  This build checkpoints at the natural boundary — after
each completed symbolic transaction round — which is where the engine
state collapses to a serializable core:

* the open WorldStates (account storage/code, balances, constraints,
  transaction sequences);
* the keccak function manager's tracked hashes (axioms regenerate from
  them at the next solve);
* the transaction-id counter (fresh symbols on resume never collide
  with checkpointed ones);
* each detection module's issues and dedup cache, so resumed runs
  neither lose nor double-report findings;
* (v4, docs/checkpoint.md) an optional **in-flight lane plane**: live
  GlobalStates mid-transaction — per-lane PC, call frame, stack,
  memory, storage slot tables, gas intervals, path constraints and
  pending PotentialIssues/promotions all ride the same flat term
  table.  A resumed run finishes the interrupted round from them
  before the normal round loop continues (laser/svm.py resume_exec),
  which is what lets work stealing split *any* wave (not just drained
  worklists), lets a SIGTERM'd rank re-enter the queue as resumable
  work, and lets ``myth analyze --resume`` continue a crashed run
  from its last window boundary.

Term DAGs are serialized as a FLAT topologically-ordered node table
(terms pickle as table references), so arbitrarily deep constraint /
storage chains — precisely what long loop-heavy analyses build — never
touch Python's recursion limit; on load the table re-interns in order,
preserving hash-consing and structural sharing.

Snapshots are bound to the analyzed code: a wrapper only resumes from
a snapshot whose code identity matches, so multi-contract runs sharing
one --checkpoint file ignore each other's state.

Dropped on save (documented limitations): CFG/statespace node graphs
(`requires_statespace` consumers re-run without them) and on-chain
dynamic loaders (an RPC session cannot be pickled; resumed storage
reads fall back to symbolic).
"""

import io
import logging
import os
import pickle
import tempfile
from typing import Any, Dict, Optional

from ..smt import terms as T
from .telemetry import trace

log = logging.getLogger(__name__)

#: v4: optional in-flight GlobalState payload ("inflight") + detection-
#: module persistent ids. Loads REJECT other versions (resume falls
#: back to a fresh run — skew-safe, never a crash): a v3 snapshot's
#: states would restore, but its pickled PotentialIssue.detector
#: references would duplicate module singletons.
VERSION = 4

#: v5: the body is a state_codec frame — ONE shared term table for the
#: whole snapshot with every open/in-flight state delta-encoded
#: against a codec-chosen reference state (docs/state_codec.md).
#: Written only when the codec gate is on (MTPU_CODEC, default on;
#: =0 writes v4 bit-for-bit); loads accept BOTH versions regardless of
#: the gate — reading what is on disk is a correctness obligation.  A
#: corrupt/skewed v5 body drops WHOLE (fresh run), like any other
#: malformed snapshot.
VERSION_CODEC = 5

#: observability: how many loads resumed vs fell back to fresh runs
RESUME_STATS = {"loaded": 0, "failed": 0}


def live_enabled() -> bool:
    """The live-checkpoint master gate (MTPU_CKPT, default on; "0"
    restores pre-checkpoint behavior bit-for-bit): mid-flight wave
    splitting over the migration bus, the SIGTERM/fatal resume dump,
    and the corpus per-contract checkpoint wiring all stand down when
    off. Round-boundary checkpoints requested explicitly via
    --checkpoint are NOT gated — the caller asked for them."""
    return os.environ.get("MTPU_CKPT", "1") != "0"


def code_identity(contract) -> str:
    """The code binding snapshots carry: multi-contract runs sharing
    one checkpoint file (or migration batches crossing ranks) must
    never resume each other's state."""
    from hashlib import sha256

    return sha256(
        (contract.creation_code or contract.code or "").encode()
    ).hexdigest()

#: load-time table of saved-tid -> re-interned Term (set around the
#: payload unpickling; term references resolve through it)
_LOAD_TERMS: Dict[int, "T.Term"] = {}


def _term_ref(tid):
    return _LOAD_TERMS[tid]


class _Pickler(pickle.Pickler):
    """Payload pickler: terms serialize as flat table references (the
    table itself is written separately, in topological order), so deep
    DAGs never recurse."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.roots: Dict[int, "T.Term"] = {}

    def reducer_override(self, obj):
        if isinstance(obj, T.Term):
            self.roots[obj.tid] = obj
            return (_term_ref, (obj.tid,))
        return NotImplemented

    def persistent_id(self, obj):
        # CFG nodes chain into the whole explored statespace; dynamic
        # loaders hold live RPC sessions — both are dropped. Detection
        # modules (referenced by in-flight states' pending
        # PotentialIssues) serialize by NAME: the loading process
        # resolves them against its own module singletons, so a
        # shipped candidate issue lands on the thief's detector
        # instead of a deep-pickled duplicate of the victim's.
        from ..analysis.module.base import DetectionModule
        from ..laser.cfg import Node
        from .loader import DynLoader

        if isinstance(obj, Node):
            return "node"
        if isinstance(obj, DynLoader):
            return "dynld"
        if isinstance(obj, DetectionModule):
            return ("module", type(obj).__name__)
        return None


class _Unpickler(pickle.Unpickler):
    def persistent_load(self, pid):
        if isinstance(pid, tuple) and pid and pid[0] == "module":
            from ..analysis.module.loader import ModuleLoader

            for module in ModuleLoader().get_detection_modules():
                if type(module).__name__ == pid[1]:
                    return module
            return None  # module set differs: candidate is dropped
        return None  # nodes / dynloaders restore as absent


def _dag_rows(roots, seen=None):
    """Iterative post-order over the term DAG: every node's row comes
    after its arguments' rows.  `seen` pre-seeds the visited set with
    tids an external base table already carries (state_codec frames
    referencing another file's table emit only the rows they add)."""
    rows = []
    seen = set() if seen is None else seen
    stack = [(t, False) for t in roots]
    while stack:
        t, emit = stack.pop()
        if emit:
            rows.append((t.tid, t.op,
                         tuple(a.tid for a in t.args),
                         t.params, t.width, t.val, t.name))
            continue
        if t.tid in seen:
            continue
        seen.add(t.tid)
        stack.append((t, True))
        stack.extend((a, False) for a in t.args)
    return rows


def _intern_rows(rows) -> Dict[int, "T.Term"]:
    by: Dict[int, T.Term] = {}
    for tid, op, arg_tids, params, width, val, name in rows:
        by[tid] = T._intern(
            op, tuple(by[a] for a in arg_tids), params, width, val,
            name)
    return by


def _keccak_state() -> Dict[str, Any]:
    from ..laser.function_managers import keccak_function_manager as km

    return {
        "widths": {
            w: {"symbolic_inputs": list(m.symbolic_inputs),
                "results": list(m.results)}
            for w, m in km._widths.items()
        },
        "concrete_hashes": dict(km.concrete_hashes),
        "quick_inverse": dict(km.quick_inverse),
    }


def _module_state() -> Dict[str, Any]:
    from ..analysis.module.loader import ModuleLoader

    out = {}
    for module in ModuleLoader().get_detection_modules():
        out[type(module).__name__] = {
            "issues": list(module.issues),
            "cache": set(module.cache),
        }
    return out


def dump_with_terms(stream, obj) -> None:
    """Term-safe pickling of an arbitrary object graph to a stream:
    Terms serialize as flat-table references exactly as checkpoints do
    (migration results carry Issue objects whose fields may reference
    terms)."""
    body = io.BytesIO()
    pickler = _Pickler(body, protocol=pickle.HIGHEST_PROTOCOL)
    pickler.dump(obj)
    pickle.dump(_dag_rows(pickler.roots.values()), stream,
                protocol=pickle.HIGHEST_PROTOCOL)
    stream.write(body.getvalue())


def load_with_terms(stream):
    """Inverse of dump_with_terms."""
    global _LOAD_TERMS

    rows = pickle.load(stream)
    _LOAD_TERMS = _intern_rows(rows)
    try:
        return _Unpickler(stream).load()
    finally:
        _LOAD_TERMS = {}


def save_verdict_sidecar(path, entries, table_from=None) -> bool:
    """Atomically write a migration batch's verdict-cache sidecar:
    ``(ordered terms, verdict, model)`` triples from
    VerdictCache.export_entries, term-safe pickled (the terms travel as
    flat-table rows and re-intern on the thief — fingerprints are
    process-local tids and must re-derive there). With the state codec
    on, the sidecar is a codec frame; ``table_from`` names a sibling
    codec payload (the offer batch) whose term table the sidecar
    REFERENCES instead of re-shipping — its entries' terms are mostly
    the shipped states' constraint prefixes, so the sidecar carries
    only the rows it adds (docs/state_codec.md). Best-effort: a
    sidecar failure must never block the batch it rides with."""
    from . import state_codec

    try:
        path = str(path)
        fd, tmp = tempfile.mkstemp(
            dir=os.path.dirname(os.path.abspath(path)) or ".",
            prefix=".vsc-")
        with os.fdopen(fd, "wb") as f:
            if state_codec.enabled():
                table_base = None
                if table_from is not None:
                    got = state_codec.frame_table_blob(table_from)
                    if got is not None:
                        table_base = (
                            os.path.basename(str(table_from)), got[0])
                f.write(state_codec.encode_frame(
                    {"kind": "verdicts"}, list(entries),
                    table_base=table_base))
            else:
                dump_with_terms(f, list(entries))
        os.replace(tmp, path)
        return True
    except Exception as e:
        log.warning("verdict sidecar save failed (%s); batch ships "
                    "without cached proofs", e)
        return False


def load_verdict_sidecar(path) -> list:
    """Inverse of save_verdict_sidecar; absent/corrupt sidecars load as
    empty (the thief just re-proves — degraded, never wrong). Codec
    frames resolve referenced term tables against sibling files in the
    sidecar's own directory; a missing or hash-skewed reference drops
    the sidecar WHOLE."""
    from . import state_codec

    try:
        if not os.path.exists(str(path)):
            return []
        with open(str(path), "rb") as f:
            data = f.read()
        if state_codec.is_frame(data):
            _meta, parts = state_codec.decode_frame(
                data, table_loader=state_codec.file_table_loader(
                    os.path.dirname(os.path.abspath(str(path)))))
            return list(parts)
        return list(load_with_terms(io.BytesIO(data)))
    except Exception as e:
        log.warning("verdict sidecar load failed (%s); replaying "
                    "nothing", e)
        return []


#: static-sidecar shape version: the payload frames a {"shape", "entries"}
#: dict so a mixed-build fleet mid-deploy re-derives from bytes instead
#: of pinning stale StaticInfo shapes into the memo. Bump whenever
#: StaticInfo grows consumer-visible fields.
#:   2 — StaticInfo carries loop_templates (PR 12, loop_summary.py);
#:       pre-summary entries (and the PR-8-era bare-list framing)
#:       are dropped on import.
STATIC_SIDECAR_SHAPE = 2


def save_static_sidecar(path, entries) -> bool:
    """Write a migration batch's static-pass sidecar: memoized
    analysis/static_pass.StaticInfo entries (plain picklable data — no
    terms, so no flat-table framing needed). The taint/dependence
    layer's products (PR 8: cfg, site taints, selector map, function
    deps, write-completeness) and the loop-summary templates (PR 12)
    are ordinary StaticInfo fields and ship with the same pickle — a
    thief computes refined planes, the tx-prune relation and verified
    summaries from them without re-running any fixpoint. The payload
    carries STATIC_SIDECAR_SHAPE so shape-skewed builds drop rather
    than adopt. Best-effort, like the verdict sidecar: a failure must
    never block the batch."""
    try:
        path = str(path)
        fd, tmp = tempfile.mkstemp(
            dir=os.path.dirname(os.path.abspath(path)) or ".",
            prefix=".ssc-")
        with os.fdopen(fd, "wb") as f:
            pickle.dump({"shape": STATIC_SIDECAR_SHAPE,
                         "entries": list(entries)}, f,
                        protocol=pickle.HIGHEST_PROTOCOL)
        os.replace(tmp, path)
        return True
    except Exception as e:
        log.warning("static sidecar save failed (%s); batch ships "
                    "without static results", e)
        return False


def filter_static_entries(entries) -> list:
    """Current-shape StaticInfo entries only: the per-entry field
    probe shared by the migration static sidecar and the warm store
    (support/warm_store.py) — a stale-shape entry would resolve new
    consumers' getattr probes to class defaults, silently turning the
    newer layers off for that code."""
    return [e for e in entries
            if hasattr(e, "code_hash") and hasattr(e, "reach_mask")
            and hasattr(e, "taint_converged")
            and hasattr(e, "loop_templates")]


def load_static_sidecar(path) -> list:
    """Inverse of save_static_sidecar; absent/corrupt loads as empty
    (the thief re-analyzes — milliseconds, never wrong). A payload
    whose shape version differs — including the PR-8-era bare-list
    framing, which predates the loop-summary templates — is dropped
    whole rather than adopted: a stale-shape StaticInfo resolves the
    new consumers' getattr probes to class defaults, which is sound
    but silently turns the new layers off for every shipped code."""
    try:
        if not os.path.exists(str(path)):
            return []
        with open(str(path), "rb") as f:
            payload = pickle.load(f)
        if not isinstance(payload, dict) \
                or payload.get("shape") != STATIC_SIDECAR_SHAPE:
            log.info("static sidecar: shape %s != %d — dropped "
                     "(thief re-analyzes)",
                     payload.get("shape") if isinstance(payload, dict)
                     else "legacy-list", STATIC_SIDECAR_SHAPE)
            return []
        entries = list(payload.get("entries", ()))
        kept = filter_static_entries(entries)
        if len(kept) != len(entries):
            log.info("static sidecar: dropped %d stale-shape "
                     "entries (thief re-analyzes)",
                     len(entries) - len(kept))
        return kept
    except Exception as e:
        log.warning("static sidecar load failed (%s); re-analyzing", e)
        return []


def save_checkpoint(path: str, round_index: int, open_states,
                    target_address: int, code_id: str,
                    include_modules: bool = True,
                    inflight=None) -> bool:
    """Atomically write a resumable snapshot after a completed
    transaction round. Failures are logged, never raised — a
    checkpoint must not kill the analysis it protects.
    include_modules=False writes a MIGRATION batch: the open states
    travel, detector issues/caches stay with the exporting rank
    (parallel/migrate.py). ``inflight`` is the live lane plane
    (docs/checkpoint.md): GlobalStates mid-way through round
    ``round_index - 1`` — a resumed run finishes that round from them
    before the loop continues at ``round_index``. Returns True when
    the file landed."""
    from ..laser.transaction import tx_id_manager

    from . import state_codec

    inflight = list(inflight or [])
    open_states = list(open_states)
    try:
        with trace.span("ckpt.export", states=len(open_states),
                        inflight=len(inflight)):
            if state_codec.enabled():
                # v5: one shared term table for the whole snapshot,
                # states delta-chained (docs/state_codec.md)
                meta = {
                    "round": round_index,
                    "n_open": len(open_states),
                    "target_address": target_address,
                    "tx_counter": tx_id_manager._next,
                    "keccak": _keccak_state(),
                    "modules": _module_state() if include_modules
                    else {},
                }
                body_bytes = state_codec.encode_frame(
                    meta, open_states + inflight)
                head = io.BytesIO()
                pickle.dump({"version": VERSION_CODEC,
                             "code_id": code_id},
                            head, protocol=pickle.HIGHEST_PROTOCOL)
            else:
                body = io.BytesIO()
                pickler = _Pickler(body,
                                   protocol=pickle.HIGHEST_PROTOCOL)
                pickler.dump({
                    "round": round_index,
                    "open_states": open_states,
                    "inflight": inflight,
                    "target_address": target_address,
                    "tx_counter": tx_id_manager._next,
                    "keccak": _keccak_state(),
                    "modules": _module_state() if include_modules
                    else {},
                })
                body_bytes = body.getvalue()
                head = io.BytesIO()
                pickle.dump(
                    {"version": VERSION, "code_id": code_id,
                     "terms": _dag_rows(pickler.roots.values())},
                    head, protocol=pickle.HIGHEST_PROTOCOL)

            fd, tmp = tempfile.mkstemp(
                dir=os.path.dirname(os.path.abspath(path)) or ".",
                prefix=".ckpt-")
            with os.fdopen(fd, "wb") as f:
                f.write(head.getvalue())
                f.write(body_bytes)
            os.replace(tmp, path)
        log.info(
            "checkpoint: round %d, %d open + %d in-flight states -> "
            "%s (%d bytes)",
            round_index, len(open_states), len(inflight), path,
            head.tell() + len(body_bytes))
        return True
    except Exception as e:  # pragma: no cover - best-effort by design
        log.warning("checkpoint save failed (%s); continuing", e)
        return False


def load_checkpoint(path: str, code_id: str) -> Optional[Dict[str, Any]]:
    """Load a snapshot for the given code identity; returns the payload
    dict (with keccak/module state already restored into the current
    run context) or None when absent, unreadable, or for other code.
    The whole payload is parsed BEFORE any global state mutates, so a
    corrupt snapshot leaves the fresh run untouched."""
    global _LOAD_TERMS

    if not os.path.exists(path):
        return None
    RESUME_STATS["failed"] += 1  # flipped to loaded on success
    try:
        with trace.span("ckpt.import"), open(path, "rb") as f:
            head = pickle.load(f)
            if head.get("version") not in (VERSION, VERSION_CODEC):
                # version skew (old rank in a mixed-build fleet, or a
                # pre-v4 file on disk): skipped, never crashed on —
                # the run starts fresh and overwrites it
                log.warning("checkpoint %s: unsupported version %s; "
                            "starting fresh",
                            path, head.get("version"))
                return None
            if head.get("code_id") != code_id:
                log.info(
                    "checkpoint %s belongs to different code; ignoring",
                    path)
                return None
            if head.get("version") == VERSION_CODEC:
                # codec frame body: shared table + delta-chained
                # states. Any malformation raises (CodecError or
                # otherwise) into the outer handler — the snapshot is
                # dropped WHOLE, never partially adopted.
                from . import state_codec

                meta, parts = state_codec.decode_frame(f.read())
                n_open = int(meta["n_open"])
                payload = dict(meta)
                payload["open_states"] = parts[:n_open]
                payload["inflight"] = parts[n_open:]
            else:
                _LOAD_TERMS = _intern_rows(head["terms"])
                try:
                    payload = _Unpickler(f).load()
                finally:
                    _LOAD_TERMS = {}

        # parse everything up front: a malformed payload must not
        # leave half-restored global state behind
        round_index = payload["round"]
        open_states = payload["open_states"]
        inflight = list(payload.get("inflight", ()))
        tx_counter = payload["tx_counter"]
        keccak = {
            key: payload["keccak"][key]
            for key in ("widths", "concrete_hashes", "quick_inverse")
        }
        modules = payload["modules"]
    except Exception as e:
        log.warning("checkpoint load failed (%s); starting fresh", e)
        return None

    from ..analysis.module.loader import ModuleLoader
    from ..laser.function_managers import keccak_function_manager as km
    from ..laser.transaction import tx_id_manager

    tx_id_manager._next = tx_counter
    # width models rebuild in the snapshot's insertion order (pickle
    # preserves dict order) so each width reclaims the same slab
    for width, entry in keccak["widths"].items():
        km.get_function(width)
        model = km._widths[width]
        model.symbolic_inputs.extend(entry["symbolic_inputs"])
        model.results.extend(entry["results"])
    for data, result in keccak["concrete_hashes"].items():
        if data not in km.concrete_hashes:
            km._concrete_by_width.setdefault(
                data.size(), []).append((data, result))
        km.concrete_hashes[data] = result
    km.quick_inverse.update(keccak["quick_inverse"])
    for module in ModuleLoader().get_detection_modules():
        entry = modules.get(type(module).__name__)
        if entry is not None:
            module.issues.extend(entry["issues"])
            module.cache.update(entry["cache"])

    RESUME_STATS["failed"] -= 1
    RESUME_STATS["loaded"] += 1
    log.info("checkpoint: resuming at round %d with %d open + %d "
             "in-flight states",
             round_index, len(open_states), len(inflight))
    return {"round": round_index, "open_states": open_states,
            "inflight": inflight,
            "target_address": payload["target_address"]}


# -- live dumps (SIGTERM / fatal — docs/checkpoint.md) -------------------


def snapshot_live_states(laser) -> list:
    """The in-flight half of a live dump: the host worklist verbatim,
    plus one window-boundary seed state per live device lane — each
    engine's lane ctxs rebuild as (seed template + accumulated path
    conditions), pure host work that is safe from a signal handler
    (no device access; a lane's progress since its seed re-executes
    on resume, restricted to its recorded branch by the conditions).
    Lanes retired into the streaming retire ring but not yet
    materialized (chunks whose deferred pull is still riding the next
    window — docs/drain_pipeline.md §1b) are covered by the same
    seed-state rebuild: live_seed_states reads their ctx snapshots
    off the pending ring jobs, so the deferral loses no subtree.
    The mid-flight window-export client itself retires through the
    chunked gather seam (LaneEngine._retire_chunked), so a migration
    split of a 64k wave never recreates the monolithic allocation.
    Best-effort per state: a state that fails to rebuild is dropped
    (it re-runs from the round checkpoint instead)."""
    states = list(getattr(laser, "work_list", ()) or ())
    # the state mid-step (already popped from the worklist) and the
    # terminal states whose PotentialIssue wave has not discharged
    # yet: both re-enter the worklist on resume — one re-executed
    # step / re-ended transaction each, absorbed by issue dedup
    current = getattr(laser, "_ckpt_current_state", None)
    if current is not None:
        states.append(current)
    states.extend(getattr(laser, "_pi_wave", ()) or ())
    # states this analysis handed to an in-flight packed wave
    # (laser/wave_pack.py): they left the worklist but have not been
    # delivered back — re-enter them so a SIGTERM mid-packed-wave
    # dump stays a complete per-request payload (their device progress
    # re-executes on resume, like any live seed below)
    states.extend(getattr(laser, "_pack_pending_states", ()) or ())
    engines = getattr(laser, "_lane_engines", None) or {}
    for engine in list(engines.values()):
        try:
            states.extend(engine.live_seed_states())
        except Exception:
            continue
    return states


def write_resume_checkpoint(laser, path, code_id: str) -> bool:
    """Dump a FULL live checkpoint for the analysis `laser` is mid-way
    through: open states of the current round, the in-flight plane
    (snapshot_live_states), detector issues/caches, keccak state and
    the tx counter. Called from the flight recorder's SIGTERM/fatal
    hook — single-flight there, never raises here."""
    try:
        ctx = getattr(laser, "_ckpt_round_ctx", None)
        if ctx is None:
            return False  # no round running: nothing resumable yet
        next_round, _tx_count, address = ctx
        from ..smt import BitVec

        addr = address.value if isinstance(address, BitVec) else address
        return save_checkpoint(
            str(path), next_round, list(laser.open_states), addr,
            code_id, include_modules=True,
            inflight=snapshot_live_states(laser))
    except Exception as e:
        log.warning("live resume dump failed (%s)", e)
        return False


def arm_live_dump(laser, path, code_id: str) -> None:
    """Register the SIGTERM/fatal resume-checkpoint provider with the
    flight recorder (PR 9): when the process dies with this analysis
    mid-round, ``<out-dir>/flightrec/resume_rank<r>.ckpt`` (and the
    analysis's own --checkpoint file, when set) capture the live
    plane, so the contract re-enters the queue as resumable work.
    Latest analysis wins — one resume file per rank."""
    if not live_enabled():
        return
    try:
        import weakref

        from .telemetry import flightrec

        ref = weakref.ref(laser)

        def provider(dest_dir, rank):
            l = ref()
            if l is None:
                return None
            resume_path = os.path.join(
                str(dest_dir), f"resume_rank{rank}.ckpt")
            if not write_resume_checkpoint(l, resume_path, code_id):
                return None
            if path and os.path.abspath(str(path)) != \
                    os.path.abspath(resume_path):
                try:
                    import shutil

                    shutil.copyfile(resume_path, str(path))
                except OSError:
                    pass
            return resume_path

        flightrec.register_resume_provider(provider)
    except Exception as e:  # telemetry only
        log.debug("live-dump arming failed: %s", e)
