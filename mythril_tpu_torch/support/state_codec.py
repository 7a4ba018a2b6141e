"""Shared-structure state codec: delta/dedup compression for every
serialized-state payload (docs/state_codec.md).

Sibling lanes share all but O(1) of their stacks/memories/storage with
their fork parent, yet before this codec every payload the system
shipped — retire-chunk materialization rows, live checkpoints,
migration offers, warm-store entries — serialized full planes plus a
full flat term table *per payload*.  The CFLOBDD BMC line of work
(PAPERS.md) shows shared-structure symbolic-state representations
compress by orders of magnitude; this module is the byte-level
realization of that observation for the four seams named in ROADMAP
item 5:

* **term-table dedup** — one shared, hash-cons-preserving flat term
  table per frame (checkpoint / offer / warm entry), with every part
  referencing it by tid.  Re-interning on import keeps tid identity —
  the same contract as ``checkpoint.dump_with_terms``.  A frame may
  also reference ANOTHER file's table (``table_base``): a migration
  verdict sidecar ships only the rows its entries add over the offer
  batch it rides with.
* **reference-delta parts** — each part (an open state, an in-flight
  state, a verdict entry) pickles separately against the shared table,
  then byte-delta-encodes against a codec-chosen reference part: the
  fingerprint-nearest sibling on a greedy similarity chain (block-hash
  sketches — the same frontier-similarity idea as the merge layer's
  ``_merge_fingerprint``), falling back to payload order for very
  large frames.  Only changed byte runs + the reference id are stored;
  every delta is verified against its target at encode time, so a
  codec bug degrades to whole-part storage, never to corruption.
* **retire-row planes** — ``encode_rows``/``decode_rows`` compress the
  host-retained row dicts the retire ring parks between pull and
  materialize: per-column, each lane row stores only the slots that
  differ from the previous lane (fork order places siblings
  adjacently).

Soundness (the PR-13 trust boundary): decode never partially
succeeds.  Corrupt bytes, a version-skewed frame, or a missing /
hash-mismatched table reference raise :class:`CodecError` and the
caller drops the payload WHOLE — a checkpoint starts fresh, a sidecar
replays nothing, an offer falls back to local resume.  Degraded,
never wrong.

Gate: ``MTPU_CODEC`` (default on; ``0`` restores pre-codec behavior
bit-for-bit at every seam — legacy formats are written, no codec
counters move).  Decoding EXISTING codec payloads is not gated:
reading what is on disk is a correctness obligation, not a payload
choice.

Byte accounting (SolverStatistics -> "State codec" render group):
``codec_bytes_raw`` (what the legacy layout would have written),
``codec_bytes_encoded`` (what the codec wrote), ``codec_ref_hits``
(parts/columns that delta-encoded against a reference),
``codec_fallback_whole`` (parts/columns stored whole),
``codec_drop_whole`` (decode-side whole-payload drops).
"""

import hashlib
import io
import logging
import os
import pickle
import zlib
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

log = logging.getLogger(__name__)

#: frame format version: a skewed frame is dropped whole (the caller
#: falls back exactly as for a corrupt payload). Bump on any change to
#: the frame dict shape or the delta op encoding.
CODEC_VERSION = 1

#: file/frame magics: a reader sniffs these to distinguish codec
#: payloads from legacy pickles (which never start with them — pickle
#: protocol 2+ streams begin with b"\\x80").
MAGIC = b"MTSC\x01"        # object frames (checkpoint bodies, sidecars,
                           # warm entries)
MAGIC_ROWS = b"MTSR\x01"   # retire-row plane payloads

#: test/bench hook: overrides the env gate when not None
FORCE: Optional[bool] = None

#: byte-delta block size: reference tables index aligned BLOCK-byte
#: windows; smaller finds more matches, larger indexes faster
_BLOCK = 64

#: similarity-chain cap: above this many parts the greedy
#: nearest-neighbor ordering is O(n^2) sketch comparisons — fall back
#: to payload order (fork order already places siblings adjacently)
_CHAIN_CAP = 512

#: exact per-part term-table attribution cap: above this many
#: (rows x parts) traversal steps the raw-byte estimate charges the
#: shared table once (UNDER-stating the win — conservative, never
#: inflated)
_ATTRIB_CAP = 4_000_000


class CodecError(Exception):
    """Payload cannot be decoded as a whole — the caller must drop it
    entirely (never adopt a partial decode)."""


def enabled() -> bool:
    """The codec master gate (MTPU_CODEC, default on; "0" restores the
    legacy formats bit-for-bit at every seam)."""
    if FORCE is not None:
        return bool(FORCE)
    return os.environ.get("MTPU_CODEC", "1") != "0"


def _bump(**deltas) -> None:
    try:
        from ..smt.solver.solver_statistics import SolverStatistics

        SolverStatistics().bump(**deltas)
    except Exception:  # pragma: no cover - accounting never blocks
        pass


# ---------------------------------------------------------------------------
# byte-level reference delta
# ---------------------------------------------------------------------------


#: zlib preset-dictionary window: DEFLATE dictionaries cap at 32 KiB,
#: so a larger reference part contributes its TAIL (pickle streams
#: keep their shared structure distributed, and the matcher only
#: reaches back one window anyway)
_ZDICT = 32768


def _zdelta(ref: bytes, tgt: bytes) -> Optional[tuple]:
    """DEFLATE `tgt` against `ref` as a preset dictionary — the
    unaligned complement to the block dedup below: sibling state
    pickles share long byte runs at SHIFTED offsets (one diverging
    varint re-aligns everything downstream), which aligned blocks
    cannot see but LZ77 matching against the reference window can.
    Returns ``("z", zblob, len(tgt))`` or None when no win."""
    try:
        co = zlib.compressobj(6, zlib.DEFLATED, -15, 9,
                              zlib.Z_DEFAULT_STRATEGY,
                              ref[-_ZDICT:])
        z = co.compress(tgt) + co.flush()
    except Exception:  # pragma: no cover - zlib config trouble
        return None
    if len(z) + 16 >= (len(tgt) * 7) // 8:
        return None
    return ("z", z, len(tgt))


def _delta_encode(ref: bytes, tgt: bytes) -> Optional[tuple]:
    """Delta-encode `tgt` against `ref`: the smaller of (a) common
    prefix/suffix trim plus aligned-block dedup of the middle against
    the whole reference — ``(prefix, suffix, ops, len(tgt))``, ops a
    list of ``("c", ref_off, length)`` copies and ``("l", bytes)``
    literals — and (b) DEFLATE with the reference as preset
    dictionary — ``("z", zblob, len(tgt))``.  Returns None when
    neither beats whole storage.  The encoded form is VERIFIED to
    reapply to `tgt` exactly before being offered; a mismatch
    (impossible by construction, but soundness-critical) falls back
    to whole."""
    if not ref or not tgt:
        return None
    zrec = _zdelta(ref, tgt)
    n = min(len(ref), len(tgt))
    a = np.frombuffer(ref, np.uint8, n)
    b = np.frombuffer(tgt, np.uint8, n)
    neq = a != b
    if not neq.any():
        pre = n
    else:
        pre = int(neq.argmax())
    rem = n - pre
    if rem <= 0:
        suf = 0
    else:
        ar = np.frombuffer(ref, np.uint8)[len(ref) - rem:]
        br = np.frombuffer(tgt, np.uint8)[len(tgt) - rem:]
        neqr = ar != br
        suf = rem if not neqr.any() else int(neqr[::-1].argmax())
    mid = tgt[pre:len(tgt) - suf]
    ops: List[tuple] = []
    enc_size = 16  # record overhead
    if mid:
        index: Dict[bytes, int] = {}
        for off in range(0, len(ref) - _BLOCK + 1, _BLOCK):
            index.setdefault(ref[off:off + _BLOCK], off)
        lit = bytearray()
        run_off, run_len = -1, 0
        for off in range(0, len(mid), _BLOCK):
            blk = mid[off:off + _BLOCK]
            hit = index.get(blk) if len(blk) == _BLOCK else None
            if hit is None:
                if run_len:
                    ops.append(("c", run_off, run_len))
                    enc_size += 12
                    run_off, run_len = -1, 0
                lit.extend(blk)
            else:
                if lit:
                    ops.append(("l", bytes(lit)))
                    enc_size += 6 + len(lit)
                    lit = bytearray()
                if run_len and hit == run_off + run_len:
                    run_len += _BLOCK
                else:
                    if run_len:
                        ops.append(("c", run_off, run_len))
                        enc_size += 12
                    run_off, run_len = hit, _BLOCK
        if run_len:
            ops.append(("c", run_off, run_len))
            enc_size += 12
        if lit:
            ops.append(("l", bytes(lit)))
            enc_size += 6 + len(lit)
    rec: Optional[tuple] = (pre, suf, ops, len(tgt))
    if enc_size >= (len(tgt) * 7) // 8:
        rec = None
    if zrec is not None and (rec is None
                             or len(zrec[1]) + 16 < enc_size):
        rec = zrec
    if rec is None:
        return None
    if _delta_apply(ref, rec) != tgt:  # soundness over bytes saved
        log.warning("state codec: delta verification failed; "
                    "storing part whole")
        return None
    return rec


def _delta_apply(ref: bytes, rec: tuple) -> bytes:
    """Reapply a `_delta_encode` record against the reference bytes."""
    if rec and rec[0] == "z":
        _tag, z, total = rec
        try:
            do = zlib.decompressobj(-15, ref[-_ZDICT:])
            blob = do.decompress(z) + do.flush()
        except Exception as e:
            raise CodecError("zdict delta inflate failed: %s" % e)
        if len(blob) != total:
            raise CodecError("delta record reassembles to %d bytes, "
                             "expected %d" % (len(blob), total))
        return blob
    pre, suf, ops, total = rec
    out = [ref[:pre]]
    for op in ops:
        if op[0] == "c":
            _, off, ln = op
            out.append(ref[off:off + ln])
        else:
            out.append(op[1])
    if suf:
        out.append(ref[len(ref) - suf:])
    blob = b"".join(out)
    if len(blob) != total:
        raise CodecError("delta record reassembles to %d bytes, "
                         "expected %d" % (len(blob), total))
    return blob


def _sketch(blob: bytes) -> frozenset:
    """A cheap content fingerprint for reference-part selection: the 8
    smallest crc32s over aligned blocks (minhash over block content —
    the byte-level cousin of the merge layer's frontier
    ``_merge_fingerprint``).  Sibling parts share most blocks, so
    sketch overlap tracks delta-encodability."""
    crcs = {zlib.crc32(blob[off:off + _BLOCK])
            for off in range(0, len(blob), _BLOCK)}
    return frozenset(sorted(crcs)[:8])


def _order_chain(blobs: Sequence[bytes]) -> List[int]:
    """Greedy nearest-neighbor encode order over part sketches: each
    part delta-encodes against its chain predecessor, so chaining
    similar parts adjacently is what converts structural sharing into
    byte savings.  Deterministic (ties break on payload index); falls
    back to payload order above _CHAIN_CAP parts (fork order already
    places siblings adjacently)."""
    n = len(blobs)
    if n <= 2 or n > _CHAIN_CAP:
        return list(range(n))
    sketches = [_sketch(b) for b in blobs]
    order = [0]
    left = set(range(1, n))
    while left:
        cur = sketches[order[-1]]
        best = min(left, key=lambda i: (-len(cur & sketches[i]), i))
        order.append(best)
        left.remove(best)
    return order


# ---------------------------------------------------------------------------
# object frames (shared term table + reference-delta parts)
# ---------------------------------------------------------------------------


def _pickle_with_table(obj, roots: Dict[int, Any]) -> Tuple[bytes, dict]:
    """Pickle one part against the frame's shared term table: terms
    serialize as tid references (checkpoint._Pickler) and the part's
    roots merge into the frame-wide root set."""
    from . import checkpoint as ckpt

    body = io.BytesIO()
    pickler = ckpt._Pickler(body, protocol=pickle.HIGHEST_PROTOCOL)
    pickler.dump(obj)
    roots.update(pickler.roots)
    return body.getvalue(), pickler.roots


def _reach_counts(rows: list, part_roots: List[dict]) -> Optional[List[int]]:
    """Per-part reachable-row counts over the shared table (for honest
    raw-byte attribution: the legacy layout ships each part's OWN
    reachable table).  None above _ATTRIB_CAP traversal steps — the
    caller then charges the shared table once (conservative)."""
    if len(rows) * max(len(part_roots), 1) > _ATTRIB_CAP:
        return None
    args_of = {row[0]: row[2] for row in rows}
    counts = []
    for roots in part_roots:
        seen = set()
        stack = [tid for tid in roots if tid in args_of]
        while stack:
            tid = stack.pop()
            if tid in seen:
                continue
            seen.add(tid)
            stack.extend(a for a in args_of.get(tid, ())
                         if a not in seen)
        counts.append(len(seen))
    return counts


def encode_frame(meta, parts: Sequence[Any],
                 table_base: Optional[Tuple[str, bytes]] = None) -> bytes:
    """Encode a codec frame: `meta` (always stored whole) plus `parts`
    (delta-chained), all sharing ONE flat term table.  With
    `table_base` = (name, base_rows_blob), the frame stores only the
    rows its content ADDS over that external table and references the
    base by name + sha256 — the decode side must resolve it via
    `table_loader` or drop the frame whole.  Returns the framed bytes
    (MAGIC-prefixed) and bumps the codec byte counters."""
    from . import checkpoint as ckpt

    roots: Dict[int, Any] = {}
    meta_blob, meta_roots = _pickle_with_table(meta, roots)
    part_blobs: List[bytes] = []
    part_roots: List[dict] = []
    for obj in parts:
        blob, pr = _pickle_with_table(obj, roots)
        part_blobs.append(blob)
        part_roots.append(pr)

    base_seen: set = set()
    if table_base is not None:
        base_name, base_blob = table_base
        base_rows = pickle.loads(base_blob)
        base_seen = {row[0] for row in base_rows}
        extra_rows = ckpt._dag_rows(roots.values(), seen=set(base_seen))
        extra_blob = pickle.dumps(extra_rows,
                                  protocol=pickle.HIGHEST_PROTOCOL)
        table = ("ref", base_name,
                 hashlib.sha256(base_blob).hexdigest(), extra_blob)
        all_rows = list(base_rows) + list(extra_rows)
        rows_blob_len = len(extra_blob)
    else:
        all_rows = ckpt._dag_rows(roots.values())
        rows_blob = pickle.dumps(all_rows,
                                 protocol=pickle.HIGHEST_PROTOCOL)
        table = ("inline", rows_blob)
        rows_blob_len = len(rows_blob)

    order = _order_chain(part_blobs)
    records: List[tuple] = []
    ref = b""
    ref_hits = fallback = 0
    for pos, idx in enumerate(order):
        blob = part_blobs[idx]
        rec = _delta_encode(ref, blob) if pos else None
        if rec is not None:
            records.append(("d", idx, rec))
            ref_hits += 1
        else:
            records.append(("w", idx, blob))
            fallback += 1
        ref = blob

    frame = {
        "v": CODEC_VERSION,
        "table": table,
        "meta": meta_blob,
        "parts": records,
        "n": len(part_blobs),
    }
    out = MAGIC + pickle.dumps(frame, protocol=pickle.HIGHEST_PROTOCOL)

    # raw = what the legacy one-table-per-payload layout would have
    # written: each part whole plus its own reachable slice of the
    # term table (estimated pro-rata; exact traversal above the cap is
    # skipped and the table charged once — conservative)
    raw = len(meta_blob) + sum(len(b) for b in part_blobs)
    counts = _reach_counts(all_rows, [meta_roots] + part_roots)
    if counts is not None and all_rows:
        per_row = rows_blob_len / max(len(all_rows), 1)
        raw += int(sum(counts) * per_row)
    else:
        raw += rows_blob_len
    _bump(codec_bytes_raw=raw, codec_bytes_encoded=len(out),
          codec_ref_hits=ref_hits, codec_fallback_whole=fallback)
    return out


def is_frame(blob: bytes) -> bool:
    """Sniff: do these bytes start a codec object frame?"""
    return blob[:len(MAGIC)] == MAGIC


def decode_frame(blob: bytes,
                 table_loader: Optional[Callable[[str, str],
                                                 Optional[bytes]]] = None
                 ) -> Tuple[Any, List[Any]]:
    """Decode a codec frame to ``(meta, parts)`` with parts in their
    original payload order.  EVERY failure mode — bad magic, version
    skew, corrupt pickle, a table reference the loader cannot resolve
    or whose hash mismatches, a delta that reassembles short — raises
    :class:`CodecError`: the caller drops the payload whole.  Terms
    re-intern through the shared table exactly as
    ``checkpoint.load_with_terms`` does, preserving tid identity
    across parts."""
    from . import checkpoint as ckpt

    try:
        if not is_frame(blob):
            raise CodecError("not a codec frame")
        frame = pickle.loads(blob[len(MAGIC):])
        if not isinstance(frame, dict) or frame.get("v") != CODEC_VERSION:
            raise CodecError("frame version skew: %r"
                             % (frame.get("v")
                                if isinstance(frame, dict) else None))
        table = frame["table"]
        if table[0] == "inline":
            rows = pickle.loads(table[1])
        elif table[0] == "ref":
            _, base_name, base_sha, extra_blob = table
            if table_loader is None:
                raise CodecError("frame references external table %r "
                                 "but no loader was provided"
                                 % base_name)
            base_blob = table_loader(base_name, base_sha)
            if base_blob is None:
                raise CodecError("referenced table %r missing"
                                 % base_name)
            if hashlib.sha256(base_blob).hexdigest() != base_sha:
                raise CodecError("referenced table %r hash mismatch"
                                 % base_name)
            rows = list(pickle.loads(base_blob)) \
                + list(pickle.loads(extra_blob))
        else:
            raise CodecError("unknown table kind %r" % (table[0],))

        n = frame["n"]
        blobs: List[Optional[bytes]] = [None] * n
        ref = b""
        for rec in frame["parts"]:
            kind, idx, payload = rec
            if kind == "w":
                blob_i = payload
            elif kind == "d":
                blob_i = _delta_apply(ref, payload)
            else:
                raise CodecError("unknown part kind %r" % (kind,))
            blobs[idx] = blob_i
            ref = blob_i
        if any(b is None for b in blobs):
            raise CodecError("frame part set incomplete")

        terms = ckpt._intern_rows(rows)
        ckpt._LOAD_TERMS = terms
        try:
            meta = ckpt._Unpickler(io.BytesIO(frame["meta"])).load()
            parts = [ckpt._Unpickler(io.BytesIO(b)).load()
                     for b in blobs]
        finally:
            ckpt._LOAD_TERMS = {}
        return meta, parts
    except CodecError:
        _bump(codec_drop_whole=1)
        raise
    except Exception as e:
        _bump(codec_drop_whole=1)
        raise CodecError("frame decode failed: %s" % e) from e


def frame_table_blob(path) -> Optional[Tuple[bytes, str]]:
    """Read the inline term-table blob (and its sha256) out of a codec
    frame stored at `path` after any leading head pickle — the
    publisher side of cross-file table sharing (a verdict sidecar
    referencing its offer batch's table).  None when the file is not a
    codec-framed payload (legacy format: the sidecar falls back to an
    inline table)."""
    try:
        with open(str(path), "rb") as f:
            data = f.read()
        pos = data.find(MAGIC)
        if pos < 0:
            return None
        frame = pickle.loads(data[pos + len(MAGIC):])
        table = frame.get("table")
        if not table or table[0] != "inline":
            return None
        return table[1], hashlib.sha256(table[1]).hexdigest()
    except Exception as e:
        log.debug("frame table read failed for %s: %s", path, e)
        return None


def file_table_loader(directory) -> Callable[[str, str], Optional[bytes]]:
    """A decode-side table_loader resolving referenced tables against
    sibling files in `directory` (the migration bus spool): returns the
    named file's inline table blob or None (-> the frame drops whole).
    Path components in the reference are rejected — a payload must not
    name files outside its own spool."""
    def load(name: str, sha: str) -> Optional[bytes]:
        if os.path.basename(name) != name:
            return None
        got = frame_table_blob(os.path.join(str(directory), name))
        return got[0] if got else None

    return load


# ---------------------------------------------------------------------------
# retire-row planes
# ---------------------------------------------------------------------------


def encode_rows(rows: Dict[str, np.ndarray]) -> Optional[bytes]:
    """Compress a retired chunk's host row dict (laser/lane_engine
    ``_unpack_rows`` output) for parking in the retire ring: per
    column, lane row i stores only the slots differing from lane row
    i-1 (fork order places siblings adjacently, and siblings share all
    but O(1) of their planes).  Returns None when the codec is off or
    the encoding would not beat the raw bytes — the caller keeps the
    raw dict and pays no decode."""
    if not enabled():
        return None
    try:
        recs: Dict[str, tuple] = {}
        raw = 0
        ref_hits = fallback = 0
        for name, arr in rows.items():
            arr = np.asarray(arr)
            raw += arr.nbytes
            rec = None
            if arr.ndim >= 2 and arr.shape[0] > 1 and arr.size:
                flat = np.ascontiguousarray(arr).reshape(
                    arr.shape[0], -1)
                changed = flat[1:] != flat[:-1]
                rw, pos = np.nonzero(changed)
                vals = flat[1:][changed]
                est = (flat[0].nbytes + rw.nbytes // 2 + pos.nbytes // 2
                       + vals.nbytes)
                if est < (arr.nbytes * 3) // 4:
                    rec = ("d", arr.shape, arr.dtype.str,
                           flat[0].tobytes(),
                           rw.astype(np.int32).tobytes(),
                           pos.astype(np.int32).tobytes(),
                           vals.tobytes())
                    ref_hits += 1
            if rec is None:
                rec = ("w", arr.shape, arr.dtype.str,
                       np.ascontiguousarray(arr).tobytes())
                fallback += 1
            recs[name] = rec
        body = pickle.dumps(recs, protocol=pickle.HIGHEST_PROTOCOL)
        # one DEFLATE pass over the whole record dict: plane data is
        # highly repetitive even after the sibling delta, and whole-
        # fallback columns ride it too
        z = zlib.compress(body, 6)
        if len(z) < len(body):
            payload = {"v": CODEC_VERSION, "z": z}
        else:
            payload = {"v": CODEC_VERSION, "p": body}
        blob = MAGIC_ROWS + pickle.dumps(
            payload, protocol=pickle.HIGHEST_PROTOCOL)
        if len(blob) >= raw:
            return None
        _bump(codec_bytes_raw=raw, codec_bytes_encoded=len(blob),
              codec_ref_hits=ref_hits, codec_fallback_whole=fallback)
        return blob
    except Exception as e:  # never the retire path's problem
        log.debug("row-plane encode skipped: %s", e)
        return None


def decode_rows(blob: bytes) -> Dict[str, np.ndarray]:
    """Inverse of :func:`encode_rows`.  Raises :class:`CodecError` on
    any malformation (the ring treats that as fatal for the chunk —
    but the encode side verified the blob it parked, so this only
    guards memory corruption)."""
    try:
        if blob[:len(MAGIC_ROWS)] != MAGIC_ROWS:
            raise CodecError("not a row-plane payload")
        payload = pickle.loads(blob[len(MAGIC_ROWS):])
        if payload.get("v") != CODEC_VERSION:
            raise CodecError("row-plane version skew")
        if "z" in payload:
            recs = pickle.loads(zlib.decompress(payload["z"]))
        elif "p" in payload:
            recs = pickle.loads(payload["p"])
        else:
            raise CodecError("row-plane payload has no record body")
        out: Dict[str, np.ndarray] = {}
        for name, rec in recs.items():
            kind, shape, dtype = rec[0], rec[1], np.dtype(rec[2])
            if kind == "w":
                arr = np.frombuffer(rec[3], dtype).reshape(shape).copy()
            elif kind == "d":
                base = np.frombuffer(rec[3], dtype)
                rw = np.frombuffer(rec[4], np.int32)
                pos = np.frombuffer(rec[5], np.int32)
                vals = np.frombuffer(rec[6], dtype)
                k = shape[0]
                flat = np.empty((k, base.size), dtype)
                flat[0] = base
                bounds = np.searchsorted(rw, np.arange(k - 1),
                                         side="left")
                bounds = np.append(bounds, rw.size)
                for i in range(1, k):
                    flat[i] = flat[i - 1]
                    lo, hi = bounds[i - 1], bounds[i]
                    if hi > lo:
                        flat[i, pos[lo:hi]] = vals[lo:hi]
                arr = flat.reshape(shape)
            else:
                raise CodecError("unknown column kind %r" % (kind,))
            out[name] = arr
        return out
    except CodecError:
        raise
    except Exception as e:
        raise CodecError("row-plane decode failed: %s" % e) from e
