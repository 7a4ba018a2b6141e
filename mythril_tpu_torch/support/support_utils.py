"""Cross-cutting utilities (reference parity:
mythril/support/support_utils.py:14-101): Singleton metaclass, LRU cache,
model quick-sat cache, and the keccak entry point (backed by the native
library instead of the eth-hash wheel)."""

import functools
import logging
from collections import OrderedDict
from typing import Dict

log = logging.getLogger(__name__)


class Singleton(type):
    """A metaclass type implementing the singleton pattern.

    Like the reference (support_utils.py:21-23) this is not thread- or
    process-safe; per-run context objects own all engine state, this is only
    used for process-global knobs (Args, statistics, signature DB).
    """

    _instances: Dict = {}

    def __call__(cls, *args, **kwargs):
        if cls not in cls._instances:
            cls._instances[cls] = super(Singleton, cls).__call__(
                *args, **kwargs
            )
        return cls._instances[cls]


class LRUCache:
    """Simple ordered-dict LRU (reference support_utils.py:34-52)."""

    def __init__(self, size: int):
        self.size = size
        self.lru_cache: OrderedDict = OrderedDict()

    def get(self, key):
        try:
            value = self.lru_cache.pop(key)
            self.lru_cache[key] = value
            return value
        except KeyError:
            return None

    def put(self, key, value):
        try:
            self.lru_cache.pop(key)
        except KeyError:
            if len(self.lru_cache) >= self.size:
                self.lru_cache.popitem(last=False)
        self.lru_cache[key] = value


class ModelCache:
    """Caches recent models; quick-sat re-evaluates a constraint under cached
    models before invoking the solver (reference support_utils.py:55-68).

    The scan width adapts to the observed hit rate: on miss-heavy
    workloads (fork-dense path sweeps where every query has a distinct
    path condition) re-evaluating 100 models per query costs far more
    than the solve it tries to avoid, so the scan shrinks toward a few
    most-recent models and recovers geometrically on any hit."""

    MAX_SCAN = 100
    MIN_SCAN = 4

    def __init__(self):
        import threading

        from ..smt.repair import REPAIR_MODELS

        self.model_cache = LRUCache(size=100)
        self._scan = self.MAX_SCAN
        self._misses = 0
        self._repair_tries = REPAIR_MODELS
        # solver-pool workers and async discharge futures feed/scan
        # the cache concurrently with the main thread; the scan
        # iterates the LRU's OrderedDict, which a concurrent put()
        # would invalidate mid-iteration (smt/solver/pool.py)
        self._lock = threading.RLock()

    def check_quick_sat(self, constraint_term) -> object:
        with self._lock:
            return self._check_quick_sat_locked(constraint_term)

    def _check_quick_sat_locked(self, constraint_term) -> object:
        scanned = 0
        for model in reversed(self.model_cache.lru_cache.keys()):
            if scanned >= self._scan:
                break
            scanned += 1
            try:
                result = model.raw[0].eval_term(constraint_term,
                                                complete=False)
            except Exception:
                continue
            if result is True:
                self.model_cache.put(model, 1)
                self._misses = 0
                self._scan = min(self._scan * 2, self.MAX_SCAN)
                return model
        # scan miss: attempt a path-guided repair of the most recent
        # models — fork storms (every leaf a distinct path condition)
        # are exactly the workload where the plain scan always misses
        # but a sibling's model is a few flipped branch bits away. The
        # attempt budget rides the same miss backoff as the scan width:
        # on workloads where repair never lands it decays to one donor.
        from ..smt.repair import REPAIR_MODELS, try_repair

        tried = 0
        for model in reversed(self.model_cache.lru_cache.keys()):
            if tried >= self._repair_tries:
                break
            tried += 1
            try:
                fixed = try_repair(constraint_term, model)
            except Exception:
                break  # repair is an optimization, never an error path
            if fixed is not None:
                # a repair hit must NOT re-grow the scan width: in a
                # fork storm the plain scan never hits (every query is
                # a distinct path condition) and re-pegging _scan to
                # MAX would re-introduce the 100-model re-evaluation
                # cost per query that the backoff exists to cut.
                # More: the scan just missed END-TO-END and only repair
                # saved the query, so DECAY the width — without this,
                # repair-served storms kept paying the full 100-model
                # evaluation before every repair (measured 219 s of
                # term evaluation on a 16k-path sweep); a direct scan
                # hit still re-grows the width geometrically.
                # Re-touch the DONOR, not the repaired model: a
                # repaired sibling is single-use (the next path has
                # different branch bits) and its eval memo is cold,
                # while the donor has accumulated the shared-prefix
                # memo — caching repairs rotated a cold-memo model to
                # the front and made every scan re-walk the full
                # constraint DAG (the measured top cost of a 16k-path
                # terminal storm)
                self.model_cache.put(model, 1)
                self._repair_tries = REPAIR_MODELS
                self._scan = max(self._scan // 2, self.MIN_SCAN)
                return fixed
        self._misses += 1
        if self._misses >= 8:
            self._misses = 0
            self._scan = max(self._scan // 2, self.MIN_SCAN)
            self._repair_tries = max(self._repair_tries // 2, 1)
        return None

    def put(self, model, weight) -> None:
        with self._lock:
            self.model_cache.put(model, weight)

    def most_recent(self):
        """Newest cached model, or None (phase-seed donor even when
        quick-sat misses)."""
        with self._lock:
            for model in reversed(self.model_cache.lru_cache.keys()):
                return model
            return None


def fold_concrete_bytes(seq) -> list:
    """Normalize a byte sequence that may mix ints, concrete BitVec(8)s
    (memory stores Extracts of MSTOREd words) and genuinely symbolic
    byte terms: ints stay, concrete BitVecs fold to their value,
    symbolic terms pass through. Callers check `all(isinstance(b, int))`
    to decide between the concrete and symbolic paths."""
    out = []
    for b in seq:
        if isinstance(b, int):
            out.append(b)
        elif getattr(b, "value", None) is not None:
            out.append(b.value)
        else:
            out.append(b)
    return out


def get_code_hash(code) -> str:
    """Keccak hash of hex bytecode string (reference support_utils.py:71-88).

    The common str form is memoized: every DetectionModule.execute
    call hashes the active code for its issue-cache key, so an
    analysis pays one full keccak per hook firing — tens of thousands
    of redundant hashes of the same handful of contracts per run."""
    if isinstance(code, str):
        return _code_hash_of_hex(code)
    return _code_hash_of_obj(code)


@functools.lru_cache(maxsize=1024)
def _code_hash_of_hex(code: str) -> str:
    from ..native import keccak256

    code = code.replace("0x", "")
    try:
        hash_ = keccak256(bytes.fromhex(code))
        return "0x" + hash_.hex()
    except ValueError:
        log.debug("invalid code hex: %s", code[:40])
        return ""


def _code_hash_of_obj(code) -> str:
    from ..native import keccak256

    code = fold_concrete_bytes(code)
    if not all(isinstance(b, int) for b in code):
        # partially-symbolic runtime code: identity-hash the structure
        # (reference support_utils.py:80-82 falls back to hash(code))
        return str(hash(tuple(str(b) for b in code)))
    return "0x" + keccak256(bytes(code)).hex()


def sha3(value: bytes) -> bytes:
    """Concrete keccak-256 (reference support_utils.py:94-101)."""
    if isinstance(value, str):
        value = value.encode()
    from ..native import keccak256

    return keccak256(value)


def zpad(x: bytes, l: int) -> bytes:
    """Left zero pad value `x` at least to length `l`."""
    return b"\x00" * max(0, l - len(x)) + x
