"""Keccak modeling for the symbolic engine.

Capability parity with the reference's VerX-style scheme
(mythril/laser/ethereum/function_managers/keccak_function_manager.py:
25-180) — uninterpreted functions with inverse axioms and disjoint
output ranges — re-architected around this build's term DAG:

- Every distinct input WIDTH owns one `_WidthModel` record: the
  `kec_w`/`unkec_w` uninterpreted-function pair plus one SLAB of the
  placeholder region. The placeholder region is the top `2^228` values
  of the 256-bit space: every member's hex rendering starts with seven
  'f' digits (28 set bits), which is what report-time back-substitution
  scans calldata for (analysis/solver.py), and what the interval
  prefilter uses to refute `hash == small-constant` detector probes
  without a solver (smt/interval.py treats APPLY atoms as boundable).
- Slabs are `2^212` wide and handed out in width-arrival order, so
  placeholder hashes of different input widths can never collide, and
  hashes are pinned ≡ 0 mod 64 inside their slab (mapping/array slot
  spreading, as in VerX).
- Per-input axioms are built once and cached as hash-consed terms
  (keyed by the input's term id and the count of same-width concrete
  hashes, which widen the axiom's escape disjunct); `axioms()` is a
  cheap conjunction of cached terms rather than a rebuild.

Concrete inputs are hashed for real with the native C++ keccak.
State is per-run: the module-level handle is a SwappableProxy the run
context exchanges (support/run_context.py).
"""

import logging
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from ...smt import (
    And,
    BitVec,
    Bool,
    Function,
    Or,
    ULE,
    ULT,
    URem,
    symbol_factory,
)
from ...support.support_utils import sha3

log = logging.getLogger(__name__)

#: the placeholder region: values whose top PREFIX_BITS bits are all
#: set — chosen so every placeholder's 64-hex-digit rendering starts
#: with PREFIX_HEX, a pattern cheap to scan calldata for and (at
#: 2^-28 per real hash) rare enough to make false positives moot
PREFIX_BITS = 28
PREFIX_HEX = "f" * (PREFIX_BITS // 4)
REGION_LO = ((1 << PREFIX_BITS) - 1) << (256 - PREFIX_BITS)

#: one slab per input width, carved out of the region in arrival
#: order; 2^212-wide slabs leave room for 65536 distinct widths
SLAB_BITS = 212
SLAB = 1 << SLAB_BITS

#: hashes are pinned to multiples of 64 within their slab: consecutive
#: storage cells derived from a hash (array data regions) then stay
#: inside one placeholder neighbourhood (VerX's spreading trick)
ALIGN = 64


@dataclass
class _WidthModel:
    """Everything the scheme tracks for one input width."""

    uf: Function
    inverse: Function
    slab_lo: int
    slab_hi: int
    symbolic_inputs: List[BitVec] = field(default_factory=list)
    results: List[BitVec] = field(default_factory=list)


class KeccakFunctionManager:
    #: distinctive hex prefix of every interval-placeholder hash (the
    #: report back-substitution's fast scan key)
    hash_matcher = PREFIX_HEX

    def __init__(self):
        self._widths: Dict[int, _WidthModel] = {}
        self._next_slab = 0
        #: concrete input term -> its real keccak (axioms link them to
        #: the UF so symbolic inputs may equal concrete ones)
        self.concrete_hashes: Dict[BitVec, BitVec] = {}
        #: real hash -> preimage, for the VMTests concrete replay path
        self.quick_inverse: Dict[BitVec, BitVec] = {}
        #: per-width (input term, hash) pairs, appended by
        #: create_keccak — the axiom cache keys on their count, so the
        #: cache-hit path is two dict lookups, no scans
        self._concrete_by_width: Dict[int, List[Tuple[BitVec, BitVec]]] \
            = {}
        #: (input tid, same-width concrete count) -> cached axiom term
        self._axiom_cache: Dict[Tuple[int, int], Bool] = {}
        #: create_conditions memo — the population-count key is only
        #: valid within one manager lifetime (slabs re-allocate after
        #: reset), so __init__ must drop it explicitly
        self._conditions_cache = None

    def reset(self):
        self.__init__()

    # -- model records ------------------------------------------------------

    def _model(self, width: int) -> _WidthModel:
        model = self._widths.get(width)
        if model is None:
            if self._next_slab >= 1 << (256 - PREFIX_BITS - SLAB_BITS):
                raise RuntimeError(
                    "placeholder region exhausted: more than "
                    f"{1 << (256 - PREFIX_BITS - SLAB_BITS)} distinct "
                    "keccak input widths in one run")
            lo = REGION_LO + self._next_slab * SLAB
            self._next_slab += 1
            model = _WidthModel(
                uf=Function(f"kec{width}", [width], 256),
                inverse=Function(f"unkec{width}", [256], width),
                slab_lo=lo,
                slab_hi=lo + SLAB,
            )
            self._widths[width] = model
        return model

    def get_function(self, length: int) -> Tuple[Function, Function]:
        """(keccak UF, inverse UF) for an input width."""
        model = self._model(length)
        return model.uf, model.inverse

    def inverse_for(self, length: int) -> Function:
        return self._model(length).inverse

    # -- placeholder region -------------------------------------------------

    @staticmethod
    def value_in_placeholder_region(value: int) -> bool:
        return value >= REGION_LO

    @classmethod
    def might_contain_placeholder(cls, hex_text: str) -> bool:
        """Fast scan gate: can this hex blob hold a placeholder hash?"""
        return cls.hash_matcher in hex_text

    # -- hashing ------------------------------------------------------------

    @staticmethod
    def find_concrete_keccak(data: BitVec) -> BitVec:
        raw = data.value.to_bytes(data.size() // 8, byteorder="big")
        return symbol_factory.BitVecVal(
            int.from_bytes(sha3(raw), "big"), 256)

    @staticmethod
    def get_empty_keccak_hash() -> BitVec:
        return symbol_factory.BitVecVal(
            int.from_bytes(sha3(b""), "big"), 256)

    def create_keccak(self, data: BitVec) -> BitVec:
        """The engine's SHA3 result for `data`: the real hash when the
        input is concrete, the width's UF applied to it otherwise."""
        model = self._model(data.size())
        if not data.symbolic:
            result = self.find_concrete_keccak(data)
            if data not in self.concrete_hashes:
                self._concrete_by_width.setdefault(
                    data.size(), []).append((data, result))
            self.concrete_hashes[data] = result
            return result
        model.symbolic_inputs.append(data)
        result = model.uf(data)
        model.results.append(result)
        return result

    # -- axioms -------------------------------------------------------------

    def _axiom_for(self, data: BitVec) -> Bool:
        """inverse(kec(x)) == x, and kec(x) either lives 64-aligned in
        the width's slab or coincides with a known concrete hash whose
        input x equals. Cached per (input, concrete-escape count)."""
        width = data.size()
        model = self._widths[width]
        same_width = self._concrete_by_width.get(width, ())
        key = (data.raw.tid, len(same_width))
        cached = self._axiom_cache.get(key)
        if cached is not None:
            return cached
        h = model.uf(data)
        in_slab = And(
            ULE(symbol_factory.BitVecVal(model.slab_lo, 256), h),
            ULT(h, symbol_factory.BitVecVal(model.slab_hi, 256)),
            URem(h, symbol_factory.BitVecVal(ALIGN, 256))
            == symbol_factory.BitVecVal(0, 256),
        )
        escape = symbol_factory.Bool(False)
        for conc_input, conc_hash in same_width:
            escape = Or(escape,
                        And(h == conc_hash, data == conc_input))
        axiom = And(model.inverse(h) == data, Or(in_slab, escape))
        self._axiom_cache[key] = axiom
        return axiom

    def create_conditions(self) -> Bool:
        """The conjunction of every axiom this run's hashes need —
        appended to each solver query by Constraints.get_all_constraints
        (laser/state/constraints.py). Memoized on the manager's hash
        population: terminal storms call this once per open state
        (16k+ times a run) while the population changes only when a
        new hash appears."""
        key = (
            tuple((w, len(m.symbolic_inputs))
                  for w, m in self._widths.items()),
            len(self.concrete_hashes),
        )
        cached = getattr(self, "_conditions_cache", None)
        if cached is not None and cached[0] == key:
            return cached[1]
        out = self._create_conditions_uncached()
        self._conditions_cache = (key, out)
        return out

    def _create_conditions_uncached(self) -> Bool:
        parts: List[Bool] = []
        for model in self._widths.values():
            parts.extend(self._axiom_for(data)
                         for data in model.symbolic_inputs)
        for conc_input, conc_hash in self.concrete_hashes.items():
            uf, inverse = self.get_function(conc_input.size())
            applied = uf(conc_input)
            parts.append(And(applied == conc_hash,
                             inverse(applied) == conc_input))
        if not parts:
            return symbol_factory.Bool(True)
        return And(*parts)

    # -- model extraction ---------------------------------------------------

    def get_concrete_hash_data(self, model
                               ) -> Dict[int, List[Optional[int]]]:
        """Per input width, the model's concrete values for every UF
        hash result (report back-substitution input)."""
        out: Dict[int, List[Optional[int]]] = {}
        for width, wm in self._widths.items():
            values: List[Optional[int]] = []
            for result in wm.results:
                evaluated = model.eval(result, model_completion=False)
                if evaluated is None or evaluated.value is None:
                    continue
                values.append(evaluated.value)
            out[width] = values
        return out


from ...support.run_context import SwappableProxy  # noqa: E402

# per-run axiom state behind a stable handle (SURVEY §5 parallel-safe
# contexts; support/run_context.RunContext.activate swaps it)
keccak_function_manager = SwappableProxy(KeccakFunctionManager())
