"""Solver facades over the native decision core (reference parity:
mythril/laser/smt/solver/solver.py:18-135 and independence_solver.py:88-152,
with z3 replaced by mythril_tpu_torch's own pipeline)."""

import logging
from typing import Dict, List, Optional

from .. import terms as T
from ..bool import Bool
from ..model import Model
from .core import SAT, UNKNOWN, UNSAT, check
from .solver_statistics import SolverStatistics, stat_smt_query

log = logging.getLogger(__name__)

# check-result sentinels (role of z3.sat / z3.unsat / z3.unknown)
sat = SAT
unsat = UNSAT
unknown = UNKNOWN


class BaseSolver:
    def __init__(self) -> None:
        self.constraints: List[Bool] = []
        self.timeout_ms = 10000
        self.minimize_terms: List = []
        self.maximize_terms: List = []
        self._last = None
        self._phase_hint = None

    def set_timeout(self, timeout: int) -> None:
        """Timeout in milliseconds (parity: solver.py:23-30)."""
        self.timeout_ms = timeout

    def set_phase_hint(self, model_data) -> None:
        """Warm-start the decision phases from a model satisfying the
        constraints (optimization queries: quick-sat/repair supplies
        it; the objective bound search then starts near a solution)."""
        self._phase_hint = model_data

    def add(self, *constraints) -> None:
        for c in constraints:
            if isinstance(c, (list, tuple)):
                self.constraints.extend(c)
            else:
                self.constraints.append(c)

    def append(self, *constraints) -> None:
        self.add(*constraints)

    @stat_smt_query
    def check(self, *extra) -> str:
        terms = [c.raw for c in self.constraints]
        terms.extend(c.raw for c in extra)
        try:
            self._last = check(
                terms,
                timeout_s=self.timeout_ms / 1000.0,
                minimize=[m.raw for m in self.minimize_terms],
                maximize=[m.raw for m in self.maximize_terms],
                phase_hint=self._phase_hint,
            )
        except Exception as e:  # parity: z3 crashes map to unknown
            log.info("solver exception treated as unknown: %r", e)
            self._last = None
            return unknown
        return self._last.status

    def model(self) -> Model:
        if self._last is None or self._last.model is None:
            return Model()
        return Model([self._last.model])

    def sexpr(self) -> str:
        """SMT-LIB-ish dump for --solver-log."""
        lines = [f"; mythril_tpu_torch query, timeout={self.timeout_ms}ms"]
        for c in self.constraints:
            lines.append(f"(assert {c.raw!r})")
        lines.append("(check-sat)")
        return "\n".join(lines)

    def reset(self) -> None:
        self.constraints = []
        self._last = None


class Solver(BaseSolver):
    """An SMT solver object."""

    def pop(self, num) -> None:
        if num:
            self.constraints = self.constraints[:-num]


class Optimize(BaseSolver):
    """An optimizing solver (z3.Optimize role: tx-sequence input
    minimization, reference analysis/solver.py:222-259)."""

    def minimize(self, element) -> None:
        self.minimize_terms.append(element)

    def maximize(self, element) -> None:
        self.maximize_terms.append(element)


class IndependenceSolver:
    """Partitions constraints into variable-independence buckets and solves
    them separately (reference independence_solver.py:88-152)."""

    def __init__(self) -> None:
        self.constraints: List[Bool] = []
        self.timeout_ms = 10000
        self.models: List = []

    def set_timeout(self, timeout: int) -> None:
        self.timeout_ms = timeout

    def add(self, *constraints) -> None:
        for c in constraints:
            if isinstance(c, (list, tuple)):
                self.constraints.extend(c)
            else:
                self.constraints.append(c)

    def append(self, *constraints) -> None:
        self.add(*constraints)

    @stat_smt_query
    def check(self, *extra) -> str:
        from .core import _free_var_tids

        terms = [c.raw for c in self.constraints]
        terms.extend(c.raw for c in extra)
        # union-find over shared free variables
        parent: Dict[int, int] = {}

        def find(x):
            while parent.get(x, x) != x:
                parent[x] = parent.get(parent[x], parent[x])
                x = parent[x]
            return x

        def union(a, b):
            ra, rb = find(a), find(b)
            if ra != rb:
                parent[ra] = rb

        buckets: Dict[int, List] = {}
        var_root: Dict[int, int] = {}
        for i, t in enumerate(terms):
            fv = _free_var_tids(t)
            anchor = None
            for v in fv:
                if v in var_root:
                    if anchor is None:
                        anchor = var_root[v]
                    else:
                        union(var_root[v], anchor)
                else:
                    if anchor is None:
                        anchor = v
                    var_root[v] = anchor
            # terms with no free vars get their own bucket keyed by index
            key = find(anchor) if anchor is not None else -(i + 1)
            buckets.setdefault(key, []).append(t)
        # normalize: merge buckets whose keys united
        merged: Dict[int, List] = {}
        for key, ts in buckets.items():
            root = find(key) if key >= 0 else key
            merged.setdefault(root, []).extend(ts)

        self.models = []
        overall = sat
        for ts in merged.values():
            try:
                ctx = check(ts, timeout_s=self.timeout_ms / 1000.0)
            except Exception as e:  # parity with BaseSolver: crash -> unknown
                log.info(
                    "solver exception treated as unknown: %r", e
                )
                overall = unknown
                continue
            if ctx.status == unsat:
                return unsat
            if ctx.status == unknown:
                overall = unknown
            elif ctx.model is not None:
                self.models.append(ctx.model)
        return overall

    def model(self) -> Model:
        return Model(self.models)

    def sexpr(self) -> str:
        lines = [f"; mythril_tpu_torch independence query"]
        for c in self.constraints:
            lines.append(f"(assert {c.raw!r})")
        lines.append("(check-sat)")
        return "\n".join(lines)

    def reset(self) -> None:
        self.constraints = []
        self.models = []
