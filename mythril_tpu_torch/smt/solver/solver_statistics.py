"""The solver counters the device feasibility screens bump, copied from
``mythril_tpu/smt/solver/solver_statistics.py``: the same singleton,
the same ``bump``, and of its counter block only the four the screens
write. The host bridge brings the rest with the solver."""

import threading

from ...support.support_utils import Singleton


class SolverStatistics(object, metaclass=Singleton):
    """Process-wide counters of the device screens (ops/propagate.py)."""

    def __init__(self):
        # counter lock: `x += 1` is a load/add/store sequence the GIL
        # does NOT make atomic; every concurrent update routes through
        # bump()
        self._lock = threading.Lock()
        self.propagate_kills = 0      # lanes refuted by the product-
        #                               domain fixpoint screen
        self.propagate_sweeps = 0     # fixpoint sweeps executed
        self.facts_harvested = 0      # learned facts read back for
        #                               surviving lanes
        self.static_facts_seeded = 0  # implied storage facts seeded
        #                               into the screens' init tables

    def bump(self, **deltas) -> None:
        """Atomically add deltas to counters (the only update path
        safe from solver-pool worker threads)."""
        with self._lock:
            for name, delta in deltas.items():
                setattr(self, name, getattr(self, name) + delta)

    def counters(self) -> dict:
        with self._lock:
            return {"propagate_kills": self.propagate_kills,
                    "propagate_sweeps": self.propagate_sweeps,
                    "facts_harvested": self.facts_harvested,
                    "static_facts_seeded": self.static_facts_seeded}
