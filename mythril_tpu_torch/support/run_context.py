"""Per-run analysis context: the state the reference keeps in process
singletons (keccak axiom manager, solver model caches, the incremental
CDCL session, detector-module issue lists, the Args flag object —
reference mythril/support/support_args.py:5-43,
mythril/laser/ethereum/function_managers/keccak_function_manager.py:25)
lives HERE per analyzer run instead (SURVEY §5's parallel-safe-context
requirement).

Every `MythrilAnalyzer` owns one RunContext and activates it on entry to
its public methods: two analyzers in one process — even alternating —
stay independent with no manual cache clearing. Activation swaps the
live implementation behind stable proxy objects (call sites keep their
plain module-level imports), parks the outgoing run's state, and
restores the incoming run's.
"""

import logging
from typing import Dict, Optional

log = logging.getLogger(__name__)

_current: Optional["RunContext"] = None


class SwappableProxy:
    """Stable module-level handle whose implementation is swapped per
    analyzer run by RunContext.activate — call sites keep their plain
    imports; only plain attribute/method access forwards (dunder
    protocols would need explicit definitions)."""

    def __init__(self, impl):
        self._impl = impl

    def __getattr__(self, name):
        return getattr(self._impl, name)


class RunContext:
    def __init__(self):
        from ..laser.function_managers.keccak_function_manager import (
            KeccakFunctionManager,
        )
        from .support_utils import ModelCache

        self.keccak_manager = KeccakFunctionManager()
        self.model_cache = ModelCache()
        self.solver_session = None  # lazily built by the solver core
        self.args_snapshot: Optional[dict] = None
        # detector-module per-run state: class name -> (issues, cache)
        self.module_state: Dict[str, tuple] = {}

    # -- swap helpers --------------------------------------------------------

    def snapshot_args(self) -> None:
        """Record the Args flag values this run was configured with
        (MythrilAnalyzer.__init__ writes cmd_args into the global Args
        object; re-activation re-applies them)."""
        from .support_args import args

        self.args_snapshot = dict(vars(args))

    def _park_modules(self, store: Dict[str, tuple]) -> None:
        for m in _loaded_modules():
            store[type(m).__name__] = (
                list(getattr(m, "issues", ())),
                set(getattr(m, "cache", ())),
            )

    def _restore_modules(self, store: Dict[str, tuple]) -> None:
        for m in _loaded_modules():
            issues, cache = store.get(type(m).__name__, ([], set()))
            if hasattr(m, "issues"):
                m.issues = list(issues)
            if hasattr(m, "cache"):
                m.cache = set(cache)

    def activate(self) -> None:
        global _current
        from ..laser.function_managers import keccak_function_manager
        from ..smt.solver import core
        from . import model as model_mod
        from .support_args import args

        # Args values ALWAYS re-apply from this run's own init-time
        # snapshot — the global Args may have been overwritten by
        # another analyzer's __init__ since (which is also why the
        # outgoing context's snapshot is NOT refreshed from the global
        # here: it would capture the other run's values)
        if self.args_snapshot is not None:
            for key, val in self.args_snapshot.items():
                setattr(args, key, val)
        if _current is self:
            return
        if _current is not None:
            _current.solver_session = core._session
            _current._park_modules(_current.module_state)
        keccak_function_manager._impl = self.keccak_manager
        model_mod.model_cache._impl = self.model_cache
        core._session = self.solver_session
        self._restore_modules(self.module_state)
        _current = self


def _loaded_modules():
    try:
        from ..analysis.module.loader import ModuleLoader

        return ModuleLoader()._modules
    except Exception:  # loader not initialized yet
        return ()


def current() -> Optional[RunContext]:
    return _current
