"""The ``Singleton`` metaclass, copied from
``mythril_tpu/support/support_utils.py`` (the one piece of that module
the port needs: ``Args`` and ``SolverStatistics`` are singletons)."""

from typing import Dict


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
