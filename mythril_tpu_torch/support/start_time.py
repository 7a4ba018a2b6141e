"""Start-time singleton (capability parity: mythril/support/start_time.py
— records when the current contract's execution began; consumed by
deadline bookkeeping)."""

from time import time

from .support_utils import Singleton


class StartTime(object, metaclass=Singleton):
    """Maintains the start time of the current contract in execution."""

    def __init__(self):
        self.global_start_time = time()
