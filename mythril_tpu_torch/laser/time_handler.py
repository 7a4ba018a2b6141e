"""Global execution-deadline singleton (reference parity:
mythril/laser/ethereum/time_handler.py:5-18 — tracks an absolute
monotonic deadline instead of the reference's start/duration pair;
coupled into every solver call by support.model.get_model)."""

import time

from ..support.support_utils import Singleton


class TimeHandler(object, metaclass=Singleton):
    """Deadline for the current execution, in wall milliseconds."""

    _NO_DEADLINE = float("inf")

    def __init__(self):
        self._deadline_ms = self._NO_DEADLINE

    def start_execution(self, execution_time_s) -> None:
        self._deadline_ms = time.monotonic() * 1000 \
            + execution_time_s * 1000

    def clear(self) -> None:
        """Drop the deadline (back to the no-window state). Every
        engine entry point re-arms via start_execution, so clearing
        between independent analyses is always safe — and NOT clearing
        leaks the previous analysis's deadline into any get_model call
        made before the next engine run starts (a stale-deadline
        UnsatError time bomb)."""
        self._deadline_ms = self._NO_DEADLINE

    def snapshot(self) -> float:
        """Current deadline value (cross-tenant wave packing: the pack
        coordinator saves/restores it at member baton switches so one
        member's re-arm never shortens or extends another's window —
        docs/daemon.md §wave packing)."""
        return self._deadline_ms

    def restore(self, deadline_ms: float) -> None:
        self._deadline_ms = deadline_ms

    def time_remaining(self) -> int:
        """Milliseconds until the deadline (a large number when no
        execution window was started)."""
        if self._deadline_ms == self._NO_DEADLINE:
            return 10 ** 9
        return int(self._deadline_ms - time.monotonic() * 1000)


time_handler = TimeHandler()
