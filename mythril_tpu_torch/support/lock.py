"""File locking for shared ~/.mythril_tpu_torch state (capability parity:
mythril/support/lock.py — serializes config.ini / signature-DB access
across the many-process usage pattern the reference's parallel_test
exercises)."""

import fcntl
import os


class LockFile:
    """Advisory exclusive lock; usable as a context manager.

    ``acquire(blocking=False)`` returns False instead of waiting when
    another process holds the lock (the warm-store GC uses this: an
    entry mid-rewrite is hot and simply skipped this pass)."""

    def __init__(self, path: str):
        self.path = path
        self._fd = None

    def acquire(self, blocking: bool = True) -> bool:
        fd = os.open(self.path, os.O_CREAT | os.O_RDWR, 0o644)
        flags = fcntl.LOCK_EX | (0 if blocking else fcntl.LOCK_NB)
        try:
            fcntl.flock(fd, flags)
        except BlockingIOError:
            os.close(fd)
            return False
        except OSError:
            os.close(fd)  # flock unsupported (e.g. some NFS): no fd leak
            raise
        self._fd = fd
        return True

    def release(self) -> None:
        if self._fd is not None:
            fcntl.flock(self._fd, fcntl.LOCK_UN)
            os.close(self._fd)
            self._fd = None

    def __enter__(self) -> "LockFile":
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()
