"""Helpers usable inside detection modules (reference parity:
mythril/analysis/module/module_helpers.py:4-13)."""

import traceback


def is_prehook() -> bool:
    """True when the calling detector runs inside a pre-hook (stack
    inspection, same trick as the reference)."""
    return any(
        "pre_hook" in frame.name or "_execute_pre_hook" in frame.name
        for frame in traceback.extract_stack()
    )
