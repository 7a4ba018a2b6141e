"""Plugin flow-control signals (reference parity:
mythril/laser/plugin/signals.py:10-27)."""


class PluginSignal(Exception):
    """Base plugin signal."""


class PluginSkipState(PluginSignal):
    """Skip the current state: it is dropped from the worklist."""


class PluginSkipWorldState(PluginSignal):
    """Skip adding the current world state to the open states."""
