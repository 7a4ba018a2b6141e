"""Mythril-level plugin system (capability parity: mythril/plugin/ —
interface, entry-point discovery, loader)."""

from .interface import MythrilCLIPlugin, MythrilLaserPlugin, MythrilPlugin
from .loader import MythrilPluginLoader, UnsupportedPluginType

__all__ = [
    "MythrilPlugin",
    "MythrilCLIPlugin",
    "MythrilLaserPlugin",
    "MythrilPluginLoader",
    "UnsupportedPluginType",
]
