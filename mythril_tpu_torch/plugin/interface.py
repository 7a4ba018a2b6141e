"""Plugin interfaces third-party packages implement (capability parity:
mythril/plugin/interface.py:5-45).

A plugin can: extend the LASER engine (implement MythrilLaserPlugin,
which is also a laser PluginBuilder), add a detection module (subclass
DetectionModule), or add CLI commands (MythrilCLIPlugin)."""

from abc import ABC

from ..laser.plugin.builder import PluginBuilder as LaserPluginBuilder


class MythrilPlugin:
    """Base interface for every Mythril-level plugin."""

    author = "Default Author"
    name = "Plugin Name"
    plugin_license = "All rights reserved."
    plugin_type = "Mythril Plugin"
    plugin_version = "0.0.1"
    plugin_description = "This is an example plugin description"
    plugin_default_enabled = False

    def __init__(self, **kwargs):
        pass

    def __repr__(self):
        return (
            f"{type(self).__name__} - {self.plugin_version} - {self.author}"
        )


class MythrilCLIPlugin(MythrilPlugin):
    """Interface for plugins that add commands to the myth CLI."""


class MythrilLaserPlugin(MythrilPlugin, LaserPluginBuilder, ABC):
    """Interface for plugins that instrument the LASER EVM."""
