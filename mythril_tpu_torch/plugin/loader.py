"""Mythril-level plugin loader (capability parity:
mythril/plugin/loader.py:21-98): validates a plugin and dispatches it to
the right subsystem — detection modules to the ModuleLoader, laser
plugins to the LaserPluginLoader."""

import logging
from typing import Dict

from ..analysis.module.base import DetectionModule
from ..analysis.module.loader import ModuleLoader
from ..laser.plugin.loader import LaserPluginLoader
from ..support.support_utils import Singleton
from .discovery import PluginDiscovery
from .interface import MythrilLaserPlugin, MythrilPlugin

log = logging.getLogger(__name__)


class UnsupportedPluginType(Exception):
    """Raised when a plugin with an unsupported type is loaded."""


class MythrilPluginLoader(object, metaclass=Singleton):
    """Loads MythrilPlugins, including default-enabled installed ones."""

    def __init__(self):
        log.info("Initializing mythril plugin loader")
        self.loaded_plugins = []
        self.plugin_args: Dict[str, Dict] = dict()
        self._load_default_enabled()

    def set_args(self, plugin_name: str, **kwargs):
        self.plugin_args[plugin_name] = kwargs

    def load(self, plugin: MythrilPlugin):
        if not isinstance(plugin, MythrilPlugin):
            raise ValueError("Passed plugin is not of type MythrilPlugin")
        log.info("Loading plugin: %s", plugin)
        if isinstance(plugin, DetectionModule):
            self._load_detection_module(plugin)
        elif isinstance(plugin, MythrilLaserPlugin):
            self._load_laser_plugin(plugin)
        else:
            raise UnsupportedPluginType(
                "Passed plugin type is not yet supported"
            )
        self.loaded_plugins.append(plugin)

    @staticmethod
    def _load_detection_module(plugin: DetectionModule) -> None:
        ModuleLoader().register_module(plugin)

    @staticmethod
    def _load_laser_plugin(plugin: MythrilLaserPlugin) -> None:
        LaserPluginLoader().load(plugin)

    def _load_default_enabled(self) -> None:
        for plugin_name in PluginDiscovery().get_plugins(
            default_enabled=True
        ):
            try:
                plugin = PluginDiscovery().build_plugin(
                    plugin_name, self.plugin_args.get(plugin_name, {})
                )
                self.load(plugin)
            except Exception:  # noqa: BLE001 - see discovery
                log.exception("failed to load plugin %s", plugin_name)
