"""Plugin loader singleton (reference parity:
mythril/laser/plugin/loader.py:12-76)."""

import logging
from typing import Dict, List, Optional

from ...support.support_utils import Singleton
from .builder import PluginBuilder
from .interface import LaserPlugin

log = logging.getLogger(__name__)


class LaserPluginLoader(object, metaclass=Singleton):
    """Registry of plugin builders; instruments VMs with enabled plugins."""

    def __init__(self) -> None:
        self.laser_plugin_builders: Dict[str, PluginBuilder] = {}
        self.plugin_args: Dict[str, Dict] = {}
        #: instances built by the most recent instrument call, by name
        #: (telemetry consumers read coverage/profile data back out)
        self.plugin_instances: Dict[str, "LaserPlugin"] = {}

    def add_args(self, plugin_name: str, **kwargs) -> None:
        self.plugin_args[plugin_name] = kwargs

    def load(self, plugin_builder: PluginBuilder) -> None:
        if plugin_builder.name in self.laser_plugin_builders:
            log.warning(
                "Laser plugin with name %s was already loaded, "
                "skipping...",
                plugin_builder.name,
            )
            return
        self.laser_plugin_builders[plugin_builder.name] = plugin_builder

    def is_enabled(self, plugin_name: str) -> bool:
        if plugin_name not in self.laser_plugin_builders:
            return False
        return self.laser_plugin_builders[plugin_name].enabled

    def enable(self, plugin_name: str):
        if plugin_name not in self.laser_plugin_builders:
            return ValueError(f"Plugin with name: `{plugin_name}` was not loaded")
        self.laser_plugin_builders[plugin_name].enabled = True

    def instrument_virtual_machine(self, symbolic_vm,
                                   with_plugins: Optional[List[str]]):
        """Install all enabled (or selected) plugins on the vm."""
        self.plugin_instances.clear()
        for plugin_name, plugin_builder in self.laser_plugin_builders.items():
            if not plugin_builder.enabled:
                continue
            if with_plugins and plugin_name not in with_plugins:
                continue
            plugin = plugin_builder(
                **self.plugin_args.get(plugin_name, {})
            )
            if not isinstance(plugin, LaserPlugin):
                log.warning(
                    "Plugin %s does not implement the LaserPlugin "
                    "interface",
                    plugin_name,
                )
                continue
            log.info("Loading laser plugin: %s", plugin_name)
            plugin.initialize(symbolic_vm)
            self.plugin_instances[plugin_name] = plugin
