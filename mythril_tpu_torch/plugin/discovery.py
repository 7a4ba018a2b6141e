"""Entry-point based plugin discovery (capability parity:
mythril/plugin/discovery.py:8-57; uses importlib.metadata instead of the
deprecated pkg_resources). Third-party packages expose plugins through
the `mythril_tpu_torch.plugins` entry-point group (declared in setup.py)."""

from typing import Any, Dict, List, Optional

from ..support.support_utils import Singleton
from .interface import MythrilPlugin

ENTRY_POINT_GROUP = "mythril_tpu_torch.plugins"


class PluginDiscovery(object, metaclass=Singleton):
    """Discovers and builds plugins from installed python packages."""

    _installed_plugins: Optional[Dict[str, Any]] = None

    def init_installed_plugins(self) -> None:
        from importlib.metadata import entry_points

        try:
            eps = entry_points(group=ENTRY_POINT_GROUP)
        except TypeError:  # pragma: no cover - py<3.10 dict API
            eps = entry_points().get(ENTRY_POINT_GROUP, [])
        self._installed_plugins = {}
        for entry_point in eps:
            try:
                self._installed_plugins[entry_point.name] = (
                    entry_point.load()
                )
            except Exception:  # noqa: BLE001 - a broken plugin package
                # must not take down the host analyzer
                import logging

                logging.getLogger(__name__).exception(
                    "failed to load plugin entry point %s",
                    entry_point.name,
                )

    @property
    def installed_plugins(self) -> Dict[str, Any]:
        if self._installed_plugins is None:
            self.init_installed_plugins()
        return self._installed_plugins

    def is_installed(self, plugin_name: str) -> bool:
        return plugin_name in self.installed_plugins

    def build_plugin(self, plugin_name: str,
                     plugin_args: Dict) -> MythrilPlugin:
        if not self.is_installed(plugin_name):
            raise ValueError(
                f"Plugin with name: `{plugin_name}` is not installed"
            )
        plugin = self.installed_plugins.get(plugin_name)
        if plugin is None or not issubclass(plugin, MythrilPlugin):
            raise ValueError(f"No valid plugin was found for {plugin_name}")
        return plugin(**plugin_args)

    def get_plugins(self, default_enabled=None) -> List[str]:
        if default_enabled is None:
            return list(self.installed_plugins.keys())
        return [
            name
            for name, cls in self.installed_plugins.items()
            if getattr(cls, "plugin_default_enabled", False)
            == default_enabled
        ]
