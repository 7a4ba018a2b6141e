"""Plugin builder (reference parity: mythril/laser/plugin/builder.py:6)."""

from abc import ABC, abstractmethod

from .interface import LaserPlugin


class PluginBuilder(ABC):
    """Constructs a plugin instance per VM instrumentation."""

    name = "Default Plugin Name"

    def __init__(self):
        self.enabled = True

    @abstractmethod
    def __call__(self, *args, **kwargs) -> LaserPlugin:
        pass
