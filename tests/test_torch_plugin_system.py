"""The port's Mythril-level plugin system (the counterpart of
tests/test_plugin_system.py): interface dispatch and discovery
(capability parity with mythril/plugin/ — reference has no tests for
this layer; these cover the loader's type dispatch and the discovery
fallback)."""

import pytest

from mythril_tpu_torch.analysis.module.base import DetectionModule, EntryPoint
from mythril_tpu_torch.analysis.module.loader import ModuleLoader
from mythril_tpu_torch.laser.plugin.interface import LaserPlugin
from mythril_tpu_torch.plugin import (
    MythrilLaserPlugin,
    MythrilPlugin,
    MythrilPluginLoader,
    UnsupportedPluginType,
)


class _MyDetector(DetectionModule, MythrilPlugin):
    name = "TestDetector"
    swc_id = "000"
    description = "a test detector"
    entry_point = EntryPoint.CALLBACK
    pre_hooks = ["STOP"]

    def _execute(self, state):
        return []


class _MyLaserPlugin(MythrilLaserPlugin):
    name = "test-laser-plugin"

    def __call__(self):
        class _P(LaserPlugin):
            def initialize(self, symbolic_vm):
                pass

        return _P()


def test_loader_rejects_non_plugin():
    loader = MythrilPluginLoader()
    with pytest.raises(ValueError):
        loader.load(object())


def test_loader_rejects_unsupported_type():
    loader = MythrilPluginLoader()
    with pytest.raises(UnsupportedPluginType):
        loader.load(MythrilPlugin())


def test_loader_registers_detection_module():
    loader = MythrilPluginLoader()
    detector = _MyDetector()
    loader.load(detector)
    assert detector in ModuleLoader().get_detection_modules()
    # clean up the singleton for other tests
    ModuleLoader()._modules.remove(detector)


def test_loader_registers_laser_plugin():
    from mythril_tpu_torch.laser.plugin.loader import LaserPluginLoader

    loader = MythrilPluginLoader()
    plugin = _MyLaserPlugin()
    loader.load(plugin)
    assert (
        LaserPluginLoader().laser_plugin_builders["test-laser-plugin"]
        is plugin
    )
    del LaserPluginLoader().laser_plugin_builders["test-laser-plugin"]


def test_discovery_lists_no_plugins_in_clean_env():
    from mythril_tpu_torch.plugin.discovery import PluginDiscovery

    disc = PluginDiscovery()
    assert isinstance(disc.installed_plugins, dict)
    assert not disc.is_installed("nonexistent-plugin-xyz")
    with pytest.raises(ValueError):
        disc.build_plugin("nonexistent-plugin-xyz", {})

