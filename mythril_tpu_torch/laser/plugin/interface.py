"""Laser plugin interface (reference parity:
mythril/laser/plugin/interface.py:18)."""


class LaserPlugin:
    """A laser plugin instruments the symbolic VM with hooks."""

    def initialize(self, symbolic_vm) -> None:
        """Install this plugin's hooks on the given vm."""
        raise NotImplementedError
