"""Execution info entries attached to reports (reference parity:
mythril/laser/execution_info.py)."""


class ExecutionInfo:
    def as_dict(self):
        """Plugin-provided execution summary."""
        raise NotImplementedError
