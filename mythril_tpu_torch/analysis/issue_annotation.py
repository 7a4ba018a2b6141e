"""Issue + satisfying conditions attached to states (reference parity:
mythril/analysis/issue_annotation.py:9-34)."""

from typing import List

from ..laser.state.annotation import StateAnnotation
from ..smt import Bool
from .report import Issue


class IssueAnnotation(StateAnnotation):
    def __init__(self, conditions: List[Bool], issue: Issue, detector):
        """
        :param conditions: The conditions that must hold for the issue
        :param issue: The issue itself
        :param detector: The detector that emitted the issue
        """
        self.conditions = conditions
        self.issue = issue
        self.detector = detector

    @property
    def persist_to_world_state(self) -> bool:
        return True

    @property
    def persist_over_calls(self) -> bool:
        return True

    def __copy__(self):
        return self
