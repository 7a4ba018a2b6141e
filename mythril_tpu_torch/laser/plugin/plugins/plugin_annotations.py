"""Annotations used by the built-in plugins (capability parity:
mythril/laser/plugin/plugins/plugin_annotations.py:20-123)."""

import logging
from copy import copy
from typing import Dict, List, Set

from ...state.annotation import MergeableStateAnnotation, StateAnnotation

log = logging.getLogger(__name__)


class MutationAnnotation(StateAnnotation):
    """Marks states that executed a state-mutating instruction."""

    @property
    def persist_over_calls(self) -> bool:
        return True


class DependencyAnnotation(MergeableStateAnnotation):
    """Tracks storage reads/writes during each transaction."""

    def __init__(self):
        self.storage_loaded: Set = set()
        self.storage_written: Dict[int, Set] = {}
        self.has_call: bool = False
        self.path: List = [0]
        self.blocks_seen: Set[int] = set()

    def __copy__(self):
        result = DependencyAnnotation()
        result.storage_loaded = copy(self.storage_loaded)
        result.storage_written = copy(self.storage_written)
        result.has_call = self.has_call
        result.path = copy(self.path)
        result.blocks_seen = copy(self.blocks_seen)
        return result

    def get_storage_write_cache(self, iteration: int):
        return self.storage_written.get(iteration, set())

    def extend_storage_write_cache(self, iteration: int, value):
        if iteration not in self.storage_written:
            self.storage_written[iteration] = set()
        self.storage_written[iteration].add(value)

    def check_merge_annotation(self, other: "DependencyAnnotation"):
        if not isinstance(other, DependencyAnnotation):
            raise TypeError(
                "Expected an instance of DependencyAnnotation"
            )
        return self.has_call == other.has_call and self.path == other.path

    def merge_annotation(self, other: "DependencyAnnotation"):
        merged = DependencyAnnotation()
        merged.blocks_seen = self.blocks_seen.union(other.blocks_seen)
        merged.has_call = self.has_call
        merged.path = copy(self.path)
        merged.storage_loaded = self.storage_loaded.union(
            other.storage_loaded
        )
        keys = set(
            list(self.storage_written.keys())
            + list(other.storage_written.keys())
        )
        for key in keys:
            merged.storage_written[key] = self.storage_written.get(
                key, set()
            ).union(other.storage_written.get(key, set()))
        return merged


class WSDependencyAnnotation(MergeableStateAnnotation):
    """A stack of dependency annotations carried on the world state across
    transactions."""

    def __init__(self):
        self.annotations_stack: List = []

    def __copy__(self):
        result = WSDependencyAnnotation()
        result.annotations_stack = copy(self.annotations_stack)
        return result

    def check_merge_annotation(self, annotation:
                               "WSDependencyAnnotation") -> bool:
        if len(self.annotations_stack) != len(
            annotation.annotations_stack
        ):
            return False
        for a1, a2 in zip(
            self.annotations_stack, annotation.annotations_stack
        ):
            if a1 == a2:
                continue
            if (
                isinstance(a1, MergeableStateAnnotation)
                and isinstance(a2, MergeableStateAnnotation)
                and a1.check_merge_annotation(a2)
            ):
                continue
            return False
        return True

    def merge_annotation(self, annotation: "WSDependencyAnnotation"
                         ) -> "WSDependencyAnnotation":
        merged = WSDependencyAnnotation()
        for a1, a2 in zip(
            self.annotations_stack, annotation.annotations_stack
        ):
            if a1 == a2:
                merged.annotations_stack.append(copy(a1))
            else:
                merged.annotations_stack.append(a1.merge_annotation(a2))
        return merged
