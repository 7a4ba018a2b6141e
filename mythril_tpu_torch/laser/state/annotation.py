"""State annotations: detector/plugin payloads carried on states
(reference parity: mythril/laser/ethereum/state/annotation.py:11-74 —
expressed as class-attribute flags rather than the reference's
per-instance property methods; subclasses override a value instead of
re-implementing a getter)."""


class StateAnnotation:
    """Annotations are copied along with the states they decorate; the
    class attributes below control propagation.

    persist_to_world_state -- copy to the world state at tx end
    persist_over_calls     -- keep on the caller state across message
                              calls
    search_importance      -- weight used by beam search (1 = default);
                              may also be a property on subclasses that
                              derive it from their payload
    """

    persist_to_world_state: bool = False
    persist_over_calls: bool = False
    search_importance: int = 1


class MergeableStateAnnotation(StateAnnotation):
    """Annotation that supports state-merging workflows; subclasses
    decide mergeability and produce the merged payload."""

    def check_merge_annotation(self, annotation) -> bool:
        raise NotImplementedError

    def merge_annotation(self, annotation):
        raise NotImplementedError


class NoCopyAnnotation(StateAnnotation):
    """Shared by reference instead of copied (for expensive or
    immutable payloads)."""

    def __copy__(self):
        return self

    def __deepcopy__(self, _):
        return self
