"""Expression wrapper: a term plus an annotation set.

Parity with reference mythril/laser/smt/expression.py:10-71 — annotations are
the taint-tracking payload detectors rely on (e.g. integer overflow taint,
predictable-value taint); they live on the wrapper, never in the interned DAG,
and union through every operation.
"""

from typing import Generic, List, Optional, Set, TypeVar

from . import terms as T

G = TypeVar("G")


class Expression(Generic[G]):
    """Wraps a DAG term and carries annotations."""

    def __init__(self, raw: "T.Term", annotations: Optional[Set] = None):
        self.raw = raw
        # lazy: most facades never carry annotations, and the empty-set
        # allocation per wrapper dominated terminal-storm
        # materialization (None stands for "empty"; materialized on
        # first annotate). Callers treat `annotations` as read-only
        # (union/iterate) — smt/bool._union_annotations et al.
        if not annotations:
            self._annotations = None  # empty set normalizes too
        elif isinstance(annotations, set):
            self._annotations = annotations
        else:
            self._annotations = set(annotations)

    @property
    def annotations(self) -> Set:
        ann = self._annotations
        if ann is None:
            # materialize on access: returning a throwaway empty set
            # silently dropped `expr.annotations.add(x)` on annotation-
            # free expressions (the lazy slot stayed None); the lazy
            # win is preserved for wrappers whose annotations are never
            # read
            ann = self._annotations = set()
        return ann

    @annotations.setter
    def annotations(self, value) -> None:
        self._annotations = set(value)

    def annotate(self, annotation) -> None:
        if self._annotations is None:
            self._annotations = {annotation}
        else:
            self._annotations.add(annotation)

    def get_annotations(self, annotation_type: type) -> List:
        ann = self._annotations
        if not ann:
            return []
        return [a for a in ann if isinstance(a, annotation_type)]

    def __repr__(self) -> str:
        return repr(self.raw)

    def size(self):
        w = self.raw.width
        return w if isinstance(w, int) else None

    def __hash__(self) -> int:
        return self.raw.tid

    def __reduce__(self):
        # checkpoint pickling: rebuild with `raw` set IMMEDIATELY (the
        # object may be a dict key inside a reference cycle, so it must
        # hash before its BUILD state arrives); everything else — the
        # annotation set, subclass fields — restores through the state
        # dict afterwards
        state = dict(self.__dict__)
        state.pop("raw", None)
        return (_rebuild_expr, (self.__class__, self.raw), state)


def _rebuild_expr(cls, raw):
    obj = cls.__new__(cls)
    obj.raw = raw
    return obj


def simplify(expression: Expression) -> Expression:
    """Rebuild the term (constructors fold constants / apply local rules).

    Reference parity: mythril/laser/smt/expression.py:62-71.
    """
    t = expression.raw
    simplified = T.substitute_term(t, {})
    expression.raw = simplified
    return expression
