"""Deferred issue solving (capability parity:
mythril/analysis/potential_issues.py:11-123 — restructured: the
tx-end discharge runs as a screened wave, and promotion of a surviving
candidate to a real Issue is its own step).  Detectors queue
PotentialIssues with extra constraints; check_potential_issues solves
them lazily at transaction end."""

from ..exceptions import UnsatError
from ..laser.state.annotation import StateAnnotation
from ..laser.state.global_state import GlobalState
from ..smt import And
from ..support.support_args import args
from .issue_annotation import IssueAnnotation
from .report import Issue
from .solver import get_transaction_sequence

class PotentialIssue:
    """A not-yet-verified issue candidate with its extra constraints."""

    __slots__ = (
        "contract", "function_name", "address", "swc_id", "title",
        "bytecode", "detector", "severity", "description_head",
        "description_tail", "constraints",
    )

    def __init__(self, contract, function_name, address, swc_id, title,
                 bytecode, detector, severity=None,
                 description_head="", description_tail="",
                 constraints=None):
        self.contract = contract
        self.function_name = function_name
        self.address = address
        self.swc_id = swc_id
        self.title = title
        self.bytecode = bytecode
        self.detector = detector
        self.severity = severity
        self.description_head = description_head
        self.description_tail = description_tail
        self.constraints = constraints or []


class PotentialIssuesAnnotation(StateAnnotation):
    def __init__(self):
        self.potential_issues = []

    @property
    def search_importance(self):
        return 10 * len(self.potential_issues)


def get_potential_issues_annotation(state: GlobalState
                                    ) -> PotentialIssuesAnnotation:
    for annotation in state.annotations:
        if isinstance(annotation, PotentialIssuesAnnotation):
            return annotation
    annotation = PotentialIssuesAnnotation()
    state.annotate(annotation)
    return annotation


def _promote(state: GlobalState, candidate: PotentialIssue,
             transaction_sequence) -> None:
    """A satisfiable candidate becomes a real Issue on its detector."""
    issue = Issue(
        contract=candidate.contract,
        function_name=candidate.function_name,
        address=candidate.address,
        title=candidate.title,
        bytecode=candidate.bytecode,
        swc_id=candidate.swc_id,
        gas_used=(state.mstate.min_gas_used, state.mstate.max_gas_used),
        severity=candidate.severity,
        description_head=candidate.description_head,
        description_tail=candidate.description_tail,
        transaction_sequence=transaction_sequence,
    )
    state.annotate(
        IssueAnnotation(
            detector=candidate.detector,
            issue=issue,
            conditions=[
                And(
                    *(
                        state.world_state.constraints
                        + candidate.constraints
                    )
                )
            ],
        )
    )
    if args.use_issue_annotations is False:
        candidate.detector.issues.append(issue)
        candidate.detector.update_cache([issue])


def check_potential_issues(state: GlobalState) -> None:
    """Solve pending potential issues at transaction end; satisfiable
    ones become real Issues on their detector, unsatisfiable ones stay
    queued on the annotation."""
    discharge_wave([state])


def discharge_wave(states: list) -> None:
    """Cross-state transaction-end discharge: EVERY end state's pending
    candidates screen in ONE interval batch — at device batch sizes
    where the per-state wave saw only a handful — then only the
    survivors pay solver queries (check_potential_issues semantics,
    applied wave-wide). The per-item constraint lists include the
    run's keccak axioms, so probe constraints like
    `hash == small-constant` die in the screen."""
    items = []  # (state, annotation, candidate)
    base_cache: dict = {}
    for state in states:
        annotation = get_potential_issues_annotation(state)
        for pi in annotation.potential_issues:
            items.append((state, annotation, pi))
    if not items:
        return
    from ..models.pruner import _screen_interval

    def _constraints(item):
        state, _, pi = item
        base = base_cache.get(id(state))
        if base is None:
            base = list(
                state.world_state.constraints.get_all_constraints())
            base_cache[id(state)] = base
        return base + list(pi.constraints)

    survivors = (_screen_interval(items, _constraints)
                 if len(items) > 1 else items)
    # key by (state, candidate): forked siblings share one candidate
    # list via the annotation copy, and a pi screened out under one
    # state's constraints may survive under a sibling's
    alive = {(id(it[0]), id(it[2])) for it in survivors}
    leftovers: dict = {}
    for state, annotation, pi in items:
        entry = leftovers.setdefault(id(annotation), (annotation, []))
        if (id(state), id(pi)) not in alive:
            entry[1].append(pi)
            continue
        try:
            transaction_sequence = get_transaction_sequence(
                state,
                state.world_state.constraints + pi.constraints,
            )
        except UnsatError:
            entry[1].append(pi)
            continue
        _promote(state, pi, transaction_sequence)
    for annotation, remaining in leftovers.values():
        annotation.potential_issues = remaining
