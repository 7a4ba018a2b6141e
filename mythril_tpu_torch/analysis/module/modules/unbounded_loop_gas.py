"""Unbounded-loop gas-griefing detector (SWC-128, docs/static_pass.md
§loop summaries).

The loop-summary layer (analysis/static_pass/loop_summary.py)
recognizes counter loops and synthesizes their iteration hulls.  A
hull whose bound is NOT a static constant is unbounded — and when the
loop condition is additionally attacker-tainted (PR-8 site taints:
CALLDATA/CALLVALUE/SLOAD flow into the head JUMPI's condition), the
caller controls how many iterations the contract burns, which is the
classic gas-griefing / DoS-with-block-gas-limit shape: drive the
bound high enough and the function can no longer complete within the
block gas limit.

The trigger predicate is the *failure* of the termination side of the
summary layer: a loop the closed-form machinery can bound never fires
here.  Detection is CALLBACK on JUMPI — the module plugs into the
detection-module seam with zero engine changes (the lane path lifts
the hook through a drain-time adapter, lane_adapters.py, exactly like
the other taint-style JUMPI modules).
"""

import logging
from copy import copy
from typing import List

from ....exceptions import UnsatError
from ....laser.state.global_state import GlobalState
from ....smt import And, Bool
from ...issue_annotation import IssueAnnotation
from ...report import Issue
from ...solver import get_transaction_sequence
from ...swc_data import DOS_WITH_BLOCK_GAS_LIMIT
from ..base import DetectionModule, EntryPoint

log = logging.getLogger(__name__)


def _attacker_tainted(info, jumpi_pc: int) -> bool:
    """Static taint check: does the head condition provably carry
    attacker-drivable flow?  TOP does NOT fire — an unmodeled origin
    is not a proof of attacker control, and this module values
    precision over recall (it rides the default module set)."""
    try:
        from ....analysis.static_pass import taint as taint_mod

        st = info.site_taints.get(jumpi_pc)
        if st is None or st.cond is None:
            return False
        bits = (taint_mod.CALLDATA | taint_mod.CALLVALUE
                | taint_mod.SLOAD)
        return bool(st.cond & bits)
    except Exception:
        return False


def loop_head_hit(code_obj, jumpi_byte_pc: int):
    """The unbounded-and-tainted loop template anchored at this JUMPI,
    or None.  Shared by the host pre-hook and the lane drain adapter
    so both paths fire on exactly the same predicate."""
    try:
        from ....analysis import static_pass
        from ....analysis.static_pass import loop_summary

        if not loop_summary.enabled():
            return None
        info = static_pass.info_for_code_obj(code_obj)
        if info is None:
            return None
        t = loop_summary.template_at_jumpi(info, jumpi_byte_pc)
        if t is None or not t.unbounded:
            return None
        if not _attacker_tainted(info, jumpi_byte_pc):
            return None
        return t
    except Exception as e:
        log.debug("unbounded-loop probe failed: %s", e)
        return None


class UnboundedLoopGas(DetectionModule):
    """Fires when a recognized counter loop's iteration hull is
    unbounded and the bound is attacker-tainted."""

    name = "Caller can force unbounded loop iteration (gas griefing)"
    swc_id = DOS_WITH_BLOCK_GAS_LIMIT
    description = (
        "Check for loops whose iteration count is controlled by "
        "transaction input (DoS with block gas limit)"
    )
    entry_point = EntryPoint.CALLBACK
    pre_hooks = ["JUMPI"]

    def execute(self, target: GlobalState):
        """Static pre-screen ahead of the base-class machinery: almost
        no JUMPI is an unbounded tainted loop head, and the base
        execute() pays a code hash per call for its issue-cache key —
        skip all of it on the (overwhelming) template-less path."""
        if loop_head_hit(
                target.environment.code,
                target.get_current_instruction()["address"]) is None:
            return []
        return super().execute(target)

    def _execute(self, state: GlobalState) -> List[Issue]:
        instr = state.get_current_instruction()
        template = loop_head_hit(state.environment.code,
                                 instr["address"])
        if template is None:
            return []
        condition = state.mstate.stack[-2]
        # the host interpreter hands the raw JUMPI word; the lane
        # drain adapter hands the fork record's Bool condition — both
        # shapes normalize to "the continue condition"
        if isinstance(condition, Bool):
            continue_cond = condition
            concrete = condition.is_true or condition.is_false
        else:
            continue_cond = condition != 0
            concrete = not getattr(condition, "symbolic", False)
        if concrete:
            # a runtime-concrete condition means THIS instance is
            # bounded after all (the summary layer handles it)
            return []
        constraints = copy(state.world_state.constraints)
        constraints.append(continue_cond)
        try:
            transaction_sequence = get_transaction_sequence(
                state, constraints
            )
        except UnsatError:
            return []
        log.info("unbounded attacker-tainted loop at %d",
                 instr["address"])
        issue = Issue(
            contract=state.environment.active_account.contract_name,
            function_name=state.environment.active_function_name,
            address=instr["address"],
            swc_id=DOS_WITH_BLOCK_GAS_LIMIT,
            title="Loop iteration count controllable by the caller",
            severity="Medium",
            bytecode=state.environment.code.bytecode,
            description_head=(
                "The number of loop iterations is controlled by "
                "transaction input."
            ),
            description_tail=(
                "A loop bound derived from calldata, call value or "
                "attacker-writable storage lets a caller drive the "
                "iteration count arbitrarily high. Gas consumption "
                "then grows without bound and the function can be "
                "forced to exceed the block gas limit (denial of "
                "service / gas griefing). Cap the iteration count or "
                "paginate the operation."
            ),
            gas_used=(
                state.mstate.min_gas_used, state.mstate.max_gas_used
            ),
            transaction_sequence=transaction_sequence,
        )
        state.annotate(
            IssueAnnotation(
                conditions=[And(*state.world_state.constraints),
                            continue_cond],
                issue=issue,
                detector=self,
            )
        )
        return [issue]


detector = UnboundedLoopGas()
