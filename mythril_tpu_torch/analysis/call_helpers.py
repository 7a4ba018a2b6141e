"""Helpers for analysis modules dealing with CALL-family instructions
(capability parity: mythril/analysis/call_helpers.py — parse the current
instruction's stack into an ops.Call record)."""

from typing import Union

from ..laser.natives import PRECOMPILE_COUNT
from ..laser.state.global_state import GlobalState
from .ops import Call, VarType, get_variable


def get_call_from_state(state: GlobalState) -> Union[Call, None]:
    """The Call at the current instruction, or None for precompiles."""
    instruction = state.get_current_instruction()
    op = instruction["opcode"]
    stack = state.mstate.stack

    if op in ("CALL", "CALLCODE"):
        gas, to, value, meminstart, meminsz = (
            get_variable(stack[-1]),
            get_variable(stack[-2]),
            get_variable(stack[-3]),
            get_variable(stack[-4]),
            get_variable(stack[-5]),
        )
        if to.type == VarType.CONCRETE and 0 < to.val <= PRECOMPILE_COUNT:
            return None
        if (
            meminstart.type == VarType.CONCRETE
            and meminsz.type == VarType.CONCRETE
        ):
            return Call(
                state.node, state, None, op, to, gas, value,
                state.mstate.memory[
                    meminstart.val : meminstart.val + meminsz.val
                ],
            )
        return Call(state.node, state, None, op, to, gas, value)

    # DELEGATECALL/STATICCALL: the reference helper does NOT filter
    # precompile targets on this branch (only CALL/CALLCODE do)
    gas, to = get_variable(stack[-1]), get_variable(stack[-2])
    return Call(state.node, state, None, op, to, gas)
