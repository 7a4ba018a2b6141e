"""Lane-engine adapters: drain-time integration of detection modules.

The TPU lane engine (laser/lane_engine.py) parks every opcode that has a
registered detector hook so the hook can fire host-side. For the default
module set that would idle the device on its hottest opcodes — JUMPI,
the arithmetic family, SSTORE — because the taint-style modules hook
them on every execution. But those hooks only *read value annotations*
(and env-source post-hooks only *write* them), so their effect can be
reproduced exactly from the drain logs without parking:

- env-source taints (ORIGIN, TIMESTAMP, …) are seeded onto the host
  term objects once per lane seed — equivalent to the post-hook because
  the interpreter pushes the same shared wrapper each execution;
- arithmetic overflow annotations are attached when the drain resolves
  a deferred record, before the result term is built (so annotation
  union propagates exactly as in the interpreter). Concrete arithmetic
  that actually wraps emits a device record too (symstep taint_table);
- JUMPI checks fire per fork-site from the path-condition log with a
  reconstructed pre-hook state (pc, constraint prefix, gas interval,
  active function) — modules run their unmodified `execute` against it;
- sink promotions (integer SSTORE/JUMPI) flow into per-lane promotion
  lists and are attached to every descendant materialized state.

A module with no adapter keeps the conservative behavior: its hooked
opcodes park. This file is the TPU-first redesign of the detection
layer's engine contract; module policy code (what is a vulnerability)
is unchanged and keeps capability parity with the reference
(mythril/analysis/module/modules/*)."""

import logging
from typing import Dict, FrozenSet, List, Optional

log = logging.getLogger(__name__)


class LaneAdapter:
    """Base adapter: nothing lifted, no drain-time work."""

    #: hooked opcodes that need not park when this module is loaded
    lifted_hooks: FrozenSet[str] = frozenset()
    #: opcodes the device needs extra records/parks for (symstep
    #: taint_table semantics)
    taint_ops: FrozenSet[str] = frozenset()

    def __init__(self, module):
        self.module = module

    def seed_env(self, env_objects: Dict[str, object], gs) -> None:
        """Annotate env-source term objects at lane seed time
        (replaces the module's post-hooks on source opcodes)."""

    def seed_ok(self, gs) -> bool:
        """False if this entry state must stay host-side for the
        module's semantics to hold."""
        return True

    def pre_resolve(self, opname: str, args, site) -> None:
        """Called when the drain resolves a *new* deferred arithmetic
        record, before the result term is constructed."""

    def on_sstore(self, value, site, key=None) -> List[object]:
        """Promotions for a device-executed SSTORE sink record. `key`
        is the resolved storage key term (None on legacy call sites)."""
        return []

    def on_jumpi(self, cond, site) -> List[object]:
        """Promotions for one JUMPI fork site (called once per lane
        carrying the site's path-condition record)."""
        return []

    def on_jumpi_site(self, cond, site) -> None:
        """Issue-firing work for one *unique* JUMPI fork site (deduped
        across the sibling lanes that share the record)."""

    def attach(self, gs, promotions: List[object],
               last_jump: Optional[int]) -> None:
        """Transfer per-lane drain state onto a materialized
        GlobalState."""


class ArbitraryJumpAdapter(LaneAdapter):
    """arbitrary_jump no-ops on concrete destinations
    (modules/arbitrary_jump.py), and device-executed JUMP/JUMPI always
    have concrete destinations (symbolic ones park) — lift both hooks
    with no drain work."""

    lifted_hooks = frozenset({"JUMP", "JUMPI"})


class ExceptionsAdapter(LaneAdapter):
    """exceptions' JUMP hook only records the last jump address for its
    issue cache key; the device tracks it in the last_jump plane."""

    lifted_hooks = frozenset({"JUMP"})

    def attach(self, gs, promotions, last_jump):
        if last_jump is None or last_jump < 0:
            return
        from .modules.exceptions import LastJumpAnnotation

        anns = list(gs.get_annotations(LastJumpAnnotation))
        if anns:
            anns[0].last_jump = last_jump
        else:
            gs.annotate(LastJumpAnnotation(last_jump))


class TxOriginAdapter(LaneAdapter):
    lifted_hooks = frozenset({"JUMPI", "ORIGIN"})

    def seed_env(self, env_objects, gs):
        from ...smt import BitVec
        from .modules.dependence_on_origin import TxOriginAnnotation

        obj = env_objects.get("ORIGIN")
        if obj is None:
            return
        if obj is env_objects.get("CALLER"):
            # the tx executor shares one sender wrapper between ORIGIN
            # and CALLER (reference parity); annotating it would taint
            # every caller-derived condition — give the ORIGIN slot its
            # own wrapper so only values read *via ORIGIN* carry taint
            obj = BitVec(obj.raw, annotations=set(obj.annotations))
            env_objects["ORIGIN"] = obj
        obj.annotate(TxOriginAnnotation())

    def on_jumpi_site(self, cond, site):
        from .modules.dependence_on_origin import TxOriginAnnotation

        if any(isinstance(a, TxOriginAnnotation)
               for a in cond.annotations):
            site.fire_module_pre_hook(self.module)


class PredictableVarsAdapter(LaneAdapter):
    _SOURCES = ("COINBASE", "GASLIMIT", "TIMESTAMP", "NUMBER")
    lifted_hooks = frozenset({"JUMPI"} | set(_SOURCES))

    def seed_env(self, env_objects, gs):
        from .modules.dependence_on_predictable_vars import (
            PredictableValueAnnotation,
        )

        for op in self._SOURCES:
            obj = env_objects.get(op)
            if obj is not None:
                obj.annotate(PredictableValueAnnotation(
                    "The block.{} environment variable".format(op.lower())
                ))

    def on_jumpi_site(self, cond, site):
        from .modules.dependence_on_predictable_vars import (
            PredictableValueAnnotation,
        )

        if any(isinstance(a, PredictableValueAnnotation)
               for a in cond.annotations):
            site.fire_module_pre_hook(self.module)


class IntegerAdapter(LaneAdapter):
    lifted_hooks = frozenset({"JUMPI", "ADD", "SUB", "MUL", "EXP",
                              "SSTORE"})
    taint_ops = frozenset({"ADD", "SUB", "MUL", "EXP", "SSTORE"})
    _ARITH = ("ADD", "SUB", "MUL", "EXP")

    def pre_resolve(self, opname, args, site):
        if opname not in self._ARITH:
            return
        from .modules.integer import (
            OverUnderflowAnnotation,
            arithmetic_overflow_constraint,
        )

        op0, op1 = args[0], args[1]
        constraint, operator = arithmetic_overflow_constraint(
            opname, op0, op1
        )
        if constraint is None or constraint.is_false:
            return
        op0.annotate(OverUnderflowAnnotation(
            site.lazy_ostate(), operator, constraint
        ))

    def on_sstore(self, value, site, key=None):
        from .modules.integer import OverUnderflowAnnotation

        return [a for a in value.annotations
                if isinstance(a, OverUnderflowAnnotation)]

    def on_jumpi(self, cond, site):
        from .modules.integer import OverUnderflowAnnotation

        return [a for a in cond.annotations
                if isinstance(a, OverUnderflowAnnotation)]

    def attach(self, gs, promotions, last_jump):
        if not promotions:
            return
        from .modules.integer import (
            _get_overflowunderflow_state_annotation,
        )

        ann = _get_overflowunderflow_state_annotation(gs)
        ann.overflowing_state_annotations.update(promotions)


class ArbitraryStorageAdapter(LaneAdapter):
    """SYMBOLIC-key SSTOREs (the actual arbitrary-write shape,
    executed on device by symbolic-storage mode) run the real module
    against the reconstructed pre-SSTORE site state; its
    PotentialIssues ride the promotion channel onto every descendant
    state (interpreter parity: each path through the SSTORE carries
    one) and discharge at transaction end as usual.

    CONCRETE-key device SSTOREs: the module's probe constraint is
    `key == 324345425435` (ref arbitrary_write.py:21-28), which for a
    concrete key is decidable by comparison — equal runs the module
    (host parity even for the adversarial contract that literally
    writes the sentinel slot), different skips the provably-UNSAT
    PotentialIssue without paying the discharge query the host pays."""

    lifted_hooks = frozenset({"SSTORE"})
    #: the stepper's probe-key sink record (symstep key_is_probe) is
    #: gated on taint_table[SSTORE] — this adapter must set that bit
    #: itself, not rely on the integer adapter being co-loaded
    taint_ops = frozenset({"SSTORE"})

    #: the module's probe slot (single source:
    #: support/eth_constants.py; the device stepper mints a sink
    #: record for a concrete write to it)
    from ...support.eth_constants import ARB_PROBE_SLOT as PROBE_SLOT

    def on_sstore(self, value, site, key=None):
        if key is not None:
            kv = getattr(key, "value", None)
            if kv is None or kv == self.PROBE_SLOT:
                from ..potential_issues import (
                    get_potential_issues_annotation,
                )

                # pre-SSTORE stack tail: [-2]=value, [-1]=write slot
                site.stack_tail = (value, key)
                state = site.build_state()
                self.module.execute(state)
                return list(
                    get_potential_issues_annotation(
                        state).potential_issues
                )
        return super().on_sstore(value, site, key)

    def attach(self, gs, promotions, last_jump):
        if not promotions:
            return
        from ..potential_issues import get_potential_issues_annotation

        get_potential_issues_annotation(gs).potential_issues.extend(
            promotions)


class StateChangeAdapter(LaneAdapter):
    """State-change-after-call only acts on states already carrying a
    StateChangeCallsAnnotation (an external CALL happened earlier in the
    tx, which always parks). Lane seeds are fresh tx entries; refuse the
    rare seed that somehow carries one."""

    lifted_hooks = frozenset({"SSTORE", "SLOAD"})

    def seed_ok(self, gs):
        from .modules.state_change_external_calls import (
            StateChangeCallsAnnotation,
        )

        return not list(gs.get_annotations(StateChangeCallsAnnotation))


class UnboundedLoopGasAdapter(LaneAdapter):
    """The unbounded-loop detector's trigger is almost entirely STATIC
    (a loop template with an unbounded, attacker-tainted hull —
    modules/unbounded_loop_gas.loop_head_hit); only the final
    satisfiability witness needs the site state. Device-executed
    JUMPIs that fork carry their condition in the path-condition log,
    so the module runs against the reconstructed site exactly like
    the other taint-style JUMPI modules; concrete-condition JUMPIs
    never fire it (a concrete condition means the instance is
    bounded), and those produce no fork record anyway."""

    lifted_hooks = frozenset({"JUMPI"})

    def on_jumpi_site(self, cond, site):
        from .modules.unbounded_loop_gas import loop_head_hit

        code_obj = site.ctx.template.environment.code
        if loop_head_hit(code_obj, site.byte_pc) is not None:
            site.fire_module_pre_hook(self.module)


class UserAssertionsAdapter(LaneAdapter):
    """The MSTORE hook only fires on concrete values matching the
    0xcafe… scribble pattern — the device parks exactly those
    (symstep taint_table MSTORE semantics); symbolic stores are ignored
    by the module."""

    lifted_hooks = frozenset({"MSTORE"})
    taint_ops = frozenset({"MSTORE"})


_ADAPTER_CLASSES = {
    "ArbitraryJump": ArbitraryJumpAdapter,
    "Exceptions": ExceptionsAdapter,
    "TxOrigin": TxOriginAdapter,
    "PredictableVariables": PredictableVarsAdapter,
    "IntegerArithmetics": IntegerAdapter,
    "ArbitraryStorage": ArbitraryStorageAdapter,
    "StateChangeAfterCall": StateChangeAdapter,
    "UnboundedLoopGas": UnboundedLoopGasAdapter,
    "UserAssertions": UserAssertionsAdapter,
}


def get_adapter(module) -> Optional[LaneAdapter]:
    """The (cached) lane adapter for a detection module, or None —
    modules without one keep park-on-hook behavior."""
    if module is None:
        return None
    cached = getattr(module, "_lane_adapter", False)
    if cached is not False:
        return cached
    cls = _ADAPTER_CLASSES.get(type(module).__name__)
    adapter = cls(module) if cls else None
    module._lane_adapter = adapter
    return adapter
