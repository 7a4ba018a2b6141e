"""Wave-based symbolic transaction entry — the lane-batch-first
redesign of the reference's one-state-at-a-time transaction setup
(reference mythril/laser/ethereum/transaction/symbolic.py:106-150).

The reference's message-call executor loops over open world states,
minting an id and five fresh symbols per state and pushing one entry
GlobalState at a time onto the worklist.  On the lane engine that shape
is hostile: the device wants ONE flood-seeded window of entry lanes,
not a trickle.  Here a whole wave is planned first — one contiguous
transaction-id block, the actor set and selector byte patterns
computed once — then instantiated in a tight loop, so laser_evm.exec()
sees the complete wave and the lane sweep's first window seeds every
entry lane in one dispatch (laser/svm.py _lane_engine_sweep).
"""

import logging
from typing import List, Optional

from ...smt import Bool, Or, symbol_factory
from ..cfg import Edge, JumpType, Node
from ..state.calldata import SymbolicCalldata
from .transaction_models import (
    BaseTransaction,
    MessageCallTransaction,
    tx_id_manager,
)

#: selector prefix length constrained by func_hashes
FUNCTION_HASH_BYTE_LENGTH = 4

log = logging.getLogger(__name__)


class Actors:
    """Named transaction senders used to constrain symbolic callers."""

    def __init__(
        self,
        creator=0xAFFEAFFEAFFEAFFEAFFEAFFEAFFEAFFEAFFEAFFE,
        attacker=0xDEADBEEFDEADBEEFDEADBEEFDEADBEEFDEADBEEF,
        someguy=0xAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAA,
    ):
        self.addresses = {
            "CREATOR": symbol_factory.BitVecVal(creator, 256),
            "ATTACKER": symbol_factory.BitVecVal(attacker, 256),
            "SOMEGUY": symbol_factory.BitVecVal(someguy, 256),
        }

    def __setitem__(self, actor: str, address: Optional[str]):
        if address is None:
            if actor in ("CREATOR", "ATTACKER"):
                raise ValueError(
                    "Can't delete creator or attacker address"
                )
            del self.addresses[actor]
            return
        if address[0:2] != "0x":
            raise ValueError("Actor address not in valid format")
        self.addresses[actor] = symbol_factory.BitVecVal(
            int(address[2:], 16), 256
        )

    def __getitem__(self, actor: str):
        return self.addresses[actor]

    @property
    def creator(self):
        return self.addresses["CREATOR"]

    @property
    def attacker(self):
        return self.addresses["ATTACKER"]

    def __len__(self):
        return len(self.addresses)


ACTORS = Actors()


class EntryWave:
    """One planned wave of symbolic transaction entries.

    Construction reserves the id block and freezes the per-wave
    artifacts (actor addresses, allowed selector byte values); spawn()
    does only the per-state work.  Ids are assigned in wave order, so
    reports are byte-identical to sequential minting."""

    def __init__(self, laser_evm, size: int, func_hashes=None):
        self.laser_evm = laser_evm
        self.base = tx_id_manager.reserve_block(size)
        self.actors = list(ACTORS.addresses.values())
        # per selector byte position: the allowed concrete values, plus
        # wave-wide fallback/receive markers (calldata-size bounds)
        self.func_hashes = func_hashes or []

    # -- per-state instantiation ------------------------------------------

    def spawn_call(self, i: int, world_state, callee_account
                   ) -> MessageCallTransaction:
        """Entry i of the wave: a symbolic message call into
        callee_account from an actor-constrained sender."""
        tid = str(self.base + i)
        sender = symbol_factory.BitVecSym(f"sender_{tid}", 256)
        calldata = SymbolicCalldata(tid)
        tx = MessageCallTransaction(
            world_state=world_state,
            identifier=tid,
            gas_price=symbol_factory.BitVecSym(f"gas_price{tid}", 256),
            gas_limit=8000000,  # block gas limit
            origin=sender,
            caller=sender,
            callee_account=callee_account,
            call_data=calldata,
            call_value=symbol_factory.BitVecSym(
                f"call_value{tid}", 256
            ),
        )
        constraints = self._selector_constraints(calldata)
        constraints += self._exclusion_constraints(world_state, calldata)
        self.enqueue(tx, constraints)
        return tx

    def _exclusion_constraints(self, world_state, calldata) -> List[Bool]:
        """Static tx-sequence pruning (docs/static_pass.md): the
        pre-round screen stashed selectors this state's next
        transaction may skip. Each exclusion keeps every other path —
        including the fallback (size < 4) — alive: the constraint is
        ``size < 4 OR some selector byte differs``."""
        excluded = getattr(world_state, "_mtpu_excluded_selectors",
                           None)
        if not excluded:
            return []
        out = []
        for sel in excluded:
            sel_bytes = int(sel).to_bytes(4, "big")
            alts = [calldata.size
                    < FUNCTION_HASH_BYTE_LENGTH]
            alts += [
                calldata[i] != symbol_factory.BitVecVal(b, 8)
                for i, b in enumerate(sel_bytes)
            ]
            out.append(Or(*alts))
        return out

    def _selector_constraints(self, calldata) -> List[Bool]:
        """Constrain the selector bytes to the wave's allowed function
        hashes (-1 = fallback, -2 = receive)."""
        out = []
        for i in range(FUNCTION_HASH_BYTE_LENGTH):
            if not self.func_hashes:
                return out
            alts = []
            for func_hash in self.func_hashes:
                if func_hash == -1:
                    alts.append(calldata.size < 4)
                elif func_hash == -2:
                    alts.append(calldata.size == 0)
                else:
                    alts.append(
                        calldata[i]
                        == symbol_factory.BitVecVal(func_hash[i], 8)
                    )
            out.append(Or(symbol_factory.Bool(False), *alts))
        return out

    # -- worklist installation --------------------------------------------

    def enqueue(self, tx: BaseTransaction, constraints=None) -> None:
        """Spawn tx's entry state, pin its caller to the actor set, and
        put it on the worklist with statespace bookkeeping."""
        laser_evm = self.laser_evm
        state = tx.initial_global_state()
        state.transaction_stack.append((tx, None))
        ws = state.world_state
        ws.constraints += constraints or []
        ws.constraints.append(
            Or(*[tx.caller == actor for actor in self.actors])
        )

        node = Node(
            state.environment.active_account.contract_name,
            function_name=state.environment.active_function_name,
        )
        if laser_evm.requires_statespace:
            laser_evm.nodes[node.uid] = node
            if tx.world_state.node:
                laser_evm.edges.append(
                    Edge(
                        tx.world_state.node.uid,
                        node.uid,
                        edge_type=JumpType.Transaction,
                        condition=None,
                    )
                )
        if tx.world_state.node:
            node.constraints = ws.constraints

        ws.transaction_sequence.append(tx)
        state.node = node
        node.states.append(state)
        laser_evm.work_list.append(state)
