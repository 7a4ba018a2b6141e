"""Block-level storage-slot read/write summaries.

Computed by replaying the converged VSA entry stacks (cfg.py) through
each block once and recording the abstract slot operand at every
SLOAD/SSTORE, plus whether the block contains a call-family op. A slot
summary is either a small frozenset of concrete words (complete: the
value-set analysis proved every execution's operand lies in it) or
None (at least one operand widened to TOP — "could be anything").

The aggregated products consumers read:

* ``reach_reads[block-start]``: the complete concrete union of every
  SLOAD slot reachable from the block (None when any reachable read is
  incomplete) — the dependency pruner's wake-up fast path tests a
  previous transaction's concrete write slots against this set instead
  of walking the pairwise alias oracle.
* ``reach_calls[block-start]``: whether a CALL-family op is reachable.
* ``all_read_slots``: the whole-code complete read-slot union (None
  when any read anywhere is incomplete).
"""

from typing import Dict, FrozenSet, List, NamedTuple, Optional

from .cfg import CFG, TOP, transfer

#: aggregated read-set width cap: beyond this, treat as incomplete
_AGG_K = 64

_CALL_OPS = frozenset(("CALL", "CALLCODE", "DELEGATECALL", "STATICCALL",
                       "CREATE", "CREATE2"))


class BlockSummary(NamedTuple):
    #: concrete SLOAD slots in this block, or None when one widened
    reads: Optional[FrozenSet[int]]
    #: concrete SSTORE slots in this block, or None when one widened
    writes: Optional[FrozenSet[int]]
    has_call: bool
    #: concrete SSTORE VALUES in this block, or None when one widened
    #: (the fact-seeding gate, deps.py: complete write values keep
    #: storage select chains concrete)
    write_values: Optional[FrozenSet[int]] = frozenset()


def summarize_blocks(cfg: CFG) -> Dict[int, BlockSummary]:
    out: Dict[int, BlockSummary] = {}
    for bi, block in enumerate(cfg.blocks):
        stack = list(cfg.entry_stacks.get(bi, []))
        reads: Optional[set] = set()
        writes: Optional[set] = set()
        wvals: Optional[set] = set()
        has_call = False
        for ins in block.instrs:
            if ins.op in ("SLOAD", "SSTORE"):
                slot = stack[-1] if stack else TOP
                target = reads if ins.op == "SLOAD" else writes
                if slot is TOP:
                    if ins.op == "SLOAD":
                        reads = None
                    else:
                        writes = None
                elif target is not None:
                    target.update(slot)
                if ins.op == "SSTORE":
                    val = stack[-2] if len(stack) >= 2 else TOP
                    if val is TOP:
                        wvals = None
                    elif wvals is not None:
                        wvals.update(val)
            elif ins.op in _CALL_OPS:
                has_call = True
            transfer(stack, ins)
        out[block.start] = BlockSummary(
            frozenset(reads) if reads is not None else None,
            frozenset(writes) if writes is not None else None,
            has_call,
            frozenset(wvals) if wvals is not None else None)
    return out


class ReachSummaries(NamedTuple):
    reach_reads: Dict[int, Optional[FrozenSet[int]]]
    reach_calls: Dict[int, bool]
    all_read_slots: Optional[FrozenSet[int]]
    #: whole-code complete write-slot union | None (deps.py)
    all_write_slots: Optional[FrozenSet[int]] = None
    #: every SSTORE site's slot AND value proved concrete — the
    #: fact-seeding gate (deps.register_code)
    writes_complete: bool = False


def aggregate(cfg: CFG, per_block: Dict[int, BlockSummary]
              ) -> ReachSummaries:
    """Forward-reachable union per block (fixpoint; None absorbs)."""
    nb = len(cfg.blocks)
    reads: List[Optional[frozenset]] = [
        per_block[b.start].reads for b in cfg.blocks]
    calls: List[bool] = [per_block[b.start].has_call for b in cfg.blocks]
    changed = True
    while changed:
        changed = False
        for bi in range(nb - 1, -1, -1):
            r, c = reads[bi], calls[bi]
            for si in cfg.succ[bi]:
                sr = reads[si]
                if r is not None:
                    if sr is None:
                        r = None
                    elif not sr <= r:
                        r = r | sr
                        if len(r) > _AGG_K:
                            r = None
                c = c or calls[si]
            if r != reads[bi] or c != calls[bi]:
                reads[bi], calls[bi] = r, c
                changed = True
    all_reads: Optional[frozenset] = frozenset()
    for bi in range(nb):
        br = per_block[cfg.blocks[bi].start].reads
        if br is None or all_reads is None:
            all_reads = None
            break
        all_reads = all_reads | br
    all_writes: Optional[frozenset] = frozenset()
    writes_complete = True
    for bi in range(nb):
        summ = per_block[cfg.blocks[bi].start]
        if summ.writes is None or all_writes is None:
            all_writes = None
        else:
            all_writes = all_writes | summ.writes
        if summ.writes is None or summ.write_values is None:
            writes_complete = False
    return ReachSummaries(
        {cfg.blocks[bi].start: reads[bi] for bi in range(nb)},
        {cfg.blocks[bi].start: calls[bi] for bi in range(nb)},
        all_reads, all_writes, writes_complete)
