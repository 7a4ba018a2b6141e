"""Generic monotone-fixpoint dataflow engine over the static CFG.

The PR-7 pass grew three ad-hoc fixpoints (the VSA in cfg.py, the
backward reach mask in reach.py, the forward read-union in
summaries.py).  The taint/dependence layer needs two more, so the
worklist machinery lives here once: a client supplies a lattice
(``join``/``equal``/``top``), a block transfer function, and optionally
a per-edge adaptation hook, and gets back the converged block-entry
facts.

Soundness contract (shared by every client): facts only ever move UP
the client's lattice (``join`` is monotone and ``transfer`` is
monotone in its input), unresolved-jump edges carry the client's TOP
fact (``edge_fact`` receives the edge kind so it can weaken), and a
blown iteration budget returns ``converged=False`` — the caller must
then fall back to its most conservative answer rather than trust a
partial table.
"""

from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

from .cfg import CFG

#: per-block transfer budget before the fixpoint gives up (the same
#: envelope the VSA uses; structured contract CFGs converge in a few
#: passes, and a blown budget is a signal, not an error)
DEFAULT_BUDGET_PER_BLOCK = 64

#: edge kinds handed to ``edge_fact``
FALL = "fall"          # sequential / JUMPI-false successor
JUMP = "jump"          # statically resolved jump target
JUMP_TOP = "jump_top"  # unresolved jump: target set = every JUMPDEST


class Edge(NamedTuple):
    src: int   # block index
    dst: int   # block index
    kind: str  # FALL | JUMP | JUMP_TOP


def block_edges(cfg: CFG) -> List[List[Edge]]:
    """Per-block outgoing edges with kinds, derived from the jump
    table: a JUMP/JUMPI site whose value set widened to TOP contributes
    JUMP_TOP edges to every valid JUMPDEST (clients must weaken the
    fact they push along those), everything else keeps the exact exit
    fact."""
    dest_block = {pc: cfg.block_at[pc] for pc in cfg.jumpdests
                  if pc in cfg.block_at}
    out: List[List[Edge]] = []
    for bi, block in enumerate(cfg.blocks):
        last = block.last
        edges: List[Edge] = []
        if last.op in ("JUMP", "JUMPI"):
            targets = cfg.jump_table.get(last.pc)
            if targets is None:
                edges.extend(Edge(bi, di, JUMP_TOP)
                             for di in sorted(set(dest_block.values())))
            else:
                edges.extend(Edge(bi, dest_block[t], JUMP)
                             for t in targets if t in dest_block)
            if last.op == "JUMPI" and block.fallthrough in cfg.block_at:
                edges.append(
                    Edge(bi, cfg.block_at[block.fallthrough], FALL))
        elif last.op in ("STOP", "RETURN", "REVERT", "INVALID",
                         "SELFDESTRUCT"):
            pass
        elif block.fallthrough is not None \
                and block.fallthrough in cfg.block_at:
            edges.append(Edge(bi, cfg.block_at[block.fallthrough], FALL))
        out.append(edges)
    return out


class Result(NamedTuple):
    #: block index -> converged entry fact (every block present; blocks
    #: the flow never reached hold the client's unreached fact)
    entry: Dict[int, object]
    converged: bool


def forward(cfg: CFG,
            entry_fact,
            top_fact,
            transfer: Callable[[int, object], object],
            join: Callable[[object, object], object],
            equal: Callable[[object, object], bool],
            edge_fact: Optional[Callable[[Edge, object], object]] = None,
            unreached=None,
            budget_per_block: int = DEFAULT_BUDGET_PER_BLOCK) -> Result:
    """Forward worklist fixpoint.

    ``transfer(bi, entry) -> exit`` runs a whole block;
    ``edge_fact(edge, exit) -> fact`` adapts the exit fact per edge
    (default: TOP along JUMP_TOP edges, exit otherwise).  Blocks the
    flow never reaches get ``unreached`` (default ``top_fact`` — the
    conservative choice for clients that must answer for dead code
    too)."""
    n = len(cfg.blocks)
    if n == 0:
        return Result({}, True)
    if edge_fact is None:
        edge_fact = lambda e, x: top_fact if e.kind == JUMP_TOP else x  # noqa: E731,E501

    edges = block_edges(cfg)
    entry: Dict[int, object] = {0: entry_fact}
    work = [0]
    budget = budget_per_block * n
    converged = True
    while work:
        budget -= 1
        if budget < 0:
            converged = False
            break
        bi = work.pop()
        exit_f = transfer(bi, entry[bi])
        for e in edges[bi]:
            f = edge_fact(e, exit_f)
            old = entry.get(e.dst)
            new = f if old is None else join(old, f)
            if old is None or not equal(old, new):
                entry[e.dst] = new
                if e.dst not in work:
                    work.append(e.dst)
    fill = top_fact if unreached is None else unreached
    for bi in range(n):
        entry.setdefault(bi, fill)
    return Result(entry, converged)


def backward_union(cfg: CFG,
                   gen: List[object],
                   join: Callable[[object, object], object],
                   equal: Callable[[object, object], bool]) -> List[object]:
    """Backward union fixpoint: ``in[b] = gen[b] ⊔ ⊔(in[succ(b)])``
    over ``cfg.succ`` — the shape reach.py and summaries.py both use.
    Runs to convergence (unions over a finite lattice terminate)."""
    n = len(cfg.blocks)
    inm = list(gen)
    changed = True
    while changed:
        changed = False
        for bi in range(n - 1, -1, -1):
            cur = inm[bi]
            for si in cfg.succ[bi]:
                cur = join(cur, inm[si])
            if not equal(cur, inm[bi]):
                inm[bi] = cur
                changed = True
    return inm


def reachable_from(cfg: CFG, roots) -> frozenset:
    """Block indices reachable from ``roots`` over ``cfg.succ``
    (inclusive) — the per-entry-point aggregation walk deps.py runs."""
    seen = set()
    stack = [r for r in roots if 0 <= r < len(cfg.blocks)]
    seen.update(stack)
    while stack:
        bi = stack.pop()
        for si in cfg.succ[bi]:
            if si not in seen:
                seen.add(si)
                stack.append(si)
    return frozenset(seen)
