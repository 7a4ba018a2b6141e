"""Dominator / back-edge loop-head detection, plus the SCC-based
cycle-candidate set the bounded-loops strategy consumes.

Two distinct products, because they serve two different soundness
contracts:

* ``loop_heads``: classic dominator back-edges (u -> v with v dom u).
  Precise on reducible graphs — reporting / heuristics only.
* ``cycle_pcs``: every JUMPDEST inside a NON-TRIVIAL strongly
  connected component. Any cycle a concrete execution can drive lies
  within one SCC of the conservative CFG (the CFG over-approximates
  real edges), so a JUMPDEST outside ``cycle_pcs`` can never be part
  of a repeating trace cycle *of this code* — the bounded-loops
  strategy may skip its trailing-cycle scan there. Irreducible loops,
  which dominator back-edges miss, are still covered.
"""

from typing import FrozenSet, List, Tuple

from .cfg import CFG


def _entry_reachable(cfg: CFG) -> List[int]:
    seen = {0} if cfg.blocks else set()
    stack = [0] if cfg.blocks else []
    while stack:
        bi = stack.pop()
        for si in cfg.succ[bi]:
            if si not in seen:
                seen.add(si)
                stack.append(si)
    return sorted(seen)


def dominators(cfg: CFG) -> Tuple[dict, dict]:
    """Iterative dominator bitsets over the entry-reachable subgraph
    (the corpus codes are a few hundred blocks); returns
    (block-index -> bitset, block-index -> bit position)."""
    reach = _entry_reachable(cfg)
    if not reach:
        return {}, {}
    idx = {bi: i for i, bi in enumerate(reach)}
    preds: List[List[int]] = [[] for _ in reach]
    for bi in reach:
        for si in cfg.succ[bi]:
            if si in idx:
                preds[idx[si]].append(idx[bi])
    n = len(reach)
    full = (1 << n) - 1
    dom = [full] * n
    dom[0] = 1
    changed = True
    while changed:
        changed = False
        for i in range(1, n):
            d = full
            for p in preds[i]:
                d &= dom[p]
            d |= 1 << i
            if d != dom[i]:
                dom[i] = d
                changed = True
    return {bi: dom[idx[bi]] for bi in reach}, idx


def loop_heads(cfg: CFG) -> FrozenSet[int]:
    """Byte addresses of dominator-back-edge targets."""
    if not cfg.blocks:
        return frozenset()
    dom, idx = dominators(cfg)
    heads = set()
    for bi, d in dom.items():
        for si in cfg.succ[bi]:
            if si in idx and (d >> idx[si]) & 1:
                heads.add(cfg.blocks[si].start)
    return frozenset(heads)


def cycle_pcs(cfg: CFG) -> FrozenSet[int]:
    """JUMPDEST byte addresses inside non-trivial SCCs (incl. self
    loops). Iterative Tarjan — recursion would blow on deep CFGs."""
    n = len(cfg.blocks)
    index = [0] * n
    low = [0] * n
    on_stack = [False] * n
    visited = [False] * n
    comp = [-1] * n
    stack: List[int] = []
    counter = [1]
    comp_members: List[List[int]] = []

    for root in range(n):
        if visited[root]:
            continue
        work: List[Tuple[int, int]] = [(root, 0)]
        while work:
            v, pi = work.pop()
            if pi == 0:
                visited[v] = True
                index[v] = low[v] = counter[0]
                counter[0] += 1
                stack.append(v)
                on_stack[v] = True
            recurse = False
            for j in range(pi, len(cfg.succ[v])):
                w = cfg.succ[v][j]
                if not visited[w]:
                    work.append((v, j + 1))
                    work.append((w, 0))
                    recurse = True
                    break
                if on_stack[w]:
                    low[v] = min(low[v], index[w])
            if recurse:
                continue
            if low[v] == index[v]:
                members = []
                while True:
                    w = stack.pop()
                    on_stack[w] = False
                    comp[w] = len(comp_members)
                    members.append(w)
                    if w == v:
                        break
                comp_members.append(members)
            if work:
                parent = work[-1][0]
                low[parent] = min(low[parent], low[v])

    out = set()
    for members in comp_members:
        nontrivial = len(members) > 1 or any(
            bi in cfg.succ[bi] for bi in members)
        if not nontrivial:
            continue
        for bi in members:
            for ins in cfg.blocks[bi].instrs:
                if ins.op == "JUMPDEST":
                    out.add(ins.pc)
    return frozenset(out)
