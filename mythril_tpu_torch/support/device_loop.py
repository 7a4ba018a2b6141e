"""The lane engine's device half alone, on raw seed dicts: a harness
for ``chip_smoke.py``, ``tools/prof_torch_port.py`` and the tests, not
a path of the analyzer.

``DeviceLoop`` seeds lanes from raw seed dicts (``tx_entry_seed``, see
``lane_engine.pack_window``), dispatches windows through the same
``window_exec`` and escalations as ``lane_engine.LaneEngine`` and
retires parked lanes, with no host bridge. It feeds the window kernels
at widths the host bridge cannot (131072 lanes of one contract), so
their times can be taken at those widths.
"""

from collections import deque, namedtuple
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..laser import lane_engine as le
from ..ops import symstep
from ..ops.bv256 import NLIMBS
from ..ops.stepper import Status, compile_code, compile_packed_code
from ..ops.symstep import DEAD, SymLaneState
from .devices import resolve


class DeviceLoop:
    """The device loop alone: seed raw seed dicts (see
    ``lane_engine.pack_window``), dispatch windows until no lane is RUNNING, retire parked lanes (in
    the window dispatch, or through ``_retire_rows`` for the rest) and
    refill free slots, with no host bridge. Each canonical record gets
    the next object id (its row), resolved into the planes at the next
    window's remap; no kills and no SHA3 resumes are sent. It measures
    the window kernels at widths the host bridge cannot feed
    (chip_smoke.py's wide run); ``LaneEngine`` is the analyzer's
    engine."""

    def __init__(self, n_lanes: int = 256, window: Optional[int] = None,
                 step_budget: Optional[int] = None, device=None,
                 plain: bool = False, **lane_kwargs):
        """``plain`` runs the plain PyTorch versions even on the card
        (the reference the kernels are held against)."""
        self.n_lanes = n_lanes
        self.window = le.DEFAULT_WINDOW if window is None else window
        self.step_budget = (le.DEFAULT_STEP_BUDGET if step_budget is None
                            else step_budget)
        self.device = resolve(device)
        self.lane_kwargs = lane_kwargs
        self.plain = plain
        self.ops = le.PLAIN if plain else le.DISPATCH
        self.exec_table = symstep.SYM_EXECUTABLE.copy()
        self.taint_table = np.zeros(256, bool)
        self.resume_on = 0
        self.objects = le.ObjectTable()
        self._prov: Dict[Tuple[int, int], int] = {}
        self.stats = {"seeded": 0, "windows": 0, "forks": 0, "records": 0,
                      "retired": 0, "fast_retired": 0, "device_steps": 0,
                      "records_escalated": 0, "forks_escalated": 0}

    def _acquire_state(self) -> SymLaneState:
        return symstep.init_sym_lanes(self.n_lanes, device=self.device,
                                      plain=self.plain, **self.lane_kwargs)

    def _retire_floors(self, counts, lanes_sel):
        lk = self.lane_kwargs
        sel = np.asarray(lanes_sel, np.int64)
        return (
            le._geo_bucket(max(int(counts["sp"][sel].max()), 1),
                        lk.get("stack_depth", 64), 8),
            le._geo_bucket(max(int(counts["msize"][sel].max()), 1),
                        lk.get("memory_bytes", 4096), 64),
            le._geo_bucket(max(int(counts["mlog_count"][sel].max()), 1),
                        lk.get("mem_records", 64), 8),
            le._geo_bucket(max(int(counts["scount"][sel].max()), 1),
                        lk.get("storage_slots", 64), 8),
        )

    def _retire_chunks(self, st, lanes_sel, counts):
        """Escalation retire in chunks of at most RETIRE_CHUNK rows,
        each padded to a power-of-two bucket. Returns (st, [(lanes,
        floors, host rows)])."""
        cap = min(le.RETIRE_CHUNK, self.n_lanes)
        chunks = []
        for i in range(0, len(lanes_sel), le.RETIRE_CHUNK):
            part = list(lanes_sel[i:i + le.RETIRE_CHUNK])
            floors = self._retire_floors(counts, part)
            kp = le._geo_bucket(len(part), cap, min(64, cap))
            idx = np.full(kp, self.n_lanes, np.int32)
            idx[:len(part)] = part
            st, rows = self.ops["retire_rows"](
                st, torch.from_numpy(idx).to(self.device), *floors)
            chunks.append((part, floors, [x.cpu().numpy() for x in rows]))
        return st, chunks

    def explore(self, code_bytes: bytes, seeds, func_entries=()) -> dict:
        """Run seeds (raw seed dicts, see ``lane_engine.pack_window``) of one
        contract until no lane is RUNNING. Returns {"windows": [per
        window: outputs, records, forks, retired chunks], "paths": lanes
        retired, "forks": forks made, "records": unique records}."""
        n = self.n_lanes
        cc = compile_code(code_bytes, func_entries, device=self.device)
        visited = torch.zeros(cc.packed.shape[0], dtype=torch.bool,
                              device=self.device)
        st = self._acquire_state()
        d_recs = self.lane_kwargs.get("dlog_records", 64)
        calldata_cap = int(st.calldata.shape[1])
        queue = deque(seeds)
        free = list(range(n - 1, -1, -1))
        small = min(16, n)
        windows = []
        while True:
            seed_cap = n if len(queue) > small else small
            entries = []
            while queue and free and len(entries) < seed_cap:
                entries.append((free.pop(), queue.popleft()))
            i32b, u8b, k, pv = le.pack_window(
                n, symstep.N_ENV, self.lane_kwargs, entries, free, [],
                self._prov, calldata_cap, big=seed_cap > small)
            self.stats["seeded"] += len(entries)
            n_free_written = len(free)
            st, visited, out = self.ops["window_exec"](
                st, cc, torch.from_numpy(i32b).to(self.device),
                torch.from_numpy(u8b).to(self.device), self.exec_table,
                self.taint_table, self.window, k, self.step_budget, pv,
                visited, self.resume_on)
            outs = [x.cpu().numpy() for x in out]
            misc, scal, utab, ftab, ridx = outs[:5]
            self.stats["windows"] += 1
            counts = {"dlog_count": misc[:, 0], "status": misc[:, 1],
                      "steps": misc[:, 2], "sp": misc[:, 3],
                      "scount": misc[:, 4], "mlog_count": misc[:, 5],
                      "msize": misc[:, 6], "pc": misc[:, 7]}
            nf, free_count, ucount = (int(x) for x in scal)
            if ucount > utab.shape[0]:
                urb_big = utab.shape[0]
                cap = n * d_recs
                while urb_big < ucount and urb_big < cap:
                    urb_big *= 2
                urb_big = min(urb_big, cap)
                tab, uc2 = self.ops["unique_table_big"](st, urb_big)
                utab, ucount = tab.cpu().numpy(), int(uc2)
                self.stats["records_escalated"] += 1
            if nf > ftab.shape[0]:
                ftab = self.ops["gather_full_flog"](st).cpu().numpy()
                self.stats["forks_escalated"] += 1
            records, forks = utab[:ucount], ftab[:nf]
            status = counts["status"].copy()
            steps = counts["steps"]
            consumed = n_free_written - free_count
            if consumed:
                free = free[:n_free_written - consumed]
            fast = [int(x) for x in ridx if x < n]
            runaway = (status == Status.RUNNING) & (steps >= self.step_budget)
            rest = np.nonzero((status == Status.NEEDS_HOST) | runaway)[0]
            chunks = []
            if len(rest):
                st, chunks = self._retire_chunks(st, rest.tolist(), counts)
            # the host drain's device-facing duty: every canonical record
            # gets an object id, resolved into the planes at the next
            # window's remap
            self._prov = {}
            for row in records:
                self._prov[(int(row[0]), int(row[1]))] = \
                    self.objects.add(row.copy())
            for lane in fast:
                self.stats["device_steps"] += int(steps[lane])
                free.append(lane)
            for part, _, _ in chunks:
                for lane in part:
                    self.stats["device_steps"] += int(steps[lane])
                    free.append(lane)
                status[np.asarray(part, np.int64)] = DEAD
            self.stats["forks"] += nf
            self.stats["records"] += ucount
            self.stats["fast_retired"] += len(fast)
            self.stats["retired"] += len(fast) + len(rest)
            windows.append({"outs": outs, "records": records,
                            "forks": forks, "retired": chunks})
            if not int(np.sum(status == Status.RUNNING)) and not queue:
                break
        return {"windows": windows, "paths": self.stats["retired"],
                "forks": self.stats["forks"],
                "records": self.stats["records"],
                "visited": visited.cpu().numpy()[:cc.size]}


#: env slots a fresh symbolic transaction entry carries as symbols (the
#: rest are concrete): the sender and origin, the call value, and the
#: block fields the interpreter leaves symbolic
_SYMBOLIC_ENV = ("ORIGIN", "CALLER", "CALLVALUE", "COINBASE", "TIMESTAMP",
                 "NUMBER", "DIFFICULTY", "SELFBALANCE")


#: gas limit and account address of a fresh transaction entry
_TX_GAS_LIMIT = 8_000_000
_TX_ADDRESS = 0xDEADBEEF


def tx_entry_seed(objects: "le.ObjectTable", group: int,
                  calldata_cap: int):
    """A raw seed dict (see ``lane_engine.pack_window``) of a fresh transaction
    entry: pc 0, empty stack and memory, symbolic calldata of symbolic
    size, symbolic sender/value/block fields, zero-array storage. Each
    symbol gets an object id from ``objects``."""
    from ..ops.stepper import ENV_SLOTS
    from ..ops.bv256 import int_to_limbs

    env = np.zeros((symstep.N_ENV, NLIMBS), np.uint32)
    env_sid = np.zeros(symstep.N_ENV, np.int32)
    for name, slot in ENV_SLOTS.items():
        if name in _SYMBOLIC_ENV:
            env_sid[slot] = objects.add(("env", name))
    env[ENV_SLOTS["ADDRESS"]] = int_to_limbs(_TX_ADDRESS)
    env[ENV_SLOTS["GASLIMIT"]] = int_to_limbs(_TX_GAS_LIMIT)
    env[ENV_SLOTS["CHAINID"]] = int_to_limbs(1)
    return dict(
        group=group, sbase=0, calldata=np.zeros(calldata_cap, np.uint8),
        cd_size=0, cd_sym=1, cd_size_sid=objects.add(("calldatasize",)),
        env=env, env_sid=env_sid, gas_limit=_TX_GAS_LIMIT, pc=0, sp=0,
        msize=0,
        stack_v=np.zeros((le.SEED_STACK, NLIMBS), np.uint32),
        stack_s=np.zeros(le.SEED_STACK, np.int32),
        mem_v=np.zeros(le.SEED_MEM, np.uint8),
        mem_k=np.zeros(le.SEED_MEM, np.uint8),
    )


def packed_probe_seeds(objects: "le.ObjectTable", codes, bases, probes,
                       calldata_cap: int, n_seeds: int, group0: int = 1):
    """``n_seeds`` raw seeds over a packed arena of the members
    ``codes`` (each ending in ``contracts.with_probe``'s probe, entry
    offsets ``probes``) at arena ``bases``, round robin over the
    members: a transaction entry at the member's base (symbolic
    calldata: it forks at the member's own JUMPIs), then probe lanes
    that read PC and CODESIZE and JUMP to each destination kind (an
    in-member JUMPDEST; the member's size; the next member's JUMPDEST,
    out of the member; a non-JUMPDEST; a word over 32 bits; a symbolic
    word), and JUMPI lanes on a symbolic condition (a fork), a true
    and a false one."""
    from ..ops.bv256 import int_to_limbs

    kinds = [("entry", None)] + [
        ("jump", d) for d in ("local", "size", "cross", "plain", "huge",
                              "symbolic")] + [
        ("jumpi", c) for c in ("symbolic", "true", "false")]
    seeds = []
    m_count = len(codes)
    for i in range(n_seeds):
        m = i % m_count
        kind, arg = kinds[(i // m_count) % len(kinds)]
        s = tx_entry_seed(objects, group0 + i, calldata_cap)
        s["pc"] = bases[m]
        seeds.append(s)
        if kind == "entry":
            continue
        nxt = (m + 1) % m_count
        dests = {
            "local": probes[m]["jumpi"],
            "size": len(codes[m]),
            "cross": (bases[nxt] - bases[m] + probes[nxt]["jumpi"])
            % (1 << 256),
            "plain": probes[m]["jump"] + 1,
            "huge": 1 << 40,
            "symbolic": 0,
        }
        stack = []  # (value, sid) from the bottom
        if kind == "jump":
            s["pc"] = bases[m] + probes[m]["jump"]
            sid = objects.add(("dest", i)) if arg == "symbolic" else 0
            stack.append((dests[arg], sid))
        else:
            s["pc"] = bases[m] + probes[m]["jumpi"]
            sym = arg == "symbolic"
            stack.append((int(arg == "true"),
                          objects.add(("cond", i)) if sym else 0))
            stack.append((dests["local"] if sym or arg == "false"
                          else dests["cross"], 0))
        for j, (v, sid) in enumerate(stack):
            s["stack_v"][j] = int_to_limbs(v)
            s["stack_s"][j] = sid
        s["sp"] = len(stack)
    return seeds


#: the inputs K1 is held to on both sides (``k1_edge_cases``)
K1Case = namedtuple("K1Case", "name code members seeds lanes steps")


def k1_edge_cases(calldata_cap: int, scale: int = 1):
    """The edge inputs of K1: on the card ``chip_smoke.py`` holds K1 to
    its plain version on them, on the CPU ``tests/test_torch_symstep.py``
    holds the plain version to the JAX ``sym_run``. Each is a
    ``K1Case``: one contract's bytes (``code``) or a packed arena's
    members (``members``, for ``compile_packed_code``), raw seeds, the
    lane count and the steps to run. ``scale`` multiplies the lane
    counts that are not fixed by what the case is about (1 on the CPU).

    - ``odd_lanes``: 64 * scale + 37 lanes, no multiple of any block;
    - ``fork_budget``: MAX_FORKS_PER_STEP + 452 lanes reach a symbolic
      JUMPI in the same step, spread over many blocks, with 2100 free
      slots: 2048 fork, 52 stall and fork the next step, the rest park;
    - ``mid_window_stop``: every lane stops on its own, the last at a
      step that is no multiple of ``symstep.SYNC_EVERY``;
    - ``corpus_width``: 64 lanes (the corpus' ``--tpu-lanes``);
    - ``packed``: a packed arena of three probe members, 64 * scale
      lanes, five eighths of them seeded."""
    from . import contracts
    from ..ops.symstep import MAX_FORKS_PER_STEP

    def mixed(objs, n_seeds, seed):
        """coverage-contract entries: odd ones symbolic, even ones
        concrete calldata picking each arm in turn"""
        rng = np.random.default_rng(seed)
        out = []
        for i in range(n_seeds):
            s = tx_entry_seed(objs, i + 1, calldata_cap)
            if i % 2 == 0:
                s["cd_sym"], s["cd_size_sid"], s["cd_size"] = 0, 0, 64
                s["calldata"][31] = (i // 2) % 10
                s["calldata"][32:64] = rng.integers(0, 256, 32, np.uint8)
            out.append(s)
        return out

    cover = contracts.build_coverage_contract()
    objs = le.ObjectTable()
    odd = 64 * scale + 37
    cases = [K1Case("odd_lanes", cover, None, mixed(objs, odd // 8, 1), odd,
                    64)]
    objs = le.ObjectTable()
    storm = MAX_FORKS_PER_STEP + 452
    cases.append(K1Case(
        "fork_budget", contracts.build_symbolic_contract(4)[0], None,
        [tx_entry_seed(objs, g + 1, calldata_cap) for g in range(storm)],
        storm + 2100, 12))
    objs = le.ObjectTable()
    seeds = []
    for i in range(12):
        s = tx_entry_seed(objs, i + 1, calldata_cap)
        s["cd_sym"], s["cd_size_sid"], s["cd_size"] = 0, 0, 64
        s["calldata"][31] = _STOP_ARMS[i % len(_STOP_ARMS)]
        s["calldata"][63] = i
        seeds.append(s)
    cases.append(K1Case("mid_window_stop", cover, None, seeds, 64, 256))
    objs = le.ObjectTable()
    cases.append(K1Case("corpus_width", cover, None, mixed(objs, 8, 2), 64,
                        64))
    codes, probes = zip(*(contracts.with_probe(c) for c in (
        contracts.build_symbolic_contract(4)[0],
        contracts.build_diamond_contract(k=3),
        cover)))
    members = [(c, (p["jumpi"], 0)) for c, p in zip(codes, probes)]
    lanes = 64 * scale
    _, bases = compile_packed_code(members, device="cpu")
    cases.append(K1Case(
        "packed", None, members,
        packed_probe_seeds(le.ObjectTable(), codes, bases, probes,
                           calldata_cap, lanes * 5 // 8),
        lanes, 48))
    return cases


#: the coverage contract's arms that stop (arm 7 loops) for
#: ``mid_window_stop``: arm 5 runs longest, to step 90
_STOP_ARMS = (0, 1, 2, 3, 4, 5, 6, 8, 9)


def k1_case_state(case: K1Case, device, **lane_kwargs):
    """A case's batch after the window prologue, and its code:
    (SymLaneState, CompiledCode) on ``device``."""
    dev = resolve(device)
    st = symstep.init_sym_lanes(case.lanes, device=dev, **lane_kwargs)
    free = list(range(case.lanes - 1, -1, -1))
    entries = [(free.pop(), s) for s in case.seeds]
    i32b, u8b, k, pv = le.pack_window(
        case.lanes, symstep.N_ENV, lane_kwargs, entries, free, [], {},
        int(st.calldata.shape[1]), big=len(entries) > 16)
    st = le.prologue_plain(st, torch.from_numpy(i32b).to(dev),
                           torch.from_numpy(u8b).to(dev), k, pv)
    if case.members is not None:
        cc, _ = compile_packed_code(case.members, device=dev)
    else:
        cc = compile_code(case.code, device=dev)
    return st, cc
