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
            chunks.append((part, floors, le._start_pull(rows)()))
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
            outs = le._start_pull(out)()
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


#: the inputs K3 is held to on both sides (``k3_edge_cases``): a batch's
#: lanes and deferred-record slots, the planes written over a fresh
#: batch (numpy, the JAX dtypes), and the unique-table rows to pull
K3Case = namedtuple("K3Case", "name lanes records planes urb")

#: plane widths of the K3 cases' batches (besides their records)
K3_WIDTHS = dict(stack_depth=16, memory_bytes=64, mem_records=8,
                 storage_slots=8, calldata_bytes=64)

_HASH_MUL = 0x9E3779B1
_M32 = 0xFFFFFFFF


def record_hash(group, op, pc, fentry, sids, vals) -> int:
    """K3's record hash (``lane_engine._dedup_canon``) of one record in
    Python ints: h = h * 0x9E3779B1 + x mod 2**32 over group, op, pc,
    fentry, the three canonical sids and the 24 value limbs."""
    h = 0
    for x in (group, op, pc, fentry, *sids, *vals):
        h = (h * _HASH_MUL + (int(x) & _M32)) & _M32
    return h


class _Batch:
    """Planes of an n-lane, R-record batch whose lanes hold no record:
    junk in every record slot and fork-log row, and sid planes that mix
    object ids, provisional sids of every (lane, slot), unresolved sids
    (int32 min) and provisional sids past the last lane (JAX clamps
    their row)."""

    def __init__(self, n, r, rng):
        self.n, self.r, self.rng = n, r, rng
        i32 = np.iinfo(np.int32)
        junk = rng.integers(i32.min, i32.max, (n, r), dtype=np.int32)
        self.p = {
            "group": rng.integers(0, 4, n).astype(np.int32),
            "dlog_count": np.zeros(n, np.int32),
            "dlog_op": junk.copy(), "dlog_pc": junk ^ 1,
            "dlog_step": junk ^ 2, "dlog_fentry": junk ^ 3,
            "dlog_sid": rng.integers(i32.min, i32.max, (n, r, 3),
                                     dtype=np.int32),
            "dlog_val": rng.integers(0, 1 << 32, (n, r, 3, NLIMBS),
                                     dtype=np.uint64).astype(np.uint32)}
        shapes = symstep._plane_shapes(
            n, K3_WIDTHS["stack_depth"], K3_WIDTHS["memory_bytes"],
            K3_WIDTHS["mem_records"], K3_WIDTHS["storage_slots"],
            K3_WIDTHS["calldata_bytes"], r)
        for f in ("ssid", "sval_sid", "skey_sid", "mlog_sid", "flog_sid"):
            self.p[f] = self.sids(shapes[f])
        for f in ("flog_parent", "flog_child", "flog_step", "flog_pc",
                  "flog_fentry", "flog_dest"):
            self.p[f] = rng.integers(-5, n + 5, n).astype(np.int32)
        for f in ("flog_gmin", "flog_gmax"):
            self.p[f] = rng.integers(0, 1 << 32, n,
                                     dtype=np.uint64).astype(np.uint32)
        self.p["flog_count"] = np.array(n, np.int32)

    def sids(self, shape):
        rng, nr = self.rng, self.n * self.r
        kind = rng.integers(0, 8, shape)
        prov = -rng.integers(1, nr + 1, shape)
        past = -rng.integers(nr + 1, nr + 4 * self.r, shape)
        obj = rng.integers(0, 1000, shape)
        out = np.where(kind < 4, prov, np.where(kind < 6, obj, np.where(
            kind == 6, past, np.iinfo(np.int32).min)))
        return out.astype(np.int32)

    def pid(self, lane, slot):
        """The provisional sid of record (lane, slot)."""
        return -(lane * self.r + slot + 1)

    def record(self, step, op=0x01, pc=7, fentry=-1, sids=(0, 0, 0),
               vals=None):
        if vals is None:
            vals = self.rng.integers(0, 1 << 32, 3 * NLIMBS,
                                     dtype=np.uint64)
        return (step, op, pc, fentry, tuple(sids),
                np.asarray(vals, np.uint64).astype(np.uint32))

    def put(self, lane, recs, count=None):
        """Write lane's records (slot order) and its record count."""
        p = self.p
        for slot, (step, op, pc, fen, sids, vals) in enumerate(recs):
            p["dlog_step"][lane, slot] = step
            p["dlog_op"][lane, slot] = op
            p["dlog_pc"][lane, slot] = pc
            p["dlog_fentry"][lane, slot] = fen
            p["dlog_sid"][lane, slot] = sids
            p["dlog_val"][lane, slot] = vals.reshape(3, NLIMBS)
        p["dlog_count"][lane] = len(recs) if count is None else count


def k3_edge_cases():
    """The edge inputs of K3 (``window_dedup``) and of the escalation
    tables it feeds (``_unique_table_big``, ``_gather_full_flog``): on
    the card ``chip_smoke.py`` holds K3 to ``dedup_plain`` on them (in
    one block and on a cooperative grid), on the CPU
    ``tests/test_torch_dedup.py`` holds the plain versions to the JAX
    functions. Each is a ``K3Case``; ``k3_case_state`` makes its batch.

    - ``rules`` (33 lanes, 16 records, steps from 1003 with gaps):
      two distinct records in one bucket (lanes 2 and 7; lane 9 equal
      to lane 7 meets lane 2, the bucket's winner, and keeps its own
      identity); equal records in lanes 5 and 3 (lane 3 wins); equal
      SSTORE and ``REC_SLOAD_RW`` records that keep their own; a chain
      of three rounds whose sids name the round before's duplicates;
      a lane whose records repeat a step (the first counts) and one
      whose records are out of step order; lanes with no records;
    - ``full_log``: 64 lanes of 64 records, lanes 0-15 lockstep
      siblings, lane 3's count past its 64 slots;
    - ``none``: 33 lanes, no records (junk in every slot);
    - ``one_lane``: one lane whose sids name itself and rows past it;
    - ``wide``: 4096 lanes of up to 24 records each, a quarter copying
      a lower lane's, sids naming earlier records; more unique records
      than ``URB`` and more fork rows than ``FB``."""
    from ..ops.symstep import REC_SLOAD_RW

    sstore = le._SSTORE_BYTE
    cases = []

    # rules
    rng = np.random.default_rng(301)
    b = _Batch(33, 16, rng)
    base = 1003
    b.p["group"][[2, 7, 9]] = 1
    a = b.record(base, op=0x16, pc=40)
    vals = a[5].copy()
    vals[-1] = (int(vals[-1]) + 4096) & _M32
    b.put(2, [b.record(base, op=0x16, pc=40, vals=vals)])
    b.put(7, [a])
    b.put(9, [a])
    assert record_hash(1, 0x16, 40, -1, (0, 0, 0), vals) % 4096 \
        == record_hash(1, 0x16, 40, -1, (0, 0, 0), a[5]) % 4096
    eq = b.record(base + 4, op=0x01, pc=12, sids=(0, 77, 0))
    b.put(3, [b.record(base, op=0x02, pc=3), eq])
    b.put(5, [eq])
    b.p["group"][[3, 5]] = 2
    st_rec = b.record(base, op=sstore, pc=50)
    rw_rec = b.record(base + 4, op=REC_SLOAD_RW, pc=51)
    for lane in (10, 11):
        b.put(lane, [st_rec, rw_rec])
    b.p["group"][[10, 11]] = 3
    # the chain: lanes 20/21 equal at the first step, 22/23 at the
    # second naming 21's and 20's record, 24/25 at the third naming 23's
    # and 22's
    x = b.record(base, op=0x20, pc=60)
    b.put(20, [x])
    b.put(21, [x])
    v2, v3 = b.record(0)[5], b.record(0)[5]
    b.put(22, [b.record(base + 4, pc=61, sids=(b.pid(21, 0), 5, 0),
                        vals=v2)])
    b.put(23, [b.record(base + 4, pc=61, sids=(b.pid(20, 0), 5, 0),
                        vals=v2)])
    b.put(24, [b.record(base + 9, pc=62, sids=(0, b.pid(23, 0), 0),
                        vals=v3)])
    b.put(25, [b.record(base + 9, pc=62, sids=(0, b.pid(22, 0), 0),
                        vals=v3)])
    b.p["group"][20:26] = 0
    # a repeated step, records out of step order
    b.put(30, [b.record(base), b.record(base), b.record(base + 7)])
    b.put(31, [b.record(base + 9), b.record(base + 4),
               b.record(base + 4), b.record(base + 12)])
    cases.append(K3Case("rules", 33, 16, b.p, 64))

    # full_log
    rng = np.random.default_rng(302)
    b = _Batch(64, 64, rng)
    sib = [b.record(2 * s + 1, op=int(rng.integers(1, 0x20)),
                    pc=int(rng.integers(0, 300)),
                    sids=(b.pid(0, s - 1) if s else 0, 0, 0))
           for s in range(64)]
    b.p["group"][:16] = 7
    for lane in range(16):
        recs = [(st, op, pc, fen, (b.pid(lane, s - 1) if s else 0, 0, 0),
                 v) for s, (st, op, pc, fen, _, v) in enumerate(sib)]
        b.put(lane, recs, count=70 if lane == 3 else None)
    for lane in range(16, 64):
        k = int(rng.integers(0, 40))
        steps = np.sort(rng.choice(200, k, replace=False)) + 1
        b.put(lane, [b.record(int(s), sids=(
            b.pid(lane - 1, 0) if j % 3 == 0 else 0, 0, 0))
            for j, s in enumerate(steps)])
    cases.append(K3Case("full_log", 64, 64, b.p, 256))

    cases.append(K3Case("none", 33, 16, _Batch(33, 16, np.random
                                                .default_rng(303)).p, 16))

    rng = np.random.default_rng(304)
    b = _Batch(1, 16, rng)
    b.put(0, [b.record(4), b.record(5, sids=(b.pid(0, 0), -40, 0)),
              b.record(9, sids=(b.pid(0, 1), b.pid(0, 0), -9999))])
    cases.append(K3Case("one_lane", 1, 16, b.p, 8))

    rng = np.random.default_rng(305)
    n = 4096
    b = _Batch(n, 64, rng)
    b.p["group"] = rng.integers(0, 64, n).astype(np.int32)
    for lane in range(n):
        if lane >= 4 and rng.random() < 0.25:
            src = int(rng.integers(0, lane))
            b.p["group"][lane] = b.p["group"][src]
            k = int(b.p["dlog_count"][src])
            for f in ("dlog_step", "dlog_op", "dlog_pc", "dlog_fentry",
                      "dlog_sid", "dlog_val"):
                b.p[f][lane, :k] = b.p[f][src, :k]
            b.p["dlog_count"][lane] = k
            continue
        k = int(rng.integers(0, 25))
        steps = np.sort(rng.choice(168, k, replace=False)) + 5
        recs = []
        for j, s in enumerate(steps):
            ref = 0
            if j and rng.random() < 0.5:
                ref = b.pid(lane, int(rng.integers(0, j)))
            elif lane and rng.random() < 0.3:
                ref = b.pid(int(rng.integers(0, lane)), int(rng.integers(
                    0, 24)))
            op = sstore if rng.random() < 0.05 else int(rng.integers(1, 4))
            recs.append(b.record(int(s), op=op, pc=int(rng.integers(0, 8)),
                                 sids=(ref, 0, 0),
                                 vals=rng.integers(0, 3, 3 * NLIMBS)))
        b.put(lane, recs)
    cases.append(K3Case("wide", n, 64, b.p, 2048))
    return cases


def k3_case_state(case: K3Case, device) -> SymLaneState:
    """A case's batch on ``device``: a fresh batch of ``K3_WIDTHS`` with
    the case's planes written over it."""
    from .. import interop

    st = symstep.init_sym_lanes(case.lanes, device="cpu",
                                dlog_records=case.records, **K3_WIDTHS)
    planes = interop.state_to_numpy(st)
    planes.update(case.planes)
    return interop.state_from_numpy(planes, resolve(device))


#: the inputs K2 (``window_prologue``) is held to on both sides
#: (``k2_edge_cases``): a batch's lanes and plane widths, its planes
#: (numpy, the JAX dtypes), and the window's packed buffers
K2Case = namedtuple("K2Case", "name lanes widths planes i32buf u8buf k pv")
#: the inputs K4 (``window_epilogue``) is held to (``k4_edge_cases``):
#: the planes, the canon (n, R), the code's bytes, the step budget and
#: the resume flag
K4Case = namedtuple("K4Case",
                    "name lanes widths planes canon code budget resume_on")

#: plane widths of the K2 and K4 cases: equal to the seed caps
#: (``lane_engine.SEED_STACK``, ``SEED_MEM``, ``SEED_CD``: a seed's
#: prefix is its whole row), wider (rows of bytes that are no multiple of
#: 4) and narrower
WINDOW_WIDTHS = {
    "caps": dict(stack_depth=16, memory_bytes=256, mem_records=8,
                 storage_slots=8, calldata_bytes=160, dlog_records=16),
    "wide": dict(stack_depth=24, memory_bytes=302, mem_records=10,
                 storage_slots=9, calldata_bytes=170, dlog_records=8),
    "narrow": dict(stack_depth=8, memory_bytes=64, mem_records=4,
                   storage_slots=4, calldata_bytes=64, dlog_records=64),
}

_SID_PLANES = ("ssid", "sval_sid", "skey_sid", "mlog_sid", "flog_sid",
               "dlog_sid", "env_sid", "cd_size_sid")


def window_planes(n: int, widths: dict, rng) -> dict:
    """Every plane of an n-lane batch of ``widths`` filled at random
    (numpy, the JAX dtypes): sid planes mix object ids, provisional sids
    of every (lane, record), provisional sids past the last lane and
    unresolved ones (int32 min); statuses, counts and positions range
    past their planes on both sides."""
    i32 = np.iinfo(np.int32)
    r = widths["dlog_records"]
    shapes = symstep._plane_shapes(
        n, widths["stack_depth"], widths["memory_bytes"],
        widths["mem_records"], widths["storage_slots"],
        widths["calldata_bytes"], r)
    nr = n * r
    out = {}
    for f, shape in shapes.items():
        if f in symstep.U8_FIELDS:
            out[f] = rng.integers(0, 256, shape, dtype=np.uint8)
        elif f in symstep.U32_FIELDS:
            out[f] = rng.integers(0, 1 << 32, shape,
                                  dtype=np.uint64).astype(np.uint32)
        elif f in _SID_PLANES:
            kind = rng.integers(0, 8, shape)
            out[f] = np.where(
                kind < 4, -rng.integers(1, nr + 1, shape),
                np.where(kind < 6, rng.integers(0, 1000, shape),
                         np.where(kind == 6, -rng.integers(
                             nr + 1, nr + 4 * r + 2, shape),
                             i32.min))).astype(np.int32)
        else:
            out[f] = rng.integers(-3, 600, shape).astype(np.int32)
    out["status"] = rng.choice(np.array([0, 0, 1, 2, 3, 4, 5, 5, 5, 6, 7],
                                        np.int32), n)
    out["dlog_count"] = rng.integers(-1, r + 3, n).astype(np.int32)
    out["flog_count"] = np.array(rng.integers(0, n + 1), np.int32)
    out["free_count"] = np.array(rng.integers(0, n + 1), np.int32)
    return out


def _k2_buffers(n, widths, rng, k, pv, prov, kill, resumes, seeds):
    """A window's packed buffers (``lane_engine._seed_sections``) with
    random contents, then the given index entries: ``prov`` [(slot,
    oid)], ``kill`` [lane], ``resumes`` / ``seeds`` [lane]; unlisted
    entries are padding (n, or slot n * R)."""
    r = widths["dlog_records"]
    sd = min(le.SEED_STACK, widths["stack_depth"])
    mc = min(le.SEED_MEM, widths["memory_bytes"])
    ccw = min(le.SEED_CD, widths["calldata_bytes"])
    n_env = symstep.N_ENV
    sections = le._seed_sections(n, k, n_env, sd, pv)
    offs, total = le._section_offsets(sections)
    buf = rng.integers(-(1 << 31), 1 << 31, total,
                       dtype=np.int64).astype(np.int32)

    def put(name, values):
        values = np.asarray(values, np.int64).astype(np.int32).reshape(-1)
        buf[offs[name]:offs[name] + values.size] = values

    def index(values, size, pad):
        out = np.full(size, pad, np.int64)
        out[:len(values)] = values
        return out

    put("idx", index(seeds, k, n))
    put("r_idx", index(resumes, k, n))
    put("kill", index(kill, n, n))
    pairs = np.full((pv, 2), n * r, np.int64)
    pairs[:, 1] = rng.integers(1, 1 << 20, pv)
    for j, (slot, oid) in enumerate(prov):
        pairs[j] = (slot, oid)
    put("prov", pairs)
    put("fcount", [rng.integers(0, n + 1)])
    put("fs", rng.integers(0, n, n))
    i32p = rng.integers(-5, 400, (k, 8 + n_env))
    i32p[:, 5] = rng.integers(0, sd + 1, k)  # sp: empty to a full prefix
    put("i32p", i32p)
    r_i32 = rng.integers(-3, 300, (k, 6))
    r_i32[:, 1] = rng.integers(-1, widths["stack_depth"] + 3, k)
    put("r_i32", r_i32)
    u8 = rng.integers(0, 256, k * (ccw + 2 * mc), dtype=np.uint8)
    if k:  # seed 0's calldata, memory and kinds: zeros
        u8[:ccw] = 0
        u8[k * ccw:k * ccw + mc] = 0
        u8[k * (ccw + mc):k * (ccw + mc) + mc] = 0
    return buf, u8


def k2_edge_cases():
    """The edge inputs of K2 (``window_prologue``): on the card
    ``chip_smoke.py`` holds K2 to ``prologue_plain`` on them, in one
    block and on a cooperative grid; on the CPU
    ``tests/test_torch_window_edges.py`` holds ``prologue_plain`` to the
    JAX package's remap, kill, resume and seed scatters
    (``_remap_reset_core``, ``_prologue_core``), bit for bit. Every case
    has provisional sids of every kind in its sid planes.

    - ``indices`` (33 lanes, seed-cap widths): provisional pairs with a
      negative slot, one of -n*R (slot 0), one below it and one past
      n*R (dropped), a slot named twice (the last pair wins) and
      padding; kills, resumes and seeds at -1, -n, -n-1, n+3 and
      padding; a lane killed and resumed (RUNNING), one killed and
      seeded, one resumed and seeded (the seed wins), a lane seeded
      twice and one resumed twice (the last entry wins); resumes with sp
      0 and past the stack;
    - ``lanes_1``, ``lanes_8``, ``lanes_64``: random entries at 1, 8 and
      64 lanes;
    - ``wide_rows``, ``narrow_rows``: seeds into rows wider than the
      seed caps (bytes no multiple of 4) and narrower;
    - ``empty``: k = 0 and pv = 0 (every provisional sid unresolved);
    - ``dense``: more pairs than K2's shared table holds
      (``lane_engine._K2_PROV_LOCAL``): pv = n * R, the escalated
      form."""
    cases = []

    def case(name, n, wname, k, pv, seed, prov=None, kill=None,
             resumes=None, seeds=None):
        rng = np.random.default_rng(seed)
        widths = WINDOW_WIDTHS[wname]
        r = widths["dlog_records"]
        planes = window_planes(n, widths, rng)
        if prov is None:
            m = int(rng.integers(0, pv + 1))
            slots = rng.choice(n * r, min(m, n * r), replace=False)
            prov = [(int(sl), int(rng.integers(1, 1 << 20))) for sl in slots]
        if kill is None:
            kill = rng.choice(n, int(rng.integers(0, n + 1)), replace=False)
        if resumes is None:
            resumes = rng.choice(n, int(rng.integers(0, min(k, n) + 1)),
                                 replace=False)
        if seeds is None:
            seeds = rng.choice(n, int(rng.integers(0, min(k, n) + 1)),
                               replace=False)
        i32, u8 = _k2_buffers(n, widths, rng, k, pv, prov, list(kill),
                              list(resumes), list(seeds))
        cases.append(K2Case(name, n, widths, planes, i32, u8, k, pv))

    n, r = 33, WINDOW_WIDTHS["caps"]["dlog_records"]
    nr = n * r
    case("indices", n, "caps", 16, 32, 401,
         prov=[(-1, 11), (-nr, 12), (-nr - 1, 13), (nr + 2, 14), (5, 15),
               (40, 16), (5, 17), (nr - 1, 18), (3 * r + 2, 19)],
         kill=[-1, -n, -n - 1, n + 3, 4, 6, 7, 4],
         resumes=[4, -2, 9, 9, -n - 1, n, 10, 12],
         seeds=[6, 10, -3, 12, 12, n + 3, -n, 20])
    case("lanes_1", 1, "caps", 1, 32, 402)
    case("lanes_8", 8, "caps", 8, 16, 403)
    case("lanes_64", 64, "caps", 16, 128, 404)
    case("wide_rows", 40, "wide", 40, 64, 405)
    case("narrow_rows", 40, "narrow", 16, 64, 406)
    case("empty", 33, "caps", 0, 0, 407)
    n, r = 128, WINDOW_WIDTHS["narrow"]["dlog_records"]
    case("dense", n, "narrow", 16, n * r, 408, prov=None)
    return cases


def k2_case_state(case: K2Case, device):
    """A K2 case's (state, i32buf, u8buf, k, pv) on ``device``."""
    from .. import interop

    dev = resolve(device)
    return (interop.state_from_numpy(case.planes, dev),
            torch.from_numpy(case.i32buf).to(dev),
            torch.from_numpy(case.u8buf).to(dev), case.k, case.pv)


#: K4 cases' code: PUSH1 1, SHA3, SHA3, STOP, SHA3 (SHA3 at pcs 2, 3, 5)
K4_CODE = bytes([0x60, 0x01, 0x20, 0x20, 0x00, 0x20])


def k4_edge_cases():
    """The edge inputs of K4 (``window_epilogue``): on the card
    ``chip_smoke.py`` holds K4 to ``epilogue_plain`` on them, in one
    block and on a cooperative grid; on the CPU
    ``tests/test_torch_window_edges.py`` holds ``epilogue_plain`` to the
    JAX package's selection and its cores (``_resume_gather_core``,
    ``_retire_gather_core``, ``_counts_core``, ``_unique_table``,
    ``_fork_table``), bit for bit.

    - ``caps_over`` (200 lanes, resume on): 80 lanes in the hold
      envelope (more than ``HOLD_CAP``) and 40 more parked lanes that fit
      the retire floors (more than ``RCAP``): held lanes are not retired,
      the holds past the cap are; pcs past the code and below it;
    - ``resume_off``: the same planes with resume off (no hold);
    - ``lanes_1``, ``lanes_8``, ``lanes_33``, ``lanes_64``: random
      planes and canon;
    - ``urb_over``: 64 lanes of 16 records, every record its own
      canon: 1024 unique records, more than ``URB``;
    - ``fb_over``: 600 lanes, 600 fork rows: more than ``FB``."""
    cases = []
    code_rows = len(K4_CODE) + 1

    def case(name, n, wname, seed, resume_on=1, budget=64, envelope=0,
             parked=0, canon_all=False):
        rng = np.random.default_rng(seed)
        widths = WINDOW_WIDTHS[wname]
        r = widths["dlog_records"]
        p = window_planes(n, widths, rng)
        # the counts the selection reads, mostly inside the envelope
        p["sp"] = rng.integers(-1, 30, n).astype(np.int32)
        p["msize"] = rng.integers(0, 700, n).astype(np.int32)
        p["mlog_count"] = rng.integers(0, 11, n).astype(np.int32)
        p["scount"] = rng.integers(0, 11, n).astype(np.int32)
        p["steps"] = rng.integers(0, 2 * budget, n).astype(np.int32)
        p["pc"] = rng.integers(-2, code_rows + 3, n).astype(np.int32)
        lanes = rng.permutation(n)
        hold, fit = lanes[:envelope], lanes[envelope:envelope + parked]
        p["status"][hold] = Status.NEEDS_HOST
        p["pc"][hold] = rng.choice([2, 3, 5], len(hold))
        p["sp"][hold] = rng.integers(2, 17, len(hold))
        p["msize"][hold] = rng.integers(0, 257, len(hold))
        p["mlog_count"][hold] = rng.integers(0, 9, len(hold))
        p["scount"][hold] = rng.integers(0, 9, len(hold))
        p["status"][fit] = rng.choice([0, 5], len(fit))
        p["steps"][fit] = budget + rng.integers(0, 5, len(fit))
        p["sp"][fit] = rng.integers(0, 25, len(fit))
        p["msize"][fit] = rng.integers(0, 513, len(fit))
        p["mlog_count"][fit] = rng.integers(0, 9, len(fit))
        p["scount"][fit] = rng.integers(0, 9, len(fit))
        own = -(np.arange(n)[:, None] * r + np.arange(r)[None, :] + 1)
        if canon_all:
            p["dlog_count"][:] = r
            canon = own.astype(np.int32)
        else:
            pick = rng.integers(0, 3, (n, r))
            canon = np.where(pick == 0, own, np.where(
                pick == 1, -rng.integers(1, n * r + 1, (n, r)), 0))
            canon = canon.astype(np.int32)
        cases.append(K4Case(name, n, widths, p, canon, K4_CODE, budget,
                            resume_on))

    case("caps_over", 200, "caps", 501, envelope=80, parked=40)
    case("resume_off", 200, "caps", 501, resume_on=0, envelope=80,
         parked=40)
    case("lanes_1", 1, "caps", 502, envelope=1)
    case("lanes_8", 8, "wide", 503, envelope=3, parked=3)
    case("lanes_33", 33, "narrow", 504, envelope=10, parked=10)
    case("lanes_64", 64, "caps", 505, envelope=20, parked=20)
    case("urb_over", 64, "caps", 506, canon_all=True)
    case("fb_over", 600, "narrow", 507, envelope=100, parked=100)
    cases[-1].planes["flog_count"][...] = 600
    return cases


def k4_case_inputs(case: K4Case, device):
    """A K4 case's (state, code, canon, budget, resume_on) on
    ``device``."""
    from .. import interop

    dev = resolve(device)
    return (interop.state_from_numpy(case.planes, dev),
            compile_code(case.code, device=dev),
            torch.from_numpy(case.canon).to(dev), case.budget,
            case.resume_on)


# ---------------------------------------------------------------------------
# K10 lane_run and K9 merge_fingerprint edge inputs
# ---------------------------------------------------------------------------

#: the inputs K10 is held to on both sides (``k10_edge_cases``): a
#: contract's bytes, every plane of the batch (numpy, the JAX dtypes),
#: the run's step cap, and ``view`` (offset, lanes) where the run takes a
#: shard view of the batch (None: the whole batch)
K10Case = namedtuple("K10Case", "name code planes max_steps view")

#: plane sizes of the K10 cases: ``arms`` holds every arm's stores and
#: stacks, ``odd`` has a memory width no multiple of 4, ``bench`` is
#: ``contracts.BENCH_LANE_KW``, ``default`` ``init_lanes``' defaults
#: (past K10's on-chip budget: memory and storage read in place)
K10_SHAPES = {
    "arms": dict(stack_depth=24, memory_bytes=1024, storage_slots=6,
                 calldata_bytes=160),
    "odd": dict(stack_depth=20, memory_bytes=95, storage_slots=5,
                calldata_bytes=130),
    "bench": dict(stack_depth=16, memory_bytes=64, storage_slots=4,
                  calldata_bytes=32),
    "default": dict(stack_depth=64, memory_bytes=4096, storage_slots=64,
                    calldata_bytes=512),
}

_M256 = (1 << 256) - 1
#: operand words of the binary-op arm: carries and borrows across every
#: limb, signs, one-limb and wide divisors, shift amounts at and past 256
_K10_WORDS = (0, 1, 2, 3, 7, 31, 32, 97, 255, 256, 257, (1 << 32) - 1,
              1 << 32, (1 << 64) - 1, (1 << 128) + 5, 1 << 255,
              (1 << 255) - 1, _M256, _M256 - 1, _M256 - 96,
              0x0123456789ABCDEF0011223344556677_8899AABBCCDDEEFF0F1E2D3C4B5A6978)
_BINOPS = ("ADD", "MUL", "SUB", "DIV", "SDIV", "MOD", "SMOD", "EXP",
           "SIGNEXTEND", "LT", "GT", "SLT", "SGT", "EQ", "AND", "OR", "XOR",
           "BYTE", "SHL", "SHR", "SAR")
_ENV_OPS = ("ADDRESS", "ORIGIN", "CALLER", "CALLVALUE", "GASPRICE",
            "COINBASE", "TIMESTAMP", "NUMBER", "DIFFICULTY", "GASLIMIT",
            "CHAINID", "SELFBALANCE", "BASEFEE")


def k10_arms(depth: int, mem: int, slots: int, cd: int, pad: int = 0):
    """The arms contract of the K10 cases for these plane sizes, and its
    arm names in order: a switch on calldata word 0 (arm i at value
    i + 1; 0 runs the bench loop on word 1 % 97). ``pad`` bytes of code
    no lane reaches (PUSH32s of JUMPDEST bytes, then JUMPDESTs) sit
    between the bench loop and the arms, so every arm's jump goes that
    far. Each arm ends in one status cause or result class:

    - ``binops``: every binary op on calldata words 1 and 2 (``_BINOPS``),
      ADDMOD and MULMOD with word 3, ISZERO and NOT, each result stored
      at its own memory word; then RETURN of the first 64 bytes;
    - ``env``: the env words, PC, GAS, MSIZE, CALLDATASIZE and CODESIZE
      stored, then STOP;
    - ``mem_edge``: MSTORE and MLOAD at M - 32, MSTORE8 at M - 1, MLOAD
      back, then REVERT of 8 bytes;
    - ``mload_oob``, ``mstore_oob``: a word at M - 31 (parks);
      ``mstore8_oob``: a byte at M; ``mem_big``: MLOAD at 2**40;
    - ``mstore_underflow``: MSTORE of one item (INVALID; msize still
      rounds up to its offset);
    - ``storage_full``: SSTOREs to S distinct keys, a rewrite of the
      first, SLOADs, then a new key (parks);
    - ``cdl_edge``: CALLDATALOAD at CALLDATASIZE - 1, past it, at 2**40
      and across the word; ``cdl_oob``: at C - 16 (parks where
      cd_size passes it);
    - ``ret_oob``, ``revert_oob``: a range past M (parks);
      ``ret_empty``: RETURN of 0 bytes at 2**40 (RETURNED, 0, 0);
    - ``dup16_under``, ``swap16_under``: one item short (INVALID);
      ``dup16``, ``swap16``: enough items (STOP);
    - ``overflow``: D + 1 pushes (parks at D);
    - ``bad_jump``, ``bad_jumpi``, ``wide_jump``: a destination that is
      no JUMPDEST, and one past 32 bits (INVALID);
    - ``invalid``, ``underflow`` (POP of nothing), ``unsupported``
      (BALANCE parks), ``sha3`` (parks), ``selfdestruct``, ``stop``,
      ``oog`` (a loop until the lane's gas runs out)."""
    from .contracts import assemble

    def store_all(ops):
        out = []
        for i, op in enumerate(ops):
            out += op + [32 * i, "MSTORE"]
        return out

    def cdl(word):
        return [32 * word, "CALLDATALOAD"]

    binops = [cdl(2) + cdl(1) + [op] for op in _BINOPS]
    binops += [cdl(3) + cdl(2) + cdl(1) + [op] for op in ("ADDMOD", "MULMOD")]
    binops += [cdl(1) + ["ISZERO"], cdl(1) + ["NOT"], cdl(2) + ["ISZERO"]]
    arms = {
        "binops": store_all(binops) + [64, 0, "RETURN"],
        "env": store_all([[op] for op in _ENV_OPS + (
            "PC", "GAS", "MSIZE", "CALLDATASIZE", "CODESIZE")]) + ["STOP"],
        "mem_edge": cdl(1) + [mem - 32, "MSTORE", mem - 32, "MLOAD",
                              0xAB, mem - 1, "MSTORE8", mem - 32, "MLOAD",
                              8, 0, "REVERT"],
        "mload_oob": [mem - 31, "MLOAD", "STOP"],
        "mstore_oob": [7, mem - 31, "MSTORE", "STOP"],
        "mstore8_oob": [7, mem, "MSTORE8", "STOP"],
        "mem_big": [1 << 40, "MLOAD", "STOP"],
        "mstore_underflow": [64, "MSTORE", "STOP"],
        "storage_full": sum(([k + 11, k + 1, "SSTORE"] for k in range(slots)),
                            []) + [99, 1, "SSTORE", 1, "SLOAD", slots,
                                   "SLOAD", 77, "SLOAD", 5, slots + 1,
                                   "SSTORE", "STOP"],
        "cdl_edge": ["CALLDATASIZE", 1, "SWAP1", "SUB", "CALLDATALOAD",
                     "CALLDATASIZE", "CALLDATALOAD", 1 << 40, "CALLDATALOAD",
                     "CALLDATASIZE", 20, "SWAP1", "SUB", "CALLDATALOAD",
                     "STOP"],
        "cdl_oob": [cd - 16, "CALLDATALOAD", "STOP"],
        "ret_oob": [32, mem - 16, "RETURN"],
        "revert_oob": [1 << 31, 0, "REVERT"],
        "ret_empty": [0, 1 << 40, "RETURN"],
        "dup16_under": [1] * 15 + ["DUP16", "STOP"],
        "dup16": [1] * 16 + ["DUP16", "STOP"],
        "swap16_under": [1] * 16 + ["SWAP16", "STOP"],
        "swap16": list(range(1, 18)) + ["SWAP16", "STOP"],
        "overflow": [2] * (depth + 1) + ["STOP"],
        "bad_jump": [3, "JUMP"],
        "bad_jumpi": [1, 5, "JUMPI"],
        "wide_jump": [(1 << 40) + 3, "JUMP"],
        "invalid": ["INVALID"],
        "underflow": ["POP"],
        "unsupported": [5, "BALANCE", "STOP"],
        "sha3": [32, 0, "SHA3", "STOP"],
        "selfdestruct": [0, "SELFDESTRUCT"],
        "stop": ["STOP"],
        "oog": [("label", "spin"), ("ref", "spin"), "JUMP"],
    }
    items = [0, "CALLDATALOAD"]
    for i, name in enumerate(arms):
        items += ["DUP1", i + 1, "EQ", ("ref", name), "JUMPI"]
    # word 0 matched no arm: the bench loop on word 1 % 97
    items += ["POP", 32, "CALLDATALOAD", 97, "SWAP1", "MOD", 1,
              ("label", "loop"), "DUP2", "ISZERO", ("ref", "done"), "JUMPI",
              3, "MUL", "DUP2", "ADD", "SWAP1", 1, "SWAP1", "SUB", "SWAP1",
              ("ref", "loop"), "JUMP", ("label", "done"), 0, "SSTORE",
              "STOP"]
    items += [int.from_bytes(b"\x5b" * 32, "big")] * (pad // 33)
    items += ["JUMPDEST"] * (pad % 33)
    for name, body in arms.items():
        items += [("label", name)] + body
    return assemble(items), tuple(arms)


def _k10_planes(n: int, shape: dict) -> dict:
    """An n-lane batch of ``shape`` (``K10_SHAPES``): numpy planes in the
    JAX dtypes, every lane RUNNING at pc 0 with the largest gas limit."""
    from ..ops.stepper import N_ENV

    d, m = shape["stack_depth"], shape["memory_bytes"]
    s, c = shape["storage_slots"], shape["calldata_bytes"]
    i32 = lambda: np.zeros(n, np.int32)  # noqa: E731
    return dict(
        pc=i32(), sp=i32(), stack=np.zeros((n, d, NLIMBS), np.uint32),
        memory=np.zeros((n, m), np.uint8), msize=i32(),
        skeys=np.zeros((n, s, NLIMBS), np.uint32),
        svals=np.zeros((n, s, NLIMBS), np.uint32), scount=i32(),
        calldata=np.zeros((n, c), np.uint8), cd_size=i32(),
        env=np.zeros((n, N_ENV, NLIMBS), np.uint32),
        gas_used=np.zeros(n, np.uint32),
        gas_limit=np.full(n, 0xFFFFFFFF, np.uint32), status=i32(),
        ret_offset=i32(), ret_len=i32(), steps=i32())


def _put_word(row: np.ndarray, at: int, value: int) -> None:
    """value as 32 big-endian bytes into row[at:at + 32] (clipped)."""
    b = np.frombuffer(int(value).to_bytes(32, "big"), np.uint8)
    end = min(at + 32, row.shape[0])
    if end > at:
        row[at:end] = b[:end - at]


def _arms_batch(n: int, shape: dict, names, seed: int) -> dict:
    """A batch for ``k10_arms``: lane i takes arm i % (len(names) + 1)
    (0: the bench loop), operand words from ``_K10_WORDS`` and seeded
    random words, cd_size from 0 past the buffer, seeded env words; the
    ``oog`` arm's lanes a gas limit that runs out; past the first round
    of arms, one lane in ten not RUNNING (every status), some at a pc
    past the code and some with a small gas limit."""
    rng = np.random.default_rng(seed)
    p = _k10_planes(n, shape)
    c = shape["calldata_bytes"]
    pool = list(_K10_WORDS)
    arms = np.arange(n) % (len(names) + 1)
    for i in range(n):
        row = p["calldata"][i]
        _put_word(row, 0, int(arms[i]))
        for w in (1, 2, 3):
            v = pool[int(rng.integers(len(pool)))] if rng.random() < 0.7 \
                else int.from_bytes(rng.bytes(32), "big")
            _put_word(row, 32 * w, v)
        p["cd_size"][i] = c if arms[i] == 0 else \
            rng.choice([c, c, c, c - 13, 40, 0, c + 9])
    words = rng.integers(0, 1 << 32, p["env"].shape, dtype=np.uint64)
    p["env"][:] = words.astype(np.uint32)
    p["env"][::3, :, 1:] = 0  # small env words on a third of the lanes
    p["gas_limit"][arms == names.index("oog") + 1] = 300
    rest = np.arange(n) > len(names)
    off = rest & (rng.random(n) < 0.1)
    p["status"][off] = rng.integers(1, 7, int(off.sum()))
    p["pc"][rest & (rng.random(n) < 0.03)] = 1 << 20
    poor = rest & (rng.random(n) < 0.05)
    p["gas_limit"][poor] = rng.integers(0, 400, int(poor.sum()))
    return p


def k10_edge_cases(full: bool = False):
    """The edge inputs of K10 (``lane_run``): on the card
    ``chip_smoke.py`` holds K10 to ``run_plain`` on them (``full``: at
    the lane counts of the card's paths); on the CPU
    ``tests/test_torch_k10_edges.py`` holds ``run_plain`` to the JAX
    ``run_jit``, bit for bit. Each is a ``K10Case``.

    - ``arms_33`` (33 lanes, ``arms`` planes): every arm of ``k10_arms``
      (each result class and status cause, MSTORE/MLOAD at M - 32 and
      M - 31, storage full at S, CALLDATALOAD across cd_size and C,
      RETURN out of range, DUP16/SWAP16 underflow, overflow at D) beside
      bench loops of different counts in one warp, lanes not RUNNING
      at the start, a pc past the code, gas running out;
    - ``arms_1``: one lane; ``steps_0`` and ``steps_1``: ``arms_33``
      with max_steps 0 and 1;
    - ``loop_counts`` (33 lanes, the bench contract and planes): every
      lane a different loop count, some not RUNNING;
    - ``odd_memory``: the arms at a memory width of 95 bytes;
    - ``default_planes``: the arms at ``init_lanes``' defaults, past
      K10's on-chip budget (memory and storage read in place): 33 lanes,
      131072 with ``full``;
    - ``lanes_4096``: the arms at 4096 lanes (``full``: also
      ``lanes_32768``, whose rows pass K10's on-chip budget);
    - ``long_code`` and ``long_code_default``: the arms past
      ``K10_LONG_PAD`` bytes of unreached code, so the code's rows pass
      K10's code budget and are read in place (``odd`` planes on chip,
      the default planes in place);
    - ``shard_view``: lanes 5-32 of a 40-lane ``odd`` batch, run as a
      view at that offset (its memory rows then start off 16 bytes)."""
    from ..support.contracts import build_bench_contract, bench_calldata

    cases = []
    for name, n, shape_name, seed, max_steps, view, pad in _k10_specs(full):
        if name == "loop_counts":
            p = _k10_planes(n, K10_SHAPES[shape_name])
            p["calldata"][:] = bench_calldata(n)
            p["calldata"][:, 31] = np.arange(n) * 3  # word % 97: n counts
            p["cd_size"][:] = 32
            p["status"][[4, 9, 30]] = [Status.STOPPED, Status.NEEDS_HOST,
                                       Status.INVALID]
            cases.append(K10Case(name, build_bench_contract(), p,
                                 max_steps, view))
            continue
        shape = K10_SHAPES[shape_name]
        code, names = k10_arms(shape["stack_depth"], shape["memory_bytes"],
                               shape["storage_slots"],
                               shape["calldata_bytes"], pad)
        p = _arms_batch(n, shape, names, seed)
        if name == "arms_33":
            p["status"][[31, 32]] = [Status.STOPPED, Status.NEEDS_HOST]
        cases.append(K10Case(name, code, p, max_steps, view))
    return cases


#: the unreached code of the ``long_code`` cases: the arms contract then
#: passes ``ops/stepper.K10_CODE_BUDGET`` (2047 bytes)
K10_LONG_PAD = 2100


def _k10_specs(full: bool):
    """(name, lanes, ``K10_SHAPES`` key, seed, max_steps, view, pad) of
    each K10 case, in order."""
    specs = [("arms_33", 33, "arms", 1001, 400, None),
             ("arms_1", 1, "arms", 1002, 400, None),
             ("steps_0", 33, "arms", 1001, 0, None),
             ("steps_1", 33, "arms", 1001, 1, None),
             ("loop_counts", 33, "bench", 0, 1800, None),
             ("odd_memory", 33, "odd", 1003, 400, None),
             ("default_planes", 131072 if full else 33, "default", 1004,
              400, None),
             ("lanes_4096", 4096, "arms", 1005, 400, None)]
    if full:
        specs.append(("lanes_32768", 32768, "arms", 1006, 400, None))
    specs += [("shard_view", 40, "odd", 1007, 400, (5, 28)),
              ("long_code", 33, "odd", 1008, 400, None),
              ("long_code_default", 33, "default", 1009, 400, None)]
    return [s + (K10_LONG_PAD if s[0].startswith("long_code") else 0,)
            for s in specs]


def k10_case_sizes(full: bool = False):
    """(name, lanes run, D, M, S, code bytes) of each K10 case, without
    building its planes."""
    from ..support.contracts import build_bench_contract

    out = []
    for name, n, shape_name, _, _, view, pad in _k10_specs(full):
        sh = K10_SHAPES[shape_name]
        code = build_bench_contract() if name == "loop_counts" else k10_arms(
            sh["stack_depth"], sh["memory_bytes"], sh["storage_slots"],
            sh["calldata_bytes"], pad)[0]
        out.append((name, view[1] if view else n, sh["stack_depth"],
                    sh["memory_bytes"], sh["storage_slots"], len(code)))
    return out


def k10_case_inputs(case: K10Case, device):
    """A K10 case's (code, whole batch) on ``device``; the run takes
    ``view_of(batch, case.view)``."""
    from .. import interop

    dev = resolve(device)
    return (compile_code(case.code, device=dev),
            interop.state_from_numpy(case.planes, dev))


def view_of(st, view):
    """The lanes [offset, offset + count) of a ``LaneState`` as views
    (no copy), or ``st`` where view is None."""
    from ..ops.stepper import LANE_FIELDS, LaneState

    if view is None:
        return st
    a, k = view
    return LaneState(**{f: getattr(st, f)[a:a + k] for f in LANE_FIELDS})


#: the inputs K9 is held to on both sides (``k9_edge_cases``): every
#: plane of a symbolic batch (numpy, the JAX dtypes) and the resolution
#: pairs ((pv, 2) int32)
K9Case = namedtuple("K9Case", "name lanes widths planes pairs")


def k9_edge_cases():
    """The edge inputs of K9 (``merge_fingerprint``): on the card
    ``chip_smoke.py`` holds K9 to ``merge_fingerprint_plain`` on them;
    on the CPU ``tests/test_torch_k9_edges.py`` holds the plain version
    to the JAX ``_merge_fingerprint``, bit for bit. Planes as
    ``window_planes`` (sids of every kind), memory kinds 0-3.

    - ``lanes_1``, ``lanes_33``, ``lanes_64``, ``lanes_600``,
      ``lanes_4096``: a padded pair bucket (``PROV_BUCKET`` rows or
      n * R where smaller);
    - ``no_pairs``: pv = 0 (every provisional sid unresolved);
    - ``slots``: negative slots (-1, -n*R, below -n*R: dropped), one
      past n*R (dropped), a slot named twice (the last pair wins);
    - ``past_shared``: more pairs than K9's shared hash holds
      (``K9_PROV_LOCAL``): n * R + 8 rows, K9's dense table;
    - ``scount_0``, ``scount_full``: every lane's storage table empty,
      and full at S, with write stamps from two values (ties);
    - ``odd_memory``: a memory width no multiple of 16 (K9 reads it a
      byte at a time)."""
    cases = []

    def case(name, n, wname, seed, pv=None, extra=(), scount=None):
        rng = np.random.default_rng(seed)
        widths = WINDOW_WIDTHS[wname]
        r, s = widths["dlog_records"], widths["storage_slots"]
        p = window_planes(n, widths, rng)
        p["mkind"] = rng.integers(0, 4, p["mkind"].shape, dtype=np.uint8)
        p["sp"] = rng.integers(0, widths["stack_depth"] + 1, n
                               ).astype(np.int32)
        p["mlog_count"] = rng.integers(
            0, widths["mem_records"] + 1, n).astype(np.int32)
        p["scount"] = (rng.integers(0, s + 1, n) if scount is None
                       else np.full(n, scount)).astype(np.int32)
        p["s_written"] = rng.integers(0, 2, p["s_written"].shape
                                      ).astype(np.int32)
        p["s_wstep"] = rng.integers(0, 2 if scount else 4,
                                    p["s_wstep"].shape).astype(np.int32)
        nr = n * r
        if pv is None:
            pv = min(le.PROV_BUCKET, nr)
        pairs = np.full((pv, 2), nr, np.int32)
        m = min(pv - len(extra), nr, int(rng.integers(pv // 4, pv // 2 + 2)))
        m = max(m, 0)
        pairs[:m, 0] = rng.choice(nr, m, replace=False)
        pairs[:m, 1] = rng.integers(1, 1 << 20, m)
        for j, (slot, oid) in enumerate(extra):
            pairs[m + j] = (slot, oid)
        cases.append(K9Case(name, n, widths, p, pairs))

    for n, seed in ((1, 901), (33, 902), (64, 903), (600, 904),
                    (4096, 905)):
        case(f"lanes_{n}", n, "caps" if n < 600 else "narrow", seed)
    case("no_pairs", 33, "caps", 906, pv=0)
    nr = 33 * WINDOW_WIDTHS["caps"]["dlog_records"]
    case("slots", 33, "caps", 907, pv=64,
         extra=((-1, 11), (-nr, 12), (-nr - 1, 13), (nr + 2, 14), (5, 15),
                (5, 16), (nr - 1, 17)))
    n, r = 300, WINDOW_WIDTHS["narrow"]["dlog_records"]
    case("past_shared", n, "narrow", 908, pv=n * r + 8)
    case("scount_0", 33, "caps", 909, scount=0)
    case("scount_full", 33, "caps", 910,
         scount=WINDOW_WIDTHS["caps"]["storage_slots"])
    case("odd_memory", 40, "wide", 911)
    return cases


def k9_case_inputs(case: K9Case, device):
    """A K9 case's (state, pairs) on ``device``."""
    from .. import interop

    dev = resolve(device)
    return (interop.state_from_numpy(case.planes, dev),
            torch.from_numpy(case.pairs).to(dev))


#: K13's edge widths: around a warp, around a block of 256 threads of 16
#: lanes (4096), and the mesh phase's wide deal
K13_WIDTHS = (1, 31, 32, 33, 4095, 4096, 4097, 131072)
K13_DEVS = (1, 2, 4, 8)


def k13_edge_cases():
    """The edge inputs of K13 (``parallel/mesh.lane_order``): on the card
    ``chip_smoke.py`` holds K13 to ``lane_order_plain`` on them; on the
    CPU ``tests/test_torch_k13_edges.py`` holds the plain version to the
    JAX ``jnp.argsort(-running, stable=True)`` and ``steal_balance``'s
    deal, bit for bit. Each case: (name, status plane as int32 numpy,
    the shard counts ``n_dev`` to deal over: those of ``K13_DEVS`` that
    divide n).

    - ``n`` 1, 31, 32, 33, 4095, 4096, 4097 and 131072 lanes, each
      ``all`` running, ``none`` running (every halting status in turn),
      ``alternating`` (even lanes run) and ``last`` (only the last lane
      runs);
    - ``runs_across``: runs of running lanes that start one lane before
      and end one lane after each boundary of K13's tiles (16 lanes a
      thread, 4096 a 256-thread block's tile), at 32768 and 131072 lanes
      (grids of 8 and 32 blocks), and a seeded mix of every status at
      131072."""
    halts = [Status.STOPPED, Status.RETURNED, Status.REVERTED,
             Status.INVALID, Status.NEEDS_HOST, Status.SELFDESTRUCT]
    cases = []

    def devs(n):
        return tuple(d for d in K13_DEVS if n % d == 0)

    for n in K13_WIDTHS:
        idx = np.arange(n)
        none = np.array([halts[i % len(halts)] for i in range(min(n, 64))]
                        * (-(-n // 64)))[:n]
        pats = {
            "all": np.full(n, Status.RUNNING),
            "none": none,
            "alternating": np.where(idx % 2 == 0, Status.RUNNING, none),
            "last": np.where(idx == n - 1, Status.RUNNING, none),
        }
        for pat, st in pats.items():
            cases.append((f"n{n}_{pat}", st.astype(np.int32), devs(n)))
    for n in (32768, 131072):
        st = np.full(n, halts[0], np.int32)
        for edge in range(16, n, 4096):
            st[edge - 1:edge + 1] = Status.RUNNING
        for edge in range(4096, n, 4096):
            st[edge - 2:edge + 2] = Status.RUNNING
        for edge in range(16384, n, 16384):
            st[edge - 1:edge + 2] = halts[-1]
            st[edge:edge + 1] = Status.RUNNING
        cases.append((f"runs_across_{n}", st, devs(n)))
    rng = np.random.default_rng(13)
    every = [Status.RUNNING] + halts
    cases.append(("mixed_131072",
                  rng.choice(every, 131072).astype(np.int32), devs(131072)))
    return cases


#: K12's shard widths of a lane, 3 lanes and 5 lanes (a shard boundary
#: inside a 16-lane tile), over 8 shards
K12_SHARD_LANES = (1, 3, 5)


def k12_edge_cases():
    """The edge inputs of K12 (``parallel/mesh.lane_live`` and
    ``live_lane_counts``): on the card ``chip_smoke.py`` holds K12 to
    ``lane_live_plain`` on them, one launch a device a call; on the CPU
    ``tests/test_torch_k12_edges.py`` holds the plain version and
    ``live_lane_counts`` to the JAX ``live_lane_counts`` on the virtual
    CPU devices. Each case: (name, status plane as int32 numpy, the
    shard counts ``n_dev`` to count over: those of ``K13_DEVS`` that
    divide n, the lanes of the status's storage before its first lane).

    - every case of ``k13_edge_cases`` (``n`` 1-131072 lanes all, none,
      alternating and last running; runs across K13's tiles; the seeded
      mix of every status at 131072 lanes);
    - ``shards_of_{1,3,5}``: 8 shards of 1, 3 and 5 lanes (K12's tiles
      are 16 lanes, so several shards share one), a seeded mix of
      statuses;
    - ``offset_view``: 4104 lanes read from one lane into their storage
      (a view only 4-byte aligned: K12's scalar loads), a seeded mix;
    - ``tiles_and_shards_{32768,131072}``: runs of running lanes from one lane
      before to one lane after each boundary of K12's tiles (16 lanes),
      of a warp's tiles (512 lanes), of a block's (1024 lanes) and of
      each shard count's shards, halted lanes elsewhere."""
    halts = [Status.STOPPED, Status.RETURNED, Status.REVERTED,
             Status.INVALID, Status.NEEDS_HOST, Status.SELFDESTRUCT]
    every = [Status.RUNNING] + halts
    rng = np.random.default_rng(12)

    def devs(n):
        return tuple(d for d in K13_DEVS if n % d == 0)

    cases = [(name, st, ds, 0) for name, st, ds in k13_edge_cases()]
    for w in K12_SHARD_LANES:
        n = 8 * w
        cases.append((f"shards_of_{w}",
                      rng.choice(every, n).astype(np.int32), devs(n), 0))
    cases.append(("offset_view", rng.choice(every, 4104).astype(np.int32),
                  devs(4104), 1))
    for n in (32768, 131072):
        st = np.full(n, halts[1], np.int32)
        edges = set(range(16, n, 16 * 67)) | set(range(512, n, 512)) \
            | set(range(1024, n, 1024))
        for d in devs(n):
            edges |= set(range(n // d, n, n // d))
        for edge in sorted(edges):
            st[edge - 1:edge + 1] = Status.RUNNING
        cases.append((f"tiles_and_shards_{n}", st, devs(n), 0))
    return cases


def k12_status(case, device) -> torch.Tensor:
    """A K12 case's status plane on ``device``: a view ``offset`` lanes
    into its storage."""
    _, status, _, offset = case
    buf = torch.full((offset + status.shape[0],), Status.STOPPED,
                     dtype=torch.int32, device=resolve(device))
    buf[offset:] = torch.from_numpy(status).to(buf.device)
    return buf[offset:]
