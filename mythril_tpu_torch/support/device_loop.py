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
