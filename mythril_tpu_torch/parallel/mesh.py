"""Lane sharding over a mesh of devices: SPMD lane stepping, the live-lane
count, compaction and the work-stealing deal.

The counterpart of ``mythril_tpu/parallel/mesh.py`` (kernel row 14),
with its names. A ``Mesh`` is an ordered tuple of ``torch.device``s
along the ``lanes`` axis; ``make_mesh(n)`` takes the first ``n`` CUDA
devices, as the JAX function takes ``jax.devices()[:n]``, and a mesh
may also be built from a device list in which one device repeats (the
counterpart of the JAX tests' virtual CPU devices: several shards on
one card or on the CPU). A sharded batch (``ShardedLanes``) keeps
``P("lanes")``'s placement: lane ``i`` lives in shard
``i // (N / n_dev)``. Where every shard is on one device, the shards
are views of one batch, which ``ShardedLanes.lanes()`` returns;
otherwise that global batch is gathered onto the first device.

- ``sharded_run``: ``stepper.run`` on each shard (kernel K10 on a CUDA
  shard, the plain loop on a CPU one), each shard stepping until its
  own lanes halt, with no traffic between shards; the shards update in
  place, as ``stepper.run`` does.
- ``live_lane_counts``: the RUNNING lanes per shard, kernel K12
  ``lane_live`` (``csrc/mesh.cu``): one launch a device over every
  shard on it (``device_groups``), the counts written by the launch
  into a pinned host buffer mapped into the card's address space, one
  wait a device, and their total summed in the process.
- ``compact_lanes``: the stable "running first" order (or a caller's
  ``order``, with JAX's index rule: a negative index wraps once, then
  an index out of range clamps), kernel K13 ``lane_order``, then every
  plane gathered in that order, kernel K14 ``lane_gather``.
- ``steal_balance``: the same order dealt round-robin over the shards
  (sorted lane ``s * n_dev + d`` to shard ``d``, slot ``s``) in the
  same K13 launch, then K14, then resharded.

Each kernel's wrapper (``lane_live``, ``lane_order``, ``lane_gather``)
runs its plain PyTorch version (``*_plain``) on a CPU tensor and
launches its kernel on a CUDA one, counting the launch in
``_build.LAUNCHES``; a failed build or launch raises.

The meshed lane engine's batch is here too: ``SymShards`` (a symbolic
batch a shard a device, each shard its own allocation, and the batch's
global planes on the first device), made by ``shard_sym_lanes``, with
``gather_home``/``scatter_home`` to move planes between the shards and
the first device.
"""

import contextlib
import ctypes
import math
from dataclasses import dataclass, field
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..ops import stepper
from ..ops.stepper import LANE_FIELDS, CompiledCode, LaneState, Status

LANES_AXIS = "lanes"


class Devices(tuple):
    """A mesh's devices in order: a tuple that also answers ``size`` and
    ``flat``, as the JAX mesh's array of devices does."""

    @property
    def size(self) -> int:
        return len(self)

    @property
    def flat(self):
        return iter(self)


@dataclass(frozen=True, init=False)
class Mesh:
    """A 1-D mesh: ``devices`` in order along ``axis_names[0]``."""

    devices: Devices
    axis_names: Tuple[str, ...]

    def __init__(self, devices: Sequence, axis_names=(LANES_AXIS,)):
        devs = tuple(torch.device(d) for d in devices)
        devs = Devices(torch.device("cuda", torch.cuda.current_device())
                       if d.type == "cuda" and d.index is None else d
                       for d in devs)
        if not devs:
            raise ValueError("a mesh needs at least one device")
        object.__setattr__(self, "devices", devs)
        object.__setattr__(self, "axis_names", tuple(axis_names))

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def one_device(self) -> Optional[torch.device]:
        """The device every shard lives on, or None when they differ."""
        first = self.devices[0]
        return first if all(d == first for d in self.devices) else None


@dataclass(frozen=True)
class NamedSharding:
    """Where an array lives on a mesh: ``spec`` ``(LANES_AXIS,)`` splits
    its leading axis over the mesh, ``()`` replicates it."""

    mesh: Mesh
    spec: Tuple[str, ...]


def make_mesh(n_devices: Optional[int] = None) -> Mesh:
    """1-D mesh over the first ``n_devices`` CUDA devices (default:
    all). Raises without a usable card."""
    from ..support.devices import resolve

    resolve("cuda")
    devs = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh([resolve(d) for d in devs])


def lane_sharding(mesh: Mesh) -> NamedSharding:
    """Shard the leading (lane) axis; replicate everything smaller."""
    return NamedSharding(mesh, (LANES_AXIS,))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, ())


@dataclass
class ShardedLanes:
    """A ``LaneState`` split along its lanes over ``mesh``: ``shards[i]``
    holds lanes ``[i * per, (i + 1) * per)`` on ``mesh.devices[i]``;
    ``whole`` is the batch the shards are views of, where every shard
    lives on one device (else None)."""

    mesh: Mesh
    shards: Tuple[LaneState, ...]
    whole: Optional[LaneState] = None

    def lanes(self) -> LaneState:
        """The global batch: ``whole``, or the shards gathered onto the
        mesh's first device (a copy)."""
        if self.whole is not None:
            return self.whole
        dev = self.mesh.devices[0]
        return LaneState(**{f: torch.cat([getattr(s, f).to(dev)
                                          for s in self.shards])
                            for f in LANE_FIELDS})


def _lanes_of(state: Union[LaneState, ShardedLanes]) -> LaneState:
    return state.lanes() if isinstance(state, ShardedLanes) else state


def _per_shard(n: int, n_dev: int) -> int:
    if n_dev < 1 or n % n_dev:
        raise ValueError(f"{n} lanes not divisible by {n_dev} devices")
    return n // n_dev


def shard_lanes(state: Union[LaneState, ShardedLanes],
                mesh: Mesh) -> ShardedLanes:
    """Place every per-lane plane with its leading axis split across the
    mesh. Lane count must be divisible by mesh size. Planes already on
    a shard's device are not copied: the shards are views of them."""
    state = _lanes_of(state)
    per = _per_shard(state.pc.shape[0], mesh.size)

    def cut(st, i, dev):
        return LaneState(**{f: getattr(st, f)[i * per:(i + 1) * per]
                            .to(dev).contiguous() for f in LANE_FIELDS})

    dev = mesh.one_device
    if dev is None:
        return ShardedLanes(mesh, tuple(cut(state, i, d) for i, d in
                                        enumerate(mesh.devices)))
    whole = LaneState(**{f: getattr(state, f).to(dev).contiguous()
                         for f in LANE_FIELDS})
    return ShardedLanes(mesh, tuple(cut(whole, i, dev)
                                    for i in range(mesh.size)), whole)


def replicate_code(code: CompiledCode, mesh: Mesh
                   ) -> Tuple[CompiledCode, ...]:
    """One ``CompiledCode`` a shard, on the shard's device (one copy a
    device)."""
    copies = {}
    for dev in mesh.devices:
        if dev not in copies:
            copies[dev] = code if code.packed.device == dev else \
                CompiledCode(
                    packed=code.packed.to(dev), size=code.size,
                    seg_of=None if code.seg_of is None
                    else code.seg_of.to(dev),
                    seg_tab=None if code.seg_tab is None
                    else code.seg_tab.to(dev))
    return tuple(copies[d] for d in mesh.devices)


def _on(dev: torch.device):
    """Make ``dev`` the current CUDA device for a launch on it."""
    return torch.cuda.device(dev) if dev.type == "cuda" \
        else contextlib.nullcontext()


def sharded_run(code, state: Union[LaneState, ShardedLanes],
                max_steps: int, mesh: Mesh) -> ShardedLanes:
    """Run the stepper on each shard: ``stepper.run`` over its own lanes
    until they halt or ``max_steps`` steps, with no traffic between
    shards (the JAX function's ``shard_map``; each shard's loop ends as
    soon as its own lanes halt). ``code`` is a ``CompiledCode`` or
    ``replicate_code``'s tuple. The shards update in place."""
    sh = state if isinstance(state, ShardedLanes) \
        else shard_lanes(state, mesh)
    if sh.mesh != mesh:
        raise ValueError("the state is sharded over another mesh")
    codes = code if isinstance(code, tuple) else replicate_code(code, mesh)
    if len(codes) != mesh.size:
        raise ValueError(f"{len(codes)} code copies for {mesh.size} shards")
    for cc, shard, dev in zip(codes, sh.shards, mesh.devices):
        with _on(dev):
            stepper.run(cc, shard, max_steps)
    return sh


def device_groups(mesh: Mesh):
    """Each device of ``mesh`` with its shards: [(device, the shards'
    indices in mesh order)], the devices in the order they first
    appear. K12 runs once a device, over its group."""
    groups = {}
    for i, dev in enumerate(mesh.devices):
        groups.setdefault(dev, []).append(i)
    return list(groups.items())


def live_lane_counts(state: Union[LaneState, ShardedLanes], mesh: Mesh):
    """(per-shard running-lane counts as an int32 numpy array, global
    total): one K12 launch a device over its shards (the one batch the
    shards are views of, or each shard's own copy), which writes the
    counts into a pinned host buffer mapped into the cards' address
    space and returns when they are there; the total summed here. On CPU
    shards the plain version."""
    sh = state if isinstance(state, ShardedLanes) \
        else shard_lanes(state, mesh)
    if sh.whole is not None:
        groups = [(sh.whole.status.device, [sh.whole.status], mesh.size,
                   list(range(mesh.size)))]
    else:
        groups = [(dev, [sh.shards[i].status for i in idx], 1, idx)
                  for dev, idx in device_groups(mesh)]
    per = np.zeros(mesh.size, np.int32)
    for dev, statuses, spp, idx in groups:
        if dev.type != "cuda":
            per[idx] = torch.cat([lane_live_plain(x, spp)
                                  for x in statuses]).numpy()
            continue
        view, addr = _live_host(mesh.size)
        with _on(dev):
            _live_launch(statuses, spp, host=addr, sync=True)
        per[idx] = view[:len(idx)]
    return per, int(per.sum())


def compact_lanes(state: Union[LaneState, ShardedLanes],
                  order=None) -> LaneState:
    """Pack live lanes to the front: every plane gathered in the stable
    "running first" order (K13, then K14), or in ``order`` (any length,
    with JAX's index rule). Returns the global batch, on the device of
    ``state``'s global batch."""
    src = _lanes_of(state)
    with _on(src.device):
        if order is None:
            order = lane_order(src.status, 1)
        else:
            order = torch.as_tensor(order).to(device=src.device,
                                              dtype=torch.int32)
        return lane_gather(src, order)


def steal_balance(state: Union[LaneState, ShardedLanes],
                  mesh: Mesh) -> ShardedLanes:
    """Work-stealing rebalance: sort lanes by liveness (stable) and deal
    them round-robin across the shards so every shard holds an equal
    share of running lanes (K13 with the deal, K14), then reshard."""
    src = _lanes_of(state)
    _per_shard(src.pc.shape[0], mesh.size)
    with _on(src.device):
        dealt = lane_gather(src, lane_order(src.status, mesh.size))
    return shard_lanes(dealt, mesh)


# ---------------------------------------------------------------------------
# the plain versions
# ---------------------------------------------------------------------------

def lane_live_plain(status: torch.Tensor, n_dev: int) -> torch.Tensor:
    """(n_dev,) int32: RUNNING lanes in each of n_dev equal shards."""
    return (status.reshape(n_dev, -1) == Status.RUNNING).sum(
        dim=1, dtype=torch.int32)


def lane_order_plain(status: torch.Tensor, n_dev: int) -> torch.Tensor:
    """(N,) int32: the lanes in stable "running first" order, dealt over
    n_dev shards (sorted lane ``s * n_dev + d`` to position
    ``d * (N / n_dev) + s``)."""
    n = status.shape[0]
    run = (status == Status.RUNNING).to(torch.int64)
    before = torch.cumsum(run, 0) - run
    idx = torch.arange(n, device=status.device)
    q = torch.where(run.bool(), before, run.sum() + idx - before)
    per = n // n_dev
    out = torch.empty(n, dtype=torch.int32, device=status.device)
    out[(q % n_dev) * per + q // n_dev] = idx.to(torch.int32)
    return out


def source_rows(order: torch.Tensor, n_src: int) -> torch.Tensor:
    """JAX's gather index rule: a negative index wraps once, then an
    index out of range clamps to ``[0, n_src)``."""
    o = order.to(torch.int64)
    return torch.where(o < 0, o + n_src, o).clamp(0, n_src - 1)


def lane_gather_plain(state: LaneState, order: torch.Tensor) -> LaneState:
    """Every plane's rows ``order`` (JAX's index rule): a new batch of
    ``len(order)`` lanes."""
    rows = source_rows(order, state.pc.shape[0])
    return LaneState(**{f: getattr(state, f)[rows] for f in LANE_FIELDS})


# ---------------------------------------------------------------------------
# the kernels (csrc/mesh.cu)
# ---------------------------------------------------------------------------

#: K14's output layout (csrc/mesh.cu ``GatherLayout``): the planes' row
#: bytes and offsets in the one output allocation
MAX_PLANES = 32
#: each output plane starts at a multiple of this many bytes
PLANE_ALIGN = 16


class GatherLayout(ctypes.Structure):
    _fields_ = [("n_planes", ctypes.c_int), ("n_out", ctypes.c_longlong),
                ("row", ctypes.c_longlong * MAX_PLANES),
                ("offset", ctypes.c_longlong * MAX_PLANES)]


class _GatherPlan:
    """K14's output for a batch shape and an order length: the C layout
    and each plane's view of the one allocation (dtype, shape, strides,
    offset in elements)."""

    def __init__(self, planes, n_out: int):
        if len(planes) > MAX_PLANES:
            raise ValueError(f"{len(planes)} planes, at most {MAX_PLANES}")
        self.layout = GatherLayout(n_planes=len(planes), n_out=n_out)
        self.views = []
        off = 0
        for k, x in enumerate(planes):
            shape = (n_out,) + tuple(x.shape[1:])
            row = x.element_size() * math.prod(shape[1:])
            strides = tuple(math.prod(shape[i + 1:])
                            for i in range(len(shape)))
            self.layout.row[k] = row
            self.layout.offset[k] = off
            self.views.append((x.dtype, shape, strides,
                               off // x.element_size()))
            off += -(-row * n_out // PLANE_ALIGN) * PLANE_ALIGN
        self.nbytes = max(off, PLANE_ALIGN)

    def outputs(self, device):
        """(the one allocation, each plane's view of it)."""
        buf = torch.empty(self.nbytes, dtype=torch.uint8, device=device)
        by_type = {torch.uint8: buf, torch.int32: buf.view(torch.int32)}
        return buf, [by_type[dt].as_strided(shape, strides, off)
                     for dt, shape, strides, off in self.views]


_PLANS = {}


def gather_outputs(state: LaneState, n_out: int):
    """The planes of a ``n_out``-lane batch shaped as ``state``'s, as
    views of one allocation (each at a 16-byte-aligned offset, none
    overlapping): (the allocation, a ``LaneState`` of the views). K14
    writes them; its layout is cached by the batch's shape."""
    planes = [getattr(state, f) for f in LANE_FIELDS]
    key = (n_out,) + tuple((x.dtype, x.shape[1:]) for x in planes)
    plan = _PLANS.get(key)
    if plan is None:
        if len(_PLANS) >= 64:
            _PLANS.clear()
        plan = _PLANS[key] = _GatherPlan(planes, n_out)
    buf, views = plan.outputs(state.device)
    return buf, LaneState(*views), plan


_SIGS = {
    "lane_live": [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                  ctypes.c_longlong] + [ctypes.c_int] * 3
    + [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_void_p],
    "lane_live_blocks": [ctypes.c_int],
    "live_host_alloc": [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p],
    "empty_launch": [ctypes.c_void_p],
    "lane_order": [ctypes.c_void_p, ctypes.c_longlong] + [ctypes.c_int] * 4
    + [ctypes.c_void_p] * 3,
    "lane_order_blocks": [],
    "lane_gather": [ctypes.POINTER(GatherLayout), ctypes.c_void_p,
                    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                    ctypes.c_void_p],
}

#: K13 (csrc/mesh.cu ``k_order``): lanes a thread holds in a tile (four
#: 16-byte loads of the status plane) and the threads of a block
ORDER_VEC = 16
ORDER_THREADS = 256
def lane_order_shape(n: int, resident: int):
    """K13's cooperative launch for ``n`` lanes: (blocks, tiles). A tile
    is ``ORDER_VEC`` lanes a thread of ``ORDER_THREADS``; block ``b``
    takes tiles ``[b * tiles, (b + 1) * tiles)``, a tile a block where
    the ``resident`` blocks (the card's blocks resident at once, which a
    cooperative launch needs) suffice; one block up to 4096 lanes."""
    tiles = max(1, -(-n // (ORDER_VEC * ORDER_THREADS)))
    each = -(-tiles // max(1, resident))
    return -(-tiles // each), each


def order_tile_lanes(shape, block: int, tile: int):
    """The first lane of each thread of block ``block`` in its tile
    ``tile`` (``k_order``'s indexing): thread t holds the ``ORDER_VEC``
    lanes from ``((block * tiles + tile) * ORDER_THREADS + t) *
    ORDER_VEC``."""
    _, tiles = shape
    return [((block * tiles + tile) * ORDER_THREADS + t) * ORDER_VEC
            for t in range(ORDER_THREADS)]


def lane_order_tiled(status: torch.Tensor, n_dev: int, shape) -> torch.Tensor:
    """K13's arithmetic in plain PyTorch, block by block and tile by tile
    as ``k_order`` walks them (``order_tile_lanes``): each block's offset
    is the running lanes of the blocks before it, a thread's the running
    lanes of the threads before it in its tile; equal to
    ``lane_order_plain`` wherever the shape covers the lanes."""
    n = status.shape[0]
    blocks, tiles = shape
    run = (status == Status.RUNNING).tolist() + [False] * ORDER_VEC
    lanes = [order_tile_lanes(shape, b, k) for b in range(blocks)
             for k in range(tiles)]
    counts = [[sum(run[i:min(i + ORDER_VEC, n)]) if i < n else 0
               for i in tile] for tile in lanes]
    sums = [sum(sum(c) for c in counts[b * tiles:(b + 1) * tiles])
            for b in range(blocks)]
    total = sum(sums)
    out = torch.full((n,), -1, dtype=torch.int32)
    per = n // n_dev
    for b in range(blocks):
        carry = sum(sums[:b])
        for k in range(tiles):
            tile, count = lanes[b * tiles + k], counts[b * tiles + k]
            for t, i in enumerate(tile):
                before = carry + sum(count[:t])
                for j in range(i, min(i + ORDER_VEC, n)):
                    q = before if run[j] else total + (j - before)
                    before += run[j]
                    out[(q % n_dev) * per + q // n_dev] = j
            carry += sum(count)
    return out


#: K12 (csrc/mesh.cu ``k_lane_live``): the lanes of a warp's tile (16 a
#: thread, from four 16-byte loads), the threads of a block of the grid
#: sized to the card, the most a block a shard takes (8 shards of 32768
#: lanes, 256 threads each, ran faster so than on the grid; 8 of 131072
#: lanes, 1024 threads each, slower: PERF.md), and the status arrays one
#: launch takes
LIVE_TILE = 32 * ORDER_VEC
LIVE_THREADS = 64
LIVE_SHARD_THREADS = 256
MAX_LIVE_ARRAYS = 64


def lane_live_threads(per: int) -> int:
    """K12's block for shards of ``per`` lanes: a warp a ``LIVE_TILE``
    lanes of a shard, where a shard is a whole number of tiles of at
    most ``LIVE_SHARD_THREADS`` threads (a block's chunk is then one
    shard, whose sum the block writes with no atomic), else
    ``LIVE_THREADS``."""
    tiles, rest = divmod(per, LIVE_TILE)
    if not rest and 0 < tiles * 32 <= LIVE_SHARD_THREADS:
        return tiles * 32
    return LIVE_THREADS


def lane_live_shape(n_tiles: int, threads: int, resident: int) -> int:
    """K12's grid for ``n_tiles`` warp tiles (``LIVE_TILE`` lanes) on
    blocks of ``threads``: a tile a warp, no more blocks than
    ``resident`` (the card's blocks of that size resident at once; each
    block then takes several chunks), and at least one (a launch of no
    lanes writes zeros)."""
    return max(1, min(resident, -(-n_tiles // (threads // 32))))


def lane_live_tiled(statuses, spp: int, blocks: int, threads: int):
    """K12's arithmetic in plain Python, block by block as
    ``k_lane_live`` walks the warp tiles of ``statuses`` (arrays of
    ``spp`` shards of equal lanes, mesh order) on a grid of ``blocks``
    blocks of ``threads``: thread t of a warp holds the lanes 4 t + 128 k
    + r (k, r < 4) of its tile; each block's chunk (a tile a warp) sums,
    for each shard it holds lanes of, their running lanes; a shard in
    one chunk is written at once, the others when the sum that brings
    them to their count of chunks (from the geometry alone) arrives.
    Returns (the totals so written, shard ``j * spp + k`` for shard k of
    array j, None where none was; for each array the shard each lane was
    counted in, -1 for none; for each array how many times each lane was
    counted)."""
    per = statuses[0].shape[0] // spp
    lanes = per * spp
    tiles = -(-lanes // LIVE_TILE)
    total = tiles * len(statuses)
    warps = threads // 32
    run = [(x == Status.RUNNING).tolist() for x in statuses]
    shards = len(statuses) * spp
    sums, adds, done = [0] * shards, [0] * shards, [None] * shards
    owner = [[-1] * lanes for _ in statuses]
    seen = [[0] * lanes for _ in statuses]
    if lanes == 0:
        return [0] * shards, owner, seen

    def shard_of(g, lane):
        arr = g // tiles
        return arr * spp + ((g % tiles) * LIVE_TILE + lane) // per

    def chunks_of(k):
        j, q = divmod(k, spp)
        t0 = j * tiles + q * per // LIVE_TILE
        t1 = j * tiles + ((q + 1) * per - 1) // LIVE_TILE
        return t1 // warps - t0 // warps + 1

    for b in range(blocks):
        for c0 in range(b * warps, total, blocks * warps):
            c1 = min(c0 + warps, total) - 1
            k0 = shard_of(c0, 0)
            k1 = shard_of(c1, min(LIVE_TILE, lanes - (c1 % tiles)
                                  * LIVE_TILE) - 1)
            for k in range(k0, k1 + 1):
                c = 0
                for g in range(c0, c1 + 1):
                    arr, start = g // tiles, (g % tiles) * LIVE_TILE
                    for t in range(32):
                        for j in range(16):
                            i = start + 4 * t + 128 * (j // 4) + j % 4
                            if i < lanes and shard_of(g, i - start) == k:
                                c += run[arr][i]
                                owner[arr][i] = k
                                seen[arr][i] += 1
                sums[k] += c
                adds[k] += 1
                if adds[k] == chunks_of(k):
                    done[k] = sums[k]
    return done, owner, seen


def _lib():
    from .. import _build

    return _build.lib("mesh.cu", _SIGS)


def lane_live(status: torch.Tensor, n_dev: int) -> torch.Tensor:
    """RUNNING lanes in each of ``n_dev`` equal shards of ``status``, a
    tensor on its device: K12 on a CUDA ``status`` (one launch), the
    plain version on a CPU one."""
    _per_shard(status.shape[0], n_dev)
    if status.device.type == "cpu":
        return lane_live_plain(status, n_dev)
    out = torch.empty(n_dev, dtype=torch.int32, device=status.device)
    _live_launch((status,), n_dev, out=out)
    return out


#: K12's launch arguments by (the status arrays' devices, addresses,
#: shapes, strides and types, shards an array, stream): the pointer
#: array, counters (zero between launches, which leave them so), block,
#: grid and alignment, checked once; its blocks resident at once by
#: (device, block); its mapped host buffers by shard count
_LIVE_PLANS = {}
_LIVE_RESIDENT = {}
_LIVE_HOST = {}


def _live_host(n: int):
    """K12's host buffer for ``n`` counts, made once: pinned host memory
    mapped into every card's address space, (an int32 numpy view of it,
    its device address)."""
    if n not in _LIVE_HOST:
        from .. import _build

        lib = _lib()
        host, dev = ctypes.c_void_p(), ctypes.c_void_p()
        _build.check(lib, lib.live_host_alloc(n, ctypes.byref(host),
                                              ctypes.byref(dev)),
                     "live_host_alloc")
        view = np.ctypeslib.as_array(
            (ctypes.c_int32 * max(n, 1)).from_address(host.value))
        _LIVE_HOST[n] = (view, dev.value)
    return _LIVE_HOST[n]


def _live_plan(statuses, spp: int, stream):
    """K12's launch arguments for ``statuses`` (contiguous CUDA int32
    status arrays of one device, mesh order, each of ``spp`` shards of
    equal lanes) on ``stream``, checked and made at the first launch:
    (arrays, the pointer array, lanes a shard, blocks, threads, vec,
    counters)."""
    from .. import _build

    key = (tuple((x.get_device(), x.data_ptr(), x.shape, x.stride(),
                  x.dtype) for x in statuses), spp, stream.value)
    plan = _LIVE_PLANS.get(key)
    if plan is not None:
        return plan
    dev, n = statuses[0].device, statuses[0].shape[0]
    if len(statuses) > MAX_LIVE_ARRAYS:
        raise ValueError(f"lane_live: {len(statuses)} shard arrays on "
                         f"{dev}, at most {MAX_LIVE_ARRAYS}")
    for x in statuses:
        _build.need_cuda(x, torch.int32, "status")
        if x.device != dev or x.shape != (n,):
            raise ValueError(f"lane_live: status arrays of {n} lanes on "
                             f"{dev}, got {tuple(x.shape)} on {x.device}")
    threads = lane_live_threads(n // spp)
    if (dev.index, threads) not in _LIVE_RESIDENT:
        with torch.cuda.device(dev):
            _LIVE_RESIDENT[dev.index, threads] = _lib().lane_live_blocks(
                threads)
    if len(_LIVE_PLANS) >= 256:
        _LIVE_PLANS.clear()
    plan = _LIVE_PLANS[key] = (
        len(statuses), _build.ptr_array(statuses), n // spp,
        lane_live_shape(-(-n // LIVE_TILE) * len(statuses), threads,
                        _LIVE_RESIDENT[dev.index, threads]), threads,
        int(all(x.data_ptr() % 16 == 0 for x in statuses)),
        torch.zeros(len(statuses) * spp, dtype=torch.int64, device=dev))
    return plan


def _live_launch(statuses, spp: int, out=None, host=None,
                 sync: bool = False) -> None:
    """One K12 launch over ``statuses`` (``_live_plan``) on the current
    stream of their device: the counts into ``out`` (a CUDA int32 tensor
    of a count a shard) and into the mapped host buffer at the device
    address ``host``, where given; ``sync``: the call returns when the
    launch has run."""
    from .. import _build

    stream = _build.stream(statuses[0].device)
    arrays, ptrs, per, blocks, threads, vec, counters = _live_plan(
        statuses, spp, stream)
    if out is not None and (out.dtype != torch.int32 or not out.is_cuda
                            or out.numel() < arrays * spp):
        raise ValueError(f"lane_live: out must be a CUDA int32 tensor of "
                         f"{arrays * spp} counts")
    lib = _lib()
    rc = lib.lane_live(ptrs, arrays, spp, per, blocks, threads, vec,
                       counters.data_ptr(),
                       None if out is None else out.data_ptr(), host,
                       int(sync), stream)
    _build.LAUNCHES["lane_live"] += 1
    _build.check(lib, rc, "lane_live")


def empty_launch(device) -> None:
    """An empty kernel of one thread on ``device``'s current stream: the
    launch floor K12 is timed against."""
    from .. import _build

    lib = _lib()
    _build.check(lib, lib.empty_launch(_build.stream(torch.device(device))),
                 "empty_launch")


_ORDER_RESIDENT = {}


def lane_order(status: torch.Tensor, n_dev: int) -> torch.Tensor:
    """The stable "running first" order dealt over ``n_dev`` shards: K13
    on a CUDA ``status`` (one cooperative launch, ``lane_order_shape``;
    its blocks' sums in the output allocation's tail), the plain version
    on a CPU one."""
    n = status.shape[0]
    _per_shard(n, n_dev)
    if status.device.type == "cpu":
        return lane_order_plain(status, n_dev)
    from .. import _build

    _build.need_cuda(status, torch.int32, "status")
    lib = _lib()
    dev = status.device.index if status.device.index is not None \
        else torch.cuda.current_device()
    if dev not in _ORDER_RESIDENT:
        with torch.cuda.device(dev):
            _ORDER_RESIDENT[dev] = lib.lane_order_blocks()
    blocks, tiles = lane_order_shape(n, _ORDER_RESIDENT[dev])
    buf = torch.empty(n + blocks, dtype=torch.int32, device=status.device)
    out = buf[:n]
    if n == 0:
        return out
    rc = lib.lane_order(_build.ptr(status), n, n_dev, blocks, tiles,
                        int(status.data_ptr() % 16 == 0),
                        ctypes.c_void_p(buf.data_ptr() + 4 * n),
                        _build.ptr(out), _build.stream(status.device))
    _build.LAUNCHES["lane_order"] += 1
    _build.check(lib, rc, "lane_order")
    return out


#: each plane's dtype in a batch K14 takes
_PLANE_TYPES = tuple(torch.uint8 if f in stepper.LANE_U8 else torch.int32
                     for f in LANE_FIELDS)


def _check_batch(planes) -> None:
    """The batch as a whole: every plane a contiguous CUDA tensor of its
    type on one device, and as many lanes in each."""
    dev, n = planes[0].device, planes[0].shape[0]
    if dev.type != "cuda":
        raise ValueError(f"lane_gather: expected CUDA planes, got {dev}")
    bad = [f for f, x, t in zip(LANE_FIELDS, planes, _PLANE_TYPES)
           if x.device != dev or x.dtype != t or not x.is_contiguous()
           or x.shape[0] != n]
    if bad:
        raise ValueError(f"lane_gather: planes {bad} are not contiguous "
                         f"{n}-lane tensors of their type on {dev}")


def lane_gather(state: LaneState, order: torch.Tensor) -> LaneState:
    """A new batch of ``len(order)`` lanes, every plane's rows gathered
    through ``order`` with JAX's index rule: K14 on a CUDA batch, the
    plain version on a CPU one. On the card the output planes are views
    of one allocation (``gather_outputs``)."""
    if state.device.type == "cpu":
        return lane_gather_plain(state, order)
    from .. import _build

    planes = [getattr(state, f) for f in LANE_FIELDS]
    _check_batch(planes)
    _build.need_cuda(order, torch.int32, "order")
    n_src, n_out = planes[0].shape[0], order.shape[0]
    if n_src == 0 and n_out:
        raise IndexError(f"lane_gather: {n_out} rows of a batch of 0 lanes")
    buf, out, plan = gather_outputs(state, n_out)
    if n_out == 0:
        return out
    lib = _lib()
    rc = lib.lane_gather(
        ctypes.byref(plan.layout),
        (ctypes.c_void_p * len(planes))(*[x.data_ptr() for x in planes]),
        buf.data_ptr(), order.data_ptr(), n_src,
        _build.stream(state.device))
    _build.LAUNCHES["lane_gather"] += 1
    _build.check(lib, rc, "lane_gather")
    return out


# ---------------------------------------------------------------------------
# a symbolic lane batch over a mesh (the meshed lane engine)
# ---------------------------------------------------------------------------

@dataclass
class SymShards:
    """A symbolic batch (``ops/symstep.SymLaneState``) of ``n`` lanes
    placed over ``mesh``, as the JAX engine places its lane planes over
    the ``lanes`` axis: ``shards[i]`` holds lanes ``[i * per, (i + 1) *
    per)`` on ``mesh.devices[i]``, an allocation of its own also where
    a device repeats (so one exchange serves shards of one card and
    distinct cards alike). ``home``, on ``mesh.devices[0]``, is a batch
    of ``n`` lanes whose row planes are one slot wide: its fork log,
    free-slot stack and step counters are the batch's, and the window's
    cross-lane phases gather into its small per-lane planes and record
    planes what they read (``laser/lane_engine.window_exec_mesh``); the
    shards' own copies of those global planes are unused. A card's
    shards are written in place for the batch's life, never rebound, so
    ``plan`` (the meshed kernels' table of their planes a device,
    ``lane_engine._BatchPlan``: K3's remap and K4's rows) is made at its
    first use and kept."""

    mesh: Mesh
    shards: list
    home: object
    plan: object = field(default=None, repr=False, compare=False)

    @property
    def n(self) -> int:
        return self.home.pc.shape[0]

    @property
    def per(self) -> int:
        return self.shards[0].pc.shape[0]

    @property
    def device(self) -> torch.device:
        return self.mesh.devices[0]

    def owner(self, lanes):
        """(shard, local lane) of global lanes (numpy)."""
        lanes = np.asarray(lanes, np.int64)
        return lanes // self.per, lanes % self.per

    def lanes(self):
        """The global batch on the home device (a copy): every lane
        plane the shards' in order, the batch's global planes home's."""
        from ..ops import symstep

        planes = {}
        for f in symstep.FIELDS:
            if f in symstep.NO_COPY:
                planes[f] = getattr(self.home, f).clone()
            else:
                planes[f] = torch.cat([getattr(s, f).to(self.device)
                                       for s in self.shards])
        return symstep.SymLaneState(**planes)


#: the per-lane planes the window's cross-lane phases read at home: the
#: selections' and counters' (K4) and the records' (K3, K4's unique
#: table)
HOME_PLANES = ("pc", "sp", "msize", "mlog_count", "scount", "status",
               "steps", "dlog_count", "group", "dlog_op", "dlog_pc",
               "dlog_step", "dlog_fentry", "dlog_sid", "dlog_val")


def shard_sym_lanes(mesh: Mesh, n: int, gas_limit: int = 8_000_000,
                    **lane_kwargs) -> SymShards:
    """A fresh ``SymShards`` of ``n`` lanes (every lane DEAD, every slot
    on the batch's free stack) over ``mesh``: each shard made on its
    device as ``init_sym_lanes`` makes a batch (kernel K0 on a card),
    the home batch likewise with its row planes one slot wide (what K4
    gathers of them there is never read: each row comes from its
    shard). Raises where ``n`` does not divide over the mesh."""
    from ..ops import symstep

    per = _per_shard(n, mesh.size)
    shards = []
    for dev in mesh.devices:
        with _on(dev):
            shards.append(symstep.init_sym_lanes(
                per, device=dev, gas_limit=gas_limit, **lane_kwargs))
    narrow = dict(stack_depth=1, memory_bytes=16, mem_records=1,
                  storage_slots=1, calldata_bytes=16)
    kw = {**lane_kwargs, **narrow}
    with _on(mesh.devices[0]):
        home = symstep.init_sym_lanes(n, device=mesh.devices[0],
                                      gas_limit=gas_limit, **kw)
    return SymShards(mesh, shards, home)


def gather_home(ss: SymShards, names=HOME_PLANES) -> None:
    """Copy the shards' ``names`` planes into the home batch's, shard
    ``i`` into lanes ``[i * per, (i + 1) * per)``: a device copy, a peer
    copy from another card."""
    per = ss.per
    for f in names:
        dst = getattr(ss.home, f)
        for i, st in enumerate(ss.shards):
            dst[i * per:(i + 1) * per].copy_(getattr(st, f))


def scatter_home(ss: SymShards, names) -> None:
    """The inverse of ``gather_home``: the home batch's ``names`` planes
    back into the shards'."""
    per = ss.per
    for f in names:
        src = getattr(ss.home, f)
        for i, st in enumerate(ss.shards):
            getattr(st, f).copy_(src[i * per:(i + 1) * per])
