"""CUDA device discovery for the port.

The counterpart of ``mythril_tpu/support/devices.py``: which device the
lane engine runs on, whether that device really executes (a launch
probe, not only enumeration), and how many lanes it should run by
default. There is no CPU fallback: a caller that wants the CPU asks for
it with ``device="cpu"`` (the tests do); otherwise a missing or broken
card raises.
"""

import torch

#: the lane width ``default_lanes`` gives on a usable card, as the JAX
#: package's ``default_tpu_lanes`` does on a local accelerator
DEFAULT_LANES = 64

#: share of the card's memory the lane planes may take (the rest holds
#: window scratch, outputs and PyTorch's own pool)
_STATE_SHARE = 0.5

_EXEC_OK = {}


def resolve(device=None) -> torch.device:
    """The torch device an entry point runs on: ``cuda`` unless the
    caller names another. A CUDA request without a usable card raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: pass device='cpu' to run the plain "
                "versions on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        if not device_exec_ok(dev):
            raise RuntimeError(f"{dev} enumerates but does not execute")
    return dev


def device_exec_ok(dev: torch.device) -> bool:
    """Probe the card with an executed launch, once per device:
    enumeration can succeed while execution is broken (a driver and
    runtime mismatch fails only at the first launch)."""
    key = str(dev)
    if key not in _EXEC_OK:
        try:
            x = torch.ones(1, dtype=torch.int32, device=dev) + 1
            torch.cuda.synchronize(dev)
            _EXEC_OK[key] = int(x.item()) == 2
        except RuntimeError:
            _EXEC_OK[key] = False
    return _EXEC_OK[key]


def default_lanes(lane_bytes: int, device=None) -> int:
    """Lane width of the ``auto`` setting: ``DEFAULT_LANES`` (what the
    JAX package's ``default_tpu_lanes`` gives on a local accelerator),
    cut to the widest power of two whose planes (``lane_bytes`` each,
    see ``ops.symstep.lane_bytes``) fit in ``_STATE_SHARE`` of the
    card's memory. Raises without a usable card."""
    dev = resolve(device)
    total = torch.cuda.get_device_properties(dev).total_memory
    cap = int(total * _STATE_SHARE) // max(int(lane_bytes), 1)
    lanes = DEFAULT_LANES
    while lanes > 1 and lanes > cap:
        lanes //= 2
    return lanes


def default_tpu_lanes() -> int:
    """Lane width of the ``auto`` ``tpu_lanes`` setting:
    ``DEFAULT_LANES``. Unlike the JAX package, a missing card does not
    turn the device screens off: the screen's first device call
    raises in ``resolve`` instead."""
    return DEFAULT_LANES


def effective_tpu_lanes() -> int:
    """``args.tpu_lanes`` with the auto sentinel (<0) resolved, and
    cached back onto the args so every later reader sees the same
    resolution."""
    from .support_args import args

    lanes = args.tpu_lanes
    if lanes is None or lanes < 0:
        lanes = default_tpu_lanes()
        args.tpu_lanes = lanes
    return lanes
