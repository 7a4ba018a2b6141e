"""Carry lane state and compiled code between the JAX package and the
port, as numpy.

A JAX ``SymLaneState`` reaches here as ``{field: numpy array}`` (the
caller takes ``np.asarray`` of each plane) and a ``CompiledCode`` as its
``packed`` array and ``size``; nothing here imports JAX. uint32 planes
travel as their bit patterns (the port's int32 tensors), so a round trip
is exact. The tests feed both packages the same inputs through these.
"""

import numpy as np
import torch

from .ops.stepper import CompiledCode
from .ops.symstep import FIELDS, U8_FIELDS, U32_FIELDS, SymLaneState
from .support.devices import resolve


def state_from_numpy(planes: dict, device=None) -> SymLaneState:
    """{field: numpy array} in the JAX dtypes -> the port's state on
    ``device``."""
    dev = resolve(device)
    out = {}
    for name in FIELDS:
        arr = np.array(planes[name])  # keeps 0-d scalars 0-d
        if name in U8_FIELDS:
            arr = arr.astype(np.uint8)
        elif name in U32_FIELDS:
            arr = arr.astype(np.uint32).view(np.int32)
        else:
            arr = arr.astype(np.int32)
        out[name] = torch.from_numpy(np.ascontiguousarray(arr)
                                     .reshape(arr.shape)).to(dev)
    return SymLaneState(**out)


def state_to_numpy(st: SymLaneState) -> dict:
    """The port's state -> {field: numpy array} in the JAX dtypes
    (uint32 planes as uint32)."""
    out = {}
    for name in FIELDS:
        arr = getattr(st, name).detach().cpu().numpy()
        out[name] = arr.view(np.uint32) if name in U32_FIELDS else arr
    return out


def code_from_numpy(packed, size: int, device=None) -> CompiledCode:
    """A JAX ``CompiledCode.packed`` (as numpy) and its ``size`` -> the
    port's ``CompiledCode`` on ``device``."""
    arr = np.ascontiguousarray(np.asarray(packed).astype(np.int32))
    return CompiledCode(packed=torch.from_numpy(arr).to(resolve(device)),
                        size=int(size))


def code_to_numpy(cc: CompiledCode):
    """(packed int32 numpy array, size)."""
    return cc.packed.detach().cpu().numpy(), cc.size
