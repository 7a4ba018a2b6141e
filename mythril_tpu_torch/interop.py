"""Carry lane state, compiled code and screen encodings between the JAX
package and the port, as numpy.

A JAX ``SymLaneState`` or concrete ``LaneState`` reaches here as
``{field: numpy array}`` (the caller takes ``np.asarray`` of each plane)
and a ``CompiledCode`` as its ``packed`` array and ``size``; nothing
here imports JAX. uint32 planes
travel as their bit patterns (the port's int32 tensors), so a round trip
is exact. The tests feed both packages the same inputs through these.
"""

import numpy as np
import torch

from .ops.intervals import EncodedDAG
from .ops.propagate import Plan
from .ops.stepper import (
    LANE_FIELDS, LANE_U8, LANE_U32, CompiledCode, LaneState,
)
from .ops.symstep import FIELDS, U8_FIELDS, U32_FIELDS, SymLaneState
from .support.devices import resolve

#: state class -> (its fields, uint8 planes, uint32 planes)
_LAYOUTS = {SymLaneState: (FIELDS, U8_FIELDS, U32_FIELDS),
            LaneState: (LANE_FIELDS, LANE_U8, LANE_U32)}


def state_from_numpy(planes: dict, device=None):
    """{field: numpy array} in the JAX dtypes -> the port's state on
    ``device``: a ``SymLaneState`` for the symbolic planes, a
    ``LaneState`` for the concrete stepper's 17."""
    dev = resolve(device)
    cls = LaneState if set(planes) == set(LANE_FIELDS) else SymLaneState
    fields_, u8_fields, u32_fields = _LAYOUTS[cls]
    out = {}
    for name in fields_:
        arr = np.array(planes[name])  # keeps 0-d scalars 0-d
        if name in u8_fields:
            arr = arr.astype(np.uint8)
        elif name in u32_fields:
            arr = arr.astype(np.uint32).view(np.int32)
        else:
            arr = arr.astype(np.int32)
        out[name] = torch.from_numpy(np.ascontiguousarray(arr)
                                     .reshape(arr.shape)).to(dev)
    return cls(**out)


def state_to_numpy(st) -> dict:
    """The port's state (symbolic or concrete) -> {field: numpy array}
    in the JAX dtypes (uint32 planes as uint32)."""
    fields_, _, u32_fields = _LAYOUTS[type(st)]
    out = {}
    for name in fields_:
        arr = getattr(st, name).detach().cpu().numpy()
        out[name] = arr.view(np.uint32) if name in u32_fields else arr
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


_ENC_ARRAYS = ("init_lo", "init_hi", "seed_idx", "seed_lo", "seed_hi",
               "dead", "assert_idx", "assert_mask")


def _numpy_tree(x):
    """Nested dicts/tuples/lists of array-likes -> the same of numpy
    arrays (tuples of op codes, ints and strings pass through)."""
    if isinstance(x, dict):
        return {k: _numpy_tree(v) for k, v in x.items()}
    if isinstance(x, (tuple, list)):
        if all(isinstance(v, (int, np.integer)) for v in x):
            return tuple(int(v) for v in x)
        return type(x)(_numpy_tree(v) for v in x)
    if isinstance(x, (int, str)):
        return x
    return np.array(x)


def encoded_from_numpy(fields: dict) -> EncodedDAG:
    """A JAX ``EncodedDAG``'s fields ({name: array}, ``levels`` as its
    list of level dicts, ``n_nodes``, ``n_real`` and optionally
    ``host``) -> the port's ``EncodedDAG`` holding the same numpy
    arrays."""
    f = _numpy_tree({k: v for k, v in fields.items() if k != "host"})
    return EncodedDAG(
        int(f["n_nodes"]), list(f["levels"]),
        *[f[k] for k in _ENC_ARRAYS], n_real=int(f["n_real"]),
        host=fields.get("host"))


def plan_from_numpy(arrays: dict, statics) -> Plan:
    """A JAX propagate ``Plan``'s arrays and statics -> the port's
    ``Plan`` holding the same numpy arrays."""
    return Plan(_numpy_tree(arrays), statics)
