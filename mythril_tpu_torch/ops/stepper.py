"""Host half of the EVM lane stepper: status codes, per-opcode tables,
compiled code, and the word helpers the symbolic stepper uses.

The counterpart of the host part of ``mythril_tpu/ops/stepper.py``
(``Status``, the ``NPOP/NPUSH/SUPPORTED/ENV/RESULT_CLASS`` tables,
``CompiledCode`` with its packed ``(L+1, 14)`` int32 plane, and
``compile_code``). The concrete ``step``/``run`` and the wave-packed
``compile_packed_code`` are not part of this slice.
"""

from dataclasses import dataclass

import numpy as np
import torch

from ..support.opcodes import ADDRESS, GAS, OPCODES
from . import bv256


class Status:
    RUNNING = 0
    STOPPED = 1
    RETURNED = 2
    REVERTED = 3
    INVALID = 4
    NEEDS_HOST = 5
    SELFDESTRUCT = 6


_OP = {name: data[ADDRESS] for name, data in OPCODES.items()}

ENV_SLOTS = {
    "ADDRESS": 0, "ORIGIN": 1, "CALLER": 2, "CALLVALUE": 3,
    "GASPRICE": 4, "COINBASE": 5, "TIMESTAMP": 6, "NUMBER": 7,
    "DIFFICULTY": 8, "GASLIMIT": 9, "CHAINID": 10, "SELFBALANCE": 11,
    "BASEFEE": 12,
}
N_ENV = len(ENV_SLOTS)

#: which computed word an opcode pushes; the order is the case order of
#: the result select in ops/symstep.sym_step and csrc/symstep.cu
RESULT_CLASSES = (
    "ZERO ADD MUL SUB DIV SDIV MOD SMOD ADDMOD MULMOD EXP SIGNEXTEND "
    "LT GT SLT SGT EQ ISZERO AND OR XOR NOT BYTE SHL SHR SAR MLOAD "
    "SLOAD PC MSIZE GAS CALLDATALOAD CALLDATASIZE CODESIZE ENV PUSH DUP"
).split()
RESULT_CLASS_ID = {name: i for i, name in enumerate(RESULT_CLASSES)}


def _build_tables():
    """Static (256,) per-opcode metadata tables."""
    npop = np.zeros(256, dtype=np.int32)
    npush = np.zeros(256, dtype=np.int32)
    static_gas = np.zeros(256, dtype=np.uint32)
    supported = np.zeros(256, dtype=bool)
    env_slot = np.full(256, -1, dtype=np.int32)
    result_class = np.zeros(256, dtype=np.int32)

    for name, data in OPCODES.items():
        static_gas[data[ADDRESS]] = data[GAS][0]

    def sup(name, pops, pushes):
        byte = _OP[name]
        supported[byte] = True
        npop[byte] = pops
        npush[byte] = pushes
        if name in RESULT_CLASS_ID:
            result_class[byte] = RESULT_CLASS_ID[name]

    for name in (
        "ADD MUL SUB DIV SDIV MOD SMOD EXP SIGNEXTEND LT GT SLT SGT EQ "
        "AND OR XOR BYTE SHL SHR SAR"
    ).split():
        sup(name, 2, 1)
    for name in ("ISZERO", "NOT"):
        sup(name, 1, 1)
    for name in ("ADDMOD", "MULMOD"):
        sup(name, 3, 1)
    sup("STOP", 0, 0)
    sup("POP", 1, 0)
    # SHA3 and BALANCE run only on the symbolic stepper, which needs
    # their stack effect
    npop[_OP["SHA3"]] = 2
    npush[_OP["SHA3"]] = 1
    npop[_OP["BALANCE"]] = 1
    npush[_OP["BALANCE"]] = 1
    sup("MLOAD", 1, 1)
    sup("MSTORE", 2, 0)
    sup("MSTORE8", 2, 0)
    sup("SLOAD", 1, 1)
    sup("SSTORE", 2, 0)
    sup("JUMP", 1, 0)
    sup("JUMPI", 2, 0)
    sup("JUMPDEST", 0, 0)
    sup("PC", 0, 1)
    sup("MSIZE", 0, 1)
    sup("GAS", 0, 1)
    sup("CALLDATALOAD", 1, 1)
    sup("CALLDATASIZE", 0, 1)
    sup("CODESIZE", 0, 1)
    sup("RETURN", 2, 0)
    sup("REVERT", 2, 0)
    sup("INVALID", 0, 0)
    sup("SELFDESTRUCT", 1, 0)
    for name, slot in ENV_SLOTS.items():
        sup(name, 0, 1)
        env_slot[_OP[name]] = slot
        result_class[_OP[name]] = RESULT_CLASS_ID["ENV"]
    for i in range(1, 33):
        b = 0x5F + i
        supported[b] = True
        npush[b] = 1
        result_class[b] = RESULT_CLASS_ID["PUSH"]
    for i in range(1, 17):
        b = 0x7F + i
        supported[b] = True
        npush[b] = 1
        result_class[b] = RESULT_CLASS_ID["DUP"]
    for i in range(1, 17):
        supported[0x8F + i] = True
    return npop, npush, static_gas, supported, env_slot, result_class


(NPOP_TABLE, NPUSH_TABLE, GAS_TABLE, SUPPORTED_TABLE, ENV_TABLE,
 RESULT_CLASS_TABLE) = _build_tables()


# ---------------------------------------------------------------------------
# compiled code
# ---------------------------------------------------------------------------

@dataclass
class CompiledCode:
    """Per-pc planes of one contract, packed into ONE ``(L+1, 14)`` int32
    tensor with the column layout of the JAX package: opcode, next_pc,
    is_jumpdest, is_func_entry, 8 PUSH-immediate limbs, det_mask,
    loopsum_park. ``size`` is the real code length."""

    packed: torch.Tensor
    size: int

    @property
    def opcode(self):
        return self.packed[:, 0]

    @property
    def next_pc(self):
        return self.packed[:, 1]

    @property
    def is_jumpdest(self):
        return self.packed[:, 2] != 0

    @property
    def is_func_entry(self):
        return self.packed[:, 3] != 0

    @property
    def push_value(self):  # (L+1, 8) limb bit patterns
        return self.packed[:, 4:4 + bv256.NLIMBS]

    @property
    def det_mask(self):  # (L+1,) uint32 bit patterns
        return self.packed[:, 12]

    @property
    def loopsum_park(self):
        return self.packed[:, 13] != 0


#: padded code lengths (the JAX package pads to share compiled
#: programs; the port keeps the same padding so planes compare equal)
_CODE_BUCKETS = (4096, 16384, 65536)


def _code_bucket(length: int) -> int:
    for b in _CODE_BUCKETS:
        if length <= b:
            return b
    return length


def pack_code(code: bytes, func_entries=(), det_mask=None,
              loopsum_pcs=None) -> np.ndarray:
    """The packed ``(L+1, 14)`` int32 code plane, as numpy."""
    length = len(code)
    padded = _code_bucket(length)
    opcode = np.full(padded + 1, _OP["STOP"], dtype=np.int32)
    push_value = np.zeros((padded + 1, bv256.NLIMBS), dtype=np.uint32)
    next_pc = np.arange(1, padded + 2, dtype=np.int32)
    is_jumpdest = np.zeros(padded + 1, dtype=np.int32)
    is_func_entry = np.zeros(padded + 1, dtype=np.int32)
    mask_col = np.zeros(padded + 1, dtype=np.uint32)
    loopsum_col = np.zeros(padded + 1, dtype=np.int32)
    for addr in func_entries:
        if 0 <= addr <= length:
            is_func_entry[addr] = 1
    i = 0
    while i < length:
        op = code[i]
        opcode[i] = op
        if 0x60 <= op <= 0x7F:
            n = op - 0x5F
            push_value[i] = bv256.int_to_limbs(
                int.from_bytes(code[i + 1:i + 1 + n], "big"))
            next_pc[i] = i + 1 + n
        elif op == _OP["JUMPDEST"]:
            is_jumpdest[i] = 1
        i = next_pc[i]
    if det_mask is not None:
        n = min(len(det_mask), length + 1)
        mask_col[:n] = np.asarray(det_mask[:n], dtype=np.uint32)
    if loopsum_pcs is not None:
        n = min(len(loopsum_pcs), length + 1)
        loopsum_col[:n] = np.asarray(loopsum_pcs[:n], dtype=bool)
    return np.concatenate([
        opcode[:, None], next_pc[:, None], is_jumpdest[:, None],
        is_func_entry[:, None], push_value.view(np.int32),
        mask_col[:, None].view(np.int32), loopsum_col[:, None],
    ], axis=1)


def compile_code(code: bytes, func_entries=(), det_mask=None,
                 loopsum_pcs=None, device=None) -> CompiledCode:
    """Compile bytecode to per-pc planes on ``device`` (``cuda`` unless
    the caller names another). ``func_entries``: byte addresses of
    function entry points; ``det_mask``/``loopsum_pcs``: the optional
    static-pass columns (zeros when absent)."""
    from ..support.devices import resolve

    packed = pack_code(code, func_entries, det_mask, loopsum_pcs)
    return CompiledCode(packed=torch.from_numpy(packed).to(resolve(device)),
                        size=len(code))


# ---------------------------------------------------------------------------
# word helpers (words in the int64 arithmetic form of ops/bv256)
# ---------------------------------------------------------------------------

def _lanes(x):
    return torch.arange(x.shape[0], device=x.device)


def _onehot_gather(arr, idx):
    """arr[lane, idx[lane]] (idx already in range)."""
    return arr[_lanes(arr), idx.long()]


def _peek(stack, sp, k):
    """Word at stack position sp-k, clip-guarded (the caller masks)."""
    return _onehot_gather(stack, (sp - k).clamp(0, stack.shape[1] - 1))


def _scatter_word(plane, lane_mask, idx, value):
    """plane[lane, idx[lane]] = value[lane] where lane_mask, on a copy."""
    out = plane.clone()
    lanes = _lanes(plane)[lane_mask]
    out[lanes, idx.long()[lane_mask]] = value[lane_mask].to(plane.dtype)
    return out


def _u32_of(word):
    """Low 32 bits, and whether the word exceeds 32 bits."""
    return word[..., 0], (word[..., 1:] != 0).any(dim=-1)


def word_to_bytes_be(w):
    """(..., 8) limbs -> (..., 32) uint8 big-endian bytes."""
    sh = torch.tensor([24, 16, 8, 0], device=w.device)
    parts = (w.flip(-1)[..., :, None] >> sh) & 0xFF
    return parts.reshape(w.shape[:-1] + (32,)).to(torch.uint8)


def bytes_be_to_word(b):
    """(..., 32) big-endian bytes -> (..., 8) limbs (int64 form)."""
    b = b.to(torch.int64).reshape(b.shape[:-1] + (bv256.NLIMBS, 4))
    limbs = (b[..., 0] << 24) | (b[..., 1] << 16) | (b[..., 2] << 8) \
        | b[..., 3]
    return limbs.flip(-1)
