"""Native precompiled contracts 1-9 (capability parity:
mythril/laser/ethereum/natives.py:75-282).

All precompiles operate on concrete byte lists; symbolic input raises
NativeContractException and the caller substitutes fresh symbolic output
bytes (reference call.py:238-249). Crypto backends are this build's own
pure-Python implementations (mythril_tpu_torch/utils/crypto.py) instead of the
coincurve/py_ecc/blake2b wheels, including an exact bn128 ecPairing
(own Fq2/Fq12 tower + optimal-ate Miller loop)."""

import hashlib
import logging
from typing import List, Union

from ..support.support_utils import sha3, zpad
from ..utils import crypto
from .state.calldata import BaseCalldata, ConcreteCalldata
from .util import extract32, extract_copy

log = logging.getLogger(__name__)


class NativeContractException(Exception):
    """An error (usually symbolic input) during a native call."""


def int_to_32bytes(i: int) -> bytes:
    return i.to_bytes(32, byteorder="big")


def ecrecover(data: List[int]) -> List[int]:
    try:
        bytes_data = bytearray(data)
        v = extract32(bytes_data, 32)
        r = extract32(bytes_data, 64)
        s = extract32(bytes_data, 96)
    except TypeError:
        raise NativeContractException

    message = bytes(bytes_data[0:32])
    if r >= crypto.N or s >= crypto.N or v < 27 or v > 28:
        return []
    try:
        result = crypto.secp256k1_recover(message, v, r, s)
    except Exception as e:
        log.debug("Error in ecrecover: %s", e)
        return []
    if result is None:
        return []
    x, y = result
    pub = int_to_32bytes(x) + int_to_32bytes(y)
    o = [0] * 12 + [b for b in sha3(pub)[-20:]]
    return list(bytearray(o))


def sha256(data: List[int]) -> List[int]:
    try:
        bytes_data = bytes(data)
    except TypeError:
        raise NativeContractException
    return list(bytearray(hashlib.sha256(bytes_data).digest()))


def ripemd160(data: List[int]) -> List[int]:
    try:
        bytes_data = bytes(data)
    except TypeError:
        raise NativeContractException
    digest = hashlib.new("ripemd160", bytes_data).digest()
    padded = 12 * [0] + list(digest)
    return list(bytearray(bytes(padded)))


def identity(data: List[int]) -> List[int]:
    result = []
    for item in data:
        try:
            result.append(int(item))
        except TypeError:
            raise NativeContractException
    return result


def mod_exp(data: List[int]) -> List[int]:
    """EIP-198 modular exponentiation."""
    bytes_data = bytearray(data)
    baselen = extract32(bytes_data, 0)
    explen = extract32(bytes_data, 32)
    modlen = extract32(bytes_data, 64)
    if baselen == 0:
        return [0] * modlen
    if modlen == 0:
        return []

    base = bytearray(baselen)
    extract_copy(bytes_data, base, 0, 96, baselen)
    exp = bytearray(explen)
    extract_copy(bytes_data, exp, 0, 96 + baselen, explen)
    mod = bytearray(modlen)
    extract_copy(bytes_data, mod, 0, 96 + baselen + explen, modlen)
    if int.from_bytes(mod, "big") == 0:
        return [0] * modlen
    o = pow(
        int.from_bytes(base, "big"),
        int.from_bytes(exp, "big"),
        int.from_bytes(mod, "big"),
    )
    return [x for x in int(o).to_bytes(modlen, byteorder="big")]


def ec_add(data: List[int]) -> List[int]:
    bytes_data = bytearray(data)
    x1 = extract32(bytes_data, 0)
    y1 = extract32(bytes_data, 32)
    x2 = extract32(bytes_data, 64)
    y2 = extract32(bytes_data, 96)
    try:
        p1 = crypto.bn128_decode_point(x1, y1)
        p2 = crypto.bn128_decode_point(x2, y2)
    except ValueError:
        return []
    o = crypto.bn128_encode_point(crypto.bn128_add(p1, p2))
    return [b for b in int_to_32bytes(o[0]) + int_to_32bytes(o[1])]


def ec_mul(data: List[int]) -> List[int]:
    bytes_data = bytearray(data)
    x = extract32(bytes_data, 0)
    y = extract32(bytes_data, 32)
    m = extract32(bytes_data, 64)
    try:
        p = crypto.bn128_decode_point(x, y)
    except ValueError:
        return []
    o = crypto.bn128_encode_point(crypto.bn128_mul(p, m))
    return [b for b in int_to_32bytes(o[0]) + int_to_32bytes(o[1])]


def ec_pair(data: List[int]) -> List[int]:
    """EIP-197 ecPairing product check (capability parity:
    mythril/laser/ethereum/natives.py:204-236; EVM supplies each G2
    coordinate imaginary-part-first)."""
    if len(data) % 192:
        return []
    pairs = []
    bytes_data = bytearray(data)
    for i in range(0, len(bytes_data), 192):
        x1 = extract32(bytes_data, i)
        y1 = extract32(bytes_data, i + 32)
        x2_i = extract32(bytes_data, i + 64)
        x2_r = extract32(bytes_data, i + 96)
        y2_i = extract32(bytes_data, i + 128)
        y2_r = extract32(bytes_data, i + 160)
        try:
            p1 = crypto.bn128_decode_point(x1, y1)
            q2 = crypto.bn128_g2_decode(x2_r, x2_i, y2_r, y2_i)
        except ValueError:
            return []
        pairs.append((p1, q2))
    result = crypto.bn128_pairing_check(pairs)
    return [0] * 31 + [1 if result else 0]


def blake2b_fcompress(data: List[int]) -> List[int]:
    """EIP-152 blake2b F precompile."""
    try:
        bytes_data = bytes(data)
    except TypeError:
        raise NativeContractException
    if len(bytes_data) != 213:
        raise NativeContractException
    rounds = int.from_bytes(bytes_data[0:4], "big")
    h = [
        int.from_bytes(bytes_data[4 + 8 * i : 12 + 8 * i], "little")
        for i in range(8)
    ]
    m = [
        int.from_bytes(bytes_data[68 + 8 * i : 76 + 8 * i], "little")
        for i in range(16)
    ]
    t = (
        int.from_bytes(bytes_data[196:204], "little"),
        int.from_bytes(bytes_data[204:212], "little"),
    )
    f = bytes_data[212]
    if f not in (0, 1):
        raise NativeContractException
    result = crypto.blake2b_compress(rounds, h, m, t, bool(f))
    out = b"".join(x.to_bytes(8, "little") for x in result)
    return list(bytearray(out))


PRECOMPILE_FUNCTIONS = (
    ecrecover,
    sha256,
    ripemd160,
    identity,
    mod_exp,
    ec_add,
    ec_mul,
    ec_pair,
    blake2b_fcompress,
)
PRECOMPILE_COUNT = len(PRECOMPILE_FUNCTIONS)


def native_contracts(address: int, data: BaseCalldata) -> List[int]:
    """Run the precompile at `address` (1-based) on concrete calldata."""
    if not isinstance(data, ConcreteCalldata):
        raise NativeContractException
    concrete_data = data.concrete(None)
    try:
        return PRECOMPILE_FUNCTIONS[address - 1](concrete_data)
    except TypeError:
        raise NativeContractException
