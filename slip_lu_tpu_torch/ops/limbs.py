"""Host <-> device conversion between Python ints and fixed-width limb arrays.

A value v is represented as (sign, mag) where sign is int32 in {-1, 0, +1}
and mag is int32[..., W], little-endian base-2**16 limbs of |v|. This is the
framework's replacement for GMP mpz_t (SURVEY.md section 7 design stance):
static shapes, no pointers, VPU-friendly.
"""

from __future__ import annotations

from typing import Iterable, Tuple

import numpy as np

LIMB_BITS = 16
LIMB_BASE = 1 << LIMB_BITS
LIMB_MASK = LIMB_BASE - 1


def width_for_bits(bits: int) -> int:
    """Limbs needed to hold a magnitude of `bits` bits (at least 1)."""
    return max(1, -(-bits // LIMB_BITS))


def ints_to_limbs(values: Iterable[int], W: int) -> Tuple[np.ndarray, np.ndarray]:
    """Pack Python ints into (sign [N], mag [N, W]) int32 arrays.

    Raises OverflowError if any |value| needs more than W limbs — callers
    choose W from the IPGE bit-growth bound (slip_lu_tpu.tpu.bounds).
    Values within int64 range take a vectorized numpy path (the common
    case when packing input matrices at corpus scale); anything wider
    falls back to exact per-entry conversion.
    """
    vals = list(values)
    n = len(vals)
    a64 = None
    try:
        a64 = np.array(vals, dtype=np.int64)
    except (OverflowError, TypeError):
        pass
    if a64 is not None and (n == 0
                            or int(a64.min()) != np.iinfo(np.int64).min):
        sign = np.sign(a64).astype(np.int32)
        mag = np.zeros((n, W), dtype=np.int32)
        if n:
            a = np.abs(a64).astype(np.uint64)
            hi = int(a.max(initial=0)).bit_length()
            if hi > 16 * W:
                raise OverflowError(f"value needs more than W={W} limbs "
                                    f"({hi} bits)")
            k = min(W, 4)
            shifts = (16 * np.arange(k, dtype=np.uint64))[None, :]
            mag[:, :k] = ((a[:, None] >> shifts)
                          & np.uint64(0xFFFF)).astype(np.int32)
        return sign, mag
    sign = np.zeros(n, dtype=np.int32)
    buf = np.zeros((n, 2 * W), dtype=np.uint8)
    for k, v in enumerate(vals):
        v = int(v)
        if v > 0:
            sign[k] = 1
        elif v < 0:
            sign[k] = -1
        a = abs(v)
        try:
            b = a.to_bytes(2 * W, "little")
        except OverflowError:
            raise OverflowError(f"value needs more than W={W} limbs "
                                f"({a.bit_length()} bits)")
        buf[k] = np.frombuffer(b, dtype=np.uint8)
    mag = buf[:, 0::2].astype(np.int32) | (buf[:, 1::2].astype(np.int32) << 8)
    return sign, mag


def limbs_to_ints(sign: np.ndarray, mag: np.ndarray) -> np.ndarray:
    """Unpack (sign, mag) back into an object array of Python ints."""
    sign = np.asarray(sign)
    mag = np.asarray(mag)
    W = mag.shape[-1]
    flat_s = sign.reshape(-1)
    flat_m = mag.reshape(-1, W)
    # vectorized path: magnitudes that fit in 3 limbs (< 2**48) combine
    # exactly inside int64
    sig = min(W, 3)
    if W <= 3 or not flat_m[:, 3:].any():
        u = np.zeros(flat_m.shape[0], dtype=np.int64)
        for k in range(sig):
            u |= flat_m[:, k].astype(np.int64) << (16 * k)
        out = np.empty(flat_m.shape[0], dtype=object)
        out[:] = (flat_s.astype(np.int64) * u).tolist()
        return out.reshape(sign.shape)
    buf = np.empty((flat_m.shape[0], 2 * W), dtype=np.uint8)
    buf[:, 0::2] = flat_m & 0xFF
    buf[:, 1::2] = (flat_m >> 8) & 0xFF
    raw = buf.tobytes()
    stride = 2 * W
    out = np.empty(flat_s.shape[0], dtype=object)
    for k in range(flat_s.shape[0]):
        out[k] = int(flat_s[k]) * int.from_bytes(
            raw[k * stride:(k + 1) * stride], "little")
    return out.reshape(sign.shape)


def matrix_to_limbs(dense_ints: np.ndarray, W: int) -> Tuple[np.ndarray, np.ndarray]:
    """Pack a 2-D object array of ints into (sign [m,n], mag [m,n,W])."""
    m, n = dense_ints.shape
    sign, mag = ints_to_limbs(dense_ints.reshape(-1), W)
    return sign.reshape(m, n), mag.reshape(m, n, W)
