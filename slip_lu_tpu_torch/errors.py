"""Error codes and exceptions for slip_lu_tpu.

Mirrors the reference's ``SLIP_info`` enum (reference:
``SLIP_LU/Include/SLIP_LU.h`` ~l.160 — {SLIP_OK=0, SLIP_OUT_OF_MEMORY=-1,
SLIP_SINGULAR=-2, SLIP_INCORRECT_INPUT=-3, SLIP_INCORRECT=-4, SLIP_PANIC=-5}),
plus one new-framework code, ``LIMB_OVERFLOW``, raised when a fixed-width
limb computation on TPU would exceed the chosen limb budget W (the reference
has no analogue because GMP integers grow without bound).

The low-level API is info-code based like the reference; the Pythonic API
raises these exceptions instead.
"""

from __future__ import annotations

import enum


class SlipInfo(enum.IntEnum):
    """Status codes, value-compatible with the reference SLIP_info enum."""

    OK = 0
    OUT_OF_MEMORY = -1
    SINGULAR = -2
    INCORRECT_INPUT = -3
    INCORRECT = -4
    PANIC = -5
    # New-framework only: fixed-width limb arithmetic overflowed W words.
    LIMB_OVERFLOW = -6


class SlipError(Exception):
    """Base class for all slip_lu_tpu errors. Carries a SlipInfo code."""

    info: SlipInfo = SlipInfo.PANIC

    def __init__(self, message: str = ""):
        super().__init__(message or self.__class__.__doc__)


class SlipSingularError(SlipError):
    """The matrix is singular (a column had no eligible nonzero pivot)."""

    info = SlipInfo.SINGULAR


class SlipIncorrectInputError(SlipError):
    """An input argument is malformed (bad kind/type/shape/indices)."""

    info = SlipInfo.INCORRECT_INPUT


class SlipIncorrectError(SlipError):
    """Solution verification failed: A*x != b in exact rational arithmetic."""

    info = SlipInfo.INCORRECT


class SlipPanicError(SlipError):
    """Internal invariant violated."""

    info = SlipInfo.PANIC


class SlipLimbOverflowError(SlipError):
    """A fixed-width limb computation exceeded the configured word budget W.

    Host-side recovery: recompute the bit-growth bound with a wider W and
    retry (see slip_lu_tpu.tpu.bounds).
    """

    info = SlipInfo.LIMB_OVERFLOW


_EXC_FOR_INFO = {
    SlipInfo.SINGULAR: SlipSingularError,
    SlipInfo.INCORRECT_INPUT: SlipIncorrectInputError,
    SlipInfo.INCORRECT: SlipIncorrectError,
    SlipInfo.PANIC: SlipPanicError,
    SlipInfo.LIMB_OVERFLOW: SlipLimbOverflowError,
}


def raise_for_info(info: SlipInfo, message: str = "") -> None:
    """Raise the exception matching a non-OK info code; no-op on OK."""
    if info == SlipInfo.OK:
        return
    exc = _EXC_FOR_INFO.get(SlipInfo(info), SlipPanicError)
    raise exc(message)
