"""Solver options.

Mirrors the reference ``SLIP_options`` struct created by
``SLIP_create_default_options.c`` (reference: SLIP_LU/Source/
SLIP_create_default_options.c ~l.30; struct in Include/SLIP_LU.h ~l.250):
pivot scheme, ordering, tolerance, print level, MPFR output precision,
rounding mode, and solution-check flag — with identical defaults
(pivot=SMALLEST, order=COLAMD, tol=0.1, print_level=0, prec=128,
round=nearest, check=False).

New-framework additions (no reference counterpart): fixed-width limb
configuration and device-mesh shape for the TPU execution path.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional, Tuple


class Pivot(enum.IntEnum):
    """Pivot schemes (reference: SLIP_pivot enum, Include/SLIP_LU.h ~l.200).

    Semantics (implemented in slip_lu_tpu.factorize._choose_pivot):
      SMALLEST       — smallest nonzero |x| in the eliminated column
                       (best bit-growth control; reference default).
      DIAGONAL       — the diagonal entry if nonzero, else SMALLEST.
      FIRST_NONZERO  — first nonzero encountered in the column pattern.
      TOL_SMALLEST   — diagonal if |diag| <= |smallest| / tol, else SMALLEST.
      TOL_LARGEST    — diagonal if |diag| >= |largest| * tol, else LARGEST.
      LARGEST        — largest nonzero |x| (best numerical growth for the
                       implicit-double path; worst bit growth).
    """

    SMALLEST = 0
    DIAGONAL = 1
    FIRST_NONZERO = 2
    TOL_SMALLEST = 3
    TOL_LARGEST = 4
    LARGEST = 5


# Per-backend pivot semantics (documented deviation; see USERGUIDE
# "Pivoting semantics by backend"):
#
#   backend        honors options.pivot?   actual rule
#   -------        ---------------------   -----------
#   host oracle    yes (all 6 schemes)     dynamic search per column,
#                                          reference parity
#                                          (slip_get_pivot.c dispatch)
#   tpu (dense)    yes (all 6 schemes)     on-device masked tournament
#                                          over limb magnitudes
#   tpu-sparse /   default: NO —           pivots pinned to a
#   tpu-fused /    static schedule         zero-free transversal
#   sharded                                diagonal of B = A[r][:, q];
#                                          on exact cancellation the
#                                          driver replans with the
#                                          host oracle's pivot rows
#                                          (which DO follow
#                                          options.pivot)
#                  pivot_exact=True:       the host pivot search runs
#                  yes (all 6 schemes)     ONCE per analysis and its
#                                          row sequence is pinned into
#                                          the schedule — reference
#                                          pivot semantics, device
#                                          execution
#
# Why: the scheduled paths need data-independent patterns; a dynamic
# SMALLEST search would make every column's pattern (and the whole
# schedule) value-dependent. The cost is bit-growth control: SMALLEST
# (the reference default) minimizes pivot magnitude and hence the limb
# width W. Measured max factor-entry width in limbs on the corpus,
# pinned-transversal vs oracle SMALLEST (tools: /tmp-style probe,
# factorize(fixed_r=schedule rows) vs factorize()): grid16 35/35,
# grid24 79/79, sparse100 18/18, wide_range 15/15; tri1000 and uni10k
# cancel on the pinned transversal and replan with the oracle's rows,
# landing exactly on the SMALLEST widths (143, 18). Adversarial value
# distributions can make the pinned choice wider — never wrong: every
# width is overflow-checked and widened on demand.


class Ordering(enum.IntEnum):
    """Fill-reducing column orderings (reference: SLIP_col_order enum).

    AUTO is a framework extension with no reference counterpart: it
    compares fill ESTIMATES across identity/COLAMD/AMD and takes the
    minimum — on banded constructions the identity order can carry
    ~15x less fill (and far narrower IPGE growth) than COLAMD, and the
    reference leaves that knowledge to the user. The default stays
    COLAMD for reference parity."""

    NONE = 0      # identity ordering (no permutation)
    COLAMD = 1    # column approximate minimum degree (reference default)
    AMD = 2       # approximate minimum degree on A+A'
    AUTO = 3      # pick min estimated fill among NONE/COLAMD/AMD


class RoundMode(enum.IntEnum):
    """Rounding for big-float (mpfr-equivalent) output conversion."""

    NEAREST = 0   # round-to-nearest-even (MPFR_RNDN, reference default)
    ZERO = 1      # toward zero (MPFR_RNDZ)
    UP = 2        # toward +inf
    DOWN = 3      # toward -inf


@dataclasses.dataclass(frozen=True)
class Options:
    """Immutable solver options; `Options()` reproduces reference defaults.

    Reference parity fields: pivot, order, tol, print_level, prec, round,
    check (SLIP_create_default_options.c).
    New-framework fields: limb_bits, max_limbs, mesh_shape, use_pallas.
    """

    pivot: Pivot = Pivot.SMALLEST
    pivot_exact: bool = False     # honor `pivot` on the SCHEDULED paths
    #   (tpu-sparse / tpu-fused / sharded): run the reference pivot
    #   search once on host (slip_get_pivot.c dispatch) and pin the
    #   resulting row sequence into the static schedule — exact
    #   reference pivot semantics, at the cost of one host
    #   factorization per analysis (cached; its exact width also seeds
    #   the device width ladder, skipping the widen-retry climb).
    #   Default False keeps the zero-free transversal (see the
    #   per-backend table above).
    order: Ordering = Ordering.COLAMD
    tol: float = 0.1              # pivot tolerance for TOL_* schemes, in (0,1]
    print_level: int = 0          # 0 none, 1 stats, 2 matrices terse, 3 full
    prec: int = 128               # big-float output precision in bits
    round: RoundMode = RoundMode.NEAREST
    check: bool = False           # verify A*x == b exactly after solve

    # --- TPU-path configuration (new framework; no reference counterpart) ---
    limb_bits: int = 16           # bits per limb word on device (16 fits VPU i32 products)
    max_limbs: Optional[int] = None  # cap on W; None = use Hadamard/IPGE bound
    mesh_shape: Optional[Tuple[int, ...]] = None  # device mesh, None = single chip
    use_pallas: bool = True       # use Pallas kernels where available

    def validate(self) -> None:
        from .errors import SlipIncorrectInputError

        if not (0.0 < self.tol <= 1.0):
            raise SlipIncorrectInputError(f"tol must be in (0, 1], got {self.tol}")
        if self.prec < 2:
            raise SlipIncorrectInputError(f"prec must be >= 2 bits, got {self.prec}")
        if self.limb_bits not in (8, 16):
            raise SlipIncorrectInputError(
                f"limb_bits must be 8 or 16 (products must fit int32), got {self.limb_bits}"
            )
        if self.print_level not in (0, 1, 2, 3):
            raise SlipIncorrectInputError(f"print_level must be 0..3, got {self.print_level}")


def default_options() -> Options:
    """Reference-parity constructor (SLIP_create_default_options)."""
    return Options()
