"""Single-device REF LU factorization, dense with masking (IPGE).

Port of ``slip_lu_tpu/tpu/factor.py``: right-looking IPGE (Bareiss
fraction-free elimination) over a dense limb tensor with masks,

    M[i,j] <- (rho_k * M[i,j] - M[i,k] * M[k,j]) / rho_{k-1}   for i,j > k,

which computes the same integers as the reference's left-looking
formulation (IPGE values are minors), so L, U and the rhos match the host
oracle bit for bit. It is the only device path that honours
``options.pivot`` dynamically: each step searches column k for its pivot
on the device, under any of the six schemes.

Each step is whole-tensor limb arithmetic (``ops/matarith.py``): rho x M
and the exact division by rho_{k-1} through kernel K5, the pivot outer
product as a float64 matrix product, the pivot search as a log-depth
tournament. The JAX package's ``lax.fori_loop`` over n is a Python loop
over device tensors here. No step reads anything back to the host: the
pivot position, the singular and overflow flags stay on the device until
the caller reads the results once at the end. Row swaps update the
working tensors in place (they are this function's own copies).

After the loop the working tensor is the packed factorization: upper
triangle and diagonal = U rows, strict lower triangle = L columns,
diagonal = rhos. Overflow and singularity come back as flags; the host
widens W and retries.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..ops import matarith as mt
from ..ops.arith import mag_shl_bits_static
from ..options import Pivot

_I32 = torch.int32
_ROW_PAD = 2 ** 30          # original-row key of padding and ineligible rows


def _swap_rows(t: torch.Tensor, k: int, p: torch.Tensor) -> torch.Tensor:
    """Swap rows k (static) and p (a 0-dim device tensor) of t, in place."""
    pi = p.long().reshape(1)
    rk = t[k].clone()
    rp = t.index_select(0, pi)[0]
    t.index_copy_(0, pi, rk.unsqueeze(0))
    t[k] = rp
    return t


def _tournament(cm: torch.Tensor, eligible: torch.Tensor,
                rowidx: torch.Tensor, minimize: bool
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """argext over eligible rows of (magnitude, original row) lexicographic.

    Log-depth pairwise reduction, the vectorized replacement for the
    reference's sequential pivot scan. Returns (best_mag, best_position,
    any_eligible).
    """
    n, W = cm.shape
    m = 1 << max(1, n - 1).bit_length()
    pad = m - n
    dev = cm.device
    mags = torch.cat([cm, torch.zeros((pad, W), dtype=cm.dtype, device=dev)])
    elig = torch.cat([eligible, torch.zeros(pad, dtype=torch.bool,
                                            device=dev)])
    rows = torch.cat([rowidx, torch.full((pad,), _ROW_PAD, dtype=_I32,
                                         device=dev)])
    pos = torch.cat([torch.arange(n, dtype=_I32, device=dev),
                     torch.zeros(pad, dtype=_I32, device=dev)])
    while m > 1:
        h = m // 2
        ma_, mb_ = mags[:h], mags[h:]
        ea, eb = elig[:h], elig[h:]
        ra, rb = rows[:h], rows[h:]
        pa, pb = pos[:h], pos[h:]
        c = mt.mag_cmp_vec(mb_, ma_)
        better = (c < 0) if minimize else (c > 0)
        take_b = eb & ((~ea) | better | ((c == 0) & (rb < ra)))
        mags = torch.where(take_b[:, None], mb_, ma_)
        elig = ea | eb
        rows = torch.where(take_b, rb, ra)
        pos = torch.where(take_b, pb, pa)
        m = h
    return mags[0], pos[0], elig[0]


def _select_pivot(cs: torch.Tensor, cm: torch.Tensor, eligible: torch.Tensor,
                  rowidx: torch.Tensor, scheme: int, k: int,
                  diag_orig_col: torch.Tensor,
                  tol_num_mag: torch.Tensor, tol_shift: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """On-device pivot search over column k's candidates.

    cs/cm: sign [n] and magnitude [n, W] of the current column.
    eligible: row position >= k and entry nonzero.
    Tie-breaks match the host oracle exactly: smallest *original* row
    index. argmin and argmax return the first index of a tie, as in JAX.
    Returns (pivot_position, found_flag).
    """
    n, W = cm.shape

    def first_nonzero():
        keyed = torch.where(eligible, rowidx, _ROW_PAD)
        return torch.argmin(keyed).to(_I32), torch.any(eligible)

    # diagonal candidate: the row whose original index equals the original
    # column index of column k (columns were permuted on the host by q)
    diag_mask = eligible & (rowidx == diag_orig_col)
    diag_pos = torch.argmax(diag_mask.to(_I32)).to(_I32)
    has_diag = torch.any(diag_mask)
    diag_mag = cm.index_select(0, diag_pos.long().reshape(1))[0]

    if scheme == Pivot.FIRST_NONZERO:
        return first_nonzero()
    if scheme == Pivot.SMALLEST:
        _, pos, has = _tournament(cm, eligible, rowidx, minimize=True)
        return pos, has
    if scheme == Pivot.LARGEST:
        _, pos, has = _tournament(cm, eligible, rowidx, minimize=False)
        return pos, has
    if scheme == Pivot.DIAGONAL:
        _, pos, has = _tournament(cm, eligible, rowidx, minimize=True)
        return torch.where(has_diag, diag_pos, pos), has
    if scheme == Pivot.TOL_SMALLEST:
        bm, pos, has = _tournament(cm, eligible, rowidx, minimize=True)
        # use diagonal if |diag| * tol <= |smallest|  (tol = num / 2**shift)
        lhs, _ = mt.mul_shared(diag_mag[None, :], tol_num_mag,
                               W + tol_num_mag.shape[-1])
        rhs = _shl_static(bm, tol_shift)
        use_diag = has_diag & (mt.mag_cmp_vec(lhs[0], rhs) <= 0)
        return torch.where(use_diag, diag_pos, pos), has
    if scheme == Pivot.TOL_LARGEST:
        bm, pos, has = _tournament(cm, eligible, rowidx, minimize=False)
        # use diagonal if |diag| >= |largest| * tol
        lhs = _shl_static(diag_mag, tol_shift)
        rhs, _ = mt.mul_shared(bm[None, :], tol_num_mag,
                               W + tol_num_mag.shape[-1])
        use_diag = has_diag & (mt.mag_cmp_vec(lhs, rhs[0]) >= 0)
        return torch.where(use_diag, diag_pos, pos), has
    raise ValueError(f"unknown pivot scheme {scheme}")


def _shl_static(a: torch.Tensor, nbits: int) -> torch.Tensor:
    return mag_shl_bits_static(a, nbits)


def factor_dense_limbs(S: torch.Tensor, M: torch.Tensor, qcols: torch.Tensor,
                       scheme: int, tol_num_mag: torch.Tensor, tol_shift: int
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                  torch.Tensor, torch.Tensor]:
    """Factor a column-permuted dense limb matrix on S's device.

    S: [n, n] int32 signs; M: [n, n, W] int32 magnitudes (of A[:, q],
    integerized). qcols: [n] original column index per position (for the
    DIAGONAL schemes). tol_num_mag: the TOL schemes' numerator limbs.
    Returns (S, M, rowidx, singular_flag, overflow_flag), all on the
    device, with the packed LU in (S, M) and rowidx[k] = original row
    pivoting position k.
    """
    n, _, W = M.shape
    W2 = 2 * W + 1  # product / IPGE-intermediate width
    dev = M.device
    S, M = S.clone(), M.clone()
    rows = torch.arange(n, dtype=_I32, device=dev)
    rowidx = rows.clone()
    one_mag = torch.zeros(W, dtype=_I32, device=dev)
    one_mag[0] = 1
    rp_sign = torch.ones((), dtype=_I32, device=dev)
    rp_mag = one_mag
    singular = torch.zeros((), dtype=torch.bool, device=dev)
    overflow = torch.zeros((), dtype=torch.bool, device=dev)
    for k in range(n):
        # --- pivot search on column k
        cs, cm = S[:, k], M[:, k, :]
        eligible = (rows >= k) & (cs != 0)
        pos, found = _select_pivot(cs, cm, eligible, rowidx, scheme, k,
                                   qcols[k], tol_num_mag, tol_shift)
        singular = singular | ~found
        pos = torch.where(found, pos, k)  # keep computing if singular
        # --- swap the pivot row into position k
        _swap_rows(S, k, pos)
        _swap_rows(M, k, pos)
        _swap_rows(rowidx, k, pos)
        rho_s = S[k, k].clone()
        rho_m = M[k, k].clone()
        # degenerate-safe divisor (the flag is already set if singular)
        rho_m_safe = torch.where(torch.all(rho_m == 0), one_mag, rho_m)
        # --- IPGE update of the trailing submatrix: three products and one
        #     subtract, no per-limb loops
        live = rows > k
        mask = live[:, None] & live[None, :]                     # [n, n]
        p1s, p1m, _ = mt.signed_mul_shared(S, M, rho_s, rho_m_safe, W2)
        p2s, p2m, _ = mt.signed_mul_outer(S[:, k], M[:, k, :], S[k, :],
                                          M[k, :, :], W2)
        ds, dm, _ = mt.signed_sub_vec(p1s, p1m, p2s, p2m, W2)
        inv, tz = mt.div_precompute_hensel(rp_mag, W2)
        qs, qm, bad = mt.signed_divexact_shared(ds, dm, rp_sign, inv, tz, W)
        S = torch.where(mask, qs, S)
        M = torch.where(mask[..., None], qm, M)
        overflow = overflow | torch.any(mask & bad)
        rp_sign, rp_mag = rho_s, rho_m_safe
    return S, M, rowidx, singular, overflow
