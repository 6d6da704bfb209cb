"""Device REF substitution: dense-RHS forward/back solve in limb arithmetic.

Port of ``slip_lu_tpu/tpu/solve.py`` (reference parity: slip_forward_sub.c,
slip_matrix_mul.c, slip_back_sub.c). Right-looking dense form: no history
vector is needed because every row is touched at every step, and the
integers equal the reference's left-looking values exactly.

Per step everything is shared-operand limb arithmetic (``ops/matarith``):
rho x X and the exact division by rho through kernel K5, the L-column x
X-row outer product as a float64 matrix product. The JAX package's two
``lax.fori_loop``s are Python loops over device tensors; the overflow flag
stays on the device.

Inputs come from ``gpu.factor.factor_dense_limbs``: the packed LU tensor
(FS, FM) whose diagonal is the rhos, strict lower is L, upper is U.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..ops import matarith as mt

_I32 = torch.int32


def solve_dense_limbs(FS: torch.Tensor, FM: torch.Tensor,
                      VS: torch.Tensor, VM: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Solve U x_hat = rho_{n-1} * forward_sub(L, P b) on FS's device.

    FS/FM: [n, n(, W)] packed LU; VS/VM: [n, nrhs(, Ws)] RHS already
    permuted into pivot order. Returns (XS, XM, overflow) where x_hat is
    the integer solution scaled by det = rho_{n-1}; the exact rational
    solution is x_hat / det (the host divides).
    """
    n, _, W = FM.shape
    Ws = VM.shape[2]
    Wp = W + Ws + 1  # product / intermediate width
    dev = FM.device
    rows = torch.arange(n, dtype=_I32, device=dev)
    one_mag = torch.zeros(W, dtype=_I32, device=dev)
    one_mag[0] = 1
    ovf = torch.zeros((), dtype=torch.bool, device=dev)

    # ---- forward substitution (rows process in pivot order) ----
    rp_s, rp_m = torch.ones((), dtype=_I32, device=dev), one_mag
    for k in range(n):
        rho_s, rho_m = FS[k, k], FM[k, k]
        rho_m_safe = torch.where(torch.all(rho_m == 0), one_mag, rho_m)
        p1s, p1m, _ = mt.signed_mul_shared(VS, VM, rho_s, rho_m_safe, Wp)
        p2s, p2m, _ = mt.signed_mul_outer(FS[:, k], FM[:, k], VS[k], VM[k],
                                          Wp)
        ds, dm, _ = mt.signed_sub_vec(p1s, p1m, p2s, p2m, Wp)
        inv, tz = mt.div_precompute_hensel(rp_m, Wp)
        qs, qm, bad = mt.signed_divexact_shared(ds, dm, rp_s, inv, tz, Ws)
        mask = (rows > k)[:, None]                    # [n, 1] over rhs
        VS = torch.where(mask, qs, VS)
        VM = torch.where(mask[..., None], qm, VM)
        ovf = ovf | torch.any(mask & bad)
        rp_s, rp_m = rho_s, rho_m_safe

    # ---- scale by the determinant rho_{n-1} ----
    VS, VM, o_det = mt.signed_mul_shared(VS, VM, FS[n - 1, n - 1],
                                         FM[n - 1, n - 1], Ws)
    ovf = ovf | torch.any(o_det)

    # ---- back substitution ----
    for j in range(n - 1, -1, -1):
        rho_s, rho_m = FS[j, j], FM[j, j]
        rho_m_safe = torch.where(torch.all(rho_m == 0), one_mag, rho_m)
        inv, tz = mt.div_precompute_hensel(rho_m_safe, Ws)
        xj_s, xj_m, bad = mt.signed_divexact_shared(VS[j], VM[j], rho_s,
                                                    inv, tz, Ws)
        VS, VM = VS.clone(), VM.clone()
        VS[j], VM[j] = xj_s, xj_m
        ps, pm, o1 = mt.signed_mul_outer(FS[:, j], FM[:, j], xj_s, xj_m, Ws)
        ns, nm, o2 = mt.signed_sub_vec(VS, VM, ps, pm, Ws)
        mask = (rows < j)[:, None]
        VS = torch.where(mask, ns, VS)
        VM = torch.where(mask[..., None], nm, VM)
        ovf = ovf | torch.any(bad) | torch.any(mask & (o1 | o2))
    return VS, VM, ovf
