"""Dense factor + solve on one device, one read back to the host.

Port of ``slip_lu_tpu/tpu/fused.py``: the factorization, the right-hand
side's row permutation, forward and back substitution and the determinant
run on the device, and the host reads everything it needs through one
flat int32 buffer, the only device-to-host transfer of a solve.
"""

from __future__ import annotations

import torch

from .factor import factor_dense_limbs
from .solve import solve_dense_limbs

_I32 = torch.int32


def factor_solve_dense(S: torch.Tensor, M: torch.Tensor, qcols: torch.Tensor,
                       VS0: torch.Tensor, VM0: torch.Tensor, scheme: int,
                       tol_num_mag: torch.Tensor, tol_shift: int
                       ) -> torch.Tensor:
    """Factor A (packed, column-permuted) and solve for a RHS block.

    VS0/VM0: RHS in *natural* row order at solve width Ws; the pivot-order
    permutation happens on the device using the factorization's rowidx.

    Returns ONE flat int32 tensor on the device:
      [singular, f_ovf, s_ovf, det_s, det_m (W), rowidx (n),
       XS (n*nrhs), XM (n*nrhs*Ws)]
    Unpack with unpack_dense_result(buf, n, nrhs, W, Ws).
    """
    n = S.shape[0]
    FS, FM, rowidx, singular, f_ovf = factor_dense_limbs(
        S, M, qcols, scheme, tol_num_mag, tol_shift)
    perm = rowidx.long()
    VS = VS0.index_select(0, perm)
    VM = VM0.index_select(0, perm)
    XS, XM, s_ovf = solve_dense_limbs(FS, FM, VS, VM)
    flags = torch.stack([singular, f_ovf, s_ovf]).to(_I32)
    return torch.cat([flags, FS[n - 1, n - 1].reshape(1), FM[n - 1, n - 1],
                      rowidx, XS.reshape(-1), XM.reshape(-1)])


def unpack_dense_result(buf, n, nrhs, W, Ws):
    """Split the flat result of factor_solve_dense (a numpy array) back
    into parts."""
    singular, f_ovf, s_ovf = (bool(buf[t]) for t in range(3))
    o = 3
    det_s = buf[o]
    o += 1
    det_m = buf[o:o + W]
    o += W
    rowidx = buf[o:o + n]
    o += n
    XS = buf[o:o + n * nrhs].reshape(n, nrhs)
    o += n * nrhs
    XM = buf[o:o + n * nrhs * Ws].reshape(n, nrhs, Ws)
    return XS, XM, det_s, det_m, rowidx, singular, f_ovf, s_ovf
