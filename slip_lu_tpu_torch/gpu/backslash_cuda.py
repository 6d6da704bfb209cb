"""Host glue for the dense device path: pack -> factor -> solve -> unpack.

Port of ``slip_lu_tpu/tpu/backslash_tpu.py`` (backend ``"tpu"`` there,
``"cuda"`` here). The host

  1. computes the IPGE bit-growth bound and chooses the limb width W,
  2. packs the integerized, column-permuted matrix into limb tensors
     (numpy, shared with the JAX package) and moves them to the device,
  3. runs the dense factorization and substitution (``gpu/fused.py``)
     with every pivot searched on the device under ``options.pivot``,
  4. on overflow flags widens W and retries (``bounds.widen_widths``),
  5. unpacks exact rationals and undoes permutations and scales.

``device="cuda"`` (the default) runs the kernels and raises if torch finds
no CUDA device; ``device="cpu"`` runs their plain versions.
"""

from __future__ import annotations

from fractions import Fraction
from typing import Optional, Tuple

import numpy as np
import torch

from ..analyze import Analysis
from ..convert import csc_to_dense, matrix_copy
from ..errors import (SlipIncorrectInputError, SlipLimbOverflowError,
                      SlipSingularError)
from ..factorize import Factorization
from ..matrix import Kind, SlipMatrix, Type
from ..options import Options
from ..ops.limbs import ints_to_limbs, limbs_to_ints, matrix_to_limbs
from ..stats import SolveStats, phase_timer, record
from .backslash_fused import _device
from .bounds import factor_width, solve_width, widen_widths
from .factor import factor_dense_limbs
from .fused import factor_solve_dense, unpack_dense_result


def _tol_dyadic(tol: float) -> Tuple[np.ndarray, int]:
    """tol as (numerator limb magnitude, power-of-two shift)."""
    f = Fraction(tol)  # float -> exact dyadic
    shift = f.denominator.bit_length() - 1
    _, mag = ints_to_limbs([f.numerator],
                           max(1, -(-f.numerator.bit_length() // 16)))
    return mag[0], shift


def _pack_factor_inputs(A: SlipMatrix, q: np.ndarray, W: int, dev):
    dense = csc_to_dense(A)
    perm = dense.x[:, np.asarray(q, dtype=np.int64)]
    S, M = matrix_to_limbs(perm, W)
    return torch.from_numpy(S).to(dev), torch.from_numpy(M).to(dev)


def factor_cuda(A: SlipMatrix, analysis: Analysis,
                options: Optional[Options] = None,
                device="cuda") -> Factorization:
    """Dense device REF LU returning the same Factorization as the host
    oracle (same pivots, same L, U and rhos integers)."""
    options = options or Options()
    options.validate()
    dev = _device(device)
    if A.kind != Kind.CSC or A.type != Type.MPZ:
        raise SlipIncorrectInputError("factor_cuda requires CSC x MPZ input")
    if A.m != A.n:
        raise SlipIncorrectInputError(
            f"matrix must be square, got {A.m}x{A.n}")
    n = A.n
    q = np.asarray(analysis.q, dtype=np.int64)
    if n == 0:
        return Factorization(n=0, Lcols=[], Ucols=[], rhos=[],
                             pinv=np.zeros(0, np.int64),
                             row_perm=np.zeros(0, np.int64), q=q,
                             scale=A.scale)
    tol_mag, tol_shift = _tol_dyadic(options.tol)
    tol_t = torch.from_numpy(tol_mag).to(dev)
    qcols = torch.from_numpy(q.astype(np.int32)).to(dev)
    W = factor_width(A, options.max_limbs)
    W_full = factor_width(A)
    while True:
        S, M = _pack_factor_inputs(A, q, W, dev)
        FS, FM, rowidx, singular, overflow = factor_dense_limbs(
            S, M, qcols, int(options.pivot), tol_t, tol_shift)
        flags = torch.stack([singular, overflow]).cpu()
        singular, overflow = bool(flags[0]), bool(flags[1])
        # overflow first: truncation can fake a zero pivot, so widen before
        # trusting the singular flag; at the analytic bound real overflow
        # is impossible, so a set singular flag there is the true cause
        if overflow:
            if W >= W_full:
                if singular:
                    raise SlipSingularError(
                        "device factorization found no eligible pivot")
                raise SlipLimbOverflowError(
                    "overflow persists at the analytic width bound "
                    f"(W={W}) — internal invariant violated")
            W = min(2 * W, W_full)  # widen-and-retry
            continue
        if singular:
            raise SlipSingularError(
                "device factorization found no eligible pivot")
        return _unpack_factorization(FS.cpu().numpy(), FM.cpu().numpy(),
                                     rowidx.cpu().numpy(), q, A.scale)


def _unpack_factorization(FS: np.ndarray, FM: np.ndarray, rowidx: np.ndarray,
                          q: np.ndarray, scale: Fraction) -> Factorization:
    n = FS.shape[0]
    vals = limbs_to_ints(FS, FM)  # [n, n] object ints
    rhos = [int(vals[k, k]) for k in range(n)]
    pinv = np.empty(n, dtype=np.int64)
    row_perm = np.asarray(rowidx, dtype=np.int64)
    for k in range(n):
        pinv[int(rowidx[k])] = k
    Lcols = []
    Ucols = []
    for k in range(n):
        lcol = [(int(rowidx[i]), int(vals[i, k])) for i in range(k, n)
                if vals[i, k] != 0]
        ucol = [(r, int(vals[r, k])) for r in range(k) if vals[r, k] != 0]
        ucol.append((k, rhos[k]))
        Lcols.append(lcol)
        Ucols.append(ucol)
    return Factorization(n=n, Lcols=Lcols, Ucols=Ucols, rhos=rhos, pinv=pinv,
                         row_perm=row_perm, q=np.asarray(q, np.int64),
                         scale=scale)


def factorize_solve_cuda(A: SlipMatrix, analysis: Analysis, b: SlipMatrix,
                         options: Optional[Options] = None,
                         device="cuda") -> SlipMatrix:
    """The dense device path: factor and substitute on ``device``, exact
    MPQ result. One flat buffer comes back per rung of the width ladder."""
    options = options or Options()
    options.validate()
    dev = _device(device)
    if A.kind != Kind.CSC or A.type != Type.MPZ:
        raise SlipIncorrectInputError("dense path requires CSC x MPZ input")
    n = A.n
    if b.m != n:
        raise SlipIncorrectInputError(f"b has {b.m} rows, matrix has {n}")
    bz = matrix_copy(b, Kind.DENSE, Type.MPZ, options)
    nrhs = bz.n
    if n == 0:
        return SlipMatrix.allocate(Kind.DENSE, Type.MPQ, 0, nrhs)
    st = SolveStats(backend="cuda", n=n, nnz=int(A.p[n]), nrhs=nrhs)
    q = np.asarray(analysis.q, dtype=np.int64)
    tol_mag, tol_shift = _tol_dyadic(options.tol)
    W = factor_width(A, options.max_limbs)
    Ws = solve_width(A, bz.x, W, n, options.max_limbs)
    W_full = factor_width(A)
    Ws_full = solve_width(A, bz.x, W_full, n)
    with phase_timer(st, "pack"):
        tol_t = torch.from_numpy(tol_mag).to(dev)
        qcols = torch.from_numpy(q.astype(np.int32)).to(dev)
    while True:
        st.W, st.Ws = W, Ws
        with phase_timer(st, "pack"):
            S, M = _pack_factor_inputs(A, q, W, dev)
            VSn, VMn = matrix_to_limbs(bz.x, Ws)  # natural order
            VSn = torch.from_numpy(VSn).to(dev)
            VMn = torch.from_numpy(VMn).to(dev)
        with phase_timer(st, "device"):
            out = factor_solve_dense(S, M, qcols, VSn, VMn,
                                     int(options.pivot), tol_t, tol_shift)
            buf = out.cpu().numpy()   # the one device -> host transfer
        (XS, XM, det_s, det_m, rowidx, singular, f_ovf,
         s_ovf) = unpack_dense_result(buf, n, nrhs, W, Ws)
        # overflow before singular: truncated quotients can have all-zero
        # low limbs, making a nonzero pivot column look empty, so a width
        # overflow must widen-and-retry, not surface as SlipSingularError
        if f_ovf or s_ovf:
            nxt = widen_widths(W, Ws, W_full, Ws_full)
            if nxt is None:
                if singular:
                    # at the analytic bound overflow is garbage past the
                    # missing pivot: singular is the true cause
                    raise SlipSingularError(
                        "device factorization found no eligible pivot")
                raise SlipLimbOverflowError(
                    "overflow persists at the analytic width bound "
                    f"(W={W}, Ws={Ws}) — internal invariant violated")
            W, Ws = nxt
            st.retries += 1
            continue
        if singular:
            raise SlipSingularError(
                "device factorization found no eligible pivot")
        with phase_timer(st, "unpack"):
            det = int(limbs_to_ints(det_s.reshape(1), det_m[None, :])[0])
            xhat = limbs_to_ints(XS, XM)  # [n, nrhs]
            factor = A.scale / bz.scale
            x = SlipMatrix.allocate(Kind.DENSE, Type.MPQ, n, nrhs)
            for k in range(n):
                oc = int(q[k])
                for c in range(nrhs):
                    x.x[oc, c] = Fraction(int(xhat[k, c]), det) * factor
        record(st)
        return x
