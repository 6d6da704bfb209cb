"""The fused exact solve's device half: factor stream, solve stream, and
the one flat result vector.

Counterpart of ``slip_lu_tpu/tpu/factor_fused.py`` for one system (G = 1),
with right-hand sides run one after another, width segments (the tables
widen between segments, GT re-lifts in kernel K4, ``gpu/relift.py``) and
grouped (subtree-local) streams (``ndet``, ``nxx``, the extra value
slots). The factor stream (kernel K2,
``csrc/fused.cu:factor_stream_kernel``) runs, per chunk, the pivot heads,
the Hensel lift of the new pivot inverses, and two passes of

    out = (val[t] * SMT[m] - val[a] * B[b]) / rho[d];

the solve stream (K3, ``solve_stream_kernel``) runs the same two passes
over X. Each wrapper takes the kernel on a CUDA tensor and its plain
PyTorch version (``*_ref``, beside it) on a CPU tensor; any other device
raises. The plain versions also run on the card, where ``chip_smoke.py``
holds the kernels to them.

Semantics the two versions share with the reference, bit for bit:

  * chunks run in order; within a chunk the heads run one after another
    (head k's fix multiplies by rho_{k-1} from the head just before it),
    then the lift, then pass 1, then pass 2; within a pass every event
    reads the tables before any event writes;
  * division is the verified short division of ``_pass_body``: the
    Hensel product at WQ limbs, re-multiplied by the divisor at WV limbs
    and compared with the numerator, with ``fits_in`` as the overflow
    test; a zero pivot raises ``sing`` and is stored as 1;
  * flags: int32[8], rows 0 sing, 1 any overflow, 2 heads, 3 pass 1,
    4 pass 2 (the reference's ``facc`` rows, lane 0).

The tables use the reference's shapes (rows padded to multiples of 8).
The wrappers never write their inputs: ``val_in`` is cloned, so a caller
may cache and reuse it.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..ops import device_limbs as dl
from . import _build
from .relift import relift_gt, widen_tc, widen_val

_I32 = torch.int32


def _r8(x: int) -> int:
    return ((x + 7) // 8) * 8


# ---------------------------------------------------------------------------
# the state carrier: planner arrays -> the port's tensors
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class StreamTensors:
    """The two chunk streams on one device, plus the host copies of the
    per-chunk counts that the plain versions branch on."""
    H: int
    C1: int
    C2: int
    fhm: torch.Tensor     # [nc, 3H+4]: steps | slots | hists | counts
    fev1: torch.Tensor    # [nc, 5, C1] field-major (t, m, d, a, b)
    fev2: torch.Tensor    # [nc, 5, C2]
    scnt: torch.Tensor    # [ns, 4]
    sev1: torch.Tensor    # [ns, 5, C1]
    sev2: torch.Tensor    # [ns, 5, C2]
    fhm_host: np.ndarray
    scnt_host: np.ndarray


def _field_major(ev) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(ev, np.int32).transpose(0, 2, 1))


def stream_tensors(es, device) -> StreamTensors:
    """Planner streams (an ``EventStream`` of either package) -> tensors."""
    f, s = es.factor, es.solve
    fhm = np.concatenate([f.h_step, f.h_slot, f.h_div, f.counts],
                         axis=1).astype(np.int32)
    scnt = np.ascontiguousarray(s.counts, dtype=np.int32)

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return StreamTensors(
        H=int(f.h_step.shape[1]), C1=int(f.ev1.shape[1]),
        C2=int(f.ev2.shape[1]),
        fhm=dev(fhm), fev1=dev(_field_major(f.ev1)),
        fev2=dev(_field_major(f.ev2)), scnt=dev(scnt),
        sev1=dev(_field_major(s.ev1)), sev2=dev(_field_major(s.ev2)),
        fhm_host=fhm, scnt_host=scnt)


def val_tensor(avals, init_pos, E: int, W8: int, device, extra_pos=None,
               extra_vals=None) -> torch.Tensor:
    """A's values packed as the [r8(E+1), W8] two's-complement value
    table (slot E, the dummy, stays zero). Grouped streams add their
    constant slots (``extra_pos`` <- ``extra_vals``)."""
    val = np.zeros((_r8(E + 1), W8), dtype=np.int32)
    val[np.asarray(init_pos)] = ints_to_tc_rows(avals, W8)
    if extra_pos is not None and len(extra_pos):
        val[np.asarray(extra_pos)] = ints_to_tc_rows(extra_vals, W8)
    return torch.from_numpy(val).to(device)


def _moduli(Wt: int, W8: int, WI8: int):
    WQ = min(WI8, _r8(Wt + 2))       # short-division quotient modulus
    WV = _r8(WQ + W8)                # verification modulus (>= WQ + W8)
    return WQ, WV


def _nwarps(L: int) -> int:
    """Warps per block: at most 16 (fused.cu's kMaxThreads), and as many
    as 200 KB of shared memory hold at 48 bytes per limb of L."""
    per_warp = (8 + 4 * 10) * L
    nw = min(16, (200 * 1024) // per_warp)
    if nw < 1:
        raise ValueError(f"limb width {L} exceeds the kernels' shared "
                         "memory")
    return nw


def _require_cuda(t: torch.Tensor, what: str) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{what}: tensors must lie on the CPU (plain "
                         f"version) or on a CUDA device, not {t.device}")


def _check_kernel_args(what: str, device, widths: dict, **tensors) -> None:
    """What the kernels take: contiguous int32 tensors on one device, with
    rows of the widths the launch names (widths: tensor name -> width)."""
    for name, t in tensors.items():
        if t.device != device or t.dtype != _I32 or not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be a contiguous int32 "
                             f"tensor on {device}, not {t.dtype} on "
                             f"{t.device}")
        if name in widths and t.shape[-1] != widths[name]:
            raise ValueError(f"{what}: {name} has rows of {t.shape[-1]} "
                             f"limbs, the launch needs {widths[name]}")


def chunk_range(st: StreamTensors, lo: int, hi: int,
                factor: bool) -> StreamTensors:
    """The chunks [lo, hi) of the factor (or the solve) stream; the other
    stream is kept whole. Slices along dim 0 stay contiguous views."""
    if factor:
        return dataclasses.replace(
            st, fhm=st.fhm[lo:hi], fev1=st.fev1[lo:hi], fev2=st.fev2[lo:hi],
            fhm_host=st.fhm_host[lo:hi])
    return dataclasses.replace(
        st, scnt=st.scnt[lo:hi], sev1=st.sev1[lo:hi], sev2=st.sev2[lo:hi],
        scnt_host=st.scnt_host[lo:hi])


def _stream_args(st: "StreamTensors", factor: bool) -> dict:
    if factor:
        return dict(fhm=st.fhm, fev1=st.fev1, fev2=st.fev2)
    return dict(scnt=st.scnt, sev1=st.sev1, sev2=st.sev2)


# ---------------------------------------------------------------------------
# shared pieces of the plain versions
# ---------------------------------------------------------------------------

def _col(row: torch.Tensor) -> torch.Tensor:
    """One table row -> a [W, 1] limb column."""
    return row.reshape(-1, 1).long()


def _pass_ref(ev, cnt, tgt, asrc, bsrc, SMT, GT, TZ, flags, flag_slot, *,
              WN, WQ, WV, has_ab):
    """One batched pass (``_pass_body``): gather, compute, scatter."""
    if cnt == 0:
        return
    t, m, d, a, b = ev[:, :cnt].long()
    Wo = tgt.shape[1]
    T = tgt[t].T.long()
    M = SMT[m].T.long()
    if has_ab:
        num = dl.signed_mul_sub_mod(T, M, asrc[a].T.long(),
                                    bsrc[b].T.long(), WN)
    else:
        num = dl.signed_mul_mod(T, M, WN)
    sh = dl.shr_bits(num, TZ[d, :1].T.long())
    q = dl.mul_mod(sh[:WQ], GT[d, :WQ].T.long(), WQ)
    v = dl.signed_mul_mod(q, SMT[d].T.long(), WV)
    bad = (v != dl.sign_extend(num, WV)).any(0)
    ovf = (bad | ~dl.fits_in(q, Wo)[0]).any().to(_I32)
    flags[1] |= ovf
    flags[flag_slot] |= ovf
    tgt[t] = q[:Wo].T.to(_I32)


def _heads_ref(hm, val, SMT, GT, TZ, flags, *, H, W8, WN, WQ, WV):
    """The chunk's pivot heads one after another (``_heads_phase``);
    returns [(k, rho_w)] of the live heads for the lift."""
    nh, fl = int(hm[3 * H]), int(hm[3 * H + 3])
    lifts = []
    R_prev = None
    one = torch.zeros((W8, 1), dtype=torch.int64, device=val.device)
    one[0] = 1
    for t in range(H):
        k = int(hm[t])
        if k < 0:
            continue
        slot, dv = int(hm[H + t]), int(hm[2 * H + t])
        live = t < nh
        x = _col(val[slot])
        if (fl & 256) and dv != k:
            chain = t > 0 and int(hm[t - 1]) == k - 1
            mult = R_prev[:W8] if chain else _col(SMT[k])
            num = dl.signed_mul_mod(x, mult, WN)
            sh = dl.shr_bits(num, TZ[dv, :1].reshape(1, 1).long())
            R = dl.mul_mod(sh[:WQ], _col(GT[dv, :WQ]), WQ)
            v = dl.signed_mul_mod(R, _col(SMT[dv]), WV)
            bad = (v != dl.sign_extend(num, WV)).any()
        else:
            R = dl.sign_extend(x, WQ)
            bad = torch.zeros((), dtype=torch.bool, device=val.device)
        zer = dl.is_zero(R)[0, 0]
        hovf = ~dl.fits_in(R, W8)[0, 0]
        if live:
            flags[0] |= zer.to(_I32)
            flags[1] |= (bad | hovf).to(_I32)
            flags[2] |= (bad | hovf).to(_I32)
        rho_w = torch.where(zer, one, R[:W8])
        SMT[k + 1] = rho_w[:, 0].to(_I32)
        val[slot] = rho_w[:, 0].to(_I32)
        R_prev = R
        if live:
            lifts.append((k, rho_w))
    return lifts


def _lift_ref(lifts, GT, TZ, *, WI8):
    """Hensel lift of the chunk's new pivots (``_lift_phase``)."""
    if not lifts:
        return
    rw = torch.cat([r for _, r in lifts], dim=1)            # [W8, L]
    tz = dl.trailing_zero_bits(rw)
    odd = dl.shr_bits(dl.sign_extend(rw, WI8), tz)
    inv = dl.inverse_mod(odd, WI8)
    rows = torch.tensor([k + 1 for k, _ in lifts], device=GT.device)
    GT[rows] = inv.T.to(_I32)
    TZ[rows] = tz.T.expand(-1, 8).to(_I32)


# ---------------------------------------------------------------------------
# K2: the factor stream
# ---------------------------------------------------------------------------

def _factor_tables(val_in, n, W8, WI8, tables):
    """The stream's tables: the identity start of a first segment, or
    copies of the incoming (widened, re-lifted) ones of a later one."""
    n8 = _r8(n + 2)
    dev = val_in.device
    flags = torch.zeros(8, dtype=_I32, device=dev)
    if tables is not None:
        SMT, GT, TZ = tables
        want = ((n8, W8), (n8, WI8), (n8, 8))
        if tuple(tuple(t.shape) for t in tables) != want:
            raise ValueError(f"factor_stream: incoming tables "
                             f"{[tuple(t.shape) for t in tables]}, the "
                             f"segment needs {list(want)}")
        return val_in.clone(), SMT.clone(), GT.clone(), TZ.clone(), flags
    SMT = torch.zeros((n8, W8), dtype=_I32, device=dev)
    GT = torch.zeros((n8, WI8), dtype=_I32, device=dev)
    TZ = torch.zeros((n8, 8), dtype=_I32, device=dev)
    SMT[0, 0] = 1                     # rho_{-1} = 1, its inverse 1, tz 0
    GT[0, 0] = 1
    return val_in.clone(), SMT, GT, TZ, flags


def factor_stream_ref(st: StreamTensors, val_in, n: int, W8: int, WN: int,
                      WI8: int, tables=None):
    """Plain version of ``factor_stream`` (any device).
    Returns (val, SMT, GT, TZ, flags)."""
    val, SMT, GT, TZ, flags = _factor_tables(val_in, n, W8, WI8, tables)
    WQ, WV = _moduli(W8, W8, WI8)
    H = st.H
    for c in range(st.fhm_host.shape[0]):
        hm = st.fhm_host[c]
        if hm[3 * H] > 0:
            lifts = _heads_ref(hm, val, SMT, GT, TZ, flags, H=H, W8=W8,
                               WN=WN, WQ=WQ, WV=WV)
            _lift_ref(lifts, GT, TZ, WI8=WI8)
        _pass_ref(st.fev1[c], int(hm[3 * H + 1]), val, val, val, SMT, GT,
                  TZ, flags, 3, WN=WN, WQ=WQ, WV=WV, has_ab=False)
        _pass_ref(st.fev2[c], int(hm[3 * H + 2]), val, val, val, SMT, GT,
                  TZ, flags, 4, WN=WN, WQ=WQ, WV=WV, has_ab=True)
    return val, SMT, GT, TZ, flags


def factor_stream(st: StreamTensors, val_in, n: int, W8: int, WN: int,
                  WI8: int, tables=None):
    """Run the factor stream (K2) over a table of n + 2 rows (n = the
    determinant row: ``ndet`` for grouped streams) at segment width W8
    with GT width WI8. tables: None for the first segment, else the
    incoming (SMT, GT, TZ) at this segment's widths, never written.
    Returns (val, SMT, GT, TZ, flags)."""
    if val_in.device.type == "cpu":
        return factor_stream_ref(st, val_in, n, W8, WN, WI8, tables)
    _require_cuda(val_in, "factor_stream")
    tabs = {} if tables is None else dict(zip(("SMT", "GT", "TZ"), tables))
    _check_kernel_args("factor_stream", val_in.device,
                       {"val_in": W8, "fhm": 3 * st.H + 4, "fev1": st.C1,
                        "fev2": st.C2}, val_in=val_in, **tabs,
                       **_stream_args(st, True))
    lib = _build.library().lib
    val, SMT, GT, TZ, flags = _factor_tables(val_in, n, W8, WI8, tables)
    WQ, WV = _moduli(W8, W8, WI8)
    L = max(WN, WQ, WV, WI8, W8)
    obuf = torch.empty((max(st.C1, st.C2), W8), dtype=_I32,
                       device=val.device)
    stream = torch.cuda.current_stream(val.device).cuda_stream
    rc = lib.slip_factor_stream(
        st.fhm.data_ptr(), st.fev1.data_ptr(), st.fev2.data_ptr(),
        val.data_ptr(), SMT.data_ptr(), GT.data_ptr(), TZ.data_ptr(),
        flags.data_ptr(), obuf.data_ptr(), st.fhm.shape[0], st.H, st.C1,
        st.C2, W8, WN, WQ, WV, WI8, L, _nwarps(L), stream)
    _build.check(rc, "factor_stream")
    factor_stream.launches += 1
    return val, SMT, GT, TZ, flags


factor_stream.launches = 0


# ---------------------------------------------------------------------------
# K3: the solve stream
# ---------------------------------------------------------------------------

def solve_stream_ref(st: StreamTensors, val, SMT, GT, TZ, X_in, W8: int,
                     Ws8: int, WNS: int, WI: int):
    """Plain version of ``solve_stream`` (any device). Returns (X, flags)."""
    X = X_in.clone()
    flags = torch.zeros(8, dtype=_I32, device=X.device)
    WQ, WV = _moduli(Ws8, W8, WI)
    for c in range(st.scnt_host.shape[0]):
        cn = st.scnt_host[c]
        _pass_ref(st.sev1[c], int(cn[1]), X, val, X, SMT, GT, TZ, flags, 3,
                  WN=WNS, WQ=WQ, WV=WV, has_ab=False)
        _pass_ref(st.sev2[c], int(cn[2]), X, val, X, SMT, GT, TZ, flags, 4,
                  WN=WNS, WQ=WQ, WV=WV, has_ab=True)
    return X, flags


def solve_stream(st: StreamTensors, val, SMT, GT, TZ, X_in, W8: int,
                 Ws8: int, WNS: int, WI: int):
    """Run the solve stream (K3) over X_in [r8(n+1+nxx), Ws8] with GT at
    width WI (the factor stream's last GT width, re-lifted if the solve
    quotient needs more). Returns (X, flags)."""
    if X_in.device.type == "cpu":
        return solve_stream_ref(st, val, SMT, GT, TZ, X_in, W8, Ws8, WNS,
                                WI)
    _require_cuda(X_in, "solve_stream")
    _check_kernel_args("solve_stream", X_in.device,
                       {"val": W8, "SMT": W8, "GT": WI, "TZ": 8,
                        "X_in": Ws8, "scnt": 4, "sev1": st.C1,
                        "sev2": st.C2}, val=val, SMT=SMT, GT=GT, TZ=TZ,
                       X_in=X_in, **_stream_args(st, False))
    lib = _build.library().lib
    X = X_in.clone()
    flags = torch.zeros(8, dtype=_I32, device=X.device)
    WQ, WV = _moduli(Ws8, W8, WI)
    L = max(WNS, WQ, WV, WI, Ws8)
    obuf = torch.empty((max(st.C1, st.C2), Ws8), dtype=_I32,
                       device=X.device)
    stream = torch.cuda.current_stream(X.device).cuda_stream
    rc = lib.slip_solve_stream(
        st.scnt.data_ptr(), st.sev1.data_ptr(), st.sev2.data_ptr(),
        val.data_ptr(), SMT.data_ptr(), GT.data_ptr(), TZ.data_ptr(),
        X.data_ptr(), flags.data_ptr(), obuf.data_ptr(), st.scnt.shape[0],
        st.C1, st.C2, W8, Ws8, WNS, WQ, WV, WI, L, _nwarps(L), stream)
    _build.check(rc, "solve_stream")
    solve_stream.launches += 1
    return X, flags


solve_stream.launches = 0


# ---------------------------------------------------------------------------
# the whole device half
# ---------------------------------------------------------------------------

def x_tensor(b_col: torch.Tensor, n: int, Ws8: int, nxx: int = 0
             ) -> torch.Tensor:
    """One right-hand side [n, Wb] -> X [r8(n+1+nxx), Ws8], b sign-extended
    (or cut) from Wb to Ws8 limbs. Row n is the solve stream's dummy, the
    nxx rows after it the grouped stream's clone rows."""
    Wb = b_col.shape[1]
    X = torch.zeros((_r8(n + 1 + nxx), Ws8), dtype=_I32, device=b_col.device)
    X[:n, :min(Wb, Ws8)] = b_col[:, :Ws8]
    if Wb < Ws8:
        fill = torch.where(b_col[:, Wb - 1:Wb] >= 0x8000, 0xFFFF, 0)
        X[:n, Wb:] = fill.to(_I32)
    return X


def fused_solve_all(n: int, W8: int, Ws8: int, WN: int, WNS: int, WI8: int,
                    st: StreamTensors, val_in, b_rows, segments=None,
                    ssegments=None, ndet=None, nxx: int = 0) -> torch.Tensor:
    """Factor stream, then each right-hand side's solve stream; returns
    the reference's flat int32 vector for G = 1:

        [per factor segment: fsing, fovf] [det (W8 limbs)]
        [per rhs: per solve segment: ssing, sovf; X (n*Ws8)]

    segments / ssegments: (lo, hi, W8s) chunk ranges of the factor / solve
    stream with nondecreasing widths ending at W8 / Ws8 (None: one
    full-width segment). val_in is packed at segments[0]'s width. Between
    factor segments the value table and SMT sign-extend and GT re-lifts
    (K4); between solve segments X sign-extends (a Hensel inverse truncates
    to an inverse mod any smaller power, so GT needs no re-lift there).
    ndet: the table row of the determinant (grouped streams; default n);
    nxx: the grouped solve stream's extra X rows. b_rows: [nrhs, n, Wb]
    int32 limb rows on the same device as val_in. WN and WNS are kept for
    the reference's signature: every segment derives its own."""
    if ndet is None:
        ndet = n
    if segments is None:
        segments = ((0, st.fhm.shape[0], W8),)
    S = len(segments)
    val, SMT, GT, TZ = val_in, None, None, None
    parts, prev = [], None
    for lo, hi, W8s in segments:
        # segmented runs lift head inverses only to the segment's short
        # division modulus; GT re-lifts at each boundary (K4), and once
        # more below if the solve quotient needs more
        WQf = _r8(W8s + 2)
        WIs = max(WQf, WI8) if S == 1 else WQf
        tables = None
        if prev is not None:
            pW8, pWI = prev
            val = widen_val(val, pW8, W8s)
            SMT = widen_tc(SMT, pW8, W8s)
            GT = relift_gt(SMT, GT, TZ, W8s, pWI, WIs)
            tables = (SMT, GT, TZ)
        val, SMT, GT, TZ, fflags = factor_stream(
            chunk_range(st, lo, hi, True), val, ndet, W8s, _r8(2 * W8s + 2),
            WIs, tables)
        parts.append(fflags[:2])
        prev = (W8s, WIs)
    parts.append(SMT[ndet, :W8])
    if ssegments is None:
        ssegments = ((0, st.scnt.shape[0], Ws8),)
    WQs = min(WI8, _r8(Ws8 + 2))      # the solve stream's quotient modulus
    WIf = prev[1]
    if WIf < WQs:
        GT = relift_gt(SMT, GT, TZ, W8, WIf, WQs)
        WIf = WQs
    for c in range(b_rows.shape[0]):
        pWs = ssegments[0][2]
        X = x_tensor(b_rows[c], n, pWs, nxx)
        for lo, hi, Ws_s in ssegments:
            if Ws_s != pWs:
                X = widen_tc(X, pWs, Ws_s)
            X, sflags = solve_stream(chunk_range(st, lo, hi, False), val,
                                     SMT, GT, TZ, X, W8, Ws_s,
                                     _r8(W8 + Ws_s + 2), WIf)
            parts.append(sflags[:2])
            pWs = Ws_s
        parts.append(X[:n, :Ws8].reshape(-1))
    return torch.cat(parts)


# ---------------------------------------------------------------------------
# host-side packing helpers (two's complement)
# ---------------------------------------------------------------------------

def ints_to_tc_rows(values, W: int) -> np.ndarray:
    """Python ints -> [len, W] int32 two's-complement 16-bit limb rows.

    int64-range values take a vectorized path (arithmetic right shift
    produces exactly the two's-complement limbs; limbs above bit 63 are
    the sign fill) — the per-entry loop only runs for wider ints.
    """
    out = np.zeros((len(values), W), dtype=np.int32)
    try:
        a64 = np.array(values, dtype=np.int64)
    except (OverflowError, TypeError):
        a64 = None
    if a64 is not None:
        if len(values):
            k = min(W, 4)
            shifts = (16 * np.arange(k, dtype=np.int64))[None, :]
            out[:, :k] = ((a64[:, None] >> shifts) & 0xFFFF).astype(np.int32)
            if W > 4:
                out[:, 4:] = np.where(a64[:, None] < 0, 0xFFFF, 0)
        return out
    mod = 1 << (16 * W)
    for r, v in enumerate(values):
        u = int(v) % mod
        b = u.to_bytes(2 * W, "little")
        out[r] = np.frombuffer(b, dtype="<u2").astype(np.int32)
    return out


def tc_rows_to_ints(rows: np.ndarray) -> list:
    """[R, W] limb rows -> Python ints (signed)."""
    R, W = rows.shape
    arr = rows.astype(np.uint16)
    # vectorized path: rows whose payload fits in int64 (all limbs above
    # the third are pure sign fill) combine exactly inside int64
    if W >= 4:
        neg = arr[:, 3] >= 0x8000
        fill = np.where(neg, 0xFFFF, 0).astype(np.uint16)
        if W == 4 or bool((arr[:, 4:] == fill[:, None]).all()):
            u = np.zeros(R, dtype=np.uint64)
            for k in range(4):
                u |= arr[:, k].astype(np.uint64) << (16 * k)
            return u.astype(np.int64).tolist()
    half = 1 << (16 * W - 1)
    mod = 1 << (16 * W)
    out = []
    for r in range(R):
        u = int.from_bytes(arr[r].tobytes(), "little")
        out.append(u - mod if u >= half else u)
    return out
