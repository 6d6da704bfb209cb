"""The fused exact solve's device half: factor stream, solve stream, and
the one flat result vector.

Counterpart of ``slip_lu_tpu/tpu/factor_fused.py``: one system, or G
pattern-sharing systems run together (member rows, ``fused_solve_many``),
with several right-hand sides of one system run as the lanes of one
solve-stream run, width segments (the tables widen between segments, GT
re-lifts in kernel K4, ``gpu/relift.py``) and grouped (subtree-local)
streams (``ndet``, ``nxx``, the extra value slots). The factor stream
(kernel K2, ``csrc/fused.cu:factor_stream_kernel``) runs, per chunk, the
pivot heads, the Hensel lift of the new pivot inverses, and two passes of

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
  * flags: rows 0 sing, 1 any overflow, 2 heads, 3 pass 1, 4 pass 2 (the
    reference's ``facc`` rows), one column a member: int32[8] for one
    member, [8, G] for G;
  * members (the reference's member-lane batching): a table with member
    rows keeps logical row r of member g at row r*G + g; members never
    read each other's rows, so the kernels run member g on block g and
    the plain versions put the members on a tensor dimension.

The tables use the reference's shapes (rows padded to multiples of 8 for
one member, (n+2)*G table rows and E8*G value rows for G). The lane
count is exact: the reference pads lanes to a multiple of 8 on TPU
hardware (``lane_group``) and not in interpret mode, and a GPU needs no
lane alignment, so the flat vector equals the interpret-mode
reference's. The wrappers never write their inputs: ``val_in`` is
cloned, so a caller may cache and reuse it.
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

def _members(tab: torch.Tensor, m: int) -> torch.Tensor:
    """A table with m member rows per logical row (m = G, or 1 when the
    members share it) as an [R, m, W] view: logical row r of member g is
    row r*m + g. Pad rows past the last whole logical row are left out."""
    R = tab.shape[0] // m
    return tab[:R * m].unflatten(0, (R, m))


def _lanes(tab3: torch.Tensor, idx, G: int) -> torch.Tensor:
    """Logical rows idx of an [R, m, W] member view as limb columns
    [W, len(idx) * G], lane e*G + g; a shared table (m = 1) repeats its
    row on every member's lane."""
    rows = tab3[idx]                                       # [k, m, W]
    return rows.expand(-1, G, -1).reshape(-1, tab3.shape[2]).T.long()


def _new_flags(G: int, device) -> torch.Tensor:
    """Zero flags: int32[8] for one member, [8, G] for G."""
    return torch.zeros(8 if G == 1 else (8, G), dtype=_I32, device=device)


def _pass_ref(ev, cnt, tgt, asrc, bsrc, SMT, GT, TZ, flags, flag_slot, *,
              WN, WQ, WV, has_ab, G=1, a_g=True, tab_g=True):
    """One batched pass (``_pass_body``): gather, compute, scatter, every
    member of G on its own lanes. tgt and bsrc have G member rows per
    logical row; asrc has them if a_g, SMT / GT / TZ if tab_g."""
    if cnt == 0:
        return
    ms = G if tab_g else 1
    t, m, d, a, b = ev[:, :cnt].long()
    T3, S3 = _members(tgt, G), _members(SMT, ms)
    Wo = tgt.shape[1]
    T, M = _lanes(T3, t, G), _lanes(S3, m, G)
    if has_ab:
        num = dl.signed_mul_sub_mod(
            T, M, _lanes(_members(asrc, G if a_g else 1), a, G),
            _lanes(_members(bsrc, G), b, G), WN)
    else:
        num = dl.signed_mul_mod(T, M, WN)
    sh = dl.shr_bits(num, _lanes(_members(TZ, ms), d, G)[:1])
    q = dl.mul_mod(sh[:WQ], _lanes(_members(GT, ms), d, G)[:WQ], WQ)
    v = dl.signed_mul_mod(q, _lanes(S3, d, G), WV)
    bad = (v != dl.sign_extend(num, WV)).any(0)
    ovf = (bad | ~dl.fits_in(q, Wo)[0]).view(cnt, G).any(0).to(_I32)
    fl = flags.view(8, G)             # one column a member
    fl[1] |= ovf
    fl[flag_slot] |= ovf
    T3[t] = q[:Wo].T.reshape(cnt, G, Wo).to(_I32)


def _heads_ref(hm, val, SMT, GT, TZ, flags, *, H, W8, WN, WQ, WV,
               diag=None, G=1):
    """The chunk's pivot heads one after another (``_heads_phase``), each
    on every member of G at once; returns [(k, rho_w [W8, G])] of the live
    heads for the lift. diag: None to read head t's diagonal from
    val[slot], else from row t of diag (the sharded path's all-reduced
    diagonals, the reference's ``diag_ext``; one member)."""
    nh, fl = int(hm[3 * H]), int(hm[3 * H + 3])
    V3, S3, G3, Z3 = (_members(t, G) for t in (val, SMT, GT, TZ))
    f2 = flags.view(8, G)             # one column a member
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
        x = (V3[slot] if diag is None else diag[t:t + 1]).T.long()
        if (fl & 256) and dv != k:
            chain = t > 0 and int(hm[t - 1]) == k - 1
            mult = R_prev[:W8] if chain else S3[k].T.long()
            num = dl.signed_mul_mod(x, mult, WN)
            sh = dl.shr_bits(num, Z3[dv, :, :1].T.long())
            R = dl.mul_mod(sh[:WQ], G3[dv, :, :WQ].T.long(), WQ)
            v = dl.signed_mul_mod(R, S3[dv].T.long(), WV)
            bad = (v != dl.sign_extend(num, WV)).any(0)
        else:
            R = dl.sign_extend(x, WQ)
            bad = torch.zeros(G, dtype=torch.bool, device=val.device)
        zer = dl.is_zero(R)[0]
        hovf = ~dl.fits_in(R, W8)[0]
        if live:
            f2[0] |= zer.to(_I32)
            f2[1] |= (bad | hovf).to(_I32)
            f2[2] |= (bad | hovf).to(_I32)
        rho_w = torch.where(zer, one, R[:W8])
        S3[k + 1] = rho_w.T.to(_I32)
        V3[slot] = rho_w.T.to(_I32)
        R_prev = R
        if live:
            lifts.append((k, rho_w))
    return lifts


def _lift_ref(lifts, GT, TZ, *, WI8, G=1):
    """Hensel lift of the chunk's new pivots (``_lift_phase``), every
    member's at once."""
    if not lifts:
        return
    rw = torch.cat([r for _, r in lifts], dim=1)            # [W8, L*G]
    tz = dl.trailing_zero_bits(rw)
    odd = dl.shr_bits(dl.sign_extend(rw, WI8), tz)
    inv = dl.inverse_mod(odd, WI8)
    rows = torch.tensor([k + 1 for k, _ in lifts], device=GT.device)
    nl = len(lifts)
    _members(GT, G)[rows] = inv.T.reshape(nl, G, WI8).to(_I32)
    _members(TZ, G)[rows] = tz.T.reshape(nl, G, 1).expand(-1, -1, 8).to(
        _I32)


# ---------------------------------------------------------------------------
# K2: the factor stream
# ---------------------------------------------------------------------------

def _factor_tables(val_in, n, W8, WI8, tables, G):
    """The stream's tables, of the reference's shapes (r8(n + 2) rows for
    one member, (n + 2) * G member rows for G): the identity start of a
    first segment (rows 0..G-1, logical row 0 of every member), or copies
    of the incoming (widened, re-lifted) ones of a later one."""
    n8 = _r8(n + 2) if G == 1 else (n + 2) * G
    dev = val_in.device
    flags = _new_flags(G, dev)
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
    SMT[:G, 0] = 1                    # rho_{-1} = 1, its inverse 1, tz 0
    GT[:G, 0] = 1
    return val_in.clone(), SMT, GT, TZ, flags


def factor_stream_ref(st: StreamTensors, val_in, n: int, W8: int, WN: int,
                      WI8: int, tables=None, G: int = 1):
    """Plain version of ``factor_stream`` (any device).
    Returns (val, SMT, GT, TZ, flags)."""
    val, SMT, GT, TZ, flags = _factor_tables(val_in, n, W8, WI8, tables, G)
    WQ, WV = _moduli(W8, W8, WI8)
    H = st.H
    for c in range(st.fhm_host.shape[0]):
        hm = st.fhm_host[c]
        if hm[3 * H] > 0:
            lifts = _heads_ref(hm, val, SMT, GT, TZ, flags, H=H, W8=W8,
                               WN=WN, WQ=WQ, WV=WV, G=G)
            _lift_ref(lifts, GT, TZ, WI8=WI8, G=G)
        _pass_ref(st.fev1[c], int(hm[3 * H + 1]), val, val, val, SMT, GT,
                  TZ, flags, 3, WN=WN, WQ=WQ, WV=WV, has_ab=False, G=G)
        _pass_ref(st.fev2[c], int(hm[3 * H + 2]), val, val, val, SMT, GT,
                  TZ, flags, 4, WN=WN, WQ=WQ, WV=WV, has_ab=True, G=G)
    return val, SMT, GT, TZ, flags


def _check_members(what: str, G: int, **tables) -> None:
    """Tables with member rows hold whole logical rows of G members."""
    if G < 1:
        raise ValueError(f"{what}: member count G={G}")
    for name, t in tables.items():
        if t.shape[0] % G:
            raise ValueError(f"{what}: {name} has {t.shape[0]} rows, not a "
                             f"multiple of the {G} members")


def factor_stream(st: StreamTensors, val_in, n: int, W8: int, WN: int,
                  WI8: int, tables=None, G: int = 1):
    """Run the factor stream (K2) over a table of n + 2 logical rows (n =
    the determinant row: ``ndet`` for grouped streams) at segment width
    W8 with GT width WI8. tables: None for the first segment, else the
    incoming (SMT, GT, TZ) at this segment's widths, never written.

    G > 1: G pattern-sharing systems, every table with G member rows per
    logical row (val_in [E8*G, W8], slot-interleaved: row slot*G + g;
    tables [(n+2)*G, .]); the kernel runs member g on block g. Flags
    come back as [8, G], one column a member (int32[8] for G = 1).
    Returns (val, SMT, GT, TZ, flags)."""
    if val_in.device.type == "cpu":
        return factor_stream_ref(st, val_in, n, W8, WN, WI8, tables, G)
    _require_cuda(val_in, "factor_stream")
    tabs = {} if tables is None else dict(zip(("SMT", "GT", "TZ"), tables))
    _check_kernel_args("factor_stream", val_in.device,
                       {"val_in": W8, "fhm": 3 * st.H + 4, "fev1": st.C1,
                        "fev2": st.C2}, val_in=val_in, **tabs,
                       **_stream_args(st, True))
    _check_members("factor_stream", G, val_in=val_in)
    lib = _build.library().lib
    val, SMT, GT, TZ, flags = _factor_tables(val_in, n, W8, WI8, tables, G)
    WQ, WV = _moduli(W8, W8, WI8)
    L = max(WN, WQ, WV, WI8, W8)
    obuf = torch.empty((G, max(st.C1, st.C2), W8), dtype=_I32,
                       device=val.device)
    stream = torch.cuda.current_stream(val.device).cuda_stream
    rc = lib.slip_factor_stream(
        st.fhm.data_ptr(), st.fev1.data_ptr(), st.fev2.data_ptr(),
        val.data_ptr(), SMT.data_ptr(), GT.data_ptr(), TZ.data_ptr(),
        flags.data_ptr(), obuf.data_ptr(), st.fhm.shape[0], st.H, st.C1,
        st.C2, W8, WN, WQ, WV, WI8, L, _nwarps(L), G, stream)
    _build.check(rc, "factor_stream")
    factor_stream.launches += 1
    factor_stream.member_launches += G > 1
    factor_stream.blocks += G
    return val, SMT, GT, TZ, flags


factor_stream.launches = 0          # every launch
factor_stream.member_launches = 0   # launches of G > 1 systems
factor_stream.blocks = 0            # blocks launched: one a member


# ---------------------------------------------------------------------------
# K3: the solve stream
# ---------------------------------------------------------------------------

def solve_stream_ref(st: StreamTensors, val, SMT, GT, TZ, X_in, W8: int,
                     Ws8: int, WNS: int, WI: int, G: int = 1,
                     a_g: bool = True, tab_g: bool = True):
    """Plain version of ``solve_stream`` (any device). Returns (X, flags)."""
    X = X_in.clone()
    flags = _new_flags(G, X.device)
    WQ, WV = _moduli(Ws8, W8, WI)
    for c in range(st.scnt_host.shape[0]):
        cn = st.scnt_host[c]
        _pass_ref(st.sev1[c], int(cn[1]), X, val, X, SMT, GT, TZ, flags, 3,
                  WN=WNS, WQ=WQ, WV=WV, has_ab=False, G=G, a_g=a_g,
                  tab_g=tab_g)
        _pass_ref(st.sev2[c], int(cn[2]), X, val, X, SMT, GT, TZ, flags, 4,
                  WN=WNS, WQ=WQ, WV=WV, has_ab=True, G=G, a_g=a_g,
                  tab_g=tab_g)
    return X, flags


def solve_stream(st: StreamTensors, val, SMT, GT, TZ, X_in, W8: int,
                 Ws8: int, WNS: int, WI: int, G: int = 1, a_g: bool = True,
                 tab_g: bool = True):
    """Run the solve stream (K3) over X_in [r8((n+1+nxx)*G), Ws8] with GT
    at width WI (the factor stream's last GT width, re-lifted if the solve
    quotient needs more). Returns (X, flags).

    G > 1: X has G member rows per logical row (row j*G + g). a_g / tab_g
    say whether the value table / SMT, GT, TZ have member rows too (G
    pattern-sharing systems) or are shared (G right-hand sides of one
    system, the reference's right-hand-side lanes). Flags: [8, G]."""
    if X_in.device.type == "cpu":
        return solve_stream_ref(st, val, SMT, GT, TZ, X_in, W8, Ws8, WNS,
                                WI, G, a_g, tab_g)
    _require_cuda(X_in, "solve_stream")
    _check_kernel_args("solve_stream", X_in.device,
                       {"val": W8, "SMT": W8, "GT": WI, "TZ": 8,
                        "X_in": Ws8, "scnt": 4, "sev1": st.C1,
                        "sev2": st.C2}, val=val, SMT=SMT, GT=GT, TZ=TZ,
                       X_in=X_in, **_stream_args(st, False))
    _check_members("solve_stream", G, **(dict(val=val) if a_g else {}),
                   **(dict(SMT=SMT, GT=GT, TZ=TZ) if tab_g else {}))
    lib = _build.library().lib
    X = X_in.clone()
    flags = _new_flags(G, X.device)
    WQ, WV = _moduli(Ws8, W8, WI)
    L = max(WNS, WQ, WV, WI, Ws8)
    obuf = torch.empty((G, max(st.C1, st.C2), Ws8), dtype=_I32,
                       device=X.device)
    stream = torch.cuda.current_stream(X.device).cuda_stream
    rc = lib.slip_solve_stream(
        st.scnt.data_ptr(), st.sev1.data_ptr(), st.sev2.data_ptr(),
        val.data_ptr(), SMT.data_ptr(), GT.data_ptr(), TZ.data_ptr(),
        X.data_ptr(), flags.data_ptr(), obuf.data_ptr(), st.scnt.shape[0],
        st.C1, st.C2, W8, Ws8, WNS, WQ, WV, WI, L, _nwarps(L), G,
        int(a_g), int(tab_g), stream)
    _build.check(rc, "solve_stream")
    solve_stream.launches += 1
    solve_stream.member_launches += G > 1 and tab_g
    solve_stream.lane_launches += G > 1 and not tab_g
    solve_stream.blocks += G
    return X, flags


solve_stream.launches = 0           # every launch
solve_stream.member_launches = 0    # launches of G > 1 systems
solve_stream.lane_launches = 0      # launches of G > 1 right-hand sides
solve_stream.blocks = 0             # blocks launched: one a member


# ---------------------------------------------------------------------------
# the whole device half
# ---------------------------------------------------------------------------

def x_tensor(b: torch.Tensor, n: int, Ws8: int, nxx: int = 0
             ) -> torch.Tensor:
    """Right-hand sides -> X. b: one column [n, Wb], or L lanes [L, n, Wb]
    (members, or right-hand sides of one system). X is
    [r8((n+1+nxx)*L), Ws8] with row j*L + l, b sign-extended (or cut)
    from Wb to Ws8 limbs. Logical row n is the solve stream's dummy, the
    nxx rows after it the grouped stream's clone rows."""
    cols = b if b.dim() == 3 else b[None]
    L, _, Wb = cols.shape
    rows = cols.transpose(0, 1).reshape(n * L, Wb)
    X = torch.zeros((_r8((n + 1 + nxx) * L), Ws8), dtype=_I32,
                    device=b.device)
    X[:n * L, :min(Wb, Ws8)] = rows[:, :Ws8]
    if Wb < Ws8:
        fill = torch.where(rows[:, Wb - 1:Wb] >= 0x8000, 0xFFFF, 0)
        X[:n * L, Wb:] = fill.to(_I32)
    return X


def fused_solve_all(n: int, W8: int, Ws8: int, WN: int, WNS: int, WI8: int,
                    st: StreamTensors, val_in, b_rows, segments=None,
                    ssegments=None, ndet=None, nxx: int = 0,
                    G: int = 1) -> torch.Tensor:
    """Factor stream, then the solve stream; returns the reference's flat
    int32 vector. For one system (G = 1) and one right-hand side:

        [per factor segment: fsing, fovf] [det (W8 limbs)]
        [per solve segment: ssing, sovf] [X (n*Ws8)]

    With nrhs > 1 right-hand sides of one system (b_rows [nrhs, n, Wb]),
    all of them run as the lanes of ONE solve-stream run (the reference's
    right-hand-side lanes: X rows j*nrhs + c, the factored tables shared),
    and the tail is [per solve segment: ssing*nrhs, sovf*nrhs]
    [X (n*nrhs*Ws8), rows j*nrhs + c].

    G > 1 pattern-sharing systems (val_in slot-interleaved [E8*G, .], row
    slot*G + g; b_rows [G, nrhs, n, Wb]): every chunk runs on all G
    members, and the layout generalizes per member, the reference's:
    [per factor segment: sing*G, ovf*G] [det: G*W8] [per rhs: per solve
    segment: sing*G, ovf*G; X: n*G*Ws8, rows j*G + g].

    segments / ssegments: (lo, hi, W8s) chunk ranges of the factor / solve
    stream with nondecreasing widths ending at W8 / Ws8 (None: one
    full-width segment). val_in is packed at segments[0]'s width. Between
    factor segments the value table and SMT sign-extend and GT re-lifts
    (K4); between solve segments X sign-extends (a Hensel inverse truncates
    to an inverse mod any smaller power, so GT needs no re-lift there).
    ndet: the table row of the determinant (grouped streams; default n);
    nxx: the grouped solve stream's extra X rows. b_rows lies on the same
    device as val_in. WN and WNS are kept for the reference's signature:
    every segment derives its own."""
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
            WIs, tables, G)
        parts.append(fflags[:2].reshape(-1))
        prev = (W8s, WIs)
    parts.append(SMT[ndet * G:(ndet + 1) * G, :W8].reshape(-1))
    if ssegments is None:
        ssegments = ((0, st.scnt.shape[0], Ws8),)
    WQs = min(WI8, _r8(Ws8 + 2))      # the solve stream's quotient modulus
    WIf = prev[1]
    if WIf < WQs:
        GT = relift_gt(SMT, GT, TZ, W8, WIf, WQs)
        WIf = WQs
    if G == 1:
        b_rows = b_rows[None]
    nrhs = b_rows.shape[1]
    if G == 1 and nrhs > 1:
        # right-hand-side lanes: one run, X per lane, the tables shared
        runs = [(b_rows[0], nrhs, False)]
    else:
        runs = [(b_rows[:, c], G, True) for c in range(nrhs)]
    for cols, lanes, own in runs:
        pWs = ssegments[0][2]
        X = x_tensor(cols, n, pWs, nxx)
        for lo, hi, Ws_s in ssegments:
            if Ws_s != pWs:
                X = widen_tc(X, pWs, Ws_s)
            X, sflags = solve_stream(chunk_range(st, lo, hi, False), val,
                                     SMT, GT, TZ, X, W8, Ws_s,
                                     _r8(W8 + Ws_s + 2), WIf, lanes, own,
                                     own)
            parts.append(sflags[:2].reshape(-1))
            pWs = Ws_s
        parts.append(X[:n * lanes, :Ws8].reshape(-1))
    return torch.cat(parts)


def fused_solve_many(n: int, W8: int, Ws8: int, WN: int, WNS: int,
                     WI8: int, G: int, st: StreamTensors, val_stack,
                     b_stack, segments=None) -> torch.Tensor:
    """G pattern-sharing systems in one device half: the stream is shared,
    each member brings its value table (val_stack [G, E8, W8s]) and its
    right-hand sides (b_stack [G, nrhs, n, Wb]), and every chunk runs on
    all G members (``fused_solve_all`` with G; the reference's
    ``val_stack`` interleave, row slot*G + g). Returns the G-aware flat
    vector; a family of one is one system, whose right-hand sides run as
    lanes."""
    val_il = val_stack.transpose(0, 1).reshape(-1, val_stack.shape[2])
    return fused_solve_all(n, W8, Ws8, WN, WNS, WI8, st, val_il,
                           b_stack[0] if G == 1 else b_stack,
                           segments=segments, G=G)


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
