"""The sharded fused exact solve's device half: kernels K6 and K7 and the
chunk loop over the ranks of a ``torch.distributed`` group.

Counterpart of ``slip_lu_tpu/parallel/factor_fused_shard.py``. Every rank
runs the same chunk sequence over its own slice of each chunk (events
binned by the target row's owner, cyclic), so per chunk (one sharded
superstep):

    owner-masked diagonal gather -> psum -> K6 -> psum(bc) -> K7

  * K6 (``ab_chunk``, ``csrc/fused_shard.cu:ab_chunk_kernel``): the
    chunk's heads, replicated on every rank from the summed diagonals (so
    SMT, GT and TZ stay bit-identical everywhere), the Hensel lift, the
    rank's pass 1, and the owner-masked gather of the pass-2 B operands;
  * K7 (``c_chunk``, ``c_chunk_kernel``): the rank's pass 2, its B
    operands read by position from the summed broadcast buffer.

The value table is partitioned (each rank holds its owned slots plus a
dummy row); the solve scans keep the full X on every rank and sum only
its owned rows at the end. Each wrapper takes its kernel for CUDA tensors
and its plain PyTorch version (``*_ref``, beside it) for CPU tensors; any
other device raises. The wrappers work in place on the tables (the
reference aliases them), which keeps one copy of each on the device.

Left behind as TPU-only: the HBM plane layout of the value table
(``hbm_segs``, ``KR``, the row DMAs); the port keeps one row layout.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..gpu import _build
from ..gpu.factor_fused import (_heads_ref, _lift_ref, _moduli, _nwarps,
                                _pass_ref, _r8, _require_cuda)
from ..gpu.relift import relift_gt, widen_tc, widen_val
from .shard import psum

_I32 = torch.int32


# ---------------------------------------------------------------------------
# one rank's streams on its device
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ShardChunks:
    """One rank's slice of one sharded chunk stream on its device.

    meta [nc, 3H+5] holds a chunk's head block and counts in one row: H
    head steps (pad -1), H LOCAL diag slots (the dummy row off the owner),
    H diag histories, the counts (heads, pass-1 events, pass-2 events, flag
    bits) and the broadcast count. The solve stream has no heads (H = 0).
    meta_host is the same array on the host: the chunk loop and the plain
    versions branch on it without reading the device. top: the largest
    index of each kind in the stream, for the range check."""
    H: int
    C1: int
    C2: int
    CB8: int
    meta: torch.Tensor            # [nc, 3H+5]
    hsl: Optional[torch.Tensor]   # [nc, H] int64 local diag slots (factor)
    mdiag: Optional[torch.Tensor]  # [nc, H, 1] 1 where this rank owns it
    ev1: torch.Tensor             # [nc, 5, C1] field-major (t, m, d, a, b)
    ev2: torch.Tensor             # [nc, 5, C2]
    bidx: torch.Tensor            # [nc, CB8] broadcast rows
    mbc: torch.Tensor             # [nc, CB8] 1 where this rank owns the row
    meta_host: np.ndarray
    top: dict
    # per array name: its address and row size; per kernel: the table
    # sizes its indices were checked against
    rows: dict = dataclasses.field(default_factory=dict)
    checked: dict = dataclasses.field(default_factory=dict)

    @property
    def nchunks(self) -> int:
        return int(self.meta_host.shape[0])

    def ptr(self, name: str, c: int) -> int:
        """Device address of chunk c's row of the stream array ``name``
        (the array's address and row size are looked up once)."""
        base = self.rows.get(name)
        if base is None:
            t = getattr(self, name)
            base = self.rows[name] = (t.data_ptr(),
                                      t.stride(0) * t.element_size())
        return base[0] + c * base[1]


@dataclasses.dataclass
class RankStreams:
    factor: ShardChunks
    solve: ShardChunks
    xown: torch.Tensor            # [r8(n)] 1 where this rank owns X row i


def _top(a) -> int:
    a = np.asarray(a)
    if a.size and a.min() < 0:
        raise ValueError("fused_sharded_solve: a negative stream index")
    return int(a.max()) + 1 if a.size else 0


def _chunks(device, cnt, ev1, ev2, bidx, bcnt, mbc, hs=None, hsl=None,
            hd=None, mdiag=None) -> ShardChunks:
    heads = () if hs is None else (hs, hsl, hd)
    meta = np.concatenate(heads + (cnt, np.asarray(bcnt)[:, None]),
                          axis=1).astype(np.int32)
    ev1, ev2 = np.asarray(ev1), np.asarray(ev2)
    # rows each index must find: the target table (t), the tables of
    # pivots (m, d; a head k writes row k + 1), the A and B sources
    top = {"t": max(_top(ev1[:, 0]), _top(ev2[:, 0])),
           "md": max(_top(ev1[:, 1:3]), _top(ev2[:, 1:3])),
           "a": _top(ev2[:, 3]), "b": _top(ev2[:, 4]), "bidx": _top(bidx),
           "k": 0 if hs is None else _top(np.maximum(hs, -1) + 1),
           "slot": 0 if hs is None else _top(hsl),
           "hd": 0 if hs is None else _top(hd)}

    def dev(a, dtype=None):
        return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(device)

    H = 0 if hs is None else int(hs.shape[1])
    return ShardChunks(
        H=H, C1=int(ev1.shape[2]), C2=int(ev2.shape[2]),
        CB8=int(bidx.shape[1]), meta=dev(meta),
        hsl=None if hs is None else dev(hsl, np.int64),
        mdiag=None if hs is None else dev(np.asarray(mdiag)[:, :, None],
                                          np.int32),
        ev1=dev(ev1, np.int32), ev2=dev(ev2, np.int32),
        bidx=dev(bidx, np.int32), mbc=dev(mbc, np.int32), meta_host=meta,
        top=top)


def rank_streams(rank: int, device, fhs, fhsl, fhd, f_mdiag, f_cnt, f_ev1,
                 f_ev2, f_bidx, f_bcnt, f_mbc, s_cnt, s_ev1, s_ev2, s_bidx,
                 s_bcnt, s_mbc, xown) -> RankStreams:
    """This rank's slice of the reference's stream arrays (the arguments of
    its ``fused_sharded_solve``, numpy, rank-major where the reference
    shards them: fhsl, f_mdiag, f_cnt, f_ev1/2, f_bidx, f_mbc, s_cnt,
    s_ev1/2, s_mbc, xown), on ``device``. Events are field-major."""
    r = rank
    factor = _chunks(device, f_cnt[r], f_ev1[r], f_ev2[r], f_bidx[r], f_bcnt,
                     f_mbc[r], hs=fhs, hsl=fhsl[r], hd=fhd,
                     mdiag=f_mdiag[r])
    solve = _chunks(device, s_cnt[r], s_ev1[r], s_ev2[r], s_bidx, s_bcnt,
                    s_mbc[r])
    return RankStreams(factor, solve, torch.from_numpy(
        np.ascontiguousarray(xown[r], np.int32)).to(device))


def _check_rows(what, ch: ShardChunks, tgt_rows: int, n8: int,
                a_rows=None) -> None:
    """Every row index the kernel reads lies inside its table (JAX clamps a
    gather out of range; a CUDA kernel would read past the table). a_rows:
    the A operands' table (None: the kernel reads none). Checked once per
    kernel, stream and table sizes."""
    key = (tgt_rows, n8, a_rows)
    if ch.checked.get(what) == key:
        return
    b_rows = ch.CB8 if ch.H else tgt_rows     # factor: bc positions
    rows = [("t", tgt_rows), ("bidx", tgt_rows), ("slot", tgt_rows),
            ("b", b_rows), ("md", n8), ("k", n8), ("hd", n8)]
    if a_rows is not None:
        rows.append(("a", a_rows))
    for name, hi in rows:
        if ch.top[name] > hi:
            raise ValueError(f"{what}: a stream index ({name}) lies outside "
                             f"its table of {hi} rows")
    ch.checked[what] = key


# ---------------------------------------------------------------------------
# K6 and K7
# ---------------------------------------------------------------------------

def _widths(val, SMT, GT):
    W8, Wt, WI8 = SMT.shape[1], val.shape[1], GT.shape[1]
    WN = _r8(W8 + Wt + 2)
    WQ, WV = _moduli(Wt, W8, WI8)
    return W8, Wt, WI8, WN, WQ, WV


def _check(what, ch, dev, Wt, **tensors) -> None:
    """What the kernels take: contiguous int32 tensors on the stream's
    device."""
    if ch.meta.device != dev:
        raise ValueError(f"{what}: the stream lies on {ch.meta.device}, the "
                         f"tables on {dev}")
    for name, t in tensors.items():
        if t is None:
            continue
        if t.device != dev or t.dtype != _I32 or not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be a contiguous int32 "
                             f"tensor on {dev}, not {t.dtype} on {t.device}")
    if tensors["bc"].shape != (ch.CB8, Wt):
        raise ValueError(f"{what}: bc is {tuple(tensors['bc'].shape)}, the "
                         f"stream needs ({ch.CB8}, {Wt})")


def _check_chunk(what, ch, c) -> None:
    if not 0 <= c < ch.nchunks:
        raise IndexError(f"{what}: chunk {c} of a stream of {ch.nchunks}")


def ab_chunk_ref(ch: ShardChunks, c: int, diag_b, val, SMT, GT, TZ, flags,
                 bc_out):
    """Plain version of ``ab_chunk`` (any device)."""
    hm, H = ch.meta_host[c], ch.H
    W8, Wt, WI8, WN, WQ, WV = _widths(val, SMT, GT)
    if H and hm[3 * H] > 0:
        lifts = _heads_ref(hm, val, SMT, GT, TZ, flags, H=H, W8=W8, WN=WN,
                           WQ=WQ, WV=WV, diag=diag_b)
        _lift_ref(lifts, GT, TZ, WI8=WI8)
    _pass_ref(ch.ev1[c], int(hm[3 * H + 1]), val, val, val, SMT, GT, TZ,
              flags, 3, WN=WN, WQ=WQ, WV=WV, has_ab=False)
    bc_out.zero_()
    nb = int(hm[3 * H + 4])
    if nb:
        bc_out[:nb] = val[ch.bidx[c, :nb].long()] * ch.mbc[c, :nb, None]
    return bc_out


def _stream(t, stream):
    return torch.cuda.current_stream(t.device).cuda_stream \
        if stream is None else stream


def ab_chunk(ch: ShardChunks, c: int, diag_b, val, SMT, GT, TZ, flags,
             bc_out, obuf=None, stream=None):
    """K6 on chunk c of this rank's stream ``ch``.

    Factor stream (ch.H > 0): the chunk's heads from diag_b [H, W8] (the
    summed diagonals; None or unread in a chunk without heads), the lift,
    pass 1 over the rank's value table val [Lp8, W8]. Solve stream: pass 1
    over X (val [X8, Ws]). Then the owner-masked gather of the B operands
    into bc_out [CB8, Wt]. Works in place on val, SMT, GT, TZ and the flags
    (int32[8], accumulated); obuf: optional scratch [>= C1, Wt]; stream:
    the CUDA stream's handle (default: the current stream). Returns
    bc_out."""
    if val.device.type == "cpu":
        return ab_chunk_ref(ch, c, diag_b, val, SMT, GT, TZ, flags, bc_out)
    _require_cuda(val, "ab_chunk")
    _check_chunk("ab_chunk", ch, c)
    W8, Wt, WI8, WN, WQ, WV = _widths(val, SMT, GT)
    H = ch.H
    heads = H > 0 and ch.meta_host[c, 3 * H] > 0
    if H and Wt != W8 or heads and (diag_b is None
                                    or diag_b.shape != (H, W8)):
        raise ValueError(f"ab_chunk: the factor stream needs val and diag_b "
                         f"of W8 = {W8} limbs")
    if obuf is None:
        obuf = torch.empty((ch.C1, Wt), dtype=_I32, device=val.device)
    _check("ab_chunk", ch, val.device, Wt, val=val, SMT=SMT, GT=GT, TZ=TZ,
           flags=flags, bc=bc_out, diag_b=diag_b if heads else None,
           obuf=obuf)
    _check_rows("ab_chunk", ch, val.shape[0], SMT.shape[0])
    if obuf.shape[0] < ch.C1 or obuf.shape[1] != Wt:
        raise ValueError(f"ab_chunk: obuf {tuple(obuf.shape)} holds no "
                         f"{ch.C1} rows of {Wt} limbs")
    L = max(WN, WQ, WV, WI8, Wt)
    rc = _build.library().lib.slip_ab_chunk(
        ch.ptr("meta", c), ch.ptr("ev1", c), ch.ptr("bidx", c),
        ch.ptr("mbc", c), diag_b.data_ptr() if heads else None,
        val.data_ptr(), SMT.data_ptr(), GT.data_ptr(), TZ.data_ptr(),
        flags.data_ptr(), bc_out.data_ptr(), obuf.data_ptr(), H, ch.C1,
        ch.CB8, W8, Wt, WN, WQ, WV, WI8, L, _nwarps(L), _stream(val, stream))
    _build.check(rc, "ab_chunk")
    ab_chunk.launches += 1
    return bc_out


ab_chunk.launches = 0


def c_chunk_ref(ch: ShardChunks, c: int, bc, a_src, SMT, GT, TZ, val, flags):
    """Plain version of ``c_chunk`` (any device)."""
    hm, H = ch.meta_host[c], ch.H
    W8, Wt, WI8, WN, WQ, WV = _widths(val, SMT, GT)
    solve = a_src is not None
    nb = int(hm[3 * H + 4])
    if solve and nb:
        val[ch.bidx[c, :nb].long()] = bc[:nb]
    _pass_ref(ch.ev2[c], int(hm[3 * H + 2]), val, a_src if solve else val,
              val if solve else bc, SMT, GT, TZ, flags, 4, WN=WN, WQ=WQ,
              WV=WV, has_ab=True)
    return val


def c_chunk(ch: ShardChunks, c: int, bc, a_src, SMT, GT, TZ, val, flags,
            obuf=None, stream=None):
    """K7 on chunk c of this rank's stream ``ch``: pass 2.

    Factor stream (a_src None): targets and A operands in the rank's value
    table val, B operands by position in bc [CB8, W8] (the summed
    broadcast). Solve stream: bc's rows are first scattered into X (val)
    at the broadcast rows, then the A operands come from a_src, the
    rank's finished value table [Lp8, W8]. In place on val and the flags;
    obuf and stream as for ``ab_chunk``. Returns val."""
    if val.device.type == "cpu":
        return c_chunk_ref(ch, c, bc, a_src, SMT, GT, TZ, val, flags)
    _require_cuda(val, "c_chunk")
    _check_chunk("c_chunk", ch, c)
    W8, Wt, WI8, WN, WQ, WV = _widths(val, SMT, GT)
    if a_src is None and Wt != W8 or a_src is not None and \
            a_src.shape[1] != W8:
        raise ValueError(f"c_chunk: the A operands need W8 = {W8} limbs")
    if obuf is None:
        obuf = torch.empty((ch.C2, Wt), dtype=_I32, device=val.device)
    _check("c_chunk", ch, val.device, Wt, val=val, SMT=SMT, GT=GT, TZ=TZ,
           flags=flags, bc=bc, a_src=a_src, obuf=obuf)
    _check_rows("c_chunk", ch, val.shape[0], SMT.shape[0],
                (val if a_src is None else a_src).shape[0])
    if obuf.shape[0] < ch.C2 or obuf.shape[1] != Wt:
        raise ValueError(f"c_chunk: obuf {tuple(obuf.shape)} holds no "
                         f"{ch.C2} rows of {Wt} limbs")
    L = max(WN, WQ, WV, WI8, Wt)
    rc = _build.library().lib.slip_c_chunk(
        ch.ptr("meta", c), ch.ptr("ev2", c), ch.ptr("bidx", c),
        bc.data_ptr(), None if a_src is None else a_src.data_ptr(),
        val.data_ptr(), SMT.data_ptr(), GT.data_ptr(), TZ.data_ptr(),
        flags.data_ptr(), obuf.data_ptr(), ch.H, ch.C2, W8, Wt, WN, WQ, WV,
        WI8, L, _nwarps(L), _stream(val, stream))
    _build.check(rc, "c_chunk")
    c_chunk.launches += 1
    return val


c_chunk.launches = 0


# ---------------------------------------------------------------------------
# every rank in one process
# ---------------------------------------------------------------------------

def local_ab(chs, c: int, states, solve: bool = False, plain: bool = False):
    """K6 of chunk c on every rank of a plan, in this one process: the
    diagonals summed over the ranks by hand first (what the all-reduce
    computes). chs: each rank's ShardChunks; states: each rank's tables, a
    dict of val, SMT, GT, TZ and flags (X and sflags for the solve stream),
    updated in place. plain: the plain versions. Returns each rank's
    B-operand buffer (their sum is K7's bc). This is how p > 1 runs on one
    card, where NCCL takes one rank a device."""
    ab = ab_chunk_ref if plain else ab_chunk
    H = chs[0].H
    diag = None
    if not solve and chs[0].meta_host[c, 3 * H] > 0:
        diag = sum(st["val"][ch.hsl[c]] * ch.mdiag[c]
                   for ch, st in zip(chs, states))
    bcs = []
    for ch, st in zip(chs, states):
        tgt, fl = (st["X"], st["sflags"]) if solve else \
            (st["val"], st["flags"])
        bc = torch.zeros((ch.CB8, tgt.shape[1]), dtype=_I32,
                         device=tgt.device)
        bcs.append(ab(ch, c, diag, tgt, st["SMT"], st["GT"], st["TZ"], fl,
                      bc))
    return bcs


def local_c(chs, c: int, states, bc, solve: bool = False,
            plain: bool = False) -> None:
    """K7 of chunk c on every rank of a plan in this one process, on the
    B operands bc summed over the ranks (see ``local_ab``)."""
    cc = c_chunk_ref if plain else c_chunk
    for ch, st in zip(chs, states):
        tgt, fl = (st["X"], st["sflags"]) if solve else \
            (st["val"], st["flags"])
        cc(ch, c, bc, st["val"] if solve else None, st["SMT"], st["GT"],
           st["TZ"], tgt, fl)


# ---------------------------------------------------------------------------
# the chunk loop
# ---------------------------------------------------------------------------

def _zeros(*shape, device):
    return torch.zeros(shape, dtype=_I32, device=device)


def fused_sharded_solve(group, n: int, W8: int, Ws8: int, WI8: int,
                        rs: RankStreams, val0: torch.Tensor,
                        X0: torch.Tensor, ndet=None, segments=None,
                        ssegments=None) -> torch.Tensor:
    """The sharded factor scan, then one sharded solve scan per right-hand
    side, on this rank; returns the reference's flat int32 vector, the
    same on every rank:

        [fsing, fovf, sovf, det (W8 limbs), X (nrhs * n * Ws8)]

    The three flag words are sums over the ranks of each rank's 0/1 flags.
    rs: this rank's streams (``rank_streams``); val0 [Lp8, w0]: its value
    table at segments[0]'s width (not written); X0 [nrhs, X8, ws0]: the
    right-hand sides at ssegments[0]'s width, the grouped stream's clone
    rows after row n. ndet: the determinant's table row (grouped streams;
    default n). segments / ssegments: (lo, hi, W8s) chunk ranges with
    nondecreasing widths, as in the single-chip ``fused_solve_all``;
    between factor segments the tables widen and GT re-lifts (K4)."""
    f, s = rs.factor, rs.solve
    dev = val0.device
    if ndet is None:
        ndet = n
    if segments is None:
        segments = ((0, f.nchunks, W8),)
    if ssegments is None:
        ssegments = ((0, s.nchunks, Ws8),)
    n8v = _r8(ndet + 2)
    S = len(segments)
    H = f.H
    cs = _stream(val0, None) if dev.type == "cuda" else None
    flags = _zeros(8, device=dev)
    val = val0.clone()
    SMT = GT = TZ = None
    prev = None
    for lo, hi, W8s in segments:
        WQf = _r8(W8s + 2)
        WIs = max(WQf, WI8) if S == 1 else WQf
        if prev is None:
            SMT = _zeros(n8v, W8s, device=dev)
            GT = _zeros(n8v, WIs, device=dev)
            TZ = _zeros(n8v, 8, device=dev)
            SMT[0, 0] = 1
            GT[0, 0] = 1
        else:
            pW8, pWI = prev
            val = widen_val(val, pW8, W8s).contiguous()
            SMT = widen_tc(SMT, pW8, W8s).contiguous()
            GT = relift_gt(SMT, GT, TZ, W8s, pWI, WIs)
        dsel = _zeros(H, W8s, device=dev)
        diag_b = _zeros(H, W8s, device=dev)
        bc = _zeros(f.CB8, W8s, device=dev)
        obuf = _zeros(max(f.C1, f.C2), W8s, device=dev)
        for c in range(lo, hi):
            hm = f.meta_host[c]
            if hm[3 * H] > 0:
                # owner-masked current diagonals, summed over the ranks
                torch.index_select(val, 0, f.hsl[c], out=dsel)
                torch.mul(dsel, f.mdiag[c], out=diag_b)
                psum(diag_b, group)
            ab_chunk(f, c, diag_b, val, SMT, GT, TZ, flags, bc, obuf, cs)
            if hm[3 * H + 4] > 0:     # else bc is zero on every rank
                psum(bc, group)
            c_chunk(f, c, bc, None, SMT, GT, TZ, val, flags, obuf, cs)
        prev = (W8s, WIs)
    fflags = flags[:2].clone()
    psum(fflags, group)
    det_row = SMT[ndet].clone()
    WIf = prev[1]
    WQs_full = _r8(Ws8 + 2)
    if WIf < min(WI8, WQs_full):
        GT = relift_gt(SMT, GT, TZ, W8, WIf, min(WI8, WQs_full))
        WIf = min(WI8, WQs_full)

    sovf = _zeros(1, device=dev)
    parts = []
    for cr in range(X0.shape[0]):
        X = X0[cr].clone()
        sflags = _zeros(8, device=dev)
        pWs = None
        for lo, hi, Ws_s in ssegments:
            if pWs is not None and Ws_s != pWs:
                X = widen_tc(X, pWs, Ws_s).contiguous()
            bc = _zeros(s.CB8, Ws_s, device=dev)
            obuf = _zeros(max(s.C1, s.C2), Ws_s, device=dev)
            for c in range(lo, hi):
                ab_chunk(s, c, None, X, SMT, GT, TZ, sflags, bc, obuf, cs)
                if s.meta_host[c, 4] > 0:
                    psum(bc, group)
                c_chunk(s, c, bc, val, SMT, GT, TZ, X, sflags, obuf, cs)
            pWs = Ws_s
        sv = (sflags[0] + sflags[1]).reshape(1)
        sovf += psum(sv, group)
        xfull = (X[:n] * rs.xown[:n, None]).contiguous()
        parts.append(psum(xfull, group).reshape(-1))
    return torch.cat([fflags, sovf, det_row] + parts)
