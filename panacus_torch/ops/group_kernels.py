"""Ordered growth and group similarity over the packed membership matrix.

Counterpart of panacus_tpu/ops/engine.py: ordered_growth
(_ordered_growth_all / _ordered_growth_block_body) and
similarity_intersections (_sim_block_int / _sim_all). M is int32
[n_words, n_items_pad] (the uint32 bits viewed as int32), weights are int32
[n_items_pad], results are exact int64.

Each wrapper takes the plain PyTorch version for tensors on the CPU and
launches its CUDA kernel (csrc/group.cu) for tensors on a CUDA device; it
never falls back from one to the other.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from . import kernels
from .hist_kernels import _check_m, _cuda_args

# elements of one [groups, items] temporary in the plain versions
_BLOCK_ELEMS = 1 << 21


def _unpack(M_block: torch.Tensor, n_groups: int) -> torch.Tensor:
    """[n_words, B] packed int32 -> [n_groups, B] 0/1 int32 presence. The
    arithmetic shift of a negative word only fills bits the & 1 drops."""
    shifts = torch.arange(32, dtype=torch.int32, device=M_block.device)
    P = (M_block.unsqueeze(1) >> shifts.view(1, 32, 1)) & 1
    return P.reshape(-1, M_block.shape[1])[:n_groups]


def _block_items(n_rows: int) -> int:
    return max(_BLOCK_ELEMS // max(n_rows, 1), 1)


def ordered_growth_ref(
    M: torch.Tensor, w: torch.Tensor, thr: torch.Tensor, c_min: int
) -> torch.Tensor:
    """Plain version: int64 [n_groups]. Per item block: unpack to [G, B],
    cumsum and cummax over where(P, thr, -1) down the groups, then
    ok = (cum >= thr) & (cum >= 1) & (total >= c_min) (engine.py:230-260);
    blocks whose weights are all zero add nothing and are skipped."""
    n_groups = thr.shape[0]
    out = torch.zeros(n_groups, dtype=torch.int64, device=M.device)
    tv = thr.to(M.device).view(-1, 1)
    step = _block_items(n_groups)
    for lo in range(0, M.shape[1], step):
        wb = w[lo : lo + step].to(torch.int64)
        if not bool(wb.any()):
            continue
        P = _unpack(M[:, lo : lo + step], n_groups)
        cum = P.cumsum(0, dtype=torch.int32)
        t = torch.where(P > 0, tv, -1).cummax(0).values
        ok = (cum >= t) & (cum >= 1) & (cum[-1] >= c_min)
        out += (ok.to(torch.int64) * wb).sum(1)
    return out


def similarity_ref(M: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain version: int64 [32 n_words, 32 n_words], S[g, h] = sum_i w_i
    P[g, i] P[h, i]. torch has no integer matmul on CUDA, so each item block
    is a float64 matmul, exact because every partial sum of a block stays
    below 2^53 (blocks of at most 2^53 / max(w) items); the blocks add up
    in int64."""
    n_words, n_items_pad = M.shape
    g_pad = 32 * n_words
    S = torch.zeros((g_pad, g_pad), dtype=torch.int64, device=M.device)
    if n_items_pad == 0:
        return S
    w_max = max(int(w.max()), 1)
    step = min(_block_items(g_pad), (2**53 - 1) // w_max)
    for lo in range(0, n_items_pad, step):
        wb = w[lo : lo + step].to(torch.float64)
        if not bool(wb.any()):
            continue
        P = _unpack(M[:, lo : lo + step], g_pad).to(torch.float64)
        S += (P @ (P * wb).T).to(torch.int64)
    return S


def n_planes(w_max: int) -> int:
    """Byte planes that weights up to w_max need (W = sum_p 256^p B_p):
    1 for unit weights and anything below 2^8, at most 4 below 2^31."""
    if not 0 <= w_max < 2**31:
        raise ValueError(f"weights must lie in [0, 2^31), max is {w_max}")
    n = 1
    while w_max >= 1 << (8 * n):
        n += 1
    return n


def _check_w(M: torch.Tensor, w: torch.Tensor) -> None:
    if w.dtype != torch.int32 or w.shape != (M.shape[1],) or not w.is_contiguous():
        raise ValueError(
            f"w must be a contiguous int32 [{M.shape[1]}] tensor, got "
            f"{w.dtype} {tuple(w.shape)}"
        )


def _on_cpu(*ts: torch.Tensor) -> bool:
    return all(t.device.type == "cpu" for t in ts)


# int64 scratch of pt_ordered_growth per (device, stream): its difference
# array and block counter, zero between calls (the kernel leaves it so)
_ordered_scratches: Dict[Tuple[torch.device, int], torch.Tensor] = {}
# checked device copies of the thresholds, by device and content (an
# ordered run asks for the same few again and again; a copy per call would
# wait on the stream, a check per call would cost more host time than the
# kernel takes)
_thresholds_on: Dict[Tuple[torch.device, bytes], torch.Tensor] = {}
_THRESHOLD_COPIES = 64


def _ordered_scratch(device: torch.device, stream: int, n: int) -> torch.Tensor:
    buf = _ordered_scratches.get((device, stream))
    if buf is None or buf.numel() < n:
        buf = torch.zeros(n, dtype=torch.int64, device=device)
        _ordered_scratches[(device, stream)] = buf
    return buf


def thresholds_on(device: torch.device, thr: torch.Tensor) -> torch.Tensor:
    """The host thresholds thr on `device`, checked and copied once per
    content."""
    key = (device, thr.numpy().tobytes())
    dev = _thresholds_on.get(key)
    if dev is None:
        check_thresholds(thr)
        if len(_thresholds_on) >= _THRESHOLD_COPIES:
            _thresholds_on.clear()
        dev = _thresholds_on[key] = thr.to(device)
    return dev


def check_thresholds(thr: torch.Tensor) -> None:
    """thr (int32 [n_groups] on the host) clamped to [0, n_groups + 1] must
    step by 0 or 1 from 0, as ceil((g + 1) * quorum) does for a quorum in
    [0, 1]: the only thresholds pt_ordered_growth scans."""
    n_groups = thr.shape[0]
    steps = np.diff(np.clip(thr.numpy().astype(np.int64), 0, n_groups + 1), prepend=0)
    bad = np.flatnonzero((steps != 0) & (steps != 1))
    if bad.size:
        raise ValueError(
            f"thresholds must step by 0 or 1 (clamped to [0, {n_groups + 1}]); "
            f"they step by {steps[bad[0]]} into group {bad[0]}"
        )


def ordered_growth(
    M: torch.Tensor, w: torch.Tensor, thr: torch.Tensor, c_min: int
) -> torch.Tensor:
    """int64 [n_groups] ordered growth (pt_ordered_growth on CUDA, one
    launch). thr: int32 [n_groups] on the host, thr[g] = ceil((g + 1) *
    quorum) for a quorum in [0, 1] (check_thresholds rejects any other
    steps, on every device; on CUDA when thresholds_on first copies them);
    M must have exactly ceil(n_groups / 32) word rows."""
    _check_m(M)
    _check_w(M, w)
    n_groups = thr.shape[0] if thr.dim() == 1 else -1
    if (
        thr.dtype != torch.int32
        or n_groups < 1
        or M.shape[0] != (n_groups + 31) // 32
        or not thr.is_contiguous()
        or thr.device.type != "cpu"
    ):
        raise ValueError(
            f"thr must be a contiguous int32 [n_groups] tensor on the host with "
            f"ceil(n_groups / 32) == {M.shape[0]}, got {thr.dtype} "
            f"{tuple(thr.shape)} on {thr.device}"
        )
    if _on_cpu(M, w):
        check_thresholds(thr)
        return ordered_growth_ref(M, w, thr, c_min)
    n_words, n_items_pad = M.shape
    out = torch.empty(n_groups, dtype=torch.int64, device=M.device)
    thr_dev = thresholds_on(M.device, thr)
    stream = _cuda_args(M, w, thr_dev, out)
    diff = _ordered_scratch(M.device, stream, n_groups + 1)
    with torch.cuda.device(M.device):
        kernels.launch(
            "pt_ordered_growth", M.data_ptr(), n_words, n_items_pad, n_groups,
            w.data_ptr(), thr_dev.data_ptr(), c_min, diff.data_ptr(), out.data_ptr(),
            stream,
        )
    return out


def _w_max(w: torch.Tensor) -> int:
    """max(w), read to the host in one sync together with min(w), which
    must not be negative."""
    if w.numel() == 0:
        return 0
    lo, hi = torch.stack(torch.aminmax(w)).tolist()
    if lo < 0:
        raise ValueError(f"weights must lie in [0, 2^31), min is {lo}")
    return hi


def similarity(
    M: torch.Tensor, w: torch.Tensor, w_max: Optional[int] = None
) -> torch.Tensor:
    """int64 [32 n_words, 32 n_words] weighted group co-occurrence
    (pt_similarity on CUDA: one int8 tensor-core product per byte plane of
    the weights, as many planes as max(w) needs). Weights lie in [0, 2^31);
    a caller that knows their maximum passes it as w_max, which spares the
    read of w to the host."""
    _check_m(M)
    _check_w(M, w)
    planes = n_planes(_w_max(w) if w_max is None else w_max)
    if _on_cpu(M, w):
        return similarity_ref(M, w)
    n_words, n_items_pad = M.shape
    out = torch.empty((32 * n_words, 32 * n_words), dtype=torch.int64, device=M.device)
    part_elems = ctypes.c_longlong()
    with torch.cuda.device(M.device):
        kernels.query(
            "pt_similarity_scratch", n_words, n_items_pad, planes,
            ctypes.byref(part_elems),
        )
        # int32 partial tiles, one per (item slice, plane, tile pair)
        part = torch.empty(part_elems.value, dtype=torch.int32, device=M.device)
        stream = _cuda_args(M, w, out, part)
        kernels.launch(
            "pt_similarity", M.data_ptr(), n_words, n_items_pad, w.data_ptr(),
            planes, part.data_ptr(), part_elems.value, out.data_ptr(), stream,
        )
    return out
