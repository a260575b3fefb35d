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
    tv = thr.view(-1, 1)
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


def _check_w(M: torch.Tensor, w: torch.Tensor) -> None:
    if w.dtype != torch.int32 or w.shape != (M.shape[1],) or not w.is_contiguous():
        raise ValueError(
            f"w must be a contiguous int32 [{M.shape[1]}] tensor, got "
            f"{w.dtype} {tuple(w.shape)}"
        )


def _on_cpu(*ts: torch.Tensor) -> bool:
    return all(t.device.type == "cpu" for t in ts)


def ordered_growth(
    M: torch.Tensor, w: torch.Tensor, thr: torch.Tensor, c_min: int
) -> torch.Tensor:
    """int64 [n_groups] ordered growth (pt_ordered_growth on CUDA). thr:
    int32 [n_groups], thr[g] = ceil((g + 1) * quorum) computed on the host;
    M must have exactly ceil(n_groups / 32) word rows."""
    _check_m(M)
    _check_w(M, w)
    n_groups = thr.shape[0] if thr.dim() == 1 else -1
    if (
        thr.dtype != torch.int32
        or n_groups < 1
        or M.shape[0] != (n_groups + 31) // 32
        or not thr.is_contiguous()
    ):
        raise ValueError(
            f"thr must be a contiguous int32 [n_groups] tensor with "
            f"ceil(n_groups / 32) == {M.shape[0]}, got {thr.dtype} "
            f"{tuple(thr.shape)}"
        )
    if _on_cpu(M, w, thr):
        return ordered_growth_ref(M, w, thr, c_min)
    n_words, n_items_pad = M.shape
    diff = torch.zeros(n_groups, dtype=torch.int64, device=M.device)
    out = torch.empty(n_groups, dtype=torch.int64, device=M.device)
    stream = _cuda_args(M, w, thr, diff, out)
    with torch.cuda.device(M.device):
        kernels.launch(
            "pt_ordered_growth", M.data_ptr(), n_words, n_items_pad, n_groups,
            w.data_ptr(), thr.data_ptr(), c_min, diff.data_ptr(), out.data_ptr(),
            stream,
        )
    return out


def similarity(M: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """int64 [32 n_words, 32 n_words] weighted group co-occurrence
    (pt_similarity on CUDA)."""
    _check_m(M)
    _check_w(M, w)
    if _on_cpu(M, w):
        return similarity_ref(M, w)
    n_words, n_items_pad = M.shape
    out = torch.zeros((32 * n_words, 32 * n_words), dtype=torch.int64, device=M.device)
    stream = _cuda_args(M, w, out)
    with torch.cuda.device(M.device):
        kernels.launch(
            "pt_similarity", M.data_ptr(), n_words, n_items_pad, w.data_ptr(),
            out.data_ptr(), stream,
        )
    return out
