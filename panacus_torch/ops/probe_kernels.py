"""The probe kernels: the raw-read control and the hist-formulation probes.

Counterparts of the Pallas TPU kernels that measure the hist pass:

- xor_fold (pt_xor_fold): bench.py:_xor_read_bw, the raw-read ceiling;
- word_fold (pt_word_fold): scripts/kernel_probe.py pc_only, pcl_only and
  pcm_only, and scripts/kernel_interleave.py _simple(_pc_kernel |
  _pcx_kernel | _pcm_kernel);
- limb_hist (pt_limb_hist): scripts/kernel_probe.py coarse, fh2 and fhm,
  and scripts/kernel_interleave.py _fh2(n_limbs, mxu_cov).

M is int32 [n_words, n_items] (the uint32 bits viewed as int32), W int32
[n_vecs, n_items]. Each function adds `salt` to every weight as it reads
it, wrapping in int32: the TPU chains' `w + i`, which the kernels fold into
their read of W. The folds keep the TPU grid's accumulator, one slot per
item of a 16384-item block (item i lands in slot i % 16384), and wrap in
int32 as JAX does. limb_hist returns the histograms that the TPU kernels'
lo/hi 16-bit planes encode, [n_limbs * n_vecs, 32 * n_coarse] int64 with
row j * n_vecs + v for byte j of vector v.

Each wrapper takes the plain PyTorch version for tensors on the CPU and
launches its CUDA kernel (csrc/probe.cu) for tensors on a CUDA device; it
never falls back from one to the other. The route flags (op, weight_side,
mma_cov) choose how the kernel computes; the plain versions give the same
function whatever they are.
"""

from __future__ import annotations

import torch

from . import kernels
from .hist_kernels import _check_m, _cuda_args, coverage_ref

BLOCK_ITEMS = 16384  # items per TPU grid step: the fold's slots
FINE = 32  # fine bins per coarse bin (bin = 32 * coarse + fine)
OPS = ("popc", "cast")
WEIGHT_SIDES = ("fine", "coarse")
MAX_COARSE_PAD = 240  # csrc/probe.cu: coarse bins travel as bytes
MAX_UNITS = 48  # csrc/probe.cu: 16 x 16 product tiles a block keeps in registers
MAX_WORDS = 128  # csrc/probe.cu: a stage of every word fits shared memory
XOR_SCRATCH = BLOCK_ITEMS + BLOCK_ITEMS // 256 + 1  # csrc/probe.cu: pt_xor_fold


def _wrap32(x: torch.Tensor) -> torch.Tensor:
    """int64 values -> int32 with two's-complement wrap."""
    return (((x + 2**31) & 0xFFFFFFFF) - 2**31).to(torch.int32)


def _salt32(salt: int) -> int:
    """A Python int as the int32 the kernels add (wrapping)."""
    return ((int(salt) + 2**31) & 0xFFFFFFFF) - 2**31


def n_coarse_for(n_bins: int) -> int:
    """Coarse bins of the TPU kernels: n_bins padded to 128, over FINE."""
    return (n_bins + 127) // 128 * 128 // FINE


def salted(W: torch.Tensor, salt: int) -> torch.Tensor:
    """W + salt, wrapping in int32: what the kernels read in place of W."""
    return _wrap32(W.to(torch.int64) + _salt32(salt))


def _slot_rows(x: torch.Tensor) -> torch.Tensor:
    """[n_items] -> [n_blocks, BLOCK_ITEMS], zero-padded: row k holds the
    items of grid step k."""
    n = x.shape[0]
    pad = -n % BLOCK_ITEMS if n else BLOCK_ITEMS
    return torch.nn.functional.pad(x, (0, pad)).view(-1, BLOCK_ITEMS)


def _xor_rows(x: torch.Tensor) -> torch.Tensor:
    """XOR of the rows of an int32 [n, k] tensor, by halving."""
    while x.shape[0] > 1:
        h = x.shape[0] // 2
        y = x[:h] ^ x[h : 2 * h]
        if x.shape[0] % 2:
            y[0] ^= x[-1]
        x = y
    return x[0]


def xor_fold_ref(M: torch.Tensor, W: torch.Tensor, salt: int = 0) -> torch.Tensor:
    """Plain version: int32 [1, 1], the int32-wrapping sum over the slots j
    of slot_j = XOR over items i = j (mod 16384) of
    (XOR_w M[w, i]) ^ (W[0, i] + salt)."""
    r = salted(W[0], salt)
    for k in range(M.shape[0]):
        r = r ^ M[k]
    slots = _xor_rows(_slot_rows(r))
    return _wrap32(slots.to(torch.int64).sum()).view(1, 1)


def word_fold_ref(
    M: torch.Tensor,
    W: torch.Tensor,
    salt: int = 0,
    op: str = "popc",
    mma_cov: bool = False,
) -> torch.Tensor:
    """Plain version: int32 [1, 16384], slot_j = sum over items i = j
    (mod 16384) of cov_i + ((W[0, i] + salt) & 1), wrapping, with cov_i =
    sum_w popcount(M[w, i]) (op "popc") or sum_w M[w, i] (op "cast")."""
    if op == "popc":
        cov = coverage_ref(M).to(torch.int64)
    else:
        cov = M.to(torch.int64).sum(dim=0)
    v = cov + (salted(W[0], salt) & 1).to(torch.int64)
    return _wrap32(_slot_rows(v).sum(dim=0)).view(1, BLOCK_ITEMS)


def limb_hist_ref(
    M: torch.Tensor,
    W: torch.Tensor,
    n_bins: int,
    n_limbs: int = 3,
    salt: int = 0,
    weight_side: str = "fine",
    mma_cov: bool = False,
) -> torch.Tensor:
    """Plain version: int64 [n_limbs * n_vecs, 32 * n_coarse], row j *
    n_vecs + v holds H[b] = sum over items with cov_i == b of byte j of
    W[v, i] + salt; items with cov_i >= 32 * n_coarse are dropped."""
    width = n_coarse_for(n_bins) * FINE
    n_vecs = W.shape[0]
    cov = coverage_ref(M).to(torch.int64)
    keep = cov < width
    idx = cov[keep]
    Ws = salted(W, salt)[:, keep]
    out = torch.zeros((n_limbs * n_vecs, width), dtype=torch.int64, device=M.device)
    for j in range(n_limbs):
        for v in range(n_vecs):
            byte = ((Ws[v] >> (8 * j)) & 0xFF).to(torch.int64)
            out[j * n_vecs + v].index_add_(0, idx, byte)
    return out


def recombine(H: torch.Tensor, n_vecs: int, n_limbs: int) -> torch.Tensor:
    """[n_limbs * n_vecs, width] limb histograms -> [n_vecs, width] weight
    histograms, sum_j H[j * n_vecs + v] << 8 j."""
    out = torch.zeros((n_vecs, H.shape[1]), dtype=torch.int64, device=H.device)
    for j in range(n_limbs):
        out += H[j * n_vecs : (j + 1) * n_vecs] << (8 * j)
    return out


def _check_w(M: torch.Tensor, W: torch.Tensor, one_row: bool) -> None:
    if (
        W.dtype != torch.int32
        or W.dim() != 2
        or W.shape[1] != M.shape[1]
        or W.shape[0] < 1
        or (one_row and W.shape[0] != 1)
        or not W.is_contiguous()
    ):
        rows = "1" if one_row else "n_vecs"
        raise ValueError(
            f"W must be a contiguous int32 [{rows}, {M.shape[1]}] tensor, got "
            f"{W.dtype} {tuple(W.shape)}"
        )


def _on_cpu(*ts: torch.Tensor) -> bool:
    return all(t.device.type == "cpu" for t in ts)


def xor_fold(M: torch.Tensor, W: torch.Tensor, salt: int = 0) -> torch.Tensor:
    """int32 [1, 1] raw-read control (pt_xor_fold on CUDA). W: int32
    [1, n_items]."""
    _check_m(M)
    _check_w(M, W, one_row=True)
    if _on_cpu(M, W):
        return xor_fold_ref(M, W, salt)
    # the slots, a count per 256-slot window, the result
    scratch = torch.zeros(XOR_SCRATCH, dtype=torch.int32, device=M.device)
    stream = _cuda_args(M, W, scratch)
    with torch.cuda.device(M.device):
        kernels.launch(
            "pt_xor_fold", M.data_ptr(), M.shape[0], M.shape[1], W.data_ptr(),
            _salt32(salt), scratch.data_ptr(), stream,
        )
    return scratch[-1:].view(1, 1)


def word_fold(
    M: torch.Tensor,
    W: torch.Tensor,
    salt: int = 0,
    op: str = "popc",
    mma_cov: bool = False,
) -> torch.Tensor:
    """int32 [1, 16384] folded per-item coverage (pt_word_fold on CUDA).
    op "popc" counts bits, "cast" adds the words themselves; mma_cov takes
    the popcount coverage on the int8 tensor cores. W: int32 [1, n_items]."""
    _check_m(M)
    _check_w(M, W, one_row=True)
    if op not in OPS or (mma_cov and op != "popc"):
        raise ValueError(f"no word-fold route for op={op!r}, mma_cov={mma_cov}")
    if _on_cpu(M, W):
        return word_fold_ref(M, W, salt, op, mma_cov)
    out = torch.zeros((1, BLOCK_ITEMS), dtype=torch.int32, device=M.device)
    stream = _cuda_args(M, W, out)
    with torch.cuda.device(M.device):
        kernels.launch(
            "pt_word_fold", M.data_ptr(), M.shape[0], M.shape[1], W.data_ptr(),
            _salt32(salt), OPS.index(op), int(mma_cov), out.data_ptr(), stream,
        )
    return out


def limb_hist(
    M: torch.Tensor,
    W: torch.Tensor,
    n_bins: int,
    n_limbs: int = 3,
    salt: int = 0,
    weight_side: str = "fine",
    mma_cov: bool = False,
    _max_blocks: int = 0,
) -> torch.Tensor:
    """int64 [n_limbs * n_vecs, 32 * n_coarse] per-byte coverage
    histograms (pt_limb_hist on CUDA: one-hot products on the int8 tensor
    cores, the weight byte on the `weight_side` operand; mma_cov takes the
    coverage on the tensor cores too). W: int32 [n_vecs, n_items].
    _max_blocks is for tests only: > 0 caps the kernel's blocks, so its
    item slices grow to their 2^23-item limit (0 fills the card)."""
    _check_m(M)
    _check_w(M, W, one_row=False)
    n_coarse = n_coarse_for(n_bins) if n_bins >= 1 else 0
    coarse_pad = (n_coarse + 15) // 16 * 16
    n_rows = n_limbs * W.shape[0]
    if (
        not 1 <= n_limbs <= 4
        or not 1 <= n_coarse
        or M.shape[0] > MAX_WORDS
        or coarse_pad > MAX_COARSE_PAD
        or n_rows * coarse_pad // 16 * 2 > MAX_UNITS
        or weight_side not in WEIGHT_SIDES
    ):
        raise ValueError(
            f"no limb-hist route for n_bins={n_bins}, n_limbs={n_limbs}, "
            f"{W.shape[0]} vectors, weight_side={weight_side!r}"
        )
    if _on_cpu(M, W):
        return limb_hist_ref(M, W, n_bins, n_limbs, salt, weight_side, mma_cov)
    out = torch.zeros((n_rows, n_coarse * FINE), dtype=torch.int64, device=M.device)
    stream = _cuda_args(M, W, out)
    with torch.cuda.device(M.device):
        kernels.launch(
            "pt_limb_hist", M.data_ptr(), M.shape[0], M.shape[1], W.data_ptr(),
            W.shape[0], n_limbs, n_coarse, int(weight_side == "coarse"),
            int(mma_cov), _salt32(salt), _max_blocks, out.data_ptr(), stream,
        )
    return out
