"""The parse of GFA step lists into membership rows, on the card.

No counterpart in panacus_tpu, which tokenizes every P/W line on the host.
stream.py's device route uploads the GFA's bytes from the first step list
to the last in one copy (`upload`) and hands them to `parse_pack` with one
descriptor row a non-empty step list {begin, end, span, bit | walk << 8 |
word << 16} (int64 [n, 4], offsets in the text, ascending and not
overlapping), which turns them into M's rows (int32 [n_words,
n_items_pad], the group bit ORed into M[word, id]; word -1 sets none) and
each span's token count and bp (acc: int64 [1 + 2 * n_spans], the error
slot, the counts, the bp sums, all added to). A malformed token (checked as
the host tokenizer checks it) or an id outside 1..n_items lowers the error
slot, ERR_NONE while none failed, to the least failing span.

The copy is a `StepUpload`, which GraphStorage starts on a worker thread
while the index still runs (bytes from the first P/W line to the last): the
same pageable copy as `upload`, on a stream of the job's own, so that it is
off the main thread. A build that finds no such upload in flight copies
with `upload` on the calling thread.

The wrapper takes the plain version for tensors on the CPU and launches
csrc/parse.cu:pt_parse_pack for tensors on a CUDA device; it never falls
back from one to the other. Where a list fails, the plain version leaves
M and the sums as they were and the kernel leaves them undefined: either
way the caller discards the build.
"""

from __future__ import annotations

import contextlib
import warnings
from concurrent.futures import ThreadPoolExecutor, wait
from typing import Optional

import numpy as np
import torch

from ..runtime import span
from . import kernels

ERR_NONE = np.iinfo(np.int64).max


def _values(s: np.ndarray, starts: np.ndarray, ends: np.ndarray) -> np.ndarray:
    """int64 value of each run of decimal digits s[starts[i]:ends[i]], the
    digits summed mod 2^64 (as the host's and the kernel's parse wrap)."""
    vals = np.zeros(len(starts), dtype=np.uint64)
    lens = ends - starts
    for k in range(int(lens.max()) if len(lens) else 0):
        live = lens > k
        d = s[ends[live] - 1 - k].astype(np.uint64) - np.uint64(48)
        vals[live] += d * np.uint64(pow(10, k, 1 << 64))
    return vals.view(np.int64)


def list_ids(s: np.ndarray, walk: bool, n_items: int) -> Optional[np.ndarray]:
    """The node ids of one step list's bytes, or None where a token is
    malformed or an id lies outside 1..n_items. P: tokens split at ',',
    each digits then '+'/'-'; W: tokens at each '>'/'<', each followed by
    digits."""
    if not len(s):
        return np.zeros(0, dtype=np.int64)
    other = (s < 48) | (s > 57)  # bytes that are not digits
    if walk:
        seps = np.flatnonzero((s == 62) | (s == 60))
        if not len(seps) or seps[0] != 0:
            return None
        starts = seps + 1
        ends = np.append(seps[1:], len(s))
        other[seps] = False
    else:
        commas = np.flatnonzero(s == 44)
        starts = np.concatenate([[0], commas + 1])
        tok_ends = np.append(commas, len(s))
        if (tok_ends - starts < 2).any():
            return None
        ends = tok_ends - 1  # the orientation byte
        if not np.isin(s[ends], (43, 45)).all():
            return None
        other[commas] = False
        other[ends] = False
    if (ends <= starts).any() or other.any():
        return None
    ids = _values(s, starts, ends)
    if len(ids) and (ids.min() < 1 or ids.max() > n_items):
        return None
    return ids


def descriptors(
    starts: np.ndarray, ends: np.ndarray, walk: np.ndarray, words: np.ndarray, bits: np.ndarray
):
    """(lo, hi, descs) of step lists at buf[starts[k]:ends[k]], span k in
    group bit bits[k] of word words[k] (-1: none), a W line where walk[k]:
    the text to upload is buf[lo:hi], and descs (int64 [n, 4]) has a row
    for each non-empty list, ordered by its place in the text."""
    keep = np.flatnonzero(ends > starts)
    keep = keep[np.argsort(starts[keep], kind="stable")]
    if not len(keep):
        return 0, 0, np.zeros((0, 4), dtype=np.int64)
    lo, hi = int(starts[keep[0]]), int(ends[keep].max())
    meta = (
        bits[keep].astype(np.int64)
        | walk[keep].astype(np.int64) << 8
        | words[keep].astype(np.int64) << 16
    )
    descs = np.stack([starts[keep] - lo, ends[keep] - lo, keep.astype(np.int64), meta], axis=1)
    if (descs[1:, 0] < descs[:-1, 1]).any():
        raise ValueError("step lists overlap")
    return lo, hi, np.ascontiguousarray(descs)


def upload(data: np.ndarray, device: torch.device) -> torch.Tensor:
    """data (uint8, a read-only map is fine) as a tensor on `device`: one
    copy from pageable host memory on the current stream, which the host
    waits for; on the CPU the tensor shares data's memory."""
    with warnings.catch_warnings():
        # nothing writes through the tensor
        warnings.simplefilter("ignore", UserWarning)
        host = torch.from_numpy(data)
    return host if device.type == "cpu" else host.to(device)


class StepUpload:
    """buf[base:end] copied to `device` by `upload` on a worker thread, on a
    stream of the job's own, under the span `index.upload` (count `bytes`)
    that `parent` (what runtime.handoff() gave) parents. `take` gives the
    text, `close` joins the job."""

    def __init__(self, buf: np.ndarray, base: int, end: int, device: torch.device, parent=None):
        self.base, self.end = base, end
        self._text: Optional[torch.Tensor] = None
        ex = ThreadPoolExecutor(max_workers=1)
        self._job = ex.submit(self._run, buf[base:end], device, parent)
        ex.shutdown(wait=False)

    def _run(self, data: np.ndarray, device: torch.device, parent) -> None:
        cuda = device.type == "cuda"
        with span("index.upload", handoff=parent, bytes=len(data)):
            with torch.cuda.stream(torch.cuda.Stream(device)) if cuda else contextlib.nullcontext():
                self._text = upload(data, device)

    def take(self) -> torch.Tensor:
        """Wait for the copy; the text, now the caller's."""
        self._job.result()
        text, self._text = self._text, None
        if text is None:
            raise RuntimeError("the upload's text was taken already")
        return text

    def close(self) -> None:
        """Join the job (it reads the map no more then) and drop the text;
        a failed copy that no build took raises nothing."""
        wait([self._job])
        self._text = None


def parse_pack_ref(
    text: torch.Tensor,
    descs: torch.Tensor,
    M: torch.Tensor,
    node_lens: torch.Tensor,
    n_items: int,
    acc: torch.Tensor,
) -> None:
    """Plain version of pt_parse_pack, list by list on the host."""
    s = text.numpy()
    rows = M.numpy().view(np.uint32)
    lens = node_lens.numpy().view(np.uint32)
    a = acc.numpy()
    n_spans = (len(a) - 1) // 2
    for begin, end, span, meta in descs.numpy().tolist():
        ids = list_ids(s[begin:end], bool(meta >> 8 & 1), n_items)
        if ids is None:
            a[0] = min(a[0], span)
            continue
        if meta >> 16 >= 0:
            rows[meta >> 16, ids] |= np.uint32(1 << (meta & 31))
        a[1 + span] += len(ids)
        a[1 + n_spans + span] += int(lens[ids].sum(dtype=np.int64))


def parse_pack(
    text: torch.Tensor,
    descs: torch.Tensor,
    M: torch.Tensor,
    node_lens: torch.Tensor,
    n_items: int,
    acc: torch.Tensor,
) -> None:
    """Parse the step lists of `text` that `descs` names into M's rows and
    acc (pt_parse_pack on CUDA, on the current stream)."""
    if text.dtype != torch.uint8 or text.dim() != 1 or not text.is_contiguous():
        raise ValueError("text must be a contiguous uint8 vector")
    if (
        descs.dtype != torch.int64
        or descs.dim() != 2
        or descs.shape[1] != 4
        or descs.shape[0] < 1
        or not descs.is_contiguous()
    ):
        raise ValueError(f"descs must be a contiguous int64 [n >= 1, 4], got {tuple(descs.shape)}")
    if M.dtype != torch.int32 or M.dim() != 2 or not M.is_contiguous() or M.shape[1] <= n_items:
        raise ValueError("M must be a contiguous int32 [n_words, n_items_pad > n_items] tensor")
    if node_lens.dtype != torch.int32 or len(node_lens) < n_items + 1:
        raise ValueError("node_lens must be int32 of length n_items + 1 or more")
    if acc.dtype != torch.int64 or acc.dim() != 1 or len(acc) % 2 != 1:
        raise ValueError("acc must be an int64 vector of 1 + 2 * n_spans")
    if M.device.type == "cpu":
        return parse_pack_ref(text, descs, M, node_lens, n_items, acc)
    for t in (text, descs, node_lens, acc):
        if t.device != M.device:
            raise ValueError(f"operands on {t.device} and {M.device}")
    stream = torch.cuda.current_stream(M.device).cuda_stream
    with torch.cuda.device(M.device):
        kernels.launch(
            "pt_parse_pack", text.data_ptr(), text.numel(), descs.data_ptr(),
            descs.shape[0], M.data_ptr(), M.shape[1], node_lens.data_ptr(),
            n_items, acc.data_ptr(), (len(acc) - 1) // 2, stream,
        )
