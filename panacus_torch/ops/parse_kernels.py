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

`parse_pack_edges` reads the same text and rows for a build that counts
edges: each pair of consecutive steps of a list is looked up in the L
lines' CSR adjacency (native.build_edge_adj: row_off int64 [n_items + 2],
adj_ent uint64 [E] as int64) under its canonical key, and the group bit is
ORed into the edge M at [word, edge id]. A malformed token or a pair with
no L line lowers its one error slot (err: int64 [1]) the same way.

The copy is a `StepUpload`, which GraphStorage starts on a worker thread
while the index still runs (bytes from the first P/W line to the last): the
same pageable copy as `upload`, on a stream of the job's own, so that it is
off the main thread. A build that finds no such upload in flight copies
with `upload` on the calling thread.

Each wrapper takes the plain version for tensors on the CPU and launches
csrc/parse.cu:pt_parse_pack or pt_parse_pack_edges for tensors on a CUDA
device; it never falls back from one to the other. Where a list fails, the
plain versions leave M and the sums as they were and the kernels leave
them undefined: either way the caller discards the build.
"""

from __future__ import annotations

import contextlib
import warnings
from concurrent.futures import ThreadPoolExecutor, wait
from typing import Optional, Tuple

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


def list_steps(
    s: np.ndarray, walk: bool, n_items: int
) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """(ids, orient) of one step list's bytes (orient 1 for '-' and '<', as
    the host tokenizer has it), or None where a token is malformed or an
    id lies outside 1..n_items. P: tokens split at ',', each digits then
    '+'/'-'; W: tokens at each '>'/'<', each followed by digits."""
    if not len(s):
        return np.zeros(0, dtype=np.int64), np.zeros(0, dtype=np.uint8)
    other = (s < 48) | (s > 57)  # bytes that are not digits
    if walk:
        seps = np.flatnonzero((s == 62) | (s == 60))
        if not len(seps) or seps[0] != 0:
            return None
        starts = seps + 1
        ends = np.append(seps[1:], len(s))
        other[seps] = False
        orient = (s[seps] == 60).astype(np.uint8)
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
        orient = (s[ends] == 45).astype(np.uint8)
    if (ends <= starts).any() or other.any():
        return None
    ids = _values(s, starts, ends)
    if len(ids) and (ids.min() < 1 or ids.max() > n_items):
        return None
    return ids, orient


def adjacency_keys(row_off: np.ndarray, adj_ent: np.ndarray) -> np.ndarray:
    """The (row, key) of each entry of the CSR adjacency
    (native.build_edge_adj) as one uint64, row << 31 | key: ascending, as
    the rows ascend and each row's keys do."""
    rows = np.repeat(np.arange(len(row_off) - 1, dtype=np.uint64), np.diff(row_off))
    return rows << np.uint64(31) | adj_ent.view(np.uint64) >> np.uint64(32)


def edge_ids(keys: np.ndarray, adj_ent: np.ndarray, ids: np.ndarray, orient: np.ndarray):
    """The edge id of each pair of consecutive steps (ids, orient) in the CSR
    adjacency whose entries are adj_ent and whose adjacency_keys are `keys`,
    0 where the pair has no L line: the pair flipped where u > v or u == v
    and the first step is backward (reference: Edge::canonical,
    graph.rs:142-148), then (u, v << 2 | o1 << 1 | o2) searched."""
    u, v = ids[:-1], ids[1:]
    o1, o2 = orient[:-1].astype(np.int64), orient[1:].astype(np.int64)
    swap = (u > v) | ((u == v) & (o1 == 1))
    cu, cv = np.where(swap, v, u), np.where(swap, u, v)
    key = cv << 2 | np.where(swap, o2 ^ 1, o1) << 1 | np.where(swap, o1 ^ 1, o2)
    want = cu.astype(np.uint64) << np.uint64(31) | key.astype(np.uint64)
    if not len(keys):
        return np.zeros(len(want), dtype=np.int64)
    at = np.minimum(np.searchsorted(keys, want), len(keys) - 1)
    eids = (adj_ent.view(np.uint64)[at] & np.uint64(0xFFFFFFFF)).astype(np.int64)
    return np.where(keys[at] == want, eids, 0)


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
        got = list_steps(s[begin:end], bool(meta >> 8 & 1), n_items)
        if got is None:
            a[0] = min(a[0], span)
            continue
        ids = got[0]
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


def parse_pack_edges_ref(
    text: torch.Tensor,
    descs: torch.Tensor,
    M: torch.Tensor,
    row_off: torch.Tensor,
    adj_ent: torch.Tensor,
    n_items: int,
    err: torch.Tensor,
) -> None:
    """Plain version of pt_parse_pack_edges, list by list on the host."""
    s = text.numpy()
    rows = M.numpy().view(np.uint32)
    ent = adj_ent.numpy()
    keys = adjacency_keys(row_off.numpy(), ent)
    e = err.numpy()
    for begin, end, span, meta in descs.numpy().tolist():
        got = list_steps(s[begin:end], bool(meta >> 8 & 1), n_items)
        eids = None if got is None else edge_ids(keys, ent, *got)
        if eids is None or not eids.all():
            e[0] = min(e[0], span)
            continue
        if meta >> 16 >= 0:
            rows[meta >> 16, eids] |= np.uint32(1 << (meta & 31))


def parse_pack_edges(
    text: torch.Tensor,
    descs: torch.Tensor,
    M: torch.Tensor,
    row_off: torch.Tensor,
    adj_ent: torch.Tensor,
    n_items: int,
    err: torch.Tensor,
) -> None:
    """OR the group bit of every pair of consecutive steps of the lists of
    `text` that `descs` names into the edge M at its edge id, and lower err
    where a token or a pair fails (pt_parse_pack_edges on CUDA, on the
    current stream)."""
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
    if M.dtype != torch.int32 or M.dim() != 2 or not M.is_contiguous() or M.shape[1] <= len(adj_ent):
        raise ValueError("M must be a contiguous int32 [n_words, n_items_pad > n_edges] tensor")
    if row_off.dtype != torch.int64 or row_off.dim() != 1 or len(row_off) != n_items + 2:
        raise ValueError("row_off must be int64 of length n_items + 2")
    if adj_ent.dtype != torch.int64 or adj_ent.dim() != 1 or not adj_ent.is_contiguous():
        raise ValueError("adj_ent must be a contiguous int64 vector")
    if err.dtype != torch.int64 or err.shape != (1,):
        raise ValueError("err must be an int64 vector of 1")
    if M.device.type == "cpu":
        return parse_pack_edges_ref(text, descs, M, row_off, adj_ent, n_items, err)
    for t in (text, descs, row_off, adj_ent, err):
        if t.device != M.device:
            raise ValueError(f"operands on {t.device} and {M.device}")
    stream = torch.cuda.current_stream(M.device).cuda_stream
    with torch.cuda.device(M.device):
        kernels.launch(
            "pt_parse_pack_edges", text.data_ptr(), text.numel(), descs.data_ptr(),
            descs.shape[0], M.data_ptr(), M.shape[1], row_off.data_ptr(),
            adj_ent.data_ptr(), n_items, err.data_ptr(), stream,
        )
