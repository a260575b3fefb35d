"""Device compute core: the packed node-x-group membership bit matrix.

Port of panacus_tpu/ops/engine.py (CountingEngine, MembershipStream) to
PyTorch. M[n_words, n_items_pad] holds bit (g % 32) of word M[g // 32, i]
when item i occurs in path group g; it is stored as int32 (the same bits
as the reference's uint32). Items are 1-based dense ids, 0 is a sentinel
with weight 0, and the item axis is zero-padded to ITEM_ALIGN.

coverage   = popcount-reduce over words     (== AbacusByTotal.countable)
hist       = weighted bincount of coverage  (== construct_hist / _bps)
ordered    = per-item scan over the groups  (== AbacusByGroup::calc_growth)
similarity = weighted group co-occurrence   (== Similarity::set_table)

They run through ops.hist_kernels and ops.group_kernels: the CUDA kernels
for M on a GPU, the plain PyTorch versions for M on the CPU. Results are
exact int64 for any weight total.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from . import group_kernels, hist_kernels

ITEM_ALIGN = 1 << 14


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


class CountingEngine:
    """Holds the membership matrix for one (graph, mask, count-type) state
    on one torch device."""

    def __init__(self, n_items: int, n_groups: int, device: torch.device):
        self.n_items = n_items
        self.n_groups = n_groups
        self.n_words = max((n_groups + 31) // 32, 1)
        self.n_items_pad = _round_up(n_items + 1, ITEM_ALIGN)
        self.device = torch.device(device)
        self.M: Optional[torch.Tensor] = None
        self._ones: Optional[torch.Tensor] = None

    @classmethod
    def from_host_state(
        cls,
        M_uint32: np.ndarray,
        n_items: int,
        n_groups: int,
        device: torch.device,
    ) -> "CountingEngine":
        """Adopt a membership matrix fetched from another engine (e.g.
        `np.asarray(jax_engine.M)`), whatever item padding it carries:
        columns past n_items must be zero and are re-padded to this
        engine's n_items_pad."""
        eng = cls(n_items, n_groups, device)
        M_uint32 = np.asarray(M_uint32, dtype=np.uint32)
        if M_uint32.ndim != 2 or M_uint32.shape[0] != eng.n_words:
            raise ValueError(
                f"expected {eng.n_words} word rows, got shape {M_uint32.shape}"
            )
        if M_uint32[:, n_items + 1 :].any():
            raise ValueError("membership bits set past item n_items")
        M = np.zeros((eng.n_words, eng.n_items_pad), dtype=np.uint32)
        k = min(M_uint32.shape[1], n_items + 1)
        M[:, :k] = M_uint32[:, :k]
        return eng.build_from_host_matrix(M)

    def build_from_host_matrix(self, M_host: np.ndarray) -> "CountingEngine":
        """Adopt a host-assembled uint32 [n_words, n_items_pad] matrix (one
        upload; zero-copy on the CPU)."""
        if M_host.shape != (self.n_words, self.n_items_pad):
            raise ValueError(
                f"M has shape {M_host.shape}, expected "
                f"{(self.n_words, self.n_items_pad)}"
            )
        M = torch.from_numpy(np.ascontiguousarray(M_host).view(np.int32))
        self.M = M.to(self.device)
        self._ones = None
        return self

    def coverage(self) -> np.ndarray:
        """Per-item distinct-group count, length n_items + 1 (slot 0 sentinel)."""
        cov = hist_kernels.coverage(self.M)
        return cov[: self.n_items + 1].cpu().numpy()

    def _ones_w(self) -> torch.Tensor:
        """All-ones weights with the sentinel and padding zeroed, built on
        M's device (the hot path never uploads a ones vector)."""
        if self._ones is None:
            ones = torch.zeros(self.n_items_pad, dtype=torch.int32, device=self.device)
            ones[1 : self.n_items + 1] = 1
            self._ones = ones
        return self._ones

    def _w_dev(self, w: Optional[np.ndarray]) -> torch.Tensor:
        """Weights of length n_items + 1 (w[0] == 0), padded and placed
        next to M as int32; None = the device-built all-ones vector."""
        if w is None:
            return self._ones_w()
        w = np.asarray(w)
        if len(w) != self.n_items + 1:
            raise ValueError(f"weights of length {len(w)}, expected {self.n_items + 1}")
        if w.size and (w.min() < 0 or w.max() >= 2**31):
            raise ValueError("weights must lie in [0, 2^31)")
        wp = np.zeros(self.n_items_pad, dtype=np.int32)
        wp[: self.n_items + 1] = w
        return torch.from_numpy(wp).to(self.device)

    def hist(self, weights: Optional[np.ndarray] = None) -> np.ndarray:
        """int64 weighted coverage histogram of size n_groups + 1; None
        weights = the unweighted (all-ones) histogram."""
        return self.hist_multi([weights])[0]

    def hist_multi(self, weight_list) -> List[np.ndarray]:
        """Several weighted histograms in ONE pass over M (node + bp share
        it); entries may be None (= all-ones, built on the device)."""
        W = torch.stack([self._w_dev(w) for w in weight_list])
        out = hist_kernels.fused_hist(self.M, W, self.n_groups + 2)
        out = out[:, : self.n_groups + 1].cpu().numpy()
        return [out[v] for v in range(len(weight_list))]

    def ordered_growth(
        self, weights: np.ndarray, quorum_rel: float, c_min: int
    ) -> np.ndarray:
        """int64 [n_groups]: at each group position (path order) the summed
        weight of the items that meet the coverage floor c_min and the
        quorum (reference: abacus.rs:988-1032). The per-position thresholds
        ceil((g + 1) * quorum_rel) are taken on the host in float64, as
        panacus_tpu does (engine.py:272-275)."""
        if self.n_groups == 0:
            return np.zeros(0, dtype=np.int64)
        g = np.arange(1, self.n_groups + 1, dtype=np.int64)
        thr = np.ceil(g * quorum_rel).astype(np.int32)
        out = group_kernels.ordered_growth(
            self.M, self._w_dev(weights), torch.from_numpy(thr), c_min
        )
        return out.cpu().numpy()

    def similarity(self, weights: np.ndarray) -> np.ndarray:
        """float64 [n_groups, n_groups] of the exact int64 weighted group
        co-occurrence counts (reference: similarity.rs:119-150); weights
        are integers of length n_items + 1 with weights[0] == 0."""
        w = self._w_dev(weights)
        w_max = 1 if weights is None else int(np.max(weights))
        S = group_kernels.similarity(self.M, w, w_max)
        return S[: self.n_groups, : self.n_groups].cpu().numpy().astype(np.float64)


class MembershipStream:
    """Builds an engine's M one 32-group word row at a time while the host
    tokenizes paths.

    `host_row(word)` hands the packers a zeroed numpy view to fill in
    place: on the CPU a row of the final matrix (finalize never copies); on
    CUDA a pinned host row, which `feed` copies into the preallocated,
    zeroed device M on a side stream, so uploads ride under the host's
    tokenization of the next slab. `finalize` makes the current stream
    wait for those copies. Words never fed stay zero."""

    def __init__(self, n_items: int, n_groups: int, device: torch.device):
        self.engine = CountingEngine(n_items, n_groups, device)
        eng = self.engine
        self._fed: set = set()
        self._cuda = eng.device.type == "cuda"
        if self._cuda:
            eng.M = torch.zeros(
                (eng.n_words, eng.n_items_pad), dtype=torch.int32, device=eng.device
            )
            self._copy_stream = torch.cuda.Stream(eng.device)
            # the copies must not overtake the zero fill of M
            self._copy_stream.wait_stream(torch.cuda.current_stream(eng.device))
            self._host_rows: dict = {}  # word -> host tensor, alive until finalize
            self._events: list = []
        else:
            self._M_host = np.zeros((eng.n_words, eng.n_items_pad), dtype=np.uint32)

    def host_row(self, word: int) -> np.ndarray:
        """A writable, zeroed uint32[n_items_pad] row for `word`."""
        if not self._cuda:
            return self._M_host[word]
        if word not in self._host_rows:
            self._host_rows[word] = torch.zeros(
                self.engine.n_items_pad, dtype=torch.int32, pin_memory=True
            )
        return self._host_rows[word].numpy().view(np.uint32)

    def feed(self, word: int, row: np.ndarray) -> None:
        """row: the view host_row(word) returned, now holding this word's
        group bits. On CUDA the copy is issued asynchronously: do not mutate
        row afterwards."""
        if not 0 <= word < self.engine.n_words:
            raise ValueError(f"word {word} out of range")
        if word in self._fed:
            raise ValueError(f"word {word} fed twice")
        if self._cuda:
            src = self._host_rows.get(word)
            own = src is not None and np.shares_memory(row, src.numpy())
        else:
            own = np.shares_memory(row, self._M_host[word])
        if not own:
            raise ValueError(f"feed takes the row host_row({word}) returned")
        self._fed.add(word)
        if not self._cuda:
            return
        with torch.cuda.stream(self._copy_stream):
            self.engine.M[word].copy_(src, non_blocking=True)
            ev = torch.cuda.Event()
            ev.record(self._copy_stream)
        self._events.append(ev)

    def finalize(self) -> CountingEngine:
        eng = self.engine
        if not self._cuda:
            eng.M = torch.from_numpy(self._M_host.view(np.int32))
            return eng
        current = torch.cuda.current_stream(eng.device)
        for ev in self._events:
            current.wait_event(ev)
        # M was written on the copy stream; tell the allocator it is in use there
        eng.M.record_stream(self._copy_stream)
        self._events = []
        self._host_rows = {}
        return eng
