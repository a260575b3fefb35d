"""Device compute core: the packed node-x-group membership bit matrix.

Port of panacus_tpu/ops/engine.py (CountingEngine, MembershipStream, the
build from occurrence pairs and the sharded dispatch) to PyTorch.
M[n_words, n_items_pad] holds bit (g % 32) of word M[g // 32, i] when item
i occurs in path group g; it is stored as int32 (the same bits as the
reference's uint32). Items are 1-based dense ids, 0 is a sentinel with
weight 0, and the item axis is zero-padded.

coverage   = popcount-reduce over words     (== AbacusByTotal.countable)
hist       = weighted bincount of coverage  (== construct_hist / _bps)
ordered    = per-item scan over the groups  (== AbacusByGroup::calc_growth)
similarity = weighted group co-occurrence   (== Similarity::set_table)

They run through ops.hist_kernels and ops.group_kernels: the CUDA kernels
for M on a GPU, the plain PyTorch versions for M on the CPU.

An engine lives on a tuple of devices, one item shard each
(runtime.resolve_devices gives every visible GPU; a tuple may name one
device several times). n_items_pad is a multiple of ITEM_ALIGN * k, and
shard s holds the columns [s * n_items_pad / k, (s + 1) * n_items_pad / k)
as its own contiguous tensor on devices[s]. Every op is elementwise over
items or a reduction over them, so each shard runs the kernel on its own
columns (every shard's launch is issued before the first copy back to the
host) and the host adds the partials in int64: n_bins, n_groups or
n_groups^2 values a shard, as panacus_tpu's shard_map dispatch does
(engine.py:398-540). No shard's M leaves its device. Results are exact
int64 for any weight total.

In a multi-process run (runtime.init_distributed) the item axis is split
over every device of every process: process p of P owns the columns
[p * n_items_pad / P, (p + 1) * n_items_pad / P) and splits them over its
k devices as above; n_items_pad is then a multiple of ITEM_ALIGN * P *
the lcm of the processes' k, and `bounds` are global item ranges. The
processes' int64 partials are summed by an all_reduce, and `coverage`
all_gathers the processes' item blocks in rank order (panacus_tpu's
fetch_parts, engine.py:398-407). One process is the case p = 0, P = 1.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..runtime import all_gather_cat, all_reduce_sum, comm_device, host_all_gather, span, world
from . import group_kernels, hist_kernels

ITEM_ALIGN = 1 << 14

Devices = Tuple[torch.device, ...]
DeviceArg = Union[torch.device, str, Sequence[Union[torch.device, str]]]


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def as_devices(devices: DeviceArg) -> Devices:
    """The shard devices `devices` names: one device (or its name) is a
    tuple of one; a CUDA device without an index is the current one, so
    that shards on one card compare equal. All lie on one device type."""
    if isinstance(devices, (torch.device, str)):
        devices = (devices,)
    out = []
    for d in devices:
        d = torch.device(d)
        if d.type == "cuda" and d.index is None:
            d = torch.device("cuda", torch.cuda.current_device())
        out.append(d)
    if not out or len({d.type for d in out}) != 1:
        raise ValueError(f"need one or more devices of one type, got {devices}")
    return tuple(out)


def _host_sum(parts: List[torch.Tensor]) -> torch.Tensor:
    """The shards' int64 partials copied to the host and added, then summed
    over the processes of a multi-process run."""
    return all_reduce_sum(torch.stack([p.cpu() for p in parts]).sum(0))


def dedup_pairs(
    items: torch.Tensor, groups: torch.Tensor, n_groups: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The distinct (item, group) pairs, sorted by item and then group:
    the semantic core of the reference's `last[sid] != group_id` dedup
    (abacus.rs:733-743). int64, on the pairs' device."""
    key = torch.unique(items.to(torch.int64) * n_groups + groups.to(torch.int64))
    return key // n_groups, key % n_groups


def pack_pairs(
    items: torch.Tensor, groups: torch.Tensor, n_words: int
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Distinct (item, group) pairs -> unique (item, word, bits) updates,
    the group bits of each (item, word) ORed together (added: distinct
    pairs set distinct bits); bits are int64 in [0, 2^32)."""
    items, groups = items.to(torch.int64), groups.to(torch.int64)
    key, inverse = torch.unique(items * n_words + (groups >> 5), return_inverse=True)
    bits = torch.zeros(key.numel(), dtype=torch.int64, device=key.device)
    bits.index_add_(0, inverse, torch.ones_like(groups) << (groups & 31))
    return key // n_words, key % n_words, bits


def membership_from_pairs(
    n_words: int, n_items: int, items: torch.Tensor, groups: torch.Tensor
) -> torch.Tensor:
    """int32 [n_words, n_items] membership of distinct (item, group) pairs,
    built on their device: one index_put_ of the packed words (the indices
    are unique, so the assignment is the OR), bit 31 as the sign bit."""
    M = torch.zeros((n_words, n_items), dtype=torch.int32, device=items.device)
    u_items, u_words, bits = pack_pairs(items, groups, n_words)
    bits = torch.where(bits >= 2**31, bits - 2**32, bits).to(torch.int32)
    M.index_put_((u_words, u_items), bits)
    return M


class CountingEngine:
    """Holds the membership matrix for one (graph, mask, count-type) state,
    split along the item axis over `devices` (a device, or a tuple of them:
    one shard each)."""

    def __init__(self, n_items: int, n_groups: int, devices: DeviceArg):
        self.n_items = n_items
        self.n_groups = n_groups
        self.n_words = max((n_groups + 31) // 32, 1)
        self.devices = as_devices(devices)
        k = len(self.devices)
        rank, self.world_size = world()
        ks = [k]
        if self.world_size > 1:  # every process's shard count
            ks = [int(x) for x in host_all_gather(torch.tensor([k]))]
        self.n_items_pad = _round_up(
            n_items + 1, ITEM_ALIGN * self.world_size * math.lcm(*ks)
        )
        # this process's global columns [item_lo, item_lo + proc_items)
        self.proc_items = self.n_items_pad // self.world_size
        self.item_lo = rank * self.proc_items
        self.shard_items = self.proc_items // k
        # [lo, hi) global columns of each local shard
        self.bounds = [
            (self.item_lo + s * self.shard_items, self.item_lo + (s + 1) * self.shard_items)
            for s in range(k)
        ]
        self.shards: List[torch.Tensor] = []
        self._ones: Optional[List[torch.Tensor]] = None

    @classmethod
    def from_host_state(
        cls,
        M_uint32: np.ndarray,
        n_items: int,
        n_groups: int,
        devices: DeviceArg,
    ) -> "CountingEngine":
        """Adopt a membership matrix fetched from another engine (e.g.
        `np.asarray(jax_engine.M)`), whatever item padding it carries:
        columns past n_items must be zero and are re-padded to this
        engine's n_items_pad."""
        eng = cls(n_items, n_groups, devices)
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

    def build(
        self, items: np.ndarray, groups: np.ndarray, dedup: bool = True
    ) -> "CountingEngine":
        """M from occurrence pairs, in any order: item items[j] in [0,
        n_items] occurs in group groups[j] in [0, n_groups). Each shard
        takes the pairs of its items and builds its columns on its device
        (in a multi-process run, the pairs of other processes' items are
        dropped). dedup=False promises that the pairs are distinct. Excluded items
        must be filtered by the caller."""
        items = np.asarray(items, dtype=np.int64)
        groups = np.asarray(groups, dtype=np.int64)
        if items.ndim != 1 or items.shape != groups.shape:
            raise ValueError(f"pairs of shapes {items.shape} and {groups.shape}")
        if items.size and (
            items.min() < 0
            or items.max() > self.n_items
            or groups.min() < 0
            or groups.max() >= self.n_groups
        ):
            raise ValueError(
                f"pairs must lie in items [0, {self.n_items}] and groups "
                f"[0, {self.n_groups})"
            )
        if self.world_size > 1:
            mine = (items >= self.item_lo) & (items < self.item_lo + self.proc_items)
            items, groups = items[mine], groups[mine]
        k = len(self.devices)
        cuts = [0, items.size]
        if k > 1:  # one pass: the pairs sorted by shard (a radix sort of small keys)
            sid = ((items - self.item_lo) // self.shard_items).astype(
                np.min_scalar_type(k - 1)
            )
            order = np.argsort(sid, kind="stable")
            items, groups = items[order], groups[order]
            cuts = np.concatenate([[0], np.cumsum(np.bincount(sid, minlength=k))])
        shards = []
        for s, (dev, (lo, hi)) in enumerate(zip(self.devices, self.bounds)):
            a, b = cuts[s], cuts[s + 1]
            it = torch.from_numpy(items[a:b] - lo).to(dev)
            gr = torch.from_numpy(groups[a:b]).to(dev)
            if dedup:
                it, gr = dedup_pairs(it, gr, self.n_groups)
            shards.append(membership_from_pairs(self.n_words, hi - lo, it, gr))
        self.shards = shards
        self._ones = None
        return self

    def build_from_host_matrix(self, M_host: np.ndarray) -> "CountingEngine":
        """Adopt a host-assembled uint32 [n_words, n_items_pad] matrix (the
        whole M, in every process of a multi-process run): one upload of
        each local shard's columns (zero-copy for one CPU shard)."""
        if M_host.shape != (self.n_words, self.n_items_pad):
            raise ValueError(
                f"M has shape {M_host.shape}, expected "
                f"{(self.n_words, self.n_items_pad)}"
            )
        M = np.ascontiguousarray(M_host).view(np.int32)
        self.shards = [
            torch.from_numpy(np.ascontiguousarray(M[:, lo:hi])).to(dev)
            for dev, (lo, hi) in zip(self.devices, self.bounds)
        ]
        self._ones = None
        return self

    def coverage(self) -> np.ndarray:
        """Per-item distinct-group count, length n_items + 1 (slot 0 sentinel)."""
        # this process's block where the collective takes it, then all blocks
        covs = [hist_kernels.coverage(m) for m in self.shards]
        cov = all_gather_cat(torch.cat([c.to(comm_device()) for c in covs])).numpy()
        return cov[: self.n_items + 1]

    def _ones_w(self) -> List[torch.Tensor]:
        """All-ones weights with the sentinel and padding zeroed, built on
        each shard's device (the hot path never uploads a ones vector)."""
        if self._ones is None:
            self._ones = []
            for dev, (lo, hi) in zip(self.devices, self.bounds):
                ones = torch.zeros(hi - lo, dtype=torch.int32, device=dev)
                a, b = max(lo, 1), min(hi, self.n_items + 1)
                if b > a:
                    ones[a - lo : b - lo] = 1
                self._ones.append(ones)
        return self._ones

    def _w_dev(self, w: Optional[np.ndarray]) -> List[torch.Tensor]:
        """Weights of length n_items + 1 (w[0] == 0), padded and placed
        next to each shard as int32; None = the device-built all-ones."""
        if w is None:
            return self._ones_w()
        w = np.asarray(w)
        if len(w) != self.n_items + 1:
            raise ValueError(f"weights of length {len(w)}, expected {self.n_items + 1}")
        if w.size and (w.min() < 0 or w.max() >= 2**31):
            raise ValueError("weights must lie in [0, 2^31)")
        wp = np.zeros(self.n_items_pad, dtype=np.int32)
        wp[: self.n_items + 1] = w
        return [
            torch.from_numpy(wp[lo:hi]).to(dev)
            for dev, (lo, hi) in zip(self.devices, self.bounds)
        ]

    def hist(self, weights: Optional[np.ndarray] = None) -> np.ndarray:
        """int64 weighted coverage histogram of size n_groups + 1; None
        weights = the unweighted (all-ones) histogram."""
        return self.hist_multi([weights])[0]

    def hist_multi(self, weight_list) -> List[np.ndarray]:
        """Several weighted histograms in ONE pass over M (node + bp share
        it); entries may be None (= all-ones, built on the device)."""
        ws = [self._w_dev(w) for w in weight_list]
        parts = [
            hist_kernels.fused_hist(m, torch.stack([w[s] for w in ws]), self.n_groups + 2)
            for s, m in enumerate(self.shards)
        ]
        out = _host_sum(parts)[:, : self.n_groups + 1].numpy()
        return [out[v] for v in range(len(weight_list))]

    def ordered_growth(
        self, weights: np.ndarray, quorum_rel: float, c_min: int
    ) -> np.ndarray:
        """int64 [n_groups]: at each group position (path order) the summed
        weight of the items that meet the coverage floor c_min and the
        quorum (reference: abacus.rs:988-1032). The per-position thresholds
        ceil((g + 1) * quorum_rel) are taken on the host in float64, as
        panacus_tpu does (engine.py:272-275); every shard scans its items
        with the same ones (the counts are per item)."""
        if self.n_groups == 0:
            return np.zeros(0, dtype=np.int64)
        g = np.arange(1, self.n_groups + 1, dtype=np.int64)
        thr = torch.from_numpy(np.ceil(g * quorum_rel).astype(np.int32))
        parts = [
            group_kernels.ordered_growth(m, w, thr, c_min)
            for m, w in zip(self.shards, self._w_dev(weights))
        ]
        return _host_sum(parts).numpy()

    def similarity(self, weights: np.ndarray) -> np.ndarray:
        """float64 [n_groups, n_groups] of the exact int64 weighted group
        co-occurrence counts (reference: similarity.rs:119-150); weights
        are integers of length n_items + 1 with weights[0] == 0. Every
        shard is given the global max(w), so all take the same byte
        planes and none reads its weights back."""
        w_max = 1 if weights is None else int(np.max(weights))
        parts = [
            group_kernels.similarity(m, w, w_max)
            for m, w in zip(self.shards, self._w_dev(weights))
        ]
        S = _host_sum(parts)
        return S[: self.n_groups, : self.n_groups].numpy().astype(np.float64)


class MembershipStream:
    """Builds an engine's M one 32-group word row at a time while the host
    tokenizes paths.

    `host_row(word)` hands the packers a zeroed numpy row of all
    n_items_pad items to fill in place: on the CPU a row of the final
    matrix, which finalize splits into the shards (one shard: no copy); on
    CUDA a pinned host row, whose slice of each shard's columns `feed`
    copies into that shard's preallocated, zeroed M on its device's side
    stream, so uploads ride under the host's tokenization of the next
    slab. `finalize` makes each device's current stream wait for those
    copies. Words never fed stay zero."""

    def __init__(self, n_items: int, n_groups: int, devices: DeviceArg):
        with span("build.alloc"):
            self.engine = CountingEngine(n_items, n_groups, devices)
            eng = self.engine
            self._fed: set = set()
            self._cuda = eng.devices[0].type == "cuda"
            if self._cuda:
                eng.shards = [
                    torch.zeros((eng.n_words, eng.shard_items), dtype=torch.int32, device=d)
                    for d in eng.devices
                ]
                self._copy_streams = {}  # one side stream per device
                for d in eng.devices:
                    if d not in self._copy_streams:
                        stream = torch.cuda.Stream(d)
                        # the copies must not overtake the zero fills of M
                        stream.wait_stream(torch.cuda.current_stream(d))
                        self._copy_streams[d] = stream
                self._host_rows: dict = {}  # word -> host tensor, alive until finalize
                self._events: List[list] = [[] for _ in eng.devices]  # per shard
            else:
                self._M_host = np.zeros((eng.n_words, eng.n_items_pad), dtype=np.uint32)

    def host_row(self, word: int) -> np.ndarray:
        """A writable, zeroed uint32[n_items_pad] row for `word`."""
        if not self._cuda:
            return self._M_host[word]
        if word not in self._host_rows:
            with span("build.alloc"):
                self._host_rows[word] = torch.zeros(
                    self.engine.n_items_pad, dtype=torch.int32, pin_memory=True
                )
        return self._host_rows[word].numpy().view(np.uint32)

    def feed(self, word: int, row: np.ndarray) -> None:
        """row: the view host_row(word) returned, now holding this word's
        group bits. On CUDA the copies are issued asynchronously: do not
        mutate row afterwards."""
        eng = self.engine
        if not 0 <= word < eng.n_words:
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
        for s, (dev, (lo, hi)) in enumerate(zip(eng.devices, eng.bounds)):
            stream = self._copy_streams[dev]
            with torch.cuda.stream(stream):
                eng.shards[s][word].copy_(src[lo:hi], non_blocking=True)
                ev = torch.cuda.Event()
                ev.record(stream)
            self._events[s].append(ev)

    def device_rows(self) -> Tuple[torch.Tensor, Optional["torch.cuda.Stream"]]:
        """The zeroed M of a one-shard stream, for a kernel that ORs rows into
        it in place, and the stream such writes go on (None on the CPU, where
        the tensor shares the host matrix). `written` then names the words."""
        eng = self.engine
        if len(eng.devices) != 1:
            raise ValueError("device_rows takes a stream on one device")
        if not self._cuda:
            return torch.from_numpy(self._M_host.view(np.int32)), None
        return eng.shards[0], self._copy_streams[eng.devices[0]]

    def written(self, words) -> None:
        """`words` were written through device_rows: finalize waits for the
        work queued so far on its stream, as for the rows fed."""
        for word in words:
            if not 0 <= word < self.engine.n_words or word in self._fed:
                raise ValueError(f"word {word} out of range or written twice")
            self._fed.add(word)
        if self._cuda:
            ev = torch.cuda.Event()
            ev.record(self._copy_streams[self.engine.devices[0]])
            self._events[0].append(ev)

    def discard(self) -> None:
        """Drop a stream that will not be finalized (its build gave up):
        wait for the copies already issued, so that neither M nor a pinned
        row is freed under one, then release both."""
        if self._cuda:
            for events in self._events:
                for ev in events:
                    ev.synchronize()
            self._events = [[] for _ in self.engine.devices]
            self._host_rows = {}
            self.engine.shards = []
        else:
            self._M_host = None

    def finalize(self) -> CountingEngine:
        eng = self.engine
        if not self._cuda:
            return eng.build_from_host_matrix(self._M_host)
        for s, dev in enumerate(eng.devices):
            current = torch.cuda.current_stream(dev)
            for ev in self._events[s]:
                current.wait_event(ev)
            # M was written on the copy stream; tell the allocator it is in use there
            eng.shards[s].record_stream(self._copy_streams[dev])
        self._events = [[] for _ in eng.devices]
        self._host_rows = {}
        return eng
