"""Coverage abaci on the port's engine.

Port of panacus_tpu/abacus.py: AbacusByTotal, construct_hists and
AbacusByGroup, plus the host helpers path_order_groups,
build_membership_host and quantify_uncovered_bps (panacus_tpu.abacus
starts JAX; the port imports nothing of panacus_tpu). Both abaci read one
packed membership
matrix on a CountingEngine. (reference: src/graph_broker/abacus.rs:476-1229)
"""

from __future__ import annotations

import logging
from typing import Dict, List, Optional, Tuple

import numpy as np

from .gfa import GraphStorage, ItemTable, PathSegment
from .itemize import ItemizeResult
from .mask import GraphMask
from .native import build_membership, format_table
from .ops.engine import CountingEngine, Devices
from .runtime import effective_threads
from .utils import ActiveTable, CountType, IntervalContainer, Threshold

log = logging.getLogger("panacus")


def path_order_groups(
    mask: GraphMask, path_segments: List[PathSegment]
) -> Tuple[List[Tuple[int, int]], List[str]]:
    """Resolve (path_idx, group_idx) in processing order plus ordered group
    names (reference: abacus.rs:556-567 group-block walk)."""
    order = mask.get_path_order(path_segments)
    groups: List[str] = []
    out: List[Tuple[int, int]] = []
    for path_id, group_name in order:
        if not groups or groups[-1] != group_name:
            groups.append(group_name)
        out.append((path_id, len(groups) - 1))
    return out, groups


def build_membership_host(
    item_table: ItemTable,
    path_order: List[Tuple[int, int]],
    exclude_table: Optional[ActiveTable],
    n_items: int,
    n_groups: int,
    n_items_pad: int,
) -> np.ndarray:
    """Packed membership matrix M[n_words, n_items_pad] built on the host:
    one OR per (path, group) block. Excluded items are zeroed afterwards
    (an all-zero column counts as coverage 0, as the reference's per-visit
    exclude check, abacus.rs:736-737)."""
    n_words = max((n_groups + 31) // 32, 1)
    M = np.zeros((n_words, n_items_pad), dtype=np.uint32)
    if path_order:
        pids = np.fromiter(
            (p for p, _ in path_order), dtype=np.int64, count=len(path_order)
        )
        gidx = np.fromiter(
            (g for _, g in path_order), dtype=np.int64, count=len(path_order)
        )
        build_membership(
            item_table.items,
            item_table.prefsum,
            pids,
            gidx,
            M,
            effective_threads(),
        )
    if exclude_table is not None:
        excluded = np.flatnonzero(exclude_table.items)
        M[:, excluded] = 0
    M[:, 0] = 0  # sentinel slot
    return M


def quantify_uncovered_bps(
    exclude_table: Optional[ActiveTable],
    subset_covered_bps: Optional[IntervalContainer],
    graph: GraphStorage,
) -> Dict[int, int]:
    """Per-node uncovered bp from partial subset coverage
    (reference: abacus.rs:1187-1229)."""
    res: Dict[int, int] = {}
    if subset_covered_bps is not None:
        for sid in subset_covered_bps.keys():
            if exclude_table is None or not exclude_table.items[sid]:
                l = graph.node_len(sid)
                ex = (
                    exclude_table.get_active_intervals(sid, l)
                    if exclude_table is not None
                    else None
                )
                covered = subset_covered_bps.total_coverage(sid, ex)
                if covered > l:
                    log.error(
                        "oops, total coverage %d is larger than node length %d "
                        "for node %d",
                        covered,
                        l,
                        sid,
                    )
                else:
                    res[sid] = l - covered
    return res


def group_multiplicities(
    item_table: ItemTable,
    exclude_table: Optional[ActiveTable],
    path_order: List[Tuple[int, int]],
    n_groups: int,
    n_items: int,
) -> List[Tuple[int, np.ndarray, np.ndarray]]:
    """Per group with a visit to a countable: (group, its items ascending,
    their multiplicities), excluded items and the sentinel dropped. One
    group at a time (a dense bincount each), so the peak extra memory is
    one group's visits plus the nonzeros."""
    paths_by_group: List[List[int]] = [[] for _ in range(n_groups)]
    for pid, gi in path_order:
        paths_by_group[gi].append(pid)
    excluded = np.flatnonzero(exclude_table.items) if exclude_table is not None else None
    per_group: List[Tuple[int, np.ndarray, np.ndarray]] = []
    for gi, pids in enumerate(paths_by_group):
        slices = [s for s in map(item_table.path_slice, pids) if len(s)]
        if not slices:
            continue
        visits = slices[0] if len(slices) == 1 else np.concatenate(slices)
        cnt = np.bincount(visits, minlength=n_items + 1)
        if excluded is not None and len(excluded):
            cnt[excluded] = 0
        cnt[0] = 0
        nz = np.flatnonzero(cnt)
        if len(nz):
            per_group.append((gi, nz, cnt[nz].astype(np.int64)))
    return per_group


class AbacusByTotal:
    """Coverage histogram per count type (reference: abacus.rs:476-788)."""

    def __init__(
        self,
        count: CountType,
        engine: CountingEngine,
        groups: List[str],
        uncovered_bps: Dict[int, int],
        graph: GraphStorage,
    ):
        self.count = count
        self.engine = engine
        self.groups = groups
        self.uncovered_bps = uncovered_bps
        self._graph = graph
        self._countable: Optional[np.ndarray] = None

    @classmethod
    def from_itemization(
        cls,
        count: CountType,
        slot: int,
        itemized: ItemizeResult,
        path_order: List[Tuple[int, int]],
        groups: List[str],
        graph: GraphStorage,
        devices: Devices,
    ) -> "AbacusByTotal":
        n_items = graph.number_of_items(count)
        engine = CountingEngine(n_items, len(groups), devices)
        M_host = build_membership_host(
            itemized.item_tables[slot],
            path_order,
            itemized.exclude_tables[slot],
            n_items,
            len(groups),
            engine.n_items_pad,
        )
        engine.build_from_host_matrix(M_host)
        uncovered = quantify_uncovered_bps(
            itemized.exclude_tables[slot],
            itemized.subset_covered_bps if count == CountType.BP else None,
            graph,
        )
        log.info(
            "abacus has %d path groups and %d countables", len(groups), n_items
        )
        return cls(count, engine, groups, uncovered, graph)

    @property
    def countable(self) -> np.ndarray:
        """Per-item coverage; slot 0 is the sentinel (reported as max-u32 to
        mirror reference abacus.rs:551)."""
        if self._countable is None:
            cov = self.engine.coverage().astype(np.int64)
            cov[0] = np.iinfo(np.uint32).max
            self._countable = cov
        return self._countable

    def _hist_weights(self, bps: bool) -> "np.ndarray | None":
        """Weight vector for the total hist; None = all-ones, which the
        engine builds on the device."""
        if not bps:
            return None
        w = self._graph.node_lens[: self.engine.n_items + 1].astype(np.int64)
        w[0] = 0
        return w

    def _finish_hist_bps(self, hist: np.ndarray) -> np.ndarray:
        if self.uncovered_bps:  # unmasked runs skip the coverage fetch
            cov = self.countable
            for sid, uncov in self.uncovered_bps.items():
                hist[cov[sid]] -= uncov
                hist[0] += uncov
        return hist


def construct_hists(abaci: "Dict[CountType, AbacusByTotal]"):
    """All total hists for a run. Count types sharing one engine (node + bp
    on the streamed build) share one pass over the membership matrix."""
    by_engine: Dict[int, List[CountType]] = {}
    for ct, ab in abaci.items():
        by_engine.setdefault(id(ab.engine), []).append(ct)
    hists: Dict[CountType, np.ndarray] = {}
    for cts in by_engine.values():
        engine = abaci[cts[0]].engine
        ws = [abaci[ct]._hist_weights(ct == CountType.BP) for ct in cts]
        hs = engine.hist_multi(ws)
        for ct, h in zip(cts, hs):
            if ct == CountType.BP:
                h = abaci[ct]._finish_hist_bps(h)
            hists[ct] = h
    return hists


class AbacusByGroup:
    """Group-resolved coverage on the same membership matrix
    (reference: abacus.rs:790-1179). Group ids follow the mask's path order;
    ordered growth and similarity run on the engine, the table export
    resolves the sparse multiplicities on the host."""

    def __init__(
        self,
        count: CountType,
        engine: CountingEngine,
        groups: List[str],
        uncovered_bps: Dict[int, int],
        graph: GraphStorage,
        itemized: ItemizeResult,
        slot: int,
        path_order: List[Tuple[int, int]],
    ):
        self.count = count
        self.engine = engine
        self.groups = groups
        self.uncovered_bps = uncovered_bps
        self._graph = graph
        # kept for the multiplicity export (table analysis only)
        self._itemized = itemized
        self._slot = slot
        self._path_order = path_order
        self._sparse_cache: Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]] = None

    @classmethod
    def from_itemization(
        cls,
        count: CountType,
        slot: int,
        itemized: ItemizeResult,
        path_order: List[Tuple[int, int]],
        groups: List[str],
        graph: GraphStorage,
        devices: Devices,
    ) -> "AbacusByGroup":
        total = AbacusByTotal.from_itemization(
            count, slot, itemized, path_order, groups, graph, devices
        )
        return cls(
            count, total.engine, groups, total.uncovered_bps, graph, itemized,
            slot, path_order,
        )

    def _weights(self) -> np.ndarray:
        """Per-item growth weight: 1 for node/edge, covered bp for bp
        (reference: abacus.rs:1010-1026)."""
        n = self.engine.n_items
        if self.count == CountType.BP:
            w = self._graph.node_lens[: n + 1].astype(np.int64)
            for sid, uncov in self.uncovered_bps.items():
                covered = int(w[sid])
                if uncov > covered:
                    log.error(
                        "oops, #uncovered bps (%d) is larger than #covered bps "
                        "(%d) for node with sid %d",
                        uncov,
                        covered,
                        sid,
                    )
                    w[sid] = 0
                else:
                    w[sid] = covered - uncov
        else:
            w = np.ones(n + 1, dtype=np.int64)
        w[0] = 0
        return w

    def calc_growth(self, t_coverage: Threshold, t_quorum: Threshold) -> List[float]:
        """Ordered growth curve (reference: abacus.rs:988-1032)."""
        n_groups = len(self.groups)
        c = max(1, t_coverage.to_absolute(n_groups))
        q = max(0.0, t_quorum.to_relative(n_groups))
        res = self.engine.ordered_growth(self._weights(), q, c)
        return [float(x) for x in res]

    def similarity_matrix(self) -> Tuple[np.ndarray, np.ndarray]:
        """(intersections[G, G], sizes[G]) weighted by node length for bp
        (reference: src/analyses/similarity.rs:119-163). The bp weights go
        through float32 as in panacus_tpu (abacus.py:355-361), so node
        lengths above 2^24 round the same way there and here."""
        n = self.engine.n_items
        if self.count == CountType.BP:
            w = self._graph.node_lens[: n + 1].astype(np.float32).astype(np.int64)
        else:
            w = np.ones(n + 1, dtype=np.int64)
        w[0] = 0
        inter = self.engine.similarity(w)
        sizes = np.diagonal(inter).copy()
        return inter, sizes

    def sparse_counts(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(items, group_ids, multiplicities) of the occurrence matrix, items
        ascending and groups in path order within an item: the CSC (r, c, v)
        equivalent for the table export (reference: compute_column_values
        abacus.rs:901-986). A multi-process build gathered them already
        (parallel.ingest, `mh_triplets`); here no collective runs."""
        if self._sparse_cache is not None:
            return self._sparse_cache
        gathered = getattr(self._itemized, "mh_triplets", None)
        if gathered is not None:
            self._sparse_cache = gathered[self._slot]
            return self._sparse_cache
        n_items = self.engine.n_items
        per_group = group_multiplicities(
            self._itemized.item_tables[self._slot],
            self._itemized.exclude_tables[self._slot],
            self._path_order,
            len(self.groups),
            n_items,
        )
        if not per_group:
            z = np.zeros(0, dtype=np.int64)
            return z, z.copy(), z.copy()
        # counting placement instead of a global sort: each group's nonzero
        # list is item-sorted with unique items, so ptr[nz] places the
        # (item, group) runs row-major with groups in path order per item
        row_counts = np.zeros(n_items + 2, dtype=np.int64)
        for _, nz, _ in per_group:
            row_counts[nz + 1] += 1
        ptr = np.cumsum(row_counts)[:-1]
        nnz = int(ptr[-1] + row_counts[-1])
        items = np.empty(nnz, dtype=np.int64)
        group_ids = np.empty(nnz, dtype=np.int64)
        counts = np.empty(nnz, dtype=np.int64)
        for gi, nz, c in per_group:
            pos = ptr[nz]
            items[pos] = nz
            group_ids[pos] = gi
            counts[pos] = c
            ptr[nz] += 1
        self._sparse_cache = (items, group_ids, counts)
        return self._sparse_cache

    def to_tsv(self, total: bool, graph: GraphStorage) -> str:
        """Full or total coverage table (reference: abacus.rs:1056-1178), in
        chunks of dense rows scattered from the sparse counts and formatted
        by the threaded C formatter (native.format_table)."""
        log.info("reporting coverage table")
        n_groups = len(self.groups)
        items, group_ids, counts = self.sparse_counts()
        n_items = self.engine.n_items
        starts = np.searchsorted(items, np.arange(1, n_items + 2))

        head = "node" if self.count in (CountType.NODE, CountType.BP) else "edge"
        header = head + (
            "\ttotal" if total else "".join(f"\t{g}" for g in self.groups)
        ) + "\n"

        # per-item bp multiplier (covered bp for bp counts, else 1)
        if self.count == CountType.BP:
            bp = self._graph.node_lens[: n_items + 1].astype(np.int64)
            for sid, unc in self.uncovered_bps.items():
                bp[sid] -= unc
        else:
            bp = None

        body: List[bytes] = []
        CHUNK = 1 << 16
        dense = None if total else np.zeros((CHUNK, n_groups), dtype=np.int64)
        for lo in range(1, n_items + 1, CHUNK):
            hi = min(lo + CHUNK, n_items + 1)
            n_rows = hi - lo
            a, b = starts[lo - 1], starts[hi - 1]
            if total:
                vals = np.diff(starts[lo - 1 : hi]).reshape(-1, 1)
            else:
                # each present group gets its multiplicity (x bp for bp
                # counts); the reference's edge branch (abacus.rs:1164)
                # mis-indexes v by group id; this emits the evidently
                # intended per-slot multiplicity, as panacus_tpu does
                mult = counts[a:b]
                if bp is not None:
                    mult = mult * bp[items[a:b]]
                vals = dense[:n_rows]
                vals[items[a:b] - lo, group_ids[a:b]] = mult
            ids = np.arange(lo, hi, dtype=np.int64)
            names = (
                graph.node_names_fixed(ids)
                if head == "node"
                else graph.edge_names_fixed(ids)
            )
            body.append(format_table(vals, names, effective_threads()))
            if not total:
                # clear only the cells this chunk scattered (buffer reuse)
                vals[items[a:b] - lo, group_ids[a:b]] = 0
        return header + b"".join(body).decode("utf-8")
