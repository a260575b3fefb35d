"""Path/walk itemization: GFA path runs -> per-count-type item tables.

Replaces the reference's hot byte-scanning loop
(reference: src/graph_broker/util.rs:22-366, 412-795) with vectorized host
passes. The fast path (no masks) is pure array concatenation; the masked
path replicates the reference's interval-walking semantics exactly,
including its documented inexactness for partially covered nodes
(see comment at src/graph_broker/util.rs:444-463).
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from .gfa import GraphStorage, ItemTable, PathSegment
from .mask import GraphMask
from .utils import (
    ActiveTable,
    CountType,
    IntervalContainer,
    intersects,
    is_contained,
)

log = logging.getLogger("panacus")

COMPLETE = [(0, (1 << 63) - 1)]


@dataclass
class ItemizeResult:
    item_tables: List[ItemTable]  # one per requested count type
    exclude_tables: List[Optional[ActiveTable]]
    subset_covered_bps: Optional[IntervalContainer]
    paths_len: Dict[PathSegment, Tuple[int, int]]


def _prefetch_runs(graph: GraphStorage, indices, runs: List, n_workers: int):
    """Tokenize the given path indices concurrently into `runs`, one path
    a task, where the batch tokenizer refused a step list: each path's own
    parse then raises the user-facing error, or takes the list
    (counterpart of the reference's rayon par_split, util.rs:1206-1229)."""
    indices = list(indices)
    if n_workers > 1 and len(indices) > 1:
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(max_workers=n_workers) as ex:
            for i, r in zip(indices, ex.map(graph.path_item_run, indices)):
                runs[i] = r
    else:
        for i in indices:
            runs[i] = graph.path_item_run(i)


def itemize_paths(
    graph: GraphStorage,
    mask: GraphMask,
    count_types: List[CountType],
    path_filter: Optional[np.ndarray] = None,
    track_cov_order: bool = False,
) -> ItemizeResult:
    """Single host pass over all P/W lines producing item tables for every
    requested count type (reference: parse_gfa_paths_walks_multiple,
    src/graph_broker/util.rs:22-206).

    Node and Bp share one item table (cloned at the end); Edge gets its own.

    `path_filter` (bool[n_paths]): process only the flagged paths — the
    multi-host path-sliced masked build (parallel.ingest) runs the exact
    interval walker on each host's group range and merges the mask side
    products afterwards. Filtered-out paths contribute nothing (empty CSR
    rows, no paths_len entry, no exclude/coverage marks).

    `track_cov_order`: record (position, sid, a, b) for every covered-bp
    interval add and the position of each node's LAST full-coverage visit
    (position = path_id << 40 | visit index). The covered container's
    remove-on-full-coverage is order-dependent across paths (reference
    util.rs:444-463), so the multi-host merge recomputes the final state
    from these globally ordered events instead of unioning local maps.
    """
    n_paths = len(graph.path_segments)
    item_tables = [ItemTable(n_paths) for _ in count_types]
    subset_covered_bps, exclude_tables, include_map, exclude_map = (
        mask.load_optional_subsetting(graph, count_types)
    )
    if track_cov_order and subset_covered_bps is not None:
        subset_covered_bps._mh_track = (
            np.full(len(graph.node_lens), -1, dtype=np.int64),
            [],
        )
    paths_len: Dict[PathSegment, Tuple[int, int]] = {}

    # map each count type to its computation slot: Node computes via Bp slot
    slot_of: Dict[CountType, List[int]] = {}
    for i, ct in enumerate(count_types):
        eff = CountType.BP if ct == CountType.NODE else ct
        slot_of.setdefault(eff, []).append(i)

    has_include = mask.include_coords is not None
    has_exclude = mask.exclude_coords is not None

    # tokenize paths concurrently: one threaded C batch call writing
    # straight into contiguous CSR storage, or, where it refuses a step
    # list, a thread pool over per-path tokenization (the counterpart of
    # the reference's rayon par_split, util.rs:1206-1229)
    from .runtime import effective_threads

    n_workers = min(effective_threads(), max(n_paths, 1))
    runs: List = [None] * n_paths
    batch = None
    batch_slot: Optional[np.ndarray] = None
    if has_include:
        # subset mode: decide skips up front (coords only), then batch-
        # tokenize exactly the paths that will be processed
        sel = []
        for i, seg in enumerate(graph.path_segments):
            if path_filter is not None and not path_filter[i]:
                continue
            inc = include_map.get(seg.id(), [])
            exc = exclude_map.get(seg.id(), []) if has_exclude else []
            c = seg.coords()
            s0, e0 = c if c is not None else (0, (1 << 63) - 1)
            if intersects(inc, (s0, e0)) or intersects(exc, (s0, e0)):
                sel.append(i)
        if sel:
            batch = graph.all_path_item_runs(np.asarray(sel, dtype=np.int64))
            if batch is not None:
                batch_slot = np.full(n_paths, -1, dtype=np.int64)
                batch_slot[sel] = np.arange(len(sel))
            else:
                _prefetch_runs(graph, sel, runs, n_workers)
    elif path_filter is not None:
        sel = np.flatnonzero(path_filter)
        if len(sel):
            batch = graph.all_path_item_runs(sel)
            if batch is not None:
                batch_slot = np.full(n_paths, -1, dtype=np.int64)
                batch_slot[sel] = np.arange(len(sel))
            else:
                _prefetch_runs(graph, sel, runs, n_workers)
    else:
        batch = graph.all_path_item_runs()
        if batch is None:
            _prefetch_runs(graph, range(n_paths), runs, n_workers)

    if (
        batch is not None
        and not has_include
        and not has_exclude
        and path_filter is None
    ):
        # zero-copy shortcut: no masks at all -> the batch CSR IS the item
        # table; edges pair up vectorized across every path at once
        b_ids, b_orient, b_pref, b_bp = batch
        counts = np.diff(b_pref)
        any_non_edge = False
        for eff_count, slots in slot_of.items():
            table = item_tables[slots[0]]
            if eff_count != CountType.EDGE:
                any_non_edge = True
                table.adopt(b_ids, b_pref)
            else:
                table.adopt(*graph.edge_runs(b_ids, b_orient, b_pref))
        if any_non_edge:
            for i, path_seg in enumerate(graph.path_segments):
                paths_len[path_seg] = (int(counts[i]), int(b_bp[i]))
        for t in item_tables:
            t.finalize()
        for eff_count, slots in slot_of.items():
            for extra in slots[1:]:
                item_tables[extra].items = item_tables[slots[0]].items
                item_tables[extra].prefsum = item_tables[slots[0]].prefsum
        return ItemizeResult(
            item_tables, exclude_tables, subset_covered_bps, paths_len
        )

    if batch is not None:
        b_ids, b_orient, b_pref, _ = batch

        def _run_of(i):
            k = i if batch_slot is None else int(batch_slot[i])
            if k < 0:  # skipped path tokenized after all (shouldn't happen)
                return graph.path_item_run(i)
            a, b = b_pref[k], b_pref[k + 1]
            return b_ids[a:b], b_orient[a:b]

    else:

        def _run_of(i):
            if runs[i] is not None:
                r = runs[i]
                runs[i] = None
                return r
            return graph.path_item_run(i)

    for num_path, path_seg in enumerate(graph.path_segments):
        if path_filter is not None and not path_filter[num_path]:
            for t in item_tables:
                t.close_path(num_path)
            continue
        include_coords = (
            COMPLETE
            if not has_include
            else include_map.get(path_seg.id(), [])
        )
        exclude_coords = (
            [] if not has_exclude else exclude_map.get(path_seg.id(), [])
        )
        c = path_seg.coords()
        start, end = c if c is not None else (0, (1 << 63) - 1)

        if (
            has_include
            and not intersects(include_coords, (start, end))
            and not intersects(exclude_coords, (start, end))
        ):
            for t in item_tables:
                t.close_path(num_path)
            continue

        ids, orient = _run_of(num_path)

        for eff_count, slots in slot_of.items():
            exs = [exclude_tables[i] for i in slots]
            if eff_count != CountType.EDGE and (
                (not has_include or is_contained(include_coords, (start, end)))
                and (not has_exclude or is_contained(exclude_coords, (start, end)))
            ):
                # fast path: full containment -> plain concatenation
                ex = None if not exclude_coords else exs
                table = item_tables[slots[0]]
                table.append(num_path, ids)
                bp_len = int(graph.node_lens[ids].astype(np.uint64).sum())
                if ex is not None:
                    for e in ex:
                        if e is not None:
                            e.items[ids] = True
                paths_len[path_seg] = (len(ids), bp_len)
            elif eff_count != CountType.EDGE:
                node_len, bp_len = _update_tables(
                    item_tables[slots[0]],
                    subset_covered_bps,
                    exs,
                    num_path,
                    graph,
                    ids,
                    orient,
                    include_coords,
                    exclude_coords,
                    start,
                )
                paths_len[path_seg] = (node_len, bp_len)
            elif not has_include and not exclude_coords:
                # no masks: every consecutive pair is included — vectorized
                # (reference walks pairs one by one even unmasked,
                # util.rs:744-791)
                table = item_tables[slots[0]]
                if len(ids) > 1:
                    eids = graph.edge_ids_for_pairs(
                        ids[:-1], orient[:-1], ids[1:], orient[1:]
                    )
                    table.append(num_path, eids)
                else:
                    table.close_path(num_path)
            else:
                _update_tables_edgecount(
                    item_tables[slots[0]],
                    exs[0],
                    num_path,
                    graph,
                    ids,
                    orient,
                    include_coords,
                    exclude_coords,
                    start,
                )

    for t in item_tables:
        t.finalize()
    # Node and Bp share one item table: copy the computed slot into siblings
    for eff_count, slots in slot_of.items():
        for extra in slots[1:]:
            item_tables[extra].items = item_tables[slots[0]].items
            item_tables[extra].prefsum = item_tables[slots[0]].prefsum
    return ItemizeResult(item_tables, exclude_tables, subset_covered_bps, paths_len)


# the covered-bp merge orders visits by path << 40 | visit index in int64
MAX_TRACKED_PATHS = 1 << 23
MAX_TRACKED_VISITS = 1 << 40


def visit_position_base(num_path: int, n_visits: int) -> int:
    """path << 40, the position of path `num_path`'s first visit in the
    global visit order that the multi-process covered-bp merge reads
    (parallel.ingest.merge_covered_container). The positions of every
    visit fit in int64 only for path indices below 2^23 and fewer than
    2^40 visits a path; past that this raises instead of letting the
    positions wrap and scramble the merge."""
    if not 0 <= num_path < MAX_TRACKED_PATHS:
        raise ValueError(
            f"path index {num_path} is past the {MAX_TRACKED_PATHS} paths whose "
            "visit positions (path << 40 | visit) fit in int64: the "
            "multi-process subset merge cannot order this graph's visits"
        )
    if n_visits >= MAX_TRACKED_VISITS:
        raise ValueError(
            f"path {num_path} has {n_visits} visits, past the "
            f"{MAX_TRACKED_VISITS} that a visit position (path << 40 | visit) holds"
        )
    return num_path << 40


def _update_tables(
    item_table: ItemTable,
    subset_covered_bps: Optional[IntervalContainer],
    exclude_tables: List[Optional[ActiveTable]],
    num_path: int,
    graph: GraphStorage,
    ids: np.ndarray,
    orient: np.ndarray,
    include_coords,
    exclude_coords,
    offset: int,
) -> Tuple[int, int]:
    """Interval-walking include/exclude accounting for node/bp counts.

    Bit-exact port of the reference semantics
    (reference: src/graph_broker/util.rs:412-567): nodes overlapping an
    include interval are pushed (once per overlapping interval), partial bp
    coverage is tracked in subset_covered_bps, exclusion marks nodes in
    exclude tables (annotated for bp). The walk runs in C
    (native.interval_walk, a bit-exact port of the reference's loop) and
    returns a compressed event stream, which this replays into the
    interval containers."""
    track = (
        getattr(subset_covered_bps, "_mh_track", None)
        if subset_covered_bps is not None
        else None
    )
    pos_base = visit_position_base(num_path, len(ids)) if track is not None else 0
    if len(ids) == 0:
        item_table.close_path(num_path)
        return 0, 0
    from .native import interval_walk

    cov_present = None
    if subset_covered_bps is not None:
        cov_present = getattr(subset_covered_bps, "_present", None)
        if cov_present is None:
            cov_present = np.zeros(len(graph.node_lens), dtype=np.uint8)
            if subset_covered_bps.map:
                cov_present[list(subset_covered_bps.map.keys())] = 1
            subset_covered_bps._present = cov_present
    pushed_arr, cov_ev, exc_ev, included_bp = interval_walk(
        ids,
        orient,
        graph.node_lens,
        include_coords,
        exclude_coords,
        offset,
        cov_present,
        pos_base=pos_base,
        last_full=track[0] if track is not None else None,
    )
    item_table.append(num_path, pushed_arr)
    if subset_covered_bps is not None:
        for sid, a, b, kind, pos in cov_ev.tolist():
            if kind:
                subset_covered_bps.remove(sid)
            else:
                subset_covered_bps.add(sid, a, b)
                if track is not None:
                    track[1].append((pos, sid, a, b))
    node_lens_l = graph.node_lens
    for sid, a, b in exc_ev.tolist():
        l = int(node_lens_l[sid])
        for ex in exclude_tables:
            if ex is not None:
                if ex.with_annotation():
                    ex.activate_n_annotate(sid, l, a, b)
                else:
                    ex.activate(sid)
    return len(pushed_arr), included_bp


def _update_tables_edgecount(
    item_table: ItemTable,
    exclude_table: Optional[ActiveTable],
    num_path: int,
    graph: GraphStorage,
    ids: np.ndarray,
    orient: np.ndarray,
    include_coords,
    exclude_coords,
    offset: int,
) -> None:
    """Edge-count interval walking (reference: src/graph_broker/util.rs:723-795).

    Edges sit between nodes; included when the *second* node's span overlaps
    an active interval."""
    if len(ids) == 0:
        item_table.close_path(num_path)
        return
    # vectorized canonical edge id lookup for the whole path, then the scalar
    # interval walk only decides inclusion
    eids = graph.edge_ids_for_pairs(ids[:-1], orient[:-1], ids[1:], orient[1:])
    node_lens = graph.node_lens

    i = 0
    j = 0
    p = offset + int(node_lens[ids[0]])
    n_inc = len(include_coords)
    n_exc = len(exclude_coords)
    pushed: List[int] = []

    for k in range(len(eids)):
        while i < n_inc and include_coords[i][1] <= p:
            i += 1
        while j < n_exc and exclude_coords[j][1] <= p:
            j += 1
        l = int(node_lens[ids[k + 1]])
        eid = int(eids[k])
        if i < n_inc and include_coords[i][0] < p + l:
            pushed.append(eid)
        if (
            exclude_table is not None
            and j < n_exc
            and exclude_coords[j][0] < p + l
        ):
            exclude_table.activate(eid)
        elif i >= n_inc and j >= n_exc:
            break
        p += l

    item_table.append(num_path, np.array(pushed, dtype=np.int64))
