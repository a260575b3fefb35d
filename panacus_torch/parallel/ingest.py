"""Multi-process ingest: partition the path groups across processes,
tokenize only the local range, and assemble M across processes.

Port of panacus_tpu/parallel/ingest.py onto torch.distributed. P/W lines
are independent given the node table, and the membership build is a
commutative OR, so any partition of the paths gives the same matrix. Each
process:

  1. indexes the GFA structure (S lines and path spans: a cheap scan
     beside tokenizing the path payload, which is most of the bytes),
  2. tokenizes ONLY the paths of its payload-balanced contiguous group
     range (`multihost_total_abaci`; GraphBroker routes here whenever the
     world size is above 1),
  3. sends each other process the columns of its partial word rows that
     process owns, with one all_to_all, and adds the bit-disjoint blocks
     it receives into its shards of M (`assemble_global_matrix`).

The process group comes from runtime.init_distributed (torchrun's
environment). The helpers that are pure numpy (host_path_slice,
partial_membership, merge_partials, group_cuts, words_of_range,
word_slots, _partition_groups) are copies of panacus_tpu's, so a test can
hold them against each other. Host payloads (counts, bitmaps, triplets,
path lengths) travel over the gloo group as int64: torch carries int64 as
it is, so the int32 pairs panacus_tpu needed (ingest.py:242-275) are gone.

Every collective here runs at a fixed point of the program on every rank:
a decision that could differ between ranks (a tokenizer that bails) is
agreed on by a collective before anyone acts on it.
"""

from __future__ import annotations

import logging
from typing import List, Tuple

import numpy as np
import torch
import torch.distributed as tdist

from ..abacus import (
    AbacusByTotal,
    build_membership_host,
    group_multiplicities,
    path_order_groups,
    quantify_uncovered_bps,
)
from ..gfa import GraphStorage
from ..itemize import ItemizeResult, itemize_paths
from ..mask import GraphMask
from ..ops.engine import CountingEngine, Devices
from ..runtime import comm_device, host_all_gather, world
from ..stream import _pack_row, _plan_slabs
from ..utils import CountType

log = logging.getLogger("panacus")


def host_path_slice(n_paths: int, host_id: int, n_hosts: int) -> np.ndarray:
    """Contiguous, balanced partition of path indices across hosts."""
    bounds = np.linspace(0, n_paths, n_hosts + 1).astype(np.int64)
    return np.arange(bounds[host_id], bounds[host_id + 1], dtype=np.int64)


def partial_membership(
    graph: GraphStorage,
    mask: GraphMask,
    path_indices: np.ndarray,
    n_items: int,
    n_items_pad: int,
) -> Tuple[np.ndarray, List[str]]:
    """One host's contribution to the packed membership matrix: OR of the
    group bits of every path in `path_indices` (no masks). Returns
    (M_partial, ordered group names). The group indices come from the
    mask's full path order, so every host assigns the same columns and the
    merge is a bitwise OR."""
    path_order, groups = path_order_groups(mask, graph.path_segments)
    group_of = {p: g for p, g in path_order}
    n_groups = len(groups)
    n_words = max((n_groups + 31) // 32, 1)
    M = np.zeros((n_words, n_items_pad), dtype=np.uint32)

    sel = np.asarray([p for p in path_indices if p in group_of], dtype=np.int64)
    batch = graph.all_path_item_runs(sel)
    if batch is not None:
        ids, _orient, prefsum, _bp = batch
        for k, p in enumerate(sel):
            g = group_of[int(p)]
            run = ids[prefsum[k] : prefsum[k + 1]]
            M[g >> 5, run] |= np.uint32(1 << (g & 31))
    else:
        for p in sel:
            g = group_of[int(p)]
            run, _ = graph.path_item_run(int(p))
            M[g >> 5, run] |= np.uint32(1 << (g & 31))
    M[:, 0] = 0
    M[:, n_items + 1 :] = 0
    return M, groups


def merge_partials(partials: List[np.ndarray]) -> np.ndarray:
    """OR-merge of host partials (the one-process form of the cross-process
    assembly: partials from paths that share a group's word must OR)."""
    out = partials[0].copy()
    for p in partials[1:]:
        np.bitwise_or(out, p, out=out)
    return out


# -- the multi-process build ---------------------------------------------------
#
# Partition unit: a contiguous, payload-balanced GROUP range. Process p owns
# groups [cuts[p], cuts[p+1]) (cut points on the cumulative path payload, so
# every process tokenizes ~1/n_proc of the bytes even when the group count
# is far from a multiple of 32: a whole-word partition starves processes as
# soon as n_words < n_proc, e.g. 90 haplotypes = 3 words). Each process
# packs its groups' bits into rows for the words its range touches. A word
# shared by several processes receives bit-DISJOINT contributions (each
# group's bit is set by exactly one owner), so the global row is the SUM of
# the partial rows: carry-free, add == or.


def group_cuts(group_payload: np.ndarray, n_proc: int) -> List[int]:
    """Contiguous group partition balanced on cumulative payload bytes:
    cuts[p]..cuts[p+1] is process p's group range."""
    n_groups = len(group_payload)
    cum = np.concatenate([[0], np.cumsum(group_payload)])
    total = int(cum[-1])
    cuts = [0]
    for p in range(1, n_proc):
        c = int(np.searchsorted(cum, total * p / n_proc, side="left"))
        cuts.append(min(max(c, cuts[-1]), n_groups))
    cuts.append(n_groups)
    return cuts


def words_of_range(g_lo: int, g_hi: int) -> range:
    """Word indices a contiguous group range touches (empty when empty)."""
    if g_lo >= g_hi:
        return range(0, 0)
    return range(g_lo >> 5, ((g_hi - 1) >> 5) + 1)


def word_slots(cuts: List[int], n_words: int, wpp2: int):
    """Per-word contributor slots: [n_words, max_k] of global row indices
    (p * wpp2 + local slot), -1 padded. Deterministic on every process."""
    contrib = [[] for _ in range(n_words)]
    for p in range(len(cuts) - 1):
        ws = words_of_range(cuts[p], cuts[p + 1])
        for w in ws:
            contrib[w].append(p * wpp2 + (w - ws.start))
    max_k = max((len(c) for c in contrib), default=1) or 1
    out = np.full((n_words, max_k), -1, dtype=np.int64)
    for w, c in enumerate(contrib):
        out[w, : len(c)] = c
    return out


def assemble_global_matrix(
    rows: np.ndarray, slots: np.ndarray, engine: CountingEngine
) -> None:
    """K9 (panacus_tpu/parallel/ingest.py:185-239, an XLA program there):
    this process's partial word rows uint32 [wpp2, n_items_pad] -> its
    shards of the global M [n_words, n_items_pad].

    Process q owns the columns [q * P, (q + 1) * P) of the padded item axis
    (P = engine.proc_items). One all_to_all sends q the columns of every
    partial row that q owns (on the card under NCCL, on the host under
    gloo); q then adds, per word, the received rows that `slots` assigns
    to it. The rows are bit-disjoint, so the sum is the OR; it runs in
    int64 on the unsigned values (bit 31, the int32 sign bit, stays a
    bit) and is stored back as the same 32 bits in int32, as
    membership_from_pairs stores them. Each local shard then gets its
    columns, as build_from_host_matrix places them."""
    n_proc, P = engine.world_size, engine.proc_items
    wpp2 = rows.shape[0]
    if rows.shape != (wpp2, engine.n_items_pad) or rows.dtype != np.uint32:
        raise ValueError(
            f"partial rows {rows.dtype}{list(rows.shape)}, expected uint32 "
            f"[{wpp2}, {engine.n_items_pad}]"
        )
    if slots.shape[0] != engine.n_words or int(slots.max(initial=-1)) >= n_proc * wpp2:
        raise ValueError(
            f"slots {list(slots.shape)} do not address {n_proc} x {wpp2} rows "
            f"for {engine.n_words} words"
        )
    dev = comm_device()
    # block q of the send buffer: the columns process q owns, [wpp2, P]
    send = np.ascontiguousarray(
        rows.view(np.int32).reshape(wpp2, n_proc, P).transpose(1, 0, 2)
    )
    send = torch.from_numpy(send).to(dev)
    if n_proc > 1:
        recv = torch.empty_like(send)
        tdist.all_to_all_single(recv, send)
    else:
        recv = send
    M = sum_slot_rows(recv.reshape(n_proc * wpp2, P), slots)
    lo0 = engine.item_lo
    engine.shards = [
        M[:, lo - lo0 : hi - lo0].to(d).contiguous()
        for d, (lo, hi) in zip(engine.devices, engine.bounds)
    ]
    engine._ones = None


def sum_slot_rows(recv: torch.Tensor, slots: np.ndarray) -> torch.Tensor:
    """The receiving half of K9: int32 rows [n_proc * wpp2, P] (row
    p * wpp2 + j is process p's partial row j, this process's columns) ->
    int32 M [n_words, P], word w the sum of the rows slots[w] names. Each
    row is read as unsigned 32 bits into an int64 sum (bit-disjoint rows:
    the sum is the OR and stays below 2^32) and stored back as the same 32
    bits, bit 31 as the int32 sign bit."""
    M = torch.empty((slots.shape[0], recv.shape[1]), dtype=torch.int32, device=recv.device)
    for w, row_ids in enumerate(slots):
        acc = torch.zeros(recv.shape[1], dtype=torch.int64, device=recv.device)
        for s in row_ids[row_ids >= 0]:
            acc += recv[s].to(torch.int64) & 0xFFFFFFFF
        M[w] = torch.where(acc >= 2**31, acc - 2**32, acc).to(torch.int32)
    return M


def allgather_rows(arr: np.ndarray) -> List[np.ndarray]:
    """Allgather a per-process variable-length 2-D int64 array over the
    gloo group: gather the row counts, pad to the largest, gather, trim.
    Every process receives every process's rows, in rank order."""
    arr = np.ascontiguousarray(arr, dtype=np.int64)
    arr = arr.reshape(-1, arr.shape[1] if arr.ndim == 2 else 1)
    ns = [int(n) for n in host_all_gather(torch.tensor([arr.shape[0]]))]
    m = max(ns)
    if m == 0:
        return [arr[:0] for _ in ns]
    pad = torch.zeros((m, arr.shape[1]), dtype=torch.int64)
    pad[: arr.shape[0]] = torch.from_numpy(arr)
    parts = host_all_gather(pad)
    return [p[:n].numpy() for p, n in zip(parts, ns)]


def _allgather_or(packed: np.ndarray) -> np.ndarray:
    """Bitwise OR over every process of an equal-length uint8 array."""
    parts = host_all_gather(torch.from_numpy(np.ascontiguousarray(packed)))
    return np.bitwise_or.reduce(np.stack([p.numpy() for p in parts]), axis=0)


def _serialize_intervals(cont) -> np.ndarray:
    return np.asarray(
        [(sid, a, b) for sid, ivs in cont.map.items() for a, b in ivs],
        dtype=np.int64,
    ).reshape(-1, 3)


def merge_covered_container(cont) -> None:
    """Exact cross-process merge of the subset covered-bp container.

    The container's remove-on-full-coverage (reference util.rs:444-463: a
    visit that covers a node completely FORGETS its earlier partial
    intervals, but later partials accumulate again) makes the final state
    order-dependent across paths, so a plain union of per-process maps is
    wrong. itemize records (position, sid, a, b) for every interval add
    and each node's last full-coverage position (position = path_id << 40
    | visit index, the order one process walks). The merged state is, per
    node, the union of the adds after the global last full cover."""
    last_full, add_log = cont._mh_track
    adds = np.asarray(add_log, dtype=np.int64).reshape(-1, 4)
    all_adds = np.concatenate(allgather_rows(adds))
    interesting = (
        np.unique(all_adds[:, 1]) if len(all_adds) else np.zeros(0, dtype=np.int64)
    )
    lf_local = np.column_stack([interesting, last_full[interesting]])
    lf_all = np.concatenate(allgather_rows(lf_local))
    gmax = {}
    for sid, posv in lf_all:
        if posv > gmax.get(int(sid), -1):
            gmax[int(sid)] = int(posv)
    cont.map.clear()
    if hasattr(cont, "_present"):  # itemize's cached presence bitmap
        del cont._present
    for pos, sid, a, b in all_adds:
        if int(pos) > gmax.get(int(sid), -1):
            cont.add(int(sid), int(a), int(b))


def merge_exclude_tables(exclude_tables, graph) -> None:
    """Allgather-OR the ActiveTable states in place: boolean activation plus
    the bp exclude-interval annotations, replaying the full-coverage
    promotion of ActiveTable.activate_n_annotate so the merged state is
    what one process walking every path would hold."""
    tabs = []
    seen = set()
    for t in exclude_tables:
        if t is not None and id(t) not in seen:
            seen.add(id(t))
            tabs.append(t)
    if not tabs:
        return
    merged = _allgather_or(np.concatenate([np.packbits(t.items) for t in tabs]))
    off = 0
    for t in tabs:
        nb = (len(t.items) + 7) // 8
        t.items[:] = np.unpackbits(merged[off : off + nb])[: len(t.items)].astype(bool)
        off += nb
    for t in tabs:
        ann = t.annotation
        if ann is None:
            continue
        parts = allgather_rows(_serialize_intervals(ann))
        ann.map.clear()
        for part in parts:
            for sid, a, b in part:
                ann.add(int(sid), int(a), int(b))
        for sid in list(ann.keys()):
            sid = int(sid)
            if t.items[sid]:  # promoted by another process
                ann.remove(sid)
                continue
            got = ann.get(sid)
            if got and got[0] == (0, graph.node_len(sid)):
                ann.remove(sid)
                t.items[sid] = True


def _partition_groups(graph, path_order, n_groups, n_words, n_proc):
    """Payload-balanced contiguous group partition and per-word slot layout,
    SHARED by the unmasked and masked builds (both must compute the same
    cuts and slots or the assembly desynchronizes). Returns (span_len,
    total_payload, cuts, wpp2, slots)."""
    spans = np.asarray(graph._pw_seq_spans, dtype=np.int64)
    span_len = spans[:, 1] - spans[:, 0] if len(spans) else np.zeros(0, dtype=np.int64)
    total_payload = int(span_len.sum())
    group_payload = np.zeros(max(n_groups, 1), dtype=np.int64)
    if path_order:
        po_pids = np.fromiter((p for p, _ in path_order), dtype=np.int64, count=len(path_order))
        po_gidx = np.fromiter((g for _, g in path_order), dtype=np.int64, count=len(path_order))
        np.add.at(group_payload, po_gidx, span_len[po_pids])
    cuts = group_cuts(group_payload[:n_groups], n_proc)
    wpp2 = max(
        (len(words_of_range(cuts[p], cuts[p + 1])) for p in range(n_proc)),
        default=1,
    ) or 1
    slots = word_slots(cuts, n_words, wpp2)
    return span_len, total_payload, cuts, wpp2, slots


def _allgather_sum_paths(graph, node_len, bp_len, have) -> dict:
    """Sum per-path (node_len, bp_len, have) arrays across processes (each
    path is walked by exactly one) and rebuild the paths_len dict."""
    n_paths = len(graph.path_segments)
    tot = np.zeros((n_paths, 3), dtype=np.int64)
    for part in allgather_rows(np.stack([node_len, bp_len, have], axis=1)):
        tot += part
    return {
        graph.path_segments[p]: (int(tot[p, 0]), int(tot[p, 1]))
        for p in range(n_paths)
        if tot[p, 2]
    }


def _merge_paths_len(graph, paths_len) -> dict:
    """Allgather-merge per-path (node_len, bp_len) dicts."""
    n_paths = len(graph.path_segments)
    node_len = np.zeros(n_paths, dtype=np.int64)
    bp_len = np.zeros(n_paths, dtype=np.int64)
    have = np.zeros(n_paths, dtype=np.int64)
    for p, seg in enumerate(graph.path_segments):
        v = paths_len.get(seg)
        if v is not None:
            node_len[p], bp_len[p] = v
            have[p] = 1
    return _allgather_sum_paths(graph, node_len, bp_len, have)


def _gather_triplets(itemized, slot, path_order, n_groups, n_items):
    """The (items, group_ids, multiplicities) of one count type's coverage
    table over every process: each process counts the groups of its own
    paths (the group ranges are disjoint, so the rows never repeat), the
    triplets are allgathered and sorted items-major, groups in path order,
    as AbacusByGroup.sparse_counts lays them out in one process."""
    per_group = group_multiplicities(
        itemized.item_tables[slot],
        itemized.exclude_tables[slot],
        path_order,
        n_groups,
        n_items,
    )
    tri = np.zeros((0, 3), dtype=np.int64)
    if per_group:
        tri = np.concatenate(
            [np.column_stack([nz, np.full(len(nz), gi), c]) for gi, nz, c in per_group]
        )
    allt = np.concatenate(allgather_rows(tri))
    allt = allt[np.lexsort((allt[:, 1], allt[:, 0]))]
    return allt[:, 0].copy(), allt[:, 1].copy(), allt[:, 2].copy()


def multihost_masked_abaci(graph, mask, count_types, devices: Devices, need_tables: bool):
    """Path-sliced multi-process build for masked runs (subset BEDs,
    coordinate excludes) and coverage-table exports: each process runs the
    exact interval-walking itemizer over only its payload-balanced group
    range's paths, then the mask side products merge across processes:

      - exclude tables: boolean OR and interval-annotation union with the
        full-coverage promotion replayed (merge_exclude_tables),
      - subset covered-bp intervals: the order-aware merge
        (merge_covered_container), so the uncovered-bp correction
        (abacus.quantify_uncovered_bps) is the same on every process,
      - paths_len: per-path allgather (each path is walked exactly once),
      - membership rows: packed per word block and assembled as the
        unmasked build does (each count type's merged excluded columns are
        zeroed on every process before the assembly),
      - with `need_tables`, the coverage-table triplets of every count
        type, gathered here so that AbacusByGroup.sparse_counts reads them
        without a collective (panacus_tpu gathers them lazily inside
        sparse_counts, abacus.py:402, where a rank that never calls it
        leaves the others blocked).

    The returned ItemizeResult keeps this process's LOCAL item tables."""
    n_paths = len(graph.path_segments)
    if n_paths == 0:
        return None

    pid, n_proc = world()
    path_order, groups = path_order_groups(mask, graph.path_segments)
    n_groups = len(groups)
    n_words = max((n_groups + 31) // 32, 1)

    span_len, total_payload, cuts, wpp2, slots = _partition_groups(
        graph, path_order, n_groups, n_words, n_proc
    )
    g_lo, g_hi = cuts[pid], cuts[pid + 1]
    my_words = words_of_range(g_lo, g_hi)

    grouped = np.zeros(n_paths, dtype=bool)
    local = np.zeros(n_paths, dtype=bool)
    for p, g in path_order:
        grouped[p] = True
        if g_lo <= g < g_hi:
            local[p] = True
    if pid == 0:  # ungrouped paths: paths_len as one process reports it
        local |= ~grouped
    my_payload = int(span_len[local].sum()) if len(span_len) else 0
    log.info(
        "multi-process build (masked): process %d of %d owns groups [%d, %d), "
        "%d paths, %d of %d path payload bytes",
        pid,
        n_proc,
        g_lo,
        g_hi,
        int(local.sum()),
        my_payload,
        total_payload,
    )

    itemized = itemize_paths(
        graph, mask, count_types, path_filter=local, track_cov_order=True
    )
    local_order = [(p, g) for p, g in path_order if g_lo <= g < g_hi]

    merge_exclude_tables(itemized.exclude_tables, graph)
    if itemized.subset_covered_bps is not None:
        merge_covered_container(itemized.subset_covered_bps)

    abaci = {}
    for slot, ct in enumerate(count_types):
        # one engine per count type with ITS OWN exclude set, as the
        # one-process masked build (AbacusByTotal.from_itemization): the
        # node and bp exclude tables can differ (partial exclusion only
        # annotates the bp table)
        engine = CountingEngine(graph.number_of_items(ct), n_groups, devices)
        M_full = build_membership_host(
            itemized.item_tables[slot],
            local_order,
            itemized.exclude_tables[slot],  # merged above
            engine.n_items,
            n_groups,
            engine.n_items_pad,
        )
        rows = np.zeros((wpp2, engine.n_items_pad), dtype=np.uint32)
        if len(my_words):
            rows[: len(my_words)] = M_full[my_words.start : my_words.stop]
        del M_full
        assemble_global_matrix(rows, slots, engine)
        unc = quantify_uncovered_bps(
            itemized.exclude_tables[slot],
            itemized.subset_covered_bps if ct == CountType.BP else None,
            graph,
        )
        abaci[ct] = AbacusByTotal(ct, engine, groups, unc, graph)
        log.info("abacus has %d path groups and %d countables", n_groups, engine.n_items)

    itemized.paths_len = _merge_paths_len(graph, itemized.paths_len)
    if need_tables:
        itemized.mh_triplets = [
            _gather_triplets(
                itemized, slot, path_order, n_groups, graph.number_of_items(ct)
            )
            for slot, ct in enumerate(count_types)
        ]
    itemized.mh_stats = {
        "tokenized_payload_bytes": my_payload,
        "total_payload_bytes": total_payload,
        "n_processes": n_proc,
    }
    return abaci, itemized, path_order, groups


def multihost_total_abaci(
    graph, mask, count_types, need_itemized: bool, devices: Devices
):
    """Multi-process form of stream.streamed_total_abaci: this process
    tokenizes only its group range's paths; M assembles across processes.

    Exclude-only masks with whole-path rows (no coordinates) run
    path-sliced too: whole-path exclusion zeroes an item set (the classic
    build's `M[:, excluded] = 0`, abacus.build_membership_host), so each
    process marks the excluded items of the paths it tokenizes, the bitmaps
    are allgather-ORed, and every process zeroes those columns of its rows
    before the assembly (reference: src/graph_broker/abacus.rs:427-473).

    Subset masks, coordinate excludes and coverage-table exports
    (need_itemized) take multihost_masked_abaci. Returns None (the caller
    runs the classic build: every process itemizes the whole graph and
    keeps its own columns of M) when the C tokenizer refuses a step list
    of any rank's paths, or there are no paths."""
    if need_itemized or mask.include_coords is not None:
        return multihost_masked_abaci(graph, mask, count_types, devices, need_itemized)
    exc_pids = None
    if mask.exclude_coords is not None:
        big = (1 << 63) - 1
        exc_map = mask.build_subpath_map(mask.exclude_coords)
        if any(v != [(0, big)] for v in exc_map.values()):
            # coordinate excludes need the interval walk: path-sliced too
            return multihost_masked_abaci(graph, mask, count_types, devices, False)
        exc_pids = frozenset(
            i for i, seg in enumerate(graph.path_segments) if seg.id() in exc_map
        )
    n_paths = len(graph.path_segments)
    if n_paths == 0:
        return None

    pid, n_proc = world()
    path_order, groups = path_order_groups(mask, graph.path_segments)
    n_groups = len(groups)
    slabs = _plan_slabs(path_order, n_paths)
    need_edge = CountType.EDGE in count_types
    need_node = any(ct != CountType.EDGE for ct in count_types)
    n_words = max((n_groups + 31) // 32, 1)

    span_len, total_payload, cuts, wpp2, slots = _partition_groups(
        graph, path_order, n_groups, n_words, n_proc
    )
    g_lo, g_hi = cuts[pid], cuts[pid + 1]
    my_words = words_of_range(g_lo, g_hi)

    # clip each word slab to this process's group range; the ungrouped
    # trailing slab (word -1) only feeds paths_len: process 0 walks it so
    # the merged paths_len matches the one-process build
    my_parts = []  # (slab, selection into the slab's paths)
    my_payload = 0
    for s in slabs:
        if s.word < 0:
            if pid == 0:
                my_parts.append((s, np.arange(len(s.path_ids), dtype=np.int64)))
                my_payload += int(span_len[s.path_ids].sum())
            continue
        gidx_global = s.word * 32 + s.gidx_rel
        sel = np.flatnonzero((gidx_global >= g_lo) & (gidx_global < g_hi))
        if len(sel):
            my_parts.append((s, sel))
            my_payload += int(span_len[s.path_ids[sel]].sum())
    log.info(
        "multi-process build: process %d of %d owns groups [%d, %d) over "
        "words %s, %d slab parts, %d of %d path payload bytes",
        pid,
        n_proc,
        g_lo,
        g_hi,
        list(my_words),
        len(my_parts),
        my_payload,
        total_payload,
    )

    node_engine = (
        CountingEngine(graph.number_of_items(CountType.NODE), n_groups, devices)
        if need_node
        else None
    )
    edge_engine = (
        CountingEngine(graph.number_of_items(CountType.EDGE), n_groups, devices)
        if need_edge
        else None
    )
    R_node = np.zeros((wpp2, node_engine.n_items_pad), dtype=np.uint32) if need_node else None
    R_edge = np.zeros((wpp2, edge_engine.n_items_pad), dtype=np.uint32) if need_edge else None
    node_len = np.zeros(n_paths, dtype=np.int64)
    bp_len = np.zeros(n_paths, dtype=np.int64)
    have_len = np.zeros(n_paths, dtype=np.int64)
    node_excl = (
        np.zeros(node_engine.n_items_pad, dtype=bool) if (exc_pids and need_node) else None
    )
    edge_excl = (
        np.zeros(edge_engine.n_items_pad, dtype=bool) if (exc_pids and need_edge) else None
    )
    bailed = False
    for slab, sel in my_parts:
        pids_sel = slab.path_ids[sel]
        batch = graph.all_path_item_runs(pids_sel)
        if batch is None:  # the tokenizer bailed: agreed on below
            bailed = True
            break
        ids, orient, prefsum, bp = batch
        exc_local = (
            [k for k, p in enumerate(pids_sel) if int(p) in exc_pids] if exc_pids else []
        )
        if need_node:
            node_len[pids_sel] = np.diff(prefsum)
            bp_len[pids_sel] = bp
            have_len[pids_sel] = 1
            if slab.word >= 0:
                _pack_row(ids, prefsum, slab.gidx_rel[sel], R_node[slab.word - my_words.start])
            for k in exc_local:
                node_excl[ids[prefsum[k] : prefsum[k + 1]]] = True
        if need_edge and (slab.word >= 0 or exc_local):
            eids, e_pref = graph.edge_runs(ids, orient, prefsum)
            if slab.word >= 0:
                _pack_row(eids, e_pref, slab.gidx_rel[sel], R_edge[slab.word - my_words.start])
            for k in exc_local:
                edge_excl[eids[e_pref[k] : e_pref[k + 1]]] = True
    # every rank takes the classic build if any rank's tokenizer bailed
    if _allgather_or(np.array([bailed], dtype=np.uint8))[0]:
        return None

    if exc_pids:
        # merge every process's excluded-item marks and zero those columns
        # in the local partial rows BEFORE the assembly: every process zeroes
        # the same merged set, so the carry-free sum is zero there too
        parts = [np.packbits(t) for t in (node_excl, edge_excl) if t is not None]
        merged = _allgather_or(np.concatenate(parts))
        off = 0
        if node_excl is not None:
            nb = len(parts[0])
            R_node[:, np.flatnonzero(np.unpackbits(merged[:nb])[: node_engine.n_items_pad])] = 0
            off = nb
        if edge_excl is not None:
            R_edge[:, np.flatnonzero(np.unpackbits(merged[off:])[: edge_engine.n_items_pad])] = 0

    if need_node:
        assemble_global_matrix(R_node, slots, node_engine)
    if need_edge:
        assemble_global_matrix(R_edge, slots, edge_engine)
    del R_node, R_edge

    itemized = ItemizeResult(
        item_tables=[None] * len(count_types),
        exclude_tables=[None] * len(count_types),
        subset_covered_bps=None,
        paths_len=_allgather_sum_paths(graph, node_len, bp_len, have_len),
    )
    # the tokenized share, for the tests' and chip_smoke.py's balance checks
    itemized.mh_stats = {
        "tokenized_payload_bytes": my_payload,
        "total_payload_bytes": total_payload,
        "n_processes": n_proc,
    }
    abaci = {}
    for ct in count_types:
        engine = edge_engine if ct == CountType.EDGE else node_engine
        abaci[ct] = AbacusByTotal(ct, engine, groups, {}, graph)
    return abaci, itemized, path_order, groups
