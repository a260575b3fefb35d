"""Streamed abacus construction for unmasked runs.

Port of panacus_tpu/stream.py (streamed_total_abaci) onto the port's
MembershipStream. Every membership row comes from `host_row` (a pinned host
row on CUDA, a row of the final matrix on the CPU), and `feed` uploads it
asynchronously while the next slab is tokenized.

One schedule, on one thread: the C tokenizer ORs each path's ids into the
host rows while they are cache-hot (fused tokenize+pack). Node rows are
packed while the async L-line edge indexer still runs; edge slabs are
stashed only until the indexer completes (polled each slab). This is the
JAX package's serial schedule. Its pipelined schedule (a worker thread
tokenizing slab i+1 while the main thread packs slab i), which the JAX
package runs on an accelerator with more than 2 host threads, is not
ported: on an H100 host it lost or tied against this one at 3 and 32
slabs for -c all, node, edge and gzip input (PERF.md), since every C
stage here already runs on all host threads.

Each slab's tokenize and pack are the spans `build.tokenize` and
`build.pack` (runtime.span, counted by slab); the pack of edge slabs
stashed while the indexer ran is `build.edge_pack`, the streams'
finalize `build.finalize`. The build adds `edge_slabs` (edge rows packed)
and `edge_slabs_repacked` (those packed from the stash) to the span it
runs in (`abaci_by_total`).

The build also returns each path's length in nodes and bp (for `info`),
and the item tables that the coverage-table export reads: a
SlabbedItemTable of node runs and, for edges, a LazyEdgeTable that derives
edge ids from the node runs on demand. Both only keep references to the
slabs the tokenizer has already produced.

An unmasked build in one process, on one CUDA device, of a graph whose
node names are 1..n (identity names) parses its step lists on the card
instead (`parse_on_device`), whatever it counts. The broker asks the same
predicate when it loads the graph, and GraphStorage then starts the upload
of the GFA's bytes from the first P/W line to the last on a worker thread
(parse_kernels.StepUpload, span `index.upload`), which runs while the index
and the build's set-up go on. A build that counts edges first waits for
the L-line indexer (`edge_index.wait`) and its CSR adjacency
(`edge_index.adj`), which goes up with the build; where the graph is past
the adjacency's packed layout (`graph.edge_adj()` is None) the whole build
takes the host's route. The build's first pass takes the upload (span
`build.stage`, with the `bytes` from the first step list to the last: the
wait for the job's copy), or, where none is in flight (a second build of
the same load), copies those bytes itself. One launch parses every slab's
lists into the node M's rows on the copy stream
(ops/parse_kernels.parse_pack, span `build.parse`); one copy back gives
every path's length (span `build.wait`). One more launch on the same text
and descriptor rows looks up each pair of consecutive steps in the
adjacency and ORs the group bit into the edge M
(parse_kernels.parse_pack_edges; its own `build.parse` and `build.wait`).
The node table is then a LazyNodeTable and the edge table a
LazyParsedEdgeTable, which parse again on the host only for a reader of
the ids (the coverage-table export). A malformed step list, or a pair of
steps with no L line, makes this route return None too. The build adds
`node_slabs` and `node_slabs_on_device`, `edge_slabs_on_device` (the edge
slabs whose rows the card wrote; `edge_slabs_repacked` is 0 there), and
`uploads` (1 where it copied step lists to the card, else 0) and
`uploads_early` (1 where it took the upload started while indexing) to
`abaci_by_total`.

Applicability: unmasked runs (no subset/exclude coordinates) whose step
lists the C tokenizer takes. Masked runs take the classic itemizer.
"""

from __future__ import annotations

import contextlib
import logging
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .abacus import AbacusByTotal, path_order_groups
from .gfa import GraphStorage, PathSegment, SlabbedItemTable
from .itemize import ItemizeResult
from .mask import GraphMask
from .native import build_membership, pack_edges_adj
from .ops import parse_kernels
from .ops.engine import Devices, MembershipStream
from .runtime import add_counts, effective_threads, span, world
from .utils import CountType

log = logging.getLogger("panacus")

# the upload counts of a node build that copies no step lists
NO_UPLOADS = {"uploads": 0, "uploads_early": 0}


@dataclass
class _Slab:
    word: int  # group word this slab contributes to; -1 = ungrouped paths
    path_ids: np.ndarray  # global path indices, in path order
    gidx_rel: np.ndarray  # per-path group bit within the word (0..31)


def _plan_slabs(path_order: List[Tuple[int, int]], n_paths: int) -> List[_Slab]:
    """Partition the (path, group) order into word-aligned slabs. Group
    indices are non-decreasing along path_order (path_order_groups), so
    each 32-group word is one contiguous run. Paths in no group form a
    trailing slab that sets no bit: they are tokenized only for their
    lengths, which the classic itemizer reports for every P/W line."""
    slabs: List[_Slab] = []
    cur_word = None
    cur_paths: List[int] = []
    cur_bits: List[int] = []
    for pid, g in path_order:
        w = g >> 5
        if w != cur_word:
            if cur_paths:
                slabs.append(
                    _Slab(
                        cur_word,
                        np.asarray(cur_paths, dtype=np.int64),
                        np.asarray(cur_bits, dtype=np.int64),
                    )
                )
            cur_word, cur_paths, cur_bits = w, [], []
        cur_paths.append(pid)
        cur_bits.append(g & 31)
    if cur_paths:
        slabs.append(
            _Slab(
                cur_word,
                np.asarray(cur_paths, dtype=np.int64),
                np.asarray(cur_bits, dtype=np.int64),
            )
        )
    grouped = {p for p, _ in path_order}
    rest = np.asarray([p for p in range(n_paths) if p not in grouped], dtype=np.int64)
    if len(rest):
        slabs.append(_Slab(-1, rest, np.zeros(len(rest), dtype=np.int64)))
    return slabs


def _pack_row(
    ids: np.ndarray, prefsum: np.ndarray, gidx_rel: np.ndarray, out: np.ndarray
) -> np.ndarray:
    """OR this slab's per-path item runs into the zeroed uint32 row `out`."""
    build_membership(
        ids,
        prefsum,
        np.arange(len(gidx_rel), dtype=np.int64),
        np.ascontiguousarray(gidx_rel, dtype=np.int64),
        out.reshape(1, -1),
        effective_threads(),
    )
    out[0] = 0  # sentinel slot (reference: abacus.rs:549-552)
    return out


class LazyEdgeTable:
    """Edge ItemTable view derived on demand from the node runs and the
    graph's edge index (panacus_tpu/stream.py's LazyEdgeTable). The fused
    edge pack never materializes per-path edge-id runs; only the
    coverage-table export resolves them, through this view.
    Interface of SlabbedItemTable: path_slice / items / prefsum."""

    def __init__(self, graph: GraphStorage, num_paths: int):
        self.num_paths = num_paths
        self._graph = graph
        self._slabs: List[Tuple[np.ndarray, ...]] = []
        self._where: Dict[int, Tuple[int, int]] = {}
        self._items: Optional[np.ndarray] = None
        self._prefsum: Optional[np.ndarray] = None

    def add_slab(self, path_ids, ids, orient, prefsum) -> None:
        s = len(self._slabs)
        self._slabs.append((path_ids, ids, orient, prefsum))
        for k, p in enumerate(path_ids):
            self._where[int(p)] = (s, k)

    def path_slice(self, path_idx: int) -> np.ndarray:
        loc = self._where.get(path_idx)
        if loc is None:
            return np.zeros(0, dtype=np.int64)
        s, k = loc
        _, ids, orient, prefsum = self._slabs[s]
        a, b = prefsum[k], prefsum[k + 1]
        if b - a < 2:
            return np.zeros(0, dtype=np.int64)
        run, orun = ids[a:b], orient[a:b]
        return self._graph.edge_ids_for_pairs(run[:-1], orun[:-1], run[1:], orun[1:])

    def _materialize(self) -> None:
        chunks = [self.path_slice(p) for p in range(self.num_paths)]
        self._prefsum = np.zeros(self.num_paths + 1, dtype=np.int64)
        np.cumsum([len(c) for c in chunks], out=self._prefsum[1:])
        self._items = np.concatenate(chunks) if chunks else np.zeros(0, dtype=np.int64)

    @property
    def items(self) -> np.ndarray:
        if self._items is None:
            self._materialize()
        return self._items

    @property
    def prefsum(self) -> np.ndarray:
        if self._prefsum is None:
            self._materialize()
        return self._prefsum


class LazyNodeTable:
    """Node ItemTable of a build that parsed the step lists on the card: the
    host keeps no ids, so a reader's are parsed again on the host, one path
    by GraphStorage.path_item_run, every path at once (`items`, `prefsum`)
    by one all_path_item_runs. Interface of SlabbedItemTable."""

    def __init__(self, graph: GraphStorage, num_paths: int):
        self.num_paths = num_paths
        self._graph = graph
        self._items: Optional[np.ndarray] = None
        self._prefsum: Optional[np.ndarray] = None

    def _path(self, path_idx: int) -> np.ndarray:
        return self._graph.path_item_run(path_idx)[0]

    def _every_path(self) -> Tuple[np.ndarray, np.ndarray]:
        items, _, prefsum, _ = self._graph.all_path_item_runs()
        return items, prefsum

    def path_slice(self, path_idx: int) -> np.ndarray:
        if self._items is not None:
            return self._items[self._prefsum[path_idx] : self._prefsum[path_idx + 1]]
        return self._path(path_idx)

    def _materialize(self) -> None:
        self._items, self._prefsum = self._every_path()

    @property
    def items(self) -> np.ndarray:
        if self._items is None:
            self._materialize()
        return self._items

    @property
    def prefsum(self) -> np.ndarray:
        if self._prefsum is None:
            self._materialize()
        return self._prefsum


class LazyParsedEdgeTable(LazyNodeTable):
    """Edge ItemTable of a build that counted the edges on the card: a
    reader's node runs are parsed again on the host as LazyNodeTable parses
    them, and their pairs looked up in the CSR adjacency
    (GraphStorage.edge_runs)."""

    def _path(self, path_idx: int) -> np.ndarray:
        ids, orient = self._graph.path_item_run(path_idx)
        return self._graph.edge_runs(ids, orient, np.array([0, len(ids)], dtype=np.int64))[0]

    def _every_path(self) -> Tuple[np.ndarray, np.ndarray]:
        ids, orient, prefsum, _ = self._graph.all_path_item_runs()
        return self._graph.edge_runs(ids, orient, prefsum)


def _parses_on(device) -> bool:
    """The device route's device: a CUDA card."""
    return device.type == "cuda"


def parse_on_device(devices: Devices, masked: bool, identity_names: bool = True) -> bool:
    """The step lists are parsed on the card: one process, one CUDA device,
    no subset or exclude coordinates (`masked`), identity node names. The
    broker asks before the index knows the names, and GraphStorage checks
    them; the build asks with them."""
    return (
        world()[1] == 1
        and len(devices) == 1
        and _parses_on(devices[0])
        and not masked
        and identity_names
    )


def _step_text(graph: GraphStorage, lo: int, hi: int, device) -> Tuple[torch.Tensor, int, bool]:
    """(text, base, early): the bytes buf[lo:hi] on `device` at
    text[lo - base:hi - base], from the upload the index started where one
    is in flight (`early`: its range holds every step list), else copied
    now."""
    up = graph.take_upload()
    if up is None:
        return parse_kernels.upload(graph.buf[lo:hi], device), lo, False
    text = up.take()
    if device.type == "cuda":  # allocated on the job's stream
        text.record_stream(torch.cuda.current_stream(device))
    return text, up.base, True


def _on(stream):
    """The context that queues work on `stream` (None: the CPU, no stream)."""
    return torch.cuda.stream(stream) if stream is not None else contextlib.nullcontext()


class _StepLists:
    """The slabs' step lists as the device route parses them: the
    descriptor rows, and the text on the card, which the first pass that
    asks stages (span `build.stage`) and the later ones reuse."""

    def __init__(self, graph: GraphStorage, slabs: List[_Slab]):
        self.order = np.concatenate([s.path_ids for s in slabs])
        starts, ends, walk = graph.step_lists(self.order)
        words = np.concatenate([np.full(len(s.path_ids), s.word, np.int32) for s in slabs])
        bits = np.concatenate([s.gidx_rel for s in slabs])
        self._lo, self._hi, self.descs = parse_kernels.descriptors(starts, ends, walk, words, bits)
        self._graph = graph
        self._text: Optional[torch.Tensor] = None
        self.uploads = NO_UPLOADS

    def text(self, device) -> Optional[torch.Tensor]:
        """The text, for work queued on the current stream of `device`; None
        where every list is empty."""
        if not len(self.descs):
            return None
        if self._text is None:
            with span("build.stage") as sp:
                text, base, early = _step_text(self._graph, self._lo, self._hi, device)
                sp.add(bytes=self._hi - self._lo)
            self.uploads = dict(uploads=1, uploads_early=int(early))
            self.descs[:, :2] += self._lo - base
            self._text = text
        elif device.type == "cuda":
            self._text.record_stream(torch.cuda.current_stream(device))
        return self._text


def _node_rows_on_device(
    graph: GraphStorage,
    lists: _StepLists,
    slabs: List[_Slab],
    node_stream: MembershipStream,
    paths_len: Dict[PathSegment, Tuple[int, int]],
) -> bool:
    """Build node_stream's rows from the slabs' raw step lists, one
    pt_parse_pack, and fill paths_len; False where a step list is malformed
    (the caller discards the stream)."""
    n_spans, n_items = len(lists.order), graph.node_count
    M, stream = node_stream.device_rows()
    with _on(stream):
        lens = torch.from_numpy(graph.node_lens.view(np.int32)).to(M.device, non_blocking=True)
        acc = torch.zeros(1 + 2 * n_spans, dtype=torch.int64, device=M.device)
        acc[0] = int(parse_kernels.ERR_NONE)
        text = lists.text(M.device)
        if text is not None:
            with span("build.parse"):
                d = torch.from_numpy(lists.descs).to(M.device, non_blocking=True)
                parse_kernels.parse_pack(text, d, M, lens, n_items, acc)
        with span("build.wait"):
            got = acc.cpu().numpy()
    if got[0] != parse_kernels.ERR_NONE:
        return False
    segs = graph.path_segments
    for j, pid in enumerate(lists.order):
        paths_len[segs[int(pid)]] = (int(got[1 + j]), int(got[1 + n_spans + j]))
    node_stream.written([s.word for s in slabs if s.word >= 0])
    return True


def _edge_rows_on_device(
    graph: GraphStorage,
    lists: _StepLists,
    slabs: List[_Slab],
    edge_stream: MembershipStream,
    adj: Tuple[np.ndarray, np.ndarray],
) -> bool:
    """Build edge_stream's rows from the same step lists and the L lines'
    CSR adjacency `adj` (uploaded with them), one pt_parse_pack_edges; False
    where a step list is malformed or a pair of steps has no L line (the
    caller discards the stream)."""
    M, stream = edge_stream.device_rows()
    with _on(stream):
        err = torch.full((1,), int(parse_kernels.ERR_NONE), dtype=torch.int64, device=M.device)
        text = lists.text(M.device)
        if text is not None:
            with span("build.parse"):
                row_off, adj_ent = (
                    torch.from_numpy(a.view(np.int64)).to(M.device, non_blocking=True) for a in adj
                )
                d = torch.from_numpy(lists.descs).to(M.device, non_blocking=True)
                parse_kernels.parse_pack_edges(text, d, M, row_off, adj_ent, graph.node_count, err)
        with span("build.wait"):
            got = int(err.cpu()[0])
    if got != parse_kernels.ERR_NONE:
        return False
    edge_stream.written([s.word for s in slabs if s.word >= 0])
    return True


def streamed_total_abaci(
    graph: GraphStorage,
    mask: GraphMask,
    count_types: List[CountType],
    devices: Devices,
):
    """Unmasked abacus build. Returns (abaci, itemized, path_order, groups),
    or None when the classic path must run (masks present / a step list
    the C tokenizer refuses / no paths) or in a multi-process run, which
    builds through parallel.ingest.multihost_total_abaci."""
    if world()[1] > 1:
        return None
    masked = mask.include_coords is not None or mask.exclude_coords is not None
    if masked:
        return None
    n_paths = len(graph.path_segments)
    if n_paths == 0:
        return None

    path_order, groups = path_order_groups(mask, graph.path_segments)
    n_groups = len(groups)
    slabs = _plan_slabs(path_order, n_paths)
    need_edge = CountType.EDGE in count_types
    need_node = any(ct != CountType.EDGE for ct in count_types)

    # the edge rows go to the card only where the CSR adjacency holds the
    # graph's edges, which waits for the L-line indexer
    on_device = parse_on_device(devices, masked, graph.identity_names) and (
        not need_edge or graph.edge_adj() is not None
    )

    node_stream = (
        MembershipStream(graph.number_of_items(CountType.NODE), n_groups, devices)
        if need_node
        else None
    )
    node_table = None
    if need_node:
        node_table = LazyNodeTable(graph, n_paths) if on_device else SlabbedItemTable(n_paths)
    edge_stream = None
    edge_table = None
    edge_fused = False
    paths_len: Dict[PathSegment, Tuple[int, int]] = {}
    segs = graph.path_segments

    log.info(
        "streamed membership build: %d slabs, %d groups, counts %s, on %s%s",
        len(slabs),
        n_groups,
        count_types,
        ", ".join(map(str, devices)),
        ", step lists parsed on the device" if on_device else "",
    )

    def make_edge_stream():
        """Create the edge stream and table; joins the async L-line indexer."""
        nonlocal edge_stream, edge_table, edge_fused
        edge_stream = MembershipStream(
            graph.number_of_items(CountType.EDGE), n_groups, devices
        )
        edge_fused = graph.edge_adj() is not None
        if not edge_fused:
            edge_table = SlabbedItemTable(n_paths)
        elif on_device:  # the card packs the rows: the host keeps no ids
            edge_table = LazyParsedEdgeTable(graph, n_paths)
        else:
            edge_table = LazyEdgeTable(graph, n_paths)

    def consume_edge(slab, batch, packed=False):
        """Pack (unless the tokenizer already did, `packed`) and feed the
        edge row of one slab."""
        nonlocal edge_slabs
        ids, orient, prefsum, _ = batch
        if edge_fused:
            edge_table.add_slab(slab.path_ids, ids, orient, prefsum)
        else:
            eids, e_pref = graph.edge_runs(ids, orient, prefsum)
            edge_table.add_slab(slab.path_ids, eids, e_pref)
        if slab.word < 0:
            return
        edge_slabs += 1
        row = edge_stream.host_row(slab.word)
        if not edge_fused:
            _pack_row(eids, e_pref, slab.gidx_rel, row)
        elif not packed:
            # edge lookup + group-bit OR in one C pass
            pack_edges_adj(ids, orient, prefsum, slab.gidx_rel, graph.edge_adj(), row)
            row[0] = 0
        edge_stream.feed(slab.word, row)

    def consume_stashed():
        """The second pass: pack and feed the edge rows of the slabs
        tokenized before the edge index was ready."""
        nonlocal stashed, edge_slabs_repacked
        if not stashed:
            return
        with span("build.edge_pack", slabs=len(stashed)):
            before = edge_slabs
            for s_prev, b_prev in stashed:
                consume_edge(s_prev, b_prev)
            edge_slabs_repacked += edge_slabs - before
        stashed = []

    def edge_index_ready():
        f = getattr(graph, "_edge_future", None)
        return f is None or f.done()

    def bail():
        """The tokenizer bailed: drop the half-fed streams (the classic
        path runs)."""
        for stream in (node_stream, edge_stream):
            if stream is not None:
                stream.discard()

    host_slabs = slabs
    uploads = NO_UPLOADS
    edge_slabs = edge_slabs_repacked = edge_slabs_on_device = 0
    if on_device:
        lists = _StepLists(graph, slabs)
        if need_node and not _node_rows_on_device(graph, lists, slabs, node_stream, paths_len):
            bail()
            return None
        if need_edge:
            make_edge_stream()
            if not _edge_rows_on_device(graph, lists, slabs, edge_stream, graph.edge_adj()):
                bail()
                return None
            edge_slabs = edge_slabs_on_device = sum(s.word >= 0 for s in slabs)
        uploads = lists.uploads
        host_slabs = []  # nothing is left for the host's pass
    stashed = []
    for i, slab in enumerate(host_slabs):
        if need_edge and edge_stream is None and edge_index_ready():
            # ready the edge stream BEFORE tokenizing so the edge pack
            # rides the same pass
            make_edge_stream()
            consume_stashed()
        # fused tokenize+pack: the C tokenizer ORs each path's ids into the
        # host rows while they are still cache-hot
        pack = {}
        if need_node and slab.word >= 0:
            pack["pack_node_row"] = node_stream.host_row(slab.word)
        if edge_stream is not None and edge_fused and slab.word >= 0:
            pack["pack_edge_row"] = edge_stream.host_row(slab.word)
            pack["pack_edge_adj"] = graph.edge_adj()
        if pack:
            pack["pack_gbit"] = np.ascontiguousarray(slab.gidx_rel, dtype=np.int64)
        with span("build.tokenize", slab=i):
            batch = graph.all_path_item_runs(slab.path_ids, pack=pack or None)
        if batch is None:  # tokenizer bailed: let the classic path run
            bail()
            return None
        with span("build.pack", slab=i):
            if need_node:
                # path lengths for node and bp runs only, as the classic
                # itemizer fills them
                ids, _, prefsum, bp = batch
                counts = np.diff(prefsum)
                for k, pid in enumerate(slab.path_ids):
                    paths_len[segs[int(pid)]] = (int(counts[k]), int(bp[k]))
                node_table.add_slab(slab.path_ids, ids, prefsum)
                if slab.word >= 0:
                    node_stream.feed(slab.word, pack["pack_node_row"])
            if edge_stream is not None:
                consume_edge(slab, batch, "pack_edge_row" in pack)
            elif need_edge:
                stashed.append((slab, batch))
    if need_edge:
        if edge_stream is None:  # indexer outlived tokenization: join
            make_edge_stream()
        consume_stashed()
        add_counts(
            edge_slabs=edge_slabs,
            edge_slabs_repacked=edge_slabs_repacked,
            edge_slabs_on_device=edge_slabs_on_device,
        )
    if need_node:
        add_counts(node_slabs=len(slabs), node_slabs_on_device=len(slabs) if on_device else 0)
    add_counts(**uploads)

    with span("build.finalize"):
        node_engine = node_stream.finalize() if need_node else None
        edge_engine = edge_stream.finalize() if need_edge else None
        itemized = ItemizeResult(
            item_tables=[
                edge_table if ct == CountType.EDGE else node_table for ct in count_types
            ],
            exclude_tables=[None] * len(count_types),
            subset_covered_bps=None,
            paths_len=paths_len,
        )
        abaci: Dict[CountType, AbacusByTotal] = {}
        for ct in count_types:
            engine = edge_engine if ct == CountType.EDGE else node_engine
            abaci[ct] = AbacusByTotal(ct, engine, groups, {}, graph)
            log.info(
                "abacus has %d path groups and %d countables",
                n_groups,
                engine.n_items,
            )
    return abaci, itemized, path_order, groups
