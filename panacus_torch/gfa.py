"""Host-side GFA1 front-end: single-pass, columnar, numpy-vectorized.

Replaces the reference's byte-scanning multi-pass parser
(reference: src/graph_broker/graph.rs:168-467, src/graph_broker/util.rs:368-1248)
with one mmap/decompress pass that indexes every line, then lazily
materialises per-path item runs as dense integer arrays ready for device
upload. String work stays on the host; everything downstream is arrays.
"""

from __future__ import annotations

import gzip
import logging
import os
import re
import threading
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

log = logging.getLogger("panacus")

# large-buffer parsing wants heap reuse on lazy-memory VMs
from .runtime import configure_host_memory, handoff, span

configure_host_memory()

# PanSN path name handling (reference: src/graph_broker/graph.rs:16-18)
PATHID_PANSN = re.compile(r"^([^#]+)(#[^#]+)?(#[^#].*)?$")
PATHID_COORDS = re.compile(r"^(.+):([0-9]+)-([0-9]+)$")


@dataclass(frozen=True)
class PathSegment:
    """PanSN-spec path identifier sample[#haplotype[#seqid]][:start-end]
    (reference: src/graph_broker/graph.rs:469-627)."""

    sample: str
    haplotype: Optional[str] = None
    seqid: Optional[str] = None
    start: Optional[int] = None
    end: Optional[int] = None

    @classmethod
    def from_str(cls, s: str) -> "PathSegment":
        sample, haplotype, seqid, start, end = s, None, None, None, None
        m = PATHID_PANSN.match(s)
        if m:
            segs = [g for g in m.groups() if g is not None]
            if len(segs) == 3:
                sample = segs[0]
                haplotype = segs[1][1:]
                mc = PATHID_COORDS.match(segs[2][1:])
                if mc is None:
                    seqid = segs[2][1:]
                else:
                    seqid = mc.group(1)
                    start = int(mc.group(2))
                    end = int(mc.group(3))
            elif len(segs) == 2:
                sample = segs[0]
                mc = PATHID_COORDS.match(segs[1][1:])
                if mc is None:
                    haplotype = segs[1][1:]
                else:
                    haplotype = mc.group(1)
                    start = int(mc.group(2))
                    end = int(mc.group(3))
            elif len(segs) == 1:
                mc = PATHID_COORDS.match(segs[0])
                if mc is not None:
                    sample = mc.group(1)
                    start = int(mc.group(2))
                    end = int(mc.group(3))
        return cls(sample, haplotype, seqid, start, end)

    @classmethod
    def new(cls, sample, haplotype, seqid, start, end) -> "PathSegment":
        return cls(sample, haplotype, seqid, start, end)

    def id(self) -> str:
        if self.haplotype is not None:
            if self.seqid is not None:
                return f"{self.sample}#{self.haplotype}#{self.seqid}"
            return f"{self.sample}#{self.haplotype}"
        if self.seqid is not None:
            return f"{self.sample}#*#{self.seqid}"
        return self.sample

    def clear_coords(self) -> "PathSegment":
        return PathSegment(self.sample, self.haplotype, self.seqid, None, None)

    def coords(self) -> Optional[Tuple[int, int]]:
        if self.start is not None and self.end is not None:
            return (self.start, self.end)
        return None

    def __str__(self) -> str:
        c = self.coords()
        if c is not None:
            return f"{self.id()}:{c[0]}-{c[1]}"
        return self.id()


def _gz_capacity_hint(gfa_file: str) -> int:
    """Output-buffer capacity for a gzip file from its ISIZE footer,
    CLAMPED: a corrupt/truncated .gz can carry an arbitrary 32-bit ISIZE,
    which would force a multi-GiB zero-filled allocation before the
    stream is ever validated; the callers' growth loops handle
    underestimates (multi-member files report only the last member)."""
    import os as _os

    csize = _os.path.getsize(gfa_file)
    isize = 0
    try:
        with open(gfa_file, "rb") as raw:
            raw.seek(-4, 2)
            isize = int.from_bytes(raw.read(4), "little")
    except OSError:
        pass
    return max(min(isize, 64 * csize), 2 * csize, 1 << 20)


# bytes a read of the zlib route asks for: gzip's readinto holds a
# temporary as large as the request (1.2x a whole-buffer request)
_GZ_READ = 1 << 20


def _read_gz_streamed(gfa_file: str) -> bytearray:
    """Decompress a (possibly multi-member) gzip file into ONE buffer.

    Fast path: whole-buffer inflate via system libdeflate (~2.5-3x zlib
    throughput; member-by-member for concatenated streams). Fallback:
    stream through gzip.open with readinto into a growing buffer — no
    chunk-list accumulation + join either way, so peak memory stays ~1x
    the uncompressed size (the reference streams through MultiGzDecoder,
    src/io.rs:23-33; our columnar indexer needs the whole buffer, so we
    decompress *into* it). The initial capacity comes from the gzip ISIZE
    footer via _gz_capacity_hint (exact for single-member files, a floor
    otherwise). The span `index.inflate` holds both routes and counts
    `bytes_in` (the file's size), `bytes` (the inflated length) and
    `libdeflate` (1 where libdeflate inflated the file, 0 where zlib did)."""
    with span("index.inflate", bytes_in=os.path.getsize(gfa_file)) as sp:
        cap = _gz_capacity_hint(gfa_file)

        from .native import _get_libdeflate, gzip_decompress_buffer

        try:
            raw_map = np.memmap(gfa_file, dtype=np.uint8, mode="r")
            out = gzip_decompress_buffer(raw_map, cap)
            if out is not None:
                log.info("gz ingest: inflate by libdeflate")
                sp.add(bytes=len(out), libdeflate=1)
                return out
        except (OSError, ValueError):
            pass
        log.info(
            "gz ingest: inflate by zlib (%s)",
            "no libdeflate" if _get_libdeflate() is None else "libdeflate refused the file",
        )

        buf = bytearray(cap)
        pos = 0
        with gzip.open(gfa_file, "rb") as f:
            while True:
                if pos == len(buf):
                    # full: the hint is exact for one member, so grow only
                    # where more is left (a larger earlier member)
                    more = f.read(_GZ_READ)
                    if not more:
                        break
                    buf[pos:] = more
                    pos += len(more)
                    buf.extend(bytes(len(buf) // 2))  # grow 1.5x
                n = f.readinto(memoryview(buf)[pos : pos + _GZ_READ])
                if not n:
                    break
                pos += n
        del buf[pos:]
        sp.add(bytes=pos, libdeflate=0)
        return buf


def _read_all(gfa_file: str):
    """Whole-file buffer: gzip stream-decompressed into one buffer, or a
    read-only mmap for plain files (no copy; repeat runs hit the page
    cache). Falls back to a bytes copy when the file doesn't end in a
    newline."""
    log.info("loading graph from %s", gfa_file)
    if gfa_file.endswith(".gz"):
        log.info("assuming that %s is gzip compressed..", gfa_file)
        return _read_gz_streamed(gfa_file)
    with open(gfa_file, "rb") as f:
        try:
            import mmap

            mm = mmap.mmap(f.fileno(), 0, prot=mmap.PROT_READ)
        except (ValueError, OSError):
            return f.read()
        if len(mm) and mm[-1:] == b"\n":
            return mm
        data = bytes(mm)
        mm.close()
        return data


class ItemTable:
    """CSR of path -> item ids (reference: src/util.rs:80-93).

    items holds int64 ids concatenated across paths; prefsum[p]..prefsum[p+1]
    delimits path p. Built incrementally with python lists of arrays, then
    finalized to contiguous numpy.
    """

    def __init__(self, num_paths: int):
        self._chunks: List[np.ndarray] = []
        self.prefsum = np.zeros(num_paths + 1, dtype=np.int64)
        self._count = 0

    def append(self, path_idx: int, ids: np.ndarray) -> None:
        self._chunks.append(np.asarray(ids, dtype=np.int64))
        self._count += len(ids)
        self.prefsum[path_idx + 1] = self._count

    def close_path(self, path_idx: int) -> None:
        self.prefsum[path_idx + 1] = self._count

    def adopt(self, items: np.ndarray, prefsum: np.ndarray) -> None:
        """Take ownership of fully-built CSR storage (batch tokenizer path)."""
        self.items = items
        self.prefsum = prefsum
        self._count = len(items)
        self._chunks = None

    def finalize(self) -> None:
        if self._chunks is None:  # already adopted
            return
        self.items = (
            np.concatenate(self._chunks)
            if self._chunks
            else np.zeros(0, dtype=np.int64)
        )
        self._chunks = None

    def path_slice(self, path_idx: int) -> np.ndarray:
        return self.items[self.prefsum[path_idx] : self.prefsum[path_idx + 1]]


class SlabbedItemTable:
    """ItemTable built from per-slab CSR pieces (streamed membership build,
    see stream.py). `path_slice` resolves through a slab index;
    `.items`/`.prefsum` materialize the global path-ordered CSR lazily (only
    the coverage-table export walks them)."""

    def __init__(self, num_paths: int):
        self.num_paths = num_paths
        self._slabs: List[Tuple[np.ndarray, np.ndarray, np.ndarray]] = []
        self._where: Dict[int, Tuple[int, int]] = {}
        self._items: Optional[np.ndarray] = None
        self._prefsum: Optional[np.ndarray] = None

    def add_slab(
        self, path_ids: np.ndarray, ids: np.ndarray, prefsum: np.ndarray
    ) -> None:
        s = len(self._slabs)
        self._slabs.append((path_ids, ids, prefsum))
        for k, p in enumerate(path_ids):
            self._where[int(p)] = (s, k)

    def path_slice(self, path_idx: int) -> np.ndarray:
        loc = self._where.get(path_idx)
        if loc is None:
            return np.zeros(0, dtype=np.int64)
        s, k = loc
        _, ids, prefsum = self._slabs[s]
        return ids[prefsum[k] : prefsum[k + 1]]

    def _materialize(self) -> None:
        chunks = [self.path_slice(p) for p in range(self.num_paths)]
        self._prefsum = np.zeros(self.num_paths + 1, dtype=np.int64)
        np.cumsum([len(c) for c in chunks], out=self._prefsum[1:])
        self._items = (
            np.concatenate(chunks) if chunks else np.zeros(0, dtype=np.int64)
        )

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


class GraphStorage:
    """Indexed view of one GFA file.

    One file read; line classification and segment indexing are vectorized.
    Holds: node id table (dense 1..n in S-line order, id 0 reserved as
    sentinel like reference graph.rs:324), node lengths, path metadata and raw
    payload spans for lazy itemization, canonical edge table if requested.
    """

    def __init__(
        self, gfa_file: str, index_edges: bool, nice: bool = False, upload_to=None
    ):
        """`upload_to`: the torch device whose build will parse the step lists
        there (stream.parse_on_device); where the node names are the
        identity names, a worker thread copies the bytes from the first P/W
        line to the last to it while the index runs (take_upload)."""
        self.gfa_file = gfa_file
        self.is_nice = nice
        data = _read_all(gfa_file)
        if isinstance(data, (bytes, bytearray)) and data and not data.endswith(
            b"\n"
        ):
            data += b"\n"
        self._data = data
        buf = np.frombuffer(data, dtype=np.uint8)
        self._buf = buf

        from .native import classify_lines, scan_lines
        from .runtime import effective_threads

        with span("index.scan", bytes=len(buf)) as sp:
            # newlines only: the field parsers (pt_s_spans / pt_index_edges /
            # pt_tokenize) scan their own lines for tabs. One C pass (~6
            # ops/line) then gives the non-empty, CR-stripped line spans
            nl = scan_lines(buf, effective_threads())
            starts, ends, first = classify_lines(buf, nl)
            sp.add(lines=len(starts))
        self._line_starts = starts
        self._line_ends = ends
        self._name_hash_lock = threading.Lock()

        log.info(
            "constructing indexes for node/edge IDs, node lengths, and P/W lines.."
        )
        with span("index.nodes") as sp:
            is_s = first == ord("S")
            self._index_nodes(starts[is_s], ends[is_s])
            sp.add(nodes=self.node_count)

        parent = handoff()  # the upload's worker cannot see the profiler
        self._upload = None
        self._upload_taken = False
        with span("index.paths") as sp:
            # paths/walks in file order
            is_w = first == ord("W")
            pw_mask = (first == ord("P")) | is_w
            self._pw_starts = starts[pw_mask]
            self._pw_ends = ends[pw_mask]
            if upload_to is not None and self.identity_names and len(self._pw_starts):
                from .ops.parse_kernels import StepUpload

                self._upload = StepUpload(
                    buf, int(self._pw_starts[0]), int(self._pw_ends[-1]), upload_to, parent
                )
            self._pw_is_walk = is_w[pw_mask]
            self.path_segments: List[PathSegment] = []
            self._pw_seq_spans: List[Tuple[int, int]] = []
            self._index_paths()
            sp.add(paths=len(self.path_segments))

        log.info(
            "found: %d paths/walks, %d nodes",
            len(self.path_segments),
            self.node_count,
        )
        if not self.path_segments:
            log.warning("graph does not contain any annotated paths (P/W lines)")

        self._edge_count = 0
        self._edge_hash = None
        self._edge_adj = None
        self._edges_u = self._edges_o1 = None
        self._edges_v = self._edges_o2 = None
        self._degree: Optional[np.ndarray] = None
        self._edge_future = None
        if index_edges:
            # L-line indexing runs in a worker thread (the C indexer
            # releases the GIL), overlapping with the caller's path
            # tokenization — on a 2-core box this hides most of the edge
            # index cost behind the streamed membership build. Every edge
            # accessor joins first (_ensure_edges).
            from concurrent.futures import ThreadPoolExecutor

            parent = handoff()  # the worker cannot see the profiler
            with span("index.edges"):
                is_l = first == ord("L")
                ex = ThreadPoolExecutor(max_workers=1)

                def _index_job(ls, le):
                    from .native import install_thread_allocator

                    with span("edge_index", handoff=parent) as sp:
                        install_thread_allocator()  # context-local numpy handler
                        self._index_edges(ls, le)
                        sp.add(edges=self._edge_count)

                self._edge_future = ex.submit(_index_job, starts[is_l], ends[is_l])
                ex.shutdown(wait=False)

    def _ensure_edges(self) -> None:
        f = self._edge_future
        if f is not None:
            self._edge_future = None
            if f.done():
                f.result()  # re-raises indexing errors at first edge use
            else:
                with span("edge_index.wait"):
                    f.result()

    @property
    def edge_count(self) -> int:
        self._ensure_edges()
        return self._edge_count

    @property
    def degree(self) -> Optional[np.ndarray]:
        self._ensure_edges()
        return self._degree

    @property
    def edges_u(self):
        self._ensure_edges()
        return self._edges_u

    @property
    def edges_o1(self):
        self._ensure_edges()
        return self._edges_o1

    @property
    def edges_v(self):
        self._ensure_edges()
        return self._edges_v

    @property
    def edges_o2(self):
        self._ensure_edges()
        return self._edges_o2

    def edge_hash(self):
        """The open hash over canonical edge keys that the L-line indexer
        built (native.index_edges), or None where the graph was indexed
        without edges."""
        self._ensure_edges()
        return self._edge_hash

    def edge_adj(self):
        """Lazy CSR adjacency over canonical source nodes: the
        cache-friendly lookup structure for the hot path itemizer (the
        open hash costs a random DRAM miss per pair on large graphs).
        None without an edge index, and where the graph is past the
        adjacency's packed layout (native.build_edge_adj): the open hash
        serves then."""
        self._ensure_edges()
        if self._edge_adj is None and self._edges_u is not None:
            from .native import build_edge_adj

            with span("edge_index.adj"):
                self._edge_adj = build_edge_adj(
                    self._edges_u,
                    self._edges_o1,
                    self._edges_v,
                    self._edges_o2,
                    self.node_count,
                )
        return self._edge_adj

    # -- nodes ----------------------------------------------------------------

    def _index_nodes(self, s_starts: np.ndarray, s_ends: np.ndarray) -> None:
        from .native import s_spans
        from .runtime import effective_threads

        n = len(s_starts)
        name_starts = s_starts + 2
        # the decimal-name parse rides the same cache-hot C pass (ints is
        # None where a name is not an integer)
        name_ends, seq_lens, ints = s_spans(
            self._buf, s_starts, s_ends, effective_threads(),
            want_ints=True,
        )

        self.node_count = n
        self.node_lens = np.zeros(n + 1, dtype=np.uint32)
        self.node_lens[1:] = seq_lens

        # fast path: integer node names; nicest case is names == 1..n
        self._node2id: Optional[Dict[bytes, int]] = None
        self._int_names: Optional[np.ndarray] = None
        self._name_spans = (name_starts, name_ends)
        self._name_hash_cache = None  # lazily built for string-name graphs
        if ints is not None:
            self._int_names = ints
            if n and bool((ints == np.arange(1, n + 1)).all()):
                self._int_name_mode = "identity"
            else:
                # integer names, arbitrary values: sorted lookup table
                order = np.argsort(ints, kind="stable")
                sorted_ints = ints[order]
                if len(sorted_ints) != len(np.unique(sorted_ints)):
                    raise ValueError("Segment occurs multiple times in GFA")
                self._int_sorted = sorted_ints
                self._int_sorted_ids = order.astype(np.int64) + 1
                self._int_name_mode = "sorted"
        else:
            self._int_name_mode = None
            d: Dict[bytes, int] = {}
            data = self._data
            for i in range(n):
                # bytes(): gz-streamed buffers are bytearray (unhashable)
                name = bytes(data[name_starts[i] : name_ends[i]])
                if name in d:
                    raise ValueError(
                        f"Segment with ID {name.decode()} occurs multiple times in GFA"
                    )
                d[name] = i + 1
            self._node2id = d

    def node_name(self, iid: int) -> str:
        if self._int_name_mode == "identity":
            return str(iid)
        ns, ne = self._name_spans
        return self._data[ns[iid - 1] : ne[iid - 1]].decode()

    def get_node_id(self, name: bytes) -> Optional[int]:
        if self._int_name_mode == "identity":
            try:
                v = int(name)
            except ValueError:
                return None
            return v if 1 <= v <= self.node_count else None
        if self._int_name_mode == "sorted":
            try:
                v = int(name)
            except ValueError:
                return None
            i = np.searchsorted(self._int_sorted, v)
            if i < len(self._int_sorted) and self._int_sorted[i] == v:
                return int(self._int_sorted_ids[i])
            return None
        return self._node2id.get(name)

    def _ids_from_int_names(self, vals: np.ndarray, what: str) -> np.ndarray:
        if self._int_name_mode == "identity":
            bad = (vals < 1) | (vals > self.node_count)
            if bad.any():
                raise ValueError(f"unknown node {vals[bad][0]} in {what}")
            return vals
        idx = np.searchsorted(self._int_sorted, vals)
        idx_c = np.minimum(idx, len(self._int_sorted) - 1)
        bad = self._int_sorted[idx_c] != vals
        if bad.any():
            raise ValueError(f"unknown node {vals[bad][0]} in {what}")
        return self._int_sorted_ids[idx_c]

    def node_len(self, iid: int) -> int:
        return int(self.node_lens[iid])

    def number_of_items(self, count) -> int:
        from .utils import CountType

        if count in (CountType.NODE, CountType.BP):
            return self.node_count
        if count == CountType.EDGE:
            return self.edge_count
        raise ValueError("inadmissible count type")

    # -- paths ----------------------------------------------------------------

    def _index_paths(self) -> None:
        # per-line memchr finds (data.find is C-speed for mmap/bytes);
        # P/W line counts are tiny, and this never touches the global tab
        # index — only the P-line t3 find crosses the (large) seq field
        data = self._data

        def tab_after(pos: int, end: int) -> int:
            t = data.find(b"\t", pos, end)
            return t if t >= 0 else end

        for k in range(len(self._pw_starts)):
            s, e = int(self._pw_starts[k]), int(self._pw_ends[k])
            if self._pw_is_walk[k]:
                # W \t sample \t hap \t seqid \t start \t end \t walk
                t = []
                pos = s
                for _ in range(6):
                    pos = tab_after(pos + 1, e)
                    t.append(pos)
                cols = [data[t[j] + 1 : t[j + 1]].decode() for j in range(5)]
                seq_start = None if cols[3] == "*" else int(cols[3])
                seq_end = None if cols[4] == "*" else int(cols[4])
                seg = PathSegment.new(cols[0], cols[1], cols[2], seq_start, seq_end)
                self._pw_seq_spans.append((t[5] + 1, e))
            else:
                # P \t name \t seq \t overlaps
                t1 = tab_after(s, e)
                t2 = tab_after(t1 + 1, e)
                t3 = tab_after(t2 + 1, e)
                name = data[t1 + 1 : t2].decode()
                seg = PathSegment.from_str(name)
                self._pw_seq_spans.append((t2 + 1, t3))
            self.path_segments.append(seg)

    def all_path_item_runs(
        self,
        path_indices: Optional[np.ndarray] = None,
        pack: Optional[dict] = None,
    ):
        """Tokenize P/W lines in one threaded C call — every line, or
        only `path_indices` (multi-host ingest: each host tokenizes its
        slice of the path set; see parallel/ingest.py).

        `pack`: optional fused membership pack (streamed builder hot
        path) — kwargs forwarded to tokenize_batch (pack_gbit,
        pack_node_row, pack_edge_adj, pack_edge_row): each path's ids are
        ORed into the rows inside the tokenize pass, cache-hot.

        Returns (ids, orient, prefsum, bp_per_path) over the selected paths
        (path k of the selection spans ids[prefsum[k]:prefsum[k+1]]), or
        None where the graph has no P/W line, or a step list is malformed
        or names an unknown node: callers then parse path by path
        (path_item_run), which raises the user-facing error."""
        if not len(self._pw_starts):
            return None
        from .native import tokenize_batch
        from .runtime import effective_threads

        starts, ends, walk = self.step_lists(path_indices)
        if path_indices is not None and not len(starts):
            z = np.zeros(0, np.int64)
            return z, np.zeros(0, np.uint8), np.zeros(1, np.int64), z
        kwargs = dict(
            mode=1,
            n_items=self.node_count,
            node_lens=self.node_lens,
            n_threads=effective_threads(),
        )
        if self._int_name_mode is None:
            kwargs.update(mode=3, name_hash=self.name_hash())
        elif self._int_name_mode != "identity":
            kwargs.update(
                mode=2,
                sorted_vals=self._int_sorted,
                sorted_ids=self._int_sorted_ids,
            )
        if pack is not None:
            kwargs.update(pack)
        return tokenize_batch(self._buf, starts, ends, walk, **kwargs)

    def step_lists(
        self, path_indices: Optional[np.ndarray] = None
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(starts, ends, walk): the byte spans in the buffer (`buf`) of the
        step lists of every P/W line, or of `path_indices` in that order,
        int64 and contiguous, and whether each is a W line (uint8)."""
        spans = np.asarray(self._pw_seq_spans, dtype=np.int64).reshape(-1, 2)
        walk = self._pw_is_walk
        if path_indices is not None:
            spans, walk = spans[path_indices], walk[path_indices]
        return (
            np.ascontiguousarray(spans[:, 0]),
            np.ascontiguousarray(spans[:, 1]),
            np.ascontiguousarray(walk, dtype=np.uint8),
        )

    def take_upload(self):
        """The StepUpload started while indexing (its bytes cover every step
        list), for the first build that asks; None after, or where none
        started."""
        if self._upload_taken:
            return None
        self._upload_taken = True
        return self._upload

    def close(self) -> None:
        """Join the step-list upload's worker, if one started, so that it
        reads the map no more. The map goes with the object."""
        if self._upload is not None:
            self._upload.close()

    @property
    def buf(self) -> np.ndarray:
        """The GFA's bytes (uint8), which `step_lists` indexes."""
        return self._buf

    @property
    def identity_names(self) -> bool:
        """Node names are the integers 1..n in S-line order."""
        return self._int_name_mode == "identity"

    def name_hash(self):
        """Open-addressing hash over the S-line name spans (string-named
        graphs: tokenize_batch and index_edges mode 3), built once."""
        # lock: the async edge-index worker and the main-thread tokenizer
        # can both trigger the first build concurrently
        with self._name_hash_lock:
            if self._name_hash_cache is None:
                from .native import build_name_hash

                ns, ne = self._name_spans
                self._name_hash_cache = build_name_hash(
                    self._buf, ns, ne
                )
        return self._name_hash_cache

    def path_item_run(self, path_idx: int) -> Tuple[np.ndarray, np.ndarray]:
        """Item ids + orientations (0 fwd / 1 bwd) of one P/W line, vectorized.

        Equivalent of reference parse_path_seq_to_item_vec /
        parse_walk_seq_to_item_vec (src/graph_broker/util.rs:797-1016).
        Integer steps go through one C call; string names, and a step list
        that the C parse refuses, through numpy, which raises the
        user-facing error on a malformed step.
        """
        a, b = self._pw_seq_spans[path_idx]
        buf = self._buf
        if self._int_name_mode is not None:
            from .native import parse_path_tokens

            res = parse_path_tokens(
                buf, a, b, walk=bool(self._pw_is_walk[path_idx])
            )
            if res is not None:
                vals, orient = res
                ids = self._ids_from_int_names(
                    vals, f"path {self.path_segments[path_idx]}"
                )
                return ids, orient
        if self._pw_is_walk[path_idx]:
            seg = buf[a:b]
            seps = np.flatnonzero((seg == 62) | (seg == 60))  # '>' '<'
            if len(seps) == 0:
                return np.zeros(0, np.int64), np.zeros(0, np.uint8)
            tok_starts = seps + 1 + a
            tok_ends = np.empty(len(seps), dtype=np.int64)
            tok_ends[:-1] = seps[1:] + a
            tok_ends[-1] = b
            orient = (seg[seps] == 60).astype(np.uint8)
        else:
            seg = buf[a:b]
            commas = np.flatnonzero(seg == 44)
            n_tok = len(commas) + 1
            tok_starts = np.empty(n_tok, dtype=np.int64)
            tok_starts[0] = a
            tok_starts[1:] = commas + 1 + a
            tok_full_ends = np.empty(n_tok, dtype=np.int64)
            tok_full_ends[:-1] = commas + a
            tok_full_ends[-1] = b
            # last char of each token is orientation (+/-)
            ochars = buf[tok_full_ends - 1]
            bad = (ochars != 43) & (ochars != 45)
            if bad.any():
                raise ValueError(
                    "unknown orientation of segment in path "
                    f"{self.path_segments[path_idx]}"
                )
            orient = (ochars == 45).astype(np.uint8)
            tok_ends = tok_full_ends - 1
        if self._int_name_mode is not None:
            from .native import parse_int_spans

            vals = parse_int_spans(buf, tok_starts, tok_ends)
            if vals is None:
                raise ValueError(
                    f"malformed node id in path {self.path_segments[path_idx]}"
                )
            ids = self._ids_from_int_names(
                vals, f"path {self.path_segments[path_idx]}"
            )
        else:
            d = self._node2id
            data = self._data
            ids = np.fromiter(
                (
                    d[bytes(data[int(s) : int(e)])]
                    for s, e in zip(tok_starts, tok_ends)
                ),
                dtype=np.int64,
                count=len(tok_starts),
            )
        return ids, orient

    # -- edges ----------------------------------------------------------------

    def _index_edges(self, l_starts: np.ndarray, l_ends: np.ndarray) -> None:
        """Canonical edge table from L lines in one C pass
        (reference: src/graph_broker/graph.rs:276-306, Edge::canonical
        graph.rs:142-148). Edge ids are assigned in first-occurrence order."""
        from .native import index_edges

        if self._int_name_mode is None:
            mode, nh = 3, self.name_hash()
        else:
            mode, nh = (1 if self._int_name_mode == "identity" else 2), None
        (
            self._edge_hash,
            self._edges_u,
            self._edges_o1,
            self._edges_v,
            self._edges_o2,
            self._degree,
            n_dup,
        ) = index_edges(
            self._buf,
            l_starts,
            l_ends,
            mode,
            self.node_count,
            getattr(self, "_int_sorted", None),
            getattr(self, "_int_sorted_ids", None),
            name_hash=nh,
        )
        self._edge_count = len(self._edges_u)
        if n_dup:
            log.warning("%d duplicated edges in GFA", n_dup)
        log.info("found: %d edges", self._edge_count)

    def edge_ids_for_pairs(
        self,
        u: np.ndarray,
        o1: np.ndarray,
        v: np.ndarray,
        o2: np.ndarray,
    ) -> np.ndarray:
        """Canonical edge id lookup for oriented node pairs (vectorized)."""
        self._ensure_edges()
        if self._edge_hash is None:
            raise ValueError("edge index unavailable")
        from .native import lookup_pairs

        return lookup_pairs(u, o1, v, o2, self._edge_hash)

    def edge_runs(
        self, ids: np.ndarray, orient: np.ndarray, prefsum: np.ndarray
    ) -> Tuple[np.ndarray, np.ndarray]:
        """(eids, e_pref): the canonical edge ids of every consecutive pair
        of every run of the node CSR (ids, orient, prefsum), as a CSR
        itself. Through the CSR adjacency, or the open hash where the
        graph is past the adjacency's layout."""
        if len(ids) == 0:
            return np.zeros(0, np.int64), prefsum.copy()
        from .native import lookup_edges, lookup_edges_adj
        from .runtime import effective_threads

        adj = self.edge_adj()
        if adj is not None:
            return lookup_edges_adj(ids, orient, prefsum, adj, effective_threads())
        return lookup_edges(ids, orient, prefsum, self.edge_hash(), effective_threads())

    def node_names_fixed(self, ids: np.ndarray) -> np.ndarray:
        """Fixed-width byte names for a batch of node ids (NUL-padded) —
        vectorized gather from the file buffer for the table exporter."""
        ids = np.asarray(ids, dtype=np.int64)
        if self._int_name_mode == "identity":
            return ids.astype("S20")
        ns, ne = self._name_spans
        starts = ns[ids - 1]
        ends = ne[ids - 1]
        w = int((ends - starts).max()) if len(ids) else 1
        pos = starts[:, None] + np.arange(w, dtype=np.int64)
        g = self._buf[np.minimum(pos, len(self._buf) - 1)]
        out = np.where(pos < ends[:, None], g, 0).astype(np.uint8)
        return np.ascontiguousarray(out)

    def edge_names_fixed(self, eids: np.ndarray) -> np.ndarray:
        """Fixed-width byte names '<u><v' style for a batch of edge ids.
        Name blocks are NUL-padded internally; consumers treat NUL as
        padding anywhere in the cell (native.format_table does)."""
        i = np.asarray(eids, dtype=np.int64) - 1
        u = self.edges_u[i]
        v = self.edges_v[i]
        o1 = np.where(self.edges_o1[i], ord("<"), ord(">")).astype(np.uint8)
        o2 = np.where(self.edges_o2[i], ord("<"), ord(">")).astype(np.uint8)
        un = self.node_names_fixed(u)
        vn = self.node_names_fixed(v)
        un = un.view(np.uint8).reshape(len(i), -1)
        vn = vn.view(np.uint8).reshape(len(i), -1)
        wu, wv = un.shape[1], vn.shape[1]
        out = np.zeros((len(i), 2 + wu + wv), dtype=np.uint8)
        out[:, 0] = o1
        out[:, 1 : 1 + wu] = un
        out[:, 1 + wu] = o2
        out[:, 2 + wu :] = vn
        return out

    def edge_name(self, eid: int) -> str:
        i = eid - 1
        o1 = "<" if self.edges_o1[i] else ">"
        o2 = "<" if self.edges_o2[i] else ">"
        return (
            f"{o1}{self.node_name(int(self.edges_u[i]))}"
            f"{o2}{self.node_name(int(self.edges_v[i]))}"
        )
