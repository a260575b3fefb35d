"""The streamed build's device route on the CPU: the plain versions of
pt_parse_pack and pt_parse_pack_edges (ops/parse_kernels.parse_pack_ref,
parse_pack_edges_ref) and the route's host logic.

The plain node parse is held against the host tokenizer (native
pt_tokenize_pack, mode 1 with the fused node pack) on the synthetic step lists
of tests/parse_cases.py: P and W lists, seven- and eight-digit ids, ids 0
and n_items + 1, stray bytes, missing orientations, between bytes of other
fields. The plain edge parse is held against the host's fused edge pack
(native pt_pack_edges_adj) on the same lists and on the edge cases
(single-step lists, pairs with u > v, backward self-loops, paths in no
group, a row past 8 entries, a pair with no L line, which sets the error
slot). The descriptor rows (parse_kernels.descriptors) are checked to name
every non-empty list once, in the text's order. The route itself runs
here with `parse_on_device` forced (it engages only on a CUDA device), so
parse_pack takes the plain version: on make_graph and the dryrun graph
(also with its P and W lines among its S lines), with the group file that
leaves most paths in no group, its node and edge M, paths_len and item
tables equal the host tokenizer's build; a malformed step list, or a pair
of steps with no L line, makes it return None; the TSVs of histgrowth -c
node, -c bp, -c all and -c edge, info and table (-c edge too) equal
panacus_tpu's. The kernels against these plain versions are in
test_torch_parse_card.py.
"""

from __future__ import annotations

import logging
import re

import numpy as np
import pytest
import torch

import parse_cases as pc
from panacus_torch import native, stream, testgraphs
from panacus_torch.cli import run_cli as torch_cli
from panacus_torch.ops import parse_kernels
from panacus_torch.ops.engine import MembershipStream
from test_torch_slice import graphs  # noqa: F401 (fixture)


def _spans_of(pieces):
    """The whole step lists the pieces cut: {span: (bytes, walk)}."""
    out = {}
    for text, span, _, _, walk in pieces:
        if span in out:
            prev, _ = out[span]
            out[span] = (prev + (b"" if walk else b",") + text, walk)
        else:
            out[span] = (text, walk)
    return out


def _host_tokenizer(pieces):
    """The host tokenizer's row (one word) and per-span counts and bp over
    the pieces' step lists, or None where it bails."""
    spans = _spans_of(pieces)
    order = sorted(spans)
    buf = b"".join(spans[s][0] + b"\n" for s in order)
    ends = np.cumsum([len(spans[s][0]) + 1 for s in order]) - 1
    starts = ends - [len(spans[s][0]) for s in order]
    bits = {s: b for _, s, _, b, _ in pieces}
    lens = pc.node_lens().numpy().view(np.uint32)
    row = np.zeros(pc.N_ITEMS + 7, dtype=np.uint32)
    got = native.tokenize_batch(
        np.frombuffer(buf, dtype=np.uint8), starts, ends,
        np.array([spans[s][1] for s in order], dtype=np.uint8), 1, pc.N_ITEMS,
        node_lens=lens, pack_gbit=np.array([bits[s] for s in order]),
        pack_node_row=row, n_threads=1,
    )
    if got is None:
        return None
    _, _, prefsum, bp = got
    return row, dict(zip(order, np.diff(prefsum))), dict(zip(order, bp.astype(np.int64)))


@pytest.mark.parametrize("name", sorted(pc.CASES))
def test_plain_version_equals_the_host_tokenizer(name):
    pieces, good = pc.CASES[name]
    for p in pieces:  # one word, as the host packs one row
        assert p[2] in (-1, 0, 1)
    one_word = [(t, s, 0, b, w) for t, s, _, b, w in pieces]
    text, descs = pc.layout(one_word)
    n = pc.n_spans(pieces)
    M, acc = pc.outputs(n)
    parse_kernels.parse_pack(text, descs, M, pc.node_lens(), pc.N_ITEMS, acc)
    want = _host_tokenizer(pieces)
    assert (want is not None) == good
    if not good:
        bad = [s for t, s, _, _, w in pieces if parse_kernels.list_steps(np.frombuffer(t, np.uint8), w, pc.N_ITEMS) is None]
        assert acc[0] == min(bad)
        return
    row, counts, bp = want
    assert acc[0] == parse_kernels.ERR_NONE
    np.testing.assert_array_equal(M[0].numpy().view(np.uint32), row)
    assert not M[1].any()
    for s in range(n):
        assert acc[1 + s] == counts.get(s, 0)
        assert acc[1 + n + s] == bp.get(s, 0)


def test_plain_version_on_random_pieces():
    rng = np.random.default_rng(11)
    pieces = pc.random_pieces(rng, 40, 200)
    text, descs = pc.layout(pieces)
    M, acc = pc.outputs(len(pieces))
    parse_kernels.parse_pack(text, descs, M, pc.node_lens(), pc.N_ITEMS, acc)
    assert acc[0] == parse_kernels.ERR_NONE
    want = np.zeros((pc.N_WORDS, pc.N_ITEMS + 7), dtype=np.uint32)
    lens = pc.node_lens().numpy()
    for text, span, word, bit, walk in pieces:
        got = parse_kernels.list_steps(np.frombuffer(text, np.uint8), walk, pc.N_ITEMS)
        assert got is not None
        ids = got[0]
        if word >= 0:
            want[word, ids] |= np.uint32(1 << bit)
        assert acc[1 + span] == len(ids)
        assert acc[1 + len(pieces) + span] == lens[ids].sum()
    np.testing.assert_array_equal(M.numpy().view(np.uint32), want)


def _edges_plain(pieces, adj, seed=0):
    """The edge M and error slot of the plain edge parse on the lists."""
    text, descs = pc.layout(pieces, seed)
    M, err = pc.edge_outputs(adj[2])
    row_off, adj_ent = pc.edge_tensors(adj)
    parse_kernels.parse_pack_edges(text, descs, M, row_off, adj_ent, pc.N_ITEMS, err)
    return M, err


EDGE_CASES = {**{k: (v[0], []) for k, v in pc.CASES.items()}, **pc.EDGE_CASES}


@pytest.mark.parametrize("name", sorted(EDGE_CASES))
def test_plain_edges_equal_the_host_edge_pack(name):
    """Each word's edge row equals the host's pt_pack_edges_adj row of that
    word's lists (word -1: none); where a token fails or a pair has no L
    line, the error slot names the least such span."""
    pieces, missing = EDGE_CASES[name]
    adj = pc.adjacency(pieces, missing)
    M, err = _edges_plain(pieces, adj)
    want_err = pc.failing_span(pieces, missing)
    assert int(err[0]) == want_err
    if name in pc.CASES:
        assert (want_err == parse_kernels.ERR_NONE) == pc.CASES[name][1]
    if want_err == parse_kernels.ERR_NONE:
        np.testing.assert_array_equal(M.numpy().view(np.uint32), pc.host_edge_rows(pieces, adj))


def test_plain_edges_on_random_pieces():
    pieces = pc.random_pieces(np.random.default_rng(12), 40, 200)
    adj = pc.adjacency(pieces, seed=5)
    M, err = _edges_plain(pieces, adj)
    assert int(err[0]) == parse_kernels.ERR_NONE
    np.testing.assert_array_equal(M.numpy().view(np.uint32), pc.host_edge_rows(pieces, adj))


# -- the descriptor rows ------------------------------------------------------


LISTS = {
    # name: step lists of one graph's paths, in path order, as the GFA holds them
    "p_and_w": [b"1+,22-,333+,4444-", b">5<66>777<8888", b"9+", b">1", b"1234+,1+"],
    "empty_lists": [b"", b"1+,2+", b"", b">3", b""],
    "one_list": [b"7-"],
    "every_list_empty": [b"", b""],
}


@pytest.mark.parametrize("name", sorted(LISTS))
@pytest.mark.parametrize("order", ["file", "reversed", "shuffled"])
def test_descriptors_name_every_list_once(name, order):
    """Whatever order the slabs take the paths in, the rows follow the
    text, name each non-empty list once under its span with its word, bit
    and kind, and the plain parse of buf[lo:hi] gives each list's tokens."""
    texts = LISTS[name]
    gfa, starts = b"S\t1\tA\n", []
    for t in texts:
        starts.append(len(gfa) + 4)
        gfa += b"P\tx\t" + t + b"\t*\n"
    buf = np.frombuffer(gfa, np.uint8)
    starts = np.array(starts, dtype=np.int64)
    ends = starts + [len(t) for t in texts]
    n = len(texts)
    perm = {"file": np.arange(n), "reversed": np.arange(n)[::-1],
            "shuffled": np.random.default_rng(3).permutation(n)}[order]
    walk = np.array([t.startswith(b">") for t in texts], dtype=np.uint8)[perm]
    words = (np.arange(n, dtype=np.int32) % 3 - 1)[perm]
    bits = (np.arange(n, dtype=np.int32) * 7 % 32)[perm]
    lo, hi, descs = parse_kernels.descriptors(starts[perm], ends[perm], walk, words, bits)
    full = [k for k in range(n) if texts[perm[k]]]
    assert descs.dtype == np.int64 and descs.shape == (len(full), 4)
    if not full:
        assert (lo, hi) == (0, 0)
        return
    assert lo == min(starts[perm[k]] for k in full) and hi == max(ends[perm[k]] for k in full)
    assert (np.diff(descs[:, 0]) > 0).all()
    assert sorted(descs[:, 2]) == full
    for begin, end, span, meta in descs.tolist():
        assert buf[lo + begin : lo + end].tobytes() == texts[perm[span]]
        assert (meta >> 16, meta & 31, meta >> 8 & 1) == (words[span], bits[span], walk[span])
    n_items = 9999
    M = torch.zeros((2, n_items + 1), dtype=torch.int32)
    acc = torch.zeros(1 + 2 * n, dtype=torch.int64)
    acc[0] = int(parse_kernels.ERR_NONE)
    parse_kernels.parse_pack(
        parse_kernels.upload(buf[lo:hi], torch.device("cpu")), torch.from_numpy(descs),
        M, torch.ones(n_items + 1, dtype=torch.int32), n_items, acc,
    )
    assert acc[0] == parse_kernels.ERR_NONE
    want_M = np.zeros((2, n_items + 1), dtype=np.uint32)
    for k in range(n):
        ids, _ = parse_kernels.list_steps(np.frombuffer(texts[perm[k]], np.uint8), bool(walk[k]), n_items)
        assert acc[1 + k] == acc[1 + n + k] == len(ids)
        if words[k] >= 0:
            want_M[words[k], ids] |= np.uint32(1 << int(bits[k]))
    np.testing.assert_array_equal(M.numpy().view(np.uint32), want_M)


def test_descriptors_refuse_overlapping_lists():
    z = np.zeros(2, np.int32)
    with pytest.raises(ValueError, match="overlap"):
        parse_kernels.descriptors(np.array([0, 3]), np.array([5, 8]), z.astype(np.uint8), z, z)


def test_upload_reads_a_read_only_map_without_a_warning(tmp_path, recwarn):
    import mmap

    f = tmp_path / "b"
    f.write_bytes(b"1+,2+\n")
    with open(f, "rb") as fh:
        mm = mmap.mmap(fh.fileno(), 0, prot=mmap.PROT_READ)
    buf = np.frombuffer(mm, dtype=np.uint8)
    text = parse_kernels.upload(buf[0:5], torch.device("cpu"))
    assert bytes(text.numpy()) == b"1+,2+"
    assert not recwarn.list
    del text, buf
    mm.close()


# -- the route on the CPU ------------------------------------------------------


def _build(gfa, counts, forced, groups=None):
    from panacus_torch.gfa import GraphStorage
    from panacus_torch.mask import GraphMask, GraphMaskParameters
    from panacus_torch.utils import CountType

    cts = [CountType[c.upper()] for c in counts]
    g = GraphStorage(str(gfa), index_edges="edge" in counts)
    params = GraphMaskParameters(groupby=str(groups)) if groups else GraphMaskParameters(groupby_haplotype=True)
    mask = GraphMask.from_datamgr(params, g)
    with pytest.MonkeyPatch.context() as mp:
        if forced:
            mp.setattr(stream, "parse_on_device", lambda *a: True)
        return g, stream.streamed_total_abaci(g, mask, cts, (torch.device("cpu"),))


def _same_build(g, host, dev):
    from panacus_torch.utils import CountType

    assert host is not None and dev is not None
    for ct in host[0]:
        assert torch.equal(host[0][ct].engine.shards[0], dev[0][ct].engine.shards[0]), ct
    assert list(host[1].paths_len.items()) == list(dev[1].paths_len.items())
    assert host[2:] == dev[2:]
    for ct, h, d in zip(host[0], host[1].item_tables, dev[1].item_tables):
        lazy = stream.LazyParsedEdgeTable if ct == CountType.EDGE else stream.LazyNodeTable
        assert type(d) is lazy, ct
        for p in range(len(g.path_segments)):
            np.testing.assert_array_equal(h.path_slice(p), d.path_slice(p))
        np.testing.assert_array_equal(h.items, d.items)
        np.testing.assert_array_equal(h.prefsum, d.prefsum)


def _interleaved(graphs, tmp_path):  # noqa: F811
    """The dryrun graph with its P and W lines moved among its S lines, so
    that the bytes between step lists hold whole other lines."""
    lines = (graphs / "dryrun.gfa").read_text().splitlines()
    paths = [l for l in lines if l[:2] in ("P\t", "W\t")]
    rest = [l for l in lines if l[:2] not in ("P\t", "W\t")]
    segs = [k for k, l in enumerate(rest) if l.startswith("S\t")]
    for j, line in enumerate(paths):
        rest.insert(segs[(j * len(segs)) // len(paths)] + 1 + j, line)
    out = tmp_path / "interleaved.gfa"
    out.write_text("\n".join(rest) + "\n")
    return out


@pytest.mark.parametrize("layout", ["as_written", "paths_among_segments"])
@pytest.mark.parametrize(
    "counts", [("node",), ("bp",), ("node", "bp"), ("node", "bp", "edge"), ("edge",)], ids="+".join)
@pytest.mark.parametrize("grouping", ["haplotype", "group_file"])
def test_route_equals_the_host_tokenizer(graphs, tmp_path, layout, counts, grouping):  # noqa: F811
    """The dryrun graph (P and W lines): the node and edge M, paths_len,
    path order and item tables of the route (the plain parses) equal the
    host tokenizer's, with the group file's trailing slab of paths in no
    group, also where other lines lie between the step lists."""
    groups = graphs / "groups.tsv" if grouping == "group_file" else None
    gfa = _interleaved(graphs, tmp_path) if layout == "paths_among_segments" else graphs / "dryrun.gfa"
    g, host = _build(gfa, counts, False, groups)
    _, dev = _build(gfa, counts, True, groups)
    _same_build(g, host, dev)


@pytest.mark.parametrize("counts", [("node",), ("node", "bp", "edge"), ("edge",)], ids="+".join)
def test_route_on_make_graph_and_its_counts(tmp_path, counts):
    """make_graph at 3000 nodes and 90 paths (3 slabs): the build's counts
    say every slab went to the device, and a profiled build has one
    `build.stage` with the bytes from the first step list to the last, and
    one parse and one wait for the node rows and one for the edge rows."""
    from panacus_torch import runtime
    from torch.profiler import ProfilerActivity, profile

    gfa = tmp_path / "g.gfa"
    testgraphs.make_graph(str(gfa), n_nodes=3000, n_paths=90)
    g, host = _build(gfa, counts, False)
    runtime.reset_spans()
    with profile(activities=[ProfilerActivity.CPU]):
        with runtime.span("abaci_by_total"):
            _, dev = _build(gfa, counts, True)
    _same_build(g, host, dev)
    got = runtime.spans()
    staged = [r for r in got if r.name == "build.stage"]
    spans = np.asarray(g._pw_seq_spans)
    assert [r.counts for r in staged] == [{"bytes": int(spans[:, 1].max() - spans[:, 0].min())}]
    passes = ("node" in counts) + ("edge" in counts)
    assert [r.name for r in got].count("build.parse") == passes
    assert [r.name for r in got].count("build.wait") == passes
    assert not {"build.tokenize", "build.edge_pack"} & {r.name for r in got}
    top_rec = [r for r in got if r.name == "abaci_by_total"][0]
    # a GraphStorage made with no device to upload to: the build copies
    want = {"uploads": 1, "uploads_early": 0}
    if "node" in counts:
        want.update(node_slabs=3, node_slabs_on_device=3)
    if "edge" in counts:
        want.update(edge_slabs=3, edge_slabs_repacked=0, edge_slabs_on_device=3)
    assert top_rec.counts == want
    runtime.reset_spans()


def test_edges_past_the_adjacency_take_the_host_pass(tmp_path, monkeypatch):
    """A graph past the CSR adjacency's packed layout (here: the layout
    capped at one edge): the whole build takes the host tokenizer's pass,
    node rows and edge rows, and both M equal the host build's."""
    from panacus_torch import runtime
    from panacus_torch.gfa import SlabbedItemTable
    from torch.profiler import ProfilerActivity, profile

    monkeypatch.setattr(native, "ADJ_MAX_EDGES", 1)
    gfa = tmp_path / "g.gfa"
    testgraphs.make_graph(str(gfa), n_nodes=3000, n_paths=90)
    counts = ("node", "bp", "edge")
    g, host = _build(gfa, counts, False)
    runtime.reset_spans()
    with profile(activities=[ProfilerActivity.CPU]):
        with runtime.span("abaci_by_total"):
            _, dev = _build(gfa, counts, True)
    assert g.edge_adj() is None
    for ct in host[0]:
        assert torch.equal(host[0][ct].engine.shards[0], dev[0][ct].engine.shards[0]), ct
    assert list(host[1].paths_len.items()) == list(dev[1].paths_len.items())
    assert [type(t) for t in dev[1].item_tables] == [SlabbedItemTable] * 3
    for h, d in zip(host[1].item_tables, dev[1].item_tables):
        np.testing.assert_array_equal(h.items, d.items)
    got = runtime.spans()
    assert [r.name for r in got].count("build.parse") == 0
    assert [r.name for r in got].count("build.tokenize") == 3
    (top,) = [r for r in got if r.name == "abaci_by_total"]
    assert {k: top.counts[k] for k in ("node_slabs_on_device", "edge_slabs", "edge_slabs_on_device")} == {
        "node_slabs_on_device": 0, "edge_slabs": 3, "edge_slabs_on_device": 0}
    runtime.reset_spans()


def test_route_engages_only_where_it_applies(graphs, monkeypatch):  # noqa: F811
    from panacus_torch import runtime
    from panacus_torch.gfa import GraphStorage

    g = GraphStorage(str(graphs / "dryrun.gfa"), index_edges=False)
    card, cpu = (torch.device("cuda", 0),), (torch.device("cpu"),)
    on = stream.parse_on_device
    assert on(card, False, g.identity_names)  # whatever the build counts
    assert on(card, False)  # the broker, before the index knows the names
    assert not on(cpu, False, g.identity_names)
    assert not on(card * 2, False, g.identity_names)
    assert not on(card, True, g.identity_names)
    g._int_name_mode = "sorted"
    assert not on(card, False, g.identity_names)
    monkeypatch.setattr(runtime, "_world", (0, 2), raising=False)
    monkeypatch.setattr(stream, "world", lambda: (0, 2))
    assert not on(card, False)


def _malformed(graphs, tmp_path):  # noqa: F811
    """The dryrun graph with a ',' after the last step of its first P line:
    the host tokenizer and the device parse refuse it, the classic path's
    one-line parse takes it."""
    lines = (graphs / "dryrun.gfa").read_text().splitlines()
    i = next(k for k, l in enumerate(lines) if l.startswith("P\t"))
    f = lines[i].split("\t")
    f[2] += ","
    lines[i] = "\t".join(f)
    bad = tmp_path / "bad.gfa"
    bad.write_text("\n".join(lines) + "\n")
    return bad


def test_malformed_step_list_returns_none(graphs, tmp_path, monkeypatch):  # noqa: F811
    discarded = []
    real = MembershipStream.discard
    monkeypatch.setattr(MembershipStream, "discard", lambda self: (discarded.append(self), real(self)))
    _, res = _build(_malformed(graphs, tmp_path), ("node",), True)
    assert res is None
    assert len(discarded) == 1 and discarded[0]._M_host is None


def _without_an_l_line(graphs, tmp_path):  # noqa: F811
    """The dryrun graph less the L line of its first P line's first pair of
    steps (either way round)."""
    lines = (graphs / "dryrun.gfa").read_text().splitlines()
    a, b = next(l for l in lines if l.startswith("P\t")).split("\t")[2].split(",")[:2]
    flip = {"+": "-", "-": "+"}
    gone = {("L", a[:-1], a[-1], b[:-1], b[-1]), ("L", b[:-1], flip[b[-1]], a[:-1], flip[a[-1]])}
    keep = [l for l in lines if tuple(l.split("\t")[:5]) not in gone]
    assert len(keep) == len(lines) - 1
    out = tmp_path / "no_l_line.gfa"
    out.write_text("\n".join(keep) + "\n")
    return out


def test_pair_without_l_line_takes_the_classic_path(graphs, tmp_path, monkeypatch):  # noqa: F811
    """A path walks a pair of steps that no L line holds: the route drops
    both streams and returns None, and the CLI fails as the host's route
    fails."""
    discarded = []
    real = MembershipStream.discard
    monkeypatch.setattr(MembershipStream, "discard", lambda self: (discarded.append(self), real(self)))
    gfa = _without_an_l_line(graphs, tmp_path)
    _, res = _build(gfa, ("node", "bp", "edge"), True)
    assert res is None and len(discarded) == 2
    errors = []
    for forced in (False, True):
        with pytest.MonkeyPatch.context() as mp:
            if forced:
                mp.setattr(stream, "parse_on_device", lambda *a: True)
            with pytest.raises(ValueError, match="unknown edge") as e:
                torch_cli(["histgrowth", "-c", "all", "-H", str(gfa)], devices=(torch.device("cpu"),))
        errors.append(str(e.value))
    assert errors[0] == errors[1]


def _body(out: str) -> str:
    return "".join(l for l in out.splitlines(True) if not l.startswith("#"))


CLI = [
    ["histgrowth", "-c", "node", "-H", "-q", "0,0.5,1", "-l", "0,1,2"],
    ["histgrowth", "-c", "bp", "-S", "-a"],
    ["histgrowth", "-c", "node", "-g", "{groups}"],
    ["histgrowth", "-c", "all", "-H", "-q", "0,0.5,1", "-l", "0,1,2"],
    ["histgrowth", "-c", "edge", "-g", "{groups}"],
    ["info", "-S"],
    ["table", "-S"],
    ["table", "-c", "bp", "-g", "{groups}"],
    ["table", "-c", "edge", "-S"],
]


@pytest.mark.parametrize("graph", ["dryrun", "bench", "bad"])
@pytest.mark.parametrize("argv", CLI, ids=[" ".join(a) for a in CLI])
def test_tsv_equals_jax(graphs, tmp_path, argv, graph, capsys, monkeypatch, caplog):  # noqa: F811
    """The CLI with the route forced on the CPU gives panacus_tpu's TSV; a
    malformed step list gives it through the classic path."""
    pytest.importorskip("jax")
    from panacus_tpu.cli import run_cli as jax_cli

    gfa = _malformed(graphs, tmp_path) if graph == "bad" else graphs / f"{graph}.gfa"
    argv = [a.replace("{groups}", str(graphs / "groups.tsv")) for a in argv] + [str(gfa)]
    monkeypatch.setenv("PANACUS_TORCH_DEVICE", "cpu")
    monkeypatch.setattr(stream, "parse_on_device", lambda *a: True)
    with caplog.at_level(logging.INFO, logger="panacus"):
        caplog.clear()
        assert torch_cli(argv) == 0
    got = _body(capsys.readouterr().out)
    parsed = "step lists parsed on the device" in caplog.text
    assert parsed == ("streamed membership build" in caplog.text)
    if graph == "bad":
        assert parsed
    assert jax_cli(argv) == 0
    assert _body(capsys.readouterr().out) == got


# -- the upload the index starts ----------------------------------------------


def _lines_gfa(tmp_path, paths, among_s=False, n_items=9999):
    """A GFA of S lines 1..n_items (identity names) and the paths, given as
    (kind, step list) with kind "P" or "W", after the S lines or among them."""
    segs = [f"S\t{i}\tA" for i in range(1, n_items + 1)]
    lines = []
    for k, (kind, steps) in enumerate(paths):
        if kind == "P":
            lines.append(f"P\ts{k}#0#c\t{steps}\t*")
        else:
            lines.append(f"W\ts{k}\t0\tc\t0\t9\t{steps}")
    if among_s:
        out = []
        for j, seg in enumerate(segs):
            out.append(seg)
            if lines and j % 997 == 5:
                out.append(lines.pop(0))
        out += lines
    else:
        out = segs + lines
    gfa = tmp_path / "lines.gfa"
    gfa.write_text("\n".join(out) + "\n")
    return gfa


RANGES = {
    "p_lines": ([("P", "1+,22-,333+,4444-"), ("P", "9+"), ("P", "1234+,1+")], False),
    "w_lines": ([("W", ">5<66>777<8888"), ("W", ">1"), ("W", "<9999>2")], False),
    "p_and_w_among_s_lines": (
        [("P", "1+,22-"), ("W", ">5<66"), ("P", "9+"), ("W", ">1"), ("P", "7-,8+")], True),
    "empty_lists": ([("P", ""), ("P", "1+,2+"), ("P", ""), ("W", ">3"), ("P", "")], False),
}


def _range_covers_today(graphs, tmp_path, monkeypatch, capsys, caplog, name):
    """The index's upload holds the bytes from the first P/W line to the
    last; with its descriptor rows offset by that base, every row names the
    bytes that today's rows name in buf[lo:hi], and the text holds all of
    buf[lo:hi]."""
    from panacus_torch.gfa import GraphStorage

    paths, among_s = RANGES[name]
    g = GraphStorage(str(_lines_gfa(tmp_path, paths, among_s)), index_edges=False,
                     upload_to=torch.device("cpu"))
    assert g.identity_names
    up = g.take_upload()
    assert g.take_upload() is None  # the first build alone takes it
    text = up.take()
    up.close()
    assert up.end - up.base == text.numel()
    starts, ends, walk = g.step_lists()
    z = np.zeros(len(starts), np.int32)
    lo, hi, today = parse_kernels.descriptors(starts, ends, walk, z, z)
    assert len(today) == sum(1 for _, steps in paths if steps)
    early = today.copy()
    early[:, :2] += lo - up.base
    s, buf = text.numpy(), g.buf
    for (b, e, *_), (eb, ee, *_) in zip(today.tolist(), early.tolist()):
        assert s[eb:ee].tobytes() == buf[lo + b : lo + e].tobytes() != b""
    assert up.base <= lo and hi <= up.end
    assert s[lo - up.base : hi - up.base].tobytes() == buf[lo:hi].tobytes()


class _Jobs:
    """Records the StepUploads started and whether a build took each."""

    def __init__(self, monkeypatch):
        self.made, self.taken = [], []
        made, taken = self.made, self.taken

        class Recorded(parse_kernels.StepUpload):
            def __init__(self, *a, **k):
                super().__init__(*a, **k)
                made.append(self)

            def take(self):
                taken.append(self)
                return super().take()

        monkeypatch.setattr(parse_kernels, "StepUpload", Recorded)


def _run(argv, capsys):
    assert torch_cli(argv) == 0
    return _body(capsys.readouterr().out)


JOBLESS = {
    "all": ["histgrowth", "-c", "all", "-H"],
    "edge": ["histgrowth", "-c", "edge", "-H"],
    "subset": ["histgrowth", "-c", "node", "-H", "-s", "{subset}"],
    "exclude": ["histgrowth", "-c", "node", "-H", "-e", "{exclude}"],
    "names": ["histgrowth", "-c", "node", "-H"],
}


def _no_job(graphs, tmp_path, monkeypatch, capsys, caplog, name):
    """With the card's device forced to the CPU, `-c node` starts one job and
    its build takes it, and so do -c all and -c edge; a subset, an exclude
    and names other than 1..n start none."""
    monkeypatch.setenv("PANACUS_TORCH_DEVICE", "cpu")
    monkeypatch.setattr(stream, "_parses_on", lambda device: True)
    jobs = _Jobs(monkeypatch)
    gfa = graphs / "dryrun.gfa"
    _run(["histgrowth", "-c", "node", "-H", str(gfa)], capsys)
    assert len(jobs.made) == len(jobs.taken) == 1
    if name == "names":  # the same graph, node i named 10 * i
        text = gfa.read_text().splitlines()
        renamed = []
        for line in text:
            f = line.split("\t")
            if f[0] == "S":
                f[1] = str(10 * int(f[1]))
            elif f[0] == "P":
                f[2] = ",".join(str(10 * int(s[:-1])) + s[-1] for s in f[2].split(","))
            elif f[0] == "W":
                f[6] = re.sub(r"\d+", lambda m: str(10 * int(m.group())), f[6])
            elif f[0] == "L":
                f[1], f[3] = str(10 * int(f[1])), str(10 * int(f[3]))
            renamed.append("\t".join(f))
        gfa = tmp_path / "renamed.gfa"
        gfa.write_text("\n".join(renamed) + "\n")
    argv = [a.format(subset=graphs / "subset.bed", exclude=graphs / "exclude.bed")
            for a in JOBLESS[name]]
    _run(argv + [str(gfa)], capsys)
    starts = name in ("all", "edge")  # the edge rows parse on the card too
    assert len(jobs.made) == len(jobs.taken) == 1 + starts


TSVS = {
    "histgrowth_node": ["histgrowth", "-c", "node", "-H", "-q", "0,0.5,1", "-l", "0,1,2"],
    "histgrowth_bp": ["histgrowth", "-c", "bp", "-S", "-a"],
    "histgrowth_all": ["histgrowth", "-c", "all", "-H", "-q", "0,0.5,1", "-l", "0,1,2"],
    "similarity_node": ["similarity", "-c", "node", "-H"],
    "info": ["info", "-S"],
}


def _tsv(graphs, tmp_path, monkeypatch, capsys, caplog, name):
    """The CLI with the card's device forced to the CPU: each build takes
    the index's upload and parses from it (no bail to the classic
    itemizer), and the TSV equals panacus_tpu's."""
    pytest.importorskip("jax")
    from panacus_torch import broker
    from panacus_tpu.cli import run_cli as jax_cli

    def refuse(*a, **k):
        raise AssertionError("the build bailed to the classic itemizer")

    monkeypatch.setattr(broker, "itemize_paths", refuse)
    monkeypatch.setenv("PANACUS_TORCH_DEVICE", "cpu")
    monkeypatch.setattr(stream, "_parses_on", lambda device: True)
    jobs = _Jobs(monkeypatch)
    for graph in ("dryrun", "bench"):
        argv = TSVS[name] + [str(graphs / f"{graph}.gfa")]
        with caplog.at_level(logging.INFO, logger="panacus"):
            caplog.clear()
            got = _run(argv, capsys)
        assert "step lists parsed on the device" in caplog.text
        assert len(jobs.taken) == len(jobs.made) == 1
        jobs.made.clear()
        jobs.taken.clear()
        assert jax_cli(argv) == 0
        assert _body(capsys.readouterr().out) == got


def _never_builds(graphs, tmp_path, monkeypatch, capsys, caplog, name):
    """A command that loads and raises before its build (a missing group
    file) joins the upload's job before it releases the graph."""
    import time

    copy = parse_kernels.upload

    def slow(data, device):
        time.sleep(0.3)  # still running when the command raises, unless joined
        return copy(data, device)

    monkeypatch.setattr(parse_kernels, "upload", slow)
    monkeypatch.setenv("PANACUS_TORCH_DEVICE", "cpu")
    monkeypatch.setattr(stream, "_parses_on", lambda device: True)
    jobs = _Jobs(monkeypatch)
    argv = ["histgrowth", "-c", "node", "-g", str(tmp_path / "missing.tsv"), str(graphs / "dryrun.gfa")]
    with pytest.raises(Exception):
        torch_cli(argv)
    (up,) = jobs.made
    assert not jobs.taken and up._job.done() and up._text is None


EARLY = {
    **{f"range_{k}": (_range_covers_today, k) for k in RANGES},
    **{f"no_job_{k}": (_no_job, k) for k in JOBLESS},
    **{f"tsv_{k}": (_tsv, k) for k in TSVS},
    "never_builds": (_never_builds, None),
}


@pytest.mark.parametrize("case", sorted(EARLY))
def test_the_upload_the_index_starts(graphs, tmp_path, monkeypatch, capsys, caplog, case):  # noqa: F811
    """The step-list upload that GraphStorage starts while indexing:
    `range_*` its bytes against today's buf[lo:hi], `no_job_*` the loads
    that start none, `tsv_*` the CLI's TSVs against panacus_tpu's with the
    route forced onto the CPU, `never_builds` a command that raises before
    its build."""
    check, name = EARLY[case]
    check(graphs, tmp_path, monkeypatch, capsys, caplog, name)
