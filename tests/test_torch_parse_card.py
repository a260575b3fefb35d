"""pt_parse_pack, pt_parse_pack_edges and the streamed build's device route
on the card.

The kernels of csrc/parse.cu against their plain versions
(ops/parse_kernels.parse_pack_ref, parse_pack_edges_ref) on the step lists
of tests/parse_cases.py (and its edge cases for the edge kernel) and on
random lists whose tokens straddle their windows, each between bytes of
other fields: M and every sum equal where every token (and pair) is good,
the error slot equal where one is not. The route on cuda:0 against the
route on the CPU (the plain parses) and the host tokenizer's build, for
node and bp, -c all and -c edge; a malformed step list takes the classic
path with the CPU's TSVs, and so does a pair of steps with no L line; a
launch the card refuses raises. The upload that the index starts (parse_kernels.StepUpload), from
the plain map and from gz input, gives the same M, counts and error slot as
the one copy of the step lists; a malformed list still bails; every
command joins its upload, and the counts of the upload read 1 and 1. All
tests here need a card and skip without one; run them there with
`PANACUS_TEST_TPU=1 python -m pytest -m cuda tests/test_torch_parse_card.py`.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import parse_cases as pc
from panacus_torch import stream, testgraphs
from panacus_torch.cli import run_cli as torch_cli
from panacus_torch.ops import kernels, parse_kernels

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (no CUDA device here)")
    return torch.device("cuda", 0)


def _both(pieces, card, seed=0):
    """acc and M of the kernel and of the plain version on the lists."""
    text, descs = pc.layout(pieces, seed)
    n = pc.n_spans(pieces)
    lens = pc.node_lens()
    M, acc = pc.outputs(n)
    parse_kernels.parse_pack(text, descs, M, lens, pc.N_ITEMS, acc)
    dM, dacc = pc.outputs(n, card)
    before = kernels.launches["pt_parse_pack"]
    parse_kernels.parse_pack(text.to(card), descs.to(card), dM, lens.to(card), pc.N_ITEMS, dacc)
    torch.cuda.synchronize()
    assert kernels.launches["pt_parse_pack"] == before + 1
    return (acc, M), (dacc.cpu(), dM.cpu())


@pytest.mark.parametrize("name", sorted(pc.CASES))
def test_kernel_equals_plain_on_the_cases(card, name):
    pieces, good = pc.CASES[name]
    (acc, M), (dacc, dM) = _both(pieces, card)
    assert dacc[0] == acc[0]
    assert (acc[0] == parse_kernels.ERR_NONE) == good
    if good:
        assert torch.equal(dacc, acc)
        assert torch.equal(dM, M)


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_kernel_equals_plain_on_random_pieces(card, seed):
    rng = np.random.default_rng(seed)
    pieces = pc.random_pieces(rng, 300, 3000)
    (acc, M), (dacc, dM) = _both(pieces, card, seed)
    assert acc[0] == parse_kernels.ERR_NONE
    assert torch.equal(dacc, acc)
    assert torch.equal(dM, M)


def _both_edges(pieces, missing, card, seed=0):
    """The edge M and error slot of the kernel and of the plain version."""
    adj = pc.adjacency(pieces, missing, seed)
    text, descs = pc.layout(pieces, seed)
    M, err = pc.edge_outputs(adj[2])
    parse_kernels.parse_pack_edges(text, descs, M, *pc.edge_tensors(adj), pc.N_ITEMS, err)
    dM, derr = pc.edge_outputs(adj[2], card)
    before = kernels.launches["pt_parse_pack_edges"]
    parse_kernels.parse_pack_edges(
        text.to(card), descs.to(card), dM, *pc.edge_tensors(adj, card), pc.N_ITEMS, derr)
    torch.cuda.synchronize()
    assert kernels.launches["pt_parse_pack_edges"] == before + 1
    return (err, M), (derr.cpu(), dM.cpu())


EDGE_CASES = {**{k: (v[0], []) for k, v in pc.CASES.items()}, **pc.EDGE_CASES}


@pytest.mark.parametrize("name", sorted(EDGE_CASES))
def test_edge_kernel_equals_plain_on_the_cases(card, name):
    pieces, missing = EDGE_CASES[name]
    (err, M), (derr, dM) = _both_edges(pieces, missing, card)
    assert int(derr[0]) == int(err[0]) == pc.failing_span(pieces, missing)
    if err[0] == parse_kernels.ERR_NONE:
        assert torch.equal(dM, M)


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_edge_kernel_equals_plain_on_random_pieces(card, seed):
    pieces = pc.random_pieces(np.random.default_rng(seed), 300, 3000)
    (err, M), (derr, dM) = _both_edges(pieces, [], card, seed)
    assert int(err[0]) == int(derr[0]) == parse_kernels.ERR_NONE
    assert torch.equal(dM, M)


def test_refused_launch_raises(card):
    """An empty text asks for a grid of no blocks: the card refuses the
    launch and the wrapper raises."""
    _, descs = pc.layout(pc.CASES["leading_zeros"][0])
    M, acc = pc.outputs(2, card)
    empty = torch.zeros(0, dtype=torch.uint8, device=card)
    with pytest.raises(RuntimeError, match="pt_parse_pack failed"):
        parse_kernels.parse_pack(empty, descs.to(card), M, pc.node_lens().to(card), pc.N_ITEMS, acc)


@pytest.fixture(scope="module")
def graph(tmp_path_factory):
    gfa = tmp_path_factory.mktemp("parse_card") / "g.gfa"
    testgraphs.make_graph(str(gfa), n_nodes=200_000, n_paths=70)
    return gfa


NODE_BP = ("node", "bp")


def _build(gfa, device, forced=False, counts=NODE_BP):
    from panacus_torch.gfa import GraphStorage
    from panacus_torch.mask import GraphMask, GraphMaskParameters
    from panacus_torch.utils import CountType

    g = GraphStorage(str(gfa), index_edges="edge" in counts)
    mask = GraphMask.from_datamgr(GraphMaskParameters(groupby_haplotype=True), g)
    with pytest.MonkeyPatch.context() as mp:
        if forced:
            mp.setattr(stream, "parse_on_device", lambda *a: True)
        cts = [CountType[c.upper()] for c in counts]
        return stream.streamed_total_abaci(g, mask, cts, (device,))


@pytest.mark.parametrize("counts", [NODE_BP, ("node", "bp", "edge"), ("edge",)], ids="+".join)
def test_route_on_the_card_equals_the_cpu(card, graph, counts):
    """make_graph at 200,000 nodes, 70 paths (3 slabs, about 9 MB of steps)
    in one launch a pass: the node and edge M, paths_len and the item
    tables on the card equal the plain parses' and the host tokenizer's."""
    before = {k: kernels.launches[k] for k in ("pt_parse_pack", "pt_parse_pack_edges")}
    got = _build(graph, card, counts=counts)
    assert {k: kernels.launches[k] - n for k, n in before.items()} == {
        "pt_parse_pack": int("node" in counts), "pt_parse_pack_edges": int("edge" in counts)}
    for table, ct in zip(got[1].item_tables, counts):
        lazy = stream.LazyParsedEdgeTable if ct == "edge" else stream.LazyNodeTable
        assert type(table) is lazy, ct
    cpu = torch.device("cpu")
    for want in (_build(graph, cpu, forced=True, counts=counts), _build(graph, cpu, counts=counts)):
        for ct in want[0]:
            assert torch.equal(got[0][ct].engine.shards[0].cpu(), want[0][ct].engine.shards[0]), ct
        assert list(got[1].paths_len.items()) == list(want[1].paths_len.items())
        for mine, theirs in zip(got[1].item_tables, want[1].item_tables):
            np.testing.assert_array_equal(mine.items, theirs.items)


def test_pair_without_l_line_bails_on_the_card(card, graph, tmp_path):
    """The graph less the L line of its first path's first pair of steps:
    the edge kernel finds the pair, the route returns None, and the CLI
    fails on the card as on the CPU."""
    lines = graph.read_text().splitlines()
    a, b = next(l for l in lines if l.startswith("P\t")).split("\t")[2].split(",")[:2]
    flip = {"+": "-", "-": "+"}
    gone = {("L", a[:-1], a[-1], b[:-1], b[-1]), ("L", b[:-1], flip[b[-1]], a[:-1], flip[a[-1]])}
    gfa = tmp_path / "no_l_line.gfa"
    gfa.write_text("\n".join(l for l in lines if tuple(l.split("\t")[:5]) not in gone) + "\n")
    before = kernels.launches["pt_parse_pack_edges"]
    assert _build(gfa, card, counts=("node", "bp", "edge")) is None
    assert kernels.launches["pt_parse_pack_edges"] == before + 1
    errors = []
    for dev in (card, torch.device("cpu")):
        with pytest.raises(ValueError, match="unknown edge") as e:
            torch_cli(["histgrowth", "-c", "all", "-H", str(gfa)], devices=(dev,))
        errors.append(str(e.value))
    assert errors[0] == errors[1]


def _body(out: str) -> str:
    return "".join(l for l in out.splitlines(True) if not l.startswith("#"))


def test_malformed_graph_takes_the_classic_path(card, graph, tmp_path, capsys, monkeypatch, caplog):
    """A ',' after the last step of one P line: the kernel finds it, the
    build goes the classic way, and the TSVs equal the CPU's (info counts
    edges, and its build takes the route too)."""
    import logging

    text = graph.read_bytes()
    i = text.index(b"\t*\n", text.index(b"\nP\t"))
    bad = tmp_path / "bad.gfa"
    bad.write_bytes(text[:i] + b"," + text[i:])
    for argv in (["histgrowth", "-c", "node", "-H"], ["info", "-S"], ["table", "-c", "bp", "-S"]):
        want = None
        for dev in ("cpu", "cuda"):
            monkeypatch.setenv("PANACUS_TORCH_DEVICE", dev)
            before = kernels.launches["pt_parse_pack"]
            with caplog.at_level(logging.INFO, logger="panacus"):
                caplog.clear()
                assert torch_cli(argv + [str(bad)]) == 0
            out = _body(capsys.readouterr().out)
            if dev == "cuda":
                assert "parsed on the device" in caplog.text
                assert kernels.launches["pt_parse_pack"] > before
            want = out if want is None else want
            assert out == want, (argv, dev)


# -- the upload the index starts -------------------------------------------
#
# A plain GFA is a file mapping; a .gz GFA is inflated into a heap buffer.


def _bad(graph, tmp_path):
    text = graph.read_bytes()
    i = text.index(b"\t*\n", text.index(b"\nP\t"))
    bad = tmp_path / "bad.gfa"
    bad.write_bytes(text[:i] + b"," + text[i:])
    return bad


def _gz(gfa):
    return testgraphs.write_gzip(str(gfa), str(gfa) + ".gz")


def _lists(g):
    """(lo, hi, descs) of every step list of g, in word 0."""
    starts, ends, walk = g.step_lists()
    n = len(starts)
    return parse_kernels.descriptors(
        starts, ends, walk, np.zeros(n, np.int32), (np.arange(n) % 32).astype(np.int32))


def _parse(g, text, base, device):
    """M and acc of one pt_parse_pack over every step list of g, the text
    holding buf[base:] from its start."""
    lo, _, descs = _lists(g)
    descs[:, :2] += lo - base
    n = len(g.path_segments)
    M = torch.zeros((1, g.node_count + 1), dtype=torch.int32, device=device)
    acc = torch.zeros(1 + 2 * n, dtype=torch.int64, device=device)
    acc[0] = int(parse_kernels.ERR_NONE)
    lens = torch.from_numpy(g.node_lens.view(np.int32)).to(device)
    parse_kernels.parse_pack(text, torch.from_numpy(descs).to(device), M, lens, g.node_count, acc)
    return M.cpu(), acc.cpu()


@pytest.mark.parametrize("malformed", [False, True], ids=["good", "malformed"])
@pytest.mark.parametrize("kind", ["plain", "gz"])
def test_upload_routes_equal_the_one_copy(card, graph, tmp_path, kind, malformed):
    """The index's upload of the plain map and of gz input: M, the counts
    and the error slot equal one copy of buf[lo:hi]'s on the calling
    thread."""
    from panacus_torch.gfa import GraphStorage

    gfa = _bad(graph, tmp_path) if malformed else graph
    g = GraphStorage(str(_gz(gfa) if kind == "gz" else gfa), index_edges=False)
    up = parse_kernels.StepUpload(g.buf, int(g._pw_starts[0]), int(g._pw_ends[-1]), card)
    text = up.take()
    up.close()
    got = _parse(g, text, up.base, card)
    lo, hi, _ = _lists(g)
    M, acc = _parse(g, parse_kernels.upload(g.buf[lo:hi], card), lo, card)
    assert torch.equal(got[1], acc)
    assert (acc[0] == parse_kernels.ERR_NONE) != malformed
    assert torch.equal(got[0], M)


def _early_build(gfa, card):
    """The streamed build as the CLI's broker runs it: the index starts the
    upload to the card, the build takes it."""
    from panacus_torch.gfa import GraphStorage
    from panacus_torch.mask import GraphMask, GraphMaskParameters
    from panacus_torch.utils import CountType

    g = GraphStorage(str(gfa), index_edges=False, upload_to=card)
    mask = GraphMask.from_datamgr(GraphMaskParameters(groupby_haplotype=True), g)
    return g, stream.streamed_total_abaci(g, mask, [CountType.NODE, CountType.BP], (card,))


def test_malformed_list_bails_and_joins(card, graph, tmp_path):
    g, res = _early_build(_bad(graph, tmp_path), card)
    assert res is None
    assert g.take_upload() is None  # the build took it
    g.close()
    assert g._upload._job.done() and g._upload._text is None


@pytest.mark.parametrize("kind", ["plain", "gz"])
def test_early_build_equals_the_one_copy(card, graph, kind):
    gfa = _gz(graph) if kind == "gz" else graph
    g, got = _early_build(gfa, card)
    want = _build(graph, card)
    for ct in want[0]:
        assert torch.equal(got[0][ct].engine.shards[0], want[0][ct].engine.shards[0]), ct
    assert list(got[1].paths_len.items()) == list(want[1].paths_len.items())
    g.close()


def test_ten_commands_join_their_upload(card, graph, monkeypatch, capsys):
    """Ten commands in one process, on gz input and on the plain map in
    turns: each starts one upload on a worker under `index`, its build
    takes it, the job has ended by the end of the command, and the counts
    of the upload read 1 and 1."""
    import threading

    from panacus_torch import runtime
    from torch.profiler import ProfilerActivity, profile

    made = []

    class Recorded(parse_kernels.StepUpload):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            made.append(self)

    monkeypatch.setattr(parse_kernels, "StepUpload", Recorded)
    monkeypatch.setenv("PANACUS_TORCH_DEVICE", "cuda")
    gz = _gz(graph)
    for k in range(10):
        runtime.reset_spans()
        with profile(activities=[ProfilerActivity.CPU]):
            assert torch_cli(["similarity", "-c", "node", "-H", str(gz if k % 2 else graph)]) == 0
        capsys.readouterr()
        assert len(made) == k + 1 and made[-1]._job.done() and made[-1]._text is None, k
        got = runtime.spans()
        (upload,) = [r for r in got if r.name == "index.upload"]
        (index,) = [r for r in got if r.name == "index"]
        (top,) = [r for r in got if r.name == "abaci_by_total"]
        assert upload.parent == index.id and upload.thread != threading.get_ident()
        assert {c: top.counts[c] for c in ("uploads", "uploads_early")} == {
            "uploads": 1, "uploads_early": 1}
    runtime.reset_spans()
