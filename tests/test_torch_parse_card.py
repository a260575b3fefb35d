"""pt_parse_pack and the streamed build's device route on the card.

The kernel of csrc/parse.cu against its plain version
(ops/parse_kernels.parse_pack_ref) on the step lists of tests/parse_cases.py
and on random lists whose tokens straddle its windows, each between bytes
of other fields: M and every sum equal where every token is good, the error
slot equal where one is not. The route on cuda:0 against the route on the
CPU (the plain parse) and the host tokenizer's build; a malformed step list
takes the classic path with the CPU's TSVs; a launch the card refuses
raises. The upload that the index starts (parse_kernels.StepUpload), from
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


def _build(gfa, device, forced=False):
    from panacus_torch.gfa import GraphStorage
    from panacus_torch.mask import GraphMask, GraphMaskParameters
    from panacus_torch.utils import CountType

    g = GraphStorage(str(gfa), index_edges=False)
    mask = GraphMask.from_datamgr(GraphMaskParameters(groupby_haplotype=True), g)
    with pytest.MonkeyPatch.context() as mp:
        if forced:
            mp.setattr(stream, "parse_on_device", lambda *a: True)
        return stream.streamed_total_abaci(g, mask, [CountType.NODE, CountType.BP], (device,))


def test_route_on_the_card_equals_the_cpu(card, graph):
    """make_graph at 200,000 nodes, 70 paths (3 slabs, about 9 MB of steps)
    in one launch: M, paths_len and the node table on the card equal the
    plain parse's and the host tokenizer's."""
    before = kernels.launches["pt_parse_pack"]
    got = _build(graph, card)
    assert kernels.launches["pt_parse_pack"] - before == 1
    assert isinstance(got[1].item_tables[0], stream.LazyNodeTable)
    for want in (_build(graph, torch.device("cpu"), forced=True), _build(graph, torch.device("cpu"))):
        for ct in want[0]:
            assert torch.equal(got[0][ct].engine.shards[0].cpu(), want[0][ct].engine.shards[0]), ct
        assert list(got[1].paths_len.items()) == list(want[1].paths_len.items())
        np.testing.assert_array_equal(got[1].item_tables[0].items, want[1].item_tables[0].items)


def _body(out: str) -> str:
    return "".join(l for l in out.splitlines(True) if not l.startswith("#"))


def test_malformed_graph_takes_the_classic_path(card, graph, tmp_path, capsys, monkeypatch, caplog):
    """A ',' after the last step of one P line: the kernel finds it, the
    build goes the classic way, and the TSVs equal the CPU's (info counts
    edges, so its build stays on the host)."""
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
            if dev == "cuda" and argv[0] != "info":  # info counts edges too
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
