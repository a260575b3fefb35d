"""panacus_torch.bench, the port's measuring program, against bench.py.

On the CPU (PANACUS_TORCH_DEVICE=cpu, the plain versions of the kernels):
- the port's run_histgrowth against bench.run_histgrowth (the JAX package
  on its CPU backend) on the same make_graph file, at 3,000 nodes x 90
  paths and 2,000 x 40, for `all`, `node`, `edge` and the one-member gzip:
  the hists exactly equal, the growth count equal, every growth list
  floor-equal;
- the build's route: streamed, and classic where the streamed build
  returns None (as after a tokenizer bail), with the same hists;
- the `all` stage's hists and growth against the port's `histgrowth -a -c
  all -H` TSV on the same graph;
- the group tail is verified, and an off-by-one ordered vector or a wrong
  similarity entry fails the run;
- a stage, the group tail or the roofline that raises fails main(), which
  then prints nothing;
- main() prints exactly one JSON line, last, with every key, the device_*
  rates null on the CPU; `python -m panacus_torch.bench` without
  PANACUS_TORCH_DEVICE=cpu and without a card exits non-zero and prints
  nothing;
- runtime.hbm_peak_bytes_per_s on the H100 names and unknown names;
  _host_memory_health is positive.
The `cuda` cases run the roofline and a small bench on the card.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import bench as jax_bench
from panacus_torch import bench, runtime, testgraphs
from panacus_torch.cli import run_cli
from panacus_torch.utils import CountType, ThresholdContainer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = (torch.device("cpu"),)
SIZES = [(3000, 90), (2000, 40)]
KEYS = {
    "metric", "value", "unit", "vs_baseline", "stages", "stages_best", "stages_median",
    "routes", "host_mem_mbps",
    "group_stages", *bench.DEVICE_FIELDS, "device",
}
GROUP_KEYS = {
    "build_s", "ordered_cold_s", "ordered_s", "similarity_cold_s", "similarity_s",
    "ordered_last", "sim_trace", "verified",
}


@pytest.fixture(scope="module")
def graphs(tmp_path_factory):
    """size -> (plain GFA, its one-member level-1 gzip)."""
    d = str(tmp_path_factory.mktemp("bench"))
    out = {}
    for n, p in SIZES:
        gfa = testgraphs.cached_graph(d, n, p)
        out[(n, p)] = (gfa, testgraphs.write_gzip(gfa, gfa + ".gz"))
    return out


@pytest.fixture
def on_cpu(monkeypatch, graphs):
    """main() on the CPU, on the 3,000-node graph of `graphs`."""
    monkeypatch.setenv("PANACUS_TORCH_DEVICE", "cpu")
    gfa = graphs[SIZES[0]][0]
    monkeypatch.setattr(bench, "GRAPH_DIR", os.path.dirname(gfa))
    monkeypatch.setattr(bench, "N_NODES", SIZES[0][0])
    monkeypatch.setattr(bench, "N_PATHS", SIZES[0][1])
    return gfa


@pytest.fixture
def one_rep(monkeypatch):
    """Every stage timed once: the failure cases test what propagates, not
    the rep counts."""
    monkeypatch.setattr(bench, "STAGES", tuple(s[:4] + (1,) for s in bench.STAGES))


def growths(hists):
    tc = ThresholdContainer.parse_params(bench.QUORUM, bench.COVERAGE)
    return {ct.value: h.calc_all_growths(tc) for ct, h in hists.items()}


@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("stage", ["all", "node", "edge", "gz_node"])
def test_stage_equals_jax_bench(graphs, size, stage):
    gfa, gz = graphs[size]
    src, count = (gz, "node") if stage == "gz_node" else (gfa, stage)
    want_hists, want_n, _ = jax_bench.run_histgrowth(src, count)
    got_hists, got_n, phases, route = bench.run_histgrowth(src, count, CPU)
    assert route == "streamed"
    assert len(phases) == 4 and all(t >= 0 for t in phases)
    assert got_n == want_n > 0
    assert {ct.value: h.coverage for ct, h in got_hists.items()} == {
        ct.value: list(h.coverage) for ct, h in want_hists.items()
    }
    got, want = growths(got_hists), growths(want_hists)
    assert got.keys() == want.keys()
    for ct in got:
        assert len(got[ct]) == len(want[ct]) == 3
        for g, w in zip(got[ct], want[ct]):
            np.testing.assert_array_equal(np.floor(g), np.floor(w))


@pytest.mark.parametrize("route", ["streamed", "classic"])
def test_stage_build_route(graphs, monkeypatch, route):
    """The stage reports the route the broker's build took; the classic
    itemizer, taken where streamed_total_abaci returns None (as after a
    tokenizer bail), gives the same hists."""
    from panacus_torch import broker

    gfa = graphs[SIZES[0]][0]
    want = bench.run_histgrowth(gfa, "all", CPU)[0]
    if route == "classic":
        monkeypatch.setattr(broker, "streamed_total_abaci", lambda *a: None)
    hists, _, _, stage_route = bench.run_histgrowth(gfa, "all", CPU)
    assert stage_route == route
    assert {ct: h.coverage for ct, h in hists.items()} == {
        ct: h.coverage for ct, h in want.items()
    }


def _tsv_columns(out: str):
    """(hist columns [n + 1, 3], growth columns [n + 1, 9]) of a
    `histgrowth -a -c all` TSV, growth cells as floats (NaN in row 0)."""
    rows = [l.split("\t") for l in out.splitlines() if l and not l.startswith("#")]
    body = rows[4:]
    hist = np.array([[int(x) for x in r[1:4]] for r in body], dtype=np.int64)
    growth = np.array([[float(x) for x in r[4:]] for r in body])
    return hist, growth


def test_all_stage_equals_cli_tsv(graphs, capsys):
    """The `all` stage's node, bp and edge hists equal the hist columns of
    the port's `histgrowth -a -c all -H` TSV, and their growth its growth
    columns (floored), as chip_smoke.py phase 10 checks on the card."""
    gfa = graphs[SIZES[0]][0]
    argv = ["histgrowth", "-a", "-c", "all", "-H", "-q", bench.QUORUM, "-l", bench.COVERAGE]
    capsys.readouterr()
    assert run_cli(argv + [gfa], devices=CPU) == 0
    hist, growth = _tsv_columns(capsys.readouterr().out)
    hists = bench.run_histgrowth(gfa, "all", CPU)[0]
    order = (CountType.NODE, CountType.BP, CountType.EDGE)
    np.testing.assert_array_equal(hist, np.array([hists[ct].coverage for ct in order]).T)
    g = growths(hists)
    want = np.array([row for ct in order for row in g[ct.value]]).T
    np.testing.assert_array_equal(growth[1:], np.floor(want[1:]))


def test_group_tail_verified(graphs):
    gfa = graphs[SIZES[0]][0]
    gs, _, _ = bench.run_group_tail(gfa, CPU)
    assert set(gs) == GROUP_KEYS and gs["verified"] is True
    node_hist = bench.run_histgrowth(gfa, "node", CPU)[0][CountType.NODE].coverage
    assert gs["ordered_last"] == sum(node_hist[1:])  # every covered node
    assert gs["sim_trace"] > 0 and all(gs[k] >= 0 for k in GROUP_KEYS if k.endswith("_s"))


@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_group_tail_equals_jax(graphs, size):
    """run_group_tail's ordered vector and whole intersection matrix equal
    panacus_tpu's AbacusByGroup on the same GFA (the JAX bench's group
    tail: GraphBroker, haplotype groups, c=1 q=0)."""
    from panacus_tpu.broker import GraphBroker, GraphState, Req
    from panacus_tpu.config import Grouping
    from panacus_tpu.utils import CountType as JaxCountType
    from panacus_tpu.utils import Threshold

    gfa = graphs[size][0]
    _, og, inter = bench.run_group_tail(gfa, CPU)
    gb = GraphBroker()
    gb.change_graph_state(
        GraphState(graph=gfa, name="bench", grouping=Grouping.haplotype()),
        {Req.graph(gfa), Req.NODE, Req.HIST, Req.abacus_by_group(JaxCountType.NODE)},
        nice=False,
    )
    ab = gb.get_abacus_by_group()
    want_og = np.asarray(ab.calc_growth(Threshold.absolute(1), Threshold.rel(0.0)))
    want_inter = np.asarray(ab.similarity_matrix()[0])
    assert len(og) == size[1] and inter.shape == (size[1], size[1])
    np.testing.assert_array_equal(og, want_og)
    np.testing.assert_array_equal(inter, want_inter)


@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_oracle_membership_equals_tokenizer(graphs, size):
    """The group tail's oracle, which parses the GFA itself, gives the
    membership the port's tokenizer gives (the rows of each path's ids, in
    the broker's path order)."""
    from panacus_torch.broker import GraphBroker, GraphState, Req
    from panacus_torch.config import Grouping

    gfa = graphs[size][0]
    gb = GraphBroker(CPU)
    gb.change_graph_state(
        GraphState(graph=gfa, grouping=Grouping.haplotype()),
        {Req.graph(gfa), Req.NODE},
        nice=False,
    )
    g = gb.graph_aux
    want = np.zeros((size[1], g.number_of_items(CountType.NODE) + 1), dtype=bool)
    for pid, gi in gb._path_order:
        want[gi, g.path_item_run(pid)[0]] = True
    np.testing.assert_array_equal(bench._oracle_membership(gfa), want)


@pytest.mark.parametrize("fault", ["ordered", "similarity", "similarity_inner"])
def test_wrong_group_result_fails_the_run(on_cpu, one_rep, monkeypatch, capsys, fault):
    """An off-by-one ordered vector, a wrong similarity entry, or a wrong one
    away from the diagonal's neighbours (the whole matrix is checked)
    fails the run."""
    from panacus_torch.abacus import AbacusByGroup

    if fault == "ordered":
        calc_growth = AbacusByGroup.calc_growth

        def off_by_one(self, *a):
            res = calc_growth(self, *a)
            return res[:-1] + [res[-1] + 1]

        monkeypatch.setattr(AbacusByGroup, "calc_growth", off_by_one)
    else:
        similarity_matrix = AbacusByGroup.similarity_matrix

        def wrong_entry(self):
            inter, sizes = similarity_matrix(self)
            inter = np.array(inter)
            a, b = (0, 1) if fault == "similarity" else (5, 37)
            inter[a, b] += 1
            inter[b, a] += 1
            return inter, sizes

        monkeypatch.setattr(AbacusByGroup, "similarity_matrix", wrong_entry)
    flag = "ordered_ok=False" if fault == "ordered" else "sim_ok=False"
    with pytest.raises(bench.BenchError, match=flag):
        bench.main([])
    assert capsys.readouterr().out == ""


@pytest.mark.parametrize("where", ["node", "edge", "gz_node", "group", "roofline"])
def test_failing_stage_fails_main(on_cpu, one_rep, monkeypatch, capsys, where):
    """No stage's failure is swallowed: main() raises and prints no JSON."""
    if where == "group":
        target, name = bench, "run_group_tail"
    elif where == "roofline":
        target, name = bench, "run_roofline"
    else:
        run_histgrowth = bench.run_histgrowth

        def failing(gfa, count, devices):
            if count == ("node" if where == "gz_node" else where) and (
                gfa.endswith(".gz") == (where == "gz_node")
            ):
                raise RuntimeError(f"injected failure in {where}")
            return run_histgrowth(gfa, count, devices)

        monkeypatch.setattr(bench, "run_histgrowth", failing)
        target = None
    if target is not None:
        def fail(*a):
            raise RuntimeError(f"injected failure in {where}")

        monkeypatch.setattr(target, name, fail)
    with pytest.raises(RuntimeError, match=f"injected failure in {where}"):
        bench.main([])
    assert capsys.readouterr().out == ""


def test_main_prints_one_json_line_last(on_cpu, capsys):
    assert bench.main([]) == 0
    cap = capsys.readouterr()
    lines = cap.out.splitlines()
    assert len(lines) == 1
    out = json.loads(lines[-1])
    assert set(out) == KEYS
    assert out["metric"] == "histgrowth_all_throughput" and out["unit"] == "MB/s"
    assert out["value"] == out["stages"]["all"] > 0
    assert math.isclose(out["vs_baseline"], out["value"] / bench.BASELINE_ALL_MBPS)
    stages = {"all", "node", "edge", "gz_node"}
    assert set(out["stages"]) == set(out["stages_best"]) == set(out["stages_median"]) == stages
    assert set(out["routes"]) == stages
    # MB over the summed walls of every rep is at most the best rep's MB/s
    assert all(0 < out["stages"][k] <= out["stages_best"][k] for k in stages)
    assert all(0 < out["stages_median"][k] <= out["stages_best"][k] for k in stages)
    assert set(out["routes"].values()) == {"streamed"}
    assert out["host_mem_mbps"] > 0
    assert set(out["group_stages"]) == GROUP_KEYS and out["group_stages"]["verified"] is True
    assert all(out[k] is None for k in bench.DEVICE_FIELDS)
    assert out["device"] == "cpu"
    assert "[bench] roofline: left out on the CPU" in cap.err
    # every rep's wall: 6 for all, 4 for each other stage
    assert cap.err.count("[bench] histgrowth all pass ") == 6
    assert cap.err.count("[bench] histgrowth gz_node pass ") == 4


def test_entry_point_without_a_card_fails():
    """Without PANACUS_TORCH_DEVICE=cpu and without a CUDA device the
    program exits non-zero before it generates the graph, and prints no
    result; with the setting it prints its JSON line last."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    env = {k: v for k, v in os.environ.items() if k != "PANACUS_TORCH_DEVICE"}
    res = subprocess.run(
        [sys.executable, "-m", "panacus_torch.bench"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300,
    )
    assert res.returncode != 0
    assert res.stdout == ""
    assert "no CUDA device is available" in res.stderr


def test_entry_point_on_cpu(graphs):
    """`bench.main` in a fresh interpreter on the CPU: one JSON line, and no
    module of JAX or of the JAX package loaded."""
    gfa = graphs[SIZES[1]][0]
    script = (
        "import sys\nfrom panacus_torch import bench\n"
        "bench.GRAPH_DIR = sys.argv[1]\nrc = bench.main([])\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'panacus_tpu')]\n"
        "assert not bad, bad\nsys.exit(rc)\n"
    )
    env = dict(
        os.environ, PANACUS_TORCH_DEVICE="cpu",
        PANACUS_BENCH_NODES=str(SIZES[1][0]), PANACUS_BENCH_PATHS=str(SIZES[1][1]),
    )
    res = subprocess.run(
        [sys.executable, "-c", script, os.path.dirname(gfa)],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300,
    )
    assert res.returncode == 0, res.stderr[-4000:]
    out = json.loads(res.stdout.splitlines()[-1])
    assert set(out) == KEYS and out["group_stages"]["verified"] is True
    assert res.stdout.count("\n") == 1


@pytest.mark.parametrize(
    "name,peak",
    [
        ("NVIDIA H100 80GB HBM3", 3.35e12),
        ("NVIDIA H100 PCIe", 2.0e12),
        ("NVIDIA H100 80GB HBM3 MIG 1g.10gb", 3.35e12),
        ("NVIDIA H100", None),
        ("NVIDIA A100-SXM4-80GB", None),
        ("", None),
    ],
)
def test_hbm_peak(name, peak):
    assert runtime.hbm_peak_bytes_per_s(name) == peak


def test_host_memory_health_positive():
    assert bench._host_memory_health() > 0


# -- on the card ---------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (no CUDA device here)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_roofline_on_cuda(cuda_device):
    """K1 exact on the 1.07 GB M (run_roofline raises otherwise) and a
    reading no faster than the same run's raw read allows."""
    fields = bench.run_roofline(cuda_device)
    assert fields["device_frac_of_read"] <= 1.05
    assert fields["device_bw_gbps"] > 0 and fields["device_read_gbps"] > 0
    if runtime.hbm_peak_bytes_per_s(torch.cuda.get_device_name(cuda_device)):
        assert 0 < fields["device_bw_frac"] <= 1.0


@pytest.mark.cuda
def test_bench_on_cuda(cuda_device, graphs):
    """The whole program on the card at 3,000 nodes: streamed routes,
    verified group stages, the `all` hists equal to the CPU's."""
    gfa = graphs[SIZES[0]][0]
    out, hists = bench.run(gfa, (cuda_device,))
    assert set(out) == KEYS and out["group_stages"]["verified"] is True
    assert set(out["routes"].values()) == {"streamed"}
    assert out["device"]["count"] == torch.cuda.device_count()
    want = bench.run_histgrowth(gfa, "all", CPU)[0]
    assert {ct: h.coverage for ct, h in hists.items()} == {
        ct: h.coverage for ct, h in want.items()
    }
