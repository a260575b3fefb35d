"""The hist / growth / histgrowth slice: panacus_torch against panacus_tpu.

Each case runs one command line through panacus_tpu.cli.run_cli and
through panacus_torch.cli.run_cli on the CPU (PANACUS_TORCH_DEVICE=cpu);
stdout must be byte-equal apart from `#` comment lines. Two in-repo
graphs: __graft_entry__._write_dryrun_gfa (600 nodes, 8 paths, P and W
lines) and bench.make_graph cut to 3000 nodes (90 paths = 45 samples x 2
haplotypes). The cases cover -c node|bp|edge|all, grouping -H/-S/-g,
multiple thresholds, subset/exclude-masked runs (the classic itemizer
path) and growth on a hist TSV.
"""

from __future__ import annotations

import pytest

from panacus_torch.cli import run_cli as torch_cli

SUBSET = "s0#0#chr1\t3\t60\ns1#0#chr1\ns2#0#chr1\t10\t40\ns2#0#chr1\t50\t90\n"
EXCLUDE = "s1#0#chr1\t5\t9\n"
GROUPS = "s0#0#chr1\tA\ns1#0#chr1\tA\ns2#0#chr1\tB\n"


@pytest.fixture(scope="module")
def graphs(tmp_path_factory):
    import bench
    import __graft_entry__

    d = tmp_path_factory.mktemp("torch_slice")
    dry = d / "dryrun.gfa"
    __graft_entry__._write_dryrun_gfa(str(dry))
    synth = d / "bench.gfa"
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(bench, "N_NODES", 3000)
        bench.make_graph(str(synth))
    (d / "subset.bed").write_text(SUBSET)
    (d / "exclude.bed").write_text(EXCLUDE)
    (d / "groups.tsv").write_text(GROUPS)
    return d


CASES = [
    ["hist", "-c", "node"],
    ["hist", "-c", "bp"],
    ["hist", "-c", "edge"],
    ["hist", "-c", "all"],
    ["histgrowth", "-c", "all", "-H", "-q", "0,0.5,1", "-l", "0,1,2"],
    ["histgrowth", "-c", "edge", "-S", "-a"],
    ["growth", "-S", "-a", "-q", "0.5", "-l", "2"],
    ["histgrowth", "-c", "all", "-g", "{groups}"],
    ["hist", "-c", "all", "-s", "{subset}"],
    ["histgrowth", "-c", "bp", "-S", "-s", "{subset}", "-e", "{exclude}"],
]


def _body(out: str) -> str:
    return "".join(l for l in out.splitlines(True) if not l.startswith("#"))


def _run_both(capsys, monkeypatch, argv):
    from panacus_tpu.cli import run_cli as jax_cli

    monkeypatch.setenv("PANACUS_TORCH_DEVICE", "cpu")
    assert jax_cli(argv) == 0
    want = capsys.readouterr().out
    assert torch_cli(argv) == 0
    got = capsys.readouterr().out
    assert _body(want).count("\n") > 4
    assert _body(got) == _body(want)
    return got


@pytest.mark.parametrize("graph", ["dryrun", "bench"])
@pytest.mark.parametrize("case", CASES, ids=["_".join(c) for c in CASES])
def test_slice_matches_jax(capsys, monkeypatch, graphs, graph, case):
    pytest.importorskip("jax")
    argv = [
        a.format(
            subset=graphs / "subset.bed",
            exclude=graphs / "exclude.bed",
            groups=graphs / "groups.tsv",
        )
        for a in case
    ]
    _run_both(capsys, monkeypatch, argv + [str(graphs / f"{graph}.gfa")])


@pytest.mark.parametrize("graph", ["dryrun", "bench"])
def test_growth_from_hist_tsv_matches_jax(capsys, monkeypatch, graphs, graph, tmp_path):
    pytest.importorskip("jax")
    from panacus_tpu.cli import run_cli as jax_cli

    assert jax_cli(["hist", "-c", "all", "-S", str(graphs / f"{graph}.gfa")]) == 0
    tsv = tmp_path / "hist.tsv"
    tsv.write_text(capsys.readouterr().out)
    _run_both(
        capsys, monkeypatch, ["growth", "-a", "-q", "0,0.5,1", "-l", "0,1,2", str(tsv)]
    )


SUBCOMMANDS = {
    "render": ["render", "{json}"],
    "report": ["report", "--json", "{yaml}"],
    "hist": ["hist", "-c", "all", "{gfa}"],
    "growth": ["growth", "-S", "{gfa}"],
    "histgrowth": ["histgrowth", "-H", "{gfa}"],
    "info": ["info", "{gfa}"],
    "ordered-histgrowth": ["ordered-histgrowth", "-S", "{gfa}"],
    "table": ["table", "-S", "{gfa}"],
    "node-distribution": ["node-distribution", "{gfa}"],
    "similarity": ["similarity", "-H", "{gfa}"],
}


@pytest.mark.parametrize("command", sorted(SUBCOMMANDS))
def test_every_subcommand_runs(capsys, monkeypatch, graphs, tmp_path, command):
    """Every subcommand of panacus_tpu's parser runs through the port's CLI
    on the dryrun graph and exits 0 with output."""
    pytest.importorskip("jax")
    import argparse

    from panacus_tpu.cli import build_parser

    (sub,) = [
        a for a in build_parser()._actions if isinstance(a, argparse._SubParsersAction)
    ]
    assert sorted(sub.choices) == sorted(SUBCOMMANDS)
    monkeypatch.setenv("PANACUS_TORCH_DEVICE", "cpu")
    gfa = graphs / "dryrun.gfa"
    yaml = tmp_path / "r.yaml"
    yaml.write_text(f"- graph: {gfa}\n  analyses:\n    - !Info\n    - !Hist\n")
    report = tmp_path / "r.json"
    assert torch_cli(["report", "--json", str(yaml)]) == 0
    report.write_text(capsys.readouterr().out)
    argv = [a.format(gfa=gfa, yaml=yaml, json=report) for a in SUBCOMMANDS[command]]
    assert torch_cli(argv) == 0
    assert capsys.readouterr().out.count("\n") > 4


def test_default_device_never_falls_back(monkeypatch):
    import torch

    from panacus_torch.runtime import resolve_devices

    monkeypatch.delenv("PANACUS_TORCH_DEVICE", raising=False)
    if torch.cuda.is_available():
        assert resolve_devices() == tuple(
            torch.device("cuda", i) for i in range(torch.cuda.device_count())
        )
    else:
        with pytest.raises(RuntimeError):
            resolve_devices()
    monkeypatch.setenv("PANACUS_TORCH_DEVICE", "cpu")
    assert resolve_devices() == (torch.device("cpu"),)
    monkeypatch.setenv("PANACUS_TORCH_DEVICE", "tpu")
    with pytest.raises(ValueError):
        resolve_devices()


@pytest.mark.parametrize(
    "n,coverage,quorum",
    [(300, 1, 0.0), (300, 2, 1.0), (300, 1, 0.5), (2100, 1, 0.0), (2100, 2, 1.0)],
)
def test_growth_math_equals_jax_package(n, coverage, quorum):
    """The port's copy of the growth math gives panacus_tpu's floats: the
    per-m recurrences below GROWTH_MATMUL_MIN_N groups and the closed-form
    weight rows from there up (union and core)."""
    import numpy as np

    from panacus_torch.hist import Hist
    from panacus_torch.ops.growth_device import GROWTH_MATMUL_MIN_N
    from panacus_torch.utils import CountType, Threshold
    from panacus_tpu.hist import Hist as JaxHist
    from panacus_tpu.utils import CountType as JaxCountType
    from panacus_tpu.utils import Threshold as JaxThreshold

    assert (n >= GROWTH_MATMUL_MIN_N) == (n == 2100)
    cov = np.random.default_rng(n).integers(0, 1000, n + 1).tolist()
    got = Hist(CountType.NODE, cov).calc_growth(
        Threshold.absolute(coverage), Threshold.rel(quorum)
    )
    want = JaxHist(JaxCountType.NODE, cov).calc_growth(
        JaxThreshold.absolute(coverage), JaxThreshold.rel(quorum)
    )
    assert len(got) == n
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
