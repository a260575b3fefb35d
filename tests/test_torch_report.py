"""The report slice (info, node-distribution, report, render) and the Python
API: panacus_torch against panacus_tpu.

Each case runs one command line through panacus_tpu.cli.run_cli and through
panacus_torch.cli.run_cli on the CPU (PANACUS_TORCH_DEVICE=cpu) and
compares the two outputs under the parity rules of the port:

- TSV: byte-equal apart from `#` comment lines;
- JSON (`report --json`): equal structures after json.loads, floats
  included, apart from the `#` lines inside each section's `table` string;
- HTML (`report`, `render`): byte-equal apart from the <footer> line (time,
  version and the package that wrote it);
- `report --dry-run` and `report` without a YAML: byte-equal.

The graphs, BED files and group file are those of tests/test_torch_slice.py
(its `graphs` fixture: the 600-node dryrun graph and make_graph cut to 3000
nodes). The group file leaves most paths in no group, which the streamed
build gives a trailing slab that sets no bit. The tests marked `cuda` run
info, node-distribution and a small report on the card against the port's
CPU run.
"""

from __future__ import annotations

import json

import numpy as np
import pytest

from panacus_torch.cli import run_cli as torch_cli
from test_torch_slice import graphs  # noqa: F401 (fixture)

KINDS = {
    "hist": "    - !Hist\n      count_type: All\n",
    "growth": "    - !Growth\n      coverage: 1,2\n      quorum: 0,0.5\n",
    "info": "    - !Info\n",
    "node_distribution": "    - !NodeDistribution\n      radius: 10\n",
    "coverage_line": "    - !CoverageLine\n      count_type: Bp\n      reference: x\n",
    "ordered_growth": (
        "    - !OrderedGrowth\n      count_type: Edge\n      coverage: 1,2\n"
        "      quorum: 0,1\n"
    ),
    "similarity": "    - !Similarity\n      count_type: Node\n      cluster_method: average\n",
    "table": "    - !Table\n      total: true\n",
}
CUSTOM = {
    "png": b"\x89PNG\r\n\x1a\n\x00\x00\x00\rIHDR\x00\x00\x00\x01",
    "svg": b'<svg xmlns="http://www.w3.org/2000/svg"><circle r="4"/></svg>',
    "pdf": b"%PDF-1.4\n%\xe2\xe3\xcf\xd3\n",
    "json": b'{"a": [1, 2.5, "x"]}',
    "csv": b"name,value\nA,1\nB,2\n",
    "tsv": b"name\tvalue\nA\t1\n\nB\t2\n",
}


def _yaml(runs) -> str:
    """runs: [(graph, header lines, analyses text)]."""
    out = []
    for graph, header, analyses in runs:
        out.append(f"- graph: {graph}\n{header}  analyses:\n{analyses}")
    return "".join(out)


def _two_runs(d, graph: str) -> str:
    """The two-run YAML of chip_smoke.py's phase 6 on `graph`. Similarity
    (node) runs in the second run: one run holds one group count type, and
    the first has ordered growth on edges."""
    g = d / f"{graph}.gfa"
    run1 = (
        "    - !Info\n    - !Hist\n      count_type: All\n"
        "    - !Growth\n      coverage: 1,1,2\n      quorum: 0,0.5,1\n"
        "    - !CoverageLine\n      count_type: Node\n"
        "    - !NodeDistribution\n"
        "    - !OrderedGrowth\n      count_type: Edge\n      coverage: 1,1,2\n"
        "      quorum: 0,0.5,1\n"
    )
    run2 = (
        "    - !Hist\n      count_type: Bp\n"
        "    - !Growth\n      coverage: 1\n      quorum: 0.5\n"
        "    - !Similarity\n      count_type: Node\n"
    )
    return _yaml(
        [
            (g, "  grouping: Haplotype\n", run1),
            (g, "  name: by sample\n  grouping: Sample\n", run2),
        ]
    )


def _two_graphs(d) -> str:
    """Two graphs in one report: a subset-masked run on the dryrun graph with
    a custom grouping (the classic itemizer), then the bench graph."""
    return _yaml(
        [
            (
                d / "dryrun.gfa",
                f"  name: masked\n  subset: {d / 'subset.bed'}\n"
                f"  grouping: {d / 'groups.tsv'}\n",
                KINDS["info"] + KINDS["hist"] + KINDS["node_distribution"],
            ),
            (
                d / "bench.gfa",
                "  grouping: Sample\n",
                KINDS["info"] + KINDS["ordered_growth"] + KINDS["coverage_line"],
            ),
        ]
    )


def _tsv_body(out: str) -> str:
    return "".join(l for l in out.splitlines(True) if not l.startswith("#"))


def _mask_table(table):
    if table is None:
        return None
    return "\n".join(
        l for l in table.split("\n") if not l.lstrip("`").startswith("#")
    )


def _json_body(out: str):
    def no_const(x):
        raise AssertionError(f"non-finite constant {x} in report JSON")

    sections = json.loads(out, parse_constant=no_const)
    for s in sections:
        s["table"] = _mask_table(s["table"])
    return sections


def _html_body(out: str) -> str:
    lines = out.splitlines(True)
    footers = [l for l in lines if l.startswith("<footer>")]
    assert len(footers) == 1, footers
    return "".join(l for l in lines if not l.startswith("<footer>"))


def _run_both(capsys, monkeypatch, argv):
    """(panacus_tpu's stdout, panacus_torch's stdout) of one command line."""
    from panacus_tpu.cli import run_cli as jax_cli

    monkeypatch.setenv("PANACUS_TORCH_DEVICE", "cpu")
    assert jax_cli(argv) == 0
    want = capsys.readouterr().out
    assert torch_cli(argv) == 0
    got = capsys.readouterr().out
    return want, got


def _report_json(capsys, monkeypatch, yaml_path):
    want, got = _run_both(capsys, monkeypatch, ["report", "--json", str(yaml_path)])
    assert _json_body(got) == _json_body(want)
    return want, got


INFO_CASES = [
    ["info", "-H"],
    ["info", "-S"],
    ["info", "-H", "-s", "{subset}"],
    ["info", "-g", "{groups}"],
    ["info", "-S", "-s", "{subset}", "-e", "{exclude}"],
    ["node-distribution"],
    ["node-distribution", "-r", "5"],
]


@pytest.mark.parametrize("graph", ["dryrun", "bench"])
@pytest.mark.parametrize("case", INFO_CASES, ids=["_".join(c) for c in INFO_CASES])
def test_tables_match_jax(capsys, monkeypatch, graphs, graph, case):  # noqa: F811
    pytest.importorskip("jax")
    argv = [
        a.format(
            subset=graphs / "subset.bed",
            exclude=graphs / "exclude.bed",
            groups=graphs / "groups.tsv",
        )
        for a in case
    ]
    want, got = _run_both(capsys, monkeypatch, argv + [str(graphs / f"{graph}.gfa")])
    assert _tsv_body(want).count("\n") > 4
    assert _tsv_body(got) == _tsv_body(want)


@pytest.mark.parametrize("graph", ["dryrun", "bench"])
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_report_json_of_each_kind_matches_jax(
    capsys, monkeypatch, graphs, tmp_path, graph, kind  # noqa: F811
):
    pytest.importorskip("jax")
    cfg = tmp_path / "k.yaml"
    cfg.write_text(
        _yaml([(graphs / f"{graph}.gfa", "  grouping: Sample\n", KINDS[kind])])
    )
    _, got = _report_json(capsys, monkeypatch, cfg)
    sections = json.loads(got)
    # Table adds no section (reference table.rs:51-56); every other kind does
    assert (sections == []) == (kind == "table")


@pytest.mark.parametrize("ext", sorted(CUSTOM))
def test_report_json_custom_section_matches_jax(
    capsys, monkeypatch, graphs, tmp_path, ext  # noqa: F811
):
    pytest.importorskip("jax")
    f = tmp_path / f"figure.{ext}"
    f.write_bytes(CUSTOM[ext])
    cfg = tmp_path / "c.yaml"
    cfg.write_text(
        _yaml(
            [
                (
                    graphs / "dryrun.gfa",
                    "",
                    KINDS["hist"] + f"    - !Custom\n      name: My {ext}\n"
                    f"      file: {f}\n",
                )
            ]
        )
    )
    _, got = _report_json(capsys, monkeypatch, cfg)
    custom = [s for s in json.loads(got) if s["analysis"] == "Custom"]
    assert len(custom) == 1 and custom[0]["id"] == f"custom-my-{ext}"


@pytest.mark.parametrize("which", ["two_runs_dryrun", "two_runs_bench", "two_graphs"])
def test_report_json_of_several_runs_matches_jax(
    capsys, monkeypatch, graphs, tmp_path, which  # noqa: F811
):
    pytest.importorskip("jax")
    cfg = tmp_path / "m.yaml"
    if which == "two_graphs":
        cfg.write_text(_two_graphs(graphs))
    else:
        cfg.write_text(_two_runs(graphs, which.rsplit("_", 1)[1]))
    _, got = _report_json(capsys, monkeypatch, cfg)
    assert len({s["run_name"] for s in json.loads(got)}) == 2


@pytest.mark.parametrize("graph", ["dryrun", "bench"])
def test_report_json_after_a_partial_order_matches_jax(
    capsys, monkeypatch, graphs, tmp_path, graph  # noqa: F811
):
    """An ordered growth whose order names only some samples rebuilds the
    abaci over those; the analyses sorted after it (CoverageLine) read that
    state, those before it (Info, NodeDistribution) the full one."""
    pytest.importorskip("jax")
    order = tmp_path / "order.txt"
    order.write_text("s3\ns1\n")
    cfg = tmp_path / "o.yaml"
    cfg.write_text(
        _yaml(
            [
                (
                    graphs / f"{graph}.gfa",
                    "  grouping: Sample\n",
                    "    - !CoverageLine\n      count_type: Edge\n"
                    "    - !OrderedGrowth\n      count_type: Edge\n"
                    f"      order: {order}\n"
                    + KINDS["node_distribution"] + KINDS["info"],
                )
            ]
        )
    )
    _, got = _report_json(capsys, monkeypatch, cfg)
    lines = [s for s in json.loads(got) if s["analysis"] == "Coverage Line"]
    assert len(lines) == 3  # node, bp and edge: Info needs every count type
    for s in lines:
        assert len(s["items"][0]["Line"]["x_values"]) <= 2  # two samples


@pytest.mark.parametrize("graph", ["dryrun", "bench"])
def test_report_html_matches_jax(capsys, monkeypatch, graphs, tmp_path, graph):  # noqa: F811
    pytest.importorskip("jax")
    cfg = tmp_path / "h.yaml"
    cfg.write_text(_two_runs(graphs, graph))
    want, got = _run_both(capsys, monkeypatch, ["report", str(cfg)])
    assert got.startswith("<!DOCTYPE html>") and "<h1>panacus-tpu</h1>" in got
    assert "generated by panacus_torch v" in got
    assert "http://" not in got.replace("http://www.w3.org/2000/svg", "")
    assert "https://" not in got
    assert _html_body(got) == _html_body(want)


def test_render_matches_jax(capsys, monkeypatch, graphs, tmp_path):  # noqa: F811
    """render of one and of two JSON files; each package renders its own
    report and the other package's."""
    pytest.importorskip("jax")
    cfg1, cfg2 = tmp_path / "a.yaml", tmp_path / "b.yaml"
    cfg1.write_text(_two_runs(graphs, "dryrun"))
    cfg2.write_text(_two_graphs(graphs))
    jax_json, torch_json = {}, {}
    for cfg in (cfg1, cfg2):
        want, got = _report_json(capsys, monkeypatch, cfg)
        jax_json[cfg] = tmp_path / f"{cfg.stem}.jax.json"
        torch_json[cfg] = tmp_path / f"{cfg.stem}.torch.json"
        jax_json[cfg].write_text(want)
        torch_json[cfg].write_text(got)
    for files in (
        [torch_json[cfg1]],
        [jax_json[cfg1]],
        [torch_json[cfg1], jax_json[cfg2]],
        [jax_json[cfg2], torch_json[cfg1]],
    ):
        want, got = _run_both(capsys, monkeypatch, ["render"] + [str(f) for f in files])
        assert _html_body(got) == _html_body(want)
        assert got.count('<section class="card"') > 5


def test_report_dry_run_and_example_are_byte_equal(capsys, monkeypatch, graphs, tmp_path):  # noqa: F811
    pytest.importorskip("jax")
    cfg = tmp_path / "d.yaml"
    f = tmp_path / "figure.svg"
    f.write_bytes(CUSTOM["svg"])
    cfg.write_text(
        _two_runs(graphs, "dryrun")
        + _two_graphs(graphs)
        + _yaml(
            [
                (
                    graphs / "dryrun.gfa",
                    "  exclude: {}\n".format(graphs / "exclude.bed"),
                    KINDS["table"] + f"    - !Custom\n      name: fig\n      file: {f}\n",
                )
            ]
        )
    )
    want, got = _run_both(capsys, monkeypatch, ["report", "--dry-run", str(cfg)])
    assert got == want and got.count("GraphStateChange(") == 5
    assert "OrderChange(None)" in got and 'CustomSection("fig"' in got
    want, got = _run_both(capsys, monkeypatch, ["report"])
    assert got == want and "# Missing YAML file!" in got


def test_report_json_is_strict(capsys, monkeypatch, graphs, tmp_path):  # noqa: F811
    """No bare NaN or Infinity anywhere in the port's report JSON (the rule
    of tests/test_yaml_analyses.py), over every analysis kind that adds a
    section."""
    monkeypatch.setenv("PANACUS_TORCH_DEVICE", "cpu")
    cfg = tmp_path / "s.yaml"
    cfg.write_text(_two_runs(graphs, "dryrun") + _two_graphs(graphs))
    assert torch_cli(["report", "--json", str(cfg)]) == 0
    sections = _json_body(capsys.readouterr().out)
    assert {s["analysis"] for s in sections} >= {
        "Pangenome Info", "Node distribution", "Coverage Line"
    }
    ordered = [s for s in sections if s["analysis"].startswith("Ordered")]
    assert len(ordered) == 2
    for s in ordered:
        # the sentinel slot is zeroed, not NaN
        assert all(v[0] == 0.0 for v in s["items"][0]["MultiBar"]["values"])


@pytest.mark.parametrize(
    "graph,grouping,subset",
    [("dryrun", "sample", False), ("bench", "haplotype", False), ("dryrun", "groups", True)],
)
def test_api_matches_jax(graphs, tmp_path, graph, grouping, subset):  # noqa: F811
    pytest.importorskip("jax")
    import torch

    import panacus_tpu.api as jpt
    import panacus_torch.api as tpt

    gfa = str(graphs / f"{graph}.gfa")
    g = str(graphs / "groups.tsv") if grouping == "groups" else grouping
    s = str(graphs / "subset.bed") if subset else ""
    want = jpt.Pangenome(gfa, grouping=g, subset=s)
    got = tpt.Pangenome(gfa, grouping=g, subset=s, device=torch.device("cpu"))
    assert got.broker.devices == (torch.device("cpu"),)
    assert got.groups == want.groups
    for count in ("node", "bp", "edge"):
        np.testing.assert_array_equal(got.histogram(count), want.histogram(count))
        np.testing.assert_array_equal(
            got.coverage_vector(count), want.coverage_vector(count)
        )
        np.testing.assert_array_equal(
            got.growth(count, "1,2", "0,0.5"), want.growth(count, "1,2", "0,0.5")
        )
    assert got.info() == want.info()
    og, ol = got.ordered_growth("edge", "1,1", "0,1")
    wg, wl = want.ordered_growth("edge", "1,1", "0,1")
    np.testing.assert_array_equal(og, wg)
    assert ol == wl
    sim, labels = got.similarity("edge", "single")
    wsim, wlabels = want.similarity("edge", "single")
    np.testing.assert_array_equal(sim, wsim)
    assert labels == wlabels
    # an order naming every second group leaves the others' paths in no
    # group; info still reports every path (on the streamed build, from its
    # trailing slab that sets no bit)
    n_paths = want.info()["paths"]["no_paths"]
    order = tmp_path / "order.txt"
    order.write_text("".join(f"{name}\n" for name in want.groups[::-2]))
    og, ol = got.ordered_growth("edge", "1,2", "0,0.5", order=str(order))
    wg, wl = want.ordered_growth("edge", "1,2", "0,0.5", order=str(order))
    np.testing.assert_array_equal(og, wg)
    assert ol == wl and got.groups == want.groups == wl
    assert got.info() == want.info()
    assert got.info()["paths"]["no_paths"] == n_paths


def test_api_default_device_is_the_card(graphs, monkeypatch):  # noqa: F811
    """Without a device the API takes runtime.resolve_devices': every
    visible card, or a raise where there is none; never a silent CPU."""
    import torch

    import panacus_torch.api as tpt

    monkeypatch.delenv("PANACUS_TORCH_DEVICE", raising=False)
    gfa = str(graphs / "dryrun.gfa")
    if torch.cuda.is_available():
        devices = tpt.Pangenome(gfa).broker.devices
        assert devices == tuple(torch.device("cuda", i) for i in range(torch.cuda.device_count()))
    else:
        with pytest.raises(RuntimeError):
            tpt.Pangenome(gfa)
    monkeypatch.setenv("PANACUS_TORCH_DEVICE", "cpu")
    assert tpt.Pangenome(gfa).broker.devices == (torch.device("cpu"),)


def test_report_frees_the_previous_runs_abaci(graphs, monkeypatch):  # noqa: F811
    """Each graph state builds its own abaci: when the second run builds, no
    abacus of the first is alive (none is kept by the broker or a cached
    analysis)."""
    import gc
    import io
    import weakref

    import torch

    from panacus_torch import broker as broker_mod
    from panacus_torch.config import load_config
    from panacus_torch.pipeline import convert_to_tasks, execute_pipeline

    built = []
    alive_at_build = []
    real = broker_mod.streamed_total_abaci

    def spy(*args, **kwargs):
        gc.collect()
        alive_at_build.append(sum(r() is not None for r in built))
        res = real(*args, **kwargs)
        if res is not None:
            built.extend(weakref.ref(ab.engine) for ab in res[0].values())
        return res

    monkeypatch.setattr(broker_mod, "streamed_total_abaci", spy)
    tasks = convert_to_tasks(load_config(_two_runs(graphs, "dryrun")))
    out = io.StringIO()
    execute_pipeline(tasks, out, torch.device("cpu"), json=True)
    # run 1 builds twice (its order change), run 2 once
    assert len(alive_at_build) == 3
    assert alive_at_build == [0, 0, 0]
    assert len(json.loads(out.getvalue())) > 5


# -- on the card ---------------------------------------------------------------


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (no CUDA device here)")
    return torch.device("cuda")


def _port_outputs(capsys, monkeypatch, argv):
    outs = {}
    for device in ("cpu", "cuda"):
        monkeypatch.setenv("PANACUS_TORCH_DEVICE", device)
        assert torch_cli(argv) == 0
        outs[device] = capsys.readouterr().out
    return outs["cpu"], outs["cuda"]


@pytest.mark.cuda
@pytest.mark.parametrize("graph", ["dryrun", "bench"])
def test_report_slice_on_cuda_matches_cpu(
    cuda_device, capsys, monkeypatch, graphs, tmp_path, graph  # noqa: F811
):
    from panacus_torch.ops import kernels

    gfa = str(graphs / f"{graph}.gfa")
    for argv in (["info", "-H", gfa], ["info", "-S", "-s", str(graphs / "subset.bed"), gfa]):
        cpu, cuda = _port_outputs(capsys, monkeypatch, argv)
        assert _tsv_body(cuda) == _tsv_body(cpu)
    kernels.reset_launches()
    cpu, cuda = _port_outputs(capsys, monkeypatch, ["node-distribution", gfa])
    assert _tsv_body(cuda) == _tsv_body(cpu)
    assert kernels.launches["pt_coverage"] >= 1
    cfg = tmp_path / "r.yaml"
    cfg.write_text(_two_runs(graphs, graph))
    kernels.reset_launches()
    cpu, cuda = _port_outputs(capsys, monkeypatch, ["report", "--json", str(cfg)])
    assert _json_body(cuda) == _json_body(cpu)
    assert kernels.launches["pt_fused_hist"] >= 1
    assert kernels.launches["pt_ordered_growth"] >= 3
    assert kernels.launches["pt_similarity"] >= 1
