"""The port's CLI as two processes of a gloo group on the CPU: every
subcommand runs under torchrun's environment (WORLD_SIZE 2), rank 0 writes
what the one-process run writes and rank 1 writes nothing (the counterpart
of tests/test_multihost.py::test_two_process_cli_hist_matches_single).

One launch runs every command in one process per rank
(panacus_torch.parallel.launch's worker: one process group for all of
them), on tests/test_multihost.py's fixture. The references are the port's
run_cli in this one process on the CPU and, for `hist`, panacus_tpu's.
TSVs are compared apart from `#` lines, report JSON apart from the `#`
lines inside each section's table, HTML apart from its <footer> line, the
dry-run plan and the example YAML byte for byte.

The `cuda` case runs `histgrowth -c all` as two ranks on the card (two
ranks on one card under gloo; two cards or more under NCCL) against one
process on the card.
"""

import contextlib
import io
import json
import os
import re
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)


def _body(out):
    return "".join(l for l in out.splitlines(True) if not l.startswith("#"))


def _json_body(out):
    sections = json.loads(out)
    for s in sections:
        if s.get("table") is not None:
            s["table"] = "\n".join(
                l for l in s["table"].split("\n") if not l.lstrip("`").startswith("#")
            )
    return sections


def _html_body(out):
    """The HTML without its <footer> line and with the text of the `#`
    lines its tables embed (the `# argv` line names each process's own
    command line)."""
    lines = out.splitlines(True)
    assert sum(l.startswith("<footer>") for l in lines) == 1
    return re.sub(r"# [^\n]*", "#", "".join(l for l in lines if not l.startswith("<footer>")))


def _one_process(argv):
    """The port's stdout of one command in this process, on the CPU."""
    from panacus_torch.cli import run_cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert run_cli(argv, devices=("cpu",)) == 0
    return buf.getvalue()


def _launch(tmp, commands, n_ranks=2, env=None):
    from panacus_torch.parallel.launch import launch

    spec = tmp / "commands.json"
    spec.write_text(json.dumps(commands))
    report = str(tmp / "ranks")
    launch(
        [sys.executable, "-m", "panacus_torch.parallel.launch", report, str(spec)],
        n_ranks,
        env=env or dict(os.environ, PANACUS_TORCH_DEVICE="cpu"),
        cwd=REPO,
        timeout=400,
    )
    return [json.load(open(f"{report}.{r}.json")) for r in range(n_ranks)]


@pytest.fixture(scope="module")
def cli(tmp_path_factory):
    from test_multihost import N_SAMPLES, _write_fixture

    tmp = tmp_path_factory.mktemp("mhcli")
    gfa = str(tmp / "mh.gfa")
    _write_fixture(gfa)
    sub = tmp / "sub.bed"
    sub.write_text("".join(f"s{p}#0#chr1\t5\t{200 + 7 * p}\n" for p in range(0, N_SAMPLES, 3)))
    exc = tmp / "exc.bed"
    exc.write_text("".join(f"s{p}#0#chr1\t0\t{90 + 13 * p}\n" for p in range(1, N_SAMPLES, 5)))
    yaml = tmp / "report.yaml"
    yaml.write_text(
        f"- graph: {gfa}\n  grouping: Sample\n  analyses:\n"
        "    - !Info\n    - !Hist\n      count_type: All\n"
        "    - !Growth\n      coverage: 1,1,2\n      quorum: 0,0.5,1\n"
        "    - !CoverageLine\n      count_type: Node\n    - !NodeDistribution\n"
        "    - !OrderedGrowth\n      count_type: Edge\n      coverage: 1,2\n      quorum: 0,0.5\n"
        f"- graph: {gfa}\n  name: sim\n  grouping: Sample\n  subset: {sub}\n  analyses:\n"
        "    - !Hist\n      count_type: Bp\n    - !Similarity\n      count_type: Node\n"
    )
    hist_tsv = tmp / "hist.tsv"
    hist_tsv.write_text(_one_process(["hist", "-c", "all", "-S", gfa]))
    report_json = tmp / "report.json"
    report_json.write_text(_one_process(["report", "--json", str(yaml)]))
    commands = {
        "hist": ["hist", "-S", "-c", "node", gfa],
        "histgrowth": ["histgrowth", "-c", "all", "-S", "-q", "0,0.5,1.0", "-l", "0,1,2", gfa],
        "growth": ["growth", "-a", "-S", "-q", "0,1", "-l", "1,2", gfa],
        "growth_tsv": ["growth", "-q", "0,0.5", "-l", "1,2", str(hist_tsv)],
        "info": ["info", "-S", gfa],
        "ordered": ["ordered-histgrowth", "-c", "edge", "-S", "-q", "0,0.5,1", "-l", "1,1,2", gfa],
        "similarity": ["similarity", "-c", "node", "-S", gfa],
        "table": ["table", "-c", "node", "-S", gfa],
        "node_distribution": ["node-distribution", gfa],
        "subset": ["histgrowth", "-c", "all", "-S", "-s", str(sub), gfa],
        "exclude": ["hist", "-c", "all", "-S", "-e", str(exc), gfa],
        "report_json": ["report", "--json", str(yaml)],
        "report_html": ["report", str(yaml)],
        "render": ["render", str(report_json)],
        "dry_run": ["report", "--dry-run", str(yaml)],
        "example": ["report"],
    }
    names = list(commands)
    ranks = _launch(tmp, [commands[n] for n in names])
    outs = [dict(zip(names, r["commands"])) for r in ranks]
    return ranks, outs, commands


def test_two_process_cli_hist_matches_single(cli):
    """`hist -S` under two processes: rank 0's TSV equals one process's,
    panacus_tpu's and the port's."""
    from panacus_tpu.cli import run_cli as jax_cli

    ranks, outs, commands = cli
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert jax_cli(commands["hist"]) == 0
    got = _body(outs[0]["hist"]["out"])
    assert got == _body(buf.getvalue()) == _body(_one_process(commands["hist"]))
    assert "\t" in got and outs[1]["hist"]["out"] == ""
    assert [r["world_size"] for r in ranks] == [2, 2]
    assert [r["backend"] for r in ranks] == ["gloo", "gloo"]
    assert [r["rank"] for r in ranks] == [0, 1]


@pytest.mark.parametrize(
    "name",
    ["histgrowth", "growth", "growth_tsv", "info", "ordered", "similarity", "table",
     "node_distribution", "subset", "exclude"],
)
def test_two_process_cli_tables_match_single(cli, name):
    ranks, outs, commands = cli
    got, silent = outs[0][name]["out"], outs[1][name]["out"]
    assert silent == ""
    assert _body(got) == _body(_one_process(commands[name]))
    assert got.count("\n") > 3


def test_two_process_cli_builds_path_sliced(cli):
    """Every graph command that builds abaci built them path-sliced: the
    ranks' tokenized payloads add up to the whole, each a real share where
    every path is in a group (rank 0 also walks the paths a subset leaves
    out, for their lengths)."""
    ranks, outs, commands = cli
    for name in ("hist", "histgrowth", "ordered", "similarity", "table", "subset", "exclude"):
        p0, p1 = outs[0][name]["payload"], outs[1][name]["payload"]
        assert p0[1] == p1[1] > 0 and p0[0] + p1[0] == p0[1], name
        if name != "subset":
            assert 0.3 < p0[0] / p0[1] < 0.7, name


def test_two_process_report_and_render_match_single(cli):
    ranks, outs, commands = cli
    for name in ("report_json", "report_html", "render", "dry_run", "example"):
        assert outs[1][name]["out"] == "", name
    one = {n: _one_process(commands[n]) for n in ("report_json", "report_html", "render",
                                                  "dry_run", "example")}
    assert _json_body(outs[0]["report_json"]["out"]) == _json_body(one["report_json"])
    assert _html_body(outs[0]["report_html"]["out"]) == _html_body(one["report_html"])
    assert _html_body(outs[0]["render"]["out"]) == _html_body(one["render"])
    assert outs[0]["dry_run"]["out"] == one["dry_run"]
    assert outs[0]["example"]["out"] == one["example"]
    assert outs[0]["report_html"]["out"].count('<section class="card"') > 5


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (no CUDA device here)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_two_ranks_on_the_card_equal_one_process(cuda_device, tmp_path):
    """Two ranks on the card (sharing it under gloo, or their own cards
    under NCCL) against one process on the card: the same TSV, rank 1
    silent, every rank's pt_fused_hist launched on its CUDA shards."""
    import torch

    from test_multihost import _write_fixture

    gfa = str(tmp_path / "mh.gfa")
    _write_fixture(gfa)
    argv = ["histgrowth", "-c", "all", "-S", "-q", "0,0.5,1.0", "-l", "0,1,2", gfa]
    from panacus_torch.cli import run_cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert run_cli(argv, devices=(cuda_device,)) == 0
    env = dict(os.environ, PANACUS_TORCH_DEVICE="cuda")
    ranks = _launch(tmp_path, [argv], env=env)
    want = "nccl" if torch.cuda.device_count() >= 2 else "gloo"
    assert [r["backend"] for r in ranks] == [want, want]
    assert all(d.startswith("cuda") for r in ranks for d in r["devices"])
    assert _body(ranks[0]["commands"][0]["out"]) == _body(buf.getvalue())
    assert ranks[1]["commands"][0]["out"] == ""
    for r in ranks:
        assert r["commands"][0]["launches"]["pt_fused_hist"] >= 2 * len(r["devices"])
