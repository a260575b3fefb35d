"""The reference module's `inputs` hook: files other than the GFA that a
cell's argv names (a report's YAML), written into the run's own directory
and filled into the argv's placeholders; a placeholder left unfilled, or a
hook given no directory, raises before any command runs; the accepted
cells' argv is as before; and a `report --json {config}` cell added through
new files only."""

import json
import os
import shutil
import subprocess
import sys
import time
import types

import pytest
import torch
from conftest import ROOT, small_cell
from test_benchmark_harness import _patch_hist

from benchmark import generate, harness, readings

CPU = (torch.device("cpu"),)
SEED = 2**31 + 404
TOY = "toyreport"
FEW_HAPS = [{"sample_prefix": "HG", "samples": 4, "haps": [1, 2], "seqid": "chr22"}]
REPORT_TRAFFIC = {
    "argv": ["report", "--json", "{config}"],
    "reference": TOY,
    "grouping": "Haplotype",
    "analyses": [{"Hist": {"count_type": "Node"}},
                 {"Growth": {"coverage": "1,2", "quorum": "0,0"}}],
}
LIMITS = {"errors": 0, "bins_off": 0, "sections_off": 0}
ACCEPTED = [w["name"] for w in json.load(open(os.path.join(ROOT, "BENCHMARK.json")))["workloads"]]

TOY_REPORT = '''
"""A toy reference of `report --json CONFIG`: the YAML made from the traffic
file's own keys, and the JSON's node coverage hist against the plain
counts."""
import json
import os

from .counts import coverage, hist
from .gfa import read_gfa

COMBINE = {"bins_off": "sum", "sections_off": "sum"}


def inputs(traffic, gfa, facts, work):
    lines = [f"- graph: {gfa}", f"  grouping: {traffic['grouping']}", "  analyses:"]
    for a in traffic["analyses"]:
        (tag, params), = a.items()
        lines += [f"    - !{tag}"] + [f"      {k}: {v}" for k, v in params.items()]
    path = os.path.join(work, "report.yaml")
    with open(path, "w") as f:
        f.write("\\n".join(lines) + "\\n")
    return {"config": path}


def parse_command(argv):
    if argv[:2] != ["report", "--json"] or len(argv) != 3:
        raise ValueError("the toy reference takes report --json CONFIG only")
    with open(argv[2]) as f:
        return f.readline().split(": ", 1)[1].strip()  # "- graph: PATH"


def shape(argv, facts):
    return {"counts": ("node",), "n_groups": len(facts["haplotypes"]), "n_nodes": facts["n_nodes"],
            "n_edges": facts["n_edges"]}


def reference_tables(argv, dtype=None):
    g = read_gfa(parse_command(argv))
    groups = g.groups("haplotype")
    return [int(x) for x in hist(coverage(g, groups, "node"), None, len(groups))]


def write_tsv(want):
    return json.dumps([{"analysis": "Coverage Histogram", "countable": "node",
                        "items": [{"Bar": {"values": [float(x) for x in want]}}]}])


def compare(text, want):
    hists = [s for s in json.loads(text)
             if s["analysis"] == "Coverage Histogram" and s.get("countable") == "node"]
    if len(hists) != 1:
        return {"bins_off": 0, "sections_off": 1}
    got = hists[0]["items"][0]["Bar"]["values"]
    off = sum(a != b for a, b in zip(got, want)) + abs(len(got) - len(want))
    return {"bins_off": off, "sections_off": 0}


def controls(argv, want):
    return {"shifted": write_tsv([0] + want[:-1])}
'''


@pytest.fixture
def toy(monkeypatch):
    """TOY_REPORT as benchmark.reference.toyreport, for the tree's harness."""
    mod = types.ModuleType(f"benchmark.reference.{TOY}")
    mod.__package__ = "benchmark.reference"
    exec(compile(TOY_REPORT, f"{TOY}.py", "exec"), mod.__dict__)
    monkeypatch.setitem(sys.modules, mod.__name__, mod)
    return mod


def _report_cell(tmp_path, argv=None):
    cell = small_cell(tmp_path, "pggb-chr22.hg-node", n_nodes=600, haplotypes=FEW_HAPS)
    cell.name = "pggb-chr22.toy-report"
    cell.traffic = dict(REPORT_TRAFFIC, argv=argv or REPORT_TRAFFIC["argv"])
    cell.limits = lambda: dict(LIMITS)
    return cell


def _no_commands(monkeypatch):
    from panacus_torch import cli

    def refuse(*a, **k):
        raise AssertionError("a command ran")

    monkeypatch.setattr(cli, "run_cli", refuse)


@pytest.mark.parametrize("module", ["tables", TOY])
def test_an_unfilled_placeholder_raises_before_any_command(tmp_path, monkeypatch, toy, module):
    """A misspelt placeholder, in a cell whose module has the hook and in one
    whose module has none, fails the run before its warm-up."""
    cell = _report_cell(tmp_path, ["report", "--json", "{confg}"])
    if module == "tables":
        cell = small_cell(tmp_path, "pggb-chr22.hg-node", n_nodes=600)
        cell.traffic = dict(cell.traffic, argv=cell.traffic["argv"][:-1] + ["{confg}"])
    _no_commands(monkeypatch)
    with pytest.raises(ValueError, match=r"unfilled: \{confg\}"):
        harness.run_cell(cell, SEED, 0.1, False, CPU, time.perf_counter(),
                         graph_dir=str(tmp_path / "graphs"))


def test_a_hook_with_no_work_raises(tmp_path, toy):
    with pytest.raises(ValueError, match="no work directory"):
        harness.prepare_inputs(_report_cell(tmp_path), SEED, str(tmp_path / "graphs"))


@pytest.mark.parametrize("made", ["outside", "gfa"])
def test_a_hook_file_outside_work_raises(tmp_path, monkeypatch, toy, made):
    """A hook's file has to lie in the run's directory, so that it goes with
    it; the graph is the harness's to fill in."""
    def inputs(traffic, gfa, facts, work):
        if made == "gfa":
            return {"gfa": os.path.join(work, "other.gfa")}
        return {"config": str(tmp_path / "graphs" / "report.yaml")}

    monkeypatch.setattr(toy, "inputs", inputs)
    work = tmp_path / "work"
    work.mkdir()
    with pytest.raises(ValueError, match="is not a file in"):
        harness.prepare_inputs(_report_cell(tmp_path), SEED, str(tmp_path / "graphs"), str(work))


@pytest.mark.parametrize("with_work", [False, True])
@pytest.mark.parametrize("name", ACCEPTED)
def test_accepted_cells_argv_as_before(tmp_path, name, with_work):
    """The argv is the traffic file's with only {gfa} replaced, as the
    parent's prepare_inputs made it, with or without a work directory."""
    cell = small_cell(tmp_path, name)
    assert not hasattr(cell.reference, "inputs")
    work = tmp_path / "work"
    work.mkdir()
    inputs = harness.prepare_inputs(cell, SEED, str(tmp_path / "graphs"),
                                    str(work) if with_work else None)
    gfa = generate.graph_path(cell.config_path, SEED, str(tmp_path / "graphs"))
    assert inputs.argv == [gfa if a == "{gfa}" else a for a in cell.traffic["argv"]]
    assert os.listdir(work) == []


def test_report_cell_correct_and_its_files_gone(tmp_path, monkeypatch, toy):
    """The toy report cell runs correct on the CPU; the YAML the hook wrote
    names the graph and lasts through the comparison, and is gone once
    run_cell returns; the graph directory holds only what generate.py
    writes."""
    written = []
    real = toy.inputs

    def inputs(traffic, gfa, facts, work):
        made = real(traffic, gfa, facts, work)
        written.extend(made.values())
        return made

    monkeypatch.setattr(toy, "inputs", inputs)
    read = []
    real_ref = toy.reference_tables
    monkeypatch.setattr(toy, "reference_tables", lambda argv: read.append(argv) or real_ref(argv))
    r = harness.run_cell(_report_cell(tmp_path), SEED, 0.3, False, CPU, time.perf_counter(),
                         graph_dir=str(tmp_path / "graphs"))
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] >= 1, r["checks"]
    assert r["checks"] == {"errors": {"value": 0, "limit": 0}, "bins_off": {"value": 0, "limit": 0},
                           "sections_off": {"value": 0, "limit": 0}}
    (yaml,) = written
    assert read == [["report", "--json", yaml]]
    assert not os.path.exists(yaml) and not os.path.exists(os.path.dirname(yaml))
    kept = sorted(os.listdir(tmp_path / "graphs"))
    assert len(kept) == 2 and kept[0].endswith(".gfa") and kept[1] == kept[0] + ".json"


@pytest.mark.parametrize("how", ["altered", "half"])
def test_report_cell_broken_path_is_not_correct(tmp_path, monkeypatch, toy, how):
    """A hist bin altered where pt_fused_hist produces it, or half of M's
    items left out: the toy report cell reads not correct."""
    _patch_hist(monkeypatch, how)
    r = harness.run_cell(_report_cell(tmp_path), SEED, 0.3, False, CPU, time.perf_counter(),
                         graph_dir=str(tmp_path / "graphs"))
    assert r["correct"] is False and r["failed"] == r["attempted"], r["checks"]


def test_readings_passes_its_work_directory(tmp_path, monkeypatch, capsys, toy):
    """readings.py on the toy report cell (its commands on the CPU): the hook
    writes into readings' own directory, and the program and the control
    are read against the reference."""
    cell = _report_cell(tmp_path)
    graphs = str(tmp_path / "graphs")
    real_prepare, real_commands = harness.prepare_inputs, harness.run_commands
    monkeypatch.setattr(harness.Cell, "load", classmethod(lambda cls, name: cell))
    monkeypatch.setattr(harness, "prepare_inputs", lambda c, seed, work=None: real_prepare(c, seed, graphs, work))
    monkeypatch.setattr(harness, "run_commands", lambda run_cli, argv, devices, *a: real_commands(run_cli, argv, CPU, *a))
    assert readings.main(["--cells", cell.name, "--seeds", "6", "--seconds", "0.1", "--control", "1"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["program"] == {"errors": 0, "bins_off": 0, "sections_off": 0}
    assert line["control"]["shifted"]["bins_off"] > 0


def test_a_report_cell_needs_only_new_files(tmp_path):
    """In a copy of the benchmark, a `report --json {config}` cell whose
    traffic names the toy reference, which writes the YAML, with its
    configuration and limits, all new files: the copy's run_cell ends
    correct on the CPU, with harness.py, tables.py, readings.py and
    generate.py byte for byte the tree's, and leaves no run directory."""
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(ROOT, "benchmark"), root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    spec = json.loads(open(os.path.join(ROOT, "BENCHMARK.json")).read())
    b = root / "benchmark"
    cfg = json.loads((b / "configs/pggb-chr22.json").read_text())
    cfg.update(name="toy", n_nodes=600, haplotypes=FEW_HAPS)
    (b / "configs/toy.json").write_text(json.dumps(cfg))
    (b / f"reference/{TOY}.py").write_text(TOY_REPORT)
    (b / "traffic/toy-report.json").write_text(json.dumps(REPORT_TRAFFIC))
    (b / "limits/toy.report.json").write_text(json.dumps(LIMITS))
    spec["configs"].append({"name": "toy", "source": "a toy", "file": "benchmark/configs/toy.json",
                            "reduced": [], "why": "a toy"})
    spec["workloads"].append({"name": "toy.report", "config": "toy", "traffic": "toy-report", "chips": 1,
                              "why": "a toy"})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    tmp = tmp_path / "tmp"
    tmp.mkdir()
    code = f"""
import json, sys, time
sys.path.insert(0, {str(root)!r}); sys.path.append({ROOT!r})
import torch
from benchmark import generate, harness, readings
assert harness.__file__.startswith({str(root)!r})
cell = harness.Cell.load("toy.report", {str(root)!r})
r = harness.run_cell(cell, 5, 0.2, False, (torch.device("cpu"),), time.perf_counter(),
                     graph_dir={str(tmp_path / "g")!r})
print(json.dumps(r))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=root,
                         env=dict(os.environ, TMPDIR=str(tmp)))
    assert out.returncode == 0, out.stderr[-3000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert r["correct"] is True and r["attempted"] >= 1, r
    assert set(r["checks"]) == {"errors", "bins_off", "sections_off"}
    assert "argv report --json " + str(tmp) in out.stderr and "report.yaml" in out.stderr
    assert os.listdir(tmp) == []
    for f in ("harness.py", "reference/tables.py", "readings.py", "generate.py"):
        assert (b / f).read_bytes() == open(os.path.join(ROOT, "benchmark", f), "rb").read()
