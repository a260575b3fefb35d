"""A cell's reference module, named by its traffic, and a configuration's
graph writer, named by its configuration: the histgrowth cells on `tables`
as before, the similarity reference against the program, its faults and
controls, and a cell of a new subcommand added through new files only."""

import contextlib
import hashlib
import io
import json
import os
import shutil
import subprocess
import sys
import time

import pytest
import torch
from conftest import CELLS, ROOT, small_cell
from test_benchmark_harness import _drop_half, _patch_hist

from benchmark import generate, harness
from benchmark.reference import similarity, tables

CPU = (torch.device("cpu"),)
SEED = 2**31 + 303
SIM = "pggb-chr22.similarity-node"
FEW_HAPS = [{"sample_prefix": "HG", "samples": 5, "haps": [1, 2], "seqid": "chr22"}]
HAPS_33 = [{"sample_prefix": "HG", "samples": 16, "haps": [1, 2], "seqid": "chr22"},
           {"sample": "CHM13", "haps": [0], "seqid": "chr22"}]
PARENT_DIGEST_2000_S7 = "9e83f1157e7aa1aeaa942f35a196891209d3f8d9179543db70ebfd5bc4a66e53"


def _program_tsv(argv):
    from panacus_torch import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli.run_cli(argv, devices=CPU)
    return buf.getvalue()


def _inputs(tmp_path, name, seed=SEED, **changes):
    cell = small_cell(tmp_path, name, **changes)
    return cell, harness.prepare_inputs(cell, seed, str(tmp_path / "graphs"))


def _run(tmp_path, cell, trace=False, seconds=0.3):
    return harness.run_cell(cell, SEED, seconds, trace, CPU, time.perf_counter(),
                            graph_dir=str(tmp_path / "graphs"))


@pytest.mark.parametrize("name", CELLS)
def test_histgrowth_cells_resolve_to_tables(name):
    cell = harness.Cell.load(name, ROOT)
    assert "reference" not in cell.traffic and cell.reference is tables
    assert set(cell.limits()) == {"errors", *tables.COMBINE}


def _parent_numbers(commands, want):
    """The parent's compare_outputs, which knew the four numbers by name."""
    out = {"errors": 0, "layout_off": 0, "cells_off": 0, "growth_gap": 0.0}
    for c in commands:
        if c.error is not None:
            out["errors"] += 1
            continue
        with open(c.tsv) as f:
            r = tables.compare(f.read(), want)
        out["layout_off"] += r["layout_off"]
        out["cells_off"] += r["cells_off"]
        out["growth_gap"] = max(out["growth_gap"], r["growth_gap"])
    return out


@pytest.mark.parametrize("fault", ["none", "altered", "half", "row", "raise"])
@pytest.mark.parametrize("name", CELLS)
def test_histgrowth_numbers_as_before(tmp_path, monkeypatch, name, fault):
    """On each planted fault of the harness's tests, the numbers through the
    module are the parent's, value and type, and so is the growth shape."""
    from panacus_torch import cli
    from panacus_torch.analyses import growth
    from panacus_torch.ops import hist_kernels

    cell, inputs = _inputs(tmp_path, name)
    if fault in ("altered", "half"):
        _patch_hist(monkeypatch, fault)
    elif fault == "row":
        real = growth.write_table
        monkeypatch.setattr(growth, "write_table", lambda *a: "".join(real(*a).splitlines(True)[:-1]))
    elif fault == "raise":
        monkeypatch.setattr(hist_kernels, "fused_hist", lambda *a: 1 / 0)
    work = tmp_path / "w"
    work.mkdir()
    cmds = harness.run_commands(cli.run_cli, inputs.argv, CPU, 0, str(work))
    cmds += harness.run_commands(cli.run_cli, inputs.argv, CPU, 0, str(work), "v")
    want = tables.reference_tables(inputs.argv)
    got = harness.compare_outputs(cmds, cell.reference, want)
    parent = _parent_numbers(cmds, want)
    assert got == parent and [type(v) for v in got.values()] == [type(v) for v in parent.values()]
    if fault != "none":
        assert any(harness.command_failed(c, cell.limits()) for c in cmds)
    cmd = tables.parse_command(inputs.argv)
    run = harness.Run(cell, inputs, cmds)
    assert run.shape() == {
        "counts": ("node", "bp", "edge") if cmd.count == "all" else (cmd.count,),
        "n_groups": 90, "n_nodes": 3000, "n_edges": inputs.facts["n_edges"], "n_thresholds": 3,
    }


@pytest.mark.parametrize("changes", [
    {"seed": 0},
    {"seed": 2**31 + 11},
    {"seed": 7, "n_nodes": 20000},
    {"seed": 8, "haplotypes": FEW_HAPS},
    {"seed": 9, "haplotypes": HAPS_33},
])
def test_similarity_reference_equals_program_on_cpu(tmp_path, changes):
    """The port's plain-PyTorch `similarity -c node -H` writes the
    reference's table: every cell's text and the leaf order."""
    seed = changes.pop("seed")
    cell, inputs = _inputs(tmp_path, SIM, seed, **changes)
    assert cell.reference is similarity
    want = similarity.reference_tables(inputs.argv)
    assert len(want.labels) == len(inputs.facts["haplotypes"])
    got = similarity.compare(_program_tsv(inputs.argv), want)
    assert got == {"layout_off": 0, "cells_off": 0, "order_off": 0}


def _edit(text, how):
    head = [ln for ln in text.splitlines(True) if ln.startswith("#")]
    lines = [ln.split("\t") for ln in text.splitlines() if ln and not ln.startswith("#")]
    if how == "swap_rows":
        lines[1], lines[2] = lines[2], lines[1]
    elif how == "cell":
        lines[3][5] = lines[3][5] + "1"
    elif how == "drop_label":
        lines = [r[:-1] for r in lines[:-1]]
    return "".join(head) + "".join("\t".join(r) + "\n" for r in lines)


@pytest.mark.parametrize("how, number", [("swap_rows", "order_off"), ("cell", "cells_off"),
                                         ("drop_label", "layout_off")])
def test_similarity_planted_faults(tmp_path, how, number):
    """On the program's own table: two rows swapped read as order_off alone,
    one cell changed as cells_off alone, one label dropped as layout_off."""
    cell, inputs = _inputs(tmp_path, SIM)
    want = similarity.reference_tables(inputs.argv)
    text = _program_tsv(inputs.argv)
    got = similarity.compare(_edit(text, how), want)
    assert got == {**{k: 0 for k in similarity.COMBINE}, number: 1}
    assert any(v > cell.limits()[k] for k, v in got.items())


def test_similarity_controls_fail(tmp_path):
    """The intersections accumulated in bfloat16 fail cells_off; the
    reference's order reversed fails order_off alone; the exact table
    passes every limit."""
    cell, inputs = _inputs(tmp_path, SIM)
    limits = cell.limits()
    want = similarity.reference_tables(inputs.argv)
    got = {k: similarity.compare(t, want) for k, t in similarity.controls(inputs.argv, want).items()}
    assert got["bfloat16"]["cells_off"] > limits["cells_off"]
    assert got["order_reversed"] == {"layout_off": 0, "cells_off": 0, "order_off": 1}
    exact = similarity.compare(similarity.write_tsv(want), want)
    assert all(v <= limits[k] for k, v in exact.items())


@pytest.mark.parametrize("p, q", [(1, 3), (2, 3), (1, 10), (7, 7), (0, 5), (999_999, 1_000_003),
                                  (1, 2**24 + 1), (2**24 - 1, 2**25), (123_456, 634_000)])
def test_round_f32_rounds_the_rational_once(p, q):
    from fractions import Fraction

    import numpy as np

    got = similarity.round_f32(p, q)
    exact = Fraction(p, q)
    below = np.float32(float(exact))
    cands = {np.nextafter(below, np.float32(-1)), below, np.nextafter(below, np.float32(2))}
    best = min(cands, key=lambda c: (abs(Fraction(float(c)) - exact),
                                     int(np.float32(c).view(np.uint32)) & 1))
    assert got == best and got.dtype == np.float32


def test_bf16_rounds_to_nearest_even():
    import numpy as np

    x = np.array([1.0, 256.0, 257.0, 258.0, 259.0, 0.1], dtype=np.float32)
    assert similarity.bf16(x).tolist() == [1.0, 256.0, 256.0, 258.0, 260.0, 0.10009765625]


def _patch_similarity(monkeypatch, how):
    from panacus_torch.ops import group_kernels

    real = group_kernels.similarity

    def fake(M, w, w_max=None):
        if how == "half":
            M = _drop_half(M)
        out = real(M, w, w_max)
        if how == "altered":
            out = out.clone()
            out[0, 1] += 1
        return out

    monkeypatch.setattr(group_kernels, "similarity", fake)


@pytest.mark.parametrize("how", ["altered", "half"])
def test_similarity_broken_path_is_not_correct(tmp_path, monkeypatch, how):
    """An intersection altered where pt_similarity produces it, or half of
    M's items left out of it: `correct` reads false, every command failed."""
    _patch_similarity(monkeypatch, how)
    r = _run(tmp_path, small_cell(tmp_path, SIM))
    assert r["correct"] is False and r["failed"] == r["attempted"], r["checks"]


def test_similarity_result_line_on_cpu(tmp_path):
    cell = small_cell(tmp_path, SIM)
    for trace in (False, True):
        r = _run(tmp_path, cell, trace)
        assert r["correct"] is True and r["failed"] == 0, r["checks"]
        assert set(r["checks"]) == {"errors", "layout_off", "cells_off", "order_off"}
        listed = {m["name"] for m in cell.metrics("per_layer" if trace else "end_to_end")}
        # no card: the roofline readers find nothing to read
        assert set(r["metrics"]) == {m for m in listed if not (trace and "_roofline" in m)}
        assert "similarity_ms" in r["metrics"] or not trace


def test_pt_similarity_byte_counts_of_hand_worked_shapes():
    k = harness.load_module(os.path.join(ROOT, "benchmark/kernels/pt_similarity.py"))
    # 90 groups: 3 words; M 12 bytes an item, the weight row 4, a 96 x 96 int64 result
    s90 = {"n_groups": 90, "n_nodes": 634_000, "n_edges": 0, "counts": ("node",)}
    assert k.least_bytes(s90) == 12 * 634_000 + 4 * 634_000 + 8 * 96 * 96 == 10_217_728
    # 32 groups: one word, a 32 x 32 result
    s32 = {"n_groups": 32, "n_nodes": 1000, "n_edges": 0, "counts": ("node",)}
    assert k.least_bytes(s32) == 4 * 1000 + 4 * 1000 + 8 * 32 * 32 == 16_192
    assert k.matches("(anonymous namespace)::similarity_kernel(unsigned int const*, long, long)")
    assert k.matches("similarity_reduce_kernel(int const*, long, int, int, long long*)")
    assert not k.matches("fused_hist_warp_kernel(unsigned int const*)")


def test_default_writer_keeps_the_parents_bytes(tmp_path):
    """A configuration without a writer: generate.py's own P-line writer, its
    bytes those of the parent's generator (GEN_VERSION 3)."""
    cfg = json.loads(open(os.path.join(ROOT, "benchmark/configs/pggb-chr22.json")).read())
    cfg["n_nodes"] = 2000
    assert "writer" not in cfg and generate.GEN_VERSION == 3
    assert generate.writer(cfg) is generate.write_graph
    generate.writer(cfg)(cfg, 7, str(tmp_path / "g.gfa"))
    assert hashlib.sha256((tmp_path / "g.gfa").read_bytes()).hexdigest() == PARENT_DIGEST_2000_S7


TOY_WRITER = '''
import os
from benchmark import generate


def write_graph(cfg, seed, path, threads=0):
    n = int(cfg["n_nodes"])
    with open(path, "w") as f:
        f.write("H\\tVN:Z:1.0\\n")
        f.write("".join(f"S\\t{i}\\tACG\\n" for i in range(1, n + 1)))
        f.write("".join(f"L\\t{i}\\t+\\t{i + 1}\\t+\\t0M\\n" for i in range(1, n)))
        steps = ",".join(f"{i}+" for i in range(1, n + 1))
        f.write(f"P\\ttoy#1#c\\t{steps}\\t*\\n")
        f.write(f"P\\ttoy#2#c\\t{steps}\\t*\\n")
    assert generate.GEN_VERSION
    return {"n_nodes": n, "n_edges": n - 1, "total_bp": 3 * n, "path_bp_mean": 3.0 * n,
            "path_steps": 2 * n, "samples": ["toy"], "haplotypes": ["toy#1", "toy#2"],
            "path_names": ["toy#1#c", "toy#2#c"], "gfa_bytes": os.path.getsize(path), "seed": seed}
'''


def test_a_configuration_names_its_writer(tmp_path, monkeypatch):
    writers = tmp_path / "writers"
    writers.mkdir()
    (writers / "toy.py").write_text(TOY_WRITER)
    monkeypatch.setattr(generate, "WRITERS", str(writers))
    cfg = tmp_path / "toy.json"
    cfg.write_text(json.dumps({"name": "toy", "writer": "toy", "n_nodes": 5}))
    gfa = generate.ensure_graph(str(cfg), 4, str(tmp_path / "g"))
    text = open(gfa).read()
    assert text.count("\nS\t") == 5 and "P\ttoy#2#c\t1+,2+,3+,4+,5+\t*" in text
    assert json.load(open(gfa + ".json"))["seed"] == 4
    cfg.write_text(json.dumps({"name": "toy", "writer": "../toy", "n_nodes": 5}))
    with pytest.raises(ValueError, match="no graph writer"):
        generate.ensure_graph(str(cfg), 5, str(tmp_path / "g"))


TOY_REFERENCE = '''
"""A toy reference: `hist -c node -H`, the node coverage hist."""
from .counts import coverage, hist
from .gfa import read_gfa

COMBINE = {"bins_off": "sum"}


def parse_command(argv):
    if argv[:4] != ["hist", "-c", "node", "-H"] or len(argv) != 5:
        raise ValueError("the toy reference takes hist -c node -H only")
    return argv[4]


def shape(argv, facts):
    return {"counts": ("node",), "n_groups": len(facts["haplotypes"]), "n_nodes": facts["n_nodes"],
            "n_edges": facts["n_edges"]}


def reference_tables(argv, dtype=None):
    g = read_gfa(parse_command(argv))
    groups = g.groups("haplotype")
    return [int(x) for x in hist(coverage(g, groups, "node"), None, len(groups))]


def write_tsv(want):
    return "".join(f"{i}\\t{x}\\n" for i, x in enumerate(want))


def compare(text, want):
    rows = [ln.split("\\t") for ln in text.splitlines() if ln[:1].isdigit()]
    got = [int(r[1]) for r in rows]
    return {"bins_off": sum(a != b for a, b in zip(got, want)) + abs(len(got) - len(want))}


def controls(argv, want):
    return {"shifted": write_tsv([0] + want[:-1])}
'''


def test_a_cell_of_a_new_subcommand_needs_only_new_files(tmp_path):
    """In a copy of the benchmark, a `hist` cell whose configuration names a
    toy writer and whose traffic names a toy reference, with its limits and
    a reader of its own, all new files: the copy's harness runs it, correct,
    with no edit to harness.py, tables.py, readings.py or generate.py."""
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(ROOT, "benchmark"), root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    spec = json.loads(open(os.path.join(ROOT, "BENCHMARK.json")).read())
    b = root / "benchmark"
    (b / "writers/toy.py").write_text(TOY_WRITER)
    (b / "configs/toy.json").write_text(json.dumps({"name": "toy", "writer": "toy", "n_nodes": 400}))
    (b / "reference/toyhist.py").write_text(TOY_REFERENCE)
    (b / "traffic/toy-hist.json").write_text(json.dumps(
        {"argv": ["hist", "-c", "node", "-H", "{gfa}"], "reference": "toyhist"}))
    (b / "limits/toy.hist.json").write_text(json.dumps({"errors": 0, "bins_off": 0}))
    (b / "metrics/hist_bins.py").write_text("def read(run):\n    return float(run.shape()['n_groups'] + 1)\n")
    spec["configs"].append({"name": "toy", "source": "a toy", "file": "benchmark/configs/toy.json",
                            "reduced": [], "why": "a toy"})
    spec["workloads"].append({"name": "toy.hist", "config": "toy", "traffic": "toy-hist", "chips": 1,
                              "why": "a toy"})
    spec["per_layer"].append({"name": "hist_bins", "unit": "bins", "better": "lower",
                              "source": "program_counter", "layer": "hist", "moves": "setup_s",
                              "workloads": ["toy.hist"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    code = f"""
import json, sys, time
sys.path.insert(0, {str(root)!r}); sys.path.append({ROOT!r})
import torch
from benchmark import harness
assert harness.__file__.startswith({str(root)!r})
cell = harness.Cell.load("toy.hist", {str(root)!r})
r = harness.run_cell(cell, 3, 0.2, True, (torch.device("cpu"),), time.perf_counter(),
                     graph_dir={str(tmp_path / "g")!r})
print(json.dumps(r))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=root)
    assert out.returncode == 0, out.stderr[-3000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert r["correct"] is True and r["attempted"] >= 1, r
    assert r["checks"] == {"errors": {"value": 0, "limit": 0}, "bins_off": {"value": 0, "limit": 0}}
    assert r["metrics"]["hist_bins"]["value"] == 3.0
    for f in ("harness.py", "reference/tables.py", "readings.py", "generate.py"):
        assert (b / f).read_bytes() == open(os.path.join(ROOT, "benchmark", f), "rb").read()



def test_similarity_reference_imports_nothing_of_the_program():
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "import numpy as np\n"
        "import benchmark.reference.similarity as s, benchmark.writers\n"
        "assert sorted(s.leaf_order(np.eye(3, dtype=np.float32), 'centroid')) == [0, 1, 2]\n"
        "bad = {m.split('.')[0] for m in sys.modules} & "
        "{'jax', 'jaxlib', 'flax', 'panacus_tpu', 'panacus_torch', 'torch'}\n"
        "assert not bad, bad\n" % ROOT
    )
    subprocess.run([sys.executable, "-c", code], check=True)
