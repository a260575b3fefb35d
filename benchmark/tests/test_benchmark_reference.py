"""The reference, the generator and the byte counts on the CPU."""

import contextlib
import io
import json
import math
import os
import subprocess
import sys

import numpy as np
import pytest
from conftest import CELLS, ROOT, small_cell

from benchmark import generate
from benchmark.harness import Cell, load_module, prepare_inputs
from benchmark.reference import counts, tables
from benchmark.reference.gfa import read_gfa


def _program_tsv(argv):
    import torch

    from panacus_torch import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli.run_cli(argv, devices=(torch.device("cpu"),))
    return buf.getvalue()


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("seed", [0, 2**31 + 11])
def test_reference_equals_program_on_cpu(tmp_path, name, seed):
    """Every traffic mix on a tiny graph of its configuration: the port's
    plain-PyTorch run writes the reference's table, every floor exact."""
    cell = small_cell(tmp_path, name)
    inputs = prepare_inputs(cell, seed, str(tmp_path / "graphs"))
    want = tables.reference_tables(inputs.argv)
    got = tables.compare(_program_tsv(inputs.argv), want)
    assert got["layout_off"] == 0 and got["cells_off"] == 0, got
    assert got["growth_gap"] < 1e-9, got
    assert len(want.rows) > 1 and want.columns


def test_reference_reads_reverse_steps_and_groupings(tmp_path):
    """Hand-worked: a reverse step, -S against -H, an edge walked backwards;
    a W line raises."""
    gfa = tmp_path / "t.gfa"
    text = (
        "H\tVN:Z:1.0\nS\t1\tAC\nS\t2\tG\nS\t3\tTTT\n"
        "L\t1\t+\t2\t+\t0M\nL\t2\t+\t3\t-\t0M\nL\t1\t+\t3\t+\t0M\n"
        "P\ta#1#c\t1+,2+,3-\t*\n"
        "P\ta#2#c\t3+,2-,1-\t*\n"
        "P\tb#1#c\t1+,3+\t*\n"
    )
    gfa.write_text(text)
    g = read_gfa(str(gfa))
    assert g.node_len.tolist() == [2, 1, 3]
    by_sample = g.groups("sample")
    assert list(by_sample) == ["a", "b"]
    assert counts.coverage(g, by_sample, "node").tolist() == [2, 1, 2]
    # a's paths use L1 (1+2+) and L2 (2+3-, backwards as 3+2-); b uses L3
    assert counts.coverage(g, by_sample, "edge").tolist() == [1, 1, 1]
    assert len(g.groups("haplotype")) == 3
    cov = counts.coverage(g, by_sample, "node")
    assert counts.hist(cov, g.node_len, 2).tolist() == [0, 1, 5]
    gfa.write_text(text + "W\tb\t2\tc\t0\t5\t>1>3\n")
    with pytest.raises(ValueError, match="W lines"):
        read_gfa(str(gfa))


@pytest.mark.parametrize("n", [2, 5, 12])
def test_growth_is_the_subset_expectation(n):
    """Exact growth against a brute force over every m-subset of n groups."""
    from itertools import combinations

    rng = np.random.default_rng(n)
    mem = rng.random((n, 40)) < 0.4
    cov = mem.sum(axis=0)
    h = counts.hist(cov, None, n)
    for c, q in ((1, 0.0), (2, 0.0), (1, 0.5), (2, 0.5), (1, 1.0), (0, 0.3)):
        got = counts.growth(h, (float(c), False), (q, True))
        for m in range(1, n + 1):
            total = 0
            for sub in combinations(range(n), m):
                k = mem[list(sub)].sum(axis=0)
                quorum = max(1, math.ceil(n * q))
                if quorum == 1:
                    ok = (cov >= max(1, c)) & (k >= 1)
                elif quorum >= n:
                    ok = (k == m) & (cov >= max(1, math.ceil(c)))
                else:
                    mq = math.ceil(m * q)
                    ok = ((k == m) & (cov >= max(m, c, 1))) | (
                        (k >= max(mq, c, 1)) & (k < m) & (cov >= mq) & (cov < n)
                    )
                total += int(ok.sum())
            assert got[m - 1] * math.comb(n, m) == total, (c, q, m)


def test_generator_repeats_by_seed_and_differs_across_seeds(tmp_path):
    cfg = json.loads(open(os.path.join(ROOT, "benchmark/configs/pggb-chr22.json")).read())
    cfg["n_nodes"] = 2000
    paths = []
    for i, seed in enumerate((5, 5, 6, 2**31 + 3)):
        p = tmp_path / f"g{i}.gfa"
        facts = generate.write_graph(cfg, seed, str(p))
        paths.append(p.read_bytes())
        assert facts["n_nodes"] == 2000 and len(facts["path_names"]) == 90
        assert len(facts["samples"]) == 46 and len(facts["haplotypes"]) == 90
        assert facts["path_names"][-2:] == ["CHM13#0#chr22", "GRCh38#0#chr22"]
    assert paths[0] == paths[1]
    assert paths[0] != paths[2] and paths[2] != paths[3]


def test_generator_shape(tmp_path):
    """Every node on a path, every L line a step of a path and every step an
    L line, the shared class in every path, one P line a haplotype."""
    cfg = json.loads(open(os.path.join(ROOT, "benchmark/configs/pggb-chr22.json")).read())
    cfg["n_nodes"] = 5000
    facts = generate.write_graph(cfg, 9, str(tmp_path / "g.gfa"))
    g = read_gfa(str(tmp_path / "g.gfa"))
    assert g.n_nodes == 5000 and len(g.paths) == 90 and g.n_edges == facts["n_edges"]
    by_path = g.groups("path")
    cov = counts.coverage(g, by_path, "node")
    assert cov.min() >= 1 and (cov == 90).mean() > 0.5
    edge_cov = counts.coverage(g, by_path, "edge")  # raises on a step with no L line
    assert edge_cov.min() >= 1
    assert sum(len(p.nodes) for p in g.paths) == facts["path_steps"]
    assert abs(np.mean([g.node_len[p.nodes].sum() for p in g.paths]) - facts["path_bp_mean"]) < 1e-6


def test_generator_cache_keeps_the_newest_graphs(tmp_path, monkeypatch):
    monkeypatch.setattr(generate, "KEEP", 2)
    cell = small_cell(tmp_path, "pggb-chr22.hg-node", n_nodes=1000)
    out = str(tmp_path / "g")
    a = generate.ensure_graph(cell.config_path, 1, out)
    made = os.path.getmtime(a)
    assert generate.ensure_graph(cell.config_path, 1, out) == a
    assert os.path.getmtime(a) == made  # reused, not made again
    b = generate.ensure_graph(cell.config_path, 2, out)
    generate.ensure_graph(cell.config_path, 1, out)  # a is the newest again
    c = generate.ensure_graph(cell.config_path, 3, out)
    left = sorted(os.listdir(out))
    assert left == sorted(os.path.basename(x) + s for x in (a, c) for s in ("", ".json"))
    assert not os.path.exists(b)


def test_byte_counts_of_hand_worked_shapes():
    fh = load_module(os.path.join(ROOT, "benchmark/kernels/pt_fused_hist.py"))
    shape = {"n_groups": 90, "n_nodes": 900_000, "n_edges": 3_599_990, "n_thresholds": 3}
    # node M 3 words x 900,000 items, the bp row, two int64 hists of 91 bins,
    # edge M 3 x 3,599,990 and its hist
    assert fh.least_bytes({**shape, "counts": ("node", "bp", "edge")}) == (
        12 * 900_000 + 2 * 8 * 91 + 4 * 900_000 + 12 * 3_599_990 + 8 * 91
    )
    assert fh.least_bytes({**shape, "counts": ("node",)}) == 12 * 900_000 + 8 * 91
    # 46 groups: 2 words; bp: the M once, the bp row once, one hist
    s46 = {"n_groups": 46, "n_nodes": 1000, "n_edges": 0, "n_thresholds": 1, "counts": ("bp",)}
    assert fh.least_bytes(s46) == 8 * 1000 + 4 * 1000 + 8 * 47
    assert fh.matches("void (anonymous namespace)::fused_hist_warp_kernel(unsigned int const*)")
    assert not fh.matches("ordered_growth_kernel<7>")


def test_reference_imports_nothing_of_the_program():
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "import benchmark.reference.tables, benchmark.generate, benchmark.trace\n"
        "bad = {m.split('.')[0] for m in sys.modules} & "
        "{'jax', 'jaxlib', 'flax', 'panacus_tpu', 'panacus_torch', 'torch'}\n"
        "assert not bad, bad\n" % ROOT
    )
    subprocess.run([sys.executable, "-c", code], check=True)


def test_every_cell_has_its_files():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        spec = json.load(f)
    for w in spec["workloads"]:
        cell = Cell.load(w["name"], ROOT)
        assert os.path.exists(cell.config_path)
        assert set(cell.limits()) >= {"errors", "layout_off", "cells_off"}
        assert set(cell.limits()) == {"errors", *cell.reference.COMBINE}
        cell.reference.parse_command(cell.traffic["argv"])
        assert cell.metrics("per_layer") and cell.metrics("end_to_end")
    for m in spec["per_layer"]:
        assert os.path.exists(os.path.join(ROOT, "benchmark/metrics", m["name"] + ".py"))
