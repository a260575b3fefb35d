"""The harness on the CPU: the result line, the faults that must read as not
correct, the control, and what a run refuses."""

import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import pytest
import torch
from conftest import CELLS, ROOT, small_cell

from benchmark import harness
from benchmark.reference import tables

CPU = (torch.device("cpu"),)
SEED = 2**31 + 101


def _run(tmp_path, cell, trace=False, seconds=0.5):
    return harness.run_cell(cell, SEED, seconds, trace, CPU, time.perf_counter(),
                            graph_dir=str(tmp_path / "graphs"))


@pytest.mark.parametrize("name", CELLS)
def test_result_line_on_cpu(tmp_path, name):
    cell = small_cell(tmp_path, name)
    spec = cell.spec
    for trace in (False, True):
        r = _run(tmp_path, cell, trace)
        assert list(r)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
        assert list(r)[-1] == "checks"
        assert r["correct"] is True and r["failed"] == 0 and r["attempted"] >= 1
        kind = "per_layer" if trace else "end_to_end"
        listed = {m["name"] for m in spec[kind] if name in m.get("workloads", [name])}
        got = set(r["metrics"])
        if trace:
            # no card: the roofline readers find nothing to read
            assert got == {m for m in listed if "_roofline" not in m}
            assert {"busy_s", "window_s"} <= set(r["device"]) and "breakdown" in r
        else:
            assert got == listed
        for m in r["metrics"].values():
            assert set(m) == {"value", "unit"} and isinstance(m["value"], float)
        assert r["device"]["count"] == 1
        json.dumps(r)


def _drop_half(M):
    """M with the second half of its items (columns up to the last one that
    any group holds; the rest is padding) left out."""
    used = int((M != 0).any(dim=0).nonzero().max()) + 1
    M = M.clone()
    M[:, used // 2 :] = 0
    return M


def _patch_hist(monkeypatch, how):
    from panacus_torch.ops import hist_kernels

    real = hist_kernels.fused_hist

    def fused_hist(M, W, n_bins):
        if how == "half":
            M = _drop_half(M)
        out = real(M, W, n_bins)
        if how == "altered":
            out = out.clone()
            out[0, 2] += 1
        return out

    monkeypatch.setattr(hist_kernels, "fused_hist", fused_hist)


@pytest.mark.parametrize("how", ["altered", "half"])
@pytest.mark.parametrize("name", CELLS)
def test_a_broken_path_is_not_correct(tmp_path, monkeypatch, name, how):
    """An answer altered where the kernel produces it, or half of the items
    left out of M: `correct` reads false, every command failed."""
    cell = small_cell(tmp_path, name)
    _patch_hist(monkeypatch, how)
    r = _run(tmp_path, cell)
    assert r["correct"] is False and r["failed"] == r["attempted"], r["checks"]


@pytest.mark.parametrize("name", CELLS)
def test_a_table_missing_its_last_row_is_not_correct(tmp_path, monkeypatch, name):
    """The writer drops a row where the table is produced: layout_off."""
    from panacus_torch.analyses import growth

    real = growth.write_table
    monkeypatch.setattr(growth, "write_table", lambda *a: "".join(real(*a).splitlines(True)[:-1]))
    r = _run(tmp_path, small_cell(tmp_path, name))
    assert r["correct"] is False and r["checks"]["layout_off"]["value"] == r["attempted"]


def test_a_command_that_raises_is_not_correct(tmp_path, monkeypatch):
    from panacus_torch.ops import hist_kernels

    def broken(*a, **k):
        raise RuntimeError("planted")

    monkeypatch.setattr(hist_kernels, "fused_hist", broken)
    r = _run(tmp_path, small_cell(tmp_path, "pggb-chr22.hg-node"))
    assert r["correct"] is False and r["checks"]["errors"]["value"] == r["attempted"]


@pytest.mark.parametrize("name", CELLS)
def test_float32_control_fails(tmp_path, name):
    """The reference in float32 in the program's place fails a number of the
    cell under its limits; the float64 / exact reference passes them. At
    150,000 nodes the hists are large enough for float32 to move a floor."""
    cell = small_cell(tmp_path, name, 150000)
    inputs = harness.prepare_inputs(cell, SEED, str(tmp_path / "graphs"))
    want = tables.reference_tables(inputs.argv)
    limits = cell.limits()
    control = tables.compare(tables.write_tsv(tables.reference_tables(inputs.argv, np.float32)), want)
    exact = tables.compare(tables.write_tsv(want), want)
    assert all(v <= limits.get(k, 0) for k, v in exact.items()), exact
    assert any(v > limits.get(k, 0) for k, v in control.items()), control


def test_run_loads_no_jax_module(tmp_path):
    """A whole run in a fresh interpreter leaves no module of JAX or of the
    JAX package loaded."""
    code = f"""
import sys, time, json
sys.path.insert(0, {ROOT!r}); sys.path.insert(0, {os.path.dirname(__file__)!r})
import pathlib, torch
from conftest import small_cell
from benchmark import harness
cell = small_cell(pathlib.Path({str(tmp_path)!r}), "pggb-chr22.hg-all")
r = harness.run_cell(cell, 3, 0.2, True, (torch.device("cpu"),), time.perf_counter(),
                     graph_dir={str(tmp_path / "g")!r})
assert r["correct"], r
assert not harness.forbidden_modules(), harness.forbidden_modules()
print("ok")
"""
    out = subprocess.run([sys.executable, "-c", code], check=True, capture_output=True, text=True)
    assert out.stdout.strip().endswith("ok")


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "panacus_tpu_like", sys)
    assert "panacus_tpu_like" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jaxlib.xla", sys)
    assert "jaxlib" in harness.forbidden_modules()


def test_entry_point_without_a_card_prints_no_result():
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "pggb-chr22.hg-node",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": ""},
    )
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_entry_point_in_a_bare_directory_fails(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "benchmark"), tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "pggb-chr22.hg-node",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, capture_output=True, text=True,
    )
    assert out.returncode != 0 and out.stdout.strip() == ""
