"""The port's C layer (panacus_torch/native): required, and the host routes
that input reaches beside it.

native.get_lib() builds gfa_scan.c with $CC (else cc) on its first call
and raises RuntimeError, naming the compiler, where that fails; importing
the front end builds nothing. A process keeps the library it loaded, so
each case runs in a child interpreter with an empty cache.

Beside the C calls the front end keeps only what input reaches while the
library is loaded, each driven here through the CLI and held against
panacus_tpu: step lists that the C tokenizer refuses (a malformed integer
token in a P or a W line, an unknown node, a bad orientation, an unknown
string name, a trailing comma that the per-path parse takes) go through
the classic itemizer and GraphStorage.path_item_run, which raises
panacus_tpu's error or gives its output; a graph past the CSR adjacency's
packed layout (its limit lowered here) counts edges through the open hash.
"""

from __future__ import annotations

import os
import subprocess
import sys

import pytest

from panacus_torch import native, testgraphs
from panacus_torch.cli import run_cli as torch_cli
from panacus_torch.gfa import GraphStorage

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CHILD = """
import glob, os, sys
import panacus_torch, panacus_torch.gfa
from panacus_torch import native
cache = os.path.join(os.environ["XDG_CACHE_HOME"], "panacus_tpu", "native")
assert not glob.glob(os.path.join(cache, "gfa_scan-*.so")), "the import built the library"
for _ in range(2):  # a failure is not remembered: the second call builds again
    try:
        lib = native.get_lib()
    except RuntimeError as e:
        print("RAISED", e)
    else:
        print("LIB", type(lib).__name__, hasattr(lib, "pt_tokenize_batch"))
print("SO", len(glob.glob(os.path.join(cache, "gfa_scan-*.so"))))
"""


@pytest.mark.parametrize("cc", ["false", None], ids=["cc_false", "cc_default"])
def test_get_lib_builds_the_library_or_raises(tmp_path, cc):
    env = dict(os.environ, XDG_CACHE_HOME=str(tmp_path / "cache"), PYTHONPATH=REPO)
    env.pop("CC", None)
    if cc is not None:
        env["CC"] = cc
    out = subprocess.run(
        [sys.executable, "-c", CHILD], env=env, cwd=str(tmp_path),
        capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    if cc is None:
        assert lines == ["LIB CDLL True", "LIB CDLL True", "SO 1"], out.stdout
    else:
        raised = [l for l in lines if l.startswith("RAISED")]
        assert len(raised) == 2, out.stdout
        assert "the C compiler 'false'" in raised[0], raised[0]
        assert lines[-1] == "SO 0", out.stdout


# -- step lists the C tokenizer refuses ----------------------------------------

BASE = ["S\t1\tAC", "S\t2\tG", "S\t3\tTT", "L\t1\t+\t2\t+\t0M", "L\t2\t+\t3\t-\t0M"]
STR_BASE = ["S\ts1\tAC", "S\ts2\tG", "L\ts1\t+\ts2\t+\t0M"]
REFUSED = {
    "p_malformed_token": BASE + ["P\ta#0#c\t1+,2x+,3-\t*", "P\tb#0#c\t1+,2+\t*"],
    "w_malformed_token": BASE + ["W\ta\t0\tc\t0\t3\t>1>2x<3", "P\tb#0#c\t1+,2+\t*"],
    "unknown_node": BASE + ["P\ta#0#c\t1+,9+\t*"],
    "bad_orientation": BASE + ["P\ta#0#c\t1+,2*\t*"],
    "trailing_comma": BASE + ["P\ta#0#c\t1+,2+,\t*", "P\tb#0#c\t2+,3-\t*"],
    "string_unknown_name": STR_BASE + ["P\ta#0#c\ts1+,s9+\t*"],
    "string_bad_orientation": STR_BASE + ["P\ta#0#c\ts1+,s2x\t*"],
}


def _outcome(cli, argv, capsys):
    try:
        rc = cli(argv)
    except Exception as e:  # the user-facing error, compared by type and text
        capsys.readouterr()
        return type(e).__name__, str(e)
    body = "".join(l for l in capsys.readouterr().out.splitlines(True) if not l.startswith("#"))
    return rc, body


@pytest.mark.parametrize("count", ["node", "edge"])
@pytest.mark.parametrize("case", list(REFUSED))
def test_refused_step_list_fails_or_counts_as_jax(tmp_path, capsys, monkeypatch, case, count):
    """The tokenizer refuses the step list, the build takes the classic
    itemizer, and each path's own parse raises panacus_tpu's error (or,
    for a trailing comma, counts as panacus_tpu)."""
    pytest.importorskip("jax")
    from panacus_tpu.cli import run_cli as jax_cli

    gfa = tmp_path / f"{case}.gfa"
    gfa.write_text("\n".join(REFUSED[case]) + "\n")
    argv = ["hist", "-c", count, str(gfa)]
    monkeypatch.setenv("PANACUS_TORCH_DEVICE", "cpu")
    per_path = []
    real = GraphStorage.path_item_run
    monkeypatch.setattr(
        GraphStorage, "path_item_run", lambda self, i: (per_path.append(i), real(self, i))[1]
    )
    got = _outcome(torch_cli, argv, capsys)
    assert per_path, "the per-path parse did not run"
    assert got == _outcome(jax_cli, argv, capsys)
    assert (got[0] == 0) == (case == "trailing_comma"), got


# -- past the CSR adjacency's packed layout --------------------------------------

PAST_ADJ = [
    ["histgrowth", "-c", "all", "-H", "-q", "0,0.5,1", "-l", "0,1,2"],
    ["table", "-c", "edge"],
]


@pytest.mark.parametrize("argv", PAST_ADJ, ids=[" ".join(a[:3]) for a in PAST_ADJ])
def test_open_hash_serves_past_the_adjacency(tmp_path, capsys, monkeypatch, argv):
    """With ADJ_MAX_ITEMS below the node count, build_edge_adj returns None,
    the edge rows are packed from the open hash's edge runs, and the TSV
    equals panacus_tpu's."""
    pytest.importorskip("jax")
    from panacus_tpu.cli import run_cli as jax_cli

    gfa = str(tmp_path / "g.gfa")
    testgraphs.make_graph(gfa, n_nodes=3000, n_paths=12)
    argv = argv + [gfa]
    monkeypatch.setenv("PANACUS_TORCH_DEVICE", "cpu")
    monkeypatch.setattr(native, "ADJ_MAX_ITEMS", 1)
    runs = []
    real = GraphStorage.edge_runs
    monkeypatch.setattr(
        GraphStorage, "edge_runs", lambda self, *a: (runs.append(self.edge_adj()), real(self, *a))[1]
    )
    got = _outcome(torch_cli, argv, capsys)
    assert got[0] == 0, got
    assert runs and all(adj is None for adj in runs), runs
    assert got == _outcome(jax_cli, argv, capsys)
