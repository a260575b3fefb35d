"""The port stands alone: nothing of JAX or of the JAX package.

- A fresh interpreter runs `histgrowth -c all`, `ordered-histgrowth`,
  `similarity`, `table`, `report --json` (every analysis kind that adds a
  section) and `render` of that JSON through panacus_torch on the CPU, then
  the probe entry point (panacus_torch.probe), an `ordered-histgrowth`
  with M split over three CPU shards, testgraphs.dryrun_multichip on two,
  CountingEngine.build from pairs and `histgrowth -c all` of a gzipped
  graph, and must finish with no
  `jax` and no `panacus_tpu` module loaded; `python -m panacus_torch.probe` run under
  `-X importtime` imports neither.
- `torchrun --nproc-per-node 2 -m panacus_torch hist` (two processes of a
  gloo group on the CPU, as the README runs the port on several
  processes): rank 0 prints the one-process TSV, and the import log of
  both ranks names no module of JAX or of the JAX package.
- An AST scan of every module of panacus_torch (panacus_torch/parallel/
  included) and of chip_smoke.py finds no import of panacus_tpu, jax,
  bench or __graft_entry__.
- The port's copies of the graph generators and oracles
  (panacus_torch.testgraphs) equal the JAX package's: the same GFA bytes
  from make_graph and _write_dryrun_gfa, the same oracle arrays.
"""

from __future__ import annotations

import ast
import glob
import os
import subprocess
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("panacus_tpu", "jax", "bench", "__graft_entry__")

SCRIPT = """
import contextlib, io, sys
from panacus_torch.cli import run_cli
for argv in (
    ["histgrowth", "-c", "all", "-S", "-q", "0,1", "-l", "1,2"],
    ["ordered-histgrowth", "-c", "bp", "-S", "-q", "0,0.5", "-l", "1,2"],
    ["similarity", "-c", "edge", "-H"],
    ["table", "-c", "node", "-S"],
):
    rc = run_cli(argv + [sys.argv[1]])
    assert rc == 0, (argv, rc)
buf = io.StringIO()
with contextlib.redirect_stdout(buf):
    rc = run_cli(["report", "--json", sys.argv[2]])
assert rc == 0, rc
with open(sys.argv[3], "w") as f:
    f.write(buf.getvalue())
rc = run_cli(["render", sys.argv[3]])
assert rc == 0, rc
from panacus_torch import probe
rc = probe.main(["--words", "2", "--items", "16384", "--rounds", "1", "read", "paritym"])
assert rc == 0, rc
with contextlib.redirect_stdout(io.StringIO()):
    rc = run_cli(["ordered-histgrowth", "-c", "node", "-S", sys.argv[1]], devices=("cpu",) * 3)
assert rc == 0, rc
from panacus_torch.testgraphs import dryrun_multichip
assert dryrun_multichip(("cpu",) * 2).startswith("dryrun_multichip ok")
import numpy as np
from panacus_torch.ops.engine import CountingEngine
eng = CountingEngine(10, 40, ("cpu",) * 2).build(np.array([1, 10, 10]), np.array([31, 39, 31]))
assert eng.hist().tolist()[:3] == [8, 1, 1], eng.hist()
from panacus_torch import testgraphs
gz = testgraphs.write_gzip(sys.argv[1], sys.argv[3] + ".gfa.gz")
with contextlib.redirect_stdout(io.StringIO()):
    rc = run_cli(["histgrowth", "-c", "all", "-H", gz])
assert rc == 0, rc
loaded = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax."))
assert not loaded, loaded
loaded = sorted(m for m in sys.modules if m.startswith("panacus_tpu"))
assert not loaded, loaded
print("NO_JAX_OK")
"""


def test_slice_imports_no_jax(tmp_path):
    from panacus_torch import testgraphs

    gfa = tmp_path / "dryrun.gfa"
    testgraphs._write_dryrun_gfa(str(gfa))
    yaml = tmp_path / "report.yaml"
    yaml.write_text(
        f"- graph: {gfa}\n  grouping: Sample\n  analyses:\n"
        "    - !Info\n    - !Hist\n    - !Growth\n    - !NodeDistribution\n"
        "    - !CoverageLine\n    - !OrderedGrowth\n"
        f"- graph: {gfa}\n  name: sim\n  grouping: Haplotype\n  analyses:\n"
        "    - !Similarity\n"
    )
    env = dict(os.environ, PANACUS_TORCH_DEVICE="cpu")
    res = subprocess.run(
        [sys.executable, "-c", SCRIPT, str(gfa), str(yaml), str(tmp_path / "r.json")],
        cwd=ROOT,
        env=env,
        capture_output=True,
        text=True,
        timeout=300,
    )
    assert res.returncode == 0, res.stderr[-4000:]
    assert "NO_JAX_OK" in res.stdout
    tables, html = res.stdout.split("<!DOCTYPE html>")  # one rendered report
    assert "panacus\tgrowth" in tables
    assert "panacus\tordered-growth" in tables
    assert tables.count("\ngroup\t") == 1  # the similarity table
    assert "\nnode\ts0\t" in tables  # the coverage table
    assert html.count('<section class="card"') > 8
    assert "parity fhm vs current: True" in html


def test_probe_entry_point_imports_no_jax():
    """`python -m panacus_torch.probe` on the CPU at a small shape exits 0;
    -X importtime lists every module it imports: none of JAX's or of the
    JAX package's."""
    env = dict(os.environ, PANACUS_TORCH_DEVICE="cpu")
    res = subprocess.run(
        [
            sys.executable, "-X", "importtime", "-m", "panacus_torch.probe",
            "--words", "3", "--items", "32768", "--rounds", "1", "pc", "fh21",
        ],
        cwd=ROOT,
        env=env,
        capture_output=True,
        text=True,
        timeout=300,
    )
    assert res.returncode == 0, res.stderr[-4000:]
    imported = [
        l.rsplit("|", 1)[1].strip()
        for l in res.stderr.splitlines()
        if l.startswith("import time:") and "|" in l
    ]
    assert "panacus_torch.ops.probe_kernels" in imported and "torch" in imported
    bad = [m for m in imported if m.split(".")[0] in ("jax", "panacus_tpu")]
    assert not bad, bad
    assert "medians (GB/s, ms per pass, ratio to read):" in res.stdout
    assert "\n  pc: " in res.stdout and "\n  fh21: " in res.stdout


def test_torchrun_cli_imports_no_jax(tmp_path):
    import contextlib
    import io

    from panacus_torch import testgraphs
    from panacus_torch.cli import run_cli

    gfa = str(tmp_path / "dryrun.gfa")
    testgraphs._write_dryrun_gfa(gfa)
    argv = ["hist", "-c", "all", "-S", gfa]
    env = dict(os.environ, PANACUS_TORCH_DEVICE="cpu", PYTHONPROFILEIMPORTTIME="1")
    res = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "panacus_torch", *argv],
        cwd=ROOT,
        env=env,
        capture_output=True,
        text=True,
        timeout=300,
    )
    assert res.returncode == 0, res.stderr[-4000:]
    imported = [
        l.rsplit("|", 1)[1].strip()
        for l in res.stderr.splitlines()
        if l.startswith("import time:") and "|" in l
    ]
    assert "panacus_torch.parallel.ingest" in imported
    bad = [m for m in imported if m.split(".")[0] in ("jax", "panacus_tpu")]
    assert not bad, bad
    assert "process group: rank 1 of 2, device collectives on gloo" in res.stderr
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert run_cli(argv, devices=("cpu",)) == 0

    def body(out):
        return [l for l in out.splitlines() if "\t" in l and not l.startswith("#")]

    assert body(res.stdout) == body(buf.getvalue()) and len(body(res.stdout)) > 5


def _port_sources():
    files = sorted(glob.glob(os.path.join(ROOT, "panacus_torch", "**", "*.py"), recursive=True))
    return files + [os.path.join(ROOT, "chip_smoke.py")]


def _imported_modules(path: str):
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.lineno, node.module


def test_port_sources_import_nothing_of_the_jax_package():
    files = _port_sources()
    assert len(files) > 20  # the scan sees the whole package
    assert {"ingest.py", "launch.py"} <= {
        os.path.basename(f) for f in files if os.sep + "parallel" + os.sep in f
    }
    bad = [
        f"{os.path.relpath(path, ROOT)}:{line}: {mod}"
        for path in files
        for line, mod in _imported_modules(path)
        if mod.split(".")[0] in FORBIDDEN
    ]
    assert not bad, bad


def test_ast_scan_catches_imports(tmp_path):
    """The scan sees plain, dotted, from- and nested imports."""
    src = tmp_path / "m.py"
    src.write_text(
        "import os\nimport jax.numpy as jnp\nfrom panacus_tpu.gfa import X\n"
        "def f():\n    import bench\n    from __graft_entry__ import _oracle\n"
        "from . import sibling\n"
    )
    found = [m.split(".")[0] for _, m in _imported_modules(str(src))]
    assert [m for m in found if m in FORBIDDEN] == [
        "jax", "panacus_tpu", "bench", "__graft_entry__"
    ]


@pytest.mark.parametrize("sizes", ["module", "arguments"])
@pytest.mark.parametrize("nodes,paths", [(3000, 90), (1200, 7)])
def test_make_graph_bytes_equal_bench(tmp_path, monkeypatch, nodes, paths, sizes):
    """The port's make_graph writes the bytes of bench.make_graph at the
    same size: by default at the module-level PANACUS_BENCH_NODES / _PATHS
    sizes, or at the sizes its n_nodes / n_paths arguments give."""
    import bench

    from panacus_torch import testgraphs

    for mod in (bench, testgraphs) if sizes == "module" else (bench,):
        monkeypatch.setattr(mod, "N_NODES", nodes)
        monkeypatch.setattr(mod, "N_PATHS", paths)
    assert testgraphs.GEN_VERSION == bench.GEN_VERSION
    want, got = tmp_path / "bench.gfa", tmp_path / "port.gfa"
    bench.make_graph(str(want))
    if sizes == "module":
        testgraphs.make_graph(str(got))
    else:
        testgraphs.make_graph(str(got), n_nodes=nodes, n_paths=paths)
    assert got.read_bytes() == want.read_bytes()


def test_dryrun_graph_and_oracles_equal_graft_entry(tmp_path):
    import __graft_entry__

    from panacus_torch import testgraphs

    assert testgraphs.DRYRUN_NODES == __graft_entry__.N_NODES
    assert testgraphs.DRYRUN_SAMPLES == __graft_entry__.N_SAMPLES
    want_in = __graft_entry__._write_dryrun_gfa(str(tmp_path / "want.gfa"))
    got_in = testgraphs._write_dryrun_gfa(str(tmp_path / "got.gfa"))
    assert (tmp_path / "got.gfa").read_bytes() == (tmp_path / "want.gfa").read_bytes()
    want = __graft_entry__._oracle(*want_in)
    got = testgraphs._oracle(*got_in)
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    node_mem = got[0]
    weights = np.arange(node_mem.shape[1], dtype=np.int64)
    for c_min, q in [(1, 0.0), (2, 0.5), (1, 1.0)]:
        np.testing.assert_array_equal(
            testgraphs._oracle_ordered(node_mem, weights, c_min, q),
            __graft_entry__._oracle_ordered(node_mem, weights, c_min, q),
        )
