"""The port's slices run without JAX: a fresh interpreter runs
`histgrowth -c all`, `ordered-histgrowth`, `similarity` and `table` through
panacus_torch on the CPU and must finish with no `jax` module loaded."""

from __future__ import annotations

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = """
import sys
from panacus_torch.cli import run_cli
for argv in (
    ["histgrowth", "-c", "all", "-S", "-q", "0,1", "-l", "1,2"],
    ["ordered-histgrowth", "-c", "bp", "-S", "-q", "0,0.5", "-l", "1,2"],
    ["similarity", "-c", "edge", "-H"],
    ["table", "-c", "node", "-S"],
):
    rc = run_cli(argv + [sys.argv[1]])
    assert rc == 0, (argv, rc)
loaded = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax."))
assert not loaded, loaded
print("NO_JAX_OK")
"""


def test_slice_imports_no_jax(tmp_path):
    import __graft_entry__

    gfa = tmp_path / "dryrun.gfa"
    __graft_entry__._write_dryrun_gfa(str(gfa))
    env = dict(os.environ, PANACUS_TORCH_DEVICE="cpu")
    res = subprocess.run(
        [sys.executable, "-c", SCRIPT, str(gfa)],
        cwd=ROOT,
        env=env,
        capture_output=True,
        text=True,
        timeout=300,
    )
    assert res.returncode == 0, res.stderr[-4000:]
    assert "NO_JAX_OK" in res.stdout
    assert "panacus\tgrowth" in res.stdout
    assert "panacus\tordered-growth" in res.stdout
    assert res.stdout.count("\ngroup\t") == 1  # the similarity table
    assert "\nnode\ts0\t" in res.stdout  # the coverage table
