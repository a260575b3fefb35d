"""Start the ranks of a multi-process run on this host, as torchrun starts
them, and run several CLI commands in one rank process.

`launch(cmd, n_ranks)` starts n_ranks copies of `cmd` with torchrun's
environment (RANK, WORLD_SIZE, LOCAL_RANK, LOCAL_WORLD_SIZE, MASTER_ADDR,
MASTER_PORT on a free localhost port). When a rank exits non-zero it kills
the others and raises; when the ranks outlive `timeout` it kills them all
and raises. A failed run is tried once more on a fresh port (two launches
may race for one port). The tests and chip_smoke.py launch their
ranks with it; a user runs torchrun:

    torchrun --nproc-per-node 2 -m panacus_torch histgrowth -c all -H graph.gfa

`python -m panacus_torch.parallel.launch REPORT COMMANDS_JSON` is one
rank's worker: it runs each argv of the JSON list through
cli.run_cli in this process (one process group for all of them) and
writes REPORT.<rank>.json: the rank, the world size, its devices, the
backend of the device collectives and, per command, what it wrote to
stdout, its wall (ending in a device synchronize), its phase_timer
phases, the kernel launches it made, and the path payload bytes this
process tokenized out of the total (from the multi-process build's log
line; null where the command built no abacus that way).
"""

from __future__ import annotations

import contextlib
import io
import json
import logging
import os
import socket
import subprocess
import sys
import tempfile
import time
from typing import Dict, List, Optional, Sequence, Tuple

from ..runtime import PhaseLog


class RankFailure(RuntimeError):
    """A rank exited non-zero, or the ranks outlived their time limit."""


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _start(cmd, n_ranks, port, env, cwd, logs):
    procs = []
    for rank in range(n_ranks):
        e = dict(os.environ if env is None else env)
        e.update(
            MASTER_ADDR="127.0.0.1",
            MASTER_PORT=str(port),
            RANK=str(rank),
            WORLD_SIZE=str(n_ranks),
            LOCAL_RANK=str(rank),
            LOCAL_WORLD_SIZE=str(n_ranks),
        )
        out, err = logs[rank]
        procs.append(subprocess.Popen(list(cmd), env=e, cwd=cwd, stdout=out, stderr=err))
    return procs


def _run_once(cmd, n_ranks, env, cwd, timeout):
    """(return codes, stdouts, stderrs, timed_out) of one start."""
    with contextlib.ExitStack() as stack:
        logs = [
            tuple(stack.enter_context(tempfile.TemporaryFile("w+")) for _ in "oe")
            for _ in range(n_ranks)
        ]
        procs = _start(cmd, n_ranks, free_port(), env, cwd, logs)
        deadline = time.monotonic() + timeout
        timed_out = False
        try:
            while True:
                rcs = [p.poll() for p in procs]
                if any(rc not in (None, 0) for rc in rcs) or all(rc == 0 for rc in rcs):
                    break
                if time.monotonic() > deadline:
                    timed_out = True
                    break
                time.sleep(0.05)
        finally:
            for p in procs:  # a failed rank leaves the others in a collective
                if p.poll() is None:
                    p.kill()
            for p in procs:
                p.wait()
        texts = []
        for out, err in logs:
            out.seek(0)
            err.seek(0)
            texts.append((out.read(), err.read()))
    rcs = [p.returncode for p in procs]
    return rcs, [t[0] for t in texts], [t[1] for t in texts], timed_out


def launch(
    cmd: Sequence[str],
    n_ranks: int,
    env: Optional[Dict[str, str]] = None,
    cwd: Optional[str] = None,
    timeout: float = 600.0,
) -> List[Tuple[str, str]]:
    """Run n_ranks ranks of `cmd`; returns each rank's (stdout, stderr),
    in rank order, when every rank exits 0. Raises RankFailure otherwise,
    after one more try on a fresh port."""
    for _ in range(2):
        rcs, outs, errs, timed_out = _run_once(cmd, n_ranks, env, cwd, timeout)
        if not timed_out and all(rc == 0 for rc in rcs):
            return list(zip(outs, errs))
    what = f"timed out after {timeout:.0f} s" if timed_out else f"exit codes {rcs}"
    tails = "\n".join(
        f"--- rank {r} stderr (last 3000 bytes) ---\n{e[-3000:]}" for r, e in enumerate(errs)
    )
    raise RankFailure(f"{n_ranks} ranks of {list(cmd)}: {what}\n{tails}")


# -- one rank's worker ---------------------------------------------------------


class _RunLog(PhaseLog):
    """Collects the phase_timer phases and the multi-process build's
    payload share (its log line ends in "<mine> of <total> path payload
    bytes")."""

    def __init__(self):
        super().__init__()
        self.payload: Optional[List[int]] = None

    def emit(self, record):
        super().emit(record)
        if str(record.msg).startswith("multi-process build") and self.payload is None:
            self.payload = [int(record.args[-2]), int(record.args[-1])]


def run_commands(report: str, commands: List[List[str]]) -> None:
    import torch

    from ..cli import run_cli
    from ..ops import kernels
    from ..runtime import device_backend, resolve_devices, shutdown_distributed, world

    logging.getLogger("panacus").setLevel(logging.INFO)
    cards = {d for d in resolve_devices() if d.type == "cuda"}
    results = []
    try:
        for argv in commands:
            handler = _RunLog()
            logging.getLogger("panacus").addHandler(handler)
            before = dict(kernels.launches)
            buf = io.StringIO()
            t0 = time.perf_counter()
            try:
                with contextlib.redirect_stdout(buf):
                    rc = run_cli(argv)
                for d in cards:
                    torch.cuda.synchronize(d)
            finally:
                logging.getLogger("panacus").removeHandler(handler)
            if rc != 0:
                raise SystemExit(f"{argv} exited {rc}")
            results.append(
                {
                    "argv": argv,
                    "out": buf.getvalue(),
                    "wall": time.perf_counter() - t0,
                    "phases": handler.phases,
                    "launches": {k: kernels.launches[k] - before[k] for k in kernels.launches},
                    "payload": handler.payload,
                }
            )
        rank, size = world()
        info = {
            "rank": rank,
            "world_size": size,
            "devices": [str(d) for d in resolve_devices()],
            "backend": device_backend(),
            "commands": results,
        }
    finally:
        shutdown_distributed()
    with open(f"{report}.{rank}.json", "w") as f:
        json.dump(info, f)


if __name__ == "__main__":
    with open(sys.argv[2]) as f:
        run_commands(sys.argv[1], json.load(f))
