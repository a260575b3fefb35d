"""One run of a cell: inputs from the seed, warm-up, the timed window of CLI
commands, the comparison with the reference, and the result line.

A cell (BENCHMARK.json `workloads`) names a configuration and a traffic mix,
each a file of its own: configs/<config>.json (the graph's shape, read by
generate.py) and traffic/<traffic>.json (one panacus argv, {gfa} in the
place of the graph, and optionally the name of its reference module,
`"reference"`; `tables` without it). Any other `{name}` element of the
argv is a file that the reference module's `inputs` writes for the run.
The window is a closed loop: one `panacus_torch.cli.run_cli(argv, devices)`
after the other, stdout of each into a TSV of its own, until `seconds` have
passed; the command running at the close completes and counts. Every
command's TSV is then compared with the table of the traffic's reference
module (reference/<module>.py) under the limits of limits/<cell>.json.
End-to-end metrics come from the host clock (`setup_s` is process start to
the window less the making of the inputs, which the program's set-up has no
part in and which a kept graph skips); per-layer metrics from
metrics/<metric>.py, each a `read(run)` that returns a number or None.
"""

from __future__ import annotations

import contextlib
import gc
import hashlib
import importlib
import importlib.util
import json
import logging
import os
import re
import resource
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from dataclasses import dataclass, field
from types import ModuleType
from typing import Callable, Dict, List, Optional

from .trace import WINDOW, Trace

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
GRAPH_DIR = os.path.join(ROOT, "build", "benchmark", "graphs")
FORBIDDEN = ("jax", "jaxlib", "flax", "panacus_tpu")


def load_module(path: str):
    spec = importlib.util.spec_from_file_location(
        "benchmark_" + os.path.splitext(os.path.basename(path))[0].replace("-", "_").replace(".", "_"),
        path,
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reference_module(name: str) -> ModuleType:
    """benchmark/reference/<name>.py, the plain reference of a traffic mix.
    It provides:

    - parse_command(argv): the flags it takes; any other raises;
    - shape(argv, facts): the work of one command, for kernels/<kernel>.py;
    - reference_tables(argv, dtype=None): the expected table of the argv's GFA,
      exact, or (the control) computed in `dtype`;
    - write_tsv(table): the table as the program writes it;
    - compare(text, want): its own named numbers for one written table;
    - COMBINE: {number: "sum" or "max"}, how each combines over commands;
    - controls(argv, want): {control: its written table}, the controls that
      readings.py holds against the limits;
    - optionally inputs(traffic, gfa, facts, work): writes into `work` the
      files, other than the GFA, that the argv names, each made from the
      traffic file's own keys and the graph's facts (a report's YAML, an
      order file, an exclude file), and returns {placeholder: path}; each
      argv element `{placeholder}` becomes that path."""
    if not name.isidentifier():
        raise ValueError(f"no reference module {name!r}")
    return importlib.import_module(f"{__package__}.reference.{name}")


@dataclass
class Cell:
    name: str
    config_path: str
    traffic: dict
    chips: int = 1
    spec: dict = field(default_factory=dict)  # BENCHMARK.json

    @property
    def reference(self) -> ModuleType:
        return reference_module(self.traffic.get("reference", "tables"))

    @classmethod
    def load(cls, name: str, root: str = ROOT) -> "Cell":
        with open(os.path.join(root, "BENCHMARK.json")) as f:
            spec = json.load(f)
        (w,) = [w for w in spec["workloads"] if w["name"] == name]
        (c,) = [c for c in spec["configs"] if c["name"] == w["config"]]
        with open(os.path.join(HERE, "traffic", w["traffic"] + ".json")) as f:
            traffic = json.load(f)
        return cls(name, os.path.join(root, c["file"]), traffic, int(w["chips"]), spec)

    def limits(self) -> Dict[str, float]:
        with open(os.path.join(HERE, "limits", self.name + ".json")) as f:
            return json.load(f)

    def metrics(self, kind: str) -> List[dict]:
        """The cell's `end_to_end` or `per_layer` entries."""
        return [
            m for m in self.spec.get(kind, [])
            if self.name in m.get("workloads", [self.name])
        ]


@dataclass
class Inputs:
    argv: List[str]
    facts: dict
    mb: float  # uncompressed GFA MB (1e6 bytes)


def placeholder(arg: str) -> Optional[str]:
    """The name inside an argv element that reads `{name}`, else None."""
    m = re.fullmatch(r"\{([^{}]*)\}", arg)
    return m.group(1) if m else None


def prepare_inputs(cell: Cell, seed: int, graph_dir: str = GRAPH_DIR,
                   work: Optional[str] = None) -> Inputs:
    """Generate (in a child process) or reuse the seed's graph, read it
    through once (so that the page cache holds it however it was made), and
    fill in the traffic's argv: `{gfa}` with the graph, and the placeholders
    of the reference module's `inputs` with the files it writes into `work`
    (the run's own directory, removed with it). Raises on a placeholder left
    unfilled, before any command runs."""
    cmd = [sys.executable, os.path.join(HERE, "generate.py"), cell.config_path, str(seed), graph_dir]
    gfa = subprocess.run(cmd, check=True, stdout=subprocess.PIPE, text=True).stdout.strip()
    with open(gfa + ".json") as f:
        facts = json.load(f)
    with open(gfa, "rb") as f:
        while f.read(64 << 20):
            pass
    files = {"gfa": gfa}
    hook = getattr(cell.reference, "inputs", None)
    if hook is not None:
        if work is None:
            raise ValueError(f"cell {cell.name}: its reference module writes input files, "
                             "and prepare_inputs was given no work directory")
        made = hook(cell.traffic, gfa, facts, work)
        root = os.path.realpath(work)
        for name, path in made.items():
            if name == "gfa" or os.path.commonpath([root, os.path.realpath(path)]) != root:
                raise ValueError(f"cell {cell.name}: input {name!r} ({path}) is not a file in {work}")
        files.update(made)
    argv = [files.get(placeholder(a), a) for a in cell.traffic["argv"]]
    unfilled = [a for a in argv if placeholder(a) is not None]
    if unfilled:
        raise ValueError(f"cell {cell.name}: argv placeholders left unfilled: {' '.join(unfilled)}")
    return Inputs(argv, facts, facts["gfa_bytes"] / 1e6)


@dataclass
class Command:
    wall_s: float
    phases: Dict[str, float]  # summed seconds by phase name (nested ones too)
    in_phases_s: float  # seconds inside some phase
    tsv: str
    route: str  # the membership builds' route: "streamed" when every build streamed
    error: Optional[str] = None
    numbers: Dict[str, float] = field(default_factory=dict)  # the reference's compare


class PhaseSpans(logging.Handler):
    """The program's phases (runtime.phase_timer logs "phase <name> done;
    time elapsed: <s>s" as it closes one): (name, start, end) on the
    perf_counter clock."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.spans = []
        self.streamed = 0  # stream.py's "streamed membership build" records

    def emit(self, record):
        msg = str(record.msg)
        if msg.startswith("phase %s done"):
            name, seconds = record.args
            end = time.perf_counter()
            self.spans.append((name, end - seconds, end))
        elif msg.startswith("streamed membership build"):
            self.streamed += 1


@contextlib.contextmanager
def phase_spans():
    """A PhaseSpans on the "panacus" logger, at INFO inside the block."""
    log = logging.getLogger("panacus")
    handler, level = PhaseSpans(), log.level
    log.setLevel(logging.INFO)
    log.addHandler(handler)
    try:
        yield handler
    finally:
        log.removeHandler(handler)
        log.setLevel(level)


def covered_s(spans) -> float:
    """Seconds that the union of the (name, start, end) spans covers."""
    total, reach = 0.0, float("-inf")
    for _, a, b in sorted(spans, key=lambda t: t[1]):
        if b > reach:
            total += b - max(a, reach)
            reach = b
    return total


def run_commands(run_cli: Callable, argv, devices, seconds: float, out_dir: str,
                 tag: str = "w") -> List[Command]:
    """The closed loop: commands one after the other until `seconds` have
    passed (at least one); each writes its stdout to a TSV of its own."""
    done: List[Command] = []
    t_close = time.perf_counter() + seconds
    while not done or time.perf_counter() < t_close:
        path = os.path.join(out_dir, f"{tag}{len(done)}.tsv")
        error = None
        with open(path, "w") as out, phase_spans() as log, contextlib.redirect_stdout(out):
            t0 = time.perf_counter()
            try:
                run_cli(argv, devices=devices)
            except (Exception, SystemExit) as e:  # the run reports it as failed
                error = f"{type(e).__name__}: {e}"
            t1 = time.perf_counter()
        phases: Dict[str, float] = {}
        for name, a, b in log.spans:
            phases[name] = phases.get(name, 0.0) + (b - a)
        builds = sum(name == "abaci_by_total" for name, _, _ in log.spans)
        route = "streamed" if log.streamed == builds else f"{builds - log.streamed} of {builds} not streamed"
        done.append(Command(t1 - t0, phases, covered_s(log.spans), path, route, error))
    return done


@dataclass
class Run:
    """What a run measured; the per-layer readers take it."""

    cell: Cell
    inputs: Inputs
    commands: List[Command]
    window_s: float = 0.0
    trace: Optional[Trace] = None
    card: Optional[str] = None

    def ok(self) -> List[Command]:
        return [c for c in self.commands if c.error is None]

    def gfa_mbps(self) -> float:
        """GFA MB of every command completed without error, over the window."""
        return len(self.ok()) * self.inputs.mb / self.window_s

    def phase_ms(self, name: str) -> Optional[float]:
        """Mean ms of the phase over the commands that ran it, or None."""
        hits = [c.phases[name] for c in self.ok() if name in c.phases]
        return 1e3 * statistics.fmean(hits) if hits else None

    def shape(self) -> dict:
        """The work of one command, from the argv and the graph's facts, as
        the cell's reference module reads them."""
        return self.cell.reference.shape(self.inputs.argv, self.inputs.facts)

    def roofline(self, kernel: str) -> Optional[float]:
        """% of the least time by bytes (kernels/<kernel>.py's count, each
        input read once and each output written once, for every command of
        the window) at the card's HBM peak (peaks.json), against the
        kernel's device time summed over the trace; None without a trace, a
        known peak or a launch of the kernel."""
        with open(os.path.join(HERE, "peaks.json")) as f:
            peak = json.load(f).get(self.card or "", {}).get("hbm_bytes_per_s")
        if self.trace is None or not peak:
            return None
        k = load_module(os.path.join(HERE, "kernels", kernel + ".py"))
        seconds, launches = self.trace.device_time_s(k.matches)
        if launches == 0:
            return None
        least = len(self.ok()) * k.least_bytes(self.shape()) / peak
        return 100.0 * least / seconds


def read_metric(name: str, run: Run) -> Optional[float]:
    return load_module(os.path.join(HERE, "metrics", name + ".py")).read(run)


def compare_outputs(commands: List[Command], ref: ModuleType, want) -> Dict[str, float]:
    """The numbers of `ref.compare` over every command (each distinct TSV
    read once), each summed or the largest as `ref.COMBINE` says; `errors`
    counts the commands that raised. Each command keeps its own numbers."""
    out: Dict[str, float] = {"errors": 0}
    out.update({k: 0 if how == "sum" else 0.0 for k, how in ref.COMBINE.items()})
    seen: Dict[str, Dict[str, float]] = {}
    for c in commands:
        if c.error is not None:
            out["errors"] += 1
            continue
        with open(c.tsv, "rb") as f:
            data = f.read()
        key = hashlib.sha256(data).hexdigest()
        if key not in seen:
            seen[key] = ref.compare(data.decode(), want)
        r = seen[key]
        for k, how in ref.COMBINE.items():
            out[k] = out[k] + r[k] if how == "sum" else max(out[k], r[k])
        c.numbers = r
    return out


def command_failed(c: Command, limits: Dict[str, float]) -> bool:
    if c.error is not None:
        return True
    return any(v > limits.get(k, 0) for k, v in c.numbers.items())


def host_peak_rss_mb() -> float:
    """The peak resident memory of this process (not of its children), MB
    (1e6 bytes): getrusage's ru_maxrss, in KiB on Linux."""
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024 / 1e6


def host_mem_mbps() -> float:
    """MB/s of touching 64 MB of fresh pages (a diagnostic, as
    panacus_torch.bench reads it): about 2000 and more on a healthy host,
    under 500 where the host's page faults are slow."""
    n = 64 << 20
    t0 = time.perf_counter()
    b = bytearray(n)
    mv = memoryview(b)
    for i in range(0, n, 4096):
        mv[i] = 1
    dt = time.perf_counter() - t0
    del mv, b
    return n / 1e6 / dt


def card_facts():
    """(nvidia-smi's name, power limit, SM clock and temperature of the
    cards, the first card's power limit in W or None)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,temperature.gpu",
             "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=60, check=True,
        ).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi: {e}", None
    try:
        limit = float(out.splitlines()[0].split(",")[1])
    except (IndexError, ValueError):
        limit = None
    return out.replace("\n", " | "), limit


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def quiet_program_logs() -> None:
    """A root handler at WARNING, so that run_cli's logging.basicConfig adds
    no INFO handler of its own: the phases still reach runtime.phase_log's
    handler, and stderr stays for the run's own lines."""
    root = logging.getLogger()
    if not root.handlers:
        h = logging.StreamHandler(sys.stderr)
        h.setLevel(logging.WARNING)
        root.addHandler(h)


def say(msg: str) -> None:
    sys.stderr.write(f"[benchmark] {msg}\n")
    sys.stderr.flush()


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, devices, t_process: float,
             graph_dir: str = GRAPH_DIR) -> dict:
    """Set-up, window, comparison; returns the result object (the last line
    of the run's stdout). `devices`: the cell's own, as run_cli takes them."""
    import torch

    from panacus_torch import cli

    quiet_program_logs()
    dev0 = devices[0]
    on_card = dev0.type == "cuda"
    work = tempfile.mkdtemp(prefix="benchmark-")
    try:
        t0 = time.perf_counter()
        inputs = prepare_inputs(cell, seed, graph_dir, work)
        t_inputs = time.perf_counter() - t0
        say(f"cell {cell.name}, seed {seed}: inputs in {t_inputs:.3f} s, "
            f"{inputs.mb:.3f} MB GFA; argv {' '.join(inputs.argv)}")
        warm = run_commands(cli.run_cli, inputs.argv, devices, 0, work, "u")
        say("warm-up walls " + " ".join(f"{c.wall_s:.4f}" for c in warm)
            + "".join(f"; error {c.error}" for c in warm if c.error))
        if on_card:
            torch.cuda.synchronize(dev0)
            torch.cuda.reset_peak_memory_stats(dev0)
        gc.collect()
        smi, power_limit_w = card_facts() if on_card else ("no card", None)
        say(f"host: {os.cpu_count()} cores, {len(os.sched_getaffinity(0))} usable, "
            f"fresh-page touch {host_mem_mbps():.0f} MB/s; card: {smi}")
        profiler = contextlib.nullcontext()
        if trace:
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
            profiler = profile(activities=acts)
        with profiler as prof:
            # the window's clock runs once the profiler has started, and stops
            # before it collects its trace
            t_open = time.perf_counter()
            with torch.profiler.record_function(WINDOW):
                commands = run_commands(cli.run_cli, inputs.argv, devices, seconds, work)
            t_close = time.perf_counter()
        window_s = t_close - t_open
        rss_mb = host_peak_rss_mb()
        memory_peak = int(torch.cuda.max_memory_allocated(dev0)) if on_card else 0
        run = Run(cell, inputs, commands, window_s,
                  Trace.from_profiler(prof) if trace else None,
                  torch.cuda.get_device_name(dev0) if on_card else None)
        if trace:
            names = sorted({d[0][:60] for d in run.trace.device})
            say(f"trace: {len(run.trace.device)} device activities "
                f"({len(names)} names: {'; '.join(names[:8])}), "
                f"{len(run.trace.scopes)} host scopes")
        del prof
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()
        found = forbidden_modules()
        if found:
            raise SystemExit(f"modules of JAX or the JAX package are loaded: {', '.join(found)}")

        t_ref = time.perf_counter()
        ref = cell.reference
        want = ref.reference_tables(inputs.argv)
        numbers = compare_outputs(commands, ref, want)
        t_ref = time.perf_counter() - t_ref
        limits = cell.limits()
        checks = {k: {"value": v, "limit": limits[k]} for k, v in numbers.items()}
        correct = all(v <= limits[k] for k, v in numbers.items())
        failed = sum(command_failed(c, limits) for c in commands)
        walls = [c.wall_s for c in commands]
        routes = {r: sum(c.route == r for c in commands) for r in sorted({c.route for c in commands})}
        say(f"window {window_s:.4f} s, {run.gfa_mbps():.4f} GFA MB/s, {len(commands)} commands (routes: "
            + ", ".join(f"{r} {n}" for r, n in routes.items())
            + "), walls " + " ".join(f"{w:.4f}" for w in walls))
        say(f"reference and comparison in {t_ref:.3f} s; set-up {t_open - t_process - t_inputs:.3f} s "
            f"(and the inputs, made or reused apart, {t_inputs:.3f} s)")

        metrics = {}
        kind = "per_layer" if trace else "end_to_end"
        values = {
            "setup_s": t_open - t_process - t_inputs,
            "gfa_mbps": run.gfa_mbps(),
            "host_peak_rss_mb": rss_mb,
        }
        for m in cell.metrics(kind):
            v = read_metric(m["name"], run) if trace else values.get(m["name"])
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        device = {
            "platform": "gpu" if on_card else dev0.type,
            "kind": run.card or str(dev0),
            "count": len(set(devices)),
            "memory_peak_bytes": memory_peak,
        }
        if power_limit_w is not None:
            device["power_limit_w"] = power_limit_w
        result = {
            "correct": correct,
            "attempted": len(commands),
            "failed": failed,
            "metrics": metrics,
            "device": device,
        }
        if trace:
            device["busy_s"] = run.trace.busy_s()
            device["window_s"] = run.trace.window_s
            result["breakdown"] = {
                "device_ops": run.trace.top_device_ops(),
                "idle_gaps": run.trace.idle_gaps(),
            }
        result["checks"] = checks
        for k, c in checks.items():
            say(f"check {k}: {c['value']!r} (limit {c['limit']!r})")
        return result
    finally:
        shutil.rmtree(work, ignore_errors=True)
