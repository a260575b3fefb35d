"""Runtime settings of the port: host threads and memory, the torch devices
of this process, the process group of a multi-process run, phase timing
and spans.

The host half (set_num_threads, effective_threads, configure_host_memory)
is panacus_tpu/runtime.py's; torch is imported only where the devices or
the process group are resolved, so the host layers that read the thread
count do not load it.

A multi-process run is launched as torchrun launches it: every process
gets RANK, WORLD_SIZE, LOCAL_RANK, LOCAL_WORLD_SIZE, MASTER_ADDR and
MASTER_PORT. `init_distributed` joins the process group (the counterpart
of panacus_tpu/parallel/ingest.py:init_distributed on jax.distributed);
the collectives below are the engine's and the ingest's.
"""

from __future__ import annotations

import contextlib
import itertools
import logging
import os
import sys
import threading
import time
from datetime import timedelta
from typing import List, NamedTuple, Optional

log = logging.getLogger("panacus")

DEVICE_ENV = "PANACUS_TORCH_DEVICE"
# a rank that dies leaves the others in a collective: they fail after this
DIST_TIMEOUT = timedelta(minutes=10)

_NUM_THREADS = 0  # 0 = all cores


def set_num_threads(n: int) -> None:
    """Host-side worker thread count (CLI -t; 0 = all cores), the analogue
    of the reference's rayon pool size (src/lib.rs:55-67): it bounds the
    tokenizer thread pool; device parallelism is unaffected."""
    global _NUM_THREADS
    _NUM_THREADS = max(int(n), 0)
    log.info("running panacus on %d host threads", effective_threads())


def effective_threads() -> int:
    if _NUM_THREADS > 0:
        return _NUM_THREADS
    return os.cpu_count() or 1


_HEAP_CONFIGURED = False


def configure_host_memory() -> None:
    """Two host-memory mitigations for ballooned/lazy-memory VMs
    (firecracker with free-page reporting), where every fresh private-anon
    4 KiB page fault can cost ~0.3 ms — 12 MB/s effective:

    1. mallopt: keep freed large blocks in the process heap instead of
       returning them to the OS, so steady-state non-numpy temps reuse
       already-faulted pages.
    2. A custom numpy data allocator (native/npalloc.c via
       PyDataMem_SetHandler): large arrays come from 2 MiB-aligned mmap
       regions advised MADV_HUGEPAGE with a bounded reuse cache, so the
       one-shot CLI's first touches fault huge pages.

    Disable the allocator with PANACUS_TPU_NO_HUGEPAGES=1."""
    global _HEAP_CONFIGURED
    if _HEAP_CONFIGURED:
        return
    _HEAP_CONFIGURED = True
    try:
        import ctypes
        import ctypes.util

        libc = ctypes.CDLL(ctypes.util.find_library("c") or "libc.so.6")
        M_TRIM_THRESHOLD = -1
        M_MMAP_THRESHOLD = -3
        M_MMAP_MAX = -4
        M_ARENA_MAX = -8
        libc.mallopt(M_MMAP_MAX, 0)
        libc.mallopt(M_MMAP_THRESHOLD, 1 << 30)
        libc.mallopt(M_TRIM_THRESHOLD, 1 << 30)
        # one arena: worker-thread frees land back on the main heap where
        # the next pass's allocations (any thread) can reuse the pages —
        # non-main arenas trim to the OS and re-fault on a ballooned VM
        libc.mallopt(M_ARENA_MAX, 1)
    except Exception as e:  # pragma: no cover
        log.debug("mallopt tuning unavailable: %s", e)
    try:
        from .native import install_hugepage_allocator

        install_hugepage_allocator()
    except Exception as e:  # pragma: no cover
        log.debug("hugepage allocator unavailable: %s", e)


# HBM peak of each card, GB/s, by device-name prefix (NVIDIA's data sheets):
# the H100 SXM part, as torch.cuda.get_device_name names it, and the PCIe part
_HBM_PEAK_GBPS = {
    "NVIDIA H100 80GB HBM3": 3350,
    "NVIDIA H100 PCIe": 2000,
}


def hbm_peak_bytes_per_s(name: str) -> "float | None":
    """The HBM peak in bytes/s of the card named `name`
    (torch.cuda.get_device_name), or None for a card the table does not
    know. The longest matching prefix wins, as in panacus_tpu's table."""
    best = None
    for prefix, gbps in _HBM_PEAK_GBPS.items():
        if name.startswith(prefix) and (best is None or len(prefix) > best[0]):
            best = (len(prefix), gbps)
    return best[1] * 1e9 if best else None


def _local_rank():
    """(LOCAL_RANK, LOCAL_WORLD_SIZE) as torchrun sets them; (0, 1) outside
    a multi-process run."""
    return (
        int(os.environ.get("LOCAL_RANK", "0")),
        int(os.environ.get("LOCAL_WORLD_SIZE", "1")),
    )


def resolve_devices():
    """The torch devices this process splits its membership matrices over,
    one item shard each: under PANACUS_TORCH_DEVICE=cuda (the default;
    CUDA_VISIBLE_DEVICES picks the cards) this local rank's contiguous
    share of the visible GPUs (all of them in a one-process run), as
    indexed devices; with fewer GPUs than local ranks, local rank r takes
    cuda:(r % n) and the ranks share cards. Under PANACUS_TORCH_DEVICE=cpu
    every rank takes the CPU alone. The default never falls back to the
    CPU: without a CUDA device it raises."""
    import torch

    want = os.environ.get(DEVICE_ENV, "cuda")
    if want == "cpu":
        return (torch.device("cpu"),)
    if want != "cuda":
        raise ValueError(f"{DEVICE_ENV} must be 'cuda' or 'cpu', got {want!r}")
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"no CUDA device is available; set {DEVICE_ENV}=cpu to count on "
            "the CPU"
        )
    n = torch.cuda.device_count()
    r, n_local = _local_rank()
    if n_local > n:
        return (torch.device("cuda", r % n),)
    return tuple(
        torch.device("cuda", i) for i in range(r * n // n_local, (r + 1) * n // n_local)
    )


# -- the process group of a multi-process run ----------------------------------
#
# Device collectives (M's exchange, the int64 partials, the coverage blocks)
# run on the backend the layout allows: NCCL when every rank has cards of its
# own, gloo otherwise (the CPU, or ranks that share a card: NCCL cannot hold
# two ranks of one communicator on one GPU). Host payloads (counts, bitmaps,
# triplets, path lengths) go over a gloo group in every layout.

_HOST_GROUP = None  # the gloo group of host payloads, set by init_distributed


def init_distributed() -> bool:
    """Join the process group when torchrun's environment names more than
    one process (WORLD_SIZE > 1); returns whether this is a multi-process
    run. Call it before the first device touch. Idempotent."""
    global _HOST_GROUP
    if int(os.environ.get("WORLD_SIZE", "1")) <= 1:
        return False
    import torch
    import torch.distributed as tdist

    if tdist.is_initialized():
        return True
    devices = resolve_devices()
    n_local = _local_rank()[1]
    shared = devices[0].type == "cuda" and n_local > torch.cuda.device_count()
    backend = "nccl" if devices[0].type == "cuda" and not shared else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(devices[0])
    # env:// reads RANK, WORLD_SIZE, MASTER_ADDR and MASTER_PORT; a failure
    # to bring NCCL up raises (no retry on another backend)
    tdist.init_process_group(backend, init_method="env://", timeout=DIST_TIMEOUT)
    _HOST_GROUP = (
        tdist.new_group(backend="gloo", timeout=DIST_TIMEOUT)
        if backend == "nccl"
        else tdist.group.WORLD
    )
    log.info(
        "process group: rank %d of %d, device collectives on %s%s, host "
        "payloads on gloo; devices %s",
        tdist.get_rank(),
        tdist.get_world_size(),
        backend,
        " (ranks share a card)" if shared else "",
        ", ".join(map(str, devices)),
    )
    return True


def shutdown_distributed() -> None:
    """Leave the process group, if this process joined one."""
    global _HOST_GROUP
    import torch.distributed as tdist

    if tdist.is_available() and tdist.is_initialized():
        tdist.destroy_process_group()
    _HOST_GROUP = None


def world():
    """(rank, world size) of this process: (0, 1) outside a multi-process run."""
    import torch.distributed as tdist

    if tdist.is_available() and tdist.is_initialized():
        return tdist.get_rank(), tdist.get_world_size()
    return 0, 1


def device_backend() -> str:
    """The backend of the device collectives: "nccl", "gloo", or "" outside
    a multi-process run."""
    import torch.distributed as tdist

    if tdist.is_available() and tdist.is_initialized():
        return tdist.get_backend()
    return ""


def comm_device():
    """Where the device collectives take their tensors: this rank's card
    under NCCL, the host under gloo."""
    import torch

    if device_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def all_reduce_sum(t):
    """The elementwise sum of `t` over every rank (t itself in one process),
    on the host."""
    import torch.distributed as tdist

    if world()[1] == 1:
        return t.cpu()
    t = t.to(comm_device())
    tdist.all_reduce(t)
    return t.cpu()


def all_gather_cat(t):
    """Every rank's `t` (equal shapes) concatenated along dim 0 in rank
    order, on the host."""
    import torch
    import torch.distributed as tdist

    size = world()[1]
    if size == 1:
        return t.cpu()
    t = t.to(comm_device()).contiguous()
    parts = [torch.empty_like(t) for _ in range(size)]
    tdist.all_gather(parts, t)
    return torch.cat(parts).cpu()


def host_all_gather(t):
    """Every rank's host tensor `t` (equal shapes), a list in rank order,
    over the gloo group."""
    import torch
    import torch.distributed as tdist

    if world()[1] == 1:
        return [t]
    parts = [torch.empty_like(t) for _ in range(world()[1])]
    tdist.all_gather(parts, t.contiguous(), group=_HOST_GROUP)
    return parts


# -- spans --------------------------------------------------------------------
#
# A span is a named stretch of the program: a phase (phase_timer), a part of
# one, or the L-line indexer's job on its worker thread. A span records only
# while torch.profiler is active, which torch.autograd._profiler_enabled()
# tells on the calling thread; otherwise it does nothing. The profiler is not
# visible on a thread the program starts, so a span there records when the
# code that handed it the work passed on `handoff()`. The records stay in
# memory, in one buffer of SPAN_CAPACITY spans allocated on the first record;
# spans that do not fit are counted, not kept. Times are time.time_ns(), the
# clock of the profiler's host events. On a thread the profiler sees, a span
# also opens a record_function of its name, so a trace shows it.

SPAN_CAPACITY = 65536


class SpanRecord(NamedTuple):
    name: str
    id: int
    parent: Optional[int]  # the id of the span that caused it
    command: int  # the id of the outermost span of its tree (cli's `command`)
    thread: int  # threading.get_ident()
    start_ns: int
    end_ns: int
    counts: dict


_span_ids = itertools.count(1)
_span_stacks = threading.local()  # the open spans of each thread
_span_lock = threading.Lock()
_span_capacity = SPAN_CAPACITY
_span_buffer: Optional[list] = None
_span_n = 0
_span_dropped = 0
_span_drop_ns = (0, 0)  # the first and the last dropped span's end


def _open_spans() -> list:
    stack = getattr(_span_stacks, "stack", None)
    if stack is None:
        stack = _span_stacks.stack = []
    return stack


def _profiler_sees() -> bool:
    torch = sys.modules.get("torch")
    return torch is not None and torch.autograd._profiler_enabled()


def _keep(rec: SpanRecord) -> None:
    global _span_buffer, _span_n, _span_dropped, _span_drop_ns
    with _span_lock:
        if _span_n < _span_capacity:
            if _span_buffer is None:
                _span_buffer = [None] * _span_capacity
            _span_buffer[_span_n] = rec
            _span_n += 1
            return
        _span_drop_ns = (_span_drop_ns[0] if _span_dropped else rec.end_ns, rec.end_ns)
        _span_dropped += 1


class span:
    """A named span of the program, `with span(name, **counts) as sp:`.
    `sp.add(**counts)` adds to its counts; `handoff` is what `handoff()`
    gave the thread that handed this one its work."""

    def __init__(self, name: str, handoff: Optional[tuple] = None, **counts):
        self.name = name
        self.counts = counts
        self._handoff = handoff

    def __enter__(self):
        seen = _profiler_sees()
        self.on = seen or self._handoff is not None
        if not self.on:
            return self
        stack = _open_spans()
        if self._handoff is not None:
            self._parent, command = self._handoff
        elif stack:
            self._parent, command = stack[-1].id, stack[-1].command
        else:
            self._parent, command = None, None
        self.id = next(_span_ids)
        self.command = self.id if command is None else command
        stack.append(self)
        self._scope = sys.modules["torch"].profiler.record_function(self.name) if seen else None
        # the clock is read just before the twin stamps its start and its
        # end: the op that stamps them lets go of the GIL, and waiting to
        # take it back (behind the L-line indexer's thread) would otherwise
        # fall between the two stamps
        self._t0 = time.time_ns()
        if seen:
            self._scope.__enter__()
        return self

    def __exit__(self, *exc):
        if not self.on:
            return False
        t1 = time.time_ns()
        if self._scope is not None:
            self._scope.__exit__(*exc)
        _open_spans().pop()
        _keep(SpanRecord(self.name, self.id, self._parent, self.command,
                         threading.get_ident(), self._t0, t1, self.counts))
        return False

    def add(self, **counts) -> None:
        if self.on:
            for k, v in counts.items():
                self.counts[k] = self.counts.get(k, 0) + v


def handoff() -> Optional[tuple]:
    """What a span on another thread needs to record as a child of this
    thread's innermost open span: None while no profiler is active."""
    if not _profiler_sees():
        return None
    stack = _open_spans()
    return (stack[-1].id, stack[-1].command) if stack else (None, None)


def add_counts(**counts) -> None:
    """Add to the counts of this thread's innermost open span, if it records."""
    stack = _open_spans()
    if stack:
        stack[-1].add(**counts)


def spans(start_ns: Optional[int] = None, end_ns: Optional[int] = None) -> List[SpanRecord]:
    """The recorded spans that lie within [start_ns, end_ns], in the order
    they closed."""
    lo = -1 if start_ns is None else start_ns
    hi = float("inf") if end_ns is None else end_ns
    with _span_lock:
        kept = _span_buffer[:_span_n] if _span_buffer else []
    return [r for r in kept if lo <= r.start_ns and r.end_ns <= hi]


def spans_dropped(start_ns: Optional[int] = None, end_ns: Optional[int] = None) -> int:
    """The spans that did not fit in the record; with a window, 0 when none
    of them ended inside it. (Once the record is full every span drops, so
    the count is that of every drop since.)"""
    with _span_lock:
        dropped, (first, last) = _span_dropped, _span_drop_ns
    if not dropped:
        return 0
    if (start_ns is not None and last < start_ns) or (end_ns is not None and first > end_ns):
        return 0
    return dropped


def reset_spans(capacity: int = SPAN_CAPACITY) -> None:
    """Empty the record and give it `capacity` spans."""
    global _span_capacity, _span_buffer, _span_n, _span_dropped, _span_drop_ns
    with _span_lock:
        _span_capacity = capacity
        _span_buffer, _span_n, _span_dropped, _span_drop_ns = None, 0, 0, (0, 0)


class phase_timer(span):
    """A span that also logs its wall time at INFO as
    "phase <name> done; time elapsed: <s>s" (record args: name, seconds),
    whether or not a profiler is active."""

    def __enter__(self):
        super().__enter__()
        self._p0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        seconds = time.perf_counter() - self._p0
        super().__exit__(*exc)
        log.info("phase %s done; time elapsed: %.3fs", self.name, seconds)
        return False


class PhaseLog(logging.Handler):
    """Sums the seconds of phase_timer's records by phase name."""

    def __init__(self):
        super().__init__()
        self.phases = {}

    def emit(self, record):
        if str(record.msg).startswith("phase %s done"):
            name, seconds = record.args
            self.phases[name] = self.phases.get(name, 0.0) + seconds


@contextlib.contextmanager
def phase_log():
    """The phase_timer seconds of the block, {name: s}: a PhaseLog on the
    "panacus" logger, set to INFO inside the block (the records reach no
    other handler unless the caller set one up), its level restored after."""
    handler = PhaseLog()
    level = log.level
    log.setLevel(logging.INFO)
    log.addHandler(handler)
    try:
        yield handler.phases
    finally:
        log.removeHandler(handler)
        log.setLevel(level)
