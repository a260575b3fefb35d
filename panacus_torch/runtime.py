"""Runtime settings of the port: host threads and memory, the torch devices,
phase timing.

The host half (set_num_threads, effective_threads, configure_host_memory)
is panacus_tpu/runtime.py's; torch is imported only where the devices are
resolved, so the host layers that read the thread count do not load it.
"""

from __future__ import annotations

import logging
import os
import time

log = logging.getLogger("panacus")

DEVICE_ENV = "PANACUS_TORCH_DEVICE"

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


def resolve_devices():
    """The torch devices the membership matrices are split over, one item
    shard each: every visible GPU under PANACUS_TORCH_DEVICE=cuda (the
    default; CUDA_VISIBLE_DEVICES picks which), as indexed devices, or the
    CPU alone under PANACUS_TORCH_DEVICE=cpu. The default never falls back
    to the CPU: without a CUDA device it raises."""
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
    return tuple(torch.device("cuda", i) for i in range(torch.cuda.device_count()))


class phase_timer:
    """Wall-clock phase timing, logged at INFO as
    "phase <name> done; time elapsed: <s>s" (record args: name, seconds)."""

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        log.info(
            "phase %s done; time elapsed: %.3fs",
            self.name,
            time.perf_counter() - self._t0,
        )
        return False
