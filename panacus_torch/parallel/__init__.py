"""Multi-process scale-out of the port on torch.distributed.

The one-process multi-device path lives in ops/engine.py (M split along
the item axis over a tuple of devices); this package holds the
multi-process ingest (parallel/ingest.py: each process tokenizes only its
group range, and M is assembled across processes) and the launcher that
the tests and chip_smoke.py start ranks with (parallel/launch.py). The
process group itself is runtime.init_distributed's.
"""
