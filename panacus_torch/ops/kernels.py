"""Build, bind and count the port's hand-written CUDA kernels.

Each source under panacus_torch/csrc is compiled with nvcc for Hopper
(sm_90a) at first use into its own library in build/panacus_torch_kernels/
beside the package, under a name that hashes the source, the headers of
csrc and the flags; a rebuilt source never loads a stale library. The
libraries have a plain C interface and are loaded with ctypes: importing
this module needs neither nvcc nor a GPU. `build_all` starts one nvcc per
source at once.

`launches` counts each entry point's launches, one per successful call of
`launch`, so a run can show that its path went through the kernels.
`query` asks a library for the size of a kernel's scratch (no kernel, not
counted).
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import time
from dataclasses import dataclass
from typing import Dict, Iterable

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG_DIR, "csrc")
SOURCES = {
    "hist": os.path.join(CSRC, "hist.cu"),
    "group": os.path.join(CSRC, "group.cu"),
    "probe": os.path.join(CSRC, "probe.cu"),
    "parse": os.path.join(CSRC, "parse.cu"),
}
BUILD_DIR = os.path.join(
    os.path.dirname(_PKG_DIR), "build", "panacus_torch_kernels"
)
NVCC_FLAGS = [
    "-gencode",
    "arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-shared",
    "-Xcompiler",
    "-fPIC",
    "-Xptxas",
    "-v",
]

_P = ctypes.c_void_p
_I64 = ctypes.c_longlong
_I32 = ctypes.c_int
# entry point -> (source, argtypes)
_SIGNATURES = {
    # (M, n_words, n_items_pad, cov, stream)
    "pt_coverage": ("hist", [_P, _I64, _I64, _P, _P]),
    # (M, n_words, n_items_pad, W, n_vecs, n_bins, out, stream)
    "pt_fused_hist": ("hist", [_P, _I64, _I64, _P, _I32, _I32, _P, _P]),
    # (M, n_words, n_items_pad, n_groups, W, thr, c_min, diff, out, stream)
    "pt_ordered_growth": (
        "group",
        [_P, _I64, _I64, _I32, _P, _P, _I32, _P, _P, _P],
    ),
    # (M, n_words, n_items_pad, W, n_planes, part, part_elems, out, stream)
    "pt_similarity": ("group", [_P, _I64, _I64, _P, _I32, _P, _I64, _P, _P]),
    # (chunk, n_bytes, descs, n_descs, M, row_stride, node_lens, n_items,
    #  acc, n_spans, stream)
    "pt_parse_pack": (
        "parse",
        [_P, _I64, _P, _I64, _P, _I64, _P, _I64, _P, _I64, _P],
    ),
    # (text, n_bytes, descs, n_descs, M, row_stride, row_off, adj_ent,
    #  n_items, err, stream)
    "pt_parse_pack_edges": (
        "parse",
        [_P, _I64, _P, _I64, _P, _I64, _P, _P, _I64, _P, _P],
    ),
    # (M, n_words, n_items, W, salt, scratch, stream)
    "pt_xor_fold": ("probe", [_P, _I64, _I64, _P, _I32, _P, _P]),
    # (M, n_words, n_items, W, salt, op, mma_cov, out, stream)
    "pt_word_fold": ("probe", [_P, _I64, _I64, _P, _I32, _I32, _I32, _P, _P]),
    # (M, n_words, n_items, W, n_vecs, n_limbs, n_coarse, weight_coarse,
    #  mma_cov, salt, max_blocks, out, stream)
    "pt_limb_hist": (
        "probe",
        [_P, _I64, _I64, _P, _I32, _I32, _I32, _I32, _I32, _I32, _I32, _P, _P],
    ),
}
# scratch sizes (no kernel): name -> (source, argtypes)
_QUERIES = {
    # (n_words, n_items_pad, n_planes, *part_elems)
    "pt_similarity_scratch": ("group", [_I64, _I64, _I32, ctypes.POINTER(_I64)]),
}

launches = {name: 0 for name in _SIGNATURES}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


@dataclass(frozen=True)
class Build:
    lib: ctypes.CDLL
    seconds: float  # nvcc time; 0.0 when the library was already built
    log: str  # nvcc/ptxas output (registers, shared memory, spills)


_builds: Dict[str, Build] = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (put the CUDA toolkit on PATH); the CUDA kernels "
        "of panacus_torch are built from source at first use"
    )


def _lib_path(source: str) -> str:
    h = hashlib.sha256()
    headers = sorted(glob.glob(os.path.join(CSRC, "*.cuh")))
    for path in [SOURCES[source], *headers]:
        with open(path, "rb") as f:
            h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"{source}-{h.hexdigest()[:16]}.so")


def _load(source: str, path: str, seconds: float, log: str) -> Build:
    lib = ctypes.CDLL(path)
    for name, (src, argtypes) in {**_SIGNATURES, **_QUERIES}.items():
        if src == source:
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    lib.pt_error_string.argtypes = [ctypes.c_int]
    lib.pt_error_string.restype = ctypes.c_char_p
    return Build(lib, seconds, log)


def build_all(sources: Iterable[str] = tuple(SOURCES)) -> Dict[str, Build]:
    """Compile (once per hash) and load the libraries of `sources`; the nvcc
    runs of all sources not yet built go at once."""
    sources = list(sources)
    jobs = {}
    for source in sources:
        if source in _builds:
            continue
        path = _lib_path(source)
        if os.path.exists(path):
            jobs[source] = (path, None, None, 0.0)
            continue
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{path}.{os.getpid()}.tmp"
        proc = subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", tmp, SOURCES[source]],
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
            text=True,
        )
        jobs[source] = (path, tmp, proc, time.perf_counter())
    done = {}
    for source, (path, tmp, proc, t0) in jobs.items():
        seconds, log = 0.0, ""
        if proc is not None:  # wait for every nvcc before raising
            log = proc.communicate()[0]
            seconds = time.perf_counter() - t0
        done[source] = (seconds, log)
    for source, (path, tmp, proc, _) in jobs.items():
        seconds, log = done[source]
        if proc is not None:
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {SOURCES[source]}:\n{log}")
            os.replace(tmp, path)
        _builds[source] = _load(source, path, seconds, log)
    return {source: _builds[source] for source in sources}


def _call(name: str, source: str, *args) -> None:
    lib = build_all([source])[source].lib
    rc = getattr(lib, name)(*args)
    if rc != 0:
        msg = lib.pt_error_string(rc).decode()
        raise RuntimeError(f"{name} failed: CUDA error {rc} ({msg})")


def launch(name: str, *args) -> None:
    """Call one kernel entry point; raise on a non-zero CUDA error code."""
    _call(name, _SIGNATURES[name][0], *args)
    launches[name] += 1


def query(name: str, *args) -> None:
    """Call one scratch-size function; raise on a non-zero CUDA error code."""
    _call(name, _QUERIES[name][0], *args)
