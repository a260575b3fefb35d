"""panacus_torch: the PyTorch/CUDA port of panacus_tpu.

Counts pangenome coverage on an NVIDIA GPU (or, for tests, on the CPU)
with hand-written CUDA kernels. The host layers (GFA ingest and its C
library, masks, itemization, growth math, table writers) are the port's
own copies of panacus_tpu's, under the same module names. It imports
torch and never JAX or panacus_tpu. It runs all ten subcommands of
panacus_tpu (`python -m panacus_torch ...`) and its Python API
(`panacus_torch.api`).
"""

__version__ = "0.1.0"

_git_hash_cache: list = []


def git_hash():
    """Short git hash of the source tree, or None.

    The reference embeds GIT_HASH at compile time (build.rs:1-10) and uses
    it in TSV `# version` comments (src/io.rs:551). Resolved lazily: a
    `_build_info.py` written at package-build time wins (for installed
    wheels), else `git rev-parse --short HEAD` on the source checkout, and
    only when that checkout's panacus_torch directory is this package.
    Cached after the first call.
    """
    if _git_hash_cache:
        return _git_hash_cache[0]
    h = None
    try:
        from ._build_info import GIT_HASH as h  # type: ignore
    except Exception:
        import os
        import subprocess

        pkg_dir = os.path.dirname(os.path.abspath(__file__))
        try:
            top = subprocess.run(
                ["git", "rev-parse", "--show-toplevel"],
                cwd=pkg_dir,
                capture_output=True,
                timeout=5,
            )
            ok = False
            if top.returncode == 0:
                toplevel = os.path.realpath(top.stdout.decode().strip())
                # the repo's package must BE the imported package, not a
                # wheel installed in a venv nested inside some checkout
                ok = (
                    os.path.realpath(os.path.join(toplevel, "panacus_torch"))
                    == os.path.realpath(pkg_dir)
                )
            if ok:
                out = subprocess.run(
                    ["git", "rev-parse", "--short", "HEAD"],
                    cwd=pkg_dir,
                    capture_output=True,
                    timeout=5,
                )
                if out.returncode == 0:
                    h = out.stdout.decode().strip() or None
        except Exception:
            h = None
    _git_hash_cache.append(h)
    return h


def version_string():
    """`0.1.0-<shorthash>` when the hash is known, else `0.1.0`."""
    h = git_hash()
    return f"{__version__}-{h}" if h else __version__
