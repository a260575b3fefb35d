"""The histgrowth reference (tables.py) for a graph given as one gzip member:
the configuration `pggb-chr22-gz`, whose writer caches the member under the
harness's `.gfa` name.

`inputs` hands the program the cached bytes under a `.gfa.gz` name in the
run's directory (the program and upstream panacus both tell gzip by the
suffix), with the plain bytes' sha256 from the graph's facts beside it.
`reference_tables` inflates the file on its own (zlib in its gzip mode,
which checks the member's CRC-32 and length), requires one member and
nothing after it, requires the inflated bytes' sha256 to be the plain
graph's, and computes tables.py's exact table from those bytes. The
comparison, its numbers and their limits are tables.py's.
"""

from __future__ import annotations

import errno
import hashlib
import os
import shutil
import tempfile
import zlib
from typing import Dict, List

import numpy as np

from .gfa import read_gfa
from .tables import COMBINE, Table, compare, expected, parse_command, shape, write_tsv  # noqa: F401

DIGEST = ".sha256"  # beside the .gfa.gz: the plain bytes' sha256, hex


def inputs(traffic: dict, gfa: str, facts: dict, work: str) -> Dict[str, str]:
    """{"gfa_gz": <work>/<name>.gfa.gz}: a hard link to the cached member,
    or a copy (fsynced) where the link would cross filesystems; never a
    symlink, which would resolve outside `work`."""
    path = os.path.join(work, os.path.basename(gfa) + ".gz")
    try:
        os.link(gfa, path)
    except OSError as e:
        if e.errno != errno.EXDEV:
            raise
        with open(gfa, "rb") as src, open(path, "wb") as dst:
            shutil.copyfileobj(src, dst, 16 << 20)
            dst.flush()
            os.fsync(dst.fileno())
    with open(path + DIGEST, "w") as f:
        f.write(facts["gfa_sha256"])
    return {"gfa_gz": path}


def inflate(path: str) -> bytes:
    """The plain bytes of the one gzip member at `path`; raises where the
    member is cut short, fails its CRC-32 or length, is followed by more
    bytes, or inflates to other bytes than the plain graph's digest."""
    with open(path, "rb") as f:
        data = f.read()
    d = zlib.decompressobj(zlib.MAX_WBITS | 16)  # gzip: header, CRC-32 and length checked
    plain = d.decompress(data)
    if not d.eof:
        raise ValueError(f"{path}: the gzip member is cut short")
    if d.unused_data:
        raise ValueError(f"{path}: {len(d.unused_data)} bytes follow the one gzip member")
    with open(path + DIGEST) as f:
        digest = f.read().strip()
    if hashlib.sha256(plain).hexdigest() != digest:
        raise ValueError(f"{path}: the inflated bytes are not the plain graph's (sha256)")
    return plain


def reference_tables(argv: List[str], dtype=None) -> Table:
    cmd = parse_command(argv)
    plain = inflate(cmd.gfa)
    with tempfile.NamedTemporaryFile(dir=os.path.dirname(os.path.abspath(cmd.gfa)),
                                     suffix=".gfa") as f:
        f.write(plain)
        f.flush()
        del plain
        g = read_gfa(f.name)
    return expected(cmd, g, dtype)


def controls(argv: List[str], want: Table) -> Dict[str, str]:
    return {"float32": write_tsv(reference_tables(argv, np.float32))}
