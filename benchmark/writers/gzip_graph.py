"""The configuration's graph as one gzip member: generate.write_graph's plain
bytes for the seed, deflated at zlib level 6 as pigz writes a member.

The plain graph goes to a temporary file beside `path` first. Its bytes are
cut into BLOCK-byte blocks, each deflated on a thread of its own, primed
with the last 32 KiB of the block before it (`zdict`) and ended by a sync
flush, the last by a finish; the blocks' streams concatenated are one
deflate stream. The header carries no file name and mtime 0, the trailer
the CRC-32 and length of the plain bytes. A block's stream depends only on
its bytes and its dictionary, so the file depends only on the seed, never
on the thread count.

Facts: write_graph's (`gfa_bytes` stays the inflated size), `gz_bytes`,
and `gfa_sha256`, the digest of the plain bytes.
"""

from __future__ import annotations

import hashlib
import mmap
import os
import struct
import zlib
from concurrent.futures import ThreadPoolExecutor

from benchmark.generate import write_graph as write_plain

LEVEL = 6
BLOCK = 128 << 10
WINDOW = 32 << 10  # deflate's window: the dictionary a block is primed with
# magic, deflate, no flags, mtime 0, no extra flags at level 6, OS Unix
HEADER = b"\x1f\x8b\x08\x00" + struct.pack("<I", 0) + b"\x00\x03"


def _deflate(data, start: int, end: int) -> bytes:
    """The raw deflate stream of data[start:end], primed with the window
    before it, ended by a sync flush or (the last block) a finish."""
    view = memoryview(data)
    c = zlib.compressobj(LEVEL, zlib.DEFLATED, -zlib.MAX_WBITS, 8, zlib.Z_DEFAULT_STRATEGY,
                         view[max(0, start - WINDOW):start])
    last = end == len(data)
    return c.compress(view[start:end]) + c.flush(zlib.Z_FINISH if last else zlib.Z_SYNC_FLUSH)


def write_gzip(plain: str, path: str, threads: int = 0) -> str:
    """Write `plain` to `path` as one gzip member and fsync it; returns the
    sha256 hex digest of the plain bytes."""
    sha = hashlib.sha256()
    crc = 0
    with open(plain, "rb") as src, open(path, "wb") as out, \
            ThreadPoolExecutor(threads or os.cpu_count() or 1) as pool:
        size = os.fstat(src.fileno()).st_size
        if size == 0:
            raise ValueError(f"{plain} is empty")
        data = mmap.mmap(src.fileno(), 0, prot=mmap.PROT_READ)
        try:
            starts = range(0, size, BLOCK)
            out.write(HEADER)
            for start, deflated in zip(starts, pool.map(
                    lambda a: _deflate(data, a, min(a + BLOCK, size)), starts)):
                block = memoryview(data)[start:min(start + BLOCK, size)]
                sha.update(block)
                crc = zlib.crc32(block, crc)
                block.release()
                out.write(deflated)
            out.write(struct.pack("<II", crc, size & 0xFFFFFFFF))
        finally:
            data.close()
        out.flush()
        os.fsync(out.fileno())  # no write-back left for the timed window
    return sha.hexdigest()


def write_graph(cfg: dict, seed: int, path: str, threads: int = 0) -> dict:
    plain = path + ".plain"
    try:
        facts = write_plain(cfg, seed, plain, threads)
        facts["gfa_sha256"] = write_gzip(plain, path, threads)
    finally:
        if os.path.exists(plain):
            os.remove(plain)
    facts["gz_bytes"] = os.path.getsize(path)
    return facts
