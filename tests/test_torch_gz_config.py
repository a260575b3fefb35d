"""The benchmark's configuration `pggb-chr22-gz` on the CPU: its graph as one
gzip member, the reference that reads it, and the port on it.

The configuration is cut here to 3,000 nodes and 8 haplotypes (4 diploid
samples), at a fixed seed. Its writer (benchmark/writers/gzip_graph.py) must
write one gzip member that inflates to generate.write_graph's plain bytes
for the seed, the same file for 1 and 4 threads; the reference module
(benchmark/reference/tables_gz.py) must hand the program a `.gfa.gz` inside
the run's directory and compute tables.py's table of the plain graph; the
port's `histgrowth` on the `.gfa.gz` must compare clean against it on both
inflate routes and write the plain file's TSV; a flipped byte in the deflate
stream and a file cut short must make both the command and the reference
raise. The float32 control fails at 150,000 nodes and 90 haplotypes (as
the harness's own control test: at 3,000 nodes float32 moves no floor).
The zlib route inflates a 22 MB member into the one buffer its length
sizes, and no more, and still takes a last member smaller than the first.
"""

from __future__ import annotations

import contextlib
import errno
import gzip
import hashlib
import io
import json
import logging
import os
import tracemalloc
import zlib

import pytest
import torch

from benchmark import generate
from benchmark.reference import tables, tables_gz
from panacus_torch import native
from panacus_torch.cli import run_cli
from panacus_torch.gfa import _read_gz_streamed

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(ROOT, "benchmark", "configs", "pggb-chr22-gz.json")
CPU = (torch.device("cpu"),)
SEED = 2**31 + 2525
EIGHT = [{"sample_prefix": "HG", "samples": 4, "haps": [1, 2], "seqid": "chr22"}]
with open(os.path.join(ROOT, "benchmark", "traffic", "hg-node-gz.json")) as _f:
    TRAFFIC = json.load(_f)
with open(os.path.join(ROOT, "benchmark", "limits", "pggb-chr22-gz.hg-node.json")) as _f:
    LIMITS = json.load(_f)


def _config(**changes) -> dict:
    with open(CONFIG) as f:
        cfg = json.load(f)
    cfg.update(changes)
    return cfg


def _argv(path: str):
    return [path if a == "{gfa_gz}" else a for a in TRAFFIC["argv"]]


def _written(tmp, cfg, threads):
    """(the plain graph's bytes and facts, {threads: (gz path, facts)})."""
    plain = str(tmp / "plain.gfa")
    plain_facts = generate.write_graph(cfg, SEED, plain, 2)
    with open(plain, "rb") as f:
        data = f.read()
    gz = {}
    for t in threads:
        path = str(tmp / f"gz{t}.gfa")  # the harness caches it under a .gfa name
        gz[t] = path, generate.writer(cfg)(cfg, SEED, path, t)
    return data, plain_facts, gz


@pytest.fixture(scope="module")
def graph(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("gzconfig")
    cfg = _config(n_nodes=3000, haplotypes=EIGHT)
    data, plain_facts, gz = _written(tmp, cfg, (1, 4))
    return {"tmp": tmp, "plain": data, "plain_path": str(tmp / "plain.gfa"),
            "plain_facts": plain_facts, "gz": gz}


def _inputs(graph, work):
    path, facts = graph["gz"][1]
    os.makedirs(work, exist_ok=True)
    return tables_gz.inputs(TRAFFIC, path, facts, str(work))["gfa_gz"]


def _cli(argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert run_cli(argv, devices=CPU) == 0
    return out.getvalue()


def _body(tsv: str):
    return [line for line in tsv.splitlines() if not line.startswith("#")]


def no_libdeflate(monkeypatch):
    monkeypatch.setattr(native, "_DEFLATE", None)
    monkeypatch.setattr(native, "_DEFLATE_TRIED", True)


@pytest.mark.parametrize("threads", [1, 4])
def test_the_writer_writes_one_member_of_the_plain_bytes(graph, threads):
    path, facts = graph["gz"][threads]
    with open(path, "rb") as f:
        member = f.read()
    d = zlib.decompressobj(zlib.MAX_WBITS | 16)
    assert d.decompress(member) == graph["plain"]
    assert d.eof and d.unused_data == b""
    assert member[:10] == b"\x1f\x8b\x08\x00\x00\x00\x00\x00\x00\x03"  # no name, mtime 0
    with open(graph["gz"][1][0], "rb") as f:
        assert member == f.read()  # the thread count changes no byte
    assert facts["gfa_sha256"] == hashlib.sha256(graph["plain"]).hexdigest()
    assert facts["gfa_bytes"] == len(graph["plain"])
    assert facts["gz_bytes"] == len(member) < len(graph["plain"])
    extra = {"gfa_sha256", "gz_bytes"}
    assert {k: v for k, v in facts.items() if k not in extra} == graph["plain_facts"]


@pytest.mark.parametrize("route", ["link", "copy"])
def test_inputs_names_a_gz_file_inside_work(graph, route, tmp_path, monkeypatch):
    """A hard link to the cached member, or a copy where the link would
    cross filesystems; never a symlink."""
    if route == "copy":
        def cross(src, dst):
            raise OSError(errno.EXDEV, "Invalid cross-device link")

        monkeypatch.setattr(os, "link", cross)
    path = _inputs(graph, tmp_path / "work")
    assert path.endswith(".gfa.gz") and not os.path.islink(path)
    assert os.path.dirname(path) == str(tmp_path / "work")
    cached = graph["gz"][1][0]
    assert os.path.samefile(path, cached) == (route == "link")
    with open(path, "rb") as a, open(cached, "rb") as b:
        assert a.read() == b.read()


def test_the_reference_reads_the_plain_graph(graph, tmp_path):
    path = _inputs(graph, tmp_path)
    want = tables.reference_tables(_argv(graph["plain_path"]))
    assert tables_gz.reference_tables(_argv(path)) == want
    assert sorted(os.listdir(tmp_path)) == sorted([os.path.basename(path),
                                                   os.path.basename(path) + tables_gz.DIGEST])


@pytest.mark.parametrize("route", ["libdeflate", "zlib"])
def test_the_port_on_the_gz_compares_clean(graph, route, tmp_path, monkeypatch, caplog):
    if route == "zlib":
        no_libdeflate(monkeypatch)
    elif native._get_libdeflate() is None:
        pytest.skip("no system libdeflate: gz input takes the zlib stream (the zlib case)")
    path = _inputs(graph, tmp_path)
    want = tables_gz.reference_tables(_argv(path))
    with caplog.at_level(logging.INFO, logger="panacus"):
        text = _cli(_argv(path))
    assert any(r.getMessage().startswith(f"gz ingest: inflate by {route}") for r in caplog.records)
    got = tables_gz.compare(text, want)
    assert all(v <= LIMITS[k] for k, v in got.items()), got
    assert _body(text) == _body(_cli(_argv(graph["plain_path"])))


def test_the_float32_control_fails(tmp_path):
    cfg = _config(n_nodes=150_000)
    _, _, gz = _written(tmp_path, cfg, (0,))
    path, facts = gz[0]
    argv = _argv(tables_gz.inputs(TRAFFIC, path, facts, str(tmp_path))["gfa_gz"])
    want = tables_gz.reference_tables(argv)
    exact = tables_gz.compare(tables_gz.write_tsv(want), want)
    control = tables_gz.compare(tables_gz.controls(argv, want)["float32"], want)
    assert all(v <= LIMITS.get(k, 0) for k, v in exact.items()), exact
    assert any(v > LIMITS.get(k, 0) for k, v in control.items()), control


def _flipped(member: bytes) -> bytes:
    at = len(member) // 2  # inside the deflate stream
    return member[:at] + bytes([member[at] ^ 0x5A]) + member[at + 1:]


def _cut(member: bytes) -> bytes:
    return member[: len(member) - 1000]


@pytest.mark.parametrize("route", ["libdeflate", "zlib"])
@pytest.mark.parametrize("damage", [_flipped, _cut], ids=["flipped", "cut"])
def test_a_damaged_member_makes_command_and_reference_raise(graph, damage, route, tmp_path,
                                                            monkeypatch):
    if route == "zlib":
        no_libdeflate(monkeypatch)
    elif native._get_libdeflate() is None:
        pytest.skip("no system libdeflate: gz input takes the zlib stream (the zlib case)")
    path = _inputs(graph, tmp_path)
    with open(path, "rb") as f:
        member = f.read()
    os.remove(path)  # the link's inode is the cached file's
    with open(path, "wb") as f:
        f.write(damage(member))
    with pytest.raises((OSError, EOFError, ValueError, zlib.error, gzip.BadGzipFile)):
        _cli(_argv(path))
    with pytest.raises((ValueError, zlib.error)):
        tables_gz.reference_tables(_argv(path))


def test_a_second_member_or_trailing_bytes_fail_the_reference(graph, tmp_path):
    """The reference holds the file to the configuration's one member."""
    path = _inputs(graph, tmp_path)
    with open(path, "rb") as f:
        member = f.read()
    for tail in (gzip.compress(b"", mtime=0), b"\0" * 8):
        os.remove(path)
        with open(path, "wb") as f:
            f.write(member + tail)
        with pytest.raises(ValueError, match="follow the one gzip member"):
            tables_gz.reference_tables(_argv(path))


@pytest.fixture(scope="module")
def big(tmp_path_factory):
    """The plain bytes at 150,000 nodes and 8 haplotypes (22 MB), as one
    member and as two, the second the last line alone (its length, which
    sizes the buffer, is then far below the whole)."""
    tmp = tmp_path_factory.mktemp("gzbig")
    plain = str(tmp / "plain.gfa")
    generate.write_graph(_config(n_nodes=150_000, haplotypes=EIGHT), SEED, plain, 2)
    with open(plain, "rb") as f:
        data = f.read()
    cut = data.rindex(b"\n", 0, len(data) - 1) + 1
    paths = {"one": tmp / "one.gfa.gz", "two": tmp / "two.gfa.gz"}
    paths["one"].write_bytes(gzip.compress(data, 1, mtime=0))
    paths["two"].write_bytes(gzip.compress(data[:cut], 1, mtime=0)
                             + gzip.compress(data[cut:], 1, mtime=0))
    return data, {k: str(v) for k, v in paths.items()}


@pytest.mark.parametrize("members", ["one", "two"])
def test_the_zlib_route_holds_one_buffer(big, members, monkeypatch):
    """One member fills the buffer its length sizes: the peak of the
    inflate's allocations is that buffer and a read's worth (a whole-buffer
    read held a temporary of 1.2x, and the buffer grew 1.5x at the end).
    Two members grow the buffer, and every byte arrives."""
    data, paths = big
    no_libdeflate(monkeypatch)
    tracemalloc.start()
    try:
        got = _read_gz_streamed(paths[members])
        peak = tracemalloc.get_traced_memory()[1]
    finally:
        tracemalloc.stop()
    assert got == data
    if members == "one":
        assert peak < len(data) + (8 << 20), (peak, len(data))
