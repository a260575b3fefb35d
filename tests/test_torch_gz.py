"""gzip input in the port: panacus_torch's gz ingest against panacus_tpu's.

The port inflates a `.gz` GFA into one buffer (libdeflate's whole-buffer
inflate where the system has it, else the zlib stream) and then indexes
that buffer as it indexes a plain file. It reads nothing behind the
inflate frontier: panacus_tpu's gz follower is not ported. On the CPU the
port must give what panacus_tpu gives: the inflated buffer, the
GraphStorage line and S products, every path's item runs, and the
`histgrowth -c node|all` TSVs apart from `#` lines (panacus_tpu with its
follower, with PANACUS_TPU_NO_GZ_OVERLAP=1, at `-t 1`, and both packages
on the zlib route). Inputs are built in the repo: testgraphs.make_graph,
and a generator of P/W graphs with integer (identity or sorted) or string
names. Shapes: one gzip member and several, CRLF with no trailing
newline, a late S line, a 0xff byte. The libdeflate cases skip where the
system has no libdeflate.
"""

from __future__ import annotations

import gzip
import logging

import numpy as np
import pytest

from panacus_torch import native, testgraphs
from panacus_torch.cli import run_cli as torch_cli
from panacus_torch.gfa import GraphStorage, _read_gz_streamed

HG = ["histgrowth", "-H", "-q", "0,0.5,1", "-l", "0,1,2"]


def gfa_text(n_nodes=20_000, n_paths=8, int_names=True, seed=11):
    """A GFA of P and W lines over n_nodes segments, with an L line for
    every step of a path; deterministic."""
    rng = np.random.default_rng(seed)
    lines = ["H\tVN:Z:1.0"]
    name = (lambda i: str(i + 1)) if int_names else (lambda i: f"s{i + 1}")
    for i in range(n_nodes):
        lines.append(f"S\t{name(i)}\t{'ACGT'[i % 4] * (1 + i % 7)}")
    walks = [
        (rng.integers(0, n_nodes, size=6000), rng.integers(0, 2, size=6000))
        for _ in range(n_paths)
    ]
    seen = set()
    for ids, ori in walks:
        for a, oa, b, ob in zip(ids[:-1], ori[:-1], ids[1:], ori[1:]):
            if (a, oa, b, ob) not in seen:
                seen.update({(a, oa, b, ob), (b, 1 - ob, a, 1 - oa)})
                lines.append(f"L\t{name(a)}\t{'+-'[oa]}\t{name(b)}\t{'+-'[ob]}\t0M")
    for p, (ids, ori) in enumerate(walks):
        if p % 2:
            body = "".join(("<" if o else ">") + name(i) for i, o in zip(ids, ori))
            lines.append(f"W\tsample{p // 2}\t1\tchr1\t0\t100\t{body}")
        else:
            body = ",".join(name(i) + ("-" if o else "+") for i, o in zip(ids, ori))
            lines.append(f"P\tsample{p // 2}#0#chr1\t{body}\t*")
    return ("\n".join(lines) + "\n").encode()


def sorted_names(data: bytes) -> bytes:
    """Rename node 1 to 900001 (integer names, no longer 1..n)."""
    for a, b in (
        (b"S\t1\t", b"S\t900001\t"),
        (b">1<", b">900001<"), (b"<1>", b"<900001>"), (b">1>", b">900001>"),
        (b"<1<", b"<900001<"), (b",1+", b",900001+"), (b",1-", b",900001-"),
        (b"\t1+", b"\t900001+"), (b"\t1-", b"\t900001-"),
        (b"L\t1\t", b"L\t900001\t"), (b"\t1\t+\t0M", b"\t900001\t+\t0M"),
        (b"\t1\t-\t0M", b"\t900001\t-\t0M"),
    ):
        data = data.replace(a, b)
    return data


def make_graph_bytes(tmp_path):
    gfa = tmp_path / "mg.gfa"
    testgraphs.make_graph(str(gfa), n_nodes=150_000, n_paths=6)
    return gfa.read_bytes()


SHAPES = {
    "identity": lambda t: gfa_text(),
    "sorted": lambda t: sorted_names(gfa_text(n_nodes=8_000)),
    "strings": lambda t: gfa_text(n_nodes=6_000, int_names=False),
    "late_s": lambda t: gfa_text(n_nodes=5_000, n_paths=4)
    + b"S\t5001\tACGT\nP\tlate#0#c\t5001+\t*\n",
    "crlf_no_final_newline": lambda t: gfa_text(n_nodes=3_000, n_paths=2)
    .replace(b"\n", b"\r\n")[:-2]
    + b"\r\nS\t3001\tACGT",
    "byte_ff": lambda t: gfa_text(n_nodes=3_000, n_paths=2).replace(b"S\t2\tC", b"S\t2\t\xff", 1),
    "make_graph": make_graph_bytes,
}
MEMBERS = {"identity": 1, "make_graph": 3}  # every other shape: one member


def write(tmp_path, data: bytes, members: int = 1, tag: str = "g"):
    plain, gz = tmp_path / f"{tag}.gfa", tmp_path / f"{tag}.gfa.gz"
    plain.write_bytes(data)
    step = -(-len(data) // members)
    with open(gz, "wb") as f:
        for k in range(members):
            f.write(gzip.compress(data[k * step : (k + 1) * step], 1))
    return str(plain), str(gz)


@pytest.fixture(scope="module", params=list(SHAPES))
def shape(request, tmp_path_factory):
    d = tmp_path_factory.mktemp(f"gz_{request.param}")
    data = SHAPES[request.param](d)
    plain, gz = write(d, data, 1, "one")
    out = {"name": request.param, "plain": plain, "gz": gz}
    if request.param in MEMBERS:
        out["gz_multi"] = write(d, data, 3, "multi")[1]
    return out


def _runs(batch):
    return None if batch is None else [np.asarray(x) for x in batch]


def storage_products(g):
    """What an index of a graph consists of, in plain numpy."""
    out = {
        "starts": np.asarray(g._line_starts),
        "ends": np.asarray(g._line_ends),
        "node_count": g.node_count,
        "node_lens": np.asarray(g.node_lens),
        "name_spans": [np.asarray(x) for x in g._name_spans],
        "int_mode": g._int_name_mode,
        "int_names": None if g._int_names is None else np.asarray(g._int_names),
        "paths": [str(s) for s in g.path_segments],
        "pw_spans": np.asarray(g._pw_seq_spans),
        "runs": _runs(g.all_path_item_runs()),
    }
    if out["int_mode"] == "sorted":
        out["sorted"] = [np.asarray(g._int_sorted), np.asarray(g._int_sorted_ids)]
    return out


def assert_products_equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        x, y = a[k], b[k]
        if isinstance(x, list) and x and isinstance(x[0], np.ndarray):
            assert len(x) == len(y), k
            for u, v in zip(x, y):
                np.testing.assert_array_equal(u, v, err_msg=k)
        elif isinstance(x, np.ndarray):
            np.testing.assert_array_equal(x, y, err_msg=k)
        else:
            assert x == y, k


def test_gz_index_equals_jax_and_plain(shape, caplog):
    """The port's GraphStorage of the gz file: products equal panacus_tpu's
    of the same file (its follower engaged where it can) and the port's
    of the plain file, with no warning."""
    pytest.importorskip("jax")
    from panacus_tpu.gfa import GraphStorage as JaxStorage

    with caplog.at_level(logging.INFO, logger="panacus"):
        caplog.clear()
        g = GraphStorage(shape["gz"], index_edges=False)
    assert not [r for r in caplog.records if r.levelno >= logging.WARNING]
    want = storage_products(JaxStorage(shape["gz"], index_edges=False))
    got = storage_products(g)
    assert_products_equal(got, want)
    assert_products_equal(got, storage_products(GraphStorage(shape["plain"], index_edges=False)))
    if "gz_multi" in shape:
        assert_products_equal(
            storage_products(GraphStorage(shape["gz_multi"], index_edges=False)), want
        )


def no_libdeflate(monkeypatch):
    """Both packages as on a system without libdeflate: the zlib stream."""
    import panacus_tpu.native as jax_native

    for mod in (native, jax_native):
        monkeypatch.setattr(mod, "_DEFLATE", None)
        monkeypatch.setattr(mod, "_DEFLATE_TRIED", True)


@pytest.mark.parametrize("route", ["libdeflate", "zlib"])
def test_inflated_buffer_equals_plain_and_jax(shape, route, monkeypatch, caplog):
    """Each inflate route gives the plain file's bytes, as panacus_tpu's
    does, for one member and several; the log names the route."""
    pytest.importorskip("jax")
    from panacus_tpu.gfa import _read_gz_streamed as jax_read

    if route == "zlib":
        no_libdeflate(monkeypatch)
    elif native._get_libdeflate() is None:
        pytest.skip("no system libdeflate: gz input takes the zlib stream (the zlib case)")
    plain = open(shape["plain"], "rb").read()
    for gz in [shape["gz"]] + ([shape["gz_multi"]] if "gz_multi" in shape else []):
        with caplog.at_level(logging.INFO, logger="panacus"):
            caplog.clear()
            buf = _read_gz_streamed(gz)
        assert bytes(buf) == plain == bytes(jax_read(gz))
        assert f"gz ingest: inflate by {route}" in caplog.text


def _body(out: str) -> str:
    return "".join(l for l in out.splitlines(True) if not l.startswith("#"))


@pytest.mark.parametrize(
    "extra,env",
    [([], None), (["-t", "1"], None), ([], "1"), ([], "zlib")],
    ids=["default", "t1", "no_overlap", "zlib"],
)
@pytest.mark.parametrize("count", ["node", "all"])
def test_histgrowth_tsv_equals_jax(shape, count, extra, env, capsys, monkeypatch, caplog):
    pytest.importorskip("jax")
    from panacus_tpu.cli import run_cli as jax_cli

    if env == "zlib":
        no_libdeflate(monkeypatch)
    elif env:  # panacus_tpu without its follower; the port has none
        monkeypatch.setenv("PANACUS_TPU_NO_GZ_OVERLAP", env)
    monkeypatch.setenv("PANACUS_TORCH_DEVICE", "cpu")
    files = [shape["gz"]] + ([shape["gz_multi"]] if "gz_multi" in shape else [])
    for gz in files:
        argv = HG + ["-c", count] + extra + [gz]
        assert jax_cli(argv) == 0
        want = _body(capsys.readouterr().out)
        with caplog.at_level(logging.INFO, logger="panacus"):
            caplog.clear()
            assert torch_cli(argv) == 0
        assert _body(capsys.readouterr().out) == want
        assert "gz ingest: inflate by " + ("zlib" if env == "zlib" else "") in caplog.text
    assert torch_cli(HG + ["-c", count] + extra + [shape["plain"]]) == 0
    assert _body(capsys.readouterr().out) == want
