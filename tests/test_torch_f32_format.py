"""The C layer's float32 formatter (`native/gfa_scan.c:pt_format_f32_table`
and `pt_format_f32`) against numpy's Dragon4 on the CPU.

Every cell must be byte-equal to `np.format_float_positional(x,
unique=True, trim="-")` with the trailing "." stripped (and "NaN", "inf",
"-inf"): every float32 power of two and the 8 values either side of it, a
seeded sample of bit patterns in [0, 1] and over the whole finite range,
the zeros, NaN and the infinities, and every quotient i / j with
0 <= i <= j <= 2048 as the similarity table rounds it. The `similarity`
TSV for -c node and -c bp equals panacus_tpu's and the per-cell writer's it
replaced (kept here as the oracle); `info`'s four average lines equal
panacus_tpu's.
"""

from __future__ import annotations

import numpy as np
import pytest

from panacus_torch import native
from panacus_torch.analyses import similarity
from panacus_torch.utils import fmt_f32
from test_torch_slice import _body, _run_both, graphs  # noqa: F401 (fixture)


def _oracle(x: np.float32) -> str:
    if np.isnan(x):
        return "NaN"
    if np.isinf(x):
        return "inf" if x > 0 else "-inf"
    s = np.format_float_positional(x, unique=True, trim="-")
    return s[:-1] if s.endswith(".") else s


def _native(bits: np.ndarray) -> list:
    """The formatter's text of each bit pattern, from one table row."""
    vals = np.ascontiguousarray(bits, dtype=np.uint32).view(np.float32)
    text = native.format_f32_table(vals.reshape(1, -1), [""])
    assert text.startswith("\t") and text.endswith("\n")
    return text[1:-1].split("\t")


def _check(bits: np.ndarray) -> None:
    bits = np.unique(np.asarray(bits, dtype=np.uint32))
    got = _native(bits)
    want = [_oracle(x) for x in bits.view(np.float32)]
    bad = [(hex(int(b)), g, w) for b, g, w in zip(bits, got, want) if g != w]
    assert not bad, (len(bad), bad[:10])


def _powers_of_two() -> np.ndarray:
    """Every float32 power of two, 2^-149 to 2^127, and the 8 bit patterns
    either side of each, both signs, where finite."""
    subnormal = [1 << k for k in range(23)]
    normal = [e << 23 for e in range(1, 255)]
    around = np.array(subnormal + normal, dtype=np.int64)[:, None] + np.arange(-8, 9)
    around = around[(around >= 0) & (around < 0x7F800000)]
    return np.concatenate([around, around | 0x80000000])


def _finite_range() -> np.ndarray:
    rng = np.random.default_rng(20232)
    magnitude = rng.integers(0, 0x7F800000, 2**16, dtype=np.uint32)
    return magnitude | (rng.integers(0, 2, 2**16, dtype=np.uint32) << np.uint32(31))


SAMPLES = {
    "powers_of_two": _powers_of_two,
    "unit_interval": lambda: np.random.default_rng(20231).integers(
        0, 0x3F800001, 2**20, dtype=np.uint32),
    "finite_range": _finite_range,
    "specials": lambda: np.array(
        [0, 0x80000000, 0x7F800000, 0xFF800000, 0x7FC00000, 0xFFC00000, 0x7F800001,
         0x7FFFFFFF, 1, 0x80000001, 0x7F7FFFFF, 0xFF7FFFFF, 0x3F800000, 0x00800000],
        dtype=np.uint32),
}


@pytest.mark.parametrize("sample", sorted(SAMPLES))
def test_the_formatter_equals_dragon4(sample):
    _check(SAMPLES[sample]())


def test_every_quotient_up_to_2048():
    """i / j for 0 <= i <= j <= 2048, divided in float64 and rounded to
    float32 as the similarity table's Jaccard is."""
    j = np.arange(1, 2049, dtype=np.int64)
    i, jj = np.meshgrid(np.arange(2049, dtype=np.int64), j)
    keep = i <= jj
    q = (i[keep] / jj[keep]).astype(np.float32)
    _check(q.view(np.uint32))


@pytest.mark.parametrize(
    "x",
    [0.1, 1 / 3, -2.5, 1e-45, 3.4028235e38, 1e39, -0.0, 0.0, float("nan"),
     float("-inf"), np.float32(0.7), np.float64(12345.678), 7],
    ids=repr,
)
def test_fmt_f32_is_the_one_value_call(x):
    with np.errstate(over="ignore"):  # 1e39 rounds to inf
        assert fmt_f32(x) == _oracle(np.float32(x))


def test_a_table_with_labels_of_any_length():
    vals = np.array([[1.0, 0.5, np.nan], [0.0, -0.0, np.inf], [1 / 3, 2 / 3, 1e-7]],
                    dtype=np.float32)
    labels = ["a", "", "HG00438#1 é"]
    want = "".join(
        label + "".join("\t" + _oracle(x) for x in row) + "\n" for label, row in zip(labels, vals)
    )
    assert native.format_f32_table(vals, labels) == want
    assert native.format_f32_table(np.zeros((0, 0), np.float32), []) == ""
    with pytest.raises(ValueError):
        native.format_f32_table(vals, labels[:2])


def _cell_by_cell(table, labels) -> str:
    """The writer's body before the C layer formatted it: one numpy scalar a
    cell."""
    out = []
    for i, row in enumerate(table):
        out.append(labels[i])
        for cell in row:
            out.append(f"\t{_oracle(np.float32(cell))}")
        out.append("\n")
    return "".join(out)


@pytest.mark.parametrize("graph", ["dryrun", "bench"])
@pytest.mark.parametrize("case", [
    ["similarity", "-c", "node", "-H"],
    ["similarity", "-c", "bp", "-H"],
    ["similarity", "-c", "node", "-S", "-m", "average"],
    ["similarity", "-c", "bp", "-S"],
], ids="_".join)
def test_similarity_tsv_equals_jax_and_the_cell_writer(capsys, monkeypatch, graphs, graph, case):  # noqa: F811
    pytest.importorskip("jax")
    bodies = []

    def spy(table, labels):
        body = native.format_f32_table(table, labels)
        assert body == _cell_by_cell(table, labels)
        bodies.append((table.shape, body))
        return body

    monkeypatch.setattr(similarity, "format_f32_table", spy)
    got = _run_both(capsys, monkeypatch, case + [str(graphs / f"{graph}.gfa")])
    ((shape, body),) = bodies
    assert shape[0] == shape[1] > 1
    assert _body(got).endswith(body + "\n")


@pytest.mark.parametrize("graph", ["dryrun", "bench"])
def test_info_average_lines_equal_jax(capsys, monkeypatch, graphs, graph):  # noqa: F811
    pytest.importorskip("jax")
    got = _run_both(capsys, monkeypatch, ["info", str(graphs / f"{graph}.gfa")])
    average = [line for line in got.splitlines() if "\taverage\t" in line]
    assert len(average) == 4, average
