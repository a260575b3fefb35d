"""The group slice (ordered-histgrowth, similarity, table): panacus_torch
against panacus_tpu.

Each case runs one command line through panacus_tpu.cli.run_cli and
through panacus_torch.cli.run_cli on the CPU; stdout must be byte-equal
apart from `#` comment lines. The graphs, BED files and group file are
those of tests/test_torch_slice.py (its `graphs` fixture), plus an order
file that reverses the samples. The cases cover -c node|bp|edge, grouping
-S/-H/-g, several thresholds, -O, subset- and exclude-masked runs (the
classic itemizer, covered-bp weights), several clustering methods and the
total table.
"""

from __future__ import annotations

import pytest

from test_torch_slice import _run_both, graphs  # noqa: F401 (fixture)

CASES = [
    ["ordered-histgrowth", "-c", "node", "-S"],
    ["ordered-histgrowth", "-c", "bp", "-H", "-q", "0,0.5,1", "-l", "1,1,2"],
    ["ordered-histgrowth", "-c", "edge", "-g", "{groups}", "-q", "0,1", "-l", "1,2"],
    ["ordered-histgrowth", "-c", "node", "-S", "-O", "{order}", "-q", "0.3", "-l", "2"],
    ["ordered-histgrowth", "-c", "bp", "-S", "-s", "{subset}", "-e", "{exclude}"],
    ["ordered-histgrowth", "-c", "edge", "-S", "-s", "{subset}", "-q", "0,0.5"],
    ["similarity", "-c", "node", "-S"],
    ["similarity", "-c", "bp", "-H", "-m", "average"],
    ["similarity", "-c", "edge", "-S", "-m", "single"],
    ["similarity", "-c", "bp", "-S", "-m", "ward", "-s", "{subset}", "-e", "{exclude}"],
    ["table", "-c", "node", "-S"],
    ["table", "-c", "bp", "-H"],
    ["table", "-c", "edge", "-S"],
    ["table", "-c", "node", "-H", "-a"],
    ["table", "-c", "bp", "-S", "-s", "{subset}", "-e", "{exclude}"],
]


@pytest.fixture(scope="module")
def order_files(graphs):  # noqa: F811
    """Order files naming the samples of each graph in reverse."""
    n_samples = {"dryrun": 4, "bench": 45}
    for graph, n in n_samples.items():
        (graphs / f"order_{graph}.txt").write_text(
            "".join(f"s{k}\n" for k in reversed(range(n)))
        )
    return graphs


@pytest.mark.parametrize("graph", ["dryrun", "bench"])
@pytest.mark.parametrize("case", CASES, ids=["_".join(c) for c in CASES])
def test_group_slice_matches_jax(capsys, monkeypatch, order_files, graph, case):
    pytest.importorskip("jax")
    d = order_files
    argv = [
        a.format(
            subset=d / "subset.bed",
            exclude=d / "exclude.bed",
            groups=d / "groups.tsv",
            order=d / f"order_{graph}.txt",
        )
        for a in case
    ]
    _run_both(capsys, monkeypatch, argv + [str(d / f"{graph}.gfa")])
