"""The port's multi-process ingest helpers and K9, the assembly of M across
processes (panacus_torch/parallel/ingest.py), the counterpart of
tests/test_ingest.py on in-repo graphs.

- The pure helpers (host_path_slice, group_cuts, words_of_range,
  word_slots, _partition_groups) equal panacus_tpu's on random inputs.
- Partitioning the paths and OR-merging the partial matrices equals the
  one-process build, the port's and panacus_tpu's, and its histogram
  equals the numpy oracle.
- K9 on real 2- and 3-process gloo groups (the __main__ block below is a
  rank's worker): every rank's shards, put side by side, equal
  merge_partials of the processes' partial matrices bit for bit, with
  bit 31 (group 31 of a word, the int32 sign bit) set in every word and
  words shared by two or three processes; CountingEngine.build from every
  occurrence pair gives each rank the same shards; the coverage
  all_gather and the hist all_reduce equal numpy's.
- The visit positions of the covered-bp merge raise past their range.
"""

import json
import os
import sys

import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)

# (n_groups, cuts, shards per rank): the cut falls inside word 1 of 90
# groups (wpp2 = 2); inside words 0 and 1 of 40 groups over three ranks
K9_CASES = {
    2: (90, [0, 45, 90], [2, 1]),
    3: (40, [0, 13, 30, 40], [1, 1, 2]),
}
K9_ITEMS = 70_000


def _membership(n_groups, n_items, seed=11):
    """Random bool [n_groups, n_items + 1]: group g % 32 == 31 (bit 31)
    visits most items, the sentinel column is empty."""
    rng = np.random.default_rng(seed)
    mem = rng.random((n_groups, n_items + 1)) < 0.3
    mem[np.arange(n_groups) % 32 == 31] |= rng.random((1, n_items + 1)) < 0.9
    mem[:, 0] = False
    return mem


def _pack(mem, groups, n_words, n_pad):
    """uint32 [n_words, n_pad] with the bits of `groups` only."""
    M = np.zeros((n_words, n_pad), dtype=np.uint32)
    for g in groups:
        M[g >> 5, : mem.shape[1]] |= mem[g].astype(np.uint32) << np.uint32(g & 31)
    return M


def _k9_worker(report):
    sys.path.insert(0, REPO)
    import torch

    from panacus_torch.ops.engine import CountingEngine
    from panacus_torch.parallel.ingest import assemble_global_matrix, word_slots, words_of_range
    from panacus_torch.runtime import init_distributed, shutdown_distributed, world

    assert init_distributed()
    rank, size = world()
    n_groups, cuts, shards = K9_CASES[size]
    n_words = (n_groups + 31) // 32
    try:
        eng = CountingEngine(K9_ITEMS, n_groups, ("cpu",) * shards[rank])
        mem = _membership(n_groups, K9_ITEMS)
        mine = words_of_range(cuts[rank], cuts[rank + 1])
        wpp2 = max(len(words_of_range(cuts[p], cuts[p + 1])) for p in range(size))
        full = _pack(mem, range(cuts[rank], cuts[rank + 1]), n_words, eng.n_items_pad)
        rows = np.zeros((wpp2, eng.n_items_pad), dtype=np.uint32)
        rows[: len(mine)] = full[mine.start : mine.stop]
        assemble_global_matrix(rows, word_slots(cuts, n_words, wpp2), eng)
        block = torch.cat([m for m in eng.shards], dim=1).numpy().view(np.uint32)
        # the same M from every (group, item) pair: each rank keeps its items'
        groups, items = np.nonzero(mem)
        built = CountingEngine(K9_ITEMS, n_groups, ("cpu",) * shards[rank]).build(items, groups)
        built = torch.cat([m for m in built.shards], dim=1).numpy().view(np.uint32)
        w = np.arange(K9_ITEMS + 1, dtype=np.int64) % 7
        w[0] = 0
        out = {
            "rank": rank,
            "item_lo": eng.item_lo,
            "n_items_pad": eng.n_items_pad,
            "block": block.tolist(),
            "built_equal": bool(np.array_equal(built, block)),
            "coverage": eng.coverage().tolist(),
            "hist": eng.hist(w).tolist(),
        }
    finally:
        shutdown_distributed()
    with open(f"{report}.{rank}.json", "w") as f:
        json.dump(out, f)


# -- the pure helpers against panacus_tpu's ------------------------------------


def test_host_path_slice_partitions():
    from panacus_tpu.parallel import ingest as tpu

    from panacus_torch.parallel import ingest as pt

    for n, k in [(6, 2), (7, 3), (1, 4), (0, 2), (90, 8)]:
        parts = [pt.host_path_slice(n, h, k) for h in range(k)]
        assert np.concatenate(parts).tolist() == list(range(n))
        for h in range(k):
            np.testing.assert_array_equal(parts[h], tpu.host_path_slice(n, h, k))


@pytest.mark.parametrize("seed", range(4))
def test_cuts_and_slots_equal_panacus_tpu(seed):
    from panacus_tpu.parallel import ingest as tpu

    from panacus_torch.parallel import ingest as pt

    rng = np.random.default_rng(seed)
    for _ in range(40):
        n_groups = int(rng.integers(1, 300))
        n_proc = int(rng.integers(1, 9))
        payload = rng.integers(0, 1000, size=n_groups).astype(np.int64)
        cuts = pt.group_cuts(payload, n_proc)
        assert cuts == tpu.group_cuts(payload, n_proc)
        for p in range(n_proc):
            assert pt.words_of_range(cuts[p], cuts[p + 1]) == tpu.words_of_range(
                cuts[p], cuts[p + 1]
            )
        n_words = (n_groups + 31) // 32
        wpp2 = max(len(pt.words_of_range(cuts[p], cuts[p + 1])) for p in range(n_proc)) or 1
        np.testing.assert_array_equal(
            pt.word_slots(cuts, n_words, wpp2), tpu.word_slots(cuts, n_words, wpp2)
        )


def test_group_cuts_balanced_hprc_shape():
    """90 haplotype groups over 8 processes (the HPRC shape that starves a
    whole-word partition) give every process a payload share; the slots
    name each word's contributors exactly once."""
    from panacus_torch.parallel.ingest import group_cuts, word_slots, words_of_range

    rng = np.random.default_rng(3)
    for n_groups, n_proc in [(90, 8), (40, 2), (3, 4), (128, 3), (1, 2)]:
        payload = rng.integers(1, 1000, size=n_groups).astype(np.int64)
        cuts = group_cuts(payload, n_proc)
        assert cuts[0] == 0 and cuts[-1] == n_groups
        assert all(cuts[i] <= cuts[i + 1] for i in range(n_proc))
        total = payload.sum()
        shares = [payload[cuts[p] : cuts[p + 1]].sum() / total for p in range(n_proc)]
        assert max(shares) <= 1.0 / n_proc + payload.max() / total + 1e-9
        if n_groups >= n_proc:
            assert all(cuts[p] < cuts[p + 1] for p in range(n_proc)), cuts
        n_words = (n_groups + 31) // 32
        wpp2 = max(len(words_of_range(cuts[p], cuts[p + 1])) for p in range(n_proc)) or 1
        slots = word_slots(cuts, n_words, wpp2)
        assert (slots[:, 0] >= 0).all()
        flat = slots[slots >= 0]
        assert len(np.unique(flat)) == len(flat)
        for w in range(n_words):
            want = {
                p
                for p in range(n_proc)
                if cuts[p] < cuts[p + 1]
                and cuts[p] < min((w + 1) * 32, n_groups)
                and cuts[p + 1] > w * 32
            }
            assert {int(s) // wpp2 for s in slots[w] if s >= 0} == want


def _graphs(tmp_path):
    """The in-repo dryrun graph, tests/test_multihost.py's fixture, and the
    dryrun graph with a ',' after the last step of its first P line (the C
    tokenizer refuses it, the per-path parse takes it)."""
    from test_multihost import _write_fixture

    from panacus_torch import testgraphs

    dry = str(tmp_path / "dryrun.gfa")
    testgraphs._write_dryrun_gfa(dry)
    mh = str(tmp_path / "mh.gfa")
    _write_fixture(mh)
    lines = open(dry).read().splitlines()
    i = next(k for k, l in enumerate(lines) if l.startswith("P\t"))
    f = lines[i].split("\t")
    f[2] += ","
    lines[i] = "\t".join(f)
    bad = tmp_path / "dryrun_bad.gfa"
    bad.write_text("\n".join(lines) + "\n")
    return [dry, mh, str(bad)]


def test_partition_groups_equals_panacus_tpu(tmp_path):
    from panacus_tpu.abacus import path_order_groups as tpu_order
    from panacus_tpu.gfa import GraphStorage as TpuGraph
    from panacus_tpu.mask import GraphMask as TpuMask, GraphMaskParameters as TpuParams
    from panacus_tpu.parallel import ingest as tpu

    from panacus_torch.abacus import path_order_groups
    from panacus_torch.gfa import GraphStorage
    from panacus_torch.mask import GraphMask, GraphMaskParameters
    from panacus_torch.parallel import ingest as pt

    for gfa in _graphs(tmp_path):
        g, tg = GraphStorage(gfa, index_edges=False), TpuGraph(gfa, index_edges=False)
        mask = GraphMask.from_datamgr(GraphMaskParameters(groupby_sample=True), g)
        tmask = TpuMask.from_datamgr(TpuParams(groupby_sample=True), tg)
        order, groups = path_order_groups(mask, g.path_segments)
        assert (order, groups) == tpu_order(tmask, tg.path_segments)
        n_words = (len(groups) + 31) // 32
        for n_proc in (1, 2, 3, 5):
            got = pt._partition_groups(g, order, len(groups), n_words, n_proc)
            want = tpu._partition_groups(tg, order, len(groups), n_words, n_proc)
            np.testing.assert_array_equal(got[0], want[0])
            assert got[1:4] == want[1:4]
            np.testing.assert_array_equal(got[4], want[4])


def test_partition_merge_equals_full(tmp_path):
    """Partial matrices of a path partition OR-merge to the one-process M:
    the port's classic build, and panacus_tpu's partial_membership."""
    from panacus_tpu.gfa import GraphStorage as TpuGraph
    from panacus_tpu.mask import GraphMask as TpuMask, GraphMaskParameters as TpuParams
    from panacus_tpu.parallel.ingest import partial_membership as tpu_partial

    from panacus_torch.abacus import build_membership_host, path_order_groups
    from panacus_torch.gfa import GraphStorage
    from panacus_torch.itemize import itemize_paths
    from panacus_torch.mask import GraphMask, GraphMaskParameters
    from panacus_torch.ops.engine import CountingEngine
    from panacus_torch.parallel.ingest import host_path_slice, merge_partials, partial_membership
    from panacus_torch.utils import CountType

    for gfa in _graphs(tmp_path):
        g = GraphStorage(gfa, index_edges=False)
        mask = GraphMask.from_datamgr(GraphMaskParameters(groupby_sample=True), g)
        tg = TpuGraph(gfa, index_edges=False)
        tmask = TpuMask.from_datamgr(TpuParams(groupby_sample=True), tg)
        itemized = itemize_paths(g, mask, [CountType.NODE])
        order, groups = path_order_groups(mask, g.path_segments)
        eng = CountingEngine(g.node_count, len(groups), "cpu")
        full = build_membership_host(
            itemized.item_tables[0], order, None, g.node_count, len(groups), eng.n_items_pad
        )
        n_paths = len(g.path_segments)
        for n_hosts in (2, 3):
            parts = []
            for h in range(n_hosts):
                sl = host_path_slice(n_paths, h, n_hosts)
                Mh, gh = partial_membership(g, mask, sl, g.node_count, eng.n_items_pad)
                Th, tgh = tpu_partial(tg, tmask, sl, g.node_count, eng.n_items_pad)
                assert gh == groups == tgh
                np.testing.assert_array_equal(Mh, Th)
                parts.append(Mh)
            np.testing.assert_array_equal(merge_partials(parts), full)


def test_sliced_hist_matches(tmp_path):
    """The engine on the merged partials counts the oracle's histograms."""
    from panacus_torch import testgraphs
    from panacus_torch.abacus import path_order_groups
    from panacus_torch.gfa import GraphStorage
    from panacus_torch.mask import GraphMask, GraphMaskParameters
    from panacus_torch.ops.engine import CountingEngine
    from panacus_torch.parallel.ingest import host_path_slice, merge_partials, partial_membership

    gfa = str(tmp_path / "dryrun.gfa")
    visits, lens, edges = testgraphs._write_dryrun_gfa(gfa)
    _, node_hist, bp_hist, _ = testgraphs._oracle(visits, lens, edges)
    g = GraphStorage(gfa, index_edges=False)
    mask = GraphMask.from_datamgr(GraphMaskParameters(groupby_sample=True), g)
    _, groups = path_order_groups(mask, g.path_segments)
    eng = CountingEngine(g.node_count, len(groups), ("cpu",) * 2)
    n_paths = len(g.path_segments)
    parts = [
        partial_membership(g, mask, host_path_slice(n_paths, h, 2), g.node_count, eng.n_items_pad)[0]
        for h in range(2)
    ]
    eng.build_from_host_matrix(merge_partials(parts))
    w = g.node_lens[: g.node_count + 1].astype(np.int64)
    w[0] = 0
    assert eng.hist().tolist() == node_hist.tolist()
    assert eng.hist(w).tolist() == bp_hist.tolist()


def test_assemble_bitdisjoint_add_equals_or():
    """K9's receiving half: the slot rows of three processes' bit-disjoint
    partials, added per word in int64 as unsigned 32 bits, give the OR
    (merge_partials) bit for bit, bit 31 included."""
    import torch

    from panacus_torch.parallel.ingest import merge_partials, sum_slot_rows, word_slots, words_of_range

    n_groups, n_pad, cuts = 40, 256, [0, 13, 30, 40]
    mem = _membership(n_groups, n_pad - 1, seed=5)
    partials = [_pack(mem, range(cuts[p], cuts[p + 1]), 2, n_pad) for p in range(3)]
    wpp2 = max(len(words_of_range(cuts[p], cuts[p + 1])) for p in range(3))
    recv = np.zeros((3 * wpp2, n_pad), dtype=np.uint32)
    for p in range(3):
        mine = words_of_range(cuts[p], cuts[p + 1])
        recv[p * wpp2 : p * wpp2 + len(mine)] = partials[p][mine.start : mine.stop]
    got = sum_slot_rows(torch.from_numpy(recv.view(np.int32)), word_slots(cuts, 2, wpp2))
    want = merge_partials(partials)
    assert (want[0] >> 31).any() and (want[1] >> 31 == 0).all()  # group 31 of word 0
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    np.testing.assert_array_equal(partials[0] + partials[1] + partials[2], want)


@pytest.mark.parametrize("n_ranks", sorted(K9_CASES))
def test_k9_exchange_equals_merge_partials(tmp_path, n_ranks):
    """K9 across real gloo processes: the ranks' blocks side by side equal
    the OR of every process's partial matrix, bit for bit."""
    from panacus_torch.parallel.launch import launch

    from panacus_torch.parallel.ingest import merge_partials

    n_groups, cuts, shards = K9_CASES[n_ranks]
    report = str(tmp_path / "k9")
    env = dict(os.environ, PANACUS_TORCH_DEVICE="cpu")
    launch([sys.executable, os.path.abspath(__file__), report], n_ranks, env=env, cwd=REPO, timeout=300)
    ranks = [json.load(open(f"{report}.{r}.json")) for r in range(n_ranks)]
    n_pad = ranks[0]["n_items_pad"]
    assert n_pad % ((1 << 14) * n_ranks * int(np.lcm.reduce(shards))) == 0
    assert [r["item_lo"] for r in ranks] == [r * n_pad // n_ranks for r in range(n_ranks)]
    got = np.concatenate([np.array(r["block"], dtype=np.uint32) for r in ranks], axis=1)
    mem = _membership(n_groups, K9_ITEMS)
    n_words = (n_groups + 31) // 32
    want = merge_partials(
        [_pack(mem, range(cuts[p], cuts[p + 1]), n_words, n_pad) for p in range(n_ranks)]
    )
    assert all((want[w] >> 31).any() for w in range(n_words - 1))  # bit 31 in play
    np.testing.assert_array_equal(got, want)
    assert all(r["built_equal"] for r in ranks)  # CountingEngine.build's split
    cov = mem.sum(0)
    w = np.arange(K9_ITEMS + 1, dtype=np.int64) % 7
    w[0] = 0
    for r in ranks:
        assert r["coverage"] == cov.tolist()
        assert r["hist"] == np.bincount(cov, weights=w, minlength=n_groups + 1).astype(np.int64).tolist()


def test_visit_positions_are_range_guarded():
    """path << 40 | visit fits in int64 for paths below 2^23 with fewer than
    2^40 visits; past either the merge's positions would wrap, so the
    guard raises."""
    from panacus_torch.itemize import visit_position_base

    assert visit_position_base(0, 0) == 0
    assert visit_position_base((1 << 23) - 1, (1 << 40) - 1) == ((1 << 23) - 1) << 40
    assert ((((1 << 23) - 1) << 40) | ((1 << 40) - 1)) == np.iinfo(np.int64).max
    with pytest.raises(ValueError, match="past the 8388608 paths"):
        visit_position_base(1 << 23, 5)
    with pytest.raises(ValueError, match="visits"):
        visit_position_base(3, 1 << 40)


def test_tracked_itemize_checks_each_path(tmp_path, monkeypatch):
    """The subset walk of a multi-process build (track_cov_order) asks the
    guard for every path it walks, and its error reaches the caller."""
    from panacus_torch import itemize
    from panacus_torch.gfa import GraphStorage
    from panacus_torch.mask import GraphMask, GraphMaskParameters
    from panacus_torch.utils import CountType

    gfa = str(tmp_path / "mh.gfa")
    from test_multihost import _write_fixture

    _write_fixture(gfa)
    bed = tmp_path / "sub.bed"
    bed.write_text("".join(f"s{p}#0#chr1\t5\t301\n" for p in range(0, 40, 3)))
    g = GraphStorage(gfa, index_edges=False)
    mask = GraphMask.from_datamgr(
        GraphMaskParameters(groupby_sample=True, positive_list=str(bed)), g
    )
    seen = []
    real = itemize.visit_position_base

    def spy(num_path, n_visits):
        seen.append(num_path)
        return real(num_path, n_visits)

    monkeypatch.setattr(itemize, "visit_position_base", spy)
    itemize.itemize_paths(g, mask, [CountType.BP], track_cov_order=True)
    assert sorted(seen) == list(range(0, 40, 3))
    monkeypatch.setattr(itemize, "MAX_TRACKED_PATHS", 10)
    monkeypatch.setattr(itemize, "visit_position_base", real)
    with pytest.raises(ValueError, match="visit positions"):
        itemize.itemize_paths(g, mask, [CountType.BP], track_cov_order=True)


if __name__ == "__main__":
    _k9_worker(sys.argv[1])
