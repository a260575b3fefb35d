"""The port's multi-process build: real 2- and 3-process gloo groups on the
CPU drive panacus_torch's GraphBroker on the fixture of
tests/test_multihost.py (500 nodes, 40 single-path samples, integer and
string node names), the counterpart of that file's broker tests.

Each rank tokenizes only its payload-balanced group range
(parallel.ingest), M is assembled across the processes (K9) and split over
every device of every process, and the int64 partials meet in an
all_reduce. Every result must equal panacus_tpu's GraphBroker in this one
process on the CPU and the numpy oracle exactly, on every rank.

One launch of each group size runs every scenario in one process per rank
(`python tests/test_torch_multihost.py REPORT SCENARIOS_JSON`, the
__main__ block below), so torch is imported once per rank. Some scenarios
split each rank's columns over several CPU shards; the 3-process launch
gives rank r r + 1 shards, so the padding takes the lcm of 1, 2 and 3.
"""

import json
import os
import sys

import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
N_SAMPLES = 40


def _scenario(sc, rank):
    """One GraphBroker run of the port under the process group."""
    from panacus_torch.broker import GraphBroker, GraphState, Req
    from panacus_torch.config import Grouping
    from panacus_torch.utils import CountType, Threshold

    shards = sc.get("shards", 1)
    devices = ("cpu",) * (rank + 1 if shards == "rank+1" else shards)
    gfa, mode = sc["gfa"], sc["mode"]
    gb = GraphBroker(devices)
    state = GraphState(graph=gfa, name="mh", grouping=Grouping.sample())
    state.subset = sc.get("subset", "")
    state.exclude = sc.get("exclude", "")
    if mode == "group":
        reqs = {Req.graph(gfa), Req.NODE, Req.HIST, Req.abacus_by_group(CountType.NODE)}
    elif mode == "table":
        reqs = {
            Req.graph(gfa),
            Req.NODE,
            Req.abacus_by_group(CountType.NODE),
            Req.group_table(CountType.NODE),
        }
    else:
        reqs = {Req.graph(gfa), Req.NODE, Req.BP, Req.HIST, Req.PATH_LENS}
        if sc.get("edge"):
            reqs.add(Req.EDGE)
    gb.change_graph_state(state, reqs, nice=False)
    eng = next(iter(gb.total_abaci.values())).engine
    res = {
        "mh_stats": getattr(gb._itemized, "mh_stats", None),
        "layout": [eng.world_size, eng.n_items_pad, eng.proc_items, eng.bounds],
    }
    if mode == "table":
        res["table"] = gb.get_abacus_by_group().to_tsv(False, gb.graph_aux)
        return res
    hists = gb.get_hists()
    res["hists"] = {str(ct.value): [int(x) for x in h.coverage] for ct, h in hists.items()}
    if mode == "group":
        ab = gb.get_abacus_by_group()
        res["ordered"] = [
            ab.calc_growth(Threshold.absolute(c), Threshold.rel(q))
            for c, q in ((1, 0.0), (2, 0.5), (1, 1.0))
        ]
        res["similarity"] = ab.similarity_matrix()[0].tolist()
        res["countable"] = gb.get_abacus_by_total(CountType.NODE).countable.tolist()
    else:
        res["paths_len"] = sorted(
            [str(k), v[0], v[1]] for k, v in gb.get_path_lens().items()
        )
    return res


def _worker(report, scenarios_json):
    sys.path.insert(0, REPO)
    from panacus_torch.runtime import init_distributed, shutdown_distributed, world

    assert init_distributed(), "torchrun's environment is missing"
    rank, size = world()
    assert size == int(os.environ["WORLD_SIZE"])
    with open(scenarios_json) as f:
        scenarios = json.load(f)
    try:
        out = {name: _scenario(sc, rank) for name, sc in scenarios.items()}
    finally:
        shutdown_distributed()
    with open(f"{report}.{rank}.json", "w") as f:
        json.dump(out, f)


# -- the tests ----------------------------------------------------------------


def _fixture(path, **kw):
    from test_multihost import _write_fixture

    return _write_fixture(str(path), **kw)


def _bed(path, rows):
    path.write_text("".join(rows))
    return str(path)


def _run(tmp, n_ranks, scenarios):
    from panacus_torch.parallel.launch import launch

    spec = tmp / f"scenarios{n_ranks}.json"
    spec.write_text(json.dumps(scenarios))
    report = str(tmp / f"report{n_ranks}")
    env = dict(os.environ, PANACUS_TORCH_DEVICE="cpu")
    launch(
        [sys.executable, os.path.abspath(__file__), report, str(spec)],
        n_ranks,
        env=env,
        cwd=REPO,
        timeout=300,
    )
    return [json.load(open(f"{report}.{r}.json")) for r in range(n_ranks)]


def _tpu_result(gfa, subset="", exclude="", table=False, edge=False, group=False):
    """panacus_tpu's GraphBroker in this process: the one-process reference."""
    from panacus_tpu.broker import GraphBroker, GraphState, Req
    from panacus_tpu.config import Grouping
    from panacus_tpu.utils import CountType, Threshold

    gb = GraphBroker()
    if group:
        reqs = {Req.graph(gfa), Req.NODE, Req.HIST, Req.abacus_by_group(CountType.NODE)}
    elif table:
        reqs = {
            Req.graph(gfa),
            Req.NODE,
            Req.abacus_by_group(CountType.NODE),
            Req.group_table(CountType.NODE),
        }
    else:
        reqs = {Req.graph(gfa), Req.NODE, Req.BP, Req.HIST, Req.PATH_LENS}
        if edge:
            reqs.add(Req.EDGE)
    state = GraphState(
        graph=gfa, name="mh", subset=subset, exclude=exclude, grouping=Grouping.sample()
    )
    gb.change_graph_state(state, reqs, nice=False)
    if table:
        return {"table": gb.get_abacus_by_group().to_tsv(False, gb.graph_aux)}
    res = {
        "hists": {
            str(ct.value): [int(x) for x in h.coverage] for ct, h in gb.get_hists().items()
        }
    }
    if group:
        ab = gb.get_abacus_by_group()
        res["ordered"] = [
            ab.calc_growth(Threshold.absolute(c), Threshold.rel(q))
            for c, q in ((1, 0.0), (2, 0.5), (1, 1.0))
        ]
        res["similarity"] = ab.similarity_matrix()[0].tolist()
        res["countable"] = gb.get_abacus_by_total(CountType.NODE).countable.tolist()
    else:
        res["paths_len"] = sorted(
            [str(k), v[0], v[1]] for k, v in gb.get_path_lens().items()
        )
    return res


def _oracle_excluded(visits_all, lens, edges, excluded):
    """Whole-path exclusion: the excluded groups lose their columns and
    every item an excluded path visits counts 0 (tests/test_multihost.py's
    oracle)."""
    n_nodes = len(lens) - 1
    keep = [p for p in range(N_SAMPLES) if p not in excluded]
    mem = np.zeros((len(keep), n_nodes + 1), dtype=bool)
    emem = np.zeros((len(keep), len(edges)), dtype=bool)
    eidx = {e: i for i, e in enumerate(edges)}
    for gi, p in enumerate(keep):
        v = visits_all[p]
        mem[gi, v] = True
        for a, b in zip(v[:-1], v[1:]):
            emem[gi, eidx[(int(a), int(b))]] = True
    excl = np.zeros(n_nodes + 1, dtype=bool)
    excl_e = np.zeros(len(edges), dtype=bool)
    for p in excluded:
        v = visits_all[p]
        excl[v] = True
        for a, b in zip(v[:-1], v[1:]):
            excl_e[eidx[(int(a), int(b))]] = True
    cov, ecov = mem.sum(0), emem.sum(0)
    cov[excl] = 0
    ecov[excl_e] = 0
    n = len(keep)
    node = np.bincount(cov[1:], minlength=n + 1)
    bp = np.bincount(cov[1:], weights=lens[1:].astype(np.float64), minlength=n + 1)
    return node.tolist(), bp.astype(np.int64).tolist(), np.bincount(ecov, minlength=n + 1).tolist()


def _trailing_comma(gfa, path):
    """The graph with a ',' after the last step of its last P line: the C
    tokenizer refuses the list, the per-path parse takes it."""
    lines = open(gfa).read().splitlines()
    i = max(k for k, l in enumerate(lines) if l.startswith("P\t"))
    f = lines[i].split("\t")
    f[2] += ","
    lines[i] = "\t".join(f)
    path.write_text("\n".join(lines) + "\n")
    return str(path)


@pytest.fixture(scope="module")
def two(tmp_path_factory):
    """Every 2-process scenario in one launch, with the one-process
    references (panacus_tpu) and the fixture's oracle inputs."""
    tmp = tmp_path_factory.mktemp("mh2")
    gfa = str(tmp / "mh.gfa")
    visits, lens, edges = _fixture(gfa)
    gfa_str = str(tmp / "mh_str.gfa")
    _fixture(gfa_str, namer=lambda v: f"seg.{v}x")
    exc = _bed(tmp / "exc.bed", [f"s{p}#0#chr1\n" for p in (0, 13)])
    sub_rows = []
    for p in range(N_SAMPLES):
        if p % 3 == 0:
            sub_rows.append(f"s{p}#0#chr1\t5\t301\n")  # a partial interval
        elif p % 3 == 1:
            sub_rows.append(f"s{p}#0#chr1\n")  # the whole path
    sub = _bed(tmp / "sub.bed", sub_rows)
    cex = _bed(
        tmp / "cex.bed",
        [f"s{p}#0#chr1\t0\t{120 + 17 * p}\n" for p in range(0, N_SAMPLES, 4)],
    )
    rng = np.random.default_rng(99)
    csub, cexc = [], []
    for p in range(N_SAMPLES):
        r = rng.integers(0, 4)
        if r == 0:
            a = int(rng.integers(0, 200))
            csub.append(f"s{p}#0#chr1\t{a}\t{a + int(rng.integers(3, 400))}\n")
        elif r == 1:
            csub.append(f"s{p}#0#chr1\n")
        if rng.integers(0, 3) == 0:
            a = int(rng.integers(0, 150))
            cexc.append(f"s{p}#0#chr1\t{a}\t{a + int(rng.integers(2, 120))}\n")
    combo_sub, combo_exc = _bed(tmp / "csub.bed", csub), _bed(tmp / "cexc.bed", cexc)
    gfa_bad = _trailing_comma(gfa, tmp / "mh_bad.gfa")
    scenarios = {
        "hist": {"gfa": gfa, "mode": "hist", "shards": 2},
        "group": {"gfa": gfa, "mode": "group", "shards": 2},
        "exclude": {"gfa": gfa, "mode": "hist", "exclude": exc, "edge": True},
        "strings": {"gfa": gfa_str, "mode": "hist"},
        "subset": {"gfa": gfa, "mode": "hist", "subset": sub, "shards": 2},
        "coordexclude": {"gfa": gfa, "mode": "hist", "exclude": cex},
        "table": {"gfa": gfa, "mode": "table"},
        "combo": {"gfa": gfa, "mode": "hist", "subset": combo_sub, "exclude": combo_exc},
        "refused": {"gfa": gfa_bad, "mode": "hist", "edge": True},
    }
    ranks = _run(tmp, 2, scenarios)
    refs = {
        "hist": _tpu_result(gfa),
        "group": _tpu_result(gfa, group=True),
        "exclude": _tpu_result(gfa, exclude=exc, edge=True),
        "strings": _tpu_result(gfa_str),
        "subset": _tpu_result(gfa, subset=sub),
        "coordexclude": _tpu_result(gfa, exclude=cex),
        "table": _tpu_result(gfa, table=True),
        "combo": _tpu_result(gfa, subset=combo_sub, exclude=combo_exc),
        "refused": _tpu_result(gfa_bad, edge=True),
    }
    return ranks, refs, (visits, lens, edges)


def _same_on_every_rank(ranks, name):
    for r in ranks[1:]:
        got = {k: v for k, v in r[name].items() if k not in ("mh_stats", "layout")}
        want = {k: v for k, v in ranks[0][name].items() if k not in ("mh_stats", "layout")}
        assert got == want, name
    return ranks[0][name]


def _shares(ranks, name):
    stats = [r[name]["mh_stats"] for r in ranks]
    assert all(s is not None for s in stats), f"{name}: not the path-sliced build"
    total = stats[0]["total_payload_bytes"]
    assert total > 0 and all(s["total_payload_bytes"] == total for s in stats)
    assert all(s["n_processes"] == len(ranks) for s in stats)
    shares = [s["tokenized_payload_bytes"] / total for s in stats]
    assert abs(sum(shares) - 1.0) < 1e-9, shares  # the payload once in all
    return shares


def test_two_process_broker_matches_oracle(two):
    from test_multihost import _oracle_hists

    ranks, refs, (visits, lens, _) = two
    node, bp = _oracle_hists(visits, lens)
    res = _same_on_every_rank(ranks, "hist")
    assert all(0.3 < f < 0.7 for f in _shares(ranks, "hist"))
    assert res["hists"]["node"] == node.tolist() == refs["hist"]["hists"]["node"]
    assert res["hists"]["bp"] == bp.tolist() == refs["hist"]["hists"]["bp"]
    assert res["paths_len"] == refs["hist"]["paths_len"]
    assert len(res["paths_len"]) == N_SAMPLES
    assert sum(v for _, v, _ in res["paths_len"]) == sum(len(v) for v in visits)
    assert sum(b for _, _, b in res["paths_len"]) == sum(int(lens[v].sum()) for v in visits)
    # the item axis split over 2 processes x 2 CPU shards: global ranges
    for rank, r in enumerate(ranks):
        world_size, n_pad, proc, bounds = r["hist"]["layout"]
        assert world_size == 2 and proc * 2 == n_pad and n_pad % (1 << 16) == 0
        assert bounds == [[rank * proc, rank * proc + proc // 2],
                          [rank * proc + proc // 2, (rank + 1) * proc]]


def test_two_process_group_abacus_path_sliced(two):
    ranks, refs, (visits, lens, _) = two
    res = _same_on_every_rank(ranks, "group")
    _shares(ranks, "group")
    want = refs["group"]
    assert res["hists"] == want["hists"]
    assert res["ordered"] == want["ordered"]
    assert res["similarity"] == want["similarity"]
    assert res["countable"] == want["countable"]  # the all_gathered coverage
    mem = np.zeros((N_SAMPLES, len(lens)), dtype=bool)
    for g, v in enumerate(visits):
        mem[g, v] = True
    # ordered growth at c=1, q=0: the union of the groups so far
    seen = np.zeros(len(lens), dtype=bool)
    union = []
    for g in range(N_SAMPLES):
        seen |= mem[g]
        union.append(float(seen[1:].sum()))
    assert res["ordered"][0] == union
    assert np.trace(np.array(res["similarity"])) == float(mem.sum())


def test_two_process_excluded_runs_path_sliced(two):
    ranks, refs, (visits, lens, edges) = two
    res = _same_on_every_rank(ranks, "exclude")
    _shares(ranks, "exclude")
    node, bp, edge = _oracle_excluded(visits, lens, edges, [0, 13])
    assert res["hists"]["node"] == node == refs["exclude"]["hists"]["node"]
    assert res["hists"]["bp"] == bp == refs["exclude"]["hists"]["bp"]
    assert res["hists"]["edge"] == edge == refs["exclude"]["hists"]["edge"]
    assert res["paths_len"] == refs["exclude"]["paths_len"]
    assert len(res["paths_len"]) == N_SAMPLES


def test_two_process_string_names_path_sliced(two):
    from test_multihost import _oracle_hists

    ranks, refs, (visits, lens, _) = two
    res = _same_on_every_rank(ranks, "strings")
    _shares(ranks, "strings")
    node, bp = _oracle_hists(visits, lens)
    assert res["hists"]["node"] == node.tolist() == refs["strings"]["hists"]["node"]
    assert res["hists"]["bp"] == bp.tolist() == refs["strings"]["hists"]["bp"]


def test_two_process_refused_step_list_takes_the_classic_build(two):
    """The rank that owns the refused step list bails, every rank takes
    the classic build (no path-sliced stats), and the per-path parse takes
    the list as panacus_tpu does."""
    ranks, refs, _ = two
    res = _same_on_every_rank(ranks, "refused")
    assert all(r["refused"]["mh_stats"] is None for r in ranks)
    assert res["hists"] == refs["refused"]["hists"]
    assert res["paths_len"] == refs["refused"]["paths_len"]
    assert len(res["paths_len"]) == N_SAMPLES


@pytest.mark.parametrize("name", ["subset", "coordexclude", "combo"])
def test_two_process_masked_path_sliced(two, name):
    """A subset BED with coordinates (partial node coverage, bp
    corrections), coordinate excludes, and a randomized subset + exclude:
    each process interval-walks its group range, the exclude tables and
    covered-bp intervals merge, and the result equals one process's."""
    ranks, refs, _ = two
    res = _same_on_every_rank(ranks, name)
    shares = _shares(ranks, name)
    if name == "subset":
        assert all(0.3 < f < 0.7 for f in shares), shares
    assert res["hists"] == refs[name]["hists"]
    assert res["paths_len"] == refs[name]["paths_len"]


def test_two_process_table_export_path_sliced(two):
    ranks, refs, _ = two
    _shares(ranks, "table")

    def strip(t):
        return "\n".join(l for l in t.splitlines() if not l.startswith("#"))

    assert strip(ranks[0]["table"]["table"]) == strip(ranks[1]["table"]["table"])
    assert strip(ranks[0]["table"]["table"]) == strip(refs["table"]["table"])


@pytest.fixture(scope="module")
def three(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mh3")
    gfa = str(tmp / "mh3.gfa")
    visits, lens, _ = _fixture(gfa)
    sub = _bed(
        tmp / "sub3.bed",
        [
            f"s{p}#0#chr1\t3\t{150 + 11 * p}\n" if p % 2 else f"s{p}#0#chr1\n"
            for p in range(0, N_SAMPLES, 2)
        ],
    )
    scenarios = {
        "hist": {"gfa": gfa, "mode": "hist", "shards": "rank+1"},
        "subset": {"gfa": gfa, "mode": "hist", "subset": sub},
    }
    ranks = _run(tmp, 3, scenarios)
    refs = {"hist": _tpu_result(gfa), "subset": _tpu_result(gfa, subset=sub)}
    return ranks, refs, (visits, lens)


def test_three_process_shared_word_assembly(three):
    """Three processes over 40 groups: the payload-balanced cuts fall
    inside word 0, so its row is the sum of bit-disjoint partial rows of
    several processes; rank r splits its columns over r + 1 shards."""
    from test_multihost import _oracle_hists

    ranks, refs, (visits, lens) = three
    res = _same_on_every_rank(ranks, "hist")
    assert all(0.15 < f < 0.55 for f in _shares(ranks, "hist"))
    node, bp = _oracle_hists(visits, lens)
    assert res["hists"]["node"] == node.tolist() == refs["hist"]["hists"]["node"]
    assert res["hists"]["bp"] == bp.tolist() == refs["hist"]["hists"]["bp"]
    assert res["paths_len"] == refs["hist"]["paths_len"]
    for rank, r in enumerate(ranks):
        _, n_pad, proc, bounds = r["hist"]["layout"]
        assert n_pad % ((1 << 14) * 3 * 6) == 0 and len(bounds) == rank + 1
        assert bounds[0][0] == rank * proc and bounds[-1][1] == (rank + 1) * proc


def test_three_process_subset_path_sliced(three):
    ranks, refs, _ = three
    res = _same_on_every_rank(ranks, "subset")
    _shares(ranks, "subset")
    assert res["hists"] == refs["subset"]["hists"]
    assert res["paths_len"] == refs["subset"]["paths_len"]


if __name__ == "__main__":
    _worker(sys.argv[1], sys.argv[2])
