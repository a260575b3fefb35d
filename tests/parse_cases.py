"""Step lists for the tests of panacus_torch.ops.parse_kernels (the
plain versions of pt_parse_pack and pt_parse_pack_edges, the kernels on the
card, the host tokenizer).

A case is a list of step lists (bytes, span, word, bit, walk), laid into
one text between bytes of other GFA fields (which hold ',', '>', digits and
orientations that the parse must skip) with one descriptor row each, and
whether every token of it is good. Ids run up to N_ITEMS, past seven
digits. The edge cases add the pairs of steps that the graph's L lines
leave out; `adjacency` builds the L lines' CSR adjacency from every other
pair the good lists walk, and `host_edge_rows` packs the edge rows as the
host's pt_pack_edges_adj does.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from panacus_torch import native
from panacus_torch.ops import parse_kernels

N_ITEMS = 10_000_001
N_WORDS = 2

Piece = Tuple[bytes, int, int, int, bool]

CASES = {
    # name: (pieces, every token good)
    "p_w_and_ungrouped": (
        [(b"1+,22-,333+", 0, 0, 3, False), (b">4<55>666", 1, 1, 7, True), (b"7+", 2, -1, 0, False)],
        True,
    ),
    "seven_and_eight_digits": (
        [(b"1234567+,10000000-,10000001+", 0, 0, 0, False), (b">9999999<10000001", 1, 0, 31, True)],
        True,
    ),
    "leading_zeros": ([(b"007+,0000001-", 0, 0, 1, False), (b">0009", 1, 1, 2, True)], True),
    "wraps_to_one": ([(b"18446744073709551617+", 0, 0, 5, False)], True),
    "one_span_two_pieces": ([(b"5+,6+", 0, 0, 4, False), (b"7-", 0, 0, 4, False)], True),
    "id_zero": ([(b"1+,0+", 0, 0, 0, False)], False),
    "id_past_n_items": ([(b"10000002+", 0, 0, 0, False)], False),
    "w_id_zero": ([(b">1>0", 0, 0, 0, True)], False),
    "wraps_out_of_range": ([(b"9999999999999999999999999+", 0, 0, 0, False)], False),
    "stray_byte": ([(b"12+,3x+", 0, 0, 0, False)], False),
    "stray_after_orientation": ([(b"12+x,3+", 0, 0, 0, False)], False),
    "w_stray_byte": ([(b">12x>3", 0, 0, 0, True)], False),
    "missing_orientation": ([(b"12,3+", 0, 0, 0, False)], False),
    "missing_orientation_at_end": ([(b"12+,3", 0, 0, 0, False)], False),
    "trailing_comma": ([(b"1+,", 0, 0, 0, False)], False),
    "leading_comma": ([(b",1+", 0, 0, 0, False)], False),
    "double_comma": ([(b"1+,,2+", 0, 0, 0, False)], False),
    "orientation_alone": ([(b"+", 0, 0, 0, False)], False),
    "w_empty_token": ([(b">1>>2", 0, 0, 0, True)], False),
    "w_no_orientation_first": ([(b"1>2", 0, 0, 0, True)], False),
    "w_orientation_last": ([(b">1>", 0, 0, 0, True)], False),
    "least_failing_span": (
        [(b"1+", 0, 0, 0, False), (b"x+", 5, 0, 1, False), (b"2+", 3, 0, 2, False), (b">y", 2, 0, 3, True)],
        False,
    ),
}


# name: (pieces, the walked pairs (u, o1, v, o2) that no L line holds)
EDGE_CASES = {
    "single_steps": ([(b"5+", 0, 0, 1, False), (b">6", 1, 1, 2, True), (b"7-,8+", 2, 0, 3, False)], []),
    "u_above_v": ([(b"9+,3-,7+,2-", 0, 0, 0, False), (b">12<4>4<1", 1, 1, 9, True)], []),
    "self_loops": ([(b"5-,5-,5+,5+", 0, 0, 4, False), (b"<8<8>8>8<8", 1, 0, 5, True)], []),
    "no_group": ([(b"1+,2+,3-", 0, -1, 0, False), (b"2+,3+", 1, 0, 4, False), (b">3<9", 2, -1, 1, True)], []),
    # row 1 of the adjacency holds 24 entries: the lookup's binary search
    "hub_row": ([(",".join(f"1+,{k}{'+-'[k % 2]}" for k in range(2, 14)).encode(), 0, 0, 6, False)], []),
    "pair_without_l_line": (
        # 2+ 3+ and <3 <2 walk one edge: its span 3 is the least that fails
        [(b"1+,2+,3+", 4, 0, 0, False), (b">3>2", 2, 1, 1, True), (b"<3<2", 3, 0, 2, True)],
        [(2, 0, 3, 0)],
    ),
}


def _canonical(u, o1, v, o2):
    """(reference: Edge::canonical, graph.rs:142-148)"""
    if u > v or (u == v and o1):
        return v, 1 - o2, u, 1 - o1
    return u, o1, v, o2


def steps(pieces: List[Piece]):
    """The host tokenizer's (ids, orient) of each piece's list, None where
    it refuses the list."""
    out = []
    for text, _, _, _, walk in pieces:
        got = native.tokenize_batch(
            np.frombuffer(text + b"\n", dtype=np.uint8), np.array([0]), np.array([len(text)]),
            np.array([walk], dtype=np.uint8), 1, N_ITEMS, n_threads=1,
        )
        out.append(None if got is None else got[:2])
    return out


def walked(ids, orient):
    """The canonical edges of a list's pairs of consecutive steps."""
    return [_canonical(*map(int, e)) for e in zip(ids[:-1], orient[:-1], ids[1:], orient[1:])]


def adjacency(pieces: List[Piece], missing=(), seed: int = 0):
    """(row_off, adj_ent, n_edges): native.build_edge_adj over the canonical
    edges that the good lists walk, less `missing`, ids in a seeded order."""
    leave = {_canonical(*e) for e in missing}
    edges = sorted({e for got in steps(pieces) if got is not None for e in walked(*got)} - leave)
    edges = np.array(edges, dtype=np.int64).reshape(-1, 4)[np.random.default_rng(seed).permutation(len(edges))]
    row_off, adj_ent = native.build_edge_adj(
        edges[:, 0], edges[:, 1].astype(np.uint8), edges[:, 2], edges[:, 3].astype(np.uint8), N_ITEMS)
    return row_off, adj_ent, len(edges)


def edge_tensors(adj, device=torch.device("cpu")):
    """row_off and adj_ent (as int64) on `device`."""
    return tuple(torch.from_numpy(a.view(np.int64)).to(device) for a in adj[:2])


def edge_outputs(n_edges: int, device=torch.device("cpu")) -> Tuple[torch.Tensor, torch.Tensor]:
    """A zeroed edge M and a fresh error slot (ERR_NONE)."""
    M = torch.zeros((N_WORDS, n_edges + 3), dtype=torch.int32, device=device)
    return M, torch.full((1,), int(parse_kernels.ERR_NONE), dtype=torch.int64, device=device)


def host_edge_rows(pieces: List[Piece], adj) -> np.ndarray:
    """The edge rows [N_WORDS, n_edges + 3] that the host's fused edge pack
    (native.pack_edges_adj) gives each word's lists; every list good."""
    out = np.zeros((N_WORDS, adj[2] + 3), dtype=np.uint32)
    got = steps(pieces)
    for word in range(N_WORDS):
        mine = [k for k, p in enumerate(pieces) if p[2] == word]
        if not mine:
            continue
        ids = np.concatenate([got[k][0] for k in mine])
        orient = np.concatenate([got[k][1] for k in mine])
        prefsum = np.concatenate([[0], np.cumsum([len(got[k][0]) for k in mine])])
        native.pack_edges_adj(ids, orient, prefsum, np.array([pieces[k][3] for k in mine]),
                              adj[:2], out[word], n_threads=1)
    return out


def failing_span(pieces: List[Piece], missing=()) -> int:
    """The least span whose list the host tokenizer refuses or whose pairs
    walk an edge in `missing`; ERR_NONE where none."""
    leave = {_canonical(*e) for e in missing}
    bad = [p[1] for p, got in zip(pieces, steps(pieces))
           if got is None or leave & set(walked(*got))]
    return min(bad, default=int(parse_kernels.ERR_NONE))


def random_pieces(rng: np.random.Generator, n_pieces: int, max_tokens: int) -> List[Piece]:
    """Good step lists of random lengths and id widths, P and W, some in no
    group, their spans in random order: their tokens straddle the kernel's
    windows everywhere."""
    pieces = []
    for span in rng.permutation(n_pieces).tolist():
        k = int(rng.integers(1, max_tokens + 1))
        ids = rng.integers(1, 10 ** rng.integers(1, 9, size=k), dtype=np.int64)
        ids = np.minimum(ids, N_ITEMS)
        walk = bool(rng.integers(0, 2))
        if walk:
            text = "".join(f"{'><'[int(o)]}{i}" for i, o in zip(ids, rng.integers(0, 2, k)))
        else:
            text = ",".join(f"{i}{'+-'[int(o)]}" for i, o in zip(ids, rng.integers(0, 2, k)))
        word = int(rng.integers(-1, N_WORDS))
        pieces.append((text.encode(), span, word, int(rng.integers(0, 32)), walk))
    return pieces


def n_spans(pieces: List[Piece]) -> int:
    return 1 + max(p[1] for p in pieces)


def layout(pieces: List[Piece], seed: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """(uint8 text, int64 [n, 4] descriptor rows) of the step lists, in
    order, each after 0 to 6 bytes of other fields (seeded), the text
    ending in some more."""
    rng = np.random.default_rng(seed)
    junk = b"\n9,>1+<\t"
    data, descs = b"", []
    for text, span, word, bit, walk in pieces:
        data += junk[: int(rng.integers(0, 7))]
        meta = bit | int(walk) << 8 | word << 16
        descs.append([len(data), len(data) + len(text), span, meta])
        data += text
    data += junk
    return (
        torch.from_numpy(np.frombuffer(data, dtype=np.uint8).copy()),
        torch.tensor(descs, dtype=torch.int64),
    )


def node_lens(seed: int = 7) -> torch.Tensor:
    """int32 [N_ITEMS + 1] of 1..16 bp, slot 0 zero."""
    lens = np.random.default_rng(seed).integers(1, 17, size=N_ITEMS + 1).astype(np.int32)
    lens[0] = 0
    return torch.from_numpy(lens)


def outputs(spans: int, device=torch.device("cpu")) -> Tuple[torch.Tensor, torch.Tensor]:
    """A zeroed M and a fresh acc (error slot ERR_NONE)."""
    M = torch.zeros((N_WORDS, N_ITEMS + 7), dtype=torch.int32, device=device)
    acc = torch.zeros(1 + 2 * spans, dtype=torch.int64, device=device)
    acc[0] = int(parse_kernels.ERR_NONE)
    return M, acc
