"""Step lists for the tests of panacus_torch.ops.parse_kernels (the
plain version of pt_parse_pack, the kernel on the card, the host tokenizer).

A case is a list of step lists (bytes, span, word, bit, walk), laid into
one text between bytes of other GFA fields (which hold ',', '>', digits and
orientations that the parse must skip) with one descriptor row each, and
whether every token of it is good. Ids run up to N_ITEMS, past seven
digits.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

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
