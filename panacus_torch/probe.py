"""The raw-read control and the hist-formulation probes, on the card.

    python -m panacus_torch.probe [--rounds R] [--words W] [--items N]
                                  [--seed S] [variant ...]

The counterpart of scripts/kernel_probe.py (one variant per process) and
scripts/kernel_interleave.py (all variants round-robin in one process), in
one: every round times every requested variant back to back, then a
summary gives each variant's median and its ratio to `read`. Variants:

  read         pt_xor_fold: XOR-reduce M, no other work (the raw-read
               ceiling of bench.py:_xor_read_bw)
  pc, pcl      pt_word_fold, popcount with the adds on the ALU (the two TPU
               variants differ only in their code generation: one call,
               timed once, reported under both names)
  pcm          pt_word_fold, popcount with the coverage on the int8 tensor
               cores
  pcx          pt_word_fold, a plain cast in place of the popcount
  cur1-3       pt_fused_hist with one weight vector; it has no limbs, so the
               three are one call, timed once; it takes no salt, so pass i
               reads a copy of the weights plus i, made in the untimed
               warm-up
  old1-3       pt_limb_hist, the weight byte on the coarse operand
  fh21-3       pt_limb_hist, the weight byte on the fine operand
  fhm1-3       pt_limb_hist, fine operand, coverage on the tensor cores
  parity       check, no timing: pt_limb_hist (fine operand, 3 limbs),
               recombined, equals pt_fused_hist exactly
  paritym      the same with the coverage on the tensor cores

Defaults: the variants of kernel_interleave.py (read pc pcm fh21 fhm1 fh23
fhm3 cur1 cur3), 5 rounds, M uint32 [32, 2^23] (1 GiB) of random bits and
one weight vector drawn in [0, 2^20), both from --seed with a
torch.Generator on the device.

Timing: a chain of K passes and one of 3K, pass i given salt i (added to
the weights inside the kernel, the TPU chain's `w + i`), each timed with
CUDA events, 5 times in turns; the time per pass is the slope (median(3K)
- median(K)) / 2K, which cancels launch overhead. K is 16 for `read` and
8 for the others, as in the TPU scripts. A rate is the bytes of M and the
weights over the time per pass. 1 GiB is far beyond the 50 MB L2 cache,
so nothing is flushed. A slope of 0 or less is an error. With
PANACUS_TORCH_DEVICE=cpu the plain versions run, timed by the host clock:
those numbers describe the CPU, not the card.
"""

from __future__ import annotations

import argparse
import statistics
import sys
import time
from typing import Callable, Dict, List, Optional, Tuple

import torch

from . import runtime
from .ops import hist_kernels as hk
from .ops import probe_kernels as pk

# variant -> (kernel, keyword arguments of its wrapper and of its plain
# version): the one table of which call each variant makes
ROUTES: Dict[str, Tuple[str, dict]] = {
    "read": ("pt_xor_fold", {}),
    "pc": ("pt_word_fold", {"op": "popc", "mma_cov": False}),
    "pcm": ("pt_word_fold", {"op": "popc", "mma_cov": True}),
    "pcx": ("pt_word_fold", {"op": "cast", "mma_cov": False}),
    "cur1": ("pt_fused_hist", {}),
    **{
        f"{prefix}{n}": ("pt_limb_hist", {"n_limbs": n, "weight_side": side, "mma_cov": mma})
        for prefix, side, mma in (("old", "coarse", False), ("fh2", "fine", False), ("fhm", "fine", True))
        for n in (1, 2, 3)
    },
}
# TPU variants that make the same call as another here: timed once, and
# reported under both names
ALIASES = {"pcl": "pc", "cur2": "cur1", "cur3": "cur1"}
VARIANTS = (
    "read", "pc", "pcl", "pcm", "pcx", "cur1", "cur2", "cur3",
    "old1", "old2", "old3", "fh21", "fh22", "fh23", "fhm1", "fhm2", "fhm3",
    "parity", "paritym",
)
DEFAULT_VARIANTS = ("read", "pc", "pcm", "fh21", "fhm1", "fh23", "fhm3", "cur1", "cur3")
CHECKS = ("parity", "paritym")
N_WORDS, N_ITEMS = 32, 1 << 23
W_MAX = 1 << 20  # weights in [0, 2^20), kernel_probe.py:44
K, K_READ = 8, 16
REPS = 5


class ProbeError(RuntimeError):
    pass


def route(name: str) -> Tuple[str, dict]:
    """(kernel, keyword arguments) of a timed variant or its alias."""
    return ROUTES[ALIASES.get(name, name)]


def make_inputs(device: torch.device, n_words: int, n_items: int, seed: int):
    """M int32 [n_words, n_items] of random bits and w int32 [1, n_items] in
    [0, W_MAX), both from `seed` on `device`."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    M = torch.randint(
        -(2**31), 2**31, (n_words, n_items), dtype=torch.int32, device=device,
        generator=g,
    )
    w = torch.randint(0, W_MAX, (1, n_items), dtype=torch.int32, device=device, generator=g)
    return M, w


def n_bins_for(n_words: int) -> int:
    """Every coverage of n_words words, and the sentinel's: 32 n_words + 2."""
    return 32 * n_words + 2


def pass_fn(
    name: str, M: torch.Tensor, w: torch.Tensor, plain: bool = False
) -> Callable[[int], torch.Tensor]:
    """One pass of a timed variant, given its salt: its kernel's wrapper or,
    with plain=True, that kernel's plain version, on the variant's route.
    pt_fused_hist takes no salt, so pass s of a cur variant reads its own
    copy w + s, made when s first comes (in the untimed warm-up chains)."""
    kernel, kw = route(name)
    n_bins = n_bins_for(M.shape[0])
    if kernel == "pt_xor_fold":
        f = pk.xor_fold_ref if plain else pk.xor_fold
        return lambda s: f(M, w, s)
    if kernel == "pt_word_fold":
        f = pk.word_fold_ref if plain else pk.word_fold
        return lambda s: f(M, w, s, **kw)
    if kernel == "pt_limb_hist":
        f = pk.limb_hist_ref if plain else pk.limb_hist
        return lambda s: f(M, w, n_bins, salt=s, **kw)
    f = hk.fused_hist_ref if plain else hk.fused_hist
    salted: Dict[int, torch.Tensor] = {}

    def cur(s: int) -> torch.Tensor:
        if s not in salted:
            salted[s] = pk.salted(w, s)
        return f(M, salted[s], n_bins)

    return cur


def pass_work(name: str, M: torch.Tensor, w: torch.Tensor) -> Tuple[int, int, bool]:
    """(bytes, operations, on the int8 tensor cores) of one pass of a
    variant: M and the weights read once, the output written once; per item
    an XOR per word (read), a popcount and an add per word (the word folds;
    pt_fused_hist adds one per vector), or 2 operations per coarse x fine
    product and limb (pt_limb_hist, counted at the coarse bins it keeps)."""
    kernel, kw = route(name)
    n_words, n_items = M.shape
    n_vecs = w.shape[0]
    nbytes = pass_bytes(M, w)
    if kernel == "pt_xor_fold":
        return nbytes + 4, n_items * (n_words + 1), False
    if kernel == "pt_word_fold":
        return nbytes + 4 * pk.BLOCK_ITEMS, n_items * 2 * n_words, False
    n_bins = n_bins_for(n_words)
    if kernel == "pt_fused_hist":
        return nbytes + n_vecs * n_bins * 8, n_items * (2 * n_words + n_vecs), False
    width = pk.n_coarse_for(n_bins) * pk.FINE
    rows = kw["n_limbs"] * n_vecs
    return nbytes + rows * width * 8, 2 * rows * width * n_items, True


def parity(M: torch.Tensor, w: torch.Tensor, mma_cov: bool) -> bool:
    """pt_limb_hist (fine operand, 3 limbs), recombined, == pt_fused_hist."""
    n_bins = n_bins_for(M.shape[0])
    H = pk.limb_hist(M, w, n_bins, 3, 0, "fine", mma_cov)
    got = pk.recombine(H, w.shape[0], 3)[:, :n_bins]
    return torch.equal(got, hk.fused_hist(M, w, n_bins))


def _chain_seconds(fn: Callable[[int], torch.Tensor], k: int, device: torch.device) -> float:
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for i in range(k):
            fn(i)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3
    t0 = time.perf_counter()
    for i in range(k):
        fn(i)
    return time.perf_counter() - t0


def pass_seconds(fn: Callable[[int], torch.Tensor], k: int, device: torch.device) -> float:
    """Seconds per pass: the slope between chains of k and 3k passes."""
    _chain_seconds(fn, k, device)  # warm both
    _chain_seconds(fn, 3 * k, device)
    t1, t3 = [], []
    for _ in range(REPS):
        t1.append(_chain_seconds(fn, k, device))
        t3.append(_chain_seconds(fn, 3 * k, device))
    dt = statistics.median(t3) - statistics.median(t1)
    if dt <= 0:
        raise ProbeError(f"chain time does not grow with its length (slope {dt!r} s)")
    return dt / (2 * k)


def pass_bytes(M: torch.Tensor, w: torch.Tensor) -> int:
    """What every variant must read once: M and the weights."""
    return (M.numel() + w.numel()) * 4


def read_ceiling_bps(
    device: Optional[torch.device] = None,
    n_words: int = N_WORDS,
    n_items: int = N_ITEMS,
    seed: int = 0,
) -> float:
    """Bytes per second of the raw-read control (pt_xor_fold) on `device`
    (default: the first of runtime.resolve_devices()) at M [n_words, n_items]."""
    device = runtime.resolve_devices()[0] if device is None else torch.device(device)
    M, w = make_inputs(device, n_words, n_items, seed)
    return pass_bytes(M, w) / pass_seconds(pass_fn("read", M, w), K_READ, device)


def device_label(device: torch.device) -> str:
    if device.type == "cuda":
        return f"{torch.cuda.get_device_name(device)} (CUDA events)"
    return "cpu (plain versions, host clock: not a device number)"


def run(
    variants: List[str],
    rounds: int,
    M: torch.Tensor,
    w: torch.Tensor,
    out=print,
) -> Dict[str, List[float]]:
    """Every round times each distinct call of the timed variants in turn;
    returns the seconds per pass of each variant for each round (an alias
    gets the list of the variant it names). Checks run once, first, and
    raise on a mismatch."""
    device = M.device
    nbytes = pass_bytes(M, w)
    for name in variants:
        if name in CHECKS:
            ok = parity(M, w, mma_cov=name == "paritym")
            kind = "fhm" if name == "paritym" else "fh2"
            out(f"parity {kind} vs current: {ok}")
            if not ok:
                raise ProbeError(f"{name}: pt_limb_hist != pt_fused_hist")
    timed = [v for v in variants if v not in CHECKS]
    fns = {ALIASES.get(v, v): None for v in timed}
    for name in fns:
        fns[name] = pass_fn(name, M, w)
        t0 = time.perf_counter()
        fns[name](0)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        out(f"first pass of {name} in {time.perf_counter() - t0:.3f} s")
    times: Dict[str, List[float]] = {v: [] for v in fns}
    for r in range(rounds):
        line = []
        for name, fn in fns.items():
            t = pass_seconds(fn, K_READ if name == "read" else K, device)
            times[name].append(t)
            line.append(f"{name}={nbytes / t / 1e9:.1f}")
        out(f"round {r}: " + " ".join(line) + " (GB/s)")
    return {v: times[ALIASES.get(v, v)] for v in timed}


def summary(times: Dict[str, List[float]], nbytes: int, out=print) -> Dict[str, float]:
    """Median seconds per pass of each variant, printed with its GB/s and
    its ratio to read."""
    med = {v: statistics.median(ts) for v, ts in times.items() if ts}
    out("medians (GB/s, ms per pass, ratio to read):")
    for name, t in med.items():
        ratio = f"{med['read'] / t:.3f} of read" if "read" in med else "no read"
        note = f" (the call of {ALIASES[name]}, timed once)" if name in ALIASES else ""
        out(f"  {name}: {nbytes / t / 1e9:.1f} GB/s, {t * 1e3:.4f} ms ({ratio}){note}")
    return med


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m panacus_torch.probe", description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--words", type=int, default=N_WORDS)
    ap.add_argument("--items", type=int, default=N_ITEMS)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("variants", nargs="*", metavar="variant", help=" ".join(VARIANTS))
    args = ap.parse_args(argv)
    unknown = [v for v in args.variants if v not in VARIANTS]
    if unknown:
        ap.error(f"unknown variants {unknown}; choose from {' '.join(VARIANTS)}")
    if args.words < 1 or args.items < 4 or args.items % 4 or args.rounds < 1:
        ap.error("need --words >= 1, --items a positive multiple of 4, --rounds >= 1")
    variants = list(dict.fromkeys(args.variants or DEFAULT_VARIANTS))
    device = runtime.resolve_devices()[0]
    M, w = make_inputs(device, args.words, args.items, args.seed)
    nbytes = pass_bytes(M, w)
    print(f"probe on {device_label(device)}: M {args.words} x {args.items}, "
          f"{nbytes / 1e9:.3f} GB per pass, seed {args.seed}", flush=True)
    try:
        times = run(variants, args.rounds, M, w, out=lambda s: print(s, flush=True))
    except ProbeError as e:
        print(f"probe: {e}", file=sys.stderr)
        return 1
    summary(times, nbytes, out=lambda s: print(s, flush=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
