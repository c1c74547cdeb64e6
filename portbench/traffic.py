"""The one traffic generator: a mix file's parameters -> a request list.

An offline mix (``"kind": "offline"``) is a job of ``requests``
requests.  The mix's ``deck`` is a fixed set of (prompt length, output
length) pairs at the quantiles of the two distributions, and the job is
the deck over and over, in one fixed order: the pairs sorted by prompt
length and taken in bit-reversed order, so that every prefix spreads
over the whole distribution.  Every seed serves the same sizes in the
same order: with each deck shuffled by the seed, which sizes a window
finished changed with the seed, and ``tokens_per_s`` moved 12-15%
between seeds against 0-3% between two runs of one seed (H100, PR 28).
The seed draws the token ids, uniformly over ``[1, vocab)`` (0 is the
engine's pad id), and elsewhere the weights and the MCA key.
"""
from __future__ import annotations

import math
import statistics
from typing import Dict, List, Tuple

import numpy as np

#: the deck's pairing of prompt quantiles with output quantiles: a fixed
#: permutation, the same for every seed, so a pair's sizes are not
#: correlated (long prompts do not always get long outputs)
_PAIRING_SEED = 20240219


def _quantile(dist: Dict, q: float) -> float:
    kind = dist["dist"]
    if kind == "lognormal":
        z = statistics.NormalDist().inv_cdf(q)
        return dist["median"] * math.exp(dist["sigma"] * z)
    if kind == "uniform":
        lo, hi = dist["min"], dist["max"]
        return lo + q * (hi - lo + 1) - 0.5
    raise ValueError(f"unknown length distribution {kind!r}")


def _lengths(dist: Dict, n: int) -> List[int]:
    """``n`` lengths at the quantiles (i + 0.5) / n, clipped to the
    distribution's [min, max]."""
    out = []
    for i in range(n):
        v = int(round(_quantile(dist, (i + 0.5) / n)))
        out.append(min(max(v, dist["min"]), dist["max"]))
    return out


def _bit_reversed(n: int) -> List[int]:
    """0..n-1 in the order of their bit-reversed values (n a power of
    two: 0, n/2, n/4, 3n/4, ...); other n keep that order's members
    below n."""
    bits = max(1, (n - 1).bit_length())
    order = sorted(range(1 << bits),
                   key=lambda i: int(format(i, f"0{bits}b")[::-1], 2))
    return [i for i in order if i < n]


def deck(mix: Dict) -> List[Tuple[int, int]]:
    """The mix's (prompt length, output length) pairs in queue order."""
    n = mix["deck"]
    prompts = _lengths(mix["prompt"], n)
    outputs = _lengths(mix["output"], n)
    pair = np.random.default_rng(_PAIRING_SEED).permutation(n)
    pairs = [(prompts[i], outputs[int(pair[i])]) for i in range(n)]
    return [pairs[i] for i in _bit_reversed(n)]


def requests(mix: Dict, vocab: int, seed: int
             ) -> List[Tuple[np.ndarray, int]]:
    """The job of one run: ``mix["requests"]`` (prompt int32 [S],
    max_new) pairs, the deck over and over, token ids from ``seed``."""
    pairs = deck(mix)
    rng = np.random.default_rng(seed % (1 << 64))
    out = []
    while len(out) < mix["requests"]:
        for s, new in pairs:
            prompt = rng.integers(1, vocab, size=s, dtype=np.int64)
            out.append((prompt.astype(np.int32), new))
    return out[:mix["requests"]]
