"""Whether what the timed path served is correct.

Once the window has closed, ``draw`` takes a sample of the requests it
finished, drawn from the seed: the longest, one that still holds its
slot, and others until the sample holds the mix's ``check_tokens``
served tokens; the family's recorder (``follow/<family>.py``) copies the
K/V cache rows of the sampled requests that still hold their slot.
Once the program is freed, ``checks`` has the family's ``readings`` run
the plain float32 reference (``reference/<family>.py``) over the sample,
on weights made again from the seed, and compares each number with its
limit (``limits/<cell>.json``; the family's exact numbers with 0).  A
number the limits name that the run did not read fails it.  Beside them:
the sampled tokens (at least ``check_tokens``) and the failed, degraded
and short requests (none).
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from portbench import manifest

MAX_REQUESTS = 12


def sample(completed: List, seed: int, min_tokens: int,
           resident=frozenset()) -> List:
    """The longest finished request, one whose uid is in ``resident``
    (if the longest is not), then others drawn from ``seed`` until the
    sample holds ``min_tokens`` served tokens."""
    if not completed:
        return []
    longest = max(completed, key=lambda r: (len(r.prompt) + len(r.out),
                                            -r.uid))
    rest = [r for r in completed if r is not longest]
    rng = np.random.default_rng([seed % (1 << 64), 7])
    order = [rest[int(i)] for i in rng.permutation(len(rest))]
    if longest.uid not in resident:
        held = [r for r in order if r.uid in resident]
        if held:
            order.remove(held[0])
            order.insert(0, held[0])
    pick, tokens = [longest], len(longest.out)
    for r in order:
        if tokens >= min_tokens or len(pick) >= MAX_REQUESTS:
            break
        pick.append(r)
        tokens += len(r.out)
    return pick


def draw(window, seed: int, min_tokens: int) -> List:
    """The sample of ``window``'s finished requests that the check reads,
    with the K/V rows of those still in their slot copied."""
    ok = [r for r in window.completed if r.status == "ok"]
    picked = sample(ok, seed, min_tokens, window.recorder.resident(ok))
    window.recorder.snapshot(picked)
    return picked


def checks(window, cfg: Dict, mix: Dict, seed: int, limits: Dict,
           device, picked: List) -> Tuple[bool, Dict]:
    """(correct, {name: {"value", "limit"}}) of one run."""
    fam = manifest.follow(cfg["family"])
    need = mix["check_tokens"]
    nums = (fam.readings(cfg, seed, picked, device, window.recorder)
            if picked else {})
    out, ok = {}, True
    for name, lim in limits.items():
        v = nums.get(name)
        out[name] = {"value": v, "limit": lim["limit"]}
        ok = ok and v is not None and v <= lim["limit"]
    for name in fam.EXACT:
        v = nums.get(name)
        out[name] = {"value": v, "limit": 0}
        ok = ok and v == 0
    short = sum(len(r.out) != r.max_new for r in window.completed)
    out.update(
        sampled_tokens={"value": sum(len(r.out) for r in picked),
                        "limit": need},
        failed_requests={"value": window.failed, "limit": 0},
        degraded_requests={"value": window.degraded, "limit": 0},
        short_outputs={"value": short, "limit": 0})
    ok = (ok and out["sampled_tokens"]["value"] >= need
          and window.failed == 0 and window.degraded == 0 and short == 0)
    return ok, out
