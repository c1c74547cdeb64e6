"""The traffic generator: a seed draws the same queue every time, another
seed other tokens over the same sizes in the same order, and every
prefix of a deck spreads over the whole length distribution."""
import numpy as np

from portbench import manifest, traffic


def _mix():
    return manifest.mix("repo-context")


def test_same_seed_same_traffic():
    a = traffic.requests(_mix(), 49152, 2 ** 31 + 17)
    b = traffic.requests(_mix(), 49152, 2 ** 31 + 17)
    assert len(a) == len(b) == _mix()["requests"]
    assert all(np.array_equal(x[0], y[0]) and x[1] == y[1]
               for x, y in zip(a, b))


def test_other_seed_other_tokens_same_sizes():
    a = traffic.requests(_mix(), 49152, 2 ** 31 + 17)
    b = traffic.requests(_mix(), 49152, 2 ** 31 + 18)
    assert [(len(p), n) for p, n in a] == [(len(p), n) for p, n in b]
    assert not np.array_equal(a[0][0][:64], b[0][0][:64])
    assert len(traffic.requests(_mix(), 49152, -3)) == _mix()["requests"]


def test_the_job_is_the_deck_over_and_over():
    mix = dict(_mix(), requests=70)
    want = traffic.deck(mix) * 3
    q = traffic.requests(mix, 49152, 10 ** 12)
    assert [(len(p), new) for p, new in q] == want[:70]


def test_every_prefix_spreads_over_the_distribution():
    mix = _mix()
    d = traffic.deck(mix)
    ranks = {s: i for i, s in enumerate(sorted(d))}
    order = [ranks[p] for p in d]
    assert sorted(order) == list(range(len(d)))
    mean = (len(d) - 1) / 2
    for k in (4, 8, 16, 24, 28):
        assert abs(sum(order[:k]) / k - mean) < 0.15 * len(d)


def test_sizes_follow_the_mix():
    mix = _mix()
    d = traffic.deck(mix)
    prompts = sorted(s for s, _ in d)
    assert prompts[0] >= mix["prompt"]["min"]
    assert prompts[-1] <= mix["prompt"]["max"]
    assert abs(prompts[len(prompts) // 2] - mix["prompt"]["median"]) < 150
    assert all(mix["output"]["min"] <= o <= mix["output"]["max"]
               for _, o in d)
    q = traffic.requests(mix, 49152, 3)
    assert all(p.dtype == np.int32 and p.min() >= 1 and p.max() < 49152
               for p, _ in q[:40])
