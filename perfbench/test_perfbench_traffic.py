"""The request generator: the same seed gives the same requests, and every
seed serves the same sizes in the same order, with other tokens."""
import numpy as np

from perfbench import bench
from perfbench.requests import ClosedLoopRequests, size_table

MIX = bench.traffic("code-completion")


def test_sizes_span_the_ranges_evenly():
    table = size_table(MIX)
    prompts = sorted(p for p, _ in table)
    news = sorted(n for _, n in table)
    assert len(table) == MIX["clients"]
    assert MIX["prompt_tokens"][0] <= prompts[0] and prompts[-1] <= MIX["prompt_tokens"][1]
    assert MIX["new_tokens"][0] <= news[0] and news[-1] <= MIX["new_tokens"][1]
    assert len(set(prompts)) == len(prompts)
    assert abs(np.mean(prompts) - np.mean(MIX["prompt_tokens"])) < 50


def test_same_seed_same_requests():
    a, b = ClosedLoopRequests(MIX, 2**31 + 7, 49152), ClosedLoopRequests(MIX, 2**31 + 7, 49152)
    for c, r in ((0, 0), (31, 5), (7, 2)):
        assert a.sizes(c, r) == b.sizes(c, r)
        np.testing.assert_array_equal(a.prompt(c, r), b.prompt(c, r))


def test_every_seed_serves_the_same_sizes_in_the_same_order():
    a, b = ClosedLoopRequests(MIX, 1, 49152), ClosedLoopRequests(MIX, 4_000_000_000, 49152)
    n = MIX["clients"]
    for r in range(4):
        assert sorted(a.sizes(c, r) for c in range(n)) == sorted(size_table(MIX))
        assert [a.sizes(c, r) for c in range(n)] == [b.sizes(c, r) for c in range(n)]
    assert [a.sizes(c, 0) for c in range(n)] != [a.sizes(c, 1) for c in range(n)]
    assert not np.array_equal(a.prompt(0, 0)[:64], b.prompt(0, 0)[:64])


def test_prompts_differ_and_stay_in_the_vocabulary():
    g = ClosedLoopRequests(MIX, 3, 49152)
    p0, p1 = g.prompt(0, 0), g.prompt(1, 0)
    assert len(p0) == g.sizes(0, 0)[0]
    assert p0.min() >= 1 and p0.max() < 49152
    assert not np.array_equal(p0[:100], p1[:100])
