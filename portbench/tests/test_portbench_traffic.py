"""The one traffic generator: deterministic in the seed, and the same
sizes for every seed (only their order and the prompts' tokens move)."""

from __future__ import annotations

import numpy as np
import pytest

from portbench import spec as SPEC
from portbench import traffic as TR

SEED, OTHER = 3_000_000_019, 2_147_483_659  # seeds past 32 signed bits


def _key(planned):
    return [(p.uid, p.prompt.tobytes(), p.max_new) for p in planned]


def test_plan_is_deterministic_in_the_seed():
    t = SPEC.load_traffic("chat-c128")
    a = TR.plan(t, 151552, SEED)
    b = TR.plan(t, 151552, SEED)
    c = TR.plan(t, 151552, OTHER)
    assert _key(a) == _key(b)
    assert _key(a) != _key(c)


def test_every_block_holds_the_same_sizes_for_every_seed():
    t = SPEC.load_traffic("chat-c128")
    B = t["block"]
    a = TR.plan(t, 1000, SEED)
    c = TR.plan(t, 1000, OTHER)
    skip = t["clients"]  # the first requests start part-way
    for plan in (a, c):
        for b0 in range(-(-skip // B) * B, len(plan) - B + 1, B):
            blk = plan[b0:b0 + B]
            assert sorted(len(p.prompt) for p in blk) == sorted(TR.quantiles(t["prompt"], B))
            assert sorted(p.max_new for p in blk) == sorted(TR.quantiles(t["output"], B))
    assert [len(p.prompt) for p in a] != [len(p.prompt) for p in c]  # another order
    assert sorted(len(p.prompt) for p in a[:skip]) == sorted(len(p.prompt) for p in c[:skip])


def test_quantiles_stay_in_their_ranges():
    t = SPEC.load_traffic("chat-c128")
    for key in ("prompt", "output"):
        q = TR.quantiles(t[key], t["block"])
        assert q.min() >= t[key]["lo"] and q.max() <= t[key]["hi"]
    q = TR.quantiles({"dist": "loguniform", "lo": 64, "hi": 2048}, 1000)
    # log-uniform: the median at the geometric mean of the range
    assert abs(np.log(np.median(q)) - 0.5 * np.log(64 * 2049)) < 0.01


def test_closed_loop_first_requests_start_part_way():
    t = SPEC.load_traffic("chat-c128")
    plan = TR.plan(t, 1000, SEED)
    k = t["clients"]
    assert len(plan) == TR.CLOSED_POOL
    assert all(p.max_new >= 1 for p in plan[:k])
    assert np.mean([p.max_new for p in plan[:k]]) < np.mean([p.max_new for p in plan[k:]])
