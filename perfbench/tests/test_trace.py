"""The traced run's reductions: busy intervals and the idle gaps named by
the host span open when each began."""

import random

from perfbench import harness


def brute_gaps(kernels, host):
    busy = harness.busy_intervals(kernels)
    gaps = {}
    for (_, a), (b, _) in zip(busy, busy[1:]):
        open_spans = [h for h in host if h[1] <= a <= h[1] + h[2]]
        name = max(open_spans, key=lambda h: h[1])[0] if open_spans else "(no host span)"
        gaps[name] = gaps.get(name, 0.0) + (b - a) * 1e-6
    return [[k, v] for k, v in sorted(gaps.items(), key=lambda kv: -kv[1])[:10]]


def test_busy_intervals_merge_overlaps():
    k = [("a", 0.0, 10.0), ("b", 5.0, 10.0), ("c", 20.0, 1.0)]
    assert harness.busy_intervals(k) == [[0.0, 15.0], [20.0, 21.0]]


def test_idle_gaps_name_the_innermost_open_host_span():
    rng = random.Random(0)
    kernels, host, t = [], [], 0.0
    for i in range(400):
        t += rng.random() * 10
        d = rng.random() * 20
        kernels.append((f"k{i % 7}", t, d))
        t += d
    t = 0.0
    for i in range(1200):
        t += rng.random() * 5
        host.append((f"h{i % 30}", t, rng.random() * 40))
    got = harness.breakdown({"kernels": kernels, "host": host})
    assert got["idle_gaps"] == brute_gaps(kernels, host)
    assert len(got["device_ops"]) == 7
