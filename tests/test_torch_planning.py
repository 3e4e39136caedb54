"""The port's planning core (``repro_torch.core``) against the reference.

The port's copies of the numpy/stdlib planning modules must give the
reference's results bitwise: graph digests, DP solves (exact and approximate,
time- and memory-centric, with and without a strategy lattice), budget
sweeps, the exact minimal budget and the live peak, on three of the paper's
benchmark networks (converted node for node) and on random DAGs.  A plan the
reference writes to a disk store is a cache hit for the port.
"""

import dataclasses
import random

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

networks = pytest.importorskip("benchmarks.networks")
from conftest import random_dag  # noqa: E402
from repro.core import dp as rdp  # noqa: E402
from repro.core import graph as rgraph  # noqa: E402
from repro.core import lower_sets as rls  # noqa: E402
from repro.core.plan_cache import PlanCache as RPlanCache  # noqa: E402
from repro.core.planner import Planner as RPlanner  # noqa: E402
from repro.core.strategies import StrategyConfig as RStrategyConfig  # noqa: E402
from repro_torch.core import dp as pdp  # noqa: E402
from repro_torch.core import graph as pgraph  # noqa: E402
from repro_torch.core import lower_sets as pls  # noqa: E402
from repro_torch.core.plan_cache import PlanCache as PPlanCache  # noqa: E402
from repro_torch.core.planner import Planner as PPlanner  # noqa: E402
from repro_torch.core.strategies import StrategyConfig as PStrategyConfig  # noqa: E402

NETWORKS = ["vgg19", "resnet50", "unet"]
#: the strategy-lattice DP on resnet50 takes ~7 s a side; it runs on the rest
LATTICE_SKIP = {"resnet50"}
OBJECTIVES = ["time_centric", "memory_centric"]


def edge_order(g):
    """An edge list that rebuilds ``g``'s succ *and* pred lists in order.

    ``Graph.edges`` is a frozenset, but the order edges were added fixes the
    adjacency lists, hence the topological order and the live peak; so the
    conversion orders the edges by both lists' constraints."""
    edges = [(v, w) for v in range(len(g.nodes)) for w in g.succ[v]]
    after = {e: [] for e in edges}
    indeg = dict.fromkeys(edges, 0)
    for v, s in enumerate(g.succ):
        for a, b in zip(s, s[1:]):
            after[(v, a)].append((v, b))
            indeg[(v, b)] += 1
    for w, p in enumerate(g.pred):
        for a, b in zip(p, p[1:]):
            after[(a, w)].append((b, w))
            indeg[(b, w)] += 1
    ready = [e for e in edges if indeg[e] == 0]
    out = []
    while ready:
        e = ready.pop()
        out.append(e)
        for f in after[e]:
            indeg[f] -= 1
            if indeg[f] == 0:
                ready.append(f)
    return out


def to_port(g):
    """The reference graph, node for node and edge for edge, as a port graph."""
    nodes = [pgraph.Node(n.idx, n.name, n.time, n.memory, n.kind,
                         must_store=n.must_store) for n in g.nodes]
    pg = pgraph.Graph(nodes, edge_order(g), cost_source=g.cost_source)
    assert pg.succ == g.succ and pg.pred == g.pred
    return pg


def strategy_configs(g):
    """The same extended lattice for both packages: offload and quantize
    taxes priced at the graph's mean bytes per time unit, so the DP really
    trades them against recompute."""
    bw = sum(n.memory for n in g.nodes) / sum(n.time for n in g.nodes)
    kw = dict(strategies=("store", "recompute", "offload", "quantize"),
              offload_bytes_per_sec=bw / 2, quantize_bytes_per_sec=2 * bw)
    return RStrategyConfig(**kw), PStrategyConfig(**kw)


def graphs():
    for name in NETWORKS:
        yield name, getattr(networks, name)()
    for seed in range(4):
        r = random.Random(1000 + seed)
        yield f"dag{seed}", random_dag(r, r.randint(6, 11))


GRAPHS = dict(graphs())


def same_result(a, b):
    assert dataclasses.asdict(a) == dataclasses.asdict(b)


@pytest.mark.parametrize("name", list(GRAPHS))
def test_digest_budget_and_peak_bitwise(name):
    g = GRAPHS[name]
    pg = to_port(g)
    assert pgraph.graph_digest(pg) == rgraph.graph_digest(g)
    assert pgraph.canonical_order(pg) == rgraph.canonical_order(g)
    fam, pfam = rls.all_lower_sets(g), pls.all_lower_sets(pg)
    assert pfam == fam
    assert pls.pruned_lower_sets(pg) == rls.pruned_lower_sets(g)
    b = rdp.min_feasible_budget_exact(g, fam)
    assert pdp.min_feasible_budget_exact(pg, pfam) == b
    r = rdp.solve(g, 1.25 * b, fam)
    assert pdp.peak_memory_live(pg, r.sequence) == rdp.peak_memory_live(g, r.sequence)
    assert pdp.overhead(pg, r.sequence) == rdp.overhead(g, r.sequence)


@pytest.mark.parametrize("objective", OBJECTIVES)
@pytest.mark.parametrize("name", list(GRAPHS))
def test_solve_bitwise(name, objective):
    """Exact and approximate DP, with and without a strategy lattice."""
    g = GRAPHS[name]
    pg = to_port(g)
    rcfg, pcfg = strategy_configs(g)
    for family in (rls.all_lower_sets, rls.pruned_lower_sets):
        fam = family(g)
        pfam = [frozenset(L) for L in fam]
        b = rdp.min_feasible_budget_exact(g, fam)
        for frac in (1.0, 1.5, 4.0):
            same_result(pdp.solve(pg, frac * b, pfam, objective),
                        rdp.solve(g, frac * b, fam, objective))
        if name in LATTICE_SKIP:
            continue
        bs = rdp.min_feasible_budget_exact(g, fam, strategies=rcfg)
        assert pdp.min_feasible_budget_exact(pg, pfam, strategies=pcfg) == bs
        same_result(pdp.solve(pg, 1.2 * bs, pfam, objective, strategies=pcfg),
                    rdp.solve(g, 1.2 * bs, fam, objective, strategies=rcfg))


@pytest.mark.parametrize("name", [n for n in GRAPHS if n != "resnet50"])
def test_sweep_extract_bitwise(name):
    g = GRAPHS[name]
    pg = to_port(g)
    fam = rls.all_lower_sets(g)
    rs, ps = rdp.sweep(g, fam), pdp.sweep(pg, [frozenset(L) for L in fam])
    b = rdp.min_feasible_budget_exact(g, fam)
    for frac in (0.9, 1.0, 1.3, 2.0, 10.0):
        assert ps.extract(frac * b) == rs.extract(frac * b)


@pytest.mark.parametrize("name", ["vgg19", "dag0"])
def test_reference_disk_plan_is_a_port_cache_hit(tmp_path, name):
    g = GRAPHS[name]
    store = str(tmp_path / "plans")
    b = 1.3 * rdp.min_feasible_budget_exact(g, rls.all_lower_sets(g))
    first = RPlanner(cache=RPlanCache(cache_dir=store)).solve(g, b, "exact_dp")
    cache = PPlanCache(cache_dir=store)
    again = PPlanner(cache=cache).solve(to_port(g), b, "exact_dp")
    assert cache.stats()["disk_hits"] == 1
    same_result(again, first)
