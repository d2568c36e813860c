"""Parity of the port's counting BFS and index construction with the JAX
reference: the same graphs go through ``repro.core.{bfs,construct}``
and ``repro_torch.core.{bfs,construct}`` on the CPU, and every BFS
field and every index array must be equal (integers: exact), including
the label capacity the builders grew to."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bfs as JB
from repro.core import construct as JC
from repro.core import graph as JG
from repro.core import order as JO
from repro.core import query as JQ
from repro_torch.core import bfs as TB
from repro_torch.core import construct as TC
from repro_torch.core import graph as TG
from repro_torch.core import order as TO
from repro_torch.core import query as TQ
from repro_torch.data import random_graph_edges

HUB_BATCHES = (1, 4, 32)
ORDERS = ("id", "degree")

GRAPHS = {
    "powerlaw": (40, random_graph_edges(40, 100, seed=12)),
    "disconnected": (14, [(0, 1), (1, 2), (2, 0), (5, 6), (6, 7), (9, 10),
                          (12, 13)]),
}


def host(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def eq(a, b, what=""):
    a, b = host(a), host(b)
    assert a.dtype == b.dtype, (what, a.dtype, b.dtype)
    np.testing.assert_array_equal(a, b, err_msg=what)


def assert_index_equal(ji, ti):
    assert (ji.n, ji.l_cap) == (ti.n, ti.l_cap)
    for f in ("hub", "dist", "cnt", "size", "cnt_sum", "overflow"):
        eq(getattr(ji, f), getattr(ti, f), f)


def assert_bfs_equal(jr, tr):
    for f in ("dist", "cnt", "keep"):
        eq(getattr(jr, f), getattr(tr, f), f)
    assert int(jr.levels) == tr.levels


@pytest.fixture(scope="module")
def graphs():
    return {name: (JG.from_edges(n, e), TG.from_edges(n, e, device="cpu"))
            for name, (n, e) in GRAPHS.items()}


@pytest.fixture(scope="module")
def seq_index(graphs):
    """The sequential builders' indexes at a capacity that overflows
    and at one that fits, JAX and port."""
    jg, tg = graphs["powerlaw"]
    return {l_cap: (JC.build_index(jg, l_cap), TC.build_index(tg, l_cap))
            for l_cap in (4, 32)}


def test_sequential_build_matches(seq_index):
    for l_cap, (ji, ti) in seq_index.items():
        assert_index_equal(ji, ti)
    assert int(seq_index[4][1].overflow) > 0
    assert int(seq_index[32][1].overflow) == 0


@pytest.mark.parametrize("order", ORDERS)
@pytest.mark.parametrize("hub_batch", HUB_BATCHES)
def test_batched_build_matches(graphs, hub_batch, order):
    jg, tg = graphs["powerlaw"]
    grows_j, grows_t = [], []
    ji = JC.build_index_batched(jg, 4, hub_batch=hub_batch, order=order,
                                on_regrow=grows_j.append)
    ti = TC.build_index_batched(tg, 4, hub_batch=hub_batch, order=order,
                                on_regrow=grows_t.append)
    assert_index_equal(ji, ti)
    assert grows_t == grows_j and grows_t  # grown from 4, same schedule
    assert int(ti.overflow) == 0


def test_batched_equals_sequential_and_disconnected(graphs, seq_index):
    ti = TC.build_index_batched(graphs["powerlaw"][1], 32, hub_batch=8)
    assert_index_equal(seq_index[32][1], ti)  # same l_cap, same labels
    jg, tg = graphs["disconnected"]
    assert_index_equal(JC.build_index_batched(jg, None, hub_batch=4),
                       TC.build_index_batched(tg, None, hub_batch=4))
    assert TC.provision_l_cap(tg) == JC.provision_l_cap(jg)
    assert TC.provision_l_cap(graphs["powerlaw"][1]) == \
        JC.provision_l_cap(graphs["powerlaw"][0])
    with pytest.raises(ValueError, match="hub_batch"):
        TC.build_index_batched(tg, 4, hub_batch=0)


@pytest.mark.parametrize("root,rank_floor", [(0, None), (3, 3), (17, 5)])
def test_pruned_bfs_matches(graphs, seq_index, root, rank_floor):
    jg, tg = graphs["powerlaw"]
    ji, ti = seq_index[32]
    dbar_j, _ = JQ.one_to_all(ji, root, limit=root)
    dbar_t, _ = TQ.one_to_all(ti, root, limit=root)
    eq(dbar_j, dbar_t, "dbar")
    for root_dist, root_cnt in ((0, 1), (2, 5)):
        jr = JB.pruned_spc_bfs(jg, root, root_dist, root_cnt, dbar_j,
                               rank_floor=rank_floor)
        tr = TB.pruned_spc_bfs(tg, root, root_dist, root_cnt, dbar_t,
                               rank_floor=rank_floor)
        assert_bfs_equal(jr, tr)
    assert_bfs_equal(JB.plain_spc_bfs(jg, root), TB.plain_spc_bfs(tg, root))
    assert_bfs_equal(JB.plain_spc_bfs(jg, root, max_levels=1),
                     TB.plain_spc_bfs(tg, root, max_levels=1))
    stop_j = lambda dist, cnt, newly: dist < 2
    stop_t = lambda dist, cnt, newly: dist < 2
    assert_bfs_equal(JB.conditional_spc_bfs(jg, root, stop_j),
                     TB.conditional_spc_bfs(tg, root, stop_t))


def test_bfs_counts_host_syncs_per_level(graphs):
    _, tg = graphs["powerlaw"]
    TB.frontier_syncs.count = 0
    res = TB.plain_spc_bfs(tg, 0)
    # one frontier.any() read per level, plus the read that finds it empty
    assert TB.frontier_syncs.count == res.levels + 1


@pytest.mark.parametrize("h0,lanes", [(0, 4), (8, 8), (36, 8)])
def test_multi_bfs_matches(graphs, seq_index, h0, lanes):
    jg, tg = graphs["powerlaw"]
    ji, ti = seq_index[32]
    roots = np.arange(h0, h0 + lanes, dtype=np.int32)  # tail lanes >= n
    roots_c = np.minimum(roots, jg.n)
    dbar_j = jnp.stack([JQ.one_to_all(ji, int(r), limit=h0)[0]
                        for r in roots_c])
    dbar_t = TQ.one_to_all_dist_batch(ti, torch.from_numpy(roots_c), h0)
    eq(dbar_j, dbar_t, "dbar")
    for prune in (True, False):
        jr = JB.multi_pruned_spc_bfs(jg, jnp.asarray(roots), dbar_j,
                                     batch_rank_prune=prune)
        tr = TB.multi_pruned_spc_bfs(tg, torch.from_numpy(roots), dbar_t,
                                     batch_rank_prune=prune)
        assert_bfs_equal(jr, tr)


def test_relabel_then_build_matches_degree_order(graphs):
    jg, tg = graphs["powerlaw"]
    jo, to = JO.graph_ordering(jg, "degree"), TO.graph_ordering(tg, "degree")
    jr, tr = JO.relabel_graph(jg, jo), TO.relabel_graph(tg, to)
    eq(jr.src, tr.src)
    ti = TC.build_index_batched(tg, 32, hub_batch=4, order="degree")
    assert_index_equal(JC.build_index(jr, 32), ti)
