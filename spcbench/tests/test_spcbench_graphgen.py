"""The generator: exact sizes, determinism, the fitted largest degree
and largest component, the effective diameter as assumed, and the insert
stream's protocol and strata."""

import json

import numpy as np
import pytest

from conftest import ROOT
from spcbench import graphgen

CONFIGS = ["enron", "astroph"]


def config(name):
    return json.loads((ROOT / "spcbench" / "configs" / f"{name}.json")
                      .read_text())


def draw(cfg, seed):
    return graphgen.chung_lu_edges(cfg["n"], cfg["m"], cfg["alpha"],
                                   cfg["i0"], seed)


@pytest.mark.parametrize("name", CONFIGS)
def test_exact_sizes(name):
    cfg = config(name)
    e = draw(cfg, 2 ** 33 + 7)
    assert e.shape == (cfg["m"], 2)
    assert (e[:, 0] < e[:, 1]).all()                 # no self-loops
    assert e.min() >= 0 and e.max() < cfg["n"]
    assert np.unique(e[:, 0] * cfg["n"] + e[:, 1]).size == cfg["m"]


@pytest.mark.parametrize("name", CONFIGS)
def test_deterministic_per_seed(name):
    cfg = config(name)
    assert np.array_equal(draw(cfg, 11), draw(cfg, 11))
    assert not np.array_equal(draw(cfg, 11), draw(cfg, 12))


@pytest.mark.parametrize("name", CONFIGS)
def test_expected_largest_degree(name):
    """Over fresh seeds the largest degree averages the dataset's, and
    it falls on one of the heaviest ids (the top 1%)."""
    cfg = config(name)
    target = cfg["assumed"]["max_degree"]
    mean = graphgen.mean_top_degree(cfg["n"], cfg["m"], cfg["alpha"],
                                    cfg["i0"], seeds=(101, 102, 103, 104))
    assert abs(mean - target) <= 0.05 * target
    deg = np.bincount(draw(cfg, 105).reshape(-1), minlength=cfg["n"])
    assert deg.argmax() < cfg["n"] // 100


def test_fit_offset_is_monotone_and_reproducible():
    lo = graphgen.fit_offset(400, 2000, 0.8, 150, seeds=(0, 1), iters=16)
    hi = graphgen.fit_offset(400, 2000, 0.8, 60, seeds=(0, 1), iters=16)
    assert lo < hi
    assert lo == graphgen.fit_offset(400, 2000, 0.8, 150, seeds=(0, 1),
                                     iters=16)


@pytest.mark.parametrize("seed", [0, 5, 2 ** 40])
def test_insert_stream_fresh_non_edges(seed):
    e = graphgen.chung_lu_edges(50, 300, 0.8, 2.0, seed)
    ins = graphgen.insert_stream(e, 50, 200, seed)
    keys = ins[:, 0] * 50 + ins[:, 1]
    assert ins.shape == (200, 2)
    assert (ins[:, 0] < ins[:, 1]).all()
    assert np.unique(keys).size == 200
    assert not np.isin(keys, e[:, 0] * 50 + e[:, 1]).any()
    assert np.array_equal(ins, graphgen.insert_stream(e, 50, 200, seed))


@pytest.mark.parametrize("name", CONFIGS)
def test_largest_component_matches_the_dataset(name):
    """The configuration's graph holds the dataset's largest component
    to within 1%."""
    cfg = config(name)
    got = graphgen.largest_component(cfg["n"], draw(cfg, cfg["graph_seed"]))
    want = cfg["assumed"]["largest_wcc"]
    assert abs(got - want) <= 0.01 * want


@pytest.mark.parametrize("name", CONFIGS)
def test_effective_diameter_as_assumed(name):
    """The stand-in's effective diameter is the one ``assumed`` states,
    within 1.5 of the dataset page's and below it (no clustering)."""
    cfg = config(name)
    got = graphgen.effective_diameter(cfg["n"], draw(cfg, cfg["graph_seed"]))
    page = cfg["assumed"]["effective_diameter_page"]
    assert abs(got - cfg["assumed"]["effective_diameter_stand_in"]) < 0.01
    assert 0 < page - got < 1.5


def test_largest_component_and_diameter_hand_counted():
    # a path 0-1-2-3 and an edge 4-5; vertex 6 alone
    e = np.array([[0, 1], [1, 2], [2, 3], [4, 5]])
    assert graphgen.largest_component(7, e) == 4
    # from every vertex of the path: distances 0,1,1,2,2,3,0,1,1,2,2,3 ...
    path = np.array([[0, 1], [1, 2], [2, 3]])
    # 16 (source, vertex) pairs: 4 at 0, 6 at 1, 4 at 2, 2 at 3; 90% of 16
    # is 14.4, passed at distance 2 (14 of 16 by 2: interpolated)
    assert graphgen.effective_diameter(4, path, sources=4) == pytest.approx(
        2 + (14.4 - 14) / 2)


def test_fit_exponent_reaches_the_component():
    alpha, i0 = graphgen.fit_exponent(400, 1200, 60, 360, seeds=(0, 1),
                                      iters=8)
    got = graphgen.mean_largest_component(400, 1200, alpha, i0, seeds=(0, 1))
    assert abs(got - 360) <= 8
    assert graphgen.mean_top_degree(400, 1200, alpha, i0,
                                    seeds=(0, 1)) == pytest.approx(60, rel=0.1)


@pytest.mark.parametrize("seed", [0, 7, 2 ** 40])
def test_insert_stream_strata(seed):
    """Every 16 endpoints hold one from each block of the degree order,
    in the same order for every seed."""
    n = 1600
    e = graphgen.chung_lu_edges(n, 6000, 0.8, 5.0, 1)
    ins = graphgen.insert_stream(e, n, 400, seed, strata=16)
    blocks = (ins_flat := ins.reshape(-1)) * 16 // n
    ref = graphgen.insert_stream(e, n, 400, seed + 1, strata=16)
    keys = ins[:, 0] * n + ins[:, 1]
    assert np.unique(keys).size == 400
    assert not np.isin(keys, e[:, 0] * n + e[:, 1]).any()
    assert not np.array_equal(ins, ref)
    # endpoints are stored (lo, hi): compare each event's pair of blocks
    pairs = np.sort(blocks.reshape(-1, 2), axis=1)
    ref_pairs = np.sort((ref.reshape(-1) * 16 // n).reshape(-1, 2), axis=1)
    assert np.array_equal(pairs, ref_pairs)
    for k in range(0, ins_flat.size, 16):
        assert np.array_equal(np.sort(blocks[k:k + 16]), np.arange(16))


def test_insert_stream_too_many_for_its_blocks():
    e = graphgen.chung_lu_edges(50, 300, 0.8, 2.0, 3)
    with pytest.raises(ValueError):
        graphgen.insert_stream(e, 50, 200, 3, strata=8)
