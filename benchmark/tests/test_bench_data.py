"""The frozen generators: sizes from a seed, no parallel arcs, both
directions per bond, arcs per node at the bands the cells use."""

import numpy as np
import pytest

from benchmark.data.banded import banded_graph
from benchmark.data.molecules import ATOMS, BONDS, GRAPHS, molecules, split, subset

SEED = 2**31 + 12345


@pytest.fixture(scope="module")
def mols():
    return molecules(SEED)


def test_molecules_have_mutagenicitys_totals(mols):
    assert len(mols["node_start"]) - 1 == GRAPHS == 4337
    assert mols["nodes"].shape == (ATOMS, 14) and ATOMS == 131_488
    assert len(mols["src"]) == 2 * BONDS
    assert np.all(mols["nodes"].sum(1) == 1) and np.all(mols["arc_label"].sum(1) == 1)
    assert mols["targets"].shape == (GRAPHS, 2)
    assert np.all(np.diff(mols["node_start"]) >= 4)


def test_molecules_have_no_parallel_arcs_or_loops_and_both_directions(mols):
    src, dst = mols["src"], mols["dst"]
    key = src * ATOMS + dst
    assert len(np.unique(key)) == len(key)
    assert np.all(src != dst)
    assert np.array_equal(np.sort(key), np.sort(dst * ATOMS + src))
    graph_of = np.searchsorted(mols["node_start"], np.arange(ATOMS), side="right") - 1
    assert np.array_equal(graph_of[src], graph_of[dst])
    ns, as_ = mols["node_start"], mols["arc_start"]
    assert np.all(src[as_[1:-1]] >= ns[1:-1])


def test_molecules_are_the_seeds(mols):
    again = molecules(SEED)
    for key in mols:
        assert np.array_equal(mols[key], again[key])
    other = molecules(SEED + 1)
    assert not np.array_equal(other["src"], mols["src"])
    # every seed trains on the dataset's sizes, in its own order
    assert np.array_equal(other["node_start"], mols["node_start"])
    sizes = np.diff(mols["node_start"])
    parts = zip(split(SEED, GRAPHS), split(SEED + 1, GRAPHS))
    for a, b in parts:
        assert not np.array_equal(a, b) and np.array_equal(np.sort(sizes[a]), np.sort(sizes[b]))


def test_split_and_subset(mols):
    train, test, val = split(SEED, GRAPHS)
    assert (len(train), len(test), len(val)) == (2837, 750, 750)
    assert len(np.unique(np.concatenate([train, test, val]))) == GRAPHS
    part = subset(mols, train[:5])
    sizes = np.diff(mols["node_start"])[train[:5]]
    assert part["nodes"].shape[0] == sizes.sum()
    assert part["src"].min() >= 0 and part["src"].max() < sizes.sum()
    first = train[0]
    lo, hi = mols["arc_start"][first], mols["arc_start"][first + 1]
    assert np.array_equal(part["src"][: hi - lo], mols["src"][lo:hi] - mols["node_start"][first])


@pytest.mark.parametrize("band, per_node", [(64, 129 * (1 - (128 / 129) ** 8)), (384, 769 * (1 - (768 / 769) ** 8))])
def test_banded_arcs_per_node(band, per_node):
    n = 50_000
    g = banded_graph(SEED, n, band)
    assert abs(len(g["src"]) / n - per_node) < 0.01
    key = g["src"] * n + g["dst"]
    assert np.all(np.diff(key) > 0)  # unique and sorted
    offset = (g["dst"] - g["src"] + n) % n
    assert np.all((offset <= band) | (offset >= n - band))
    assert g["nodes"].shape == (n, 8) and g["arc_label"].shape == (len(key), 2) and g["targets"].shape == (n, 2)
    assert np.array_equal(banded_graph(SEED, n, band)["dst"], g["dst"])
