"""The port's TU-format loaders and splits (``gnnkeras_tpu_torch.data.mutag``)
against the JAX package's, on TU dumps the tests write (nothing is
downloaded; ``MUTAG_raw`` itself is not needed).

Both packages parse the same text into the same graphs, array for array
(exact: the same integers through the same NumPy steps), and their
splits, seeded, give the same graphs in the same roles.
"""

import numpy as np
import pytest

import gnnkeras_tpu.data.mutag as jmutag
import gnnkeras_tpu_torch.data.mutag as tmutag


def _write_mutagenicity(p, seed=7, n_graphs=12):
    """A Mutagenicity-format dump: intra-graph edges over 1-based node ids,
    a few cross-graph rows (dropped by both loaders), labels of 5 atom and
    3 bond types, 2 classes."""
    rng = np.random.default_rng(seed)
    sizes = rng.integers(2, 9, size=n_graphs)
    bounds = np.concatenate([[0], np.cumsum(sizes)])
    edges = []
    for k in range(len(sizes)):
        lo, hi = bounds[k] + 1, bounds[k + 1]
        for _ in range(int(sizes[k]) * 2):
            s, d = rng.integers(lo, hi + 1, size=2)
            if s != d:
                edges.append((s, d))
    for k in range(3):
        edges.append((int(bounds[k]) + 1, int(bounds[k + 1]) + 1))
    edges = np.unique(np.array(edges), axis=0)
    rng.shuffle(edges)
    p.mkdir()
    np.savetxt(p / "Mutagenicity_edges.txt", edges, fmt="%d", delimiter=", ")
    np.savetxt(p / "Mutagenicity_edge_labels.txt", rng.integers(0, 3, size=len(edges)), fmt="%d")
    np.savetxt(p / "Mutagenicity_node_labels.txt", rng.integers(0, 5, size=int(bounds[-1])), fmt="%d")
    np.savetxt(p / "Mutagenicity_graph_indicator.txt", np.repeat(np.arange(1, n_graphs + 1), sizes), fmt="%d")
    np.savetxt(p / "Mutagenicity_graph_labels.txt", rng.integers(0, 2, size=n_graphs), fmt="%d")


def _assert_same_graphs(tg, jg):
    assert len(tg) == len(jg)
    for t, j in zip(tg, jg):
        assert type(t).__name__ == type(j).__name__
        for name in ("nodes", "arcs", "targets", "set_mask", "output_mask", "graph_of_node", "nodegraph_weight",
                     "arcnode_weight"):
            got, want = getattr(t, name), getattr(j, name)
            assert got.dtype == want.dtype, name
            np.testing.assert_array_equal(got, want, err_msg=name)
        if hasattr(j, "type_mask"):
            np.testing.assert_array_equal(t.type_mask, j.type_mask)
            np.testing.assert_array_equal(t.DIM_NODE_LABEL, j.DIM_NODE_LABEL)


@pytest.mark.parametrize("composite", [False, True])
def test_load_mutag_matches_jax(tmp_path, composite):
    _write_mutagenicity(tmp_path / "TU")
    tg = tmutag.load_mutag(str(tmp_path / "TU"), composite=composite)
    jg = jmutag.load_mutag(str(tmp_path / "TU"), composite=composite)
    assert len(tg) == 12 and tg[0].nodes.shape[1] == 5 and tg[0].DIM_ARC_LABEL == 3
    _assert_same_graphs(tg, jg)


def test_generic_tu_dumps_match_jax(tmp_path):
    """No edge labels, a signed graph-label alphabet, node attributes
    alone and after the label one-hot, and a one-edge edge file."""
    p = tmp_path / "Toy"
    p.mkdir()
    np.savetxt(p / "Toy_edges.txt", np.array([[1, 2], [2, 1], [3, 4], [4, 3]]), fmt="%d", delimiter=", ")
    np.savetxt(p / "Toy_graph_indicator.txt", np.array([1, 1, 2, 2]), fmt="%d")
    np.savetxt(p / "Toy_graph_labels.txt", np.array([-1, 1]), fmt="%d")
    attrs = np.array([[0.5, -1.0], [1.5, 2.0], [0.0, 3.25], [4.0, -0.5]])
    np.savetxt(p / "Toy_node_attributes.txt", attrs, fmt="%.6g", delimiter=", ")
    for _ in ("attributes", "labels and attributes"):
        tg, jg = tmutag.load_tu_dataset(str(p), "Toy"), jmutag.load_tu_dataset(str(p), "Toy")
        _assert_same_graphs(tg, jg)
        np.testing.assert_array_equal(tg[1].targets, [[0, 1]])
        assert tg[0].DIM_ARC_LABEL == 1  # the constant edge feature
        np.savetxt(p / "Toy_node_labels.txt", np.array([1, 2, 1, 3]), fmt="%d")
    assert tg[0].nodes.shape == (2, 5)
    np.savetxt(p / "Toy_edges.txt", np.array([[1, 2]]), fmt="%d", delimiter=", ")
    tg, jg = tmutag.load_tu_dataset(str(p), "Toy"), jmutag.load_tu_dataset(str(p), "Toy")
    _assert_same_graphs(tg, jg)


def test_splits_match_jax(tmp_path):
    _write_mutagenicity(tmp_path / "TU", seed=3, n_graphs=40)
    tg = tmutag.load_mutag(str(tmp_path / "TU"))
    jg = jmutag.load_mutag(str(tmp_path / "TU"))
    for t_part, j_part in zip(tmutag.dataset_splits(tg, seed=0), jmutag.dataset_splits(jg, seed=0)):
        assert len(t_part) == len(j_part) > 0
        _assert_same_graphs(t_part, j_part)
    assert [len(s) for s in tmutag.dataset_splits(tg, seed=0)] == [26, 7, 7]
    with pytest.raises(ValueError, match="no training graphs"):
        tmutag.dataset_splits(tg[:2], seed=0, test_frac=0.5, val_frac=0.5)
    # the reference's fixed tails need ≥ 1,500 graphs: at 4,337 graphs
    # dataset_splits gives the same 2,837 / 750 / 750 sizes
    big = list(range(4337))
    sizes = [len(s) for s in tmutag.mutag_splits(big, seed=42)]
    assert sizes == [len(s) for s in jmutag.mutag_splits(big, seed=42)] == [2837, 750, 750]
    assert [len(s) for s in tmutag.dataset_splits(big, seed=0)] == sizes
    for t_part, j_part in zip(tmutag.mutag_splits(big, seed=42), jmutag.mutag_splits(big, seed=42)):
        assert t_part == j_part


def test_load_mutag_without_the_dump_raises(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    with pytest.raises(FileNotFoundError, match="MUTAG_raw"):
        tmutag.load_mutag()
