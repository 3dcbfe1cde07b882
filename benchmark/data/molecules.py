"""Mutagenicity-shaped molecules, drawn from a seed with NumPy.

Mutagenicity (the TU dataset of GNNkeras' ``examples/starter.py``) holds
4,337 molecules: 131,488 atoms over 14 atom types and 133,447 bonds over 3
bond types, stored as arcs in both directions, with no parallel arcs and no
self loops.  The dataset itself is not shipped, so this generator draws
molecules with those totals.  The atom counts are the dataset's, the same
for every seed: one draw from a gamma law of mean 30.3 (at least 4 atoms),
summed exactly to the total, from a key of the totals themselves.  The
seed draws the rest: a bond skeleton that joins
each atom to one of the four before it (a tree: chains with short branches)
plus ring bonds that close a ring of 3 to 6 atoms, drawn until they make
up the bond total (one that repeats a bond is drawn again); atom types,
bond types and a 2-class target uniform.

``molecules(seed)`` returns flat arrays, the graphs one after another:
``nodes`` (N, 14) one-hot f32, ``node_start`` (G + 1,) the first atom of
each molecule, ``src`` / ``dst`` (A,) int64 global atom indices of every
arc, sorted by (src, dst) and grouped by molecule, ``arc_start`` (G + 1,),
``arc_label`` (A, 3) one-hot f32 and ``targets`` (G, 2) one-hot f32.
"""

from __future__ import annotations

import numpy as np

GRAPHS, ATOMS, BONDS = 4_337, 131_488, 133_447
ATOM_TYPES, BOND_TYPES, CLASSES = 14, 3, 2
MIN_ATOMS = 4
SIZE_SHAPE = 2.5  # gamma shape of the atom count above MIN_ATOMS


def atom_counts(rng: np.random.Generator, graphs: int, atoms: int) -> np.ndarray:
    """``graphs`` atom counts of at least ``MIN_ATOMS`` that sum to ``atoms``."""
    mean_extra = atoms / graphs - MIN_ATOMS
    sizes = MIN_ATOMS + np.floor(rng.gamma(SIZE_SHAPE, mean_extra / SIZE_SHAPE, graphs)).astype(np.int64)
    diff = atoms - int(sizes.sum())
    while diff:
        if diff > 0:
            np.add.at(sizes, rng.integers(0, graphs, diff), 1)
        else:
            big = np.flatnonzero(sizes > MIN_ATOMS)
            take = rng.choice(big, min(-diff, len(big)), replace=False)
            sizes[take] -= 1
        diff = atoms - int(sizes.sum())
    return sizes


def molecules(seed: int, graphs: int = GRAPHS, atoms: int = ATOMS, bonds: int = BONDS) -> dict:
    sizes = atom_counts(np.random.default_rng([graphs, atoms, bonds]), graphs, atoms)
    rng = np.random.default_rng(seed)
    node_start = np.concatenate([[0], np.cumsum(sizes)])
    graph_of = np.repeat(np.arange(graphs), sizes)
    local = np.arange(atoms) - node_start[graph_of]

    # skeleton: atom i (local index > 0) bonds to one of the (up to) four before it
    child = np.flatnonzero(local > 0)
    back = 1 + np.floor(rng.random(len(child)) * np.minimum(local[child], 4)).astype(np.int64)
    u, v = child - back, child

    # ring closures, spread over the molecules in proportion to their size,
    # drawn again for the ones that repeated a bond until the total is met
    key = u * atoms + v
    for _ in range(8):
        missing = bonds - len(key)
        if missing <= 0:
            break
        ring_graph = rng.choice(graphs, missing, p=sizes / atoms)
        span = np.minimum(rng.integers(2, 6, missing), sizes[ring_graph] - 1)  # a ring of span + 1 atoms
        first = np.floor(rng.random(missing) * (sizes[ring_graph] - span)).astype(np.int64)
        ru = node_start[ring_graph] + first
        ok = span >= 2
        key = np.unique(np.concatenate([key, (ru * atoms + ru + span)[ok]]))
    u, v = key // atoms, key % atoms
    bond_type = rng.integers(0, BOND_TYPES, len(u))
    src = np.concatenate([u, v])
    dst = np.concatenate([v, u])
    types = np.concatenate([bond_type, bond_type])
    order = np.lexsort((dst, src))
    src, dst, types = src[order], dst[order], types[order]
    arc_start = np.searchsorted(src, node_start)

    eye = lambda n, idx: np.eye(n, dtype=np.float32)[idx]
    return {
        "nodes": eye(ATOM_TYPES, rng.integers(0, ATOM_TYPES, atoms)),
        "node_start": node_start,
        "src": src,
        "dst": dst,
        "arc_start": arc_start,
        "arc_label": eye(BOND_TYPES, types),
        "targets": eye(CLASSES, rng.integers(0, CLASSES, graphs)),
    }


def split(seed: int, graphs: int, test: int = 750, validation: int = 750):
    """The starter's split: the first ``test`` molecules, the next
    ``validation`` ones and the rest for training, each part in an order
    drawn from the seed, so that every seed trains on the same sizes.
    Returns (train, test, validation) index arrays."""
    rng = np.random.default_rng([seed, 7])
    part = lambda lo, hi: lo + rng.permutation(hi - lo)
    return part(test + validation, graphs), part(0, test), part(test, test + validation)


def subset(mols: dict, index) -> dict:
    """The molecules ``index`` (in that order) as flat arrays of their own."""
    index = np.asarray(index)
    ns, as_ = mols["node_start"], mols["arc_start"]
    n_sizes = ns[index + 1] - ns[index]
    a_sizes = as_[index + 1] - as_[index]
    node_rows = np.concatenate([np.arange(ns[i], ns[i + 1]) for i in index])
    arc_rows = np.concatenate([np.arange(as_[i], as_[i + 1]) for i in index])
    new_start = np.concatenate([[0], np.cumsum(n_sizes)])
    shift = np.repeat(new_start[:-1] - ns[index], a_sizes)
    return {
        "nodes": mols["nodes"][node_rows],
        "node_start": new_start,
        "src": mols["src"][arc_rows] + shift,
        "dst": mols["dst"][arc_rows] + shift,
        "arc_start": np.concatenate([[0], np.cumsum(a_sizes)]),
        "arc_label": mols["arc_label"][arc_rows],
        "targets": mols["targets"][index],
    }
