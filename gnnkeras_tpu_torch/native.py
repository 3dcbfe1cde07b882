"""NumPy host kernels of the batch and operator builders.

Copies of the NumPy paths of ``gnnkeras_tpu.native`` (``agg_label_sums``,
``agg_component_sums``, ``scatter_add_3d``, ``unique_i64``,
``factor_mask_scale``).  The JAX
package's C++ tier is pinned bit-identical to these paths, so host-built
arrays of the two packages compare equal bit for bit.
"""

from __future__ import annotations

import numpy as np


def agg_label_sums(src, dst, w, arc_label, nodes, n_rows):
    """(agg_arc, agg_node) f64 accumulations of the batch-constant neighbour
    sums: ``Σ_{e→d} w_e·arc_label_e`` and ``Σ_{e→d} w_e·nodes[src_e]``."""
    da, dn = arc_label.shape[1], nodes.shape[1]
    w64 = np.asarray(w).astype(np.float64)[:, None]
    acc_arc = np.zeros((n_rows, da), np.float64)
    np.add.at(acc_arc, dst, arc_label.astype(np.float64) * w64)
    acc_node = np.zeros((n_rows, dn), np.float64)
    np.add.at(acc_node, dst, nodes[src].astype(np.float64) * w64)
    return acc_arc, acc_node


def agg_component_sums(src, dst, w, nodes, type_mask, dims, n_rows):
    """(n_rows, Σdims) f64: the per-type neighbour-label sums of a composite
    batch, concatenated, ``Σ_{e→d, type t of src_e} w_e·nodes[src_e, :d_t]``
    for each type t.  ``type_mask`` (N, T) bool gives the source nodes'
    types; a node of several types contributes under each of them (the
    multi-hot case)."""
    dims = np.asarray(dims, np.int64)
    offsets = np.concatenate([[0], np.cumsum(dims)[:-1]]).astype(np.int64)
    acc = np.zeros((n_rows, int(dims.sum())), np.float64)
    w64 = np.asarray(w).astype(np.float64)
    for t, (d_t, off) in enumerate(zip(dims, offsets)):
        gate = type_mask[src, t].astype(np.float64)
        part = np.zeros((n_rows, int(d_t)), np.float64)
        np.add.at(part, dst, nodes[src, : int(d_t)].astype(np.float64) * (w64 * gate)[:, None])
        acc[:, off : off + int(d_t)] = part
    return acc


def scatter_add_3d(out, i0, i1, i2, w):
    """``np.add.at(out, (i0, i1, i2), w)``: f32 cells, each update rounded
    once from the f64 sum."""
    np.add.at(out, (i0, i1, i2), w)
    return out


def unique_i64(keys: np.ndarray, return_inverse: bool = False):
    return np.unique(np.asarray(keys), return_inverse=return_inverse)


def factor_mask_scale(arr: np.ndarray):
    """Factor ``arr == mask * scale[:, None, :]`` with a 0/1 mask: every
    column's nonzeros must share one value.  Returns (mask int8, scale f32)
    or None when the weights do not factor."""
    mask = arr != 0
    first = np.argmax(mask, axis=1)  # first nonzero row per (tile, col)
    t_idx = np.arange(arr.shape[0])[:, None]
    c_idx = np.arange(arr.shape[2])[None, :]
    scale = arr[t_idx, first, c_idx] * mask.any(axis=1)
    if not np.array_equal(arr, mask * scale[:, None, :]):
        return None
    return mask.astype(np.int8), scale.astype(np.float32)
