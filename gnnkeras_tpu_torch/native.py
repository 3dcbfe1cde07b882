"""The native host tier: C++ kernels of the batch and operator builders and
of the TU parser (``csrc/host_ops.cpp``), bound with ctypes, each beside
its NumPy path (the plain version).

The library is compiled with the system ``g++`` at first use into
``gnnkeras_tpu_torch/_build/`` under a name that hashes the source and the
flags, through a temporary file and an atomic rename, so processes that
build at once (test workers, ranks) never load a half-written library.
Importing this module builds nothing.  The flags are ISO ``-std=c++17``
without ``-ffast-math``: the compiler contracts no multiply-add, which the
bit-identity with the NumPy paths rests on.

Every function is bit-identical to its NumPy path, which runs when the
library is unavailable (no ``g++``, a failed build), when the input is
ineligible (the conditions each docstring names), inside ``numpy_path()``,
or when ``GNNKERAS_TPU_TORCH_NO_NATIVE`` is set.  ``available()`` says
whether the library is loaded; ``build_error()`` says why it is not.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Optional

import numpy as np

_PKG = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_PKG, "csrc", "host_ops.cpp")
BUILD_DIR = os.path.join(_PKG, "_build")
GXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17")
NO_NATIVE_ENV = "GNNKERAS_TPU_TORCH_NO_NATIVE"

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False
_error: Optional[str] = None
_disabled = 0

_i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
_i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
_f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
_f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
_i8p = np.ctypeslib.ndpointer(np.int8, flags="C_CONTIGUOUS")
_I64 = ctypes.c_int64

_SIGNATURES = {
    "agg_label_sums": (None, [_i32p, _i32p, _f32p, _I64, _f32p, _I64, _f32p, _I64, _f64p, _f64p]),
    "agg_component_sums": (None, [_i32p, _i32p, _f32p, _I64, _f32p, _I64, _i32p, _i64p, _i64p, _I64, _f64p]),
    "factor_mask_scale": (ctypes.c_int32, [_f64p, _I64, _I64, _I64, _i8p, _f32p]),
    "factor_mask_scale_f32": (ctypes.c_int32, [_f32p, _I64, _I64, _I64, _i8p, _f32p]),
    "unique_i64": (_I64, [_i64p, _I64, _i64p]),
    "unique_i64_inverse": (_I64, [_i64p, _I64, _i64p, _i64p]),
    "scatter_add_f32_idx3": (None, [_i64p, _i64p, _i64p, _f64p, _I64, _I64, _I64, _I64, _f32p]),
    "canonical_arcs_f64": (_I64, [_f64p, _I64, _I64, _f64p]),
    "canonical_arcs_f32": (_I64, [_f32p, _I64, _I64, _f32p]),
    "parse_ints": (_I64, [ctypes.c_char_p, _i64p, _I64]),
}


def library_path() -> str:
    """The library's path, named by the hash of the source and the flags."""
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_DIR, f"libhost_ops-{h.hexdigest()[:16]}.so")


def _build() -> str:
    """Compile the library unless it exists; returns its path, raises with
    the compiler's output on failure."""
    path = library_path()
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.tmp{os.getpid()}.{threading.get_ident()}"
    try:
        res = subprocess.run(["g++", *GXX_FLAGS, SOURCE, "-o", tmp], capture_output=True, text=True, timeout=300)
        if res.returncode != 0:
            raise RuntimeError(f"g++ failed ({res.returncode}):\n{res.stdout}{res.stderr}")
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return path


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried, _error
    if _disabled:
        return None
    if _lib is not None or _tried:
        return _lib
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if os.environ.get(NO_NATIVE_ENV):
            _error = f"{NO_NATIVE_ENV} is set"
            return None
        try:
            lib = ctypes.CDLL(_build())
        except (OSError, RuntimeError, subprocess.SubprocessError) as exc:
            _error = f"{type(exc).__name__}: {exc}"
            return None
        for name, (restype, argtypes) in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.restype, fn.argtypes = restype, argtypes
        _lib = lib
        return _lib


def available() -> bool:
    """Whether the C++ library is built and loaded (builds it on first call)."""
    return _load() is not None


def build_error() -> Optional[str]:
    """Why the library is not loaded, or None."""
    _load()
    return _error


@contextlib.contextmanager
def numpy_path():
    """Run every function of this module on its NumPy path inside the block
    (process-wide, threads included), whatever ``available()`` says."""
    global _disabled
    with _lock:
        _disabled += 1
    try:
        yield
    finally:
        with _lock:
            _disabled -= 1


def _all_f32(*arrays) -> bool:
    return all(np.asarray(x).dtype == np.float32 for x in arrays)


def agg_label_sums(src, dst, w, arc_label, nodes, n_rows):
    """(agg_arc, agg_node) f64 accumulations of the batch-constant neighbour
    sums: ``Σ_{e→d} w_e·arc_label_e`` and ``Σ_{e→d} w_e·nodes[src_e]``.
    The library takes f32 inputs only (f64 inputs would change the sums if
    cast): others take the NumPy path."""
    lib = _load()
    da, dn = arc_label.shape[1], nodes.shape[1]
    if lib is None or not _all_f32(w, arc_label, nodes):
        w64 = np.asarray(w).astype(np.float64)[:, None]
        acc_arc = np.zeros((n_rows, da), np.float64)
        np.add.at(acc_arc, dst, arc_label.astype(np.float64) * w64)
        acc_node = np.zeros((n_rows, dn), np.float64)
        np.add.at(acc_node, dst, nodes[src].astype(np.float64) * w64)
        return acc_arc, acc_node
    acc_arc = np.zeros((n_rows, da), np.float64)
    acc_node = np.zeros((n_rows, dn), np.float64)
    lib.agg_label_sums(np.ascontiguousarray(src, np.int32), np.ascontiguousarray(dst, np.int32),
                       np.ascontiguousarray(w, np.float32), len(src), np.ascontiguousarray(arc_label, np.float32),
                       da, np.ascontiguousarray(nodes, np.float32), dn, acc_arc, acc_node)
    return acc_arc, acc_node


def agg_component_sums(src, dst, w, nodes, type_mask, dims, n_rows):
    """(n_rows, Σdims) f64: the per-type neighbour-label sums of a composite
    batch, concatenated, ``Σ_{e→d, type t of src_e} w_e·nodes[src_e, :d_t]``
    for each type t.  ``type_mask`` (N, T) bool gives the source nodes'
    types; a node of several types contributes under each of them (the
    multi-hot case, NumPy path only).  The library takes one-hot masks and
    f32 inputs; with non-finite labels the NumPy path's 0·NaN spreads NaN
    into every type's columns where the library taints only its own type's,
    equal on finite inputs."""
    dims = np.asarray(dims, np.int64)
    offsets = np.concatenate([[0], np.cumsum(dims)[:-1]]).astype(np.int64)
    lib = _load()
    one_hot = not np.any(np.count_nonzero(type_mask, axis=1) > 1)
    if lib is None or not one_hot or not _all_f32(w, nodes):
        acc = np.zeros((n_rows, int(dims.sum())), np.float64)
        w64 = np.asarray(w).astype(np.float64)
        for t, (d_t, off) in enumerate(zip(dims, offsets)):
            gate = type_mask[src, t].astype(np.float64)
            part = np.zeros((n_rows, int(d_t)), np.float64)
            np.add.at(part, dst, nodes[src, : int(d_t)].astype(np.float64) * (w64 * gate)[:, None])
            acc[:, off : off + int(d_t)] = part
        return acc
    type_of = np.where(type_mask.any(axis=1), np.argmax(type_mask, axis=1), -1).astype(np.int32)
    acc = np.zeros((n_rows, int(dims.sum())), np.float64)
    lib.agg_component_sums(np.ascontiguousarray(src, np.int32), np.ascontiguousarray(dst, np.int32),
                           np.ascontiguousarray(w, np.float32), len(src), np.ascontiguousarray(nodes, np.float32),
                           nodes.shape[1], np.ascontiguousarray(type_of), dims, np.ascontiguousarray(offsets),
                           len(dims), acc)
    return acc


def scatter_add_3d(out, i0, i1, i2, w):
    """``np.add.at(out, (i0, i1, i2), w)``: f32 cells, each update rounded
    once from the f64 sum (NumPy's mixed-dtype loop, which the library
    repeats).  The library takes a C-contiguous f32 ``out`` and 1-D index
    and value arrays of one length; anything else (broadcasting) takes the
    NumPy path.  Indices wrap and raise as NumPy's do."""
    lib = _load()
    if lib is None or out.dtype != np.float32 or not out.flags.c_contiguous:
        np.add.at(out, (i0, i1, i2), w)
        return out
    d0, d1, d2 = out.shape
    i0, i1, i2 = (np.asarray(i, np.int64) for i in (i0, i1, i2))
    w = np.asarray(w)
    if not (i0.ndim == i1.ndim == i2.ndim == w.ndim == 1 and i0.size == i1.size == i2.size == w.size):
        np.add.at(out, (i0, i1, i2), w)
        return out
    # the raw write must never see an index NumPy would refuse
    for i, d in ((i0, d0), (i1, d1), (i2, d2)):
        if i.size and (int(i.min()) < -d or int(i.max()) >= d):
            np.add.at(out, (i0, i1, i2), w)  # raises NumPy's IndexError
            raise AssertionError("np.add.at accepted an index the wrapper refused")
    w64 = np.ascontiguousarray(w, np.float64)
    lib.scatter_add_f32_idx3(np.ascontiguousarray(i0), np.ascontiguousarray(i1), np.ascontiguousarray(i2), w64,
                             len(w64), d0, d1, d2, out.reshape(-1))
    return out


def unique_i64(keys: np.ndarray, return_inverse: bool = False):
    """``np.unique`` of a key array (optionally ``return_inverse``); the
    library takes 1-D int64 keys."""
    a = np.asarray(keys)
    lib = _load()
    if lib is None or a.dtype != np.int64 or a.ndim != 1:
        return np.unique(a, return_inverse=return_inverse)
    a = np.ascontiguousarray(a)
    out = np.empty_like(a)
    if return_inverse:
        inv = np.empty(a.shape[0], np.int64)
        m = int(lib.unique_i64_inverse(a, a.shape[0], out, inv))
        return out[:m], inv
    return out[: int(lib.unique_i64(a, a.shape[0], out))]


def canonical_arcs(arcs: np.ndarray) -> np.ndarray:
    """``np.unique(arcs, axis=0)``: the sorted unique rows of an arc matrix
    (the ``GraphObject`` constructor's canonicalisation).  The library takes
    f32 / f64 matrices of at least two columns whose endpoints are integers
    in [0, 2^32) and that hold no NaN and no -0.0 (where ``np.unique``'s
    kept row depends on its sort); others take the NumPy path."""
    a = np.asarray(arcs)
    lib = _load()
    if lib is not None and a.ndim == 2 and a.shape[1] >= 2 and a.dtype in (np.float32, np.float64):
        a = np.ascontiguousarray(a)
        out = np.empty_like(a)
        fn = lib.canonical_arcs_f64 if a.dtype == np.float64 else lib.canonical_arcs_f32
        m = int(fn(a, a.shape[0], a.shape[1], out))
        if m >= 0:
            return out[:m]
    return np.unique(a, axis=0)


def factor_mask_scale(arr: np.ndarray):
    """Factor ``arr == mask * scale[:, None, :]`` with a 0/1 mask: every
    column's nonzeros must share one value.  Returns (mask int8, scale f32)
    or None when the weights do not factor (or hold a NaN).  The library
    takes f32 / f64 arrays."""
    lib = _load()
    if lib is not None and arr.dtype in (np.float32, np.float64):
        a = np.ascontiguousarray(arr)
        B, R, C = a.shape
        mask = np.empty((B, R, C), np.int8)
        scale = np.empty((B, C), np.float32)
        fn = lib.factor_mask_scale if a.dtype == np.float64 else lib.factor_mask_scale_f32
        if not fn(a, B, R, C, mask, scale):
            return None
        return mask, scale
    mask = arr != 0
    first = np.argmax(mask, axis=1)  # first nonzero row per (tile, col)
    t_idx = np.arange(arr.shape[0])[:, None]
    c_idx = np.arange(arr.shape[2])[None, :]
    scale = arr[t_idx, first, c_idx] * mask.any(axis=1)
    if not np.array_equal(arr, mask * scale[:, None, :]):
        return None
    return mask.astype(np.int8), scale.astype(np.float32)


def load_ints(path: str, columns: int = 1) -> np.ndarray:
    """The integers of a TU-format text file (whitespace- or comma-separated)
    as an int64 vector, or (rows, ``columns``) when ``columns`` > 1: one
    pass of the library over the file, else ``np.loadtxt``.  Raises
    ``FileNotFoundError`` for a missing file and ``ValueError`` for a
    malformed one on both paths."""
    lib = _load()
    if lib is None:
        return np.loadtxt(path, dtype=np.int64, delimiter="," if columns > 1 else None,
                          ndmin=2 if columns > 1 else 1)
    try:
        size = os.stat(path).st_size
    except OSError:
        raise FileNotFoundError(path) from None
    # an integer token takes at least 2 bytes with its separator
    out = np.empty(size // 2 + 2, np.int64)
    got = int(lib.parse_ints(os.fsencode(path), out, len(out)))
    if got < 0:
        raise ValueError(f"malformed integer file: {path} (code {got})")
    flat = out[:got].copy()
    return flat.reshape(-1, columns) if columns > 1 else flat
