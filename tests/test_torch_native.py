"""The port's native host tier (``gnnkeras_tpu_torch.native``,
``csrc/host_ops.cpp``): each of its seven functions bit for bit against its
own NumPy path and against the JAX package's ``gnnkeras_tpu.native``, on
random inputs and on the edge cases of ``tests/test_native.py`` (NaN,
-0.0, empty inputs, indices out of range, malformed TU files); the library
built race-free by several processes at once; and whole batches built
natively equal to NumPy-built ones, bit for bit.
"""

import contextlib
import dataclasses
import os
import subprocess
import sys
import warnings

import numpy as np
import pytest
import torch

import gnnkeras_tpu.native as jnative
import gnnkeras_tpu_torch.native as tnative

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

torch.set_num_threads(1)


def bits(x):
    """An array's bytes with its dtype and shape, so -0.0 and NaN payloads
    count."""
    x = np.ascontiguousarray(x)
    return x.dtype.str, x.shape, x.tobytes()


def three_ways(fn, *args, copy_first=False):
    """``fn`` of the port through the library, through its NumPy path, and
    of the JAX package: the three results."""
    def call(module, numpy_path=False):
        a = [args[0].copy(), *args[1:]] if copy_first else args
        if numpy_path:
            with tnative.numpy_path():
                return getattr(module, fn)(*a)
        return getattr(module, fn)(*a)

    return call(tnative), call(tnative, True), call(jnative)


def assert_same(results):
    first = results[0]
    for other in results[1:]:
        if isinstance(first, tuple):
            assert len(first) == len(other)
            for a, b in zip(first, other):
                assert bits(a) == bits(b)
        elif first is None:
            assert other is None
        else:
            assert bits(first) == bits(other)


@pytest.fixture(scope="module", autouse=True)
def library():
    assert tnative.available(), tnative.build_error()
    yield


def test_library_built_into_the_package_build_directory():
    path = tnative.library_path()
    assert os.path.dirname(path) == tnative.BUILD_DIR and os.path.exists(path)
    assert tnative.build_error() is None
    with tnative.numpy_path():
        assert not tnative.available()
    assert tnative.available()


def test_concurrent_builds_leave_one_library(tmp_path):
    """Three processes building into one empty directory at once: one
    library, no temporary file left, every process loads it."""
    probe = ("import sys; import gnnkeras_tpu_torch.native as n; n.BUILD_DIR = sys.argv[1]; "
             "assert n.available(), n.build_error(); print(n.library_path())")
    env = dict(os.environ, PYTHONPATH=REPO)
    procs = [subprocess.Popen([sys.executable, "-c", probe, str(tmp_path)], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for _ in range(3)]
    outs = [p.communicate(timeout=300) for p in procs]
    assert all(p.returncode == 0 for p in procs), [err for _, err in outs]
    assert len({out.strip() for out, _ in outs}) == 1
    assert os.listdir(tmp_path) == [os.path.basename(outs[0][0].strip())]


def test_switch_off_variable(tmp_path):
    probe = ("import gnnkeras_tpu_torch.native as n; assert not n.available(); print(n.build_error())")
    env = dict(os.environ, PYTHONPATH=REPO, **{tnative.NO_NATIVE_ENV: "1"})
    res = subprocess.run([sys.executable, "-c", probe], env=env, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert tnative.NO_NATIVE_ENV in res.stdout


# -- agg_label_sums -------------------------------------------------------------------
def _arcs(seed, n=700, a=3000):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, a).astype(np.int32)
    dst = rng.integers(0, n, a).astype(np.int32)
    w = rng.random(a).astype(np.float32)
    w[::13] = 0.0  # padded-arc rows
    return rng, src, dst, w


def test_agg_label_sums():
    rng, src, dst, w = _arcs(1)
    arc_label = rng.normal(size=(len(src), 3)).astype(np.float32)
    nodes = rng.normal(size=(700, 14)).astype(np.float32)
    assert_same(three_ways("agg_label_sums", src, dst, w, arc_label, nodes, 700))


def test_agg_label_sums_nan_zero_weight_f64_and_empty():
    src, dst = np.array([0], np.int32), np.array([1], np.int32)
    nan_label = np.full((1, 1), np.nan, np.float32)
    res = three_ways("agg_label_sums", src, dst, np.zeros(1, np.float32), nan_label, np.ones((2, 1), np.float32), 2)
    assert_same(res)
    assert np.isnan(res[0][0][1, 0])  # 0·NaN is NaN, as np.add.at gives
    # f64 inputs take the NumPy path (no downcast)
    w64 = 1.0 + np.arange(4) * 1e-9
    assert_same(three_ways("agg_label_sums", np.arange(4, dtype=np.int32), np.zeros(4, np.int32), w64,
                           np.ones((4, 2)), np.ones((4, 3)), 4))
    e = np.zeros(0, np.int32)
    assert_same(three_ways("agg_label_sums", e, e, np.zeros(0, np.float32), np.zeros((0, 3), np.float32),
                           np.ones((5, 14), np.float32), 5))


# -- agg_component_sums ------------------------------------------------------------------
def test_agg_component_sums_one_hot_multi_hot_and_untyped():
    rng, src, dst, w = _arcs(2, n=500, a=2500)
    nodes = rng.normal(size=(500, 14)).astype(np.float32)
    type_mask = np.zeros((500, 3), bool)
    type_mask[np.arange(500), rng.integers(0, 3, 500)] = True
    type_mask[::29] = False  # untyped padded rows contribute nothing
    assert_same(three_ways("agg_component_sums", src, dst, w, nodes, type_mask, [14, 9, 5], 500))
    multi = type_mask.copy()
    multi[::7, 1] = True  # a node of two types adds under both (the NumPy path)
    res = three_ways("agg_component_sums", src, dst, w, nodes, multi, [14, 9, 5], 500)
    assert_same(res)
    e = np.zeros(0, np.int32)
    assert_same(three_ways("agg_component_sums", e, e, np.zeros(0, np.float32), nodes, type_mask, [14, 9, 5], 500))


# -- scatter_add_3d -------------------------------------------------------------------------
@pytest.mark.parametrize("wdtype", [np.float32, np.float64])
def test_scatter_add_3d_duplicates(wdtype):
    rng = np.random.default_rng(2)
    dims, n = (7, 32, 128), 5000
    i0, i1, i2 = (rng.integers(0, d, n) for d in dims)
    i0[::3] = i1[::3] = i2[::3] = 0  # many updates of one cell: order and rounding both count
    w = rng.normal(size=n).astype(wdtype)
    res = three_ways("scatter_add_3d", np.zeros(dims, np.float32), i0, i1, i2, w, copy_first=True)
    assert_same(res)
    want = np.zeros(dims, np.float32)
    np.add.at(want, (i0, i1, i2), w)
    assert bits(res[0]) == bits(want)


def test_scatter_add_3d_extremes_wrap_empty_and_broadcast():
    rng = np.random.default_rng(3)
    n = 4000
    i0, i1, i2 = rng.integers(0, 2, n), rng.integers(0, 8, n), rng.integers(0, 8, n)
    w = rng.normal(size=n) * 10.0 ** rng.integers(-20, 20, n)
    w[::7] = 0.0
    w[::11] = -0.0
    assert_same(three_ways("scatter_add_3d", np.zeros((2, 8, 8), np.float32), i0, i1, i2, w, copy_first=True))
    wrap = (np.array([-1, 0]), np.array([-2, 1]), np.array([-4, 3]), np.array([2.0, 3.0]))
    assert_same(three_ways("scatter_add_3d", np.zeros((2, 4, 4), np.float32), *wrap, copy_first=True))
    e = np.zeros(0, np.int64)
    assert_same(three_ways("scatter_add_3d", np.zeros((1, 4, 4), np.float32), e, e, e, np.zeros(0),
                           copy_first=True))
    # a scalar value broadcasts (the NumPy path)
    assert_same(three_ways("scatter_add_3d", np.zeros((2, 4, 4), np.float32), np.array([0, 1]), np.array([1, 1]),
                           np.array([2, 2]), np.float64(0.5), copy_first=True))


@pytest.mark.parametrize("numpy_path", [False, True])
def test_scatter_add_3d_out_of_range_raises(numpy_path):
    out = np.zeros((2, 4, 4), np.float32)
    ctx = tnative.numpy_path() if numpy_path else contextlib.nullcontext()
    with ctx:
        with pytest.raises(IndexError):
            tnative.scatter_add_3d(out, np.array([2]), np.array([0]), np.array([0]), np.array([1.0]))
        with pytest.raises(IndexError):
            tnative.scatter_add_3d(out, np.array([0]), np.array([-5]), np.array([0]), np.array([1.0]))
    assert not out.any()


# -- unique_i64 ---------------------------------------------------------------------------
@pytest.mark.parametrize("return_inverse", [False, True])
def test_unique_i64(return_inverse):
    keys = np.random.default_rng(9).integers(-1000, 1000, 40000).astype(np.int64)
    assert_same(three_ways("unique_i64", keys, return_inverse))
    assert_same(three_ways("unique_i64", np.array([], np.int64), return_inverse))
    assert_same(three_ways("unique_i64", np.array([7], np.int64), return_inverse))
    assert_same(three_ways("unique_i64", np.array([3.0, 1.0, 3.0]), return_inverse))  # not int64: NumPy


# -- canonical_arcs -------------------------------------------------------------------------
def _arc_rows(dtype, n=20000, nodes=200, seed=0):
    rng = np.random.default_rng(seed)
    labels = rng.normal(size=(n, 2)).round(1)
    labels[labels == 0] = 0.25
    arcs = np.concatenate([rng.integers(0, nodes, (n, 2)), labels], 1).astype(dtype)
    return np.concatenate([arcs, arcs[:500]])  # duplicates and parallel arcs


def _canonical(module, arcs):
    got = module.canonical_arcs(arcs)
    return np.unique(arcs, axis=0) if got is None else got  # the JAX package's None means np.unique


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_canonical_arcs(dtype):
    arcs = _arc_rows(dtype)
    want = np.unique(arcs, axis=0)
    got = tnative.canonical_arcs(arcs)
    with tnative.numpy_path():
        plain = tnative.canonical_arcs(arcs)
    for x in (got, plain, _canonical(jnative, arcs)):
        assert bits(x) == bits(want)


@pytest.mark.parametrize("bad", [
    np.array([[0.0, 1.0, np.nan], [0.0, 1.0, 2.0]]),  # NaN label
    np.array([[np.nan, 1.0, 1.0]]),  # NaN endpoint
    np.array([[-0.0, 1.0, 1.0], [0.0, 1.0, 1.0]]),  # -0.0 endpoint beside +0.0
    np.array([[0.0, 1.0, -0.0], [0.0, 1.0, 0.0]]),  # -0.0 label
    np.array([[-1.0, 1.0, 1.0]]),  # negative id
    np.array([[0.5, 1.0, 1.0]]),  # non-integral id
    np.array([[2.0 ** 33, 1.0, 1.0]]),  # id beyond 2^32
    np.array([[1, 2, 3], [1, 2, 3]], dtype=np.int64),  # not a float matrix
    np.zeros((0, 4)),  # empty
], ids=["nan_label", "nan_id", "neg_zero_id", "neg_zero_label", "negative", "fraction", "huge", "int", "empty"])
def test_canonical_arcs_ineligible_take_np_unique(bad):
    want = np.unique(bad, axis=0)
    with tnative.numpy_path():
        plain = tnative.canonical_arcs(bad)
    for x in (tnative.canonical_arcs(bad), plain, _canonical(jnative, bad)):
        assert bits(x) == bits(want)


def test_graph_constructor_canonicalises_natively():
    from gnnkeras_tpu.graph.graph import GraphObject as JGraph
    from gnnkeras_tpu_torch.graph.graph import GraphObject

    rng = np.random.default_rng(3)
    arcs = np.concatenate([rng.integers(0, 50, (200, 2)).astype(float), rng.normal(size=(200, 1))], 1)
    for a in (arcs, np.where(np.arange(200)[:, None] == 0, np.nan, arcs)):  # the second: NumPy's path
        kw = dict(nodes=rng.normal(size=(50, 3)), arcs=a.copy(), targets=rng.normal(size=(50, 2)), focus="n")
        g, j = GraphObject(**kw), JGraph(**kw)
        with tnative.numpy_path():
            plain = GraphObject(**kw)
        assert bits(g.arcs) == bits(j.arcs) == bits(plain.arcs)


# -- factor_mask_scale -----------------------------------------------------------------------
def _factorable(dtype, seed=4, B=3, R=32, C=128):
    rng = np.random.default_rng(seed)
    scale = np.where(rng.random((B, C)) < 0.8, rng.random((B, C)), 0.0)
    mask = (rng.random((B, R, C)) < 0.3) & (scale[:, None, :] != 0)
    return (mask * scale[:, None, :]).astype(dtype)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_factor_mask_scale(dtype):
    arr = _factorable(dtype)
    res = three_ways("factor_mask_scale", arr)
    assert_same(res)
    assert res[0][0].dtype == np.int8 and res[0][1].dtype == np.float32
    bad = arr.copy()
    bad[0, 0, 0], bad[0, 1, 0] = 1.25, 2.5  # two values in one column: no factor
    assert_same(three_ways("factor_mask_scale", bad))
    assert tnative.factor_mask_scale(bad) is None
    nan = arr.copy()
    nan[nan != 0] = np.nan
    lone = np.zeros((1, 4, 8), dtype)
    lone[0, 2, 3] = np.nan  # a column's only nonzero
    for x in (nan, lone, np.zeros((0, 4, 8), dtype)):
        assert_same(three_ways("factor_mask_scale", x))
    assert tnative.factor_mask_scale(nan) is None and tnative.factor_mask_scale(lone) is None


# -- load_ints ---------------------------------------------------------------------------
def test_load_ints_matches_loadtxt(tmp_path):
    p = tmp_path / "vals.txt"
    p.write_text("1, 2\n-3, 44\n+5, 600\n\n7, -8\n")
    got = tnative.load_ints(str(p), 2)
    with tnative.numpy_path():
        plain = tnative.load_ints(str(p), 2)
    assert bits(got) == bits(plain)
    np.testing.assert_array_equal(got, [[1, 2], [-3, 44], [5, 600], [7, -8]])
    np.testing.assert_array_equal(jnative.load_ints(str(p)), got.ravel())
    q = tmp_path / "one.txt"
    q.write_text("4\n5\n\n6\n")
    one = tnative.load_ints(str(q))
    with tnative.numpy_path():
        assert bits(one) == bits(tnative.load_ints(str(q)))
    assert one.shape == (3,)


@pytest.mark.parametrize("text", ["1, 2\nxyz\n", "1 - 2\n"], ids=["letters", "sign"])
@pytest.mark.parametrize("numpy_path", [False, True])
def test_load_ints_malformed_and_missing_raise(tmp_path, text, numpy_path):
    p = tmp_path / "bad.txt"
    p.write_text(text)
    ctx = tnative.numpy_path() if numpy_path else contextlib.nullcontext()
    with ctx:
        with pytest.raises(ValueError):
            tnative.load_ints(str(p), 2 if "," in text else 1)
        with pytest.raises(FileNotFoundError):
            tnative.load_ints(str(tmp_path / "absent.txt"))
    with pytest.raises(ValueError):
        jnative.load_ints(str(p))


def test_load_ints_refuses_a_fraction(tmp_path):
    """The parser refuses a fraction, as the JAX package's does
    (``np.loadtxt`` parses it through a float, with a DeprecationWarning)."""
    p = tmp_path / "frac.txt"
    p.write_text("1, 2\n3.5, 4\n")
    with pytest.raises(ValueError):
        tnative.load_ints(str(p), 2)
    with pytest.raises(ValueError):
        jnative.load_ints(str(p))


def test_tu_loader_parses_natively(tmp_path):
    from gnnkeras_tpu.data.mutag import load_tu_dataset as jload
    from gnnkeras_tpu_torch.data.mutag import load_tu_dataset
    from gnnkeras_tpu_torch.data.synthetic import random_molecules, write_tu_dump

    write_tu_dump(random_molecules(40, seed=1), str(tmp_path), "SYN")
    got = load_tu_dataset(str(tmp_path), "SYN")
    with tnative.numpy_path():
        plain = load_tu_dataset(str(tmp_path), "SYN")
    ref = jload(str(tmp_path), "SYN")
    for g, p, j in zip(got, plain, ref):
        for name in ("nodes", "arcs", "targets", "arcnode_weight"):
            assert bits(getattr(g, name)) == bits(getattr(p, name)) == bits(getattr(j, name))


# -- whole batches -----------------------------------------------------------------------
def _assert_tree_equal(a, b, path="batch"):
    assert type(a) is type(b), path
    if isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        assert torch.equal(a.reshape(-1).view(torch.uint8), b.reshape(-1).view(torch.uint8)), path
    elif isinstance(a, np.ndarray):
        assert bits(a) == bits(b), path
    elif dataclasses.is_dataclass(a):
        for f in dataclasses.fields(a):
            _assert_tree_equal(getattr(a, f.name), getattr(b, f.name), f"{path}.{f.name}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_tree_equal(x, y, f"{path}[{i}]")
    else:
        assert a == b, path


def _build_bench(parallel_arcs: bool):
    from gnnkeras_tpu_torch import GraphObject, from_graph_object
    from gnnkeras_tpu_torch.data.synthetic import bench_graph

    g = bench_graph()  # the constructor's canonicalisation is part of the build
    if not parallel_arcs:
        _, first = np.unique(g.arcs[:, :2], axis=0, return_index=True)
        g = GraphObject(nodes=g.nodes, arcs=g.arcs[np.sort(first)], targets=g.targets, focus="g",
                        aggregation_mode="average", NodeGraph=(g.graph_of_node, g.nodegraph_weight))
    with contextlib.nullcontext():
        warnings.simplefilter("ignore", RuntimeWarning)  # parallel arcs: bf16 strips
        return from_graph_object(g, slot_pack=128, strip_dtype="int8", device="cpu")


@pytest.mark.parametrize("parallel_arcs", [True, False], ids=["bench_bf16", "bench_int8"])
def test_bench_batch_native_equals_numpy(parallel_arcs):
    """The bench-scale batch (131,488 nodes, 4,337 graphs; int8 strips where
    the weights factor) built through the library and through the NumPy
    paths: every field equal, bit for bit."""
    native = _build_bench(parallel_arcs)
    with tnative.numpy_path():
        plain = _build_bench(parallel_arcs)
    assert (native.strip.scale is None) == parallel_arcs
    _assert_tree_equal(native, plain)


def test_banded_and_arc_batches_native_equal_numpy():
    """The banded int8 route (unique keys, the fused scatter, factorisation)
    and an arc-focused batch's incidence pairs, native against NumPy."""
    from gnnkeras_tpu_torch import GraphObject, from_graph_object
    from gnnkeras_tpu_torch.data.synthetic import large_banded_graph

    def build():
        g = large_banded_graph(n_nodes=4096)
        rng = np.random.default_rng(0)
        arcs = g.arcs
        ga = GraphObject(nodes=g.nodes, arcs=arcs, targets=np.eye(2, dtype=np.float32)[rng.integers(0, 2, len(arcs))],
                         focus="a", aggregation_mode="average")
        return (from_graph_object(g, agg_dtype="auto", device="cpu"),
                from_graph_object(ga, slot_pack=128, strip_dtype="float32", device="cpu"))

    native = build()
    with tnative.numpy_path():
        plain = build()
    assert type(native[0].bcsr).__name__ == "BandedOperator"
    _assert_tree_equal(native, plain)
