"""The whole unfolds (kernel rows 2 and 4) summed in the CUDA kernels'
order, in NumPy, as the reference of their bit-for-bit tests.

Every aggregate is a fused multiply-add chain from +0 over the contraction
ascending (row 2: source rows, row 4: source columns); every transition
output is two chains over the features ascending (state, aggregate), then
``(zs + za) + c`` and the activation, all in f32.  Row 4 with bf16 blocks
rounds the weights (once), the state and the aggregate (every iteration) to
bf16, to nearest even.  ``fma_f32`` rounds once: the product of two f32
values is exact in f64, the f64 sum is rounded to odd, and 53 >= 24 + 2
bits make the rounding to f32 that follows the single rounding of the exact
value.

With ``skip_zeros`` each chain walks only its nonzero entries, as the
kernels do; without, it walks all 128.  A zero entry adds a zero product,
which leaves a chain as it was: a chain from +0 never holds -0, since an
exact zero sum of two values of opposite signs is +0.
"""

import numpy as np
import torch

TILE = 128
_SELU_SCALE = np.float32(1.0507009873554805)
_SELU_ALPHA = np.float32(1.6732632423543772)

# the kernels' activations in f32 (selu spelled with exp(x) - 1); only
# "linear" is free of the card's own exp and tanh, so only it is compared
# bit for bit with a kernel
ACTIVATIONS = {
    "selu": lambda x: _SELU_SCALE * np.where(x > 0, x, _SELU_ALPHA * (np.exp(x) - np.float32(1))),
    "relu": lambda x: np.maximum(x, np.float32(0)),
    "tanh": np.tanh,
    "sigmoid": lambda x: np.float32(1) / (np.float32(1) + np.exp(-x)),
    "linear": lambda x: x,
}


def fma_f32(a, b, c):
    """``fmaf(a, b, c)`` elementwise on f32 arrays, rounded once."""
    p = np.asarray(a, np.float64) * np.asarray(b, np.float64)
    c = np.asarray(c, np.float64)
    s = p + c
    bp = s - p
    err = (p - (s - bp)) + (c - bp)  # s + err == p + c exactly
    # rounded to odd: an inexact s with an even last bit moves one ulp
    # toward the exact sum (s != 0 where err != 0)
    bits = s.view(np.int64)
    bits += ((err != 0) & ((bits & 1) == 0)) * np.where((err > 0) == (s > 0), 1, -1)
    return s.astype(np.float32)


def bf16(x):
    """f32 rounded to bf16 (to nearest even) and back."""
    return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(torch.bfloat16).float().numpy()


def _chain(terms, skip_zeros):
    """The contraction's steps for each output: (weights, sources, live) per
    step, each (T, 128) over the outputs, from ``terms`` (T, out, k) = the
    entry the output takes from source k.  Dense: every k in order.
    Skipping zeros: step r takes each output's r-th nonzero source."""
    t = terms.shape[0]
    if not skip_zeros:
        return [(terms[:, :, k], np.full((t, TILE), k), np.ones((t, TILE), bool)) for k in range(TILE)]
    nz = terms != 0
    rank = np.cumsum(nz, axis=2) - 1
    steps = []
    for r in range(int(nz.sum(axis=2).max(initial=0))):
        hit = nz & (rank == r)
        src = hit.argmax(axis=2)
        steps.append((np.take_along_axis(terms, src[:, :, None], axis=2)[:, :, 0], src, hit.any(axis=2)))
    return steps


def unfold_t(state0_t, const_t, ws_t, wa_t, blocks, n_iter, activation, skip_zeros=True):
    """Row 2: feature-major (D, N) state and constant, the padded (D, D)
    transposed weights ``ws_t[g][f]``, f32 values of the bf16 blocks (T, src
    rows, dst cols).  Returns the (D, N) state."""
    act = ACTIVATIONS[activation]
    d, n = state0_t.shape
    t = blocks.shape[0]
    tiles = lambda x: np.ascontiguousarray(np.asarray(x, np.float32).reshape(d, t, TILE).transpose(1, 0, 2))
    s, c = tiles(state0_t), tiles(const_t)  # (T, D, 128)
    # terms[t, j, i] = A[t, i, j]: output column j takes source row i
    steps = _chain(np.asarray(blocks, np.float32).transpose(0, 2, 1), skip_zeros)
    ws_t, wa_t = np.asarray(ws_t, np.float32), np.asarray(wa_t, np.float32)
    for _ in range(n_iter):
        agg = np.zeros_like(s)
        for a, src, live in steps:
            x = np.take_along_axis(s, src[:, None, :], axis=2)  # s[t, f, src[t, j]]
            agg = np.where(live[:, None, :], fma_f32(x, a[:, None, :], agg), agg)
        zs, za = np.zeros_like(s), np.zeros_like(s)
        for f in range(d):
            zs = fma_f32(ws_t[None, :, f, None], s[:, f, None, :], zs)
            za = fma_f32(wa_t[None, :, f, None], agg[:, f, None, :], za)
        s = act((zs + za) + c).astype(np.float32)
    return s.transpose(1, 0, 2).reshape(d, n)


def unfold(state0, const, w_state, w_agg, blocks, n_iter, activation, round_bf16, skip_zeros=True):
    """Row 4: row-major (N, d) state and constant, the (d, d) weights
    ``w[f][g]``, f32 values of the blocks (T, dst rows, src cols);
    ``round_bf16`` for bf16 blocks.  Returns the (N, d) state."""
    act = ACTIVATIONS[activation]
    rnd = bf16 if round_bf16 else (lambda x: np.asarray(x, np.float32))
    n, d = state0.shape
    t = blocks.shape[0]
    s = np.asarray(state0, np.float32).reshape(t, TILE, d)
    c = np.asarray(const, np.float32).reshape(t, TILE, d)
    ws, wa = rnd(w_state), rnd(w_agg)
    steps = _chain(np.asarray(blocks, np.float32), skip_zeros)  # row i takes source column j
    for _ in range(n_iter):
        sc = rnd(s)
        agg = np.zeros_like(s)
        for a, src, live in steps:
            x = np.take_along_axis(sc, src[:, :, None], axis=1)  # sc[t, src[t, i], f]
            agg = np.where(live[:, :, None], fma_f32(a[:, :, None], x, agg), agg)
        ac = rnd(agg)
        zs, za = np.zeros_like(s), np.zeros_like(s)
        for f in range(d):
            zs = fma_f32(sc[:, :, f, None], ws[None, None, f, :], zs)
            za = fma_f32(ac[:, :, f, None], wa[None, None, f, :], za)
        s = act((zs + za) + c).astype(np.float32)
    return s.reshape(n, d)


def blocks(t, seed, special):
    """(t, 128, 128) f32 block values, each a bf16 value: 5% nonzeros of
    weight up to 0.3 in random places.  With ``special``, tile 0 is fully
    dense (weights about 1/128, as average aggregation's), tile 1 all zero
    (half its zeros -0), and tile 2 has line 5 (row and column) empty."""
    rng = np.random.default_rng(seed)
    out = 0.3 * (rng.random((t, TILE, TILE)) < 0.05) * rng.random((t, TILE, TILE))
    if special:
        out[0] = rng.uniform(0.5, 1.0, (TILE, TILE)) / TILE
        out[1] = np.where(rng.random((TILE, TILE)) < 0.5, -0.0, 0.0)
        out[2, 5, :] = out[2, :, 5] = 0.0
    return bf16(out.astype(np.float32))


def inputs_t(d_pad, t, seed, special):
    """Row 2's inputs: feature-major state ~N(0, 1) and constant
    ~N(0, 0.3²) with zero pad rows, (d, d) weights scaled by 1/sqrt(d),
    d = d_pad - 2, and ``blocks``."""
    d = d_pad - 2
    rng = np.random.default_rng(seed)
    s0 = np.zeros((d_pad, t * TILE), np.float32)
    s0[:d] = rng.normal(size=(d, t * TILE))
    c = np.zeros((d_pad, t * TILE), np.float32)
    c[:d] = rng.normal(0.0, 0.3, size=(d, t * TILE))
    w = lambda: (0.25 * (14 / d) ** 0.5 * rng.normal(size=(d, d))).astype(np.float32)
    return s0, c, w(), w(), blocks(t, seed, special)


def inputs_rm(d, t, seed, special, w_std):
    """Row 4's inputs: row-major state ~N(0, 1) and constant ~N(0, 0.3²),
    (d, d) weights ~N(0, w_std²), and ``blocks``."""
    rng = np.random.default_rng(seed)
    s0 = rng.normal(size=(t * TILE, d)).astype(np.float32)
    c = rng.normal(0.0, 0.3, size=(t * TILE, d)).astype(np.float32)
    w = lambda: (w_std * rng.normal(size=(d, d))).astype(np.float32)
    return s0, c, w(), w(), blocks(t, seed, special)


def pad_t(w, d_pad):
    """Row 2's (d_pad, d_pad) transposed, zero-padded weights."""
    d = w.shape[0]
    return np.pad(w.T, ((0, d_pad - d), (0, d_pad - d)))


def same_bits(a, b):
    return a.shape == b.shape and np.array_equal(a.view(np.int32), b.view(np.int32))
