"""Plain PyTorch reference of the benchmark's GNNs, written from the model's
equations (GNNkeras' GNN: Scarselli et al.'s iterate-to-convergence
transition, a BatchNorm → Dense state net and a BatchNorm → Dense output
net), with no kernels, no padding, no batching tricks and no operator
storage.  It imports nothing of the program under test.

Graph: arcs ``src → dst`` with the 'average' weight 1 / in-degree(dst);
``Σ x`` below is ``Σ_{arcs into v} w · x[src]``, summed with ``index_add_``
over the arc list.  The constant sums of the labels are taken in float64
and cast once, as the GNNkeras data pipeline takes them on the host.

At dim_state 0 the state is the node label.  One iteration:
``state ← selu(Dense(BN([state | Σ state | Σ arc labels])))``; iteration 0
uses the labels' float64 sum.  Training runs ``max_iter`` iterations with
a running flag (a node moved by more than ``threshold · ‖old‖₂`` keeps the
loop running; once no node does, the state is kept).  BatchNorm normalises
with the batch's moments (biased variance, ε 1e-3), as in training.  The
output net reads the converged state: one row a node (node focus) or the
mean of a molecule's node outputs (graph focus).
Losses: mean squared error, or categorical cross-entropy of the
renormalised, ε-clipped probabilities; the mean over the supervised rows.
Adam as optax's (b1 0.9, b2 0.999, ε 1e-7 outside the root, the bias
corrections in float32).

Float32 throughout, with TF32 off, or float64 where the graph and the
weights come in float64 (Adam's bias corrections stay in float32, as the
optimizer takes them).  ``Matmul('tf32')`` rounds both operands of every
float32 Dense product, forward and backward, to TF32's 10-bit mantissa
first: the control the comparison must fail.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import torch

SELU_SCALE, SELU_ALPHA = 1.0507009873554805, 1.6732632423543772
BN_EPS = 1e-3
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-7
CCE_EPS = 1e-7


def set_strict_float32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to the nearest value with a 10-bit mantissa (ties to even)."""
    i = x.contiguous().view(torch.int32)
    i = (i + 0x0FFF + ((i >> 13) & 1)) & ~0x1FFF
    return i.view(torch.float32)


class _Tf32Matmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        a, b = round_tf32(a), round_tf32(b)
        ctx.save_for_backward(a, b)
        return a @ b

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = round_tf32(g)
        return g @ b.T, a.T @ g


class Matmul:
    """The Dense product: plain float32, or every operand rounded to TF32."""

    def __init__(self, precision: str = "float32"):
        if precision not in ("float32", "tf32"):
            raise ValueError(f"precision {precision!r} (float32 | tf32)")
        self.precision = precision

    def __call__(self, a, b):
        return a @ b if self.precision == "float32" else _Tf32Matmul.apply(a, b)


@dataclasses.dataclass
class Graph:
    """A graph (or a batch of molecules as one disjoint graph) on a device."""

    nodes: torch.Tensor  # (N, dn)
    src: torch.Tensor  # (A,) int64
    dst: torch.Tensor  # (A,) int64
    weight: torch.Tensor  # (A,) 1 / in-degree(dst)
    sum_nodes: torch.Tensor  # (N, dn) Σ labels, float64 sums cast once
    sum_arcs: torch.Tensor  # (N, da) Σ arc labels, the same
    targets: torch.Tensor  # (rows, c)
    graph_of: Optional[torch.Tensor] = None  # (N,) molecule of each node (graph focus)
    node_weight: Optional[torch.Tensor] = None  # (N,) 1 / atoms of its molecule
    n_graphs: int = 0


def _sum64(rows: torch.Tensor, dst, weight64, n: int, dtype) -> torch.Tensor:
    """``Σ_{arcs into v} w · rows[arc]`` in float64, cast once."""
    out = torch.zeros((n, rows.shape[1]), dtype=torch.float64, device=rows.device)
    return out.index_add_(0, dst, rows.double() * weight64[:, None]).to(dtype)


def make_graph(nodes, src, dst, arc_label, targets, node_start=None, device="cpu",
               dtype: torch.dtype = torch.float32) -> Graph:
    """A ``Graph`` from NumPy arrays, its numbers in ``dtype``;
    ``node_start`` (G + 1,) makes it a batch of molecules (graph focus)."""
    t = lambda x: torch.as_tensor(x, device=device)
    nodes, arc_label, targets = t(nodes).to(dtype), t(arc_label).to(dtype), t(targets).to(dtype)
    src, dst = t(src).long(), t(dst).long()
    n = nodes.shape[0]
    degree = torch.bincount(dst, minlength=n).double()
    weight64 = 1.0 / degree[dst]
    graph_of = node_weight = None
    n_graphs = 0
    if node_start is not None:
        starts = t(node_start).long()
        sizes = starts[1:] - starts[:-1]
        n_graphs = int(sizes.shape[0])
        graph_of = torch.repeat_interleave(torch.arange(n_graphs, device=nodes.device), sizes)
        node_weight = (1.0 / sizes.double()).to(dtype)[graph_of]
    return Graph(nodes=nodes, src=src, dst=dst, weight=weight64.to(dtype),
                 sum_nodes=_sum64(nodes[src], dst, weight64, n, dtype),
                 sum_arcs=_sum64(arc_label, dst, weight64, n, dtype),
                 targets=targets, graph_of=graph_of, node_weight=node_weight, n_graphs=n_graphs)


def aggregate(x: torch.Tensor, g: Graph) -> torch.Tensor:
    out = torch.zeros_like(x)
    return out.index_add(0, g.dst, x[g.src] * g.weight[:, None])


def activation(name: str, x: torch.Tensor) -> torch.Tensor:
    if name == "selu":
        return SELU_SCALE * torch.where(x > 0, x, SELU_ALPHA * torch.expm1(x))
    if name == "softmax":
        return torch.softmax(x, dim=-1)
    if name in ("linear", None):
        return x
    raise ValueError(f"activation {name!r}")


def net(params: Dict[str, torch.Tensor], prefix: str, x: torch.Tensor, act: str, mm: Matmul) -> torch.Tensor:
    """BatchNorm (the batch's moments) → Dense → activation over rows."""
    mean = x.mean(dim=0)
    var = torch.square(x - mean).mean(dim=0)
    x = (x - mean) * torch.rsqrt(var + BN_EPS) * params[f"{prefix}.bn.gamma"] + params[f"{prefix}.bn.beta"]
    return activation(act, mm(x, params[f"{prefix}.dense.kernel"]) + params[f"{prefix}.dense.bias"])


def _moving(state: torch.Tensor, old: torch.Tensor, threshold: float) -> torch.Tensor:
    """0-dim bool: does any node move by more than ``threshold · ‖old‖₂``?"""
    state, old = state.detach(), old.detach()
    if threshold == 0.0:
        return torch.any(state != old)
    distance = torch.sqrt(torch.sum(torch.square(state - old), dim=1))
    return torch.any(distance > threshold * torch.sqrt(torch.sum(torch.square(old), dim=1)))


def forward(params, g: Graph, cfg: dict, mm: Matmul) -> torch.Tensor:
    """The training forward's output rows.  ``cfg`` is the configuration
    file: ``max_iter``, ``state_threshold``, the nets' ``activation``,
    ``focus`` ('n' or 'g')."""
    K, threshold = int(cfg["max_iter"]), float(cfg["state_threshold"])

    def transition(state, summed):
        inp = torch.cat([state, summed, g.sum_arcs], dim=1)
        return net(params, "state", inp, cfg["state_net"]["activation"], mm)

    state = g.nodes
    running = _moving(state, torch.ones_like(state), threshold)
    for step in range(K):
        new = transition(state, g.sum_nodes if step == 0 else aggregate(state, g))
        changed = _moving(new, state, threshold)
        state = torch.where(running, new, state)
        running = running & changed
    out = net(params, "output", state, cfg["output_net"]["activation"], mm)
    if cfg["focus"] == "g":
        rows = torch.zeros((g.n_graphs, out.shape[1]), dtype=out.dtype, device=out.device)
        out = rows.index_add(0, g.graph_of, out * g.node_weight[:, None])
    return out


def row_loss(name: str, y: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    if name in ("mse", "mean_squared_error"):
        return torch.mean(torch.square(y - p), dim=-1)
    if name == "categorical_crossentropy":
        p = p / torch.clamp_min(torch.sum(p, dim=-1, keepdim=True), CCE_EPS)
        return -torch.sum(y * torch.log(torch.clamp(p, CCE_EPS, 1.0 - CCE_EPS)), dim=-1)
    raise ValueError(f"loss {name!r}")


def objective(params, g: Graph, cfg: dict, mm: Matmul, fault: Optional[str] = None) -> torch.Tensor:
    """The training loss of one batch; ``fault`` 'half_batch' takes the mean
    over the first half of the rows only, 'altered' scales the loss by 1.01."""
    out = forward(params, g, cfg, mm)
    per_row = row_loss(cfg["loss"], g.targets, out)
    if fault == "half_batch":
        per_row = per_row[: (per_row.shape[0] + 1) // 2]
    loss = per_row.mean()
    return loss * 1.01 if fault == "altered" else loss


class Adam:
    """Adam from zero moments, or from ``state`` (``mu``, ``nu`` by leaf and
    the step count ``t``)."""

    def __init__(self, params: Dict[str, torch.Tensor], lr: float, state: Optional[dict] = None):
        self.lr = float(lr)
        if state is None:
            self.t = 0
            self.mu = {k: torch.zeros_like(v) for k, v in params.items()}
            self.nu = {k: torch.zeros_like(v) for k, v in params.items()}
        else:
            self.t = int(state["t"])
            self.mu = {k: state["mu"][k].detach().clone() for k in params}
            self.nu = {k: state["nu"][k].detach().clone() for k in params}

    @torch.no_grad()
    def step(self, params, grads) -> None:
        self.t += 1
        for key, g in grads.items():
            self.mu[key] = (1.0 - ADAM_B1) * g + ADAM_B1 * self.mu[key]
            self.nu[key] = (1.0 - ADAM_B2) * g * g + ADAM_B2 * self.nu[key]
            # the bias corrections in float32, as optax takes them: 1 − 0.999 in
            # float32 is 1.3e-5 off, which near-cancelling gradients carry on
            t = torch.tensor(float(self.t), dtype=torch.float32, device=g.device)
            mu_hat = self.mu[key] / (1.0 - torch.pow(ADAM_B1, t))
            nu_hat = self.nu[key] / (1.0 - torch.pow(ADAM_B2, t))
            params[key] -= self.lr * mu_hat / (torch.sqrt(nu_hat) + ADAM_EPS)


def trainable(params: Dict[str, torch.Tensor]) -> List[str]:
    """The leaves training moves (the moving statistics are not among them)."""
    return [k for k in params if not k.endswith(("moving_mean", "moving_var"))]


def train(params0: Dict[str, torch.Tensor], batches: List[Graph], cfg: dict, lr: float, mm: Matmul,
          keep: Tuple[int, ...] = (), fault: Optional[str] = None, adam: Optional[dict] = None) -> dict:
    """Adam steps over ``batches`` (one step each, in order) from
    ``params0``, with Adam from zero or from ``adam`` (``Adam``'s state).
    Returns the per-step losses and batch sizes, the first step's
    gradients, and after each step in ``keep`` (1-based) and after the last
    the state: ``params``, ``mu``, ``nu`` and ``t``.  ``fault``:
    'half_batch' and 'altered' as ``objective``; 'unchanged' leaves the
    parameters and Adam's state where they are."""
    params = {k: v.detach().clone() for k, v in params0.items()}
    keys = trainable(params)
    opt = Adam({k: params[k] for k in keys}, lr, adam)
    losses, rows, first_grads, states = [], [], None, {}
    for step, g in enumerate(batches, start=1):
        leaves = {k: params[k].detach().requires_grad_(True) for k in keys}
        loss = objective({**params, **leaves}, g, cfg, mm, fault)
        grads = dict(zip(keys, torch.autograd.grad(loss, [leaves[k] for k in keys])))
        losses.append(float(loss.detach()))
        rows.append(int(g.targets.shape[0]))
        if first_grads is None:
            first_grads = grads
        if fault != "unchanged":
            opt.step(params, grads)
        if step in keep or step == len(batches):
            states[step] = {"params": {k: params[k].clone() for k in keys}, "t": opt.t,
                            "mu": {k: v.clone() for k, v in opt.mu.items()},
                            "nu": {k: v.clone() for k, v in opt.nu.items()}}
    return {"losses": losses, "rows": rows, "first_grads": first_grads, "states": states}
