"""CompGCN (corr) with a ConvE scorer, trained 1-N, in plain PyTorch: the
reference of the ``compgcn_conve`` configuration.

Vashishth et al. (2020), "Composition-based Multi-Relational Graph
Convolutional Networks", arXiv:1911.03082, as the official code's
``CompGCNConv`` and ``CompGCN_ConvE`` run it (github.com/malllabiisc/CompGCN,
``run.py``'s FB15k-237 command ``-score_func conve -opn corr``); the
scorer is ConvE (Dettmers et al., arXiv:1707.01476). From the definitions:

- the graph: each train triple (s, r, o) as the edge (s, o) of type r and
  (o, s) of type r + R; a message goes from an edge's second entity to its
  first, weighted by the half's ``compute_norm``, deg^-1/2 of both ends
  with the degrees counted over the half's targets (0 for degree 0);
- ccorr(a, b)[k] = sum_i a_i b_((i + k) mod d), by index arithmetic: each
  relation's circulant C[i, k] = b[(i + k) mod d], and a @ C over the
  edges of that relation (no FFT);
- the layer: W_in (first half), W_out (second half) times the composed
  message, summed into the targets by ``index_add``; the self-loop
  W_loop ccorr(x, loop_rel); (drop(in) + drop(out) + loop) / 3; BatchNorm
  by its mean and biased variance over the entities; tanh; relations
  times W_rel; dropout on the entity codes;
- BatchNorm's running statistics: each train-mode use moves them a tenth
  of the way to the batch's mean and unbiased variance; test mode
  normalises by them and drops nothing;
- ConvE: the subject's and relation's codes interleaved into a
  [2 k_w, k_h] image, BatchNorm, ``F.conv2d``, BatchNorm, ReLU, dropout,
  the map to d, dropout, BatchNorm, ReLU, the product with every entity's
  code plus the entity bias;
- the loss: the mean over the queries and the entities of the binary
  cross-entropy, max(x, 0) - x y + log1p(exp(-|x|)), against y =
  (1 - eps) label + 1 / V;
- Adam from its definition (no clipping, no weight decay);
- test mode (``test_energies``), as the official code ranks: a query
  (s, r) scored as it is, and a head query (?, r, o) as (o, r + R).

Dropout takes the program's keep-masks. Everything runs in float32 with
TF32 off in cuBLAS and cuDNN, or, with ``tf32``, on: the control that a
lower precision than the configuration states fails the comparison. It
imports nothing of the port.
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from .rgcn import leaves, rebuild


@dataclass(frozen=True)
class Spec:
    """The sizes and constants of the configuration."""
    d_in: int               # the input tables' width
    k_w: int                # the image is [2 k_w, k_h]
    k_h: int
    n_filters: int
    kernel: int
    layer_drop: float
    hidden_drop: float
    feature_drop: float
    decoder_drop: float
    smoothing: float
    batch: int
    lr: float
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    bn_eps: float = 1e-5

    @property
    def d(self) -> int:
        return self.k_w * self.k_h


def spec_from_settings(settings: dict) -> Spec:
    """A ``Spec`` from a configuration file's settings tree."""
    e, dec, o = settings["Encoder"], settings["Decoder"], \
        settings["Optimizer"]
    if e["Name"] != "compgcn" or dec["Name"] != "conve" \
            or e["Composition"] != "corr" or e["NumberOfLayers"] != "1" \
            or e["Bias"] != "No":
        raise ValueError("the reference covers one CompGCN layer (corr, "
                         "no bias) with the ConvE scorer")
    if o["Algorithm"]["Name"] != "Adam" or "MaxGradientNorm" in o:
        raise ValueError("the reference covers Adam without clipping")
    spec = Spec(d_in=int(e["InitDimension"]), k_w=int(dec["ReshapeWidth"]),
                k_h=int(dec["ReshapeHeight"]),
                n_filters=int(dec["NumberOfFilters"]),
                kernel=int(dec["FilterSize"]),
                layer_drop=float(e["LayerDropout"]),
                hidden_drop=float(e["HiddenDropout"]),
                feature_drop=float(dec["FeatureDropout"]),
                decoder_drop=float(dec["HiddenDropout"]),
                smoothing=float(o["LabelSmoothing"]),
                batch=int(o["BatchSize"]),
                lr=float(o["Algorithm"]["learning_rate"]))
    if int(e["InternalEncoderDimension"]) != spec.d:
        raise ValueError("the layer's width is k_w k_h")
    return spec


@contextlib.contextmanager
def precision(tf32: bool):
    """TF32 off (float32 as stated) or, for the control, on, in cuBLAS and
    cuDNN, for the enclosed block."""
    cuda, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
    saved = cuda.allow_tf32, cudnn.allow_tf32
    cuda.allow_tf32 = cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        cuda.allow_tf32, cudnn.allow_tf32 = saved


# ---------------------------------------------------------------------------
# The encoder
# ---------------------------------------------------------------------------

def halves(train: torch.Tensor, n_vertices: int, n_relations: int) -> list:
    """The two halves of the message graph, each (source, relation,
    target, norm) per edge: (o -> s, r), then (s -> o, r + R)."""
    t = train.long()
    s, r, o = t[:, 0], t[:, 1], t[:, 2]
    out = []
    for target, source, rel in ((s, o, r), (o, s, r + n_relations)):
        deg = torch.bincount(target, minlength=n_vertices).to(torch.float32)
        inv = deg.pow(-0.5)
        inv[torch.isinf(inv)] = 0.0
        out.append((source, rel, target, inv[target] * inv[source]))
    return out


def circulant(b: torch.Tensor) -> torch.Tensor:
    """[..., d, d] with C[i, k] = b[(i + k) mod d]."""
    d = b.shape[-1]
    i = torch.arange(d, device=b.device)
    return b[..., (i[:, None] + i[None, :]) % d]


def ccorr_by_relation(x: torch.Tensor, source: torch.Tensor,
                      rel: torch.Tensor, z: torch.Tensor) -> tuple:
    """(ccorr(x[source_e], z[rel_e]) for every edge, grouped by relation;
    the edges' order in it): x[source] times its relation's circulant."""
    order = torch.argsort(rel, stable=True)
    rel_sorted = rel[order]
    ids, counts = torch.unique_consecutive(rel_sorted, return_counts=True)
    c = circulant(z)
    parts, start = [], 0
    for r_id, n in zip(ids.tolist(), counts.tolist()):
        rows = order[start:start + n]
        parts.append(x[source[rows]] @ c[r_id])
        start += n
    return torch.cat(parts), order


MOMENTUM = 0.1  # the share of a batch's statistics in the running ones


def init_stats(spec: Spec) -> dict:
    """The running statistics of the four BatchNorms before training:
    mean 0 and variance 1 per channel (the layer's, then the scorer's
    image, filters and map)."""
    sizes = {"layer": spec.d, "bn0": 1, "bn1": spec.n_filters,
             "bn2": spec.d}
    return {k: {"mean": torch.zeros(n), "var": torch.ones(n)}
            for k, n in sizes.items()}


def batch_norm(x: torch.Tensor, weight, bias, dims, eps, stats=None,
               training: bool = True) -> torch.Tensor:
    """(x - mean) / sqrt(var + eps) weight + bias per channel of axis 1.
    In training the mean and the biased variance over ``dims``, and the
    running ``stats`` (where given) moved by MOMENTUM towards that mean and
    the unbiased variance; in test mode the running mean and variance."""
    shape = [1] * x.dim()
    shape[1] = -1
    if training:
        mean = x.mean(dim=dims, keepdim=True)
        var = ((x - mean) ** 2).mean(dim=dims, keepdim=True)
        if stats is not None:
            n = x.numel() // x.shape[1]
            with torch.no_grad():
                stats["mean"] = (1 - MOMENTUM) * stats["mean"] \
                    + MOMENTUM * mean.reshape(-1)
                stats["var"] = (1 - MOMENTUM) * stats["var"] \
                    + MOMENTUM * var.reshape(-1) * n / (n - 1)
    else:
        mean, var = stats["mean"].view(shape), stats["var"].view(shape)
    return (x - mean) / torch.sqrt(var + eps) * weight.view(shape) \
        + bias.view(shape)


def dropout(x: torch.Tensor, keep, drop: float):
    """Inverted dropout by ``keep``; nothing dropped where it is None
    (test mode)."""
    if keep is None:
        return x
    return torch.where(keep, x / (1.0 - drop), torch.zeros_like(x))


def encode(params: dict, graph: list, spec: Spec, masks,
           stats=None) -> tuple:
    """(entity codes [V, d], relation codes [2R, d]): in train mode, with
    ``masks``, after the codes' dropout, and the layer's running
    statistics in ``stats`` (where given) moved; in test mode (``masks``
    None) normalised by them. ``stats``: ``init_stats``' tree, whose
    tensors are replaced as they move."""
    training, stats = masks is not None, stats or {}
    masks = masks if training else [None] * 5
    x = params["entity_embedding"]["W"]
    z = params["relation_embedding"]["W_relation"]
    layer = params["compgcn_layers"][0]
    sums = []
    for (source, rel, target, norm), w in zip(graph, ("W_in", "W_out")):
        composed, order = ccorr_by_relation(x, source, rel, z)
        msgs = (composed @ layer[w]) * norm[order, None]
        sums.append(x.new_zeros(x.shape[0], spec.d).index_add(
            0, target[order], msgs))
    loop = (x @ circulant(layer["loop_rel"][0])) @ layer["W_loop"]
    out = dropout(sums[0], masks[0], spec.layer_drop) / 3 \
        + dropout(sums[1], masks[1], spec.layer_drop) / 3 + loop / 3
    out = torch.tanh(batch_norm(out, layer["bn_weight"], layer["bn_bias"],
                                (0,), spec.bn_eps, stats.get("layer"),
                                training))
    return dropout(out, masks[2], spec.hidden_drop), z @ layer["W_rel"]


# ---------------------------------------------------------------------------
# The scorer and the objective
# ---------------------------------------------------------------------------

def energies(params: dict, x: torch.Tensor, z: torch.Tensor,
             queries: torch.Tensor, spec: Spec, masks,
             stats=None) -> torch.Tensor:
    """[n, V] ConvE energies of the queries (s, r) against every entity;
    train or test mode as ``encode``."""
    training, stats = masks is not None, stats or {}
    masks = masks if training else [None] * 5
    p = params["decoder"]
    q = queries.long()
    e1, r = x[q[:, 0]], z[q[:, 1]]
    n = e1.shape[0]
    image = torch.stack([e1, r], dim=2).reshape(n, 1, 2 * spec.k_w,
                                                spec.k_h)
    h = batch_norm(image, p["bn0_weight"], p["bn0_bias"], (0, 2, 3),
                   spec.bn_eps, stats.get("bn0"), training)
    h = F.conv2d(h, p["conv_W"])
    h = torch.relu(batch_norm(h, p["bn1_weight"], p["bn1_bias"], (0, 2, 3),
                              spec.bn_eps, stats.get("bn1"), training))
    h = dropout(h, masks[3], spec.feature_drop).reshape(n, -1)
    h = dropout(h @ p["fc_W"] + p["fc_b"], masks[4], spec.decoder_drop)
    h = torch.relu(batch_norm(h, p["bn2_weight"], p["bn2_bias"], (0,),
                              spec.bn_eps, stats.get("bn2"), training))
    return h @ x.T + p["entity_bias"]


def kvsall_loss(params: dict, graph: list, step: dict, spec: Spec,
                stats=None) -> torch.Tensor:
    """The mean binary cross-entropy of every query's energies against its
    smoothed label row; ``stats`` (where given) moved."""
    x, z = encode(params, graph, spec, step["keep_masks"], stats)
    s = energies(params, x, z, step["queries"], spec, step["keep_masks"],
                 stats)
    y = step["labels"].to(torch.float32) * (1.0 - spec.smoothing) \
        + 1.0 / x.shape[0]
    ce = torch.clamp(s, min=0.0) - s * y + torch.log1p(torch.exp(-s.abs()))
    return ce.mean()


def step_losses(params: list, steps: list, spec: Spec, train: torch.Tensor,
                n_relations: int, tf32: bool = False) -> list:
    """Each step's loss from the params it was taken from: ``params[t]``
    (a tree each) on ``steps[t]``, on the message graph ``train`` [E, 3];
    TF32 on where ``tf32`` (the control)."""
    n_vertices = int(params[0]["entity_embedding"]["W"].shape[0])
    graph = halves(train, n_vertices, n_relations)
    with torch.no_grad(), precision(tf32):
        return [float(kvsall_loss(p, graph, step, spec))
                for p, step in zip(params, steps)]


def test_energies(params: dict, stats: dict, spec: Spec, train: torch.Tensor,
                  n_relations: int, queries: torch.Tensor) -> torch.Tensor:
    """[n, V] test-mode energies of the queries (s, r), r in [0, 2R), on
    the message graph ``train`` [E, 3], normalised by the running
    ``stats``; a head query (?, r, o) is the query (o, r + R)."""
    n_vertices = int(params["entity_embedding"]["W"].shape[0])
    with torch.no_grad():
        x, z = encode(params, halves(train, n_vertices, n_relations), spec,
                      None, stats)
        return energies(params, x, z, queries, spec, None, stats)


def train_steps(params0: dict, steps: list, spec: Spec, train: torch.Tensor,
                n_relations: int, tf32: bool = False, state=None,
                stats=None) -> dict:
    """The training steps from ``params0`` (left unchanged), one a dict of
    ``steps``: ``queries`` [n, 2+] (s, r), ``labels`` [n, V] bool and the
    five ``keep_masks``; the message graph is ``train`` [E, 3]. Adam starts
    from ``state`` (``mu``, ``nu`` and ``count``) or from nothing. Returns
    each step's ``losses``, the first step's gradient (``first_grads``, by
    leaf), the params after the last (``params``, by leaf) and Adam's
    moments then (``mu``, ``nu``, by leaf), and the BatchNorms' running
    statistics after the last (``stats``; from ``stats``, or from
    ``init_stats``)."""
    flat = {k: v.detach().clone() for k, v in leaves(params0).items()}
    n_vertices = int(params0["entity_embedding"]["W"].shape[0])
    graph = halves(train, n_vertices, n_relations)
    if state is None:
        mu = {k: torch.zeros_like(v) for k, v in flat.items()}
        nu = {k: torch.zeros_like(v) for k, v in flat.items()}
        taken = 0
    else:
        mu = {k: v.clone() for k, v in leaves(state["mu"]).items()}
        nu = {k: v.clone() for k, v in leaves(state["nu"]).items()}
        taken = int(state["count"])
    stats = {k: {"mean": v["mean"].to(train.device),
                 "var": v["var"].to(train.device)}
             for k, v in (stats or init_stats(spec)).items()}
    losses, first = [], None
    with precision(tf32):
        for t, step in enumerate(steps, start=taken + 1):
            for v in flat.values():
                v.requires_grad_(True)
            loss = kvsall_loss(rebuild(params0, flat), graph, step, spec,
                               stats)
            keys = list(flat)
            grads = torch.autograd.grad(loss, [flat[k] for k in keys],
                                        allow_unused=True)
            grads = {k: torch.zeros_like(flat[k]) if g is None else g
                     for k, g in zip(keys, grads)}
            losses.append(float(loss.detach()))
            with torch.no_grad():
                if first is None:
                    first = {k: g.clone() for k, g in grads.items()}
                for k in keys:
                    g = grads[k]
                    mu[k] = (1 - spec.b1) * g + spec.b1 * mu[k]
                    nu[k] = (1 - spec.b2) * g * g + spec.b2 * nu[k]
                    m_hat = mu[k] / (1 - spec.b1 ** t)
                    v_hat = nu[k] / (1 - spec.b2 ** t)
                    flat[k] = flat[k].detach() \
                        - spec.lr * m_hat / (torch.sqrt(v_hat) + spec.eps)
    return {"losses": losses, "first_grads": first,
            "params": {k: v.detach() for k, v in flat.items()},
            "mu": mu, "nu": nu,
            "stats": {k: {"mean": v["mean"], "var": v["var"]}
                      for k, v in stats.items()}}
