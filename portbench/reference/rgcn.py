"""The R-GCN link predictor in plain PyTorch: the reference of the
``rgcn_block`` and ``rgcn_basis`` configurations.

Schlichtkrull et al. (2017), "Modeling Relational Data with Graph
Convolutional Networks", arXiv:1703.06103, as the configurations' settings
files state it (RelationPrediction's ``settings/gcn_block.exp`` and
``gcn_basis.exp``): a one-hot input through an input transform with a bias
and a ReLU; ``n_layers`` layers, each the sum over both directions of the
message edges of the relation's weights times the neighbour's features,
normalised by the target's degree in that direction (eq. 2, c = |N_i|),
plus a self-loop product with dropout on it alone (kept with probability
``keep``, scaled by 1 / keep), and a ReLU on every layer but the last. The
weights are block-diagonal (eq. 4: B blocks of dr x dr) or a combination
of B bases (eq. 3). The DistMult decoder scores e_s^T diag(r) e_o; the
training objective is the mean sigmoid cross-entropy over each positive and
its ``rate`` corruptions (subject or object replaced by a coin), plus
``reg`` times the mean square of the scored codes; the update clips the
gradients to a global norm of ``max_norm`` and takes one Adam step.

Every product is taken per edge, as the equations write it, in float32.
With ``tf32`` every product's operands (and, in training, the cotangents
that enter its backward) are rounded to TF32's 10-bit mantissa: the
control that a lower precision than the configuration states fails the
comparison. Departures from the paper, kept as the settings files run:
the block and basis layers create a bias and never add it (its gradient is
zero); the input transform is the one-hot layer's weight table.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class Spec:
    """The sizes and constants of one configuration."""
    variant: str        # "block" or "basis"
    d: int              # every layer's width and the code width
    n_layers: int
    n_blocks: int       # blocks (block) or bases (basis)
    keep: float         # dropout keep probability of the self-loop
    rate: int           # corruptions a positive
    reg: float          # DistMult's regularization parameter
    lr: float
    max_norm: float
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8

    @property
    def dr(self) -> int:
        return self.d // self.n_blocks


def spec_from_settings(settings: dict) -> Spec:
    """A ``Spec`` from a configuration file's settings tree (the .exp
    file's sections as nested dicts of strings)."""
    g, e, o = settings["General"], settings["Encoder"], settings["Optimizer"]
    if e["Name"] != "gcn_basis" or e["UseInputTransform"] != "Yes":
        raise ValueError("the reference covers gcn_basis with an input "
                         "transform, blocks or bases")
    if settings["Decoder"]["Name"] != "bilinear-diag":
        raise ValueError("the reference covers the DistMult decoder")
    algo = o["Algorithm"]
    if algo["Name"] != "Adam":
        raise ValueError("the reference covers Adam")
    return Spec(variant="block" if e["Concatenation"] == "Yes" else "basis",
                d=int(e["InternalEncoderDimension"]),
                n_layers=int(e["NumberOfLayers"]),
                n_blocks=int(e["NumberOfBasisFunctions"]),
                keep=float(e["DropoutKeepProbability"]),
                rate=int(g["NegativeSampleRate"]),
                reg=float(settings["Decoder"]["RegularizationParameter"]),
                lr=float(algo["learning_rate"]),
                max_norm=float(o["MaxGradientNorm"]))


# ---------------------------------------------------------------------------
# TF32 rounding (the control)
# ---------------------------------------------------------------------------

def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """``x`` (float32) rounded to the nearest value with a 10-bit
    mantissa, as the tensor cores read a TF32 operand."""
    bits = x.contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    bits = (bits + 0x0FFF + lsb) & ~0x1FFF
    return bits.view(torch.float32)


class _RoundValue(torch.autograd.Function):
    """A TF32 operand: the value rounded, its gradient passed on."""

    @staticmethod
    def forward(ctx, x):
        return tf32_round(x)

    @staticmethod
    def backward(ctx, g):
        return g


class _RoundCotangent(torch.autograd.Function):
    """A product's output: the value as it is, the cotangent that enters
    the product's backward rounded (the backward products are TF32 too)."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return tf32_round(g)


def product(equation: str, a: torch.Tensor, b: torch.Tensor,
            tf32: bool = False) -> torch.Tensor:
    """``torch.einsum(equation, a, b)`` in float32, or with TF32 operands
    in the forward and the backward products (sums in float32)."""
    if not tf32:
        return torch.einsum(equation, a, b)
    out = torch.einsum(equation, _RoundValue.apply(a), _RoundValue.apply(b))
    return _RoundCotangent.apply(out)


def exact_float32() -> None:
    """No TF32 in cuBLAS or cuDNN: the configuration states float32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


# ---------------------------------------------------------------------------
# The encoder
# ---------------------------------------------------------------------------

@dataclass
class Graph:
    """Message edges (int64 [E] each) and their degree normalisation."""
    src: torch.Tensor
    rel: torch.Tensor
    dst: torch.Tensor
    n_vertices: int

    def norm(self, target: torch.Tensor) -> torch.Tensor:
        """1 / the degree of each edge's target, counted over the edges."""
        deg = torch.bincount(target, minlength=self.n_vertices)
        return 1.0 / deg[target].to(torch.float32)


def graph_of(triples: torch.Tensor, n_vertices: int) -> Graph:
    t = triples.long()
    return Graph(t[:, 0], t[:, 1], t[:, 2], n_vertices)


def messages(x: torch.Tensor, layer: dict, direction: str, src, rel,
             spec: Spec, tf32: bool) -> torch.Tensor:
    """[E, d] messages W_r x_src of one direction (``forward`` or
    ``backward`` weights), per edge."""
    xs = x[src]
    if spec.variant == "block":
        w = layer[f"W_{direction}"][rel]                   # [E, B, dr, dr]
        xb = xs.view(-1, spec.n_blocks, spec.dr)
        return product("ebij,ebj->ebi", w, xb, tf32).reshape(-1, spec.d)
    w = layer[f"W_{direction}"]                            # [d, B, d]
    per_basis = product("ei,ibo->ebo", xs, w, tf32)        # [E, B, d]
    coef = layer[f"C_{direction}"][rel]                    # [E, B]
    return product("eb,ebo->eo", coef, per_basis, tf32)


def layer_forward(x: torch.Tensor, layer: dict, graph: Graph, spec: Spec,
                  relu: bool, keep_mask, tf32: bool,
                  edge_chunk: int) -> torch.Tensor:
    """One layer: both directions summed into their targets with 1/degree
    weights, plus the self-loop (with dropout where ``keep_mask`` is
    given), then a ReLU where asked."""
    out = x.new_zeros(x.shape[0], spec.d)
    for direction, src, dst in (("forward", graph.src, graph.dst),
                                ("backward", graph.dst, graph.src)):
        w = graph.norm(dst)
        for start in range(0, src.shape[0], edge_chunk):
            sl = slice(start, start + edge_chunk)
            msg = messages(x, layer, direction, src[sl], graph.rel[sl], spec,
                           tf32)
            out = out.index_add(0, dst[sl], msg * w[sl, None])
    self_loop = product("vi,io->vo", x, layer["W_self"], tf32)
    if keep_mask is not None:
        self_loop = torch.where(keep_mask, self_loop / spec.keep,
                                torch.zeros_like(self_loop))
    out = out + self_loop
    return torch.relu(out) if relu else out


def encode(params: dict, graph: Graph, spec: Spec, keep_masks=None,
           tf32: bool = False, edge_chunk: int = 1 << 30) -> torch.Tensor:
    """All-entity codes [V, d]: the input transform, then the layers
    (train mode where ``keep_masks`` holds one mask a layer)."""
    it = params["input_transform"]
    x = torch.relu(it["W"] + it["b"])
    for i, layer in enumerate(params["gcn_layers"]):
        x = layer_forward(x, layer, graph, spec, relu=i < spec.n_layers - 1,
                          keep_mask=None if keep_masks is None
                          else keep_masks[i], tf32=tf32,
                          edge_chunk=edge_chunk)
    return x


# ---------------------------------------------------------------------------
# The objective and the update
# ---------------------------------------------------------------------------

def binomial_loss(codes: torch.Tensor, rel_codes: torch.Tensor,
                  positives: torch.Tensor, neg_values: torch.Tensor,
                  corrupt_object: torch.Tensor, spec: Spec,
                  tf32: bool = False) -> torch.Tensor:
    """The tiled objective: each positive, then corruption j of positive i
    (its object replaced by ``neg_values[i, j]`` where
    ``corrupt_object[i, j]``, else its subject), mean sigmoid CE with
    labels 1 and 0, plus ``reg`` times the mean square of every scored
    triple's three codes."""
    p = positives.long()
    n, rate = neg_values.shape
    s = p[:, 0:1].expand(n, rate)
    o = p[:, 2:3].expand(n, rate)
    v = neg_values.long()
    neg_s = torch.where(corrupt_object, s, v).reshape(-1)
    neg_o = torch.where(corrupt_object, v, o).reshape(-1)
    neg_r = p[:, 1:2].expand(n, rate).reshape(-1)
    subj = torch.cat([p[:, 0], neg_s])
    rel = torch.cat([p[:, 1], neg_r])
    obj = torch.cat([p[:, 2], neg_o])
    e1, r, e2 = codes[subj], rel_codes[rel], codes[obj]
    energies = product("nd,nd->n", e1 * r, e2, tf32)
    labels = torch.cat([energies.new_ones(n), energies.new_zeros(n * rate)])
    ce = torch.clamp(energies, min=0.0) - energies * labels \
        + torch.log1p(torch.exp(-energies.abs()))
    squares = (e1 * e1).sum() + (r * r).sum() + (e2 * e2).sum()
    return ce.mean() + spec.reg * squares / (e1.shape[0] * spec.d)


def leaves(tree, prefix: str = "") -> dict:
    """{path: tensor} of a nested dict / list tree."""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(leaves(tree[k], f"{prefix}{k}/"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(leaves(v, f"{prefix}{i}/"))
        return out
    return {prefix.rstrip("/"): tree}


def rebuild(tree, flat: dict, prefix: str = ""):
    """``tree``'s structure with the leaves of ``flat``."""
    if isinstance(tree, dict):
        return {k: rebuild(tree[k], flat, f"{prefix}{k}/") for k in tree}
    if isinstance(tree, (list, tuple)):
        return [rebuild(v, flat, f"{prefix}{i}/") for i, v in enumerate(tree)]
    return flat[prefix.rstrip("/")]


def train_steps(params0, steps: list, spec: Spec, n_vertices: int,
                tf32: bool = False, state=None) -> dict:
    """The training steps from ``params0`` (left unchanged), one a dict of
    ``steps``: ``edges`` (the message edges' [E, 3] triples), ``positives``
    [n, 3], ``neg_values`` / ``corrupt_object`` [n, rate] and
    ``keep_masks``; Adam starts from ``state`` (``mu`` and ``nu`` trees
    shaped as the params, and ``count`` steps taken), or from nothing.
    Returns each step's ``losses``, the first step's clipped gradient
    (``first_grads``, by leaf) and the params after the last step
    (``params``, by leaf)."""
    flat = {k: v.detach().clone() for k, v in leaves(params0).items()}
    if state is None:
        mu = {k: torch.zeros_like(v) for k, v in flat.items()}
        nu = {k: torch.zeros_like(v) for k, v in flat.items()}
        taken = 0
    else:
        mu = {k: v.clone() for k, v in leaves(state["mu"]).items()}
        nu = {k: v.clone() for k, v in leaves(state["nu"]).items()}
        taken = int(state["count"])
    losses, first = [], None
    for t, step in enumerate(steps, start=taken + 1):
        for v in flat.values():
            v.requires_grad_(True)
        tree = rebuild(params0, flat)
        codes = encode(tree, graph_of(step["edges"], n_vertices), spec,
                       step["keep_masks"], tf32)
        loss = binomial_loss(codes, tree["relation_embedding"]["W_relation"],
                             step["positives"], step["neg_values"],
                             step["corrupt_object"], spec, tf32)
        keys = list(flat)
        grads = torch.autograd.grad(loss, [flat[k] for k in keys],
                                    allow_unused=True)
        grads = {k: torch.zeros_like(flat[k]) if g is None else g
                 for k, g in zip(keys, grads)}
        losses.append(float(loss.detach()))
        with torch.no_grad():
            norm = torch.sqrt(sum((g * g).sum() for g in grads.values()))
            if norm >= spec.max_norm:
                grads = {k: g / norm * spec.max_norm
                         for k, g in grads.items()}
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
            "params": {k: v.detach() for k, v in flat.items()}}
