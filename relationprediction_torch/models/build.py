"""Model assembly: config -> encoder/decoder over a dictionary of parameters.

Counterpart of ``relationprediction_tpu/models/build.py`` for every
encoder configuration the JAX package accepts: the embedding table
(``distmult.exp``, ``complex.exp``) and the variational one, and the
R-GCN (``gcn_block.exp``, ``gcn_basis.exp``, gcn_diag, the variational
R-GCN) with every layer variant, input stage (input transform, one-hot,
random or partially random input), skip connection (highway, residual)
and the output transform; the stored-message variant with its cache state
(``encode_stateful``, ``loss_stateful``). Each with the DistMult, ComplEx
or MLP decoder, encoded in test mode and scored against all entities, or
encoded in train mode and scored by one of the training objectives: the
tiled loss (``loss``), the factored binomial loss, the split protocol's
``loss_structured`` or the shared pool's ``loss_shared_negatives``, each
with the variational encoders' KL term. bf16 ``message_precision`` runs
the aggregation ops' bf16 kernels (JAX's ``agg_dtype``, ``build.py:390-401``)
in every encode but the stored variant's train-mode one; bf16
``stream_precision`` casts the codes of the four training losses to bf16
(``_stream_cast``, ``build.py:426-432``), and evaluation scores in f32.
Parameters are a plain dictionary of tensors with the JAX package's tree
layout (params.py converts between the two).

``CompGCNModel`` is the port's own model, with no counterpart in the JAX
package: CompGCN (corr) with a ConvE scorer, trained 1-N (``loss_kvsall``)
on the whole train graph (``graph.CompGCNGraph``).
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..config import CompGCNRunConfig, RunConfig
from ..device import exact_float32
from ..graph import (CompGCNGraph, GraphBatch, build_compgcn_graph,
                     build_graph_batch)
from ..observability import span
from ..ops.gather import take_rows
from ..ops.neg_energy import (factored_negative_energies,
                              single_factor_negative_energies)
from ..parallel.collectives import all_gather_rows, all_reduce_sum
from ..parallel.mesh import EdgeMesh
from ..params import map_tree
from . import decoders as decoders_lib
from . import encoders as enc
from . import initializers as init


def binomial_factored_objective(decoder, pos_energy, neg_energy, ev_sq,
                                e1, r, e2, pos_mask, corrupt_object,
                                group=None):
    """CE + regularization of the factored binomial protocol
    (``build.py:30-84``): the exact objective of the reference's tiled
    batch (``auxilliaries.py:13-33`` + ``bilinear_diag.py``).

    pos_energy [n]; neg_energy / ev_sq / corrupt_object [n, rate];
    e1 / r / e2 [n, d] positive codes; pos_mask [n]. With ``group`` (an
    edge mesh's process group, the rows this rank's) every sum is
    all-reduced, so the ranks' rows give the global objective.
    """
    rate = neg_energy.shape[1]
    n = pos_energy.shape[0]
    energies = torch.cat([pos_energy, neg_energy.reshape(-1)])
    labels = torch.cat([pos_mask, pos_mask.new_zeros(n * rate)])
    # neg_energy is positive-major ([n, rate] flattened), so the mask
    # repeats per positive; the CE mean does not depend on the order.
    mask = torch.cat([pos_mask, pos_mask.repeat_interleave(rate)])
    loss = decoders_lib.weighted_ce_loss(energies, labels, mask, group)

    # Regularization means over the equivalent tiled rows
    # (``bilinear_diag.py:63-69``): positive i's e1 survives in its
    # positive row and its object-corrupted rows, e2 in its positive and
    # subject-corrupted rows, r in all rate+1 rows; each corrupted
    # entity's code appears once.
    m = pos_mask
    co = corrupt_object.to(torch.float32) * m[:, None]
    n_obj = co.sum(1)
    n_subj = m * rate - n_obj
    # Squares in f32 on bf16 streams too (``build.py:66-72``).
    e1_sq = ((e1.float() ** 2).sum(-1) * m * (1.0 + n_obj)).sum() \
        + (ev_sq * (m[:, None] - co)).sum()
    e2_sq = ((e2.float() ** 2).sum(-1) * m * (1.0 + n_subj)).sum() \
        + (ev_sq * co).sum()
    r_sq = ((r.float() ** 2).sum(-1) * m).sum() * (rate + 1)
    live = m.sum()
    if group is not None:
        e1_sq, e2_sq, r_sq, live = all_reduce_sum(
            torch.stack([e1_sq, e2_sq, r_sq, live]), group)
    # Clamped after the sum over ranks: a rank whose rows are all padding
    # adds nothing (``build.py:79-81``).
    count = live.clamp(min=1.0) * (rate + 1) * e1.shape[-1]
    reg = (e1_sq + e2_sq + r_sq) / count
    return loss + decoder.regularization_parameter * reg


class EncodeResult(NamedTuple):
    entity_codes: torch.Tensor    # [V, d]
    relation_codes: torch.Tensor  # [R, d]
    # The variational encoders' pre-noise statistics (the KL term's
    # inputs), else None.
    mu: Optional[torch.Tensor] = None
    log_sigma: Optional[torch.Tensor] = None


class EncoderNoise(NamedTuple):
    """An encode's random draws besides the dropout keep-masks, each None
    where the configuration does not use it: the random input, U(-1, 1)
    [V, internal_dimension] (random and partially random input); the
    dropover choice, U(-1, 1) of the same shape (partially random input,
    train mode); the variational noise, N(0, 1) [V, code_dimension]."""
    random_input: Optional[torch.Tensor] = None
    dropover: Optional[torch.Tensor] = None
    eps: Optional[torch.Tensor] = None

    def to(self, device) -> "EncoderNoise":
        return EncoderNoise(*(None if t is None else t.to(device)
                              for t in self))


ENCODERS = ("embedding", "variational_embedding", "gcn_basis", "gcn_diag",
            "variational_gcn_basis")
# The seed of the test-mode noise: the JAX package encodes in test mode
# with PRNGKey(0) at every call (``build.py:346-347``).
TEST_NOISE_SEED = 0


def _check_supported(config: RunConfig) -> None:
    """Raise ValueError for an unknown encoder or skip connection."""
    e = config.encoder
    if e.name not in ENCODERS:
        raise ValueError(f"unknown encoder {e.name!r}")
    if e.skip_connections not in ("None", "Highway", "Residual"):
        raise ValueError(f"unknown skip connection {e.skip_connections!r}")


def precision_dtype(precision: str) -> Optional[torch.dtype]:
    """torch.bfloat16 for "bfloat16" or "bf16", else None (float32), as the
    JAX package reads ``message_precision`` and ``stream_precision``
    (``build.py:117-118``, ``:390-391``)."""
    return torch.bfloat16 if precision in ("bfloat16", "bf16") else None


class RGCNModel:
    """Encoder/decoder pair on one device."""

    def __init__(self, config: RunConfig, device: torch.device):
        if config.entity_count <= 0:
            raise ValueError("config must carry dataset counts; call "
                             "config.with_counts(...) first")
        _check_supported(config)
        self.config = config
        self.device = torch.device(device)
        self.n_entities = config.entity_count
        self.n_relations = config.relation_count
        e = config.encoder
        # The embedding encoders are entity tables with no graph
        # (``build.py:141-148``, ``:350-362``).
        self.is_gcn = e.name in ("gcn_basis", "gcn_diag",
                                 "variational_gcn_basis")
        self.variational = e.name in ("variational_embedding",
                                      "variational_gcn_basis")
        # gcn_diag always builds an input transform (``build.py:125-130``);
        # random and partially random input feed dense codes too; with
        # none of them the first layer takes one-hot input.
        self.has_input_transform = self.is_gcn and (
            e.name == "gcn_diag" or e.use_input_transform)
        self.random_input = self.is_gcn and not self.has_input_transform \
            and e.random_input
        self.partially_random_input = self.is_gcn \
            and not self.has_input_transform and not e.random_input \
            and e.partially_random_input
        self.first_layer_onehot = self.is_gcn and not (
            self.has_input_transform or self.random_input
            or self.partially_random_input)
        # ``EncoderConfig.gcn_variant`` alone says "basis" for gcn_diag
        # (``build.py:158``, ``:388``).
        self.variant = "diag" if e.name == "gcn_diag" else e.gcn_variant
        # The stored-message variant carries per-edge caches through the
        # train steps (``build.py:198-204``).
        self.has_state = self.is_gcn and self.variant == "basis_stored"
        # The fused kernels (TPU kernels 1-2) serve block and basis layers
        # on dense input: after an input transform, and after random or
        # partially random input too, where the JAX package takes its v1
        # layouts only because its ``preferred_staircase2`` keys on the
        # input transform (``build.py:270-278``); the function is the
        # same. Every other layer sums per-edge messages with TPU kernel
        # 3.
        self.preferred_staircase2 = self.is_gcn \
            and not self.first_layer_onehot \
            and self.variant in ("block", "basis")
        # bf16 message precision: the aggregation kernels' input dtype
        # (None: float32); bf16 stream precision: the dtype the training
        # losses cast the codes to (``build.py:113-118``).
        self.agg_dtype = precision_dtype(e.message_precision)
        self.stream_dtype = precision_dtype(config.decoder.stream_precision)
        self.decoder = decoders_lib.build_decoder(
            config.decoder.name,
            code_dimension=config.decoder.code_dimension,
            regularization_parameter=config.decoder.regularization_parameter,
            decoder_dimension=config.decoder.decoder_dimension,
            embedding_width=config.decoder.embedding_width)

    # ------------------------------------------------------------------
    # Parameters and graph
    # ------------------------------------------------------------------
    def init_params(self, generator: torch.Generator) -> Dict:
        """Random parameters drawn from ``generator`` (``build.py:135-190``),
        moved to the model's device. ``highways`` holds one gate a layer,
        None for a layer on one-hot input, and is left out where no layer
        has one."""
        e = self.config.encoder
        d_int, d_code = e.internal_dimension, e.code_dimension
        params: Dict = {}
        if e.name == "embedding":
            params["embedding"] = enc.init_affine(
                generator, (self.n_entities, d_code), use_bias=False)
        elif e.name == "variational_embedding":
            for key in ("mu_embedding", "sigma_embedding"):
                params[key] = enc.init_affine(
                    generator, (self.n_entities, d_code), use_bias=False)
        else:
            if self.has_input_transform or self.partially_random_input:
                params["input_transform"] = enc.init_affine(
                    generator, (self.n_entities, d_int), use_bias=True)
            layers, highways = [], []
            for layer in range(e.n_layers):
                onehot = self.first_layer_onehot and layer == 0
                layers.append(enc.init_gcn_layer(
                    generator, self.variant, n_relations=self.n_relations,
                    d_in=d_int, d_out=d_int, n_bases=e.n_bases,
                    onehot_dim=self.n_entities if onehot else None))
                highways.append(
                    enc.init_highway(generator, (d_int, d_int))
                    if e.skip_connections == "Highway" and not onehot
                    else None)
            params["gcn_layers"] = layers
            if any(h is not None for h in highways):
                params["highways"] = highways
            if e.name == "variational_gcn_basis":
                for key in ("mu_projection", "sigma_projection"):
                    params[key] = enc.init_affine(generator, (d_int, d_code),
                                                  use_bias=True)
            if e.use_output_transform:
                params["output_transform"] = enc.init_affine(
                    generator, (d_int, d_code), use_bias=True)
        params["relation_embedding"] = enc.init_relation_embedding(
            generator, self.n_relations, d_code)
        params["decoder"] = self.decoder.init(generator)
        return map_tree(lambda t: t.to(self.device), params)

    def needs_graph(self) -> bool:
        """Whether the encoder passes messages over a graph
        (``build.py:195``)."""
        return self.is_gcn

    def make_graph(self, triples: np.ndarray, to_device: bool = True,
                   shard: tuple = (0, 1)) -> Optional[GraphBatch]:
        """The message graph of ``triples`` with its CSR layouts, on the
        model's device, or left on the host (``to_device`` false); None
        for a model without a graph (``build.py:280-322``). ``shard``
        (rank, n): that rank's block of the edges, weighted over all of
        them (``graph.build_graph_batch``), for an edge-partitioned
        encode."""
        if not self.is_gcn:
            return None
        graph = build_graph_batch(triples, self.n_entities, self.n_relations,
                                  shard=shard)
        return graph.to(self.device) if to_device else graph

    # ------------------------------------------------------------------
    # Encoding and scoring
    # ------------------------------------------------------------------
    def encode(self, params: Dict, graph: Optional[GraphBatch], *,
               deterministic: bool,
               generator: Optional[torch.Generator] = None,
               keep_masks: Optional[Sequence[torch.Tensor]] = None,
               noise: Optional[EncoderNoise] = None,
               group=None) -> EncodeResult:
        """All-entity codes [V, d] and relation codes [R, d]
        (``build.py:335-421``): the input stage (input transform, random
        input, partially random input, or one-hot), the layers, each
        after the first dense one wrapped by its highway gate or residual,
        then the variational stage and the output transform.

        Train mode (``deterministic`` false) drops self-loop messages with
        one keep-mask per layer: ``keep_masks[layer]`` [V, d] bool where
        given, else drawn from ``generator``. ``noise`` holds the other
        draws (``draw_noise``); where it is None they are drawn from
        ``generator`` in train mode and, in test mode, from a CPU
        generator seeded ``TEST_NOISE_SEED`` at every encode, so each
        test-mode encode sees the same noise on every device, as the JAX
        package's does.

        ``group``: an edge mesh's process group, ``graph`` this rank's
        shard (``make_graph(shard=...)``): each layer all-reduces its
        partial sums, and every rank gets the whole graph's codes.
        """
        with span("model.encode"):
            e = self.config.encoder
            if noise is None:
                noise = self.draw_noise(
                    torch.Generator().manual_seed(TEST_NOISE_SEED)
                    if deterministic else generator, deterministic
                ).to(self.device)
            rel = params["relation_embedding"]["W_relation"]
            if e.name == "embedding":
                return EncodeResult(params["embedding"]["W"], rel)
            if e.name == "variational_embedding":
                mu = params["mu_embedding"]["W"]
                log_sigma = params["sigma_embedding"]["W"]
                return EncodeResult(enc.apply_variational(noise.eps, mu,
                                                          log_sigma),
                                    rel, mu, log_sigma)

            # -- input stage -----------------------------------------------
            if self.has_input_transform:
                features = enc.apply_affine(params["input_transform"], None,
                                            onehot_input=True, use_bias=True,
                                            use_nonlinearity=True)
            elif self.random_input:
                features = noise.random_input
            elif self.partially_random_input:
                # the affine map without its ReLU (``build.py:377-379``)
                c1 = enc.apply_affine(params["input_transform"], None,
                                      onehot_input=True, use_bias=True)
                features = enc.apply_dropover(noise.dropover, c1,
                                              noise.random_input,
                                              deterministic)
            else:
                features = None  # one-hot input to the first layer

            # -- message-passing layers ------------------------------------
            highways = params.get("highways")
            for layer_idx, layer_params in enumerate(params["gcn_layers"]):
                new = enc.apply_gcn_layer(
                    layer_params, self.variant, graph, features,
                    fused=self.preferred_staircase2,
                    use_nonlinearity=layer_idx < e.n_layers - 1,
                    dropout_keep=e.dropout_keep_probability,
                    deterministic=deterministic, generator=generator,
                    n_vertices=self.n_entities,
                    keep_mask=None if keep_masks is None
                    else keep_masks[layer_idx], agg_dtype=self.agg_dtype,
                    group=group)
                if features is not None \
                        and e.skip_connections == "Highway":
                    new = enc.apply_highway(highways[layer_idx], new,
                                            features)
                elif features is not None \
                        and e.skip_connections == "Residual":
                    new = enc.apply_residual(new, features)
                features = new

            # -- variational stage and output transform --------------------
            mu = log_sigma = None
            if e.name == "variational_gcn_basis":
                mu = enc.apply_affine(params["mu_projection"], features)
                log_sigma = enc.apply_affine(params["sigma_projection"],
                                             features)
                features = enc.apply_variational(noise.eps, mu, log_sigma)
            if e.use_output_transform:
                features = enc.apply_affine(params["output_transform"],
                                            features)
            return EncodeResult(features, rel, mu, log_sigma)

    def draw_keep_masks(self, generator: torch.Generator) -> list:
        """One train-mode dropout keep-mask [V, d] per layer, drawn on the
        generator's device; none for the embedding encoders."""
        e = self.config.encoder
        if not self.is_gcn:
            return []
        return [enc.draw_keep_mask((self.n_entities, e.internal_dimension),
                                   e.dropout_keep_probability, generator)
                for _ in range(e.n_layers)]

    def draw_noise(self, generator: Optional[torch.Generator],
                   deterministic: bool = False) -> EncoderNoise:
        """The encode's other draws (``EncoderNoise``), in this order and
        only those the configuration uses: the random input, the dropover
        choice (train mode only), the variational noise. Draws nothing for
        any other configuration; raises ValueError where a draw is needed
        and ``generator`` is None."""
        e = self.config.encoder
        random_in = self.random_input or self.partially_random_input
        dropover = self.partially_random_input and not deterministic
        if not (random_in or dropover or self.variational):
            return EncoderNoise()
        if generator is None:
            raise ValueError(f"the {e.name} encoder's random draws need a "
                             f"noise tuple or a torch.Generator")
        v, d = self.n_entities, e.internal_dimension

        def uniform():
            return enc.random_embedding(generator, v, d)
        return EncoderNoise(
            random_input=uniform() if random_in else None,
            dropover=uniform() if dropover else None,
            eps=torch.randn((v, e.code_dimension), generator=generator,
                            device=generator.device)
            if self.variational else None)

    def plus_kl(self, loss: torch.Tensor,
                encoded: EncodeResult) -> torch.Tensor:
        """``loss`` plus the variational encoders' KL penalty, which every
        training loss adds (``build.py:463-465``); ``loss`` itself for any
        other encoder."""
        if not self.variational:
            return loss
        return loss + enc.variational_kl_penalty(encoded.mu,
                                                 encoded.log_sigma)

    # ------------------------------------------------------------------
    # The stored-message variant (``build.py:198-258``)
    # ------------------------------------------------------------------
    def init_cache_state(self) -> list:
        """Zero stored-message caches, one dict a layer, on the model's
        device (``gcn_basis_stored.py:33-35``)."""
        e = self.config.encoder
        return [enc.init_stored_state(self.config.edge_count,
                                      self.n_entities, e.internal_dimension,
                                      self.device)
                for _ in range(e.n_layers)]

    def encode_stateful(self, params: Dict, state: list, graph: GraphBatch,
                        edge_ids: torch.Tensor, *,
                        generator: Optional[torch.Generator] = None,
                        keep_masks: Optional[Sequence[torch.Tensor]] = None
                        ) -> Tuple[EncodeResult, list]:
        """Train-mode encode of the stored-message variant: as ``encode``,
        but each layer takes and returns its cache state
        (``enc.apply_gcn_layer_stored``; ``edge_ids``: the graph's input
        edges' ids into the train set). As in the JAX package, the input
        stage is the input transform or one-hot input, and the output
        transform follows the layers."""
        if not self.has_state:
            raise ValueError("encode_stateful is for the stored-message "
                             "variant (StoreEdgeData=Yes)")
        e = self.config.encoder
        features = None
        if e.use_input_transform:
            features = enc.apply_affine(params["input_transform"], None,
                                        onehot_input=True, use_bias=True,
                                        use_nonlinearity=True)
        new_state = []
        for layer_idx, layer_params in enumerate(params["gcn_layers"]):
            features, st = enc.apply_gcn_layer_stored(
                layer_params, state[layer_idx], graph, features, edge_ids,
                use_nonlinearity=layer_idx < e.n_layers - 1,
                dropout_keep=e.dropout_keep_probability,
                deterministic=False, generator=generator,
                n_vertices=self.n_entities,
                keep_mask=None if keep_masks is None
                else keep_masks[layer_idx])
            new_state.append(st)
        if e.use_output_transform:
            features = enc.apply_affine(params["output_transform"], features)
        rel = params["relation_embedding"]["W_relation"]
        return EncodeResult(features, rel), new_state

    def loss_stateful(self, params: Dict, state: list, graph: GraphBatch,
                      edge_ids: torch.Tensor, triples: torch.Tensor,
                      labels: torch.Tensor,
                      mask: Optional[torch.Tensor] = None, *,
                      generator: Optional[torch.Generator] = None,
                      keep_masks: Optional[Sequence] = None
                      ) -> Tuple[torch.Tensor, list]:
        """The tiled objective of the stored variant on a host-tiled batch;
        returns (loss, new state). The new caches carry no gradient."""
        encoded, new_state = self.encode_stateful(
            params, state, graph, edge_ids, generator=generator,
            keep_masks=keep_masks)
        e1, r, e2 = self.gather_codes(encoded, triples)
        dp = params["decoder"]
        energies = self.decoder.energies(dp, e1, r, e2)
        return (decoders_lib.weighted_ce_loss(energies, labels, mask)
                + self.decoder.regularization(dp, e1, r, e2, mask)), \
            new_state

    # ------------------------------------------------------------------
    # Training loss
    # ------------------------------------------------------------------
    @staticmethod
    def gather_codes(encoded: EncodeResult, triples: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(e1, r, e2) code gather (``build.py:434-440``), each by
        ``take_rows`` (a gradient summed by id in a fixed order)."""
        t = triples.long()
        return (take_rows(encoded.entity_codes, t[:, 0]),
                take_rows(encoded.relation_codes, t[:, 1]),
                take_rows(encoded.entity_codes, t[:, 2]))

    def stream_cast(self, encoded: EncodeResult) -> EncodeResult:
        """The codes in the decoder stream's dtype, for the training losses
        only (``_stream_cast``, ``build.py:426-432``): entity and relation
        codes cast to bf16 on a bf16 stream, the variational statistics as
        they are; ``encoded`` itself on a float32 stream."""
        if self.stream_dtype is None:
            return encoded
        return encoded._replace(
            entity_codes=encoded.entity_codes.to(self.stream_dtype),
            relation_codes=encoded.relation_codes.to(self.stream_dtype))

    def loss(self, params: Dict, graph: Optional[GraphBatch],
             triples: torch.Tensor, labels: torch.Tensor,
             mask: Optional[torch.Tensor] = None, *,
             deterministic: bool = False,
             keep_masks: Optional[Sequence] = None,
             noise: Optional[EncoderNoise] = None,
             group=None) -> torch.Tensor:
        """The tiled objective (``build.py:442-466``): mean sigmoid CE over
        the triples plus the decoder's regularization, for any decoder,
        plus the KL term of a variational encoder.

        triples [N, 3] (positives and their corruptions, host-tiled or from
        ``device_negative_sample``); labels / mask [N] float32. ``group``:
        an edge mesh's process group, ``graph`` and the rows this rank's
        shards; the means are over every rank's rows (``masked_mean``)."""
        encoded = self.encode(params, graph, deterministic=deterministic,
                              keep_masks=keep_masks, noise=noise,
                              group=group)
        e1, r, e2 = self.gather_codes(self.stream_cast(encoded), triples)
        dp = params["decoder"]
        energies = self.decoder.energies(dp, e1, r, e2)
        return self.plus_kl(
            decoders_lib.weighted_ce_loss(energies, labels, mask, group)
            + self.decoder.regularization(dp, e1, r, e2, mask, group),
            encoded)

    def _factorizable_codes(self, params, graph, positives, what,
                            deterministic, keep_masks, noise, group):
        """(encoded, e1, r, e2, positive energies, q_subj, q_obj) of a loss
        that scores corruptions against one factor a positive; ``encoded``
        in the decoder stream's dtype (its variational statistics f32)."""
        if not getattr(self.decoder, "factorizable", False):
            raise ValueError(f"decoder {self.decoder.name} does not support "
                             f"the {what} loss")
        encoded = self.stream_cast(self.encode(
            params, graph, deterministic=deterministic,
            keep_masks=keep_masks, noise=noise, group=group))
        e1, r, e2 = self.gather_codes(encoded, positives)
        dp = params["decoder"]
        return (encoded, e1, r, e2,
                self.decoder.energies(dp, e1, r, e2),
                self.decoder.subject_factor(dp, r, e2),
                self.decoder.object_factor(dp, e1, r))

    def _grouped_objective(self, pos_energy, groups, e1, r, e2, pos_mask,
                           corrupted_sq, pool_sq, rows_e1, rows_e2, group):
        """CE + regularization of a positive and its corruption groups.

        groups: [n, k_g] energies of each group (all labelled 0); the CE
        mask repeats each positive's mask over its own k_g entries. The
        regularization means run over the equivalent tiled rows: e1 and e2
        appear ``rows_e1`` / ``rows_e2`` times a positive, r in every row,
        plus the corrupted codes' squares: ``corrupted_sq`` summed over
        this batch's rows, and ``pool_sq`` (the shared pool's, the same on
        every rank) once a real positive. ``group``: the sums over the
        rows and the count of real positives are all-reduced
        (``masked_mean``).

        The JAX package tiles the mask over [n, k] energies flattened
        positive-major (``build.py:584-585``, ``:659``), which pairs them
        with the wrong positives where the batch has padding; it is right
        only where every mask entry is 1. Here each group's mask follows
        its own positive."""
        m = pos_mask
        energies = torch.cat([pos_energy]
                             + [g.reshape(-1) for g in groups])
        labels = torch.cat([m, m.new_zeros(sum(g.numel() for g in groups))])
        mask = torch.cat([m] + [m.repeat_interleave(g.shape[1])
                                for g in groups])
        loss = decoders_lib.weighted_ce_loss(energies, labels, mask, group)
        rows = 1 + sum(g.shape[1] for g in groups)

        def msum(x):
            return ((x ** 2).sum(-1) * m).sum()
        total = msum(e1) * rows_e1 + msum(e2) * rows_e2 + msum(r) * rows \
            + corrupted_sq
        live = m.sum()
        if group is not None:
            total, live = all_reduce_sum(torch.stack([total, live]), group)
        live = live.clamp(min=1.0)
        reg = (total + pool_sq * live) / (live * rows * e1.shape[-1])
        return loss + self.decoder.regularization_parameter * reg

    def loss_structured(self, params: Dict, graph: Optional[GraphBatch],
                        positives: torch.Tensor, pos_mask: torch.Tensor,
                        neg_subjects: torch.Tensor,
                        neg_objects: torch.Tensor, *,
                        deterministic: bool = False,
                        keep_masks: Optional[Sequence] = None,
                        noise: Optional[EncoderNoise] = None,
                        group=None) -> torch.Tensor:
        """The split protocol's loss (``build.py:530-613``): the tiled
        objective over [positives; subject corruptions; object
        corruptions], each corruption scored against one factor of its
        positive (``single_factor_negative_energies``).

        positives [n, 3]; pos_mask [n]; neg_subjects [n, k_s] and
        neg_objects [n, k_o] corrupted entity ids
        (``device_negative_entities_split``). Raises ValueError for a
        decoder that is not factorizable."""
        encoded, e1, r, e2, pos_energy, q_subj, q_obj = \
            self._factorizable_codes(params, graph, positives, "split",
                                     deterministic, keep_masks, noise, group)
        codes = encoded.entity_codes
        subj_energy, e1n_sq = single_factor_negative_energies(
            codes, q_subj, neg_subjects)
        obj_energy, e2n_sq = single_factor_negative_energies(
            codes, q_obj, neg_objects)
        m = pos_mask[:, None]
        # e1 survives in the positive and the object corruptions, e2 in
        # the positive and the subject corruptions; corrupted codes once.
        return self.plus_kl(self._grouped_objective(
            pos_energy, (subj_energy, obj_energy), e1, r, e2, pos_mask,
            (e1n_sq * m).sum() + (e2n_sq * m).sum(), 0.0,
            1 + obj_energy.shape[1], 1 + subj_energy.shape[1], group),
            encoded)

    def loss_shared_negatives(self, params: Dict,
                              graph: Optional[GraphBatch],
                              positives: torch.Tensor,
                              pos_mask: torch.Tensor,
                              neg_pool: torch.Tensor, *,
                              deterministic: bool = False,
                              keep_masks: Optional[Sequence] = None,
                              noise: Optional[EncoderNoise] = None,
                              group=None) -> torch.Tensor:
        """The shared pool's loss (``build.py:615-689``): every positive
        scores against one pool of P entities as corrupted subjects and as
        corrupted objects, two [n, d] x [d, P] GEMMs; each positive gives
        one positive row and 2P negative rows to the CE mean (a different
        negative distribution from the reference's, not a parity mode).

        neg_pool [P] entity ids (``device_negative_pool``). Raises
        ValueError for a decoder that is not factorizable."""
        encoded, e1, r, e2, pos_energy, q_subj, q_obj = \
            self._factorizable_codes(params, graph, positives, "shared",
                                     deterministic, keep_masks, noise, group)
        exact_float32()
        pool = take_rows(encoded.entity_codes, neg_pool)       # [P, d]
        p = pool.shape[0]
        # JAX's dot of bf16 streams accumulates in f32
        # (``preferred_element_type``, ``build.py:649-652``); torch's bf16
        # matmul would round the product to bf16, so the GEMMs take the
        # streams upcast (exact) and multiply in f32.
        pool_t = pool.float().T
        # Pool codes count once per real positive and side.
        return self.plus_kl(self._grouped_objective(
            pos_energy, (q_subj.float() @ pool_t, q_obj.float() @ pool_t),
            e1, r, e2, pos_mask, 0.0, 2 * (pool ** 2).sum(), 1 + p, 1 + p,
            group), encoded)

    def loss_binomial_factored(self, params: Dict, graph: GraphBatch,
                               positives: torch.Tensor,
                               pos_mask: torch.Tensor,
                               neg_values: torch.Tensor,
                               corrupt_object: torch.Tensor, *,
                               deterministic: bool = False,
                               keep_masks: Optional[Sequence] = None,
                               noise: Optional[EncoderNoise] = None,
                               group=None) -> torch.Tensor:
        """The reference's binomial-corruption objective without the
        (rate+1)-tiled batch (``build.py:468-528``): each negative shares
        two of its three codes with its positive, so the loss gathers the
        positives' codes, one factor per positive and side, and the
        corrupted entities' codes.

        positives [n, 3]; pos_mask [n] float32; neg_values [n, rate]
        corrupted entity ids; corrupt_object [n, rate] bool (True: the
        object slot is replaced). In train mode ``keep_masks`` holds one
        dropout keep-mask per layer (``draw_keep_masks``). Raises
        ValueError for a decoder that is not factorizable.
        """
        encoded, e1, r, e2, pos_energy, q_subj, q_obj = \
            self._factorizable_codes(params, graph, positives,
                                     "factored binomial", deterministic,
                                     keep_masks, noise, group)
        neg_energy, ev_sq = factored_negative_energies(
            encoded.entity_codes, q_subj, q_obj, neg_values, corrupt_object)
        return self.plus_kl(binomial_factored_objective(
            self.decoder, pos_energy, neg_energy, ev_sq, e1, r, e2,
            pos_mask, corrupt_object, group), encoded)

    def _triples(self, triples) -> torch.Tensor:
        return torch.as_tensor(np.asarray(triples), dtype=torch.long,
                               device=self.device).reshape(-1, 3)

    def score_encoded(self, params: Dict, encoded: EncodeResult, triples
                      ) -> torch.Tensor:
        """[N] sigmoid(energies) of given triples from encoded codes
        (``bilinear_diag.py:46-49``)."""
        t = self._triples(triples)
        return torch.sigmoid(self.decoder.energies(
            params["decoder"], encoded.entity_codes[t[:, 0]],
            encoded.relation_codes[t[:, 1]], encoded.entity_codes[t[:, 2]]))

    def score_all_subjects_encoded(self, params: Dict, encoded: EncodeResult,
                                   triples, apply_sigmoid: bool = True
                                   ) -> torch.Tensor:
        """[N, V] candidate-subject scores from encoded codes
        (``bilinear_diag.py:51-55``)."""
        t = self._triples(triples)
        r = encoded.relation_codes[t[:, 1]]
        e2 = encoded.entity_codes[t[:, 2]]
        energies = self.decoder.all_subject_energies(
            params["decoder"], encoded.entity_codes, r, e2)
        return torch.sigmoid(energies) if apply_sigmoid else energies

    def score_all_objects_encoded(self, params: Dict, encoded: EncodeResult,
                                  triples, apply_sigmoid: bool = True
                                  ) -> torch.Tensor:
        t = self._triples(triples)
        e1 = encoded.entity_codes[t[:, 0]]
        r = encoded.relation_codes[t[:, 1]]
        energies = self.decoder.all_object_energies(
            params["decoder"], encoded.entity_codes, e1, r)
        return torch.sigmoid(energies) if apply_sigmoid else energies

    def score(self, params: Dict, graph: GraphBatch, triples
              ) -> torch.Tensor:
        """sigmoid(energies) for given triples, test mode
        (``build.py:691-699``)."""
        encoded = self.encode(params, graph, deterministic=True)
        return self.score_encoded(params, encoded, triples)

    def score_all_subjects(self, params: Dict, graph: GraphBatch, triples,
                           apply_sigmoid: bool = True) -> torch.Tensor:
        encoded = self.encode(params, graph, deterministic=True)
        return self.score_all_subjects_encoded(params, encoded, triples,
                                               apply_sigmoid)

    def score_all_objects(self, params: Dict, graph: GraphBatch, triples,
                          apply_sigmoid: bool = True) -> torch.Tensor:
        encoded = self.encode(params, graph, deterministic=True)
        return self.score_all_objects_encoded(params, encoded, triples,
                                              apply_sigmoid)


class ModelView:
    """Encode-once scoring view, the counterpart of ``JittedModelView``
    (``build.py:720-869``).

    The test-mode codes are computed once per (params, graph) pair, compared
    by identity, and each chunk is then only the decoder GEMM. Presents the
    (params, graph, triples) surface of RGCNModel, so it can be handed to
    evaluation.Scorer. ``noise``: the encoder's test-mode draws
    (``EncoderNoise``), else the model's own fixed-seed draws.

    ``mesh`` (an ``EdgeMesh``; every rank calls each method in the same
    order): the encode runs edge-sharded on ``graph``, this rank's shard
    (``make_graph(shard=mesh.shard)``), with the training step's
    all-reduce; each rank scores its block of a chunk's rows (padded to a
    multiple of the mesh by the last row) against the whole entity table,
    and the blocks are gathered, so every rank returns the whole chunk's
    scores.
    """

    def __init__(self, model: RGCNModel,
                 noise: Optional[EncoderNoise] = None,
                 mesh: Optional[EdgeMesh] = None):
        self.model = model
        self.noise = noise
        self.mesh = mesh
        self._key = None
        self._encoded: Optional[EncodeResult] = None

    def invalidate(self) -> None:
        self._key = None
        self._encoded = None

    def encoded(self, params: Dict, graph: GraphBatch) -> EncodeResult:
        # The key holds strong references and compares with `is`: an
        # id()-keyed cache could hit a stale entry after a recycled id.
        if (self._key is None or self._key[0] is not params
                or self._key[1] is not graph):
            with torch.no_grad():
                self._encoded = self.model.encode(
                    params, graph, deterministic=True, noise=self.noise,
                    group=None if self.mesh is None or graph is None
                    else self.mesh.group)
            self._key = (params, graph)
        return self._encoded

    def _scored(self, fn, params, graph, triples, *extra) -> torch.Tensor:
        """``fn(params, codes, triples, *extra)``, over this rank's block of
        the rows on a mesh, gathered."""
        with torch.no_grad():
            encoded = self.encoded(params, graph)
            if self.mesh is None:
                return fn(params, encoded, triples, *extra)
            t = np.asarray(triples, dtype=np.int64).reshape(-1, 3)
            n, ranks = len(t), self.mesh.world_size
            pad = -(-n // ranks) * ranks
            if pad != n:
                t = np.concatenate([t, np.repeat(t[-1:], pad - n, axis=0)])
            per = pad // ranks
            mine = t[self.mesh.rank * per:(self.mesh.rank + 1) * per]
            return all_gather_rows(fn(params, encoded, mine, *extra),
                                   self.mesh.group)[:n]

    def score(self, params, graph, triples) -> torch.Tensor:
        return self._scored(self.model.score_encoded, params, graph, triples)

    def score_all_subjects(self, params, graph, triples,
                           apply_sigmoid: bool = True) -> torch.Tensor:
        return self._scored(self.model.score_all_subjects_encoded, params,
                            graph, triples, apply_sigmoid)

    def score_all_objects(self, params, graph, triples,
                          apply_sigmoid: bool = True) -> torch.Tensor:
        return self._scored(self.model.score_all_objects_encoded, params,
                            graph, triples, apply_sigmoid)


class CompGCNModel:
    """CompGCN (corr) with the ConvE scorer on one device: the official
    ``CompGCN_ConvE`` (github.com/malllabiisc/CompGCN) over a params tree.

    ``{"entity_embedding": {"W"} [V, d_in], "relation_embedding":
    {"W_relation"} [2R, d_in] (each relation and its inverse),
    "compgcn_layers": [layer] (``encoders.init_compgcn_layer``), "decoder"
    (``decoders.ConvE.init``)}``. The BatchNorms' running statistics are no
    params: ``batch_stats`` holds them on the device, a train-mode encode
    updates them in place and a test-mode one reads them, and checkpoints
    carry them beside the params. In training the entity codes go through
    dropout (``hidden_dropout``) before the scorer, which takes the subject's
    and the relation's codes; a query (s, r) for its object is scored as
    it is, one for its subject, (?, r, o), as (o, r + R, ?). The train
    step draws five keep-masks (``draw_keep_masks``): the layer's inward
    and outward sums [V, d], the codes [V, d], the filters' output and the
    scorer's map, the last two for the ``batch_size`` queries of a step."""

    objective = "kvsall"
    has_state = False
    is_gcn = True

    def __init__(self, config: CompGCNRunConfig, device: torch.device):
        if config.entity_count <= 0:
            raise ValueError("config must carry dataset counts; call "
                             "config.with_counts(...) first")
        self.config = config
        self.c = config.compgcn
        self.device = torch.device(device)
        self.n_entities = config.entity_count
        self.n_relations = config.relation_count
        self.decoder = decoders_lib.ConvE(self.c, self.n_entities)
        self.batch_stats = {
            "layers": [enc.init_batch_stats(self.c.gcn_dimension,
                                            self.device)],
            **self.decoder.init_stats(self.device)}

    def init_params(self, generator: torch.Generator) -> Dict:
        """Params drawn from ``generator`` at the official initialisation
        (``get_param``'s xavier normal; ``torch.nn``'s defaults in the
        scorer), on the model's device."""
        c, v, r2 = self.c, self.n_entities, 2 * self.n_relations
        params = {
            "entity_embedding": {"W": init.normal(
                generator, (v, c.init_dimension),
                enc.xavier_std(c.init_dimension, v))},
            "relation_embedding": {"W_relation": init.normal(
                generator, (r2, c.init_dimension),
                enc.xavier_std(c.init_dimension, r2))},
            "compgcn_layers": [enc.init_compgcn_layer(
                generator, c.init_dimension, c.gcn_dimension)],
            "decoder": self.decoder.init(generator)}
        return map_tree(lambda t: t.to(self.device), params)

    def needs_graph(self) -> bool:
        return True

    def make_graph(self, triples: np.ndarray, to_device: bool = True,
                   shard: tuple = (0, 1)) -> CompGCNGraph:
        """The whole graph of ``triples`` (``graph.build_compgcn_graph``);
        no shard other than the whole."""
        if tuple(shard) != (0, 1):
            raise ValueError("the compgcn encoder is not edge-partitioned")
        graph = build_compgcn_graph(triples, self.n_entities,
                                    self.n_relations)
        return graph.to(self.device) if to_device else graph

    def draw_keep_masks(self, generator: torch.Generator) -> list:
        c, v, n, d = (self.c, self.n_entities, self.c.batch_size,
                      self.c.gcn_dimension)
        shapes = (((v, d), c.layer_dropout), ((v, d), c.layer_dropout),
                  ((v, d), c.hidden_dropout),
                  ((n, c.n_filters, c.conv_height, c.conv_width),
                   c.feature_dropout),
                  ((n, d), c.decoder_dropout))
        return [enc.draw_keep_mask(shape, 1.0 - drop, generator)
                for shape, drop in shapes]

    def draw_noise(self, generator, deterministic: bool = False
                   ) -> EncoderNoise:
        return EncoderNoise()

    def encode(self, params: Dict, graph: CompGCNGraph, *,
               deterministic: bool,
               generator: Optional[torch.Generator] = None,
               keep_masks: Optional[Sequence[torch.Tensor]] = None,
               noise: Optional[EncoderNoise] = None,
               group=None) -> EncodeResult:
        """All-entity codes [V, d] and relation codes [2R, d]. Train mode
        (``deterministic`` false) takes the keep-masks of
        ``draw_keep_masks`` (drawn from ``generator`` where not given)
        and the entity codes' dropout; test mode none."""
        if group is not None:
            raise ValueError("the compgcn encoder runs on one device")
        with span("model.encode"):
            training = not deterministic
            if training and keep_masks is None:
                keep_masks = self.draw_keep_masks(generator)
            x = params["entity_embedding"]["W"]
            z = params["relation_embedding"]["W_relation"]
            for layer, stats in zip(params["compgcn_layers"],
                                    self.batch_stats["layers"]):
                x, z = enc.apply_compgcn_layer(
                    layer, graph, x, z, stats,
                    layer_dropout=self.c.layer_dropout, training=training,
                    keep_masks=keep_masks[:2] if training else None)
            if training:
                x = enc.dropped(x, keep_masks[2], self.c.hidden_dropout)
            return EncodeResult(x, z)

    def object_energies(self, params: Dict, encoded: EncodeResult,
                        subjects: torch.Tensor, relations: torch.Tensor,
                        keep_masks: Optional[Sequence] = None
                        ) -> torch.Tensor:
        """[n, V] energies of (subjects[i], relations[i], ?) against every
        entity; ``keep_masks`` (the scorer's two) in training."""
        with span("decode.conve"):
            dp = params["decoder"]
            hidden = self.decoder.hidden(
                dp, self.batch_stats,
                take_rows(encoded.entity_codes, subjects),
                take_rows(encoded.relation_codes, relations),
                training=keep_masks is not None, keep_masks=keep_masks)
            return self.decoder.all_object_energies(
                dp, encoded.entity_codes, hidden)

    def loss_kvsall(self, params: Dict, graph: CompGCNGraph,
                    queries: torch.Tensor, labels: torch.Tensor,
                    mask: torch.Tensor, *, deterministic: bool = False,
                    keep_masks: Optional[Sequence] = None,
                    noise: Optional[EncoderNoise] = None,
                    group=None) -> torch.Tensor:
        """The 1-N objective: queries [n, 3] (s, r, -) with r in [0, 2R),
        labels [n, V] bool (the entities that complete each query in the
        train graph), mask [n]; the mean binary cross-entropy of every
        entity's energy against its smoothed label (1 - eps) y + 1 / V, over
        the rows the mask keeps and every entity."""
        encoded = self.encode(params, graph, deterministic=deterministic,
                              keep_masks=keep_masks, group=group)
        q = queries.long()
        energies = self.object_energies(
            params, encoded, q[:, 0], q[:, 1],
            None if deterministic else keep_masks[3:])
        with span("loss.kvsall"):
            eps = self.c.label_smoothing
            target = labels.to(energies.dtype) * (1.0 - eps) \
                + 1.0 / self.n_entities
            ce = F.binary_cross_entropy_with_logits(energies, target,
                                                    reduction="none")
            return (ce.sum(1) * mask).sum() \
                / (mask.sum().clamp(min=1.0) * self.n_entities)

    # -- test-mode scoring (``ModelView``'s surface) ---------------------
    def _triples(self, triples) -> torch.Tensor:
        return torch.as_tensor(np.asarray(triples), dtype=torch.long,
                               device=self.device).reshape(-1, 3)

    def score_all_objects_encoded(self, params: Dict, encoded: EncodeResult,
                                  triples, apply_sigmoid: bool = True
                                  ) -> torch.Tensor:
        t = self._triples(triples)
        energies = self.object_energies(params, encoded, t[:, 0], t[:, 1])
        return torch.sigmoid(energies) if apply_sigmoid else energies

    def score_all_subjects_encoded(self, params: Dict, encoded: EncodeResult,
                                   triples, apply_sigmoid: bool = True
                                   ) -> torch.Tensor:
        """(?, r, o) scored as (o, r + R, ?), as the official code ranks a
        head."""
        t = self._triples(triples)
        energies = self.object_energies(params, encoded, t[:, 2],
                                        t[:, 1] + self.n_relations)
        return torch.sigmoid(energies) if apply_sigmoid else energies

    def score_encoded(self, params: Dict, encoded: EncodeResult, triples
                      ) -> torch.Tensor:
        """[N] sigmoid energies of the given triples, as objects."""
        t = self._triples(triples)
        scores = self.score_all_objects_encoded(params, encoded, t)
        return scores.gather(1, t[:, 2:3])[:, 0]

    def _test_codes(self, params, graph) -> EncodeResult:
        return self.encode(params, graph, deterministic=True)

    def score(self, params: Dict, graph: CompGCNGraph, triples):
        return self.score_encoded(params, self._test_codes(params, graph),
                                  triples)

    def score_all_subjects(self, params: Dict, graph: CompGCNGraph, triples,
                           apply_sigmoid: bool = True) -> torch.Tensor:
        return self.score_all_subjects_encoded(
            params, self._test_codes(params, graph), triples, apply_sigmoid)

    def score_all_objects(self, params: Dict, graph: CompGCNGraph, triples,
                          apply_sigmoid: bool = True) -> torch.Tensor:
        return self.score_all_objects_encoded(
            params, self._test_codes(params, graph), triples, apply_sigmoid)


def build_model(config: RunConfig, device: torch.device):
    """The model of ``config``: ``CompGCNModel`` for the compgcn encoder,
    else ``RGCNModel``."""
    if isinstance(config, CompGCNRunConfig):
        return CompGCNModel(config, device)
    return RGCNModel(config, device)
