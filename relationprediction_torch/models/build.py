"""Model assembly: config -> encoder/decoder over a dictionary of parameters.

Counterpart of ``relationprediction_tpu/models/build.py`` for the serving
path of ``settings/gcn_block.exp``: the block-diagonal R-GCN with an input
transform and the DistMult decoder, encoded in test mode and scored against
all entities. Parameters are a plain dictionary of tensors with the JAX
package's tree layout (params.py converts between the two).
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

from ..config import RunConfig
from ..graph import GraphBatch, build_graph_batch
from ..params import map_tree
from . import decoders as decoders_lib
from . import encoders as enc


class EncodeResult(NamedTuple):
    entity_codes: torch.Tensor    # [V, d]
    relation_codes: torch.Tensor  # [R, d]


def _check_supported(config: RunConfig) -> None:
    """Raise NotImplementedError for what the port does not run yet."""
    e = config.encoder
    if e.name != "gcn_basis":
        raise NotImplementedError(f"encoder {e.name!r} is not ported yet "
                                  f"(ROADMAP.md Queue 1 item 6)")
    if e.gcn_variant != "block":
        raise enc.not_ported(e.gcn_variant)
    if not e.use_input_transform or e.random_input \
            or e.partially_random_input or e.use_output_transform \
            or e.skip_connections != "None":
        raise NotImplementedError("only the gcn_block.exp input/output "
                                  "stages are ported (ROADMAP.md Queue 1 "
                                  "item 6)")
    if e.message_precision != "float32":
        raise NotImplementedError("message_precision=bfloat16 is not ported "
                                  "yet (ROADMAP.md Queue 1 item 6)")


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
        self.decoder = decoders_lib.build_decoder(
            config.decoder.name,
            code_dimension=config.decoder.code_dimension,
            regularization_parameter=config.decoder.regularization_parameter)

    # ------------------------------------------------------------------
    # Parameters and graph
    # ------------------------------------------------------------------
    def init_params(self, generator: torch.Generator) -> Dict:
        """Random parameters drawn from ``generator`` (``build.py:135-190``),
        moved to the model's device."""
        e = self.config.encoder
        d_int = e.internal_dimension
        params: Dict = {
            "input_transform": enc.init_affine(
                generator, (self.n_entities, d_int), use_bias=True),
            "gcn_layers": [
                enc.init_gcn_layer(generator, e.gcn_variant,
                                   n_relations=self.n_relations,
                                   d_in=d_int, d_out=d_int,
                                   n_bases=e.n_bases)
                for _ in range(e.n_layers)],
            "relation_embedding": enc.init_relation_embedding(
                generator, self.n_relations, e.code_dimension),
            "decoder": self.decoder.init(generator),
        }
        return map_tree(lambda t: t.to(self.device), params)

    def make_graph(self, triples: np.ndarray) -> GraphBatch:
        """The message graph of ``triples`` with its CSR layouts, on the
        model's device."""
        return build_graph_batch(triples, self.n_entities,
                                 self.n_relations).to(self.device)

    # ------------------------------------------------------------------
    # Encoding and scoring
    # ------------------------------------------------------------------
    def encode(self, params: Dict, graph: GraphBatch, *,
               deterministic: bool,
               generator: Optional[torch.Generator] = None
               ) -> EncodeResult:
        """All-entity codes [V, d] and relation codes [R, d]
        (``build.py:335-421``)."""
        e = self.config.encoder
        features = enc.apply_affine(params["input_transform"], None,
                                    onehot_input=True, use_bias=True,
                                    use_nonlinearity=True)
        for layer_idx, layer_params in enumerate(params["gcn_layers"]):
            features = enc.apply_gcn_layer(
                layer_params, e.gcn_variant, graph, features,
                use_nonlinearity=layer_idx < e.n_layers - 1,
                dropout_keep=e.dropout_keep_probability,
                deterministic=deterministic, generator=generator,
                n_vertices=self.n_entities)
        return EncodeResult(features,
                            params["relation_embedding"]["W_relation"])

    def _triples(self, triples) -> torch.Tensor:
        return torch.as_tensor(np.asarray(triples), dtype=torch.long,
                               device=self.device).reshape(-1, 3)

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
    without a mesh (``build.py:720-869``).

    The test-mode codes are computed once per (params, graph) pair, compared
    by identity, and each chunk is then only the decoder GEMM. Presents the
    (params, graph, triples) surface of RGCNModel, so it can be handed to
    evaluation.Scorer.
    """

    def __init__(self, model: RGCNModel):
        self.model = model
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
                self._encoded = self.model.encode(params, graph,
                                                  deterministic=True)
            self._key = (params, graph)
        return self._encoded

    def score_all_subjects(self, params, graph, triples,
                           apply_sigmoid: bool = True) -> torch.Tensor:
        with torch.no_grad():
            return self.model.score_all_subjects_encoded(
                params, self.encoded(params, graph), triples, apply_sigmoid)

    def score_all_objects(self, params, graph, triples,
                          apply_sigmoid: bool = True) -> torch.Tensor:
        with torch.no_grad():
            return self.model.score_all_objects_encoded(
                params, self.encoded(params, graph), triples, apply_sigmoid)


def build_model(config: RunConfig, device: torch.device) -> RGCNModel:
    return RGCNModel(config, device)
