"""Typed configuration for the PyTorch port (a copy of
``relationprediction_tpu/config.py``, kept field for field so that one
``.exp`` file gives both packages the same RunConfig). The ``compgcn``
encoder, which only the port builds, gives a ``CompGCNRunConfig``: the
same fields and its own ``compgcn`` group.

Replaces the reference's stringly-typed tab-indented INI parser
(``code/common/settings_reader.py``) with frozen dataclasses, while remaining
able to ingest the exact same ``.exp`` files (``settings/*.exp``) and the same
section-merge semantics as ``code/train.py:69-86`` (Encoder/Decoder sections
each merged with Shared then General, with runtime-computed
EntityCount/RelationCount/EdgeCount injected).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, Optional


# ---------------------------------------------------------------------------
# Raw .exp parsing (format-compatible with settings_reader.py)
# ---------------------------------------------------------------------------

class Settings:
    """Nested string-valued settings tree, format-compatible with the
    reference parser (``settings_reader.py:29-48``): ``[Section]`` headers,
    tab-indentation for nesting, ``key=value`` pairs, values kept as strings.
    """

    def __init__(self) -> None:
        self._d: Dict[str, Any] = {}

    # -- mapping protocol ---------------------------------------------------
    def __getitem__(self, key: str) -> Any:
        return self._d[key]

    def __setitem__(self, key: str, value: Any) -> None:
        self._d[key] = value

    def __contains__(self, key: str) -> bool:
        return key in self._d

    def __iter__(self):
        return iter(self._d)

    def get(self, key: str, default: Any = None) -> Any:
        return self._d.get(key, default)

    def items(self):
        return self._d.items()

    def put(self, key: str, value: Any) -> None:
        self._d[key] = value

    def merge(self, other: "Settings") -> None:
        """Overwrite-with-other merge, same as ``settings_reader.Settings.merge``."""
        self._d.update(other._d)

    def copy(self) -> "Settings":
        s = Settings()
        s._d = dict(self._d)
        return s

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"Settings({self._d!r})"

    # -- parsing ------------------------------------------------------------
    def _parse_lines(self, lines, indent: int = 0) -> None:
        for i, line in enumerate(lines):
            if not line.strip():
                continue
            indent_level = _count_indents(line)
            if indent_level < indent:
                break
            if indent_level > indent:
                continue
            stripped = line.strip()
            if stripped.startswith("["):
                name = stripped[1:-1]
                sub = Settings()
                sub._parse_lines(lines[i + 1:], indent=indent + 1)
                self._d[name] = sub
            else:
                parts = [p.strip() for p in stripped.split("=")]
                self._d[parts[0]] = parts[1]


def _count_indents(line: str) -> int:
    for i, c in enumerate(line):
        if c != "\t":
            return i
    return len(line)


def read_settings(path: str) -> Settings:
    with open(path) as f:
        lines = list(f)
    s = Settings()
    s._parse_lines(lines)
    return s


# ---------------------------------------------------------------------------
# Typed configs
# ---------------------------------------------------------------------------

def _yes(v: Any) -> bool:
    return str(v) == "Yes"


@dataclass(frozen=True)
class EncoderConfig:
    """Encoder family + hyperparameters.

    Mirrors the dispatch keys of ``model_builder.build_encoder``
    (``code/common/model_builder.py:26-270``).
    """

    name: str = "embedding"  # embedding | variational_embedding | gcn_diag |
    #                          gcn_basis | variational_gcn_basis
    code_dimension: int = 500
    internal_dimension: int = 500
    n_layers: int = 2
    n_bases: int = 5
    dropout_keep_probability: float = 0.8
    use_input_transform: bool = True
    use_output_transform: bool = False
    add_diagonal: bool = False
    diagonal_coefficients: bool = False
    concatenation: bool = False
    store_edge_data: bool = False
    random_input: bool = False
    partially_random_input: bool = False
    skip_connections: str = "None"  # None | Residual | Highway
    # TPU perf extension (not in the reference): message-stream precision
    # for the aggregation path. "bfloat16" halves the permute+scatter HBM
    # traffic; accumulation stays float32.
    message_precision: str = "float32"  # float32 | bfloat16

    def __post_init__(self):
        if self.message_precision not in ("float32", "bfloat16", "bf16"):
            raise ValueError(
                f"message_precision={self.message_precision!r} not in "
                f"{{'float32', 'bfloat16', 'bf16'}} (a typo here would "
                f"silently run float32)")

    @property
    def gcn_variant(self) -> str:
        """Per-layer variant dispatch, same precedence order as
        ``model_builder.apply_basis_gcn`` (``model_builder.py:284-295``)."""
        if self.add_diagonal:
            return "basis_plus_diag"
        if self.diagonal_coefficients:
            return "basis_times_diag"
        if self.store_edge_data:
            return "basis_stored"
        if self.concatenation:
            return "block"
        return "basis"


@dataclass(frozen=True)
class DecoderConfig:
    name: str = "bilinear-diag"  # bilinear-diag | complex | nonlinear-transform
    code_dimension: int = 500
    regularization_parameter: float = 0.01
    # nonlinear-transform only:
    decoder_dimension: int = 500
    embedding_width: int = 500
    # TPU perf extension (not in the reference): precision of the
    # per-triple decoder streams in the TRAINING loss (the [rate+1)·N, d]
    # e1/r/e2 gathers + products — the train step's dominant HBM traffic
    # at FB15k-237 scale, docs/ROOFLINE.md §4). "bfloat16" halves it;
    # energy/CE reductions and evaluation stay float32.
    stream_precision: str = "float32"  # float32 | bfloat16

    def __post_init__(self):
        if self.stream_precision not in ("float32", "bfloat16", "bf16"):
            raise ValueError(
                f"stream_precision={self.stream_precision!r} not in "
                f"{{'float32', 'bfloat16', 'bf16'}} (a typo here would "
                f"silently run float32)")


@dataclass(frozen=True)
class OptimizerConfig:
    algorithm: str = "Adam"  # Adam | GradientDescent | AdaGrad | RmsProp
    learning_rate: float = 0.01
    max_gradient_norm: Optional[float] = 1.0
    batch_size: Optional[int] = None      # Minibatches component if set
    # Contiguous (in-order, wrapping) minibatch windows instead of random
    # sampling without replacement. The reference declares this mode
    # (``shared/algorithms.py:30-39``) but its implementation is bit-rotted
    # (undefined local, returns None) and the parser hardcodes it off
    # (``optimizer_parameter_parser.py:16``); this implements the intent.
    contiguous_sampling: bool = False
    max_iterations: Optional[int] = None  # IterationCounter component if set
    report_train_loss_every: int = 100
    early_stopping_check_every: int = 2000
    early_stopping_burnin: int = 6000
    save_every_n: Optional[int] = None    # defaults to check_every (ref quirk)
    algorithm_kwargs: Dict[str, float] = field(default_factory=dict)


@dataclass(frozen=True)
class TrainingConfig:
    negative_sample_rate: int = 10
    graph_batch_size: Optional[int] = 30000
    graph_split_size: float = 0.5
    experiment_name: str = "models/Experiment"
    metric: str = "MRR"  # MRR | Accuracy


@dataclass(frozen=True)
class RunConfig:
    """Complete experiment configuration (the typed analogue of a .exp file
    plus the runtime-injected dataset statistics)."""

    encoder: EncoderConfig = field(default_factory=EncoderConfig)
    decoder: DecoderConfig = field(default_factory=DecoderConfig)
    optimizer: OptimizerConfig = field(default_factory=OptimizerConfig)
    training: TrainingConfig = field(default_factory=TrainingConfig)
    # Injected from the dataset (train.py:76-78):
    entity_count: int = 0
    relation_count: int = 0
    edge_count: int = 0

    def with_counts(self, entity_count: int, relation_count: int,
                    edge_count: int) -> "RunConfig":
        return dataclasses.replace(
            self, entity_count=entity_count, relation_count=relation_count,
            edge_count=edge_count)


@dataclass(frozen=True)
class CompGCNConfig:
    """CompGCN (Vashishth et al., arXiv:1911.03082) with a ConvE scorer
    (Dettmers et al., arXiv:1707.01476), trained 1-N: the keys of the
    official code's ``run.py`` that the ``compgcn`` encoder and ``conve``
    decoder sections set; its composition (corr), depth (one layer) and
    bias (none) are the FB15k-237 recipe's and the only ones built.
    Dropouts are drop probabilities, as there."""

    init_dimension: int = 100        # init_dim: the input table's width
    gcn_dimension: int = 200         # gcn_dim = embed_dim with one layer
    layer_dropout: float = 0.1       # dropout: the layer's two directions
    hidden_dropout: float = 0.3      # hid_drop: the entity codes
    k_w: int = 10                    # the stacked input's height is 2 k_w
    k_h: int = 20                    # and its width k_h; k_w k_h = d
    n_filters: int = 200             # num_filt
    kernel_size: int = 7             # ker_sz
    feature_dropout: float = 0.3     # feat_drop: the filters' output
    decoder_dropout: float = 0.3     # hid_drop2: the projection's output
    label_smoothing: float = 0.1     # lbl_smooth
    batch_size: int = 128            # queries a step

    @property
    def conv_height(self) -> int:
        return 2 * self.k_w - self.kernel_size + 1

    @property
    def conv_width(self) -> int:
        return self.k_h - self.kernel_size + 1

    @property
    def flat_size(self) -> int:
        """The filters' flattened output, the projection's input."""
        return self.conv_height * self.conv_width * self.n_filters


@dataclass(frozen=True)
class CompGCNRunConfig(RunConfig):
    """A RunConfig of the ``compgcn`` encoder: the port's own model, which
    the JAX package has not, so its keys live here and not in the shared
    fields."""

    compgcn: CompGCNConfig = field(default_factory=CompGCNConfig)


def require_single_card(config: RunConfig, mesh: bool,
                        vertex_sharded: bool) -> None:
    """Raise ValueError where a ``compgcn`` configuration is asked to run on
    a mesh or vertex-sharded: it trains and ranks on one device only."""
    if isinstance(config, CompGCNRunConfig) and (mesh or vertex_sharded):
        raise ValueError("the compgcn encoder runs on one device: no edge "
                         "mesh, no vertex-sharded path")


def _compgcn(config: RunConfig, enc: Settings, dec: Settings,
             opt: Settings) -> CompGCNRunConfig:
    """The ``compgcn`` encoder's configuration; raises ValueError for what
    the port does not build: another decoder, composition, depth or bias
    than CompGCN's FB15k-237 recipe, bf16, and a stacked input that is
    not the code."""
    if dec.get("Name") != "conve":
        raise ValueError("the compgcn encoder takes the conve decoder")
    if enc.get("Composition", "corr") != "corr" \
            or config.encoder.n_layers != 1 or _yes(enc.get("Bias", "No")):
        raise ValueError("compgcn: one layer, composition corr, no bias "
                         "(Composition=corr, NumberOfLayers=1, Bias=No)")
    for key in ("MessagePrecision", "StreamPrecision"):
        if enc.get(key, "float32") != "float32" \
                or dec.get(key, "float32") != "float32":
            raise ValueError(f"the compgcn encoder runs in float32 only "
                             f"({key})")
    c = CompGCNConfig(
        init_dimension=int(enc.get("InitDimension", 100)),
        gcn_dimension=config.encoder.internal_dimension,
        layer_dropout=float(enc.get("LayerDropout", 0.1)),
        hidden_dropout=float(enc.get("HiddenDropout", 0.3)),
        k_w=int(dec.get("ReshapeWidth", 10)),
        k_h=int(dec.get("ReshapeHeight", 20)),
        n_filters=int(dec.get("NumberOfFilters", 200)),
        kernel_size=int(dec.get("FilterSize", 7)),
        feature_dropout=float(dec.get("FeatureDropout", 0.3)),
        decoder_dropout=float(dec.get("HiddenDropout", 0.3)),
        label_smoothing=float(opt.get("LabelSmoothing", 0.1)),
        batch_size=int(opt.get("BatchSize", 128)))
    d = config.decoder.code_dimension
    if c.k_w * c.k_h != d or c.gcn_dimension != d:
        raise ValueError(f"compgcn: ReshapeWidth x ReshapeHeight and the "
                         f"layer's width must equal CodeDimension {d}")
    if min(c.conv_height, c.conv_width) < 1:
        raise ValueError("compgcn: the filter is larger than the stacked "
                         "input")
    return CompGCNRunConfig(**{f.name: getattr(config, f.name)
                               for f in dataclasses.fields(RunConfig)},
                            compgcn=c)


def from_settings(settings: Settings) -> RunConfig:
    """Build a typed RunConfig from a parsed .exp Settings tree, reproducing
    the section-merge of the reference's ``train.py:80-86``; a
    ``compgcn`` encoder gives a ``CompGCNRunConfig``."""
    enc = settings["Encoder"] if "Encoder" in settings else Settings()
    dec = settings["Decoder"] if "Decoder" in settings else Settings()
    shared = settings["Shared"] if "Shared" in settings else Settings()
    general = settings["General"] if "General" in settings else Settings()
    opt = settings["Optimizer"] if "Optimizer" in settings else Settings()
    ev = settings["Evaluation"] if "Evaluation" in settings else Settings()

    enc = _merged(enc, shared, general)
    dec = _merged(dec, shared, general)

    code_dim = int(enc.get("CodeDimension", 500))
    encoder = EncoderConfig(
        name=enc.get("Name", "embedding"),
        code_dimension=code_dim,
        internal_dimension=int(enc.get("InternalEncoderDimension", code_dim)),
        n_layers=int(enc.get("NumberOfLayers", 2)),
        n_bases=int(enc.get("NumberOfBasisFunctions", 5)),
        dropout_keep_probability=float(enc.get("DropoutKeepProbability", 0.8)),
        use_input_transform=_yes(enc.get("UseInputTransform", "No")),
        use_output_transform=_yes(enc.get("UseOutputTransform", "No")),
        add_diagonal=_yes(enc.get("AddDiagonal", "No")),
        diagonal_coefficients=_yes(enc.get("DiagonalCoefficients", "No")),
        concatenation=_yes(enc.get("Concatenation", "No")),
        store_edge_data=_yes(enc.get("StoreEdgeData", "No")),
        random_input=_yes(enc.get("RandomInput", "No")),
        partially_random_input=_yes(enc.get("PartiallyRandomInput", "No")),
        skip_connections=enc.get("SkipConnections", "None"),
        message_precision=enc.get("MessagePrecision", "float32"),
    )

    decoder = DecoderConfig(
        name=dec.get("Name", "bilinear-diag"),
        code_dimension=int(dec.get("CodeDimension", 500)),
        regularization_parameter=float(dec.get("RegularizationParameter", 0.01)),
        decoder_dimension=int(dec.get("DecoderDimension", 500)),
        embedding_width=int(dec.get("EmbeddingWidth", 500)),
    )

    algo = opt["Algorithm"] if "Algorithm" in opt else Settings()
    early = opt["EarlyStopping"] if "EarlyStopping" in opt else Settings()
    algo_kwargs = {k: float(v) for k, v in algo.items()
                   if k not in ("Name", "learning_rate")}
    optimizer = OptimizerConfig(
        algorithm=algo.get("Name", "Adam"),
        learning_rate=float(algo.get("learning_rate", 0.01)),
        max_gradient_norm=(float(opt["MaxGradientNorm"])
                           if "MaxGradientNorm" in opt else None),
        batch_size=(int(opt["BatchSize"]) if "BatchSize" in opt else None),
        contiguous_sampling=_yes(opt.get("ContiguousSampling", "No")),
        max_iterations=(int(opt["MaxIterations"])
                        if "MaxIterations" in opt else None),
        report_train_loss_every=int(opt.get("ReportTrainLossEvery", 100)),
        early_stopping_check_every=int(early.get("CheckEvery", 2000)),
        early_stopping_burnin=int(early.get("BurninPhaseDuration", 0)),
        save_every_n=(int(opt["SaveEveryN"]) if "SaveEveryN" in opt else None),
        algorithm_kwargs=algo_kwargs,
    )

    training = TrainingConfig(
        negative_sample_rate=int(general.get("NegativeSampleRate", 10)),
        graph_batch_size=(int(general["GraphBatchSize"])
                          if "GraphBatchSize" in general else None),
        graph_split_size=float(general.get("GraphSplitSize", 0.5)),
        experiment_name=general.get("ExperimentName", "models/Experiment"),
        metric=ev.get("Metric", "MRR"),
    )

    config = RunConfig(encoder=encoder, decoder=decoder, optimizer=optimizer,
                       training=training)
    if encoder.name == "compgcn":
        return _compgcn(config, enc, dec, opt)
    return config


def _merged(section: Settings, *others: Settings) -> Settings:
    out = section.copy()
    for o in others:
        out.merge(o)
    return out


def load(path: str) -> RunConfig:
    """Parse a .exp file into a typed RunConfig."""
    return from_settings(read_settings(path))
