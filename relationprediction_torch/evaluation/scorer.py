"""Evaluation scorer: raw/filtered MRR and Hits@k, pairwise Accuracy, and
the score and degree/frequency dumps.

Counterpart of ``relationprediction_tpu/evaluation/scorer.py``: known-triple
indexes built from all registered splits, full-entity scoring in chunks and
the reference's rank formulas (``code/common/evaluation.py``), with the
ranks taken on the scores' device (ranking.py); the dumps write the JAX
package's files line for line.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

import numpy as np

from . import ranking


@dataclass
class MrrSummary:
    """MRR + Hits@{1,3,10}, raw and filtered, plus the per-triple degree and
    frequency breakdowns (``evaluation.py:4-127``)."""

    raw_ranks: np.ndarray
    filtered_ranks: np.ndarray
    in_degrees: np.ndarray
    out_degrees: np.ndarray
    vertex_freqs: np.ndarray
    relation_freqs: np.ndarray
    calculate_hits_at: Tuple[int, ...] = (1, 3, 10)
    results: Dict[str, Dict[str, float]] = field(default_factory=dict)

    def __post_init__(self):
        self.results = {"Raw": {}, "Filtered": {}}
        for kind, ranks in (("Raw", self.raw_ranks),
                            ("Filtered", self.filtered_ranks)):
            self.results[kind]["MRR"] = float(np.mean(1.0 / ranks))
            for h in self.calculate_hits_at:
                self.results[kind][f"H@{h}"] = float(np.mean(ranks <= h))

    def mrr_string(self) -> str:
        return "MRR"

    def accuracy_string(self) -> str:
        return "Accuracy"

    def pretty_print(self) -> str:
        lines = ["\tRaw\tFiltered"]
        for item in ["MRR"] + [f"H@{h}" for h in self.calculate_hits_at]:
            lines.append(f"{item}\t{round(self.results['Raw'][item], 3)}"
                         f"\t{round(self.results['Filtered'][item], 3)}")
        out = "\n".join(lines)
        print(out)
        return out

    # -- dump utilities (``evaluation.py:99-127``) --------------------------
    def dump_degrees(self, in_filename: str, out_filename: str,
                     filter: str = "Filtered") -> None:
        """``degree + 1\tper-triple MRR`` lines, one a prediction row, by
        the in- and the out-degree (``tools/ensemble.CutoffEnsemble``
        reads them)."""
        ranks = (self.filtered_ranks if filter == "Filtered"
                 else self.raw_ranks)
        mrrs = 1.0 / ranks
        with open(in_filename, "w") as f:
            for deg, mrr in zip(self.in_degrees, mrrs):
                f.write(f"{int(deg) + 1}\t{mrr}\n")
        with open(out_filename, "w") as f:
            for deg, mrr in zip(self.out_degrees, mrrs):
                f.write(f"{int(deg) + 1}\t{mrr}\n")

    def dump_frequencies(self, vertex_filename: str, relation_filename: str,
                         filter: str = "Filtered") -> None:
        """``per-triple MRR\tfrequency`` lines, by the vertex's mean
        relation frequency and by the relation's frequency."""
        ranks = (self.filtered_ranks if filter == "Filtered"
                 else self.raw_ranks)
        mrrs = 1.0 / ranks
        with open(vertex_filename, "w") as f:
            for mrr, vf in zip(mrrs, self.vertex_freqs):
                f.write(f"{mrr}\t{vf}\n")
        with open(relation_filename, "w") as f:
            for mrr, rf in zip(mrrs, self.relation_freqs):
                f.write(f"{mrr}\t{rf}\n")


@dataclass
class AccuracySummary:
    """Pairwise accuracy, under ``results["Filtered"]["Accuracy"]`` as the
    early stopper reads it (``scorer.py:88-105`` of the JAX package)."""

    accuracy: float
    results: Dict[str, Dict[str, float]] = field(default_factory=dict)

    def __post_init__(self):
        self.results = {"Raw": {}, "Filtered": {"Accuracy": self.accuracy}}

    def accuracy_string(self) -> str:
        return "Accuracy"

    def mrr_string(self) -> str:
        return "MRR"

    def pretty_print(self) -> str:
        out = f"Accuracy\t{round(self.accuracy, 3)}"
        print(out)
        return out


class Scorer:
    """Metric machinery (``evaluation.py:212-411``).

    register_data() accumulates known-triple dicts (for filtered ranking)
    plus degree/frequency statistics; compute_scores() runs chunked
    full-entity scoring through the model and produces a summary.
    """

    def __init__(self, metric: str = "MRR", chunk_size: int = 1000):
        self.metric = metric
        self.chunk_size = chunk_size
        self.known_subjects: Dict[Tuple[int, int], np.ndarray] = {}
        self.known_objects: Dict[Tuple[int, int], np.ndarray] = {}
        self.in_degree: Dict[int, int] = {}
        self.out_degree: Dict[int, int] = {}
        self.relation_freqs: Dict[int, int] = {}
        self.avg_freq: Dict[int, float] = {}
        self.model = None
        self.params = None
        self.graph = None
        self.n_entities: Optional[int] = None

    # -- registration (``evaluation.py:246-305``) ---------------------------
    def register_data(self, triples: np.ndarray) -> None:
        t = np.asarray(triples, dtype=np.int64).reshape(-1, 3)
        if t.shape[0] == 0:
            return
        for v in np.unique(np.concatenate([t[:, 0], t[:, 2]])).tolist():
            self.in_degree.setdefault(v, 0)
            self.out_degree.setdefault(v, 0)
        rels, cnts = np.unique(t[:, 1], return_counts=True)
        for r, c in zip(rels.tolist(), cnts.tolist()):
            self.relation_freqs[r] = self.relation_freqs.get(r, 0) + c
        self._merge_known(self.known_subjects, t[:, (2, 1, 0)])
        self._merge_known(self.known_objects, t[:, (0, 1, 2)])

    @staticmethod
    def _merge_known(index: Dict[Tuple[int, int], np.ndarray],
                     rows: np.ndarray) -> None:
        """Merge (key_entity, relation, value) rows into an index of
        sorted-unique value arrays per (key_entity, relation)."""
        uniq = np.unique(rows, axis=0)  # lexsorted -> keys are contiguous
        change = np.nonzero((np.diff(uniq[:, 0]) != 0)
                            | (np.diff(uniq[:, 1]) != 0))[0] + 1
        starts = np.concatenate([[0], change])
        ends = np.concatenate([change, [len(uniq)]])
        for a, b in zip(starts.tolist(), ends.tolist()):
            key = (int(uniq[a, 0]), int(uniq[a, 1]))
            vals = uniq[a:b, 2].astype(np.int32)
            prev = index.get(key)
            if prev is not None:
                vals = np.union1d(np.asarray(prev, dtype=np.int32), vals)
            index[key] = vals

    def register_degrees(self, triples: np.ndarray) -> None:
        t = np.asarray(triples, dtype=np.int64).reshape(-1, 3)
        for v, c in zip(*(a.tolist() for a in
                          np.unique(t[:, 2], return_counts=True))):
            self.in_degree[v] += c
        for v, c in zip(*(a.tolist() for a in
                          np.unique(t[:, 0], return_counts=True))):
            self.out_degree[v] += c

    def register_model(self, model, params=None, graph=None,
                       n_entities: Optional[int] = None) -> None:
        self.model = model
        self.params = params
        self.graph = graph
        self.n_entities = n_entities

    def finalize_frequency_computation(self, triples: np.ndarray) -> None:
        t = np.asarray(triples, dtype=np.int64).reshape(-1, 3)
        if t.shape[0] == 0:
            return
        max_rel = int(t[:, 1].max())
        freq_arr = np.zeros(max_rel + 1, dtype=np.float64)
        for r, f in self.relation_freqs.items():
            if r <= max_rel:
                freq_arr[r] = f
        verts = np.concatenate([t[:, 0], t[:, 2]])
        rfreq = np.tile(freq_arr[t[:, 1]], 2)
        sums = np.bincount(verts, weights=rfreq)
        cnts = np.bincount(verts)
        for v in np.nonzero(cnts)[0].tolist():
            self.avg_freq[v] = float(sums[v] / cnts[v])

    # -- scoring ------------------------------------------------------------
    def set_params(self, params, graph=None) -> None:
        """New params (and graph); drops the model view's cached codes,
        which are keyed by the params' identity and would outlive an
        in-place update (``scorer.py:189-194``)."""
        self.params = params
        if graph is not None:
            self.graph = graph
        if hasattr(self.model, "invalidate"):
            self.model.invalidate()

    def compute_scores(self, triples: np.ndarray):
        if self.metric == "Accuracy":
            return self.compute_accuracy_scores(triples)
        return self.compute_mrr_scores(triples)

    def compute_accuracy_scores(self, triples: np.ndarray) -> AccuracySummary:
        """Pairwise pos/neg accuracy (``evaluation.py:311-325``): even rows
        are positives, odd rows their negatives."""
        scores = self.model.score(self.params, self.graph,
                                  np.asarray(triples)).cpu().numpy()
        positives = scores[::2]
        negatives = scores[1::2]
        return AccuracySummary(float(np.mean(positives > negatives)))

    def compute_mrr_scores(self, triples: np.ndarray) -> MrrSummary:
        triples = np.asarray(triples, dtype=np.int32)

        def score_subjects(chunk):
            return self.model.score_all_subjects(self.params, self.graph,
                                                 chunk, apply_sigmoid=False)

        def score_objects(chunk):
            return self.model.score_all_objects(self.params, self.graph,
                                                chunk, apply_sigmoid=False)

        raw_s, filt_s = ranking.chunked_ranks(
            score_subjects, triples, gold_col=0,
            known_dict=self.known_subjects, key_cols=(2, 1),
            n_entities=self.n_entities, chunk_size=self.chunk_size)
        raw_o, filt_o = ranking.chunked_ranks(
            score_objects, triples, gold_col=2,
            known_dict=self.known_objects, key_cols=(0, 1),
            n_entities=self.n_entities, chunk_size=self.chunk_size)

        # Subject-prediction rows use the object's degrees/frequency and
        # vice versa (``evaluation.py:358-388``).
        in_deg = np.array([self.in_degree[int(t[2])] for t in triples]
                          + [self.in_degree[int(t[0])] for t in triples])
        out_deg = np.array([self.out_degree[int(t[2])] for t in triples]
                           + [self.out_degree[int(t[0])] for t in triples])
        v_freq = np.array([self.avg_freq.get(int(t[2]), 0.0) for t in triples]
                          + [self.avg_freq.get(int(t[0]), 0.0)
                             for t in triples])
        r_freq = np.array([self.relation_freqs[int(t[1])]
                           for t in triples] * 2)

        return MrrSummary(
            raw_ranks=np.concatenate([raw_s, raw_o]).astype(np.float64),
            filtered_ranks=np.concatenate([filt_s, filt_o]).astype(np.float64),
            in_degrees=in_deg, out_degrees=out_deg,
            vertex_freqs=v_freq, relation_freqs=r_freq)

    # -- score dumping for ensembles (``evaluation.py:391-408``) -----------
    def dump_all_scores(self, triples: np.ndarray, subject_file: str,
                        object_file: str) -> None:
        """One line a triple and side, ``target | s1\ts2...``: the gold
        entity's sigmoid score, then every other candidate's in id order
        with the known answers of its (entity, relation) key and ids past
        ``n_entities`` removed (``tools/ensemble.WeightEnsemble`` reads
        them). Scored in the scorer's chunks."""
        triples = np.asarray(triples, dtype=np.int32)
        for filename, score, gold, known, key_cols in (
                (subject_file, self.model.score_all_subjects, 0,
                 self.known_subjects, (2, 1)),
                (object_file, self.model.score_all_objects, 2,
                 self.known_objects, (0, 1))):
            with open(filename, "w") as f:
                for start in range(0, len(triples), self.chunk_size):
                    chunk = triples[start:start + self.chunk_size]
                    scores = score(self.params, self.graph,
                                   chunk).cpu().numpy()
                    for prediction, t in zip(scores, chunk):
                        k = known[(int(t[key_cols[0]]), int(t[key_cols[1]]))]
                        target = prediction[int(t[gold])]
                        others = np.delete(prediction[:self.n_entities], k)
                        f.write(str(target) + " | "
                                + "\t".join(str(s) for s in others) + "\n")
