"""Raw and filtered ranks, computed on the scores' device.

Counterpart of ``relationprediction_tpu/evaluation/ranking.py``:

  raw rank      = #{v : score[v] >= score[gold]}           (evaluation.py:151)
  filtered rank = raw - #{known v : score[v] >= gold} + 1  (evaluation.py:152)

Ties count against the gold (``>=``). Known-entity sets are ragged; they are
padded on the host to a [N, K] index matrix with the gold index as filler.
Since score[gold] >= score[gold], each filler adds exactly 1 to the known
count, which is subtracted back.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch


def pad_known(known_lists: Sequence[Sequence[int]], golds: Sequence[int],
              pad_to_multiple: int = 64) -> Tuple[np.ndarray, np.ndarray]:
    """Pad ragged known-entity index lists into [N, K] (filler = gold idx).

    Returns (padded_idxs [N, K] int32, n_real [N] int32).
    """
    n = len(known_lists)
    k = max((len(kl) for kl in known_lists), default=1)
    k = max(k, 1)
    k = -(-k // pad_to_multiple) * pad_to_multiple
    out = np.empty((n, k), dtype=np.int32)
    n_real = np.empty((n,), dtype=np.int32)
    for i, (kl, g) in enumerate(zip(known_lists, golds)):
        m = len(kl)
        out[i, :m] = kl
        out[i, m:] = g
        n_real[i] = m
    return out, n_real


def ranks_from_scores(scores: torch.Tensor, gold_idx: torch.Tensor,
                      known_idxs: torch.Tensor, n_known: torch.Tensor,
                      entity_mask: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(raw, filtered) int32 ranks [N] for a chunk.

    scores: [N, V_pad] candidate scores (any monotonic transform of the
      energies); gold_idx: [N]; known_idxs: [N, K] padded with gold_idx;
    n_known: [N] real known counts; entity_mask: [V_pad] bool, False for
      phantom entity rows, which take no part in the ranking.
    """
    rows = torch.arange(scores.shape[0], device=scores.device)
    gold_scores = scores[rows, gold_idx.long()][:, None]            # [N, 1]
    ge = (scores >= gold_scores) & entity_mask[None, :]
    raw = ge.sum(dim=1, dtype=torch.int32)

    known_scores = torch.gather(scores, 1, known_idxs.long())      # [N, K]
    known_ge = (known_scores >= gold_scores).sum(dim=1, dtype=torch.int32)
    known_ge = known_ge - (known_idxs.shape[1] - n_known)  # drop fillers
    return raw, raw - known_ge + 1


def chunked_ranks(score_fn: Callable[[np.ndarray], torch.Tensor],
                  triples: np.ndarray, gold_col: int,
                  known_dict: Dict[Tuple[int, int], List[int]],
                  key_cols: Tuple[int, int], n_entities: int,
                  chunk_size: int = 1000) -> Tuple[np.ndarray, np.ndarray]:
    """Ranks for all triples, scored in fixed-size chunks.

    score_fn(chunk [C, 3]) -> [C, V_pad] scores on the device.
    gold_col: 0 for subject prediction, 2 for object prediction.
    known_dict: {(key_entity, relation): [known gold-col entities]}.
    key_cols: the (entity, relation) columns forming the dict key —
      (2, 1) for subjects, (0, 1) for objects (``evaluation.py:360,380``).
    """
    raws, filts = [], []
    for start in range(0, len(triples), chunk_size):
        chunk = triples[start:start + chunk_size]
        c = len(chunk)
        if c < chunk_size:
            # The last chunk keeps the full shape: repeat its last row.
            chunk = np.concatenate(
                [chunk, np.repeat(chunk[-1:], chunk_size - c, axis=0)])
        scores = score_fn(chunk)
        dev = scores.device
        entity_mask = torch.arange(scores.shape[1], device=dev) < n_entities

        golds = chunk[:, gold_col]
        known_lists = [known_dict[(int(t[key_cols[0]]), int(t[key_cols[1]]))]
                       for t in chunk]
        known_idxs, n_known = pad_known(known_lists, golds)

        raw, filt = ranks_from_scores(
            scores, torch.from_numpy(np.asarray(golds)).to(dev),
            torch.from_numpy(known_idxs).to(dev),
            torch.from_numpy(n_known).to(dev), entity_mask)
        raws.append(raw.cpu().numpy()[:c])
        filts.append(filt.cpu().numpy()[:c])
    return np.concatenate(raws), np.concatenate(filts)
