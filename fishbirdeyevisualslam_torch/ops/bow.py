"""Bag-of-visual-words place recognition — the port of
``fishbirdeyevisualslam_tpu/ops/bow.py`` (DBoW2's ``TemplatedVocabulary::
transform/score`` and the FeatureVector gate of ``SearchByBoW``).

Word ids come from ``ops/vocab.py``'s batched descent; the idf weights from
the same ``data/orb_vocab.npz``.  A keyframe's L1-normalised tf-idf histogram
is ``idf[w] * count(w)`` over its words, normalised: the counts are summed as
integers, so the histograms are the same bit for bit from run to run on the
card (a float ``index_add_`` sums in the order its atomics land).  Scoring
evaluates the query against every keyframe at once.
"""

from __future__ import annotations

import numpy as np
import torch

from fishbirdeyevisualslam_torch.device import table
from fishbirdeyevisualslam_torch.ops import vocab

N_WORDS = vocab.N_WORDS
NODE_DIV = vocab.K_BRANCH ** (vocab.DEPTH - 2)   # word // 100 -> 100 gate nodes


def _idf_np(path: str) -> np.ndarray:
    with np.load(path) as z:
        idf = z["idf"].astype(np.float32)
    if idf.shape != (N_WORDS,):
        raise ValueError(f"{path}: idf of shape {idf.shape}, not {(N_WORDS,)}")
    return idf


def idf_table(device) -> torch.Tensor:
    """(N_WORDS,) f32 inverse document frequencies on ``device``."""
    return table(_idf_np, (str(vocab.VOCAB_PATH),), torch.float32, torch.device(device))


def node_ids(words):
    """Depth-2 ancestor node of each word: the FeatureVector gate."""
    return torch.div(words, NODE_DIV, rounding_mode="floor")


def node_gate_mask(words_a, valid_a, words_b, valid_b):
    """(Na, Nb) bool: same vocabulary node (``SearchByBoW``'s candidate gate)."""
    return (node_ids(words_a)[:, None] == node_ids(words_b)[None, :]) \
        & valid_a[:, None] & valid_b[None, :]


def _tfidf_hists(words, valid, idf):
    """(..., F) words -> (..., N_WORDS) L1-normalised tf-idf histograms."""
    lead = words.shape[:-1]
    w = torch.where(valid, words, 0).reshape(-1, words.shape[-1]).long()
    counts = torch.zeros((w.shape[0], N_WORDS), dtype=torch.int32, device=words.device)
    counts.scatter_add_(1, w, valid.reshape(w.shape).to(torch.int32))
    hist = counts.to(torch.float32) * idf
    hist = hist / torch.clamp(hist.sum(dim=-1, keepdim=True), min=1e-9)
    return hist.reshape(lead + (N_WORDS,))


def bow_vector(words, valid):
    """The tf-idf vector of one descriptor set (the BowVector)."""
    return _tfidf_hists(words, valid, idf_table(words.device))


def score_against_keyframes(q_words, q_valid, kf_words, kf_valid):
    """DBoW2's L1 similarity of one query against every keyframe: (K,) in
    [0, 1].  For L1-normalised non-negative vectors ``1 - 0.5 |v - w|_1``
    equals ``sum_i min(v_i, w_i)``."""
    idf = idf_table(q_words.device)
    q = _tfidf_hists(q_words, q_valid, idf)
    hists = _tfidf_hists(kf_words, kf_valid, idf)
    return torch.sum(torch.minimum(q[None, :], hists), dim=1)
