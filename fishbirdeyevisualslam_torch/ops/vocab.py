"""Vocabulary-tree word ids — the part of ``fishbirdeyevisualslam_tpu/ops/vocab.py``
and ``ops/bow.py`` that keyframe insertion needs (``kf_words``): the batched
descent of ``TemplatedVocabulary::transform``.

Every node center of the k=10, depth-4 tree (``data/orb_vocab.npz``, a copy
of the JAX package's) is one row of a (T, 256) +/-1 matrix; one f32 product
scores each descriptor against every node (exact for +/-1), and each level
takes the best of the current node's 10 children, ties to the first child.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from fishbirdeyevisualslam_torch.device import table

K_BRANCH = 10
DEPTH = 4
N_WORDS = K_BRANCH ** DEPTH
N_NODES_TOTAL = sum(K_BRANCH ** (level + 1) for level in range(DEPTH))
VOCAB_PATH = Path(__file__).resolve().parent.parent / "data" / "orb_vocab.npz"


def _centers_pm1(path: str) -> np.ndarray:
    """(N_NODES_TOTAL, 256) f32 +/-1 node centers from the packed file."""
    with np.load(path) as z:
        packed = z["centers_packed"]
    if packed.shape != (N_NODES_TOTAL, 8):
        raise ValueError(f"{path}: centers of shape {packed.shape}, not {(N_NODES_TOTAL, 8)}")
    bits = (packed[:, :, None] >> np.arange(32, dtype=np.uint32)) & 1
    return bits.reshape(-1, 256).astype(np.float32) * 2.0 - 1.0


def word_ids(desc_pm1):
    """(N, 256) +/-1 descriptors -> (N,) int32 leaf word ids."""
    centers = table(_centers_pm1, (str(VOCAB_PATH),), torch.float32, desc_pm1.device)
    scores = desc_pm1.to(torch.float32) @ centers.T                # (N, T)
    n = desc_pm1.shape[0]
    node = torch.zeros((n,), dtype=torch.int64, device=desc_pm1.device)
    ks = torch.arange(K_BRANCH, device=desc_pm1.device)
    off = 0
    for level in range(DEPTH):
        s = torch.gather(scores, 1, off + node[:, None] * K_BRANCH + ks[None, :])
        node = node * K_BRANCH + torch.argmax(s, dim=1)
        off += K_BRANCH ** (level + 1)
    return node.to(torch.int32)
