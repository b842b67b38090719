"""Vocabulary-tree place recognition — the port of
``fishbirdeyevisualslam_tpu/ops/vocab.py``: the trained tree (``Vocabulary``,
``load_vocabulary``) and the batched descent of
``TemplatedVocabulary::transform`` (``descend``, its numpy twin ``descend_np``
for offline tools, and ``word_ids``, which keyframe insertion calls).

Every node center of the k=10, depth-4 tree (``data/orb_vocab.npz``, a copy
of the JAX package's) is one row of a (T, 256) +/-1 matrix; one f32 product
scores each descriptor against every node (exact for +/-1), and each level
takes the best of the current node's 10 children, ties to the first child.
"""

from __future__ import annotations

import functools
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

from fishbirdeyevisualslam_torch.device import resolve_device, table

K_BRANCH = 10
DEPTH = 4
N_WORDS = K_BRANCH ** DEPTH
N_NODES_TOTAL = sum(K_BRANCH ** (level + 1) for level in range(DEPTH))
VOCAB_PATH = Path(__file__).resolve().parent.parent / "data" / "orb_vocab.npz"


class Vocabulary(NamedTuple):
    centers_pm1: torch.Tensor  # (N_NODES_TOTAL, 256) bf16 +/-1, levels concatenated
    idf: torch.Tensor          # (N_WORDS,) float32 inverse document frequency


def _centers_pm1(path: str) -> np.ndarray:
    """(N_NODES_TOTAL, 256) f32 +/-1 node centers from the packed file."""
    with np.load(path) as z:
        packed = z["centers_packed"]
    if packed.shape != (N_NODES_TOTAL, 8):
        raise ValueError(f"{path}: centers of shape {packed.shape}, not {(N_NODES_TOTAL, 8)}")
    bits = (packed[:, :, None] >> np.arange(32, dtype=np.uint32)) & 1
    return bits.reshape(-1, 256).astype(np.float32) * 2.0 - 1.0


@functools.lru_cache(maxsize=4)
def load_vocabulary(path: str = str(VOCAB_PATH), device=None) -> Vocabulary:
    """The trained vocabulary (the package's copy of the JAX package's
    ``data/orb_vocab.npz`` by default) on ``device``, the card unless the
    caller names another.  Loaded once per (path, device): callers must not
    modify it in place."""
    dev = resolve_device(device)
    with np.load(path) as z:
        idf = z["idf"].astype(np.float32)
    if idf.shape != (N_WORDS,):
        raise ValueError(f"{path}: idf of shape {idf.shape}, not {(N_WORDS,)}")
    return Vocabulary(torch.from_numpy(_centers_pm1(path)).to(torch.bfloat16).to(dev),
                      torch.from_numpy(idf).to(dev))


def vocabulary_available(path: str = str(VOCAB_PATH)) -> bool:
    return Path(path).exists()


def descend(desc_pm1, centers_pm1):
    """(N, 256) +/-1 descriptors -> (N,) int32 leaf word ids: one f32 product
    against every node center (exact for +/-1), then DEPTH K-way argmax steps
    over the scores (max dot = min Hamming at every branch, ties to the first
    child)."""
    scores = desc_pm1.to(torch.float32) @ centers_pm1.to(torch.float32).T   # (N, T)
    n = desc_pm1.shape[0]
    node = torch.zeros((n,), dtype=torch.int64, device=desc_pm1.device)
    ks = torch.arange(K_BRANCH, device=desc_pm1.device)
    off = 0
    for level in range(DEPTH):
        s = torch.gather(scores, 1, off + node[:, None] * K_BRANCH + ks[None, :])
        node = node * K_BRANCH + torch.argmax(s, dim=1)
        off += K_BRANCH ** (level + 1)
    return node.to(torch.int32)


def word_ids(desc_pm1):
    """(N, 256) +/-1 descriptors -> (N,) int32 leaf word ids of the package's
    vocabulary."""
    return descend(desc_pm1, table(_centers_pm1, (str(VOCAB_PATH),), torch.float32,
                                   desc_pm1.device))


def descend_np(bits: np.ndarray, centers_pm1: np.ndarray) -> np.ndarray:
    """(N, 256) {0, 1} uint8 -> (N,) int32 word ids, in numpy (offline tools)."""
    scores = (bits.astype(np.float32) * 2.0 - 1.0) @ np.asarray(centers_pm1, np.float32).T
    node = np.zeros((bits.shape[0],), np.int32)
    off = 0
    for level in range(DEPTH):
        idx = off + node[:, None] * K_BRANCH + np.arange(K_BRANCH)[None, :]
        node = node * K_BRANCH + np.argmax(np.take_along_axis(scores, idx, axis=1),
                                           axis=1).astype(np.int32)
        off += K_BRANCH ** (level + 1)
    return node
