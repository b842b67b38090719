"""State carried between the JAX package and the port: its ``Frame``,
``MapState`` and any other NamedTuple of arrays (the bundle adjustment's
``PointBlocks``, ``OdomEdges`` and ``BAResult``) as numpy arrays to the
port's tensors and back, and its config.

Three conversions need care:

  * bf16 arrives as ``ml_dtypes.bfloat16`` numpy arrays; it goes through
    float32 (the +/-1 and 0 values are exact) and comes back as float32,
    since numpy has no bf16 of its own;
  * packed uint32 descriptors are stored as int32 with the same bits (torch's
    uint32 lacks most operations) and come back as uint32;
  * bool stays bool.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

import numpy as np
import torch

from fishbirdeyevisualslam_torch import config as cfg_mod
from fishbirdeyevisualslam_torch.device import resolve_device
from fishbirdeyevisualslam_torch.slam.frame import Frame
from fishbirdeyevisualslam_torch.slam.map_state import MapState

# fields holding packed uint32 descriptor words in the JAX package
PACKED_FIELDS = frozenset({"desc", "bird_desc", "kf_desc", "kf_bird_desc", "mp_desc",
                           "bp_desc"})
# fields holding bf16 +/-1 descriptors
PM1_FIELDS = frozenset({"desc_pm1", "bird_desc_pm1", "mp_desc_pm1", "bp_desc_pm1"})


def _fields(arrays) -> Mapping:
    return arrays._asdict() if hasattr(arrays, "_asdict") else arrays


def array_to_tensor(name: str, a, dev: torch.device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype == np.uint32:
        t = torch.from_numpy(np.array(a).view(np.int32))
    elif a.dtype.name == "bfloat16" or name in PM1_FIELDS:
        t = torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))
    return t.to(dev)


def tensor_to_array(name: str, t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.to(torch.float32).numpy()
    a = t.numpy()
    if name in PACKED_FIELDS:
        return a.view(np.uint32)
    return a


def from_numpy(cls, arrays, device=None):
    """The port's NamedTuple ``cls`` from the JAX package's tuple of the same
    name (a NamedTuple or a mapping of numpy arrays)."""
    dev = resolve_device(device)
    d = _fields(arrays)
    return cls(**{k: array_to_tensor(k, d[k], dev) for k in cls._fields})


def to_numpy(tup) -> dict:
    return {k: tensor_to_array(k, v) for k, v in tup._asdict().items()}


def frame_from_numpy(arrays, device=None) -> Frame:
    """A ``Frame`` from the JAX package's Frame fields (a NamedTuple or a
    mapping of numpy arrays)."""
    return from_numpy(Frame, arrays, device)


def frame_to_numpy(frame: Frame) -> dict:
    return to_numpy(frame)


def map_state_from_numpy(arrays, device=None) -> MapState:
    """A ``MapState`` from the JAX package's MapState fields."""
    return from_numpy(MapState, arrays, device)


def map_state_to_numpy(m: MapState) -> dict:
    return to_numpy(m)


def config_from_dict(d: Mapping) -> cfg_mod.SystemConfig:
    """``SystemConfig`` from ``dataclasses.asdict`` of the JAX package's config."""
    kw = {}
    for f in dataclasses.fields(cfg_mod.SystemConfig):
        sub = f.type if isinstance(f.type, type) else getattr(cfg_mod, f.type)
        kw[f.name] = sub(**{k: tuple(v) if isinstance(v, list) else v
                            for k, v in d[f.name].items()})
    return cfg_mod.SystemConfig(**kw)
