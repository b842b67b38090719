# Frozen copy of fishbirdeyevisualslam_torch/device.py (imports renamed to portbench.reference), cut to what judge.py runs:
# part of the benchmark's yardstick, which changes to the port do not reach.
"""Device choice for the port's entry points."""

from __future__ import annotations

import functools

import numpy as np
import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the current CUDA card unless the
    caller names another.  Raises when a CUDA device is wanted and none is
    present — there is no silent fall-back to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def to_device(tup, dev: torch.device):
    """Move every tensor field of a NamedTuple to ``dev`` (a no-op for fields
    already there); other fields pass through."""
    return type(tup)(*[x.to(dev) if isinstance(x, torch.Tensor) else x
                       for x in tup])


@functools.lru_cache(maxsize=256)
def table(fn, args: tuple, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """``fn(*args)`` (a numpy table) as a tensor on ``device``, built and copied
    once per key.  A host-to-device copy made on every call would synchronise
    the host with the card each time; the JAX package bakes the same tables
    into its compiled programs.  Callers must not modify the result in place."""
    return torch.as_tensor(np.asarray(fn(*args)), dtype=dtype).to(device)


def const(values, dtype: torch.dtype = torch.float32, device=None) -> torch.Tensor:
    """A small constant tensor (``values`` a number or nested tuple) on
    ``device``, cached like ``table``."""
    return table(np.asarray, (values,), dtype, torch.device("cpu" if device is None else device))
