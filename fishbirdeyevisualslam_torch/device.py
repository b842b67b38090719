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


def upload(x: torch.Tensor, dev: torch.device) -> torch.Tensor:
    """A host tensor copied to ``dev``; to a card through pinned memory, so
    that the copy does not hold the host until the card has it."""
    if dev.type != "cuda":
        return x.to(dev)
    return x.pin_memory().to(dev, non_blocking=True)


def pick(x: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """``x[i]`` for a 0-d index tensor ``i`` on ``x``'s device.  Indexing by a
    0-d tensor reads it on the host first, which waits for the card."""
    return x.index_select(0, i.reshape(1))[0]


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
