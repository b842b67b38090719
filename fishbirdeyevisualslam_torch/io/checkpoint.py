"""Map checkpoint and resume — the port of
``fishbirdeyevisualslam_tpu/io/checkpoint.py``.  The reference leaves
``SaveMap/LoadMap`` as a TODO (``include/System.h:132-134``); the functional
map state makes it one compressed npz of its arrays.

The file is the JAX package's: the same keys, shapes and dtypes (packed
descriptors as uint32), and the derived +/-1 descriptor operands left out and
rebuilt from the packed words at load.  A map saved by either package loads
in the other.
"""

from __future__ import annotations

import numpy as np

from fishbirdeyevisualslam_torch.convert import array_to_tensor, tensor_to_array
from fishbirdeyevisualslam_torch.device import resolve_device
from fishbirdeyevisualslam_torch.slam.frame import desc_pm1_from_packed
from fishbirdeyevisualslam_torch.slam.map_state import MapState

# derived fields, rebuilt from their packed source at load
DERIVED = {"mp_desc_pm1": "mp_desc", "bp_desc_pm1": "bp_desc"}


def map_arrays(m: MapState, prefix: str = "") -> dict:
    """The map's saved fields as numpy arrays in the JAX package's dtypes."""
    return {prefix + k: tensor_to_array(k, v) for k, v in m._asdict().items()
            if k not in DERIVED}


def map_from_arrays(data, device=None, prefix: str = "") -> MapState:
    """A ``MapState`` on ``device`` (the current card by default) from saved
    fields; files older than ``bp_gen`` and ``n_pressure_evicted`` start them
    at zero, as the JAX package does."""
    dev = resolve_device(device)
    fields = {}
    for k in MapState._fields:
        key = prefix + k
        if k in DERIVED:
            fields[k] = desc_pm1_from_packed(array_to_tensor(DERIVED[k], data[prefix + DERIVED[k]],
                                                             dev))
        elif k == "bp_gen" and key not in data:
            fields[k] = array_to_tensor(k, np.zeros(data[prefix + "bp_valid"].shape[0], np.int32),
                                        dev)
        elif k == "n_pressure_evicted" and key not in data:
            fields[k] = array_to_tensor(k, np.int32(0), dev)
        else:
            fields[k] = array_to_tensor(k, data[key], dev)
    return MapState(**fields)


def save_map(m: MapState, path: str) -> None:
    np.savez_compressed(path, **map_arrays(m))


def load_map(path: str, device=None) -> MapState:
    with np.load(path) as data:
        return map_from_arrays(data, device)
