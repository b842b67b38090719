"""fishbirdeyevisualslam_torch — the PyTorch / CUDA port of
``fishbirdeyevisualslam_tpu`` for NVIDIA Hopper (H100).

The JAX package stays the reference; this package mirrors its structure and
names module by module (``geometry``, ``ops``, ``slam``, ``solvers``, ``io``,
``parallel``, ``runtime``) and imports nothing of it.  Every Pallas kernel of
the JAX package becomes a CUDA C++ kernel under ``csrc/``, built with ``nvcc``
at first use and bound with ``ctypes`` (``_cuda.py``); each kernel's wrapper
runs the kernel's plain PyTorch version when it is handed CPU tensors.

The entry point is ``slam.system.SlamSystem``: ``track`` once per frame
initializes from two views, tracks, inserts keyframes and maps.  It and the
lower entry points (``slam.frame.build_frame``, ``slam.tracking.track_frame_core``,
``slam.map_state.empty_map``, ``convert``) run on the first CUDA card unless the
caller passes ``device="cpu"``; with no card and no device named they raise.
``parallel.sharded_ba`` runs the global BA sharded over the ranks of a
``torch.distributed`` process group and the pose optimisation over a batch.
"""

__version__ = "0.1.0"

import torch as _torch

# Geometry must run in true f32: TF32 matmuls and convolutions keep about three
# decimal digits, and f32 geometry rounded that coarsely moved end-to-end ATE
# from 0.014 m to 0.048 m in the JAX package (its __init__ pins the same
# policy).  Only the +/-1 descriptor contractions run in bf16, where they are
# exact.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False

from fishbirdeyevisualslam_torch.config import SystemConfig, reference_parity  # noqa: E402,F401
