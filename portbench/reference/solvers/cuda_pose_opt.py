"""Per-frame pose optimisation: the plain PyTorch LM of
``fishbirdeyevisualslam_torch/solvers/pose_opt.py``, under the name of the
kernel's wrapper (``fishbirdeyevisualslam_torch/solvers/cuda_pose_opt.py``)."""

from __future__ import annotations

from portbench.reference.solvers.pose_opt import pose_optimization  # noqa: F401
