"""The benchmark's plain reference: a frozen copy of the port's plain PyTorch
path (frame build, tracking core, local mapping), with each CUDA kernel's
wrapper replaced by the kernel's plain version under the same name.

It imports nothing of ``fishbirdeyevisualslam_torch`` and nothing of JAX, so
later changes to the port are held to it and cannot move it.  ``judge.py``
runs it on the inputs the benchmark made and on the port's state before each
sampled call, and compares what the port produced with what it gives.
"""
