"""Distributed bundle adjustment over a device mesh — the port of
``fishbirdeyevisualslam_tpu/parallel/sharded_ba.py`` onto ``torch.distributed``.

The mesh has two axes over the ranks of the process group that the caller
sets up (``torch.distributed.init_process_group``: gloo on the CPU; NCCL on
cards, or gloo, whose ``all_reduce`` also takes CUDA tensors):

  axis ``pt``  the landmark blocks.  Residuals, Jacobians, the points'
               marginalisation and their back-substitution run on each
               rank's contiguous slice of the point axis; ``bundle_adjust``
               sums the shards' reduced camera systems and chi2 over the axis
               (``all_reduce``), and the dense (6K, 6K) solve is replicated.
  axis ``dp``  independent problems (frames of a batch), a contiguous block
               of rows per rank.

Every rank passes the whole problem, as each process of the JAX package's
multi-process run builds the same one; every rank gets the whole result.
Results are gathered by an ``all_reduce`` of zero-filled disjoint shards
(``x + 0`` is exact; masks travel as int32): gloo's ``all_gather`` does not
take CUDA tensors on every torch, its ``all_reduce`` does, so one code runs
over NCCL, gloo on the CPU and gloo on a card.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from fishbirdeyevisualslam_torch.config import SystemConfig
from fishbirdeyevisualslam_torch.device import resolve_device, to_device
from fishbirdeyevisualslam_torch.solvers import cuda_pose_opt
from fishbirdeyevisualslam_torch.solvers.ba import BAResult, OdomEdges, PointBlocks, bundle_adjust
from fishbirdeyevisualslam_torch.solvers.pose_opt import BirdObs, FrontObs, PoseOptResult


def make_mesh(n_pt: int | None = None, n_dp: int = 1, device=None) -> DeviceMesh:
    """A ('dp', 'pt') mesh of ``n_dp * n_pt`` ranks of the default process
    group, on the card unless ``device`` names another (``device="cpu"``
    for a gloo group on the CPU).  ``n_pt = None`` takes world size //
    ``n_dp``.  Raises when no process group is set up or the world holds
    fewer ranks than the mesh."""
    dev = resolve_device(device)
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: call "
                           "torch.distributed.init_process_group first")
    world = dist.get_world_size()
    if n_pt is None:
        n_pt = world // n_dp
    if n_dp < 1 or n_pt < 1 or world < n_dp * n_pt:
        raise ValueError(f"make_mesh needs {n_dp} x {n_pt} ranks, the process group has "
                         f"{world}")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    return init_device_mesh(dev.type, (n_dp, n_pt), mesh_dim_names=("dp", "pt"))


def put_on_mesh(tree, mesh: DeviceMesh):
    """Every tensor of ``tree`` (a tensor, a NamedTuple of tensors, or a tuple
    or list of those) moved to the mesh's device."""
    dev = resolve_device(mesh.device_type)
    if isinstance(tree, torch.Tensor):
        return tree.to(dev)
    if hasattr(tree, "_fields"):
        return to_device(tree, dev)
    return type(tree)(put_on_mesh(x, mesh) for x in tree)


def pad_blocks_to(blocks: PointBlocks, P_pad: int) -> PointBlocks:
    """The landmark axis padded with zero rows (invalid points) to ``P_pad``."""
    pad = P_pad - blocks.Xw.shape[0]
    if pad == 0:
        return blocks
    return PointBlocks(*(torch.cat([x, x.new_zeros((pad,) + x.shape[1:])]) for x in blocks))


def _rows(tup, start: int, stop: int):
    return type(tup)(*(x[start:stop] for x in tup))


def _gather(part, start: int, total: int, group) -> torch.Tensor:
    """The whole axis from every rank's rows ``part`` placed at ``start``:
    an all_reduce of zero-filled disjoint shards, bools as int32."""
    full = part.new_zeros((total,) + part.shape[1:],
                          dtype=torch.int32 if part.dtype == torch.bool else part.dtype)
    full[start: start + part.shape[0]] = part
    dist.all_reduce(full, group=group)
    return full.to(part.dtype)


def distributed_bundle_adjust(cfg: SystemConfig, mesh: DeviceMesh, poses0, fixed,
                              front: PointBlocks, bird: PointBlocks, odom: OdomEdges,
                              n_iters_1: int | None = None,
                              n_iters_2: int | None = None) -> BAResult:
    """Global BA with the landmark blocks sharded over the mesh's ``pt`` axis:
    both block sets padded to a multiple of its size, each rank solving
    with its contiguous slice of points and the shards' terms summed.
    Returns the padded problem's result, whole, on every rank."""
    n_pt, r = mesh["pt"].size(), mesh.get_local_rank("pt")
    group = mesh.get_group("pt")
    poses0, fixed, front, bird, odom = put_on_mesh((poses0, fixed, front, bird, odom), mesh)
    front = pad_blocks_to(front, -(-front.Xw.shape[0] // n_pt) * n_pt)
    bird = pad_blocks_to(bird, -(-bird.Xw.shape[0] // n_pt) * n_pt)
    P, PB = front.Xw.shape[0], bird.Xw.shape[0]
    f0, b0 = r * (P // n_pt), r * (PB // n_pt)
    out = bundle_adjust(cfg.camera, cfg.ba, poses0, fixed, _rows(front, f0, f0 + P // n_pt),
                        _rows(bird, b0, b0 + PB // n_pt), odom, n_iters_1=n_iters_1,
                        n_iters_2=n_iters_2, group=group)
    return BAResult(out.poses, _gather(out.front_Xw, f0, P, group),
                    _gather(out.bird_Xw, b0, PB, group),
                    _gather(out.front_inlier, f0, P, group),
                    _gather(out.bird_inlier, b0, PB, group))


def batched_pose_optimization(cfg: SystemConfig, mesh: DeviceMesh, Tcw0_batch,
                              front_batch: FrontObs, bird_batch: BirdObs) -> PoseOptResult:
    """Independent per-frame pose optimisations, B / n_dp rows per rank of the
    mesh's ``dp`` axis: on a card one launch of the fused pose kernel over
    the rank's rows (``cuda_pose_opt.pose_optimization_batched``), on the CPU
    the plain LM per row.  Returns the whole batch's result on every rank."""
    n_dp, r = mesh["dp"].size(), mesh.get_local_rank("dp")
    group = mesh.get_group("dp")
    B = Tcw0_batch.shape[0]
    if B % n_dp:
        raise ValueError(f"batched_pose_optimization: a batch of {B} does not split over "
                         f"{n_dp} ranks")
    Tcw0_batch, front_batch, bird_batch = put_on_mesh((Tcw0_batch, front_batch, bird_batch),
                                                      mesh)
    b0, nb = r * (B // n_dp), B // n_dp
    out = cuda_pose_opt.pose_optimization_batched(
        cfg.camera, cfg.ba, Tcw0_batch[b0: b0 + nb].contiguous(),
        FrontObs(*(x[b0: b0 + nb].contiguous() for x in front_batch)),
        BirdObs(*(x[b0: b0 + nb].contiguous() for x in bird_batch)))
    return PoseOptResult(*(_gather(x, b0, B, group) for x in out))
