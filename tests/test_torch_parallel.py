"""Parity of the port's multi-device layer (``parallel/sharded_ba.py`` and the
``group`` of ``solvers/ba.py:bundle_adjust``) with the JAX package.

  * Two gloo processes on the CPU run ``scripts/torch_multiprocess_ba_worker.py``
    (torch and the port only) on ``__graft_entry__._example_problem``'s kind,
    rebuilt in numpy: both ranks' poses equal bit for bit and within 1e-3
    (the JAX worker's bound, ``scripts/multiprocess_ba_worker.py``) of the
    port's and of JAX's single-device ``bundle_adjust``.
  * ``distributed_bundle_adjust`` at world size 1 against JAX's on a 4-device
    virtual mesh, on ``tests/test_parallel.py:27-37``'s problem (poses 2e-4,
    points 2e-3), and bit for bit against ``bundle_adjust``.
  * ``batched_pose_optimization`` against JAX's on ``tests/test_parallel.py:53-71``'s
    batch, at ``tests/test_torch_pose_opt.py``'s bounds per row.
JAX's references are one registered fixture (``torch_refs.shared``), each
program compiled at XLA optimisation level 0."""

import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from fishbirdeyevisualslam_tpu.config import SystemConfig as JaxConfig
from fishbirdeyevisualslam_tpu.geometry import camera as j_cam
from fishbirdeyevisualslam_tpu.geometry import se3 as j_se3
from fishbirdeyevisualslam_tpu.parallel import sharded_ba as j_sba
from fishbirdeyevisualslam_tpu.solvers import ba as j_ba
from fishbirdeyevisualslam_tpu.solvers import pose_opt as j_po
from fishbirdeyevisualslam_torch.config import SystemConfig
from fishbirdeyevisualslam_torch.parallel import sharded_ba as t_sba
from fishbirdeyevisualslam_torch.solvers import ba as t_ba
from fishbirdeyevisualslam_torch.solvers import pose_opt as t_po

import torch_refs
from torch_scenes import ba_problem

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "scripts", "torch_multiprocess_ba_worker.py")
sys.path.insert(0, os.path.dirname(WORKER))
import torch_multiprocess_ba_worker as worker  # noqa: E402

torch.set_num_threads(1)

CFG = SystemConfig()
JCFG = JaxConfig()
XLA_OPTS = {"xla_backend_optimization_level": 0}
WORLD = 2


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _dp_batch():
    """tests/test_parallel.py:53-71's batch (B = 8, 32 front and 8 bird rows)."""
    rng = np.random.RandomState(0)
    B, n, nb = 8, 32, 8
    Xw = (rng.uniform(-5, 5, (B, n, 3)).astype(np.float32)
          + np.array([0, 0, 15], np.float32))
    Xb = (rng.uniform(2, 10, (B, nb, 3)).astype(np.float32)
          * np.array([1, 1, 0], np.float32))
    T0 = np.tile(np.array([1, 0, 0, 0, 0, 0, 0], np.float32), (B, 1))
    return T0, Xw, Xb


def _jax_refs():
    # the two-process problem, solved on one device
    prob = worker.example_problem(P=16 * WORLD, PB=8 * WORLD)
    poses0, fixed, front, bird, odom = prob
    single = jax.jit(lambda *a: j_ba.bundle_adjust(
        JCFG.camera, JCFG.ba, *a, n_iters_1=5, n_iters_2=5))
    args = (poses0, fixed, j_ba.PointBlocks(**front), j_ba.PointBlocks(**bird),
            j_ba.OdomEdges(**odom))
    single_out = single.lower(*args).compile(XLA_OPTS)(*args)
    # tests/test_parallel.py:27-37: 4 landmark shards
    mesh = j_sba.make_mesh(n_pt=4, n_dp=1)
    small = ba_problem(K=4, P=32, PB=8, M=3)
    sharded = j_sba._jitted_sharded_ba_cached(JCFG, mesh, 2, 1)
    sargs = (small["poses0"], small["fixed"], j_ba.PointBlocks(**small["front"]),
             j_ba.PointBlocks(**small["bird"]), j_ba.OdomEdges(**small["odom"]))
    sharded_out = sharded.lower(*sargs).compile(XLA_OPTS)(*sargs)
    # tests/test_parallel.py:53-71: 8 problems over 8 dp shards
    T0, Xw, Xb = _dp_batch()
    B, n, nb = Xw.shape[0], Xw.shape[1], Xb.shape[1]
    uv = np.asarray(j_cam.project_pinhole(JCFG.camera, jnp.asarray(Xw)))
    front_b = (Xw, uv, np.ones((B, n), np.float32), np.ones((B, n), bool))
    bird_b = (Xb, Xb, np.ones((B, nb), np.float32), np.ones((B, nb), bool))
    dp_mesh = j_sba.make_mesh(n_pt=1, n_dp=8)
    batched = jax.jit(lambda T, f, b: j_sba.batched_pose_optimization(
        JCFG, dp_mesh, T, j_po.FrontObs(*f), j_po.BirdObs(*b)))
    with dp_mesh:
        dp_out = batched.lower(T0, front_b, bird_b).compile(XLA_OPTS)(T0, front_b, bird_b)
    return dict(prob=prob, single=jax.tree.map(np.asarray, single_out), small=small,
                sharded=jax.tree.map(np.asarray, sharded_out),
                dp=(T0, front_b, bird_b), dp_out=jax.tree.map(np.asarray, dp_out))


torch_refs.register("torch_parallel_jax", __file__, _jax_refs, cost=15.0)


@pytest.fixture(scope="module")
def refs(request, tmp_path_factory):
    return torch_refs.shared(request, tmp_path_factory, "torch_parallel_jax")


@pytest.fixture
def world1(tmp_path):
    """A gloo process group of this process alone, for one test, and its mesh."""
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'store'}", world_size=1,
                            rank=0)
    try:
        yield t_sba.make_mesh(device="cpu")
    finally:
        dist.destroy_process_group()


def T(x):
    return torch.from_numpy(np.array(x))


def _blocks(d):
    return t_ba.PointBlocks(**{k: T(v) for k, v in d.items()})


def _odom(d):
    return t_ba.OdomEdges(**{k: T(v) for k, v in d.items()})


def test_two_process_ba(refs, tmp_path):
    """Two gloo ranks on the CPU, a shard of the points each."""
    port = _free_port()
    outs = [tmp_path / f"rank{r}.npz" for r in range(WORLD)]
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, WORKER, str(r), str(WORLD), str(port),
                               str(outs[r])], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, env=env, text=True)
             for r in range(WORLD)]
    try:
        logs = [p.communicate(timeout=120)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    r0, r1 = (np.load(o) for o in outs)
    for k in ("poses", "front_Xw", "bird_Xw", "front_inlier", "bird_inlier"):
        np.testing.assert_array_equal(r0[k], r1[k])
    poses0, fixed, front, bird, odom = refs["prob"]
    port = t_ba.bundle_adjust(CFG.camera, CFG.ba, T(poses0), T(fixed), _blocks(front),
                              _blocks(bird), _odom(odom), n_iters_1=5, n_iters_2=5)
    assert np.abs(r0["poses"] - port.poses.numpy()).max() < 1e-3
    assert np.abs(r0["poses"] - refs["single"].poses).max() < 1e-3
    assert np.abs(r0["poses"] - poses0).max() > 1e-3     # the solve moved the poses
    assert r0["front_Xw"].shape == (16 * WORLD, 3)


def test_distributed_ba_world_size_1(refs, world1):
    """World size 1 against JAX's 4-shard run (poses 2e-4, the first 32 points
    2e-3) and bit for bit against ``bundle_adjust``."""
    s = refs["small"]
    args = (T(s["poses0"]), T(s["fixed"]), _blocks(s["front"]), _blocks(s["bird"]),
            _odom(s["odom"]))
    out = t_sba.distributed_bundle_adjust(CFG, world1, *args, n_iters_1=2, n_iters_2=1)
    ref = refs["sharded"]
    np.testing.assert_allclose(out.poses.numpy(), ref.poses, atol=2e-4)
    np.testing.assert_allclose(out.front_Xw[:32].numpy(), ref.front_Xw[:32], atol=2e-3)
    single = t_ba.bundle_adjust(CFG.camera, CFG.ba, *args, n_iters_1=2, n_iters_2=1)
    for x, y in zip(out, single):
        assert torch.equal(x, y)


def test_batched_pose_optimization(refs, world1):
    """Every row within ``test_torch_pose_opt.py``'s bounds of JAX's: pose
    1e-3 (se3 log), inlier flips under 2%, n_inliers within 5."""
    T0, front_b, bird_b = refs["dp"]
    out = t_sba.batched_pose_optimization(CFG, world1, T(T0),
                                          t_po.FrontObs(*map(T, front_b)),
                                          t_po.BirdObs(*map(T, bird_b)))
    ref = refs["dp_out"]
    assert out.Tcw.shape == (8, 7)
    d = np.abs(np.asarray(j_se3.log(j_se3.compose(jnp.asarray(out.Tcw.numpy()),
                                                  j_se3.inverse(ref.Tcw))))).max(-1)
    assert (d < 1e-3).all(), d
    assert ((out.front_inlier.numpy() != ref.front_inlier).mean(-1) < 0.02).all()
    assert ((out.bird_inlier.numpy() != ref.bird_inlier).mean(-1) < 0.02).all()
    assert (np.abs(out.n_inliers.numpy() - ref.n_inliers) <= 5).all()


def test_pad_blocks_to(refs):
    """The padded rows are zeros (invalid points), as JAX pads."""
    s = refs["small"]
    b = _blocks(s["bird"])
    got = t_sba.pad_blocks_to(b, 12)
    want = j_sba.pad_blocks_to(j_ba.PointBlocks(**s["bird"]), 12)
    for x, y in zip(got, want):
        np.testing.assert_array_equal(x.numpy(), np.asarray(y))
    assert not got.point_valid[8:].any()
    assert t_sba.pad_blocks_to(b, 8) is b


def test_make_mesh_raises_when_the_world_is_too_small(world1):
    assert world1.shape == (1, 1) and world1.mesh_dim_names == ("dp", "pt")
    with pytest.raises(ValueError, match="ranks"):
        t_sba.make_mesh(n_pt=2, device="cpu")
    with pytest.raises(ValueError, match="ranks"):
        t_sba.make_mesh(n_pt=1, n_dp=2, device="cpu")


def test_make_mesh_needs_a_process_group():
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="process group"):
        t_sba.make_mesh(device="cpu")
