"""Synthetic populated-map fixtures at configurable capacities — the port of
``fishbirdeyevisualslam_tpu/io/fixtures.py``.

A MapState at full (or reduced) capacity with geometrically consistent
observations, the input a global or distributed bundle adjustment sees in
production (reference analog: a mature ``Map`` at ``LoopClosing``'s GBA,
``src/LoopClosing.cc:674-841``).  The random draws are the JAX package's,
from the same ``np.random.RandomState(seed)`` stream in the same order, so
both packages build the same map; the geometry runs in torch on the device
the map is built on."""

from __future__ import annotations

import numpy as np
import torch

from fishbirdeyevisualslam_torch.config import SystemConfig
from fishbirdeyevisualslam_torch.device import resolve_device
from fishbirdeyevisualslam_torch.geometry import camera as cam_ops
from fishbirdeyevisualslam_torch.geometry import se3
from fishbirdeyevisualslam_torch.slam import map_state as ms


def _last_write(table, keys, values):
    """``table.view(-1, d)[keys[r]] = values[r]`` applied in the order of the
    rows, so that the last row with a key wins, as numpy's assignment does;
    only the winners are written, so the result does not depend on the
    order in which the device applies a scatter."""
    flat = table.reshape(-1, table.shape[-1]).clone()
    order = torch.arange(keys.numel(), device=keys.device)
    last = torch.full((flat.shape[0],), -1, dtype=order.dtype, device=keys.device)
    last = last.scatter_reduce(0, keys, order, reduce="amax")
    win = last[keys] == order
    flat[keys[win]] = values[win]
    return flat.reshape(table.shape)


def make_realistic_map(cfg: SystemConfig, seed=0, device=None) -> ms.MapState:
    """Populated MapState at ``cfg``'s capacities (at the defaults: K=256
    valid keyframes on a circle, 32768 front and 16384 bird landmarks), every
    landmark observed by 2-4 consecutive keyframes with geometrically
    consistent measurements (uv = project(X) + 0.5 px noise): inconsistent
    random observations make the LM trajectory chaotic, which says nothing
    about the solver.  Built on ``device`` (the card unless the caller names
    the CPU)."""
    dev = resolve_device(device)
    rng = np.random.RandomState(seed)
    cap = cfg.capacity
    K, P, PB = cap.max_keyframes, cap.max_points, cap.max_bird_points
    M, F, FB = cap.max_obs_per_point, cap.max_front_kp, cap.max_bird_kp
    m = ms.empty_map(cfg, device=dev)
    MB = m.bobs_kf.shape[1]
    th = np.linspace(0, 2 * np.pi, K, endpoint=False)
    poses = []
    for t in th:
        q = np.array([np.cos(t / 2), 0, 0, np.sin(t / 2)])
        poses.append(np.concatenate([q, [10 * np.cos(t), 10 * np.sin(t), 0.0]]))
    kf_Tcw = torch.as_tensor(np.stack(poses), dtype=torch.float32).to(dev)
    Twc = se3.inverse(kf_Tcw)

    # each front point is born in a base keyframe's camera frame (z > 0 there
    # and in its consecutive observers).  Points sharing a feature slot (p,
    # p+F, p+2F, ...) get bases 32 keyframes apart at the default sizes, so
    # their observation windows never collide on a (kf, slot) pair
    base = (np.arange(P) * K) // P
    Xc0 = np.stack([rng.uniform(-4, 4, P), rng.uniform(-2, 2, P),
                    rng.uniform(8, 30, P)], -1).astype(np.float32)
    Xw = se3.transform(Twc[torch.as_tensor(base).to(dev)], torch.as_tensor(Xc0).to(dev))
    nobs = rng.randint(2, 5, P)
    obs_kf = (base[:, None] + np.arange(M)[None, :]) % K
    obs_valid = np.arange(M)[None, :] < nobs[:, None]
    # bird points on the ground near the circle (the same spread rule)
    bbase = (np.arange(PB) * K) // PB
    ang = th[bbase] + rng.uniform(-0.1, 0.1, PB)
    rad = rng.uniform(6, 14, PB)
    bXw = np.stack([rad * np.cos(ang), rad * np.sin(ang), np.zeros(PB)], -1).astype(np.float32)
    bnobs = rng.randint(2, 4, PB)
    bobs_kf = (bbase[:, None] + np.arange(MB)[None, :]) % K
    bobs_valid = np.arange(MB)[None, :] < bnobs[:, None]
    # each point claims one feature slot in every keyframe that observes it
    obs_feat = (np.arange(P)[:, None] % F).repeat(M, 1)
    bobs_feat = (np.arange(PB)[:, None] % FB).repeat(MB, 1)
    # the measurement noise, drawn observation column by column as the JAX
    # package draws it (in float64: numpy adds it to the f32 projections there)
    uv_noise = np.stack([rng.randn(P, 2) * 0.5 for _ in range(M)])
    cam_noise = np.stack([rng.randn(PB, 3) * 0.02 for _ in range(MB)])

    def on(x, dtype=None):
        return torch.as_tensor(x, dtype=dtype).to(dev)

    # consistent measurements: uv = project(Tcw_kf, Xw) + noise, written at
    # the claimed feature slots column by column (a later column overwrites)
    okf, bkf = on(obs_kf.T, torch.int64), on(bobs_kf.T, torch.int64)   # (M, P), (MB, PB)
    pc = se3.transform(kf_Tcw[okf], Xw[None])
    uv = (cam_ops.project_pinhole(cfg.camera, pc).double() + on(uv_noise)).float()
    kf_uv = _last_write(m.kf_uv, (okf * F + on(obs_feat.T, torch.int64)).reshape(-1),
                        uv.reshape(-1, 2))
    bpc = se3.transform(kf_Tcw[bkf], on(bXw)[None])
    bcam = (bpc.double() + on(cam_noise)).float()
    kf_bird_cam = _last_write(m.kf_bird_cam, (bkf * FB + on(bobs_feat.T, torch.int64)).reshape(-1),
                              bcam.reshape(-1, 3))

    i32 = torch.int32
    return m._replace(
        kf_Tcw=kf_Tcw,
        kf_valid=torch.ones((K,), dtype=torch.bool, device=dev),
        kf_seq=torch.arange(K, dtype=i32, device=dev),
        kf_odom=on(np.stack([10 * np.cos(th), 10 * np.sin(th), th], -1), torch.float32),
        kf_uv=kf_uv,
        kf_octave=torch.zeros((K, F), dtype=i32, device=dev),
        kf_bird_cam=kf_bird_cam,
        kf_bird_octave=torch.zeros((K, FB), dtype=i32, device=dev),
        n_kf=torch.tensor(K, dtype=i32, device=dev),
        kf_counter=torch.tensor(K, dtype=i32, device=dev),
        mp_pos=Xw,
        mp_valid=torch.ones((P,), dtype=torch.bool, device=dev),
        bp_pos=on(bXw),
        bp_valid=torch.ones((PB,), dtype=torch.bool, device=dev),
        obs_kf=on(obs_kf, i32), obs_feat=on(obs_feat, i32), obs_valid=on(obs_valid),
        bobs_kf=on(bobs_kf, i32), bobs_feat=on(bobs_feat, i32), bobs_valid=on(bobs_valid),
    )
