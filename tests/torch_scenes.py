"""Numpy-built map states for the port's mapping tests, shared by the CPU
parity tests (``test_torch_mapping.py``, ``test_torch_ba.py``) and the card
tests (``test_torch_cuda.py``, which run without JAX).  Everything is drawn
from seeds at the slice tests' small capacity (K=16, P=1024, PB=512, M=4,
F=FB=256): keyframes on a short drive whose features are the projections of
world points (0.3 px and 5 mm noise, a few descriptor bits flipped per
observation)."""

import dataclasses

import numpy as np
import torch

from fishbirdeyevisualslam_torch.config import CapacityConfig, SystemConfig
from fishbirdeyevisualslam_torch.convert import map_state_to_numpy
from fishbirdeyevisualslam_torch.geometry import camera as t_cam
from fishbirdeyevisualslam_torch.geometry import ipm as t_ipm
from fishbirdeyevisualslam_torch.geometry import odometry as t_odo
from fishbirdeyevisualslam_torch.geometry import se3 as t_se3
from fishbirdeyevisualslam_torch.slam import map_state as t_ms

F = FB = 256
P, PB, K, M = 1024, 512, 16, 4
TCFG = SystemConfig().replace(capacity=CapacityConfig(
    max_keyframes=K, max_points=P, max_bird_points=PB, max_obs_per_point=M, max_front_kp=F,
    max_bird_kp=FB))
# a local window of 4 keyframes and 2 observers, so that equal covisibility
# weights decide who is in it
TCFG_TIES = TCFG.replace(capacity=dataclasses.replace(TCFG.capacity, max_local_kfs=4,
                                                      max_local_observers=2))


def _empty_map():
    return map_state_to_numpy(t_ms.empty_map(TCFG, device="cpu"))


def _pm1(words):
    bits = (words[:, :, None] >> np.arange(32, dtype=np.uint32)) & 1
    return bits.reshape(len(words), 256).astype(np.float32) * 2 - 1


def _flip(rng, words, n_bits=3):
    out = words.copy()
    for r in range(len(out)):
        for b in rng.randint(0, 256, n_bits):
            out[r, b // 32] ^= np.uint32(1 << (b % 32))
    return out


def _Tcw(odom):
    """Camera poses of planar base poses (x, y, theta), world = base world."""
    Twb = t_odo.se2_to_se3(torch.as_tensor(np.asarray(odom, np.float32)))
    Twc = t_se3.compose(Twb, t_ipm.extrinsics_Tbc(TCFG.extrinsics))
    return t_se3.inverse(Twc).numpy()


def _project(Tcw, X):
    pc = t_se3.transform(torch.as_tensor(Tcw), torch.as_tensor(X, dtype=torch.float32))
    return t_cam.project_pinhole(TCFG.camera, pc).numpy(), pc.numpy()


class Scene:
    """World points and keyframes on a drive along +x (0.5 m and 0.02 rad per
    step).  ``observe`` writes a keyframe's features; ``register`` makes
    landmarks of world points with their observations."""

    def __init__(self, seed, n_front=400, n_bird=400):
        self.rng = rng = np.random.RandomState(seed)
        self.X = np.stack([rng.uniform(8, 30, n_front), rng.uniform(-9, 9, n_front),
                           rng.uniform(0.0, 1.6, n_front)], -1).astype(np.float32)
        self.desc = rng.randint(0, 2**32, (n_front, 8), dtype=np.uint64).astype(np.uint32)
        self.Xg = np.stack([rng.uniform(-2, 10, n_bird), rng.uniform(-4, 4, n_bird),
                            np.zeros(n_bird)], -1).astype(np.float32)
        self.bdesc = rng.randint(0, 2**32, (n_bird, 8), dtype=np.uint64).astype(np.uint32)
        self.m = _empty_map()
        self.feat_of = {}   # (keyframe slot, world id) -> feature

    @staticmethod
    def odom(i):
        return np.array([0.5 * i, 0.05 * i, 0.02 * i], np.float32)

    def features(self, i, last_valid=True, force=()):
        """The keyframe features of drive step i: a Frame-like dict and the
        world id of each front / bird feature (-1 none).  ``force``: (feature,
        world id) pairs placed first."""
        rng = self.rng
        Tcw = _Tcw(self.odom(i))
        uv, pc = _project(Tcw, self.X)
        vis = (pc[:, 2] > 1.0) & (uv[:, 0] >= 2) & (uv[:, 0] < 948) & (uv[:, 1] >= 2) \
            & (uv[:, 1] < 398)
        ids = rng.permutation(np.nonzero(vis)[0])
        forced = dict(force)
        ids = [w for w in ids if w not in forced.values()]
        wid = np.full(F, -1, np.int64)
        free = [f for f in range(F) if f not in forced]
        for f, w in forced.items():
            wid[f] = w
        for f, w in zip(free, ids):
            wid[f] = w
        if not last_valid:
            wid[F - 1] = -1
        ok = wid >= 0
        w = np.clip(wid, 0, None)
        fr = dict(uv=np.where(ok[:, None], uv[w] + rng.randn(F, 2) * 0.3, 0).astype(np.float32),
                  octave=np.where(ok, rng.randint(0, 2, F), 0).astype(np.int32),
                  desc=np.where(ok[:, None], _flip(rng, self.desc[w]), 0).astype(np.uint32),
                  kp_valid=ok)
        _, pcg = _project(Tcw, self.Xg)
        bvis = np.nonzero((np.abs(pcg[:, 0]) < 6) & (pcg[:, 2] > 0.5) & (pcg[:, 2] < 12))[0]
        bid = np.full(FB, -1, np.int64)
        bsel = rng.permutation(bvis)[:FB]
        bid[:len(bsel)] = bsel
        bok = bid >= 0
        b = np.clip(bid, 0, None)
        fr.update(
            bird_cam=np.where(bok[:, None], pcg[b] + rng.randn(FB, 3) * 0.005, 0).astype(np.float32),
            bird_desc=np.where(bok[:, None], _flip(rng, self.bdesc[b]), 0).astype(np.uint32),
            bird_octave=np.zeros(FB, np.int32), bird_kp_valid=bok)
        fr.update(uv_raw=fr["uv"].copy(), angle=np.zeros(F, np.float32),
                  desc_pm1=_pm1(fr["desc"]), bird_uv=np.zeros((FB, 2), np.float32),
                  bird_desc_pm1=_pm1(fr["bird_desc"]), bird_base=np.zeros((FB, 3), np.float32),
                  bird_octave_=None, odom=self.odom(i), timestamp=np.float32(0.04 * i))
        del fr["bird_octave_"]
        return fr, wid, bid, Tcw

    def add_keyframe(self, slot, i, last_valid=True, force=(), is_init=False):
        m = self.m
        fr, wid, bid, Tcw = self.features(i, last_valid, force)
        seq = int(m["kf_counter"])
        m["kf_Tcw"][slot] = Tcw
        m["kf_valid"][slot] = True
        m["kf_is_init"][slot] = is_init
        m["kf_odom"][slot] = fr["odom"]
        m["kf_timestamp"][slot] = fr["timestamp"]
        m["kf_frame_id"][slot] = 5 * i
        m["kf_seq"][slot] = seq
        for k in ("uv", "octave", "desc", "kp_valid"):
            m["kf_" + k][slot] = fr[k]
        for k in ("bird_cam", "bird_desc", "bird_octave", "bird_kp_valid"):
            m["kf_" + k][slot] = fr[k]
        m["kf_counter"] = np.int32(seq + 1)
        m["n_kf"] = np.int32(max(int(m["n_kf"]), slot + 1))
        for f, w in enumerate(wid):
            if w >= 0:
                self.feat_of[(slot, int(w))] = f
        return fr, wid, bid

    def register(self, pt, w, slots, pos_noise=0.03):
        """Landmark ``pt`` at world point ``w`` (+ noise), observed in ``slots``."""
        m = self.m
        m["mp_pos"][pt] = self.X[w] + self.rng.randn(3) * pos_noise
        m["mp_desc"][pt] = self.desc[w]
        m["mp_desc_pm1"][pt] = _pm1(self.desc[w][None])[0]
        m["mp_valid"][pt] = True
        m["mp_ref_kf"][pt] = slots[0] if slots else 0
        n = 0
        for s in slots:
            f = self.feat_of.get((s, w))
            if f is None:
                continue
            m["kf_mp"][s, f] = pt
            if n < M:
                m["obs_kf"][pt, n], m["obs_feat"][pt, n], m["obs_valid"][pt, n] = s, f, True
                n += 1

    def register_bird(self, pt, g, slots, feats):
        m = self.m
        m["bp_pos"][pt] = self.Xg[g] + self.rng.randn(3) * 0.01
        m["bp_desc"][pt] = self.bdesc[g]
        m["bp_desc_pm1"][pt] = _pm1(self.bdesc[g][None])[0]
        m["bp_valid"][pt] = True
        m["bp_ref_kf"][pt] = slots[0]
        for n, (s, f) in enumerate(zip(slots, feats)):
            m["kf_bird_mp"][s, f] = pt
            if n < 8:
                m["bobs_kf"][pt, n], m["bobs_feat"][pt, n], m["bobs_valid"][pt, n] = s, f, True

    def finish(self):
        m = self.m
        m["n_mp"] = np.int32(m["mp_valid"].sum())
        m["n_bp"] = np.int32(m["bp_valid"].sum())
        return m


def _landmarks(sc, slots, wids, bids, n_front, n_bird):
    """Landmarks 0.. for the first ``n_front`` world points seen by any of the
    keyframes (by world id), bird landmarks for the first ``n_bird`` ground
    points; each observed wherever it was seen."""
    seen = sorted({int(w) for wid in wids for w in wid if w >= 0})
    for pt, w in enumerate(seen[:n_front]):
        sc.register(pt, w, [s for s, wid in zip(slots, wids) if w in wid])
    bseen = sorted({int(g) for bid in bids for g in bid if g >= 0})
    for pt, g in enumerate(bseen[:n_bird]):
        obs = [(s, int(np.nonzero(bid == g)[0][0])) for s, bid in zip(slots, bids) if g in bid]
        sc.register_bird(pt, g, [s for s, _ in obs], [f for _, f in obs])
    return {w: pt for pt, w in enumerate(seen[:n_front])}, \
        {g: pt for pt, g in enumerate(bseen[:n_bird])}


def _assoc(wid, bid, pt_of, bpt_of, rng, drop=0.1):
    mp = np.array([pt_of.get(int(w), -1) if w >= 0 else -1 for w in wid], np.int32)
    mp[rng.rand(F) < drop] = -1
    bp = np.array([bpt_of.get(int(g), -1) if g >= 0 else -1 for g in bid], np.int32)
    bp[rng.rand(FB) < drop] = -1
    return dict(mp_idx=mp, bp_idx=bp)


def slice_scene():
    """Three keyframes (slots 0-2, slot 0 the fixed gauge) and the frame of
    the next step to insert; feature F-1 unused, so that no write of the JAX
    package is lost here."""
    sc = Scene(0)
    slots, wids, bids = [0, 1, 2], [], []
    for slot in slots:
        _, wid, bid = sc.add_keyframe(slot, slot, last_valid=False, is_init=slot == 0)
        wids.append(wid)
        bids.append(bid)
    pt_of, bpt_of = _landmarks(sc, slots, wids, bids, 250, 200)
    fr, wid, bid, Tcw = sc.features(3, last_valid=False)
    return dict(m=sc.finish(), frame=fr, assoc=_assoc(wid, bid, pt_of, bpt_of, sc.rng), Tcw=Tcw)


def fault_scene():
    """Keyframes 0-2 with every feature in use and the frame of step 3, built
    so that the JAX package's dump rows collide with real writes:
    keyframe 0's feature F-1 sees a world point no landmark holds and the
    frame sees it too (triangulation writes ``kf_mp[0, F-1]``); keyframe 1's
    feature F-1 sees a landmark that the frame holds but keyframe 1 does not
    (fusion writes ``kf_mp[1, F-1]``).  Two more landmarks are duplicated in
    the frame's associations, so that fusion merges them."""
    sc = Scene(1)
    X = sc.X
    # world points seen from steps 0, 1 and 3 at 8-16 m
    cand = []
    for w in range(len(X)):
        ok = True
        for i in (0, 1, 3):
            uv, pc = _project(_Tcw(sc.odom(i)), X[w:w + 1])
            ok &= bool(8 < pc[0, 2] < 16 and 20 < uv[0, 0] < 930 and 20 < uv[0, 1] < 380)
        if ok:
            cand.append(w)
    # u: the one of widest parallax between steps 0 and 3, for triangulation
    C0, C3 = (t_se3.inverse(torch.from_numpy(_Tcw(sc.odom(i))))[4:].numpy() for i in (0, 3))
    r0, r3 = X[cand] - C0, X[cand] - C3
    cos = np.sum(r0 * r3, -1) / np.linalg.norm(r0, axis=-1) / np.linalg.norm(r3, axis=-1)
    u = cand[int(np.argmin(cos))]
    v, d1, d2 = [w for w in cand if w != u][:3]
    slots, wids, bids = [0, 1, 2], [], []
    for slot, force in zip(slots, [((F - 1, u),), ((F - 1, v), (0, d1), (1, d2)),
                                   ((0, d1), (1, d2))]):
        _, wid, bid = sc.add_keyframe(slot, slot, force=force, is_init=slot == 0)
        wids.append(wid)
        bids.append(bid)
    seen = sorted({int(w) for wid in wids for w in wid if w >= 0} - {u})
    pt_of = {w: pt for pt, w in enumerate(seen[:250] + [v, d1, d2])}
    for w, pt in pt_of.items():
        sc.register(pt, w, slots)
    _, bpt_of = _landmarks(sc, slots, [np.full(F, -1)] * 3, bids, 0, 150)
    # keyframe 1 does not hold v's landmark
    pv = pt_of[v]
    sc.m["kf_mp"][1, F - 1] = -1
    keep = ~((sc.m["obs_kf"][pv] == 1) & (sc.m["obs_feat"][pv] == F - 1))
    sc.m["obs_valid"][pv] &= keep
    # duplicates of d1, d2 in slots 900, 901, held by nothing but the frame
    for dup, w in ((900, d1), (901, d2)):
        sc.register(dup, w, [])
    fr, wid, bid, Tcw = sc.features(3, force=((5, u), (6, v), (7, d1), (8, d2)))
    assoc = _assoc(wid, bid, pt_of, bpt_of, sc.rng)
    assoc["mp_idx"][5] = -1
    assoc["mp_idx"][6] = pv
    assoc["mp_idx"][7], assoc["mp_idx"][8] = 900, 901
    return dict(m=sc.finish(), frame=fr, assoc=assoc, Tcw=Tcw, pt_v=pv)


def ties_scene(outside=False):
    """Eight keyframes (steps 0-7; the one of step 7 in slot K-1) around the
    centre keyframe of step 4 (slot 4).  Each landmark is seen by the centre
    and two other keyframes, every other keyframe sharing 20 landmarks with
    the centre and slot K-1 22, so the covisibility weights tie but for slot
    K-1; with a window of 4 the window is the centre, K-1, 0 and 1 (ties to
    the lower slot), and the observers 2 and 3.  ``outside``: the same map
    with one more front landmark (72) and bird landmark (18), each seen by the
    observers 2 and 3 only, so outside the window."""
    sc = Scene(2)
    slots = [0, 1, 2, 3, 4, 5, 6, K - 1]
    vis = np.ones(len(sc.X), bool)
    for i in range(len(slots)):
        uv, pc = _project(_Tcw(sc.odom(i)), sc.X)
        vis &= (pc[:, 2] > 1.0) & (uv[:, 0] >= 2) & (uv[:, 0] < 948) & (uv[:, 1] >= 2) \
            & (uv[:, 1] < 398)
    common = list(np.nonzero(vis)[0][:72])
    force = tuple(enumerate(common))
    for i, s in enumerate(slots):
        sc.add_keyframe(s, i, force=force, is_init=i == 0)
    others = [s for s in slots if s != 4]
    pt = 0
    for a, b in zip(others, others[1:] + others[:1]):   # each other keyframe in 2 pairs
        for _ in range(10):
            sc.register(pt, common[pt], [4, a, b])
            pt += 1
    for _ in range(2):
        sc.register(pt, common[pt], [4, K - 1])
        pt += 1
    bseen = [g for g in range(len(sc.Xg))]
    n_b = 0
    for s in (K - 1, 0, 2):
        for _ in range(6):
            sc.register_bird(n_b, bseen[n_b], [4, s], [n_b, n_b])
            sc.m["kf_bird_cam"][4, n_b] = _project(sc.m["kf_Tcw"][4], sc.Xg[n_b:n_b + 1])[1][0]
            sc.m["kf_bird_cam"][s, n_b] = _project(sc.m["kf_Tcw"][s], sc.Xg[n_b:n_b + 1])[1][0]
            n_b += 1
    if outside:
        w = min(w for (s, w) in sc.feat_of if s == 2 and (3, w) in sc.feat_of
                and w not in common)
        sc.register(pt, w, [2, 3])
        sc.register_bird(n_b, bseen[n_b], [2, 3], [200, 200])
        for s in (2, 3):
            sc.m["kf_bird_cam"][s, 200] = _project(sc.m["kf_Tcw"][s], sc.Xg[n_b:n_b + 1])[1][0]
    return sc.finish()


def _swap_slots(m, a, b):
    """The same map with keyframe slots a and b exchanged."""
    m = {k: v.copy() for k, v in m.items()}
    for k, v in m.items():
        if k.startswith("kf_") and v.ndim >= 1 and v.shape[0] == K:
            v[[a, b]] = v[[b, a]]
    for k in ("obs_kf", "bobs_kf", "mp_ref_kf", "bp_ref_kf"):
        x = m[k]
        m[k] = np.where(x == a, b, np.where(x == b, a, x)).astype(x.dtype)
    return m


def pressure_scene(base):
    """``base`` with the free front and bird slots below 1/16 of capacity:
    landmarks without observations and of random birth fill the rest."""
    m = {k: v.copy() for k, v in base.items()}
    rng = np.random.RandomState(3)
    for valid, birth, n in (("mp_valid", "mp_first_kf", P - 40), ("bp_valid", "bp_birth", PB - 20)):
        fill = ~m[valid] & (np.arange(len(m[valid])) < n)
        m[birth][fill] = rng.randint(0, 3, fill.sum())
        m[valid][fill] = True
    return m


def crowd_scene():
    """Ten keyframes (steps 0-9) whose landmarks are each held by every
    keyframe that sees them (their first 4 in the observation slots), with
    random found / visible counters: keyframes whose points are all seen
    four times can be culled."""
    sc = Scene(4)
    slots = list(range(10))
    wids, bids = [], []
    for s in slots:
        _, wid, bid = sc.add_keyframe(s, s, is_init=s == 0)
        wids.append(wid)
        bids.append(bid)
    _landmarks(sc, slots, wids, bids, 320, 200)
    m = sc.m
    n = int(m["mp_valid"].sum())
    m["mp_visible"][:n] = sc.rng.randint(1, 12, n)
    m["mp_found"][:n] = (m["mp_visible"][:n] * sc.rng.uniform(0.1, 1.0, n)).astype(np.int32)
    m["mp_first_kf"][:n] = sc.rng.randint(0, 10, n)
    return sc.finish()


def obs_batch(seed, n_pts, B=64):
    """A batch of observations with repeated points, some past the last slot."""
    rng = np.random.RandomState(seed)
    return dict(pt=rng.randint(0, n_pts, B).astype(np.int32),
                kf=rng.randint(0, K, B).astype(np.int32),
                feat=rng.randint(0, F, B).astype(np.int32), valid=rng.rand(B) < 0.8)


def _recycled(m):
    """``m`` with slots recycled out of order (seqs 5, 3, 4 in slots 0-2,
    seq 1 in slot 7) and slot 1's keyframe gone (orphaned references)."""
    m = {k: v.copy() for k, v in m.items()}
    m["kf_seq"][:3] = [5, 3, 4]
    m["kf_seq"][7], m["kf_valid"][7] = 1, True
    m["kf_valid"][1] = False
    m["kf_counter"] = np.int32(6)
    return m


def _quat_rot(q, v):
    """numpy: rotate (..., 3) by unit quaternions (..., 4) [w, x, y, z]."""
    w, u = q[..., :1], q[..., 1:]
    t = 2.0 * np.cross(u, v)
    return v + w * t + np.cross(u, t)


def _project_np(T, X):
    cam = TCFG.camera
    p = _quat_rot(T[..., :4], X) + T[..., 4:]
    return np.stack([cam.fx * p[..., 0] / p[..., 2] + cam.cx,
                     cam.fy * p[..., 1] / p[..., 2] + cam.cy], -1), p


def ba_problem(K=6, P=120, PB=40, M=4, seed=0):
    """``tests/test_ba.py:build_problem`` in numpy: K cameras moving
    sideways, P front and PB bird points each seen by M consecutive cameras
    (0.3 px and 5 mm noise), points off by 0.2 m, poses by ~0.02, the first
    pose fixed, odometry chain edges at the true relative poses, and ten
    front measurements moved 60 px."""
    rng = np.random.RandomState(seed)
    Twc_t = np.stack([np.arange(K) * 1.0, np.arange(K) * -0.01, np.arange(K) * 0.4], -1)
    poses_true = np.concatenate([np.tile([1.0, 0, 0, 0], (K, 1)), -Twc_t], -1).astype(np.float32)

    def blocks(X, dim):
        n = X.shape[0]
        start = rng.randint(0, K - M + 1, n)
        kf_idx = (start[:, None] + np.arange(M)).astype(np.int32)
        uv, pc = _project_np(poses_true[kf_idx], X[:, None, :])
        meas = (uv + rng.randn(n, M, 2) * 0.3) if dim == 2 else (pc + rng.randn(n, M, 3) * 0.005)
        return dict(Xw=(X + rng.randn(*X.shape) * 0.2).astype(np.float32), kf_idx=kf_idx,
                    meas=meas.astype(np.float32), inv_sigma2=np.ones((n, M), np.float32),
                    valid=np.ones((n, M), bool), point_valid=np.ones(n, bool))

    X = np.stack([rng.uniform(-8, 8, P), rng.uniform(-4, 4, P), rng.uniform(12, 22, P)], -1)
    Xb = np.stack([rng.uniform(-8, 8, PB), rng.uniform(-4, 4, PB), rng.uniform(10, 30, PB)], -1)
    front, bird = blocks(X, 2), blocks(Xb, 3)
    front["meas"][:10, 0] += 60.0
    ii = np.arange(K - 1, dtype=np.int32)
    T_meas = np.concatenate([np.tile([1.0, 0, 0, 0], (K - 1, 1)), Twc_t[1:] - Twc_t[:-1]], -1)
    odom = dict(i=ii, j=ii + 1, T_meas=T_meas.astype(np.float32),
                info=np.full(K - 1, 1e4, np.float32), valid=np.ones(K - 1, bool))
    q = np.concatenate([np.ones((K, 1)), rng.randn(K, 3) * 0.01], -1)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    poses0 = np.concatenate([q, poses_true[:, 4:] + rng.randn(K, 3) * 0.02], -1)
    poses0[0] = poses_true[0]
    return dict(poses_true=poses_true, poses0=poses0.astype(np.float32),
                fixed=np.arange(K) == 0, front=front, bird=bird, odom=odom)


def _vocab_leaves(rng, n):
    """n distinct leaf centres of the vocabulary tree as packed descriptors:
    descriptors that quantise stably (random bits quantise arbitrarily)."""
    from fishbirdeyevisualslam_torch.ops import vocab
    with np.load(vocab.VOCAB_PATH) as z:
        leaves = z["centers_packed"][-vocab.N_WORDS:]
    return leaves[rng.choice(vocab.N_WORDS, n, replace=False)].astype(np.uint32)


def _words(m):
    """``kf_words`` of every keyframe from its descriptors (the port's vocabulary descent)."""
    from fishbirdeyevisualslam_torch.ops import vocab
    Kn, Fn = m["kf_desc"].shape[:2]
    pm1 = torch.from_numpy(_pm1(m["kf_desc"].reshape(-1, 8)))
    m["kf_words"] = vocab.word_ids(pm1).numpy().reshape(Kn, Fn)


LOOP_DRIFT = (0.0, 0.0, 0.03, 0.4, -0.25, 0.0)   # se3 (omega, upsilon) of the world drift


def loop_scene():
    """A loop: keyframes 0-3 (slots 0-3, insertion 0-3) at drive steps 0-3,
    and after eleven insertions three keyframes (slots 4-6, insertion 15-17)
    back at steps 1-3 whose poses and landmarks carry a world drift D (a
    keyframe's pose is its true one composed with D, a landmark is D^-1 of
    its world point), with odometry at the truth.  The two visits share no
    landmark.  Slot 7 (insertion 14) is a keyframe of other descriptors
    that shares three landmarks with each return keyframe, so that their
    covisible neighbours' lowest BoW score is low.  World descriptors are
    vocabulary leaves.  Keyframe 6 (the third return) leaves its feature
    F-1 free on a world point that a landmark of the first visit holds:
    fusing the loop into keyframe 6 writes ``kf_mp[6, F-1]``, the JAX
    package's dump row (ROADMAP, queue 3).  Returns the map, D (7,), the
    world id at keyframe 6's feature F-1 and the Frame fields of a query
    frame back at step 2."""
    sc = Scene(5)
    sc.desc = _vocab_leaves(np.random.RandomState(50), len(sc.X))
    D = t_se3.exp(torch.tensor(LOOP_DRIFT, dtype=torch.float32))
    Dinv = t_se3.inverse(D)
    out_slots, wids, bids = [0, 1, 2, 3], [], []
    for s in out_slots:
        _, wid, bid = sc.add_keyframe(s, s, is_init=s == 0)
        wids.append(wid)
        bids.append(bid)
    pt_of, bpt_of = _landmarks(sc, out_slots, wids, bids, 300, 150)
    # a world point of the first visit, held by a landmark, seen at step 3
    uv3, pc3 = _project(_Tcw(sc.odom(3)), sc.X)
    w_free = next(w for w in sorted(pt_of) if pc3[w, 2] > 8 and 20 < uv3[w, 0] < 930
                  and 20 < uv3[w, 1] < 380)
    m = sc.m
    n_mp, n_bp = len(pt_of), len(bpt_of)
    # the keyframe of other descriptors (slot 7, insertion 14)
    m["kf_counter"] = np.int32(14)
    sc.add_keyframe(7, 9)
    m["kf_desc"][7] = np.where(m["kf_kp_valid"][7][:, None],
                               _vocab_leaves(np.random.RandomState(51), F), 0)
    ret_slots, rwids, rbids = [4, 5, 6], [], []
    for s, i in zip(ret_slots, (1, 2, 3)):
        force = ((F - 1, w_free),) if s == 6 else ()
        _, wid, bid = sc.add_keyframe(s, i, force=force)
        m["kf_Tcw"][s] = t_se3.compose(torch.from_numpy(m["kf_Tcw"][s]), D).numpy()
        rwids.append(wid)
        rbids.append(bid)
    # the return visit's own landmarks, in the drifted world
    seen = sorted({int(w) for wid in rwids for w in wid if w >= 0})[:300]
    for k, w in enumerate(seen):
        pt = n_mp + k
        sc.register(pt, w, ret_slots)
        m["mp_pos"][pt] = t_se3.transform(Dinv, torch.from_numpy(m["mp_pos"][pt])).numpy()
    m["kf_mp"][6, F - 1] = -1
    for pt in range(n_mp, n_mp + len(seen)):
        drop = (m["obs_kf"][pt] == 6) & (m["obs_feat"][pt] == F - 1)
        m["obs_valid"][pt] &= ~drop
    bseen = sorted({int(g) for bid in rbids for g in bid if g >= 0})[:150]
    for k, g in enumerate(bseen):
        obs = [(s, int(np.nonzero(bid == g)[0][0])) for s, bid in zip(ret_slots, rbids)
               if g in bid]
        pt = n_bp + k
        sc.register_bird(pt, g, [s for s, _ in obs], [f for _, f in obs])
        m["bp_pos"][pt] = t_se3.transform(Dinv, torch.from_numpy(m["bp_pos"][pt])).numpy()
    # three return landmarks also seen by keyframe 7 (its features 0-2)
    for f in range(3):
        pt = n_mp + f
        n = int(m["obs_valid"][pt].sum())
        m["obs_kf"][pt, n], m["obs_feat"][pt, n], m["obs_valid"][pt, n] = 7, f, True
        m["kf_mp"][7, f] = pt
    _words(m)
    query = sc.features(2)[0]   # a frame back at step 2, the relocalization's query
    return dict(m=sc.finish(), D=D.numpy(), w_free=w_free, query=query)
