# Frozen copy of fishbirdeyevisualslam_torch/slam/map_state.py (imports renamed to portbench.reference), cut to what judge.py runs:
# part of the benchmark's yardstick, which changes to the port do not reach.
"""Map state: fixed-capacity struct-of-arrays with validity masks — the port
of ``fishbirdeyevisualslam_tpu/slam/map_state.py`` (the reference's pointer
graph of ``Map``/``KeyFrame``/``MapPoint``/``MapPointBird``, ``src/Map.h``).

Functions return a new ``MapState`` (``_replace``) rather than writing in
place, like the JAX package, so a caller's map is never changed under it.
Packed descriptors are int32 tensors holding the JAX package's uint32 bits.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from portbench.reference.config import SystemConfig
from portbench.reference.device import resolve_device
from portbench.reference.geometry import se3


class MapState(NamedTuple):
    # --- keyframes -----------------------------------------------------------
    kf_Tcw: torch.Tensor          # (K, 7) world-to-camera pose
    kf_valid: torch.Tensor        # (K,) bool
    kf_is_init: torch.Tensor      # (K,) bool
    kf_odom: torch.Tensor         # (K, 3)
    kf_timestamp: torch.Tensor    # (K,)
    kf_frame_id: torch.Tensor     # (K,) int32
    kf_seq: torch.Tensor          # (K,) int32 insertion sequence number (-1 free)
    kf_uv: torch.Tensor           # (K, F, 2)
    kf_octave: torch.Tensor       # (K, F) int32
    kf_desc: torch.Tensor         # (K, F, 8) int32
    kf_kp_valid: torch.Tensor     # (K, F) bool
    kf_mp: torch.Tensor           # (K, F) int32 map point per feature, -1 none
    kf_words: torch.Tensor        # (K, F) int32
    kf_bird_cam: torch.Tensor     # (K, FB, 3)
    kf_bird_desc: torch.Tensor    # (K, FB, 8) int32
    kf_bird_octave: torch.Tensor  # (K, FB) int32
    kf_bird_kp_valid: torch.Tensor  # (K, FB) bool
    kf_bird_mp: torch.Tensor      # (K, FB) int32 bird point per feature, -1 none
    # --- front map points ----------------------------------------------------
    mp_pos: torch.Tensor          # (P, 3)
    mp_desc: torch.Tensor         # (P, 8) int32
    mp_desc_pm1: torch.Tensor     # (P, 256) bf16, the same descriptors as +/-1
    mp_valid: torch.Tensor        # (P,) bool
    mp_normal: torch.Tensor       # (P, 3) mean viewing direction
    mp_min_dist: torch.Tensor     # (P,) scale-invariance range
    mp_max_dist: torch.Tensor     # (P,)
    mp_ref_kf: torch.Tensor       # (P,) int32
    mp_visible: torch.Tensor      # (P,) int32
    mp_found: torch.Tensor        # (P,) int32
    mp_first_kf: torch.Tensor     # (P,) int32
    obs_kf: torch.Tensor          # (P, M) int32
    obs_feat: torch.Tensor        # (P, M) int32
    obs_valid: torch.Tensor       # (P, M) bool
    # --- bird map points -----------------------------------------------------
    bp_pos: torch.Tensor          # (PB, 3)
    bp_desc: torch.Tensor         # (PB, 8) int32
    bp_desc_pm1: torch.Tensor     # (PB, 256) bf16
    bp_valid: torch.Tensor        # (PB,) bool
    bp_ref_kf: torch.Tensor       # (PB,) int32
    bp_birth: torch.Tensor        # (PB,) int32 kf_seq of the creating KF
    bp_gen: torch.Tensor          # (PB,) int32 slot generation
    bobs_kf: torch.Tensor         # (PB, MB) int32
    bobs_feat: torch.Tensor       # (PB, MB) int32
    bobs_valid: torch.Tensor      # (PB, MB) bool
    # --- counters (0-d int32) --------------------------------------------------
    n_kf: torch.Tensor
    kf_counter: torch.Tensor
    n_mp: torch.Tensor
    n_bp: torch.Tensor
    n_pressure_evicted: torch.Tensor

    @property
    def K(self):
        return self.kf_Tcw.shape[0]


def alloc_slots(valid_mask, want):
    """First-fit free-slot allocation with recycling: the r-th wanted entry
    gets the r-th free slot.  Slot P-1 is reserved as the dump for entries
    that get none.  Returns (dest (B,) int32, can (B,) bool)."""
    P = valid_mask.shape[0]
    B = want.shape[0]
    dev = valid_mask.device
    iota = torch.arange(P, dtype=torch.int32, device=dev)
    free = ~valid_mask & (iota < P - 1)
    slots = torch.sort(torch.where(free, iota, torch.full_like(iota, P))).values[:B]
    free_slots = torch.where(slots < P, slots, torch.full_like(slots, -1))
    order = torch.cumsum(want.to(torch.int32), dim=0) - 1
    # (an index past the table reads its last entry, as a JAX gather clamps)
    slot = free_slots[order.clamp(0, free_slots.shape[0] - 1).long()]
    can = want & (slot >= 0)
    dest = torch.where(can, slot, torch.full_like(slot, P - 1)).to(torch.int32)
    return dest, can


def reset_bird_slots(m: MapState, dest, can) -> MapState:
    """Clear the observation rows of recycled bird slots and bump their
    generation."""
    d = dest.long()
    return m._replace(
        bobs_valid=m.bobs_valid.index_put(
            (d,), torch.where(can[:, None], torch.zeros_like(m.bobs_valid[d]), m.bobs_valid[d])),
        bp_gen=m.bp_gen.index_add(0, d, can.to(torch.int32)),
    )


def scrub_stale_refs(m: MapState) -> MapState:
    """Drop ``kf_mp``/``kf_bird_mp`` entries that point at invalid points
    (a recycled slot would alias another landmark) and refresh the counts."""
    P = m.mp_pos.shape[0]
    PB = m.bp_pos.shape[0]
    kf_mp = torch.where((m.kf_mp >= 0) & m.mp_valid[m.kf_mp.clamp(0, P - 1).long()],
                        m.kf_mp, torch.full_like(m.kf_mp, -1))
    kf_bird_mp = torch.where(
        (m.kf_bird_mp >= 0) & m.bp_valid[m.kf_bird_mp.clamp(0, PB - 1).long()],
        m.kf_bird_mp, torch.full_like(m.kf_bird_mp, -1))
    return m._replace(
        kf_mp=kf_mp, kf_bird_mp=kf_bird_mp,
        n_mp=torch.sum(m.mp_valid.to(torch.int32)).to(torch.int32),
        n_bp=torch.sum(m.bp_valid.to(torch.int32)).to(torch.int32),
    )


# ---------------------------------------------------------------------------
# Derived structures and the mapping stage's updates
# ---------------------------------------------------------------------------


def _obs_matrix(obs_kf, obs_ok, K: int):
    """(K, P) f32 0/1: keyframe k observes landmark p in any of its slots."""
    P, M = obs_kf.shape
    ks = torch.arange(K, dtype=obs_kf.dtype, device=obs_kf.device)[:, None]
    hit = torch.zeros((K, P), dtype=torch.bool, device=obs_kf.device)
    for s in range(M):
        hit = hit | ((obs_kf[:, s][None, :] == ks) & obs_ok[:, s][None, :])
    return hit.to(torch.float32)


def _shared_counts(A):
    """(K, K) int32 A A^T with the diagonal zeroed.  The f32 product of 0/1
    entries is exact below 2^24 shared landmarks."""
    C = (A @ A.T).to(torch.int32)
    return C - torch.diag(torch.diagonal(C))


def covisibility_counts(m: MapState):
    """(K, K) int32 shared front landmarks between keyframe pairs, the
    covisibility weight of ``KeyFrame::UpdateConnections``; a landmark counts
    once however many slots of a keyframe hold it."""
    return _shared_counts(_obs_matrix(m.obs_kf, m.obs_valid & m.mp_valid[:, None], m.K))


def point_obs_count(m: MapState):
    return torch.sum((m.obs_valid & m.mp_valid[:, None]).to(torch.int32), dim=1)


def temporal_perm(m: MapState):
    """(K,) keyframe slots in insertion order, live ones first: ``perm[r]`` is
    the slot of the r-th oldest live keyframe (slot numbers carry no order
    once slots recycle).  Ties among free slots keep slot order, as
    ``jnp.argsort`` does."""
    key = torch.where(m.kf_valid, m.kf_seq, torch.iinfo(torch.int32).max)
    return torch.argsort(key, stable=True).to(torch.int32)


def _oldest_observer(obs_kf, obs_valid, kf_valid, seq_of, big: int):
    """Per landmark: the slot of its oldest live observer and whether it has one."""
    K = kf_valid.shape[0]
    okf = obs_kf.clamp(0, K - 1).long()
    obs_seq = torch.where(obs_valid & kf_valid[okf], seq_of[okf], big)
    best = torch.argmin(obs_seq, dim=1, keepdim=True)
    return torch.gather(obs_kf, 1, best)[:, 0], torch.min(obs_seq, dim=1).values < big


def reassign_orphan_refs(m: MapState) -> MapState:
    """Re-home ``mp_ref_kf``/``bp_ref_kf`` whose reference keyframe died
    (``KeyFrame::SetBadFlag``): to the oldest live observer, else to the
    oldest live keyframe."""
    K = m.K
    big = torch.iinfo(torch.int32).max
    seq_of = torch.where(m.kf_valid, m.kf_seq, big)
    oldest_live = torch.argmin(seq_of).to(torch.int32)
    cand, has = _oldest_observer(m.obs_kf, m.obs_valid, m.kf_valid, seq_of, big)
    mp_ref = torch.where(m.kf_valid[m.mp_ref_kf.clamp(0, K - 1).long()], m.mp_ref_kf,
                         torch.where(has, cand, oldest_live))
    bcand, bhas = _oldest_observer(m.bobs_kf, m.bobs_valid, m.kf_valid, seq_of, big)
    bp_ref = torch.where(m.kf_valid[m.bp_ref_kf.clamp(0, K - 1).long()], m.bp_ref_kf,
                         torch.where(bhas, bcand, oldest_live))
    return m._replace(mp_ref_kf=mp_ref.to(torch.int32), bp_ref_kf=bp_ref.to(torch.int32))


def put_rows(x, idx, ok, values):
    """``x`` with ``x[idx[r]] = values[r]`` for the rows r where ``ok``, and
    nothing written elsewhere.  The other rows go to a spare row past the
    end, which is dropped, so they can never collide with a real write (the
    JAX package writes them to a real slot and restores its old value there,
    and on the card repeated indices have no defined winner).  The ``ok`` rows'
    indices must be distinct."""
    n = x.shape[0]
    buf = torch.cat([x, x[:1]])
    buf[torch.where(ok, idx.long(), n)] = values.to(x.dtype)
    return buf[:n]


def reset_point_slots(m: MapState, dest, can, first_kf) -> MapState:
    """Clear the per-point state of front slots being recycled: observation
    rows, found/visible counters, scale range, birth keyframe, normal."""
    B = dest.shape[0]
    dev = dest.device
    M = m.obs_kf.shape[1]
    full = lambda v, dtype, *shape: torch.full((B,) + shape, v, dtype=dtype, device=dev)
    first = torch.as_tensor(first_kf, dtype=torch.int32, device=dev).expand(B)
    return m._replace(
        obs_valid=put_rows(m.obs_valid, dest, can, full(False, torch.bool, M)),
        mp_found=put_rows(m.mp_found, dest, can, full(1, torch.int32)),
        mp_visible=put_rows(m.mp_visible, dest, can, full(1, torch.int32)),
        mp_min_dist=put_rows(m.mp_min_dist, dest, can, full(0.0, torch.float32)),
        mp_max_dist=put_rows(m.mp_max_dist, dest, can, full(1e9, torch.float32)),
        mp_first_kf=put_rows(m.mp_first_kf, dest, can, first),
        mp_normal=put_rows(m.mp_normal, dest, can, full(0.0, torch.float32, 3)),
    )


def _obs_slots(obs_valid, pt_idx, valid):
    """Where a batch of new observations lands: each point's next slot after
    its current fill, successive slots for repeated points in batch order.
    Returns (flat index point * M + slot, ok) with ok false past the last slot."""
    P, M = obs_valid.shape
    safe = pt_idx.clamp(0, P - 1).long()
    fill = torch.sum(obs_valid.to(torch.int32), dim=1)[safe]
    # a valid entry's rank among the valid entries of its point, in batch
    # order: its place in a stable sort by point less its group's first place
    # (a batch may hold every point slot once: no (B, B) comparison)
    key = torch.where(valid, pt_idx.long(), torch.iinfo(torch.int64).max)
    order = torch.argsort(key, stable=True)
    sk = key[order]
    first = torch.searchsorted(sk, sk)
    rank = torch.empty_like(first).scatter_(
        0, order, torch.arange(sk.shape[0], device=sk.device) - first)
    rank = torch.where(valid, rank, 0).to(torch.int32)
    ok = valid & (fill + rank < M)
    return safe * M + (fill + rank).clamp(0, M - 1), ok


def _add_obs(kf, feat, valid_t, pt_idx, kf_idx, feat_idx, valid):
    P, M = kf.shape
    flat, ok = _obs_slots(valid_t, pt_idx, valid)
    B = pt_idx.shape[0]
    put = lambda x, v: put_rows(x.reshape(P * M), flat, ok, v).reshape(P, M)
    return (put(kf, kf_idx.expand(B)), put(feat, feat_idx.expand(B)),
            put(valid_t, torch.ones(B, dtype=torch.bool, device=valid.device)))


def add_observation(m: MapState, pt_idx, kf_idx, feat_idx, valid) -> MapState:
    """Register a batch of (point, keyframe, feature) observations (B,): each
    lands in the slot at its point's count of valid observations, repeated
    points in successive slots in batch order (as the JAX package places
    them: a point with a hole in its rows has that slot written over); one
    past a point's last slot is dropped."""
    obs_kf, obs_feat, obs_valid = _add_obs(m.obs_kf, m.obs_feat, m.obs_valid, pt_idx, kf_idx,
                                           feat_idx, valid)
    return m._replace(obs_kf=obs_kf, obs_feat=obs_feat, obs_valid=obs_valid)


