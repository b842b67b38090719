"""Fused projection matchers and packed Hamming kernels: the wrappers of
kernels ``csrc/matcher.cu`` and ``csrc/hamming.cu`` and their plain PyTorch
versions.

Replace ``fishbirdeyevisualslam_tpu/ops/pallas_matcher.py``'s
``fused_projection_match`` and ``fused_projection_match_dual``.  Both take

  pm1_a (Na, 256) +/-1 query descriptors, uv_a (Na, 2), oct_a (Na,), valid_a (Na,);
  pm1_b (Nb, 256) +/-1 target descriptors, uv_b (Nb, 2) projected positions,
  radius_b (Nb,) or scalar search window, pred_b (Nb,) predicted octave
  (< 0: no octave gate), valid_b (Nb,);

and match each query to the targets with |du|, |dv| <= radius and, with
``level_window``, an octave within [pred - 1, pred + 1]: exactly
``matcher.match`` on that compatibility mask.

Also replace the same file's ``hamming_matrix_packed`` (the full Hamming
matrix of packed (N, 8) 32-bit descriptor words) and ``fused_masked_match``
(nearest packed descriptor within one square window, best, second-best and
index), which no path of the tracker calls.  The wrappers launch the kernel
for CUDA tensors and run the plain version for CPU tensors; there is no other
fall-back.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from fishbirdeyevisualslam_torch import _cuda
from fishbirdeyevisualslam_torch.device import const
from fishbirdeyevisualslam_torch.ops import matcher
from fishbirdeyevisualslam_torch.ops.matcher import MatchResult

BLOCK_ROWS = 128  # query rows per block (csrc/matcher.cu: BM)
TILE_COLS = 64    # target columns per tile (csrc/matcher.cu: BN)
# dtypes the matchers read octave and predicted level in (csrc/matcher.cu: NumType)
_NUM_TYPES = {torch.float32: 0, torch.int32: 1, torch.int64: 2}


def _radius(radius_b, n: int, dev):
    """(n,) f32 per-target radii from a tensor or a number (a number is filled
    on the device: a host tensor would cost a synchronising copy)."""
    if isinstance(radius_b, torch.Tensor):
        return torch.broadcast_to(radius_b.to(torch.float32), (n,))
    return torch.full((n,), float(radius_b), dtype=torch.float32, device=dev)


def _compat(uv_a, oct_a, valid_a, uv_b, radius_b, pred_b, valid_b, level_window, scale=1.0):
    r = _radius(radius_b, uv_b.shape[0], uv_b.device) * scale
    d = torch.abs(uv_a[:, None, :] - uv_b[None, :, :])
    compat = (d[..., 0] <= r[None, :]) & (d[..., 1] <= r[None, :])
    if level_window:
        d_oct = oct_a[:, None].to(torch.float32) - pred_b[None, :].to(torch.float32)
        compat = compat & (((d_oct >= -1) & (d_oct <= 1)) | (pred_b[None, :] < 0))
    return compat & valid_a[:, None] & valid_b[None, :]


def fused_projection_match_plain(pm1_a, uv_a, oct_a, valid_a, pm1_b, uv_b, radius_b,
                                 pred_b, valid_b, max_dist: float,
                                 level_window: bool = False,
                                 ratio: Optional[float] = None) -> MatchResult:
    """The dense reference: ``matcher.match`` on the gated compatibility mask."""
    compat = _compat(uv_a, oct_a, valid_a, uv_b, radius_b, pred_b, valid_b, level_window)
    return matcher.match(pm1_a, pm1_b, compat, max_dist=max_dist, ratio=ratio)


def fused_projection_match_dual_plain(pm1_a, uv_a, oct_a, valid_a, pm1_b, uv_b, radius_b,
                                      pred_b, valid_b, max_dist: float,
                                      r2_scale: float = 2.0, level_window: bool = False):
    """The dense reference of the dual-radius matcher: one ``matcher.match``
    per window (radius, radius * r2_scale)."""
    return tuple(
        matcher.match(pm1_a, pm1_b,
                      _compat(uv_a, oct_a, valid_a, uv_b, radius_b, pred_b, valid_b,
                              level_window, scale),
                      max_dist=max_dist)
        for scale in (1.0, r2_scale))


def _launch(pm1_a, uv_a, oct_a, valid_a, pm1_b, uv_b, radius_b, pred_b, valid_b, max_dist,
            level_window, ratio=None, r2_scale=None):
    """Either matcher's launch (the dual one when ``r2_scale`` is given):
    checks, outputs and scratch, nothing more; the kernel reads the gate's
    inputs with their own strides and dtypes."""
    dev = pm1_a.device
    na, nb = pm1_a.shape[0], pm1_b.shape[0]
    tensors = [("pm1_a", pm1_a), ("uv_a", uv_a), ("oct_a", oct_a), ("valid_a", valid_a),
               ("pm1_b", pm1_b), ("uv_b", uv_b), ("pred_b", pred_b), ("valid_b", valid_b)]
    if isinstance(radius_b, torch.Tensor):
        tensors.append(("radius_b", radius_b))
    for name, t in tensors:
        if t.device != dev or dev.type != "cuda":
            raise ValueError(f"projection match: {name} must lie on the CUDA device {dev}")
    for name, t in (("pm1_a", pm1_a), ("pm1_b", pm1_b)):
        if t.dtype != torch.bfloat16 or t.dim() != 2 or t.shape[1] != 256 \
                or not t.is_contiguous() or t.data_ptr() % 32:
            raise ValueError(f"projection match: {name} must be a contiguous, 32-byte aligned "
                             "(N, 256) bfloat16 tensor")
    if nb > 65536:
        raise ValueError(f"projection match: at most 65536 targets, got {nb}")
    for name, t, shape, dtypes in (
            ("uv_a", uv_a, (na, 2), (torch.float32,)), ("uv_b", uv_b, (nb, 2), (torch.float32,)),
            ("oct_a", oct_a, (na,), _NUM_TYPES), ("pred_b", pred_b, (nb,), _NUM_TYPES),
            ("valid_a", valid_a, (na,), (torch.bool,)), ("valid_b", valid_b, (nb,), (torch.bool,))):
        if tuple(t.shape) != shape or t.dtype not in dtypes:
            raise ValueError(f"projection match: {name} must have shape {shape} and a dtype of "
                             f"{[str(d) for d in dtypes]}, got {tuple(t.shape)} {t.dtype}")
    r_ptr, r_stride, r_value = 0, 0, 0.0
    if isinstance(radius_b, torch.Tensor):
        if radius_b.dtype != torch.float32 or (radius_b.numel() != 1
                                               and tuple(radius_b.shape) != (nb,)):
            raise ValueError("projection match: radius_b must be a float32 tensor of shape "
                             "(Nb,) or of one element, or a number")
        r_ptr = radius_b.data_ptr()
        r_stride = radius_b.stride(0) if radius_b.numel() != 1 else 0
    else:
        r_value = float(radius_b)
    dual = r2_scale is not None
    outs = [torch.empty((na,), dtype=t, device=dev)
            for t in (torch.int32, torch.float32, torch.bool) * (2 if dual else 1)]
    results = (MatchResult(*outs[:3]), MatchResult(*outs[3:])) if dual else MatchResult(*outs)
    if na == 0:
        return results
    n_tiles = -(-nb // TILE_COLS)
    row_blocks = -(-na // BLOCK_ROWS)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    splits = max(1, min(n_tiles, sms // row_blocks))
    part1 = torch.empty((splits, na), dtype=torch.int32, device=dev)
    part2 = torch.empty((splits, na), dtype=torch.int32, device=dev)

    lib = _cuda.load("matcher")
    vp, ci, cf, cl = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
    if dual:
        fn, mode = lib.proj_match_dual, [cf(r2_scale)]
    else:
        fn, mode = lib.proj_match_single, [ci(ratio is not None),
                                           cf(ratio if ratio is not None else 0.0)]
    fn.argtypes = [vp, vp, cl, cl, vp, ci, cl, vp, cl, ci,
                   vp, vp, cl, cl, vp, cl, cf, vp, ci, cl, vp, cl, ci,
                   ci, cf] + [type(m) for m in mode] + [ci, vp, vp] + [vp] * len(outs) + [vp]
    fn.restype = ci
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(pm1_a.data_ptr(), uv_a.data_ptr(), uv_a.stride(0), uv_a.stride(1),
                 oct_a.data_ptr(), _NUM_TYPES[oct_a.dtype], oct_a.stride(0),
                 valid_a.data_ptr(), valid_a.stride(0), na,
                 pm1_b.data_ptr(), uv_b.data_ptr(), uv_b.stride(0), uv_b.stride(1),
                 r_ptr, r_stride, r_value, pred_b.data_ptr(), _NUM_TYPES[pred_b.dtype],
                 pred_b.stride(0), valid_b.data_ptr(), valid_b.stride(0), nb,
                 int(bool(level_window)), float(max_dist), *mode, splits, part1.data_ptr(),
                 part2.data_ptr(), *(o.data_ptr() for o in outs), stream)
    _cuda.check(err, fn.__name__)
    (fused_projection_match_dual if dual else fused_projection_match).launches += 1
    return results


def fused_projection_match(pm1_a, uv_a, oct_a, valid_a, pm1_b, uv_b, radius_b, pred_b,
                           valid_b, max_dist: float, level_window: bool = False,
                           ratio: Optional[float] = None) -> MatchResult:
    """Best match with second-best, ``max_dist`` and an optional ratio test."""
    if pm1_a.device.type == "cpu":
        return fused_projection_match_plain(pm1_a, uv_a, oct_a, valid_a, pm1_b, uv_b,
                                            radius_b, pred_b, valid_b, max_dist,
                                            level_window, ratio)
    return _launch(pm1_a, uv_a, oct_a, valid_a, pm1_b, uv_b, radius_b, pred_b, valid_b,
                   max_dist, level_window, ratio=ratio)


def fused_projection_match_dual(pm1_a, uv_a, oct_a, valid_a, pm1_b, uv_b, radius_b, pred_b,
                                valid_b, max_dist: float, r2_scale: float = 2.0,
                                level_window: bool = False):
    """Two top-1 matches from one contraction, at windows ``radius_b`` and
    ``radius_b * r2_scale`` (r2_scale >= 1).  Returns (MatchResult, MatchResult)."""
    if r2_scale < 1.0:
        raise ValueError("r2_scale must be >= 1: the narrow window lies inside the wide one")
    if pm1_a.device.type == "cpu":
        return fused_projection_match_dual_plain(pm1_a, uv_a, oct_a, valid_a, pm1_b, uv_b,
                                                 radius_b, pred_b, valid_b, max_dist,
                                                 r2_scale, level_window)
    return _launch(pm1_a, uv_a, oct_a, valid_a, pm1_b, uv_b, radius_b, pred_b, valid_b,
                   max_dist, level_window, r2_scale=r2_scale)


fused_projection_match.launches = 0
fused_projection_match_dual.launches = 0


# packed Hamming kernels (csrc/hamming.cu): descriptor words held as int32 bit
# patterns, as convert.py holds them

# masked match (csrc/hamming.cu: mm_bin + mm_match): the targets are binned into
# square cells of side s = max(r * (1 + CELL_MARGIN), MIN_CELL) and hashed
# into a table of 4**lg slots (cell coordinates mod 2**lg), about
# TARGETS_PER_SLOT targets a slot, lg in [2, 6] (csrc/hamming.cu: MAX_LG)
CELL_MARGIN = 1.0 / 32
MIN_CELL = 1.0  # px
TARGETS_PER_SLOT = 16
_POPCOUNT8 = tuple(bin(i).count("1") for i in range(256))


def hamming_matrix_packed_plain(desc_a, desc_b):
    """(Na, 8) x (Nb, 8) packed words -> (Na, Nb) f32 Hamming distances: XOR
    of each word pair, popcount by a 256-entry byte table."""
    na, nb = desc_a.shape[0], desc_b.shape[0]
    acc = torch.zeros((na, nb), dtype=torch.int32, device=desc_a.device)
    for w in range(desc_a.shape[1]):
        acc += popcount32(torch.bitwise_xor(desc_a[:, w, None], desc_b[None, :, w]))
    return acc.to(torch.float32)


def popcount32(x):
    """Set bits of each int32 element, by a 256-entry byte table."""
    table = const(_POPCOUNT8, torch.int32, x.device)
    x = x.contiguous()
    return table[x.view(torch.uint8).long()].view(x.shape + (4,)).sum(-1, dtype=torch.int32)


def fused_masked_match_plain(desc_a, uv_a, desc_b, uv_b, valid_b, radius: float):
    """The dense reference of the masked match: the Hamming matrix, the
    square window ``matcher.window_mask`` over valid targets, best and
    second-best per query (ties to the lowest column; the second-best is the
    least distance over every other column).  Returns (best (Na,) f32,
    second (Na,) f32, idx (Na,) int32), 1e9 and -1 where nothing passes."""
    D = hamming_matrix_packed_plain(desc_a, desc_b)
    ok = matcher.window_mask(uv_a.to(torch.float32), uv_b.to(torch.float32), float(radius))
    D = torch.where(ok & valid_b[None, :], D, matcher.BIG)
    best, idx = torch.min(D, dim=1)  # first occurrence of the minimum
    col = torch.arange(D.shape[1], device=D.device)
    second = torch.where(col[None, :] == idx[:, None], matcher.BIG, D).min(dim=1).values
    return best, second, torch.where(best < matcher.BIG, idx.to(torch.int32), -1)


def _check_words(what: str, dev, **tensors) -> None:
    for name, t in tensors.items():
        if dev.type != "cuda" or t.device != dev:
            raise ValueError(f"{what}: {name} must lie on the CUDA device {dev}")
        if t.dtype != torch.int32 or t.dim() != 2 or t.shape[1] != 8 or not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be a contiguous (N, 8) int32 tensor of "
                             "packed descriptor words")


def _hamming_launch(desc_a, desc_b):
    dev = desc_a.device
    _check_words("hamming_matrix_packed", dev, desc_a=desc_a, desc_b=desc_b)
    na, nb = desc_a.shape[0], desc_b.shape[0]
    out = torch.empty((na, nb), dtype=torch.float32, device=dev)
    fn = _cuda.load("hamming").hamming_matrix
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [vp, ci, vp, ci, vp, vp]
    fn.restype = ci
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(desc_a.data_ptr(), na, desc_b.data_ptr(), nb, out.data_ptr(), stream)
    _cuda.check(err, "hamming_matrix")
    return out


def hamming_matrix_packed(desc_a, desc_b):
    """(Na, 8) x (Nb, 8) packed words (int32 bit patterns) -> (Na, Nb) f32
    Hamming distances."""
    if desc_a.device.type == "cpu":
        return hamming_matrix_packed_plain(desc_a, desc_b)
    out = _hamming_launch(desc_a, desc_b)
    hamming_matrix_packed.launches += 1
    return out


def masked_cell_scale(radius) -> float:
    """The f32 1/s of the masked match's cells for a window ``radius`` (as
    the kernel rounds it to f32): 0 for an infinite radius (one cell), 1/MIN_CELL
    for a radius that is not positive or NaN.  Every pair within the window
    lies in neighbouring cells (``tests/test_torch_hamming.py`` holds a float32
    twin of the kernel's cell function to it)."""
    r = torch.tensor(float(radius), dtype=torch.float32).item()
    side = max(r * (1.0 + CELL_MARGIN), MIN_CELL) if r > 0 else MIN_CELL
    return torch.tensor(1.0 / side, dtype=torch.float32).item()


def masked_table_log2(nb: int) -> int:
    """log2 of the masked match's table side: the least lg in [2, 6] with
    about TARGETS_PER_SLOT targets or fewer in each of its 4**lg slots."""
    lg = 2
    while lg < 6 and TARGETS_PER_SLOT << (2 * lg) < nb:
        lg += 1
    return lg


def _masked_launch(desc_a, uv_a, desc_b, uv_b, valid_b, radius: float):
    dev = desc_a.device
    _check_words("fused_masked_match", dev, desc_a=desc_a, desc_b=desc_b)
    for name, t in (("desc_a", desc_a), ("desc_b", desc_b)):
        if t.data_ptr() % 16:
            raise ValueError(f"fused_masked_match: {name} must be 16-byte aligned")
    na, nb = desc_a.shape[0], desc_b.shape[0]
    for name, t, shape, dtype in (("uv_a", uv_a, (na, 2), torch.float32),
                                  ("uv_b", uv_b, (nb, 2), torch.float32),
                                  ("valid_b", valid_b, (nb,), torch.bool)):
        if t.device != dev or t.dtype != dtype or tuple(t.shape) != shape \
                or not t.is_contiguous():
            raise ValueError(f"fused_masked_match: {name} must be a contiguous {dtype} tensor "
                             f"of shape {shape} on {dev}")
    if nb > 1 << 20:
        raise ValueError(f"fused_masked_match: at most {1 << 20} targets, got {nb}")
    lib = _cuda.load("hamming")
    vp, ci, cf, cz = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_size_t
    lib.masked_match_scratch.argtypes = [ci, ci, ci]
    lib.masked_match_scratch.restype = cz
    lg = masked_table_log2(nb)
    n_scratch = lib.masked_match_scratch(na, nb, lg)
    scratch = torch.empty((n_scratch,), dtype=torch.uint8, device=dev)
    best = torch.empty((na,), dtype=torch.float32, device=dev)
    second = torch.empty((na,), dtype=torch.float32, device=dev)
    idx = torch.empty((na,), dtype=torch.int32, device=dev)
    fn = lib.masked_match
    fn.argtypes = [vp, vp, ci, vp, vp, vp, ci, cf, cf, ci, vp, cz, vp, vp, vp, vp]
    fn.restype = ci
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(desc_a.data_ptr(), uv_a.data_ptr(), na, desc_b.data_ptr(), uv_b.data_ptr(),
                 valid_b.data_ptr(), nb, float(radius), masked_cell_scale(radius), lg,
                 scratch.data_ptr(), n_scratch, best.data_ptr(), second.data_ptr(),
                 idx.data_ptr(), stream)
    _cuda.check(err, "masked_match")
    return best, second, idx


def fused_masked_match(desc_a, uv_a, desc_b, uv_b, valid_b, radius: float):
    """Nearest packed descriptor within the square window |du|, |dv| <=
    ``radius`` over valid targets, without the distance matrix.  Returns
    (best (Na,) f32, second (Na,) f32, idx (Na,) int32) as
    ``fused_masked_match_plain``."""
    if desc_a.device.type == "cpu":
        return fused_masked_match_plain(desc_a, uv_a, desc_b, uv_b, valid_b, radius)
    out = _masked_launch(desc_a, uv_a, desc_b, uv_b, valid_b, radius)
    fused_masked_match.launches += 1
    return out


hamming_matrix_packed.launches = 0
fused_masked_match.launches = 0
