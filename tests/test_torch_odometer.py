"""The port's IPM edge filter and bird odometer on the CPU, against the JAX
package.

  * ``ops/edge_filter.py`` on the 64x64 cases of ``tests/test_edge_filter.py``
    (Otsu, Canny on a step and through a weak chain, component sizes, small
    edges, the radial streak) and on a 384x384 bird render and a noisy
    image with a lane marking (the full ``filter_ipm_edges``): exact.
  * The erosion: the JAX package erodes 3x3 whatever the radius (its
    ``_shift`` pads one pixel and ``lax.dynamic_slice`` clamps the larger
    shifts back to one), where the reference erodes the freespace 7x7
    (``edge_filter_ipm.cpp:129-144``).  The port erodes 7x7: its erosion at
    radius 1 equals JAX's at radius 3, at radius 3 it equals a 7x7 minimum
    filter, and the full pipeline is held exactly against JAX's with its
    ``_shift`` swapped, for the reference run only, for one that pads by
    the shift (ROADMAP, queue 3).
  * ``slam/bird_odometer.py`` on a pair of renders 0.3 m apart (world 4):
    ``edge_cloud``, ``edge_cloud_filtered`` and ``build_ndt_grid`` exact;
    ``icp_se2`` and ``ndt_se2`` within 1e-4 (their sums run in another
    order: measured within 3e-7); a 3-frame ``BirdOdometer`` run in both
    modes, poses within 1e-4 m.

The JAX references are computed once per test run (``torch_refs.shared``).
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.ndimage import minimum_filter

from fishbirdeyevisualslam_tpu.config import SystemConfig as JaxConfig
from fishbirdeyevisualslam_tpu.io import synthetic as j_syn
from fishbirdeyevisualslam_tpu.ops import edge_filter as j_ef
from fishbirdeyevisualslam_tpu.slam import bird_odometer as j_bo
from fishbirdeyevisualslam_torch.config import SystemConfig
from fishbirdeyevisualslam_torch.ops import edge_filter as t_ef
from fishbirdeyevisualslam_torch.slam import bird_odometer as t_bo

import torch_refs

torch.set_num_threads(1)

CFG, JCFG = SystemConfig(), JaxConfig()
SE2_TOL = 1e-4
T = torch.from_numpy


def _shift_by_shift(x, dy: int, dx: int, fill):
    """JAX's ``_shift`` padded by the shift itself, so that shifts beyond one
    pixel are not clamped back to one."""
    H, W = x.shape
    r = max(abs(dy), abs(dx), 1)
    p = jnp.pad(x, ((r, r), (r, r)), constant_values=fill)
    return jax.lax.dynamic_slice(p, (r - dy, r - dx), (H, W))


@contextlib.contextmanager
def _meant_erosion():
    """JAX's edge filter, cloud and odometer traced afresh with
    ``_shift_by_shift`` in place of ``_shift``."""
    saved = (j_ef._shift, j_ef.filter_ipm_edges, j_bo.edge_cloud_filtered)
    j_ef._shift = _shift_by_shift
    j_ef.filter_ipm_edges = jax.jit(saved[1].__wrapped__)
    j_bo.edge_cloud_filtered = jax.jit(saved[2].__wrapped__, static_argnums=(2, 3))
    try:
        yield
    finally:
        j_ef._shift, j_ef.filter_ipm_edges, j_bo.edge_cloud_filtered = saved


def _cases():
    """The 64x64 images of tests/test_edge_filter.py and the renders."""
    rng = np.random.RandomState(0)
    bimodal = (np.where(rng.rand(64, 64) < 0.5, 40.0, 200.0)
               + rng.randn(64, 64) * 5).astype(np.float32)
    step = np.zeros((64, 64), np.float32)
    step[:, 32:] = 200.0
    chain = np.zeros((64, 64), np.float32)
    for r in range(64):
        chain[r, 32:] = 200.0 if 28 <= r < 36 else 60.0
    comp = np.zeros((32, 32), bool)
    comp[4, 2:12] = True
    comp[20:22, 20:23] = True
    small = np.zeros((32, 32), bool)
    small[4, 2:30] = True
    small[20, 5:10] = True
    radial = np.zeros((96, 96), np.float32)
    radial[46:50, 8:44] = 200.0
    radial[20:76, 80:84] = 200.0
    b = CFG.bird
    noisy = (rng.rand(b.rows, b.cols) * 30 + 80).astype(np.float32)
    noisy[100:104, 50:200] = 220.0
    world = j_syn.make_world(4)
    gt = j_syn.make_trajectory(8, kind="straight", step=0.3)
    renders = []
    for p in gt[:3]:
        bird = j_syn.render_bird(world, JCFG, p).astype(np.float32)
        mask, _ = j_syn.bird_mask_and_contour(JCFG, bird)
        renders.append((bird, mask.astype(np.float32)))
    erode = rng.rand(40, 40) > 0.1
    vmask = rng.choice([0, 50, 100, 150, 200, 255], size=(64, 64)).astype(np.float32)
    return dict(bimodal=bimodal, step=step, chain=chain, comp=comp, small=small, radial=radial,
                noisy=noisy, free=np.full((b.rows, b.cols), 255.0, np.float32), renders=renders,
                erode=erode, vmask=vmask)


def _jax_filter_refs():
    """The edge filter's references."""
    c = _cases()
    J = jnp.asarray
    out = dict(inputs=c)
    out["otsu"] = j_ef.otsu_threshold(J(c["bimodal"]))
    out["canny_step"] = j_ef.canny(J(c["step"]), 50.0, 100.0)
    out["canny_chain"] = j_ef.canny(J(c["chain"]), 30.0, 150.0)
    out["comp"] = j_ef.component_sizes(J(c["comp"]))
    out["small"] = j_ef.remove_small_edges(J(c["small"]), min_size=20)
    edge, gx, gy = j_ef.canny(J(c["radial"]), 100.0, 300.0)
    out["radial"] = j_ef.remove_radial_artifacts(
        edge, gx, gy, 15.0, jnp.zeros((96, 96), jnp.int32), J([[48.0, 48.0]]), min_len=20)
    out["erode"] = j_ef.erode(J(c["erode"]), 3)
    out["view"] = j_ef.default_view_index((384, 384))
    out["view_mask"] = j_ef.view_index_from_mask(J(c["vmask"]))
    b0, m0 = c["renders"][0]
    with _meant_erosion():
        out["filter_noisy"] = j_ef.filter_ipm_edges(J(c["noisy"]), J(c["free"]))
        out["filter_render"] = j_ef.filter_ipm_edges(J(b0), J(m0 * 255.0))
    return jax.tree.map(np.asarray, out)


def _jax_odometer_refs():
    """The odometer's references (a registered fixture of its own, so that
    another worker can compute it meanwhile)."""
    c = _cases()
    J = jnp.asarray
    out = dict(inputs=c)
    (b0, m0), (b1, m1), _ = c["renders"]
    with _meant_erosion():
        out["cloud_filtered"] = j_bo.edge_cloud_filtered(J(b0), J(m0 * 255.0), JCFG)
        out["odometer filtered"] = _drive(j_bo.BirdOdometer(JCFG, use_edge_filter=True),
                                          c["renders"])
    ref, cur = j_bo.edge_cloud(J(b0), J(m0), JCFG), j_bo.edge_cloud(J(b1), J(m1), JCFG)
    grid = j_bo.build_ndt_grid(ref)
    out.update(cloud_ref=ref, cloud_cur=cur, grid=grid,
               ndt=j_bo.ndt_se2(grid, cur, jnp.zeros(3)),
               icp=j_bo.icp_se2(ref, cur, jnp.zeros(3)))
    for method in ("ndt", "icp"):
        out[f"odometer {method}"] = _drive(j_bo.BirdOdometer(JCFG, method=method), c["renders"])
    return jax.tree.map(np.asarray, out)


def _drive(odo, renders):
    return np.stack([odo.add_new_frame(b, m) for b, m in renders])


torch_refs.register("torch_edge_filter", __file__, _jax_filter_refs, cost=5.0)
torch_refs.register("torch_odometer", __file__, _jax_odometer_refs, cost=7.0)


@pytest.fixture(scope="module")
def fref(request, tmp_path_factory):
    return torch_refs.shared(request, tmp_path_factory, "torch_edge_filter")


@pytest.fixture(scope="module")
def ref(request, tmp_path_factory):
    return torch_refs.shared(request, tmp_path_factory, "torch_odometer")


def _eq(got, want):
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# the edge filter
# ---------------------------------------------------------------------------


def test_otsu(fref):
    t = t_ef.otsu_threshold(T(fref["inputs"]["bimodal"]))
    _eq(t, fref["otsu"])
    assert 45 < float(t) < 190


@pytest.mark.parametrize("case,lo,hi", [("canny_step", 50.0, 100.0),
                                        ("canny_chain", 30.0, 150.0)])
def test_canny(fref, case, lo, hi):
    got = t_ef.canny(T(fref["inputs"][case.split("_")[1]]), lo, hi)
    for g, w in zip(got, fref[case]):
        _eq(g, w)
    e = got[0].numpy()
    if case == "canny_step":
        assert e[:, :28].sum() == 0 and e[16, 31:33].any()
    else:                                    # weak pixels joined through the chain
        assert e[10, 31] or e[10, 32]


def test_component_sizes_and_small_edges(fref):
    sizes = t_ef.component_sizes(T(fref["inputs"]["comp"]))
    _eq(sizes, fref["comp"])
    assert sizes[4, 5] == 10 and sizes[20, 21] == 6 and sizes[0, 0] == 0
    out = t_ef.remove_small_edges(T(fref["inputs"]["small"]), 20)
    _eq(out, fref["small"])
    assert out[4, 10] and not out[20, 7]


def test_radial_artifacts(fref):
    edge, gx, gy = t_ef.canny(T(fref["inputs"]["radial"]), 100.0, 300.0)
    out = t_ef.remove_radial_artifacts(edge, gx, gy, 15.0, torch.zeros((96, 96), dtype=torch.int32),
                                       torch.tensor([[48.0, 48.0]]), min_len=20)
    _eq(out, fref["radial"])
    pre, post = edge[42:54, 10:42].sum(), out[42:54, 10:42].sum()
    assert post < 0.2 * pre and out[30:66, 78:86].sum() > 20


def test_erosion(fref):
    m = fref["inputs"]["erode"]
    _eq(t_ef.erode(T(m), 1), fref["erode"])          # JAX's radius-3 erosion is 3x3
    want = minimum_filter(m, size=7, mode="constant", cval=False)
    np.testing.assert_array_equal(t_ef.erode(T(m), 3).numpy(), want)
    assert (want != np.asarray(fref["erode"])).any()


def test_view_indices(fref):
    _eq(t_ef.default_view_index((384, 384)), fref["view"])
    _eq(t_ef.view_index_from_mask(T(fref["inputs"]["vmask"])), fref["view_mask"])


@pytest.mark.parametrize("case", ["filter_noisy", "filter_render"])
def test_filter_ipm_edges(fref, case):
    c = fref["inputs"]
    args = (c["noisy"], c["free"]) if case == "filter_noisy" else \
        (c["renders"][0][0], c["renders"][0][1] * 255.0)
    got = t_ef.filter_ipm_edges(T(args[0]), T(args[1]))
    for g, w in zip(got, fref[case]):
        _eq(g, w)
    assert fref[case][1].sum() > 50


# ---------------------------------------------------------------------------
# the odometer
# ---------------------------------------------------------------------------


def _clouds(ref):
    (b0, m0), (b1, m1), _ = ref["inputs"]["renders"]
    return t_bo.edge_cloud(T(b0), T(m0), CFG), t_bo.edge_cloud(T(b1), T(m1), CFG)


def test_edge_clouds(ref):
    a, b = _clouds(ref)
    for got, want in ((a, ref["cloud_ref"]), (b, ref["cloud_cur"])):
        _eq(got.xy, want.xy)
        _eq(got.valid, want.valid)
    assert int(a.valid.sum()) > 300 and float(a.xy.abs().max()) < 12.0
    b0, m0 = ref["inputs"]["renders"][0]
    f = t_bo.edge_cloud_filtered(T(b0), T(m0 * 255.0), CFG)
    _eq(f.xy, ref["cloud_filtered"].xy)
    _eq(f.valid, ref["cloud_filtered"].valid)
    assert int(f.valid.sum()) > 100


def test_ndt_grid(ref):
    grid = t_bo.build_ndt_grid(_clouds(ref)[0])
    for g, w in zip(grid, ref["grid"]):
        _eq(g, w)
    assert int(grid.ok.sum()) > 10


@pytest.mark.parametrize("method", ["ndt", "icp"])
def test_registration(ref, method):
    a, b = _clouds(ref)
    if method == "ndt":
        got = t_bo.ndt_se2(t_bo.build_ndt_grid(a), b, torch.zeros(3))
    else:
        got = t_bo.icp_se2(a, b, torch.zeros(3))
    np.testing.assert_allclose(got.numpy(), ref[method], atol=SE2_TOL)
    assert abs(float(got[0]) - 0.3) < 0.05            # the 0.3 m step


@pytest.mark.parametrize("method,edge_filter", [("ndt", False), ("icp", False), ("ndt", True)])
def test_bird_odometer(ref, method, edge_filter):
    odo = t_bo.BirdOdometer(CFG, method=method, use_edge_filter=edge_filter, device="cpu")
    got = _drive(odo, ref["inputs"]["renders"])
    want = ref["odometer filtered" if edge_filter else f"odometer {method}"]
    np.testing.assert_allclose(got, want, atol=SE2_TOL)
    d = np.linalg.norm(np.diff(got[:, :2], axis=0), axis=1)
    assert np.all(np.abs(d - 0.3) < 0.12), d
