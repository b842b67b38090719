"""Parity of the port's packed Hamming kernels' plain versions
(``ops/cuda_matcher.py``: ``hamming_matrix_packed_plain`` and
``fused_masked_match_plain``) with the JAX package's Pallas kernels
(``ops/pallas_matcher.py``, in interpret mode) at the sizes of
``tests/test_pallas_matcher.py``, exactly: forced ties inside one of the
Pallas kernel's 512-column tiles and across two, and a case with no valid
target.  On the CPU the wrappers run the plain versions.  The Pallas side
of every case is computed once per run (``torch_refs.shared``)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from fishbirdeyevisualslam_tpu.ops import pallas_matcher as j_pm
from fishbirdeyevisualslam_torch.ops import cuda_matcher

import torch_refs

torch.set_num_threads(1)


def _words(rng, n):
    return rng.randint(0, 2**32, (n, 8), dtype=np.uint64).astype(np.uint32)


def _t(x):
    x = np.ascontiguousarray(x)
    return torch.from_numpy(x.view(np.int32) if x.dtype == np.uint32 else x)


MATRIX_SHAPES = [(100, 130), (64, 64)]
MASKED_CASES = ["random", "ties", "no valid target"]


def _matrix_problem(na, nb):
    rng = np.random.RandomState(na)
    a, b = _words(rng, na), _words(rng, nb)
    a[3] = b[7]   # a zero distance
    return a, b


def _jax_refs():
    """The Pallas kernels' results (interpret mode) for every case, as numpy."""
    refs = {}
    for na, nb in MATRIX_SHAPES:
        a, b = _matrix_problem(na, nb)
        refs["matrix", na, nb] = np.asarray(
            j_pm.hamming_matrix_packed(jnp.asarray(a), jnp.asarray(b), interpret=True))
    for case in MASKED_CASES:
        a, uv_a, b, uv_b, valid, r = _masked_problem(case)
        refs["masked", case] = tuple(np.asarray(x) for x in j_pm.fused_masked_match(
            jnp.asarray(a), jnp.asarray(uv_a), jnp.asarray(b), jnp.asarray(uv_b),
            jnp.asarray(valid), r, interpret=True))
    return refs


torch_refs.register("torch_hamming_jax", __file__, _jax_refs)


@pytest.fixture(scope="module")
def jax_refs(request, tmp_path_factory):
    return torch_refs.shared(request, tmp_path_factory, "torch_hamming_jax")


@pytest.mark.parametrize("na,nb", MATRIX_SHAPES)
def test_hamming_matrix_matches_jax(jax_refs, na, nb):
    a, b = _matrix_problem(na, nb)
    ref = jax_refs["matrix", na, nb]
    got = cuda_matcher.hamming_matrix_packed_plain(_t(a), _t(b))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), ref)
    assert torch.equal(cuda_matcher.hamming_matrix_packed(_t(a), _t(b)), got)


def _masked_problem(case):
    """test_pallas_matcher.py's sizes (200 x 600, radius 60): ties for query 0
    at columns 100 and 560 (across the Pallas kernel's 512-column tiles),
    for query 1 at columns 20 and 21 (inside one), or no valid target."""
    rng = np.random.RandomState(2)
    na, nb = 200, 600
    a, b = _words(rng, na), _words(rng, nb)
    uv_a = (rng.rand(na, 2) * 400).astype(np.float32)
    uv_b = (rng.rand(nb, 2) * 400).astype(np.float32)
    valid = rng.rand(nb) > 0.2
    if case == "ties":
        for q, cols in ((0, [100, 560]), (1, [20, 21])):
            b[cols], uv_b[cols], valid[cols] = a[q], uv_a[q], True
        b[300], uv_b[300], valid[300] = a[2], uv_a[2], False   # an invalid exact match
    if case == "no valid target":
        valid[:] = False
    return a, uv_a, b, uv_b, valid, 60.0


@pytest.mark.parametrize("case", MASKED_CASES)
def test_fused_masked_match_matches_jax(jax_refs, case):
    a, uv_a, b, uv_b, valid, r = _masked_problem(case)
    ref = jax_refs["masked", case]
    args = (_t(a), _t(uv_a), _t(b), _t(uv_b), _t(valid), r)
    got = cuda_matcher.fused_masked_match_plain(*args)
    assert [x.dtype for x in got] == [torch.float32, torch.float32, torch.int32]
    for x, y in zip(got, ref):
        np.testing.assert_array_equal(x.numpy(), np.asarray(y))
    for x, y in zip(cuda_matcher.fused_masked_match(*args), got):
        assert torch.equal(x, y)
    if case == "ties":
        assert got[2][:2].tolist() == [100, 20] and got[1][:2].tolist() == [0.0, 0.0]
        assert got[2][2] != 300
    if case == "no valid target":
        assert (got[2] == -1).all() and (got[0] == 1e9).all() and (got[1] == 1e9).all()


# the masked match's cells (csrc/hamming.cu: cell; ops/cuda_matcher.py picks
# their side): torch and numpy only, no JAX reference


def _cell(u, inv_s):
    """float32 twin of csrc/hamming.cu:cell: floor(u / s) from the f32 1/s,
    positions clamped to +-1e30 (NaN to -1e30) and cells to +-32768."""
    x = np.fmin(np.fmax(np.asarray(u, np.float32), np.float32(-1e30)), np.float32(1e30))
    q = np.fmin(np.fmax(x * np.float32(inv_s), np.float32(-32768)), np.float32(32768))
    return np.floor(q).astype(np.int64)


@pytest.mark.parametrize("radius", [0.0, -1.0, float("nan"), 1e-3, 0.5, 1.0, 37.3, 50.0, 60.0,
                                    1e4, 3e38, float("inf")])
def test_masked_match_cells_hold_every_window(radius):
    """Every pair that passes the f32 window test |u1 - u2| <= r lies in
    neighbouring cells for the side the wrapper picks, so a query's 3 x 3
    cells hold every target it can match: uniform draws at several scales,
    the cells' edges and one or two ulps either side, the clamp's edge,
    infinities and NaN, each against partners at exactly +-r, one ulp inside
    and outside, and uniform within the window."""
    inv = cuda_matcher.masked_cell_scale(radius)
    rf = np.float32(radius)
    side = np.float32(1.0 / inv) if inv > 0 else np.float32(1e6)
    rng = np.random.RandomState(0)
    with np.errstate(over="ignore"):
        edges = (np.arange(-60, 60, dtype=np.float32) * side).astype(np.float32)
        edges = np.append(edges, np.float32([32767, 32768, 32769]) * side)
        near = [edges, np.nextafter(edges, np.float32(np.inf)),
                np.nextafter(edges, np.float32(-np.inf))]
        near += [np.nextafter(near[1], np.float32(np.inf)),
                 np.nextafter(near[2], np.float32(-np.inf))]
    u = np.concatenate(near + [rng.uniform(-1e3, 1e3, 3000), rng.uniform(-2e6, 2e6, 3000),
                               rng.uniform(-10, 10, 2000),
                               np.array([0.0, -0.0, 1e6, -1e6, 3e38, np.inf, -np.inf, np.nan])]
                       ).astype(np.float32)
    r_fin = rf if np.isfinite(rf) and rf > 0 else np.float32(0.0)
    steps = [np.float32(0.0), r_fin, -r_fin, np.nextafter(r_fin, np.float32(0)),
             -np.nextafter(r_fin, np.float32(0)), np.nextafter(r_fin, np.float32(np.inf))]
    with np.errstate(invalid="ignore", over="ignore"):
        for d in steps + [rng.uniform(-1, 1, u.shape).astype(np.float32) * r_fin]:
            u2 = (u + d).astype(np.float32)
            ok = np.abs(u - u2) <= rf
            far = np.abs(_cell(u, inv) - _cell(u2, inv)) > 1
            assert not np.any(ok & far), (radius, u[ok & far][:5], u2[ok & far][:5])
        if np.isinf(rf):   # every pair at a finite distance, infinities included
            v = np.array([0.0, -5e3, 7e5, 3e38, -3e38, np.inf, -np.inf], np.float32)
            ok = np.abs(v[:, None] - v[None, :]) <= rf
            assert np.all(_cell(v, inv)[:, None] == _cell(v, inv)[None, :]) and ok.sum() > 40
    assert 2 <= cuda_matcher.masked_table_log2(1) <= cuda_matcher.masked_table_log2(16384) == 5
    assert cuda_matcher.masked_table_log2(1 << 20) == 6
