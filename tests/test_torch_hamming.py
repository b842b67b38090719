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
