"""The port's remaining ``io/`` modules and the demo on the CPU, against the
JAX package.

  * ``io/realism.py``: a 2-frame model-violating sequence (circle, odometry
    noise 0.02, sensor degradation on top) rendered by both packages, with
    the front camera's intrinsics scaled to a quarter of the image (the
    renderer's cost is per pixel; the code paths are the same): every image,
    mask, contour and pose exact; the perturbed configuration equal;
  * ``io/viz.py``: the overlays (``_gray_to_rgb``, ``_draw_squares``, the
    contour recolour, the status strip) and the ``FrameDrawer`` canvas exact
    against the JAX functions and the canvas JAX's ``save`` composes; the PNG
    written by the port's encoder decodes (zlib, filter 0) to the same
    array; ``plot_map`` writes a PNG holding the map's colours;
  * ``io/fixtures.py:make_realistic_map`` at a reduced capacity (K=16,
    P=512, PB=256, M=4, F=FB=64, where observation windows collide on
    feature slots): integer and boolean fields exact, floats within 1e-6
    relative (they are equal: the same draws, the same f32 operations);
  * ``io/tracing.py``: the four cases of ``tests/test_tracing.py``
    (spans and ``reset``, a disabled tracer, ``device_trace`` writing a trace,
    ``device_trace(None)``), and a pickled tracer;
  * ``demo.py``: the same command-line options as the JAX demo.  Its drive
    runs on the card (``chip_smoke.py`` phase 10): at the default capacity a
    CPU run takes minutes.

The JAX references are computed once per test run (``torch_refs.shared``).
"""

import contextlib
import dataclasses
import io
import pickle
import sys
import time
import zlib

import numpy as np
import pytest
import torch

from fishbirdeyevisualslam_tpu.config import CameraConfig as JaxCam
from fishbirdeyevisualslam_tpu.config import CapacityConfig as JaxCap
from fishbirdeyevisualslam_tpu.config import SystemConfig as JaxConfig
from fishbirdeyevisualslam_tpu.io import realism as j_realism
from fishbirdeyevisualslam_tpu.io import synthetic as j_syn
from fishbirdeyevisualslam_tpu.io import viz as j_viz
from fishbirdeyevisualslam_torch import convert
from fishbirdeyevisualslam_torch.io import fixtures as t_fixtures
from fishbirdeyevisualslam_torch.io import realism as t_realism
from fishbirdeyevisualslam_torch.io import synthetic as t_syn
from fishbirdeyevisualslam_torch.io import viz as t_viz
from fishbirdeyevisualslam_torch.io.tracing import Tracer, device_trace

import torch_refs

torch.set_num_threads(1)

# the front camera at a quarter of the image size (intrinsics scaled with it)
_CAM = dict(fx=348.5 / 4, fy=347.0 / 4, cx=480.0 / 4, cy=302.0 / 4, width=238, height=100)
JCFG_SMALL = JaxConfig().replace(camera=JaxCam(**_CAM))
TCFG_SMALL = convert.config_from_dict(dataclasses.asdict(JCFG_SMALL))
FIX_CAP = dict(max_keyframes=16, max_points=512, max_bird_points=256, max_obs_per_point=4,
               max_front_kp=64, max_bird_kp=64)
JCFG_FIX = JaxConfig().replace(capacity=JaxCap(**FIX_CAP))
TCFG_FIX = convert.config_from_dict(dataclasses.asdict(JCFG_FIX))
REAL_KW = dict(n_frames=2, kind="circle", odom_noise=0.02, seed=0)


def _jax_realism():
    seq = j_realism.make_real_sequence(JCFG_SMALL, degrade=j_syn.DegradeConfig(), **REAL_KW)
    return dict(realism=dict(gt=seq.gt, odom=seq.odom, frames=seq.frames),
                perturbed=dataclasses.asdict(j_realism._perturbed_cfg(
                    JCFG_SMALL, j_realism.RealismConfig(), 0)))


def _jax_fixture():
    from fishbirdeyevisualslam_tpu.io.fixtures import make_realistic_map
    return {k: np.asarray(v) for k, v in make_realistic_map(JCFG_FIX, seed=3)._asdict().items()}


torch_refs.register("torch_io_realism", __file__, _jax_realism, cost=4.0)
torch_refs.register("torch_io_fixture", __file__, _jax_fixture, cost=5.0)


@pytest.fixture(scope="module")
def ref(request, tmp_path_factory):
    return torch_refs.shared(request, tmp_path_factory, "torch_io_realism")


@pytest.fixture(scope="module")
def fixture_ref(request, tmp_path_factory):
    return torch_refs.shared(request, tmp_path_factory, "torch_io_fixture")


# ---------------------------------------------------------------------------
# realism
# ---------------------------------------------------------------------------


def test_realism_sequence_matches_jax(ref):
    seq = t_realism.make_real_sequence(TCFG_SMALL, degrade=t_syn.DegradeConfig(), **REAL_KW)
    want = ref["realism"]
    np.testing.assert_array_equal(seq.gt, want["gt"])
    np.testing.assert_array_equal(seq.odom, want["odom"])
    for got_f, want_f in zip(seq.frames, want["frames"]):
        assert set(got_f) == set(want_f)
        for k, w in want_f.items():
            np.testing.assert_array_equal(np.asarray(got_f[k]), np.asarray(w), err_msg=k)
    assert seq.frames[0]["front"].shape == (100, 238)
    assert np.abs(seq.frames[0]["front"] - seq.frames[1]["front"]).mean() > 1.0


def test_realism_perturbed_cfg_matches_jax(ref):
    got = t_realism._perturbed_cfg(TCFG_SMALL, t_realism.RealismConfig(), 0)
    assert dataclasses.asdict(got) == ref["perturbed"]
    assert got.extrinsics != TCFG_SMALL.extrinsics


# ---------------------------------------------------------------------------
# viz
# ---------------------------------------------------------------------------


def _overlay_inputs(seed=0):
    rng = np.random.RandomState(seed)
    img = rng.rand(60, 80).astype(np.float32) * 300 - 20        # clipped to [0, 255]
    uv = np.concatenate([rng.uniform(-2, 82, (40, 2)), [[0.4, 0.4], [79.6, 59.6]]])
    matched = rng.rand(42) < 0.5
    valid = rng.rand(42) < 0.8
    contour = np.where(rng.rand(60, 80) < 0.1, 20.0, 255.0).astype(np.float32)
    return img, uv, matched, valid, contour


@pytest.mark.parametrize("state", [0, 1, 2, 5])
def test_frame_overlay_matches_jax(state):
    img, uv, matched, valid, _ = _overlay_inputs(state)
    want = j_viz.draw_frame_overlay(img, uv, matched, valid, state=state)
    got = t_viz.draw_frame_overlay(torch.from_numpy(img), torch.from_numpy(uv),
                                   torch.from_numpy(matched), torch.from_numpy(valid), state=state)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        t_viz.draw_frame_overlay(img, uv, matched, valid, state=state, n_tracked=17),
        j_viz.draw_frame_overlay(img, uv, matched, valid, state=state, n_tracked=17))


@pytest.mark.parametrize("with_contour", [False, True])
def test_bird_overlay_matches_jax(with_contour):
    img, uv, matched, valid, contour = _overlay_inputs(7)
    c = contour if with_contour else None
    want = j_viz.draw_bird_overlay(img, uv, matched, valid, contour=c)
    got = t_viz.draw_bird_overlay(img, uv, matched, valid,
                                  contour=None if c is None else torch.from_numpy(c))
    np.testing.assert_array_equal(got, want)


class _Frame:
    def __init__(self, rng, tensors: bool):
        wrap = torch.from_numpy if tensors else (lambda x: x)
        self.uv_raw = wrap(rng.uniform(0, 80, (30, 2)).astype(np.float32))
        self.kp_valid = wrap(rng.rand(30) < 0.9)
        self.bird_uv = wrap(rng.uniform(0, 50, (20, 2)).astype(np.float32))
        self.bird_kp_valid = wrap(rng.rand(20) < 0.9)


class _Assoc:
    def __init__(self, rng, tensors: bool):
        wrap = torch.from_numpy if tensors else (lambda x: x)
        self.mp_idx = wrap(np.where(rng.rand(30) < 0.5, 3, -1).astype(np.int32))
        self.bp_idx = wrap(np.where(rng.rand(20) < 0.5, 2, -1).astype(np.int32))


class _System:
    def __init__(self, tensors: bool, with_assoc: bool):
        self.last_frame = _Frame(np.random.RandomState(1), tensors)
        self.last_assoc = _Assoc(np.random.RandomState(2), tensors) if with_assoc else None
        self.state = 1


def _png_pixels(path) -> np.ndarray:
    """Decode an 8-bit RGB PNG of one IDAT chunk with filter type 0."""
    data = open(path, "rb").read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    chunks, pos = {}, 8
    while pos < len(data):
        n = int.from_bytes(data[pos:pos + 4], "big")
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + n]
        assert zlib.crc32(kind + body) == int.from_bytes(data[pos + 8 + n:pos + 12 + n], "big")
        chunks[kind] = body
        pos += 12 + n
    w, h = int.from_bytes(chunks[b"IHDR"][:4], "big"), int.from_bytes(chunks[b"IHDR"][4:8], "big")
    assert chunks[b"IHDR"][8:10] == bytes([8, 2]) and b"IEND" in chunks
    raw = np.frombuffer(zlib.decompress(chunks[b"IDAT"]), np.uint8).reshape(h, 1 + 3 * w)
    assert (raw[:, 0] == 0).all()
    return raw[:, 1:].reshape(h, w, 3)


@pytest.mark.parametrize("with_assoc", [False, True])
def test_frame_drawer_canvas_and_png(tmp_path, with_assoc):
    rng = np.random.RandomState(3)
    front = rng.rand(40, 80).astype(np.float32) * 255
    bird = rng.rand(50, 50).astype(np.float32) * 255
    contour = np.where(rng.rand(50, 50) < 0.1, 0.0, 255.0).astype(np.float32)
    jd, td = j_viz.FrameDrawer(), t_viz.FrameDrawer()
    jd.update(_System(False, with_assoc), front, bird, contour=contour)
    td.update(_System(True, with_assoc), torch.from_numpy(front), torch.from_numpy(bird),
              contour=torch.from_numpy(contour))
    # the canvas JAX's save composes before handing it to its image writer
    hf, wf = jd._front.shape[:2]
    hb, wb = jd._bird.shape[:2]
    want = np.zeros((max(hf, hb), wf + wb, 3), np.uint8)
    want[:hf, :wf], want[:hb, wf:] = jd._front, jd._bird
    np.testing.assert_array_equal(td.canvas(), want)
    p = tmp_path / "frame.png"
    td.save(str(p))
    np.testing.assert_array_equal(_png_pixels(p), want)
    assert t_viz.FrameDrawer().canvas() is None


def test_png_encoder_read_back_by_the_dataset_reader(tmp_path):
    """A PNG of the port's encoder read by ``io/dataset.py``'s image reader
    (no plotting library): the grey levels of an image written as RGB."""
    from fishbirdeyevisualslam_torch.io import dataset
    gray = np.random.RandomState(4).randint(0, 256, (30, 50)).astype(np.uint8)
    p = tmp_path / "g.png"
    t_viz.write_png(str(p), np.stack([gray] * 3, -1))
    np.testing.assert_allclose(dataset._imread_gray(str(p)), gray.astype(np.float32), atol=1e-4)


def test_plot_map_png(tmp_path):
    m = t_fixtures.make_realistic_map(TCFG_FIX, seed=1, device="cpu")
    m = m._replace(kf_valid=m.kf_valid & (torch.arange(16) % 5 != 3))
    gt = np.stack([np.linspace(0, 5, 20), np.linspace(0, 2, 20), np.zeros(20)], -1)
    est = np.zeros((20, 7))
    est[:, 4:6] = gt[:, :2]
    p = tmp_path / "map.png"
    t_viz.plot_map(m, TCFG_FIX, str(p), gt_se2=gt, est_Twb=est)
    img = _png_pixels(p)
    assert img.shape == (t_viz.MAP_PX, t_viz.MAP_PX, 3)
    packed = np.unique(img.reshape(-1, 3).astype(np.int64) @ np.array([65536, 256, 1]))
    for c in (t_viz._GREY, t_viz._BIRD, t_viz._KF, t_viz._EST, t_viz._GT, t_viz._EDGE):
        assert c[0] * 65536 + c[1] * 256 + c[2] in packed, c


# ---------------------------------------------------------------------------
# fixtures
# ---------------------------------------------------------------------------


def test_make_realistic_map_matches_jax(fixture_ref):
    got = convert.map_state_to_numpy(t_fixtures.make_realistic_map(TCFG_FIX, seed=3,
                                                                   device="cpu"))
    for k, w in fixture_ref.items():
        g = got[k]
        if w.dtype.kind == "f":
            np.testing.assert_allclose(g, w, rtol=1e-6, atol=0, err_msg=k)
        else:
            np.testing.assert_array_equal(g, w.astype(g.dtype), err_msg=k)
    assert got["kf_valid"].all() and got["mp_valid"].all() and got["bp_valid"].all()
    assert (got["kf_uv"] != 0).any(axis=-1).sum() > 0.9 * 16 * 64


# ---------------------------------------------------------------------------
# tracing (tests/test_tracing.py's cases) and the demo
# ---------------------------------------------------------------------------


def test_tracer_spans_accumulate():
    tr = Tracer()
    for _ in range(3):
        with tr.span("work"):
            time.sleep(0.002)
    rep = tr.report()
    assert rep["work"]["count"] == 3
    assert rep["work"]["total_s"] >= 0.006
    assert rep["work"]["max_s"] >= rep["work"]["mean_s"]
    back = pickle.loads(pickle.dumps(tr))
    assert back.report()["work"]["count"] == 3 and back.enabled
    tr.reset()
    assert tr.report() == {}


def test_tracer_disabled_is_free():
    tr = Tracer(enabled=False)
    with tr.span("x"):
        pass
    assert tr.report() == {}
    assert not pickle.loads(pickle.dumps(tr)).enabled


def test_device_trace_writes_profile(tmp_path):
    d = tmp_path / "trace"
    with device_trace(str(d)):
        torch.ones(8).sum().item()
    files = list(d.rglob("*.json"))
    assert files and files[0].stat().st_size > 0


def test_device_trace_none_noop():
    with device_trace(None):
        pass


def _options(main, argv0: str) -> set:
    """The option strings a demo's ``--help`` lists."""
    out, saved = io.StringIO(), sys.argv
    sys.argv = [argv0, "--help"]
    try:
        with contextlib.redirect_stdout(out), pytest.raises(SystemExit):
            main()
    finally:
        sys.argv = saved
    return {w.strip(",[]") for w in out.getvalue().split() if w.startswith(("--", "[--"))}


def test_demo_options_match_jax():
    from fishbirdeyevisualslam_tpu import demo as j_demo
    from fishbirdeyevisualslam_torch import demo as t_demo
    want = _options(j_demo.main, "demo")
    assert want >= {"--frames", "--kind", "--no-contour", "--step", "--odom-noise", "--cpu",
                    "--out-prefix", "--draw-every"}
    assert _options(t_demo.main, "demo") == want
