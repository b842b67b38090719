"""The port's native runtime, map checkpoints and dataset reader on the CPU,
against the JAX package's.

``runtime/native.py``'s ``AsyncPipeline`` and ``Prefetcher`` on the cases of
``tests/test_runtime.py`` and ``tests/test_prefetcher.py``, native (the port
has no Python fallback); ``io/checkpoint.py``'s round trip, exact, and its
files against the JAX package's ``save_map`` / ``load_map`` on a numpy-built
map (``torch_scenes.slice_scene``), field for field; ``io/dataset.py`` on
``tests/test_dataset.py``'s cases at a quarter-size camera, and drives
exported by either package read back through both readers as equal arrays.
"""

import dataclasses
import os
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fishbirdeyevisualslam_tpu.io import checkpoint as j_ckpt
from fishbirdeyevisualslam_tpu.io import dataset as j_ds
from fishbirdeyevisualslam_tpu.slam import map_state as j_ms
from fishbirdeyevisualslam_torch import convert
from fishbirdeyevisualslam_torch.config import SystemConfig
from fishbirdeyevisualslam_torch.io import checkpoint, dataset, synthetic
from fishbirdeyevisualslam_torch.runtime import native
from fishbirdeyevisualslam_torch.runtime.native import AsyncPipeline, Prefetcher
from fishbirdeyevisualslam_torch.slam import map_state as t_ms

from torch_scenes import slice_scene

# test_dataset.py's drives at a quarter of the camera and bird sizes
SMALL = SystemConfig()
SMALL = SMALL.replace(
    camera=dataclasses.replace(SMALL.camera, width=SMALL.camera.width // 4,
                               height=SMALL.camera.height // 4, fx=SMALL.camera.fx / 4,
                               fy=SMALL.camera.fy / 4, cx=SMALL.camera.cx / 4,
                               cy=SMALL.camera.cy / 4),
    bird=dataclasses.replace(SMALL.bird, rows=SMALL.bird.rows // 4, cols=SMALL.bird.cols // 4,
                             pixel2meter=SMALL.bird.pixel2meter * 4,
                             meter2pixel=SMALL.bird.meter2pixel / 4))


# ---------------------------------------------------------------------------
# the native runtime (tests/test_runtime.py, tests/test_prefetcher.py)
# ---------------------------------------------------------------------------


def test_library_builds_into_build_dir():
    lib = native.get_library()
    assert lib is not None
    path = native.library_path()
    assert path.exists() and path.parent.name == "runtime" and path.parent.parent.name == "build"


def test_pipeline_items_flow_through_stages():
    log = {0: [], 1: [], 2: []}
    p = AsyncPipeline([lambda st, item: log[st].append(item) for _ in range(3)], capacity=4)
    try:
        assert p.is_native
        for i in range(12):
            p.submit(i)
        p.flush()
        for s in range(3):
            assert log[s] == list(range(12)), (s, log[s])
            assert p.processed(s) == 12
            assert p.queue_depth(s) == 0
    finally:
        p.close()


def test_pipeline_backpressure():
    done = []

    def slow(stage, item):
        time.sleep(0.005)
        done.append(item)

    p = AsyncPipeline([slow], capacity=2)
    try:
        t0 = time.time()
        for i in range(10):
            p.submit(i)
        p.flush()
        assert done == list(range(10))
        assert time.time() - t0 >= 0.04
    finally:
        p.close()


def test_pipeline_abort_flag():
    seen = []
    p = AsyncPipeline([lambda st, item: seen.append(p.abort_requested(0))], capacity=4)
    try:
        p.submit(0)
        p.flush()
        assert seen == [False]       # the flag resets per item
        p.signal_abort(0)
        assert p.abort_requested(0)
    finally:
        p.close()


@pytest.fixture()
def pgm_files(tmp_path):
    paths, imgs = [], []
    rng = np.random.RandomState(0)
    for i in range(6):
        img = rng.randint(0, 255, (16 + i, 24), np.uint8)
        p = tmp_path / f"f{i}.pgm"
        dataset.write_pgm(str(p), img)
        paths.append(str(p))
        imgs.append(img)
    return paths, imgs


def test_prefetcher_order_and_content(pgm_files):
    paths, imgs = pgm_files
    pf = Prefetcher(paths, capacity=3)
    assert pf.is_native
    for i in range(len(paths)):
        np.testing.assert_array_equal(pf.next(), imgs[i])
        assert pf.outstanding() == 0
    assert pf.next() is None
    pf.close()


def test_prefetcher_destroy_midway(pgm_files):
    pf = Prefetcher(pgm_files[0], capacity=2)
    pf.next()
    pf.close()


def test_prefetcher_raw_bytes_and_missing(tmp_path):
    raw = tmp_path / "raw.bin"
    raw.write_bytes(b"not a pgm")
    pf = Prefetcher([str(raw), str(tmp_path / "missing.pgm")])
    assert bytes(pf.next()) == b"not a pgm"
    assert pf.next() is None
    pf.close()


# ---------------------------------------------------------------------------
# map checkpoints
# ---------------------------------------------------------------------------


def _scene_map():
    return slice_scene()["m"]


def _jax_map(d):
    return j_ms.MapState(**{k: jnp.asarray(v, jnp.bfloat16 if k.endswith("desc_pm1") else None)
                            for k, v in d.items()})


def _fields_equal(got: dict, want: dict):
    assert set(got) == set(want)
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        if w.dtype.name == "bfloat16":
            w = w.astype(np.float32)
        if g.dtype.name == "bfloat16":
            g = g.astype(np.float32)
        assert g.shape == w.shape, k
        np.testing.assert_array_equal(g, w, err_msg=k)


def test_map_roundtrip(tmp_path):
    """test_runtime.py's small map, and a whole scene, saved and loaded: every
    field equal, the +/-1 descriptors rebuilt from the packed words."""
    from fishbirdeyevisualslam_torch.config import CapacityConfig
    cfg = SystemConfig().replace(capacity=CapacityConfig(
        max_keyframes=4, max_points=16, max_bird_points=8, max_obs_per_point=4, max_front_kp=8,
        max_bird_kp=8, max_local_kfs=2, max_local_points=8))
    m = t_ms.empty_map(cfg, device="cpu")
    m = m._replace(kf_valid=m.kf_valid.clone().index_fill_(0, torch.tensor([0]), True),
                   mp_pos=m.mp_pos.clone().index_copy_(0, torch.tensor([3]),
                                                      torch.tensor([[1.0, 2.0, 3.0]])),
                   mp_valid=m.mp_valid.clone().index_fill_(0, torch.tensor([3]), True),
                   n_kf=torch.tensor(1, dtype=torch.int32))
    for k, mm in enumerate((m, convert.map_state_from_numpy(_scene_map(), "cpu"))):
        path = str(tmp_path / f"map{k}.npz")
        checkpoint.save_map(mm, path)
        m2 = checkpoint.load_map(path, device="cpu")
        for name, a, b in zip(t_ms.MapState._fields, mm, m2):
            assert a.dtype == b.dtype and torch.equal(a, b), name


def test_map_files_cross_packages(tmp_path):
    """A map saved by the JAX package loads in the port field for field, and
    the port's file in the JAX package; both files hold the same keys,
    shapes, dtypes and values."""
    d = _scene_map()
    jpath, tpath = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    j_ckpt.save_map(_jax_map(d), jpath)
    checkpoint.save_map(convert.map_state_from_numpy(d, "cpu"), tpath)
    with np.load(jpath) as a, np.load(tpath) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    _fields_equal(convert.map_state_to_numpy(checkpoint.load_map(jpath, device="cpu")),
                  {k: np.asarray(v) for k, v in j_ckpt.load_map(jpath)._asdict().items()})
    _fields_equal({k: np.asarray(v) for k, v in j_ckpt.load_map(tpath)._asdict().items()},
                  convert.map_state_to_numpy(checkpoint.load_map(tpath, device="cpu")))
    _fields_equal(convert.map_state_to_numpy(checkpoint.load_map(tpath, device="cpu")), d)


def test_map_file_without_new_fields(tmp_path):
    """Files older than ``bp_gen`` and ``n_pressure_evicted`` load with both
    at zero."""
    d = {k: v for k, v in _scene_map().items()
         if k not in ("bp_gen", "n_pressure_evicted", "mp_desc_pm1", "bp_desc_pm1")}
    path = str(tmp_path / "old.npz")
    np.savez_compressed(path, **d)
    m = checkpoint.load_map(path, device="cpu")
    assert not m.bp_gen.any() and int(m.n_pressure_evicted) == 0
    assert m.bp_gen.shape == m.bp_valid.shape


# ---------------------------------------------------------------------------
# the dataset reader (tests/test_dataset.py)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def drive():
    """A 3-frame straight drive rendered by the port (its render equals the
    JAX package's: tests/test_torch_extract.py)."""
    return synthetic.make_sequence(SMALL, n_frames=3, kind="straight")


def _jax_cfg():
    from fishbirdeyevisualslam_tpu.config import SystemConfig as JaxConfig
    base = JaxConfig()
    return base.replace(camera=type(base.camera)(**dataclasses.asdict(SMALL.camera)),
                        bird=type(base.bird)(**dataclasses.asdict(SMALL.bird)))


def _open(mod, root, ext, cfg_bird):
    ds = mod.DatasetSequence.open(root, ext=ext, bird_cfg=cfg_bird)
    ds.crop, ds.downsample = None, 1
    return ds


def test_export_and_load(drive, tmp_path):
    root = str(tmp_path / "seq")
    dataset.export_sequence(drive, root)
    ds = _open(dataset, root, ".npy", SMALL.bird)
    assert len(ds) == 3
    fr = ds.frame(1)
    np.testing.assert_allclose(fr["front"], drive.frames[1]["front"], atol=1e-3)
    np.testing.assert_allclose(fr["bird"], drive.frames[1]["bird"], atol=1e-3)
    np.testing.assert_array_equal(fr["mask"],
                                  dataset.preprocess_bird_mask(drive.frames[1]["mask"], SMALL.bird))
    np.testing.assert_allclose(fr["contour"], drive.frames[1]["contour"], atol=1e-3)
    np.testing.assert_allclose(fr["odom"], drive.odom[1], atol=1e-5)
    np.testing.assert_allclose(fr["gt"], drive.gt[1], atol=1e-5)


def test_pgm_export_and_prefetched_iter(drive, tmp_path):
    """PGM quantises to uint8: the frames read back equal the render
    clipped and cast to uint8, exactly."""
    root = str(tmp_path / "seqp")
    dataset.export_sequence(drive, root, fmt="pgm")
    frames = list(_open(dataset, root, ".pgm", SMALL.bird).iter_prefetched())
    assert len(frames) == 3
    q = lambda a: np.clip(np.asarray(a, np.float32), 0, 255).astype(np.uint8).astype(np.float32)
    for i, fr in enumerate(frames):
        np.testing.assert_array_equal(fr["front"], q(drive.frames[i]["front"]))
        np.testing.assert_array_equal(fr["bird"], q(drive.frames[i]["bird"]))
        np.testing.assert_array_equal(fr["contour"], q(drive.frames[i]["contour"]))
        np.testing.assert_array_equal(
            fr["mask"], dataset.preprocess_bird_mask(drive.frames[i]["mask"], SMALL.bird))


def test_mask_preprocess_blanks_footprint():
    cfg = SystemConfig()
    out = dataset.preprocess_bird_mask(np.ones((cfg.bird.rows, cfg.bird.cols), bool), cfg.bird)
    assert not out[cfg.bird.rows // 2, cfg.bird.cols // 2]
    assert not out[0, 0]
    assert out[20, 20]
    np.testing.assert_array_equal(
        out, j_ds.preprocess_bird_mask(np.ones((cfg.bird.rows, cfg.bird.cols), bool), cfg.bird))


def test_parse_index_format(tmp_path):
    p = tmp_path / "associate.txt"
    p.write_text("1.5 2.0 -3.0 0.1 000001\n\n2.5 2.5 -3.1 0.2 000002\n")
    idx = dataset.parse_index(str(p))
    assert idx.stems == ["000001", "000002"]
    np.testing.assert_allclose(idx.timestamps, [1.5, 2.5])
    np.testing.assert_allclose(idx.poses[1], [2.5, -3.1, 0.2])


def test_pgm_reader(tmp_path):
    img = np.arange(48, dtype=np.uint8).reshape(6, 8)
    p = tmp_path / "t.pgm"
    with open(p, "wb") as f:
        f.write(b"P5\n# comment\n8 6\n255\n" + img.tobytes())
    np.testing.assert_array_equal(dataset._imread_gray(str(p)), img.astype(np.float32))
    pf = Prefetcher([str(p)])
    np.testing.assert_array_equal(pf.next(), img)
    pf.close()


def test_prefetcher_never_ends_early(tmp_path):
    """A file the worker has taken but not yet queued is not the end of the
    sequence: over many one-file prefetchers, ``next()`` always returns it
    (a reader that took ``next >= len(paths)`` with an empty queue for the
    end returned None in about one call of five)."""
    img = np.arange(48, dtype=np.uint8).reshape(6, 8)
    p = tmp_path / "t.pgm"
    with open(p, "wb") as f:
        f.write(b"P5\n8 6\n255\n" + img.tobytes())
    for _ in range(500):
        pf = Prefetcher([str(p)])
        got = pf.next()
        assert got is not None and pf.next() is None
        pf.close()
    np.testing.assert_array_equal(got, img)


@pytest.mark.parametrize("fmt", ["npy", "pgm"])
def test_exports_cross_packages(drive, tmp_path, fmt):
    """The same drive exported by the port and by the JAX package: the same
    files byte for byte, and every frame read back equal through both
    readers (the PGM layout through both prefetchers)."""
    ext = "." + fmt
    roots = {}
    for name, mod in (("port", dataset), ("jax", j_ds)):
        roots[name] = str(tmp_path / name)
        mod.export_sequence(drive, roots[name], fmt=fmt)
    for dirpath, _, files in os.walk(roots["port"]):
        for fn in files:
            rel = os.path.relpath(os.path.join(dirpath, fn), roots["port"])
            with open(os.path.join(roots["port"], rel), "rb") as a, \
                    open(os.path.join(roots["jax"], rel), "rb") as b:
                assert a.read() == b.read(), rel
    jcfg = _jax_cfg()
    for root in roots.values():
        ours = _open(dataset, root, ext, SMALL.bird)
        theirs = _open(j_ds, root, ext, jcfg.bird)
        it = (lambda d: d.iter_prefetched()) if fmt == "pgm" else iter
        for a, b in zip(it(ours), it(theirs), strict=True):
            for k in ("front", "bird", "mask", "contour", "odom", "gt", "timestamp"):
                np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]), err_msg=k)


def test_closed_pipeline_and_prefetcher():
    """A closed pipeline drains on close, flushes at once and refuses items;
    a closed prefetcher refuses reads (no NULL handle reaches the library)."""
    done = []
    p = AsyncPipeline([lambda st, item: done.append(item)], capacity=4)
    for i in range(3):
        p.submit(i)
    p.close()
    assert done == [0, 1, 2]
    p.flush()
    p.close()
    with pytest.raises(RuntimeError, match="closed"):
        p.submit(3)
    pf = Prefetcher([])
    assert pf.next() is None
    pf.close()
    with pytest.raises(RuntimeError, match="closed"):
        pf.next()
