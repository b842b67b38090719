"""Dataset loading for the reference's directory layout — the port of
``fishbirdeyevisualslam_tpu/io/dataset.py`` (numpy, with the port's native
prefetcher, ``runtime/native.py``).

The reference's example program (``Examples/Monocular/mono_encoder.cc:220-252``)
reads two index files with identical format — ``groundtruth.txt`` (GT SE2 poses) and
``associate.txt`` (wheel-odometry SE2 poses) — each line:

    <timestamp> <x> <y> <theta> <image-stem>

and resolves per-frame files as ``image/<stem>.jpg``, ``birdview/<stem>.jpg``,
``mask/<stem>.jpg``, ``contourICPWrite/<stem>.bmp``, ``contourICP/<stem>.jpg``.
The front image is masked, cropped to 1900x800 and half-sized
(``mono_encoder.cc:144-158``); the bird mask is eroded and the vehicle footprint
blanked (``:279-313``).

Image decoding: binary PGM natively (the C++ prefetcher) or in numpy,
PNG/JPG/BMP through Pillow where it is installed; ``.npy`` arrays always.  ``export_sequence`` writes a synthetic drive (``io/synthetic.py``)
in this layout, for round trips.
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, Optional, Tuple

import numpy as np


@dataclasses.dataclass
class DatasetIndex:
    timestamps: np.ndarray     # (N,)
    poses: np.ndarray          # (N, 3) x, y, theta
    stems: List[str]


def parse_index(path: str) -> DatasetIndex:
    ts, poses, stems = [], [], []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            parts = line.split()
            ts.append(float(parts[0]))
            poses.append([float(parts[1]), float(parts[2]), float(parts[3])])
            stems.append(parts[4] if len(parts) > 4 else "")
    return DatasetIndex(np.asarray(ts), np.asarray(poses, np.float32), stems)


def _imread_gray(path: str) -> np.ndarray:
    if path.endswith(".npy"):
        img = np.load(path)
    elif path.endswith((".pgm", ".PGM")):
        with open(path, "rb") as f:
            data = f.read()
        assert data[:2] == b"P5"
        # header: magic, width, height, maxval (whitespace/comment separated)
        tokens = []
        i = 2
        while len(tokens) < 3:
            while i < len(data) and data[i : i + 1].isspace():
                i += 1
            if data[i : i + 1] == b"#":
                while i < len(data) and data[i : i + 1] != b"\n":
                    i += 1
                continue
            j = i
            while j < len(data) and not data[j : j + 1].isspace():
                j += 1
            tokens.append(int(data[i:j]))
            i = j
        i += 1
        w, h, _ = tokens
        img = np.frombuffer(data[i : i + w * h], np.uint8).reshape(h, w)
    else:
        # PNG / JPG / BMP through Pillow, 8 bits a channel
        from PIL import Image
        with Image.open(path) as im:
            img = np.asarray(im if im.mode in ("L", "RGB", "RGBA") else im.convert("RGB"))
    img = np.asarray(img, np.float32)
    if img.ndim == 3:
        img = img[..., 0] * 0.299 + img[..., 1] * 0.587 + img[..., 2] * 0.114
    return img


def _erode(mask: np.ndarray, radius: int) -> np.ndarray:
    """Binary erosion with a (2r+1)^2 rectangular structuring element
    (``cv::erode`` with MORPH_RECT in ``ConvertMaskBirdview``)."""
    out = mask.copy()
    for axis, r in ((0, radius), (1, radius)):
        acc = out.copy()
        for s in range(1, r + 1):
            acc &= np.roll(out, s, axis=axis) & np.roll(out, -s, axis=axis)
        # rolls wrap around: kill the border band outright (conservative, the
        # reference's border pixels erode away too)
        out = acc
    out[:radius, :] = False
    out[-radius:, :] = False
    out[:, :radius] = False
    out[:, -radius:] = False
    return out


def preprocess_bird_mask(mask: np.ndarray, bird_cfg, erosion: int = 5,
                         boundary: float = 15.0) -> np.ndarray:
    """The reference example program's ``ConvertMaskBirdview``
    (``mono_encoder.cc:279-313``): binarize, erode with an 11x11 rectangle,
    then blank the vehicle-footprint rectangle (vehicle extent in pixels plus a
    ``boundary``-px margin) centered in the bird image."""
    m = np.asarray(mask) > 0 if mask.dtype != bool else mask.copy()
    m = _erode(m, erosion)
    rows, cols = m.shape
    x0 = int(cols / 2 - (bird_cfg.vehicle_width / 2 / bird_cfg.pixel2meter) - boundary)
    y0 = int(rows / 2 - (bird_cfg.vehicle_length / 2 / bird_cfg.pixel2meter) - boundary)
    w = int(bird_cfg.vehicle_width / bird_cfg.pixel2meter + 2 * boundary)
    h = int(bird_cfg.vehicle_length / bird_cfg.pixel2meter + 2 * boundary)
    m[max(0, y0): y0 + h, max(0, x0): x0 + w] = False
    return m


@dataclasses.dataclass
class DatasetSequence:
    """Iterates the reference layout, yielding ready-to-track frames."""

    root: str
    odom_index: DatasetIndex            # associate.txt
    gt_index: Optional[DatasetIndex]    # groundtruth.txt (may be absent)
    front_mask: Optional[np.ndarray] = None
    crop: Optional[Tuple[int, int]] = (1900, 800)
    downsample: int = 2
    ext: str = ".jpg"
    contour_ext: str = ".jpg"
    bird_cfg: Optional[object] = None   # BirdConfig for mask preprocessing

    @classmethod
    def open(cls, root: str, ext: str = ".jpg", bird_cfg=None) -> "DatasetSequence":
        odom = parse_index(os.path.join(root, "associate.txt"))
        gt_path = os.path.join(root, "groundtruth.txt")
        gt = parse_index(gt_path) if os.path.exists(gt_path) else None
        if bird_cfg is None:
            from fishbirdeyevisualslam_torch.config import BirdConfig
            bird_cfg = BirdConfig()
        return cls(root=root, odom_index=odom, gt_index=gt, ext=ext,
                   bird_cfg=bird_cfg)

    def __len__(self):
        return len(self.odom_index.stems)

    def _optional_gray(self, sub: str, stem: str, ext: str):
        for e in (ext, ".npy"):
            p = os.path.join(self.root, sub, stem + e)
            if os.path.exists(p):
                return _imread_gray(p)
        return None

    def frame(self, i: int):
        stem = self.odom_index.stems[i]
        front = _imread_gray(os.path.join(self.root, "image", stem + self.ext))
        bird = _imread_gray(os.path.join(self.root, "birdview", stem + self.ext))
        raw_mask = self._optional_gray("mask", stem, self.ext)
        if raw_mask is not None:
            # erode + vehicle-footprint blank (``ConvertMaskBirdview``)
            mask = preprocess_bird_mask(raw_mask > 127, self.bird_cfg)
        else:
            mask = np.ones_like(bird, bool)
        # contour label image driving GuidenceKeyBirdPts (edge < 150):
        # ``contourICP/<stem>.jpg`` (``mono_encoder.cc:246``)
        contour = self._optional_gray("contourICP", stem, self.contour_ext)
        # front preprocessing (mono_encoder.cc:144-158)
        if self.front_mask is not None:
            front = np.where(self.front_mask, front, 0.0)
        if self.crop is not None:
            cw, ch = self.crop
            front = front[:ch, :cw]
        if self.downsample > 1:
            front = front[:: self.downsample, :: self.downsample]
        return dict(
            front=front.astype(np.float32),
            bird=bird.astype(np.float32),
            mask=mask,
            contour=None if contour is None else contour.astype(np.float32),
            odom=self.odom_index.poses[i],
            gt=None if self.gt_index is None else self.gt_index.poses[i],
            timestamp=float(self.odom_index.timestamps[i]),
        )

    def __iter__(self):
        for i in range(len(self)):
            yield self.frame(i)

    def iter_prefetched(self):
        """Iterate frames with the native prefetcher reading the four image
        streams ahead of the consumer (``runtime.native.Prefetcher``; binary
        PGM parsed in C).  Other layouts are read by ``__iter__``."""
        if self.ext != ".pgm":
            yield from self
            return
        from fishbirdeyevisualslam_torch.runtime.native import Prefetcher
        stems = self.odom_index.stems
        subs = ["image", "birdview", "mask", "contourICP"]
        have = {s: os.path.isdir(os.path.join(self.root, s)) for s in subs}
        paths = [os.path.join(self.root, s, stem + self.ext)
                 for stem in stems for s in subs if have[s]]
        pf = Prefetcher(paths, capacity=16)
        try:
            for i in range(len(stems)):
                imgs = {}
                for s in subs:
                    if have[s]:
                        imgs[s] = pf.next()
                front = imgs["image"].astype(np.float32)
                bird = imgs["birdview"].astype(np.float32)
                raw_mask = imgs.get("mask")
                mask = (preprocess_bird_mask(raw_mask > 127, self.bird_cfg)
                        if raw_mask is not None else np.ones_like(bird, bool))
                contour = imgs.get("contourICP")
                if self.front_mask is not None:
                    front = np.where(self.front_mask, front, 0.0)
                if self.crop is not None:
                    cw, ch = self.crop
                    front = front[:ch, :cw]
                if self.downsample > 1:
                    front = front[:: self.downsample, :: self.downsample]
                yield dict(
                    front=front, bird=bird, mask=mask,
                    contour=None if contour is None else contour.astype(np.float32),
                    odom=self.odom_index.poses[i],
                    gt=None if self.gt_index is None else self.gt_index.poses[i],
                    timestamp=float(self.odom_index.timestamps[i]),
                )
        finally:
            pf.close()

    def play(self, realtime: bool = True):
        """Yield frames paced to their timestamps (the reference's example
        program sleeps out the remainder of each frame period,
        ``mono_encoder.cc:186-193``)."""
        import time
        prev_ts = None
        t_wall = time.perf_counter()
        for i in range(len(self)):
            fr = self.frame(i)
            if realtime and prev_ts is not None:
                period = fr["timestamp"] - prev_ts
                elapsed = time.perf_counter() - t_wall
                if period > elapsed:
                    time.sleep(period - elapsed)
            prev_ts = fr["timestamp"]
            t_wall = time.perf_counter()
            yield fr


def write_pgm(path: str, img: np.ndarray) -> None:
    """Binary PGM (P5) writer — the format the native prefetcher parses in C."""
    u8 = np.clip(np.asarray(img, np.float32), 0, 255).astype(np.uint8)
    h, w = u8.shape
    with open(path, "wb") as f:
        f.write(f"P5\n{w} {h}\n255\n".encode())
        f.write(u8.tobytes())


def export_sequence(seq, root: str, fmt: str = "npy") -> None:
    """Write a synthetic sequence (``io.synthetic.SyntheticSequence``) to disk in
    the reference layout for loader round-trip testing; ``fmt='pgm'`` produces
    the binary-PGM variant the native prefetcher decodes in C."""
    for sub in ("image", "birdview", "mask", "contourICP"):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    lines_odom, lines_gt = [], []

    def save(sub, stem, arr):
        if fmt == "pgm":
            write_pgm(os.path.join(root, sub, stem + ".pgm"), arr)
        else:
            np.save(os.path.join(root, sub, stem + ".npy"), arr)

    for i, fr in enumerate(seq.frames):
        stem = f"{i:06d}"
        save("image", stem, fr["front"])
        save("birdview", stem, fr["bird"])
        save("mask", stem, fr["mask"].astype(np.uint8) * 255)
        if fr.get("contour") is not None:
            save("contourICP", stem, fr["contour"])
        o = seq.odom[i]
        g = seq.gt[i]
        lines_odom.append(f"{fr['timestamp']:.6f} {o[0]:.6f} {o[1]:.6f} {o[2]:.6f} {stem}")
        lines_gt.append(f"{fr['timestamp']:.6f} {g[0]:.6f} {g[1]:.6f} {g[2]:.6f} {stem}")
    with open(os.path.join(root, "associate.txt"), "w") as f:
        f.write("\n".join(lines_odom) + "\n")
    with open(os.path.join(root, "groundtruth.txt"), "w") as f:
        f.write("\n".join(lines_gt) + "\n")
