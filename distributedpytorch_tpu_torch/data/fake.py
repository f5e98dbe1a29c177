"""Synthetic tiny-VOC fixture in memory, the counterpart of
``distributedpytorch_tpu/data/fake.py``'s ``make_fake_voc``, and the
on-disk fake SBD tree (:func:`make_fake_sbd`).

The same scenes — random filled ellipses and rectangles drawn back to
front over noise, each object painted with a class colour plus texture
noise, a 255 void ring around each object, the image blurred by a 7 x 7
gaussian — with the same counts, sizes and split layout, but drawn with
numpy instead of OpenCV and kept as arrays instead of JPEG/PNG files: the
card's machine has neither OpenCV nor, perhaps, PIL.  The pixels are not
the JAX fixture's (no JPEG round trip, numpy rasterisation).
"""

from __future__ import annotations

import colorsys
import os

import numpy as np


def _class_color(cat: int) -> np.ndarray:
    r, g, b = colorsys.hsv_to_rgb((cat - 1) / 20.0, 0.75, 0.9)
    return np.array([r * 255, g * 255, b * 255], np.float32)


def _ellipse(h: int, w: int, cx: int, cy: int, ax: int, ay: int,
             angle_deg: float) -> np.ndarray:
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    a = np.deg2rad(angle_deg)
    dx, dy = xx - cx, yy - cy
    u = dx * np.cos(a) + dy * np.sin(a)
    v = -dx * np.sin(a) + dy * np.cos(a)
    return ((u / max(ax, 1)) ** 2 + (v / max(ay, 1)) ** 2 <= 1.0).astype(np.uint8)


def _dilate3(mask: np.ndarray) -> np.ndarray:
    padded = np.pad(mask, 1)
    h, w = mask.shape
    return np.max([padded[i:i + h, j:j + w] for i in range(3)
                   for j in range(3)], axis=0)


def _blur7(img: np.ndarray) -> np.ndarray:
    """7 x 7 gaussian blur (cv2's sigma for ksize 7: 1.4), reflected
    border, uint8 out."""
    x = np.arange(7) - 3
    k = np.exp(-x ** 2 / (2 * 1.4 ** 2))
    k /= k.sum()
    out = img.astype(np.float64)
    for axis in (0, 1):
        pad = [(0, 0)] * out.ndim
        pad[axis] = (3, 3)
        p = np.pad(out, pad, mode="reflect")
        n = out.shape[axis]
        out = sum(k[i] * np.take(p, np.arange(i, i + n), axis=axis)
                  for i in range(7))
    return np.clip(np.rint(out), 0, 255).astype(np.uint8)


class FakeVOC:
    """An in-memory VOC tree: ``split_ids``, ``image``, ``instances`` and
    ``classes`` as :class:`~.voc.VOCTree` has them."""

    def __init__(self, splits: dict[str, list[str]],
                 arrays: dict[str, tuple[np.ndarray, np.ndarray, np.ndarray]]):
        self.splits = splits
        self.arrays = arrays

    def split_ids(self, split: str, kinds=None) -> list[str]:
        return list(self.splits[split])

    def image(self, im_id: str) -> np.ndarray:
        return self.arrays[im_id][0]

    def instances(self, im_id: str) -> np.ndarray:
        return self.arrays[im_id][1]

    def classes(self, im_id: str) -> np.ndarray:
        return self.arrays[im_id][2]


def make_fake_voc(n_images: int = 6, size: tuple[int, int] = (120, 160),
                  max_objects: int = 3, n_val: int = 2, seed: int = 0,
                  void_ring: bool = True) -> FakeVOC:
    """A fake VOC tree: ids ``fake_000000``..., the first ``n_images -
    n_val`` in ``train``, the rest in ``val``."""
    rng = np.random.default_rng(seed)
    h, w = size
    ids = [f"fake_{i:06d}" for i in range(n_images)]
    arrays = {}
    for im_id in ids:
        img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        inst = np.zeros((h, w), dtype=np.uint8)
        cls = np.zeros((h, w), dtype=np.uint8)
        for obj in range(1, int(rng.integers(1, max_objects + 1)) + 1):
            cat = int(rng.integers(1, 21))
            cx = int(rng.integers(w // 4, 3 * w // 4))
            cy = int(rng.integers(h // 4, 3 * h // 4))
            ax = int(rng.integers(max(6, w // 10), w // 3))
            ay = int(rng.integers(max(6, h // 10), h // 3))
            if rng.random() < 0.5:
                shape = _ellipse(h, w, cx, cy, ax, ay, float(rng.uniform(0, 180)))
            else:
                shape = np.zeros((h, w), np.uint8)
                shape[max(cy - ay, 0):cy + ay + 1, max(cx - ax, 0):cx + ax + 1] = 1
            sel = shape == 1
            tex = _class_color(cat) + rng.normal(0.0, 14.0, (int(sel.sum()), 3))
            img[sel] = np.clip(tex, 0, 255).astype(np.uint8)
            inst[sel] = obj
            cls[sel] = cat
            if void_ring:
                ring = _dilate3(shape) - shape
                inst[ring == 1] = 255
                cls[ring == 1] = 255
        arrays[im_id] = (_blur7(img), inst, cls)
    n_train = n_images - n_val
    return FakeVOC({"train": ids[:n_train], "val": ids[n_train:]}, arrays)


def make_fake_sbd(root: str, n_images: int = 4,
                  size: tuple[int, int] = (120, 160), max_objects: int = 3,
                  n_val: int = 1, seed: int = 0,
                  overlap_ids: list[str] | None = None) -> str:
    """Write a fake SBD tree (the ``benchmark_RELEASE/dataset`` layout:
    ``img/*.jpg``, ``GTinst``/``GTcls`` structs in ``inst/*.mat`` and
    ``cls/*.mat``, ``train.txt``/``val.txt``) under ``root``; returns
    ``root``.  Ids are ``sbd_000000``...; the last ``n_val`` go to
    ``val``.  ``overlap_ids`` are extra images written under exactly
    these ids into ``train`` (say, a VOC val split's ids), which a
    combined training set must exclude.  The scenes are the JAX writer's
    (blurred noise, 1 to ``max_objects`` filled ellipses with a 255 void
    ring, a category each), drawn with numpy; PIL writes the images and
    scipy the structs."""
    import scipy.io
    from PIL import Image

    from .sbd import BASE_DIR

    rng = np.random.default_rng(seed)
    base = os.path.join(root, BASE_DIR)
    dirs = {k: os.path.join(base, k) for k in ("img", "inst", "cls")}
    for d in dirs.values():
        os.makedirs(d, exist_ok=True)
    h, w = size
    base_ids = [f"sbd_{i:06d}" for i in range(n_images)]
    # overlap ids land in train, the split a combined set reads
    train_ids = base_ids[:n_images - n_val] + list(overlap_ids or [])
    val_ids = base_ids[n_images - n_val:] if n_val else []
    for im_id in train_ids + val_ids:
        img = _blur7(rng.integers(0, 256, (h, w, 3), dtype=np.uint8))
        inst = np.zeros((h, w), dtype=np.uint8)
        cls = np.zeros((h, w), dtype=np.uint8)
        cats = []
        for obj in range(1, int(rng.integers(1, max_objects + 1)) + 1):
            cat = int(rng.integers(1, 21))
            cats.append(cat)
            cx = int(rng.integers(w // 4, 3 * w // 4))
            cy = int(rng.integers(h // 4, 3 * h // 4))
            ax = int(rng.integers(max(6, w // 10), w // 3))
            ay = int(rng.integers(max(6, h // 10), h // 3))
            shape = _ellipse(h, w, cx, cy, ax, ay, float(rng.uniform(0, 180)))
            inst[shape == 1] = obj
            cls[shape == 1] = cat
            ring = _dilate3(shape) - shape
            inst[ring == 1] = 255
            cls[ring == 1] = 255
        Image.fromarray(img).save(os.path.join(dirs["img"], im_id + ".jpg"))
        # the struct layout scipy round-trips (a dict is written as a struct)
        scipy.io.savemat(os.path.join(dirs["inst"], im_id + ".mat"),
                         {"GTinst": {"Segmentation": inst,
                                     "Categories": np.array(cats)}})
        scipy.io.savemat(os.path.join(dirs["cls"], im_id + ".mat"),
                         {"GTcls": {"Segmentation": cls}})
    for split, ids in (("train", train_ids), ("val", val_ids)):
        with open(os.path.join(base, split + ".txt"), "w") as f:
            f.write("\n".join(ids) + "\n" if ids else "")
    return root
