"""Pascal VOC 2012, the counterpart of ``distributedpytorch_tpu/data/voc.py``'s
``VOCInstanceSegmentation`` and ``VOCSemanticSegmentation``.

One sample per (image, object) pair that survives the area filter, with
the reference's sample contract::

    {'image':       float32 (H, W, 3) RGB,
     'gt':          float32 (H, W) binary mask of ONE object,
     'void_pixels': float32 (H, W) mask of 255-labelled pixels,
     'meta':        {'image', 'object', 'category', 'im_size'}}

:class:`VOCSemanticSegmentation` gives one sample per image instead:
``image`` and ``gt``, the (H, W) float32 class ids with void kept in band
as 255, and ``meta`` ``{'image', 'im_size'}``.

The tree is read from a directory with the VOC2012 layout (JPEG/PNG
decoded by PIL, imported at the first read: the card's machine may not
have it) or from an in-memory :class:`~.fake.FakeVOC` with the same three
readers.  The per-image object categories are scanned at construction, as
the JAX trainer does with ``preprocess=True``; the port writes no cache
file into the dataset tree.  ``decode_cache=N`` keeps the last N decoded
images (``data.decode_cache``, :class:`_DecodeCache`).
"""

from __future__ import annotations

import collections
import os
import threading

import numpy as np

BASE_DIR = "VOCdevkit/VOC2012"


class VOCTree:
    """A VOC2012 directory: split ids, and the decoded image, instance and
    class PNGs of an image id."""

    def __init__(self, root: str):
        self.root = root
        voc = os.path.join(root, BASE_DIR)
        if not os.path.isdir(voc):
            raise FileNotFoundError(
                f"VOC tree not found under {voc} (the port does not download "
                "it; use data.fake=true for the synthetic fixture)")
        self._dirs = {"image": os.path.join(voc, "JPEGImages"),
                      "instances": os.path.join(voc, "SegmentationObject"),
                      "classes": os.path.join(voc, "SegmentationClass"),
                      "sets": os.path.join(voc, "ImageSets", "Segmentation")}

    def split_ids(self, split: str,
                  kinds: tuple[str, ...] = ("image", "instances", "classes")
                  ) -> list[str]:
        """The ids of ``split``; raises if a file of ``kinds`` is missing."""
        with open(os.path.join(self._dirs["sets"], split + ".txt")) as f:
            ids = f.read().splitlines()
        ext = {"image": ".jpg", "instances": ".png", "classes": ".png"}
        for im_id in ids:
            for kind in kinds:
                path = os.path.join(self._dirs[kind], im_id + ext[kind])
                if not os.path.isfile(path):
                    raise FileNotFoundError(path)
        return ids

    def _read(self, kind: str, im_id: str, ext: str, rgb: bool = False):
        from PIL import Image

        with Image.open(os.path.join(self._dirs[kind], im_id + ext)) as im:
            return np.array(im.convert("RGB") if rgb else im)

    def image(self, im_id: str) -> np.ndarray:
        """(H, W, 3) uint8 RGB."""
        return np.asarray(self._read("image", im_id, ".jpg", rgb=True),
                          np.uint8)

    def instances(self, im_id: str) -> np.ndarray:
        """(H, W) uint8 object ids, 255 on void pixels."""
        return self._read("instances", im_id, ".png")

    def classes(self, im_id: str) -> np.ndarray:
        """(H, W) uint8 category ids, 255 on void pixels."""
        return self._read("classes", im_id, ".png")


class _DecodeCache:
    """Thread-safe LRU of decoded images keyed by image index, the JAX
    package's decode-once cache: an image is decoded once for all of its
    objects and epochs while it stays among the ``max_items`` most
    recently used.  Values are stored as decoded (uint8 RGB, raw instance
    mask) and never mutated: readers copy as they convert.  A process
    worker gets an empty cache of its own (``__getstate__``)."""

    def __init__(self, max_items: int):
        self.max_items = max_items
        self._d: collections.OrderedDict = collections.OrderedDict()
        self._lock = threading.Lock()

    def get(self, key, load):
        with self._lock:
            if key in self._d:
                self._d.move_to_end(key)
                return self._d[key]
        val = load()  # decode outside the lock: loader threads overlap
        with self._lock:
            self._d[key] = val
            self._d.move_to_end(key)
            while len(self._d) > self.max_items:
                self._d.popitem(last=False)
        return val

    def __getstate__(self):
        return {"max_items": self.max_items}

    def __setstate__(self, state):
        self.__init__(state["max_items"])


class VOCInstanceSegmentation:
    """Random-access (image, single-object mask, void mask) samples.

    ``root`` is a VOC directory or a tree object (:class:`VOCTree`,
    :class:`~.fake.FakeVOC`).  Objects of ``area_thres`` pixels or fewer
    are skipped.  A ``transform`` gets the ``rng`` passed to
    ``__getitem__``.  ``decode_cache`` > 0 keeps that many decoded images
    (:class:`_DecodeCache`)."""

    def __init__(self, root, split="val", transform=None, area_thres: int = 0,
                 retname: bool = True, suppress_void_pixels: bool = True,
                 decode_cache: int = 0):
        self.tree = VOCTree(root) if isinstance(root, (str, os.PathLike)) \
            else root
        self.transform = transform
        self._cache = _DecodeCache(decode_cache) if decode_cache > 0 else None
        self.area_thres = area_thres
        self.retname = retname
        self.suppress_void_pixels = suppress_void_pixels
        self.split = sorted([split] if isinstance(split, str) else list(split))
        self.im_ids = [i for s in self.split for i in self.tree.split_ids(s)]
        #: image id -> category of each object, -1 where filtered out
        self.obj_dict = {im_id: self._categories(im_id) for im_id in self.im_ids}
        self.obj_list = [(ii, jj) for ii, im_id in enumerate(self.im_ids)
                         for jj, cat in enumerate(self.obj_dict[im_id])
                         if cat != -1]
        self.num_images = len({ii for ii, _ in self.obj_list})

    def _categories(self, im_id: str) -> list[int]:
        inst = self.tree.instances(im_id)
        ids = np.unique(inst)
        n_obj = int(ids[-2] if ids[-1] == 255 else ids[-1])
        cats = self.tree.classes(im_id)
        out = []
        for jj in range(n_obj):
            rows, cols = np.where(inst == jj + 1)
            out.append(int(cats[rows[0], cols[0]])
                       if rows.size > self.area_thres else -1)
        return out

    def __len__(self) -> int:
        return len(self.obj_list)

    def __getitem__(self, index: int,
                    rng: np.random.Generator | None = None) -> dict:
        im_ii, obj_ii = self.obj_list[index]
        im_id = self.im_ids[im_ii]
        img8, inst_raw = self.decode_raw(im_ii)
        # astype copies: a cached decode is never mutated
        img = img8.astype(np.float32)
        inst = inst_raw.astype(np.float32)
        void = inst == 255
        if self.suppress_void_pixels:
            inst[void] = 0
        sample = {"image": img,
                  "gt": (inst == obj_ii + 1).astype(np.float32),
                  "void_pixels": void.astype(np.float32)}
        if self.retname:
            sample["meta"] = {"image": im_id, "object": str(obj_ii),
                              "category": self.obj_dict[im_id][obj_ii],
                              "im_size": (img.shape[0], img.shape[1])}
        if self.transform is not None:
            sample = self.transform(sample, rng)
        return sample

    def decode_raw(self, im_ii: int) -> tuple[np.ndarray, np.ndarray]:
        """The decoded (uint8 RGB, raw instance mask) of image ``im_ii``,
        through the decode cache when there is one."""
        def decode():
            im_id = self.im_ids[im_ii]
            return self.tree.image(im_id), self.tree.instances(im_id)

        return self._cache.get(im_ii, decode) if self._cache is not None \
            else decode()

    def __str__(self) -> str:
        return f"VOC2012(split={self.split},area_thres={self.area_thres})"


class VOCSemanticSegmentation:
    """Random-access per-image samples with class-id masks
    (``SegmentationClass``), for the semantic task.

    ``root`` is a VOC directory or a tree object (:class:`VOCTree`,
    :class:`~.fake.FakeVOC`, whose ``classes`` are the fixture's class
    maps).  Void stays in band as 255: the softmax loss ignores it and
    the confusion counts drop it.  ``decode_cache`` > 0 keeps that many
    decoded images (:class:`_DecodeCache`)."""

    def __init__(self, root, split="val", transform=None,
                 retname: bool = True, decode_cache: int = 0):
        self.tree = VOCTree(root) if isinstance(root, (str, os.PathLike)) \
            else root
        self.transform = transform
        self.retname = retname
        self.split = sorted([split] if isinstance(split, str) else list(split))
        self._cache = _DecodeCache(decode_cache) if decode_cache > 0 else None
        self.im_ids = [i for s in self.split
                       for i in self.tree.split_ids(s, ("image", "classes"))]

    def __len__(self) -> int:
        return len(self.im_ids)

    def decode_raw(self, index: int) -> tuple[np.ndarray, np.ndarray]:
        """The decoded (uint8 RGB, raw class-id mask) of image ``index``,
        through the decode cache when there is one."""
        def decode():
            im_id = self.im_ids[index]
            return self.tree.image(im_id), self.tree.classes(im_id)

        return self._cache.get(index, decode) if self._cache is not None \
            else decode()

    def __getitem__(self, index: int,
                    rng: np.random.Generator | None = None) -> dict:
        img8, gt_raw = self.decode_raw(index)
        # astype copies: a cached decode is never mutated
        img = img8.astype(np.float32)
        sample = {"image": img, "gt": gt_raw.astype(np.float32)}
        if self.retname:
            sample["meta"] = {"image": self.im_ids[index],
                              "im_size": (img.shape[0], img.shape[1])}
        if self.transform is not None:
            sample = self.transform(sample, rng)
        return sample

    def __str__(self) -> str:
        return f"VOC2012Semantic(split={self.split})"
