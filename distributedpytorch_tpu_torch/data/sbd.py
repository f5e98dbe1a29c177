"""SBD (the Semantic Boundaries Dataset), the counterpart of
``distributedpytorch_tpu/data/sbd.py``: the instance and semantic sets of
an SBD tree with the VOC sample contracts, for merging into VOC training
through :class:`~.combine.CombinedDataset` (``data.sbd_root``)::

    <root>/benchmark_RELEASE/dataset/
        train.txt  val.txt
        img/<id>.jpg
        inst/<id>.mat     # GTinst struct: Segmentation (H, W ids), Categories
        cls/<id>.mat      # GTcls struct: Segmentation (H, W class ids)

:class:`SBDTree` reads it in the idiom of :class:`~.voc.VOCTree`
(``path(kind, im_id)``, ``image``, ``instances``, ``classes``), so the
prepared cache stamps SBD parts of a combined set as it stamps VOC.  The
instance categories come from ``GTinst.Categories`` with the area filter,
scanned at construction; no cache file is written into the tree.  PIL and
scipy are imported at the first read.
"""

from __future__ import annotations

import os

import numpy as np

from .voc import _DecodeCache

#: the tarball's internal prefix
BASE_DIR = os.path.join("benchmark_RELEASE", "dataset")


def _load_mat_struct(path: str, key: str):
    import scipy.io

    return scipy.io.loadmat(path, squeeze_me=True,
                            struct_as_record=False)[key]


class SBDTree:
    """An SBD directory: split ids, and the decoded image, ``GTinst`` and
    ``GTcls`` of an image id."""

    #: the directory and file extension of each kind of file
    LAYOUT = {"image": ("img", ".jpg"), "instances": ("inst", ".mat"),
              "classes": ("cls", ".mat")}

    def __init__(self, root: str):
        self.root = root
        self.base = os.path.join(root, BASE_DIR)
        if not os.path.isdir(self.base):
            raise FileNotFoundError(f"SBD tree not found under {self.base}")

    def path(self, kind: str, im_id: str) -> str:
        """The file of ``kind`` (image, instances, classes) of ``im_id``."""
        sub, ext = self.LAYOUT[kind]
        return os.path.join(self.base, sub, im_id + ext)

    def split_ids(self, split: str, kinds: tuple[str, ...]) -> list[str]:
        """The ids of ``split`` (blank lines skipped); raises if a file of
        ``kinds`` is missing."""
        with open(os.path.join(self.base, split + ".txt")) as f:
            ids = [line for line in f.read().splitlines() if line.strip()]
        for im_id in ids:
            for kind in kinds:
                if not os.path.isfile(self.path(kind, im_id)):
                    raise FileNotFoundError(self.path(kind, im_id))
        return ids

    def image(self, im_id: str) -> np.ndarray:
        """(H, W, 3) uint8 RGB."""
        from PIL import Image

        with Image.open(self.path("image", im_id)) as im:
            return np.array(im.convert("RGB"), np.uint8)

    def inst_struct(self, im_id: str):
        """The ``GTinst`` struct (``Segmentation``, ``Categories``)."""
        return _load_mat_struct(self.path("instances", im_id), "GTinst")

    def instances(self, im_id: str) -> np.ndarray:
        """(H, W) object ids, 255 on void pixels."""
        return np.asarray(self.inst_struct(im_id).Segmentation)

    def classes(self, im_id: str) -> np.ndarray:
        """(H, W) category ids, 255 on void pixels."""
        return np.asarray(_load_mat_struct(self.path("classes", im_id),
                                           "GTcls").Segmentation)


class SBDInstanceSegmentation:
    """Random-access (image, single-object mask, void mask) samples of an
    SBD tree, one per object that survives the area filter, with the
    :class:`~.voc.VOCInstanceSegmentation` sample contract.  ``root`` is a
    directory or an :class:`SBDTree`; the categories are
    ``GTinst.Categories``, -1 for an object of ``area_thres`` pixels or
    fewer."""

    def __init__(self, root, split="train", transform=None,
                 area_thres: int = 0, retname: bool = True,
                 suppress_void_pixels: bool = True, decode_cache: int = 0):
        self.tree = SBDTree(root) if isinstance(root, (str, os.PathLike)) \
            else root
        self.transform = transform
        self.area_thres = area_thres
        self.retname = retname
        self.suppress_void_pixels = suppress_void_pixels
        self._cache = _DecodeCache(decode_cache) if decode_cache > 0 else None
        self.split = sorted([split] if isinstance(split, str) else list(split))
        self.im_ids = [i for s in self.split
                       for i in self.tree.split_ids(s, ("image", "instances"))]
        #: image id -> category of each object, -1 where filtered out
        self.obj_dict = {im_id: self._categories(im_id)
                         for im_id in self.im_ids}
        self.obj_list = [(ii, jj) for ii, im_id in enumerate(self.im_ids)
                         for jj, cat in enumerate(self.obj_dict[im_id])
                         if cat != -1]

    def _categories(self, im_id: str) -> list[int]:
        gt = self.tree.inst_struct(im_id)
        inst = np.asarray(gt.Segmentation)
        cats = np.atleast_1d(np.asarray(gt.Categories)).astype(int)
        return [int(cat) if int((inst == jj + 1).sum()) > self.area_thres
                else -1 for jj, cat in enumerate(cats)]

    def __len__(self) -> int:
        return len(self.obj_list)

    def sample_image_id(self, index: int) -> str:
        """The image id of sample ``index``: the exclusion key of a
        combined set."""
        return self.im_ids[self.obj_list[index][0]]

    def decode_raw(self, im_ii: int) -> tuple[np.ndarray, np.ndarray]:
        """The decoded (uint8 RGB, raw ``GTinst`` mask) of image
        ``im_ii``, through the decode cache when there is one."""
        def decode():
            im_id = self.im_ids[im_ii]
            return self.tree.image(im_id), self.tree.instances(im_id)

        return self._cache.get(im_ii, decode) if self._cache is not None \
            else decode()

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
            inst = np.where(void, 0.0, inst)
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

    def __str__(self) -> str:
        return f"SBD(split={self.split},area_thres={self.area_thres})"


class SBDSemanticSegmentation:
    """Random-access per-image samples of an SBD tree with the ``GTcls``
    class ids, the :class:`~.voc.VOCSemanticSegmentation` contract (void
    in band as 255): the semantic task's SBD merge (DeepLab's
    ``train_aug``).  ``root`` is a directory or an :class:`SBDTree`."""

    def __init__(self, root, split="train", transform=None,
                 retname: bool = True, decode_cache: int = 0):
        self.tree = SBDTree(root) if isinstance(root, (str, os.PathLike)) \
            else root
        self.transform = transform
        self.retname = retname
        self._cache = _DecodeCache(decode_cache) if decode_cache > 0 else None
        self.split = sorted([split] if isinstance(split, str) else list(split))
        self.im_ids = [i for s in self.split
                       for i in self.tree.split_ids(s, ("image", "classes"))]

    def __len__(self) -> int:
        return len(self.im_ids)

    def sample_image_id(self, index: int) -> str:
        """The image id of sample ``index``."""
        return self.im_ids[index]

    def decode_raw(self, index: int) -> tuple[np.ndarray, np.ndarray]:
        """The decoded (uint8 RGB, raw ``GTcls`` class-id mask) of image
        ``index``, through the decode cache when there is one."""
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
        return f"SBDSemantic(split={self.split})"
