"""Prepared-sample disk cache, the counterpart of
``distributedpytorch_tpu/data/prepared.py``: the deterministic front of a
pipeline (instance: decode -> crop -> resize; semantic: decode -> resize)
computed once per sample, stored compactly and ``np.memmap``-read in every
later epoch (``data.prepared_cache``), and with ``eval_protocol`` the whole
instance val protocol, full-resolution ``gt``/``void_pixels`` included
(``data.val_prepared``).

What is cached per instance sample (fixed shapes):

* ``crop_image`` — (H, W, 3) uint8 (the [0, 255] contract makes uint8
  lossless up to rounding);
* ``crop_gt`` — H·W bits, ``np.packbits`` of the binary mask;
* ``bbox`` — the relaxed crop box, for the paste-back;
* ``im_size`` — the source image's (H, W), rebuilding ``meta``;
* with ``eval_protocol``: the full-resolution ``gt`` and ``void_pixels``
  as packed bits in rows of ``ceil(max_h · max_w / 8)`` bytes.

Randomness is not cached: flip, scale-rotate and guidance run downstream
of the cache (``post_transform``) on the fixed-size crop, the semantics of
the device augmentation (``data.device_augment_geom``).

The on-disk layout, ``_FORMAT_VERSION`` and fingerprint rules are the JAX
package's; the fingerprint names the port's imaging backend
(``imaging.backend()``), so the two packages never share a cache
directory.  Each fingerprint gets its own subdirectory, so a changed
config builds a new cache and never reads stale rows.  Concurrency: rows
land at distinct offsets with a ``valid`` byte flipped after them; racing
fillers (loader threads, worker processes) write the same deterministic
bytes; creation is serialised with an ``flock``; the memmaps are reopened
after unpickling (the worker loader), not shipped.

numpy only: the worker-process loader reads this cache, and its workers
import no torch.
"""

from __future__ import annotations

import fcntl
import hashlib
import json
import os

import numpy as np

from .. import imaging
from . import transforms as T

#: bump when the cached layout or semantics change
_FORMAT_VERSION = 1


#: the kinds of file of an image id
_KINDS = ("image", "instances", "classes")


def _content_stamp(dataset) -> list:
    """A cheap probe of the first, middle and last image id's content, so
    a dataset regenerated in place with the same name and count is not
    aliased to stale rows: (path, size, mtime_ns) of each file of a tree
    on disk, a digest of the arrays of a tree held in memory (the fake
    fixture)."""
    if hasattr(dataset, "datasets"):  # a combined dataset: its parts
        return [s for ds in dataset.datasets for s in _content_stamp(ds)]
    tree, ids = getattr(dataset, "tree", None), getattr(dataset, "im_ids", None)
    if tree is None or not ids:
        return []
    stamp = []
    for im_id in {ids[0], ids[len(ids) // 2], ids[-1]}:
        if not hasattr(tree, "path"):
            digest = hashlib.sha256()
            for kind in _KINDS:
                digest.update(np.ascontiguousarray(
                    getattr(tree, kind)(im_id)).tobytes())
            stamp.append([im_id, digest.hexdigest()[:16]])
            continue
        for kind in _KINDS:
            p = tree.path(kind, im_id)
            try:
                st = os.stat(p)
                stamp.append([p, st.st_size, st.st_mtime_ns])
            except OSError:
                stamp.append([p, -1, -1])
    return sorted(stamp)


def cache_fingerprint(dataset, crop_size, relax: int, zero_pad: bool,
                      fused_crop_resize: bool) -> str:
    """Identity of the cached bytes: the dataset (``str``, length, content
    stamp) and every knob that changes them, the imaging backend
    included."""
    ident = json.dumps({
        "format": _FORMAT_VERSION,
        "dataset": str(dataset),
        "n": len(dataset),
        "content": _content_stamp(dataset),
        "crop_size": list(crop_size),
        "relax": int(relax),
        "zero_pad": bool(zero_pad),
        "fused_crop_resize": bool(fused_crop_resize),
        "imaging_backend": imaging.backend(),
    }, sort_keys=True)
    return hashlib.sha256(ident.encode()).hexdigest()[:16]


def _needs_init(meta_path: str, expect_meta: dict) -> bool:
    """Whether the layout must be (re)created: ``meta.json`` missing,
    unreadable or describing another layout."""
    if not os.path.isfile(meta_path):
        return True
    try:
        with open(meta_path) as f:
            return json.load(f) != expect_meta
    except (ValueError, OSError):
        return True


def _open_maps(cache_dir: str, expect_meta: dict, layout) -> dict:
    """Open (or create or reset) the cache's memmaps under ``cache_dir``.

    A stale ``meta.json`` resets every file, and ``meta.json`` lands last,
    so a half-created cache is never trusted.  Creation runs under an
    exclusive ``flock``, re-checked under the lock: two racing openers
    would otherwise both truncate (``mode='w+'``) rows the other wrote.
    ``flock``, so a crashed creator's lock dies with it."""
    os.makedirs(cache_dir, exist_ok=True)
    meta_path = os.path.join(cache_dir, "meta.json")
    if _needs_init(meta_path, expect_meta):
        lock_fd = os.open(os.path.join(cache_dir, ".init.lock"),
                          os.O_CREAT | os.O_RDWR, 0o644)
        try:
            fcntl.flock(lock_fd, fcntl.LOCK_EX)
            if _needs_init(meta_path, expect_meta):  # lost the race?
                for name, shape, dtype in layout:
                    mm = np.memmap(os.path.join(cache_dir, name), mode="w+",
                                   dtype=dtype, shape=shape)
                    del mm  # creation (ftruncate to size) is all needed
                with open(meta_path + ".tmp", "w") as f:
                    json.dump(expect_meta, f)
                os.replace(meta_path + ".tmp", meta_path)
        finally:
            fcntl.flock(lock_fd, fcntl.LOCK_UN)
            os.close(lock_fd)
    return {name: np.memmap(os.path.join(cache_dir, name), mode="r+",
                            dtype=dtype, shape=shape)
            for name, shape, dtype in layout}


class _PreparedCacheBase:
    """What both caches share: pickling (the maps reopen, the files are
    the shared state), length, ids, eager prebuild and the ordered flush.
    Subclasses define ``_open_or_create``, ``_fill`` and ``__getitem__``."""

    def __getstate__(self):
        state = self.__dict__.copy()
        state.pop("_maps")
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)
        self._open_or_create()

    def __len__(self) -> int:
        return len(self.dataset)

    def sample_image_id(self, index: int) -> str:
        return self.dataset.sample_image_id(index)

    @property
    def n_prepared(self) -> int:
        """Rows already cached."""
        return int(np.count_nonzero(self._maps["valid.u8"]))

    def prebuild(self, num_workers: int = 0) -> None:
        """Fill every missing row now (a first epoch does it lazily)."""
        missing = np.flatnonzero(self._maps["valid.u8"] == 0)
        if num_workers > 0:
            import concurrent.futures as cf
            with cf.ThreadPoolExecutor(max_workers=num_workers) as pool:
                list(pool.map(self._fill, missing.tolist()))
        else:
            for i in missing.tolist():
                self._fill(i)
        self.flush()

    def flush(self) -> None:
        """msync the maps, the data before the valid map: a crash during
        write-back must not persist a valid byte whose row did not land."""
        for name, mm in self._maps.items():
            if name != "valid.u8":
                mm.flush()
        self._maps["valid.u8"].flush()


class PreparedInstanceDataset(_PreparedCacheBase):
    """An instance dataset (built with ``transform=None``) behind a
    prepared-sample cache.  The first access of an index computes decode
    -> crop -> resize (the train stack's own crop front,
    ``pipeline.build_crop_stage``), writes the row and marks it valid;
    every later access, in any epoch or process, reads it.
    ``post_transform`` runs per access on the cached crop; ``bbox`` joins
    after it.  ``eval_protocol`` adds the full-resolution ``gt`` and
    ``void_pixels`` (uint8 0/1) for the paste-back metric, in a cache
    directory of its own."""

    def __init__(self, dataset, cache_dir: str,
                 crop_size=(512, 512), relax: int = 50,
                 zero_pad: bool = True, fused_crop_resize: bool = False,
                 post_transform=None, uint8_arrays: bool = False,
                 eval_protocol: bool = False,
                 max_im_size=(512, 512)):
        if getattr(dataset, "transform", None) is not None:
            raise ValueError(
                "PreparedInstanceDataset wraps the *untransformed* dataset "
                "(construct it with transform=None); the crop stage it would "
                "run is exactly what this cache replaces")
        self.dataset = dataset
        self.crop_size = tuple(int(v) for v in crop_size)
        self.relax = int(relax)
        self.zero_pad = bool(zero_pad)
        self.fused_crop_resize = bool(fused_crop_resize)
        self.post_transform = post_transform
        #: serve the uint8 crop as is (the uint8 wire's format)
        self.uint8_arrays = bool(uint8_arrays)
        self.eval_protocol = bool(eval_protocol)
        self.max_im_size = tuple(int(v) for v in max_im_size)

        from .pipeline import build_crop_stage
        self._stage1 = T.Compose(build_crop_stage(
            self.crop_size, relax, zero_pad, fused=fused_crop_resize,
            clamp=True))
        self.fingerprint = cache_fingerprint(
            dataset, self.crop_size, relax, zero_pad, fused_crop_resize)
        suffix = "-eval" if self.eval_protocol else ""
        self.cache_dir = os.path.join(cache_dir, self.fingerprint + suffix)
        self._open_or_create()

    def _open_or_create(self) -> None:
        n = len(self.dataset)
        h, w = self.crop_size
        self._npack = (h * w + 7) // 8
        mh, mw = self.max_im_size
        self._npack_full = (mh * mw + 7) // 8
        meta = {"format": _FORMAT_VERSION, "fingerprint": self.fingerprint,
                "n": n, "crop_size": [h, w]}
        if self.eval_protocol:
            meta["eval"] = True
            meta["max_im_size"] = [mh, mw]
        self._maps = _open_maps(self.cache_dir, meta, self._layout(n, h, w))

    def _layout(self, n, h, w):
        layout = [
            ("images.u8", (n, h, w, 3), np.uint8),
            ("masks.u8", (n, self._npack), np.uint8),
            ("bboxes.i64", (n, 4), np.int64),
            ("sizes.i32", (n, 2), np.int32),
            ("valid.u8", (n,), np.uint8),
        ]
        if self.eval_protocol:
            layout += [
                ("fullgt.u8", (n, self._npack_full), np.uint8),
                ("fullvoid.u8", (n, self._npack_full), np.uint8),
            ]
        return layout

    def _fill(self, index: int):
        raw = self.dataset.__getitem__(index)
        sample = self._stage1(dict(raw), None)
        img8 = np.rint(np.asarray(sample["crop_image"],
                                  np.float32)).astype(np.uint8)
        gt = np.asarray(sample["crop_gt"], np.float32)
        if gt.ndim == 3:
            gt = gt[..., 0]
        bits = np.packbits(gt.reshape(-1) > 0.5)
        bbox = np.asarray(sample["bbox"], np.int64)
        im_size = raw["meta"]["im_size"] if "meta" in raw \
            else raw["image"].shape[:2]
        if self.eval_protocol:
            fh, fw = (int(v) for v in im_size)
            if fh * fw > self.max_im_size[0] * self.max_im_size[1]:
                raise ValueError(
                    f"source image {fh}x{fw} exceeds the eval cache's "
                    f"max_im_size {self.max_im_size}; raise max_im_size "
                    "(row bytes scale with it)")
            for key, src in (("fullgt.u8", raw["gt"]),
                             ("fullvoid.u8", raw.get("void_pixels"))):
                row = np.zeros(self._npack_full, np.uint8)
                if src is not None:
                    packed = np.packbits(np.asarray(src).reshape(-1) > 0.5)
                    row[:packed.size] = packed
                self._maps[key][index] = row
        self._maps["images.u8"][index] = img8
        self._maps["masks.u8"][index] = bits
        self._maps["bboxes.i64"][index] = bbox
        self._maps["sizes.i32"][index] = im_size
        self._maps["valid.u8"][index] = 1
        return img8, bits, bbox, tuple(int(v) for v in im_size)

    def __getitem__(self, index: int,
                    rng: np.random.Generator | None = None) -> dict:
        index = int(index)
        h, w = self.crop_size
        if self._maps["valid.u8"][index]:
            img8 = np.asarray(self._maps["images.u8"][index])
            bits = np.asarray(self._maps["masks.u8"][index])
            bbox = np.asarray(self._maps["bboxes.i64"][index]).copy()
            im_size = tuple(int(v) for v in self._maps["sizes.i32"][index])
            if not (img8.any() and bits.any() and bbox.any()
                    and bbox[2] >= bbox[0] and bbox[3] >= bbox[1]
                    and im_size[0] > 0 and im_size[1] > 0
                    and (not self.eval_protocol
                         or self._maps["fullgt.u8"][index].any())):
                # a torn write (valid landed, a row did not): every file's
                # pages persist on their own, so any row can be the zero
                # one; a real sample never is (area filter, non-black
                # crop, a box, a size): refill, idempotently
                img8, bits, bbox, im_size = self._fill(index)
        else:
            img8, bits, bbox, im_size = self._fill(index)
        gt = np.unpackbits(bits, count=h * w).reshape(h, w)
        if self.uint8_arrays:
            # a copy: img8 may be a view of the writable memmap row
            sample = {"crop_image": img8.copy(), "crop_gt": gt}
        else:
            sample = {"crop_image": img8.astype(np.float32),
                      "crop_gt": gt.astype(np.float32)}
        sample["meta"] = self._meta(index, im_size)
        if self.post_transform is not None:
            sample = self.post_transform(sample, rng)
        # after the random stage, which would warp a 4-vector too
        sample["bbox"] = bbox
        if self.eval_protocol:
            fh, fw = im_size
            for key, src in (("gt", "fullgt.u8"),
                             ("void_pixels", "fullvoid.u8")):
                sample[key] = np.unpackbits(
                    np.asarray(self._maps[src][index]),
                    count=fh * fw).reshape(fh, fw)
        return sample

    def _meta(self, index: int, im_size: tuple[int, int]) -> dict:
        """The sample's ``meta`` without the image bytes: a combined
        dataset is unwrapped to the part that owns the sample."""
        ds, local = self.dataset, index
        while hasattr(ds, "datasets") and hasattr(ds, "index"):
            di, local = ds.index[local]
            ds = ds.datasets[di]
        meta = {"image": ds.sample_image_id(local), "im_size": im_size}
        obj_list = getattr(ds, "obj_list", None)
        if obj_list is not None:
            im_ii, obj_ii = obj_list[local]
            meta["object"] = str(obj_ii)
            meta["category"] = ds.obj_dict[ds.im_ids[im_ii]][obj_ii]
        return meta

    def __str__(self) -> str:
        kind = "PreparedEval" if self.eval_protocol else "Prepared"
        return (f"{kind}({self.dataset},crop={self.crop_size},"
                f"relax={self.relax},fp={self.fingerprint})")


class PreparedSemanticDataset(_PreparedCacheBase):
    """A semantic dataset (built with ``transform=None``) behind a
    prepared-sample cache: the resized image as uint8 and the class ids as
    uint8 (0..20 and 255 void, exact).  Flip and scale-rotate run per
    access downstream, after the resize.  ``keep_fullres`` also caches the
    native-resolution ids in padded rows, emitted as ``gt_full`` for the
    full-resolution mIoU protocol."""

    def __init__(self, dataset, cache_dir: str, crop_size=(513, 513),
                 post_transform=None, uint8_arrays: bool = False,
                 keep_fullres: bool = False, max_im_size=(512, 512)):
        if getattr(dataset, "transform", None) is not None:
            raise ValueError(
                "PreparedSemanticDataset wraps the *untransformed* dataset "
                "(construct it with transform=None)")
        self.dataset = dataset
        self.crop_size = tuple(int(v) for v in crop_size)
        self.post_transform = post_transform
        self.uint8_arrays = bool(uint8_arrays)
        self.keep_fullres = bool(keep_fullres)
        self.max_im_size = tuple(int(v) for v in max_im_size)
        self._stage1 = T.Compose([
            T.FixedResize(resolutions={"image": self.crop_size,
                                       "gt": self.crop_size},
                          flagvals={"image": None, "gt": 0}),
            T.ClampRange(("image",)),
        ])
        # no relax/zero_pad/fused in the semantic front: pinned values keep
        # one fingerprint function for both caches
        self.fingerprint = cache_fingerprint(
            dataset, self.crop_size, relax=0, zero_pad=False,
            fused_crop_resize=False)
        suffix = "-fullres" if self.keep_fullres else ""
        self.cache_dir = os.path.join(cache_dir, self.fingerprint + suffix)
        self._open_or_create()

    def _layout(self, n, h, w):
        layout = [
            ("images.u8", (n, h, w, 3), np.uint8),
            ("gts.u8", (n, h, w), np.uint8),
            ("sizes.i32", (n, 2), np.int32),
            ("valid.u8", (n,), np.uint8),
        ]
        if self.keep_fullres:
            mh, mw = self.max_im_size
            layout.append(("gtfull.u8", (n, mh * mw), np.uint8))
        return layout

    def _open_or_create(self) -> None:
        h, w = self.crop_size
        meta = {"format": _FORMAT_VERSION, "fingerprint": self.fingerprint,
                "n": len(self.dataset), "crop_size": [h, w],
                "kind": "semantic"}
        if self.keep_fullres:
            meta["fullres"] = True
            meta["max_im_size"] = list(self.max_im_size)
        self._maps = _open_maps(self.cache_dir, meta,
                                self._layout(len(self.dataset), h, w))

    def _fill(self, index: int):
        raw = self.dataset.__getitem__(index)
        sample = self._stage1(dict(raw), None)
        img8 = np.rint(np.asarray(sample["image"],
                                  np.float32)).astype(np.uint8)
        gt8 = np.rint(np.asarray(sample["gt"], np.float32)).astype(np.uint8)
        im_size = raw["meta"]["im_size"] if "meta" in raw \
            else raw["image"].shape[:2]
        if self.keep_fullres:
            fh, fw = (int(v) for v in im_size)
            if fh * fw > self.max_im_size[0] * self.max_im_size[1]:
                raise ValueError(
                    f"source image {fh}x{fw} exceeds the fullres cache's "
                    f"max_im_size {self.max_im_size}; raise "
                    "data.val_max_im_size (row bytes scale with it)")
            row = np.zeros(self.max_im_size[0] * self.max_im_size[1],
                           np.uint8)
            full = np.rint(np.asarray(raw["gt"], np.float32)
                           ).astype(np.uint8).reshape(-1)
            row[:full.size] = full
            self._maps["gtfull.u8"][index] = row
        self._maps["images.u8"][index] = img8
        self._maps["gts.u8"][index] = gt8
        self._maps["sizes.i32"][index] = im_size
        self._maps["valid.u8"][index] = 1
        return img8, gt8, tuple(int(v) for v in im_size)

    def __getitem__(self, index: int,
                    rng: np.random.Generator | None = None) -> dict:
        index = int(index)
        if self._maps["valid.u8"][index]:
            img8 = np.asarray(self._maps["images.u8"][index])
            gt8 = np.asarray(self._maps["gts.u8"][index])
            im_size = tuple(int(v) for v in self._maps["sizes.i32"][index])
            if not (img8.any() and gt8.any()
                    and im_size[0] > 0 and im_size[1] > 0
                    and (not self.keep_fullres
                         or self._maps["gtfull.u8"][index].any())):
                # a torn write: a real photo is never all black, a VOC
                # mask never all background, a size never zero: refill
                img8, gt8, im_size = self._fill(index)
        else:
            img8, gt8, im_size = self._fill(index)
        if self.uint8_arrays:
            # copies, not views of the writable memmap rows
            sample = {"image": img8.copy(), "gt": gt8.copy()}
        else:
            sample = {"image": img8.astype(np.float32),
                      "gt": gt8.astype(np.float32)}
        sample["meta"] = {"image": self.dataset.sample_image_id(index),
                          "im_size": im_size}
        if self.post_transform is not None:
            sample = self.post_transform(sample, rng)
        if self.keep_fullres:
            fh, fw = im_size
            # a copy: the slice shares the writable memmap buffer
            sample["gt_full"] = np.asarray(
                self._maps["gtfull.u8"][index][:fh * fw]
            ).reshape(fh, fw).copy()
        return sample

    def __str__(self) -> str:
        kind = "PreparedSemanticFullres" if self.keep_fullres \
            else "PreparedSemantic"
        return (f"{kind}({self.dataset},crop={self.crop_size},"
                f"fp={self.fingerprint})")
