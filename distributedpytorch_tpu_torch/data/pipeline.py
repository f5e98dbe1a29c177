"""Input pipelines, the counterpart of ``distributedpytorch_tpu/data/pipeline.py``:
the default train and val transform stacks of the instance and semantic
tasks, the per-sample RNG policy, ``collate`` and the threaded,
prefetching ``DataLoader``.

Batches are dicts of stacked HWC float32 numpy arrays (ragged keys and
metadata stay lists), exactly as in the JAX package; the train step turns
them into NCHW torch tensors on the device.  Every sample's RNG is
``default_rng((seed, epoch, index))`` and the epoch's order is
``default_rng((seed, epoch))``'s permutation, so data order and content do
not depend on the worker count.  Only the ``nellipse_gaussians`` guidance
family is ported.

Under data parallelism each rank's loader walks its shard
(:func:`shard_order`, the JAX rule: contiguous per-shard slices of the
epoch's permutation, padded by wrap-around to equal lengths), so global
batch k is the ranks' batch k in rank order.  With ``micro_batches`` m >
1 each rank's batch k is instead its slice of each of the m global
micro-batches of global batch k (rows ``[i·M + r·M/W, i·M + (r+1)·M/W)``
of micro-batch i, M its size), as the JAX ``dp`` step splits the global
batch before sharding each micro-batch; the step then splits the rank's
rows locally into the same m parts.
"""

from __future__ import annotations

import concurrent.futures as cf
import queue
import threading
from typing import Iterator, Sequence

import numpy as np

from . import transforms as T

#: the default guidance channel's sample key
GUIDANCE_KEY = "nellipseWithGaussians"


def _guidance_stage(guidance: str, alpha: float,
                    is_val: bool) -> list[T.Transform]:
    if guidance != "nellipse_gaussians":
        raise NotImplementedError(
            f"data.guidance={guidance!r} is not ported yet "
            "(nellipse_gaussians only)")
    return [T.NEllipseWithGaussians(alpha=alpha, is_val=is_val),
            T.ConcatInputs(elems=("crop_image", GUIDANCE_KEY))]


def build_crop_stage(crop_size: tuple[int, int], relax: int, zero_pad: bool,
                     fused: bool = False,
                     clamp: bool = True) -> list[T.Transform]:
    """The crop front of the train stack: crop around the object with
    ``relax``, then resize to ``crop_size`` — two transforms, or with
    ``fused`` one pass of the host library's fused crop + resize
    (:class:`~.transforms.FusedCropResize`).  ``clamp`` bounds the cubic
    resize's overshoot back into [0, 255]: needed wherever no uint8 cast
    sits upstream, as the fused pass resizes in float32 always."""
    if fused:
        stage = [T.FusedCropResize(crop_elems=("image", "gt"), mask_elem="gt",
                                   relax=relax, zero_pad=zero_pad,
                                   size=crop_size)]
    else:
        stage = [T.CropFromMaskStatic(crop_elems=("image", "gt"),
                                      mask_elem="gt", relax=relax,
                                      zero_pad=zero_pad),
                 T.FixedResize(resolutions={"crop_image": crop_size,
                                            "crop_gt": crop_size})]
    return stage + ([T.ClampRange(("crop_image",))] if clamp else [])


def build_train_transform(crop_size: tuple[int, int] = (512, 512),
                          relax: int = 50, zero_pad: bool = True,
                          rots: tuple[float, float] = (-20, 20),
                          scales: tuple[float, float] = (0.75, 1.25),
                          alpha: float = 0.6,
                          guidance: str = "nellipse_gaussians",
                          fused_crop_resize: bool = False) -> T.Compose:
    """The training stack: flip -> scale/rotate -> crop around the object
    with ``relax`` -> resize to ``crop_size`` -> guidance -> concat.
    ``fused_crop_resize`` makes the crop and resize one pass
    (:func:`build_crop_stage`), clamped, as ScaleNRotate's uint8 cast no
    longer bounds the resized image."""
    return T.Compose([
        T.RandomHorizontalFlip(),
        T.ScaleNRotate(rots=rots, scales=scales),
        *build_crop_stage(crop_size, relax, zero_pad, fused=fused_crop_resize,
                          clamp=fused_crop_resize),
        *_guidance_stage(guidance, alpha, is_val=False),
        T.ToArray(),
    ])


def build_eval_transform(crop_size: tuple[int, int] = (512, 512),
                         relax: int = 50, zero_pad: bool = True,
                         alpha: float = 0.6,
                         guidance: str = "nellipse_gaussians",
                         keep_fullres: bool = True) -> T.Compose:
    """The validation stack: deterministic guidance, ``gt``/``void_pixels``
    kept at full resolution for the paste-back metric."""
    resolutions = {"crop_image": crop_size, "crop_gt": crop_size}
    if keep_fullres:
        resolutions.update({"gt": None, "void_pixels": None})
    return T.Compose([
        T.CropFromMaskStatic(crop_elems=("image", "gt"), mask_elem="gt",
                             relax=relax, zero_pad=zero_pad),
        T.FixedResize(resolutions=resolutions),
        T.ClampRange(("crop_image",)),
        *_guidance_stage(guidance, alpha, is_val=True),
        T.ToArray(),
    ])


def build_semantic_train_transform(
        crop_size: tuple[int, int] = (513, 513),
        rots: tuple[float, float] = (-10, 10),
        scales: tuple[float, float] = (0.5, 2.0)) -> T.Compose:
    """The semantic training stack (one sample per image): flip ->
    scale/rotate (class ids nearest, 255 border) -> resize to
    ``crop_size`` (the image by its values' rule, the class ids nearest so
    ids and the 255 void stay exact) -> clamp -> ``concat``/``crop_gt``."""
    return T.Compose([
        T.RandomHorizontalFlip(),
        T.ScaleNRotate(rots=rots, scales=scales, semseg=True),
        T.FixedResize(resolutions={"image": crop_size, "gt": crop_size},
                      flagvals={"image": None, "gt": 0}),
        T.ClampRange(("image",)),
        T.Rename({"image": "concat", "gt": "crop_gt"}),
        T.ToArray(),
    ])


def build_semantic_eval_transform(crop_size: tuple[int, int] = (513, 513),
                                  keep_fullres: bool = False) -> T.Compose:
    """The semantic validation stack: resize only (the class ids nearest),
    clamp, ``concat``/``crop_gt``; ``keep_fullres`` keeps the native
    ``gt`` as ``gt_full`` for the full-resolution protocol."""
    res: dict = {"image": crop_size, "gt": crop_size}
    flags: dict = {"image": None, "gt": 0}
    chain: list[T.Transform] = []
    if keep_fullres:
        chain.append(T.Duplicate({"gt": "gt_full"}))
        res["gt_full"] = None
        flags["gt_full"] = 0
    return T.Compose(chain + [
        T.FixedResize(resolutions=res, flagvals=flags),
        T.ClampRange(("image",)),
        T.Rename({"image": "concat", "gt": "crop_gt"}),
        T.ToArray(),
    ])


#: keys that stay python lists in a batch (metadata)
_NO_STACK_KEYS = ("meta", "id", "crop_relax")


def sample_rng(seed: int, epoch: int, index: int) -> np.random.Generator:
    """The per-sample RNG: ``default_rng((seed, epoch, index))``."""
    return np.random.default_rng((seed, epoch, int(index)))


def shard_order(order: np.ndarray, num_shards: int,
                shard_index: int) -> np.ndarray:
    """Shard ``shard_index`` of ``order``: the order padded by wrap-around
    to a multiple of ``num_shards``, cut into equal contiguous slices
    (every sample in some shard, no shard shorter than another)."""
    if num_shards <= 1:
        return order
    n = len(order)
    per_shard = -(-n // num_shards)
    total = per_shard * num_shards
    if total > n:
        order = np.concatenate([order, order[:total - n]])
    return order[shard_index * per_shard:(shard_index + 1) * per_shard]


def micro_batch_rows(shard_batches: Sequence[np.ndarray], shard_index: int,
                     micro_batches: int) -> np.ndarray:
    """Rank ``shard_index``'s rows of one global batch laid out for
    ``micro_batches`` accumulation steps: the global batch is the shards'
    batches (``shard_batches``, in rank order) concatenated, cut into
    ``micro_batches`` contiguous micro-batches, and each of those into
    equal contiguous slices, one per rank; the rank's rows are its slices
    of every micro-batch, in order."""
    rows = np.concatenate(list(shard_batches))
    w = len(shard_batches)
    if len(rows) % (micro_batches * w):
        raise ValueError(f"global batch {len(rows)} not divisible by "
                         f"{w} shards x {micro_batches} micro-batches")
    m = len(rows) // micro_batches
    part = m // w
    return np.concatenate([
        rows[i * m + shard_index * part:i * m + (shard_index + 1) * part]
        for i in range(micro_batches)])


def collate(samples: Sequence[dict]) -> dict:
    """Stack dict samples into a batch: same-shape keys on a new leading
    axis, ragged keys (full-resolution ``gt``/``void_pixels``) and metadata
    as lists."""
    out: dict = {}
    for key in samples[0]:
        vals = [s[key] for s in samples]
        if key in _NO_STACK_KEYS or len({np.asarray(v).shape for v in vals}) != 1:
            out[key] = vals
        else:
            out[key] = np.stack([np.asarray(v) for v in vals])
    return out


class DataLoader:
    """Sharded, shuffling, prefetching batch iterator over a random-access
    dataset (``dataset.__getitem__(index, rng=...)``).

    ``num_workers`` threads load each batch's samples; up to ``prefetch``
    collated batches wait ahead of the consumer.  A worker's error is
    raised from the iterator.  ``num_shards``/``shard_index`` walk one
    shard of the epoch (one per rank); ``micro_batches`` lays each batch
    out for accumulation over the shards (see the module docstring; it
    needs ``drop_last``)."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = False,
                 drop_last: bool = False, seed: int = 0, num_workers: int = 2,
                 prefetch: int = 2, num_shards: int = 1, shard_index: int = 0,
                 micro_batches: int = 1):
        if micro_batches > 1 and num_shards > 1 and not drop_last:
            raise ValueError("micro_batches over shards needs drop_last")
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.num_workers = max(0, num_workers)
        self.prefetch = max(1, prefetch)
        self.num_shards = max(1, num_shards)
        self.shard_index = shard_index
        self.micro_batches = max(1, micro_batches)
        self.epoch = 0
        self.start_batch = 0

    def set_epoch(self, epoch: int, start_batch: int = 0) -> None:
        """Position the loader at ``epoch``; ``start_batch`` skips that many
        batches of the epoch's fixed ``(seed, epoch)`` order, so a resumed
        run continues where a preempted one stopped.  ``len`` still counts
        the whole epoch."""
        self.epoch = epoch
        self.start_batch = start_batch

    def _permutation(self) -> np.ndarray:
        order = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.default_rng((self.seed, self.epoch)).shuffle(order)
        return order

    def epoch_indices(self, shard_index: int | None = None) -> np.ndarray:
        """The dataset indices of the current epoch in order: this
        loader's shard (or shard ``shard_index``) of the permutation."""
        return shard_order(self._permutation(), self.num_shards,
                           self.shard_index if shard_index is None
                           else shard_index)

    def __len__(self) -> int:
        n = len(self.epoch_indices())
        return n // self.batch_size if self.drop_last \
            else -(-n // self.batch_size)

    def batch_indices(self) -> list[np.ndarray]:
        """The dataset indices of every batch of the current epoch."""
        b = self.batch_size
        if self.micro_batches == 1 or self.num_shards == 1:
            order = self.epoch_indices()
            return [order[i * b:(i + 1) * b] for i in range(len(self))]
        orders = [self.epoch_indices(s) for s in range(self.num_shards)]
        return [micro_batch_rows([o[i * b:(i + 1) * b] for o in orders],
                                 self.shard_index, self.micro_batches)
                for i in range(len(self))]

    def _load_one(self, index: int) -> dict:
        return self.dataset.__getitem__(
            int(index), rng=sample_rng(self.seed, self.epoch, index))

    def __iter__(self) -> Iterator[dict]:
        batches = self.batch_indices()[self.start_batch:]
        if self.num_workers == 0:
            for idxs in batches:
                yield collate([self._load_one(i) for i in idxs])
            return
        yield from self._prefetched(batches)

    def _prefetched(self, batches: list[np.ndarray]) -> Iterator[dict]:
        out_q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        done = object()
        stop = threading.Event()

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    out_q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    pass
            return False

        def producer():
            with cf.ThreadPoolExecutor(self.num_workers) as pool:
                try:
                    for idxs in batches:
                        if not put(collate(list(pool.map(self._load_one, idxs)))):
                            return
                except BaseException as e:  # raised from the iterator
                    put(e)
                finally:
                    put(done)

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        try:
            while (item := out_q.get()) is not done:
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()
            thread.join()
