"""Input pipelines, the counterpart of ``distributedpytorch_tpu/data/pipeline.py``:
the default train and val transform stacks, the per-sample RNG policy,
``collate`` and the threaded, prefetching ``DataLoader``.

Batches are dicts of stacked HWC float32 numpy arrays (ragged keys and
metadata stay lists), exactly as in the JAX package; the train step turns
them into NCHW torch tensors on the device.  Every sample's RNG is
``default_rng((seed, epoch, index))`` and the epoch's order is
``default_rng((seed, epoch))``'s permutation, so data order and content do
not depend on the worker count.  Only the ``nellipse_gaussians`` guidance
family is ported.
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


def build_train_transform(crop_size: tuple[int, int] = (512, 512),
                          relax: int = 50, zero_pad: bool = True,
                          rots: tuple[float, float] = (-20, 20),
                          scales: tuple[float, float] = (0.75, 1.25),
                          alpha: float = 0.6,
                          guidance: str = "nellipse_gaussians") -> T.Compose:
    """The training stack: flip -> scale/rotate -> crop around the object
    with ``relax`` -> resize to ``crop_size`` -> guidance -> concat."""
    return T.Compose([
        T.RandomHorizontalFlip(),
        T.ScaleNRotate(rots=rots, scales=scales),
        T.CropFromMaskStatic(crop_elems=("image", "gt"), mask_elem="gt",
                             relax=relax, zero_pad=zero_pad),
        T.FixedResize(resolutions={"crop_image": crop_size,
                                   "crop_gt": crop_size}),
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


#: keys that stay python lists in a batch (metadata)
_NO_STACK_KEYS = ("meta", "id", "crop_relax")


def sample_rng(seed: int, epoch: int, index: int) -> np.random.Generator:
    """The per-sample RNG: ``default_rng((seed, epoch, index))``."""
    return np.random.default_rng((seed, epoch, int(index)))


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
    """Shuffling, prefetching batch iterator over a random-access dataset
    (``dataset.__getitem__(index, rng=...)``), one process.

    ``num_workers`` threads load each batch's samples; up to ``prefetch``
    collated batches wait ahead of the consumer.  A worker's error is
    raised from the iterator."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = False,
                 drop_last: bool = False, seed: int = 0, num_workers: int = 2,
                 prefetch: int = 2):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.num_workers = max(0, num_workers)
        self.prefetch = max(1, prefetch)
        self.epoch = 0
        self.start_batch = 0

    def set_epoch(self, epoch: int, start_batch: int = 0) -> None:
        """Position the loader at ``epoch``; ``start_batch`` skips that many
        batches of the epoch's fixed ``(seed, epoch)`` order, so a resumed
        run continues where a preempted one stopped.  ``len`` still counts
        the whole epoch."""
        self.epoch = epoch
        self.start_batch = start_batch

    def epoch_indices(self) -> np.ndarray:
        """The dataset indices of the current epoch in order."""
        order = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.default_rng((self.seed, self.epoch)).shuffle(order)
        return order

    def __len__(self) -> int:
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last \
            else -(-n // self.batch_size)

    def _load_one(self, index: int) -> dict:
        return self.dataset.__getitem__(
            int(index), rng=sample_rng(self.seed, self.epoch, index))

    def __iter__(self) -> Iterator[dict]:
        order = self.epoch_indices()
        batches = [order[i * self.batch_size:(i + 1) * self.batch_size]
                   for i in range(self.start_batch, len(self))]
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
