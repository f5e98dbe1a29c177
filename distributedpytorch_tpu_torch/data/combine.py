"""Datasets merged with exclusion, the counterpart of
``distributedpytorch_tpu/data/combine.py``: ``CombinedDataset([train, sbd],
excluded=[val])`` is how ``data.sbd_root`` adds SBD to VOC training while
keeping VOC val's images out of it.  Any datasets with ``__len__``,
``__getitem__(i, rng)`` and ``sample_image_id(i)`` combine.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np


class CombinedDataset:
    """The concatenation of ``datasets`` minus every sample whose image id
    occurs in an ``excluded`` dataset, and, with ``dedupe``, minus the
    samples of an image an earlier part already listed (first wins: VOC
    train's images are not added again through their SBD copies).  Each
    part keeps its own transform.

    The parts must yield one sample schema (``collate`` stacks by the
    first sample's keys): the constructor runs one full sample of each
    part and raises on a mismatch unless ``allow_mixed_schemas``."""

    def __init__(self, datasets: Sequence, excluded: Sequence = (),
                 allow_mixed_schemas: bool = False, dedupe: bool = True):
        self.datasets = list(datasets)
        if not allow_mixed_schemas and len(self.datasets) > 1:
            probe_rng = np.random.default_rng(0)
            schemas = [frozenset(ds.__getitem__(0, probe_rng).keys())
                       if len(ds) else frozenset() for ds in self.datasets]
            live = {s for s in schemas if s}
            if len(live) > 1:
                raise ValueError(
                    "constituent datasets yield different sample schemas "
                    f"({[sorted(s) for s in live]}); such a mix cannot be "
                    "batched — pass allow_mixed_schemas=True only for "
                    "unbatched access")
        excluded_ids: set[str] = set()
        for ds in excluded:
            excluded_ids |= {ds.sample_image_id(i) for i in range(len(ds))}
        #: flat index: (part, the part's sample index)
        self.index: list[tuple[int, int]] = []
        seen_ids: set[str] = set()  # the image ids of earlier parts
        for di, ds in enumerate(self.datasets):
            ds_ids = set()
            for si in range(len(ds)):
                im_id = ds.sample_image_id(si)
                ds_ids.add(im_id)
                if im_id in excluded_ids or (dedupe and im_id in seen_ids):
                    continue
                self.index.append((di, si))
            seen_ids |= ds_ids

    def __len__(self) -> int:
        return len(self.index)

    def sample_image_id(self, index: int) -> str:
        di, si = self.index[index]
        return self.datasets[di].sample_image_id(si)

    def __getitem__(self, index: int,
                    rng: np.random.Generator | None = None) -> dict:
        di, si = self.index[index]
        return self.datasets[di].__getitem__(si, rng)

    def __str__(self) -> str:
        parts = " + ".join(str(d) for d in self.datasets)
        return f"Combined({parts}, n={len(self)})"
