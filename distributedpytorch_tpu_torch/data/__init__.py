"""Host data layer of the port (numpy, no torch): the VOC and SBD datasets,
their combination, the in-memory fake VOC and the on-disk fake SBD, the
train/val transform stacks and the prepared-sample
builders, guidance synthesis, the prepared-sample cache, the threaded and
worker-process loaders and the feed governor."""

from . import guidance, transforms
from .combine import CombinedDataset
from .fake import make_fake_sbd, make_fake_voc
from .governor import GOVERNOR_MODES, FeedActuators, FeedGovernor, feed_block
from .grain_pipeline import GrainDataLoader
from .pipeline import (
    DataLoader,
    build_eval_transform,
    build_prepared_eval_post_transform,
    build_prepared_post_transform,
    build_prepared_semantic_eval_post_transform,
    build_prepared_semantic_post_transform,
    build_semantic_eval_transform,
    build_semantic_train_transform,
    build_train_transform,
    collate,
)
from .prepared import (
    PreparedInstanceDataset,
    PreparedSemanticDataset,
    cache_fingerprint,
)
from .sbd import SBDInstanceSegmentation, SBDSemanticSegmentation
from .voc import VOCInstanceSegmentation, VOCSemanticSegmentation

__all__ = [
    "CombinedDataset",
    "DataLoader",
    "FeedActuators",
    "FeedGovernor",
    "GOVERNOR_MODES",
    "GrainDataLoader",
    "PreparedInstanceDataset",
    "PreparedSemanticDataset",
    "SBDInstanceSegmentation",
    "SBDSemanticSegmentation",
    "VOCInstanceSegmentation",
    "VOCSemanticSegmentation",
    "build_eval_transform",
    "build_prepared_eval_post_transform",
    "build_prepared_post_transform",
    "build_prepared_semantic_eval_post_transform",
    "build_prepared_semantic_post_transform",
    "build_semantic_eval_transform",
    "build_semantic_train_transform",
    "build_train_transform",
    "cache_fingerprint",
    "collate",
    "feed_block",
    "guidance",
    "make_fake_sbd",
    "make_fake_voc",
    "transforms",
]
