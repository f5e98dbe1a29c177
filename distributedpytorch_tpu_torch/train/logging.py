"""Metric writers, the counterpart of ``distributedpytorch_tpu/train/logging.py``:
console lines and a ``metrics.jsonl`` stream (non-finite values written as
``null``) plus ``hparams.json``.  TensorBoard and Comet are not ported
yet; the figure panels are not ported either."""

from __future__ import annotations

import json
import math
import os
import time
from typing import Any, Mapping

import numpy as np


class MetricWriter:
    """Protocol: scalars and hparams sinks."""

    def scalars(self, metrics: Mapping[str, float], step: int) -> None: ...

    def hparams(self, params: Mapping[str, Any]) -> None: ...

    def flush(self) -> None: ...

    def close(self) -> None:
        self.flush()


class ConsoleWriter(MetricWriter):
    def __init__(self, prefix: str = ""):
        self.prefix = prefix

    def scalars(self, metrics, step):
        body = "  ".join(f"{k}={v:.6g}" if isinstance(v, float) else f"{k}={v}"
                         for k, v in metrics.items())
        print(f"{self.prefix}[step {step}] {body}", flush=True)

    def hparams(self, params):
        print(self.prefix + "hyperparameters:", flush=True)
        for k, v in params.items():
            print(f"{self.prefix}  {k}: {v}", flush=True)


def _jsonable(v):
    if isinstance(v, bool):
        return v
    if isinstance(v, (int, float, np.integer, np.floating)):
        f = float(v)
        return f if math.isfinite(f) else None
    if isinstance(v, dict):
        return {k: _jsonable(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_jsonable(x) for x in v]
    return v


class JsonlWriter(MetricWriter):
    """One line-buffered JSONL stream of scalar records under the run
    directory: ``{"step", "time", <metric>: value, ...}``."""

    def __init__(self, directory: str):
        self.directory = directory
        os.makedirs(directory, exist_ok=True)
        self._f = open(os.path.join(directory, "metrics.jsonl"), "a",
                       buffering=1)

    def scalars(self, metrics, step):
        rec = {"step": int(step), "time": time.time()}
        rec.update({k: _jsonable(v) for k, v in metrics.items()})
        self._f.write(json.dumps(rec, allow_nan=False, default=repr) + "\n")

    def hparams(self, params):
        with open(os.path.join(self.directory, "hparams.json"), "w") as f:
            json.dump({k: v if isinstance(v, (int, float, str, bool, type(None)))
                       else repr(v) for k, v in params.items()}, f, indent=2)

    def flush(self):
        self._f.flush()

    def close(self):
        self.flush()
        self._f.close()


class MultiWriter(MetricWriter):
    def __init__(self, *writers: MetricWriter):
        self.writers = list(writers)

    def scalars(self, metrics, step):
        for w in self.writers:
            w.scalars(metrics, step)

    def hparams(self, params):
        for w in self.writers:
            w.hparams(params)

    def flush(self):
        for w in self.writers:
            w.flush()

    def close(self):
        for w in self.writers:
            w.close()


def make_writer(name: str, run_dir: str) -> MetricWriter:
    """The writer behind one ``log_writers`` entry."""
    if name == "console":
        return ConsoleWriter()
    if name == "jsonl":
        return JsonlWriter(run_dir)
    if name in ("tensorboard", "comet"):
        raise NotImplementedError(f"log writer {name!r} is not ported yet "
                                  "(console | jsonl)")
    raise ValueError(f"unknown writer {name!r} "
                     "(console | jsonl | tensorboard | comet)")
