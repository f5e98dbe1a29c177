"""Metric writers and the validation figure, the counterpart of
``distributedpytorch_tpu/train/logging.py``.

One writer protocol (scalars, figures, hparams) over four backends,
selected by the ``log_writers`` knob through :func:`make_writer`: console
lines, a ``metrics.jsonl`` stream (non-finite values written as ``null``)
plus ``hparams.json``, TensorBoard events under ``run_dir/tb`` (torch's
``SummaryWriter``) and a Comet ML experiment.  The console and JSONL
writers ignore figures.  TensorBoard and Comet are optional: their import
is deferred, and a missing package (or, for Comet, a missing
``COMET_API_KEY``) makes the writer a no-op, so a run never dies of its
logging.  :func:`make_val_panels` draws the first validation batch's
figure (image and ground truth, then each output head) with matplotlib on
Agg.
"""

from __future__ import annotations

import json
import math
import os
import threading
import time
from typing import Any, Callable, Mapping

import numpy as np


class MetricWriter:
    """Protocol: scalars, figures and hparams sinks.  ``takes_figures``
    says whether :meth:`figure` records anything, so that a caller draws
    a figure only for a writer that keeps it."""

    takes_figures = False

    def scalars(self, metrics: Mapping[str, float], step: int) -> None: ...

    def figure(self, name: str, fig, step: int) -> None: ...

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


class TensorBoardWriter(MetricWriter):
    """TensorBoard events under ``directory`` through
    ``torch.utils.tensorboard.SummaryWriter``: numeric scalars, figures,
    and the hyperparameters as one text entry.  The import is deferred; if
    it fails (no ``tensorboard`` package) the writer is a no-op and writes
    nothing."""

    def __init__(self, directory: str):
        try:
            from torch.utils.tensorboard import SummaryWriter
            self._w = SummaryWriter(directory)
        except Exception:
            self._w = None

    @property
    def takes_figures(self) -> bool:
        return self._w is not None

    def scalars(self, metrics, step):
        if self._w:
            for k, v in metrics.items():
                if isinstance(v, (int, float)):
                    self._w.add_scalar(k, v, step)

    def figure(self, name, fig, step):
        if self._w:
            self._w.add_figure(name, fig, step)

    def hparams(self, params):
        if self._w:
            self._w.add_text("hparams", json.dumps(
                {k: str(v) for k, v in params.items()}, indent=2), 0)

    def flush(self):
        if self._w:
            self._w.flush()

    def close(self):
        if self._w:
            self._w.close()


class _Breaker:
    """Consecutive-failure counter: :meth:`call` runs a function, counts a
    failure (and re-raises), zeroes the count on success; :attr:`is_open`
    once ``threshold`` failures came in a row."""

    def __init__(self, threshold: int):
        self.threshold = threshold
        self._lock = threading.Lock()
        self._failures = 0

    @property
    def failures(self) -> int:
        with self._lock:
            return self._failures

    @property
    def is_open(self) -> bool:
        return self.failures >= self.threshold

    def call(self, fn: Callable[[], Any]) -> Any:
        try:
            result = fn()
        except Exception:
            with self._lock:
                self._failures += 1
            raise
        with self._lock:
            self._failures = 0
        return result


class CometWriter(MetricWriter):
    """A Comet ML experiment: numeric scalars, figures and hparams.  The
    API key comes only from ``COMET_API_KEY``; without it, or without the
    ``comet_ml`` SDK, the writer prints one line and is a no-op.  An error
    of the live SDK is printed and survived; after ``_MAX_FAILS`` in a row
    the experiment is dropped and the writer stays a no-op."""

    #: consecutive runtime failures tolerated before giving up on the SDK
    _MAX_FAILS = 5

    def __init__(self, project: str | None = None,
                 workspace: str | None = None,
                 experiment_name: str | None = None):
        self._exp = None
        self._breaker = _Breaker(self._MAX_FAILS)
        try:
            from comet_ml import Experiment
            if not os.environ.get("COMET_API_KEY"):
                raise RuntimeError("COMET_API_KEY is not set")
            kw: dict = {"log_code": False, "log_env_details": False}
            if project:
                kw["project_name"] = project
            if workspace:
                kw["workspace"] = workspace
            self._exp = Experiment(**kw)
            if experiment_name:
                self._exp.set_name(experiment_name)
        except Exception as e:
            print(f"CometWriter disabled: {e}", flush=True)

    @property
    def takes_figures(self) -> bool:
        return self._exp is not None

    @property
    def _fails(self) -> int:
        """Consecutive failures so far."""
        return self._breaker.failures

    def _guarded(self, call: Callable[[], Any]) -> None:
        try:
            self._breaker.call(call)
        except Exception as e:
            if self._breaker.is_open:
                print(f"CometWriter error (disabled after "
                      f"{self._breaker.failures} consecutive failures): "
                      f"{e}", flush=True)
                self._exp = None
            else:
                print(f"CometWriter error (will retry): {e}", flush=True)

    def scalars(self, metrics, step):
        if self._exp:
            self._guarded(lambda: self._exp.log_metrics(
                {k: v for k, v in metrics.items()
                 if isinstance(v, (int, float))}, step=step))

    def figure(self, name, fig, step):
        if self._exp:
            self._guarded(lambda: self._exp.log_figure(
                figure_name=name, figure=fig, step=step))

    def hparams(self, params):
        if self._exp:
            self._guarded(lambda: self._exp.log_parameters(
                {k: str(v) for k, v in params.items()}))

    def close(self):
        if self._exp:
            self._guarded(lambda: self._exp.end())


class MultiWriter(MetricWriter):
    def __init__(self, *writers: MetricWriter):
        self.writers = list(writers)

    @property
    def takes_figures(self) -> bool:
        return any(w.takes_figures for w in self.writers)

    def scalars(self, metrics, step):
        for w in self.writers:
            w.scalars(metrics, step)

    def figure(self, name, fig, step):
        for w in self.writers:
            w.figure(name, fig, step)

    def hparams(self, params):
        for w in self.writers:
            w.hparams(params)

    def flush(self):
        for w in self.writers:
            w.flush()

    def close(self):
        for w in self.writers:
            w.close()


def make_writer(name: str, run_dir: str,
                experiment_name: str | None = None,
                comet_project: str | None = None,
                comet_workspace: str | None = None) -> MetricWriter:
    """The writer behind one ``log_writers`` entry."""
    if name == "console":
        return ConsoleWriter()
    if name == "jsonl":
        return JsonlWriter(run_dir)
    if name == "tensorboard":
        return TensorBoardWriter(os.path.join(run_dir, "tb"))
    if name == "comet":
        return CometWriter(project=comet_project, workspace=comet_workspace,
                           experiment_name=experiment_name)
    raise ValueError(f"unknown writer {name!r} "
                     "(console | jsonl | tensorboard | comet)")


def make_val_panels(first_batch: dict, max_samples: int = 2):
    """The first validation batch's figure: per sample (at most
    ``max_samples``) a row of [input image + gt overlay, then the sigmoid
    of each output head: fused, pam, cam].  ``first_batch`` is the
    ``_first_batch`` record of :func:`.evaluate.evaluate` (the host batch
    and the NHWC outputs).  Returns a matplotlib Figure drawn on Agg."""
    import matplotlib
    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    from ..utils.helpers import overlay_mask, tens2image

    batch = first_batch["batch"]
    outputs = first_batch["outputs"]
    n = min(outputs[0].shape[0], max_samples)
    ncols = 1 + len(outputs)
    fig, axes = plt.subplots(n, ncols, figsize=(3 * ncols, 3 * n),
                             squeeze=False)
    titles = ["image+gt", "fused", "pam", "cam"]
    for i in range(n):
        img = np.clip(tens2image(np.asarray(batch["concat"][i]))[..., :3],
                      0, 255) / 255.0
        gt = tens2image(np.asarray(batch["crop_gt"][i]))
        axes[i][0].imshow(overlay_mask(img, gt > 0.5))
        for k, out in enumerate(outputs):
            prob = 1.0 / (1.0 + np.exp(-tens2image(out[i])))
            axes[i][1 + k].imshow(prob, vmin=0, vmax=1)
        for j, ax in enumerate(axes[i]):
            ax.set_axis_off()
            if i == 0 and j < len(titles):
                ax.set_title(titles[j])
    fig.tight_layout()
    return fig
