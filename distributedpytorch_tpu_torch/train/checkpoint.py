"""Checkpoints on ``torch.save``, the counterpart of
``distributedpytorch_tpu/train/checkpoint.py``.

A checkpoint is the whole train state — the model's ``state_dict``
(parameters and BatchNorm statistics), the optimizer's (momentum), the
update count and the dropout generator's state — plus a JSON meta dict.
Layout under the manager's directory::

    latest/<step>/state.pt, meta.json   the newest ``keep_latest`` saves
    best/<step>/state.pt, meta.json     the best-by-Jaccard save
    COMMITTED.json                      {"latest": [steps], "best": [steps]}

Each save is written into a temporary directory and renamed into place,
then the ``COMMITTED.json`` ledger is rewritten atomically, so a step
named there was complete on disk.  Saves are synchronous.  A restore that
is not pinned to a step falls back from an unreadable newest checkpoint
(a file torn after its commit) to the next older committed one, loudly,
and records the skipped steps in ``last_restore_fallback``.

The meta dict of a save carries ``step`` and ``best_metric``, and what the
trainer adds: ``epoch`` (the last completed epoch), and for a save made on
preemption ``interrupted_epoch``, ``epoch_steps_done``, ``train_batch``,
``seed`` and ``echo`` — what a resume reads to continue mid-epoch.
"""

from __future__ import annotations

import glob
import hashlib
import json
import os
import re
import shutil

import torch

_LEDGER = "COMMITTED.json"


def atomic_write_json(path: str, obj) -> None:
    """Write ``obj`` as JSON so that ``path`` holds either its old content
    or all of the new: a temporary file, fsync, rename, fsync of the
    directory."""
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(obj, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    fd = os.open(os.path.dirname(os.path.abspath(path)) or ".", os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def param_digest(state_dict) -> str:
    """Order-stable sha256 over the raw bytes of a ``state_dict``'s
    tensors (in key order)."""
    h = hashlib.sha256()
    for key in sorted(state_dict):
        t = state_dict[key].detach().cpu().contiguous().reshape(-1)
        h.update(key.encode())
        h.update(t.view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def _run_indices(work_dir: str) -> list[tuple[int, str]]:
    """``(N, path)`` of every ``run_<N>`` under ``work_dir``, by N."""
    return sorted((int(m.group(1)), r)
                  for r in glob.glob(os.path.join(work_dir, "run_*"))
                  if (m := re.search(r"run_(\d+)$", r)))


def next_run_dir(work_dir: str, resume_run: int | None = None) -> str:
    """Create and return ``work_dir/run_<N>``: N one past the highest, or
    ``resume_run`` when given (the reference pinned ``run_0`` to resume)."""
    if resume_run is None:
        runs = _run_indices(work_dir)
        resume_run = runs[-1][0] + 1 if runs else 0
    path = os.path.join(work_dir, f"run_{resume_run}")
    os.makedirs(path, exist_ok=True)
    return path


def latest_checkpoint_dir(work_dir: str,
                          exclude_run: str | None = None) -> str | None:
    """The ``checkpoints`` directory of the highest-numbered ``run_<N>``
    under ``work_dir`` with a committed step, skipping ``exclude_run`` (the
    caller's own new run); ``None`` when no run has one.  The target of
    ``resume=auto``."""
    skip = os.path.abspath(exclude_run) if exclude_run else None
    for _, run in reversed(_run_indices(work_dir)):
        if os.path.abspath(run) == skip:
            continue
        ckpt = os.path.join(run, "checkpoints")
        if CheckpointManager.committed_in(ckpt):
            return ckpt
    return None


def _steps(slot_dir: str) -> list[int]:
    if not os.path.isdir(slot_dir):
        return []
    return sorted(int(d) for d in os.listdir(slot_dir) if d.isdigit())


class CheckpointManager:
    """Rolling ``keep_latest`` checkpoints plus the best one by metric
    (saved when the metric beats the best so far, starting from
    ``best_metric_init``)."""

    def __init__(self, directory: str, keep_latest: int = 3,
                 best_metric_init: float = 0.0, digest: bool = False):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.keep_latest = keep_latest
        self.best_metric = best_metric_init
        self.digest = digest
        #: the steps the last unpinned restore skipped as unreadable
        self.last_restore_fallback: list[int] = []

    def _slot(self, best: bool) -> str:
        return os.path.join(self.directory, "best" if best else "latest")

    def _write(self, slot: str, step: int, payload: dict, meta: dict) -> None:
        final = os.path.join(slot, str(step))
        tmp = final + ".tmp"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        torch.save(payload, os.path.join(tmp, "state.pt"))
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump(meta, f)
        shutil.rmtree(final, ignore_errors=True)
        os.replace(tmp, final)

    def _prune(self, slot: str, keep: int) -> None:
        for s in _steps(slot)[:-keep] if keep > 0 else []:
            shutil.rmtree(os.path.join(slot, str(s)), ignore_errors=True)

    @staticmethod
    def committed_in(directory: str, best: bool = False) -> list[int]:
        """The steps the ledger under ``directory`` records in the slot."""
        try:
            with open(os.path.join(directory, _LEDGER)) as f:
                return list(json.load(f).get("best" if best else "latest", ()))
        except (OSError, ValueError):
            return []

    def committed_steps(self, best: bool = False) -> list[int]:
        """The steps the ledger records in the requested slot."""
        return self.committed_in(self.directory, best)

    def save(self, step: int, state, metric: float | None = None,
             extra: dict | None = None) -> bool:
        """Save ``state`` (a ``TrainState``) at ``step``; also into the
        best slot when ``metric`` improves on the best.  Returns whether it
        did."""
        is_best = metric is not None and metric > self.best_metric
        if is_best:
            self.best_metric = float(metric)
        model_state = state.model.state_dict()
        payload = {"model": model_state,
                   "optimizer": state.optimizer.state_dict(),
                   "step": int(state.step),
                   "generator": state.generator.get_state()}
        meta = {"step": int(step), "best_metric": self.best_metric}
        if metric is not None:
            meta["metric"] = float(metric)
        if self.digest:
            meta["param_digest"] = param_digest(model_state)
        meta.update(extra or {})
        for best in (False, True) if is_best else (False,):
            slot = self._slot(best)
            self._write(slot, step, payload, meta)
            self._prune(slot, 1 if best else self.keep_latest)
        atomic_write_json(os.path.join(self.directory, _LEDGER),
                          {"latest": _steps(self._slot(False)),
                           "best": _steps(self._slot(True))})
        return is_best

    def latest_step(self) -> int | None:
        steps = self.committed_steps()
        return steps[-1] if steps else None

    def load(self, step: int | None = None, best: bool = False,
             map_location="cpu") -> tuple[dict, dict]:
        """``(payload, meta)`` of a committed checkpoint: ``step`` from the
        latest slot, or the newest committed one of the requested slot."""
        steps = self.committed_steps(best=best)
        if step is None:
            if not steps:
                raise FileNotFoundError(f"no committed checkpoint under "
                                        f"{self.directory} ({'best' if best else 'latest'})")
            step = steps[-1]
        elif step not in steps:
            raise FileNotFoundError(f"step {step} is not committed under "
                                    f"{self.directory}: {steps}")
        path = os.path.join(self._slot(best), str(step))
        payload = torch.load(os.path.join(path, "state.pt"),
                             map_location=map_location, weights_only=True)
        with open(os.path.join(path, "meta.json")) as f:
            return payload, json.load(f)

    def restore(self, state, step: int | None = None,
                best: bool = False) -> dict:
        """Load a committed checkpoint into ``state`` (model, optimizer,
        update count, generator); returns its meta.  Without ``step``, the
        newest committed one that reads back; the unreadable ones skipped
        on the way are in ``last_restore_fallback``.  A pinned ``step``
        never falls back."""
        candidates = [step] if step is not None else \
            sorted(self.committed_steps(best=best), reverse=True)
        if not candidates:
            raise FileNotFoundError(f"no committed checkpoint under "
                                    f"{self.directory} ({'best' if best else 'latest'})")
        self.last_restore_fallback = []
        for i, s in enumerate(candidates):
            try:
                payload, meta = self.load(s, best=best,
                                          map_location=state.device)
                break
            except Exception as e:
                if step is not None or i == len(candidates) - 1:
                    raise
                print(f"warning: checkpoint step {s} is unreadable "
                      f"({type(e).__name__}: {e}; torn after commit) — "
                      f"falling back to step {candidates[i + 1]}", flush=True)
                self.last_restore_fallback.append(int(s))
        state.model.load_state_dict(payload["model"], strict=True)
        state.optimizer.load_state_dict(payload["optimizer"])
        state.step = int(payload["step"])
        state.generator.set_state(payload["generator"].cpu())
        return meta
