"""The port's worker-process train loader (``data.loader=grain``,
``data/grain_pipeline.py``) and decode cache (``data.decode_cache``), on
the CPU, at two workers.

* ``_DecodeCache``: least-recently-used eviction, readers never mutate a
  cached decode, a pickled cache arrives empty; samples of an on-disk
  JPEG/PNG tree (written by the JAX package's ``make_fake_voc``) are bit
  for bit the same with and without the cache.
* ``GrainDataLoader``: every sample bit for bit the threaded
  ``DataLoader``'s for the same ``(seed, epoch, index)``; ``len`` and the
  batches' composition and order the JAX package's ``GrainDataLoader``'s
  (on ``grain``) at the same ``num_workers``, ``drop_last`` and
  ``shuffle=False``; ``set_epoch(e, k)`` yields exactly the epoch's
  batches from the k-th; a worker never has ``torch`` (or ``jax``) in
  ``sys.modules``; no worker process is left after a break, a worker's
  exception (raised in the parent with its type) or ``close()``; a worker
  killed with SIGKILL raises in the parent naming it and the signal; it
  runs with ``PIL``, ``cv2`` and ``grain`` blocked, as does
  ``chip_smoke.py``'s host-data logic (phases 6h and 6i at a small size).
* The trainer with ``data.loader=grain``, ``data.fused_crop_resize`` and
  ``data.decode_cache``: a fit stopped after step 2 and resumed ends bit
  for bit at the straight run's weights, with no worker left; an unknown
  ``data.loader`` raises.

This module imports neither torch nor jax at its top: the loader's
worker processes import it to unpickle :class:`Probe`.
"""

import multiprocessing
import os
import pickle
import signal
import sys
import time

import numpy as np
import pytest

from distributedpytorch_tpu_torch.data import fake, grain_pipeline, pipeline, voc


class Probe:
    """Records that report their own index, their RNG draw and what their
    worker process has imported; ``sleep`` slows each, ``fail_at`` raises,
    ``pad`` bytes of zeros make a record too large for a worker to send
    many batches ahead of the reader."""

    transform = None

    def __init__(self, n: int, sleep: float = 0.0, fail_at: int | None = None,
                 pad: int = 0):
        self.n, self.sleep, self.fail_at, self.pad = n, sleep, fail_at, pad

    def __len__(self) -> int:
        return self.n

    def __getitem__(self, index, rng=None):
        if index == self.fail_at:
            raise KeyError(f"sample {index}")
        time.sleep(self.sleep)
        record = {"index": np.array(index), "draw": rng.integers(0, 2**31, 2),
                  "pid": np.array(os.getpid()),
                  "torch": np.array("torch" in sys.modules),
                  "jax": np.array("jax" in sys.modules)}
        if self.pad:  # grain's shared memory takes no empty array
            record["pad"] = np.zeros(self.pad, np.uint8)
        return record


def workers() -> list:
    """The live worker processes of the port's loader."""
    return [p for p in multiprocessing.active_children()
            if p.name.startswith("dptpu-data-worker")]


def no_children():
    assert workers() == []


# --- the decode cache -----------------------------------------------------

def test_decode_cache_lru_order():
    cache = voc._DecodeCache(2)
    loads = []

    def load(key):
        return lambda: loads.append(key) or (np.full(2, key),)

    for key in (0, 1, 0, 2, 1, 0):
        assert int(cache.get(key, load(key))[0][0]) == key
    # 0 and 1 cached; 0 used, so 2 evicts 1; then 1 evicts 0, 0 evicts 2
    assert loads == [0, 1, 2, 1, 0]
    assert list(cache._d) == [1, 0]


def test_decode_cache_pickles_empty():
    cache = voc._DecodeCache(3)
    cache.get(7, lambda: (np.zeros(2),))
    got = pickle.loads(pickle.dumps(cache))
    assert got.max_items == 3 and len(got._d) == 0
    assert got._lock is not cache._lock and len(cache._d) == 1


@pytest.fixture(scope="module")
def disk_root(tmp_path_factory):
    from distributedpytorch_tpu.data import fake as jax_fake

    root = str(tmp_path_factory.mktemp("voc"))
    jax_fake.make_fake_voc(root, n_images=5, size=(60, 80), n_val=1, seed=4)
    return root


def test_decode_cache_samples_equal_and_not_mutated(disk_root):
    tf = pipeline.build_train_transform(crop_size=(32, 32), relax=10)
    plain = voc.VOCInstanceSegmentation(disk_root, split="train", transform=tf)
    cached = voc.VOCInstanceSegmentation(disk_root, split="train", transform=tf,
                                         decode_cache=2)
    assert len(plain) == len(cached) > 2
    for _ in range(2):  # the second pass reads cached decodes
        for i in range(len(plain)):
            got = cached.__getitem__(i, rng=pipeline.sample_rng(0, 0, i))
            want = plain.__getitem__(i, rng=pipeline.sample_rng(0, 0, i))
            for key in want:
                if key != "meta":
                    np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    assert len(cached._cache._d) == 2
    raw_set = voc.VOCInstanceSegmentation(disk_root, split="train", decode_cache=2)
    raw = raw_set[0]
    im_ii = raw_set.obj_list[0][0]
    img8, inst = raw_set.decode_raw(im_ii)
    before = img8.copy(), inst.copy()
    raw["image"][:] = -1
    raw["gt"][:] = -1
    raw["void_pixels"][:] = -1
    assert raw_set.decode_raw(im_ii)[0] is img8  # served from the cache
    np.testing.assert_array_equal(img8, before[0])
    np.testing.assert_array_equal(inst, before[1])


# --- the worker loader ----------------------------------------------------

@pytest.fixture(scope="module")
def train_set():
    tree = fake.make_fake_voc(n_images=8, size=(96, 128), n_val=3, seed=0)
    return voc.VOCInstanceSegmentation(
        tree, split="train", area_thres=0,
        transform=pipeline.build_train_transform(crop_size=(32, 32), relax=10))


def test_samples_bitwise_equal_threaded_loader(train_set):
    loader = grain_pipeline.GrainDataLoader(train_set, 2, shuffle=True,
                                            drop_last=True, seed=5, num_workers=2)
    loader.set_epoch(3)
    batches = list(loader)
    assert len(batches) == len(loader) == 5
    threaded = pipeline.DataLoader(train_set, 2, shuffle=True, seed=5)
    threaded.set_epoch(3)
    np.testing.assert_array_equal(np.sort(loader.epoch_indices()),
                                  np.sort(threaded.epoch_indices()))
    for (_, idxs), batch in zip(loader.batch_plan(), batches):
        for k, i in enumerate(idxs):
            want = threaded._load_one(i)
            assert batch["meta"][k] == want["meta"]
            for key, val in want.items():
                if key != "meta":
                    np.testing.assert_array_equal(batch[key][k], val, err_msg=key)
    no_children()


@pytest.mark.parametrize("n,workers,drop_last", [
    (11, 2, True), (11, 2, False), (11, 3, False), (7, 4, True), (5, 0, False),
    (12, 5, True)])
def test_len_matches_jax(n, workers, drop_last):
    from distributedpytorch_tpu.data import grain_pipeline as jax_grain

    got = grain_pipeline.GrainDataLoader(Probe(n), 2, drop_last=drop_last,
                                         num_workers=workers)
    want = jax_grain.GrainDataLoader(Probe(n), 2, drop_last=drop_last,
                                     num_workers=got.num_workers)  # capped
    assert len(got) == len(want) == len(got.batch_plan())


def test_composition_and_order_match_jax():
    from distributedpytorch_tpu.data import grain_pipeline as jax_grain

    got = grain_pipeline.GrainDataLoader(Probe(11), 2, drop_last=False, seed=1,
                                         num_workers=2)
    want = jax_grain.GrainDataLoader(Probe(11), 2, drop_last=False, seed=1,
                                     num_workers=2)
    got_b, want_b = list(got), list(want)
    assert [b["index"].tolist() for b in got_b] == \
        [b["index"].tolist() for b in want_b] == \
        [[0, 2], [1, 3], [4, 6], [5, 7], [8, 10], [9]]
    for g, w in zip(got_b, want_b):
        np.testing.assert_array_equal(g["draw"], w["draw"])
    assert not any(b["torch"].any() or b["jax"].any() for b in got_b)
    assert len({int(p) for b in got_b for p in b["pid"]}) == 2
    no_children()


def test_set_epoch_resumes_exactly(train_set):
    loader = grain_pipeline.GrainDataLoader(train_set, 2, shuffle=True,
                                            drop_last=True, seed=2, num_workers=2)
    loader.set_epoch(1)
    whole = list(loader)
    loader.set_epoch(1, start_batch=3)
    tail = list(loader)
    assert len(tail) == len(whole) - 3
    for got, want in zip(tail, whole[3:]):
        np.testing.assert_array_equal(got["concat"], want["concat"])
        assert got["meta"] == want["meta"]
    no_children()


def test_no_worker_left_after_break_exception_or_close():
    loader = grain_pipeline.GrainDataLoader(Probe(40, sleep=0.01, pad=1 << 22),
                                            2, num_workers=2)
    for k, _ in enumerate(loader):
        if k == 1:
            break
    no_children()
    with pytest.raises(KeyError, match="sample 9"):
        list(grain_pipeline.GrainDataLoader(Probe(40, fail_at=9), 2,
                                            num_workers=2))
    no_children()
    it = iter(loader)
    next(it)
    assert len(workers()) == 2
    loader.close()
    no_children()
    it.close()


def test_killed_worker_raises_naming_it():
    loader = grain_pipeline.GrainDataLoader(Probe(60, sleep=0.02, pad=1 << 22),
                                            2, num_workers=2, prefetch=1)
    it = iter(loader)
    next(it)
    victim, = [p for p in workers() if p.name.endswith("-1")]
    os.kill(victim.pid, signal.SIGKILL)
    with pytest.raises(RuntimeError,
                       match=r"worker 1 \(pid \d+\) was killed by signal SIGKILL"):
        for _ in it:
            pass
    no_children()


def test_runs_without_pil_cv2_grain(monkeypatch, train_set):
    for name in ("PIL", "cv2", "grain"):
        monkeypatch.setitem(sys.modules, name, None)
    import chip_smoke

    loader = grain_pipeline.GrainDataLoader(train_set, 2, shuffle=True,
                                            drop_last=True, num_workers=2)
    assert len(list(loader)) == len(loader)
    chip_smoke.phase_host_ops(src=(40, 60), crop=(32, 32), reps=1)
    times = chip_smoke.phase_loaders(n_images=4, size=(40, 60), crop=(32, 32),
                                     batch=2, n_samples=8, workers=(2,),
                                     numpy_batches=2)
    assert not any("on-disk" in label for label in times)
    no_children()


# --- the trainer ----------------------------------------------------------

#: the tiny run: 11 train objects, train batch 2 on 2 workers -> 5 steps/epoch
TINY = ["data.fake=true", "model.backbone=resnet18", "data.crop_size=[32,32]",
        "data.relax=10", "data.area_thres=0", "data.train_batch=2",
        "data.val_batch=8", "data.loader=grain", "data.num_workers=2",
        "data.fused_crop_resize=true", "data.decode_cache=4", "epochs=2",
        "log_every_steps=100", "checkpoint.preempt_check_every=1",
        "optim.lr=1e-3", "checkpoint.keep_latest=1"]


def test_trainer_resumes_a_worker_fed_fit_exactly(tmp_path):
    import torch

    from distributedpytorch_tpu_torch.train import config
    from distributedpytorch_tpu_torch.train.preemption import PreemptionGuard
    from distributedpytorch_tpu_torch.train.trainer import Trainer

    class StopAt(PreemptionGuard):
        def should_stop(self, step=None):
            if step is not None and step >= 2:
                self.trip()
            return super().should_stop(step)

    def cfg(work, *extra):
        return config.apply_overrides(config.Config(),
                                      TINY + [f"work_dir={work}", *extra])

    straight = Trainer(cfg(tmp_path / "straight"), device="cpu")
    assert isinstance(straight.train_loader, grain_pipeline.GrainDataLoader)
    assert isinstance(straight.val_loader, pipeline.DataLoader)
    straight.fit()
    straight.close()
    stopped = Trainer(cfg(tmp_path / "stopped"), device="cpu")
    with StopAt(check_every=1) as guard:
        stopped.fit(guard=guard)
    stopped.close()
    no_children()
    _, meta = stopped.ckpt.load()
    assert (meta["interrupted_epoch"], meta["epoch_steps_done"],
            meta["loader_workers"]) == (0, 2, 2)
    resumed = Trainer(cfg(tmp_path / "stopped", "resume=auto"), device="cpu")
    resumed.fit()
    resumed.close()
    no_children()
    assert resumed.state.step == straight.state.step == 10
    for k, v in straight.model.state_dict().items():
        assert torch.equal(resumed.model.state_dict()[k], v), k
    with pytest.raises(ValueError, match="unknown data.loader"):
        Trainer(cfg(tmp_path / "bad", "data.loader=processes"), device="cpu")
