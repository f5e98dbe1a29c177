"""Device-side instance data in the port against the JAX package, on the
CPU: ``ops/guidance_device.py``, ``ops/augment.py``,
``parallel/mesh.prefetch_to_device`` and their wiring into the train step
and the trainer.

* Guidance: every family of ``FAMILIES`` in training (the random points
  fed JAX's own ``randint`` ranks) and at val (fixed points), on a batch
  holding blobs, an empty mask and a single-pixel mask, against JAX's
  ``guidance_map`` per sample: the fixed points and the points of the
  given ranks equal JAX's exactly, the maps within 1e-6 of the family's
  scale (255, or 1 for ``extreme_points``; largest seen 6.1e-5 on 255,
  float32 summation order), an empty mask's map zero.
* Augment (NCHW here, NHWC there), each op fed JAX's draws: the flip, the
  reflect-padded crop and the masks of the scale-rotate (nearest, binary
  re-binarised or semantic ids with the 255 border) equal JAX's exactly;
  the bilinear image (``map_coordinates``' arithmetic on the four corners)
  within 1e-2 on the [0, 255] scale: the source coordinates differ by up
  to ~2e-5 px (float32 ``cos``/``sin`` and XLA's fused multiply-adds),
  times the steepest step between neighbours of a noise image (255) on
  two axes; largest seen 2.6e-3; ``normalize`` within 1e-6 relative.
  The composed stage (flip, scale-rotate, guidance) on JAX's draws: the
  same bounds.  Turning guidance on or off leaves the flips and
  rotations unchanged.
* ``prefetch_to_device`` on the CPU: order and the key filter, the
  window's bound for an int and a callable read live (the worker keeps
  exactly the window placed ahead once it settles), ``size=0``, the
  worker stopped with nothing pulled after an abandoned iterator, and the
  ``device/put`` site firing on the worker thread, its error raised in
  the consumer.
* One train step of DANet-R18 at 64², B = 2, with the device stage
  (flip, scale-rotate, ``nellipse_gaussians`` guidance) on the draws the
  JAX step takes from its state's rng (``parallel/step.py``: split, split,
  then ``split(aug_rng, 3)`` and ``fold_in(aug_rng, 3)``): the loss
  within 1e-4 relative and the parameters and BatchNorm statistics after
  the step within 1e-4 x max(1, max |leaf|), the bounds
  ``test_torch_port_train.py`` holds the trajectory to; the stage's output
  equals JAX's augmented batch as above; and each leaf's gradient within
  2e-2 relative L2 of JAX's (of max(|g|, 1e-4), as PAM's key bias has a
  zero gradient), read off JAX's first SGD update (no weight decay:
  ``g = (p - p') / lr``).  Seen: loss 3e-6 relative, leaves 2.0e-5,
  gradients 7.8e-3; the same step without the stage is 7.5e-3 apart
  (the two frameworks' float32 backward of this randomised R18 at
  B = 2).
* The trainer: none of the A1 knobs is refused any more; the default fit
  places its batches through ``prefetch_to_device`` with a window of 2,
  and with ``data.device_prefetch`` 0 and 2 it ends with bitwise-equal
  weights; a fit with the device stage on,
  stopped at step 7 and resumed, ends bitwise equal to a straight one
  (the stage's generator derives from the seed and the step alone).
"""

import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from distributedpytorch_tpu.models import build_model as jax_build_model
from distributedpytorch_tpu.ops import augment as jaug
from distributedpytorch_tpu.ops import guidance_device as jgd
from distributedpytorch_tpu.parallel import TrainState as JaxTrainState
from distributedpytorch_tpu.parallel import make_train_step as jax_make_train_step
from distributedpytorch_tpu.train import config as jax_config
from distributedpytorch_tpu.train import optim as jax_optim
from distributedpytorch_tpu_torch.chaos import faults, sites
from distributedpytorch_tpu_torch.models import build_model
from distributedpytorch_tpu_torch.ops import augment, guidance_device
from distributedpytorch_tpu_torch.parallel import mesh
from distributedpytorch_tpu_torch.parallel.step import (
    create_train_state,
    make_train_step,
    step_generator,
)
from distributedpytorch_tpu_torch.train import config, optim
from distributedpytorch_tpu_torch.utils.weights import (
    load_jax_params,
    state_dict_to_jax,
)
from test_torch_port_model import randomize
from test_torch_port_resume import StopAt, fit
from test_torch_port_train import _no_dropout


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def blobs(n: int, h: int, w: int, seed: int = 0) -> np.ndarray:
    """(n, h, w) float32 binary ellipses."""
    r = np.random.default_rng(seed)
    yy, xx = np.mgrid[:h, :w]
    out = []
    for _ in range(n):
        cy, cx = r.uniform(h / 4, 3 * h / 4), r.uniform(w / 4, 3 * w / 4)
        a, b = r.uniform(h / 10, h / 4), r.uniform(w / 10, w / 4)
        out.append((((yy - cy) / a) ** 2 + ((xx - cx) / b) ** 2 <= 1))
    return np.asarray(out, np.float32)


def nchw(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def nhwc(t: torch.Tensor) -> np.ndarray:
    return t.numpy().transpose(0, 2, 3, 1)


def jax_ranks(masks, keys, pert: int) -> np.ndarray:
    """JAX ``extreme_points_random``'s ``randint`` draws for each mask."""
    out = []
    for m, k in zip(masks, keys):
        cands = jgd._side_candidates(jnp.asarray(m), pert)
        counts = jnp.stack([c.ravel() for c in cands]).sum(axis=1)
        out.append(np.asarray(jax.random.randint(k, (4,), 0,
                                                 jnp.maximum(counts, 1))))
    return np.stack(out)


@pytest.fixture(scope="module")
def masks():
    m = blobs(5, 40, 48, seed=1)
    m[3] = 0.0
    m[3, 9, 13] = 1.0  # a single pixel
    m[4] = 0.0  # empty
    return m


class TestGuidance:
    @pytest.mark.parametrize("is_val", [False, True])
    @pytest.mark.parametrize("family", guidance_device.FAMILIES)
    def test_family_matches_jax(self, masks, family, is_val):
        jittered = family in ("extreme_points", "confidence_l1l2",
                              "confidence_gaussian")
        pert = 5 if (jittered and not is_val) else 0
        keys = jax.random.split(jax.random.PRNGKey(3), len(masks))
        want = np.stack([np.asarray(jgd.guidance_map(
            jnp.asarray(m), k, family=family, pert=pert, is_val=is_val))
            for m, k in zip(masks, keys)])
        ranks = None
        if not is_val and family != "confidence_gaussian":
            ranks = torch.from_numpy(jax_ranks(masks, keys, pert))
        got = guidance_device.guidance_map(
            torch.from_numpy(masks), family=family, pert=pert, is_val=is_val,
            ranks=ranks).numpy()
        scale = 1.0 if family == "extreme_points" else 255.0
        assert got.dtype == np.float32 and got.shape == masks.shape
        assert np.abs(got - want).max() <= 1e-6 * scale
        assert not got[4].any() and np.isfinite(got).all()
        if family.startswith("nellipse"):
            assert got[3].max() > 0  # a single pixel is a live mask

    @pytest.mark.parametrize("pert", [0, 3])
    def test_points_equal_jax(self, masks, pert):
        m = torch.from_numpy(masks)
        got = guidance_device.extreme_points_fixed(m, pert).numpy()
        keys = jax.random.split(jax.random.PRNGKey(4), len(masks))
        ranks = jax_ranks(masks, keys, pert)
        drawn = guidance_device.extreme_points_from_ranks(
            m, torch.from_numpy(ranks), pert).numpy()
        for i, mask in enumerate(masks):
            np.testing.assert_array_equal(
                got[i], np.asarray(jgd.extreme_points_fixed(jnp.asarray(mask),
                                                            pert)))
            np.testing.assert_array_equal(
                drawn[i], np.asarray(jgd.extreme_points_random(
                    jnp.asarray(mask), keys[i], pert)))

    def test_own_draws_are_candidates_and_seeded(self, masks):
        m = torch.from_numpy(masks[:3])
        gen = lambda: torch.Generator().manual_seed(7)  # noqa: E731
        a = guidance_device.extreme_points_random(m, gen(), pert=2)
        b = guidance_device.extreme_points_random(m, gen(), pert=2)
        assert torch.equal(a, b)
        cands = guidance_device._side_candidates(m, 2)
        for i in range(3):
            for side in range(4):
                x, y = (int(v) for v in a[i, side])
                assert cands[i, side, y, x]

    def test_stage_appends_the_channel_as_jax(self, masks):
        x = np.random.default_rng(2).uniform(0, 255, masks.shape + (3,))
        x = x.astype(np.float32)
        gt = masks[..., None]
        key = jax.random.PRNGKey(9)
        want = jgd.make_device_guidance()({"concat": jnp.asarray(x),
                                           "crop_gt": jnp.asarray(gt)}, key)
        ranks = jax_ranks(masks, jax.random.split(key, len(masks)), 0)
        stage = guidance_device.make_device_guidance()
        got = stage.apply({"concat": nchw(x), "crop_gt": nchw(gt)},
                          ranks=torch.from_numpy(ranks))
        assert got["concat"].shape == (len(masks), 4, 40, 48)
        assert np.abs(nhwc(got["concat"]) - np.asarray(want["concat"])).max() \
            <= 1e-6 * 255.0
        val = guidance_device.make_device_guidance(is_val=True)
        assert not val.random and val.pert == 0
        assert guidance_device.make_device_guidance(
            "extreme_points").pert == 5

    def test_unknown_family_raises(self):
        with pytest.raises(ValueError, match="not device-supported"):
            guidance_device.make_device_guidance("scribbles")


def _aug_batch(n=4, h=40, w=48, semantic=False, seed=3):
    r = np.random.default_rng(seed)
    gt = r.integers(0, 21, (n, h, w, 1)).astype(np.float32) if semantic \
        else blobs(n, h, w, seed)[..., None]
    return {"concat": r.uniform(0, 255, (n, h, w, 3)).astype(np.float32),
            "crop_gt": gt,
            "crop_void": (r.random((n, h, w, 1)) < 0.1).astype(np.float32)}


def _close(got: dict, want: dict, image_atol: float = 1e-2) -> None:
    for k, v in want.items():
        v = np.asarray(v)
        if k == "concat":
            assert np.abs(nhwc(got[k]) - v).max() <= image_atol, k
        else:
            np.testing.assert_array_equal(nhwc(got[k]), v, err_msg=k)


def _port(batch: dict) -> dict:
    return {k: nchw(v) for k, v in batch.items()}


def _jax(batch: dict) -> dict:
    return {k: jnp.asarray(v) for k, v in batch.items()}


class TestAugment:
    def test_flip_and_crop_equal_jax(self):
        b = _aug_batch()
        key = jax.random.PRNGKey(5)
        coins = np.asarray(jax.random.uniform(key, (4,)) < 0.5)
        assert 0 < coins.sum() < 4
        got = augment.random_hflip(_port(b), torch.from_numpy(coins))
        _close(got, jaug.random_hflip(_jax(b), key), image_atol=0.0)
        oy = np.asarray(jax.random.randint(key, (4,), 0, 9))
        ox = np.asarray(jax.random.randint(jax.random.fold_in(key, 1), (4,),
                                           0, 9))
        got = augment.random_crop(_port(b), torch.from_numpy(oy).long(),
                                  torch.from_numpy(ox).long(), pad=4)
        _close(got, jaug.random_crop(_jax(b), key, pad=4), image_atol=0.0)

    @pytest.mark.parametrize("semantic", [False, True])
    def test_scale_rotate_matches_jax(self, semantic):
        b = _aug_batch(semantic=semantic)
        key = jax.random.PRNGKey(6)
        k1, k2 = jax.random.split(key)
        angles = jnp.deg2rad(jax.random.uniform(k1, (4,), minval=-20.0,
                                                maxval=20.0))
        scales = jax.random.uniform(k2, (4,), minval=0.75, maxval=1.25)
        got = augment.random_scale_rotate(
            _port(b), torch.from_numpy(np.array(angles)),
            torch.from_numpy(np.array(scales)), semantic=semantic)
        want = jaug.random_scale_rotate(_jax(b), key, semantic=semantic)
        _close(got, want)
        border = nhwc(got["crop_gt"])
        if semantic:
            assert (border == 255).any()  # the void ring
        else:
            assert set(np.unique(border)) <= {0.0, 1.0}

    def test_round_half_away_from_zero(self):
        x = torch.tensor([-2.5, -1.5, -0.5, 0.5, 1.5, 2.5, 0.49999997, -0.7])
        np.testing.assert_array_equal(
            augment._round_half_away(x).numpy(),
            np.asarray(jax.lax.round(jnp.asarray(x.numpy()))))

    def test_normalize_matches_jax(self):
        b = _aug_batch()
        mean, std = (10.0, 20.0, 30.0), (2.0, 3.0, 4.0)
        got = augment.normalize(_port(b), mean, std)["concat"]
        want = np.asarray(jaug.normalize(_jax(b), mean, std)["concat"])
        assert np.abs(nhwc(got) - want).max() <= 1e-6 * np.abs(want).max()
        pre = augment.make_preprocess()(_port(b))["concat"]
        assert torch.allclose(pre * 255.0, _port(b)["concat"])

    def test_composed_stage_on_jax_draws(self):
        b = _aug_batch(n=4, seed=8)
        key = jax.random.PRNGKey(11)
        want = jaug.make_device_augment(
            hflip=True, scale_rotate=True,
            guidance_fn=jgd.make_device_guidance())(_jax(b), key)
        draws = jax_draws(key, 4, jaug.random_scale_rotate(
            jaug.random_hflip(_jax(b), jax.random.split(key, 3)[0]),
            jax.random.split(key, 3)[2])["crop_gt"][..., 0])
        stage = augment.make_device_augment(
            hflip=True, scale_rotate=True,
            guidance_fn=guidance_device.make_device_guidance())
        got = stage.apply(_port(b), draws)
        _close(got, want)

    def test_guidance_leaves_the_other_draws(self):
        b = _port(_aug_batch(n=6, seed=4))
        plain = augment.make_device_augment(hflip=True, scale_rotate=True)
        guided = augment.make_device_augment(
            hflip=True, scale_rotate=True,
            guidance_fn=guidance_device.make_device_guidance())
        a = plain(b, torch.Generator().manual_seed(3))
        g = guided(b, torch.Generator().manual_seed(3))
        assert torch.equal(a["concat"], g["concat"][:, :3])
        assert torch.equal(a["crop_gt"], g["crop_gt"])
        assert g["concat"].shape[1] == 4
        d1 = plain.draw(b, torch.Generator().manual_seed(3))
        d2 = guided.draw(b, torch.Generator().manual_seed(3))
        for k in ("flip", "angle", "scale", "oy", "ox"):
            assert torch.equal(d1[k], d2[k])
        assert "guidance_u" in d2 and "guidance_u" not in d1


def jax_draws(aug_rng, n: int, warped_masks) -> dict:
    """The draws JAX's ``make_device_augment(hflip, scale_rotate,
    guidance)`` takes from ``aug_rng``, as the port's stage takes them;
    the guidance ranks against the masks after the geometry."""
    r1, _, r3 = jax.random.split(aug_rng, 3)
    k1, k2 = jax.random.split(r3)
    angles = jnp.deg2rad(jax.random.uniform(k1, (n,), minval=-20.0,
                                            maxval=20.0))
    scales = jax.random.uniform(k2, (n,), minval=0.75, maxval=1.25)
    keys = jax.random.split(jax.random.fold_in(aug_rng, 3), n)
    ranks = jax_ranks(np.asarray(warped_masks), keys, 0)
    return {"flip": torch.from_numpy(np.array(
                jax.random.uniform(r1, (n,)) < 0.5)),
            "angle": torch.from_numpy(np.array(angles)),
            "scale": torch.from_numpy(np.array(scales)),
            "guidance_ranks": torch.from_numpy(ranks)}


def _host_batches(n: int):
    return [{"concat": np.full((2, 4, 4, 3), i, np.float32),
             "crop_gt": np.zeros((2, 4, 4, 1), np.float32),
             "meta": [i, i]} for i in range(n)]


class Pulled:
    """An iterator over ``items`` that counts how many were taken."""

    def __init__(self, items):
        self.items, self.n = list(items), 0

    def __iter__(self):
        for item in self.items:
            self.n += 1
            yield item


def _ahead_settles(src: Pulled, taken: int, want: int,
                   timeout: float = 10.0) -> int:
    """Batches pulled beyond ``taken`` once the worker reaches ``want``
    (or ``timeout`` passes), checked a moment later not to grow past it."""
    end = time.monotonic() + timeout
    while src.n - taken < want and time.monotonic() < end:
        time.sleep(0.002)
    time.sleep(0.02)
    return src.n - taken


class TestPrefetch:
    def test_order_keys_and_layout(self):
        out = list(mesh.prefetch_to_device(_host_batches(5), torch.device("cpu"),
                                           size=2, keys=("concat", "crop_gt")))
        assert len(out) == 5
        for i, b in enumerate(out):
            assert set(b) == {"concat", "crop_gt"}
            assert b["concat"].shape == (2, 3, 4, 4)
            assert b["crop_gt"].shape == (2, 1, 4, 4)
            assert float(b["concat"][0, 0, 0, 0]) == i

    @pytest.mark.parametrize("size", [0, 1, 3])
    def test_window_bound(self, size):
        src = Pulled(_host_batches(8))
        for i, _ in enumerate(mesh.prefetch_to_device(iter(src),
                                                      torch.device("cpu"),
                                                      size=size)):
            # the worker fills the window behind the consumer: 0 pulls
            # nothing ahead, k keeps k batches placed ahead, never more
            want = min(size, 8 - (i + 1))
            assert _ahead_settles(src, i + 1, want) == want

    def test_callable_window_read_live(self):
        src = Pulled(_host_batches(10))
        window = {"size": 1}
        it = mesh.prefetch_to_device(iter(src), torch.device("cpu"),
                                     size=lambda: window["size"])
        for i, _ in enumerate(it):
            want = min(window["size"], 10 - (i + 1))
            assert _ahead_settles(src, i + 1, want) == want
            if i == 2:
                window["size"] = 4

    def test_abandoned_iterator_cancels_queued_placements(self):
        plan = faults.FaultPlan.from_dict({"seed": 0, "faults": [
            {"site": "device/put", "kind": "latency", "delay_s": 0.05}]})
        src = Pulled(_host_batches(50))
        with sites.armed_plan(plan):
            it = mesh.prefetch_to_device(iter(src), torch.device("cpu"),
                                         size=4)
            next(it)
            it.close()
            pulled = src.n
            time.sleep(0.2)
        placed = sum(1 for site, _, _ in plan.firings if site == "device/put")
        # the worker ended with the close: the batch taken, at most the
        # window placed ahead, nothing pulled or placed after it
        assert 1 <= pulled <= 5 and src.n == pulled and placed == pulled
        assert not [t for t in threading.enumerate()
                    if t.name.startswith("device-put")]

    def test_device_put_fires_on_the_worker_and_raises_in_consumer(
            self, monkeypatch):
        threads = []
        fire = sites.fire

        def spy(site, payload=None, **ctx):
            if site == "device/put":
                threads.append(threading.current_thread().name)
            return fire(site, payload, **ctx)

        monkeypatch.setattr(sites, "fire", spy)
        list(mesh.prefetch_to_device(_host_batches(3), torch.device("cpu"),
                                     size=2))
        assert len(threads) == 3
        assert all(t.startswith("device-put") for t in threads)
        plan = faults.FaultPlan.from_dict({"seed": 0, "faults": [
            {"site": "device/put", "kind": "error", "at": [2]}]})
        got = []
        with sites.armed_plan(plan), pytest.raises(faults.InjectedFaultError):
            for b in mesh.prefetch_to_device(_host_batches(4),
                                             torch.device("cpu"), size=2):
                got.append(b)
        assert len(got) == 1


def test_step_generator_per_step_and_rank():
    def draw(*args):
        return torch.rand(4, generator=step_generator(*args, torch.device("cpu")))

    assert torch.equal(draw(0, 3, 0), draw(0, 3, 0))
    assert not torch.equal(draw(0, 3, 0), draw(0, 4, 0))
    assert not torch.equal(draw(0, 3, 0), draw(0, 3, 1))
    assert not torch.equal(draw(0, 3, 0), draw(1, 3, 0))


def test_train_step_on_jax_draws():
    jmodel = jax_build_model("danet", nclass=1, backbone="resnet18",
                             output_stride=8, attention_impl="xla")
    shapes = jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 4)), train=False))
    variables = randomize(shapes)
    ocfg = dict(lr=1e-2, weight_decay=0.0)
    tx, _ = jax_optim.make_optimizer(jax_config.OptimConfig(**ocfg), 10)
    params = jax.tree.map(jnp.asarray, variables["params"])
    jstate = JaxTrainState(step=jnp.zeros((), jnp.int32), params=params,
                           batch_stats=jax.tree.map(jnp.asarray,
                                                    variables["batch_stats"]),
                           opt_state=tx.init(params),
                           rng=jax.random.PRNGKey(1))
    jstage = jaug.make_device_augment(hflip=True, scale_rotate=True,
                                      guidance_fn=jgd.make_device_guidance())
    jstep = jax_make_train_step(jmodel, tx, donate=False, augment=jstage)
    r = np.random.default_rng(12)
    batch = {"concat": r.uniform(0, 255, (2, 64, 64, 3)).astype(np.float32),
             "crop_gt": blobs(2, 64, 64, seed=12)[..., None]}
    # the JAX step's draws: split(state.rng) -> rng; split(rng) -> aug_rng
    rng, _ = jax.random.split(jstate.rng)
    _, aug_rng = jax.random.split(rng)
    r1, _, r3 = jax.random.split(aug_rng, 3)
    warped = jaug.random_scale_rotate(jaug.random_hflip(_jax(batch), r1),
                                      r3)["crop_gt"][..., 0]
    draws = jax_draws(aug_rng, 2, warped)
    with fnn.intercept_methods(_no_dropout):
        jstate2, jloss = jstep(jstate, _jax(batch))

    model = build_model("danet", backbone="resnet18", dropout_rate=0.0)
    load_jax_params(model, variables["params"], variables["batch_stats"])
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    opt, sched = optim.make_optimizer(config.OptimConfig(**ocfg), model, 10)
    state = create_train_state(model, opt, sched, 0, torch.device("cpu"))
    stage = augment.make_device_augment(
        hflip=True, scale_rotate=True,
        guidance_fn=guidance_device.make_device_guidance())
    want = jstage(_jax(batch), aug_rng)  # JAX's stage on its own draws
    seen = []

    def on_jax_draws(data, generator):
        out = stage.apply(data, draws)
        seen.append(out)
        return out

    loss = make_train_step(augment=on_jax_draws)(state, batch)
    (got,) = seen
    np.testing.assert_array_equal(nhwc(got["crop_gt"]),
                                  np.asarray(want["crop_gt"]))
    diff = np.abs(nhwc(got["concat"]) - np.asarray(want["concat"]))
    assert diff[..., :3].max() <= 1e-2 and diff[..., 3].max() <= 1e-6 * 255
    assert abs(float(loss) - float(jloss)) <= 1e-4 * abs(float(jloss))
    got_params, got_stats = state_dict_to_jax(model.state_dict())
    leaf_worst = 0.0
    for got_tree, want_tree in ((got_params, jstate2.params),
                                (got_stats, jstate2.batch_stats)):
        for (path, g), (_, w) in zip(
                jax.tree_util.tree_leaves_with_path(got_tree),
                jax.tree_util.tree_leaves_with_path(want_tree)):
            w = np.asarray(w)
            bound = max(1.0, float(np.abs(w).max()))
            d = float(np.abs(np.asarray(g) - w).max())
            leaf_worst = max(leaf_worst, d / bound)
            assert d <= 1e-4 * bound, jax.tree_util.keystr(path)
    # the gradients themselves, read off JAX's update p' = p - lr g
    model2 = build_model("danet", backbone="resnet18", dropout_rate=0.0)
    load_jax_params(model2, jax.device_get(jstate2.params),
                    jax.device_get(jstate2.batch_stats))
    after = dict(model2.named_parameters())
    grad_worst = 0.0
    for n, p in model.named_parameters():
        g_jax = (before[n] - after[n].detach()) / ocfg["lr"]
        # a floor for leaves whose exact gradient is 0 (PAM's key bias:
        # the softmax over keys ignores it)
        rel = float((p.grad - g_jax).norm() / max(float(g_jax.norm()), 1e-4))
        grad_worst = max(grad_worst, rel)
        assert rel <= 2e-2, n
    print(f"device-stage step: loss {float(loss):.6f} vs {float(jloss):.6f}, "
          f"worst leaf {leaf_worst:.2e} of max(1, |leaf|), worst gradient "
          f"{grad_worst:.2e} relative L2")


#: the tiny float32 fit: 11 train objects at train batch 2 -> 5 steps/epoch
TINY = ["data.fake=true", "model.backbone=resnet18", "data.crop_size=[32,32]",
        "data.relax=10", "data.area_thres=0", "data.train_batch=2",
        "data.val_batch=8", "data.num_workers=0", "log_every_steps=100",
        "checkpoint.preempt_check_every=1", "optim.lr=1e-3",
        "checkpoint.keep_latest=1"]
DEVICE_STAGE = ["data.device_augment=true", "data.device_augment_geom=true",
                "data.device_guidance=true"]


def tiny(work, *extra) -> config.Config:
    return config.apply_overrides(config.Config(),
                                  TINY + [f"work_dir={work}", *extra])


@pytest.mark.parametrize("knob", ["data.device_prefetch=0",
                                  "data.device_augment=true",
                                  "data.device_augment_geom=true",
                                  "data.device_guidance=true",
                                  "data.prepared_cache=/tmp/cache"])
def test_device_data_knobs_are_ported(knob):
    assert config.unported_knobs(config.apply_overrides(config.Config(),
                                                        [knob])) == []


@pytest.mark.parametrize("knob,shown", [
    ("data.uint8_transfer=true", "data.uint8_transfer=True"),
    ("data.packbits_masks=true", "data.packbits_masks=True"),
    ("data.coalesce_wire=true", "data.coalesce_wire=True"),
    ("data.steps_per_dispatch=2", "data.steps_per_dispatch=2"),
    ("data.echo=2", "data.echo=2")])
def test_wire_knobs_stay_refused(knob, shown):
    # the prepared builders take no wire arguments: the config is the one
    # place that refuses the uint8, packbits and coalesced wires by name
    assert config.unported_knobs(config.apply_overrides(config.Config(),
                                                        [knob])) == [shown]


def test_device_prefetch_window_is_bitwise(tmp_path, monkeypatch):
    windows = []
    prefetch = mesh.prefetch_to_device

    def spy(batches, device, size=2, keys=None):
        windows.append(size())
        return prefetch(batches, device, size=size, keys=keys)

    monkeypatch.setattr(mesh, "prefetch_to_device", spy)
    a = fit(tiny(tmp_path / "p0", "epochs=1", "eval_every=0",
                 "data.device_prefetch=0"))
    b = fit(tiny(tmp_path / "p2", "epochs=1", "eval_every=0"))
    # the window is max(device_prefetch, steps_per_dispatch), as the JAX
    # trainer reads it: 0 keeps one placement in flight, the default 2
    assert windows == [1, 2]
    assert config.Config().data.device_prefetch == 2 == b._device_prefetch
    assert a.state.step == b.state.step == 5
    for k, v in a.model.state_dict().items():
        assert torch.equal(b.model.state_dict()[k], v), k


def test_resume_with_device_stage_is_bitwise(tmp_path):
    straight = fit(tiny(tmp_path / "straight", "epochs=2", *DEVICE_STAGE))
    work = tmp_path / "preempted"
    stopped = fit(tiny(work, "epochs=2", *DEVICE_STAGE), StopAt(7))
    assert stopped.state.step == 7
    resumed = fit(tiny(work, "epochs=2", "resume=auto", *DEVICE_STAGE))
    assert resumed.state.step == straight.state.step == 10
    for k, v in straight.model.state_dict().items():
        assert torch.equal(resumed.model.state_dict()[k], v), k
    # the stage ran: the host stack lost its flip, rotation and guidance
    names = [type(t).__name__ for t in straight.train_set.transform.transforms]
    assert "RandomHorizontalFlip" not in names and "ScaleNRotate" not in names
    assert "NEllipseWithGaussians" not in names
