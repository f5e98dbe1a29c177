"""The port's DANet and ResNet against the JAX package's, on the CPU.

A JAX DANet is built and EVERY leaf is redrawn from a numpy generator —
the residual gates and the zero-init last-BN scales included, which at
their init value would cut the attention branches out of the logits — then
carried into the port with ``load_jax_params`` (strict).  Both forwards
run in float32; the three logits must agree within 1e-4 x max(1, max
|logit|): summation order only.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from distributedpytorch_tpu.models import build_model as jax_build_model
from distributedpytorch_tpu_torch.models import DANet, build_model
from distributedpytorch_tpu_torch.models.resnet import conv, max_pool_same, same_pad
from distributedpytorch_tpu_torch.utils.weights import (
    jax_to_state_dict,
    load_jax_params,
)

RTOL = 1e-4


def randomize(variables, seed=1):
    """Every leaf of a flax variable tree redrawn from numpy, at scales that
    keep a deep net's activations moderate."""
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = str(path[-1].key)
        shape = np.shape(leaf)
        if name == "kernel":
            fan_in = int(np.prod(shape[:3]))
            return (rng.normal(size=shape) * np.sqrt(2.0 / fan_in)).astype(np.float32)
        if name == "scale":
            return rng.uniform(0.2, 0.6, shape).astype(np.float32)
        if name == "var":
            return rng.uniform(0.5, 2.0, shape).astype(np.float32)
        if name == "gamma":
            return np.float32(rng.uniform(0.5, 1.0))
        return (rng.normal(size=shape) * 0.1).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, jax.device_get(variables))


def jax_danet(backbone, size):
    model = jax_build_model("danet", nclass=1, backbone=backbone,
                            output_stride=8, attention_impl="xla")
    variables = model.init(jax.random.PRNGKey(0),
                           jnp.zeros((1, size, size, 4)), train=False)
    return model, randomize(variables)


def port_danet(backbone, variables):
    model = build_model("danet", nclass=1, backbone=backbone, output_stride=8)
    load_jax_params(model, variables["params"], variables["batch_stats"])
    return model.eval()


def crops(size, b=2, seed=2):
    return np.random.default_rng(seed).uniform(
        0, 255, (b, size, size, 4)).astype(np.float32)


def compare_logits(jax_model, variables, port_model, x):
    ref = jax_model.apply(variables, jnp.asarray(x), train=False)
    with torch.no_grad():
        got = port_model(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert len(got) == 3
    for r, g in zip(ref, got):
        r = np.asarray(r)[..., 0]
        g = g[:, 0].numpy()
        assert g.shape == r.shape
        bound = RTOL * max(1.0, float(np.abs(r).max()))
        assert float(np.abs(g - r).max()) <= bound


@pytest.mark.parametrize("size", [64, 65])
def test_danet_r18_matches_jax(size):
    jm, variables = jax_danet("resnet18", size)
    compare_logits(jm, variables, port_danet("resnet18", variables),
                   crops(size))


def test_danet_r101_matches_jax():
    jm, variables = jax_danet("resnet101", 64)
    compare_logits(jm, variables, port_danet("resnet101", variables),
                   crops(64, b=1))


def test_gates_and_last_bn_scales_reach_the_port():
    _, variables = jax_danet("resnet18", 32)
    model = port_danet("resnet18", variables)
    assert model.head.pam.gamma.item() == pytest.approx(
        float(variables["params"]["head"]["pam"]["gamma"]))
    assert model.head.cam.gamma.item() != 0.0
    last_bn = model.backbone.BasicBlock_0.BatchNorm_1.weight
    assert torch.all(last_bn != 0)


class TestSamePadding:
    """flax SAME padding on stride-2 layers puts the extra pixel at the
    bottom/right; torch's symmetric padding would shift the map."""

    @pytest.mark.parametrize("kernel,stride,dilation,size", [
        (7, 2, 1, 32), (7, 2, 1, 33), (3, 2, 1, 16), (3, 2, 1, 17),
        (3, 1, 2, 16), (3, 1, 4, 9), (1, 2, 1, 16), (1, 2, 1, 15),
    ])
    def test_conv_matches_flax(self, kernel, stride, dilation, size):
        x = np.random.default_rng(3).normal(size=(1, size, size, 3)).astype(np.float32)
        layer = fnn.Conv(5, (kernel, kernel), strides=(stride, stride),
                         kernel_dilation=(dilation, dilation), use_bias=False)
        params = layer.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
        ref = np.asarray(layer.apply({"params": params}, jnp.asarray(x)))
        port = conv(3, 5, kernel, stride, dilation)
        port.weight.data = torch.from_numpy(
            np.asarray(params["kernel"]).transpose(3, 2, 0, 1).copy())
        with torch.no_grad():
            got = port(torch.from_numpy(x).permute(0, 3, 1, 2))
        got = got.permute(0, 2, 3, 1).numpy()
        assert got.shape == ref.shape
        np.testing.assert_allclose(got, ref, atol=1e-5)

    @pytest.mark.parametrize("size", [16, 17])
    def test_max_pool_matches_flax(self, size):
        x = np.random.default_rng(4).normal(size=(1, size, size, 2)).astype(np.float32)
        ref = np.asarray(fnn.max_pool(jnp.asarray(x), (3, 3), strides=(2, 2),
                                      padding="SAME"))
        got = max_pool_same(torch.from_numpy(x).permute(0, 3, 1, 2))
        np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), ref)

    @pytest.mark.parametrize("size,kernel,stride,dilation,pads", [
        (512, 7, 2, 1, (2, 3)), (65, 7, 2, 1, (3, 3)), (256, 3, 2, 1, (0, 1)),
        (64, 3, 1, 4, (4, 4)), (64, 1, 1, 1, (0, 0)),
    ])
    def test_same_pad_split(self, size, kernel, stride, dilation, pads):
        assert same_pad(size, kernel, stride, dilation) == pads


class TestBuildAndLoad:
    def test_other_models_raise(self):
        for name in ("pspnet", "encnet", "ccnet"):
            with pytest.raises(ValueError, match="not ported"):
                build_model(name)
        with pytest.raises(ValueError, match="attention_impl"):
            build_model("danet", backbone="resnet18", attention_impl="cuda")

    def test_set_attention_impl(self):
        model = build_model("danet", backbone="resnet18", attention_impl="xla")
        assert model.head.pam.impl == model.head.cam.impl == "einsum"
        model.set_attention_impl("flash")
        assert model.head.pam.impl == model.head.cam.impl == "flash"
        with pytest.raises(ValueError):
            model.set_attention_impl("ring")

    def test_strict_load_rejects_missing_leaf(self):
        _, variables = jax_danet("resnet18", 32)
        del variables["params"]["head"]["pam"]["gamma"]
        model = DANet(nclass=1, backbone_depth=18)
        with pytest.raises(RuntimeError, match="gamma"):
            load_jax_params(model, variables["params"], variables["batch_stats"])

    def test_layout_conversion(self):
        kernel = np.arange(3 * 3 * 4 * 5, dtype=np.float32).reshape(3, 3, 4, 5)
        state = jax_to_state_dict(
            {"c": {"kernel": kernel}, "bn": {"scale": np.ones(5, np.float32)}},
            {"bn": {"mean": np.zeros(5, np.float32),
                    "var": np.full(5, 2.0, np.float32)}})
        assert state["c.weight"].shape == (5, 4, 3, 3)
        assert state["c.weight"][2, 1, 0, 2].item() == kernel[0, 2, 1, 2]
        assert set(state) == {"c.weight", "bn.weight", "bn.running_mean",
                              "bn.running_var"}
        with pytest.raises(KeyError):
            jax_to_state_dict({"c": {"embedding": kernel}}, {})
