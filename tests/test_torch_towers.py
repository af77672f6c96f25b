"""The port's ViT and ResNet towers and the new ``VisualEncoder`` options
against the Flax modules, on the CPU, float32.

Flax variables are initialised (ResNet: norm scales, biases and running
statistics perturbed away from their identity values, so that no block's
zero-initialised last scale hides its branch), carried into the port
through ``zoo/from_jax.py``, and both sides run the same numpy images (NHWC
for Flax, NCHW for the port). Tolerance: 1e-4 of each output's (or
gradient's) largest entry (sums in another order than XLA's).

- ViT, post-LN and pre-LN, exact and tanh GELU, 2 layers of 32: the tokens,
  and the gradient of a fixed projection of them with respect to every
  parameter (dropout 0; training mode routes attention as a training step,
  dense at 17 tokens);
- resnet18 and resnet50 at 32² crops: every ``output_layer`` in eval mode,
  the training-mode forward (batch statistics) and the running statistics
  after it (Flax's momentum 0.9 update, biased variance), held against the
  port's float64 arithmetic and JAX's (see that test for why both);
- ``VisualEncoder``: ``spatial_first``, ``no_permute`` and pooled outputs of
  a ResNet, DenseNet's ``avgpool`` ``output_layer`` and the ``packed_growth``
  option, and a ViT tower's tokens whatever ``permute`` says.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vilmedic_torch.blocks.vision.densenet as tdensenet
import vilmedic_tpu.blocks.vision.densenet as jdensenet
from vilmedic_torch.blocks.vision.densenet import commit_batch_stats
from vilmedic_torch.blocks.vision.resnet import make_resnet as tmake_resnet
from vilmedic_torch.blocks.vision.visual_encoder import build_visual_encoder as tbuild
from vilmedic_torch.blocks.vision.vit import make_vit as tmake_vit
from vilmedic_torch.zoo.from_jax import rrg_state_dict_from_jax
from vilmedic_tpu.blocks.vision.resnet import make_resnet as jmake_resnet
from vilmedic_tpu.blocks.vision.visual_encoder import build_visual_encoder as jbuild
from vilmedic_tpu.blocks.vision.vit import make_vit as jmake_vit

REL = 1e-4
VIT = dict(hidden_size=32, num_hidden_layers=2, num_attention_heads=4, intermediate_size=64,
           patch_size=8, image_size=32, layer_norm_eps=1e-12)


def _close(got, want, rel=REL):
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0, atol=rel * scale)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _perturbed_stats(variables, rng):
    """Norm scales and biases and running statistics away from identity."""
    def params(path, x):
        name = jax.tree_util.keystr(path)
        x = np.asarray(x)
        if "BatchNorm" in name or "bn_init" in name or "norm_proj" in name:
            if name.endswith("['scale']"):
                return rng.uniform(0.5, 1.5, x.shape).astype(np.float32)
            return (0.1 * rng.normal(size=x.shape)).astype(np.float32)
        return x

    def stats(path, x):
        if jax.tree_util.keystr(path).endswith("['mean']"):
            return (0.1 * rng.normal(size=x.shape)).astype(np.float32)
        return rng.uniform(0.5, 1.5, x.shape).astype(np.float32)

    return {"params": jax.tree_util.tree_map_with_path(params, variables["params"]),
            "batch_stats": jax.tree_util.tree_map_with_path(stats, variables["batch_stats"])}


# ---------------------------------------------------------------- ViT

@pytest.mark.parametrize("pre_ln", [False, True])
@pytest.mark.parametrize("act", ["gelu", "gelu_tanh"])
def test_vit_forward_and_gradient_match_jax(pre_ln, act):
    rng = np.random.default_rng(int(pre_ln) * 2 + (act == "gelu_tanh"))
    images = rng.normal(size=(2, 32, 32, 3)).astype(np.float32)
    proj = rng.normal(size=(2, 17, 32)).astype(np.float32)
    jvit = jmake_vit("vit", **VIT, pre_ln=pre_ln, hidden_act=act)
    variables = jax.jit(jvit.init)(jax.random.key(0), jnp.asarray(images))
    variables = jax.tree.map(lambda x: np.asarray(x) + 0.02 * rng.normal(size=x.shape)
                             .astype(np.float32), variables)

    def jloss(params):
        out = jvit.apply({"params": params}, jnp.asarray(images), train=True,
                         rngs={"dropout": jax.random.key(1)})
        return jnp.sum(out * proj), out

    (_, jout_train), jgrads = jax.value_and_grad(jloss, has_aux=True)(variables["params"])
    jout = jvit.apply(variables, jnp.asarray(images))

    tvit = tmake_vit("vit", **VIT, pre_ln=pre_ln, hidden_act=act)
    tvit.load_state_dict(rrg_state_dict_from_jax(variables), strict=True)
    x = _nchw(images)
    with torch.no_grad():
        tout = tvit(x)
    assert tout.shape == (2, 17, 32)
    _close(tout.numpy(), jout)
    out = tvit(x, train=True, generator=torch.Generator().manual_seed(0))
    _close(out.detach().numpy(), jout_train)
    (out * torch.from_numpy(proj)).sum().backward()
    want = rrg_state_dict_from_jax({"params": jax.tree.map(np.asarray, jgrads)})
    got = dict(tvit.named_parameters())
    assert sorted(want) == sorted(got)
    for name, g in want.items():
        if name.endswith("self_attn.k.bias"):  # 0 up to rounding: softmax is shift-invariant
            assert float(got[name].grad.abs().max()) < 1e-5 * float(
                want[name.replace("bias", "weight")].abs().max())
            continue
        _close(got[name].grad.numpy(), g.numpy())


def test_vit_gradient_checkpointing_raises():
    """``gradient_checkpointing`` raised before it was ported; now the tower
    builds with it (full recompute), and its gradient equals the same
    tower's without it (bitwise) and the Flax ViT's built with the same mode
    (``jax.checkpoint`` per layer; ``tests/test_torch_grad_checkpoint.py``
    holds both modes with dropout)."""
    _vit_checkpointing_matches_jax(True)


def test_vit_dots_checkpointing_matches_jax():
    """As above with ``"dots"`` (the matmul outputs kept)."""
    _vit_checkpointing_matches_jax("dots")


def _vit_checkpointing_matches_jax(mode):
    rng = np.random.default_rng(11)
    images = rng.normal(size=(2, 32, 32, 3)).astype(np.float32)
    proj = rng.normal(size=(2, 17, 32)).astype(np.float32)
    jvit = jmake_vit("vit", **VIT, gradient_checkpointing=mode)
    params = jax.jit(jvit.init)(jax.random.key(0), jnp.asarray(images))["params"]

    def jloss(p):
        return jnp.sum(jvit.apply({"params": p}, jnp.asarray(images), train=True,
                                  rngs={"dropout": jax.random.key(1)}) * proj)

    jgrads = jax.grad(jloss)(params)
    want = rrg_state_dict_from_jax({"params": jax.tree.map(np.asarray, jgrads)})
    grads = []
    for m in (False, mode):
        tower = tmake_vit("vit", **VIT, gradient_checkpointing=m)
        assert tower.config.gradient_checkpointing == m
        tower.load_state_dict(rrg_state_dict_from_jax({"params": params}), strict=True)
        (tower(_nchw(images), train=True) * torch.from_numpy(proj)).sum().backward()
        grads.append({n: p.grad for n, p in tower.named_parameters()})
    for name, g in grads[0].items():
        torch.testing.assert_close(grads[1][name], g, rtol=0, atol=0)
        if name.endswith("self_attn.k.bias"):  # 0 up to rounding: softmax is shift-invariant
            continue
        _close(grads[1][name].numpy(), want[name].numpy())


# ---------------------------------------------------------------- ResNet

@pytest.fixture(scope="module", params=["resnet18", "resnet50"])
def resnets(request):
    """A Flax ResNet at ``avgpool`` with perturbed statistics, and images."""
    rng = np.random.default_rng(7)
    # batch 32: layer4 is 1x1 at a 32² crop, so its batch statistics are
    # over 32 values per channel
    images = rng.normal(size=(32, 32, 32, 3)).astype(np.float32)
    jnet = jmake_resnet(request.param, "avgpool")
    variables = jax.jit(jnet.init)(jax.random.key(0), jnp.asarray(images))
    return request.param, _perturbed_stats(variables, rng), images


@pytest.mark.parametrize("layer", ["stem", "layer1", "layer2", "layer3", "layer4", "avgpool"])
def test_resnet_output_layers_match_jax(resnets, layer):
    name, variables, images = resnets
    jnet = jmake_resnet(name, layer)
    # a truncated Flax ResNet has only the stages it runs
    keep = lambda tree: {k: v for k, v in tree.items()  # noqa: E731
                         if not k.startswith("layer") or
                         (layer != "stem" and (layer == "avgpool" or int(k[5]) <= int(layer[-1])))}
    vs = {"params": keep(variables["params"]), "batch_stats": keep(variables["batch_stats"])}
    jout = np.asarray(jnet.apply(vs, jnp.asarray(images)))
    tnet = tmake_resnet(name, layer).eval()
    tnet.load_state_dict(rrg_state_dict_from_jax(vs), strict=True)
    with torch.no_grad():
        tout = tnet(_nchw(images)).numpy()
    if tout.ndim == 4:
        tout = tout.transpose(0, 2, 3, 1)
    assert tout.shape == jout.shape
    _close(tout, jout)


def _float64(module):
    """A float64 copy of a port module: parameters, buffers and compute
    dtypes (the exact-arithmetic reference of the same function)."""
    import copy

    module = copy.deepcopy(module).double()
    for m in module.modules():
        for attr in ("compute_dtype", "out_dtype"):
            if hasattr(m, attr):
                setattr(m, attr, torch.float64)
    return module


def test_resnet_train_mode_and_running_stats_match_jax(resnets):
    """The training-mode forward (batch statistics) and the running
    statistics it leaves. Flax computes the batch variance as E[x²] - E[x]²
    in f32, which through ResNet-50's 16 re-normalized blocks puts its
    output up to ~6e-4 of the largest entry off the float64 result; the
    port (two-pass variance) stays within 1e-4 of it. So the port is held
    within 1e-4 of float64 arithmetic, and within 1e-4 of JAX beyond JAX's
    own distance from float64."""
    name, variables, images = resnets
    jnet = jmake_resnet(name, "avgpool")
    jout, updated = jnet.apply(variables, jnp.asarray(images), train=True,
                               mutable=["batch_stats"])
    jout = np.asarray(jout)
    want = rrg_state_dict_from_jax({"params": {}, "batch_stats": jax.tree.map(
        np.asarray, updated["batch_stats"])})
    tnet = tmake_resnet(name, "avgpool")
    tnet.load_state_dict(rrg_state_dict_from_jax(variables), strict=True)
    exact = _float64(tnet)
    with torch.no_grad():
        tout = tnet(_nchw(images), train=True).numpy()
        xout = exact(_nchw(images).double(), train=True).numpy()
    commit_batch_stats(tnet, True)
    commit_batch_stats(exact, True)
    pairs = [(tout, jout, xout, REL)] + [
        (tnet.state_dict()[k].numpy(), v.numpy(), exact.state_dict()[k].numpy(), 1e-5)
        for k, v in want.items()]
    assert len(pairs) > 20
    for got, jax_value, exact_value, rel in pairs:
        _close(got, exact_value, rel)
        jax_off = np.abs(jax_value - exact_value).max()
        np.testing.assert_allclose(got, jax_value, rtol=0,
                                   atol=jax_off + rel * np.abs(exact_value).max())


# ---------------------------------------------------------------- VisualEncoder

def _encoder_pair(cfg, images, rng):
    jenc = jbuild(dict(cfg))
    variables = jax.jit(jenc.init)(jax.random.key(0), jnp.asarray(images))
    if "batch_stats" in variables:
        variables = _perturbed_stats(variables, rng)
    tenc = tbuild(dict(cfg), crop=images.shape[1])
    tenc.load_state_dict(rrg_state_dict_from_jax(variables), strict=True)
    return jenc, variables, tenc.eval()


@pytest.mark.parametrize("cfg", [
    dict(backbone="resnet18", output_layer="layer3", permute="spatial_first"),
    dict(backbone="resnet18", output_layer="layer2", permute="no_permute"),
    dict(backbone="resnet18", output_layer="layer3", permute="batch_first"),
    dict(backbone="resnet18", output_layer="avgpool", permute="batch_first"),
    dict(backbone="densenet_tiny", output_layer="avgpool", permute="batch_first"),
    dict(backbone="densenet_tiny", output_layer="features", permute="spatial_first",
         packed_growth=True),
    dict(backbone="vit", permute="batch_first", **VIT),
    dict(backbone="vit", permute="spatial_first", pre_ln=True, **VIT),
], ids=["resnet-spatial_first", "resnet-no_permute", "resnet-batch_first", "resnet-avgpool",
        "densenet-avgpool", "densenet-packed-spatial_first", "vit-batch_first",
        "vit-spatial_first"])
def test_visual_encoder_options_match_jax(cfg, monkeypatch):
    monkeypatch.setitem(jdensenet.CONFIGS, "densenet_tiny", (8, (2, 2), 16))
    monkeypatch.setitem(tdensenet.CONFIGS, "densenet_tiny", (8, (2, 2), 16))
    rng = np.random.default_rng(11)
    images = rng.normal(size=(2, 32, 32, 3)).astype(np.float32)
    jenc, variables, tenc = _encoder_pair(cfg, images, rng)
    jout = np.asarray(jenc.apply(variables, jnp.asarray(images)))
    with torch.no_grad():
        tout = tenc(_nchw(images)).numpy()
    assert tout.shape == jout.shape
    _close(tout, jout)
