"""The multi-image, volume and slice paths of the vision tower, the port
against the JAX package on the CPU, float32.

- ``data.image.vilmedic_collate`` with ``multi_image``: the padding,
  truncation and mask case of tests/test_data.py (JAX's NHWC batch against
  the port's NCHW one, exactly), and an ``ImageDataset`` of comma-separated
  JPEG lines at the eval transform; ``device_preproc`` with ``multi_image``
  refused in both packages;
- ``VisualEncoder.encode`` on (B, N, 3, H, W) batches with one image
  masked: resnet18 to ``layer4`` at 64², N 3, projected to 16 (as
  tests/test_blocks.py), and a post-LN ViT (the RRG_HF tower): features
  within 1e-5 of JAX's and an equal mask; a pooled tower raises in both;
- ``3d_densenet121`` (avgpool and ``features``) on (2, 1, 32, 32, 32)
  volumes and ``slice_encode`` of a 2-D densenet121 over each slice along
  D, H and W (``slice_dim`` 1-3, counted as the JAX package lays out
  (B, D, H, W, C)): within 1e-4 of JAX's (conv sums in another order), the
  stem's channels taken from the JAX weights;
- the DINOv2 ``output_layer`` repair: a tower block with ``output_layer``
  set builds the same 2-layer tower in both packages, outputs within 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from vilmedic_torch.blocks.vision.visual_encoder import build_visual_encoder as tbuild
from vilmedic_torch.data.image import ImageDataset as TImageDataset
from vilmedic_torch.data.image import vilmedic_collate as tcollate
from vilmedic_torch.zoo.from_jax import rrg_state_dict_from_jax
from vilmedic_tpu.blocks.vision.visual_encoder import VisualEncoder as JVisualEncoder
from vilmedic_tpu.blocks.vision.visual_encoder import build_visual_encoder as jbuild
from vilmedic_tpu.data.image import ImageDataset as JImageDataset
from vilmedic_tpu.data.image import vilmedic_collate as jcollate

TOL = 1e-5
TOL_CONV = 1e-4  # conv sums over 7³ taps in another order than XLA's


def _chw(x, axis=1):
    """A JAX channel-last array as the port's tensor, channels at ``axis``:
    1 for images and volumes, 2 for (B, N, ...) multi-image batches."""
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(np.asarray(x), -1, axis)))


def _pair(block, x, images_mask=None, in_channels=None, perturb=0.0, seed=0):
    """The JAX tower from ``block`` with initial weights (plus N(0, perturb))
    and the port's carrying them. Returns (jax encoder, variables, port
    encoder)."""
    jenc = jbuild(dict(block))
    args = (jnp.asarray(x),) + ((images_mask,) if images_mask is not None else (None,))
    variables = jax.tree.map(np.asarray, jax.jit(
        lambda k: jenc.init(k, *args, method=JVisualEncoder.encode))(jax.random.key(seed)))
    if perturb:
        rng = np.random.default_rng(seed)
        variables["params"] = jax.tree.map(
            lambda a: a + perturb * rng.normal(size=a.shape).astype(np.float32),
            variables["params"])
    tenc = tbuild(dict(block), in_channels=in_channels).eval()
    tenc.load_state_dict(rrg_state_dict_from_jax(variables), strict=True)
    return jenc, variables, tenc


def _encode_both(jenc, variables, tenc, x, images_mask=None, axis=1):
    jm = None if images_mask is None else jnp.asarray(images_mask)
    want, want_mask = jenc.apply(variables, jnp.asarray(x), jm, method=JVisualEncoder.encode)
    tm = None if images_mask is None else torch.from_numpy(images_mask)
    with torch.no_grad():
        got, got_mask = tenc.encode(_chw(x, axis), tm)
    return (got.numpy(), got_mask.numpy()), (np.asarray(want), np.asarray(want_mask))


# ------------------------------------------------------------------ the collate

def test_collate_pads_truncates_and_masks_like_jax():
    im = np.ones((8, 8, 3), dtype=np.float32)
    batch = [{"image": [im, im * 2]}, {"image": [im]}, {"image": [im, im, im]}]
    want = jcollate(batch, multi_image=2)
    got = tcollate(batch, multi_image=2)
    assert got["images"].shape == (3, 2, 3, 8, 8)
    np.testing.assert_array_equal(got["images"].numpy(),
                                  np.moveaxis(want["images"], -1, 2))
    np.testing.assert_array_equal(got["images_mask"].numpy(), want["images_mask"])
    assert got["images_mask"].tolist() == [[True, True], [True, False], [True, True]]
    single = tcollate(batch, multi_image=1)
    assert sorted(single) == ["images"] and single["images"].shape == (3, 3, 8, 8)
    assert jcollate(batch, multi_image=1)["images_mask"] is None


def test_collate_masks_an_all_zero_image_like_jax():
    """A real image whose values sum to 0 is masked in both packages."""
    im = np.ones((4, 4, 3), dtype=np.float32)
    batch = [{"image": [np.zeros_like(im), im]}, {"image": [im, -im, im]}]
    want, got = jcollate(batch, multi_image=3), tcollate(batch, multi_image=3)
    np.testing.assert_array_equal(got["images_mask"].numpy(), want["images_mask"])
    assert got["images_mask"].tolist() == [[False, True, False], [True, True, True]]


@pytest.fixture(scope="module")
def jpegs(tmp_path_factory):
    root = tmp_path_factory.mktemp("multi_image")
    rng = np.random.default_rng(0)
    paths = []
    for i in range(4):
        p = root / f"im{i}.jpg"
        Image.fromarray(rng.integers(0, 255, (48, 40, 3), dtype=np.uint8)).save(p)
        paths.append(str(p))
    lines = [",".join(paths[:2]), paths[3], ",".join(paths[1:4]), paths[2]]
    (root / "validate.image.tok").write_text("\n".join(lines))
    (root / "train.image.tok").write_text("\n".join(lines))
    return root


def test_image_dataset_multi_image_batches_match_jax(jpegs):
    kw = dict(root=str(jpegs), file="image.tok", split="validate", resize=40, crop=32,
              multi_image=2)
    jds, tds = JImageDataset(**kw), TImageDataset(**kw)
    assert [len(x) for x in tds.images] == [len(x) for x in jds.images] == [2, 1, 3, 1]
    want = jds.get_collate_fn()([jds[i] for i in range(4)])
    got = tds.get_collate_fn()([tds[i] for i in range(4)])
    np.testing.assert_allclose(got["images"].numpy(), np.moveaxis(want["images"], -1, 2),
                               rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got["images_mask"].numpy(), want["images_mask"])
    assert got["images_mask"].tolist() == [[True, True], [True, False], [True, True],
                                           [True, False]]
    inference = tds.inference([jds.images[0], jds.images[1][0]])
    np.testing.assert_array_equal(inference["images"].numpy(), got["images"][:2].numpy())


def test_device_preproc_refuses_multi_image_like_jax(jpegs):
    kw = dict(root=str(jpegs), file="image.tok", split="train", multi_image=2,
              device_preproc=True)
    with pytest.raises(AssertionError, match="multi_image"):
        JImageDataset(**kw)
    with pytest.raises(ValueError, match="multi_image"):
        TImageDataset(**kw)


# ------------------------------------------------------------------ 5-D encode

RESNET = dict(proto="VisualEncoder", backbone="resnet18", output_layer="layer4",
              permute="batch_first", dropout_out=0.0,
              visual_projection=dict(in_features=512, out_features=16))
VIT = dict(proto="VisualEncoder", backbone="vit", permute="no_permute", hidden_size=32,
           num_hidden_layers=2, num_attention_heads=4, intermediate_size=64, patch_size=16,
           image_size=32, visual_projection=dict(in_features=32, out_features=24))


@pytest.mark.parametrize("block,size,tokens", [(RESNET, 64, 4), (VIT, 32, 5)],
                         ids=["resnet18-layer4", "vit-post-ln"])
def test_multi_image_encode_matches_jax(block, size, tokens):
    b, n = 2, 3
    x = np.random.default_rng(0).normal(size=(b, n, size, size, 3)).astype(np.float32)
    x[1, 2] = 0.0  # a padded image
    images_mask = np.asarray([[True, True, True], [True, True, False]])
    jenc, variables, tenc = _pair(block, x, images_mask, perturb=0.05)
    (got, got_mask), (want, want_mask) = _encode_both(jenc, variables, tenc, x, images_mask,
                                                      axis=2)
    out = block["visual_projection"]["out_features"]
    assert got.shape == want.shape == (b, n * tokens, out)
    np.testing.assert_array_equal(got_mask, want_mask)
    assert not got_mask[1, -tokens:].any() and got_mask[0].all()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL * np.abs(want).max())


def test_multi_image_encode_of_a_pooled_tower_raises_like_jax():
    block = dict(RESNET, output_layer="avgpool")
    x = np.ones((1, 2, 32, 32, 3), np.float32)
    with pytest.raises(ValueError, match="too small"):
        jbuild(dict(block)).init(jax.random.key(0), jnp.asarray(x), None,
                                 method=JVisualEncoder.encode)
    with pytest.raises(ValueError, match="too small"):
        tbuild(dict(block)).encode(_chw(x, 2))


def test_multi_image_encode_in_training_routes_the_flat_batch():
    """``train=True``: the B·N images share one batch-statistics pass; the
    masked image's tokens stay masked."""
    x = np.random.default_rng(1).normal(size=(2, 2, 64, 64, 3)).astype(np.float32)
    x[0, 1] = 0.0
    tenc = tbuild(dict(RESNET))
    feats, mask = tenc.encode(_chw(x, 2), torch.tensor([[True, False], [True, True]]),
                              train=True)
    assert feats.shape == (2, 8, 16) and mask.tolist() == [[True] * 4 + [False] * 4, [True] * 8]
    feats.sum().backward()
    assert tenc.model.bn_init.weight.grad is not None


# ------------------------------------------------------------------ volumes

VOLUME_CASES = [("avgpool", "batch_first"), ("features", "batch_first"),
                ("features", "no_permute")]


def _volume_block(backbone, **kw):
    return {"proto": "VisualEncoder", "backbone": backbone, "permute": "batch_first",
            "output_layer": "avgpool", **kw}


def _volume(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _slice_shape(slice_dim):
    shape = [2, 32, 32, 32, 1]
    shape[slice_dim] = 2
    return shape


@pytest.fixture(scope="module")
def volume_runs():
    """JAX's initial weights and encodings of every volume case, one jit per
    tower (their parameters depend neither on the output layer nor on the
    slice axis): a 3d_densenet121 and a 2-D densenet121 over slices, each
    over 1-channel input."""
    runs = {}
    encs = [jbuild(_volume_block("3d_densenet121", output_layer=o, permute=p))
            for o, p in VOLUME_CASES]

    def volumes(key, x):
        v = encs[0].init(key, x, method=JVisualEncoder.encode)
        return v, [e.apply(v, x, method=JVisualEncoder.encode) for e in encs]

    vol = _volume((2, 32, 32, 32, 1), 2)
    v, outs = jax.jit(volumes)(jax.random.key(0), jnp.asarray(vol))
    runs["3d"] = (jax.tree.map(np.asarray, v), vol, dict(zip(VOLUME_CASES, outs)))
    encs = [jbuild(_volume_block("densenet121", slice_encode=True, slice_dim=d))
            for d in (1, 2, 3)]
    vols = [_volume(_slice_shape(d), 3 + d) for d in (1, 2, 3)]

    def slices(key, xs):
        v = encs[0].init(key, xs[0], None, method=JVisualEncoder.encode)
        return v, [e.apply(v, x, None, method=JVisualEncoder.encode) for e, x in zip(encs, xs)]

    v, outs = jax.jit(slices)(jax.random.key(1), [jnp.asarray(x) for x in vols])
    runs["slice"] = (jax.tree.map(np.asarray, v), vols, dict(zip((1, 2, 3), outs)))
    return runs


def _port_encode(block, variables, vol):
    in_channels = variables["params"]["model"]["conv0"]["kernel"].shape[-2]
    tenc = tbuild(dict(block), in_channels=in_channels).eval()
    tenc.load_state_dict(rrg_state_dict_from_jax(variables), strict=True)
    with torch.no_grad():
        got, got_mask = tenc.encode(_chw(vol))
    return tenc, got.numpy(), got_mask.numpy()


def _close_conv(got, want):
    np.testing.assert_allclose(got, want, rtol=TOL_CONV, atol=TOL_CONV * np.abs(want).max())


@pytest.mark.parametrize("output_layer,permute", VOLUME_CASES)
def test_3d_densenet_matches_jax(volume_runs, output_layer, permute):
    variables, vol, outs = volume_runs["3d"]
    want, want_mask = (np.asarray(a) for a in outs[(output_layer, permute)])
    tenc, got, got_mask = _port_encode(
        _volume_block("3d_densenet121", output_layer=output_layer, permute=permute),
        variables, vol)
    assert tenc.model.conv0.weight.shape == (64, 1, 7, 7, 7)
    assert got.shape == want.shape
    if output_layer == "avgpool":
        assert got.shape == (2, 1024)
    np.testing.assert_array_equal(got_mask, want_mask)
    _close_conv(got, want)


def test_3d_densenet_needs_its_stem_channels():
    with pytest.raises(ValueError, match="in_channels"):
        tbuild(dict(backbone="3d_densenet121"))


@pytest.mark.parametrize("slice_dim", [1, 2, 3])
def test_slice_encode_matches_jax(volume_runs, slice_dim):
    """A 2-D densenet121 over each slice of a (B, D, H, W, 1) volume (the
    port's (B, 1, D, H, W)), two slices along ``slice_dim``: one pooled
    vector per slice."""
    variables, vols, outs = volume_runs["slice"]
    want, want_mask = (np.asarray(a) for a in outs[slice_dim])
    _, got, got_mask = _port_encode(
        _volume_block("densenet121", slice_encode=True, slice_dim=slice_dim), variables,
        vols[slice_dim - 1])
    assert got.shape == want.shape == (2, 2, 1024)
    np.testing.assert_array_equal(got_mask, want_mask)
    _close_conv(got, want)


def test_slice_dim_outside_the_volume_raises():
    with pytest.raises(ValueError, match="slice_dim"):
        tbuild(dict(backbone="densenet121", slice_encode=True, slice_dim=4))


# ------------------------------------------------------------------ DINOv2 repair

def test_dinov2_output_layer_is_ignored_like_jax():
    block = dict(proto="VisualEncoder", backbone="dinov2", output_layer="last_hidden_state",
                 hidden_size=32, num_hidden_layers=2, num_attention_heads=2, mlp_ratio=4.0,
                 patch_size=8, image_size=32, layer_norm_eps=1e-6)
    x = np.random.default_rng(4).normal(size=(2, 32, 32, 3)).astype(np.float32)
    jenc = jbuild(dict(block))
    variables = jax.tree.map(np.asarray, jax.jit(
        lambda k: jenc.init(k, jnp.asarray(x)))(jax.random.key(2)))
    want = np.asarray(jenc.apply(variables, jnp.asarray(x)))
    tenc = tbuild(dict(block)).eval()
    tenc.load_state_dict(rrg_state_dict_from_jax(variables), strict=True)
    with torch.no_grad():
        got = tenc(_chw(x)).numpy()
    assert got.shape == want.shape == (2, 17, 32)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL * np.abs(want).max())
