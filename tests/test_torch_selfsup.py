"""SELFSUP (ConVIRT, GLoRIA) and its losses, the port against the JAX
package on the CPU, float32:

- the six losses the SELFSUP and MVQA configs name (``ConVIRTLoss``,
  ``InfoNCELoss``, ``VICREGLoss``, ``GLoRIALoss``, ``SuperLoss``,
  ``MixUpLoss``) and ``gloria_attention``, within 1e-5 relative;
  ``ConVIRTLoss`` and ``GLoRIALoss`` gradients against ``jax.grad`` within
  1e-5 of the largest; the GLoRIA local loss against the ragged per-caption
  oracle of tests/test_losses.py (float64 oracle, 2e-5 as there);
- GLoRIA's report cleaner and the stemming ROUGE cleaner without NLTK
  (the card's machine has none): the JAX package's text;
- ResNet's ``capture_layer`` (resnet18 at 64², layer3) in eval and train
  mode, the running statistics it leaves included: 1e-5 of the largest;
- ``GLoRIA._aggregate_words`` on the ``##`` vocabulary of
  tests/test_models_families.py: equal to JAX's;
- ConVIRT (a tiny ViT tower and a tiny ResNet tower) and GLoRIA (resnet18)
  forwards, eval and train mode, with weights carried by
  ``convirt_state_dict_from_jax`` / ``gloria_state_dict_from_jax``:
  outputs 1e-5 of the largest, losses 1e-5 relative; ``zero_shot_
  classification`` picks JAX's classes;
- one epoch of the train CLI (``python -m vilmedic_torch.bin.train``) on
  ``config/SELFSUP/convirt-mimic.yml`` and ``gloria-mimic.yml`` cut down by
  dotlist overrides (``dataset.seq.tokenizer=null``: the corpus vocabulary)
  against ``bin_tpu/train.py``'s Trainor + Validator from the same initial
  weights: the epoch's loss within 1e-5 relative, ``validation_loss``
  within 1e-5; then the ensemble CLI over the run's checkpoint gives the
  run's ``validation_loss`` and the embeddings.
"""

import os
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import transformers.utils.hub as hf_hub
import yaml
from PIL import Image

import vilmedic_torch.bin.train as tcli
from vilmedic_torch.blocks import losses as tlosses
from vilmedic_torch.blocks.vision.densenet import commit_batch_stats
from vilmedic_torch.blocks.vision.resnet import make_resnet as tmake_resnet
from vilmedic_torch.executors import Trainor as TTrainor
from vilmedic_torch.models.selfsup import ConVIRT as TConVIRT
from vilmedic_torch.models.selfsup import GLoRIA as TGLoRIA
from vilmedic_torch.zoo.from_jax import (
    convirt_state_dict_from_jax, gloria_state_dict_from_jax, rrg_state_dict_from_jax,
)
from vilmedic_tpu.blocks import losses as jlosses
from vilmedic_tpu.blocks.vision.resnet import BasicBlock, ResNet
from vilmedic_tpu.config.config import executor_config, load_config
from vilmedic_tpu.executors import Trainor as JTrainor
from vilmedic_tpu.executors import Validator as JValidator
from vilmedic_tpu.models.selfsup import ConVIRT as JConVIRT
from vilmedic_tpu.models.selfsup import GLoRIA as JGLoRIA
from vilmedic_tpu.utils import set_logger as jset_logger

REPO = pathlib.Path(__file__).resolve().parents[1]
REL = 1e-5
SEED = 515151
TINY_TRANSFORMER = {"proto": None, "hidden_size": 32, "num_hidden_layers": 1,
                    "num_attention_heads": 4, "intermediate_size": 64,
                    "max_position_embeddings": 64, "hidden_dropout_prob": 0.0}
TINY_VIT = {"proto": "VisualEncoder", "backbone": "vit", "permute": "batch_first",
            "hidden_size": 32, "num_hidden_layers": 1, "num_attention_heads": 4,
            "intermediate_size": 64, "patch_size": 16}
TINY_RESNET = {"proto": "VisualEncoder", "backbone": "resnet18", "output_layer": "avgpool",
               "permute": "batch_first"}
REPORTS = ["no acute disease .", "heart size is normal .", "small pleural effusion .",
           "no evidence of pneumonia .", "lungs are clear .", "mild cardiomegaly .",
           "no acute disease .", "lungs are clear ."]


def _close(got, want, rel=REL):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=rel * max(float(np.abs(want).max()), 1e-30))


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


# ---------------------------------------------------------------- losses

def _gloria_inputs(rng, b=4, s=9, t=6, d=8):
    lens = np.asarray([6, 3, 5, 2])[:b]
    return (rng.normal(size=(b, d)).astype(np.float32),
            rng.normal(size=(b, s, d)).astype(np.float32),
            rng.normal(size=(b, t, d)).astype(np.float32),
            rng.normal(size=(b, d)).astype(np.float32),
            (np.arange(t)[None, :] < lens[:, None]).astype(np.float32))


def _loss_case(name, rng):
    """(kwargs, inputs) of one loss."""
    z = lambda: (2 * rng.normal(size=(6, 16))).astype(np.float32)  # noqa: E731
    if name == "ConVIRTLoss":
        return {"tau": 0.1, "lambda_": 0.75}, (z(), z())
    if name == "InfoNCELoss":
        return {"tau": 0.5}, (z(), z())
    if name == "VICREGLoss":
        return {}, (z(), z())
    if name == "GLoRIALoss":
        return {"temp1": 4.0, "temp2": 5.0, "temp3": 10.0}, _gloria_inputs(rng)
    if name == "SuperLoss":
        return {"C": 10, "lam": 0.25}, ((3 * np.abs(rng.normal(size=12))).astype(np.float32),)
    logits = (3 * rng.normal(size=(6, 5))).astype(np.float32)
    return {"criterion": "CrossEntropyLoss"}, (logits, rng.integers(0, 5, 6),
                                               rng.integers(0, 5, 6), 0.3)


@pytest.mark.parametrize("name", ["ConVIRTLoss", "InfoNCELoss", "VICREGLoss", "GLoRIALoss",
                                  "SuperLoss", "MixUpLoss"])
def test_losses_match_jax(name):
    kwargs, inputs = _loss_case(name, np.random.default_rng(3))
    want = getattr(jlosses, name)(**kwargs)(
        *[jnp.asarray(x) if isinstance(x, np.ndarray) else x for x in inputs])
    got = getattr(tlosses, name)(**kwargs)(
        *[torch.from_numpy(x) if isinstance(x, np.ndarray) else x for x in inputs])
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), rtol=REL, atol=1e-7)


def test_gloria_attention_matches_jax():
    rng = np.random.default_rng(4)
    word, context = rng.normal(size=(3, 5, 8)), rng.normal(size=(3, 7, 8))
    mask = np.ones((3, 5), np.float32)
    mask[1, 2:] = 0
    mask[2] = 0  # an all-masked caption: a uniform first softmax, no NaN
    word, context = word.astype(np.float32), context.astype(np.float32)
    for m in (None, mask):
        want = jlosses.gloria_attention(jnp.asarray(word), jnp.asarray(context), 4.0,
                                        None if m is None else jnp.asarray(m))
        got = tlosses.gloria_attention(*_t(word, context), 4.0,
                                       None if m is None else torch.from_numpy(m))
        for g, w in zip(got, want):
            assert torch.isfinite(g).all()
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=REL, atol=1e-6)


@pytest.mark.parametrize("name", ["ConVIRTLoss", "GLoRIALoss"])
def test_loss_gradients_match_jax(name):
    kwargs, inputs = _loss_case(name, np.random.default_rng(5))
    n = 2 if name == "ConVIRTLoss" else 4  # GLoRIA: not the word mask
    jfn = getattr(jlosses, name)(**kwargs)

    def scalar(*xs):
        out = jfn(*xs, *[jnp.asarray(x) for x in inputs[n:]])
        return out[0] if isinstance(out, tuple) else out

    want = jax.grad(scalar, argnums=tuple(range(n)))(*[jnp.asarray(x) for x in inputs[:n]])
    args = [torch.from_numpy(x).requires_grad_(i < n) for i, x in enumerate(inputs)]
    out = getattr(tlosses, name)(**kwargs)(*args)
    (out[0] if isinstance(out, tuple) else out).backward()
    for a, w in zip(args[:n], want):
        _close(a.grad.numpy(), w)


def test_gloria_local_loss_matches_the_ragged_oracle():
    """The reference's per-caption loop (each caption cut to its length) in
    float64, as tests/test_losses.py holds the JAX loss."""
    rng = np.random.default_rng(0)
    b, s, tmax, d = 4, 9, 6, 8
    t1, t2, t3 = 4.0, 5.0, 10.0
    img = rng.normal(size=(b, s, d))
    words = rng.normal(size=(b, tmax, d))
    lens = np.asarray([6, 3, 5, 2])
    mask = (np.arange(tmax)[None, :] < lens[:, None]).astype(np.float32)

    def softmax(x, axis):
        e = np.exp(x - x.max(axis=axis, keepdims=True))
        return e / e.sum(axis=axis, keepdims=True)

    sims = np.zeros((b, b))  # [image j, text i]
    for i in range(b):
        word = words[i, :lens[i]]
        for j in range(b):
            a = softmax(softmax(img[j] @ word.T, axis=1).T * t1, axis=1)
            wctx = a @ img[j]
            cos = (word * wctx).sum(-1) / np.clip(
                np.linalg.norm(word, axis=-1) * np.linalg.norm(wctx, axis=-1), 1e-8, None)
            sims[j, i] = np.log(np.exp(cos * t2).sum())
    sims *= t3

    def ce(scores):
        m = scores.max(1, keepdims=True)
        return -np.mean(np.diag(scores - m - np.log(np.exp(scores - m).sum(1, keepdims=True))))

    l0, l1 = tlosses.GLoRIALoss(temp1=t1, temp2=t2, temp3=t3).local_loss(
        *_t(img.astype(np.float32), words.astype(np.float32), mask))
    np.testing.assert_allclose(float(l0 + l1), ce(sims) + ce(sims.T), rtol=2e-5, atol=2e-5)


# ---------------------------------------------------------------- the cleaners

@pytest.mark.parametrize("name,kwargs", [("gloria_clean_report_chexpert", {}),
                                         ("rouge", {"use_stemmer": True})],
                         ids=["gloria", "rouge-stemmer"])
def test_cleaners_need_no_nltk(name, kwargs, monkeypatch):
    """GLoRIA's report cleaner (``gloria-mimic.yml``'s ``processing``) and
    the stemming ROUGE cleaner run where NLTK is not installed (the card's
    machine) and give the JAX package's text, which NLTK makes."""
    import sys

    from vilmedic_torch.data import processing as tprocessing
    from vilmedic_tpu.data import processing as jprocessing

    reports = ["1. Heart is normal. 2. No effusion seen.", "Lungs: clear!! No pneumothorax...",
               "Hx: s/p CABG. R-sided PICC (tip @ SVC).\nET tube 4.2 cm above carina.",
               "Mild \u00e9 cardiomegaly; stable opacities, increasing effusions.", "", "a. b"]
    want = [jprocessing.get_processing(name)(r, **kwargs) for r in reports]
    for module in ("nltk", "nltk.tokenize", "nltk.stem"):
        monkeypatch.setitem(sys.modules, module, None)
    assert [tprocessing.get_processing(name)(r, **kwargs) for r in reports] == want


# ---------------------------------------------------------------- capture_layer

def test_resnet_capture_layer_matches_jax():
    rng = np.random.default_rng(7)
    images = rng.normal(size=(4, 64, 64, 3)).astype(np.float32)
    jnet = ResNet(stage_sizes=[2, 2, 2, 2], block_cls=BasicBlock, capture_layer="layer3")
    variables = jax.jit(jnet.init)(jax.random.key(0), jnp.asarray(images))
    variables = {"params": jax.tree.map(np.asarray, variables["params"]),
                 "batch_stats": jax.tree.map(lambda x: rng.uniform(0.5, 1.5, x.shape)
                                             .astype(np.float32), variables["batch_stats"])}
    tnet = tmake_resnet("resnet18", "avgpool", capture_layer="layer3")
    tnet.load_state_dict(rrg_state_dict_from_jax(variables), strict=True)
    assert tnet.captured_channels == 256
    jout, jcap = jnet.apply(variables, jnp.asarray(images))
    with torch.no_grad():
        tout, tcap = tnet(_nchw(images))
    assert tuple(tcap.shape) == (4, 4, 4, 256)  # NHWC, as the JAX module's
    _close(tout.numpy(), jout)
    _close(tcap.numpy(), jcap)
    (jout, jcap), updated = jnet.apply(variables, jnp.asarray(images), train=True,
                                       mutable=["batch_stats"])
    with torch.no_grad():
        tout, tcap = tnet(_nchw(images), train=True)
    _close(tout.numpy(), jout)
    _close(tcap.numpy(), jcap)
    commit_batch_stats(tnet, True)
    want = rrg_state_dict_from_jax({"params": {}, "batch_stats": jax.tree.map(
        np.asarray, updated["batch_stats"])})
    for key, value in want.items():
        _close(tnet.state_dict()[key].numpy(), value.numpy())


# ---------------------------------------------------------------- the models

class _Tok:
    """The ``##`` vocabulary of tests/test_models_families.py, widened."""
    vocab = {"[PAD]": 0, "[UNK]": 1, "[CLS]": 2, "[SEP]": 3, "pneumo": 4, "##thorax": 5,
             "clear": 6, **{f"w{i}": 7 + i for i in range(20)}, "##s": 27, "##ed": 28}
    cls_token, sep_token, pad_token = "[CLS]", "[SEP]", "[PAD]"
    vocab_size = 29


class _DL:
    class dataset:  # noqa: N801
        tokenizer = _Tok()


def test_aggregate_words_matches_jax():
    ids = np.array([[2, 4, 5, 6, 3, 0], [2, 7, 27, 28, 8, 3], [4, 5, 5, 9, 0, 0]], np.int32)
    mask = (ids != 0).astype(np.int32)
    mask[2, 3] = 0  # a piece under the mask is dropped
    enc = {"proto": None, "hidden_size": 8, "num_hidden_layers": 1, "num_attention_heads": 2,
           "intermediate_size": 16, "max_position_embeddings": 16}
    cnn = {"backbone": "resnet18", "feature_dim": 8}
    jg = JGLoRIA(encoder=dict(enc), cnn=dict(cnn), dl=_DL())
    tg = TGLoRIA(encoder=dict(enc), cnn=dict(cnn), dl=_DL(), device="cpu")
    emb = np.random.default_rng(2).normal(size=(3, 6, 8)).astype(np.float32)
    jagg, jmask = jg._aggregate_words(jnp.asarray(emb), jnp.asarray(ids), jnp.asarray(mask))
    tagg, tmask = tg._aggregate_words(*_t(emb), torch.from_numpy(ids).long(),
                                      torch.from_numpy(mask))
    np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask))
    np.testing.assert_array_equal(tagg.numpy(), np.asarray(jagg))
    np.testing.assert_array_equal(tmask[0].numpy(), [1, 1, 1, 0, 0, 0])


def _batch(rng, b, size, vocab, t=7):
    ids = rng.integers(4, vocab, (b, t)).astype(np.int32)
    mask = np.ones((b, t), np.int32)
    mask[1, 4:] = 0
    ids[mask == 0] = 0
    images = rng.normal(size=(b, size, size, 3)).astype(np.float32)
    return ({"input_ids": jnp.asarray(ids), "attention_mask": jnp.asarray(mask),
             "images": jnp.asarray(images)},
            {"input_ids": torch.from_numpy(ids).long(), "attention_mask": torch.from_numpy(mask),
             "images": _nchw(images)})


def _perturbed(variables, rng):
    out = {"params": jax.tree.map(lambda x: np.asarray(x) + 0.05 * rng.normal(size=x.shape)
                                  .astype(np.float32), variables["params"])}
    if variables.get("batch_stats"):
        out["batch_stats"] = jax.tree.map(lambda x: rng.uniform(0.5, 1.5, x.shape)
                                          .astype(np.float32), variables["batch_stats"])
    return out


def _convirt(cnn, rng, size):
    kwargs = dict(encoder=dict(TINY_TRANSFORMER, vocab_size=40), cnn=dict(cnn),
                  projection={"projection_dim": 16},
                  loss={"proto": "ConVIRTLoss", "tau": 0.1, "lambda_": 0.75})
    jm = JConVIRT(**kwargs)
    jb, tb = _batch(rng, 4, size, 40)
    variables = _perturbed(jax.jit(jm.init_variables)(jax.random.key(0), jb), rng)
    tcnn = dict(cnn, image_size=size) if cnn["backbone"] == "vit" else dict(cnn)
    tm = TConVIRT(**dict(kwargs, cnn=tcnn), device="cpu")
    tm.module.load_state_dict(convirt_state_dict_from_jax(variables), strict=True)
    return jm, variables, tm, jb, tb


def _gloria(rng, size=64):
    kwargs = dict(encoder=dict(TINY_TRANSFORMER), cnn={"backbone": "resnet18",
                                                       "feature_dim": 16},
                  loss={"proto": "GLoRIALoss"})
    jm = JGLoRIA(**kwargs, dl=_DL())
    jb, tb = _batch(rng, 4, size, _Tok.vocab_size)
    variables = _perturbed(jax.jit(jm.init_variables)(jax.random.key(0), jb), rng)
    tm = TGLoRIA(**kwargs, dl=_DL(), device="cpu")
    tm.module.load_state_dict(gloria_state_dict_from_jax(variables), strict=True)
    return jm, variables, tm, jb, tb


@pytest.fixture(scope="module", params=["convirt-vit", "convirt-resnet", "gloria"])
def pair(request):
    """A JAX model with perturbed variables, the port's with the same, a
    batch for each, and the output keys to compare."""
    rng = np.random.default_rng(11)
    if request.param == "gloria":
        return (*_gloria(rng), ("global", "sent"))
    cnn = TINY_VIT if request.param == "convirt-vit" else TINY_RESNET
    return (*_convirt(cnn, rng, 32), ("linguistic", "visual"))


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_model_forward_and_loss_match_jax(pair, train):
    jm, variables, tm, jb, tb, keys = pair
    jout, _ = jm.apply_train(variables, jb, jax.random.key(1) if train else None, train=train)
    tout = tm.apply_train(tb, torch.Generator().manual_seed(0)) if train else tm.apply_eval(tb)
    np.testing.assert_allclose(float(tout["loss"].detach()), float(jout["loss"]), rtol=REL)
    for key in keys:
        _close(tout[key].detach().numpy(), jout[key])


def test_zero_shot_classification_matches_jax():
    """JAX's ``get_similarities`` runs its loss too, so it takes as many
    prompts as images: 4 each here."""
    rng = np.random.default_rng(12)
    jm, variables, tm, jb, tb = _gloria(rng)
    jm.variables = jax.tree.map(jnp.asarray, variables)
    prompts = {}
    for name in ("effusion", "normal", "pneumonia"):
        ids = rng.integers(4, _Tok.vocab_size, (4, 5)).astype(np.int32)
        prompts[name] = ids
    jp = {n: {"input_ids": jnp.asarray(v), "attention_mask": jnp.ones(v.shape, jnp.int32)}
          for n, v in prompts.items()}
    tp = {n: {"input_ids": torch.from_numpy(v).long(),
              "attention_mask": torch.ones(v.shape, dtype=torch.int32)}
          for n, v in prompts.items()}
    _close(tm.get_similarities(tb["images"], tp["normal"]["input_ids"],
                               tp["normal"]["attention_mask"]),
           jm.get_similarities(jb["images"], jp["normal"]["input_ids"],
                               jp["normal"]["attention_mask"]))
    assert tm.zero_shot_classification(tb["images"], tp) == \
        jm.zero_shot_classification(jb["images"], jp)


def test_convirt_freeze_keeps_the_tower_out_of_the_optimizer():
    from vilmedic_torch.executors.train_state import create_optimizer

    tm = TConVIRT(encoder=dict(TINY_TRANSFORMER, vocab_size=40), cnn=dict(TINY_RESNET, freeze=True),
                  projection={"projection_dim": 16}, forward_batch_size=2,
                  loss={"proto": "ConVIRTLoss", "tau": 0.1, "lambda_": 0.75}, device="cpu")
    assert tm.frozen_prefixes == ("visual/model",)
    tx = create_optimizer("RAdam", {"lr": 5e-5}, frozen_prefixes=tm.frozen_prefixes,
                          named_parameters=tm.module.named_parameters())
    tower = [n for n, _ in tm.module.named_parameters() if n.startswith("visual.model.")]
    assert tower and not any(n.startswith("visual.") for n in tx.names)
    assert any(n.startswith("vis_proj.") for n in tx.names)


@pytest.mark.parametrize("steps,error,match", [
    ([{"plot_representation": {"keys": ["visual"]}}], ImportError, "scikit-learn"),
    (["plot_attention"], ImportError, "matplotlib"),
    ([{"save_representation_of_nothing": None}], ValueError, "Unknown post-processing step")])
def test_post_processing_raises_before_any_run(steps, error, match, monkeypatch):
    """ConVIRT's ensemblor names ``plot_representation`` (scikit-learn,
    matplotlib): where they are not installed, the Validator refuses it
    when it is built, before any run, as it refuses an unknown step."""
    import importlib.util

    from vilmedic_torch.executors.validator import Validator

    real = importlib.util.find_spec
    monkeypatch.setattr(importlib.util, "find_spec",
                        lambda name, *a: None if name in ("sklearn", "matplotlib")
                        else real(name, *a))
    with pytest.raises(error, match=match):
        Validator({"post_processing": steps, "splits": []}, models=[])


# ---------------------------------------------------------------- the CLI

@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    """8 noise JPEGs of 80² and their reports, train = validate."""
    root = tmp_path_factory.mktemp("selfsup")
    rng = np.random.default_rng(0)
    paths = []
    for i in range(len(REPORTS)):
        p = root / f"im{i}.jpg"
        Image.fromarray(rng.integers(0, 255, (80, 80, 3), dtype=np.uint8)).save(p)
        paths.append(str(p))
    for split in ("train", "validate"):
        (root / f"{split}.image.tok").write_text("\n".join(paths))
        (root / f"{split}.report.tok").write_text("\n".join(REPORTS))
    return root


def _overrides(kind, root, ckpt_dir):
    """``config/SELFSUP/{kind}-mimic.yml`` cut down: width 32, 1 layer,
    dropout 0, resnet18, 72 / 64 images, batch 4 (2 steps), one epoch.
    Adam's eps 1 (GLoRIA): Adam turns the rounding noise of a ~0 gradient
    entry (BatchNorm biases whose gradients nearly cancel) into a full lr
    step of either sign, which would move the packages apart; RAdam's first
    steps are not normalized (ConVIRT)."""
    out = [f"ckpt_dir={ckpt_dir}", f"name={kind}", f"seed={SEED}", "model.dtype=float32",
           f"dataset.image.root={root}", f"dataset.seq.root={root}", "dataset.image.resize=72",
           "dataset.image.crop=64", "dataset.num_workers=0", "dataset.seq.tokenizer=null",
           "model.encoder.hidden_size=32", "model.encoder.num_hidden_layers=1",
           "model.encoder.num_attention_heads=4", "model.encoder.intermediate_size=64",
           "model.encoder.hidden_dropout_prob=0.0", "model.cnn.backbone=resnet18",
           "trainor.batch_size=4", "trainor.epochs=0", "validator.batch_size=4",
           "ensemblor.batch_size=4", "ensemblor.splits=[validate]"]
    if kind == "gloria":
        return out + ["model.cnn.feature_dim=16", "trainor.optim_params.eps=1.0"]
    return out + ["model.projection.projection_dim=16", "ensemblor.post_processing=null"]


def _config_file(kind, root, ckpt_dir, path):
    cfg, _ = load_config(f"config/SELFSUP/{kind}-mimic.yml", _overrides(kind, root, ckpt_dir))
    path.write_text(yaml.safe_dump(cfg.to_dict()))
    return str(path)


@pytest.fixture(scope="module", params=["convirt", "gloria"])
def runs(request, workdir, tmp_path_factory):
    kind = request.param
    bridge = convirt_state_dict_from_jax if kind == "convirt" else gloria_state_dict_from_jax
    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(REPO)  # the config files' paths
        empty = tmp_path_factory.mktemp("hf_cache")  # the encoder's name resolves nowhere
        mp.setenv("HF_HUB_CACHE", str(empty))
        mp.setattr(hf_hub, "TRANSFORMERS_CACHE", str(empty))
        jdir = tmp_path_factory.mktemp(f"jax_{kind}")
        config, _ = load_config(_config_file(kind, workdir, jdir, jdir / "config.yml"))
        train_config = executor_config(config, "trainor")
        val_config = executor_config(config, "validator")
        ckpt_dir = os.path.join(config.ckpt_dir, config.name)
        os.makedirs(ckpt_dir)
        train_config.ckpt_dir = val_config.ckpt_dir = ckpt_dir
        jset_logger(ckpt_dir, SEED)
        jtrainor = JTrainor(config=train_config, seed=SEED)
        jtrainor.dl.dataset.image.transform.rng = np.random.default_rng(SEED)
        jtrainor.evaluator = JValidator(config=val_config, models=[jtrainor.model],
                                        train_dl=jtrainor.dl, seed=SEED, from_training=True)
        initial = {k: v.numpy().copy() for k, v in bridge(
            jax.tree.map(np.asarray, dict(jtrainor.model.variables))).items()}
        jtrainor.start()

        class Seeded(TTrainor):
            def __init__(self, *args, **kwargs):
                super().__init__(*args, **kwargs)
                self.model.module.load_state_dict(
                    {k: torch.from_numpy(v) for k, v in initial.items()}, strict=True)

        tdir = tmp_path_factory.mktemp(f"torch_{kind}")
        mp.setattr(tcli, "Trainor", Seeded)
        tpath = _config_file(kind, workdir, tdir, tdir / "config.yml")
        ttrainor = tcli.main([tpath, "device=cpu"])
        yield dict(j=jtrainor, t=ttrainor, tpath=tpath)


def test_cli_epoch_matches_jax(runs):
    j, t = runs["j"], runs["t"]
    assert len(t.epoch_losses) == len(j.epoch_losses) == 1
    assert t.training_scheduler.iteration_count == 2
    np.testing.assert_allclose(t.epoch_losses, j.epoch_losses, rtol=REL)
    got, want = t.evaluator.scores[0], j.evaluator.scores[0]
    assert sorted(got) == sorted(want) == ["validation_loss"]
    np.testing.assert_allclose(got["validation_loss"], want["validation_loss"], rtol=REL)


def test_ensemble_cli_scores_the_run(runs):
    """The ensemble CLI over the run's best checkpoint: the run's
    validation loss, and the embeddings its eval function returns outside
    training."""
    from vilmedic_torch.bin.ensemble import main as ensemble_main
    from vilmedic_torch.models import selfsup

    kept = []
    real = runs["t"].model.eval_func

    def recorded(*args, **kwargs):
        out = real(*args, **kwargs)
        kept.append(dict(out))
        return out

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(selfsup, "gloria_evaluation", recorded)
        mp.setattr(selfsup, "convirt_evaluation", recorded)
        ens = ensemble_main([runs["tpath"], "device=cpu"])
    np.testing.assert_allclose(ens.scores[0]["validation_loss"],
                               runs["t"].evaluator.scores[0]["validation_loss"], rtol=REL)
    assert len(kept) == 1 and kept[0]["visual"].shape[0] == len(REPORTS)
    assert kept[0]["linguistic"].shape[0] == len(REPORTS)
