"""The VisionLanguage config through the port's normal entry points, against
the JAX package, on the CPU, float32.

``config/VL/vl-dinov2-modernbert.yml`` is cut to size by dotlist overrides:
its ``vision_model_name`` names a directory holding a tiny DINOv2
``config.json`` (written by ``transformers.Dinov2Config.save_pretrained``,
no weights: the tower keeps its random init in both packages, with the
JAX package's warning), a 1-layer decoder of width 64 (2 heads of 32),
hidden dropout 0, the corpus vocabulary (``dataset.seq.tokenizer=null``),
32² crops, batch 2 with ``grad_accu`` 2, one epoch, ``shard_eval`` off on
the JAX side. ``BERTSCORE_MODEL`` names a tiny BERT directory, so
``bertscore`` is scored in both. The JAX trainer's initial variables are
copied into the port's before training (``zoo/from_jax.py``).

Held: the repair (``create_model(config, dl)`` takes the tokenizer's
vocabulary and special ids, as the JAX package does; the parent ignored the
loader); ``_resolve_hf_config`` of a DINOv2 directory against
``AutoConfig``; the train CLI's epoch loss (1e-5), the Validator's hyps
at beam 2 (equal) and scores (BLEU / ROUGEL 1e-12, bertscore 1e-5); greedy
hyps through both ``vl_evaluation``; the ensemble CLI's hyps at beam 8 on
both splits; one unfrozen-DINOv2 training step (``VisualEncoder``, flash
attention with its backward in the tower) and one VisionLanguage step with
``freeze: false``; and the trainer keys ``eval_only``, ``save_every_epoch``
and ``profile_dir`` against the JAX trainer's.
"""

import glob
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from PIL import Image

import vilmedic_torch.bin.ensemble as tens
import vilmedic_torch.bin.train as tcli
import vilmedic_torch.ops.attention as tattn
import vilmedic_tpu.ops.attention as jattn
from vilmedic_torch.config.config import Config as TConfig
from vilmedic_torch.executors import Trainor as TTrainor
from vilmedic_torch.zoo.from_jax import rrg_state_dict_from_jax, vl_state_dict_from_jax
from vilmedic_tpu.config.config import Config as JConfig
from vilmedic_tpu.config.config import executor_config, load_config
from vilmedic_tpu.executors import Trainor as JTrainor
from vilmedic_tpu.executors import Validator as JValidator
from vilmedic_tpu.utils import set_logger as jset_logger

REPORTS = ["no acute disease .", "lungs are clear .", "heart size is normal .",
           "small pleural effusion .", "mild cardiomegaly .", "no evidence of pneumonia ."]
SEED = 717171
TOL_LOSS, TOL_SCORE, TOL_BERTSCORE = 1e-5, 1e-12, 1e-5
DINO = dict(hidden_size=64, num_hidden_layers=1, num_attention_heads=2, mlp_ratio=2,
            patch_size=8, image_size=32)
WORDS = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", "no", "acute", "disease", ".",
         "lungs", "are", "clear", "heart", "size", "is", "normal"]


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    """The corpus (JPEGs and reports of three splits), the DINOv2 config
    directory and a tiny BERT directory for bertscore."""
    from transformers import BertConfig, BertModel, BertTokenizer, Dinov2Config

    root = tmp_path_factory.mktemp("vl_cli")
    rng = np.random.default_rng(0)
    paths = []
    for i in range(len(REPORTS)):
        p = root / f"im{i}.jpg"
        Image.fromarray(rng.integers(0, 255, (40, 40, 3), dtype=np.uint8)).save(p)
        paths.append(str(p))
    for split in ("train", "validate", "test"):
        (root / f"{split}.report.tok").write_text("\n".join(REPORTS))
        (root / f"{split}.image.tok").write_text("\n".join(paths))
    Dinov2Config(**DINO).save_pretrained(root / "dinov2")
    bert = root / "bert"
    bert.mkdir()
    (bert / "vocab.txt").write_text("\n".join(WORDS))
    BertTokenizer(vocab_file=str(bert / "vocab.txt")).save_pretrained(bert)
    torch.manual_seed(0)
    BertModel(BertConfig(vocab_size=len(WORDS), hidden_size=16, num_hidden_layers=2,
                         num_attention_heads=2, intermediate_size=32,
                         max_position_embeddings=32)).save_pretrained(bert)
    return root


def _overrides(root, ckpt_dir, extra=()):
    return [
        f"ckpt_dir={ckpt_dir}", "name=vl", f"seed={SEED}", "model.dtype=float32",
        f"dataset.seq.root={root}", "dataset.seq.file=report.tok", "dataset.seq.tokenizer=null",
        "dataset.seq.tokenizer_max_len=10", f"dataset.image.root={root}",
        "dataset.image.file=image.tok", "dataset.image.resize=36", "dataset.image.crop=32",
        "dataset.num_workers=0", f"model.vision.vision_model_name={root / 'dinov2'}",
        "model.vision.image_size=32", "model.decoder.hidden_size=64",
        "model.decoder.num_attention_heads=2", "model.decoder.num_hidden_layers=1",
        "model.decoder.intermediate_size=64", "model.decoder.max_position_embeddings=64",
        "model.decoder.hidden_dropout_prob=0.0", "trainor.batch_size=2", "trainor.grad_accu=2",
        "trainor.epochs=1", "trainor.optim_params.lr=0.001", "validator.batch_size=2",
        "validator.shard_eval=false", "ensemblor.batch_size=2", "ensemblor.shard_eval=false",
        *extra,
    ]


def _config_file(root, ckpt_dir, extra=()):
    config, _ = load_config("config/VL/vl-dinov2-modernbert.yml",
                            _overrides(root, ckpt_dir, extra))
    path = os.path.join(str(ckpt_dir), "config.yml")
    with open(path, "w") as f:
        f.write(yaml.safe_dump(config.to_dict()))
    return path


def _hyps(folder, split):
    return open(os.path.join(folder, f"{split}_{SEED}_hyps.txt")).read()


def _jax_trainor(config_path, **keys):
    """The JAX package's Trainor and Validator as its train CLI builds them,
    with the training crops seeded; ``keys`` set on the trainor view."""
    config, _ = load_config(config_path)
    train_config = executor_config(config, "trainor")
    val_config = executor_config(config, "validator")
    ckpt_dir = os.path.join(config.ckpt_dir, config.name)
    os.makedirs(ckpt_dir, exist_ok=True)
    train_config.ckpt_dir = val_config.ckpt_dir = ckpt_dir
    for key, value in keys.items():
        setattr(train_config, key, value)
    jset_logger(ckpt_dir, SEED)
    jtrainor = JTrainor(config=train_config, seed=SEED)
    jtrainor.dl.dataset.image.transform.rng = np.random.default_rng(SEED)
    jtrainor.evaluator = JValidator(config=val_config, models=[jtrainor.model],
                                    train_dl=jtrainor.dl, seed=SEED, from_training=True)
    return jtrainor, ckpt_dir


def _seeded_trainor(jtrainor):
    """The port's Trainor, started from the JAX trainer's initial weights."""
    initial = {k: torch.from_numpy(np.array(v)) for k, v in vl_state_dict_from_jax(
        {"params": jtrainor.model.variables["params"]}).items()}

    class Seeded(TTrainor):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            self.model.module.load_state_dict(initial, strict=True)

    return Seeded


@pytest.fixture(scope="module")
def runs(workdir, tmp_path_factory):
    """The train CLI, then the ensemble CLI, in both packages."""
    import bin_tpu.ensemble as jens

    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("BERTSCORE_MODEL", str(workdir / "bert"))
        mp.delenv("BERTSCORE_BASELINE", raising=False)
        jdir = tmp_path_factory.mktemp("jax_ckpt")
        jtrainor, ckpt_dir = _jax_trainor(_config_file(workdir, jdir))
        mp.setattr(tcli, "Trainor", _seeded_trainor(jtrainor))
        jtrainor.start()
        jval = _hyps(ckpt_dir, "validate")
        jens.main([_config_file(workdir, jdir)])
        jens_hyps = {s: _hyps(ckpt_dir, s) for s in ("validate", "test")}

        tdir = tmp_path_factory.mktemp("torch_ckpt")
        ttrainor = tcli.main([_config_file(workdir, tdir), "device=cpu"])
        trun = os.path.join(str(tdir), "vl")
        tval = _hyps(trun, "validate")
        tvalidator = tens.main([_config_file(workdir, tdir), "device=cpu"])
        tens_hyps = {s: _hyps(trun, s) for s in ("validate", "test")}
    # the patches end here: the module's other tests see the real Trainor
    return dict(j=jtrainor, t=ttrainor, jval=jval, tval=tval, jens=jens_hyps, tens=tens_hyps,
                tens_validator=tvalidator)


def test_vl_takes_the_loaders_tokenizer(workdir, tmp_path):
    """The repair: ``create_model(config, dl)`` builds the decoder with the
    tokenizer's vocabulary and [CLS] / [SEP] / [PAD] as BOS / EOS / PAD, as
    the JAX package's ``VisionLanguage(dl=...)`` does, and registers its
    ``eval_func``; explicit keywords still win."""
    from vilmedic_torch.executors.utils import create_data_loader, create_model
    from vilmedic_torch.models.vision_language import vl_evaluation
    from vilmedic_tpu.models.vision_language import VisionLanguage as JVL

    config, _ = load_config("config/VL/vl-dinov2-modernbert.yml",
                            _overrides(workdir, tmp_path))
    train_config = executor_config(config, "trainor")
    train_config.ckpt_dir = str(tmp_path)
    tconfig = TConfig(train_config.to_dict())
    dl = create_data_loader(tconfig, "train", seed=SEED)
    tok = dl.dataset.tokenizer
    model_cfg = train_config.model.to_dict()
    model_cfg.pop("proto")
    jmodel = JVL(**model_cfg, dl=dl)
    model = create_model(tconfig, dl=dl, device="cpu")
    want = (tok.vocab_size, tok.cls_token_id, tok.sep_token_id, tok.pad_token_id)
    for cfg in (model.dec_config, jmodel.dec_config):
        assert (cfg.vocab_size, cfg.bos_token_id, cfg.eos_token_id, cfg.pad_token_id) == want
    assert model.module.lm_head.weight.shape[0] == tok.vocab_size
    assert model.eval_func is vl_evaluation
    model = create_model(tconfig, dl=dl, device="cpu", vocab_size=97, bos_token_id=5)
    assert (model.dec_config.vocab_size, model.dec_config.bos_token_id,
            model.dec_config.eos_token_id) == (97, 5, tok.sep_token_id)


def test_resolve_dinov2_directory_matches_autoconfig(tmp_path):
    from transformers import AutoConfig, Dinov2Config

    from vilmedic_torch.models.hf_compat import _resolve_hf_config

    Dinov2Config(hidden_size=48, num_attention_heads=3, use_swiglu_ffn=True,
                 image_size=518).save_pretrained(tmp_path)
    want = AutoConfig.from_pretrained(str(tmp_path), local_files_only=True).to_dict()
    got = _resolve_hf_config(str(tmp_path))
    keys = ("hidden_size", "num_hidden_layers", "num_attention_heads", "mlp_ratio",
            "patch_size", "layer_norm_eps", "use_swiglu_ffn", "hidden_act", "image_size",
            "hidden_dropout_prob", "model_type")
    assert {k: got[k] for k in keys} == {k: want[k] for k in keys}
    # the tower takes those keys; weights beside the config are recorded for
    # base.load_pretrained (tests/test_torch_zoo.py loads them)
    from vilmedic_torch.models.vision_language import VisionLanguage

    decoder = dict(proto=None, hidden_size=48, num_hidden_layers=1, num_attention_heads=3,
                   intermediate_size=64, max_position_embeddings=1400)
    model = VisionLanguage(decoder=decoder, vision={"vision_model_name": str(tmp_path)},
                           vocab_size=30, device="cpu")
    tower = model.module.vision.model
    assert tower.config.hidden_size == 48 and model.module.num_image_tokens == 37 * 37 + 1
    assert type(tower.layer_0.ffn).__name__ == "SwiGLUFFN"
    (tmp_path / "model.safetensors").write_bytes(b"")
    model = VisionLanguage(decoder=decoder, vision={"vision_model_name": str(tmp_path)},
                           vocab_size=30, device="cpu")
    assert model.pretrained_blocks == {"vision": (str(tmp_path), "dinov2")}


def test_cli_training_and_validator_match_jax(runs):
    j, t = runs["j"], runs["t"]
    assert type(t.model).__name__ == "VisionLanguage" and t.model.module.drop_cls_token
    assert t.model.dec_config.vocab_size == j.model.dec_config.vocab_size
    assert t.training_scheduler.iteration_count == j.training_scheduler.iteration_count > 0
    np.testing.assert_allclose(t.epoch_losses, j.epoch_losses, rtol=TOL_LOSS, atol=TOL_LOSS)
    assert runs["tval"] == runs["jval"]
    want, got = j.evaluator.scores[0], t.evaluator.scores[0]
    assert sorted(got) == sorted(want) == ["BLEU", "ROUGEL", "bertscore", "validation_loss"]
    for key, tol in (("BLEU", TOL_SCORE), ("ROUGEL", TOL_SCORE),
                     ("bertscore", TOL_BERTSCORE)):
        assert got[key] is not None
        np.testing.assert_allclose(got[key], want[key], rtol=0, atol=tol)


def test_greedy_hyps_match_jax(runs):
    from vilmedic_torch.models.vision_language import vl_evaluation as tvl_evaluation
    from vilmedic_tpu.models.vision_language import vl_evaluation as jvl_evaluation

    j, t = runs["j"], runs["t"]
    want = jvl_evaluation([j.model], JConfig({"beam_width": 1, "shard_eval": False}),
                          j.evaluator.splits[0][1])
    got = tvl_evaluation([t.model], TConfig({"beam_width": 1}), t.evaluator.splits[0][1])
    assert got["hyps"] == want["hyps"] and got["refs"] == want["refs"]


def test_ensemble_cli_matches_jax(runs):
    validator = runs["tens_validator"]
    assert validator.config.beam_width == 8 and len(validator.models) == 1
    assert [s for s, _ in validator.splits] == ["validate", "test"]
    assert runs["tens"] == runs["jens"]


def test_unfrozen_dinov2_step_matches_jax(monkeypatch):
    """One training step of an unfrozen DINOv2 tower through
    ``VisualEncoder`` (the JAX package trains it there): the loss of a fixed
    projection of its tokens, every parameter's gradient (the tower's 17
    tokens take the flash forward with LSE and the flash backward, non-causal,
    in both packages) and one AdamW update."""
    from vilmedic_torch.blocks.vision.visual_encoder import build_visual_encoder as tbuild
    from vilmedic_torch.executors.train_state import create_optimizer, gated_update
    from vilmedic_tpu.blocks.vision.visual_encoder import build_visual_encoder as jbuild
    from vilmedic_tpu.executors import train_state as jts

    for mod in (jattn, tattn):
        monkeypatch.setattr(mod, "FLASH_MIN_LEN_TRAIN", 16)
    block = dict(backbone="dinov2", freeze=False, permute="no_permute", hidden_size=64,
                 num_hidden_layers=2, num_attention_heads=2, mlp_ratio=2.0, patch_size=8,
                 image_size=32, hidden_dropout_prob=0.0)
    rng = np.random.default_rng(4)
    images = rng.normal(size=(2, 32, 32, 3)).astype(np.float32)
    proj = rng.normal(size=(2, 17, 64)).astype(np.float32)
    jenc = jbuild(dict(block))
    variables = jax.jit(jenc.init)(jax.random.key(0), jnp.asarray(images))
    params = jax.tree.map(lambda x: np.asarray(x) + 0.05 * rng.normal(size=x.shape)
                          .astype(np.float32), variables["params"])

    def jloss(p):
        out = jenc.apply({"params": p}, jnp.asarray(images), train=True,
                         rngs={"dropout": jax.random.key(1)})
        return jnp.sum(out * proj)

    loss_j, grads_j = jax.value_and_grad(jloss)(params)
    lr = 1e-3
    tx = jts.create_optimizer("adamw", {"lr": lr}, None)
    new_j, _ = jts.gated_update(tx, params, tx.init(params), grads_j, lr, loss_j)

    tenc = tbuild(dict(block))
    tenc.load_state_dict(rrg_state_dict_from_jax({"params": params}), strict=True)
    assert all(p.dtype == torch.float32 for p in tenc.parameters())
    calls = []
    real = tattn.flash_attention

    def counting(*args, **kwargs):
        out = real(*args, **kwargs)
        calls.append((type(out.grad_fn).__name__, kwargs.get("causal")))
        return out

    monkeypatch.setattr(tattn, "flash_attention", counting)
    x = torch.from_numpy(np.ascontiguousarray(images.transpose(0, 3, 1, 2)))
    loss_t = (tenc(x, train=True, generator=torch.Generator().manual_seed(0))
              * torch.from_numpy(proj)).sum()
    loss_t.backward()
    assert len(calls) == 2 and all(c == ("FlashAttentionFunctionBackward", False)
                                   or c[0].startswith("FlashAttention") for c in calls)
    np.testing.assert_allclose(loss_t.item(), float(loss_j), rtol=1e-5)
    want = rrg_state_dict_from_jax({"params": jax.tree.map(np.asarray, grads_j)})
    named = dict(tenc.named_parameters())
    for name, g in want.items():
        scale = float(g.abs().max())
        if name.endswith("self_attn.k.bias"):  # 0 up to rounding: softmax is shift-invariant
            scale = float(want[name.replace("bias", "weight")].abs().max())
        np.testing.assert_allclose(named[name].grad.numpy(), g.numpy(), rtol=0,
                                   atol=1e-4 * scale)
    ttx = create_optimizer("adamw", {"lr": lr}, None, named_parameters=tenc.named_parameters())
    assert gated_update(ttx, lr, loss_t.detach())
    new = rrg_state_dict_from_jax({"params": jax.tree.map(np.asarray, new_j)})
    for name, w in new.items():
        if name.endswith("self_attn.k.bias"):  # Adam's first step is lr * sign(noise) there
            continue
        np.testing.assert_allclose(named[name].detach().numpy(), w.numpy(), rtol=0,
                                   atol=0.1 * lr)


def test_vl_unfrozen_tower_moves_only_by_weight_decay_as_jax(workdir, runs, tmp_path):
    """``vision.freeze: false`` in VisionLanguage: the tower joins the
    optimizer, but the prefix takes no gradient through it in either package
    (the JAX module's ``stop_gradient``), so one AdamW update moves it by the
    decay alone, as optax does."""
    j = runs["j"]
    cfg = {**j.config.model.to_dict()}
    cfg["vision"] = {**cfg["vision"], "freeze": False}
    t = runs["t"]
    from vilmedic_torch import registry as tregistry
    from vilmedic_tpu import registry as jregistry

    jmodel = jregistry.build("model", JConfig(cfg), dl=j.dl)
    assert jmodel.frozen_prefixes == ()
    tmodel = tregistry.build("model", TConfig(cfg), dl=t.dl, device="cpu")
    assert tmodel.frozen_prefixes == ()
    params = jax.tree.map(np.asarray, j.model.variables["params"])
    tmodel.module.load_state_dict(vl_state_dict_from_jax({"params": params}), strict=True)
    batch = next(iter(t.dl))
    tbatch = {k: batch[k] for k in ("images", "input_ids", "attention_mask")}
    jbatch = {"images": jnp.asarray(batch["images"].numpy().transpose(0, 2, 3, 1)),
              "input_ids": jnp.asarray(batch["input_ids"].numpy()),
              "attention_mask": jnp.asarray(batch["attention_mask"].numpy())}
    from vilmedic_torch.executors.train_state import create_optimizer, gated_update
    from vilmedic_tpu.executors import train_state as jts

    lr = 1e-3

    def loss_fn(p):
        return jmodel.apply_train({"params": p}, jbatch, None, train=True)[0]["loss"]

    loss_j, grads_j = jax.value_and_grad(loss_fn)(params)
    assert all(float(jnp.abs(g).max()) == 0 for g in jax.tree.leaves(grads_j["vision"]))
    tx = jts.create_optimizer("adamw", {"lr": lr}, None, frozen_prefixes=())
    new_j, _ = jts.gated_update(tx, params, tx.init(params), grads_j, lr, loss_j)
    loss_t = tmodel.apply_train(tbatch)["loss"]
    loss_t.backward()
    np.testing.assert_allclose(loss_t.item(), float(loss_j), rtol=1e-5)
    ttx = create_optimizer("adamw", {"lr": lr}, None, (),
                           named_parameters=tmodel.module.named_parameters())
    assert any(n.startswith("vision.") for n in ttx.names)
    assert gated_update(ttx, lr, loss_t.detach())
    new = vl_state_dict_from_jax({"params": jax.tree.map(np.asarray, new_j)})
    old = vl_state_dict_from_jax({"params": params})
    named = dict(tmodel.module.named_parameters())
    for name, w in new.items():
        if name.startswith("vision."):
            np.testing.assert_allclose(named[name].detach().numpy(), w.numpy(), rtol=1e-6,
                                       atol=1e-9)
            assert not np.array_equal(w.numpy(), old[name].numpy()) or not old[name].any()


def test_trainor_keys_save_every_epoch_profile_dir_eval_only(workdir, tmp_path, monkeypatch):
    """``save_every_epoch``, ``profile_dir`` and ``eval_only`` in both
    packages, from the same initial weights (batch 1, BLEU at beam 1):
    the same epochs and iterations, epoch losses (1e-5) and validation BLEU
    (1e-12); ``epoch_{e}_{seed}.ckpt`` files of the same names, each holding
    the port's live weights and the JAX payload's keys; a Chrome trace in
    each ``profile_dir`` (the port's over exactly iterations 3 to 5); and
    ``eval_only`` from each package's best checkpoint: no update, the same
    hyps and BLEU as the JAX package's, and the best epoch's BLEU."""
    import gzip

    from vilmedic_torch.executors.checkpoint import load_checkpoint
    from vilmedic_tpu.executors.checkpoint import load_checkpoint as jload_checkpoint

    monkeypatch.setenv("BERTSCORE_MODEL", str(tmp_path / "none"))
    keys = ("trainor.batch_size=1", "trainor.grad_accu=1", "trainor.save_every_epoch=true",
            "trainor.early_stop_metric=BLEU", "validator.metrics=[BLEU]",
            "validator.beam_width=1")
    jdir, tdir = tmp_path / "jax", tmp_path / "torch"
    jdir.mkdir()
    tdir.mkdir()
    jtrainor, jrun = _jax_trainor(
        _config_file(workdir, jdir, (*keys, f"trainor.profile_dir={jdir}/prof")))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tcli, "Trainor", _seeded_trainor(jtrainor))
        jtrainor.start()
        config = _config_file(workdir, tdir, (*keys, f"trainor.profile_dir={tdir}/prof"))
        trainor = tcli.main([config, "device=cpu"])
    trun = tdir / "vl"

    # epochs 1 runs epochs 0 and 1 in both loops
    assert (trainor.training_scheduler.iteration_count
            == jtrainor.training_scheduler.iteration_count == 2 * len(REPORTS))
    np.testing.assert_allclose(trainor.epoch_losses, jtrainor.epoch_losses, rtol=TOL_LOSS,
                               atol=TOL_LOSS)
    np.testing.assert_allclose(trainor.training_scheduler.current_best_metric,
                               jtrainor.training_scheduler.current_best_metric, rtol=0,
                               atol=TOL_SCORE)
    names = {run: sorted(os.path.basename(p) for p in glob.glob(os.path.join(run, "epoch_*.ckpt")))
             for run in (jrun, str(trun))}
    assert names[jrun] == names[str(trun)] == [f"epoch_1_{SEED}.ckpt", f"epoch_2_{SEED}.ckpt"]
    assert len(glob.glob(str(trun / "*.ckpt"))) == len(glob.glob(f"{jrun}/*.ckpt")) == 3
    state = load_checkpoint(str(trun / f"epoch_2_{SEED}.ckpt"))
    jstate = jload_checkpoint(os.path.join(jrun, f"epoch_2_{SEED}.ckpt"))
    assert sorted(state) == sorted(jstate) == ["__version__", "config", "model", "opt_state",
                                               "training_scheduler"]
    for name, value in trainor.model.module.state_dict().items():
        assert torch.equal(state["model"][name], value)

    # the port's trace holds the profiler steps of iterations 3, 4 and 5
    trace = json.loads((tdir / "prof" / f"trace_{SEED}.json").read_text())
    steps = {e["name"] for e in trace["traceEvents"]
             if e.get("name", "").startswith("ProfilerStep")}
    assert steps == {"ProfilerStep#2", "ProfilerStep#3", "ProfilerStep#4"}
    (jtrace,) = glob.glob(f"{jdir}/prof/plugins/profile/*/*.trace.json.gz")
    assert json.loads(gzip.open(jtrace).read())["traceEvents"]

    # eval_only from each package's best checkpoint (the epoch files' names
    # carry no tag to resume from, in either package)
    def best(run):
        (path,) = [p for p in glob.glob(os.path.join(run, "*.ckpt")) if "epoch_" not in p]
        return path

    evals = {}
    for pkg, run in (("jax", jrun), ("torch", str(trun))):
        folder = tmp_path / f"eval_{pkg}"
        folder.mkdir()
        config = _config_file(workdir, folder, (*keys[:2], "trainor.eval_only=true",
                                                f"trainor.ckpt={best(run)}", *keys[-3:]))
        if pkg == "jax":
            evaluated, _ = _jax_trainor(config)
            evaluated.start()
        else:
            evaluated = tcli.main([config, "device=cpu"])
        evals[pkg] = (evaluated, _hyps(folder / "vl", "validate"))
    (jeval, jhyps), (teval, thyps) = evals["jax"], evals["torch"]
    assert thyps == jhyps
    np.testing.assert_allclose(teval.evaluator.scores[0]["BLEU"],
                               jeval.evaluator.scores[0]["BLEU"], rtol=0, atol=TOL_SCORE)
    np.testing.assert_allclose(teval.evaluator.scores[0]["BLEU"],
                               trainor.training_scheduler.current_best_metric, rtol=1e-12)
    # no update: the scheduler and the weights are the checkpoint's
    best_state = load_checkpoint(best(str(trun)))
    assert teval.training_scheduler.state_dict() == best_state["training_scheduler"]
    assert (jeval.training_scheduler.state_dict()
            == jload_checkpoint(best(jrun))["training_scheduler"])
    for name, value in teval.model.module.state_dict().items():
        assert torch.equal(value, best_state["model"][name])
