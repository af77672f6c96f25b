"""RRS (findings -> impression) of the PyTorch port against the JAX package,
on the CPU, float32.

- ``TransformerEncoder`` and ``RRSModule`` forward: logits and loss within
  1e-5 of the Flax modules from the same weights (``rrs_state_dict_from_jax``);
- beam-8 sequences of ``make_generate_fn`` over an RRS's
  ``encoder_inputs`` equal to JAX's, at a target vocabulary of 300 (plain
  head, two-stage candidates) and 4500 (blocked-stats head; the JAX
  package's Pallas kernels in interpret mode);
- ``Seq2Seq`` batches equal to JAX's (``vocab.src``/``vocab.tgt`` built
  from the corpus, the target as ``decoder_input_ids``);
- the train CLI (``python -m vilmedic_torch.bin.train``, its ``main``) on
  ``config/RRS/baseline-transformer-mimic.yml`` cut down by dotlist
  overrides to the fixture of ``tests/test_rrs_e2e.py`` (8 findings /
  impression pairs, 1-layer encoder and decoder of width 32, dropout 0,
  float32, RAdam, 2 epochs of one step, beam 2, ROUGEL/BLEU) against the
  JAX package's ``Trainor`` + ``Validator`` from the same initial weights:
  epoch losses within 1e-5, equal hypotheses, scores within 1e-12.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vilmedic_torch.bin.train as tcli
from vilmedic_torch.blocks.transformer import TransformerConfig as TConfig
from vilmedic_torch.blocks.transformer import TransformerEncoder as TEncoder
from vilmedic_torch.data.composites import Seq2Seq as TSeq2Seq
from vilmedic_torch.executors import Trainor as TTrainor
from vilmedic_torch.models import evaluation_nlg as teval
from vilmedic_torch.models.rrs import RRS as TRRS
from vilmedic_torch.zoo.from_jax import rrs_state_dict_from_jax
from vilmedic_tpu.blocks.transformer import TransformerConfig as JConfig
from vilmedic_tpu.blocks.transformer import TransformerEncoder as JEncoder
from vilmedic_tpu.config.config import executor_config, load_config
from vilmedic_tpu.data.composites import Seq2Seq as JSeq2Seq
from vilmedic_tpu.decoding.decode import BeamResult as JBeamResult
from vilmedic_tpu.decoding.decode import beam_search as jax_beam_search
from vilmedic_tpu.executors import Trainor as JTrainor
from vilmedic_tpu.executors import Validator as JValidator
from vilmedic_tpu.models import evaluation_nlg as jeval
from vilmedic_tpu.models.rrs import RRS as JRRS
from vilmedic_tpu.utils import set_logger as jset_logger

FINDINGS = [
    "the lungs are well expanded and clear without focal consolidation .",
    "heart size is mildly enlarged with tortuous aorta .",
    "there is a small left pleural effusion with adjacent atelectasis .",
    "no pneumothorax or pleural effusion is identified .",
    "the cardiomediastinal silhouette is within normal limits .",
    "patchy opacity in the right lower lobe may reflect pneumonia .",
    "lungs are clear without effusion .",
    "stable cardiomegaly without edema .",
]
IMPRESSIONS = ["no acute disease .", "cardiomegaly .", "small left effusion .",
               "no pneumothorax .", "normal heart .", "possible pneumonia .", "clear lungs .",
               "stable cardiomegaly ."]
BOS, EOS, PAD = 0, 2, 1
SEED = 818181
TOL, TOL_SCORE = 1e-5, 1e-12


def _block(vocab, layers=2, heads=2):
    return dict(proto=None, hidden_size=64, num_hidden_layers=layers, num_attention_heads=heads,
                intermediate_size=128, max_position_embeddings=32, layer_norm_eps=1e-5,
                hidden_dropout_prob=0.0, vocab_size=vocab)


def _models(src_vocab, tgt_vocab, rng, scale=0.3, eos_bias=0.0):
    """A JAX RRS with weights perturbed by N(0, scale) and the port's RRS
    carrying them. The beam checks take a large perturbation, a head scaled
    up and ``eos_bias`` on EOS's logit, so that some hypotheses finish
    early; the forward check takes weights at the scale of a trained
    model, where f32 sums stay within its tolerance."""
    enc, dec = _block(src_vocab), dict(_block(tgt_vocab), bos_token_id=BOS, eos_token_id=EOS,
                                       pad_token_id=PAD)
    jmodel = JRRS(encoder=dict(enc), decoder=dict(dec), dtype="float32")
    ids = jnp.ones((2, 6), jnp.int32)
    v = jax.jit(lambda k: jmodel.module.init(k, ids, ids, ids, ids))(jax.random.key(0))
    params = jax.tree.map(lambda x: np.asarray(x) + scale * rng.normal(size=x.shape).astype(
        np.float32), v["params"])
    if scale > 0.1:
        params["dec"]["lm_head"]["kernel"] *= 2.0
        params["dec"]["lm_head"]["kernel"][:, EOS] *= 3.0
    params["dec"]["lm_head"]["bias"][EOS] += eos_bias
    variables = {"params": params}
    tmodel = TRRS(encoder=dict(enc), decoder=dict(dec), dtype="float32", device="cpu")
    tmodel.module.load_state_dict(rrs_state_dict_from_jax(variables), strict=True)
    return jmodel, variables, tmodel


def _src(rng, b, t, vocab):
    ids = rng.integers(5, vocab, (b, t)).astype(np.int32)
    mask = np.ones((b, t), np.int32)
    mask[1, t - 3:] = 0
    ids[1, t - 3:] = PAD
    return ids, mask


def test_encoder_matches_jax():
    rng = np.random.default_rng(0)
    cfg = dict(_block(97), num_hidden_layers=2)
    jenc = JEncoder(JConfig(**{k: v for k, v in cfg.items() if k != "proto"}))
    ids, mask = _src(rng, 3, 11, 97)
    v = jenc.init(jax.random.key(1), jnp.asarray(ids), jnp.asarray(mask))
    params = jax.tree.map(lambda x: np.asarray(x) + 0.1 * rng.normal(size=x.shape).astype(
        np.float32), v["params"])
    want = np.asarray(jenc.apply({"params": params}, jnp.asarray(ids), jnp.asarray(mask)))
    tenc = TEncoder(TConfig.from_dict(cfg))
    tenc.load_state_dict(rrs_state_dict_from_jax({"params": params}), strict=True)
    got = tenc(torch.from_numpy(ids).long(), torch.from_numpy(mask).long())
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=TOL, atol=TOL)
    assert [n for n, _ in tenc.named_parameters()][:3] == [
        "embeddings.word_embeddings.weight", "embeddings.position_embeddings.weight",
        "embeddings.ln.weight"]


def test_rrs_forward_matches_jax():
    rng = np.random.default_rng(1)
    jmodel, variables, tmodel = _models(97, 300, rng, scale=0.05)
    ids, mask = _src(rng, 3, 11, 97)
    dec_ids = rng.integers(5, 300, (3, 7)).astype(np.int32)
    dec_ids[:, 0] = BOS
    dec_mask = np.ones((3, 7), np.int32)
    dec_mask[2, 4:] = 0
    want = jmodel.module.apply(variables, *(jnp.asarray(x) for x in (ids, mask, dec_ids,
                                                                     dec_mask)))
    got = tmodel.module(*(torch.from_numpy(x).long() for x in (ids, mask, dec_ids, dec_mask)))
    np.testing.assert_allclose(got["logits"].detach().numpy(), np.asarray(want["logits"]),
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got["loss"].item(), float(want["loss"]), rtol=TOL, atol=TOL)


def _beam_search_with_scores(*args, **kwargs):
    r = jax_beam_search(*args, **kwargs)
    return JBeamResult((r.sequences, r.scores), r.scores)


@pytest.mark.parametrize("vocab,eos_bias", [(300, 12.0), (4500, 16.0)])
def test_rrs_beam_sequences_match_jax(vocab, eos_bias, monkeypatch):
    """Beam 8 over 2 findings, max_len 10: K1's plain version (the
    never-permuted cache) and, at 4500, the blocked-stats head's."""
    rng = np.random.default_rng(2)
    jmodel, variables, tmodel = _models(97, vocab, rng, eos_bias=eos_bias)
    ids, mask = _src(rng, 2, 9, 97)
    monkeypatch.setattr(jeval, "beam_search", _beam_search_with_scores)
    monkeypatch.setenv("VILMEDIC_LMHEAD_KERNEL", "1")
    seqs_j, scores_j = jeval.make_generate_fn([jmodel], 8, 10, BOS, EOS, PAD, 1.0)(
        [variables], {"input_ids": jnp.asarray(ids), "attention_mask": jnp.asarray(mask)})
    generate = teval.make_generate_fn([tmodel], 8, 10, BOS, EOS, PAD, 1.0)
    got = generate(tmodel.encoder_inputs({"input_ids": torch.from_numpy(ids).long(),
                                          "attention_mask": torch.from_numpy(mask).long()}))
    np.testing.assert_array_equal(got.sequences.numpy(), np.asarray(seqs_j))
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(scores_j), rtol=1e-4, atol=1e-4)
    assert (np.asarray(seqs_j)[:, 1:-1] == EOS).any()  # a hypothesis ended early


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    root = tmp_path_factory.mktemp("rrs")
    for split in ("train", "validate"):
        (root / f"{split}.findings.tok").write_text("\n".join(FINDINGS))
        (root / f"{split}.impression.tok").write_text("\n".join(IMPRESSIONS))
    return root


def test_seq2seq_batches_match_jax(workdir, tmp_path):
    kw = dict(src={"root": str(workdir), "file": "findings.tok", "tokenizer_max_len": 24,
                   "processing": "ifcc_clean_report"},
              tgt={"root": str(workdir), "file": "impression.tok", "tokenizer_max_len": 8,
                   "processing": "ifcc_clean_report"})
    (tmp_path / "j").mkdir()
    (tmp_path / "t").mkdir()
    jds = JSeq2Seq(split="train", ckpt_dir=str(tmp_path / "j"), **kw)
    tds = TSeq2Seq(split="train", ckpt_dir=str(tmp_path / "t"), **kw)
    for name in ("vocab.src", "vocab.tgt"):
        assert (tmp_path / "t" / name).read_text() == (tmp_path / "j" / name).read_text()
    items = [tds[i] for i in range(5)]
    assert items == [jds[i] for i in range(5)]
    want = jds.get_collate_fn()(items)
    got = tds.get_collate_fn()(items)
    assert sorted(got) == sorted(want) == ["attention_mask", "decoder_attention_mask",
                                           "decoder_input_ids", "input_ids"]
    for key in want:
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]))
    assert tds.tgt_tokenizer_max_len == 8 and tds.tgt_tokenizer.vocab_size == len(
        (tmp_path / "t" / "vocab.tgt").read_text().split("\n"))


def _overrides(root, ckpt_dir):
    block = ["hidden_size=32", "num_hidden_layers=1", "num_attention_heads=4",
             "intermediate_size=64", "max_position_embeddings=32", "hidden_dropout_prob=0.0"]
    return [
        f"ckpt_dir={ckpt_dir}", "name=rrs", f"seed={SEED}", "model.dtype=float32",
        f"dataset.src.root={root}", f"dataset.tgt.root={root}", "dataset.src.file=findings.tok",
        "dataset.tgt.file=impression.tok", "dataset.src.tokenizer_max_len=24",
        "dataset.tgt.tokenizer_max_len=8", "dataset.num_workers=0",
        *[f"model.encoder.{kv}" for kv in block], *[f"model.decoder.{kv}" for kv in block],
        "trainor.batch_size=8", "trainor.epochs=1", "trainor.optim_params.lr=0.001",
        "validator.batch_size=4", "validator.beam_width=2", "validator.metrics=[ROUGEL,BLEU]",
        "validator.shard_eval=false",
    ]


@pytest.fixture(scope="module")
def runs(workdir, tmp_path_factory):
    config_file = "config/RRS/baseline-transformer-mimic.yml"
    jdir = tmp_path_factory.mktemp("jax_rrs")
    config, _ = load_config(config_file, _overrides(workdir, jdir))
    train_config = executor_config(config, "trainor")
    val_config = executor_config(config, "validator")
    ckpt_dir = os.path.join(config.ckpt_dir, config.name)
    os.makedirs(ckpt_dir)
    train_config.ckpt_dir = val_config.ckpt_dir = ckpt_dir
    jset_logger(ckpt_dir, SEED)
    jtrainor = JTrainor(config=train_config, seed=SEED)
    jtrainor.evaluator = JValidator(config=val_config, models=[jtrainor.model],
                                    train_dl=jtrainor.dl, seed=SEED, from_training=True)
    initial = {k: v.clone() for k, v in rrs_state_dict_from_jax(
        jax.tree.map(np.asarray, jtrainor.model.variables)).items()}
    jhyps = []
    jeval_start = jtrainor.evaluator.start

    def jstart():
        jeval_start()
        jhyps.append(open(os.path.join(ckpt_dir, f"validate_{SEED}_hyps.txt")).read())

    jtrainor.evaluator.start = jstart
    jtrainor.start()

    class Seeded(TTrainor):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            self.model.module.load_state_dict(initial, strict=True)

    tdir = tmp_path_factory.mktemp("torch_rrs")
    thyps = []
    from vilmedic_torch.executors.validator import Validator as TValidator

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tcli, "Trainor", Seeded)
        tstart = TValidator.start

        def recording_start(self):
            scores = tstart(self)
            thyps.append(open(os.path.join(str(tdir), "rrs", f"validate_{SEED}_hyps.txt")).read())
            return scores

        mp.setattr(TValidator, "start", recording_start)
        ttrainor = tcli.main([config_file, *_overrides(workdir, tdir), "device=cpu"])
    yield dict(j=jtrainor, t=ttrainor, jhyps=jhyps, thyps=thyps, tdir=str(tdir))


def test_cli_losses_match_jax(runs):
    j, t = runs["j"], runs["t"]
    assert len(t.epoch_losses) == len(j.epoch_losses) == 2
    np.testing.assert_allclose(t.epoch_losses, j.epoch_losses, rtol=TOL, atol=TOL)
    assert t.training_scheduler.iteration_count == j.training_scheduler.iteration_count == 2
    for name in ("vocab.src", "vocab.tgt"):
        assert os.path.exists(os.path.join(runs["tdir"], "rrs", name))


def test_cli_hyps_and_scores_match_jax(runs):
    assert len(runs["thyps"]) == len(runs["jhyps"]) == 2
    assert runs["thyps"] == runs["jhyps"]
    want, got = runs["j"].evaluator.scores[0], runs["t"].evaluator.scores[0]
    for key in ("ROUGEL", "BLEU"):
        np.testing.assert_allclose(got[key], want[key], rtol=TOL_SCORE, atol=TOL_SCORE)
