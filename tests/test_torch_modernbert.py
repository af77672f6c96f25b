"""The port's ModernBERT (``scorers/modernbert.py``) against
``transformers.ModernBertModel``, and ``radevalbertscore`` through the
port's ``compute_scores`` against the JAX package's, on the CPU.

- A 3-layer ModernBERT (hidden 64, ``global_attn_every_n_layers`` 2, so
  layer 1 is local, ``local_attention`` 8: a window of 4 on either side,
  shorter than the 40-token rows) with random weights and biases: every
  hidden state within 1e-5 of HF's ``output_hidden_states``, padded rows
  included; the last one is taken before ``final_norm``, as HF takes it.
- ``radevalbertscore``: a 22-layer ModernBERT of width 32 written with its
  ModernBERT-style ``tokenizer.json`` into a temp hub cache as
  ``IAMJB/RadEvalModernBERT``; both packages' ``compute_scores`` read it
  by name (layer 22, no baseline) and agree within 1e-6; without the files
  both read ``None``.
"""

import logging

import numpy as np
import pytest
import torch

tr = pytest.importorskip("transformers")

from test_torch_tokenizers import CORPUS, write_modernbert_tokenizer  # noqa: E402
from vilmedic_torch.scorers.bert_encoder import load_weights  # noqa: E402
from vilmedic_torch.scorers.modernbert import ModernBertEncoder  # noqa: E402

RADEVAL = "IAMJB/RadEvalModernBERT"


@pytest.fixture(autouse=True)
def offline(monkeypatch):
    """The JAX side loads by name through ``transformers``, which would ask
    the hub for files it lacks: hold both libraries offline."""
    import huggingface_hub.constants as hub_constants
    import transformers.utils.hub as hf_hub

    monkeypatch.setenv("HF_HUB_OFFLINE", "1")
    monkeypatch.setattr(hub_constants, "HF_HUB_OFFLINE", True)
    monkeypatch.setattr(hf_hub, "_is_offline_mode", True)


def _hf_model(seed=0, **kw):
    cfg = dict(vocab_size=320, hidden_size=64, intermediate_size=96, num_hidden_layers=3,
               num_attention_heads=4, global_attn_every_n_layers=2, local_attention=8,
               global_rope_theta=160000.0, local_rope_theta=10000.0, norm_bias=True,
               attention_bias=True, mlp_bias=True, max_position_embeddings=64,
               pad_token_id=303, cls_token_id=301, sep_token_id=302, bos_token_id=301,
               eos_token_id=302)
    cfg.update(kw)
    config = tr.ModernBertConfig(**cfg)
    torch.manual_seed(seed)
    model = tr.ModernBertModel(config).eval()
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=g))
    return model


def _port(model):
    enc = ModernBertEncoder(model.config.to_dict())
    enc.load_hf_state_dict(model.state_dict())
    return enc.eval()


@pytest.mark.parametrize("bias", [True, False])
def test_hidden_states_match_transformers(bias):
    model = _hf_model(norm_bias=bias, attention_bias=bias, mlp_bias=bias)
    ours = _port(model)
    rng = np.random.default_rng(0)
    ids = torch.from_numpy(rng.integers(0, 299, (3, 40)))
    mask = torch.ones(3, 40, dtype=torch.long)
    mask[1, 25:] = 0
    mask[2, 6:] = 0
    ids[mask == 0] = 303
    with torch.no_grad():
        want = model(input_ids=ids, attention_mask=mask, output_hidden_states=True)
        got = ours(ids, mask)
    assert len(got) == len(want.hidden_states) == 4
    for i, (a, b) in enumerate(zip(got, want.hidden_states)):
        keep = mask.bool()
        np.testing.assert_allclose(a[keep].numpy(), b[keep].numpy(), rtol=0, atol=1e-5,
                                   err_msg=f"hidden state {i}")
    # the list ends before final_norm; last_hidden_state is after it
    with torch.no_grad():
        normed = ours.final_norm(got[-1])
    np.testing.assert_allclose(normed[mask.bool()].numpy(),
                               want.last_hidden_state[mask.bool()].numpy(), atol=1e-5)
    assert not torch.allclose(got[-1], want.last_hidden_state)


def test_local_layers_see_only_their_window():
    """A token far outside layer 1's window changes nothing of layer 1's
    input but changes its output only through layer 0 (global)."""
    model = _hf_model()
    ours = _port(model)
    ids = torch.from_numpy(np.random.default_rng(1).integers(0, 299, (1, 30)))
    changed = ids.clone()
    changed[0, 29] = (ids[0, 29] + 1) % 299
    mask = torch.ones(1, 30, dtype=torch.long)
    with torch.no_grad():
        # the local layer alone, on the same input, sees no difference at
        # position 0 from a change at position 29 (outside its window)
        x = ours.embeddings.norm(ours.embeddings.tok_embeddings(ids))
        y = ours.embeddings.norm(ours.embeddings.tok_embeddings(changed))
        layer, g = ours.layers[1], torch.zeros(1, 1, 1, 30)
        pos = torch.arange(30)
        local = g.masked_fill(((pos[:, None] - pos[None, :]).abs() > 4), torch.finfo().min)
        a, b = layer(x, g, local), layer(y, g, local)
    assert torch.equal(a[0, :20], b[0, :20])
    assert not torch.equal(a[0, 29], b[0, 29])


def _radeval_cache(tmp_path, monkeypatch):
    import huggingface_hub.constants as hub_constants
    import transformers.utils.hub as hf_hub

    cache = tmp_path / "hub"
    snap = cache / ("models--" + RADEVAL.replace("/", "--")) / "snapshots" / "r1"
    write_modernbert_tokenizer(str(snap))
    model = _hf_model(num_hidden_layers=22, hidden_size=32, intermediate_size=48,
                      num_attention_heads=2, global_attn_every_n_layers=3, local_attention=8,
                      norm_bias=False, attention_bias=False, mlp_bias=False)
    model.save_pretrained(str(snap))
    (snap.parent.parent / "refs").mkdir()
    (snap.parent.parent / "refs" / "main").write_text("r1")
    monkeypatch.setenv("HF_HUB_CACHE", str(cache))
    monkeypatch.setattr(hf_hub, "TRANSFORMERS_CACHE", str(cache))
    monkeypatch.setattr(hub_constants, "HF_HUB_CACHE", str(cache))
    return snap, model


REFS = CORPUS[:6] + ["no acute process.", "the heart is normal in size and the lungs are clear."]
HYPS = CORPUS[1:7] + ["no acute cardiopulmonary process.", "normal heart, clear lungs!"]


def _compute(fn, metrics, **kw):
    return fn(metrics, REFS, HYPS, split="validate", seed=0, config={}, epoch=0,
              logger=logging.getLogger("radeval_test"), dump=False, **kw)


def test_radevalbertscore_matches_jax(tmp_path, monkeypatch):
    from vilmedic_torch.scorers import bertscore_impl
    from vilmedic_torch.scorers.scores import compute_scores as tcompute
    from vilmedic_tpu.scorers.scores import compute_scores as jcompute

    snap, model = _radeval_cache(tmp_path, monkeypatch)
    assert set(load_weights(str(snap))) == set(model.state_dict())
    bertscore_impl._load_scorer.cache_clear()
    want = _compute(jcompute, ["radevalbertscore", "BLEU"])
    got = _compute(tcompute, ["radevalbertscore", "BLEU"], device="cpu")
    assert list(got) == list(want)
    assert want["radevalbertscore"] is not None
    assert abs(got["radevalbertscore"] - want["radevalbertscore"]) <= 1e-6
    # per pair, through the scorer's own entry
    from vilmedic_torch.scorers.bertscore_impl import bert_score_f1 as tf1
    from vilmedic_tpu.scorers.bertscore_impl import bert_score_f1 as jf1

    np.testing.assert_allclose(
        tf1(RADEVAL, REFS, HYPS, layer=22, rescale_with_baseline=False, device="cpu"),
        jf1(RADEVAL, REFS, HYPS, layer=22, rescale_with_baseline=False), rtol=0, atol=1e-6)
    bertscore_impl._load_scorer.cache_clear()


def test_radevalbertscore_without_files_reads_none(tmp_path, monkeypatch):
    import huggingface_hub.constants as hub_constants
    import transformers.utils.hub as hf_hub

    from vilmedic_torch.scorers.scores import compute_scores as tcompute
    from vilmedic_tpu.scorers.scores import compute_scores as jcompute

    empty = str(tmp_path / "empty")
    monkeypatch.setenv("HF_HUB_CACHE", empty)
    monkeypatch.setattr(hf_hub, "TRANSFORMERS_CACHE", empty)
    monkeypatch.setattr(hub_constants, "HF_HUB_CACHE", empty)
    want = _compute(jcompute, ["radevalbertscore"])
    got = _compute(tcompute, ["radevalbertscore"], device="cpu")
    assert got == want == {"radevalbertscore": None}
