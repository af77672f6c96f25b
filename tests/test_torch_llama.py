"""The port's LLaMA (``blocks/llm/llama.py``), its checkpoint reader
(``zoo/convert_llm.py``), the JAX tree bridge and the GREEN judge against
the JAX package, on the CPU, at ``tests/test_llama_judge.py``'s sizes
(vocab 97, hidden 64, 2 layers of 4 heads), MHA and GQA (2 key / value
heads):

- full-sequence logits of a left-padded batch within 1e-5 of JAX's
  ``LlamaForCausalLM`` (f32), the weights bridged by
  ``llama_state_dict_from_jax``;
- ``greedy_generate`` tokens equal to JAX's, with left padding, and with an
  EOS that row 0 emits mid-way (pad after it, the loop ended early);
- ``load_hf_llama`` on one ``model.safetensors`` and on index-sharded
  files: the same tensors as the JAX loader's, the same logits;
- the GREEN text path: a tiny judge written as an HF checkpoint beside a
  Llama-2-style ``tokenizer.json``; the port's judge (f32) and the JAX
  package's ``_tpu_judge`` (held to f32) give the same responses, and
  ``GREENImpl`` the same scores; ``VILMEDIC_GREEN_BACKEND=torch`` raises.
"""

import json

import numpy as np
import pytest
import torch

tr = pytest.importorskip("transformers")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from vilmedic_torch.blocks.llm import LlamaForCausalLM as TLlama  # noqa: E402
from vilmedic_torch.blocks.llm import greedy_generate as tgreedy  # noqa: E402
from vilmedic_torch.blocks.llm import llama_config_from_hf as tconfig  # noqa: E402
from vilmedic_torch.zoo.convert_llm import build_hf_llama, load_hf_llama  # noqa: E402
from vilmedic_torch.zoo.from_jax import llama_state_dict_from_jax  # noqa: E402
from vilmedic_tpu.blocks.llm import LlamaConfig as JConfig  # noqa: E402
from vilmedic_tpu.blocks.llm import LlamaForCausalLM as JLlama  # noqa: E402
from vilmedic_tpu.blocks.llm import greedy_generate as jgreedy  # noqa: E402
from vilmedic_tpu.zoo.convert_llm import convert_hf_llama  # noqa: E402

VOCAB = 97
TOL = 1e-5


@pytest.fixture(autouse=True)
def offline(monkeypatch):
    import huggingface_hub.constants as hub_constants
    import transformers.utils.hub as hf_hub

    monkeypatch.setenv("HF_HUB_OFFLINE", "1")
    monkeypatch.setattr(hub_constants, "HF_HUB_OFFLINE", True)
    monkeypatch.setattr(hf_hub, "_is_offline_mode", True)


def tiny_hf(num_kv=4, seed=0, vocab=VOCAB, scale=0.05, tied=False):
    cfg = tr.LlamaConfig(vocab_size=vocab, hidden_size=64, intermediate_size=128,
                         num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=num_kv,
                         max_position_embeddings=2048, rms_norm_eps=1e-5, rope_theta=10000.0,
                         tie_word_embeddings=tied, attention_dropout=0.0, bos_token_id=1,
                         eos_token_id=2, pad_token_id=None, torch_dtype="float32")
    model = tr.LlamaForCausalLM(cfg)
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(torch.randn(p.shape, generator=g) * scale)
    return cfg, model.eval()


def jax_from(hf_cfg, model):
    cfg = JConfig(vocab_size=hf_cfg.vocab_size, hidden_size=hf_cfg.hidden_size,
                  intermediate_size=hf_cfg.intermediate_size,
                  num_hidden_layers=hf_cfg.num_hidden_layers,
                  num_attention_heads=hf_cfg.num_attention_heads,
                  num_key_value_heads=hf_cfg.num_key_value_heads,
                  max_position_embeddings=hf_cfg.max_position_embeddings,
                  rms_norm_eps=hf_cfg.rms_norm_eps,
                  tie_word_embeddings=hf_cfg.tie_word_embeddings, dtype=jnp.float32)
    params = convert_hf_llama(model.state_dict())
    if hf_cfg.tie_word_embeddings:  # HF's state dict repeats the tied table
        params.pop("lm_head")
    return JLlama(cfg), {"params": params}


def port_from(hf_cfg, params):
    model = TLlama(tconfig(hf_cfg.to_dict(), dtype=torch.float32), device="cpu")
    model.load_state_dict(llama_state_dict_from_jax(params), strict=True)
    return model.eval()


def left_padded_batch(rng, b=3, p=9):
    ids = rng.integers(3, VOCAB, (b, p)).astype(np.int32)
    mask = np.ones((b, p), np.int32)
    for i, pad in enumerate([0, 3, 5][:b]):
        ids[i, :pad] = 0
        mask[i, :pad] = 0
    return ids, mask


@pytest.mark.parametrize("num_kv,tied", [(4, False), (2, False), (4, True)])
def test_logits_match_jax(num_kv, tied):
    hf_cfg, hf = tiny_hf(num_kv, tied=tied)
    jm, params = jax_from(hf_cfg, hf)
    ours = port_from(hf_cfg, params)
    ids, mask = left_padded_batch(np.random.default_rng(1))
    want = np.asarray(jm.apply(params, jnp.asarray(ids), jnp.asarray(mask)))
    got = ours(torch.from_numpy(ids).long(), torch.from_numpy(mask).long()).numpy()
    np.testing.assert_allclose(got[mask > 0], want[mask > 0], rtol=0, atol=TOL)


@pytest.mark.parametrize("num_kv", [4, 2])
def test_greedy_tokens_match_jax(num_kv):
    hf_cfg, hf = tiny_hf(num_kv)
    jm, params = jax_from(hf_cfg, hf)
    ours = port_from(hf_cfg, params)
    ids, mask = left_padded_batch(np.random.default_rng(2))
    max_new = 10

    def jax_tokens(eos):
        return np.asarray(jax.jit(lambda p, i, m: jgreedy(jm, p, i, m, max_new, eos, 1))(
            params, jnp.asarray(ids), jnp.asarray(mask)))

    def port_tokens(eos):
        return tgreedy(ours, torch.from_numpy(ids).long(), torch.from_numpy(mask).long(),
                       max_new, eos, 1).numpy()

    free = jax_tokens(-1)
    np.testing.assert_array_equal(port_tokens(-1), free)
    eos = int(free[0, 2])  # row 0 emits it at step 3
    got, want = port_tokens(eos), jax_tokens(eos)
    np.testing.assert_array_equal(got, want)
    hit = int(np.argmax(got[0] == eos))
    assert (got[0, hit + 1:] == 1).all()
    # an EOS that some row emits first: pad after it in that row
    all_eos = int(free[:, 0].max())
    rows = tgreedy(ours, torch.from_numpy(ids).long(), torch.from_numpy(mask).long(), max_new,
                   all_eos, 1).numpy()
    np.testing.assert_array_equal(rows, jax_tokens(all_eos))


def _write_checkpoint(d, hf, sharded: bool):
    from safetensors.torch import save_file

    d.mkdir(parents=True, exist_ok=True)
    (d / "config.json").write_text(json.dumps(hf.config.to_dict()))
    state = {k: v.contiguous() for k, v in hf.state_dict().items()}
    if not sharded:
        save_file(state, str(d / "model.safetensors"))
        return
    keys = sorted(state)
    parts = [keys[: len(keys) // 2], keys[len(keys) // 2:]]
    weight_map = {}
    for i, part in enumerate(parts):
        name = f"model-{i + 1:05d}-of-00002.safetensors"
        save_file({k: state[k] for k in part}, str(d / name))
        weight_map.update({k: name for k in part})
    (d / "model.safetensors.index.json").write_text(json.dumps({"weight_map": weight_map}))


@pytest.mark.parametrize("sharded", [False, True])
def test_load_hf_llama_matches_jax(tmp_path, sharded):
    from vilmedic_tpu.zoo.convert_llm import load_hf_llama as jload

    hf_cfg, hf = tiny_hf(2)
    d = tmp_path / "judge"
    _write_checkpoint(d, hf, sharded)
    cfg, state = load_hf_llama(str(d))
    assert cfg.dtype == torch.float32 and cfg.num_key_value_heads == 2
    _, jparams = jload(str(d))
    bridged = llama_state_dict_from_jax(jparams)
    assert sorted(state) == sorted(bridged)
    for k in state:
        np.testing.assert_array_equal(state[k].float().numpy(), bridged[k].numpy(), err_msg=k)
    model = build_hf_llama(str(d), device="cpu")
    ids, mask = left_padded_batch(np.random.default_rng(3))
    jm, params = jax_from(hf_cfg, hf)
    want = np.asarray(jm.apply(params, jnp.asarray(ids), jnp.asarray(mask)))
    got = model(torch.from_numpy(ids).long(), torch.from_numpy(mask).long()).numpy()
    np.testing.assert_allclose(got[mask > 0], want[mask > 0], rtol=0, atol=TOL)


def test_from_jax_covers_the_llama_tree():
    hf_cfg, hf = tiny_hf(2, tied=True)
    _, params = jax_from(hf_cfg, hf)
    port = TLlama(tconfig(hf_cfg.to_dict(), dtype=torch.float32), device="cpu")
    assert sorted(llama_state_dict_from_jax(params)) == sorted(port.state_dict())


# ------------------------------------------------------------------ GREEN


REFS = ["The heart size is normal. The lungs are clear.",
        "Mild cardiomegaly with small bilateral effusions.",
        "No acute cardiopulmonary process."]
HYPS = ["Normal heart size, lungs clear.",
        "Cardiomegaly. No effusion.",
        "No acute process."]


@pytest.fixture(scope="module")
def judge_dir(tmp_path_factory):
    from test_torch_tokenizers import write_llama_tokenizer

    d = tmp_path_factory.mktemp("green") / "judge"
    write_llama_tokenizer(str(d))
    vocab = len(json.loads((d / "tokenizer.json").read_text())["model"]["vocab"])
    _, hf = tiny_hf(2, vocab=vocab, scale=0.08, seed=5)
    _write_checkpoint(d, hf, sharded=False)
    return d


@pytest.mark.parametrize("max_length,max_new", [(1024, 8), (40, 6)])
def test_green_judge_matches_jax(judge_dir, monkeypatch, max_length, max_new):
    """Responses equal to the JAX package's ``_tpu_judge`` (its 128-multiple
    buckets and fixed batch included) and the same GREEN scores."""
    import vilmedic_tpu.zoo.convert_llm as jconvert
    from vilmedic_torch.data.auto_tokenizer import AutoTokenizer
    from vilmedic_torch.scorers import green as tgreen
    from vilmedic_tpu.scorers import green as jgreen

    jload = jconvert.load_hf_llama
    monkeypatch.setattr(jconvert, "load_hf_llama", lambda d, dtype=None: jload(d, jnp.float32))
    jtok = tr.AutoTokenizer.from_pretrained(str(judge_dir), local_files_only=True,
                                            padding_side="left")
    jtok.pad_token = jtok.eos_token
    jjudge = jgreen.GREENImpl._tpu_judge(str(judge_dir), max_length, 2, tokenizer=jtok,
                                         max_new_tokens=max_new)
    ttok = AutoTokenizer.from_pretrained(str(judge_dir), padding_side="left")
    ttok.pad_token = ttok.eos_token
    tjudge = tgreen.GREENImpl.llama_judge(str(judge_dir), max_length, 2, tokenizer=ttok,
                                          max_new_tokens=max_new, device="cpu")
    prompts = [tgreen.make_prompt(r, h) for r, h in zip(REFS, HYPS)]
    assert prompts == [jgreen.make_prompt(r, h) for r, h in zip(REFS, HYPS)]
    want = jjudge(prompts)
    got = tjudge(prompts)
    assert got == want
    assert len({len(w) for w in want}) > 1 or any(want)  # the judge emitted text
    jgreen.pair_to_reward_dict.clear()
    tgreen.pair_to_reward_dict.clear()
    assert tgreen.GREENImpl(judge_fn=tjudge)(REFS, HYPS) == \
        jgreen.GREENImpl(judge_fn=jjudge)(REFS, HYPS)


def test_green_parser_and_memo_match_jax():
    from vilmedic_torch.scorers import green as tgreen
    from vilmedic_tpu.scorers import green as jgreen

    response = ("[Explanation]:\nx\n\n[Clinically Significant Errors]:\n(a) False report: 1. "
                "a\n(b) Missing: 2. b; c\n\n[Clinically Insignificant Errors]:\n(a) x: 0.\n\n"
                "[Matched Findings]:\n3. heart; lungs; pleura\n")
    for text in (response, response.replace("(a)", "(1)").replace("(b)", "(2)"), "", "nothing"):
        assert tgreen.compute_green(text) == jgreen.compute_green(text)
        for cat in tgreen.CATEGORIES:
            assert tgreen.parse_error_counts(text, cat) == jgreen.parse_error_counts(text, cat)
    tgreen.pair_to_reward_dict.clear()
    calls = []
    impl = tgreen.GREENImpl(judge_fn=lambda ps: calls.append(len(ps)) or [response] * len(ps))
    assert impl(["r", "r"], ["h", "h"])[1] == [0.5, 0.5]
    assert impl(["r"], ["h"]) == (0.5, [0.5]) and calls == [2]


def test_green_refuses_without_weights_or_the_transformers_route(tmp_path, monkeypatch):
    from vilmedic_torch.scorers.clinical import GREEN, ScorerUnavailable

    monkeypatch.delenv("GREEN_MODEL", raising=False)
    monkeypatch.setenv("VILMEDIC_WEIGHTS_DIR", str(tmp_path / "none"))
    monkeypatch.setenv("HF_HUB_CACHE", str(tmp_path / "empty"))
    with pytest.raises(ScorerUnavailable):
        GREEN(device="cpu")
    monkeypatch.setenv("VILMEDIC_GREEN_BACKEND", "torch")
    with pytest.raises(NotImplementedError, match="VILMEDIC_GREEN_BACKEND=torch"):
        GREEN(device="cpu")
