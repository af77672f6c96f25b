"""Sampled, fused greedy + sampled, and constrained decoding: the port's
``decoding/decode.py`` against the JAX package's, on the CPU, float32.

``jax.random``'s bits cannot be drawn in torch, so the port's
``gumbel_noise`` is replaced by JAX's own noise: for step i,
``jax.random.gumbel(fold_in(key, i), (B, V), float32)``, the noise inside
``jax.random.categorical`` there. Sequences and lengths must then be equal,
on a Markov toy step function (vocab 200 and 4500: the top-k threshold is
blockwise from 4096 up) and on a tiny RRG over the plain cache (vocab 300
and 4500), whose weights cross through ``rrg_state_dict_from_jax``. The
port's own sampler is held against the softmax by its frequencies.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vilmedic_torch.blocks.vision.densenet as tdensenet
import vilmedic_tpu.blocks.vision.densenet as jdensenet
from vilmedic_torch.data.image import finalize_device_preproc
from vilmedic_torch.decoding import decode as tdecode
from vilmedic_torch.models.rrg import RRG as TRRG
from vilmedic_torch.zoo.from_jax import rrg_state_dict_from_jax
from vilmedic_tpu.decoding import decode as jdecode
from vilmedic_tpu.models.rrg import RRG as JRRG
from vilmedic_tpu.ops.image_preproc import crop_normalize as jax_crop_normalize

B, MAX_LEN, BOS, EOS, PAD = 4, 12, 0, 2, 1
TOP_K = 5
KEY = jax.random.key(11)
CPU = torch.device("cpu")
TINY = (8, (2, 2), 16)
CNN = dict(proto="VisualEncoder", backbone="densenet_tiny", output_layer="features",
           dropout_out=0.0, permute="batch_first",
           visual_projection={"in_features": 32, "out_features": 64}, freeze=False)


def jax_noise(key=KEY):
    """A stand-in for the port's ``gumbel_noise``: its i-th call returns
    JAX's step-i noise of the requested shape."""
    calls = []

    def noise(shape, generator, device):
        n = jax.random.gumbel(jax.random.fold_in(key, len(calls)), tuple(shape), jnp.float32)
        calls.append(tuple(shape))
        return torch.from_numpy(np.array(n)).to(device)

    noise.calls = calls
    return noise


def _table(vocab, seed=0):
    """Markov logits (vocab, vocab): a few strong successors per token and
    EOS likely enough that rows finish at different steps."""
    rng = np.random.default_rng(seed)
    table = rng.normal(size=(vocab, vocab)).astype(np.float32) * 2.0
    table[:, EOS] = rng.uniform(2.0, 7.0, size=vocab).astype(np.float32)
    return table


def _steps(table):
    jt, tt = jnp.asarray(table), torch.from_numpy(table)
    return (lambda tokens, caches, i: (jt[tokens[:, 0]], caches),
            lambda tokens, i: tt[tokens[:, 0]])


def _force(vocab):
    rng = np.random.default_rng(3)
    f = np.full((B, 4), -1, np.int32)
    for b in range(B):
        n = b + 1 if b < 3 else 4
        f[b, :n] = rng.choice(np.arange(5, vocab), n, replace=False)
    f[3, 3] = f[3, 2]  # a forced id twice: its bias counts twice until met
    return f


def _assert_rollouts_equal(got, want):
    np.testing.assert_array_equal(got.sequences.numpy(), np.asarray(want.sequences))
    np.testing.assert_array_equal(got.lengths.numpy(), np.asarray(want.lengths))


@pytest.mark.parametrize("vocab", [200, 4500])
def test_sample_matches_jax(vocab, monkeypatch):
    jstep, tstep = _steps(_table(vocab))
    want = jdecode.sample(jstep, {}, B, MAX_LEN, BOS, EOS, PAD, rng=KEY, top_k=TOP_K,
                          bad_words=(PAD, BOS), forced_eos=True)
    noise = jax_noise()
    monkeypatch.setattr(tdecode, "gumbel_noise", noise)
    got = tdecode.sample(tstep, B, MAX_LEN, BOS, EOS, PAD, CPU, top_k=TOP_K,
                         bad_words=(PAD, BOS), forced_eos=True)
    _assert_rollouts_equal(got, want)
    assert noise.calls == [(B, vocab)] * got.steps
    assert len(set(got.lengths.tolist())) > 1  # rows finish at different steps


@pytest.mark.parametrize("vocab", [200, 4500])
def test_greedy_and_sample_matches_jax(vocab, monkeypatch):
    jstep, tstep = _steps(_table(vocab, seed=1))
    jcache = {"payload": jnp.arange(B * 3, dtype=jnp.float32).reshape(B, 3)}
    jg, js = jdecode.greedy_and_sample(jstep, jdecode.stack_for_rollouts(jcache), B, MAX_LEN,
                                       BOS, EOS, PAD, rng=KEY, top_k=TOP_K,
                                       bad_words=(PAD, BOS), forced_eos=True)
    monkeypatch.setattr(tdecode, "gumbel_noise", jax_noise())
    tg, ts = tdecode.greedy_and_sample(tstep, B, MAX_LEN, BOS, EOS, PAD, CPU, top_k=TOP_K,
                                       bad_words=(PAD, BOS), forced_eos=True)
    _assert_rollouts_equal(tg, jg)
    _assert_rollouts_equal(ts, js)
    assert not np.array_equal(ts.sequences.numpy(), tg.sequences.numpy())


@pytest.mark.parametrize("vocab", [200, 4500])
def test_constrained_greedy_matches_jax(vocab):
    jstep, tstep = _steps(_table(vocab, seed=2))
    force = _force(vocab)
    want = jdecode.constrained_greedy_search(jstep, {}, B, MAX_LEN, BOS, EOS, PAD,
                                             jnp.asarray(force))
    got = tdecode.constrained_greedy_search(tstep, B, MAX_LEN, BOS, EOS, PAD,
                                            torch.from_numpy(force), CPU)
    _assert_rollouts_equal(got, want)
    seqs = got.sequences.numpy()
    for row, f in zip(seqs, force):  # every forced id fits in 12 tokens
        assert set(f[f >= 0]) <= set(row.tolist())


def test_stack_for_rollouts_interleaves():
    x = torch.arange(6).reshape(3, 2)
    got = tdecode.stack_for_rollouts({"a": x, "b": (x, x + 1)})
    want = np.asarray(jdecode.stack_for_rollouts({"a": jnp.asarray(x.numpy())})["a"])
    np.testing.assert_array_equal(got["a"].numpy(), want)
    np.testing.assert_array_equal(got["b"][1].numpy(), want + 1)


@pytest.mark.parametrize("vocab", [200, 4500])
def test_fused_rollout_equals_separate_ones(vocab):
    """The port's fused loop against its own greedy_search + sample, from
    generators of one seed (the JAX package's test with its own sampler)."""
    _, tstep = _steps(_table(vocab, seed=4))
    kw = dict(top_k=TOP_K, bad_words=(PAD, BOS), forced_eos=True)
    g = tdecode.greedy_search(tstep, B, MAX_LEN, BOS, EOS, PAD, CPU, forced_eos=True)
    s = tdecode.sample(tstep, B, MAX_LEN, BOS, EOS, PAD, CPU,
                       generator=torch.Generator().manual_seed(9), **kw)
    g2, s2 = tdecode.greedy_and_sample(tstep, B, MAX_LEN, BOS, EOS, PAD, CPU,
                                       generator=torch.Generator().manual_seed(9), **kw)
    for a, b in ((g, g2), (s, s2)):
        assert torch.equal(a.sequences, b.sequences) and torch.equal(a.lengths, b.lengths)


def test_gumbel_noise_formula():
    """``-log(-log(u))`` of the generator's uniform draws, u floored at the
    f32 tiny as ``jax.random.gumbel``'s ``minval``."""
    gen = torch.Generator().manual_seed(1)
    got = tdecode.gumbel_noise((64, 33), gen, CPU)
    u = torch.rand((64, 33), generator=torch.Generator().manual_seed(1))
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    torch.testing.assert_close(got, -torch.log(-torch.log(u)), rtol=0, atol=0)


def test_port_sampler_matches_softmax():
    """The port's own sampler by distribution: 200000 draws from one row of
    logits under top-k 4 and two bad words (the two largest logits). The
    4th largest allowed value is shared by three tokens, so the support is
    5 tokens (ties at the k-th value stay in); every draw lies in it, and
    each token's frequency is within 5 standard errors (and 0.006) of the
    softmax renormalized over it."""
    logits = torch.tensor([[2.0, -1.0, 1.5, 0.3, 0.3, 1.0, -0.5, 0.3, 3.0, -2.0]])
    bad = (8, 0)
    n = 200_000
    rows = logits.expand(n, -1)
    draws = tdecode._categorical(tdecode._warp(rows, bad, 4), torch.Generator().manual_seed(0))
    support = torch.zeros(10, dtype=torch.bool)
    support[[2, 5, 3, 4, 7]] = True
    p = torch.where(support, torch.softmax(torch.where(support, logits[0], -torch.inf), -1), 0.0)
    freq = torch.bincount(draws, minlength=logits.shape[1]).double() / n
    assert set(draws.unique().tolist()) == {2, 3, 4, 5, 7}
    se = torch.sqrt(p * (1 - p) / n)
    assert ((freq - p).abs() <= torch.maximum(5 * se, torch.tensor(0.006))).all(), (freq, p)


# --------------------------------------------------------------- tiny RRG


@pytest.fixture(scope="module")
def tiny_rrg():
    """Per vocab (300, 4500): a JAX RRG with perturbed weights, the port's
    RRG with the same weights, and both sides' images."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(jdensenet.CONFIGS, "densenet_tiny", TINY)
        mp.setitem(tdensenet.CONFIGS, "densenet_tiny", TINY)
        rng = np.random.default_rng(0)
        images = rng.integers(0, 256, (B, 40, 40, 3), dtype=np.uint8)
        tops, lefts = np.array([3, 8, 0, 4], np.int32), np.array([0, 5, 2, 7], np.int32)
        jimages = jax_crop_normalize(jnp.asarray(images), jnp.asarray(tops),
                                     jnp.asarray(lefts), 32, use_pallas=False)
        timages = finalize_device_preproc({
            "images_u8": torch.from_numpy(images), "preproc_tops": torch.from_numpy(tops),
            "preproc_lefts": torch.from_numpy(lefts)}, 32)["images"]
        out = {}
        for vocab in (300, 4500):
            dec = dict(proto=None, hidden_size=64, num_hidden_layers=2, num_attention_heads=2,
                       intermediate_size=128, max_position_embeddings=32, layer_norm_eps=1e-5,
                       vocab_size=vocab, bos_token_id=BOS, eos_token_id=EOS,
                       pad_token_id=PAD)
            jmodel = JRRG(decoder=dict(dec), cnn=dict(CNN), dtype="float32")
            batch = {"images": jnp.zeros((2, 32, 32, 3)),
                     "input_ids": jnp.zeros((2, 4), jnp.int32),
                     "attention_mask": jnp.ones((2, 4), jnp.int32)}
            v = jax.jit(jmodel.init_variables)(jax.random.key(0), batch)
            params = jax.tree.map(
                lambda x: np.asarray(x) + 0.3 * rng.normal(size=x.shape).astype(np.float32),
                v["params"])
            params["dec"]["lm_head"]["kernel"] *= 3.0
            variables = {"params": params, "batch_stats": jax.tree.map(np.asarray,
                                                                       v["batch_stats"])}
            tmodel = TRRG(decoder=dict(dec), cnn=dict(CNN), dtype="float32", device="cpu")
            tmodel.module.load_state_dict(rrg_state_dict_from_jax(variables), strict=True)
            out[vocab] = (jmodel.module, variables, tmodel.module)
        yield out, jimages, timages


def _jax_rrg(module, variables, jimages, stacked):
    enc_h, enc_m = module.apply(variables, jimages, None, method=type(module).encode)
    self_cache, cross_cache = module.apply(variables, enc_h, MAX_LEN,
                                           method=type(module).init_cache)
    enc_m = enc_m.astype(jnp.int32)

    def step(tokens, cache, i):
        logits, new = module.apply(variables, tokens, cache, cross_cache, enc_m, i,
                                   method=type(module).decode_step)
        return logits[:, -1].astype(jnp.float32), new

    return step, (jdecode.stack_for_rollouts(self_cache) if stacked else self_cache)


def _port_rrg(module, timages, stacked):
    enc_h, enc_m = module.encode(timages)
    self_cache, cross_cache = module.init_cache(enc_h, MAX_LEN)
    if stacked:
        self_cache = tdecode.stack_for_rollouts(self_cache)
    enc_m = enc_m.to(torch.int32)
    return lambda tokens, i: module.decode_step(tokens, self_cache, cross_cache, enc_m,
                                                i)[:, -1].float()


@pytest.mark.parametrize("vocab", [300, 4500])
@pytest.mark.parametrize("route", ["sample", "greedy_and_sample", "constrained"])
def test_tiny_rrg_rollouts_match_jax(tiny_rrg, vocab, route, monkeypatch):
    models, jimages, timages = tiny_rrg
    jmodule, variables, tmodule = models[vocab]
    stacked = route == "greedy_and_sample"
    jstep, jcache = _jax_rrg(jmodule, variables, jimages, stacked)
    monkeypatch.setattr(tdecode, "gumbel_noise", jax_noise())
    kw = dict(top_k=TOP_K, bad_words=(PAD, BOS), forced_eos=True)
    with torch.no_grad():
        tstep = _port_rrg(tmodule, timages, stacked)
        if route == "sample":
            want = [jdecode.sample(jstep, jcache, B, MAX_LEN, BOS, EOS, PAD, rng=KEY, **kw)]
            got = [tdecode.sample(tstep, B, MAX_LEN, BOS, EOS, PAD, CPU, **kw)]
        elif route == "greedy_and_sample":
            want = jdecode.greedy_and_sample(jstep, jcache, B, MAX_LEN, BOS, EOS, PAD, rng=KEY,
                                             **kw)
            got = tdecode.greedy_and_sample(tstep, B, MAX_LEN, BOS, EOS, PAD, CPU, **kw)
        else:
            force = _force(vocab)
            want = [jdecode.constrained_greedy_search(jstep, jcache, B, MAX_LEN, BOS, EOS, PAD,
                                                      jnp.asarray(force))]
            got = [tdecode.constrained_greedy_search(tstep, B, MAX_LEN, BOS, EOS, PAD,
                                                     torch.from_numpy(force), CPU)]
    for g, w in zip(got, want):
        _assert_rollouts_equal(g, w)
