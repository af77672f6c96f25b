"""The RRG decode routes beyond single-model beam search, the port against
the JAX package on the CPU, float32: greedy decoding, ensembling of two
members, the two-stage candidate route of a vocabulary under 4096, the
cache-permute route, and the candidate helpers they share.

Tiny RRG slices (DenseNet-tiny, a 2-layer 128-wide decoder) carry the same
weights on both sides through ``rrg_state_dict_from_jax``. The port takes the
permute route for a decoder whose head dim the beam-cache kernel is not built
for, so that route is held with 8 heads of 16. The JAX package
runs its Pallas beam-cache kernel in interpret mode; its generate returns the
sequences only, so its ``beam_search`` is wrapped to carry the scores out.
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
from vilmedic_torch.models import evaluation_nlg as teval
from vilmedic_torch.models.rrg import RRG as TRRG
from vilmedic_torch.zoo.from_jax import rrg_state_dict_from_jax
from vilmedic_tpu.decoding import decode as jdecode
from vilmedic_tpu.models import evaluation_nlg as jeval
from vilmedic_tpu.models.rrg import RRG as JRRG
from vilmedic_tpu.ops.image_preproc import crop_normalize as jax_crop_normalize

TINY = (8, (2, 2), 16)
BEAM, MAX_LEN, BOS, EOS, PAD = 4, 12, 0, 2, 1
CNN = dict(proto="VisualEncoder", backbone="densenet_tiny", output_layer="features",
           dropout_out=0.0, permute="batch_first",
           visual_projection={"in_features": 32, "out_features": 128}, freeze=False)
# beam scores: sums of f32 log-probs computed in another order
TOL_SCORE = 1e-4


def _decoder(vocab, heads=2):
    return dict(proto=None, hidden_size=128, num_hidden_layers=2, num_attention_heads=heads,
                intermediate_size=256, max_position_embeddings=64, layer_norm_eps=1e-5,
                hidden_act="gelu", vocab_size=vocab, bos_token_id=BOS, eos_token_id=EOS,
                pad_token_id=PAD)


def _variables(jmodel, rng):
    batch = {"images": jnp.zeros((2, 32, 32, 3)), "input_ids": jnp.zeros((2, 4), jnp.int32),
             "attention_mask": jnp.ones((2, 4), jnp.int32)}
    variables = jax.jit(jmodel.init_variables)(jax.random.key(0), batch)
    params = jax.tree.map(
        lambda x: np.asarray(x) + 0.3 * rng.normal(size=x.shape).astype(np.float32),
        variables["params"])
    # a wider head whose EOS logit swings widest: hypotheses finish early
    params["dec"]["lm_head"]["kernel"] *= 2.0
    params["dec"]["lm_head"]["kernel"][:, EOS] *= 3.0
    stats = jax.tree.map(lambda x: rng.uniform(0.5, 1.5, size=x.shape).astype(np.float32),
                         variables["batch_stats"])
    return {"params": params, "batch_stats": stats}


def _beam_search_with_scores(*args, **kwargs):
    r = jdecode.beam_search(*args, **kwargs)
    return jdecode.BeamResult((r.sequences, r.scores), r.scores)


@pytest.fixture(scope="module")
def models():
    """Per vocab (4500: blocked; 300: two-stage), a JAX RRG, two sets of
    its variables and the port's RRG for each, under ``vocab`` for heads of
    64 and ``(vocab, 16)`` for heads of 16; the images of both sides.
    DenseNet-tiny stays registered in both packages for the module's tests."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(jdensenet.CONFIGS, "densenet_tiny", TINY)
        mp.setitem(tdensenet.CONFIGS, "densenet_tiny", TINY)
        rng = np.random.default_rng(0)
        images = rng.integers(0, 256, (2, 40, 40, 3), dtype=np.uint8)
        tops, lefts = np.array([3, 8], np.int32), np.array([0, 5], np.int32)
        jimages = jax_crop_normalize(jnp.asarray(images), jnp.asarray(tops),
                                     jnp.asarray(lefts), 32, use_pallas=False)
        batch = finalize_device_preproc({
            "images_u8": torch.from_numpy(images), "preproc_tops": torch.from_numpy(tops),
            "preproc_lefts": torch.from_numpy(lefts)}, 32)
        out = {"jinputs": {"images": jimages, "images_mask": None}, "batch": batch}
        for key, vocab, heads in ((4500, 4500, 2), (300, 300, 2), ((4500, 16), 4500, 8),
                                  ((300, 16), 300, 8)):
            jmodel = JRRG(decoder=_decoder(vocab, heads), cnn=dict(CNN), dtype="float32")
            variables = [_variables(jmodel, rng) for _ in range(2)]
            tmodels = []
            for v in variables:
                tm = TRRG(decoder=_decoder(vocab, heads), cnn=dict(CNN), dtype="float32",
                          device="cpu")
                tm.module.load_state_dict(rrg_state_dict_from_jax(v), strict=True)
                tmodels.append(tm)
            out[key] = (jmodel, variables, tmodels)
        yield out


def _jax_generate(models, key, n_members, beam, monkeypatch):
    jmodel, variables, _ = models[key]
    if beam > 1:
        monkeypatch.setattr(jeval, "beam_search", _beam_search_with_scores)
    generate = jeval.make_generate_fn([jmodel] * n_members, beam, MAX_LEN, BOS, EOS, PAD, 1.0)
    out = generate(variables[:n_members], models["jinputs"])
    return (np.asarray(out[0]), np.asarray(out[1])) if beam > 1 else (np.asarray(out), None)


def _port_generate(models, key, n_members, beam, **kwargs):
    tmodels = models[key][2][:n_members]
    generate = teval.make_generate_fn(tmodels, beam, MAX_LEN, BOS, EOS, PAD, 1.0, **kwargs)
    return generate(tmodels[0].encoder_inputs(models["batch"]))


def _assert_beams_equal(got, want):
    seqs, scores = want
    assert (seqs[:, 0] == BOS).all()
    np.testing.assert_array_equal(got.sequences.numpy(), seqs)
    np.testing.assert_allclose(got.scores.numpy(), scores, rtol=TOL_SCORE, atol=TOL_SCORE)


@pytest.mark.parametrize("vocab,n_members", [(4500, 1), (4500, 2), (300, 1)])
def test_greedy_matches_jax(models, monkeypatch, vocab, n_members):
    """beam_width 1: the plain cache, the plain head, argmax, no forced EOS;
    one decode step (and host sync) per generated column."""
    want, _ = _jax_generate(models, vocab, n_members, 1, monkeypatch)
    got = _port_generate(models, vocab, n_members, 1)
    assert isinstance(got, tdecode.RolloutResult)
    np.testing.assert_array_equal(got.sequences.numpy(), want)
    finished = (want == EOS).any(axis=1)
    assert got.steps == (MAX_LEN - 1 if not finished.all() else
                         int((want == EOS).argmax(axis=1).max()))


@pytest.mark.parametrize("vocab,n_members,g", [(4500, 2, 1), (4500, 2, 2), (300, 1, 1),
                                               (300, 2, 2)])
def test_beam_routes_match_jax(models, monkeypatch, vocab, n_members, g):
    """Ensembling (two members' blocked f32 heads summed) at vocab 4500, and
    the two-stage candidate route at vocab 300, one member and two: beam
    sequences equal, over the beam-cache kernel's never-permuted caches."""
    want = _jax_generate(models, vocab, n_members, BEAM, monkeypatch)
    _assert_beams_equal(_port_generate(models, vocab, n_members, BEAM,
                                       ancestry_group_items=g), want)


@pytest.mark.parametrize("vocab,n_members", [(4500, 1), (4500, 2), (300, 1)])
def test_permute_route_matches_jax(models, monkeypatch, vocab, n_members):
    """Heads of 16: the plain self cache reordered by every step's beams.
    The sequences equal both the JAX package's permute route
    (``VILMEDIC_ANCESTRY_DECODE=0``) and its beam-cache kernel route."""
    key = (vocab, 16)
    kernel_seqs, _ = _jax_generate(models, key, n_members, BEAM, monkeypatch)
    monkeypatch.setenv("VILMEDIC_ANCESTRY_DECODE", "0")
    monkeypatch.setenv("VILMEDIC_LMHEAD_KERNEL", "1")
    want = _jax_generate(models, key, n_members, BEAM, monkeypatch)
    got = _port_generate(models, key, n_members, BEAM)
    _assert_beams_equal(got, want)
    np.testing.assert_array_equal(got.sequences.numpy(), kernel_seqs)


@pytest.mark.parametrize("key,beam,kernel", [(4500, BEAM, True), (300, BEAM, True),
                                             (4500, 1, False), ((4500, 16), BEAM, False),
                                             ((300, 16), BEAM, False)])
def test_route_follows_head_dim(models, key, beam, kernel):
    """The reorder-free kernel route for a beam over heads of 64; the permute
    route for heads of 16; neither for greedy decoding."""
    assert teval.kernel_route_ok(models[key][2], beam) is kernel


def _quantized(rng, shape):
    return (rng.integers(-8, 8, shape) * 0.5).astype(np.float32)


@pytest.mark.parametrize("vocab", [300, 4500])
@pytest.mark.parametrize("k", [1, 8])
def test_topk_helpers_match_jax(vocab, k):
    """``_topk_and_lse``, ``_block_topk_lse`` and ``_kth_largest`` on
    logits quantized to 0.5, so ties are everywhere: indices equal (lower
    index first), values and lse within f32 rounding of another library."""
    rng = np.random.default_rng(vocab + k)
    x = _quantized(rng, (6, vocab))
    t = torch.from_numpy(x)
    for tfn, jfn in ((tdecode._topk_and_lse, jdecode._topk_and_lse),
                     (tdecode._block_topk_lse, jdecode._block_topk_lse)):
        got, want = tfn(t, k), jfn(jnp.asarray(x), k)
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
        np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(tdecode._kth_largest(t, k).numpy(),
                                  np.asarray(jdecode._kth_largest(jnp.asarray(x), k)))


@pytest.mark.parametrize("vocab", [4096, 4500])
def test_batch_beam_candidates_match_jax(vocab):
    """The unblocked candidate route for plain logits over a vocab >= 4096
    (padded to 128-column blocks per step)."""
    rng = np.random.default_rng(vocab)
    b, k = 3, 4
    x = _quantized(rng, (b * k, vocab))
    alive = (rng.integers(-6, 0, (b, k)) * 0.5).astype(np.float32)
    want = jdecode._batch_beam_candidates(jnp.asarray(x), b, k, jnp.asarray(alive), 2 * k)
    got = tdecode._batch_beam_candidates(torch.from_numpy(x), b, k, torch.from_numpy(alive),
                                         2 * k)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=1e-5, atol=1e-5)
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_gather_beams_matches_jax():
    """The permute: every leaf's rows by the new beams, exactly (one source
    row per target row), in place."""
    rng = np.random.default_rng(3)
    b, k = 3, 4
    tree = ({"self_k": rng.normal(size=(b * k, 5, 2, 8)).astype(np.float32),
             "self_v": rng.normal(size=(b * k, 5, 2, 8)).astype(np.float32)},)
    new_beam = rng.integers(0, k, (b, k))
    want = jdecode._gather_beams(jax.tree.map(jnp.asarray, tree), jnp.asarray(new_beam), b, k)
    got = ({key: torch.from_numpy(v.copy()) for key, v in tree[0].items()},)
    tdecode._gather_beams(got, torch.from_numpy(new_beam), b, k)
    for key in ("self_k", "self_v"):
        np.testing.assert_array_equal(got[0][key].numpy(), np.asarray(want[0][key]))


@pytest.mark.parametrize("forced_eos", [False, True])
def test_greedy_search_matches_jax(forced_eos):
    """``greedy_search`` over a table of quantized logits by (row, step,
    previous token), ties in the argmax included; some rows finish early."""
    b, vocab = 5, 40
    rng = np.random.default_rng(4)
    table = _quantized(rng, (b, MAX_LEN, vocab))
    table[..., EOS] = np.where(rng.random((b, MAX_LEN, vocab)) < 0.1, 5.0, -4.0)[..., 0]
    jt, tt = jnp.asarray(table), torch.from_numpy(table)
    rows = np.arange(b)

    def jstep(tokens, caches, i):
        return jt[rows, i, tokens[:, 0]], caches

    want = jdecode.greedy_search(jstep, (), b, MAX_LEN, BOS, EOS, PAD, forced_eos=forced_eos)
    got = tdecode.greedy_search(lambda tokens, i: tt[rows, i, tokens[:, 0]], b, MAX_LEN, BOS,
                                EOS, PAD, torch.device("cpu"), forced_eos=forced_eos)
    np.testing.assert_array_equal(got.sequences.numpy(), np.asarray(want.sequences))
    np.testing.assert_array_equal(got.lengths.numpy(), np.asarray(want.lengths))
    assert (np.asarray(want.sequences)[:, 1:-1] == EOS).any()


def test_plain_cache_decode_step_matches_kernel_cache():
    """One decoder step over the plain (N, T, H, D) cache writes the step's
    K/V at its index and returns the kernel-cache step's logits when the
    ancestry is the identity."""
    from vilmedic_torch.blocks.transformer import TransformerConfig, TransformerDecoder, \
        to_kernel_cache

    torch.manual_seed(0)
    cfg = TransformerConfig(vocab_size=50, hidden_size=64, num_hidden_layers=2,
                            num_attention_heads=2, intermediate_size=96,
                            max_position_embeddings=16)
    dec = TransformerDecoder(cfg).eval()
    enc = torch.randn(3, 5, 64)
    plain, cross = dec(encoder_hidden_states=enc, mode="init_cache", max_len=8)
    kernel = to_kernel_cache(plain)
    anc = torch.zeros(3, 1, 8, dtype=torch.bool)
    with torch.no_grad():
        for i in range(3):
            tokens = torch.randint(0, 50, (3, 1))
            a = dec(tokens, mode="decode", cache=(plain, cross), decode_index=i)
            b = dec(tokens, mode="decode", cache=(kernel, cross), decode_index=i,
                    ancestry=anc)
            anc[:, 0, i] = True
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
    assert a.shape == (3, 1, 50) and a.dtype == torch.float32
    assert torch.equal(plain[0]["self_k"][:, :3].permute(1, 0, 2, 3).reshape(3, 3, 64),
                       kernel[0]["self_k_tnf"][:3])
    assert not plain[0]["self_k"][:, 3:].any()
