"""The port's flash-attention backward, LSE and training route against the JAX
package, on the CPU.

On CPU tensors ``flash_attention`` runs ``FlashAttentionFunction`` with the
plain versions of K4 (with LSE) and K5, what the CUDA kernels are held
against on the card. The JAX side is ``vilmedic_tpu.ops.flash_attention``'s
custom VJP with its Pallas backward kernels in interpret mode, through both
layouts: v2 (``_flash_bwd_bthd``, H*D a multiple of 128) and v1
(``_flash_bwd_bhtd``: D = 48, or ``VILMEDIC_FLASH_IMPL=v1``), with the 64-wide
blocks of ``tests/test_flash_attention.py``, so ragged axes are padded on the
JAX side and masked in the port.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vilmedic_torch.ops import attention as tattn
from vilmedic_torch.ops.flash_attention import (
    flash_attention, flash_attention_backward, flash_attention_backward_reference,
    flash_attention_reference, flash_attention_with_lse, pad_head_dim, padded_head_dim,
)
from vilmedic_tpu.ops import attention as jattn
from vilmedic_tpu.ops import flash_attention as jfa

# f32: sums in another order (the JAX kernels' 64-wide blocks, the port's one
# softmax), the tolerance of the JAX package's own flash tests
TOL = 2e-4
# bf16: both sides round p and dS to bf16 at the same points, but from f32
# values that differ in the last bits, so a rounded value can land one bf16
# step (2^-8 relative) apart; measured against the largest gradient entry
TOL_BF16 = 2e-2
# (heads, head dim, VILMEDIC_FLASH_IMPL): v2, v1 by layout, v1 by the switch
LAYOUTS = [(2, 64, "v2"), (2, 48, "v2"), (2, 64, "v1")]
# (Tq, Tk, causal): equal ragged axes, Tq < Tk under the causal mask (every
# row sees a key), and Tq > Tk without it
SHAPES = [(100, 100, True), (70, 130, True), (130, 70, False), (64, 128, False)]


def _inputs(seed, tq, tk, h, d, masked):
    rng = np.random.default_rng(seed)
    q, dout = (rng.normal(size=(2, tq, h, d)).astype(np.float32) for _ in range(2))
    k, v = (rng.normal(size=(2, tk, h, d)).astype(np.float32) for _ in range(2))
    mask = None
    if masked:  # a padded key tail on the second item; key 0 always kept
        mask = np.ones((2, tk), np.int32)
        mask[1, tk - 17:] = 0
    return q, k, v, dout, mask


def _jax_grads(q, k, v, dout, mask, causal, dtype):
    def f(q_, k_, v_):
        return jfa.flash_attention(q_, k_, v_, key_mask=None if mask is None else jnp.asarray(mask),
                                   block_q=64, block_k=64, interpret=True, causal=causal)

    args = [jnp.asarray(x, dtype) for x in (q, k, v)]
    out, vjp = jax.vjp(f, *args)
    grads = vjp(jnp.asarray(dout, dtype))
    return [np.asarray(x.astype(jnp.float32)) for x in (out, *grads)]


def _port_grads(q, k, v, dout, mask, causal, dtype):
    qt, kt, vt = (torch.from_numpy(x).to(dtype).requires_grad_() for x in (q, k, v))
    out = flash_attention(qt, kt, vt, None if mask is None else torch.from_numpy(mask),
                          causal=causal)
    out.backward(torch.from_numpy(dout).to(dtype))
    return [x.detach().float().numpy() for x in (out, qt.grad, kt.grad, vt.grad)]


@pytest.mark.parametrize("h,d,impl", LAYOUTS)
@pytest.mark.parametrize("tq,tk,causal", SHAPES)
@pytest.mark.parametrize("masked", [False, True])
def test_flash_grads_match_jax_f32(monkeypatch, h, d, impl, tq, tk, causal, masked):
    monkeypatch.setenv("VILMEDIC_FLASH_IMPL", impl)
    q, k, v, dout, mask = _inputs(tq + tk + d, tq, tk, h, d, masked)
    want = _jax_grads(q, k, v, dout, mask, causal, jnp.float32)
    got = _port_grads(q, k, v, dout, mask, causal, torch.float32)
    for name, g, w in zip(("out", "dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g, w, rtol=TOL, atol=TOL, err_msg=name)


@pytest.mark.parametrize("h,d,impl", LAYOUTS)
@pytest.mark.parametrize("tq,tk,causal", [(100, 100, True), (130, 70, False)])
def test_flash_grads_match_jax_bf16(monkeypatch, h, d, impl, tq, tk, causal):
    monkeypatch.setenv("VILMEDIC_FLASH_IMPL", impl)
    q, k, v, dout, mask = _inputs(7 + tq, tq, tk, h, d, True)
    want = _jax_grads(q, k, v, dout, mask, causal, jnp.bfloat16)
    got = _port_grads(q, k, v, dout, mask, causal, torch.bfloat16)
    for name, g, w in zip(("out", "dq", "dk", "dv"), got, want):
        scale = np.abs(w).max()
        assert np.abs(g - w).max() <= TOL_BF16 * scale, name


def _keybias(mask, tk):
    return jnp.zeros((2, tk), jnp.float32) if mask is None else jnp.where(
        jnp.asarray(mask) > 0, 0.0, jfa.NEG_INF).astype(jnp.float32)


@pytest.mark.parametrize("h,d,v2", [(2, 64, True), (2, 48, False)])
@pytest.mark.parametrize("causal", [False, True])
def test_dbias_matches_jax_keybias_grad(h, d, v2, causal):
    """dbias from the port's backward against the gradient of JAX's key bias
    through ``_flash_v2_diff`` / ``_flash_diff`` directly, as
    ``tests/test_flash_attention.py`` takes it."""
    tq, tk = 100, 130
    q, k, v, dout, mask = _inputs(11, tq, tk, h, d, True)
    bias = _keybias(mask, tk)
    if v2:
        def f(bias_):
            fold = lambda x: jnp.asarray(x).reshape(2, x.shape[1], h * d)  # noqa: E731
            return jfa._flash_v2_diff(fold(q), fold(k), fold(v), bias_, d, 64, 64, True, causal)
        dout_j = jnp.asarray(dout).reshape(2, tq, h * d)
    else:
        def f(bias_):
            return jfa._flash_diff(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), bias_, 64, 64,
                                   True, causal)
        dout_j = jnp.asarray(dout)
    _, vjp = jax.vjp(f, bias)
    want = np.asarray(vjp(dout_j)[0])
    qt, kt, vt, dt = (torch.from_numpy(x) for x in (q, k, v, dout))
    mt = torch.from_numpy(mask)
    out, lse = flash_attention_with_lse(qt, kt, vt, mt, causal)
    got = flash_attention_backward(qt, kt, vt, mt, out, lse, dt, causal)[3]
    assert got.shape == (2, tk) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("h,d,v2", [(2, 64, True), (4, 32, True), (2, 48, False)])
@pytest.mark.parametrize("causal", [False, True])
def test_lse_matches_jax(h, d, v2, causal):
    """The forward's per-row log-sum-exp (B, H, Tq) against JAX's
    ``with_lse`` residual, per head (v2: lane groups of each head pair; v1:
    (B*H) slabs), unpadded."""
    tq, tk = 100, 130
    q, k, v, _, mask = _inputs(12, tq, tk, h, d, True)
    bias = _keybias(mask, tk)
    if v2:
        fold = lambda x: jnp.asarray(x).reshape(2, x.shape[1], h * d)  # noqa: E731
        _, lse = jfa._flash_v2_forward(fold(q), fold(k), fold(v), bias, d, 64, 64, True, causal,
                                       with_lse=True)
        hpb = 128 // d
        lse = np.asarray(lse)  # (B, HP, Tqp, hpb * STATS_LANES)
        want = np.stack([lse[:, hh // hpb, :tq, (hh % hpb) * jfa.STATS_LANES]
                         for hh in range(h)], axis=1)
    else:
        _, lse = jfa._flash_forward(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), bias, 64, 64,
                                    True, causal, with_lse=True)
        want = np.asarray(lse).reshape(2, h, -1, jfa.STATS_LANES)[:, :, :tq, 0]
    _, got = flash_attention_reference(*(torch.from_numpy(x) for x in (q, k, v)),
                                       torch.from_numpy(mask), causal, return_lse=True)
    assert got.shape == (2, h, tq) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("d", [160, 256, 320])
@pytest.mark.parametrize("tq,tk,causal", [(100, 100, True), (70, 130, True), (130, 70, False)])
def test_wide_head_dims_match_jax_v1(d, tq, tk, causal):
    """Head dims above 128 (JAX's v1 path, which takes any D): the port's
    forward, LSE and gradients (its plain versions on the CPU) against JAX's
    in interpret mode, with a padded key tail; the LSE against the v1
    kernel's ``with_lse`` residual; and the backward as the card runs it
    (zero columns up to ``padded_head_dim``, the true scale) against the
    unpadded one."""
    q, k, v, dout, mask = _inputs(d + tq + tk, tq, tk, 2, d, True)
    want = _jax_grads(q, k, v, dout, mask, causal, jnp.float32)
    got = _port_grads(q, k, v, dout, mask, causal, torch.float32)
    for name, g, w in zip(("out", "dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g, w, rtol=TOL, atol=TOL, err_msg=name)
    _, jlse = jfa._flash_forward(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                 _keybias(mask, tk), 64, 64, True, causal, with_lse=True)
    qt, kt, vt, dt = (torch.from_numpy(x) for x in (q, k, v, dout))
    mt = torch.from_numpy(mask)
    out, lse = flash_attention_with_lse(qt, kt, vt, mt, causal)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse).reshape(2, 2, -1, jfa.STATS_LANES)
                               [:, :, :tq, 0], rtol=TOL, atol=TOL)
    width = padded_head_dim(d)
    padded = [pad_head_dim(x, width) for x in (qt, kt, vt, out, dt)]
    grads_p = flash_attention_backward_reference(*padded[:3], mt, padded[3], lse, padded[4],
                                                 causal, scale=d ** -0.5)
    grads = flash_attention_backward(qt, kt, vt, mt, out, lse, dt, causal)
    for gp, g in zip(grads_p[:3], grads[:3]):
        assert torch.equal(gp[..., d:], torch.zeros_like(gp[..., d:]))
        torch.testing.assert_close(gp[..., :d], g, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(grads_p[3], grads[3], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("causal", [False, True])
def test_autograd_runs_the_port_backward(causal):
    """On CPU tensors autograd goes through ``FlashAttentionFunction``: its
    gradients are exactly those of ``flash_attention_backward_reference``
    (with bf16 operands, so its rounding points are the ones taken)."""
    q, k, v, dout, mask = _inputs(13, 40, 50, 2, 32, True)
    qt, kt, vt = (torch.from_numpy(x).bfloat16().requires_grad_() for x in (q, k, v))
    mt, dt = torch.from_numpy(mask), torch.from_numpy(dout).bfloat16()
    out = flash_attention(qt, kt, vt, mt, causal)
    assert out.grad_fn is not None and "FlashAttentionFunction" in type(out.grad_fn).__name__
    out.backward(dt)
    with torch.no_grad():
        o, lse = flash_attention_reference(qt, kt, vt, mt, causal, return_lse=True)
        want = flash_attention_backward_reference(qt, kt, vt, mt, o, lse, dt, causal)
    torch.testing.assert_close(out.detach(), o, rtol=0, atol=0)
    for got, w in zip((qt.grad, kt.grad, vt.grad), want):
        torch.testing.assert_close(got, w, rtol=0, atol=0)


def test_no_grad_keeps_the_plain_forward():
    """Without grad the route is the plain forward, no Function node."""
    q, k, v, _, _ = _inputs(14, 20, 20, 2, 32, False)
    qt, kt, vt = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    with torch.no_grad():
        out = flash_attention(qt, kt, vt, causal=True)
    assert out.grad_fn is None
    torch.testing.assert_close(out, flash_attention_reference(qt, kt, vt, causal=True),
                               rtol=0, atol=0)


@pytest.mark.parametrize("train", [False, True])
def test_train_routing_matches_jax(monkeypatch, train):
    """``dot_product_attention(train=True)`` takes flash from
    ``FLASH_MIN_LEN_TRAIN`` (both packages' module globals, read at call
    time), ``train=False`` from ``FLASH_MIN_LEN``: at T = 100 with the
    thresholds 1024 / 64 only the training call routes to flash. Values and
    gradients agree with JAX either way."""
    for mod in (tattn, jattn):
        monkeypatch.setattr(mod, "FLASH_MIN_LEN", 1024)
        monkeypatch.setattr(mod, "FLASH_MIN_LEN_TRAIN", 64)
    calls = []
    real_flash = tattn.flash_attention

    def counting_flash(*args, **kwargs):
        calls.append(1)
        return real_flash(*args, **kwargs)

    monkeypatch.setattr(tattn, "flash_attention", counting_flash)
    q, k, v, dout, mask = _inputs(15, 100, 100, 2, 64, True)

    def f(q_, k_, v_):
        return jattn.dot_product_attention(q_, k_, v_, bias=jattn.make_attention_bias(
            jnp.asarray(mask)), causal=True, train=train)

    out_j, vjp = jax.vjp(f, *(jnp.asarray(x) for x in (q, k, v)))
    grads_j = vjp(jnp.asarray(dout))
    qt, kt, vt = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = tattn.dot_product_attention(qt, kt, vt, bias=tattn.make_attention_bias(
        key_mask=torch.from_numpy(mask)), causal=True, train=train)
    out.backward(torch.from_numpy(dout))
    assert len(calls) == (1 if train else 0)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_j), rtol=TOL, atol=TOL)
    for g, w in zip((qt.grad, kt.grad, vt.grad), grads_j):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=TOL, atol=TOL)
