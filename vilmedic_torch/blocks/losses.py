"""Losses (port of ``blocks/losses.py``), registered under the config's
``loss.proto`` names. All compute in f32 whatever their inputs' dtype.

Classification:

- :func:`cross_entropy`: ``torch.nn.CrossEntropyLoss`` semantics with
  ``ignore_index`` (-100): the mean over the rows that count (at least 1;
  the global batch's in a multi-process training forward);
- ``BCEWithLogitsLoss``: ``max(x, 0) - x * t + log1p(exp(-|x|))``;
- in a multi-process training forward the classification losses' means
  are the global batch's (:func:`mean_over_rows`);
- ``LabelSmoothingCrossEntropy`` (the reference's MVQA loss):
  ``smoothing / C * (-sum of log-softmax)`` plus ``(1 - smoothing)`` times
  the cross entropy, each reduced by ``reduction``;
- ``SuperLoss`` (confidence-aware: the Lambert-W closed form by 8 Newton
  steps) and ``MixUpLoss`` (``lam`` times the criterion on ``label`` plus
  ``1 - lam`` times it on ``label_mixed``).

Contrastive self-supervision (the SELFSUP models):

- ``ConVIRTLoss``: bidirectional NT-Xent over L2-normalized (eps 1e-8)
  embeddings, ``lambda_`` on the image-to-text side;
- ``InfoNCELoss``: the symmetric cross entropy of ``l @ v.T``;
- ``VICREGLoss``: invariance, variance (biased, plus 1e-4 under the root)
  and covariance (unbiased, off-diagonal) terms;
- :func:`gloria_attention` and ``GLoRIALoss``: GLoRIA's global loss and its
  local loss batched over the (text, image) grid: the first softmax (over
  words) fills masked word slots with -1e9, the second (over regions) runs
  at ``temp1``; each caption's cosine rows are summed under its word mask.
"""

from __future__ import annotations

import math

import torch

from ..parallel.mesh import global_mean
from ..registry import register

EPS = 1e-8


def cross_entropy(logits, labels, reduction: str = "mean", ignore_index: int = -100):
    log_probs = torch.log_softmax(logits.float(), dim=-1)
    labels = labels.long()
    valid = labels != ignore_index
    safe = torch.where(valid, labels, torch.zeros_like(labels))
    nll = -log_probs.gather(-1, safe[..., None])[..., 0]
    nll = torch.where(valid, nll, torch.zeros_like(nll))
    if reduction == "none":
        return nll
    if reduction == "sum":
        return nll.sum()
    return global_mean(nll.sum(), valid.sum())


def mean_over_rows(x):
    """``x.mean()``; in a multi-process training forward the mean over the
    global batch's entries (``parallel.mesh.global_mean``)."""
    return global_mean(x.sum(), torch.tensor(x.numel(), device=x.device))


def binary_cross_entropy_with_logits(logits, targets, reduction: str = "mean"):
    x = logits.float()
    loss = torch.clamp_min(x, 0) - x * targets + torch.log1p(torch.exp(-x.abs()))
    if reduction == "none":
        return loss
    return loss.sum() if reduction == "sum" else mean_over_rows(loss)


@register("loss", "CrossEntropyLoss")
class CrossEntropyLoss:
    def __init__(self, reduction: str = "mean", ignore_index: int = -100, **kwargs):
        self.reduction = reduction
        self.ignore_index = ignore_index

    def __call__(self, logits, labels, **kwargs):
        return cross_entropy(logits, labels, self.reduction, self.ignore_index)


@register("loss", "BCEWithLogitsLoss")
class BCEWithLogitsLoss:
    def __init__(self, reduction: str = "mean", **kwargs):
        self.reduction = reduction

    def __call__(self, logits, targets, **kwargs):
        return binary_cross_entropy_with_logits(logits, targets, self.reduction)


@register("loss", "LabelSmoothingCrossEntropy")
class LabelSmoothingCrossEntropy:
    def __init__(self, smoothing: float = 0.1, reduction: str = "mean", **kwargs):
        self.smoothing = smoothing
        self.reduction = reduction

    def __call__(self, output, target, **kwargs):
        c = output.shape[-1]
        log_preds = torch.log_softmax(output.float(), dim=-1)
        if self.reduction == "sum":
            loss = -log_preds.sum()
        else:
            loss = -log_preds.sum(dim=-1)
            if self.reduction == "mean":
                loss = mean_over_rows(loss)
        nll = cross_entropy(output, target, self.reduction)
        return loss * self.smoothing / c + (1 - self.smoothing) * nll


@register("loss", "SuperLoss")
class SuperLoss:
    """Confidence-aware loss over per-sample losses ``l_i`` (the reference's
    mvqa ``SuperLoss``)."""

    def __init__(self, C, lam: float = 0.25, **kwargs):
        self.tau = float(torch.log(torch.tensor(float(C))))
        self.lam = lam

    @staticmethod
    def _lambertw(y, iters: int = 8):
        # Newton's steps for w e^w = y on the principal branch, y >= -1/e
        w = torch.where(y > 0, torch.log1p(y), torch.full_like(y, -0.5))
        for _ in range(iters):
            ew = torch.exp(w)
            w = w - (w * ew - y) / (ew * (w + 1) + EPS)
        return w

    def __call__(self, l_i, **kwargs):
        l_i = l_i.float()
        y = 0.5 * torch.clamp_min((l_i.detach() - self.tau) / self.lam, -2.0 / math.e)
        sigma = torch.exp(-self._lambertw(y))
        loss = (l_i - self.tau) * sigma + self.lam * torch.log(sigma) ** 2
        return mean_over_rows(loss)


@register("loss", "MixUpLoss")
class MixUpLoss:
    def __init__(self, criterion: str = "CrossEntropyLoss", **kwargs):
        from .. import registry

        self.criterion = registry.get("loss", criterion)(**kwargs)

    def __call__(self, pred, label, label_mixed, lam, **kwargs):
        return lam * self.criterion(pred, label) + (1 - lam) * self.criterion(pred, label_mixed)


# ---------------------------------------------------------------------------
# Contrastive self-supervision
# ---------------------------------------------------------------------------

def l2_normalize(x, dim: int = -1):
    return x / torch.linalg.vector_norm(x, dim=dim, keepdim=True).clamp_min(EPS)


@register("loss", "ConVIRTLoss")
class ConVIRTLoss:
    """Returns ``(loss, loss_l (B,), loss_v (B,))``."""

    def __init__(self, tau, lambda_, **kwargs):
        self.tau = tau
        self.lambda_ = lambda_

    def __call__(self, linguistic, visual, **kwargs):
        ln = l2_normalize(linguistic.float())
        vn = l2_normalize(visual.float())
        nominator = torch.exp((ln * vn).sum(dim=-1) / self.tau)  # exp(cos(l_i, v_i) / tau)
        pairwise = ln @ vn.t()  # (B, B)
        loss_l = -torch.log(nominator / torch.exp(pairwise / self.tau).sum(dim=1))
        loss_v = -torch.log(nominator / torch.exp(pairwise.t() / self.tau).sum(dim=1))
        loss = (self.lambda_ * loss_v + (1 - self.lambda_) * loss_l).mean()
        return loss, loss_l, loss_v


@register("loss", "InfoNCELoss")
class InfoNCELoss:
    """Returns ``(loss, loss_t (B,), loss_i (B,))``."""

    def __init__(self, tau: float = 1.0, **kwargs):
        self.tau = tau

    def __call__(self, linguistic, visual, **kwargs):
        logits = linguistic.float() @ visual.float().t()
        labels = torch.arange(logits.shape[0], device=logits.device)
        loss_t = cross_entropy(logits, labels, reduction="none")
        loss_i = cross_entropy(logits.t(), labels, reduction="none")
        return ((loss_i + loss_t) / 2).mean(), loss_t, loss_i


@register("loss", "VICREGLoss")
class VICREGLoss:
    def __init__(self, sim_loss_weight: float = 25.0, var_loss_weight: float = 25.0,
                 cov_loss_weight: float = 1.0, **kwargs):
        self.sim_loss_weight = sim_loss_weight
        self.var_loss_weight = var_loss_weight
        self.cov_loss_weight = cov_loss_weight

    @staticmethod
    def _var(z):
        std = torch.sqrt(z.var(dim=0, unbiased=False) + 1e-4)
        return torch.relu(1.0 - std).mean()

    @staticmethod
    def _cov(z):
        n, d = z.shape
        zc = z - z.mean(dim=0)
        cov = (zc.t() @ zc) / (n - 1)
        off = cov - torch.diag(torch.diag(cov))
        return (off ** 2).sum() / d

    def __call__(self, z1, z2, **kwargs):
        z1, z2 = z1.float(), z2.float()
        sim = ((z1 - z2) ** 2).mean()
        var = self._var(z1) + self._var(z2)
        cov = self._cov(z1) + self._cov(z2)
        return self.sim_loss_weight * sim + self.var_loss_weight * var + self.cov_loss_weight * cov


def _word_region_attention(scores, word_mask, temp1: float):
    """(..., S, T) region-word scores -> (..., T, S) attention: a softmax
    over the words (masked slots at -1e9, so an all-masked caption degrades
    to a uniform softmax, not NaN), then one over the regions at
    ``temp1``."""
    if word_mask is not None:
        scores = torch.where(word_mask[..., None, :] > 0, scores, torch.full_like(scores, -1e9))
    attn = torch.softmax(scores, dim=-1).transpose(-1, -2)
    return torch.softmax(attn * temp1, dim=-1)


def gloria_attention(word, context, temp1: float, word_mask=None):
    """GLoRIA's word-to-region attention: ``word`` (B, T, D) queries,
    ``context`` (B, S, D) regions, ``word_mask`` (B, T). Returns the
    attention-weighted context (B, T, D) and the attention (B, T, S)."""
    attn = _word_region_attention(torch.einsum("bsd,btd->bst", context, word), word_mask, temp1)
    return torch.einsum("bts,bsd->btd", attn, context), attn


@register("loss", "GLoRIALoss")
class GLoRIALoss:
    """Global + local contrastive loss: ``(local both ways) *
    local_loss_weight + (global both ways) * global_loss_weight``."""

    def __init__(self, local_loss_weight: float = 1.0, global_loss_weight: float = 1.0,
                 temp1: float = 4.0, temp2: float = 5.0, temp3: float = 10.0, **kwargs):
        self.local_loss_weight = local_loss_weight
        self.global_loss_weight = global_loss_weight
        self.temp1, self.temp2, self.temp3 = temp1, temp2, temp3

    def global_loss(self, cnn_code, rnn_code):
        scores = l2_normalize(cnn_code.float()) @ l2_normalize(rnn_code.float()).t() * self.temp3
        labels = torch.arange(scores.shape[0], device=scores.device)
        return cross_entropy(scores, labels), cross_entropy(scores.t(), labels)

    def local_loss(self, img_features, words_emb, words_mask):
        """``img_features`` (B, S, D), ``words_emb`` (B, T, D),
        ``words_mask`` (B, T). Caption i against every image j on a (B, B)
        grid: ``sims[i, j] = log(sum_t mask[i, t] exp(temp2 cos(word_it,
        weighted_ijt)))``, then the cross entropy both ways at ``temp3``."""
        b = img_features.shape[0]
        img = img_features.float()
        words = words_emb.float()
        mask = words_mask.float()
        scores = torch.einsum("jsd,itd->ijst", img, words)  # (B_text, B_image, S, T)
        attn = _word_region_attention(scores, mask[:, None], self.temp1)
        weighted = torch.einsum("ijts,jsd->ijtd", attn, img)
        cos = (l2_normalize(words)[:, None] * l2_normalize(weighted)).sum(dim=-1)  # (B, B, T)
        row = torch.exp(cos * self.temp2) * mask[:, None]
        sims = torch.log(row.sum(dim=-1).clamp_min(EPS)) * self.temp3
        labels = torch.arange(b, device=sims.device)
        return cross_entropy(sims, labels), cross_entropy(sims.t(), labels)

    def __call__(self, global_features, local_features, word_embeddings, sent_embeddings,
                 words_mask, **kwargs):
        l0, l1 = self.local_loss(local_features, word_embeddings, words_mask)
        g0, g1 = self.global_loss(global_features, sent_embeddings)
        return (l0 + l1) * self.local_loss_weight + (g0 + g1) * self.global_loss_weight
