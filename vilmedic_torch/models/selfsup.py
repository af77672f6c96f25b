"""Self-supervised contrastive pretraining: ConVIRT and GLoRIA (port of
``models/selfsup.py``), the models of ``config/SELFSUP``.

- :class:`ConVIRTModule`: a :class:`~..blocks.transformer.TransformerEncoder`
  (``linguistic``), a tanh pooler on token 0 and the text projection
  ``lin_proj``; the ``cnn:`` tower (``visual``, a ``VisualEncoder``), mean
  pooled over its tokens when it returns (B, S, C), and ``vis_proj``. Both
  projections are :class:`MLPProjection`. :class:`ConVIRT` scores the pair
  with ``loss.proto`` (``ConVIRTLoss`` in the config); ``cnn.freeze`` keeps
  the tower out of training; ``forward_batch_size`` (the reference's chunked
  forward) is accepted and ignored, as in the JAX package: the whole batch
  runs at once.
- :class:`GLoRIAModule`: a ResNet to ``avgpool`` that also returns its
  ``layer3`` map (``capture_layer``; resnet50: 14 x 14 regions of 1024 at
  224²), the text encoder, and the global / local / word / sentence
  embedders to ``feature_dim``; the sentence embedding is the masked mean of
  the encoder's output. :class:`GLoRIA` sums word-piece embeddings into
  whole words (:meth:`GLoRIA._aggregate_words`) before ``GLoRIALoss``.

Both return ``{"loss", ...}`` in training, and their ``eval_func`` returns
the mean loss over a split (the Validator's ``validation_loss``), with the
embeddings when the Validator is not called from training (the ensemble
CLI), as the JAX package's do. A pretrained ``encoder.proto`` resolves
through :func:`~.base.resolve_block` (a local HF config, or JAX's warning
and the explicit keys); weights beside that config are not loaded, as the
JAX package builds these two from the config alone (no
``pretrained_blocks``).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .. import registry
from ..blocks import losses  # noqa: F401  (registers the losses)
from ..blocks.losses import GLoRIALoss
from ..blocks.transformer import Linear, TransformerConfig, TransformerEncoder
from ..blocks.vision.resnet import make_resnet
from ..blocks.vision.visual_encoder import VisualEncoder, build_visual_encoder
from ..config.config import Config
from ..data.image import prepare_batch
from ..parallel import mesh
from .base import in_transformer_layer, init_weights_, loader_crop, resolve_block, resolve_device
from .evaluation_nlg import to_device


def _d(cfg) -> Dict:
    return cfg.to_dict() if isinstance(cfg, Config) else dict(cfg or {})


def _first(loss):
    """A loss's value where it returns ``(loss, per-row terms...)``."""
    return loss[0] if isinstance(loss, tuple) else loss


def _compute_dtype(dtype) -> torch.dtype:
    return torch.bfloat16 if str(dtype) in ("bfloat16", "bf16") else torch.float32


def _encoder_config(encoder, dl, vocab_size, dtype) -> TransformerConfig:
    """The text encoder's config: ``encoder:`` resolved, the vocabulary size
    from the loader's tokenizer (else ``vocab_size``, else the block's)."""
    if dl is not None:
        vocab_size = dl.dataset.tokenizer.vocab_size
    return TransformerConfig.from_dict(resolve_block(encoder)[0],
                                       **({"vocab_size": vocab_size} if vocab_size else {}),
                                       dtype=dtype)


class MLPProjection(nn.Module):
    """``fc2(relu(fc1(x)))``, both to ``dim``."""

    def __init__(self, n_in: int, dim: int, dtype: torch.dtype):
        super().__init__()
        self.fc1 = Linear(n_in, dim, dtype)
        self.fc2 = Linear(dim, dim, dtype)

    def forward(self, x):
        return self.fc2(F.relu(self.fc1(x)))


class ConVIRTModule(nn.Module):
    def __init__(self, enc_config: TransformerConfig, visual: VisualEncoder, projection_dim: int):
        super().__init__()
        h, dt = enc_config.hidden_size, enc_config.dtype
        self.linguistic = TransformerEncoder(enc_config)
        self.pooler = Linear(h, h, dt)
        self.lin_proj = MLPProjection(h, projection_dim, dt)
        self.vis_proj = MLPProjection(visual.width, projection_dim, dt)
        self.visual = visual

    def forward(self, input_ids, attention_mask, images, train: bool = False,
                generator: Optional[torch.Generator] = None):
        """-> (linguistic, visual) (B, projection_dim) in the compute dtype.
        ``train``: the tower's batch statistics (pending, for the trainer to
        commit) and dropout from ``generator``."""
        gen = generator if train else None
        hidden = self.linguistic(input_ids, attention_mask, train=train, generator=gen)
        linguistic = self.lin_proj(torch.tanh(self.pooler(hidden[:, 0])))
        v = self.visual(images, train, gen)
        if v.ndim == 3:  # token outputs (a ViT, a feature map) -> mean pool
            v = v.mean(dim=1)
        return linguistic, self.vis_proj(v)


class _SelfSupModel:
    """What ConVIRT and GLoRIA share: random weights from ``seed`` on the
    device, and the training / eval entry points over :meth:`_apply`. Across
    several processes their losses run over every process's rows
    (``parallel.mesh.loss_over_global_rows``), as the JAX package's over its
    global batch."""

    module: nn.Module

    def _place(self, std: float, seed: int, device) -> None:
        init_weights_(self.module, torch.Generator().manual_seed(seed), std,
                      in_transformer_layer)
        self.module.to(device).eval()

    def apply_train(self, batch, generator: Optional[torch.Generator] = None) -> Dict:
        """One training forward over ``{"input_ids", "attention_mask",
        "images"}``, with the graph for the backward; BatchNorm's batch
        statistics wait as pending statistics for the trainer to commit."""
        return self._apply(batch, True, generator)

    @torch.no_grad()
    def apply_eval(self, batch) -> Dict:
        return self._apply(batch, False)


def _mean_loss_evaluation(keys):
    """An ``eval_func`` over the model's :meth:`apply_eval`: the mean of
    the batches' losses, and, outside training, the concatenated ``keys``
    (result key, output key) as numpy arrays."""

    def evaluation(models, config, dl, from_training: bool = True, **kwargs) -> Dict:
        model = models[0]
        device = next(model.module.parameters()).device
        losses, kept = [], {k: [] for k, _ in keys}
        for batch in dl:
            out = model.apply_eval(prepare_batch(to_device(batch, device), dl.dataset))
            losses.append(float(out["loss"]))
            if not from_training:
                for key, name in keys:
                    kept[key].append(out[name].float().cpu().numpy())
        result = {"loss": float(np.mean(losses))}
        if not from_training:
            result.update({k: np.concatenate(v) for k, v in kept.items()})
        return result

    return evaluation


convirt_evaluation = _mean_loss_evaluation((("linguistic", "linguistic"),
                                            ("visual", "visual")))
gloria_evaluation = _mean_loss_evaluation((("visual", "global"), ("linguistic", "sent")))


@registry.register("model")
class ConVIRT(_SelfSupModel):
    """Host-side task model around :class:`ConVIRTModule`, built from a
    config's ``model:`` block (module doc). Builds on the card unless
    ``device`` names another."""

    def __init__(self, encoder, cnn, projection, loss, forward_batch_size=None, dl=None,
                 dtype="float32", vocab_size: Optional[int] = None, device="cuda",
                 seed: int = 0, **kwargs):
        device = resolve_device(device)
        compute_dtype = _compute_dtype(dtype)
        projection, loss = _d(projection), _d(loss)
        self.enc_config = _encoder_config(encoder, dl, vocab_size, compute_dtype)
        self.loss_fn = registry.get("loss", loss.pop("proto"))(**loss)
        self.frozen_prefixes = ("visual/model",) if _d(cnn).get("freeze") else ()
        self.module = ConVIRTModule(
            self.enc_config, build_visual_encoder(cnn, dtype=compute_dtype, crop=loader_crop(dl)),
            int(projection.get("projection_dim", 768)))
        self._place(self.enc_config.initializer_range, seed, device)
        self.eval_func = convirt_evaluation

    def _apply(self, batch, train: bool, generator=None) -> Dict:
        linguistic, visual = self.module(batch["input_ids"], batch["attention_mask"],
                                         batch["images"], train, generator)
        loss = mesh.loss_over_global_rows(lambda *rows: _first(self.loss_fn(*rows)),
                                          linguistic, visual)
        return {"loss": loss, "linguistic": linguistic, "visual": visual}

    def __repr__(self):
        return "model: ConVIRT"


class GLoRIAModule(nn.Module):
    def __init__(self, enc_config: TransformerConfig, backbone: str = "resnet50",
                 feature_dim: int = 768, local_layer: str = "layer3"):
        super().__init__()
        h, dt = enc_config.hidden_size, enc_config.dtype
        self.cnn = make_resnet(backbone, "avgpool", dtype=dt, capture_layer=local_layer)
        self.text_encoder = TransformerEncoder(enc_config)
        self.global_embedder = Linear(self.cnn.out_channels, feature_dim, dt)
        self.local_embedder = Linear(self.cnn.captured_channels, feature_dim, dt)
        self.word_embedder = Linear(h, feature_dim, dt)
        self.sent_embedder = Linear(h, feature_dim, dt)

    def forward(self, input_ids, attention_mask, images, train: bool = False,
                generator: Optional[torch.Generator] = None) -> Dict:
        """-> global (B, F), local (B, h*w, F) (the captured map's regions in
        row-major order), word (B, T, F) and sentence (B, F) embeddings and
        the word mask (B, T) f32."""
        global_feat, local_map = self.cnn(images, train)
        b, c = local_map.shape[0], local_map.shape[-1]
        hidden = self.text_encoder(input_ids, attention_mask, train=train,
                                   generator=generator if train else None)
        mask_f = attention_mask.float()
        count = mask_f.sum(dim=1, keepdim=True).clamp_min(1.0)
        pooled = (hidden * mask_f[:, :, None]).sum(dim=1) / count
        return {
            "global_features": self.global_embedder(global_feat),
            "local_features": self.local_embedder(local_map.reshape(b, -1, c)),
            "word_embeddings": self.word_embedder(hidden),
            "sent_embeddings": self.sent_embedder(pooled),
            "words_mask": mask_f,
        }


@registry.register("model")
class GLoRIA(_SelfSupModel):
    """Host-side task model around :class:`GLoRIAModule` (module doc).
    With a loader (its tokenizer's vocabulary) and ``aggregate_words``,
    word pieces are summed into whole words for the local loss. Builds on
    the card unless ``device`` names another."""

    def __init__(self, encoder=None, cnn=None, loss=None, dl=None, dtype="float32",
                 aggregate_words: bool = True, vocab_size: Optional[int] = None, device="cuda",
                 seed: int = 0, **kwargs):
        device = resolve_device(device)
        compute_dtype = _compute_dtype(dtype)
        loss, cnn = _d(loss or {"proto": "GLoRIALoss"}), _d(cnn)
        loss.pop("proto", None)
        self.enc_config = _encoder_config(encoder, dl, vocab_size, compute_dtype)
        self.loss_fn = GLoRIALoss(**loss)
        self.module = GLoRIAModule(self.enc_config, cnn.get("backbone", "resnet50"),
                                   int(cnn.get("feature_dim", 768)))
        self._place(self.enc_config.initializer_range, seed, device)
        self.eval_func = gloria_evaluation
        # whole-word tables over the tokenizer's vocabulary: "##" pieces
        # continue a word; [CLS] and [PAD] are dropped
        self._cont_table = self._drop_table = None
        tokenizer = dl.dataset.tokenizer if dl is not None else None
        if aggregate_words and tokenizer is not None:
            vocab = tokenizer.vocab
            cont = torch.zeros(len(vocab), dtype=torch.bool)
            drop = torch.zeros(len(vocab), dtype=torch.bool)
            for tok, idx in vocab.items():
                cont[idx] = tok.startswith("##")
            for tok in (tokenizer.cls_token, tokenizer.pad_token):
                if tok in vocab:
                    drop[vocab[tok]] = True
            self._cont_table, self._drop_table = cont.to(device), drop.to(device)

    def _aggregate_words(self, word_emb, input_ids, attention_mask):
        """Sum word-piece embeddings per whole word: -> (embeddings (B, T,
        F), word mask (B, T) f32). Word w of a row is its w-th token that
        starts a word (not "##", not dropped, under the mask); [SEP] stays a
        word. Empty slots hold 1.0 (masked out of the loss; zeros would be
        0/0 in its cosine)."""
        t = input_ids.shape[1]
        cont = self._cont_table[input_ids]
        keep = ~self._drop_table[input_ids] & (attention_mask > 0)
        word_ids = torch.cumsum((~cont & keep).int(), dim=1) - 1
        valid = keep & (word_ids >= 0)
        oh = F.one_hot(torch.where(valid, word_ids, torch.full_like(word_ids, t)).long(),
                       t + 1)[..., :t].to(word_emb.dtype)  # (B, T_token, T_word)
        agg = torch.einsum("btw,btd->bwd", oh, word_emb)
        word_mask = (oh.float().sum(dim=1) > 0).float()
        agg = torch.where(word_mask[..., None] > 0, agg, torch.ones((), dtype=agg.dtype,
                                                                     device=agg.device))
        return agg, word_mask

    def _apply(self, batch, train: bool, generator=None) -> Dict:
        out = self.module(batch["input_ids"], batch["attention_mask"], batch["images"], train,
                          generator)
        words, mask = out["word_embeddings"], out["words_mask"]
        if self._cont_table is not None:
            words, mask = self._aggregate_words(words, batch["input_ids"],
                                                batch["attention_mask"])
        # empty word slots hold 1.0 and mask 0, as the longest batch pads them
        loss = mesh.loss_over_global_rows(self.loss_fn, out["global_features"],
                                          out["local_features"], (words, 1.0),
                                          out["sent_embeddings"], (mask, 0.0))
        return {"loss": loss, "global": out["global_features"], "sent": out["sent_embeddings"]}

    # -- inference: the reference's zero-shot API --------------------------
    @torch.no_grad()
    def get_similarities(self, images, texts_input_ids, texts_attention_mask) -> np.ndarray:
        """Global cosine similarity (B_images, B_texts) between each image
        and each text."""
        out = self.module(texts_input_ids, texts_attention_mask, images)
        img = out["global_features"].float()
        txt = out["sent_embeddings"].float()
        img = img / torch.linalg.vector_norm(img, dim=-1, keepdim=True)
        txt = txt / torch.linalg.vector_norm(txt, dim=-1, keepdim=True)
        return (img @ txt.t()).cpu().numpy()

    def zero_shot_classification(self, images, class_prompts: Dict[str, Dict]):
        """Class name -> tokenized prompts (``input_ids``, ``attention_mask``);
        returns each image's class: the highest mean similarity over the
        class's prompts."""
        names = list(class_prompts)
        sims = np.stack([self.get_similarities(images, class_prompts[n]["input_ids"],
                                               class_prompts[n]["attention_mask"]).mean(axis=1)
                         for n in names], axis=1)  # (B, n_classes)
        return [names[i] for i in sims.argmax(axis=1)]

    def __repr__(self):
        return "model: GLoRIA"
