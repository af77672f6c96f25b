"""ViLMedic in PyTorch with hand-written CUDA kernels for NVIDIA Hopper.

The port of ``vilmedic_tpu`` (JAX on TPU), which stays in the repository as
the reference. This package imports ``torch`` and never ``jax``, ``flax`` or
``vilmedic_tpu``. It covers beam-8 report generation with the flagship RRG
(uint8 images through DenseNet-169 and a cross-attention decoder,
``models.evaluation_nlg.make_generate_fn``, with its ensembling, greedy,
small-vocabulary and cache-permute routes); generation with VisionLanguage
(float images through DINOv2 and a prefix-conditioned causal LM,
``models.vision_language.make_vl_generate_fn``: the merge, int8-cache,
fused-prefix, permute, greedy and small-vocabulary routes); VisionLanguage
training steps (``executors.Trainor``); and RRG training and evaluation end
to end through ``python -m vilmedic_torch.bin.train`` (``data``, the
``Trainor``'s epoch loop with checkpoints, the ``Validator`` and the host
NLG ``scorers``); SCST fine-tuning of RRG and RRS (``models.scst_models``:
sampled rollouts from ``decoding``, host rewards from ``blocks.rl.scst``),
RRG_FORCE's constrained decoding and RRS (findings -> impression, a text
encoder and the decoder) through the same CLI; RRG with a trainable ViT
tower, and the MVQA / CLASS classifiers (ResNet or ViT towers, a
set transformer, ``models.mvqa``) through the same CLI, the ensemble CLI
(``bin.ensemble``) and the metrics CLI (``bin.vilmedic_metrics``: BLEU and
ROUGE-L on a native C++ core, METEOR, CIDEr-D, SPICE, the classification
metrics); with the fused LM-head top-k (``ops.fused_lm_head``) and the fp8
probes (``ops.fp8_probe``) as their own entry points. Every Pallas
kernel of the JAX package has a CUDA counterpart. Entry points build on the
CUDA device unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
