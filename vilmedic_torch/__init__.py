"""ViLMedic in PyTorch with hand-written CUDA kernels for NVIDIA Hopper.

The port of ``vilmedic_tpu`` (JAX on TPU), which stays in the repository as
the reference. This package imports ``torch`` and never ``jax``, ``flax`` or
``vilmedic_tpu``. It covers five slices: beam-8
report generation with the flagship RRG (uint8 images through DenseNet-169
and a cross-attention decoder, ``models.evaluation_nlg.make_generate_fn``);
beam-8 generation with VisionLanguage (float images through DINOv2 and a
prefix-conditioned causal LM, ``models.vision_language.make_vl_generate_fn``);
its serving routes with the int8 prefix and generated caches and with the
fused prefix (the same function's ``prefix_kv_dtype``, ``gen_kv_dtype`` and
``fused_prefix``); VisionLanguage training steps (``executors.Trainor``); and
the RRG's ensembling, greedy, small-vocabulary and cache-permute decode
routes (``make_generate_fn`` with several models, with ``beam_width=1``, or
over a decoder whose head dim the beam-cache kernel is not built for), with
the fused LM-head top-k (``ops.fused_lm_head``)
and the fp8 probes (``ops.fp8_probe``) as their own entry points. Every
Pallas kernel of the JAX package has a CUDA counterpart. Entry points build
on the CUDA device unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
