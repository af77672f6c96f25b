"""ViLMedic in PyTorch with hand-written CUDA kernels for NVIDIA Hopper.

The port of ``vilmedic_tpu`` (JAX on TPU), which stays in the repository as
the reference. This package imports ``torch`` and never ``jax``, ``flax`` or
``vilmedic_tpu``. It covers four slices: beam-8
report generation with the flagship RRG (uint8 images through DenseNet-169
and a cross-attention decoder, ``models.evaluation_nlg.make_generate_fn``);
beam-8 generation with VisionLanguage (float images through DINOv2 and a
prefix-conditioned causal LM, ``models.vision_language.make_vl_generate_fn``);
its serving routes with the int8 prefix and generated caches and with the
fused prefix (the same function's ``prefix_kv_dtype``, ``gen_kv_dtype`` and
``fused_prefix``); and VisionLanguage training steps (``executors.Trainor``).
Entry points build on the CUDA device unless the caller passes
``device="cpu"``.
"""

__version__ = "0.1.0"
