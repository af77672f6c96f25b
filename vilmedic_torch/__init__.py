"""ViLMedic in PyTorch with hand-written CUDA kernels for NVIDIA Hopper.

The port of ``vilmedic_tpu`` (JAX on TPU), which stays in the repository as
the reference. This package imports ``torch`` and never ``jax``, ``flax`` or
``vilmedic_tpu``. It covers two beam-8 report-generation slices: the
flagship RRG (uint8 images through DenseNet-169 and a cross-attention
decoder, ``models.evaluation_nlg.make_generate_fn``) and VisionLanguage
(float images through DINOv2 and a prefix-conditioned causal LM,
``models.vision_language.make_vl_generate_fn``).
"""

__version__ = "0.1.0"
