"""kvq_tpu_torch — the PyTorch/CUDA port of kvq_tpu for NVIDIA Hopper.

Imports torch, numpy and scipy only; nothing of JAX or of ``kvq_tpu``.
Entry points (``models.vqa_network.build_model``,
``train.evaluator.Evaluator``) run on ``device="cuda"`` unless the caller
passes ``device="cpu"``.
"""
