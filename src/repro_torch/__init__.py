"""PyTorch/CUDA port of the Spindle reproduction for NVIDIA Hopper.

The JAX package ``repro`` is the reference; this package mirrors its module
layout and is held against it by ``tests/test_torch_*.py``.  It imports
``torch`` and never ``jax`` or ``repro``.  The ported slices are paged-KV
serving of dense, MoE and hybrid decoders, replanned on mix shifts by the
Spindle planner (``repro_torch.core``, ``repro_torch.session``):
``repro_torch.launch.serve.serve`` → :class:`~repro_torch.serving.session.
ServingSession` → :class:`~repro_torch.serving.batcher.ContinuousBatcher` →
``Transformer.prefill`` / ``decode_step``, with every kernel of that path
hand-written in CUDA (``repro_torch/csrc``).
"""
