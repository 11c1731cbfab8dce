"""PyTorch/CUDA port of the Spindle reproduction for NVIDIA Hopper.

The JAX package ``repro`` is the reference; this package mirrors its module
layout and is held against it by ``tests/test_torch_*.py``.  It imports
``torch`` and never ``jax`` or ``repro``.  The ported slice is paged-KV
serving of decoder-only dense models:
``repro_torch.launch.serve.serve`` → :class:`~repro_torch.serving.session.
ServingSession` → :class:`~repro_torch.serving.batcher.ContinuousBatcher` →
``Transformer.prefill`` / ``decode_step``, with the flash-attention forward
and paged-decode attention as hand-written CUDA kernels
(``repro_torch/csrc``).
"""
