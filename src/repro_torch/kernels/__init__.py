"""Hand-written CUDA kernels and their plain PyTorch versions.

``ops`` is the entry point the model calls; ``ref`` holds the plain
versions; ``flash_attention`` / ``paged_attention`` / ``grouped_matmul``
/ ``rglru_scan`` wrap the CUDA sources in ``repro_torch/csrc``; ``build``
compiles and binds them at first use.
"""
