"""flake16_framework_tpu_torch: the Flake16 ML pipeline in PyTorch and CUDA
for one NVIDIA H100, beside the JAX package ``flake16_framework_tpu``.

It imports torch and numpy, never jax and nothing of the JAX package: it
keeps its own copies of the grid, the loader, the fold masks and the
synthetic dataset. Entry points run on ``cuda`` unless the caller passes
``device="cpu"``; the histogram step of the tree grower is a hand-written
CUDA kernel (``csrc/hist_cumsum.cu``).

This slice covers the ``scores`` verb for the Random Forest and Extra Trees
configs (144 of the 216).
"""

__version__ = "0.1.0"
