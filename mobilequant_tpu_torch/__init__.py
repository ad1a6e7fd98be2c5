"""mobilequant_tpu_torch: the PyTorch/CUDA port of mobilequant_tpu.

The W4A8 integer engine on an NVIDIA Hopper GPU: prefill and decode of a
packed model through hand-written CUDA kernels (ops/, csrc/), with a plain
PyTorch version beside every kernel. The port imports torch and numpy, never
jax and nothing of the JAX package.
"""
