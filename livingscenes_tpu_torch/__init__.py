"""PyTorch and CUDA port of livingscenes_tpu for NVIDIA Hopper.

The JAX package `livingscenes_tpu` is the reference; this package imports
nothing of it, nor JAX. Entry points run on the card unless given
`device="cpu"`. Kernels: csrc/*.cu, built with nvcc at first use
(ops/_cuda.py).
"""
