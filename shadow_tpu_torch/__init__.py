"""shadow_tpu_torch: the PyTorch and CUDA port of shadow_tpu.

The port runs the device engine of shadow_tpu (the `tpu` scheduler
policy on model workloads) on an NVIDIA H100, with the hot path in
CUDA kernels written by hand (shadow_tpu_torch/csrc/). It imports
torch, numpy and pyyaml, never jax and never the shadow_tpu package:
where it needs a jax-free module of that package it keeps its own copy
under the same relative path.

Its scope so far: PHOLD and the tgen ladder on one GPU, dense topology
tables. Configs outside it are refused by name (core/build.py).
"""
