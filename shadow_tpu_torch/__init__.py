"""shadow_tpu_torch: the PyTorch and CUDA port of shadow_tpu.

The port runs the device engine of shadow_tpu (the `tpu` scheduler
policy on model workloads) on an NVIDIA H100, with the hot path in
CUDA kernels written by hand (shadow_tpu_torch/csrc/). It imports
torch, numpy and pyyaml, never jax and never the shadow_tpu package:
where it needs a jax-free module of that package it keeps its own copy
under the same relative path.

Its scope so far: PHOLD, tgen and Tor model hosts on one GPU (the
device engine, `tpu`) and on the CPU engine with the batched judge on
the card (`hybrid`) or alone (`serial`), with the features
core/build.py lists. Configs outside it are refused by name there.
"""
