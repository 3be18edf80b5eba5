"""PyTorch / CUDA port of the DLRM-v3 HSTU serving path.

Mirrors the layout of `generative_recommenders_tpu` (ops/, modules/,
configs/, data/, inference/) so each module's counterpart is easy to find.
The JAX package is the reference this port is tested against; the port
imports nothing from it, nor JAX itself. The two TPU attention kernels on
the serving path are hand-written CUDA kernels for Hopper
(`ops/cuda/hstu_attention.py`, sources under `csrc/`).
"""
