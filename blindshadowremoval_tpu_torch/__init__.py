"""PyTorch/CUDA port of blindshadowremoval_tpu for NVIDIA Hopper.

The JAX package beside this one is the reference.  This package imports
neither JAX nor anything of `blindshadowremoval_tpu`; it mirrors the
reference's module tree so each counterpart is easy to find.  Entry points
run on CUDA unless the caller passes `device="cpu"`.
"""
