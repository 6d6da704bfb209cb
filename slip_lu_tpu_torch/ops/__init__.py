"""Limb arithmetic: host packing (limbs.py, a copy of the JAX package's)
and the plain PyTorch limb library (device_limbs.py), whose CUDA
counterpart is csrc/limbs.cuh."""

from .limbs import LIMB_BITS, ints_to_limbs, limbs_to_ints

__all__ = ["LIMB_BITS", "ints_to_limbs", "limbs_to_ints"]
