"""Limb arithmetic: host packing (limbs.py, a copy of the JAX package's),
the plain PyTorch limb library of the fused solve (device_limbs.py), whose
CUDA counterpart is csrc/limbs.cuh, and the dense solve's sign-magnitude
arithmetic (arith.py, matarith.py) with its shared-operand multiply,
kernel K5 (mul_shared.py, csrc/mul_shared.cu)."""

from .limbs import LIMB_BITS, ints_to_limbs, limbs_to_ints

__all__ = ["LIMB_BITS", "ints_to_limbs", "limbs_to_ints"]
