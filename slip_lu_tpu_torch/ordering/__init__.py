"""Fill-reducing orderings (reference: AMD/ and COLAMD/ packages).

`amd_order` and `colamd_order` are the Python reference implementations;
`slip_lu_tpu.ordering.native` exposes the C++ versions (built from
native/slip_symbolic.cpp) and is preferred automatically when the shared
library is available.
"""

from .amd import amd_order
from .colamd import colamd_order

__all__ = ["amd_order", "colamd_order"]
