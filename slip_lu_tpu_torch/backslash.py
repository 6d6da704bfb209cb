"""One-call exact solve: analyze + factorize + solve + output conversion.

Reference parity: ``SLIP_backslash.c`` (copy input to CSC x MPZ, analyze,
factorize, solve, then copy the rational solution to the caller's
requested type), with the device path of this package as the default.
"""

from __future__ import annotations

from typing import Optional

from .analyze import analyze
from .convert import matrix_copy
from .errors import SlipIncorrectInputError
from .factorize import factorize
from .matrix import Kind, SlipMatrix, Type
from .options import Options
from .solve import check_solution, solve


def backslash(A: SlipMatrix, b: SlipMatrix, out_type: Type = Type.MPQ,
              options: Optional[Options] = None,
              backend: str = "cuda-fused", device="cuda") -> SlipMatrix:
    """Exactly solve A x = b; return dense x of `out_type`.

    out_type semantics (reference: SLIP_backslash's type argument):
      MPQ  — exact rationals (lossless),
      MPFR — rounded to options.prec bits,
      FP64 — rounded to double,
      MPZ/INT64 — valid only if the exact solution is integral.

    backend:
      "host"       — Python-int oracle (the reference algorithm);
      "cuda"       — the dense exact solve: right-looking IPGE over the
                     dense limb matrix on `device`, every pivot searched
                     on the device under options.pivot (all six schemes),
                     with widen-and-retry on overflow;
      "cuda-fused" — the fused exact solve: the factor and solve chunk
                     streams run as two kernels on `device`, with
                     widen-and-retry on overflow and a replan around the
                     oracle's pivots on exact cancellation.
    device: "cuda" (default) runs the kernels and raises if torch finds
    no CUDA device; "cpu" runs the kernels' plain PyTorch versions.
    All backends produce bit-identical rationals (the exact solution is
    unique; only internal pivot sequences differ).
    """
    from .stats import SolveStats, phase_timer, record

    options = options or Options()
    options.validate()
    A2 = matrix_copy(A, Kind.CSC, Type.MPZ, options)  # integerize
    analysis = analyze(A2, options)
    if backend == "cuda":
        from .gpu.backslash_cuda import factorize_solve_cuda
        x_mpq = factorize_solve_cuda(A2, analysis, b, options, device=device)
    elif backend == "cuda-fused":
        from .gpu.backslash_fused import factorize_solve_cuda_fused
        x_mpq = factorize_solve_cuda_fused(A2, analysis, b, options,
                                           device=device)
    elif backend == "host":
        st = SolveStats(backend="host", n=A2.n, nnz=int(A2.p[A2.n]),
                        nrhs=b.n if b.kind == Kind.DENSE else 1)
        with phase_timer(st, "factorize"):
            F = factorize(A2, analysis, options)
        with phase_timer(st, "solve"):
            x_mpq = solve(F, b, options)
        record(st)
    else:
        raise SlipIncorrectInputError(
            f"unknown backend={backend!r}, expected 'host', 'cuda' or "
            "'cuda-fused'")
    if options.check:
        check_solution(A, x_mpq, b, options)
    return matrix_copy(x_mpq, Kind.DENSE, out_type, options)
