"""Matmul-precision setup: full float32 matmuls, no TF32.

At JAX's default precision the GPU may run float32 matmuls and convolutions
on the tensor cores in TF32, which keeps 10 bits of mantissa. The
estimator's numerics — triangulation back-substitution, J^T J normal
equations, Lie retraction chains — lose enough precision at reduced matmul
precision to corrupt the solution (with bf16-rounded matmul inputs the
synthetic e2e drifted 32% of traveled distance; float32 is exact). Every
matmul in this pipeline is tiny and latency-bound, so full precision costs
little.

This lives in a function (called by every entry point: CLI, bench, examples,
tools, chip_smoke.py) instead of a package-import side effect so that
merely importing rsvio_tpu as a library never mutates process-global JAX
configuration for the embedding application.
"""

from __future__ import annotations

import os


def ensure_matmul_precision() -> None:
    """Set jax_default_matmul_precision to "highest" unless the embedding
    application already chose a value (non-None) or RSVIO_MATMUL_PRECISION
    is set to "default" (which keeps the raw hardware behavior)."""
    import jax

    prec = os.environ.get("RSVIO_MATMUL_PRECISION", "highest")
    if prec != "default" and jax.config.jax_default_matmul_precision is None:
        jax.config.update("jax_default_matmul_precision", prec)
