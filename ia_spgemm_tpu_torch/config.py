"""Framework-wide constants and configuration (PyTorch port).

Same values as ``ia_spgemm_tpu.config``: the class-row padding of the
width-class planner comes from :func:`bucket_capacity`, so it must agree
with the JAX package bit for bit, and the harness's guards read the same
budgets, so both packages skip the same rows.
"""

from __future__ import annotations

import dataclasses

# Density-representation image side length (reference main.cpp:516).
DENSITY_IMAGE_SIZE: int = 128

# Format viability guard: a format is rejected when its byte footprint
# exceeds RATIO x the CSR footprint (reference CPU 50x, GPU 20x).
SIZE_GUARD_RATIO_CPU: float = 50.0
SIZE_GUARD_RATIO_GPU: float = 20.0

# Benchmark watchdog: an algorithm is abandoned past TIMEOUT_SCALE x the
# baseline's runtime (reference main.cpp:510,751).
TIMEOUT_SCALE: float = 20.0

# Byte sizes of the reference's memory-size formulas (int=4, double=8).
SIZEOF_INDEX: int = 4
SIZEOF_VALUE: int = 8


@dataclasses.dataclass(frozen=True)
class SpGEMMConfig:
    """The fields of the JAX package's SpGEMMConfig that the harness and
    ``spgemm_auto`` read, with its values."""

    # Bucket data-dependent capacities (plan parity with the JAX package).
    bucket_capacities: bool = True
    # Viability guard ratio (reference CPU rule).
    size_guard_ratio: float = SIZE_GUARD_RATIO_CPU
    # Benchmark timeout scale.
    timeout_scale: float = TIMEOUT_SCALE
    # Watchdog budget when the menu carries no baseline to scale from.
    default_timeout_s: float = 300.0
    # Device-memory budget of the dense / dense_row routes' densified
    # operands and output. The JAX package sized it for a 16 GB TPU; it is
    # kept so the harness skips the same rows (an 80 GB refit is ROADMAP
    # work).
    dense_bytes_budget: float = 6 * 2**30


DEFAULT_CONFIG = SpGEMMConfig()


def bucket_capacity(n: int, *, enabled: bool = True, minimum: int = 8) -> int:
    """Round a data-dependent capacity up to the next geometric bucket
    {8, 10, 12, 14} x 2^e (at most 25% padding, 4 buckets per octave)."""
    n = int(n)
    if n <= minimum:
        return minimum
    if not enabled:
        return n
    base = 1 << max((n - 1).bit_length() - 4, 0)
    for mant in (8, 10, 12, 14, 16):
        if mant * base >= n:
            return mant * base
    raise AssertionError("unreachable")
