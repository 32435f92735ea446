"""ia_spgemm_tpu_torch — the PyTorch / CUDA port of ia_spgemm_tpu.

The JAX package ``ia_spgemm_tpu`` is the reference; this package mirrors
its module paths and names. It imports torch, numpy and scipy, never
jax. Ported so far: the width-class bitonic route (CSR -> ELL, the
width-class planner, fragment tables, the K1-K4 kernels of
``csrc/bitonic.cu``, BlockCSR assembly), the flat ``spgemm_bitonic``
(float32), the harness's ``baseline``/``bitonic`` rows and the CLI's
``--mode bitonic``.
"""

__version__ = "0.1.0"


def __getattr__(name):
    """Lazy top-level API (keeps `import ia_spgemm_tpu_torch` light)."""
    if name in ("CSR", "ELL", "BlockCSR"):
        from ia_spgemm_tpu_torch.formats import types
        return getattr(types, name)
    if name == "spgemm_bitonic":
        from ia_spgemm_tpu_torch.ops.bitonic import spgemm_bitonic
        return spgemm_bitonic
    if name == "read_mtx_to_csr":
        from ia_spgemm_tpu_torch.io.mmio import read_mtx_to_csr
        return read_mtx_to_csr
    raise AttributeError(name)
