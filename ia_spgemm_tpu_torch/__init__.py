"""ia_spgemm_tpu_torch — the PyTorch / CUDA port of ia_spgemm_tpu.

The JAX package ``ia_spgemm_tpu`` is the reference; this package mirrors
its module paths and names. It imports torch, numpy and scipy, never
jax. Ported so far: the width-class bitonic route (CSR -> ELL, the
width-class planner, fragment tables, the K1-K4 kernels of
``csrc/bitonic.cu``, BlockCSR assembly), the flat ``spgemm_bitonic``
(float32), the production CSR entry ``ops/esc.spgemm_csr_auto`` with its
engines (tiled, the slab engine with K8 + K3, the slab + global hybrid,
the global sort, workspace slicing) and the compensated route (K9 + K10
of ``csrc/slab.cu``), the harness's ``baseline``/``bitonic``/``csr``/
``esc``/``compensated`` rows and the same CLI modes.
"""

__version__ = "0.2.0"


def __getattr__(name):
    """Lazy top-level API (keeps `import ia_spgemm_tpu_torch` light)."""
    if name in ("CSR", "ELL", "BlockCSR", "SlabCSR"):
        from ia_spgemm_tpu_torch.formats import types
        return getattr(types, name)
    if name == "spgemm_bitonic":
        from ia_spgemm_tpu_torch.ops.bitonic import spgemm_bitonic
        return spgemm_bitonic
    if name in ("spgemm_csr_auto", "spgemm_csr_compensated"):
        from ia_spgemm_tpu_torch.ops import esc
        return getattr(esc, name)
    if name == "read_mtx_to_csr":
        from ia_spgemm_tpu_torch.io.mmio import read_mtx_to_csr
        return read_mtx_to_csr
    raise AttributeError(name)
