"""ia_spgemm_tpu_torch — the PyTorch / CUDA port of ia_spgemm_tpu.

The JAX package ``ia_spgemm_tpu`` is the reference; this package mirrors
its module paths and names. It imports torch, numpy and scipy, never
jax. Its constructors and readers put matrices on the card unless given
``device="cpu"``, where the kernels' plain PyTorch versions run. Ported:

- the width-class bitonic route (``ops/bitonic.py``: the planner,
  fragment tables, K1-K4 of ``csrc/bitonic.cu``, BlockCSR assembly), the
  flat ``spgemm_bitonic`` with its bf16 serve lane (K7), and the cols
  layout over the torch expand (K5, K6 + K3) that float64 operands and
  wide float32 rows take;
- the production CSR entry ``ops/esc.spgemm_csr_auto`` with its engines
  (tiled, the slab engine with K8 + K3 of ``csrc/slab.cu``, the slab +
  global hybrid, the global sort, workspace slicing) and the compensated
  route (K9 + K10);
- the input-aware path: features, density images, MatNet and
  ``autotune.spgemm_auto``, and the other accumulators (dense, dense-row
  with K11, hash with K12, ELL, DIA, COO);
- the distributed paths (``parallel/``): a mesh of shards that may share
  a card, the all-gather ``dist_spgemm``, the ring ``ring_spgemm`` whose
  blocks hop through K13 (``csrc/ring.cu``), multi-process meshes on
  ``torch.distributed`` and ``bench/scaling.py``;
- the harness (with the process-isolated watchdog and device timers)
  and the CLI, every mode of the JAX package's;
- the selector's training path: ``models/train.py``,
  ``models/upcycle.py`` (harvest by device-time winner, retrain,
  score), the named SuiteSparse replicas (``io/suitesparse.py``), the
  native .mtx parser (``io/native.py``), ``bench/profiling.py``,
  ``bench/roofline.py`` and ``graft_entry.py``.
"""

__version__ = "0.3.0"


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
    if name in ("make_mesh", "partition_rows", "dist_spgemm",
                "gather_result"):
        from ia_spgemm_tpu_torch import parallel
        return getattr(parallel, name)
    if name in ("partition_rows_ell", "ring_spgemm", "gather_result_ell"):
        from ia_spgemm_tpu_torch.parallel import ring
        return getattr(ring, name)
    if name == "spgemm_auto":
        from ia_spgemm_tpu_torch.autotune import spgemm_auto
        return spgemm_auto
    if name == "read_mtx_to_csr":
        from ia_spgemm_tpu_torch.io.mmio import read_mtx_to_csr
        return read_mtx_to_csr
    raise AttributeError(name)
