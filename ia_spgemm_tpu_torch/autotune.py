"""Input-aware autotuning: features + density images -> MatNet -> algorithm
(PyTorch port of ``ia_spgemm_tpu.autotune``).

The selection pipeline of the reference program (main.cpp:512-704):
the 26-feature vector and both 128x128 density images of the operands,
MatNet's prediction, and the predicted class mapped to an algorithm.
Features, images and MatNet run on the operands' device.

Class menus: the shipped CPU weights predict over (MKL, CSR, DIA, ELL,
COO) (README.md:5-8), class 0 being the vendor baseline (here the dense
route for small products, scipy in the harness); the GPU weights over
(CUSP, cuSPARSE, NSPARSE) -> (coo, csr, bitonic); the retrained TPU
weights carry their own menu of algorithm names.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Sequence

import numpy as np

from ia_spgemm_tpu_torch.formats import convert
from ia_spgemm_tpu_torch.formats.types import CSR
from ia_spgemm_tpu_torch.models import matnet, weights
from ia_spgemm_tpu_torch.ops import density, features

CPU_CLASS_TO_ALGORITHM = ("baseline", "csr", "dia", "ell", "coo")
GPU_CLASS_TO_ALGORITHM = ("coo", "csr", "bitonic")


@dataclasses.dataclass
class AutotuneResult:
    algorithm: str
    class_index: int
    logits: np.ndarray
    feature_vector: np.ndarray


def select_algorithm(A: CSR, B: CSR,
                     params=None,
                     arch: Optional[dict] = None,
                     class_menu: Optional[Sequence[str]] = None,
                     weight_name: str = "Intel") -> AutotuneResult:
    """Pick the predicted-fastest algorithm for C = A @ B.

    weight_name: a shipped set (Intel/Amd/P100), "TPU" (the selector
    retrained on measured TPU winners, weights/TPU_upcycled.npz), or a
    path to an npz, whose class menu it carries. A pick outside the menu
    reads as "csr"."""
    if params is None:
        if weight_name == "TPU":
            weight_name = os.path.join(weights.LOCAL_WEIGHTS_DIR,
                                       "TPU_upcycled.npz")
        if weight_name.endswith(".npz"):
            params, menu = weights.load_params_npz(weight_name,
                                                   with_menu=True)
            arch = weights.infer_arch(params)
            if class_menu is None and menu is not None:
                class_menu = menu
        else:
            params, arch = weights.import_reference_weights(weight_name)
    if arch is None:
        arch = weights.infer_arch(params)
    if class_menu is None:
        class_menu = (GPU_CLASS_TO_ALGORITHM
                      if arch.get("num_classes") == 3
                      else CPU_CLASS_TO_ALGORITHM)

    fv = features.feature_vector(A, B)
    nf = arch["num_features"]
    fv_in = (fv[:nf] if fv.shape[0] >= nf
             else np.pad(fv.cpu().numpy(), (0, nf - fv.shape[0])))
    img1 = density.density_image_normalized(A)
    img2 = density.density_image_normalized(B)
    logits = matnet.predict_logits(
        params, img1, img2, fv_in, num_classes=arch["num_classes"],
        num_features=nf, device=A.device).cpu().numpy()
    cls = int(np.argmax(logits))
    algo = class_menu[cls] if cls < len(class_menu) else "csr"
    return AutotuneResult(algorithm=algo, class_index=cls, logits=logits,
                          feature_vector=fv.cpu().numpy())


def spgemm_auto(A: CSR, B: CSR, **kwargs):
    """Select, then run. Returns (C as a flat CSR, AutotuneResult) on
    every branch.

    The viability guards still apply: a pick the guards reject falls
    back to the production CSR route, as in the JAX package. Unlike the
    JAX package, whose compensated branch returns its SlabCSR as is, the
    compensated result is flattened too."""
    from ia_spgemm_tpu_torch import config as cfg
    from ia_spgemm_tpu_torch.ops import bitonic as bt
    from ia_spgemm_tpu_torch.ops import dense as dense_ops
    from ia_spgemm_tpu_torch.ops import dia as dia_ops
    from ia_spgemm_tpu_torch.ops import ell as ell_ops
    from ia_spgemm_tpu_torch.ops import esc

    sel = select_algorithm(A, B, **kwargs)
    algo = sel.algorithm
    if algo == "dia":
        Ad, Bd = convert.csr_to_dia(A), convert.csr_to_dia(B)
        if (Ad is not None and Bd is not None
                and dia_ops.dia_compute_viable(Ad.num_diagonals,
                                               Bd.num_diagonals, A.nrows)):
            return convert.dia_to_csr(dia_ops.spgemm_dia(Ad, Bd)), sel
        algo = "csr"
    if algo == "ell":
        Ae, Be = convert.csr_to_ell(A), convert.csr_to_ell(B)
        if Ae is not None and Be is not None:
            # the flat bitonic route when its plan is viable, the width
            # classes for skewed rows, row-local ELL for the rest
            plan = bt.plan_bitonic(Ae, Be)
            C = (bt.spgemm_bitonic(Ae, Be, plan) if plan.viable
                 else bt.spgemm_bitonic_multiclass(Ae, Be, assemble="bcsr"))
            if C is None:
                C = ell_ops.spgemm_ell(Ae, Be)
            return _as_csr(C), sel
        algo = "csr"
    if algo == "coo":
        C = esc.spgemm_coo(convert.csr_to_coo(A), convert.csr_to_coo(B))
        return convert.coo_to_csr(C), sel
    if algo == "bitonic":
        Ae = convert.csr_to_ell(A, check_guard=False)
        Be = convert.csr_to_ell(B, check_guard=False)
        plan = bt.plan_bitonic(Ae, Be)
        C = (bt.spgemm_bitonic(Ae, Be, plan) if plan.viable
             else bt.spgemm_bitonic_multiclass(Ae, Be, assemble="bcsr"))
        if C is not None:
            return _as_csr(C), sel
        algo = "csr"
    if algo == "esc":
        # the global engine gives a flat CSR directly; a workspace
        # overflow falls back like any rejected pick
        try:
            return esc.spgemm_csr(A, B, esc.plan_spgemm(A, B)), sel
        except ValueError:
            algo = "csr"
    if algo == "dense_row":
        from ia_spgemm_tpu_torch.ops import dense_row as dr_ops
        # the harness's gates: B + C densify within the budget, the
        # accumulator row's cap (halved for 8-byte values), A ELL-viable
        vb = A.values.element_size()
        dense_elems = B.nrows * B.ncols + A.nrows * B.ncols
        ka = convert.plan_ell_width(A)
        if (B.ncols * max(vb // 4, 1) <= dr_ops.MAX_N_F32
                and dense_elems * vb <= cfg.DEFAULT_CONFIG.dense_bytes_budget
                and convert.ell_viable(A.nrows, int(A.nnz), ka)):
            Ae = convert.csr_to_ell(A, width=ka, check_guard=False)
            C = dr_ops.spgemm_dense_row(Ae, convert.csr_to_dense(B))
            return convert.dense_to_csr(C), sel
        algo = "csr"
    if algo == "hash":
        from ia_spgemm_tpu_torch.ops import hash_spgemm as hash_ops
        Ae = convert.csr_to_ell(A, check_guard=False)
        Be = convert.csr_to_ell(B, check_guard=False)
        try:
            # hash-ordered slots -> left-justified before the CSR view
            C = convert.compact_ell(hash_ops.spgemm_hash(Ae, Be))
            return _as_csr(C), sel
        except ValueError:
            algo = "csr"
    if algo == "serve":
        # bf16 serve lane (per-product rel error <= 2^-9, float32 sums);
        # compact stays on for the CSR view
        Ae = convert.csr_to_ell(A, check_guard=False)
        Be = convert.csr_to_ell(B, check_guard=False)
        plan = bt.plan_bitonic(Ae, Be)
        if plan.viable:
            try:
                return _as_csr(bt.spgemm_bitonic(Ae, Be, plan,
                                                 value_mode="bf16")), sel
            except ValueError:
                pass
        algo = "csr"
    if algo == "compensated":
        try:
            return _as_csr(esc.spgemm_csr_compensated(A, B)), sel
        except ValueError:
            algo = "csr"
    if algo == "baseline" and A.nrows * B.ncols <= 4 * 1024 * 1024:
        return convert.dense_to_csr(dense_ops.spgemm_dense(A, B)), sel
    return _as_csr(esc.spgemm_csr_auto(A, B)), sel


def _as_csr(C):
    """A flat CSR of any route's result: BlockCSR and SlabCSR convert on
    the device, ELL through ell_to_csr, the hybrid's disjoint parts merge
    through scipy on the host."""
    from ia_spgemm_tpu_torch.formats.types import ELL, BlockCSR, SlabCSR
    from ia_spgemm_tpu_torch.ops import slab as slab_mod
    if isinstance(C, BlockCSR):
        return convert.bcsr_to_csr(C)
    if isinstance(C, SlabCSR):
        return slab_mod.slab_to_csr(C)
    if isinstance(C, slab_mod.HybridCSR):
        dtype = np.dtype(str(C.light.dtype).removeprefix("torch."))
        return CSR.from_scipy(C.to_scipy().astype(dtype),
                              device=C.light.device)
    if isinstance(C, ELL):
        return convert.ell_to_csr(C)
    return C
