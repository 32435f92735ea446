"""Entry points of the port: MatNet's forward pass, and a dry run of the
data-parallel training step and the distributed SpGEMM over a mesh of
shards (the counterpart of the repository's ``__graft_entry__.py``,
which drives the JAX package).

    python -m ia_spgemm_tpu_torch.graft_entry [N_SHARDS] [--device cpu]

runs the forward pass on a batch of 4, then ``dryrun_multichip(N)``
(default 4 shards of the card; shards may share a card).
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from ia_spgemm_tpu_torch.formats.types import DEFAULT_DEVICE, checked_device


def entry(device=None):
    """(fn, example_args): MatNet's forward pass, fn(params, img1, img2,
    feats) -> logits with params a state_dict, over a batch of 4 zero
    inputs on `device` (the card by default)."""
    from ia_spgemm_tpu_torch.models.matnet import (MatNet, init_params,
                                                   no_tf32)
    from ia_spgemm_tpu_torch.models.weights import matnet_state_dict

    dev = checked_device(DEFAULT_DEVICE if device is None else device)
    model = MatNet(num_classes=5, num_features=26).to(dev)
    params = {k: v.to(dev) for k, v in
              matnet_state_dict(init_params(0)).items()}

    def fn(params, img1, img2, feats):
        with no_tf32():
            return torch.func.functional_call(model, params,
                                              (img1, img2, feats))

    example_args = (params,
                    torch.zeros((4, 128, 128, 1), device=dev),
                    torch.zeros((4, 128, 128, 1), device=dev),
                    torch.zeros((4, 26), device=dev))
    return fn, example_args


def dryrun_multichip(n_shards: int, device=None) -> dict:
    """One data-parallel MatNet training step (batch 2 x n_shards split
    over the shards), then dist_spgemm (B all-gathered) and ring_spgemm
    (B streamed) over an n_shards mesh on `device` (the card by default;
    every shard on it), each held against scipy. Raises on a mismatch;
    returns the loss and the two errors."""
    import scipy.sparse as sp

    from ia_spgemm_tpu_torch.formats import convert
    from ia_spgemm_tpu_torch.formats.types import CSR
    from ia_spgemm_tpu_torch.models import train
    from ia_spgemm_tpu_torch.parallel import distributed as dist
    from ia_spgemm_tpu_torch.parallel import ring
    from ia_spgemm_tpu_torch.parallel.mesh import make_mesh

    dev = checked_device(DEFAULT_DEVICE if device is None else device)
    mesh = make_mesh(devices=[dev] * n_shards)

    # 1. MatNet training step, batch split over the shards
    cfg = train.TrainConfig(batch_size=2 * n_shards)
    model, opt = train.make_model(cfg, device=dev)
    step = train.make_train_step(model, opt, mesh)
    bs = cfg.batch_size
    batch = (np.zeros((bs, 128, 128, 1), np.float32),
             np.zeros((bs, 128, 128, 1), np.float32),
             np.zeros((bs, 26), np.float32), np.zeros(bs, np.int32))
    loss = float(step(batch)[0])
    if not np.isfinite(loss):
        raise AssertionError(f"training step loss {loss}")

    # 2. distributed SpGEMM: row-sharded A and C, all-gathered B
    rng = np.random.default_rng(0)
    m = 8 * n_shards
    a = sp.random(m, m, density=0.2, random_state=np.random.RandomState(0),
                  format="csr")
    a.data[:] = rng.standard_normal(a.nnz)
    A = CSR.from_scipy(a, device=dev)
    As = dist.partition_rows(A, n_shards, mesh=mesh)
    e_cap, out_cap = dist.plan_dist_spgemm(A, A, n_shards)
    C = dist.dist_spgemm(As, As, mesh, e_cap=e_cap, out_cap=out_cap)
    want = (a @ a).tocsr()
    diff = dist.gather_result(C).to_scipy() - want
    err = abs(diff).max() if diff.nnz else 0.0
    if not err < 1e-4:
        raise AssertionError(f"dist spgemm mismatch: {err}")

    # 3. ring SpGEMM: B's blocks hop around the ring, bitonic finishes
    A_ell = convert.csr_to_ell(CSR.from_scipy(a.astype(np.float32),
                                              device=dev),
                               check_guard=False)
    As_e = ring.partition_rows_ell(A_ell, n_shards, mesh=mesh)
    Cr = ring.ring_spgemm(As_e, As_e, mesh,
                          ring.plan_ring(A_ell, A_ell, n_shards))
    diff_r = ring.gather_result_ell(Cr).to_scipy() - want
    err_r = abs(diff_r).max() if diff_r.nnz else 0.0
    if not err_r < 1e-3:
        raise AssertionError(f"ring spgemm mismatch: {err_r}")
    print(f"dryrun_multichip({n_shards}) on {dev}: train loss={loss:.4f}, "
          f"dist spgemm max err={float(err):.2e}, "
          f"ring spgemm max err={float(err_r):.2e} - OK", flush=True)
    return {"loss": loss, "dist_err": float(err), "ring_err": float(err_r)}


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    device = argv[argv.index("--device") + 1] if "--device" in argv \
        else None
    shards = [a for a in argv if a.isdigit()]
    fn, args = entry(device)
    print("entry forward:", tuple(fn(*args).shape))
    dryrun_multichip(int(shards[0]) if shards else 4, device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
