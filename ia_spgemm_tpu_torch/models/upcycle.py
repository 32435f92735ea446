"""Upcycling MatNet: retrain the selector on the port's algorithm menu
from the card's own timings (PyTorch port of
``ia_spgemm_tpu.models.upcycle``).

The reference ships only pretrained weights for its MKL/CSR/DIA/ELL/COO
menu (no training code in the tree); this module closes the loop:

  matrices -> benchmark harness with device timers (winner per matrix)
           -> (density images, features, winner label) samples
           -> fine-tune / retrain MatNet -> a class menu of our algorithms.

Everything runs on a device argument, the card by default (the harvest
on the device its matrices live on). Sample files and weight files have
the JAX package's npz layouts, so each package reads the other's.

Two faults of the JAX package's harvest scripts stay out: a matrix is
never blacklisted after a failed row (``harvest_sample`` labels among
the rows that ran), and no file name is parsed for a version. Unlike
the JAX function, ``harvest_sample`` keeps a row whose checksum missed
the baseline's out of the sample's stored times, so ``relabel`` cannot
pick a wrong result.

    A = CSR.from_scipy(suitesparse.gen_named("m133-b3").astype(np.float32))
    s = harvest_sample(A, A, menu=V3_MENU, name="m133-b3")
    params, history, menu = upcycle([s], menu=V3_MENU, init_from=None)
    weights.save_params_npz("card.npz", params, menu=menu)
"""

from __future__ import annotations

import dataclasses
import json
from typing import List, Optional, Sequence

import numpy as np

from ia_spgemm_tpu_torch.bench import harness
from ia_spgemm_tpu_torch.formats.types import CSR
from ia_spgemm_tpu_torch.models import matnet, train as train_mod, weights
from ia_spgemm_tpu_torch.ops import density, features

DEFAULT_MENU = ("baseline", "csr", "dia", "ell", "coo")
# the class menu of weights/TPU_upcycled_v3.npz
V3_MENU = ("bitonic", "esc", "dia", "dense_row", "dense")


@dataclasses.dataclass
class Sample:
    img1: np.ndarray       # (128, 128) normalized
    img2: np.ndarray
    feats: np.ndarray      # (26,)
    label: int             # index into the menu
    winner: str
    matrix_name: str = ""
    # per-algorithm measured times {name: [device_ms, wall_ms]}, kept so
    # a harvested corpus can be relabeled offline when the menu changes;
    # device_ms = 0.0 means no device timer ran, and relabeling then
    # falls back to wall
    times: dict = dataclasses.field(default_factory=dict)


def harvest_report(A: CSR, B: CSR, menu: Sequence[str] = DEFAULT_MENU,
                   name: str = "", iters: int = 2,
                   progress=None) -> harness.BenchReport:
    """Benchmark every menu algorithm on (A, B) with device timers, on
    their device. The scipy baseline always runs (it arms the
    reference's 20x watchdog budget, main.cpp:510,751, and checks every
    checksum)."""
    algos = tuple(menu) if "baseline" in menu \
        else ("baseline",) + tuple(menu)
    return harness.run_benchmark(A, B, algos, iters=iters,
                                 device_timers=True,
                                 matrix_a=name, matrix_b=name,
                                 progress=progress)


def sample_from_report(A: CSR, B: CSR, rep: harness.BenchReport,
                       menu: Sequence[str] = DEFAULT_MENU,
                       name: str = "") -> Optional[Sample]:
    """The sample of (A, B) labelled by harvest_report's report: label =
    the device-time winner among the menu's rows (the baseline is a
    candidate only when the menu names it). None when no menu row
    ran."""
    ran = [r for r in rep.results
           if r.ok and r.run_time_ms > 0 and not r.error]
    ok = [r for r in ran if r.name in menu]
    if not ok:
        return None
    winner = min(ok, key=lambda r: (r.device_time_ms
                                    if r.device_time_ms > 0
                                    else r.run_time_ms)).name
    times = {r.name: [float(r.device_time_ms), float(r.run_time_ms)]
             for r in ran}
    fv = features.feature_vector(A, B).cpu().numpy().astype(np.float32)
    img1 = density.density_image_normalized(A).cpu().numpy().astype(
        np.float32)
    img2 = density.density_image_normalized(B).cpu().numpy().astype(
        np.float32)
    return Sample(img1=img1, img2=img2, feats=fv,
                  label=list(menu).index(winner), winner=winner,
                  matrix_name=name, times=times)


def harvest_sample(A: CSR, B: CSR, menu: Sequence[str] = DEFAULT_MENU,
                   name: str = "", iters: int = 2,
                   progress=None) -> Optional[Sample]:
    """Benchmark every menu algorithm on (A, B) with device timers, on
    their device; label = the device-time winner (harvest_report, then
    sample_from_report)."""
    rep = harvest_report(A, B, menu, name=name, iters=iters,
                         progress=progress)
    return sample_from_report(A, B, rep, menu, name)


def relabel(samples: List[Sample], menu: Sequence[str]) -> List[Sample]:
    """Re-derive (label, winner) from each sample's stored times against
    a (possibly different) menu; samples measuring none of the menu's
    algorithms are dropped. Device time wins over wall when recorded."""
    out = []
    for s in samples:
        cand = {n: t for n, t in s.times.items() if n in menu}
        if not cand:
            continue
        winner = min(cand,
                     key=lambda n: (cand[n][0] if cand[n][0] > 0
                                    else cand[n][1]))
        out.append(dataclasses.replace(
            s, label=list(menu).index(winner), winner=winner))
    return out


def dataset_from_samples(samples: List[Sample], batch_size: int,
                         seed: int = 0):
    """Infinite batch iterator over harvested samples (with replacement;
    the JAX package's draws)."""
    rng = np.random.default_rng(seed)
    n = len(samples)
    while True:
        idx = rng.integers(0, n, batch_size)
        yield (np.stack([samples[i].img1 for i in idx])[..., None],
               np.stack([samples[i].img2 for i in idx])[..., None],
               np.stack([samples[i].feats for i in idx]),
               np.array([samples[i].label for i in idx], np.int32))


def upcycle(samples: List[Sample],
            menu: Sequence[str] = DEFAULT_MENU,
            init_from: Optional[str] = "Intel",
            steps: int = 200, batch_size: int = 16,
            learning_rate: float = 1e-3, seed: int = 0, device=None):
    """Retrain MatNet on harvested samples on `device` (the card by
    default). Starts from a shipped weight set when its architecture
    matches the menu (warm start), else from init_params(seed). Returns
    (params as a numpy tree in the JAX layout, history, menu)."""
    params = None
    if init_from is not None:
        try:
            params, arch = weights.import_reference_weights(init_from)
            if arch["num_classes"] != len(menu) or arch["num_features"] != 26:
                params = None
        except FileNotFoundError:
            params = None
    cfg = train_mod.TrainConfig(num_classes=len(menu), num_features=26,
                                learning_rate=learning_rate,
                                batch_size=batch_size, steps=steps,
                                seed=seed)
    ds = dataset_from_samples(samples, batch_size, seed=seed)
    params, history = train_mod.train(ds, cfg, params=params, device=device,
                                      log=lambda *_: None)
    return params, history, tuple(menu)


def evaluate_pick_accuracy(params, samples: List[Sample],
                           menu: Sequence[str] = DEFAULT_MENU,
                           device=None) -> float:
    """Fraction of samples where MatNet picks the empirical winner, the
    aggregate of the reference's per-run Correct/Incorrect verdict
    (main.cpp:994-999); MatNet runs on `device` (the card by default)."""
    hits = 0
    for s in samples:
        cls = matnet.predict_class(params, s.img1, s.img2, s.feats,
                                   num_classes=len(menu), num_features=26,
                                   device=device)
        hits += int(cls == s.label)
    return hits / max(len(samples), 1)


def save_samples(path: str, samples: List[Sample],
                 menu: Optional[Sequence[str]] = None) -> None:
    extra = {"menu": json.dumps(list(menu))} if menu else {}
    np.savez_compressed(
        path,
        img1=np.stack([s.img1 for s in samples]),
        img2=np.stack([s.img2 for s in samples]),
        feats=np.stack([s.feats for s in samples]),
        labels=np.array([s.label for s in samples], np.int32),
        winners=json.dumps([s.winner for s in samples]),
        names=json.dumps([s.matrix_name for s in samples]),
        times=json.dumps([s.times for s in samples]),
        **extra)


def load_samples_menu(path: str) -> Optional[List[str]]:
    """The class menu a sample file's labels index, when it recorded
    one."""
    with np.load(path, allow_pickle=False) as d:
        if "menu" in d:
            return list(json.loads(str(d["menu"])))
    return None


def load_samples(path: str) -> List[Sample]:
    with np.load(path, allow_pickle=False) as d:
        d = {k: d[k] for k in d.files}
    winners = json.loads(str(d["winners"]))
    names = json.loads(str(d["names"]))
    # one non-finite feature poisons every gradient step it lands in:
    # fail, naming the samples, instead of training on them
    feats = d["feats"]
    bad = np.nonzero(~np.isfinite(
        feats.reshape(feats.shape[0], -1)).all(axis=1))[0]
    if bad.size:
        raise ValueError(
            "non-finite features in harvest checkpoint "
            f"{path}: samples {[names[i] for i in bad]}; re-extract "
            "(ops/features.py) or drop them before training")
    times = (json.loads(str(d["times"])) if "times" in d
             else [{} for _ in winners])  # files without stored times
    return [Sample(img1=d["img1"][i], img2=d["img2"][i],
                   feats=feats[i], label=int(d["labels"][i]),
                   winner=winners[i], matrix_name=names[i],
                   times=times[i])
            for i in range(len(winners))]


def stratified_kfold_accuracy(samples: List[Sample],
                              menu: Sequence[str] = DEFAULT_MENU,
                              k: int = 5, steps: int = 300,
                              seed: int = 0,
                              init_from: Optional[str] = "Intel",
                              device=None):
    """Stratified k-fold pick accuracy: samples split per class into k
    folds (the JAX package's assignment); each fold held out once
    against a model trained on the rest. Returns (mean_acc, per_fold,
    majority_baseline)."""
    rng = np.random.default_rng(seed)
    by_class: dict = {}
    for i, s in enumerate(samples):
        by_class.setdefault(s.label, []).append(i)
    folds: List[List[int]] = [[] for _ in range(k)]
    for _, idxs in sorted(by_class.items()):
        idxs = list(idxs)
        rng.shuffle(idxs)
        for j, i in enumerate(idxs):
            folds[j % k].append(i)
    accs = []
    for f in range(k):
        test = [samples[i] for i in folds[f]]
        train_set = [samples[i] for g in range(k) if g != f
                     for i in folds[g]]
        if not test or not train_set:
            continue
        params, _, _ = upcycle(train_set, menu=menu, init_from=init_from,
                               steps=steps, seed=seed + f, device=device)
        accs.append(evaluate_pick_accuracy(params, test, menu=menu,
                                           device=device))
    counts = np.bincount([s.label for s in samples],
                         minlength=len(menu))
    majority = float(counts.max()) / max(len(samples), 1)
    return (float(np.mean(accs)) if accs else 0.0,
            [round(a, 4) for a in accs], majority)

