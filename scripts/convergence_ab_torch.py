"""Convergence-level A/B of the PyTorch port against the JAX package: each
trainer family trained full-batch to convergence in both packages from
the same weights on the same planted-signal cohort reaches the same model.

The port's counterpart of `scripts/convergence_ab.py`. Where that script
holds the JAX package against an independent torch derivation, this one
holds the port (`iggcn_tpu_torch/`) against the JAX package's production
steps, family by family:

  * fused, gcn, guide, cluster, sgcn: the JAX `make_train_step` with the
    family's objective, scanned over the epochs, against the port's
    `train/steps.py:train_step` with `OBJECTIVES[kind]`;
  * snps (`Gene_ontology_network`): `build_snps_steps` against
    `train/snps_trainer.py:snps_train_step`;
  * zoo (`GCNFlat`, the generic trainer): `build_generic_steps` against
    `train/generic_cv.py:build_generic_steps`.

The weights are the JAX init, loaded into the port with
`tools/convert.py:load_flax_variables`; the cohort is each package's own
`synthetic_cohort` from the same seed (checked bit-equal). Dropout is 0
on both sides and GUIDE's Gumbel noise is zeroed: the packages' random
streams cannot be aligned.

Bounds, fixed before any run:

  * the first `EARLY_WINDOW` epochs' losses agree to `EARLY_RTOL` (the
    port's six-step trajectory pin);
  * the final loss agrees to `FINAL_RTOL` (`SNPS_DESCENT_RTOL` for the
    SNP family at `SNPS_DESCENT_EPOCHS` epochs or fewer: it is still in
    steep descent there);
  * both packages learn: the last loss is below half the first;
  * the held-out predictions agree on every subject but near-ties, whose
    class margin |log p1 - log p0| is below `TIE_MARGIN` in either
    package; each near-tie is printed with both margins, and the
    accuracies may differ only by those subjects.

`--exact` adds two float64 runs from the same weights, the JAX package's
(x64, its float32-result products widened; `jax_exact`) and the port's,
prints how far every run departs from the JAX package's, and holds the
port's fp32 run to it under the same bounds: a witness that does not
come from the port, to tell rounding from a fault.

The port half (`port_problem`, `new_port_model`, `train_port`,
`predict_port`, `verdict`, `against_exact`) imports nothing of JAX, so
that
`chip_smoke.py` reuses it on a machine without JAX to hold a long run on
the card against the CPU. JAX is imported inside the JAX half only.

Usage:
    env JAX_PLATFORMS=cpu OMP_NUM_THREADS=1 \\
        python scripts/convergence_ab_torch.py --family fused [--epochs 300]
        [--subjects 120] [--rois 30|90] [--exact]

`--rois 90` trains the flagship's full width (the default `ModelConfig`;
the other families at their defaults too). The port runs on one torch
thread. Prints a checkpoint table of both packages' losses, the
near-ties, and one final JSON line; exits 1 when a bound fails.
`tests/test_torch_port_convergence.py` runs six families at 30 epochs
and 60 subjects, `tests/test_torch_port_convergence_cluster.py` the
cluster family at the default run.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import sys
import time
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from iggcn_tpu_torch.config import (LossWeights, ModelConfig,  # noqa: E402
                                    TrainConfig)
from iggcn_tpu_torch.data.adni import synthetic_cohort  # noqa: E402
from iggcn_tpu_torch.data.batching import cohort_batch_arrays  # noqa: E402
from iggcn_tpu_torch.data.go_graph import synthetic_topology  # noqa: E402
from iggcn_tpu_torch.models.baselines import GCNFlat  # noqa: E402
from iggcn_tpu_torch.models.go_network import \
    GeneOntologyNetwork  # noqa: E402
from iggcn_tpu_torch.tools.convert import load_flax_variables  # noqa: E402
from iggcn_tpu_torch.train import generic_cv, snps_trainer, steps  # noqa: E402
from iggcn_tpu_torch.train.cv import MODEL_FAMILIES  # noqa: E402
from iggcn_tpu_torch.train.metrics import roc_auc_binary  # noqa: E402

FAMILIES = ("fused", "gcn", "guide", "cluster", "sgcn", "snps", "zoo")
# the fused families' model kinds (`steps.OBJECTIVES`, both packages)
KINDS = {"fused": "sgcn_imgsnp", "gcn": "gcn_imgsnp", "guide": "guide_imgsnp",
         "cluster": "clusterlabel", "sgcn": "sgcn_image"}
EARLY_WINDOW, EARLY_RTOL = 3, 2e-4
FINAL_RTOL = 0.05
SNPS_DESCENT_RTOL, SNPS_DESCENT_EPOCHS = 0.15, 30
TIE_MARGIN = 0.1
# StepLR's factor; the fused families' coupled L2 decay (the SNP and zoo
# trainers take none, as in both packages)
LR_DECAY_FACTOR, WEIGHT_DECAY = 0.5, 1e-4
# the planted signal and the held-out share (the JAX harness's)
PLANTED_ROIS, PLANTED_STRENGTH, TEST_FRAC = (3, 11, 19, 26), 1.25, 0.25
LAMBDA0 = 1e-5                   # the SNP family's reconstruction weight
ZERO_DROP = dict(dropout_lin=0.0, dropout_regr=0.0, dropout_go=0.0,
                 dropout_readout=0.0)
# the convergence harness's widths at 30 ROIs (scripts/convergence_ab.py),
# per family: loss weights and ModelConfig fields; at the flagship's 90
# ROIs every family takes the ModelConfig defaults instead
LOSSES = {
    "fused": dict(disease=1.0, regr=1.0, prob=0.5, reco=1.5e-6, simi=0.1,
                  orth=0.1),
    # GUIDE reads prob as the SNP reconstruction's weight, reco as the
    # image reconstruction's and simi as the Bernoulli-KL sparsity's
    "guide": dict(disease=1.0, regr=1.0, prob=1e-4, reco=1e-3, simi=0.1,
                  orth=0.0),
    "cluster": dict(disease=1.0, regr=0.0, prob=0.5, reco=1.5e-6, simi=0.0,
                    orth=0.0),
    "sgcn": dict(disease=1.0),
}
LOSSES["gcn"] = LOSSES["fused"]
HARNESS_WIDTHS = {
    "fused": dict(num_layers=2, hidden=8, hidden_linear=32),
    "gcn": dict(num_layers=2, hidden=8, hidden_linear=32),
    "guide": dict(num_layers=2, hidden=16),
    "cluster": dict(num_layers=2, hidden=8, hidden_linear=32),
    "sgcn": dict(num_layers=2, hidden=16),
    "zoo": dict(num_layers=2, hidden=16),
}


@dataclasses.dataclass
class Problem:
    """A planted-signal cohort split into train and held-out test subjects:
    the GO topology, the dense arrays (`cohort_batch_arrays`, NumPy) and
    the two index sets."""
    topo: Any
    arrays: Dict[str, np.ndarray]
    train_idx: np.ndarray
    test_idx: np.ndarray


@dataclasses.dataclass
class Schedule:
    """Full-batch optimisation: one Adam step an epoch, StepLR every
    `decay_every` epochs by `LR_DECAY_FACTOR`."""
    epochs: int = 300
    lr: float = 5e-3
    decay_every: int = 100


def split(y: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Deterministic stratified split, round-robin within each class (the
    convergence harness's): (train_idx, test_idx)."""
    order = np.concatenate([np.flatnonzero(y == c) for c in np.unique(y)])
    n_test = max(2, int(round(len(y) * TEST_FRAC)))
    test_idx = order[::int(np.ceil(len(order) / n_test))][:n_test]
    return np.setdiff1d(np.arange(len(y)), test_idx), test_idx


def planted_snps(go_snps: np.ndarray) -> list:
    """The three SNPs wired to the most GO terms."""
    conn = (go_snps != 0).sum(axis=0)
    return [int(i) for i in np.argsort(-conn)[:3]]


def port_problem(*, subjects: int = 120, rois: int = 30, seed: int = 7,
                 go_levels: Optional[Sequence[int]] = None,
                 feat_dim: int = 3) -> Problem:
    """The port's cohort and topology, drawn in the harness's order from
    one generator: the topology first, then the cohort with class signal
    in `PLANTED_ROIS` and the three best-connected SNPs (`feat_dim` 1 with
    270 ROIs: the multi-fusion shape)."""
    rng = np.random.default_rng(seed)
    topo = synthetic_topology(
        rng, level_sizes=list(go_levels) if go_levels else None)
    cohort = synthetic_cohort(rng, num_subjects=subjects, rois=rois,
                              feat_dim=feat_dim,
                              planted_rois=list(PLANTED_ROIS),
                              planted_snps=planted_snps(topo.go_snps),
                              planted_strength=PLANTED_STRENGTH)
    arrays = cohort_batch_arrays(cohort)
    arrays.pop("sbj_id")
    train_idx, test_idx = split(arrays["y"])
    return Problem(topo, arrays, train_idx, test_idx)


def model_fields(family: str, rois: int, **overrides) -> Dict[str, Any]:
    """ModelConfig fields of `family` at `rois` ROIs, dropout 0: the
    harness's widths at 30 ROIs, the defaults at the flagship's 90."""
    widths = ({} if rois == ModelConfig().rois
              else dict(HARNESS_WIDTHS.get(family, {})))
    if family == "cluster":
        widths["is_predict_cluster"] = True
    return {"rois": rois, **widths, **ZERO_DROP, **overrides}


def train_config(family: str, n_train: int, sched: Schedule) -> TrainConfig:
    return TrainConfig(epochs=sched.epochs, batch_size=n_train, lr=sched.lr,
                       weight_decay=WEIGHT_DECAY,
                       lr_decay_factor=LR_DECAY_FACTOR,
                       lr_decay_step_size=sched.decay_every,
                       loss=LossWeights(**LOSSES.get(family, {})))


def new_port_model(family: str, problem: Problem, fields: Dict[str, Any],
                   generator: Optional[torch.Generator] = None
                   ) -> torch.nn.Module:
    """The port's model of `family` on the CPU, dropout 0 and GUIDE's
    Gumbel noise zeroed; its weights from `generator` (a caller replaces
    them with `load_flax_variables`)."""
    g = generator if generator is not None else torch.Generator()
    if family == "snps":
        return GeneOntologyNetwork(problem.topo, classifier=True,
                                   dropout_gcn=0.0, dropout_readout=0.0,
                                   dropout_cls=(0.0, 0.0), generator=g)
    x = problem.arrays["x"]
    if family == "zoo":
        return GCNFlat(x.shape[2], x.shape[1],
                       num_layers=fields.get("num_layers", 2),
                       hidden=fields.get("hidden", 16), dropout_lin=0.0,
                       generator=g)
    mcfg = ModelConfig(**fields)
    model = MODEL_FAMILIES[KINDS[family]](mcfg, problem.topo, generator=g)
    if hasattr(model, "gumbel_zero"):
        model.gumbel_zero = True
    for attr in ("dropout_lin", "dropout1", "dropout2"):
        if hasattr(model, attr):
            setattr(model, attr, 0.0)
    return model


def _tensor(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """`a` on `device`, floating values in the default dtype."""
    t = torch.as_tensor(a).to(device)
    return t.to(torch.get_default_dtype()) if t.is_floating_point() else t


def _subset(problem: Problem, idx: np.ndarray, device: torch.device,
            keys: Optional[Sequence[str]] = None) -> Dict[str, torch.Tensor]:
    out = {k: _tensor(v[idx], device) for k, v in problem.arrays.items()
           if keys is None or k in keys}
    out["w"] = torch.ones(len(idx), device=device)
    return out


def _snps_batch(problem: Problem, idx: np.ndarray, device: torch.device):
    return (_tensor(problem.arrays["snps"][idx], device),
            _tensor((problem.arrays["y"][idx] > 0).astype(np.float32), device),
            torch.ones(len(idx), device=device))


@contextlib.contextmanager
def default_dtype(dtype: torch.dtype):
    """Run a block with `dtype` as torch's default floating dtype."""
    before = torch.get_default_dtype()
    torch.set_default_dtype(dtype)
    try:
        yield
    finally:
        torch.set_default_dtype(before)


@dataclasses.dataclass
class PortRun:
    """A trained port model and its per-epoch training losses (the JAX
    package's bookkeeping: the mean loss over the train rows for the fused
    and zoo families, the summed loss for the SNP family)."""
    family: str
    model: torch.nn.Module
    losses: np.ndarray
    mcfg: Optional[ModelConfig]
    tcfg: Optional[TrainConfig]
    dtype: torch.dtype = torch.float32


def train_port(family: str, problem: Problem, variables: Dict[str, Any],
               device: torch.device, sched: Schedule,
               fields: Optional[Dict[str, Any]] = None,
               dtype: torch.dtype = torch.float32) -> PortRun:
    """Train the port's `family` full-batch from the flax tree `variables`
    ({'params', 'batch_stats'}) on `device`, one step an epoch, in fp32
    or, with `dtype=torch.float64`, in exact arithmetic's stand-in (the
    yardstick that tells an fp32 run's rounding from a fault). Nothing
    but the steps runs between the first and the last step: a caller that
    counts kernel launches around this call counts the training's."""
    with default_dtype(dtype):
        return _train_port(family, problem, variables, device, sched,
                           fields, dtype)


def _train_port(family, problem, variables, device, sched, fields, dtype):
    fields = fields if fields is not None else model_fields(
        family, problem.arrays["x"].shape[1])
    model = new_port_model(family, problem, fields)
    load_flax_variables(model, variables["params"],
                        variables.get("batch_stats"))
    model = model.to(device=device, dtype=dtype)
    n_train = len(problem.train_idx)
    losses = []
    if family == "snps":
        optimizer = snps_trainer.make_snps_optimizer(model)
        x, y, w = _snps_batch(problem, problem.train_idx, device)
        for epoch in range(sched.epochs):
            lr_t = snps_trainer.steplr_host(sched.lr, LR_DECAY_FACTOR,
                                            sched.decay_every, epoch)
            losses.append(snps_trainer.snps_train_step(
                model, optimizer, x, y, w, lr_t, LAMBDA0, None))
        mcfg = tcfg = None
    elif family == "zoo":
        optimizer = generic_cv.make_generic_optimizer(model)
        train_step, _ = generic_cv.build_generic_steps(
            model, optimizer, needs_mask=False, needs_assign=False,
            adj_only=False, aux_loss=False, takes_weight=False)
        batch = _subset(problem, problem.train_idx, device, ("x", "adj", "y"))
        for epoch in range(sched.epochs):
            lr_t = snps_trainer.steplr_host(sched.lr, LR_DECAY_FACTOR,
                                            sched.decay_every, epoch)
            losses.append(train_step(batch, None, lr_t))
        mcfg = tcfg = None
    else:
        mcfg = ModelConfig(**fields)
        tcfg = train_config(family, n_train, sched)
        state = steps.TrainState(model, tcfg, steps_per_epoch=1,
                                 kind=KINDS[family])
        batch = _subset(problem, problem.train_idx, device)
        for _ in range(sched.epochs):
            losses.append(steps.train_step(state, batch, mcfg, tcfg, None)
                          / n_train)
    # one host read at the end: the steps queue on the device meanwhile
    losses = torch.stack(losses).double().cpu().numpy()
    return PortRun(family, model, losses, mcfg, tcfg, dtype)


def train_port_grouped(family: str, problem: Problem,
                       variables: Sequence[Dict[str, Any]],
                       device: torch.device, sched: Schedule,
                       fields: Optional[Dict[str, Any]] = None,
                       dtype: torch.dtype = torch.float32
                       ) -> Sequence[PortRun]:
    """Train one fused `family` from each flax tree of `variables` at once,
    full batch, through the fold-parallel trainer
    (`steps.batched_train_step`: one program for every weight set, whose
    GCN stack runs the kernel's grouped form); one PortRun per set, as
    `train_port` would return it. Nothing but the steps runs between the
    first and the last step."""
    with default_dtype(dtype):
        fields = fields if fields is not None else model_fields(
            family, problem.arrays["x"].shape[1])
        models = []
        for v in variables:
            model = new_port_model(family, problem, fields)
            load_flax_variables(model, v["params"], v.get("batch_stats"))
            models.append(model.to(device=device, dtype=dtype))
        n_sets, n_train = len(models), len(problem.train_idx)
        mcfg = ModelConfig(**fields)
        tcfg = train_config(family, n_train, sched)
        state = steps.StackedState(models, tcfg, [1] * n_sets, KINDS[family])
        one = _subset(problem, problem.train_idx, device)
        batch = {k: torch.stack([v] * n_sets) for k, v in one.items()}
        real = np.ones(n_sets, bool)
        losses = [steps.batched_train_step(state, batch, mcfg, tcfg, None,
                                           real) / n_train
                  for _ in range(sched.epochs)]
        losses = torch.stack(losses).double().cpu().numpy()
        for f, model in enumerate(models):
            model.load_state_dict(state.fold_state_dict(f))
        return [PortRun(family, model, np.ascontiguousarray(losses[:, f]),
                        mcfg, tcfg, dtype)
                for f, model in enumerate(models)]


def cpu_reference(family: str, problem: Problem, variables: Dict[str, Any],
                  sched: Schedule, fields: Optional[Dict[str, Any]] = None,
                  dtype: torch.dtype = torch.float32, threads: int = 0
                  ) -> Dict[str, Any]:
    """A CPU run of `train_port` and its held-out log-probabilities, as
    plain arrays (for a worker process): {"losses", "log_probs",
    "seconds"}. `threads` > 0 sets torch's CPU threads first."""
    if threads:
        torch.set_num_threads(threads)
    cpu = torch.device("cpu")
    t0 = time.perf_counter()
    run = train_port(family, problem, variables, cpu, sched, fields, dtype)
    return {"losses": run.losses, "log_probs": predict_port(run, problem, cpu),
            "seconds": time.perf_counter() - t0}


def snps_log_probs(prob: np.ndarray) -> np.ndarray:
    """(log(1 - p), log p) of the SNP head's probability, clamped as its
    BCE clamps it."""
    p = np.clip(np.asarray(prob, np.float64), 1e-7, 1 - 1e-7)
    return np.stack([np.log1p(-p), np.log(p)], axis=1)


def predict_port(run: PortRun, problem: Problem, device: torch.device
                 ) -> np.ndarray:
    """The trained model's held-out class log-probabilities, eval mode,
    (n_test, classes) float64."""
    with default_dtype(run.dtype):
        return _predict_port(run, problem, device)


def _predict_port(run, problem, device):
    idx = problem.test_idx
    if run.family == "snps":
        x, y, w = _snps_batch(problem, idx, device)
        _, prob = snps_trainer.snps_eval_batch(run.model, x, y, w, LAMBDA0)
        return snps_log_probs(prob.cpu().numpy())
    if run.family == "zoo":
        run.model.eval()
        batch = _subset(problem, idx, device, ("x", "adj"))
        with torch.no_grad():
            return run.model(batch["x"], batch["adj"]).double().cpu().numpy()
    out = steps.eval_step(run.model, _subset(problem, idx, device), run.mcfg,
                          run.tcfg, KINDS[run.family])
    return out["log_probs"].double().cpu().numpy()


def held_out_labels(family: str, problem: Problem) -> np.ndarray:
    y = problem.arrays["y"][problem.test_idx]
    return (y > 0).astype(np.int64) if family == "snps" else y.astype(np.int64)


def margins(log_probs: np.ndarray) -> np.ndarray:
    """Each subject's class margin: its largest log-probability minus the
    next (|log p1 - log p0| with two classes)."""
    top = np.sort(np.asarray(log_probs, np.float64), axis=1)
    return top[:, -1] - top[:, -2]


def final_rtol(family: str, epochs: int) -> float:
    """The final loss's bound: `SNPS_DESCENT_RTOL` for a short SNP run,
    `FINAL_RTOL` otherwise."""
    return (SNPS_DESCENT_RTOL if family == "snps"
            and epochs <= SNPS_DESCENT_EPOCHS else FINAL_RTOL)


def verdict(family: str, losses: Dict[str, np.ndarray],
            log_probs: Dict[str, np.ndarray], y_test: np.ndarray
            ) -> Dict[str, Any]:
    """The agreement of two sides' runs of a binary task (`losses` and
    `log_probs` keyed by side name, the reference side first):
    early-window and final loss agreement relative to the reference, both
    learned, and the held-out predictions equal but for near-ties."""
    (a, la), (b, lb) = losses.items()
    epochs = len(la)
    w = min(EARLY_WINDOW, epochs)
    rtol = final_rtol(family, epochs)
    early_rel = float(np.max(np.abs(la[:w] - lb[:w]) / np.abs(la[:w])))
    final_rel = float(abs(la[-1] - lb[-1]) / abs(la[-1]))
    learned = {s: bool(v[-1] < 0.5 * v[0]) for s, v in losses.items()}
    pa, pb = (np.asarray(log_probs[s]) for s in (a, b))
    pred_a, pred_b = pa.argmax(axis=1), pb.argmax(axis=1)
    ma, mb = margins(pa), margins(pb)
    tie = (ma < TIE_MARGIN) | (mb < TIE_MARGIN)
    differ = pred_a != pred_b
    acc = {s: float(np.mean(p == y_test)) for s, p in ((a, pred_a),
                                                       (b, pred_b))}
    auc = {s: float(roc_auc_binary(y_test, np.exp(p[:, 1])))
           for s, p in ((a, pa), (b, pb))}
    near_ties = [{"subject": int(i), f"margin_{a}": float(ma[i]),
                  f"margin_{b}": float(mb[i]), f"pred_{a}": int(pred_a[i]),
                  f"pred_{b}": int(pred_b[i])}
                 for i in np.flatnonzero(tie)]
    # subjects the two sides classify differently and neither calls close
    disagree = [int(i) for i in np.flatnonzero(differ & ~tie)]
    # the accuracies may differ only by the near-ties that flipped
    flipped_ties = int(np.sum(differ & tie))
    acc_ok = abs(acc[a] - acc[b]) * len(y_test) <= flipped_ties + 1e-9
    ok = bool(early_rel <= EARLY_RTOL and final_rel <= rtol
              and all(learned.values()) and not disagree and acc_ok)
    out = {"family": family, "epochs": epochs, "n_test": int(len(y_test)),
           "early_window": w, "early_rel": early_rel,
           "early_rtol": EARLY_RTOL, "final_rel": final_rel,
           "final_rtol": rtol,
           **{f"learned_{s}": v for s, v in learned.items()},
           **{f"acc_{s}": v for s, v in acc.items()},
           **{f"auc_{s}": v for s, v in auc.items()},
           "pred_agree": float(np.mean(~differ)),
           "tie_margin": TIE_MARGIN, "near_ties": near_ties,
           "disagreements": disagree, "ok": ok}
    return out


def against_exact(losses: Dict[str, np.ndarray],
                  log_probs: Dict[str, np.ndarray], reference: str,
                  subjects: Sequence[int]) -> Dict[str, Any]:
    """Each run's departure from the float64 run `reference` (runs keyed
    by name in `losses` and `log_probs`, all from the same weights): its
    largest relative loss difference over the early window and the run
    and at the last epoch, and for `subjects` every run's
    log p1 - log p0."""
    exact_losses = losses[reference]
    w = min(EARLY_WINDOW, len(exact_losses))
    rel = {s: np.abs(v - exact_losses) / np.abs(exact_losses)
           for s, v in losses.items() if s != reference}
    gap = {s: v[:, 1] - v[:, 0] for s, v in log_probs.items()}
    return {"reference": reference,
            "early_rel": {s: float(r[:w].max()) for s, r in rel.items()},
            "worst_rel": {s: float(r.max()) for s, r in rel.items()},
            "final_rel": {s: float(r[-1]) for s, r in rel.items()},
            "log_p1_minus_log_p0": [{"subject": int(i), **{
                s: float(g[i]) for s, g in gap.items()}} for i in subjects]}


def checkpoint_rows(losses: Dict[str, np.ndarray]) -> list:
    """Table rows (epoch, loss per side, relative difference) at the first
    three epochs, every tenth of the run and the last."""
    (_, la), (_, lb) = losses.items()
    epochs = len(la)
    marks = sorted({0, 1, 2, *range(0, epochs, max(1, epochs // 10)),
                    epochs - 1} & set(range(epochs)))
    return [(e, float(la[e]), float(lb[e]),
             float(abs(la[e] - lb[e]) / abs(la[e]))) for e in marks]


def print_report(result: Dict[str, Any], losses: Dict[str, np.ndarray]
                 ) -> None:
    a, b = losses
    print(f"| epoch | loss_{a} | loss_{b} | rel_diff |")
    print("|---|---|---|---|")
    for e, va, vb, rel in checkpoint_rows(losses):
        print(f"| {e} | {va:.6f} | {vb:.6f} | {rel:.2e} |")
    for t in result["near_ties"]:
        print(f"near-tie: subject {t['subject']}, margin {a} "
              f"{t[f'margin_{a}']:.4f} (pred {t[f'pred_{a}']}), {b} "
              f"{t[f'margin_{b}']:.4f} (pred {t[f'pred_{b}']})")
    exact = result.get("exact")
    if exact:
        for what in ("early_rel", "worst_rel", "final_rel"):
            print(f"against {exact['reference']}: {what} " + ", ".join(
                f"{s} {v:.3e}" for s, v in exact[what].items()))
        w = exact["port_against_witness"]
        print(f"port against {exact['reference']} under the same bounds: "
              f"early {w['early_rel']:.3e}, final {w['final_rel']:.3e}, "
              f"disagreements {w['disagreements']}, ok {w['ok']}")
        for row in exact["log_p1_minus_log_p0"]:
            print(f"subject {row['subject']}: log p1 - log p0 " + ", ".join(
                f"{s} {v:.4f}" for s, v in row.items() if s != "subject"))


# ---------------------------------------------------------------------------
# the JAX half: imports JAX and the JAX package inside its functions only

def _jax_models(family: str, fields: Dict[str, Any], topo):
    """(flax module, model kind) of `family` in the JAX package."""
    from iggcn_tpu.config import ModelConfig as JaxMC
    from iggcn_tpu.models.baselines import GCNFlat as JaxGCNFlat
    from iggcn_tpu.models.clusterlabel import ClusterLabelSGCN
    from iggcn_tpu.models.fused_sgcn import FusedSGCN
    from iggcn_tpu.models.go_network import GeneOntologyNetwork as JaxGO
    from iggcn_tpu.models.guide import GuideImgSnp
    from iggcn_tpu.models.sgcn_image import SGCNImage

    if family == "snps":
        return JaxGO(topo=topo, dropout_gcn=0.0, dropout_readout=0.0,
                     dropout_cls=(0.0, 0.0)), None
    if family == "zoo":
        return JaxGCNFlat(num_layers=fields.get("num_layers", 2),
                          hidden=fields.get("hidden", 16),
                          dropout_lin=0.0), None
    mcfg = JaxMC(**fields)
    if family == "guide":
        return GuideImgSnp(cfg=mcfg, topo=topo, gumbel_zero=True), mcfg
    if family == "cluster":
        return ClusterLabelSGCN(cfg=mcfg, topo=topo), mcfg
    if family == "sgcn":
        return SGCNImage(num_layers=mcfg.num_layers, hidden=mcfg.hidden,
                         rois=mcfg.rois, feat_dim=mcfg.feat_dim,
                         num_classes=mcfg.num_classes,
                         hidden_linear=mcfg.hidden_linear,
                         dropout_lin=0.0), mcfg
    return FusedSGCN(cfg=mcfg, topo=topo), mcfg


def jax_problem(*, subjects: int, rois: int, seed: int) -> Problem:
    """`port_problem` drawn by the JAX package's own generators."""
    from iggcn_tpu.data.adni import synthetic_cohort as jax_cohort
    from iggcn_tpu.data.batching import cohort_batch_arrays as jax_arrays
    from iggcn_tpu.data.go_graph import synthetic_topology as jax_topology

    rng = np.random.default_rng(seed)
    topo = jax_topology(rng)
    cohort = jax_cohort(rng, num_subjects=subjects, rois=rois,
                        planted_rois=list(PLANTED_ROIS),
                        planted_snps=planted_snps(topo.go_snps),
                        planted_strength=PLANTED_STRENGTH)
    arrays = jax_arrays(cohort)
    arrays.pop("sbj_id")
    train_idx, test_idx = split(arrays["y"])
    return Problem(topo, arrays, train_idx, test_idx)


@contextlib.contextmanager
def jax_exact():
    """JAX in float64: x64 on, and the products that the JAX package asks
    for in float32 (`jnp.dot` / `jnp.einsum` with
    `preferred_element_type=jnp.float32`) left in their operands' type.
    Nothing of the JAX package is edited; the two `jnp` names are
    restored on exit."""
    import jax
    import jax.numpy as jnp

    saved = {name: getattr(jnp, name) for name in ("dot", "einsum")}

    def widened(fn):
        def call(*args, preferred_element_type=None, **kwargs):
            return fn(*args, **kwargs)
        return call

    try:
        for name, fn in saved.items():
            setattr(jnp, name, widened(fn))
        with jax.enable_x64(True):
            yield
    finally:
        for name, fn in saved.items():
            setattr(jnp, name, fn)


def _float64(tree):
    """`tree` with every floating array in float64."""
    import jax

    return jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float64)
        if np.issubdtype(np.asarray(a).dtype, np.floating) else a, tree)


def train_jax(family: str, problem: Problem, sched: Schedule,
              fields: Dict[str, Any], init_seed: int = 11,
              start: Optional[Dict[str, Any]] = None):
    """Init the JAX package's model of `family` from PRNGKey(init_seed) and
    train it full-batch with the production step. Returns (variables at
    init as NumPy trees, per-epoch losses, held-out log-probs). With
    `start` (an earlier call's init), train from it in float64 instead:
    the float64 witness, run under `jax_exact`."""
    if start is not None:
        problem = dataclasses.replace(problem, arrays=_float64(problem.arrays))
        with jax_exact():
            return _train_jax(family, problem, sched, fields, init_seed,
                              _float64(start))
    return _train_jax(family, problem, sched, fields, init_seed, None)


def _train_jax(family, problem, sched, fields, init_seed, start):
    import jax
    import jax.numpy as jnp

    from iggcn_tpu.config import LossWeights as JaxLW
    from iggcn_tpu.config import TrainConfig as JaxTC
    from iggcn_tpu.train.steps import OBJECTIVES as JAX_OBJECTIVES
    from iggcn_tpu.train.steps import TrainState, make_eval_step
    from iggcn_tpu.train.steps import make_optimizer, make_train_step

    model, mcfg = _jax_models(family, fields, problem.topo)
    arrays, tr, te = problem.arrays, problem.train_idx, problem.test_idx
    key = jax.random.PRNGKey(init_seed)
    if family in ("snps", "zoo"):
        return _train_jax_loop(family, model, arrays, tr, te, sched, key,
                               start)

    def subset(idx):
        b = {k: jnp.asarray(v[idx]) for k, v in arrays.items()}
        b["w"] = jnp.ones((len(idx),), jnp.float32)
        return b

    train_b, test_b = subset(tr), subset(te)
    n_train = len(tr)
    inputs = ((train_b["x"], train_b["adj"]) if family == "sgcn"
              else (train_b["x"], train_b["adj"], train_b["snps"]))
    variables = (start if start is not None
                 else jax.jit(model.init)(key, *inputs))
    init = jax.device_get({"params": variables["params"],
                           "batch_stats": variables.get("batch_stats", {})})
    tcfg = JaxTC(epochs=sched.epochs, batch_size=n_train, lr=sched.lr,
                 weight_decay=WEIGHT_DECAY, lr_decay_factor=LR_DECAY_FACTOR,
                 lr_decay_step_size=sched.decay_every,
                 loss=JaxLW(**LOSSES[family]))
    objective = JAX_OBJECTIVES[KINDS[family]]
    optimizer = make_optimizer(tcfg)
    step_fn = make_train_step(model, mcfg, tcfg, optimizer, objective)

    @jax.jit
    def run(state, batch, key):
        def body(carry, _):
            st, r = carry
            r, er = jax.random.split(r)
            st, loss_sum = step_fn(st, batch, er)
            return (st, r), loss_sum

        (state, _), losses = jax.lax.scan(body, (state, key), None,
                                          length=sched.epochs)
        return state, losses

    state = TrainState.create(variables, optimizer, steps_per_epoch=1)
    state, losses = run(state, train_b, jax.random.PRNGKey(2))
    losses = np.asarray(losses, np.float64) / n_train
    ev = jax.jit(make_eval_step(model, mcfg, tcfg, objective))(
        state.params, state.batch_stats, test_b)
    return init, losses, np.asarray(ev["log_probs"], np.float64)


def _train_jax_loop(family, model, arrays, tr, te, sched, key, start):
    """The host-loop trainers: `build_snps_steps` (snps) and
    `build_generic_steps` (zoo), Adam without decay, StepLR from the
    host."""
    import jax
    import jax.numpy as jnp
    import optax

    from iggcn_tpu.train.generic_cv import build_generic_steps
    from iggcn_tpu.train.snps_trainer import build_snps_steps
    from iggcn_tpu.train.steps import steplr_host

    optimizer = optax.scale_by_adam(b1=0.9, b2=0.999)
    n_train = len(tr)
    w = jnp.ones((n_train,), jnp.float32)
    rng = jax.random.PRNGKey(2)
    losses = []
    if family == "snps":
        snps = np.asarray(arrays["snps"])
        y = (np.asarray(arrays["y"]) > 0).astype(snps.dtype)
        x_tr, y_tr = jnp.asarray(snps[tr]), jnp.asarray(y[tr])

        def _init_all(mod, x):
            latent, _, _ = mod(x)
            return mod.classify(latent, x)

        variables = start if start is not None else jax.jit(
            lambda r, x: model.init(r, x, method=_init_all))(key, x_tr)
        init = jax.device_get({"params": variables["params"],
                               "batch_stats": variables["batch_stats"]})
        train_step, eval_batch = build_snps_steps(model, optimizer, LAMBDA0,
                                                  use_mlp=False)
        params, stats = variables["params"], variables["batch_stats"]
        opt_state = optimizer.init(params)
        for epoch in range(sched.epochs):
            lr_t = jnp.float32(steplr_host(sched.lr, LR_DECAY_FACTOR,
                                           sched.decay_every, epoch))
            rng, srng = jax.random.split(rng)
            params, stats, opt_state, loss = train_step(
                params, stats, opt_state, x_tr, y_tr, w, srng, lr_t)
            losses.append(float(loss))
        _, _, prob = eval_batch(params, stats, jnp.asarray(snps[te]),
                                jnp.asarray(y[te]),
                                jnp.ones((len(te),), jnp.float32))
        return init, np.asarray(losses), snps_log_probs(np.asarray(prob))
    batch = {"x": jnp.asarray(arrays["x"][tr]),
             "adj": jnp.asarray(arrays["adj"][tr]),
             "y": jnp.asarray(arrays["y"][tr]), "w": w}
    variables = dict(start if start is not None
                     else jax.jit(model.init)(key, batch["x"], batch["adj"]))
    init = jax.device_get({"params": variables["params"], "batch_stats": {}})
    variables = {"params": variables["params"]}
    train_step, _ = build_generic_steps(
        model, optimizer, needs_mask=False, needs_assign=False,
        adj_only=False, aux_loss=False, takes_weight=False, has_stats=False)
    opt_state = optimizer.init(variables["params"])
    for epoch in range(sched.epochs):
        lr_t = jnp.float32(steplr_host(sched.lr, LR_DECAY_FACTOR,
                                       sched.decay_every, epoch))
        rng, srng = jax.random.split(rng)
        variables, opt_state, loss = train_step(variables, opt_state, batch,
                                                srng, lr_t)
        losses.append(float(loss))
    logp = jax.jit(model.apply)(variables, jnp.asarray(arrays["x"][te]),
                                jnp.asarray(arrays["adj"][te]))
    return init, np.asarray(losses), np.asarray(logp, np.float64)


def run_convergence_ab(family: str = "fused", *, epochs: int = 300,
                       subjects: int = 120, rois: int = 30, seed: int = 7,
                       exact: bool = False) -> Dict[str, Any]:
    """Train `family` in the JAX package and in the port (CPU) from the same
    weights on the same cohort; return `verdict`'s dict plus both loss
    series (`losses`, keyed jax / port). With `exact`, also train both
    packages in float64 from the same weights and add under `exact`
    `against_exact` of every run against the JAX package's float64 run
    (the disagreeing and near-tied subjects')."""
    if family not in FAMILIES:
        raise ValueError(f"unknown family {family!r}; one of {FAMILIES}")
    sched = Schedule(epochs=epochs)
    kw = dict(subjects=subjects, rois=rois, seed=seed)
    jprob, pprob = jax_problem(**kw), port_problem(**kw)
    for k, v in jprob.arrays.items():
        if not np.array_equal(np.asarray(v), pprob.arrays[k]):
            raise AssertionError(f"the two packages' cohorts differ in {k}")
    fields = model_fields(family, rois)
    init, losses_jax, lp_jax = train_jax(family, jprob, sched, fields)
    cpu = torch.device("cpu")
    run = train_port(family, pprob, init, cpu, sched, fields)
    lp_port = predict_port(run, pprob, cpu)
    losses = {"jax": losses_jax, "port": run.losses}
    result = verdict(family, losses, {"jax": lp_jax, "port": lp_port},
                     held_out_labels(family, pprob))
    result.update(subjects=subjects, rois=rois,
                  n_train=int(len(pprob.train_idx)), losses=losses)
    if exact:
        _, losses_jax64, lp_jax64 = train_jax(family, jprob, sched, fields,
                                              start=init)
        run64 = train_port(family, pprob, init, cpu, sched, fields,
                           torch.float64)
        result["exact"] = against_exact(
            {**losses, "port_float64": run64.losses,
             "jax_float64": losses_jax64},
            {"jax": lp_jax, "port": lp_port,
             "port_float64": predict_port(run64, pprob, cpu),
             "jax_float64": lp_jax64}, "jax_float64",
            result["disagreements"] + [t["subject"]
                                       for t in result["near_ties"]])
        result["exact"]["port_against_witness"] = verdict(
            family, {"jax_float64": losses_jax64, "port": run.losses},
            {"jax_float64": lp_jax64, "port": lp_port},
            held_out_labels(family, pprob))
    return result


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Convergence A/B of the PyTorch port against the JAX "
                    "package: one trainer family trained full-batch from the "
                    "same weights on the same planted-signal cohort in both, "
                    "on the CPU")
    p.add_argument("--family", choices=FAMILIES, default="fused",
                   help="fused (SGCN_GCN_IMGSNP, 7-term), gcn (GCN_IMGSNP), "
                        "guide (GUIDE_IMGSNP, Gumbel noise zeroed), cluster "
                        "(SGCN_GCN_CLUSTERLABEL), sgcn (SGCN_GCN), snps "
                        "(Gene_ontology_network) or zoo (GCN, the generic "
                        "trainer)")
    p.add_argument("--epochs", type=int, default=300,
                   help="full-batch optimiser steps, one an epoch")
    p.add_argument("--subjects", type=int, default=120,
                   help="planted-signal synthetic cohort size")
    p.add_argument("--rois", type=int, default=30,
                   help="ROIs per subject; 90 trains the flagship's full "
                        "width (the ModelConfig defaults)")
    p.add_argument("--seed", type=int, default=7, help="cohort seed")
    p.add_argument("--exact", action="store_true",
                   help="also train both packages in float64 from the same "
                        "weights and print how far every run departs from "
                        "the JAX package's float64 run (tells rounding "
                        "from a fault)")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    torch.set_num_threads(1)
    r = run_convergence_ab(args.family, epochs=args.epochs,
                           subjects=args.subjects, rois=args.rois,
                           seed=args.seed, exact=args.exact)
    print_report(r, r["losses"])
    print(json.dumps({k: v for k, v in r.items() if k != "losses"}))
    return 0 if r["ok"] else 1


if __name__ == "__main__":
    from iggcn_tpu.utils.platform import honor_platform_env
    honor_platform_env()
    sys.exit(main())
