"""Drive the PyTorch port on one NVIDIA GPU and check it end to end.

Run from the repository root on a machine with a CUDA card:

    python3 chip_smoke.py

It imports nothing of JAX or of the JAX package. Phases, in order; any
failure propagates and the script exits non-zero:

  1. card and build: the `nvidia-smi` name/power-limit line, the python,
     torch, CUDA, numpy and scipy versions, then every CUDA source under
     iggcn_tpu_torch/csrc/ built by nvcc (one process per source, all
     started together), with the build time and ptxas's
     register/shared-memory report;
  2. kernel vs plain on the card: `fused_gcn_stack` against
     `gcn_stack_reference` at every imaging-stack shape of both search
     grids (N=90, F0=3 and N=270, F0=1; B in {1, 7, 32, 256}), each with P
     in both layouts the kernel takes (as `gcn_propagation_matrix` returns
     it, and row-major), one P with isolated nodes, shapes beyond the
     grids at which `plan_launch` picks each other cluster size and K
     split, and transposed P that the bulk copy cannot take (odd N, a
     4-byte-offset view); rtol 1e-4 / atol 1e-5 (fp32, different summation
     order), plus the autograd gradients through both, and at the training
     shape (B=32, N=90) with P built by `gcn_propagation_matrix` from an
     adjacency that requires grad (the transposed view the training path
     passes), gradients into the adjacency included; rtol/atol 1e-4;
  3. the serving slice at full width: the default ModelConfig over a GO
     topology at the real scale, random weights from a seeded
     torch.Generator, written with save_bundle, read back with load_bundle
     and served to an 874-subject cohort at batch 256 on the card; held
     against the same bundle served on the CPU by the plain path
     (log_probs and our_reg within atol 1e-4, pred equal wherever the
     class log-probs differ by more than 1e-4), and the kernel's launch
     count over that run must be ceil(874 / 256) = 4;
  4. the HTTP daemon on the card: /health, three /predict requests of 1, 37
     and 256 subjects checked against phase 3, /stats with the exact
     request count;
  5. times, with CUDA events, median of 25: the kernel, its plain version
     and the same stack in torch.baddbmm/bmm calls at the serving shape,
     the training batch (B=32), the multi-fusion serving shape (B=256,
     N=270) and the multi-fusion training batch (B=32, N=270), each
     warm (back to back, P in L2 where it fits) and cold (L2 flushed by
     writing 256 MB before each call, outside the events), beside its
     bound on this card; the serve-cohort wall time and the request
     latency; for training at full width (fold 0 of phase 7's cohort, B=32):
     one train step's device time (the union of its device ops from the profiler over five
     steps), its span on the card (CUDA events) and its host wall, the
     kernel's forward against the autograd backward (the recompute
     through the plain version) at B=32, and graphs/s over one epoch;
  6. one torch.profiler pass over a warm serving forward of 256 subjects
     and one over a warm train step (each session records the second of
     two calls, after a warm-up cycle in which the tracer starts): the
     kernel's share of device time, the device's idle share, the top 10
     device ops; and one over `SINGLE_CALLS` back-to-back
     `fused_gcn_stack` calls, each of which must launch exactly one
     device kernel, its own (a session with fewer records than calls is
     profiled again, up to three sessions);
     the train step must launch the kernel twice, and so must one eval
     batch (counted);
  7. the training slice at full width: `iggcn_tpu_torch.main.main` on the
     card, default ModelConfig (L=2, H=16), the real-scale GO topology, an
     874-subject synthetic cohort, batch 32, 5 folds with val, 3 epochs,
     --lambda_disease 1.0; every printed loss finite, the `Result -` line
     printed, the experiment's wall time, and the kernel's launches over
     the run equal to what the loop implies (2 per train step and 2 per
     eval batch: sum over folds of epochs x 2 x (train + val + test
     batches)); then six train steps of fold 0 from the same weights at
     dropout 0 on the card, on the CPU and on the CPU in float64:
     per-step losses card vs CPU within rtol 2e-4, the first step's
     gradients and the final params and batch_stats held to float64 as
     `card_vs_cpu_steps` states (the 1e-4 pin, widened only where the
     CPU's own fp32 departs from exact arithmetic);
  8. multi-fusion training at full width: the CLI route `--isMultiFusion`
     (N=270, F0=1: the kernel's 2-CTA cluster path in every step) at the
     widest configuration of its grid (L=3, H=10), phase 7's cohort size,
     batch and folds, 2 epochs; the kernel's launches counted in one train
     step and one eval batch (2 each) and over the run (the loop's count);
     a warm step's host wall, device busy, idle share and kernel share;
     six card steps against the CPU under phase 7's rules; the run exports
     its serving bundles (`--export_bundle`) for phase 10;
  9. every other fused family of the CLI (GCN_IMGSNP, SGCN_GCN, SGCN_GAT,
     SGCN_Ori, GUIDE_IMGSNP, SGCN_GCN_CLUSTERLABEL): one 5-fold, 1-epoch
     experiment each at the default widths; the kernel's launches per
     train step and per eval batch must be the family's (`STACK_CALLS`: 1
     for GCN_IMGSNP, 2 for CLUSTERLABEL, 0 for the rest, which do not run
     the stack) and over the run the loop's count; two card steps against
     the CPU under phase 7's rules (dropout 0, GUIDE's Gumbel noise 0);
     GUIDE_IMGSNP and SGCN_GCN_CLUSTERLABEL export their bundles;
 10. what an experiment keeps, at phase 7's setting: the flagship CLI run
     with `--export_bundle` (2 epochs) writes every fold's checkpoint,
     record and bundle, launching the kernel the loop's count; the fold
     records of folds 3-4 are deleted and the run repeated with
     `--resume`: folds 0-2 restored (their score rows bit-equal to the
     first run's), 3-4 retrained with the loop's launches for those folds
     alone and per-epoch test losses within rtol 2e-4 of the first run's;
     the fold-0 bundles of the flagship (N=90), of phase 8 (N=270) and of
     phase 9's CLUSTERLABEL and GUIDE runs each serve an 874-subject cohort
     at batch 256 on the card, held against the CPU's plain path under
     phase 3's rule, with the kernel's launches per forward the model's (1,
     1, 1, 0); `tools.explain` on the card over the flagship's and
     SGCN_GCN's fold-0 checkpoints: finite importances and edge
     probabilities, and SGCN_GCN's grad-CAM of shape (64, 90), held against
     the CPU's (atol 1e-4);
 11. the SNP-only families (`--model Gene_ontology_network`, `MLP_Model`,
     `--disease_id 0`) over the same topology and cohort, batch 32, 5
     folds, 3 epochs, `--export_bundle`: finite scores and losses, the
     `Result - ... (SNP-only, <model>)` line, two card steps each against
     the CPU under phase 7's rules (dropout 0); both fold-0 bundles served
     on the card against the CPU (prob within atol 1e-4, pred equal where
     |prob - 0.5| > 1e-4), the GO one also through the HTTP daemon's
     SNP-only route; the kernel is launched 0 times in the phase;
 12. the real-cohort route on a layout the script fabricates in a temp dir
     (`write_mat_layout`, `write_go_sources`): the reference's `.mat`
     cohort of 874 subjects at 90 ROIs with the three multi-fusion
     modality dirs, and GO sources that parse into 5 levels of
     `REAL_GO_LEVELS` terms; `load_adni874` and `parse_go_json` timed on
     the host; the flagship CLI over it (phase 7's setting, 2 epochs,
     `--export_bundle`, a temp `--cohort_cache_dir`): finite losses, the
     `Result -` line, the loop's launches; the same run again, which must
     hit the cache, whose entry must equal `load_adni874`'s cohort; six
     card steps of fold 0 against the CPU under phase 7's rules;
     `--isMultiFusion` over the layout (L=3, H=10, 1 epoch, no cache) with
     the loop's launches; `tools.export_cohort` of the layout, and the
     flagship's fold-0 bundle served over it under phase 3's rule (1
     launch per forward);
 13. the other routes, 1 epoch each, with the loop's launches:
     `--isPermutTest --Seed4PermutTest 3` over the layout (results under
     results_permuttest/, fold records only: no checkpoint, no npy);
     `--isTestAdnitype` on phase 7's synthetic cohort (every fold tests on
     exactly the held-out subjects); `--init_from_torch` from a `.pt` the
     phase writes with `export_reference_state_dict` of seeded random
     weights over the layout's GO DAG (fold 0's weights before its first
     step bit-equal to the converted checkpoint, the tag line printed),
     and the same `.pt` through `tools.import_torch` into a bundle served
     under phase 3's rule (1 launch per forward);
 14. the baseline, pooling and nested zoo: the 13 graph baselines of
     `ZOO_MODELS` through the CLI on phase 7's synthetic 874-subject,
     90-ROI cohort (one cohort build through a temp cache, then a graph
     list), the 5 Nested* names on the synthetic TU benchmark (`--data
     SYNTH --synthetic --h 2`: 120 graphs of 8-24 nodes), each L=2, H=16,
     batch 32, 5 folds with val, 1 epoch: finite per-epoch accuracies, the
     `Using` and `Result -` lines, the experiment wall and train graphs/s;
     the kernel's launches over each run the loop's count (`--model GCN`:
     1 per train step and per eval batch, counted in one of each too; 0
     for the other 17); six card steps of fold 0 against the CPU under
     phase 7's rules for GCN, GIN, DiffPool and TopK.

Phases 7-11 build their synthetic cohorts without the cohort cache
(`--cohort_cache_dir ''`), so no cache hit changes their readings.

It prints the `kernels` JSON line before the last line, and as the last
line `{"ok": true, "device": {...}}`. Everything it measures is also
written to results/chip_smoke/result.json (git-ignored).
"""
from __future__ import annotations

import contextlib
import copy
import dataclasses
import glob
import http.client
import io
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import types

import numpy as np
import torch

from iggcn_tpu_torch import main as port_main
from iggcn_tpu_torch.config import ModelConfig
from iggcn_tpu_torch.data import adni, cohort_cache, go_graph
from iggcn_tpu_torch.data.batching import cohort_batch_arrays
from iggcn_tpu_torch.data.go_graph import synthetic_topology
from iggcn_tpu_torch.data.splits import k_fold
from iggcn_tpu_torch.models.fused_sgcn import FusedSGCN
from iggcn_tpu_torch.models.nn_compat import BatchNorm1d
from iggcn_tpu_torch.ops import gcn_stack
from iggcn_tpu_torch.ops.gcn import gcn_propagation_matrix
from iggcn_tpu_torch.data.sampler import (imbalanced_sample_indices,
                                          pad_epoch_indices)
from iggcn_tpu_torch.predict import batched_forward, batched_forward_snps
from iggcn_tpu_torch.tools import explain, export_cohort, import_torch
from iggcn_tpu_torch.tools.convert import _flatten as flat_tree
from iggcn_tpu_torch.tools.convert import to_flax_variables
from iggcn_tpu_torch.tools.serve import (build_http_server, load_bundle,
                                         save_bundle)
from iggcn_tpu_torch.train import cv as port_cv
from iggcn_tpu_torch.train import fold_loop, generic_cv, snps_trainer, steps
from iggcn_tpu_torch.train.cv import init_fold_model, prepare_fold, to_device
from iggcn_tpu_torch.utils import cuda_build

REPO = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(REPO, "results", "chip_smoke")
RTOL, ATOL = 1e-4, 1e-5          # kernel vs plain, fp32
SERVE_ATOL = 1e-4                # card vs CPU serving
COHORT, BATCH = 874, 256         # ADNI cohort size, serving batch
# imaging-stack shapes of both search grids (main.py:_combos), (N, F0,
# widths per layer): the default 90-ROI grid, then --isMultiFusion's
STACK_SHAPES = ([(90, 3, (h,) * n) for n, h in
                 zip([2, 3, 2, 3, 4], [16, 16, 10, 10, 5])]
                + [(270, 1, (h,) * n) for n, h in
                   zip([3, 2, 4, 2, 3], [2, 3, 3, 5, 10])])
STACK_BATCHES = (1, 7, 32, 256)
# timed shapes, (name, B, N, F0, widths): serving first, then the training
# batch (TrainConfig.batch_size) and the multi-fusion grid's widest entry
TIMED_SHAPES = [("serving", BATCH, 90, 3, (16, 16)),
                ("training", 32, 90, 3, (16, 16)),
                ("multi-fusion", BATCH, 270, 1, (10, 10, 10)),
                ("multi-fusion training", 32, 270, 1, (10, 10, 10))]
# (N, F0, widths) beyond the grids at which plan_launch picks the kernel's
# other branches: (cluster, K split) = (1, 1), (2, 4), (4, 1), (8, 1), (8, 2)
BRANCH_SHAPES = [(90, 3, (64, 64)), (270, 1, (3, 3)), (400, 1, (10, 10)),
                 (500, 1, (10, 10)), (600, 1, (4, 4))]
FLUSH_BYTES = 256 * 2**20        # written between cold calls; L2 is 50 MB
# phase 7: the training route at full width (default ModelConfig L=2, H=16;
# the real GO graph's scale; batch 32; 5 folds with val; 3 epochs)
TRAIN_EPOCHS, TRAIN_FOLDS, TRAIN_BATCH = 3, 5, 32
GO_LEVELS = "250,120,50,15,1"


def cli_argv(epochs, appendix, *extra):
    """The CLI route on the card: 874 synthetic subjects over the real-scale
    GO DAG, batch 32, 5 folds with val, --lambda_disease 1.0, the default
    ModelConfig widths (L=2, H=16) unless `extra` says otherwise; no
    cohort cache, so that every run builds its cohort."""
    return ["--device", "cuda", "--synthetic", "--synthetic_subjects",
            str(COHORT), "--synthetic_go_levels", GO_LEVELS, "--epochs",
            str(epochs), "--fold", str(TRAIN_FOLDS), "--batch_size",
            str(TRAIN_BATCH), "--no-search", "--layers", "2", "--hiddens",
            "16", "--lambda_disease", "1.0", "--save_appendix", appendix,
            "--cohort_cache_dir", "", *extra]


TRAIN_ARGV = cli_argv(TRAIN_EPOCHS, "_chip_smoke")
CARD_CPU_STEPS = 6
# phase 8: --isMultiFusion (N=270, F0=1) at the widest configuration of its
# search grid (main.py:combos), L=3, H=10
MULTI_EPOCHS = 2
MULTI_ARGV = cli_argv(MULTI_EPOCHS, "_chip_smoke_multi", "--isMultiFusion",
                      "--layers", "3", "--hiddens", "10", "--export_bundle")
# phase 9: every other fused family, one epoch, two card steps vs the CPU;
# the kernel's launches per train step and per eval batch of each family
# (0: the family does not run the GCN stack, as in the JAX package)
FAMILY_EPOCHS, FAMILY_CPU_STEPS = 1, 2
STACK_CALLS = {"SGCN_GCN_IMGSNP": 2, "GCN_IMGSNP": 1,
               "SGCN_GCN_CLUSTERLABEL": 2, "SGCN_GCN": 0, "SGCN_GAT": 0,
               "SGCN_Ori": 0, "GUIDE_IMGSNP": 0}
OTHER_FAMILIES = ("GCN_IMGSNP", "SGCN_GCN", "SGCN_GAT", "SGCN_Ori",
                  "GUIDE_IMGSNP", "SGCN_GCN_CLUSTERLABEL")
# phase 9 families whose runs export serving bundles (phase 10 serves them)
BUNDLE_FAMILIES = ("GUIDE_IMGSNP", "SGCN_GCN_CLUSTERLABEL")
# phase 10: the flagship's artifacts (2 epochs, --export_bundle), then a
# resume after the records of RESUME_FOLDS are deleted; retrained folds'
# per-epoch test losses within RESUME_RTOL of the first run's (the card is
# not bit-deterministic run to run: atomics in index_select's backward and
# split-K GEMMs)
ARTIFACT_EPOCHS, RESUME_FOLDS, RESUME_RTOL = 2, (3, 4), 2e-4
ARTIFACT_ARGV = cli_argv(ARTIFACT_EPOCHS, "_chip_smoke_artifacts",
                         "--export_bundle")
# the kernel's launches per served forward of each bundle class
SERVE_CALLS = {"FusedSGCN": 1, "ClusterLabelSGCN": 1, "GuideImgSnp": 0}
EXPLAIN_SUBJECTS = 64
# phase 11: the SNP-only families, 3 epochs, binary (--disease_id 0)
SNP_MODELS, SNP_EPOCHS = ("Gene_ontology_network", "MLP_Model"), 3
# phases 12-13: the real-cohort route on a fabricated reference layout;
# its GO sources parse into these level sizes (leaves first), the real
# graph's scale
REAL_GO_LEVELS, REAL_EPOCHS = (250, 120, 50, 15, 1), 2
# phase 14: the zoo, 1 epoch each; six card steps against the CPU for these
ZOO_EPOCHS, ZOO_CARD_CPU = 1, ("GCN", "GIN", "DiffPool", "TopK")


def snps_argv(appendix):
    """The SNP-only CLI route on the card (`--model` comes first): phase
    7's cohort and topology, batch and folds, binary, with bundles."""
    return ["--device", "cuda", "--synthetic", "--synthetic_subjects",
            str(COHORT), "--synthetic_go_levels", GO_LEVELS, "--epochs",
            str(SNP_EPOCHS), "--fold", str(TRAIN_FOLDS), "--batch_size",
            str(TRAIN_BATCH), "--disease_id", "0", "--save_appendix",
            appendix, "--export_bundle", "--cohort_cache_dir", ""]
EPOCH_LINE = re.compile(r"^Fold: (\d+), epoch:(\d+), train_loss: ([^,]+), "
                        r"val_loss: ([^,]+), test_loss: ([^,]+), acc:", re.M)

# published peaks, dense (NVIDIA data sheets): HBM bytes/s, fp32 FLOP/s
# outside the tensor cores; matched on torch.cuda.get_device_name
CARD_SPECS = [("H100 PCIe", 2.0e12, 51e12), ("H100 NVL", 3.9e12, 60e12),
              ("H200", 4.8e12, 67e12), ("H100", 3.35e12, 67e12)]


def log(msg: str) -> None:
    print(msg, flush=True)


def card_spec(name: str):
    for key, bw, flops in CARD_SPECS:
        if key in name:
            return key, bw, flops
    return "H100 (assumed: unknown card)", 3.35e12, 67e12


def stack_work(b, n, f0, widths):
    """(bytes, flops) the stack must move / do: every input read once, the
    output written once; matmuls + bias + relu."""
    dims = [f0] + list(widths)
    params = sum(dims[i] * dims[i + 1] + dims[i + 1] for i in range(len(widths)))
    nbytes = 4 * (b * n * n + b * n * f0 + b * n * sum(widths) + params)
    flops = b * sum(2 * n * dims[i] * dims[i + 1] + 2 * n * n * dims[i + 1]
                    + 2 * n * dims[i + 1] for i in range(len(widths)))
    return nbytes, flops


def stack_inputs(rng, b, n, f0, widths, dev, adjacency=False):
    """A realistic propagation matrix (non-negative top-k adjacency with a
    nonzero diagonal, normalised; in the transposed memory layout
    `gcn_propagation_matrix` returns, as on the serving path; the adjacency
    itself with `adjacency=True`) and glorot-scale weights."""
    adj = np.abs(rng.normal(size=(b, n, n))).astype(np.float32)
    kth = np.partition(adj, n - 10, axis=1)[:, n - 10][:, None, :]
    adj[adj < kth] = 0.0
    adj[:, np.arange(n), np.arange(n)] += 0.5
    prop = torch.from_numpy(adj).to(dev)
    if not adjacency:
        prop = gcn_propagation_matrix(prop)
    x = torch.from_numpy(rng.normal(size=(b, n, f0)).astype(np.float32)).to(dev)
    dims = [f0] + list(widths)
    ws = [torch.from_numpy(rng.normal(0, (2.0 / (dims[i] + dims[i + 1])) ** 0.5,
                                      (dims[i], dims[i + 1])).astype(np.float32)).to(dev)
          for i in range(len(widths))]
    bs = [torch.from_numpy(rng.normal(0, 0.1, (h,)).astype(np.float32)).to(dev)
          for h in widths]
    return prop, x, ws, bs


def library_stack(prop, x, weights, biases):
    """The same stack as PyTorch library calls (bmm + baddbmm + relu). Used
    only as a yardstick here; the port never calls it."""
    h, feats = x, []
    for w, b in zip(weights, biases):
        h = torch.relu(torch.baddbmm(b, prop, torch.matmul(h, w)))
        feats.append(h)
    return torch.cat(feats, dim=-1)


def device_ms(fn, runs=25, inner=10, sleep_cycles=20_000_000):
    """Median device time of one call of `fn`, in ms, from CUDA events,
    warm: calls back to back, so inputs that fit stay in L2.

    Each run first queues a sleep kernel, so the host enqueues all `inner`
    calls while the card waits and the card then runs them back to back:
    the events time the device work, not the host's launch rate. The sleep
    must outlast the enqueueing (a train step enqueues hundreds of ops)."""
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(sleep_cycles)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def cold_device_ms(fn, flush, runs=25):
    """Median device time of one call of `fn`, in ms, with L2 cold: before
    each call the card writes all of `flush` (outside the events), so the
    call reads its inputs from device memory."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    marks = []
    torch.cuda._sleep(20_000_000)
    for _ in range(runs):
        flush.fill_(1.0)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        marks.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in marks)


def make_cohort(rng, s, rois=90, feat=3, num_snps=54, k=10):
    """ADNI-shaped cohort: non-negative adjacency, sparse by top-k per column,
    with a nonzero diagonal; ROI features; SNPs in [0, 1]."""
    x = rng.normal(size=(s, rois, feat)).astype(np.float32)
    adj = np.abs(rng.normal(size=(s, rois, rois))).astype(np.float32)
    adj = (adj + adj.transpose(0, 2, 1)) / 2
    kth = np.partition(adj, rois - k, axis=1)[:, rois - k][:, None, :]
    adj[adj < kth] = 0.0
    adj[:, np.arange(rois), np.arange(rois)] += 0.5
    snps = rng.random((s, num_snps)).astype(np.float32)
    return x, adj, snps


def compare_predictions(got, want, what):
    """Card vs CPU serving outputs: log_probs and, where the model has it,
    our_reg within SERVE_ATOL; pred equal where the decision is wider than
    1e-4."""
    if set(got) != set(want):
        raise AssertionError(f"{what}: outputs {sorted(got)} vs {sorted(want)}")
    for key in ("log_probs", "our_reg"):
        if key not in want:
            continue
        if got[key].shape != want[key].shape or not np.isfinite(got[key]).all():
            raise AssertionError(f"{what}: {key} shape {got[key].shape} vs "
                                 f"{want[key].shape}, or not finite")
        err = float(np.abs(got[key] - want[key]).max()) if got[key].size else 0.0
        if err > SERVE_ATOL:
            raise AssertionError(f"{what}: {key} differs by {err} > {SERVE_ATOL}")
    lp = np.sort(want["log_probs"], axis=1)
    decided = lp[:, -1] - lp[:, -2] > 1e-4
    if not np.array_equal(got["pred"][decided], want["pred"][decided]):
        raise AssertionError(f"{what}: pred differs on decided subjects")


def compare_snps_predictions(got, want, what):
    """Card vs CPU SNP-only serving: prob within SERVE_ATOL, pred equal
    where |prob - 0.5| > 1e-4."""
    if set(got) != {"prob", "pred"} or got["prob"].shape != want["prob"].shape:
        raise AssertionError(f"{what}: outputs {sorted(got)}, prob shape "
                             f"{got['prob'].shape} vs {want['prob'].shape}")
    err = float(np.abs(got["prob"] - want["prob"]).max(initial=0.0))
    if not np.isfinite(got["prob"]).all() or err > SERVE_ATOL:
        raise AssertionError(f"{what}: prob differs by {err} > {SERVE_ATOL}")
    decided = np.abs(want["prob"] - 0.5) > 1e-4
    if not np.array_equal(got["pred"][decided], want["pred"][decided]):
        raise AssertionError(f"{what}: pred differs on decided subjects")
    return err


def phase_build():
    log("== phase 1: card and build")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    import scipy
    log(f"python {sys.version.split()[0]}, torch {torch.__version__} (CUDA "
        f"{torch.version.cuda}), numpy {np.__version__}, scipy "
        f"{scipy.__version__}")
    sources = sorted(os.path.basename(p) for p in
                     glob.glob(os.path.join(cuda_build.CSRC_DIR, "*.cu")))
    t0 = time.perf_counter()
    cuda_build.build_all(sources)
    build_s = time.perf_counter() - t0
    for source, text in cuda_build.BUILD_LOGS.items():
        log(f"-- nvcc {source}:\n{text.strip()}")
    log(f"built {sources} in {build_s:.2f} s")
    return card, build_s


def phase_kernel_vs_plain(dev):
    log("== phase 2: kernel vs plain on the card")
    rng = np.random.default_rng(0)
    max_err = 0.0

    def check(what, prop, x, ws, bs):
        nonlocal max_err
        out = gcn_stack.fused_gcn_stack(prop, x, ws, bs)
        ref = gcn_stack.gcn_stack_reference(prop, x, ws, bs)
        torch.cuda.synchronize()
        err = float((out - ref).abs().max())
        torch.testing.assert_close(out, ref, rtol=RTOL, atol=ATOL)
        max_err = max(max_err, err)
        log(f"{what}: max_abs_err {err:.3e}")

    with torch.inference_mode():
        runs = [(b, *shape) for b in STACK_BATCHES for shape in STACK_SHAPES]
        for b, n, f0, widths in runs + [(7, *shape) for shape in BRANCH_SHAPES]:
            prop, x, ws, bs = stack_inputs(rng, b, n, f0, widths, dev)
            plan = gcn_stack.plan_launch(b, n, (f0, *widths))
            for layout, p in (("transposed", prop),
                              ("row-major", prop.contiguous())):
                check(f"B={b} N={n} F0={f0} H={widths} P {layout} "
                      f"(cluster {plan.cluster}, ksplit {plan.ksplit}, "
                      f"{plan.threads} threads, {plan.smem_bytes} B)",
                      p, x, ws, bs)
        for n, f0 in ((90, 3), (270, 1)):   # isolated nodes: zero rows/cols
            adj = np.abs(rng.normal(size=(7, n, n))).astype(np.float32)
            adj[:, :5, :] = 0.0
            adj[:, :, :5] = 0.0
            prop = gcn_propagation_matrix(torch.from_numpy(adj).to(dev),
                                          add_self_loops=False)
            _, x, ws, bs = stack_inputs(rng, 7, n, f0, (10, 10), dev)
            check(f"B=7 N={n} isolated nodes 0-4", prop, x, ws, bs)
        # transposed P by 4-byte cp.asyncs: odd N (its shared-memory stride
        # is padded to N + 1), and a view 4 bytes past a 16-byte boundary
        for n, f0, widths in ((91, 3, (16, 16)), (271, 1, (10, 10, 10)),
                              (90, 3, (16, 16))):
            prop, x, ws, bs = stack_inputs(rng, 7, n, f0, widths, dev)
            what = f"B=7 N={n} P transposed"
            if n % 2 == 0:
                buf = torch.empty(prop.numel() + 1, device=dev)
                rows = buf[1:].view(prop.shape)
                rows.copy_(prop.transpose(1, 2))
                prop, what = rows.transpose(1, 2), what + ", 4-byte offset"
            plan = gcn_stack.plan_launch(7, n, (f0, *widths))
            if gcn_stack._bulk_copyable(prop, plan):
                raise AssertionError(f"{what}: expected the 4-byte copy path")
            check(f"{what}, 4-byte copies (cluster {plan.cluster})",
                  prop, x, ws, bs)
        prop, x, ws, bs = stack_inputs(rng, 2, 90, 3, (16, 16), dev)
        batch_minor = prop.transpose(0, 1).contiguous().transpose(0, 1)
        try:
            gcn_stack.fused_gcn_stack(batch_minor, x, ws, bs)
        except ValueError as e:
            log(f"other P layout refused: {e}")
        else:
            raise AssertionError("wrapper took a P of another layout")

    grads = []
    for fn in (gcn_stack.fused_gcn_stack, gcn_stack.gcn_stack_reference):
        prop, x, ws, bs = stack_inputs(np.random.default_rng(1), 7, 90, 3,
                                       (16, 16), dev)
        leaves = [prop, x, *ws, *bs]
        for t in leaves:
            t.requires_grad_(True)
        (fn(prop, x, ws, bs) ** 2).sum().backward()
        grads.append([t.grad for t in leaves])
    for g, r in zip(*grads):
        torch.testing.assert_close(g, r, rtol=1e-4, atol=1e-4)
    # the training shape as the train step sees it: P from
    # gcn_propagation_matrix of an adjacency that requires grad (its
    # transposed view), so the gradient reaches the adjacency through P
    rng = np.random.default_rng(4)
    adj0, x0, ws0, bs0 = stack_inputs(rng, TRAIN_BATCH, 90, 3, (16, 16),
                                      "cpu", adjacency=True)
    cot = torch.from_numpy(rng.normal(size=(TRAIN_BATCH, 90, 32)).astype(
        np.float32)).to(dev)
    grads = []
    for fn in (gcn_stack.fused_gcn_stack, gcn_stack.gcn_stack_reference):
        leaves = [t.to(dev).requires_grad_(True)
                  for t in (adj0, x0, *ws0, *bs0)]
        adj, x, ws, bs = leaves[0], leaves[1], leaves[2:4], leaves[4:]
        prop = gcn_propagation_matrix(adj)
        if not gcn_stack._prop_transposed(prop):
            raise AssertionError("expected the transposed P view")
        (fn(prop, x, ws, bs) * cot).sum().backward()
        grads.append([t.grad for t in leaves])
    train_grad_err = 0.0
    for name, g, r in zip(("adj", "x", "W0", "W1", "b0", "b1"), *grads):
        torch.testing.assert_close(g, r, rtol=1e-4, atol=1e-4)
        train_grad_err = max(train_grad_err, float((g - r).abs().max()))
        log(f"training-shape gradient of {name}: max_abs_err "
            f"{float((g - r).abs().max()):.3e}")
    log(f"gradients agree; kernel max_abs_err over all shapes {max_err:.3e}")
    return max_err, train_grad_err


def phase_serve(dev, cohort):
    log("== phase 3: serving slice at full width")
    cfg = ModelConfig()
    topo = synthetic_topology(np.random.default_rng(0),
                              level_sizes=[250, 120, 50, 15, 1], num_snps=54)
    gen = torch.Generator(device=dev).manual_seed(0)
    model = FusedSGCN(cfg, topo, generator=gen, device=dev).eval()
    with torch.no_grad():   # random running statistics for the eval-mode BNs
        for m in model.modules():
            if isinstance(m, BatchNorm1d):
                m.running_mean.normal_(0.0, 0.3, generator=gen)
                m.running_var.uniform_(0.5, 2.0, generator=gen)
    os.makedirs(OUT_DIR, exist_ok=True)
    bundle = os.path.join(OUT_DIR, "bundle.npz")
    save_bundle(bundle, model)
    gpu_model = load_bundle(bundle, device=dev)
    cpu_model = load_bundle(bundle, device="cpu")
    log(f"topology n={topo.n}, params "
        f"{sum(p.numel() for p in gpu_model.parameters())}")

    gcn_stack.fused_gcn_stack.launches = 0
    gpu = batched_forward(gpu_model, *cohort, batch_size=BATCH)
    launches = gcn_stack.fused_gcn_stack.launches
    want_launches = math.ceil(len(cohort[0]) / BATCH)
    if launches != want_launches:
        raise AssertionError(f"serving launched the kernel {launches} times, "
                             f"expected {want_launches}")
    cpu = batched_forward(cpu_model, *cohort, batch_size=BATCH)
    compare_predictions(gpu, cpu, "card vs CPU serving")
    log(f"served {COHORT} subjects on the card: {launches} kernel launches; "
        f"matches the CPU plain path (log_probs max diff "
        f"{np.abs(gpu['log_probs'] - cpu['log_probs']).max():.3e}, our_reg "
        f"{np.abs(gpu['our_reg'] - cpu['our_reg']).max():.3e}); class counts "
        f"{np.bincount(gpu['pred']).tolist()}")
    return gpu_model, gpu, launches


def _post(addr, arrays):
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    conn = http.client.HTTPConnection(*addr, timeout=120)
    conn.request("POST", "/predict", body=buf.getvalue())
    resp = conn.getresponse()
    body = resp.read()
    conn.close()
    if resp.status != 200:
        raise AssertionError(f"/predict answered {resp.status}: {body[:200]}")
    with np.load(io.BytesIO(body)) as zf:
        return {k: zf[k] for k in zf.files}


def _get(addr, path):
    conn = http.client.HTTPConnection(*addr, timeout=60)
    conn.request("GET", path)
    resp = conn.getresponse()
    body = json.loads(resp.read())
    conn.close()
    return body


def phase_http(dev, model, cohort, want):
    log("== phase 4: HTTP daemon on the card")
    server = build_http_server(model, device=dev, port=0, batch=BATCH)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        addr = server.server_address[:2]
        log(f"/health {json.dumps(_get(addr, '/health'))}")
        lo = 0
        for n in (1, 37, 256):
            got = _post(addr, {k: v[lo:lo + n] for k, v in
                               zip(("x", "adj", "snps"), cohort)})
            compare_predictions(got, {k: v[lo:lo + n] for k, v in want.items()},
                                f"/predict of {n} subjects")
            lo += n
        request = {k: v[:BATCH] for k, v in zip(("x", "adj", "snps"), cohort)}
        latencies = []
        for _ in range(20):
            t0 = time.perf_counter()
            _post(addr, request)
            latencies.append((time.perf_counter() - t0) * 1e3)
        stats = _get(addr, "/stats")
        log(f"/stats {json.dumps(stats)}")
        if (stats["requests"], stats["errors"]) != (23, 0):
            raise AssertionError(f"/stats counted {stats['requests']} requests "
                                 f"and {stats['errors']} errors; sent 23, "
                                 "all answered")
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    return {"client_p50_ms": statistics.median(latencies),
            "server_p50_ms": stats["latency_ms"]["p50"],
            "requests": stats["requests"]}


def phase_times(dev, card_name, model, cohort):
    log("== phase 5: times")
    spec, bw, peak = card_spec(card_name)
    flush = torch.empty(FLUSH_BYTES // 4, dtype=torch.float32, device=dev)
    rng = np.random.default_rng(2)
    shapes = []
    with torch.inference_mode():
        for name, b, n, f0, widths in TIMED_SHAPES:
            args = stack_inputs(rng, b, n, f0, widths, dev)
            fns = {"kernel": lambda: gcn_stack.fused_gcn_stack(*args),
                   "plain": lambda: gcn_stack.gcn_stack_reference(*args),
                   "library": lambda: library_stack(*args)}
            nbytes, flops = stack_work(b, n, f0, widths)
            bytes_ms, flops_ms = nbytes / bw * 1e3, flops / peak * 1e3
            row = {"shape": name, "B": b, "N": n, "F0": f0,
                   "widths": list(widths), "bytes": nbytes, "flops": flops,
                   "bound_ms": max(bytes_ms, flops_ms),
                   "bound_by": "bytes" if bytes_ms >= flops_ms else "operations"}
            for what, fn in fns.items():
                row[f"{what}_ms"] = device_ms(fn)
                row[f"{what}_cold_ms"] = cold_device_ms(fn, flush)
            shapes.append(row)
            log(f"gcn_stack {name} B={b} N={n} F0={f0} H={widths}: kernel "
                f"{row['kernel_ms']:.5f} ms warm / {row['kernel_cold_ms']:.5f} "
                f"cold, plain {row['plain_ms']:.5f} / {row['plain_cold_ms']:.5f}, "
                f"library {row['library_ms']:.5f} / {row['library_cold_ms']:.5f}, "
                f"bound {row['bound_ms']:.5f} ms ({row['bound_by']}; {nbytes} B, "
                f"{flops} FLOP, {spec} peaks)")
    del flush
    for row in shapes:
        b, n, f0, widths = row["B"], row["N"], row["F0"], tuple(row["widths"])
        plan = gcn_stack.plan_launch(b, n, (f0, *widths))
        row["plan"] = {"cluster": plan.cluster, "ksplit": plan.ksplit,
                       "threads": plan.threads, "smem_bytes": plan.smem_bytes}
    batched_forward(model, *cohort, batch_size=BATCH)   # warm
    walls = []
    for _ in range(5):
        t0 = time.perf_counter()
        batched_forward(model, *cohort, batch_size=BATCH)
        walls.append(time.perf_counter() - t0)
    wall = statistics.median(walls)
    log(f"serve {COHORT} subjects {wall:.6f} s")
    return {"shapes": shapes, "spec": spec,
            "serve_cohort_s": wall}


def _device_events(prof):
    """(name, start_us, end_us) of every device activity the profiler saw:
    kernels, copies and sets, not the annotation ranges (such as
    `Optimizer.step#Adam.step`) that span several of them."""
    return [(e.name, e.time_range.start, e.time_range.end)
            for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]


def summarize_profile(events, wall_us):
    """Device busy time (union of spans), the kernel's share of device
    time, the idle share of the host wall and the top 10 device ops."""
    totals = {}
    for name, t0, t1 in events:
        tot, cnt = totals.get(name, (0.0, 0))
        totals[name] = (tot + t1 - t0, cnt + 1)
    busy, end = 0.0, -math.inf
    for _, t0, t1 in sorted(events, key=lambda e: e[1]):   # union of spans
        busy += max(0.0, t1 - max(t0, end))
        end = max(end, t1)
    device_us = sum(t for t, _ in totals.values())
    kernel_us = sum(t for name, (t, _) in totals.items()
                    if "gcn_stack_kernel" in name)
    top = sorted(totals.items(), key=lambda kv: -kv[1][0])[:10]
    return {"wall_us": wall_us, "device_busy_us": busy,
            "device_op_us": device_us, "device_ops": len(events),
            "idle_share": 1.0 - busy / wall_us,
            "gcn_stack_us": kernel_us, "gcn_stack_share": kernel_us / device_us,
            "gcn_stack_launches": sum(c for name, (_, c) in totals.items()
                                      if "gcn_stack_kernel" in name),
            "top10": [{"name": name, "us": t, "count": c}
                      for name, (t, c) in top]}


def log_profile(what, out):
    log(f"{what}: host wall {out['wall_us']:.1f} us, device busy "
        f"{out['device_busy_us']:.1f} us over {out['device_ops']} device ops "
        f"(idle share {out['idle_share']:.3f}); gcn_stack "
        f"{out['gcn_stack_us']:.1f} us in {out['gcn_stack_launches']} "
        f"launch(es) = {out['gcn_stack_share']:.4f} of device time")
    for row in out["top10"]:
        log(f"  {row['us']:10.1f} us  x{row['count']:<4d} {row['name'][:110]}")


# calls profiled together to show that one `fused_gcn_stack` call is one
# device kernel: a session that starts tracing right at a ~12 us kernel has
# come back with no device records at all, or with one of ten launches
# missing, on the card
SINGLE_CALLS = 10


def profiled(fn, attempts=3, complete=bool):
    """(device events, host wall in us) of one call of `fn`. Each session
    first runs `fn` in a warm-up cycle, in which the tracer starts and its
    records are dropped, then records a second call. A session whose
    events do not satisfy `complete` (by default: no device activity at
    all) is logged and `fn` is profiled again, up to `attempts` sessions."""
    from torch.profiler import ProfilerActivity, profile, schedule
    for attempt in range(1, attempts + 1):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1)) as prof:
            fn()
            torch.cuda.synchronize()
            prof.step()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        events = _device_events(prof)
        if complete(events):
            return events, wall_us
        log(f"profiler session {attempt} of {attempts} recorded "
            f"{len(events)} device op(s), too few: {events}")
    raise AssertionError(f"{attempts} profiler sessions in a row recorded too "
                         "few device ops")


def phase_profile(dev, model, cohort, train):
    log("== phase 6: profiler")
    request = [a[:BATCH] for a in cohort]
    batched_forward(model, *request, batch_size=BATCH)   # warm
    events, wall_us = profiled(
        lambda: batched_forward(model, *request, batch_size=BATCH))
    prop, x, ws, bs = stack_inputs(np.random.default_rng(3), BATCH, 90, 3,
                                   (16, 16), dev)
    with torch.inference_mode():
        # fewer records than calls is a record the tracer dropped (phase 2
        # checked every call's output); more, or another op, fails below
        calls, _ = profiled(lambda: [gcn_stack.fused_gcn_stack(prop, x, ws, bs)
                                     for _ in range(SINGLE_CALLS)],
                            complete=lambda ev: len(ev) >= SINGLE_CALLS)
    train["step"]()                                      # warm
    step_events, step_wall_us = profiled(train["step"])
    out = summarize_profile(events, wall_us)
    out["forward_wall_us"] = wall_us
    out["single_call_device_ops"] = sorted({name for name, _, _ in calls})
    log_profile(f"serving forward of {BATCH} subjects", out)
    log(f"{SINGLE_CALLS} fused_gcn_stack calls ran {len(calls)} device "
        f"op(s): {out['single_call_device_ops']}")
    if (len(calls) != SINGLE_CALLS
            or not all("gcn_stack_kernel" in name for name, _, _ in calls)):
        raise AssertionError("each fused_gcn_stack call must run exactly one "
                             f"device kernel, its own; {SINGLE_CALLS} calls "
                             f"ran {calls}")
    out["train_step"] = summarize_profile(step_events, step_wall_us)
    log_profile(f"warm train step (B={TRAIN_BATCH}, both passes, backward, "
                "Adam)", out["train_step"])
    if out["train_step"]["gcn_stack_launches"] != 2:
        raise AssertionError("a train step must launch the kernel twice (plain "
                             "and masked pass); the profiler saw "
                             f"{out['train_step']['gcn_stack_launches']}")
    gcn_stack.fused_gcn_stack.launches = 0
    steps.eval_step(train["state"].model, train["eval_batch"], train["mcfg"],
                    train["tcfg"])
    torch.cuda.synchronize()
    out["eval_batch_launches"] = gcn_stack.fused_gcn_stack.launches
    log(f"one eval batch (B={TRAIN_BATCH}, both passes) launched the kernel "
        f"{out['eval_batch_launches']} times")
    if out["eval_batch_launches"] != 2:
        raise AssertionError("an eval batch must launch the kernel twice; it "
                             f"launched {out['eval_batch_launches']}")
    return out


def quiet(model):
    """Dropout off and GUIDE's Gumbel noise zeroed on a port model: the
    image families and the SNP-only models keep their dropout rates as
    model attributes, not in ModelConfig."""
    for attr in ("dropout_lin", "dropout1", "dropout2", "dropout_rate",
                 "dropout_gcn", "dropout_readout"):
        if hasattr(model, attr):
            setattr(model, attr, 0.0)
    if hasattr(model, "dropout_cls"):
        model.dropout_cls = (0.0, 0.0)
    if hasattr(model, "gumbel_zero"):
        model.gumbel_zero = True
    return model


def training_setup(dev, argv=TRAIN_ARGV):
    """A CLI route's experiment, fold 0, built through the CLI's own helpers
    from `argv`: configs, model kind, cohort, splits, fold 0's data on the
    card and a fresh fold-0 train state; `step` runs one train step on the
    first batch, `eval_batch` is fold 0's first test batch."""
    args = port_main.build_parser().parse_args(argv)
    kind = port_main.FUSION_MODELS[args.model]
    dcfg = port_main.build_dcfg(args)
    with contextlib.redirect_stdout(io.StringIO()):
        cohort, topo = port_main.load_cohort(args, dcfg,
                                             np.random.default_rng(args.seed))
    mcfg, tcfg = port_main.fused_cfgs(args, dcfg, args.layers, args.hiddens)
    splits = k_fold(cohort.y, tcfg.folds, tcfg.seed)
    fold0 = prepare_fold(cohort, cohort_batch_arrays(cohort), splits[0], 0,
                         tcfg, tcfg.clinical_score_index)
    model, generator = init_fold_model(mcfg, topo, tcfg.seed, 0, dev,
                                       kind=kind)
    spe = fold0["train_data"]["y"].shape[0] // tcfg.batch_size
    state = steps.TrainState(model, tcfg, spe, kind)
    train_dev = to_device(fold0["train_data"], dev)
    batch = {k: v[:tcfg.batch_size] for k, v in train_dev.items()}
    eval_batch = {k: v[:tcfg.batch_size] for k, v in
                  to_device(fold0["test_data"], dev).items()}
    route = args.model + (" --isMultiFusion" if args.isMultiFusion else "")
    log(f"training setup {route} (L={mcfg.num_layers}, H={mcfg.hidden}, "
        f"N={mcfg.rois}, F0={mcfg.feat_dim}): GO topology n={topo.n}, {len(cohort)} "
        f"subjects, {sum(p.numel() for p in model.parameters())} parameters, "
        f"fold 0 train {fold0['n_train']} / val {fold0['n_val']} / test "
        f"{fold0['n_test']}")
    return {"args": args, "argv": argv, "kind": kind, "mcfg": mcfg,
            "tcfg": tcfg, "topo": topo, "splits": splits, "fold0": fold0,
            "state": state, "generator": generator, "train_dev": train_dev,
            "eval_batch": eval_batch,
            "step": lambda: steps.train_step(state, batch, mcfg, tcfg,
                                             generator)}


def counted_launches(fn):
    """The kernel's launches in one call of `fn` (the wrapper's counter)."""
    gcn_stack.fused_gcn_stack.launches = 0
    fn()
    torch.cuda.synchronize()
    return gcn_stack.fused_gcn_stack.launches


def expected_launches(splits, tcfg, per_batch=2, test_size=None):
    """The kernel's launches over one CV run with a validation split, as
    the loop implies: `per_batch` per train step and per eval batch (2 for
    the two-pass families, 1 for GCN_IMGSNP, 0 where no stack runs), every
    epoch, over the train, val and test batches; with `test_size` every
    fold tests on an external cohort of that many subjects instead of its
    test split."""
    b = tcfg.batch_size

    def batches(split):
        train, test, val = (len(idx) for idx in split)
        if test_size is not None:
            test = test_size
        return sum(math.ceil(n / b) for n in (train, test, val))

    return per_batch * sum(tcfg.epochs * batches(split) for split in splits)


def phase_train_times(dev, train):
    log("== phase 5 (training): train step, forward vs backward, epoch")
    walls = []
    for _ in range(5):
        train["step"]()
    torch.cuda.synchronize()
    for _ in range(25):
        t0 = time.perf_counter()
        train["step"]()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    step_wall_ms = statistics.median(walls)
    # span of one step on the card's clock (CUDA events around it): it
    # includes the gaps in which the card waits for the host
    spans = []
    for _ in range(25):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        train["step"]()
        end.record()
        end.synchronize()
        spans.append(start.elapsed_time(end))
    step_span_ms = statistics.median(spans)
    # the step's device time: the union of its device ops' spans, from the
    # profiler over 5 steps. A sleep before the step cannot hide the host
    # here: the step's ~2,000 launches overrun the launch queue, so the
    # host paces part of it whatever the card does.
    events, _ = profiled(lambda: [train["step"]() for _ in range(5)])
    step_device_ms = summarize_profile(events, 1.0)["device_busy_us"] / 5e3
    prop, x, ws, bs = stack_inputs(np.random.default_rng(5), TRAIN_BATCH, 90,
                                   3, (16, 16), dev)
    leaves = [t.requires_grad_(True) for t in (prop, x, *ws, *bs)]
    with torch.inference_mode():
        fwd_ms = device_ms(lambda: gcn_stack.fused_gcn_stack(prop, x, ws, bs))
    out = gcn_stack.fused_gcn_stack(prop, x, ws, bs)
    grad_out = torch.randn_like(out)
    def backward():
        return torch.autograd.grad(out, leaves, grad_out, retain_graph=True)

    bwd_ms = device_ms(backward, sleep_cycles=100_000_000)
    bwd_events, _ = profiled(backward)
    bwd = summarize_profile(bwd_events, 1.0)
    bwd_busy_ms = bwd["device_busy_us"] / 1e3
    tcfg, mcfg, fold0 = train["tcfg"], train["mcfg"], train["fold0"]
    perm = torch.as_tensor(fold0["perms"][0], device=dev).long()
    fold_loop.train_epoch(train["state"], train["train_dev"], perm, mcfg,
                          tcfg, train["generator"])           # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fold_loop.train_epoch(train["state"], train["train_dev"], perm, mcfg,
                          tcfg, train["generator"])
    torch.cuda.synchronize()
    epoch_s = time.perf_counter() - t0
    out = {"step_wall_ms": step_wall_ms, "step_span_ms": step_span_ms,
           "step_device_ms": step_device_ms,
           "fwd_kernel_b32_ms": fwd_ms, "bwd_recompute_b32_ms": bwd_ms,
           "bwd_recompute_b32_busy_ms": bwd_busy_ms,
           "bwd_recompute_b32_ops": bwd["device_ops"],
           "epoch_s": epoch_s, "epoch_graphs": fold0["n_train"],
           "epoch_graphs_per_s": fold0["n_train"] / epoch_s}
    log(f"train step B={TRAIN_BATCH}: device busy {step_device_ms:.4f} ms, "
        f"span on the card {step_span_ms:.4f} ms, host wall "
        f"{step_wall_ms:.4f} ms; gcn_stack at B={TRAIN_BATCH}: forward kernel "
        f"{fwd_ms:.5f} ms, autograd backward (recompute) {bwd_ms:.5f} ms "
        f"(events; profiler busy {bwd_busy_ms:.5f} ms over "
        f"{bwd['device_ops']} device ops); one epoch of fold 0: "
        f"{fold0['n_train']} graphs in "
        f"{epoch_s:.4f} s = {out['epoch_graphs_per_s']:.1f} graphs/s")
    return out


def adam_step_bound(lr_t, t, b1=0.9, b2=0.999):
    """Largest move of a parameter in Adam step t (1-based, at learning
    rate lr_t) from a fresh state, whatever its gradients: by
    Cauchy-Schwarz on the moment sums,
    lr_t (1-b1)/(1-b1^t) sqrt((1-b2^t)/(1-b2)) sqrt(sum_{k<t} (b1^2/b2)^k),
    which stays near lr_t over the first steps."""
    r = b1 * b1 / b2
    return (lr_t * (1 - b1) / (1 - b1 ** t) * math.sqrt((1 - b2 ** t) / (1 - b2))
            * math.sqrt((1 - r ** t) / (1 - r)))


def adam_sensitivity(optimizer, model, lr):
    """{param name: per entry, how far Adam's step just taken moves per unit
    of gradient through its first moment, lr (1 - b1) / (1 - b1^t) /
    (sqrt(v / (1 - b2^t)) + eps)}, from the optimizer's state after it."""
    group = optimizer.param_groups[0]
    (b1, b2), eps = group["betas"], group["eps"]
    out = {}
    for n, p in model.named_parameters():
        st = optimizer.state.get(p)
        if not st:
            continue
        t = float(st["step"])
        v = st["exp_avg_sq"].detach().double().cpu().numpy()
        out[n] = (lr * (1 - b1) / (1 - b1 ** t)
                  / (np.sqrt(v / (1 - b2 ** t)) + eps))
    return out


def _floats(model):
    return {n: t.detach().double().cpu().numpy()
            for n, t in model.state_dict().items() if t.is_floating_point()}


# an activation whose input is this close to its kink on both devices, and
# on opposite sides of it, is a tie that rounding decides (fp32 rounding of
# the O(1) pre-activations here is ~1e-6)
TIE_ATOL = 1e-4


@contextlib.contextmanager
def recorded_activations(model):
    """Record, in call order, the input of every relu, leaky relu and PReLU
    that `model`'s forward applies (on the host, float64), except inside
    the plain GCN stack: the kernel applies its relus inside, so the card
    shows none there. Yields the list."""
    seen, paused = [], [False]
    relu, leaky = torch.relu, torch.nn.functional.leaky_relu
    reference = gcn_stack.gcn_stack_reference

    def record(x):
        if not paused[0]:
            seen.append(x.detach().to("cpu", torch.float64))

    def relu_(x):
        record(x)
        return relu(x)

    def leaky_(x, *args, **kwargs):
        record(x)
        return leaky(x, *args, **kwargs)

    def reference_(*args, **kwargs):
        paused[0] = True
        try:
            return reference(*args, **kwargs)
        finally:
            paused[0] = False

    hooks = [m.register_forward_pre_hook(lambda _, args: record(args[0]))
             for m in model.modules() if type(m).__name__ == "PReLU"]
    torch.relu, torch.nn.functional.leaky_relu = relu_, leaky_
    gcn_stack.gcn_stack_reference = reference_
    try:
        yield seen
    finally:
        torch.relu, torch.nn.functional.leaky_relu = relu, leaky
        gcn_stack.gcn_stack_reference = reference
        for h in hooks:
            h.remove()


def activation_ties(card, cpu, exact):
    """(flips, largest |input| at a flip, largest excess over the tie band)
    of the activation inputs that the card and the CPU put on opposite
    sides of the kink. A flip is a tie when both inputs lie within
    `TIE_ATOL` plus twice the CPU's own departure from float64 at that
    entry (`exact`) of the kink: fp32 cannot tell the side there, on either
    device (a train-mode batch norm over near-constant features amplifies
    rounding by up to 1/sqrt(eps)); a positive excess is a flip that
    rounding does not explain."""
    if not ([a.shape for a in card] == [b.shape for b in cpu]
            == [e.shape for e in exact]):
        raise AssertionError("card, CPU and float64 applied different "
                             "activations")
    flips, near, excess = 0, 0.0, -math.inf
    for a, b, e in zip(card, cpu, exact):
        flip = (a > 0) != (b > 0)
        if flip.any():
            flips += int(flip.sum())
            dist = torch.maximum(a.abs(), b.abs())[flip]
            band = TIE_ATOL + 2 * (b - e).abs()[flip]
            near = max(near, float(dist.max()))
            excess = max(excess, float((dist - band).max()))
    return flips, near, excess


def fused_route(train):
    """What `card_vs_cpu_steps` needs of a fused family's route (fold 0 of
    `training_setup`'s experiment): a fresh CPU model at dropout 0 (GUIDE's
    Gumbel noise zeroed), the first epoch's shuffled train batches, a train
    state, its step (the loss sum) and the learning rate of step t."""
    mcfg = dataclasses.replace(train["mcfg"], dropout_lin=0.0,
                               dropout_regr=0.0, dropout_go=0.0,
                               dropout_readout=0.0)
    tcfg, fold0, kind = train["tcfg"], train["fold0"], train["kind"]
    cpu_model, _ = init_fold_model(mcfg, train["topo"], tcfg.seed, 0,
                                   torch.device("cpu"), kind=kind)
    perm = fold0["perms"][0]
    spe = perm.shape[0] // tcfg.batch_size
    return {"model": quiet(cpu_model), "batch": tcfg.batch_size,
            "data": {k: v[perm] for k, v in fold0["train_data"].items()},
            "state": lambda model: steps.TrainState(model, tcfg, spe, kind),
            "step": lambda state, batch: float(steps.train_step(
                state, batch, mcfg, tcfg, None)),
            "lr": lambda t: steps.lr_at_step(tcfg, t - 1, spe)}


class SnpsState:
    """A SNP-only model, its optimiser and the count of steps taken."""

    def __init__(self, model):
        self.model = model
        self.optimizer = snps_trainer.make_snps_optimizer(model)
        self.step = 0


def snps_route(kind, snps, labels, topo, seed, batch_size, lr=1e-3):
    """`card_vs_cpu_steps`' route of a SNP-only family: fold 0 of the CLI's
    CV at dropout 0, its first epoch's class-balanced draw, the trainer's
    step (BCE sum + lambda0 reconstruction) at the epoch-0 StepLR rate."""
    train_idx, _, val_idx = k_fold(labels.astype(int), TRAIN_FOLDS, seed)[0]
    tr = np.concatenate([train_idx, val_idx])
    idx, w = pad_epoch_indices(imbalanced_sample_indices(
        labels[tr], np.random.default_rng(seed * 77)), batch_size)
    model, _ = snps_trainer.init_snps_model(kind, topo, snps.shape[1], seed,
                                            0, torch.device("cpu"))
    lambda0 = 0.0 if kind == "mlp" else 1e-5
    lr_t = snps_trainer.steplr_host(lr, 0.7, 50, 0)

    def step(state, batch):
        state.step += 1
        return float(snps_trainer.snps_train_step(
            state.model, state.optimizer, batch["x"], batch["y"], batch["w"],
            lr_t, lambda0, None))

    return {"model": quiet(model), "batch": batch_size,
            "data": {"x": snps[tr][idx], "y": labels[tr][idx], "w": w},
            "state": SnpsState, "step": step, "lr": lambda t: lr_t}


def card_vs_cpu_steps(dev, route, n_steps=CARD_CPU_STEPS):
    """`n_steps` train steps of a route (`fused_route`: fold 0 of a fused
    family with its objective from `steps.OBJECTIVES`; `snps_route`: fold 0
    of a SNP-only family) on the card at dropout 0, each repeated on
    the CPU and on the CPU in float64 from the card's state before it
    (params, batch statistics, Adam's moments and step count), so that each
    step is compared from the same start and device rounding does not
    compound through Adam. Checks, at every step:

      * the loss sum, card vs CPU: rtol 2e-4;
      * the gradients (pre-Adam, before the coupled L2 decay), per leaf
        against float64: |g_card - g64| <= 1e-3 |g64| + 2 |g_cpu - g64|
        (L2 norms), except the leaves whose gradient is zero to rounding
        (|g64| <= |g_cpu - g64|), which are logged, and except in a step
        where the card and the CPU put an activation input on opposite
        sides of its kink (relu, leaky relu, PReLU) within `TIE_ATOL` of
        it, widened per entry by twice the CPU's own departure from float64
        there (`activation_ties`): the gradient then takes the other branch there on one device
        (a tie that rounding decides), so the leaves upstream of it depart
        from float64 by more than rounding; such a step's gradient readings
        are logged as a tie, a flip farther from the kink fails;
      * the params and batch statistics after the step, card vs CPU: atol
        1e-4 per entry, except the entries whose gradient is zero to
        rounding (|g64| no larger than the card's or the CPU's rounding of
        it, which is not 0; a constant on every attention key shifts no
        softmax, for one): Adam's step g / (sqrt(v) + eps) is scale-free,
        so each device moves such an entry by up to lr in whatever
        direction its rounding points; card vs CPU within twice
        `adam_step_bound`. A parameter entry's pin is widened by Adam's
        own amplification of the card-vs-CPU gradient difference,
        2 `adam_sensitivity` |g_card - g_cpu|: where |g| is near Adam's
        eps (SGCN_Ori's relu -> batch-norm head has thousands of such
        entries), the step is lr g / eps and turns a 1e-9 gradient
        difference into a 1e-4 move.

    Returns the readings; every leaf's gradient norms at the first step and
    every leaf with zero-to-rounding entries are logged."""
    cpu = torch.device("cpu")
    cpu_model, b = route["model"], route["batch"]
    sides = {}
    for side, model, device, dtype in [
            ("card", copy.deepcopy(cpu_model).to(dev), dev, torch.float32),
            ("cpu", cpu_model, cpu, torch.float32),
            ("float64", copy.deepcopy(cpu_model).double(), cpu,
             torch.float64)]:
        data = {k: v.to(dtype) if v.is_floating_point() else v
                for k, v in to_device(route["data"], device).items()}
        sides[side] = (route["state"](model), data)
    card = sides["card"][0]
    failures, rows, ties, losses = [], [], [], {s: [] for s in sides}
    for t in range(1, n_steps + 1):
        for side in ("cpu", "float64"):
            state = sides[side][0]
            state.model.load_state_dict(card.model.state_dict())
            state.optimizer.load_state_dict(
                copy.deepcopy(card.optimizer.state_dict()))
            state.step = card.step
        grads, after = {}, {}
        acts = {}
        for side, (state, data) in sides.items():
            batch = {k: v[(t - 1) * b:t * b] for k, v in data.items()}
            with recorded_activations(state.model) as acts[side]:
                losses[side].append(route["step"](state, batch))
            grads[side] = {n: p.grad.detach().double().cpu().numpy()
                           for n, p in state.model.named_parameters()
                           if p.grad is not None}
            after[side] = _floats(state.model)
        if not math.isclose(losses["card"][-1], losses["cpu"][-1],
                            rel_tol=2e-4):
            failures.append(f"step {t}: loss sum {losses['card'][-1]} on the "
                            f"card, {losses['cpu'][-1]} on the CPU")
        flips, near, excess = activation_ties(acts["card"], acts["cpu"],
                                              acts["float64"])
        if flips:
            log(f"step {t}: {flips} activation input(s) on opposite sides of "
                f"the kink on the card and the CPU, all within {near:.3e} "
                f"of it, {excess:.3e} past the tie band at most")
            ties.append({"step": t, "flips": flips, "max_abs_input": near,
                         "max_excess": excess})
        if excess > 0:
            failures.append(f"step {t}: an activation input {near:.3e} from "
                            "its kink flipped between the card and the CPU, "
                            f"{excess:.3e} past its tie band")
        tie = flips > 0
        bound = 2 * adam_step_bound(route["lr"](t), t)
        cpu_state = sides["cpu"][0]
        sens = adam_sensitivity(cpu_state.optimizer, cpu_state.model,
                                route["lr"](t))
        zero = {}
        for n, g64 in grads["float64"].items():
            g_card, g_cpu = grads["card"][n], grads["cpu"][n]
            rounding = np.maximum(np.abs(g_cpu - g64), np.abs(g_card - g64))
            zero[n] = (np.abs(g64) <= rounding) & (rounding > 0)
            norm = float(np.linalg.norm(g64))
            cpu_err = float(np.linalg.norm(g_cpu - g64))
            card_err = float(np.linalg.norm(g_card - g64))
            allowed = 1e-3 * norm + 2 * cpu_err
            leaf_zero = norm <= cpu_err
            rows.append({"step": t, "leaf": n, "norm64": norm,
                         "cpu_err": cpu_err, "card_err": card_err,
                         "allowed": allowed, "leaf_zero": leaf_zero,
                         "tie": tie, "zero_entries": int(zero[n].sum()),
                         "entries": int(g64.size)})
            if t == 1 or leaf_zero:
                log(f"step {t} grad {n}: |g64| {norm:.4e}, |cpu - g64| "
                    f"{cpu_err:.4e}, |card - g64| {card_err:.4e} (allowed "
                    f"{allowed:.4e}){' ZERO TO ROUNDING' if leaf_zero else ''}"
                    f", {int(zero[n].sum())}/{g64.size} entries zero to "
                    f"rounding")
            if not leaf_zero and card_err > allowed:
                if tie:
                    log(f"step {t} grad {n}: |card - g64| {card_err:.3e} > "
                        f"{allowed:.3e} in a step with an activation tie")
                else:
                    failures.append(f"step {t} grad {n}: |card - g64| "
                                    f"{card_err:.3e} > {allowed:.3e}")
        for n, got in after["card"].items():
            diff = np.abs(got - after["cpu"][n])
            walking = zero.get(n, np.zeros(diff.shape, bool))
            pin = 1e-4 + (2 * sens[n] * np.abs(grads["card"][n]
                                                - grads["cpu"][n])
                          if n in sens else 0.0)
            pinned = float(diff[~walking].max(initial=0.0))
            walked = float(diff[walking].max(initial=0.0))
            over = float((diff - pin)[~walking].max(initial=-1.0))
            widest = float(np.max(pin, initial=1e-4))
            rows.append({"step": t, "leaf": n, "state_max": pinned,
                         "pin_max": widest, "walking": int(walking.sum()),
                         "walk_max": walked})
            if walking.any():
                log(f"step {t} state {n}: {int(walking.sum())} "
                    f"zero-to-rounding entries moved {walked:.3e} apart "
                    f"(bound {bound:.3e}); the others {pinned:.3e}")
            if pinned > 1e-4:
                log(f"step {t} state {n}: {pinned:.3e} apart, past 1e-4 only "
                    f"where Adam amplifies the gradient difference (pin up "
                    f"to {widest:.3e} there)" if over <= 0 else
                    f"step {t} state {n}: {pinned:.3e} apart")
            if over > 0:
                failures.append(f"step {t} state {n}: {pinned:.3e} apart, "
                                f"{over:.3e} past its pin")
            if walked > bound:
                failures.append(f"step {t} state {n}: zero-to-rounding "
                                f"entries {walked:.3e} > {bound:.3e}")
    for side, series in losses.items():
        log(f"loss sums, {side}: {series}")
    if failures:
        raise AssertionError("card vs CPU: " + "; ".join(failures))
    state_rows = [r for r in rows if "state_max" in r]
    grad_rows = [r for r in rows if "norm64" in r and not r["leaf_zero"]
                 and not r["tie"]]
    out = {"steps": n_steps, "loss_sums_card": losses["card"],
           "loss_sums_cpu": losses["cpu"],
           "loss_sums_float64": losses["float64"],
           "loss_max_rel_diff": max(abs(a - b) / abs(b) for a, b in
                                    zip(losses["card"], losses["cpu"])),
           "state_max_abs_diff": max(r["state_max"] for r in state_rows),
           "walk_max": max(r["walk_max"] for r in state_rows),
           "grad_max_rel_err": max((r["card_err"] / r["norm64"]
                                    for r in grad_rows), default=0.0),
           "grad_cpu_max_rel_err": max((r["cpu_err"] / r["norm64"]
                                        for r in grad_rows), default=0.0),
           "zero_leaves": sorted({f"{r['leaf']}@{r['step']}" for r in rows
                                  if r.get("leaf_zero")}),
           "activation_ties": ties, "rows": rows}
    log(f"card vs CPU over {n_steps} steps, each from the card's "
        f"state: loss max rel diff {out['loss_max_rel_diff']:.3e}; gradients "
        f"max rel err vs float64 {out['grad_max_rel_err']:.3e} on the card, "
        f"{out['grad_cpu_max_rel_err']:.3e} on the CPU; params/batch_stats "
        f"max abs diff {out['state_max_abs_diff']:.3e} (pin 1e-4), "
        f"zero-to-rounding entries up to {out['walk_max']:.3e}; leaves zero "
        f"to rounding: {out['zero_leaves'] or 'none'}; steps with an "
        f"activation tie (gradient rule waived there): "
        f"{[r['step'] for r in ties] or 'none'}")
    return out


def cli_run(argv):
    """(stdout, the kernel's launches, wall s, return value) of
    `iggcn_tpu_torch.main.main(argv)` on the card; the output is logged."""
    buf = io.StringIO()
    gcn_stack.fused_gcn_stack.launches = 0
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        results = port_main.main(argv)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    text = buf.getvalue()
    log(text.rstrip())
    return text, gcn_stack.fused_gcn_stack.launches, wall_s, results


def run_dir(appendix):
    """The CLI's results dir for `--save_appendix appendix`."""
    return os.path.join(os.getcwd(), "results", f"ADNI{appendix}")


def result_name(layers, hidden, h=2):
    """The CLI's result file stem of a fused-family configuration."""
    return f"result_sgcn_img_snp_layers{layers}_hidden{hidden}_h{h}"


def run_route(train, per_batch):
    """The route's CLI experiment, `iggcn_tpu_torch.main.main(argv)`, on the
    card: every epoch line's losses finite, the `Result -` line printed,
    and the kernel's launches over the run equal to what the loop implies
    at `per_batch` launches per train step and per eval batch. Returns the
    readings and the run's output (`text`)."""
    argv, tcfg = train["argv"], train["tcfg"]
    text, launches, wall_s, results = cli_run(argv)
    epochs = EPOCH_LINE.findall(text)
    if len(epochs) != tcfg.folds * tcfg.epochs:
        raise AssertionError(f"expected {tcfg.folds * tcfg.epochs} epoch "
                             f"lines, got {len(epochs)}")
    bad = [e for e in epochs if not all(np.isfinite(float(v)) for v in e[2:])]
    if bad:
        raise AssertionError(f"non-finite losses: {bad}")
    result = re.search(r"^Result - .*$", text, re.M)
    throughput = re.search(r"^\[throughput\] ([\d.]+) graphs/s$", text, re.M)
    if result is None or throughput is None:
        raise AssertionError("no `Result -` or `[throughput]` line")
    want = expected_launches(train["splits"], tcfg, per_batch,
                             train.get("test_size"))
    if launches != want:
        raise AssertionError(f"the run launched the kernel {launches} "
                             f"times; the loop implies {want}")
    steps_run = sum(tcfg.epochs * math.ceil(len(tr) / tcfg.batch_size)
                    for tr, _, _ in train["splits"])
    shown = " ".join(argv[argv.index("--save_appendix") + 1:])
    log(f"experiment {shown}: {wall_s:.3f} s wall, {launches} "
        f"kernel launches (= {want} implied: {steps_run} train steps x "
        f"{per_batch} + eval batches x {per_batch}), {throughput.group(0)}, "
        f"{result.group(0)}")
    res = results[0]
    return {"text": text, "experiment_wall_s": wall_s, "launches": launches,
            "expected_launches": want, "train_steps": steps_run,
            "result_line": result.group(0),
            "throughput_graphs_per_s": res.throughput_graphs_per_sec,
            "fold_durations_s": res.durations, "subjects": COHORT,
            "folds": tcfg.folds, "epochs": tcfg.epochs,
            "batch": tcfg.batch_size}


def phase_train(dev, train):
    log("== phase 7: training slice at full width")
    out = run_route(train, STACK_CALLS["SGCN_GCN_IMGSNP"])
    out["card_vs_cpu"] = card_vs_cpu_steps(dev, fused_route(train))
    return out


def step_breakdown(train, steps_profiled=5):
    """A warm train step of the route: host wall (median of 10), device busy
    per step (the union of device ops over `steps_profiled` profiled steps)
    and, from one profiled step, the idle share, the kernel's share of
    device time and its launches."""
    for _ in range(3):
        train["step"]()
    torch.cuda.synchronize()
    walls = []
    for _ in range(10):
        t0 = time.perf_counter()
        train["step"]()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    events, _ = profiled(lambda: [train["step"]()
                                  for _ in range(steps_profiled)])
    busy_ms = (summarize_profile(events, 1.0)["device_busy_us"]
               / steps_profiled / 1e3)
    one = summarize_profile(*profiled(train["step"]))
    return {"step_wall_ms": statistics.median(walls),
            "step_device_ms": busy_ms, "profiled_step": one}


def phase_multi_fusion(dev):
    log("== phase 8: multi-fusion training at full width (N=270, F0=1, "
        "L=3, H=10)")
    train = training_setup(dev, MULTI_ARGV)
    per_step = counted_launches(train["step"])
    per_eval = counted_launches(lambda: steps.eval_step(
        train["state"].model, train["eval_batch"], train["mcfg"],
        train["tcfg"], train["kind"]))
    want = STACK_CALLS["SGCN_GCN_IMGSNP"]
    if (per_step, per_eval) != (want, want):
        raise AssertionError(f"a multi-fusion train step / eval batch "
                             f"launched the kernel {per_step} / {per_eval} "
                             f"times; expected {want} / {want}")
    breakdown = step_breakdown(train)
    one = breakdown["profiled_step"]
    log_profile(f"warm multi-fusion train step (B={TRAIN_BATCH}, N=270)", one)
    log(f"multi-fusion train step: host wall {breakdown['step_wall_ms']:.4f} "
        f"ms (median of 10), device busy {breakdown['step_device_ms']:.4f} ms "
        f"(profiler, 5 steps)")
    if one["gcn_stack_launches"] != want:
        raise AssertionError("the profiled multi-fusion step ran the kernel "
                             f"{one['gcn_stack_launches']} times, not {want}")
    out = run_route(train, want)
    out.update(breakdown, launches_per_train_step=per_step,
               launches_per_eval_batch=per_eval,
               card_vs_cpu=card_vs_cpu_steps(dev, fused_route(train)))
    return out


def phase_families(dev):
    log("== phase 9: the other fused families on the card")
    out = {}
    for model in OTHER_FAMILIES:
        log(f"-- {model}")
        extra = ("--export_bundle",) if model in BUNDLE_FAMILIES else ()
        train = training_setup(dev, cli_argv(FAMILY_EPOCHS,
                                             f"_chip_smoke_{model}",
                                             "--model", model, *extra))
        per_step = counted_launches(train["step"])
        per_eval = counted_launches(lambda: steps.eval_step(
            train["state"].model, train["eval_batch"], train["mcfg"],
            train["tcfg"], train["kind"]))
        want = STACK_CALLS[model]
        log(f"{model}: one train step launched the kernel {per_step} times, "
            f"one eval batch {per_eval} (expected {want})")
        if (per_step, per_eval) != (want, want):
            raise AssertionError(f"{model}: {per_step} / {per_eval} launches "
                                 f"per train step / eval batch; expected "
                                 f"{want} / {want}")
        run = run_route(train, want)
        run.update(launches_per_train_step=per_step,
                   launches_per_eval_batch=per_eval,
                   card_vs_cpu=card_vs_cpu_steps(dev, fused_route(train),
                                                 FAMILY_CPU_STEPS))
        out[model] = run
    return out


def serve_bundle(dev, path, cohort, what):
    """One bundle served to `cohort` at batch BATCH on the card and on the
    CPU's plain path: held under phase 3's rule, the kernel's launches per
    served forward required to be the model's (`SERVE_CALLS`), the card's
    cohort wall (median of 3) recorded."""
    gpu_model = load_bundle(path, device=dev)
    cls = type(gpu_model).__name__
    gcn_stack.fused_gcn_stack.launches = 0
    gpu = batched_forward(gpu_model, *cohort, batch_size=BATCH)
    torch.cuda.synchronize()
    launches = gcn_stack.fused_gcn_stack.launches
    forwards = math.ceil(len(cohort[0]) / BATCH)
    if launches != SERVE_CALLS[cls] * forwards:
        raise AssertionError(f"{what}: serving launched the kernel {launches} "
                             f"times over {forwards} forwards; {cls} must "
                             f"launch it {SERVE_CALLS[cls]} per forward")
    cpu = batched_forward(load_bundle(path, device="cpu"), *cohort,
                          batch_size=BATCH)
    compare_predictions(gpu, cpu, f"{what}: card vs CPU serving")
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        batched_forward(gpu_model, *cohort, batch_size=BATCH)
        walls.append(time.perf_counter() - t0)
    out = {"bundle": os.path.relpath(path), "model_class": cls,
           "subjects": len(cohort[0]), "batch": BATCH, "forwards": forwards,
           "launches": launches, "launches_per_forward": launches / forwards,
           "log_probs_max_abs_diff": float(np.abs(
               gpu["log_probs"] - cpu["log_probs"]).max()),
           "cohort_wall_s": statistics.median(walls)}
    log(f"{what} ({cls}, N={cohort[0].shape[1]}): {out['subjects']} subjects "
        f"at batch {BATCH}, {launches} kernel launches over {forwards} "
        f"forwards; card vs CPU log_probs max diff "
        f"{out['log_probs_max_abs_diff']:.3e}; cohort wall "
        f"{out['cohort_wall_s']:.6f} s")
    return out


def explain_checkpoint(dev, ckpt, tag, x_path, adj_path, n_subjects):
    """`tools.explain` on the card over a fold checkpoint: every exported
    importance finite, and on an SGCN image-family checkpoint a finite
    grad-CAM of shape (S, 90) that the CPU's grad-CAM matches (atol
    1e-4)."""
    out_dir = os.path.join(OUT_DIR, f"explain_{tag}")
    shutil.rmtree(out_dir, ignore_errors=True)
    argv = [ckpt, "--out", out_dir, "--prefix", tag, "--x_npy", x_path,
            "--adj_npy", adj_path, "--device", str(dev)]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        explain.main(argv)
    log(buf.getvalue().rstrip())
    exported = {}
    for name in sorted(os.listdir(out_dir)):
        arr = np.load(os.path.join(out_dir, name))
        if not np.isfinite(arr).all():
            raise AssertionError(f"explain {tag}: {name} is not finite")
        exported[name] = list(arr.shape)
    if f"node_importance_{tag}.npy" not in exported:
        raise AssertionError(f"explain {tag}: no node importance exported")
    out = {"checkpoint": os.path.relpath(ckpt), "exported": exported}
    cam_name = f"grad_cam_{tag}.npy"
    if cam_name in exported:
        if exported[cam_name] != [n_subjects, 90]:
            raise AssertionError(f"explain {tag}: grad-CAM shape "
                                 f"{exported[cam_name]}, not ({n_subjects}, 90)")
        payload = explain.load_payload(ckpt)
        cpu_cam = explain.export_grad_cam(
            payload["params"], payload["batch_stats"], np.load(x_path),
            np.load(adj_path), os.path.join(out_dir, "cpu"), tag,
            device="cpu")
        err = float(np.abs(np.load(os.path.join(out_dir, cam_name))
                           - cpu_cam).max())
        if err > 1e-4:
            raise AssertionError(f"explain {tag}: grad-CAM card vs CPU {err}")
        out["grad_cam_card_vs_cpu_max_abs_diff"] = err
    log(f"explain {tag}: {exported}")
    return out


def phase_artifacts(dev, train, cohort):
    log("== phase 10: artifacts, resume, bundles and explain")
    res_dir = run_dir("_chip_smoke_artifacts")
    shutil.rmtree(res_dir, ignore_errors=True)
    tcfg = dataclasses.replace(train["tcfg"], epochs=ARTIFACT_EPOCHS)
    per_batch = STACK_CALLS["SGCN_GCN_IMGSNP"]
    first = run_route(dict(train, argv=ARTIFACT_ARGV, tcfg=tcfg), per_batch)
    name = result_name(train["mcfg"].num_layers, train["mcfg"].hidden)

    def fold_file(stem, k, ext):
        return os.path.join(res_dir, f"{stem}_{name}_fold_{k}.{ext}")

    missing = [path for k in range(tcfg.folds) for path in (
        fold_file("gcn_state_dict", k, "msgpack"),
        fold_file("fold_result", k, "npz"),
        fold_file("serving_bundle", k, "npz")) if not os.path.exists(path)]
    if missing:
        raise AssertionError(f"artifacts missing after the run: {missing}")
    scores_first = np.load(os.path.join(res_dir, f"{name}.npy"))
    losses_first = {}
    for k in RESUME_FOLDS:
        with np.load(fold_file("fold_result", k, "npz")) as zf:
            losses_first[k] = zf["test_losses"]
        os.remove(fold_file("fold_result", k, "npz"))
    text, launches, wall_s, _ = cli_run(ARTIFACT_ARGV + ["--resume"])
    kept = [k for k in range(tcfg.folds) if k not in RESUME_FOLDS]
    restored = sorted(int(k) for k in re.findall(
        r"^\[resume\] fold (\d+) restored", text, re.M))
    if restored != kept:
        raise AssertionError(f"resume restored folds {restored}, not {kept}")
    if re.search(r"^Result - .*$", text, re.M) is None:
        raise AssertionError("the resumed run printed no `Result -` line")
    want = expected_launches([train["splits"][k] for k in RESUME_FOLDS],
                             tcfg, per_batch)
    if launches != want:
        raise AssertionError(f"the resumed run launched the kernel {launches} "
                             f"times; the loop implies {want} for folds "
                             f"{list(RESUME_FOLDS)}")
    scores = np.load(os.path.join(res_dir, f"{name}.npy"))
    if not np.array_equal(scores[kept], scores_first[kept]):
        raise AssertionError("restored folds' score rows differ from the "
                             "first run's")
    gaps = {}
    for k in RESUME_FOLDS:
        with np.load(fold_file("fold_result", k, "npz")) as zf:
            again = zf["test_losses"]
        gaps[k] = float(np.max(np.abs(again - losses_first[k])
                               / np.abs(losses_first[k])))
        if gaps[k] > RESUME_RTOL:
            raise AssertionError(f"retrained fold {k}: per-epoch test losses "
                                 f"{again.tolist()} vs the first run's "
                                 f"{losses_first[k].tolist()} (rel {gaps[k]})")
    same_scores = bool(np.array_equal(scores, scores_first))
    log(f"resume: folds {kept} restored, {list(RESUME_FOLDS)} retrained in "
        f"{wall_s:.3f} s with {launches} kernel launches (= {want} implied); "
        f"restored score rows bit-equal; retrained folds' test losses vs the "
        f"first run max rel diff {max(gaps.values()):.3e} (tolerance "
        f"{RESUME_RTOL}); whole score matrix bit-equal: {same_scores}")

    multi_cohort = make_cohort(np.random.default_rng(4), COHORT, rois=270,
                               feat=1)
    bundles = {
        "flagship N=90": (fold_file("serving_bundle", 0, "npz"), cohort),
        "flagship N=270 (multi-fusion)": (os.path.join(
            run_dir("_chip_smoke_multi"),
            f"serving_bundle_{result_name(3, 10)}_fold_0.npz"), multi_cohort),
        **{model: (os.path.join(run_dir(f"_chip_smoke_{model}"),
                                f"serving_bundle_{name}_fold_0.npz"), cohort)
           for model in BUNDLE_FAMILIES}}
    served = {what: serve_bundle(dev, path, data, what)
              for what, (path, data) in bundles.items()}

    os.makedirs(OUT_DIR, exist_ok=True)
    x_path = os.path.join(OUT_DIR, "explain_x.npy")
    adj_path = os.path.join(OUT_DIR, "explain_adj.npy")
    np.save(x_path, cohort[0][:EXPLAIN_SUBJECTS])
    np.save(adj_path, cohort[1][:EXPLAIN_SUBJECTS])
    explained = {
        "flagship": explain_checkpoint(
            dev, fold_file("gcn_state_dict", 0, "msgpack"), "flagship", x_path,
            adj_path, EXPLAIN_SUBJECTS),
        "SGCN_GCN": explain_checkpoint(dev, os.path.join(
            run_dir("_chip_smoke_SGCN_GCN"),
            f"gcn_state_dict_{name}_fold_0.msgpack"), "sgcn_gcn", x_path,
            adj_path, EXPLAIN_SUBJECTS)}
    if "grad_cam_card_vs_cpu_max_abs_diff" not in explained["SGCN_GCN"]:
        raise AssertionError("explain exported no grad-CAM for SGCN_GCN")
    return {"run": first, "resume": {
        "launches": launches, "expected_launches": want, "wall_s": wall_s,
        "restored_folds": kept, "retrained_folds": list(RESUME_FOLDS),
        "retrained_test_loss_max_rel_diff": gaps,
        "score_matrix_bit_equal": same_scores},
        "serving": served, "explain": explained}


def phase_snps(dev):
    log("== phase 11: the SNP-only families on the card")
    appendix = "_chip_smoke_snps"
    res_dir = run_dir(appendix)
    shutil.rmtree(res_dir, ignore_errors=True)
    argv = snps_argv(appendix)
    args = port_main.build_parser().parse_args(argv)
    with contextlib.redirect_stdout(io.StringIO()):
        snps, labels, topo = port_main.snps_inputs(
            args, None, port_main.build_dcfg(args),
            np.random.default_rng(args.seed))
    out, total_launches = {}, 0
    for model in SNP_MODELS:
        kind = "mlp" if model == "MLP_Model" else "go"
        text, launches, wall_s, res = cli_run(["--model", model, *argv])
        total_launches += launches
        result = re.search(rf"^Result - .* \(SNP-only, {model}\)$", text, re.M)
        if result is None:
            raise AssertionError(f"{model}: no `Result - ... (SNP-only)` line")
        losses = []
        for k in range(TRAIN_FOLDS):
            with np.load(os.path.join(
                    res_dir, f"fold_result_snps_{kind}_fold_{k}.npz")) as zf:
                losses.extend(zf["losses"].tolist())
            bundle = os.path.join(res_dir,
                                  f"serving_bundle_snps_{kind}_fold_{k}.npz")
            if not os.path.exists(bundle):
                raise AssertionError(f"{model}: no bundle {bundle}")
        scores = np.load(os.path.join(res_dir, f"result_snps_{kind}.npy"))
        if (scores.shape != (TRAIN_FOLDS, SNP_EPOCHS, 5)
                or not np.isfinite(scores).all()
                or not np.isfinite(losses).all()
                or len(losses) != TRAIN_FOLDS * SNP_EPOCHS):
            raise AssertionError(f"{model}: scores {scores.shape} or losses "
                                 f"{losses} not finite / complete")
        log(f"{model}: {wall_s:.3f} s wall, {launches} kernel launches, "
            f"mean test loss per fold-epoch {np.mean(losses):.5f}, "
            f"{result.group(0)}")
        out[model] = {
            "experiment_wall_s": wall_s, "launches": launches,
            "result_line": result.group(0), "mean_test_loss": res.mean_loss,
            "card_vs_cpu": card_vs_cpu_steps(
                dev, snps_route(kind, snps, labels, topo, args.seed,
                                TRAIN_BATCH), FAMILY_CPU_STEPS)}

    gcn_stack.fused_gcn_stack.launches = 0
    served = {}
    for model, kind in (("Gene_ontology_network", "go"), ("MLP_Model", "mlp")):
        path = os.path.join(res_dir, f"serving_bundle_snps_{kind}_fold_0.npz")
        gpu_model = load_bundle(path, device=dev)
        gpu = batched_forward_snps(gpu_model, snps, batch_size=BATCH)
        cpu = batched_forward_snps(load_bundle(path, device="cpu"), snps,
                                   batch_size=BATCH)
        err = compare_snps_predictions(gpu, cpu, f"{model} bundle")
        served[model] = {"subjects": len(snps), "prob_max_abs_diff": err,
                         "positives": int(gpu["pred"].sum())}
        log(f"{model} bundle served {len(snps)} subjects on the card: prob "
            f"max diff vs CPU {err:.3e}, {served[model]['positives']} "
            "predicted positive")
        if kind == "go":
            go_model, go_pred = gpu_model, gpu
    server = build_http_server(go_model, device=dev, port=0, batch=BATCH)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        addr = server.server_address[:2]
        health = _get(addr, "/health")
        log(f"/health {json.dumps(health)}")
        if health["inputs"] != "snps" or health["num_snps"] != snps.shape[1]:
            raise AssertionError(f"SNP-only /health {health}")
        lo = 0
        for n in (1, 37, 256):
            got = _post(addr, {"snps": snps[lo:lo + n]})
            compare_snps_predictions(
                got, {k: v[lo:lo + n] for k, v in go_pred.items()},
                f"SNP-only /predict of {n} subjects")
            lo += n
        stats = _get(addr, "/stats")
        if (stats["requests"], stats["errors"]) != (3, 0):
            raise AssertionError(f"SNP-only /stats {stats}")
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    total_launches += gcn_stack.fused_gcn_stack.launches
    if total_launches:
        raise AssertionError(f"the SNP-only families launched the kernel "
                             f"{total_launches} times; they run no GCN stack")
    log(f"SNP-only daemon: 3 /predict requests match the one-shot card "
        f"predictions; /stats {json.dumps(stats)}; kernel launches over the "
        f"phase: {total_launches}")
    return {"families": out, "serving": served, "http_stats": stats,
            "launches": total_launches}


# ---------------------------------------------------------------------------
# phase 14: the baseline, pooling and nested zoo

class ZooState:
    """A zoo model, its optimiser, its generic train step and the count of
    steps taken."""

    def __init__(self, model, wiring):
        self.model = model
        self.optimizer = generic_cv.make_generic_optimizer(model)
        self.train_step, _ = generic_cv.build_generic_steps(
            model, self.optimizer, **wiring)
        self.step = 0


def zoo_argv(model, appendix, cache_dir):
    """The zoo CLI route on the card: phase 7's synthetic 874-subject,
    90-ROI cohort through a shared cohort cache (one build for the 13
    runs), L=2, H=16, batch 32, 5 folds with val, 1 epoch."""
    return ["--device", "cuda", "--model", model, "--synthetic",
            "--synthetic_subjects", str(COHORT), "--synthetic_go_levels",
            GO_LEVELS, "--no-search", "--layers", "2", "--hiddens", "16",
            "--batch_size", str(TRAIN_BATCH), "--fold", str(TRAIN_FOLDS),
            "--epochs", str(ZOO_EPOCHS), "--save_appendix", appendix,
            "--cohort_cache_dir", cache_dir]


def nested_argv(model, appendix):
    """The Nested* CLI route on the card: the synthetic TU benchmark (no
    raw SYNTH files under --tu_root) at h=2, otherwise `zoo_argv`'s."""
    return ["--device", "cuda", "--model", model, "--data", "SYNTH",
            "--synthetic", "--h", "2", "--no-search", "--layers", "2",
            "--hiddens", "16", "--batch_size", str(TRAIN_BATCH), "--fold",
            str(TRAIN_FOLDS), "--epochs", str(ZOO_EPOCHS), "--save_appendix",
            appendix, "--tu_root", os.path.join(REPO, "results", "no_tu")]


def zoo_data(argv):
    """(args, dataset) of a zoo command line, built as the CLI builds it
    (for the Nested* names, the graphs their nested dataset is made of:
    same labels, so same splits)."""
    args = port_main.build_parser().parse_args(argv)
    with contextlib.redirect_stdout(io.StringIO()):
        ds = port_main.zoo_dataset(args, port_main.build_dcfg(args),
                                   np.random.default_rng(args.seed))
    return args, ds


def zoo_route(args, ds):
    """`card_vs_cpu_steps`' route of a zoo model: fold 0 of the generic CV
    at dropout 0 (its weights from seed + 0 on the CPU), the first epoch's
    shuffled train batches, the generic train step (loss x sum(w)) at the
    epoch-0 learning rate."""
    template, kw = port_main.build_zoo_model(args.model, args.layers,
                                             args.hiddens, ds)
    model, _ = generic_cv.init_generic_model(template, args.seed, 0,
                                             torch.device("cpu"))
    wiring = {k: kw.get(k, False) for k in (
        "needs_mask", "needs_assign", "adj_only", "aux_loss",
        "takes_weight")}
    train_idx = k_fold(ds.y, TRAIN_FOLDS, args.seed)[0][0]
    idx, w = pad_epoch_indices(
        np.random.default_rng(args.seed * 31).permutation(train_idx),
        TRAIN_BATCH)
    data = {k: getattr(ds, k)[idx] for k in generic_cv.BATCH_KEYS
            if getattr(ds, k, None) is not None}
    data["w"] = w
    lr_t = snps_trainer.steplr_host(args.lr, args.lr_decay_factor,
                                    args.lr_decay_step_size, 0)

    def step(state, batch):
        state.step += 1
        return float(state.train_step(batch, None, lr_t) * batch["w"].sum())

    return {"model": quiet(model), "batch": TRAIN_BATCH, "data": data,
            "state": lambda m: ZooState(m, wiring), "step": step,
            "lr": lambda t: lr_t}


def run_zoo(dev, argv):
    """One zoo CLI experiment on the card: every per-epoch accuracy finite,
    the `Using` and `Result -` lines printed; returns its readings."""
    args, ds = zoo_data(argv)
    text, launches, wall_s, results = cli_run(argv)
    accs = re.findall(r"^fold \d+ epoch \d+: acc (\S+)$", text, re.M)
    if (len(accs) != TRAIN_FOLDS * ZOO_EPOCHS
            or not all(np.isfinite(float(a)) for a in accs)):
        raise AssertionError(f"{args.model}: per-epoch lines {accs}")
    result = re.search(r"^Result - .*$", text, re.M)
    if result is None or "Using 2 layers, 16 hidden units" not in text:
        raise AssertionError(f"{args.model}: no `Using`/`Result -` line")
    splits = k_fold(ds.y, TRAIN_FOLDS, args.seed)
    graphs = ZOO_EPOCHS * sum(len(tr) for tr, _, _ in splits)
    log(f"{args.model}: {wall_s:.3f} s wall, {graphs / wall_s:.1f} train "
        f"graphs/s over the experiment, {launches} kernel launches, "
        f"mean test loss {results[0].mean_loss:.5f}, {result.group(0)}")
    return {"args": args, "dataset": ds, "splits": splits,
            "experiment_wall_s": wall_s, "launches": launches,
            "throughput_graphs_per_s": graphs / wall_s,
            "result_line": result.group(0), "epochs": ZOO_EPOCHS,
            "mean_test_loss": results[0].mean_loss,
            "nodes": int(ds.x.shape[1]), "graphs": len(ds)}


def gcn_launch_counts(dev, route):
    """The kernel's launches in one generic train step and one eval batch
    of the GCN route's first batch on the card (both must be 1)."""
    card = route["state"](copy.deepcopy(route["model"]).to(dev))
    batch = to_device({k: v[:TRAIN_BATCH] for k, v in route["data"].items()},
                      dev)
    _, evaluate = generic_cv.build_generic_steps(
        card.model, card.optimizer, needs_mask=False, needs_assign=False,
        adj_only=False, aux_loss=False, takes_weight=False)
    per_step = counted_launches(lambda: card.train_step(batch, None, 1e-3))
    per_eval = counted_launches(lambda: evaluate(batch))
    if (per_step, per_eval) != (1, 1):
        raise AssertionError(f"GCN: {per_step} / {per_eval} launches per "
                             "train step / eval batch; expected 1 / 1")
    return per_step, per_eval


def phase_zoo(dev):
    log("== phase 14: the baseline, pooling and nested zoo on the card")
    t0 = time.perf_counter()
    out = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_zoo_") as cache:
        for model in port_main.ZOO_MODELS:
            appendix = f"_chip_smoke_zoo_{model}"
            shutil.rmtree(run_dir(appendix), ignore_errors=True)
            argv = (nested_argv(model, appendix)
                    if model.startswith("Nested")
                    else zoo_argv(model, appendix, cache))
            run = run_zoo(dev, argv)
            args, ds, splits = (run.pop(k) for k in ("args", "dataset",
                                                     "splits"))
            # the GCN stack's kernel runs in GCNFlat only: 1 launch per
            # train step and per eval batch, 0 for every other name
            want = expected_launches(
                splits, types.SimpleNamespace(batch_size=args.batch_size,
                                              epochs=args.epochs),
                1 if model == "GCN" else 0)
            if run["launches"] != want:
                raise AssertionError(f"{model}: the run launched the kernel "
                                     f"{run['launches']} times; the loop "
                                     f"implies {want}")
            run["expected_launches"] = want
            if model in ZOO_CARD_CPU:
                route = zoo_route(args, ds)
                if model == "GCN":
                    (run["launches_per_train_step"],
                     run["launches_per_eval_batch"]) = gcn_launch_counts(
                        dev, route)
                run["card_vs_cpu"] = card_vs_cpu_steps(dev, route)
            out[model] = run
    total = time.perf_counter() - t0
    log(f"phase 14: {total:.3f} s for the {len(out)} zoo names")
    return {"models": out, "phase_s": total}


# ---------------------------------------------------------------------------
# phases 12-13: the real-cohort route on a fabricated reference layout

def write_go_sources(dirpath, rng, level_sizes=REAL_GO_LEVELS,
                     num_snps=54, num_genes=300):
    """A PANTHER-style GO analysis json, a root-connection file and a
    `num_snps`-row snps_to_gene.txt under `dirpath` whose parse
    (`parse_go_json`) is a five-level DAG of `level_sizes` terms, leaves
    first. The connection chains `0008150.A.B.C` put every level-1 (A),
    level-2 (B) and level-3 (C) term under the root; every pathway of the
    json is [D, C] at PANTHER levels [1, 2], so the parser's edge runs from
    C to D and the level-4 terms D hang under the C terms. Returns the
    three paths."""
    n4, n3, n2, n1, root = level_sizes
    if root != 1:
        raise ValueError("the root level has one term")
    ids = iter(range(1, 10 ** 7))

    def fresh(n):
        return [f"{next(ids):07d}" for _ in range(n)]

    lvl1, lvl2, lvl3, lvl4 = fresh(n1), fresh(n2), fresh(n3), fresh(n4)
    genes = [f"GENE{i}" for i in range(num_genes)]

    def term(num, level):
        mapped = list(rng.choice(genes, size=int(rng.integers(1, 4)),
                                 replace=False))
        return {"term": {"id": f"GO:{num}", "level": level},
                "input_list": {"mapped_id_list": {
                    "mapped_id": mapped if len(mapped) > 1 else mapped[0]}}}

    groups = [{"result": [term(d, 1), term(lvl3[i % n3], 2)]}
              for i, d in enumerate(lvl4)]
    paths = (os.path.join(dirpath, "analysis.json"),
             os.path.join(dirpath, "go_root_connection.txt"),
             os.path.join(dirpath, "snps_to_gene.txt"))
    with open(paths[0], "w") as fh:
        json.dump({"overrepresentation": {"group": groups}}, fh)
    with open(paths[1], "w") as fh:
        for i, c in enumerate(lvl3):
            b = i % n2
            fh.write(f"0008150.{lvl1[b % n1]}.{lvl2[b]}.{c}\n")
    with open(paths[2], "w") as fh:
        for _ in range(num_snps):
            fh.write(";".join(rng.choice(genes, size=int(rng.integers(1, 6)),
                                         replace=False)) + "\n")
    return paths


def write_mat_layout(base, rng, subjects=COHORT, rois=90, feat=3,
                     num_snps=54, multi_fusion=True):
    """The reference's `.mat` cohort layout under `base` (what
    `load_adni874` reads): `knn/5/` with subject ids, demographics with NaN
    holes and their filled copy, SNPs with NaNs, raw labels 1..5,
    symmetric positive correlation matrices, ROI features with a NaN,
    cluster labels (`center_2/`) and the PET similarity features; with
    `multi_fusion` the three modality dirs' `knn/5/corr_data.mat` too."""
    import scipy.io as sio

    kdir = os.path.join(base, "knn", "5")
    os.makedirs(os.path.join(kdir, "center_2"), exist_ok=True)

    def corr():
        a = np.abs(rng.normal(size=(subjects, rois, rois)))
        return (a + a.transpose(0, 2, 1)) / 2 + 0.05

    scores = rng.normal(size=(subjects, 9))
    holes = scores.copy()
    holes[rng.random(holes.shape) < 0.1] = np.nan
    snps = rng.random((subjects, num_snps))
    snps[rng.random(snps.shape) < 0.02] = np.nan
    img = rng.normal(size=(subjects, rois, feat))
    img[0, 0, 0] = np.nan
    for name, key, value in (
            ("sbjID_int", "sbjID_int",
             np.arange(1000, 1000 + subjects).reshape(-1, 1)),
            ("score_excel_val_adni874_fill", "info_score_val_fill", scores),
            ("score_excel_val_adni874", "info_score_val_subs", holes),
            ("SNPS_data", "SNPS_data", snps),
            ("BL_DXGrp_label", "BL_DXGrp_label",
             rng.integers(1, 6, size=(subjects, 1))),
            ("corr_data", "corr_data", corr()),
            ("imgData_mat_normalized_fix", "imgData_mat_normalized", img)):
        sio.savemat(os.path.join(kdir, f"{name}.mat"), {key: value})
    np.save(os.path.join(kdir, "center_2", "clusters_pred_label.npy"),
            rng.integers(0, 2, subjects))
    np.save(os.path.join(kdir, "pet_for_similarity.npy"),
            rng.normal(size=(subjects, 8)).astype(np.float32))
    if multi_fusion:
        for mod in ("MRI", "FDG-PET", "AV45-PET"):
            mdir = os.path.join(base, mod, "knn", "5")
            os.makedirs(mdir, exist_ok=True)
            sio.savemat(os.path.join(mdir, "corr_data.mat"),
                        {"corr_data": corr()})


def real_layout(root):
    """The fabricated real-data layout of phases 12-13 under `root`: the
    874-subject `.mat` cohort at 90 ROIs (with the multi-fusion dirs), the
    GO sources of `REAL_GO_LEVELS` and a cohort cache dir."""
    rng = np.random.default_rng(6)
    data = os.path.join(root, "preprocessing")
    write_mat_layout(data, rng, subjects=COHORT)
    go = write_go_sources(root, rng)
    return {"data_path": data, "go": go, "cache": os.path.join(root, "cache")}


def real_argv(layout, epochs, appendix, *extra):
    """The real-cohort CLI route on the card at phase 7's setting (batch 32,
    5 folds with val, --lambda_disease 1.0, L=2, H=16) over `layout`."""
    json_path, conn_path, genes_path = layout["go"]
    return ["--device", "cuda", "--data_path", layout["data_path"],
            "--json_path", json_path, "--go_connection_path", conn_path,
            "--snps_to_gene_path", genes_path, "--epochs", str(epochs),
            "--fold", str(TRAIN_FOLDS), "--batch_size", str(TRAIN_BATCH),
            "--no-search", "--layers", "2", "--hiddens", "16",
            "--lambda_disease", "1.0", "--save_appendix", appendix, *extra]


def phase_real_cohort(dev, layout):
    log("== phase 12: the real-cohort route (fabricated reference layout)")
    args = port_main.build_parser().parse_args(
        real_argv(layout, REAL_EPOCHS, "_chip_smoke_real"))
    dcfg = port_main.build_dcfg(args)
    t0 = time.perf_counter()
    cohort = adni.load_adni874(dcfg)
    load_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    topo = go_graph.parse_go_json(*layout["go"])
    parse_s = time.perf_counter() - t0
    log(f"load_adni874: {len(cohort)} subjects, x {cohort.x.shape}, adj "
        f"{cohort.adj.shape}, classes {np.bincount(cohort.y).tolist()} in "
        f"{load_s:.3f} s; parse_go_json: {topo.n} terms, pool {topo.pool} "
        f"in {parse_s:.3f} s (host)")
    if len(topo.pool) != 5 or min(topo.pool) < 1 or topo.pool[-1] != 1:
        raise AssertionError(f"the GO sources parse into pool {topo.pool}, "
                             "not five non-empty levels under one root")

    cached = real_argv(layout, REAL_EPOCHS, "_chip_smoke_real",
                       "--export_bundle", "--cohort_cache_dir",
                       layout["cache"])
    train = training_setup(dev, real_argv(layout, REAL_EPOCHS,
                                          "_chip_smoke_real",
                                          "--cohort_cache_dir", ""))
    per_batch = STACK_CALLS["SGCN_GCN_IMGSNP"]
    first = run_route(dict(train, argv=cached), per_batch)
    entries = glob.glob(os.path.join(layout["cache"], "adni874-*.npz"))
    if len(entries) != 1:
        raise AssertionError(f"cache entries after the first run: {entries}")
    again = run_route(dict(train, argv=real_argv(
        layout, REAL_EPOCHS, "_chip_smoke_real_again", "--cohort_cache_dir",
        layout["cache"])), per_batch)
    text = again.pop("text")
    hit = re.search(r"^\[data\] cohort loaded from cache \((adni874-\w+)\)$",
                    text, re.M)
    if hit is None or not cohort_cache.equal_cohorts(
            cohort_cache.load_cohort(entries[0]), cohort):
        raise AssertionError("the second run did not hit the cache, or the "
                             "cached cohort differs from load_adni874's")
    log(f"cohort cache: first run {first['experiment_wall_s']:.3f} s (miss, "
        f"entry written), second {again['experiment_wall_s']:.3f} s (hit "
        f"{hit.group(1)}); the entry equals load_adni874's cohort")
    first["card_vs_cpu"] = card_vs_cpu_steps(dev, fused_route(train))

    multi_tcfg = dataclasses.replace(train["tcfg"], epochs=1)
    multi = run_route(dict(train, tcfg=multi_tcfg, argv=real_argv(
        layout, 1, "_chip_smoke_real_multi", "--isMultiFusion", "--layers",
        "3", "--hiddens", "10", "--cohort_cache_dir", "")), per_batch)

    os.makedirs(OUT_DIR, exist_ok=True)
    served_npz = os.path.join(OUT_DIR, "real_cohort.npz")
    with contextlib.redirect_stdout(io.StringIO()):
        export_cohort.main(["--data_path", layout["data_path"], "--out",
                            served_npz])
    with np.load(served_npz) as zf:
        exported = tuple(zf[k] for k in ("x", "adj", "snps"))
    bundle = os.path.join(run_dir("_chip_smoke_real"),
                          f"serving_bundle_{result_name(2, 16)}_fold_0.npz")
    served = serve_bundle(dev, bundle, exported,
                          "real-cohort flagship bundle over the exported npz")
    readings = {"load_adni874_s": load_s, "parse_go_json_s": parse_s,
                "go_pool": topo.pool, "subjects": len(cohort), "run": first,
                "cached_run": again, "cache_key": hit.group(1),
                "multi_fusion": multi, "serving": served}
    return readings, {"train": train, "exported": exported}


def phase_other_routes(dev, layout, real):
    log("== phase 13: the permutation test, the held-out ADNI type and "
        "--init_from_torch")
    train = real["train"]
    per_batch = STACK_CALLS["SGCN_GCN_IMGSNP"]
    one_epoch = dataclasses.replace(train["tcfg"], epochs=1)

    appendix = "_chip_smoke_permut"
    permut_dir = os.path.join(os.getcwd(), "results_permuttest",
                              f"ADNI{appendix}")
    shutil.rmtree(permut_dir, ignore_errors=True)
    permut = run_route(dict(train, tcfg=one_epoch, argv=real_argv(
        layout, 1, appendix, "--isPermutTest", "--Seed4PermutTest", "3",
        "--cohort_cache_dir", "")), per_batch)
    written = sorted(os.listdir(permut_dir))
    kept = [f for f in written if f.endswith((".npy", ".msgpack"))]
    records = [f for f in written if f.startswith("fold_result_")]
    if kept or len(records) != TRAIN_FOLDS:
        raise AssertionError(f"the permutation run wrote {written}: it must "
                             "write fold records only, no checkpoint or npy")
    log(f"--isPermutTest: {permut_dir} holds {written}")
    permut["written"] = written

    argv = cli_argv(1, "_chip_smoke_adnitype", "--isTestAdnitype")
    args = port_main.build_parser().parse_args(argv)
    with contextlib.redirect_stdout(io.StringIO()):
        cohort, _ = port_main.load_cohort(args, port_main.build_dcfg(args),
                                          np.random.default_rng(args.seed))
    held_in, held_out = adni.separate_data_adnitype(
        cohort, args.disease_id4Adnitype, args.adnitype_id)
    tcfg = dataclasses.replace(one_epoch, seed=args.seed)
    adnitype = run_route(dict(
        train, argv=argv, tcfg=tcfg, test_size=len(held_out),
        splits=k_fold(held_in.y, tcfg.folds, tcfg.seed)), per_batch)
    subids = np.load(os.path.join(run_dir("_chip_smoke_adnitype"),
                                  f"subids_{result_name(2, 16)}.npy"))
    want_ids = cohort.sbj_id[cohort.adni_type == args.adnitype_id]
    if not np.array_equal(subids, np.tile(want_ids, tcfg.folds)):
        raise AssertionError("the external test pass did not cover exactly "
                             "the held-out subjects in every fold")
    log(f"--isTestAdnitype: {len(held_in)} subjects in the folds, every fold "
        f"tested on the {len(held_out)} held-out ones")
    adnitype.update(train_subjects=len(held_in), held_out=len(held_out))

    topo = go_graph.parse_go_json(*layout["go"])
    model = FusedSGCN(ModelConfig(num_classes=3), topo,
                      generator=torch.Generator().manual_seed(5))
    variables = to_flax_variables(model)
    ckpt = os.path.join(OUT_DIR, "reference_state_dict.pt")
    torch.save({k: torch.from_numpy(v) for k, v in
                import_torch.export_reference_state_dict(
                    variables["params"], variables["batch_stats"], topo,
                    model.cfg).items()}, ckpt)
    sd = import_torch._load_state_dict(ckpt)
    params, stats = import_torch.convert_fused_state_dict(
        sd, topo, import_torch.infer_model_config(sd, topo))
    want = flat_tree({"params": params, "batch_stats": stats}, ())
    seen = []
    fold_init = port_cv.init_fold_model

    def capture(*a, **kw):
        fold_model, generator = fold_init(*a, **kw)
        if not seen:
            seen.append(flat_tree(to_flax_variables(fold_model), ()))
        return fold_model, generator

    port_cv.init_fold_model = capture
    try:
        warm = run_route(dict(train, tcfg=one_epoch, argv=real_argv(
            layout, 1, "_chip_smoke_warm", "--init_from_torch", ckpt,
            "--cohort_cache_dir", "")), per_batch)
    finally:
        port_cv.init_fold_model = fold_init
    text = warm.pop("text")
    if re.search(r"^\[init_from_torch\] warm-starting every fold from "
                 r"reference_state_dict\.pt:\w+$", text, re.M) is None:
        raise AssertionError("no `[init_from_torch]` tag line")
    if seen[0].keys() != want.keys() or any(
            not np.array_equal(seen[0][k], want[k]) for k in want):
        raise AssertionError("fold 0's weights before its first step differ "
                             "from the converted checkpoint")
    log(f"--init_from_torch: fold 0 starts from the converted checkpoint, "
        f"{len(want)} leaves bit-equal")
    bundle = os.path.join(OUT_DIR, "imported_bundle.npz")
    with contextlib.redirect_stdout(io.StringIO()):
        if import_torch.main(["--ckpt", ckpt, "--out", bundle,
                              "--json_path", layout["go"][0],
                              "--go_connection_path", layout["go"][1],
                              "--snps_to_gene_path", layout["go"][2]]):
            raise AssertionError("import_torch failed on the exported .pt")
    served = serve_bundle(dev, bundle, real["exported"],
                          "imported reference .pt bundle")
    return {"permut": permut, "adnitype": adnitype, "init_from_torch": warm,
            "imported_serving": served}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script drives the "
              "port on an NVIDIA GPU", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    card, build_s = phase_build()
    max_err, train_grad_err = phase_kernel_vs_plain(dev)
    cohort = make_cohort(np.random.default_rng(1), COHORT)
    model, served, launches = phase_serve(dev, cohort)
    http_times = phase_http(dev, model, cohort, served)
    times = phase_times(dev, torch.cuda.get_device_name(0), model, cohort)
    train = training_setup(dev)
    train_times = phase_train_times(dev, train)
    profile = phase_profile(dev, model, cohort, train)
    training = phase_train(dev, train)
    multi = phase_multi_fusion(dev)
    families = phase_families(dev)
    artifacts = phase_artifacts(dev, train, cohort)
    snps = phase_snps(dev)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_real_") as root:
        layout = real_layout(root)
        real, real_ctx = phase_real_cohort(dev, layout)
        other = phase_other_routes(dev, layout, real_ctx)
    zoo = phase_zoo(dev)

    serving, *others = times["shapes"]
    # per route: the kernel's launches per train step and per eval batch,
    # and over the route's whole CLI run against the loop's count
    routes = {"SGCN_GCN_IMGSNP": training, "SGCN_GCN_IMGSNP --isMultiFusion":
              multi, **families,
              "SGCN_GCN_IMGSNP real cohort": real["run"],
              "SGCN_GCN_IMGSNP real cohort, cache hit": real["cached_run"],
              "SGCN_GCN_IMGSNP --isMultiFusion real cohort":
                  real["multi_fusion"],
              "SGCN_GCN_IMGSNP --isPermutTest": other["permut"],
              "SGCN_GCN_IMGSNP --isTestAdnitype": other["adnitype"],
              "SGCN_GCN_IMGSNP --init_from_torch":
                  other["init_from_torch"],
              "GCN": zoo["models"]["GCN"]}
    served_bundles = {**artifacts["serving"],
                      "real-cohort flagship": real["serving"],
                      "imported reference .pt": other["imported_serving"]}
    per_route = {name: {
        "launches_per_train_step": run.get(
            "launches_per_train_step",
            profile["train_step"]["gcn_stack_launches"]),
        "launches_per_eval_batch": run.get(
            "launches_per_eval_batch", profile["eval_batch_launches"]),
        "launches_run": run["launches"],
        "expected_launches_run": run["expected_launches"]}
        for name, run in routes.items()}
    kernels = {"kernels": [{
        "name": "gcn_stack", "route": "cuda",
        "source": "iggcn_tpu_torch/csrc/gcn_stack.cu",
        "replaces": "iggcn_tpu/ops/pallas_gcn.py:83",
        "launches": launches, "max_abs_err": max_err,
        "ms": serving["kernel_ms"], "kernel_ms": serving["kernel_ms"],
        "cold_ms": serving["kernel_cold_ms"],
        "plain_ms": serving["plain_ms"], "bound_ms": serving["bound_ms"],
        "bound_by": serving["bound_by"], "library_ms": serving["library_ms"],
        "training": {
            "launches_per_train_step":
                profile["train_step"]["gcn_stack_launches"],
            "launches_per_eval_batch": profile["eval_batch_launches"],
            "launches_run": training["launches"],
            "expected_launches_run": training["expected_launches"],
            "step_device_ms": train_times["step_device_ms"],
            "step_span_ms": train_times["step_span_ms"],
            "step_wall_ms": train_times["step_wall_ms"],
            "fwd_kernel_b32_ms": train_times["fwd_kernel_b32_ms"],
            "bwd_recompute_b32_ms": train_times["bwd_recompute_b32_ms"],
            "grad_max_abs_err_b32": train_grad_err,
            "step_gcn_stack_share": profile["train_step"]["gcn_stack_share"],
            "step_idle_share": profile["train_step"]["idle_share"]},
        "multi_fusion_training": {
            "step_device_ms": multi["step_device_ms"],
            "step_wall_ms": multi["step_wall_ms"],
            "step_gcn_stack_share":
                multi["profiled_step"]["gcn_stack_share"],
            "step_idle_share": multi["profiled_step"]["idle_share"]},
        "launches_per_train_step": {
            name: r["launches_per_train_step"] for name, r in
            per_route.items()},
        "routes": per_route,
        "resume": {k: artifacts["resume"][k] for k in (
            "launches", "expected_launches", "restored_folds",
            "retrained_folds")},
        "served_bundles": {what: {k: row[k] for k in (
            "model_class", "launches", "launches_per_forward", "forwards")}
            for what, row in served_bundles.items()},
        "snps_only_launches": snps["launches"],
        "shapes": [{k: row[k] for k in (
            "shape", "B", "N", "F0", "widths", "kernel_ms", "kernel_cold_ms",
            "plain_ms", "plain_cold_ms", "library_ms", "library_cold_ms",
            "bound_ms", "bound_by")} for row in others]}]}
    serve = {"serve": {"subjects": COHORT, "batch": BATCH,
                       "cohort_wall_s": times["serve_cohort_s"],
                       "request_subjects": BATCH, **http_times},
             "train": {"experiment_wall_s": training["experiment_wall_s"],
                       "throughput_graphs_per_s":
                           training["throughput_graphs_per_s"],
                       "epoch_graphs_per_s": train_times["epoch_graphs_per_s"],
                       "step_wall_ms": train_times["step_wall_ms"],
                       "step_device_ms": train_times["step_device_ms"],
                       "result_line": training["result_line"],
                       "card_vs_cpu_loss_max_rel_diff":
                           training["card_vs_cpu"]["loss_max_rel_diff"]},
             "routes": {name: {
                 "experiment_wall_s": run["experiment_wall_s"],
                 "throughput_graphs_per_s": run["throughput_graphs_per_s"],
                 "epochs": run["epochs"], "result_line": run["result_line"],
                 "card_vs_cpu_loss_max_rel_diff":
                     run["card_vs_cpu"]["loss_max_rel_diff"]
                     if "card_vs_cpu" in run else None}
                 for name, run in routes.items()},
             "real_cohort": {k: real[k] for k in (
                 "load_adni874_s", "parse_go_json_s", "go_pool", "subjects",
                 "cache_key")},
             "bundles": {what: {k: row[k] for k in (
                 "subjects", "cohort_wall_s", "log_probs_max_abs_diff")}
                 for what, row in served_bundles.items()},
             "resume": {"wall_s": artifacts["resume"]["wall_s"],
                        "retrained_test_loss_max_rel_diff": max(
                            artifacts["resume"][
                                "retrained_test_loss_max_rel_diff"].values())},
             "zoo": {"phase_s": zoo["phase_s"], **{model: {
                 k: run[k] for k in (
                     "experiment_wall_s", "throughput_graphs_per_s",
                     "result_line", "launches", "expected_launches",
                     "graphs", "nodes")}
                 for model, run in zoo["models"].items()}},
             "snps_only": {model: {
                 "experiment_wall_s": run["experiment_wall_s"],
                 "result_line": run["result_line"],
                 "card_vs_cpu_loss_max_rel_diff":
                     run["card_vs_cpu"]["loss_max_rel_diff"]}
                 for model, run in snps["families"].items()}}
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": torch.cuda.device_count()}
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "result.json"), "w") as fh:
        json.dump({"card": card, "build_s": build_s, **kernels, **serve,
                   "times": times, "train_times": train_times,
                   "profile": profile, "training": training,
                   "multi_fusion": multi, "families": families,
                   "artifacts": artifacts, "snps_only": snps,
                   "real_cohort": real, "other_routes": other, "zoo": zoo,
                   "device": device}, fh, indent=1, default=float)
    log(card)
    log(json.dumps(serve))
    log(json.dumps(kernels))
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
