"""Drive the PyTorch port on one NVIDIA GPU and check it end to end.

Run from the repository root on a machine with a CUDA card:

    python3 chip_smoke.py

It imports nothing of JAX or of the JAX package. Phases, in order; any
failure propagates and the script exits non-zero:

  1. card and build: the `nvidia-smi` name/power-limit line, the python,
     torch, CUDA, numpy and scipy versions, then every CUDA source under
     iggcn_tpu_torch/csrc/ built by nvcc (one process per source, all
     started together), with the build time and ptxas's
     register/shared-memory report, which must show no spills;
  2. kernel vs plain on the card: `fused_gcn_stack` against
     `gcn_stack_reference` at every imaging-stack shape of both search
     grids (N=90, F0=3 and N=270, F0=1; B in {1, 7, 32, 64, 256}), each
     with P in both layouts the kernel takes (as `gcn_propagation_matrix`
     returns it, and row-major), one P with isolated nodes, shapes beyond the
     grids at which `plan_launch` picks each other cluster size and K
     split, and transposed P that the bulk copy cannot take (odd N, a
     4-byte-offset view); rtol 1e-4 / atol 1e-5 (fp32, different summation
     order), plus the autograd gradients through both, and at the training
     shape (B=32, N=90) with P built by `gcn_propagation_matrix` from an
     adjacency that requires grad (the transposed view the training path
     passes), gradients into the adjacency included; rtol/atol 1e-4; and
     the grouped form (F weight sets of B samples in one launch, the
     fold-parallel trainer's) against `gcn_stack_reference_grouped` at
     F in {1, 5} x B=32 at N=90, F=5 at N=270 (the 2-CTA path), the
     3-seed x 5-fold batch (F=15) and phase 20's rank-local 5 x 8 and
     5 x 16, P in both layouts, one launch per
     call, each set's samples bit-equal to a launch of that set alone,
     and through `torch.func.vmap` over the fold axis as the model calls
     it, gradients included; then the stack's backward kernel (one
     launch per backward call, through `fused_gcn_stack`'s autograd)
     against `gcn_stack_backward_reference` and against autograd of the
     forward's plain version, rtol/atol 1e-4, at every grid shape x B in
     {1, 7, 32} and the branch shapes at B=7, both P layouts, P and x
     with and without grad, isolated nodes with zero biases (z ties at
     0), odd N and a 4-byte-offset P, every grouped shape in both layouts
     and through vmap with one weight broadcast to every fold; every call
     made twice, bit-equal;
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
     kernel's forward at B=32, and graphs/s over one epoch;
     the grouped form likewise at the fold-parallel train batch (5 x 32,
     N=90), the seed batch's (15 x 32), multi-fusion's (5 x 32, N=270)
     and phase 20's rank-local 5 x 8, 1 x 32 and 5 x 16, beside the library's batched-weight matmul + baddbmm; the
     backward kernel (its wrapper: the kernel and the per-set sum of dW,
     db) at B=32 at N=90 and N=270 and at the six grouped shapes,
     beside its plain version and the autograd recompute it replaced, in
     turns on the same inputs, warm and cold, with its bound;
  6. one torch.profiler pass over a warm serving forward of 256 subjects
     and one over a warm train step (each session records the second of
     two calls, after a warm-up cycle in which the tracer starts): the
     kernel's share of device time, the device's idle share, the top 10
     device ops; and one over `SINGLE_CALLS` back-to-back
     `fused_gcn_stack` calls, each of which must launch exactly one
     device kernel, its own (a session with fewer records than calls is
     profiled again after a second's pause, up to five sessions);
     the train step must launch the forward kernel twice and the backward
     kernel twice (profiled and counted), one eval batch the forward
     twice and the backward never (counted);
  7. the training slice at full width: `iggcn_tpu_torch.main.main` on the
     card, default ModelConfig (L=2, H=16), the real-scale GO topology, an
     874-subject synthetic cohort, batch 32, 5 folds with val, 3 epochs,
     --lambda_disease 1.0; every printed loss finite, the `Result -` line
     printed, the experiment's wall time, and the kernels' launches over
     the run equal to what the loop implies (forward 2 per train step
     and 2 per eval batch: sum over folds of epochs x 2 x (train + val +
     test batches); backward 2 per train step); then six train steps of fold 0 from the same weights at
     dropout 0 on the card, on the CPU and on the CPU in float64:
     per-step losses card vs CPU within rtol 2e-4, the first step's
     gradients and the final params and batch_stats held to float64 as
     `card_vs_cpu_steps` states (the 1e-4 pin, widened only where the
     CPU's own fp32 departs from exact arithmetic);
  8. multi-fusion training at full width: the CLI route `--isMultiFusion`
     (N=270, F0=1: the kernel's 2-CTA cluster path in every step) at the
     widest configuration of its grid (L=3, H=10), phase 7's cohort size,
     batch and folds, 2 epochs; the kernels' launches counted in one train
     step (2 forward, 2 backward) and one eval batch (2 forward) and over
     the run (the loop's count);
     a warm step's host wall, device busy, idle share and kernel share;
     six card steps against the CPU under phase 7's rules; the run exports
     its serving bundles (`--export_bundle`) for phase 10;
  9. every other fused family of the CLI (GCN_IMGSNP, SGCN_GCN, SGCN_GAT,
     SGCN_Ori, GUIDE_IMGSNP, SGCN_GCN_CLUSTERLABEL): one 5-fold, 1-epoch
     experiment each at the default widths; the kernel's launches per
     train step and per eval batch must be the family's (`STACK_CALLS`: 1
     for GCN_IMGSNP, 2 for CLUSTERLABEL, 0 for the rest, which do not run
     the stack; as many backward launches per train step, none per eval
     batch) and over the run the loop's count; two card steps against
     the CPU under phase 7's rules (dropout 0, GUIDE's Gumbel noise 0);
     GUIDE_IMGSNP and SGCN_GCN_CLUSTERLABEL export their bundles;
 10. what an experiment keeps, at phase 7's setting: the flagship CLI run
     with `--export_bundle` (2 epochs) writes every fold's checkpoint,
     record and bundle, launching the kernel the loop's count; the fold
     records of folds 3-4 are deleted and the run repeated with
     `--resume`: folds 0-2 restored, 3-4 retrained with the loop's
     launches for those folds alone, their per-epoch test losses and the
     whole score matrix bit-equal to the first run's;
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
     phase 7's rules for GCN, GIN, DiffPool and TopK;
 15. the batched routes on phase 7's cohort: the flagship with
     `--fold_parallel` (2 epochs) beside the sequential 2-epoch run
     (walls; printed per-epoch losses within 1e-3; launches the batched
     loop's count, 2 per batched train step and eval batch: 58 per epoch
     against 290); six fold-parallel steps of the 5 folds at dropout 0
     against the same steps taken fold by fold on the card and in
     float64 on the CPU, under phase 7's rules, then a warm batched
     step's host wall, device busy and idle share; `--fold_parallel
     --isMultiFusion` (1 epoch); `--cv_seeds 1:3 --fold_parallel` (one
     program of 15 entries, the `Replication` line, every seed's fold
     records against its standalone fold-parallel run); `--permut_seeds
     1:3 --fold_parallel` and `tools.report --permut_null` over it (the
     p-value printed); a `--batch_file` of a fused, a zoo and a failing
     line (exit 1, the first two done).
 16. bf16 serving, the tools and the diffusion backends: the GCN stack's
     bf16-operand form against its plain version (the fp32 stack on the
     upcasts) at every grid shape x B `BF16_BATCHES` in both P layouts
     (N=90 and N=270 on the persistent kernel: 106 and 133 leave CTAs a
     sample short, 874 refills each CTA's stage 2-3 times at N=90 and 5-6
     at N=270), at `BF16_REFILL_CASES` (the other K split refilling its
     stage), on an odd grid whose refills change the stage's lead after a
     sample ending in inf (`bf16_slack_check`), at
     `BF16_BRANCH_SHAPES` (every K split and cluster its plan can choose)
     and on a P whose samples start 2 bytes off at both N (value by value),
     at rtol 1e-4 / atol 1e-5, one launch per call; its warm and cold
     times at the serving shapes (N=90 and N=270, B=256) beside its bound,
     the plain version, the library composition and the fp32 form on the
     upcast inputs (bf16 and fp32 forms in turns); phase 3's bundle served in bf16
     to the 874-subject cohort (the bf16 form's launches counted from 0:
     one per forward) against the CPU's bf16 plain path (atol
     `BF16_SERVE_ATOL`) and the card's fp32 (the JAX package's bf16 rule),
     the cohort walls of fp32 and bf16 in turns; every phase-10 bundle
     likewise (1, 1, 1 and 0 bf16 launches per forward); a `--bf16`
     daemon's /health and /predict; `tools.profile_step` on the card and a
     short `--profile_dir` run, its trace's files listed; the doctor on
     phase 12's layout (exit 0) and with one file removed (exit 1); the
     `auto` (within 1e-12, the same sparsity) and `device` (within 2e-5
     and the same sparsity on every column whose k-th and (k+1)-th PPR
     values are more than `DIFFUSION_TIE` apart, relative: closer ones
     fp32 cannot order) diffusion backends against `numpy` on an 874 x 90
     cohort, with the three walls. It says in one line that `--plot` and
     `data/cluster.py` are not run on the card (no matplotlib or
     scikit-learn there).
 17. the streamed form (`csrc/gcn_stack_streamed.cu`), which takes every
     shape the resident kernels cannot hold; no earlier phase may have
     run it. Against its plain versions, each call twice and bit-equal,
     with the counters showing the streamed form where the plan streams
     and the resident kernels where it does not: the fp32 forward in
     both P layouts (rtol 1e-4 / atol 1e-5) and the backward, all four
     gradients (rtol/atol 1e-4), at `STREAMED_SHAPES` (N=90 at 2 and 3
     layers of 128 and at 9 of 16, N=270 at 3 of 32 and 1 of 64, N=620
     at 3 of 32, 3 of 16 and 2 of 10); the grouped form at 5 x 32 x (90,
     3, 3 x 128); the bf16 form at `STREAMED_BF16`. Warm and cold times of
     the forward and the backward at the flagship's (32, 90, 3, 3 x 128)
     and the zoo's (32, 620, 3, 3 x 32, 3 x 16 and 2 x 10) and
     multi-fusion's (32, 270, 1, 3 x 32: the forward resident, the
     backward streamed) beside the plain versions, the library yardsticks
     and the bounds. Then three
     CLI routes, 1 epoch each, with the loop's launches split over the
     forms and six card steps against the CPU under phase 7's rules: the
     flagship `--layers 3 --hiddens 128`, `--isMultiFusion --layers 3
     --hiddens 32`, and the zoo's `--model GCN` over a PROTEINS-shaped TU
     layout the script writes (`write_tu_layout`: 400 graphs, the largest
     of 620 nodes).
 18. long training runs, the card against the CPU, through the port half
     of `scripts/convergence_ab_torch.py`: the flagship at full width
     (default ModelConfig, N=90, the real-scale GO DAG) on a planted-signal
     cohort of `LONG_SUBJECTS`, full batch, dropout 0, from one set of
     seeded random weights, learning rate `LONG_LR`, `LONG_EPOCHS` epochs
     with StepLR every `LONG_DECAY` (three boundaries); then `--layers 3
     --hiddens 128` (both directions streamed) for `LONG_STREAMED_EPOCHS`;
     the multi-fusion shape (270 ROIs, F0=1, `--layers 3 --hiddens 10`:
     the resident kernels' 2-CTA clusters both ways) for
     `LONG_MULTI_EPOCHS`; and the grouped form, `LONG_SETS` weight sets
     from as many seeded inits in one fold-parallel program
     (`batched_train_step`, the per-set sums of `sum_weight_slots`), for
     `LONG_GROUPED_EPOCHS`. Each on the card twice, the two runs bit-equal
     (per-epoch losses, held-out log-probabilities, final weights), where
     every step must launch the forward and backward kernels
     (the counters over the training equal epochs x one step's: 2 + 2
     resident, or 4 streamed calls), and on the CPU from the same weights
     (each weight set its own run; the CPU runs train in worker processes,
     started before phase 16, while the card runs phases 16-18);
     held to the harness's bounds, the CPU as the reference: the first
     three epochs' losses within rtol 2e-4, the last within 0.05, both
     learn (the loss halves), the held-out predictions equal but for
     near-ties (class margin below 0.1 on either side, each printed);
     and to the same bounds with a float64 run on the CPU as the
     reference. It prints the loss checkpoints, the worst relative
     difference per StepLR window, how far each fp32 run departs from
     the float64 run and the phase's seconds.
 19. the card's results repeat run to run in PyTorch's default mode (no
     deterministic switch, no `CUBLAS_WORKSPACE_CONFIG`; cuDNN held to
     its deterministic convolution algorithms by `utils/platform.py`:
     asserted, and at the start of the script too): each route twice,
     the two results
     compared bit for bit, the first differing value printed on failure:
     every bundle class of phases 10-11 served to the 874-subject cohort
     at batch 256 in fp32 and bf16; phase 18's full-batch flagship; the
     2-epoch 5-fold flagship CLI, sequential and `--fold_parallel`, and
     `--fold_parallel --isMultiFusion --layers 3 --hiddens 10`, 1 epoch
     (phase 15's runs against a run of each now: every npy, fold record,
     checkpoint and bundle, the printed per-epoch losses and the `Result
     -` line); the SNP-only `Gene_ontology_network`, 1 epoch, twice; the
     zoo's `CNN_Model` and `SortPool` (cuDNN convolutions, held to
     cuDNN's deterministic algorithms by `utils/platform.py`), 1 epoch,
     twice each. One line per route with the values compared, then the
     phase's seconds.
 20. the device mesh (`iggcn_tpu_torch/parallel/mesh.py`), one process
     per position, at phase 15's width (`MESH_EPOCHS` epochs, dropout
     on); it prints `torch.cuda.device_count()`: (a) the CLI's
     `--fold_parallel` with one card spawns nothing and repeats phase
     19's run bit for bit; (b) gloo meshes with cuda:0 listed once per
     position, through `cv.fold_parallel_runs` in one world of
     `MESH_WORLD` ranks: fold=5 x data=1, fold=1 x data=4 (what a 4-GPU
     host takes for 5 folds) and 2 seeds x 5 folds on fold=2 x data=2
     (`fold_mesh(10)` on 4 devices), each against the one-device run
     (every entry's per-epoch train, val and test loss sums within rtol
     2e-4; mean test loss rtol 1e-3 and score matrix rtol 1e-3 / atol
     2e-3, `tests/test_parallel.py`'s),
     stating whether every entry is bit-equal to it, and each made twice,
     the two bit-equal; (c) `make_dp_train_step` on 4 ranks against the
     single step (loss rtol 1e-5, params atol 1e-4); (d) mesh serving of
     the cohort at batch 256 over 4 positions of cuda:0 against serving
     on the card alone (fp32 atol 1e-4, bf16 atol 2e-3); (e) each rank's
     forward and backward launches against the one-device run's (every
     position steps through every batch; an idle rank launches none),
     and the sample counts its plans were made for, its fold row's share
     of each batch (5 x 8 at fold=1 x data=4, 1 x 32 at fold=5 x data=1,
     5 x 16 at fold=2 x data=2; phase 2 holds each of these grouped
     shapes, and a serving position's 64 samples in fp32 and bf16,
     against the plain version);
     (f) with two cards or more, fold=1 x data=N under NCCL across them
     against the one-device run, else a line saying no second card was
     there. The world of (b), (c) and (e) starts before phase 18 and
     trains while phases 18 and 19 run; phase 20 joins it.

Every route's launches are counted for both kernels of the fp32 stack,
the forward and its backward: the loop's count is the forward's per
train step and eval batch, and the backward's per train step.

Phases 7-11 build their synthetic cohorts without the cohort cache
(`--cohort_cache_dir ''`), so no cache hit changes their readings.

It prints the `kernels` JSON line before the last line, and as the last
line `{"ok": true, "device": {...}}`. Everything it measures is also
written to results/chip_smoke/result.json (git-ignored).
"""
from __future__ import annotations

import concurrent.futures
import contextlib
import copy
import dataclasses
import glob
import hashlib
import http.client
import io
import json
import math
import multiprocessing
import os
import re
import shlex
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
from iggcn_tpu_torch.parallel import mesh as meshlib
from iggcn_tpu_torch.data.sampler import (imbalanced_sample_indices,
                                          pad_epoch_indices)
from iggcn_tpu_torch.predict import (batched_forward, batched_forward_snps,
                                     cast_floating)
from iggcn_tpu_torch.tools import explain, export_cohort, import_torch, report
from iggcn_tpu_torch.tools.convert import _flatten as flat_tree
from iggcn_tpu_torch.tools.convert import to_flax_variables
from iggcn_tpu_torch.tools.serve import (build_http_server, load_bundle,
                                         save_bundle)
from iggcn_tpu_torch.train import cv as port_cv
from iggcn_tpu_torch.train import fold_loop, generic_cv, snps_trainer, steps
from iggcn_tpu_torch.train.cv import init_fold_model, prepare_fold, to_device
from iggcn_tpu_torch.utils import cuda_build

REPO = os.path.dirname(os.path.abspath(__file__))
# phase 18 trains through the port half of the convergence harness
sys.path.insert(0, os.path.join(REPO, "scripts"))
import convergence_ab_torch  # noqa: E402
OUT_DIR = os.path.join(REPO, "results", "chip_smoke")
RTOL, ATOL = 1e-4, 1e-5          # kernel vs plain, fp32
BWD_TOL = 1e-4                   # gradients, rtol and atol (phase 2's)
SERVE_ATOL = 1e-4                # card vs CPU serving
COHORT, BATCH = 874, 256         # ADNI cohort size, serving batch
# imaging-stack shapes of both search grids (main.py:_combos), (N, F0,
# widths per layer): the default 90-ROI grid, then --isMultiFusion's
STACK_SHAPES = ([(90, 3, (h,) * n) for n, h in
                 zip([2, 3, 2, 3, 4], [16, 16, 10, 10, 5])]
                + [(270, 1, (h,) * n) for n, h in
                   zip([3, 2, 4, 2, 3], [2, 3, 3, 5, 10])])
# batches of the checks: 64 is a position's slice of a serving batch of
# 256 on phase 20's mesh of 4
STACK_BATCHES = (1, 7, 32, 64, 256)
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
# the same for the kernel's bf16 form: the persistent kernel with K split
# 2 at wide layers (the grids give 4),
# and the cluster design beyond one CTA with (cluster, K split) = (2, 2),
# (2, 1), (2, 4), (4, 1), (4, 2), (8, 1), (8, 2); an odd N comes value by
# value
BF16_BRANCH_SHAPES = [(90, 3, (64, 64)), (300, 1, (8, 8, 8)),
                      (400, 1, (10, 10)),
                      (380, 1, (4, 4)), (500, 1, (10, 10)), (600, 1, (4, 4)),
                      (700, 1, (10, 10)), (800, 1, (4, 4)), (91, 3, (16, 16))]
# batches of the bf16 form's checks: 106 the cohort's last serving batch,
# 133 one more than an H100's SMs, 874 the whole cohort in one launch, 64
# a position's slice of a serving batch on phase 20's mesh of 4
BF16_BATCHES = (1, 7, 64, 106, 133, 256, 874)
# (B, N, F0, widths) at which the persistent kernel's K split 2 (the
# grids' shapes take 4) refills each CTA's stage: one CTA an SM, 6-7
# samples each, so the barrier's parity flips 5-6 times
BF16_REFILL_CASES = [(874, 90, 3, (64, 64))]
FLUSH_BYTES = 256 * 2**20        # written between cold calls; L2 is 50 MB
# the backward kernel: its device kernels' names (the main kernel first,
# then the per-set sum of dW and db), the batches of its checks at every
# grid shape, and its timed shapes (name, F, B, N, F0, widths), F = 0 for
# shared weights: the training batch at both N, then the grouped form's
BACKWARD_KERNELS = ("gcn_stack_backward_kernel", "sum_weight_slots")
BWD_BATCHES = (1, 7, 32)
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
# resume after the records of RESUME_FOLDS are deleted; the retrained
# folds' per-epoch test losses and the whole score matrix equal the first
# run's bit for bit: the port's runs repeat on the card (no trained or
# served path accumulates with atomics, tests/test_torch_port_determinism.py;
# phase 19), as the JAX package's resume repeats its uninterrupted run
ARTIFACT_EPOCHS, RESUME_FOLDS = 2, (3, 4)
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
# the kernel's grouped form (fold-parallel training: F weight sets of B
# samples in one launch), (F, B, N, F0, widths) held against its plain
# version in phase 2: one fold and five folds at N=90, five at N=270 (the
# 2-CTA cluster path), the 3-seed x 5-fold seed batch, and the ranks of
# phase 20's meshes: fold=1 x data=4 (five folds, 8 samples each; what
# fold=1 x data=4 gives 5 folds on 4 cards) and fold=2 x data=2 (five
# entries, 16 samples each; also fold=1 x data=2 on 2 cards); fold=5 x
# data=1's 1 x 32 is the first
GROUPED_CHECKS = [(1, 32, 90, 3, (16, 16)), (5, 32, 90, 3, (16, 16)),
                  (5, 32, 270, 1, (10, 10, 10)), (15, 32, 90, 3, (16, 16)),
                  (5, 8, 90, 3, (16, 16)), (5, 16, 90, 3, (16, 16))]
# and timed in phase 5, (name, F, B, N, F0, widths): the fold-parallel
# train batch, the seed batch's, the multi-fusion fold-parallel one, and
# the rank-local batches of phase 20's meshes
GROUPED_TIMED = [("fold-parallel training", 5, 32, 90, 3, (16, 16)),
                 ("seed batch training", 15, 32, 90, 3, (16, 16)),
                 ("multi-fusion fold-parallel training", 5, 32, 270, 1,
                  (10, 10, 10)),
                 ("a rank of fold=1 x data=4", 5, 8, 90, 3, (16, 16)),
                 ("a rank of fold=5 x data=1", 1, 32, 90, 3, (16, 16)),
                 ("a rank of fold=2 x data=2", 5, 16, 90, 3, (16, 16))]
BWD_TIMED = [("training", 0, 32, 90, 3, (16, 16)),
             ("multi-fusion training", 0, 32, 270, 1, (10, 10, 10)),
             *GROUPED_TIMED]
# phase 15: the batched routes; the flagship at FP_EPOCHS beside a
# sequential run of as many epochs, the others at 1 epoch; FP_STEPS
# fold-parallel steps against sequential ones; the seeds of the batches
FP_EPOCHS, FP_STEPS, FP_SEEDS = 2, 6, "1:3"
FP_MULTI_ARGV = cli_argv(1, "_chip_smoke_fp_multi", "--fold_parallel",
                         "--isMultiFusion", "--layers", "3", "--hiddens", "10")


def snps_argv(appendix, epochs=SNP_EPOCHS):
    """The SNP-only CLI route on the card (`--model` comes first): phase
    7's cohort and topology, batch and folds, binary, with bundles."""
    return ["--device", "cuda", "--synthetic", "--synthetic_subjects",
            str(COHORT), "--synthetic_go_levels", GO_LEVELS, "--epochs",
            str(epochs), "--fold", str(TRAIN_FOLDS), "--batch_size",
            str(TRAIN_BATCH), "--disease_id", "0", "--save_appendix",
            appendix, "--export_bundle", "--cohort_cache_dir", ""]
EPOCH_LINE = re.compile(r"^Fold: (\d+), epoch:(\d+), train_loss: ([^,]+), "
                        r"val_loss: ([^,]+), test_loss: ([^,]+), acc:", re.M)

# published peaks, dense (NVIDIA data sheets): HBM bytes/s, fp32 FLOP/s
# outside the tensor cores; matched on torch.cuda.get_device_name
CARD_SPECS = [("H100 PCIe", 2.0e12, 51e12), ("H100 NVL", 3.9e12, 60e12),
              ("H200", 4.8e12, 67e12), ("H100", 3.35e12, 67e12)]


START = time.perf_counter()


def log(msg: str) -> None:
    """Print a line; a phase's header also gets the script's seconds."""
    if msg.startswith("== phase"):
        msg += f" (at {time.perf_counter() - START:.1f} s)"
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


def grouped_inputs(rng, f, b, n, f0, widths, dev):
    """`stack_inputs` of F*B samples (P in the transposed layout) with F
    weight sets: weights (F, F_l, H_l), biases (F, H_l)."""
    prop, x, _, _ = stack_inputs(rng, f * b, n, f0, widths, dev)
    dims = [f0] + list(widths)
    ws = [torch.from_numpy(rng.normal(0, (2.0 / (dims[i] + dims[i + 1])) ** 0.5,
                                      (f, dims[i], dims[i + 1])).astype(
        np.float32)).to(dev) for i in range(len(widths))]
    bs = [torch.from_numpy(rng.normal(0, 0.1, (f, h)).astype(np.float32)).to(dev)
          for h in widths]
    return prop, x, ws, bs


def grouped_work(f, b, n, f0, widths):
    """(bytes, flops) of the grouped form: `stack_work` of F*B samples with
    F weight sets read once each."""
    nbytes, flops = stack_work(f * b, n, f0, widths)
    dims = [f0] + list(widths)
    params = sum(dims[i] * dims[i + 1] + dims[i + 1] for i in range(len(widths)))
    return nbytes + 4 * (f - 1) * params, flops


def library_stack_grouped(prop, x, weights, biases):
    """The grouped stack as PyTorch library calls (torch.matmul with the
    weights batched per set, baddbmm, relu). A yardstick only; the port
    never calls it."""
    f = weights[0].shape[0]
    s, n, _ = prop.shape
    h, feats = x.reshape(f, s // f, n, -1), []
    for w, b in zip(weights, biases):
        hw = torch.matmul(h, w[:, None]).reshape(s, n, -1)
        bias = b[:, None, None, :].expand(f, s // f, 1, -1).reshape(s, 1, -1)
        h = torch.relu(torch.baddbmm(bias, prop, hw)).reshape(f, s // f, n, -1)
        feats.append(h)
    return torch.cat(feats, dim=-1).reshape(s, n, -1)


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


def assert_bit_equal(got, want, what):
    """The number of values in `got`, which must equal `want` bit for bit
    (shape, dtype and every value's bits); else an AssertionError that
    names the first value that differs."""
    got, want = np.ascontiguousarray(got), np.ascontiguousarray(want)
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"{what}: {got.dtype}{got.shape} against "
                             f"{want.dtype}{want.shape}")
    if got.size == 0:
        return 0
    a = got.reshape(-1).view(np.uint8).reshape(got.size, -1)
    b = want.reshape(-1).view(np.uint8).reshape(want.size, -1)
    differ = np.flatnonzero((a != b).any(axis=1))
    if differ.size:
        i = np.unravel_index(differ[0], got.shape)
        raise AssertionError(f"{what}: {differ.size} of {got.size} values "
                             f"differ; the first at {tuple(map(int, i))}: "
                             f"{got[i]!r} against {want[i]!r}")
    return int(got.size)


def assert_default_mode():
    """Nothing switches PyTorch to its deterministic variants (the runs
    must repeat by the port's own formulation) but cuDNN's choice of
    convolution algorithm, which `utils/platform.py` pins to its
    deterministic ones, unbenchmarked, for the zoo's convolutions."""
    switched = {"torch.are_deterministic_algorithms_enabled()":
                torch.are_deterministic_algorithms_enabled(),
                "CUBLAS_WORKSPACE_CONFIG":
                os.environ.get("CUBLAS_WORKSPACE_CONFIG")}
    pinned = {"torch.backends.cudnn.deterministic":
              torch.backends.cudnn.deterministic,
              "torch.backends.cudnn.benchmark":
              torch.backends.cudnn.benchmark}
    if (any(v not in (False, None) for v in switched.values())
            or pinned != {"torch.backends.cudnn.deterministic": True,
                          "torch.backends.cudnn.benchmark": False}):
        raise AssertionError(f"not PyTorch's default mode with the port's "
                             f"cuDNN pins: {switched}, {pinned}")
    return {**switched, **pinned}


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
        spills = re.findall(r"(\d+) bytes spill stores, (\d+) bytes spill "
                            r"loads", text)
        if source in sources and (
                not spills or any(int(a) or int(b) for a, b in spills)):
            raise AssertionError(f"ptxas reports spills in {source} (or no "
                                 f"report): {spills}")
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

    grouped_err = phase_grouped_vs_plain(dev)

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
    return max_err, train_grad_err, grouped_err


def phase_grouped_vs_plain(dev):
    """The grouped form at `GROUPED_CHECKS`: against
    `gcn_stack_reference_grouped` with P in both layouts (one launch per
    call), every weight set's samples bit-equal to a shared-weight launch
    of that set alone, and through `torch.func.vmap` over the fold axis as
    the fold-parallel model calls it (P from `gcn_propagation_matrix`
    inside, one launch for all folds), gradients included. Returns the
    largest difference from the plain version."""
    rng = np.random.default_rng(6)
    max_err = 0.0

    def held(what, out, ref, launches):
        nonlocal max_err
        torch.cuda.synchronize()
        if launches != 1:
            raise AssertionError(f"{what}: {launches} launches, not 1")
        torch.testing.assert_close(out, ref, rtol=RTOL, atol=ATOL)
        err = float((out - ref).abs().max())
        max_err = max(max_err, err)
        log(f"{what}: one launch, max_abs_err {err:.3e}")

    for f, b, n, f0, widths in GROUPED_CHECKS:
        prop, x, ws, bs = grouped_inputs(rng, f, b, n, f0, widths, dev)
        plan = gcn_stack.plan_launch(f * b, n, (f0, *widths))
        with torch.inference_mode():
            for layout, p in (("transposed", prop),
                              ("row-major", prop.contiguous())):
                out = counted_out(lambda: gcn_stack.fused_gcn_stack(
                    p, x, ws, bs))
                held(f"grouped F={f} x B={b} N={n} F0={f0} H={widths} P "
                     f"{layout} (cluster {plan.cluster})", out[0],
                     gcn_stack.gcn_stack_reference_grouped(p, x, ws, bs),
                     out[1])
            grouped = gcn_stack.fused_gcn_stack(prop, x, ws, bs)
            for k in range(f):
                rows = slice(k * b, (k + 1) * b)
                alone = gcn_stack.fused_gcn_stack(
                    prop[rows], x[rows], [w[k] for w in ws], [v[k] for v in bs])
                if not torch.equal(grouped[rows], alone):
                    raise AssertionError(f"grouped F={f} N={n}: set {k}'s "
                                         "samples differ from its own launch")
        log(f"grouped F={f} N={n}: every set's samples bit-equal to a "
            "shared-weight launch of that set")
        adj = torch.from_numpy(np.abs(rng.normal(size=(f, b, n, n))).astype(
            np.float32)).to(dev)
        xf = x.reshape(f, b, n, f0)
        layers = len(widths)

        def per_fold(a, xx, *params):
            return gcn_stack.fused_gcn_stack(gcn_propagation_matrix(a), xx,
                                             params[:layers], params[layers:])

        leaves = [t.clone().requires_grad_(True) for t in (adj, xf, *ws, *bs)]
        out, launches = counted_out(lambda: torch.func.vmap(per_fold)(*leaves))
        ref_leaves = [t.clone().requires_grad_(True) for t in (adj, xf, *ws, *bs)]
        ref = gcn_stack.gcn_stack_reference_grouped(
            gcn_propagation_matrix(ref_leaves[0]).reshape(f * b, n, n),
            ref_leaves[1].reshape(f * b, n, f0), ref_leaves[2:2 + layers],
            ref_leaves[2 + layers:]).reshape(f, b, n, -1)
        held(f"vmap over F={f} folds of B={b}, N={n}", out.detach(),
             ref.detach(), launches)
        cot = torch.randn_like(out)
        got = torch.autograd.grad(out, leaves, cot)
        want = torch.autograd.grad(ref, ref_leaves, cot)
        for name, g, r in zip(("adj", "x", *(f"W{i}" for i in range(layers)),
                               *(f"b{i}" for i in range(layers))), got, want):
            torch.testing.assert_close(g, r, rtol=1e-4, atol=1e-4)
        log(f"vmap over F={f}: gradients of adj, x, W, b agree (rtol/atol "
            "1e-4)")
    return max_err


def reset_launches():
    """Both fp32 counts to 0: the stack's forward kernel's and its
    backward kernel's."""
    gcn_stack.fused_gcn_stack.launches = 0
    gcn_stack.fused_gcn_stack.launches_backward = 0


def launch_counts():
    """The fp32 stack's launches since `reset_launches`: {"forward": n,
    "backward": n}."""
    return {"forward": gcn_stack.fused_gcn_stack.launches,
            "backward": gcn_stack.fused_gcn_stack.launches_backward}


def backward_grads(fn, prop, x, ws, bs, cot, needs=(True, True, True)):
    """The gradients of sum(fn(prop, x, ws, bs) * cot) through autograd,
    from leaves that require grad as `needs` (prop, x, weights and biases)
    says: [dprop, dx, dW..., db...], None where not needed. With
    `fn=gcn_stack.fused_gcn_stack` on the card that is one backward
    kernel launch."""
    layers = len(ws)
    leaves = [t.detach().requires_grad_(need) for t, need in zip(
        (prop, x, *ws, *bs), (needs[0], needs[1], *[needs[2]] * 2 * layers))]
    out = fn(leaves[0], leaves[1], leaves[2:2 + layers], leaves[2 + layers:])
    grads = iter(torch.autograd.grad(out, [t for t in leaves
                                           if t.requires_grad], cot))
    return [next(grads) if t.requires_grad else None for t in leaves]


def plain_backward(prop, x, ws, bs, cot, needs=(True, True, True)):
    """`gcn_stack_backward_reference` as `backward_grads` lists them."""
    dprop, dx, dws, dbs = gcn_stack.gcn_stack_backward_reference(
        prop, x, ws, bs, cot, needs)
    return [dprop, dx, *(dws or [None] * len(ws)), *(dbs or [None] * len(ws))]


def reference_for(ws):
    """The forward's plain version of the form `ws` has."""
    return (gcn_stack.gcn_stack_reference_grouped if ws[0].dim() == 3
            else gcn_stack.gcn_stack_reference)


def phase_backward_vs_plain(dev):
    """The backward kernel on the card (through `fused_gcn_stack`'s
    autograd, one launch per call) against `gcn_stack_backward_reference`
    and against autograd of the forward's plain version, rtol / atol
    BWD_TOL: at every grid shape x `BWD_BATCHES` and the branch shapes at
    B=7, P in both layouts; P and x without grad; isolated nodes 0-4 with
    zero biases, so z ties at 0 there; transposed P by 4-byte copies (odd
    N, a 4-byte-offset view); the grouped form at `GROUPED_CHECKS` in both
    layouts and through `torch.func.vmap` with one weight broadcast to
    every fold. Every call is made twice and must be bit-equal. Returns
    the largest difference from the plain version and the calls."""
    rng = np.random.default_rng(8)
    max_err, calls = 0.0, 0

    def held(what, got, plain, auto, again):
        nonlocal max_err, calls
        err = 0.0
        for k, (g, p, a, r) in enumerate(zip(got, plain, auto, again)):
            if g is None:
                if p is not None or r is not None:
                    raise AssertionError(f"{what}: gradient {k} missing")
                continue
            torch.testing.assert_close(g, p, rtol=BWD_TOL, atol=BWD_TOL)
            torch.testing.assert_close(g, a, rtol=BWD_TOL, atol=BWD_TOL)
            if not torch.equal(g, r):
                raise AssertionError(f"{what}: gradient {k} differs between "
                                     "two runs of the same call")
            err = max(err, float((g - p).abs().max()))
        max_err, calls = max(max_err, err), calls + 1
        log(f"backward {what}: max_abs_err {err:.3e}, bit-equal twice")

    def check(what, prop, x, ws, bs, needs=(True, True, True)):
        total = sum(w.shape[-1] for w in ws)
        cot = torch.from_numpy(rng.normal(size=(*prop.shape[:2], total))
                               .astype(np.float32)).to(dev)
        reset_launches()
        got = backward_grads(gcn_stack.fused_gcn_stack, prop, x, ws, bs, cot,
                             needs)
        torch.cuda.synchronize()
        if launch_counts() != {"forward": 1, "backward": 1}:
            raise AssertionError(f"backward {what}: launches "
                                 f"{launch_counts()}, not one of each")
        again = backward_grads(gcn_stack.fused_gcn_stack, prop, x, ws, bs, cot,
                               needs)
        held(what, got, plain_backward(prop, x, ws, bs, cot, needs),
             backward_grads(reference_for(ws), prop, x, ws, bs, cot, needs),
             again)

    runs = [(b, *shape) for b in BWD_BATCHES for shape in STACK_SHAPES]
    for b, n, f0, widths in runs + [(7, *shape) for shape in BRANCH_SHAPES]:
        prop, x, ws, bs = stack_inputs(rng, b, n, f0, widths, dev)
        plan = gcn_stack.plan_backward(b, n, (f0, *widths))
        for layout, p in (("transposed", prop), ("row-major", prop.contiguous())):
            check(f"B={b} N={n} F0={f0} H={widths} P {layout} (cluster "
                  f"{plan.cluster}, {plan.smem_bytes} B)", p, x, ws, bs)
    for n, f0, widths in ((90, 3, (16, 16)), (270, 1, (10, 10, 10))):
        prop, x, ws, bs = stack_inputs(rng, TRAIN_BATCH, n, f0, widths, dev)
        for needs in ((False, True, True), (False, False, True),
                      (True, False, True), (True, True, False)):
            check(f"B={TRAIN_BATCH} N={n} needs (P, x, W/b) {needs}", prop, x,
                  ws, bs, needs)
    for n, f0 in ((90, 3), (270, 1)):   # isolated nodes: z = 0 exactly
        adj = np.abs(rng.normal(size=(7, n, n))).astype(np.float32)
        adj[:, :5, :] = 0.0
        adj[:, :, :5] = 0.0
        prop = gcn_propagation_matrix(torch.from_numpy(adj).to(dev),
                                      add_self_loops=False)
        _, x, ws, bs = stack_inputs(rng, 7, n, f0, (10, 10), dev)
        check(f"B=7 N={n} isolated nodes 0-4, zero biases", prop, x, ws,
              [torch.zeros_like(v) for v in bs])
    for n, f0, widths in ((91, 3, (16, 16)), (271, 1, (10, 10, 10)),
                          (90, 3, (16, 16))):
        prop, x, ws, bs = stack_inputs(rng, 7, n, f0, widths, dev)
        what = f"B=7 N={n} P transposed"
        if n % 2 == 0:
            buf = torch.empty(prop.numel() + 1, device=dev)
            rows = buf[1:].view(prop.shape)
            rows.copy_(prop.transpose(1, 2))
            prop, what = rows.transpose(1, 2), what + ", 4-byte offset"
        plan = gcn_stack.plan_backward(7, n, (f0, *widths))
        if gcn_stack._bulk_copyable(prop, plan):
            raise AssertionError(f"{what}: expected the 4-byte copy path")
        check(f"{what}, 4-byte copies (cluster {plan.cluster})", prop, x, ws,
              bs)
    for f, b, n, f0, widths in GROUPED_CHECKS:
        prop, x, ws, bs = grouped_inputs(rng, f, b, n, f0, widths, dev)
        for layout, p in (("transposed", prop), ("row-major", prop.contiguous())):
            check(f"grouped F={f} x B={b} N={n} H={widths} P {layout}", p, x,
                  ws, bs)
        # as the fold-parallel model calls it: P built per fold inside the
        # vmap, the first weight one set broadcast to every fold
        layers = len(widths)
        adj = torch.from_numpy(np.abs(rng.normal(size=(f, b, n, n))).astype(
            np.float32)).to(dev)
        params = [ws[0][0], *ws[1:], *bs]
        in_dims = (0, 0, None, *[0] * (len(params) - 1))

        def per_fold(a, xx, *ps):
            return gcn_stack.fused_gcn_stack(gcn_propagation_matrix(a), xx,
                                             ps[:layers], ps[layers:])

        def ref_fold(a, xx, *ps):
            sets = [ps[0].expand(f, *ps[0].shape), *ps[1:layers]]
            return gcn_stack.gcn_stack_reference_grouped(
                gcn_propagation_matrix(a).reshape(f * b, n, n),
                xx.reshape(f * b, n, f0), sets, ps[layers:]
            ).reshape(f, b, n, -1)

        cot = torch.randn(f, b, n, sum(widths), device=dev)
        grads = []
        for fn in (torch.func.vmap(per_fold, in_dims=in_dims),
                   torch.func.vmap(per_fold, in_dims=in_dims), ref_fold):
            leaves = [t.clone().requires_grad_(True)
                      for t in (adj, x.reshape(f, b, n, f0), *params)]
            reset_launches()
            grads.append(torch.autograd.grad(fn(*leaves), leaves, cot))
            torch.cuda.synchronize()
            want = ({"forward": 0, "backward": 0} if fn is ref_fold
                    else {"forward": 1, "backward": 1})
            if launch_counts() != want:
                raise AssertionError(f"vmap over F={f}: launches "
                                     f"{launch_counts()}, not {want}")
        got, again, auto = grads
        held(f"vmap over F={f} folds of B={b}, N={n}, W0 broadcast", got,
             auto, auto, again)
    log(f"backward kernel: {calls} calls, max_abs_err {max_err:.3e} against "
        f"the plain version (rtol/atol {BWD_TOL})")
    return max_err, calls


def backward_work(f, b, n, f0, widths):
    """(bytes, flops) of the backward of F*B samples (F = 0: shared
    weights): P, x, the output gradient and each weight set read once;
    dP, dx and each set's dW, db written once; the recompute's and the
    backward's products and elementwise steps."""
    sets, s = max(f, 1), max(f, 1) * b
    dims = [f0] + list(widths)
    params = sum(dims[i] * dims[i + 1] + dims[i + 1] for i in range(len(widths)))
    nbytes = 4 * (2 * s * n * n + 2 * s * n * f0 + s * n * sum(widths)
                  + 2 * sets * params)
    per = 2 * n * n * sum(widths)                         # dP
    for fin, h in zip(dims[:-1], dims[1:]):
        per += 2 * n * fin * h + 2 * n * n * h + 2 * n * h  # a, P a + b, relu
        per += 2 * n * n * h + 2 * n * fin * h + 3 * n * h  # da, dW; mask, db
        per += 2 * n * h * fin + n * fin                    # e, + g
    return nbytes, s * per


def recompute_backward(prop, x, ws, bs, cot):
    """What the backward ran on the card before its kernel: autograd of the
    forward's plain version, recomputed from the inputs. A yardstick only;
    the port no longer runs it on the card."""
    leaves = [t.detach().requires_grad_(True) for t in (prop, x, *ws, *bs)]
    layers = len(ws)
    out = reference_for(ws)(leaves[0], leaves[1], leaves[2:2 + layers],
                            leaves[2 + layers:])
    return torch.autograd.grad(out, leaves, cot)


def phase_backward_times(dev, card_name):
    """Phase 5's backward rows at `BWD_TIMED`: the kernel's wrapper (one
    backward launch and the per-set sum), the plain version and the
    autograd recompute it replaces, in turns, each warm and cold, beside
    the bound."""
    log("== phase 5 (backward): the backward kernel's times")
    spec, bw, peak = card_spec(card_name)
    flush = torch.empty(FLUSH_BYTES // 4, dtype=torch.float32, device=dev)
    rng = np.random.default_rng(9)
    rows = []
    for name, f, b, n, f0, widths in BWD_TIMED:
        args = (grouped_inputs(rng, f, b, n, f0, widths, dev) if f
                else stack_inputs(rng, b, n, f0, widths, dev))
        cot = torch.randn(max(f, 1) * b, n, sum(widths), device=dev)
        needs = (True, True, True)
        fns = {"kernel": lambda: gcn_stack._launch_backward(*args, cot, needs),
               "plain": lambda: gcn_stack.gcn_stack_backward_reference(
                   *args, cot, needs),
               "library": lambda: recompute_backward(*args, cot)}
        nbytes, flops = backward_work(f, b, n, f0, widths)
        bytes_ms, flops_ms = nbytes / bw * 1e3, flops / peak * 1e3
        row = {"shape": name, "F": f, "B": b, "N": n, "F0": f0,
               "widths": list(widths), "bytes": nbytes, "flops": flops,
               "bound_ms": max(bytes_ms, flops_ms),
               "bound_by": "bytes" if bytes_ms >= flops_ms else "operations",
               "cluster": gcn_stack.plan_backward(
                   max(f, 1) * b, n, (f0, *widths)).cluster}
        for what, fn in fns.items():   # in turns on the same inputs
            # the plain version and the recompute enqueue ~100 ops a call:
            # a longer sleep keeps the host ahead of the card
            row[f"{what}_ms"] = device_ms(
                fn, sleep_cycles=20_000_000 if what == "kernel"
                else 100_000_000)
            row[f"{what}_cold_ms"] = cold_device_ms(fn, flush)
        rows.append(row)
        log(f"gcn_stack backward {name} F={f} B={b} N={n} F0={f0} "
            f"H={widths} (cluster {row['cluster']}): kernel "
            f"{row['kernel_ms']:.5f} ms warm / {row['kernel_cold_ms']:.5f} "
            f"cold, plain {row['plain_ms']:.5f} / {row['plain_cold_ms']:.5f}, "
            f"autograd recompute {row['library_ms']:.5f} / "
            f"{row['library_cold_ms']:.5f}, bound {row['bound_ms']:.5f} ms "
            f"({row['bound_by']}; {nbytes} B, {flops} FLOP, {spec} peaks)")
    del flush
    return rows


def counted_out(fn):
    """(fn's result, the forward kernel's launches in that call)."""
    reset_launches()
    out = fn()
    torch.cuda.synchronize()
    return out, gcn_stack.fused_gcn_stack.launches


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
        grouped = []
        for name, f, b, n, f0, widths in GROUPED_TIMED:
            args = grouped_inputs(rng, f, b, n, f0, widths, dev)
            fns = {"kernel": lambda: gcn_stack.fused_gcn_stack(*args),
                   "plain": lambda: gcn_stack.gcn_stack_reference_grouped(
                       *args),
                   "library": lambda: library_stack_grouped(*args)}
            nbytes, flops = grouped_work(f, b, n, f0, widths)
            bytes_ms, flops_ms = nbytes / bw * 1e3, flops / peak * 1e3
            row = {"shape": name, "F": f, "B": b, "N": n, "F0": f0,
                   "widths": list(widths), "bytes": nbytes, "flops": flops,
                   "bound_ms": max(bytes_ms, flops_ms),
                   "bound_by": "bytes" if bytes_ms >= flops_ms else "operations"}
            for what, fn in fns.items():
                row[f"{what}_ms"] = device_ms(fn)
                row[f"{what}_cold_ms"] = cold_device_ms(fn, flush)
            grouped.append(row)
            log(f"gcn_stack grouped {name} F={f} x B={b} N={n} F0={f0} "
                f"H={widths}: kernel {row['kernel_ms']:.5f} ms warm / "
                f"{row['kernel_cold_ms']:.5f} cold, plain "
                f"{row['plain_ms']:.5f} / {row['plain_cold_ms']:.5f}, library "
                f"{row['library_ms']:.5f} / {row['library_cold_ms']:.5f}, "
                f"bound {row['bound_ms']:.5f} ms ({row['bound_by']}; {nbytes} "
                f"B, {flops} FLOP, {spec} peaks)")
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
    return {"shapes": shapes, "grouped": grouped, "spec": spec,
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
    backward_us = sum(t for name, (t, _) in totals.items()
                      if any(k in name for k in BACKWARD_KERNELS))
    top = sorted(totals.items(), key=lambda kv: -kv[1][0])[:10]
    return {"wall_us": wall_us, "device_busy_us": busy,
            "device_op_us": device_us, "device_ops": len(events),
            "idle_share": 1.0 - busy / wall_us,
            "gcn_stack_us": kernel_us, "gcn_stack_share": kernel_us / device_us,
            "gcn_stack_launches": sum(c for name, (_, c) in totals.items()
                                      if "gcn_stack_kernel" in name),
            "gcn_stack_backward_us": backward_us,
            "gcn_stack_backward_share": backward_us / device_us,
            "gcn_stack_backward_launches": sum(
                c for name, (_, c) in totals.items()
                if BACKWARD_KERNELS[0] in name),
            "top10": [{"name": name, "us": t, "count": c}
                      for name, (t, c) in top]}


def log_profile(what, out):
    log(f"{what}: host wall {out['wall_us']:.1f} us, device busy "
        f"{out['device_busy_us']:.1f} us over {out['device_ops']} device ops "
        f"(idle share {out['idle_share']:.3f}); gcn_stack "
        f"{out['gcn_stack_us']:.1f} us in {out['gcn_stack_launches']} "
        f"launch(es) = {out['gcn_stack_share']:.4f} of device time; its "
        f"backward {out['gcn_stack_backward_us']:.1f} us in "
        f"{out['gcn_stack_backward_launches']} launch(es) = "
        f"{out['gcn_stack_backward_share']:.4f}")
    for row in out["top10"]:
        log(f"  {row['us']:10.1f} us  x{row['count']:<4d} {row['name'][:110]}")


# calls profiled together to show that one `fused_gcn_stack` call is one
# device kernel: a session that starts tracing right at a ~12 us kernel has
# come back with no device records at all, or with one of ten launches
# missing, on the card
SINGLE_CALLS = 10


def profiled(fn, attempts=5, complete=bool):
    """(device events, host wall in us) of one call of `fn`. Each session
    first runs `fn` in a warm-up cycle, in which the tracer starts and its
    records are dropped, then records a second call. A session whose
    events do not satisfy `complete` (by default: no device activity at
    all) is logged and `fn` is profiled again after a second's pause, up
    to `attempts` sessions (once, the tracer dropped 6 of 10 records and
    then recorded nothing in the next two sessions run back to back)."""
    from torch.profiler import ProfilerActivity, profile, schedule
    for attempt in range(1, attempts + 1):
        if attempt > 1:
            time.sleep(1.0)
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
    step_seen = {"forward": out["train_step"]["gcn_stack_launches"],
                 "backward": out["train_step"]["gcn_stack_backward_launches"]}
    per_step, per_eval = step_launches(STACK_CALLS["SGCN_GCN_IMGSNP"])
    if step_seen != per_step:
        raise AssertionError("a train step must launch the forward kernel "
                             "twice (plain and masked pass) and the backward "
                             f"kernel twice; the profiler saw {step_seen}")
    out["train_step_launches"] = counted_launches(train["step"])
    out["eval_batch_launches"] = counted_launches(lambda: steps.eval_step(
        train["state"].model, train["eval_batch"], train["mcfg"],
        train["tcfg"]))
    log(f"one train step launched the kernels {out['train_step_launches']}, "
        f"one eval batch (B={TRAIN_BATCH}, both passes) "
        f"{out['eval_batch_launches']}")
    if (out["train_step_launches"], out["eval_batch_launches"]) != (
            per_step, per_eval):
        raise AssertionError(f"a train step / an eval batch must launch the "
                             f"kernels {per_step} / {per_eval}; they launched "
                             f"{out['train_step_launches']} / "
                             f"{out['eval_batch_launches']}")
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
            "tcfg": tcfg, "topo": topo, "cohort": cohort, "splits": splits,
            "fold0": fold0,
            "state": state, "generator": generator, "train_dev": train_dev,
            "eval_batch": eval_batch,
            "step": lambda: steps.train_step(state, batch, mcfg, tcfg,
                                             generator)}


def counted_launches(fn):
    """The kernels' launches in one call of `fn` (the wrappers' counters):
    {"forward": n, "backward": n}."""
    counted_out(fn)
    return launch_counts()


def step_launches(per_batch):
    """What one train step and one eval batch launch, as
    `counted_launches` reads them, for a route that calls the stack
    `per_batch` times a pass: each call's forward, and in a train step its
    backward."""
    return ({"forward": per_batch, "backward": per_batch},
            {"forward": per_batch, "backward": 0})


def expected_launches(splits, tcfg, per_batch=2, test_size=None):
    """The kernels' launches over one CV run with a validation split, as
    the loop implies: forward, `per_batch` per train step and per eval
    batch (2 for the two-pass families, 1 for GCN_IMGSNP, 0 where no stack
    runs), every epoch, over the train, val and test batches; backward,
    `per_batch` per train step. With `test_size` every fold tests on an
    external cohort of that many subjects instead of its test split."""
    b = tcfg.batch_size

    def batches(split, kinds):
        train, test, val = (len(idx) for idx in split)
        if test_size is not None:
            test = test_size
        counts = {"train": train, "test": test, "val": val}
        return sum(math.ceil(counts[k] / b) for k in kinds)

    def total(kinds):
        return per_batch * sum(tcfg.epochs * batches(split, kinds)
                               for split in splits)

    return {"forward": total(("train", "test", "val")),
            "backward": total(("train",))}


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
    with torch.inference_mode():
        fwd_ms = device_ms(lambda: gcn_stack.fused_gcn_stack(prop, x, ws, bs))
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
           "fwd_kernel_b32_ms": fwd_ms,
           "epoch_s": epoch_s, "epoch_graphs": fold0["n_train"],
           "epoch_graphs_per_s": fold0["n_train"] / epoch_s}
    log(f"train step B={TRAIN_BATCH}: device busy {step_device_ms:.4f} ms, "
        f"span on the card {step_span_ms:.4f} ms, host wall "
        f"{step_wall_ms:.4f} ms; gcn_stack at B={TRAIN_BATCH}: forward kernel "
        f"{fwd_ms:.5f} ms (the backward's rows: phase 5 (backward)); one "
        f"epoch of fold 0: "
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
    """(stdout, the kernels' launches as `launch_counts` reads them, wall
    s, return value) of `iggcn_tpu_torch.main.main(argv)` on the card; the
    output is logged."""
    buf = io.StringIO()
    reset_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        results = port_main.main(argv)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    text = buf.getvalue()
    log(text.rstrip())
    return text, launch_counts(), wall_s, results


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
    log(f"experiment {shown}: {wall_s:.3f} s wall, kernel launches {launches} "
        f"(= {want} implied: forward {steps_run} train steps x {per_batch} + "
        f"eval batches x {per_batch}, backward {steps_run} x {per_batch}), "
        f"{throughput.group(0)}, {result.group(0)}")
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
    if (per_step, per_eval) != step_launches(want):
        raise AssertionError(f"a multi-fusion train step / eval batch "
                             f"launched the kernels {per_step} / {per_eval} "
                             f"times; expected {step_launches(want)}")
    breakdown = step_breakdown(train)
    one = breakdown["profiled_step"]
    log_profile(f"warm multi-fusion train step (B={TRAIN_BATCH}, N=270)", one)
    log(f"multi-fusion train step: host wall {breakdown['step_wall_ms']:.4f} "
        f"ms (median of 10), device busy {breakdown['step_device_ms']:.4f} ms "
        f"(profiler, 5 steps)")
    if (one["gcn_stack_launches"], one["gcn_stack_backward_launches"]) != (
            want, want):
        raise AssertionError("the profiled multi-fusion step ran the forward "
                             f"/ backward kernels {one['gcn_stack_launches']} "
                             f"/ {one['gcn_stack_backward_launches']} times, "
                             f"not {want} each")
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
        log(f"{model}: one train step launched the kernels {per_step}, one "
            f"eval batch {per_eval} (expected {step_launches(want)})")
        if (per_step, per_eval) != step_launches(want):
            raise AssertionError(f"{model}: {per_step} / {per_eval} launches "
                                 f"per train step / eval batch; expected "
                                 f"{step_launches(want)}")
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
        raise AssertionError(f"the resumed run launched the kernels "
                             f"{launches}; the loop implies {want} for folds "
                             f"{list(RESUME_FOLDS)}")
    scores = np.load(os.path.join(res_dir, f"{name}.npy"))
    if not np.array_equal(scores[kept], scores_first[kept]):
        raise AssertionError("restored folds' score rows differ from the "
                             "first run's")
    compared = 0
    for k in RESUME_FOLDS:
        with np.load(fold_file("fold_result", k, "npz")) as zf:
            compared += assert_bit_equal(
                zf["test_losses"], losses_first[k],
                f"retrained fold {k}'s per-epoch test losses vs the first "
                "run's")
    compared += assert_bit_equal(scores, scores_first, "the resumed run's "
                                 "score matrix vs the first run's")
    log(f"resume: folds {kept} restored, {list(RESUME_FOLDS)} retrained in "
        f"{wall_s:.3f} s with {launches} kernel launches (= {want} implied); "
        f"the retrained folds' per-epoch test losses and the whole score "
        f"matrix bit-equal to the first run's ({compared} values)")

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
        "values_bit_equal": compared},
        "serving": served, "explain": explained}


def snps_inputs(argv):
    """(snps, labels, topo) that the SNP-only CLI route `argv` trains on."""
    args = port_main.build_parser().parse_args(argv)
    with contextlib.redirect_stdout(io.StringIO()):
        return port_main.snps_inputs(args, None, port_main.build_dcfg(args),
                                     np.random.default_rng(args.seed))


def phase_snps(dev):
    log("== phase 11: the SNP-only families on the card")
    appendix = "_chip_smoke_snps"
    res_dir = run_dir(appendix)
    shutil.rmtree(res_dir, ignore_errors=True)
    argv = snps_argv(appendix)
    args = port_main.build_parser().parse_args(argv)
    snps, labels, topo = snps_inputs(argv)
    out, total_launches = {}, 0
    for model in SNP_MODELS:
        kind = "mlp" if model == "MLP_Model" else "go"
        text, launches, wall_s, res = cli_run(["--model", model, *argv])
        total_launches += sum(launches.values())
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


def run_zoo(dev, argv, layers=2, hidden=16):
    """One zoo CLI experiment on the card (`layers` x `hidden` as argv
    says): every per-epoch accuracy finite, the `Using` and `Result -`
    lines printed; returns its readings."""
    args, ds = zoo_data(argv)
    text, launches, wall_s, results = cli_run(argv)
    accs = re.findall(r"^fold \d+ epoch \d+: acc (\S+)$", text, re.M)
    if (len(accs) != TRAIN_FOLDS * ZOO_EPOCHS
            or not all(np.isfinite(float(a)) for a in accs)):
        raise AssertionError(f"{args.model}: per-epoch lines {accs}")
    result = re.search(r"^Result - .*$", text, re.M)
    if (result is None
            or f"Using {layers} layers, {hidden} hidden units" not in text):
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
    """The kernels' launches in one generic train step and one eval batch
    of the GCN route's first batch on the card (`step_launches(1)`)."""
    card = route["state"](copy.deepcopy(route["model"]).to(dev))
    batch = to_device({k: v[:TRAIN_BATCH] for k, v in route["data"].items()},
                      dev)
    _, evaluate = generic_cv.build_generic_steps(
        card.model, card.optimizer, needs_mask=False, needs_assign=False,
        adj_only=False, aux_loss=False, takes_weight=False)
    per_step = counted_launches(lambda: card.train_step(batch, None, 1e-3))
    per_eval = counted_launches(lambda: evaluate(batch))
    if (per_step, per_eval) != step_launches(1):
        raise AssertionError(f"GCN: {per_step} / {per_eval} launches per "
                             f"train step / eval batch; expected "
                             f"{step_launches(1)}")
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
                raise AssertionError(f"{model}: the run launched the kernels "
                                     f"{run['launches']}; the loop "
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


def fp_expected_launches(split_lists, batch, epochs, per_batch=2,
                         no_val=False):
    """The kernels' launches over one fold-parallel run of the fold entries
    of `split_lists` (one list of splits per seed; all entries in one
    batched program): forward, `per_batch` per batched train step and per
    batched eval batch, every epoch, each split kind padded to its largest
    entry's batches; backward, `per_batch` per batched train step."""
    entries = [split for splits in split_lists for split in splits]
    train = max(math.ceil(len(tr) / batch) for tr, _, _ in entries)
    test = max(math.ceil(len(te) / batch) for _, te, _ in entries)
    val = 0 if no_val else max(math.ceil(len(va) / batch)
                               for _, _, va in entries)
    return {"forward": per_batch * epochs * (train + val + test),
            "backward": per_batch * epochs * train}


def epoch_losses(text):
    """{(fold, epoch): (train, val, test) loss} of a run's epoch lines."""
    return {(int(m[0]), int(m[1])): tuple(float(v) for v in m[2:])
            for m in EPOCH_LINE.findall(text)}


def fp_run(argv, split_lists, tcfg, what, epochs=1, per_batch=2):
    """A fold-parallel CLI run on the card: the epoch lines of every fold
    (of every seed) finite, a `Result -` line per seed, and the kernel's
    launches equal to `fp_expected_launches`."""
    text, launches, wall_s, results = cli_run(argv)
    want = fp_expected_launches(split_lists, tcfg.batch_size, epochs,
                                per_batch)
    lines = EPOCH_LINE.findall(text)
    if len(lines) != len(split_lists) * tcfg.folds * epochs or not all(
            np.isfinite(float(v)) for e in lines for v in e[2:]):
        raise AssertionError(f"{what}: epoch lines {lines}")
    if len(re.findall(r"^Result - .*$", text, re.M)) != len(split_lists):
        raise AssertionError(f"{what}: expected one `Result -` line per seed")
    if launches != want:
        raise AssertionError(f"{what}: the run launched the kernels {launches}"
                             f"; the batched loop implies {want}")
    log(f"{what}: {wall_s:.3f} s wall, kernel launches {launches} (= {want}: "
        f"{per_batch} forward per batched train step and eval batch, "
        f"{per_batch} backward per batched train step)")
    return {"text": text, "experiment_wall_s": wall_s, "launches": launches,
            "expected_launches": want, "epochs": epochs,
            "result_line": re.search(r"^Result - .*$", text, re.M).group(0)}


def _adam_state(optimizer, model, exp_avg, exp_avg_sq, step, device, dtype):
    """Set torch Adam's state of every param of `model` to the given
    moments (name -> tensor) and step count."""
    for name, p in model.named_parameters():
        optimizer.state[p] = {
            "step": torch.tensor(float(step)),
            "exp_avg": exp_avg[name].detach().to(device, dtype).clone(),
            "exp_avg_sq": exp_avg_sq[name].detach().to(device, dtype).clone()}


def fold_parallel_vs_sequential_steps(dev, train, n_steps=FP_STEPS):
    """`n_steps` fold-parallel train steps of all folds of phase 7's
    experiment (dropout 0) on the card against the same steps taken one
    fold at a time on the card (`steps.train_step`) and in float64 on the
    CPU, each step from the fold-parallel state before it (params, batch
    statistics, Adam's moments and step count), under
    `card_vs_cpu_steps`' rules with the sequential card run in the CPU's
    place: per fold, the loss sum within rtol 2e-4; each leaf's gradient
    |g_fp - g64| <= 1e-3 |g64| + 2 |g_seq - g64| (leaves zero to rounding,
    |g64| <= |g_seq - g64|, are logged); the params and batch statistics
    after the step within 1e-4, widened by Adam's amplification of the
    gradient difference, 2 `adam_sensitivity` |g_fp - g_seq|, and entries
    whose gradient is zero to rounding within twice `adam_step_bound`."""
    cpu = torch.device("cpu")
    mcfg = dataclasses.replace(train["mcfg"], dropout_lin=0.0,
                               dropout_regr=0.0, dropout_go=0.0,
                               dropout_readout=0.0)
    tcfg, kind, topo = train["tcfg"], train["kind"], train["topo"]
    cohort = train["cohort"]
    full = cohort_batch_arrays(cohort)
    b = tcfg.batch_size
    ps = [prepare_fold(cohort, full, split, f, tcfg, tcfg.clinical_score_index)
          for f, split in enumerate(train["splits"])]
    spe = [p["train_data"]["y"].shape[0] // b for p in ps]
    data = [{k: v[p["perms"][0][:n_steps * b]] for k, v in
             p["train_data"].items()} for p in ps]
    models = [quiet(init_fold_model(mcfg, topo, tcfg.seed, f, cpu,
                                    kind=kind)[0]) for f in range(len(ps))]
    fp = steps.StackedState([copy.deepcopy(m).to(dev) for m in models], tcfg,
                            spe, kind)
    seq = [steps.TrainState(copy.deepcopy(m).to(dev), tcfg, n, kind)
           for m, n in zip(models, spe)]
    exact = [steps.TrainState(copy.deepcopy(m).double(), tcfg, n, kind)
             for m, n in zip(models, spe)]
    stacked = {k: torch.as_tensor(np.stack([d[k] for d in data]), device=dev)
               for k in data[0]}
    if steps.record_noise_shapes(fp, {k: v[:, :b] for k, v in stacked.items()},
                                 mcfg, tcfg):
        raise AssertionError("a dropout-0 flagship step drew noise")
    failures, rel, grad_rel, state_max = [], 0.0, 0.0, 0.0
    for t in range(1, n_steps + 1):
        rows = slice((t - 1) * b, t * b)
        for f, (sq, ex) in enumerate(zip(seq, exact)):
            fold_sd = fp.fold_state_dict(f)
            for state, device, dtype in ((sq, dev, torch.float32),
                                         (ex, cpu, torch.float64)):
                state.model.load_state_dict(
                    {k: v.to(device, dtype if v.is_floating_point() else v.dtype)
                     for k, v in fold_sd.items()})
                _adam_state(state.optimizer, state.model,
                            {k: v[f] for k, v in fp.exp_avg.items()},
                            {k: v[f] for k, v in fp.exp_avg_sq.items()},
                            fp.steps[f], device, dtype)
                state.step = int(fp.steps[f])
        lr = [steps.lr_at_step(tcfg, int(fp.steps[f]), spe[f])
              for f in range(len(ps))]
        batch = {k: v[:, rows] for k, v in stacked.items()}
        loss_fp = steps.batched_train_step(fp, batch, mcfg, tcfg, None,
                                           np.ones(len(ps), bool)).cpu()
        for f, (sq, ex) in enumerate(zip(seq, exact)):
            one = {k: v[f] for k, v in batch.items()}
            loss_seq = float(steps.train_step(sq, one, mcfg, tcfg, None))
            steps.train_step(ex, {k: v.to(cpu).double()
                                  if v.is_floating_point() else v.to(cpu)
                                  for k, v in one.items()}, mcfg, tcfg, None)
            r = abs(float(loss_fp[f]) - loss_seq) / abs(loss_seq)
            rel = max(rel, r)
            if r > 2e-4:
                failures.append(f"step {t} fold {f}: loss sum {float(loss_fp[f])}"
                                f" fold-parallel, {loss_seq} sequential")
            sens = adam_sensitivity(sq.optimizer, sq.model, lr[f])
            zero = {}
            for n, p in ex.model.named_parameters():
                if p.grad is None:
                    continue
                g64 = p.grad.numpy()
                g_fp = fp.params[n].grad[f].double().cpu().numpy()
                g_seq = dict(sq.model.named_parameters())[n].grad.double(
                    ).cpu().numpy()
                rounding = np.maximum(np.abs(g_fp - g64), np.abs(g_seq - g64))
                zero[n] = ((np.abs(g64) <= rounding) & (rounding > 0),
                           np.abs(g_fp - g_seq))
                norm = float(np.linalg.norm(g64))
                seq_err = float(np.linalg.norm(g_seq - g64))
                fp_err = float(np.linalg.norm(g_fp - g64))
                if norm <= seq_err:
                    log(f"step {t} fold {f} grad {n}: zero to rounding "
                        f"(|g64| {norm:.3e}, |seq - g64| {seq_err:.3e})")
                    continue
                grad_rel = max(grad_rel, fp_err / norm)
                if fp_err > 1e-3 * norm + 2 * seq_err:
                    failures.append(f"step {t} fold {f} grad {n}: |fp - g64| "
                                    f"{fp_err:.3e} > {1e-3 * norm + 2 * seq_err:.3e}")
            bound = 2 * adam_step_bound(lr[f], t)
            got = {k: v.detach().double().cpu().numpy()
                   for k, v in fp.fold_state_dict(f).items()
                   if v.is_floating_point()}
            for n, want in _floats(sq.model).items():
                diff = np.abs(got[n] - want)
                walking, gdiff = zero.get(n, (np.zeros(diff.shape, bool), 0.0))
                pin = 1e-4 + (2 * sens[n] * gdiff if n in sens else 0.0)
                over = float((diff - pin)[~walking].max(initial=-1.0))
                state_max = max(state_max, float(diff[~walking].max(initial=0.0)))
                if over > 0:
                    failures.append(f"step {t} fold {f} state {n}: "
                                    f"{over:.3e} past its pin")
                if float(diff[walking].max(initial=0.0)) > bound:
                    failures.append(f"step {t} fold {f} state {n}: "
                                    "zero-to-rounding entries past "
                                    f"{bound:.3e}")
    if failures:
        raise AssertionError("fold-parallel vs sequential: "
                             + "; ".join(failures))
    out = {"steps": n_steps, "folds": len(ps), "loss_max_rel_diff": rel,
           "grad_max_rel_err": grad_rel, "state_max_abs_diff": state_max}
    log(f"fold-parallel vs sequential on the card over {n_steps} steps of "
        f"{len(ps)} folds, each from the fold-parallel state: loss max rel "
        f"diff {rel:.3e}, gradients max rel err vs float64 {grad_rel:.3e}, "
        f"params/batch_stats max abs diff {state_max:.3e} (pin 1e-4)")
    # a warm batched step of the 5 folds, as `step_breakdown` reads one
    # fold's step in phase 8
    first = {k: v[:, :b] for k, v in stacked.items()}
    breakdown = step_breakdown({"step": lambda: steps.batched_train_step(
        fp, first, mcfg, tcfg, None, np.ones(len(ps), bool))})
    one = breakdown["profiled_step"]
    log_profile(f"warm fold-parallel train step ({len(ps)} folds x "
                f"B={b}, N=90)", one)
    if (one["gcn_stack_launches"], one["gcn_stack_backward_launches"]) != (
            2, 2):
        raise AssertionError("a fold-parallel step must launch the forward "
                             "and the backward kernel twice each (plain and "
                             "masked pass, all folds); the profiler saw "
                             f"{one['gcn_stack_launches']} and "
                             f"{one['gcn_stack_backward_launches']}")
    log(f"fold-parallel train step: host wall {breakdown['step_wall_ms']:.4f}"
        f" ms (median of 10), device busy {breakdown['step_device_ms']:.4f} "
        f"ms (profiler, 5 steps)")
    out.update(step_wall_ms=breakdown["step_wall_ms"],
               step_device_ms=breakdown["step_device_ms"],
               profiled_step=one)
    return out


def fold_records(res_dir, name):
    """{fold: record} of a results dir's fold records of stem `name`."""
    out = {}
    for path in glob.glob(os.path.join(res_dir, f"fold_result_{name}_fold_*.npz")):
        with np.load(path) as zf:
            out[int(path.rsplit("_", 1)[1][:-4])] = {k: zf[k] for k in zf.files}
    return out


# a seed of a 15-entry batch against its own 5-entry run: the two vmapped
# programs run cuBLAS's batched GEMMs at other batch counts, so with other
# kernels and summation orders, and 17 Adam steps compound the rounding
# (1.330e-4 read on an NVIDIA H100 80GB HBM3 at 700 W)
SEED_RECORD_RTOL = 1e-3


def same_records(got, want, what):
    """Two runs' fold records: the same folds and keys, equal subject ids,
    labels, true scores and meta, test losses within SEED_RECORD_RTOL, and
    accuracies equal but for at most one test subject per fold-epoch (a
    class decision that rounding tips, as phase 10's resume allows)."""
    if sorted(got) != sorted(want) or not got:
        raise AssertionError(f"{what}: folds {sorted(got)} vs {sorted(want)}")
    worst = 0.0
    for fold in want:
        a, b = got[fold], want[fold]
        if set(a) != set(b):
            raise AssertionError(f"{what} fold {fold}: keys differ")
        for key in ("subid", "true_labels", "true_scores", "meta"):
            if not np.array_equal(a[key], b[key]):
                raise AssertionError(f"{what} fold {fold}: {key} differs")
        np.testing.assert_allclose(a["test_losses"], b["test_losses"],
                                   rtol=SEED_RECORD_RTOL, err_msg=what)
        worst = max(worst, float(np.max(np.abs(a["test_losses"] - b["test_losses"])
                                        / np.abs(b["test_losses"]))))
        n_test = len(b["true_labels"])
        if np.any(np.abs(a["accs"] - b["accs"]) > 1.0 / n_test + 1e-9):
            raise AssertionError(f"{what} fold {fold}: accuracies "
                                 f"{a['accs']} vs {b['accs']}")
    return worst


def phase_fold_parallel(dev, train):
    log("== phase 15: batched experiments on the card (--fold_parallel, "
        "--cv_seeds, --permut_seeds, --batch_file)")
    tcfg = train["tcfg"]
    splits = train["splits"]
    name = result_name(2, 16)
    out = {}
    seq_tcfg = dataclasses.replace(tcfg, epochs=FP_EPOCHS)
    text, launches, seq_wall, _ = cli_run(cli_argv(FP_EPOCHS,
                                                   "_chip_smoke_seq"))
    want = expected_launches(splits, seq_tcfg)
    if launches != want:
        raise AssertionError(f"sequential {FP_EPOCHS}-epoch run: {launches} "
                             f"launches, the loop implies {want}")
    fp = fp_run(cli_argv(FP_EPOCHS, "_chip_smoke_fp", "--fold_parallel"),
                [splits], tcfg, f"--fold_parallel {FP_EPOCHS} epochs",
                epochs=FP_EPOCHS)
    seq_losses, fp_losses = epoch_losses(text), epoch_losses(fp["text"])
    if sorted(seq_losses) != sorted(fp_losses):
        raise AssertionError("fold-parallel and sequential epoch lines differ")
    worst = max(abs(a - b) / abs(b) for key in seq_losses
                for a, b in zip(fp_losses[key], seq_losses[key]))
    log(f"--fold_parallel vs sequential, {FP_EPOCHS} epochs, dropout on: "
        f"per-epoch losses (as printed, 4 decimals) max rel diff {worst:.3e}; "
        f"wall {fp['experiment_wall_s']:.3f} s against {seq_wall:.3f} s "
        f"sequential ({seq_wall / fp['experiment_wall_s']:.2f}x); launches "
        f"{fp['launches']} against {launches} "
        f"({fp['launches']['forward'] // FP_EPOCHS} against "
        f"{launches['forward'] // FP_EPOCHS} forward per epoch)")
    if worst > 1e-3:
        raise AssertionError("fold-parallel epoch losses depart from the "
                             f"sequential run's by {worst:.3e} (> 1e-3 of the "
                             "printed 4 decimals)")
    out["flagship"] = {**{k: v for k, v in fp.items() if k != "text"},
                       "sequential_wall_s": seq_wall,
                       "sequential_launches": launches,
                       "printed_loss_max_rel_diff": worst,
                       # what phase 19 holds its repeats of both runs to
                       "epoch_lines": EPOCH_LINE.findall(fp["text"]),
                       "sequential_epoch_lines": EPOCH_LINE.findall(text),
                       "sequential_result_line": re.search(
                           r"^Result - .*$", text, re.M).group(0)}
    out["steps"] = fold_parallel_vs_sequential_steps(dev, train)

    multi = fp_run(FP_MULTI_ARGV, [splits], tcfg,
                   "--fold_parallel --isMultiFusion 1 epoch")
    out["multi_fusion"] = {k: v for k, v in multi.items() if k != "text"}
    out["multi_fusion"]["epoch_lines"] = EPOCH_LINE.findall(multi["text"])

    seeds = port_main.parse_permut_seeds(FP_SEEDS, None)
    seed_splits = [k_fold(train["cohort"].y, tcfg.folds, s) for s in seeds]
    rep = fp_run(cli_argv(1, "_chip_smoke_seeds", "--fold_parallel",
                          "--cv_seeds", FP_SEEDS), seed_splits, tcfg,
                 f"--cv_seeds {FP_SEEDS} --fold_parallel 1 epoch")
    line = re.search(r"^Replication over 3 seeds - acc .*$", rep["text"], re.M)
    if line is None:
        raise AssertionError("no `Replication over 3 seeds` line")
    worst_seed = 0.0
    with tempfile.TemporaryDirectory(prefix="chip_smoke_seed_") as tmp:
        for s in seeds:
            alone = dataclasses.replace(tcfg, seed=s, epochs=1,
                                        fold_parallel=True)
            with contextlib.redirect_stdout(io.StringIO()):
                port_cv.cross_validation(
                    train["cohort"], train["topo"], train["mcfg"], alone,
                    res_dir=os.path.join(tmp, str(s)), result_file_name=name,
                    model_kind=train["kind"], device=dev)
            worst_seed = max(worst_seed, same_records(
                fold_records(run_dir(f"_chip_smoke_seeds_seed{s}"), name),
                fold_records(os.path.join(tmp, str(s)), name),
                f"seed {s} of the batch vs its standalone fold-parallel run"))
    log(f"{line.group(0)}; every seed's fold records match its standalone "
        f"fold-parallel run (test losses max rel diff {worst_seed:.3e})")
    out["cv_seeds"] = {**{k: v for k, v in rep.items() if k != "text"},
                       "replication_line": line.group(0),
                       "records_test_loss_max_rel_diff": worst_seed}

    permut = fp_run(cli_argv(1, "_chip_smoke_permut", "--fold_parallel",
                             "--permut_seeds", FP_SEEDS), [splits] * 3, tcfg,
                    f"--permut_seeds {FP_SEEDS} --fold_parallel 1 epoch")
    nulls = [os.path.join(os.getcwd(), "results_permuttest",
                          f"ADNI_chip_smoke_permut_permut{s}") for s in seeds]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        code = report.main([run_dir("_chip_smoke_fp"), "--permut_null", *nulls])
    log(buf.getvalue().rstrip())
    pvals = re.findall(r"^\| " + re.escape(name) + r" \| [\d.]+ \| 3 \| "
                       r"[\d.]+ \| [\d.]+ \| ([\d.]+) \|$", buf.getvalue(),
                       re.M)
    if code != 0 or not pvals:
        raise AssertionError("tools.report --permut_null printed no p-value")
    log(f"permutation p-value of the observed accuracy over 3 nulls: "
        f"{pvals[0]}")
    out["permut_seeds"] = {**{k: v for k, v in permut.items() if k != "text"},
                           "p_value": float(pvals[0])}

    os.makedirs(OUT_DIR, exist_ok=True)
    path = os.path.join(OUT_DIR, "batch.txt")
    fused = cli_argv(1, "_chip_smoke_batch_fused", "--fold_parallel")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_batch_") as cache:
        zoo = zoo_argv("GCN", "_chip_smoke_batch_zoo", cache)
        with open(path, "w") as fh:
            fh.write("# fused, zoo, then a line that fails\n"
                     + shlex.join(fused) + "\n\n" + shlex.join(zoo) + "\n"
                     + "--device cuda --model BOGUS\n")
        buf = io.StringIO()
        reset_launches()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf), \
                contextlib.redirect_stderr(io.StringIO()):
            try:
                port_main.main(["--batch_file", path])
                code = 0
            except SystemExit as e:
                code = e.code
        batch_wall = time.perf_counter() - t0
    log(buf.getvalue().rstrip())
    done = [os.path.exists(os.path.join(run_dir(a), "log.txt")) and
            "Result - " in open(os.path.join(run_dir(a), "log.txt")).read()
            for a in ("_chip_smoke_batch_fused", "_chip_smoke_batch_zoo")]
    if code != 1 or not all(done) or "[batch] 2/3 experiments succeeded" \
            not in buf.getvalue():
        raise AssertionError(f"--batch_file: exit {code}, runs done {done}")
    log(f"--batch_file of a fused, a zoo and a failing line: exit 1, the "
        f"first two done, {batch_wall:.3f} s, kernel launches "
        f"{launch_counts()}")
    out["batch_file"] = {"exit": code, "wall_s": batch_wall,
                         "launches": launch_counts()}
    return out

# phase 16: bf16 serving. The bf16 form against its plain version at the
# fp32 tolerances RTOL / ATOL (both sum fp32 products of the same bf16
# values); bf16 serving on the card against the CPU's bf16 plain path
# within BF16_SERVE_ATOL (log_probs, our_reg, prob: the outputs are fp32,
# their inputs bf16-rounded alike, so the card and the CPU differ by the
# summation order of fp32 sums and by bf16 roundings of intermediate
# products that land on either side of a tie: ~1e-4 measured on the CPU
# against the JAX package at full width), pred equal where the decision is
# wider than that; and against the card's fp32 under the JAX package's own
# bf16 rule (tests/test_predict.py: atol 0.15, agreement >= 0.9)
BF16_SERVE_ATOL = 2e-3
BF16_FP32_ATOL, BF16_FP32_AGREE = 0.15, 0.9
# the timed bf16 shapes: serving at N=90 and multi-fusion serving at N=270
BF16_TIMED = [("serving", BATCH, 90, 3, (16, 16)),
              ("multi-fusion", BATCH, 270, 1, (10, 10, 10))]
# phase 16's short --profile_dir run and the diffusion cohort
PROFILE_SUBJECTS, DIFFUSION_SUBJECTS = 120, COHORT
# relative gap of a column's k-th and (k+1)-th PPR values below which the
# fp32 device backend may select otherwise than float64 numpy (~1e-7 seen)
DIFFUSION_TIE = 1e-5


def to_bf16(args):
    """(prop, x, weights, biases) with every tensor in bf16."""
    prop, x, ws, bs = args
    b16 = torch.bfloat16
    return (prop.to(b16), x.to(b16), [w.to(b16) for w in ws],
            [b.to(b16) for b in bs])


def plain_stack_bf16(prop, x, weights, biases):
    """The bf16 form's plain version: the fp32 stack on the upcasts."""
    return gcn_stack.gcn_stack_reference(
        prop.float(), x.float(), [w.float() for w in weights],
        [b.float() for b in biases])


def library_stack_bf16(prop, x, weights, biases):
    """The upcast, then PyTorch's matmul + baddbmm + relu. A yardstick
    only; the port never calls it."""
    return library_stack(prop.float(), x.float(), [w.float() for w in weights],
                         [b.float() for b in biases])


def stack_work_bf16(b, n, f0, widths):
    """(bytes, flops) of the bf16 form: bf16 inputs read once, the fp32
    output written once; the same FLOPs as the fp32 form."""
    dims = [f0] + list(widths)
    params = sum(dims[i] * dims[i + 1] + dims[i + 1] for i in range(len(widths)))
    nbytes = 2 * (b * n * n + b * n * f0 + params) + 4 * b * n * sum(widths)
    return nbytes, stack_work(b, n, f0, widths)[1]


def compare_bf16(got, want, what, atol):
    """Every float output within `atol`, finite, of the expected shape;
    pred equal wherever the decision is wider than `atol`."""
    if set(got) != set(want):
        raise AssertionError(f"{what}: outputs {sorted(got)} vs {sorted(want)}")
    worst = 0.0
    for key in sorted(set(want) - {"pred"}):
        if got[key].shape != want[key].shape or not np.isfinite(got[key]).all():
            raise AssertionError(f"{what}: {key} shape {got[key].shape} vs "
                                 f"{want[key].shape}, or not finite")
        err = float(np.abs(got[key] - want[key]).max(initial=0.0))
        if err > atol:
            raise AssertionError(f"{what}: {key} differs by {err} > {atol}")
        worst = max(worst, err)
    if "prob" in want:
        decided = np.abs(want["prob"] - 0.5) > atol
    else:
        lp = np.sort(want["log_probs"], axis=1)
        decided = lp[:, -1] - lp[:, -2] > atol
    if not np.array_equal(got["pred"][decided], want["pred"][decided]):
        raise AssertionError(f"{what}: pred differs on decided subjects")
    return worst


def bf16_vs_fp32(got, fp32, what):
    """The JAX package's bf16 rule against fp32 on the same device."""
    for key in sorted(set(fp32) - {"pred"}):
        err = float(np.abs(got[key] - fp32[key]).max(initial=0.0))
        if err > BF16_FP32_ATOL:
            raise AssertionError(f"{what}: bf16 {key} {err} from fp32")
    agree = float(np.mean(got["pred"] == fp32["pred"]))
    if agree < BF16_FP32_AGREE:
        raise AssertionError(f"{what}: bf16/fp32 prediction agreement {agree}")
    return agree


def counted_bf16(fn):
    """(fn's result, the bf16 form's launches in that call)."""
    gcn_stack.fused_gcn_stack.launches_bf16 = 0
    out = fn()
    torch.cuda.synchronize()
    return out, gcn_stack.fused_gcn_stack.launches_bf16


def phase_bf16_kernel(dev):
    """The bf16 form against its plain version at every grid shape and
    `BF16_BATCHES`, both P layouts, `BF16_REFILL_CASES` (CTAs of at least
    three samples), the bf16 branch shapes and P whose samples start 2
    bytes off (value by value); one launch per call, none of the fp32
    form."""
    rng = np.random.default_rng(16)
    max_err, calls, seen = 0.0, 0, set()
    gcn_stack.fused_gcn_stack.launches = 0
    gcn_stack.fused_gcn_stack.launches_bf16 = 0
    sms = torch.cuda.get_device_properties(dev).multi_processor_count

    def check(what, args):
        nonlocal max_err, calls
        prop, x, ws = args[0], args[1], args[2]
        b, n = prop.shape[:2]
        plan = gcn_stack.plan_launch(b, n, (x.shape[-1], *(w.shape[1] for w in ws)),
                                     2, sms)
        seen.add(bf16_branch(plan))
        with torch.inference_mode():
            out = gcn_stack.fused_gcn_stack(*args)
            ref = plain_stack_bf16(*args)
        torch.cuda.synchronize()
        calls += 1
        if out.dtype != torch.float32:
            raise AssertionError(f"bf16 form {what}: output {out.dtype}")
        err = float((out - ref).abs().max())
        torch.testing.assert_close(out, ref, rtol=RTOL, atol=ATOL,
                                   msg=lambda m: f"bf16 form {what}: {m}")
        max_err = max(max_err, err)

    for n, f0, widths in STACK_SHAPES:
        for b in BF16_BATCHES:
            args = to_bf16(stack_inputs(rng, b, n, f0, widths, dev))
            check((b, n, f0, widths), args)
            check((b, n, f0, widths, "row-major"),
                  (args[0].contiguous(),) + args[1:])
    for b, n, f0, widths in BF16_REFILL_CASES:
        plan = gcn_stack.plan_launch(b, n, (f0, *widths), 2, sms)
        per_cta = b // plan.grid(b)
        if not isinstance(plan, gcn_stack.PersistentPlan) or per_cta < 3:
            raise AssertionError(f"bf16 refill case B={b} N={n} H={widths}: "
                                 f"{per_cta} samples a CTA")
        args = to_bf16(stack_inputs(rng, b, n, f0, widths, dev))
        check((b, n, f0, widths, f"K split {plan.ksplit}, at least "
               f"{per_cta} samples a CTA"), args)
    slack_err = bf16_slack_check(rng, dev)
    for n, f0, widths in BF16_BRANCH_SHAPES:
        for b in (1, 7):
            args = to_bf16(stack_inputs(rng, b, n, f0, widths, dev))
            check((b, n, f0, widths), args)
    for n, f0, widths in ((90, 3, (16, 16)), (270, 1, (10, 10, 10))):
        prop, x, ws, bs = to_bf16(stack_inputs(rng, 7, n, f0, widths, dev))
        flat = torch.zeros(7 * n * n + 1, dtype=torch.bfloat16, device=dev)
        flat[1:] = prop.transpose(1, 2).reshape(-1)
        shifted = flat[1:].reshape(7, n, n).transpose(1, 2)
        check(f"N={n} P 2 bytes off", (shifted, x, ws, bs))
    launches = gcn_stack.fused_gcn_stack.launches_bf16
    if launches != calls or gcn_stack.fused_gcn_stack.launches:
        raise AssertionError(f"{calls} bf16 calls launched the bf16 form "
                             f"{launches} times and the fp32 form "
                             f"{gcn_stack.fused_gcn_stack.launches}")
    log(f"bf16 form vs plain: {calls} calls ({len(STACK_SHAPES)} grid shapes "
        f"x B {BF16_BATCHES} x both P layouts, {len(BF16_REFILL_CASES)} "
        f"refill case, {len(BF16_BRANCH_SHAPES)} branch shapes x B (1, 7), a "
        f"2-byte-offset P at N=90 and 270) over "
        f"the plan branches {sorted(seen, key=str)}, max abs err "
        f"{max_err:.3e} (rtol {RTOL}, atol {ATOL}), one launch each; the "
        f"odd-grid slack check {slack_err:.3e}")
    return max(max_err, slack_err), calls


def bf16_slack_check(rng, dev):
    """The persistent kernel launched directly on a plan for a card of 131
    SMs (an odd grid) at N=270, B=300: a CTA's next sample then sits at
    another lead in the stage than the one before, so the slack after it
    held that sample's last values until the refill zeroed them. Sample 1's last
    four values are inf; every other sample must match the plain version
    (K's pad columns read the slack times zero rows of hW). Not counted
    as a launch of the wrapper."""
    b, n, f0, widths = 300, 270, 1, (10, 10, 10)
    plan = gcn_stack.plan_launch(b, n, (f0, *widths), 2, sms=131)
    prop, x, ws, bs = to_bf16(stack_inputs(rng, b, n, f0, widths, dev))
    leads = {(prop[s].data_ptr() % 16) // 2 for s in (1, 1 + plan.grid(b))}
    if plan.grid(b) != 131 or len(leads) != 2:
        raise AssertionError(f"slack check: grid {plan.grid(b)}, leads "
                             f"{leads}; the case does not arise")
    prop.transpose(1, 2).reshape(b, -1)[1, -4:] = float("inf")
    out = torch.empty((b, n, sum(widths)), device=dev)
    with torch.inference_mode():
        gcn_stack._launch_persistent(plan, prop, x, ws, bs, out,
                                     [f0, *widths], True, dev.index or 0)
        ref = plain_stack_bf16(prop, x, ws, bs)
    torch.cuda.synchronize()
    keep = torch.arange(b, device=dev) != 1
    torch.testing.assert_close(out[keep], ref[keep], rtol=RTOL, atol=ATOL,
                               msg=lambda m: f"bf16 slack check: {m}")
    return float((out[keep] - ref[keep]).abs().max())


def bf16_branch(plan):
    """The kernel branch a bf16 plan takes: ("persistent", 1, K split) or
    ("cluster", cluster, K split)."""
    kind = ("persistent" if isinstance(plan, gcn_stack.PersistentPlan)
            else "cluster")
    return (kind, plan.cluster, plan.ksplit)


def phase_bf16_times(dev, card_name):
    """Warm and cold device ms of the bf16 form, its plain version and the
    library composition at BF16_TIMED, beside the bound; and the fp32 form
    on the upcast inputs, warm, timed in turns with the bf16 form (bf16,
    fp32, fp32, bf16; each the mean of its two readings)."""
    spec, bw, peak = card_spec(card_name)
    flush = torch.empty(FLUSH_BYTES // 4, dtype=torch.float32, device=dev)
    rng = np.random.default_rng(17)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rows = []
    with torch.inference_mode():
        for name, b, n, f0, widths in BF16_TIMED:
            args = to_bf16(stack_inputs(rng, b, n, f0, widths, dev))
            up = (args[0].float(), args[1].float(),
                  [w.float() for w in args[2]], [v.float() for v in args[3]])
            fns = {"kernel": lambda: gcn_stack.fused_gcn_stack(*args),
                   "plain": lambda: plain_stack_bf16(*args),
                   "library": lambda: library_stack_bf16(*args)}
            nbytes, flops = stack_work_bf16(b, n, f0, widths)
            bytes_ms, flops_ms = nbytes / bw * 1e3, flops / peak * 1e3
            plan = gcn_stack.plan_launch(b, n, (f0, *widths), 2, sms)
            row = {"shape": name, "B": b, "N": n, "F0": f0,
                   "widths": list(widths), "bytes": nbytes, "flops": flops,
                   "bound_ms": max(bytes_ms, flops_ms),
                   "bound_by": "bytes" if bytes_ms >= flops_ms else "operations",
                   "plan": {"branch": list(bf16_branch(plan)),
                            "threads": plan.threads,
                            "ctas_per_sm": getattr(plan, "ctas_per_sm", None),
                            "smem_bytes": plan.smem_bytes}}
            turns = {"kernel": [], "fp32": []}
            for what in ("kernel", "fp32", "fp32", "kernel"):
                turns[what].append(device_ms(
                    fns["kernel"] if what == "kernel" else
                    lambda: gcn_stack.fused_gcn_stack(*up)))
            row["kernel_turns_ms"] = turns["kernel"]
            row["fp32_turns_ms"] = turns["fp32"]
            row["fp32_ms"] = statistics.mean(turns["fp32"])
            for what, fn in fns.items():
                row[f"{what}_ms"] = (statistics.mean(turns["kernel"])
                                     if what == "kernel" else device_ms(fn))
                row[f"{what}_cold_ms"] = cold_device_ms(fn, flush)
            rows.append(row)
            log(f"gcn_stack bf16 {name} B={b} N={n} F0={f0} H={widths} "
                f"({row['plan']}): kernel {row['kernel_ms']:.5f} ms warm "
                f"(turns {turns['kernel']}) / {row['kernel_cold_ms']:.5f} "
                f"cold, fp32 form on the upcasts {row['fp32_ms']:.5f} (turns "
                f"{turns['fp32']}), plain {row['plain_ms']:.5f} / "
                f"{row['plain_cold_ms']:.5f}, library {row['library_ms']:.5f} "
                f"/ {row['library_cold_ms']:.5f}, bound {row['bound_ms']:.5f} "
                f"ms ({row['bound_by']}; {nbytes} B, {flops} FLOP, {spec} "
                "peaks)")
    del flush
    return rows


def phase_bf16_serving(dev, fp32_model, fp32_served, cohort, artifacts):
    """The main path in bf16: phase 3's bundle served to the cohort with
    `dtype=torch.bfloat16` (the bf16 form's launches counted from 0 just
    before, read just after), held against the CPU's bf16 plain path and
    the card's fp32; the cohort walls of fp32 and bf16 in turns; then
    every phase-10 bundle likewise, with its launches per forward."""
    b16 = torch.bfloat16
    bundle = os.path.join(OUT_DIR, "bundle.npz")
    forwards = math.ceil(COHORT / BATCH)
    got, launches = counted_bf16(lambda: batched_forward(
        fp32_model, *cohort, batch_size=BATCH, dtype=b16))
    if launches != forwards:
        raise AssertionError(f"bf16 serving launched the bf16 form "
                             f"{launches} times over {forwards} forwards")
    cpu = batched_forward(load_bundle(bundle, device="cpu"), *cohort,
                          batch_size=BATCH, dtype=b16)
    err = compare_bf16(got, cpu, "bf16 serving card vs CPU", BF16_SERVE_ATOL)
    agree = bf16_vs_fp32(got, fp32_served, "bf16 serving vs fp32")
    bf16_model = cast_floating(load_bundle(bundle, device=dev), b16)
    walls = {"fp32": [], "bf16": []}
    for order in (("fp32", "bf16"), ("bf16", "fp32")) * 3:
        for what in order:
            model, dtype = ((fp32_model, None) if what == "fp32"
                            else (bf16_model, b16))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            batched_forward(model, *cohort, batch_size=BATCH, dtype=dtype)
            walls[what].append(time.perf_counter() - t0)
    wall = {k: statistics.median(v) for k, v in walls.items()}
    log(f"bf16 serving of {COHORT} subjects: {launches} bf16-form launches "
        f"over {forwards} forwards; card vs CPU bf16 max abs diff {err:.3e} "
        f"(atol {BF16_SERVE_ATOL}); agreement with fp32 {agree:.4f}; cohort "
        f"wall bf16 {wall['bf16']:.6f} s vs fp32 {wall['fp32']:.6f} s "
        "(median of 6, in turns)")
    out = {"launches": launches, "forwards": forwards,
           "card_vs_cpu_max_abs_diff": err, "fp32_agreement": agree,
           "cohort_wall_s": wall["bf16"], "fp32_cohort_wall_s": wall["fp32"],
           "bundles": {}}
    multi = make_cohort(np.random.default_rng(4), COHORT, rois=270, feat=1)
    for what, row in artifacts["serving"].items():
        data = multi if "N=270" in what else cohort
        gpu_model = load_bundle(row["bundle"], device=dev)
        cls = type(gpu_model).__name__
        fp32 = batched_forward(gpu_model, *data, batch_size=BATCH)
        got, n_bf16 = counted_bf16(lambda: batched_forward(
            gpu_model, *data, batch_size=BATCH, dtype=b16))
        if n_bf16 != SERVE_CALLS[cls] * forwards:
            raise AssertionError(f"{what}: bf16 serving launched the bf16 "
                                 f"form {n_bf16} times over {forwards} "
                                 f"forwards; {cls} launches it "
                                 f"{SERVE_CALLS[cls]} per forward")
        cpu = batched_forward(load_bundle(row["bundle"], device="cpu"), *data,
                              batch_size=BATCH, dtype=b16)
        err = compare_bf16(got, cpu, f"{what}: bf16 card vs CPU",
                           BF16_SERVE_ATOL)
        agree = bf16_vs_fp32(got, fp32, f"{what}: bf16 vs fp32")
        out["bundles"][what] = {
            "model_class": cls, "launches": n_bf16,
            "launches_per_forward": n_bf16 / forwards,
            "card_vs_cpu_max_abs_diff": err, "fp32_agreement": agree}
        log(f"{what} ({cls}) in bf16: {n_bf16} bf16-form launches over "
            f"{forwards} forwards; card vs CPU bf16 max abs diff {err:.3e}; "
            f"agreement with fp32 {agree:.4f}")
    return out


def phase_bf16_http(dev, cohort, want):
    """A `--bf16` daemon over phase 3's bundle: /health reports bfloat16,
    /predict of 1 and 37 subjects equals the bf16 cohort serve."""
    server = build_http_server(load_bundle(os.path.join(OUT_DIR, "bundle.npz"),
                                           device=dev),
                               device=dev, port=0, batch=BATCH,
                               dtype=torch.bfloat16)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        addr = server.server_address[:2]
        health = _get(addr, "/health")
        if health["dtype"] != "bfloat16":
            raise AssertionError(f"--bf16 daemon /health: {health}")
        lo = 0
        for n in (1, 37):
            got = _post(addr, {k: v[lo:lo + n] for k, v in
                               zip(("x", "adj", "snps"), cohort)})
            compare_bf16(got, {k: v[lo:lo + n] for k, v in want.items()},
                         f"bf16 /predict of {n} subjects", BF16_SERVE_ATOL)
            lo += n
        stats = _get(addr, "/stats")
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    log(f"--bf16 daemon: /health {json.dumps(health)}; /stats "
        f"{json.dumps(stats)}")
    return {"health": health, "requests": stats["requests"]}


def phase_tools(dev, layout):
    """tools.profile_step on the card; a short --profile_dir CLI run; the
    doctor on phase 12's layout and on a copy with one file removed; the
    diffusion backends on an 874 x 90 cohort."""
    import importlib.util

    from iggcn_tpu_torch.data import diffusion
    from iggcn_tpu_torch.tools import doctor, profile_step
    have = {m: importlib.util.find_spec(m) is not None
            for m in ("matplotlib", "sklearn")}
    log(f"not run on the card: --plot (matplotlib "
        f"{'present' if have['matplotlib'] else 'absent'}) and "
        f"data/cluster.py (scikit-learn "
        f"{'present' if have['sklearn'] else 'absent'}); the CPU tests hold "
        "both against the JAX package")
    out = {"have": have}
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        hist = profile_step.main(["--batch", str(BATCH), "--steps", "5",
                                  "--top", "10", "--device", str(dev),
                                  "--out",
                                  os.path.join(OUT_DIR, "profile_step")])
    text = buf.getvalue()
    log(text.rstrip())
    if "device time" not in text or not any(
            "gcn_stack_kernel" in name for name in hist):
        raise AssertionError("profile_step saw no device time or no "
                             "gcn_stack kernel")
    out["profile_step_s"] = time.perf_counter() - t0
    out["profile_step_device_ops"] = int(sum(c for _, c in hist.values()))

    trace_dir = os.path.join(OUT_DIR, "profile_dir")
    shutil.rmtree(trace_dir, ignore_errors=True)
    argv = cli_argv(1, "_chip_smoke_profile", "--profile_dir", trace_dir)
    argv[argv.index("--synthetic_subjects") + 1] = str(PROFILE_SUBJECTS)
    argv[argv.index("--fold") + 1] = "3"
    text, _, wall_s, _ = cli_run(argv)
    files = {name: os.path.getsize(os.path.join(trace_dir, name))
             for name in sorted(os.listdir(trace_dir))}
    with open(os.path.join(trace_dir, "trace.json")) as fh:
        events = json.load(fh)["traceEvents"]
    kernels = sum(1 for e in events if e.get("cat") == "kernel")
    if not kernels or re.search(r"^Result - ", text, re.M) is None:
        raise AssertionError(f"--profile_dir run: {kernels} kernel events")
    out["profile_dir"] = {"files": files, "kernel_events": kernels,
                          "wall_s": wall_s}
    log(f"--profile_dir run ({PROFILE_SUBJECTS} subjects, 3 folds, 1 epoch) "
        f"in {wall_s:.3f} s: {files}, {kernels} device kernel events")

    json_path, conn_path, genes_path = layout["go"]
    doc_argv = ["--data_path", layout["data_path"], "--isMultiFusion",
                "--json_path", json_path, "--go_connection_path", conn_path,
                "--snps_to_gene_path", genes_path]
    good = _run_main(doctor.main, doc_argv)
    broken = layout["data_path"] + "_broken"
    shutil.copytree(layout["data_path"], broken)
    os.remove(os.path.join(broken, "knn", "5", "corr_data.mat"))
    bad = _run_main(doctor.main, ["--data_path", broken] + doc_argv[2:])
    shutil.rmtree(broken)
    log(f"doctor on phase 12's layout: exit {good[0]}, "
        f"{good[1].strip().splitlines()[-1]}; with corr_data.mat removed: "
        f"exit {bad[0]}, {bad[1].strip().splitlines()[-1]}")
    if (good[0], bad[0]) != (0, 1):
        raise AssertionError(f"doctor exits {good[0]} / {bad[0]}, not 0 / 1:"
                             f"\n{good[1]}\n{bad[1]}")
    out["doctor_exit"] = {"layout": good[0], "one_file_removed": bad[0]}

    raw = make_cohort(np.random.default_rng(18), DIFFUSION_SUBJECTS)[1]
    walls, results = {}, {}
    # auto's first call builds the library (where no cohort loader has
    # yet) and device's first call starts the solver: the walls kept are
    # the second calls'
    for backend in ("numpy", "auto", "auto", "device", "device"):
        t0 = time.perf_counter()
        results[backend] = diffusion.preprocess_diffusion(
            raw, backend=backend, device=dev)
        walls[backend] = time.perf_counter() - t0
    ref = results["numpy"]
    if (np.abs(results["auto"] - ref).max() > 1e-12
            or not ((results["auto"] > 0) == (ref > 0)).all()):
        raise AssertionError("diffusion auto differs from numpy")
    # device is fp32: a column whose k-th and (k+1)-th PPR values are
    # closer than fp32 resolves may keep another entry (the JAX package's
    # device backend does the same); every other column must agree
    k, n = 3, raw.shape[-1]
    ppr = np.sort(np.stack([diffusion.get_ppr_matrix(a.astype(np.float64))
                            for a in raw]), axis=1)
    near = (ppr[:, n - k] - ppr[:, n - k - 1]) / ppr[:, n - k] < DIFFUSION_TIE
    dev_out = results["device"]
    differ = ((dev_out > 0) != (ref > 0)).any(axis=1)
    err = float(np.abs(np.where(near[:, None, :], 0.0, dev_out - ref)).max())
    if (differ & ~near).any() or err > 2e-5:
        raise AssertionError(f"diffusion device: {int((differ & ~near).sum())} "
                             f"columns apart from near-ties select other "
                             f"entries, max abs diff {err} (atol 2e-5)")
    errs = {"auto": float(np.abs(results["auto"] - ref).max()),
            "device_untied_columns": err}
    out["diffusion_columns"] = {"near_tied": int(near.sum()),
                                "selected_otherwise": int(differ.sum()),
                                "total": int(near.size)}
    out["diffusion"] = {"subjects": DIFFUSION_SUBJECTS, "walls_s": walls,
                        "max_abs_diff_vs_numpy": errs}
    log(f"-- host build of gdc_native.cpp:\n"
        f"{cuda_build.BUILD_LOGS.get('gdc_native.cpp', '').strip()}")
    log(f"diffusion of {DIFFUSION_SUBJECTS} x 90 x 90: walls {walls} s; "
        f"vs numpy max abs diff {errs}; device selected other entries in "
        f"{int(differ.sum())} of {near.size} columns, all near-tied "
        f"({int(near.sum())} columns within {DIFFUSION_TIE} relative)")
    return out


def _run_main(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        code = main(argv)
    return code, buf.getvalue()


def phase_bf16(dev, card_name, fp32_model, fp32_served, cohort, artifacts,
               layout):
    log("== phase 16: bf16 serving, the tools and the diffusion backends")
    max_err, calls = phase_bf16_kernel(dev)
    times = phase_bf16_times(dev, card_name)
    serving = phase_bf16_serving(dev, fp32_model, fp32_served, cohort,
                                 artifacts)
    http = phase_bf16_http(dev, cohort, batched_forward(
        fp32_model, *cohort, batch_size=BATCH, dtype=torch.bfloat16))
    tools = phase_tools(dev, layout)
    return {"max_abs_err": max_err, "checked_calls": calls, "times": times,
            "serving": serving, "http": http, "tools": tools}


# ---------------------------------------------------------------------------
# phase 17: the streamed form, for shapes the resident kernels cannot hold

# (B, N, F0, widths) of the streamed form's checks: the flagship at 2 and
# 3 layers of 128 (at 2 only the backward streams), 9 layers, the
# multi-fusion cohort at 3 layers of 32 (only the backward streams) and 1
# of 64 (only the forward), and the zoo's GCN at PROTEINS' 620 nodes at 3
# layers of 32 and at two points of its search grid, 3 of 16 and 2 of 10
STREAMED_SHAPES = [(32, 90, 3, (128, 128)), (32, 90, 3, (128, 128, 128)),
                   (32, 90, 3, (16,) * 9), (32, 270, 1, (32, 32, 32)),
                   (32, 270, 1, (64,)), (32, 620, 3, (32, 32, 32)),
                   (32, 620, 3, (16, 16, 16)), (32, 620, 3, (10, 10))]
STREAMED_GROUPED = [(5, 32, 90, 3, (128, 128, 128))]
# the bf16 form's streamed shapes: a bundle trained at --layers 3
# --hiddens 128 served at batch 256, and N=620 at three layers of 32 (at
# 620 x (16, 16) the bf16 form stays on the resident cluster design)
STREAMED_BF16 = [(256, 90, 3, (128, 128, 128)), (256, 620, 3, (32, 32, 32))]
# timed: the flagship's widest training shape, the zoo's at 3 x 32 and at
# two points of its search grid, and multi-fusion's at 3 x 32, whose
# forward stays resident and whose backward streams (name, B, N, F0,
# widths)
STREAMED_TIMED = [("flagship training --layers 3 --hiddens 128", 32, 90, 3,
                   (128, 128, 128)),
                  ("zoo GCN training, 620 nodes", 32, 620, 3, (32, 32, 32)),
                  ("zoo GCN grid --layers 3 --hiddens 16, 620 nodes", 32, 620,
                   3, (16, 16, 16)),
                  ("zoo GCN grid --layers 2 --hiddens 10, 620 nodes", 32, 620,
                   3, (10, 10)),
                  ("--isMultiFusion training --layers 3 --hiddens 32", 32,
                   270, 1, (32, 32, 32))]
# the routes: one epoch each; the TU layout's graphs leave fold 0 the six
# train batches of 32 that the card-vs-CPU steps take
STREAMED_EPOCHS = 1
TU_NAME, TU_GRAPHS, TU_MAX_NODES = "PROTEINS", 400, 620


def all_counts():
    """Every form's count: the resident fp32 forward's and backward's, and
    the streamed form's calls."""
    return {**launch_counts(),
            "streamed": gcn_stack.fused_gcn_stack.launches_streamed}


def reset_all():
    reset_launches()
    gcn_stack.fused_gcn_stack.launches_streamed = 0


def streamed_forms(b, n, dims):
    """(the forward streams, the backward streams) at this shape."""
    return (isinstance(gcn_stack.plan_launch(b, n, dims),
                       gcn_stack.StreamedPlan),
            isinstance(gcn_stack.plan_backward(b, n, dims),
                       gcn_stack.StreamedPlan))


def split_counts(want, forms):
    """The loop's {"forward", "backward"} launches split over the three
    counters as the forms at the route's shape say."""
    fwd, bwd = forms
    return {"forward": 0 if fwd else want["forward"],
            "backward": 0 if bwd else want["backward"],
            "streamed": (want["forward"] if fwd else 0)
            + (want["backward"] if bwd else 0)}


def phase_streamed_kernel(dev):
    """The streamed form against its plain versions on the card: the fp32
    forward in both P layouts and the backward (all four gradients,
    BWD_TOL) at `STREAMED_SHAPES`, the grouped form at `STREAMED_GROUPED`
    (forward and backward), the bf16 form at `STREAMED_BF16` (both
    layouts); each call made twice and bit-equal, the counters showing
    the streamed form where the plan says so and the resident kernels
    elsewhere. Returns the largest differences."""
    rng = np.random.default_rng(17)
    errs = {"forward": 0.0, "backward": 0.0, "grouped": 0.0, "bf16": 0.0}

    def run(fn):
        reset_all()
        out = fn()
        torch.cuda.synchronize()
        return out, all_counts()

    def forward(what, key, args, ref, forms_fwd):
        got, counts = run(lambda: gcn_stack.fused_gcn_stack(*args))
        again = gcn_stack.fused_gcn_stack(*args)
        bf16 = args[0].dtype == torch.bfloat16
        want = {"forward": int(not forms_fwd and not bf16), "backward": 0,
                "streamed": int(forms_fwd)}
        if counts != want:
            raise AssertionError(f"streamed {what}: launches {counts}, not "
                                 f"{want}")
        ref_out = ref(*args)
        torch.testing.assert_close(got, ref_out, rtol=RTOL, atol=ATOL)
        if not torch.equal(got, again):
            raise AssertionError(f"streamed {what}: two runs differ")
        err = float((got - ref_out).abs().max())
        errs[key] = max(errs[key], err)
        log(f"streamed {what}: forward max_abs_err {err:.3e}, launches "
            f"{counts}, bit-equal twice")

    def backward(what, key, args, forms):
        prop, x, ws, bs = args
        cot = torch.from_numpy(rng.normal(size=(
            *prop.shape[:2], sum(w.shape[-1] for w in ws))).astype(
            np.float32)).to(dev)
        got, counts = run(lambda: backward_grads(
            gcn_stack.fused_gcn_stack, prop, x, ws, bs, cot))
        want = split_counts({"forward": 1, "backward": 1}, forms)
        if counts != want:
            raise AssertionError(f"streamed {what}: launches {counts}, not "
                                 f"{want}")
        again = backward_grads(gcn_stack.fused_gcn_stack, prop, x, ws, bs, cot)
        plain = plain_backward(prop, x, ws, bs, cot)
        err = 0.0
        for k, (g, p, r) in enumerate(zip(got, plain, again)):
            torch.testing.assert_close(g, p, rtol=BWD_TOL, atol=BWD_TOL)
            if not torch.equal(g, r):
                raise AssertionError(f"streamed {what}: gradient {k} differs "
                                     "between two runs")
            err = max(err, float((g - p).abs().max()))
        errs[key] = max(errs[key], err)
        log(f"streamed {what}: backward max_abs_err {err:.3e}, launches "
            f"{counts}, bit-equal twice")

    for b, n, f0, widths in STREAMED_SHAPES:
        forms = streamed_forms(b, n, (f0, *widths))
        if not any(forms):
            raise AssertionError(f"N={n} {widths}: nothing streams here")
        prop, x, ws, bs = stack_inputs(rng, b, n, f0, widths, dev)
        for layout, p in (("transposed", prop), ("row-major",
                                                 prop.contiguous())):
            what = (f"B={b} N={n} F0={f0} H={widths} P {layout} (forward "
                    f"{'streamed' if forms[0] else 'resident'}, backward "
                    f"{'streamed' if forms[1] else 'resident'})")
            forward(what, "forward", (p, x, ws, bs),
                    gcn_stack.gcn_stack_reference, forms[0])
            backward(what, "backward", (p, x, ws, bs), forms)
    for f, b, n, f0, widths in STREAMED_GROUPED:
        args = grouped_inputs(rng, f, b, n, f0, widths, dev)
        forms = streamed_forms(f * b, n, (f0, *widths))
        what = f"grouped F={f} x B={b} N={n} H={widths}"
        forward(what, "grouped", args, gcn_stack.gcn_stack_reference_grouped,
                forms[0])
        backward(what, "grouped", args, forms)
    for b, n, f0, widths in STREAMED_BF16:
        if not isinstance(gcn_stack.plan_launch(b, n, (f0, *widths), 2),
                          gcn_stack.StreamedPlan):
            raise AssertionError(f"bf16 N={n} {widths} does not stream")
        prop, x, ws, bs = to_bf16(stack_inputs(rng, b, n, f0, widths, dev))
        for layout, p in (("transposed", prop), ("row-major",
                                                 prop.contiguous())):
            with torch.no_grad():
                forward(f"bf16 B={b} N={n} F0={f0} H={widths} P {layout}",
                        "bf16", (p, x, ws, bs), plain_stack_bf16, True)
    log(f"streamed form: max_abs_err {errs} (forward rtol {RTOL} / atol "
        f"{ATOL}, backward rtol/atol {BWD_TOL})")
    return errs


def phase_streamed_times(dev, card_name):
    """The streamed form at `STREAMED_TIMED`, in turns on the same inputs,
    warm and cold: the forward's wrapper beside `gcn_stack_reference` and
    `library_stack`, the backward's beside `gcn_stack_backward_reference`
    and the autograd recompute; each with its bound."""
    spec, bw, peak = card_spec(card_name)
    flush = torch.empty(FLUSH_BYTES // 4, dtype=torch.float32, device=dev)
    rng = np.random.default_rng(18)
    rows = []
    for name, b, n, f0, widths in STREAMED_TIMED:
        args = stack_inputs(rng, b, n, f0, widths, dev)
        cot = torch.randn(b, n, sum(widths), device=dev)
        needs = (True, True, True)
        for direction, fns, (nbytes, flops) in (
                ("forward", {"kernel": lambda: gcn_stack._launch(*args),
                             "plain": lambda: gcn_stack.gcn_stack_reference(
                                 *args),
                             "library": lambda: library_stack(*args)},
                 stack_work(b, n, f0, widths)),
                ("backward", {"kernel": lambda: gcn_stack._launch_backward(
                    *args, cot, needs),
                              "plain": lambda:
                                  gcn_stack.gcn_stack_backward_reference(
                                      *args, cot, needs),
                              "library": lambda: recompute_backward(*args,
                                                                    cot)},
                 backward_work(0, b, n, f0, widths))):
            bytes_ms, flops_ms = nbytes / bw * 1e3, flops / peak * 1e3
            plan = (gcn_stack.plan_launch(b, n, (f0, *widths))
                    if direction == "forward"
                    else gcn_stack.plan_backward(b, n, (f0, *widths)))
            row = {"shape": name, "direction": direction, "B": b, "N": n,
                   "F0": f0, "widths": list(widths), "bytes": nbytes,
                   "flops": flops, "bound_ms": max(bytes_ms, flops_ms),
                   "bound_by": "bytes" if bytes_ms >= flops_ms
                   else "operations",
                   "form": type(plan).__name__}
            for what, fn in fns.items():
                row[f"{what}_ms"] = device_ms(
                    fn, sleep_cycles=20_000_000 if what == "kernel"
                    else 100_000_000)
                row[f"{what}_cold_ms"] = cold_device_ms(fn, flush)
            rows.append(row)
            log(f"gcn_stack streamed {direction} {name} B={b} N={n} F0={f0} "
                f"H={widths} ({row['form']}): kernel {row['kernel_ms']:.5f} "
                f"ms warm / {row['kernel_cold_ms']:.5f} cold, plain "
                f"{row['plain_ms']:.5f} / {row['plain_cold_ms']:.5f}, library "
                f"{row['library_ms']:.5f} / {row['library_cold_ms']:.5f}, "
                f"bound {row['bound_ms']:.5f} ms ({row['bound_by']}; {nbytes} "
                f"B, {flops} FLOP, {spec} peaks)")
    del flush
    return rows


def streamed_fused_route(dev, argv, what):
    """A fused CLI route whose stack shape streams: one train step's and one
    eval batch's launches (three counters), the CLI run over
    `STREAMED_EPOCHS` with the loop's launches split as the forms say, and
    six card steps against the CPU under phase 7's rules."""
    train = training_setup(dev, argv)
    mcfg = train["mcfg"]
    dims = (mcfg.feat_dim, *([mcfg.hidden] * mcfg.num_layers))
    forms = streamed_forms(TRAIN_BATCH, mcfg.rois, dims)
    per_batch = STACK_CALLS["SGCN_GCN_IMGSNP"]
    step_want, eval_want = (split_counts(w, forms)
                            for w in step_launches(per_batch))

    def counted(fn):
        reset_all()
        fn()
        torch.cuda.synchronize()
        return all_counts()

    per_step = counted(train["step"])
    per_eval = counted(lambda: steps.eval_step(
        train["state"].model, train["eval_batch"], mcfg, train["tcfg"],
        train["kind"]))
    if (per_step, per_eval) != (step_want, eval_want):
        raise AssertionError(f"{what}: a train step / eval batch launched "
                             f"{per_step} / {per_eval}; expected {step_want} "
                             f"/ {eval_want}")
    reset_all()
    text, _, wall_s, _ = cli_run(argv)
    launches = all_counts()
    want = split_counts(expected_launches(train["splits"], train["tcfg"],
                                          per_batch), forms)
    epochs = EPOCH_LINE.findall(text)
    result = re.search(r"^Result - .*$", text, re.M)
    if (len(epochs) != TRAIN_FOLDS * STREAMED_EPOCHS or result is None
            or not all(np.isfinite(float(v)) for e in epochs for v in e[2:])):
        raise AssertionError(f"{what}: epoch lines {epochs}, result {result}")
    if launches != want:
        raise AssertionError(f"{what}: the run launched {launches}; the loop "
                             f"implies {want}")
    log(f"{what}: {wall_s:.3f} s wall, launches {launches} (= the loop's), "
        f"per train step {per_step}, per eval batch {per_eval}, "
        f"{result.group(0)}")
    return {"experiment_wall_s": wall_s, "launches": launches,
            "expected_launches": want, "launches_per_train_step": per_step,
            "launches_per_eval_batch": per_eval,
            "forms": {"forward": "streamed" if forms[0] else "resident",
                      "backward": "streamed" if forms[1] else "resident"},
            "result_line": result.group(0), "epochs": STREAMED_EPOCHS,
            "card_vs_cpu": card_vs_cpu_steps(dev, fused_route(train))}


def write_tu_layout(root, rng, name=TU_NAME, graphs=TU_GRAPHS,
                    largest=TU_MAX_NODES):
    """A raw TU benchmark directory shaped like PROTEINS: `graphs` graphs
    of 20 to `largest` nodes (one of exactly `largest`, so the dataset
    pads to it), 3 node labels (one-hot: F0 = 3), about 3.7 neighbours a
    node, two graph classes; the files `data/tu.py:read_tu_dir` reads."""
    base = os.path.join(root, name)
    os.makedirs(base, exist_ok=True)
    sizes = rng.integers(20, largest, size=graphs)
    sizes[rng.integers(graphs)] = largest
    edges, indicator, labels, first = [], [], [], 1
    for g, n in enumerate(sizes):
        ring = np.arange(n)
        extra = rng.integers(0, n, size=(int(n * 0.85), 2))
        pairs = np.concatenate([np.stack([ring, (ring + 1) % n], 1), extra])
        pairs = pairs[pairs[:, 0] != pairs[:, 1]]
        pairs = np.concatenate([pairs, pairs[:, ::-1]]) + first
        edges.append(pairs)
        indicator.append(np.full(n, g + 1))
        labels.append(rng.integers(1, 4, size=n))
        first += n
    y = (sizes > np.median(sizes)).astype(int) + 1
    np.savetxt(os.path.join(base, f"{name}_A.txt"), np.concatenate(edges),
               fmt="%d", delimiter=", ")
    np.savetxt(os.path.join(base, f"{name}_graph_indicator.txt"),
               np.concatenate(indicator), fmt="%d")
    np.savetxt(os.path.join(base, f"{name}_graph_labels.txt"), y, fmt="%d")
    np.savetxt(os.path.join(base, f"{name}_node_labels.txt"),
               np.concatenate(labels), fmt="%d")
    return root


def streamed_zoo_route(dev, tu_root):
    """The zoo's `--model GCN` over the fabricated TU layout (padded to its
    largest graph): the CLI run with the loop's launches split as the
    forms say, one train step's and one eval batch's launches, six card
    steps against the CPU under phase 7's rules."""
    appendix = "_chip_smoke_streamed_zoo"
    shutil.rmtree(run_dir(appendix), ignore_errors=True)
    argv = ["--device", "cuda", "--model", "GCN", "--data", TU_NAME,
            "--tu_root", tu_root, "--no-search", "--layers", "3",
            "--hiddens", "32", "--batch_size", str(TRAIN_BATCH), "--fold",
            str(TRAIN_FOLDS), "--epochs", str(STREAMED_EPOCHS),
            "--save_appendix", appendix]
    args, ds = zoo_data(argv)
    n, f0 = int(ds.x.shape[1]), int(ds.x.shape[2])
    forms = streamed_forms(TRAIN_BATCH, n, (f0, 32, 32, 32))
    if n != TU_MAX_NODES or not all(forms):
        raise AssertionError(f"zoo GCN: N={n}, F0={f0}, forms {forms}")
    reset_all()
    run = run_zoo(dev, argv, layers=3, hidden=32)
    launches = all_counts()
    want = split_counts(expected_launches(
        run["splits"], types.SimpleNamespace(batch_size=args.batch_size,
                                             epochs=args.epochs), 1), forms)
    if launches != want:
        raise AssertionError(f"zoo GCN at N={n}: the run launched {launches}; "
                             f"the loop implies {want}")
    route = zoo_route(args, ds)
    card = route["state"](copy.deepcopy(route["model"]).to(dev))
    batch = to_device({k: v[:TRAIN_BATCH] for k, v in route["data"].items()},
                      dev)
    _, evaluate = generic_cv.build_generic_steps(
        card.model, card.optimizer, needs_mask=False, needs_assign=False,
        adj_only=False, aux_loss=False, takes_weight=False)
    counts = []
    for fn in (lambda: card.train_step(batch, None, 1e-3),
               lambda: evaluate(batch)):
        reset_all()
        fn()
        torch.cuda.synchronize()
        counts.append(all_counts())
    if counts != [split_counts(w, forms) for w in step_launches(1)]:
        raise AssertionError(f"zoo GCN: {counts} per train step / eval batch")
    log(f"zoo GCN at N={n}, F0={f0}, {len(ds)} graphs: launches {launches} "
        f"(= the loop's), per train step / eval batch {counts}")
    return {"experiment_wall_s": run["experiment_wall_s"],
            "launches": launches, "expected_launches": want,
            "launches_per_train_step": counts[0],
            "launches_per_eval_batch": counts[1], "nodes": n,
            "graphs": len(ds), "result_line": run["result_line"],
            "epochs": STREAMED_EPOCHS,
            "card_vs_cpu": card_vs_cpu_steps(dev, route)}


def phase_streamed(dev, card_name):
    log("== phase 17: the streamed form (shapes the resident kernels cannot "
        "hold)")
    if gcn_stack.fused_gcn_stack.launches_streamed != 0:
        raise AssertionError(
            f"an earlier phase ran the streamed form "
            f"{gcn_stack.fused_gcn_stack.launches_streamed} times")
    t0 = time.perf_counter()
    errs = phase_streamed_kernel(dev)
    times = phase_streamed_times(dev, card_name)
    routes = {
        "SGCN_GCN_IMGSNP --layers 3 --hiddens 128": streamed_fused_route(
            dev, cli_argv(STREAMED_EPOCHS, "_chip_smoke_streamed", "--layers",
                          "3", "--hiddens", "128"),
            "flagship --layers 3 --hiddens 128"),
        "SGCN_GCN_IMGSNP --isMultiFusion --layers 3 --hiddens 32":
            streamed_fused_route(
                dev, cli_argv(STREAMED_EPOCHS, "_chip_smoke_streamed_multi",
                              "--isMultiFusion", "--layers", "3",
                              "--hiddens", "32"),
                "--isMultiFusion --layers 3 --hiddens 32")}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_tu_") as root:
        routes[f"zoo GCN --data {TU_NAME} (N={TU_MAX_NODES})"] = \
            streamed_zoo_route(dev, write_tu_layout(
                root, np.random.default_rng(19)))
    phase_s = time.perf_counter() - t0
    log(f"phase 17: {phase_s:.3f} s")
    return {"max_abs_err": errs, "times": times, "routes": routes,
            "phase_s": phase_s}


# ---------------------------------------------------------------------------
# phase 18: long training runs, the card against the CPU

# the flagship at full width (default ModelConfig, N=90, the real-scale GO
# DAG), a planted-signal cohort of LONG_SUBJECTS trained full batch from
# one set of random weights, dropout 0, at the CLI's default learning rate
# (at the harness's 5e-3 this DAG makes the CPU's own fp32 part from
# float64 by as much as the bounds allow); StepLR every LONG_DECAY epochs
# (three boundaries in LONG_EPOCHS); then at --layers 3 --hiddens 128,
# where both directions stream, for LONG_STREAMED_EPOCHS; the multi-fusion
# shape (270 ROIs, F0 = 1, --layers 3 --hiddens 10: the resident kernels'
# 2-CTA clusters in both directions) for LONG_MULTI_EPOCHS; and the
# kernels' grouped form, LONG_SETS weight sets from as many seeded inits
# trained as one fold-parallel program (`steps.batched_train_step`), each
# set held to its own CPU run, for LONG_GROUPED_EPOCHS with no StepLR
# boundary (at this learning rate two of the five inits need 27 and 33
# epochs to halve their loss; with a decay every 10 they do not in 30)
LONG_SUBJECTS, LONG_EPOCHS, LONG_DECAY, LONG_LR = 120, 100, 30, 1e-3
LONG_STREAMED_EPOCHS, LONG_STREAMED_DECAY = 30, 10
LONG_MULTI_EPOCHS, LONG_MULTI_DECAY = 30, 10
LONG_SETS, LONG_GROUPED_EPOCHS = 5, 40
LONG_GROUPED_DECAY = LONG_GROUPED_EPOCHS
# the CPU reference runs (fp32 and float64, each weight set its own) train
# in LONG_CPU_WORKERS processes of LONG_CPU_THREADS torch threads, started
# before phase 16, while phases 16-18 run the card from this one (one core
# of the card host's 8 left to it); the longest runs are submitted first
LONG_CPU_WORKERS, LONG_CPU_THREADS = 7, 1
MULTI_FIELDS = {"num_layers": 3, "hidden": 10, "feat_dim": 1,
                "is_multi_fusion": True,
                "hidden_linear": ModelConfig().hidden_linear}
# (what, problem: ROIs, ModelConfig overrides, epochs, StepLR step, weight
# sets: 1 trains through `train_port`, more through the grouped form)
LONG_RUNS = [("flagship L=2 H=16", 90, {}, LONG_EPOCHS, LONG_DECAY, 1),
             ("flagship --layers 3 --hiddens 128", 90,
              {"num_layers": 3, "hidden": 128}, LONG_STREAMED_EPOCHS,
              LONG_STREAMED_DECAY, 1),
             ("--isMultiFusion --layers 3 --hiddens 10 (N=270)", 270,
              MULTI_FIELDS, LONG_MULTI_EPOCHS, LONG_MULTI_DECAY, 1),
             (f"grouped form, {LONG_SETS} weight sets", 90, {},
              LONG_GROUPED_EPOCHS, LONG_GROUPED_DECAY, LONG_SETS)]


def window_rels(rels, decay_every):
    """The largest relative loss difference in the first
    `EARLY_WINDOW` epochs and in each StepLR window."""
    early = convergence_ab_torch.EARLY_WINDOW
    out = {f"epochs 0-{early - 1}": float(np.max(rels[:early]))}
    for start in range(0, len(rels), decay_every):
        end = min(start + decay_every, len(rels))
        out[f"epochs {start}-{end - 1}"] = float(np.max(rels[start:end]))
    return out


def repeated_runs(first, second, what):
    """Two card runs of the same training, held equal bit for bit: each
    weight set's per-epoch losses, held-out log-probabilities and every
    tensor of its final state_dict (params and running statistics).
    Returns the number of values compared."""
    n = 0
    for f, ((a, lp_a), (b, lp_b)) in enumerate(zip(first, second)):
        tag = f"{what}, set {f}" if len(first) > 1 else what
        n += assert_bit_equal(b.losses, a.losses,
                              f"{tag}: the second card run's losses")
        n += assert_bit_equal(lp_b, lp_a, f"{tag}: the second card run's "
                              "held-out log-probabilities")
        sa, sb = a.model.state_dict(), b.model.state_dict()
        for k in sa:
            n += assert_bit_equal(sb[k].cpu().numpy(), sa[k].cpu().numpy(),
                                  f"{tag}: the second card run's {k}")
    return n


def long_plan(pool, problem, what, overrides, epochs, decay_every, sets):
    """One long run's inputs (`sets` seeded weight sets, the schedule, the
    launches one step must make at this shape) with its CPU references
    submitted to `pool`: each set's fp32 and float64 CPU run
    (`convergence_ab_torch.cpu_reference`), float64 first."""
    ab = convergence_ab_torch
    fields = ab.model_fields("fused", problem.arrays["x"].shape[1],
                             **overrides)
    variables = [to_flax_variables(ab.new_port_model(
        "fused", problem, fields, torch.Generator().manual_seed(18 + f)))
        for f in range(sets)]
    sched = ab.Schedule(epochs=epochs, lr=LONG_LR, decay_every=decay_every)
    mcfg = ModelConfig(**fields)
    forms = streamed_forms(len(problem.train_idx), mcfg.rois,
                           (mcfg.feat_dim,) + (mcfg.hidden,) * mcfg.num_layers)
    refs = {dtype: [pool.submit(ab.cpu_reference, "fused", problem, v, sched,
                                fields, dtype, LONG_CPU_THREADS)
                    for v in variables]
            for dtype in (torch.float64, torch.float32)}
    return {"what": what, "problem": problem, "fields": fields,
            "variables": variables, "sched": sched, "mcfg": mcfg,
            "forms": forms, "sets": sets, "refs": refs,
            "per_step": split_counts(step_launches(
                STACK_CALLS["SGCN_GCN_IMGSNP"])[0], forms)}


def long_card(dev, plan):
    """The plan's training on the card, twice: the first run's launches
    against epochs x one train step's (2 forward, 2 backward, split over
    the forms this shape takes), and the second run bit-equal to the
    first. One weight set trains through `convergence_ab_torch.
    train_port`, more through the grouped form (`train_port_grouped`)."""
    ab = convergence_ab_torch
    what, problem, sched = plan["what"], plan["problem"], plan["sched"]

    def card_run():
        if plan["sets"] == 1:
            runs = [ab.train_port("fused", problem, plan["variables"][0], dev,
                                  sched, plan["fields"])]
        else:
            runs = ab.train_port_grouped("fused", problem, plan["variables"],
                                         dev, sched, plan["fields"])
        torch.cuda.synchronize()
        return runs

    t0 = time.perf_counter()
    reset_all()
    card = card_run()
    launches = all_counts()
    card_s = time.perf_counter() - t0
    want = {k: sched.epochs * v for k, v in plan["per_step"].items()}
    if launches != want:
        raise AssertionError(f"{what}: {sched.epochs} train steps launched "
                             f"{launches}; epochs x one step's is {want}")
    lp_card = [ab.predict_port(r, problem, dev) for r in card]
    repeated = repeated_runs(
        list(zip(card, lp_card)),
        [(r, ab.predict_port(r, problem, dev)) for r in card_run()], what)
    log(f"{what}: the second card run bit-equal to the first ({repeated} "
        "values: per-epoch losses, held-out log-probabilities, final "
        f"weights); launches {launches} (= {sched.epochs} x "
        f"{plan['per_step']}), {card_s:.3f} s (first run)")
    return {"losses": [r.losses for r in card], "log_probs": lp_card,
            "launches": launches, "card_s": card_s, "repeated": repeated}


def long_run(plan, card):
    """The card's runs against the CPU references of the plan (each
    weight set its own): `convergence_ab_torch.verdict`'s bounds, the CPU
    as the reference, and the same bounds with the float64 CPU run as the
    reference (the CPU's fp32 run parts from float64 further than the
    card's on this GO DAG: `scripts/fp32_drift_torch.py`); beside them how
    far each fp32 run departs from float64 (`against_exact`)."""
    what, sets, mcfg = plan["what"], plan["sets"], plan["mcfg"]
    decay_every = plan["sched"].decay_every
    results, cpu_s = [], 0.0
    for f in range(sets):
        tag = f"{what}, set {f}" if sets > 1 else what
        cpu = plan["refs"][torch.float32][f].result()
        exact = plan["refs"][torch.float64][f].result()
        cpu_s += cpu["seconds"]
        results.append(long_verdict(tag, card["losses"][f],
                                    card["log_probs"][f], cpu, exact,
                                    plan["problem"], decay_every))
    log(f"{what}: CPU {cpu_s:.3f} s (fp32, {sets} set(s), "
        f"{LONG_CPU_THREADS} threads each)")
    for tag, v in results:
        for reference, verdict in (("CPU", v), ("float64",
                                                v["card_against_float64"])):
            if not verdict["ok"]:
                raise AssertionError(f"{tag}: card against {reference} out "
                                     f"of bounds: {verdict}")
    forms = plan["forms"]
    out = {"epochs": plan["sched"].epochs, "decay_every": decay_every,
           "B": len(plan["problem"].train_idx), "N": mcfg.rois,
           "F0": mcfg.feat_dim, "sets": sets,
           "widths": [mcfg.hidden] * mcfg.num_layers,
           "forms": {"forward": "streamed" if forms[0] else "resident",
                     "backward": "streamed" if forms[1] else "resident"},
           "launches": card["launches"], "launches_per_step": plan["per_step"],
           "card_s": card["card_s"], "cpu_s": cpu_s,
           "repeat_values_bit_equal": card["repeated"]}
    if sets == 1:
        return {**out, **results[0][1]}
    return {**out, "per_set": {tag: v for tag, v in results},
            **{k: max(v[k] for _, v in results)
               for k in ("early_rel", "final_rel")},
            "acc_card": min(v["acc_card"] for _, v in results),
            "acc_cpu": min(v["acc_cpu"] for _, v in results),
            "near_ties": [t for _, v in results for t in v["near_ties"]],
            "worst_rel_per_window": {
                k: max(v["worst_rel_per_window"][k] for _, v in results)
                for k in results[0][1]["worst_rel_per_window"]},
            "against_float64": [v["against_float64"] for _, v in results],
            "card_against_float64": {
                k: max(v["card_against_float64"][k] for _, v in results)
                for k in ("early_rel", "final_rel")}}


def long_verdict(tag, card_losses, lp_card, cpu, exact, problem,
                 decay_every):
    """(tag, readings) of one weight set's card run against its CPU run
    and its float64 CPU run (`convergence_ab_torch.cpu_reference`'s) under
    `convergence_ab_torch.verdict`'s bounds, the loss checkpoints,
    near-ties and windows logged."""
    ab = convergence_ab_torch
    losses = {"cpu": cpu["losses"], "card": card_losses}
    log_probs = {"cpu": cpu["log_probs"], "card": lp_card}
    labels = ab.held_out_labels("fused", problem)
    verdict = ab.verdict("fused", losses, log_probs, labels)
    exact_verdict = ab.verdict(
        "fused", {"float64": exact["losses"], "card": card_losses},
        {"float64": exact["log_probs"], "card": lp_card}, labels)
    yardstick = ab.against_exact(
        {**losses, "float64": exact["losses"]},
        {**log_probs, "float64": exact["log_probs"]}, "float64",
        sorted({*verdict["disagreements"], *exact_verdict["disagreements"],
                *(t["subject"] for t in verdict["near_ties"]
                  + exact_verdict["near_ties"])}))
    rels = np.abs(card_losses - cpu["losses"]) / np.abs(cpu["losses"])
    windows = window_rels(rels, decay_every)
    for e, vc, vk, rel in ab.checkpoint_rows(losses):
        log(f"{tag} epoch {e}: loss cpu {vc:.6f} card {vk:.6f} rel "
            f"{rel:.2e}")
    for t in verdict["near_ties"]:
        log(f"{tag} near-tie: subject {t['subject']}, margin cpu "
            f"{t['margin_cpu']:.4f} (pred {t['pred_cpu']}), card "
            f"{t['margin_card']:.4f} (pred {t['pred_card']})")
    log(f"{tag}: worst rel per window {windows}; early "
        f"{verdict['early_rel']:.3e} (rtol {verdict['early_rtol']}), final "
        f"{verdict['final_rel']:.3e} (rel {verdict['final_rtol']}), acc card "
        f"{verdict['acc_card']} / cpu {verdict['acc_cpu']}, learned card "
        f"{verdict['learned_card']} / cpu {verdict['learned_cpu']}")
    log(f"{tag} against float64 on the CPU: early rel "
        f"{yardstick['early_rel']}, worst {yardstick['worst_rel']}, final "
        f"{yardstick['final_rel']}, log p1 - log p0 of the subjects in "
        f"question {yardstick['log_p1_minus_log_p0']}; the card under the "
        f"same bounds: early {exact_verdict['early_rel']:.3e}, final "
        f"{exact_verdict['final_rel']:.3e}, acc {exact_verdict['acc_card']} "
        f"/ float64 {exact_verdict['acc_float64']}, near-ties "
        f"{exact_verdict['near_ties']}")
    return tag, {"worst_rel_per_window": windows,
                 "against_float64": yardstick,
                 "card_against_float64": {k: exact_verdict[k] for k in (
                     "early_rel", "final_rel", "near_ties", "disagreements",
                     "ok")},
                 "losses_card": card_losses.tolist(),
                 "losses_cpu": cpu["losses"].tolist(), **verdict}


def start_long_references():
    """Phase 18's inputs, with every CPU reference run submitted to a pool
    of LONG_CPU_WORKERS spawned processes: started before phase 16, so that
    the references train while phases 16 and 17 run on the card. The
    caller shuts the pool down (`long["pool"]`)."""
    problems = {rois: convergence_ab_torch.port_problem(
        subjects=LONG_SUBJECTS, rois=rois, go_levels=REAL_GO_LEVELS,
        feat_dim=3 if rois == 90 else 1) for rois in (90, 270)}
    pool = concurrent.futures.ProcessPoolExecutor(
        LONG_CPU_WORKERS, mp_context=multiprocessing.get_context("spawn"))
    # the references of the longest runs first: epochs x width / 16
    order = sorted(LONG_RUNS, key=lambda r: -r[3] * max(
        1, r[2].get("hidden", 16) // 16))
    plans = {what: long_plan(pool, problems[rois], what, overrides, epochs,
                             decay, sets)
             for what, rois, overrides, epochs, decay, sets in order}
    return {"pool": pool, "problems": problems, "t0": time.perf_counter(),
            "plans": [plans[run[0]] for run in LONG_RUNS]}


def phase_long_runs(dev, long):
    log("== phase 18: long training runs, the card against the CPU and "
        "against itself")
    t0 = time.perf_counter()
    for rois, problem in long["problems"].items():
        log(f"long runs at {rois} ROIs: {LONG_SUBJECTS} planted-signal "
            f"subjects (train {len(problem.train_idx)}, held out "
            f"{len(problem.test_idx)}), GO topology n={problem.topo.n}")
    plans = long["plans"]
    cards = [long_card(dev, plan) for plan in plans]
    card_s = time.perf_counter() - t0
    runs = {plan["what"]: long_run(plan, card)
            for plan, card in zip(plans, cards)}
    long["pool"].shutdown()
    phase_s = time.perf_counter() - t0
    log(f"phase 18: the card's runs done at {card_s:.3f} s; the CPU "
        f"references in {LONG_CPU_WORKERS} processes of {LONG_CPU_THREADS} "
        f"threads, started {t0 - long['t0']:.3f} s before the phase")
    log(f"phase 18: {phase_s:.3f} s")
    return {"runs": runs, "phase_s": phase_s}


# ---------------------------------------------------------------------------
# phase 19: the card's results repeat run to run, in PyTorch's default mode

# the route phase 19 runs twice itself: the SNP-only GO network, 1 epoch
# (the others repeat a run of an earlier phase)
REPEAT_EPOCHS = 1
# the zoo names whose convolutions run on cuDNN, run twice (zoo_argv)
REPEAT_ZOO = ("CNN_Model", "SortPool")
REPEAT_SNPS_ARGV = ["--model", "Gene_ontology_network",
                    *snps_argv("_chip_smoke_repeat_snps", REPEAT_EPOCHS)]


def snapshot(res_dir):
    """{file: {key: array}} of every .npy, .npz (fold records, bundles) and
    .msgpack (checkpoints, as bytes) a run wrote into `res_dir`."""
    out = {}
    for path in sorted(glob.glob(os.path.join(res_dir, "*"))):
        name = os.path.basename(path)
        if name.endswith(".npy"):
            out[name] = {"": np.load(path)}
        elif name.endswith(".npz"):
            with np.load(path) as zf:
                out[name] = {k: zf[k] for k in zf.files}
        elif name.endswith(".msgpack"):
            with open(path, "rb") as fh:
                out[name] = {"": np.frombuffer(fh.read(), np.uint8)}
    if not out:
        raise AssertionError(f"{res_dir}: no artifacts to compare")
    return out


def same_snapshots(got, want, what):
    """The number of values in two runs' artifacts, which must be the same
    files holding the same arrays bit for bit."""
    if sorted(got) != sorted(want):
        raise AssertionError(f"{what}: files {sorted(got)} against "
                             f"{sorted(want)}")
    n = 0
    for name, arrays in want.items():
        if sorted(arrays) != sorted(got[name]):
            raise AssertionError(f"{what}: {name} holds {sorted(got[name])} "
                                 f"against {sorted(arrays)}")
        for k, v in arrays.items():
            n += assert_bit_equal(got[name][k], v,
                                  f"{what}: {name}{':' + k if k else ''}")
    return n


def same_printed(text, lines, result_line, what):
    """The run's printed per-epoch losses and `Result -` line equal to the
    first run's."""
    got = EPOCH_LINE.findall(text)
    if [list(g) for g in got] != [list(w) for w in lines]:
        raise AssertionError(f"{what}: epoch lines {got} against {lines}")
    again = re.search(r"^Result - .*$", text, re.M)
    if again is None or again.group(0) != result_line:
        raise AssertionError(f"{what}: {again and again.group(0)!r} against "
                             f"{result_line!r}")
    return 3 * len(lines)


def repeat_cli(argv, appendix, first=None):
    """A CLI route run again on the card (or twice, without `first`):
    the artifacts, printed epoch losses and `Result -` line of the run
    against those of the first. `first` = (snapshot, epoch lines, result
    line) of an earlier phase's run of the same argv."""
    res_dir = run_dir(appendix)
    if first is None:
        shutil.rmtree(res_dir, ignore_errors=True)
        text, _, _, _ = cli_run(argv)
        first = (snapshot(res_dir), EPOCH_LINE.findall(text),
                 re.search(r"^Result - .*$", text, re.M).group(0))
    files, lines, result_line = first
    text, _, wall_s, _ = cli_run(argv)
    n = same_snapshots(snapshot(res_dir), files, appendix)
    n += same_printed(text, lines, result_line, appendix)
    return n, wall_s


def served_twice(dev, path, data, dtype, snps_only):
    """The number of values in two served outputs of the bundle at `path`,
    each from a fresh load on the card, which must be bit-equal."""
    outs = []
    for _ in range(2):
        model = load_bundle(path, device=dev)
        if snps_only:
            outs.append(batched_forward_snps(model, data, batch_size=BATCH,
                                             dtype=dtype))
        else:
            outs.append(batched_forward(model, *data, batch_size=BATCH,
                                        dtype=dtype))
    if sorted(outs[0]) != sorted(outs[1]):
        raise AssertionError(f"{path}: outputs {sorted(outs[1])} against "
                             f"{sorted(outs[0])}")
    return sum(assert_bit_equal(outs[1][k], outs[0][k],
                                f"{os.path.relpath(path)} {dtype} {k}")
               for k in outs[0])


def phase_repeat(dev, artifacts, batched, long_runs, cohort):
    """Each route twice on the card in PyTorch's default mode, the two
    results compared bit for bit (any difference fails the phase with the
    first differing value): every bundle class served to the cohort at
    batch 256, fp32 and bf16; phase 18's full-batch flagship (its two card
    runs); the 2-epoch 5-fold flagship CLI, sequential and
    `--fold_parallel`, and `--fold_parallel --isMultiFusion`, 1 epoch
    (phase 15's runs, each run again); the SNP-only GO network, 1 epoch,
    twice; the zoo's cuDNN routes (`REPEAT_ZOO`), 1 epoch, twice."""
    log("== phase 19: results repeat run to run on the card")
    t0 = time.perf_counter()
    mode = assert_default_mode()
    log(f"default mode: {mode}")
    routes = {}

    def report(route, n, note=""):
        routes[route] = {"values_bit_equal": n, "note": note}
        log(f"{route}: {n} values compared, bit-equal{note}")

    multi = make_cohort(np.random.default_rng(4), COHORT, rois=270, feat=1)
    snps_dir = run_dir("_chip_smoke_snps")
    snps, _, _ = snps_inputs(snps_argv("_chip_smoke_snps"))
    bundles = {**{what: (row["bundle"], multi if "N=270" in what else cohort,
                         False)
                  for what, row in artifacts["serving"].items()},
               **{model: (os.path.join(
                   snps_dir, f"serving_bundle_snps_{kind}_fold_0.npz"),
                   snps, True) for model, kind in (
                       ("Gene_ontology_network", "go"), ("MLP_Model", "mlp"))}}
    for what, (path, data, snps_only) in bundles.items():
        for dtype in (None, torch.bfloat16):
            report(f"served {what}, {'bf16' if dtype else 'fp32'}, "
                   f"{COHORT} subjects at {BATCH}",
                   served_twice(dev, path, data, dtype, snps_only))

    flagship = long_runs["runs"]["flagship L=2 H=16"]
    report(f"full-batch flagship, {flagship['epochs']} epochs (phase 18)",
           flagship["repeat_values_bit_equal"], " (phase 18's two card runs)")

    fp, multi = batched["flagship"], batched["multi_fusion"]
    flagship_cli = f"CLI flagship, {FP_EPOCHS} epochs, {TRAIN_FOLDS} folds"
    for what, argv, appendix, lines, result_line in (
            (f"{flagship_cli}, sequential",
             cli_argv(FP_EPOCHS, "_chip_smoke_seq"), "_chip_smoke_seq",
             fp["sequential_epoch_lines"], fp["sequential_result_line"]),
            (f"{flagship_cli}, --fold_parallel",
             cli_argv(FP_EPOCHS, "_chip_smoke_fp", "--fold_parallel"),
             "_chip_smoke_fp", fp["epoch_lines"], fp["result_line"]),
            ("CLI --fold_parallel --isMultiFusion --layers 3 --hiddens 10, "
             "1 epoch", FP_MULTI_ARGV, "_chip_smoke_fp_multi",
             multi["epoch_lines"], multi["result_line"])):
        first = (snapshot(run_dir(appendix)), lines, result_line)
        n, wall_s = repeat_cli(argv, appendix, first)
        report(what, n, f" (phase 15's run against a {wall_s:.3f} s run "
               "now)")
    n, wall_s = repeat_cli(REPEAT_SNPS_ARGV, "_chip_smoke_repeat_snps")
    report(f"CLI --model Gene_ontology_network, {REPEAT_EPOCHS} epoch", n,
           f" (two runs; the second {wall_s:.3f} s)")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_repeat_") as cache:
        for zoo in REPEAT_ZOO:
            appendix = f"_chip_smoke_repeat_{zoo}"
            n, wall_s = repeat_cli(zoo_argv(zoo, appendix, cache), appendix)
            report(f"CLI --model {zoo} (cuDNN convolutions), {ZOO_EPOCHS} "
                   "epoch", n, f" (two runs; the second {wall_s:.3f} s)")
    assert_default_mode()
    phase_s = time.perf_counter() - t0
    log(f"phase 19: {phase_s:.3f} s")
    return {"default_mode": mode, "routes": routes, "phase_s": phase_s}


# ---------------------------------------------------------------------------
# phase 20: the device mesh, one process per position (`parallel/mesh.py`)

# phase 15's flagship (default widths, the 436-node GO DAG, 874 subjects,
# batch 32, 5 folds with val) at MESH_EPOCHS epochs, dropout on, through
# `cv.fold_parallel_runs` on gloo meshes of cuda:0 listed once per
# position, in one world of MESH_WORLD ranks: (what, (fold, data), seeds).
# One epoch: every rank of a gloo mesh on one card shares its time (a
# 2-epoch world took 113-197 s); the world starts before phase 18 and
# trains while phases 18-19 run
MESH_EPOCHS, MESH_WORLD, MESH_SEEDS = 1, 5, (1, 2)
MESH_CASES = [("fold=5 x data=1", (5, 1), 1), ("fold=1 x data=4", (1, 4), 1),
              (f"{len(MESH_SEEDS)} seeds x 5 folds, fold=2 x data=2", (2, 2),
               len(MESH_SEEDS))]
# every entry's per-epoch train, val and test loss sums against the
# one-device run's at the six-step pin. Past the first epoch an entry's
# sums may part further, as fp32 training parts from float64 (phase 18's
# bound there is 0.05): the data axis reorders the sums and training
# amplifies the rounding; in float64 the mesh and the one device agree
# (`scripts/mesh_drift_torch.py --cpu`)
MESH_RTOL = 2e-4
MESH_LOSS_RTOL, MESH_SCORE_RTOL, MESH_SCORE_ATOL = 1e-3, 1e-3, 2e-3
DP_LOSS_RTOL, DP_PARAM_ATOL, DP_RANKS = 1e-5, 1e-4, 4
MESH_SERVE_ATOL = {"fp32": 1e-4, "bf16": 2e-3}
MESH_SERVE_POSITIONS = 4


def mesh_setup(epochs=MESH_EPOCHS):
    """Phase 20's experiment at `epochs`: (cohort, topo, mcfg, tcfg, kind,
    {seeds: fold entries}), built through the CLI's helpers, as
    `cross_validation_seed_batch` builds its entries."""
    args = port_main.build_parser().parse_args(
        cli_argv(epochs, "_chip_smoke_mesh", "--fold_parallel"))
    kind = port_main.FUSION_MODELS[args.model]
    dcfg = port_main.build_dcfg(args)
    with contextlib.redirect_stdout(io.StringIO()):
        cohort, topo = port_main.load_cohort(args, dcfg,
                                             np.random.default_rng(args.seed))
    mcfg, tcfg = port_main.fused_cfgs(args, dcfg, args.layers, args.hiddens)
    full = cohort_batch_arrays(cohort)

    def entries(seeds):
        out = []
        for s in seeds:
            tc = dataclasses.replace(tcfg, seed=s)
            out += [{"p": prepare_fold(cohort, full, split, f, tc,
                                       tc.clinical_score_index),
                     "seed": s, "fold": f}
                    for f, split in enumerate(k_fold(cohort.y, tc.folds, s))]
        return out
    return (cohort, topo, mcfg, tcfg, kind,
            {1: entries([tcfg.seed]), len(MESH_SEEDS): entries(MESH_SEEDS)})


def state_digest(state):
    """A hash of a state_dict's names and bytes."""
    h = hashlib.sha256()
    for k, v in state.items():
        h.update(k.encode())
        h.update(v.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def mesh_summary(setup, runs, dev):
    """What phase 20 compares of a `fold_parallel_runs` result: each
    seed's CVResult (`cross_validation`'s post-processing of the trained
    entries), every entry's per-epoch loss sums, and digests of its
    per-epoch outputs, best weights and final weights."""
    cohort, topo, mcfg, tcfg, kind, _ = setup
    k = tcfg.folds
    seeds = sorted({r["seed"] for r in runs})
    results = [port_cv.cross_validation(
        cohort, topo, mcfg, dataclasses.replace(tcfg, seed=s),
        res_dir=None, verbose=False, model_kind=kind, device=dev,
        trained=runs[i * k:(i + 1) * k]) for i, s in enumerate(seeds)]
    sums = {(r["seed"], r["fold"]): np.stack([r["per_epoch"][key] for key in (
        "train_loss_sum", "val_loss_sum", "test_loss_sum")], axis=1)
        for r in runs}
    digests = {(r["seed"], r["fold"]): (
        hashlib.sha256(b"".join(np.ascontiguousarray(v).tobytes() for _, v in
                                sorted(r["per_epoch"].items()))).hexdigest(),
        state_digest(r["best"]["state"]),
        state_digest(r["model"].state_dict())) for r in runs}
    return {"results": results, "sums": sums, "digests": digests}


def mesh_entries_run(setup, seeds, dev, mesh):
    """`fold_parallel_runs` of the entries of `seeds` on `mesh` (None: this
    process alone), with this process's kernel launches and the sample
    counts the forward and backward plans were made for: (summary,
    launches, planned)."""
    cohort, topo, mcfg, tcfg, kind, entries = setup
    planned = {"forward": set(), "backward": set()}
    orig = gcn_stack.plan_launch, gcn_stack.plan_backward

    def spy_forward(b, *args, **kw):
        planned["forward"].add(int(b))
        return orig[0](b, *args, **kw)

    def spy_backward(b, *args, **kw):
        planned["backward"].add(int(b))
        return orig[1](b, *args, **kw)

    gcn_stack.plan_launch, gcn_stack.plan_backward = spy_forward, spy_backward
    try:
        reset_launches()
        runs = port_cv.fold_parallel_runs(entries[seeds], topo, mcfg, tcfg,
                                          kind, dev, mesh=mesh)
        torch.cuda.synchronize()
        launches = launch_counts()
    finally:
        gcn_stack.plan_launch, gcn_stack.plan_backward = orig
    return (mesh_summary(setup, runs, dev), launches,
            {k: sorted(v) for k, v in planned.items()})


def dp_step_run(setup, dev, mesh):
    """One train step of fold 0's flagship on its first train batch,
    unsharded or through `make_dp_train_step` on `mesh`, dropout on:
    (loss * sum(w), flax variables after)."""
    cohort, topo, mcfg, tcfg, kind, entries = setup
    p = entries[1][0]["p"]
    model, gen = init_fold_model(mcfg, topo, tcfg.seed, 0, dev, kind=kind)
    state = steps.TrainState(model, tcfg, p["train_data"]["y"].shape[0]
                             // tcfg.batch_size, kind)
    batch = {k: v[:tcfg.batch_size] for k, v in
             to_device(p["train_data"], dev).items()}
    step = (steps.train_step if mesh is None
            else meshlib.make_dp_train_step(steps.train_step, mesh))
    loss = float(step(state, batch, mcfg, tcfg, gen))
    return loss, to_flax_variables(model)


def mesh_rank(cases, dp_ranks):
    """Phase 20 on one rank of the world: each case of `cases` ((fold,
    data) shape, seeds) run twice, then the DP step on `dp_ranks`
    positions. Returns, on every rank, rank 0's summaries and every
    rank's launches and planned sample counts."""
    world = meshlib.world()
    dev = world.device
    setup = mesh_setup()
    out = []
    for shape, seeds in cases:
        n = shape[0] * shape[1]
        mesh = meshlib.Mesh(world.devices[:n], shape,
                            (meshlib.FOLD, meshlib.DATA))
        runs = []
        for _ in range(2):
            t0 = time.perf_counter()
            summary, launches, planned = mesh_entries_run(setup, seeds, dev,
                                                          mesh)
            wall = time.perf_counter() - t0
            per_rank = meshlib.gather_objects((launches, planned, wall))
            runs.append({"summary": summary if world.rank == 0 else None,
                         "per_rank": per_rank})
        out.append(runs)
    dp = None
    if dp_ranks:
        dp = dp_step_run(setup, dev, meshlib.make_mesh(dp_ranks,
                                                       world.devices))
    return out, dp


def compare_mesh(got, want, what):
    """A mesh run's summary against the one-device run's: every entry's
    per-epoch train, val and test loss sums within MESH_RTOL, each seed's
    mean test loss and score matrix within `tests/test_parallel.py`'s
    tolerances. Returns ((worst train rel, worst val / test rel), whether
    every entry is bit-equal)."""
    if sorted(got["sums"]) != sorted(want["sums"]):
        raise AssertionError(f"{what}: entries differ")
    worst = [0.0, 0.0]
    for key, w in want["sums"].items():
        rel = np.abs(got["sums"][key] - w) / np.abs(w)
        for i, cols in enumerate((slice(0, 1), slice(1, 3))):
            r = float(np.max(rel[:, cols], initial=0.0))
            if not r <= MESH_RTOL:
                raise AssertionError(
                    f"{what}: entry {key} per-epoch loss sums (train, val, "
                    f"test) {got['sums'][key]} against {w} (rel {r} > "
                    f"{MESH_RTOL})")
            worst[i] = max(worst[i], r)
    for g, w in zip(got["results"], want["results"]):
        if not np.isclose(g.mean_test_loss, w.mean_test_loss,
                          rtol=MESH_LOSS_RTOL, atol=0):
            raise AssertionError(f"{what}: mean test loss {g.mean_test_loss}"
                                 f" against {w.mean_test_loss}")
        if not np.allclose(g.score_result, w.score_result,
                           rtol=MESH_SCORE_RTOL, atol=MESH_SCORE_ATOL):
            raise AssertionError(f"{what}: score matrix {g.score_result} "
                                 f"against {w.score_result}")
    return tuple(worst), got["digests"] == want["digests"]


def same_mesh_runs(first, second, what):
    """Two mesh runs' summaries, which must be bit-equal: the digests of
    every entry's per-epoch outputs, best and final weights, the loss
    sums and each seed's score matrix. Returns the entries compared."""
    if first["digests"] != second["digests"]:
        bad = [k for k in first["digests"]
               if first["digests"][k] != second["digests"][k]]
        raise AssertionError(f"{what}: the second run differs in entries "
                             f"{bad}")
    for a, b in zip(first["results"], second["results"]):
        assert_bit_equal(b.score_result, a.score_result,
                         f"{what}: the second run's score matrix")
    for key, a in first["sums"].items():
        assert_bit_equal(second["sums"][key], a, f"{what}: entry {key}")
    return len(first["digests"])


def dp_compare(got, want, mcfg, lr):
    """The DP step against the single step: the loss within
    DP_LOSS_RTOL, every param and running statistic within DP_PARAM_ATOL
    but the two leaves whose true gradient is zero in train mode (the key
    slice of the attention's in-projection bias, the last decoder bias
    before the train-mode bn_b_d) and bn_b_d's running mean, which sees
    that bias: Adam's first step turns their float noise into steps of up
    to ~lr of either sign (`tests/test_torch_port_mesh.py` states the
    rule). Returns (loss rel, worst difference elsewhere)."""
    (lg, vg), (lw, vw) = got, want
    rel = abs(lg - lw) / abs(lw)
    if not rel <= DP_LOSS_RTOL:
        raise AssertionError(f"DP step loss {lg} against {lw}")
    fg, fw = ({"/".join(k): np.asarray(v) for k, v in flat_tree(t, ()).items()}
              for t in (vg, vw))
    if sorted(fg) != sorted(fw):
        raise AssertionError("DP step: the variables differ in names")
    walk = 2 * 1.02 * lr
    e = mcfg.jk_dim
    key = slice(e, 2 * e)
    name = "params/mha_in_proj_bias"
    bias = f"params/go_network/g_b_d_{mcfg.go_n_l - 1}/bias"
    stat = "batch_stats/go_network/bn_b_d/mean"
    if not np.abs(fg[name][key] - fw[name][key]).max() <= walk:
        raise AssertionError(f"DP step: {name} key slice beyond {walk}")
    fg[name] = fg[name].copy()
    fg[name][key] = fw[name][key]
    bias_walk = float(np.abs(fg[bias] - fw[bias]).max())
    conc_d = float(np.abs(fw["params/go_network/conc_d/kernel"]).sum())
    if not (bias_walk <= walk and np.abs(fg[stat] - fw[stat]).max()
            <= bias_walk * conc_d + DP_PARAM_ATOL):
        raise AssertionError(f"DP step: {bias} or {stat} beyond the walk")
    worst = 0.0
    for k, w in fw.items():
        if k in (bias, stat):
            continue
        diff = float(np.max(np.abs(fg[k] - w), initial=0.0))
        if not diff <= DP_PARAM_ATOL:
            raise AssertionError(f"DP step {k} differs by {diff}")
        worst = max(worst, diff)
    return rel, worst


def mesh_launches(mesh, kind):
    """{case: each rank's `kind` launches and the one-device run's} of
    phase 20's gloo meshes."""
    return {f"--fold_parallel, {what} (gloo, cuda:0 per position)": {
        "launches_per_rank": [row["launches"][kind] for row in case["ranks"]],
        "one_device_launches": case["one_device_launches"][kind]}
        for what, case in mesh["cases"].items()}


def start_mesh_world(dev):
    """Phase 20's gloo world of MESH_WORLD ranks on `dev` (`mesh_rank`:
    every case of MESH_CASES twice, then the DP step), started on a thread
    before phase 18 so that it trains while phases 18 and 19 run; phase
    20 joins it."""
    cases = [(shape, seeds) for _, shape, seeds in MESH_CASES]
    box = {"t0": time.perf_counter()}
    mesh = meshlib.make_mesh(devices=[dev] * MESH_WORLD)

    def run():
        try:
            box["out"] = meshlib.launch(mesh_rank, (cases, DP_RANKS), mesh,
                                        backend="gloo")
        except BaseException as e:     # re-raised by phase 20
            box["error"] = e
        box["s"] = time.perf_counter() - box["t0"]

    box["thread"] = threading.Thread(target=run, daemon=True)
    box["thread"].start()
    return box


def phase_mesh(dev, batched, model, cohort, world_box):
    log("== phase 20: the device mesh (--fold_parallel folds x samples, the "
        "data-parallel step, mesh serving), one process per position")
    t0 = time.perf_counter()
    count = torch.cuda.device_count()
    log(f"torch.cuda.device_count() = {count}")
    out = {"device_count": count}

    # (a) one card: the CLI spawns nothing (no world, no process started
    # from this thread; the phase's own world runs on another) and
    # repeats phase 19's run
    spawned = []
    orig = meshlib.launch, torch.multiprocessing.start_processes

    def spy(fn):
        def called(*a, **kw):
            if threading.current_thread() is threading.main_thread():
                spawned.append(fn.__name__)
            return fn(*a, **kw)
        return called

    meshlib.launch = spy(orig[0])
    torch.multiprocessing.start_processes = spy(orig[1])
    try:
        fp = batched["flagship"]
        first = (snapshot(run_dir("_chip_smoke_fp")), fp["epoch_lines"],
                 fp["result_line"])
        n, wall_s = repeat_cli(cli_argv(FP_EPOCHS, "_chip_smoke_fp",
                                        "--fold_parallel"), "_chip_smoke_fp",
                               first)
    finally:
        meshlib.launch, torch.multiprocessing.start_processes = orig
    if count == 1 and spawned:
        raise AssertionError(f"one card: the CLI spawned ({spawned})")
    log(f"(a) one card: --fold_parallel made {len(spawned)} calls that "
        f"spawn; {n} values bit-equal to phase 19's run ({wall_s:.3f} s)")
    out["one_card"] = {"spawned": len(spawned), "values_bit_equal": n,
                       "wall_s": wall_s}

    # (b), (c), (e): the one-device references, then the world's results
    setup = mesh_setup()
    refs = {}
    for seeds in sorted({s for _, _, s in MESH_CASES}):
        t1 = time.perf_counter()
        refs[seeds] = mesh_entries_run(setup, seeds, dev, None)
        log(f"one-device reference, {seeds} seed(s) x 5 folds: "
            f"{time.perf_counter() - t1:.3f} s, launches {refs[seeds][1]}")
    dp_single = dp_step_run(setup, dev, None)
    world_box["thread"].join(timeout=900)
    if "error" in world_box:
        raise world_box["error"]
    if "out" not in world_box:
        raise AssertionError("the gloo world did not finish")
    world_s = world_box["s"]
    mesh_out, dp = world_box["out"]
    tcfg, entries = setup[3], setup[5]
    out["cases"] = {}
    for (what, shape, seeds), runs in zip(MESH_CASES, mesh_out):
        ref, ref_launches, ref_planned = refs[seeds]
        first, second = runs[0]["summary"], runs[1]["summary"]
        worst, same = compare_mesh(first, ref, what)
        n_entries = same_mesh_runs(first, second, what)
        fold_only = shape[1] == 1
        log(f"(b) {what}, {MESH_EPOCHS} epoch(s): the loss sums within "
            f"{worst[0]:.3e} (train) and {worst[1]:.3e} (val and test) of "
            f"the one-device run (rtol {MESH_RTOL}); mean test loss "
            + ", ".join(f"{g.mean_test_loss:.6f} vs {w.mean_test_loss:.6f}"
                        for g, w in zip(first["results"], ref["results"]))
            + f"; {'fold-only mesh: ' if fold_only else ''}every entry "
            f"{'bit-equal' if same else 'not bit-equal'} to the one-device "
            f"run; the second run bit-equal to the first ({n_entries} "
            "entries: per-epoch outputs, best and final weights)")
        # (e) each rank's launches: what the one-device run launched (every
        # position steps through every batch), none on an idle rank; its
        # plans made for its own fold row's samples of each batch
        n = shape[0] * shape[1]
        b_local = tcfg.batch_size // shape[1]
        per_row = len(entries[seeds]) // shape[0]
        rank_rows = []
        for rank, (launches, planned, wall) in enumerate(
                runs[0]["per_rank"]):
            want = ref_launches if rank < n else {"forward": 0,
                                                   "backward": 0}
            if launches != want:
                raise AssertionError(f"{what}: rank {rank} launched "
                                     f"{launches}, the shapes imply {want}")
            if rank < n and (planned["backward"] != [per_row * b_local]
                             or per_row * b_local not in planned["forward"]):
                raise AssertionError(f"{what}: rank {rank} planned "
                                     f"{planned} for {per_row} x {b_local}")
            rank_rows.append({"launches": launches, "planned": planned,
                              "wall_s": wall})
        log(f"(e) {what}: launches per rank "
            + "; ".join(f"{r}: {row['launches']} (planned samples "
                        f"{row['planned']}, {row['wall_s']:.3f} s)"
                        for r, row in enumerate(rank_rows))
            + f"; the one-device run {ref_launches}, planned {ref_planned}")
        out["cases"][what] = {
            "shape": list(shape), "seeds": seeds,
            "epoch_max_rel_diff": {"train": worst[0], "eval": worst[1]},
            "bit_equal_to_one_device": same,
            "repeat_entries_bit_equal": n_entries,
            "mean_test_loss": [r.mean_test_loss for r in first["results"]],
            "one_device_mean_test_loss": [r.mean_test_loss
                                          for r in ref["results"]],
            "ranks": rank_rows, "one_device_launches": ref_launches}
    rel, worst = dp_compare(dp, dp_single, setup[2], tcfg.lr)
    log(f"(c) make_dp_train_step on {DP_RANKS} ranks against the single "
        f"step: loss rel {rel:.3e} (rtol {DP_LOSS_RTOL}), params within "
        f"{worst:.3e} (atol {DP_PARAM_ATOL})")
    out["dp_step"] = {"ranks": DP_RANKS, "loss_rel": rel, "param_max": worst}
    log(f"the gloo world of {MESH_WORLD} ranks on {dev}: {world_s:.3f} s "
        f"(started {t0 - world_box['t0']:.3f} s before the phase)")
    out["world_s"] = world_s

    # (d) mesh serving: the cohort's batches split over 4 positions of
    # cuda:0, against serving on the card alone
    smesh = meshlib.make_mesh(devices=[dev] * MESH_SERVE_POSITIONS)
    out["serving"] = {}
    for name, dtype in (("fp32", None), ("bf16", torch.bfloat16)):
        one = batched_forward(model, *cohort, batch_size=BATCH, dtype=dtype)
        par = batched_forward(model, *cohort, batch_size=BATCH, dtype=dtype,
                              mesh=smesh)
        err = max(float(np.abs(par[k] - one[k]).max()) for k in one
                  if k != "pred")
        if sorted(par) != sorted(one) or not err <= MESH_SERVE_ATOL[name]:
            raise AssertionError(f"(d) mesh serving {name}: {err}")
        agree = float(np.mean(par["pred"] == one["pred"]))
        log(f"(d) mesh serving {name}, {COHORT} subjects at {BATCH} over "
            f"{MESH_SERVE_POSITIONS} positions: max abs diff {err:.3e} "
            f"(atol {MESH_SERVE_ATOL[name]}), pred agreement {agree:.4f}")
        out["serving"][name] = {"max_abs_diff": err, "agreement": agree}

    # (f) NCCL across cards
    if count >= 2:
        n = min(4, count)
        cards = meshlib.make_mesh(n)
        t1 = time.perf_counter()
        (runs,), _ = meshlib.launch(mesh_rank, ([((1, n), 1)], 0), cards)
        worst, _ = compare_mesh(runs[0]["summary"], refs[1][0],
                                f"NCCL fold=1 x data={n}")
        same_mesh_runs(runs[0]["summary"], runs[1]["summary"], "NCCL")
        log(f"(f) NCCL, fold=1 x data={n} on {n} cards: within "
            f"{worst[0]:.3e} / {worst[1]:.3e} (train / eval) of the "
            f"one-device run, repeats bit-equal "
            f"({time.perf_counter() - t1:.3f} s)")
        out["nccl"] = {"cards": n, "epoch_max_rel_diff": list(worst)}
    else:
        log("(f) NCCL: no second card on this host; the NCCL mesh did not "
            "run")
        out["nccl"] = None
    out["phase_s"] = time.perf_counter() - t0
    log(f"phase 20: {out['phase_s']:.3f} s")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script drives the "
              "port on an NVIDIA GPU", file=sys.stderr)
        return 1
    assert_default_mode()
    dev = torch.device("cuda", 0)
    card, build_s = phase_build()
    max_err, train_grad_err, grouped_err = phase_kernel_vs_plain(dev)
    backward_err, backward_calls = phase_backward_vs_plain(dev)
    cohort = make_cohort(np.random.default_rng(1), COHORT)
    model, served, launches = phase_serve(dev, cohort)
    http_times = phase_http(dev, model, cohort, served)
    times = phase_times(dev, torch.cuda.get_device_name(0), model, cohort)
    backward_times = phase_backward_times(dev, torch.cuda.get_device_name(0))
    train = training_setup(dev)
    train_times = phase_train_times(dev, train)
    profile = phase_profile(dev, model, cohort, train)
    training = phase_train(dev, train)
    multi = phase_multi_fusion(dev)
    families = phase_families(dev)
    artifacts = phase_artifacts(dev, train, cohort)
    snps = phase_snps(dev)
    long = world = None
    try:
        with tempfile.TemporaryDirectory(prefix="chip_smoke_real_") as root:
            layout = real_layout(root)
            real, real_ctx = phase_real_cohort(dev, layout)
            other = phase_other_routes(dev, layout, real_ctx)
            zoo = phase_zoo(dev)
            batched = phase_fold_parallel(dev, train)
            long = start_long_references()
            bf16 = phase_bf16(dev, torch.cuda.get_device_name(0), model,
                              served, cohort, artifacts, layout)
            streamed = phase_streamed(dev, torch.cuda.get_device_name(0))
        world = start_mesh_world(dev)
        long_runs = phase_long_runs(dev, long)
        repeat = phase_repeat(dev, artifacts, batched, long_runs, cohort)
        mesh = phase_mesh(dev, batched, model, cohort, world)
    finally:
        # the CPU references and the world's ranks end before the script
        # does, whatever failed
        if long is not None:
            long["pool"].shutdown(cancel_futures=True)
        if world is not None:
            world["thread"].join(timeout=900)

    serving, *others = times["shapes"]
    fp_row = times["grouped"][0]
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
            "launches_per_train_step", profile["train_step_launches"]),
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
            "launches_per_train_step": profile["train_step_launches"],
            "launches_per_eval_batch": profile["eval_batch_launches"],
            "launches_run": training["launches"],
            "expected_launches_run": training["expected_launches"],
            "step_device_ms": train_times["step_device_ms"],
            "step_span_ms": train_times["step_span_ms"],
            "step_wall_ms": train_times["step_wall_ms"],
            "fwd_kernel_b32_ms": train_times["fwd_kernel_b32_ms"],
            "bwd_kernel_b32_ms": backward_times[0]["kernel_ms"],
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
            "bound_ms", "bound_by")} for row in others]}, {
        # the same kernel's grouped form: the fold-parallel trainer's one
        # launch per pass for all folds, each with its own weights
        "name": "gcn_stack_grouped", "route": "cuda",
        "source": "iggcn_tpu_torch/csrc/gcn_stack.cu",
        "replaces": "iggcn_tpu/ops/pallas_gcn.py:83",
        "launches": batched["flagship"]["launches"]["forward"],
        "max_abs_err": grouped_err,
        "ms": fp_row["kernel_ms"], "cold_ms": fp_row["kernel_cold_ms"],
        "plain_ms": fp_row["plain_ms"], "bound_ms": fp_row["bound_ms"],
        "bound_by": fp_row["bound_by"], "library_ms": fp_row["library_ms"],
        "routes": {what: {"launches_run": run["launches"],
                          "expected_launches_run": run["expected_launches"]}
                   for what, run in (
                       ("SGCN_GCN_IMGSNP --fold_parallel",
                        batched["flagship"]),
                       ("SGCN_GCN_IMGSNP --fold_parallel --isMultiFusion",
                        batched["multi_fusion"]),
                       ("--cv_seeds " + FP_SEEDS, batched["cv_seeds"]),
                       ("--permut_seeds " + FP_SEEDS,
                        batched["permut_seeds"]))},
        # phase 20: each rank of a gloo mesh on cuda:0, its forward
        # launches over the run against the one-device run's
        "mesh": mesh_launches(mesh, "forward"),
        "shapes": [{k: row[k] for k in (
            "shape", "F", "B", "N", "F0", "widths", "kernel_ms",
            "kernel_cold_ms", "plain_ms", "plain_cold_ms", "library_ms",
            "library_cold_ms", "bound_ms", "bound_by")}
            for row in times["grouped"]]}, {
        # the backward (the JAX VJP's `_bwd`, a recompute and its
        # gradients; no pallas_call): one launch per backward call of the
        # fp32 forms, shared-weight and grouped; `launches` over phase 7's
        # flagship run
        "name": "gcn_stack_backward", "route": "cuda",
        "source": "iggcn_tpu_torch/csrc/gcn_stack_backward.cu",
        "replaces": "iggcn_tpu/ops/pallas_gcn.py:116",
        "launches": training["launches"]["backward"],
        "max_abs_err": backward_err, "checked_calls": backward_calls,
        "ms": backward_times[0]["kernel_ms"],
        "cold_ms": backward_times[0]["kernel_cold_ms"],
        "plain_ms": backward_times[0]["plain_ms"],
        "bound_ms": backward_times[0]["bound_ms"],
        "bound_by": backward_times[0]["bound_by"],
        "library_ms": backward_times[0]["library_ms"],
        "launches_per_train_step": {
            name: r["launches_per_train_step"]["backward"]
            for name, r in per_route.items()},
        "routes": {
            **{name: {"launches_run": r["launches_run"]["backward"],
                      "expected_launches_run":
                          r["expected_launches_run"]["backward"]}
               for name, r in per_route.items()},
            **{what: {"launches_run": run["launches"]["backward"],
                      "expected_launches_run":
                          run["expected_launches"]["backward"]}
               for what, run in (
                   ("SGCN_GCN_IMGSNP --fold_parallel", batched["flagship"]),
                   ("--cv_seeds " + FP_SEEDS, batched["cv_seeds"]))}},
        "mesh": mesh_launches(mesh, "backward"),
        "shapes": [{k: row[k] for k in (
            "shape", "F", "B", "N", "F0", "widths", "cluster", "kernel_ms",
            "kernel_cold_ms", "plain_ms", "plain_cold_ms", "library_ms",
            "library_cold_ms", "bound_ms", "bound_by")}
            for row in backward_times]}, {
        # the bf16-operand form: bf16 serving's one launch per forward
        "name": "gcn_stack_bf16", "route": "cuda",
        "source": "iggcn_tpu_torch/csrc/gcn_stack_bf16.cu",
        "replaces": "iggcn_tpu/ops/pallas_gcn.py:83",
        "launches": bf16["serving"]["launches"],
        "max_abs_err": bf16["max_abs_err"],
        "ms": bf16["times"][0]["kernel_ms"],
        "cold_ms": bf16["times"][0]["kernel_cold_ms"],
        "plain_ms": bf16["times"][0]["plain_ms"],
        "bound_ms": bf16["times"][0]["bound_ms"],
        "bound_by": bf16["times"][0]["bound_by"],
        "library_ms": bf16["times"][0]["library_ms"],
        "fp32_ms": bf16["times"][0]["fp32_ms"],
        "served_bundles": {what: {k: row[k] for k in (
            "model_class", "launches", "launches_per_forward")}
            for what, row in bf16["serving"]["bundles"].items()},
        "shapes": [{k: row[k] for k in (
            "shape", "B", "N", "F0", "widths", "kernel_ms", "kernel_cold_ms",
            "fp32_ms", "plain_ms", "plain_cold_ms", "library_ms",
            "library_cold_ms", "bound_ms", "bound_by", "plan")}
            for row in bf16["times"]]}, {
        # the streamed form: every shape the three kernels above cannot
        # hold, forward (fp32, grouped, bf16) and backward; `launches`
        # over phase 17's flagship run at --layers 3 --hiddens 128, where
        # both directions stream
        "name": "gcn_stack_streamed", "route": "cuda",
        "source": "iggcn_tpu_torch/csrc/gcn_stack_streamed.cu",
        "replaces": "iggcn_tpu/ops/pallas_gcn.py:83",
        "launches": streamed["routes"][
            "SGCN_GCN_IMGSNP --layers 3 --hiddens 128"]["launches"][
            "streamed"],
        "max_abs_err": max(streamed["max_abs_err"].values()),
        "max_abs_err_by_form": streamed["max_abs_err"],
        "ms": streamed["times"][0]["kernel_ms"],
        "cold_ms": streamed["times"][0]["kernel_cold_ms"],
        "plain_ms": streamed["times"][0]["plain_ms"],
        "bound_ms": streamed["times"][0]["bound_ms"],
        "bound_by": streamed["times"][0]["bound_by"],
        "library_ms": streamed["times"][0]["library_ms"],
        "routes": {name: {k: run[k] for k in (
            "launches", "expected_launches", "launches_per_train_step",
            "launches_per_eval_batch")}
            for name, run in streamed["routes"].items()},
        "shapes": [{k: row[k] for k in (
            "shape", "direction", "B", "N", "F0", "widths", "form",
            "kernel_ms", "kernel_cold_ms", "plain_ms", "plain_cold_ms",
            "library_ms", "library_cold_ms", "bound_ms", "bound_by")}
            for row in streamed["times"]]}]}
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
                        "values_bit_equal":
                            artifacts["resume"]["values_bit_equal"]},
             "zoo": {"phase_s": zoo["phase_s"], **{model: {
                 k: run[k] for k in (
                     "experiment_wall_s", "throughput_graphs_per_s",
                     "result_line", "launches", "expected_launches",
                     "graphs", "nodes")}
                 for model, run in zoo["models"].items()}},
             "fold_parallel": {
                 "experiment_wall_s":
                     batched["flagship"]["experiment_wall_s"],
                 "sequential_wall_s":
                     batched["flagship"]["sequential_wall_s"],
                 "epochs": FP_EPOCHS,
                 "steps_loss_max_rel_diff":
                     batched["steps"]["loss_max_rel_diff"],
                 "step_wall_ms": batched["steps"]["step_wall_ms"],
                 "step_device_ms": batched["steps"]["step_device_ms"],
                 "step_idle_share":
                     batched["steps"]["profiled_step"]["idle_share"],
                 "cv_seeds_wall_s": batched["cv_seeds"]["experiment_wall_s"],
                 "permut_seeds_wall_s":
                     batched["permut_seeds"]["experiment_wall_s"],
                 "p_value": batched["permut_seeds"]["p_value"]},
             "bf16": {
                 "cohort_wall_s": bf16["serving"]["cohort_wall_s"],
                 "fp32_cohort_wall_s": bf16["serving"]["fp32_cohort_wall_s"],
                 "card_vs_cpu_max_abs_diff":
                     bf16["serving"]["card_vs_cpu_max_abs_diff"],
                 "fp32_agreement": bf16["serving"]["fp32_agreement"]},
             "tools": {"doctor_exit": bf16["tools"]["doctor_exit"],
                       "diffusion_walls_s":
                           bf16["tools"]["diffusion"]["walls_s"],
                       "profile_dir_files":
                           bf16["tools"]["profile_dir"]["files"]},
             "streamed": {name: {
                 "experiment_wall_s": run["experiment_wall_s"],
                 "result_line": run["result_line"],
                 "card_vs_cpu_loss_max_rel_diff":
                     run["card_vs_cpu"]["loss_max_rel_diff"]}
                 for name, run in streamed["routes"].items()},
             "long_runs": {what: {k: run[k] for k in (
                 "epochs", "launches", "early_rel", "final_rel", "acc_card",
                 "acc_cpu", "near_ties", "worst_rel_per_window",
                 "against_float64", "card_against_float64", "card_s",
                 "cpu_s", "repeat_values_bit_equal")}
                 for what, run in long_runs["runs"].items()},
             "repeat": {route: row["values_bit_equal"]
                        for route, row in repeat["routes"].items()},
             "mesh": {"device_count": mesh["device_count"],
                      "one_card": mesh["one_card"],
                      "world_s": mesh["world_s"],
                      "cases": {what: {k: case[k] for k in (
                          "shape", "epoch_max_rel_diff",
                          "bit_equal_to_one_device",
                          "repeat_entries_bit_equal", "mean_test_loss",
                          "one_device_mean_test_loss")}
                          for what, case in mesh["cases"].items()},
                      "dp_step": mesh["dp_step"],
                      "serving": mesh["serving"], "nccl": mesh["nccl"]},
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
                   "times": times, "backward_times": backward_times,
                   "train_times": train_times,
                   "profile": profile, "training": training,
                   "multi_fusion": multi, "families": families,
                   "artifacts": artifacts, "snps_only": snps,
                   "real_cohort": real, "other_routes": other, "zoo": zoo,
                   "batched": batched, "bf16": bf16, "streamed": streamed,
                   "long_runs": long_runs, "repeat": repeat, "mesh": mesh,
                   "script_s": time.perf_counter() - START,
                   "device": device}, fh, indent=1,
                  default=float)
    script_s = time.perf_counter() - START
    log(f"chip_smoke: {script_s:.3f} s")
    log(card)
    log(json.dumps(serve))
    log(json.dumps(kernels))
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
