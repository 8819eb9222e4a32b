"""Generate ``docs/cli_torch.md``, the port's command-line reference, from
its argparse parsers (port of `iggcn_tpu/tools/gen_docs.py`, which renders
the JAX package's `docs/cli.md`).

Every entry point of the port exposes a ``build_parser()``; this tool
renders them all to one markdown reference, and ``--check`` exits 1 when
the committed file differs from what the parsers give, so a flag cannot
change without its documentation.

Usage:
  python -m iggcn_tpu_torch.tools.gen_docs          # rewrite docs/cli_torch.md
  python -m iggcn_tpu_torch.tools.gen_docs --check  # exit 1 if it is stale
"""
from __future__ import annotations

import argparse
import os
import sys
from typing import List

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DOC_PATH = os.path.join(REPO_ROOT, "docs", "cli_torch.md")

HEADER = """\
# Command-line reference of the PyTorch port (`iggcn_tpu_torch`)

<!-- GENERATED FILE — do not edit by hand.
     Regenerate with: python -m iggcn_tpu_torch.tools.gen_docs
     tests/test_torch_port_tools.py fails the suite when this file is stale. -->

Every entry point runs on the CUDA card unless `--device cpu` asks for the
host (the plain PyTorch path); the hand-written kernels build from
`iggcn_tpu_torch/csrc/` at first use. Flag names, defaults and help strings
below are rendered from the argparse parsers themselves. The JAX package's
reference is `docs/cli.md`.
"""


def _flag_cell(action: argparse.Action) -> str:
    if not action.option_strings:          # positional
        return f"`{action.dest}`"
    return " / ".join(f"`{s}`" for s in action.option_strings)


def _type_cell(action: argparse.Action) -> str:
    if isinstance(action, argparse.BooleanOptionalAction):
        return "bool"
    if isinstance(action, (argparse._StoreTrueAction,
                           argparse._StoreFalseAction)):
        return "flag"
    if action.choices:
        return " \\| ".join(str(c) for c in action.choices)
    if action.type is int:
        return "int"
    if action.type is float:
        return "float"
    return "str"


def _default_cell(action: argparse.Action) -> str:
    if isinstance(action, argparse._StoreTrueAction):
        return "off"
    if isinstance(action, argparse._StoreFalseAction):
        return "on"
    if isinstance(action, argparse.BooleanOptionalAction):
        return "on" if action.default else "off"
    if not action.option_strings:
        return "(required)"
    if action.default is None:
        return "—"
    if action.default == "":
        return '`""`'
    return f"`{action.default}`"


def _escape(text: str) -> str:
    return text.replace("|", "\\|").replace("\n", " ")


def render_parser(parser: argparse.ArgumentParser) -> str:
    rows = ["| flag | type | default | description |",
            "|---|---|---|---|"]
    for action in parser._actions:
        if isinstance(action, argparse._HelpAction):
            continue
        rows.append(
            f"| {_flag_cell(action)} | {_type_cell(action)} "
            f"| {_default_cell(action)} | {_escape(action.help or '')} |")
    return "\n".join(rows)


# the stack shapes `render_stack_forms` tabulates: (N, what gives it),
# depths and widths
STACK_NODES = ((90, "the ADNI ROIs"), (270, "`--isMultiFusion`"),
               (620, "a zoo graph padded to PROTEINS' largest"))
STACK_DEPTHS = (1, 2, 3, 4, 8, 9)
STACK_WIDTHS = (5, 16, 32, 64, 128)


def render_stack_forms() -> str:
    """Which design of the GCN-stack kernels each `--layers` x `--hiddens`
    takes on the card, from the launch plans themselves (`plan_launch`,
    `plan_backward` at the training batch of 32)."""
    from iggcn_tpu_torch.ops import gcn_stack

    def form(plan):
        return "S" if isinstance(plan, gcn_stack.StreamedPlan) else "R"

    rows = ["| N | `--layers` | " + " | ".join(
        f"H={h}" for h in STACK_WIDTHS) + " |",
        "|---|---|" + "---|" * len(STACK_WIDTHS)]
    for n, what in STACK_NODES:
        f0 = 1 if n == 270 else 3
        for layers in STACK_DEPTHS:
            cells = []
            for h in STACK_WIDTHS:
                dims = (f0,) + (h,) * layers
                cells.append(form(gcn_stack.plan_launch(32, n, dims)) + "/"
                             + form(gcn_stack.plan_backward(32, n, dims)))
            rows.append(f"| {n} ({what}) | {layers} | " + " | ".join(cells)
                        + " |")
    return "\n".join(rows)


# the entries and device counts `render_mesh_table` tabulates
MESH_ENTRIES = ((3, "3 folds"), (4, "4 folds"), (5, "5 folds"),
                (10, "`--cv_seeds 1:2` x 5 folds"),
                (15, "`--permut_seeds 1:3` x 5 folds"))
MESH_DEVICES = (1, 2, 4, 8)


def render_mesh_table() -> str:
    """The (fold, data) mesh `fold_mesh` gives each number of fold
    entries on each number of visible cards, and a rank's share of a
    32-sample batch."""
    import torch

    from iggcn_tpu_torch.parallel.mesh import fold_mesh
    rows = ["| entries | " + " | ".join(
        f"{n} GPU{'s' if n > 1 else ''}" for n in MESH_DEVICES) + " |",
        "|---|" + "---|" * len(MESH_DEVICES)]
    for k, what in MESH_ENTRIES:
        cells = []
        for n in MESH_DEVICES:
            m = fold_mesh(k, [torch.device("cpu", i) for i in range(n)])
            f, d = m.shape
            cells.append(f"{f} x {d}: {k // f} x {32 // d}"
                         + (f" ({n - m.size} idle)" if m.size < n else ""))
        rows.append(f"| {what} | " + " | ".join(cells) + " |")
    return "\n".join(rows)


def render_cli_md() -> str:
    from iggcn_tpu_torch import main as main_mod
    from iggcn_tpu_torch.tools import (doctor, explain, export_cohort,
                                       import_torch, profile_step, report,
                                       serve)

    parts: List[str] = [HEADER]
    parts.append("## `python -m iggcn_tpu_torch.main` — the experiment CLI\n")
    parts.append(
        "Cross-validated training for every model family. `--model` "
        "routes to the matching trainer (unknown names abort with the "
        "full list):\n")
    parts.append("| family | `--model` names | trainer |")
    parts.append("|---|---|---|")
    fusion = ", ".join(f"`{m}`" for m in main_mod.FUSION_MODELS)
    zoo = ", ".join(f"`{m}`" for m in main_mod.ZOO_MODELS)
    snp = ", ".join(f"`{m}`" for m in main_mod.SNP_MODELS)
    parts.append(f"| fused imaging-genetics + image-only SGCN | {fusion} "
                 "| `train/cv.py` (sequential or `--fold_parallel`) |")
    parts.append(f"| baseline / pooling / nested zoo | {zoo} "
                 "| `train/generic_cv.py` |")
    parts.append(f"| SNP-only | {snp} | `train/snps_trainer.py` |")
    parts.append("")
    parts.append(render_parser(main_mod.build_parser()))
    parts.append("")
    parts.append("### GCN-stack shapes on the card\n")
    parts.append(
        "Every `--layers` / `--hiddens` runs on the card. The imaging GCN "
        "stack (`ops/gcn_stack.py:fused_gcn_stack`, in the fused families "
        "and the zoo's `GCN`) takes one of two designs per shape, chosen "
        "apart for its forward and its backward. Resident (R): "
        "`csrc/gcn_stack.cu`, `gcn_stack_bf16.cu` and "
        "`gcn_stack_backward.cu` hold a sample's P and operands in shared "
        "memory (232,448 bytes a CTA, a cluster of up to 8 CTAs, up to 8 "
        "layers); both search grids and the default widths are resident. "
        "Streamed (S): every other shape, any depth, "
        "`csrc/gcn_stack_streamed.cu`, which streams P through shared "
        "memory once per layer. Forward/backward at a batch of 32 (N=270 "
        "with F0=1, else F0=3):\n")
    parts.append(render_stack_forms())
    parts.append("")
    parts.append("### `--fold_parallel` on several GPUs\n")
    parts.append(
        "A `--fold_parallel` run of a fused family takes every visible "
        "card, as the JAX package's does every visible device: "
        "`parallel/mesh.py:fold_mesh` gives the fold entries (the folds, "
        "or a batched program's seeds x folds) a fold axis of the largest "
        "divisor of their count that fits the cards, and the cards left "
        "over a data axis that shards each batch's samples; when the "
        "count does not divide the cards the rest idle. One process runs "
        "each position (NCCL; the kernels are built once before they "
        "start), each with its fold row's entries on its slice of every "
        "train and eval batch; batch norms, losses and gradients are "
        "summed over the data axis, so each fold trains as it would on "
        "one card, and rank 0 alone prints and writes. With one card "
        "nothing spawns. Cells: fold x data, then a rank's entries x "
        "samples of a 32-sample batch:\n")
    parts.append(render_mesh_table())

    for title, blurb, mod in (
        ("## `python -m iggcn_tpu_torch.tools.doctor`",
         "Pre-flight validation of real data layouts (files, mat keys, "
         "shapes, cross-file agreement, GO parseability, a raw TU "
         "dataset). Host-side only. Exit 0 = all checks pass.",
         doctor),
        ("## `python -m iggcn_tpu_torch.tools.serve`",
         "Score a cohort npz against a serving bundle (one-shot), or run a "
         "long-lived HTTP daemon (`GET /health`, `GET /stats`, "
         "`POST /predict`); `--bf16` serves in bfloat16.",
         serve),
        ("## `python -m iggcn_tpu_torch.tools.explain`",
         "Export learned ROI/edge/SNP importances (and grad-CAM saliency "
         "for the SGCN image family) from a checkpoint or serving bundle; "
         "`--plot` renders their figures (needs matplotlib).",
         explain),
        ("## `python -m iggcn_tpu_torch.tools.profile_step`",
         "Trace N flagship train steps at the real GO scale with "
         "`torch.profiler` and print the per-op time histogram (device "
         "time on the card, host op time with `--device cpu`).",
         profile_step),
        ("## `python -m iggcn_tpu_torch.tools.report`",
         "Aggregate results dirs into a summary table (best epoch by "
         "fold-mean accuracy, acc ± std, auc/f1/sen/spe) from the per-fold "
         "result records of either package, and compute permutation "
         "p-values against `--isPermutTest` null runs. Host-side only.",
         report),
        ("## `python -m iggcn_tpu_torch.tools.export_cohort`",
         "Convert a reference-layout data dir into a serving cohort npz "
         "through the training loaders themselves. Host-side only.",
         export_cohort),
        ("## `python -m iggcn_tpu_torch.tools.import_torch`",
         "Convert a reference-trained torch checkpoint "
         "(`gcn_state_dict_*.pt`, the fused SGCN_GCN_IMGSNP family) into a "
         "serving bundle, or a bundle back into the reference layout.",
         import_torch),
    ):
        parts.append("")
        parts.append(title + "\n")
        parts.append(blurb + "\n")
        parts.append(render_parser(mod.build_parser()))

    parts.append("")
    parts.append("## Environment variables\n")
    parts.append("| variable | effect |")
    parts.append("|---|---|")
    for var, effect in (
        ("`CUDA_HOME` / `CUDA_PATH`", "the CUDA toolkit whose `nvcc` builds "
         "the kernels (else `nvcc` on `PATH`, else `/usr/local/cuda`)"),
        ("`CXX`", "the host C++ compiler of the native diffusion library, "
         "which the cohort loaders use for PPR + top-k (`auto` backend of "
         "`preprocess_diffusion`); default `g++`"),
        ("`OMP_NUM_THREADS`", "torch's CPU threads; 1 is much faster for "
         "the small ops of a `--device cpu` run"),
    ):
        parts.append(f"| {var} | {effect} |")
    parts.append("")
    return "\n".join(parts)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--check", action="store_true",
                   help="exit 1 if docs/cli_torch.md differs from the parsers")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    text = render_cli_md()
    if args.check:
        on_disk = (open(DOC_PATH).read()
                   if os.path.isfile(DOC_PATH) else "")
        if on_disk != text:
            print("docs/cli_torch.md is stale; regenerate with "
                  "python -m iggcn_tpu_torch.tools.gen_docs", file=sys.stderr)
            return 1
        print("docs/cli_torch.md is up to date")
        return 0
    os.makedirs(os.path.dirname(DOC_PATH), exist_ok=True)
    with open(DOC_PATH, "w") as fh:
        fh.write(text)
    print(f"wrote {DOC_PATH}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
