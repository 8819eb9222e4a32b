"""Hold this checkout's one-device training against another checkout's,
bit for bit (e.g. the parent commit unpacked by `git archive` into the
git-ignored `results/parent`).

Each checkout runs in a fresh process with its root first on `sys.path`
and as its working directory, so that it imports its own
`iggcn_tpu_torch` (and builds its kernels into its own `_build/`):

  * on the CPU (always): `cross_validation` of every fused family at a
    small size (3 folds, 45 subjects, 2 epochs, batch 8, dropout on),
    sequential and `--fold_parallel`, the SGCN_GCN_IMGSNP family with the
    soft and the hard similarity; the mean test loss and the score matrix
    of each run;
  * with `--card`, on the card: `chip_smoke.py`'s 2-epoch flagship
    `--fold_parallel` CLI run (phases 15 and 19; the argv of this
    checkout's `chip_smoke.cli_argv`): every npy, fold record, checkpoint
    and bundle it writes, its printed per-epoch losses and `Result -`
    line.

Prints the number of values compared and exits 1 at the first that
differs in any bit.

    python scripts/parent_bits_torch.py --parent results/parent [--card]

It imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import glob
import io
import json
import os
import pickle
import re
import shutil
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# (family, soft similarity) of the CPU runs
CPU_RUNS = [("sgcn_imgsnp", True), ("sgcn_imgsnp", False),
            ("gcn_imgsnp", True), ("guide_imgsnp", True),
            ("clusterlabel", True), ("sgcn_image", True), ("sgcn_ori", True)]
CARD_APPENDIX = "_parent_bits_fp"


def cpu_arrays() -> dict:
    """{run: array} of the CPU runs, in this process's checkout."""
    import numpy as np
    import torch

    from iggcn_tpu_torch.config import LossWeights, ModelConfig, TrainConfig
    from iggcn_tpu_torch.data.adni import synthetic_cohort
    from iggcn_tpu_torch.data.go_graph import synthetic_topology
    from iggcn_tpu_torch.train.cv import cross_validation
    torch.set_num_threads(1)
    out = {}
    for kind, soft in CPU_RUNS:
        mcfg = ModelConfig(num_layers=2, hidden=8, hidden_linear=16, l_dim=8,
                           is_soft_similarity=soft)
        tcfg = TrainConfig(epochs=2, batch_size=8, folds=3, seed=1,
                           loss=LossWeights(disease=1.0, regr=1.0, simi=0.1,
                                            orth=0.1, prob=0.1, reco=0.1))
        for fold_parallel in (False, True):
            res = cross_validation(
                synthetic_cohort(np.random.default_rng(1), num_subjects=45),
                synthetic_topology(np.random.default_rng(0)), mcfg,
                dataclasses.replace(tcfg, fold_parallel=fold_parallel),
                res_dir=None, verbose=False, device="cpu", model_kind=kind)
            tag = f"{kind} soft={soft} fold_parallel={fold_parallel}"
            out[f"{tag}: mean test loss"] = np.asarray(res.mean_test_loss)
            out[f"{tag}: score matrix"] = np.asarray(res.score_result)
    return out


def snapshot(res_dir: str) -> dict:
    """{file:key: array} of the .npy, .npz and .msgpack files (as bytes)
    a CLI run wrote into `res_dir`."""
    import numpy as np
    out = {}
    for path in sorted(glob.glob(os.path.join(res_dir, "*"))):
        name = os.path.basename(path)
        if name.endswith(".npy"):
            out[name] = np.load(path)
        elif name.endswith(".npz"):
            with np.load(path) as zf:
                out.update({f"{name}:{k}": zf[k] for k in zf.files})
        elif name.endswith(".msgpack"):
            with open(path, "rb") as fh:
                out[name] = np.frombuffer(fh.read(), np.uint8)
    return out


def card_arrays(argv: list) -> dict:
    """{file:key: array, "printed": the epoch and Result lines} of the
    CLI run of `argv` on the card, in this process's checkout."""
    from iggcn_tpu_torch import main as port_main
    res_dir = os.path.join(os.getcwd(), "results", f"ADNI{CARD_APPENDIX}")
    shutil.rmtree(res_dir, ignore_errors=True)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        port_main.main(argv)
    out = snapshot(res_dir)
    if not out:
        raise AssertionError(f"{res_dir}: the run wrote nothing to compare")
    out["printed"] = "\n".join(
        line for line in buf.getvalue().splitlines()
        if re.match(r"^(Fold: \d+, epoch:|Result - )", line))
    return out


def child(root: str, out_path: str, argv_json: str | None) -> None:
    sys.path.insert(0, os.path.abspath(root))
    os.chdir(root)
    out = {"cpu": cpu_arrays()}
    if argv_json is not None:
        out["card"] = card_arrays(json.loads(argv_json))
    with open(out_path, "wb") as fh:
        pickle.dump(out, fh)


def run_checkout(root: str, argv: list | None) -> dict:
    with tempfile.TemporaryDirectory(prefix="parent_bits_") as tmp:
        out_path = os.path.join(tmp, "out.pkl")
        cmd = [sys.executable, os.path.abspath(__file__), "--child",
               os.path.abspath(root), out_path]
        if argv is not None:
            cmd.append(json.dumps(argv))
        subprocess.run(cmd, check=True)
        with open(out_path, "rb") as fh:
            return pickle.load(fh)


def compare(got: dict, want: dict, what: str) -> int:
    """The number of values in `want`, which `got` must hold bit for bit."""
    import numpy as np
    if sorted(got) != sorted(want):
        raise AssertionError(f"{what}: {sorted(got)} against {sorted(want)}")
    n = 0
    for key, w in want.items():
        g = got[key]
        if isinstance(w, str):
            if g != w:
                raise AssertionError(f"{what} {key}: {g!r} against {w!r}")
            n += len(w.splitlines())
            continue
        if g.dtype != w.dtype or g.shape != w.shape or \
                np.ascontiguousarray(g).tobytes() != \
                np.ascontiguousarray(w).tobytes():
            raise AssertionError(f"{what} {key}: differs from the other "
                                 "checkout's")
        n += w.size
    return n


def main() -> int:
    if len(sys.argv) > 1 and sys.argv[1] == "--child":
        child(sys.argv[2], sys.argv[3],
              sys.argv[4] if len(sys.argv) > 4 else None)
        return 0
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--parent", required=True,
                   help="the other checkout's root")
    p.add_argument("--card", action="store_true",
                   help="also the flagship's --fold_parallel CLI run on "
                        "the card")
    args = p.parse_args()
    argv = None
    if args.card:
        sys.path.insert(0, REPO)
        import chip_smoke
        argv = chip_smoke.cli_argv(chip_smoke.FP_EPOCHS, CARD_APPENDIX,
                                   "--fold_parallel")
    theirs = run_checkout(args.parent, argv)
    ours = run_checkout(REPO, argv)
    for part in ours:
        n = compare(ours[part], theirs[part], part)
        print(f"parent_bits {part}: {n} values bit-equal to {args.parent}",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
