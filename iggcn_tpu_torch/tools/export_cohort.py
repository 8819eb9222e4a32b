"""Convert a reference-layout data dir into a serving cohort npz (port of
`iggcn_tpu/tools/export_cohort.py`).

Closes the deployment loop for real data: training exports a bundle
(`--export_bundle` -> `serving_bundle_*.npz`), but
`python -m iggcn_tpu_torch.tools.serve --npz` needs the cohort tensors in the SAME preprocessed form the model trained
on — diffused adjacency (PPR/heat + top-k), NaN-filled MinMax-scaled SNPs,
reshaped imaging features. Hand-building those from the raw .mat files
would duplicate (and inevitably drift from) the training loaders; this
tool runs the actual loaders (`data/adni.py:load_adni874` /
`load_adni_csv`, `data/snps.py:load_snps_csv`) over a data dir and writes
the ready-to-serve npz. Host-side NumPy only: it needs no card.

Usage:
  # imaging+genetics cohort (reference .mat layout) -> x/adj/snps/y npz
  python -m iggcn_tpu_torch.tools.export_cohort --data_path DIR --out cohort.npz
  # per-task CSV/mat layout
  python -m iggcn_tpu_torch.tools.export_cohort --data_path DIR --csv_layout \\
      --disease_id 0 --out cohort.npz
  # SNP-only csv cohort (serve against a snps_go / snps_mlp bundle)
  python -m iggcn_tpu_torch.tools.export_cohort --snps_csv_root DIR \\
      --disease_id 0 --out snps.npz

Diffusion flags must match the training run (`--isPPr/--isTopK/--top_k`,
same defaults as `iggcn_tpu_torch.main`) or the served adjacencies differ
from the trained ones.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--out", required=True,
                   help="output npz (feed to iggcn_tpu_torch.tools.serve "
                        "--npz or POST to the daemon's /predict)")
    p.add_argument("--data_path", default=None,
                   help="ADNI preprocessing dir (holds knn/<k>/)")
    p.add_argument("--knn", type=int, default=5)
    p.add_argument("--disease_id", type=int, default=3)
    p.add_argument("--csv_layout", action="store_true", default=False,
                   help="--data_path holds the per-task CSV/mat layout "
                        "(load_adni_csv) instead of the adni874 .mat layout")
    p.add_argument("--isMultiFusion", action="store_true", default=False)
    p.add_argument("--isPPr", action=argparse.BooleanOptionalAction,
                   default=True,
                   help="PPR diffusion (--no-isPPr: heat kernel); must "
                        "match the training run")
    p.add_argument("--isTopK", action=argparse.BooleanOptionalAction,
                   default=True)
    p.add_argument("--top_k", type=int, default=3)
    p.add_argument("--snps_csv_root", default=None,
                   help="export a SNP-only cohort from the standalone csv "
                        "layout instead of an imaging cohort")
    p.add_argument("--with_labels", action=argparse.BooleanOptionalAction,
                   default=True,
                   help="also store y/sbj_id (for offline evaluation of "
                        "the served predictions); --no-with_labels writes "
                        "pure inference inputs")
    return p


def main(argv=None) -> int:
    p = build_parser()
    args = p.parse_args(argv)
    if args.snps_csv_root is None and args.data_path is None:
        p.error("give --data_path (imaging cohort) or --snps_csv_root "
                "(SNP-only cohort)")

    if args.snps_csv_root is not None:
        from iggcn_tpu_torch.data.snps import load_snps_csv
        snps, y = load_snps_csv(args.snps_csv_root, args.disease_id)
        payload = {"snps": snps.astype(np.float32)}
        if args.with_labels:
            payload["y"] = y
        np.savez(args.out, **payload)
        print(f"wrote {args.out}: snps {snps.shape}"
              + (" + y" if args.with_labels else ""))
        return 0

    from iggcn_tpu_torch.config import DataConfig
    from iggcn_tpu_torch.data.adni import load_adni874, load_adni_csv

    cfg = DataConfig(data_path=args.data_path, knn=args.knn,
                     disease_id=args.disease_id, is_ppr=args.isPPr,
                     is_topk=args.isTopK, top_k=args.top_k,
                     is_multi_fusion=args.isMultiFusion)
    try:
        cohort = (load_adni_csv(cfg) if args.csv_layout
                  else load_adni874(cfg))
    except Exception as e:
        print(f"[export] failed to load the cohort from {args.data_path} "
              f"({type(e).__name__}: {e}); the layout needs "
              + ("data_{AH,MH,AM}/snp.csv and data_*/knn/<k>/*.mat"
                 if args.csv_layout else "knn/<k>/*.mat")
              + f" with --knn {args.knn}", file=sys.stderr)
        raise
    payload = {
        "x": cohort.x.astype(np.float32),
        "adj": cohort.adj.astype(np.float32),
        "snps": cohort.snps.astype(np.float32),
    }
    if args.with_labels:
        payload["y"] = cohort.y
        payload["sbj_id"] = cohort.sbj_id
    np.savez(args.out, **payload)
    print(f"wrote {args.out}: x {cohort.x.shape}, adj {cohort.adj.shape}, "
          f"snps {cohort.snps.shape}"
          + (" + y/sbj_id" if args.with_labels else ""))
    return 0


if __name__ == "__main__":
    sys.exit(main())
