"""Pre-flight data validation ("doctor") for real ADNI / GO data layouts
(port of `iggcn_tpu/tools/doctor.py`: the same checks, findings and exit
codes; the GO sources parse through the port's `data/go_graph.py`, a TU
dataset through its `data/tu.py`).

The reference has no data validation at all: a wrong `--data_path`, a
renamed mat key, or a truncated file fails minutes into setup with a deep
scipy `KeyError` or an indexing crash (`sgcn_data.py:113-292` loads nine
files with no checks). This tool verifies the WHOLE layout up front —
required files, mat variable names, array shapes, cross-file subject-count
agreement, label ranges, GO source parseability, and SNP-width agreement
between the cohort and the GO incidence — so a long training run never
starts against broken inputs. New capability (no reference equivalent);
the file inventory mirrors `data/adni.py:load_adni874` /
`data/snps.py:load_snps_csv` / `data/go_graph.py:parse_go_json` exactly.

Usage:
  python -m iggcn_tpu_torch.tools.doctor --data_path DIR [--knn 5]
      [--num_cluster 2] [--isMultiFusion]
      [--json_path J --go_connection_path C --snps_to_gene_path G]
      [--snps_csv_root DIR --disease_id 0]

Exit code 0 when every check passes (warnings allowed), 1 on any FAIL.
Pure host-side NumPy/scipy: it never touches the card.
"""
from __future__ import annotations

import argparse
import os
import sys
from typing import Any, List, Optional, Tuple

import numpy as np

Finding = Tuple[str, str]   # (level: 'ok' | 'warn' | 'fail', message)

# (filename, mat variable, human description) under <data_path>/knn/<k>/
_MAT_FILES = (
    ("sbjID_int.mat", "sbjID_int", "subject ids"),
    ("score_excel_val_adni874_fill.mat", "info_score_val_fill",
     "imputed clinical scores"),
    ("score_excel_val_adni874.mat", "info_score_val_subs",
     "raw demographics (NaNs expected)"),
    ("SNPS_data.mat", "SNPS_data", "SNP matrix"),
    ("BL_DXGrp_label.mat", "BL_DXGrp_label", "diagnosis labels"),
    ("corr_data.mat", "corr_data", "connectivity matrices"),
    ("imgData_mat_normalized_fix.mat", "imgData_mat_normalized",
     "imaging features"),
)
_MODALITIES = ("MRI", "FDG-PET", "AV45-PET")


def _load_mat(path: str, key: str, out: List[Finding]) -> Optional[np.ndarray]:
    """Load one mat variable; records a finding and returns None on failure."""
    import scipy.io as sio

    if not os.path.isfile(path):
        out.append(("fail", f"missing file: {path}"))
        return None
    try:
        mat = sio.loadmat(path)
    except Exception as e:
        out.append(("fail", f"unreadable mat file {path}: {e}"))
        return None
    if key not in mat:
        have = [k for k in mat if not k.startswith("__")]
        out.append(("fail", f"{path}: expected variable {key!r}, found "
                            f"{have} (rename the variable, not the file)"))
        return None
    return np.asarray(mat[key])


def check_adni874(data_path: str, knn: int = 5, num_cluster: int = 2,
                  multi_fusion: bool = False,
                  use_tsne4similar: bool = False,
                  multimodal4similarity: bool = False
                  ) -> Tuple[List[Finding], dict]:
    """Validate the `.mat` cohort layout `load_adni874` reads.

    Returns (findings, info) where info carries the discovered dimensions
    ('subjects', 'snp_width') for cross-checks against the GO sources."""
    out: List[Finding] = []
    info: dict = {}
    base = os.path.join(data_path, f"knn/{knn}/")
    if not os.path.isdir(base):
        out.append(("fail", f"missing directory: {base} (--data_path must "
                            "hold knn/<k>/ like the reference layout)"))
        return out, info

    arrays = {}
    for fname, key, desc in _MAT_FILES:
        arr = _load_mat(os.path.join(base, fname), key, out)
        if arr is not None:
            arrays[fname] = arr
            out.append(("ok", f"{fname} [{desc}]: {key} {arr.shape}"))

    # subject-count agreement across every file
    counts = {f: int(a.shape[0]) for f, a in arrays.items()}
    if counts and len(set(counts.values())) > 1:
        out.append(("fail", "subject counts disagree across files: "
                            + ", ".join(f"{f}={n}" for f, n in
                                        sorted(counts.items()))))
    s = next(iter(counts.values()), None)
    info["subjects"] = s
    if "SNPS_data.mat" in arrays:
        info["snp_width"] = int(arrays["SNPS_data.mat"].shape[1])

    corr = arrays.get("corr_data.mat")
    if corr is not None:
        if corr.ndim != 3 or corr.shape[1] != corr.shape[2]:
            out.append(("fail", f"corr_data must be (S, N, N) square, got "
                                f"{corr.shape}"))
        img = arrays.get("imgData_mat_normalized_fix.mat")
        if img is not None and img.ndim >= 2 and corr.ndim == 3 \
                and img.shape[1] != corr.shape[1]:
            out.append(("fail", f"ROI count disagrees: corr_data has "
                                f"{corr.shape[1]} nodes, imgData has "
                                f"{img.shape[1]}"))

    labels = arrays.get("BL_DXGrp_label.mat")
    if labels is not None:
        lab = labels.reshape(-1)
        # the mat stores 1..5 = {HC, SMC, EMCI, LMCI, AD}; the loader
        # subtracts 1 (data/adni.py:192, parity sgcn_data.py)
        if lab.min() < 1 or lab.max() > 5:
            out.append(("fail", f"labels must be raw 1..5 "
                                f"(HC/SMC/EMCI/LMCI/AD), got range "
                                f"[{lab.min()}, {lab.max()}] — already "
                                "0-based labels would shift every class"))
        else:
            binc = np.bincount(lab.astype(int), minlength=6)[1:]
            out.append(("ok", f"label counts HC..AD: {binc.tolist()}"))

    snps = arrays.get("SNPS_data.mat")
    if snps is not None and np.isnan(snps).any():
        frac = float(np.isnan(snps).mean())
        out.append(("warn", f"SNP matrix has {frac:.1%} NaNs (loader "
                            "zero-fills them)"))
    demo = arrays.get("score_excel_val_adni874.mat")
    if demo is not None and np.isnan(demo).any():
        out.append(("ok", f"demographics NaN fraction "
                          f"{float(np.isnan(demo).mean()):.1%} (expected; "
                          "imputed per fold)"))

    # npy sidecars
    clus = os.path.join(base, f"center_{num_cluster}",
                        "clusters_pred_label.npy")
    if not os.path.isfile(clus):
        out.append(("fail", f"missing file: {clus} (produce it with "
                            "iggcn_tpu_torch.data.cluster, parity "
                            "util/image_cluster.py)"))
    elif s is not None:
        n_clus = np.load(clus).reshape(-1).shape[0]
        if n_clus != s:
            out.append(("fail", f"{clus}: {n_clus} labels for {s} subjects"))
        else:
            out.append(("ok", f"cluster labels: {n_clus} subjects"))
    if use_tsne4similar:
        sim_name = "tsne_results.npy"
    elif multimodal4similarity:
        sim_name = "multimodal_for_similarity.npy"
    else:
        sim_name = "pet_for_similarity.npy"
    sim = os.path.join(base, sim_name)
    if not os.path.isfile(sim):
        out.append(("fail", f"missing file: {sim} (similarity features for "
                            "the consistency loss)"))
    elif s is not None:
        n_sim = np.load(sim).shape[0]
        out.append(("ok", f"{sim_name}: shape[0]={n_sim}") if n_sim == s
                   else ("fail", f"{sim}: {n_sim} rows for {s} subjects"))

    if multi_fusion:
        for mod in _MODALITIES:
            mpath = os.path.join(data_path, mod, f"knn/{knn}/corr_data.mat")
            m = _load_mat(mpath, "corr_data", out)
            if m is None:
                continue
            if s is not None and m.shape[0] != s:
                out.append(("fail", f"{mpath}: {m.shape[0]} subjects "
                                    f"(cohort has {s})"))
            elif corr is not None and m.shape[1:] != corr.shape[1:]:
                out.append(("fail", f"{mpath}: per-modality shape "
                                    f"{m.shape[1:]} != base {corr.shape[1:]}"))
            else:
                out.append(("ok", f"{mod} corr_data: {m.shape}"))
    return out, info


def check_go_sources(json_path: str, connection_path: str,
                     snps_to_gene_path: str
                     ) -> Tuple[List[Finding], Optional[Any]]:
    """Validate the three GO source files by actually parsing them."""
    out: List[Finding] = []
    missing = [p for p in (json_path, connection_path, snps_to_gene_path)
               if not os.path.isfile(p)]
    if missing:
        out.append(("fail", f"missing GO source file(s): {missing}"))
        return out, None
    from iggcn_tpu_torch.data.go_graph import parse_go_json
    try:
        topo = parse_go_json(json_path, connection_path, snps_to_gene_path)
    except Exception as e:
        out.append(("fail", f"GO sources do not parse ({type(e).__name__}: "
                            f"{e}) — expected PANTHER-style analysis json + "
                            "root-connection txt + snps_to_gene txt"))
        return out, None
    out.append(("ok", f"GO topology: {topo.n} terms, pool {list(topo.pool)}, "
                      f"n_l={topo.n_l}, {topo.num_snps} SNP columns"))
    if topo.go_snps.sum() == 0:
        out.append(("warn", "GO x SNP incidence is all-zero: no SNP maps to "
                            "any GO term's gene list — the genetics branch "
                            "would see zero gene signal"))
    return out, topo


def check_snps_width(topo: Any, snp_width: int) -> List[Finding]:
    if int(topo.num_snps) != int(snp_width):
        return [("fail", f"SNP width mismatch: cohort has {snp_width} SNPs "
                         f"but the GO incidence expects {topo.num_snps} — "
                         "snps_to_gene.txt and SNPS_data.mat must describe "
                         "the same SNP panel")]
    return [("ok", f"SNP width agrees: {snp_width}")]


def check_adni_csv(data_path: str, disease_id: int,
                   knn: int = 5) -> Tuple[List[Finding], dict]:
    """Validate the per-task CSV/mat cohort layout `load_adni_csv` reads
    (`data_AH|MH|AM/snp.csv` + `knn/<k>/` imaging mats with ALREADY-binary
    labels, parity sgcn_data.py:62-111). Returns (findings, info) like
    `check_adni874`."""
    out: List[Finding] = []
    info: dict = {}
    sub = {0: "data_AH", 1: "data_MH"}.get(disease_id, "data_AM")
    base = os.path.join(data_path, sub)
    snp = os.path.join(base, "snp.csv")
    if not os.path.isfile(snp):
        out.append(("fail", f"missing file: {snp}"))
        x = None
    else:
        x = np.atleast_2d(np.genfromtxt(snp, delimiter=",", skip_header=1))
        out.append(("ok", f"{sub}/snp.csv: {x.shape[0]} subjects x "
                          f"{x.shape[1]} SNPs"))
        info["snp_width"] = int(x.shape[1])
    img_dir = os.path.join(base, f"knn/{knn}/")
    arrays = {}
    for fname, key, desc in _MAT_FILES:
        if fname not in ("BL_DXGrp_label.mat", "corr_data.mat",
                         "imgData_mat_normalized_fix.mat"):
            continue
        arr = _load_mat(os.path.join(img_dir, fname), key, out)
        if arr is not None:
            arrays[fname] = arr
            out.append(("ok", f"{sub}/knn/{knn}/{fname} [{desc}]: "
                              f"{arr.shape}"))
    counts = {f: int(a.shape[0]) for f, a in arrays.items()}
    if x is not None:
        counts["snp.csv"] = int(x.shape[0])
    if counts and len(set(counts.values())) > 1:
        out.append(("fail", "subject counts disagree: "
                            + ", ".join(f"{f}={n}" for f, n in
                                        sorted(counts.items()))))
    labels = arrays.get("BL_DXGrp_label.mat")
    if labels is not None:
        vals = set(np.unique(labels).tolist())
        if not vals <= {0, 1}:
            out.append(("fail", f"this layout's labels must be ALREADY "
                                f"binary 0/1 (unlike the adni874 layout's "
                                f"raw 1..5), found {sorted(vals)}"))
    info["subjects"] = next(iter(counts.values()), None)
    return out, info


def check_snps_csv(root: str, disease_id: int) -> List[Finding]:
    """Validate the standalone SNP csv cohort layout `load_snps_csv` reads."""
    out: List[Finding] = []
    sub = {0: "data_AH", 1: "data_MH", 2: "data_AM"}.get(disease_id)
    if sub is None:
        return [("fail", f"SNP csv cohorts exist for disease_id 0|1|2, "
                         f"got {disease_id}")]
    base = os.path.join(root, sub)
    snp, dia = os.path.join(base, "snp.csv"), os.path.join(base, "dia.csv")
    missing = [p for p in (snp, dia) if not os.path.isfile(p)]
    if missing:
        out.append(("fail", f"missing csv file(s): {missing}"))
        return out
    try:
        x = np.genfromtxt(snp, delimiter=",", skip_header=1)
        y = np.genfromtxt(dia, delimiter=",", skip_header=1)
    except Exception as e:
        out.append(("fail", f"csv files do not parse: {e}"))
        return out
    x = np.atleast_2d(x)
    y = np.asarray(y).reshape(-1)
    if x.shape[0] != y.shape[0]:
        out.append(("fail", f"{snp} has {x.shape[0]} rows but {dia} has "
                            f"{y.shape[0]} labels"))
    labels = set(np.unique(y[np.isfinite(y)]).tolist())
    if not labels <= {0.0, 1.0}:
        out.append(("fail", f"dia.csv labels must be binary 0/1 (BCE "
                            f"trainer), found {sorted(labels)}"))
    if not out:
        out.append(("ok", f"{sub}: {x.shape[0]} subjects x {x.shape[1]} "
                          "SNPs, binary labels"))
    return out


def check_tu_dataset(root: str, name: str) -> List[Finding]:
    """Validate a raw TU benchmark layout (`data/tu.py:read_tu_dir`):
    required files, 1-based index conventions, cross-file count agreement —
    then prove it by actually loading the dataset."""
    out: List[Finding] = []
    base = os.path.join(root, name)
    if not os.path.isfile(os.path.join(base, f"{name}_A.txt")):
        raw = os.path.join(base, "raw")
        if os.path.isfile(os.path.join(raw, f"{name}_A.txt")):
            base = raw
        else:
            out.append(("fail", f"no {name}_A.txt under {base} or "
                                f"{base}/raw (--tu_root must hold "
                                f"<name>/<name>_A.txt, the raw TU dump)"))
            return out

    def path(suffix):
        return os.path.join(base, f"{name}_{suffix}.txt")

    for suffix in ("graph_indicator", "graph_labels"):
        if not os.path.isfile(path(suffix)):
            out.append(("fail", f"missing file: {path(suffix)}"))
    if any(level == "fail" for level, _ in out):
        return out
    try:
        indicator = np.loadtxt(path("graph_indicator"), dtype=np.int64,
                               delimiter=",").reshape(-1)
        edges = np.loadtxt(path("A"), dtype=np.int64, delimiter=",",
                           ndmin=2)
        graph_labels = np.loadtxt(path("graph_labels"), dtype=np.int64,
                                  delimiter=",").reshape(-1)
    except Exception as e:
        out.append(("fail", f"TU files do not parse as int csv: {e}"))
        return out
    num_nodes, num_graphs = indicator.shape[0], int(indicator.max())
    if indicator.min() < 1:
        out.append(("fail", f"{name}_graph_indicator.txt must be 1-based "
                            f"(min found: {indicator.min()})"))
    if set(np.unique(indicator)) != set(range(1, num_graphs + 1)):
        out.append(("fail", f"{name}_graph_indicator.txt graph ids are not "
                            f"contiguous 1..{num_graphs}"))
    if graph_labels.shape[0] != num_graphs:
        out.append(("fail", f"{name}_graph_labels.txt has "
                            f"{graph_labels.shape[0]} labels for "
                            f"{num_graphs} graphs"))
    if edges.size and (edges.min() < 1 or edges.max() > num_nodes):
        out.append(("fail", f"{name}_A.txt node ids out of range "
                            f"[{edges.min()}, {edges.max()}] for "
                            f"{num_nodes} nodes (must be 1-based)"))
    for suffix, what in (("node_labels", "per-node int labels"),
                         ("node_attributes", "per-node float attributes")):
        if os.path.isfile(path(suffix)):
            try:
                rows = sum(1 for line in open(path(suffix)) if line.strip())
            except Exception as e:
                out.append(("fail", f"{path(suffix)} unreadable: {e}"))
                continue
            if rows != num_nodes:
                out.append(("fail", f"{path(suffix)}: {rows} rows for "
                                    f"{num_nodes} nodes"))
            else:
                out.append(("ok", f"{name}_{suffix}.txt: {rows} rows "
                                  f"({what})"))
    if not (os.path.isfile(path("node_labels"))
            or os.path.isfile(path("node_attributes"))):
        out.append(("warn", f"{name} has no node features; the loader "
                            "falls back to degree features "
                            "(kernel/datasets.py:55-67 semantics)"))
    if any(level == "fail" for level, _ in out):
        return out
    from iggcn_tpu_torch.data.tu import read_tu_dir
    try:
        ds = read_tu_dir(root, name)
    except Exception as e:
        out.append(("fail", f"read_tu_dir({name}) failed after structural "
                            f"checks passed: {e}"))
        return out
    out.append(("ok", f"{name}: {len(ds)} graphs, max {ds.x.shape[1]} "
                      f"nodes, {ds.num_features} features, "
                      f"{ds.num_classes} classes"))
    return out


def _report(findings: List[Finding]) -> int:
    tag = {"ok": "[ ok ]", "warn": "[warn]", "fail": "[FAIL]"}
    for level, msg in findings:
        print(f"{tag[level]} {msg}")
    fails = sum(1 for level, _ in findings if level == "fail")
    warns = sum(1 for level, _ in findings if level == "warn")
    print(f"doctor: {len(findings) - fails - warns} ok, {warns} warning(s), "
          f"{fails} failure(s)")
    return 1 if fails else 0


def build_parser() -> argparse.ArgumentParser:
    """The CLI's parser, apart from main() so that `tools/gen_docs.py`
    can render it."""
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--data_path", default=None,
                   help="ADNI preprocessing dir (holds knn/<k>/)")
    p.add_argument("--knn", type=int, default=5)
    p.add_argument("--num_cluster", type=int, default=2)
    p.add_argument("--disease_id", type=int, default=0)
    p.add_argument("--isMultiFusion", action="store_true", default=False)
    p.add_argument("--csv_layout", action="store_true", default=False,
                   help="--data_path holds the per-task CSV/mat layout "
                        "(data_AH|MH|AM/snp.csv + knn/<k>/ mats, the "
                        "load_adni_csv variant) instead of the adni874 "
                        ".mat layout")
    p.add_argument("--isUseTsne4Similar", action="store_true", default=False)
    p.add_argument("--isMultilModal4Similarity", action="store_true",
                   default=False)
    p.add_argument("--json_path", default=None)
    p.add_argument("--go_connection_path", default=None)
    p.add_argument("--snps_to_gene_path", default=None)
    p.add_argument("--snps_csv_root", default=None,
                   help="root of the standalone SNP csv cohorts")
    p.add_argument("--tu_root", default="./data",
                   help="root of raw TU benchmark datasets (with --tu_name)")
    p.add_argument("--tu_name", default=None,
                   help="validate this raw TU dataset "
                        "(<tu_root>/<name>/<name>_A.txt family)")
    return p


def main(argv=None) -> int:
    p = build_parser()
    args = p.parse_args(argv)

    go_args = (args.json_path, args.go_connection_path,
               args.snps_to_gene_path)
    if (not args.data_path and not any(go_args) and not args.snps_csv_root
            and not args.tu_name):
        p.error("nothing to check: give --data_path, the three GO source "
                "paths, --snps_csv_root, and/or --tu_name")
    if any(go_args) and not all(go_args):
        p.error("GO validation needs all three of --json_path "
                "--go_connection_path --snps_to_gene_path")

    findings: List[Finding] = []
    snp_width = None
    if args.data_path and args.csv_layout:
        fs, info = check_adni_csv(args.data_path, args.disease_id,
                                  knn=args.knn)
        findings += fs
        snp_width = info.get("snp_width")
    elif args.data_path:
        fs, info = check_adni874(
            args.data_path, knn=args.knn, num_cluster=args.num_cluster,
            multi_fusion=args.isMultiFusion,
            use_tsne4similar=args.isUseTsne4Similar,
            multimodal4similarity=args.isMultilModal4Similarity)
        findings += fs
        snp_width = info.get("snp_width")
    topo = None
    if all(go_args):
        fs, topo = check_go_sources(*go_args)
        findings += fs
    if topo is not None and snp_width is not None:
        findings += check_snps_width(topo, snp_width)
    if args.snps_csv_root:
        findings += check_snps_csv(args.snps_csv_root, args.disease_id)
    if args.tu_name:
        findings += check_tu_dataset(args.tu_root, args.tu_name)
    return _report(findings)


if __name__ == "__main__":
    sys.exit(main())
