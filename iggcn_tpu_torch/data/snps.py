"""Standalone SNP csv cohort of the SNP-only trainers (a copy of
`iggcn_tpu/data/snps.py`).

The reference layout is `<root>/<folder>/snp.csv` and `dia.csv`, each
with a header row; the folder follows the disease id: 0 -> data_AH (AD
vs HC), 1 -> data_MH (MCI vs HC), anything else -> data_AM (AD vs MCI).
The SNP matrix is scaled by 1/10 and the labels are kept as floats for
the BCE loss; the trainer splits the cohort itself.
"""
from __future__ import annotations

import os
from typing import Tuple

import numpy as np

DISEASE_FOLDER = {0: "data_AH", 1: "data_MH"}


def load_snps_csv(root: str, disease_id: int = 0
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """(snps (S, num_snps) float32 / 10, labels (S,) float32) from
    `<root>/<folder>/{snp,dia}.csv`; FileNotFoundError when either file
    is missing."""
    folder = DISEASE_FOLDER.get(disease_id, "data_AM")
    base = os.path.join(root, folder)
    snp_path = os.path.join(base, "snp.csv")
    dia_path = os.path.join(base, "dia.csv")
    if not (os.path.exists(snp_path) and os.path.exists(dia_path)):
        raise FileNotFoundError(f"no snp.csv/dia.csv under {base}")
    data = np.genfromtxt(snp_path, delimiter=",", skip_header=1,
                         dtype=np.float64)
    data = np.atleast_2d(data) / 10.0
    label = np.genfromtxt(dia_path, delimiter=",", skip_header=1,
                          dtype=np.float64)
    label = np.asarray(label).reshape(-1)
    if data.shape[0] != label.shape[0]:
        raise ValueError(f"snp.csv has {data.shape[0]} rows but dia.csv "
                         f"has {label.shape[0]}")
    return data.astype(np.float32), label.astype(np.float32)
