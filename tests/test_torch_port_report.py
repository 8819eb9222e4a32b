"""The port's results aggregator (`iggcn_tpu_torch/tools/report.py`) against
the JAX package's (`iggcn_tpu/tools/report.py`) over the same results
dirs, with fold records written by both packages: the port's fused CV,
its permutation-null batch and its seed batch, and the SNP-only MLP
trained by each package into dirs of the same tag. The summary,
replication, regression, importance and p-value tables, the CSV files and
the exit codes are equal, and so are `--plot`'s figures, pixel for
pixel."""
import contextlib
import dataclasses
import glob
import io
import os

import numpy as np
import pytest
import torch

from iggcn_tpu.data.go_graph import synthetic_topology as jax_topology
from iggcn_tpu.tools import report as jax_report
from iggcn_tpu.train.snps_trainer import cross_validation_snps as jax_snps
from iggcn_tpu_torch.config import LossWeights, ModelConfig, TrainConfig
from iggcn_tpu_torch.data.adni import (permute_regression_targets,
                                       synthetic_cohort)
from iggcn_tpu_torch.data.go_graph import synthetic_topology
from iggcn_tpu_torch.tools import report as port_report
from iggcn_tpu_torch.train.cv import (cross_validation,
                                      cross_validation_permut_batch,
                                      cross_validation_seed_batch)
from iggcn_tpu_torch.train.snps_trainer import \
    cross_validation_snps as port_snps


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("report")
    cohort = synthetic_cohort(np.random.default_rng(1), num_subjects=40,
                              num_classes=2)
    topo = synthetic_topology(np.random.default_rng(0))
    mcfg = ModelConfig(num_layers=2, hidden=8, hidden_linear=16, l_dim=8,
                       num_classes=2)
    tcfg = TrainConfig(epochs=2, batch_size=8, folds=3, seed=0,
                       fold_parallel=True,
                       loss=LossWeights(disease=1.0, regr=1.0, prob=0.5,
                                        reco=1.5e-6, simi=0.1))
    out = {"observed": str(root / "observed")}
    cross_validation(cohort, topo, mcfg, tcfg, res_dir=out["observed"],
                     result_file_name="r", verbose=False, device="cpu")
    out["nulls"] = [str(root / f"null{s}") for s in (1, 2, 3)]
    cross_validation_permut_batch(
        [(s, permute_regression_targets(cohort, s)) for s in (1, 2, 3)],
        topo, mcfg, dataclasses.replace(tcfg, is_permut_test=True),
        res_dirs=out["nulls"], result_file_name="r", verbose=False,
        device="cpu")
    out["seeds"] = [str(root / f"seed{s}") for s in (4, 5)]
    cross_validation_seed_batch(cohort, (4, 5), topo, mcfg, tcfg,
                                res_dirs=out["seeds"], result_file_name="r",
                                verbose=False, device="cpu")
    snps = (cohort.snps, cohort.y.astype(np.float32))
    out["jax_snps"] = str(root / "jax_snps")
    os.makedirs(out["jax_snps"])
    jax_snps(*snps, jax_topology(np.random.default_rng(0)), folds=3, epochs=2,
             batch_size=8, model_kind="mlp", record_dir=out["jax_snps"])
    out["port_snps"] = str(root / "port_snps")
    os.makedirs(out["port_snps"])
    port_snps(*snps, topo, folds=3, epochs=2, batch_size=8, model_kind="mlp",
              record_dir=out["port_snps"], device="cpu")
    for d in (out["jax_snps"], out["port_snps"]):
        assert any(n.startswith("fold_result_snps_mlp_fold_")
                   for n in os.listdir(d))
    out["root"] = root
    return out


def _run(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        code = main(argv)
    return code, buf.getvalue()


def _both(argv):
    got, want = _run(port_report.main, argv), _run(jax_report.main, argv)
    assert got == want
    return got


def test_tables_and_p_values_equal_the_jax_tools(dirs):
    code, text = _both([dirs["observed"], "--permut_null", *dirs["nulls"]])
    assert code == 0
    assert "| tag | observed_acc | null_n | null_mean | null_max | p_value |" \
        in text
    assert "| r | tau | " in text          # the regression p-values
    pv = port_report.permutation_pvalue(port_report.collect_dir(
        dirs["observed"]), dirs["nulls"])
    want = jax_report.permutation_pvalue(jax_report.collect_dir(
        dirs["observed"]), dirs["nulls"])
    assert [r["p_value"] for r in pv] == [r["p_value"] for r in want]
    assert pv and pv[0]["null_n"] == 3


def test_replication_across_seeds_and_packages_and_the_csv(dirs, tmp_path):
    argv = [*dirs["seeds"], dirs["jax_snps"], dirs["port_snps"],
            "--importance"]
    code, text = _both(argv + ["--csv", str(tmp_path / "a.csv")])
    assert code == 0
    rows = port_report.replication_rows(
        [r for d in argv[:-1] for r in port_report.collect_dir(d)])
    assert {r["tag"] for r in rows} == {"r", "snps_mlp"}
    assert all(r["runs"] == 2 for r in rows)
    _run(jax_report.main, argv + ["--csv", str(tmp_path / "b.csv")])
    for a, b in (("a.csv", "b.csv"), ("a_importance.csv",
                                      "b_importance.csv")):
        assert (tmp_path / a).read_text() == (tmp_path / b).read_text()


def test_empty_dirs_and_missing_nulls_fail_alike(dirs, tmp_path):
    assert _both([str(tmp_path)])[0] == 1
    assert _both([dirs["observed"], "--permut_null", str(tmp_path)])[0] == 1


def test_plot_is_refused_until_the_port_has_plots(dirs, capsys):
    """The port has the plots now: `--plot` writes the JAX tool's figures
    (training curves, permutation nulls, importance bars), pixel-equal."""
    from matplotlib.image import imread
    argv = [dirs["observed"], *dirs["seeds"], "--permut_null",
            *dirs["nulls"], "--importance", "--plot"]

    def figures():
        return {p: imread(p) for d in argv if os.path.isdir(d)
                for p in sorted(glob.glob(os.path.join(d, "report_*.png")))}

    code, _ = _run(port_report.main, argv)
    got = figures()
    assert code == 0 and len(got) >= 5
    kinds = {os.path.basename(p).split("_")[1] for p in got}
    assert kinds == {"curves", "null", "importance"}
    for p in got:
        os.remove(p)
    assert _run(jax_report.main, argv)[0] == 0
    want = figures()
    assert sorted(want) == sorted(got)
    for p in got:
        assert np.array_equal(got[p], want[p]), p
    assert "[report] wrote" in capsys.readouterr().err
