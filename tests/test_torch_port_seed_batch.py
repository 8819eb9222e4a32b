"""The port's seed batches (`cross_validation_seed_batch`,
`cross_validation_permut_batch` in `iggcn_tpu_torch/train/cv.py`) and the
CLI routes `--cv_seeds`, `--permut_seeds` and `--spmd_batch_entries`
(`iggcn_tpu_torch/main.py`), on the CPU.

Every seed of a batch equals its standalone fold-parallel run, fold
record by fold record (the seeds x folds entries train in one vmapped
program; floats within rtol 1e-5, the entries' products summed in the
same order as a run of fewer entries, integers equal); chunking by
`--spmd_batch_entries` changes nothing; the preconditions, the checks
and the parser errors are the JAX package's, message for message; the
zoo and SNP-only families replicate one seed after the other; the results
dirs are named, and the `Replication over N seeds` line printed, as the
JAX CLI does; every results dir carries an `env.txt` manifest.
"""
import dataclasses
import glob
import os
import re

import numpy as np
import pytest
import torch

import main as jax_main
from iggcn_tpu.config import TrainConfig as JaxTC
from iggcn_tpu.train.cv import cross_validation_permut_batch as jax_permut
from iggcn_tpu.train.cv import cross_validation_seed_batch as jax_seed
from iggcn_tpu_torch import main as port_main
from iggcn_tpu_torch.config import LossWeights, ModelConfig, TrainConfig
from iggcn_tpu_torch.data.adni import (permute_regression_targets,
                                       synthetic_cohort)
from iggcn_tpu_torch.data.go_graph import synthetic_topology
from iggcn_tpu_torch.train.cv import (cross_validation,
                                      cross_validation_permut_batch,
                                      cross_validation_seed_batch)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEEDS = (3, 7)
MCFG = ModelConfig(num_layers=2, hidden=8, hidden_linear=16, l_dim=8,
                   num_classes=2)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def data():
    return (synthetic_cohort(np.random.default_rng(1), num_subjects=40,
                             num_classes=2),
            synthetic_topology(np.random.default_rng(0)))


def _tcfg(**over):
    base = dict(epochs=2, batch_size=8, folds=3, seed=0, fold_parallel=True,
                lr_decay_step_size=1,
                loss=LossWeights(disease=1.0, regr=1.0, prob=0.5,
                                 reco=1.5e-6, simi=0.1))
    base.update(over)
    return TrainConfig(**base)


def _same_dirs(a, b):
    """The same files; fold records and npys equal (floats rtol 1e-5)."""
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b)) and names
    for name in names:
        pa, pb = os.path.join(a, name), os.path.join(b, name)
        if name.endswith(".npz"):
            with np.load(pa) as za, np.load(pb) as zb:
                assert set(za.files) == set(zb.files)
                arrays = [(k, za[k], zb[k]) for k in za.files]
        elif name.endswith(".npy"):
            arrays = [(name, np.load(pa), np.load(pb))]
        else:
            continue
        for k, va, vb in arrays:
            if va.dtype.kind == "f":
                np.testing.assert_allclose(va, vb, rtol=1e-5, atol=1e-6,
                                           err_msg=f"{name}:{k}")
            else:
                assert np.array_equal(va, vb), (name, k)


def test_seed_batch_equals_standalone_runs(data, tmp_path):
    cohort, topo = data
    tcfg = _tcfg()
    dirs = [str(tmp_path / f"b{s}") for s in SEEDS]
    got = cross_validation_seed_batch(cohort, SEEDS, topo, MCFG, tcfg,
                                      res_dirs=dirs, result_file_name="r",
                                      verbose=False, device="cpu")
    for s, d, res in zip(SEEDS, dirs, got):
        alone = str(tmp_path / f"a{s}")
        want = cross_validation(cohort, topo, MCFG,
                                dataclasses.replace(tcfg, seed=s),
                                res_dir=alone, result_file_name="r",
                                verbose=False, device="cpu")
        _same_dirs(d, alone)
        assert len(glob.glob(os.path.join(d, "*.npy"))) > 3
        np.testing.assert_allclose(res.score_result, want.score_result,
                                   atol=1e-6)
        np.testing.assert_allclose(res.mean_test_loss, want.mean_test_loss,
                                   rtol=1e-5)


def test_permut_batch_equals_standalone_runs(data, tmp_path):
    cohort, topo = data
    tcfg = _tcfg(is_permut_test=True)
    variants = [(s, permute_regression_targets(cohort, s)) for s in SEEDS]
    dirs = [str(tmp_path / f"b{s}") for s in SEEDS]
    cross_validation_permut_batch(variants, topo, MCFG, tcfg, res_dirs=dirs,
                                  result_file_name="r", verbose=False,
                                  device="cpu")
    for (s, variant), d in zip(variants, dirs):
        alone = str(tmp_path / f"a{s}")
        cross_validation(variant, topo, MCFG, tcfg, res_dir=alone,
                         result_file_name="r", verbose=False, device="cpu")
        _same_dirs(d, alone)
        # a permutation run keeps fold records only
        assert sorted(os.listdir(d)) == [
            f"fold_result_r_fold_{k}.npz" for k in range(3)]


def _raised(fn, *args, **kwargs):
    with pytest.raises((ValueError, AssertionError)) as info:
        fn(*args, **kwargs)
    return str(info.value)


@pytest.mark.parametrize("over,permut", [
    (dict(fold_parallel=False), False), (dict(use_fold_scan=False), False),
    (dict(device_gather=False), False), (dict(is_permut_test=True), False),
    (dict(fold_parallel=False, is_permut_test=True), True),
    (dict(device_gather=False, is_permut_test=True), True),
    (dict(), True)])
def test_batch_preconditions_are_the_jax_packages(data, over, permut):
    cohort, topo = data
    port_cfg, jax_cfg = _tcfg(**over), JaxTC(**{
        k: v for k, v in dataclasses.asdict(_tcfg(**over)).items()
        if k not in ("loss", "sparsity")})
    if permut:
        variants = [(s, cohort) for s in SEEDS]
        got = _raised(cross_validation_permut_batch, variants, topo, MCFG,
                      port_cfg, res_dirs=["a", "b"], device="cpu")
        want = _raised(jax_permut, variants, topo, None, jax_cfg,
                       res_dirs=["a", "b"])
    else:
        got = _raised(cross_validation_seed_batch, cohort, SEEDS, topo, MCFG,
                      port_cfg, res_dirs=["a", "b"], device="cpu")
        want = _raised(jax_seed, cohort, SEEDS, topo, None, jax_cfg,
                       res_dirs=["a", "b"])
    assert got == want


def test_permut_batch_rejects_variants_that_differ_beyond_the_scores(data):
    cohort, topo = data
    other = dataclasses.replace(cohort, x=cohort.x + 1.0)
    got = _raised(cross_validation_permut_batch, [(1, cohort), (2, other)],
                  topo, MCFG, _tcfg(is_permut_test=True), res_dirs=["a", "b"],
                  device="cpu")
    assert got == ("permut-batch variant 2 disagrees with the first variant "
                   "on cohort field 'x'; only the subject->score pairing may "
                   "differ across seeds")


@pytest.mark.parametrize("seeds,folds,entries", [
    (list(range(10)), 5, 64), (list(range(10)), 5, 0), (list(range(10)), 5, 7),
    ([1, 2, 3], 3, 3), ([4], 5, 1)])
def test_seed_chunks_are_the_jax_clis(seeds, folds, entries):
    assert (port_main.seed_chunks(seeds, folds, entries)
            == jax_main._seed_chunks(seeds, folds, entries))


BAD_LINES = [
    ["--fold_parallel", "--no_fold_scan"],
    ["--spmd_batch_entries", "-1"],
    ["--cv_seeds", "1:2", "--permut_seeds", "1:2"],
    ["--cv_seeds", "1:2", "--isPermutTest"],
    ["--cv_seeds", "1:2", "--isTestAdnitype"],
    ["--cv_seeds", "3:1"], ["--cv_seeds", "a,b"], ["--cv_seeds", "1,1"],
    ["--permut_seeds", "-1,2"], ["--permut_seeds", ","],
    ["--permut_seeds", "1:2", "--export_bundle"],
    ["--model", "GCN_IMGSNP", "--init_from_torch", "x.pt"],
    ["--init_from_torch", "x.pt", "--cv_seeds", "1:2"],
]


@pytest.mark.parametrize("argv", BAD_LINES, ids=" ".join)
def test_cli_errors_are_the_jax_clis(argv, tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    messages = []
    for run, extra in ((jax_main.main, []),
                       (port_main.main, ["--device", "cpu"])):
        with pytest.raises(SystemExit) as info:
            run(argv + extra)
        assert info.value.code == 2
        err = capsys.readouterr().err
        messages.append(re.search(r"error: (.*)$", err, re.S).group(1))
    assert messages[0] == messages[1]
    assert not os.listdir(tmp_path)


def _argv(appendix, *extra, subjects=40):
    return ["--device", "cpu", "--synthetic", "--synthetic_subjects",
            str(subjects), "--epochs", "1", "--fold", "3", "--batch_size", "8",
            "--no-search", "--layers", "2", "--hiddens", "8",
            "--lambda_disease", "1.0", "--save_appendix", appendix,
            "--cohort_cache_dir", "", *extra]


def test_cli_seed_routes_chunk_and_name_dirs(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    port_main.main(_argv("_s", "--fold_parallel", "--cv_seeds", "1:3",
                         "--spmd_batch_entries", "6"))
    out = capsys.readouterr().out
    assert ("[cv_seeds] 3 seeds x 3 folds exceeds --spmd_batch_entries 6; "
            "running 2 batched programs of <= 2 seeds") in out
    assert re.search(r"^Replication over 3 seeds - acc [\d.]+ \+/- [\d.]+ "
                     r"\(per-seed: 1:[\d.]+, 2:[\d.]+, 3:[\d.]+\)$", out, re.M)
    assert ("[cv_seeds] aggregate across seeds with: python -m "
            "iggcn_tpu_torch.tools.report results/ADNI_s_seed*") in out
    port_main.main(_argv("_u", "--fold_parallel", "--cv_seeds", "1:3",
                         "--spmd_batch_entries", "0"))
    assert "exceeds" not in capsys.readouterr().out
    for s in (1, 2, 3):
        _same_dirs(tmp_path / "results" / f"ADNI_s_seed{s}",
                   tmp_path / "results" / f"ADNI_u_seed{s}")
    port_main.main(_argv("_p", "--fold_parallel", "--permut_seeds", "1,2",
                         "--spmd_batch_entries", "3"))
    out = capsys.readouterr().out
    assert ("[permut] 2 seeds x 3 folds exceeds --spmd_batch_entries 3; "
            "running 2 batched programs of <= 1 seeds") in out
    assert out.rstrip().endswith(
        "[permut] 2 null runs done (one batched program per configuration); "
        "p-values: python -m iggcn_tpu_torch.tools.report <observed_dir> "
        "--permut_null results_permuttest/ADNI_p_permut*")
    assert sorted(os.listdir(tmp_path / "results_permuttest")) == [
        "ADNI_p_permut1", "ADNI_p_permut2"]
    # the sequential permutation route: one seed after the other, the same
    # records as the batch
    port_main.main(_argv("_q", "--permut_seeds", "1,2"))
    assert "[permut] null run 2/2 (Seed4PermutTest=2)" in \
        capsys.readouterr().out
    for s in (1, 2):
        _same_dirs(tmp_path / "results_permuttest" / f"ADNI_p_permut{s}",
                   tmp_path / "results_permuttest" / f"ADNI_q_permut{s}")
    env = (tmp_path / "results" / "ADNI_s_seed2" / "env.txt").read_text()
    lines = env.splitlines()
    assert lines[0].startswith("python ") and lines[-1] == "---"
    assert lines[1].startswith(f"torch {torch.__version__} (CUDA ")
    assert lines[2] == f"numpy {np.__version__}"
    assert lines[3] == "device cpu (x1)"


def test_replication_line_is_the_jax_clis(capsys):
    seeds, accs = [1, 5, 9], [0.5, 0.625, 0.75]
    got_log, want_log = [], []
    port_main.replication_summary(seeds, accs, [got_log.append], "_x")
    got = capsys.readouterr().out.splitlines()
    jax_main._replication_summary(seeds, accs, [want_log.append], "_x")
    want = capsys.readouterr().out.splitlines()
    assert got[0] == want[0] == got_log[0] == want_log[0] == (
        "Replication over 3 seeds - acc 0.625 +/- 0.125 (per-seed: "
        "1:0.500, 5:0.625, 9:0.750)")
    assert got[1] == want[1].replace("iggcn_tpu.", "iggcn_tpu_torch.")


def test_cli_cv_seeds_zoo_and_snps_run_one_seed_after_the_other(
        tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    zoo = ["--device", "cpu", "--model", "GIN", "--data", "TUTEST",
           "--tu_root", os.path.join(REPO, "tests", "fixtures"), "--epochs",
           "1", "--fold", "3", "--batch_size", "4", "--no-search",
           "--layers", "2", "--hiddens", "8"]
    accs = port_main.main(zoo + ["--save_appendix", "_z", "--cv_seeds",
                                 "1:2", "--fold_parallel"])
    out = capsys.readouterr().out
    assert ("[cv_seeds] --fold_parallel is a fused-family SPMD path; --model "
            "GIN replicates sequentially") in out
    assert "[cv_seeds] replication 2/2 (seed 2) -> results/ADNI_z_seed2" in out
    assert f"per-seed: 1:{accs[0]:.3f}, 2:{accs[1]:.3f})" in out
    # each seed as its standalone run (the TU data do not depend on --seed)
    for s in (1, 2):
        port_main.main(zoo + ["--save_appendix", f"_a{s}", "--seed", str(s)])
        want = capsys.readouterr().out
        result = re.search(r"^Result - .*$", want, re.M).group(0)
        log = (tmp_path / "results" / f"ADNI_z_seed{s}" / "log.txt").read_text()
        assert result in log.splitlines()
        _same_dirs(tmp_path / "results" / f"ADNI_z_seed{s}",
                   tmp_path / "results" / f"ADNI_a{s}")
    accs = port_main.main(["--device", "cpu", "--model", "MLP_Model",
                           "--synthetic", "--synthetic_subjects", "40",
                           "--disease_id", "0", "--epochs", "1", "--fold",
                           "3", "--batch_size", "8", "--save_appendix", "_m",
                           "--cohort_cache_dir", "", "--cv_seeds", "4,6"])
    out = capsys.readouterr().out
    assert len(accs) == 2
    assert len(re.findall(r"^Result - .* \(SNP-only, MLP_Model\)$", out,
                          re.M)) == 2
    assert "Replication over 2 seeds - acc" in out
    for s in (4, 6):
        assert glob.glob(str(tmp_path / "results" / f"ADNI_m_seed{s}"
                             / "fold_result_*.npz"))


def test_dedup_cohort_aliases_the_seed_invariant_fields(data):
    cohort, _ = data
    variant = permute_regression_targets(cohort, 5)
    variant = dataclasses.replace(variant, x=variant.x.copy())
    deduped = port_main.dedup_cohort(cohort, variant)
    assert deduped.x is cohort.x and deduped.adj is cohort.adj
    assert deduped.clini_score is variant.clini_score
