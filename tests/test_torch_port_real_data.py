"""The port's real-cohort route against the JAX package on the CPU:

  * the loaders (`iggcn_tpu_torch/data/adni.py`): `load_adni874` over a
    fabricated reference `.mat` layout for every disease_id, a single
    clinical score, the permutation shuffle, multi-fusion and each
    similarity source, and `load_adni_csv`, field for field bit-equal to
    the JAX loaders, except the diffused `adj` at atol 1e-6 (the JAX
    package may take its C++ diffusion, `iggcn_tpu/data/diffusion.py:86`);
  * `separate_data_adnitype` and `permute_regression_targets` bit-equal;
  * the processed-cohort cache (`data/cohort_cache.py`): the same keys,
    and an entry written by either package loads equal in the other;
  * `cross_validation` with an external test cohort and as a permutation
    test, held against the JAX CV under `tests/test_torch_port_cv.py`'s
    rules (one set of flax variables, dropout 0, losses rtol 2e-4, the same
    score matrix and artifact names, none for a permutation run), with
    fold records that cross between the packages;
  * the CLI (`python -m iggcn_tpu_torch.main --device cpu`) on the
    fabricated 90-ROI layout and GO fixture: the `Result -` line, the JAX
    CLI's artifact names, a cache hit on the second run with a
    byte-identical log.txt; `--isPermutTest`, `--isTestAdnitype`, the
    `--synthetic_go_levels` parser errors and the JAX CLI's command lines
    of these routes."""
import dataclasses
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.io as sio
import torch

from iggcn_tpu.config import DataConfig as JaxDC
from iggcn_tpu.config import LossWeights as JaxLW
from iggcn_tpu.config import ModelConfig as JaxMC
from iggcn_tpu.config import TrainConfig as JaxTC
from iggcn_tpu.data import adni as jax_adni
from iggcn_tpu.data import cohort_cache as jax_cache
from iggcn_tpu.data.go_graph import synthetic_topology as jax_topology
from iggcn_tpu.models.fused_sgcn import FusedSGCN as JaxFused
from iggcn_tpu.train.cv import cross_validation as jax_cv
from iggcn_tpu_torch import main as port_main
from iggcn_tpu_torch.config import (DataConfig, LossWeights, ModelConfig,
                                    TrainConfig)
from iggcn_tpu_torch.data import adni, cohort_cache
from iggcn_tpu_torch.data.go_graph import synthetic_topology
from iggcn_tpu_torch.train.cv import cross_validation
from tests.test_cli_real_data import _write_go_fixture
from tests.test_real_loaders import _write_mat_cohort

S, N = 30, 12
ARRAYS = ("x", "raw_adj", "y", "clust_y", "snps", "sbj_id", "tsne_fdim",
          "clini_score", "demographics", "raw_y", "adni_type")
MODEL = dict(num_layers=2, hidden=8, hidden_linear=16, l_dim=8,
             num_classes=2, dropout_lin=0.0, dropout_regr=0.0,
             dropout_go=0.0, dropout_readout=0.0)
LOSS = dict(disease=1.0, regr=1.0, prob=0.5, reco=1.5e-6, simi=0.1, orth=0.1)
TRAIN = dict(epochs=2, batch_size=8, folds=3, lr=3e-3, weight_decay=1e-2,
             lr_decay_step_size=1)
LINE = re.compile(r"Fold: (\d+), epoch:(\d+), train_loss: ([-\d.naninf]+), "
                  r"val_loss: ([-\d.naninf]+), test_loss: ([-\d.naninf]+)")


@pytest.fixture(autouse=True, scope="module")
def fast_compiles():
    before = jax.config.read("jax_disable_most_optimizations")
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", before)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def mat_layout(tmp_path_factory):
    """The reference layout with raw labels over all five classes, every
    similarity source and the three multi-fusion modality dirs."""
    base = str(tmp_path_factory.mktemp("adnimat")) + os.sep
    rng = np.random.default_rng(11)
    _write_mat_cohort(base, rng, s=S, n=N)
    kdir = os.path.join(base, "knn", "5")
    sio.savemat(os.path.join(kdir, "BL_DXGrp_label.mat"),
                {"BL_DXGrp_label": (np.arange(S) % 5 + 1).reshape(-1, 1)})
    holes = rng.normal(size=(S, 9))
    holes[rng.random(holes.shape) < 0.15] = np.nan
    sio.savemat(os.path.join(kdir, "score_excel_val_adni874.mat"),
                {"info_score_val_subs": holes})
    for name in ("multimodal_for_similarity", "tsne_results"):
        np.save(os.path.join(kdir, f"{name}.npy"),
                rng.normal(size=(S, 8)).astype(np.float32))
    for mod in ("MRI", "FDG-PET", "AV45-PET"):
        mdir = os.path.join(base, mod, "knn", "5")
        os.makedirs(mdir)
        sio.savemat(os.path.join(mdir, "corr_data.mat"), {
            "corr_data": np.abs(rng.normal(size=(S, N, N))) + 0.1})
    return base


def _assert_same_cohort(got, want, adj_atol=1e-6):
    for field in ARRAYS:
        a, b = getattr(got, field), getattr(want, field)
        assert (a is None) == (b is None), field
        if b is not None:
            assert a.dtype == b.dtype and a.shape == b.shape, field
            np.testing.assert_array_equal(a, b, err_msg=field)
    assert got.adj.dtype == want.adj.dtype
    np.testing.assert_allclose(got.adj, want.adj, rtol=0, atol=adj_atol)
    assert got.num_classes == want.num_classes
    for attr in ("data_min_", "data_max_", "scale_"):
        np.testing.assert_array_equal(getattr(got.scaler4score, attr),
                                      getattr(want.scaler4score, attr))


def _to_port(cohort):
    """A JAX-package cohort as the port's AdniCohort, array for array."""
    scaler = adni.MinMaxScaler()
    scaler.__dict__.update(vars(cohort.scaler4score))
    fields = {f.name: getattr(cohort, f.name)
              for f in dataclasses.fields(cohort)}
    return adni.AdniCohort(**{**fields, "scaler4score": scaler})


LOADER_CASES = {
    "disease 0": dict(disease_id=0),
    "disease 1": dict(disease_id=1),
    "disease 2": dict(disease_id=2),
    "disease 3": dict(disease_id=3),
    "one clinical score": dict(disease_id=3, clinical_score_index=5),
    "permutation test": dict(disease_id=3, is_permut_test=True,
                             seed4permut_test=4),
    "multi-fusion": dict(disease_id=0, is_multi_fusion=True),
    "multimodal similarity": dict(disease_id=3,
                                  is_multimodal4similarity=True),
    "t-SNE similarity": dict(disease_id=1, is_use_tsne4similar=True),
    "heat kernel": dict(disease_id=2, is_ppr=False),
}


@pytest.mark.parametrize("case", LOADER_CASES)
def test_load_adni874_matches_jax(mat_layout, case):
    kw = dict(data_path=mat_layout, knn=5, **LOADER_CASES[case])
    got = adni.load_adni874(DataConfig(**kw))
    _assert_same_cohort(got, jax_adni.load_adni874(JaxDC(**kw)))
    assert np.isnan(got.demographics).any()


@pytest.mark.parametrize("disease_id", [0, 2])
def test_load_adni_csv_matches_jax(tmp_path, disease_id):
    rng = np.random.default_rng(2)
    base = tmp_path / {0: "data_AH", 2: "data_AM"}[disease_id]
    kdir = base / "knn" / "5"
    kdir.mkdir(parents=True)
    rows = rng.random((S, 54))
    rows[1, 3] = np.nan
    np.savetxt(base / "snp.csv", rows, delimiter=",", comments="",
               header=",".join(f"snp{i}" for i in range(54)))
    sio.savemat(str(kdir / "BL_DXGrp_label.mat"),
                {"BL_DXGrp_label": (np.arange(S) % 2).reshape(-1, 1)})
    sio.savemat(str(kdir / "corr_data.mat"),
                {"corr_data": np.abs(rng.normal(size=(S, N, N))) + 0.1})
    sio.savemat(str(kdir / "imgData_mat_normalized_fix.mat"),
                {"imgData_mat_normalized": rng.normal(size=(S, N, 3))})
    kw = dict(data_path=str(tmp_path), knn=5, disease_id=disease_id)
    _assert_same_cohort(adni.load_adni_csv(DataConfig(**kw)),
                        jax_adni.load_adni_csv(JaxDC(**kw)))


@pytest.fixture(scope="module")
def synthetic():
    """(JAX cohort, the same arrays as the port's cohort)."""
    jc = jax_adni.synthetic_cohort(np.random.default_rng(5), num_subjects=60)
    return jc, _to_port(jc)


@pytest.mark.parametrize("disease_id,adnitype_id", [(0, 0), (1, 1), (2, 0)])
def test_adnitype_split_matches_jax(synthetic, disease_id, adnitype_id):
    jc, pc = synthetic
    got = adni.separate_data_adnitype(pc, disease_id, adnitype_id)
    want = jax_adni.separate_data_adnitype(jc, disease_id, adnitype_id)
    for g, w in zip(got, want):
        _assert_same_cohort(g, w, adj_atol=0)
    assert set(got[1].sbj_id) == set(pc.sbj_id[pc.adni_type == adnitype_id])


def test_adnitype_split_refusals_match_jax(synthetic):
    jc, pc = synthetic
    for split, cohort in ((adni.separate_data_adnitype, pc),
                          (jax_adni.separate_data_adnitype, jc)):
        with pytest.raises(ValueError, match="disease_id 0-2"):
            split(cohort, 3)
        with pytest.raises(ValueError, match="raw_y and adni_type"):
            split(dataclasses.replace(cohort, adni_type=None), 0)


@pytest.mark.parametrize("seed", [1, 3])
def test_permutation_matches_jax(synthetic, seed):
    jc, pc = synthetic
    got = adni.permute_regression_targets(pc, seed)
    _assert_same_cohort(got, jax_adni.permute_regression_targets(jc, seed),
                        adj_atol=0)
    assert not np.array_equal(got.clini_score, pc.clini_score)


KEY_CASES = {
    "synthetic": ("synthetic", dict(seed=1000, num_subjects=874, rois=90,
                                    feat_dim=3, num_classes=3, num_regr=3,
                                    top_k=3)),
    "synthetic multi-fusion": ("synthetic", dict(
        seed=7, num_subjects=40, rois=270, feat_dim=1, num_classes=2,
        num_regr=1, top_k=5)),
    "adni874": ("adni874", dict(
        files=(("knn/5/a.mat", 10, 123456789),), data_path="/x/y",
        disease_id=0, knn=5, num_cluster=2, clinical_score_index=-1,
        is_ppr=True, is_topk=True, top_k=3, ppr_alpha=0.05, heat_t=5.0,
        is_multimodal4similarity=False, is_use_tsne4similar=False,
        is_multi_fusion=False, is_permut_test=True, seed4permut_test=2)),
}


@pytest.mark.parametrize("case", KEY_CASES)
def test_cohort_keys_match_jax(case):
    kind, params = KEY_CASES[case]
    assert cohort_cache.cohort_key(kind, **params) == jax_cache.cohort_key(
        kind, **params)


def test_cache_entries_cross_between_packages(tmp_path, synthetic,
                                              mat_layout):
    jc, pc = synthetic
    assert cohort_cache.FORMAT_VERSION == jax_cache.FORMAT_VERSION
    assert ({f.name for f in dataclasses.fields(adni.AdniCohort)}
            == {f.name for f in dataclasses.fields(jax_adni.AdniCohort)})
    assert cohort_cache.dir_fingerprint(mat_layout) == \
        jax_cache.dir_fingerprint(mat_layout)
    jax_cache.save_cohort(jc, str(tmp_path / "jax.npz"))
    cohort_cache.save_cohort(pc, str(tmp_path / "port.npz"))
    assert cohort_cache.equal_cohorts(
        cohort_cache.load_cohort(str(tmp_path / "jax.npz")), pc)
    assert jax_cache.equal_cohorts(
        jax_cache.load_cohort(str(tmp_path / "port.npz")), jc)
    without = dataclasses.replace(pc, raw_y=None, adni_type=None)
    cohort_cache.save_cohort(without, str(tmp_path / "none.npz"))
    back = jax_cache.load_cohort(str(tmp_path / "none.npz"))
    assert back.raw_y is None and back.adni_type is None


def test_load_or_build_miss_hit_and_corrupt_entry(tmp_path, synthetic):
    _, pc = synthetic
    calls = []

    def build():
        calls.append(1)
        return pc

    first, hit1 = cohort_cache.load_or_build(str(tmp_path), "k", build)
    second, hit2 = cohort_cache.load_or_build(str(tmp_path), "k", build)
    assert (hit1, hit2, len(calls)) == (False, True, 1)
    assert cohort_cache.equal_cohorts(second, pc)
    (tmp_path / "k.npz").write_bytes(b"not an npz")
    third, hit3 = cohort_cache.load_or_build(str(tmp_path), "k", build)
    assert not hit3 and len(calls) == 2
    assert cohort_cache.load_or_build("", "k", build)[1] is False


def test_cli_synthetic_key_is_the_jax_cli_key(tmp_path, monkeypatch, capsys):
    """The default synthetic route keys its entry as the JAX CLI does
    (`main.py:744-748`); other `--synthetic_go_levels` get their own."""
    monkeypatch.chdir(tmp_path)
    want = jax_cache.cohort_key("synthetic", seed=5, num_subjects=20,
                                rois=90, feat_dim=3, num_classes=2,
                                num_regr=3, top_k=3)
    for levels in (None, "12,8,5,3,1"):
        argv = ["--synthetic", "--synthetic_subjects", "20", "--seed", "5",
                "--disease_id", "0", "--cohort_cache_dir", "cache"]
        if levels:
            argv += ["--synthetic_go_levels", levels]
        args = port_main.build_parser().parse_args(argv)
        port_main.load_cohort(args, port_main.build_dcfg(args),
                              np.random.default_rng(5))
    names = sorted(os.listdir(tmp_path / "cache"))
    assert len(names) == 2 and f"{want}.npz" in names
    args = port_main.build_parser().parse_args(argv)
    _, topo = port_main.load_cohort(args, port_main.build_dcfg(args),
                                    np.random.default_rng(5))
    assert topo.pool == [12, 8, 5, 3, 1]
    assert "cohort loaded from cache (synthetic-" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# cross-validation: external test cohort, permutation test


@pytest.fixture(scope="module")
def warm():
    jmodel = JaxFused(cfg=JaxMC(**MODEL),
                      topo=jax_topology(np.random.default_rng(0)))
    variables = jax.device_get(jax.jit(jmodel.init)(
        jax.random.PRNGKey(3), jnp.zeros((8, 90, 3)), jnp.zeros((8, 90, 90)),
        jnp.zeros((8, 54))))
    return variables["params"], variables["batch_stats"], "shared"


def _epochs(lines):
    return {(int(m[1]), int(m[2])): tuple(map(float, m.group(3, 4, 5)))
            for m in map(LINE.match, lines) if m}


def _both_cvs(tmp_path, warm, mode):
    """The JAX CV and the port's CV over the same cohort (each package
    draws its own, bit-equal but for adj's rounding) from one set of
    weights: `mode` 'external' tests every fold on the held-out ADNI
    type, 'permut' is a permutation test."""
    runs = {}
    for side, cv, mk_cohort, topology, split, permute, mcfg, tcfg, kw in (
            ("jax", jax_cv, jax_adni.synthetic_cohort, jax_topology,
             jax_adni.separate_data_adnitype,
             jax_adni.permute_regression_targets, JaxMC(**MODEL),
             JaxTC(**TRAIN, is_permut_test=mode == "permut",
                   loss=JaxLW(**LOSS)), {}),
            ("port", cross_validation, adni.synthetic_cohort,
             synthetic_topology, adni.separate_data_adnitype,
             adni.permute_regression_targets, ModelConfig(**MODEL),
             TrainConfig(**TRAIN, is_permut_test=mode == "permut",
                         loss=LossWeights(**LOSS)), {"device": "cpu"})):
        cohort = mk_cohort(np.random.default_rng(1), num_subjects=80)
        if mode == "external":
            cohort, kw["external_test"] = split(cohort, 1, 0)
        else:
            cohort = permute(cohort, 3)
        lines = []
        res_dir = tmp_path / side
        # the JAX CV's permutation run writes its fold records into a
        # directory it does not create (its CLI creates it)
        res_dir.mkdir()
        result = cv(cohort, topology(np.random.default_rng(0)), mcfg, tcfg,
                    res_dir=str(res_dir), result_file_name="r",
                    logger=lines.append, warm_start=warm, **kw)
        runs[side] = (result, _epochs(lines), res_dir, mcfg, tcfg, cohort,
                      kw)
    return runs


@pytest.mark.parametrize("mode", ["external", "permut"])
def test_cross_validation_modes_match_jax(tmp_path, warm, mode, capsys):
    runs = _both_cvs(tmp_path, warm, mode)
    (want, want_ep, want_dir, *_), (got, got_ep, got_dir, mcfg, tcfg,
                                    cohort, kw) = runs["jax"], runs["port"]
    assert got_ep.keys() == want_ep.keys() and len(want_ep) == 6
    for key, w in want_ep.items():
        np.testing.assert_allclose(got_ep[key], w, rtol=2e-4, err_msg=str(key))
    np.testing.assert_allclose(got.score_result, want.score_result, atol=1e-6)
    np.testing.assert_allclose(got.mean_test_loss, want.mean_test_loss,
                               rtol=2e-4)
    assert round(got.best_acc, 3) == round(want.best_acc, 3)
    # the pooled regression metrics at the npy rule: a permutation run's
    # correlations are near 0, where the predictions' 1e-4 differences
    # after four Adam steps move them by more than 1e-4
    for name, vals in want.regression_summary.items():
        for k, v in vals.items():
            np.testing.assert_allclose(got.regression_summary[name][k], v,
                                       rtol=1e-3, atol=1e-3)
    names = sorted(os.listdir(want_dir))
    assert names == sorted(os.listdir(got_dir))
    npys = [n for n in names if n.endswith(".npy")]
    if mode == "permut":
        # fold records only: no checkpoint, bundle or npy artifact
        assert names == [f"fold_result_r_fold_{k}.npz" for k in range(3)]
    else:
        assert len(npys) == 22 and len(names) == 28
        held_out = kw["external_test"]
        np.testing.assert_array_equal(
            np.load(got_dir / "subids_r.npy"), np.tile(held_out.sbj_id, 3))
        for name in npys:
            np.testing.assert_allclose(np.load(got_dir / name),
                                       np.load(want_dir / name), rtol=1e-3,
                                       atol=1e-3, err_msg=name)
    for k in range(3):
        name = f"fold_result_r_fold_{k}.npz"
        with np.load(got_dir / name) as a, np.load(want_dir / name) as b:
            assert sorted(a.files) == sorted(b.files)
            np.testing.assert_array_equal(a["meta"], b["meta"])
            for part in ("hidden", "linear", "pred_scores", "true_scores",
                         "true_labels", "subid", "test_losses"):
                np.testing.assert_allclose(a[part], b[part], rtol=1e-3,
                                           atol=1e-3, err_msg=part)
            assert a["meta"][5] == (mode == "permut")
            assert a["meta"][6] == (mode == "external")
    # the JAX run's records resume in the port: nothing trained
    capsys.readouterr()
    again = cross_validation(cohort, synthetic_topology(
        np.random.default_rng(0)), mcfg, tcfg, res_dir=str(want_dir),
        result_file_name="r", warm_start=warm, resume=True, **kw)
    assert capsys.readouterr().out.count("training skipped") == 3
    np.testing.assert_array_equal(again.score_result, want.score_result)


# ---------------------------------------------------------------------------
# the CLI


@pytest.fixture(scope="module")
def real_layout(tmp_path_factory):
    root = tmp_path_factory.mktemp("real")
    base = str(root / "preprocessing") + os.sep
    os.makedirs(base)
    _write_mat_cohort(base, np.random.default_rng(3), s=24, n=90)
    return base, _write_go_fixture(root)


def _real_argv(real_layout, appendix, *extra):
    base, (jp, cp, sg) = real_layout
    return ["--device", "cpu", "--data_path", base, "--json_path", jp,
            "--go_connection_path", cp, "--snps_to_gene_path", sg, "--knn",
            "5", "--epochs", "2", "--fold", "3", "--batch_size", "8",
            "--disease_id", "0", "--no-search", "--layers", "2", "--hiddens",
            "8", "--save_appendix", appendix, *extra]


def test_cli_real_route_caches_and_writes_the_jax_artifacts(
        tmp_path, monkeypatch, capsys, real_layout):
    import main as jax_cli
    monkeypatch.chdir(tmp_path)
    port_main.main(_real_argv(real_layout, "_real1"))
    out1 = capsys.readouterr().out
    assert "cohort loaded from cache" not in out1
    assert re.search(r"^Result - \d\.\d{3} \+/- \d\.\d{3}, with 2 layers and "
                     r"8 hidden units and h = 2$", out1, re.M)
    port_main.main(_real_argv(real_layout, "_real2"))
    assert "cohort loaded from cache (adni874-" in capsys.readouterr().out
    log1, log2 = ((tmp_path / "results" / f"ADNI_real{i}" / "log.txt")
                  .read_text() for i in (1, 2))
    assert log1 == log2 and "Result - " in log1
    # the JAX CLI's run over the same layout writes the same file names
    jax_cli.main(_real_argv(real_layout, "_jax")[2:])
    capsys.readouterr()

    def names(appendix):
        return sorted(n for n in os.listdir(tmp_path / "results"
                                            / f"ADNI{appendix}")
                      if n.endswith((".npy", ".msgpack", ".npz")))

    assert names("_real1") == names("_jax") and len(names("_jax")) == 28


@pytest.mark.parametrize("levels", ["10,5,1", "20,10,6,3,2,1",
                                    "24,16,10,6,0", "24,16,x,6,1"])
def test_cli_refuses_go_levels_it_cannot_build(levels, capsys):
    with pytest.raises(SystemExit):
        port_main.build_parser().parse_args(["--synthetic_go_levels", levels])
    assert "five positive node counts" in capsys.readouterr().err


def test_cli_builds_the_go_levels_it_accepts(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    args = port_main.build_parser().parse_args(
        ["--synthetic", "--synthetic_subjects", "12", "--synthetic_go_levels",
         "30,20,10,5,1", "--cohort_cache_dir", ""])
    _, topo = port_main.load_cohort(args, port_main.build_dcfg(args),
                                    np.random.default_rng(0))
    assert topo.pool == [30, 20, 10, 5, 1] and topo.n == 66
    np.testing.assert_array_equal(topo.go_level, np.repeat(
        [4.0, 3.0, 2.0, 1.0, 0.0], [30, 20, 10, 5, 1]))


def test_cli_permutation_test(tmp_path, monkeypatch, capsys, real_layout):
    monkeypatch.chdir(tmp_path)
    port_main.main(_real_argv(real_layout, "_p", "--isPermutTest",
                              "--Seed4PermutTest", "3", "--epochs", "1"))
    assert "Result - " in capsys.readouterr().out
    assert not (tmp_path / "results").exists()
    written = sorted(os.listdir(tmp_path / "results_permuttest" / "ADNI_p"))
    assert written == ["cmd_input.txt", "env.txt"] + [
        f"fold_result_result_sgcn_img_snp_layers2_hidden8_h2_fold_{k}.npz"
        for k in range(3)] + ["log.txt"]
    with pytest.raises(SystemExit):
        port_main.main(_real_argv(real_layout, "_pb", "--isPermutTest",
                                  "--export_bundle"))
    assert "refusing to export" in capsys.readouterr().err


def test_cli_held_out_adni_type(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    argv = ["--device", "cpu", "--synthetic", "--synthetic_subjects", "60",
            "--epochs", "1", "--fold", "3", "--batch_size", "8",
            "--no-search", "--layers", "2", "--hiddens", "8",
            "--isTestAdnitype", "--adnitype_id", "1",
            "--disease_id4Adnitype", "1", "--save_appendix", "_t",
            "--cohort_cache_dir", ""]
    port_main.main(argv)
    assert "Result - " in capsys.readouterr().out
    args = port_main.build_parser().parse_args(argv)
    rng = np.random.default_rng(args.seed)
    full, _ = port_main.load_cohort(args, port_main.build_dcfg(args), rng)
    held_out = full.sbj_id[full.adni_type == 1]
    subids = np.load(tmp_path / "results" / "ADNI_t"
                     / "subids_result_sgcn_img_snp_layers2_hidden8_h2.npy")
    np.testing.assert_array_equal(subids, np.tile(held_out, 3))


# JAX CLI command lines of the routes this slice ports (`main.py` flags,
# the reference-compat no-ops included); each must parse in the port
JAX_COMMAND_LINES = [
    "--data_path D --json_path J --go_connection_path C --snps_to_gene_path "
    "G --knn 5 --no-isPPr --no-isTopK --isMultilModal4Similarity",
    "--isTestAdnitype --adnitype_id 1 --disease_id4Adnitype 2 --synthetic",
    "--isPermutTest --Seed4PermutTest 7 --cohort_cache_dir ''",
    "--init_from_torch ck.pt --no-search --layers 2 --hiddens 16",
    "--cuda 0 --cpu --clean --keep_old --reprocess --use_pallas_gcn "
    "--no_fold_scan",
]


@pytest.mark.parametrize("line", JAX_COMMAND_LINES)
def test_jax_cli_command_lines_parse(line):
    import shlex

    import main as jax_cli
    argv = shlex.split(line)
    jax_args = vars(jax_cli.build_parser().parse_args(argv))
    port_args = vars(port_main.build_parser().parse_args(argv))
    for key, value in port_args.items():
        if key in jax_args and key != "synthetic_go_levels":
            assert value == jax_args[key], key


def test_chip_smoke_tie_band():
    """`chip_smoke.activation_ties`: a card-vs-CPU flip is a tie within
    `TIE_ATOL` plus twice the CPU's own departure from float64 of the
    kink, and past that band a fault."""
    import chip_smoke

    def ties(card, cpu, exact):
        return chip_smoke.activation_ties(
            [torch.tensor([card])], [torch.tensor([cpu])],
            [torch.tensor([exact], dtype=torch.float64)])

    flips, near, excess = ties(-1e-3, 2e-3, 1e-3)      # band 2.1e-3
    assert (flips, near) == (1, pytest.approx(2e-3))
    assert excess < 0
    assert ties(-1e-3, 2e-3, 1.5e-3)[2] > 0            # band 1.1e-3
    assert ties(-5e-5, 5e-5, 5e-5)[2] < 0              # TIE_ATOL alone
    assert ties(1.0, 2.0, 1.5)[:2] == (0, 0.0)         # no flip
