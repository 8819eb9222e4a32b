"""Port host data (`iggcn_tpu_torch/data/`, `train/fold_loop.fold_perms`)
and the training configs against the JAX package, on the same seeds:
splits, padding, epoch permutations, KNN imputation and the NumPy
diffusion bit-equal, the default `auto` diffusion bit-equal to the JAX
package's; the synthetic cohort bit-equal; the config dataclasses with the same fields and
defaults."""
import dataclasses

import numpy as np
import pytest

from iggcn_tpu import config as jax_config
from iggcn_tpu.data import adni as jax_adni
from iggcn_tpu.data import batching as jax_batching
from iggcn_tpu.data import diffusion as jax_diffusion
from iggcn_tpu.data import impute as jax_impute
from iggcn_tpu.data import splits as jax_splits
from iggcn_tpu.train.cv import _fold_perms
from iggcn_tpu_torch import config
from iggcn_tpu_torch.data import adni, batching, diffusion, impute, splits
from iggcn_tpu_torch.train.fold_loop import fold_perms


@pytest.fixture(scope="module")
def cohorts():
    return (jax_adni.synthetic_cohort(np.random.default_rng(4),
                                      num_subjects=40),
            adni.synthetic_cohort(np.random.default_rng(4), num_subjects=40))


def _same_splits(a, b):
    assert len(a) == len(b)
    for sa, sb in zip(a, b):
        for u, v in zip(sa, sb):
            np.testing.assert_array_equal(u, v)


@pytest.mark.parametrize("n,classes,folds,seed", [
    (40, 2, 3, 1000), (40, 3, 5, 7), (97, 3, 5, 3), (874, 3, 5, 1000)])
def test_k_fold_is_bit_equal(n, classes, folds, seed):
    y = np.random.default_rng(seed).integers(0, classes, n)
    _same_splits(jax_splits.k_fold(y, folds, seed), splits.k_fold(y, folds, seed))


def test_pad_to_batches_and_fold_perms_are_bit_equal(cohorts):
    jc, pc = cohorts
    want = jax_batching.pad_to_batches(
        {k: v for k, v in jax_batching.cohort_batch_arrays(jc).items()}, 16)
    got = batching.pad_to_batches(batching.cohort_batch_arrays(pc), 16)
    assert want.keys() == got.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    np.testing.assert_array_equal(fold_perms(1000, 4, 2, 27, 32),
                                  _fold_perms(1000, 4, 2, 27, 32))


def test_knn_imputation_is_bit_equal(cohorts):
    _, pc = cohorts
    demo = pc.demographics
    assert np.isnan(demo).any()
    for tr, te, va in splits.k_fold(pc.y, 3, 1000):
        for parts in ([demo[tr], demo[va], demo[te]], [demo[tr], demo[te]]):
            want = jax_impute.knn_impute_scores(parts, pc.scaler4score)
            got = impute.knn_impute_scores(parts, pc.scaler4score)
            for g, w in zip(got, want):
                assert g.dtype == w.dtype
                np.testing.assert_array_equal(g, w)
        one = impute.knn_impute_scores([demo[tr], demo[te]],
                                       pc.scaler4score, 7)
        np.testing.assert_array_equal(
            one[1], jax_impute.knn_impute_scores([demo[tr], demo[te]],
                                                 pc.scaler4score, 7)[1])


@pytest.mark.parametrize("is_ppr,is_topk", [(True, True), (False, True),
                                            (True, False)])
def test_numpy_diffusion_is_bit_equal(cohorts, is_ppr, is_topk):
    raw = cohorts[1].raw_adj[:3]
    modes = {"is_ppr": is_ppr, "is_topk": is_topk}
    want = diffusion.preprocess_diffusion(raw, backend="numpy", **modes)
    np.testing.assert_array_equal(
        want, jax_diffusion.preprocess_diffusion(raw, backend="numpy",
                                                 **modes))
    # the default is `auto` in both packages, and bit-equal between them:
    # the native library for PPR + top-k, numpy for the other modes
    got = diffusion.preprocess_diffusion(raw, **modes)
    np.testing.assert_array_equal(
        got, jax_diffusion.preprocess_diffusion(raw, **modes))
    if not (is_ppr and is_topk):
        np.testing.assert_array_equal(got, want)
        with pytest.raises(ValueError, match="PPR\\+top-k"):
            diffusion.preprocess_diffusion(raw, backend="device",
                                           device="cpu", **modes)
        return
    # for PPR + top-k the native library and the fp32 batched solve agree
    # with numpy (within 1e-12 and 2e-5) with the same sparsity
    for backend, atol in (("auto", 1e-12), ("device", 2e-5)):
        got = diffusion.preprocess_diffusion(raw, backend=backend,
                                             device="cpu")
        np.testing.assert_allclose(got, want, rtol=0, atol=atol)
        assert ((got > 0) == (want > 0)).all()


def test_synthetic_cohort_matches(cohorts):
    jc, pc = cohorts
    for f in dataclasses.fields(jc):
        want, got = getattr(jc, f.name), getattr(pc, f.name)
        if f.name == "scaler4score":
            for attr in ("data_min_", "data_max_", "scale_"):
                np.testing.assert_array_equal(getattr(got, attr),
                                              getattr(want, attr))
        elif isinstance(want, np.ndarray):
            assert got.dtype == want.dtype, f.name
            # bit-equal, adj included: both packages diffuse it through
            # the `auto` backend's native library
            np.testing.assert_array_equal(got, want, err_msg=f.name)
        else:
            assert got == want, f.name
    np.testing.assert_array_equal(pc.adj != 0, jc.adj != 0)
    np.testing.assert_array_equal(adni.CLINICAL_SELECT_INDEX,
                                  jax_adni.CLINICAL_SELECT_INDEX)
    assert adni.SCORE_NAMES_ALL == jax_adni.SCORE_NAMES_ALL
    assert adni.SCORE_NAMES_DEFAULT == jax_adni.SCORE_NAMES_DEFAULT


@pytest.mark.parametrize("name", ["TrainConfig", "LossWeights",
                                  "SparsityWeights", "DataConfig"])
def test_training_configs_match(name):
    port, ref = getattr(config, name), getattr(jax_config, name)
    assert ([f.name for f in dataclasses.fields(port)]
            == [f.name for f in dataclasses.fields(ref)])
    assert dataclasses.asdict(port()) == dataclasses.asdict(ref())
    if name == "DataConfig":
        for d in range(4):
            assert port(disease_id=d).num_classes == ref(disease_id=d).num_classes
