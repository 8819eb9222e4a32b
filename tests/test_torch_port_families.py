"""The fused model families of the port against the JAX package on the same
weights (the port's own init, carried across by `tools/convert.py`) and the
same numpy batch, at small widths on the CPU:

  * every new model's flax tree round trip, and its eval-mode forward at
    rtol 1e-4 / atol 1e-5 and train-mode forward (batch statistics over the
    real rows) on the real rows at rtol 1e-4 / atol 1e-5 plus twice the
    port's own fp32-vs-float64 gap in that output
    (`SGCNImage` with GCN and GAT convs, `SGCNOri`, `GuideImgSnp` with
    `gumbel_zero`, `ClusterLabelSGCN`, the flagship with `use_gat`);
  * each family's objective over a 3-step trajectory against
    `make_train_step` with the JAX objective, per-step loss rtol 2e-4 (the
    pin of `tests/test_trajectory_parity.py`): GCN_IMGSNP, SGCN_GCN,
    SGCN_GAT, SGCN_Ori, GUIDE, CLUSTERLABEL and the flagship under
    `--isMultiFusion` (N=270, F0=1, through the plain stack);
  * the flagship's variant branches: the train-mode objective over both
    passes and the batch statistics it leaves, against `fused_objective`
    (their eval-mode forwards are pinned in `test_torch_port_fused_sgcn.py`);
  * the image family's cross-validation against the JAX `cross_validation`
    (3 folds x 1 epoch), and the port's CLI for `--isMultiFusion` and
    `--model SGCN_GCN`;
  * the synthetic multi-fusion cohort, bit-equal to the JAX one.

Dropout is 0 and GUIDE's Gumbel noise is zeroed on both sides: the two
packages' random streams cannot be aligned."""
import copy
import dataclasses
import re

import jax
import numpy as np
import pytest
import torch

from iggcn_tpu.config import LossWeights as JaxLW
from iggcn_tpu.config import ModelConfig as JaxMC
from iggcn_tpu.config import TrainConfig as JaxTC
from iggcn_tpu.data.adni import synthetic_cohort as jax_cohort
from iggcn_tpu.data.go_graph import synthetic_topology as jax_topology
from iggcn_tpu.models.clusterlabel import ClusterLabelSGCN as JaxCluster
from iggcn_tpu.models.fused_sgcn import FusedSGCN as JaxFused
from iggcn_tpu.models.guide import GuideImgSnp as JaxGuide
from iggcn_tpu.models.sgcn_image import SGCNImage as JaxSGCNImage
from iggcn_tpu.models.sgcn_image import SGCNOri as JaxSGCNOri
from iggcn_tpu.train import cv as jax_cv_module
from iggcn_tpu.train.steps import OBJECTIVES as JAX_OBJECTIVES
from iggcn_tpu.train.steps import TrainState as JaxState
from iggcn_tpu.train.steps import fused_objective as jax_fused_objective
from iggcn_tpu.train.steps import make_optimizer, make_train_step
from iggcn_tpu_torch import main as port_main
from iggcn_tpu_torch.config import LossWeights, ModelConfig, TrainConfig
from iggcn_tpu_torch.data.adni import synthetic_cohort
from iggcn_tpu_torch.data.batching import cohort_batch_arrays, pad_to_batches
from iggcn_tpu_torch.data.go_graph import synthetic_topology
from iggcn_tpu_torch.tools.convert import load_flax_variables, to_flax_variables
from iggcn_tpu_torch.train import cv as port_cv_module
from iggcn_tpu_torch.train import steps

STEPS, B = 3, 14
SMALL = dict(num_layers=2, hidden=8, hidden_linear=16, l_dim=8,
             dropout_lin=0.0, dropout_regr=0.0, dropout_go=0.0,
             dropout_readout=0.0)
LOSS = dict(disease=1.0, regr=1.0, prob=0.5, reco=1.5e-6, simi=0.1, orth=0.1)
# GUIDE reads prob as the SNP reconstruction's weight and reco as the
# image reconstruction's (the JAX package's own GUIDE trajectory test's
# weights): at prob=0.5 the summed SNP error (~6e4) makes fp32 itself
# depart from float64 by 3e-3 within three steps, in the port as in JAX
GUIDE_LOSS = dict(disease=1.0, regr=1.0, prob=1e-4, reco=1e-3, simi=0.1,
                  orth=0.0)
# lr 1e-3: at 3e-3 SGCN_Ori's relu -> batch-norm head is chaotic (the JAX
# package's own suite pins it for one step only): entries whose gradient is
# zero to rounding take Adam steps of +-lr in JAX's fp32 while the port's
# fp32 stays within 3e-6 of its float64, and the step-3 loss parts by 2 %
TRAIN = dict(epochs=STEPS, batch_size=B, lr=1e-3, weight_decay=1e-2,
             lr_decay_factor=0.5, lr_decay_step_size=1)
MULTI = dict(rois=270, feat_dim=1, is_multi_fusion=True)
# case -> (model kind, ModelConfig fields beyond SMALL)
FAMILIES = {
    "GCN_IMGSNP": ("gcn_imgsnp", {}),
    "SGCN_GCN": ("sgcn_image", {}),
    "SGCN_GAT": ("sgcn_image", {"use_gat": True}),
    "SGCN_Ori": ("sgcn_ori", {}),
    "GUIDE": ("guide_imgsnp", {}),
    "CLUSTERLABEL": ("clusterlabel", {}),
    "multi_fusion": ("sgcn_imgsnp", MULTI),
}


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
def topo():
    return synthetic_topology(np.random.default_rng(0))


@pytest.fixture(scope="module")
def batches():
    """Padded batches of B rows, 2 of them padding (the 12 subjects of
    seed 3: with the 10 of the same seed, fp32 itself departs from
    float64 by 8e-4 within three GUIDE steps, in the port as in JAX): 90
    ROIs x 3 and 270 x 1, with a 1-wide clinical score for the
    single-score variant."""
    out = {}
    for rois, feat in ((90, 3), (270, 1)):
        cohort = synthetic_cohort(np.random.default_rng(3),
                                  num_subjects=B - 2, rois=rois,
                                  feat_dim=feat)
        arrays = cohort_batch_arrays(cohort)
        arrays.pop("sbj_id")
        out[rois] = pad_to_batches(arrays, B)
    one = dict(out[90])
    one["clini"] = one["clini"][:, 1:2]
    out["one_score"] = one
    return out


def _quiet(model):
    """Dropout off and Gumbel noise zeroed on a port model."""
    for attr in ("dropout_lin", "dropout1", "dropout2"):
        if hasattr(model, attr):
            setattr(model, attr, 0.0)
    if hasattr(model, "gumbel_zero"):
        model.gumbel_zero = True
    return model


def _port_model(kind, mcfg, topo):
    """The port's model of `kind` from its own init, quiet."""
    return _quiet(port_cv_module.MODEL_FAMILIES[kind](
        mcfg, topo, generator=torch.Generator().manual_seed(5)))


def _jax_model(kind, jmcfg, jtopo):
    """The JAX package's model of `kind`, dropout off, Gumbel noise zeroed."""
    if kind in ("sgcn_imgsnp", "gcn_imgsnp"):
        return JaxFused(cfg=jmcfg, topo=jtopo)
    if kind == "guide_imgsnp":
        return JaxGuide(cfg=jmcfg, topo=jtopo, gumbel_zero=True)
    if kind == "clusterlabel":
        return JaxCluster(cfg=jmcfg, topo=jtopo)
    if kind == "sgcn_image":
        return JaxSGCNImage(num_layers=jmcfg.num_layers, hidden=jmcfg.hidden,
                            rois=jmcfg.rois, feat_dim=jmcfg.feat_dim,
                            num_classes=jmcfg.num_classes,
                            hidden_linear=jmcfg.hidden_linear,
                            use_gat=jmcfg.use_gat, dropout_lin=0.0)
    return JaxSGCNOri(h0=jmcfg.feat_dim, rois=jmcfg.rois,
                      num_classes=jmcfg.num_classes, dropout1=0.0,
                      dropout2=0.0)


def _pair(case, topo, **extra):
    kind, fields = FAMILIES[case]
    mcfg = ModelConfig(**SMALL, **fields, **extra)
    jmcfg = JaxMC(**SMALL, **fields, **extra)
    return (kind, mcfg, jmcfg, _port_model(kind, mcfg, topo),
            _jax_model(kind, jmcfg, jax_topology(np.random.default_rng(0))))


def _inputs(kind, batch):
    keys = ("x", "adj") if kind in ("sgcn_image", "sgcn_ori") else (
        "x", "adj", "snps")
    return [batch[k] for k in keys]


def _random_stats(variables, seed=7):
    """Random running statistics, so eval-mode batch norms are exercised."""
    rng = np.random.default_rng(seed)
    stats = jax.tree_util.tree_map_with_path(
        lambda p, a: (rng.uniform(0.5, 2.0, a.shape) if p[-1].key == "var"
                      else rng.normal(0, 0.3, a.shape)).astype(np.float32),
        variables["batch_stats"])
    return {"params": variables["params"], "batch_stats": stats}


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield "/".join(prefix + (k,)), np.asarray(v)


FORWARD_CASES = ["SGCN_GCN", "SGCN_GAT", "SGCN_Ori", "GUIDE", "CLUSTERLABEL",
                 "FUSED_GAT"]


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("case", FORWARD_CASES)
def test_new_models_forward_match_jax(topo, batches, case, train):
    if case == "FUSED_GAT":
        kind, mcfg, jmcfg, model, jmodel = _pair("GCN_IMGSNP", topo,
                                                 use_gat=True)
    else:
        kind, mcfg, jmcfg, model, jmodel = _pair(case, topo)
    batch = batches[90]
    variables = _random_stats(to_flax_variables(model))
    load_flax_variables(model, variables["params"], variables["batch_stats"])
    flat = dict(_flat(to_flax_variables(model)))
    for k, v in _flat(variables):
        np.testing.assert_array_equal(flat.pop(k), v, err_msg=k)
    assert not flat
    if not train:
        # every leaf under the JAX name and shape: the JAX model's own
        # variable tree, traced abstractly (no compile)
        tree = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0),
                              *_inputs(kind, batch))
        want = {"/".join(str(p.key) for p in path): leaf.shape
                for path, leaf in jax.tree_util.tree_leaves_with_path(
                    {c: tree.get(c, {}) for c in ("params", "batch_stats")})}
        assert {k: v.shape for k, v in _flat(variables)} == want
    kwargs = {"temperature": 0.1} if kind == "guide_imgsnp" else {}
    passes = [{}] if kind == "guide_imgsnp" else [{}, {"is_explain": True}]
    inputs = _inputs(kind, batch)

    def apply(variables, extra):
        if not train:
            return jmodel.apply(variables, *inputs, **kwargs, **extra), {}
        return jmodel.apply(variables, *inputs, train=True,
                            sample_weight=batch["w"], mutable=["batch_stats"],
                            rngs={"dropout": jax.random.PRNGKey(0)},
                            **kwargs, **extra)

    def port(m, dtype, extra):
        m.train(train)
        with torch.no_grad():
            out = m(*(torch.as_tensor(a).to(dtype) if a.dtype == np.float32
                      else torch.as_tensor(a) for a in inputs),
                    sample_weight=(torch.as_tensor(batch["w"]).to(dtype)
                                   if train else None), **kwargs, **extra)
        return (out._asdict() if hasattr(out, "_fields")
                else {"log_probs": out})

    real = batch["w"] > 0
    for extra in passes:
        want, mut = jax.jit(lambda v: apply(v, extra))(variables)
        want = (want._asdict() if hasattr(want, "_fields")
                else {"log_probs": want})
        got = port(model, torch.float32, extra)
        exact = (port(copy.deepcopy(model).double(), torch.float64, extra)
                 if train else None)
        assert got.keys() == want.keys()
        for name, w in want.items():
            w, g = np.asarray(w), got[name].numpy()
            atol = 1e-5
            if train:
                # the real rows only (a padding row's batch-normed values
                # are never read); train-mode batch statistics over 12
                # rows are ill-conditioned in fp32 (E[x^2] - E[x]^2), so
                # the bound adds twice the port's own fp32 rounding there,
                # measured against its float64 forward
                e = exact[name].numpy()
                if w.shape[:1] == real.shape:
                    w, g, e = w[real], g[real], e[real]
                atol += 2 * float(np.abs(g - e).max())
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=atol,
                                       err_msg=f"{case} {name} {extra}")
        if "batch_stats" in mut:
            got_stats = dict(_flat(to_flax_variables(model)["batch_stats"]))
            for k, w in _flat(jax.device_get(mut["batch_stats"])):
                np.testing.assert_allclose(got_stats[k], w, rtol=1e-4,
                                           atol=1e-5, err_msg=k)
            load_flax_variables(model, variables["params"],
                                variables["batch_stats"])


def _jax_trajectory(kind, jmcfg, jmodel, variables, batch, jtcfg):
    optimizer = make_optimizer(jtcfg)
    step = jax.jit(make_train_step(jmodel, jmcfg, jtcfg, optimizer,
                                   JAX_OBJECTIVES[kind]))
    state = JaxState.create(variables, optimizer, steps_per_epoch=1)
    out = []
    for i in range(STEPS):
        state, loss_sum = step(state, batch, jax.random.PRNGKey(i))
        out.append(float(loss_sum))
    return out


@pytest.mark.parametrize("case", sorted(FAMILIES))
def test_three_step_trajectory_matches_make_train_step(topo, batches, case):
    kind, mcfg, jmcfg, model, jmodel = _pair(case, topo)
    batch = batches[mcfg.rois]
    variables = to_flax_variables(model)
    loss = GUIDE_LOSS if kind == "guide_imgsnp" else LOSS
    want = _jax_trajectory(kind, jmcfg, jmodel, variables, batch,
                           JaxTC(**TRAIN, loss=JaxLW(**loss)))
    tcfg = TrainConfig(**TRAIN, loss=LossWeights(**loss))
    state = steps.TrainState(model, tcfg, steps_per_epoch=1, kind=kind)
    tbatch = {k: torch.as_tensor(v) for k, v in batch.items()}
    got = [float(steps.train_step(state, tbatch, mcfg, tcfg, None))
           for _ in range(STEPS)]
    np.testing.assert_allclose(got, want, rtol=2e-4)
    assert abs(want[0] - want[-1]) > 1e-3 * abs(want[0])


VARIANTS = {
    "image_only": {"is_image_only": True},
    "snps_only": {"is_snps_only": True},
    "no_cross_atten": {"is_cross_atten": False},
    "no_soft_similarity": {"is_soft_similarity": False},
    "model4eachregr": {"model4eachregr": True},
    "no_prob4regr": {"is_use_prob4regr": False},
    "one_clinical_score": {"num_regr": 1},
}


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_flagship_variant_objective_matches_jax(topo, batches, variant):
    fields = VARIANTS[variant]
    mcfg = ModelConfig(**SMALL, **fields)
    jmcfg = JaxMC(**SMALL, **fields)
    tcfg = TrainConfig(**TRAIN, loss=LossWeights(**LOSS))
    jtcfg = JaxTC(**TRAIN, loss=JaxLW(**LOSS), dual_pass_vmap=False)
    batch = batches["one_score" if variant == "one_clinical_score" else 90]
    model = _port_model("sgcn_imgsnp", mcfg, topo)
    variables = _random_stats(to_flax_variables(model))
    load_flax_variables(model, variables["params"], variables["batch_stats"])
    jmodel = JaxFused(cfg=jmcfg, topo=jax_topology(np.random.default_rng(0)))

    @jax.jit
    def objective(params, stats):
        loss, aux = jax_fused_objective(jmodel, params, stats, batch, jmcfg,
                                        jtcfg, train=True,
                                        rng=jax.random.PRNGKey(0))
        return loss, aux["batch_stats"]

    want_train, want_stats = objective(variables["params"],
                                       variables["batch_stats"])
    tbatch = {k: torch.as_tensor(v) for k, v in batch.items()}
    with torch.no_grad():
        got_train, _ = steps.fused_objective(model, tbatch, mcfg, tcfg,
                                             train=True)
    np.testing.assert_allclose(float(got_train), float(want_train), rtol=2e-4)
    got_stats = dict(_flat(to_flax_variables(model)["batch_stats"]))
    for k, w in _flat(jax.device_get(want_stats)):
        np.testing.assert_allclose(got_stats[k], w, rtol=1e-4, atol=1e-5,
                                   err_msg=k)


def test_image_family_cross_validation_matches_jax(tmp_path, topo,
                                                   monkeypatch):
    """SGCN_GCN (`takes_snps=False`) through both CV drivers from the same
    weights: per-epoch losses rtol 2e-4, no regression scores in the
    per-epoch lines, the same score matrix and npy artifacts."""
    cfg = dict(SMALL, num_classes=2)
    mcfg, jmcfg = ModelConfig(**cfg), JaxMC(**cfg)
    tcfg = TrainConfig(epochs=1, batch_size=8, folds=3, lr=3e-3)
    jtcfg = JaxTC(epochs=1, batch_size=8, folds=3, lr=3e-3)
    model = _port_model("sgcn_image", mcfg, topo)
    variables = to_flax_variables(model)
    warm = (variables["params"], None, "shared")
    # both builders keep the family's 0.5 head dropout; zero it
    monkeypatch.setitem(
        jax_cv_module.MODEL_FAMILIES, "sgcn_image",
        (lambda m, t: _jax_model("sgcn_image", m, t), False))
    build = port_cv_module.MODEL_FAMILIES["sgcn_image"]
    monkeypatch.setitem(port_cv_module.MODEL_FAMILIES, "sgcn_image",
                        lambda m, t, **kw: _quiet(build(m, t, **kw)))
    runs = {}
    for side, cv, cohort, topology, mc, tc, kw in (
            ("jax", jax_cv_module.cross_validation, jax_cohort, jax_topology,
             jmcfg, jtcfg, {}),
            ("port", port_cv_module.cross_validation, synthetic_cohort,
             synthetic_topology,
             mcfg, tcfg, {"device": "cpu"})):
        lines = []
        result = cv(cohort(np.random.default_rng(1), num_subjects=36),
                    topology(np.random.default_rng(0)), mc, tc,
                    res_dir=str(tmp_path / side), result_file_name="r",
                    logger=lines.append, model_kind="sgcn_image",
                    warm_start=warm, **kw)
        runs[side] = (result, [ln for ln in lines if ln.startswith("Fold")])
    (want, want_lines), (got, got_lines) = runs["jax"], runs["port"]
    assert len(got_lines) == len(want_lines) == 3
    number = re.compile(r"-?\d+\.\d+")
    for g, w in zip(got_lines, want_lines):
        assert "corr" not in g and "corr" not in w
        np.testing.assert_allclose([float(v) for v in number.findall(g)],
                                   [float(v) for v in number.findall(w)],
                                   rtol=2e-4, atol=1e-4, err_msg=g)
    np.testing.assert_allclose(got.score_result, want.score_result, atol=1e-6)
    names = sorted(p.name for p in (tmp_path / "jax").glob("*.npy"))
    assert names == sorted(p.name for p in (tmp_path / "port").glob("*.npy"))
    assert not any(n.startswith("snps_importance") for n in names)
    for name in names:
        w = np.load(tmp_path / "jax" / name)
        g = np.load(tmp_path / "port" / name)
        assert g.shape == w.shape and g.dtype == w.dtype, name
        np.testing.assert_allclose(g, w, rtol=1e-3, atol=1e-3, err_msg=name)


@pytest.mark.parametrize("flags,regression", [(["--isMultiFusion"], True),
                                              (["--model", "SGCN_GCN"], False)])
def test_cli_routes_train_on_the_cpu(tmp_path, monkeypatch, capsys, flags,
                                     regression):
    monkeypatch.chdir(tmp_path)
    port_main.main(["--device", "cpu", "--synthetic", "--synthetic_subjects",
                    "30", "--epochs", "1", "--fold", "3", "--batch_size", "16",
                    "--no-search", "--layers", "2", "--hiddens", "8",
                    "--disease_id", "0", "--save_appendix", "_cli", *flags])
    out = capsys.readouterr().out
    lines = [ln for ln in out.splitlines() if ln.startswith("Fold: ")]
    assert len(lines) == 3
    assert all(("corr:" in ln) == regression for ln in lines)
    assert re.search(r"^\[throughput\] [\d.]+ graphs/s$", out, re.M)
    assert re.search(r"^Result - \d\.\d{3} \+/- \d\.\d{3}, with 2 layers and "
                     r"8 hidden units and h = 2$", out, re.M)
    res = tmp_path / "results" / "ADNI_cli"
    prob = np.load(res / "node_importance_result_sgcn_img_snp_layers2_"
                   "hidden8_h2_fold_0.npy")
    assert prob.shape == ((270, 1) if "--isMultiFusion" in flags else (90, 3))


def test_synthetic_multi_fusion_cohort_is_bit_equal():
    want = jax_cohort(np.random.default_rng(4), num_subjects=12, rois=270,
                      feat_dim=1, num_classes=3)
    got = synthetic_cohort(np.random.default_rng(4), num_subjects=12,
                           rois=270, feat_dim=1, num_classes=3)
    for f in dataclasses.fields(want):
        w, g = getattr(want, f.name), getattr(got, f.name)
        if isinstance(w, np.ndarray):
            assert g.dtype == w.dtype and np.array_equal(g, w, equal_nan=True), \
                f.name
    assert got.x.shape == (12, 270, 1) and got.adj.shape == (12, 270, 270)
    assert set(np.unique(got.clust_y)) <= {0, 1}
