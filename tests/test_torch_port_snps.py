"""The port's SNP-only families against the JAX package on the same weights
(the port's own init, carried across by `tools/convert.py`) at small
widths on the CPU:

  * `GeneOntologyNetwork.classify` (built with `classifier=True`) after the
    encoder, in eval and in train mode (dropout 0, batch statistics over
    the rows `sample_weight` marks, and the running statistics they
    leave, rtol 1e-4 / atol 1e-5), atol 1e-5 on every row in eval mode
    and on the real rows in train mode (a padding row, normalised by the
    real rows' statistics, differs from float64 by 6e-6 in the port's own
    fp32 and by 1.4e-5 between the packages; no loss reads it);
    `MLPModel`'s forward, atol 1e-6;
  * the class-balanced sampler's draws and `load_snps_csv`, bit-equal;
  * six train steps of both kinds against `build_snps_steps` (two padding
    rows per batch, the learning rate across two StepLR boundaries): the
    pins of `tests/test_trajectory_parity_snps.py`, per-step loss rtol
    2e-4, final params rtol 2e-3 / atol 2.5e-4 (the last decoder layer
    norm's bias, whose gradient is zero to rounding, within Adam's walk of
    1.5 x the summed learning rates), running statistics rtol 2e-3 /
    atol 1e-5 after the first step and rtol 0.1 / atol 1e-5 after the
    sixth;
  * a 3-fold x 2-epoch `cross_validation_snps` of both kinds against the
    JAX one, dropout zeroed on both sides (test-time subclasses in the JAX
    modules, rate-0 port models) and each fold started from the JAX init
    of `PRNGKey(seed + fold)`: the same score matrix (acc/auc/f1/sen/spe),
    the mean test loss within rtol 2e-4, and the same fold records;
  * the CLI route of both models with `--device cpu`, and of the GO
    network over a csv cohort (a synthetic DAG without the GO source
    files; with them, the DAG the port parses from them, equal to the JAX
    parser's)."""
import os
import re
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iggcn_tpu.data import sampler as jax_sampler
from iggcn_tpu.data.go_graph import parse_go_json as jax_parse_go_json
from iggcn_tpu.data.go_graph import synthetic_topology as jax_topology
from iggcn_tpu.data.snps import load_snps_csv as jax_load_snps_csv
from iggcn_tpu.models import baselines as jax_baselines
from iggcn_tpu.models.go_network import GeneOntologyNetwork as JaxGO
from iggcn_tpu.train import snps_trainer as jax_trainer
from iggcn_tpu.train.steps import adam_transform
from iggcn_tpu.train.steps import steplr_host as jax_steplr
from iggcn_tpu_torch import main as port_main
from iggcn_tpu_torch.data import sampler
from iggcn_tpu_torch.data.adni import synthetic_cohort
from iggcn_tpu_torch.data.go_graph import synthetic_topology
from iggcn_tpu_torch.data.snps import load_snps_csv
from iggcn_tpu_torch.models.baselines import MLPModel
from iggcn_tpu_torch.models.go_network import GeneOntologyNetwork
from iggcn_tpu_torch.tools.convert import load_flax_variables, to_flax_variables
from iggcn_tpu_torch.train import snps_trainer

B, STEPS, LR, LAMBDA0 = 8, 6, 3e-3, 1e-5
DECAY_EVERY, FACTOR = 2, 0.5
QUIET_GO = dict(dropout_gcn=0.0, dropout_readout=0.0, dropout_cls=(0.0, 0.0))


class ZeroDropGO(JaxGO):
    dropout_gcn: float = 0.0
    dropout_readout: float = 0.0
    dropout_cls: tuple = (0.0, 0.0)


class ZeroDropMLP(jax_baselines.MLPModel):
    dropout_rate: float = 0.0


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
def cohort():
    c = synthetic_cohort(np.random.default_rng(3), num_subjects=B * STEPS)
    w = np.ones(B * STEPS, np.float32)
    w[B - 2::B] = w[B - 1::B] = 0.0          # two padding rows per batch
    return c.snps.astype(np.float32), (c.y > 0).astype(np.float32), w


def _port_model(kind, topo, seed=0):
    g = torch.Generator().manual_seed(seed)
    if kind == "mlp":
        return MLPModel(54, dropout_rate=0.0, generator=g)
    return GeneOntologyNetwork(topo, classifier=True, generator=g,
                               **QUIET_GO)


def _jax_model(kind, topo):
    return (jax_baselines.MLPModel(dropout_rate=0.0) if kind == "mlp"
            else JaxGO(topo=jax_topology(np.random.default_rng(0)),
                       **QUIET_GO))


def _random_stats(model, seed=5):
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, buf in model.named_buffers():
            if name.endswith("running_mean"):
                buf.normal_(0.0, 0.3, generator=gen)
            elif name.endswith("running_var"):
                buf.uniform_(0.5, 2.0, generator=gen)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_classify_matches_jax(topo, cohort, train):
    snps, _, w = cohort
    x, wb = snps[:B], w[:B]
    model = _port_model("go", topo)
    _random_stats(model)
    variables = to_flax_variables(model)
    jmodel = _jax_model("go", topo)
    if train:
        rngs = {"dropout": jax.random.PRNGKey(0)}   # feeds rate-0 dropout
        (latent, _, _), mut = jmodel.apply(
            variables, x, train=True, sample_weight=wb, rngs=rngs,
            mutable=["batch_stats"])
        want, mut = jmodel.apply(
            {"params": variables["params"], **mut}, latent, x, train=True,
            sample_weight=wb, method=JaxGO.classify, rngs=rngs,
            mutable=["batch_stats"])
    else:
        latent, _, _ = jmodel.apply(variables, x)
        want = jmodel.apply(variables, latent, x, method=JaxGO.classify)
    model.train(train)
    xt, wt = torch.from_numpy(x), torch.from_numpy(wb)
    latent_t, _, _ = model(xt, sample_weight=wt)
    got = model.classify(latent_t, xt, sample_weight=wt)
    # in train mode the padding rows' outputs are read by no loss: the
    # real rows are held
    rows = wb > 0 if train else slice(None)
    np.testing.assert_allclose(got.detach().numpy()[rows],
                               np.asarray(want)[rows], atol=1e-5)
    if train:
        stats = to_flax_variables(model)["batch_stats"]
        jax.tree_util.tree_map(
            lambda g, e: np.testing.assert_allclose(g, e, rtol=1e-4,
                                                    atol=1e-5),
            stats, jax.device_get(mut["batch_stats"]))


def test_classifier_leaves_only_where_asked(topo):
    plain = GeneOntologyNetwork(topo)
    assert not any(k.startswith(("bn_cls", "cls1", "cls2"))
                   for k in plain.state_dict())
    with pytest.raises(ValueError, match="classifier=True"):
        plain.classify(torch.zeros(2, 32), torch.zeros(2, 54))


def test_mlp_forward_matches_jax(cohort):
    snps = cohort[0][:B]
    model = _port_model("mlp", None).eval()
    want = _jax_model("mlp", None).apply(to_flax_variables(model), snps)
    got = model(torch.from_numpy(snps))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=1e-6)


def test_sampler_and_csv_loader_are_bit_equal(tmp_path):
    y = (np.random.default_rng(0).random(37) < 0.3).astype(np.float32)
    for seed in (0, 77 * 1000 + 2):
        got = sampler.imbalanced_sample_indices(y, np.random.default_rng(seed))
        want = jax_sampler.imbalanced_sample_indices(
            y, np.random.default_rng(seed))
        np.testing.assert_array_equal(got, want)
        for b in (8, 37, 64):
            for g, e in zip(sampler.pad_epoch_indices(got, b),
                            jax_sampler.pad_epoch_indices(want, b)):
                np.testing.assert_array_equal(g, e)
    rng = np.random.default_rng(1)
    for disease_id, folder in ((0, "data_AH"), (1, "data_MH"), (2, "data_AM")):
        base = tmp_path / folder
        base.mkdir()
        rows = rng.integers(0, 3, size=(9, 54))
        np.savetxt(base / "snp.csv", rows, delimiter=",", fmt="%d",
                   header=",".join(f"rs{i}" for i in range(54)), comments="")
        np.savetxt(base / "dia.csv", rng.integers(0, 2, 9), fmt="%d",
                   header="dia", comments="")
        for g, e in zip(load_snps_csv(str(tmp_path), disease_id),
                        jax_load_snps_csv(str(tmp_path), disease_id)):
            assert g.dtype == e.dtype
            np.testing.assert_array_equal(g, e)
    with pytest.raises(FileNotFoundError):
        load_snps_csv(str(tmp_path / "none"), 0)


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


@pytest.mark.parametrize("kind", ["go", "mlp"])
def test_six_step_trajectory_matches_build_snps_steps(topo, cohort, kind):
    snps, y, w = cohort
    model = _port_model(kind, topo)
    variables = to_flax_variables(model)
    jmodel = _jax_model(kind, topo)
    lambda0 = 0.0 if kind == "mlp" else LAMBDA0
    optimizer = adam_transform()
    train_step, _ = jax_trainer.build_snps_steps(jmodel, optimizer, lambda0,
                                                 use_mlp=kind == "mlp")
    params, stats = variables["params"], variables["batch_stats"]
    opt_state = optimizer.init(params)
    port_opt = snps_trainer.make_snps_optimizer(model)
    rng = jax.random.PRNGKey(99)        # feeds rate-0 dropout only
    want, got, stats_want, stats_got = [], [], [], []
    for t in range(STEPS):
        lr_t = snps_trainer.steplr_host(LR, FACTOR, DECAY_EVERY, t)
        assert lr_t == jax_steplr(LR, FACTOR, DECAY_EVERY, t)
        sl = slice(t * B, (t + 1) * B)
        rng, srng = jax.random.split(rng)
        params, stats, opt_state, loss = train_step(
            params, stats, opt_state, snps[sl], y[sl], w[sl], srng,
            jnp.float32(lr_t))
        want.append(float(loss))
        got.append(float(snps_trainer.snps_train_step(
            model, port_opt, *(torch.from_numpy(a[sl]) for a in (snps, y, w)),
            lr_t, lambda0, None)))
        if t in (0, STEPS - 1):
            stats_want.append(jax.device_get(stats))
            stats_got.append(to_flax_variables(model)["batch_stats"])
    np.testing.assert_allclose(got, want, rtol=2e-4)
    assert abs(want[0] - want[-1]) > 1e-3
    lr_walk = 1.5 * sum(snps_trainer.steplr_host(LR, FACTOR, DECAY_EVERY, t)
                        for t in range(STEPS))
    final = dict(_flat(to_flax_variables(model)["params"]))
    for path, a in _flat(jax.device_get(params)):
        if path == ("g_b_d_1", "bias"):
            assert np.abs(final[path] - a).max() < lr_walk
            continue
        np.testing.assert_allclose(final[path], a, rtol=2e-3, atol=2.5e-4,
                                   err_msg="/".join(path))
    for rtol, sw, sg in zip((2e-3, 0.1), stats_want, stats_got):
        got_stats = dict(_flat(sg))
        for path, a in _flat(sw):
            np.testing.assert_allclose(got_stats[path], a, rtol=rtol,
                                       atol=1e-5, err_msg="/".join(path))


@pytest.mark.parametrize("kind", ["go", "mlp"])
def test_cross_validation_snps_matches_jax(topo, tmp_path, monkeypatch,
                                           kind):
    snps = synthetic_cohort(np.random.default_rng(4),
                            num_subjects=36).snps.astype(np.float32)
    y = (np.random.default_rng(5).random(36) < 0.5).astype(np.float32)
    monkeypatch.setattr(jax_trainer, "GeneOntologyNetwork", ZeroDropGO)
    monkeypatch.setattr(jax_baselines, "MLPModel", ZeroDropMLP)
    jtopo = jax_topology(np.random.default_rng(0))

    def jax_init(kind, topo, num_snps, seed, fold, device, **kw):
        """The JAX trainer's fold init, PRNGKey(seed + fold), carried into
        a rate-0 port model."""
        init_rng, _ = jax.random.split(jax.random.PRNGKey(seed + fold))
        x = jnp.zeros((B, num_snps))
        if kind == "mlp":
            variables = ZeroDropMLP().init(init_rng, x)
        else:
            def init_all(mod, x):
                latent, _, _ = mod(x)
                return mod.classify(latent, x)
            variables = ZeroDropGO(topo=jtopo).init(init_rng, x,
                                                    method=init_all)
        model = _port_model(kind, topo)
        load_flax_variables(model, jax.device_get(variables["params"]),
                            jax.device_get(variables.get("batch_stats", {})))
        return model, None

    monkeypatch.setattr(snps_trainer, "init_snps_model", jax_init)
    kw = dict(folds=3, epochs=2, batch_size=B, model_kind=kind)
    for side in ("jax", "port"):
        (tmp_path / side).mkdir()
    want = jax_trainer.cross_validation_snps(
        snps, y, jtopo, record_dir=str(tmp_path / "jax"), **kw)
    got = snps_trainer.cross_validation_snps(
        snps, y, topo, record_dir=str(tmp_path / "port"), device="cpu", **kw)
    np.testing.assert_array_equal(got.score_result, want.score_result)
    np.testing.assert_array_equal(got.accs, want.accs)
    assert (got.best_acc, got.best_acc_std) == (want.best_acc,
                                                want.best_acc_std)
    np.testing.assert_allclose(got.mean_loss, want.mean_loss, rtol=2e-4)
    for fold in range(3):
        name = f"fold_result_snps_{kind}_fold_{fold}.npz"
        with np.load(tmp_path / "jax" / name) as a, \
                np.load(tmp_path / "port" / name) as b:
            assert sorted(a.files) == sorted(b.files)
            np.testing.assert_array_equal(a["meta"], b["meta"])
            assert str(a["model_kind"]) == str(b["model_kind"]) == kind
            np.testing.assert_allclose(b["losses"], a["losses"], rtol=2e-4)


@pytest.mark.parametrize("model", ["Gene_ontology_network", "MLP_Model"])
def test_cli_route_trains_on_the_cpu(tmp_path, monkeypatch, capsys, model):
    monkeypatch.chdir(tmp_path)
    res = port_main.main(["--model", model, "--device", "cpu", "--synthetic",
                          "--synthetic_subjects", "40", "--epochs", "2",
                          "--fold", "3", "--batch_size", "16",
                          "--disease_id", "0", "--save_appendix", "_snp",
                          "--export_bundle"])
    out = capsys.readouterr().out
    assert re.search(rf"^Result - \d\.\d{{3}} \+/- \d\.\d{{3}} \(SNP-only, "
                     rf"{model}\)$", out, re.M)
    assert res.score_result.shape == (3, 2, 5)
    kind = "mlp" if model == "MLP_Model" else "go"
    d = tmp_path / "results" / "ADNI_snp"
    assert (d / f"result_snps_{kind}.npy").exists()
    for fold in range(3):
        assert (d / f"fold_result_snps_{kind}_fold_{fold}.npz").exists()
        assert (d / f"serving_bundle_snps_{kind}_fold_{fold}.npz").exists()
    with pytest.raises(SystemExit):
        port_main.main(["--model", model, "--device", "cpu", "--synthetic",
                        "--disease_id", "3", "--save_appendix", "_snp3"])
    assert "binary classifiers" in capsys.readouterr().err


@pytest.mark.parametrize("go_files", [False, True], ids=["no_go", "go"])
def test_cli_reads_the_csv_cohort(tmp_path, monkeypatch, capsys, go_files):
    """Without --synthetic the SNP-only route reads the csv cohort, over a
    synthetic GO DAG without the GO source files, and over the DAG the
    port's parser builds from them (the committed PANTHER fixture, three
    SNPs wide) when all three are present, as the JAX CLI does."""
    monkeypatch.chdir(tmp_path)
    rng = np.random.default_rng(2)
    base = tmp_path / "csv" / "data_AH"
    base.mkdir(parents=True)
    width = 3 if go_files else 54
    np.savetxt(base / "snp.csv", rng.integers(0, 3, size=(30, width)),
               delimiter=",", fmt="%d", comments="",
               header=",".join(f"rs{i}" for i in range(width)))
    np.savetxt(base / "dia.csv", np.arange(30) % 2, fmt="%d", header="dia",
               comments="")
    fixture = os.path.join(os.path.dirname(__file__), "fixtures", "go")
    if go_files:
        for name, src in (("data/snps/analysis.json", "analysis.json"),
                          ("data/go_root_connection.txt",
                           "go_root_connection.txt"),
                          ("data/snps_to_gene.txt", "snps_to_gene.txt")):
            (tmp_path / name).parent.mkdir(parents=True, exist_ok=True)
            shutil.copy(os.path.join(fixture, src), tmp_path / name)
    topos = []
    trainer = snps_trainer.cross_validation_snps

    def recording(snps_x, snps_y, topo, **kw):
        topos.append(topo)
        return trainer(snps_x, snps_y, topo, **kw)

    monkeypatch.setattr(snps_trainer, "cross_validation_snps", recording)
    argv = ["--model", "Gene_ontology_network", "--device", "cpu",
            "--snps_csv_root", str(tmp_path / "csv"), "--epochs", "1",
            "--fold", "3", "--batch_size", "16", "--disease_id", "0",
            "--save_appendix", "_csv"]
    res = port_main.main(argv)
    out = capsys.readouterr().out
    assert "[data] SNP csv cohort: 30 subjects" in out
    assert ("using a synthetic GO topology" in out) != go_files
    assert res.score_result.shape == (3, 1, 5)
    if go_files:
        want = jax_parse_go_json(*(os.path.join(fixture, n) for n in (
            "analysis.json", "go_root_connection.txt", "snps_to_gene.txt")))
        assert topos[0].go_ids == want.go_ids
        assert topos[0].pool == want.pool == [0, 1, 3, 4, 1]
        np.testing.assert_array_equal(topos[0].adj_child_parent,
                                      want.adj_child_parent)
        np.testing.assert_array_equal(topos[0].go_snps, want.go_snps)
    else:
        assert topos[0].pool == [24, 16, 10, 6, 1]
