"""The port's fold-parallel CV on (fold, data) meshes of gloo CPU ranks,
one torch thread each, in one world of 5 ranks.

* The flagship's `cross_validation(..., fold_parallel=True)` at dropout 0
  from one flax tree: 4 folds (49 subjects, batch 8) on meshes (4, 1),
  (2, 2) and (1, 4), and 5 unequal folds (48 subjects, batch 4) on
  (5, 1). Each is held against the port's one-device fold-parallel run
  (per-epoch losses rtol 2e-4) and the JAX package's fold-parallel CV at
  `tests/test_parallel.py`'s tolerances (mean test loss rtol 1e-3, score
  matrix rtol 1e-3 / atol 2e-3).
* With dropout on, (2, 2) against the one-device run: each data position
  keeps its rows of the uniforms drawn for the whole batch.
* The data replicas of each fold row end bit-equal (each rank's digest of
  its fold row's weights), on every mesh with a data axis.
* A seeds x folds grid (2 CV seeds x 2 folds without a validation split)
  on (2, 2) against the one-device seed batch.
* The CLI spawns nothing with one card, and on several takes
  `fold_mesh(entries)` over them.
"""
import re
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iggcn_tpu.config import LossWeights as JaxLW
from iggcn_tpu.config import ModelConfig as JaxMC
from iggcn_tpu.config import TrainConfig as JaxTC
from iggcn_tpu.data.adni import synthetic_cohort as jax_cohort
from iggcn_tpu.data.go_graph import synthetic_topology as jax_topology
from iggcn_tpu.models.fused_sgcn import FusedSGCN as JaxFused
from iggcn_tpu.train.cv import cross_validation as jax_cv
from iggcn_tpu_torch import main as cli
from iggcn_tpu_torch.parallel import mesh as meshlib

from tests import torch_mesh_ranks as ranks

CPU = torch.device("cpu")
MODEL = dict(num_layers=2, hidden=8, hidden_linear=16, l_dim=8,
             num_classes=2)
NO_DROPOUT = dict(dropout_lin=0.0, dropout_regr=0.0, dropout_go=0.0,
                  dropout_readout=0.0)
LOSS = dict(disease=1.0, regr=1.0, prob=0.5, reco=1.5e-6, simi=0.1, orth=0.1)
TRAIN = dict(epochs=2, seed=7, lr=3e-3, weight_decay=1e-2,
             lr_decay_step_size=1)
# (mesh shape, folds, cohort, batch)
CASES = [((4, 1), 4, 49, 8), ((2, 2), 4, 49, 8), ((1, 4), 4, 49, 8),
         ((5, 1), 5, 48, 4)]
LINE = re.compile(r"Fold: (\d+), epoch:(\d+), train_loss: ([-\d.naninf]+), "
                  r"val_loss: ([-\d.naninf]+), test_loss: ([-\d.naninf]+)")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(autouse=True, scope="module")
def fast_jax_compiles():
    before = jax.config.read("jax_disable_most_optimizations")
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", before)


@pytest.fixture(scope="module")
def warm():
    jmodel = JaxFused(cfg=JaxMC(**MODEL, **NO_DROPOUT),
                      topo=jax_topology(np.random.default_rng(0)))
    variables = jax.device_get(jax.jit(jmodel.init)(
        jax.random.PRNGKey(3), jnp.zeros((8, 90, 3)), jnp.zeros((8, 90, 90)),
        jnp.zeros((8, 54))))
    return (variables["params"], variables["batch_stats"], "shared")


def _epochs(lines):
    return {(int(m[1]), int(m[2])): tuple(map(float, m.group(3, 4, 5)))
            for m in map(LINE.match, lines) if m}


def _port_args(folds, subjects, batch, dropout):
    model = MODEL if dropout else {**MODEL, **NO_DROPOUT}
    return ({"num_subjects": subjects}, model,
            {**TRAIN, "batch_size": batch}, LOSS, folds)


def _in_background(fn, *args):
    """Start `fn(*args)` on a thread; the returned callable joins it and
    gives its result (or raises its exception)."""
    box = {}

    def run():
        try:
            box["result"] = fn(*args)
        except BaseException as e:   # re-raised by the joining test
            box["error"] = e

    thread = threading.Thread(target=run, daemon=True)
    thread.start()

    def join():
        thread.join(timeout=600)
        assert not thread.is_alive(), "the mesh world did not finish"
        if "error" in box:
            raise box["error"]
        return box["result"]
    return join


@pytest.fixture(scope="module")
def runs(warm):
    """The world's runs (5 spawned CPU ranks, started first) and, while
    they train, the references in this process."""
    join = _in_background(_mesh_runs, warm)
    refs = _references(warm)
    return join(), refs


def _mesh_runs(warm):
    """Every mesh case, run in one world of 5 CPU ranks."""
    jobs = []
    for shape, folds, subjects, batch in CASES:
        cohort_kw, model, train, loss, _ = _port_args(folds, subjects, batch,
                                                      False)
        jobs.append(("cv_runs", ([(shape, folds)], cohort_kw, model, train,
                                 loss, warm)))
    cohort_kw, model, train, loss, _ = _port_args(4, 49, 8, True)
    jobs.append(("cv_runs", ([((2, 2), 4)], cohort_kw, model, train, loss,
                             None)))
    jobs.append(("seed_batch_run", ((1, 2), {"num_subjects": 49},
                                    {**MODEL, **NO_DROPOUT},
                                    {**TRAIN, "batch_size": 8, "folds": 2,
                                     "no_val": True}, LOSS, (2, 2))))
    jobs.append(("replica_digests", ((1, 4),)))
    out = meshlib.launch(ranks.run_all, (jobs,),
                         meshlib.make_mesh(devices=[CPU] * 5), threads=1)
    return {"cases": [o[0] for o in out[:len(CASES)]],
            "dropout": out[len(CASES)][0], "seeds": out[len(CASES) + 1],
            "digests": out[len(CASES) + 2]}


def _one_device(folds, subjects, batch, warm, dropout=False):
    """The port's fold-parallel CV in this process: (CVResult, lines)."""
    from iggcn_tpu_torch.config import LossWeights, ModelConfig, TrainConfig
    from iggcn_tpu_torch.data.adni import synthetic_cohort
    from iggcn_tpu_torch.data.go_graph import synthetic_topology
    from iggcn_tpu_torch.train.cv import cross_validation
    cohort_kw, model, train, loss, _ = _port_args(folds, subjects, batch,
                                                  dropout)
    lines = []
    res = cross_validation(
        synthetic_cohort(np.random.default_rng(1), **cohort_kw),
        synthetic_topology(np.random.default_rng(0)), ModelConfig(**model),
        TrainConfig(**train, folds=folds, fold_parallel=True,
                    loss=LossWeights(**loss)),
        res_dir=None, logger=lines.append, verbose=True, warm_start=warm,
        device=CPU)
    return res, lines


def _references(warm):
    """{(folds, subjects, batch): (port one-device, JAX)}."""
    out = {}
    for _, folds, subjects, batch in CASES:
        key = (folds, subjects, batch)
        if key in out:
            continue
        port = _one_device(folds, subjects, batch, warm)
        lines = []
        want = jax_cv(jax_cohort(np.random.default_rng(1),
                                 num_subjects=subjects),
                      jax_topology(np.random.default_rng(0)),
                      JaxMC(**MODEL, **NO_DROPOUT),
                      JaxTC(**TRAIN, batch_size=batch, folds=folds,
                            fold_parallel=True, loss=JaxLW(**LOSS)),
                      res_dir=None, logger=lines.append, verbose=True,
                      warm_start=warm)
        out[key] = (port, (want, lines))
    return out


@pytest.mark.parametrize("case", range(len(CASES)), ids=[
    f"{s[0]}x{s[1]}-{k}folds" for s, k, _, _ in CASES])
def test_mesh_cv_equals_one_device_and_the_jax_package(runs, case):
    mesh_runs, references = runs
    shape, folds, subjects, batch = CASES[case]
    got, got_lines = mesh_runs["cases"][case]
    (port, port_lines), (want, _) = references[folds, subjects, batch]
    got_ep, port_ep = _epochs(got_lines), _epochs(port_lines)
    assert got_ep.keys() == port_ep.keys() and len(got_ep) == 2 * folds
    for key, w in port_ep.items():
        np.testing.assert_allclose(got_ep[key], w, rtol=2e-4, err_msg=str(key))
    np.testing.assert_allclose(got.mean_test_loss, port.mean_test_loss,
                               rtol=2e-4)
    np.testing.assert_allclose(got.score_result, port.score_result,
                               rtol=1e-3, atol=2e-3)
    np.testing.assert_allclose(got.mean_test_loss, want.mean_test_loss,
                               rtol=1e-3)
    np.testing.assert_allclose(got.score_result, want.score_result,
                               rtol=1e-3, atol=2e-3)


def test_sharded_dropout_draws_the_whole_batchs_uniforms(runs):
    got, got_lines = runs[0]["dropout"]
    port, port_lines = _one_device(4, 49, 8, None, dropout=True)
    got_ep, port_ep = _epochs(got_lines), _epochs(port_lines)
    assert got_ep.keys() == port_ep.keys() and len(got_ep) == 8
    for key, w in port_ep.items():
        np.testing.assert_allclose(got_ep[key], w, rtol=2e-4, err_msg=str(key))
    np.testing.assert_allclose(got.score_result, port.score_result,
                               rtol=1e-3, atol=2e-3)


def test_data_replicas_end_bit_equal(runs):
    digests = runs[0]["digests"]       # rank -> (fold row, digest)
    assert len(digests) == 5 and digests[4] is None      # rank 4 idles
    assert {row for row, _ in digests[:4]} == {0}
    assert len({d for _, d in digests[:4]}) == 1


def test_seeds_x_folds_grid_equals_one_device(runs):
    from iggcn_tpu_torch.config import LossWeights, ModelConfig, TrainConfig
    from iggcn_tpu_torch.data.adni import synthetic_cohort
    from iggcn_tpu_torch.data.go_graph import synthetic_topology
    from iggcn_tpu_torch.train.cv import cross_validation_seed_batch
    want = cross_validation_seed_batch(
        synthetic_cohort(np.random.default_rng(1), num_subjects=49), (1, 2),
        synthetic_topology(np.random.default_rng(0)),
        ModelConfig(**MODEL, **NO_DROPOUT),
        TrainConfig(**TRAIN, batch_size=8, folds=2, no_val=True,
                    fold_parallel=True, loss=LossWeights(**LOSS)),
        res_dirs=[None, None], verbose=False, device=CPU)
    got = runs[0]["seeds"]
    assert len(got) == 2
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.mean_test_loss, w.mean_test_loss,
                                   rtol=2e-4)
        np.testing.assert_allclose(g.score_result, w.score_result,
                                   rtol=1e-3, atol=2e-3)


def _args(argv):
    return cli.build_parser().parse_args(argv)


def test_cli_mesh_spawns_nothing_on_one_card_and_takes_fold_mesh_on_more(
        monkeypatch):
    cuda = torch.device("cuda", 0)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    base = ["--fold_parallel", "--fold", "5"]
    assert cli.cli_mesh(_args(base), cuda) is None
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert cli.cli_mesh(_args(base), CPU) is None
    assert cli.cli_mesh(_args(["--fold", "5"]), cuda) is None
    assert cli.cli_mesh(_args(base), cuda).shape == (1, 4)
    assert cli.cli_mesh(_args(base + ["--cv_seeds", "1:2"]),
                        cuda).shape == (2, 2)
    assert cli.cli_mesh(_args(base + ["--permut_seeds", "1:3",
                                      "--spmd_batch_entries", "10"]),
                        cuda).shape == (2, 2)
    launched = []
    monkeypatch.setattr(cli, "run_on_mesh",
                        lambda args, argv, mesh: launched.append(mesh.shape))
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(cli, "run_routes", lambda *a: "in process")
    monkeypatch.setattr("iggcn_tpu_torch.utils.platform.resolve_device",
                        lambda d: cuda)
    assert cli.main(base + ["--synthetic"]) == "in process"
    assert launched == []
