"""The port's cross-validation (`iggcn_tpu_torch/train/cv.py`) against the
JAX package's `cross_validation`, both warm-started from one set of flax
variables at dropout 0, 3 folds x 2 epochs, with and without a validation
split: per-epoch train/val/test losses rtol 2e-4, the same best epochs,
the same per-epoch score matrix (acc/auc/f1/sen/spe), the `Result` numbers
to 3 decimals, and the same npy artifact names with contents within
rtol/atol 1e-3 (trained features after up to eight Adam steps: the GO
latent columns pass train-mode batch norms over few rows, whose fp32
cancellation moves them by up to 3e-4 while every loss still agrees to
2e-4). Then the port's CLI (`python -m iggcn_tpu_torch.main`):
it runs on the CPU when asked and raises without CUDA otherwise."""
import os
import re
import shlex
import subprocess
import sys

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
from iggcn_tpu_torch import main as port_main
from iggcn_tpu_torch.config import LossWeights, ModelConfig, TrainConfig
from iggcn_tpu_torch.data.adni import synthetic_cohort
from iggcn_tpu_torch.data.go_graph import synthetic_topology
from iggcn_tpu_torch.train.cv import cross_validation

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODEL = dict(num_layers=2, hidden=8, hidden_linear=16, l_dim=8,
             num_classes=2, dropout_lin=0.0, dropout_regr=0.0,
             dropout_go=0.0, dropout_readout=0.0)
LOSS = dict(disease=1.0, regr=1.0, prob=0.5, reco=1.5e-6, simi=0.1, orth=0.1)
TRAIN = dict(epochs=2, batch_size=8, folds=3, lr=3e-3, weight_decay=1e-2,
             lr_decay_step_size=1)
LINE = re.compile(r"Fold: (\d+), epoch:(\d+), train_loss: ([-\d.naninf]+), "
                  r"val_loss: ([-\d.naninf]+), test_loss: ([-\d.naninf]+)")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _epochs(lines):
    """{(fold, epoch): (train, val, test)} from the per-epoch lines."""
    out = {}
    for line in lines:
        m = LINE.match(line)
        if m:
            out[int(m[1]), int(m[2])] = tuple(map(float, m.group(3, 4, 5)))
    return out


def _best_epochs(epochs, folds):
    """The epoch each fold keeps: first strict minimum of its val loss."""
    return [min(sorted(e for f, e in epochs if f == fold),
                key=lambda e: epochs[fold, e][1]) for fold in range(folds)]


@pytest.mark.parametrize("no_val", [False, True])
def test_cross_validation_matches_jax(tmp_path, no_val):
    jmodel = JaxFused(cfg=JaxMC(**MODEL),
                      topo=jax_topology(np.random.default_rng(0)))
    variables = jax.device_get(jax.jit(jmodel.init)(
        jax.random.PRNGKey(3), jnp.zeros((8, 90, 3)), jnp.zeros((8, 90, 90)),
        jnp.zeros((8, 54))))
    warm = (variables["params"], variables["batch_stats"], "shared")
    runs = {}
    for side, cv, cohort, topo, mcfg, tcfg, kw in (
            ("jax", jax_cv, jax_cohort, jax_topology, JaxMC(**MODEL),
             JaxTC(**TRAIN, no_val=no_val, loss=JaxLW(**LOSS)), {}),
            ("port", cross_validation, synthetic_cohort, synthetic_topology,
             ModelConfig(**MODEL),
             TrainConfig(**TRAIN, no_val=no_val, loss=LossWeights(**LOSS)),
             {"device": "cpu"})):
        lines = []
        res_dir = tmp_path / side
        result = cv(cohort(np.random.default_rng(1), num_subjects=40),
                    topo(np.random.default_rng(0)), mcfg, tcfg,
                    res_dir=str(res_dir), result_file_name="r",
                    logger=lines.append, warm_start=warm, **kw)
        runs[side] = (result, _epochs(lines), res_dir)

    (want, want_ep, want_dir), (got, got_ep, got_dir) = runs["jax"], runs["port"]
    assert got_ep.keys() == want_ep.keys() and len(want_ep) == 6
    for key, w in want_ep.items():
        np.testing.assert_allclose(got_ep[key], w, rtol=2e-4, err_msg=str(key))
    assert _best_epochs(got_ep, 3) == _best_epochs(want_ep, 3)
    np.testing.assert_allclose(got.score_result, want.score_result, atol=1e-6)
    np.testing.assert_allclose(got.mean_test_loss, want.mean_test_loss,
                               rtol=2e-4)
    assert round(got.best_acc, 3) == round(want.best_acc, 3)
    assert round(got.best_acc_std, 3) == round(want.best_acc_std, 3)
    for name, vals in want.regression_summary.items():
        for k, v in vals.items():
            np.testing.assert_allclose(got.regression_summary[name][k], v,
                                       rtol=1e-3, atol=1e-4)
    names = sorted(p.name for p in want_dir.glob("*.npy"))
    assert names == sorted(p.name for p in got_dir.glob("*.npy"))
    assert len(names) == 22
    for name in names:
        w, g = np.load(want_dir / name), np.load(got_dir / name)
        assert g.shape == w.shape and g.dtype == w.dtype, name
        np.testing.assert_allclose(g, w, rtol=1e-3, atol=1e-3, err_msg=name)


def test_cross_validation_refuses_what_is_not_ported():
    cohort = synthetic_cohort(np.random.default_rng(1), num_subjects=12)
    topo = synthetic_topology(np.random.default_rng(0))
    for kwargs, tcfg in (({"resume": True}, TrainConfig()),
                         ({"model_kind": "gcn_imgsnp"}, TrainConfig()),
                         ({}, TrainConfig(fold_parallel=True))):
        with pytest.raises(NotImplementedError, match="not ported"):
            cross_validation(cohort, topo, ModelConfig(), tcfg,
                             device="cpu", **kwargs)


def test_cli_trains_on_the_cpu_when_asked(tmp_path):
    env = {**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1"}
    r = subprocess.run(
        [sys.executable, "-m", "iggcn_tpu_torch.main", "--device", "cpu",
         "--synthetic", "--synthetic_subjects", "30", "--epochs", "1",
         "--fold", "3", "--batch_size", "16", "--no-search", "--layers", "2",
         "--hiddens", "8", "--disease_id", "0", "--save_appendix", "_cli"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    assert re.search(r"^\[throughput\] [\d.]+ graphs/s$", r.stdout, re.M)
    assert re.search(r"^Result - \d\.\d{3} \+/- \d\.\d{3}, with 2 layers and "
                     r"8 hidden units and h = 2$", r.stdout, re.M)
    assert len(LINE.findall(r.stdout)) == 3
    out = tmp_path / "results" / "ADNI_cli"
    assert (out / "result_sgcn_img_snp_layers2_hidden8_h2.npy").exists()
    assert "Result - " in (out / "log.txt").read_text()


def test_cli_defaults_to_the_card_and_refuses_other_models(monkeypatch,
                                                           tmp_path):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port_main.main(["--synthetic", "--epochs", "1", "--no-search"])
    with pytest.raises(SystemExit):
        port_main.main(["--model", "GIN", "--device", "cpu"])
    assert not (tmp_path / "results").exists()


def test_documented_port_commands_parse():
    with open(os.path.join(REPO, "README.md")) as fh:
        text = fh.read().replace("\\\n", " ")
    lines = [ln.strip() for ln in text.splitlines()
             if ln.strip().startswith("python -m iggcn_tpu_torch.main")]
    assert len(lines) >= 2
    parser = port_main.build_parser()
    for line in lines:
        parser.parse_args(shlex.split(line)[3:])
