"""The port's generic CV (`iggcn_tpu_torch/train/generic_cv.py`) against the
JAX package's `cross_validation_generic`, on the CPU, for a batch-norm
family (GIN), DiffPool and the kernel's family (GCN), each with and
without a validation split, 3 folds x 2 epochs at batch 8 over a
36-graph synthetic TU benchmark (6-12 nodes), dropout zeroed on both
sides, the learning rate decayed every epoch. Both start every fold from
one set of weights: the port's through `warm_start`, the JAX CV's
through a test-side `init` on its model instance that returns the same
flax variables (nothing in the JAX package changes). Held: the per-epoch
test accuracies and the selection (`best_acc`, `best_acc_std`) equal,
the mean test loss within rtol 2e-4, and every fold record with the same
keys, equal accuracies and `meta`, losses within rtol 2e-4. One reading
may differ: a test graph whose two best class log-probabilities are
within `TIE` (1e-4) of each other in the port's eval is a tie that fp32
decides (the packages differ by rounding, and by the Adam walk of
zero-gradient entries that `tests/test_torch_port_zoo_models.py`
describes, which eval-mode batch norms read through their running
means); its prediction may flip, moving that fold-epoch's accuracy by
1 / n_test. Seen once: GIN without val, a margin of 2e-5, the mean test
loss agreeing to 1.4e-5. The accuracies may then differ by at most the
count of such ties, and the selection is held to the JAX rule on the
port's own accuracies. Then a
record written by the JAX CV resumes in the port's (two folds restored,
one retrained to the JAX fold's accuracies), and the CLI
(`python -m iggcn_tpu_torch.main --model GIN --data TUTEST`) runs in a
subprocess on the CPU, with a Nested* route in-process."""
import os
import re
import shutil
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import main as jax_main
from iggcn_tpu.data import tu as jax_tu
from iggcn_tpu.train import generic_cv as jax_cv
from iggcn_tpu_torch import main as port_main
from iggcn_tpu_torch.data import tu
from iggcn_tpu_torch.tools.convert import to_flax_variables
from iggcn_tpu_torch.train import generic_cv

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = dict(num_graphs=36, n_min=6, n_max=12)
CV = dict(folds=3, epochs=2, batch_size=8, lr=3e-3, lr_decay_step_size=1,
          seed=1000)
MODELS = {"GIN": 2, "DiffPool": 2, "GCN": 2}
TIE = 1e-4
RESULT = re.compile(r"^Result - \d\.\d{3} \+/- \d\.\d{3}, with 2 layers and "
                    r"8 hidden units and h = 1$", re.M)


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
def datasets():
    return (tu.synthetic_tu_dataset(np.random.default_rng(5), **DATA),
            jax_tu.synthetic_tu_dataset(np.random.default_rng(5), **DATA))


def _pair(name, datasets):
    """(port model, JAX model with the port's weights as its init,
    cv_kwargs, warm start), dropout zeroed on both."""
    port_ds, jax_ds = datasets
    model, kw = port_main.build_zoo_model(name, MODELS[name], 8, port_ds)
    model.dropout_lin = 0.0
    jmodel, _ = jax_main._build_zoo_model(name, MODELS[name], 8, jax_ds)
    jmodel = jmodel.clone(dropout_lin=0.0)
    variables = to_flax_variables(
        model.fresh(generator=torch.Generator().manual_seed(17)))
    if not variables["batch_stats"]:
        del variables["batch_stats"]
    object.__setattr__(jmodel, "init", lambda *a, **k: variables)
    warm = (variables["params"], variables.get("batch_stats"))
    return model, jmodel, kw, warm


@pytest.fixture
def ties(monkeypatch):
    """The port's eval predictions on real rows whose two best class
    log-probabilities are within TIE of each other, counted."""
    count = [0]
    forward = generic_cv.model_forward

    def counting(model, batch, train, generator, **kw):
        out = forward(model, batch, train, generator, **kw)
        if not train:
            logp = out[0] if isinstance(out, tuple) else out
            top = logp.topk(2, dim=-1).values
            count[0] += int(((top[:, 0] - top[:, 1] < TIE)
                             & (batch["w"] > 0)).sum())
        return out

    monkeypatch.setattr(generic_cv, "model_forward", counting)
    return count


def _assert_accs(got, want, n_test, n_ties):
    """Equal, but for at most `n_ties` graphs' flips over the run."""
    flips = np.abs(np.asarray(got) - np.asarray(want)) * n_test[:, None]
    assert np.allclose(flips, np.round(flips)), flips
    assert np.round(flips).sum() <= n_ties, (got, want, n_ties)


def _selection(accs, val_losses, no_val):
    """The JAX CV's selection rule on a run's accuracies."""
    if no_val:
        mean = accs.mean(axis=0)
        arg = int(mean.argmax())
        return float(mean[arg]), float(accs[:, arg].std(ddof=1))
    picked = accs[np.arange(len(accs)), val_losses.argmin(axis=1)]
    return float(picked.mean()), float(picked.std(ddof=1))


def _assert_records(got_dir, want_dir, tag, n_test, n_ties=0, folds=3):
    for fold in range(folds):
        name = f"fold_result_generic_{tag}_fold_{fold}.npz"
        with np.load(os.path.join(want_dir, name)) as a, \
                np.load(os.path.join(got_dir, name)) as b:
            assert sorted(a.files) == sorted(b.files)
            np.testing.assert_array_equal(b["meta"], a["meta"])
            _assert_accs(b["accs"][None], a["accs"][None],
                         n_test[fold:fold + 1], n_ties)
            for k in ("val_losses", "losses"):
                np.testing.assert_allclose(b[k], a[k], rtol=2e-4)


@pytest.mark.parametrize("no_val", [False, True], ids=["val", "no_val"])
@pytest.mark.parametrize("name", list(MODELS))
def test_generic_cv_matches_jax(datasets, tmp_path, ties, name, no_val):
    model, jmodel, kw, warm = _pair(name, datasets)
    n_test = np.asarray([len(te) for _, te, _ in generic_cv.k_fold(
        datasets[0].y, CV["folds"], CV["seed"])], float)
    tag = f"{name}_layers2_hidden8_h2"
    runs = {}
    for side in ("jax", "port"):
        d = tmp_path / side
        d.mkdir()
        common = dict(CV, no_val=no_val, record_dir=str(d), record_tag=tag,
                      **kw)
        runs[side] = (jax_cv.cross_validation_generic(datasets[1], jmodel,
                                                      **common)
                      if side == "jax" else
                      generic_cv.cross_validation_generic(
                          datasets[0], model, warm_start=warm, device="cpu",
                          **common))
    got, want = runs["port"], runs["jax"]
    _assert_accs(got.accs, want.accs, n_test, ties[0])
    val_losses = np.stack([np.load(
        tmp_path / "port" / f"fold_result_generic_{tag}_fold_{f}.npz")[
        "val_losses"] for f in range(CV["folds"])])
    assert (got.best_acc, got.best_acc_std) == _selection(
        got.accs, val_losses, no_val)
    if np.array_equal(got.accs, want.accs):
        assert (got.best_acc, got.best_acc_std) == (want.best_acc,
                                                    want.best_acc_std)
    np.testing.assert_allclose(got.mean_loss, want.mean_loss, rtol=2e-4)
    _assert_records(str(tmp_path / "port"), str(tmp_path / "jax"), tag,
                    n_test, ties[0])
    if name == "GIN" and not no_val:
        # a JAX run's records resume in the port: two folds restored, the
        # deleted one retrained to the same accuracies
        resumed = tmp_path / "resumed"
        shutil.copytree(tmp_path / "jax", resumed)
        os.remove(resumed / f"fold_result_generic_{tag}_fold_2.npz")
        again = generic_cv.cross_validation_generic(
            datasets[0], model, warm_start=warm, device="cpu", resume=True,
            **dict(CV, record_dir=str(resumed), record_tag=tag, **kw))
        _assert_accs(again.accs, want.accs, n_test, ties[0])
        np.testing.assert_array_equal(again.accs[:2], want.accs[:2])
        np.testing.assert_allclose(again.mean_loss, want.mean_loss,
                                   rtol=2e-4)
        _assert_records(str(resumed), str(tmp_path / "jax"), tag, n_test,
                        ties[0])


def test_cli_trains_the_zoo_on_the_cpu(tmp_path, monkeypatch, capsys):
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""))
    argv = ["--model", "GIN", "--data", "TUTEST", "--tu_root",
            os.path.join(REPO, "tests", "fixtures"), "--device", "cpu",
            "--epochs", "1", "--fold", "3", "--batch_size", "4",
            "--no-search", "--layers", "2", "--hiddens", "8", "--h", "1",
            "--save_appendix", "_zoo"]
    proc = subprocess.run([sys.executable, "-m", "iggcn_tpu_torch.main",
                           *argv], cwd=tmp_path, env=env, capture_output=True,
                          text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "Using 2 layers, 8 hidden units, h = 1" in proc.stdout
    assert RESULT.search(proc.stdout), proc.stdout[-1000:]
    out = tmp_path / "results" / "ADNI_zoo"
    assert RESULT.search((out / "log.txt").read_text())
    for fold in range(3):
        assert (out / f"fold_result_generic_GIN_layers2_hidden8_h1_fold_"
                      f"{fold}.npz").exists()
    # a Nested* route in-process, over the nested TUTEST at h=1
    monkeypatch.chdir(tmp_path)
    res = port_main.main(["--model", "NestedGIN0", *argv[2:-1], "_nested",
                          "--use_rd", "--node_label", "spd"])
    assert len(res) == 1 and res[0].accs.shape == (3, 1)
    assert RESULT.search(capsys.readouterr().out)
