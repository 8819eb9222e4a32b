"""What the port's experiments keep, against the JAX package on the CPU:

  * the checkpoint codec (`iggcn_tpu_torch/train/checkpoint.py`) writes the
    bytes `flax.serialization.to_bytes` writes for the same tree (0-d
    leaves and NumPy scalars included) and reads every width flax emits;
    a port-written fold checkpoint restores leaf for leaf in the JAX
    `load_checkpoint`, and the port reads a JAX-written one;
  * `config_fingerprint` and the fold record's `meta` are the JAX CV's for
    the default configs and the GUIDE, multi-fusion and no-val variants;
  * resume on a 3-fold, 2-epoch CPU run, as `tests/test_resume.py` holds
    the JAX CV: a full resume trains nothing, a partial one reproduces the
    uninterrupted run exactly, a changed config or model family retrains,
    a corrupt record is ignored; fold records cross between the packages
    in both directions;
  * the best-epoch checkpoint holds the weights of the epoch the val loss
    picked (first strict minimum)."""
import dataclasses
import glob
import os
import shutil

import jax
import numpy as np
import pytest
import torch
from flax import serialization

from iggcn_tpu.config import LossWeights as JaxLW
from iggcn_tpu.config import ModelConfig as JaxMC
from iggcn_tpu.config import TrainConfig as JaxTC
from iggcn_tpu.data.adni import synthetic_cohort as jax_cohort
from iggcn_tpu.data.go_graph import synthetic_topology as jax_topology
from iggcn_tpu.train import checkpoint as jax_checkpoint
from iggcn_tpu.train.cv import cross_validation as jax_cv
from iggcn_tpu.train.records import config_fingerprint as jax_fingerprint
from iggcn_tpu_torch.config import LossWeights, ModelConfig, TrainConfig
from iggcn_tpu_torch.data.adni import synthetic_cohort
from iggcn_tpu_torch.data.go_graph import synthetic_topology
from iggcn_tpu_torch.models.fused_sgcn import FusedSGCN
from iggcn_tpu_torch.tools.convert import to_flax_variables
from iggcn_tpu_torch.train import checkpoint, cv as port_cv
from iggcn_tpu_torch.train.records import config_fingerprint

MODEL = dict(num_layers=1, hidden=4, hidden_linear=8, l_dim=8, num_classes=2)
LOSS = dict(disease=1.0, regr=1.0, prob=0.5, reco=1.5e-6, simi=0.1)
TRAIN = dict(epochs=2, batch_size=8, lr=1e-3, folds=3, seed=7)
EXECUTION = ("use_fold_scan", "fold_parallel", "device_gather",
             "dual_pass_vmap", "scan_unroll")


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
def data():
    return (synthetic_cohort(np.random.default_rng(1), num_subjects=36),
            synthetic_topology(np.random.default_rng(0)))


def _cfgs(**train):
    return (ModelConfig(**MODEL),
            TrainConfig(**{**TRAIN, **train}, loss=LossWeights(**LOSS)))


def _run(data, res_dir, mcfg=None, tcfg=None, **kw):
    if mcfg is None:
        mcfg, tcfg = _cfgs()
    return port_cv.cross_validation(*data, mcfg, tcfg, res_dir=str(res_dir),
                                    result_file_name="res", verbose=False,
                                    device="cpu", **kw)


@pytest.fixture(scope="module")
def base_run(data, tmp_path_factory):
    """One uninterrupted run; each test works on a copy of its dir."""
    d = tmp_path_factory.mktemp("port_base")
    return d, _run(data, d)


def _copy(base_run, tmp_path):
    src, res = base_run
    d = tmp_path / "run"
    shutil.copytree(src, d)
    return d, res


def _assert_same(a, b):
    np.testing.assert_array_equal(a.score_result, b.score_result)
    assert a.mean_test_loss == b.mean_test_loss
    assert (a.best_acc, a.best_acc_std) == (b.best_acc, b.best_acc_std)
    for nm, vals in a.regression_summary.items():
        for k, v in vals.items():
            np.testing.assert_allclose(b.regression_summary[nm][k], v,
                                       rtol=1e-6, atol=1e-9)


def _trees():
    rng = np.random.default_rng(0)
    model = FusedSGCN(ModelConfig(**MODEL),
                      synthetic_topology(np.random.default_rng(0)),
                      generator=torch.Generator().manual_seed(0))
    yield "fused model", to_flax_variables(model)
    yield "leaf kinds", {
        "params": {"w": rng.normal(size=(3, 4)).astype(np.float32),
                   "alpha": np.array(0.25, np.float32),
                   "scale": np.float32(1.5), "step": np.int64(70000),
                   "ids": np.arange(300, dtype=np.int32),
                   "empty": np.zeros((0, 2), np.float64),
                   "big": rng.normal(size=(200, 200)).astype(np.float32),
                   "nested": {f"k{i}": np.full(i, i, np.float32)
                              for i in range(20)}},
        "batch_stats": {}}
    yield "python scalars", {"a": 1, "b": -3, "c": -200, "d": 300,
                             "e": 70000, "f": 2 ** 40, "g": -2 ** 40,
                             "h": 1.5, "i": True, "j": None, "s": "x" * 40,
                             "t": "y" * 300}


@pytest.mark.parametrize("name,tree", list(_trees()),
                         ids=[n for n, _ in _trees()])
def test_codec_writes_flax_bytes_and_reads_them(name, tree):
    want = serialization.to_bytes(tree)
    assert checkpoint.to_bytes(tree) == want
    got = checkpoint.from_bytes(want)
    flat_got = jax.tree_util.tree_leaves_with_path(got)
    flat_want = jax.tree_util.tree_leaves_with_path(
        serialization.msgpack_restore(want))
    assert [p for p, _ in flat_got] == [p for p, _ in flat_want]
    for (path, g), (_, w) in zip(flat_got, flat_want):
        assert type(g) is type(w), path
        np.testing.assert_array_equal(g, w, err_msg=str(path))


def test_codec_refuses_what_flax_would_chunk(monkeypatch):
    monkeypatch.setattr(checkpoint, "MAX_CHUNK_SIZE", 64)
    with pytest.raises(ValueError, match="MAX_CHUNK_SIZE"):
        checkpoint.to_bytes({"w": np.zeros(17, np.float32)})
    with pytest.raises(TypeError, match="tuple"):
        checkpoint.to_bytes({"w": (1, 2)})


def test_fold_checkpoints_cross_between_packages(tmp_path):
    _, variables = next(_trees())
    port_path = str(tmp_path / "port.msgpack")
    jax_path = str(tmp_path / "jax.msgpack")
    checkpoint.save_checkpoint(port_path, variables["params"],
                               variables["batch_stats"])
    jax_checkpoint.save_checkpoint(jax_path, variables["params"],
                                   variables["batch_stats"])
    with open(port_path, "rb") as a, open(jax_path, "rb") as b:
        assert a.read() == b.read()
    template = jax.tree_util.tree_map(np.zeros_like, variables)
    restored = jax_checkpoint.load_checkpoint(port_path, template)
    read = checkpoint.load_checkpoint(jax_path)
    for tree in (restored, read):
        jax.tree_util.tree_map(np.testing.assert_array_equal, tree,
                               variables)


def _jax_meta(jmcfg, jtcfg, kind):
    identity = dataclasses.asdict(jtcfg)
    for key in EXECUTION:
        identity.pop(key)
    return jax_fingerprint(model_kind=kind, mcfg=jmcfg, **identity)


@pytest.mark.parametrize("case", ["default", "guide", "multi_fusion",
                                  "no_val"])
def test_config_fingerprint_matches_jax(case):
    model, train, kind = {}, {}, "sgcn_imgsnp"
    if case == "guide":
        kind, train = "guide_imgsnp", {"temperature": 0.5}
    elif case == "multi_fusion":
        model = dict(rois=270, feat_dim=1, is_multi_fusion=True,
                     num_layers=3, hidden=10)
    elif case == "no_val":
        train = {"no_val": True, "lr": 3e-3,
                 "loss": LossWeights(disease=1.0)}
    jtrain = {k: (JaxLW(**dataclasses.asdict(v)) if k == "loss" else v)
              for k, v in train.items()}
    mcfg, tcfg = ModelConfig(**model), TrainConfig(**train)
    jmcfg, jtcfg = JaxMC(**model), JaxTC(**jtrain)
    assert config_fingerprint(a=1, mcfg=mcfg) == jax_fingerprint(
        a=1, mcfg=jmcfg)
    meta = port_cv.record_meta(tcfg, mcfg, kind)
    assert meta.dtype == np.int64 and meta[-1] == _jax_meta(jmcfg, jtcfg,
                                                            kind)
    assert meta[4] == int(tcfg.no_val)


def test_full_resume_skips_all_training(data, base_run, tmp_path,
                                        monkeypatch):
    d, base = _copy(base_run, tmp_path)
    assert len(glob.glob(str(d / "fold_result_res_fold_*.npz"))) == 3
    assert len(glob.glob(str(d / "gcn_state_dict_res_fold_*.msgpack"))) == 3

    def boom(*a, **k):
        raise AssertionError("training was attempted on a complete resume")

    monkeypatch.setattr(port_cv, "run_fold", boom)
    resumed = _run(data, d, resume=True)
    _assert_same(base, resumed)
    assert resumed.throughput_graphs_per_sec == 0.0


def test_partial_resume_reproduces_uninterrupted_run(data, base_run,
                                                     tmp_path):
    d, base = _copy(base_run, tmp_path)
    for f in (1, 2):
        os.remove(d / f"fold_result_res_fold_{f}.npz")
    lines = []
    resumed = _run(data, d, resume=True, logger=lines.append)
    restored = [ln for ln in lines if "restored" in ln]
    assert len(restored) == 1 and "fold 0 restored" in restored[0]
    _assert_same(base, resumed)
    assert len(glob.glob(str(d / "fold_result_res_fold_*.npz"))) == 3


@pytest.mark.parametrize("change", [dict(seed=8), dict(lr=2e-3),
                                    dict(kind="gcn_imgsnp")],
                         ids=["seed", "lr", "model_family"])
def test_resume_retrains_another_config(data, base_run, tmp_path, capsys,
                                        change):
    d, _ = _copy(base_run, tmp_path)
    kind = change.pop("kind", "sgcn_imgsnp")
    mcfg, tcfg = _cfgs(**change)
    resumed = _run(data, d, mcfg, tcfg, resume=True, model_kind=kind)
    assert "different config" in capsys.readouterr().out
    assert resumed.throughput_graphs_per_sec > 0.0


def test_resume_ignores_corrupt_record(data, base_run, tmp_path, capsys):
    d, base = _copy(base_run, tmp_path)
    (d / "fold_result_res_fold_0.npz").write_bytes(b"not an npz")
    resumed = _run(data, d, resume=True)
    assert "unreadable" in capsys.readouterr().out
    _assert_same(base, resumed)


def test_fold_records_cross_between_packages(data, base_run, tmp_path,
                                             capsys):
    """A JAX CV over the same configuration restores the port's records,
    and the port's CV restores the JAX one's: every fold, nothing
    trained, the same aggregates as the writer's run."""
    port_dir, port_res = _copy(base_run, tmp_path)
    jmcfg, jtcfg = JaxMC(**MODEL), JaxTC(**TRAIN, loss=JaxLW(**LOSS))
    jdata = (jax_cohort(np.random.default_rng(1), num_subjects=36),
             jax_topology(np.random.default_rng(0)))
    jax_dir = tmp_path / "jax"
    kw = dict(result_file_name="res", verbose=False)
    jax_res = jax_cv(*jdata, jmcfg, jtcfg, res_dir=str(jax_dir), **kw)
    capsys.readouterr()
    lines = []
    from_port = jax_cv(*jdata, jmcfg, jtcfg, res_dir=str(port_dir),
                       resume=True, logger=lines.append, **kw)
    from_jax = _run(data, jax_dir, resume=True, logger=lines.append)
    out = capsys.readouterr().out + "\n".join(lines)
    assert out.count("training skipped") == 6 and "different" not in out
    _assert_same(port_res, from_port)
    _assert_same(jax_res, from_jax)
    assert from_port.throughput_graphs_per_sec == 0.0
    assert from_jax.throughput_graphs_per_sec == 0.0


def test_best_epoch_checkpoint_holds_the_picked_epoch(data, tmp_path,
                                                      monkeypatch):
    """Each epoch's weights are captured as the epoch ends; the fold's
    checkpoint must equal the ones of the epoch with the first strict
    minimum of the val loss, and the CV must have trained more than one
    epoch per fold so the pick is not trivial."""
    snaps, vals = [], []
    real_run_fold = port_cv.run_fold

    def capturing(state, *args):
        fold_snaps, fold_vals = [], []
        on_epoch = args[-1]

        def hook(epoch, rec):
            fold_snaps.append(to_flax_variables(state.model))
            fold_vals.append(rec["val_loss_sum"])
            on_epoch(epoch, rec)

        snaps.append(fold_snaps)
        vals.append(fold_vals)
        return real_run_fold(state, *args[:-1], hook)

    monkeypatch.setattr(port_cv, "run_fold", capturing)
    mcfg, tcfg = _cfgs(epochs=3, lr=3e-3)
    _run(data, tmp_path, mcfg, tcfg)
    picked = []
    for fold, (fold_snaps, fold_vals) in enumerate(zip(snaps, vals)):
        best = min(range(len(fold_vals)), key=lambda e: fold_vals[e])
        picked.append(best)
        got = checkpoint.load_checkpoint(
            str(tmp_path / f"gcn_state_dict_res_fold_{fold}.msgpack"))
        jax.tree_util.tree_map(np.testing.assert_array_equal, got,
                               fold_snaps[best])
        if best != len(fold_vals) - 1:
            other = jax.tree_util.tree_leaves(fold_snaps[-1])
            assert any(not np.array_equal(a, b) for a, b in
                       zip(jax.tree_util.tree_leaves(got), other))
    assert len(snaps) == 3 and all(len(s) == 3 for s in snaps)
