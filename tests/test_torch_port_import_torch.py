"""The port's reference-checkpoint converter
(`iggcn_tpu_torch/tools/import_torch.py`) and `--init_from_torch` against
the JAX package's (`iggcn_tpu/tools/import_torch.py`, `main.py`):

  * `export_reference_state_dict` gives the JAX exporter's keys and
    tensors for one flax tree; `infer_model_config` and
    `convert_fused_state_dict` give the JAX converter's config and trees,
    bit-equal, from that state_dict (the PyG < 2.0 conv layout too);
  * the round trip tree -> .pt -> tree is exact (the gene coding's
    off-mask entries aside, which every consumer masks: the eval forward
    is unchanged), the CLI's `.pt` -> bundle and `--reverse` round trips
    are exact, and every error path raises `ImportError_` where the JAX
    converter does;
  * `--init_from_torch` builds the JAX CLI's warm start (trees and tag),
    starts fold 0 from the converted weights bit for bit, prints its tag,
    and refuses what the JAX CLI refuses."""
import dataclasses
import os

import numpy as np
import pytest
import torch

import main as jax_cli
from iggcn_tpu.config import ModelConfig as JaxMC
from iggcn_tpu.tools import import_torch as jax_it
from iggcn_tpu_torch import main as port_main
from iggcn_tpu_torch.config import ModelConfig
from iggcn_tpu_torch.data.go_graph import synthetic_topology
from iggcn_tpu_torch.models.fused_sgcn import FusedSGCN
from iggcn_tpu_torch.models.nn_compat import BatchNorm1d
from iggcn_tpu_torch.tools import import_torch as it
from iggcn_tpu_torch.tools.convert import (load_flax_variables,
                                           to_flax_variables)
from iggcn_tpu_torch.tools.serve import load_bundle, save_bundle
from iggcn_tpu_torch.train import cv as port_cv

SMALL = dict(num_layers=2, hidden=4, hidden_linear=8, l_dim=8, num_classes=3)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _model(cfg, seed=0, topo_seed=0):
    """A fused model with seeded random weights and batch statistics."""
    topo = synthetic_topology(np.random.default_rng(topo_seed))
    gen = torch.Generator().manual_seed(seed)
    model = FusedSGCN(cfg, topo, generator=gen).eval()
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, BatchNorm1d):
                m.running_mean.normal_(0.0, 0.3, generator=gen)
                m.running_var.uniform_(0.5, 2.0, generator=gen)
    return model


@pytest.fixture(scope="module")
def fused():
    model = _model(ModelConfig(**SMALL))
    variables = to_flax_variables(model)
    sd = it.export_reference_state_dict(variables["params"],
                                        variables["batch_stats"],
                                        model.topo, model.cfg)
    return model, variables, {k: torch.from_numpy(v) for k, v in sd.items()}


def _leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaves(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _assert_same_tree(got, want):
    got, want = _leaves(got), _leaves(want)
    assert got.keys() == want.keys()
    for key, w in want.items():
        assert got[key].dtype == w.dtype and got[key].shape == w.shape, key
        np.testing.assert_array_equal(got[key], w, err_msg=key)


def test_export_matches_jax(fused):
    model, variables, _ = fused
    got = it.export_reference_state_dict(variables["params"],
                                         variables["batch_stats"],
                                         model.topo, model.cfg)
    want = jax_it.export_reference_state_dict(
        variables["params"], variables["batch_stats"], model.topo,
        JaxMC(**SMALL))
    assert got.keys() == want.keys()
    for key, w in want.items():
        assert got[key].dtype == w.dtype, key
        np.testing.assert_array_equal(got[key], w, err_msg=key)


@pytest.mark.parametrize("conv_layout", ["pyg2", "pyg1"])
def test_infer_and_convert_match_jax(fused, conv_layout):
    model, _, sd = fused
    sd = dict(sd)
    if conv_layout == "pyg1":   # a direct (in, out) `weight`
        for base in ("conv1", "convs.0"):
            sd[f"{base}.weight"] = sd.pop(f"{base}.lin.weight").T.contiguous()
    cfg = it.infer_model_config(sd, model.topo)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(
        jax_it.infer_model_config(sd, model.topo))
    assert cfg == model.cfg
    got = it.convert_fused_state_dict(sd, model.topo, cfg)
    want = jax_it.convert_fused_state_dict(sd, model.topo,
                                           JaxMC(**dataclasses.asdict(cfg)))
    for g, w in zip(got, want):
        _assert_same_tree(g, w)


def test_round_trip_is_exact(fused):
    """Every leaf comes back but the gene coding's off-mask entries (the
    state_dict holds the on-mask values only); the eval forward is the
    same bit for bit."""
    model, variables, sd = fused
    params, stats = it.convert_fused_state_dict(sd, model.topo, model.cfg)
    got, want = _leaves({"p": params, "s": stats}), _leaves(
        {"p": variables["params"], "s": variables["batch_stats"]})
    mask = model.topo.go_snps != 0
    for key, w in want.items():
        g = got[key]
        if key.startswith("p/go_network/gene_"):
            on = mask if g.shape == mask.shape else mask.T
            np.testing.assert_array_equal(g[on], w[on], err_msg=key)
            assert (g[~on] == 1.0).all()
        else:
            np.testing.assert_array_equal(g, w, err_msg=key)
    twin = load_flax_variables(FusedSGCN(model.cfg, model.topo), params,
                               stats).eval()
    rng = np.random.default_rng(1)
    x = torch.as_tensor(rng.normal(size=(4, 90, 3)), dtype=torch.float32)
    adj = torch.as_tensor(np.abs(rng.normal(size=(4, 90, 90))),
                          dtype=torch.float32)
    snps = torch.as_tensor(rng.random((4, 54)), dtype=torch.float32)
    with torch.no_grad():
        a, b = model(x, adj, snps), twin(x, adj, snps)
    for field, want in a._asdict().items():
        torch.testing.assert_close(getattr(b, field), want, rtol=0, atol=0)


def _mutations(sd, topo):
    """(name, broken state_dict, topology) cases that must not import."""
    missing = dict(sd)
    del missing["lin2.bias"]
    unknown = {**sd, "mystery.weight": torch.zeros(2)}
    shape = {**sd, "lin2.bias": torch.zeros(7)}
    other_topo = synthetic_topology(np.random.default_rng(9))
    no_prob = {k: v for k, v in sd.items() if k != "prob"}
    return [("missing key", missing, topo), ("unknown key", unknown, topo),
            ("shape", shape, topo), ("other topology", sd, other_topo),
            ("not a fused checkpoint", no_prob, topo)]


@pytest.mark.parametrize("case", range(5))
def test_error_paths_raise_as_in_jax(fused, case):
    model, _, sd = fused
    _, broken, topo = _mutations(sd, model.topo)[case]
    for mod in (it, jax_it):
        with pytest.raises(mod.ImportError_):
            mod.convert_fused_state_dict(
                broken, topo, mod.infer_model_config(broken, topo))


def test_load_state_dict_refuses_what_is_not_one(tmp_path):
    path = str(tmp_path / "list.pt")
    torch.save([torch.zeros(2)], path)
    for mod in (it, jax_it):
        with pytest.raises(mod.ImportError_, match="flat state_dict"):
            mod._load_state_dict(path)


def test_cli_imports_and_reverses_exactly(fused, tmp_path, capsys):
    """.pt -> bundle -> .pt -> bundle: the second bundle holds the first's
    weights bit for bit, and serves as the model the .pt came from."""
    model, _, sd = fused
    pt, b1, pt2, b2 = (str(tmp_path / n) for n in ("a.pt", "a.npz",
                                                    "b.pt", "b.npz"))
    torch.save(sd, pt)
    assert it.main(["--ckpt", pt, "--out", b1,
                    "--synthetic_topo_seed", "0"]) == 0
    assert it.main(["--reverse", "--ckpt", b1, "--out", pt2]) == 0
    assert it.main(["--ckpt", pt2, "--out", b2,
                    "--synthetic_topo_seed", "0"]) == 0
    out = capsys.readouterr().out
    assert "reference-layout state_dict" in out and "parameters; config" in out
    again = torch.load(pt2, weights_only=True)
    assert again.keys() == sd.keys()
    for key, value in sd.items():
        torch.testing.assert_close(again[key], value, rtol=0, atol=0)
    first, second = (to_flax_variables(load_bundle(b, device="cpu"))
                     for b in (b1, b2))
    _assert_same_tree(second, first)
    # the JAX tool reads the port's reverse export into the same trees
    jsd = jax_it._load_state_dict(pt2)
    jcfg = jax_it.infer_model_config(jsd, model.topo)
    _assert_same_tree(dict(zip(("params", "batch_stats"),
                               jax_it.convert_fused_state_dict(
                                   jsd, model.topo, jcfg))), first)


@pytest.mark.parametrize("knob", ["model4eachregr", "is_use_prob4regr"])
def test_reverse_refuses_non_reference_knobs(tmp_path, capsys, knob):
    cfg = ModelConfig(**SMALL, **{knob: knob == "model4eachregr"})
    path = str(tmp_path / "b.npz")
    save_bundle(path, _model(cfg))
    assert it.main(["--reverse", "--ckpt", path,
                    "--out", str(tmp_path / "x.pt")]) == 1
    assert "non-reference" in capsys.readouterr().err


# ---------------------------------------------------------------------------
# --init_from_torch

SEED = 4
RUN = ["--synthetic", "--synthetic_subjects", "30", "--epochs", "1",
       "--fold", "3", "--batch_size", "8", "--disease_id", "0",
       "--no-search", "--layers", "2", "--hiddens", "8", "--seed", str(SEED),
       "--cohort_cache_dir", ""]


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    """A reference-layout .pt of the architecture `RUN` trains, over the
    synthetic topology the run draws."""
    model = _model(ModelConfig(num_layers=2, hidden=8, num_classes=2),
                   seed=2, topo_seed=SEED)
    variables = to_flax_variables(model)
    path = str(tmp_path_factory.mktemp("ckpt") / "gcn_state_dict_ref.pt")
    torch.save({k: torch.from_numpy(v) for k, v in
                it.export_reference_state_dict(
                    variables["params"], variables["batch_stats"],
                    model.topo, model.cfg).items()}, path)
    return path, model.topo


def test_warm_start_is_the_jax_cli_warm_start(checkpoint, capsys):
    path, topo = checkpoint
    argv = RUN + ["--init_from_torch", path]
    args = port_main.build_parser().parse_args(argv)
    lines = []
    got = port_main.build_warm_start(args, port_main.build_dcfg(args), topo,
                                     port_main.combos(args), lines.append)
    jargs = jax_cli.build_parser().parse_args(argv)
    want = jax_cli._build_warm_start(jargs, jax_cli._build_dcfg(jargs), topo,
                                     jax_cli._combos(jargs), lines.append)
    _assert_same_tree({"p": got[0], "s": got[1]},
                      {"p": want[0], "s": want[1]})
    assert got[2] == want[2] and got[2].startswith("gcn_state_dict_ref.pt:")
    assert lines[0] == lines[1] == (
        f"[init_from_torch] warm-starting every fold from {got[2]}")
    capsys.readouterr()


def test_cli_starts_every_fold_from_the_checkpoint(checkpoint, tmp_path,
                                                   monkeypatch, capsys):
    path, topo = checkpoint
    monkeypatch.chdir(tmp_path)
    want = _leaves(dict(zip(("params", "batch_stats"),
                            it.convert_fused_state_dict(
                                it._load_state_dict(path), topo,
                                ModelConfig(num_layers=2, hidden=8,
                                            num_classes=2)))))
    seen = []
    fold_init = port_cv.init_fold_model

    def capture(*a, **kw):
        model, generator = fold_init(*a, **kw)
        seen.append(_leaves(to_flax_variables(model)))
        return model, generator

    monkeypatch.setattr(port_cv, "init_fold_model", capture)
    port_main.main(["--device", "cpu", *RUN, "--init_from_torch", path,
                    "--save_appendix", "_warm"])
    out = capsys.readouterr().out
    assert "[init_from_torch] warm-starting every fold from " \
           "gcn_state_dict_ref.pt:" in out and "Result - " in out
    assert len(seen) == 3
    for fold in seen:
        assert fold.keys() == want.keys()
        for key, w in want.items():
            np.testing.assert_array_equal(fold[key], w, err_msg=key)
    log = (tmp_path / "results" / "ADNI_warm" / "log.txt").read_text()
    assert log.startswith("[init_from_torch] warm-starting every fold")


@pytest.mark.parametrize("extra,what", [
    (["--model", "GCN_IMGSNP"], "supports --model SGCN_GCN_IMGSNP only"),
    (["--isTestAdnitype"], "does not combine with --isTestAdnitype"),
    (["--init_from_torch", "/nonexistent.pt"], "does not exist"),
])
def test_cli_refuses_what_the_jax_cli_refuses(checkpoint, tmp_path,
                                              monkeypatch, capsys, extra,
                                              what):
    monkeypatch.chdir(tmp_path)
    argv = ["--device", "cpu", *RUN, "--init_from_torch", checkpoint[0],
            *extra]
    for cli in (port_main, jax_cli):
        with pytest.raises(SystemExit):
            cli.main(argv if cli is port_main else argv[2:])
        assert what in capsys.readouterr().err
    assert not os.path.exists(tmp_path / "results")


@pytest.mark.parametrize("extra,what", [
    (["--search"], "a grid search cannot warm-start"),
    (["--hiddens", "16"], "hidden: checkpoint 8 vs run 16"),
])
def test_cli_aborts_on_an_architecture_it_cannot_load(checkpoint, tmp_path,
                                                      monkeypatch, capsys,
                                                      extra, what):
    monkeypatch.chdir(tmp_path)
    with pytest.raises(SystemExit) as exc:
        port_main.main(["--device", "cpu", *RUN, "--init_from_torch",
                        checkpoint[0], *extra])
    assert exc.value.code == 2 and what in capsys.readouterr().err
