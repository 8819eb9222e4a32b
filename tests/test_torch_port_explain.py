"""The port's explain tool (`iggcn_tpu_torch/tools/explain.py`) against the
JAX one on the same weights, on the CPU: `load_payload` on a msgpack
checkpoint written by either package and on a serving bundle; the
exported importances bit-equal; the edge probabilities within atol 1e-6;
grad-CAM of `SGCNImage` (GCN and GAT stacks) and `SGCNOri` within atol
1e-5 (pooled, on each subject's predicted class and on a given class);
and the CLI, whose `--plot` figures are pixel-equal to the JAX tool's."""
import jax
import numpy as np
import pytest
import torch

from iggcn_tpu.config import ModelConfig as JaxMC
from iggcn_tpu.data.go_graph import synthetic_topology as jax_topology
from iggcn_tpu.models.fused_sgcn import FusedSGCN as JaxFused
from iggcn_tpu.tools import explain as jax_explain
from iggcn_tpu.tools import serve as jax_serve
from iggcn_tpu.train.checkpoint import save_checkpoint as jax_save_checkpoint
from iggcn_tpu_torch.config import ModelConfig
from iggcn_tpu_torch.data.adni import synthetic_cohort
from iggcn_tpu_torch.data.go_graph import synthetic_topology
from iggcn_tpu_torch.models.fused_sgcn import FusedSGCN
from iggcn_tpu_torch.models.sgcn_image import SGCNImage, SGCNOri
from iggcn_tpu_torch.tools import explain
from iggcn_tpu_torch.tools.convert import to_flax_variables
from iggcn_tpu_torch.train.checkpoint import save_checkpoint

SMALL = dict(num_layers=2, hidden=8, hidden_linear=16, l_dim=8)


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
def data(tmp_path_factory):
    c = synthetic_cohort(np.random.default_rng(1), num_subjects=12)
    root = tmp_path_factory.mktemp("explain")
    x, adj = c.x.astype(np.float32), c.adj.astype(np.float32)
    np.save(root / "x.npy", x)
    np.save(root / "adj.npy", adj)
    return root, x, adj


def _with_random_importances(model, seed=4):
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name in ("prob", "snps_prob", "prob_bias"):
                p.normal_(0.0, 0.5, generator=gen)
        for name, buf in model.named_buffers():
            if name.endswith("running_mean"):
                buf.normal_(0.0, 0.3, generator=gen)
            elif name.endswith("running_var"):
                buf.uniform_(0.5, 2.0, generator=gen)
    return model


@pytest.fixture(scope="module")
def fused(data):
    """A fused model's weights as a JAX-written checkpoint, a port-written
    checkpoint and a JAX-written bundle."""
    root = data[0]
    model = _with_random_importances(FusedSGCN(
        ModelConfig(**SMALL), synthetic_topology(np.random.default_rng(0)),
        generator=torch.Generator().manual_seed(0)))
    v = to_flax_variables(model)
    paths = {"jax": str(root / "jax.msgpack"),
             "port": str(root / "port.msgpack"),
             "bundle": str(root / "bundle.npz")}
    jax_save_checkpoint(paths["jax"], v["params"], v["batch_stats"])
    save_checkpoint(paths["port"], v["params"], v["batch_stats"])
    jax_serve.save_bundle(paths["bundle"], JaxFused(
        cfg=JaxMC(**SMALL), topo=jax_topology(np.random.default_rng(0))),
        v["params"], v["batch_stats"])
    return v, paths


@pytest.mark.parametrize("kind", ["jax", "port", "bundle"])
def test_load_payload_reads_both_formats(fused, kind):
    variables, paths = fused
    got = explain.load_payload(paths[kind])
    want = jax_explain.load_payload(paths[kind])
    for tree in (got, want):
        jax.tree_util.tree_map(np.testing.assert_array_equal,
                               {k: tree[k] for k in variables}, variables)


def test_importances_and_edge_probabilities_match_jax(fused, data, tmp_path):
    root, x, _ = data
    params = fused[0]["params"]
    got = explain.export_importances(params, str(tmp_path / "port"))
    want = jax_explain.export_importances(params, str(tmp_path / "jax"))
    assert sorted(got) == sorted(want) == ["prob", "prob_bias", "snps_prob"]
    for f in sorted(p.name for p in (tmp_path / "jax").iterdir()):
        np.testing.assert_array_equal(np.load(tmp_path / "port" / f),
                                      np.load(tmp_path / "jax" / f))
    ep = explain.export_edge_probabilities(params, x, str(tmp_path / "port"),
                                           device="cpu")
    ep_jax = jax_explain.export_edge_probabilities(params, x,
                                                   str(tmp_path / "jax"))
    assert ep.shape == (len(x), 90, 90)
    np.testing.assert_allclose(ep, ep_jax, atol=1e-6)


def _image_model(case):
    g = torch.Generator().manual_seed(1)
    if case == "SGCNOri":
        return _with_random_importances(SGCNOri(generator=g))
    return _with_random_importances(SGCNImage(
        num_layers=2, hidden=8, hidden_linear=64, use_gat=case == "GAT",
        generator=g))


@pytest.mark.parametrize("case", ["GCN", "GAT", "SGCNOri"])
@pytest.mark.parametrize("class_index", [None, 1])
def test_grad_cam_matches_jax(data, tmp_path, case, class_index):
    _, x, adj = data
    v = to_flax_variables(_image_model(case))
    got = explain.export_grad_cam(v["params"], v["batch_stats"], x, adj,
                                  str(tmp_path), class_index=class_index,
                                  device="cpu")
    want = jax_explain.export_grad_cam(v["params"], v["batch_stats"], x, adj,
                                       str(tmp_path / "jax"),
                                       class_index=class_index)
    assert got.shape == (len(x), 90) and got.dtype == np.float32
    assert np.abs(want).max() > 0
    np.testing.assert_allclose(got, want, atol=1e-5)
    unpooled = explain.grad_cam(_image_model(case), x, adj, pooled=False)
    assert unpooled.shape == (len(x), 90) and (unpooled >= 0).all()
    with pytest.raises(ValueError, match="out of range"):
        explain.grad_cam(_image_model(case), x, adj, class_index=2)


def test_cli_exports_and_refuses_plot(fused, data, tmp_path, capsys,
                                      monkeypatch):
    root = data[0]
    out = str(tmp_path / "out")
    explain.main([fused[1]["port"], "--out", out, "--x_npy",
                  str(root / "x.npy"), "--adj_npy", str(root / "adj.npy"),
                  "--device", "cpu"])
    text = capsys.readouterr().out
    assert "edge probabilities (12, 90, 90) exported" in text
    assert "grad-CAM skipped: fused-model checkpoint" in text
    image = to_flax_variables(_image_model("GCN"))
    ckpt = str(tmp_path / "sgcn.msgpack")
    save_checkpoint(ckpt, image["params"], image["batch_stats"])
    explain.main([ckpt, "--out", out, "--prefix", "img", "--x_npy",
                  str(root / "x.npy"), "--adj_npy", str(root / "adj.npy"),
                  "--device", "cpu"])
    assert "grad-CAM saliency (12, 90) exported" in capsys.readouterr().out
    assert np.load(tmp_path / "out" / "grad_cam_img.npy").shape == (12, 90)
    # --plot: every figure of the JAX tool, pixel for pixel
    from matplotlib.image import imread
    for name, path in (("fused", fused[1]["port"]), ("img", ckpt)):
        for tool, sub in ((explain, "port_plot"), (jax_explain, "jax_plot")):
            tool.main([path, "--out", str(tmp_path / sub), "--prefix", name,
                       "--x_npy", str(root / "x.npy"), "--adj_npy",
                       str(root / "adj.npy"), "--plot"]
                      + (["--device", "cpu"] if tool is explain else []))
    pngs = sorted(p.name for p in (tmp_path / "jax_plot").glob("*.png"))
    assert pngs == sorted(p.name for p in
                          (tmp_path / "port_plot").glob("*.png"))
    assert {"node_importance_fused.png", "snps_importance_fused.png",
            "edge_probability_fused.png", "grad_cam_img.png"} <= set(pngs)
    for png in pngs:
        got = imread(tmp_path / "port_plot" / png)
        assert np.array_equal(got, imread(tmp_path / "jax_plot" / png)), png
    assert "figure " in capsys.readouterr().out
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        explain.main([ckpt, "--out", out])
