"""The port's plotting and clustering utilities against the JAX
package's, on the same inputs, on the CPU: every figure of
`utils/plots.py` and `utils/visualize.py` pixel-equal
(`matplotlib.image.imread`) to the JAX module's, and the artifacts of
`data/cluster.py` (similarity features, t-SNE embedding, KMeans labels,
the scatter figures) equal to `iggcn_tpu/data/cluster.py`'s, and the
elbow curve within rtol 1e-5 (scikit-learn's threaded float32 sums).
`tools/explain.py --plot` and `tools/report.py --plot` are held in
`test_torch_port_explain.py` and `test_torch_port_report.py`."""
import os

import numpy as np
import pytest
from matplotlib.image import imread

from iggcn_tpu.data import cluster as jax_cluster
from iggcn_tpu.utils import plots as jax_plots
from iggcn_tpu.utils import visualize as jax_visualize
from iggcn_tpu_torch.data import cluster
from iggcn_tpu_torch.utils import plots, visualize


def _same_png(a, b):
    got, want = imread(a), imread(b)
    assert got.shape == want.shape and np.array_equal(got, want), (a, b)


def _cases():
    rng = np.random.default_rng(0)
    acc = rng.random((3, 6))
    return {
        "bar": ("plot_importance_bar", (rng.random(40),),
                dict(title="ROI importance", top=12)),
        "bar_named": ("plot_importance_bar", (rng.random(5),),
                      dict(title="SNP importance", item_name="SNP",
                           names=["a", "b", "c", "d", "e"])),
        "curves": ("plot_training_curves", (acc,), dict(title="r")),
        "curves_loss": ("plot_training_curves", (acc,),
                        dict(title="r", loss_by_fold=rng.random((3, 6)))),
        "null": ("plot_null_distribution",
                 (rng.random(30), 0.8, 0.0323), dict(title="tag")),
        "matrix": ("plot_matrix", (rng.random((20, 20)),),
                   dict(title="Edge probability")),
    }


@pytest.mark.parametrize("case", list(_cases()))
def test_each_figure_is_pixel_equal_to_the_jax_one(tmp_path, case):
    fn, args, kwargs = _cases()[case]
    got = getattr(plots, fn)(*args, str(tmp_path / "port" / "f.png"),
                             **kwargs)
    want = getattr(jax_plots, fn)(*args, str(tmp_path / "jax" / "f.png"),
                                  **kwargs)
    assert got.endswith("port/f.png") and os.path.getsize(got) > 2000
    _same_png(got, want)


def test_the_go_dag_drawing_is_pixel_equal(tmp_path):
    paths = []
    for mod, name in ((visualize, "port.png"), (jax_visualize, "jax.png")):
        g = mod.GraphVisualization()
        g.addEdge(0, 1)
        g.add_edges([(1, 2), (1, 3), (3, 4)])
        g.set_labels({i: f"GO{i}" for i in range(5)})
        g.visualize(str(tmp_path / name), figsize=(3, 3))
        paths.append(str(tmp_path / name))
    _same_png(*paths)


@pytest.fixture(scope="module")
def imaging():
    rng = np.random.default_rng(3)
    img = rng.normal(size=(36, 12, 3)).astype(np.float32)
    img[18:] += 2.0       # two groups of subjects
    return img, rng.integers(0, 5, 36)


@pytest.mark.parametrize("mode", ["multimodal", "pet"])
def test_cluster_artifacts_equal_the_jax_module(tmp_path, imaging, mode):
    img, dx = imaging
    dirs = {}
    for name, mod in (("port", cluster), ("jax", jax_cluster)):
        dirs[name] = str(tmp_path / name)
        labels = mod.prepare_cluster_artifacts(
            img, dirs[name], k=2, mode=mode, perplexity=10.0, seed=1000,
            plots=True, diagnosis_labels=dx)
        assert labels.dtype == np.int64 and set(labels) == {0, 1}
    files = sorted(os.path.relpath(os.path.join(r, f), dirs["jax"])
                   for r, _, fs in os.walk(dirs["jax"]) for f in fs)
    assert files == sorted(os.path.relpath(os.path.join(r, f), dirs["port"])
                           for r, _, fs in os.walk(dirs["port"]) for f in fs)
    assert os.path.join("center_2", "clusters_pred_label.npy") in files
    for f in files:
        a, b = (os.path.join(dirs[k], f) for k in ("port", "jax"))
        if f.endswith(".npy"):
            np.testing.assert_array_equal(np.load(a), np.load(b), err_msg=f)
        elif f.endswith(".png"):
            _same_png(a, b)
        else:
            with open(a) as fa, open(b) as fb:
                assert fa.read() == fb.read()
    # the elbow curve: scikit-learn sums the float32 inertia over OpenMP
    # threads in an order that varies from run to run
    feats = cluster.similarity_features(img, mode)
    np.testing.assert_allclose(cluster.calculate_wss(feats, kmax=3),
                               jax_cluster.calculate_wss(feats, kmax=3),
                               rtol=1e-5)
    with pytest.raises(ValueError, match="label_names"):
        cluster.plot_tsne(np.zeros((3, 2)), np.array([0, 1, 7]),
                          str(tmp_path / "x.png"),
                          label_names=cluster.DIAGNOSIS_NAMES)


def test_a_host_without_matplotlib_or_sklearn_gets_the_install_hint(
        tmp_path, monkeypatch, imaging):
    """The card host has neither: `--plot` and the clustering raise with
    the hint, as the JAX package does on a host image without them."""
    import sys
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(ImportError, match="matplotlib is required"):
        plots.plot_matrix(np.eye(3), str(tmp_path / "m.png"), title="m")
    monkeypatch.setitem(sys.modules, "sklearn", None)
    monkeypatch.setitem(sys.modules, "sklearn.cluster", None)
    with pytest.raises(ImportError, match="scikit-learn is required"):
        cluster.prepare_cluster_artifacts(imaging[0], str(tmp_path / "c"))
