"""Every serving-bundle class crosses between the packages, on the CPU:
`FusedSGCN` (GCN and GAT stacks), `GuideImgSnp`, `ClusterLabelSGCN`, and
the SNP-only `GeneOntologyNetwork` (with its classifier head) and
`MLPModel`. A bundle written by the JAX `save_bundle` (the port's own
init, random batch-norm statistics) loads in the port and serves what the
JAX `batched_forward` / `batched_forward_snps` serve: log_probs and our_reg
(where the model has a regression head, and only there) and prob within
atol 1e-5, pred equal wherever the decision is wider than 1e-4. The
port's `save_bundle` writes the same arrays, and the JAX `load_bundle`
rebuilds the same model from it. Then the HTTP daemon's SNP-only route
and its `/health`."""
import dataclasses
import http.client
import io
import json
import threading

import jax
import numpy as np
import pytest
import torch

from iggcn_tpu.config import ModelConfig as JaxMC
from iggcn_tpu.data.go_graph import synthetic_topology as jax_topology
from iggcn_tpu.models.baselines import MLPModel as JaxMLP
from iggcn_tpu.models.clusterlabel import ClusterLabelSGCN as JaxCluster
from iggcn_tpu.models.fused_sgcn import FusedSGCN as JaxFused
from iggcn_tpu.models.go_network import GeneOntologyNetwork as JaxGO
from iggcn_tpu.models.guide import GuideImgSnp as JaxGuide
from iggcn_tpu.predict import batched_forward as jax_forward
from iggcn_tpu.predict import batched_forward_snps as jax_forward_snps
from iggcn_tpu.tools import serve as jax_serve
from iggcn_tpu_torch.config import ModelConfig
from iggcn_tpu_torch.data.adni import synthetic_cohort
from iggcn_tpu_torch.data.go_graph import synthetic_topology
from iggcn_tpu_torch.models.baselines import MLPModel
from iggcn_tpu_torch.models.clusterlabel import ClusterLabelSGCN
from iggcn_tpu_torch.models.fused_sgcn import FusedSGCN
from iggcn_tpu_torch.models.go_network import GeneOntologyNetwork
from iggcn_tpu_torch.models.guide import GuideImgSnp
from iggcn_tpu_torch.predict import batched_forward, batched_forward_snps
from iggcn_tpu_torch.tools import serve
from iggcn_tpu_torch.tools.convert import to_flax_variables

SMALL = dict(num_layers=2, hidden=8, hidden_linear=16, l_dim=8)
N_SUBJECTS, BATCH = 40, 16
# case -> (port class, JAX class, ModelConfig fields); the fused ones take
# (cfg, topo)
CASES = {
    "FusedSGCN": (FusedSGCN, JaxFused, {}),
    "FusedSGCN_gat": (FusedSGCN, JaxFused, {"use_gat": True}),
    "GuideImgSnp": (GuideImgSnp, JaxGuide, {}),
    "ClusterLabelSGCN": (ClusterLabelSGCN, JaxCluster, {}),
    "GeneOntologyNetwork": (None, None, {}),
    "MLPModel": (None, None, {}),
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
def arrays():
    c = synthetic_cohort(np.random.default_rng(1), num_subjects=N_SUBJECTS)
    return {k: getattr(c, k).astype(np.float32) for k in ("x", "adj", "snps")}


def _models(case):
    """(port model with random batch-norm statistics, JAX module)."""
    topo = synthetic_topology(np.random.default_rng(0))
    jtopo = jax_topology(np.random.default_rng(0))
    g = torch.Generator().manual_seed(2)
    port_cls, jax_cls, extra = CASES[case]
    if case == "GeneOntologyNetwork":
        model, jmodel = (GeneOntologyNetwork(topo, classifier=True,
                                             generator=g), JaxGO(topo=jtopo))
    elif case == "MLPModel":
        model, jmodel = MLPModel(54, generator=g), JaxMLP()
    else:
        model = port_cls(ModelConfig(**SMALL, **extra), topo, generator=g)
        jmodel = jax_cls(cfg=JaxMC(**SMALL, **extra), topo=jtopo)
    gen = torch.Generator().manual_seed(9)
    with torch.no_grad():
        for name, buf in model.named_buffers():
            if name.endswith("running_mean"):
                buf.normal_(0.0, 0.3, generator=gen)
            elif name.endswith("running_var"):
                buf.uniform_(0.5, 2.0, generator=gen)
    return model.eval(), jmodel


def _assert_same(got, want):
    assert set(got) == set(want)
    if "prob" in want:
        np.testing.assert_allclose(got["prob"], want["prob"], atol=1e-5)
        decided = np.abs(np.asarray(want["prob"]) - 0.5) > 1e-4
    else:
        np.testing.assert_allclose(got["log_probs"], want["log_probs"],
                                   atol=1e-5)
        if "our_reg" in want:
            np.testing.assert_allclose(got["our_reg"], want["our_reg"],
                                       atol=1e-5)
        lp = np.sort(np.asarray(want["log_probs"]), axis=1)
        decided = lp[:, -1] - lp[:, -2] > 1e-4
    np.testing.assert_array_equal(np.asarray(got["pred"])[decided],
                                  np.asarray(want["pred"])[decided])


def _serve(model, arrays, jax_side=None):
    """Predictions of a port model, or with `jax_side` = (module, params,
    stats) of the JAX package."""
    if jax_side is not None:
        jmodel, params, stats = jax_side
        if hasattr(jmodel, "cfg"):
            return jax_forward(jmodel, params, stats, arrays["x"],
                               arrays["adj"], arrays["snps"],
                               batch_size=BATCH)
        return jax_forward_snps(jmodel, params, stats, arrays["snps"],
                                batch_size=BATCH)
    if hasattr(model, "cfg"):
        return batched_forward(model, arrays["x"], arrays["adj"],
                               arrays["snps"], batch_size=BATCH)
    return batched_forward_snps(model, arrays["snps"], batch_size=BATCH)


@pytest.mark.parametrize("case", list(CASES))
def test_bundle_crosses_both_ways_and_serves_the_same(tmp_path, arrays,
                                                      case):
    model, jmodel = _models(case)
    variables = to_flax_variables(model)
    jax_bundle = str(tmp_path / "jax.npz")
    jax_serve.save_bundle(jax_bundle, jmodel, variables["params"],
                          variables["batch_stats"])
    loaded = serve.load_bundle(jax_bundle, device="cpu")
    assert type(loaded).__name__ == type(jmodel).__name__
    want = _serve(None, arrays, jax_serve.load_bundle(jax_bundle))
    got = _serve(loaded, arrays)
    _assert_same(got, want)
    assert ("our_reg" in got) == (case not in ("ClusterLabelSGCN",
                                               "GeneOntologyNetwork",
                                               "MLPModel"))

    port_bundle = str(tmp_path / "port.npz")
    serve.save_bundle(port_bundle, loaded)
    with np.load(jax_bundle) as a, np.load(port_bundle) as b:
        assert set(a.files) == set(b.files)
        for k in a.files:
            if k != "__meta__":
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        meta_a, meta_b = (json.loads(str(z["__meta__"])) for z in (a, b))
    assert meta_a == meta_b
    back, params, stats = jax_serve.load_bundle(port_bundle)
    assert type(back) is type(jmodel)
    fields = [f.name for f in dataclasses.fields(jmodel)
              if f.name not in ("parent", "name", "topo")]
    assert all(getattr(back, f) == getattr(jmodel, f) for f in fields)
    jax.tree_util.tree_map(np.testing.assert_array_equal,
                           (params, stats),
                           (variables["params"], variables["batch_stats"]))


def test_best_epoch_weights_go_into_the_bundle(tmp_path, arrays):
    model, _ = _models("FusedSGCN")
    best = to_flax_variables(model)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(1.0)
    path = str(tmp_path / "best.npz")
    serve.save_bundle(path, model, best["params"], best["batch_stats"])
    again = to_flax_variables(serve.load_bundle(path, device="cpu"))
    jax.tree_util.tree_map(np.testing.assert_array_equal, again, best)
    with pytest.raises(ValueError, match="no bundle layout"):
        serve.save_bundle(path, torch.nn.Linear(2, 2))


def test_snps_batched_forward_refuses_other_widths(arrays):
    model, _ = _models("GeneOntologyNetwork")
    with pytest.raises(ValueError, match="expects 54"):
        batched_forward_snps(model, arrays["snps"][:, :50],
                             expected_width=54)
    with pytest.raises(ValueError, match="2-D"):
        batched_forward_snps(model, arrays["snps"][0])
    empty = batched_forward_snps(model, arrays["snps"][:0])
    assert empty["prob"].shape == (0,) and empty["pred"].dtype == np.int32


def _request(addr, method, path, body=None):
    conn = http.client.HTTPConnection(*addr, timeout=60)
    conn.request(method, path, body=body)
    resp = conn.getresponse()
    data = resp.read()
    conn.close()
    return resp.status, data


@pytest.mark.parametrize("case", ["GeneOntologyNetwork", "MLPModel"])
def test_http_daemon_serves_snps_only_bundles(tmp_path, arrays, case):
    model, _ = _models(case)
    path = str(tmp_path / "bundle.npz")
    serve.save_bundle(path, model)
    model = serve.load_bundle(path, device="cpu")
    want = batched_forward_snps(model, arrays["snps"], batch_size=BATCH)
    server = serve.build_http_server(model, port=0, batch=BATCH, device="cpu")
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        addr = server.server_address[:2]
        status, body = _request(addr, "GET", "/health")
        health = json.loads(body)
        assert status == 200 and health["model_class"] == case
        assert health["inputs"] == "snps" and health["num_snps"] == 54
        assert health["device"] == "cpu" and health["batch"] == BATCH
        for lo, hi in ((0, 1), (1, 23), (23, N_SUBJECTS)):
            buf = io.BytesIO()
            np.savez(buf, snps=arrays["snps"][lo:hi])
            status, body = _request(addr, "POST", "/predict", buf.getvalue())
            assert status == 200
            with np.load(io.BytesIO(body)) as zf:
                _assert_same({k: zf[k] for k in zf.files},
                             {k: v[lo:hi] for k, v in want.items()})
        buf = io.BytesIO()
        np.savez(buf, x=arrays["x"][:2])
        status, body = _request(addr, "POST", "/predict", buf.getvalue())
        assert status == 400 and b"snps" in body
        buf = io.BytesIO()
        np.savez(buf, snps=arrays["snps"][:2, :50])
        assert _request(addr, "POST", "/predict", buf.getvalue())[0] == 500
        stats = json.loads(_request(addr, "GET", "/stats")[1])
        assert (stats["requests"], stats["errors"]) == (5, 2)
        assert stats["subjects_scored"] == N_SUBJECTS
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)
    assert not thread.is_alive()


def test_snps_only_cli_scores_a_snps_matrix(tmp_path, arrays, capsys):
    model, jmodel = _models("MLPModel")
    variables = to_flax_variables(model)
    bundle = str(tmp_path / "mlp.npz")
    jax_serve.save_bundle(bundle, jmodel, variables["params"], {})
    cohort = str(tmp_path / "cohort.npz")
    y = (np.random.default_rng(0).random(N_SUBJECTS) < 0.5).astype(np.int64)
    np.savez(cohort, snps=arrays["snps"], y=y)
    out = str(tmp_path / "preds.npz")
    serve.main([bundle, "--npz", cohort, "--out", out, "--device", "cpu"])
    err = capsys.readouterr().err
    assert "accuracy vs provided labels" in err and "auc" in err
    with np.load(out) as zf:
        got = {k: zf[k] for k in zf.files}
    _assert_same(got, batched_forward_snps(model, arrays["snps"]))
