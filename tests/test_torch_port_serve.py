"""The port's serving slice as a whole, on the CPU: bundles cross between the
packages in both directions, the port's CLI (`--device cpu`) and the JAX
CLI give the same predictions at a batch below 64 (GO attention 'dense')
and at 64 ('edge'), and the port's HTTP daemon answers with the same
arrays. log_probs at 1e-5, our_reg at rtol 1e-4; pred equal wherever the
two classes' log-probs differ by more than 1e-4."""
import http.client
import io
import json
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from iggcn_tpu.config import ModelConfig as JaxConfig
from iggcn_tpu.data.adni import synthetic_cohort
from iggcn_tpu.data.go_graph import synthetic_topology as jax_topology
from iggcn_tpu.models.fused_sgcn import FusedSGCN as JaxFused
from iggcn_tpu.predict import batched_forward as jax_batched_forward
from iggcn_tpu.tools import serve as jax_serve
from iggcn_tpu_torch.predict import batched_forward, pad_split_batches
from iggcn_tpu_torch.tools import serve

N_SUBJECTS = 70


@pytest.fixture(scope="module")
def jax_bundle(tmp_path_factory):
    """A bundle written by the JAX package, with random running stats."""
    root = tmp_path_factory.mktemp("serve")
    cohort = synthetic_cohort(np.random.default_rng(1),
                              num_subjects=N_SUBJECTS)
    arrays = {k: getattr(cohort, k).astype(np.float32)
              for k in ("x", "adj", "snps")}
    cohort_path = str(root / "cohort.npz")
    np.savez(cohort_path, **arrays, y=cohort.y)
    model = JaxFused(cfg=JaxConfig(num_layers=2, hidden=8, hidden_linear=16,
                                   l_dim=8),
                     topo=jax_topology(np.random.default_rng(0)))
    variables = jax.jit(model.init)(
        jax.random.PRNGKey(3), *(jnp.asarray(arrays[k][:4])
                                 for k in ("x", "adj", "snps")))
    rng = np.random.default_rng(9)
    stats = jax.tree_util.tree_map_with_path(
        lambda p, a: (rng.uniform(0.5, 2.0, a.shape) if p[-1].key == "var"
                      else rng.normal(0, 0.3, a.shape)).astype(np.float32),
        jax.device_get(variables["batch_stats"]))
    bundle = str(root / "bundle.npz")
    jax_serve.save_bundle(bundle, model, variables["params"], stats)
    return root, bundle, cohort_path, arrays


def _assert_same_predictions(got, want):
    np.testing.assert_allclose(got["log_probs"], want["log_probs"],
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got["our_reg"], want["our_reg"],
                               rtol=1e-4, atol=1e-5)
    lp = np.asarray(want["log_probs"])
    decided = np.abs(lp[:, 0] - lp[:, 1]) > 1e-4
    np.testing.assert_array_equal(np.asarray(got["pred"])[decided],
                                  np.asarray(want["pred"])[decided])


@pytest.mark.parametrize("batch", [8, 64])
def test_port_cli_matches_jax_cli(jax_bundle, batch, capsys):
    root, bundle, cohort_path, _ = jax_bundle
    outs, reports = {}, {}
    for name, main, extra in (("jax", jax_serve.main, []),
                              ("port", serve.main, ["--device", "cpu"])):
        out = str(root / f"preds_{name}_{batch}.npz")
        capsys.readouterr()
        main([bundle, "--npz", cohort_path, "--out", out,
              "--batch", str(batch), *extra])
        reports[name] = [line for line in capsys.readouterr().err.splitlines()
                         if line.startswith("accuracy vs provided labels")]
        with np.load(out) as zf:
            outs[name] = {k: zf[k] for k in zf.files}
    assert set(outs["port"]) == set(outs["jax"])
    # the labelled cohort's accuracy/AUC report is the same line
    assert len(reports["port"]) == 1 and reports["port"] == reports["jax"]
    assert outs["port"]["log_probs"].shape == (N_SUBJECTS, 2)
    _assert_same_predictions(outs["port"], outs["jax"])


def test_port_bundle_loads_in_jax(jax_bundle):
    root, bundle, _, arrays = jax_bundle
    model = serve.load_bundle(bundle, device="cpu")
    port_bundle = str(root / "port_bundle.npz")
    serve.save_bundle(port_bundle, model)
    jmodel, params, stats = jax_serve.load_bundle(port_bundle)
    assert type(jmodel).__name__ == "FusedSGCN"
    x, adj, snps = (arrays[k] for k in ("x", "adj", "snps"))
    want = jax_batched_forward(jmodel, params, stats, x, adj, snps,
                               batch_size=32)
    got = batched_forward(model, x, adj, snps, batch_size=32)
    _assert_same_predictions(got, want)
    # the port's bundle carries exactly the JAX bundle's arrays
    with np.load(bundle) as a, np.load(port_bundle) as b:
        assert set(a.files) == set(b.files)
        for k in a.files:
            if k != "__meta__":
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_pad_split_repeats_first_row():
    x = np.arange(10, dtype=np.float32).reshape(5, 2)
    (xb,) = pad_split_batches((x,), 4)
    assert tuple(xb.shape) == (2, 4, 2)
    np.testing.assert_array_equal(xb[1, 1:].numpy(), np.repeat(x[:1], 3, 0))


def test_mismatched_cohort_and_other_families_are_refused(jax_bundle, tmp_path):
    _, bundle, _, arrays = jax_bundle
    model = serve.load_bundle(bundle, device="cpu")
    with pytest.raises(ValueError, match="model expects"):
        batched_forward(model, arrays["x"][:, :, :1], arrays["adj"],
                        arrays["snps"])
    empty = batched_forward(model, *(arrays[k][:0] for k in ("x", "adj", "snps")))
    assert empty["log_probs"].shape == (0, 2) and empty["pred"].shape == (0,)
    assert empty["our_reg"].shape == (0, 3)
    other = str(tmp_path / "other.npz")
    np.savez(other, __meta__=np.asarray(json.dumps(
        {"model_class": "GIN", "ctor": {}})))
    with pytest.raises(ValueError, match="unknown bundled model class GIN"):
        serve.load_bundle(other, device="cpu")


def _request(addr, method, path, body=None):
    conn = http.client.HTTPConnection(*addr, timeout=60)
    conn.request(method, path, body=body)
    resp = conn.getresponse()
    data = resp.read()
    conn.close()
    return resp.status, data


def test_http_daemon_serves_same_arrays(jax_bundle):
    _, bundle, _, arrays = jax_bundle
    model = serve.load_bundle(bundle, device="cpu")
    want = batched_forward(model, arrays["x"], arrays["adj"], arrays["snps"],
                           batch_size=16)
    server = serve.build_http_server(model, port=0, batch=16, device="cpu")
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        addr = server.server_address[:2]
        status, body = _request(addr, "GET", "/health")
        health = json.loads(body)
        assert status == 200 and health["model_class"] == "FusedSGCN"
        assert health["device"] == "cpu" and health["batch"] == 16
        for lo, hi in ((0, 1), (1, 38), (38, N_SUBJECTS)):
            buf = io.BytesIO()
            np.savez(buf, **{k: v[lo:hi] for k, v in arrays.items()})
            status, body = _request(addr, "POST", "/predict", buf.getvalue())
            assert status == 200
            with np.load(io.BytesIO(body)) as zf:
                _assert_same_predictions(
                    {k: zf[k] for k in zf.files},
                    {k: v[lo:hi] for k, v in want.items()})
        assert _request(addr, "POST", "/predict", b"not an npz")[0] == 400
        assert _request(addr, "GET", "/nope")[0] == 404
        stats = json.loads(_request(addr, "GET", "/stats")[1])
        assert stats["requests"] == 4 and stats["errors"] == 1
        assert stats["subjects_scored"] == N_SUBJECTS
        assert stats["latency_ms"]["window"] == 4
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)
    assert not thread.is_alive()
