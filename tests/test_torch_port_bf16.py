"""bf16 serving in the port, held against the JAX package on the CPU.

* The GCN stack's bf16 form: on the CPU the plain version on the fp32
  upcasts of bf16 P, x, W and b, returning fp32. It equals the JAX path
  the bf16 flagship takes (`gcn_conv` per layer, whose products return
  fp32) and the JAX `gcn_stack_reference` on the same upcasts, at the
  fp32 tolerance rtol 1e-5 (both sum fp32 products of the same bf16
  values, in other orders).
* `batched_forward(dtype=torch.bfloat16)` / `batched_forward_snps` of
  every bundle class against the JAX functions with `dtype=jnp.bfloat16`
  on the same weights (crossed with `tools/convert.py`): atol 2e-3 on the
  outputs the models compute in fp32 (log_probs, our_reg, the GO
  network's prob); on the MLP's prob, which both packages compute in bf16,
  one bf16 step of a value below 1 (2^-8), since the two round the last
  sigmoid on either side of a tie now and then. Both are far inside the
  JAX package's own bf16 rule (`tests/test_predict.py`: atol 0.15 against
  fp32, agreement >= 0.9); predictions equal wherever the decision is
  wider than 1e-2.
* `cast_floating` casts the weights and leaves the GO topology buffers
  and integer buffers alone; the kernel's bf16 launch plan (offsets and
  16-byte alignment of the band's bulk copy for odd and even samples) and
  the shapes `chip_smoke.py` launches to reach each branch; the HTTP
  daemon and the one-shot CLI under `--bf16`.
"""
import http.client
import io
import json
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from iggcn_tpu.ops.gcn import gcn_conv as jax_gcn_conv
from iggcn_tpu.ops.pallas_gcn import gcn_stack_reference as jax_reference
from iggcn_tpu.predict import batched_forward as jax_forward
from iggcn_tpu.predict import batched_forward_snps as jax_forward_snps
from iggcn_tpu_torch.config import ModelConfig
from iggcn_tpu_torch.data.adni import synthetic_cohort
from iggcn_tpu_torch.data.go_graph import synthetic_topology
from iggcn_tpu_torch.models.fused_sgcn import FusedSGCN
from iggcn_tpu_torch.models.go_network import GeneOntologyNetwork
from iggcn_tpu_torch.ops.gcn_stack import (SMEM_PER_BLOCK, BF16_LEAD,
                                           band_copy, fused_gcn_stack,
                                           plan_launch)
from iggcn_tpu_torch.predict import (batched_forward, batched_forward_snps,
                                     cast_floating)
from iggcn_tpu_torch.tools import serve
from iggcn_tpu_torch.tools.convert import to_flax_variables

from tests import test_torch_port_bundles as bundles

BF16 = torch.bfloat16
ATOL_FP32_OUT = 2e-3        # outputs computed in fp32
ATOL_BF16_OUT = 2.0 ** -8   # one bf16 step below 1: outputs computed in bf16


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
    c = synthetic_cohort(np.random.default_rng(1),
                         num_subjects=bundles.N_SUBJECTS)
    return {k: getattr(c, k).astype(np.float32) for k in ("x", "adj", "snps")}


def _bf16_stack(b, n, f0, widths, seed=0):
    """bf16-valued inputs as float32 numpy arrays (exact in both)."""
    rng = np.random.default_rng(seed)
    dims = [f0] + list(widths)

    def r(a):
        return torch.from_numpy(a.astype(np.float32)).to(BF16).float().numpy()
    prop = r(np.abs(rng.normal(0, 0.1, (b, n, n))))
    x = r(rng.normal(size=(b, n, f0)))
    ws = [r(rng.normal(0, 0.3, (dims[i], dims[i + 1])))
          for i in range(len(widths))]
    bs = [r(rng.normal(0, 0.1, (h,))) for h in widths]
    return prop, x, ws, bs


@pytest.mark.parametrize("n,f0,widths", [(90, 3, (16, 16)),
                                         (27, 1, (10, 10, 10))])
def test_bf16_plain_stack_matches_jax(n, f0, widths):
    prop, x, ws, bs = _bf16_stack(3, n, f0, widths)

    def t(a):
        return torch.from_numpy(a).to(BF16)
    before = fused_gcn_stack.launches_bf16
    got = fused_gcn_stack(t(prop), t(x), [t(w) for w in ws],
                          [t(b) for b in bs])
    assert got.dtype == torch.float32 and fused_gcn_stack.launches_bf16 == before
    # the JAX bf16 flagship's path: gcn_conv per layer on bf16 operands,
    # fp32 out, the next layer's h fp32 against bf16 P and W
    jb = [jnp.asarray(a, jnp.bfloat16) for a in (prop, x)]
    h, feats = jb[1], []
    for w, b in zip(ws, bs):
        h = jax.nn.relu(jax_gcn_conv(h, jb[0], jnp.asarray(w, jnp.bfloat16),
                                     jnp.asarray(b, jnp.bfloat16)))
        assert h.dtype == jnp.float32
        feats.append(h)
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(jnp.concatenate(feats, -1)),
                               rtol=1e-5, atol=1e-6)
    want = np.asarray(jax_reference(jnp.asarray(prop), jnp.asarray(x),
                                    tuple(map(jnp.asarray, ws)),
                                    tuple(map(jnp.asarray, bs))))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


def test_bf16_form_refuses_grad_groups_and_mixed_types():
    prop, x, ws, bs = (torch.from_numpy(a).to(BF16) if isinstance(a, np.ndarray)
                       else [torch.from_numpy(v).to(BF16) for v in a]
                       for a in _bf16_stack(2, 8, 2, (4,)))
    w_grad = [w.clone().requires_grad_() for w in ws]
    with pytest.raises(ValueError, match="no backward"):
        fused_gcn_stack(prop, x, w_grad, bs)
    with torch.no_grad():
        assert fused_gcn_stack(prop, x, w_grad, bs).shape == (2, 8, 4)
    with pytest.raises(ValueError, match="bf16 x"):
        fused_gcn_stack(prop, x.float(), ws, bs)
    with pytest.raises(ValueError, match="grouped"):
        fused_gcn_stack(prop, x, [w[None].expand(2, -1, -1) for w in ws],
                        [b[None].expand(2, -1) for b in bs])


@pytest.mark.parametrize("n,f0,widths", [(90, 3, (16, 16)),
                                         (270, 1, (10, 10, 10))])
def test_bf16_plan_band_copy_is_aligned_for_odd_and_even_samples(
        n, f0, widths):
    dims = (f0,) + widths
    plan = plan_launch(256, n, dims, elem_bytes=2)
    fp32 = plan_launch(256, n, dims)
    # bf16 P needs half the room: N=270 fits one CTA where fp32 needs two
    assert plan.cluster == 1 and fp32.cluster == (1 if n == 90 else 2)
    assert plan.smem_bytes <= SMEM_PER_BLOCK - 1024
    assert plan.ps == n and plan.elem_bytes == 2
    # the band (lead, kpad columns of stride ps, 8 of slack, in bf16)
    # ends before the next region, which stays 16-byte aligned
    assert 2 * plan.off_part >= BF16_LEAD + plan.kpad * plan.ps + 8
    assert plan.off_part % 4 == 0
    base = 1 << 20                         # a 512-byte-aligned allocation
    for sample in range(8):
        for rank in range(plan.cluster):
            r0 = rank * plan.rows
            own = min(n, r0 + plan.rows) - r0
            addr = base + 2 * (sample * n * n + r0 * n)
            lead, head, body, tail = band_copy(addr, own, n, 2)
            assert head + body + tail == 2 * own * n
            assert 0 <= head < 16 and 0 <= tail < 16 and body % 16 == 0
            assert (addr + head) % 16 == 0               # bulk source
            assert (2 * lead + head) % 16 == 0           # bulk destination
            assert lead % 2 == 0 and lead < BF16_LEAD    # pairs stay aligned
            # at N=90 and 270 a sample is 8 bytes off 16 for odd samples
            assert (head == 0) == (sample % 2 == 0)
    # fp32 bands are 16-byte aligned whole: one bulk copy
    assert band_copy(base + 4 * 90 * 90, 90, 90, 4) == (0, 0, 4 * 8100, 0)


def test_chip_smoke_bf16_branch_shapes_reach_every_plan():
    """chip_smoke.py launches the bf16 form at these shapes beyond the
    grids so that every (cluster, K split) the bf16 plan can choose runs
    on the card."""
    seen = {}
    for n, f0, widths in chip_smoke.BF16_BRANCH_SHAPES:
        plan = plan_launch(7, n, (f0,) + widths, elem_bytes=2)
        assert plan.smem_bytes <= SMEM_PER_BLOCK and plan.threads <= 512
        seen[(plan.cluster, plan.ksplit)] = (n, f0, widths)
    for n, f0, widths in chip_smoke.STACK_SHAPES:
        plan = plan_launch(7, n, (f0,) + widths, elem_bytes=2)
        seen.setdefault((plan.cluster, plan.ksplit), (n, f0, widths))
    assert set(seen) == {(1, 1), (1, 2), (1, 4), (2, 1), (2, 4), (4, 1),
                         (4, 2), (8, 1), (8, 2)}


def test_cast_floating_leaves_topology_buffers_and_ints_alone():
    topo = synthetic_topology(np.random.default_rng(0))
    model = FusedSGCN(ModelConfig(**bundles.SMALL), topo,
                      generator=torch.Generator().manual_seed(0))
    weights = to_flax_variables(model)
    kept = {name: buf.clone() for name, buf in model.named_buffers()
            if "running_" not in name}
    assert cast_floating(model, BF16) is model
    for name, p in model.named_parameters():
        assert p.dtype == BF16, name
    for name, buf in model.named_buffers():
        if "running_" in name:
            assert buf.dtype == BF16, name
        else:       # gene_mask, enc_mask_*, enc_rows_*, dec_attn_*
            assert buf.dtype == kept[name].dtype, name
            assert torch.equal(buf, kept[name]), name
    assert model.go_network.gene_mask.dtype == torch.float32
    assert model.go_network.enc_rows_0.dtype == torch.int64
    # the cast is the flax trees' cast: every leaf rounded to bf16
    jax.tree_util.tree_map(
        lambda got, w: np.testing.assert_array_equal(
            got, np.asarray(jnp.asarray(w, jnp.bfloat16), np.float32)),
        to_flax_variables(model), weights)


@pytest.mark.parametrize("case", list(bundles.CASES))
def test_bf16_serving_matches_jax_bf16(arrays, case):
    model, jmodel = bundles._models(case)
    v = to_flax_variables(model)
    if hasattr(model, "cfg"):
        want = jax_forward(jmodel, v["params"], v["batch_stats"], arrays["x"],
                           arrays["adj"], arrays["snps"],
                           batch_size=bundles.BATCH, dtype=jnp.bfloat16)
        got = batched_forward(model, arrays["x"], arrays["adj"],
                              arrays["snps"], batch_size=bundles.BATCH,
                              dtype=BF16)
        fp32 = batched_forward(model, arrays["x"], arrays["adj"],
                               arrays["snps"], batch_size=bundles.BATCH)
    else:
        want = jax_forward_snps(jmodel, v["params"], v["batch_stats"],
                                arrays["snps"], batch_size=bundles.BATCH,
                                dtype=jnp.bfloat16)
        got = batched_forward_snps(model, arrays["snps"],
                                   batch_size=bundles.BATCH, dtype=BF16)
        fp32 = batched_forward_snps(model, arrays["snps"],
                                    batch_size=bundles.BATCH)
    # the caller's model is left in fp32 (the cast is on a copy)
    assert all(p.dtype == torch.float32 for p in model.parameters())
    assert set(got) == set(want)
    for key in set(got) - {"pred"}:
        assert got[key].dtype == np.float32
        atol = ATOL_BF16_OUT if case == "MLPModel" else ATOL_FP32_OUT
        np.testing.assert_allclose(got[key], want[key], rtol=0, atol=atol,
                                   err_msg=key)
        # and the JAX package's own bf16-vs-fp32 rule
        np.testing.assert_allclose(got[key], fp32[key], atol=0.15)
    if "prob" in want:
        decided = np.abs(want["prob"] - 0.5) > 1e-2
    else:
        lp = np.sort(want["log_probs"], axis=1)
        decided = lp[:, -1] - lp[:, -2] > 1e-2
    np.testing.assert_array_equal(got["pred"][decided], want["pred"][decided])
    assert np.mean(got["pred"] == fp32["pred"]) >= 0.9


def _request(addr, method, path, body=None):
    conn = http.client.HTTPConnection(*addr, timeout=60)
    conn.request(method, path, body=body)
    resp = conn.getresponse()
    data = resp.read()
    conn.close()
    return resp.status, data


@pytest.mark.parametrize("case", ["FusedSGCN", "GeneOntologyNetwork"])
def test_bf16_http_daemon_reports_its_dtype_and_predicts(tmp_path, arrays,
                                                         case):
    model, _ = bundles._models(case)
    path = str(tmp_path / "bundle.npz")
    serve.save_bundle(path, model)
    want = (batched_forward(model, arrays["x"], arrays["adj"], arrays["snps"],
                            batch_size=bundles.BATCH, dtype=BF16)
            if hasattr(model, "cfg") else
            batched_forward_snps(model, arrays["snps"],
                                 batch_size=bundles.BATCH, dtype=BF16))
    loaded = serve.load_bundle(path, device="cpu")
    server = serve.build_http_server(loaded, port=0, batch=bundles.BATCH,
                                     device="cpu", dtype=BF16)
    assert next(loaded.parameters()).dtype == BF16      # cast once, at build
    if isinstance(loaded, GeneOntologyNetwork):
        assert loaded.gene_mask.dtype == torch.float32
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        addr = server.server_address[:2]
        status, body = _request(addr, "GET", "/health")
        health = json.loads(body)
        assert status == 200 and health["dtype"] == "bfloat16"
        assert health["model_class"] == case
        keys = ("x", "adj", "snps") if hasattr(model, "cfg") else ("snps",)
        buf = io.BytesIO()
        np.savez(buf, **{k: arrays[k][3:20] for k in keys})
        status, body = _request(addr, "POST", "/predict", buf.getvalue())
        assert status == 200
        with np.load(io.BytesIO(body)) as zf:
            got = {k: zf[k] for k in zf.files}
        assert set(got) == set(want)
        for k in got:
            # one request of 17 subjects padded to the fixed batch 16 x 2
            # against the cohort served in batches of 16: the same rows
            np.testing.assert_allclose(got[k], want[k][3:20], atol=1e-6)
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)
    assert not thread.is_alive()


def test_bf16_cli_scores_a_cohort(tmp_path, arrays, capsys):
    model, _ = bundles._models("ClusterLabelSGCN")
    bundle = str(tmp_path / "b.npz")
    serve.save_bundle(bundle, model)
    cohort = str(tmp_path / "cohort.npz")
    np.savez(cohort, **arrays)
    out = str(tmp_path / "preds.npz")
    serve.main([bundle, "--npz", cohort, "--out", out, "--device", "cpu",
                "--bf16", "--batch", str(bundles.BATCH)])
    want = batched_forward(model, arrays["x"], arrays["adj"], arrays["snps"],
                           batch_size=bundles.BATCH, dtype=BF16)
    with np.load(out) as zf:
        assert set(zf.files) == set(want)
        for k in zf.files:
            np.testing.assert_array_equal(zf[k], want[k])
    assert "served" in capsys.readouterr().err
