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
  and integer buffers alone; the kernel's bf16 launch plan (its forms,
  warps per SM and grid; offsets and 16-byte alignment of each sample's
  bulk copy in the stage, for odd and even samples), a mirror of the
  persistent kernel's schedule (every sample once, the stage's barrier
  parity on every reuse), the C struct's field order, and the shapes
  `chip_smoke.py` launches to reach each branch and refill the stage; the
  HTTP daemon and the one-shot CLI under `--bf16`.
"""
import http.client
import io
import json
import pathlib
import re
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
from iggcn_tpu_torch.ops.gcn_stack import (BF16_KSPLITS, BF16_LEAD,
                                           BF16_MAX_THREADS, MAX_LAYERS,
                                           MAX_THREADS, SMEM_PER_BLOCK,
                                           PersistentPlan, StreamedPlan,
                                           _c_bf16_plan,
                                           _CBf16Plan, band_copy,
                                           fused_gcn_stack, plan_launch,
                                           stage_schedule)
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
    """Each sample the persistent kernel takes lands in its stage: the
    head and tail plain-loaded, the body's bulk copy 16-byte aligned in
    device and shared memory, all inside the stage, for odd and even
    samples, with P 16-byte aligned or 2 bytes off."""
    dims = (f0,) + widths
    plan = plan_launch(256, n, dims, elem_bytes=2)
    fp32 = plan_launch(256, n, dims)
    # bf16 P needs half the room: N=270 fits one CTA where fp32 needs two
    assert isinstance(plan, PersistentPlan) and plan.cluster == 1
    assert fp32.cluster == (1 if n == 90 else 2)
    assert plan.smem_bytes <= SMEM_PER_BLOCK - 1024 and plan.ps == n
    assert plan.stage_vals == 2 * plan.off_hw  # hW right after the stage
    assert plan.stage_vals % 8 == 0            # and 16-byte aligned
    lo, hi = 0, 2 * plan.stage_vals            # the stage's bytes
    for base in (1 << 20, (1 << 20) + 2):    # an allocation, and 2 bytes off
        for sample in range(8):
            addr = base + 2 * sample * n * n
            lead, head, body, tail = band_copy(addr, n, n, 2)
            assert head + body + tail == 2 * n * n
            assert 0 <= head < 16 and 0 <= tail < 16 and body % 16 == 0
            # the kernel's edge threads, with the 8 zeros after the sample
            assert (head + tail) // 2 + 8 <= 32
            assert (addr + head) % 16 == 0                 # bulk source
            assert (lo + 2 * lead + head) % 16 == 0        # bulk destination
            assert lo <= lo + 2 * lead and lo + 2 * lead + 2 * n * n <= hi
            assert lead < BF16_LEAD
            # read in place: as far as the tile loop reads
            assert 2 * (lead + plan.kpad * plan.ps + 8) <= hi - lo
            if base % 16 == 0:   # a sample is 8 bytes off 16 when odd
                assert (head == 0) == (sample % 2 == 0)
                assert lead % 2 == 0           # pairs stay 4-byte aligned
    # fp32 bands are 16-byte aligned whole: one bulk copy
    assert band_copy((1 << 20) + 4 * 90 * 90, 90, 90, 4) == (0, 0, 4 * 8100, 0)


def test_bf16_persistent_plan_at_the_serving_shapes():
    """N=90: K split 4, CTAs of 6 warps, two to an SM at 128 registers a
    thread, whatever the batch (the whole cohort in one launch gets the
    serving plan); N=90 at widths 64: K split 2 (4 would take 768
    threads), one CTA of 12 warps; N=270: K split 4, one CTA of 13 warps;
    the grid is the resident CTAs or B; layouts in order and 16-byte
    aligned."""
    serving = plan_launch(256, 90, (3, 16, 16), elem_bytes=2)
    wide = plan_launch(256, 90, (3, 64, 64), elem_bytes=2)
    multi = plan_launch(256, 270, (1, 10, 10, 10), elem_bytes=2)
    assert (serving.ksplit, serving.threads,
            serving.ctas_per_sm) == (4, 192, 2)
    assert plan_launch(874, 90, (3, 16, 16), elem_bytes=2) == serving
    assert (wide.ksplit, wide.threads, wide.ctas_per_sm) == (2, 384, 1)
    assert (multi.ksplit, multi.threads, multi.ctas_per_sm) == (4, 416, 1)
    # warps an SM holds
    assert [p.warps_per_sm for p in (serving, wide, multi)] == [12, 12, 13]
    for plan, n, dims in ((serving, 90, (3, 16, 16)),
                          (wide, 90, (3, 64, 64)),
                          (multi, 270, (1, 10, 10, 10))):
        assert plan.ctas_per_sm * plan.threads <= BF16_MAX_THREADS
        assert plan.threads % 32 == 0
        assert plan.ctas_per_sm * (plan.smem_bytes + 2048) <= 233472
        assert plan.kpad >= n and plan.kpad % (2 * plan.ksplit) == 0
        assert plan.hws % 8 == 4
        assert plan.stage_vals >= BF16_LEAD + plan.kpad * plan.ps + 8
        ends = [plan.off_hw + plan.kpad * plan.hws,
                plan.off_h + plan.hs * plan.hts]
        starts = [plan.off_h, plan.off_w[0]]
        for i, (fin, fp) in enumerate(zip(dims[:-1], plan.fout_p)):
            ends += [plan.off_w[i] + -(-fin // 4) * 4 * fp, plan.off_b[i] + fp]
            starts += [plan.off_b[i], (plan.off_w + (plan.off_o,))[i + 1]]
        assert ends == starts
        assert plan.smem_bytes >= 4 * (plan.off_o + n * sum(dims[1:]))
        assert all(o % 4 == 0 for o in (plan.off_hw, plan.off_h, plan.off_o,
                                        *plan.off_w))
    for b, sms, n, dims, grid in ((256, 132, 90, (3, 16, 16), 256),
                                  (874, 132, 90, (3, 16, 16), 264),
                                  (874, 132, 90, (3, 64, 64), 132),
                                  (7, 132, 90, (3, 16, 16), 7),
                                  (256, 114, 90, (3, 16, 16), 228),
                                  (256, 132, 270, (1, 10, 10, 10), 132),
                                  (133, 132, 270, (1, 10, 10, 10), 132)):
        assert plan_launch(b, n, dims, 2, sms).grid(b) == grid


def test_bf16_plan_refuses_what_no_kernel_holds():
    """What no resident kernel holds in bf16 goes to the streamed form (its
    plan, with bf16 operands); only an invalid argument raises."""
    for b, n, dims in ((256, 1100, (1, 4, 4)), (7, 90, (3, 2048))):
        plan = plan_launch(b, n, dims, elem_bytes=2)
        assert isinstance(plan, StreamedPlan) and plan.elem_bytes == 2
    with pytest.raises(ValueError, match="elem_bytes"):
        plan_launch(7, 90, (3, 16), elem_bytes=1)


@pytest.mark.parametrize("b", [1, 7, 106, 133, 256])
def test_bf16_stage_schedule_takes_every_sample_once(b):
    """The persistent kernel's schedule for each grid it can get (an H100's
    132 SMs at 1 and 2 CTAs per SM, a card of 114, one CTA): every sample
    filled and waited for once, by CTA s % grid, in order; the stage's
    fills in use order, each waited for on parity use & 1, and refilled
    only after the CTA waited for (and so released) its previous sample."""
    for grid in {min(b, g) for g in (132, 264, 114, 1)}:
        waited = []
        for cta, events in enumerate(stage_schedule(b, grid)):
            filled, uses = None, 0
            for kind, sample, value in events:
                assert sample % grid == cta
                if kind == "fill":
                    assert filled is None and value == uses  # stage released
                    filled, uses = (sample, value), uses + 1
                else:
                    got, use = filled                    # filled, not waited
                    assert got == sample and value == use & 1
                    filled = None
                    waited.append(sample)
            assert filled is None                        # nothing in flight
        assert sorted(waited) == list(range(b))
        assert waited == sorted(waited, key=lambda s: (s % grid, s))


def test_c_bf16_plan_mirrors_the_kernel_struct():
    """`_CBf16Plan` is passed by pointer as csrc/gcn_stack_bf16.cu's
    Bf16Plan: the same int fields, in the same order, with the same array
    lengths."""
    src = (pathlib.Path(__file__).parents[1] / "iggcn_tpu_torch" / "csrc"
           / "gcn_stack_bf16.cu").read_text()
    body = re.search(r"struct Bf16Plan \{(.*?)\};", src, re.S).group(1)
    fields = []
    for decl in re.findall(r"^\s*int ([^;]+);", body, re.M):
        for name in decl.split(","):
            m = re.fullmatch(r"\s*(\w+)(?:\[(.+)\])?\s*", name)
            fields.append((m.group(1), {None: None, "kMaxLayers": MAX_LAYERS,
                                        "kMaxLayers + 1": MAX_LAYERS + 1}
                           [m.group(2)]))
    ours = [(name, getattr(ctype, "_length_", None))
            for name, ctype in _CBf16Plan._fields_]
    assert fields == ours
    plan = plan_launch(256, 90, (3, 16, 16), elem_bytes=2)
    c = _c_bf16_plan(plan, 90, (3, 16, 16), True, True, plan.grid(256))
    assert (c.grid, c.copy_bulk, c.ksplit, c.total,
            list(c.out_off)[:2]) == (256, 1, 4, 32, [0, 16])


def test_chip_smoke_bf16_branch_shapes_reach_every_plan():
    """chip_smoke.py launches the bf16 form at these shapes beyond the
    grids so that every branch its plan can choose runs on the card: the
    persistent kernel with each K split, and the cluster design with each
    (cluster, K split) it takes beyond one CTA."""
    seen = {}
    for n, f0, widths in chip_smoke.BF16_BRANCH_SHAPES:
        plan = plan_launch(7, n, (f0,) + widths, elem_bytes=2)
        assert plan.smem_bytes <= SMEM_PER_BLOCK
        assert plan.threads <= (BF16_MAX_THREADS
                                if isinstance(plan, PersistentPlan)
                                else MAX_THREADS)
        seen[chip_smoke.bf16_branch(plan)] = (n, f0, widths)
    for n, f0, widths in chip_smoke.STACK_SHAPES:
        plan = plan_launch(7, n, (f0,) + widths, elem_bytes=2)
        seen.setdefault(chip_smoke.bf16_branch(plan), (n, f0, widths))
    assert set(seen) == {
        *(("persistent", 1, ks) for ks in BF16_KSPLITS),
        *(("cluster", c, ks) for c, ks in ((2, 1), (2, 2), (2, 4), (4, 1),
                                           (4, 2), (8, 1), (8, 2)))}


def test_chip_smoke_bf16_refills_the_stage_at_every_k_split():
    """chip_smoke.py launches the persistent kernel with each K split at a
    batch whose CTAs (on an H100's 132 SMs) take three samples or more, so
    that the stage is refilled and its barrier waited on at parity 0 and
    1: the grids' shapes at `BF16_BATCHES` and `BF16_REFILL_CASES`."""
    cases = [(b, n, f0, widths) for n, f0, widths in chip_smoke.STACK_SHAPES
             for b in chip_smoke.BF16_BATCHES] + chip_smoke.BF16_REFILL_CASES
    refilled = set()
    for b, n, f0, widths in cases:
        plan = plan_launch(b, n, (f0,) + widths, elem_bytes=2)
        if not isinstance(plan, PersistentPlan):
            continue
        parities = {value for events in stage_schedule(b, plan.grid(b))
                    for kind, _, value in events if kind == "wait"}
        if b // plan.grid(b) >= 3 and parities == {0, 1}:
            refilled.add(plan.ksplit)
    assert refilled == set(BF16_KSPLITS)


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
        else:       # gene_mask, enc_mask_*, agg_*, pick_*, dec_attn_*
            assert buf.dtype == kept[name].dtype, name
            assert torch.equal(buf, kept[name]), name
    assert model.go_network.gene_mask.dtype == torch.float32
    assert model.go_network.enc_mask_0.dtype == torch.bool
    # the edge attention's one-hots stay fp32: its sums accumulate in fp32
    assert model.go_network.agg_0.dtype == torch.float32
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
