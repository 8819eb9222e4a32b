"""The backward kernel's shared-memory layout and product tiling, checked
without the card.

`csrc/gcn_stack_backward.cu` runs every product through one routine
(`product<>`): register tiles, each operand read in 8- or 16-byte vectors
along the dimension it is contiguous in, K in chunks of 4, so K is read up
to the next multiple of 4 and M and N up to the tile's edge.
`ops/gcn_stack.py:backward_products` describes those reads over the plan's
offsets. Here (a) over every shape the plan covers in the sweeps of
tests/test_torch_port_gcn_stack_backward.py, each read vector is aligned
to its size and stays inside shared memory, and K's pad meets a region
that holds exact zeros on one side and finite values on the other; (b) a
NumPy emulation of the kernel, step by step over the plan's offsets (the
prologue's writes, the products, the epilogues, the cluster's partial
sums and gathers), on shared memory filled with NaN, gives
`gcn_stack_backward_reference`'s gradients within rtol / atol 1e-4 and no
NaN: a read that met a stale pad would spread NaN into a stored output."""
import itertools
import pathlib
import re

import numpy as np
import pytest
import torch

from iggcn_tpu_torch.ops.gcn_stack import (P_DEEP_K, backward_products,
                                           gcn_stack_backward_reference,
                                           plan_backward, plan_launch)

from tests.test_torch_port_gcn_stack_backward import BRANCHES, GRID

TOL = dict(rtol=1e-4, atol=1e-4)


def _ceil(v, m):
    return -(-v // m) * m


def _read_span(spec):
    """(lowest, highest) shared-memory index of A's reads and of B's."""
    mp, np_, kp = _ceil(spec.mn, spec.tm), _ceil(spec.nn, spec.tn), _ceil(
        spec.kn, 4)
    a_hi = spec.a + ((spec.mn - 1) * spec.a_stride + kp - 1 if spec.a_k
                     else (kp - 1) * spec.a_stride + mp - 1)
    b_hi = spec.b + ((spec.nn - 1) * spec.b_stride + kp - 1 if spec.b_k
                     else (kp - 1) * spec.b_stride + np_ - 1)
    return (spec.a, a_hi), (spec.b, b_hi)


def _layout_reads_hold(plan, n, dims):
    """Every CTA's products read aligned vectors inside shared memory, and
    K's pad is zero on one side, finite on the other, by where it lands."""
    size = plan.smem_bytes // 4
    for rank in range(plan.cluster):
        own = min(n, (rank + 1) * plan.rows) - rank * plan.rows
        for spec in backward_products(plan, n, dims, rank):
            (a_lo, a_hi), (b_lo, b_hi) = _read_span(spec)
            assert 0 <= a_lo and a_hi < size and 0 <= b_lo and b_hi < size, spec
            # vectors start at multiples of their length: base and stride
            # (tiles start at multiples of tm, tn and chunks of 4)
            for base, stride, vec, tile in ((spec.a, spec.a_stride, spec.a_vec,
                                             spec.tm),
                                            (spec.b, spec.b_stride, spec.b_vec,
                                             spec.tn)):
                assert vec in (2, 4) and base % vec == 0, spec
                assert stride % vec == 0 and tile % vec == 0, spec
            kp = _ceil(spec.kn, 4)
            if kp == spec.kn:
                continue
            # K's pad: which operand reads exact zeros there
            if spec.name == "z":
                # P's columns own .. kp - 1 lie in the band's zeroed tail,
                # a^T's pad columns are zeros
                assert (kp - 1) * plan.ps + _ceil(n, spec.tm) - 1 < plan.off_dz
                assert kp <= plan.ats
            elif spec.name == "da":
                # dz^T's columns n .. kp - 1 are zeros; P's values there are
                # the next column's, a column's zeroed pad or the tail
                assert kp <= plan.dts
                assert (own - 1) * plan.ps + kp - 1 < plan.off_dz
            elif spec.name == "dW":     # h^T's and da's zeroed pads
                assert kp <= min(plan.ats, plan.rows)
            elif spec.name in ("e", "a"):   # W's zero-padded rows / columns
                assert kp == plan.fout_p[spec.layer] if spec.name == "e" else \
                    kp == _ceil(dims[spec.layer], 4)
            else:
                raise AssertionError(f"unexpected K pad in {spec}")
        # the P-products read P in 16-byte vectors where the stride allows
        assert all(s.a_vec == (4 if plan.ps % 4 == 0 else 2)
                   for s in backward_products(plan, n, dims, rank)
                   if s.name in ("z", "da"))


@pytest.mark.parametrize("n,f0,widths", GRID + BRANCHES)
def test_backward_reads_hold_at_every_model_shape(n, f0, widths):
    dims = (f0, *widths)
    for b in (1, 32):
        _layout_reads_hold(plan_backward(b, n, dims), n, dims)


def test_backward_reads_hold_wherever_the_plan_exists():
    """The sweep of N up to 320 at the grids' widths, as the plan's own
    test sweeps it."""
    checked = 0
    for n in range(1, 321, 7):
        for f0, layers, hidden in itertools.product((1, 3), (1, 2, 3, 4),
                                                    (1, 2, 5, 10, 16)):
            dims = (f0,) + (hidden,) * layers
            try:
                plan_launch(7, n, dims)
            except ValueError:
                continue
            _layout_reads_hold(plan_backward(7, n, dims), n, dims)
            checked += 1
    assert checked > 1500


def test_p_products_read_p_and_their_other_operand_in_vectors():
    """z = P a and da = P^T dz read P's band in 8-byte vectors at the
    model's N (ps = 90, 270: only even) and 16-byte ones where ps is a
    multiple of 4, the other operand in 16-byte vectors along K; 4 x 4
    tiles at N=90, 8 x 4 where K reaches P_DEEP_K (N=270): each load
    feeds 5.3 or 6.4 FMAs (scalar loads along K fed 2-5.3)."""
    for n, dims, vec, rows in ((90, (3, 16, 16), 2, (4, 4)),
                               (270, (1, 10, 10, 10), 2, (8, 8)),
                               (92, (3, 16), 4, (4, 4))):
        plan = plan_backward(32, n, dims)
        specs = {s.name: s for s in backward_products(plan, n, dims)}
        for name, tm in zip(("z", "da"), rows):
            spec = specs[name]
            assert (spec.a_vec, spec.b_vec, spec.b_k) == (vec, 4, True), spec
            assert (spec.tm, spec.tn) == (tm, 4), spec
            loads = spec.tm * 4 // spec.a_vec + spec.tn * 4 // spec.b_vec
            assert spec.tm * spec.tn * 4 / loads >= (16 / 3 if vec == 2 else 8)


def test_p_deep_k_mirrors_the_kernel():
    """`backward_products` takes the P-products' 8-row tiles from the K on
    at which the kernel does (kDeepK)."""
    src = (pathlib.Path(__file__).parents[1] / "iggcn_tpu_torch" / "csrc"
           / "gcn_stack_backward.cu").read_text()
    assert int(re.search(r"constexpr int kDeepK = (\d+);", src).group(1)) \
        == P_DEEP_K


# ---------------------------------------------------------------- emulation

def _product(sm, spec):
    """C = A B over the padded tiles, read as the kernel reads them; the
    K pad checked zero on one side and finite on the other; returns
    C[:mn, :nn] (what the epilogue may store)."""
    mp, np_, kp = _ceil(spec.mn, spec.tm), _ceil(spec.nn, spec.tn), _ceil(
        spec.kn, 4)
    m, nn, k = np.arange(mp), np.arange(np_), np.arange(kp)
    # rows past mn (a_k) and columns past nn (b_k) read the last one again
    ia = spec.a + (np.minimum(m, spec.mn - 1)[:, None] * spec.a_stride
                   + k[None, :] if spec.a_k
                   else k[None, :] * spec.a_stride + m[:, None])
    ib = spec.b + (np.minimum(nn, spec.nn - 1)[None, :] * spec.b_stride
                   + k[:, None] if spec.b_k
                   else k[:, None] * spec.b_stride + nn[None, :])
    assert ia.min() >= 0 and ia.max() < sm.size, spec
    assert ib.min() >= 0 and ib.max() < sm.size, spec
    starts_a = ia[:, ::spec.a_vec] if spec.a_k else ia[::spec.a_vec, :]
    starts_b = ib[::spec.b_vec, :] if spec.b_k else ib[:, ::spec.b_vec]
    assert (starts_a % spec.a_vec == 0).all() and (
        starts_b % spec.b_vec == 0).all(), spec
    a, b = sm[ia], sm[ib]
    if kp > spec.kn:
        ap, bp = a[:spec.mn, spec.kn:, None], b[None, spec.kn:, :spec.nn]
        ok = ((ap == 0) & np.isfinite(bp)) | ((bp == 0) & np.isfinite(ap))
        assert ok.all(), f"K pad of {spec.name} (layer {spec.layer})"
    with np.errstate(invalid="ignore"):
        c = (a[:, :, None] * b[None, :, :]).sum(axis=1)
    return c[:spec.mn, :spec.nn]


def _emulate(plan, prop, x, ws, bs, g):
    """The kernel, step by step, for one sample (numpy float64): P (N, N),
    x (N, F0), weights, biases, g (N, sum H). Returns dP, dx, dW, db."""
    n = prop.shape[0]
    dims = [x.shape[1]] + [w.shape[1] for w in ws]
    layers, cl, rows, ps = len(ws), plan.cluster, plan.rows, plan.ps
    dts, ats, das, hmax = plan.dts, plan.ats, plan.das, plan.hmax
    out_off = np.cumsum([0] + dims[1:])[:-1]
    ctas = []
    for rank in range(cl):
        r0 = rank * rows
        own = min(n, r0 + rows) - r0
        sm = np.full(plan.smem_bytes // 4, np.nan)
        ctas.append(dict(
            sm=sm, r0=r0, own=own,
            specs={(s.name, s.layer): s
                   for s in backward_products(plan, n, tuple(dims), rank)},
            dz=sm[plan.off_dz:plan.off_at].reshape(plan.tot_p, dts),
            at=sm[plan.off_at:plan.off_ht].reshape(plan.tot_p, ats),
            ht=sm[plan.off_ht:plan.off_da].reshape(-1, ats),
            da=sm[plan.off_da:plan.off_da + rows * das].reshape(rows, das),
            slot_w=[None] * layers, slot_b=[None] * layers))

    def fill_dz(c, mask_last):
        dz, r0, own = c["dz"], c["r0"], c["own"]
        for l in range(layers):
            fp, fout = plan.fout_p[l], dims[l + 1]
            block = dz[plan.dz_off[l]:plan.dz_off[l] + fp]
            block[fout:] = 0.0
            block[:fout, :r0] = 0.0
            block[:fout, r0 + own:] = 0.0
            vals = g[r0:r0 + own, out_off[l]:out_off[l] + fout].T
            if mask_last and l == layers - 1:
                vals = np.where(c["da"][:own, :fout].T > 0, vals, 0.0)
            block[:fout, r0:r0 + own] = vals

    # 1-2. P's band, its pads, the weights, h^T, a^T and da, dz^T (one CTA)
    for c in ctas:
        sm, r0, own = c["sm"], c["r0"], c["own"]
        for j in range(own):
            sm[j * ps:j * ps + n] = prop[:, r0 + j]
            sm[j * ps + n:(j + 1) * ps] = 0.0
        sm[own * ps:plan.off_dz] = 0.0
        for l in range(layers):
            fin, fout, fp = dims[l], dims[l + 1], plan.fout_p[l]
            w = np.zeros((_ceil(fin, 4), fp))
            w[:fin, :fout] = ws[l]
            sm[plan.off_w[l]:plan.off_w[l] + w.size] = w.ravel()
            sm[plan.off_b[l]:plan.off_b[l] + fp] = np.pad(bs[l], (0, fp - fout))
        c["ht"][:] = 0.0
        c["ht"][:dims[0], :own] = x[r0:r0 + own].T
        c["at"][:] = 0.0
        c["da"][:] = 0.0
        if cl == 1:
            fill_dz(c, False)

    # 3. the recompute
    for l in range(layers):
        fout, last = dims[l + 1], l == layers - 1
        bias = None
        for c in ctas:
            spec = c["specs"][("a", l)]
            av = _product(c["sm"], spec)
            c["at"][plan.dz_off[l]:plan.dz_off[l] + spec.nn, :c["own"]] = av.T
        for c in ctas:
            sm = c["sm"]
            bias = sm[plan.off_b[l]:plan.off_b[l] + fout]
            z = _product(sm, c["specs"][("z", l)])[:, :fout]       # (n, fout)
            if cl > 1:
                part = sm[plan.off_dz:plan.off_dz + n * hmax].reshape(n, hmax)
                part[:, :fout] = z
            elif last:
                dz = c["dz"][plan.dz_off[l]:plan.dz_off[l] + fout, :n]
                dz[~(z.T + bias[:, None] > 0)] = 0.0
            else:
                c["ht"][plan.h_off[l + 1]:plan.h_off[l + 1] + fout, :n] = \
                    np.maximum(z + bias, 0.0).T
        if cl > 1:
            parts = [c["sm"][plan.off_dz:plan.off_dz + n * hmax]
                     .reshape(n, hmax).copy() for c in ctas]
            for c in ctas:
                r0, own = c["r0"], c["own"]
                z = sum(p[r0:r0 + own, :fout] for p in parts)
                h = np.maximum(z + bias, 0.0)
                if last:
                    c["da"][:own, :fout] = h
                else:
                    c["ht"][plan.h_off[l + 1]:plan.h_off[l + 1] + fout,
                            :own] = h.T
    if cl > 1:
        for c in ctas:
            fill_dz(c, True)

    # 4. the backward, last layer first
    dx = np.full((n, dims[0]), np.nan)
    for l in reversed(range(layers)):
        fin, fout, fp = dims[l], dims[l + 1], plan.fout_p[l]
        rows_l = slice(plan.dz_off[l], plan.dz_off[l] + fout)
        if cl > 1:
            for rank, c in enumerate(ctas):
                for q, peer in enumerate(ctas):
                    if q != rank:
                        cols = slice(peer["r0"], peer["r0"] + peer["own"])
                        c["dz"][rows_l, cols] = peer["dz"][rows_l, cols]
        for c in ctas:
            r0, own = c["r0"], c["own"]
            c["slot_b"][l] = c["dz"][rows_l, r0:r0 + own].sum(axis=1)
            da = _product(c["sm"], c["specs"][("da", l)])        # (own, fp)
            c["da"][:own, :fp] = da
        for c in ctas:
            r0, own = c["r0"], c["own"]
            c["slot_w"][l] = _product(c["sm"], c["specs"][("dW", l)])
            e = _product(c["sm"], c["specs"][("e", l)])          # (own, fin)
            if l == 0:
                dx[r0:r0 + own] = e
            else:
                h = c["ht"][plan.h_off[l]:plan.h_off[l] + fin, :own]
                dz = c["dz"][plan.dz_off[l - 1]:plan.dz_off[l - 1] + fin,
                             r0:r0 + own]
                dz[:] = np.where(h > 0, dz + e.T, 0.0)

    # 5. dP's columns of each CTA's band
    dprop = np.full((n, n), np.nan)
    for c in ctas:
        r0, own = c["r0"], c["own"]
        dprop[:, r0:r0 + own] = _product(c["sm"], c["specs"][("dP", -1)]).T
    dws = [sum(c["slot_w"][l] for c in ctas) for l in range(layers)]
    dbs = [sum(c["slot_b"][l] for c in ctas) for l in range(layers)]
    return dprop, dx, dws, dbs


@pytest.mark.parametrize("n,f0,widths", [(90, 3, (16, 16)),
                                         (270, 1, (10, 10, 10)),
                                         (91, 3, (5, 7)),
                                         (400, 1, (10, 10))])
def test_emulated_kernel_on_nan_filled_shared_memory_gives_the_gradients(
        n, f0, widths):
    """N=90 and N=270 (cluster 1 and 2), an odd N whose band has a pad in
    every column and widths that are no multiples of 4, and a shape the
    plan gives a cluster of 4; P with isolated nodes, so z is exactly 0
    (the relu's tie) on some rows."""
    dims = (f0, *widths)
    plan = plan_backward(2, n, dims)
    assert plan.cluster == plan_launch(2, n, dims).cluster
    rng = np.random.default_rng(n)
    prop = rng.normal(0, 0.2, (2, n, n))
    prop[:, :3, :] = 0.0
    prop[:, :, :3] = 0.0
    x = rng.normal(size=(2, n, f0))
    ws = [rng.normal(0, 0.5, (dims[i], dims[i + 1])) for i in range(len(widths))]
    bs = [rng.normal(0, 0.1, h) for h in widths]
    bs[0][:] = 0.0
    g = rng.normal(size=(2, n, sum(widths)))
    dprop, dx, dws, dbs = gcn_stack_backward_reference(
        *[torch.tensor(t) for t in (prop, x)], [torch.tensor(w) for w in ws],
        [torch.tensor(v) for v in bs], torch.tensor(g))
    got_w = [np.zeros(w.shape) for w in ws]
    got_b = [np.zeros(v.shape) for v in bs]
    for s in range(2):
        gp, gx, gw, gb = _emulate(plan, prop[s], x[s], ws, bs, g[s])
        for got in (gp, gx, *gw, *gb):
            assert np.isfinite(got).all()
        np.testing.assert_allclose(gp, dprop[s].numpy(), **TOL)
        np.testing.assert_allclose(gx, dx[s].numpy(), **TOL)
        for k in range(len(ws)):
            got_w[k] += gw[k]
            got_b[k] += gb[k]
    for k in range(len(ws)):
        np.testing.assert_allclose(got_w[k], dws[k].numpy(), **TOL)
        np.testing.assert_allclose(got_b[k], dbs[k].numpy(), **TOL)
