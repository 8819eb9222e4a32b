"""Import a reference-trained torch checkpoint into the port (port of
`iggcn_tpu/tools/import_torch.py`).

The reference's flagship trainer saves ``model.state_dict()`` for its fused
``SGCN_GCN_IMGSNP`` model whenever a fold's validation loss improves
(``kernel/train_eval_sgcn_img_snps.py:184-185,379-380`` —
``gcn_state_dict_<name>_fold_<k>.pt``) and then NEVER loads it: the files are
write-only artifacts upstream. This tool closes the migration loop — a user
switching frameworks keeps their trained models: the checkpoint converts into
a serving bundle (``iggcn_tpu_torch/tools/serve.py``) or, through
``python -m iggcn_tpu_torch.main --init_from_torch``, into the starting
weights of every fold. The port's modules keep the flax layout's names
(``tools/convert.py``); this converter is the one place that speaks the
upstream keys, and it turns them into the same flax trees as the JAX
package's converter, so both packages import a ``.pt`` alike.

Layout mapping (reference -> here):

* PyG ``GCNConv`` layers (``conv1``, ``convs.{i}``): ``lin.weight`` is
  (out, in) in PyG >= 2.0 -> transposed into our (in, out) ``conv_w_{i}``;
  the pre-2.0 layout (a direct ``weight`` of shape (in, out)) is accepted
  as-is. ``bias`` maps unchanged.
* ``torch.nn`` Linears (``lin1``/``lin2``/``lin1_regr``/``lin2_regr`` and
  every GO-branch Linear): ``weight`` (out, in) -> ``kernel`` (in, out).
* ``nn.MultiheadAttention``: in/out projection weights keep torch layout
  (the model consumes them in torch packing, ``ops/attention.py``).
* Sparse GO gene coding: the reference stores only the VALUE vectors of
  ``A_g = to_sparse(go_snps).coalesce()`` (``kernel/go_model.py:77-88`` —
  ``t.{c}`` over A_g's nonzeros, ``t_D.0`` over A_g.t()'s). torch's
  ``coalesce`` sorts indices row-major, so values scatter into our dense
  ``gene_enc_{c}``/``gene_dec`` at ``np.nonzero(go_snps)`` /
  ``np.nonzero(go_snps.T)`` positions (ordering pinned against torch itself
  in ``tests/test_import_torch.py``). Off-mask entries are set to 1.0 (the
  reference's init mean); every consumer multiplies by the mask first.
* BatchNorms inside reference ``nn.Sequential`` blocks map by position
  (``conc_for_attention.1`` -> ``bn_atten``, ``B.0`` -> ``bn_b``,
  ``B_D.0`` -> ``bn_b_d``, ``latent.1``/``latent.5`` ->
  ``bn_latent1``/``bn_latent2``); ``running_mean``/``running_var`` land in
  the ``batch_stats`` collection (both frameworks store the UNBIASED
  running variance, ``models/nn_compat.py:BatchNorm1d``).

Keys the reference registers but its fused forward never reads are accepted
and dropped (reported on stderr): ``edge_prob`` (superseded by the
``prob_bias`` rank-1 attention, ``kernel/sgcn_img_snp.py:142``),
``batch_norm``/``batch_norm_1d`` (defined ``sgcn_img_snp.py:86,101``, never
called), the GO ``classification`` head (its output is discarded at
``sgcn_img_snp.py:237``), and BN ``num_batches_tracked`` counters. Any OTHER
unknown key — or any missing/mis-shaped expected key — aborts loudly: a
checkpoint from a different reference model family must not half-import.

CLI (a host-side conversion; no card needed):
  python -m iggcn_tpu_torch.tools.import_torch --ckpt ck.pt --out b.npz \
      --json_path J --go_connection_path C --snps_to_gene_path G
  python -m iggcn_tpu_torch.tools.import_torch --reverse --ckpt b.npz \
      --out ck.pt
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Any, Dict, Mapping, Tuple

import numpy as np

# ---------------------------------------------------------------------------
# state-dict conversion


class ImportError_(ValueError):
    """Conversion failure (missing / unknown / mis-shaped keys)."""


_IGNORED_EXACT = ("edge_prob",)
_IGNORED_PREFIXES = ("batch_norm.", "batch_norm_1d.",
                     "go_network.classification.")
_IGNORED_SUFFIXES = (".num_batches_tracked",)


def _ignorable(key: str) -> bool:
    return (key in _IGNORED_EXACT
            or key.startswith(_IGNORED_PREFIXES)
            or key.endswith(_IGNORED_SUFFIXES))


def _to_numpy(v: Any) -> np.ndarray:
    if hasattr(v, "detach"):               # torch tensor
        v = v.detach().cpu().numpy()
    return np.asarray(v, dtype=np.float32)


class _Taker:
    """Tracks which state-dict keys have been consumed."""

    def __init__(self, sd: Mapping[str, Any]):
        self.sd = {k: v for k, v in sd.items()}
        self.remaining = set(self.sd)

    def take(self, key: str, shape: Tuple[int, ...]) -> np.ndarray:
        if key not in self.sd:
            raise ImportError_(
                f"reference checkpoint is missing expected key {key!r} "
                f"(expected shape {shape}). Is this really a fused "
                f"SGCN_GCN_IMGSNP state_dict?")
        arr = _to_numpy(self.sd[key])
        if tuple(arr.shape) != tuple(shape):
            raise ImportError_(
                f"shape mismatch for {key!r}: checkpoint has {arr.shape}, "
                f"the target architecture needs {shape} — the checkpoint "
                f"was trained with different hyperparameters than the "
                f"inferred/passed ModelConfig")
        self.remaining.discard(key)
        return arr

    def has(self, key: str) -> bool:
        return key in self.sd

    def finish(self) -> Tuple[list, list]:
        ignored = sorted(k for k in self.remaining if _ignorable(k))
        unknown = sorted(k for k in self.remaining if not _ignorable(k))
        if unknown:
            raise ImportError_(
                "unrecognized state_dict keys (not part of the fused "
                f"SGCN_GCN_IMGSNP layout and not on the documented "
                f"unused-parameter ignore list): {unknown}")
        return ignored, []


def _conv_weight(t: _Taker, base: str, in_dim: int, out_dim: int
                 ) -> np.ndarray:
    """GCNConv weight in either PyG layout -> our (in, out) kernel."""
    if t.has(f"{base}.lin.weight"):        # PyG >= 2.0: (out, in)
        return t.take(f"{base}.lin.weight", (out_dim, in_dim)).T.copy()
    # PyG < 2.0 stored a direct (in, out) ``weight``
    return t.take(f"{base}.weight", (in_dim, out_dim))


def _linear_kernel(t: _Taker, key: str, in_dim: int, out_dim: int
                   ) -> np.ndarray:
    return t.take(key, (out_dim, in_dim)).T.copy()


def _scatter_sparse_values(vals: np.ndarray, mask: np.ndarray) -> np.ndarray:
    """Place coalesced sparse values into a dense (mask-shaped) array.

    torch's ``coalesce()`` sorts indices lexicographically (row-major) —
    exactly ``np.nonzero``'s C-order (pinned against torch in the tests).
    """
    rows, cols = np.nonzero(mask)
    if vals.shape != rows.shape:
        raise ImportError_(
            f"sparse value vector has {vals.shape[0]} entries but the GO "
            f"gene/SNP incidence mask has {rows.shape[0]} nonzeros — the "
            f"checkpoint was trained against a DIFFERENT GO topology than "
            f"the one passed to the importer")
    dense = np.ones(mask.shape, np.float32)
    dense[rows, cols] = vals
    return dense


def infer_model_config(sd: Mapping[str, Any], topo) -> "Any":
    """Derive the fused ModelConfig from the state_dict's own shapes.

    Everything architectural is recoverable from tensor shapes; only the
    GO topology (which sets n/n_top and the sparse orderings) must be
    supplied externally.
    """
    from iggcn_tpu_torch.config import ModelConfig

    def shape(key):
        if key not in sd:
            raise ImportError_(
                f"cannot infer architecture: key {key!r} missing from the "
                f"state_dict. Is this a fused SGCN_GCN_IMGSNP checkpoint?")
        return tuple(_to_numpy(sd[key]).shape)

    num_layers = 1 + sum(
        1 for k in sd if k.startswith("convs.") and k.endswith(".bias"))
    hidden = shape("conv1.bias")[0]
    rois, feat_dim = shape("prob")
    num_snps = shape("snps_prob")[1]
    hidden_linear, lin1_in = shape("lin1.weight")
    num_classes = shape("lin2.weight")[0]
    num_regr = shape("lin2_regr.weight")[0]
    l_dim = shape("go_network.latent.4.weight")[0]
    jk = num_layers * hidden
    lin1_regr_in = shape("lin1_regr.weight")[1]
    base_in = rois * jk + l_dim
    if lin1_in != base_in:
        raise ImportError_(
            f"lin1 input width {lin1_in} does not match the cross-attention "
            f"fused architecture (rois*num_layers*hidden + l_dim = "
            f"{base_in}) — only the flagship isCrossAtten configuration "
            f"(the one the reference checkpoints) is importable")
    if lin1_regr_in == base_in + rois * feat_dim:
        is_use_prob4regr = True
    elif lin1_regr_in == base_in:
        is_use_prob4regr = False
    else:
        raise ImportError_(
            f"lin1_regr input width {lin1_regr_in} matches neither the "
            f"isuseProb4Regr ({base_in + rois * feat_dim}) nor the plain "
            f"({base_in}) regression head")
    go_in_f_dim = sum(
        1 for k in sd if k.startswith("go_network.t.")
        and not k.endswith("num_batches_tracked"))
    go_n_l = sum(1 for k in sd if k.startswith("go_network.w_inc.")
                 and k.endswith(".weight"))
    go_f_dim = tuple(shape(f"go_network.w_inc.{i}.weight")[0]
                     for i in range(go_n_l))
    return ModelConfig(
        num_layers=num_layers, hidden=hidden, rois=rois, feat_dim=feat_dim,
        num_classes=num_classes, num_regr=num_regr,
        hidden_linear=hidden_linear, l_dim=l_dim, go_in_f_dim=go_in_f_dim,
        go_n_l=go_n_l, go_f_dim=go_f_dim, num_snps=num_snps,
        is_use_prob4regr=is_use_prob4regr)


def convert_fused_state_dict(sd: Mapping[str, Any], topo, cfg
                             ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """Reference ``SGCN_GCN_IMGSNP.state_dict()`` -> (params, batch_stats).

    Raises ImportError_ on missing, unknown, or mis-shaped keys. Prints the
    consumed-but-unused reference parameters to stderr (see module
    docstring for why each is unused upstream).
    """
    t = _Taker(sd)
    cfgd = cfg
    params: Dict[str, Any] = {}
    jk = cfgd.num_layers * cfgd.hidden

    # imaging GCN stack
    dims = [cfgd.feat_dim] + [cfgd.hidden] * cfgd.num_layers
    for i in range(cfgd.num_layers):
        base = "conv1" if i == 0 else f"convs.{i - 1}"
        params[f"conv_w_{i}"] = _conv_weight(t, base, dims[i], dims[i + 1])
        params[f"conv_b_{i}"] = t.take(f"{base}.bias", (dims[i + 1],))

    # interpretability parameters
    params["prob"] = t.take("prob", (cfgd.rois, cfgd.feat_dim))
    params["prob_bias"] = t.take("prob_bias", (2 * cfgd.feat_dim, 1))
    params["snps_prob"] = t.take("snps_prob", (1, cfgd.num_snps))

    # cross attention (torch packing kept, ops/attention.py)
    params["mha_in_proj_weight"] = t.take("multihead_attn.in_proj_weight",
                                          (3 * jk, jk))
    params["mha_in_proj_bias"] = t.take("multihead_attn.in_proj_bias",
                                        (3 * jk,))
    params["mha_out_proj_weight"] = t.take(
        "multihead_attn.out_proj.weight", (jk, jk))
    params["mha_out_proj_bias"] = t.take("multihead_attn.out_proj.bias",
                                         (jk,))

    # heads
    lin1_in = cfgd.rois * jk + cfgd.l_dim
    regr_in = lin1_in + (cfgd.rois * cfgd.feat_dim
                         if cfgd.is_use_prob4regr else 0)
    for name, in_d, out_d in (
            ("lin1", lin1_in, cfgd.hidden_linear),
            ("lin2", cfgd.hidden_linear, cfgd.num_classes),
            ("lin1_regr", regr_in, cfgd.hidden_linear),
            ("lin2_regr", cfgd.hidden_linear, cfgd.num_regr)):
        params[name] = {
            "kernel": _linear_kernel(t, f"{name}.weight", in_d, out_d),
            "bias": t.take(f"{name}.bias", (out_d,))}

    # GO branch
    go: Dict[str, Any] = {}
    stats_go: Dict[str, Any] = {}
    mask = np.asarray(topo.go_snps) != 0
    nnz = int(mask.sum())

    def take_sparse_values(key: str) -> np.ndarray:
        if t.has(key):
            got = tuple(_to_numpy(t.sd[key]).shape)
            if got != (nnz,):
                raise ImportError_(
                    f"sparse value vector {key!r} has {got[0]} entries but "
                    f"the GO gene/SNP incidence mask has {nnz} nonzeros — "
                    f"the checkpoint was trained against a DIFFERENT GO "
                    f"topology than the one passed to the importer")
        return t.take(key, (nnz,))

    for c in range(cfgd.go_in_f_dim):
        go[f"gene_enc_{c}"] = _scatter_sparse_values(
            take_sparse_values(f"go_network.t.{c}"), mask)
    # decoder values follow A_g.t().coalesce() ordering: row-major over the
    # TRANSPOSED mask, written back into our (n, s) gene_dec
    go["gene_dec"] = _scatter_sparse_values(
        take_sparse_values("go_network.t_D.0"), mask.T).T.copy()

    fdims = [cfgd.go_in_f_dim] + list(cfgd.go_f_dim)
    n_l = cfgd.go_n_l
    pool = list(topo.pool)
    for i in range(n_l):
        go[f"w_inc_{i}"] = {"kernel": _linear_kernel(
            t, f"go_network.w_inc.{i}.weight", fdims[i], fdims[i + 1])}
        go[f"w_s_loop_{i}"] = {"kernel": _linear_kernel(
            t, f"go_network.w_s_loop.{i}.weight", fdims[i], fdims[i + 1])}
        go[f"w_att_s_{i}"] = {"kernel": _linear_kernel(
            t, f"go_network.w_att_s.{i}.weight", fdims[i + 1], 1)}
        go[f"w_att_in_{i}"] = _linear_kernel(
            t, f"go_network.w_att_in.{i}.weight", 2 * fdims[i + 1], 1)
        width = sum(pool[i:])
        go[f"g_b_{i}"] = {
            "scale": t.take(f"go_network.G_B.{i}.weight", (width,)),
            "bias": t.take(f"go_network.G_B.{i}.bias", (width,))}
        # decoder mirrors: w_out.{i} maps f_dim[n_l-i] -> f_dim[n_l-i-1]
        go[f"w_out_{i}"] = {"kernel": _linear_kernel(
            t, f"go_network.w_out.{i}.weight",
            fdims[n_l - i], fdims[n_l - i - 1])}
        go[f"w_s_loop_out_{i}"] = {"kernel": _linear_kernel(
            t, f"go_network.w_s_loop_out.{i}.weight",
            fdims[n_l - i], fdims[n_l - i - 1])}
        width_d = sum(pool[n_l - 1 - i:])
        go[f"g_b_d_{i}"] = {
            "scale": t.take(f"go_network.G_B_D.{i}.weight", (width_d,)),
            "bias": t.take(f"go_network.G_B_D.{i}.bias", (width_d,))}

    n_top = topo.n - sum(pool[:n_l])

    def bn(target: str, ref_base: str, width: int) -> None:
        go[target] = {
            "scale": t.take(f"{ref_base}.weight", (width,)),
            "bias": t.take(f"{ref_base}.bias", (width,))}
        stats_go[target] = {
            "mean": t.take(f"{ref_base}.running_mean", (width,)),
            "var": t.take(f"{ref_base}.running_var", (width,))}

    go["conc_for_attention"] = {"kernel": _linear_kernel(
        t, "go_network.conc_for_attention.0.weight", fdims[-1], jk)}
    bn("bn_atten", "go_network.conc_for_attention.1", n_top)
    go["conc"] = {"kernel": _linear_kernel(
        t, "go_network.conc.weight", fdims[-1], 1)}
    bn("bn_b", "go_network.B.0", n_top)
    go["conc_d"] = {"kernel": _linear_kernel(
        t, "go_network.conc_D.weight", fdims[0], 1)}
    bn("bn_b_d", "go_network.B_D.0", topo.n)
    go["latent1"] = {"kernel": _linear_kernel(
        t, "go_network.latent.0.weight", n_top, 32)}
    bn("bn_latent1", "go_network.latent.1", 32)
    go["latent2"] = {"kernel": _linear_kernel(
        t, "go_network.latent.4.weight", 32, cfgd.l_dim)}
    bn("bn_latent2", "go_network.latent.5", cfgd.l_dim)

    params["go_network"] = go
    batch_stats = {"go_network": stats_go}

    ignored, _ = t.finish()
    if ignored:
        print(f"[import] dropped {len(ignored)} reference parameters the "
              f"fused forward never reads: {ignored}", file=sys.stderr)
    return params, batch_stats


# ---------------------------------------------------------------------------
# reverse direction: our tree -> reference-layout state_dict


def export_reference_state_dict(params: Mapping[str, Any],
                                batch_stats: Mapping[str, Any],
                                topo, cfg) -> Dict[str, np.ndarray]:
    """Our (params, batch_stats) -> a reference ``SGCN_GCN_IMGSNP``
    state_dict (PyG >= 2.0 conv layout), so models trained HERE can be
    loaded by the reference's ``model.load_state_dict(torch.load(...))``.

    Keys the reference registers but its fused forward never reads are
    synthesized neutrally (strict ``load_state_dict`` requires them):
    ``edge_prob`` zeros, ``batch_norm``/``batch_norm_1d`` and the GO
    ``classification`` head at their framework defaults (BN scale 1 /
    stats 0,1; zero linears). They carry no trained signal in a genuine
    reference checkpoint of this family either — nothing upstream reads
    them (see module docstring).
    """
    sd: Dict[str, np.ndarray] = {}
    go = params["go_network"]
    sgo = batch_stats["go_network"]

    def put(key, arr):
        sd[key] = np.ascontiguousarray(np.asarray(arr, np.float32))

    for i in range(cfg.num_layers):
        base = "conv1" if i == 0 else f"convs.{i - 1}"
        put(f"{base}.lin.weight", np.asarray(params[f"conv_w_{i}"]).T)
        put(f"{base}.bias", params[f"conv_b_{i}"])
    for name in ("prob", "prob_bias", "snps_prob"):
        put(name, params[name])
    put("multihead_attn.in_proj_weight", params["mha_in_proj_weight"])
    put("multihead_attn.in_proj_bias", params["mha_in_proj_bias"])
    put("multihead_attn.out_proj.weight", params["mha_out_proj_weight"])
    put("multihead_attn.out_proj.bias", params["mha_out_proj_bias"])
    for name in ("lin1", "lin2", "lin1_regr", "lin2_regr"):
        put(f"{name}.weight", np.asarray(params[name]["kernel"]).T)
        put(f"{name}.bias", params[name]["bias"])

    mask = np.asarray(topo.go_snps) != 0
    rows, cols = np.nonzero(mask)            # == A_g.coalesce() order
    for c in range(cfg.go_in_f_dim):
        put(f"go_network.t.{c}", np.asarray(go[f"gene_enc_{c}"])[rows, cols])
    dr, dc = np.nonzero(mask.T)              # == A_g.t().coalesce() order
    put("go_network.t_D.0", np.asarray(go["gene_dec"]).T[dr, dc])

    for i in range(cfg.go_n_l):
        for name in ("w_inc", "w_s_loop", "w_att_s", "w_out",
                     "w_s_loop_out"):
            put(f"go_network.{name}.{i}.weight",
                np.asarray(go[f"{name}_{i}"]["kernel"]).T)
        put(f"go_network.w_att_in.{i}.weight",
            np.asarray(go[f"w_att_in_{i}"]).T)
        for ref, ours in (("G_B", "g_b"), ("G_B_D", "g_b_d")):
            put(f"go_network.{ref}.{i}.weight", go[f"{ours}_{i}"]["scale"])
            put(f"go_network.{ref}.{i}.bias", go[f"{ours}_{i}"]["bias"])

    def put_bn(ref_base, target):
        put(f"{ref_base}.weight", go[target]["scale"])
        put(f"{ref_base}.bias", go[target]["bias"])
        put(f"{ref_base}.running_mean", sgo[target]["mean"])
        put(f"{ref_base}.running_var", sgo[target]["var"])
        sd[f"{ref_base}.num_batches_tracked"] = np.asarray(0, np.int64)

    put("go_network.conc_for_attention.0.weight",
        np.asarray(go["conc_for_attention"]["kernel"]).T)
    put_bn("go_network.conc_for_attention.1", "bn_atten")
    put("go_network.conc.weight", np.asarray(go["conc"]["kernel"]).T)
    put_bn("go_network.B.0", "bn_b")
    put("go_network.conc_D.weight", np.asarray(go["conc_d"]["kernel"]).T)
    put_bn("go_network.B_D.0", "bn_b_d")
    put("go_network.latent.0.weight", np.asarray(go["latent1"]["kernel"]).T)
    put_bn("go_network.latent.1", "bn_latent1")
    put("go_network.latent.4.weight", np.asarray(go["latent2"]["kernel"]).T)
    put_bn("go_network.latent.5", "bn_latent2")

    # registered-but-unused reference parameters, synthesized neutrally
    put("edge_prob", np.zeros((cfg.rois, cfg.rois)))
    jk = cfg.num_layers * cfg.hidden
    for base, width in (("batch_norm", jk),
                        ("batch_norm_1d", cfg.rois * jk + cfg.l_dim)):
        put(f"{base}.weight", np.ones(width))
        put(f"{base}.bias", np.zeros(width))
        put(f"{base}.running_mean", np.zeros(width))
        put(f"{base}.running_var", np.ones(width))
        sd[f"{base}.num_batches_tracked"] = np.asarray(0, np.int64)
    cw = cfg.l_dim + cfg.num_snps
    put("go_network.classification.0.weight", np.ones(cw))
    put("go_network.classification.0.bias", np.zeros(cw))
    put("go_network.classification.0.running_mean", np.zeros(cw))
    put("go_network.classification.0.running_var", np.ones(cw))
    sd["go_network.classification.0.num_batches_tracked"] = np.asarray(
        0, np.int64)
    put("go_network.classification.3.weight", np.zeros((16, cw)))
    put("go_network.classification.6.weight", np.zeros((1, 16)))
    put("go_network.classification.6.bias", np.zeros(1))
    return sd


# ---------------------------------------------------------------------------
# CLI


def _load_state_dict(path: str) -> Dict[str, Any]:
    import torch

    obj = torch.load(path, map_location="cpu", weights_only=True)
    if not isinstance(obj, dict) or not all(
            hasattr(v, "shape") for v in obj.values()):
        raise ImportError_(
            f"{path} does not contain a flat state_dict (got "
            f"{type(obj).__name__}) — expected the file written by the "
            f"reference's torch.save(model.state_dict(), ...)")
    return obj


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m iggcn_tpu_torch.tools.import_torch",
        description="Convert a reference gcn_state_dict_*.pt checkpoint "
                    "(fused SGCN_GCN_IMGSNP family) into a serving bundle "
                    "for iggcn_tpu_torch.tools.serve / explain.")
    p.add_argument("--ckpt", required=True,
                   help="path to the reference torch checkpoint "
                        "(gcn_state_dict_<name>_fold_<k>.pt); with "
                        "--reverse: a fused serving bundle (npz)")
    p.add_argument("--out", required=True,
                   help="output serving-bundle npz path; with --reverse: "
                        "output torch .pt path")
    p.add_argument("--reverse", action="store_true",
                   help="export instead of import: convert a fused serving "
                        "bundle (of either package) into a reference-layout "
                        "SGCN_GCN_IMGSNP state_dict loadable by the "
                        "reference's model.load_state_dict (topology "
                        "comes from the bundle; no GO flags needed)")
    p.add_argument("--json_path", default="",
                   help="GO hierarchy json the checkpoint was trained with "
                        "(same file the reference's main.py consumed)")
    p.add_argument("--go_connection_path", default="",
                   help="GO root-connection file (pairs with --json_path)")
    p.add_argument("--snps_to_gene_path", default="",
                   help="SNP-to-gene table (pairs with --json_path)")
    p.add_argument("--synthetic_topo_seed", type=int, default=None,
                   help="build the synthetic GO topology from this seed "
                        "instead of real GO files (matches a run of "
                        "iggcn_tpu_torch.main --synthetic --seed N at the "
                        "default --synthetic_go_levels)")
    return p


def _build_topo(args):
    from iggcn_tpu_torch.data import go_graph

    if args.synthetic_topo_seed is not None:
        return go_graph.synthetic_topology(
            np.random.default_rng(args.synthetic_topo_seed))
    if not (args.json_path and args.go_connection_path
            and args.snps_to_gene_path):
        raise SystemExit(
            "either --synthetic_topo_seed or all three GO source paths "
            "(--json_path --go_connection_path --snps_to_gene_path) are "
            "required: the checkpoint stores only sparse VALUE vectors; "
            "their positions come from the GO topology it was trained with")
    return go_graph.parse_go_json(args.json_path, args.go_connection_path,
                                  args.snps_to_gene_path)


def main(argv=None) -> int:
    """Convert one file; a conversion runs on the host and builds its model
    on the CPU only as the bundle's container. Returns the exit code."""
    args = build_parser().parse_args(argv)
    if args.reverse:
        return _main_reverse(args)
    from iggcn_tpu_torch.models.fused_sgcn import FusedSGCN
    from iggcn_tpu_torch.tools.serve import save_bundle

    topo = _build_topo(args)
    sd = _load_state_dict(args.ckpt)
    try:
        cfg = infer_model_config(sd, topo)
        params, batch_stats = convert_fused_state_dict(sd, topo, cfg)
    except ImportError_ as e:
        print(f"[import] FAILED: {e}", file=sys.stderr)
        return 1
    model = FusedSGCN(cfg, topo, device="cpu")
    save_bundle(args.out, model, params, batch_stats)
    n_params = sum(int(np.prod(np.asarray(v).shape))
                   for v in _flatten_leaves(params))
    print(f"[import] {os.path.basename(args.ckpt)} -> {args.out} "
          f"({n_params:,} parameters; config {json.dumps(_cfg_brief(cfg))})")
    return 0


def _main_reverse(args) -> int:
    import torch

    from iggcn_tpu_torch.tools.convert import to_flax_variables
    from iggcn_tpu_torch.tools.serve import load_bundle

    model = load_bundle(args.ckpt, device="cpu")
    if type(model).__name__ != "FusedSGCN":
        print(f"[import] FAILED: --reverse supports the fused family only "
              f"(the one model the reference can load back); bundle holds "
              f"{type(model).__name__}", file=sys.stderr)
        return 1
    # a fused bundle trained under non-reference knobs has a param tree the
    # reference layout cannot hold — refuse with the tool's clean message
    # instead of dying in the exporter on a raw KeyError
    cfg = model.cfg
    knobs = [("use_gat", cfg.use_gat, False),
             ("graph_pool", cfg.graph_pool, False),
             ("is_cross_atten", cfg.is_cross_atten, True),
             ("model4eachregr", cfg.model4eachregr, False),
             # these keep every param-tree KEY but change out_lin/feat4regr
             # DIMS, so an export would "succeed" into lin1/lin1_regr
             # weights the reference's strict load_state_dict rejects
             ("is_image_only", cfg.is_image_only, False),
             ("is_snps_only", cfg.is_snps_only, False),
             ("is_use_prob4regr", cfg.is_use_prob4regr, True),
             ("is_multi_fusion", cfg.is_multi_fusion, False)]
    off = [f"{k}={v!r}" for k, v, ref in knobs if v != ref]
    if off:
        print("[import] FAILED: bundle was trained with non-reference "
              f"architecture knobs ({', '.join(off)}); the reference "
              "state_dict layout cannot represent that parameter tree",
              file=sys.stderr)
        return 1
    variables = to_flax_variables(model)
    sd = export_reference_state_dict(variables["params"],
                                     variables["batch_stats"], model.topo,
                                     cfg)
    torch.save({k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()},
               args.out)
    print(f"[import] {os.path.basename(args.ckpt)} -> {args.out} "
          f"(reference-layout state_dict, {len(sd)} entries)")
    return 0


def _flatten_leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _flatten_leaves(v)
    else:
        yield tree


def _cfg_brief(cfg) -> Dict[str, Any]:
    return {"num_layers": cfg.num_layers, "hidden": cfg.hidden,
            "rois": cfg.rois, "feat_dim": cfg.feat_dim,
            "l_dim": cfg.l_dim, "num_regr": cfg.num_regr,
            "is_use_prob4regr": cfg.is_use_prob4regr}


if __name__ == "__main__":
    raise SystemExit(main())
