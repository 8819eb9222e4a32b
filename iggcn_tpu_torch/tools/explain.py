"""Interpretability export from a trained fold checkpoint or serving bundle
(port of `iggcn_tpu/tools/explain.py`).

It reads a `gcn_state_dict_*_fold_k.msgpack` checkpoint
(`train/checkpoint.py`) or a `serving_bundle_*.npz`, written by either
package, and exports in the reference's analysis units:

  * the learned importances as they are stored: node importance `prob`
    (ROIs, D), SNP importance `snps_prob` (1, SNPs), the edge scorer
    `prob_bias` (2D, 1), GUIDE's mask logits `bias_n`;
  * with `--x_npy`, per-subject edge probabilities
    sigmoid([x_r * prob || x_c * prob] @ prob_bias) (`ops/masking.py`);
  * with `--x_npy` and `--adj_npy` on an SGCN image-family checkpoint
    (SGCN_GCN, SGCN_GAT, SGCN_Ori), grad-CAM saliency per subject and ROI
    from the model's `trunk` / `head` seam and `torch.autograd.grad`.

With `--plot` each export also gets its figure (`utils/plots.py`, the
JAX tool's figures pixel for pixel): sorted importance bars, the
subject-mean edge-probability heatmap and the grad-CAM saliency bar. It
needs matplotlib, which the card host does not have.

Usage (runs on the card unless --device cpu is given):
  python -m iggcn_tpu_torch.tools.explain CKPT --out DIR
      [--x_npy X.npy [--adj_npy A.npy]] [--plot] [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import os
import sys
from typing import Any, Dict, Optional

import numpy as np
import torch

from iggcn_tpu_torch.models.sgcn_image import SGCNImage, SGCNOri
from iggcn_tpu_torch.ops.masking import edge_probability_dense
from iggcn_tpu_torch.tools.convert import load_flax_variables
from iggcn_tpu_torch.tools.serve import read_bundle
from iggcn_tpu_torch.train.checkpoint import load_checkpoint
from iggcn_tpu_torch.utils.platform import resolve_device

IMPORTANCES = (("prob", "node_importance"), ("snps_prob", "snps_importance"),
               ("prob_bias", "edge_prob_bias"), ("bias_n", "mask_importance"))


def load_payload(path: str) -> Dict[str, Any]:
    """{"params": ..., "batch_stats": ...} host trees of a checkpoint or a
    serving bundle, chosen by content (an npz is a ZIP file, `PK`)."""
    with open(path, "rb") as fh:
        head = fh.read(2)
    if head == b"PK":
        _, params, batch_stats, _ = read_bundle(path)
        return {"params": params, "batch_stats": batch_stats}
    return load_checkpoint(path)


def export_importances(params: Dict[str, Any], out_dir: str,
                       prefix: str = "ckpt") -> Dict[str, np.ndarray]:
    """Save every importance leaf the params have as
    `{node,snps,mask}_importance_{prefix}.npy` / `edge_prob_bias_...`."""
    os.makedirs(out_dir, exist_ok=True)
    out = {}
    for key, fname in IMPORTANCES:
        if key in params:
            arr = np.asarray(params[key])
            out[key] = arr
            np.save(os.path.join(out_dir, f"{fname}_{prefix}.npy"), arr)
    return out


def plot_importances(exported: Dict[str, np.ndarray], out_dir: str,
                     prefix: str = "ckpt") -> list:
    """Render a sorted importance bar chart per exported tensor, in the
    tensor's analysis units (matching tests/test_interpretability.py):
    sigmoid for prob/snps_prob, softmax keep-probability for the guide
    family's bias_n mask logits. prob_bias (the edge-scorer WEIGHTS, not
    per-entity scores) is skipped — per-subject edge probabilities get
    their own heatmap when --x_npy is given."""
    from iggcn_tpu_torch.utils.plots import plot_importance_bar

    def sigmoid(a):
        return 1.0 / (1.0 + np.exp(-np.asarray(a, np.float64)))

    pngs = []
    if "prob" in exported:
        v = sigmoid(exported["prob"])
        v = v.mean(axis=-1) if v.ndim > 1 else v      # (rois, D) -> (rois,)
        pngs.append(plot_importance_bar(
            v, os.path.join(out_dir, f"node_importance_{prefix}.png"),
            title="ROI importance sigmoid(prob)"))
    if "snps_prob" in exported:
        pngs.append(plot_importance_bar(
            sigmoid(exported["snps_prob"]).reshape(-1),
            os.path.join(out_dir, f"snps_importance_{prefix}.png"),
            title="SNP importance sigmoid(snps_prob)", item_name="SNP"))
    if "bias_n" in exported:
        logits = np.asarray(exported["bias_n"], np.float64)
        e = np.exp(logits - logits.max(axis=-1, keepdims=True))
        keep = (e / e.sum(axis=-1, keepdims=True))[:, 1]
        pngs.append(plot_importance_bar(
            keep, os.path.join(out_dir, f"mask_importance_{prefix}.png"),
            title="Gumbel mask keep-probability", item_name="feature"))
    return pngs


def export_edge_probabilities(params: Dict[str, Any], x: np.ndarray,
                              out_dir: str, prefix: str = "ckpt",
                              device: str | torch.device | None = None
                              ) -> np.ndarray:
    """(S, N, N) dense edge scores sigmoid([x_r || x_c] @ prob_bias) of the
    prob-masked features, saved as `edge_probability_{prefix}.npy`."""
    dev = resolve_device(device)

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    with torch.no_grad():
        ep = edge_probability_dense(t(x) * t(params["prob"]),
                                    t(params["prob_bias"])).cpu().numpy()
    os.makedirs(out_dir, exist_ok=True)
    np.save(os.path.join(out_dir, f"edge_probability_{prefix}.npy"), ep)
    return ep


def grad_cam(model: torch.nn.Module, x: np.ndarray, adj: np.ndarray, *,
             class_index: Optional[int] = None, is_explain: bool = False,
             pooled: bool = True) -> np.ndarray:
    """(S, N) grad-CAM saliency of an SGCN image-family model in eval mode.

    `trunk` gives the last conv's pre-relu activations A (S, N, C); the
    gradient of the target class's log-probability through `head` is
    dy/dA. Pooled (graph Grad-CAM): alpha_c = mean_n dy/dA_{n,c}, map_n =
    relu(sum_c alpha_c A_{n,c}); unpooled: relu(sum_c dy/dA * A).
    `class_index` None explains each subject's predicted class."""
    n_classes = (model.lin2.weight.shape[0] if hasattr(model, "lin2")
                 else model.fc3.weight.shape[0])
    if class_index is not None and not 0 <= class_index < n_classes:
        raise ValueError(f"class_index {class_index} out of range for a "
                         f"{n_classes}-class model")
    dev = next(model.parameters()).device
    model.eval()
    xt = torch.as_tensor(np.asarray(x, np.float32), device=dev)
    at = torch.as_tensor(np.asarray(adj, np.float32), device=dev)
    with torch.no_grad():
        prefix, acts = model.trunk(xt, at, is_explain=is_explain)
    acts = acts.detach().requires_grad_(True)
    log_probs = model.head(prefix, acts)
    if class_index is None:
        target = log_probs.argmax(dim=-1)
    else:
        target = torch.full((xt.shape[0],), class_index, device=dev)
    score = log_probs.gather(1, target[:, None]).sum()
    (grads,) = torch.autograd.grad(score, acts)
    with torch.no_grad():
        if pooled:
            alpha = grads.mean(dim=1, keepdim=True)           # (S, 1, C)
            cam = torch.relu((alpha * acts).sum(dim=-1))       # (S, N)
        else:
            cam = torch.relu((grads * acts).sum(dim=-1))
    return cam.cpu().numpy().astype(np.float32)


def export_grad_cam(params: Dict[str, Any], batch_stats: Dict[str, Any],
                    x: np.ndarray, adj: np.ndarray, out_dir: str,
                    prefix: str = "ckpt", *, use_gat: Optional[bool] = None,
                    num_layers: Optional[int] = None,
                    hidden: Optional[int] = None,
                    class_index: Optional[int] = None,
                    device: str | torch.device | None = None) -> np.ndarray:
    """Build the SGCN image-family model of the checkpoint, load its
    weights and save its grad-CAM as `grad_cam_{prefix}.npy`. The layer
    count, width and conv kind come from the param keys and shapes
    (`gat_w_i` / `conv_w_i`, SGCN_Ori's `conv1_w`) unless given; the class
    count from the head."""
    dev = resolve_device(device)
    if "conv1_w" in params and "fc3" in params:
        if num_layers is not None or hidden is not None or use_gat:
            raise ValueError(
                "checkpoint is an SGCN_Ori (fixed conv1->conv3) model; "
                "--gradcam_layers/--gradcam_hidden/use_gat do not apply")
        model = SGCNOri(
            h0=x.shape[2], rois=x.shape[1],
            h1=int(np.asarray(params["conv1_w"]).shape[1]),
            h3=int(np.asarray(params["conv3_w"]).shape[1]),
            num_classes=int(np.asarray(params["fc3"]["kernel"]).shape[1]),
            device=dev)
    else:
        if use_gat is None:
            use_gat = any(k.startswith("gat_") for k in params)
        stem = "gat_w_" if use_gat else "conv_w_"
        conv_keys = [k for k in params if k.startswith(stem)]
        if not conv_keys:
            raise ValueError(
                "checkpoint has no SGCN image-family conv parameters "
                f"(no '{stem}*' keys); grad-CAM targets the SGCN image "
                "models")
        if num_layers is None:
            num_layers = len(conv_keys)
        if hidden is None:
            hidden = int(np.asarray(params[stem + "0"]).shape[1])
        lin1 = np.asarray(params["lin1"]["kernel"])
        model = SGCNImage(
            num_layers=num_layers, hidden=hidden, rois=x.shape[1],
            feat_dim=x.shape[2], use_gat=use_gat,
            hidden_linear=int(lin1.shape[1]),
            num_classes=int(np.asarray(params["lin2"]["kernel"]).shape[1]),
            device=dev)
    load_flax_variables(model, params, batch_stats)
    cam = grad_cam(model, x, adj, class_index=class_index)
    os.makedirs(out_dir, exist_ok=True)
    np.save(os.path.join(out_dir, f"grad_cam_{prefix}.npy"), cam)
    return cam


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("checkpoint",
                   help="gcn_state_dict_*.msgpack checkpoint or a "
                        "serving_bundle_*.npz bundle (either package)")
    p.add_argument("--out", default="./explain_out")
    p.add_argument("--prefix", default="ckpt")
    p.add_argument("--x_npy", default=None,
                   help="(S, N, D) features npy for per-subject edge "
                        "probabilities")
    p.add_argument("--adj_npy", default=None,
                   help="(S, N, N) adjacency npy; with --x_npy on an SGCN "
                        "image checkpoint, also exports grad-CAM saliency")
    p.add_argument("--gradcam_layers", type=int, default=None,
                   help="override the layer count (default: from the ckpt)")
    p.add_argument("--gradcam_hidden", type=int, default=None,
                   help="override the hidden width (default: from the ckpt)")
    p.add_argument("--gradcam_class", type=int, default=None)
    p.add_argument("--plot", action="store_true", default=False,
                   help="also render figures (png) next to each exported "
                        "npy: sorted importance bars, subject-mean edge-"
                        "probability heatmap, grad-CAM saliency bar")
    p.add_argument("--device", default=None,
                   help="torch device (default cuda; cpu runs on the host)")
    return p


def main(argv=None):
    parser = build_parser()
    args = parser.parse_args(argv)
    dev = resolve_device(args.device)
    payload = load_payload(args.checkpoint)
    params = payload["params"]
    out = export_importances(params, args.out, args.prefix)
    n_exported = len(out)
    if out:
        print(f"exported {sorted(out)} to {args.out}")
    if args.plot and out:
        for png in plot_importances(out, args.out, args.prefix):
            print(f"figure {png}")
    if args.x_npy is not None:
        if "prob" in params and "prob_bias" in params:
            ep = export_edge_probabilities(params, np.load(args.x_npy),
                                           args.out, args.prefix,
                                           device=dev)
            n_exported += 1
            print(f"edge probabilities {ep.shape} exported")
            if args.plot:
                from iggcn_tpu_torch.utils.plots import plot_matrix
                png = plot_matrix(
                    ep.mean(axis=0),
                    os.path.join(args.out,
                                 f"edge_probability_{args.prefix}.png"),
                    title="Edge probability (subject mean)")
                print(f"figure {png}")
        else:
            print("edge probabilities skipped: checkpoint has no "
                  "prob/prob_bias importance parameters")
    if args.x_npy is not None and args.adj_npy is not None:
        if "go_network" in params or "mha_in_proj_weight" in params:
            print("grad-CAM skipped: fused-model checkpoint (importances and "
                  "edge probabilities above are the interpretability "
                  "artifacts for this family)")
        else:
            cam = export_grad_cam(
                params, payload.get("batch_stats") or {}, np.load(args.x_npy),
                np.load(args.adj_npy), args.out, args.prefix,
                num_layers=args.gradcam_layers, hidden=args.gradcam_hidden,
                class_index=args.gradcam_class, device=dev)
            n_exported += 1
            print(f"grad-CAM saliency {cam.shape} exported")
            if args.plot:
                from iggcn_tpu_torch.utils.plots import plot_importance_bar
                sal = np.abs(np.asarray(cam, np.float64))
                if sal.ndim > 1:
                    sal = sal.mean(axis=0)      # subject mean -> (rois,)
                while sal.ndim > 1:
                    sal = sal.mean(axis=-1)
                png = plot_importance_bar(
                    sal / max(float(sal.max()), 1e-12),
                    os.path.join(args.out, f"grad_cam_{args.prefix}.png"),
                    title="Grad-CAM saliency (subject mean, normalized)")
                print(f"figure {png}")
    if not n_exported:
        print("error: no interpretability artifacts in this checkpoint — it "
              "has none of the prob/snps_prob/prob_bias importance leaves "
              "(those live on the SGCN image and fused families), and "
              "grad-CAM needs --x_npy/--adj_npy on an SGCN image-family "
              "checkpoint. SNP-only GeneOntologyNetwork/MLPModel bundles have "
              "no importance parameters.", file=sys.stderr)
        raise SystemExit(2)


if __name__ == "__main__":
    main()
