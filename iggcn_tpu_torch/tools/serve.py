"""Serving bundle + batch-prediction CLI + HTTP daemon (port of
`iggcn_tpu/tools/serve.py`).

A bundle is ONE `.npz` holding the model config, the GO topology and the
trained collections, in the same layout the JAX tool reads and writes:
`__meta__` (JSON: model_class, config, topo), `params/...`,
`batch_stats/...` and `topo/...` arrays. A bundle written by either
package serves in the other. The port serves `FusedSGCN` bundles; the
other families come with a later slice.

API:
  save_bundle(path, model)
  model = load_bundle(path, device=None)

CLI (runs on the card unless --device cpu is given):
  python -m iggcn_tpu_torch.tools.serve BUNDLE.npz --npz cohort.npz --out preds.npz
      [--batch 256] [--device cuda|cpu]
  python -m iggcn_tpu_torch.tools.serve BUNDLE.npz --http 8000 [--batch 256]

`cohort.npz` needs arrays `x` (S, N, F), `adj` (S, N, N), `snps` (S, P);
`preds.npz` gets `log_probs`, `pred` and `our_reg`.

HTTP protocol (npz on the wire):
  GET  /health   -> JSON {model_class, batch, dtype, device, ...}
  GET  /stats    -> JSON {requests, errors, subjects_scored, uptime_s,
                    latency_ms {last, p50, p95, window}}
  POST /predict  -> body: npz bytes with x/adj/snps; response: npz bytes
                    with log_probs/pred/our_reg
"""
from __future__ import annotations

import argparse
import collections
import dataclasses
import io
import json
import os
import sys
import threading
import time
from typing import Any, Dict

import numpy as np
import torch

from iggcn_tpu_torch.config import ModelConfig
from iggcn_tpu_torch.data.go_graph import GoTopology
from iggcn_tpu_torch.models.fused_sgcn import FusedSGCN
from iggcn_tpu_torch.predict import batched_forward
from iggcn_tpu_torch.tools.convert import load_flax_variables, to_flax_variables
from iggcn_tpu_torch.utils.platform import resolve_device

# request-body ceiling for the HTTP daemon; a larger Content-Length is
# refused before any allocation
MAX_BODY_BYTES = 256 * 1024 * 1024


def _flatten(tree: Dict[str, Any], prefix: str) -> Dict[str, np.ndarray]:
    """Nested dict of arrays -> {'prefix/a/b': array}."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, f"{prefix}/{k}"))
        else:
            out[f"{prefix}/{k}"] = np.asarray(v)
    return out


def _unflatten(flat: Dict[str, np.ndarray], prefix: str) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    plen = len(prefix) + 1
    for key in sorted(flat):
        if not key.startswith(prefix + "/"):
            continue
        node = out
        parts = key[plen:].split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = flat[key]
    return out


def save_bundle(path: str, model: FusedSGCN) -> None:
    """Write the model's config, GO topology and weights as one npz."""
    topo = model.topo
    variables = to_flax_variables(model)
    meta = {"model_class": type(model).__name__,
            "config": dataclasses.asdict(model.cfg),
            "topo": {"pool": list(map(int, topo.pool)),
                     "n_l": int(topo.n_l),
                     "go_ids": list(topo.go_ids),
                     "go_genes": [list(g) for g in topo.go_genes]}}
    payload = {**_flatten(variables["params"], "params"),
               **_flatten(variables["batch_stats"], "batch_stats"),
               "topo/adj_child_parent": np.asarray(topo.adj_child_parent),
               "topo/go_snps": np.asarray(topo.go_snps),
               "topo/go_level": np.asarray(topo.go_level),
               "__meta__": np.asarray(json.dumps(meta))}
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(path, **payload)


def load_bundle(path: str, device: str | torch.device | None = None
                ) -> FusedSGCN:
    """Rebuild an eval-mode model from a `save_bundle` npz (written by this
    package or by the JAX one) on `device` (default: CUDA)."""
    dev = resolve_device(device)
    with np.load(path, allow_pickle=False) as zf:
        flat = {k: zf[k] for k in zf.files}
    if "__meta__" not in flat:
        raise ValueError(
            f"{path} is not a serving bundle (no __meta__ entry; keys: "
            f"{sorted(flat)[:6]}...) — expected an npz written by "
            "save_bundle / --export_bundle. A cohort npz (x/adj/snps) "
            "belongs on --npz, not in the bundle position.")
    meta = json.loads(str(flat.pop("__meta__")))
    if meta["model_class"] != "FusedSGCN":
        raise ValueError(
            f"bundled model class {meta['model_class']} is not served by the "
            "PyTorch port yet: it serves FusedSGCN bundles; the other "
            "families (GuideImgSnp, ClusterLabelSGCN, GeneOntologyNetwork, "
            "MLPModel) come with a later slice (ROADMAP Queue 1 item 11). "
            "Serve this bundle with iggcn_tpu.tools.serve.")
    topo = GoTopology(
        adj_child_parent=flat.pop("topo/adj_child_parent"),
        go_snps=flat.pop("topo/go_snps"),
        go_level=flat.pop("topo/go_level"),
        pool=list(meta["topo"]["pool"]), n_l=meta["topo"]["n_l"],
        go_ids=list(meta["topo"]["go_ids"]),
        go_genes=[list(g) for g in meta["topo"]["go_genes"]])
    # JSON turns tuples into lists; keys this ModelConfig does not know
    # (a newer producer) are dropped, as the JAX loader does
    known = {f.name for f in dataclasses.fields(ModelConfig)}
    cfg = ModelConfig(**{k: tuple(v) if isinstance(v, list) else v
                         for k, v in meta["config"].items() if k in known})
    model = FusedSGCN(cfg, topo, device=dev)
    load_flax_variables(model, _unflatten(flat, "params"),
                        _unflatten(flat, "batch_stats"))
    return model.eval()


def build_http_server(model: FusedSGCN, *, host: str = "127.0.0.1",
                      port: int = 0, batch: int = 256,
                      device: str | torch.device | None = None):
    """A ready-to-serve `ThreadingHTTPServer` around the model, moved to
    `device` (default: CUDA). The caller owns the lifecycle
    (`serve_forever` / `shutdown`); bind port 0 and read
    `server.server_address` for a free port.

    Inference is serialised behind a lock (one device, one queue); threads
    still overlap request I/O. Every request pads to the fixed serving
    batch, and a warm-up forward runs (and builds the kernel) before the
    socket binds.

    `/stats` counts a request before its reply is written, so a client
    that has read a reply finds it counted; a request's latency therefore
    runs from the start of its handling until its reply body is ready and
    leaves out the write to the socket.
    """
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    dev = resolve_device(device)
    model = model.to(dev).eval()
    cfg = model.cfg
    lock = threading.Lock()
    health = {"model_class": type(model).__name__, "batch": batch,
              "dtype": "float32",
              "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                         else "cpu"),
              "inputs": "x,adj,snps", "rois": cfg.rois,
              "feat_dim": cfg.feat_dim, "num_snps": cfg.num_snps,
              "num_classes": cfg.num_classes}

    def forward(x, adj, snps):
        with lock:
            return batched_forward(model, x, adj, snps, batch_size=batch,
                                   fixed_batch=True)

    forward(np.zeros((1, cfg.rois, cfg.feat_dim), np.float32),
            np.zeros((1, cfg.rois, cfg.rois), np.float32),
            np.zeros((1, cfg.num_snps), np.float32))

    stats_lock = threading.Lock()
    started = time.monotonic()
    counters = {"requests": 0, "errors": 0, "subjects_scored": 0}
    latencies: collections.deque = collections.deque(maxlen=200)

    def _record(ok: bool, subjects: int, dt_s: float) -> None:
        with stats_lock:
            counters["requests"] += 1
            counters["errors"] += 0 if ok else 1
            counters["subjects_scored"] += subjects
            latencies.append(dt_s)

    def _stats() -> dict:
        with stats_lock:
            lat = sorted(latencies)
            last = latencies[-1] if latencies else None
            snap = dict(counters)
        out = {**snap, "uptime_s": round(time.monotonic() - started, 1)}
        if lat:
            out["latency_ms"] = {
                "last": round(last * 1e3, 3),
                "p50": round(lat[len(lat) // 2] * 1e3, 3),
                "p95": round(lat[min(len(lat) - 1,
                                     int(len(lat) * 0.95))] * 1e3, 3),
                "window": len(lat)}
        return out

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # access log to stderr
            sys.stderr.write(f"[serve] {self.address_string()} "
                             f"{fmt % args}\n")

        def _reply(self, code, body, content_type):
            self.send_response(code)
            self.send_header("Content-Type", content_type)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _reply_json(self, code, obj):
            self._reply(code, json.dumps(obj).encode(), "application/json")

        def do_GET(self):
            if self.path == "/health":
                self._reply_json(200, health)
            elif self.path == "/stats":
                self._reply_json(200, _stats())
            else:
                self._reply_json(404, {"error": f"no route {self.path}"})

        def _fail(self, t0, code, msg):
            _record(False, 0, time.monotonic() - t0)
            self._reply_json(code, {"error": msg})

        def do_POST(self):
            if self.path != "/predict":
                self._reply_json(404, {"error": f"no route {self.path}"})
                return
            t0 = time.monotonic()
            try:
                n = int(self.headers.get("Content-Length", 0))
            except ValueError:
                n = 0
            if n <= 0:
                return self._fail(t0, 400, "missing Content-Length")
            if n > MAX_BODY_BYTES:
                return self._fail(t0, 413, f"body {n} bytes exceeds the "
                                           f"{MAX_BODY_BYTES}-byte cap")
            try:
                with np.load(io.BytesIO(self.rfile.read(n)),
                             allow_pickle=False) as zf:
                    args = tuple(np.asarray(zf[k], np.float32)
                                 for k in ("x", "adj", "snps"))
            except (OSError, ValueError, KeyError) as e:
                return self._fail(t0, 400, f"bad request body (want npz "
                                           f"with x/adj/snps): {e}")
            try:
                out = forward(*args)
            except Exception as e:  # a server boundary: report, keep serving
                return self._fail(t0, 500, f"inference failed: {e}")
            buf = io.BytesIO()
            np.savez(buf, **out)
            body = buf.getvalue()
            _record(True, int(args[-1].shape[0]), time.monotonic() - t0)
            self._reply(200, body, "application/octet-stream")

    return ThreadingHTTPServer((host, port), Handler)


def roc_auc_binary(y_true: np.ndarray, scores: np.ndarray) -> float:
    """ROC AUC with pos_label=1 (Mann-Whitney U with midranks for ties);
    0.0 when undefined (one class only, or non-finite scores)."""
    y = np.asarray(y_true) == 1
    n_pos, n_neg = int(y.sum()), int((~y).sum())
    if n_pos == 0 or n_neg == 0 or not np.isfinite(scores).all():
        return 0.0
    _, inverse, counts = np.unique(scores, return_inverse=True,
                                   return_counts=True)
    # midrank of each distinct score value
    ends = np.cumsum(counts)
    midranks = ends - (counts - 1) / 2.0
    u = midranks[inverse][y].sum() - n_pos * (n_pos + 1) / 2.0
    return float(u / (n_pos * n_neg))


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("bundle", help="npz written by save_bundle (either package)")
    p.add_argument("--npz", help="cohort npz with x/adj/snps arrays")
    p.add_argument("--out", help="output predictions npz")
    p.add_argument("--http", type=int, metavar="PORT",
                   help="run a long-lived HTTP daemon on this port instead "
                        "of one-shot scoring (GET /health, GET /stats, "
                        "POST /predict)")
    p.add_argument("--host", default="127.0.0.1",
                   help="HTTP bind address (default loopback)")
    p.add_argument("--batch", type=int, default=256)
    p.add_argument("--device", default=None,
                   help="torch device (default cuda; cpu runs the plain "
                        "PyTorch path on the host)")
    return p


def main(argv=None):
    p = build_parser()
    args = p.parse_args(argv)
    if args.http is None and (args.npz is None or args.out is None):
        p.error("--npz and --out are required unless --http is given")
    if args.http is not None and (args.npz is not None or
                                  args.out is not None):
        p.error("--http is a daemon mode and does not score a cohort; "
                "drop --npz/--out (or drop --http for one-shot scoring)")
    model = load_bundle(args.bundle, device=args.device)
    if args.http is not None:
        server = build_http_server(model, host=args.host, port=args.http,
                                   batch=args.batch, device=args.device)
        host, port = server.server_address[:2]
        print(f"serving {type(model).__name__} on http://{host}:{port} "
              f"(batch {args.batch}, fp32; Ctrl-C to stop)", file=sys.stderr)
        try:
            server.serve_forever()
        except KeyboardInterrupt:
            pass
        finally:
            server.server_close()
        return
    y_true = None
    with np.load(args.npz) as zf:
        x, adj, snps = (np.asarray(zf[k], np.float32)
                        for k in ("x", "adj", "snps"))
        if "y" in zf.files:
            y_true = np.asarray(zf["y"]).reshape(-1)
    out = batched_forward(model, x, adj, snps, batch_size=args.batch)
    np.savez(args.out, **out)
    counts = np.bincount(out["pred"].astype(int))
    print(f"served {snps.shape[0]} subjects -> {args.out} "
          f"(class counts {counts.tolist()})", file=sys.stderr)
    if y_true is not None and y_true.shape[0] == out["pred"].shape[0]:
        acc = float((out["pred"].astype(int) == y_true.astype(int)).mean())
        msg = f"accuracy vs provided labels: {acc:.4f}"
        if out["log_probs"].shape[1] == 2 and len(np.unique(y_true)) == 2:
            auc = roc_auc_binary(y_true.astype(np.int64),
                                 out["log_probs"][:, 1])
            msg += f", auc: {auc:.4f}"
        print(msg, file=sys.stderr)


if __name__ == "__main__":
    main()
