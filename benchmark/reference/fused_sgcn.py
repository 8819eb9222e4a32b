"""Plain PyTorch reference of the SGCN_GCN_IMGSNP family, for judging the
port's outputs.

The math is the reference implementation's dense formulation
(github.com/Houliang-Zhou/IG-GCN: `kernel/go_model.py`,
`kernel/sgcn_img_snp.py`, the objective of
`kernel/train_eval_sgcn_img_snps.py:511-548`), written as functions of a
dict of tensors: plain tensor operations, no kernel, no batching across
models, no cache. Nothing here imports the port: the weights come in as
the benchmark drew them, under the port's state_dict names and layouts
(`W` below), and every derived table (the GO masks, the un-pooling
matrices, the propagation matrix, the clinical targets) is worked out
here again from the raw inputs.

Dropout takes its uniforms from a `torch.Generator` in the order the
reference's forward reaches its dropout sites: a generator seeded as the
program's gives the same masks.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

W = Dict[str, torch.Tensor]
EPS = 1e-5                  # batch and layer norms
BN_MOMENTUM = 0.1           # torch.nn.BatchNorm1d's
RUNNING = ("running_mean", "running_var")
ADAM_BETAS, ADAM_EPS = (0.9, 0.999), 1e-8


def exact_matmuls(on: bool = True) -> None:
    """float32 products in full float32 (TF32 off), or TF32 with `on`
    False: the control's precision."""
    torch.backends.cuda.matmul.allow_tf32 = not on
    torch.backends.cudnn.allow_tf32 = not on


class GoDag:
    """The GO DAG's tables, from its raw child -> parent adjacency (nodes
    leaves first, root last), its GO x SNP incidence and its level sizes:
    layer i's encoder mask (parent <- child messages among the nodes that
    survive i poolings) and decoder un-pooling (1 / row degree over the
    child -> parent slice)."""

    def __init__(self, adj_child_parent: np.ndarray, go_snps: np.ndarray,
                 pool: Sequence[int], n_l: int, device):
        a = np.asarray(adj_child_parent) != 0
        self.pool, self.n_l, self.n = list(pool), n_l, a.shape[0]
        self.enc = []
        for i in range(n_l):
            s = sum(self.pool[:i])
            self.enc.append(torch.as_tensor(a.T[s:, s:], dtype=torch.float32,
                                            device=device))
        self.dec = []
        for i in range(n_l):
            r, c = sum(self.pool[:n_l - i - 1]), sum(self.pool[:n_l - i])
            m = torch.as_tensor(a[r:, c:], dtype=torch.float32, device=device)
            deg = m.sum(-1, keepdim=True)
            self.dec.append(torch.where(deg > 0, m / deg.clamp_min(1.0),
                                        torch.zeros_like(m)))
        self.gene_mask = torch.as_tensor(np.asarray(go_snps) != 0,
                                         dtype=torch.float32, device=device)


class Dropout:
    """Train-mode dropout from uniforms drawn in call order: an entry (or
    a node row) is kept where its uniform is >= the rate and scaled by
    1 / (1 - rate). `generator=None` is eval mode."""

    def __init__(self, generator: Optional[torch.Generator]):
        self.g = generator

    @property
    def train(self) -> bool:
        return self.g is not None

    def _keep(self, shape, rate, device):
        return torch.rand(shape, generator=self.g, device=device) >= rate

    def entries(self, x, rate):
        if not self.train or rate == 0:
            return x
        keep = self._keep(x.shape, rate, x.device)
        return torch.where(keep, x / (1 - rate), torch.zeros_like(x))

    def nodes(self, x, rate):
        if not self.train or rate == 0:
            return x
        keep = self._keep(x.shape[:2] + (1,), rate, x.device)
        return torch.where(keep, x / (1 - rate), torch.zeros_like(x))


def batch_norm(w: W, name: str, x, train: bool):
    """torch.nn.BatchNorm1d: (B, C) per feature, (B, C, L) per channel;
    train mode moves the running statistics in `w` in place."""
    return F.batch_norm(x, w[f"{name}.running_mean"],
                        w[f"{name}.running_var"], w[f"{name}.scale"],
                        w[f"{name}.bias"], training=train,
                        momentum=BN_MOMENTUM, eps=EPS)


def node_layer_norm(w: W, name: str, x):
    """torch.nn.LayerNorm over the node axis of (B, N, F)."""
    n = x.shape[1]
    y = F.layer_norm(x.transpose(1, 2), (n,), w[f"{name}.scale"],
                     w[f"{name}.bias"], eps=EPS)
    return y.transpose(1, 2)


def go_network(w: W, cfg: dict, dag: GoDag, snps, drop: Dropout):
    """`kernel/go_model.py`: gene encoding, n_l attention layers pooling
    the deepest level each, the readouts (attention tokens, latent),
    n_l un-pooling layers and the SNP reconstruction."""
    p = "go_network."
    train = drop.train
    rate_gcn, rate_read = cfg["dropout_go"], cfg["dropout_readout"]
    x = torch.stack([snps @ (dag.gene_mask * w[f"{p}gene_enc_{c}"]).T
                     for c in range(cfg["go_in_f_dim"])], dim=2)
    for i in range(dag.n_l):
        x_in = x @ w[f"{p}w_inc_{i}.weight"].T
        x_s = x @ w[f"{p}w_s_loop_{i}.weight"].T
        f = x_in.shape[-1]
        att = w[f"{p}w_att_in_{i}"][:, 0]
        u, v = x_in @ att[:f], x_in @ att[f:]
        masked = torch.exp(torch.tanh(u[:, :, None] + v[:, None, :])) \
            * dag.enc[i]
        row = masked.sum(-1, keepdim=True)
        a_hat = torch.where(row > 0, masked / row.clamp_min(1e-38),
                            torch.zeros_like(masked))
        v_s = torch.sigmoid(x_s @ w[f"{p}w_att_s_{i}.weight"].T)
        out = a_hat @ x_in + x_s * v_s
        out = drop.nodes(torch.relu(node_layer_norm(w, f"{p}g_b_{i}", out)),
                         rate_gcn)
        x = out[:, dag.pool[i]:, :]
    atten_out = torch.relu(batch_norm(
        w, f"{p}bn_atten", x @ w[f"{p}conc_for_attention.weight"].T, train))
    inp = drop.entries(torch.relu(batch_norm(
        w, f"{p}bn_b", (x @ w[f"{p}conc.weight"].T)[..., 0], train)),
        rate_read)
    h = drop.entries(torch.relu(batch_norm(
        w, f"{p}bn_latent1", inp @ w[f"{p}latent1.weight"].T, train)),
        rate_read)
    latent = torch.relu(batch_norm(w, f"{p}bn_latent2",
                                   h @ w[f"{p}latent2.weight"].T, train))
    for i in range(dag.n_l):
        x_out = x @ w[f"{p}w_out_{i}.weight"].T
        x_s_out = x @ w[f"{p}w_s_loop_out_{i}.weight"].T
        grow = dag.pool[dag.n_l - i - 1]
        out = dag.dec[i] @ x_out + F.pad(x_s_out, (0, 0, grow, 0))
        x = drop.nodes(torch.relu(node_layer_norm(w, f"{p}g_b_d_{i}", out)),
                       rate_gcn)
    out_d = drop.entries(torch.relu(batch_norm(
        w, f"{p}bn_b_d", (x @ w[f"{p}conc_d.weight"].T)[..., 0], train)),
        rate_read)
    x_hat = out_d @ (dag.gene_mask * w[f"{p}gene_dec"])
    return latent, x_hat, atten_out


def propagation(adj):
    """PyG's gcn_norm with add_remaining_self_loops, as a dense matrix:
    prop[i, j] = d_i^-1/2 m[j, i] d_j^-1/2, d the in-degree."""
    n = adj.shape[-1]
    eye = torch.eye(n, dtype=torch.bool, device=adj.device)
    diag = adj.diagonal(dim1=-2, dim2=-1)
    new_diag = torch.where(diag != 0, diag, torch.ones_like(diag))
    m = torch.where(eye, new_diag[..., None, :] * eye, adj)
    deg = m.sum(-2)
    dis = torch.where(deg > 0, deg.clamp_min(1e-38).rsqrt(),
                      torch.zeros_like(deg))
    return dis[..., :, None] * m.transpose(-1, -2) * dis[..., None, :]


def cross_attention(w: W, q_in, kv_in, heads: int):
    """torch.nn.MultiheadAttention(batch_first=True)(q, kv, kv)."""
    b, lq, e = q_in.shape
    lk, dh = kv_in.shape[1], e // heads
    wq, wk, wv = w["mha_in_proj_weight"].split(e)
    bq, bk, bv = w["mha_in_proj_bias"].split(e)
    q = (q_in @ wq.T + bq).reshape(b, lq, heads, dh).transpose(1, 2)
    k = (kv_in @ wk.T + bk).reshape(b, lk, heads, dh).transpose(1, 2)
    v = (kv_in @ wv.T + bv).reshape(b, lk, heads, dh).transpose(1, 2)
    att = torch.softmax(q @ k.transpose(-1, -2) / math.sqrt(dh), dim=-1)
    out = (att @ v).transpose(1, 2).reshape(b, lq, e)
    return out @ w["mha_out_proj_weight"].T + w["mha_out_proj_bias"]


def linear(w: W, name: str, x):
    return x @ w[f"{name}.weight"].T + w[f"{name}.bias"]


def forward(w: W, cfg: dict, dag: GoDag, x, adj, snps, drop: Dropout,
            explain: bool = False) -> Dict[str, torch.Tensor]:
    """`kernel/sgcn_img_snp.py`'s fused forward: (optionally) the learned
    importance masks, the GCN stack with its jumping-knowledge concat, the
    GO branch, 2-head cross-attention, the classification and regression
    heads."""
    b = x.shape[0]
    if explain:
        xp = x * w["prob"]
        d = x.shape[-1]
        pb = w["prob_bias"].reshape(-1)
        ep = torch.sigmoid((xp @ pb[:d])[:, :, None]
                           + (xp @ pb[d:])[:, None, :])
        x_u, adj_u = xp, adj * ep
        snps_u = snps * torch.sigmoid(w["snps_prob"])
    else:
        x_u, adj_u, snps_u = x, adj, snps
    prop = propagation(adj_u)
    h, feats = x_u, []
    for i in range(cfg["num_layers"]):
        h = torch.relu(prop @ (h @ w[f"conv_w_{i}"]) + w[f"conv_b_{i}"])
        feats.append(h)
    batch_x = torch.cat(feats, dim=-1)
    img_out = batch_x.reshape(b, -1)
    latent, snps_hat, atten_out = go_network(w, cfg, dag, snps_u, drop)
    out_cross = torch.relu(cross_attention(w, batch_x, atten_out,
                                           cfg["num_attn_heads"]))
    out_z = (img_out + out_cross.reshape(b, -1)) / 2
    out_lin = torch.cat([out_z, latent], dim=-1)
    linear_outf = torch.relu(linear(w, "lin1", out_lin))
    logits = linear(w, "lin2", drop.entries(linear_outf, cfg["dropout_lin"]))
    feat4regr = torch.cat([out_lin, (x * w["prob"]).reshape(b, -1)], -1)
    reg = torch.relu(linear(w, "lin1_regr", feat4regr))
    reg = linear(w, "lin2_regr", drop.entries(reg, cfg["dropout_regr"]))
    return {"log_probs": torch.log_softmax(logits, dim=-1),
            "snps_hat": snps_hat, "out_z": out_z, "our_reg": reg}


def _entropy(p, eps=1e-6):
    return -(p * torch.log(p + eps) + (1 - p) * torch.log(1 - p + eps))


def _sparsity(w: W, x, adj):
    """`kernel/sgcn_img_snp.py:153-181`: L1 and binary entropy of the
    sigmoid node and SNP importances and of the edge scores on existing
    edges, each weighted 0.1."""
    xp = torch.sigmoid(w["prob"])
    sp = torch.sigmoid(w["snps_prob"])
    d = x.shape[-1]
    pb = w["prob_bias"].reshape(-1)
    xf = x * w["prob"]
    ep = torch.sigmoid((xf @ pb[:d])[:, :, None] + (xf @ pb[d:])[:, None, :])
    epm = ep[adj != 0]
    l1 = xp.abs().mean() + sp.abs().mean() + epm.abs().mean()
    ent = _entropy(xp).mean() + _entropy(sp).mean() + _entropy(epm).mean()
    return 0.1 * l1 + 0.1 * ent


def _consistency(s, sim):
    deg = sim.sum(1)
    gram = s @ s.T
    return ((deg * gram.diagonal()).sum() - (sim * gram).sum()) \
        / (s.shape[0] ** 2)


def _orthogonality(hidden):
    wn = hidden / hidden.norm(dim=1, keepdim=True).clamp_min(1e-12)
    gram = wn.T @ wn
    eye = torch.eye(gram.shape[0], device=hidden.device)
    return ((gram - eye) ** 2).sum() / (hidden.shape[0] ** 2)


def objective(w: W, cfg: dict, dag: GoDag, batch: Dict[str, torch.Tensor],
              drop: Dropout):
    """The 7-term training loss (`kernel/train_eval_sgcn_img_snps.py:
    511-548`) of the plain and the importance-masked pass."""
    x, adj, snps = batch["x"], batch["adj"], batch["snps"]
    out = forward(w, cfg, dag, x, adj, snps, drop)
    out_m = forward(w, cfg, dag, x, adj, snps, drop, explain=True)
    return loss_of(w, cfg, batch, out, out_m)


def loss_of(w: W, cfg: dict, batch: Dict[str, torch.Tensor], out: dict,
            out_m: dict):
    """The 7-term loss of one batch from its two passes' outputs: disease
    CE and regression MSE of both, the sparsity penalty, the SNP
    reconstruction, the similarity consistency over the RBF affinity of
    the t-SNE features and the orthogonality of the fused embedding."""
    lw = cfg["loss"]
    x, adj, snps = batch["x"], batch["adj"], batch["snps"]
    y, clini = batch["y"], batch["clini"]
    loss = lw["disease"] * (F.nll_loss(out["log_probs"], y)
                            + F.nll_loss(out_m["log_probs"], y))
    loss = loss + lw["regr"] * (F.mse_loss(out["our_reg"], clini)
                                + F.mse_loss(out_m["our_reg"], clini)) / 2
    loss = loss + lw["prob"] * _sparsity(w, x, adj)
    loss = loss + lw["reco"] * (((out["snps_hat"] - snps) ** 2).sum()
                                + ((out_m["snps_hat"] - snps) ** 2).sum()) / 2
    sim = torch.exp(-cfg["rbf_gamma"]
                    * torch.cdist(batch["tsne"], batch["tsne"]) ** 2)
    loss = loss + lw["simi"] * (_consistency(out["out_z"], sim)
                                + _consistency(out_m["out_z"], sim)) / 2
    return loss + lw["orth"] * _orthogonality(out["out_z"])


def train_steps(init: W, cfg: dict, dag: GoDag,
                batches: List[Dict[str, torch.Tensor]],
                generator: torch.Generator, lr: float,
                weight_decay: float) -> dict:
    """Adam with coupled L2 (torch.optim.Adam) over `batches` from the
    weights `init`: each step's loss, each leaf's first gradient as the
    optimiser takes it (with the decay term), each leaf's change over all
    the steps and each running statistic's."""
    params = {k: v.detach().clone().requires_grad_(True)
              for k, v in init.items() if not k.endswith(RUNNING)}
    stats = {k: v.detach().clone() for k, v in init.items()
             if k.endswith(RUNNING)}
    opt = torch.optim.Adam(list(params.values()), lr=lr, betas=ADAM_BETAS,
                           eps=ADAM_EPS, weight_decay=weight_decay,
                           foreach=False)
    drop = Dropout(generator)
    losses, first_grad = [], None
    for batch in batches:
        opt.zero_grad(set_to_none=False)
        loss = objective({**params, **stats}, cfg, dag, batch, drop)
        loss.backward()
        if first_grad is None:
            first_grad = {k: (p.grad + weight_decay * p).detach().clone()
                          for k, p in params.items()}
        opt.step()
        losses.append(float(loss.detach()))
    change = {k: (p.detach() - init[k]) for k, p in params.items()}
    return {"losses": losses, "first_grad": first_grad, "change": change,
            "stats": {k: v - init[k] for k, v in stats.items()}}


@torch.no_grad()
def evaluate(w: W, cfg: dict, dag: GoDag, data: Dict[str, torch.Tensor],
             batch_size: int, block: int = 512) -> dict:
    """Eval mode over a fold's rows, taken in the trainer's batches of
    `batch_size`: the loss summed over the batches (each batch's loss
    times its rows) and the plain pass's log_probs and our_reg of every
    row. The passes run in blocks of rows (eval mode treats each row
    apart); each batch's loss is taken from its rows' outputs."""
    drop = Dropout(None)
    n = len(data["x"])
    passes = []
    for explain in (False, True):
        outs = [forward(w, cfg, dag, data["x"][i:i + block],
                        data["adj"][i:i + block], data["snps"][i:i + block],
                        drop, explain=explain) for i in range(0, n, block)]
        passes.append({k: torch.cat([o[k] for o in outs]) for k in outs[0]})
    total = 0.0
    for i in range(0, n, batch_size):
        batch, out, out_m = ({k: v[i:i + batch_size] for k, v in d.items()}
                             for d in (data, *passes))
        total += len(batch["x"]) * float(loss_of(w, cfg, batch, out, out_m))
    return {"loss_sum": total, "log_probs": passes[0]["log_probs"],
            "our_reg": passes[0]["our_reg"]}


@torch.no_grad()
def serve(w: W, cfg: dict, dag: GoDag, x, adj, snps, block: int) -> dict:
    """Eval-mode forward over a cohort in blocks of rows: log_probs and
    our_reg as float32 tensors."""
    drop = Dropout(None)
    outs = [forward(w, cfg, dag, x[i:i + block], adj[i:i + block],
                    snps[i:i + block], drop) for i in range(0, len(x), block)]
    return {k: torch.cat([o[k] for o in outs]) for k in ("log_probs",
                                                          "our_reg")}


def clinical_targets(demographics: np.ndarray, columns: Sequence[int]
                     ) -> np.ndarray:
    """The regression targets: the demographics' score columns min-max
    scaled over the cohort (a constant column scales by 1)."""
    lo, hi = demographics.min(axis=0), demographics.max(axis=0)
    rng = np.where(hi - lo == 0, 1.0, hi - lo)
    return ((demographics - lo) / rng)[:, list(columns)].astype(np.float32)
