"""Hierarchical attention GCN encoder/decoder over the GO DAG (port of
`iggcn_tpu/models/go_network.py`, relu and prelu variants). In train mode
it drops whole node rows after each encoder and decoder layer and entries
of the readouts, at the JAX package's sites, and its batch norms take the
padding weight of the batch.

The GO topology is static, so its masks, edge one-hots and the decoder's
uniform un-pooling matrices are built once at construction and held as
non-persistent buffers (they move with `.to(device)` and are not
weights). The encoder's edge attention has two implementations of the
same function, equal to fp32 rounding:

  * 'dense': masked (B, n, n) row-normalise and a batched matmul;
  * 'edge': (B, E) scores over the static edge list, with row sums and
    messages aggregated by the static one-hot matrix `agg` (n, E), as the
    JAX package aggregates; no (B, n, n) tensor exists.

'auto' takes 'edge' at batch >= 64, as the JAX package does. The edge
form's gathers are products with one-hot matrices too (`agg` for the
edge's row, `pick_{i}` for its column): exact in the forward (one
non-zero term per output, fp32 products), and their backward is a
matmul, so nothing accumulates with atomics and a CUDA run repeats bit
for bit. A gather's backward (`index`, `index_select`) would sum into
each node with float atomics in an order that changes between launches.
`activation='prelu'` is the GUIDE family's variant (`guide_go_model`): a
learned PReLU in place of every relu, and a latent that ends at `latent2`
with no batch norm. `classifier=True` adds the standalone SNP classifier
head (`classify`: `bn_cls` over [latent || snps], `cls1`, `cls2`) that the
SNP-only trainer uses. Its leaves exist only then: in the JAX package they
exist only where `classify` was traced at init, which the fused models'
GO branches never do.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch
from torch import nn

from iggcn_tpu_torch.data.go_graph import GoTopology
from iggcn_tpu_torch.models.nn_compat import (BatchNorm1d, NodeLayerNorm,
                                              TorchLinear, dropout, normal,
                                              node_dropout, promoted,
                                              torch_linear_init)
from iggcn_tpu_torch.ops.attention import masked_row_normalize

ATTENTION_IMPLS = ("auto", "dense", "edge")
ACTIVATIONS = ("relu", "prelu")


class PReLU(nn.Module):
    """PReLU with one learned slope (`alpha`, 0.25 at init) for every
    entry, as torch's `nn.PReLU()` and the JAX package's `PReLU`."""

    def __init__(self, device=None):
        super().__init__()
        self.alpha = nn.Parameter(torch.full((), 0.25, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.where(x >= 0, x, self.alpha * x)


class GeneOntologyNetwork(nn.Module):
    """Encoder/decoder over a static GO hierarchy.

    Args:
      topo: static GoTopology.
      in_f_dim: number of learned gene-encoding channels.
      n_l: encoder/decoder depth (levels pooled).
      f_dim: hidden dims per layer, length n_l.
      l_dim: latent dim of the readout MLP.
      dim_snps_atten: width of the cross-attention token readout.
      attention_impl: 'auto' | 'dense' | 'edge'.
      dropout_gcn: node-row dropout after each encoder/decoder layer.
      dropout_readout: dropout after the readout batch norms.
      activation: 'relu' | 'prelu'.
      classifier: also build the `classify` head (the SNP-only trainer's).
      dropout_cls: the head's two dropout rates.
    """

    # the constructor's fields a serving bundle records (`ctor` meta), as
    # the JAX package's save_bundle lists the flax module's
    CTOR_FIELDS = ("in_f_dim", "n_l", "f_dim", "l_dim", "dim_snps_atten",
                   "activation", "attention_impl")

    def __init__(self, topo: GoTopology, *, in_f_dim: int = 2, n_l: int = 2,
                 f_dim: Sequence[int] = (5, 5), l_dim: int = 32,
                 dim_snps_atten: int = 5, attention_impl: str = "auto",
                 dropout_gcn: float = 0.4, dropout_readout: float = 0.5,
                 activation: str = "relu", classifier: bool = False,
                 dropout_cls: Tuple[float, float] = (0.5, 0.3),
                 generator=None, device=None):
        super().__init__()
        if attention_impl not in ATTENTION_IMPLS:
            raise ValueError(f"attention_impl must be one of {ATTENTION_IMPLS}; "
                             f"got {attention_impl!r}")
        if activation not in ACTIVATIONS:
            raise ValueError(f"activation must be one of {ACTIVATIONS}; got "
                             f"{activation!r}")
        self.activation = activation
        self.attention_impl = attention_impl
        self.dropout_gcn = dropout_gcn
        self.dropout_readout = dropout_readout
        self.n_l = n_l
        self.f_dim = tuple(f_dim)
        self.l_dim = l_dim
        self.dim_snps_atten = dim_snps_atten
        self.dropout_cls = tuple(dropout_cls)
        self.topo = topo
        self.pool = list(topo.pool)
        n, s = topo.go_snps.shape
        n_top = n - sum(self.pool[:n_l])
        fdims = [in_f_dim] + list(f_dim)
        g, dev = generator, device

        # ---- static topology buffers ----------------------------------
        enc_masks = topo.encoder_masks(n_l)
        for i, m in enumerate(enc_masks):
            r, c = np.nonzero(m)
            self.register_buffer(f"enc_mask_{i}", torch.as_tensor(m, device=dev),
                                 persistent=False)
            # (n_i, E_i) one-hots of each edge's row (the JAX package's
            # `agg`, go_network.py setup) and of its column
            edges = np.arange(len(r))
            for name, idx in (("agg", r), ("pick", c)):
                onehot = np.zeros((m.shape[0], len(r)), np.float32)
                onehot[idx, edges] = 1.0
                self.register_buffer(f"{name}_{i}", torch.as_tensor(
                    onehot, device=dev), persistent=False)
        for jj, m in enumerate(topo.decoder_masks(n_l)):
            # uniform attention: 1/row-degree over the static mask
            mask = torch.as_tensor(m, device=dev)
            self.register_buffer(
                f"dec_attn_{jj}",
                masked_row_normalize(torch.ones(mask.shape, device=dev), mask),
                persistent=False)
        self.register_buffer("gene_mask", torch.as_tensor(
            topo.go_snps != 0, dtype=torch.float32, device=dev), persistent=False)

        # ---- gene encoding/decoding lifts: masked dense (n, S) params ---
        for c in range(in_f_dim):
            setattr(self, f"gene_enc_{c}",
                    nn.Parameter(normal((n, s), 1.0, 0.1, g, dev)))
        self.in_f_dim = in_f_dim
        self.gene_dec = nn.Parameter(normal((n, s), 1.0, 0.1, g, dev))

        # ---- encoder ------------------------------------------------------
        for i in range(n_l):
            fi, fo = fdims[i], fdims[i + 1]
            setattr(self, f"w_inc_{i}", TorchLinear(fi, fo, bias=False,
                                                    generator=g, device=dev))
            setattr(self, f"w_s_loop_{i}", TorchLinear(fi, fo, bias=False,
                                                       generator=g, device=dev))
            setattr(self, f"w_att_s_{i}", TorchLinear(fo, 1, bias=False,
                                                      generator=g, device=dev))
            # raw (2f, 1) kernel: tanh(W [x_r || x_c]) splits into u_r + v_c
            setattr(self, f"w_att_in_{i}", nn.Parameter(
                torch_linear_init((2 * fo, 1), 2 * fo, g, dev)))
            setattr(self, f"g_b_{i}", NodeLayerNorm(sum(self.pool[i:]),
                                                    device=dev))

        # ---- decoder (fdims reversed) ------------------------------------
        for jj in range(n_l):
            fi, fo = fdims[n_l - jj], fdims[n_l - jj - 1]
            setattr(self, f"w_out_{jj}", TorchLinear(fi, fo, bias=False,
                                                     generator=g, device=dev))
            setattr(self, f"w_s_loop_out_{jj}", TorchLinear(
                fi, fo, bias=False, generator=g, device=dev))
            setattr(self, f"g_b_d_{jj}", NodeLayerNorm(
                sum(self.pool[n_l - 1 - jj:]), device=dev))

        # ---- readouts -----------------------------------------------------
        f_top = fdims[n_l]
        self.conc_for_attention = TorchLinear(f_top, dim_snps_atten, bias=False,
                                              generator=g, device=dev)
        self.bn_atten = BatchNorm1d(n_top, device=dev)
        self.conc = TorchLinear(f_top, 1, bias=False, generator=g, device=dev)
        self.bn_b = BatchNorm1d(n_top, device=dev)
        self.conc_d = TorchLinear(in_f_dim, 1, bias=False, generator=g,
                                  device=dev)
        self.bn_b_d = BatchNorm1d(n, device=dev)
        self.latent1 = TorchLinear(n_top, 32, bias=False, generator=g,
                                   device=dev)
        self.bn_latent1 = BatchNorm1d(32, device=dev)
        self.latent2 = TorchLinear(32, l_dim, bias=False, generator=g,
                                   device=dev)
        if activation == "relu":
            self.bn_latent2 = BatchNorm1d(l_dim, device=dev)
        else:
            for i in range(n_l):
                setattr(self, f"act_enc_{i}", PReLU(device=dev))
                setattr(self, f"act_dec_{i}", PReLU(device=dev))
            for name in ("atten", "b", "b_d", "latent1"):
                setattr(self, f"act_{name}", PReLU(device=dev))
        self.classifier = classifier
        if classifier:
            self.bn_cls = BatchNorm1d(l_dim + s, device=dev)
            self.cls1 = TorchLinear(l_dim + s, 16, bias=False, generator=g,
                                    device=dev)
            self.cls2 = TorchLinear(16, 1, generator=g, device=dev)

    def _act(self, x: torch.Tensor, name: str) -> torch.Tensor:
        """relu, or the PReLU `act_<name>` of the prelu variant."""
        if self.activation == "relu":
            return torch.relu(x)
        return getattr(self, f"act_{name}")(x)

    def _attend(self, jj: int, x_in: torch.Tensor, use_edge: bool
                ) -> torch.Tensor:
        """Row-normalised edge attention exp(tanh(W [x_r || x_c])) applied
        to x_in: the incoming message of every node."""
        w_att = getattr(self, f"w_att_in_{jj}")
        f = x_in.shape[-1]
        x_in, w_att = promoted(x_in, w_att)
        u = x_in @ w_att[:f, 0]
        v = x_in @ w_att[f:, 0]
        if not use_edge:
            scores = torch.exp(torch.tanh(u[:, :, None] + v[:, None, :]))
            a_hat = masked_row_normalize(scores, getattr(self, f"enc_mask_{jj}"))
            return torch.matmul(*promoted(a_hat, x_in))
        agg = getattr(self, f"agg_{jj}")        # (n, E): edge e's row
        pick = getattr(self, f"pick_{jj}")      # (n, E): edge e's column

        def gather(t, onehot):
            # t[:, idx] as t @ onehot: one term per output, exact; kept in
            # t's type, as the JAX gather keeps it
            return torch.matmul(*promoted(t, onehot)).to(t.dtype)

        scores_e = torch.exp(torch.tanh(gather(u, agg) + gather(v, pick)))
        # fp32 sums, as the JAX einsums' preferred_element_type
        rowsum = torch.matmul(*promoted(scores_e, agg.T))       # (B, n)
        vn = scores_e / torch.matmul(rowsum, agg)               # (B, E)
        x_cols = torch.matmul(*promoted(pick.T, x_in)).to(x_in.dtype)
        msg = vn[..., None] * x_cols                            # (B, E, f)
        return torch.matmul(*promoted(agg, msg))                # (B, n, f)

    def forward(self, snps: torch.Tensor, *,
                sample_weight: torch.Tensor | None = None,
                generator: torch.Generator | None = None
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Forward; train mode follows `self.training`.

        Args:
          snps: (B, S) SNP features (possibly importance-masked).
          sample_weight: (B,) 0/1 padding mask for the batch statistics.
          generator: dropout stream (train mode).
        Returns:
          latent (B, l_dim), x_hat (B, S) reconstructed SNPs,
          atten_out (B, n_top, dim_snps_atten) cross-attention tokens.
        """
        train = self.training
        w = sample_weight if train else None

        def drop(t):
            return (dropout(t, self.dropout_readout, generator) if train
                    else t)

        def drop_nodes(t):
            return node_dropout(t, self.dropout_gcn, generator) if train else t

        # gene encoding: (B, S) -> (B, n, C)
        x = torch.stack([torch.matmul(*promoted(
            snps, (self.gene_mask * getattr(self, f"gene_enc_{c}")).T))
            for c in range(self.in_f_dim)], dim=2)

        use_edge = (self.attention_impl == "edge"
                    or (self.attention_impl == "auto" and snps.shape[0] >= 64))
        for jj in range(self.n_l):
            x_in = getattr(self, f"w_inc_{jj}")(x)
            x_s = getattr(self, f"w_s_loop_{jj}")(x)
            incoming = self._attend(jj, x_in, use_edge)
            v_s = torch.sigmoid(getattr(self, f"w_att_s_{jj}")(x_s))
            out = self._act(getattr(self, f"g_b_{jj}")(incoming + x_s * v_s),
                            f"enc_{jj}")
            out = drop_nodes(out)
            x = out[:, self.pool[jj]:, :]

        # readouts
        atten_out = self._act(self.bn_atten(self.conc_for_attention(x), w),
                              "atten")
        inp = drop(self._act(self.bn_b(self.conc(x)[..., 0], w), "b"))
        h = drop(self._act(self.bn_latent1(self.latent1(inp), w), "latent1"))
        latent = self.latent2(h)
        if self.activation == "relu":
            latent = torch.relu(self.bn_latent2(latent, w))

        # decoder: uniform un-pooling back to the full node set
        for jj in range(self.n_l):
            x_out = getattr(self, f"w_out_{jj}")(x)
            x_s_out = getattr(self, f"w_s_loop_out_{jj}")(x)
            grow = self.pool[self.n_l - jj - 1]
            x_self = nn.functional.pad(x_s_out, (0, 0, grow, 0))
            out_dec = torch.matmul(*promoted(getattr(self, f"dec_attn_{jj}"),
                                             x_out)) + x_self
            x = drop_nodes(self._act(getattr(self, f"g_b_d_{jj}")(out_dec),
                                     f"dec_{jj}"))

        out_d = drop(self._act(self.bn_b_d(self.conc_d(x)[..., 0], w), "b_d"))
        # gene decoding: (B, n) -> (B, S)
        x_hat = torch.matmul(*promoted(out_d, self.gene_mask * self.gene_dec))
        return latent, x_hat, atten_out

    def classify(self, latent: torch.Tensor, snps: torch.Tensor, *,
                 sample_weight: torch.Tensor | None = None,
                 generator: torch.Generator | None = None) -> torch.Tensor:
        """(B, 1) probability of the SNP classifier head: batch norm over
        [latent || snps] (its statistics over the rows `sample_weight`
        marks), relu, dropout, `cls1`, relu, dropout, `cls2`, sigmoid.
        Train mode follows `self.training` (dropout from `generator`)."""
        if not self.classifier:
            raise ValueError("this GeneOntologyNetwork has no classifier "
                             "head: build it with classifier=True")
        train = self.training
        h = torch.cat([latent, snps], dim=-1)
        h = torch.relu(self.bn_cls(h, sample_weight if train else None))
        if train:
            h = dropout(h, self.dropout_cls[0], generator)
        h = torch.relu(self.cls1(h))
        if train:
            h = dropout(h, self.dropout_cls[1], generator)
        return torch.sigmoid(self.cls2(h))
