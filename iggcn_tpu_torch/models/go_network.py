"""Hierarchical attention GCN encoder/decoder over the GO DAG (port of
`iggcn_tpu/models/go_network.py`, relu variant). In train mode it drops
whole node rows after each encoder and decoder layer and entries of the
readouts, at the JAX package's sites, and its batch norms take the padding
weight of the batch.

The GO topology is static, so its masks, edge lists and the decoder's
uniform un-pooling matrices are built once at construction and held as
non-persistent buffers (they move with `.to(device)` and are not
weights). The encoder's edge attention has two implementations with
identical math:

  * 'dense': masked (B, n, n) row-normalise and a batched matmul;
  * 'edge': (B, E) gathered scores, row sums and messages aggregated with
    `index_add_` over the static edge list; no (B, n, n) tensor exists.

'auto' takes 'edge' at batch >= 64, as the JAX package does. The
standalone `classify` head and the `prelu` variant (the Guide family)
come with the slices that serve those families.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch
from torch import nn

from iggcn_tpu_torch.data.go_graph import GoTopology
from iggcn_tpu_torch.models.nn_compat import (BatchNorm1d, NodeLayerNorm,
                                              TorchLinear, dropout, normal,
                                              node_dropout, torch_linear_init)
from iggcn_tpu_torch.ops.attention import masked_row_normalize

ATTENTION_IMPLS = ("auto", "dense", "edge")


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
    """

    def __init__(self, topo: GoTopology, *, in_f_dim: int = 2, n_l: int = 2,
                 f_dim: Sequence[int] = (5, 5), l_dim: int = 32,
                 dim_snps_atten: int = 5, attention_impl: str = "auto",
                 dropout_gcn: float = 0.4, dropout_readout: float = 0.5,
                 generator=None, device=None):
        super().__init__()
        if attention_impl not in ATTENTION_IMPLS:
            raise ValueError(f"attention_impl must be one of {ATTENTION_IMPLS}; "
                             f"got {attention_impl!r}")
        self.attention_impl = attention_impl
        self.dropout_gcn = dropout_gcn
        self.dropout_readout = dropout_readout
        self.n_l = n_l
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
            self.register_buffer(f"enc_rows_{i}", torch.as_tensor(r, device=dev),
                                 persistent=False)
            self.register_buffer(f"enc_cols_{i}", torch.as_tensor(c, device=dev),
                                 persistent=False)
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
        self.bn_latent2 = BatchNorm1d(l_dim, device=dev)

    def _attend(self, jj: int, x_in: torch.Tensor, use_edge: bool
                ) -> torch.Tensor:
        """Row-normalised edge attention exp(tanh(W [x_r || x_c])) applied
        to x_in: the incoming message of every node."""
        w_att = getattr(self, f"w_att_in_{jj}")
        f = x_in.shape[-1]
        u = x_in @ w_att[:f, 0]
        v = x_in @ w_att[f:, 0]
        if not use_edge:
            scores = torch.exp(torch.tanh(u[:, :, None] + v[:, None, :]))
            a_hat = masked_row_normalize(scores, getattr(self, f"enc_mask_{jj}"))
            return a_hat @ x_in
        rows = getattr(self, f"enc_rows_{jj}")
        cols = getattr(self, f"enc_cols_{jj}")
        scores_e = torch.exp(torch.tanh(u[:, rows] + v[:, cols]))  # (B, E)
        rowsum = torch.zeros_like(u).index_add_(1, rows, scores_e)
        msg = (scores_e / rowsum[:, rows])[..., None] * x_in[:, cols, :]
        return torch.zeros_like(x_in).index_add_(1, rows, msg)

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
        x = torch.stack([snps @ (self.gene_mask * getattr(self, f"gene_enc_{c}")).T
                         for c in range(self.in_f_dim)], dim=2)

        use_edge = (self.attention_impl == "edge"
                    or (self.attention_impl == "auto" and snps.shape[0] >= 64))
        for jj in range(self.n_l):
            x_in = getattr(self, f"w_inc_{jj}")(x)
            x_s = getattr(self, f"w_s_loop_{jj}")(x)
            incoming = self._attend(jj, x_in, use_edge)
            v_s = torch.sigmoid(getattr(self, f"w_att_s_{jj}")(x_s))
            out = torch.relu(getattr(self, f"g_b_{jj}")(incoming + x_s * v_s))
            out = drop_nodes(out)
            x = out[:, self.pool[jj]:, :]

        # readouts
        atten_out = torch.relu(self.bn_atten(self.conc_for_attention(x), w))
        inp = drop(torch.relu(self.bn_b(self.conc(x)[..., 0], w)))
        h = drop(torch.relu(self.bn_latent1(self.latent1(inp), w)))
        latent = torch.relu(self.bn_latent2(self.latent2(h), w))

        # decoder: uniform un-pooling back to the full node set
        for jj in range(self.n_l):
            x_out = getattr(self, f"w_out_{jj}")(x)
            x_s_out = getattr(self, f"w_s_loop_out_{jj}")(x)
            grow = self.pool[self.n_l - jj - 1]
            x_self = nn.functional.pad(x_s_out, (0, 0, grow, 0))
            out_dec = getattr(self, f"dec_attn_{jj}") @ x_out + x_self
            x = drop_nodes(torch.relu(getattr(self, f"g_b_d_{jj}")(out_dec)))

        out_d = drop(torch.relu(self.bn_b_d(self.conc_d(x)[..., 0], w)))
        # gene decoding: (B, n) -> (B, S)
        x_hat = out_d @ (self.gene_mask * self.gene_dec)
        return latent, x_hat, atten_out
