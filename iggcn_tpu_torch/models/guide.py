"""Guided autoencoder fusion model, GUIDE_IMGSNP (port of
`iggcn_tpu/models/guide.py`).

The imaging branch is an MLP autoencoder over the flattened (rois * F0)
features behind a learned Bernoulli keep mask, drawn in train mode by a
straight-through Gumbel-softmax (hard) at the run's temperature; the GO
branch is the PReLU variant of `GeneOntologyNetwork`; the fusion is the
mean of the two latents. The outputs carry the reconstruction pair and the
keep probabilities that the GUIDE objective's KL sparsity term reads.

The Gumbel noise is drawn from the caller's explicit generator.
`gumbel_zero=True` replaces it with zeros: the deterministic mode in which
the tests hold the port against the JAX package (the two packages' random
streams cannot be aligned, as with dropout). Training draws the noise.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn

from iggcn_tpu_torch.config import ModelConfig
from iggcn_tpu_torch.data.go_graph import GoTopology
from iggcn_tpu_torch.models.go_network import GeneOntologyNetwork, PReLU
from iggcn_tpu_torch.models.nn_compat import (BatchNorm1d, NoiseSource,
                                              TorchLinear, dropout, uniform,
                                              uniform_noise)


class GuideOutputs(NamedTuple):
    log_probs: torch.Tensor
    snps_hat: torch.Tensor
    out_z: torch.Tensor
    out_lin: torch.Tensor
    linear_outf: torch.Tensor
    our_reg: torch.Tensor
    surrogate_img: torch.Tensor     # flattened imaging input (recon target)
    surrogate_recon: torch.Tensor   # decoder(latent)
    imp_prob: torch.Tensor          # (rois * F0,) keep probabilities


def gumbel_noise(shape, generator: torch.Generator | NoiseSource | None,
                 device: torch.device) -> torch.Tensor:
    """Standard Gumbel samples -log(-log U), U ~ U(0, 1), from an explicit
    generator on `device` (or the next draw of a `NoiseSource`)."""
    if generator is None:
        raise ValueError("train-mode Gumbel noise draws from an explicit "
                         "torch.Generator: pass generator= (on the inputs' "
                         "device), or set gumbel_zero")
    u = uniform_noise(shape, generator, device)
    tiny = torch.finfo(u.dtype).tiny
    return -torch.log(-torch.log(u.clamp(min=tiny)))


class GuideImgSnp(nn.Module):
    """Dropout rates come from `cfg.dropout_go/lin/regr`; `hidden_linear`
    is the family's own width (32), not `cfg.hidden_linear`."""

    def __init__(self, cfg: ModelConfig, topo: GoTopology, *,
                 hidden_linear: int = 32, gumbel_zero: bool = False,
                 generator=None, device=None):
        super().__init__()
        g, dev = generator, device
        self.cfg = cfg
        self.topo = topo
        self.gumbel_zero = gumbel_zero
        d = cfg.rois * cfg.feat_dim
        hl = hidden_linear

        def linear(fin, fout, bias=True):
            return TorchLinear(fin, fout, bias=bias, generator=g, device=dev)

        self.enc1 = linear(d, hl, bias=False)
        self.enc_act = PReLU(device=dev)
        # the image latent is averaged with the GO latent: both l_dim wide
        self.enc2 = linear(hl, cfg.l_dim, bias=False)
        self.dec_bn1 = BatchNorm1d(cfg.l_dim, device=dev)
        self.dec_act1 = PReLU(device=dev)
        self.dec1 = linear(cfg.l_dim, hl, bias=False)
        self.dec_bn2 = BatchNorm1d(hl, device=dev)
        self.dec_act2 = PReLU(device=dev)
        self.dec2 = linear(hl, d, bias=False)
        # Bernoulli logits over the features, U(-0.1, 0.1)
        self.bias_n = nn.Parameter(uniform((d, 2), 0.1, g, dev))
        self.go_network = GeneOntologyNetwork(
            topo, in_f_dim=2, n_l=cfg.go_n_l, f_dim=cfg.go_f_dim,
            l_dim=cfg.l_dim, dim_snps_atten=cfg.hidden,
            attention_impl=cfg.go_attention_impl, dropout_gcn=cfg.dropout_go,
            dropout_readout=cfg.dropout_readout, activation="prelu",
            generator=g, device=dev)
        self.lin1 = linear(cfg.l_dim, hl)
        self.lin2 = linear(hl, cfg.num_classes)
        self.lin1_regr = linear(cfg.l_dim, hl)
        self.lin2_regr = linear(hl, cfg.num_regr)

    def forward(self, x: torch.Tensor, adj: torch.Tensor, snps: torch.Tensor,
                *, temperature: float = 0.1,
                sample_weight: torch.Tensor | None = None,
                generator: torch.Generator | None = None) -> GuideOutputs:
        """Forward of one dense batch (`adj` is unused, as in the
        reference); train mode follows `self.training`: Gumbel mask and
        dropout from `generator`, batch statistics over the real rows."""
        del adj
        cfg = self.cfg
        train = self.training
        b = x.shape[0]
        img_out = x.reshape(b, -1)
        imp = torch.softmax(self.bias_n, dim=1)          # (d, 2)
        if train:
            shape = (b,) + tuple(self.bias_n.shape)
            noise = (torch.zeros(shape, device=x.device) if self.gumbel_zero
                     else gumbel_noise(shape, generator, x.device))
            logits = (torch.log(imp)[None] + noise) / temperature
            soft = torch.softmax(logits, dim=-1)
            hard = nn.functional.one_hot(logits.argmax(dim=-1), 2).to(
                soft.dtype)
            z = hard + soft - soft.detach()
            x_in = img_out * z[:, :, 1]
        else:
            x_in = img_out

        def drop(t, rate):
            return dropout(t, rate, generator) if train else t

        latent_g, snps_hat, _ = self.go_network(
            snps, sample_weight=sample_weight, generator=generator)
        h = drop(self.enc_act(self.enc1(x_in)), cfg.dropout_go)
        latent = (latent_g + self.enc2(h)) / 2

        w = sample_weight if train else None
        r = drop(self.dec_act1(self.dec_bn1(latent, w)), cfg.dropout_go)
        r = drop(self.dec_act2(self.dec_bn2(self.dec1(r), w)), cfg.dropout_go)
        recon = self.dec2(r)

        linear_outf = torch.relu(self.lin1(latent))
        logits = self.lin2(drop(linear_outf, cfg.dropout_lin))
        reg = self.lin2_regr(drop(torch.relu(self.lin1_regr(latent)),
                                  cfg.dropout_regr))
        return GuideOutputs(torch.log_softmax(logits, dim=-1), snps_hat,
                            latent, latent, linear_outf, reg, img_out, recon,
                            imp[:, 1])
