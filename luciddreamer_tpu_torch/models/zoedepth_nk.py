"""ZoeDepth-NK: two metric heads (indoor and outdoor bin configurations)
routed by a patch-transformer classifier on the DPT bottleneck, in PyTorch
(the twin of ``luciddreamer_tpu/models/zoedepth_nk.py``).

Module names follow the reference checkpoint (``patch_transformer.
transformer_encoder.layers.{i}.self_attn.in_proj_*``, ``mlp_classifier``,
``seed_bin_regressors.{name}``, ``attractors.{name}.{i}``,
``conditional_log_binomial.{name}``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from luciddreamer_tpu_torch.models.backbone import LN_EPS, _resize
from luciddreamer_tpu_torch.models.zoedepth import (
    AttractorLayerUnnormed,
    ConditionalLogBinomial,
    MidasCore,
    Projector,
    SeedBinRegressorUnnormed,
    ZoeDepthConfig,
)


@dataclasses.dataclass(frozen=True)
class BinConf:
    name: str
    n_bins: int
    min_depth: float
    max_depth: float


# config_zoedepth_nk.json bin_conf
NK_BIN_CONFS = (
    BinConf("nyu", 64, 1e-3, 10.0),
    BinConf("kitti", 64, 1e-3, 80.0),
)


class _SelfAttention(nn.Module):
    """The parameters of torch's ``nn.MultiheadAttention`` (packed
    [q; k; v] in_proj, out_proj), applied as matmul, softmax, matmul."""

    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.in_proj_weight = nn.Parameter(torch.zeros(3 * dim, dim))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * dim))
        self.out_proj = nn.Linear(dim, dim)

    def forward(self, x):                                    # (B, S, E)
        B, S, E = x.shape
        hd = E // self.num_heads
        q, k, v = F.linear(x, self.in_proj_weight, self.in_proj_bias).reshape(
            B, S, 3, self.num_heads, hd).permute(2, 0, 3, 1, 4)
        attn = torch.softmax((q @ k.transpose(-2, -1)) / math.sqrt(hd), -1)
        return self.out_proj((attn @ v).transpose(1, 2).reshape(B, S, E))


class _EncoderLayer(nn.Module):
    """One ``nn.TransformerEncoderLayer`` in its default post-norm form
    (``x = norm1(x + attn(x)); x = norm2(x + ff(x))``, relu FF).  The norms
    take the JAX package's epsilon, 1e-6 (torch's layer has 1e-5)."""

    def __init__(self, dim: int, num_heads: int, ff_dim: int = 1024):
        super().__init__()
        self.self_attn = _SelfAttention(dim, num_heads)
        self.linear1 = nn.Linear(dim, ff_dim)
        self.linear2 = nn.Linear(ff_dim, dim)
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)

    def forward(self, x):
        x = self.norm1(x + self.self_attn(x))
        return self.norm2(x + self.linear2(F.relu(self.linear1(x))))


class _Encoder(nn.Module):
    def __init__(self, dim: int, num_heads: int, num_layers: int):
        super().__init__()
        self.layers = nn.ModuleList(
            _EncoderLayer(dim, num_heads) for _ in range(num_layers))

    def forward(self, x):
        for layer in self.layers:
            x = layer(x)
        return x


class PatchTransformerEncoder(nn.Module):
    """PxP conv embedding, a zero class token (padding, not a parameter),
    sinusoidal positions, 4 post-norm encoder layers; returns the class
    token's embedding (B, E)."""

    def __init__(self, in_channels: int, embedding_dim: int = 128,
                 patch_size: int = 1, num_heads: int = 4, num_layers: int = 4):
        super().__init__()
        self.embedding_convPxP = nn.Conv2d(in_channels, embedding_dim,
                                           patch_size, stride=patch_size)
        self.transformer_encoder = _Encoder(embedding_dim, num_heads,
                                            num_layers)

    def forward(self, x):
        tokens = self.embedding_convPxP(x).flatten(2).transpose(1, 2)
        tokens = F.pad(tokens, (0, 0, 1, 0))               # zero cls token
        S, E = tokens.shape[1:]
        pos = torch.arange(S, dtype=torch.float32, device=x.device)[:, None]
        idx = torch.arange(0, E, 2, dtype=torch.float32, device=x.device)
        div = torch.exp(idx * (-math.log(10000.0) / E))[None]
        pe = torch.cat([torch.sin(pos * div), torch.cos(pos * div)], 1)
        return self.transformer_encoder(tokens + pe[None, :, :E])[:, 0]


class ZoeDepthNK(nn.Module):
    """Two-domain metric head; the router picks the bin configuration per
    image.  Mirrors ``FlaxZoeDepthNK``."""

    def __init__(self, cfg: ZoeDepthConfig,
                 bin_confs: Sequence[BinConf] = NK_BIN_CONFS):
        super().__init__()
        self.cfg = c = cfg
        self.names = tuple(b.name for b in bin_confs)
        f, bed = c.midas_features, c.bin_embedding_dim
        self.core = MidasCore(c)
        self.conv2 = nn.Conv2d(f, f, 1)
        self.patch_transformer = PatchTransformerEncoder(f)
        self.mlp_classifier = nn.Sequential(
            nn.Linear(128, 128), nn.ReLU(), nn.Linear(128, len(bin_confs)))
        self.seed_projector = Projector(f, bed, mlp_dim=bed // 2)
        # the projector stack is shared between the domains
        self.projectors = nn.ModuleList(
            Projector(f, bed, mlp_dim=bed // 2) for _ in c.n_attractors)
        # both reference bin confs have 64 bins, the model's n_bins; NK
        # passes n_attractors[i] into the n_bins slot, so every layer has
        # the default 16 attractor points and mlp_dim = bed
        self.seed_bin_regressors = nn.ModuleDict({
            n: SeedBinRegressorUnnormed(f, c.n_bins, mlp_dim=bed // 2)
            for n in self.names})
        self.attractors = nn.ModuleDict({
            n: nn.ModuleList(
                AttractorLayerUnnormed(bed, 16, c.attractor_kind,
                                       c.attractor_type, mlp_dim=bed)
                for _ in c.n_attractors)
            for n in self.names})
        # NK feeds out_conv alone (32 channels) to the CLB, no rel depth
        self.conditional_log_binomial = nn.ModuleDict({
            n: ConditionalLogBinomial(32, bed, c.n_bins, c.min_temp,
                                      c.max_temp, bottleneck_factor=4)
            for n in self.names})

    def forward(self, x):
        rel_depth, hooks = self.core((x - 0.5) / 0.5)
        out_conv, btlnck, r4, r3, r2, r1 = hooks
        xb = self.conv2(btlnck)
        logits = self.mlp_classifier(self.patch_transformer(xb))
        domain_probs = torch.softmax(logits, dim=-1)          # (B, domains)
        seed_emb = self.seed_projector(xb)
        embs = [proj(blk) for proj, blk in zip(self.projectors,
                                                (r4, r3, r2, r1))]
        depths = []
        for name in self.names:
            _, b_prev = self.seed_bin_regressors[name](xb)
            b_centers = b_prev
            emb_prev = seed_emb
            for attractor, emb in zip(self.attractors[name], embs):
                b_prev, b_centers = attractor(emb, b_prev, emb_prev)
                emb_prev = emb
            h, w = out_conv.shape[2:]
            probs = self.conditional_log_binomial[name](
                out_conv, _resize(emb_prev, h, w))
            centers = _resize(b_centers, *probs.shape[2:])
            d = torch.sum(probs * centers, dim=1, keepdim=True)
            depths.append(_resize(d, *x.shape[2:])[:, 0])
        stacked = torch.stack(depths, dim=-1)                 # (B, H, W, 2)
        pick = torch.argmax(domain_probs, dim=-1)
        depth = torch.take_along_dim(stacked, pick[:, None, None, None],
                                     dim=-1)[..., 0]
        return {
            "metric_depth": depth,
            "rel_depth": rel_depth,
            "domain_logits": logits,
            "per_domain_depth": stacked,
        }
