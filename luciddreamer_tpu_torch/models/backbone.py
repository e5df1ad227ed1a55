"""ViT encoder + DPT decoder (the MiDaS "DPT_BEiT_L_384" core), in PyTorch
(the twin of ``luciddreamer_tpu/models/backbone.py``).

The encoder is a ViT with BEiT-style relative position bias; four
intermediate layers are reassembled into a feature pyramid and DPT fusion
blocks refine it top-down.  ``DPT`` returns the relative depth map and the
six hooked tensors (out_conv, l4_rn, r4, r3, r2, r1) the ZoeDepth head
reads.

NCHW layout.  Module and parameter names are those of the reference
checkpoints (timm BEiT under ``pretrained.model``, MiDaS
``pretrained.act_postprocess{k}`` and ``scratch.*``), so a reference state
dict loads with ``load_state_dict`` once its prefixes are stripped and its
rel-pos tables resized to the run's grid (``models/convert.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    patch_size: int = 16
    embed_dim: int = 1024
    depth: int = 24
    num_heads: int = 16
    mlp_ratio: float = 4.0
    hooks: Sequence[int] = (5, 11, 17, 23)
    use_rel_pos_bias: bool = True       # BEiT-style
    readout: str = "project"            # cls-token handling at reassembly


BEIT_LARGE_384 = ViTConfig()
VIT_TINY_TEST = ViTConfig(
    patch_size=16, embed_dim=64, depth=4, num_heads=2, hooks=(0, 1, 2, 3),
    readout="ignore",
)

LN_EPS = 1e-6           # timm's BEiT (and flax's default), not torch's 1e-5


def rel_pos_index(h: int, w: int) -> np.ndarray:
    """timm BEiT's (h*w + 1, h*w + 1) index into the rel-pos table: patch
    pairs fill the (2h-1)(2w-1) grid; the 3 trailing table rows are
    cls->patch, patch->cls and cls->cls."""
    num_rel = (2 * h - 1) * (2 * w - 1) + 3
    coords = np.stack(np.meshgrid(np.arange(h), np.arange(w),
                                  indexing="ij")).reshape(2, -1)
    rel = coords[:, :, None] - coords[:, None, :]
    idx = (rel[0] + h - 1) * (2 * w - 1) + (rel[1] + w - 1)
    n = h * w
    full = np.zeros((n + 1, n + 1), np.int64)
    full[1:, 1:] = idx
    full[0, :] = num_rel - 3
    full[:, 0] = num_rel - 2
    full[0, 0] = num_rel - 1
    return full


class Attention(nn.Module):
    """BEiT attention: q and v biases (no k bias), and a relative position
    bias over the (h, w) token grid the module is built for.  Written as
    the JAX package writes it: matmul, bias, softmax, matmul."""

    def __init__(self, dim: int, num_heads: int, grid: tuple[int, int],
                 use_rel_pos_bias: bool = True):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = nn.Linear(dim, 3 * dim, bias=False)
        self.q_bias = nn.Parameter(torch.zeros(dim))
        self.v_bias = nn.Parameter(torch.zeros(dim))
        self.proj = nn.Linear(dim, dim)
        self.use_rel_pos_bias = use_rel_pos_bias
        if use_rel_pos_bias:
            h, w = grid
            self.relative_position_bias_table = nn.Parameter(
                torch.zeros((2 * h - 1) * (2 * w - 1) + 3, num_heads))
            self.register_buffer("relative_position_index",
                                 torch.from_numpy(rel_pos_index(h, w)),
                                 persistent=False)

    def forward(self, x):
        B, N, C = x.shape
        hd = C // self.num_heads
        bias = torch.cat([self.q_bias, torch.zeros_like(self.q_bias),
                          self.v_bias])
        qkv = F.linear(x, self.qkv.weight, bias)
        q, k, v = qkv.reshape(B, N, 3, self.num_heads, hd).permute(
            2, 0, 3, 1, 4)                                   # (B, H, N, hd)
        attn = (q @ k.transpose(-2, -1)) / float(np.sqrt(hd))
        if self.use_rel_pos_bias:
            rel = self.relative_position_bias_table[
                self.relative_position_index]                # (N, N, H)
            attn = attn + rel.permute(2, 0, 1)[None]
        attn = torch.softmax(attn, dim=-1)
        out = (attn @ v).transpose(1, 2).reshape(B, N, C)
        return self.proj(out)


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))          # exact-erf GELU


class Block(nn.Module):
    def __init__(self, dim: int, num_heads: int, mlp_ratio: float,
                 grid: tuple[int, int], use_rel_pos_bias: bool = True):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn = Attention(dim, num_heads, grid, use_rel_pos_bias)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))
        self.gamma_1 = nn.Parameter(torch.ones(dim))
        self.gamma_2 = nn.Parameter(torch.ones(dim))

    def forward(self, x):
        x = x + self.gamma_1 * self.attn(self.norm1(x))
        return x + self.gamma_2 * self.mlp(self.norm2(x))


class PatchEmbed(nn.Module):
    def __init__(self, patch_size: int, dim: int):
        super().__init__()
        self.proj = nn.Conv2d(3, dim, patch_size, stride=patch_size)

    def forward(self, x):
        return self.proj(x).flatten(2).transpose(1, 2)      # (B, h*w, C)


class ViT(nn.Module):
    """x: (B, 3, H, W) with (H, W) the size the module was built for.
    Returns the hooked token sequences [(B, 1 + h*w, C)] (cls first) in hook
    order."""

    def __init__(self, cfg: ViTConfig, grid: tuple[int, int]):
        super().__init__()
        self.hooks = tuple(cfg.hooks)
        self.patch_embed = PatchEmbed(cfg.patch_size, cfg.embed_dim)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, cfg.embed_dim))
        self.blocks = nn.ModuleList(
            Block(cfg.embed_dim, cfg.num_heads, cfg.mlp_ratio, grid,
                  cfg.use_rel_pos_bias) for _ in range(cfg.depth))

    def forward(self, x):
        x = self.patch_embed(x)
        x = torch.cat([self.cls_token.expand(x.shape[0], -1, -1), x], 1)
        feats = []
        for i, blk in enumerate(self.blocks):
            x = blk(x)
            if i in self.hooks:
                feats.append(x)
        return feats


class ProjectReadout(nn.Module):
    """MiDaS 'project' readout: each patch token concatenated with the cls
    token, projected 2C -> C, GELU."""

    def __init__(self, dim: int):
        super().__init__()
        self.project = nn.Sequential(nn.Linear(2 * dim, dim), nn.GELU())

    def forward(self, tokens):
        patches = tokens[:, 1:]
        cls = tokens[:, :1].expand_as(patches)
        return self.project(torch.cat([patches, cls], -1))


class ResidualConvUnit(nn.Module):
    def __init__(self, features: int):
        super().__init__()
        self.conv1 = nn.Conv2d(features, features, 3, padding=1)
        self.conv2 = nn.Conv2d(features, features, 3, padding=1)

    def forward(self, x):
        return x + self.conv2(F.relu(self.conv1(F.relu(x))))


def _resize(x, h: int, w: int):
    """Bilinear resize of (B, C, H, W) with align_corners=True, the
    interpolation of every resize inside the reference model graph."""
    if tuple(x.shape[-2:]) == (h, w):
        return x
    return F.interpolate(x, size=(h, w), mode="bilinear", align_corners=True)


class FusionBlock(nn.Module):
    """MiDaS FeatureFusionBlock: (skip RCU +) RCU, 2x upsample, 1x1 conv.
    The top block (``refinenet4``) has no skip and so no ``resConfUnit1``."""

    def __init__(self, features: int, with_skip: bool = True):
        super().__init__()
        if with_skip:
            self.resConfUnit1 = ResidualConvUnit(features)
        self.resConfUnit2 = ResidualConvUnit(features)
        self.out_conv = nn.Conv2d(features, features, 1)

    def forward(self, x, skip=None):
        if skip is not None:
            x = x + self.resConfUnit1(skip)
        x = self.resConfUnit2(x)
        x = _resize(x, x.shape[2] * 2, x.shape[3] * 2)
        return self.out_conv(x)


class DPT(nn.Module):
    """Reassemble hooked ViT features to a pyramid at strides 4, 8, 16 and
    32, fuse top-down and emit the relative depth head.  Built for inputs
    of ``img_size``: the rel-pos tables are sized for its token grid."""

    def __init__(self, cfg: ViTConfig, img_size: tuple[int, int],
                 features: int = 256,
                 out_channels: Sequence[int] = (256, 512, 1024, 1024)):
        super().__init__()
        self.cfg = cfg
        self.grid = (img_size[0] // cfg.patch_size,
                     img_size[1] // cfg.patch_size)
        C = cfg.embed_dim
        self.pretrained = nn.Module()
        self.pretrained.model = ViT(cfg, self.grid)
        # MiDaS act_postprocess{k}: 0 readout, (1 transpose, 2 unflatten:
        # no parameters), 3 1x1 projection, 4 resampling
        for k, ch in enumerate(out_channels):
            ap = nn.ModuleDict()
            if cfg.readout == "project":
                ap["0"] = ProjectReadout(C)
            ap["3"] = nn.Conv2d(C, ch, 1)
            if k == 0:
                ap["4"] = nn.ConvTranspose2d(ch, ch, 4, stride=4)
            elif k == 1:
                ap["4"] = nn.ConvTranspose2d(ch, ch, 2, stride=2)
            elif k == 3:
                ap["4"] = nn.Conv2d(ch, ch, 3, stride=2, padding=1)
            setattr(self.pretrained, f"act_postprocess{k + 1}", ap)
        self.scratch = nn.Module()
        for k, ch in enumerate(out_channels):
            setattr(self.scratch, f"layer{k + 1}_rn",
                    nn.Conv2d(ch, features, 3, padding=1, bias=False))
        for k in range(1, 5):
            setattr(self.scratch, f"refinenet{k}",
                    FusionBlock(features, with_skip=k < 4))
        self.scratch.output_conv = nn.ModuleDict({
            "0": nn.Conv2d(features, features // 2, 3, padding=1),
            "2": nn.Conv2d(features // 2, 32, 3, padding=1),
            "4": nn.Conv2d(32, 1, 1),
        })

    def forward(self, x):
        """x: (B, 3, H, W), normalised.  Returns rel_depth (B, H, W) and
        (out_conv, l4_rn, r4, r3, r2, r1)."""
        B, _, H, W = x.shape
        h, w = self.grid
        if (H, W) != (h * self.cfg.patch_size, w * self.cfg.patch_size):
            raise ValueError(f"DPT built for {self.grid} patches got {H}x{W}")
        feats = self.pretrained.model(x)
        layers = []
        for k, t in enumerate(feats):
            ap = getattr(self.pretrained, f"act_postprocess{k + 1}")
            y = ap["0"](t) if "0" in ap else t[:, 1:]
            y = y.transpose(1, 2).reshape(B, -1, h, w)
            y = ap["3"](y)
            if "4" in ap:
                y = ap["4"](y)
            layers.append(getattr(self.scratch, f"layer{k + 1}_rn")(y))
        l1_rn, l2_rn, l3_rn, l4_rn = layers
        s = self.scratch
        r4 = s.refinenet4(l4_rn)
        r3 = s.refinenet3(r4, l3_rn)
        r2 = s.refinenet2(r3, l2_rn)
        r1 = s.refinenet1(r2, l1_rn)
        y = _resize(s.output_conv["0"](r1), H, W)
        out_conv = F.relu(s.output_conv["2"](y))
        rel_depth = F.relu(s.output_conv["4"](out_conv))[:, 0]
        return rel_depth, (out_conv, l4_rn, r4, r3, r2, r1)
