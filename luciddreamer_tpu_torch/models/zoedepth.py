"""ZoeDepth metric-bins head and its inference pipeline, in PyTorch (the
twin of ``luciddreamer_tpu/models/zoedepth.py``).

A seed bin regressor on the DPT bottleneck, attractor layers that refine
the bin centres across the decoder's scales, and a conditional
log-binomial distribution per pixel; depth = sum p * c.  The default
config is ZoeD_N's: 64 bins, softplus (unnormed) bin centres, inverse
attractors, kind mean, n_attractors (16, 8, 4, 1), bin embedding 128.

``ZoeDepthEstimator`` adds the reference's test-time augmentation:
reflect padding of sqrt(h/2)*3 pixels, a resize to the model's input size,
the average with the horizontally flipped input, and a bicubic resize
back.  Module names follow the reference checkpoints (``core.core.*``,
``seed_bin_regressor._net.*``, ``attractors.{i}._net.*``,
``conditional_log_binomial.mlp.*``).
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from luciddreamer_tpu_torch.device import resolve_device
from luciddreamer_tpu_torch.models.backbone import (
    BEIT_LARGE_384,
    DPT,
    VIT_TINY_TEST,
    ViTConfig,
    _resize,
)


@dataclasses.dataclass(frozen=True)
class ZoeDepthConfig:
    vit: ViTConfig = BEIT_LARGE_384
    n_bins: int = 64
    bin_embedding_dim: int = 128
    n_attractors: Sequence[int] = (16, 8, 4, 1)
    attractor_alpha: float = 1000.0
    attractor_gamma: float = 2.0
    attractor_kind: str = "mean"          # 'mean' | 'sum'
    attractor_type: str = "inv"           # 'inv' | 'exp'
    bin_centers_type: str = "softplus"    # 'softplus' | 'normed'
    min_depth: float = 1e-3
    max_depth: float = 10.0
    min_temp: float = 0.0212
    max_temp: float = 50.0
    midas_features: int = 256
    out_channels: Sequence[int] = (256, 512, 1024, 1024)
    img_size: tuple[int, int] = (384, 512)

    @staticmethod
    def tiny():
        return ZoeDepthConfig(vit=VIT_TINY_TEST, n_bins=8,
                              bin_embedding_dim=16, n_attractors=(4, 2, 2, 1),
                              midas_features=32,
                              out_channels=(16, 32, 64, 64),
                              img_size=(64, 64))

    @staticmethod
    def kitti():
        """ZoeD_K: normed (bounded) bin centres on (1e-3, 80), 384x768."""
        return ZoeDepthConfig(bin_centers_type="normed", max_depth=80.0,
                              img_size=(384, 768))

    @staticmethod
    def kitti_tiny():
        return dataclasses.replace(
            ZoeDepthConfig.tiny(), bin_centers_type="normed", max_depth=80.0
        )


def inv_attractor(dx, alpha=300.0, gamma=2.0):
    """dc = dx / (1 + alpha dx^gamma).  The reference's attractor layers
    call it without alpha and gamma, so these defaults, not the configured
    attractor_alpha, are what every shipped checkpoint ran with."""
    return dx / (1.0 + alpha * dx**gamma)


def exp_attractor(dx, alpha=300.0, gamma=2.0):
    """dc = exp(-alpha |dx|^gamma) dx (same defaults as inv_attractor)."""
    return torch.exp(-alpha * torch.abs(dx) ** gamma) * dx


def _mlp(cin, hidden, cout, last=None):
    layers = [nn.Conv2d(cin, hidden, 1), nn.ReLU(), nn.Conv2d(hidden, cout, 1)]
    return nn.Sequential(*layers, *([last] if last is not None else []))


class SeedBinRegressorUnnormed(nn.Module):
    """Softplus bin centres, unbounded (the 'softplus' bin_centers_type)."""

    def __init__(self, cin: int, n_bins: int, mlp_dim: int = 256):
        super().__init__()
        self._net = _mlp(cin, mlp_dim, n_bins, nn.Softplus())

    def forward(self, x):
        centers = self._net(x)
        return centers, centers


class SeedBinRegressor(nn.Module):
    """Normed bin centres (ZoeD_K): eps-shifted relu widths normalised to
    sum 1, scaled to (max - min), min_depth-padded cumsum edges, midpoint
    centres."""

    def __init__(self, cin: int, n_bins: int, min_depth: float,
                 max_depth: float, mlp_dim: int = 256):
        super().__init__()
        self.min_depth, self.max_depth = min_depth, max_depth
        self._net = _mlp(cin, mlp_dim, n_bins, nn.ReLU())

    def forward(self, x):
        y = self._net(x) + 1e-3
        widths_normed = y / torch.sum(y, dim=1, keepdim=True)
        widths = (self.max_depth - self.min_depth) * widths_normed
        widths = F.pad(widths, (0, 0, 0, 0, 1, 0), value=self.min_depth)
        edges = torch.cumsum(widths, dim=1)
        centers = 0.5 * (edges[:, :-1] + edges[:, 1:])
        return widths_normed, centers


class Projector(nn.Module):
    def __init__(self, cin: int, out_dim: int, mlp_dim: int = 128):
        super().__init__()
        self._net = _mlp(cin, mlp_dim, out_dim)

    def forward(self, x):
        return self._net(x)


def _attract(points, b_centers, attractor_type, kind):
    """Pull the (B, n_bins, h, w) centres toward the (B, A, h, w) points."""
    dist = inv_attractor if attractor_type == "inv" else exp_attractor
    dx = points[:, :, None] - b_centers[:, None]         # (B, A, nbins, h, w)
    delta = torch.sum(dist(dx), dim=1)
    if kind == "mean":
        delta = delta / points.shape[1]
    return b_centers + delta


class AttractorLayerUnnormed(nn.Module):
    """Softplus attractor points pull the unbounded bin centres."""

    def __init__(self, in_features: int, n_attractors: int, kind: str,
                 attractor_type: str, mlp_dim: int = 128):
        super().__init__()
        self.kind, self.attractor_type = kind, attractor_type
        self._net = _mlp(in_features, mlp_dim, n_attractors, nn.Softplus())

    def forward(self, x, b_prev, prev_b_embedding=None):
        h, w = x.shape[2:]
        if prev_b_embedding is not None:
            x = x + _resize(prev_b_embedding, h, w)
        a = self._net(x)
        b_new = _attract(a, _resize(b_prev, h, w), self.attractor_type,
                         self.kind)
        return b_new, b_new


class AttractorLayer(nn.Module):
    """The 'normed' variant: attractor points in normalised bin space;
    scaled centres sorted and clipped to (min_depth, max_depth).  The conv
    emits 2 * n_attractors channels and only the even ones are used, as in
    the shipped reference (its normalisation of the pairs is overwritten)."""

    def __init__(self, in_features: int, n_attractors: int, kind: str,
                 attractor_type: str, min_depth: float, max_depth: float,
                 mlp_dim: int = 128):
        super().__init__()
        self.kind, self.attractor_type = kind, attractor_type
        self.min_depth, self.max_depth = min_depth, max_depth
        self._net = _mlp(in_features, mlp_dim, 2 * n_attractors, nn.ReLU())

    def forward(self, x, b_prev, prev_b_embedding=None):
        h, w = x.shape[2:]
        if prev_b_embedding is not None:
            x = x + _resize(prev_b_embedding, h, w)
        a = self._net(x) + 1e-3
        n, c2 = a.shape[:2]
        points = a.view(n, c2 // 2, 2, h, w)[:, :, 0]
        b_new = _attract(points, _resize(b_prev, h, w), self.attractor_type,
                         self.kind)
        scaled = (self.max_depth - self.min_depth) * b_new + self.min_depth
        scaled = torch.sort(scaled, dim=1).values
        return b_new, torch.clip(scaled, self.min_depth, self.max_depth)


def log_binom_coef(n_classes: int) -> np.ndarray:
    """log C(K-1, k) by Stirling's form, in float32 in the reference's
    order of operations.  Evaluated on the host: reassociating
    (n + eps) - (k + eps) to n - k gives log(0) at k = K-1, and the whole
    distribution becomes NaN."""
    eps = np.float32(1e-7)
    n = np.float32(n_classes - 1) + eps
    kk = np.arange(n_classes).astype(np.float32) + eps
    return (n * np.log(n) - kk * np.log(kk)
            - (n - kk) * np.log(n - kk + eps)).astype(np.float32)


class ConditionalLogBinomial(nn.Module):
    """Per-pixel (p, t) from features -> a log-binomial distribution over
    n_classes bins, (B, K, h, w)."""

    def __init__(self, in_features: int, condition_dim: int, n_classes: int,
                 min_temp: float, max_temp: float, bottleneck_factor: int = 2,
                 p_eps: float = 1e-4):
        super().__init__()
        self.min_temp, self.max_temp, self.p_eps = min_temp, max_temp, p_eps
        bott = (in_features + condition_dim) // bottleneck_factor
        self.mlp = nn.Sequential(
            nn.Conv2d(in_features + condition_dim, bott, 1), nn.GELU(),
            nn.Conv2d(bott, 4, 1), nn.Softplus())
        K = n_classes
        self.register_buffer("log_coef", torch.from_numpy(
            log_binom_coef(K)).view(1, K, 1, 1), persistent=False)
        self.register_buffer("k", torch.arange(K, dtype=torch.float32).view(
            1, K, 1, 1), persistent=False)

    def forward(self, x, cond):
        y = self.mlp(torch.cat([x, cond], 1))
        p2, t2 = y[:, :2] + self.p_eps, y[:, 2:] + self.p_eps
        p = p2[:, 0] / (p2[:, 0] + p2[:, 1])
        t = t2[:, 0] / (t2[:, 0] + t2[:, 1])
        t = (self.max_temp - self.min_temp) * t + self.min_temp
        K = self.k.shape[1]
        one_minus_p = torch.clip(1.0 - p, 1e-4, 1.0)[:, None]
        p = torch.clip(p, 1e-4, 1.0)[:, None]
        logits = (self.log_coef + self.k * torch.log(p)
                  + (K - 1 - self.k) * torch.log(one_minus_p))
        return torch.softmax(logits / t[:, None], dim=1)


class MidasCore(nn.Module):
    """Holds the DPT under the reference's ``core.core`` prefix."""

    def __init__(self, cfg: ZoeDepthConfig):
        super().__init__()
        self.core = DPT(cfg.vit, cfg.img_size, features=cfg.midas_features,
                        out_channels=tuple(cfg.out_channels))

    def forward(self, x):
        return self.core(x)


class ZoeDepth(nn.Module):
    """DPT core + metric bins head; mirrors ``FlaxZoeDepth``.  Built for
    inputs of ``cfg.img_size``."""

    def __init__(self, cfg: ZoeDepthConfig):
        super().__init__()
        self.cfg = c = cfg
        f, bed = c.midas_features, c.bin_embedding_dim
        self.normed = c.bin_centers_type == "normed"
        self.core = MidasCore(c)
        self.conv2 = nn.Conv2d(f, f, 1)
        if self.normed:
            self.seed_bin_regressor = SeedBinRegressor(
                f, c.n_bins, c.min_depth, c.max_depth)
            self.attractors = nn.ModuleList(
                AttractorLayer(bed, n, c.attractor_kind, c.attractor_type,
                               c.min_depth, c.max_depth)
                for n in c.n_attractors)
        else:
            self.seed_bin_regressor = SeedBinRegressorUnnormed(f, c.n_bins)
            self.attractors = nn.ModuleList(
                AttractorLayerUnnormed(bed, n, c.attractor_kind,
                                       c.attractor_type)
                for n in c.n_attractors)
        self.seed_projector = Projector(f, bed)
        self.projectors = nn.ModuleList(
            Projector(f, bed) for _ in c.n_attractors)
        self.conditional_log_binomial = ConditionalLogBinomial(
            33, bed, c.n_bins, c.min_temp, c.max_temp)

    def forward(self, x):
        """x: (B, 3, H, W) in [0, 1].  Returns metric_depth (B, H, W),
        rel_depth (B, H, W) and bin_centers (B, n_bins, H', W')."""
        c = self.cfg
        rel_depth, hooks = self.core((x - 0.5) / 0.5)
        out_conv, btlnck, r4, r3, r2, r1 = hooks
        xb = self.conv2(btlnck)
        _, seed_centers = self.seed_bin_regressor(xb)
        b_prev = seed_centers
        if self.normed:
            b_prev = (seed_centers - c.min_depth) / (c.max_depth - c.min_depth)
        prev_emb = self.seed_projector(xb)
        for proj, attractor, blk in zip(self.projectors, self.attractors,
                                        (r4, r3, r2, r1)):
            emb = proj(blk)
            b_prev, b_centers = attractor(emb, b_prev, prev_emb)
            prev_emb = emb

        h, w = out_conv.shape[2:]
        last = torch.cat([out_conv, _resize(rel_depth[:, None], h, w)], 1)
        probs = self.conditional_log_binomial(last, _resize(prev_emb, h, w))
        # the reference does not clip the bin centres here
        centers_up = _resize(b_centers, *probs.shape[2:])
        depth = torch.sum(probs * centers_up, dim=1, keepdim=True)
        depth = _resize(depth, *x.shape[2:])[:, 0]
        return {"metric_depth": depth, "rel_depth": rel_depth,
                "bin_centers": centers_up}


def init_random_(model: nn.Module, seed: int = 0) -> nn.Module:
    """Fill every parameter from a ``torch.Generator`` seeded with ``seed``
    on the parameter's device, as flax's default initialisers do: dense and
    conv weights lecun-normal (std 1/sqrt(fan_in)), norm scales and layer
    scales one, everything else (biases, cls token, rel-pos tables) zero.
    Random weights make no depth model: only tests and smoke runs use
    them."""
    gens = {}
    with torch.no_grad():
        for mod in model.modules():
            for name, p in mod.named_parameters(recurse=False):
                dev = p.device
                if dev not in gens:
                    gens[dev] = torch.Generator(device=dev).manual_seed(seed)
                if name in ("weight", "in_proj_weight") and p.dim() >= 2:
                    fan_in = (p.shape[0] if isinstance(mod, nn.ConvTranspose2d)
                              else p.shape[1]) * p[0, 0].numel()
                    p.copy_(torch.randn(p.shape, generator=gens[dev],
                                        device=dev) / float(np.sqrt(fan_in)))
                elif (isinstance(mod, nn.LayerNorm) and name == "weight") \
                        or name.startswith("gamma_"):
                    p.fill_(1.0)
                else:
                    p.zero_()
    return model


class ZoeDepthEstimator:
    """The ``DepthEstimator`` protocol over a ZoeDepth model, with the
    reference's test-time augmentation; mirrors ``FlaxZoeDepthEstimator``.
    Random weights from ``seed`` (``init_random_``) unless ``state_dict``
    is given.  Runs on ``device`` (default: the CUDA device) and takes
    images on that device only."""

    def __init__(self, cfg: ZoeDepthConfig | None = None, state_dict=None,
                 seed: int = 0, model_cls=None, device=None):
        self.cfg = cfg or ZoeDepthConfig.tiny()
        self.model = (model_cls or ZoeDepth)(self.cfg).to(
            resolve_device(device)).eval()
        self.device = next(self.model.parameters()).device    # with its index
        if state_dict is None:
            init_random_(self.model, seed)
        else:
            self.model.load_state_dict(state_dict)

    def _infer_once(self, x):
        return self.model(x)["metric_depth"]

    @torch.no_grad()
    def infer(self, x):
        """(B, H, W, 3) -> (B, H, W) with pad + flip augmentation."""
        if x.device != self.device:
            raise ValueError(f"the depth model is on {self.device}, its "
                             f"input on {x.device}")
        B, H, W, _ = x.shape
        ph, pw = int(np.sqrt(H / 2) * 3), int(np.sqrt(W / 2) * 3)
        xp = F.pad(x.permute(0, 3, 1, 2), (pw, pw, ph, ph), mode="reflect")
        # jax.image.resize antialiases when it shrinks, with a Keys a=-0.5
        # cubic: torch's antialiased modes are that filter
        xr = F.interpolate(xp, size=tuple(self.cfg.img_size), mode="bilinear",
                           align_corners=False, antialias=True)
        d = 0.5 * (self._infer_once(xr) + self._infer_once(xr.flip(-1)).flip(-1))
        d = F.interpolate(d[:, None], size=xp.shape[2:], mode="bicubic",
                          align_corners=False, antialias=True)[:, 0]
        return d[:, ph : d.shape[1] - ph, pw : d.shape[2] - pw]

    def __call__(self, image):
        """DepthEstimator protocol: (H, W, 3) in [0, 1] -> (H, W)."""
        return self.infer(torch.as_tensor(image, dtype=torch.float32)[None])[0]
