"""Chunked front-to-back alpha compositing math (the plain PyTorch form).

Per-pixel semantics of the reference blend loop, vectorized over a chunk of
K depth-ordered Gaussians: an exclusive cumulative product of (1 - alpha)
gives the transmittance, and a sticky "done" mask carries the T < 1e-4
early-termination rule.

  - power = -0.5*(A dx^2 + C dy^2) - B dx dy; skip if power > 0
  - alpha = min(0.99, opacity * exp(power)); skip if alpha < 1/255
    (the clamp is straight-through for gradients)
  - if T*(1-alpha) < 1e-4: the triggering Gaussian is itself skipped and
    the pixel is done
  - C += rgb * alpha * T ; D += depth * alpha * T ; acc += alpha * T

Every function takes optional leading batch dimensions, so one call blends
a chunk of every tile at once.
"""
from __future__ import annotations

import dataclasses

import torch

ALPHA_CLAMP = 0.99
ALPHA_MIN = 1.0 / 255.0
T_MIN = 1.0e-4


@dataclasses.dataclass
class BlendCarry:
    """Per-pixel compositing state; every field has shape (..., N_pix),
    ``rgb`` has (..., 3, N_pix)."""

    T: torch.Tensor          # transmittance
    rgb: torch.Tensor        # accumulated color (pre-background)
    depth: torch.Tensor      # accumulated depth * weight
    acc: torch.Tensor        # accumulated weight, seeded at 1e-6
    done: torch.Tensor       # bool, early-termination latch
    n_contrib: torch.Tensor  # int32: 1 + within-tile index of the last
    #                          committed Gaussian (0 if none)

    @classmethod
    def init(cls, batch: tuple, n_pix: int, device=None):
        shape = tuple(batch) + (n_pix,)
        return cls(
            T=torch.ones(shape, device=device),
            rgb=torch.zeros(tuple(batch) + (3, n_pix), device=device),
            depth=torch.zeros(shape, device=device),
            acc=torch.full(shape, 1e-6, device=device),
            done=torch.zeros(shape, dtype=torch.bool, device=device),
            n_contrib=torch.zeros(shape, dtype=torch.int32, device=device),
        )


def straight_through_min(x: torch.Tensor, cap: float) -> torch.Tensor:
    """min(x, cap) with identity gradient."""
    return x + (torch.clamp_max(x, cap) - x).detach()


def gaussian_alpha(dx, dy, conic_a, conic_b, conic_c, opacity):
    """alpha and the power <= 0 mask for a block of Gaussian/pixel pairs."""
    power = -0.5 * (conic_a * dx * dx + conic_c * dy * dy) - conic_b * dx * dy
    in_ellipse = power <= 0.0
    alpha_raw = opacity * torch.exp(torch.clamp_max(power, 0.0))
    alpha = straight_through_min(alpha_raw, ALPHA_CLAMP)
    return alpha, in_ellipse


def exclusive_cumprod(x: torch.Tensor, dim: int = -2) -> torch.Tensor:
    prod = torch.cumprod(x, dim=dim)
    one = torch.ones_like(prod.narrow(dim, 0, 1))
    return torch.cat([one, prod.narrow(dim, 0, x.shape[dim] - 1)], dim=dim)


def blend_chunk(
    carry: BlendCarry,
    alpha: torch.Tensor,   # (..., K, N) straight-through-clamped alphas
    valid: torch.Tensor,   # (..., K, N) in-ellipse & alpha >= 1/255 & live
    rgb: torch.Tensor,     # (..., K, 3) per-Gaussian color
    depth: torch.Tensor,   # (..., K) per-Gaussian view z
    base_index,            # int or (...,) int tensor: index of chunk row 0
) -> BlendCarry:
    """Composite one chunk of K depth-ordered Gaussians over N pixels."""
    K = alpha.shape[-2]
    a = torch.where(valid, alpha, torch.zeros_like(alpha))
    t_before = carry.T.unsqueeze(-2) * exclusive_cumprod(1.0 - a, dim=-2)
    t_after = t_before * (1.0 - a)
    # t_after is non-increasing along the chunk and a live pixel enters it
    # with T >= T_MIN, so "a pair at or before i triggered" is t_after < T_MIN
    done_after = carry.done.unsqueeze(-2) | (t_after < T_MIN)
    commit = valid & ~done_after
    w = torch.where(commit, a * t_before, torch.zeros_like(a))

    new_rgb = carry.rgb + torch.einsum("...kn,...kc->...cn", w, rgb)
    new_depth = carry.depth + torch.einsum("...k,...kn->...n", depth, w)
    new_acc = carry.acc + torch.sum(w, dim=-2)
    new_T = carry.T * torch.prod(
        1.0 - torch.where(commit, a, torch.zeros_like(a)), dim=-2
    )

    # n_contrib: 1 + index of the last committed Gaussian
    base = torch.as_tensor(base_index, dtype=torch.int32, device=alpha.device)
    idx = (
        base[..., None, None]
        + torch.arange(1, K + 1, dtype=torch.int32, device=alpha.device)[:, None]
    )
    contrib = torch.amax(
        torch.where(commit, idx, torch.zeros_like(idx)), dim=-2
    )
    new_n_contrib = torch.maximum(carry.n_contrib, contrib)

    return BlendCarry(
        T=new_T,
        rgb=new_rgb,
        depth=new_depth,
        acc=new_acc,
        done=done_after[..., -1, :],
        n_contrib=new_n_contrib,
    )


def finalize(carry: BlendCarry, bg: torch.Tensor, acc_min: float = 0.5):
    """Background compositing + depth = D / acc where acc > ``acc_min``.
    ``bg`` is (3,); returns (rgb (..., 3, N), depth (..., N))."""
    rgb = carry.rgb + carry.T.unsqueeze(-2) * bg[:, None]
    depth = torch.where(
        carry.acc > acc_min, carry.depth / carry.acc, torch.zeros_like(carry.depth)
    )
    return rgb, depth
