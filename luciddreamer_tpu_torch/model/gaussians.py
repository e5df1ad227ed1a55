"""Gaussian model state ops: creation, densification, pruning, opacity reset
(the twins of ``luciddreamer_tpu/model/gaussians.py``).

The parameter buffer has a fixed capacity with an ``alive`` mask:
densify/prune scatter into dead slots and flip the mask instead of
reallocating.  Every function returns new objects and leaves its inputs as
they are.  Scatters that the JAX package drops when their index is out of
range (``mode="drop"``) write into one spare row P that is then cut off.
"""
from __future__ import annotations

import dataclasses

import torch

from luciddreamer_tpu_torch.core import sh as shlib
from luciddreamer_tpu_torch.core.covariance import quat_to_rotmat
from luciddreamer_tpu_torch.core.types import GaussianParams
from luciddreamer_tpu_torch.model.optim import AdamState
from luciddreamer_tpu_torch.points.knn import mean_sq_dist_3nn


def inverse_sigmoid(x):
    return torch.log(x / (1.0 - x))


def _set_rows(x: torch.Tensor, dest: torch.Tensor, values) -> torch.Tensor:
    """``x.at[dest].set(values, mode="drop")`` for dest in [0, P]."""
    buf = torch.cat([x, x[:1]])
    buf[dest] = values
    return buf[:-1]


@torch.no_grad()
def create_from_pcd(
    points: torch.Tensor,
    colors: torch.Tensor,
    sh_degree: int = 3,
    capacity: int | None = None,
) -> GaussianParams:
    """Gaussians from a coloured point cloud: SH DC from RGB, isotropic
    scale from the 3-NN mean squared distance, identity rotation, opacity
    0.1; rows past the cloud are dead."""
    P = points.shape[0]
    capacity = capacity or P
    if capacity < P:
        raise ValueError(
            f"capacity {capacity} < point count {P}; subsample the cloud or "
            "raise the capacity"
        )
    n_rest = (sh_degree + 1) ** 2 - 1
    dev = points.device
    points = points.to(torch.float32)
    dist2 = torch.clamp_min(mean_sq_dist_3nn(points), 1e-7)
    log_scale = torch.log(torch.sqrt(dist2))[:, None].repeat(1, 3)

    def pad(x, fill=0.0):
        return torch.cat([x, x.new_full((capacity - P,) + x.shape[1:], fill)])

    rot = torch.zeros((capacity, 4), device=dev)
    rot[:, 0] = 1.0
    return GaussianParams(
        xyz=pad(points),
        features_dc=pad(shlib.rgb2sh(colors.to(torch.float32))[:, None, :]),
        features_rest=pad(torch.zeros((P, n_rest, 3), device=dev)),
        scaling=pad(log_scale),
        rotation=rot,
        opacity=pad(inverse_sigmoid(torch.full((P, 1), 0.1, dtype=torch.float64,
                                               device=dev)).to(torch.float32)),
        alive=pad(torch.ones(P, dtype=torch.bool, device=dev), fill=False),
    )


@torch.no_grad()
def reset_opacity(params: GaussianParams, adam: AdamState):
    """Clamp opacity to <= 0.01 and zero its Adam moments."""
    p = params.param_dict()
    p["opacity"] = inverse_sigmoid(torch.clamp_max(params.get_opacity(), 0.01))
    mu = dict(adam.mu, opacity=torch.zeros_like(adam.mu["opacity"]))
    nu = dict(adam.nu, opacity=torch.zeros_like(adam.nu["opacity"]))
    return (GaussianParams.from_param_dict(p, params.alive),
            AdamState(count=adam.count, mu=mu, nu=nu))


@dataclasses.dataclass
class DensifyStats:
    """Running densification statistics."""

    grad_accum: torch.Tensor    # (P,) sum of ||dL/dmean2d.xy||
    denom: torch.Tensor         # (P,) number of visible frames
    max_radii2d: torch.Tensor   # (P,) int32

    @classmethod
    def zero(cls, capacity: int, device=None):
        return cls(
            grad_accum=torch.zeros(capacity, device=device),
            denom=torch.zeros(capacity, device=device),
            max_radii2d=torch.zeros(capacity, dtype=torch.int32, device=device),
        )


def add_densification_stats(stats: DensifyStats, mean2d_grad: torch.Tensor,
                            radii: torch.Tensor) -> DensifyStats:
    """Accumulate the screen-gradient norms of the visible Gaussians
    (radii > 0); ``mean2d_grad`` is dL/d(mean2d offset) of a step."""
    vis = radii > 0
    g = torch.sqrt(torch.sum(mean2d_grad[:, :2] ** 2, dim=-1))
    return DensifyStats(
        grad_accum=stats.grad_accum + torch.where(vis, g, 0.0),
        denom=stats.denom + vis.to(torch.float32),
        max_radii2d=torch.maximum(stats.max_radii2d,
                                  torch.where(vis, radii, 0).to(torch.int32)),
    )


def _rank_to_slot(free: torch.Tensor) -> torch.Tensor:
    """free: (P,) bool -> (P,) int64 mapping rank r to the index of the r-th
    free slot (0 past the number of free slots)."""
    P = free.shape[0]
    rank = torch.cumsum(free.to(torch.int64), dim=0) - 1
    slot = torch.arange(P, device=free.device)
    return _set_rows(torch.zeros(P, dtype=torch.int64, device=free.device),
                     torch.where(free, rank, P), slot)


@torch.no_grad()
def densify_and_prune(
    params: GaussianParams,
    adam: AdamState,
    stats: DensifyStats,
    grad_threshold: float,
    min_opacity: float,
    extent: float,
    max_screen_size: int | None,
    percent_dense: float = 0.01,
    generator: torch.Generator | None = None,
    noise: tuple[torch.Tensor, torch.Tensor] | None = None,
):
    """Clone small and split large high-gradient Gaussians, prune
    transparent ones, as a fixed-capacity scatter.

    The split children are offset by two (P, 3) standard normals, drawn from
    ``generator`` unless ``noise`` gives them.  Returns (params, adam, fresh
    zero stats, overflowed: bool 0-d tensor).  New rows get zeroed Adam
    moments.
    """
    P = params.capacity
    dev = params.xyz.device
    avg_grad = torch.where(stats.denom > 0, stats.grad_accum / stats.denom, 0.0)
    scales = params.get_scaling()
    max_scale = torch.amax(scales, dim=-1)
    hot = params.alive & (avg_grad >= grad_threshold)
    clone_mask = hot & (max_scale <= percent_dense * extent)
    split_mask = hot & (max_scale > percent_dense * extent)

    # --- payloads: clones (P) then split children A and B (P each) ---
    if noise is None:
        noise = tuple(torch.randn((P, 3), generator=generator, device=dev)
                      for _ in range(2))
    R = quat_to_rotmat(params.get_rotation())                # (P, 3, 3)
    pdict = params.param_dict()
    child_xyz = [torch.sum(R * (n * scales)[:, None, :], dim=-1) + pdict["xyz"]
                 for n in noise]
    child_scaling = torch.log(scales / (0.8 * 2.0))

    def payload(xyz, scaling):
        return dict(pdict, xyz=xyz, scaling=scaling)

    payloads = [
        (payload(pdict["xyz"], pdict["scaling"]), clone_mask),
        (payload(child_xyz[0], child_scaling), split_mask),
        (payload(child_xyz[1], child_scaling), split_mask),
    ]
    valid = torch.cat([m for _, m in payloads])              # (3P,)

    free = ~params.alive
    n_free = free.sum()
    rank2slot = _rank_to_slot(free)
    rank = torch.cumsum(valid.to(torch.int64), dim=0) - 1    # payload -> rank
    overflow = valid.sum() > n_free
    placed = valid & (rank < n_free)
    dest = torch.where(placed, rank2slot[rank.clamp(0, P - 1)], P)

    new_p, new_mu, new_nu = {}, {}, {}
    for name in pdict:
        stacked = torch.cat([pl[name] for pl, _ in payloads])
        new_p[name] = _set_rows(pdict[name], dest, stacked)
        new_mu[name] = _set_rows(adam.mu[name], dest, 0.0)
        new_nu[name] = _set_rows(adam.nu[name], dest, 0.0)

    alive = _set_rows(params.alive, dest, placed)
    alive = alive & ~split_mask          # split sources die
    params = GaussianParams.from_param_dict(new_p, alive)

    # --- prune (old and newly inserted rows alike) ---
    prune = params.get_opacity()[:, 0] < min_opacity
    if max_screen_size is not None:
        # max_radii2d is stale (zero) for new rows, as in the reference
        radii = _set_rows(stats.max_radii2d, dest, 0)
        big_scale = torch.amax(params.get_scaling(), dim=-1) > 0.1 * extent
        prune = prune | (radii > max_screen_size) | big_scale
    params = GaussianParams.from_param_dict(params.param_dict(), alive & ~prune)
    return (
        params,
        AdamState(count=adam.count, mu=new_mu, nu=new_nu),
        DensifyStats.zero(P, device=dev),
        overflow,
    )


@torch.no_grad()
def grow_capacity(params: GaussianParams, adam: AdamState,
                  stats: DensifyStats, new_capacity: int):
    """Pad every buffer to ``new_capacity`` rows with dead zero rows."""
    old = params.capacity
    if new_capacity < old:
        raise ValueError(f"new capacity {new_capacity} < capacity {old}")

    def pad(x, fill=0):
        return torch.cat([x, x.new_full((new_capacity - old,) + x.shape[1:], fill)])

    params = GaussianParams.from_param_dict(
        {k: pad(v) for k, v in params.param_dict().items()},
        pad(params.alive, False),
    )
    adam = AdamState(count=adam.count,
                     mu={k: pad(v) for k, v in adam.mu.items()},
                     nu={k: pad(v) for k, v in adam.nu.items()})
    stats = DensifyStats(*(pad(getattr(stats, f.name))
                           for f in dataclasses.fields(DensifyStats)))
    return params, adam, stats
