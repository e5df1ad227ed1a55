"""Multi-device rendering and training on ``torch.distributed``: tile-row
sharding over a (data, tiles) mesh of processes, the twin of
``luciddreamer_tpu/parallel/sharded.py``.

* Each process is one rank of the mesh; rank = d * tiles + t.  Cameras are
  spread over ``data`` (classic data parallelism) and the image's tile
  rows over ``tiles`` (the renderer's long axis is its pixels).
* The Gaussians are replicated.  Every rank preprocesses all of them, cuts
  each rectangle to its band of tile rows, bins the band and blends it
  through ``render/cuda_blend.blend_tiles``: on CUDA tensors the forward is
  K1, the backward K2 and the binning VJP K3, so binning and blending, the
  dominant costs, shrink with 1/tiles.
* The bands are assembled with a differentiable all-gather over the
  ``tiles`` group (and a camera batch over the ``data`` group).  Every rank
  then computes the same whole-image loss, so the gather's backward hands
  each rank its own slice of the cotangent and sums nothing; the parameter
  gradients of all ranks are then summed once over the world.
* The update runs replicated: every rank feeds the same summed gradients
  to the same Adam, and an overflow on any rank voids the update on all.

A mesh without a process group (a world of one) is valid; its collectives
are the identity.  Where the JAX package relies on ``shard_map`` and the
compiler's collectives, this module calls them on process groups itself.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from luciddreamer_tpu_torch.config import GSConfig
from luciddreamer_tpu_torch.core.types import (
    Camera, GaussianParams, ProcessedGaussians,
)
from luciddreamer_tpu_torch.device import resolve_device
from luciddreamer_tpu_torch.model.optim import GROUPS
from luciddreamer_tpu_torch.render import blend_math, cuda_blend, torch_blend
from luciddreamer_tpu_torch.render.binning import build_tile_bins, num_tiles_for
from luciddreamer_tpu_torch.render.preprocess import preprocess_gaussians
from luciddreamer_tpu_torch.train.loop import (
    TrainState, apply_update, loss_and_grads, view_loss,
)

BACKEND_OF_DEVICE = {"cuda": "nccl", "cpu": "gloo"}


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This process's place in a (data, tiles) mesh of processes.

    ``tiles_group`` holds the ranks of this rank's row (its data index, every
    band), ``data_group`` those of its column (its band, every data index),
    ``world_group`` all; each is None when there is no process group.
    """

    data: int
    tiles: int
    rank: int
    device: torch.device
    world_group: object = None
    tiles_group: object = None
    data_group: object = None

    @property
    def shape(self) -> dict:
        return {"data": self.data, "tiles": self.tiles}

    @property
    def d_index(self) -> int:
        return self.rank // self.tiles

    @property
    def t_index(self) -> int:
        return self.rank % self.tiles


def make_mesh(data: int = 1, tiles: int | None = None, device=None) -> Mesh:
    """The (data, tiles) mesh over the processes of the default group, or a
    mesh of one when there is none.  Every rank must call it, in the same
    order as its other group creations: it creates a group for each row and
    each column.  The device must match the group's backend (NCCL: CUDA,
    gloo: the CPU)."""
    dev = resolve_device(device)
    grouped = dist.is_available() and dist.is_initialized()
    world, rank = (dist.get_world_size(), dist.get_rank()) if grouped else (1, 0)
    tiles = tiles or world // data
    if data < 1 or data * tiles != world:
        raise ValueError(f"a {data} x {tiles} mesh needs {data * tiles} "
                         f"processes, the world has {world}")
    if not grouped:
        return Mesh(data, tiles, 0, dev)
    backend = dist.get_backend()
    if BACKEND_OF_DEVICE.get(dev.type) != backend:
        raise ValueError(f"a mesh on {dev} cannot use the {backend} backend")
    rows = [dist.new_group([d * tiles + t for t in range(tiles)])
            for d in range(data)]
    cols = [dist.new_group([d * tiles + t for d in range(data)])
            for t in range(tiles)]
    return Mesh(data, tiles, rank, dev, dist.group.WORLD,
                rows[rank // tiles], cols[rank % tiles])


# ------------------------------------------------------------ collectives

def all_reduce(x: torch.Tensor, group, op=None) -> torch.Tensor:
    """The reduction (a sum unless ``op``) of ``x`` over ``group``, in a new
    tensor; ``x`` itself when there is no group."""
    if group is None:
        return x
    x = x.clone()
    dist.all_reduce(x, op=op or dist.ReduceOp.SUM, group=group)
    return x


def any_rank(flag: torch.Tensor, group) -> torch.Tensor:
    """A bool that is set on every rank when ``flag`` is set on any."""
    return all_reduce(flag.to(torch.int32), group, dist.ReduceOp.MAX) > 0


class _GatherReplicated(torch.autograd.Function):
    """All-gather along ``dim`` over a group whose ranks all use the result
    in the same way (a replicated loss): each rank's cotangent of the whole
    is then the same, so the backward returns this rank's slice of it and
    sums nothing.  A sum would count the same cotangent once per rank."""

    @staticmethod
    def forward(ctx, x, group, n, index, dim):
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x.contiguous(), group=group)
        ctx.args = (index, dim, x.shape[dim])
        return torch.cat(parts, dim)

    @staticmethod
    def backward(ctx, grad):
        index, dim, size = ctx.args
        return grad.narrow(dim, index * size, size), None, None, None, None


def gather_replicated(x: torch.Tensor, group, n: int, index: int,
                      dim: int) -> torch.Tensor:
    """Concatenate ``x`` of the ``n`` ranks of ``group`` along ``dim``
    (this rank's is part ``index``), differentiably for a replicated use
    (``_GatherReplicated``); ``x`` itself when there is no group."""
    if group is None:
        return x
    return _GatherReplicated.apply(x, group, n, index, dim)


def all_reduce_flat(tensors: list, group) -> list:
    """The sums of ``tensors`` over ``group``, in one all-reduce of their
    concatenation; ``tensors`` itself when there is no group."""
    if group is None:
        return tensors
    flat = all_reduce(torch.cat([t.reshape(-1) for t in tensors]), group)
    return [v.view_as(t) for v, t in
            zip(flat.split([t.numel() for t in tensors]), tensors)]


def reduce_grads(grads: dict, g2d: torch.Tensor, group):
    """Sum the parameter gradients and dL/d mean2d_offset over ``group``."""
    out = all_reduce_flat([grads[k] for k in GROUPS] + [g2d], group)
    return dict(zip(GROUPS, out[:-1])), out[-1]


# -------------------------------------------------------------- rendering

def band_pair_capacity(capacity: int, n_tiles: int) -> int:
    """The default pair budget of one band: a frame's 8 pairs per Gaussian
    spread over the bands, with a floor of 4096."""
    return max(4096, int(capacity * 8) // n_tiles)


def band_rows(camera: Camera, tile_size: int, n_tiles: int) -> int:
    """The tile rows of one band; the tile grid's rows must split evenly."""
    _, grid_y = num_tiles_for(camera.height, camera.width, tile_size)
    if grid_y % n_tiles:
        raise ValueError(f"{grid_y} tile rows do not split into {n_tiles} "
                         "bands")
    return grid_y // n_tiles


def _restrict_rows(proc: ProcessedGaussians, ty0: int,
                   grid_y_local: int) -> ProcessedGaussians:
    """Cut every Gaussian's tile rectangle to tile rows [ty0, ty0 +
    grid_y_local), in the band's own coordinates, and recount its tiles.

    ``visible`` and ``radius`` stay band-independent: they follow the
    3-sigma rectangle while binning uses the opacity-tightened one, so a
    Gaussian whose tight rectangle misses every band must still report its
    radius to densification; zeroing it per band would make the sharded
    radii disagree with the whole render's."""
    rmin, rmax = proc.rect_min, proc.rect_max
    min_y = (rmin[:, 1] - ty0).clamp(0, grid_y_local)
    max_y = (rmax[:, 1] - ty0).clamp(0, grid_y_local)
    tiles = (rmax[:, 0] - rmin[:, 0]) * (max_y - min_y)
    tiles = torch.where(proc.visible & (tiles > 0), tiles, 0).to(torch.int32)
    return dataclasses.replace(
        proc,
        rect_min=torch.stack([rmin[:, 0], min_y], dim=-1),
        rect_max=torch.stack([rmax[:, 0], max_y], dim=-1),
        tiles_touched=tiles,
    )


def band_of(proc: ProcessedGaussians, ty0: int, grid_y_local: int,
            tile_size: int) -> ProcessedGaussians:
    """The preprocessed Gaussians as the band of tile rows [ty0, ty0 +
    grid_y_local) bins them: rectangles cut to the band, and mean2d shifted
    into the band's frame, which keeps global pixel coordinates (the conic
    and pixel math is translation-invariant)."""
    proc = _restrict_rows(proc, ty0, grid_y_local)
    shift = proc.mean2d.new_tensor([0.0, float(ty0 * tile_size)])
    return dataclasses.replace(proc, mean2d=proc.mean2d - shift)


def _render_rows(params, camera, bg, ty0, grid_y_local, *, active_sh_degree,
                 tile_size, chunk, pair_cap, backend, mean2d_offset=None):
    """Render tile rows [ty0, ty0 + grid_y_local): render (3, h, W), depth
    and acc (h, W), n_contrib, radii (P,), overflow and num_pairs, where h
    is grid_y_local * tile_size.  ``pair_cap`` is the band's budget,
    rounded up to a multiple of ``chunk`` as the JAX package's binning
    does."""
    if backend not in ("cuda", "torch"):
        raise ValueError(f"unknown backend {backend!r}")
    grid_x, _ = num_tiles_for(camera.height, camera.width, tile_size)
    h_local = grid_y_local * tile_size
    pair_cap = -(-pair_cap // chunk) * chunk
    proc = band_of(preprocess_gaussians(params, camera, active_sh_degree,
                                        tile_size, mean2d_offset=mean2d_offset),
                   ty0, grid_y_local, tile_size)
    bins = build_tile_bins(proc, h_local, camera.width, tile_size, pair_cap)
    carry = cuda_blend.blend_tiles(bins, grid_x, tile_size, chunk,
                                   plain=backend == "torch")
    rgb, depth = blend_math.finalize(carry, bg)

    def to_img(x):
        return torch_blend.tilemajor_to_image(x, grid_x, grid_y_local,
                                              tile_size, h_local, camera.width)

    return {
        "render": to_img(rgb.transpose(0, 1)),
        "depth": to_img(depth),
        "acc": to_img(carry.acc),
        "n_contrib": to_img(carry.n_contrib),
        "radii": proc.radius,
        "overflow": bins.overflow,
        "num_pairs": bins.num_pairs,
    }


def _band(params, camera, bg, mesh, active_sh_degree, tile_size, chunk,
          pair_cap, backend, mean2d_offset):
    gyl = band_rows(camera, tile_size, mesh.tiles)
    if pair_cap is None:
        pair_cap = band_pair_capacity(params.capacity, mesh.tiles)
    return _render_rows(
        params, camera, bg, mesh.t_index * gyl, gyl,
        active_sh_degree=active_sh_degree, tile_size=tile_size, chunk=chunk,
        pair_cap=pair_cap, backend=backend, mean2d_offset=mean2d_offset,
    )


def render_sharded(
    params: GaussianParams,
    camera: Camera,
    bg: torch.Tensor,
    mesh: Mesh,
    active_sh_degree: int = 3,
    tile_size: int = 16,
    chunk: int = 64,
    pair_cap: int | None = None,
    backend: str = "cuda",
    mean2d_offset: torch.Tensor | None = None,
):
    """One camera with its tile rows sharded over the mesh's ``tiles``: each
    rank renders its band and the bands are gathered, so every rank returns
    the whole render (3, H, W), depth and acc (H, W), radii (the maximum
    over the world) and overflow (set on every rank if any overflowed).
    ``pair_cap`` is per band.  Differentiable for a loss that every rank of
    the tiles group computes alike."""
    out = _band(params, camera, bg, mesh, active_sh_degree, tile_size, chunk,
                pair_cap, backend, mean2d_offset)
    gather = lambda x, dim: gather_replicated(x, mesh.tiles_group, mesh.tiles,
                                              mesh.t_index, dim)
    return {
        "render": gather(out["render"], 1),
        "depth": gather(out["depth"], 0),
        "acc": gather(out["acc"], 0),
        "radii": all_reduce(out["radii"], mesh.world_group, dist.ReduceOp.MAX),
        "overflow": any_rank(out["overflow"], mesh.world_group),
    }


def render_sharded_batch(
    params: GaussianParams,
    cam_batch: list,
    bg: torch.Tensor,
    mesh: Mesh,
    active_sh_degree: int = 3,
    tile_size: int = 16,
    chunk: int = 64,
    pair_cap: int | None = None,
    backend: str = "cuda",
    mean2d_offset: torch.Tensor | None = None,
):
    """Data-parallel x tile-parallel render of ``cam_batch``, one camera per
    data index: camera b is rendered by row b of the mesh, each rank its
    band.  Every rank returns the whole batch, render (B, 3, H, W) and depth
    (B, H, W), radii (maximum over the world) and overflow (any rank)."""
    if len(cam_batch) != mesh.data:
        raise ValueError(f"{len(cam_batch)} cameras for {mesh.data} data rows")
    out = _band(params, cam_batch[mesh.d_index], bg, mesh, active_sh_degree,
                tile_size, chunk, pair_cap, backend, mean2d_offset)

    def gather(x, dim):
        x = gather_replicated(x, mesh.tiles_group, mesh.tiles, mesh.t_index,
                              dim)
        return gather_replicated(x[None], mesh.data_group, mesh.data,
                                 mesh.d_index, 0)

    return {
        "render": gather(out["render"], 1),
        "depth": gather(out["depth"], 0),
        "radii": all_reduce(out["radii"], mesh.world_group, dist.ReduceOp.MAX),
        "overflow": any_rank(out["overflow"], mesh.world_group),
    }


# --------------------------------------------------------------- training

def sharded_loss_fn(pdict, alive, camera, gt_image, bg, mesh: Mesh,
                    cfg: GSConfig, mean2d_offset=None, **render_kw):
    """0.8 L1 + 0.2 D-SSIM of a tile-sharded render of one camera, on every
    rank; differentiable in ``pdict`` and ``mean2d_offset``.  Returns
    (loss, the render's dict)."""
    params = GaussianParams.from_param_dict(pdict, alive)
    out = render_sharded(params, camera, bg, mesh,
                         mean2d_offset=mean2d_offset, **render_kw)
    return view_loss(out["render"], gt_image, out["depth"], None, cfg), out


def sharded_train_step_batch(state: TrainState, cam_batch, gt_batch, bg,
                             mesh: Mesh, cfg: GSConfig, extent: float,
                             gt_depth_batch=None, **render_kw):
    """One data x tiles training step over ``cam_batch`` (one camera per
    data index; ``gt_batch`` (B, 3, H, W) and ``gt_depth_batch`` (B, H, W)
    whole on every rank).  The loss of the whole batch is computed on every
    rank, the gradients of every (camera, band) are summed over the world,
    and Adam and the densification statistics run replicated.  As in the
    single-device ``Trainer._step``, an update computed from a truncated
    pair list is never committed: an overflow on any rank voids the whole
    update (params, Adam, stats, step) on every rank.  Returns (state,
    loss, overflow)."""
    max_deg = state.params.max_sh_degree

    def loss_fn(p, offset):
        out = render_sharded_batch(p, cam_batch, bg, mesh,
                                   mean2d_offset=offset,
                                   active_sh_degree=max_deg, **render_kw)
        return view_loss(out["render"], gt_batch, out["depth"],
                         gt_depth_batch, cfg), out

    loss, out, grads, g2d = loss_and_grads(state, loss_fn)
    grads, g2d = reduce_grads(grads, g2d, mesh.world_group)
    new = apply_update(state, grads, g2d, out["radii"], out["overflow"], cfg,
                       extent)
    return new, loss, out["overflow"]


def sharded_train_step(state: TrainState, camera, gt_image, bg, mesh: Mesh,
                       cfg: GSConfig, extent: float, **render_kw):
    """One training step on one camera with its render sharded over the
    mesh's ``tiles``; every data row computes the same step, so the
    gradients are summed over the tiles group only.  An overflowed update
    is voided, as in the batch step."""
    max_deg = state.params.max_sh_degree

    def loss_fn(p, offset):
        out = render_sharded(p, camera, bg, mesh, mean2d_offset=offset,
                             active_sh_degree=max_deg, **render_kw)
        return view_loss(out["render"], gt_image, out["depth"], None,
                         cfg), out

    loss, out, grads, g2d = loss_and_grads(state, loss_fn)
    grads, g2d = reduce_grads(grads, g2d, mesh.tiles_group)
    new = apply_update(state, grads, g2d, out["radii"], out["overflow"], cfg,
                       extent)
    return new, loss, out["overflow"]
