"""The training step with its gradient reduction overlapped with the
optimizer: a chunked ring all-reduce and Adam issued chunk by chunk (the
twin of ``luciddreamer_tpu/parallel/overlap.py``).

* Each band computes its own share of the loss (its L1 sum and its rows of
  the global SSIM map, reached through 5 halo rows from each neighbour;
  zero rows arrive at the image's top and bottom, as the global window's
  zero padding reads), so the backward yields *partial* gradients with no
  reduction at all.
* The partials are summed by an explicit ring all-reduce (reduce-scatter,
  then all-gather, over point-to-point sends; over the ``tiles`` row, then
  the ``data`` column), one parameter chunk at a time: ``f_dc``,
  ``scaling``, ``rotation``, ``opacity``, ``xyz``, then ``f_rest`` in
  column chunks.  A chunk's first ring step is posted before the previous
  chunk's Adam update is issued, so the update runs while the chunk is on
  the wire.
* The accumulation order of the ring is fixed, so every rank holds the same
  bits.

The numbers equal ``sharded_train_step_batch``'s up to the order of the
sums.  In a world of one there is nothing to send and nothing overlaps.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from luciddreamer_tpu_torch.config import GSConfig
from luciddreamer_tpu_torch.core.types import GaussianParams
from luciddreamer_tpu_torch.model.gaussians import add_densification_stats
from luciddreamer_tpu_torch.model.optim import (
    AdamState, adam_leaf, bias_corrections, learning_rates,
)
from luciddreamer_tpu_torch.parallel.sharded import (
    Mesh, _render_rows, all_reduce, any_rank, band_pair_capacity, band_rows,
)
from luciddreamer_tpu_torch.train.loop import (
    TrainState, loss_and_grads, select_state,
)
from luciddreamer_tpu_torch.train.losses import _blur, _gaussian_window

HALO = 5            # an 11x11 window reaches 5 rows out


def _ring_steps(x: torch.Tensor, group, n: int):
    """Generator of a ring all-reduce of ``x`` over the ``n`` ranks of
    ``group``: it yields once each step's send and receive are posted and
    returns the sum.  Reduce-scatter, then all-gather, 2(n - 1) steps; x is
    padded to a multiple of n."""
    if n == 1 or group is None:
        return x
    idx = dist.get_rank(group)
    nxt = dist.get_global_rank(group, (idx + 1) % n)
    prv = dist.get_global_rank(group, (idx - 1) % n)
    flat = x.reshape(-1)
    size = flat.numel()
    pad = (-size) % n
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    parts = flat.view(n, -1)

    def shift(buf):
        recv = torch.empty_like(buf)
        ops = [dist.P2POp(dist.isend, buf, nxt, group),
               dist.P2POp(dist.irecv, recv, prv, group)]
        return recv, dist.batch_isend_irecv(ops)

    # reduce-scatter: after n - 1 steps this rank holds the whole sum of
    # part (idx + 1) % n
    buf = parts[idx].clone()
    for s in range(n - 1):
        recv, reqs = shift(buf)
        yield
        for r in reqs:
            r.wait()
        buf = recv + parts[(idx - s - 1) % n]
    # all-gather: pass the owned parts around the ring
    out = torch.empty_like(parts)
    out[(idx + 1) % n] = buf
    for s in range(n - 1):
        buf, reqs = shift(buf)
        yield
        for r in reqs:
            r.wait()
        out[(idx - s) % n] = buf
    return out.view(-1)[:size].view(x.shape)


def _finish(steps):
    """Run a generator of ``_ring_steps`` to its end; its return value."""
    while True:
        try:
            next(steps)
        except StopIteration as done:
            return done.value


def ring_all_reduce(x: torch.Tensor, group, n: int) -> torch.Tensor:
    """Sum ``x`` over the ``n`` ranks of ``group`` with a ring; every rank
    gets the same bits."""
    return _finish(_ring_steps(x, group, n))


def _ring_all_reduce_2d(x: torch.Tensor, mesh: Mesh):
    """Generator of the sum over the whole mesh: the tiles ring, then the
    data ring."""
    x = yield from _ring_steps(x, mesh.tiles_group, mesh.tiles)
    return (yield from _ring_steps(x, mesh.data_group, mesh.data))


def _pipelined(chunks, reduce_steps, consume):
    """Reduce each (key, tensor) of ``chunks`` with the generator
    ``reduce_steps`` and hand each sum to ``consume(key, sum)``; a chunk's
    first step is posted before the previous chunk's ``consume`` runs."""
    prev = None
    for key, x in chunks:
        steps = reduce_steps(x)
        try:
            next(steps)
            done = None
        except StopIteration as stop:           # nothing to send
            done = stop.value
        if prev is not None:
            consume(*prev)
        prev = (key, _finish(steps) if done is None else done)
    if prev is not None:
        consume(*prev)


def _swap(down: torch.Tensor, up: torch.Tensor, mesh: Mesh):
    """Send ``down`` to the next band and ``up`` to the previous one: (what
    the previous band sent down, what the next band sent up), zeros where
    there is no neighbour."""
    t, n = mesh.t_index, mesh.tiles
    from_prev, from_next = torch.zeros_like(down), torch.zeros_like(up)
    if n == 1 or mesh.tiles_group is None:
        return from_prev, from_next
    group = mesh.tiles_group
    peer = lambda k: dist.get_global_rank(group, k)
    ops = []
    if t + 1 < n:
        ops += [dist.P2POp(dist.isend, down.contiguous(), peer(t + 1), group),
                dist.P2POp(dist.irecv, from_next, peer(t + 1), group)]
    if t > 0:
        ops += [dist.P2POp(dist.isend, up.contiguous(), peer(t - 1), group),
                dist.P2POp(dist.irecv, from_prev, peer(t - 1), group)]
    for r in dist.batch_isend_irecv(ops):
        r.wait()
    return from_prev, from_next


class _Halo(torch.autograd.Function):
    """The neighbours' edge rows of a (C, h, W) band: (the previous band's
    last ``halo`` rows, the next band's first).  The backward sends each
    halo's cotangent back to the band that rendered its rows."""

    @staticmethod
    def forward(ctx, x, halo, mesh):
        ctx.halo, ctx.mesh, ctx.h = halo, mesh, x.shape[1]
        return _swap(x[:, -halo:], x[:, :halo], mesh)

    @staticmethod
    def backward(ctx, d_top, d_bot):
        halo, h = ctx.halo, ctx.h
        from_prev, from_next = _swap(d_bot, d_top, ctx.mesh)
        dx = d_top.new_zeros((d_top.shape[0], h, d_top.shape[2]))
        dx[:, :halo] += from_prev
        dx[:, h - halo:] += from_next
        return dx, None, None


def _halo(x: torch.Tensor, halo: int, mesh: Mesh):
    """(top, bottom) halo rows of the band ``x`` (C, h, W) from its tile
    neighbours, differentiably; zeros at the image's top and bottom."""
    return _Halo.apply(x, halo, mesh)


def _band_ssim_sum(img, gt, top_i, bot_i, top_g, bot_g, window_size=11,
                   sigma=1.5):
    """The sum over this band's rows of the global zero-padded SSIM map:
    the band with its halos blurred, the centre rows kept."""
    halo = window_size // 2
    ext_i = torch.cat([top_i, img, bot_i], dim=1)
    ext_g = torch.cat([top_g, gt, bot_g], dim=1)
    window = _gaussian_window(window_size, sigma)
    mu1, mu2, e11, e22, e12 = _blur(
        torch.stack([ext_i, ext_g, ext_i * ext_i, ext_g * ext_g,
                     ext_i * ext_g]), window).unbind(0)
    mu1_sq, mu2_sq, mu1_mu2 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    s1, s2, s12 = e11 - mu1_sq, e22 - mu2_sq, e12 - mu1_mu2
    C1, C2 = 0.01**2, 0.03**2
    ssim_map = ((2 * mu1_mu2 + C1) * (2 * s12 + C2)) / (
        (mu1_sq + mu2_sq + C1) * (s1 + s2 + C2))
    return torch.sum(ssim_map[:, halo:halo + img.shape[1]])


def _target_rows(gt: torch.Tensor, r0: int, r1: int) -> torch.Tensor:
    """Rows [r0, r1) of a (C, H, W) target, zero rows outside the image.
    Every rank holds the whole target, so its halos need no exchange."""
    H = gt.shape[1]
    out = gt.new_zeros((gt.shape[0], r1 - r0, gt.shape[2]))
    lo, hi = max(r0, 0), min(r1, H)
    if hi > lo:
        out[:, lo - r0:hi - r0] = gt[:, lo:hi]
    return out


def sharded_train_step_overlapped(
    state: TrainState, cam_batch, gt_batch, bg, mesh: Mesh, cfg: GSConfig,
    extent: float, tile_size: int = 16, chunk: int = 64,
    pair_cap: int | None = None, backend: str = "cuda",
    f_rest_chunks: int = 3, gt_depth_batch=None,
):
    """Drop-in twin of ``sharded_train_step_batch`` with the chunked ring
    reduction overlapped with Adam (module docstring).

    With ``gt_depth_batch`` (B, H, W) and cfg.lambda_depth > 0 each band
    adds its masked depth-L1 sum over the batch's mask count, which one
    scalar all-reduce outside the gradient provides.  Returns (state, loss,
    overflow); an overflow on any rank voids the whole update."""
    n_data, n_tiles = mesh.data, mesh.tiles
    params = state.params
    cam = cam_batch[mesh.d_index]
    H, W = cam.height, cam.width
    gyl = band_rows(cam, tile_size, n_tiles)
    h_local = gyl * tile_size
    r0 = mesh.t_index * h_local
    if pair_cap is None:
        pair_cap = band_pair_capacity(params.capacity, n_tiles)
    it = state.step + 1
    lrs = learning_rates(cfg, extent, it - 1)
    lam = cfg.lambda_dssim
    denom = n_data * 3 * H * W
    use_depth = cfg.lambda_depth > 0.0 and gt_depth_batch is not None
    gt = gt_batch[mesh.d_index]
    gt_band = gt[:, r0:r0 + h_local]
    top_g = _target_rows(gt, r0 - HALO, r0)
    bot_g = _target_rows(gt, r0 + h_local, r0 + h_local + HALO)

    def local_loss(p, offset):
        out = _render_rows(
            p, cam, bg, mesh.t_index * gyl, gyl,
            active_sh_degree=params.max_sh_degree, tile_size=tile_size,
            chunk=chunk, pair_cap=pair_cap, backend=backend,
            mean2d_offset=offset,
        )
        img = out["render"]
        l1_sum = torch.sum(torch.abs(img - gt_band))
        top_i, bot_i = _halo(img, HALO, mesh)
        ssim_sum = _band_ssim_sum(img, gt_band, top_i, bot_i, top_g, bot_g)
        contrib = ((1.0 - lam) * l1_sum - lam * ssim_sum) / denom
        if use_depth:
            dpt = out["depth"]
            gtd = gt_depth_batch[mesh.d_index][r0:r0 + h_local]
            dmask = ((gtd > 0) & (dpt > 0)).to(img.dtype)
            num = torch.sum(torch.abs(dpt - gtd) * dmask)
            # the batch's mask count: the mask has no gradient, so this sum
            # stays out of the parameter gradients
            den = all_reduce(torch.sum(dmask).detach(), mesh.world_group)
            contrib = contrib + cfg.lambda_depth * num / (den + 1e-8)
        return contrib, out

    contrib, out, grads, g2d = loss_and_grads(state, local_loss)
    # the constant lam of (1 - SSIM) has no gradient: added after the sum
    loss = all_reduce(contrib, mesh.world_group) + lam
    ovf = any_rank(out["overflow"], mesh.world_group)
    radii = all_reduce(out["radii"], mesh.world_group, dist.ReduceOp.MAX)

    # ---- the chunked ring reduction; Adam issued per chunk as it lands
    work = [(name, None) for name in
            ("f_dc", "scaling", "rotation", "opacity", "xyz")]
    n_rest = grads["f_rest"].shape[1]
    splits = np.linspace(0, n_rest, f_rest_chunks + 1).astype(int)
    work += [("f_rest", (int(a), int(b)))
             for a, b in zip(splits[:-1], splits[1:]) if b > a]
    pdict = params.param_dict()
    count = state.adam.count + 1
    c1, c2 = bias_corrections(count)
    new_p = {k: v.clone() for k, v in pdict.items()}
    new_mu = {k: v.clone() for k, v in state.adam.mu.items()}
    new_nu = {k: v.clone() for k, v in state.adam.nu.items()}
    stats = []

    def cut(t, sl):
        return t if sl is None else t[:, sl[0]:sl[1]]

    def consume(key, g):
        if key == "g2d":
            stats.append(add_densification_stats(state.stats, g, radii))
            return
        name, sl = key
        p1, m1, v1 = adam_leaf(cut(pdict[name], sl), g,
                               cut(state.adam.mu[name], sl),
                               cut(state.adam.nu[name], sl), lrs[name], c1, c2)
        cut(new_p[name], sl).copy_(p1)
        cut(new_mu[name], sl).copy_(m1)
        cut(new_nu[name], sl).copy_(v1)

    with torch.no_grad():
        chunks = [((name, sl), cut(grads[name], sl).contiguous())
                  for name, sl in work] + [("g2d", g2d)]
        _pipelined(chunks, lambda x: _ring_all_reduce_2d(x, mesh), consume)
        new = TrainState(
            params=GaussianParams.from_param_dict(new_p, params.alive),
            adam=AdamState(count=count, mu=new_mu, nu=new_nu),
            stats=stats[0],
            step=it,
        )
        return select_state(ovf, new, state), loss, ovf
