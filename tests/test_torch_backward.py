"""Port parity, backward: the plain versions of K2 (backward blend) and K3
(cotangent column repack), the binning gather's VJP, ``render_tiled``
gradients and ``render_dense`` against the JAX package (CPU).

JAX runs as its own tests run it here: K2 through ``_bwd_call`` in
interpret mode, K3 through ``_repack_cols`` (interpret mode off-TPU), the
tiled render with ``backend="pallas"`` and ``"xla"``.  Tolerances: K2 rows
atol 1e-5 scaled by each channel's max; the gather VJP atol 1e-5 scaled by
each field's max (the JAX prefix sum runs in fp32); render gradients atol
5e-4 scaled by the group's max, as tests/test_pallas_blend.py; K3 exact.
The contracts that the CUDA kernels' edge cases rest on are pinned here on
the plain versions: K3 against a direct numpy loop, K2 on tile ranges that
cross 128 and 256 rows.
"""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from luciddreamer_tpu.core.types import GaussianParams as JParams
from luciddreamer_tpu.render.binning import _repack_cols
from luciddreamer_tpu.render.binning import build_tile_bins as jbins
from luciddreamer_tpu.render.dense import render_dense as jdense
from luciddreamer_tpu.render.pallas_blend import _bwd_call, _fwd_call
from luciddreamer_tpu.render.preprocess import preprocess_gaussians as jpre
from luciddreamer_tpu.render.tiled import render_tiled as jrender
from luciddreamer_tpu_torch.render import (
    binning, blend_cases, cuda_blend, cuda_repack, kernels, torch_blend,
)
from luciddreamer_tpu_torch.render.dense import render_dense as tdense
from luciddreamer_tpu_torch.render.preprocess import preprocess_gaussians as tpre
from luciddreamer_tpu_torch.render.tiled import render_tiled as trender
from tests.helpers import make_random_gaussians, make_test_camera
from tests.port_helpers import (  # noqa: F401  (one_torch_thread: a fixture)
    assert_scaled_close, jax_tile_ranges, np_, one_torch_thread, port_camera,
    port_params,
)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

TILE = 16
GROUPS = ("xyz", "f_dc", "f_rest", "scaling", "rotation", "opacity")
PORT_NAMES = dict(xyz="xyz", f_dc="features_dc", f_rest="features_rest",
                  scaling="scaling", rotation="rotation", opacity="opacity")


def _wall(jp, P):
    """Dense opaque wall: the done latch decides most pixels."""
    return jp.replace(opacity=jnp.full((P, 1), 8.0))


def _scene(rng, case):
    if case == "wall":
        jp = make_random_gaussians(120, rng, scale_range=(-2.5, -1.0), spread=0.3)
        return _wall(jp, 120), 0, 16
    return make_random_gaussians(60, rng, scale_range=(-3.0, -1.0)), 2, 32


@pytest.mark.parametrize("case", ["blob", "wall"])
def test_plain_k2_matches_jax_bwd_call(rng, case):
    jp, _, chunk = _scene(rng, case)
    W = H = 32
    gx, gy = W // TILE, H // TILE
    nt = gx * gy
    jcam = make_test_camera(W, H)
    jb = jax.jit(lambda p: jbins(jpre(p, jcam, 3), H, W, TILE, 4096, chunk))(jp)
    segs = (jb.seg_tile, jb.seg_k0, jb.seg_lo, jb.seg_hi, jb.seg_chunk)
    fwd = jax.jit(lambda a, *s: _fwd_call(a, *s, gx, gy, TILE, chunk,
                                          interpret=True))
    bwd = jax.jit(lambda a, st, ds, *s: _bwd_call(a, *s, st, ds, gx, gy, TILE,
                                                  chunk, interpret=True))
    state = fwd(jb.attrs, *segs)
    dstate = rng.normal(size=state.shape).astype(np.float32)
    ref = np.asarray(bwd(jb.attrs, state, jnp.asarray(dstate), *segs))

    start, end = jax_tile_ranges(jb, nt, chunk)
    t_state = torch.as_tensor(np.array(state)[:nt, :7])
    t_dstate = torch.as_tensor(dstate[:nt, :7]).contiguous()
    t_dstate[:, 6] = 0.0
    out = torch_blend.blend_tiles_bwd_torch(
        torch.as_tensor(np.array(jb.attrs)),
        torch.as_tensor(start, dtype=torch.int32),
        torch.as_tensor(end, dtype=torch.int32),
        t_state, t_dstate, gx, TILE, chunk,
    )
    n = int(jb.num_pairs)
    assert n > 100
    for c in range(10):
        assert_scaled_close(out[:n, c], ref[:n, c], 1e-5, err_msg=f"channel {c}")
    assert not np_(out)[n:].any() and not np_(out)[:, 10:].any()


@pytest.mark.parametrize("P,opaque", [(200, False), (300, False), (300, True)],
                         ids=["cross_128", "cross_256", "cross_256_wall"])
def test_plain_k2_long_ranges_match_jax_bwd_call(rng, P, opaque):
    """Tile ranges that cross 128 and 256 rows (the batch and stage edges of
    the CUDA kernel, the chunk edge of the plain walk): every Gaussian is
    wide enough to touch all four tiles, so each range holds about P rows
    (256 can only be crossed with more than the 250 Gaussians the other
    parity tests keep to).  With the opaque wall every pixel latches early:
    the rows after a tile's latch are zero, as are columns 10-15."""
    if opaque:     # splats wider than the image, stacked at its centre
        jp = _wall(make_random_gaussians(P, rng, scale_range=(-0.3, 0.0),
                                         spread=0.02), P)
    else:
        jp = make_random_gaussians(P, rng, scale_range=(-1.5, -0.9), spread=0.2)
    W = H = 32
    chunk = 128
    gx, gy = W // TILE, H // TILE
    nt = gx * gy
    jcam = make_test_camera(W, H)
    jb = jax.jit(lambda p: jbins(jpre(p, jcam, 3), H, W, TILE, 2048, chunk))(jp)
    segs = (jb.seg_tile, jb.seg_k0, jb.seg_lo, jb.seg_hi, jb.seg_chunk)
    state = jax.jit(lambda a, *s: _fwd_call(a, *s, gx, gy, TILE, chunk,
                                            interpret=True))(jb.attrs, *segs)
    dstate = rng.normal(size=state.shape).astype(np.float32)
    ref = np.asarray(jax.jit(
        lambda a, st, ds, *s: _bwd_call(a, *s, st, ds, gx, gy, TILE, chunk,
                                        interpret=True)
    )(jb.attrs, state, jnp.asarray(dstate), *segs))

    start, end = jax_tile_ranges(jb, nt, chunk)
    assert (end - start).max() > (256 if P > 256 else 128)
    t_attrs = torch.as_tensor(np.array(jb.attrs))
    t_start = torch.as_tensor(start, dtype=torch.int32)
    t_end = torch.as_tensor(end, dtype=torch.int32)
    t_state = torch.as_tensor(np.array(state)[:nt, :7])
    t_dstate = torch.as_tensor(dstate[:nt, :7]).contiguous()
    t_dstate[:, 6] = 0.0
    out = torch_blend.blend_tiles_bwd_torch(
        t_attrs, t_start, t_end, t_state, t_dstate, gx, TILE, chunk)
    n = int(jb.num_pairs)
    for c in range(10):
        assert_scaled_close(out[:n, c], ref[:n, c], 1e-5, err_msg=f"channel {c}")
    assert not np_(out)[n:].any() and not np_(out)[:, 10:].any()

    # rows after the tile's last commit are exactly zero
    fwd = torch_blend.blend_tiles_torch(t_attrs, t_start, t_end, gx, TILE, chunk)
    last = fwd.n_contrib.amax(dim=1).numpy()          # 1 + position in the range
    after = [np_(out)[s + l:e] for s, l, e in zip(start, last, end)]
    assert not any(a.any() for a in after)
    if opaque:
        assert bool(fwd.done.all()) and min(len(a) for a in after) > 128


@pytest.mark.parametrize("case", list(blend_cases.EDGE_CASES))
def test_k2_edge_cases_reach_every_sum_branch(case):
    """The synthetic pair streams that the CUDA forward and backward are
    held against on the card: each has (warp, row) pairs with a commit on
    several lanes, on one lane and on none (K2's three sum branches), the
    wall latches every tile within 32 rows, and the plain backward on them
    keeps its contract: a gradient on committed rows, zeros after a tile's
    last walked row, in the dead tail and in columns 10-15."""
    table, src, ts, te = blend_cases.edge_case(case, "cpu")
    attrs = binning.pair_rows(table, src)
    gx = blend_cases.EDGE_GRID_X
    lengths, wall, _ = blend_cases.EDGE_CASES[case]
    assert (te - ts).tolist() == list(lengths) and src.shape[0] > int(te.max())
    # the table is laid out so that an indexing fault shows: shuffled
    # against the stream, rows read by two tiles, decoys no slot reads, and
    # the empty slots on the zero sentinel
    n = int(te.max())
    tile_of = torch.repeat_interleave(torch.arange(len(lengths)), te - ts)
    read = torch.unique(src[:n])
    assert not torch.equal(src[:n].long(), torch.arange(n))
    assert len(torch.unique(src[:n].long() * 16 + tile_of)) > len(read) > n // 2
    assert len(read) + blend_cases.DECOY_ROWS + 1 == table.shape[0]
    assert (src[n:] == table.shape[0] - 1).all() and not table[-1].any()
    work = blend_cases.blend_work(table, src, ts, te, gx)
    assert work["warp_rows"] > work["warp_rows_single"] > 0
    assert work["warp_rows_none"] > 0
    assert work["commits"] > 0 and work["evaluated"] >= work["exps"] >= work["commits"]
    walked = work["walked"]
    assert (walked <= te - ts).all()
    if wall:
        assert int(walked.max()) <= 32
    fwd = torch_blend.blend_tiles_torch(attrs, ts, te, gx, TILE, 128)
    assert int(fwd.n_contrib.sum()) >= work["commits"]
    state, _ = cuda_blend.blend_fwd_torch(attrs, ts, te, gx, TILE, 128)
    d_state = torch.as_tensor(np.random.default_rng(3).normal(
        size=tuple(state.shape)).astype(np.float32))
    d_state[:, 6] = 0.0
    out = torch_blend.blend_tiles_bwd_torch(attrs, ts, te, state, d_state, gx,
                                            TILE, 128)
    assert int(out[:n, :10].any(dim=1).sum()) > 0.3 * int(walked.sum())
    for s0, w, e in zip(ts.tolist(), walked.tolist(), te.tolist()):
        assert not out[s0 + w:e].any()
    assert not out[n:].any() and not out[:, 10:].any()


def test_plain_k2_matches_autograd_of_plain_blend(rng):
    """The plain K2 against autograd of the plain forward on the stream's
    rows; and the blend's autograd Function, which reads the rows through
    ``src``, gives the table the gradient ``gather_vjp`` makes of them."""
    jp = make_random_gaussians(80, rng, scale_range=(-3.0, -1.0))
    params, cam = port_params(jp), port_camera(make_test_camera(48, 32))
    with torch.no_grad():
        bins = binning.build_tile_bins(tpre(params, cam, 3), 32, 48, TILE, 4096)
    rows = binning.pair_rows(bins.table, bins.src)
    attrs = rows.clone().requires_grad_()
    c = torch_blend.blend_tiles_torch(attrs, bins.tile_start, bins.tile_end,
                                      3, TILE, 16)
    g = torch.as_tensor(rng.normal(size=(6,) + tuple(c.T.shape)),
                        dtype=torch.float32)
    fields = [c.T, c.rgb[:, 0], c.rgb[:, 1], c.rgb[:, 2], c.depth, c.acc]
    sum(torch.sum(f * gi) for f, gi in zip(fields, g)).backward()
    state, _ = cuda_blend.blend_fwd_torch(rows, bins.tile_start,
                                          bins.tile_end, 3, TILE, 16)
    d_state = torch.zeros_like(state)
    d_state[:, :6] = g.transpose(0, 1)
    out = torch_blend.blend_tiles_bwd_torch(
        rows, bins.tile_start, bins.tile_end, state, d_state, 3, TILE, 16)
    n = int(bins.num_pairs)
    for ch in range(10):
        assert_scaled_close(out[:n, ch], attrs.grad[:n, ch], 1e-5,
                            err_msg=f"channel {ch}")

    table = bins.table.clone().requires_grad_()
    c2 = cuda_blend.blend_tiles(bins._replace(table=table), 3, TILE, 16)
    for k in ("T", "depth", "acc", "n_contrib"):
        np.testing.assert_array_equal(np_(getattr(c2, k)), np_(getattr(c, k)),
                                      err_msg=k)
    fields2 = [c2.T, c2.rgb[:, 0], c2.rgb[:, 1], c2.rgb[:, 2], c2.depth, c2.acc]
    sum(torch.sum(f * gi) for f, gi in zip(fields2, g)).backward()
    ref = binning.gather_vjp(attrs.grad, bins.order, bins.offsets_p1,
                             bins.num_pairs)
    for ch in range(10):
        assert_scaled_close(table.grad[:, ch], ref[:, ch], 1e-5,
                            err_msg=f"table channel {ch}")
    assert not np_(table.grad)[:, 10:].any() and not np_(table.grad)[-1].any()


def _render_loss_weights(rng, W, H):
    wr = rng.normal(size=(3, H, W)).astype(np.float32)
    wd = rng.normal(size=(H, W)).astype(np.float32)
    return wr, wd


def _loss(out, wr, wd, lib):
    """Every differentiable output, as tests/test_pallas_blend.py."""
    return (lib.sum(out["render"] * wr) + lib.sum(out["depth"] * wd)
            + 0.3 * lib.sum(out["final_T"] ** 2) + 0.1 * lib.sum(out["acc"]))


@pytest.mark.parametrize("jax_backend,case", [
    ("pallas", "blob"), ("xla", "blob"), ("xla", "wall"), ("pallas", "wall"),
])
def test_render_tiled_gradients_match_jax(rng, jax_backend, case):
    jp, deg, chunk = _scene(rng, case)
    W = H = 32
    jcam = make_test_camera(W, H)
    bg = np.array([0.2, 0.4, 0.6], np.float32)
    wr, wd = _render_loss_weights(rng, W, H)

    def jloss(pdict, offset):
        p = JParams.from_param_pytree(pdict, jp.alive)
        out = jrender(p, jcam, jnp.asarray(bg), active_sh_degree=deg,
                      chunk=chunk, backend=jax_backend, mean2d_offset=offset)
        return _loss(out, wr, wd, jnp)

    offset = jnp.zeros((jp.capacity, 2), jnp.float32)
    jg, jg2d = jax.jit(jax.grad(jloss, argnums=(0, 1)))(jp.param_pytree(), offset)

    params = port_params(jp)
    t_off = torch.zeros((params.capacity, 2), requires_grad=True)
    out = trender(params, port_camera(jcam), torch.as_tensor(bg),
                  active_sh_degree=deg, chunk=chunk, backend="cuda",
                  mean2d_offset=t_off)
    assert not bool(out["overflow"])
    _loss(out, torch.as_tensor(wr), torch.as_tensor(wd), torch).backward()
    for name in GROUPS:
        assert_scaled_close(getattr(params, PORT_NAMES[name]).grad, jg[name],
                            5e-4, err_msg=name)
    assert_scaled_close(t_off.grad, jg2d, 5e-4, err_msg="mean2d_offset")


FIELDS = ("mean2d", "conic", "opacity", "rgb", "depth")


@pytest.mark.parametrize("pair_cap", [4096, 64])
def test_gather_vjp_matches_jax_expand_sort(rng, pair_cap):
    """The port's VJP of the row reads ``table[src]`` (plain K3, prefix
    sum, boundary gather) against the custom VJP of the JAX binning and
    against autograd of the plain row index; pair_cap 64 overflows."""
    jp = make_random_gaussians(100, rng, scale_range=(-3.0, -1.0))
    W, H, chunk = 48, 32, 16
    jcam = make_test_camera(W, H)
    jproc = jax.jit(lambda p: jpre(p, jcam, 3))(jp)
    cap = ((pair_cap + chunk - 1) // chunk) * chunk
    d = rng.normal(size=(cap, 16)).astype(np.float32)

    def jattrs(f):
        return jbins(jproc.replace(**f), H, W, TILE, pair_cap, chunk).attrs

    jf = {k: getattr(jproc, k) for k in FIELDS}
    j_out, vjp = jax.vjp(jax.jit(jattrs), jf)
    (jgrad,) = vjp(jnp.asarray(d))

    with torch.no_grad():
        tproc = tpre(port_params(jp), port_camera(jcam), 3)
    leaves = {k: getattr(tproc, k).clone().requires_grad_() for k in FIELDS}
    proc = dataclasses.replace(tproc, **leaves)
    bins = binning.build_tile_bins(proc, H, W, TILE, cap)
    assert bool(bins.overflow) == (pair_cap == 64)
    np.testing.assert_allclose(np_(binning.pair_rows(bins.table, bins.src)),
                               np_(j_out), rtol=1e-5, atol=1e-5)
    d_table = binning.gather_vjp(torch.as_tensor(d), bins.order,
                                 bins.offsets_p1, bins.num_pairs)
    bins.table.backward(d_table)

    # the plain row index under autograd: atomics-free only on the CPU
    leaves2 = {k: getattr(tproc, k).clone().requires_grad_() for k in FIELDS}
    proc2 = dataclasses.replace(tproc, **leaves2)
    pairs = binning.sort_pairs(proc2, H, W, TILE, cap)
    live = (torch.arange(cap) < pairs.total)[:, None]
    plain = binning.gaussian_attr_table(proc2)[pairs.src]
    torch.sum(plain * torch.as_tensor(d) * live).backward()

    for k in FIELDS:
        assert_scaled_close(leaves[k].grad, jgrad[k], 1e-5, err_msg=k)
        assert_scaled_close(leaves[k].grad, leaves2[k].grad, 1e-5, err_msg=k)


def test_plain_k3_matches_jax_repack_cols(rng):
    n = 1500                                    # not a multiple of 1024
    x = rng.normal(size=(n, 16)).astype(np.float32)
    ref = np.stack([np.asarray(c) for c in _repack_cols(jnp.asarray(x), 10)])
    tx = torch.as_tensor(x)
    out = cuda_repack.repack_cols(tx, torch.arange(n), torch.tensor(n))
    np.testing.assert_array_equal(np_(out), ref)

    # fused with the inverse permutation: the JAX VJP's slot-id re-sort of
    # the same columns, rows past the live count zeroed
    live = 1100
    order = np.concatenate([rng.permutation(live), np.arange(live, n)])
    j_sorted = jax.lax.sort((jnp.asarray(order, jnp.int32),
                             *_repack_cols(jnp.asarray(x), 10)), num_keys=1)
    j_slot = np.stack([np.asarray(c) for c in j_sorted[1:]])
    j_slot[:, live:] = 0.0
    out = cuda_repack.repack_cols(tx, torch.as_tensor(order), torch.tensor(live))
    np.testing.assert_array_equal(np_(out), j_slot)


K3_CASES = {
    # rows, live count, whether order is shuffled over all rows (the dead
    # rows' slots then lie in the middle of slot order) or only over the
    # live ones (the pair sort's form: the dead tail keeps slot order)
    "interleaved_dead": (1500, 1100, True),
    "sorted_dead_tail": (1500, 1100, False),
    "none_live": (1500, 0, True),
    "all_live": (1500, 1500, True),
    "overflow": (1500, 1700, True),
    "ragged_small": (77, 50, True),
    "one_row": (1, 1, True),
}


@pytest.mark.parametrize("case", list(K3_CASES))
def test_plain_k3_contract(rng, case):
    """``repack_cols`` on CPU tensors (the plain version) against a direct
    loop: any permutation, rows at or past the live count give zeros, the
    live count may exceed the row count, every output element written."""
    n, live, shuffled = K3_CASES[case]
    x = rng.normal(size=(n, 16)).astype(np.float32)
    if shuffled:
        order = rng.permutation(n)
    else:
        order = np.concatenate([rng.permutation(live), np.arange(live, n)])
    ref = np.full((10, n), np.nan, np.float32)
    for i in range(n):
        ref[:, order[i]] = x[i, :10] if i < live else 0.0
    out = cuda_repack.repack_cols(torch.as_tensor(x), torch.as_tensor(order),
                                  torch.tensor(live))
    assert out.shape == (10, n) and out.dtype == torch.float32
    np.testing.assert_array_equal(np_(out), ref)


def test_render_dense_matches_jax(rng):
    jp = make_random_gaussians(40, rng, scale_range=(-3.0, -1.0))
    W, H = 32, 32
    jcam = make_test_camera(W, H)
    bg = np.array([0.1, 0.2, 0.3], np.float32)
    wr, wd = _render_loss_weights(rng, W, H)
    ref = jax.jit(lambda p: jdense(p, jcam, jnp.asarray(bg)))(jp)
    jg = jax.jit(jax.grad(lambda pd: _loss(jdense(
        JParams.from_param_pytree(pd, jp.alive), jcam, jnp.asarray(bg)),
        wr, wd, jnp)))(jp.param_pytree())

    params = port_params(jp)
    out = tdense(params, port_camera(jcam), torch.as_tensor(bg))
    for k, atol in (("render", 1e-5), ("acc", 1e-5), ("final_T", 1e-5),
                    ("depth", 1e-4)):
        np.testing.assert_allclose(np_(out[k]), np_(ref[k]), atol=atol, err_msg=k)
    for k in ("n_contrib", "radii"):
        np.testing.assert_array_equal(np_(out[k]), np_(ref[k]), err_msg=k)
    _loss(out, torch.as_tensor(wr), torch.as_tensor(wd), torch).backward()
    for name in GROUPS:
        assert_scaled_close(getattr(params, PORT_NAMES[name]).grad, jg[name],
                            5e-4, err_msg=name)


@pytest.mark.parametrize("case", ["blob", "wall"])
def test_render_dense_recomputation_changes_nothing(monkeypatch, rng, case):
    """The oracle recomputes each chunk in its backward pass: its outputs
    and every gradient are bit-equal to those of the same chunks kept
    whole in the graph (``checkpoint`` replaced by a direct call)."""
    from luciddreamer_tpu_torch.render import dense

    jp, deg, _ = _scene(rng, case)
    W = H = 32
    cam = port_camera(make_test_camera(W, H))
    bg = torch.tensor([0.1, 0.2, 0.3])
    wr, wd = (torch.as_tensor(a) for a in _render_loss_weights(rng, W, H))

    def run():
        params = port_params(jp)
        out = tdense(params, cam, bg, active_sh_degree=deg, chunk=16)
        _loss(out, wr, wd, torch).backward()
        return out, {n: getattr(params, PORT_NAMES[n]).grad for n in GROUPS}

    out, grads = run()
    monkeypatch.setattr(dense, "checkpoint",
                        lambda fn, *args, use_reentrant: fn(*args))
    ref, ref_grads = run()
    for k in ("render", "depth", "acc", "final_T", "n_contrib"):
        assert torch.equal(out[k], ref[k]), k
    for n in GROUPS:
        # the wall renders at SH degree 0: f_rest gets no gradient
        assert torch.count_nonzero(ref_grads[n]) > 0 or (n, deg) == ("f_rest", 0), n
        assert torch.equal(grads[n], ref_grads[n]), n


def test_blend_wrappers_refuse_what_the_kernels_do_not_take():
    """K1's and K2's wrappers raise on a ``src`` that is not a contiguous
    int32 vector on the table's device, a table that is not (N, 16)
    float32, or a state of the wrong shape, before anything is launched."""
    table = torch.zeros((5, 16))
    src = torch.zeros(8, dtype=torch.int32)
    ts = te = torch.zeros(4, dtype=torch.int32)
    state = torch.zeros((4, 7, 256))
    bad = [
        (table, src.long(), ts, te), (table, src.view(2, 4), ts, te),
        (table, src[::2], ts, te), (table[:, :11], src, ts, te),
        (table.double(), src, ts, te), (table, src, ts.long(), te),
    ]
    for args in bad:
        with pytest.raises(ValueError):
            cuda_blend.blend_fwd(*args, 2)
        with pytest.raises(ValueError):
            cuda_blend.blend_bwd(*args, state, state, 2)
    with pytest.raises(ValueError, match="state"):
        cuda_blend.blend_bwd(table, src, ts, te, state[:, :6], state, 2)


def test_failed_kernel_build_raises(monkeypatch, tmp_path):
    """No fallback: a compiler that fails makes the build raise."""
    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(kernels, "_nvcc", lambda: "false")
    with pytest.raises(RuntimeError, match="nvcc failed"):
        kernels.build("blend_bwd", "repack_cols")
    assert not list(tmp_path.glob("*.so"))
