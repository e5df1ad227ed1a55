"""Port parity: forward binning and the blend math of
``luciddreamer_tpu_torch`` against ``luciddreamer_tpu`` (CPU).

The pair stream must come out in exactly the JAX package's (tile, depth
rank) order: sorted attribute rows (the port's ``table[src]``) allclose,
each sorted pair's table row ``src`` the owner Gaussian that JAX's
expansion gives it, and per-tile ranges equal.  The JAX side keeps its
ranges in segment metadata; the test derives them.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from luciddreamer_tpu.render import blend_math as jbm
from luciddreamer_tpu.render.binning import build_tile_bins as jbins
from luciddreamer_tpu.render.preprocess import preprocess_gaussians as jpre
from luciddreamer_tpu_torch.render import blend_math as tbm
from luciddreamer_tpu_torch.render.binning import build_tile_bins as tbins
from luciddreamer_tpu_torch.render.binning import pair_rows
from luciddreamer_tpu_torch.render.preprocess import preprocess_gaussians as tpre
from tests.helpers import make_random_gaussians, make_test_camera
from tests.port_helpers import jax_tile_ranges, np_, port_camera, port_params

TILE = 16


def _both(jp, W, H, pair_cap, chunk):
    jcam = make_test_camera(W, H)
    jb = jax.jit(
        lambda p: jbins(jpre(p, jcam, 3), H, W, TILE, pair_cap, chunk)
    )(jp)
    with torch.no_grad():
        tb = tbins(tpre(port_params(jp), port_camera(jcam), 3), H, W, TILE,
                   pair_cap)
    return jb, tb


@pytest.mark.parametrize("case", ["blob", "depth_ties"])
def test_tile_bins_match(rng, case):
    P, W, H, chunk = 150, 48, 32, 32
    jp = make_random_gaussians(P, rng, scale_range=(-3.5, -1.0))
    if case == "depth_ties":
        # groups of equal view depth: the index must break the ties
        xyz = np.asarray(jp.xyz).copy()
        xyz[:, 2] = np.round(xyz[:, 2] * 4) / 4
        jp = jp.replace(xyz=jnp.asarray(xyz))
    jb, tb = _both(jp, W, H, pair_cap=4096, chunk=chunk)
    total = int(jb.num_pairs)
    assert total > 100 and not bool(jb.overflow)
    assert int(tb.num_pairs) == total and not bool(tb.overflow)
    rows = np_(pair_rows(tb.table, tb.src))
    np.testing.assert_allclose(rows[:total], np_(jb.attrs)[:total],
                               rtol=1e-5, atol=1e-5)
    assert not rows[total:].any()
    start, end = jax_tile_ranges(jb, (W // TILE) * (H // TILE), chunk)
    np.testing.assert_array_equal(np_(tb.tile_start), start)
    np.testing.assert_array_equal(np_(tb.tile_end), end)


def test_tile_bins_overflow_matches(rng):
    jp = make_random_gaussians(120, rng, scale_range=(-2.5, -1.0))
    jb, tb = _both(jp, 32, 32, pair_cap=64, chunk=16)
    assert bool(jb.overflow) and bool(tb.overflow)
    assert int(tb.num_pairs) == int(jb.num_pairs) > 64
    # the first pair_cap slots survive, in the same order
    np.testing.assert_allclose(np_(pair_rows(tb.table, tb.src)), np_(jb.attrs),
                               rtol=1e-5, atol=1e-5)
    start, end = jax_tile_ranges(jb, 4, 16)
    np.testing.assert_array_equal(np_(tb.tile_start), start)
    np.testing.assert_array_equal(np_(tb.tile_end), end)


@pytest.mark.parametrize("case", ["blob", "overflow"])
def test_src_is_the_owner_jax_expands(rng, case):
    """``src`` is contiguous int32; each live sorted pair's entry is the
    Gaussian that JAX's expansion places in that sorted row (read back from
    JAX's sorted rows with each Gaussian's index as its opacity), and each
    empty slot's is the sentinel row P."""
    P, W, H = 150, 48, 32
    jp = make_random_gaussians(P, rng, scale_range=(-3.5, -1.0))
    pair_cap, chunk = (4096, 32) if case == "blob" else (64, 16)
    jcam = make_test_camera(W, H)
    jproc = jax.jit(lambda p: jpre(p, jcam, 3))(jp)
    tagged = jproc.replace(opacity=jnp.arange(P, dtype=jnp.float32))
    jb = jax.jit(lambda q: jbins(q, H, W, TILE, pair_cap, chunk))(tagged)
    with torch.no_grad():
        tb = tbins(tpre(port_params(jp), port_camera(jcam), 3), H, W, TILE,
                   pair_cap)
    src = tb.src
    assert src.dtype == torch.int32 and src.is_contiguous()
    assert src.shape == (jb.attrs.shape[0],) and tb.table.shape == (P + 1, 16)
    total = int(tb.num_pairs)
    live = min(total, src.shape[0])
    assert bool(tb.overflow) == (case == "overflow") and live > 50
    owner = np.asarray(jb.attrs)[:live, 5]
    np.testing.assert_array_equal(np_(src)[:live], owner.astype(np.int32))
    assert (np_(src)[live:] == P).all()


def _carry_pair(rng, n):
    T = rng.uniform(1e-3, 1.0, n).astype(np.float32)
    rgb = rng.uniform(size=(3, n)).astype(np.float32)
    depth = rng.uniform(size=n).astype(np.float32)
    acc = rng.uniform(size=n).astype(np.float32)
    done = rng.uniform(size=n) < 0.2
    nc = rng.integers(0, 5, n).astype(np.int32)
    j = jbm.BlendCarry(T=jnp.asarray(T), rgb=jnp.asarray(rgb),
                       depth=jnp.asarray(depth), acc=jnp.asarray(acc),
                       done=jnp.asarray(done), n_contrib=jnp.asarray(nc))
    t = tbm.BlendCarry(T=torch.as_tensor(T), rgb=torch.as_tensor(rgb),
                       depth=torch.as_tensor(depth), acc=torch.as_tensor(acc),
                       done=torch.as_tensor(done), n_contrib=torch.as_tensor(nc))
    return j, t


def test_blend_chunk_and_finalize_match(rng):
    K, N = 24, 64
    jc, tc = _carry_pair(rng, N)
    dx = rng.normal(size=(K, N)).astype(np.float32) * 2
    dy = rng.normal(size=(K, N)).astype(np.float32) * 2
    ca, cc = (rng.uniform(0.1, 1.0, (K, 1)).astype(np.float32) for _ in range(2))
    cb = rng.uniform(-0.05, 0.05, (K, 1)).astype(np.float32)
    op = rng.uniform(0.0, 1.0, (K, 1)).astype(np.float32)
    op[:4] = 1.0                                    # exercise the 0.99 clamp
    jargs = [jnp.asarray(v) for v in (dx, dy, ca, cb, cc, op)]
    targs = [torch.as_tensor(v) for v in (dx, dy, ca, cb, cc, op)]
    ja, jin = jbm.gaussian_alpha(*jargs)
    ta, tin = tbm.gaussian_alpha(*targs)
    np.testing.assert_allclose(np_(ta), np_(ja), rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(np_(tin), np_(jin))
    jvalid = jin & (ja >= jbm.ALPHA_MIN)
    tvalid = tin & (ta >= tbm.ALPHA_MIN)
    rgb = rng.uniform(size=(K, 3)).astype(np.float32)
    dep = rng.uniform(1, 5, K).astype(np.float32)
    jout = jbm.blend_chunk(jc, ja, jvalid, jnp.asarray(rgb), jnp.asarray(dep),
                           jnp.int32(7))
    tout = tbm.blend_chunk(tc, ta, tvalid, torch.as_tensor(rgb),
                           torch.as_tensor(dep), 7)
    for k in ("T", "rgb", "depth", "acc"):
        np.testing.assert_allclose(np_(getattr(tout, k)), np_(getattr(jout, k)),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    for k in ("done", "n_contrib"):
        np.testing.assert_array_equal(np_(getattr(tout, k)), np_(getattr(jout, k)),
                                      err_msg=k)
    bg = np.array([0.1, 0.5, 0.9], np.float32)
    jrgb, jdepth = jbm.finalize(jout, jnp.asarray(bg))
    trgb, tdepth = tbm.finalize(tout, torch.as_tensor(bg))
    np.testing.assert_allclose(np_(trgb), np_(jrgb), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(np_(tdepth), np_(jdepth), rtol=1e-5, atol=1e-6)
