"""Port parity of the programs that run the JAX package on its chip, on the
CPU: ``luciddreamer_tpu_torch.entry`` against ``__graft_entry__.entry``
(render atol 1e-5, depth 5e-4, at entry's full size), the bench's scene
bit-equal to ``bench.py:46-58``'s draws, the bench step's loss and
gradients against the JAX tiled render (``backend="xla"``; gradients atol
5e-4 scaled by the group's max, as tests/test_pallas_blend.py), the
bench's JSON line, the profile's four stages, and the hardware gate's
drives (``luciddreamer_tpu_torch.smoke``) at a small size.

The programs themselves run on the card (``chip_smoke.py`` phase 16); here
every kernel wrapper runs its plain version, since the tensors lie on the
CPU.
"""
import contextlib
import io
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__
from luciddreamer_tpu.core.transforms import make_camera as jmake_camera
from luciddreamer_tpu.core.types import GaussianParams as JParams
from luciddreamer_tpu.render.tiled import render_tiled as jrender
from luciddreamer_tpu_torch import bench, entry, profile_step, smoke
from luciddreamer_tpu_torch.core.transforms import make_camera
from tests.port_helpers import (  # noqa: F401  (one_torch_thread: a fixture)
    assert_scaled_close, np_, one_torch_thread,
)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

BENCH_KEYS = ["metric", "value", "unit", "vs_baseline"]


def _bench_py_params(P):
    """``bench.py:46-58``, with its P."""
    rng = np.random.default_rng(42)
    return JParams(
        xyz=jnp.asarray(rng.normal(size=(P, 3)) + [0, 0, 3.0], jnp.float32),
        features_dc=jnp.asarray(rng.normal(size=(P, 1, 3)) * 0.5, jnp.float32),
        features_rest=jnp.asarray(rng.normal(size=(P, 15, 3)) * 0.1, jnp.float32),
        scaling=jnp.asarray(rng.uniform(-5.5, -3.5, size=(P, 3)), jnp.float32),
        rotation=jnp.asarray(rng.normal(size=(P, 4)), jnp.float32),
        opacity=jnp.asarray(rng.uniform(-2.0, 3.0, size=(P, 1)), jnp.float32),
        alive=jnp.ones(P, bool),
    )


def test_entry_matches_graft_entry():
    fn, args = entry.entry(device="cpu")
    params, camera, bg = args
    assert (camera.height, camera.width, params.capacity) == (256, 256, 2048)
    with torch.no_grad():
        render, depth = fn(*args)
    jfn, jargs = __graft_entry__.entry()
    ref_render, ref_depth = jax.jit(jfn)(*jargs)
    assert render.shape == (3, 256, 256) and depth.shape == (256, 256)
    assert float(render.amax()) > 0.1
    np.testing.assert_allclose(np_(render), np.asarray(ref_render), atol=1e-5)
    np.testing.assert_allclose(np_(depth), np.asarray(ref_depth), atol=5e-4)
    assert entry.dryrun_multichip.__module__.endswith("parallel.dryrun")


def test_entry_points_need_the_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (entry.entry, bench.run, profile_step.run,
                 smoke.baseline_config1, smoke.drive_20k, smoke.bench_shape,
                 smoke.graft_entry):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()


def test_bench_scene_is_bench_py_draws():
    P = 257
    ours = bench.bench_scene(P, device="cpu")
    ref = _bench_py_params(P)
    for name, group in (("xyz", "xyz"), ("features_dc", "f_dc"),
                        ("features_rest", "f_rest"), ("scaling", "scaling"),
                        ("rotation", "rotation"), ("opacity", "opacity")):
        np.testing.assert_array_equal(np_(getattr(ours, name)),
                                      np.asarray(getattr(ref, name)), err_msg=group)
    assert bool(ours.alive.all())


def test_bench_step_matches_jax_xla():
    """The bench's loss and every gradient group at P 250 and 48x48, the
    bench's chunk, against JAX's tiled render with the XLA blend."""
    P, S, cap, chunk = 250, 48, 8192, 384
    jp = _bench_py_params(P)
    jcam = jmake_camera(np.eye(4), 0.8279, 0.8279, S, S)

    def jloss(pdict):
        out = jrender(JParams.from_param_pytree(pdict, jp.alive), jcam,
                      jnp.zeros(3), active_sh_degree=3, chunk=chunk,
                      pair_cap=cap, backend="xla")
        loss = (jnp.mean(jnp.abs(out["render"] - 0.5))
                + 0.1 * jnp.mean(out["depth"]))
        return loss, (out["num_pairs"], out["overflow"])

    (ref_loss, (ref_pairs, ref_ovf)), ref_g = jax.jit(
        jax.value_and_grad(jloss, has_aux=True))(jp.param_pytree())
    cam = make_camera(np.eye(4), 0.8279, 0.8279, S, S, device="cpu")
    step = bench.fwd_bwd(bench.bench_scene(P, device="cpu"), cam,
                         torch.zeros(3), cap, chunk)
    s, grads, out = step(torch.zeros(()))
    assert not bool(out["overflow"]) and not bool(ref_ovf)
    assert int(out["num_pairs"]) == int(ref_pairs) > 50
    np.testing.assert_allclose(float(bench.bench_loss(out).detach()), float(ref_loss),
                               rtol=1e-5)
    for name, g in grads.items():
        assert_scaled_close(g, ref_g[name], 5e-4, err_msg=name)
    total = sum(float(np.asarray(v, np.float64).sum()) for v in ref_g.values())
    np.testing.assert_allclose(float(s), total, rtol=1e-4)


def test_bench_prints_bench_py_line(capsys):
    res = bench.run(P=300, size=32, pair_cap=8192, chunk=64, k1=1, k2=2,
                    reps=1, device="cpu")
    lines = capsys.readouterr().out.strip().splitlines()
    last = json.loads(lines[-1])
    assert list(last) == BENCH_KEYS
    assert last["metric"] == "rays_per_s_fwd_bwd_1M_gaussians_512px"
    assert last["unit"] == "rays/s/chip" and last["value"] > 0
    assert last["vs_baseline"] == round(last["value"] / bench.ANCHOR_RAYS_PER_S, 3)
    assert res["device_ms"] is None and res["peak_bytes"] is None
    assert 0 < res["num_pairs"] <= 8192
    assert any("not measured" in line for line in lines[:-1])


def test_profile_stages_are_finite():
    params = bench.bench_scene(300, device="cpu")
    cam = make_camera(np.eye(4), 0.8279, 0.8279, 32, 32, device="cpu")
    stages = profile_step.stages(params, cam, torch.zeros(3), 8192, 64)
    assert [n for n, _ in stages] == ["preprocess fwd", "prep+binning fwd",
                                      "full fwd", "full fwd+bwd"]
    for name, fn in stages:
        v = fn(torch.zeros(()))
        assert v.shape == () and bool(torch.isfinite(v)), name
    with contextlib.redirect_stdout(io.StringIO()) as out:
        rows = profile_step.run(P=300, pair_cap=8192, chunk=64, size=32, k1=1,
                                k2=2, reps=1, device="cpu")
    assert [r["stage"] for r in rows] == [n for n, _ in stages]
    assert all(np.isfinite(r["wall_ms"]) and r["device_ms"] is None for r in rows)
    assert len(out.getvalue().splitlines()) == 5


@pytest.mark.parametrize("drive", ["baseline_config1", "drive_20k",
                                   "bench_shape", "graft_entry"])
def test_smoke_drives_pass_on_a_small_scene(monkeypatch, drive):
    """The hardware gate's drives on the CPU at 48x48 and a few hundred
    Gaussians (the plain blend against the dense oracle), at their own
    tolerances."""
    monkeypatch.setattr(smoke, "SIZE", 48)
    monkeypatch.setattr(smoke, "CROP", slice(8, 40))
    for name, P, cap in (("CONFIG1", 200, 8192), ("DRIVE_20K", 300, 8192),
                         ("BENCH_SHAPE", 1000, 20_000)):
        monkeypatch.setitem(getattr(smoke, name), "P", P)
        monkeypatch.setitem(getattr(smoke, name), "pair_cap", cap)
    res = getattr(smoke, drive)("cpu")
    assert res["misses"] == [], res
    if drive != "graft_entry":
        assert res["num_pairs"] > 20 and not res["overflow"]
    if drive == "baseline_config1":
        assert set(res["groups"]) == {"xyz", "f_dc", "f_rest", "scaling",
                                      "rotation", "opacity"}
