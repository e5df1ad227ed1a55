"""Tests of the port that need an NVIDIA GPU: the CUDA kernels K1, K2, K3
and the preprocess pair on the card against their plain PyTorch versions,
the CUDA path with no fallback and no stream-order copy of the attribute
rows, and a few training steps on the card.

They carry the ``cuda`` marker and skip where there is no CUDA device.
This file imports neither JAX nor the JAX package, so it also runs where
JAX is not installed (the repository's conftest.py imports JAX):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""
import numpy as np
import pytest
import torch

from luciddreamer_tpu_torch.config import GSConfig
from luciddreamer_tpu_torch.core.transforms import make_camera
from luciddreamer_tpu_torch.core.types import GaussianParams
from luciddreamer_tpu_torch.model.gaussians import DensifyStats, grow_capacity
from luciddreamer_tpu_torch.model.optim import adam_init
from luciddreamer_tpu_torch.render import (
    binning, cuda_blend, cuda_preprocess, cuda_repack, torch_blend,
)
from luciddreamer_tpu_torch.render.blend_cases import (
    EDGE_CASES, EDGE_GRID_X, blend_work, edge_case,
)
from luciddreamer_tpu_torch.render.preprocess import preprocess_gaussians
from luciddreamer_tpu_torch.render.tiled import render_tiled
from luciddreamer_tpu_torch.train.loop import Trainer

pytestmark = pytest.mark.cuda
W = H = 64


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (and nvcc) to build and run the kernels")
    return torch.device("cuda")


def _scene(P, seed, dev):
    rng = np.random.default_rng(seed)
    f32 = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=dev)
    return GaussianParams(
        xyz=f32(rng.normal(size=(P, 3)) + [0, 0, 3.0]),
        features_dc=f32(rng.normal(size=(P, 1, 3)) * 0.5),
        features_rest=f32(rng.normal(size=(P, 15, 3)) * 0.1),
        scaling=f32(rng.uniform(-3.5, -1.5, size=(P, 3))),
        rotation=f32(rng.normal(size=(P, 4))),
        opacity=f32(rng.uniform(-2.0, 3.0, size=(P, 1))),
        alive=torch.ones(P, dtype=torch.bool, device=dev),
    )


def _camera(dev):
    return make_camera(np.eye(4), 0.8279, 0.8279, W, H, device=dev)


def test_cuda_backward_launches_the_kernels(monkeypatch, dev):
    """On CUDA tensors the render's forward and backward go through K1, K2
    and K3, never through their plain versions, and no stream-order copy
    of the attribute rows is built."""
    def refuse(*a, **k):
        raise AssertionError("a plain version ran on the CUDA path")

    for mod, name in ((torch_blend, "blend_tiles_torch"),
                      (torch_blend, "blend_tiles_bwd_torch"),
                      (cuda_repack, "repack_cols_torch"),
                      (binning, "pair_rows")):
        monkeypatch.setattr(mod, name, refuse)
    params = _scene(300, 0, dev)
    before = (cuda_blend.blend_fwd.launches, cuda_blend.blend_bwd.launches,
              cuda_repack.repack_cols.launches)
    out = render_tiled(params, _camera(dev), torch.zeros(3, device=dev))
    (out["render"].sum() + out["depth"].sum()).backward()
    torch.cuda.synchronize()
    after = (cuda_blend.blend_fwd.launches, cuda_blend.blend_bwd.launches,
             cuda_repack.repack_cols.launches)
    assert [a - b for a, b in zip(after, before)] == [1, 1, 1]
    for name, p in params.named_parameters():
        assert torch.isfinite(p.grad).all(), name


K3_N = 100_003                 # not a multiple of the kernels' block
K3_CASES = {
    # live count, whether the permutation is shuffled over all rows (the dead
    # rows' slots then lie in the middle of slot order) or only over the
    # live ones (the pair sort's form)
    "k3_interleaved_dead": (60_000, True),
    "k3_sorted_dead_tail": (60_000, False),
    "k3_none_live": (0, True),
    "k3_all_live": (K3_N, True),
    "k3_overflow": (K3_N + 9, True),
}


def _k3_case(case, dev):
    live, shuffled = K3_CASES[case]
    g = torch.Generator(device=dev).manual_seed(3)
    x = torch.randn((K3_N, 16), generator=g, device=dev)
    order = torch.randperm(K3_N, generator=g, device=dev)
    if not shuffled:
        order = torch.cat([order[order < live],
                           torch.arange(live, K3_N, device=dev)])
    total = torch.tensor(live, device=dev)
    out = cuda_repack.repack_cols(x, order, total)
    assert torch.equal(out, cuda_repack.repack_cols_torch(x, order, total))
    assert torch.equal(out, cuda_repack.repack_cols(x, order, total))


def _k1_case(case, dev):
    """K1 on the synthetic tiles (ranges around every batch edge, or an
    opaque wall), whose table is shuffled against the stream, shares rows
    between tiles and holds decoy rows: n_contrib bit-equal to the plain
    version, the state within 1e-5."""
    table, src, ts, te = edge_case(case.removeprefix("k1_"), dev)
    state, n_contrib = cuda_blend.blend_fwd(table, src, ts, te, EDGE_GRID_X)
    ref_state, ref_nc = cuda_blend.blend_fwd_torch(
        binning.pair_rows(table, src), ts, te, EDGE_GRID_X, 16, 128)
    assert int(ref_nc.max()) > 0
    assert torch.equal(n_contrib, ref_nc)
    assert ((state - ref_state).abs() <= 1e-5).all()


def _k2_case(case, dev):
    """Synthetic tiles with empty ranges and ranges of 1, 31 ... 65, 127,
    128, 129, 256, 257 and more rows (the kernels' batch and stage edges,
    the plain walk's chunk edge), or an opaque wall that latches within
    the first batch; two runs bit-equal.  Each case reaches all three of
    the kernel's sum branches: (warp, row) pairs with a commit on several
    lanes, on one lane and on none."""
    table, src, ts, te = edge_case(case.removeprefix("k2_"), dev)
    work = blend_work(table, src, ts, te, EDGE_GRID_X)
    assert work["warp_rows"] > work["warp_rows_single"] > 0
    assert work["warp_rows_none"] > 0
    state, _ = cuda_blend.blend_fwd(table, src, ts, te, EDGE_GRID_X)
    g = torch.Generator(device=dev).manual_seed(3)
    d_state = torch.randn(state.shape, generator=g, device=dev)
    d_state[:, 6] = 0.0
    args = (ts, te, state, d_state)
    out = cuda_blend.blend_bwd(table, src, *args, EDGE_GRID_X)
    rerun = cuda_blend.blend_bwd(table, src, *args, EDGE_GRID_X)
    ref = torch_blend.blend_tiles_bwd_torch(binning.pair_rows(table, src),
                                            *args, EDGE_GRID_X, 16, 128)
    n = int(te.max())
    assert ref[:n, :10].any()
    scale = ref[:n, :10].abs().amax(dim=0)
    assert ((out[:n, :10] - ref[:n, :10]).abs() <= 5e-4 * scale).all()
    assert not out[:n, :10][~ref[:n, :10].any(dim=1)].any()
    assert not out[n:].any() and not out[:, 10:].any()
    assert torch.equal(out, rerun)


def _scene_case(dev):
    params = _scene(2000, 1, dev)
    cam = _camera(dev)
    with torch.no_grad():
        proc = preprocess_gaussians(params, cam, 3)
        pairs = binning.sort_pairs(proc, H, W, 16, 16384)
        table = binning.gaussian_attr_table(proc)
        state, n_contrib = cuda_blend.blend_fwd(table, pairs.src,
                                                pairs.tile_start,
                                                pairs.tile_end, W // 16)
        rows = binning.pair_rows(table, pairs.src)
        ref_state, ref_nc = cuda_blend.blend_fwd_torch(
            rows, pairs.tile_start, pairs.tile_end, W // 16, 16, 128)
        assert torch.equal(n_contrib, ref_nc)
        assert ((state - ref_state).abs() <= 1e-4).all()
        g = torch.Generator(device=dev).manual_seed(0)
        d_state = torch.randn(state.shape, generator=g, device=dev)
    args = (pairs.tile_start, pairs.tile_end, state, d_state)
    out = cuda_blend.blend_bwd(table, pairs.src, *args, W // 16)
    ref = torch_blend.blend_tiles_bwd_torch(rows, *args, W // 16, 16, 128)
    n = int(pairs.total)
    assert n > 1000
    scale = ref[:n, :10].abs().amax(dim=0)
    assert ((out[:n, :10] - ref[:n, :10]).abs() <= 5e-4 * scale).all()
    assert not out[n:].any() and not out[:, 10:].any()
    assert torch.equal(out, cuda_blend.blend_bwd(table, pairs.src, *args,
                                                 W // 16))
    assert torch.equal(cuda_repack.repack_cols(out, pairs.order, pairs.total),
                       cuda_repack.repack_cols_torch(out, pairs.order, pairs.total))

    def grads(backend):
        for t in params.parameters():
            t.grad = None
        o = render_tiled(params, cam, torch.zeros(3, device=dev), backend=backend)
        (o["render"].square().sum() + o["final_T"].sum()).backward()
        return {k: t.grad.clone() for k, t in params.named_parameters()}

    gk, gp = grads("cuda"), grads("torch")
    for k in gk:
        assert ((gk[k] - gp[k]).abs() <= 5e-4 * gp[k].abs().max()).all(), k


@pytest.mark.parametrize(
    "case", ["scene", *K3_CASES, *(f"k2_{name}" for name in EDGE_CASES),
             *(f"k1_{name}" for name in EDGE_CASES)])
def test_kernels_match_their_plain_versions(dev, case):
    """K1 with n_contrib bit-equal and the state close; K2 within 5e-4 of
    each channel's max on every live row, zero where the plain version is
    zero and beyond, two runs bit-equal; K3 bit-equal; on a rendered scene
    also the whole gradient of the cuda backend within 5e-4 of the group's
    max against the torch backend."""
    if case == "scene":
        _scene_case(dev)
    elif case in K3_CASES:
        _k3_case(case, dev)
    elif case.startswith("k1_"):
        _k1_case(case, dev)
    else:
        _k2_case(case, dev)


@pytest.mark.parametrize("deg", [0, 1, 2, 3])
def test_preprocess_kernels_match_their_plain_versions(dev, deg):
    """The preprocess forward and backward kernels against their plain
    versions on a 20k scene at 512x512 (chip_smoke.py phase 6 (b)): the
    integer outputs equal on every row, the floats within 1e-6 of each
    output's max, every gradient group within 1e-5 of its max against the
    plain backward and against autograd of the plain forward, nothing past
    the active degree; at degree 3 also at scale modifier 1.3 with an
    offset."""
    from chip_smoke import check_preprocess_case

    params = _scene(20_000, 3, dev)
    cam = make_camera(np.eye(4), 0.8279, 0.8279, 512, 512, device=dev)
    check_preprocess_case(params, cam, "20k", deg)
    if deg == 3:
        check_preprocess_case(params, cam, "20k x1.3 offset", deg, 1.3,
                              torch.zeros((20_000, 2), device=dev))


def test_preprocess_kernels_launch_once_per_render_and_step(monkeypatch, dev):
    """On CUDA tensors a render's preprocess runs the forward kernel once
    and its backward the backward kernel once, never the plain versions;
    with a mean2d offset its gradient comes from the kernel too."""
    def refuse(*a, **k):
        raise AssertionError("a plain version ran on the CUDA path")

    for name in ("preprocess_fwd_torch", "preprocess_bwd_torch"):
        monkeypatch.setattr(cuda_preprocess, name, refuse)
    params = _scene(300, 0, dev)
    offset = torch.zeros((300, 2), device=dev, requires_grad=True)
    before = (cuda_preprocess.preprocess_fwd.launches,
              cuda_preprocess.preprocess_bwd.launches)
    out = render_tiled(params, _camera(dev), torch.zeros(3, device=dev),
                       mean2d_offset=offset)
    (out["render"].sum() + out["depth"].sum()).backward()
    torch.cuda.synchronize()
    after = (cuda_preprocess.preprocess_fwd.launches,
             cuda_preprocess.preprocess_bwd.launches)
    assert [a - b for a, b in zip(after, before)] == [1, 1]
    assert offset.grad is not None and bool(offset.grad.abs().sum() > 0)
    for t in params.parameters():
        assert t.grad is not None and bool(torch.isfinite(t.grad).all())


def test_trainer_steps_on_the_card(dev):
    params = _scene(500, 2, dev)
    cams = [make_camera(np.array([[1, 0, 0, dx], [0, 1, 0, 0], [0, 0, 1, 0],
                                  [0, 0, 0, 1]], np.float64),
                        0.8279, 0.8279, W, H, device=dev) for dx in (-0.2, 0.2)]
    with torch.no_grad():
        views = [(c, render_tiled(params, c, torch.zeros(3, device=dev))["render"])
                 for c in cams]
    start = GaussianParams.from_param_dict(
        dict(params.param_dict(), f_dc=params.features_dc.detach() * 0.5),
        params.alive)
    # room for the clones and split children
    start, _, _ = grow_capacity(start, adam_init(start.param_dict()),
                                DensifyStats.zero(500, dev), 1500)
    # one densify, after step 8, that clones or splits most Gaussians
    tr = Trainer(start, GSConfig(iterations=12, densify_from_iter=7,
                                 densification_interval=8,
                                 densify_grad_threshold=1e-5), 1.0)
    losses = []
    state = tr.run(views, callback=lambda it, st, loss: losses.append(float(loss)))
    assert int(state.step) == 12 and state.params.xyz.is_cuda
    assert int(state.params.num_alive) != 500
    assert np.isfinite(losses).all()
    assert np.mean(losses[5:8]) < np.mean(losses[:3])


def _bands(params, cam, n, backend="cuda"):
    from luciddreamer_tpu_torch.parallel.sharded import _render_rows

    rows = H // 16 // n
    return [_render_rows(params, cam, torch.zeros(3, device=params.xyz.device),
                         t * rows, rows, active_sh_degree=3, tile_size=16,
                         chunk=128, pair_cap=8 * params.capacity,
                         backend=backend) for t in range(n)]


def test_band_decomposition_matches_the_whole_render(dev):
    """The tile-row bands of parallel.sharded, each through K1, stitch into
    the whole frame's render; K1 on each band against its plain version."""
    params = _scene(2000, 5, dev)
    cam = _camera(dev)
    with torch.no_grad():
        whole = render_tiled(params, cam, torch.zeros(3, device=dev), chunk=128)
        bands = _bands(params, cam, 4)
        plain = _bands(params, cam, 4, backend="torch")
    assert not any(bool(b["overflow"]) for b in bands)
    for k, dim in (("render", 1), ("depth", 0), ("acc", 0), ("n_contrib", 0)):
        torch.testing.assert_close(torch.cat([b[k] for b in bands], dim),
                                   whole[k], atol=1e-5, rtol=0)
    for b, p in zip(bands, plain):
        assert torch.equal(b["radii"], whole["radii"])
        assert torch.equal(b["n_contrib"], p["n_contrib"])
        torch.testing.assert_close(b["render"], p["render"], atol=1e-5, rtol=0)


def test_band_gradients_sum_to_the_whole_gradient(dev):
    """K1 forward, K2 backward and K3 in the binning VJP on each band: the
    bands' gradients sum to the whole render's, each launched once a band."""
    params = _scene(2000, 6, dev)
    cam = _camera(dev)
    w = torch.randn((3, H, W), generator=torch.Generator(device=dev)
                    .manual_seed(1), device=dev)

    def grads(loss):
        return torch.autograd.grad(loss, list(params.parameters()))

    ref = grads(torch.sum(render_tiled(params, cam, torch.zeros(3, device=dev),
                                       chunk=128)["render"] * w))
    for c in (cuda_blend.blend_fwd, cuda_blend.blend_bwd,
              cuda_repack.repack_cols):
        c.launches = 0
    rows = H // 4
    got = grads(sum(torch.sum(b["render"] * w[:, t * rows:(t + 1) * rows])
                    for t, b in enumerate(_bands(params, cam, 4))))
    assert (cuda_blend.blend_fwd.launches, cuda_blend.blend_bwd.launches,
            cuda_repack.repack_cols.launches) == (4, 4, 4)
    for g, r in zip(got, ref):
        scale = float(r.abs().max()) + 1e-12
        assert float((g - r).abs().max()) <= 5e-4 * scale


def test_viewer_reply_matches_direct_render(dev):
    """One SIBR request through the viewer bridge on a 20k scene at 512x512:
    the reply is the direct K1 render's bytes, and it is one K1 launch."""
    from chip_smoke import serve_requests, viewer_request
    from luciddreamer_tpu_torch.viewer import ViewerServer, frame_bytes

    params = _scene(20_000, 8, dev)
    cam = make_camera(np.eye(4), 0.8279, 0.8279, 512, 512, device=dev)
    bg = torch.zeros(3, device=dev)
    msg = viewer_request(cam)
    server = ViewerServer(port=0)
    try:
        cuda_blend.blend_fwd.launches = 0
        client, answered = serve_requests(server, params, bg, [msg],
                                          timeout=60.0)
        launches = cuda_blend.blend_fwd.launches
    finally:
        server.close()
    assert client.error is None and answered == 1 and launches == 1
    img, verify = client.replies[0]
    got = ViewerServer.camera_from_message(msg, dev)
    with torch.no_grad():
        direct = render_tiled(params, got, bg, backend="cuda")["render"]
    assert verify == "ok" and img == frame_bytes(direct)
    assert np.count_nonzero(np.frombuffer(img, np.uint8)) > 0.05 * len(img)


def test_lama_adapter_on_cuda_matches_cpu(monkeypatch, tmp_path, dev):
    """The scripted stand-in LaMa of chip_smoke.py phase 15 through the
    port's ``lama`` adapter at 512x512 on the card against the CPU: within
    1e-5 (TF32 off; the convolutions sum in another order), known pixels
    kept exactly, the model on the card."""
    from chip_smoke import scripted_lama
    from luciddreamer_tpu_torch.dream import protocols
    from luciddreamer_tpu_torch.utils import download

    path = scripted_lama(tmp_path / "big-lama.pt")
    monkeypatch.setattr(download, "fetch_checked",
                        lambda url, dest, md5=None: str(path))
    monkeypatch.setattr(protocols, "_INPAINTERS", {
        k: v for k, v in protocols._INPAINTERS.items() if k != "lama"})
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    rng = np.random.default_rng(3)
    img = torch.as_tensor(rng.uniform(size=(512, 512, 3)).astype(np.float32))
    mask = torch.zeros(512, 512)
    mask[100:300, 150:400] = 1.0
    outs = {}
    for d in (dev, torch.device("cpu")):
        inp = protocols.get_inpainter("lama", device=d)
        assert {p.device.type for p in inp.model.parameters()} == {d.type}
        outs[d.type] = inp(img.to(d), mask.to(d))
    card = outs["cuda"].cpu()
    assert outs["cuda"].device.type == "cuda"
    assert float((card - outs["cpu"]).abs().max()) <= 1e-5
    assert torch.equal(card[mask == 0], img[mask == 0])


def test_baseline_config1_tiled_matches_dense_oracle(dev):
    """BASELINE config 1 at full scale, the twin of
    tests/test_baseline_config1.py at its tolerances: 10k Gaussians (seed 3)
    at 512x512, the tiled render (K1; K2 and K3 in its backward) against
    the dense oracle, which recomputes each chunk in its backward, on RGB,
    depth and every parameter group's gradient."""
    from luciddreamer_tpu_torch.render.dense import render_dense
    from luciddreamer_tpu_torch.smoke import config1_scene

    rng = np.random.default_rng(3)
    P, S = 10_000, 512
    params = config1_scene(rng, P, dev)
    cam = make_camera(np.eye(4), 0.8279, 0.8279, S, S, device=dev)
    bg = torch.zeros(3, device=dev)
    tiled = lambda p: render_tiled(p, cam, bg, pair_cap=300_000, chunk=128)
    with torch.no_grad():
        t_out = tiled(params)
        d_out = render_dense(params, cam, bg)
    assert not bool(t_out["overflow"])
    np.testing.assert_allclose(t_out["render"].cpu().numpy(),
                               d_out["render"].cpu().numpy(), atol=1e-5)
    np.testing.assert_allclose(t_out["depth"].cpu().numpy(),
                               d_out["depth"].cpu().numpy(), atol=5e-4)

    tgt = torch.as_tensor(rng.uniform(size=(3, S, S)), dtype=torch.float32,
                          device=dev)

    def grads(render):
        out = render(params)
        loss = ((out["render"] - tgt).abs().mean()
                + 0.1 * out["depth"].mean())
        return torch.autograd.grad(loss, list(params.parameters()))

    names = list(params.param_dict())
    for k, a, b in zip(names, grads(tiled),
                       grads(lambda p: render_dense(p, cam, bg))):
        a, b = a.cpu().numpy(), b.cpu().numpy()
        assert np.isfinite(a).all(), k
        err = np.abs(a - b) / (np.max(np.abs(b)) + 1e-12)
        assert np.mean(err <= 5e-3) > 0.9999, (k, np.mean(err <= 5e-3))
        assert np.max(err) < 5e-2, (k, np.max(err))


def test_entry_and_bench_step_on_the_card(dev):
    """entry()'s fn on the card against the same fn on CPU copies of its
    arguments (render 1e-5, depth 5e-4), and one bench step at a small
    shape through K1, K2 and K3, once each."""
    from luciddreamer_tpu_torch import bench
    from luciddreamer_tpu_torch.smoke import graft_entry

    res = graft_entry(dev)
    assert res["misses"] == [] and res["shape"] == (3, 256, 256), res
    step = bench.fwd_bwd(bench.bench_scene(2000, device=dev), _camera(dev),
                         torch.zeros(3, device=dev), 40_000, 128)
    before = bench.launch_counts()
    s, grads, out = step(torch.zeros((), device=dev))
    after = bench.launch_counts()
    assert not bool(out["overflow"]) and bool(torch.isfinite(s))
    assert {k: after[k] - before[k] for k in after} == dict.fromkeys(after, 1)


def test_exact_knn_kernel_matches_its_plain_version(dev):
    """knn3_exact on 20k seeded points bit-equal to its plain version (the
    same operations in the same order, -fmad=false), one launch."""
    from luciddreamer_tpu_torch.points import knn_exact

    pts = torch.as_tensor(np.random.default_rng(3).normal(size=(20_000, 3))
                          .astype(np.float32), device=dev)
    before = knn_exact.mean_sq_dist_3nn_exact.launches
    out = knn_exact.mean_sq_dist_3nn_exact(pts)
    torch.cuda.synchronize()
    assert knn_exact.mean_sq_dist_3nn_exact.launches == before + 1
    assert torch.equal(out, knn_exact.mean_sq_dist_3nn_exact_torch(pts))


def test_grad_overlap_report_in_a_world_of_one(dev):
    """The overlap twin in an NCCL world of one at a small size: no
    collective window, K1-K3 once per step in each trace, the two steps
    agreeing, a verdict."""
    import socket

    import torch.distributed as dist

    from luciddreamer_tpu_torch import grad_overlap
    from luciddreamer_tpu_torch.parallel import make_mesh, multihost

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    assert multihost.initialize(f"127.0.0.1:{port}", 1, 0, device=dev)
    try:
        rep = grad_overlap.run(make_mesh(1, 1, device=dev), dev,
                               capacity=20_000, size=256, pair_cap=200_000,
                               steps=2, warmup=1)
    finally:
        dist.destroy_process_group()
    for name in ("batch", "overlapped"):
        assert rep[name]["windows"] == 0 and not rep[name]["overflow"]
        assert rep[name]["kernels"] == dict.fromkeys(
            ("blend_fwd", "blend_bwd", "repack_cols"), 1.0)
        assert rep[name]["device_ms"] > 0
    assert rep["agreement"]["ok"], rep["agreement"]
    assert grad_overlap.report_lines(rep)[-1].startswith("VERDICT: neither")
