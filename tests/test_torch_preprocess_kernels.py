"""The preprocess layer's kernel pair (``render/cuda_preprocess.py``) on the
CPU: its plain versions against autograd and against the JAX package, the
differentiable entry point through ``render_tiled``, and the wrapper's
contract.  The CUDA kernels themselves run only on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).

Scenes keep to P <= 250 and 32-48 px images, with spread 2.0 (some
Gaussians behind the near plane) and dead capacity rows, plus rows built
to sit exactly on the boundaries where autograd picks a subgradient: the
near clamp of the view depth, the w clamp of the projection, both sides of
the 1.3 tan(fov / 2) clamp, the rgb clamp at 0 and a mean on the camera
centre.  Tolerances are relative to each gradient group's max |ref|.
"""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from luciddreamer_tpu.core.types import GaussianParams as JParams
from luciddreamer_tpu.render.preprocess import preprocess_gaussians as jpre
from luciddreamer_tpu_torch.core import sh as shlib
from luciddreamer_tpu_torch.core.transforms import make_camera
from luciddreamer_tpu_torch.core.types import GaussianParams
from luciddreamer_tpu_torch.render import cuda_preprocess as cp
from luciddreamer_tpu_torch.render import kernels, tiled
from luciddreamer_tpu_torch.render.preprocess import preprocess_gaussians
from tests.helpers import make_random_gaussians, make_test_camera
from tests.port_helpers import (  # noqa: F401  (one_torch_thread: a fixture)
    assert_scaled_close, np_, one_torch_thread, port_camera, port_params,
)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

GROUPS = ("xyz", "f_dc", "f_rest", "scaling", "rotation", "opacity")
OUTPUTS = ("mean2d", "depth", "conic", "opacity", "rgb")
W, H = 48, 32
P, CAPACITY = 200, 220
N_BOUNDARY = 6          # rows of _scene on the subgradient boundaries


def _camera(dtype):
    cam = make_camera(np.eye(4), 0.8279, 0.8279, W, H, device="cpu")
    move = lambda t: t.to(dtype)
    return dataclasses.replace(
        cam, viewmatrix=move(cam.viewmatrix), projmatrix=move(cam.projmatrix),
        campos=move(cam.campos), tanfovx=move(cam.tanfovx),
        tanfovy=move(cam.tanfovy))


def _scene(seed, dtype, cam):
    """Raw parameters (dict of tensors), alive: P random Gaussians in a
    capacity of CAPACITY, the first rows on the subgradient boundaries.
    The identity camera's view depth and projective w are both z, and its
    view x, y are x, y."""
    rng = np.random.default_rng(seed)
    jp = make_random_gaussians(P, rng, sh_degree=3, spread=2.0,
                               scale_range=(-3.5, -1.0), capacity=CAPACITY)
    p = {k: torch.tensor(np.array(v), dtype=dtype)
         for k, v in jp.param_pytree().items()}
    row = lambda *v: torch.tensor(v, dtype=dtype)
    limx = float(1.3 * cam.tanfovx)
    limy = float(1.3 * cam.tanfovy)
    xyz = p["xyz"]
    xyz[0] = row(0.1, -0.2, 0.01)         # view z on its 0.01 clamp
    xyz[1] = row(0.3, 0.1, 1e-3)          # w on its 1e-3 clamp
    xyz[2] = row(limx, 0.2, 1.0)          # x / z on +1.3 tan(fov/2)
    xyz[3] = row(-limx, -limy, 1.0)       # x, y / z on -1.3 tan(fov/2)
    xyz[5] = 0.0                          # on the camera centre
    # row 4: rgb exactly on its clamp at 0, C0 * dc + 0.5 == 0
    p["f_rest"][4] = 0.0
    dc = torch.tensor(-0.5 / shlib.C0, dtype=dtype)
    for step in range(16):         # the nearest value whose product is -0.5
        toward = torch.tensor(1.0 if step % 2 else -1.0, dtype=dtype)
        for _ in range(step // 2):
            dc = torch.nextafter(dc, toward)
        if float(shlib.C0 * dc) == -0.5:
            break
    assert float(shlib.C0 * dc) == -0.5
    p["f_dc"][4] = dc
    return p, torch.tensor(np.array(jp.alive))


def _cotangents(seed, n, dtype):
    rng = np.random.default_rng(seed)
    return [torch.as_tensor(rng.normal(size=s), dtype=dtype)
            for s in ((n, 2), (n,), (n, 3), (n,), (n, 3))]


def _autograd(p, alive, cam, deg, sm, cot, with_offset):
    leaves = {k: v.clone().requires_grad_(True) for k, v in p.items()}
    offset = (torch.zeros((CAPACITY, 2), dtype=p["xyz"].dtype, requires_grad=True)
              if with_offset else None)
    proc = cp.preprocess_fwd_torch(*leaves.values(), alive, cam, deg, 16, sm,
                                   0.2, offset)
    loss = sum((getattr(proc, k) * g).sum() for k, g in zip(OUTPUTS, cot))
    ins = list(leaves.values()) + ([offset] if with_offset else [])
    return torch.autograd.grad(loss, ins)


@pytest.mark.parametrize("with_offset", [False, True], ids=["no_offset", "offset"])
@pytest.mark.parametrize("deg", [0, 1, 2, 3])
def test_plain_backward_is_autograd_float64(deg, with_offset):
    """The derivation by hand against autograd of the plain forward, in
    float64: within 1e-10 of each group's max, which only a wrong term could
    miss (two orders of the same float64 sums differ near 1e-16).  Also
    checks that the rows on the boundaries take autograd's subgradients and
    that coefficients past the active degree get exactly 0."""
    cam = _camera(torch.float64)
    p, alive = _scene(deg, torch.float64, cam)
    cot = _cotangents(7, CAPACITY, torch.float64)
    sm = 1.3 if with_offset else 1.0
    ref = _autograd(p, alive, cam, deg, sm, cot, with_offset)
    got = cp.preprocess_bwd_torch(*p.values(), cam, deg, sm, *cot)
    for name, r, g in zip(GROUPS + ("mean2d_offset",), ref, got):
        if r.numel():
            assert_scaled_close(g, r, 1e-10, err_msg=name)
            # the boundary rows, each to its own scale: rows near z = 0
            # take gradients far above the others'
            for i in range(N_BOUNDARY):
                assert_scaled_close(g[i], r[i], 1e-10, err_msg=f"{name} row {i}")
    n_act = (deg + 1) ** 2
    assert not got[2][:, n_act - 1:].any()
    assert got[0][:6].abs().max() > 0


@pytest.mark.parametrize("deg", [0, 3])
def test_plain_backward_is_autograd_float32(deg):
    """The same in float32 at scale_modifier 1.3: within 1e-5 of each
    group's max, the rounding of two orders of the same fp32 sums (a few
    ulps of the largest terms) with a wide margin."""
    cam = _camera(torch.float32)
    p, alive = _scene(10 + deg, torch.float32, cam)
    cot = _cotangents(8, CAPACITY, torch.float32)
    ref = _autograd(p, alive, cam, deg, 1.3, cot, True)
    got = cp.preprocess_bwd_torch(*p.values(), cam, deg, 1.3, *cot)
    for name, r, g in zip(GROUPS + ("mean2d_offset",), ref, got):
        if r.numel():
            assert_scaled_close(g, r, 1e-5, err_msg=name)


@pytest.mark.parametrize("deg", [0, 1, 2, 3])
def test_plain_backward_matches_jax_grad(rng, deg):
    """``preprocess_bwd_torch`` against ``jax.grad`` of the JAX package's
    preprocess on the same numpy-seeded scene, camera and cotangents, at
    the tolerance the render gradients are held to in
    tests/test_torch_backward.py (5e-4 of each group's max): the two
    frameworks round and fuse differently."""
    jp = make_random_gaussians(P, rng, sh_degree=3, spread=2.0,
                               scale_range=(-3.5, -1.0), capacity=CAPACITY)
    jcam = make_test_camera(W, H)
    cot = [rng.normal(size=s).astype(np.float32)
           for s in ((CAPACITY, 2), (CAPACITY,), (CAPACITY, 3), (CAPACITY,),
                     (CAPACITY, 3))]

    def jloss(pdict, offset):
        params = JParams.from_param_pytree(pdict, jp.alive)
        proc = jpre(params, jcam, deg, 16, 1.3, 0.2, offset)
        return sum(jnp.sum(getattr(proc, k) * c) for k, c in zip(OUTPUTS, cot))

    offset = jnp.zeros((CAPACITY, 2), jnp.float32)
    jg, jg2d = jax.jit(jax.grad(jloss, argnums=(0, 1)))(jp.param_pytree(), offset)
    tp = port_params(jp)
    raw = (tp.xyz, tp.features_dc, tp.features_rest, tp.scaling, tp.rotation,
           tp.opacity)
    got = cp.preprocess_bwd_torch(*(t.detach() for t in raw), port_camera(jcam),
                                  deg, 1.3, *map(torch.as_tensor, cot))
    for name, g in zip(GROUPS, got):
        assert_scaled_close(g, jg[name], 5e-4, err_msg=name)
    assert_scaled_close(got[6], jg2d, 5e-4, err_msg="mean2d_offset")


def _render_grads(params, deg, offset_grad=True):
    for t in params.parameters():
        t.grad = None
    off = torch.zeros((params.capacity, 2), requires_grad=offset_grad)
    cam = port_camera(make_test_camera(32, 32))
    out = tiled.render_tiled(params, cam, torch.tensor([0.2, 0.4, 0.6]),
                             active_sh_degree=deg, chunk=32, mean2d_offset=off)
    (out["render"].square().sum() + out["depth"].sum()
     + 0.3 * out["final_T"].sum()).backward()
    return out, [t.grad for t in params.parameters()] + [off.grad]


@pytest.mark.parametrize("deg", [0, 3])
def test_entry_point_through_render_tiled(monkeypatch, rng, deg):
    """``cuda_preprocess.preprocess`` on CPU tensors (the Function with the
    plain forward and the hand-derived backward) in place of the autograd
    path inside ``render_tiled``: every output equal (the same forward),
    every gradient within 1e-5 of its group's max (two fp32 orders of the
    same sums)."""
    params = port_params(make_random_gaussians(80, rng, scale_range=(-3.0, -1.0),
                                               capacity=90))
    ref, ref_g = _render_grads(params, deg)
    monkeypatch.setattr(tiled, "preprocess_gaussians", cp.preprocess)
    before = cp.preprocess_fwd.launches, cp.preprocess_bwd.launches
    out, got_g = _render_grads(params, deg)
    assert (cp.preprocess_fwd.launches, cp.preprocess_bwd.launches) == before
    for k in ("render", "depth", "acc", "final_T", "n_contrib", "radii"):
        assert torch.equal(out[k], ref[k]), k
    assert int(ref["num_pairs"]) > 100
    for name, g, r in zip(GROUPS + ("mean2d_offset",), got_g, ref_g):
        assert_scaled_close(g, r, 1e-5, err_msg=name)


def test_entry_point_forward_equals_the_autograd_path(rng):
    """On CPU tensors the entry point's forward is the plain forward, which
    ``preprocess_gaussians`` runs: equal outputs, and the integer outputs
    carry no gradient."""
    params = port_params(make_random_gaussians(P, rng, spread=2.0,
                                               capacity=CAPACITY))
    cam = port_camera(make_test_camera(W, H))
    got = cp.preprocess(params, cam, 3, 16, 1.3, 0.2)
    ref = preprocess_gaussians(params, cam, 3, 16, 1.3, 0.2)
    for f in dataclasses.fields(ref):
        assert torch.equal(getattr(got, f.name), getattr(ref, f.name)), f.name
    for k in cp._INT_FIELDS:
        assert not getattr(got, k).requires_grad
    assert got.rgb.requires_grad and got.conic.requires_grad


def test_pack_camera_layout():
    cam = _camera(torch.float32)
    packed = cp.pack_camera(cam)
    assert packed.shape == (cp.CAM_LEN,) and packed.dtype == torch.float32
    assert torch.equal(packed[:16], cam.viewmatrix.reshape(16))
    assert torch.equal(packed[16:32], cam.projmatrix.reshape(16))
    assert torch.equal(packed[32:35], cam.campos)
    want = torch.stack([cam.focal_x, cam.focal_y, 1.3 * cam.tanfovx,
                        1.3 * cam.tanfovy])
    assert torch.equal(packed[35:], want)


def _kernel_inputs(**change):
    cam = _camera(torch.float32)
    p, alive = _scene(0, torch.float32, cam)
    args = dict(xyz=p["xyz"], f_dc=p["f_dc"], f_rest=p["f_rest"],
                scaling=p["scaling"], rotation=p["rotation"],
                opacity=p["opacity"], alive=alive, cam=cp.pack_camera(cam),
                width=W, height=H, active_sh_degree=3)
    args.update(change)
    return args


BAD_INPUTS = {
    "float64": dict(xyz=torch.zeros((CAPACITY, 3), dtype=torch.float64)),
    "rotation_shape": dict(rotation=torch.zeros((CAPACITY, 3))),
    "strided_f_rest": dict(f_rest=torch.zeros((CAPACITY, 3, 15)).transpose(1, 2)),
    "alive_float": dict(alive=torch.ones(CAPACITY)),
    "camera_length": dict(cam=torch.zeros(cp.CAM_LEN - 1)),
    "degree_4": dict(active_sh_degree=4),
    "too_few_coefficients": dict(f_rest=torch.zeros((CAPACITY, 8, 3))),
    "cpu_tensors": {},
}


@pytest.mark.parametrize("case", BAD_INPUTS)
def test_wrapper_rejects_what_the_kernel_does_not_take(case):
    """The launch wrappers raise before any launch on a wrong dtype, shape,
    layout or degree, and on tensors that are not on a CUDA device (no
    fallback to the plain version)."""
    with pytest.raises(ValueError):
        cp.preprocess_fwd(**_kernel_inputs(**BAD_INPUTS[case]))
    if case not in ("alive_float",):
        args = _kernel_inputs(**BAD_INPUTS[case])
        cot = _cotangents(0, CAPACITY, torch.float32)
        with pytest.raises(ValueError):
            cp.preprocess_bwd(args["xyz"], args["f_dc"], args["f_rest"],
                              args["scaling"], args["rotation"],
                              args["opacity"], args["cam"], W, H,
                              args["active_sh_degree"], 1.0, *cot)


def test_cuda_request_without_a_card_raises(monkeypatch, tmp_path):
    """No fallback: a CUDA request with no card, an unsupported device, or
    a failed build of either kernel raises."""
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            params = GaussianParams(
                *(torch.zeros(s, device="cuda") for s in
                  ((4, 3), (4, 1, 3), (4, 15, 3), (4, 3), (4, 4), (4, 1))),
                alive=torch.ones(4, dtype=torch.bool, device="cuda"))
            preprocess_gaussians(params, _camera(torch.float32), 3)
    meta = GaussianParams(
        *(torch.zeros(s, device="meta") for s in
          ((4, 3), (4, 1, 3), (4, 15, 3), (4, 3), (4, 4), (4, 1))),
        alive=torch.ones(4, dtype=torch.bool, device="meta"))
    with pytest.raises(ValueError, match="unsupported device"):
        cp.preprocess(meta, _camera(torch.float32), 3)
    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(kernels, "_nvcc", lambda: "false")
    with pytest.raises(RuntimeError, match="nvcc failed"):
        kernels.build("preprocess_fwd", "preprocess_bwd")
    assert not list(tmp_path.glob("*.so"))
