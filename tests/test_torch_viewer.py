"""Port parity: the SIBR viewer bridge (``luciddreamer_tpu_torch.viewer``)
against ``luciddreamer_tpu.viewer`` on the CPU.  The fake SIBR client is
``chip_smoke.SibrClient``: it connects, signals, and only then does the
server poll, sleeping between empty polls until a deadline."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import chip_smoke
from luciddreamer_tpu.render.tiled import render_tiled as jax_render
from luciddreamer_tpu.viewer import ViewerServer as JaxViewerServer
from luciddreamer_tpu_torch.core.transforms import make_camera
from luciddreamer_tpu_torch.render.tiled import render_tiled
from luciddreamer_tpu_torch.viewer import ViewerServer, frame_bytes
from tests.helpers import make_random_gaussians
from tests.port_helpers import np_, one_torch_thread, port_camera, port_params  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")
CAMERA_FIELDS = ("viewmatrix", "projmatrix", "campos", "tanfovx", "tanfovy")
# jitted, so that the cameras of one size share one compile
jax_render_rgb = jax.jit(lambda p, c: jax_render(p, c, jnp.zeros(3))["render"])


def _cameras(rng, n=3, W=40, H=32):
    """Cameras near the origin looking down +z at the test blob."""
    cams = []
    for _ in range(n):
        a = rng.normal(scale=0.1, size=3)
        K = np.array([[0, -a[2], a[1]], [a[2], 0, -a[0]], [-a[1], a[0], 0]])
        q, r = np.linalg.qr(np.eye(3) + K)
        c2w = np.eye(4)
        c2w[:3, :3] = q * np.sign(np.diag(r))
        c2w[:3, 3] = rng.normal(scale=0.2, size=3)
        cams.append(make_camera(c2w, 0.9, 0.75, W, H, device="cpu"))
    return cams


def test_camera_from_message_matches_jax(rng):
    for cam in _cameras(rng):
        msg = chip_smoke.viewer_request(cam)
        got = ViewerServer.camera_from_message(msg, "cpu")
        ref = JaxViewerServer.camera_from_message(msg)
        for k in CAMERA_FIELDS:
            np.testing.assert_allclose(np_(getattr(got, k)), np_(getattr(ref, k)),
                                       rtol=0, atol=1e-7, err_msg=k)
            np.testing.assert_allclose(np_(getattr(got, k)), np_(getattr(cam, k)),
                                       rtol=0, atol=1e-6, err_msg=k)
        assert (got.width, got.height, got.znear, got.zfar) == (
            ref.width, ref.height, ref.znear, ref.zfar)
    assert ViewerServer.camera_from_message(
        dict(msg, resolution_x=0), "cpu") is None


def test_camera_from_message_needs_cuda_unless_cpu_is_asked(monkeypatch, rng):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    msg = chip_smoke.viewer_request(_cameras(rng, 1)[0])
    with pytest.raises(RuntimeError, match="CUDA"):
        ViewerServer.camera_from_message(msg)


def test_viewer_round_trip_matches_direct_render_and_jax(rng):
    jp = make_random_gaussians(60, rng)
    params = port_params(jp)
    cams = _cameras(rng)
    messages = [chip_smoke.viewer_request(c) for c in cams]
    messages.insert(1, dict(messages[0], resolution_x=0))   # an empty request
    server = ViewerServer(port=0)
    try:
        client, answered = chip_smoke.serve_requests(
            server, params, [0.0, 0.0, 0.0], messages, timeout=30.0)
    finally:
        server.close()
    assert client.error is None and answered == len(messages)
    assert not client.is_alive()
    assert [v for _, v in client.replies] == ["ok"] * len(messages)
    assert client.replies[1][0] == b""
    replies = [img for i, (img, _) in enumerate(client.replies) if i != 1]
    for cam, msg, img in zip(cams, messages[:1] + messages[2:], replies):
        got = ViewerServer.camera_from_message(msg, "cpu")
        with torch.no_grad():
            direct = render_tiled(params, got, torch.zeros(3), backend="torch")
        assert img == frame_bytes(direct["render"])
        ref = jax_render_rgb(jp, JaxViewerServer.camera_from_message(msg))
        ref8 = (np.clip(np.asarray(ref), 0, 1).transpose(1, 2, 0) * 255).astype(
            np.uint8)
        mine = np.frombuffer(img, np.uint8).reshape(ref8.shape)
        off = np.abs(mine.astype(int) - ref8.astype(int))
        assert off.max() <= 1 and (off > 0).mean() <= 1e-3
        assert (mine > 0).mean() > 0.05                       # not blank


def test_frame_bytes_is_the_jax_arithmetic(rng):
    img = rng.uniform(-0.2, 1.2, size=(3, 7, 9)).astype(np.float32)
    ref = (np.clip(img, 0, 1).transpose(1, 2, 0) * 255).astype(np.uint8)
    assert frame_bytes(torch.as_tensor(img)) == ref.tobytes()


def test_serve_once_without_a_viewer_and_after_a_drop(rng):
    params = port_params(make_random_gaussians(10, rng))
    server = ViewerServer(port=0)
    try:
        assert server.serve_once(params, [0.0, 0.0, 0.0]) is False
        client, answered = chip_smoke.serve_requests(
            server, params, [0.0, 0.0, 0.0], [], timeout=5.0)
        client.join(5.0)
        # the client left without a request: the next poll drops it
        assert answered == 0 and server.serve_once(params, [0.0] * 3) is False
        assert server.conn is None
    finally:
        server.close()
