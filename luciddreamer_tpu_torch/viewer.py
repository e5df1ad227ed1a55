"""SIBR live-viewer TCP bridge (the twin of ``luciddreamer_tpu/viewer.py``).

Protocol-compatible with the reference network GUI: a 4-byte little-endian
length and a JSON camera request on 127.0.0.1:6009; the reply is the raw
H x W x 3 uint8 image, then a length-prefixed verify string.  The incoming
matrices are the reference's *transposed* (glm) world_view /
view_projection with flipped y/z columns; they are converted to the plain
math convention before rendering.

``serve_once`` renders on the device the Gaussians live on: through K1
(``render_tiled(backend="cuda")``) for CUDA tensors, through the plain
blend only for CPU tensors.  One request is one render.
"""
from __future__ import annotations

import json
import socket
import traceback
from typing import Optional

import numpy as np
import torch

from luciddreamer_tpu_torch.core.types import Camera
from luciddreamer_tpu_torch.device import resolve_device
from luciddreamer_tpu_torch.render.tiled import render_tiled


def frame_bytes(img: torch.Tensor) -> bytes:
    """(3, H, W) float image -> the reply's H x W x 3 uint8 bytes: clamped
    to [0, 1], times 255 in float32, truncated; on the image's device, then
    one copy to the host."""
    hwc = img.detach().clamp(0.0, 1.0).permute(1, 2, 0) * 255.0
    return hwc.to(torch.uint8).cpu().numpy().tobytes()


class ViewerServer:
    def __init__(self, host: str = "127.0.0.1", port: int = 6009):
        self.host = host
        self.port = port
        self.listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self.listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self.listener.bind((host, port))
        self.listener.listen()
        self.listener.settimeout(0)
        self.conn: Optional[socket.socket] = None

    def try_connect(self):
        try:
            self.conn, _ = self.listener.accept()
            self.conn.settimeout(None)
        except (BlockingIOError, socket.timeout):
            pass

    def _read(self) -> dict:
        n = int.from_bytes(self._recv_exact(4), "little")
        return json.loads(self._recv_exact(n).decode("utf-8"))

    def _recv_exact(self, n):
        buf = b""
        while len(buf) < n:
            chunk = self.conn.recv(n - len(buf))
            if not chunk:
                raise ConnectionError("viewer disconnected")
            buf += chunk
        return buf

    def send(self, image_bytes: Optional[bytes], verify: str):
        if image_bytes is not None:
            self.conn.sendall(image_bytes)
        self.conn.sendall(len(verify).to_bytes(4, "little"))
        self.conn.sendall(verify.encode("ascii"))

    @staticmethod
    def camera_from_message(message: dict, device=None) -> Optional[Camera]:
        """Build a renderer Camera on ``device`` (default: the CUDA device)
        from a viewer request; None for a zero-sized request."""
        W = message["resolution_x"]
        H = message["resolution_y"]
        if W == 0 or H == 0:
            return None
        wvt = np.array(message["view_matrix"], np.float64).reshape(4, 4)
        wvt[:, 1] *= -1
        wvt[:, 2] *= -1
        vpt = np.array(
            message["view_projection_matrix"], np.float64
        ).reshape(4, 4)
        vpt[:, 1] *= -1
        # the viewer sends transposed (glm) matrices; untranspose
        view = wvt.T
        full = vpt.T
        campos = np.linalg.inv(view)[:3, 3]
        dev = resolve_device(device)
        f32 = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=dev)
        return Camera(
            viewmatrix=f32(view),
            projmatrix=f32(full),
            campos=f32(campos),
            tanfovx=f32(np.tan(message["fov_x"] / 2)),
            tanfovy=f32(np.tan(message["fov_y"] / 2)),
            height=int(H),
            width=int(W),
            znear=float(message["z_near"]),
            zfar=float(message["z_far"]),
        )

    def receive(self, device=None):
        """-> (camera on ``device`` | None, request dict)."""
        message = self._read()
        try:
            cam = self.camera_from_message(message, device)
        except Exception:
            traceback.print_exc()
            raise
        return cam, message

    def serve_once(self, params, bg, render_fn=None, verify: str = "ok"):
        """Handle one request if a viewer is connected: render it on the
        device ``params`` live on and reply.  Returns False when no viewer
        is connected or the connection dropped.  ``render_fn(params, cam,
        message)``, when given, returns the (3, H, W) image instead."""
        if self.conn is None:
            self.try_connect()
        if self.conn is None:
            return False
        dev = params.xyz.device
        try:
            cam, msg = self.receive(dev)
        except (ConnectionError, OSError):
            self.conn = None
            return False
        # only the socket's errors drop the connection: a render that
        # fails (a kernel that does not build or launch) raises
        payload = None
        if cam is not None:
            with torch.no_grad():
                if render_fn is None:
                    # a live preview: a frame that overflows its pair
                    # capacity is sent as it is, as the JAX viewer does
                    img = render_tiled(
                        params, cam,
                        torch.as_tensor(bg, dtype=torch.float32, device=dev),
                        scale_modifier=float(msg.get("scaling_modifier", 1.0)),
                        backend="cuda" if dev.type == "cuda" else "torch",
                    )["render"]
                else:
                    img = render_fn(params, cam, msg)
                payload = frame_bytes(img)
        try:
            self.send(payload, verify)
        except (ConnectionError, OSError):
            self.conn = None
            return False
        return True

    def close(self):
        if self.conn is not None:
            self.conn.close()
        self.listener.close()
