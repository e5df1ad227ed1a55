"""The data x tiles training loop, the twin of
``luciddreamer_tpu/parallel/trainer.py``: ``Trainer.run``'s host protocol
around ``sharded_train_step_batch`` (or, with ``grad_overlap``,
``sharded_train_step_overlapped``).

* The overflow flag of a step is read one step late; an overflowed step
  changed nothing on any rank and is run again after the per-band pair
  budget doubles.
* Densify/prune and the opacity reset run on the reference's cadence,
  replicated: every rank holds the same state and draws from a generator
  seeded alike, so they stay bitwise equal.
* Each iteration draws ``mesh.data`` views from the same numpy generator on
  every rank; rank (d, t) renders band t of view d.  With one data row the
  draws are ``Trainer``'s for the same seed.
"""
from __future__ import annotations

import torch

from luciddreamer_tpu_torch.config import GSConfig
from luciddreamer_tpu_torch.core.types import GaussianParams
from luciddreamer_tpu_torch.device import resolve_device
from luciddreamer_tpu_torch.parallel.overlap import sharded_train_step_overlapped
from luciddreamer_tpu_torch.parallel.sharded import (
    Mesh, band_pair_capacity, sharded_train_step_batch,
)
from luciddreamer_tpu_torch.train.loop import Trainer


class ShardedTrainer(Trainer):
    """Trains over a (data, tiles) ``Mesh``; ``pair_cap`` is per band
    (default ``band_pair_capacity``).  ``device=None`` means the CUDA
    device, which must be the mesh's kind of device.  Views as for
    ``Trainer.run``."""

    def __init__(
        self,
        params: GaussianParams,
        cfg: GSConfig,
        cameras_extent: float,
        mesh: Mesh,
        pair_cap: int | None = None,
        backend: str = "cuda",
        chunk: int = 64,
        seed: int = 0,
        grad_overlap: bool = False,
        device=None,
    ):
        dev = resolve_device(device)
        if dev.type != mesh.device.type:
            raise ValueError(f"the trainer is on {dev}, its mesh on "
                             f"{mesh.device}")
        if pair_cap is None:
            pair_cap = band_pair_capacity(params.capacity, mesh.tiles)
        super().__init__(params, cfg, cameras_extent, pair_cap=pair_cap,
                         backend=backend, chunk=chunk, seed=seed,
                         device=mesh.device)
        self.mesh = mesh
        self.grad_overlap = grad_overlap

    def _sample(self, norm):
        """``mesh.data`` views: (cameras, images (B, 3, H, W), depths
        (B, H, W) or None unless every view has one)."""
        picks = [norm[self.py_rng.integers(len(norm))]
                 for _ in range(self.mesh.data)]
        depths = [p[2] for p in picks]
        return ([p[0] for p in picks], torch.stack([p[1] for p in picks]),
                None if any(d is None for d in depths) else torch.stack(depths))

    def _step(self, state, cams, gt, depth):
        step = (sharded_train_step_overlapped if self.grad_overlap
                else sharded_train_step_batch)
        return step(state, cams, gt, self.bg, self.mesh, self.cfg, self.extent,
                    gt_depth_batch=depth, chunk=self.chunk,
                    pair_cap=self.pair_cap, backend=self.backend)
