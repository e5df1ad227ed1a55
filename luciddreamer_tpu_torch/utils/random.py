"""Deterministic seeding."""
from __future__ import annotations

import random

import numpy as np
import torch

from luciddreamer_tpu_torch.device import resolve_device


def seed_everything(seed: int = 0, device=None) -> torch.Generator:
    """Seed Python, numpy and torch; return a ``torch.Generator`` on
    ``device`` (default: the CUDA device) seeded with ``seed``."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    return torch.Generator(device=resolve_device(device)).manual_seed(seed)
