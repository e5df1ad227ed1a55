"""Per-phase wall-clock timers and ``torch.profiler`` traces."""
from __future__ import annotations

import contextlib
import time
from collections import defaultdict

import torch


def _wait_for(tree):
    """Wait for the device work behind every CUDA tensor in ``tree``."""
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        for leaf in tree:
            _wait_for(leaf)
    elif isinstance(tree, torch.Tensor) and tree.is_cuda:
        torch.cuda.synchronize(tree.device)


class PhaseTimer:
    """Accumulates wall-clock time per named phase.  Work on the device
    runs after the host returns: pass ``block_on`` (tensors, or dicts and
    sequences of them) to count it."""

    def __init__(self):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str, block_on=None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if block_on is not None:
                _wait_for(block_on)
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def summary(self) -> str:
        lines = []
        for name in sorted(self.totals, key=self.totals.get, reverse=True):
            t = self.totals[name]
            n = self.counts[name]
            lines.append(f"{name:>24s}: {t:8.3f}s total  {t/n*1e3:8.2f} ms/call  x{n}")
        return "\n".join(lines)


@contextlib.contextmanager
def trace_to(logdir: str):
    """``torch.profiler`` over the block, CPU and (where present) CUDA
    activity, written as a Chrome trace into ``logdir`` (view it in
    Perfetto or TensorBoard)."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts, on_trace_ready=tensorboard_trace_handler(logdir)):
        yield
