"""How far the golden pipeline's statistics move with the inpainter's noise.

``tests/test_golden_pipeline.py`` holds the JAX package's dream -> bake ->
render run (64x64 waterfall, rotate360, classic inpainter + radial depth,
80 iterations, 3,000 points) against ``tests/golden/waterfall_golden.npz``.
The golden was made with one noise stream: ``create(seed=1)`` seeds the
classic inpainter's draws (sigma 0.02 a pass).  This script runs the same
pipeline (``tests/port_helpers.py::golden_run``) with other dream seeds
(the bake's seed stays 1), and the port's ``create`` on the CPU, whose
noise comes from a ``torch.Generator``, and prints each run's distance
from the golden at the golden test's tolerances.

    JAX_PLATFORMS=cpu python tools/golden_noise_spread.py --jax 1 2 3 --port 1

Each run takes about a minute on one CPU thread; runs go in parallel
processes.
"""
from __future__ import annotations

import argparse
import concurrent.futures as cf
import multiprocessing as mp
import os
import sys
import tempfile

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(which: str, seed: int) -> str:
    sys.path.insert(0, REPO)
    import jax

    jax.config.update("jax_platforms", "cpu")
    from tests.port_helpers import GOLDEN, golden_run

    with tempfile.TemporaryDirectory() as out:
        stats, _, _ = golden_run(which, out, dream_seed=seed)
    g = np.load(GOLDEN)
    d = np.abs(stats["blocks"] - g["blocks"])
    return (f"{which} dream seed {seed}: blocks off by > 0.025 on "
            f"{(d > 0.025).mean():.4f} of them, max {d.max():.4f}; alive "
            f"{stats['alive']} (golden {int(g['alive'])}); |xyz mean - golden| "
            f"max {np.abs(stats['xyz_mean'] - g['xyz_mean']).max():.4f}; "
            f"depth mean rel. diff max "
            f"{np.abs(stats['depth_mean'] / g['depth_mean'] - 1).max():.4f}; "
            f"depth > 0 share diff max "
            f"{np.abs(stats['depth_posfrac'] - g['depth_posfrac']).max():.4f}")


def main():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--jax", type=int, nargs="*", default=[],
                   help="dream seeds of the JAX package's runs")
    p.add_argument("--port", type=int, nargs="*", default=[],
                   help="dream seeds of the port's runs")
    p.add_argument("--workers", type=int, default=3)
    args = p.parse_args()
    jobs = [("jax", s) for s in args.jax] + [("port", s) for s in args.port]
    with cf.ProcessPoolExecutor(args.workers,
                                mp_context=mp.get_context("spawn")) as pool:
        for line in pool.map(_run, *zip(*jobs)):
            print(line, flush=True)


if __name__ == "__main__":
    main()
