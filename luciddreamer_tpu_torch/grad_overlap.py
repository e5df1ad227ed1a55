"""What runs beside the gradient reduction of the sharded training step,
read from a profiler trace: the twin of ``tools/grad_overlap.py``.

The JAX tool compiles the (data 2, tiles 2) sharded step for a TPU topology
and reads the async collective windows of the scheduled HLO.  Here both
steps it compares run on the cards and ``torch.profiler`` traces them:

* ``parallel/sharded.py::sharded_train_step_batch``, whose one flat
  all-reduce of the gradients after the backward is the twin of the
  "autodiff step (XLA psum)";
* ``parallel/overlap.py::sharded_train_step_overlapped``, the chunked ring
  with Adam issued chunk by chunk.

Each is warmed up, timed by CUDA events, then traced (CPU and CUDA
activities) over a few steps.  ``analyze`` reads the trace's kernels: a
collective window is an NCCL kernel (``ncclDevKernel_*``) on its stream;
inside it are the compute kernels of other streams whose interval meets
it; its bytes are the message sizes that the profiler recorded for the
collective that launched it (``record_param_comms``; a coalesced
SendRecv counts its send and its receive).  Per step it reports the
windows, the ms of NCCL kernels and of their overlap with compute, the
share, the compute kernels inside, the MB, the step's device ms by events
and K1-K3's launches, each beside the card's name and power limit, then
the JAX tool's three verdicts in the port's words.  The two steps must
agree as ``tools/nccl_world.py`` check 4 holds them: loss within 1e-5
relative, Adam's first moments within 5e-4 of each group's max.

Caveats: a SendRecv kernel that spins waiting for its peer counts as NCCL
time; and the windows are kernel intervals on the card, where the JAX tool
counted ops in an HLO schedule, so the JAX package's TPU figures (windows,
MB, ops) are no yardstick for these.

On four cards (``multihost.initialize`` reads torchrun's variables)::

    torchrun --standalone --nproc-per-node=4 -m luciddreamer_tpu_torch.grad_overlap

The gloo rehearsal on the CPU, at a small size (the collective windows are
then the ``gloo:*`` annotations of the trace, the compute the top-level
ops of the threads that issued them, and a message counts 4 bytes an
element, since gloo records no dtype)::

    torchrun --standalone --nproc-per-node=4 -m luciddreamer_tpu_torch.grad_overlap \\
        --device cpu --capacity 3000 --size 64 --pair-cap 30000 --chunk 32

Without a process group it runs a mesh of one, where nothing is sent.
"""
from __future__ import annotations

import argparse
import collections
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

from luciddreamer_tpu_torch.bench import bench_scene, events_ms
from luciddreamer_tpu_torch.config import CameraConfig, GSConfig
from luciddreamer_tpu_torch.core.types import GaussianParams
from luciddreamer_tpu_torch.device import resolve_device
from luciddreamer_tpu_torch.model.gaussians import DensifyStats
from luciddreamer_tpu_torch.model.optim import GROUPS, adam_init
from luciddreamer_tpu_torch.parallel import multihost
from luciddreamer_tpu_torch.parallel.overlap import sharded_train_step_overlapped
from luciddreamer_tpu_torch.parallel.sharded import (
    make_mesh, sharded_train_step_batch,
)
from luciddreamer_tpu_torch.render.tiled import render_tiled
from luciddreamer_tpu_torch.train.loop import TrainState

# tools/grad_overlap.py:183-200 and its build_step: a (2, 2) mesh, capacity
# 100k, 512x512, pair_cap 400,000 per band, chunk 128, GSConfig(), extent 1
MESH = (2, 2)
CAPACITY = 100_000
SIZE = 512
PAIR_CAP = 400_000
CHUNK = 128
SEED = 42
STEPS = 3                     # traced steps of each kind
WARMUP = 2
NCCL_PREFIXES = ("ncclDevKernel", "ncclKernel")
# the blend kernels' entry points, K1, K2 and K3's two passes
PORT_KERNELS = {"blend_fwd": ("blend_fwd_kernel",),
                "blend_bwd": ("blend_bwd_kernel",),
                "repack_cols": ("invert_order_kernel", "gather_cols_kernel")}
DTYPE_BYTES = {"Float": 4, "Int": 4, "Long": 8, "Double": 8, "Half": 2,
               "BFloat16": 2, "Bool": 1, "Byte": 1, "Char": 1, "Short": 2}
PER_RANK = ("windows", "collective_ms", "overlap_ms", "mb", "device_ms")
LOSS_RTOL = 1e-5              # tools/nccl_world.py check 4
MU_ATOL = 5e-4


# ------------------------------------------------------------------ analysis

def _union_us(intervals) -> float:
    total, end = 0.0, -float("inf")
    for a, b in sorted(intervals):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


def analyze(events) -> dict:
    """The collective windows of a trace and what ran inside them.

    ``events``: dicts with ``name``, ``lane`` (a stream or a thread),
    ``start`` and ``end`` (us), ``collective`` (bool) and, for a
    collective, ``bytes``.  A window is a collective event; the compute
    inside it is every non-collective event on another lane whose interval
    meets it, and its overlap is the union of those intervals within it.
    Returns the windows (name, lane, start, ms, overlap_ms, bytes, inside:
    a Counter of compute names) in start order, their number, the sums
    ``collective_ms``, ``overlap_ms`` and ``bytes``, ``share`` (overlap
    over collective time, 0 without windows) and ``inside``, the Counter
    over all windows."""
    compute = [e for e in events if not e["collective"]]
    windows = []
    for w in sorted((e for e in events if e["collective"]),
                    key=lambda e: e["start"]):
        meet = [c for c in compute if c["lane"] != w["lane"]
                and c["start"] < w["end"] and c["end"] > w["start"]]
        windows.append({
            "name": w["name"], "lane": w["lane"], "start": w["start"],
            "ms": (w["end"] - w["start"]) / 1e3,
            "overlap_ms": _union_us((max(c["start"], w["start"]),
                                     min(c["end"], w["end"]))
                                    for c in meet) / 1e3,
            "bytes": w.get("bytes", 0),
            "inside": collections.Counter(c["name"] for c in meet),
        })
    coll_ms = sum(w["ms"] for w in windows)
    ovl_ms = sum(w["overlap_ms"] for w in windows)
    return {
        "windows": windows,
        "n_windows": len(windows),
        "collective_ms": coll_ms,
        "overlap_ms": ovl_ms,
        "share": ovl_ms / coll_ms if coll_ms > 0 else 0.0,
        "bytes": sum(w["bytes"] for w in windows),
        "inside": sum((w["inside"] for w in windows), collections.Counter()),
    }


def _comm_bytes(args: dict) -> int:
    return int(args.get("In msg nelems", 0)) * DTYPE_BYTES.get(
        args.get("dtype"), 4)


def _device_events(xs, kernels):
    """Kernel events of a CUDA trace; an NCCL kernel's bytes come from the
    ``record_param_comms`` range of its launching thread that holds its
    launch, else (a coalesced group, launched when the group ends) from
    the point-to-point records issued on that thread since the previous
    NCCL launch."""
    launches = {}
    for e in xs:
        corr = e.get("args", {}).get("correlation")
        if e.get("cat") in ("cuda_runtime", "cuda_driver") and corr is not None:
            launches[corr] = (e.get("tid"), e["ts"])
    comms = sorted((e for e in xs if e["name"] == "record_param_comms"),
                   key=lambda e: e["ts"])
    launch_of = lambda k: launches.get(k.get("args", {}).get("correlation"),
                                       (None, None))
    used, last_launch, nbytes = set(), {}, {}
    nccl = [k for k in kernels if k["name"].startswith(NCCL_PREFIXES)]
    for k in sorted(nccl, key=lambda k: launch_of(k)[1] or k["ts"]):
        tid, t = launch_of(k)
        if t is None:
            continue
        mine = [i for i, c in enumerate(comms) if c.get("tid") == tid]
        holding = [i for i in mine
                   if comms[i]["ts"] <= t <= comms[i]["ts"] + comms[i].get("dur", 0)]
        if holding:
            pick = [max(holding, key=lambda i: comms[i]["ts"])]
        else:
            since = last_launch.get(tid, -float("inf"))
            pick = [i for i in mine if since < comms[i]["ts"] <= t
                    and i not in used and comms[i].get("args", {}).get(
                        "Collective name") in ("send", "recv")]
        used.update(pick)
        nbytes[id(k)] = sum(_comm_bytes(comms[i].get("args", {})) for i in pick)
        last_launch[tid] = t
    return [{"name": k["name"], "lane": k.get("args", {}).get("stream"),
             "start": k["ts"], "end": k["ts"] + k.get("dur", 0),
             "collective": k["name"].startswith(NCCL_PREFIXES),
             "bytes": nbytes.get(id(k), 0)} for k in kernels]


def short_name(name: str) -> str:
    """A kernel's name without ``void`` and its parameter list, its
    template arguments cut to the functors and kernels named in them."""
    name = re.sub(r"\((?!anonymous namespace\)).*$", "", name)
    head, sep, rest = name.removeprefix("void ").partition("<")
    tags = dict.fromkeys(re.findall(r"\w*(?:Functor|_kernel_cuda)\w*", rest))
    return f"{head}<{', '.join(tags)}>" if tags else head


def _kind(name: str) -> str:
    return "".join(ch for ch in name.split(":")[-1] if ch.isalpha())


def _host_events(xs):
    """A CPU (gloo) trace: the ``gloo:*`` annotations are the windows, on a
    lane of their own; the compute is the top-level ops of the threads
    that issued collectives, less those that issue one; the k-th window of
    a kind takes the bytes of the k-th ``c10d::`` op of that kind (its
    tensor arguments' elements, 4 bytes each)."""
    ops = [e for e in xs if e.get("cat") == "cpu_op"]
    c10d = sorted((e for e in ops if e["name"].startswith("c10d::")),
                  key=lambda e: e["ts"])
    sizes = collections.defaultdict(list)
    for e in c10d:
        a = e.get("args", {})
        n = 0
        for dims, typ in zip(a.get("Input Dims", []), a.get("Input type", [])):
            if typ == "TensorList":
                n += sum(int(np.prod(d)) for d in dims)
        sizes[_kind(e["name"])].append(4 * n)
    issuers = {e.get("tid") for e in c10d}
    out, seen = [], collections.Counter()
    for e in sorted(xs, key=lambda e: e["ts"]):
        if e.get("cat") == "user_annotation" and e["name"].startswith("gloo:"):
            kind = _kind(e["name"])
            got = sizes.get(kind, [])
            nbytes = got[seen[kind]] if seen[kind] < len(got) else 0
            seen[kind] += 1
            out.append({"name": e["name"], "lane": "gloo", "start": e["ts"],
                        "end": e["ts"] + e.get("dur", 0), "collective": True,
                        "bytes": nbytes})
    for tid in issuers:
        top_end = -float("inf")
        mine = sorted((e for e in ops if e.get("tid") == tid),
                      key=lambda e: (e["ts"], -e.get("dur", 0)))
        issued = [e["ts"] for e in c10d if e.get("tid") == tid]
        for e in mine:
            if e["ts"] < top_end:
                continue
            top_end = e["ts"] + e.get("dur", 0)
            # an op that issues a collective (c10d's own, or a caller such
            # as the all-gather's autograd Function) is not compute
            if not any(e["ts"] <= t < top_end for t in issued):
                out.append({"name": e["name"], "lane": tid, "start": e["ts"],
                            "end": top_end, "collective": False, "bytes": 0})
    return out


def trace_events(trace: dict) -> list:
    """The events ``analyze`` reads from a chrome trace of
    ``torch.profiler``: its kernels where it traced a card, else its gloo
    annotations and host ops."""
    xs = [e for e in trace.get("traceEvents", []) if e.get("ph") == "X"
          and "ts" in e]
    kernels = [e for e in xs if e.get("cat") == "kernel"]
    return _device_events(xs, kernels) if kernels else _host_events(xs)


def kernel_counts(events) -> dict:
    """Launches of K1-K3's entry points in a card's trace (K3's two passes
    each), by kernel."""
    names = [e["name"] for e in events]
    return {k: min(sum(f"{p}(" in n for n in names) for p in entries)
            for k, entries in PORT_KERNELS.items()}


# ------------------------------------------------------------- the steps

def build_inputs(dev, capacity=CAPACITY, size=SIZE, n_cams=MESH[0],
                 seed=SEED):
    """``tools/nccl_world.py``'s scene at this size: the bench scene of
    ``capacity`` Gaussians, its renders at the first ``n_cams`` llff poses
    as the targets, and the start state: the same Gaussians with
    features_dc and opacity perturbed from seed ``seed + 1``.  Returns
    (state, cams, gt)."""
    from luciddreamer_tpu_torch.app import LucidDreamerTPU

    scene = bench_scene(capacity, seed, dev)
    cams = LucidDreamerTPU(cam_config=CameraConfig(image_width=size,
                                                   image_height=size),
                           device=dev).preset_cameras("llff")[:n_cams]
    bg = torch.zeros(3, device=dev)
    with torch.no_grad():
        gt = torch.stack([render_tiled(scene, c, bg)["render"] for c in cams])
    rng = np.random.default_rng(seed + 1)
    p = scene.param_dict()
    noise = lambda t, s: t + torch.as_tensor(
        rng.normal(size=t.shape).astype(np.float32) * s, device=dev)
    p["f_dc"] = noise(p["f_dc"], 0.3)
    p["opacity"] = noise(p["opacity"], 1.0)
    params = GaussianParams.from_param_dict(p, scene.alive)
    state = TrainState(params, adam_init(params.param_dict()),
                       DensifyStats.zero(capacity, device=dev),
                       torch.zeros((), dtype=torch.int32, device=dev))
    return state, cams, gt


def make_steps(state, cams, gt, mesh, pair_cap=PAIR_CAP, chunk=CHUNK):
    """The two steps of the JAX tool, each from ``state``: name -> a call
    returning (new state, loss, overflow)."""
    bg = torch.zeros(3, device=gt.device)
    kw = dict(chunk=chunk, pair_cap=pair_cap, backend="cuda")
    return {
        "batch": lambda: sharded_train_step_batch(
            state, cams, gt, bg, mesh, GSConfig(), 1.0, **kw),
        "overlapped": lambda: sharded_train_step_overlapped(
            state, cams, gt, bg, mesh, GSConfig(), 1.0, **kw),
    }


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def step_ms(fn, dev, reps) -> tuple:
    """(device ms by CUDA events, or None off the card; host wall ms): the
    median over ``reps`` calls, each timed alone.  On the card every rank
    sleeps the same time before each call (twice the group's slowest wall,
    after a small all-reduce that lines up the ranks' streams), so that the
    ranks start each timed step together and no rank's events hold a wait
    for a peer still asleep."""
    walls = []
    for _ in range(reps):
        _sync(dev)
        t0 = time.perf_counter()
        fn()
        _sync(dev)
        walls.append((time.perf_counter() - t0) * 1e3)
    wall = float(np.median(walls))
    if dev.type != "cuda":
        return None, wall
    align = None
    slowest = torch.tensor([wall], device=dev)
    if dist.is_initialized():
        dist.all_reduce(slowest, op=dist.ReduceOp.MAX)
        align = lambda: dist.all_reduce(torch.zeros(1, device=dev))
    return events_ms(fn, 2 * float(slowest) + 5, reps, align), wall


def trace_of(fn, dev, steps, path=None) -> list:
    """``steps`` calls of ``fn`` under ``torch.profiler`` (CPU, and CUDA on
    the card, with shapes): the events of its chrome trace, which is kept
    at ``path`` when one is given."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    _sync(dev)
    with profile(activities=acts, record_shapes=True) as prof:
        for _ in range(steps):
            fn()
        _sync(dev)
    with tempfile.TemporaryDirectory() as tmp:
        out = path or os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(out)
        with open(out) as f:
            return trace_events(json.load(f))


def agreement(batch, overlapped) -> dict:
    """The overlapped step against the batch step from the same state:
    loss relative difference and Adam's first moments' max |d| over each
    group's max, with ``ok`` at check 4's limits.  (``tools/nccl_world.py``
    holds these and the parameters through its own ``step_errors``; a
    script, which the package does not import.)"""
    (b_state, b_loss, _), (o_state, o_loss, _) = batch, overlapped
    loss_rel = abs(float(o_loss) - float(b_loss)) / abs(float(b_loss))
    mu = {}
    for k in GROUPS:
        ref = b_state.adam.mu[k]
        mu[k] = float((o_state.adam.mu[k] - ref).abs().max()
                      / ref.abs().max().clamp_min(1e-30))
    return {"loss_batch": float(b_loss), "loss_overlapped": float(o_loss),
            "loss_rel": loss_rel, "mu": mu,
            "ok": loss_rel <= LOSS_RTOL and max(mu.values()) <= MU_ATOL}


def card_line(dev) -> str:
    """``nvidia-smi``'s name and power limit of the card, or the CPU."""
    if dev.type != "cuda":
        return "cpu (no card)"
    return subprocess.run(
        ["nvidia-smi", f"--id={dev.index or 0}", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()


def run(mesh, dev, capacity=CAPACITY, size=SIZE, pair_cap=PAIR_CAP,
        chunk=CHUNK, steps=STEPS, warmup=WARMUP, trace_dir=None) -> dict:
    """Warm up, time and trace both steps on ``mesh``; returns per step its
    analysis scaled to one step (``windows``, ``window_names``,
    ``collective_ms``, ``overlap_ms``, ``share``, ``mb``, ``inside``: the
    six compute kernels most often inside), ``device_ms`` and
    ``wall_ms``, ``kernels`` (K1-K3 launches per step in the trace, on the
    card) and ``overflow``; then ``agreement``, ``steps_run`` (calls of
    each step) and ``target_renders`` (the targets' renders, through K1
    alone).  Rank 0 keeps its two chrome traces in ``trace_dir``."""
    state, cams, gt = build_inputs(dev, capacity, size, mesh.data)
    calls = collections.Counter()
    report = {"mesh": mesh.shape, "capacity": capacity, "size": size,
              "pair_cap": pair_cap, "chunk": chunk, "steps": steps,
              "card": card_line(dev), "device": dev.type,
              "target_renders": len(cams)}
    outs = {}
    for name, fn in make_steps(state, cams, gt, mesh, pair_cap, chunk).items():
        def counted(fn=fn, name=name):
            calls[name] += 1
            return fn()

        for _ in range(warmup):
            outs[name] = counted()
        ms, wall = step_ms(counted, dev, steps)
        path = (os.path.join(trace_dir, f"{name}.json")
                if trace_dir and mesh.rank == 0 else None)
        events = trace_of(counted, dev, steps, path)
        a = analyze(events)
        inside = collections.Counter()
        for k, v in a["inside"].items():
            inside[short_name(k)] += v
        report[name] = {
            "windows": a["n_windows"] / steps,
            "collective_ms": a["collective_ms"] / steps,
            "overlap_ms": a["overlap_ms"] / steps,
            "share": a["share"],
            "mb": a["bytes"] / steps / 1e6,
            "inside": {k: v / steps for k, v in inside.most_common(6)},
            "window_names": {k: v / steps for k, v in collections.Counter(
                short_name(w["name"]) for w in a["windows"]).items()},
            "device_ms": ms, "wall_ms": wall,
            "kernels": ({k: v / steps for k, v in kernel_counts(events).items()}
                        if dev.type == "cuda" else None),
            "overflow": bool(outs[name][2]),
        }
    report["agreement"] = agreement(outs["batch"], outs["overlapped"])
    report["steps_run"] = dict(calls)
    return report


def verdict(report) -> str:
    """The JAX tool's three outcomes, in the port's words."""
    b, o = report["batch"], report["overlapped"]
    if o["overlap_ms"] > b["overlap_ms"]:
        return (f"VERDICT: the chunked ring's NCCL kernels run while compute "
                f"kernels run ({o['share']:.1%} of their time); the flat "
                f"all-reduce's do less ({b['share']:.1%}).")
    if b["overlap_ms"] > 0:
        return (f"VERDICT: the flat all-reduce already overlaps compute "
                f"({b['share']:.1%} of its NCCL time), as much as the "
                f"chunked ring or more ({o['share']:.1%}).")
    return ("VERDICT: neither step runs a compute kernel beside its "
            "collectives in this trace"
            + (" (no collective window: nothing was sent)."
               if b["windows"] == o["windows"] == 0 else "."))


def report_lines(report) -> list:
    card = report["card"]
    dev_ms = lambda v: "not measured" if v is None else f"{v:.4f}"
    lines = [
        f"[grad_overlap] mesh {report['mesh']}, {report['capacity']} "
        f"Gaussians, {report['size']}x{report['size']}, pair_cap "
        f"{report['pair_cap']} per band, chunk {report['chunk']}; "
        f"{report['steps']} traced steps of each | {card}"]
    for name, title in (("batch", "flat all-reduce step "
                         "(sharded_train_step_batch)"),
                        ("overlapped", "chunked-ring step "
                         "(sharded_train_step_overlapped)")):
        r = report[name]
        lines += [
            f"== {title}: per step {r['windows']:.2f} collective windows "
            f"{r['window_names']}, {r['collective_ms']:.4f} ms in them, "
            f"{r['overlap_ms']:.4f} ms overlapped with compute (share "
            f"{r['share']:.4f}), {r['mb']:.3f} MB | {card}",
            f"   step ms: device {dev_ms(r['device_ms'])} (CUDA events, "
            f"median of {report['steps']}), host wall {r['wall_ms']:.4f}; "
            f"overflow {r['overflow']}; K1-K3 launches per step in the "
            f"trace {r['kernels']} | {card}",
            f"   compute inside the windows, launches per step: {r['inside']} "
            f"| {card}"]
    a = report["agreement"]
    lines += [
        f"[grad_overlap] agreement: loss {a['loss_batch']:.7f} / "
        f"{a['loss_overlapped']:.7f} (rel {a['loss_rel']:.2e}, limit "
        f"{LOSS_RTOL}); Adam mu max |d| / group max "
        + ", ".join(f"{k} {v:.2e}" for k, v in a["mu"].items())
        + f" (limit {MU_ATOL}): {'ok' if a['ok'] else 'DISAGREE'}",
        "[grad_overlap] caveats: a SendRecv kernel that spins waiting for "
        "its peer counts as NCCL time; these are kernel intervals on the "
        "card, where the JAX tool counted ops in a TPU's HLO schedule, so "
        "its TPU figures (windows, MB, ops) are no yardstick for them.",
        verdict(report)]
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None, choices=("cuda", "cpu"))
    ap.add_argument("--capacity", type=int, default=CAPACITY)
    ap.add_argument("--size", type=int, default=SIZE)
    ap.add_argument("--pair-cap", type=int, default=PAIR_CAP)
    ap.add_argument("--chunk", type=int, default=CHUNK)
    ap.add_argument("--trace-dir", default=None,
                    help="keep rank 0's chrome traces here")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    grouped = multihost.initialize(device=dev)
    if dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    world = dist.get_world_size() if grouped else 1
    main_rank = multihost.is_main_process()
    data = 2 if world % 2 == 0 else 1         # (2, 2) on four ranks
    mesh = make_mesh(data, world // data, device=dev)
    if args.trace_dir:
        os.makedirs(args.trace_dir, exist_ok=True)
    try:
        report = run(mesh, dev, args.capacity, args.size, args.pair_cap,
                     args.chunk, trace_dir=args.trace_dir)
        mine = {k: [None if report[k][m] is None else round(report[k][m], 4)
                    for m in PER_RANK] for k in ("batch", "overlapped")}
        ranks = [mine]
        if grouped:
            ranks = [None] * world
            dist.all_gather_object(ranks, mine)
    finally:
        if grouped:
            dist.destroy_process_group()
    if main_rank:
        for line in report_lines(report):
            print(line, flush=True)
        print(f"[grad_overlap] every rank's {list(PER_RANK)} per step: "
              + "; ".join(f"rank {r} {v}" for r, v in enumerate(ranks))
              + f" | {report['card']}", flush=True)
    return 0 if report["agreement"]["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
