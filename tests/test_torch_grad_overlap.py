"""The port's twin of ``tools/grad_overlap.py``
(``luciddreamer_tpu_torch/grad_overlap.py``) on the CPU: ``analyze`` and
the trace readers on hand-built traces with known windows, overlaps and
bytes (exact numbers), the three verdicts, and one gloo world of 4 at a
tiny size that profiles both steps on a (2, 2) mesh.

In the world, each rank wraps ``torch.distributed``'s collectives and
point-to-point calls while a step is traced, and the analysis must find a
window for each call it counted (gloo records one ``gloo:*`` annotation a
call).  The two steps must agree at ``tools/nccl_world.py`` check 4's
limits: loss within 1e-5 relative, Adam's first moments within 5e-4 of
each group's max.
"""
import numpy as np
import pytest

from luciddreamer_tpu_torch import grad_overlap as go
from tests.port_helpers import REPO, GlooWorld, one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

KINDS = ("all_reduce", "all_gather", "send", "recv")


def _ev(name, lane, start, end, collective=False, nbytes=0):
    return {"name": name, "lane": lane, "start": start, "end": end,
            "collective": collective, "bytes": nbytes}


def test_analyze_counts_windows_overlap_and_bytes():
    events = [
        _ev("ncclDevKernel_AllReduce", 20, 100.0, 200.0, True, 1000),
        _ev("ncclDevKernel_SendRecv", 21, 300.0, 350.0, True, 24),
        _ev("k1", 7, 50.0, 120.0),      # meets the first window for 20 us
        _ev("k2", 7, 110.0, 150.0),     # overlaps k1 there: union 50 us
        _ev("k3", 8, 180.0, 320.0),     # 20 us in each window
        _ev("k4", 21, 310.0, 340.0),    # the second window's own stream
        _ev("k5", 8, 400.0, 500.0),     # after both
    ]
    a = go.analyze(events)
    assert a["n_windows"] == 2
    w0, w1 = a["windows"]
    assert (w0["name"], w0["lane"], w0["bytes"]) == ("ncclDevKernel_AllReduce",
                                                     20, 1000)
    assert w0["ms"] == pytest.approx(0.1) and w1["ms"] == pytest.approx(0.05)
    assert w0["overlap_ms"] == pytest.approx(0.07)
    assert w1["overlap_ms"] == pytest.approx(0.02)
    assert w0["inside"] == {"k1": 1, "k2": 1, "k3": 1}
    assert w1["inside"] == {"k3": 1}
    assert a["collective_ms"] == pytest.approx(0.15)
    assert a["overlap_ms"] == pytest.approx(0.09)
    assert a["share"] == pytest.approx(0.6)
    assert a["bytes"] == 1024
    assert a["inside"] == {"k1": 1, "k2": 1, "k3": 2}
    empty = go.analyze([_ev("k", 7, 0.0, 1.0)])
    assert (empty["n_windows"], empty["share"], empty["bytes"]) == (0, 0.0, 0)


def _x(name, cat, ts, dur, tid=1, **args):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
            "tid": tid, "args": args}


def test_device_trace_reads_streams_and_message_sizes():
    """A card's trace: an all-reduce launched inside its comms record, and a
    coalesced send/recv pair launched after both records ended."""
    trace = {"traceEvents": [
        _x("record_param_comms", "cpu_op", 10, 20, **{
            "Collective name": "allreduce", "dtype": "Float",
            "In msg nelems": 250, "Out msg nelems": 250}),
        _x("cudaLaunchKernel", "cuda_runtime", 15, 2, correlation=1),
        _x("record_param_comms", "cpu_op", 40, 5, **{
            "Collective name": "send", "dtype": "Float", "In msg nelems": 8}),
        _x("record_param_comms", "cpu_op", 50, 5, **{
            "Collective name": "recv", "dtype": "Long", "In msg nelems": 8}),
        _x("cuLaunchKernelEx", "cuda_driver", 60, 2, correlation=2),
        _x("cudaLaunchKernel", "cuda_runtime", 16, 2, correlation=3),
        _x("ncclDevKernel_AllReduce_Sum_f32_RING_LL(x)", "kernel", 100, 50,
           tid=9, stream=20, correlation=1),
        _x("ncclDevKernel_SendRecv(y)", "kernel", 300, 40, tid=9, stream=21,
           correlation=2),
        _x("(anonymous namespace)::blend_fwd_kernel(float const*)", "kernel",
           120, 60, tid=9, stream=7, correlation=3),
        {"ph": "i", "name": "marker", "ts": 0},
    ]}
    events = go.trace_events(trace)
    by_name = {e["name"].split("(")[0]: e for e in events}
    ar = by_name["ncclDevKernel_AllReduce_Sum_f32_RING_LL"]
    sr = by_name["ncclDevKernel_SendRecv"]
    assert (ar["collective"], ar["lane"], ar["bytes"]) == (True, 20, 1000)
    assert (sr["collective"], sr["lane"], sr["bytes"]) == (True, 21, 32 + 64)
    assert go.kernel_counts(events) == {"blend_fwd": 1, "blend_bwd": 0,
                                        "repack_cols": 0}
    a = go.analyze(events)
    assert a["overlap_ms"] == pytest.approx(0.03)
    assert a["bytes"] == 1096


def test_host_trace_reads_gloo_annotations():
    """A CPU trace: windows are the gloo annotations, compute the issuing
    thread's top-level ops less the ones that issue a collective."""
    trace = {"traceEvents": [
        _x("c10d::allreduce_", "cpu_op", 0, 10, tid=1,
           **{"Input Dims": [[[10, 3]], [], []],
              "Input type": ["TensorList", "", "Scalar"]}),
        _x("aten::empty", "cpu_op", 2, 1, tid=1),             # nested
        _x("gloo:all_reduce", "user_annotation", 5, 100, tid=2),
        _x("aten::mul", "cpu_op", 20, 30, tid=1),             # compute
        _x("_GatherReplicated", "cpu_op", 60, 30, tid=1),     # issues one
        _x("c10d::allgather_", "cpu_op", 61, 5, tid=1,
           **{"Input Dims": [[], [[4]], []],
              "Input type": ["", "TensorList", "Scalar"]}),
        _x("gloo:all_gather", "user_annotation", 62, 20, tid=3),
        _x("aten::add", "cpu_op", 300, 5, tid=4),             # another thread
    ]}
    events = go.trace_events(trace)
    coll = [e for e in events if e["collective"]]
    assert [(e["name"], e["bytes"]) for e in coll] == [
        ("gloo:all_reduce", 120), ("gloo:all_gather", 16)]
    assert [e["name"] for e in events if not e["collective"]] == ["aten::mul"]
    a = go.analyze(events)
    assert a["overlap_ms"] == pytest.approx(0.03) and a["n_windows"] == 2


def test_short_kernel_names():
    assert go.short_name("(anonymous namespace)::blend_fwd_kernel(float "
                         "const*, int)") == "(anonymous namespace)::blend_fwd_kernel"
    assert go.short_name("ncclDevKernel_SendRecv(ncclDevKernelArgsStorage"
                         "<4096ul>)") == "ncclDevKernel_SendRecv"
    assert go.short_name(
        "void at::native::vectorized_elementwise_kernel<4, at::native::"
        "AUnaryFunctor<float, float, float, at::native::binary_internal::"
        "MulFunctor<float> >, std::array<char*, 2ul> >(int, at::native::"
        "AUnaryFunctor<float>)") == (
        "at::native::vectorized_elementwise_kernel<AUnaryFunctor, MulFunctor>")
    assert go.short_name("void k<128, 2>(int)") == "k"
    assert go.short_name("aten::mul") == "aten::mul"


def test_verdicts():
    rep = lambda b, o, nb=1, no=1: {
        "batch": {"overlap_ms": b, "share": b, "windows": nb},
        "overlapped": {"overlap_ms": o, "share": o, "windows": no}}
    assert go.verdict(rep(0.1, 0.5)).startswith(
        "VERDICT: the chunked ring's NCCL kernels run while compute")
    assert go.verdict(rep(0.5, 0.1)).startswith(
        "VERDICT: the flat all-reduce already overlaps compute")
    assert go.verdict(rep(0.0, 0.0)).startswith("VERDICT: neither step")
    assert "nothing was sent" in go.verdict(rep(0.0, 0.0, 0, 0))


def test_run_needs_the_card_by_default(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        go.main([])


# The ranks' script.  argv: rank, world size, port, output dir.
WORKER = r"""
import collections, sys
import numpy as np
import torch
import torch.distributed as dist
import torch.distributed.distributed_c10d as c10d

rank, world, port, out_dir = (int(sys.argv[1]), int(sys.argv[2]),
                              sys.argv[3], sys.argv[4])
sys.path.insert(0, {repo!r})
torch.set_num_threads(1)

from luciddreamer_tpu_torch import grad_overlap as go
from luciddreamer_tpu_torch.parallel import make_mesh, multihost

multihost.initialize(f"127.0.0.1:{{port}}", world, rank, device="cpu")
mesh = make_mesh(2, 2, device="cpu")
NAMES = ("all_reduce", "all_gather", "all_gather_into_tensor", "broadcast",
         "reduce_scatter_tensor", "send", "recv", "isend", "irecv")
issued = []
traced = go.trace_of


def counting_trace_of(fn, dev, steps, path=None):
    calls = collections.Counter()
    saved = {{n: getattr(c10d, n) for n in NAMES}}
    for n, real in saved.items():
        def wrapper(*a, _real=real, _n=n, **k):
            calls[_n] += 1
            return _real(*a, **k)
        setattr(c10d, n, wrapper)
        setattr(dist, n, wrapper)
    try:
        return traced(fn, dev, steps, path)
    finally:
        for n, real in saved.items():
            setattr(c10d, n, real)
            setattr(dist, n, real)
        issued.append(calls)


go.trace_of = counting_trace_of
rep = go.run(mesh, torch.device("cpu"), capacity=3000, size=64,
             pair_cap=30000, chunk=32, steps=1, warmup=1)
lines = go.report_lines(rep)
res = {{}}
for (name, calls) in zip(("batch", "overlapped"), issued):
    found = rep[name]["window_names"]
    res[name + "_issued"] = np.array([
        calls["all_reduce"], calls["all_gather"] + calls["all_gather_into_tensor"],
        calls["send"] + calls["isend"], calls["recv"] + calls["irecv"],
        sum(calls.values())])
    res[name + "_found"] = np.array(
        [found.get("gloo:" + k, 0) for k in {kinds!r}]
        + [rep[name]["windows"]])
    res[name + "_mb"] = np.array(rep[name]["mb"])
    res[name + "_overflow"] = np.array(rep[name]["overflow"])
a = rep["agreement"]
res["agree"] = np.array(a["ok"])
res["losses"] = np.array([a["loss_batch"], a["loss_overlapped"]])
res["mu"] = np.array(list(a["mu"].values()))
res["steps_run"] = np.array([rep["steps_run"]["batch"],
                             rep["steps_run"]["overlapped"]])
res["lines"] = np.array(len(lines))
res["verdict"] = np.array(lines[-1].startswith("VERDICT: "))
dist.destroy_process_group()
np.savez(f"{{out_dir}}/rank{{rank}}.npz", **res)
"""


def test_gloo_world_profiles_both_steps(tmp_path):
    world = GlooWorld(WORKER.format(repo=REPO, kinds=KINDS), 4, tmp_path,
                      args=(tmp_path,), timeout=240)
    ranks = world.wait()
    for r, res in enumerate(ranks):
        for name in ("batch", "overlapped"):
            issued, found = res[name + "_issued"], res[name + "_found"]
            assert issued[-1] > 0, (r, name)
            np.testing.assert_array_equal(found, issued, err_msg=f"{r} {name}")
            assert float(res[name + "_mb"]) > 0 and not res[name + "_overflow"]
        # the flat step sends nothing point to point; the ring does
        assert tuple(res["batch_issued"][2:4]) == (0, 0)
        assert res["overlapped_issued"][2] > 0
        assert res["agree"] and res["verdict"] and int(res["lines"]) == 10
        assert tuple(res["steps_run"]) == (3, 3)
        np.testing.assert_allclose(res["losses"][1], res["losses"][0],
                                   rtol=1e-5)
        assert res["mu"].max() <= 5e-4
    np.testing.assert_array_equal(ranks[1]["losses"], ranks[0]["losses"])
