"""The attribution of device time to spans (``span_trace``) on a small
hand-written chrome trace, and ``trace.reduce`` on the same trace.

The fixture has a main thread (tid 1) and an autograd thread (tid 2);
times are microseconds:

- tid 1: ``tb:step`` [0, 1000) > ``rt/forward_backward`` [10, 600) >
  ``rt/block`` [20, 200) > ``rt/attention`` [50, 150), with the forward
  ops of sequence numbers 7 (inside the attention, after an op outside
  the block that made no node and so carries 7 too), 8 (the attention's
  Function, around it) and 9 (in the block, outside the attention);
  ``rt/lm_head`` [200, 210); ``rt/allreduce`` [620, 700);
  ``rt/optimizer`` [700, 800);
- tid 2: node A (seq 7) [210, 260) with no span in it; node B (seq 9)
  [270, 380) holding a recompute, ``rt/block`` [275, 370) >
  ``rt/attention`` [280, 320), and a recompute op that reuses sequence
  number 7 on this thread; node C (seq 8) [382, 398) holding
  ``rt/attention/backward`` [383, 397);
- kernels by correlation: the attention's forward (launched in the
  nested spans), its backward through node A, its recompute, its marked
  backward, the embedding (in ``forward_backward`` alone), the LM head,
  an NCCL kernel on a second stream launched through the driver API,
  AdamW, a memcpy in ``tb:step`` alone, and one orphan kernel with no
  launch.
"""

import json

import pytest

from trainbench import run, span_trace, trace

F32 = ("f32f32", "simt_sgemm")


def _x(cat, name, tid, ts, dur, **args):
    return {"ph": "X", "cat": cat, "name": name, "pid": 1, "tid": tid,
            "ts": ts, "dur": dur, "args": args}


def _span(name, tid, t0, t1):
    return _x("user_annotation", name, tid, t0, t1 - t0)


def _op(name, tid, t0, t1, seq, fwd=0):
    return _x("cpu_op", name, tid, t0, t1 - t0,
              **{"Sequence number": seq, "Fwd thread id": fwd})


def _node(name, tid, t0, t1, seq):
    return _op("autograd::engine::evaluate_function: " + name, tid, t0, t1,
               seq, fwd=1)


def _launch(corr, tid, ts, cat="cuda_runtime", name="cudaLaunchKernel"):
    return _x(cat, name, tid, ts, 2, correlation=corr)


def _kernel(name, corr, t0, t1, stream=7, cat="kernel"):
    args = {"stream": stream}
    if corr is not None:
        args["correlation"] = corr
    return _x(cat, name, 0, t0, t1 - t0, **args)


EVENTS = [
    _span("tb:step", 1, 0, 1000),
    _span("rt/forward_backward", 1, 10, 600),
    _span("rt/block", 1, 20, 200),
    _op("aten::copy_", 1, 16, 17, 7),       # made no node: seq 7 is next
    _op("_Blockwise", 1, 45, 155, 8),
    _span("rt/attention", 1, 50, 150),
    _op("aten::bmm", 1, 60, 70, 7),
    _op("aten::mul", 1, 180, 190, 9),
    _span("rt/lm_head", 1, 200, 210),
    _span("rt/allreduce", 1, 620, 700),
    _span("rt/optimizer", 1, 700, 800),
    _node("BmmBackward0", 2, 210, 260, 7),
    _node("MulBackward0", 2, 270, 380, 9),
    _span("rt/block", 2, 275, 370),
    _span("rt/attention", 2, 280, 320),
    _op("aten::mm", 2, 285, 286, 7),
    _node("_BlockwiseBackward", 2, 382, 398, 8),
    _span("rt/attention/backward", 2, 383, 397),
    _launch(2, 1, 15),
    _launch(1, 1, 65),
    _launch(3, 1, 205),
    _launch(6, 2, 220),
    _launch(7, 2, 290),
    _launch(8, 2, 385),
    _launch(4, 1, 650, "cuda_driver", "cuLaunchKernelEx"),
    _launch(5, 1, 720),
    _launch(10, 1, 900, name="cudaMemcpyAsync"),
    _kernel("embedding_fwd", 2, 20, 40),
    _kernel("sm80_xmma_gemm_f32f32_attn", 1, 100, 130),
    _kernel("cutlass_80_simt_sgemm_attn_bwd", 6, 230, 250),
    _kernel("elementwise_exp", 7, 300, 310),
    _kernel("flash_bwd_ds", 8, 390, 395),
    _kernel("sm80_xmma_gemm_f32f32_lmhead", 3, 400, 460),
    _kernel("ncclDevKernel_AllReduce_Sum_f32", 4, 660, 760, stream=20),
    _kernel("adam_elementwise", 5, 740, 790),
    _kernel("Memcpy HtoD", 10, 905, 910, cat="gpu_memcpy"),
    _kernel("orphan_kernel", None, 950, 960),
]


@pytest.fixture
def chrome(tmp_path):
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": EVENTS}))
    return str(path)


def _us(x):
    return pytest.approx(x * 1e-6, abs=1e-12)


# (forward, recompute, backward, self, launches) in microseconds
EXPECTED = {
    "rt/attention": (30, 10, 25, 65, 4),
    "rt/block": (30, 10, 25, 0, 4),
    "rt/lm_head": (60, 0, 0, 60, 1),
    "rt/forward_backward": (110, 10, 25, 20, 6),
    "rt/allreduce": (100, 0, 0, 100, 1),
    "rt/optimizer": (50, 0, 0, 50, 1),
    "tb:step": (265, 10, 25, 5, 9),
}


def test_each_operation_goes_to_one_span(chrome):
    got = span_trace.by_span(chrome)
    assert set(got["spans"]) == set(EXPECTED)
    for name, (f, rc, b, own, n) in EXPECTED.items():
        sp = got["spans"][name]
        assert sp["forward_s"] == _us(f), name
        assert sp["recompute_s"] == _us(rc), name
        assert sp["backward_s"] == _us(b), name
        assert sp["self_s"] == _us(own), name
        assert sp["launches"] == n, name
    assert got["unattributed"] == {"seconds": _us(10), "launches": 1,
                                   "top": [["orphan_kernel", _us(10)]]}
    assert got["total_s"] == _us(310)
    assert got["launches"] == 10
    # the partition: every operation's seconds exactly once
    parts = sum(v["self_s"] for v in got["spans"].values())
    assert parts + got["unattributed"]["seconds"] == _us(310)


def test_idle_gaps_named_by_the_launching_thread(chrome):
    got = span_trace.by_span(chrome)["idle_gaps"]
    assert [g[:2] for g in got] == [
        ["rt/forward_backward", "forward"],    # 460 -> 660, before NCCL
        ["rt/optimizer", "forward"],           # 790 -> 905
        ["outside_spans", None],               # 130 -> 230, autograd idle
        ["rt/attention", "recompute"],         # 310 -> 390
        ["rt/block", "forward"],               # 40 -> 100
        ["rt/attention", "backward"],          # 250 -> 300, node A
        ["tb:step", "forward"],                # 910 -> 950, orphan next
        ["rt/forward_backward", "forward"],    # 395 -> 400
    ]
    assert [g[2] for g in got] == [_us(d) for d in
                                   (200, 115, 100, 80, 60, 50, 40, 5)]
    # the host op the thread was in: a node, an op, or nothing
    assert [g[3] for g in got] == [
        None, None, None, "autograd::engine::evaluate_function: MulBackward0",
        None, "autograd::engine::evaluate_function: BmmBackward0",
        None, None]


def test_float32_products_by_span(chrome):
    records, _ = span_trace.attribute(span_trace.load_events(chrome))
    got = span_trace.matching(records, *F32)
    assert got["total"] == _us(110)
    assert got["rt/attention"] == _us(50)
    assert got["rt/lm_head"] == _us(60)
    assert "unattributed" not in got


def test_reduce_is_unchanged_on_the_same_trace(chrome):
    got = trace.reduce(chrome)
    assert set(got) == {"busy_s", "kernels", "idle_gaps", "first_op_s",
                        "last_op_s"}
    assert got["busy_s"] == _us(290)
    assert got["first_op_s"] == _us(20)
    assert got["last_op_s"] == _us(960)
    assert got["kernels"]["ncclDevKernel_AllReduce_Sum_f32"] == {
        "seconds": _us(100), "launches": 1}
    assert len(got["kernels"]) == 10
    assert sum(v["launches"] for v in got["kernels"].values()) == 10
    assert [g[0] for g in got["idle_gaps"]] == ["step"] * 8
    assert [g[1] for g in got["idle_gaps"]] == [
        _us(d) for d in (200, 115, 100, 80, 60, 50, 40, 5)]


def _ctx(chrome, steps=2):
    got = span_trace.by_span(chrome)
    ranks = [{"rank": 0, "trace": {"steps": steps, "by_span": got}},
             {"rank": 1, "trace": {"steps": steps, "by_span": {
                 "spans": {"rt/attention": {"forward_s": 1e-3,
                                            "recompute_s": 0.0,
                                            "backward_s": 0.0}}}}}]
    return {"ranks": ranks}


@pytest.mark.parametrize("name, ms", [
    ("attention_ms", 0.5),             # rank 1's 1 ms over 2 steps
    ("lm_head_ms", 60e-3 / 2),
    ("optimizer_ms", 50e-3 / 2),
])
def test_readers_take_the_highest_rank(chrome, name, ms):
    assert run._reader(name)(_ctx(chrome)) == pytest.approx(ms)


@pytest.mark.parametrize("name", ["attention_ms", "lm_head_ms",
                                  "optimizer_ms"])
def test_readers_find_nothing_without_spans(name):
    # a program with no spans, or a trace reduced without them
    ctx = {"ranks": [{"rank": 0, "trace": {"steps": 3, "busy_s": 1.0}},
                     {"rank": 1}]}
    assert run._reader(name)(ctx) is None


def test_breakdown_keys(chrome):
    got = span_trace.breakdown({"steps": 2,
                                "by_span": span_trace.by_span(chrome)})
    ms = got["device_by_span"]
    assert list(ms)[0] == "rt/allreduce"
    assert ms["rt/allreduce"] == pytest.approx(0.05)
    assert ms["unattributed"] == pytest.approx(0.005)
    assert sum(ms.values()) == pytest.approx(0.155)
    assert got["idle_gaps_by_span"][0][0] == "rt/forward_backward"
    assert span_trace.breakdown({"steps": 2}) == {}


def test_span_run_reads_the_harness_trace(monkeypatch):
    """``span_run`` stores ``by_span`` beside ``trace.reduce``'s keys for
    the trace of the harness's own traced steps (on the CPU the trace has
    host events alone, so nothing is put down to a span)."""
    import torch
    from trainbench import harness, span_run
    from trainbench.tests import tiny
    monkeypatch.setattr(trace, "reduce", trace.reduce)
    span_run._wrap_reduce()
    c = tiny.cell("granite-3-8b-8L", seq_len=16)
    res = harness.run(c, 2 ** 31 + 9, 0.05, True, torch.device("cpu"),
                      t_start=0.0)
    tr = res["trace"]
    assert {"busy_s", "kernels", "idle_gaps", "by_span",
            "f32_products"} <= set(tr)
    assert tr["by_span"]["total_s"] == 0 and tr["by_span"]["spans"] == {}
    summary = span_run._rank_summary(res)
    assert summary["steps"] == tr["steps"] and summary["device_s"] == 0
