"""The training step's spans (``repro_torch.spans``).

Under the CPU profiler, one dedup step (``make_train_step(dedup=True)``)
and one manual-collective step (``make_manual_collective_train_step``,
streaming chunk 1) of granite-3-8b's smoke config in float32:

- every named span appears, as often as the step opens it, nested as
  placed: ``block`` inside ``forward_backward``, ``attention`` inside
  ``block``, ``lm_head`` inside ``forward_backward`` and outside every
  ``block``; ``combine``, ``allreduce``, ``optimizer`` and
  ``step_metrics`` outside ``forward_backward``;
- ``block`` and ``attention`` are entered again inside the backward's
  nodes (the recompute), and ``attention/backward`` only there;
- the step's loss, parameters and optimizer state are bit for bit those
  of the same step with no profiler;
- with no profiler, ``span`` makes no ``record_function``.

On the card (marker ``cuda``), the device time of a smoke step that no
span takes (``trainbench.span_trace.by_span``) is under 3 % of the step's.
"""

import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import spans as S
from repro_torch import tree as T
from repro_torch.configs import CodingConfig, get_config
from repro_torch.core import step_weights as sw
from repro_torch.data.pipeline import CodedBatcher, SyntheticLM
from repro_torch.dist import coded_train as TT
from repro_torch.models import model as M
from repro_torch.optim import optimizers as opt_mod

NODE = "autograd::engine::evaluate_function:"
W = np.array([1.0, 0.0, 0.7, 2.0])
LAYERS = 2


@pytest.fixture(scope="module", autouse=True)
def _deterministic_two_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(False)
    torch.set_num_threads(threads)


def _cfg(**over):
    return get_config("granite-3-8b").smoke_variant().with_overrides(
        n_layers=LAYERS, **over)


def _case(path, dev, cfg):
    """(step, its inputs) for one path."""
    A = TT.make_assignment(CodingConfig(replication=2), 4)
    raw = SyntheticLM(cfg.vocab_size, 32, seed=0).batch(A.n * 2, 0)
    batcher = CodedBatcher(A, shuffle_seed=0)
    opt = opt_mod.get_optimizer("adamw", 1e-3)
    if path == "dedup":
        step = TT.make_train_step(
            cfg, opt, dedup=True, norm_scale=TT.dedup_norm_scale(A),
            alpha_weights=TT.alpha_bar_weights(A))
        batch, w = batcher.unique_blocks(raw), sw.block_weights(A, W)
    else:
        step = TT.make_manual_collective_train_step(
            cfg, opt, alpha_weights=TT.alpha_bar_weights(A),
            streaming_chunk=1)
        batch, w = batcher.code_batch(raw), W
    batch = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
    w = torch.tensor(np.asarray(w, np.float32), device=dev)
    params = M.init_params(cfg, seed=0, device=dev)
    return step, params, opt.init(params), batch, w


def _run(path, dev, cfg, trace_path=None, acts=(ProfilerActivity.CPU,),
         warm=False):
    step, params, opt_state, batch, w = _case(path, dev, cfg)
    if warm:
        step(T.map(torch.clone, params), opt_state, batch, w)
    if trace_path is None:
        return step(params, opt_state, batch, w)
    with profile(activities=list(acts)) as prof:
        out = step(params, opt_state, batch, w)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    prof.export_chrome_trace(str(trace_path))
    return out


def _intervals(trace_path):
    """(the program's spans, backward nodes) as (t0, t1, name) lists."""
    events = json.loads(trace_path.read_text())["traceEvents"]
    spans, nodes = [], []
    for ev in events:
        if ev.get("ph") != "X":
            continue
        t0 = float(ev["ts"])
        iv = (t0, t0 + float(ev["dur"]), ev["name"])
        if (ev.get("cat") == "user_annotation"
                and ev["name"].startswith(S.PREFIX)):
            spans.append((iv[0], iv[1], ev["name"][len(S.PREFIX):]))
        elif ev.get("cat") == "cpu_op" and ev["name"].startswith(NODE):
            nodes.append(iv)
    return spans, nodes


def _inside(iv, outer):
    return any(o[0] <= iv[0] and iv[1] <= o[1] for o in outer)


def _named(spans, name):
    return [s for s in spans if s[2] == name]


# per path: how many times one step opens each span (two layers; the
# manual path runs m = 4 machines, one a chunk, one backward each)
COUNTS = {
    "dedup": {"forward_backward": 1, "block": 2 * LAYERS,
              "attention": 2 * LAYERS, "attention/backward": LAYERS,
              "lm_head": 1, "allreduce": 2, "optimizer": 1,
              "step_metrics": 1},
    "manual": {"forward_backward": 4, "block": 8 * LAYERS,
               "attention": 8 * LAYERS, "attention/backward": 4 * LAYERS,
               "lm_head": 4, "combine": 4, "allreduce": 2, "optimizer": 1,
               "step_metrics": 1},
}


@pytest.mark.parametrize("path", ["dedup", "manual"])
def test_spans_nest_where_placed(path, tmp_path):
    trace = tmp_path / "trace.json"
    _run(path, torch.device("cpu"), _cfg(), trace)
    spans, nodes = _intervals(trace)
    got = {}
    for s in spans:
        got[s[2]] = got.get(s[2], 0) + 1
    assert got == COUNTS[path]
    fb, blocks = _named(spans, "forward_backward"), _named(spans, "block")
    assert all(_inside(b, fb) for b in blocks)
    assert all(_inside(a, blocks) for a in _named(spans, "attention"))
    for s in _named(spans, "lm_head"):
        assert _inside(s, fb) and not _inside(s, blocks)
    for name in ("combine", "allreduce", "optimizer", "step_metrics"):
        assert not any(_inside(s, fb) for s in _named(spans, name))
    # the recompute enters each layer's block, and its attention, again
    # inside the backward; the attention's backward runs only there
    per_fb = COUNTS[path]["forward_backward"]
    assert sum(_inside(b, nodes) for b in blocks) == LAYERS * per_fb
    att = _named(spans, "attention")
    assert sum(_inside(a, nodes) for a in att) == LAYERS * per_fb
    assert all(_inside(a, nodes) for a in _named(spans, "attention/backward"))


@pytest.mark.parametrize("path", ["dedup", "manual"])
def test_spans_change_no_number(path, tmp_path):
    cpu, cfg = torch.device("cpu"), _cfg()
    plain = _run(path, cpu, cfg)
    traced = _run(path, cpu, cfg, tmp_path / "trace.json")
    for a, b in zip(plain[:2], traced[:2]):
        la, lb = T.leaves(a), T.leaves(b)
        assert len(la) == len(lb)
        assert all(torch.equal(x, y) for x, y in zip(la, lb))
    assert torch.equal(plain[2]["loss"], traced[2]["loss"])
    assert torch.equal(plain[2]["grad_norm"], traced[2]["grad_norm"])


def test_no_record_function_without_a_profiler(monkeypatch):
    made = []

    class Counting(torch.profiler.record_function):
        def __init__(self, *a, **kw):
            made.append(a)
            super().__init__(*a, **kw)

    monkeypatch.setattr(torch.profiler, "record_function", Counting)
    assert S.span("block") is S.span("optimizer", backward=True)
    _run("dedup", torch.device("cpu"), _cfg())
    assert made == []
    with profile(activities=[ProfilerActivity.CPU]):
        with S.span("block"):
            pass
    assert made == [("rt/block",)]


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["dedup", "manual"])
def test_card_step_device_time_lies_in_spans(path, tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the device trace has no CPU mode")
    from trainbench import span_trace
    dev = torch.device("cuda", torch.cuda.current_device())
    trace = tmp_path / "trace.json"
    _run(path, dev, _cfg(dtype="bfloat16"), trace,
         acts=(ProfilerActivity.CPU, ProfilerActivity.CUDA), warm=True)
    got = span_trace.by_span(str(trace))
    assert got["total_s"] > 0
    assert got["unattributed"]["seconds"] < 0.03 * got["total_s"], \
        got["unattributed"]
    sp = got["spans"]
    assert sp["rt/attention"]["forward_s"] > 0
    assert sp["rt/attention"]["recompute_s"] > 0
    assert sp["rt/attention"]["backward_s"] > 0
    assert sp["rt/block"]["backward_s"] > 0
    assert sp["rt/lm_head"]["backward_s"] > 0
    assert sp["rt/optimizer"]["forward_s"] > 0
