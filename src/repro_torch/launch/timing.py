"""Timing on the card with CUDA events (measurement scripts only)."""

from __future__ import annotations

from typing import Callable

import torch


def call_ms(fn: Callable[[], object], iters: int = 50,
            warmup: int = 5) -> float:
    """Wall time per call of ``fn`` issued back to back from Python,
    between CUDA events: for a small kernel, the host's launch rate."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn: Callable[[], object], reps: int = 20,
             iters: int = 10) -> float:
    """Device time per call of ``fn``: ``reps`` calls captured in one CUDA
    graph (after warm-up on a side stream), replayed ``iters`` times
    between CUDA events, so no host launch gap sits between the kernels
    that are timed."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (iters * reps)
