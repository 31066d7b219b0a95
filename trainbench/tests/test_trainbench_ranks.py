"""The harness's loop on several ranks (the four-card cell's path) on
the CPU: two ``gloo`` ranks over a ``FileStore``, the manual coded
collective with one streamed machine a chunk. A sound run is correct
on rank 0; with the exchange between ranks left out it is not."""

import json

import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from trainbench import harness
from trainbench.tests import tiny

WORLD = 2


def _rank(rank, store_path, out_path, fault):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, WORLD),
                           rank=rank, world_size=WORLD)
    try:
        P = harness._program()
        if fault:
            P["pg"].Workers.all_reduce_ = lambda self, x, op="sum": x
        workers = P["pg"].init_workers(torch.device("cpu"), model=1)
        c = tiny.cell("granite-3-8b-8L", "manual-4chip", seq_len=16,
                      chips=WORLD)
        res = harness.run(c, 2 ** 31 + 41, 0.3, True,
                          torch.device("cpu"), t_start=0.0, workers=workers)
        if rank == 0:
            with open(out_path, "w") as f:
                json.dump({"correct": res["check"]["correct"],
                           "numbers": res["check"]["numbers"],
                           "steps": res["window_steps"],
                           "moved": res["traffic_bytes_per_step"]}, f)
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("fault", [False, True])
def test_ranks(tmp_path, fault):
    out = tmp_path / "rank0.json"
    mp.spawn(_rank, args=(str(tmp_path / "store"), str(out), fault),
             nprocs=WORLD, join=True)
    res = json.loads(out.read_text())
    assert res["steps"] >= 1
    assert res["correct"] is (not fault), res["numbers"]
    if not fault:
        assert res["moved"]["all_reduce"] > 0
