"""The port's coded training over a real process group: W = 2 and 4
``gloo`` ranks on the CPU, spawned with ``torch.multiprocessing`` and
joined over a ``FileStore`` in the test's directory.

- The three coded allreduces on W ranks (each reducing its m/W rows,
  then the float32 all_reduce) equal the single-process combine: bit
  for bit for the quantized and packed payloads on exact inputs
  (integer payloads, power-of-two weights and scales, a dead row, so
  every float32 partial sum is exact), within 1e-6 for float32.
- The manual step on W ranks, materialising and streaming, equals the
  one-process step: the update of one SGD step at lr 1 within rtol 2e-4
  / atol 2e-5 and the loss within rtol 1e-5 (the reference's
  reassociation tolerances, tests/test_dist.py).
- The FSDP step over 3 AdamW steps equals the replicated step on the
  same ranks: losses and grad norms within rtol 1e-5, parameters and v
  within rtol 1e-5 but for 0.1 % of entries (reason in the test); at
  one rank bit for bit. Each rank's resident parameter bytes equal
  ``bytes_per_device`` under ``fsdp_specs`` and are under the
  replicated bytes.
- The dedup block fallback: with n blocks not a multiple of W every
  rank keeps all of them, and the step equals the one-process step.
- ``--production-mesh`` refuses at W = 4, naming both sizes.
- The training driver under ``--chaos`` on W = 2 ranks (qwen1.5-4b smoke
  variant, 12 steps; tests/test_torch_dist_driver.py's flags) against the
  port's one-process driver: ``kill:1@3`` (m = 4 -> 3, the 3 blocks
  kept whole on both ranks), the same under ``--compress int8`` (the
  residual follows), and ``--machines 6 --chaos rack:1,2@3`` under int8
  (6 -> 4 blocks: blocks and residual rows re-split, 2 a rank). The
  chaos objects equal (but ``rebuild_s``), the losses within rtol 1e-4
  (the drivers' tolerance), every rank reporting the same losses.

Parameters reach the ranks as NumPy through ``models.convert``; every
rank runs under ``torch.use_deterministic_algorithms`` so its
per-machine gradients are the one-process step's.
"""

import os

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch import tree as T
from repro_torch.configs import CodingConfig, get_config
from repro_torch.core import compress as tcomp
from repro_torch.data.pipeline import CodedBatcher, SyntheticLM
from repro_torch.dist import coded_train as TT
from repro_torch.dist import process_group as pg
from repro_torch.dist.fsdp import FSDP, resident_bytes
from repro_torch.dist.sharding import bytes_per_device, fsdp_specs
from repro_torch.kernels.coded_combine import ops as cc_ops
from repro_torch.launch import train as ttrain
from repro_torch.models import model as M
from repro_torch.models.convert import params_from_numpy
from repro_torch.optim import optimizers as opt_mod

UPD_TOL = dict(rtol=2e-4, atol=2e-5)


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two torch threads: the suite's other workers share the host."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


# ------------------------------------------------------------- harness
#
# Each world size is spawned once, for every job of the module at that
# size; a job that raises in a rank is reported by its own test only.

def _entry(rank, world, tmp, jobs):
    import traceback
    torch.set_num_threads(1)
    torch.use_deterministic_algorithms(True)
    store = dist.FileStore(os.path.join(tmp, "store"), world)
    dist.init_process_group("gloo", store=store, rank=rank,
                            world_size=world)
    out = {}
    try:
        for key, (name, args) in jobs.items():
            try:
                out[key] = ("ok", globals()[name](rank, world, *args))
            except BaseException:           # reported by the job's test
                out[key] = ("error", traceback.format_exc())
        torch.save(out, os.path.join(tmp, f"out{rank}.pt"))
    finally:
        dist.destroy_process_group()


_DONE = {}


def _results(world, key, tmp_path_factory):
    """What each of ``world`` ranks returned for job ``key``."""
    if world not in _DONE:
        tmp = tmp_path_factory.mktemp(f"world{world}")
        jobs = {k: v for (w, k), v in _jobs().items() if w == world}
        mp.spawn(_entry, args=(world, str(tmp), jobs), nprocs=world,
                 join=True)
        _DONE[world] = [torch.load(tmp / f"out{r}.pt", weights_only=False)
                        for r in range(world)]
    outs = []
    for rank_out in _DONE[world]:
        status, value = rank_out[key]
        if status != "ok":
            raise AssertionError(f"rank job {key} raised:\n{value}")
        outs.append(value)
    return outs


def _np_tree(tree):
    return T.map(lambda x: x.detach().numpy().copy(), tree)


def _setup(arch="granite-3-8b", m=4, scheme="expander", bs=2, S=16):
    cfg = get_config(arch).smoke_variant()
    A = TT.make_assignment(CodingConfig(scheme=scheme, replication=2), m)
    batcher = CodedBatcher(A, shuffle_seed=0)
    raw = SyntheticLM(cfg.vocab_size, S, seed=0).batch(A.n * bs, 0)
    tree = _np_tree(M.init_params(cfg, seed=3, device="cpu"))
    return cfg, A, batcher.code_batch(raw), batcher.unique_blocks(raw), tree


def _tb(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _update(p1, p0):
    return [(a.double() - b.double()).numpy()
            for a, b in zip(T.leaves(p1), T.leaves(p0))]


# ------------------------------------------------------ the allreduces

def _exact_inputs(m, seed=0):
    rng = np.random.default_rng(seed)
    w = (2.0 ** rng.integers(-3, 3, m)).astype(np.float32)
    w[m // 2] = 0.0
    scales = {k: (2.0 ** rng.integers(-4, 2, m)).astype(np.float32)
              for k in ("a", "b")}
    q = {"a": rng.integers(-127, 128, (m, 37)).astype(np.int8),
         "b": rng.integers(-127, 128, (m, 5)).astype(np.int8)}
    packed = {"a": rng.integers(0, 256, (m, 5)).astype(np.uint8),
              "b": rng.integers(0, 256, (m, 1)).astype(np.uint8)}
    shapes = {"a": (37,), "b": (5,)}
    g = {"a": rng.standard_normal((m, 6, 7)).astype(np.float32),
         "b": rng.standard_normal((m, 11)).astype(np.float32)}
    return w, scales, q, packed, shapes, g


def _allreduces(rank, world, m):
    workers = pg.init_workers("cpu")
    w, scales, q, packed, shapes, g = _exact_inputs(m)
    rows = pg.row_block(m, world, rank)

    def mine(t):
        return {k: torch.from_numpy(v[rows]) for k, v in t.items()}

    w_l = torch.from_numpy(w[rows])
    return {
        "float32": TT.coded_allreduce(mine(g), w_l, workers),
        "int8": TT.quantized_coded_allreduce(mine(q), mine(scales), w_l,
                                             workers),
        "packed": TT.packed_sign_coded_allreduce(
            mine(packed), mine(scales), w_l, shapes, workers),
        "all_reduce_bytes": pg.traffic["all_reduce"],
    }


@pytest.mark.parametrize("world", [2, 4])
def test_coded_allreduces_equal_the_single_process_combine(
        world, tmp_path_factory):
    w, scales, q, packed, shapes, g = _exact_inputs(M_ALLREDUCE)
    full = _tb
    want = {
        "float32": cc_ops.coded_combine_tree(full(g), torch.from_numpy(w)),
        "int8": cc_ops.quantized_combine_tree(full(q), full(scales),
                                              torch.from_numpy(w)),
        "packed": cc_ops.packed_sign_combine_tree(
            full(packed), full(scales), torch.from_numpy(w), shapes),
    }
    for out in _results(world, "allreduce", tmp_path_factory):
        for k in ("int8", "packed"):
            for a, b in zip(T.leaves(out[k]), T.leaves(want[k])):
                assert torch.equal(a, b), k
        for a, b in zip(T.leaves(out["float32"]),
                        T.leaves(want["float32"])):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6,
                                       atol=1e-6)
        # one float32 all_reduce of each combined leaf, three combines
        per_call = sum(x.numel() * 4 for x in T.leaves(want["float32"]))
        assert out["all_reduce_bytes"] >= per_call


# ------------------------------------------------- the manual step

def _manual(rank, world, tree, coded, w, chunk, codec):
    workers = pg.init_workers("cpu")
    cfg = get_config("granite-3-8b").smoke_variant()
    params = params_from_numpy(tree, cfg, device="cpu")
    opt = opt_mod.sgd(1.0)
    step = TT.make_manual_collective_train_step(
        cfg, opt, compress=codec, streaming_chunk=chunk, workers=workers)
    with torch.no_grad():
        if codec:
            resid = tcomp.init_state(params, w.shape[0] // world)
            p1, _, c1, met = step(params, opt.init(params), resid,
                                  _tb(coded), torch.from_numpy(w))
            return {"params": p1, "loss": met["loss"],
                    "residual": c1["residual"]}
        p1, _, met = step(params, opt.init(params), _tb(coded),
                          torch.from_numpy(w))
    return {"params": p1, "loss": met["loss"],
            "grad_norm": met["grad_norm"]}


MANUAL = [(2, None, None), (4, None, None), (2, 1, None), (2, 1, "int8")]


@pytest.mark.parametrize("world,chunk,codec", MANUAL)
def test_manual_step_on_w_ranks_equals_one_rank(world, chunk, codec,
                                                tmp_path_factory):
    cfg, A, coded, _, tree = _setup()
    params = params_from_numpy(tree, cfg, device="cpu")
    opt = opt_mod.sgd(1.0)
    step = TT.make_manual_collective_train_step(cfg, opt, compress=codec)
    w = torch.from_numpy(W_MANUAL)
    torch.use_deterministic_algorithms(True)
    try:
        with torch.no_grad():
            if codec:
                p1, _, c1, m1 = step(params, opt.init(params),
                                     tcomp.init_state(params, A.m),
                                     _tb(coded), w)
            else:
                p1, _, m1 = step(params, opt.init(params), _tb(coded), w)
    finally:
        torch.use_deterministic_algorithms(False)
    want = _update(p1, params)
    outs = _results(world, ("manual", chunk, codec), tmp_path_factory)
    for rank, out in enumerate(outs):
        np.testing.assert_allclose(out["loss"].item(), m1["loss"].item(),
                                   rtol=1e-5)
        for a, b in zip(_update(out["params"], params), want):
            np.testing.assert_allclose(a, b, **UPD_TOL)
        if codec:
            # this rank's machines of the one-process residual
            rows = pg.row_block(A.m, world, rank)
            for a, b in zip(T.leaves(out["residual"]),
                            T.leaves(c1["residual"])):
                np.testing.assert_allclose(a.numpy(), b[rows].numpy(),
                                           rtol=2e-4, atol=2e-4)
        else:
            np.testing.assert_allclose(out["grad_norm"].item(),
                                       m1["grad_norm"].item(), rtol=1e-5)


# ------------------------------------------------------------ FSDP

def _fsdp(rank, world, tree, blocks, ws, ns):
    workers = pg.init_workers("cpu")
    cfg = get_config("granite-3-8b").smoke_variant()
    out = {}
    for placed in ("replicated", "fsdp"):
        params = params_from_numpy(tree, cfg, device="cpu")
        opt = opt_mod.adamw(1e-3)
        fsdp = FSDP(params, workers) if placed == "fsdp" else None
        opt_state = opt.init(params)
        if fsdp is not None:
            params = fsdp.shard(params)
            opt_state = fsdp.opt_shard(opt_state)
            out["resident"] = resident_bytes(params)
            out["resident_m"] = resident_bytes(opt_state["m"])
        step = TT.make_train_step(cfg, opt, dedup=True, norm_scale=ns,
                                  workers=workers, fsdp=fsdp)
        losses, norms = [], []
        with torch.no_grad():
            for w in ws:
                params, opt_state, met = step(params, opt_state,
                                              _tb(blocks),
                                              torch.from_numpy(w))
                losses.append(met["loss"].item())
                norms.append(met["grad_norm"].item())
        if fsdp is not None:
            params = fsdp.gather(params)
            opt_state = fsdp.opt_gather(opt_state)
        out[placed] = {"params": params, "v": opt_state["v"],
                       "losses": losses, "norms": norms}
    return out


@pytest.mark.parametrize("world", [2, 4])
def test_fsdp_step_equals_replicated_step(world, tmp_path_factory):
    """Losses and grad norms within rtol 1e-5; the parameters and
    AdamW's v within rtol 1e-5 (atol 1e-8 and 1e-12) on all but 1e-3 of
    each leaf's entries, and every parameter within 2 lr a step: AdamW
    divides by sqrt(v), so an entry whose gradient sums to nearly zero
    moves by another fraction of lr when the ranks' partial sums are
    added in another order -- gloo's reduce-scatter and all-reduce order
    them differently at W = 4 -- and the next steps' gradients see that
    (tests/test_torch_train.py's trajectory tolerance has the same
    reason)."""
    cfg, A, _, blocks, tree = _setup()
    params = params_from_numpy(tree, cfg, device="cpu")
    layout = pg.make_test_layout((world, 1))
    want_bytes = bytes_per_device(params, fsdp_specs(params, layout),
                                  layout)
    lr, steps = 1e-3, 3
    for out in _results(world, "fsdp", tmp_path_factory):
        rep, sh = out["replicated"], out["fsdp"]
        np.testing.assert_allclose(sh["losses"], rep["losses"], rtol=1e-5)
        np.testing.assert_allclose(sh["norms"], rep["norms"], rtol=1e-5)
        for key, atol in (("params", 1e-8), ("v", 1e-12)):
            for a, b in zip(T.leaves(sh[key]), T.leaves(rep[key])):
                d = (a - b).abs().numpy()
                off = d > atol + 1e-5 * b.abs().numpy()
                assert off.sum() <= 1e-3 * d.size, (key, int(off.sum()))
                if key == "params":
                    assert d.max() <= 2 * lr * steps
        assert out["resident"] == want_bytes
        assert out["resident_m"] == want_bytes      # float32 params
        assert out["resident"] < resident_bytes(params)


def test_fsdp_at_one_rank_is_the_replicated_step_bit_for_bit():
    cfg, A, _, blocks, tree = _setup()
    w = (A.A @ np.asarray([1.0, 0.0, 0.5, 1.0])).astype(np.float32)
    outs = []
    torch.use_deterministic_algorithms(True)
    try:
        for placed in (False, True):
            params = params_from_numpy(tree, cfg, device="cpu")
            opt = opt_mod.adamw(1e-3)
            fsdp = FSDP(params, pg.SINGLE) if placed else None
            step = TT.make_train_step(
                cfg, opt, dedup=True, norm_scale=TT.dedup_norm_scale(A),
                workers=pg.SINGLE, fsdp=fsdp)
            with torch.no_grad():
                outs.append(step(params, opt.init(params), _tb(blocks),
                                 torch.from_numpy(w)))
    finally:
        torch.use_deterministic_algorithms(False)
    (p0, s0, m0), (p1, s1, m1) = outs
    for a, b in zip(T.leaves(p0) + T.leaves(s0["v"]),
                    T.leaves(p1) + T.leaves(s1["v"])):
        assert torch.equal(a, b)
    assert torch.equal(m0["grad_norm"], m1["grad_norm"])


# ------------------------------------ dedup fallback and the refusals

def _dedup(rank, world, tree, blocks, v, ns):
    workers = pg.init_workers("cpu")
    cfg = get_config("granite-3-8b").smoke_variant()
    params = params_from_numpy(tree, cfg, device="cpu")
    opt = opt_mod.sgd(1.0)
    step = TT.make_train_step(cfg, opt, dedup=True, norm_scale=ns,
                              workers=workers)
    before = pg.traffic["all_reduce"]
    with torch.no_grad():
        p1, _, met = step(params, opt.init(params), _tb(blocks),
                          torch.from_numpy(v))
    return {"params": p1, "loss": met["loss"],
            "all_reduce": pg.traffic["all_reduce"] - before}


def test_dedup_blocks_stay_whole_when_n_is_not_a_multiple_of_w(
        tmp_path_factory):
    # FRC at m = 4, d = 2 has n = 2 blocks: they do not split over 4
    cfg, A, _, blocks, tree = _setup(scheme="frc")
    assert A.n == 2 and not pg.block_rows_split(A.n, 4)
    assert pg.block_rows_split(4, 4) and not pg.block_rows_split(4, 1)
    params = params_from_numpy(tree, cfg, device="cpu")
    opt = opt_mod.sgd(1.0)
    torch.use_deterministic_algorithms(True)
    try:
        with torch.no_grad():
            p1, _, m1 = TT.make_train_step(
                cfg, opt, dedup=True, norm_scale=TT.dedup_norm_scale(A))(
                params, opt.init(params), _tb(blocks),
                torch.from_numpy(_frc_v(A)))
    finally:
        torch.use_deterministic_algorithms(False)
    for out in _results(4, "dedup", tmp_path_factory):
        # every rank computed every block: nothing to sum across ranks
        assert out["all_reduce"] == 0
        assert out["loss"].item() == m1["loss"].item()
        for a, b in zip(T.leaves(out["params"]), T.leaves(p1)):
            assert torch.equal(a, b)


def _production(rank, world):
    try:
        pg.init_workers("cpu", production=True)
    except ValueError as exc:
        return str(exc)
    return None


def test_production_mesh_refuses_at_four_ranks(tmp_path_factory):
    for msg in _results(4, "production", tmp_path_factory):
        assert msg is not None and "256" in msg and "has 4" in msg
    with pytest.raises(ValueError, match="256"):
        pg.init_workers("cpu", production=True)


DRIVER_FLAGS = ["--device", "cpu", "--arch", "qwen1.5-4b", "--steps",
                "12", "--seq-len", "32", "--block-size", "2"]
CHAOS_RUNS = {"kill": ["--chaos", "kill:1@3"],
              "kill-int8": ["--chaos", "kill:1@3", "--compress", "int8"],
              "rack-int8": ["--machines", "6", "--chaos", "rack:1,2@3",
                            "--compress", "int8"]}
_ONE_PROCESS = {}


def _driver(rank, world, argv):
    # the data axis alone: layout (2, 1)
    return ttrain.main(argv, model=1)


def _without_rebuild_s(chaos):
    return {**chaos, "reassignments": [
        {k: v for k, v in r.items() if k != "rebuild_s"}
        for r in chaos["reassignments"]]}


@pytest.mark.parametrize("run", list(CHAOS_RUNS))
def test_chaos_driver_on_two_ranks_matches_one_process(run,
                                                       tmp_path_factory):
    outs = _results(2, ("driver", run), tmp_path_factory)
    if run not in _ONE_PROCESS:
        _ONE_PROCESS[run] = ttrain.main(DRIVER_FLAGS + CHAOS_RUNS[run])
    single, p = _ONE_PROCESS[run], outs[0]
    assert p["world_size"] == 2 and single["world_size"] == 1
    assert _without_rebuild_s(p["chaos"]) == \
        _without_rebuild_s(single["chaos"])
    (re,) = p["chaos"]["reassignments"]
    assert re["n_blocks"] == (4 if run == "rack-int8" else 3)
    np.testing.assert_allclose(p["losses"], single["losses"], rtol=1e-4)
    assert outs[1]["losses"] == p["losses"]


# ------------------------------------------------- the jobs, by world

M_ALLREDUCE = 8
W_MANUAL = np.asarray([1.0, 0.0, 0.7, 2.0], np.float32)


def _frc_v(A):
    return (A.A @ np.asarray([1.0, 0.0, 0.5, 1.0])).astype(np.float32)


def _jobs():
    """(world, key) -> (rank function name, its arguments)."""
    _, A, coded, blocks, tree = _setup()
    rng = np.random.default_rng(1)
    ws = [(A.A @ (rng.random(A.m) * (rng.random(A.m) > 0.2)))
          .astype(np.float32) for _ in range(3)]
    _, A_frc, _, blocks_frc, tree_frc = _setup(scheme="frc")
    jobs = {}
    for world in (2, 4):
        jobs[(world, "allreduce")] = ("_allreduces", (M_ALLREDUCE,))
        jobs[(world, "fsdp")] = ("_fsdp", (tree, blocks, ws,
                                           TT.dedup_norm_scale(A)))
    for world, chunk, codec in MANUAL:
        jobs[(world, ("manual", chunk, codec))] = (
            "_manual", (tree, coded, W_MANUAL, chunk, codec))
    jobs[(4, "dedup")] = ("_dedup", (tree_frc, blocks_frc, _frc_v(A_frc),
                                     TT.dedup_norm_scale(A_frc)))
    jobs[(4, "production")] = ("_production", ())
    for run, flags in CHAOS_RUNS.items():
        jobs[(2, ("driver", run))] = ("_driver", (DRIVER_FLAGS + flags,))
    return jobs


def test_fsdp_splits_only_the_worker_axis_on_the_production_layout():
    """On (data=16, model=16) the placements also name the model axis,
    which is not executed: a rank's shard splits the data dim alone."""
    from repro_torch.launch.mesh import make_production_layout
    from repro_torch.models.convert import param_shapes
    layout = make_production_layout()
    shapes = T.unflatten({k: torch.empty(v, device="meta") for k, v in
                          param_shapes(get_config("granite-3-8b")).items()})
    fsdp = FSDP(shapes, pg.Workers(size=16, rank=3, layout=layout))
    shards = fsdp.shard(shapes)
    n_model = 0
    for x, s, spec in zip(T.leaves(shapes), T.leaves(shards),
                          T.leaves(fsdp.specs)):
        want = list(x.shape)
        for d, entry in enumerate(spec):
            if entry == "data":
                want[d] //= 16
            n_model += entry == "model"
        assert list(s.shape) == want, (spec, x.shape, s.shape)
    assert n_model > 0     # the layout does name the model axis
