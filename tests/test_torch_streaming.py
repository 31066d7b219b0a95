"""The streaming combine of the port's manual collective against the
reference's (``tests/test_streaming.py``), on the CPU.

- The machine regrouping ``_to_stream_chunks`` / ``_from_stream_chunks``
  equals the reference's bit for bit, and round-trips.
- The port's streaming step equals the reference's streaming step on
  ``make_test_mesh((1, 1))``, from the same parameters (through
  ``models.convert``), batch and weights, for no codec, int8 and
  sign_packed at chunk 1 and 2: the loss and grad_norm within rtol 2e-4,
  and the update of one SGD step at lr 1 -- the combined gradient --
  within rtol 2e-4 / atol 2e-5 (the reference's float32 reassociation
  tolerance, tests/test_streaming.py); the residuals within rtol 2e-4 /
  atol 2e-4 (the reference test's own for residuals). Under int8 and
  sign_packed the two packages' per-machine gradients differ in the
  last bits, so a value on a rounding boundary (int8) or near zero
  (sign) can land in the next bucket: there at most 0.1 % of a leaf's
  entries may miss that tolerance, each by at most one quantization
  step of one machine (int8: max|w| max|g|/127; sign_packed:
  2 max|w| max_j mean|g_j|, from the port's per-machine gradients).
  Within the port, streaming equals materialising under the strict
  tolerance on every entry.
- Two streaming steps carry the residual: the port's second step
  equals the reference's (a bucket flipped in the first step rides in
  the residual into the second, so there two quantization steps).
- The refusals: ``streaming_chunk < 1``, and m not divisible by
  W * chunk.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as rget
from repro.core import compress as rcomp
from repro.core import expander_assignment as r_expander
from repro.data.pipeline import CodedBatcher, SyntheticLM
from repro.dist import coded_train as RT
from repro.launch.mesh import make_test_mesh
from repro.models import model as RM
from repro.optim import optimizers as ropt
from repro_torch import tree as T
from repro_torch.configs import get_config as tget
from repro_torch.core import compress as tcomp
from repro_torch.dist import coded_train as TT
from repro_torch.dist.process_group import Workers
from repro_torch.models.convert import params_from_numpy
from repro_torch.optim import optimizers as topt

RTOL, ATOL = 2e-4, 2e-5
RESID_TOL = dict(rtol=2e-4, atol=2e-4)
W_FIXED = np.asarray([1.0, 0.0, 0.7, 2.0], np.float32)


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two torch threads: the suite's other workers share the host."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@functools.lru_cache(maxsize=None)
def _setup(bs=3, S=16):
    """Read-only inputs, made once: the reference's parameter init is
    seconds on the CPU."""
    rcfg = rget("granite-3-8b").smoke_variant()
    tcfg = tget("granite-3-8b").smoke_variant()
    A = r_expander(4, 2, vertex_transitive=False, seed=1)
    batch = CodedBatcher(A, shuffle_seed=0).code_batch(
        SyntheticLM(rcfg.vocab_size, S, seed=0).batch(A.n * bs, 0))
    tree = jax.tree.map(np.asarray, RM.init_params(rcfg,
                                                   jax.random.PRNGKey(0)))
    return rcfg, tcfg, A, batch, tree


def _np(tree):
    return [np.asarray(x, np.float64) for x in jax.tree.leaves(tree)]


def _tnp(tree):
    return [x.detach().double().numpy() for x in T.leaves(tree)]


def _close(got, want, **tol):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, **tol)


def _quant_steps(codec, tcfg, params, batch, w, residual=None):
    """Per leaf, one quantization step of one machine's payload (the
    gradient plus the residual it carries) in the combine at the port's
    ``params`` (see the module docstring)."""
    with torch.no_grad():
        _, grads = TT._per_machine_values_and_grads(
            params, {k: torch.from_numpy(v) for k, v in batch.items()},
            tcfg)
    if residual is not None:
        grads = T.map(torch.add, grads, residual)
    wmax = float(np.abs(w).max())
    out = []
    for g in T.leaves(grads):
        flat = g.reshape(g.shape[0], -1).double().abs()
        step = (flat.max().item() / 127 if codec == "int8"
                else 2 * flat.mean(dim=1).max().item())
        out.append(wmax * step * 1.01)
    return out


def _close_but_flips(got, want, steps, rtol, atol):
    """``_close`` on all but 0.1 % of each leaf's entries; those within
    one quantization step."""
    for a, b, step in zip(got, want, steps):
        d = np.abs(a - b)
        off = d > atol + rtol * np.abs(b)
        assert off.sum() <= 1e-3 * d.size, (int(off.sum()), d.size)
        assert (d[off] <= step + atol).all(), (d[off].max(), step)


REGROUP = [(shape, ns, c) for shape in ((4,), (4, 5), (8, 3, 2))
           for ns, c in ((1, 1), (1, 2), (2, 1), (2, 2), (4, 1))
           if shape[0] % (ns * c) == 0]


@pytest.mark.parametrize("shape,n_shards,chunk", REGROUP)
def test_regrouping_equals_reference_bit_for_bit(shape, n_shards, chunk):
    x = np.arange(np.prod(shape), dtype=np.float32).reshape(shape)
    got = TT._to_stream_chunks(torch.from_numpy(x), n_shards, chunk)
    want = RT._to_stream_chunks(jnp.asarray(x), n_shards, chunk)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    back = TT._from_stream_chunks(got, n_shards, chunk)
    np.testing.assert_array_equal(back.numpy(), x)
    np.testing.assert_array_equal(
        back.numpy(),
        np.asarray(RT._from_stream_chunks(want, n_shards, chunk)))


def test_stream_chunks_keep_each_ranks_block():
    """Step t, slot s*chunk + c holds machine s*(m/W) + t*chunk + c: each
    rank's own machines, consecutive, every step."""
    m, n_shards, chunk = 8, 2, 2
    got = TT._to_stream_chunks(torch.arange(m), n_shards, chunk).numpy()
    per = m // n_shards
    for t in range(got.shape[0]):
        for s in range(n_shards):
            for c in range(chunk):
                assert got[t, s * chunk + c] == s * per + t * chunk + c
    assert TT._n_worker_shards(None) == 1
    assert TT._n_worker_shards(Workers(size=3, rank=1)) == 3


@functools.lru_cache(maxsize=None)
def _steps(rcfg, tcfg, codec, chunk, lr=1.0):
    """Both packages' streaming steps; the reference's jitted once per
    (codec, chunk) for the module."""
    mesh = make_test_mesh((1, 1))
    r_opt, t_opt = ropt.sgd(lr), topt.sgd(lr)
    r_step = jax.jit(RT.make_manual_collective_train_step(
        rcfg, r_opt, mesh, compress=codec, streaming_chunk=chunk))
    t_step = TT.make_manual_collective_train_step(
        tcfg, t_opt, compress=codec, streaming_chunk=chunk)
    return mesh, r_opt, t_opt, r_step, t_step


def _run_both(rcfg, tcfg, A, batch, tree, codec, chunk, ws):
    """The reference's and the port's streaming steps, one per weight
    vector in ``ws``, each from the other's state of the same step."""
    mesh, r_opt, t_opt, r_step, t_step = _steps(rcfg, tcfg, codec, chunk)
    rp = jax.tree.map(jnp.asarray, tree)
    tp = params_from_numpy(tree, tcfg, device="cpu")
    rs, ts = r_opt.init(rp), t_opt.init(tp)
    rc = rcomp.init_state(rp, A.m) if codec else None
    tc = tcomp.init_state(tp, A.m) if codec else None
    rb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    outs = []
    for w in ws:
        with mesh:
            r_out = (r_step(rp, rs, rc, rb, jnp.asarray(w)) if codec
                     else r_step(rp, rs, rb, jnp.asarray(w)))
        with torch.no_grad():
            t_out = (t_step(tp, ts, tc, tb, torch.from_numpy(w)) if codec
                     else t_step(tp, ts, tb, torch.from_numpy(w)))
        r_upd = [a - b for a, b in zip(_np(r_out[0]), _np(rp))]
        t_upd = [a - b for a, b in zip(_tnp(t_out[0]), _tnp(tp))]
        outs.append((r_out, t_out, r_upd, t_upd))
        if codec:
            rp, rs, rc, _ = r_out
            tp, ts, tc, _ = t_out
        else:
            rp, rs, _ = r_out
            tp, ts, _ = t_out
    return outs


@pytest.mark.parametrize("chunk", [1, 2])
@pytest.mark.parametrize("codec", [None, "int8", "sign_packed"])
def test_streaming_step_equals_reference(codec, chunk):
    rcfg, tcfg, A, batch, tree = _setup()
    (r_out, t_out, r_upd, t_upd), = _run_both(rcfg, tcfg, A, batch, tree,
                                              codec, chunk, [W_FIXED])
    rm, tm = r_out[-1], t_out[-1]
    np.testing.assert_allclose(tm["loss"].item(), float(rm["loss"]),
                               rtol=RTOL)
    np.testing.assert_allclose(tm["grad_norm"].item(),
                               float(rm["grad_norm"]), rtol=RTOL)
    if codec is None:
        _close(t_upd, r_upd, rtol=RTOL, atol=ATOL)
        return
    steps = _quant_steps(codec, tcfg,
                         params_from_numpy(tree, tcfg, device="cpu"),
                         batch, W_FIXED)
    _close_but_flips(t_upd, r_upd, steps, RTOL, ATOL)
    assert float(tm["comm_bytes"]) == float(rm["comm_bytes"])
    resid_steps = [s / float(np.abs(W_FIXED).max()) for s in steps]
    _close_but_flips(
        [x.reshape(-1) for x in _tnp(t_out[2]["residual"])],
        [x.reshape(-1) for x in _np(r_out[2]["residual"])],
        [s for s in resid_steps], **RESID_TOL)


def test_streaming_two_steps_carry_the_residual():
    rcfg, tcfg, A, batch, tree = _setup()
    ws = [W_FIXED, np.asarray([1.0, 1.0, 0.0, 1.0], np.float32)]
    outs = _run_both(rcfg, tcfg, A, batch, tree, "sign_packed", 2, ws)
    r_out, t_out, r_upd, t_upd = outs[1]
    # a bucket flipped in the first step rides in the residual into the
    # second: two steps there
    first = outs[0][1]
    steps = [2 * s for s in _quant_steps("sign_packed", tcfg, first[0],
                                         batch, ws[1],
                                         first[2]["residual"])]
    _close_but_flips(t_upd, r_upd, steps, RTOL, ATOL)
    _close_but_flips(
        [x.reshape(-1) for x in _tnp(t_out[2]["residual"])],
        [x.reshape(-1) for x in _np(r_out[2]["residual"])],
        [2 * s for s in steps], **RESID_TOL)


@pytest.mark.parametrize("codec", [None, "int8", "sign_packed"])
def test_streaming_equals_materialising_in_the_port(codec):
    _, tcfg, A, batch, tree = _setup()
    opt = topt.sgd(1.0)
    params = params_from_numpy(tree, tcfg, device="cpu")
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    w = torch.from_numpy(W_FIXED)
    outs = []
    torch.use_deterministic_algorithms(True)
    try:
        for chunk in (None, 1):
            step = TT.make_manual_collective_train_step(
                tcfg, opt, compress=codec, streaming_chunk=chunk)
            with torch.no_grad():
                if codec:
                    outs.append(step(params, opt.init(params),
                                     tcomp.init_state(params, A.m), tb, w))
                else:
                    outs.append(step(params, opt.init(params), tb, w))
    finally:
        torch.use_deterministic_algorithms(False)
    (p0, m0), (p1, m1) = [(o[0], o[-1]) for o in outs]
    np.testing.assert_allclose(m1["loss"].item(), m0["loss"].item(),
                               rtol=RTOL)
    upd0 = [a - b for a, b in zip(_tnp(p0), _tnp(params))]
    upd1 = [a - b for a, b in zip(_tnp(p1), _tnp(params))]
    _close(upd1, upd0, rtol=RTOL, atol=ATOL)
    if codec:
        _close(_tnp(outs[1][2]["residual"]), _tnp(outs[0][2]["residual"]),
               **RESID_TOL)


def test_streaming_refuses_a_chunk_below_one():
    tcfg = tget("granite-3-8b").smoke_variant()
    with pytest.raises(ValueError, match="streaming_chunk"):
        TT.make_manual_collective_train_step(tcfg, topt.sgd(1e-3),
                                             streaming_chunk=0)


@pytest.mark.parametrize("chunk,workers", [(3, None),
                                           (4, Workers(size=2, rank=0))])
def test_streaming_refuses_indivisible_geometry(chunk, workers):
    _, tcfg, A, batch, tree = _setup(bs=1, S=8)
    opt = topt.sgd(1e-3)
    params = params_from_numpy(tree, tcfg, device="cpu")
    step = TT.make_manual_collective_train_step(
        tcfg, opt, streaming_chunk=chunk, workers=workers)
    with pytest.raises(ValueError, match="divisible"):
        step(params, opt.init(params),
             {k: torch.from_numpy(v) for k, v in batch.items()},
             torch.ones(4))
