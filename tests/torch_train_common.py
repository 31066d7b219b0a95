"""Helpers shared by the ``test_torch_train*.py`` files: the smoke
configs of both packages, reference parameters (made once a config and
seed, and read only), tree comparisons and the coded setup of four
machines over an expander."""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as rget
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
from repro_torch.models.convert import params_from_numpy
from repro_torch.optim import optimizers as topt

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GRAD_TOL = dict(rtol=2e-4, atol=2e-5)
TRAJ_TOL = dict(rtol=2e-3, atol=5e-4)


def _cfgs(arch="granite-3-8b", **over):
    return (rget(arch).smoke_variant().with_overrides(**over),
            tget(arch).smoke_variant().with_overrides(**over))


@functools.lru_cache(maxsize=None)
def _ref_params(rcfg, seed=0):
    """The reference's parameters as NumPy, made once a (config, seed):
    every caller only reads them (``params_from_numpy`` copies)."""
    return jax.tree.map(np.asarray,
                        RM.init_params(rcfg, jax.random.PRNGKey(seed)))


def _t(x):
    return torch.from_numpy(np.array(x))


def _tt(tree):
    """A NumPy / JAX tree as torch tensors on the CPU."""
    return T.map(_t, jax.tree.map(np.asarray, tree))


def _assert_trees(port, ref, **tol):
    """Leaf by leaf, in the flatten order both packages share."""
    pl, rl = T.leaves(port), jax.tree.leaves(ref)
    assert len(pl) == len(rl)
    assert T.paths(port) == ["/".join(str(k.key) for k in p) for p, _ in
                             jax.tree_util.tree_flatten_with_path(ref)[0]]
    for a, b in zip(pl, rl):
        np.testing.assert_allclose(a.detach().float().numpy(),
                                   np.asarray(b, np.float32), **tol)


def _setup(name="expander", bs=3, S=16, cfg_over=None):
    rcfg, tcfg = _cfgs(**(cfg_over or {}))
    A = {"expander": lambda: r_expander(4, 2, vertex_transitive=False,
                                        seed=1)}[name]()
    batcher = CodedBatcher(A, shuffle_seed=0)
    raw = SyntheticLM(rcfg.vocab_size, S, seed=0).batch(A.n * bs, 0)
    coded = batcher.code_batch(raw)
    blocks = batcher.unique_blocks(raw)
    tree = _ref_params(rcfg)
    return rcfg, tcfg, A, coded, blocks, tree




def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(REPO, "src") + (
        os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    return env


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two torch threads: the suite's other workers share the host."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def check_trajectory(compress, path):
    """The port's train step on ``path`` ("dedup", "replicated" or
    "manual") against the reference's over three AdamW steps: losses
    rtol 1e-4; 99.9 % of the parameters within ``TRAJ_TOL`` and all of
    them within atol 2 lr per step (Adam divides by sqrt(v): where a
    gradient entry is near zero, float32 rounding, or one flipped
    quantized value or sign bit, can turn into an lr-sized update of the
    other sign on that entry)."""
    rcfg, tcfg, A, _, _, tree = _setup()
    lr = 1e-3
    r_opt, t_opt = ropt.adamw(lr), topt.adamw(lr)
    dedup = path == "dedup"
    aw = RT.alpha_bar_weights(A)
    ns = RT.dedup_norm_scale(A)
    if path == "manual":
        mesh = make_test_mesh((1, 1))
        r_step = jax.jit(RT.make_manual_collective_train_step(
            rcfg, r_opt, mesh, alpha_weights=aw, compress=compress))
        t_step = TT.make_manual_collective_train_step(
            tcfg, t_opt, alpha_weights=aw, compress=compress)
    else:
        kw = dict(dedup=dedup, norm_scale=ns, alpha_weights=aw,
                  compress=compress)
        r_step = jax.jit(RT.make_train_step(rcfg, r_opt, **kw))
        t_step = TT.make_train_step(tcfg, t_opt, **kw)
    rp = jax.tree.map(jnp.asarray, tree)
    tp = params_from_numpy(tree, tcfg, device="cpu")
    rs, ts = r_opt.init(rp), t_opt.init(tp)
    rows = A.n if dedup else A.m
    rc = RT.compress_mod.init_state(rp, rows) if compress else None
    tc = tcomp.init_state(tp, rows) if compress else None
    batcher = CodedBatcher(A, shuffle_seed=0)
    src = SyntheticLM(rcfg.vocab_size, 16, seed=0)
    rng = np.random.default_rng(1)
    for step in range(3):
        raw = src.batch(A.n * 2, step)
        b = batcher.unique_blocks(raw) if dedup else batcher.code_batch(raw)
        w = (rng.random(A.m) * (rng.random(A.m) > 0.3)).astype(np.float32)
        wv = (A.A @ w).astype(np.float32) if dedup else w
        rb = {k: jnp.asarray(v) for k, v in b.items()}
        if path == "manual":
            with make_test_mesh((1, 1)):
                r_out = (r_step(rp, rs, rc, rb, jnp.asarray(wv))
                         if compress else r_step(rp, rs, rb, jnp.asarray(wv)))
        else:
            r_out = (r_step(rp, rs, rc, rb, jnp.asarray(wv)) if compress
                     else r_step(rp, rs, rb, jnp.asarray(wv)))
        t_out = (t_step(tp, ts, tc, T.map(_t, b), _t(wv)) if compress
                 else t_step(tp, ts, T.map(_t, b), _t(wv)))
        if compress:
            rp, rs, rc, rm = r_out
            tp, ts, tc, tm = t_out
            assert float(tm["comm_bytes"]) == float(rm["comm_bytes"])
        else:
            rp, rs, rm = r_out
            tp, ts, tm = t_out
        np.testing.assert_allclose(tm["loss"].item(), float(rm["loss"]),
                                   rtol=1e-4)
        np.testing.assert_allclose(tm["alpha_bar"].item(),
                                   float(rm["alpha_bar"]), rtol=1e-6)
    _assert_trees(tp, rp, rtol=0, atol=2 * lr * 3)
    far = total = 0
    for a, b in zip(T.leaves(tp), jax.tree.leaves(rp)):
        d = np.abs(a.numpy() - np.asarray(b))
        far += int((d > TRAJ_TOL["atol"] + TRAJ_TOL["rtol"]
                    * np.abs(np.asarray(b))).sum())
        total += d.size
    assert far <= 1e-3 * total, (far, total)
