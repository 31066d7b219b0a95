"""The port's blockwise attention against the JAX package's.

``models.attention.blockwise_attention`` (an online softmax over
(query block x key block) tiles with a flash-attention-2 backward)
against the reference's ``blockwise_attention`` (``lax.scan`` over key
blocks, its gradient by ``jax.vjp``), in float32 on the CPU, from NumPy
inputs drawn from a seed, in the four mask cases: causal, causal with a
sliding window, bidirectional, and cross-attention with Sq != Sk. Two
sizes: 1,100 positions with the default 512 blocks (block edges and
padded tails), and 37 queries with blocks of 8 (many edges and tiles a
mask wholly hides, cheaply).

- The forward within atol = rtol = 1e-5, and the q, k and v gradients
  of <out, cotangent> within the families' GRAD_TOL (rtol 2e-4, atol
  2e-5; tests/test_torch_families.py), both float32 reduction orders.
- ``attention_forward`` (projections, RoPE, the call into the blockwise
  path) against the reference's, self and cross, at 1,100 positions.
- In bfloat16, the blockwise version against the plain version
  (``attention_ref``, the whole-score softmax) on the same inputs, the
  forward and the gradients within the repository's bf16 tolerance
  (atol = rtol = 3e-2, scaled by max(1, max |reference|)).
- Linear memory: on meta tensors, no op of the forward or the backward
  makes a tensor larger than one tile, at 2,048 and at 8,192 positions.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.models import attention as RA
from repro_torch.models import attention as TA

FWD_TOL = dict(atol=1e-5, rtol=1e-5)
GRAD_TOL = dict(rtol=2e-4, atol=2e-5)
BF16_TOL = 3e-2
H, KVH, DH = 4, 2, 16

# name -> (causal, window, Sk relative to Sq: None for self-attention)
CASES = {"causal": (True, None, None),
         "window": (True, 300, None),
         "bidirectional": (False, None, None),
         "cross": (False, None, 0.6)}
# (Sq, block): the default blocks across edges with a padded tail, and
# small blocks over a short sequence
SIZES = [(1100, 512), (37, 8)]


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two torch threads: the suite's other workers share the host."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _inputs(Sq, Sk, seed=0, B=2):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, Sq, H, DH)).astype(np.float32)
    k = rng.normal(size=(B, Sk, KVH, DH)).astype(np.float32)
    v = rng.normal(size=(B, Sk, KVH, DH)).astype(np.float32)
    cot = rng.normal(size=(B, Sq, H, DH)).astype(np.float32)
    return q, k, v, cot


def _case(name, Sq, block):
    causal, window, rel = CASES[name]
    if window is not None:
        window = min(window, max(2, Sq // 3))
    Sk = Sq if rel is None else int(Sq * rel)
    return causal, window, Sk


def _port(q, k, v, cot, dtype=torch.float32, plain=False, **kw):
    qt, kt, vt = (torch.from_numpy(x).to(dtype).requires_grad_(True)
                  for x in (q, k, v))
    fn = TA.attention_ref if plain else TA.blockwise_attention
    out = fn(qt, kt, vt, **kw)
    out.backward(torch.from_numpy(cot).to(dtype))
    return [x.detach().float().numpy() for x in (out, qt.grad, kt.grad,
                                                 vt.grad)]


@pytest.mark.parametrize("Sq,block", SIZES, ids=["1100", "37-blocks8"])
@pytest.mark.parametrize("name", list(CASES))
def test_blockwise_equals_reference(name, Sq, block):
    causal, window, Sk = _case(name, Sq, block)
    q, k, v, cot = _inputs(Sq, Sk)

    def ref(q_, k_, v_):
        return RA.blockwise_attention(q_, k_, v_, causal=causal,
                                      window=window, block_q=block,
                                      block_k=block)
    out, vjp = jax.vjp(ref, *(jnp.asarray(x) for x in (q, k, v)))
    want = [np.asarray(out)] + [np.asarray(g) for g in
                                vjp(jnp.asarray(cot))]
    got = _port(q, k, v, cot, causal=causal, window=window, block_q=block,
                block_k=block)
    np.testing.assert_allclose(got[0], want[0], **FWD_TOL)
    for g, w, what in zip(got[1:], want[1:], "qkv"):
        np.testing.assert_allclose(g, w, err_msg=f"d{what}", **GRAD_TOL)


@pytest.mark.parametrize("cross", [False, True], ids=["self", "cross"])
def test_attention_forward_equals_reference(cross):
    """The whole layer at 1,100 positions: projections, RoPE (self) or
    the source's K and V (cross), the blockwise path, the output
    projection."""
    rng = np.random.default_rng(3)
    D, S = 32, 1100
    shapes = {"wq": (D, H * DH), "wk": (D, KVH * DH),
              "wv": (D, KVH * DH), "wo": (H * DH, D)}
    p = {name: {"w": (rng.normal(size=shape) * 0.1).astype(np.float32)}
         for name, shape in shapes.items()}
    x = rng.normal(size=(1, S, D)).astype(np.float32)
    src = rng.normal(size=(1, 700, D)).astype(np.float32) if cross else None
    kw = dict(n_heads=H, n_kv_heads=KVH, head_dim=DH, rope_theta=1e4,
              window=None if cross else 257)
    want = RA.attention_forward(
        jax.tree.map(jnp.asarray, p), jnp.asarray(x),
        kv=None if src is None else jnp.asarray(src), **kw)
    got = TA.attention_forward(
        {n: {"w": torch.from_numpy(a["w"])} for n, a in p.items()},
        torch.from_numpy(x),
        kv=None if src is None else torch.from_numpy(src), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FWD_TOL)


@pytest.mark.parametrize("name", list(CASES))
def test_blockwise_equals_plain_in_bf16(name):
    Sq, block = 300, 64
    causal, window, Sk = _case(name, Sq, block)
    q, k, v, cot = _inputs(Sq, Sk, seed=1)
    kw = dict(causal=causal, window=window)
    got = _port(q, k, v, cot, torch.bfloat16, block_q=block,
                block_k=block, **kw)
    want = _port(q, k, v, cot, torch.bfloat16, plain=True, **kw)
    for g, w, what in zip(got, want, ("out", "dq", "dk", "dv")):
        scale = max(1.0, float(np.abs(w).max()))
        np.testing.assert_allclose(g, w, atol=BF16_TOL * scale,
                                   rtol=BF16_TOL, err_msg=what)


class _Largest(TorchDispatchMode):
    """The largest numel of any op result."""

    def __init__(self):
        super().__init__()
        self.numel = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in (out if isinstance(out, (tuple, list)) else (out,)):
            if isinstance(t, torch.Tensor):
                self.numel = max(self.numel, t.numel())
        return out


@pytest.mark.parametrize("S", [2048, 8192])
@pytest.mark.parametrize("name", ["causal", "window"])
def test_no_tensor_larger_than_a_tile(name, S):
    causal, window, _ = _case(name, S, 512)
    B, Hq, Kv, Dh = 1, 32, 8, 128
    q = torch.empty(B, S, Hq, Dh, device="meta", dtype=torch.bfloat16,
                    requires_grad=True)
    k = torch.empty(B, S, Kv, Dh, device="meta", dtype=torch.bfloat16,
                    requires_grad=True)
    v = torch.empty_like(k, requires_grad=True)
    with _Largest() as mode:
        out = TA.blockwise_attention(q, k, v, causal=causal, window=window)
        out.backward(torch.empty_like(out))
    tile = B * Hq * 512 * 512
    linear = B * S * Hq * Dh
    assert q.grad.shape == q.shape and k.grad.shape == k.shape
    assert mode.numel <= max(tile, linear) < B * Hq * S * S // 4
