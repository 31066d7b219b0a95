"""The tiles that ``models.attention.blockwise_attention`` skips.

The blockwise loop visits only the (query block x key block) tiles its
mask does not wholly hide, in the forward and in the flash backward:

- The counter ``attention.tiles``, on meta tensors, at a causal 4,096
  positions in blocks of 512 (36 tiles computed, 28 skipped, each call),
  a causal window of 300 at 1,100 (5 and 4), and bidirectional and
  cross-attention (nothing skipped), for the forward and the backward
  alike.
- The skip itself: keys and values that only wholly hidden tiles hold
  are set to NaN, and the query blocks that never see them keep finite
  outputs and q-gradients, equal to an unpoisoned run's. A loop that
  computed those tiles would multiply their zero probabilities by NaN.
- Matmul FLOPs (``torch.utils.flop_counter``, on meta tensors): the
  live tiles, by the plain version's whole mask, times the tile's two
  products in the forward and five in the backward.
"""

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.models import attention as TA

# the blockwise tests' tolerances (tests/test_torch_attention_blockwise.py)
FWD_TOL = dict(atol=1e-5, rtol=1e-5)
GRAD_TOL = dict(rtol=2e-4, atol=2e-5)
B, H, KVH, DH = 2, 4, 2, 16

# name -> (causal, window, Sq, Sk, block, tiles computed, tiles skipped)
COUNTS = {"causal-4096": (True, None, 4096, 4096, 512, 36, 28),
          "window-1100": (True, 300, 1100, 1100, 512, 5, 4),
          "bidirectional": (False, None, 1100, 1100, 512, 9, 0),
          "cross": (False, None, 1100, 660, 512, 6, 0)}


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two torch threads: the suite's other workers share the host."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _meta(Sq, Sk):
    return (torch.empty(B, Sq, H, DH, device="meta", requires_grad=True),
            torch.empty(B, Sk, KVH, DH, device="meta", requires_grad=True),
            torch.empty(B, Sk, KVH, DH, device="meta", requires_grad=True))


def _reset():
    TA.tiles.update(computed=0, skipped=0)


@pytest.mark.parametrize("name", list(COUNTS))
def test_counter_on_meta_tensors(name):
    causal, window, Sq, Sk, block, live, hidden = COUNTS[name]
    q, k, v = _meta(Sq, Sk)
    _reset()
    out = TA.blockwise_attention(q, k, v, causal=causal, window=window,
                                 block_q=block, block_k=block)
    assert TA.tiles == {"computed": live, "skipped": hidden}
    _reset()
    out.backward(torch.empty_like(out))
    assert TA.tiles == {"computed": live, "skipped": hidden}
    assert q.grad.shape == q.shape and k.grad.shape == k.shape


# name -> (causal, window): S = 80 in blocks of 16
POISON = {"causal": (True, None), "window": (True, 20)}


@pytest.mark.parametrize("name", list(POISON))
def test_wholly_hidden_keys_never_reach_the_output(name):
    causal, window = POISON[name]
    S, block = 80, 16
    if window is None:
        # the first query block: every later key block is hidden
        rows, keys = slice(0, block), slice(block, S)
    else:
        # the last query block [64, 80): key blocks ending at or before
        # q0 - window (44), [0, 16) and [16, 32), are hidden
        q0 = S - block
        end = max(k1 for _, k1 in TA._blocks(S, block)
                  if k1 - 1 <= q0 - window)
        rows, keys = slice(q0, S), slice(0, end)
    gen = torch.Generator().manual_seed(0)
    q = torch.randn(B, S, H, DH, generator=gen)
    k = torch.randn(B, S, KVH, DH, generator=gen)
    v = torch.randn(B, S, KVH, DH, generator=gen)
    cot = torch.randn(B, S, H, DH, generator=gen)

    def run(k, v):
        qt = q.clone().requires_grad_(True)
        out = TA.blockwise_attention(qt, k, v, causal=causal, window=window,
                                     block_q=block, block_k=block)
        out.backward(cot)
        return out.detach()[:, rows], qt.grad[:, rows]

    want_out, want_dq = run(k, v)
    kp, vp = k.clone(), v.clone()
    kp[:, keys] = float("nan")
    vp[:, keys] = float("nan")
    got_out, got_dq = run(kp, vp)
    assert torch.isfinite(got_out).all() and torch.isfinite(got_dq).all()
    torch.testing.assert_close(got_out, want_out, **FWD_TOL)
    torch.testing.assert_close(got_dq, want_dq, **GRAD_TOL)


@pytest.mark.parametrize("name", list(COUNTS))
def test_flops_are_the_live_tiles_products(name):
    causal, window, Sq, Sk, block, live, _ = COUNTS[name]
    mask = TA._mask(Sq, Sk, causal, window, "cpu")
    blocks_q, blocks_k = TA._blocks(Sq, block), TA._blocks(Sk, block)
    # one product of a tile: (B*KVH) x (G*tq x Dh) @ (Dh x tk)
    product = [2 * B * H * (q1 - q0) * (k1 - k0) * DH
               for q0, q1 in blocks_q for k0, k1 in blocks_k
               if mask is None or mask[q0:q1, k0:k1].any()]
    assert len(product) == live
    q, k, v = _meta(Sq, Sk)
    with FlopCounterMode(display=False) as fc:
        out = TA.blockwise_attention(q, k, v, causal=causal, window=window,
                                     block_q=block, block_k=block)
    assert fc.get_total_flops() == 2 * sum(product)
    with FlopCounterMode(display=False) as fc:
        out.backward(torch.empty_like(out))
    assert fc.get_total_flops() == 5 * sum(product)
