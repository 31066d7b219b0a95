"""decode_attention (K2) at head dim 160, pixtral-12b's (5120 / 32).

The reference's Pallas kernel tiles a full (G, Dh) block at any head
dim, and every family's decode attention goes through it. On the CPU:
the launch plan at Dh = 160 and the plain version against the JAX
package's ``ref`` and its kernel in interpret mode, on the smallest
input of fault C2 (B = 1, H = 32, KVH = 8, S = 16) and on pixtral's
serving shape. On the card (marker ``cuda``): the CUDA kernel against
its plain version at pixtral's shape, B = 8, H = 32, KVH = 8, ragged
lengths, in bf16 (the tensor-core path, rows padded to an odd number of
16-byte chunks) and float32 (the CUDA-core path, 20 elements and 8
lanes a position), many chunks, graph replays and repeats.

Tolerances, the reference suite's (tests/test_kernels.py:21): 2e-5 in
float32, where only the fp32 summation order differs; 3e-2 in bf16,
where that order can move a result across a rounding boundary of the
8-bit mantissa.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels.decode_attention import kernel as da_k
from repro_torch.kernels.decode_attention import ops as da_ops
from repro_torch.kernels.decode_attention import ref as da_r

DH = 160
PIXTRAL = dict(B=8, H=32, KVH=8)
DTYPES = ["float32", "bfloat16"]
SCALED_TOL = 3e-2        # max |err| <= this * max |want|


def _tol(dt):
    return dict(atol=3e-2, rtol=3e-2) if dt == "bfloat16" else \
        dict(atol=2e-5, rtol=2e-5)


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().float().cpu().numpy()
    return np.asarray(t, np.float32)


@pytest.fixture(scope="module")
def jx():
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.kernels.decode_attention import kernel, ref
    return jnp, kernel, ref


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU "
                    "mode (their plain versions are tested here)")
    return torch.device("cuda")


@pytest.mark.parametrize("S", [16, 1024, 32768])
@pytest.mark.parametrize("itemsize", [2, 4])
def test_plan_chunks_at_head_dim_160(S, itemsize):
    p = da_k.plan_chunks(S=S, Dh=DH, itemsize=itemsize, **PIXTRAL)
    assert p.gt == 4 and p.groups == PIXTRAL["B"] * PIXTRAL["KVH"]
    assert p.tile == da_k.tile_positions(DH, itemsize)
    assert p.tile == (64 if itemsize == 2 else 16)
    assert p.chunk % p.tile == 0
    assert (p.chunks - 1) * p.chunk < S <= p.chunks * p.chunk
    assert p.state == (2 + DH) * p.gt


@pytest.mark.parametrize("Dh,itemsize,elems", [
    (160, 4, 20), (32, 4, 4), (64, 4, 4), (128, 4, 4), (256, 4, 8),
    (32, 2, 8)])
def test_lane_tiling_divides_the_warp(Dh, itemsize, elems):
    """The CUDA-core path's lane tiling: whole 16-byte vectors a lane,
    lanes a position dividing 32, and whole rounds of positions a warp
    in each ring stage (unchanged for the earlier head dims)."""
    e = da_k.lane_elems(Dh, itemsize)
    assert e == elems and e % (16 // itemsize) == 0 and Dh % e == 0
    lanes = Dh // e
    assert 32 % lanes == 0
    tile = da_k.tile_positions(Dh, itemsize)
    per_warp = tile // da_k.WARPS
    assert per_warp % (32 // lanes) == 0 and per_warp <= 32


def _inputs(jnp, rng, B, H, KVH, S, dtype, lengths):
    out = []
    for shape in ((B, H, DH), (B, S, KVH, DH), (B, S, KVH, DH)):
        a = rng.normal(size=shape)
        out.append((jnp.asarray(a, jnp.dtype(dtype)),
                    torch.from_numpy(a).to(getattr(torch, dtype))))
    return out, np.asarray(lengths, np.int32)


@pytest.mark.parametrize("B,H,KVH,S,lengths", [
    (1, 32, 8, 16, [16]),                        # fault C2's input
    (8, 32, 8, 64, [1, 5, 17, 33, 64, 2, 40, 63])])
@pytest.mark.parametrize("dtype", DTYPES)
def test_plain_matches_jax_at_head_dim_160(jx, B, H, KVH, S, lengths,
                                           dtype):
    jnp, kernel, ref = jx
    ((qj, qt), (kj, kt), (vj, vt)), lens = _inputs(
        jnp, np.random.default_rng(0), B, H, KVH, S, dtype, lengths)
    port = da_ops.decode_attention(qt, kt, vt, torch.from_numpy(lens))
    assert port.shape == (B, H, DH) and port.dtype == qt.dtype
    np.testing.assert_allclose(
        _np(port), _np(ref.decode_attention(qj, kj, vj,
                                            jnp.asarray(lens))),
        **_tol(dtype))
    np.testing.assert_allclose(
        _np(port), _np(kernel.decode_attention(qj, kj, vj,
                                               jnp.asarray(lens),
                                               interpret=True)),
        **_tol(dtype))


def _card_inputs(cuda, B, H, KVH, S, dtype, seed):
    g = torch.Generator(device=cuda).manual_seed(seed)
    dt = getattr(torch, dtype)
    return [torch.randn(shape, generator=g, device=cuda).to(dt)
            for shape in ((B, H, DH), (B, S, KVH, DH), (B, S, KVH, DH))]


@pytest.mark.cuda
@pytest.mark.parametrize("S", [1024, 32768])
@pytest.mark.parametrize("dtype", DTYPES)
def test_kernel_at_pixtral_shape_on_card(cuda, S, dtype):
    """B = 8, H = 32, KVH = 8, ragged lengths (0, 1, a chunk's edges and
    S among them): kernel against plain, two launches and a graph replay
    bit for bit."""
    q, k, v = _card_inputs(cuda, S=S, dtype=dtype, seed=S, **PIXTRAL)
    plan = da_k.plan_chunks(S=S, Dh=DH, itemsize=q.element_size(),
                            **PIXTRAL)
    c = plan.chunk
    rng = np.random.default_rng(S)
    n = [0, 1, c - 1, c + 1, S] + rng.integers(1, S + 1, 3).tolist()
    lens = torch.tensor(n, dtype=torch.int32, device=cuda)
    before = da_ops.launches
    fn = lambda: da_ops.decode_attention(q, k, v, lens)  # noqa: E731
    out = fn()
    torch.cuda.synchronize()
    assert da_ops.launches == before + 1
    want = da_r.decode_attention(q, k, v, lens)
    live = lens > 0
    got_np, want_np = _np(out[live]), _np(want[live])
    np.testing.assert_allclose(got_np, want_np, **_tol(dtype))
    assert np.abs(got_np - want_np).max() <= \
        SCALED_TOL * np.abs(want_np).max()
    assert torch.equal(out[~live], torch.zeros_like(out[~live]))
    assert torch.equal(out, fn())
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = fn()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, captured)


@pytest.mark.cuda
@pytest.mark.parametrize("G", [1, 4])
@pytest.mark.parametrize("dtype", DTYPES)
def test_kernel_head_dim_160_groups_on_card(cuda, G, dtype):
    """G = 1 (one query head a CTA) and G = 4 at one long cache, one
    chunk and many."""
    B, KVH, S = 2, 2, 4096
    q, k, v = _card_inputs(cuda, B, G * KVH, KVH, S, dtype, G)
    lens = torch.tensor([S, 100], dtype=torch.int32, device=cuda)
    out = da_ops.decode_attention(q, k, v, lens)
    torch.cuda.synchronize()
    np.testing.assert_allclose(_np(out),
                               _np(da_r.decode_attention(q, k, v, lens)),
                               **_tol(dtype))
