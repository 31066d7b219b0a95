"""The port's kernels against the JAX package's.

On the CPU: the port's plain versions (``repro_torch.kernels.*.ref``,
which ``ops`` runs for CPU tensors) against the JAX ``ref`` and against
the JAX Pallas kernel in interpret mode, over the parameter grid of
tests/test_kernels.py, float32 and bfloat16. Inputs are made with NumPy
from a seed and handed to both packages.

Tolerances are the reference suite's own (tests/test_kernels.py:21):
2e-5 in float32, where only the fp32 summation order differs; 3e-2 in
bfloat16, where that order can move a result across a rounding boundary
of the 8-bit mantissa (one bf16 ulp is 2^-8 ~ 4e-3 relative).

On the card (marker ``cuda``; skipped without one): each CUDA kernel
against its plain version on the same device tensors, same tolerances.
The JAX package is imported through a fixture, so the card's tests run
where JAX is not installed.

The three coded combines (``kernels.coded_combine``) have their own
ladder, the reference suite's (tests/test_kernels.py:93-275): the plain
versions against the JAX Pallas kernels in interpret mode within 2e-5
(float32) / 3e-2 (bfloat16); BITWISE against the float64 NumPy oracles
on exactness-preserving inputs (integer payloads, power-of-two weights
and scales, straggler zeros), where every float32 partial sum is exact;
within 2e-5 of the oracle's scale on general inputs. On the card each
kernel must equal its plain version bit for bit on any input: both do
the same rounded multiply and add per row, in row order.
"""

import ctypes
import types

import numpy as np
import pytest
import torch

from repro_torch.kernels.coded_combine import ops as cc_ops, ref as cc_r
from repro_torch.kernels.decode_attention import ops as da_ops, ref as da_r
from repro_torch.kernels.rmsnorm import ops as rn_ops, ref as rn_r

RMS_SHAPES = [(4, 128), (3, 5, 256), (64, 512), (1, 1024), (7, 384)]
DA_GRID = [(2, 8, 2, 256, 64, 64), (1, 4, 4, 128, 32, 128),
           (2, 16, 4, 512, 128, 256), (3, 4, 1, 192, 64, 64)]
DTYPES = ["float32", "bfloat16"]


def _tol(dt):
    return dict(atol=3e-2, rtol=3e-2) if dt == "bfloat16" else \
        dict(atol=2e-5, rtol=2e-5)


@pytest.fixture(scope="module")
def jx():
    """The JAX package's kernel modules (and jax.numpy)."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.kernels.decode_attention import kernel as da_k, ref as da_r
    from repro.kernels.rmsnorm import kernel as rn_k, ops as rn_ops, \
        ref as rn_r
    return types.SimpleNamespace(jnp=jnp, da_k=da_k, da_r=da_r, rn_k=rn_k,
                                 rn_ops=rn_ops, rn_r=rn_r)


def _both(jnp, a: np.ndarray, dt: str):
    """One NumPy array as a JAX array and a torch tensor of dtype dt."""
    return jnp.asarray(a, jnp.dtype(dt)), \
        torch.from_numpy(np.ascontiguousarray(a)).to(getattr(torch, dt))


def _np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.detach().float().cpu().numpy()
    return np.asarray(t, np.float32)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU "
                    "mode (their plain versions are tested here)")
    return torch.device("cuda")


# ----------------------------------------------------------- rmsnorm

@pytest.mark.parametrize("shape", RMS_SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_rmsnorm_plain_matches_jax(jx, shape, dtype):
    rng = np.random.default_rng(0)
    xj, xt = _both(jx.jnp, rng.normal(size=shape), dtype)
    sj, st = _both(jx.jnp, rng.normal(size=shape[-1]), dtype)
    port = rn_ops.rmsnorm(xt, st)       # CPU tensor -> plain version
    assert port.dtype == xt.dtype and port.shape == xt.shape
    np.testing.assert_allclose(_np(port), _np(jx.rn_r.rmsnorm(xj, sj)),
                               **_tol(dtype))
    np.testing.assert_allclose(
        _np(port), _np(jx.rn_k.rmsnorm(xj, sj, interpret=True)),
        **_tol(dtype))


@pytest.mark.parametrize("shape", [(6, 64), (2, 3, 128)])
def test_rmsnorm_backward_matches_jax_closed_form(jx, shape):
    """The autograd.Function's backward is the reference's closed form
    (repro/kernels/rmsnorm/ops.py _bwd); float32, 1e-5: the same
    expression in another library's fp32 reduction order."""
    rng = np.random.default_rng(1)
    x, s, g = (rng.normal(size=shape), rng.normal(size=shape[-1]),
               rng.normal(size=shape))
    xt = torch.tensor(x, dtype=torch.float32, requires_grad=True)
    st = torch.tensor(s, dtype=torch.float32, requires_grad=True)
    y = rn_ops.rmsnorm(xt, st, 1e-6)
    y.backward(torch.tensor(g, dtype=torch.float32))
    jnp = jx.jnp
    dx, ds = jx.rn_ops._bwd(1e-6, (jnp.asarray(x, jnp.float32),
                                   jnp.asarray(s, jnp.float32)),
                            jnp.asarray(g, jnp.float32))
    np.testing.assert_allclose(_np(xt.grad), _np(dx), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(_np(st.grad), _np(ds), rtol=1e-5,
                               atol=1e-5)


def test_rmsnorm_backward_matches_autodiff_of_plain_version():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(5, 96))
    s = rng.normal(size=96)
    a = [torch.tensor(v, dtype=torch.float32, requires_grad=True)
         for v in (x, s)]
    b = [torch.tensor(v, dtype=torch.float32, requires_grad=True)
         for v in (x, s)]
    (rn_ops.rmsnorm(*a) ** 2).sum().backward()
    (rn_r.rmsnorm(*b) ** 2).sum().backward()
    for u, w in zip(a, b):
        torch.testing.assert_close(u.grad, w.grad, rtol=1e-4, atol=1e-5)


# The launch plan of the CUDA rmsnorm: threads a row, vectors a thread in
# registers, rows a CTA -- from the shape and the SM count only.

from repro_torch.kernels.rmsnorm import kernel as rn_k


def _plan_is_pure(fn, names):
    import inspect
    params = list(inspect.signature(fn).parameters)
    assert params[:len(names)] == names
    assert not {"x", "alphas", "a", "data"} & set(params)


@pytest.mark.parametrize("rows", [1, 8, 132, 8192])
@pytest.mark.parametrize("d", [128, 4095, 4096, 5120, 12800])
@pytest.mark.parametrize("itemsize", [2, 4])
def test_rmsnorm_row_plan(rows, d, itemsize):
    """Every vector of a row is held by exactly one thread, every row by
    one row group; threads and shared memory within the card's limits;
    the register path only where it holds the row."""
    _plan_is_pure(rn_k.plan_rows, ["rows", "d", "itemsize", "sms"])
    sms = rn_k.H100_SMS
    p = rn_k.plan_rows(rows, d, itemsize, sms)
    assert p == rn_k.plan_rows(rows, d, itemsize, sms)
    n = 16 // itemsize
    nv = d // n
    assert p.tpr % 32 == 0 and p.rpc >= 1 and p.tpr * p.rpc <= 1024
    assert rn_k.SMEM_BYTES <= 48 * 1024
    assert (p.ctas - 1) * p.rpc < rows <= p.ctas * p.rpc
    holds = d % n == 0 and nv <= rn_k.VPTS[-1] * rn_k.MAX_THREADS
    assert (p.vpt > 0) == holds
    assert rn_k.plan_rows(rows, d, itemsize, sms, aligned=False).vpt == 0
    if not p.vpt:
        assert (p.tpr, p.rpc, p.ctas) == (rn_k.LOOP_THREADS, 1, rows)
        return
    assert p.vpt in rn_k.VPTS and p.tpr * p.rpc <= rn_k.MAX_THREADS
    # at most ROW_VPT vectors a thread while the row may take more warps,
    # and more than ROW_THREADS threads a row only to keep to that
    assert p.vpt <= rn_k.ROW_VPT or p.tpr == rn_k.MAX_THREADS
    assert p.tpr <= rn_k.ROW_THREADS or p.vpt >= rn_k.ROW_VPT
    # thread t of a row holds vectors t + k * tpr, k < vpt, below nv
    held = (np.arange(p.tpr)[:, None]
            + p.tpr * np.arange(p.vpt)[None, :]).ravel()
    held = held[held < nv]
    assert np.array_equal(np.sort(held), np.arange(nv))
    assert p.tpr - 32 < -(-nv // p.vpt)      # no warp without a vector
    assert p.vpt == 1 or (p.vpt // 2) * p.tpr < nv   # fewest vectors
    # enough row warps for the card where the row has vectors for them
    assert rows * p.tpr // 32 >= min(
        rn_k.WARPS_PER_SM * sms,
        rows * min(rn_k.ROW_THREADS // 32, -(-nv // 32))) // 2


@pytest.mark.parametrize("rows,d,itemsize,want", [
    (8, 4096, 2, (2, 256, 1)),       # the decode step: a CTA a row
    (8, 4096, 4, (4, 256, 1)),
    (8192, 4096, 2, (8, 64, 2)),     # training: two warps a row, 2 a CTA
    (8192, 4096, 4, (8, 128, 1)),
    (132, 4096, 2, (2, 256, 1)),
    (8, 12800, 2, (8, 224, 1)),
    (8, 32768, 2, (8, 512, 1)),      # past ROW_THREADS at 8 vectors
    (4, 65536, 2, (16, 512, 1)),     # the widest row the registers hold
    (4, 65536, 4, (0, 256, 1)),      # too wide: the loop kernel
    (8, 4095, 2, (0, 256, 1))])      # not whole vectors: the loop kernel
def test_rmsnorm_row_plan_regimes(rows, d, itemsize, want):
    p = rn_k.plan_rows(rows, d, itemsize)
    assert (p.vpt, p.tpr, p.rpc) == want


# The launch plan of the int8 and packed-sign combines: the bulk route's
# tile, stages and CTAs, the lane route's CTAs, or the generic kernels --
# from the shape, the alignment and the SM count only.

from repro_torch.kernels.coded_combine import kernel as cc_k


@pytest.mark.parametrize("kind", cc_k.KINDS)
@pytest.mark.parametrize("n", [1, 2, 3, 4, 16])
@pytest.mark.parametrize("d", [1, 7, 9, 130, 8192, 1_000_003, 104_857_600])
def test_combine_plan(kind, n, d):
    """Whole 16-byte tiles that with the tail cover D exactly, shared
    memory within a CTA's and an SM's limit, the bulk route from
    BULK_MIN_D positions on and the lane route below, the generic route
    for rows that are not whole aligned vectors."""
    _plan_is_pure(cc_k.plan_combine, ["kind", "n", "d", "itemsize", "sms"])
    sms = cc_k.H100_SMS
    p = cc_k.plan_combine(kind, n, d, 1, sms)
    assert p == cc_k.plan_combine(kind, n, d, 1, sms)
    assert p.ctas >= 1
    row_bytes = cc_k.payload_bytes(kind, d)
    assert cc_k.plan_combine(kind, n, d, 1, sms, aligned=False).route \
        == "generic"
    if row_bytes % 16:
        assert p.route == "generic"
    elif kind == "packed" and d < cc_k.PACKED_LANE_MIN_D:
        assert p.route == "generic"
    else:
        assert p.route == ("bulk" if d >= cc_k.BULK_MIN_D else "lane")
    if p.route != "bulk":
        assert (p.tile, p.stages, p.smem_bytes) == (0, 0, 0)
        assert p.ctas <= (cc_k.GENERIC_MAX_CTAS if p.route == "generic"
                          else cc_k.LANE_CTAS_PER_SM * sms)
        return
    per = cc_k.positions_per_byte(kind)
    tile_in = p.tile // per
    assert p.tile in cc_k.BULK_TILES and tile_in % 16 == 0
    assert (4 * p.tile) % 16 == 0                # the output tile's bytes
    assert cc_k.BULK_MIN_STAGES <= p.stages <= cc_k.BULK_MAX_STAGES
    assert p.smem_bytes == cc_k.bulk_smem(n, p.tile, p.stages, kind)
    assert p.smem_bytes <= cc_k.MAX_SMEM == 232_448
    per_sm = -(-p.ctas // sms)
    assert per_sm * (p.smem_bytes + cc_k.CTA_RESERVED) <= cc_k.SM_SMEM
    tiles = -(-row_bytes // tile_in)
    assert p.ctas <= min(tiles, max(cc_k.BULK_CTAS_PER_SM) * sms)
    tail_bytes = row_bytes - (tiles - 1) * tile_in
    assert 0 < tail_bytes <= tile_in and tail_bytes % 16 == 0
    tail = d - (tiles - 1) * p.tile              # output positions
    assert 0 < tail <= p.tile and (tiles - 1) * p.tile + tail == d


@pytest.mark.parametrize("kind,n,d,want", [
    # one int8 row of the wi_gate leaf: 2 CTAs an SM of 6 stages of 8 KB
    ("quantized", 1, 104_857_600, ("bulk", 264, 8192, 6, 114_784)),
    ("quantized", 3, 104_857_600, ("bulk", 264, 8192, 2, 114_720)),
    ("quantized", 4, 104_857_600, ("bulk", 264, 4096, 5, 114_768)),
    ("quantized", 16, 1 << 24, ("bulk", 264, 2048, 3, 114_736)),
    ("packed", 1, 104_857_600, ("bulk", 264, 8192, 8, 73_856)),
    ("packed", 4, 104_857_600, ("bulk", 264, 8192, 8, 98_432)),
    # below 2^24 positions, the lane route: the norm scales' 8192
    ("quantized", 4, 8192, ("lane", 2, 0, 0, 0)),
    ("packed", 4, 1 << 20, ("lane", 128, 0, 0, 0)),
    ("packed", 4, 8192, ("generic", 4, 0, 0, 0)),   # below 2^20 packed
    ("quantized", 1, (1 << 24) - 16, ("lane", 1056, 0, 0, 0)),
    ("quantized", 200, 1 << 24, ("lane", 1056, 0, 0, 0)),  # rows too many
    ("quantized", 4, 1_000_003, ("generic", 2112, 0, 0, 0)),
    ("quantized", 4, 8191, ("generic", 32, 0, 0, 0)),
    ("packed", 2, 1_000_003, ("generic", 489, 0, 0, 0))])
def test_combine_plan_regimes(kind, n, d, want):
    assert tuple(cc_k.plan_combine(kind, n, d, 1)) == want


@pytest.mark.parametrize("d", [8192, 8191, 104_857_600])
def test_combine_plan_float32_payload_is_generic(d):
    """quantized_combine's float32 payload keeps the generic kernels, on
    16-byte vectors where the rows are whole aligned vectors."""
    p = cc_k.plan_combine("quantized", 4, d, 4)
    vec = d % 4 == 0
    assert p.route == "generic" and p.ctas == min(
        -(-(d // 4 if vec else d) // 256), cc_k.GENERIC_MAX_CTAS)


# -------------------------------------------------- decode attention

def _da_inputs(jnp, rng, B, H, KVH, S, Dh, dtype):
    q = _both(jnp, rng.normal(size=(B, H, Dh)), dtype)
    k = _both(jnp, rng.normal(size=(B, S, KVH, Dh)), dtype)
    v = _both(jnp, rng.normal(size=(B, S, KVH, Dh)), dtype)
    lengths = rng.integers(1, S + 1, size=B).astype(np.int32)
    return q, k, v, lengths


@pytest.mark.parametrize("B,H,KVH,S,Dh,bk", DA_GRID)
@pytest.mark.parametrize("dtype", DTYPES)
def test_decode_attention_plain_matches_jax(jx, B, H, KVH, S, Dh, bk,
                                            dtype):
    rng = np.random.default_rng(3)
    (qj, qt), (kj, kt), (vj, vt), lengths = _da_inputs(
        jx.jnp, rng, B, H, KVH, S, Dh, dtype)
    port = da_ops.decode_attention(qt, kt, vt, torch.from_numpy(lengths))
    assert port.dtype == qt.dtype and port.shape == qt.shape
    lj = jx.jnp.asarray(lengths)
    np.testing.assert_allclose(
        _np(port), _np(jx.da_r.decode_attention(qj, kj, vj, lj)),
        **_tol(dtype))
    np.testing.assert_allclose(
        _np(port), _np(jx.da_k.decode_attention(qj, kj, vj, lj, block_k=bk,
                                                interpret=True)),
        **_tol(dtype))


def _beyond_length_case(device):
    """Values past ``length`` must not change the output (mirrors
    tests/test_kernels.py test_decode_attention_respects_lengths)."""
    rng = np.random.default_rng(4)
    B, H, KVH, S, Dh = 1, 4, 2, 128, 32
    q = torch.tensor(rng.normal(size=(B, H, Dh)), dtype=torch.float32,
                     device=device)
    k = torch.tensor(rng.normal(size=(B, S, KVH, Dh)), dtype=torch.float32,
                     device=device)
    v = torch.tensor(rng.normal(size=(B, S, KVH, Dh)), dtype=torch.float32,
                     device=device)
    lengths = torch.tensor([40], dtype=torch.int32, device=device)
    out1 = da_ops.decode_attention(q, k, v, lengths)
    k2, v2 = k.clone(), v.clone()
    k2[:, 40:] = 999.0
    v2[:, 40:] = -999.0
    out2 = da_ops.decode_attention(q, k2, v2, lengths)
    torch.testing.assert_close(out1, out2, atol=1e-6, rtol=0)


def test_decode_attention_plain_ignores_values_beyond_length():
    _beyond_length_case("cpu")


def test_decode_attention_rejects_ungrouped_heads():
    q = torch.zeros(1, 6, 32)
    k = torch.zeros(1, 8, 4, 32)
    with pytest.raises(ValueError, match="multiple of KVH"):
        da_ops.decode_attention(q, k, k, torch.ones(1, dtype=torch.int32))


def test_kernel_forced_on_cpu_tensor_raises(monkeypatch):
    """No fallback: asking for the kernel on a CPU tensor raises instead
    of quietly running the plain version."""
    monkeypatch.setattr(rn_ops, "_FORCE", "kernel")
    monkeypatch.setattr(da_ops, "_FORCE", "kernel")
    counts = (rn_ops.launches, da_ops.launches)
    with pytest.raises(ValueError, match="CUDA tensor"):
        rn_ops.rmsnorm(torch.ones(2, 8), torch.ones(8))
    q = torch.zeros(1, 4, 32)
    k = torch.zeros(1, 8, 4, 32)
    with pytest.raises(ValueError, match="CUDA tensor"):
        da_ops.decode_attention(q, k, k, torch.ones(1, dtype=torch.int32))
    assert (rn_ops.launches, da_ops.launches) == counts


# The split of the cache over CTAs (flash-decoding): the planner reads
# shapes and the SM count only; each chunk's (m, l, acc) state merges in
# chunk order by the kernel's formula.

from repro_torch.kernels.decode_attention import kernel as da_k

DA_PATH = dict(B=8, H=32, KVH=8, Dh=128)      # granite-3-8b serving


@pytest.mark.parametrize("S", [1, 7, 128, 1024, 32768])
@pytest.mark.parametrize("itemsize", [2, 4])
def test_decode_attention_chunk_plan(S, itemsize):
    import inspect
    assert "lengths" not in inspect.signature(da_k.plan_chunks).parameters
    p = da_k.plan_chunks(S=S, itemsize=itemsize, **DA_PATH)
    assert p == da_k.plan_chunks(S=S, itemsize=itemsize, **DA_PATH)
    G = DA_PATH["H"] // DA_PATH["KVH"]
    assert p.gt == 4 and p.groups == DA_PATH["B"] * DA_PATH["KVH"]
    assert p.tile == da_k.tile_positions(DA_PATH["Dh"], itemsize)
    assert p.chunk % p.tile == 0 and p.chunk >= 1
    assert (p.chunks - 1) * p.chunk < S <= p.chunks * p.chunk
    assert 1 <= p.chunks <= da_k.MAX_CHUNKS
    assert p.state == (2 + DA_PATH["Dh"]) * p.gt and G % p.gt == 0
    # chunks no shorter than MIN_CHUNK unless the cache is; enough CTAs
    # for the card once the cache is long enough to split
    assert p.chunks == 1 or p.chunk >= da_k.MIN_CHUNK
    if S >= 1024:
        assert p.groups * p.chunks >= 2 * da_k.H100_SMS


def _chunked_plain(q, k, v, lengths, chunk):
    """The plain version cut at the planner's chunks: each chunk's fp32
    (m, l, acc) over its valid positions, merged in chunk order as the
    kernel's last CTA merges them; zeros where lengths[b] = 0."""
    B, H, Dh = q.shape
    S, KVH = k.shape[1], k.shape[2]
    G = H // KVH
    qf = q.reshape(B, KVH, G, Dh).float()
    out = torch.zeros(B, KVH, G, Dh)
    for b in range(B):
        n = int(min(max(int(lengths[b]), 0), S))
        states = []
        for t0 in range(0, n, chunk):
            t1 = min(t0 + chunk, n)
            kc = k[b, t0:t1].float().permute(1, 0, 2)        # (KVH, T, Dh)
            vc = v[b, t0:t1].float().permute(1, 0, 2)
            s = torch.einsum("hgd,htd->hgt", qf[b], kc) * Dh ** -0.5
            m = s.amax(-1)
            p = torch.exp(s - m[..., None])
            states.append((m, p.sum(-1), torch.einsum("hgt,htd->hgd", p,
                                                      vc)))
        if not states:
            continue
        mt = torch.stack([m for m, _, _ in states]).amax(0)
        ll = torch.zeros_like(mt)
        acc = torch.zeros(KVH, G, Dh)
        for m, l_, a in states:
            w = torch.exp(m - mt)
            ll = ll + l_ * w
            acc = acc + a * w[..., None]
        out[b] = acc / ll.clamp_min(1e-30)[..., None]
    return out.reshape(B, H, Dh).to(q.dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_decode_attention_chunk_merge_matches_plain_and_jax(jx, dtype):
    """The planner's chunks, merged in order, against the plain version
    and the JAX kernel in interpret mode: lengths 0, 1, chunk - 1,
    chunk + 1 and S. At length 0 the kernel writes zeros (the plain
    version's softmax over nothing is undefined there)."""
    B, H, KVH, S, Dh = 5, 8, 2, 512, 64
    itemsize = 2 if dtype == "bfloat16" else 4
    plan = da_k.plan_chunks(B, H, KVH, S, Dh, itemsize)
    assert plan.chunks > 2
    c = plan.chunk
    lengths = np.array([0, 1, c - 1, c + 1, S], np.int32)
    rng = np.random.default_rng(8)
    (qj, qt), (kj, kt), (vj, vt), _ = _da_inputs(jx.jnp, rng, B, H, KVH, S,
                                                 Dh, dtype)
    got = _chunked_plain(qt, kt, vt, torch.from_numpy(lengths), c)
    assert got.dtype == qt.dtype and got.shape == qt.shape
    assert torch.equal(got[0], torch.zeros_like(got[0]))
    lj = jx.jnp.asarray(lengths)
    want_ref = da_r.decode_attention(qt, kt, vt, torch.from_numpy(lengths))
    want_jax = jx.da_k.decode_attention(qj, kj, vj, lj, block_k=128,
                                        interpret=True)
    np.testing.assert_allclose(_np(got)[1:], _np(want_ref)[1:],
                               **_tol(dtype))
    np.testing.assert_allclose(_np(got)[1:], _np(want_jax)[1:],
                               **_tol(dtype))


# ----------------------------------------------------- coded combines

@pytest.fixture(scope="module")
def jcc():
    """The JAX package's coded_combine kernel and ref modules."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.kernels.coded_combine import kernel, ref
    return types.SimpleNamespace(jnp=jnp, k=kernel, r=ref)


def _exact_qsw(rng, n, D, payload):
    """The reference suite's exactness-preserving inputs."""
    q = rng.integers(-127, 128, size=(n, D)).astype(
        np.int8 if payload == "int8" else np.float32)
    s = (2.0 ** rng.integers(-4, 1, size=n)).astype(np.float32)
    w = (rng.choice([-1.0, 0.0, 1.0], size=n)
         * 2.0 ** rng.integers(-2, 3, size=n)).astype(np.float32)
    return q, s, w


def _exact_packed(rng, n, D):
    q = rng.integers(0, 256, size=(n, (D + 7) // 8)).astype(np.uint8)
    s = (2.0 ** rng.integers(-4, 1, size=n)).astype(np.float32)
    w = (rng.choice([-1.0, 0.0, 1.0], size=n)
         * 2.0 ** rng.integers(-2, 3, size=n)).astype(np.float32)
    return q, s, w


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("n,D", [(8, 1000), (24, 4096), (3, 130),
                                 (1, 256), (16, 65536)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_coded_combine_plain_matches_jax_kernel(jcc, n, D, dtype):
    rng = np.random.default_rng(n * 1000 + D)
    gj, gt = _both(jcc.jnp, rng.normal(size=(n, D)), dtype)
    w = rng.normal(size=n).astype(np.float32)
    port = cc_ops.coded_combine(gt, _t(w))
    assert port.dtype == gt.dtype and port.shape == (D,)
    want = jcc.k.coded_combine(gj, jcc.jnp.asarray(w), interpret=True)
    np.testing.assert_allclose(_np(port), _np(want), **_tol(dtype))
    np.testing.assert_allclose(_np(port), _np(jcc.r.coded_combine(
        gj, jcc.jnp.asarray(w))), **_tol(dtype))


def test_coded_combine_tree_matches_jax(jcc):
    """Every leaf of a tree reduced over its leading axis, shapes
    kept (tests/test_kernels.py:380)."""
    from repro.kernels.coded_combine import ops as jops
    rng = np.random.default_rng(3)
    tree = {"a": rng.normal(size=(4, 3, 5)).astype(np.float32),
            "b": {"c": rng.normal(size=(4, 7)).astype(np.float32)}}
    w = rng.normal(size=4).astype(np.float32)
    port = cc_ops.coded_combine_tree(
        {"a": _t(tree["a"]), "b": {"c": _t(tree["b"]["c"])}}, _t(w))
    want = jops.coded_combine_tree(
        {"a": jcc.jnp.asarray(tree["a"]),
         "b": {"c": jcc.jnp.asarray(tree["b"]["c"])}}, jcc.jnp.asarray(w))
    assert port["a"].shape == (3, 5) and port["b"]["c"].shape == (7,)
    np.testing.assert_allclose(_np(port["a"]), _np(want["a"]),
                               **_tol("float32"))
    np.testing.assert_allclose(_np(port["b"]["c"]), _np(want["b"]["c"]),
                               **_tol("float32"))


@pytest.mark.parametrize("n,D", [(1, 256), (2, 130), (4, 1000),
                                 (7, 61), (16, 4096), (3, 129)])
@pytest.mark.parametrize("payload", ["int8", "float32"])
def test_quantized_combine_plain_bitwise_to_np_and_jax(jcc, n, D,
                                                       payload):
    rng = np.random.default_rng(n * 1000 + D)
    q, s, w = _exact_qsw(rng, n, D, payload)
    oracle = cc_r.quantized_combine_np(q, s, w)
    np.testing.assert_array_equal(
        oracle, jcc.r.quantized_combine_np(q, s, w))
    port = cc_ops.quantized_combine(_t(q), _t(s), _t(w))
    assert port.dtype == torch.float32
    np.testing.assert_array_equal(port.numpy(), oracle)
    jnp = jcc.jnp
    pallas = jcc.k.quantized_combine(jnp.asarray(q), jnp.asarray(s),
                                     jnp.asarray(w), interpret=True)
    np.testing.assert_array_equal(port.numpy(), np.asarray(pallas))


@pytest.mark.parametrize("n,D", [(2, 73), (5, 700), (6, 69), (16, 4096)])
def test_quantized_combine_plain_general_inputs_tolerance(jcc, n, D):
    rng = np.random.default_rng(n * 1000 + D)
    q = rng.integers(-127, 128, size=(n, D)).astype(np.int8)
    s = (rng.uniform(0.1, 2.0, size=n)
         * 10.0 ** rng.integers(-2, 3, size=n)).astype(np.float32)
    w = rng.normal(size=n).astype(np.float32)
    ref = np.asarray(cc_r.quantized_combine_np(q, s, w), np.float64)
    scale = max(1.0, float(np.abs(ref).max()))
    port = cc_ops.quantized_combine(_t(q), _t(s), _t(w))
    np.testing.assert_allclose(port.numpy().astype(np.float64) / scale,
                               ref / scale, atol=2e-5, rtol=0)
    jnp = jcc.jnp
    pallas = jcc.k.quantized_combine(jnp.asarray(q), jnp.asarray(s),
                                     jnp.asarray(w), interpret=True)
    np.testing.assert_allclose(port.numpy(), np.asarray(pallas),
                               atol=2e-5 * scale, rtol=0)


@pytest.mark.parametrize("n,D", [(1, 256), (2, 130), (4, 1000),
                                 (7, 61), (16, 4096), (3, 129), (5, 8),
                                 (3, 1), (2, 7), (2, 9)])
def test_packed_sign_combine_plain_bitwise_to_np_and_jax(jcc, n, D):
    """Widths that are and are not multiples of 8: the padding bits of
    the trailing byte must be dropped, not summed as -1."""
    rng = np.random.default_rng(n * 1000 + D)
    q, s, w = _exact_packed(rng, n, D)
    oracle = cc_r.packed_sign_combine_np(q, s, w, D)
    np.testing.assert_array_equal(
        oracle, jcc.r.packed_sign_combine_np(q, s, w, D))
    port = cc_ops.packed_sign_combine(_t(q), _t(s), _t(w), D)
    assert port.shape == (D,) and port.dtype == torch.float32
    np.testing.assert_array_equal(port.numpy(), oracle)
    jnp = jcc.jnp
    pallas = jcc.k.packed_sign_combine(jnp.asarray(q), jnp.asarray(s),
                                       jnp.asarray(w), d=D,
                                       interpret=True)
    np.testing.assert_array_equal(port.numpy(), np.asarray(pallas))


def test_packed_sign_combine_plain_general_inputs_tolerance(jcc):
    rng = np.random.default_rng(17)
    n, D = 6, 700
    q = rng.integers(0, 256, size=(n, (D + 7) // 8)).astype(np.uint8)
    s = (rng.uniform(0.1, 2.0, size=n)
         * 10.0 ** rng.integers(-2, 3, size=n)).astype(np.float32)
    w = rng.normal(size=n).astype(np.float32)
    ref = np.asarray(cc_r.packed_sign_combine_np(q, s, w, D), np.float64)
    scale = max(1.0, float(np.abs(ref).max()))
    port = cc_ops.packed_sign_combine(_t(q), _t(s), _t(w), D)
    np.testing.assert_allclose(port.numpy().astype(np.float64) / scale,
                               ref / scale, atol=2e-5, rtol=0)


@pytest.mark.parametrize("kind", ["coded", "quantized", "packed"])
def test_dead_rows_give_exact_zeros(kind):
    """w_j == 0: perturbing a straggler row's payload leaves the result
    bit for bit unchanged, and an all-dead combine is exactly zero."""
    rng = np.random.default_rng(5)
    D = 400
    if kind == "packed":
        q, s, w = _exact_packed(rng, 5, D)
    else:
        q, s, w = _exact_qsw(rng, 5, D, "int8")
    w[1] = w[3] = 0.0
    q2 = q.copy()
    q2[1] = 0xFF if kind == "packed" else 127
    q2[3] = 0 if kind == "packed" else -127

    def run(qq, ww):
        if kind == "coded":
            return cc_ops.coded_combine(_t(qq.astype(np.float32)), _t(ww))
        if kind == "quantized":
            return cc_ops.quantized_combine(_t(qq), _t(s), _t(ww))
        return cc_ops.packed_sign_combine(_t(qq), _t(s), _t(ww), D)
    assert torch.equal(run(q, w), run(q2, w))
    zero = run(q, np.zeros_like(w))
    assert torch.equal(zero, torch.zeros(D, dtype=zero.dtype))


def test_packed_sign_combine_rejects_mismatched_width(monkeypatch):
    """The width check raises before any launch, on either device."""
    before = dict(cc_ops.launches)
    with pytest.raises(ValueError, match="width"):
        cc_ops.packed_sign_combine(torch.zeros(2, 4, dtype=torch.uint8),
                                   torch.ones(2), torch.ones(2), 64)
    monkeypatch.setattr(cc_ops, "_FORCE", "kernel")
    with pytest.raises(ValueError, match="width"):
        cc_ops.packed_sign_combine(torch.zeros(2, 4, dtype=torch.uint8),
                                   torch.ones(2), torch.ones(2), 40)
    assert cc_ops.launches == before


def test_combine_kernels_forced_on_cpu_tensor_raise(monkeypatch):
    """No fallback: the kernels refuse a CPU tensor and count nothing."""
    monkeypatch.setattr(cc_ops, "_FORCE", "kernel")
    before = dict(cc_ops.launches)
    g, w = torch.ones(2, 8), torch.ones(2)
    with pytest.raises(ValueError, match="CUDA tensor"):
        cc_ops.coded_combine(g, w)
    with pytest.raises(ValueError, match="CUDA tensor"):
        cc_ops.quantized_combine(g.to(torch.int8), w, w)
    with pytest.raises(ValueError, match="CUDA tensor"):
        cc_ops.packed_sign_combine(torch.zeros(2, 1, dtype=torch.uint8),
                                   w, w, 8)
    assert cc_ops.launches == before


# ------------------------------------------------------ on the card

# every plan regime: a CTA a row (8 rows), a warp a row (8192), rows in
# between, wide rows (12800, 65536 bf16), and the loop kernel (d = 4095,
# 130 and 33 * 130 not whole vectors; 65536 f32 and 70000 past the
# registers)
RMS_CARD_SHAPES = RMS_SHAPES + [
    (8, 1, 4096), (33, 130), (1, 128), (132, 4096), (8192, 4096),
    (8, 5120), (8, 12800), (4, 65536), (2, 70000), (8, 4095)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", RMS_CARD_SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_rmsnorm_kernel_matches_plain_on_card(cuda, shape, dtype):
    rng = np.random.default_rng(5)
    x = torch.tensor(rng.normal(size=shape), device=cuda).to(
        getattr(torch, dtype))
    s = torch.tensor(rng.normal(size=shape[-1]), device=cuda,
                     dtype=torch.float32)
    before = rn_ops.launches
    out = rn_ops.rmsnorm(x, s)
    torch.cuda.synchronize()
    assert rn_ops.launches == before + 1
    assert out.dtype == x.dtype and out.shape == x.shape
    np.testing.assert_allclose(_np(out), _np(rn_r.rmsnorm(x, s)),
                               **_tol(dtype))


class _EdgeData(ctypes.Structure):
    """cudaGraphEdgeData: from_port, to_port, type, 5 reserved bytes."""
    _fields_ = [("from_port", ctypes.c_ubyte), ("to_port", ctypes.c_ubyte),
                ("type", ctypes.c_ubyte), ("reserved", ctypes.c_ubyte * 5)]


def _graph_edge_types(graph):
    """The dependency type of every edge of a kept CUDA graph
    (cudaGraphGetEdges_v2; 1 is cudaGraphDependencyTypeProgrammatic)."""
    rt = ctypes.CDLL("libcudart.so.12")
    fn = rt.cudaGraphGetEdges_v2
    fn.restype = ctypes.c_int
    raw = ctypes.c_void_p(graph.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    assert fn(raw, None, None, None, ctypes.byref(n)) == 0
    frm, to = (ctypes.c_void_p * n.value)(), (ctypes.c_void_p * n.value)()
    data = (_EdgeData * n.value)()
    assert fn(raw, frm, to, data, ctypes.byref(n)) == 0
    return [e.type for e in data]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(8, 1, 4096), (8192, 4096), (8, 4095)])
def test_rmsnorm_graph_keeps_programmatic_edge_on_card(cuda, shape):
    """Captured in a CUDA graph right after the torch kernel that writes
    its x, rmsnorm keeps its programmatic dependent launch: the edge
    from the writer is programmatic, and the replay is right."""
    g = torch.Generator(device=cuda).manual_seed(13)
    src = torch.randn(shape, generator=g, device=cuda).to(torch.bfloat16)
    s = torch.randn(shape[-1], generator=g, device=cuda)
    x = torch.empty_like(src)
    fn = lambda: (torch.add(src, 1.0, out=x),  # noqa: E731
                  rn_ops.rmsnorm(x, s))[1]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        out = fn()
    assert 1 in _graph_edge_types(graph)
    graph.instantiate()
    src.mul_(-2.0)
    graph.replay()
    torch.cuda.synchronize()
    np.testing.assert_allclose(_np(out), _np(rn_r.rmsnorm(src + 1.0, s)),
                               **_tol("bfloat16"))


@pytest.mark.cuda
@pytest.mark.parametrize("rows,d", [(8, 4096), (8192, 4096), (3, 4095)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_rmsnorm_kernel_misaligned_view_on_card(cuda, rows, d, dtype):
    """A contiguous view that starts one element past a 16-byte boundary
    goes to the loop kernel's scalar path, and agrees with the plain
    version and with the kernel on an aligned copy."""
    dt = getattr(torch, dtype)
    g = torch.Generator(device=cuda).manual_seed(rows + d)
    base = torch.randn(rows * d + 1, generator=g, device=cuda).to(dt)
    x = base[1:].view(rows, d)
    assert x.is_contiguous() and x.data_ptr() % 16
    s = torch.randn(d, generator=g, device=cuda)
    assert rn_k.plan_rows(rows, d, x.element_size(), aligned=False).vpt == 0
    out = rn_ops.rmsnorm(x, s)
    aligned = rn_ops.rmsnorm(x.clone(), s)
    torch.cuda.synchronize()
    np.testing.assert_allclose(_np(out), _np(rn_r.rmsnorm(x, s)),
                               **_tol(dtype))
    np.testing.assert_allclose(_np(out), _np(aligned), **_tol(dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(8, 1, 4096), (8192, 4096), (8, 4095)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_rmsnorm_kernel_after_writer_in_graph_on_card(cuda, shape, dtype):
    """rmsnorm right after the torch kernel that writes its x, four times
    in one CUDA graph: each output is that of the x just written (the
    kernel waits for its writer before it reads x), and repeats --
    eager, replayed, back to back -- are bitwise."""
    dt = getattr(torch, dtype)
    g = torch.Generator(device=cuda).manual_seed(11)
    src = torch.randn(shape, generator=g, device=cuda).to(dt)
    s = torch.randn(shape[-1], generator=g, device=cuda)
    x = torch.empty_like(src)

    def fn():
        outs = []
        for i in range(4):
            torch.add(src, float(i + 1), out=x)
            outs.append(rn_ops.rmsnorm(x, s))
        return torch.stack(outs)

    out = fn()
    torch.cuda.synchronize()
    for i in range(4):
        np.testing.assert_allclose(
            _np(out[i]), _np(rn_r.rmsnorm(src + float(i + 1), s)),
            **_tol(dtype))
    _repeat_graph_and_burst(fn, out)
    # a graph replayed on new values of src: the writer's new x each time
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = fn()
    for step in range(3):
        src.copy_(torch.randn(shape, generator=g, device=cuda).to(dt))
        graph.replay()
        want = fn()
        torch.cuda.synchronize()
        assert torch.equal(captured, want), step


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,KVH,S,Dh,bk",
                         DA_GRID + [(8, 32, 8, 1024, 128, 0),
                                    (2, 20, 20, 300, 128, 0),
                                    (2, 12, 4, 77, 256, 0)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_decode_attention_kernel_matches_plain_on_card(
        cuda, B, H, KVH, S, Dh, bk, dtype):
    rng = np.random.default_rng(6)
    dt = getattr(torch, dtype)
    q = torch.tensor(rng.normal(size=(B, H, Dh)), device=cuda).to(dt)
    k = torch.tensor(rng.normal(size=(B, S, KVH, Dh)), device=cuda).to(dt)
    v = torch.tensor(rng.normal(size=(B, S, KVH, Dh)), device=cuda).to(dt)
    lengths = torch.tensor(rng.integers(1, S + 1, size=B), device=cuda,
                           dtype=torch.int32)
    before = da_ops.launches
    out = da_ops.decode_attention(q, k, v, lengths)
    torch.cuda.synchronize()
    assert da_ops.launches == before + 1
    np.testing.assert_allclose(
        _np(out), _np(da_r.decode_attention(q, k, v, lengths)),
        **_tol(dtype))


@pytest.mark.cuda
def test_decode_attention_kernel_ignores_values_beyond_length(cuda):
    _beyond_length_case(cuda)


def _repeat_graph_and_burst(fn, want):
    """Two launches give the same bits, a CUDA-graph replay of the call
    gives them too, and so do 20 launches back to back (a last-CTA
    ticket that failed to reset to 0 would break the second of them)."""
    again = fn()
    torch.cuda.synchronize()
    assert torch.equal(want, again)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = fn()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(want, captured)
    burst = [fn() for _ in range(20)]
    torch.cuda.synchronize()
    assert all(torch.equal(want, o) for o in burst)


DA_SCALED_TOL = 3e-2     # max |err| <= this * max |want|


def _da_card_inputs(cuda, B, H, KVH, S, Dh, dtype, seed):
    g = torch.Generator(device=cuda).manual_seed(seed)
    dt = getattr(torch, dtype)
    return (torch.randn(B, H, Dh, generator=g, device=cuda).to(dt),
            torch.randn(B, S, KVH, Dh, generator=g, device=cuda).to(dt),
            torch.randn(B, S, KVH, Dh, generator=g, device=cuda).to(dt))


@pytest.mark.cuda
@pytest.mark.parametrize("length", [0, 1, 32768])
@pytest.mark.parametrize("G", [1, 2, 4, 8])
@pytest.mark.parametrize("Dh", [32, 64, 128, 256])
@pytest.mark.parametrize("dtype", DTYPES)
def test_decode_attention_kernel_many_chunks_on_card(cuda, length, G, Dh,
                                                     dtype):
    """B = 1 over a 32k cache: many chunks, merged by the last CTA; zeros
    at length 0. The outputs of a full 32k cache are small (about
    sqrt(e / 32768) rms), so the error is also held against max |want|:
    a chunk dropped from the merge exceeds DA_SCALED_TOL of it."""
    B, KVH, S = 1, 2, 32768
    q, k, v = _da_card_inputs(cuda, B, G * KVH, KVH, S, Dh, dtype, G + Dh)
    assert da_k.plan_chunks(B, G * KVH, KVH, S, Dh,
                            q.element_size()).chunks > 1
    lens = torch.tensor([length], dtype=torch.int32, device=cuda)
    out = da_ops.decode_attention(q, k, v, lens)
    torch.cuda.synchronize()
    if length == 0:
        assert torch.equal(out, torch.zeros_like(out))
    else:
        want = _np(da_r.decode_attention(q, k, v, lens))
        np.testing.assert_allclose(_np(out), want, **_tol(dtype))
        assert np.abs(_np(out) - want).max() <= \
            DA_SCALED_TOL * np.abs(want).max()


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,KVH,S,Dh,lengths", [
    (8, 32, 8, 1024, 128, "ragged"), (8, 32, 8, 1024, 128, "144"),
    (1, 32, 8, 32768, 128, "full"), (3, 20, 20, 300, 128, "edges"),
    (2, 16, 2, 4096, 64, "edges")])
@pytest.mark.parametrize("dtype", DTYPES)
def test_decode_attention_kernel_repeats_in_graphs_on_card(
        cuda, B, H, KVH, S, Dh, lengths, dtype):
    q, k, v = _da_card_inputs(cuda, B, H, KVH, S, Dh, dtype, B + S)
    rng = np.random.default_rng(S)
    n = {"ragged": rng.integers(1, S + 1, B), "144": [144] * B,
         "full": [S] * B, "edges": ([0, 1, S] * B)[:B]}[lengths]
    lens = torch.tensor(n, dtype=torch.int32, device=cuda)
    fn = lambda: da_ops.decode_attention(q, k, v, lens)  # noqa: E731
    out = fn()
    torch.cuda.synchronize()
    want = da_r.decode_attention(q, k, v, lens)
    live = lens > 0
    np.testing.assert_allclose(_np(out[live]), _np(want[live]),
                               **_tol(dtype))
    assert torch.equal(out[~live], torch.zeros_like(out[~live]))
    _repeat_graph_and_burst(fn, out)


def _card_combine_case(cuda, kind, n, D, dtype, exact):
    rng = np.random.default_rng(n * 7 + D)
    if kind == "packed":
        q, s, w = _exact_packed(rng, n, D)
        if not exact:
            s = rng.uniform(0.1, 2.0, size=n).astype(np.float32)
            w = rng.normal(size=n).astype(np.float32)
    elif exact:
        q, s, w = _exact_qsw(rng, n, D, "int8" if dtype == "int8"
                             else "float32")
    else:
        q = (rng.integers(-127, 128, size=(n, D)).astype(np.int8)
             if dtype == "int8"
             else rng.normal(size=(n, D)).astype(np.float32))
        s = rng.uniform(0.1, 2.0, size=n).astype(np.float32)
        w = rng.normal(size=n).astype(np.float32)
    if n == 1 and w[0] == 0:   # one row: a live one
        w[0] = 0.5
    qt = torch.tensor(q, device=cuda)
    if kind == "coded":
        qt = qt.to(getattr(torch, dtype))
    st, wt = (torch.tensor(a, device=cuda) for a in (s, w))
    if kind == "coded":
        return (qt, wt), cc_ops.coded_combine, cc_r.coded_combine
    if kind == "quantized":
        return (qt, st, wt), cc_ops.quantized_combine, \
            cc_r.quantized_combine
    return (qt, st, wt, D), cc_ops.packed_sign_combine, \
        cc_r.packed_sign_combine


@pytest.mark.cuda
@pytest.mark.parametrize("kind,dtype", [("coded", "float32"),
                                        ("coded", "bfloat16"),
                                        ("quantized", "int8"),
                                        ("quantized", "float32"),
                                        ("packed", "uint8")])
@pytest.mark.parametrize("n,D", [(4, 8192), (4, 1), (4, 7), (3, 9),
                                 (4, 1_000_003), (16, 4096), (1, 130),
                                 # rows and tails on each route: generic
                                 # (1,000,003 and 3 * 4096 + 5 are no
                                 # whole int8 or packed vectors), lane
                                 # (int8 3 * 4096 + 16; packed 1,048,701
                                 # ends 3 short of a whole float4) and
                                 # the bulk route's short last tile (16
                                 # int8 positions past 2^24; 125 packed)
                                 (1, 1_000_003), (2, 3 * 4096 + 5),
                                 (1, 3 * 4096 + 16), (2, 1_048_701),
                                 (1, (1 << 24) + 16), (2, 16_777_341)])
@pytest.mark.parametrize("exact", [False, True])
def test_combine_kernels_equal_plain_on_card(cuda, kind, dtype, n, D,
                                             exact):
    args, op, plain = _card_combine_case(cuda, kind, n, D, dtype, exact)
    before = cc_ops.launches[op.__name__]
    out = op(*args)
    torch.cuda.synchronize()
    assert cc_ops.launches[op.__name__] == before + 1
    assert torch.equal(out, plain(*args))
    if exact and kind != "coded":
        _assert_oracle(kind, args, out)


def _assert_oracle(kind, args, out):
    host = [a.cpu().numpy() if isinstance(a, torch.Tensor) else a
            for a in args]
    oracle = (cc_r.quantized_combine_np(*host) if kind == "quantized"
              else cc_r.packed_sign_combine_np(*host))
    np.testing.assert_array_equal(out.cpu().numpy(), oracle)


def _offset_view(t: torch.Tensor, offset: int) -> torch.Tensor:
    """A contiguous copy of t that starts ``offset`` bytes past a 16-byte
    boundary."""
    flat = torch.empty(t.numel() * t.element_size() + 16, dtype=torch.uint8,
                       device=t.device)
    view = flat[offset:offset + t.numel() * t.element_size()].view(
        t.dtype).view(t.shape)
    view.copy_(t)
    return view


@pytest.mark.cuda
@pytest.mark.parametrize("kind,dtype", [("quantized", "int8"),
                                        ("packed", "uint8")])
@pytest.mark.parametrize("n,D", [(2, 1 << 20), (4, 3 << 20),
                                 (1, 1 << 24)])
def test_combine_misaligned_payload_takes_generic_route_on_card(
        cuda, kind, dtype, n, D):
    """A payload whose rows start off a 16-byte boundary is planned onto
    the generic kernels before the launch, and gives the plain version's
    and the aligned launch's bits (the lane and the bulk route)."""
    args, op, plain = _card_combine_case(cuda, kind, n, D, dtype, True)
    q = _offset_view(args[0], 1)
    assert q.is_contiguous() and q.data_ptr() % 16
    assert cc_k.plan_combine(kind, n, D, 1).route != "generic"
    assert cc_k._plan_for(kind, q, D).route == "generic"
    out = op(q, *args[1:])
    aligned = op(*args)
    torch.cuda.synchronize()
    assert torch.equal(out, plain(q, *args[1:]))
    assert torch.equal(out, aligned)
    _assert_oracle(kind, args, out)


@pytest.mark.cuda
@pytest.mark.parametrize("kind,dtype", [("quantized", "int8"),
                                        ("packed", "uint8")])
@pytest.mark.parametrize("n,D", [(1, 1_048_701), (4, 8192),
                                 (2, 3 * 4096 + 5), (1, (1 << 24) + 16),
                                 (2, 16_777_341)])
def test_combine_repeats_in_graphs_on_card(cuda, kind, dtype, n, D):
    """Two replays of a captured combine give one eager launch's bits, and
    so do 20 launches back to back."""
    args, op, plain = _card_combine_case(cuda, kind, n, D, dtype, False)
    want = op(*args)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        op(*args)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = op(*args)
    for _ in range(2):
        captured.fill_(float("nan"))
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(want, captured)
    burst = [op(*args) for _ in range(20)]
    torch.cuda.synchronize()
    assert all(torch.equal(want, o) for o in burst)
    assert torch.equal(want, plain(*args))


# ------------------------------------------------------------- build

def _fake_nvcc(tmp_path, body):
    fake = tmp_path / "nvcc"
    fake.write_text("#!" + __import__("sys").executable + "\n" + body)
    fake.chmod(0o755)
    return str(fake)


def test_failed_build_raises_with_compiler_output(tmp_path, monkeypatch):
    """A kernel that does not build stops the caller: no plain fallback."""
    from repro_torch.kernels import build
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(build, "nvcc_path", lambda: _fake_nvcc(
        tmp_path, "import sys\nprint('error: no such target')\n"
        "sys.exit(1)\n"))
    with pytest.raises(RuntimeError, match="no such target"):
        build.build(["rmsnorm", "decode_attention"])
    assert not list((tmp_path / "_build").glob("*.so"))


def test_build_compiles_missing_sources_once(tmp_path, monkeypatch):
    from repro_torch.kernels import build
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(build, "nvcc_path", lambda: _fake_nvcc(
        tmp_path, "import sys\nout = sys.argv[sys.argv.index('-o') + 1]\n"
        "open(out, 'w').write('lib')\n"
        "print('ptxas info    : Used 32 registers')\n"))
    first = build.build()
    assert set(first) == set(build.SOURCES)
    assert build.build() == {}
    assert "32 registers" in build.compiler_report("rmsnorm")
    for name in build.SOURCES:
        assert build.library_path(name).parent == tmp_path / "_build"


# ------------------------------- harness kernels: fused_error, gram_matvec
#
# The reference suite's grids and tolerances (tests/test_kernels.py:
# 278-358): fused_error rtol = atol = 2e-5 against the float64 oracle;
# the Gram matvecs atol 5e-6 after scaling by max(1, max|ref|) -- float32
# accumulation over R rows of products. On the CPU the ops are the
# float64 oracles themselves, equal to the reference's bit for bit.

from repro_torch.kernels.batched_alpha import ops as ba_ops, ref as ba_r
from repro_torch.kernels.spectral_matvec import kernel as sm_k, \
    ops as sm_ops, ref as sm_r

BA_GRID = [(4, 128, None), (10, 130, 8), (64, 1000, 16), (1, 256, None),
           (33, 384, 8)]
SM_GRID = [(64, 16, None), (100, 1, 16), (256, 130, 32), (33, 64, None),
           (17, 384, 8), (2184, 30, None)]
SM_BLOCK_GRID = [(64, 16, 1), (100, 30, 4), (33, 130, 7), (2184, 30, 3)]
SM_BATCH_GRID = [(1, 64, 16, None), (5, 100, 30, 16), (3, 33, 130, 8),
                 (12, 2184, 30, None)]


def _scaled_close(got, want):
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(np.asarray(got, np.float64) / scale,
                               want / scale, atol=5e-6, rtol=0)


@pytest.fixture(scope="module")
def jha():
    """The JAX package's batched_alpha / spectral_matvec modules."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.kernels.batched_alpha import kernel as ba_k, ops as ba_o
    from repro.kernels.spectral_matvec import kernel as sm_jk, ops as sm_o
    return types.SimpleNamespace(jnp=jnp, ba_k=ba_k, ba_o=ba_o,
                                 sm_k=sm_jk, sm_o=sm_o)


@pytest.mark.parametrize("T,n,bt", BA_GRID)
def test_fused_error_plain_matches_jax_kernel(jha, T, n, bt):
    rng = np.random.default_rng(T * 1000 + n)
    a = rng.normal(loc=1.0, scale=0.2, size=(T, n))
    scale = float(rng.uniform(0.5, 1.5))
    want = np.asarray(jha.ba_k.fused_error(
        jha.jnp.asarray(a, jha.jnp.float32), jha.jnp.float32(scale),
        block_t=bt, interpret=True), np.float64)
    got = ba_r.fused_error(_t(a.astype(np.float32)), scale)
    assert got.dtype == torch.float32 and got.shape == (T,)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got.numpy(), ba_r.fused_error_np(a, scale),
                               rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("debias", [True, False])
def test_fused_error_ops_on_cpu_is_the_reference_oracle(jha, debias):
    a = np.random.default_rng(3).normal(1.0, 0.1, size=(32, 24))
    errs, scale = ba_ops.fused_error(a, debias=debias, device="cpu")
    r_errs, r_scale = jha.ba_o.fused_error(a, debias=debias)
    assert scale == r_scale and errs.dtype == np.float64
    np.testing.assert_array_equal(errs, r_errs)
    assert ba_ops.debias_scale(a) == jha.ba_o.debias_scale(a)
    e0, s0 = ba_ops.fused_error(np.zeros((0, 5)), device="cpu")
    assert e0.shape == (0,) and s0 == 1.0
    with pytest.raises(ValueError, match="trials, n"):
        ba_ops.fused_error(np.ones(4), device="cpu")


@pytest.mark.parametrize("R,k,br", SM_GRID)
def test_gram_matvec_plain_matches_jax_kernel(jha, R, k, br):
    rng = np.random.default_rng(R * 7 + k)
    x, v = rng.normal(size=(R, k)), rng.normal(size=k)
    want = np.asarray(jha.sm_k.gram_matvec(
        jha.jnp.asarray(x, jha.jnp.float32),
        jha.jnp.asarray(v, jha.jnp.float32), block_r=br, interpret=True),
        np.float64)
    got = sm_r.gram_matvec(_t(x.astype(np.float32)),
                           _t(v.astype(np.float32)))
    assert got.dtype == torch.float32 and got.shape == (k,)
    oracle = sm_r.gram_matvec_np(x, v)
    _scaled_close(want, oracle)
    _scaled_close(got.numpy(), oracle)


@pytest.mark.parametrize("R,k,bv", SM_BLOCK_GRID)
def test_gram_matvec_block_plain_matches_jax_kernel(jha, R, k, bv):
    rng = np.random.default_rng(R * 11 + bv)
    x, V = rng.normal(size=(R, k)), rng.normal(size=(k, bv))
    want = np.asarray(jha.sm_k.gram_matvec(
        jha.jnp.asarray(x, jha.jnp.float32),
        jha.jnp.asarray(V.T, jha.jnp.float32), interpret=True), np.float64)
    got = sm_r.gram_matvec(_t(x.astype(np.float32)),
                           _t(np.ascontiguousarray(V.T, np.float32)))
    assert got.shape == (bv, k)
    oracle = sm_r.gram_matvec_block_np(x, V)
    _scaled_close(want.T, oracle)
    _scaled_close(got.numpy().T, oracle)


@pytest.mark.parametrize("B,R,k,br", SM_BATCH_GRID)
def test_gram_matvec_batch_plain_matches_jax_kernel(jha, B, R, k, br):
    rng = np.random.default_rng(B * 13 + R)
    x, v = rng.normal(size=(B, R, k)), rng.normal(size=(B, k))
    want = np.asarray(jha.sm_k.gram_matvec_batch(
        jha.jnp.asarray(x, jha.jnp.float32),
        jha.jnp.asarray(v, jha.jnp.float32), block_r=br, interpret=True),
        np.float64)
    got = sm_r.gram_matvec_batch(_t(x.astype(np.float32)),
                                 _t(v.astype(np.float32)))
    assert got.shape == (B, k)
    oracle = sm_r.gram_matvec_batch_np(x, v)
    _scaled_close(want, oracle)
    _scaled_close(got.numpy(), oracle)


def test_gram_matvec_ops_on_cpu_are_the_reference_oracles(jha):
    rng = np.random.default_rng(4)
    x, v, V = rng.normal(size=(50, 7)), rng.normal(size=7), \
        rng.normal(size=(7, 3))
    xb, vb = rng.normal(size=(4, 40, 9)), rng.normal(size=(4, 9))
    staged = sm_ops.prepare_operand(x, "cpu")
    assert isinstance(staged, np.ndarray) and staged.dtype == np.float64
    assert not sm_ops.uses_kernel("cpu")
    np.testing.assert_array_equal(sm_ops.gram_matvec(staged, v),
                                  jha.sm_o.gram_matvec(x, v))
    np.testing.assert_array_equal(sm_ops.gram_matvec_block(staged, V),
                                  jha.sm_o.gram_matvec_block(x, V))
    np.testing.assert_array_equal(sm_ops.gram_matvec_batch(xb, vb),
                                  jha.sm_o.gram_matvec_batch(xb, vb))
    for i in range(4):
        np.testing.assert_array_equal(sm_r.gram_matvec_batch_np(xb, vb)[i],
                                      sm_r.gram_matvec_np(xb[i], vb[i]))
    with pytest.raises(ValueError, match="R, k"):
        sm_ops.gram_matvec(x, np.ones(3))
    with pytest.raises(ValueError, match="k, b"):
        sm_ops.gram_matvec_block(x, np.ones((3, 2)))
    with pytest.raises(ValueError, match="B, R, k"):
        sm_ops.gram_matvec_batch(xb, np.ones((4, 3)))


def test_harness_plain_versions_on_cpu_tensors(monkeypatch):
    """A CPU tensor (or ``_FORCE = "ref"``) takes the plain float32 torch
    version and counts it as such; no kernel launch is counted."""
    rng = np.random.default_rng(6)
    x, v = rng.normal(size=(40, 9)), rng.normal(size=9)
    before, plain = dict(sm_ops.launches), dict(sm_ops.plain_calls)
    got = sm_ops.gram_matvec(torch.from_numpy(x).float(), v)
    _scaled_close(got, sm_r.gram_matvec_np(x, v))
    assert sm_ops.plain_calls["gram_matvec"] == plain["gram_matvec"] + 1
    monkeypatch.setattr(sm_ops, "_FORCE", "ref")
    got = sm_ops.gram_matvec_block(x, np.stack([v, -v], axis=1))
    _scaled_close(got, sm_r.gram_matvec_block_np(x, np.stack([v, -v], 1)))
    assert sm_ops.launches == before
    monkeypatch.setattr(ba_ops, "_FORCE", "ref")
    n_plain, n_launch = ba_ops.plain_calls, ba_ops.launches
    a = rng.normal(1.0, 0.1, size=(8, 33))
    errs, scale = ba_ops.fused_error(a, device="cpu")
    np.testing.assert_allclose(errs, ba_r.fused_error_np(a, scale),
                               rtol=2e-5, atol=2e-5)
    assert (ba_ops.plain_calls, ba_ops.launches) == (n_plain + 1, n_launch)


def test_harness_kernels_forced_on_cpu_raise(monkeypatch):
    """No fallback: asked for the kernels, the CPU raises and counts
    nothing."""
    monkeypatch.setattr(ba_ops, "_FORCE", "kernel")
    monkeypatch.setattr(sm_ops, "_FORCE", "kernel")
    before = (ba_ops.launches, dict(sm_ops.launches))
    with pytest.raises(ValueError, match="CUDA tensor"):
        ba_ops.fused_error(np.ones((3, 4)), device="cpu")
    x = np.ones((6, 4))
    with pytest.raises(ValueError, match="CUDA tensor"):
        sm_ops.gram_matvec(x, np.ones(4))
    with pytest.raises(ValueError, match="CUDA tensor"):
        sm_ops.gram_matvec_block(x, np.ones((4, 2)))
    with pytest.raises(ValueError, match="CUDA tensor"):
        sm_ops.gram_matvec_batch(np.ones((2, 6, 4)), np.ones((2, 4)))
    assert (ba_ops.launches, sm_ops.launches) == before


@pytest.mark.parametrize("R,B,bv", [(2184, 12, 1), (2184, 1, 1),
                                    (2184, 1, 8), (1000, 1, 8), (1, 1, 1),
                                    (7, 1, 1), (17, 3, 1), (5, 1, 4096),
                                    (100_000, 1, 1)])
@pytest.mark.parametrize("k", [30, 1000])
def test_gram_matvec_plan(R, B, bv, k):
    """The CUDA wrapper's plan covers every row, fits shared memory, keeps
    the partials that reach device memory within an eighth of X, and
    gives the card as many CTAs as X has bytes for."""
    sms = sm_k.H100_SMS
    p = sm_k.plan_gram(B, R, k, bv, sms)
    assert p == sm_k.plan_gram(B, R, k, bv, sms)
    strips = -(-R // p.rows)
    assert 1 <= p.rows <= R and (strips - 1) * p.rows < R
    assert 1 <= p.cluster <= (sm_k.MAX_CLUSTER_ONE if B * p.passes
                              * p.blocks == 1 else sm_k.MAX_CLUSTER)
    assert p.clusters == -(-strips // p.cluster)
    assert p.passes == -(-bv // sm_k.JB) and p.passes * p.blocks <= 65535
    assert p.blocks * sm_k.CPT * p.ct >= k > (p.blocks - 1) * sm_k.CPT * p.ct
    # shared memory: the ring within its budget, the CTA within 227 KB
    assert p.stages == 0 or 2 <= p.stages <= sm_k.MAX_STAGES
    # rows straight into registers only when two ring stages cannot fit
    assert p.stages > 0 or sm_k.smem_bytes(p.tile, 2, k, bv) > \
        sm_k.RING_BYTES
    assert 1 <= p.tile <= min(R, sm_k.MAX_TILE)
    if k > 32:      # the register tile holds every row of a ring stage
        assert p.tile <= sm_k.wide_rows(bv) * (sm_k.THREADS // p.ct)
    ring = 4 * p.stages * sm_k.slot_floats(p.tile, k)
    assert ring <= sm_k.MAX_SMEM_BYTES
    jbt = 1 if bv == 1 else sm_k.JB
    vs = jbt * k if k <= 32 or (jbt > 1 and jbt * k <= sm_k.MAX_VS_FLOATS) \
        else 0
    assert p.smem_bytes >= 4 * (vs + p.tile * jbt) + max(
        ring, 4 * jbt * sm_k.CPT * sm_k.THREADS)
    assert p.smem_bytes <= sm_k.MAX_SMEM_BYTES
    # partials in device memory only across clusters, and bounded
    if p.clusters == 1:
        assert p.partial_floats == 0 and p.tickets == 0
    else:
        assert p.partial_floats <= B * R * k // 8
        # the last CTA of a cluster rank sums its slice of every cluster
        slice_floats = (1 if bv == 1 else sm_k.JB) * sm_k.CPT * p.ct
        if 4 * B * R * k <= sm_k.BIG_BYTES_PER_SM * sms:
            assert (p.clusters * slice_floats // p.cluster
                    <= sm_k.FINAL_FLOATS)
        assert p.tickets == B * p.passes * p.blocks * p.cluster
    # the card filled as far as X allows (MIN_CTA_BYTES of X a CTA), up
    # to the strips lost to whole clusters
    units = B * p.passes * p.blocks
    by_bytes = -(-4 * R * k // sm_k.MIN_CTA_BYTES)
    assert p.ctas >= min(sms, min(by_bytes, R) * units) * 2 // 3
    assert p.ctas == p.clusters * p.cluster * units


from repro_torch.kernels.batched_alpha import kernel as ba_k


def _fused_error_reads(p, n, head):
    """How often the kernel reads each element of a row whose first
    16-byte aligned element is ``head`` floats in: the scalar head, the
    rounds of vpt vector loads a thread, the scalar tail."""
    seen = np.zeros(n, np.int64)
    t = np.arange(p.tpr)
    seen[t[t < head]] += 1
    nvec = (n - head) // 4
    for c in range(0, nvec, p.vpt * p.tpr):
        i = (c + t[:, None] + p.tpr * np.arange(p.vpt)[None, :]).ravel()
        for j in range(4):
            np.add.at(seen, head + 4 * i[i < nvec] + j, 1)
    tail = head + 4 * nvec
    seen[tail + t[t < n - tail]] += 1
    return seen


@pytest.mark.parametrize("trials", [1, 30, 132, 1000])
@pytest.mark.parametrize("n", [3, 2184, 2185])
def test_fused_error_plan(trials, n):
    """Every element of a row is read exactly once at any row offset,
    every row by one row group; threads and shared memory within the
    card's limits; a row that fits 16 loads a thread in one round."""
    _plan_is_pure(ba_k.plan_error, ["trials", "n", "sms"])
    sms = ba_k.H100_SMS
    p = ba_k.plan_error(trials, n, sms)
    assert p == ba_k.plan_error(trials, n, sms)
    assert p.vpt in ba_k.VPTS and p.tpr % 32 == 0 and p.rpc >= 1
    assert p.tpr * p.rpc <= ba_k.MAX_THREADS
    assert ba_k.SMEM_BYTES <= 48 * 1024
    assert (p.ctas - 1) * p.rpc < trials <= p.ctas * p.rpc
    for head in range(min(3, n) + 1):
        assert (_fused_error_reads(p, n, head) == 1).all()
    nv = -(-n // 4)
    assert p.rounds == -(-nv // (p.vpt * p.tpr))
    if nv <= ba_k.VPTS[-1] * ba_k.MAX_THREADS:
        assert p.rounds == 1
        assert p.tpr - 32 < -(-nv // p.vpt)  # no warp without a load
    # a row takes the threads its vectors can use, at any trial count
    assert p.tpr == ba_k.plan_error(1, n, sms).tpr
    if nv >= ba_k.MAX_THREADS:
        assert p.tpr >= 128 and p.rpc == 1


@pytest.mark.parametrize("trials,n,want", [
    (30, 2184, (4, 160, 1, 1)),      # the regime-2 campaign: a CTA a row
    (1000, 2184, (4, 160, 1, 1)),    # the throughput point: the same
    (1, 3, (1, 32, 1, 1)),
    (1, 20000, (16, 256, 1, 2))])    # past 16 loads a thread: two rounds
def test_fused_error_plan_regimes(trials, n, want):
    p = ba_k.plan_error(trials, n)
    assert (p.vpt, p.tpr, p.rpc, p.rounds) == want
    for head in range(4):
        assert (_fused_error_reads(p, n, head) == 1).all()


# ------------------------------------------ harness kernels on the card

CARD_BA_SHAPES = [(30, 2184), (1000, 2184), (1, 1), (7, 130), (33, 384),
                  (1000, 2185), (5, 3), (1, 3), (132, 2184), (30, 2185),
                  (1, 20000)]
CARD_SM_SHAPES = [(2184, 30), (2184, 1000), (1, 1), (7, 130), (33, 384),
                  (1000, 2185), (17, 384)]


@pytest.mark.cuda
@pytest.mark.parametrize("T,n", CARD_BA_SHAPES)
def test_fused_error_kernel_matches_plain_on_card(cuda, T, n):
    rng = np.random.default_rng(T + n)
    a = rng.normal(1.0, 0.2, size=(T, n))
    scale = float(rng.uniform(0.5, 1.5))
    t = torch.tensor(a, dtype=torch.float32, device=cuda)
    before = ba_ops.launches
    errs, s = ba_ops.fused_error(a, debias=False, device=cuda)
    assert ba_ops.launches == before + 1 and s == 1.0
    np.testing.assert_allclose(errs, ba_r.fused_error_np(a, 1.0),
                               rtol=2e-5, atol=2e-5)
    got = ba_k.fused_error(t, scale)
    torch.cuda.synchronize()
    np.testing.assert_allclose(_np(got), _np(ba_r.fused_error(t, scale)),
                               rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(_np(got), ba_r.fused_error_np(a, scale),
                               rtol=2e-5, atol=2e-5)
    # an unaligned row start: the kernel reads the head as scalars
    if n > 1:
        u = t[:, 1:]
        np.testing.assert_allclose(
            _np(ba_k.fused_error(u.contiguous(), scale)),
            ba_r.fused_error_np(a[:, 1:], scale), rtol=2e-5, atol=2e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("T,n", [(30, 2184), (1000, 2184), (1, 3),
                                 (132, 2185), (1, 20000)])
def test_fused_error_kernel_repeats_in_graphs_on_card(cuda, T, n):
    """The plan's fixed order: two launches, a CUDA-graph replay and 20
    launches back to back give the same bits."""
    rng = np.random.default_rng(T * 3 + n)
    t = torch.tensor(rng.normal(1.0, 0.2, size=(T, n)), dtype=torch.float32,
                     device=cuda)
    fn = lambda: ba_k.fused_error(t, 1.1)  # noqa: E731
    out = fn()
    torch.cuda.synchronize()
    np.testing.assert_allclose(_np(out), _np(ba_r.fused_error(t, 1.1)),
                               rtol=2e-5, atol=2e-5)
    _repeat_graph_and_burst(fn, out)


@pytest.mark.cuda
@pytest.mark.parametrize("R,k", CARD_SM_SHAPES)
@pytest.mark.parametrize("bv", [0, 8])
def test_gram_matvec_kernel_matches_plain_on_card(cuda, R, k, bv):
    rng = np.random.default_rng(R + k + bv)
    x = rng.normal(size=(R, k))
    V = rng.normal(size=(k, bv)) if bv else rng.normal(size=k)
    xs = sm_ops.prepare_operand(x, cuda)
    assert sm_ops.uses_kernel(cuda) and xs.dtype == torch.float32
    entry = "gram_matvec_block" if bv else "gram_matvec"
    before = sm_ops.launches[entry]
    got = (sm_ops.gram_matvec_block(xs, V) if bv
           else sm_ops.gram_matvec(xs, V))
    assert sm_ops.launches[entry] == before + 1
    _scaled_close(got, sm_r.gram_matvec_block_np(x, V) if bv
                  else sm_r.gram_matvec_np(x, V))
    vt = torch.tensor(V.T if bv else V, dtype=torch.float32, device=cuda)
    k1 = sm_k.gram_matvec(xs, vt.contiguous())
    k2 = sm_k.gram_matvec(xs, vt.contiguous())
    plain = sm_r.gram_matvec(xs, vt)
    torch.cuda.synchronize()
    assert torch.equal(k1, k2)   # no atomics: the same bits every run
    _scaled_close(_np(k1), _np(plain).astype(np.float64))


@pytest.mark.cuda
@pytest.mark.parametrize("B,R,k", [(12, 2184, 30), (3, 17, 384), (1, 1, 1),
                                   (5, 100, 30), (2, 1000, 2185)])
def test_gram_matvec_batch_kernel_matches_plain_on_card(cuda, B, R, k):
    rng = np.random.default_rng(B + R + k)
    x, v = rng.normal(size=(B, R, k)), rng.normal(size=(B, k))
    xs = sm_ops.prepare_operand(x, cuda)
    before = sm_ops.launches["gram_matvec_batch"]
    got = sm_ops.gram_matvec_batch(xs, v)
    assert sm_ops.launches["gram_matvec_batch"] == before + 1
    _scaled_close(got, sm_r.gram_matvec_batch_np(x, v))
    vt = torch.tensor(v, dtype=torch.float32, device=cuda)
    k1 = sm_k.gram_matvec_batch(xs, vt)
    plain = sm_r.gram_matvec_batch(xs, vt)
    torch.cuda.synchronize()
    assert torch.equal(k1, sm_k.gram_matvec_batch(xs, vt))
    _scaled_close(_np(k1), _np(plain).astype(np.float64))


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 30, 31, 1000])
@pytest.mark.parametrize("bv", [1, 7, 8, 9, 16])
@pytest.mark.parametrize("B", [1, 12])
def test_gram_kernel_rhs_and_widths_on_card(cuda, k, bv, B):
    """One launch per call over B slices and bv right-hand sides (passes
    of 8), against the float64 oracle and the plain version, repeated
    bit for bit, inside a CUDA graph and 20 times back to back."""
    R = 2184
    rng = np.random.default_rng(k * 100 + bv + B)
    x, V = rng.normal(size=(B, R, k)), rng.normal(size=(B, bv, k))
    xs = torch.tensor(x, dtype=torch.float32, device=cuda)
    vt = torch.tensor(V, dtype=torch.float32, device=cuda)
    fn = lambda: sm_k._gram(xs, vt)  # noqa: E731
    out = fn()
    torch.cuda.synchronize()
    assert out.shape == (B, bv, k)
    for b in range(B):
        _scaled_close(_np(out[b]).T, sm_r.gram_matvec_block_np(x[b],
                                                                V[b].T))
        _scaled_close(_np(out[b]), _np(sm_r.gram_matvec(
            xs[b], vt[b])).astype(np.float64))
    _repeat_graph_and_burst(fn, out)
