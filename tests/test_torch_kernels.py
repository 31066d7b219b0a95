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
"""

import types

import numpy as np
import pytest
import torch

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


# ------------------------------------------------------ on the card

@pytest.mark.cuda
@pytest.mark.parametrize("shape", RMS_SHAPES + [(8, 1, 4096), (33, 130)])
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
