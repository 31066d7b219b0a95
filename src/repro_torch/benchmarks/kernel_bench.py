"""Kernel bench-and-tolerance registry: every hand kernel, at its path
shapes, against its plain version, a library call and its bound.

Port of ``benchmarks/kernel_bench.py``. One ``KernelSpec`` per row:
the entry point it measures (K1-K7b, the eight ``pl.pallas_call`` sites
of the reference, ``replaces`` names each by file and line), a case
maker and the registered tolerance. ``run_specs`` builds each case on
the device and

* on the card: holds the kernel (through its ``ops`` wrapper, or its
  ``kernel`` binding where the wrapper takes host arrays) against its
  plain PyTorch version at the tolerance, then times the kernel, the
  plain version and the library call where one PyTorch call computes
  the same function (``F.rms_norm``, SDPA, ``torch.mv``,
  ``x.T @ (x @ v)``, K4's one-row ``torch.mul``) with
  ``launch.timing.graph_ms`` (CUDA-graph replays once the clock has
  risen), and one PyTorch call that moves the same bytes where the row
  has one (``copy_ms``: K4's int8-to-float32 copy of its one row, K5's
  output written alone), and reports the bound -- bytes
  over 3.35 TB/s or operations over the dtype's peak, the larger --
  and the kernel's share of it;
* on the CPU: holds the plain version against a float64 oracle and
  times it on the host clock, as the reference times its refs. No card
  figure comes out of a CPU run: ``ms``, ``library_ms`` and the bound
  share are None there.

The card runs the path shapes of ``PERF.md`` section 6; the CPU the
reference bench's fast sizes. The last row is the batched-alpha
engine: alpha* of 256 masks over a 4-regular graph on 256 vertices (m =
512), the torch propagator on the device against NumPy, bit for bit.
Rows print as the reference's ``name,us_per_call,derived`` CSV.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.launch import roofline

Thunk = Callable[[], object]


@dataclasses.dataclass
class Case:
    """One kernel call, built on a device: the thunks to compare and
    time, and what the call must move and compute."""
    shape: str
    dtype: str
    kernel: Thunk                 # the hand kernel (card) / its wrapper
    plain: Thunk                  # the plain PyTorch version
    oracle: Thunk                 # float64 reference (the CPU check)
    library: Optional[Thunk]      # one PyTorch call, or None
    nbytes: int                   # inputs read once, outputs written once
    flops: int
    scaled: bool = False          # compare after dividing by max(1, |ref|)
    copy: Optional[Thunk] = None  # one PyTorch call moving the same bytes


@dataclasses.dataclass(frozen=True)
class KernelSpec:
    name: str
    entry: str                    # K1 .. K7b, or "engine"
    replaces: Optional[str]       # file:line of the reference's pallas_call
    make: Callable[[torch.device], Case]
    rtol: float = 1e-5
    atol: float = 1e-6
    reps: int = 20


def _gen(dev, seed):
    return torch.Generator(device=dev).manual_seed(seed)


def _card(dev) -> bool:
    return dev.type == "cuda"


# ---- K1 rmsnorm -------------------------------------------------------------

def _mk_rmsnorm(card_shape, cpu_shape):
    def make(dev):
        from repro_torch.kernels.rmsnorm import ops, ref
        shape, dt = ((card_shape, torch.bfloat16) if _card(dev)
                     else (cpu_shape, torch.float32))
        g = _gen(dev, 1)
        d = shape[-1]
        x = torch.randn(shape, generator=g, device=dev).to(dt)
        scale = torch.randn(d, generator=g, device=dev)
        scale_lib = scale.to(dt)
        rows = x.numel() // d
        return Case(
            shape=str(tuple(shape)), dtype=str(dt).split(".")[-1],
            kernel=lambda: ops.rmsnorm(x, scale),
            plain=lambda: ref.rmsnorm(x, scale),
            oracle=lambda: ref.rmsnorm(x.double(), scale.double()),
            library=lambda: F.rms_norm(x, (d,), scale_lib, 1e-6),
            nbytes=2 * x.numel() * x.element_size() + 4 * d,
            flops=4 * rows * d)
    return make


# ---- K2 decode_attention ----------------------------------------------------

def _mk_decode_attention(card_S, cpu_S, ragged: bool):
    def make(dev):
        from repro_torch.kernels.decode_attention import ops, ref
        B, H, KVH, Dh = 8, 32, 8, 128
        S, dt = ((card_S, torch.bfloat16) if _card(dev)
                 else (cpu_S, torch.float32))
        g = _gen(dev, 2)
        q = torch.randn(B, H, Dh, generator=g, device=dev).to(dt)
        k = torch.randn(B, S, KVH, Dh, generator=g, device=dev).to(dt)
        v = torch.randn(B, S, KVH, Dh, generator=g, device=dev).to(dt)
        lengths = (np.random.default_rng(0).integers(1, S + 1, B)
                   if ragged else np.full(B, S))
        lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
        mask = (torch.arange(S, device=dev)[None, :] < lens[:, None])
        mask = mask[:, None, None, :]
        q4, k4, v4 = q[:, :, None], k.transpose(1, 2), v.transpose(1, 2)
        used = int(lengths.sum())
        esz = q.element_size()
        return Case(
            shape=f"B={B} H={H} KVH={KVH} S={S} Dh={Dh}"
                  + (" ragged" if ragged else " full"),
            dtype=str(dt).split(".")[-1],
            kernel=lambda: ops.decode_attention(q, k, v, lens),
            plain=lambda: ref.decode_attention(q, k, v, lens),
            oracle=lambda: ref.decode_attention(q.double(), k.double(),
                                                v.double(), lens),
            library=lambda: F.scaled_dot_product_attention(
                q4, k4, v4, attn_mask=mask, enable_gqa=True)[:, :, 0],
            nbytes=(2 * used * KVH * Dh + 2 * B * H * Dh) * esz + 4 * B,
            flops=4 * used * H * Dh)
    return make


# ---- K3-K5 the combines -----------------------------------------------------

COMBINE_ROWS = 4
COMBINE_D = 104_857_600       # the stacked wi_gate leaf of granite-3-8b
COMBINE_D_CPU = 1 << 20


def _mk_combine(kind, n=COMBINE_ROWS):
    def make(dev):
        from repro_torch.kernels.coded_combine import ops, ref
        d = COMBINE_D if _card(dev) else COMBINE_D_CPU
        g = _gen(dev, 7)
        w = torch.rand(n, generator=g, device=dev) * 2
        o, copy = torch.empty(d, device=dev), None
        if n > 1:
            w[n // 2] = 0.0                   # a straggler's zero weight
        scales = torch.rand(n, generator=g, device=dev) + 0.01
        if kind == "coded_combine":
            x = torch.randn(n, d, generator=g, device=dev)
            args, dtype = (x, w), "float32"
            oracle = lambda: (w.double()[:, None]  # noqa: E731
                              * x.double()).sum(0)
            library = lambda: torch.mv(x.t(), w)  # noqa: E731
        elif kind == "quantized_combine":
            x = torch.randint(-127, 128, (n, d), generator=g, device=dev,
                              dtype=torch.int8)
            args, dtype, library = (x, scales, w), "int8", None
            if n == 1:   # an int8 row times a 0-dim float32: u * q
                u0 = w[0] * scales[0]
                library = lambda: torch.mul(x[0], u0)  # noqa: E731
                # ... and the int8-to-float32 copy of that row
                copy = lambda: o.copy_(x[0])  # noqa: E731
            oracle = lambda: torch.from_numpy(  # noqa: E731
                ref.quantized_combine_np(*(a.cpu().numpy() for a in args)))
        else:
            x = torch.randint(0, 256, (n, (d + 7) // 8), generator=g,
                              device=dev, dtype=torch.uint8)
            args, dtype, library = (x, scales, w, d), "uint8", None
            copy = o.zero_            # the output written alone
            oracle = lambda: torch.from_numpy(  # noqa: E731
                ref.packed_sign_combine_np(x.cpu().numpy(),
                                           scales.cpu().numpy(),
                                           w.cpu().numpy(), d))
        fn, plain = getattr(ops, kind), getattr(ref, kind)
        return Case(
            shape=f"({n}, {x.shape[1]})", dtype=dtype,
            kernel=lambda: fn(*args), plain=lambda: plain(*args),
            oracle=oracle, library=library,
            nbytes=x.numel() * x.element_size() + 4 * d + 8 * n,
            flops=2 * n * d, copy=copy)
    return make


# ---- K6 fused_error ---------------------------------------------------------

def _mk_fused_error(T, n):
    def make(dev):
        from repro_torch.kernels.batched_alpha import kernel, ref
        rng = np.random.default_rng(T * 7 + n)
        a = rng.normal(1.0, 0.2, size=(T, n))
        scale = float(rng.uniform(0.5, 1.5))
        t = torch.tensor(a, dtype=torch.float32, device=dev)
        return Case(
            shape=f"({T}, {n})", dtype="float32",
            kernel=lambda: kernel.fused_error(t, scale),
            plain=lambda: ref.fused_error(t, scale),
            oracle=lambda: torch.from_numpy(ref.fused_error_np(a, scale)),
            library=None, nbytes=4 * (T * n + T), flops=3 * T * n)
    return make


# ---- K7 gram_matvec / gram_matvec_batch -------------------------------------

def _mk_gram(R, k):
    def make(dev):
        from repro_torch.kernels.spectral_matvec import kernel, ref
        rng = np.random.default_rng(R + 3 * k)
        x, v = rng.normal(size=(R, k)), rng.normal(size=k)
        xs = torch.tensor(x, dtype=torch.float32, device=dev)
        vt = torch.tensor(v, dtype=torch.float32, device=dev)
        return Case(
            shape=f"({R}, {k}) 1-D v", dtype="float32",
            kernel=lambda: kernel.gram_matvec(xs, vt),
            plain=lambda: ref.gram_matvec(xs, vt),
            oracle=lambda: torch.from_numpy(ref.gram_matvec_np(x, v)),
            library=lambda: xs.T @ (xs @ vt),
            nbytes=4 * (R * k + 2 * k), flops=4 * R * k, scaled=True)
    return make


def _mk_gram_batch(B, R, k):
    def make(dev):
        from repro_torch.kernels.spectral_matvec import kernel, ref
        rng = np.random.default_rng(B + R + k)
        x, v = rng.normal(size=(B, R, k)), rng.normal(size=(B, k))
        xs = torch.tensor(x, dtype=torch.float32, device=dev)
        vt = torch.tensor(v, dtype=torch.float32, device=dev)
        return Case(
            shape=f"({B}, {R}, {k})", dtype="float32",
            kernel=lambda: kernel.gram_matvec_batch(xs, vt),
            plain=lambda: ref.gram_matvec_batch(xs, vt),
            oracle=lambda: torch.from_numpy(
                ref.gram_matvec_batch_np(x, v)),
            library=lambda: (xs.transpose(1, 2) @ (xs @ vt[:, :, None])
                             )[:, :, 0],
            nbytes=4 * (B * R * k + 2 * B * k), flops=4 * B * R * k,
            scaled=True)
    return make


# ---- the batched-alpha engine -----------------------------------------------

def _mk_alpha_engine(dev):
    from repro_torch.core.batched_decoding import batched_optimal_alpha_graph
    from repro_torch.core.graphs import random_regular_graph
    g = random_regular_graph(256, 4, seed=0)           # m = 512 machines
    masks = np.random.default_rng(1).random((256, 512)) >= 0.2

    def engine(backend):
        return lambda: torch.from_numpy(batched_optimal_alpha_graph(
            g, masks, backend=backend, device=dev))
    return Case(shape="256 masks, m=512", dtype="float64",
                kernel=engine("torch"), plain=engine("numpy"),
                oracle=engine("numpy"), library=None, nbytes=0, flops=0)


KERNEL_FILES = "src/repro/kernels/"
# Tolerances: the reference bench's and test suite's -- bf16 3e-2 (the
# repository's bf16 tolerance), the combines rtol 2e-5 / atol 1e-3 (the
# reference bench's quantized-combine registration), K6 2e-5, K7 an
# absolute 5e-6 after scaling by max(1, max|ref|).
REGISTRY: List[KernelSpec] = [
    KernelSpec("rmsnorm_decode", "K1", KERNEL_FILES + "rmsnorm/kernel.py:54",
               _mk_rmsnorm((8, 1, 4096), (8, 1, 4096)),
               rtol=3e-2, atol=3e-2),
    KernelSpec("rmsnorm_rows", "K1", KERNEL_FILES + "rmsnorm/kernel.py:54",
               _mk_rmsnorm((8192, 4096), (2048, 1024)),
               rtol=3e-2, atol=3e-2),
    KernelSpec("decode_attention_pool", "K2",
               KERNEL_FILES + "decode_attention/kernel.py:90",
               _mk_decode_attention(1024, 256, ragged=True),
               rtol=3e-2, atol=3e-2),
    KernelSpec("decode_attention_32k", "K2",
               KERNEL_FILES + "decode_attention/kernel.py:90",
               _mk_decode_attention(32768, 2048, ragged=False),
               rtol=3e-2, atol=3e-2, reps=4),
    KernelSpec("coded_combine", "K3",
               KERNEL_FILES + "coded_combine/kernel.py:183",
               _mk_combine("coded_combine"), rtol=2e-5, atol=1e-3, reps=4),
    KernelSpec("quantized_combine_int8", "K4",
               KERNEL_FILES + "coded_combine/kernel.py:91",
               _mk_combine("quantized_combine"), rtol=2e-5, atol=1e-3,
               reps=4),
    KernelSpec("packed_sign_combine", "K5",
               KERNEL_FILES + "coded_combine/kernel.py:158",
               _mk_combine("packed_sign_combine"), rtol=2e-5, atol=1e-3,
               reps=4),
    # one row a rank: the streaming combine's chunk of 1, or W = m ranks
    KernelSpec("quantized_combine_int8_row", "K4",
               KERNEL_FILES + "coded_combine/kernel.py:91",
               _mk_combine("quantized_combine", 1), rtol=2e-5, atol=1e-3,
               reps=4),
    KernelSpec("packed_sign_combine_row", "K5",
               KERNEL_FILES + "coded_combine/kernel.py:158",
               _mk_combine("packed_sign_combine", 1), rtol=2e-5, atol=1e-3,
               reps=4),
    KernelSpec("fused_error_campaign", "K6",
               KERNEL_FILES + "batched_alpha/kernel.py:58",
               _mk_fused_error(30, 2184), rtol=2e-5, atol=2e-5),
    KernelSpec("fused_error_1000", "K6",
               KERNEL_FILES + "batched_alpha/kernel.py:58",
               _mk_fused_error(1000, 2184), rtol=2e-5, atol=2e-5),
    KernelSpec("gram_matvec_lanczos", "K7a",
               KERNEL_FILES + "spectral_matvec/kernel.py:75",
               _mk_gram(2184, 30), rtol=0.0, atol=5e-6),
    KernelSpec("gram_matvec_1000", "K7a",
               KERNEL_FILES + "spectral_matvec/kernel.py:75",
               _mk_gram(2184, 1000), rtol=0.0, atol=5e-6),
    KernelSpec("gram_matvec_batch", "K7b",
               KERNEL_FILES + "spectral_matvec/kernel.py:127",
               _mk_gram_batch(12, 2184, 30), rtol=0.0, atol=5e-6),
    KernelSpec("batched_alpha_engine", "engine", None, _mk_alpha_engine,
               rtol=0.0, atol=0.0, reps=3),
]


def _err(got, want, scaled: bool) -> float:
    got, want = torch.as_tensor(got).double().cpu(), \
        torch.as_tensor(want).double().cpu()
    err = float((got - want).abs().max())
    if scaled:
        err /= max(1.0, float(want.abs().max()))
    return err


def _check(spec: KernelSpec, case: Case, got, want) -> float:
    err = _err(got, want, case.scaled)
    if case.scaled:
        ok = err <= spec.atol
    else:
        ok = torch.allclose(torch.as_tensor(got).double().cpu(),
                            torch.as_tensor(want).double().cpu(),
                            rtol=spec.rtol, atol=spec.atol)
    if not ok:
        raise AssertionError(f"{spec.name} {case.shape}: max abs err "
                             f"{err} beyond rtol={spec.rtol} "
                             f"atol={spec.atol}")
    return err


def _host_us(fn: Thunk, reps: int) -> float:
    fn()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) / reps * 1e6


def run_spec(spec: KernelSpec, dev: torch.device) -> dict:
    case = spec.make(dev)
    card = _card(dev)
    row = {"name": spec.name, "entry": spec.entry,
           "replaces": spec.replaces, "shape": case.shape,
           "dtype": case.dtype, "rtol": spec.rtol, "atol": spec.atol}
    if spec.entry == "engine":   # host code around the torch propagator
        got, want = case.kernel(), case.plain()
        if not torch.equal(got, want):
            raise AssertionError("batched_alpha_engine: the torch "
                                 "propagator differs from NumPy")
        us, plain_us = (_host_us(case.kernel, spec.reps),
                        _host_us(case.plain, spec.reps))
        row.update(max_abs_err=0.0, us_per_call=us, plain_us=plain_us,
                   ms=None, plain_ms=None, library_ms=None, copy_ms=None,
                   bound_ms=None, bound_by=None, bound_share=None,
                   derived=f"{256 / (us / 1e6):.0f}trials/s")
        return row
    t_bytes = case.nbytes / roofline.HBM_BW * 1e3
    t_ops = case.flops / roofline.PEAK_FLOPS.get(case.dtype,
                                                 roofline.PEAK_FLOPS[
                                                     "float32"]) * 1e3
    bound, by = (t_bytes, "bytes") if t_bytes >= t_ops else \
        (t_ops, "operations")
    if card:
        from repro_torch.launch.timing import graph_ms
        got, want = case.kernel(), case.plain()
        torch.cuda.synchronize(dev)
        err = _check(spec, case, got, want)
        del got, want
        ms = graph_ms(case.kernel, reps=spec.reps)
        row.update(max_abs_err=err, ms=ms,
                   plain_ms=graph_ms(case.plain, reps=spec.reps),
                   library_ms=(None if case.library is None
                               else graph_ms(case.library, reps=spec.reps)),
                   copy_ms=(None if case.copy is None
                            else graph_ms(case.copy, reps=spec.reps)),
                   us_per_call=ms * 1e3, bound_ms=bound, bound_by=by,
                   bound_share=bound / ms,
                   derived=f"{100 * bound / ms:.1f}% of bound")
    else:
        err = _check(spec, case, case.plain(), case.oracle())
        us = _host_us(case.plain, min(spec.reps, 5))
        row.update(max_abs_err=err, ms=None, plain_ms=None,
                   library_ms=None, copy_ms=None, us_per_call=us, plain_us=us,
                   bound_ms=None, bound_by=None, bound_share=None,
                   derived=f"{case.nbytes / 1e9 / (us / 1e6):.1f}GB/s "
                           "(plain, host)")
    return row


def run_specs(specs: Sequence[KernelSpec], dev: torch.device) -> List[dict]:
    rows = []
    for spec in specs:
        rows.append(run_spec(spec, dev))
        if _card(dev):
            torch.cuda.empty_cache()
    return rows


def main(dev: torch.device) -> dict:
    """Every registered row on ``dev``; prints the CSV and returns the
    report (no fast mode: the path shapes are the point)."""
    rows = run_specs(REGISTRY, dev)
    for r in rows:
        print(f"{r['name']},{r['us_per_call']:.2f},{r['derived']}")
    return {"rows": rows,
            "entries": sorted({s.entry for s in REGISTRY} - {"engine"})}
