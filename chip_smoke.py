#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA GPU and
check it: the quickest proof that the port builds and serves on the card.

    python3 chip_smoke.py          # from the repository root

Phases, in order; any failure raises and the script exits non-zero:

1. Environment: the card's name and power limit (``nvidia-smi``), the
   torch and CUDA versions, and the float32 matmul setting (TF32 off).
2. Build: both CUDA kernels from ``src/repro_torch/kernels/*/csrc`` with
   nvcc for sm_90a, into the git-ignored build directory.
3. Kernels: each kernel against its plain PyTorch version on the card,
   in the working dtype, at the serving path's shapes and a few more,
   with the repository's tolerances (bf16 atol = rtol = 3e-2, f32 2e-5);
   kernel, plain and library-call device times (CUDA-graph replays
   between CUDA events), the wrapper's per-call time, and the least
   time the card could take (bytes over 3.35 TB/s, or operations over
   the peak rate of the inputs' type, whichever is larger).
4. The serving path: ``repro_torch.launch.serve.main`` at granite-3-8b's
   full config (40 layers, d_model 4096, GQA 32/8), 16 requests on 8
   slots, coded prefill over the expander, ``--check`` against the
   sequential reference loop. Kernel launch counts are zeroed just before
   and read just after; they must equal 81 and 40 per pool step. Then
   coded at p=0 and uncoded must produce equal streams. Then a few
   teacher-forced decode steps through the kernels and through the plain
   versions: equal to 1e-3 in float32, and in bf16 no farther from the
   float32 logits than twice the plain version's bf16 error.
5. A ``kernels`` JSON line, then the card line, then the result line.
"""

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12          # H100 SXM, NVIDIA's data sheet
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}   # dense, same sheet
TOL = {"bfloat16": dict(atol=3e-2, rtol=3e-2),
       "float32": dict(atol=2e-5, rtol=2e-5)}
F32_MODEL_TOL = dict(atol=1e-3, rtol=1e-3)   # f32 logits after 40 layers
BF16_NOISE_FACTOR = 2.0
SERVE_ARGS = ["--arch", "granite-3-8b", "--full-config", "--requests",
              "16", "--slots", "8", "--prompt-len", "128",
              "--prompt-spread", "32", "--max-new-tokens", "32",
              "--max-len", "1024", "--replicas", "8", "--seed", "0"]


def _say(tag, **kw):
    print(f"{tag} {json.dumps(kw)}", flush=True)


def _times(torch, kernel, plain, library):
    """Device ms per call of each (CUDA-graph replays), and the wrapper's
    host ms per call of the kernel."""
    from repro_torch.launch.timing import call_ms, graph_ms
    return dict(kernel_ms=graph_ms(kernel), plain_ms=graph_ms(plain),
                library_ms=graph_ms(library), kernel_call_ms=call_ms(kernel))


def _bound_ms(nbytes, flops, dtype):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _compare(torch, got, want, tol, what):
    err = (got.float() - want.float()).abs().max().item()
    if not torch.allclose(got.float(), want.float(), **tol):
        raise AssertionError(f"{what}: kernel disagrees with its plain "
                             f"version (max abs err {err}, tol {tol})")
    return err


def check_rmsnorm(torch, dev, rows_shape, dtype, label):
    import torch.nn.functional as F
    from repro_torch.kernels.rmsnorm import ops, ref
    g = torch.Generator(device=dev).manual_seed(1)
    dt = getattr(torch, dtype)
    d = rows_shape[-1]
    x = torch.randn(rows_shape, generator=g, device=dev).to(dt)
    scale = torch.randn(d, generator=g, device=dev)
    out = ops.rmsnorm(x, scale, 1e-6)
    want = ref.rmsnorm(x, scale, 1e-6)
    torch.cuda.synchronize()
    err = _compare(torch, out, want, TOL[dtype], f"rmsnorm {label}")
    rows = x.numel() // d
    nbytes = 2 * x.numel() * x.element_size() + scale.numel() * 4
    bound, by = _bound_ms(nbytes, 4 * rows * d, dtype)
    scale_lib = scale.to(dt)
    row = dict(kernel="rmsnorm", shape=label, dtype=dtype,
               max_abs_err=err, bound_ms=bound, bound_by=by,
               **_times(torch, lambda: ops.rmsnorm(x, scale),
                        lambda: ref.rmsnorm(x, scale),
                        lambda: F.rms_norm(x, (d,), scale_lib, 1e-6)))
    _say("kernel", **row)
    return row


def check_decode_attention(torch, dev, B, H, KVH, S, Dh, dtype, lengths,
                           label):
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attention import ops, ref
    g = torch.Generator(device=dev).manual_seed(2)
    dt = getattr(torch, dtype)
    q = torch.randn(B, H, Dh, generator=g, device=dev).to(dt)
    k = torch.randn(B, S, KVH, Dh, generator=g, device=dev).to(dt)
    v = torch.randn(B, S, KVH, Dh, generator=g, device=dev).to(dt)
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    out = ops.decode_attention(q, k, v, lens)
    want = ref.decode_attention(q, k, v, lens)
    torch.cuda.synchronize()
    err = _compare(torch, out, want, TOL[dtype],
                   f"decode_attention {label}")
    used = int(sum(min(int(n), S) for n in lengths))
    esz = q.element_size()
    nbytes = (2 * used * KVH * Dh + 2 * B * H * Dh) * esz + 4 * B
    bound, by = _bound_ms(nbytes, 4 * used * (H // KVH) * KVH * Dh, dtype)
    # library yardstick: SDPA over the same cache with a length mask
    mask = (torch.arange(S, device=dev)[None, :] < lens[:, None])
    mask = mask[:, None, None, :]
    q4, k4, v4 = q[:, :, None], k.transpose(1, 2), v.transpose(1, 2)
    row = dict(kernel="decode_attention", shape=label, dtype=dtype,
               max_abs_err=err, bound_ms=bound, bound_by=by,
               **_times(torch, lambda: ops.decode_attention(q, k, v, lens),
                        lambda: ref.decode_attention(q, k, v, lens),
                        lambda: F.scaled_dot_product_attention(
                            q4, k4, v4, attn_mask=mask, enable_gqa=True)))
    _say("kernel", **row)
    return row


def check_beyond_length(torch, dev):
    """Values past lengths[b] must not change the kernel's output."""
    from repro_torch.kernels.decode_attention import ops
    g = torch.Generator(device=dev).manual_seed(3)
    B, H, KVH, S, Dh = 2, 32, 8, 256, 128
    q = torch.randn(B, H, Dh, generator=g, device=dev).to(torch.bfloat16)
    k = torch.randn(B, S, KVH, Dh, generator=g, device=dev).to(q.dtype)
    v = torch.randn(B, S, KVH, Dh, generator=g, device=dev).to(q.dtype)
    lens = torch.tensor([40, 177], dtype=torch.int32, device=dev)
    out1 = ops.decode_attention(q, k, v, lens)
    k2, v2 = k.clone(), v.clone()
    for b, n in enumerate((40, 177)):
        k2[b, n:] = 999.0
        v2[b, n:] = -999.0
    out2 = ops.decode_attention(q, k2, v2, lens)
    torch.cuda.synchronize()
    if not torch.equal(out1, out2):
        raise AssertionError("decode_attention reads past lengths[b]")
    _say("kernel_check", name="decode_attention ignores values beyond "
         "lengths[b]", ok=True)


def teacher_forced(torch, dev, steps=4):
    """granite-3-8b decode steps through the kernels and through the plain
    versions (``_FORCE = "ref"``), on the card, from the same parameters
    and tokens.

    float32 (kernels' f32 build, weights and activations in f32): logits
    must agree to ``F32_MODEL_TOL``. bfloat16 (the serving dtype): 40
    layers carry each bf16 rounding flip (one ulp = 2^-8 relative) into
    the logits, so both bf16 paths are held against the float32 plain
    logits, and the kernels' error must stay within twice the plain
    version's own -- the kernels add no error beyond bf16 arithmetic's.
    """
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.kernels.decode_attention import ops as da_ops
    from repro_torch.kernels.rmsnorm import ops as rn_ops
    from repro_torch.models import model as M
    cfg = get_config("granite-3-8b")
    cfg32 = cfg.with_overrides(dtype="float32")
    params32 = M.init_params(cfg, seed=7, device=dev)
    params16 = M.cast_block_weights(params32, cfg)
    toks = np.random.default_rng(7).integers(0, cfg.vocab_size,
                                             (steps, 8))

    def run(c, params, force):
        rn_ops._FORCE = da_ops._FORCE = force
        try:
            cache = M.init_decode_cache(c, 8, 64, device=dev)
            out = []
            with torch.no_grad():
                for t in range(steps):
                    logits, cache = M.decode_step(
                        params, torch.from_numpy(toks[t]).to(dev), cache,
                        c)
                    out.append(logits)
        finally:
            rn_ops._FORCE = da_ops._FORCE = None
        out = torch.stack(out)
        if not torch.isfinite(out).all():
            raise AssertionError("non-finite teacher-forced logits")
        return out

    k32, p32 = run(cfg32, params32, None), run(cfg32, params32, "ref")
    err32 = (k32 - p32).abs().max().item()
    if not torch.allclose(k32, p32, **F32_MODEL_TOL):
        raise AssertionError(f"float32 teacher-forced logits: kernels vs "
                             f"plain differ by {err32} ({F32_MODEL_TOL})")
    k16, p16 = run(cfg, params16, None), run(cfg, params16, "ref")
    err_k = (k16 - p32).abs().max().item()
    err_p = (p16 - p32).abs().max().item()
    if not err_k <= BF16_NOISE_FACTOR * err_p:
        raise AssertionError(
            f"bf16 teacher-forced logits: kernels are {err_k} from the "
            f"float32 logits, more than {BF16_NOISE_FACTOR} x the plain "
            f"bf16 version's {err_p}")
    _say("teacher_forced", arch=cfg.name, steps=steps, batch=8,
         f32_kernel_vs_plain=err32, f32_tol=F32_MODEL_TOL,
         bf16_kernel_vs_f32=err_k, bf16_plain_vs_f32=err_p,
         bf16_kernel_vs_plain=(k16 - p16).abs().max().item(),
         bf16_factor=BF16_NOISE_FACTOR,
         max_abs_logit=p32.abs().max().item(),
         greedy_agreement_bf16=(k16.argmax(-1) == p16.argmax(-1))
         .float().mean().item())


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this "
              "script runs only on an NVIDIA GPU", file=sys.stderr)
        return 2
    src = os.path.join(ROOT, "src")
    if not os.path.isdir(os.path.join(src, "repro_torch")):
        print(f"chip_smoke: no src/repro_torch beside {__file__}; run it "
              "from the repository root", file=sys.stderr)
        return 2
    sys.path.insert(0, src)
    from repro_torch import device as device_mod
    from repro_torch.kernels import build
    from repro_torch.kernels.decode_attention import ops as da_ops
    from repro_torch.kernels.rmsnorm import ops as rn_ops
    from repro_torch.launch import serve as launch_serve

    dev = device_mod.resolve("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    _say("env", card=card, torch=torch.__version__,
         cuda=torch.version.cuda, device=torch.cuda.get_device_name(0),
         allow_tf32=torch.backends.cuda.matmul.allow_tf32,
         cudnn_allow_tf32=torch.backends.cudnn.allow_tf32)

    t0 = time.perf_counter()
    per = build.build()
    _say("build", seconds=time.perf_counter() - t0, per_source=per,
         arch="sm_90a", directory=os.path.relpath(build.BUILD_DIR, ROOT))
    for name in build.SOURCES:
        _say("ptxas", name=name,
             report=build.compiler_report(name).splitlines())

    import numpy as np
    rng = np.random.default_rng(0)
    rows = {"rmsnorm": check_rmsnorm(torch, dev, (8, 1, 4096), "bfloat16",
                                     "path (8,1,4096)")}
    check_rmsnorm(torch, dev, (8192, 4096), "bfloat16", "(8192,4096)")
    check_rmsnorm(torch, dev, (8, 1, 4096), "float32", "(8,1,4096) f32")
    rows["decode_attention"] = check_decode_attention(
        torch, dev, 8, 32, 8, 1024, 128, "bfloat16",
        rng.integers(1, 1025, 8).tolist(),
        "path B=8 H=32 KVH=8 S=1024 Dh=128 ragged")
    check_decode_attention(torch, dev, 8, 32, 8, 32768, 128, "bfloat16",
                           [32768] * 8, "decode_32k B=8 S=32768 full")
    check_decode_attention(torch, dev, 8, 20, 20, 1024, 128, "bfloat16",
                           rng.integers(1, 1025, 8).tolist(),
                           "G=1 B=8 H=KVH=20 S=1024")
    check_decode_attention(torch, dev, 8, 32, 8, 1024, 128, "float32",
                           rng.integers(1, 1025, 8).tolist(),
                           "B=8 H=32 KVH=8 S=1024 f32")
    check_beyond_length(torch, dev)

    # ---- the serving path: counts zeroed just before, read just after
    rn_ops.launches = da_ops.launches = 0
    t0 = time.perf_counter()
    out = launch_serve.main(SERVE_ARGS + [
        "--scheme", "expander", "--straggler-p", "0.2", "--check"])
    wall = time.perf_counter() - t0
    launches = {"rmsnorm": rn_ops.launches,
                "decode_attention": da_ops.launches}
    s = out["summary"]
    steps = s["pool_steps"]
    want = {"rmsnorm": 81 * steps, "decode_attention": 40 * steps}
    if steps <= 0 or launches != want:
        raise AssertionError(f"launch counts {launches} != {want} for "
                             f"{steps} pool steps")
    if s["check_passed"] is not True:
        raise AssertionError("engine streams != sequential reference")
    toks = np.concatenate(list(out["results"].values()))
    if s["new_tokens"] != 16 * 32 or toks.min() < 0 or \
            toks.max() >= 49155:
        raise AssertionError("unexpected generated tokens")

    p0 = {}
    for scheme in ("expander", "uncoded"):
        r = launch_serve.main(SERVE_ARGS + ["--scheme", scheme,
                                            "--straggler-p", "0"])
        p0[scheme] = r["results"]
    coded_eq_uncoded = all(np.array_equal(p0["expander"][u],
                                          p0["uncoded"][u])
                           for u in p0["uncoded"])
    if not coded_eq_uncoded:
        raise AssertionError("coded p=0 stream != uncoded stream")
    _say("path", arch="granite-3-8b", config="full", scheme="expander",
         straggler_p=0.2, tokens_per_s=s["tokens_per_s"],
         iterations=s["iterations"], pool_steps=steps,
         ttft_p50_ms=s["ttft_p50_ms"], ttft_p99_ms=s["ttft_p99_ms"],
         retries=s["retries"], check_passed=s["check_passed"],
         coded_p0_equals_uncoded=coded_eq_uncoded, launches=launches,
         wall_s=wall, peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)

    teacher_forced(torch, dev)

    kernels = []
    for name, replaces in (
            ("rmsnorm", "src/repro/kernels/rmsnorm/kernel.py:38"),
            ("decode_attention",
             "src/repro/kernels/decode_attention/kernel.py:72")):
        r = rows[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": os.path.relpath(build.SOURCES[name], ROOT),
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": r["max_abs_err"], "ms": r["kernel_ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
