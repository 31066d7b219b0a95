#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA GPU and
check it: the quickest proof that the port builds, serves, trains and
runs the paper's Monte-Carlo and spectral harness on the card.

    python3 chip_smoke.py          # from the repository root

Phases, in order; any failure raises and the script exits non-zero:

1. Environment: the card's name and power limit (``nvidia-smi``), the
   torch and CUDA versions, and the float32 matmul setting (TF32 off).
2. Build: the five CUDA sources under ``src/repro_torch/kernels/*/csrc``
   (rmsnorm, decode_attention, coded_combine, batched_alpha,
   spectral_matvec), one nvcc each, started together, for sm_90a into
   the git-ignored build directory.
3. Kernels: each kernel against its plain PyTorch version on the card,
   in the working dtype, at the serving path's shapes and a few more,
   with the repository's tolerances (bf16 atol = rtol = 3e-2, f32 2e-5);
   decode_attention also at the serving position (every length 144) and
   at a 32k cache, two launches bit for bit equal;
   kernel, plain and library-call device times (CUDA-graph replays
   between CUDA events, once the card's clock has risen), the wrapper's
   per-call time, and the least
   time the card could take (bytes over 3.35 TB/s, or operations over
   the peak rate of the inputs' type, whichever is larger). The three
   combines (coded_combine, quantized_combine, packed_sign_combine) at
   the training path's shapes (n = 4 rows of D = 104,857,600, the
   stacked ``wi_gate`` leaf, and D = 8,192, the stacked norm scales),
   at odd widths (D = 1, 7, 9, 1,000,003), and on exact inputs (integer
   payloads, power-of-two weights and scales, a dead row), where the
   comparison is bitwise and also against the float64 NumPy oracles;
   quantized_combine also at the elastic run's 3 rows of D = 104,857,600.
   The harness kernels -- fused_error (K6), gram_matvec with a 1-D v and
   with 8 right-hand sides (K7a) and gram_matvec_batch (K7b) -- at the
   harness path's shapes (trials = 30 and 1000 over n = 2184; the
   regime-2 stack of 12 (2184, 30) slices, and of 12 (2184, 1000)) and
   odd ones, against their
   plain torch versions and the float64 NumPy oracles: K6 within
   rtol = atol = 2e-5, K7 within atol 5e-6 after scaling by max|ref|
   (the reference suite's tolerances).
4. The serving path: ``repro_torch.launch.serve.main`` at granite-3-8b's
   full config (40 layers, d_model 4096, GQA 32/8), 16 requests on 8
   slots, coded prefill over the expander, ``--check`` against the
   sequential reference loop. Kernel launch counts are zeroed just before
   and read just after; they must equal 81 and 40 per pool step. Then
   coded at p=0 and uncoded must produce equal streams. Then a few
   teacher-forced decode steps through the kernels and through the plain
   versions: equal to 1e-3 in float32, and in bf16 no farther from the
   float32 logits than twice the plain version's bf16 error. Then the
   pool step's device time by kernel family
   (``repro_torch.launch.step_profile --full-config``).
5. The training path: ``repro_torch.launch.train.main`` at granite-3-8b's
   full width with 2 layers (bf16 activations, float32 parameters and
   AdamW at lr 1e-4), m = 4 machines, expander d = 2, Bernoulli
   p = 0.2, sequences of 256 tokens in blocks of 4, 12 steps, four
   runs: the dedup path with no compression, with int8 and with
   sign_packed, and the manual collective. Launch counts are zeroed
   before each run and read after: one combine launch per parameter
   leaf and step (12 leaves: the LM head is untied) on the run that uses
   that combine and none elsewhere, and 5 rmsnorm launches per forward
   pass. The driver asserts that the loss decreased. Each run is
   repeated through the plain versions (``_FORCE = "ref"``) and the two
   loss streams must agree to ``LOSS_RTOL``. Then one float32 SGD step:
   the manual collective through coded_combine against the dedup path
   through autograd, on the same parameters, weights and batch, the
   parameters equal to rtol 2e-4 and atol 2e-5. Then elastic training,
   the same model and settings: CI's chaos smoke (``--straggler-p 0
   --chaos kill:1@3``) under int8, so machine 1 is declared dead after 3
   missed heartbeats and the code is re-drawn over 3 survivors
   (quantized_combine on 4 blocks, then on 3): CI's five conditions on
   the event log, the log equal to the summary, one quantized_combine
   launch per leaf and step across both generations, 5 rmsnorm launches
   per forward, the plain run's loss stream within ``LOSS_RTOL`` and
   ``rebuild_s`` printed. Then the scheme zoo and adaptive decoding: the
   affine plane AG(2,2) (``--scheme bibd --replication 3 --machines 6``,
   n = 4 blocks) under sign_packed, and cyclic-MDS under a Markov
   process with ``--adaptive adaptive`` (its ``adaptive`` block
   printed), each against its plain run. Then the coding runtime at
   m = 6552 with ``device="cuda"`` (its debias batch through the torch
   propagator) and ``device="cpu"``: equal scales. Each phase's seconds
   are printed.
5b. The other families at full width (``families``): deepseek-moe-16b
   (moe), zamba2-1.2b (hybrid), xlstm-1.3b (ssm), pixtral-12b (vlm) and
   seamless-m4t-large-v2 (audio). Each trains 6 steps on the dedup path
   (m = 4, expander d = 2, p = 0.2, 256-token sequences in blocks of 4,
   lr 1e-4) through the kernels and through the plain versions (loss
   streams within ``LOSS_RTOL``, exactly one rmsnorm launch per norm of
   each forward), then serves: moe, hybrid and ssm through the engine
   with ``--check``, vlm and audio through the static path (prefill
   with the 1024-position patch prefix or frame source, the encoder
   output into the cache, decode steps), with exact rmsnorm and
   decode_attention counts; then teacher-forced decode logits through
   the kernels against the plain versions (``teacher_forced``'s rules,
   float32 within ``FAMILY_F32_REL`` of the largest logit).
   Depth is cut only where memory forces it (``FAMILY_TRAIN``,
   ``FAMILY_SERVE``); each family's line prints its cuts, ms per step
   and peak memory. The kernels phase also checks decode_attention at
   the families' head dims (pixtral's 160 in bf16 and f32, 64, 128 at
   G = 1) and rmsnorm at d = 1024, 2048 and 5120.
6. The harness path (``repro_torch.launch.harness``) on the card at the
   paper's Section VIII-B scale (m = 6552, d = 6, the LPS X^{5,13}
   graph, n = 2184): the CLI with ``--full`` (regime 1 and regime 2 and
   the compression grid, the adversarial table at m = 6552, the q = 3
   scheme zoo, the convergence grid, the lower bounds of Props A.1/A.3,
   the Theorem IV.1 expansion ablation) with its paper-claim asserts,
   the new sections held to the CPU's rows (errors within
   1e-4 |cpu| + 1e-7, covariance spectra within 5e-3 |cpu| + 1e-9, the
   compression grid bit for bit); then the torch label
   propagator at (1000, 6552) bitwise against the NumPy one, cold and
   warm; ``monte_carlo_error`` at trials = 1000; the regime-2 campaign
   (blocked Lanczos, K7b) against per-scheme ``sweep_error`` (lanczos,
   K7a) and against the same campaign on the CPU (errors within
   1e-4 |cpu| + 1e-7, covariance norms within 5e-3 |cpu| + 1e-9), one
   dense SVD, a bitwise repeat and a ``cov_topk=4`` campaign (K7a's
   block form). Counts are zeroed before and read after each step: one
   fused_error launch per (scheme, p) row, one gram_matvec_batch launch
   per lockstep Lanczos iteration, no plain-version run. Then the
   regime-2 campaign's wall time split into host decode, the K6 stage,
   and the covariance stage with the device time the profiler saw.
7. The launch plans of the four redesigned kernels at the path shapes
   (rmsnorm's and fused_error's threads a row, decode_attention's
   chunks, gram_matvec's strips and clusters; each timed K1 and K6 row
   also carries its plan), a
   ``kernels`` JSON line (K1-K7, eight entry points), then the card line,
   then the result line.
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
# decode attention also within this share of max |want|: a full 32k
# cache gives outputs of about sqrt(e / 32768) rms, far below TOL's atol,
# and a chunk dropped from the merge exceeds this share
DA_SCALED_TOL = 3e-2
F32_MODEL_TOL = dict(atol=1e-3, rtol=1e-3)   # f32 logits after 40 layers
# The other families' float32 logits, kernels vs plain, within this share
# of the largest logit: the kernels' float32 rounding (2^-24 in a norm)
# grows with depth and differs by family -- zamba2-1.2b's 38 Mamba2 blocks
# and 2 shared-attention blocks reached 1.3e-3 at logits of about 5, 30x
# xlstm-1.3b's 48 blocks (on an NVIDIA H100 80GB HBM3 at 700 W, PERF.md).
FAMILY_F32_REL = 1e-3
BF16_NOISE_FACTOR = 2.0
# The combines on general inputs: kernel and plain version do the same
# rounded multiplies and adds in the same row order, so the error is
# expected to be 0; the tolerance is float32 rounding of one partial sum.
COMBINE_TOL = dict(atol=1e-6, rtol=1e-6)
PATH_D = (104_857_600, 8_192)
ODD_D = (1, 7, 9, 1_000_003)
COMBINE_ROWS = 4
COMBINES = ("coded_combine", "quantized_combine", "packed_sign_combine")
# Training: loss streams through the kernels vs the plain versions.
LOSS_RTOL = 1e-2
F32_STEP_TOL = dict(rtol=2e-4, atol=2e-5)
TRAIN_ARGS = ["--steps", "12", "--seq-len", "256", "--block-size", "4",
              "--machines", "4", "--scheme", "expander", "--replication",
              "2", "--straggler-model", "bernoulli", "--straggler-p",
              "0.2", "--lr", "1e-4", "--log-every", "4", "--seed", "0"]
TRAIN_RUNS = (("dedup none", []),
              ("dedup int8", ["--compress", "int8"]),
              ("dedup sign_packed", ["--compress", "sign_packed"]),
              ("manual none", ["--collective", "manual"]))
# Elastic training: CI's chaos smoke (kill machine 1 at step 3, no
# sampled stragglers) under int8, so quantized_combine runs on 4 blocks
# and, after the re-assignment over 3 survivors, on 3.
ELASTIC_ARGS = ["--straggler-p", "0", "--compress", "int8", "--chaos",
                "kill:1@3"]
ELASTIC_ROWS = 3
# The scheme zoo and adaptive decoding: the affine plane AG(2,2) (m = 6
# machines, n = 4 blocks) under sign_packed, and cyclic-MDS under a
# Markov straggler process with the adaptive policy.
ZOO_RUNS = (("bibd sign_packed", ["--scheme", "bibd", "--replication", "3",
                                  "--machines", "6", "--compress",
                                  "sign_packed"]),
            ("cyclic_mds adaptive", ["--scheme", "cyclic_mds",
                                     "--straggler-model", "markov",
                                     "--adaptive", "adaptive"]))
SERVE_ARGS = ["--arch", "granite-3-8b", "--full-config", "--requests",
              "16", "--slots", "8", "--prompt-len", "128",
              "--prompt-spread", "32", "--max-new-tokens", "32",
              "--max-len", "1024", "--replicas", "8", "--seed", "0"]
# The harness kernels: the reference suite's tolerances
# (tests/test_kernels.py:278-358).
K6_TOL = dict(rtol=2e-5, atol=2e-5)
K7_SCALED_ATOL = 5e-6          # after dividing by max(1, max|ref|)
K6_SHAPES = ((30, 2184), (1000, 2184), (1, 1), (7, 130), (33, 384),
             (1000, 2185))
K7_SHAPES = ((2184, 30), (2184, 1000), (1, 1), (7, 130), (33, 384),
             (1000, 2185), (17, 384))
K7B_SHAPES = ((12, 2184, 30), (12, 2184, 1000), (3, 17, 384),
              (5, 100, 30))
# The harness on the card against the CPU: errors within
# ERR_RTOL |cpu| + ERR_ATOL (float32 reduction, float32 debias scale;
# the floor covers the exact zeros where alpha = 1), covariance norms
# within COV_RTOL |cpu| + COV_ATOL (the reference's float32 tolerance,
# tests/test_campaign.py:40; the floor covers zero covariances).
ERR_RTOL, ERR_ATOL = 1e-4, 1e-7
COV_RTOL, COV_ATOL = 5e-3, 1e-9
HARNESS_P = (0.05, 0.1, 0.15, 0.2, 0.25, 0.3)


def _say(tag, **kw):
    print(f"{tag} {json.dumps(kw)}", flush=True)


def _times(torch, kernel, plain, library, reps=20):
    """Device ms per call of each (CUDA-graph replays), and the wrapper's
    host ms per call of the kernel. ``library`` may be None: no single
    PyTorch call computes the function."""
    from repro_torch.launch.timing import call_ms, graph_ms
    return dict(kernel_ms=graph_ms(kernel, reps=reps),
                plain_ms=graph_ms(plain, reps=reps),
                library_ms=(None if library is None
                            else graph_ms(library, reps=reps)),
                kernel_call_ms=call_ms(kernel))


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


def _plan(module, name, *args):
    """A kernel's launch plan at these arguments, as a dict; None where
    the checkout being timed (``tools/compare_trees.py``) has no such
    planner."""
    fn = getattr(module, name, None)
    return None if fn is None else fn(*args)._asdict()


def check_rmsnorm(torch, dev, rows_shape, dtype, label):
    import torch.nn.functional as F
    from repro_torch.kernels import _launch
    from repro_torch.kernels.rmsnorm import kernel, ops, ref
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
    # what the card takes to read x and write an output of its shape: a
    # device copy, the floor that moving these bytes reaches in practice
    from repro_torch.launch.timing import graph_ms
    copy = torch.empty_like(x)
    row = dict(kernel="rmsnorm", shape=label, dtype=dtype,
               max_abs_err=err, bound_ms=bound, bound_by=by,
               copy_ms=graph_ms(lambda: copy.copy_(x)),
               plan=_plan(kernel, "plan_rows", rows, d, x.element_size(),
                          _launch.sm_count(dev)),
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
    again = ops.decode_attention(q, k, v, lens)
    want = ref.decode_attention(q, k, v, lens)
    torch.cuda.synchronize()
    if not torch.equal(out, again):
        raise AssertionError(f"decode_attention {label}: two launches "
                             "differ")
    err = _compare(torch, out, want, TOL[dtype],
                   f"decode_attention {label}")
    top = want.float().abs().max().item()
    if err > DA_SCALED_TOL * top:
        raise AssertionError(f"decode_attention {label}: max abs err {err} "
                             f"> {DA_SCALED_TOL} * max|want| ({top})")
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


def _combine_inputs(torch, dev, kind, d, dtype, exact, seed,
                    n=COMBINE_ROWS):
    """(payload, scales, w) for one combine of n rows. Exact inputs:
    integer payloads, power-of-two weights and scales, so every float32
    partial sum is exact; both kinds carry a dead row (w = 0)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    if exact:
        w = 2.0 ** torch.randint(-3, 3, (n,), generator=g,
                                 device=dev).float()
        scales = 2.0 ** torch.randint(-4, 2, (n,), generator=g,
                                      device=dev).float()
    else:
        w = torch.rand(n, generator=g, device=dev) * 2
        scales = torch.rand(n, generator=g, device=dev) + 0.01
    w[n // 2] = 0.0
    if kind == "packed_sign_combine":
        x = torch.randint(0, 256, (n, (d + 7) // 8), generator=g,
                          device=dev, dtype=torch.uint8)
    elif dtype == "int8":
        x = torch.randint(-127, 128, (n, d), generator=g, device=dev,
                          dtype=torch.int8)
    elif exact:
        x = torch.randint(-127, 128, (n, d), generator=g, device=dev,
                          dtype=torch.int32).to(getattr(torch, dtype))
    else:
        x = torch.randn(n, d, generator=g, device=dev).to(
            getattr(torch, dtype))
    return x, scales, w


def check_combine(torch, dev, kind, d, dtype, exact, time_it=True,
                  n=COMBINE_ROWS):
    """One combine of n rows against its plain version on the card:
    bitwise on exact inputs (and against the float64 NumPy oracle of the
    quantized combines up to D = 1,000,003), else within COMBINE_TOL."""
    import numpy as np
    from repro_torch.kernels.coded_combine import ops, ref
    x, scales, w = _combine_inputs(torch, dev, kind, d, dtype, exact,
                                   seed=d % 1000 + 7 * exact + n, n=n)
    if kind == "coded_combine":
        args, plain = (x, w), ref.coded_combine
    elif kind == "quantized_combine":
        args, plain = (x, scales, w), ref.quantized_combine
    else:
        args = (x, scales, w, d)
        plain = ref.packed_sign_combine
    fn = getattr(ops, kind)
    out, want = fn(*args), plain(*args)
    torch.cuda.synchronize()
    label = f"{kind} n={n} D={d} {dtype}" + (" exact" if exact else "")
    err = (out.float() - want.float()).abs().max().item()
    if exact:
        if not torch.equal(out, want):
            raise AssertionError(f"{label}: kernel differs from its plain "
                                 f"version on exact inputs (max {err})")
        if kind != "coded_combine" and d <= 1_000_003:
            xs, ss, ws = (a.cpu().numpy() for a in (x, scales, w))
            oracle = (ref.quantized_combine_np(xs, ss, ws)
                      if kind == "quantized_combine"
                      else ref.packed_sign_combine_np(xs, ss, ws, d))
            if not np.array_equal(out.cpu().numpy(), oracle):
                raise AssertionError(f"{label}: kernel differs from the "
                                     "float64 NumPy oracle")
        # the dead row's payload must not matter: replace it, same bits
        x2 = x.clone()
        x2[n // 2] = x2[0]
        if not torch.equal(fn(x2, *args[1:]), out):
            raise AssertionError(f"{label}: a dead row changed the output")
    else:
        _compare(torch, out, want, COMBINE_TOL, label)
    row = dict(kernel=kind, shape=label, dtype=dtype, max_abs_err=err,
               exact=exact)
    if time_it:
        out_bytes = d * out.element_size()
        nbytes = x.numel() * x.element_size() + out_bytes + 8 * n
        bound, by = _bound_ms(nbytes, 2 * n * d, "float32")
        library = None
        if kind == "coded_combine":
            wl = w.to(x.dtype)
            library = lambda: torch.mv(x.t(), wl)  # noqa: E731
        row.update(bound_ms=bound, bound_by=by, **_times(
            torch, lambda: fn(*args), lambda: plain(*args), library,
            reps=4 if d > 10_000_000 else 20))
    _say("kernel", **row)
    return row


def combine_checks(torch, dev):
    """The three combines at the path shapes, odd widths and on exact
    inputs; returns the timed path-shape rows by kernel name."""
    rows = {}
    for kind in COMBINES:
        dtypes = {"coded_combine": ("float32", "bfloat16"),
                  "quantized_combine": ("int8", "float32"),
                  "packed_sign_combine": ("uint8",)}[kind]
        for d in PATH_D:
            for i, dt in enumerate(dtypes):
                r = check_combine(torch, dev, kind, d, dt, exact=False)
                if d == PATH_D[0] and i == 0:
                    rows[kind] = r
                check_combine(torch, dev, kind, d, dt, exact=True,
                              time_it=False)
        for d in ODD_D:
            for dt in dtypes:
                check_combine(torch, dev, kind, d, dt, exact=False)
                check_combine(torch, dev, kind, d, dt, exact=True,
                              time_it=False)
    # the elastic run's shape: 3 blocks after the re-assignment
    check_combine(torch, dev, "quantized_combine", PATH_D[0], "int8",
                  exact=False, n=ELASTIC_ROWS)
    check_combine(torch, dev, "quantized_combine", PATH_D[0], "int8",
                  exact=True, time_it=False, n=ELASTIC_ROWS)
    check_width_mismatch(torch, dev)
    return rows


def check_width_mismatch(torch, dev):
    from repro_torch.kernels.coded_combine import ops
    before = dict(ops.launches)
    q = torch.zeros(2, 3, dtype=torch.uint8, device=dev)
    one = torch.ones(2, device=dev)
    try:
        ops.packed_sign_combine(q, one, one, 25)
    except ValueError:
        pass
    else:
        raise AssertionError("packed_sign_combine took a payload of the "
                             "wrong width")
    if ops.launches != before:
        raise AssertionError("a refused width still launched")
    _say("kernel_check", name="packed_sign_combine refuses a width other "
         "than ceil(d/8) before launching", ok=True)


def _run_train(torch, cfg, extra, force, args=TRAIN_ARGS):
    """One driver run with every count zeroed just before and read just
    after; ``force`` is the ops modules' ``_FORCE``."""
    import gc
    from repro_torch.kernels.coded_combine import ops as cc_ops
    from repro_torch.kernels.decode_attention import ops as da_ops
    from repro_torch.kernels.rmsnorm import ops as rn_ops
    from repro_torch.launch import train as launch_train
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    rn_ops._FORCE = cc_ops._FORCE = force
    rn_ops.launches = da_ops.launches = 0
    cc_ops.launches = dict.fromkeys(cc_ops.launches, 0)
    t0 = time.perf_counter()
    try:
        summary = launch_train.main(args + extra, cfg=cfg)
    finally:
        rn_ops._FORCE = cc_ops._FORCE = None
    wall = time.perf_counter() - t0
    counts = {"rmsnorm": rn_ops.launches,
              "decode_attention": da_ops.launches, **cc_ops.launches}
    return summary, counts, wall, torch.cuda.max_memory_allocated()


def train_runs(torch, dev):
    """The four training runs, each through the kernels and then through
    the plain versions; returns the kernel runs' launch counts."""
    from repro_torch.configs import get_config
    from repro_torch.models.convert import param_shapes
    cfg = get_config("granite-3-8b").with_overrides(n_layers=2)
    n_leaves = len(param_shapes(cfg))   # one combine launch per leaf
    steps = int(TRAIN_ARGS[TRAIN_ARGS.index("--steps") + 1])
    totals = {}
    for label, extra in TRAIN_RUNS:
        s, counts, wall, peak = _run_train(torch, cfg, extra, None)
        manual = "manual" in extra
        codec = extra[extra.index("--compress") + 1] \
            if "--compress" in extra else "none"
        rows = 4   # n blocks on the dedup path, m machines on the manual
        forwards = rows if (manual or codec != "none") else 1
        want = {"rmsnorm": 5 * forwards * steps, "decode_attention": 0,
                "coded_combine": n_leaves * steps if manual else 0,
                "quantized_combine": (n_leaves * steps
                                      if codec == "int8" else 0),
                "packed_sign_combine": (n_leaves * steps
                                        if codec == "sign_packed" else 0)}
        if counts != want:
            raise AssertionError(f"train {label}: launch counts {counts} "
                                 f"!= {want}")
        r, rwall = _plain_run(torch, cfg, extra, label)
        gap = _loss_gap(label, s, r, steps)
        for k, v in counts.items():
            totals[k] = totals.get(k, 0) + v
        _say("train", run=label, arch=cfg.name, n_layers=cfg.n_layers,
             d_model=cfg.d_model, dtype=cfg.dtype, path=s["path"],
             collective=s["collective"], compress=s["compress"],
             steps=steps, losses=s["losses"], plain_losses=r["losses"],
             loss_rel_gap=gap, loss_rtol=LOSS_RTOL, launches=counts,
             ms_per_step=s["loop_s"] / steps * 1e3,
             plain_ms_per_step=r["loop_s"] / steps * 1e3,
             wall_s=wall, plain_wall_s=rwall, peak_mem_gb=peak / 1e9,
             comm_bytes_per_step=s["comm_bytes_per_step"],
             decode_calls=s["decode_calls"])
    return totals


def _loss_gap(label, s, r, steps):
    """Largest relative gap between the kernel and plain loss streams."""
    import numpy as np
    got, ref_l = (np.asarray(x["losses"]) for x in (s, r))
    if got.shape != (steps,) or not np.isfinite(got).all():
        raise AssertionError(f"train {label}: bad loss stream {got}")
    gap = float(np.max(np.abs(got - ref_l) / np.abs(ref_l)))
    if not gap <= LOSS_RTOL:
        raise AssertionError(f"train {label}: kernel and plain loss streams "
                             f"differ by {gap} relative (> {LOSS_RTOL})")
    return gap


def _plain_run(torch, cfg, extra, label, args=TRAIN_ARGS):
    r, counts, wall, _ = _run_train(torch, cfg, extra, "ref", args)
    if any(counts.values()):
        raise AssertionError(f"train {label}: the plain run launched "
                             f"kernels {counts}")
    return r, wall


def elastic_run(torch, dev):
    """CI's chaos smoke at full width: machine 1 killed at step 3,
    detected after 3 missed heartbeats, the code re-drawn over the 3
    survivors; int8 combines on 4 blocks, then on 3. Returns the kernel
    run's launch counts."""
    import tempfile
    from repro_torch.configs import get_config
    from repro_torch.models.convert import param_shapes
    cfg = get_config("granite-3-8b").with_overrides(n_layers=2)
    n_leaves = len(param_shapes(cfg))
    steps = int(TRAIN_ARGS[TRAIN_ARGS.index("--steps") + 1])
    with tempfile.TemporaryDirectory() as tmp:
        log = os.path.join(tmp, "events.json")
        s, counts, wall, peak = _run_train(
            torch, cfg, ELASTIC_ARGS + ["--event-log", log], None)
        with open(log) as f:
            logged = json.load(f)
    chaos = s["chaos"]
    if logged != chaos:
        raise AssertionError("the event log differs from the summary's "
                             "chaos object")
    got = (chaos["dead_machines"], chaos["steps_to_detect"],
           len(chaos["reassignments"]), chaos["m_final"],
           chaos["generations"])
    if got != ([1], {"1": 3}, 1, 3, 2):
        raise AssertionError(f"elastic: chaos summary {got}")
    at = chaos["reassignments"][0]["step"]
    rows = 4 * at + ELASTIC_ROWS * (steps - at)   # per-block forwards
    want = {"rmsnorm": 5 * rows, "decode_attention": 0, "coded_combine": 0,
            "quantized_combine": n_leaves * steps,
            "packed_sign_combine": 0}
    if counts != want:
        raise AssertionError(f"elastic: launch counts {counts} != {want}")
    r, rwall = _plain_run(torch, cfg, ELASTIC_ARGS, "elastic")
    if r["chaos"]["events"] != chaos["events"]:
        raise AssertionError("elastic: the plain run saw other events")
    gap = _loss_gap("elastic", s, r, steps)
    _say("train_elastic", arch=cfg.name, n_layers=cfg.n_layers,
         chaos=chaos["spec"], compress=s["compress"],
         dead_machines=chaos["dead_machines"],
         steps_to_detect=chaos["steps_to_detect"],
         degraded_steps=chaos["degraded_steps"],
         reassignments=chaos["reassignments"],
         rebuild_s=chaos["reassignments"][0]["rebuild_s"],
         m_final=chaos["m_final"], generations=chaos["generations"],
         losses=s["losses"], plain_losses=r["losses"], loss_rel_gap=gap,
         loss_rtol=LOSS_RTOL, launches=counts,
         ms_per_step=s["loop_s"] / steps * 1e3,
         plain_ms_per_step=r["loop_s"] / steps * 1e3, wall_s=wall,
         plain_wall_s=rwall, peak_mem_gb=peak / 1e9)
    return counts


def zoo_runs(torch, dev):
    """The scheme zoo and adaptive decoding at full width, each through
    the kernels and then the plain versions. Returns the kernel runs'
    summed launch counts."""
    from repro_torch.configs import get_config
    from repro_torch.models.convert import param_shapes
    cfg = get_config("granite-3-8b").with_overrides(n_layers=2)
    n_leaves = len(param_shapes(cfg))
    steps = int(TRAIN_ARGS[TRAIN_ARGS.index("--steps") + 1])
    totals = {}
    for label, extra in ZOO_RUNS:
        s, counts, wall, peak = _run_train(torch, cfg, extra, None)
        packed = "sign_packed" in extra
        forwards = 4 if packed else 1      # both schemes have n = 4 blocks
        want = {"rmsnorm": 5 * forwards * steps, "decode_attention": 0,
                "coded_combine": 0, "quantized_combine": 0,
                "packed_sign_combine": n_leaves * steps if packed else 0}
        if counts != want:
            raise AssertionError(f"train {label}: launch counts {counts} "
                                 f"!= {want}")
        r, rwall = _plain_run(torch, cfg, extra, label)
        if s.get("adaptive") != r.get("adaptive"):
            raise AssertionError(f"train {label}: adaptive blocks differ "
                                 f"{s.get('adaptive')} {r.get('adaptive')}")
        gap = _loss_gap(label, s, r, steps)
        for k, v in counts.items():
            totals[k] = totals.get(k, 0) + v
        _say("train_zoo", run=label, arch=cfg.name, n_layers=cfg.n_layers,
             scheme=s["scheme"], m_workers=s["m_workers"],
             compress=s["compress"], adaptive=s.get("adaptive"),
             losses=s["losses"], plain_losses=r["losses"],
             loss_rel_gap=gap, loss_rtol=LOSS_RTOL, launches=counts,
             ms_per_step=s["loop_s"] / steps * 1e3,
             plain_ms_per_step=r["loop_s"] / steps * 1e3, wall_s=wall,
             plain_wall_s=rwall, peak_mem_gb=peak / 1e9,
             decode_calls=s["decode_calls"])
    return totals


def runtime_at_scale(torch, dev):
    """The coding runtime at m = 6552 (the LPS X^{5,13} expander, d = 6):
    its debias batch (256 x 6552 mask entries) decodes through the torch
    label propagator on the card, or on the host with device="cpu"; the
    two scales are equal bit for bit."""
    from repro_torch.configs import CodingConfig
    from repro_torch.core import batched_decoding as bd
    from repro_torch.dist import coded_train
    cfg = CodingConfig(scheme="expander", replication=6, straggler_p=0.2)
    calls = []
    orig = bd._propagate_torch

    def counting(*a, **kw):
        calls.append(1)
        return orig(*a, **kw)

    bd._propagate_torch = counting
    try:
        t0 = time.perf_counter()
        card = coded_train.CodingRuntime(cfg, 6552, device=dev).scale
        card_s = time.perf_counter() - t0
        on_card = len(calls)
        t0 = time.perf_counter()
        host = coded_train.CodingRuntime(cfg, 6552, device="cpu").scale
        host_s = time.perf_counter() - t0
    finally:
        bd._propagate_torch = orig
    if on_card < 1 or len(calls) != on_card:
        raise AssertionError(f"runtime at scale: propagator calls "
                             f"{on_card} on the card, {len(calls)} in all")
    if card != host:
        raise AssertionError(f"runtime scale on the card {card} != on the "
                             f"host {host}")
    _say("runtime_at_scale", m=6552, replication=6, p=0.2, trials=256,
         scale=card, bitwise=True, card_s=card_s, host_s=host_s)


def f32_manual_vs_autograd(torch, dev):
    """One float32 SGD step at granite-3-8b's width, 2 layers: the manual
    collective (per-machine gradients through coded_combine) against the
    dedup path (autograd's fused combine), same parameters, weights and
    batch."""
    import numpy as np
    from repro_torch import tree as T
    from repro_torch.configs import CodingConfig, get_config
    from repro_torch.core import step_weights as sw
    from repro_torch.data.pipeline import CodedBatcher, SyntheticLM
    from repro_torch.dist import coded_train
    from repro_torch.kernels.coded_combine import ops as cc_ops
    from repro_torch.models import model as M
    from repro_torch.models.convert import param_shapes
    from repro_torch.optim import optimizers as opt_mod
    cfg = get_config("granite-3-8b").with_overrides(n_layers=2,
                                                    dtype="float32")
    n_leaves = len(param_shapes(cfg))
    A = coded_train.make_assignment(CodingConfig(replication=2), 4)
    batcher = CodedBatcher(A, shuffle_seed=0)
    raw = SyntheticLM(cfg.vocab_size, 256, seed=0).batch(A.n * 4, 0)
    coded = {k: torch.from_numpy(v).to(dev)
             for k, v in batcher.code_batch(raw).items()}
    blocks = {k: torch.from_numpy(v).to(dev)
              for k, v in batcher.unique_blocks(raw).items()}
    w_np = np.asarray([1.0, 0.0, 0.7, 2.0], np.float32)
    w = torch.from_numpy(w_np).to(dev)
    v = torch.from_numpy(sw.block_weights(A, w_np)
                         .astype(np.float32)).to(dev)
    params = M.init_params(cfg, seed=1, device=dev)
    opt = opt_mod.sgd(1e-2)
    s_man = coded_train.make_manual_collective_train_step(
        cfg, opt, alpha_weights=coded_train.alpha_bar_weights(A))
    s_dd = coded_train.make_train_step(
        cfg, opt, dedup=True, norm_scale=coded_train.dedup_norm_scale(A))
    cc_ops.launches = dict.fromkeys(cc_ops.launches, 0)
    with torch.no_grad():
        p1, _, m1 = s_man(params, opt.init(params), coded, w)
        n_launch = cc_ops.launches["coded_combine"]
        p2, _, m2 = s_dd(params, opt.init(params), blocks, v)
    if n_launch != n_leaves:
        raise AssertionError(f"manual step launched coded_combine "
                             f"{n_launch} times, not {n_leaves}")
    l1, l2 = float(m1["loss"]), float(m2["loss"])
    if abs(l1 - l2) > 1e-5 * abs(l2):
        raise AssertionError(f"f32 step losses {l1} vs {l2}")
    for a, b in zip(T.leaves(p1), T.leaves(p2)):
        if not torch.allclose(a, b, **F32_STEP_TOL):
            raise AssertionError("f32 step: manual and autograd params "
                                 f"differ beyond {F32_STEP_TOL}")
    del p1, p2
    # the two combined gradients themselves (a parameter difference of
    # one step is lr * g under float32 cancellation against the params)
    with torch.no_grad():
        _, per = coded_train._per_machine_values_and_grads(params, coded,
                                                           cfg)
        g_man = coded_train.coded_allreduce(per, w)
        del per
        _, g_auto = coded_train.value_and_grad(
            lambda p: coded_train.coded_loss_fn_dedup(
                p, blocks, v, cfg, coded_train.dedup_norm_scale(A)),
            params)
    gap = max((a - b).abs().max().item()
              for a, b in zip(T.leaves(g_man), T.leaves(g_auto)))
    g_max = max(b.abs().max().item() for b in T.leaves(g_auto))
    _say("f32_step", arch=cfg.name, n_layers=2, loss_manual=l1,
         loss_autograd=l2, params_tol=F32_STEP_TOL,
         grad_max_abs_gap=gap, grad_max_abs=g_max,
         coded_combine_launches=n_launch)


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


# ---- the five other families (moe, hybrid, ssm, vlm, audio), full width
# Training: the dedup path with no compression, m = 4, expander d = 2,
# Bernoulli p = 0.2, sequences of 256 in blocks of 4 (16 a step), 6 steps
# of AdamW at lr 1e-4, as the granite runs. Depth is cut where float32
# parameters, AdamW's two moments, the gradients and the activations
# autograd keeps would pass ~60 GB (PERF.md section 4 has the reckoning).
FAMILY_TRAIN_ARGS = ["--steps", "6", "--seq-len", "256", "--block-size",
                     "4", "--machines", "4", "--scheme", "expander",
                     "--replication", "2", "--straggler-model",
                     "bernoulli", "--straggler-p", "0.2", "--lr", "1e-4",
                     "--log-every", "2", "--seed", "0"]
FAMILY_TRAIN = (("deepseek-moe-16b", {"n_layers": 2}),
                ("zamba2-1.2b", {}),
                ("xlstm-1.3b", {"n_layers": 16}),
                ("pixtral-12b", {"n_layers": 2}),
                ("seamless-m4t-large-v2", {"n_layers": 12,
                                           "n_encoder_layers": 12}))
# Serving: moe, hybrid and ssm through the engine with --check; vlm and
# audio through the static path (prefill with the patch prefix or the
# frame source, the encoder output into the cache, decode steps).
FAMILY_SERVE = (("deepseek-moe-16b", {"n_layers": 8}),
                ("zamba2-1.2b", {}),
                ("xlstm-1.3b", {}),
                ("pixtral-12b", {"n_layers": 8}),
                ("seamless-m4t-large-v2", {}))
ENGINE_ARGS = ["--requests", "8", "--slots", "8", "--prompt-len", "32",
               "--prompt-spread", "8", "--max-new-tokens", "16",
               "--max-len", "64", "--replicas", "8", "--scheme",
               "expander", "--straggler-p", "0.2", "--seed", "0",
               "--check"]
STATIC_ARGS = ["--slots", "4", "--prompt-len", "16", "--max-new-tokens",
               "16", "--max-len", "64", "--seed", "0"]


def _norms(cfg, kind):
    """rmsnorm launches of one pass: "forward" (training batches carry no
    audio source), "decode" (one step; audio with its cross-attention) or
    "encode" (the audio encoder)."""
    at, L = cfg.arch_type, cfg.n_layers
    if kind == "encode":
        return 2 * cfg.n_encoder_layers + 1
    if at == "hybrid":
        return L + 2 * len(cfg.attn_positions) + 1
    if at == "ssm":
        r = cfg.slstm_ratio
        return 2 * (L // (r + 1)) * (r + 1) + 1
    if at == "audio" and kind == "decode":
        return 3 * L + 1
    return 2 * L + 1


def _attentions(cfg):
    """decode_attention launches of one decode step."""
    if cfg.arch_type == "hybrid":
        return len(cfg.attn_positions)
    return 0 if cfg.arch_type == "ssm" else cfg.n_layers


def _cuts(cfg, over):
    from repro_torch.configs import get_config
    full = get_config(cfg.name)
    return {k: [getattr(full, k), v] for k, v in over.items()}


def _free(torch):
    import gc
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()


def family_train(torch, arch, over):
    """One family's training run through the kernels, then through the
    plain versions; returns its row and the kernel run's counts."""
    from repro_torch.configs import get_config
    from repro_torch.models.convert import param_shapes
    import numpy as np
    cfg = get_config(arch).with_overrides(**over)
    steps = int(FAMILY_TRAIN_ARGS[FAMILY_TRAIN_ARGS.index("--steps") + 1])
    label = f"{arch} train"
    s, counts, wall, peak = _run_train(torch, cfg, [], None,
                                       FAMILY_TRAIN_ARGS)
    want = {"rmsnorm": _norms(cfg, "forward") * steps,
            "decode_attention": 0, "coded_combine": 0,
            "quantized_combine": 0, "packed_sign_combine": 0}
    if counts != want:
        raise AssertionError(f"{label}: launch counts {counts} != {want}")
    r, rwall = _plain_run(torch, cfg, [], label, FAMILY_TRAIN_ARGS)
    gap = _loss_gap(label, s, r, steps)
    n_params = sum(int(np.prod(v)) for v in param_shapes(cfg).values())
    _free(torch)
    return dict(n_layers=cfg.n_layers, params=n_params,
                cuts=_cuts(cfg, over), losses=s["losses"],
                plain_losses=r["losses"], loss_rel_gap=gap,
                loss_rtol=LOSS_RTOL, launches=counts,
                ms_per_step=s["loop_s"] / steps * 1e3,
                plain_ms_per_step=r["loop_s"] / steps * 1e3,
                wall_s=wall, plain_wall_s=rwall,
                peak_mem_gb=peak / 1e9), counts


def family_serve(torch, dev, arch, over):
    """One family's serving run (engine with --check, or the static path)
    with the counts zeroed just before and read just after, then its
    teacher-forced logits through the kernels against the plain
    versions."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.kernels.decode_attention import ops as da_ops
    from repro_torch.kernels.rmsnorm import ops as rn_ops
    from repro_torch.launch import serve as launch_serve
    cfg = get_config(arch).with_overrides(**over)
    static = cfg.arch_type in ("vlm", "audio")
    _free(torch)
    rn_ops.launches = da_ops.launches = 0
    t0 = time.perf_counter()
    out = launch_serve.main(["--arch", arch] +
                            (STATIC_ARGS if static else ENGINE_ARGS),
                            cfg=cfg)
    wall = time.perf_counter() - t0
    counts = {"rmsnorm": rn_ops.launches,
              "decode_attention": da_ops.launches}
    s = out["summary"]
    if static:
        args = dict(zip(STATIC_ARGS[::2], STATIC_ARGS[1::2]))
        steps = int(args["--prompt-len"]) + int(args["--max-new-tokens"])
        prefill = (_norms(cfg, "encode") + _norms(cfg, "decode")
                   if cfg.arch_type == "audio" else _norms(cfg, "forward"))
        encode = _norms(cfg, "encode") if cfg.arch_type == "audio" else 0
        want_k1 = prefill + encode + steps * _norms(cfg, "decode")
        if s["new_tokens"] != int(args["--slots"]) * \
                int(args["--max-new-tokens"]):
            raise AssertionError(f"{arch} static: {s['new_tokens']} tokens")
    else:
        steps = s["pool_steps"]
        want_k1 = steps * _norms(cfg, "decode")
        if s["check_passed"] is not True or steps <= 0:
            raise AssertionError(f"{arch}: engine streams != sequential "
                                 "reference")
    want = {"rmsnorm": want_k1,
            "decode_attention": steps * _attentions(cfg)}
    if counts != want:
        raise AssertionError(f"{arch} serve: launch counts {counts} != "
                             f"{want} for {steps} steps")
    toks = (out["tokens"] if static else
            np.concatenate(list(out["results"].values())))
    if toks.min() < 0 or toks.max() >= cfg.vocab_size:
        raise AssertionError(f"{arch} serve: token out of the vocabulary")
    row = dict(path=s["path"], n_layers=cfg.n_layers, cuts=_cuts(cfg, over),
               steps=steps, tokens_per_s=s["tokens_per_s"],
               new_tokens=s["new_tokens"], launches=counts, wall_s=wall,
               peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
               check_passed=s.get("check_passed"))
    del out
    if not static:
        # where the pool step goes: 8 slots at cache position 32
        from repro_torch.launch import step_profile as sp
        _free(torch)
        prof = sp.main(["--slots", "8", "--max-len", "64", "--pos", "32"],
                       cfg=cfg)
        row["step_profile"] = {k: prof[k] for k in (
            "host_ms_per_step", "graph_ms_per_step", "device_ms_per_step",
            "device_busy_share", "kernel_families_ms_per_step")}
    row["teacher_forced"] = family_teacher_forced(torch, dev, cfg)
    _free(torch)
    return row, counts


def family_teacher_forced(torch, dev, cfg, steps=4, B=8):
    """``teacher_forced`` for any family: float32 kernels against float32
    plain versions within ``FAMILY_F32_REL`` of the largest logit; bf16
    kernels no farther from the float32 logits than
    ``BF16_NOISE_FACTOR`` times the plain bf16 version. The audio family
    decodes over an encoded frame source."""
    import numpy as np
    from repro_torch.kernels.decode_attention import ops as da_ops
    from repro_torch.kernels.rmsnorm import ops as rn_ops
    from repro_torch.models import model as M
    cfg32 = cfg.with_overrides(dtype="float32")
    params32 = M.init_params(cfg, seed=7, device=dev)
    params16 = M.cast_block_weights(params32, cfg)
    toks = torch.from_numpy(np.random.default_rng(7).integers(
        0, cfg.vocab_size, (steps, B))).to(dev)
    src = None
    if cfg.arch_type == "audio":
        g = torch.Generator(device=dev).manual_seed(7)
        src = torch.randn(B, cfg.prefix_len, cfg.d_model, generator=g,
                          device=dev) * 0.02

    def run(c, params, force):
        rn_ops._FORCE = da_ops._FORCE = force
        try:
            with torch.no_grad():
                cache = M.init_decode_cache(
                    c, B, 64, device=dev,
                    src_len=0 if src is None else src.shape[1])
                if src is not None:
                    cache["enc"] = M.encode(params, src, c)
                out = torch.stack([M.decode_step(params, toks[t], cache,
                                                 c)[0]
                                   for t in range(steps)])
        finally:
            rn_ops._FORCE = da_ops._FORCE = None
        if not torch.isfinite(out).all():
            raise AssertionError(f"{cfg.name}: non-finite logits")
        return out

    k32, p32 = run(cfg32, params32, None), run(cfg32, params32, "ref")
    err32 = (k32 - p32).abs().max().item()
    top = p32.abs().max().item()
    if not err32 <= FAMILY_F32_REL * top:
        raise AssertionError(f"{cfg.name} float32 teacher-forced logits: "
                             f"kernels vs plain differ by {err32} > "
                             f"{FAMILY_F32_REL} x max|logit| ({top})")
    del params32
    k16, p16 = run(cfg, params16, None), run(cfg, params16, "ref")
    err_k = (k16 - p32).abs().max().item()
    err_p = (p16 - p32).abs().max().item()
    if not err_k <= BF16_NOISE_FACTOR * err_p:
        raise AssertionError(
            f"{cfg.name} bf16 teacher-forced logits: kernels are {err_k} "
            f"from the float32 logits, more than {BF16_NOISE_FACTOR} x the "
            f"plain bf16 version's {err_p}")
    return dict(steps=steps, batch=B, f32_kernel_vs_plain=err32,
                f32_rel_tol=FAMILY_F32_REL, bf16_kernel_vs_f32=err_k,
                bf16_plain_vs_f32=err_p,
                bf16_kernel_vs_plain=(k16 - p16).abs().max().item(),
                max_abs_logit=top,
                greedy_agreement_bf16=(k16.argmax(-1) == p16.argmax(-1))
                .float().mean().item())


def families(torch, dev):
    """Every family trained and served on the card; one ``family`` line
    each. Returns the summed launch counts of the kernel runs."""
    from repro_torch.configs import get_config
    totals = {"rmsnorm": 0, "decode_attention": 0}
    serve = dict(FAMILY_SERVE)
    for arch, over in FAMILY_TRAIN:
        train_row, tc = family_train(torch, arch, over)
        serve_row, sc = family_serve(torch, dev, arch, serve[arch])
        for k in totals:
            totals[k] += tc[k] + sc[k]
        _say("family", arch=arch, arch_type=get_config(arch).arch_type,
             train=train_row, serve=serve_row)
    return totals


def _scaled_err(got, want):
    """max |got - want| / max(1, max |want|), the K7 comparison."""
    import numpy as np
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() /
                 max(1.0, float(np.abs(want).max())))


def check_fused_error(torch, dev, T, n, time_it):
    """K6 against its plain torch version and the float64 oracle."""
    import numpy as np
    from repro_torch.kernels import _launch
    from repro_torch.kernels.batched_alpha import kernel, ref
    rng = np.random.default_rng(T * 7 + n)
    a = rng.normal(1.0, 0.2, size=(T, n))
    scale = float(rng.uniform(0.5, 1.5))
    t = torch.tensor(a, dtype=torch.float32, device=dev)
    out, want = kernel.fused_error(t, scale), ref.fused_error(t, scale)
    torch.cuda.synchronize()
    label = f"fused_error trials={T} n={n}"
    err = _compare(torch, out, want, K6_TOL, label)
    oracle = ref.fused_error_np(a, scale)
    if not np.allclose(out.cpu().numpy(), oracle, **K6_TOL):
        raise AssertionError(f"{label}: kernel disagrees with the float64 "
                             "oracle")
    row = dict(kernel="fused_error", shape=label, dtype="float32",
               max_abs_err=err, plan=_plan(kernel, "plan_error", T, n,
                                           _launch.sm_count(dev)))
    if time_it:
        bound, by = _bound_ms(4 * (T * n + T), 3 * T * n, "float32")
        row.update(bound_ms=bound, bound_by=by, **_times(
            torch, lambda: kernel.fused_error(t, scale),
            lambda: ref.fused_error(t, scale), None))
    _say("kernel", **row)
    return row


def check_gram_matvec(torch, dev, R, k, bv, time_it):
    """K7a (bv = 0: a 1-D v) against its plain version and the oracle;
    no atomics, so two launches must agree bit for bit."""
    import numpy as np
    from repro_torch.kernels.spectral_matvec import kernel, ops, ref
    rng = np.random.default_rng(R + 3 * k + bv)
    x = rng.normal(size=(R, k))
    v = rng.normal(size=(bv, k)) if bv else rng.normal(size=k)
    xs = ops.prepare_operand(x, dev)
    vt = torch.tensor(v, dtype=torch.float32, device=dev)
    out, again = kernel.gram_matvec(xs, vt), kernel.gram_matvec(xs, vt)
    want = ref.gram_matvec(xs, vt)
    torch.cuda.synchronize()
    label = f"gram_matvec R={R} k={k} " + (f"bv={bv}" if bv else "1-D v")
    if not torch.equal(out, again):
        raise AssertionError(f"{label}: two launches differ")
    err = _scaled_err(out.cpu(), want.cpu())
    oracle = (ref.gram_matvec_block_np(x, v.T).T if bv
              else ref.gram_matvec_np(x, v))
    err_np = _scaled_err(out.cpu(), oracle)
    if not max(err, err_np) <= K7_SCALED_ATOL:
        raise AssertionError(f"{label}: scaled error {err} vs plain, "
                             f"{err_np} vs the float64 oracle "
                             f"(> {K7_SCALED_ATOL})")
    row = dict(kernel="gram_matvec", shape=label, dtype="float32",
               max_abs_err=err, max_scaled_err_vs_oracle=err_np)
    if time_it:
        nrhs = max(bv, 1)
        bound, by = _bound_ms(4 * (R * k + 2 * nrhs * k), 4 * nrhs * R * k,
                              "float32")
        vlib = vt.T if bv else vt
        row.update(bound_ms=bound, bound_by=by, **_times(
            torch, lambda: kernel.gram_matvec(xs, vt),
            lambda: ref.gram_matvec(xs, vt),
            lambda: xs.T @ (xs @ vlib)))
    _say("kernel", **row)
    return row


def check_gram_matvec_batch(torch, dev, B, R, k, time_it):
    """K7b against its plain version and the oracle, bit-reproducible."""
    import numpy as np
    from repro_torch.kernels.spectral_matvec import kernel, ops, ref
    rng = np.random.default_rng(B + R + k)
    x, v = rng.normal(size=(B, R, k)), rng.normal(size=(B, k))
    xs = ops.prepare_operand(x, dev)
    vt = torch.tensor(v, dtype=torch.float32, device=dev)
    out = kernel.gram_matvec_batch(xs, vt)
    again = kernel.gram_matvec_batch(xs, vt)
    want = ref.gram_matvec_batch(xs, vt)
    torch.cuda.synchronize()
    label = f"gram_matvec_batch B={B} R={R} k={k}"
    if not torch.equal(out, again):
        raise AssertionError(f"{label}: two launches differ")
    err = _scaled_err(out.cpu(), want.cpu())
    err_np = _scaled_err(out.cpu(), ref.gram_matvec_batch_np(x, v))
    if not max(err, err_np) <= K7_SCALED_ATOL:
        raise AssertionError(f"{label}: scaled error {err} vs plain, "
                             f"{err_np} vs the float64 oracle")
    row = dict(kernel="gram_matvec_batch", shape=label, dtype="float32",
               max_abs_err=err, max_scaled_err_vs_oracle=err_np)
    if time_it:
        bound, by = _bound_ms(4 * (B * R * k + 2 * B * k), 4 * B * R * k,
                              "float32")
        row.update(bound_ms=bound, bound_by=by, **_times(
            torch, lambda: kernel.gram_matvec_batch(xs, vt),
            lambda: ref.gram_matvec_batch(xs, vt),
            lambda: xs.transpose(1, 2) @ (xs @ vt[:, :, None])))
    _say("kernel", **row)
    return row


def harness_kernel_checks(torch, dev):
    """K6/K7 at the harness path's shapes and odd ones; returns the timed
    path-shape rows by kernel name (the first shape of each list)."""
    rows = {}
    for i, (T, n) in enumerate(K6_SHAPES):
        r = check_fused_error(torch, dev, T, n, time_it=i < 2)
        rows.setdefault("fused_error", r)
    for i, (R, k) in enumerate(K7_SHAPES):
        r = check_gram_matvec(torch, dev, R, k, 0, time_it=i < 2)
        rows.setdefault("gram_matvec", r)
        check_gram_matvec(torch, dev, R, k, 8, time_it=i < 2)
    for i, (B, R, k) in enumerate(K7B_SHAPES):
        r = check_gram_matvec_batch(torch, dev, B, R, k, time_it=i < 2)
        rows.setdefault("gram_matvec_batch", r)
    return rows


HARNESS_KERNELS = ("fused_error", "gram_matvec", "gram_matvec_block",
                   "gram_matvec_batch")


def _harness_zero():
    from repro_torch.kernels.batched_alpha import ops as ba_ops
    from repro_torch.kernels.spectral_matvec import ops as sm_ops
    ba_ops.launches = ba_ops.plain_calls = 0
    sm_ops.launches = dict.fromkeys(sm_ops.launches, 0)
    sm_ops.plain_calls = dict.fromkeys(sm_ops.plain_calls, 0)


def _harness_read(step):
    """The harness counts after ``step``; any plain-version run fails."""
    from repro_torch.kernels.batched_alpha import ops as ba_ops
    from repro_torch.kernels.spectral_matvec import ops as sm_ops
    plain = ba_ops.plain_calls + sum(sm_ops.plain_calls.values())
    if plain:
        raise AssertionError(f"harness {step}: {plain} plain-version runs "
                             "on the card")
    return {"fused_error": ba_ops.launches, **sm_ops.launches}


def _within(got, want, rtol, atol):
    return abs(got - want) <= rtol * abs(want) + atol


def _compare_rows(card, cpu, what):
    """Per (scheme, p): errors within ERR_*, covariance norms (and top-k
    spectra) within COV_*. Returns, per kind, the largest relative gap
    where the CPU value is above the absolute floor, and the largest
    share of the tolerance used anywhere."""
    gaps = {"err_rel": 0.0, "err_tol_share": 0.0, "cov_rel": 0.0,
            "cov_tol_share": 0.0}

    def check(kind, got, want, rtol, atol, where):
        tol = rtol * abs(want) + atol
        if not abs(got - want) <= tol:
            raise AssertionError(f"{what} {where}: card {got} vs cpu "
                                 f"{want} (tolerance {tol})")
        gaps[f"{kind}_tol_share"] = max(gaps[f"{kind}_tol_share"],
                                        abs(got - want) / tol)
        if abs(want) > atol:
            gaps[f"{kind}_rel"] = max(gaps[f"{kind}_rel"],
                                      abs(got - want) / abs(want))

    for label in cpu:
        for rc_, rg in zip(cpu[label], card[label]):
            where = f"{label} p={rc_['p']}"
            for key in ("mean_error", "std_error"):
                check("err", rg[key], rc_[key], ERR_RTOL, ERR_ATOL,
                      f"{where} {key}")
            if "cov_norm" in rc_:
                check("cov", rg["cov_norm"], rc_["cov_norm"], COV_RTOL,
                      COV_ATOL, f"{where} cov_norm")
            for a, b in zip(rg.get("cov_topk", ()), rc_.get("cov_topk", ())):
                check("cov", a, b, COV_RTOL, COV_ATOL, f"{where} cov_topk")
    return gaps


def new_sections_vs_cpu(secs):
    """The bounds and expansion sections and the compression grid of the
    --full CLI on the card against the same sections on the CPU: errors
    within ERR_*, covariance spectra within COV_*, the compression grid
    (host NumPy at m = 24) bit for bit."""
    from repro_torch.launch import harness
    t0 = time.perf_counter()
    cpu = {n: harness.run_section(n, False, "cpu")
           for n in ("bounds", "expansion")}
    cpu_s = time.perf_counter() - t0
    if secs["decoding_error"]["compression"] != \
            harness.compression(device="cpu"):
        raise AssertionError("compression grid: card rows != cpu rows")
    gaps = {"err_rel": 0.0, "cov_rel": 0.0}

    def check(kind, got, want, where):
        rtol, atol = (ERR_RTOL, ERR_ATOL) if kind == "err" else \
            (COV_RTOL, COV_ATOL)
        if not _within(got, want, rtol, atol):
            raise AssertionError(f"{where}: card {got} vs cpu {want}")
        if abs(want) > atol:
            gaps[f"{kind}_rel"] = max(gaps[f"{kind}_rel"],
                                      abs(got - want) / abs(want))

    for rg, rc_ in zip(secs["bounds"]["rows"], cpu["bounds"]["rows"]):
        for key in ("ours_optimal", "ours_fixed", "frc_optimal"):
            check("err", rg[key], rc_[key], f"bounds p={rc_['p']} {key}")
    for rg, rc_ in zip(secs["expansion"]["rows"], cpu["expansion"]["rows"]):
        check("err", rg["error"], rc_["error"], f"expansion {rc_['graph']}")
        for a, b in zip(rg["cov_top3"], rc_["cov_top3"]):
            check("cov", a, b, f"expansion {rc_['graph']} cov_top3")
    _say("harness_new_sections", bounds=secs["bounds"]["rows"],
         expansion=secs["expansion"]["rows"],
         compression_rows=len(secs["decoding_error"]["compression"]),
         compression_bitwise=True, gaps_vs_cpu=gaps, cpu_s=cpu_s,
         tolerances=dict(err=[ERR_RTOL, ERR_ATOL],
                         cov=[COV_RTOL, COV_ATOL]))


def harness_path(torch, dev):
    """The harness on the card at paper scale, step by step, each with
    its counts zeroed before and read after. Returns the summed counts."""
    import numpy as np
    import repro_torch.core as tc
    from repro_torch.core import batched_decoding as bd
    from repro_torch.core import spectral
    from repro_torch.launch import harness
    totals = dict.fromkeys(HARNESS_KERNELS, 0)

    def add(counts):
        for k_, v_ in counts.items():
            totals[k_] += v_

    # 1. the CLI, --full: every section with its paper-claim asserts
    iters = []
    orig = spectral.lanczos_lambda_max_batch

    def counting(matvec, dim, nbatch, **kw):
        calls = [0]

        def mv(V, idx):
            calls[0] += 1
            return matvec(V, idx)
        out = orig(mv, dim, nbatch, **kw)
        iters.append(calls[0])
        return out

    spectral.lanczos_lambda_max_batch = counting
    try:
        _harness_zero()
        t0 = time.perf_counter()
        summary = harness.main(["--full"])
        wall = time.perf_counter() - t0
        counts = _harness_read("cli")
    finally:
        spectral.lanczos_lambda_max_batch = orig
    secs = summary["sections"]
    n_rows = (3 * 6 + 2 * 6          # regime 1 and 2: scheme x p rows
              + 2 * 6                # adversarial: ours and frc
              + len(secs["zoo"]["rows"])
              + 3 * len(secs["bounds"]["rows"])   # three schemes a row
              + len(secs["expansion"]["rows"]))
    if counts["fused_error"] != n_rows:
        raise AssertionError(f"harness cli: {counts['fused_error']} "
                             f"fused_error launches for {n_rows} rows")
    if not iters or counts["gram_matvec_batch"] != sum(iters):
        raise AssertionError(f"harness cli: {counts['gram_matvec_batch']} "
                             f"gram_matvec_batch launches for lockstep "
                             f"iterations {iters}")
    add(counts)
    _say("harness_cli", device=summary["device"], mode=summary["mode"],
         seconds={k_: v_["seconds"] for k_, v_ in secs.items()},
         wall_s=wall, launches=counts, lockstep_iterations=iters,
         regime2=[{k_: r[k_] for k_ in ("p", "ours_optimal",
                                        "ours_optimal_cov", "ours_fixed",
                                        "ours_fixed_cov")}
                  for r in secs["decoding_error"]["rows"]
                  if r["regime"] == "m6552_d6_LPS"])
    new_sections_vs_cpu(secs)

    A = tc.expander_assignment(6552, 6, vertex_transitive=True, seed=0)

    # 2. the torch propagator at the throughput point, bitwise
    u = tc.bernoulli_uniforms(A.m, 1000, 0)
    alive = u >= 0.2
    t0 = time.perf_counter()
    want = bd._propagate_numpy(A.graph, alive)
    np_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    cold = bd._propagate_torch(A.graph, alive, None, dev)
    torch_s = time.perf_counter() - t0
    warm = bd._propagate_torch(A.graph, alive,
                               bd._propagate_torch(A.graph, u >= 0.3, None,
                                                   dev), dev)
    if not (cold.dtype == want.dtype and np.array_equal(cold, want)
            and np.array_equal(warm, want)):
        raise AssertionError("torch propagator labels differ from the "
                             "NumPy propagator's")
    _say("harness_propagator", trials=1000, m=A.m, p=0.2,
         labels_dtype=str(cold.dtype), bitwise_cold=True, bitwise_warm=True,
         numpy_s=np_s, torch_s=torch_s)

    # 3. monte_carlo_error at trials = 1000, cov off
    _harness_zero()
    t0 = time.perf_counter()
    mc = tc.monte_carlo_error(A, 0.2, trials=1000, cov=False, device=dev)
    mc_s = time.perf_counter() - t0
    counts = _harness_read("monte_carlo_error")
    mc_cpu = tc.monte_carlo_error(A, 0.2, trials=1000, cov=False,
                                  device="cpu")
    if counts["fused_error"] != 1 or any(
            not _within(mc[k_], mc_cpu[k_], ERR_RTOL, ERR_ATOL)
            for k_ in mc_cpu):
        raise AssertionError(f"monte_carlo_error: {mc} vs cpu {mc_cpu}, "
                             f"counts {counts}")
    add(counts)
    _say("harness_monte_carlo", trials=1000, p=0.2, card=mc, cpu=mc_cpu,
         seconds=mc_s, trials_per_s=1000 / mc_s, launches=counts)

    # 4. regime 2: campaign (blocked, K7b) vs per-scheme sweep_error
    # (lanczos, K7a) vs the campaign on the CPU; a repeat; one dense SVD
    entries = [(A, "optimal"), (A, "fixed")]
    _harness_zero()
    t0 = time.perf_counter()
    camp = tc.sweep_campaign(entries, HARNESS_P, trials=30, seed=0,
                             device=dev)
    camp_s = time.perf_counter() - t0
    counts = _harness_read("regime-2 campaign")
    if counts["fused_error"] != 12 or counts["gram_matvec_batch"] < 1:
        raise AssertionError(f"regime-2 campaign counts {counts}")
    add(counts)
    camp_cpu = tc.sweep_campaign(entries, HARNESS_P, trials=30, seed=0,
                                 device="cpu")
    gaps = _compare_rows(camp, camp_cpu, "regime-2 campaign")
    _harness_zero()
    again = tc.sweep_campaign(entries, HARNESS_P, trials=30, seed=0,
                              device=dev)
    add(_harness_read("regime-2 repeat"))
    if again != camp:
        raise AssertionError("the regime-2 campaign on the card did not "
                             "repeat bit for bit")
    _harness_zero()
    seq = {f"{A.name}:{m_}": tc.sweep_error(
        A, HARNESS_P, trials=30, method=m_, seed=0, cov_method="lanczos",
        device=dev) for _, m_ in entries}
    counts = _harness_read("per-scheme sweep_error")
    if counts["fused_error"] != 12 or counts["gram_matvec"] < 1:
        raise AssertionError(f"sweep_error counts {counts}")
    add(counts)
    gaps_seq = _compare_rows(seq, camp_cpu, "per-scheme sweep_error")
    alphas = tc.batched_alpha(A, u[:30] >= 0.3, method="fixed", p=0.3,
                              device=dev)
    scaled = alphas * tc.step_weights.debias_scale(alphas)
    dense = tc.covariance_spectral_norm(scaled, method="dense", device=dev)
    blocked = camp[f"{A.name}:fixed"][-1]["cov_norm"]
    if not _within(blocked, dense, COV_RTOL, COV_ATOL):
        raise AssertionError(f"blocked cov norm {blocked} vs dense SVD "
                             f"{dense}")
    _harness_zero()
    topk = tc.sweep_campaign(entries, HARNESS_P, trials=30, seed=0,
                             cov=False, cov_topk=4, device=dev)
    counts = _harness_read("cov_topk campaign")
    if counts["gram_matvec_block"] < 1:
        raise AssertionError(f"cov_topk campaign counts {counts}")
    add(counts)
    topk_cpu = tc.sweep_campaign(entries, HARNESS_P, trials=30, seed=0,
                                 cov=False, cov_topk=4, device="cpu")
    gaps_topk = _compare_rows(topk, topk_cpu, "cov_topk campaign")
    _say("harness_regime2", trials=30, campaign_s=camp_s,
         gaps_vs_cpu=gaps, sweep_error_gaps_vs_cpu=gaps_seq,
         topk_gaps_vs_cpu=gaps_topk, dense_svd=dense, blocked=blocked,
         repeat_bitwise=True, tolerances=dict(
             err=[ERR_RTOL, ERR_ATOL], cov=[COV_RTOL, COV_ATOL]))
    return totals


def harness_breakdown(torch, dev):
    """The regime-2 campaign's wall time by stage, after a warm-up pass:
    host decode, the K6 stage (upload, kernel, download), the
    covariance stage (host Lanczos around the K7b launches); and the
    device time the profiler records inside the last two."""
    import numpy as np
    import repro_torch.core as tc
    from repro_torch.core import sweep
    from repro_torch.kernels.batched_alpha import ops as ba_ops
    A = tc.expander_assignment(6552, 6, vertex_transitive=True, seed=0)
    u = tc.bernoulli_uniforms(A.m, 30, 0)
    masks = np.stack([u >= p for p in HARNESS_P])
    out = {}

    def decode():
        return [sweep._campaign_alphas(
            tc.CampaignEntry(A, m_), masks, list(HARNESS_P),
            backend="auto", warm_start=True, device=dev)
            for m_ in ("optimal", "fixed")]
    alphas = decode()                      # warm-up: caches, first calls
    t0 = time.perf_counter()
    alphas = decode()
    out["decode_host_s"] = time.perf_counter() - t0

    def device_stages():
        slices = []
        for al in alphas:
            for a in al:
                _, scale = ba_ops.fused_error(a, device=dev)
                slices.append(a * scale)
        t1 = time.perf_counter()
        tc.covariance_spectral_norm_batch(np.stack(slices), device=dev)
        torch.cuda.synchronize()
        return t1

    device_stages()                        # warm-up: lazy kernel loads
    t0 = time.perf_counter()
    t1 = device_stages()
    out["k6_stage_s"] = t1 - t0
    out["cov_stage_s"] = time.perf_counter() - t1
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        device_stages()
        prof_wall = time.perf_counter() - t0
    from torch.autograd import DeviceType
    by_name = {}
    for e in prof.key_averages():
        # device-side events only (kernels, copies): an operator's row
        # repeats the time of the kernels it launched
        if e.device_type != DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        if us:
            by_name[e.key] = by_name.get(e.key, 0.0) + us / 1e6
    device_s = sum(by_name.values())
    out.update(profiled_wall_s=prof_wall,
               device_s=device_s if device_s else "not measured",
               device_busy_share=(device_s / prof_wall if device_s
                                  else "not measured"),
               device_s_by_name=dict(sorted(by_name.items(),
                                            key=lambda kv: -kv[1])[:8]))
    _say("harness_breakdown", arch="m6552_d6_LPS trials=30 regime 2",
         **out)


def step_profile():
    """The serving pool step's device time by kernel family
    (``repro_torch.launch.step_profile --full-config``)."""
    from repro_torch.launch import step_profile as sp
    out = sp.main(["--full-config"])
    fam = out["kernel_families_ms_per_step"]
    _say("step_profile", arch=out["arch"], pos=out["pos"],
         decode_attention_ms_per_step=fam.get("decode_attention"),
         rmsnorm_ms_per_step=fam.get("rmsnorm"),
         host_ms_per_step=out["host_ms_per_step"],
         graph_ms_per_step=out["graph_ms_per_step"],
         device_ms_per_step=out["device_ms_per_step"])


def plans(torch, dev):
    """The launch plans the redesigned kernels chose at the path shapes:
    K1's and K6's threads a row, K2's chunks, K7's strips, clusters and
    CTAs."""
    from repro_torch.kernels import _launch
    from repro_torch.kernels.batched_alpha import kernel as ba_k
    from repro_torch.kernels.decode_attention import kernel as da_k
    from repro_torch.kernels.rmsnorm import kernel as rn_k
    from repro_torch.kernels.spectral_matvec import kernel as sm_k
    sms = _launch.sm_count(dev)
    rn = {f"rows={rows} d=4096 itemsize={size}":
          rn_k.plan_rows(rows, 4096, size, sms)._asdict()
          for rows, size in ((8, 2), (8, 4), (8192, 2))}
    ba = {f"trials={T} n=2184": ba_k.plan_error(T, 2184, sms)._asdict()
          for T in (30, 1000)}
    da = {f"B={B} H=32 KVH=8 S={S} Dh={Dh} {name}":
          da_k.plan_chunks(B, 32, 8, S, Dh, size, sms)._asdict()
          for B, S, Dh, size, name in ((8, 1024, 128, 2, "bf16"),
                                       (8, 32768, 128, 2, "bf16"),
                                       (8, 1024, 160, 2, "bf16"),
                                       (8, 1024, 160, 4, "f32"))}
    da["CTAs at S=1024 (every chunk)"] = \
        da["B=8 H=32 KVH=8 S=1024 Dh=128 bf16"]["groups"] * \
        da["B=8 H=32 KVH=8 S=1024 Dh=128 bf16"]["chunks"]
    sm = {f"B={B} R={R} k={k} bv={bv}":
          sm_k.plan_gram(B, R, k, bv, sms)._asdict()
          for B, R, k, bv in ((1, 2184, 30, 1), (1, 2184, 30, 8),
                              (1, 2184, 1000, 1), (1, 2184, 1000, 8),
                              (12, 2184, 30, 1), (12, 2184, 1000, 1))}
    _say("plans", sms=sms, rmsnorm=rn, fused_error=ba,
         decode_attention=da, gram_matvec=sm)


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

    phases = {}
    t0 = time.perf_counter()
    per = build.build()
    phases["build"] = time.perf_counter() - t0
    _say("build", seconds=phases["build"], per_source=per,
         arch="sm_90a", directory=os.path.relpath(build.BUILD_DIR, ROOT))
    for name in build.SOURCES:
        _say("ptxas", name=name,
             report=build.compiler_report(name).splitlines())
    t0 = time.perf_counter()

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
    check_decode_attention(torch, dev, 8, 32, 8, 1024, 128, "bfloat16",
                           [144] * 8, "serving position B=8 S=1024 "
                           "every length 144")
    check_decode_attention(torch, dev, 8, 32, 8, 32768, 128, "bfloat16",
                           [32768] * 8, "decode_32k B=8 S=32768 full")
    check_decode_attention(torch, dev, 8, 20, 20, 1024, 128, "bfloat16",
                           rng.integers(1, 1025, 8).tolist(),
                           "G=1 B=8 H=KVH=20 S=1024")
    check_decode_attention(torch, dev, 8, 32, 8, 1024, 128, "float32",
                           rng.integers(1, 1025, 8).tolist(),
                           "B=8 H=32 KVH=8 S=1024 f32")
    # the other families' shapes: pixtral-12b's head dim 160 (G = 4, the
    # tensor cores in bf16, the CUDA cores in f32), zamba2-1.2b's and
    # seamless-m4t's 64 and deepseek-moe-16b's 128 at G = 1
    for dtype in ("bfloat16", "float32"):
        check_decode_attention(torch, dev, 8, 32, 8, 1024, 160, dtype,
                               rng.integers(1, 1025, 8).tolist(),
                               f"pixtral B=8 H=32 KVH=8 S=1024 Dh=160 "
                               f"ragged {dtype}")
    check_decode_attention(torch, dev, 8, 32, 32, 1024, 64, "bfloat16",
                           rng.integers(1, 1025, 8).tolist(),
                           "zamba2 B=8 H=KVH=32 S=1024 Dh=64 ragged")
    check_decode_attention(torch, dev, 8, 16, 16, 1024, 128, "bfloat16",
                           rng.integers(1, 1025, 8).tolist(),
                           "deepseek-moe B=8 H=KVH=16 S=1024 Dh=128 ragged")
    for d in (1024, 2048, 5120):
        check_rmsnorm(torch, dev, (8, 1, d), "bfloat16", f"(8,1,{d})")
    check_beyond_length(torch, dev)
    rows.update(combine_checks(torch, dev))
    rows.update(harness_kernel_checks(torch, dev))
    phases["kernels"] = time.perf_counter() - t0

    # ---- the serving path: counts zeroed just before, read just after
    t0 = time.perf_counter()
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
    phases["serve"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    step_profile()
    phases["step_profile"] = time.perf_counter() - t0

    # ---- the training path: four runs, each zeroed before, read after
    t0 = time.perf_counter()
    train_counts = train_runs(torch, dev)
    phases["train"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    f32_manual_vs_autograd(torch, dev)
    phases["f32_step"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    for name, v in elastic_run(torch, dev).items():
        train_counts[name] += v
    phases["train_elastic"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    for name, v in zoo_runs(torch, dev).items():
        train_counts[name] += v
    phases["train_zoo"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    runtime_at_scale(torch, dev)
    phases["runtime_at_scale"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    family_counts = families(torch, dev)
    phases["families"] = time.perf_counter() - t0

    # ---- the harness path: each step zeroed before, read after
    t0 = time.perf_counter()
    harness_counts = harness_path(torch, dev)
    phases["harness"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    harness_breakdown(torch, dev)
    phases["harness_breakdown"] = time.perf_counter() - t0
    _say("phases", seconds=phases)
    plans(torch, dev)

    launches = {name: launches.get(name, 0) + train_counts[name]
                + family_counts.get(name, 0) for name in train_counts}
    launches.update(
        fused_error=harness_counts["fused_error"],
        gram_matvec=(harness_counts["gram_matvec"]
                     + harness_counts["gram_matvec_block"]),
        gram_matvec_batch=harness_counts["gram_matvec_batch"])
    if min(launches.values()) < 1:
        raise AssertionError(f"a kernel of the path never launched: "
                             f"{launches}")
    kernels = []
    for name, source, replaces in (
            ("rmsnorm", "rmsnorm", "src/repro/kernels/rmsnorm/kernel.py:54"),
            ("decode_attention", "decode_attention",
             "src/repro/kernels/decode_attention/kernel.py:90"),
            ("coded_combine", "coded_combine",
             "src/repro/kernels/coded_combine/kernel.py:183"),
            ("quantized_combine", "coded_combine",
             "src/repro/kernels/coded_combine/kernel.py:91"),
            ("packed_sign_combine", "coded_combine",
             "src/repro/kernels/coded_combine/kernel.py:158"),
            ("fused_error", "batched_alpha",
             "src/repro/kernels/batched_alpha/kernel.py:58"),
            ("gram_matvec", "spectral_matvec",
             "src/repro/kernels/spectral_matvec/kernel.py:75"),
            ("gram_matvec_batch", "spectral_matvec",
             "src/repro/kernels/spectral_matvec/kernel.py:127")):
        r = rows[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": os.path.relpath(build.SOURCES[source], ROOT),
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
