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
   quantized_combine also at the elastic run's 3 rows of D = 104,857,600,
   and all three at the distributed path's rows a rank (2, and a
   streaming chunk of 1) of D = 104,857,600. The int8 and packed rows
   carry their launch plan (``plan_combine``: the bulk route from 2^24
   positions, the lane route below, or the generic kernels), the time of
   both vector routes on the same folded weights (``bulk_ms``,
   ``lane_ms``, each bitwise equal to the planned launch), the
   output's write
   alone (``copy_ms``, packed) or the int8-to-float32 copy of one row
   (``copy_ms``, int8 at one row), and quantized_combine at one row the
   PyTorch call ``torch.mul(q[0], u0)`` (``library_ms``, equal to the
   kernel); then both at their edges on exact inputs (``EDGE_SHAPES``:
   several tiles and a tail on each route) and
   a payload one byte off a 16-byte boundary, which must take the
   generic route and give the aligned launch's bits.
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
   (``repro_torch.launch.step_profile --full-config``, over
   ``PROFILE_STEPS`` traced steps, as the families' profiles).
4a. Long sequences (``long_attention``, ``prefill_32k``): one
   granite-width attention layer (H = 32, KVH = 8, Dh = 128, bf16,
   B = 1) forward and backward, at 4,096 tokens the blockwise output and
   q, k, v gradients within ``BF16_TOL`` of the plain version's (the
   whole-score softmax), at 8,192 and 16,384 the peak memory above the
   inputs, the 16k one under 2.5 times the 8k one; then granite-3-8b at
   full config prefills one 32,768-token sequence through
   ``coded_train.make_prefill_step`` (finite logits; seconds and peak
   bytes printed) and ``forward_hidden``'s first 4,096 positions are
   held to a 4,096-token run's within ``BF16_TOL``.
5. The training path: ``repro_torch.launch.train.main`` at granite-3-8b's
   full width with 2 layers (bf16 activations, float32 parameters and
   AdamW at lr 1e-4), m = 4 machines, expander d = 2, Bernoulli
   p = 0.2, sequences of 256 tokens in blocks of 4, 12 steps, four
   runs: the dedup path with no compression, with int8 and with
   sign_packed, and the manual collective. Launch counts are zeroed
   before each run and read after: one combine launch per parameter
   leaf and step (12 leaves: the LM head is untied) on the run that uses
   that combine and none elsewhere, and 9 rmsnorm launches per forward
   and backward (the forward's 5, and the 4 of the two layers the
   backward recomputes: ``models.model`` rematerialises each layer).
   The driver asserts that the loss decreased. Each run is
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
   launch per leaf and step across both generations, 9 rmsnorm launches
   per block's forward and backward, the plain run's loss stream within
   ``LOSS_RTOL`` and
   ``rebuild_s`` printed. Then the scheme zoo and adaptive decoding: the
   affine plane AG(2,2) (``--scheme bibd --replication 3 --machines 6``,
   n = 4 blocks) under sign_packed, and cyclic-MDS under a Markov
   process with ``--adaptive adaptive`` (its ``adaptive`` block
   printed), each against its plain run. Then the coding runtime at
   m = 6552 with ``device="cuda"`` (its debias batch through the torch
   propagator) and ``device="cpu"``: equal scales. Each phase's seconds
   are printed. Right after the four runs, ``remat``: granite-3-8b at
   full width in float32, ``train_loss`` forward and backward over one
   4,096-token sequence at 2 and 4 layers with the model's
   rematerialisation on and off (``M._REMAT``): the peak above the
   parameters and their preallocated gradients must grow per added
   layer at most half as fast with remat as without; the line also
   carries the dedup run's ms a step and peak.
5a. The distributed runtime (``distributed``), at the training path's
   width (granite-3-8b, 2 layers, ``DIST_ARGS``: 8 steps, m = 4). On one
   ``nccl`` rank in process: the manual collective materialising, then
   streaming with chunks of 1 and 2 machines, then int8 and sign_packed
   streaming with chunks of 1 (counts zeroed before each run and read
   after: one combine launch a leaf and chunk, 9 rmsnorm launches a
   machine's forward and backward); the streaming loss streams within
   rtol 2e-4 /
   atol 2e-5 of the materialising one (the reference's reassociation
   tolerance) and their peak ``max_memory_allocated`` strictly under
   its; one SGD step's combined gradient, streaming against
   materialising, within the same tolerance; one AdamW step of the dedup
   path with ``FSDP`` at one rank and without, bit for bit (deterministic
   algorithms on). Then two ``gloo`` ranks spawned on the one card
   (machines [0, 2) and [2, 4), K3 on each, the sum through gloo): their
   loss stream within the same tolerance of the one-rank run; and, in
   the same spawn, chaos on the dedup path (``--chaos kill:1@3``, no
   sampled stragglers, 8 steps: 4 blocks split 2 a rank, then 3 kept
   whole on both): the ``chaos`` object (but ``rebuild_s``) equal to a
   one-process run's, the losses within rtol 1e-4, 9 rmsnorm launches a
   step on each rank. The
   ``distributed`` line prints ms a step, peak GB, all_reduce bytes a
   step and launch counts per run.
5a'. The model axis (``model_axis``), executed by
   ``dist.tensor_parallel``, on two ``gloo`` ranks spawned on the one
   card (NCCL refuses two ranks on one device). Training on the layout
   (data, model) = (1, 2) at the training path's width (granite-3-8b,
   2 layers, ``DIST_ARGS``, float32 activations): the dedup path with
   no compression, int8 and sign_packed, each rank holding its shards
   of the leaves ``safe_param_specs`` splits; each loss stream within
   rtol 1e-4 of the one-process run of the same arguments, each rank's
   resident parameter bytes within 2 % of ``bytes_per_device``, K1 (9 a
   step and block), K4 and K5 (one launch a leaf and step, on the shard
   rows) counts on each rank. Serving granite-3-8b at full config (40
   layers, bf16) through ``launch.serve.main`` on (1, 2) (16 query and
   4 KV heads a rank through K2, the vocabulary split) and on (2, 1)
   (4 slots a rank): ``--check`` passes on each; the ranks'
   teacher-forced logits along the one-process streams within
   ``MA_LOGIT_ATOL`` of the one process's, and the streams equal the
   one-process engine's up to each request's first position whose
   one-process top-2 logit gap is at most twice the largest logit
   difference seen (a closer pair is the only place the argmax can
   change), which is printed with the number of tokens the rule held
   equal (few where the ranks' rounding is large: the teacher-forced
   bound is then the check that counts); K1 and K2 at 81 and 40 a pool
   step on each rank. The kernels phase holds K2 at that 16/4-head shape
   against its plain version. In the same spawn, zamba2-1.2b and
   xlstm-1.3b at their published widths with Mamba2's and the xLSTM's
   split heads run where they lie (``MA_FAMILIES``): training on (1, 2)
   (float32, ``MA_FAMILY_STEPS`` steps, dedup and int8; zamba2 cut to 2
   Mamba2 layers and one shared attention insertion, xlstm to 8 layers,
   one super-block) with each loss stream within rtol 1e-4 of one
   process's, resident bytes as placed, K1 and K4 counts on each rank and
   nothing all-gathered but Mamba2's B | C | dt features; serving at
   full config (38 and 48 layers, in float32: in bf16 zamba2's rounding
   alone moves its logits by their size) on (1, 2) with ``--check``, the
   teacher-forced logits and streams held as granite's, K1 and K2
   counts a pool step on each rank (zamba2's shared attention at 16
   query over 16 KV heads a rank, which the kernels phase also holds K2
   at). Each family's ``model_axis_family`` line prints the model
   group's bytes a step and a pool step by kind beside the bytes gather
   at use moved a pass (computed from the leaf shapes), peak GB a rank,
   ms a step and tokens/s.
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
7. The benchmark suite (``repro_torch.benchmarks.run --fast``) into a
   temporary directory: every kernel at its path shapes against its
   plain version, a library call and its bound; the serving engine's
   tokens/s and TTFT (granite-3-8b full config, three runs, streams
   pinned); the training paths' ms per step, comm bytes and peak memory
   (granite-3-8b at 2 layers) and the chaos row; decoded trials/s and
   the regime-2 grid at m = 6552. Each report must name the card. Then
   the dry-run's specs for every arch and shape on both production
   layouts under both placements (yi-34b's FSDP parameter bytes at most
   an eighth of its replicated ones), one full dry-run of granite-3-8b
   ``train_4k`` (it must fit the card), and the argument-bytes
   cross-check: the dry-run's bytes of the train bench's dedup step
   within 2 % of what the allocator holds just before its first step.
8. The launch plans of the six redesigned kernels at the path shapes
   (rmsnorm's and fused_error's threads a row, decode_attention's
   chunks, gram_matvec's strips and clusters, the int8 and packed
   combines' routes, tiles and stages at both path widths; each timed
   K1, K4, K5 and K6 row also carries its plan), a
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
RANK_ROWS = (2, 1)
# The int8 and packed combines' edges (rows, D), on exact inputs, on each
# route: generic (no whole 16-byte rows: 1,000,003 and 3 * 4096 + 5),
# lane (int8 3 * 4096 + 16; packed 1,048,701 ends 3 short of a whole
# float4) and the bulk route's short last tile (16 int8 positions past
# 2^24; 125 packed ones at 16,777,341). The float64 NumPy oracle up to
# ORACLE_MAX_D.
EDGE_SHAPES = ((1, 1_000_003), (2, 3 * 4096 + 5), (1, 3 * 4096 + 16),
               (2, 1_048_701), (1, (1 << 24) + 16), (2, 16_777_341))
ORACLE_MAX_D = 17_000_000
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
# Steps each pool-step profile traces (the tool's default is 20): a
# profile's time grows with the traced steps, whose trace the host
# processes, and 8 keep the script inside its time limit.
PROFILE_STEPS = 8


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
    partial sum is exact; more than one row carries a dead row (w = 0),
    one row is live."""
    g = torch.Generator(device=dev).manual_seed(seed)
    if exact:
        w = 2.0 ** torch.randint(-3, 3, (n,), generator=g,
                                 device=dev).float()
        scales = 2.0 ** torch.randint(-4, 2, (n,), generator=g,
                                      device=dev).float()
    else:
        w = torch.rand(n, generator=g, device=dev) * 2
        scales = torch.rand(n, generator=g, device=dev) + 0.01
    if n > 1:   # a dead row, and at one row a live one
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
        if kind != "coded_combine" and d <= ORACLE_MAX_D:
            xs, ss, ws = (a.cpu().numpy() for a in (x, scales, w))
            oracle = (ref.quantized_combine_np(xs, ss, ws)
                      if kind == "quantized_combine"
                      else ref.packed_sign_combine_np(xs, ss, ws, d))
            if not np.array_equal(out.cpu().numpy(), oracle):
                raise AssertionError(f"{label}: kernel differs from the "
                                     "float64 NumPy oracle")
        # the dead row's payload must not matter: replace it, same bits
        if n > 1:
            x2 = x.clone()
            x2[n // 2] = x2[0]
            if not torch.equal(fn(x2, *args[1:]), out):
                raise AssertionError(f"{label}: a dead row changed the "
                                     "output")
    else:
        _compare(torch, out, want, COMBINE_TOL, label)
    row = dict(kernel=kind, shape=label, dtype=dtype, max_abs_err=err,
               exact=exact)
    if kind != "coded_combine":
        from repro_torch.kernels import _launch
        from repro_torch.kernels.coded_combine import kernel
        row["plan"] = _plan(kernel, "plan_combine", kind.split("_")[0], n,
                            d, x.element_size(), _launch.sm_count(dev))
    if time_it:
        from repro_torch.launch.timing import graph_ms
        reps = 4 if d > 10_000_000 else 20
        out_bytes = d * out.element_size()
        nbytes = x.numel() * x.element_size() + out_bytes + 8 * n
        bound, by = _bound_ms(nbytes, 2 * n * d, "float32")
        library = None
        if kind == "coded_combine":
            wl = w.to(x.dtype)
            library = lambda: torch.mv(x.t(), wl)  # noqa: E731
        elif kind == "quantized_combine" and n == 1:
            # one PyTorch call computes K4 at one row: an int8 row times
            # a 0-dim float32 tensor promotes to float32, u * q exactly
            u0 = w[0] * scales[0]
            library = lambda: torch.mul(x[0], u0)  # noqa: E731
            if not torch.equal(library(), out):
                raise AssertionError(f"{label}: torch.mul(q[0], u0) "
                                     "differs from the kernel")
        # one PyTorch call that moves the same bytes, a yardstick: K4's
        # int8-to-float32 copy of its one row, K5's output written alone
        if kind != "coded_combine":
            o = torch.empty_like(out)
            if kind == "packed_sign_combine":
                row["copy_ms"] = graph_ms(o.zero_, reps=reps)
            elif n == 1:
                row["copy_ms"] = graph_ms(lambda: o.copy_(x[0]), reps=reps)
            row.update(_route_ms(torch, dev, kind, x, scales, w, d, out,
                                 reps))
        row.update(bound_ms=bound, bound_by=by, **_times(
            torch, lambda: fn(*args), lambda: plain(*args), library,
            reps=reps))
    _say("kernel", **row)
    return row


def _route_ms(torch, dev, kind, x, scales, w, d, out, reps):
    """Both vector routes of the int8 and packed combines, bulk and lane,
    at the same inputs and folded weights (the kernel's binding, without
    the wrapper's ``w * scales``): each bitwise equal to the planned
    launch, and its device ms (``bulk_ms``, ``lane_ms``). Empty where the
    checkout being timed has no such routes or the shape takes the
    generic kernels."""
    from repro_torch.kernels import _launch
    from repro_torch.kernels.coded_combine import kernel
    if not hasattr(kernel, "plan_lane") or x.dtype == torch.float32:
        return {}
    short, n, sms = kind.split("_")[0], x.shape[0], _launch.sm_count(dev)
    if kernel.plan_combine(short, n, d, 1, sms).route == "generic":
        return {}
    from repro_torch.launch.timing import graph_ms
    u = w.float() * scales.float()
    row = {}
    for plan in (kernel.plan_bulk(short, n, d, sms),
                 kernel.plan_lane(short, n, d, sms)):
        if plan is None:
            continue
        if kind == "quantized_combine":
            call = lambda: kernel.quantized_combine(  # noqa: E731
                x, u, plan)
        else:
            call = lambda: kernel.packed_sign_combine(  # noqa: E731
                x, u, d, plan)
        if not torch.equal(call(), out):
            raise AssertionError(f"{kind} n={n} D={d}: the {plan.route} "
                                 "route differs from the planned launch")
        row[f"{plan.route}_ms"] = graph_ms(call, reps=reps)
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
    # the distributed path's rows a rank: two machines (two ranks at
    # m = 4) and a streaming chunk of one
    for n in RANK_ROWS:
        for kind, dt in (("coded_combine", "float32"),
                         ("quantized_combine", "int8"),
                         ("packed_sign_combine", "uint8")):
            check_combine(torch, dev, kind, PATH_D[0], dt, exact=False, n=n)
            check_combine(torch, dev, kind, PATH_D[0], dt, exact=True,
                          time_it=False, n=n)
    for kind, dt in (("quantized_combine", "int8"),
                     ("packed_sign_combine", "uint8")):
        for n, d in EDGE_SHAPES:
            check_combine(torch, dev, kind, d, dt, exact=True,
                          time_it=False, n=n)
        check_misaligned_combine(torch, dev, kind, 2, 1 << 20)
    check_width_mismatch(torch, dev)
    return rows


def check_misaligned_combine(torch, dev, kind, n, d):
    """A payload one byte past a 16-byte boundary is planned onto the
    generic kernels and gives the plain version's and the aligned
    launch's bits."""
    from repro_torch.kernels.coded_combine import kernel, ops, ref
    x, scales, w = _combine_inputs(torch, dev, kind, d, "int8", True,
                                   seed=11, n=n)
    flat = torch.empty(x.numel() + 16, dtype=torch.uint8, device=dev)
    q = flat[1:1 + x.numel()].view(x.dtype).view(x.shape)
    q.copy_(x)
    short = kind.split("_")[0]
    plan = kernel._plan_for(short, q, d)
    extra = (d,) if kind == "packed_sign_combine" else ()
    fn, plain = getattr(ops, kind), getattr(ref, kind)
    out = fn(q, scales, w, *extra)
    same = (torch.equal(out, fn(x, scales, w, *extra))
            and torch.equal(out, plain(q, scales, w, *extra)))
    if plan.route != "generic" or not same:
        raise AssertionError(f"{kind} n={n} D={d} one byte off: plan "
                             f"{plan}, equal to the plain version and the "
                             f"aligned launch: {same}")
    _say("kernel_check", name=f"{kind} n={n} D={d} payload one byte off "
         "16 takes the generic route", plan=plan._asdict(), ok=True)


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
    the plain versions; returns the kernel runs' launch counts and the
    dedup run's ms a step and peak."""
    from repro_torch.configs import get_config
    from repro_torch.models.convert import param_shapes
    cfg = get_config("granite-3-8b").with_overrides(n_layers=2)
    n_leaves = len(param_shapes(cfg))   # one combine launch per leaf
    steps = int(TRAIN_ARGS[TRAIN_ARGS.index("--steps") + 1])
    totals, dedup = {}, None
    for label, extra in TRAIN_RUNS:
        s, counts, wall, peak = _run_train(torch, cfg, extra, None)
        manual = "manual" in extra
        codec = extra[extra.index("--compress") + 1] \
            if "--compress" in extra else "none"
        rows = 4   # n blocks on the dedup path, m machines on the manual
        forwards = rows if (manual or codec != "none") else 1
        want = {"rmsnorm": _train_norms(cfg) * forwards * steps,
                "decode_attention": 0,
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
        if label == "dedup none":
            dedup = {"ms_per_step": s["loop_s"] / steps * 1e3,
                     "peak_mem_gb": peak / 1e9}
    return totals, dedup


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
    want = {"rmsnorm": _train_norms(cfg) * rows, "decode_attention": 0,
            "coded_combine": 0,
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
        want = {"rmsnorm": _train_norms(cfg) * forwards * steps,
                "decode_attention": 0,
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
# ---------------------------------------------------------------------------
# Long sequences: blockwise attention (memory linear in S) and the
# rematerialised training forward
# ---------------------------------------------------------------------------

# granite-3-8b's attention layer: B = 1, H = 32, KVH = 8, Dh = 128, bf16
LONG_ATTN = dict(B=1, H=32, KVH=8, Dh=128)
LONG_CHECK_S = 4096                 # blockwise against the plain version
LONG_MEM_S = (8192, 16384)          # peaks above the inputs
LONG_PEAK_RATIO = 2.5               # the 16k peak under 2.5x the 8k one
# blockwise against the plain version in bf16, forward and gradients:
# |got - want| <= BF16_TOL (max(1, max |want|) + |want|)
BF16_TOL = 3e-2
PREFILL_S, PREFILL_PREFIX = 32768, 4096
REMAT_S = 4096                      # tokens of the remat measurement
REMAT_LAYERS = (2, 4)
REMAT_MAX_SHARE = 0.5   # the per-layer peak increment, remat / no remat


def _attn_inputs(torch, dev, S, seed):
    g = torch.Generator(dev).manual_seed(seed)
    B, H, KVH, Dh = (LONG_ATTN[k] for k in ("B", "H", "KVH", "Dh"))

    def r(*shape):
        return torch.randn(*shape, generator=g, device=dev,
                           dtype=torch.bfloat16).requires_grad_(True)
    return r(B, S, H, Dh), r(B, S, KVH, Dh), r(B, S, KVH, Dh), \
        torch.randn(B, S, H, Dh, generator=g, device=dev,
                    dtype=torch.bfloat16)


def long_attention(torch, dev):
    """One granite-width attention layer (bf16), forward and backward:
    at 4,096 tokens the blockwise output and q, k, v gradients against
    the plain version's (``attention_ref``, whole scores) within
    ``BF16_TOL``; at 8,192 and 16,384 the peak memory above the inputs,
    the 16k peak under ``LONG_PEAK_RATIO`` times the 8k one (linear, not
    quadratic, in S)."""
    from repro_torch.models import attention as A
    q, k, v, d_out = _attn_inputs(torch, dev, LONG_CHECK_S, 0)
    res = {}
    for name, fn in (("blockwise", A.blockwise_attention),
                     ("plain", A.attention_ref)):
        q.grad = k.grad = v.grad = None
        out = fn(q, k, v, causal=True, window=None)
        out.backward(d_out)
        res[name] = [out.detach(), q.grad, k.grad, v.grad]
    errs = {}
    for what, got, want in zip(("out", "dq", "dk", "dv"), res["blockwise"],
                               res["plain"]):
        got, want = got.float(), want.float()
        scale = max(1.0, want.abs().max().item())
        err = (got - want).abs()
        if not bool((err <= BF16_TOL * (scale + want.abs())).all()):
            raise AssertionError(f"long_attention S={LONG_CHECK_S} {what}: "
                                 f"max |err| {err.max().item()} beyond "
                                 f"{BF16_TOL} (scale {scale})")
        errs[what] = err.max().item()
    del q, k, v, d_out, res
    peaks, secs = {}, {}
    for S in LONG_MEM_S:
        _free(torch)
        q, k, v, d_out = _attn_inputs(torch, dev, S, 1)
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = A.blockwise_attention(q, k, v, causal=True)
        out.backward(d_out)
        torch.cuda.synchronize()
        secs[S] = time.perf_counter() - t0
        peaks[S] = torch.cuda.max_memory_allocated() - base
        del q, k, v, d_out, out
    ratio = peaks[LONG_MEM_S[1]] / peaks[LONG_MEM_S[0]]
    if not ratio < LONG_PEAK_RATIO:
        raise AssertionError(f"long_attention: the {LONG_MEM_S[1]} peak is "
                             f"{ratio:.3f}x the {LONG_MEM_S[0]} one "
                             f"(>= {LONG_PEAK_RATIO})")
    _free(torch)
    _say("long_attention", **LONG_ATTN, dtype="bfloat16",
         check_s=LONG_CHECK_S, max_abs_err=errs, tol=BF16_TOL,
         peak_bytes_above_inputs={str(S): peaks[S] for S in LONG_MEM_S},
         peak_ratio=ratio, fwd_bwd_s={str(S): secs[S] for S in LONG_MEM_S})


def prefill_32k(torch, dev):
    """granite-3-8b at full config (40 layers, bf16 weights) prefills one
    32,768-token sequence through ``coded_train.make_prefill_step``:
    finite logits, its seconds and peak bytes; then the first 4,096
    positions of its ``forward_hidden`` output against a 4,096-token
    run's, within ``BF16_TOL`` (causal attention makes them the same
    function)."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.dist import coded_train
    from repro_torch.models import model as M
    cfg = get_config("granite-3-8b")
    _free(torch)
    params = M.cast_block_weights(M.init_params(cfg, seed=0, device=dev),
                                  cfg)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (1, PREFILL_S))).to(dev)
    # the prefill's own hidden states, kept by a wrapper around
    # forward_hidden (one 32k pass, ~50 s, instead of two)
    hidden = []
    forward_hidden = M.forward_hidden
    M.forward_hidden = lambda *a, **k: hidden.append(
        forward_hidden(*a, **k)) or hidden[-1]
    weights = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        with torch.no_grad():
            logits = coded_train.make_prefill_step(cfg)(params,
                                                        {"tokens": tokens})
        torch.cuda.synchronize()
    finally:
        M.forward_hidden = forward_hidden
    secs = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    if tuple(logits.shape) != (1, cfg.padded_vocab()) or \
            not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"prefill_32k: logits {tuple(logits.shape)}, "
                             "not all finite")
    (long,) = hidden
    long = long[:, :PREFILL_PREFIX]
    with torch.no_grad():
        short = M.forward_hidden(params, tokens[:, :PREFILL_PREFIX], cfg)
    long, short = long.float(), short.float()
    scale = max(1.0, short.abs().max().item())
    err = (long - short).abs()
    if not bool((err <= BF16_TOL * (scale + short.abs())).all()):
        raise AssertionError(f"prefill_32k: the first {PREFILL_PREFIX} "
                             f"positions differ from a {PREFILL_PREFIX}-"
                             f"token run by {err.max().item()}")
    _say("prefill_32k", arch=cfg.name, n_layers=cfg.n_layers,
         dtype=cfg.dtype, tokens=PREFILL_S, seconds=secs,
         peak_bytes=peak, peak_bytes_above_weights=peak - weights,
         prefix=PREFILL_PREFIX, prefix_max_abs_err=err.max().item(),
         prefix_bitwise=bool(torch.equal(long, short)), tol=BF16_TOL)
    del params, logits, long, short
    _free(torch)


def remat(torch, dev, dedup):
    """granite-3-8b at full width in float32: ``train_loss`` forward and
    backward over one 4,096-token sequence at 2 and 4 layers, with the
    model's rematerialisation on and off (``M._REMAT``). Peaks above the
    parameters and their preallocated gradients; the increment per added
    layer with remat at most ``REMAT_MAX_SHARE`` of the one without.
    ``dedup`` is the train phase's dedup run (ms a step, peak)."""
    import numpy as np
    from repro_torch import tree as T
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    base_cfg = get_config("granite-3-8b").with_overrides(dtype="float32")
    toks = np.random.default_rng(0).integers(0, base_cfg.vocab_size,
                                             (1, REMAT_S + 1))
    batch = {"tokens": torch.from_numpy(toks[:, :-1]).to(dev),
             "labels": torch.from_numpy(toks[:, 1:]).to(dev)}
    peaks, secs, losses = {}, {}, {}
    for L in REMAT_LAYERS:
        cfg = base_cfg.with_overrides(n_layers=L)
        _free(torch)
        params = M.init_params(cfg, seed=0, device=dev)
        for p in T.leaves(params):
            p.requires_grad_(True)
            p.grad = torch.zeros_like(p)
        for on in (True, False):
            for p in T.leaves(params):
                p.grad.zero_()
            M._REMAT = on
            try:
                base = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
                t0 = time.perf_counter()
                loss = M.train_loss(params, batch, cfg)
                loss.backward()
                torch.cuda.synchronize()
                secs[(L, on)] = time.perf_counter() - t0
                peaks[(L, on)] = torch.cuda.max_memory_allocated() - base
                losses[(L, on)] = loss.item()
            finally:
                M._REMAT = True
            del loss
        del params
    _free(torch)
    lo, hi = REMAT_LAYERS
    inc = {on: (peaks[(hi, on)] - peaks[(lo, on)]) / (hi - lo)
           for on in (True, False)}
    for L in REMAT_LAYERS:
        # the same forward arithmetic either way
        if abs(losses[(L, True)] - losses[(L, False)]) > \
                1e-6 * abs(losses[(L, False)]):
            raise AssertionError(f"remat: {L} layers, loss "
                                 f"{losses[(L, True)]} with remat, "
                                 f"{losses[(L, False)]} without")
    if not inc[True] <= REMAT_MAX_SHARE * inc[False]:
        raise AssertionError(f"remat: {inc[True]} bytes a layer with remat, "
                             f"{inc[False]} without (> {REMAT_MAX_SHARE}x)")
    _say("remat", arch=base_cfg.name, d_model=base_cfg.d_model,
         dtype="float32", tokens=REMAT_S, layers=list(REMAT_LAYERS),
         peak_bytes={f"{L} {'remat' if on else 'kept'}": v
                     for (L, on), v in peaks.items()},
         bytes_per_layer={"remat": inc[True], "kept": inc[False]},
         share=inc[True] / inc[False],
         fwd_bwd_s={f"{L} {'remat' if on else 'kept'}": v
                    for (L, on), v in secs.items()},
         losses={f"{L} {'remat' if on else 'kept'}": v
                 for (L, on), v in losses.items()},
         dedup_ms_per_step=dedup["ms_per_step"],
         dedup_peak_gb=dedup["peak_mem_gb"])


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


def _train_norms(cfg):
    """rmsnorm launches of one training forward and backward (training
    batches carry no audio source): the forward's, and again those of
    every layer the backward recomputes (``models.model``'s remat: each
    layer but the hybrid's shared attention; each xLSTM super-block,
    and its mLSTM layers once more inside it)."""
    at, L = cfg.arch_type, cfg.n_layers
    if at == "hybrid":
        again = L
    elif at == "ssm":
        r = cfg.slstm_ratio
        n_super = L // (r + 1)
        again = 2 * (r + 1) * n_super + 2 * r * n_super
    else:
        again = 2 * L
    return _norms(cfg, "forward") + again


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
    want = {"rmsnorm": _train_norms(cfg) * steps,
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
        prof = sp.main(["--slots", "8", "--max-len", "64", "--pos", "32",
                        "--steps", str(PROFILE_STEPS)], cfg=cfg)
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


# ---------------------------------------------------------------------------
# The distributed runtime: one nccl rank in process, two gloo ranks
# sharing the card
# ---------------------------------------------------------------------------

# the training runs' arguments cut from 12 steps to 8, to keep the whole
# script well inside its time limit: the training CLI's window-mean loss
# check then compares the first two steps with the last two, and at seed
# 0 and lr 1e-4 the loss falls over them on every path (4 steps did not;
# the runs are deterministic in the seed)
DIST_STEPS = 8
DIST_ARGS = ["--steps", str(DIST_STEPS)] + TRAIN_ARGS[2:]
MANUAL = ["--collective", "manual"]
DIST_RUNS = (("materialising", MANUAL),
             ("stream chunk 1", MANUAL + ["--stream-chunk", "1"]),
             ("stream chunk 2", MANUAL + ["--stream-chunk", "2"]),
             ("int8 stream chunk 1", MANUAL + ["--stream-chunk", "1",
                                               "--compress", "int8"]),
             ("sign_packed stream chunk 1",
              MANUAL + ["--stream-chunk", "1", "--compress",
                        "sign_packed"]))
# chaos on two gloo ranks against one process: kill machine 1 at step 3
# on the dedup path, no sampled stragglers; 8 steps (the 3-block
# generation trains 2; at 6 the training CLI's window-mean loss check
# compares one step with one, and the elastic run's loss rises over its
# first 6). In float32 activations: the ranks batch 2 blocks where one
# process batches 4, and in bf16 the other GEMM shapes' rounding alone
# moves the losses past the rtol of 1e-4 on the H100.
CHAOS_STEPS = 8
CHAOS_DTYPE = "float32"
DIST_CHAOS_ARGS = (["--steps", str(CHAOS_STEPS)] + TRAIN_ARGS[2:]
                   + ["--straggler-p", "0", "--chaos", "kill:1@3"])
CHAOS_RTOL = 1e-4
# streaming and two ranks only reassociate the combine: the reference's
# float32 reassociation tolerance (tests/test_streaming.py:23)
DIST_RTOL, DIST_ATOL = 2e-4, 2e-5


def _dist_counts(torch, cfg, extra, force=None, args=DIST_ARGS):
    """``_run_train`` on the default group, and the group's traffic."""
    from repro_torch.dist import process_group as pg
    before = dict(pg.traffic)
    s, counts, wall, peak = _run_train(torch, cfg, extra, force, args)
    return s, counts, wall, peak, {k: pg.traffic[k] - before[k]
                                   for k in before}


def _want_manual(n_leaves, norms, rows, chunk, codec, steps):
    """Launch counts of the manual collective over ``rows`` machines a
    rank: one combine a leaf and chunk (a chunk is all the rows when
    materialising), ``norms`` rmsnorm launches a machine's forward and
    backward."""
    combines = n_leaves * (rows // (chunk or rows)) * steps
    return {"rmsnorm": norms * rows * steps, "decode_attention": 0,
            "coded_combine": combines if codec == "none" else 0,
            "quantized_combine": combines if codec == "int8" else 0,
            "packed_sign_combine": (combines if codec == "sign_packed"
                                    else 0)}


def _close_streams(label, got, want):
    import numpy as np
    got, want = np.asarray(got), np.asarray(want)
    if got.shape != want.shape or not np.allclose(
            got, want, rtol=DIST_RTOL, atol=DIST_ATOL):
        raise AssertionError(f"distributed {label}: loss stream {got} != "
                             f"{want} (rtol {DIST_RTOL}, atol {DIST_ATOL})")
    return float(np.max(np.abs(got - want) / np.abs(want)))


def _fsdp_one_rank(torch, dev, cfg):
    """One AdamW step of the dedup path with ``FSDP`` at one rank and
    without: the parameters and moments bit for bit (deterministic
    algorithms on, for the embedding's and the loss's backward)."""
    import numpy as np
    from repro_torch import tree as T
    from repro_torch.configs import CodingConfig
    from repro_torch.data.pipeline import CodedBatcher, SyntheticLM
    from repro_torch.dist import coded_train
    from repro_torch.dist import process_group as pg
    from repro_torch.dist.fsdp import FSDP
    from repro_torch.models import model as M
    from repro_torch.optim import optimizers as opt_mod
    A = coded_train.make_assignment(CodingConfig(replication=2), 4)
    raw = SyntheticLM(cfg.vocab_size, 256, seed=0).batch(A.n * 4, 0)
    blocks = {k: torch.from_numpy(v).to(dev) for k, v in
              CodedBatcher(A, shuffle_seed=0).unique_blocks(raw).items()}
    v = torch.from_numpy((A.A @ np.asarray([1.0, 0.0, 0.7, 2.0]))
                         .astype(np.float32)).to(dev)
    workers = pg.init_workers(dev)
    old = os.environ.get("CUBLAS_WORKSPACE_CONFIG")
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    torch.use_deterministic_algorithms(True)
    outs = []
    try:
        for placed in (False, True):
            _free(torch)
            params = M.init_params(cfg, seed=1, device=dev)
            opt = opt_mod.adamw(1e-4)
            fsdp = FSDP(params, workers) if placed else None
            step = coded_train.make_train_step(
                cfg, opt, dedup=True,
                norm_scale=coded_train.dedup_norm_scale(A),
                workers=workers, fsdp=fsdp)
            with torch.no_grad():
                p, s, met = step(params, opt.init(params), blocks, v)
            outs.append(([x.cpu() for x in T.leaves(p)],
                         [x.cpu() for x in T.leaves(s["v"])],
                         met["loss"].item(), met["grad_norm"].item()))
            del params, p, s, met
    finally:
        torch.use_deterministic_algorithms(False)
        if old is None:
            os.environ.pop("CUBLAS_WORKSPACE_CONFIG")
        else:
            os.environ["CUBLAS_WORKSPACE_CONFIG"] = old
    (p0, v0, l0, n0), (p1, v1, l1, n1) = outs
    same = (l0 == l1 and n0 == n1
            and all(torch.equal(a, b) for a, b in zip(p0 + v0, p1 + v1)))
    if not same:
        raise AssertionError("--fsdp at one rank differs from the "
                             "replicated step")
    return {"bitwise": True, "loss": l0, "grad_norm": n0}


def _stream_params(torch, dev, cfg):
    """One SGD step of the manual collective, materialising and
    streaming (chunk 1 and 2), from the same parameters, batch and
    weights: the combined gradients (the update over lr) within the
    reassociation tolerance."""
    import numpy as np
    from repro_torch import tree as T
    from repro_torch.configs import CodingConfig
    from repro_torch.data.pipeline import CodedBatcher, SyntheticLM
    from repro_torch.dist import coded_train
    from repro_torch.models import model as M
    from repro_torch.optim import optimizers as opt_mod
    A = coded_train.make_assignment(CodingConfig(replication=2), 4)
    raw = SyntheticLM(cfg.vocab_size, 256, seed=0).batch(A.n * 4, 0)
    coded = {k: torch.from_numpy(v).to(dev) for k, v in
             CodedBatcher(A, shuffle_seed=0).code_batch(raw).items()}
    w = torch.tensor([1.0, 0.0, 0.7, 2.0], device=dev)
    lr = 1e-2
    opt = opt_mod.sgd(lr)
    _free(torch)
    params = M.init_params(cfg, seed=1, device=dev)
    grads = {}
    for chunk in (None, 1, 2):
        step = coded_train.make_manual_collective_train_step(
            cfg, opt, streaming_chunk=chunk)
        with torch.no_grad():
            p, _, met = step(params, opt.init(params), coded, w)
            grads[chunk] = [((a - b) / -lr).cpu()
                            for a, b in zip(T.leaves(p), T.leaves(params))]
        del p
    gap = 0.0
    for chunk in (1, 2):
        for a, b in zip(grads[chunk], grads[None]):
            if not torch.allclose(a, b, rtol=DIST_RTOL, atol=DIST_ATOL):
                raise AssertionError(f"streaming chunk {chunk}: combined "
                                     "gradient off the materialising one")
            gap = max(gap, (a - b).abs().max().item())
    del params
    return {"grad_max_abs_gap": gap,
            "grad_max_abs": max(b.abs().max().item() for b in grads[None])}


def _gloo_rank(rank, tmp, jobs):
    """One of two gloo ranks on the card: the training CLI once for each
    of ``jobs`` (label -> (argv, activation dtype)) at granite-3-8b's
    width with 2 layers, with its launch counts, peak memory and wall
    time written to ``tmp``."""
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.dist import process_group as pg
    from repro_torch.kernels.coded_combine import ops as cc_ops
    from repro_torch.kernels.decode_attention import ops as da_ops
    from repro_torch.kernels.rmsnorm import ops as rn_ops
    from repro_torch.launch import train as launch_train
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", store=dist.FileStore(
        os.path.join(tmp, "store"), 2), rank=rank, world_size=2)
    try:
        out = {}
        for label, (argv, dtype) in jobs.items():
            cfg = get_config("granite-3-8b").with_overrides(n_layers=2,
                                                            dtype=dtype)
            rn_ops.launches = da_ops.launches = 0
            cc_ops.launches = dict.fromkeys(cc_ops.launches, 0)
            traffic0 = dict(pg.traffic)
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            s = launch_train.main(argv, cfg=cfg, model=1)
            wall = time.perf_counter() - t0
            out[label] = {"summary": s, "wall_s": wall,
                          "peak_bytes": torch.cuda.max_memory_allocated(),
                          "launches": {"rmsnorm": rn_ops.launches,
                                       "decode_attention": da_ops.launches,
                                       **cc_ops.launches},
                          "traffic": {k: pg.traffic[k] - traffic0[k]
                                      for k in traffic0}}
        with open(os.path.join(tmp, f"rank{rank}.json"), "w") as f:
            json.dump(out, f)
    finally:
        dist.destroy_process_group()


def _gloo_chaos(ranks, one, cfg):
    """The chaos run on two gloo ranks against the one-process run: the
    same ``chaos`` object (but ``rebuild_s``), the losses within
    ``CHAOS_RTOL``, one forward and backward of the rank's blocks a step
    (no combine kernel on this path)."""
    import numpy as np

    def events(chaos):
        return {**chaos, "reassignments": [
            {k: v for k, v in r.items() if k != "rebuild_s"}
            for r in chaos["reassignments"]]}
    want = {"rmsnorm": _train_norms(cfg) * CHAOS_STEPS,
            "decode_attention": 0, "coded_combine": 0,
            "quantized_combine": 0, "packed_sign_combine": 0}
    for r, out in enumerate(ranks):
        s = out["summary"]
        if s["world_size"] != 2 or events(s["chaos"]) != \
                events(one["chaos"]):
            raise AssertionError(f"gloo rank {r} chaos: {s['chaos']} != "
                                 f"{one['chaos']}")
        if out["launches"] != want:
            raise AssertionError(f"gloo rank {r} chaos: launch counts "
                                 f"{out['launches']} != {want}")
        got, ref = np.asarray(s["losses"]), np.asarray(one["losses"])
        if got.shape != ref.shape or not np.allclose(got, ref,
                                                     rtol=CHAOS_RTOL,
                                                     atol=0):
            raise AssertionError(f"gloo rank {r} chaos: losses {got} vs "
                                 f"one process {ref} (rtol {CHAOS_RTOL})")
    s = ranks[0]["summary"]
    return {"dtype": CHAOS_DTYPE,
            "ms_per_step": s["loop_s"] / CHAOS_STEPS * 1e3,
            "peak_gb": [o["peak_bytes"] / 1e9 for o in ranks],
            "losses": s["losses"], "one_process_losses": one["losses"],
            "loss_rel_gap": float(np.max(np.abs(
                np.asarray(s["losses"]) - one["losses"])
                / np.abs(one["losses"]))),
            "rank1_losses": ranks[1]["summary"]["losses"],
            "reassignments": s["chaos"]["reassignments"],
            "launches": ranks[0]["launches"],
            "all_reduce_bytes_per_step":
                s["collective_bytes_per_step"]["all_reduce"]}


def distributed(torch, dev, card):
    """The training driver's distributed runtime at granite-3-8b's full
    width, 2 layers (``DIST_ARGS``): on one nccl rank in process, the
    manual collective materialising, then streaming with chunks of 1
    and 2 machines, and the int8 and sign_packed steps streaming (loss
    streams and one SGD step's combined gradient within the
    reassociation tolerance, streaming's peak strictly under
    materialising's, K1/K3/K4/K5 counts a chunk and a leaf), FSDP at one
    rank bit for bit; then two gloo ranks on the card (two machines a
    rank, the local combine through K3, the ranks' sum through gloo),
    their loss stream within the same tolerance of the one-rank run.
    Returns the kernel runs' summed launch counts."""
    import tempfile
    import torch.distributed as dist
    import torch.multiprocessing as mp
    from repro_torch.configs import get_config
    from repro_torch.models.convert import param_shapes
    cfg = get_config("granite-3-8b").with_overrides(n_layers=2)
    n_leaves = len(param_shapes(cfg))
    totals = {}
    rows = {}
    dist.init_process_group(
        "nccl", store=dist.HashStore(), rank=0, world_size=1,
        device_id=torch.device("cuda", torch.cuda.current_device()))
    try:
        for label, extra in DIST_RUNS:
            s, counts, wall, peak, traffic = _dist_counts(torch, cfg, extra)
            chunk = (int(extra[extra.index("--stream-chunk") + 1])
                     if "--stream-chunk" in extra else 0)
            codec = (extra[extra.index("--compress") + 1]
                     if "--compress" in extra else "none")
            want = _want_manual(n_leaves, _train_norms(cfg), 4, chunk,
                                codec, DIST_STEPS)
            if counts != want:
                raise AssertionError(f"distributed {label}: launch counts "
                                     f"{counts} != {want}")
            if s["world_size"] != 1 or s["stream_chunk"] != chunk:
                raise AssertionError(f"distributed {label}: summary {s}")
            for k, v in counts.items():
                totals[k] = totals.get(k, 0) + v
            rows[label] = {"ms_per_step": s["loop_s"] / DIST_STEPS * 1e3,
                           "peak_gb": peak / 1e9, "losses": s["losses"],
                           "launches": counts, "wall_s": wall,
                           "all_reduce_bytes_per_step":
                               traffic["all_reduce"] / DIST_STEPS}
        mat = rows["materialising"]
        for label in ("stream chunk 1", "stream chunk 2"):
            rows[label]["loss_rel_gap"] = _close_streams(
                label, rows[label]["losses"], mat["losses"])
            if not rows[label]["peak_gb"] < mat["peak_gb"]:
                raise AssertionError(f"distributed {label}: peak "
                                     f"{rows[label]['peak_gb']} GB not under "
                                     f"materialising {mat['peak_gb']} GB")
        grads = _stream_params(torch, dev, cfg)
        fsdp = _fsdp_one_rank(torch, dev, cfg)
    finally:
        dist.destroy_process_group()
    _free(torch)
    # the one-process chaos run the two ranks' is held to
    one, one_counts, _, _ = _run_train(
        torch, cfg.with_overrides(dtype=CHAOS_DTYPE), [], None,
        DIST_CHAOS_ARGS)
    for k, v in one_counts.items():
        totals[k] = totals.get(k, 0) + v
    _free(torch)
    # two gloo ranks sharing the card: machines [0, 2) and [2, 4) on the
    # manual path; then chaos on the dedup path
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        mp.spawn(_gloo_rank, args=(tmp, {
            "manual": (DIST_ARGS + MANUAL, cfg.dtype),
            "chaos": (DIST_CHAOS_ARGS, CHAOS_DTYPE)}), nprocs=2, join=True)
        spawn_s = time.perf_counter() - t0
        outs = []
        for r in range(2):
            with open(os.path.join(tmp, f"rank{r}.json")) as f:
                outs.append(json.load(f))
    rows["two gloo ranks chaos"] = _gloo_chaos(
        [o["chaos"] for o in outs], one, cfg)
    for k, v in outs[0]["chaos"]["launches"].items():
        totals[k] = totals.get(k, 0) + v
    ranks = [o["manual"] for o in outs]
    want = _want_manual(n_leaves, _train_norms(cfg), 2, 0, "none",
                        DIST_STEPS)
    for r, out in enumerate(ranks):
        if out["launches"] != want:
            raise AssertionError(f"gloo rank {r}: launch counts "
                                 f"{out['launches']} != {want}")
        if out["summary"]["world_size"] != 2:
            raise AssertionError(f"gloo rank {r}: {out['summary']}")
    for k, v in ranks[0]["launches"].items():
        totals[k] = totals.get(k, 0) + v
    two = ranks[0]["summary"]
    gap = _close_streams("two gloo ranks", two["losses"], mat["losses"])
    if ranks[1]["summary"]["losses"] != two["losses"]:
        raise AssertionError("the two gloo ranks report other losses")
    rows["two gloo ranks"] = {
        "ms_per_step": two["loop_s"] / DIST_STEPS * 1e3,
        "peak_gb": [o["peak_bytes"] / 1e9 for o in ranks],
        "losses": two["losses"], "loss_rel_gap": gap,
        "launches": ranks[0]["launches"], "wall_s": spawn_s,
        "all_reduce_bytes_per_step":
            two["collective_bytes_per_step"]["all_reduce"],
        "broadcast_bytes_per_step":
            two["collective_bytes_per_step"]["broadcast"]}
    _say("distributed", card=card, arch=cfg.name, n_layers=cfg.n_layers,
         steps=DIST_STEPS, m=4, rtol=DIST_RTOL, atol=DIST_ATOL, runs=rows,
         stream_grads=grads, fsdp_one_rank=fsdp)
    return totals


# ---- the model axis: two gloo ranks sharing the card on layout (1, 2)
# Training: granite-3-8b at full width, 2 layers, the dedup path with no
# compression, int8 and sign_packed, ``DIST_ARGS`` (8 steps: the
# driver's loss-decrease check compares window means of a quarter of
# the steps, and at 6 one sampled draw lifts the last step over the
# first), against the one-process runs of the same arguments. In float32
# activations, as the chaos check: in bf16 a row-parallel product's two
# partial sums are each rounded to bf16 before the all-reduce adds them,
# which the one-process GEMM never rounds, and that alone moves losses
# past the rtol of 1e-4 (GEMM shapes alone moved them 1.13e-4 relative
# on an NVIDIA H100 80GB HBM3 at 700 W, PERF.md).
MA_STEPS = DIST_STEPS
MA_DTYPE = "float32"
MA_TRAIN_ARGS = DIST_ARGS
MA_TRAIN_RUNS = (("dedup", []), ("int8", ["--compress", "int8"]),
                 ("sign_packed", ["--compress", "sign_packed"]))
MA_RTOL = 1e-4
MA_RESIDENT_RTOL = 0.02        # resident parameter bytes vs bytes_per_device
# Serving: granite-3-8b at full config (40 layers, bf16) on (1, 2) and on
# (2, 1), 8 requests on 8 slots, coded prefill at p = 0.2, ``--check``.
MA_SERVE_ARGS = ["--arch", "granite-3-8b", "--full-config", "--requests",
                 "8", "--slots", "8", "--prompt-len", "48",
                 "--prompt-spread", "16", "--max-new-tokens", "16",
                 "--max-len", "128", "--replicas", "8", "--seed", "0",
                 "--scheme", "expander", "--straggler-p", "0.2", "--check"]
# Teacher-forced bf16 logits of the two ranks within this of the one
# process's, absolutely: 40 bf16 layers put ~0.11 between bf16 and
# float32 logits at this config (``teacher_forced``'s measurement,
# PERF.md), and the two ranks' other rounding is of that order; 0.25 is
# 2.3 x that.
MA_LOGIT_ATOL = 0.25


# Mamba2's and the xLSTM's split heads run locally (``models/ssm.py``,
# ``models/xlstm.py``) on (1, 2), two gloo ranks on the card, at their
# published widths. Training, float32 activations, dedup and int8 (K4 on
# shard rows), depth cut: zamba2 to 2 Mamba2 layers with one shared
# attention insertion, xlstm to 8 layers (one super-block of 7 mLSTM and
# one sLSTM). Serving at full config (38 and 48 layers) in float32, 8
# requests on 8 slots, short prompts and streams to keep the script well
# inside its time limit (K2 at zamba2's 16 query over 16 KV heads a rank):
# in bf16 zamba2's own rounding moves its logits by about their size
# (5.48 between bf16 and float32 at 4 teacher-forced steps, the families
# phase; 4.24 between the two layouts), so no bound could hold the ranks
# to one process there.
# 3 steps: from the fourth the xLSTM's float32 training parts fast from
# any rounding change (on an NVIDIA H100 at 700 W: the two ranks 1.2e-5
# from one process at the third step, 9.6e-5 at the fourth; a 1e-7
# relative perturbation of its parameters in one process 6.4e-7 and
# 4.1e-5, ``tools/train_divergence.py``).
MA_FAMILY_STEPS = 3
MA_FAMILY_TRAIN_ARGS = ["--steps", str(MA_FAMILY_STEPS)] + TRAIN_ARGS[2:]
MA_FAMILY_TRAIN_RUNS = (("dedup", []), ("int8", ["--compress", "int8"]))
MA_FAMILIES = (("zamba2-1.2b", {"n_layers": 2, "attn_positions": (1,)}),
               ("xlstm-1.3b", {"n_layers": 8}))
MA_FAMILY_SERVE_ARGS = ["--full-config", "--requests", "8", "--slots", "8",
                        "--prompt-len", "8", "--prompt-spread", "4",
                        "--max-new-tokens", "6", "--max-len", "32",
                        "--replicas", "8", "--seed", "0", "--scheme",
                        "expander", "--straggler-p", "0.2", "--check"]
MA_FAMILY_SERVE_DTYPE = "float32"
MA_ZAMBA2_K2 = "zamba2 model axis M=2 B=8 H=KVH=16 S=1024 Dh=64 ragged"


def _ma_requests(args):
    """The serving CLI's requests for ``args`` (their prompts)."""
    import types
    from repro_torch.configs import get_config
    from repro_torch.launch import serve as launch_serve
    kv = {a: v for a, v in zip(args, args[1:]) if a.startswith("--")}
    ns = types.SimpleNamespace(
        seed=int(kv["--seed"]), requests=int(kv["--requests"]),
        prompt_len=int(kv["--prompt-len"]),
        prompt_spread=int(kv["--prompt-spread"]),
        max_new_tokens=int(kv["--max-new-tokens"]))
    return launch_serve._build_requests(ns, get_config(kv["--arch"]))


def _ma_teacher_forced(torch, dev, cfg, params, reqs, streams, workers):
    """Decode logits (float32, whole vocabulary) at every generated
    position of ``reqs``, each fed its prompt and then ``streams``' tokens
    (teacher-forced), all requests as one batch, on ``workers``' placement
    (this rank's slots, gathered). Returns (n_new, B, V)."""
    from repro_torch.dist import tensor_parallel as tp
    from repro_torch.models import model as M
    from repro_torch.serve import slot_rows
    B = len(reqs)
    seqs = [list(r.prompt) + list(streams[r.uid][:-1]) for r in reqs]
    T = max(len(q) for q in seqs)
    n_new = len(streams[reqs[0].uid])
    rows = slot_rows(B, workers)
    model = None if workers is None else workers.model
    with tp.executing(model), torch.no_grad():
        cache = M.init_decode_cache(cfg, rows.stop - rows.start, T + 1,
                                    device=dev)
        out = torch.zeros(n_new, B, cfg.padded_vocab(), device=dev)
        for t in range(T):
            tok = torch.tensor([q[t] if t < len(q) else 0 for q in seqs],
                               dtype=torch.int32, device=dev)
            logits, cache = M.decode_step(params, tok[rows], cache, cfg)
            if rows.stop - rows.start != B:
                logits = workers.all_gather_(
                    torch.empty(B, logits.shape[1], device=dev),
                    logits.contiguous())
            for i, r in enumerate(reqs):
                j = t - (len(r.prompt) - 1)
                if 0 <= j < n_new:
                    out[j, i] = logits[i]
    return out


def _model_axis_rank(rank, tmp, jobs):
    """One of two gloo ranks on the card: ``jobs`` in order, each a
    training run (label -> ("train", (arch, overrides, argv))) on layout
    (1, 2), or a serving run (label -> ("serve", (argv, model,
    overrides))) on (1, 2) or (2, 1) of ``--arch``'s full config with the
    overrides, followed by its teacher-forced logits along the
    one-process streams (``one_streams_<arch>.json``); launch counts,
    traffic, peaks and results written to ``tmp``."""
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.dist import process_group as pg
    from repro_torch.kernels.coded_combine import ops as cc_ops
    from repro_torch.kernels.decode_attention import ops as da_ops
    from repro_torch.kernels.rmsnorm import ops as rn_ops
    from repro_torch.launch import serve as launch_serve
    from repro_torch.launch import train as launch_train
    torch.cuda.set_device(0)
    dev = torch.device("cuda", 0)
    dist.init_process_group("gloo", store=dist.FileStore(
        os.path.join(tmp, "store"), 2), rank=rank, world_size=2)
    try:
        out = {}
        for label, (kind, arg) in jobs.items():
            _free(torch)
            rn_ops.launches = da_ops.launches = 0
            cc_ops.launches = dict.fromkeys(cc_ops.launches, 0)
            traffic0 = dict(pg.traffic)
            t0 = time.perf_counter()
            if kind == "train":
                arch, over, argv = arg
                cfg = get_config(arch).with_overrides(dtype=MA_DTYPE,
                                                      **over)
                res = {"summary": launch_train.main(argv, cfg=cfg,
                                                    model=2)}
            else:
                argv, model, over = arg
                arch = argv[argv.index("--arch") + 1]
                cfg = get_config(arch).with_overrides(**over)
                r = launch_serve.main(argv, cfg, model=model)
                res = {"summary": r["summary"],
                       "results": {str(k): v.tolist()
                                   for k, v in r["results"].items()}}
            wall = time.perf_counter() - t0
            res.update(wall_s=wall,
                       peak_bytes=torch.cuda.max_memory_allocated(),
                       launches={"rmsnorm": rn_ops.launches,
                                 "decode_attention": da_ops.launches,
                                 **cc_ops.launches},
                       traffic={k: pg.traffic[k] - traffic0[k]
                                for k in traffic0})
            if kind == "serve":
                # teacher-forced along the one-process streams, on this
                # layout's placement
                with open(os.path.join(tmp,
                                       f"one_streams_{arch}.json")) as f:
                    one = {int(k): v for k, v in json.load(f).items()}
                del r
                _free(torch)
                workers = pg.init_workers(dev, model=model)
                params = launch_serve._placed_params(cfg, 0, dev, workers)
                lg = _ma_teacher_forced(torch, dev, cfg, params,
                                        _ma_requests(argv), one, workers)
                if rank == 0:
                    torch.save(lg.cpu(), os.path.join(tmp, f"tf_{label}.pt"))
                del params, lg
            out[label] = res
            dist.barrier()
        with open(os.path.join(tmp, f"rank{rank}.json"), "w") as f:
            json.dump(out, f)
    finally:
        dist.destroy_process_group()


def _first_near_tie(one_logits, vocab, eps):
    """Per request, the first generated position whose one-process top-2
    logit gap is at most ``eps`` (n_new where there is none)."""
    top2 = one_logits[..., :vocab].topk(2, dim=-1).values
    gap = (top2[..., 0] - top2[..., 1])                    # (n_new, B)
    n_new = gap.shape[0]
    firsts = []
    for b in range(gap.shape[1]):
        hit = (gap[:, b] <= eps).nonzero()
        firsts.append(int(hit[0]) if len(hit) else n_new)
    return firsts


def model_axis(torch, dev, card, archs=None):
    """The model axis executed (``dist.tensor_parallel``) on two gloo ranks
    sharing the card. Training on (1, 2): each run's loss stream within
    ``MA_RTOL`` of the one-process run's, each rank's resident parameter
    bytes within ``MA_RESIDENT_RTOL`` of ``bytes_per_device``, the model
    group's bytes a step, and K1 (9 a step), K4 and K5 (a launch a leaf
    and step) counts on each rank. Serving granite-3-8b at full config on
    (1, 2) and (2, 1): ``--check`` passes; the one process's and each
    layout's teacher-forced logits along the one-process streams within
    ``MA_LOGIT_ATOL``, and the streams equal the one process's up to the
    first position whose one-process top-2 gap is at most twice their
    largest difference (no closer pair can change the argmax); K1 and K2
    counts a pool step (81 and 40) on each rank. Returns the summed
    counts of the ranks' runs (rank 0's). ``archs`` (default all) picks
    granite-3-8b and the ``MA_FAMILIES`` to run (``_ma_family_check``)."""
    import tempfile
    import numpy as np
    import torch.multiprocessing as mp
    from repro_torch.configs import get_config
    from repro_torch.dist.sharding import bytes_per_device, safe_param_specs
    from repro_torch.kernels.decode_attention import ops as da_ops
    from repro_torch.kernels.rmsnorm import ops as rn_ops
    from repro_torch.launch import serve as launch_serve
    from repro_torch.launch.mesh import make_test_layout
    from repro_torch.launch.specs import meta_params
    from repro_torch.models import model as M
    from repro_torch.models.convert import param_shapes
    cfg = get_config("granite-3-8b").with_overrides(n_layers=2,
                                                    dtype=MA_DTYPE)
    n_leaves = len(param_shapes(cfg))
    totals, rows = {}, {}
    ones = {}
    archs = archs or ("granite-3-8b",) + tuple(a for a, _ in MA_FAMILIES)
    granite = "granite-3-8b" in archs
    fams = tuple(f for f in MA_FAMILIES if f[0] in archs)
    jobs, one_streams = {}, {}
    for label, extra in (MA_TRAIN_RUNS if granite else ()):
        ones[label], counts, _, _ = _run_train(torch, cfg, extra, None,
                                               MA_TRAIN_ARGS)
        for k, v in counts.items():
            totals[k] = totals.get(k, 0) + v
        _free(torch)
    if granite:
        # the one-process engine, and its teacher-forced logits
        full = get_config("granite-3-8b")
        rn_ops.launches = da_ops.launches = 0
        one = launch_serve.main(MA_SERVE_ARGS)
        totals["rmsnorm"] = totals.get("rmsnorm", 0) + rn_ops.launches
        totals["decode_attention"] = (totals.get("decode_attention", 0)
                                      + da_ops.launches)
        one_streams = {int(k): v for k, v in one["results"].items()}
        del one
        _free(torch)
        reqs = _ma_requests(MA_SERVE_ARGS)
        params = M.cast_block_weights(M.init_params(full, seed=0, device=dev),
                                      full)
        one_lg = _ma_teacher_forced(torch, dev, full, params, reqs,
                                    one_streams, None).cpu()
        del params
        _free(torch)
    shapes = meta_params(cfg)
    layout = make_test_layout((1, 2))
    want_resident = bytes_per_device(shapes, safe_param_specs(shapes,
                                                              layout),
                                     layout)
    if granite:
        over = {"n_layers": 2}
        jobs = {label: ("train", ("granite-3-8b", over,
                                  MA_TRAIN_ARGS + extra))
                for label, extra in MA_TRAIN_RUNS}
        jobs.update({"serve (1, 2)": ("serve", (MA_SERVE_ARGS, 2, {})),
                     "serve (2, 1)": ("serve", (MA_SERVE_ARGS, 1, {}))})
    fam = _ma_family_ones(torch, dev, fams)
    jobs.update(fam["jobs"])
    streams_of = dict(fam["ones"], **({"granite-3-8b": {
        "streams": one_streams}} if granite else {}))
    with tempfile.TemporaryDirectory() as tmp:
        for arch, one in streams_of.items():
            streams = one["streams"]
            with open(os.path.join(tmp, f"one_streams_{arch}.json"),
                      "w") as f:
                json.dump({str(k): list(map(int, v))
                           for k, v in streams.items()}, f)
        t0 = time.perf_counter()
        mp.spawn(_model_axis_rank, args=(tmp, jobs), nprocs=2, join=True)
        spawn_s = time.perf_counter() - t0
        outs = []
        for r in range(2):
            with open(os.path.join(tmp, f"rank{r}.json")) as f:
                outs.append(json.load(f))
        tf = {label: torch.load(os.path.join(tmp, f"tf_{label}.pt"))
              for label, (kind, _) in jobs.items() if kind == "serve"}
    if granite:
        norms = _train_norms(cfg)
        for label, extra in MA_TRAIN_RUNS:
            codec = extra[1] if extra else "none"
            rows_n = 4                      # the dedup path's 4 blocks
            forwards = rows_n if codec != "none" else 1
            want = {"rmsnorm": norms * forwards * MA_STEPS,
                    "decode_attention": 0, "coded_combine": 0,
                    "quantized_combine": (n_leaves * MA_STEPS
                                          if codec == "int8" else 0),
                    "packed_sign_combine": (
                        n_leaves * MA_STEPS if codec == "sign_packed"
                        else 0)}
            ref = np.asarray(ones[label]["losses"])
            for r, o in enumerate(outs):
                got = o[label]
                s = got["summary"]
                if s["layout"] != {"data": 1, "model": 2}:
                    raise AssertionError(f"model_axis {label}: layout "
                                         f"{s['layout']}")
                if got["launches"] != want:
                    raise AssertionError(f"model_axis {label} rank {r}: "
                                         f"launch counts {got['launches']} != "
                                         f"{want}")
                res = s["resident_bytes"]["params"]
                if abs(res - want_resident) > MA_RESIDENT_RTOL * want_resident:
                    raise AssertionError(f"model_axis {label} rank {r}: "
                                         f"resident {res} B, bytes_per_device "
                                         f"{want_resident} B")
                loss = np.asarray(s["losses"])
                if loss.shape != ref.shape or not np.allclose(
                        loss, ref, rtol=MA_RTOL, atol=0):
                    raise AssertionError(f"model_axis {label} rank {r}: "
                                         f"losses {loss} vs one process "
                                         f"{ref}")
            s = outs[0][label]["summary"]
            rows[label] = {
                "ms_per_step": s["loop_s"] / MA_STEPS * 1e3,
                "one_process_ms_per_step": ones[label]["loop_s"] / MA_STEPS
                * 1e3,
                "losses": s["losses"], "one_process_losses": ones[label][
                    "losses"],
                "loss_rel_gap": float(np.max(np.abs(np.asarray(s["losses"])
                                                    - ref) / np.abs(ref))),
                "resident_param_bytes": [
                    o[label]["summary"]["resident_bytes"]["params"]
                    for o in outs],
                "bytes_per_device": want_resident,
                "one_process_param_bytes": ones[label]["resident_bytes"][
                    "params"],
                "model_bytes_per_step": {
                    k: v for k, v in s["collective_bytes_per_step"].items()
                    if v},
                "peak_gb": [o[label]["peak_bytes"] / 1e9 for o in outs],
                "launches": outs[0][label]["launches"]}
            for k, v in outs[0][label]["launches"].items():
                totals[k] = totals.get(k, 0) + v
        vocab = full.vocab_size
        for label, model in (("serve (1, 2)", 2), ("serve (2, 1)", 1)):
            lg = tf[label]
            err = (lg - one_lg).abs().max().item()
            if not err <= MA_LOGIT_ATOL:
                raise AssertionError(f"model_axis {label}: teacher-forced "
                                     f"logits {err} from the one process's "
                                     f"(> {MA_LOGIT_ATOL})")
            firsts = _first_near_tie(one_lg, vocab, 2 * err)
            for r, o in enumerate(outs):
                got = o[label]
                s = got["summary"]
                if s["check_passed"] is not True:
                    raise AssertionError(f"model_axis {label} rank {r}: "
                                         "engine streams != sequential "
                                         "reference")
                steps = s["pool_steps"]
                want = {"rmsnorm": 81 * steps, "decode_attention": 40 * steps,
                        "coded_combine": 0, "quantized_combine": 0,
                        "packed_sign_combine": 0}
                if steps <= 0 or got["launches"] != want:
                    raise AssertionError(f"model_axis {label} rank {r}: "
                                         f"launch counts {got['launches']} "
                                         f"!= {want}")
                agree = []
                for req, first in zip(reqs, firsts):
                    a = got["results"][str(req.uid)]
                    b = one_streams[req.uid]
                    n = next((i for i, (x, y) in enumerate(zip(a, b))
                              if x != y), len(b))
                    if n < first:
                        raise AssertionError(
                            f"model_axis {label} rank {r}: request {req.uid} "
                            f"parts from the one process at token {n}, before "
                            f"its first near-tie at {first}")
                    agree.append(n)
            s = outs[0][label]["summary"]
            rows[label] = {
                "layout": s["layout"], "slots_per_rank": s["slots_per_rank"],
                "tokens_per_s": s["tokens_per_s"],
                "pool_steps": s["pool_steps"],
                "check_passed": s["check_passed"],
                "teacher_forced_max_abs_diff": err,
                "max_abs_logit": one_lg.abs().max().item(),
                "near_tie_eps": 2 * err, "first_near_tie": firsts,
                # the tokens the stream rule held equal (those before each
                # request's first near-tie), of all the generated ones
                "stream_rule_tokens": sum(min(f, len(one_streams[q.uid]))
                                          for f, q in zip(firsts, reqs)),
                "generated_tokens": sum(len(one_streams[q.uid])
                                        for q in reqs),
                "agree_tokens": agree,
                "streams_equal": sum(a == len(one_streams[q.uid])
                                     for a, q in zip(agree, reqs)),
                "peak_gb": [o[label]["peak_bytes"] / 1e9 for o in outs],
                "wall_s": [o[label]["wall_s"] for o in outs],
                "bytes_per_pool_step": {
                    k: v / max(1, s["pool_steps"]) for k, v in
                    outs[0][label]["traffic"].items() if v},
                "launches": outs[0][label]["launches"]}
            for k, v in outs[0][label]["launches"].items():
                totals[k] = totals.get(k, 0) + v
        _say("model_axis", card=card, arch="granite-3-8b", train_n_layers=2,
             train_dtype=MA_DTYPE, steps=MA_STEPS, rtol=MA_RTOL,
             logit_atol=MA_LOGIT_ATOL, spawn_s=spawn_s, runs=rows)
    for arch, over in fams:
        for k, v in _ma_family_check(torch, card, arch, over, fam, outs,
                                     tf).items():
            totals[k] = totals.get(k, 0) + v
    return totals


def _ma_family_ones(torch, dev, fams=MA_FAMILIES):
    """The one-process runs the families' model-axis runs are held to
    (training runs, the engine's streams, teacher-forced logits along
    them, and their launch counts) and the families' rank jobs."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.decode_attention import ops as da_ops
    from repro_torch.kernels.rmsnorm import ops as rn_ops
    from repro_torch.launch import serve as launch_serve
    from repro_torch.models import model as M
    ones, jobs = {}, {}
    for arch, over in fams:
        cfg = get_config(arch).with_overrides(dtype=MA_DTYPE, **over)
        one = {"train": {}, "counts": {}}
        for label, extra in MA_FAMILY_TRAIN_RUNS:
            s, counts, _, _ = _run_train(torch, cfg, extra, None,
                                         MA_FAMILY_TRAIN_ARGS)
            one["train"][label] = s
            one["counts"][label] = counts
            jobs[f"{arch} {label}"] = ("train", (
                arch, over, MA_FAMILY_TRAIN_ARGS + extra))
            _free(torch)
        argv = ["--arch", arch] + MA_FAMILY_SERVE_ARGS
        serve_over = {"dtype": MA_FAMILY_SERVE_DTYPE}
        full = get_config(arch).with_overrides(**serve_over)
        rn_ops.launches = da_ops.launches = 0
        r = launch_serve.main(argv, full)
        one["counts"]["serve"] = {"rmsnorm": rn_ops.launches,
                                  "decode_attention": da_ops.launches}
        one["serve"] = r["summary"]
        one["streams"] = {int(k): v for k, v in r["results"].items()}
        del r
        _free(torch)
        params = M.cast_block_weights(M.init_params(full, seed=0,
                                                    device=dev), full)
        one["logits"] = _ma_teacher_forced(
            torch, dev, full, params, _ma_requests(argv), one["streams"],
            None).cpu()
        del params
        _free(torch)
        jobs[f"{arch} serve (1, 2)"] = ("serve", (argv, 2, serve_over))
        ones[arch] = one
    return {"ones": ones, "jobs": jobs}


def _ma_gather_at_use_bytes(cfg, itemsize):
    """What gather at use moved a pass, computed from the leaf shapes
    (not measured): a rank's block of every Mamba2 or xLSTM leaf that
    ``safe_param_specs`` splits at M = 2, in ``itemsize`` bytes."""
    import numpy as np
    from repro_torch import tree as T
    from repro_torch.dist import tensor_parallel as tp
    from repro_torch.dist.sharding import safe_param_specs
    from repro_torch.launch.mesh import make_test_layout
    from repro_torch.launch.specs import meta_params
    shapes = meta_params(cfg)
    specs = safe_param_specs(shapes, make_test_layout((1, 2)))
    total = 0
    for path, x, spec in zip(T.paths(shapes), T.leaves(shapes),
                             T.leaves(specs)):
        if tp.model_dim(spec) >= 0 and path.split("/")[1] in (
                "ssm", "mlstm", "slstm"):
            total += int(np.prod(x.shape)) // 2 * itemsize
    return total


def _ma_family_check(torch, card, arch, over, fam, outs, tf):
    """One family's model-axis runs against its one-process runs:
    training (loss streams within ``MA_RTOL``, resident parameter bytes
    within ``MA_RESIDENT_RTOL`` of ``bytes_per_device``, K1 and K4 counts
    on each rank, no all-gather of a Mamba2 or xLSTM leaf) and serving
    at full config (``--check``, teacher-forced logits within
    ``MA_LOGIT_ATOL``, streams equal up to the first near-tie, K1 and K2
    counts a pool step on each rank). Prints its line; returns rank 0's
    counts."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.dist.sharding import bytes_per_device, safe_param_specs
    from repro_torch.launch.mesh import make_test_layout
    from repro_torch.launch.specs import meta_params
    from repro_torch.models.convert import param_shapes
    one = fam["ones"][arch]
    cfg = get_config(arch).with_overrides(dtype=MA_DTYPE, **over)
    n_leaves = len(param_shapes(cfg))
    layout = make_test_layout((1, 2))
    shapes = meta_params(cfg)
    want_resident = bytes_per_device(
        shapes, safe_param_specs(shapes, layout), layout)
    # nothing of a parameter is all-gathered in training: only Mamba2's
    # B | C | dt features, a rank's half of them for each of the 4,096
    # tokens a step (4 blocks of 4 sequences of 256), in the forward and
    # in the recomputation
    want_gathered = 0
    if cfg.arch_type == "hybrid":
        H = cfg.ssm_expand * cfg.d_model // 64
        want_gathered = (2 * cfg.n_layers * 4096
                         * (2 * cfg.ssm_state + H) // 2 * 4)
    totals, rows = {}, {}
    for label, extra in MA_FAMILY_TRAIN_RUNS:
        key = f"{arch} {label}"
        codec = extra[1] if extra else "none"
        forwards = 4 if codec != "none" else 1      # the dedup path's 4
        want = {"rmsnorm": _train_norms(cfg) * forwards * MA_FAMILY_STEPS,
                "decode_attention": 0, "coded_combine": 0,
                "quantized_combine": (n_leaves * MA_FAMILY_STEPS
                                      if codec == "int8" else 0),
                "packed_sign_combine": 0}
        ref = np.asarray(one["train"][label]["losses"])
        for r, o in enumerate(outs):
            got = o[key]
            s = got["summary"]
            if s["layout"] != {"data": 1, "model": 2}:
                raise AssertionError(f"model_axis {key}: layout "
                                     f"{s['layout']}")
            if got["launches"] != want:
                raise AssertionError(f"model_axis {key} rank {r}: launch "
                                     f"counts {got['launches']} != {want}")
            res = s["resident_bytes"]["params"]
            if abs(res - want_resident) > MA_RESIDENT_RTOL * want_resident:
                raise AssertionError(f"model_axis {key} rank {r}: resident "
                                     f"{res} B, bytes_per_device "
                                     f"{want_resident} B")
            loss = np.asarray(s["losses"])
            if loss.shape != ref.shape or not np.allclose(
                    loss, ref, rtol=MA_RTOL, atol=0):
                raise AssertionError(f"model_axis {key} rank {r}: losses "
                                     f"{loss} vs one process {ref}")
            gathered = s["collective_bytes_per_step"]["model_all_gather"]
            if gathered != want_gathered:
                raise AssertionError(f"model_axis {key} rank {r}: "
                                     f"{gathered} B all-gathered a step, "
                                     f"not {want_gathered} (B | C | dt)")
        s = outs[0][key]["summary"]
        rows[label] = {
            "ms_per_step": s["loop_s"] / MA_FAMILY_STEPS * 1e3,
            "one_process_ms_per_step": one["train"][label]["loop_s"]
            / MA_FAMILY_STEPS * 1e3,
            "losses": s["losses"],
            "one_process_losses": one["train"][label]["losses"],
            "loss_rel_gap": float(np.max(np.abs(np.asarray(s["losses"])
                                                - ref) / np.abs(ref))),
            "resident_param_bytes": [o[key]["summary"]["resident_bytes"][
                "params"] for o in outs],
            "bytes_per_device": want_resident,
            "model_bytes_per_step": {
                k: v for k, v in s["collective_bytes_per_step"].items()
                if v},
            "gather_at_use_bytes_per_pass": _ma_gather_at_use_bytes(cfg, 4),
            "peak_gb": [o[key]["peak_bytes"] / 1e9 for o in outs],
            "launches": outs[0][key]["launches"]}
        for k, v in outs[0][key]["launches"].items():
            totals[k] = totals.get(k, 0) + v
    full = get_config(arch)
    key = f"{arch} serve (1, 2)"
    lg, one_lg = tf[key], one["logits"]
    err = (lg - one_lg).abs().max().item()
    if not err <= MA_LOGIT_ATOL:
        raise AssertionError(f"model_axis {key}: teacher-forced logits "
                             f"{err} from the one process's "
                             f"(> {MA_LOGIT_ATOL})")
    firsts = _first_near_tie(one_lg, full.vocab_size, 2 * err)
    reqs = _ma_requests(["--arch", arch] + MA_FAMILY_SERVE_ARGS)
    one_streams = one["streams"]
    agree = []
    for r, o in enumerate(outs):
        got = o[key]
        s = got["summary"]
        if s["check_passed"] is not True:
            raise AssertionError(f"model_axis {key} rank {r}: engine "
                                 "streams != sequential reference")
        steps = s["pool_steps"]
        want = {"rmsnorm": _norms(full, "decode") * steps,
                "decode_attention": _attentions(full) * steps,
                "coded_combine": 0, "quantized_combine": 0,
                "packed_sign_combine": 0}
        if steps <= 0 or got["launches"] != want:
            raise AssertionError(f"model_axis {key} rank {r}: launch "
                                 f"counts {got['launches']} != {want}")
        agree = []
        for req, first in zip(reqs, firsts):
            a = got["results"][str(req.uid)]
            b = one_streams[req.uid]
            n = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
                     len(b))
            if n < first:
                raise AssertionError(
                    f"model_axis {key} rank {r}: request {req.uid} parts "
                    f"from the one process at token {n}, before its "
                    f"first near-tie at {first}")
            agree.append(n)
    s = outs[0][key]["summary"]
    steps = max(1, s["pool_steps"])
    with_heads = {}
    if full.arch_type == "hybrid":
        # the shared attention's query and KV heads a rank (both divide 2)
        with_heads["attention_heads_a_rank"] = [full.n_heads // 2,
                                                full.n_kv_heads // 2]
    rows["serve (1, 2)"] = {
        "n_layers": full.n_layers, "tokens_per_s": s["tokens_per_s"],
        "one_process_tokens_per_s": one["serve"]["tokens_per_s"],
        "pool_steps": s["pool_steps"], "check_passed": s["check_passed"],
        "teacher_forced_max_abs_diff": err,
        "max_abs_logit": one_lg.abs().max().item(),
        "near_tie_eps": 2 * err, "first_near_tie": firsts,
        "stream_rule_tokens": sum(min(f, len(one_streams[q.uid]))
                                  for f, q in zip(firsts, reqs)),
        "generated_tokens": sum(len(one_streams[q.uid]) for q in reqs),
        "agree_tokens": agree,
        "streams_equal": sum(a == len(one_streams[q.uid])
                             for a, q in zip(agree, reqs)),
        "peak_gb": [o[key]["peak_bytes"] / 1e9 for o in outs],
        "wall_s": [o[key]["wall_s"] for o in outs],
        "bytes_per_pool_step": {k: v / steps for k, v in
                                outs[0][key]["traffic"].items() if v},
        "dtype": MA_FAMILY_SERVE_DTYPE,
        "gather_at_use_bytes_per_pass": _ma_gather_at_use_bytes(
            full, 4 if MA_FAMILY_SERVE_DTYPE == "float32" else 2),
        "launches": outs[0][key]["launches"], **with_heads}
    for k, v in outs[0][key]["launches"].items():
        totals[k] = totals.get(k, 0) + v
    for label, c in one["counts"].items():
        for k, v in c.items():
            totals[k] = totals.get(k, 0) + v
    _say("model_axis_family", card=card, arch=arch, train_cuts=_cuts(
        cfg, over), train_dtype=MA_DTYPE, steps=MA_FAMILY_STEPS,
        rtol=MA_RTOL, logit_atol=MA_LOGIT_ATOL, runs=rows)
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
    out = sp.main(["--full-config", "--steps", str(PROFILE_STEPS)])
    fam = out["kernel_families_ms_per_step"]
    _say("step_profile", arch=out["arch"], pos=out["pos"],
         decode_attention_ms_per_step=fam.get("decode_attention"),
         rmsnorm_ms_per_step=fam.get("rmsnorm"),
         host_ms_per_step=out["host_ms_per_step"],
         graph_ms_per_step=out["graph_ms_per_step"],
         device_ms_per_step=out["device_ms_per_step"])


BENCH_FILES = ("BENCH_torch_kernels.json", "BENCH_torch_serve.json",
               "BENCH_torch_train.json", "BENCH_torch_decoding.json",
               "BENCH_torch_sweep.json")
ARG_BYTES_RTOL = 0.02


def benchmarks(torch, dev, card):
    """The port's benchmark suite (``repro_torch.benchmarks.run --fast``)
    on the card into a temporary directory, every report carrying the
    card's name; the dry-run's specs for every arch and shape on both
    production layouts under both placements, and one full dry-run
    (granite-3-8b ``train_4k``) whose table the suite's roofline section
    prints; and the train bench's argument-bytes cross-check: the
    dry-run's bytes for the dedup step against the allocator's just
    before its first step, within ``ARG_BYTES_RTOL``."""
    import tempfile
    from repro_torch.benchmarks import run as bench_run
    from repro_torch.configs import ALL_SHAPES, ARCH_IDS
    from repro_torch.launch import dryrun
    name = card.rsplit(",", 1)[0].strip()
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        specs = {}
        for arch in ARCH_IDS:
            for shape in ALL_SHAPES:
                for mp in (False, True):
                    for fsdp in (False, True):
                        r = dryrun.specs_one(arch, shape.name, multi_pod=mp,
                                             fsdp=fsdp, verbose=False)
                        specs[(arch, shape.name, mp, fsdp)] = r
        bad = [k for k, r in specs.items() if r["status"] not in
               ("ok", "skipped")]
        yi = [specs[("yi-34b", "train_4k", mp, f)]["param_bytes_per_device"]
              for mp in (False, True) for f in (False, True)]
        if bad or not (yi[1] * 8 <= yi[0] and yi[3] * 8 <= yi[2]):
            raise AssertionError(f"dry-run specs: errors {bad}, yi-34b "
                                 f"param bytes (repl, fsdp) x 2 {yi}")
        specs_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        dry_dir = os.path.join(tmp, "dryrun")
        os.makedirs(dry_dir)
        one = dryrun.dryrun_one("granite-3-8b", "train_4k", multi_pod=False)
        with open(os.path.join(dry_dir, "granite-3-8b__train_4k__single"
                               ".json"), "w") as f:
            json.dump(one, f)
        dry_s = time.perf_counter() - t0
        if one["status"] != "ok" or not one["fits_device"]:
            raise AssertionError(f"granite-3-8b train_4k dry-run: {one}")
        t0 = time.perf_counter()
        out = bench_run.main(["--fast", "--out", tmp,
                              "--dryrun-dir", dry_dir])
        bench_s = time.perf_counter() - t0
        reports = {}
        for fn in BENCH_FILES:
            with open(os.path.join(tmp, fn)) as f:
                reports[fn] = json.load(f)
            if reports[fn]["device"]["name"] != name:
                raise AssertionError(f"{fn} names {reports[fn]['device']}, "
                                     f"not the card {name!r}")
    res = out["results"]
    eng = res["serve"]["engine"]["coded"]
    dedup = next(r for r in res["train_step"]["runs"]
                 if r["path"] == "dedup" and r["compress"] == "none")
    mem = dedup["memory"]
    if not mem["argument_bytes_rel_diff"] <= ARG_BYTES_RTOL:
        raise AssertionError(f"dry-run argument bytes "
                             f"{mem['argument_bytes_dryrun']} vs allocated "
                             f"{mem['argument_bytes_measured']}: off by "
                             f"{mem['argument_bytes_rel_diff']}")
    shares = {r["name"]: r["bound_share"] for r in res["kernels"]["rows"]
              if r["bound_share"] is not None}
    _say("benchmarks", card=card, files=list(BENCH_FILES),
         tokens_per_s=eng["tokens_per_s"], ttft_p50_ms=eng["ttft_p50_ms"],
         ttft_p99_ms=eng["ttft_p99_ms"],
         sim_p99_ms={k: res["serve"]["acceptance"][k]
                     for k in ("coded_p99_ms", "uncoded_p99_ms")},
         dedup_ms_per_step=dedup["step_ms"],
         dedup_peak_gb=mem["peak_bytes"] / 1e9,
         train_ms_per_step={f"{r['path']}/{r['collective']}/"
                            f"{r['compress']}/{r['scheme']}/m{r['m_workers']}"
                            f"/stream{r['stream_chunk']}": r["step_ms"]
                            for r in res["train_step"]["runs"]},
         argument_bytes={k: mem[k] for k in (
             "argument_bytes_dryrun", "argument_bytes_measured",
             "argument_bytes_rel_diff")},
         chaos={k: res["train_step"]["chaos"][k] for k in (
             "steps_to_detect", "degraded_steps", "m_final", "loss_gap")},
         trials_per_s=res["decoding"]["batched"]["trials_per_sec"],
         sweep_s={k: res["sweep"]["regime2_grid"][k]
                  for k in ("per_point_seconds", "sweep_seconds")},
         campaign_s=res["sweep"]["campaign"]["campaign_seconds"],
         bound_share=shares,
         dryrun={"specs": len(specs), "specs_s": specs_s,
                 "granite_train_4k_s": dry_s,
                 "argument_gb_per_device":
                     one["memory"]["argument_bytes"] / 1e9,
                 "t_compute_ms": one["roofline"]["t_compute_s"] * 1e3,
                 "t_memory_ms": one["roofline"]["t_memory_s"] * 1e3,
                 "t_collective_ms":
                     one["roofline"]["t_collective_s"] * 1e3,
                 "useful_flops_ratio":
                     one["roofline"]["useful_flops_ratio"]},
         bench_s=bench_s)


def plans(torch, dev):
    """The launch plans the redesigned kernels chose at the path shapes:
    K1's and K6's threads a row, K2's chunks, K7's strips, clusters and
    CTAs, K4's and K5's routes, tiles and stages."""
    from repro_torch.kernels import _launch
    from repro_torch.kernels.batched_alpha import kernel as ba_k
    from repro_torch.kernels.coded_combine import kernel as cc_k
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
    cc = {f"{kind} n={n} D={PATH_D[0]}":
          cc_k.plan_combine(kind, n, PATH_D[0], 1, sms)._asdict()
          for kind, ns in (("quantized", (1, 2, 3, 4)), ("packed", (1, 2, 4)))
          for n in ns}
    cc.update({f"{kind} n=4 D={PATH_D[1]}":
               cc_k.plan_combine(kind, 4, PATH_D[1], 1, sms)._asdict()
               for kind in ("quantized", "packed")})
    _say("plans", sms=sms, rmsnorm=rn, fused_error=ba,
         decode_attention=da, gram_matvec=sm, combine=cc)


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
    # the model axis's shape: granite-3-8b's heads on one of two model
    # ranks (16 query heads over 4 KV heads, G = 4)
    check_decode_attention(torch, dev, 8, 16, 4, 1024, 128, "bfloat16",
                           rng.integers(1, 1025, 8).tolist(),
                           "model axis M=2 B=8 H=16 KVH=4 S=1024 ragged")
    # zamba2-1.2b's shared attention on one of two model ranks (16 query
    # heads over 16 KV heads, G = 1, Dh 64)
    for dtype in ("bfloat16", "float32"):
        check_decode_attention(torch, dev, 8, 16, 16, 1024, 64, dtype,
                               rng.integers(1, 1025, 8).tolist(),
                               f"{MA_ZAMBA2_K2} {dtype}")
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

    # ---- long sequences: blockwise attention, the 32k prefill
    t0 = time.perf_counter()
    long_attention(torch, dev)
    phases["long_attention"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    prefill_32k(torch, dev)
    phases["prefill_32k"] = time.perf_counter() - t0

    # ---- the training path: four runs, each zeroed before, read after
    t0 = time.perf_counter()
    train_counts, dedup = train_runs(torch, dev)
    phases["train"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    remat(torch, dev, dedup)
    phases["remat"] = time.perf_counter() - t0
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
    for name, v in distributed(torch, dev, card).items():
        train_counts[name] += v
    phases["distributed"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    for name, v in model_axis(torch, dev, card).items():
        train_counts[name] += v
    phases["model_axis"] = time.perf_counter() - t0
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

    # ---- the benchmark suite and the dry-run
    t0 = time.perf_counter()
    benchmarks(torch, dev, card)
    phases["benchmarks"] = time.perf_counter() - t0
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
