"""Run single phases of ``chip_smoke.py`` on the card, after building the
kernels, each printing its own line; a phase that raises prints its
error and the others still run.

    python tools/smoke_phases.py long prefill remat chaos model_axis
    python tools/smoke_phases.py chaos --chaos-dtype bfloat16

Phases: ``long`` (``long_attention``), ``prefill`` (``prefill_32k``),
``remat`` (``remat``, without the train phase's dedup row), ``chaos``
(the distributed phase's chaos run on two gloo ranks against one process,
in ``--chaos-dtype`` activations, float32 by default as in
``chip_smoke.py``) and ``model_axis`` (decode_attention at the model
axis's 16/4 heads and at zamba2's 16/16 against its plain version, then
``model_axis``: two gloo ranks on layout (1, 2) and (2, 1)) and
``model_axis_families`` (zamba2's 16/16 heads, then ``model_axis``'s
zamba2-1.2b and xlstm-1.3b runs alone). Exits non-zero if any phase
raised.
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
import traceback

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

import chip_smoke as C  # noqa: E402

PHASES = ("long", "prefill", "remat", "chaos", "model_axis",
          "model_axis_families")


def _chaos(torch, dtype):
    import torch.multiprocessing as mp
    from repro_torch.configs import get_config
    cfg = get_config("granite-3-8b").with_overrides(n_layers=2,
                                                    dtype=dtype)
    one, _, _, _ = C._run_train(torch, cfg, [], None, C.DIST_CHAOS_ARGS)
    C._free(torch)
    with tempfile.TemporaryDirectory() as tmp:
        mp.spawn(C._gloo_rank, args=(tmp, {"chaos": (C.DIST_CHAOS_ARGS,
                                                     dtype)}),
                 nprocs=2, join=True)
        outs = []
        for r in range(2):
            with open(os.path.join(tmp, f"rank{r}.json")) as f:
                outs.append(json.load(f)["chaos"])
    row = C._gloo_chaos(outs, one, cfg)
    C._say("chaos", **{**row, "dtype": dtype})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("phases", nargs="+", choices=PHASES)
    ap.add_argument("--chaos-dtype", default=C.CHAOS_DTYPE,
                    choices=("float32", "bfloat16"))
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("smoke_phases: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import build
    build.build()
    dev = torch.device("cuda")
    failed = []
    for name in args.phases:
        t0 = time.perf_counter()
        try:
            if name == "long":
                C.long_attention(torch, dev)
            elif name == "prefill":
                C.prefill_32k(torch, dev)
            elif name == "remat":
                C.remat(torch, dev, {"ms_per_step": None,
                                     "peak_mem_gb": None})
            elif name in ("model_axis", "model_axis_families"):
                import numpy as np
                rng = np.random.default_rng(0)
                if name == "model_axis":
                    C.check_decode_attention(
                        torch, dev, 8, 16, 4, 1024, 128, "bfloat16",
                        rng.integers(1, 1025, 8).tolist(),
                        "model axis M=2 B=8 H=16 KVH=4 S=1024 ragged")
                for dtype in ("bfloat16", "float32"):
                    C.check_decode_attention(
                        torch, dev, 8, 16, 16, 1024, 64, dtype,
                        rng.integers(1, 1025, 8).tolist(),
                        f"{C.MA_ZAMBA2_K2} {dtype}")
                card = subprocess.run(
                    ["nvidia-smi", "--query-gpu=name,power.limit",
                     "--format=csv,noheader"], capture_output=True,
                    text=True, timeout=60).stdout.strip()
                C.model_axis(torch, dev, card, archs=(
                    None if name == "model_axis" else
                    tuple(a for a, _ in C.MA_FAMILIES)))
            else:
                _chaos(torch, args.chaos_dtype)
        except Exception:           # report it, run the other phases
            traceback.print_exc()
            failed.append(name)
        C._say("phase", name=name, seconds=time.perf_counter() - t0)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
