"""How far two training runs part when only rounding differs, on the card.

    python tools/train_divergence.py          # from the repository root
    python tools/train_divergence.py --only "8 layers"   # cases by name

For each case, runs the training driver (``repro_torch.launch.train``)
on one NVIDIA GPU several ways from the same seed and prints the largest
relative gap between the loss streams of each pair, as one JSON line:

- ``kernel_vs_kernel``, ``plain_vs_plain``: a run repeated (0 when the
  run is deterministic);
- ``kernel_vs_plain``: through the hand kernels against their plain
  versions (``_FORCE = "ref"``), the gap the kernels' rounding opens;
- ``plain_vs_perturbed``: the plain versions against themselves with
  every float parameter multiplied by (1 + 1e-7 N(0, 1)), the gap any
  rounding-sized change opens -- the yardstick for the first;
  ``kernel_vs_perturbed`` the same through the kernels, and
  ``*_steps`` each pair's gap step by step.

Cases: zamba2-1.2b's 4-layer smoke config (float32, lr 3e-3, 6 steps),
xlstm-1.3b at full width and 16 layers (bf16, lr 1e-4, 12 steps),
xlstm-1.3b at full width and 8 layers as ``chip_smoke.py``'s model-axis
runs train it (float32, lr 1e-4, 4 steps of 4,096 tokens), and
granite-3-8b's smoke config as a control.
"""

import argparse
import contextlib
import io
import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))

from repro_torch import tree as T  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels.rmsnorm import ops as rn_ops  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.models import model as M  # noqa: E402

SMOKE = ["--steps", "6", "--seq-len", "32", "--block-size", "2",
         "--log-every", "1", "--seed", "0"]
CASES = (
    ("zamba2-1.2b smoke, 4 layers", get_config("zamba2-1.2b")
     .smoke_variant().with_overrides(n_layers=4, attn_positions=(1, 3)),
     SMOKE),
    ("xlstm-1.3b, 16 layers", get_config("xlstm-1.3b")
     .with_overrides(n_layers=16),
     ["--steps", "12", "--seq-len", "256", "--block-size", "4", "--lr",
      "1e-4", "--log-every", "4", "--seed", "0"]),
    ("xlstm-1.3b, 8 layers, float32", get_config("xlstm-1.3b")
     .with_overrides(n_layers=8, dtype="float32"),
     ["--steps", "4", "--seq-len", "256", "--block-size", "4",
      "--machines", "4", "--scheme", "expander", "--replication", "2",
      "--straggler-model", "bernoulli", "--straggler-p", "0.2", "--lr",
      "1e-4", "--log-every", "4", "--seed", "0"]),
    ("granite-3-8b smoke", get_config("granite-3-8b").smoke_variant(),
     SMOKE),
)
PERTURB = 1e-7


def losses(cfg, argv, force, perturb=0.0):
    init = M.init_params

    def perturbed(c, **kw):
        g = torch.Generator(device="cuda").manual_seed(123)
        return T.map(lambda t: t * (1 + perturb * torch.randn(
            t.shape, generator=g, device=t.device)), init(c, **kw))

    rn_ops._FORCE = force
    if perturb:
        M.init_params = perturbed
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            return np.asarray(train.main(argv, cfg=cfg)["losses"])
    finally:
        M.init_params = init
        rn_ops._FORCE = None


def steps(a, b):
    return np.abs(a / b - 1).tolist()


def gap(a, b):
    return float(np.max(np.abs(a / b - 1)))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", default="",
                    help="run the cases whose name holds this text")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("train_divergence: needs an NVIDIA GPU")
    for name, cfg, cli in CASES:
        if args.only not in name:
            continue
        k1, k2 = losses(cfg, cli, None), losses(cfg, cli, None)
        p1, p2 = losses(cfg, cli, "ref"), losses(cfg, cli, "ref")
        pp = losses(cfg, cli, "ref", PERTURB)
        kp = losses(cfg, cli, None, PERTURB)
        print(json.dumps({
            "case": name, "device": torch.cuda.get_device_name(0),
            "kernel_vs_kernel": gap(k1, k2), "plain_vs_plain": gap(p1, p2),
            "kernel_vs_plain": gap(k1, p1),
            "plain_vs_perturbed": gap(pp, p1),
            "kernel_vs_perturbed": gap(kp, k1), "perturbation": PERTURB,
            "kernel_vs_plain_steps": steps(k1, p1),
            "kernel_vs_perturbed_steps": steps(kp, k1),
            "kernel_losses": k1.tolist(), "plain_losses": p1.tolist()}),
            flush=True)


if __name__ == "__main__":
    main()
