"""The plain float32 reference that decides a run's ``correct``: NumPy
coding (``coding``), PyTorch model families (one module a family, found
by ``family``; pieces they share in ``model``) and the checked training
steps (``train``). It imports nothing of the program.

A configuration file names its family under ``"reference"``; the family
is the module ``trainbench.reference.<name>``, which gives:

- ``param_shapes(model)``: {leaf path: shape}, the paths of the program's
  parameter tree (``inputs.nest``);
- ``init_scale(path, shape)``: None for a leaf drawn by ``init_uniform``
  or constant (1), else the standard deviation of its normal draw;
- ``init_uniform(path, u)``: the leaf from a U(0, 1) draw of its shape,
  or None;
- ``sequence_loss(p, tokens, labels, model, q8)``: the float32 summed
  next-token loss of one sequence over the real vocabulary, ``q8``
  applied where the control rounds;
- ``step_flops(model, seq_len, sequences)``: the model FLOPs of a step
  that trains ``sequences`` distinct sequences of ``seq_len`` tokens.

``model`` is a configuration's ``"model"`` object. A new family is a new
file here and a configuration that names it.
"""

from __future__ import annotations

import importlib
import re
from types import ModuleType

INTERFACE = ("param_shapes", "init_scale", "init_uniform", "sequence_loss",
             "step_flops")


def family(name) -> ModuleType:
    """The reference family ``name``; LookupError, naming it, where
    there is no such family."""
    if not isinstance(name, str) or not re.fullmatch(r"[a-z_][a-z0-9_]*",
                                                     name):
        raise LookupError(f"no reference family {name!r}: a family is "
                          "named by a module of trainbench/reference/")
    full = f"{__name__}.{name}"
    try:
        mod = importlib.import_module(full)
    except ModuleNotFoundError as e:
        if e.name != full:
            raise
        raise LookupError(f"no reference family {name!r}: "
                          f"trainbench/reference/{name}.py does not "
                          "exist") from None
    missing = [f for f in INTERFACE if not callable(getattr(mod, f, None))]
    if missing:
        raise LookupError(f"{full} is no reference family: it lacks "
                          f"{', '.join(missing)}")
    return mod
