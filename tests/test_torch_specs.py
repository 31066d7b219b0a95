"""``launch.specs.make_step_spec`` against the reference's for every arch
and shape on the production layouts: the meta tensors' shapes and dtypes
equal the reference's ``ShapeDtypeStruct``s leaf for leaf, and the
placements its ``NamedSharding`` specs. The reference builds its
shardings on a device-free ``AbstractMesh`` of the same axes."""

import jax
import pytest
from jax.sharding import AbstractMesh

from repro.configs import ALL_SHAPES as R_SHAPES
from repro.configs import ARCH_IDS, CodingConfig as RCoding
from repro.configs import get_config as r_get_config
from repro.launch import specs as r_specs
from repro_torch.configs import ALL_SHAPES, CodingConfig, get_config
from repro_torch.launch import specs
from repro_torch.launch.mesh import make_production_layout

LAYOUTS = {False: (make_production_layout(),
                   AbstractMesh((16, 16), ("data", "model"))),
           True: (make_production_layout(multi_pod=True),
                  AbstractMesh((2, 16, 16), ("pod", "data", "model")))}


def _flat(tree, leaf_fn, is_leaf=None):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_leaf)
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): leaf_fn(leaf) for path, leaf in flat}


def _port_flat(tree, leaf_fn):
    out = {}

    def walk(t, pre):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, pre + (str(k),))
        elif isinstance(t, (tuple, list)) and not _is_placement(t):
            for i, v in enumerate(t):
                walk(v, pre + (str(i),))
        else:
            out["/".join(pre)] = leaf_fn(t)
    walk(tree, ())
    return out


def _is_placement(t) -> bool:
    return isinstance(t, tuple) and all(
        e is None or isinstance(e, (str, tuple)) for e in t)


def _shape_dtype(x):
    return tuple(int(s) for s in x.shape), str(x.dtype).replace("torch.", "")


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_step_specs_equal_the_reference(arch, multi_pod):
    layout, mesh = LAYOUTS[multi_pod]
    cfg, r_cfg = get_config(arch), r_get_config(arch)
    for shape, r_shape in zip(ALL_SHAPES, R_SHAPES):
        if shape.name == "long_500k" and \
                not specs.long_500k_supported(cfg)[0]:
            continue
        spec = specs.make_step_spec(cfg, shape, layout,
                                    CodingConfig(replication=4))
        ref = r_specs.make_step_spec(r_cfg, r_shape, mesh,
                                     RCoding(replication=4))
        assert spec.kind == ref.kind and spec.window == ref.window
        got = _port_flat(spec.args, _shape_dtype)
        want = _flat(ref.args, _shape_dtype)
        assert got == want, (shape.name, set(got) ^ set(want))
        got_p = _port_flat(spec.placements, tuple)
        want_p = _flat(ref.in_shardings, lambda s: tuple(s.spec),
                       is_leaf=lambda x: hasattr(x, "spec"))
        # the reference's empty sub-trees (a replicated scalar) flatten
        # to a placement leaf here
        assert len(want_p) > 10
        assert {k: v for k, v in got_p.items() if k in want_p} == want_p
        assert set(got_p) - set(want_p) <= {"3"}, shape.name


def test_fsdp_spec_places_params_and_moments_alike():
    layout = make_production_layout()
    cfg = get_config("yi-34b")
    shape = {s.name: s for s in ALL_SHAPES}["train_4k"]
    spec = specs.make_step_spec(cfg, shape, layout, fsdp=True)
    params_p, opt_p = spec.placements[0], spec.placements[1]
    assert opt_p["m"] is params_p and opt_p["v"] is params_p
    assert opt_p["step"] == ()
    assert all(p.device.type == "meta" for p in
               jax.tree_util.tree_leaves(spec.args[0]))
