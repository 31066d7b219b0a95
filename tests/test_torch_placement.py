"""The port's placement arithmetic against the reference's on both
production layouts, for every arch: parameter placements (replicated
and FSDP), their per-device bytes, and decode-cache placements.

The reference functions read only a mesh's ``shape`` and
``axis_names``, so they are handed the port's ``Layout`` itself: no 512
virtual devices. The reference's placements are ``PartitionSpec``s,
compared as the tuples they are."""

import jax
import pytest

from repro.configs import ARCH_IDS, get_config as r_get_config
from repro.dist import sharding as r_rules
from repro.launch import specs as r_specs
from repro.models import model as RM
from repro_torch import tree as T
from repro_torch.configs import ALL_SHAPES, get_config
from repro_torch.dist import sharding as rules
from repro_torch.launch import specs
from repro_torch.launch.mesh import (Layout, make_production_layout,
                                     make_test_layout, num_coded_workers)
from repro_torch.models import model as M

LAYOUTS = {"16x16": make_production_layout(),
           "2x16x16": make_production_layout(multi_pod=True)}


def _ref_flat(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, tuple))
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): tuple(leaf) for path, leaf in flat}


def _port_flat(tree):
    keys, leaves = T.flatten(tree)
    return dict(zip(keys, leaves))


@pytest.fixture(scope="module")
def ref_params():
    return {a: jax.eval_shape(lambda a=a: RM.init_params(
        r_get_config(a), jax.random.PRNGKey(0))) for a in ARCH_IDS}


def test_layouts():
    single, multi = LAYOUTS["16x16"], LAYOUTS["2x16x16"]
    assert single.shape == {"data": 16, "model": 16} and single.size == 256
    assert multi.shape == {"pod": 2, "data": 16, "model": 16}
    assert multi.size == 512
    assert num_coded_workers(single) == 16
    assert num_coded_workers(multi) == 32
    assert rules.data_axes(multi) == ("pod", "data")
    assert make_test_layout().shape == {"data": 1, "model": 1}
    with pytest.raises(ValueError):
        Layout(("data",), (1, 2))


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_placements_and_bytes_equal_the_reference(arch, layout,
                                                        ref_params):
    lay = LAYOUTS[layout]
    params = specs.meta_params(get_config(arch))
    ref = ref_params[arch]
    for fn, r_fn in ((rules.safe_param_specs, r_rules.safe_param_specs),
                     (rules.fsdp_specs, r_rules.fsdp_specs)):
        placed, r_placed = fn(params, lay), r_fn(ref, lay)
        assert _port_flat(placed) == _ref_flat(r_placed), fn.__name__
        assert rules.bytes_per_device(params, placed, lay) == \
            r_rules.bytes_per_device(ref, r_placed, lay), fn.__name__


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_placements_equal_the_reference(arch, layout):
    lay = LAYOUTS[layout]
    cfg, r_cfg = get_config(arch), r_get_config(arch)
    src = cfg.prefix_len if cfg.arch_type == "audio" else 0
    for B in (1, 128):
        cache = M.init_decode_cache(cfg, B, 64, pos=3, src_len=src,
                                    device="meta")
        r_cache = jax.eval_shape(lambda: RM.init_decode_cache(
            r_cfg, B, 64, pos=3, src_len=src))
        for repl in (False, True):
            got = _port_flat(rules.cache_specs(cache, lay,
                                               batch_replicated=repl))
            want = _ref_flat(r_rules.cache_specs(r_cache, lay,
                                                 batch_replicated=repl))
            assert got == want, (B, repl)
            assert rules.bytes_per_device(
                cache, rules.cache_specs(cache, lay,
                                         batch_replicated=repl), lay) == \
                r_rules.bytes_per_device(
                    r_cache, r_rules.cache_specs(
                        r_cache, lay, batch_replicated=repl), lay)


def test_cache_batch_dim_matches_the_reference_and_the_pool():
    from repro_torch.serve import cache_pool
    for keys in ((), ("enc",), ("layers", "k"), ("ssm", "h")):
        assert rules.cache_batch_dim(keys) == r_rules.cache_batch_dim(keys)
    assert cache_pool.cache_batch_dim is rules.cache_batch_dim


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_yi34b_fsdp_is_at_most_an_eighth_of_replicated(layout):
    """The reference's slow FSDP acceptance (tests/test_system.py), as
    arithmetic."""
    lay = LAYOUTS[layout]
    params = specs.meta_params(get_config("yi-34b"))
    repl = rules.bytes_per_device(
        params, rules.safe_param_specs(params, lay), lay)
    fsdp = rules.bytes_per_device(params, rules.fsdp_specs(params, lay),
                                  lay)
    assert fsdp * 8 <= repl


def test_long_500k_skip_policy():
    ok, why = specs.long_500k_supported(get_config("seamless-m4t-large-v2"))
    assert not ok and "500k" in why
    for arch in ("xlstm-1.3b", "zamba2-1.2b", "qwen1.5-4b"):
        ok, _ = specs.long_500k_supported(get_config(arch))
        assert ok
    for arch in ARCH_IDS:
        assert specs.long_500k_supported(get_config(arch)) == \
            r_specs.long_500k_supported(r_get_config(arch))
        assert specs.decode_supported(get_config(arch))
    long = {s.name: s for s in ALL_SHAPES}["long_500k"]
    with pytest.raises(ValueError):
        specs.make_step_spec(get_config("seamless-m4t-large-v2"), long,
                             LAYOUTS["16x16"])
