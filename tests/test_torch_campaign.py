"""The port's compression campaign and the harness's new sections against
the reference, on the CPU.

``compression_campaign`` is host NumPy in both packages, and the port's
NumPy codec route copies the reference's ``xp=np`` codecs expression for
expression, so rows, payloads and scales are pinned bit for bit. The
harness's ``bounds`` and ``expansion`` sections on the CPU are the
reference's float64 path, so their rows equal ``benchmarks.bounds.run``
and ``benchmarks.expansion_ablation.run`` bit for bit too (the rounded
``cov_top3`` included). Mirrors ``tests/test_compress.py``'s campaign
tests.
"""

import numpy as np
import pytest

import repro.core as rc
from repro.core import compress as rcm
from repro_torch import core as tc
from repro_torch.core import compress as tcm
from repro_torch.launch import harness

CPU = "cpu"
P_GRID = (0.05, 0.1, 0.15, 0.2, 0.25, 0.3)
CODECS = ("none", "int8", "sign", "sign_packed")


# ------------------------------------------------------ NumPy codec route

@pytest.mark.parametrize("name", CODECS)
@pytest.mark.parametrize("shape", [(5, 37), (3, 8), (1, 1), (2, 3, 17)])
def test_host_codecs_equal_reference_numpy_codecs(name, shape):
    rng = np.random.default_rng(sum(shape))
    g = rng.normal(size=shape).astype(np.float32)
    g[..., 0] = 0.0                       # exact zeros: sign 0, packed +1
    g.reshape(-1, shape[-1])[0] = 0.0     # an all-zero row: int8 scale 1
    q_r, s_r = rcm.get_codec(name).compress(g, xp=np)
    q_t, s_t = tcm.get_codec(name).compress_host(g)
    for a, b in ((q_t, q_r), (s_t, s_r)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    d = shape[-1]
    np.testing.assert_array_equal(
        tcm.get_codec(name).decompress_host(q_t, s_t, d=d),
        rcm.get_codec(name).decompress(q_r, s_r, xp=np, d=d))


def test_host_pack_signs_equals_reference_and_unpackbits():
    bits = np.random.default_rng(3).random((4, 21)) < 0.5
    packed = tcm.pack_signs_np(bits)
    np.testing.assert_array_equal(packed, rcm.pack_signs(bits, np))
    np.testing.assert_array_equal(
        np.unpackbits(packed, axis=-1, bitorder="little")[:, :21], bits)
    np.testing.assert_array_equal(tcm.unpack_signs_np(packed, 21), bits)


# --------------------------------------------------- compression_campaign

def _both(fn, *args, **kw):
    return getattr(rc, fn)(*args, **kw), getattr(tc, fn)(*args, **kw)


def test_campaign_at_regime1_equals_reference():
    a_r, a_t = _both("expander_assignment", 24, 3, vertex_transitive=False,
                     seed=1)
    want = rcm.compression_campaign(a_r, P_GRID, trials=200, dim=512,
                                    seed=0)
    got = tcm.compression_campaign(a_t, P_GRID, trials=200, dim=512,
                                   seed=0, device=CPU)
    assert got == want
    assert got == harness.compression(device=CPU)
    harness.check_compression(got)


@pytest.mark.parametrize("kw", [
    dict(codecs=CODECS, method="fixed"),
    dict(codecs=("none", "sign_packed"), debias=False,
         majority_vote=False, seed=4)])
def test_campaign_on_an_irregular_scheme_equals_reference(kw):
    a_r, a_t = _both("bernoulli_assignment", 10, 12, 3, seed=2)
    want = rcm.compression_campaign(a_r, (0.1, 0.3), trials=40, dim=64,
                                    **kw)
    got = tcm.compression_campaign(a_t, (0.1, 0.3), trials=40, dim=64,
                                   device=CPU, **kw)
    assert got == want


def test_campaign_grid_shape_and_ordering():
    """tests/test_compress.py's shape and ordering pin, in the port."""
    A = tc.expander_assignment(8, 2, vertex_transitive=True, seed=0)
    rows = tcm.compression_campaign(A, (0.1, 0.3), trials=64, dim=128,
                                    device=CPU)
    assert len(rows) == 2 * 4
    by = {(r["codec"], r["decoding"], r["p"]): r for r in rows}
    for p in (0.1, 0.3):
        none, int8 = by[("none", "optimal", p)], by[("int8", "optimal", p)]
        sign, mv = by[("sign", "optimal", p)], by[("sign", "majority_vote",
                                                      p)]
        assert (none["bits"], int8["bits"], sign["bits"], mv["bits"]) == \
            (32, 8, 1, 1)
        assert int8["mean_error"] <= none["mean_error"] * 1.10 + 1e-3
        assert sign["mean_error"] >= none["mean_error"] - 1e-6
        assert mv["mean_error"] > none["mean_error"]


def test_campaign_is_exported_like_the_reference():
    assert "compression_campaign" in tc.__all__
    assert tc.compression_campaign is tcm.compression_campaign
    assert sorted(set(rc.__all__) - set(tc.__all__)) == []


# ------------------------------------------------- the harness's sections

def test_bounds_section_equals_reference_benchmark():
    from benchmarks import bounds as r_bounds
    rows = harness.bounds(trials=60, device=CPU)
    assert rows == r_bounds.run(trials=60)
    out = harness.run_section("bounds", True, CPU)
    assert out == {"rows": r_bounds.run(trials=150)}
    harness.check_bounds(out["rows"])


def test_expansion_section_equals_reference_benchmark():
    from benchmarks import expansion_ablation as r_exp
    rows = harness.expansion(trials=40, device=CPU)
    assert rows == r_exp.run(trials=40)
    out = harness.run_section("expansion", True, CPU)
    assert out == {"rows": r_exp.run(trials=100)}
    harness.check_expansion(out["rows"])


def test_section_asserts_catch_bad_rows():
    comp = harness.compression(trials=40, device=CPU)
    bad = [dict(r, mean_error=0.0) if r["codec"] == "sign" else r
           for r in comp]
    with pytest.raises(AssertionError, match="should exceed"):
        harness.check_compression(bad)
    bad = [dict(r, mean_error=1.0) if r["codec"] == "int8" else r
           for r in comp]
    with pytest.raises(AssertionError, match="int8"):
        harness.check_compression(bad)
    rows = harness.bounds(trials=60, device=CPU)
    with pytest.raises(AssertionError, match="fixed-decoding bound"):
        harness.check_bounds([dict(r, ours_fixed=0.0) for r in rows])
    rows = harness.expansion(trials=40, device=CPU)
    with pytest.raises(AssertionError, match="d=6"):
        harness.check_expansion([dict(r, error=1.0)
                                 if r["graph"] == "random_regular_n64_d6"
                                 else r for r in rows])


def test_cli_runs_the_new_sections_and_prints_their_rows(capsys):
    out = harness.main(["--device", CPU, "--section",
                        "bounds,expansion"])
    assert set(out["sections"]) == {"bounds", "expansion"}
    printed = capsys.readouterr().out
    assert "graph=cycle_n64_d2" in printed and "bound_any=" in printed
    assert set(harness.SECTIONS) >= {"bounds", "expansion"}
