"""The port's codecs against ``repro.core.compress`` (mirrors
tests/test_compress.py).

The same float32 rows go through both packages. Bitwise: the int8
payload and scale (round half to even, a float32 ``1/127`` multiply, a
true divide by the runtime scale), the sign and packed-sign payloads,
and every dequantized value whose scale is bitwise. The sign scales are
a mean, which the libraries sum in different orders: rtol 1e-6.
Also the compressed combine of the dist layer: error feedback
telescopes, dead rows cannot influence the combine, and the 'none'
codec with a zero residual is the plain combine.
"""

import numpy as np
import pytest
import torch

import repro.core.compress as R
from repro_torch import tree as T
from repro_torch.core import compress as P
from repro_torch.dist import coded_train
from repro_torch.kernels.coded_combine import ops as cc_ops

SCALE_RTOL = 1e-6


def _rows(seed, rows=5, d=1003):
    rng = np.random.default_rng(seed)
    g = (rng.normal(size=(rows, d))
         * 10.0 ** rng.integers(-3, 3, size=(rows, 1))).astype(np.float32)
    g[0, :7] = 0.0
    g[1, 3] = -0.0
    g[2] = 0.0                       # the amax == 0 guard
    g[3, 10:14] = [0.5, -0.5, 1.5, 2.5]   # ties after scaling
    return g


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("d", [1, 7, 8, 9, 64, 1003])
def test_int8_payload_and_scale_bitwise(seed, d):
    g = _rows(seed, d=max(d, 14))[:, :d].copy()
    rq, rs = R.get_codec("int8").compress(g, xp=np)
    pq, ps = P.get_codec("int8").compress(_t(g))
    assert pq.dtype == torch.int8 and ps.dtype == torch.float32
    np.testing.assert_array_equal(pq.numpy(), rq)
    np.testing.assert_array_equal(ps.numpy(), rs)
    jq, js = R.get_codec("int8").compress(g)          # jnp: same bits
    np.testing.assert_array_equal(pq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ps.numpy(), np.asarray(js))
    np.testing.assert_array_equal(
        P.get_codec("int8").decompress(pq, ps).numpy(),
        R.get_codec("int8").decompress(rq, rs, xp=np))


def test_int8_scale_is_a_float32_multiply_and_rounds_half_to_even():
    g = np.asarray([[127.0, 0.5, 1.5, 2.5, -0.5, -2.5]], np.float32)
    q, s = P.get_codec("int8").compress(_t(g))
    assert s.item() == np.float32(127.0) * np.float32(1.0 / 127.0)
    assert q.tolist() == [[127, 0, 2, 2, 0, -2]]


@pytest.mark.parametrize("name", ["sign", "sign_packed"])
@pytest.mark.parametrize("seed", [0, 1])
def test_sign_payloads_bitwise_scales_close(name, seed):
    g = _rows(seed)
    rq, rs = R.get_codec(name).compress(g, xp=np)
    pq, ps = P.get_codec(name).compress(_t(g))
    assert pq.dtype == (torch.uint8 if name == "sign_packed"
                        else torch.int8)
    np.testing.assert_array_equal(pq.numpy(), rq)
    np.testing.assert_allclose(ps.numpy(), rs, rtol=SCALE_RTOL)
    d = g.shape[1]
    np.testing.assert_allclose(
        P.get_codec(name).decompress(pq, ps, d=d).numpy(),
        R.get_codec(name).decompress(rq, rs, xp=np, d=d),
        rtol=SCALE_RTOL)


def test_sign_zero_conventions():
    """sign gives 0 at 0 and at -0.0; sign_packed maps both to bit 1."""
    g = np.asarray([[0.0, -0.0, 1.0, -1.0]], np.float32)
    q, _ = P.get_codec("sign").compress(_t(g))
    assert q.tolist() == [[0, 0, 1, -1]]
    qp, _ = P.get_codec("sign_packed").compress(_t(g))
    assert qp.tolist() == [[0b0111]]


@pytest.mark.parametrize("d", [1, 7, 8, 9, 64, 700])
def test_pack_unpack_inverse_and_unpackbits_oracle(d):
    rng = np.random.default_rng(d)
    bits = rng.integers(0, 2, size=(3, d)).astype(np.uint8)
    packed = P.pack_signs(_t(bits))
    assert packed.dtype == torch.uint8
    assert packed.shape == (3, P.packed_width(d))
    np.testing.assert_array_equal(packed.numpy(),
                                  R.pack_signs(bits, np))
    np.testing.assert_array_equal(
        np.unpackbits(packed.numpy(), axis=1, bitorder="little")[:, :d],
        bits)
    np.testing.assert_array_equal(P.unpack_signs(packed, d).numpy(), bits)
    tail = P.unpack_signs(packed).numpy()[:, d:]
    assert not tail.any()            # zero-padded trailing byte


def test_get_codec_rejects_unknown():
    with pytest.raises(ValueError, match="unknown codec"):
        P.get_codec("fp4")
    assert P.get_codec(P.CODECS["int8"]) is P.CODECS["int8"]
    for name, c in P.CODECS.items():
        rc = R.CODECS[name]
        assert (c.bits, c.wire_bits, c.packed) == \
            (rc.bits, rc.wire_bits, rc.packed)


def _params():
    rng = np.random.default_rng(0)
    return {"a": rng.normal(size=(3, 5)).astype(np.float32),
            "b": {"c": rng.normal(size=(13,)).astype(np.float32),
                  "d": rng.normal(size=(2, 2, 3)).astype(np.float32)}}


def _torch_tree(tree):
    if isinstance(tree, dict):
        return {k: _torch_tree(v) for k, v in tree.items()}
    return _t(tree)


def test_init_state_shapes_match_reference():
    import jax
    params = _params()
    rs = R.init_state(params, 4)
    ps = P.init_state(_torch_tree(params), 4)
    for r, p in zip(jax.tree.leaves(rs), T.leaves(ps)):
        assert tuple(r.shape) == tuple(p.shape)
        assert p.dtype == torch.float32 and not p.any()
    with pytest.raises(ValueError):
        P.init_state(_torch_tree(params), 0)


@pytest.mark.parametrize("codec", [None, "none", "int8", "sign",
                                   "sign_packed"])
@pytest.mark.parametrize("rows", [1, 4, 7])
def test_comm_bytes_per_step_equal(codec, rows):
    params = _params()
    rc = None if codec is None else R.get_codec(codec)
    pc = None if codec is None else P.get_codec(codec)
    assert P.comm_bytes_per_step(pc, rows, _torch_tree(params)) == \
        R.comm_bytes_per_step(rc, rows, params)


@pytest.mark.parametrize("name", ["sign", "int8", "sign_packed"])
def test_error_feedback_telescopes(name):
    """sum_t dequant_t == sum_t g_t + e_0 - e_T (float32 tolerance)."""
    rng = np.random.default_rng(1)
    codec = P.get_codec(name)
    params = {"w": torch.zeros(3, 50)}
    resid = P.init_state(params, 3)["residual"]
    total_g = torch.zeros(3, 3, 50)
    total_deq = torch.zeros(3, 3, 50)
    for _ in range(6):
        g = {"w": _t(rng.normal(size=(3, 3, 50)).astype(np.float32))}
        q, s, new_r, shapes = coded_train._quantize_rows(g, resid, codec,
                                                         True)
        total_deq += codec.decompress(q["w"], s["w"], d=150).reshape(
            3, 3, 50)
        total_g += g["w"]
        resid = new_r
    np.testing.assert_allclose(total_deq.numpy(),
                               (total_g - resid["w"]).numpy(),
                               rtol=1e-4, atol=1e-4)


def test_compress_combine_none_with_zero_residual_is_the_plain_combine():
    rng = np.random.default_rng(2)
    grads = {"a": _t(rng.normal(size=(4, 3, 5)).astype(np.float32)),
             "b": _t(rng.normal(size=(4, 9)).astype(np.float32))}
    w = _t(rng.normal(size=4).astype(np.float32))
    resid = P.init_state({"a": grads["a"][0], "b": grads["b"][0]},
                         4)["residual"]
    out, new_r = coded_train.compress_combine_tree(
        grads, resid, w, P.get_codec("none"))
    want = cc_ops.coded_combine_tree(grads, w)
    for k in grads:
        assert out[k].shape == grads[k].shape[1:]
        assert torch.equal(out[k], want[k])
        assert not new_r[k].any()


@pytest.mark.parametrize("name", ["none", "int8", "sign", "sign_packed"])
def test_dead_rows_cannot_influence_the_compressed_combine(name):
    rng = np.random.default_rng(3)
    g = _t(rng.normal(size=(4, 33)).astype(np.float32))
    g2 = g.clone()
    g2[2] = 1e3 * torch.sign(g2[2] + 0.1)
    w = torch.tensor([0.5, 1.0, 0.0, 2.0])
    codec = P.get_codec(name)
    resid = {"x": torch.zeros(4, 33)}
    a, _ = coded_train.compress_combine_tree({"x": g}, resid, w, codec)
    b, _ = coded_train.compress_combine_tree({"x": g2}, resid, w, codec)
    assert torch.equal(a["x"], b["x"])
