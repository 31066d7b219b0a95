"""The port's data pipeline against ``repro.data.pipeline``: the same
NumPy code, so the synthetic batches, the coded (replicated) batches and
the unique-block batches must be bit-identical for every scheme."""

import numpy as np
import pytest

from repro.core.assignment import (Assignment as RAssignment,
                                   expander_assignment as r_expander,
                                   frc_assignment as r_frc,
                                   uncoded_assignment as r_uncoded)
from repro.data import pipeline as R
from repro_torch.core.assignment import (Assignment as TAssignment,
                                         expander_assignment as t_expander,
                                         frc_assignment as t_frc,
                                         uncoded_assignment as t_uncoded)
from repro_torch.data import pipeline as P


def _irregular(cls):
    """Machine loads {2, 1, 2, 1}: padded slots in the coded batch."""
    A = np.zeros((3, 4))
    A[0, 0] = A[1, 0] = A[0, 1] = 1.0
    A[1, 2] = A[2, 2] = A[2, 3] = 1.0
    return cls(A=A, name="irregular")


SCHEMES = {
    "expander": (lambda: r_expander(8, 2, vertex_transitive=True, seed=1),
                 lambda: t_expander(8, 2, vertex_transitive=True, seed=1)),
    "frc": (lambda: r_frc(6, 2), lambda: t_frc(6, 2)),
    "uncoded": (lambda: r_uncoded(4), lambda: t_uncoded(4)),
    "irregular": (lambda: _irregular(RAssignment),
                  lambda: _irregular(TAssignment)),
}


def _equal(a: dict, b: dict):
    assert set(a) == set(b)
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("step", [0, 1, 17])
@pytest.mark.parametrize("seed", [0, 5])
def test_synthetic_lm_batch_bit_identical(step, seed):
    r = R.SyntheticLM(vocab_size=512, seq_len=33, seed=seed)
    t = P.SyntheticLM(vocab_size=512, seq_len=33, seed=seed)
    _equal(r.batch(12, step), t.batch(12, step))


@pytest.mark.parametrize("name", list(SCHEMES))
@pytest.mark.parametrize("shuffle_seed", [0, 3, None])
def test_code_batch_and_unique_blocks_bit_identical(name, shuffle_seed):
    ra, ta = (f() for f in SCHEMES[name])
    rb = R.CodedBatcher(ra, shuffle_seed=shuffle_seed)
    tb = P.CodedBatcher(ta, shuffle_seed=shuffle_seed)
    np.testing.assert_array_equal(rb.block_ids, tb.block_ids)
    np.testing.assert_array_equal(rb.block_mask, tb.block_mask)
    np.testing.assert_array_equal(rb.rho, tb.rho)
    raw = R.SyntheticLM(512, 16, seed=2).batch(ra.n * 3, 4)
    _equal(rb.code_batch(raw), tb.code_batch(raw))
    _equal(rb.unique_blocks(raw), tb.unique_blocks(raw))


def test_data_iterator_bit_identical():
    ra, ta = (f() for f in SCHEMES["expander"])
    rit = R.data_iterator(R.SyntheticLM(512, 8), R.CodedBatcher(ra),
                          ra.n * 2, 3)
    tit = P.data_iterator(P.SyntheticLM(512, 8), P.CodedBatcher(ta),
                          ta.n * 2, 3)
    for rb, tb in zip(rit, tit):
        _equal(rb, tb)


def test_indivisible_global_batch_raises():
    tb = P.CodedBatcher(t_uncoded(4))
    raw = P.SyntheticLM(64, 4).batch(6, 0)
    with pytest.raises(ValueError, match="not divisible"):
        tb.code_batch(raw)
    with pytest.raises(ValueError, match="not divisible"):
        tb.unique_blocks(raw)
