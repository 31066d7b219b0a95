"""The port's benchmark suite's training section on the CPU
(``python -m repro_torch.benchmarks.run --device cpu --fast --only
train_step``), split from ``test_torch_benchmarks.py`` so that the
suite's workers run it beside the other sections: it writes valid JSON
that names its device, its inline acceptances hold, and its rows' comm
bytes equal the reference's ``comm_bytes_per_step`` of the same
parameters."""

import jax
import pytest

from repro.configs import get_config as r_get_config
from repro.core import compress as r_compress
from repro.models import model as RM

from torch_bench_common import check_section, sections  # noqa: F401


@pytest.mark.parametrize("name", ["train_step"])
def test_section_writes_valid_json_and_passes(sections, name):  # noqa: F811
    check_section(sections, name)


def test_train_comm_bytes_equal_the_reference(sections):  # noqa: F811
    rep = sections["train_step"][1]["results"]["train_step"]
    params = jax.eval_shape(lambda: RM.init_params(
        r_get_config(rep["arch"]).smoke_variant(), jax.random.PRNGKey(0)))
    for r in rep["runs"]:
        rows = (r["m_workers"] if r["path"] == "replicated"
                else r["global_batch"] // 4)
        codec = (None if r["compress"] == "none"
                 else r_compress.get_codec(r["compress"]))
        assert r["comm_bytes_per_step"] == \
            r_compress.comm_bytes_per_step(codec, rows, params)
        assert r["comm_bytes_per_step_float32"] == \
            r_compress.comm_bytes_per_step(None, rows, params)
