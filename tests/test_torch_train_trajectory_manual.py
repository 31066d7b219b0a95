"""The port's train steps against the reference's over three AdamW
steps, on the CPU, for one coded path of the trajectory pin
(``torch_train_common.check_trajectory``, which states the tolerances;
the file per path lets the suite's workers run the paths side by
side)."""

import pytest

from torch_train_common import _two_threads, check_trajectory  # noqa: F401

PATH = "manual"


@pytest.mark.parametrize("compress", [None, "int8", "sign_packed"])
@pytest.mark.parametrize("path", [PATH])
def test_train_step_trajectory_matches_reference(compress, path):
    check_trajectory(compress, path)
