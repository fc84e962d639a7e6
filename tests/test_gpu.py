"""Card-only parity tests: the compiled kernels of the main path against
their plain references at the full 640x480 widths.

Run on a GPU with ``JAX_PLATFORMS=cuda python -m pytest -m gpu tests/``
(``chip_smoke.py`` does so). Elsewhere each test skips: the ``gpu_device``
fixture decides, never the import.
"""

import pytest

from slam_robot_tpu.utils import kernel_check as kc

pytestmark = pytest.mark.gpu


def test_newton_kernel_matches_xla_every_level(gpu_device):
    rows = kc.newton_errors("triton")
    assert len(rows) == 6
    for lvl, dims, err, n_over, n_status in rows:
        assert n_over == 0 and n_status == 0, (lvl, dims, err, n_over,
                                               n_status)


def test_build_pyramid_matches_numpy_full_width(gpu_device):
    assert kc.pyramid_error(480, 640, 6) < kc.PYRAMID_TOL

