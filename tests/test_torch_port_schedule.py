"""Port schedule tables vs the JAX package's: exactly equal, byte for byte."""

import numpy as np
import pytest

from ddim_cold_torch.ops import schedule as port
from ddim_cold_tpu.ops import schedule as ref

T = 2000


@pytest.mark.parametrize("k,t_start", [(1, None), (20, None), (500, None),
                                       (20, 1000), (500, 1000), (7, 1234)])
def test_ddim_tables_identical(k, t_start):
    np.testing.assert_array_equal(port.ddim_time_sequence(T, k, t_start),
                                  ref.ddim_time_sequence(T, k, t_start))
    a, b = port.ddim_coefficients(T, k, t_start), ref.ddim_coefficients(T, k, t_start)
    for field in ref.DDIMCoefficients._fields:
        x, y = getattr(a, field), getattr(b, field)
        assert x.dtype == y.dtype and x.shape == y.shape, field
        assert x.tobytes() == y.tobytes(), field


def test_stochastic_tables_identical():
    a = port.ddim_coefficients(T, 20, None, eta=0.5)
    b = ref.ddim_coefficients(T, 20, None, eta=0.5)
    for field in ref.DDIMCoefficients._fields:
        assert getattr(a, field).tobytes() == getattr(b, field).tobytes(), field


def test_alpha_helpers_identical():
    t = np.arange(0, T, 37)
    np.testing.assert_array_equal(port.alpha_bar(t, T), ref.alpha_bar(t, T))
    np.testing.assert_array_equal(port.alpha_bar(t, T, port.ALPHA_EPS),
                                  ref.alpha_bar(t, T, ref.ALPHA_EPS))
    for t_start in (1, 500, 1999):
        assert (port.forward_noise_alpha(t_start, T)
                == ref.forward_noise_alpha(t_start, T))
