"""The port's schedules (cleandiffuser_tpu_torch/utils/schedules.py) against
the numpy references of tests/test_schedules.py: the published VP-SDE
formulas computed independently with numpy, the same expected values and
tolerances as the JAX package's tests."""

import numpy as np
import pytest

from cleandiffuser_tpu_torch.utils import schedules as S


def test_linear_beta_schedule():
    got = S.linear_beta_schedule(1e-4, 0.02, 100).numpy()
    np.testing.assert_allclose(got, np.linspace(1e-4, 0.02, 100), rtol=1e-6)


def test_cosine_beta_schedule():
    got = S.cosine_beta_schedule(0.008, 50).numpy()
    f = np.cos((np.arange(51) / 50 + 0.008) / 1.008 * np.pi / 2.0) ** 2
    ab = f / f[0]
    exp = np.clip(1 - ab[1:] / ab[:-1], None, 0.999)
    np.testing.assert_allclose(got, exp, rtol=1e-4, atol=1e-6)


def test_linear_noise_schedule_and_inverse():
    t = np.linspace(1e-3, 1.0, 37).astype(np.float32)
    alpha, sigma = (v.numpy() for v in S.linear_noise_schedule(t))
    np.testing.assert_allclose(alpha**2 + sigma**2, 1.0, atol=1e-6)  # VP property
    la = -(20.0 - 0.1) / 4.0 * t**2 - 0.1 / 2.0 * t
    np.testing.assert_allclose(alpha, np.exp(la), rtol=1e-5)
    t_rec = S.inverse_linear_noise_schedule(logSNR=np.log(alpha / sigma)).numpy()
    np.testing.assert_allclose(t_rec, t, atol=2e-3)


def test_cosine_noise_schedule_and_inverse():
    t = np.linspace(1e-3, 0.9946, 29).astype(np.float32)
    alpha, sigma = (v.numpy() for v in S.cosine_noise_schedule(t))
    s = 0.008
    exp_alpha = np.cos(np.pi / 2 * (t + s) / (1 + s)) / np.cos(np.pi / 2 * s / (1 + s))
    np.testing.assert_allclose(alpha, exp_alpha, atol=1e-5)
    np.testing.assert_allclose(alpha**2 + sigma**2, 1.0, atol=1e-6)
    t_rec = S.inverse_cosine_noise_schedule(logSNR=np.log(alpha / sigma)).numpy()
    np.testing.assert_allclose(t_rec, t, atol=2e-3)


def test_uniform_discretization():
    got = S.uniform_discretization(10, 1e-3).numpy()
    np.testing.assert_allclose(got, np.linspace(1e-3, 1.0, 10), rtol=1e-6)


@pytest.mark.parametrize("steps", [1, 5, 10])
def test_uniform_sampling_step_schedule(steps):
    got = S.uniform_sampling_step_schedule(1000, steps).numpy()
    assert got.shape == (steps + 1,)
    np.testing.assert_array_equal(got, np.linspace(0, 999, steps + 1).astype(np.int64))


@pytest.mark.parametrize("name", ["uniform_continuous", "quad_continuous",
                                  "cat_cos_continuous", "quad_cos_continuous"])
def test_continuous_schedules_endpoints(name):
    sched = S.SUPPORTED_SAMPLING_STEP_SCHEDULE[name]([1e-3, 1.0], 7).numpy()
    assert sched.shape == (8,)
    np.testing.assert_allclose(sched[0], 1e-3, atol=1e-5)
    np.testing.assert_allclose(sched[-1], 1.0, atol=1e-5)
    assert np.all(np.diff(sched) >= -1e-6)


@pytest.mark.parametrize("name", ["uniform", "quad", "cat_cos", "quad_cos"])
def test_discrete_schedules_endpoints(name):
    sched = S.SUPPORTED_SAMPLING_STEP_SCHEDULE[name](1000, 7).numpy()
    assert sched.shape == (8,)
    assert sched[0] == 0
    assert sched[-1] == 999


def test_karras_sigma_schedule():
    got = np.asarray(S.karras_sigma_schedule(0.002, 80.0, 7.0, 10))
    i = np.arange(11)
    exp = (0.002 ** (1 / 7) + i / 10 * (80.0 ** (1 / 7) - 0.002 ** (1 / 7))) ** 7
    np.testing.assert_allclose(got, exp, rtol=1e-4)
    assert got[0] == pytest.approx(0.002, rel=1e-3)
    assert got[-1] == pytest.approx(80.0, rel=1e-3)
