"""The port's flow modulation m(t) against the JAX package's, on the CPU.

The reference computes m inside its compiled scan, in the state's dtype
(``kid_tpu/driver/loop.py:231-232``); the port computes it on the host
(``Case.time_modulation``).  At every step of four cases: equal bit for
bit in float64, and within one ulp in float32, where the reference's
float32 sine and a correctly rounded one part at a few steps.
"""
from __future__ import annotations

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from kid_tpu.driver import cases as jcases
from kid_tpu_torch.driver import cases as tcases

CASES = ["mixed1", "warm1", "cumulus2d", "orographic2d"]
# float32 steps at which the port's m is one ulp off the reference's:
# at most 12 of a case's steps (warm1: 12 of 3600)
MAX_F32_ULP_STEPS = 16


def _jax_m(case, dtype):
    """m at every step of ``case``, as the reference's scan computes it."""
    def body(carry, istep):
        t = istep.astype(dtype) * case.dt
        return carry, case.time_modulation(t)

    _, m = jax.jit(lambda steps: jax.lax.scan(body, 0, steps))(
        jnp.arange(case.n_steps))
    return np.asarray(m)


@pytest.mark.parametrize("name", CASES)
def test_time_modulation_f64_bit_for_bit(name):
    want = _jax_m(jcases.CASES[name], jnp.float64)
    case = tcases.CASES[name]
    got = np.array([case.time_modulation(i, torch.float64)
                    for i in range(case.n_steps)])
    np.testing.assert_array_equal(got, want)
    assert np.count_nonzero(got) > case.n_steps // 10


@pytest.mark.parametrize("name", CASES)
def test_time_modulation_f32_within_one_ulp(name):
    want = _jax_m(jcases.CASES[name], jnp.float32)
    case = tcases.CASES[name]
    raw = np.array([case.time_modulation(i, torch.float32)
                    for i in range(case.n_steps)])
    got = raw.astype(np.float32)
    # each value is a float32, so the port's m * w_pat rounds as the
    # reference's does
    np.testing.assert_array_equal(got.astype(np.float64), raw)
    assert want.dtype == np.float32
    ulps = np.abs(got.view(np.int32).astype(np.int64)
                  - want.view(np.int32).astype(np.int64))
    n_off = int(np.count_nonzero(ulps))
    print(f"{name}: m differs at {n_off} of {case.n_steps} float32 steps")
    assert ulps.max() <= 1
    assert n_off <= MAX_F32_ULP_STEPS
