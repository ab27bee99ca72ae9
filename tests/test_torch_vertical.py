"""The kernels' vertical helpers (``kid_tpu_torch/micro/csrc/thompson.cuh``)
as NumPy models laid out exactly as the kernels order them, held against
the port's plain forms and the JAX package's.

A column of nz levels is one block of nz rounded up to whole warps; level
k is lane k % 32 of warp k // 32, and the padding threads above nz take
part with their flag off.  The models:

  * ``suffix_min`` / ``fill_down``: a 5-step scan inside each warp (the
    value of lane + off arrives by __shfl_down_sync; past lane 31 the
    scan's identity), then each warp's lane-0 total in a slot, and each
    thread combines its own with the slots of the warps above it;
  * ``block_max``: a max per warp, one slot per warp, a max over the slots;
  * the sedimentation substep's inflow: the next lane's flux, lane 31
    the next warp's lane 0 through its slot, the top level its own flux
    times 0.

Each is held bit for bit against the layout the kernels had before (a
log-doubling scan over the whole block through shared memory, an atomic
max), and by value against ``kid_tpu_torch.micro.solver`` and
``kid_tpu.micro.solver`` (``kernel=True`` is the JAX package's Pallas
form).  Inputs carry NaNs of two payloads, both infinities, signed zeros
and many ties.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kid_tpu.micro import solver as jsolver
from kid_tpu_torch.micro import solver as tsolver

WARP = 32
NZ = [2, 31, 32, 33, 64, 97, 120, 130, 256]
NCOL = 12
NAN_A = np.array([0x7FF8000000000001], np.uint64).view(np.float64)[0]
NAN_B = np.array([0x7FF8000000000abc], np.uint64).view(np.float64)[0]


def mn(a, b):
    """The kernels' NaN-propagating min: a if a is NaN or a < b, else b."""
    return np.where(np.isnan(a) | (a < b), a, b)


def threads(nz: int) -> int:
    return (nz + WARP - 1) // WARP * WARP


def pad(v, nz, fill):
    """(ncol, nz) -> (ncol, threads(nz)), the padding threads at ``fill``."""
    out = np.empty((v.shape[0], threads(nz)), v.dtype)
    out[:, :nz] = v
    out[:, nz:] = fill
    return out


def lane_shift(a, off, fill):
    """What lane l receives from __shfl_down_sync(a, off) per warp, with
    ``fill`` where l + off leaves the warp; a is (ncol, warps, 32)."""
    out = np.empty_like(a)
    out[..., :WARP - off] = a[..., off:]
    out[..., WARP - off:] = fill
    return out


def column(nz: int, seed: int):
    """Values with NaNs of two payloads, infinities, signed zeros and
    ties, and flags, for NCOL columns (one all off, one all on)."""
    rng = np.random.default_rng(seed)
    pool = np.array([NAN_A, NAN_B, np.inf, -np.inf, 0.0, -0.0, 1.0, -1.0,
                     2.5, 2.5, 1e30])
    v = rng.normal(size=(NCOL, nz)) * 10.0 ** rng.integers(-3, 4, (NCOL, nz))
    special = rng.random((NCOL, nz)) < 0.25
    v = np.where(special, rng.choice(pool, (NCOL, nz)), v)
    v[1] = rng.choice([1.0, -0.0, 0.0, 3.0], nz)   # ties only
    v[2] = np.where(np.isnan(v[2]), 7.0, v[2])     # no NaN
    flag = rng.random((NCOL, nz)) < rng.random((NCOL, 1))
    flag[0] = False
    flag[3] = True
    return v, flag


# ---- the kernels' layouts -------------------------------------------------

def suffix_min_warps(v, valid):
    """thompson.cuh::suffix_min: warp scan, slots, combine."""
    ncol, nz = v.shape
    cur = pad(np.where(valid, v, np.inf), nz, np.inf)
    cur = cur.reshape(ncol, -1, WARP)
    off = 1
    while off < WARP:
        cur = mn(cur, lane_shift(cur, off, np.inf))
        off *= 2
    slots = cur[..., 0]
    above = np.full_like(slots, np.inf)
    for w in range(slots.shape[1] - 2, -1, -1):
        acc = np.full(ncol, np.inf)
        for u in range(slots.shape[1] - 1, w, -1):
            acc = mn(slots[:, u], acc)
        above[:, w] = acc
    return mn(cur, above[..., None]).reshape(ncol, -1)[:, :nz]


def suffix_min_log_doubling(v, valid):
    """The layout before: log-doubling over the block in shared memory."""
    nz = v.shape[1]
    cur = pad(np.where(valid, v, np.inf), nz, np.inf)
    n, off = cur.shape[1], 1
    while off < n:
        o = np.concatenate([cur[:, off:], np.full((cur.shape[0], off),
                                                   np.inf)], 1)
        cur = mn(cur, o)
        off *= 2
    return cur[:, :nz]


def fill_down_warps(v, flag):
    """thompson.cuh::fill_down: the (value, flag) pair of the lowest
    flagged level at or above, scanned as suffix_min."""
    ncol, nz = v.shape
    cv = pad(v, nz, v[:, -1:]).reshape(ncol, -1, WARP)   # mirrors the top
    cf = pad(flag, nz, False).reshape(ncol, -1, WARP)
    off = 1
    while off < WARP:
        ov, of = lane_shift(cv, off, 0.0), lane_shift(cf, off, False)
        cv, cf = np.where(cf, cv, ov), cf | of
        off *= 2
    sv, sf = cv[..., 0].copy(), cf[..., 0].copy()
    for w in range(cv.shape[1]):
        for u in range(w + 1, cv.shape[1]):
            take = ~cf[:, w] & sf[:, u, None]
            cv[:, w] = np.where(take, sv[:, u, None], cv[:, w])
            cf[:, w] |= take
    return np.where(cf, cv, 0.0).reshape(ncol, -1)[:, :nz]


def fill_down_log_doubling(v, flag):
    nz = v.shape[1]
    cv, cf = pad(v, nz, v[:, -1:]), pad(flag, nz, False)
    n, off = cv.shape[1], 1
    while off < n:
        zeros = np.zeros((cv.shape[0], off))
        ov = np.concatenate([cv[:, off:], zeros], 1)
        of = np.concatenate([cf[:, off:], zeros.astype(bool)], 1)
        cv, cf = np.where(cf, cv, ov), cf | of
        off *= 2
    return np.where(cf, cv, 0.0)[:, :nz]


def block_max_warps(v, nz):
    """thompson.cuh::block_max: __reduce_max_sync per warp, slots, max."""
    per_warp = pad(v, nz, 0).reshape(v.shape[0], -1, WARP).max(-1)
    r = np.zeros(v.shape[0], v.dtype)
    for w in range(per_warp.shape[1]):
        r = np.maximum(r, per_warp[:, w])
    return r


def block_max_atomic(v, nz):
    """The layout before: atomicMax of the positive values into a 0."""
    r = np.zeros(v.shape[0], v.dtype)
    for k in range(threads(nz)):
        vk = v[:, k] if k < nz else np.zeros_like(r)
        r = np.where(vk > 0, np.maximum(r, vk), r)
    return r


def inflow_warps(sed, nz):
    """thompson.cuh::sweep's inflow from the level above."""
    ncol = sed.shape[0]
    s = pad(sed, nz, sed[:, -1:]).reshape(ncol, -1, WARP)
    up = lane_shift(s, 1, 0.0)
    up[..., :-1, WARP - 1] = s[..., 1:, 0]       # lane 31 <- next warp's slot
    up = up.reshape(ncol, -1)
    s = s.reshape(ncol, -1)
    k = np.arange(s.shape[1])
    with np.errstate(invalid="ignore"):       # inf * 0 is NaN, as on the card
        up = np.where(k + 1 >= nz, s * 0.0, up)
    return up[:, :nz]


def inflow_shared(sed, nz):
    """The layout before: sh.a[k + 1], the top sh.a[nz - 1] * 0."""
    out = np.empty_like(sed)
    out[:, :-1] = sed[:, 1:]
    with np.errstate(invalid="ignore"):
        out[:, -1] = sed[:, -1] * 0.0
    return out


def bits(a):
    return np.ascontiguousarray(a, np.float64).view(np.uint64)


# ---- tests ----------------------------------------------------------------

@pytest.mark.parametrize("nz", NZ)
def test_suffix_min_warp_layout_is_bit_identical(nz):
    v, flag = column(nz, nz)
    for valid in (np.ones_like(flag), flag):
        np.testing.assert_array_equal(
            bits(suffix_min_warps(v, valid)),
            bits(suffix_min_log_doubling(v, valid)))


@pytest.mark.parametrize("nz", NZ)
def test_suffix_min_matches_port_and_jax(nz):
    v, _ = column(nz, 100 + nz)
    got = suffix_min_warps(v, np.ones(v.shape, bool))
    np.testing.assert_array_equal(
        got, tsolver._cummin_rev(torch.from_numpy(v)).numpy())
    np.testing.assert_array_equal(
        got, np.asarray(jsolver._cummin_rev(jnp.asarray(v))))
    # the Pallas form pads with 3.4e38 where the kernel pads with +inf: the
    # two differ exactly where the whole suffix is +inf
    np.testing.assert_array_equal(
        np.where(got == np.inf, 3.4e38, got),
        np.asarray(jsolver._cummin_rev(jnp.asarray(v), kernel=True)))


@pytest.mark.parametrize("nz", NZ)
def test_fill_down_warp_layout_is_bit_identical(nz):
    v, flag = column(nz, 200 + nz)
    np.testing.assert_array_equal(bits(fill_down_warps(v, flag)),
                                  bits(fill_down_log_doubling(v, flag)))


@pytest.mark.parametrize("nz", NZ)
def test_fill_down_matches_port_and_jax(nz):
    v, flag = column(nz, 300 + nz)
    got = fill_down_warps(v, flag)
    np.testing.assert_array_equal(
        got, tsolver._fill_down(torch.from_numpy(v),
                                torch.from_numpy(flag)).numpy())
    for kernel in (False, True):
        np.testing.assert_array_equal(
            got, np.asarray(jsolver._fill_down(jnp.asarray(v),
                                               jnp.asarray(flag), kernel)))


@pytest.mark.parametrize("nz", NZ)
def test_block_max_matches_atomic_port_and_jax(nz):
    rng = np.random.default_rng(400 + nz)
    kk = np.arange(nz)
    mask = rng.random((NCOL, nz)) < rng.random((NCOL, 1))
    mask[0] = False
    for v in (np.where(mask, kk, 0),                        # k0, ksed
              np.where(mask, rng.integers(0, 7, (NCOL, nz)), 0)):  # nstep
        got = block_max_warps(v, nz)
        np.testing.assert_array_equal(got, block_max_atomic(v, nz))
        np.testing.assert_array_equal(
            got, torch.from_numpy(v).amax(-1).numpy())
        np.testing.assert_array_equal(got, np.asarray(jnp.max(v, axis=-1)))


@pytest.mark.parametrize("nz", NZ)
def test_sweep_inflow_matches_shared_and_plain_shift(nz):
    v, _ = column(nz, 500 + nz)
    got = inflow_warps(v, nz)
    np.testing.assert_array_equal(bits(got), bits(inflow_shared(v, nz)))
    # the plain versions' shift_up (solver._sweep of both packages)
    t = torch.from_numpy(v)
    np.testing.assert_array_equal(
        bits(got), bits(torch.cat([t[..., 1:], t[..., -1:] * 0.0],
                                  -1).numpy()))
