"""PyTorch port's distribution over ranks, on the CPU under gloo, with
each rank a spawned process.

``halo_exchange_x`` on 2 and 4 ranks against the periodic wrap of the
global array, and ``sharded_tendency_x`` on 4 ranks against
``advective_tendency_x`` of the global field, bit for bit;
``simulate_sharded`` on 4 ranks against the port's ``simulate`` at the
sizes of ``tests/test_dist.py`` (cumulus2d 32 x 24, 15 steps;
orographic2d 16 x 24, 5 steps; float64), bit for bit, and against the JAX
package's ``simulate`` at the ``test_torch_solver.assert_equiv`` model
(precip rtol 1e-8); a widened 1-D case gets no x flux; one rank equals
``simulate`` and two ranks (``run_sharded``, the counterpart of
``tests/test_multiproc.py``); a CUDA request without a card raises.  The
split loop (the halo exchanged on the host into ghost buffers before each
step) and the loop whose step holds the exchange (``Halo.swap``, the
placement of NCCL and of the CPU) on 2 and 4 ranks, graphed through a
stand-in capture and eager, each equal ``simulate`` bit for bit in the
final state and every stream, across a chunk boundary from step 150 (so
each other's); on 2 and 4 ranks the in-step loop matches the JAX
package's ``simulate_sharded`` on as many shards at the ``assert_equiv``
model.
"""
from __future__ import annotations

import dataclasses
import functools
import tempfile
from datetime import timedelta
from pathlib import Path

import numpy as np
import pytest
import torch

from kid_tpu_torch.dist import launch as L
from kid_tpu_torch.dist import mesh as M
from kid_tpu_torch.driver import advection as tadv
from kid_tpu_torch.driver import cases as tcases
from kid_tpu_torch.driver import loop as tloop
from kid_tpu_torch.driver.loop import KidState, run_case

torch.set_num_threads(2)

PPT = ("ppt_rain", "ppt_snow", "ppt_graupel", "ppt_ice")
# the sizes of tests/test_dist.py
SHARDED = {"cumulus2d": (32, 24, 15), "orographic2d": (16, 24, 5)}
N_RANKS = 4
# the split loop's runs: from a seeded state at step 150, across a chunk
# boundary
SPLIT_STEPS, SPLIT_ISTEP0 = tloop.CHUNK_STEPS + 3, 150
# a rank whose peer is gone gives up after this, not after M.TIMEOUT
TEST_TIMEOUT = timedelta(seconds=120)


def _seeded(shape, seed=0):
    rng = np.random.default_rng(seed)
    return rng.random(shape) * np.exp(-rng.random(shape[-1:]))


def _spawn(worker, n, *args):
    """``worker(rank, n, init_method, out_dir, *args)`` on ``n`` spawned
    CPU ranks; returns each rank's saved arrays."""
    with tempfile.TemporaryDirectory() as out:
        torch.multiprocessing.spawn(
            worker, nprocs=n, join=True,
            args=(n, f"tcp://127.0.0.1:{L._free_port()}", out, *args))
        loaded = []
        for r in range(n):
            with np.load(Path(out) / f"{r}.npz") as z:
                loaded.append({k: z[k] for k in z.files})
        return loaded


def _halo_worker(rank, n, init, out, nx, nz):
    M.TIMEOUT = TEST_TIMEOUT
    group = M.make_group("cpu", "gloo", init, rank, n)
    try:
        lo, hi = M.column_block(nx, rank, n)
        saved = {}
        for axis, q in ((0, _seeded((nx, nz))), (1, _seeded((3, nx, nz)))):
            local = torch.as_tensor(np.take(q, range(lo, hi), axis))
            left, right = M.halo_exchange_x(local, group, 2, axis)
            saved[f"left{axis}"], saved[f"right{axis}"] = left, right
        saved["calls"] = np.array(M.halo_exchange_x.calls)
        np.savez(Path(out) / f"{rank}.npz", **saved)
    finally:
        torch.distributed.destroy_process_group()


@pytest.mark.parametrize("n", [2, 4])
def test_halo_exchange_is_the_periodic_wrap(n):
    nx, nz = 4 * n, 5
    got = _spawn(_halo_worker, n, nx, nz)
    for axis, q in ((0, _seeded((nx, nz))), (1, _seeded((3, nx, nz)))):
        for r, g in enumerate(got):
            lo, hi = M.column_block(nx, r, n)
            want_left = np.take(q, [(lo - 2) % nx, (lo - 1) % nx], axis)
            want_right = np.take(q, [hi % nx, (hi + 1) % nx], axis)
            np.testing.assert_array_equal(g[f"left{axis}"], want_left)
            np.testing.assert_array_equal(g[f"right{axis}"], want_right)
            assert int(g["calls"]) == 2


def _tendency_worker(rank, n, init, out, name):
    M.TIMEOUT = TEST_TIMEOUT
    group = M.make_group("cpu", "gloo", init, rank, n)
    try:
        case, q, u_face, rho0 = _flow(name)
        lo, hi = M.column_block(case.nx, rank, n)
        ten = M.sharded_tendency_x(q[lo:hi].clone(), u_face[lo:hi + 1],
                                   rho0, case.dx, group)
        np.savez(Path(out) / f"{rank}.npz", ten=ten)
    finally:
        torch.distributed.destroy_process_group()


def _flow(name, nx=32, m=0.7):
    case = dataclasses.replace(tcases.CASES[name], nx=nx, nz=24)
    grid = case.grid()
    u_face = case.u0 * grid.rho0[None, :] + m * case.rhou_pattern(grid)
    return (case, torch.as_tensor(_seeded((case.nx, case.nz), 3)),
            torch.as_tensor(u_face), torch.as_tensor(grid.rho0))


@pytest.mark.parametrize("name", ["cumulus2d", "orographic2d"])
def test_sharded_tendency_x_is_bitwise(name):
    case, q, u_face, rho0 = _flow(name)
    want = tadv.advective_tendency_x(q, u_face, rho0, case.dx).numpy()
    got = np.concatenate([g["ten"] for g in _spawn(_tendency_worker,
                                                    N_RANKS, name)])
    np.testing.assert_array_equal(got, want)


def _sized(name):
    nx, nz, _ = SHARDED[name]
    return dataclasses.replace(tcases.CASES[name], nx=nx, nz=nz)


@functools.cache
def _runs(name):
    """(simulate, simulate_sharded on 4 ranks) of the sized case."""
    case, n = _sized(name), SHARDED[name][2]
    final, streams = run_case(case, torch.float64, n_steps=n, device="cpu")
    sharded = L.run_sharded(case, N_RANKS, n, torch.float64,
                            devices=["cpu"] * N_RANKS)
    return final, streams, sharded


@pytest.mark.parametrize("name", list(SHARDED))
def test_simulate_sharded_equals_simulate_bitwise(name):
    final, streams, sharded = _runs(name)
    for f in KidState._fields:
        np.testing.assert_array_equal(sharded.fields[f],
                                      getattr(final, f).numpy(), err_msg=f)
    for k in PPT:
        np.testing.assert_array_equal(sharded.ppt[k],
                                      getattr(streams, k).numpy(), err_msg=k)
    # one exchange per step on every rank, and the blocks differ
    assert [r["exchange_calls"] for r in sharded.ranks] == [
        SHARDED[name][2]] * N_RANKS
    assert float(np.std(sharded.fields["theta"], 0).max()) > 0.0


@pytest.mark.parametrize("name", list(SHARDED))
def test_simulate_sharded_matches_jax_simulate(name):
    import jax.numpy as jnp

    from kid_tpu.driver import cases as jcases
    from kid_tpu.driver.loop import initial_state as j_initial_state
    from kid_tpu.driver.loop import simulate as j_simulate
    from kid_tpu.micro.solver import device_tables as j_device_tables
    from kid_tpu.tables.cache import get_tables as j_get_tables
    from test_torch_solver import assert_equiv

    nx, nz, n = SHARDED[name]
    jcase = dataclasses.replace(jcases.CASES[name], nx=nx, nz=nz)
    jtabs = j_device_tables(j_get_tables(iiwarm=jcase.micro.iiwarm),
                            jnp.float64)
    wst, wout = j_simulate(j_initial_state(jcase, jnp.float64), jtabs,
                           jcase, n)
    sharded = _runs(name)[2]
    assert_equiv(sharded.fields, {f: np.asarray(getattr(wst, f))
                                  for f in KidState._fields})
    for k in PPT:
        np.testing.assert_allclose(sharded.ppt[k], np.asarray(getattr(wout, k)),
                                   rtol=1e-8, atol=1e-20, err_msg=k)


def _placement_worker(rank, n, init, out, name, placement):
    """``simulate_sharded`` on this rank's block of the seeded state, the
    exchange forced to ``placement`` ("split": on the host between two
    steps; "step": inside the step), through the graphed loop (the
    stand-in capture of the cache tests, which replays eagerly) and then
    the eager loop, every stream."""
    from test_torch_graph_loop import EagerCapture, _seeded, _tables
    M.TIMEOUT = TEST_TIMEOUT
    M.exchange_in_step = lambda group, device: placement == "step"
    tloop.GRAPH_DEVICE_TYPES = ("cuda", "cpu")
    tloop.CapturedStep = EagerCapture
    group = M.make_group("cpu", "gloo", init, rank, n)
    try:
        case = _sized(name)
        tables = _tables(case)
        local = M.shard_state(_seeded(case), rank, n)
        saved = {}
        for mode, graphs in (("graphed", True), ("eager", False)):
            M.halo_exchange_x.calls = 0
            final, streams = M.simulate_sharded(
                local, tables, case, SPLIT_STEPS, group, True, SPLIT_ISTEP0,
                "cpu", graphs)
            saved.update({f"{mode}/{f}": getattr(final, f)
                          for f in KidState._fields})
            saved.update({f"{mode}/{k}": getattr(streams, k) for k in PPT})
            saved.update({f"{mode}/profile/{k}": v
                          for k, v in streams.profiles.items()})
            saved[f"{mode}/calls"] = np.array(M.halo_exchange_x.calls)
        saved["captures"] = np.array(len(EagerCapture.built))
        np.savez(Path(out) / f"{rank}.npz", **saved)
    finally:
        torch.distributed.destroy_process_group()


def _check_placement(name, n, placement):
    """The graphed and the eager run on ``n`` ranks with the exchange in
    ``placement`` equal ``simulate`` bit for bit, with one exchange a step
    on every rank and one capture."""
    from test_torch_graph_loop import _seeded, _tables
    case = _sized(name)
    final, streams = tloop.simulate(_seeded(case), _tables(case), case,
                                    SPLIT_STEPS, True, SPLIT_ISTEP0,
                                    device="cpu")
    want = {**{f: getattr(final, f) for f in KidState._fields},
            **{k: getattr(streams, k) for k in PPT},
            **{f"profile/{k}": v for k, v in streams.profiles.items()}}
    assert len(want) == 12 + 4 + len(tloop.ALL_PROFILE_NAMES)
    got = _spawn(_placement_worker, n, name, placement)
    for mode in ("graphed", "eager"):
        for k, v in want.items():
            axis = 0 if k in KidState._fields else 1   # the column axis
            np.testing.assert_array_equal(
                np.concatenate([g[f"{mode}/{k}"] for g in got], axis),
                v.numpy(), err_msg=f"{mode} {k}")
        # one exchange a step on every rank
        assert [int(g[f"{mode}/calls"]) for g in got] == [SPLIT_STEPS] * n
    assert [int(g["captures"]) for g in got] == [1] * n
    assert float(streams.ppt_rain.abs().sum()) > 0.0


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("name", list(SHARDED))
def test_split_sharded_loop_equals_simulate_bitwise(name, n):
    _check_placement(name, n, "split")


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("name", list(SHARDED))
def test_in_step_sharded_loop_equals_simulate_bitwise(name, n):
    # the exchange inside the step: simulate's bits, as the split's are
    _check_placement(name, n, "step")


@pytest.mark.parametrize("n", [2, 4])
def test_in_step_sharded_matches_jax_simulate_sharded(n):
    # the placement the CPU takes, against the reference's shard_map with
    # its ppermute inside the compiled step, on as many shards
    import jax.numpy as jnp

    from kid_tpu.dist.mesh import make_mesh
    from kid_tpu.dist.mesh import simulate_sharded as j_simulate_sharded
    from kid_tpu.driver import cases as jcases
    from kid_tpu.driver.loop import initial_state as j_initial_state
    from kid_tpu.micro.solver import device_tables as j_device_tables
    from kid_tpu.tables.cache import get_tables as j_get_tables
    from test_torch_solver import assert_equiv

    nx, nz, steps = SHARDED["cumulus2d"]
    jcase = dataclasses.replace(jcases.CUMULUS2D, nx=nx, nz=nz)
    jtabs = j_device_tables(j_get_tables(iiwarm=True), jnp.float64)
    wst, wout = j_simulate_sharded(j_initial_state(jcase, jnp.float64),
                                   jtabs, jcase, steps, make_mesh(n))
    got = (_runs("cumulus2d")[2] if n == N_RANKS else
           L.run_sharded(_sized("cumulus2d"), n, steps, torch.float64,
                         devices=["cpu"] * n, profile_steps=2))
    assert [r["placement"] for r in got.ranks] == ["step"] * n
    assert all(r["exchange_share"] > 0.0 for r in got.ranks)
    if n != N_RANKS:    # the eager CPU step calls its exchange once a step
        assert [(r["profile"]["host_exchange_calls"],
                 r["profile"]["nccl_kernels"]) for r in got.ranks] == [
            (1.0, 0.0)] * n
    assert_equiv(got.fields, {f: np.asarray(getattr(wst, f))
                              for f in KidState._fields})
    for k in PPT:
        np.testing.assert_allclose(got.ppt[k], np.asarray(getattr(wout, k)),
                                   rtol=1e-8, atol=1e-20, err_msg=k)


def test_widened_1d_case_has_no_x_flux():
    case = dataclasses.replace(tcases.MIXED1, nx=8)
    final, streams = run_case(case, torch.float64, n_steps=4, device="cpu")
    sharded = L.run_sharded(case, 2, 4, torch.float64, devices=["cpu"] * 2)
    assert [r["exchange_calls"] for r in sharded.ranks] == [0, 0]
    for f in KidState._fields:
        np.testing.assert_array_equal(sharded.fields[f],
                                      getattr(final, f).numpy(), err_msg=f)
        # every column is the case's one column
        assert (sharded.fields[f] == sharded.fields[f][:1]).all(), f
    np.testing.assert_array_equal(sharded.ppt["ppt_rain"],
                                  streams.ppt_rain.numpy())


def test_one_rank_equals_simulate_and_two_ranks():
    case, n = tcases.CUMULUS2D, 10
    final, streams = run_case(case, torch.float64, n_steps=n, device="cpu")
    one, two = (L.run_sharded(case, k, n, torch.float64,
                              devices=["cpu"] * k, profile_diags=("qc",))
                for k in (1, 2))
    for f in KidState._fields:
        np.testing.assert_array_equal(one.fields[f],
                                      getattr(final, f).numpy(), err_msg=f)
    np.testing.assert_array_equal(one.ppt["ppt_rain"],
                                  streams.ppt_rain.numpy())
    report = L.compare(one, two)
    assert all(v["bitwise_equal"] for v in report.values()), report
    np.testing.assert_array_equal(one.profiles["qc"], two.profiles["qc"])
    assert one.profiles["qc"].shape == (n, case.nx, case.nz)
    assert [r["exchange_calls"] for r in two.ranks] == [n, n]


def test_cuda_request_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    case = dataclasses.replace(tcases.CUMULUS2D, nx=8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        L.run_sharded(case, 2, 1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        L.default_layout(2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        M.make_group("cuda:0")
    assert L.main(["--ranks", "2", "--steps", "1"]) == 2
    with pytest.raises(ValueError, match="do not divide"):
        L.run_sharded(case, 3, 1, devices=["cpu"] * 3)
