"""The port's chaos ensemble (``kid_tpu_torch/validation/chaos.py``) on the
CPU.

Its noisy step against the JAX package's: ``kid_tpu.driver.loop.
make_step`` wrapped as ``prof/prof_chaos_ppt.py`` wraps it, with the same
numpy-made noise on both sides (the port reads it through a noise source
of its own interface, ``TableNoise``), mixed1 at 4 columns from a seeded
state inside the updraft pulse, 5 steps in float64, to rtol 1e-8 and atol
1e-20 (the precip tolerance of ``tests/test_torch_driver.py``).  Then the
port's own noise (``CounterNoise``): a function of seed, class, step,
field and cell alone, fresh each step for white noise and the same each
step for a persistent bias; eps 0 and no noise are ``simulate`` bit for
bit; a loop stepped in place (what a CUDA graph replays) gives the bits
of the eager loop; the envelope's spreads are the reference's formulas.
The card's capture of the noisy step is held against the eager loop by
``chip_smoke.py`` phase 12 (no CUDA graph here).
"""
from __future__ import annotations

import dataclasses
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from kid_tpu.driver import cases as jcases
from kid_tpu.driver import loop as jloop
from kid_tpu.micro.solver import device_tables as j_device_tables
from kid_tpu.tables.cache import get_tables as j_get_tables
from kid_tpu_torch.convert import tables_from_numpy
from kid_tpu_torch.driver import cases as tcases
from kid_tpu_torch.driver.loop import KidState, drive, initial_state, simulate
from kid_tpu_torch.micro.solver import device_tables
from kid_tpu_torch.tables.cache import get_tables
from kid_tpu_torch.validation import chaos as C
from test_torch_driver import _seeded_state

torch.set_num_threads(2)

NX, N_STEPS, ISTEP0 = 4, 5, 150
FIELDS = KidState._fields


class TableNoise:
    """Noise read from a (n_steps, 12, nx, nz) table, row by row at a
    step counter of its own: the noise source of a run held against one
    whose noise is the same table."""

    def __init__(self, table: np.ndarray):
        self.table = torch.from_numpy(table)
        self.step = torch.zeros(1, dtype=torch.long)

    def restart(self):
        self.step.zero_()

    def draw(self, dtype):
        u = self.table.index_select(0, self.step)[0].to(dtype)
        self.step.add_(1)
        return u


def _port_tables(case):
    return tables_from_numpy(j_get_tables(iiwarm=case.micro.iiwarm),
                             torch.float64, "cpu")


def test_noisy_step_matches_jax_make_step():
    eps = 1e-6
    jcase = dataclasses.replace(jcases.MIXED1, nx=NX)
    tcase = dataclasses.replace(tcases.MIXED1, nx=NX)
    st = _seeded_state(jcase)
    u = np.random.default_rng(7).uniform(
        -1.0, 1.0, (N_STEPS, len(FIELDS), NX, jcase.nz))
    names = C.TARGET_FIELDS

    grid = jcase.grid()
    jtabs = j_device_tables(j_get_tables(iiwarm=False), jnp.float64)
    pres2 = jnp.broadcast_to(jnp.asarray(grid.pres, jnp.float64),
                             (NX, jcase.nz))
    w_pat = jnp.asarray(jcase.rhow_pattern(grid), jnp.float64)
    jstep = jloop.make_step(jcase, jtabs, jnp.float64, w_pat, None, pres2,
                            None, names)
    ju = jnp.asarray(u)

    def noisy(s, i):      # prof/prof_chaos_ppt.py:run's noisy_step
        new, outs = jstep(s, i)
        new = jloop.KidState(*[x * (1.0 + eps * ju[i - ISTEP0, k])
                               for k, x in enumerate(new)])
        return new, outs

    jst0 = jloop.KidState(**{k: jnp.asarray(v) for k, v in st.items()})
    jfinal, raw = jax.jit(lambda s: jax.lax.scan(
        noisy, s, jnp.arange(ISTEP0, ISTEP0 + N_STEPS)))(jst0)
    want = jloop._unpack_streams(raw)

    st0 = KidState(**{k: torch.from_numpy(np.array(v)) for k, v in
                      st.items()})
    loop = C.member_loop(tcase, _port_tables(tcase), st0,
                         TableNoise(u), eps)
    final, got = drive(loop, loop.run, tcase, N_STEPS, ISTEP0)
    for f in FIELDS:
        np.testing.assert_allclose(getattr(final, f).numpy(),
                                   np.asarray(getattr(jfinal, f)),
                                   rtol=1e-8, atol=1e-20, err_msg=f)
    for k in ("ppt_rain", "ppt_snow", "ppt_graupel", "ppt_ice"):
        np.testing.assert_allclose(getattr(got, k).numpy(),
                                   np.asarray(getattr(want, k)),
                                   rtol=1e-8, atol=1e-20, err_msg=k)
    for k in names:
        np.testing.assert_allclose(got.profiles[k].numpy(),
                                   np.asarray(want.profiles[k]),
                                   rtol=1e-8, atol=1e-20, err_msg=k)
    # the noise moved the run: against the same steps without it
    plain, _ = simulate(st0, _port_tables(tcase), tcase, N_STEPS, (),
                        ISTEP0, device="cpu")
    assert not torch.equal(plain.qv, final.qv)


def test_counter_noise_is_a_function_of_seed_class_and_step():
    shape = (3, 7)
    noise = C.CounterNoise(shape, "cpu")

    def draws(seed, persistent, steps, dtype=torch.float32):
        noise.set(seed, persistent)
        out = []
        for s in steps:
            noise.step.fill_(s)
            out.append(noise.draw(dtype))
            assert int(noise.step) == s + 1        # draw moves it on
        return out

    w = draws(1, False, (0, 1, 0))
    assert w[0].shape == (len(FIELDS),) + shape
    assert w[0].dtype == torch.float32
    assert torch.equal(w[0], w[2])                 # the same step again
    assert not torch.equal(w[0], w[1])             # white: fresh each step
    assert all(((x >= -1.0) & (x < 1.0)).all() for x in w)
    p = draws(1, True, (0, 1, 57))
    assert torch.equal(p[0], p[1]) and torch.equal(p[0], p[2])
    assert not torch.equal(p[0], w[0])             # the classes differ
    assert not torch.equal(draws(2, False, (0,))[0], w[0])   # the seeds
    # fresh values in every field and cell
    assert len(torch.unique(w[0])) > 0.95 * w[0].numel()
    # float64 draws the same values
    assert torch.equal(draws(1, False, (1,), torch.float64)[0],
                       w[1].double())
    # a uniform: mean near 0, variance near 1/3
    big = C.CounterNoise((64, 120), "cpu")
    big.set(3, False)
    assert int(big.step) == 0                      # set restarts it
    big.step.fill_(5)
    u = big.draw(torch.float64)
    assert abs(float(u.mean())) < 0.01
    assert abs(float(u.var()) - 1.0 / 3.0) < 0.01


def _mixed1(nx=2):
    case = dataclasses.replace(tcases.MIXED1, nx=nx)
    tables = device_tables(get_tables(iiwarm=False), torch.float32, "cpu")
    return case, tables, initial_state(case, torch.float32, "cpu")


def test_no_noise_and_eps_zero_are_simulate():
    case, tables, st0 = _mixed1()
    n = 20
    want = simulate(st0, tables, case, n, C.TARGET_FIELDS, device="cpu")
    noise = C.CounterNoise((case.nx, case.nz), "cpu")
    noise.set(1, False)
    for got in (C.run_member(case, tables, st0, n),
                C.run_member(case, tables, st0, n, noise, eps=0.0)):
        for f in FIELDS:
            assert torch.equal(getattr(got[0], f), getattr(want[0], f)), f
        assert torch.equal(got[1].ppt_rain, want[1].ppt_rain)
        for k in C.TARGET_FIELDS:
            assert torch.equal(got[1].profiles[k], want[1].profiles[k]), k
    noisy = C.run_member(case, tables, st0, n, noise)
    assert not torch.equal(noisy[0].qv, want[0].qv)


def test_a_member_repeats_and_steps_in_place_as_it_runs():
    case, tables, st0 = _mixed1()
    noise = C.CounterNoise((case.nx, case.nz), "cpu")
    noise.set(2, False)
    a = C.run_member(case, tables, st0, 20, noise)
    b = C.run_member(case, tables, st0, 20, noise)       # the same seed
    assert all(torch.equal(x, y) for x, y in zip(a[0], b[0]))
    # the graph's shape of the loop: the new state copied into the
    # loop's buffers, one step at a time (eager on the CPU)
    loop = C.member_loop(case, tables, st0, noise)
    loop.state = KidState(*[t.clone() for t in st0])
    noise.restart()
    loop.start_chunk(case.modulation_table(0, 2, torch.float32))
    loop.step_in_place()
    loop.step_in_place()
    ref = C.member_loop(case, tables, st0, noise)
    noise.restart()
    ref.start_chunk(case.modulation_table(0, 2, torch.float32))
    ref.run(2)
    assert all(torch.equal(x, y) for x, y in zip(loop.state, ref.state))
    assert not torch.equal(loop.state.qv, st0.qv)


def test_spreads_are_the_reference_formulas():
    rng = np.random.default_rng(0)

    def run():
        return {"final": {f: rng.random((1, 5)) for f in FIELDS},
                "rain": rng.random(8), "tmean": {f: rng.random((1, 5))
                                                 for f in C.TARGET_FIELDS}}

    base, member = run(), run()
    s = C.spreads(member, base)
    p0, p1 = base["rain"].cumsum(), member["rain"].cumsum()
    assert s["cum_ppt_spread"] == float(np.abs(p1 - p0).max()
                                        / (np.abs(p0).max() + 1e-30))
    assert s["final_field_spread"] == max(
        float(np.abs(base["final"][f] - member["final"][f]).max()
              / (np.abs(base["final"][f]).max() + 1e-30))
        for f in C.TARGET_FIELDS)
    assert s["tmean_profile_spread"] == max(
        float(np.abs(member["tmean"][f] - base["tmean"][f]).max()
              / (np.abs(base["tmean"][f]).max() + 1e-30))
        for f in C.TARGET_FIELDS)


def test_chaos_main_records_its_block(tmp_path, capsys):
    out = tmp_path / "v.json"
    out.write_text(json.dumps({"fp64": {"mixed1": {"pass": True}}}))
    assert C.main(["warm1_recon", "--device", "cpu", "--steps", "6",
                   "--record", str(out)]) == 0
    report = json.loads(out.read_text())
    assert report["fp64"] == {"mixed1": {"pass": True}}       # kept
    env = report["chaos_envelope"]
    assert set(env["cases"]) == {"warm1_recon"}
    e = env["cases"]["warm1_recon"]
    for kind in C.KINDS:
        assert e[kind]["members"] == 3 and e[kind]["eps"] == C.EPS
        assert set(e[kind]) >= {"cum_ppt_spread", "final_field_spread",
                                "tmean_profile_spread"}
    assert e["launches"] == dict.fromkeys(e["launches"], 0)     # the CPU
    assert report["hardware"]["device"] == "cpu"
    assert set(report["runs"]) == {"chaos_envelope"}
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_chaos_main_needs_a_card_or_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert C.main([]) == 2
    with pytest.raises(RuntimeError, match="device='cpu'"):
        C.envelope("mixed1", n_steps=1)
