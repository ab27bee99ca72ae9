"""The comparison fails a broken timed path and passes the program.

Each test skips the harness's look for a card and drives the rest of a
run on the CPU (the program's plain versions) at a size a test run can
hold: the case cut to 20 steps and a few columns, the tile to 2 x 4
columns.  With the timed path broken underneath (a step that returns its
state unchanged, half the columns left out, an answer altered where it
is produced) ``correct`` comes out false; the control, the reference
with its state in bfloat16, reads above the limit too."""
import time
from pathlib import Path

import pytest
import torch

from kidbench import drive
from kidbench.manifest import find_cell

SEED = 2 ** 31 + 977


def small(name):
    cell = find_cell(name)
    cfg, tr = dict(cell.cfg), dict(cell.traffic)
    cfg.update(nx=128 if cfg["dx"] else 8, t_final=40.0)
    cfg["tile"] = [2, cfg["nz"], 4]
    tr.update(chunk_steps=5, checks_at_share=[0.0, 0.5], trace_calls=2,
              sample_columns=6,
              sample={"columns": 6, "blocks": 2, "block_columns": 4})
    return cell._replace(cfg=cfg, traffic=tr)


def run_small(name, control=False):
    out = drive.run_cell(small(name), SEED, 0.3, False, torch.device("cpu"),
                         time.perf_counter(), control=control, workers=2)
    return out, all(v <= lim for v, lim in out.checks.values())


def unchanged(st, out):
    return type(out)(*[t.clone() for t in st])


def half_left_out(st, out):
    n = st[0].shape[0] // 2
    return type(out)(*[torch.cat([b[:n], a[n:]]) for a, b in zip(out, st)])


def altered(st, out):
    theta = out.theta.clone()
    theta[:, 5] += 0.5
    return out._replace(theta=theta)


LOOP_FAULTS = {"unchanged": unchanged, "half_left_out": half_left_out,
               "altered": altered}


@pytest.mark.parametrize("name", ["mixed1.loop", "cumulus2d.loop"])
def test_the_program_and_the_control(name):
    out, correct = run_small(name, control=True)
    assert correct, out.checks
    assert out.control["worst_gap"] > 3 * out.checks["worst_gap"][1]


@pytest.mark.parametrize("fault", sorted(LOOP_FAULTS))
@pytest.mark.parametrize("name", ["mixed1.loop", "cumulus2d.loop"])
def test_a_broken_loop_is_not_correct(monkeypatch, name, fault):
    from kid_tpu_torch.driver import loop
    real = loop.simulate

    def broken(st, *a, **k):
        out, streams = real(st, *a, **k)
        return LOOP_FAULTS[fault](st, out), streams

    monkeypatch.setattr(loop, "simulate", broken)
    out, correct = run_small(name)
    assert not correct, out.checks


def call_unchanged(args, fields, precip):
    names = ("qv", "qc", "qr", "qi", "qs", "qg", "ni", "nr", "th")
    prior = args[14:17]
    return ({k: args[i].clone() for i, k in enumerate(names)},
            precip._replace(rainnc=prior[0].clone(),
                            snownc=prior[1].clone(),
                            graupelnc=prior[2].clone()))


def call_half_left_out(args, fields, precip):
    kept, _ = call_unchanged(args, fields, precip)
    n = args[0].shape[0] // 2
    return ({k: torch.cat([kept[k][:n], v[n:]]) for k, v in
             fields.items()}, precip)


def call_altered(args, fields, precip):
    th = fields["th"].clone()
    th[:, 5, :] += 1.0
    return {**fields, "th": th}, precip


CALL_FAULTS = {"unchanged": call_unchanged,
               "half_left_out": call_half_left_out,
               "altered": call_altered}


def test_the_call_and_its_control():
    out, correct = run_small("mixed1.wrf_calls", control=True)
    assert correct, out.checks
    assert out.control["worst_gap"] > 3 * out.checks["worst_gap"][1]


@pytest.mark.parametrize("fault", sorted(CALL_FAULTS))
def test_a_broken_call_is_not_correct(monkeypatch, fault):
    from kid_tpu_torch.driver import wrf_adapter
    real = wrf_adapter.mp_driver_3d

    def broken(*args, **k):
        fields, precip, eff = real(*args, **k)
        fields, precip = CALL_FAULTS[fault](args, fields, precip)
        return fields, precip, eff

    monkeypatch.setattr(wrf_adapter, "mp_driver_3d", broken)
    out, correct = run_small("mixed1.wrf_calls")
    assert not correct, out.checks


def small_sharded():
    from kidbench.manifest import Cell, load
    bench = Path(__file__).resolve().parents[1]
    cfg = load(bench / "configs" / "cumulus2d_weak4x131072x60.json")
    tr = load(bench / "traffic" / "loop.json")
    limits = load(bench / "limits" / "cumulus2d_weak4.loop.json")
    # one circulation over the domain, so that the boundaries between the
    # ranks lie where its wind is strongest (the configuration's lie at
    # the edges of its 64-column cells, where the wind across is 0); in
    # float64, since the plain versions' float32 on the CPU reads some
    # 0.006 sound, above the limit that the card's float32 kernels meet
    cfg.update(nx=cfg["ranks"] * 16, cell_nx=0, t_final=40.0,
               dtype="float64")
    tr.update(chunk_steps=5, checks_at_share=[0.0, 0.5],
              sample={"columns": 6, "blocks": 2, "block_columns": 4})
    return Cell("cumulus2d_weak4.loop", cfg["ranks"], cfg, tr, limits, [],
                [])


def rank_without_exchange(rank, *args):
    """A rank whose ring exchange sends and receives nothing."""
    from kid_tpu_torch.dist import mesh

    from kidbench.sharded import _rank_main
    mesh._ring = lambda send, recv, group: None
    _rank_main(rank, *args)


@pytest.mark.parametrize("fault", ["none", "exchange_left_out"])
def test_the_sharded_loop_and_its_exchange(fault):
    from kidbench.sharded import _rank_main, sharded_case_loop
    run = drive.Run(small_sharded(), SEED, 0.3, False, torch.device("cpu"),
                    time.perf_counter(), control=False, workers=2)
    main = _rank_main if fault == "none" else rank_without_exchange
    out = sharded_case_loop(run, rank_main=main)
    correct = all(v <= lim for v, lim in out.checks.values())
    assert correct == (fault == "none"), out.checks


def rank_holding_jax(rank, *args):
    """A rank whose process holds a module named ``jax`` (rank 1)."""
    import sys
    import types

    from kidbench.sharded import _rank_main
    if rank == 1:
        sys.modules["jax"] = types.ModuleType("jax")
    _rank_main(rank, *args)


def test_run_refuses_a_rank_that_loaded_jax(monkeypatch, capsys):
    """The command, past its look for cards, runs the sharded loop on gloo
    ranks, one of which holds ``jax``: it exits 3 and prints no line."""
    from kidbench import run
    from kidbench.sharded import sharded_case_loop

    def run_cell(cell, seed, seconds, trace, dev, t_start, control=False):
        r = drive.Run(small_sharded(), SEED, 0.3, False, torch.device("cpu"),
                      t_start, control=False, workers=2)
        return sharded_case_loop(r, rank_main=rank_holding_jax)

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(run, "set_caches", lambda: None)
    monkeypatch.setattr(drive, "run_cell", run_cell)
    rc = run.main(["--workload", "cumulus2d_weak4.loop", "--seed",
                   str(SEED), "--seconds", "0.3"])
    captured = capsys.readouterr()
    assert rc == 3
    assert captured.out == ""
    assert "['jax']" in captured.err
