"""The warp-uniform guards of the aerosol kernels, proved on the CPU.

``csrc/thompson.cuh`` computes some chains of the aerosol-aware kernels
(``fused_rates.cu``, ``fused_post.cu``) only where a mask holds, as
``T v = 0; if (guard<AERO>(mask)) v = chain;``, and keeps the select that
reads ``v``: the results stay bit for bit those of the unguarded chain
only if no output reads ``v`` outside the mask.  The plain version passes
each such value through ``solver.guarded(name, mask, value)``.  Here that
identity is replaced by one that spoils the value outside its mask (NaN,
or the flipped flag), and every output of ``rates_from_tables`` and
``post_from_p8`` must keep its bits.
"""
from __future__ import annotations

import dataclasses
import re
from pathlib import Path

import pytest
import torch

import chip_smoke as C
from kid_tpu_torch.config import MicroConfig
from kid_tpu_torch.driver.cases import AEROSOL1D
from kid_tpu_torch.driver.loop import run_case, simulate
from kid_tpu_torch.micro import solver as S
from kid_tpu_torch.micro import split_step as A
from kid_tpu_torch.tables.cache import get_tables

CSRC = Path(S.__file__).parent / "csrc"
_MARKER = re.compile(r"if \(guard<AERO>\((\w+)\)\)\s*\{?\s*// guard: (\w+)")


def _spoil(seen):
    def guarded(name, mask, value):
        seen.setdefault(name, []).append(mask)
        if value.dtype == torch.bool:
            return torch.where(mask, value, ~value)
        return torch.where(mask, value, torch.full_like(value, float("nan")))
    return guarded


def _seeded(dtype, warm, cold):
    """A seeded aerosol-aware batch (``chip_smoke.make_batch``) as the
    split kernels' plain versions take it."""
    cfg = MicroConfig(iiwarm=warm, is_aerosol_aware=True)
    tables = S.device_tables(get_tables(iiwarm=warm), dtype, "cpu")
    seed = int(cold)
    st, pres, dzq = C.make_batch(6, 48, seed, dtype, "cpu", cold=cold)
    w = C.seeded_w(6, 48, seed, dtype, "cpu")
    pro, idx = S._prologue(st, pres, cfg)
    tv = S._table_stage(pro, idx, tables, cfg, 10.0)
    p8 = S.rates_from_tables(st, pres, tv, cfg, 10.0, True)
    aux = S.aerosol_lookup_stage(st, pres, w, p8, tables, cfg, 10.0)
    return dict(st=st, pres=pres, dzq=dzq, tv=tv, p8=p8, aux=aux, cfg=cfg,
                dt=10.0)


@pytest.fixture(scope="module")
def aerosol1d_step():
    """The split kernels' inputs in aerosol1d's step 151 on the CPU (one
    column, float64), after a 150-step run."""
    case = dataclasses.replace(AEROSOL1D, nx=1)
    st, _ = run_case(case, torch.float64, n_steps=150, device="cpu")
    tables = S.device_tables(get_tables(iiwarm=False), torch.float64, "cpu")
    got = {}
    rates, post = A.fused_rates, A.fused_post

    def rec_rates(state, pres, tv, cfg, dt_f, want_rates, out=None):
        got.update(st=state, pres=pres, tv=tv, cfg=cfg, dt=dt_f)
        got["p8"] = rates(state, pres, tv, cfg, dt_f, want_rates, out)
        return got["p8"]

    def rec_post(state, pres, dzq, p8, aux, cfg, dt_f, want_rates):
        got.update(dzq=dzq, aux=aux)
        return post(state, pres, dzq, p8, aux, cfg, dt_f, want_rates)

    mp = pytest.MonkeyPatch()
    mp.setattr(A, "fused_rates", rec_rates)
    mp.setattr(A, "fused_post", rec_post)
    try:
        simulate(st, tables, case, 1, istep0=150, device="cpu")
    finally:
        mp.undo()
    return got


def _bits(t):
    return t.contiguous().view(torch.uint8)


def _assert_same_bits(got, want, what):
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(_bits(got[k]), _bits(want[k])), (what, k)


def _flat(res):
    st, ppt, diag = res
    out = {f"state.{f}": getattr(st, f) for f in st._fields}
    out.update({f"ppt.{f}": getattr(ppt, f) for f in ppt._fields})
    out.update(diag)
    return out


def _check_guards(b, monkeypatch, want_rates):
    """Both plain versions on batch ``b``, with and without the spoiling
    ``guarded``; returns the masks each guard saw."""
    args = (b["st"], b["pres"], b["tv"], b["cfg"], b["dt"], want_rates)
    p8 = S.rates_from_tables(*args)
    post = (b["st"], b["pres"], b["dzq"], b["p8"], b["cfg"], b["dt"],
            want_rates, b["aux"])
    out = _flat(S.post_from_p8(*post))
    seen = {}
    with monkeypatch.context() as m:
        m.setattr(S, "guarded", _spoil(seen))
        p8_s = S.rates_from_tables(*args)
        out_s = _flat(S.post_from_p8(*post))
    _assert_same_bits(p8_s, p8, "rates_from_tables")
    _assert_same_bits(out_s, out, "post_from_p8")
    return seen


def _kernel_guards():
    """{guard name: mask} from the markers of csrc/thompson.cuh."""
    text = (CSRC / "thompson.cuh").read_text()
    found = _MARKER.findall(text)
    assert len(found) == len(re.findall(r"// guard: \w+", text))
    names = [n for _, n in found]
    assert len(names) == len(set(names)), names
    return {name: mask for mask, name in found}


@pytest.mark.parametrize("want_rates", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("warm,cold", [(False, False), (False, True),
                                       (True, False), (True, True)],
                         ids=["mixed", "mixed-cold", "warm", "warm-cold"])
def test_guarded_values_are_read_only_inside_their_masks(
        warm, cold, dtype, want_rates, monkeypatch):
    seen = _check_guards(_seeded(dtype, warm, cold), monkeypatch, want_rates)
    assert set(seen) <= set(_kernel_guards())
    if not warm:
        assert set(seen) == set(_kernel_guards())


def test_guards_hold_on_aerosol1d_state(aerosol1d_step, monkeypatch):
    seen = _check_guards(aerosol1d_step, monkeypatch, False)
    assert set(seen) == set(_kernel_guards())


def test_every_guard_is_exercised_both_ways(aerosol1d_step, monkeypatch):
    """Across the batches, each guard's mask is true at some cells and
    false at others, so the spoiled values are really read or dropped."""
    any_in, any_out = set(), set()
    batches = [aerosol1d_step] + [_seeded(torch.float64, False, cold)
                                  for cold in (False, True)]
    for b in batches:
        for name, masks in _check_guards(b, monkeypatch, True).items():
            if any(bool(m.any()) for m in masks):
                any_in.add(name)
            if any(not bool(m.all()) for m in masks):
                any_out.add(name)
    names = set(_kernel_guards())
    assert any_in == names, names - any_in
    assert any_out == names, names - any_out


def test_guard_call_sites_match_the_kernel_markers():
    """Every ``// guard: <name>`` of thompson.cuh has ``guarded("<name>",``
    call sites in solver.py and no others exist; only the aerosol
    kernels carry guards (``guard<AERO>``)."""
    solver = Path(S.__file__).read_text()
    calls = re.findall(r'guarded\(\s*"(\w+)"', solver)
    assert set(calls) == set(_kernel_guards())
    for path in CSRC.glob("*.cu"):
        assert "guard<" not in path.read_text(), path.name
