"""PyTorch port's host side against the JAX package, on the CPU: tables,
index functions, power helpers, saturation polynomials, the package's
import boundary and its device rule."""
from __future__ import annotations

import ast
import dataclasses
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from kid_tpu import special as jspecial
from kid_tpu.micro import fastmath as jfast
from kid_tpu.tables import builders as jbuild
from kid_tpu.tables import index as jindex
from kid_tpu.tables.cache import get_tables as j_get_tables
from kid_tpu_torch import special as tspecial
from kid_tpu_torch.__main__ import main as cli_main
from kid_tpu_torch.convert import state_from_numpy, tables_from_numpy
from kid_tpu_torch.driver import advection as adv
from kid_tpu_torch.driver.cases import AEROSOL1D, MIXED1, WARM1_RECON
from kid_tpu_torch.driver.loop import initial_state, run_case
from kid_tpu_torch.micro import fastmath as tfast
from kid_tpu_torch.micro import fused_step as fs
from kid_tpu_torch.micro import split_step as ss
from kid_tpu_torch.micro import table_stage as ts
from kid_tpu_torch.micro.solver import device_tables
from kid_tpu_torch.tables import builders as tbuild
from kid_tpu_torch.tables import index as tindex
from kid_tpu_torch.tables.cache import get_tables as t_get_tables

torch.set_num_threads(2)

PKG = Path(__file__).resolve().parents[1] / "kid_tpu_torch"


@pytest.mark.parametrize("iiwarm", [True, False], ids=["warm", "mixed"])
def test_build_all_tables_array_equal(iiwarm):
    want = jbuild.build_all_tables(iiwarm)
    got = tbuild.build_all_tables(iiwarm)
    assert got._fields == want._fields
    for f in want._fields:
        np.testing.assert_array_equal(np.asarray(getattr(got, f)),
                                      np.asarray(getattr(want, f)), err_msg=f)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_tables_from_numpy_equals_device_tables(dtype):
    got = tables_from_numpy(j_get_tables(iiwarm=False), dtype, "cpu")
    want = device_tables(t_get_tables(iiwarm=False), dtype, "cpu")
    for f in want._fields:
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == dtype and a.device.type == "cpu"
        assert torch.equal(a, b), f


def _rand(seed, n, lo, hi, log=False):
    rng = np.random.default_rng(seed)
    if log:
        return 10.0 ** rng.uniform(np.log10(lo), np.log10(hi), n)
    return rng.uniform(lo, hi, n)


def test_index_functions_match():
    r = _rand(0, 4000, 1e-12, 1e-1, log=True)
    for n2, ntb in ((-6, 37), (-12, 100), (-4, 55)):
        np.testing.assert_array_equal(
            tindex.decade_index(torch.as_tensor(r), n2, ntb).numpy(),
            np.asarray(jindex.decade_index(jnp.asarray(r), n2, ntb)))
    x = _rand(1, 4000, 1e-7, 1e-2, log=True)
    np.testing.assert_array_equal(
        tindex.log_bin_index(torch.as_tensor(x), 5e-6, 5e-3, 100).numpy(),
        np.asarray(jindex.log_bin_index(jnp.asarray(x), 5e-6, 5e-3, 100)))
    nc = _rand(2, 4000, 1e6, 1e10, log=True)
    np.testing.assert_array_equal(
        tindex.tnc_index(torch.as_tensor(nc), 1e7, 2, 100).numpy(),
        np.asarray(jindex.tnc_index(jnp.asarray(nc), 1e7, 2, 100)))
    v = _rand(3, 4000, -50.0, 50.0)
    v[:4] = [-2.5, 2.5, 0.5, -0.5]
    np.testing.assert_array_equal(tindex.fnint(torch.as_tensor(v)).numpy(),
                                  np.asarray(jindex.fnint(jnp.asarray(v))))


@pytest.mark.parametrize("p", [3.0, -4.0, 1.0 / 3.0, 0.25, 1.0 / 6.0, 2.5,
                               0.75, 2.0 / 3.0, 0.89, 1.94, -3.55])
def test_powc_matches(p):
    x = _rand(4, 2000, 1e-6, 1e4, log=True)
    np.testing.assert_allclose(tfast.powc(torch.as_tensor(x), p).numpy(),
                               np.asarray(jfast.powc(jnp.asarray(x), p)),
                               rtol=1e-13)


def test_exp10_log10_match():
    x = _rand(5, 2000, -30.0, 30.0)
    np.testing.assert_allclose(tfast.exp10(torch.as_tensor(x)).numpy(),
                               np.asarray(jfast.exp10(jnp.asarray(x))),
                               rtol=1e-13)
    y = _rand(6, 2000, 1e-30, 1e30, log=True)
    np.testing.assert_allclose(tfast.log10(torch.as_tensor(y)).numpy(),
                               np.asarray(jnp.log10(jnp.asarray(y))),
                               rtol=1e-13)


def test_saturation_polynomials_match():
    p = _rand(7, 3000, 1.0e4, 1.05e5)
    t = _rand(8, 3000, 180.0, 320.0)
    for tf, jf in ((tspecial.rslf, jspecial.rslf),
                   (tspecial.rsif, jspecial.rsif)):
        np.testing.assert_allclose(
            tf(torch.as_tensor(p), torch.as_tensor(t)).numpy(),
            np.asarray(jf(jnp.asarray(p), jnp.asarray(t))), rtol=1e-13)
    np.testing.assert_array_equal(tspecial.rslf_np(p, t),
                                  jspecial.rslf_np(p, t))
    np.testing.assert_array_equal(tspecial.rsif_np(p, t),
                                  jspecial.rsif_np(p, t))


def test_state_from_numpy_round_trip():
    from kid_tpu.driver.loop import initial_state as j_initial_state
    case = dataclasses.replace(MIXED1, nx=3)
    from kid_tpu.driver.cases import MIXED1 as JMIXED1
    jst = j_initial_state(dataclasses.replace(JMIXED1, nx=3), jnp.float64)
    got = state_from_numpy(jst, device="cpu", dtype=torch.float64)
    want = initial_state(case, torch.float64, "cpu")
    assert type(got).__name__ == "KidState"
    for f in want._fields:
        assert torch.equal(getattr(got, f), getattr(want, f)), f


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_imports_neither_jax_nor_reference_package():
    files = sorted(PKG.rglob("*.py"))
    assert len(files) >= 15
    assert {"dist/mesh.py", "dist/launch.py", "validation/cases.py",
            "validation/twod.py", "validation/oracle.py",
            "validation/driver_twin.py", "validation/chaos.py",
            "micro/graphs.py", "bench.py", "baseline.py", "scaling.py",
            "records.py"} <= {
        p.relative_to(PKG).as_posix() for p in files}
    for path in files:
        for mod in _imports(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "kid_tpu", "flax", "tests",
                               "prof", "test_oracle"), (path, mod)


def test_chip_smoke_imports_neither_jax_nor_reference_package():
    path = PKG.parent / "chip_smoke.py"
    for mod in _imports(path):
        assert mod.split(".")[0] not in ("jax", "jaxlib", "kid_tpu", "tests",
                                         "prof"), mod


def test_nccl_smoke_imports_neither_jax_nor_reference_package(monkeypatch):
    for mod in _imports(PKG.parent / "nccl_smoke.py"):
        assert mod.split(".")[0] not in ("jax", "jaxlib", "kid_tpu", "tests",
                                         "prof"), mod
    import nccl_smoke as N
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert N.main() == 2                   # NCCL ranks need two cards


def test_nccl_smoke_names_every_fault():
    import nccl_smoke as N

    def run(theta, rain, calls, launches, placement="step", seconds=0.0,
            nccl=1.0, host=0.0):
        return SimpleNamespace(
            fields={"theta": np.array([theta])},
            ppt={"ppt_rain": np.array([rain])},
            ranks=[{"rank": 0, "placement": placement,
                    "exchange_calls": calls, "exchange_seconds": seconds,
                    "launches": {"fused_step": launches, "fused_post": 0},
                    "profile": {"nccl_kernels": nccl,
                                "host_exchange_calls": host}}])

    one = run(1.0, 2.0, 3, 3)
    assert N.faults(one, run(1.0, 2.0, 3, 3), 3, True) == []
    assert N.faults(one, run(1.0, 2.0, 3, 3, seconds=0.1, host=1.0), 3,
                    False) == []
    bad = N.faults(one, run(1.5, 2.5, 2, 3), 3, True)
    assert bad[:2] == ["theta", "ppt_rain"] and "2 exchanges" in bad[2]
    assert len(N.faults(one, run(1.0, 2.0, 3, 4), 3, True)) == 1
    # the exchange outside the step, host time in a graphed run's exchange,
    # no NCCL kernel a profiled step, a host call of the exchange between
    # two replays, none in an eager step
    for graphs, kw in ((True, {"placement": "split"}),
                       (True, {"seconds": 0.1}), (True, {"nccl": 0.0}),
                       (True, {"host": 1.0}), (False, {"host": 0.0})):
        assert len(N.faults(one, run(1.0, 2.0, 3, 3, **kw), 3, graphs)) == 1


def test_kernel_budget_imports_neither_jax_nor_reference_package():
    mods = list(_imports(PKG.parent / "kernel_budget.py"))
    assert "chip_smoke" in mods
    for mod in mods:
        assert mod.split(".")[0] not in ("jax", "jaxlib", "kid_tpu"), mod


def test_kernel_budget_builds_every_kernel_with_its_budget_macros():
    import kernel_budget as K
    from kid_tpu_torch.micro import cuda_build
    built = {p.stem for p in cuda_build.SRC_DIR.glob("*.cu")}
    assert set(K.STEMS) == built == set(K.BUDGET_MACROS)
    header = (cuda_build.SRC_DIR / "thompson.cuh").read_text()
    for macros in K.BUDGET_MACROS.values():
        assert len(macros) == 4
        for m in macros:
            assert f"#ifndef {m}\n#define {m} " in header, m
    # instantiation labels from the mangled names cuobjdump prints
    t = K._TEMPLATE.search("_ZN12_GLOBAL__N_118fused_rates_kernelIfLb0ELb1"
                           "ELi128EEEvPKT_PS1_iidddii")
    assert t.group(1).endswith("fused_rates") and t.groups()[1:] == (
        "f", "0", "1", "128")
    t = K._TEMPLATE.search("_ZN46_GLOBAL__N__3dda1021_13_fused_post_cu_6149"
                           "acc917fused_post_kernelIdLb1ELb0EEEvPKT_PS1_S4_")
    assert t.groups()[1:] == ("d", "1", "0", None)


def test_kernel_budget_counts_sass_instructions(monkeypatch):
    import subprocess

    import kernel_budget as K
    sass = """
\t\tFunction : _ZN12_GLOBAL__N_115fused_post_kernelIfLb0ELb0ELi128EEEvPKT_
        /*0000*/                   LDC R1, c[0x0][0x28] ;   /* 0x00 */
                                                            /* 0x00 */
        /*0010*/                   MUFU.RSQ R2, R3 ;        /* 0x00 */
        /*0020*/              @!P2 DADD R4, R4, -0.5 ;      /* 0x00 */
        /*0030*/                   F2F.F32.F64 R8, UR4 ;    /* 0x00 */
        /*0040*/                   DSETP.GEU.AND P2, PT, |R4|, UR4, PT ;
        /*0050*/                   NOP ;                    /* 0x00 */
\t\tFunction : _ZN12_GLOBAL__N_115fused_post_kernelIdLb1ELb1ELi256EEEvPKT_
        /*0000*/                   DFMA R2, R4, R6, R8 ;    /* 0x00 */
"""
    monkeypatch.setattr(K, "cuobjdump", lambda: "cuobjdump")
    monkeypatch.setattr(subprocess, "run", lambda *a, **k: SimpleNamespace(
        stdout=sass))
    assert K.sass_counts(Path("lib.so")) == {
        "f32 mixed rates=0 block=128": (5, 1, 1, 1),
        "f64 warm  rates=1 block=256": (1, 0, 1, 0)}


def test_kernel_budget_passes_m_to_fused_kid_step_as_a_tensor(monkeypatch):
    import chip_smoke as C
    import kernel_budget as K
    from kid_tpu_torch.micro import fused_kid_step as FK
    seen = []

    def launch(x, prof, mmod, cfg, dt_f, want_rates):
        assert isinstance(mmod, torch.Tensor) and mmod.numel() == 1
        assert mmod.dtype == x.dtype and mmod.device == x.device
        seen.append((x.dtype, float(mmod)))

    monkeypatch.setattr(FK, "launch_kid_packed", launch)
    monkeypatch.setattr(C, "BATCH_NCOL", 3)
    launches = K.step_batches(torch.device("cpu"), {"fused_kid_step"})
    # nz 33/120/256, float32/float64, mixed/warm, rates off/on
    assert len(launches) == 24
    for _, stem, fn in launches:
        assert stem == "fused_kid_step"
        fn()
    # m(t) of kid_step_inputs (a float64 value), rounded to each dtype
    ms = {C.kid_step_inputs(dataclasses.replace(case, nx=3), torch.float64,
                            torch.device("cpu"))[1]
          for case in (MIXED1, WARM1_RECON)}
    assert {v for dt, v in seen if dt == torch.float64} == ms
    assert {v for dt, v in seen if dt == torch.float32} == {
        float(torch.tensor(m, dtype=torch.float32)) for m in ms}
    # the timed launches take the same path: the script launches the
    # kernel in one place
    assert (PKG.parent / "kernel_budget.py").read_text().count(
        "launch_kid_packed(") == 1


def test_kernel_budget_timed_launches_take_their_own_case(monkeypatch):
    import chip_smoke as C
    import kernel_budget as K
    from kid_tpu_torch.driver import loop
    from kid_tpu_torch.micro import fused_kid_step as FK
    seen = []

    def stub(stem):
        def launch(x, *args):
            x = x[0] if isinstance(x, list) else x   # table_stage's chans
            seen.append((stem, x.dtype, next(
                a for a in args if hasattr(a, "is_aerosol_aware"))))
        return launch

    packed = torch.zeros(31, 2, 3)
    last = {"pack_inputs": packed, "pack_kid_inputs": (packed, packed),
            "pack_rates_inputs": packed, "pack_post_inputs": packed}
    monkeypatch.setattr(loop, "run_case", lambda *a, **k: (None, None))
    monkeypatch.setattr(loop, "simulate", lambda *a, **k: None)
    monkeypatch.setattr(C, "recording", lambda packers: (last, lambda: None))
    monkeypatch.setattr(C, "MAIN_NX", 3)
    monkeypatch.setattr(fs, "launch_packed", stub("fused_step"))
    monkeypatch.setattr(FK, "launch_kid_packed", stub("fused_kid_step"))
    monkeypatch.setattr(ss, "launch_rates_packed", stub("fused_rates"))
    monkeypatch.setattr(ss, "launch_post_packed", stub("fused_post"))
    monkeypatch.setattr(ss, "launch_lookup", stub("lookup_stage"))
    monkeypatch.setattr(ts, "launch", stub("table_stage"))
    monkeypatch.setattr(C, "advect_inputs", lambda cell, dtype, dev: (
        SimpleNamespace(qv=packed[0]), None, None, 5))
    monkeypatch.setattr(adv, "launch", lambda st, m, tr, n_adv, *out:
                        seen.append(("advect", st.qv.dtype, None)))
    launches = K.timed_inputs(torch.device("cpu"), set(K.STEMS))
    for label, stem, fn in launches:
        fn()
    # the main paths' launches first, each with its own case's config
    assert [s[0] for s in seen[:7]] == ["table_stage", "fused_step",
                                        "fused_kid_step", "table_stage",
                                        "fused_rates", "lookup_stage",
                                        "fused_post"]
    assert [s[2].is_aerosol_aware for s in seen[:7]] == [False] * 3 + [
        True] * 4
    assert [stem for _, stem, _ in launches] == [s[0] for s in seen]
    # then advect on the loops' two cells
    assert len(launches) == 7 + 3 * 5 + 2
    assert [stem for _, stem, _ in launches[-2:]] == ["advect"] * 2


def test_entry_points_need_a_card_unless_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        device_tables(t_get_tables(iiwarm=True))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_case(dataclasses.replace(MIXED1, nx=2), n_steps=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_case(dataclasses.replace(AEROSOL1D, nx=2), n_steps=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tables_from_numpy(j_get_tables(iiwarm=True))
    # the command line runs on the card unless given --device cpu
    assert cli_main(["run", "warm1_recon", "--steps", "1"]) != 0
    tabs = device_tables(t_get_tables(iiwarm=True), device="cpu")
    assert tabs.t_efrw.device.type == "cpu"
    # the kernel wrappers launch only on the card; a CPU tensor runs the
    # plain version through the wrapper, never the launcher
    cfg = AEROSOL1D.micro
    x = torch.zeros(3, 2, 8)
    for launch in (fs.launch_packed, ss.launch_rates_packed,
                   ss.launch_post_packed):
        with pytest.raises(ValueError, match="needs a CUDA tensor"):
            launch(x, cfg, 1.0, False)
