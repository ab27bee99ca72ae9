"""The tests' helper: a configuration dict written from a case of
``kid_tpu_torch.driver.cases.CASES``, with its scalars, its scheme and
its soundings in the file's keys, as a configuration file states them."""
import copy

# Each case's soundings, as its definition in kid_tpu_torch/driver/cases.py
# writes them; deep1's theta and warm1's qv are piecewise linear.
SOUNDINGS = {
    "warm1": dict(
        theta={"kind": "const", "at_0": 297.9},
        qv={"kind": "piecewise", "z_m": [0.0, 740.0, 3260.0],
            "values": [0.015, 0.0138, 0.0024]}),
    "warm1_recon": dict(
        theta={"kind": "const", "at_0": 288.0},
        qv={"kind": "exp", "at_0": 0.015, "scale_m": 2000.0}),
    "mixed1": dict(
        theta={"kind": "linear", "at_0": 273.15, "per_m": 0.002},
        qv={"kind": "exp", "at_0": 0.0045, "scale_m": 2500.0}),
    "deep1": dict(
        theta={"kind": "piecewise", "z_m": [0.0, 12000.0, 16000.0],
               "values": [297.0, 333.0, 373.0]},
        qv={"kind": "exp", "at_0": 0.016, "scale_m": 2200.0}),
    "aerosol1d": dict(
        theta={"kind": "linear", "at_0": 273.15, "per_m": 0.002},
        qv={"kind": "exp", "at_0": 0.0045, "scale_m": 2500.0},
        nwfa={"kind": "exp", "at_0": 300.0e6, "scale_m": 3000.0},
        nifa={"kind": "exp", "at_0": 1.0e6, "scale_m": 4000.0}),
    "cumulus2d": dict(
        theta={"kind": "const", "at_0": 288.0},
        qv={"kind": "exp", "at_0": 0.015, "scale_m": 2000.0}),
    "orographic2d": dict(
        theta={"kind": "linear", "at_0": 278.0, "per_m": 0.003},
        qv={"kind": "exp", "at_0": 0.005, "scale_m": 2500.0}),
}

SCHEME_KEYS = ("iiwarm", "set_nc", "l_sediment", "is_aerosol_aware",
               "dusty_ice", "homog_ice", "ifdry")


def config_of(case, nx: int = 0, dtype: str = "float64") -> dict:
    """``case`` as a configuration dict at ``nx`` columns (0: the case's
    own), without noise."""
    cfg = {k: getattr(case, k) for k in ("nz", "ztop", "dt", "t_final",
                                         "w1", "t1", "modulation", "dx",
                                         "u0", "cell_nx")}
    cfg.update(name=case.name, program_case=case.name, dtype=dtype,
               nx=nx or case.nx,
               scheme={k: getattr(case.micro, k) for k in SCHEME_KEYS},
               noise={"theta_K": 0.0, "qv_rel": 0.0})
    cfg.update(copy.deepcopy(SOUNDINGS[case.name]))
    return cfg


def is_piecewise(cfg: dict) -> bool:
    return any(isinstance(v, dict) and v.get("kind") == "piecewise"
               for v in cfg.values())
