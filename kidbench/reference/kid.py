"""The reference KiD loop: plain torch float64 on the CPU around the
frozen NumPy oracle, worked out from a configuration file alone.

The per-step contract of the KiD shell around ``mp_thompson``
(mphys_thompson09n.f90:60-245): MUSCL advection by the prescribed flow
(z, plus the 1-D divergence closure, or periodic x in 2-D), the
provisional state ``x + (adv + div) * dt``, theta <-> T through the fixed
Exner profile, then the column solver, whose output is the new state.
The grid, the flow patterns and m(t) are computed here from the
configuration's numbers, in float64, as the KiD case design defines
them; nothing is taken from the program.

``advance`` follows a block of columns from a state the caller gives
(the program's own, or the benchmark's initial state) for a few steps.
1-D columns are independent, so any sample of them will do; a 2-D block
is contiguous and carries two ghost columns a side for each step, which
the x-advection consumes: the block that comes back is the inner one.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from . import constants as c
from .advection import (advective_tendency_x_padded, advective_tendency_z,
                        divergence_tendency_z)
from .oracle import mp_thompson_oracle

FIELDS = ("theta", "qv", "qc", "qr", "nr", "qi", "ni", "qs", "qg", "nc",
          "nwfa", "nifa")
PPT = ("rain", "snow", "graupel", "ice")
# the fields a configuration states as soundings; nwfa and nifa optional
SOUNDINGS = ("theta", "qv", "nwfa", "nifa")
# (field, oracle output key) of the fields the solver returns
_OUT_KEYS = (("qv", "qv1d"), ("qc", "qc1d"), ("qr", "qr1d"), ("nr", "nr1d"),
             ("qi", "qi1d"), ("ni", "ni1d"), ("qs", "qs1d"), ("qg", "qg1d"),
             ("nc", "nc1d"), ("nwfa", "nwfa1d"), ("nifa", "nifa1d"))
_PPT_KEYS = ("pptrain", "pptsnow", "pptgraul", "pptice")
P0 = 1.0e5
R_ON_CP = 287.04 / 1004.0
G = 9.81
CP = 1004.0


class Grid(NamedTuple):
    z: np.ndarray
    dz: np.ndarray
    exner: np.ndarray
    pres: np.ndarray
    rho0: np.ndarray


def make_grid(nz: int, ztop: float, theta_prof: np.ndarray) -> Grid:
    """Uniform grid with the hydrostatic Exner profile of ``theta_prof``
    from a surface pressure of 1000 hPa, held fixed, as KiD does."""
    dz = np.full(nz, ztop / nz)
    z = (np.arange(nz) + 0.5) * dz
    exner = np.zeros(nz)
    exner[0] = 1.0 - G / (CP * theta_prof[0]) * z[0]
    for k in range(1, nz):
        th_mid = 0.5 * (theta_prof[k - 1] + theta_prof[k])
        exner[k] = exner[k - 1] - G / (CP * th_mid) * (z[k] - z[k - 1])
    pres = P0 * exner ** (1.0 / R_ON_CP)
    rho0 = pres / (287.04 * theta_prof * exner)
    return Grid(z, dz, exner, pres, rho0)


def sounding(spec: dict, z: np.ndarray) -> np.ndarray:
    """A profile of the configuration: ``linear`` (``at_0 + per_m * z``),
    ``exp`` (``at_0 * exp(-z / scale_m)``), ``const`` (``at_0``) or
    ``piecewise`` (linear between the points ``z_m``, ``values``, which
    rise strictly in ``z_m``, and flat beyond the ends, as ``np.interp``
    computes it)."""
    kind = spec["kind"]
    if kind == "linear":
        return spec["at_0"] + spec["per_m"] * z
    if kind == "exp":
        return spec["at_0"] * np.exp(-z / spec["scale_m"])
    if kind == "const":
        return np.full_like(z, spec["at_0"], dtype=np.float64)
    if kind == "piecewise":
        zp = np.asarray(spec["z_m"], np.float64)
        vp = np.asarray(spec["values"], np.float64)
        if zp.ndim != 1 or zp.shape != vp.shape or not np.all(
                np.diff(zp) > 0):
            raise ValueError("a piecewise sounding needs as many values "
                             "as heights, the heights rising strictly")
        return np.interp(z, zp, vp)
    raise ValueError(f"unknown sounding kind {kind!r}")


class KidCase:
    """A KiD case as a configuration file states it."""

    def __init__(self, cfg: dict):
        self.cfg = cfg
        self.nx, self.nz = int(cfg["nx"]), int(cfg["nz"])
        self.ztop, self.dt = float(cfg["ztop"]), float(cfg["dt"])
        self.n_steps = int(round(cfg["t_final"] / cfg["dt"]))
        self.w1, self.t1 = float(cfg["w1"]), float(cfg["t1"])
        self.modulation_kind = cfg["modulation"]
        self.dx, self.u0 = float(cfg["dx"]), float(cfg["u0"])
        self.cell_nx = int(cfg["cell_nx"]) or self.nx
        self.scheme = dict(cfg["scheme"])
        zc = self.ztop / self.nz * (np.arange(self.nz) + 0.5)
        self.grid = make_grid(self.nz, self.ztop,
                              sounding(cfg["theta"], zc))
        g = self.grid
        self.rho_face = np.concatenate([g.rho0[:1],
                                        0.5 * (g.rho0[1:] + g.rho0[:-1]),
                                        g.rho0[-1:]])
        self.zface = np.concatenate([[0.0], np.cumsum(g.dz)])

    @property
    def one_d(self) -> bool:
        return self.dx == 0.0

    def advected(self) -> tuple:
        """The tracers the kinematic shell advects: the scheme's fields;
        nc/nwfa/nifa only where the scheme is aerosol-aware."""
        if self.scheme["is_aerosol_aware"]:
            return FIELDS
        if self.scheme["iiwarm"]:
            return ("theta", "qv", "qc", "qr", "nr")
        return FIELDS[:9]

    def initial_profiles(self) -> dict:
        """(nz,) float64 profiles of every field at t = 0: the sounding,
        dry and cloud-free; nwfa and nifa (per kg) from the file's
        soundings of them, where it has them, else the non-aerosol number
        fills (f90:957-964)."""
        g = self.grid
        zero = np.zeros(self.nz)
        out = {f: zero for f in FIELDS}
        out.update(theta=sounding(self.cfg["theta"], g.z),
                   qv=sounding(self.cfg["qv"], g.z),
                   nc=self.scheme["set_nc"] * 1.0e6 / g.rho0,
                   nwfa=11.1e6 / g.rho0, nifa=c.NA_IN1 * 0.01 / g.rho0)
        out.update({f: sounding(self.cfg[f], g.z) for f in SOUNDINGS[2:]
                    if f in self.cfg})
        return out

    def modulation(self, istep: int) -> float:
        """m(t) at step ``istep``: a half-sine pulse, ``sin(pi t / t1)``
        while t < t1 and 0 after, or a ramp ``min(t / t1, 1)``."""
        t = istep * self.dt
        if self.modulation_kind == "pulse":
            return math.sin(math.pi * t / self.t1) if t < self.t1 else 0.0
        return min(t / self.t1, 1.0)

    def _psi(self, faces: np.ndarray) -> np.ndarray:
        """Stream function at the corners of x-faces ``faces`` (global
        indices; periodic) and every z-face: (len(faces), nz+1)."""
        lx = self.cell_nx * self.dx
        return (self.grid.rho0[0] * self.w1 * lx / (2.0 * np.pi)
                * np.sin(np.pi * self.zface / self.ztop)[None, :]
                * np.sin(2.0 * np.pi * (faces * self.dx) / lx)[:, None])

    def rhow_faces(self, cols: np.ndarray) -> np.ndarray:
        """rho0 * w at the z-faces of columns ``cols``: (len, nz+1)."""
        if self.one_d:
            wz = self.w1 * np.sin(np.pi * self.zface / self.ztop)
            return np.broadcast_to(self.rho_face * wz,
                                   (len(cols), self.nz + 1)).copy()
        psi = self._psi(np.concatenate([cols, cols[-1:] + 1]))
        return np.diff(psi, axis=0) / self.dx

    def rhou_faces(self, lo: int, n: int) -> np.ndarray:
        """rho0 * u' (the circulation's part) at x-faces ``lo .. lo + n``:
        (n+1, nz)."""
        psi = self._psi(np.arange(lo, lo + n + 1))
        return -np.diff(psi, axis=1) / self.grid.dz[None, :]


def to_bfloat16(a: np.ndarray) -> np.ndarray:
    """``a`` rounded to bfloat16, back in float64."""
    return torch.from_numpy(np.ascontiguousarray(a, np.float64)).to(
        torch.bfloat16).to(torch.float64).numpy()


def solve_column(args: tuple, tables) -> dict:
    """One column through the oracle: ``args`` = (fields dict, t, pres,
    w_cent, dz, dt, scheme); ``tables``: the host tables."""
    f, t, pres, w, dz, dt, s = args
    return mp_thompson_oracle(
        f["qv"], f["qc"], f["qi"], f["qr"], f["qs"], f["qg"], f["ni"],
        f["nr"], f["nc"], f["nwfa"], f["nifa"], t, pres, w, dz, dt, tables,
        iiwarm=s["iiwarm"], l_sediment=s["l_sediment"], set_nc=s["set_nc"],
        is_aerosol_aware=s["is_aerosol_aware"], ifdry=s["ifdry"],
        dusty_ice=s["dusty_ice"], homog_ice=s["homog_ice"])


def local_solver(tables):
    """``solve`` for ``advance``: the columns one after another, here."""
    return lambda batch: [solve_column(a, tables) for a in batch]


def advance(case: KidCase, solve, fields: dict, cols, istep0: int,
            n_steps: int, lower: Optional[str] = None):
    """``n_steps`` steps from ``fields`` (name -> (W, nz) float64) of the
    global columns ``cols`` (1-D: any; 2-D: ``W`` contiguous columns,
    ``W > 4 * n_steps``), the first at step ``istep0``.

    ``solve(list of args) -> list of oracle outputs`` runs the columns
    (``local_solver``, or ``pool.Solver``'s processes).  ``lower``
    ("bfloat16"): the state is held in that precision, rounded on the way
    in and after every step (the control).  Returns (fields of the columns
    that come back, their global indices, surface precip summed over the
    steps: name -> (W',))."""
    g = case.grid
    rnd = to_bfloat16 if lower == "bfloat16" else (lambda a: a)
    if lower not in (None, "bfloat16"):
        raise ValueError(f"unknown lower precision {lower!r}")
    cols = np.asarray(cols)
    fields = {k: rnd(np.asarray(v, np.float64)) for k, v in fields.items()}
    rho0 = torch.from_numpy(g.rho0)
    dz = torch.from_numpy(g.dz)
    adv = case.advected()
    ppt = {k: np.zeros(len(cols)) for k in PPT}
    for s in range(n_steps):
        m = case.modulation(istep0 + s)
        w_face = torch.from_numpy(m * case.rhow_faces(cols))
        q = torch.from_numpy(np.stack([fields[f] for f in adv]))
        ten = advective_tendency_z(q, w_face, rho0, dz)
        if case.one_d:
            ten = ten + divergence_tendency_z(q, w_face, rho0, dz)
        else:
            inner = slice(2, len(cols) - 2)
            u_face = torch.from_numpy(
                case.u0 * g.rho0[None, :]
                + m * case.rhou_faces(int(cols[2]), len(cols) - 4))
            ten = ten[:, inner] + advective_tendency_x_padded(
                q, u_face, rho0, case.dx)
            q, w_face, cols = q[:, inner], w_face[inner], cols[inner]
            fields = {k: v[inner] for k, v in fields.items()}
            ppt = {k: v[inner] for k, v in ppt.items()}
        prov = dict(fields)
        prov.update(zip(adv, (q + ten * case.dt).numpy()))
        w_vel = w_face.numpy() / case.rho_face
        w_cent = 0.5 * (w_vel[:, 1:] + w_vel[:, :-1])
        outs = solve([({k: v[i] for k, v in prov.items()},
                       prov["theta"][i] * g.exner, g.pres, w_cent[i], g.dz,
                       case.dt, case.scheme)
                      for i in range(len(cols))])
        new = {"theta": np.stack([o["t1d"] for o in outs]) / g.exner}
        for f, key in _OUT_KEYS:
            new[f] = np.stack([np.asarray(o[key], np.float64)
                               for o in outs])
        fields = {k: rnd(v) for k, v in new.items()}
        for k, key in zip(PPT, _PPT_KEYS):
            ppt[k] = ppt[k] + np.array([o[key] for o in outs])
    return fields, cols, ppt
