"""Thompson09 column microphysics in PyTorch (twin of
``kid_tpu/micro/solver.py``).

The physics of ``mp_thompson`` (module_mp_thompson09n.f90:1156-3688) as
branch-free tensor code over a batch of (ncol, nz) columns:

  * ``_prologue``: phases 2-7 plus the PSD shapes and lookup indices;
  * ``_table_stage``: the table lookups and the rates that consume them,
    as plain torch gathers (the reference's banded and one-hot forms were
    TPU lowerings of the same exact selections).  The two together are
    the plain version of the hand-written CUDA kernel
    ``table_stage.table_stage``, the port's counterpart of the fusion the
    reference's ``jit`` makes of them;
  * ``core_from_tables``: phases 2-20 from the raw state and the
    table-stage channels.  This is the plain version of the hand-written
    CUDA kernel (``fused_step.fused_step``), which computes the same
    function on the card;
  * aerosol-aware configurations split the step in two around the
    phase-14 table lookups: ``rates_from_tables`` (phases 2-11, plain
    version of ``split_step.fused_rates``), ``aerosol_lookup_stage``
    (plain version of ``split_step.lookup_stage``) and ``post_from_p8``
    (phases 12-20, plain version of ``split_step.fused_post``).

``batched_microphysics`` runs the kernel path: ``table_stage``, then
``fused_step``, or ``fused_rates`` -> ``lookup_stage`` -> ``fused_post``
for aerosol-aware configurations.  Each wrapper launches its kernel for a
CUDA tensor and runs its plain version for a CPU tensor.  Phase numbers
follow SURVEY.md section 3.2b.
"""
from __future__ import annotations

import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from .. import constants as c
from .. import spans
from ..config import MicroConfig
from ..device import check_on, resolve_device
from ..special import rsif, rslf
from ..tables.builders import Tables
from ..tables.index import (decade_index, fnint, log_bin_index, tnc_index,
                           trunc_int)
from .aerosol import activ_ncloud, eff_aero, ice_demott, ice_koop
from .fastmath import exp10, ipow, log10, powc
from .state import ColumnState, Precip

# Fortran 1-based gamma caches as python floats.
CRE = tuple(float(x) for x in c.CRE)
CRG = tuple(float(x) for x in c.CRG)
CSE = tuple(float(x) for x in c.CSE)
CSG = tuple(float(x) for x in c.CSG)
CGE = tuple(float(x) for x in c.CGE)
CGG = tuple(float(x) for x in c.CGG)
CIE = tuple(float(x) for x in c.CIE)
CIG = tuple(float(x) for x in c.CIG)
_SA = tuple(float(x) for x in c.SA)
_SB = tuple(float(x) for x in c.SB)

# Stacking orders of the table families.  The rain-snow and rain-graupel
# consumers (f90:1966-1995, 1999-2018) only read fixed linear combinations
# of their tables, pre-summed once in float64 (as the reference does).
_RACS = (("tmr_racs1", "tcr_sacr1"),      # ma
         ("tmr_racs2", "tcr_sacr2"),      # mb
         ("tcs_racs1", "tms_sacr1"),      # mc
         ("tnr_racs1", "tnr_racs2", "tnr_sacr1", "tnr_sacr2"),  # n cold
         ("tnr_racs2", "tnr_sacr2"))      # n warm
#                                         index (idx_s, idx_t, idx_r1, idx_r)
_RACG = (("tmr_racg", "tcr_gacr"),        # cold: rain mass -> graupel
         ("tnr_racg", "tnr_gacr"),        # cold: rain number loss
         ("tnr_gacr",),                   # warm: break-up base (x -5)
         ("tcg_racg",))                   # warm: graupel melt-collect mass
#                                         index (idx_g1, idx_g, idx_r1, idx_r)
_QRFZ = ("tpg_qrfz", "tpi_qrfz", "tni_qrfz", "tnr_qrfz")
#                                         index (idx_r, idx_r1, idx_tc)
_QCFZ = ("tpi_qcfz", "tni_qcfz")          # index (idx_c, idx_tc)
_IAUS = ("tpi_ide", "tps_iaus", "tni_iaus")   # index (idx_i, idx_i1)

class DeviceTables(NamedTuple):
    """Device-resident lookup tables, laid out for one gather per family
    (contents as the Fortran tables of f90:322-342)."""

    racs: torch.Tensor    # (ntb_s*ntb_t*ntb_r1*ntb_r, 5), order _RACS
    racg: torch.Tensor    # (ntb_g1*ntb_g*ntb_r1*ntb_r, 4), order _RACG
    qrfz: torch.Tensor    # (ntb_r*ntb_r1*45, 4), order _QRFZ
    qcfz: torch.Tensor    # (2, ntb_c*45), order _QCFZ
    iaus: torch.Tensor    # (3, ntb_i*ntb_i1), order _IAUS
    t_efrw: torch.Tensor  # (nbr, nbc)
    t_efsw: torch.Tensor  # (nbs, nbc)
    tnc_wev: torch.Tensor  # (nbc, ntb_c, nbc)
    tnccn_act: torch.Tensor  # (7, 9, 7, 5, 4) CCN activation fraction
    tnccn_corners: torch.Tensor  # (7*9*7, 4), see _tnccn_corners


def device_tables(tables: Tables, dtype=torch.float32,
                  device="cuda") -> DeviceTables:
    """Re-lay host float64 tables into flat stacked families on
    ``device``; casting and stacking happen in numpy, so each family
    crosses to the device as one buffer.  The span ``kid.setup.tables``."""
    with spans.span("kid.setup.tables"):
        return _device_tables(tables, dtype, resolve_device(device))


def _device_tables(tables: Tables, dtype, dev) -> DeviceTables:
    np_dtype = np.dtype(str(dtype).replace("torch.", ""))

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def stack(names):
        s = np.stack([np.asarray(getattr(tables, n), np_dtype)
                      for n in names], axis=0)
        return put(s.reshape(s.shape[0], -1))

    def stack_rows(combos):
        s = np.stack([
            sum(np.asarray(getattr(tables, n), np.float64)
                for n in ([names] if isinstance(names, str) else names))
            for names in combos], axis=0).astype(np_dtype)
        return put(s.reshape(s.shape[0], -1).T)

    return DeviceTables(
        racs=stack_rows(_RACS), racg=stack_rows(_RACG),
        qrfz=stack_rows(_QRFZ), qcfz=stack(_QCFZ), iaus=stack(_IAUS),
        t_efrw=put(np.asarray(tables.t_efrw, np_dtype)),
        t_efsw=put(np.asarray(tables.t_efsw, np_dtype)),
        tnc_wev=put(np.asarray(tables.tnc_wev, np_dtype)),
        tnccn_act=put(np.asarray(tables.tnccn_act, np_dtype)),
        tnccn_corners=put(_tnccn_corners(
            np.asarray(tables.tnccn_act, np.float64)).astype(np_dtype)))


def _tnccn_corners(act: np.ndarray) -> np.ndarray:
    """(ni*nj*nk, 4) corner rows [a, b, cc, dd] of the activation table's
    (l=2, m=1) plane (f90:4502-4503), indexed by the clipped (i, j, k) of
    ``aerosol.activ_ncloud``: a=act[i-1,j-1,k], b=act[i,j-1,k],
    cc=act[i,j,k], dd=act[i-1,j,k].  Rows with i==0 or j==0 are never
    fetched (activ_ncloud clips both to >= 1); zeros there."""
    plane = act[:, :, :, 2, 1]                  # (ni, nj, nk)
    ni, nj, nk = plane.shape
    out = np.zeros((ni, nj, nk, 4))
    out[1:, 1:, :, 0] = plane[:-1, :-1, :]      # a
    out[1:, 1:, :, 1] = plane[1:, :-1, :]       # b
    out[1:, 1:, :, 2] = plane[1:, 1:, :]        # cc
    out[1:, 1:, :, 3] = plane[:-1, 1:, :]       # dd
    return out.reshape(ni * nj * nk, 4)


# nu_c-indexed gamma-coefficient columns [ccg1, ccg2, ccg3, ocg1, ocg2,
# cce2] (f90:452-490), rows 0..15 (row 0 is the unused Fortran slot).
NUC_COEF = np.stack([c.CCG[1], c.CCG[2], c.CCG[3], c.OCG1, c.OCG2,
                     c.CCE[2]], axis=1)


@functools.lru_cache(maxsize=8)
def _nuc_table(dtype, device):
    return torch.as_tensor(NUC_COEF, dtype=dtype, device=device)


def _nuc_rows(nu_c, dtype):
    """The 6 nu_c-indexed coefficient columns (exact row selection)."""
    return _nuc_table(dtype, nu_c.device)[nu_c].unbind(-1)


def masked_rows(name: str, mask, rows):
    """The gathered table ``rows``, which no output of ``_table_stage``
    reads where ``mask`` (broadcast against them) is false.  The table
    stage's kernel (csrc/table_stage.cu) skips the gather there;
    tests/test_torch_table_stage.py replaces this identity with one that
    spoils ``rows`` outside ``mask`` and checks that every tv channel
    keeps its bits."""
    return rows


def guarded(name: str, mask, value):
    """``value``, which no output reads where ``mask`` is false.  The
    aerosol kernels compute it under the guard of the same name
    (``// guard: <name>`` in csrc/thompson.cuh), which a warp with no lane
    in ``mask`` skips; tests/test_torch_guards.py replaces this identity
    with one that spoils ``value`` outside ``mask`` and checks that every
    output keeps its bits."""
    return value


def _relu(x):
    # Fortran idiom 0.5*((x)+abs(x)) (e.g. f90:1702,2098)
    return torch.clamp(x, min=0.0)


def _fill_down(vals, valid):
    """vt(k) = vt(k) if valid else vt(k+1), swept top->bottom with a zero
    upper boundary (f90:3234-3236, 3266-3268, 3306-3307, 3332-3333): each
    level takes the value of the first valid level at or above it."""
    nz = vals.shape[-1]
    kk = torch.arange(nz, device=vals.device)
    pos = torch.where(valid, kk, nz)
    first = torch.flip(torch.cummin(torch.flip(pos, (-1,)), -1).values,
                       (-1,))
    got = torch.gather(vals, -1, torch.clamp(first, max=nz - 1))
    return torch.where(first < nz, got, 0.0)


def _cummin_rev(x):
    """Reversed (suffix) running minimum along the last axis."""
    return torch.flip(torch.cummin(torch.flip(x, (-1,)), -1).values, (-1,))


def _field_ab(tc0, m: float):
    """Field et al. (2005) moment-regression coefficients (loga_, b_) at
    moment order ``m`` (f90:1556-1626 with static M)."""
    sa, sb = _SA, _SB
    loga = (sa[0] + sa[1] * tc0 + sa[2] * m + sa[3] * tc0 * m
            + sa[4] * tc0 * tc0 + sa[5] * m * m + sa[6] * tc0 * tc0 * m
            + sa[7] * tc0 * m * m + sa[8] * ipow(tc0, 3) + sa[9] * m ** 3)
    b = (sb[0] + sb[1] * tc0 + sb[2] * m + sb[3] * tc0 * m
         + sb[4] * tc0 * tc0 + sb[5] * m * m + sb[6] * tc0 * tc0 * m
         + sb[7] * tc0 * m * m + sb[8] * ipow(tc0, 3) + sb[9] * m ** 3)
    return loga, b


def _field_moment(log10_smo2, tc0, m: float):
    # a_ * smo2**b_ == 10**(loga_ + b_*log10(smo2))
    loga, b = _field_ab(tc0, m)
    return exp10(loga + b * log10_smo2)


def _snow_moments(rs, temp, l_qs, orders):
    """Snow moments via the Field regression (f90:1545-1628); bm_s == 2,
    so smo2 == smob == rs/am_s.  Zero where not ``l_qs``."""
    tc0 = torch.clamp(temp - 273.15, max=-0.1)
    smob = rs * c.OAMS
    smo2 = smob
    log10_smo2 = torch.log(torch.clamp(smo2, min=1e-35)) * (
        1.0 / math.log(10.0))
    out = {"b": torch.where(l_qs, smob, 0.0),
           "2": torch.where(l_qs, smo2, 0.0)}
    for name, m in orders:
        out[name] = torch.where(l_qs, _field_moment(log10_smo2, tc0, m), 0.0)
    return out


def _graupel_psd(rg, temp, l_qr, mvd_r):
    """Graupel N0/lambda with the top-down running-minimum N0
    (f90:1633-1656)."""
    nz = rg.shape[-1]
    kk = torch.arange(nz, device=rg.device)
    # k_0: highest level with temp >= 270.65 (f90:1635-1637), default kts
    k0 = torch.where(temp >= 270.65, kk, 0).amax(-1, keepdim=True)
    xslw1 = torch.where((kk > k0) & l_qr & (mvd_r > 100.0e-6),
                        4.01 + log10(torch.clamp(mvd_r, min=1e-12)),
                        0.01)
    ygra1 = 4.31 + log10(torch.clamp(rg, min=5.0e-5))
    zans1 = 3.1 + (100.0 / (300.0 * xslw1 * ygra1
                            / (10.0 / xslw1 + 1.0 + 0.25 * ygra1)
                            + 30.0 + 10.0 * ygra1))
    n0_exp = torch.clamp(exp10(zans1), c.GONV_MIN, c.GONV_MAX)
    n0_exp = _cummin_rev(n0_exp)            # f90:1648-1649
    lam_exp = powc(n0_exp * c.AM_G * CGG[1] / rg, c.OGE1)
    lamg = lam_exp * (CGG[3] * c.OGG2 * c.OGG1) ** c.OBMG
    ilamg = 1.0 / lamg
    n0_g = n0_exp / (CGG[2] * lam_exp) * powc(lamg, CGE[2])
    return ilamg, n0_g


def _rain_psd(rr, nr):
    """Rain slope/intercept for every level (f90:1661-1666)."""
    lamr = powc(c.AM_R * CRG[3] * c.ORG2 * nr / rr, c.OBMR)
    ilamr = 1.0 / lamr
    mvd_r = (3.0 + c.MU_R + 0.672) / lamr
    n0_r = nr * c.ORG2 * powc(lamr, CRE[2])
    return ilamr, mvd_r, n0_r


def _subl_prefactor(temp, qvsi, rho, diffu, tcond, ssati, lheat, two_pi):
    """Srivastava & Coen (1992) ventilation/thermo prefactor
    (f90:1883-1900 for sublimation, :2819-2822 for evaporation)."""
    otemp = 1.0 / temp
    rvs = rho * qvsi
    base = lheat * otemp * c.ORV - 1.0
    rvs_p = rvs * otemp * base
    rvs_pp = rvs * (otemp * base * otemp * base
                    + (-2.0 * lheat * ipow(otemp, 3) * c.ORV) + otemp * otemp)
    gamsc = lheat * diffu / tcond * rvs_p
    alphsc = torch.clamp(
        0.5 * ipow(gamsc / (1.0 + gamsc), 2) * rvs_pp / rvs_p * rvs / rvs_p,
        min=1.0e-9)
    xsat = torch.where(torch.abs(ssati) < 1.0e-9, 0.0, ssati)
    t1 = two_pi * (1.0 - alphsc * xsat
                   + 2.0 * alphsc * alphsc * xsat * xsat
                   - 5.0 * ipow(alphsc, 3) * ipow(xsat, 3)) / (1.0 + gamsc)
    return t1, rvs


# table axis first values used by the index guards
_RC1 = float(c.R_C_AXIS[0])
_RI1 = float(c.R_I_AXIS[0])
_RR1 = float(c.R_R_AXIS[0])
_RS1 = float(c.R_S_AXIS[0])
_RG1 = float(c.R_G_AXIS[0])
_NTI1 = float(c.NT_I_AXIS[0])
_DR1 = float(c.DR_BINS[0])
_DRN = float(c.DR_BINS[-1])
_DS1 = float(c.DS_BINS[0])
_DSN = float(c.DS_BINS[-1])


def _nr_from_mvd(rr_, mvd):
    lam = (3.0 + c.MU_R + 0.672) / mvd
    return CRG[2] * c.ORG3 * rr_ * powc(lam, c.BM_R) / c.AM_R


def _dt_pair(dt_f, dtype):
    """(dt, 1/dt) as python floats holding the ``dtype`` values, with the
    reciprocal taken in ``dtype`` as the kernel does."""
    dt = torch.tensor(float(dt_f), dtype=dtype)
    return float(dt), float(1.0 / dt)


# channel names of the phase 8-11 rates block (see the reference package)
P8_OUT = ("tten", "qvten", "qcten", "ncten", "qiten", "niten", "qrten",
          "nrten", "qsten", "qgten", "nwfaten", "nifaten", "vts_boost",
          "mvd_r_new", "prr_gml")
P8_RATES = ('prr_wau', 'prr_rcw', 'pnr_wau', 'pnr_rcr', 'pri_inu', 'pri_ide',
            'prs_ide', 'prs_sde', 'prg_gde', 'pri_wfz', 'prs_scw', 'prg_scw',
            'prg_gcw', 'pri_ihm', 'pri_rfz', 'prs_iau', 'prs_sci', 'pri_rci',
            'pni_inu', 'pni_ihm', 'pni_wfz', 'pni_rfz', 'pni_ide', 'pni_iau',
            'pni_sci', 'pni_rci', 'prr_sml', 'pnr_rcs', 'pnr_rcg', 'pnr_rci',
            'pnr_sml', 'pnr_gml', 'pnr_rfz')
# the table-stage channels the kernel takes: 18 for mixed phase, 1 warm
TV_ICE = ("ef_rw", "ef_sw", "tide", "prr_rcs", "prs_rcs", "prg_rcs",
          "pnr_rcs", "prg_rcg", "prr_rcg", "pnr_rcg", "prg_rfz", "pri_rfz",
          "pni_rfz", "pnr_rfz", "pri_wfz", "pni_wfz", "prs_iau", "pni_iau")
TV_WARM = ("ef_rw",)
# the 36 rate profiles returned with ``want_rates``
DIAG_KEYS = P8_RATES + ("prr_gml", "prv_rev", "pnr_rev")


def tv_keys(cfg: MicroConfig) -> tuple:
    return TV_WARM if cfg.iiwarm else TV_ICE


def rates_and_tendencies(pro, cfg, dt_f, want_rates=True):
    """Phases 8-11 of mp_thompson (f90:1676-2569): the process rates,
    conservation ratio-clamps and tendency assembly, as one elementwise
    function of the prologue products and table channels in ``pro``.
    Returns a dict with P8_OUT keys (+ P8_RATES when ``want_rates``)."""
    qv = pro["qv"]
    dtype = qv.dtype
    dt, odt = _dt_pair(dt_f, dtype)
    odts = odt
    z = torch.zeros_like(qv)

    temp = pro["temp"]
    qc1d = pro["qc1d"]; nc1d = pro["nc1d"]; qi1d = pro["qi1d"]
    ni1d = pro["ni1d"]; qr1d = pro["qr1d"]; nr1d = pro["nr1d"]
    qs1d = pro["qs1d"]; qg1d = pro["qg1d"]
    rho = pro["rho"]; rc = pro["rc"]; nc = pro["nc"]; ri = pro["ri"]
    ni = pro["ni"]; rr = pro["rr"]; nr = pro["nr"]; rs = pro["rs"]
    rg = pro["rg"]
    rhof = pro["rhof"]; rhof2 = pro["rhof2"]
    qvsi = pro["qvsi"]; delqvs = pro["delqvs"]; ssatw = pro["ssatw"]
    ssati = pro["ssati"]; diffu = pro["diffu"]; visco = pro["visco"]
    vsc2 = pro["vsc2"]; ocp = pro["ocp"]; lvap = pro["lvap"]
    tcond = pro["tcond"]
    ilamr = pro["ilamr"]; mvd_r = pro["mvd_r"]; n0_r = pro["n0_r"]
    mvd_c = pro["mvd_c"]; xdc = pro["xdc"]
    dc_g = pro["dc_g"]; ef_rw = pro["ef_rw"]
    nu_c = pro["nu_c_f"]
    tempc = temp - 273.15
    l_qc = qc1d > c.R1
    l_qi = qi1d > c.R1
    l_qr = qr1d > c.R1
    l_qs = qs1d > c.R1
    l_qg = qg1d > c.R1
    if not cfg.iiwarm:
        smo0 = pro["smo0"]; smo1 = pro["smo1"]
        smoe = pro["smoe"]; smof = pro["smof"]
        ilamg = pro["ilamg"]; n0_g = pro["n0_g"]; xds = pro["xds"]
        ef_sw = pro["ef_sw"]
        prr_rcs = pro["prr_rcs"]; prs_rcs = pro["prs_rcs"]
        prg_rcs = pro["prg_rcs"]; pnr_rcs = pro["pnr_rcs"]
        prg_rcg = pro["prg_rcg"]; prr_rcg = pro["prr_rcg"]
        pnr_rcg = pro["pnr_rcg"]
        prg_rfz = pro["prg_rfz"]; pri_rfz = pro["pri_rfz"]
        pni_rfz = pro["pni_rfz"]; pnr_rfz = pro["pnr_rfz"]
        pri_wfz = pro["pri_wfz"]; pni_wfz = pro["pni_wfz"]
        prs_iau = pro["prs_iau"]; pni_iau = pro["pni_iau"]
    else:
        prr_rcs = prs_rcs = prg_rcs = pnr_rcs = z
        prg_rcg = prr_rcg = pnr_rcg = z
        prg_rfz = pri_rfz = pni_rfz = pnr_rfz = z
        pri_wfz = pni_wfz = prs_iau = pni_iau = z
    aero = cfg.is_aerosol_aware
    if aero:
        nwfa = pro["nwfa"]; nifa = pro["nifa"]

    # ---- phase 8: warm-rain process rates (f90:1676-1742) -----------------
    ef_rr = 1.0 - torch.exp(torch.clamp(2300.0 * (mvd_r - 1950.0e-6),
                                        max=50.0))
    pnr_rcr = torch.where(l_qr & (mvd_r > c.D0R), ef_rr * 2.0 * nr * rr,
                          0.0)

    # Berry & Reinhardt autoconversion (f90:1698-1712)
    au = rc > 0.01e-3
    dc_b = powc(_relu(ipow(xdc, 3) * ipow(dc_g, 3) - ipow(xdc, 6)),
                1.0 / 6.0)
    zeta1 = _relu(6.25e-6 * xdc * ipow(dc_b, 3) - 0.4)
    zeta = 0.027 * rc * zeta1
    taud = _relu(0.5 * dc_b - 7.5) + c.R1
    tau = 3.72 / (rc * taud)
    prr_wau = torch.where(au, torch.minimum(rc * odts, zeta / tau), 0.0)
    pnr_wau = torch.where(au, prr_wau / (c.AM_R * nu_c * c.D0R ** 3), 0.0)
    pnc_wau = torch.where(au, torch.minimum(
        nc * odts, prr_wau / (c.AM_R * ipow(mvd_c, 3))), 0.0)

    # rain collecting cloud water via t_Efrw (f90:1715-1726)
    rcw = l_qr & (mvd_r > c.D0R) & (mvd_c > c.D0C)
    lamr = 1.0 / ilamr
    geo_r = powc(lamr + c.FV_R, -CRE[9])
    prr_rcw = torch.where(rcw, torch.minimum(
        rc * odts, rhof * c.T1_QR_QC * ef_rw * rc * n0_r * geo_r), 0.0)
    pnc_rcw = torch.where(rcw, torch.minimum(
        nc * odts, rhof * c.T1_QR_QC * ef_rw * nc * n0_r * geo_r), 0.0)

    # rain collecting aerosols, wet scavenging (f90:1728-1740)
    pna_rca = z; pnd_rcd = z; pna_sca = z; pnd_scd = z
    pna_gca = z; pnd_gcd = z
    if aero:
        rca_on = l_qr & (mvd_r > c.D0R)
        ef_ra = guarded("rain_aero", rca_on,
                        eff_aero(mvd_r, 0.04e-6, visco, rho, temp, "r"))
        pna_rca = torch.where(rca_on, torch.minimum(
            nwfa * odts, rhof * c.T1_QR_QC * ef_ra * nwfa * n0_r * geo_r),
            0.0)
        ef_rd = guarded("rain_aero", rca_on,
                        eff_aero(mvd_r, 0.8e-6, visco, rho, temp, "r"))
        pnd_rcd = torch.where(rca_on, torch.minimum(
            nifa * odts, rhof * c.T1_QR_QC * ef_rd * nifa * n0_r * geo_r),
            0.0)

    # ---- phase 9: ice-phase process rates (f90:1749-2286) -----------------
    pnc_scw = z; pnc_gcw = z
    pri_inu = z; pni_inu = z; pri_ihm = z; pni_ihm = z
    pri_iha = z; pni_iha = z
    pri_ide = z; pni_ide = z; prs_ide = z
    pri_rci = z; pni_rci = z; prr_rci = z; pnr_rci = z; prg_rci = z
    pni_sci = z; prs_sci = z
    prs_sde = z; prs_scw = z; prs_ihm = z
    prg_scw = z; prg_gde = z; prg_gcw = z
    prg_ihm = z
    prr_sml = z; pnr_sml = z; prr_gml = z; pnr_gml = z
    vts_boost = torch.full_like(qv, 1.5)

    if not cfg.iiwarm:
        t_lt_0 = temp < c.T_0
        vts_boost = torch.where(t_lt_0, torch.ones_like(qv), 1.5)

        # sublimation/deposition prefactor (f90:1883-1900)
        t1_subl, rvs_i = _subl_prefactor(temp, qvsi, rho, diffu, tcond,
                                         ssati, c.LSUB, 4.0 * c.PI)

        # snow collecting cloud water via t_Efsw (f90:1902-1913)
        scw = l_qc & (mvd_c > c.D0C) & (xds > c.D0S)
        prs_scw = torch.where(scw, rhof * c.T1_QS_QC * ef_sw * rc * smoe,
                              0.0)
        pnc_scw = torch.where(scw, torch.minimum(
            nc * odts, rhof * c.T1_QS_QC * ef_sw * nc * smoe), 0.0)

        # graupel collecting cloud water (f90:1915-1935); one pow for the
        # bv_g family (cge(9)=bv_g+3, cge(11)=(bv_g+5)/2)
        xdg = (c.BM_G + c.MU_G + 1.0) * ilamg
        g_bvg = powc(ilamg, c.BV_G)
        g_cge9 = g_bvg * powc(ilamg, 3.0)
        g_cge11 = torch.sqrt(g_bvg * powc(ilamg, 5.0))
        vtg_loc = rhof * c.AV_G * CGG[6] * c.OGG3 * g_bvg
        stoke_g = mvd_c * mvd_c * vtg_loc * c.RHO_W / (9.0 * visco * xdg)
        ef_gw = torch.where(
            stoke_g >= 0.4,
            torch.where(stoke_g <= 10.0,
                        0.55 * log10(2.51 * stoke_g), 0.77),
            0.0)
        gcw = (l_qc & (mvd_c > c.D0C) & (rg >= _RG1) & (xdg > c.D0G))
        geo_g = g_cge9
        prg_gcw = torch.where(gcw, rhof * c.T1_QG_QC * ef_gw * rc
                              * n0_g * geo_g, 0.0)
        pnc_gcw = torch.where(gcw, torch.minimum(
            nc * odts, rhof * c.T1_QG_QC * ef_gw * nc * n0_g * geo_g), 0.0)

        # snow/graupel collecting aerosols, wet scavenging (f90:1937-1959)
        if aero:
            sca_on = rs > _RS1
            xds_s = pro["smoc"] / torch.clamp(pro["smob"], min=1e-30)
            ef_sa = guarded("snow_aero", sca_on,
                            eff_aero(xds_s, 0.04e-6, visco, rho, temp, "s"))
            pna_sca = torch.where(sca_on, torch.minimum(
                nwfa * odts, rhof * c.T1_QS_QC * ef_sa * nwfa * smoe), 0.0)
            ef_sd = guarded("snow_aero", sca_on,
                            eff_aero(xds_s, 0.8e-6, visco, rho, temp, "s"))
            pnd_scd = torch.where(sca_on, torch.minimum(
                nifa * odts, rhof * c.T1_QS_QC * ef_sd * nifa * smoe), 0.0)
            gca_on = rg > _RG1
            ef_ga = guarded("graupel_aero", gca_on,
                            eff_aero(xdg, 0.04e-6, visco, rho, temp, "g"))
            pna_gca = torch.where(gca_on, torch.minimum(
                nwfa * odts,
                rhof * c.T1_QG_QC * ef_ga * nwfa * n0_g * geo_g), 0.0)
            ef_gd = guarded("graupel_aero", gca_on,
                            eff_aero(xdg, 0.8e-6, visco, rho, temp, "g"))
            pnd_gcd = torch.where(gca_on, torch.minimum(
                nifa * odts,
                rhof * c.T1_QG_QC * ef_gd * nifa * n0_g * geo_g), 0.0)

        # ---------- processes only below 0C (f90:2025-2231) ----------------
        rate_max_i = (qv - qvsi) * rho * odts * 0.999   # f90:2028

        # deposition-condensation ice nucleation: DeMott (2010) when dusty
        # and aerosol-aware, else the Cooper curve (f90:2088-2101)
        inu = t_lt_0 & ((ssati >= 0.25) | ((ssatw > c.EPS)
                                           & (temp < 253.15)))
        if aero and cfg.dusty_ice:
            xnc_inu = guarded("demott", inu, ice_demott(
                tempc, qv, pro["qvs"], qvsi, rho, nifa))
        else:
            xnc_inu = torch.clamp(c.TNO * torch.exp(c.ATO * (c.T_0 - temp)),
                                  max=250.0e3)
        xni_now = ni + (pni_rfz + pni_wfz) * dt
        pni_inu0 = 0.5 * (xnc_inu - xni_now
                          + torch.abs(xnc_inu - xni_now)) * odts
        pri_inu = torch.where(inu, torch.minimum(rate_max_i,
                                                 c.XM0I * pni_inu0), 0.0)
        pni_inu = torch.where(inu, pri_inu / c.XM0I, 0.0)

        # Koop (2001) homogeneous freezing of deliquesced aerosols
        # (f90:2103-2111)
        if aero and cfg.homog_ice:
            xni_koop = smo0 + ni + (pni_rfz + pni_wfz + pni_inu) * dt
            iha_on = (t_lt_0 & (xni_koop <= 500.0e3) & (temp < 238.0)
                      & (ssati >= 0.4))
            xnc_iha = guarded("koop", iha_on,
                              ice_koop(temp, qv, pro["qvs"], nwfa, dt))
            pni_iha0 = xnc_iha * odts
            pri_iha = torch.where(iha_on, torch.minimum(
                rate_max_i, c.XM0I * 0.1 * pni_iha0), 0.0)
            pni_iha = torch.where(iha_on, pri_iha / (c.XM0I * 0.1), 0.0)

        # cloud-ice deposition/sublimation (f90:2115-2133)
        ilami = pro["ilami"]
        xdi = pro["xdi"]
        oxmi = pro["oxmi"]
        ide0 = (c.C_CUBE * t1_subl * diffu * ssati * rvs_i
                * c.OIG1 * CIG[5] * ni * ilami)
        ide_neg = torch.maximum(torch.maximum(-ri * odts, ide0), rate_max_i)
        pni_ide_neg = torch.maximum(-ni * odts, ide_neg * oxmi)
        ide_pos = torch.minimum(ide0, rate_max_i)
        tide = pro["tide"]
        ice_on = t_lt_0 & l_qi
        pri_ide = torch.where(ice_on, torch.where(ide0 < 0.0, ide_neg,
                                                  tide * ide_pos), 0.0)
        pni_ide = torch.where(ice_on & (ide0 < 0.0), pni_ide_neg, 0.0)
        prs_ide = torch.where(ice_on & (ide0 >= 0.0),
                              (1.0 - tide) * ide_pos, 0.0)

        # snow deposition/sublimation (f90:2151-2164)
        c_snow = torch.clamp(c.C_SQRD + (tempc + 1.5) * (c.C_CUBE - c.C_SQRD)
                             / (-30.0 + 1.5), c.C_SQRD, c.C_CUBE)
        sde0 = (c_snow * t1_subl * diffu * ssati * rvs_i
                * (c.T1_QS_SD * smo1 + c.T2_QS_SD * rhof2 * vsc2 * smof))
        prs_sde_cold = torch.where(
            sde0 < 0.0, torch.maximum(torch.maximum(-rs * odts, sde0),
                                      rate_max_i),
            torch.minimum(sde0, rate_max_i))
        prs_sde = torch.where(t_lt_0 & l_qs, prs_sde_cold, 0.0)

        # graupel sublimation (cold branch needs ssati < -eps, f90:2166-2175)
        gde0 = (c.C_CUBE * t1_subl * diffu * ssati * rvs_i * n0_g
                * (c.T1_QG_SD * powc(ilamg, CGE[10])
                   + c.T2_QG_SD * vsc2 * rhof2 * g_cge11))
        gde_lim = torch.where(gde0 < 0.0,
                              torch.maximum(torch.maximum(-rg * odts, gde0),
                                            rate_max_i),
                              torch.minimum(gde0, rate_max_i))
        prg_gde = torch.where(t_lt_0 & l_qg & (ssati < -c.EPS), gde_lim,
                              0.0)

        # snow collecting cloud ice (f90:2177-2187)
        sci_on = ice_on & (rs >= _RS1)
        prs_sci = torch.where(sci_on,
                              c.T1_QS_QI * rhof * c.EF_SI * ri * smoe, 0.0)
        pni_sci = torch.where(sci_on, prs_sci * oxmi, 0.0)

        # rain collecting cloud ice -> graupel (f90:2189-2201)
        rci_on = ice_on & (rr >= _RR1) & (mvd_r > 4.0 * xdi)
        pri_rci = torch.where(rci_on, rhof * c.T1_QR_QI * c.EF_RI * ri
                              * n0_r * geo_r, 0.0)
        pnr_rci = torch.where(rci_on, rhof * c.T1_QR_QI * c.EF_RI * ni
                              * n0_r * geo_r, 0.0)
        pni_rci = torch.where(rci_on, pri_rci * oxmi, 0.0)
        prr_rci = torch.where(rci_on, torch.minimum(
            rr * odts, rhof * c.T2_QR_QI * c.EF_RI * ni * n0_r
            * powc(lamr + c.FV_R, -CRE[8])), 0.0)
        prg_rci = torch.where(rci_on, pri_rci + prr_rci, 0.0)

        # Hallett-Mossop rime splintering (f90:2204-2218)
        hm_on = t_lt_0 & (prg_gcw > c.EPS) & (tempc > -8.0)
        tf = torch.where((tempc >= -5.0) & (tempc < -3.0),
                         0.5 * (-3.0 - tempc),
                         torch.where((tempc > -8.0) & (tempc < -5.0),
                                     0.33333333 * (8.0 + tempc), 0.0))
        pni_ihm = torch.where(hm_on, 3.5e8 * tf * prg_gcw, 0.0)
        pri_ihm = torch.where(hm_on, c.XM0I * pni_ihm, 0.0)
        hm_den = torch.clamp(prs_scw + prg_gcw, min=1e-30)
        prs_ihm = torch.where(hm_on, prs_scw / hm_den * pri_ihm, 0.0)
        prg_ihm = torch.where(hm_on, prg_gcw / hm_den * pri_ihm, 0.0)

        # rimed snow -> graupel split + fallspeed boost (f90:2220-2231)
        conv = t_lt_0 & (prs_scw > 2.0 * prs_sde) & (prs_sde > c.EPS)
        r_frac = torch.clamp(prs_scw / torch.clamp(prs_sde, min=1e-30),
                             max=30.0)
        g_frac = torch.clamp(0.15 + (r_frac - 2.0) * 0.028, max=0.95)
        vts_boost = torch.where(
            conv, torch.clamp(1.1 + (r_frac - 2.0) * 0.016, max=1.5),
            vts_boost)
        prg_scw = torch.where(conv, g_frac * prs_scw, 0.0)
        prs_scw = torch.where(conv, (1.0 - g_frac) * prs_scw, prs_scw)

        # ---------- melting branch, T >= T_0 (f90:2235-2281) ----------------
        melt = ~t_lt_0
        sml0 = ((tempc * tcond - c.LVAP0 * diffu * delqvs)
                * (c.T1_QS_ME * smo1 + c.T2_QS_ME * rhof2 * vsc2 * smof))
        sml = torch.minimum(rs * odts, torch.clamp(
            sml0 + 4218.0 * c.OLFUS * tempc * (prr_rcs + prs_scw), min=0.0))
        prr_sml = torch.where(melt & l_qs, sml, 0.0)
        pnr_sml = torch.where(melt & l_qs, torch.minimum(
            smo0 * odts, smo0 / torch.clamp(rs, min=c.R1) * prr_sml
            * exp10(-0.25 * tempc)), 0.0)
        # subsaturated snow in the melting layer sublimates (f90:2247-2252)
        prs_sde = torch.where(melt & l_qs & (ssati < 0.0), torch.maximum(
            -rs * odts, c.C_CUBE * t1_subl * diffu * ssati * rvs_i
            * (c.T1_QS_SD * smo1 + c.T2_QS_SD * rhof2 * vsc2 * smof)),
            prs_sde)
        gml0 = ((tempc * tcond - c.LVAP0 * diffu * delqvs) * n0_g
                * (c.T1_QG_ME * powc(ilamg, CGE[10])
                   + c.T2_QG_ME * rhof2 * vsc2 * g_cge11))
        prr_gml = torch.where(melt & l_qg, torch.minimum(
            rg * odts, torch.clamp(gml0, min=0.0)), 0.0)
        pnr_gml = torch.where(
            melt & l_qg,
            n0_g * CGG[2] * powc(ilamg, CGE[2])
            / torch.clamp(rg, min=c.R1) * prr_gml
            * exp10(-0.5 * tempc), 0.0)
        prg_gde = torch.where(melt & l_qg & (ssati < 0.0),
                              torch.maximum(-rg * odts, gde0), prg_gde)
        # long-timestep riming reroute (f90:2277-2281)
        if dt > 120.0:
            prr_rcw = torch.where(melt, prr_rcw + prs_scw + prg_gcw,
                                  prr_rcw)
            prs_scw = torch.where(melt, 0.0, prs_scw)
            prg_gcw = torch.where(melt, 0.0, prg_gcw)

    # ---- phase 10: conservation ratio-clamps (f90:2291-2387) --------------
    def _scale(cond, ratio, *rates):
        return tuple(torch.where(cond, r * ratio, r) for r in rates)

    def _ratio(rate_max, bad, sump):
        return rate_max / torch.where(bad, sump, 1.0)

    # vapor deposition group
    # (pri_iha is zero unless aerosol-aware: adding it changes no bit)
    sump = pri_inu + pri_ide + prs_ide + prs_sde + prg_gde + pri_iha
    rate_max = (qv - qvsi) * odts * 0.999
    bad = (((sump > c.EPS) & (sump > rate_max))
           | ((sump < -c.EPS) & (sump < rate_max)))
    ratio = _ratio(rate_max, bad, sump)
    (pri_inu, pri_ide, pni_ide, prs_ide, prs_sde, prg_gde,
     pri_iha) = _scale(bad, ratio, pri_inu, pri_ide, pni_ide, prs_ide,
                       prs_sde, prg_gde, pri_iha)

    # cloud water
    sump = -prr_wau - pri_wfz - prr_rcw - prs_scw - prg_scw - prg_gcw
    rate_max = -rc * odts
    bad = (sump < rate_max) & l_qc
    ratio = _ratio(rate_max, bad, sump)
    (prr_wau, pri_wfz, prr_rcw, prs_scw, prg_scw, prg_gcw) = _scale(
        bad, ratio, prr_wau, pri_wfz, prr_rcw, prs_scw, prg_scw, prg_gcw)

    # cloud ice
    sump = pri_ide - prs_iau - prs_sci - pri_rci
    rate_max = -ri * odts
    bad = (sump < rate_max) & l_qi
    ratio = _ratio(rate_max, bad, sump)
    (pri_ide, prs_iau, prs_sci, pri_rci) = _scale(
        bad, ratio, pri_ide, prs_iau, prs_sci, pri_rci)

    # rain
    sump = -prg_rfz - pri_rfz - prr_rci + prr_rcs + prr_rcg
    rate_max = -rr * odts
    bad = (sump < rate_max) & l_qr
    ratio = _ratio(rate_max, bad, sump)
    (prg_rfz, pri_rfz, prr_rci, prr_rcs, prr_rcg) = _scale(
        bad, ratio, prg_rfz, pri_rfz, prr_rci, prr_rcs, prr_rcg)

    # snow
    sump = prs_sde - prs_ihm - prr_sml + prs_rcs
    rate_max = -rs * odts
    bad = (sump < rate_max) & l_qs
    ratio = _ratio(rate_max, bad, sump)
    (prs_sde, prs_ihm, prr_sml, prs_rcs) = _scale(
        bad, ratio, prs_sde, prs_ihm, prr_sml, prs_rcs)

    # graupel
    sump = prg_gde - prg_ihm - prr_gml + prg_rcg
    rate_max = -rg * odts
    bad = (sump < rate_max) & l_qg
    ratio = _ratio(rate_max, bad, sump)
    (prg_gde, prg_ihm, prr_gml, prg_rcg) = _scale(
        bad, ratio, prg_gde, prg_ihm, prr_gml, prg_rcg)

    # symmetry re-enforcement (f90:2375-2385)
    pri_ihm = prs_ihm + prg_ihm
    pair = torch.minimum(torch.abs(prr_rcg), torch.abs(prg_rcg))
    prr_rcg = pair * torch.sign(prr_rcg)
    prg_rcg = -prr_rcg
    warm_lvl = temp > c.T_0
    pair = torch.minimum(torch.abs(prr_rcs), torch.abs(prs_rcs))
    prr_rcs = torch.where(warm_lvl, pair * torch.sign(prr_rcs), prr_rcs)
    prs_rcs = torch.where(warm_lvl, -prr_rcs, prs_rcs)

    # ---- phase 11: tendency assembly + number clamps (f90:2393-2569) ------
    orho = 1.0 / rho
    lfus2 = c.LSUB - lvap

    qvten = (-pri_inu - pri_iha - pri_ide - prs_ide - prs_sde
             - prg_gde) * orho
    qcten = (-prr_wau - pri_wfz - prr_rcw - prs_scw - prg_scw
             - prg_gcw) * orho
    ncten = (-pnc_wau - pnc_rcw - pni_wfz - pnc_scw - pnc_gcw) * orho

    # cloud mass/number balance (f90:2428-2448); the reference uses the
    # OLD rc in the lamc denominator at :2432, reproduced
    xrc = torch.clamp((qc1d + qcten * dt) * rho, min=c.R1)
    xnc = torch.clamp((nc1d + ncten * dt) * rho, min=2.0)
    nu_c = trunc_int(torch.clamp(fnint(1000.0e6 / xnc) + 2, max=15))
    ccg1_n, ccg2_n, _u3, ocg1_n, ocg2_n, cce2_n = _nuc_rows(nu_c, dtype)
    lamc = powc(xnc * c.AM_R * ccg2_n * ocg1_n / rc, c.OBMR)
    xdc = (c.BM_R + nu_c.to(dtype) + 1.0) / lamc
    lamc_lo = cce2_n / c.D0C
    lamc_hi = cce2_n / (c.D0R * 2.0)
    xnc_lo = ccg1_n * ocg2_n * xrc / c.AM_R * powc(lamc_lo, c.BM_R)
    xnc_hi = ccg1_n * ocg2_n * xrc / c.AM_R * powc(lamc_hi, c.BM_R)
    ncten = torch.where(
        xrc > c.R1,
        torch.where(xdc < c.D0C, (xnc_lo - nc1d * rho) * odts * orho,
                    torch.where(xdc > c.D0R * 2.0,
                                (xnc_hi - nc1d * rho) * odts * orho, ncten)),
        -nc1d * odts)
    xnc = torch.clamp((nc1d + ncten * dt) * rho, min=0.0)
    ncten = torch.where(xnc > c.NT_C_MAX,
                        (c.NT_C_MAX - nc1d * rho) * odts * orho, ncten)

    qiten = (pri_inu + pri_iha + pri_ihm + pri_wfz + pri_rfz + pri_ide
             - prs_iau - prs_sci - pri_rci) * orho
    niten = (pni_inu + pni_iha + pni_ihm + pni_wfz + pni_rfz + pni_ide
             - pni_iau - pni_sci - pni_rci) * orho

    # ice mass/number balance (f90:2464-2484)
    xri = torch.clamp((qi1d + qiten * dt) * rho, min=c.R1)
    xni = torch.clamp((ni1d + niten * dt) * rho, min=c.R2)
    lami = powc(c.AM_I * CIG[2] * c.OIG1 * xni / xri, c.OBMI)
    xdi = (c.BM_I + c.MU_I + 1.0) / lami
    xni_lo = torch.clamp(CIG[1] * c.OIG2 * xri / c.AM_I
                         * powc(CIE[2] / 5.0e-6, c.BM_I), max=499.0e3)
    xni_hi = (CIG[1] * c.OIG2 * xri / c.AM_I
              * powc(CIE[2] / 300.0e-6, c.BM_I))
    niten = torch.where(
        xri > c.R1,
        torch.where(xdi < 5.0e-6, (xni_lo - ni1d * rho) * odts * orho,
                    torch.where(xdi > 300.0e-6,
                                (xni_hi - ni1d * rho) * odts * orho, niten)),
        -ni1d * odts)
    xni = torch.clamp((ni1d + niten * dt) * rho, min=0.0)
    niten = torch.where(xni > 499.0e3,
                        (499.0e3 - ni1d * rho) * odts * orho, niten)

    qrten = (prr_wau + prr_rcw + prr_sml + prr_gml + prr_rcs + prr_rcg
             - prg_rfz - pri_rfz - prr_rci) * orho
    nrten = (pnr_wau + pnr_sml + pnr_gml
             - (pnr_rfz + pnr_rcr + pnr_rcg + pnr_rcs + pnr_rci)) * orho

    # rain mass/number balance (f90:2515-2534)
    xrr = torch.clamp((qr1d + qrten * dt) * rho, min=c.R1)
    xnr = torch.clamp((nr1d + nrten * dt) * rho, min=c.R2)
    lamr_b = powc(c.AM_R * CRG[3] * c.ORG2 * xnr / xrr, c.OBMR)
    mvd_b = (3.0 + c.MU_R + 0.672) / lamr_b
    xnr_hi = _nr_from_mvd(xrr, 2.5e-3)
    xnr_lo = _nr_from_mvd(xrr, c.D0R * 0.75)
    has_rain_after = (qr1d + qrten * dt) * rho > c.R1
    nrten = torch.where(
        has_rain_after,
        torch.where(mvd_b > 2.5e-3, (xnr_hi - nr1d * rho) * odts * orho,
                    torch.where(mvd_b < c.D0R * 0.75,
                                (xnr_lo - nr1d * rho) * odts * orho, nrten)),
        -nr1d * odts)
    qrten = torch.where(has_rain_after, qrten, -qr1d * odts)
    mvd_r = torch.where(has_rain_after,
                        torch.clamp(mvd_b, c.D0R * 0.75, 2.5e-3), mvd_r)

    qsten = (prs_iau + prs_sde + prs_sci + prs_scw + prs_rcs + prs_ide
             - prs_ihm - prr_sml) * orho
    qgten = (prg_scw + prg_rfz + prg_gde + prg_rcg + prg_gcw + prg_rci
             + prg_rcs - prg_ihm - prr_gml) * orho

    # temperature tendency split by T (f90:2550-2567)
    ifdry = float(1 - cfg.ifdry)
    tten_cold = (c.LSUB * ocp * (pri_inu + pri_ide + prs_ide + prs_sde
                                 + prg_gde + pri_iha)
                 + lfus2 * ocp * (pri_wfz + pri_rfz + prg_rfz + prs_scw
                                  + prg_scw + prg_gcw + prg_rcs + prs_rcs
                                  + prr_rci + prg_rcg)) * orho * ifdry
    tten_warm = (c.LFUS * ocp * (-prr_sml - prr_gml - prr_rcg - prr_rcs)
                 + c.LSUB * ocp * (prs_sde + prg_gde)) * orho * ifdry
    tten = torch.where(temp < c.T_0, tten_cold, tten_warm)

    # aerosol tendencies (f90:2398-2408)
    nwfaten = z
    nifaten = z + 0.0
    if aero:
        nwfaten = -(pna_rca + pna_sca + pna_gca + pni_iha) * orho
        if cfg.dusty_ice:
            nifaten = (-(pnd_rcd + pnd_scd + pnd_gcd) - pni_inu) * orho

    out = dict(tten=tten, qvten=qvten, qcten=qcten, ncten=ncten,
               qiten=qiten, niten=niten, qrten=qrten, nrten=nrten,
               qsten=qsten, qgten=qgten, nwfaten=nwfaten, nifaten=nifaten,
               vts_boost=vts_boost, mvd_r_new=mvd_r, prr_gml=prr_gml)
    if want_rates:
        loc = locals()
        for k in P8_RATES:
            out[k] = loc[k]
    return out


def _prologue(state: ColumnState, pres, cfg: MicroConfig, want_idx=True):
    """Phases 2-7 of mp_thompson (f90:1387-1666) plus the PSD shapes and
    lookup-table indices of the phase 8-9 prologue (f90:1688-1694,
    1753-1881).  Returns (pro, idx): ``pro`` holds the rate-block input
    channels this stage can produce, ``idx`` the int64 lookup indices
    (empty when ``want_idx=False``)."""
    dtype = state.qv.dtype
    nt_c = cfg.nt_c
    z = torch.zeros_like(state.qv)

    t1d, qv1d = state.t, state.qv
    qc1d, qi1d, qr1d = state.qc, state.qi, state.qr
    qs1d, qg1d = state.qs, state.qg
    ni1d, nr1d, nc1d = state.ni, state.nr, state.nc

    # ---- phase 2: load column, presence flags, PSD sanity clamps ----------
    # (f90:1387-1493)
    temp = t1d
    qv = torch.clamp(qv1d, min=1.0e-10)
    rho = 0.622 * pres / (c.R_GAS * temp * (qv + 0.622))
    aero = cfg.is_aerosol_aware
    if aero:
        nwfa = torch.clamp(state.nwfa * rho, 11.1e6, 9999.0e6)
        nifa = torch.clamp(state.nifa * rho, c.NA_IN1 * 0.01, 9999.0e6)

    # cloud water (f90:1395-1418)
    l_qc = qc1d > c.R1
    qc1d = torch.where(l_qc, qc1d, 0.0)
    nc1d = torch.where(l_qc, nc1d, 0.0)
    rc = torch.where(l_qc, qc1d * rho, c.R1)
    if aero:
        # the droplet number of the state, clamped to the PSD limits
        nc_raw = torch.clamp(nc1d * rho, min=2.0)
        nu_raw = trunc_int(torch.clamp(fnint(1000.0e6 / nc_raw) + 2, max=15))
        ccg1_n, ccg2_n, _u, ocg1_n, ocg2_n, cce2_n = _nuc_rows(nu_raw, dtype)
        lamc = powc(nc_raw * c.AM_R * ccg2_n * ocg1_n / rc, c.OBMR)
        xdc = (c.BM_R + nu_raw.to(dtype) + 1.0) / lamc
        lamc = torch.where(xdc < c.D0C, cce2_n / c.D0C,
                           torch.where(xdc > c.D0R * 2.0,
                                       cce2_n / (c.D0R * 2.0), lamc))
        nc_cl = guarded("droplet_clamp", l_qc, torch.clamp(
            ccg1_n * ocg2_n * rc / c.AM_R * powc(lamc, c.BM_R),
            max=c.NT_C_MAX))
        nc = torch.where(l_qc, nc_cl, 2.0)
    else:
        nc = torch.where(l_qc, torch.full_like(qv, nt_c), 2.0)  # f90:1410

    # cloud ice (f90:1420-1445)
    l_qi = qi1d > c.R1
    qi1d = torch.where(l_qi, qi1d, 0.0)
    ni1d = torch.where(l_qi, ni1d, 0.0)
    ri = torch.where(l_qi, qi1d * rho, c.R1)
    ni0 = torch.clamp(ni1d * rho, min=c.R2)
    ni_fix = torch.clamp(CIG[1] * c.OIG2 * ri / c.AM_I
                         * powc(CIE[2] / 25.0e-6, c.BM_I), max=499.0e3)
    ni1 = torch.where(ni1d * rho <= c.R2, ni_fix, ni0)
    lami = powc(c.AM_I * CIG[2] * c.OIG1 * ni1 / ri, c.OBMI)
    xdi = (c.BM_I + c.MU_I + 1.0) / lami
    ni2 = torch.where(
        xdi < 5.0e-6,
        torch.clamp(CIG[1] * c.OIG2 * ri / c.AM_I
                    * powc(CIE[2] / 5.0e-6, c.BM_I), max=499.0e3),
        torch.where(xdi > 300.0e-6,
                    CIG[1] * c.OIG2 * ri / c.AM_I
                    * powc(CIE[2] / 300.0e-6, c.BM_I),
                    ni1))
    ni = torch.where(l_qi, ni2, c.R2)

    # rain (f90:1447-1474)
    l_qr = qr1d > c.R1
    qr1d = torch.where(l_qr, qr1d, 0.0)
    nr1d = torch.where(l_qr, nr1d, 0.0)
    rr = torch.where(l_qr, qr1d * rho, c.R1)
    nr0 = torch.clamp(nr1d * rho, min=c.R2)
    nr1 = torch.where(nr1d * rho <= c.R2, _nr_from_mvd(rr, 1.0e-3), nr0)
    lamr = powc(c.AM_R * CRG[3] * c.ORG2 * nr1 / rr, c.OBMR)
    mvd0 = (3.0 + c.MU_R + 0.672) / lamr
    nr2 = torch.where(mvd0 > 2.5e-3, _nr_from_mvd(rr, 2.5e-3),
                      torch.where(mvd0 < c.D0R * 0.75,
                                  _nr_from_mvd(rr, c.D0R * 0.75), nr1))
    nr = torch.where(l_qr, nr2, c.R2)
    mvd_r = torch.where(l_qr, torch.clamp(mvd0, c.D0R * 0.75, 2.5e-3), c.D0C)

    # snow / graupel (f90:1475-1492)
    l_qs = qs1d > c.R1
    qs1d = torch.where(l_qs, qs1d, 0.0)
    rs = torch.where(l_qs, qs1d * rho, c.R1)
    l_qg = qg1d > c.R1
    qg1d = torch.where(l_qg, qg1d, 0.0)
    rg = torch.where(l_qg, qg1d * rho, c.R1)

    # ---- phase 3: thermodynamics (f90:1503-1533) --------------------------
    tempc = temp - 273.15
    rhof = torch.sqrt(c.RHO_NOT / rho)
    rhof2 = torch.sqrt(rhof)
    qvs = rslf(pres, temp)
    delqvs = torch.clamp(rslf(pres, torch.full_like(temp, 273.15)) - qv,
                         min=0.0)
    qvsi = torch.where(tempc <= 0.0, rsif(pres, temp), qvs)
    satw = qv / qvs
    sati = qv / qvsi
    ssatw = satw - 1.0
    ssati = sati - 1.0
    ssatw = torch.where(torch.abs(ssatw) < c.EPS, 0.0, ssatw)
    ssati = torch.where(torch.abs(ssati) < c.EPS, 0.0, ssati)
    diffu = 2.11e-5 * powc(temp / 273.15, 1.94) * (101325.0 / pres)
    visco = torch.where(
        tempc >= 0.0, (1.718 + 0.0049 * tempc) * 1.0e-5,
        (1.718 + 0.0049 * tempc - 1.2e-5 * ipow(tempc, 2)) * 1.0e-5)
    ocp = 1.0 / (c.CP * (1.0 + 0.887 * qv))
    vsc2 = torch.sqrt(rho / visco)
    lvap = c.LVAP0 + (2106.0 - 4218.0) * tempc
    tcond = (5.69 + 0.0168 * tempc) * 1.0e-5 * 418.936

    # ---- phases 5-6: snow moments, graupel PSD (f90:1545-1656) ------------
    if not cfg.iiwarm:
        sm = _snow_moments(rs, temp, l_qs,
                           [("0", 0.0), ("1", 1.0), ("c", CSE[1]),
                            ("e", CSE[13]), ("f", CSE[16])])
        ilamg, n0_g = _graupel_psd(rg, temp, l_qr, mvd_r)

    # ---- phase 7: rain PSD (f90:1661-1666) --------------------------------
    ilamr, mvd_r, n0_r = _rain_psd(rr, nr)

    # ---- phases 8-11 prologue: PSD shapes + lookup indices ----------------
    # cloud mvd (f90:1688-1694); nu_c/lamc recomputed from current nc
    nu_c = trunc_int(torch.clamp(fnint(1000.0e6 / nc) + 2, max=15))
    ccg1_n, ccg2_n, ccg3_n, ocg1_n, ocg2_n, _u = _nuc_rows(nu_c, dtype)
    nu_c_f = nu_c.to(dtype)
    xdc = torch.clamp(powc(rc / (c.AM_R * nc), c.OBMR) * 1.0e6,
                      min=c.D0C * 1.0e6)
    lamc = powc(nc * c.AM_R * ccg2_n * ocg1_n / rc, c.OBMR)
    mvd_c = torch.where(l_qc, (3.0 + nu_c_f + 0.672) / lamc, c.D0C)
    dc_g = powc(ccg3_n * ocg2_n, c.OBMR) / lamc * 1.0e6
    idx = {}
    if want_idx:
        idx["rw"] = log_bin_index(torch.clamp(mvd_r, min=_DR1), _DR1, _DRN,
                                  c.NBR)
        idx["cw"] = torch.clamp(trunc_int(mvd_c * 1.0e6, -1.0, c.NBC + 1.0),
                                1, c.NBC) - 1

    pro = dict(temp=temp, qv=qv, qc1d=qc1d, nc1d=nc1d, qi1d=qi1d,
               ni1d=ni1d, qr1d=qr1d, nr1d=nr1d, qs1d=qs1d, qg1d=qg1d,
               rho=rho, rc=rc, nc=nc, ri=ri, ni=ni, rr=rr, nr=nr, rs=rs,
               rg=rg, rhof=rhof, rhof2=rhof2, qvs=qvs, qvsi=qvsi,
               delqvs=delqvs, ssatw=ssatw, ssati=ssati, diffu=diffu,
               visco=visco, vsc2=vsc2, ocp=ocp, lvap=lvap, tcond=tcond,
               ilamr=ilamr, mvd_r=mvd_r, n0_r=n0_r, mvd_c=mvd_c, xdc=xdc,
               dc_g=dc_g, nu_c_f=nu_c_f)
    if aero:
        pro.update(nwfa=nwfa, nifa=nifa)
    if cfg.iiwarm:
        return pro, idx

    smob, smoc = sm["b"], sm["c"]
    xds = torch.where(l_qs, smoc / torch.clamp(smob, min=1e-30), 0.0)
    # cloud-ice PSD shape for the ide/iau/sci/rci rates (f90:2115-2201)
    lami = powc(c.AM_I * CIG[2] * c.OIG1 * ni / ri, c.OBMI)
    ilami = 1.0 / lami
    xdi = torch.clamp((c.BM_I + c.MU_I + 1.0) * ilami, min=c.D0I)
    xmi = c.AM_I * powc(xdi, c.BM_I)
    oxmi = 1.0 / xmi
    pro.update(smo0=sm["0"], smo1=sm["1"], smob=smob, smoc=smoc,
               smoe=sm["e"], smof=sm["f"], ilamg=ilamg, n0_g=n0_g, xds=xds,
               ilami=ilami, xdi=xdi, oxmi=oxmi)
    if want_idx:
        # temperature / species table indices (f90:1753-1881, 2050-2062)
        idx["tc"] = torch.clamp(trunc_int(fnint(-tempc), -1.0, 46.0),
                                1, 45) - 1
        idx_t0 = trunc_int((tempc - 2.5) / 5.0) - 1
        idx["t"] = torch.clamp(torch.clamp(-idx_t0, min=1), 1, c.NTB_T) - 1
        has_r = rr > _RR1
        has_g = rg > _RG1
        lam_exp_r = (1.0 / ilamr) * (CRG[3] * c.ORG2 * c.ORG1) ** c.BM_R
        n0_exp_r = c.ORG1 * rr / c.AM_R * powc(lam_exp_r, CRE[1])
        lam_exp_g = (1.0 / ilamg) * (CGG[3] * c.OGG2 * c.OGG1) ** c.BM_G
        n0_exp_g = c.OGG1 * rg / c.AM_G * powc(lam_exp_g, CGE[1])
        zero = torch.zeros_like(nu_c)
        idx["c"] = torch.where(rc > _RC1, decade_index(rc, c.NIC2, c.NTB_C),
                               zero)
        idx["i"] = torch.where(ri > _RI1, decade_index(ri, c.NII2, c.NTB_I),
                               zero)
        idx["i1"] = torch.where(ni > _NTI1,
                                decade_index(ni, c.NII3, c.NTB_I1), zero)
        idx["r"] = torch.where(has_r, decade_index(rr, c.NIR2, c.NTB_R),
                               zero)
        idx["r1"] = torch.where(has_r,
                                decade_index(n0_exp_r, c.NIR3, c.NTB_R1),
                                zero + (c.NTB_R1 - 1))
        idx["s"] = torch.where(rs > _RS1, decade_index(rs, c.NIS2, c.NTB_S),
                               zero)
        idx["g"] = torch.where(has_g, decade_index(rg, c.NIG2, c.NTB_G),
                               zero)
        idx["g1"] = torch.where(has_g,
                                decade_index(n0_exp_g, c.NIG3, c.NTB_G1),
                                zero + (c.NTB_G1 - 1))
        idx["sw"] = log_bin_index(torch.clamp(xds, min=_DS1), _DS1, _DSN,
                                  c.NBS)
    return pro, idx


def _table_stage(pro, idx, tables: DeviceTables, cfg: MicroConfig,
                 dt_f: float):
    """Table lookups and their consumer rates (f90:1715-1726, 1902-1913,
    1961-2018, 2065-2086, 2135-2148) as plain torch gathers.  Returns the
    ``tv`` channel dict (``tv_keys(cfg)``): ef_rw, and for mixed phase
    ef_sw, tide and the 15 finished table-consuming rates.  With
    ``_prologue`` this is the plain version of ``table_stage.table_stage``,
    which computes the same function as one CUDA kernel."""
    dtype = pro["qv"].dtype
    _, odts = _dt_pair(dt_f, dtype)
    nt_c = cfg.nt_c
    ef_rw = tables.t_efrw[idx["rw"], idx["cw"]]
    if cfg.iiwarm:
        return {"ef_rw": ef_rw}
    temp = pro["temp"]
    rc = pro["rc"]; nc = pro["nc"]; ri = pro["ri"]; ni = pro["ni"]
    rr = pro["rr"]; nr = pro["nr"]; rs = pro["rs"]; rg = pro["rg"]
    ef_sw = tables.t_efsw[idx["sw"], idx["cw"]]
    idx_r = idx["r"]; idx_r1 = idx["r1"]; idx_tc = idx["tc"]
    t_lt_0 = temp < c.T_0
    rs_on = (rr >= _RR1) & (rs >= _RS1)
    rg_on = (rr >= _RR1) & (rg >= _RG1)
    frz_tab = t_lt_0 & (rr > _RR1)
    wfz_tab = t_lt_0 & (rc > _RC1)
    ice_on = t_lt_0 & (pro["qi1d"] > c.R1)
    # each gather's rows are read only where its consumers' mask holds
    lin_s = ((idx["s"] * c.NTB_T + idx["t"]) * c.NTB_R1 + idx_r1) \
        * c.NTB_R + idx_r
    rv = masked_rows("racs", rs_on[..., None],
                     tables.racs[lin_s]).unbind(-1)
    lin_g = ((idx["g1"] * c.NTB_G + idx["g"]) * c.NTB_R1 + idx_r1) \
        * c.NTB_R + idx_r
    gv = masked_rows("racg", rg_on[..., None],
                     tables.racg[lin_g]).unbind(-1)
    fv = masked_rows("qrfz", frz_tab[..., None], tables.qrfz[
        (idx_r * c.NTB_R1 + idx_r1) * 45 + idx_tc]).unbind(-1)
    cv = masked_rows("qcfz", wfz_tab, tables.qcfz[:, idx["c"] * 45 + idx_tc])
    iv = tables.iaus[:, idx["i"] * c.NTB_I1 + idx["i1"]]
    tide = iv[0]
    iv = (tide, *masked_rows("iaus", ice_on, iv[1:]))

    idx_i_top = idx["i"] == c.NTB_I - 1
    # rain<->snow collection via the 5 pre-summed combinations
    # (f90:1961-1997): ma, mb, mc, n_cold, n_warm
    ma, mb, mc, n_cold, n_warm = rv
    prr_rcs_c = torch.maximum(-rr * odts, -(mb + ma))
    prs_rcs_c = torch.maximum(-rs * odts, mb - mc)
    prg_rcs_c = torch.minimum((rr + rs) * odts, ma + mc)
    prs_rcs_w = torch.maximum(-rs * odts, mb - mc)
    prr_rcs_w = -prs_rcs_w
    prr_rcs = torch.where(rs_on, torch.where(t_lt_0, prr_rcs_c, prr_rcs_w),
                          0.0)
    prs_rcs = torch.where(rs_on, torch.where(t_lt_0, prs_rcs_c, prs_rcs_w),
                          0.0)
    prg_rcs = torch.where(rs_on & t_lt_0, prg_rcs_c, 0.0)
    pnr_rcs = torch.where(rs_on, torch.minimum(
        nr * odts, torch.where(t_lt_0, n_cold, n_warm)), 0.0)

    # rain<->graupel collection via the 4 pre-summed combinations
    # (f90:1999-2018)
    prg_rcg_c = torch.minimum(rr * odts, gv[0])
    pnr_rcg_c = torch.minimum(nr * odts, gv[1])
    prr_rcg_w = torch.minimum(rg * odts, gv[3])
    pnr_rcg_w = -5.0 * gv[2]                 # explicit break-up f90:2016
    prg_rcg = torch.where(rg_on, torch.where(t_lt_0, prg_rcg_c, -prr_rcg_w),
                          0.0)
    prr_rcg = torch.where(rg_on, torch.where(t_lt_0, -prg_rcg_c, prr_rcg_w),
                          0.0)
    pnr_rcg = torch.where(rg_on, torch.where(t_lt_0, pnr_rcg_c, pnr_rcg_w),
                          0.0)

    # rain freezing, Bigg 1953 (f90:2065-2076), order _QRFZ
    frz_hom = t_lt_0 & ~(rr > _RR1) & (rr > c.R1) & (temp < c.HGFR)
    prg_rfz = torch.where(frz_tab, fv[0] * odts, 0.0)
    pri_rfz = torch.where(frz_tab, fv[1] * odts,
                          torch.where(frz_hom, rr * odts, 0.0))
    pni_rfz = torch.where(frz_tab, fv[2] * odts,
                          torch.where(frz_hom, nr * odts, 0.0))
    pnr_rfz = torch.where(frz_tab, torch.minimum(nr * odts, fv[3] * odts),
                          torch.where(frz_hom, nr * odts, 0.0))

    # cloud water freezing (f90:2077-2086), order _QCFZ
    wfz_hom = t_lt_0 & ~(rc > _RC1) & (rc > c.R1) & (temp < c.HGFR)
    pri_wfz = torch.where(wfz_tab, torch.minimum(rc * odts, cv[0] * odts),
                          torch.where(wfz_hom, rc * odts, 0.0))
    pni_wfz = torch.where(
        wfz_tab,
        torch.minimum(torch.clamp(pri_wfz / (2.0 * c.XM0I),
                                  max=nt_c * odts), cv[1] * odts),
        torch.where(wfz_hom, nc * odts, 0.0))

    # ice -> snow autoconversion (f90:2135-2148)
    xdi = pro["xdi"]
    iau_big = idx_i_top | (xdi > 5.0 * c.D0S)
    iau_small = xdi < 0.1 * c.D0S
    prs_iau_t = torch.minimum(ri * 0.99 * odts, iv[1] * odts)
    pni_iau_t = torch.minimum(ni * 0.95 * odts, iv[2] * odts)
    prs_iau = torch.where(ice_on, torch.where(
        iau_big, ri * 0.99 * odts,
        torch.where(iau_small, 0.0, prs_iau_t)), 0.0)
    pni_iau = torch.where(ice_on, torch.where(
        iau_big, ni * 0.95 * odts,
        torch.where(iau_small, 0.0, pni_iau_t)), 0.0)

    return dict(
        ef_rw=ef_rw, ef_sw=ef_sw, tide=tide,
        prr_rcs=prr_rcs, prs_rcs=prs_rcs, prg_rcs=prg_rcs,
        pnr_rcs=pnr_rcs, prg_rcg=prg_rcg, prr_rcg=prr_rcg,
        pnr_rcg=pnr_rcg, prg_rfz=prg_rfz, pri_rfz=pri_rfz,
        pni_rfz=pni_rfz, pnr_rfz=pnr_rfz, pri_wfz=pri_wfz,
        pni_wfz=pni_wfz, prs_iau=prs_iau, pni_iau=pni_iau)


def _cfl(vt_mask, vt, dt, odzq):
    """Per-column CFL bookkeeping (f90:3239-3246): the lowest level that
    sediments (``ksed``), the substep count and its reciprocal."""
    nz = vt.shape[-1]
    top = nz - 1
    kk = torch.arange(nz, device=vt.device)
    ksed = torch.where(vt_mask, kk, 0).amax(-1, keepdim=True)
    ksed = torch.where(ksed == top, top - 1, ksed)
    nstep = torch.where(vt_mask, trunc_int(dt * vt * odzq + 1.0, 0.0, 2.0 ** 30),
                        0).amax(-1, keepdim=True)
    n_loop = torch.clamp(nstep, min=1)
    return ksed, n_loop, 1.0 / n_loop.to(vt.dtype)


def _sweep(n_loop, onstep, ksed, vts_mass, vts_num, ten_m, ten_n, dm, dn,
           floor_m, floor_n, gate_sed, orho, odzq, dt):
    """One species' substepped upwind sweep (f90:3365-3399 pattern): the
    batch's largest substep count, each column masked to its own."""
    nz = dm.shape[-1]
    top = nz - 1
    kk = torch.arange(nz, device=dm.device)
    ppt = torch.zeros(dm.shape[:-1] + (1,), dtype=dm.dtype, device=dm.device)

    def shift_up(a):
        return torch.cat([a[..., 1:], a[..., -1:] * 0.0], -1)

    for n in range(int(n_loop.max())):
        active = n < n_loop                               # (ncol, 1)
        upd = ((kk == top) | (kk <= ksed)) & active
        sed_m = vts_mass * dm * gate_sed
        dflx_m = shift_up(sed_m) - sed_m
        ten_m = torch.where(upd, ten_m + dflx_m * odzq * onstep * orho,
                            ten_m)
        dm = torch.where(upd, torch.maximum(
            dm + dflx_m * odzq * dt * onstep, torch.full_like(dm, floor_m)),
            dm)
        if vts_num is not None:
            sed_n = vts_num * dn * gate_sed
            dflx_n = shift_up(sed_n) - sed_n
            ten_n = torch.where(upd, ten_n + dflx_n * odzq * onstep * orho,
                                ten_n)
            dn = torch.where(upd, torch.maximum(
                dn + dflx_n * odzq * dt * onstep,
                torch.full_like(dn, floor_n)), dn)
        ppt = ppt + torch.where(active & (dm[..., 0:1] > c.R1 * 10.0),
                                sed_m[..., 0:1] * dt * onstep, 0.0)
    return ten_m, ten_n, dm, dn, ppt[..., 0]


def _post_rates(state: ColumnState, pres, dzq, p8, pro, cfg: MicroConfig,
                dt_f: float, want_rates: bool, aero_aux=None):
    """Phases 12-20 of mp_thompson (f90:2574-3686): provisional state at
    t+dt, PSD recompute, saturation adjustment + droplet nucleation, rain
    evaporation, terminal velocities + CFL-substepped sedimentation,
    instant melt/freeze, final apply + PSD renorm.  Aerosol-aware configs
    take the phase-14 lookups ``xnc_act`` and ``wev`` in ``aero_aux``
    (from ``aerosol_lookup_stage``), as the kernel path does."""
    aero = cfg.is_aerosol_aware
    if aero and aero_aux is None:
        raise ValueError("aerosol-aware configs need aero_aux "
                         "(aerosol_lookup_stage)")
    dtype = state.qv.dtype
    dt, odt = _dt_pair(dt_f, dtype)
    odts = odt
    nt_c = cfg.nt_c
    ifdry = float(1 - cfg.ifdry)
    t1d, qv1d = state.t, state.qv
    nwfa1d, nifa1d = state.nwfa, state.nifa
    qc1d = pro["qc1d"]; nc1d = pro["nc1d"]; qi1d = pro["qi1d"]
    ni1d = pro["ni1d"]; qr1d = pro["qr1d"]; nr1d = pro["nr1d"]
    qs1d = pro["qs1d"]; qg1d = pro["qg1d"]
    (tten, qvten, qcten, ncten, qiten, niten, qrten, nrten, qsten, qgten,
     nwfaten, nifaten, vts_boost, mvd_r, prr_gml) = [p8[k] for k in P8_OUT]

    # ---- phase 12: provisional state at t+dt (f90:2574-2656) --------------
    temp = t1d + dt * tten
    tempc = temp - 273.15
    qv = torch.clamp(qv1d + dt * qvten, min=1.0e-10)
    rho = 0.622 * pres / (c.R_GAS * temp * (qv + 0.622))
    qvs = rslf(pres, temp)
    ssatw = qv / qvs - 1.0
    ssatw = torch.where(torch.abs(ssatw) < c.EPS, 0.0, ssatw)
    lvap = c.LVAP0 + (2106.0 - 4218.0) * tempc
    ocp = 1.0 / (c.CP * (1.0 + 0.887 * qv))
    otemp = 1.0 / temp
    lvt2 = lvap * lvap * ocp * c.ORV * otemp * otemp

    l_qc = (qc1d + qcten * dt) > c.R1
    rc = torch.where(l_qc, (qc1d + qcten * dt) * rho, c.R1)
    if aero:
        nc = torch.where(l_qc, torch.clamp((nc1d + ncten * dt) * rho,
                                           min=2.0), 2.0)
    else:
        nc = torch.where(l_qc, torch.full_like(rc, nt_c), 2.0)  # f90:2602

    l_qi = (qi1d + qiten * dt) > c.R1
    ri = torch.where(l_qi, (qi1d + qiten * dt) * rho, c.R1)
    ni = torch.where(l_qi, torch.clamp((ni1d + niten * dt) * rho, min=c.R2),
                     c.R2)

    l_qr = (qr1d + qrten * dt) > c.R1
    rr = torch.where(l_qr, (qr1d + qrten * dt) * rho, c.R1)
    nr0 = torch.clamp((nr1d + nrten * dt) * rho, min=c.R2)
    lamr = powc(c.AM_R * CRG[3] * c.ORG2 * nr0 / rr, c.OBMR)
    mvd0 = (3.0 + c.MU_R + 0.672) / lamr
    nr2 = torch.where(mvd0 > 2.5e-3, _nr_from_mvd(rr, 2.5e-3),
                      torch.where(mvd0 < c.D0R * 0.75,
                                  _nr_from_mvd(rr, c.D0R * 0.75), nr0))
    nr = torch.where(l_qr, nr2, c.R2)
    mvd_r = torch.where(l_qr, torch.clamp(mvd0, c.D0R * 0.75, 2.5e-3), mvd_r)

    l_qs = (qs1d + qsten * dt) > c.R1
    rs = torch.where(l_qs, (qs1d + qsten * dt) * rho, c.R1)
    l_qg = (qg1d + qgten * dt) > c.R1
    rg = torch.where(l_qg, (qg1d + qgten * dt) * rho, c.R1)

    # ---- phase 13: recompute snow moments / graupel / rain PSD ------------
    # (f90:2662-2750); levels no longer snowy keep their stale moments
    if not cfg.iiwarm:
        sm2 = _snow_moments(rs, temp, l_qs, [("c", CSE[1])])
        smob = torch.where(l_qs, sm2["b"], pro["smob"])
        smoc = torch.where(l_qs, sm2["c"], pro["smoc"])
        ilamg, n0_g = _graupel_psd(rg, temp, l_qr, mvd_r)
    ilamr, mvd_r, n0_r = _rain_psd(rr, nr)

    # ---- phase 14: saturation adjustment + droplet nucleation -------------
    # (f90:2780-2874): 3-iteration Newton solve for the condensation amount
    orho = 1.0 / rho
    sat_mask = (ssatw > c.EPS) | ((ssatw < -c.EPS) & l_qc)
    clap = (qv - qvs) / (1.0 + lvt2 * qvs)
    for _ in range(3):
        ex = torch.exp(torch.clamp(lvt2 * clap, -50.0, 50.0))
        fcd = qvs * ex - qv + clap
        dfcd = qvs * lvt2 * ex + 1.0
        clap = clap - fcd / dfcd
    xrc = rc + clap * rho
    prw_vcd_pos = clap * odt
    # CCN activation (f90:2795-2801); non-aerosol: Nt_c
    xnc_act = aero_aux["xnc_act"] if aero else nt_c
    pnc_wcd_pos = torch.where(clap > c.EPS,
                              0.5 * (xnc_act - nc + torch.abs(xnc_act - nc))
                              * odts * orho, 0.0)
    if aero:
        # evaporate the drops smaller than Dc_star (f90:2804-2851)
        evap_br = (clap < -c.EPS) & (ssatw < -1.0e-6)
        pnc_wcd_pos = torch.where(
            evap_br, torch.maximum(-nc * 0.99 * orho * odt,
                                   -aero_aux["wev"] * orho * odt),
            pnc_wcd_pos)
        prw_vcd_pos = torch.where(
            evap_br, torch.maximum(-rc * 0.99 * orho * odt, prw_vcd_pos),
            prw_vcd_pos)
    # full-evaporation branch (xrc <= R1, f90:2853-2856)
    prw_vcd = torch.where(xrc > c.R1, prw_vcd_pos, -rc * orho * odt)
    pnc_wcd = torch.where(xrc > c.R1, pnc_wcd_pos, -nc * orho * odt)
    prw_vcd = torch.where(sat_mask, prw_vcd, 0.0)
    pnc_wcd = torch.where(sat_mask, pnc_wcd, 0.0)

    qvten = qvten - prw_vcd
    qcten = qcten + prw_vcd
    ncten = ncten + pnc_wcd
    nwfaten = nwfaten - pnc_wcd
    tten = tten + lvap * ocp * prw_vcd * ifdry
    # state refresh inside the mask only (f90:2865-2872)
    rc_n = torch.clamp((qc1d + dt * qcten) * rho, min=c.R1)
    qv_n = torch.clamp(qv1d + dt * qvten, min=1.0e-10)
    temp_n = t1d + dt * tten
    rc = torch.where(sat_mask, rc_n, rc)
    if aero:
        nc = torch.where(sat_mask, torch.clamp((nc1d + dt * ncten) * rho,
                                               min=2.0), nc)
    else:
        nc = torch.where(sat_mask, nt_c, nc)
    qv = torch.where(sat_mask, qv_n, qv)
    temp = torch.where(sat_mask, temp_n, temp)
    rho = torch.where(sat_mask,
                      0.622 * pres / (c.R_GAS * temp * (qv + 0.622)), rho)
    qvs = torch.where(sat_mask, rslf(pres, temp), qvs)
    ssatw = torch.where(sat_mask, qv / qvs - 1.0, ssatw)

    # ---- phase 15: rain evaporation (f90:2880-2960) -----------------------
    rev_mask = (ssatw < -c.EPS) & l_qr & ~(prw_vcd > 0.0)
    tempc = temp - 273.15
    orho = 1.0 / rho
    rhof2_c = torch.sqrt(torch.sqrt(c.RHO_NOT * orho))
    diffu_c = 2.11e-5 * powc(temp / 273.15, 1.94) * (101325.0 / pres)
    visco_c = torch.where(
        tempc >= 0.0, (1.718 + 0.0049 * tempc) * 1.0e-5,
        (1.718 + 0.0049 * tempc - 1.2e-5 * ipow(tempc, 2)) * 1.0e-5)
    vsc2_c = torch.sqrt(rho / visco_c)
    lvap_c = guarded("rain_evap", rev_mask,
                     c.LVAP0 + (2106.0 - 4218.0) * tempc)
    tcond_c = (5.69 + 0.0168 * tempc) * 1.0e-5 * 418.936
    ocp_c = guarded("rain_evap", rev_mask,
                    1.0 / (c.CP * (1.0 + 0.887 * qv)))
    lvap = torch.where(rev_mask, lvap_c, lvap)
    ocp = torch.where(rev_mask, ocp_c, ocp)
    t1_evap, rvs_w = _subl_prefactor(
        temp, qvs, rho, diffu_c, tcond_c, torch.clamp(ssatw, max=-1.0e-9),
        lvap_c, 2.0 * c.PI)
    lamr = 1.0 / ilamr
    quick = guarded("rain_evap", rev_mask,
                    (qv / qvs < 0.95) & (rr * orho <= 1.0e-8))
    rev0 = guarded("rain_evap", rev_mask,
                   t1_evap * diffu_c * (-ssatw) * n0_r * rvs_w
                   * (c.T1_QR_EV * powc(ilamr, CRE[10])
                      + c.T2_QR_EV * vsc2_c * rhof2_c
                      * powc(lamr + 0.5 * c.FV_R, -CRE[11])))
    rate_max = torch.minimum(rr * orho * odts, (qvs - qv) * odts)
    rev1 = torch.minimum(rate_max, rev0 * orho)
    # graupel-melt suppression factor (f90:2940-2943)
    eva_factor = torch.where(
        prr_gml > 0.0, torch.clamp(0.01 + 0.98 * (tempc / 20.0), max=1.0),
        1.0)
    prv_rev = torch.where(rev_mask, torch.where(quick, rr * orho * odts,
                                                rev1 * eva_factor), 0.0)
    pnr_rev = torch.where(rev_mask, torch.minimum(
        nr * 0.99 * orho * odts, prv_rev * nr / torch.clamp(rr, min=c.R1)),
        0.0)
    qrten = qrten - prv_rev
    qvten = qvten + prv_rev
    nrten = nrten - pnr_rev
    nwfaten = nwfaten + pnr_rev
    tten = tten - lvap * ocp * prv_rev * ifdry
    rr = torch.where(rev_mask, torch.clamp((qr1d + dt * qrten) * rho,
                                           min=c.R1), rr)
    qv = torch.where(rev_mask, torch.clamp(qv1d + dt * qvten, min=1.0e-10),
                     qv)
    nr = torch.where(rev_mask, torch.clamp((nr1d + dt * nrten) * rho,
                                           min=c.R2), nr)
    temp = torch.where(rev_mask, t1d + dt * tten, temp)
    rho = torch.where(rev_mask,
                      0.622 * pres / (c.R_GAS * temp * (qv + 0.622)), rho)

    # ---- phases 17+18: terminal velocities + substepped sedimentation -----
    # (f90:3198-3578)
    odzq = 1.0 / dzq
    orho = 1.0 / rho
    rhof = torch.sqrt(c.RHO_NOT / rho)                      # f90:3219

    def sweep(vt_mask_vt, vts_mass, vts_num, ten_m, ten_n, dm, dn, floor_m,
              floor_n, gate):
        ksed, n_loop, onstep = _cfl(vt_mask_vt > 1.0e-3, vt_mask_vt, dt,
                                    odzq)
        return _sweep(n_loop, onstep, ksed, vts_mass, vts_num, ten_m, ten_n,
                      dm, dn, floor_m, floor_n, gate, orho, odzq, dt)

    # rain (never gated by l_sediment; f90:3365-3399)
    valid_r = rr > c.R1
    lamr = powc(c.AM_R * CRG[3] * c.ORG2 * nr / rr, c.OBMR)
    vtr_m = guarded("rain_fall", valid_r,
                    rhof * c.AV_R * CRG[6] * c.ORG3 * powc(lamr, CRE[3])
                    * powc(lamr + c.FV_R, -CRE[6]))
    # deliberately slower number-weighted fall (f90:3229-3233)
    vtr_n = guarded("rain_fall", valid_r,
                    rhof * c.AV_R * CRG[7] / CRG[12] * powc(lamr, CRE[12])
                    * powc(lamr + c.FV_R, -CRE[7]))
    vtrk = _fill_down(vtr_m, valid_r)
    vtnrk = _fill_down(vtr_n, valid_r)
    vmax_r = torch.maximum(vtrk, vtnrk)
    qrten, nrten, rr, nr, pptrain = sweep(vmax_r, vtrk, vtnrk, qrten, nrten,
                                          rr, nr, c.R1, c.R2, 1.0)

    zcol = torch.zeros_like(pptrain)
    pptice = pptsnow = pptgraul = zcol
    if not cfg.iiwarm:
        gate = 1.0 if cfg.l_sediment else 0.0

        # cloud ice (f90:3447-3480)
        valid_i = ri > c.R1
        lami = powc(c.AM_I * CIG[2] * c.OIG1 * ni / ri, c.OBMI)
        ilami = 1.0 / lami
        vti_m = guarded("ice_fall", valid_i, rhof * c.AV_I * CIG[3]
                        * c.OIG2 * powc(ilami, c.BV_I))
        vti_n = guarded("ice_fall", valid_i, rhof * c.AV_I * CIG[6]
                        / CIG[7] * powc(ilami, c.BV_I))
        vtik = _fill_down(vti_m, valid_i)
        vtnik = _fill_down(vti_n, valid_i)
        qiten, niten, ri, ni, pptice = sweep(vtik, vtik, vtnik, qiten, niten,
                                             ri, ni, c.R1, c.R2, gate)

        # snow (f90:3284-3317, 3504-3529)
        valid_s = rs > c.R1
        xds = smoc / torch.clamp(smob, min=1e-30)
        mrat = 1.0 / torch.clamp(xds, min=1e-30)
        ils1 = 1.0 / (mrat * c.LAM0 + c.FV_S)
        ils2 = 1.0 / (mrat * c.LAM1 + c.FV_S)
        t1v = c.KAP0 * CSG[4] * powc(ils1, CSE[4])
        t2v = c.KAP1 * powc(mrat, c.MU_S) * CSG[10] * powc(ils2, CSE[10])
        ils1 = 1.0 / (mrat * c.LAM0)
        ils2 = 1.0 / (mrat * c.LAM1)
        t3v = c.KAP0 * CSG[1] * powc(ils1, CSE[1])
        t4v = c.KAP1 * powc(mrat, c.MU_S) * CSG[7] * powc(ils2, CSE[7])
        vts = rhof * c.AV_S * (t1v + t2v) / (t3v + t4v)
        vts_melt = torch.maximum(vts * vts_boost,
                                 vts * ((vtrk - vts * vts_boost)
                                        / (temp - c.T_0)))
        vts_eff = guarded("snow_fall", valid_s, torch.where(
            temp > (c.T_0 + 0.1), vts_melt, vts * vts_boost))
        vtsk = _fill_down(vts_eff, valid_s)
        qsten, _, rs, _, pptsnow = sweep(vtsk, vtsk, None, qsten, None, rs,
                                         None, c.R1, c.R1, gate)

        # graupel (f90:3321-3343, 3553-3578)
        valid_g = rg > c.R1
        vtg = rhof * c.AV_G * CGG[6] * c.OGG3 * powc(ilamg, c.BV_G)
        vtg_eff = guarded("graupel_fall", valid_g, torch.where(
            temp > c.T_0, torch.maximum(vtg, vtrk), vtg))
        vtgk = _fill_down(vtg_eff, valid_g)
        qgten, _, rg, _, pptgraul = sweep(vtgk, vtgk, None, qgten, None, rg,
                                          None, c.R1, c.R1, gate)

    # cloud-droplet sedimentation is dead code in the reference
    # (f90:3142-3162, 3414-3425) and stays off.

    # ---- phase 19: instant melt / instant freeze (f90:3584-3606) ----------
    if not cfg.iiwarm:
        xri = torch.clamp(qi1d + qiten * dt, min=0.0)
        melt_i = (temp > c.T_0) & (xri > 0.0)
        qcten = qcten + torch.where(melt_i, xri * odt, 0.0)
        ncten = ncten + torch.where(melt_i, ni1d * odt, 0.0)
        qiten = qiten - torch.where(melt_i, xri * odt, 0.0)
        niten = torch.where(melt_i, -ni1d * odt, niten)
        tten = tten - torch.where(melt_i, c.LFUS * ocp * xri * odt * ifdry,
                                  0.0)

        xrc2 = torch.clamp(qc1d + qcten * dt, min=0.0)
        frz_c = (temp < c.HGFR) & (xrc2 > 0.0)
        lfus2 = c.LSUB - lvap
        xnc2 = nc1d + ncten * dt
        qiten = qiten + torch.where(frz_c, xrc2 * odt, 0.0)
        niten = niten + torch.where(frz_c, xnc2 * odt, 0.0)
        qcten = qcten - torch.where(frz_c, xrc2 * odt, 0.0)
        ncten = ncten - torch.where(frz_c, xnc2 * odt, 0.0)
        tten = tten + torch.where(frz_c, lfus2 * ocp * xrc2 * odt * ifdry,
                                  0.0)

    # ---- phase 20: apply tendencies, final PSD renorm (f90:3623-3686) -----
    t_out = t1d + tten * dt
    qv_out = torch.clamp(qv1d + qvten * dt, min=1.0e-10)
    qc_out = qc1d + qcten * dt
    nc_out = torch.maximum(nc1d + ncten * dt, 2.0 / rho)
    nwfa_out = torch.minimum(torch.maximum(nwfa1d + nwfaten * dt,
                                           11.1e6 / rho), 9999.0e6 / rho)
    nifa_out = torch.minimum(torch.clamp(nifa1d + nifaten * dt,
                                         min=c.NA_IN1 * 0.01),
                             9999.0e6 / rho)

    has_c = qc_out > c.R1
    nu_c = trunc_int(torch.clamp(
        fnint(1000.0e6 / torch.clamp(nc_out * rho, min=1.0)) + 2, max=15))
    ccg1_n, ccg2_n, _u, ocg1_n, ocg2_n, cce2_n = _nuc_rows(nu_c, dtype)
    lamc = powc(c.AM_R * ccg2_n * ocg1_n * nc_out
                / torch.clamp(qc_out, min=c.R1), c.OBMR)
    xdc = (c.BM_R + nu_c.to(dtype) + 1.0) / lamc
    lamc = torch.where(xdc < c.D0C, cce2_n / c.D0C,
                       torch.where(xdc > c.D0R * 2.0, cce2_n / (c.D0R * 2.0),
                                   lamc))
    nc_renorm = torch.minimum(ccg1_n * ocg2_n * qc_out / c.AM_R
                              * powc(lamc, c.BM_R), c.NT_C_MAX / rho)
    qc_out = torch.where(has_c, qc_out, 0.0)
    nc_out = torch.where(has_c, nc_renorm, 0.0)

    qi_out = qi1d + qiten * dt
    ni_out = torch.maximum(ni1d + niten * dt, c.R2 / rho)
    has_i = qi_out > c.R1
    lami = powc(c.AM_I * CIG[2] * c.OIG1 * ni_out
                / torch.clamp(qi_out, min=c.R1), c.OBMI)
    xdi = (c.BM_I + c.MU_I + 1.0) / lami
    lami = torch.where(xdi < 5.0e-6, CIE[2] / 5.0e-6,
                       torch.where(xdi > 300.0e-6, CIE[2] / 300.0e-6, lami))
    ni_renorm = torch.minimum(CIG[1] * c.OIG2 * qi_out / c.AM_I
                              * powc(lami, c.BM_I), 499.0e3 / rho)
    qi_out = torch.where(has_i, qi_out, 0.0)
    ni_out = torch.where(has_i, ni_renorm, 0.0)

    qr_out = qr1d + qrten * dt
    nr_out = torch.maximum(nr1d + nrten * dt, c.R2 / rho)
    has_r = qr_out > c.R1
    lamr = powc(c.AM_R * CRG[3] * c.ORG2 * nr_out
                / torch.clamp(qr_out, min=c.R1), c.OBMR)
    mvd_f = torch.clamp((3.0 + c.MU_R + 0.672) / lamr, c.D0R * 0.75, 2.5e-3)
    lamr = (3.0 + c.MU_R + 0.672) / mvd_f
    nr_renorm = CRG[2] * c.ORG3 * qr_out * powc(lamr, c.BM_R) / c.AM_R
    qr_out = torch.where(has_r, qr_out, 0.0)
    nr_out = torch.where(has_r, nr_renorm, 0.0)

    qs_out = qs1d + qsten * dt
    qs_out = torch.where(qs_out > c.R1, qs_out, 0.0)
    qg_out = qg1d + qgten * dt
    qg_out = torch.where(qg_out > c.R1, qg_out, 0.0)

    new_state = ColumnState(
        t=t_out, qv=qv_out, qc=qc_out, qi=qi_out, qr=qr_out, qs=qs_out,
        qg=qg_out, ni=ni_out, nr=nr_out, nc=nc_out, nwfa=nwfa_out,
        nifa=nifa_out)
    precip = Precip(rain=pptrain, snow=pptsnow, graupel=pptgraul, ice=pptice)
    diag = {}
    if want_rates:
        # the P8_RATES pass through; a p8 of P8_OUT alone (the split
        # kernel's operand) has none
        diag = {k: p8[k] for k in P8_RATES if k in p8}
        diag.update(prr_gml=prr_gml, prv_rev=prv_rev, pnr_rev=pnr_rev)
    return new_state, precip, diag


def core_from_tables(state: ColumnState, pres, dzq, tv, cfg: MicroConfig,
                     dt_f: float, want_rates: bool):
    """Phases 2-20 given only the raw state and the table-stage channels
    ``tv``: the function the CUDA kernel computes (its plain version)."""
    pro, _ = _prologue(state, pres, cfg, want_idx=False)
    pro.update(tv)
    p8 = rates_and_tendencies(pro, cfg, dt_f, want_rates)
    return _post_rates(state, pres, dzq, p8, pro, cfg, dt_f, want_rates)


def rates_from_tables(state: ColumnState, pres, tv, cfg: MicroConfig,
                      dt_f: float, want_rates: bool):
    """Phases 2-11 given the raw state and the table-stage channels: the
    function of the aerosol split's first kernel (its plain version).
    Returns the p8 dict (P8_OUT, + P8_RATES with ``want_rates``)."""
    pro, _ = _prologue(state, pres, cfg, want_idx=False)
    pro.update(tv)
    return rates_and_tendencies(pro, cfg, dt_f, want_rates)


def post_from_p8(state: ColumnState, pres, dzq, p8, cfg: MicroConfig,
                 dt_f: float, want_rates: bool, aero_aux=None):
    """Phases 12-20 given the raw state, the p8 tendencies and (aerosol
    mode) the phase-14 lookups: the function of the aerosol split's
    second kernel (its plain version).  The prologue is recomputed for
    the phase-2 zeroed state and the stale snow moments."""
    pro, _ = _prologue(state, pres, cfg, want_idx=False)
    return _post_rates(state, pres, dzq, p8, pro, cfg, dt_f, want_rates,
                       aero_aux)


def aerosol_lookup_stage(state: ColumnState, pres, w1d, p8,
                         tables: DeviceTables, cfg: MicroConfig, dt_f: float):
    """The two aerosol-mode table lookups of phase 14 (f90:2795-2851)
    between the split kernels: the plain version of
    ``split_step.lookup_stage``.  Both read the provisional
    (phase-12) state, which depends on the p8 tendencies.  This stage
    re-derives the phase-12 thermodynamics they read from the RAW
    ``state.qc``/``state.nc``, as the reference does (ROADMAP.md Queue 3),
    then returns ``xnc_act`` (CCN activation, ``aerosol.activ_ncloud``)
    and ``wev`` (the drop-evaporation number from ``tnc_wev``, a plain
    gather at every cell, where the reference gathered a band of levels
    around the cells that consume it)."""
    dt, _ = _dt_pair(dt_f, state.qv.dtype)
    tten = p8["tten"]; qvten = p8["qvten"]; qcten = p8["qcten"]
    ncten = p8["ncten"]; nwfaten = p8["nwfaten"]
    temp = state.t + dt * tten
    tempc = temp - 273.15
    qv = torch.clamp(state.qv + dt * qvten, min=1.0e-10)
    rho = 0.622 * pres / (c.R_GAS * temp * (qv + 0.622))
    qvs = rslf(pres, temp)
    ssatw = qv / qvs - 1.0
    ssatw = torch.where(torch.abs(ssatw) < c.EPS, 0.0, ssatw)
    diffu = 2.11e-5 * powc(temp / 273.15, 1.94) * (101325.0 / pres)
    lvap = c.LVAP0 + (2106.0 - 4218.0) * tempc
    tcond = (5.69 + 0.0168 * tempc) * 1.0e-5 * 418.936
    nwfa = torch.clamp((state.nwfa + nwfaten * dt) * rho, min=11.1e6)
    l_qc = (state.qc + qcten * dt) > c.R1
    rc = torch.where(l_qc, (state.qc + qcten * dt) * rho, c.R1)
    nc = torch.where(l_qc, torch.clamp((state.nc + ncten * dt) * rho,
                                       min=2.0), 2.0)
    xnc_act = torch.clamp(activ_ncloud(temp, w1d, nwfa,
                                       tables.tnccn_corners), min=2.0)
    t1_evd, rvs_wd = _subl_prefactor(temp, qvs, rho, diffu, tcond, ssatw,
                                     lvap, 2.0 * c.PI)
    dc_star = torch.sqrt(torch.clamp(
        -2.0 * dt * t1_evd / (2.0 * c.PI) * 4.0 * diffu * ssatw * rvs_wd
        / c.RHO_W, min=0.0))
    idx_d = torch.clamp(trunc_int(1.0e6 * dc_star, -1.0, c.NBC + 1.0),
                        1, c.NBC) - 1
    idx_n = tnc_index(nc, float(c.T_NC[0]), c.NIC1, c.NBC)
    idx_ce = torch.where(rc > _RC1, decade_index(rc, c.NIC2, c.NTB_C),
                         torch.zeros_like(idx_d))
    wev = tables.tnc_wev[idx_d, idx_ce, idx_n]
    return {"xnc_act": xnc_act, "wev": wev}


def column_microphysics(state: ColumnState, pres, w1d, dzq, dt,
                        tables: DeviceTables, cfg: MicroConfig,
                        want_rates: bool = True, packed=None):
    """One microphysics timestep on a batch of (ncol, nz) columns.

    ``table_stage`` (``_prologue`` and ``_table_stage``: the lookup
    indices, the gathers and the rates that consume them) -> ``fused_step``;
    for aerosol-aware configs -> ``fused_rates`` -> ``lookup_stage``
    (``aerosol_lookup_stage``) -> ``fused_post``, the first two writing
    into the rows that the last one's packed input ends with unless
    ``want_rates``.  Each wrapper
    launches its CUDA kernel for a CUDA tensor and runs its plain version
    for a CPU tensor.  ``w1d`` (the
    cell-centred vertical velocity, m/s) feeds aerosol activation only.
    ``packed``, if given, is the first kernel's packed input whose head
    rows ``state``, ``pres`` (and, for ``fused_step``, ``dzq``) already
    are (the driver step's, ``driver.advection.advect``): the table stage
    writes its tail, and the packs copy nothing.
    Returns (new ColumnState, Precip, dict of process-rate profiles)."""
    from . import fused_step as F
    from . import split_step as A
    if cfg.is_aerosol_aware and w1d is None:
        raise ValueError("aerosol-aware configs need the vertical "
                         "velocity w1d")
    from . import table_stage as T
    dt_f = float(dt)
    # the tv channels go into the rows the next kernel's input ends with
    kernel = A if cfg.is_aerosol_aware else F
    tv_rows = (kernel.tv_out(state, cfg) if packed is None
               else packed[len(packed) - len(tv_keys(cfg)):])
    tv = T.table_stage(state, pres, tables, cfg, dt_f, out=tv_rows)
    if not cfg.is_aerosol_aware:
        return F.fused_step(state, pres, dzq, tv, cfg, dt_f, want_rates)
    # without rate profiles, kernel A's P8_OUT rows and the lookups go
    # into the rows that fused_post's packed input ends with
    post = None if want_rates else A.post_out(state)
    n_p8 = len(P8_OUT)
    p8 = A.fused_rates(state, pres, tv, cfg, dt_f, want_rates,
                       out=None if post is None else post[:n_p8])
    aux = A.lookup_stage(state, pres, w1d, p8, tables, cfg, dt_f,
                         out=None if post is None else post[n_p8:])
    return A.fused_post(state, pres, dzq, p8, aux, cfg, dt_f, want_rates)


def batched_microphysics(state: ColumnState, pres, w, dzq, dt,
                         tables: DeviceTables, cfg: MicroConfig,
                         want_rates: bool = True, device="cuda",
                         graphs: bool = True):
    """Batched columns (the reference's ``do i=1,nx`` loop,
    mphys_thompson09n.f90:54) on ``device``; every tensor must lie there.
    Raises without a GPU unless ``device="cpu"``.

    The reference compiles this call (``jax.jit``).  On a card, with
    ``graphs``, ``column_microphysics`` is captured once as a CUDA graph
    per (shapes, dtype, device, ``cfg``, ``dt``, ``want_rates``, tables)
    and replayed (``graphs.run``); ``graphs=False`` and the CPU run it
    eagerly.  A failed capture raises.  The outputs are the caller's own.
    Never call the graphed form inside another capture: ``mp_driver_3d``
    takes ``graphs=False``, and ``simulate``'s step calls
    ``column_microphysics`` itself."""
    from . import graphs as G
    dev = resolve_device(device)
    for t in (*state, pres, dzq):
        check_on(t, dev)
    if w is not None:
        check_on(w, dev)
    dt_f = float(dt)

    def body(*a):
        return column_microphysics(ColumnState(*a[:12]), a[12], a[13],
                                   a[14], dt_f, tables, cfg, want_rates)

    return G.run(body, (*state, pres, w, dzq),
                 ("batched_microphysics", cfg, dt_f, want_rates, id(tables)),
                 graphs)


def vmapped_microphysics(state: ColumnState, pres, w, dzq, dt,
                         tables: DeviceTables, cfg: MicroConfig,
                         device="cuda"):
    """The reference's ``vmap`` cross-check of the batched solver
    (``kid_tpu/micro/solver.py:2176``): each column runs alone, as a
    (1, nz) batch through ``column_microphysics`` with the rate profiles,
    eagerly, and the results are stacked.  Every tensor must lie on
    ``device`` (``pres``, ``w`` and ``dzq`` with a row a column); raises
    without a GPU unless ``device="cpu"``."""
    dev = resolve_device(device)
    for t in (*state, pres, w, dzq):
        check_on(t, dev)
    outs = [column_microphysics(
        ColumnState(*[t[i:i + 1] for t in state]), pres[i:i + 1],
        w[i:i + 1], dzq[i:i + 1], dt, tables, cfg, True)
        for i in range(state.qv.shape[0])]
    st, ppt, diag = zip(*outs)
    return (ColumnState(*[torch.cat(f) for f in zip(*st)]),
            Precip(*[torch.cat(f) for f in zip(*ppt)]),
            {k: torch.cat([d[k] for d in diag]) for k in diag[0]})
