"""Lookup-table builders (L2): the benchmark's frozen copy of
``kid_tpu_torch/tables/builders.py``, its code unchanged but for its
imports (the frozen ``constants``; ``gammp`` straight from scipy).

The reference builds ~20 tables with quadruple loops over table cells and
explicit 100x100 bin integrations (qr_acr_qg at module_mp_thompson09n.f90:
3698-3833 alone is ~1e10 flops, which is why it has a file cache and MPI
decomposition).  The collection-equation integrands are *separable*:

    T[cell_a, cell_b] = sum_{r,g} N_a(cell_a, r) * K(r, g) * N_b(cell_b, g)

so every table is three small matmuls.  Build time collapses from minutes of
serial Fortran to milliseconds, making the reference's file cache and MPI
decomposition unnecessary (a content-addressed npz cache is still provided in
``cache.py`` to mirror run_data/*.data, see f90:3710,3857).

All host-side float64 numpy.  Shapes and index orders match the Fortran
arrays exactly (documented per table).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np

from . import constants as c
from scipy.special import gammainc as gammp


class Tables(NamedTuple):
    """Immutable pytree of lookup tables (reference decl f90:322-342)."""

    # rain <-> graupel collection, (ntb_g1, ntb_g, ntb_r1, ntb_r) (f90:387-395)
    tcg_racg: np.ndarray
    tmr_racg: np.ndarray
    tcr_gacr: np.ndarray
    tmg_gacr: np.ndarray
    tnr_racg: np.ndarray
    tnr_gacr: np.ndarray
    # rain <-> snow collection, (ntb_s, ntb_t, ntb_r1, ntb_r) (f90:397-408)
    tcs_racs1: np.ndarray
    tmr_racs1: np.ndarray
    tcs_racs2: np.ndarray
    tmr_racs2: np.ndarray
    tcr_sacr1: np.ndarray
    tms_sacr1: np.ndarray
    tcr_sacr2: np.ndarray
    tms_sacr2: np.ndarray
    tnr_racs1: np.ndarray
    tnr_racs2: np.ndarray
    tnr_sacr1: np.ndarray
    tnr_sacr2: np.ndarray
    # Bigg freezing, cloud (ntb_c, 45) and rain (ntb_r, ntb_r1, 45) (f90:410-416)
    tpi_qcfz: np.ndarray
    tni_qcfz: np.ndarray
    tpi_qrfz: np.ndarray
    tpg_qrfz: np.ndarray
    tni_qrfz: np.ndarray
    tnr_qrfz: np.ndarray
    # ice -> snow autoconversion, (ntb_i, ntb_i1) (f90:418-420)
    tps_iaus: np.ndarray
    tni_iaus: np.ndarray
    tpi_ide: np.ndarray
    # collision efficiencies, (nbr, nbc) and (nbs, nbc) (f90:422-423)
    t_efrw: np.ndarray
    t_efsw: np.ndarray
    # vestigial: allocated+zeroed only in the reference (f90:425,744-750)
    tnr_rev: np.ndarray
    # drop evaporation, (nbc, ntb_c, nbc) (f90:426-427)
    tpc_wev: np.ndarray
    tnc_wev: np.ndarray
    # CCN activation fraction, == 1.0 in this variant (f90:429-430,752-762)
    tnccn_act: np.ndarray


def _vr_quartic(d):
    """Rain fallspeed quartic fit used inside table builders (f90:3733-3735)."""
    return (-0.1021 + 4.932e3 * d - 0.9551e6 * d * d
            + 0.07934e9 * d ** 3 - 0.002362e12 * d ** 4)


def _rain_bin_numbers():
    """N_r(cell, bin) for all (r_r, N0r_exp) cells (f90:3755-3760).

    Returns array of shape (ntb_r1, ntb_r, nbr): index order (k, m, n2).
    """
    n0r = c.N0R_EXP_AXIS[:, None]            # (k,1)
    rr = c.R_R_AXIS[None, :]                 # (1,m)
    lam_exp = (n0r * c.AM_R * c.CRG[1] / rr) ** c.ORE1
    lamr = lam_exp * (c.CRG[3] * c.ORG2 * c.ORG1) ** c.OBMR
    n0_r = n0r / (c.CRG[2] * lam_exp) * lamr ** c.CRE[2]
    d = c.DR_BINS[None, None, :]
    return (n0_r[..., None] * d ** c.MU_R
            * np.exp(-lamr[..., None] * d) * c.DTR_BINS[None, None, :])


def build_qr_acr_qg():
    """Rain<->graupel collection tables (f90:3698-3833), as 6 GEMMs."""
    vr = _vr_quartic(c.DR_BINS)
    vg = c.AV_G * c.DG_BINS ** c.BV_G
    massr = c.AM_R * c.DR_BINS ** c.BM_R
    massg = c.AM_G * c.DG_BINS ** c.BM_G

    dr = c.DR_BINS[:, None]
    dg = c.DG_BINS[None, :]
    geo = c.PI * 0.25 * c.EF_RG * (dg + dr) ** 2          # (nbr, nbg)
    dvg = np.maximum(vr[:, None] - vg[None, :], 0.0)
    dvr = np.maximum(vg[None, :] - vr[:, None], 0.0)

    n_r = _rain_bin_numbers()                              # (k, m, nbr)
    # graupel cells: (i=N0g_exp, j=r_g)
    n0g = c.N0G_EXP_AXIS[:, None]
    rg = c.R_G_AXIS[None, :]
    lam_exp = (n0g * c.AM_G * c.CGG[1] / rg) ** c.OGE1
    lamg = lam_exp * (c.CGG[3] * c.OGG2 * c.OGG1) ** c.OBMG
    n0_g = n0g / (c.CGG[2] * lam_exp) * lamg ** c.CGE[2]
    d = c.DG_BINS[None, None, :]
    n_g = (n0_g[..., None] * d ** c.MU_G
           * np.exp(-lamg[..., None] * d) * c.DTG_BINS[None, None, :])  # (i,j,nbg)

    def contract(kernel):
        # out[i,j,k,m] = sum_{r,g} N_r[k,m,r] kernel[r,g] N_g[i,j,g]
        return np.einsum('ijg,rg,kmr->ijkm', n_g, kernel, n_r, optimize=True)

    tcg_racg = contract(geo * dvg * massg[None, :])
    tmr_racg = contract(geo * dvg * massr[:, None])
    tnr_racg = contract(geo * dvg)
    tcr_gacr = contract(geo * dvr * massr[:, None])
    tmg_gacr = contract(geo * dvr * massg[None, :])
    tnr_gacr = contract(geo * dvr)
    # tmr_racg is clamped to the cell's rain content (f90:3802)
    tmr_racg = np.minimum(tmr_racg, c.R_R_AXIS[None, None, None, :])
    return tcg_racg, tmr_racg, tcr_gacr, tmg_gacr, tnr_racg, tnr_gacr


def snow_moments_from_m2(m2, tc):
    """Field et al. (2005) moment regression: given the bm_s-th moment (=M2
    for bm_s=2) and temperature (C), return (M2, M3) where M3 is the
    (bm_s+1)-th moment (f90:3937-3965).  Vectorized over inputs."""
    m2 = np.asarray(m2, np.float64)
    tc = np.asarray(tc, np.float64)
    csen = c.CSE[1]
    loga = (c.SA[0] + c.SA[1] * tc + c.SA[2] * csen + c.SA[3] * tc * csen
            + c.SA[4] * tc * tc + c.SA[5] * csen * csen
            + c.SA[6] * tc * tc * csen + c.SA[7] * tc * csen * csen
            + c.SA[8] * tc ** 3 + c.SA[9] * csen ** 3)
    a = 10.0 ** loga
    b = (c.SB[0] + c.SB[1] * tc + c.SB[2] * csen + c.SB[3] * tc * csen
         + c.SB[4] * tc * tc + c.SB[5] * csen * csen
         + c.SB[6] * tc * tc * csen + c.SB[7] * tc * csen * csen
         + c.SB[8] * tc ** 3 + c.SB[9] * csen ** 3)
    m3 = a * m2 ** b
    return m2, m3


def build_qr_acr_qs():
    """Rain<->snow collection tables (f90:3842-4082), as 12 GEMMs.

    The mass-ratio branch (massr > 1.5*masss, f90:3998-4028) depends only on
    the bin pair, so it becomes a static mask on the kernel matrices.
    """
    vr = _vr_quartic(c.DR_BINS)
    # snow fallspeed boosted 1.5x inside this integrand (f90:3906)
    vs = 1.5 * c.AV_S * c.DS_BINS ** c.BV_S * np.exp(-c.FV_S * c.DS_BINS)
    massr = c.AM_R * c.DR_BINS ** c.BM_R
    masss = c.AM_S * c.DS_BINS ** c.BM_S

    dr = c.DR_BINS[:, None]
    ds = c.DS_BINS[None, :]
    geo = c.PI * 0.25 * c.EF_RS * (ds + dr) ** 2
    dvs = np.maximum(vr[:, None] - vs[None, :], 0.0)
    dvr = np.maximum(vs[None, :] - vr[:, None], 0.0)
    mask1 = (massr[:, None] > 1.5 * masss[None, :]).astype(np.float64)
    mask2 = 1.0 - mask1

    n_r = _rain_bin_numbers()                              # (k, m, nbr)

    # snow cells: (i=r_s, j=Tc)
    m2 = (c.R_S_AXIS * c.OAMS)[:, None] * np.ones((1, c.NTB_T))
    tcj = c.TC_AXIS[None, :]
    # bm_s == 2 exactly, so "second" == M2 (f90:3938 branch)
    _, m3 = snow_moments_from_m2(m2, tcj)
    om3 = 1.0 / m3
    mrat = m2 * (m2 * om3) ** 3
    m0 = (m2 * om3) ** c.MU_S
    slam1 = m2 * om3 * c.LAM0
    slam2 = m2 * om3 * c.LAM1
    d = c.DS_BINS[None, None, :]
    n_s = (mrat[..., None]
           * (c.KAP0 * np.exp(-slam1[..., None] * d)
              + c.KAP1 * m0[..., None] * d ** c.MU_S
              * np.exp(-slam2[..., None] * d)) * c.DTS_BINS[None, None, :])

    def contract(kernel):
        # out[i,j,k,m] = sum_{r,s} N_s[i,j,s] kernel[r,s] N_r[k,m,r]
        return np.einsum('ijs,rs,kmr->ijkm', n_s, kernel, n_r, optimize=True)

    tcs_racs1 = contract(geo * dvs * masss[None, :] * mask1)
    tmr_racs1 = np.minimum(contract(geo * dvs * massr[:, None] * mask1),
                           c.R_R_AXIS[None, None, None, :])
    tcs_racs2 = contract(geo * dvs * masss[None, :] * mask2)
    tmr_racs2 = contract(geo * dvs * massr[:, None] * mask2)
    tcr_sacr1 = contract(geo * dvr * massr[:, None] * mask1)
    tms_sacr1 = contract(geo * dvr * masss[None, :] * mask1)
    tcr_sacr2 = contract(geo * dvr * massr[:, None] * mask2)
    tms_sacr2 = contract(geo * dvr * masss[None, :] * mask2)
    tnr_racs1 = contract(geo * dvs * mask1)
    tnr_racs2 = contract(geo * dvs * mask2)
    tnr_sacr1 = contract(geo * dvr * mask1)
    tnr_sacr2 = contract(geo * dvr * mask2)
    return (tcs_racs1, tmr_racs1, tcs_racs2, tmr_racs2,
            tcr_sacr1, tms_sacr1, tcr_sacr2, tms_sacr2,
            tnr_racs1, tnr_racs2, tnr_sacr1, tnr_sacr2)


def build_freeze_h2o():
    """Bigg (1953) freezing tables (f90:4092-4175).

    The reference's outer ``do m = 1, ntb_IN`` loop overwrites tables that
    have no IN dimension, so only the last iteration (Nt_IN=1e6, T_adjust=-3)
    survives; we compute that final state directly (SURVEY.md quirk 3).
    """
    t_adjust = max(-3.0, min(3.0 - np.log10(c.NT_IN_AXIS[-1]), 3.0))  # == -3
    k = np.arange(1, 46, dtype=np.float64)
    texp = np.exp(k - t_adjust) - 1.0                      # (45,)

    # --- rain part (no early exit in KiD variant; f90:4143 commented) ---
    massr = c.AM_R * c.DR_BINS ** c.BM_R
    vol = massr / c.RHO_W
    prob = 1.0 - np.exp(-120.0 * vol[None, :] * 5.2e-4 * texp[:, None])  # (45,nbr)
    n_r = _rain_bin_numbers()                              # (j=N0r, i=r_r, nbr)
    small = (massr < c.XM0G).astype(np.float64)
    big = 1.0 - small
    # out[i,j,k] with i=r_r, j=N0r_exp (f90:4145-4148 index order)
    tpi_qrfz = np.einsum('jin,kn,n->ijk', n_r, prob, small * massr, optimize=True)
    tni_qrfz = np.einsum('jin,kn,n->ijk', n_r, prob, small, optimize=True)
    tpg_qrfz = np.einsum('jin,kn,n->ijk', n_r, prob, big * massr, optimize=True)
    tnr_qrfz = np.einsum('jin,kn,n->ijk', n_r, prob, big, optimize=True)

    # --- cloud part (early exit when sum1 >= r_c(i); f90:4161-4168) ---
    nt_c1 = c.T_NC[0]
    nu_c = min(15, int(np.floor(1000.0e6 / nt_c1 + 0.5)) + 2)
    massc = c.AM_R * c.DC_BINS ** c.BM_R
    volc = massc / c.RHO_W
    probc = 1.0 - np.exp(-120.0 * volc[None, :] * 5.2e-4 * texp[:, None])  # (45,nbc)
    lamc = (nt_c1 * c.AM_R * c.CCG[2, nu_c] * c.OCG1[nu_c]
            / c.R_C_AXIS) ** c.OBMR                        # (ntb_c,)
    n0_c = nt_c1 * c.OCG1[nu_c] * lamc ** c.CCE[1, nu_c]
    n_c = (n0_c[:, None] * c.DC_BINS[None, :] ** nu_c
           * np.exp(-lamc[:, None] * c.DC_BINS[None, :]) * c.DTC_BINS[None, :])

    tpi_qcfz = np.zeros((c.NTB_C, 45))
    tni_qcfz = np.zeros((c.NTB_C, 45))
    for kk in range(45):
        # reverse (largest-bin-first) cumulative sums, truncated at first
        # crossing of r_c(i), inclusive — vectorized over i
        mass_term = probc[kk] * n_c * massc[None, :]        # (ntb_c, nbc)
        num_term = probc[kk] * n_c
        rc_mass = np.cumsum(mass_term[:, ::-1], axis=1)
        rc_num = np.cumsum(num_term[:, ::-1], axis=1)
        crossed = rc_mass >= c.R_C_AXIS[:, None]
        any_crossed = crossed.any(axis=1)
        stop = np.where(any_crossed, crossed.argmax(axis=1), c.NBC - 1)
        rows = np.arange(c.NTB_C)
        tpi_qcfz[:, kk] = rc_mass[rows, stop]
        tni_qcfz[:, kk] = np.minimum(nt_c1, rc_num[rows, stop])
    return tpi_qcfz, tni_qcfz, tpi_qrfz, tpg_qrfz, tni_qrfz, tnr_qrfz


def build_qi_aut_qs():
    """Ice->snow autoconversion tables (f90:4190-4233)."""
    r_i = c.R_I_AXIS[:, None]                              # (i,1)
    nt_i = c.NT_I_AXIS[None, :]                            # (1,j)
    lami = (c.AM_I * c.CIG[2] * c.OIG1 * nt_i / r_i) ** c.OBMI
    di_mean = (c.BM_I + c.MU_I + 1.0) / lami
    n0_i = nt_i * c.OIG1 * lami ** c.CIE[1]
    d = c.DI_BINS[None, None, :]
    n_i = (n0_i[..., None] * d ** c.MU_I
           * np.exp(-lami[..., None] * d) * c.DTI_BINS[None, None, :])
    large = (c.DI_BINS >= c.D0S).astype(np.float64)
    t1_mid = np.einsum('ijn,n->ij', n_i, large * c.AM_I * c.DI_BINS ** c.BM_I)
    t2_mid = np.einsum('ijn,n->ij', n_i, large)
    # the cast to single precision before comparing mirrors SNGL() (f90:4209)
    dm32 = di_mean.astype(np.float32).astype(np.float64)
    big = dm32 > 5.0 * c.D0S
    tiny = dm32 < c.D0I
    tps = np.where(big, r_i * np.ones_like(di_mean),
                   np.where(tiny, 0.0, t1_mid))
    tni = np.where(big, nt_i * np.ones_like(di_mean),
                   np.where(tiny, 0.0, t2_mid))
    tpi_ide = np.where(big, 0.0,
                       np.where(tiny, 1.0, gammp(c.MU_I + 2.0, lami * c.D0S)))
    return tps, tni, tpi_ide


def _beard_grover(stokes, p):
    """Beard & Grover (1974) linear-collision efficiency (f90:4284-4290)."""
    reynolds = 9.0 * stokes / (p * p * c.RHO_W)
    f = np.log(reynolds)
    g = -0.1007 - 0.358 * f + 0.0261 * f * f
    k0 = np.exp(g)
    z = np.log(stokes / (k0 + 1.0e-15))
    h = 0.1465 + 1.302 * z - 0.607 * z * z + 0.293 * z ** 3
    yc0 = 2.0 / c.PI * np.arctan(h)
    return (yc0 + p) ** 2 / ((1.0 + p) ** 2)


def build_table_efrw():
    """Rain-collects-cloud efficiency (f90:4243-4299), shape (nbr, nbc)."""
    dr = c.DR_BINS[:, None]
    dc = c.DC_BINS[None, :]
    p = dc / dr
    x = dc * 1.0e6

    # Pruppacher & Klett polynomial patches for p > 0.25 (f90:4259-4276)
    poly = np.where(
        dr < 75.0e-6, 0.026794 * x - 0.20604,
        np.where(
            dr < 125.0e-6, -0.00066842 * x * x + 0.061542 * x - 0.37089,
            np.where(
                dr < 175.0e-6,
                4.091e-06 * x ** 4 - 0.00030908 * x ** 3 + 0.0066237 * x * x
                - 0.0013687 * x - 0.073022,
                np.where(
                    dr < 250.0e-6,
                    9.6719e-5 * x ** 3 - 0.0068901 * x * x + 0.17305 * x
                    - 0.65988,
                    np.where(
                        dr < 350.0e-6,
                        9.0488e-5 * x ** 3 - 0.006585 * x * x + 0.16606 * x
                        - 0.56125,
                        0.00010721 * x ** 3 - 0.0072962 * x * x + 0.1704 * x
                        - 0.46929)))))

    vtr = _vr_quartic(dr)
    stokes = dc * dc * vtr * c.RHO_W / (9.0 * 1.718e-5 * dr)
    with np.errstate(invalid='ignore', divide='ignore'):
        bg = _beard_grover(stokes, p)
    ef = np.where(p > 0.25, poly, bg)
    ef = np.where((dr < 50.0e-6) | (dc < 3.0e-6), 0.0, ef)
    return np.clip(ef, 0.0, 0.95)


def build_table_efsw():
    """Snow-collects-cloud efficiency, Wang & Ji 2000 (f90:4307-4343)."""
    ds = c.DS_BINS[:, None]
    dc = c.DC_BINS[None, :]
    vtc = 1.19e4 * (1.0e4 * dc * dc * 0.25)
    vts = c.AV_S * ds ** c.BV_S * np.exp(-c.FV_S * ds) - vtc
    ds_m = (c.AM_S * ds ** c.BM_S / c.AM_R) ** c.OBMR
    p = dc / ds_m
    zero = (p > 0.25) | (ds < c.D0S) | (dc < 6.0e-6) | (vts < 1.0e-3)
    stokes = dc * dc * np.maximum(vts, 1e-30) * c.RHO_W / (9.0 * 1.718e-5 * ds_m)
    with np.errstate(invalid='ignore', divide='ignore'):
        bg = _beard_grover(stokes, p)
    ef = np.clip(bg, 0.0, 0.95)
    return np.where(zero, 0.0, ef)


def build_table_drop_evap():
    """Cumulative drop mass/number below the evaporation diameter D*
    (f90:4400-4439), shapes (nbc, ntb_c, nbc) indexed (i=D* bin, j=r_c,
    k=t_Nc)."""
    massc = c.AM_R * c.DC_BINS ** c.BM_R
    tpc = np.zeros((c.NBC, c.NTB_C, c.NBC))
    tnc = np.zeros((c.NBC, c.NTB_C, c.NBC))
    nint = lambda v: int(np.floor(v + 0.5))
    for k in range(c.NBC):
        nu_c = min(15, nint(1000.0e6 / c.T_NC[k]) + 2)
        lamc = (c.T_NC[k] * c.AM_R * c.CCG[2, nu_c] * c.OCG1[nu_c]
                / c.R_C_AXIS) ** c.OBMR                    # (ntb_c,)
        n0_c = c.T_NC[k] * c.OCG1[nu_c] * lamc ** c.CCE[1, nu_c]
        n_c = (n0_c[:, None] * c.DC_BINS[None, :] ** nu_c
               * np.exp(-lamc[:, None] * c.DC_BINS[None, :])
               * c.DTC_BINS[None, :])                      # (ntb_c, nbc)
        tpc[:, :, k] = np.cumsum(n_c * massc[None, :], axis=1).T
        tnc[:, :, k] = np.cumsum(n_c, axis=1).T
    return tpc, tnc


def build_all_tables(iiwarm: bool = False) -> Tables:
    """Build every lookup table (thompson_init dispatch, f90:764-791).

    When ``iiwarm`` the ice-phase builders are skipped and their tables are
    zero (matching f90:676-762 zero-fill + the skipped calls at :773-791).
    """
    t_efrw = build_table_efrw()
    t_efsw = build_table_efsw()
    tpc_wev, tnc_wev = build_table_drop_evap()

    z4g = np.zeros((c.NTB_G1, c.NTB_G, c.NTB_R1, c.NTB_R))
    z4s = np.zeros((c.NTB_S, c.NTB_T, c.NTB_R1, c.NTB_R))
    if iiwarm:
        racg = (z4g,) * 6
        racs = (z4s,) * 12
        qcfz = (np.zeros((c.NTB_C, 45)),) * 2
        qrfz = (np.zeros((c.NTB_R, c.NTB_R1, 45)),) * 4
        iaus = (np.zeros((c.NTB_I, c.NTB_I1)),) * 3
    else:
        racg = build_qr_acr_qg()
        racs = build_qr_acr_qs()
        frz = build_freeze_h2o()
        qcfz = frz[0:2]
        qrfz = frz[2:6]
        iaus = build_qi_aut_qs()

    return Tables(
        tcg_racg=racg[0], tmr_racg=racg[1], tcr_gacr=racg[2],
        tmg_gacr=racg[3], tnr_racg=racg[4], tnr_gacr=racg[5],
        tcs_racs1=racs[0], tmr_racs1=racs[1], tcs_racs2=racs[2],
        tmr_racs2=racs[3], tcr_sacr1=racs[4], tms_sacr1=racs[5],
        tcr_sacr2=racs[6], tms_sacr2=racs[7], tnr_racs1=racs[8],
        tnr_racs2=racs[9], tnr_sacr1=racs[10], tnr_sacr2=racs[11],
        tpi_qcfz=qcfz[0], tni_qcfz=qcfz[1],
        tpi_qrfz=qrfz[0], tpg_qrfz=qrfz[1], tni_qrfz=qrfz[2],
        tnr_qrfz=qrfz[3],
        tps_iaus=iaus[0], tni_iaus=iaus[1], tpi_ide=iaus[2],
        t_efrw=t_efrw, t_efsw=t_efsw,
        tnr_rev=np.zeros((c.NBR, c.NTB_R1, c.NTB_R)),
        tpc_wev=tpc_wev, tnc_wev=tnc_wev,
        tnccn_act=np.ones((c.NTB_ARC, c.NTB_ARW, c.NTB_ART, c.NTB_ARR,
                           c.NTB_ARK), dtype=np.float32),
    )
