"""The benchmark's frozen copy of the NumPy oracle
(``kid_tpu_torch/validation/oracle.py``), its code unchanged: its only
package import, ``constants``, resolves to the benchmark's own frozen
copy, and its host tables come from ``kidbench.reference.tables``.  It
imports nothing of the program.

Golden oracle: a literal, serial, NumPy-fp64 transliteration of the
reference column solver ``mp_thompson`` (module_mp_thompson09n.f90:
1156-3688).

Deliberately un-clever: explicit k loops, scalar math, the reference's
control flow reproduced branch for branch, with f90 line citations.  This
is the accuracy arbiter for the TPU solver (BASELINE.md: allclose rtol
1e-4 on qv,qc,qr,qi,qs,qg,ni,nr,theta) — the reference Fortran cannot be
compiled here (no gfortran), so equivalence is earned against
this transliteration instead.

Scope: the KiD-live configuration — ``is_aerosol_aware = .false.``
(module_mp_thompson09n.f90:28), both warm-only (iiwarm) and mixed-phase —
plus the aerosol-aware mode (CCN activation, explicit drop evaporation,
DeMott/Koop nucleation, scavenging; validated by tests/test_oracle.py and
the full-length aerosol1d case in VALIDATION artifacts).

Quirk policy follows SURVEY.md §2.6: cloud-droplet sedimentation is dead
code in the reference (velocities never assigned, f90:3142-3162) and is
treated as zero here; its side-effect-free rc/nc floors (f90:3436-3442)
touch locals that are never read again, so they are omitted.
"""
from __future__ import annotations

import math

import numpy as np

from . import constants as c

# -- L0 scalar special functions (f90:4656-4717) ----------------------------

_RSLF_C = (0.611583699e03, 0.444606896e02, 0.143177157e01, 0.264224321e-1,
           0.299291081e-3, 0.203154182e-5, 0.702620698e-8, 0.379534310e-11,
           -0.321582393e-13)
_RSIF_C = (0.609868993e03, 0.499320233e02, 0.184672631e01, 0.402737184e-1,
           0.565392987e-3, 0.521693933e-5, 0.307839583e-7, 0.105785160e-9,
           0.161444444e-12)


def rslf(p, t):
    x = max(-80.0, t - 273.16)
    esl = _RSLF_C[8]
    for cc in _RSLF_C[7::-1]:
        esl = cc + x * esl
    esl = min(esl, p * 0.15)
    return 0.622 * esl / (p - esl)


def rsif(p, t):
    x = max(-80.0, t - 273.16)
    esi = _RSIF_C[8]
    for cc in _RSIF_C[7::-1]:
        esi = cc + x * esi
    esi = min(esi, p * 0.15)
    return 0.622 * esi / (p - esi)


def _nint(x):
    """Fortran NINT: round half away from zero."""
    return int(math.floor(x + 0.5)) if x >= 0 else int(math.ceil(x - 0.5))


def _decade_idx(r, n2, ntb):
    """The literal NINT(log10)+goto decade search (f90:1762-1774 pattern).
    Returns the 1-based Fortran index."""
    nic = _nint(math.log10(r))
    n = nic + 1
    for nn in (nic - 1, nic, nic + 1):
        if 1.0 <= (r / 10.0 ** nn) < 10.0:
            n = nn
            break
    idx = int(r / 10.0 ** n) + 10 * (n - n2) - (n - n2)
    return max(1, min(idx, ntb))


def _field_ab(tc0, m):
    """Field et al. (2005) regression (a_, b_) at moment m (f90:1556+)."""
    sa, sb = c.SA, c.SB
    loga = (sa[0] + sa[1] * tc0 + sa[2] * m + sa[3] * tc0 * m
            + sa[4] * tc0 * tc0 + sa[5] * m * m + sa[6] * tc0 * tc0 * m
            + sa[7] * tc0 * m * m + sa[8] * tc0 ** 3 + sa[9] * m ** 3)
    b = (sb[0] + sb[1] * tc0 + sb[2] * m + sb[3] * tc0 * m
         + sb[4] * tc0 * tc0 + sb[5] * m * m + sb[6] * tc0 * tc0 * m
         + sb[7] * tc0 * m * m + sb[8] * tc0 ** 3 + sb[9] * m ** 3)
    return 10.0 ** loga, b


def _eff_aero(d, da, visc, rhoa, temp, species):
    """Slinn/Wang aerosol scavenging efficiency (f90:4354-4390), scalar."""
    boltzman = 1.3806503e-23
    mean_path = 0.0256e-6
    if species == "r":
        vt = (-0.1021 + 4.932e3 * d - 0.9551e6 * d * d
              + 0.07934e9 * d ** 3 - 0.002362e12 * d ** 4)
    elif species == "s":
        vt = c.AV_S * d ** c.BV_S
    else:
        vt = c.AV_G * d ** c.BV_G
    cc = 1.0 + 2.0 * mean_path / da * (1.257
                                       + 0.4 * math.exp(-0.55 * da
                                                        / mean_path))
    diff = boltzman * temp * cc / (3.0 * c.PI * visc * da)
    re = 0.5 * rhoa * d * vt / visc
    sc = visc / (rhoa * diff)
    st = da * da * vt * 1000.0 / (9.0 * visc * d)
    aval = 1.0 + math.log(1.0 + re)
    st2 = (1.2 + 1.0 / 12.0 * aval) / (1.0 + aval)
    eff = (4.0 / (re * sc) * (1.0 + 0.4 * math.sqrt(re) * sc ** (1 / 3)
                              + 0.16 * math.sqrt(re) * math.sqrt(sc))
           + 4.0 * da / d * (0.02 + da / d * (1.0 + 2.0 * math.sqrt(re))))
    if st > st2:
        eff = eff + ((st - st2) / (st - st2 + 0.666667)) ** 1.5
    return max(1.0e-5, min(eff, 1.0))


def _activ_ncloud(tt, ww, nccn, tnccn_act):
    """CCN activation, bilinear log-interp (f90:4451-4526), scalar."""
    ta_na, ta_ww, ta_tk = c.TA_NA, c.TA_WW, c.TA_TK
    ntb_arc, ntb_arw, ntb_art = c.NTB_ARC, c.NTB_ARW, c.NTB_ART
    n_local = nccn * 1.0e-6
    w_local = ww
    if n_local >= ta_na[ntb_arc - 1]:
        n_local = ta_na[ntb_arc - 1] - 1.0
    elif n_local <= ta_na[0]:
        n_local = ta_na[0] + 1.0
    i = ntb_arc - 1
    for n in range(1, ntb_arc):
        if ta_na[n - 1] <= n_local < ta_na[n]:
            i = n
            break
    x1, x2 = math.log(ta_na[i - 1]), math.log(ta_na[i])
    if w_local >= ta_ww[ntb_arw - 1]:
        w_local = ta_ww[ntb_arw - 1] - 1.0
    elif w_local <= ta_ww[0]:
        w_local = ta_ww[0] + 0.001
    j = ntb_arw - 1
    for n in range(1, ntb_arw):
        if ta_ww[n - 1] <= w_local < ta_ww[n]:
            j = n
            break
    y1, y2 = math.log(ta_ww[j - 1]), math.log(ta_ww[j])
    k = max(1, min(_nint((tt - ta_tk[0]) * 0.1) + 1, ntb_art))
    ll, m = 3, 2     # fixed radius/kappa rows (f90:4502-4503), 1-based
    a = tnccn_act[i - 1, j - 1, k - 1, ll - 1, m - 1]
    b = tnccn_act[i, j - 1, k - 1, ll - 1, m - 1]
    cc_ = tnccn_act[i, j, k - 1, ll - 1, m - 1]
    d_ = tnccn_act[i - 1, j, k - 1, ll - 1, m - 1]
    t = (math.log(n_local) - x1) / (x2 - x1)
    u = (math.log(w_local) - y1) / (y2 - y1)
    frac = ((1.0 - t) * (1.0 - u) * a + t * (1.0 - u) * b + t * u * cc_
            + (1.0 - t) * u * d_)
    return nccn * frac


def _ice_demott(tempc, qv, qvs, qvsi, rho, nifa):
    """DeMott et al. (2010) IN count (f90:4720-4756), scalar."""
    rho_not0 = 101325.0 / (287.05 * 273.15)
    nifa_cc = nifa * rho_not0 * 1.0e-6 / rho
    xni = (5.94e-5 * (-tempc) ** 3.33
           * nifa_cc ** ((-0.0264 * tempc) + 0.0033))
    xni = xni * rho / rho_not0 * 1000.0
    return max(0.0, xni)


def _ice_koop(temp, qv, qvs, naero, dt):
    """Koop et al. (2001) homogeneous freezing (f90:4764-4789), scalar."""
    satw = qv / qvs
    mu_diff = (210368.0 + 131.438 * temp - 3.32373e6 / temp
               - 41729.1 * math.log(temp))
    a_w_i = math.exp(mu_diff / (c.R_UNI * temp))
    delta_aw = satw - a_w_i
    log_j = (-906.7 + 8502.0 * delta_aw - 26924.0 * delta_aw ** 2
             + 29180.0 * delta_aw ** 3)
    j_rate = 10.0 ** min(20.0, log_j)
    prob_h = min(1.0 - math.exp(-j_rate * c.AR_VOLUME * dt), 1.0)
    xni = min(prob_h * naero, 1000.0e3) if prob_h > 0.0 else 0.0
    return max(0.0, xni)


# Fortran-style aliases for the gamma caches (1-based access preserved).
ccg, cce = c.CCG, c.CCE
ocg1, ocg2 = c.OCG1, c.OCG2
cig, cie = c.CIG, c.CIE
crg, cre = c.CRG, c.CRE
csg, cse = c.CSG, c.CSE
cgg, cge = c.CGG, c.CGE


def mp_thompson_oracle(qv1d, qc1d, qi1d, qr1d, qs1d, qg1d, ni1d, nr1d,
                       nc1d, nwfa1d, nifa1d, t1d, p1d, w1d, dzq, dt,
                       tables, *, iiwarm=False, l_sediment=True,
                       set_nc=100.0, is_aerosol_aware=False, ifdry=0,
                       dusty_ice=True, homog_ice=True):
    """One column, one timestep of mp_thompson (f90:1156-3688), fp64.

    Args mirror the Fortran dummy arguments (bottom = index 0 = kts);
    ``tables`` is the host-side ``Tables`` NamedTuple (fp64 numpy, 0-based
    storage of the Fortran tables).  Returns a dict with the updated
    prognostics plus pptrain/pptsnow/pptgraul/pptice [same units as the
    reference: m of fallen water-equivalent per rho_w scaling at kts].
    """
    nz = len(qv1d)
    kts, kte = 0, nz - 1
    Nt_c = set_nc * 1.0e6

    qv1d = np.array(qv1d, np.float64)
    qc1d = np.array(qc1d, np.float64)
    qi1d = np.array(qi1d, np.float64)
    qr1d = np.array(qr1d, np.float64)
    qs1d = np.array(qs1d, np.float64)
    qg1d = np.array(qg1d, np.float64)
    ni1d = np.array(ni1d, np.float64)
    nr1d = np.array(nr1d, np.float64)
    nc1d = np.array(nc1d, np.float64)
    nwfa1d = np.array(nwfa1d, np.float64)
    nifa1d = np.array(nifa1d, np.float64)
    t1d = np.array(t1d, np.float64)
    p1d = np.asarray(p1d, np.float64)
    dzq = np.asarray(dzq, np.float64)

    z = lambda: np.zeros(nz)
    # tendencies + process rates (f90:1282-1362)
    tten, qvten, qcten, qiten = z(), z(), z(), z()
    qrten, qsten, qgten = z(), z(), z()
    niten, nrten, ncten, nwfaten, nifaten = z(), z(), z(), z(), z()
    prw_vcd = z()
    pnc_wcd, pnc_wau, pnc_rcw, pnc_scw, pnc_gcw = z(), z(), z(), z(), z()
    pna_rca, pna_sca, pna_gca = z(), z(), z()
    pnd_rcd, pnd_scd, pnd_gcd = z(), z(), z()
    prv_rev, prr_wau, prr_rcw, prr_rcs = z(), z(), z(), z()
    prr_rcg, prr_sml, prr_gml, prr_rci = z(), z(), z(), z()
    pnr_wau, pnr_rcs, pnr_rcg, pnr_rci = z(), z(), z(), z()
    pnr_sml, pnr_gml, pnr_rev, pnr_rcr, pnr_rfz = z(), z(), z(), z(), z()
    pri_inu, pni_inu, pri_ihm, pni_ihm = z(), z(), z(), z()
    pri_wfz, pni_wfz, pri_rfz, pni_rfz = z(), z(), z(), z()
    pri_ide, pni_ide, pri_rci, pni_rci = z(), z(), z(), z()
    pni_sci, pni_iau, pri_iha, pni_iha = z(), z(), z(), z()
    prs_iau, prs_sci, prs_rcs, prs_scw = z(), z(), z(), z()
    prs_sde, prs_ihm, prs_ide = z(), z(), z()
    prg_scw, prg_rfz, prg_gde, prg_gcw = z(), z(), z(), z()
    prg_rci, prg_rcs, prg_rcg, prg_ihm = z(), z(), z(), z()
    smo0, smo1, smo2, smob = z(), z(), z(), z()
    smoc, smod, smoe, smof = z(), z(), z(), z()

    temp, pres, qv = z(), z(), z()
    rc, ri, rr, rs, rg = z(), z(), z(), z(), z()
    ni, nr, nc, nwfa, nifa = z(), z(), z(), z(), z()
    rho, rhof, rhof2 = z(), z(), z()
    qvs, qvsi, delQvs = z(), z(), z()
    satw, sati, ssatw, ssati = z(), z(), z(), z()
    diffu, visco, vsc2, tcond, lvap, ocp, lvt2 = (z(), z(), z(), z(), z(),
                                                  z(), z())
    ilamr, ilamg, N0_r, N0_g = z(), z(), z(), z()
    mvd_r, mvd_c = z(), z()
    L_qc = np.zeros(nz, bool)
    L_qi = np.zeros(nz, bool)
    L_qr = np.zeros(nz, bool)
    L_qs = np.zeros(nz, bool)
    L_qg = np.zeros(nz, bool)
    vts_boost = np.full(nz, 1.5)

    pptrain = pptsnow = pptgraul = pptice = 0.0
    no_micro = True
    odt = 1.0 / dt
    dtsave = dt
    odts = 1.0 / dtsave

    R, R1, R2, eps = c.R_GAS, c.R1, c.R2, c.EPS
    T_0 = c.T_0

    # ---- load column + presence flags + PSD clamps (f90:1387-1493) --------
    for k in range(nz):
        temp[k] = t1d[k]
        qv[k] = max(1.0e-10, qv1d[k])
        pres[k] = p1d[k]
        rho[k] = 0.622 * pres[k] / (R * temp[k] * (qv[k] + 0.622))
        nwfa[k] = max(11.1e6, min(9999.0e6, nwfa1d[k] * rho[k]))
        nifa[k] = max(c.NA_IN1 * 0.01, min(9999.0e6, nifa1d[k] * rho[k]))

        if qc1d[k] > R1:
            no_micro = False
            rc[k] = qc1d[k] * rho[k]
            nc[k] = max(2.0, nc1d[k] * rho[k])
            L_qc[k] = True
            nu_c = min(15, _nint(1000.0e6 / nc[k]) + 2)
            lamc = (nc[k] * c.AM_R * ccg[2, nu_c] * ocg1[nu_c]
                    / rc[k]) ** c.OBMR
            xDc = (c.BM_R + nu_c + 1.0) / lamc
            if xDc < c.D0C:
                lamc = cce[2, nu_c] / c.D0C
            elif xDc > c.D0R * 2.0:
                lamc = cce[2, nu_c] / (c.D0R * 2.0)
            nc[k] = min(c.NT_C_MAX, ccg[1, nu_c] * ocg2[nu_c] * rc[k]
                        / c.AM_R * lamc ** c.BM_R)
            if not is_aerosol_aware:
                nc[k] = Nt_c
        else:
            qc1d[k] = 0.0
            nc1d[k] = 0.0
            rc[k] = R1
            nc[k] = 2.0
            L_qc[k] = False

        if qi1d[k] > R1:
            no_micro = False
            ri[k] = qi1d[k] * rho[k]
            ni[k] = max(R2, ni1d[k] * rho[k])
            if ni[k] <= R2:
                lami = cie[2] / 25.0e-6
                ni[k] = min(499.0e3, cig[1] * c.OIG2 * ri[k] / c.AM_I
                            * lami ** c.BM_I)
            L_qi[k] = True
            lami = (c.AM_I * cig[2] * c.OIG1 * ni[k] / ri[k]) ** c.OBMI
            ilami = 1.0 / lami
            xDi = (c.BM_I + c.MU_I + 1.0) * ilami
            if xDi < 5.0e-6:
                lami = cie[2] / 5.0e-6
                ni[k] = min(499.0e3, cig[1] * c.OIG2 * ri[k] / c.AM_I
                            * lami ** c.BM_I)
            elif xDi > 300.0e-6:
                lami = cie[2] / 300.0e-6
                ni[k] = cig[1] * c.OIG2 * ri[k] / c.AM_I * lami ** c.BM_I
        else:
            qi1d[k] = 0.0
            ni1d[k] = 0.0
            ri[k] = R1
            ni[k] = R2
            L_qi[k] = False

        if qr1d[k] > R1:
            no_micro = False
            rr[k] = qr1d[k] * rho[k]
            nr[k] = max(R2, nr1d[k] * rho[k])
            if nr[k] <= R2:
                mvd_r[k] = 1.0e-3
                lamr = (3.0 + c.MU_R + 0.672) / mvd_r[k]
                nr[k] = crg[2] * c.ORG3 * rr[k] * lamr ** c.BM_R / c.AM_R
            L_qr[k] = True
            lamr = (c.AM_R * crg[3] * c.ORG2 * nr[k] / rr[k]) ** c.OBMR
            mvd_r[k] = (3.0 + c.MU_R + 0.672) / lamr
            if mvd_r[k] > 2.5e-3:
                mvd_r[k] = 2.5e-3
                lamr = (3.0 + c.MU_R + 0.672) / mvd_r[k]
                nr[k] = crg[2] * c.ORG3 * rr[k] * lamr ** c.BM_R / c.AM_R
            elif mvd_r[k] < c.D0R * 0.75:
                mvd_r[k] = c.D0R * 0.75
                lamr = (3.0 + c.MU_R + 0.672) / mvd_r[k]
                nr[k] = crg[2] * c.ORG3 * rr[k] * lamr ** c.BM_R / c.AM_R
        else:
            qr1d[k] = 0.0
            nr1d[k] = 0.0
            rr[k] = R1
            nr[k] = R2
            L_qr[k] = False

        if qs1d[k] > R1:
            no_micro = False
            rs[k] = qs1d[k] * rho[k]
            L_qs[k] = True
        else:
            qs1d[k] = 0.0
            rs[k] = R1
            L_qs[k] = False

        if qg1d[k] > R1:
            no_micro = False
            rg[k] = qg1d[k] * rho[k]
            L_qg[k] = True
        else:
            qg1d[k] = 0.0
            rg[k] = R1
            L_qg[k] = False

    # ---- thermodynamics (f90:1503-1533) ------------------------------------
    for k in range(nz):
        tempc = temp[k] - 273.15
        rhof[k] = math.sqrt(c.RHO_NOT / rho[k])
        rhof2[k] = math.sqrt(rhof[k])
        qvs[k] = rslf(pres[k], temp[k])
        delQvs[k] = max(0.0, rslf(pres[k], 273.15) - qv[k])
        if tempc <= 0.0:
            qvsi[k] = rsif(pres[k], temp[k])
        else:
            qvsi[k] = qvs[k]
        satw[k] = qv[k] / qvs[k]
        sati[k] = qv[k] / qvsi[k]
        ssatw[k] = satw[k] - 1.0
        ssati[k] = sati[k] - 1.0
        if abs(ssatw[k]) < eps:
            ssatw[k] = 0.0
        if abs(ssati[k]) < eps:
            ssati[k] = 0.0
        if no_micro and ssati[k] > 0.0:
            no_micro = False
        diffu[k] = 2.11e-5 * (temp[k] / 273.15) ** 1.94 * (101325.0
                                                           / pres[k])
        if tempc >= 0.0:
            visco[k] = (1.718 + 0.0049 * tempc) * 1.0e-5
        else:
            visco[k] = (1.718 + 0.0049 * tempc
                        - 1.2e-5 * tempc * tempc) * 1.0e-5
        ocp[k] = 1.0 / (c.CP * (1.0 + 0.887 * qv[k]))
        vsc2[k] = math.sqrt(rho[k] / visco[k])
        lvap[k] = c.LVAP0 + (2106.0 - 4218.0) * tempc
        tcond[k] = (5.69 + 0.0168 * tempc) * 1.0e-5 * 418.936

    out = dict(t1d=t1d, qv1d=qv1d, qc1d=qc1d, nc1d=nc1d, qi1d=qi1d,
               ni1d=ni1d, qr1d=qr1d, nr1d=nr1d, qs1d=qs1d, qg1d=qg1d,
               nwfa1d=nwfa1d, nifa1d=nifa1d, pptrain=0.0, pptsnow=0.0,
               pptgraul=0.0, pptice=0.0)
    if no_micro:  # early exit (f90:1540)
        return out

    # ---- snow moments (f90:1545-1628) --------------------------------------
    if not iiwarm:
        for k in range(nz):
            if not L_qs[k]:
                continue
            tc0 = min(-0.1, temp[k] - 273.15)
            smob[k] = rs[k] * c.OAMS
            smo2[k] = smob[k]          # bm_s == 2 (f90:1553-1554)
            a_, b_ = _field_ab(tc0, 0.0)
            smo0[k] = a_ * smo2[k] ** b_
            a_, b_ = _field_ab(tc0, 1.0)
            smo1[k] = a_ * smo2[k] ** b_
            a_, b_ = _field_ab(tc0, cse[1])
            smoc[k] = a_ * smo2[k] ** b_
            a_, b_ = _field_ab(tc0, cse[13])
            smoe[k] = a_ * smo2[k] ** b_
            a_, b_ = _field_ab(tc0, cse[16])
            smof[k] = a_ * smo2[k] ** b_

        # graupel N0/lambda, top-down running-min scan (f90:1633-1656)
        N0_min = c.GONV_MAX
        k_0 = kts
        for k in range(kte, kts - 1, -1):
            if temp[k] >= 270.65:
                k_0 = max(k_0, k)
        for k in range(kte, kts - 1, -1):
            if k > k_0 and L_qr[k] and mvd_r[k] > 100.0e-6:
                xslw1 = 4.01 + math.log10(mvd_r[k])
            else:
                xslw1 = 0.01
            ygra1 = 4.31 + math.log10(max(5.0e-5, rg[k]))
            zans1 = 3.1 + (100.0 / (300.0 * xslw1 * ygra1
                                    / (10.0 / xslw1 + 1.0 + 0.25 * ygra1)
                                    + 30.0 + 10.0 * ygra1))
            N0_exp = 10.0 ** zans1
            N0_exp = max(c.GONV_MIN, min(N0_exp, c.GONV_MAX))
            N0_min = min(N0_exp, N0_min)
            N0_exp = N0_min
            lam_exp = (N0_exp * c.AM_G * cgg[1] / rg[k]) ** c.OGE1
            lamg = lam_exp * (cgg[3] * c.OGG2 * c.OGG1) ** c.OBMG
            ilamg[k] = 1.0 / lamg
            N0_g[k] = N0_exp / (cgg[2] * lam_exp) * lamg ** cge[2]

    # ---- rain N0/lambda (f90:1661-1666) ------------------------------------
    for k in range(kte, kts - 1, -1):
        lamr = (c.AM_R * crg[3] * c.ORG2 * nr[k] / rr[k]) ** c.OBMR
        ilamr[k] = 1.0 / lamr
        mvd_r[k] = (3.0 + c.MU_R + 0.672) / lamr
        N0_r[k] = nr[k] * c.ORG2 * lamr ** cre[2]

    # ---- warm-rain process rates (f90:1676-1742) ---------------------------
    nu_c = 15
    lamc = 1.0
    xDc = 0.0
    for k in range(nz):
        if L_qr[k] and mvd_r[k] > c.D0R:
            Ef_rr = 1.0 - math.exp(min(700.0, 2300.0
                                       * (mvd_r[k] - 1950.0e-6)))
            pnr_rcr[k] = Ef_rr * 2.0 * nr[k] * rr[k]

        mvd_c[k] = c.D0C
        if L_qc[k]:
            nu_c = min(15, _nint(1000.0e6 / nc[k]) + 2)
            xDc = max(c.D0C * 1.0e6,
                      ((rc[k] / (c.AM_R * nc[k])) ** c.OBMR) * 1.0e6)
            lamc = (nc[k] * c.AM_R * ccg[2, nu_c] * ocg1[nu_c]
                    / rc[k]) ** c.OBMR
            mvd_c[k] = (3.0 + nu_c + 0.672) / lamc

        # Berry & Reinhardt autoconversion (f90:1698-1712)
        if rc[k] > 0.01e-3:
            Dc_g = ((ccg[3, nu_c] * ocg2[nu_c]) ** c.OBMR / lamc) * 1.0e6
            Dc_b = (xDc ** 3 * Dc_g ** 3 - xDc ** 6) ** (1.0 / 6.0) \
                if (xDc ** 3 * Dc_g ** 3 - xDc ** 6) > 0.0 else 0.0
            zeta1 = 0.5 * ((6.25e-6 * xDc * Dc_b ** 3 - 0.4)
                           + abs(6.25e-6 * xDc * Dc_b ** 3 - 0.4))
            zeta = 0.027 * rc[k] * zeta1
            taud = 0.5 * ((0.5 * Dc_b - 7.5) + abs(0.5 * Dc_b - 7.5)) + R1
            tau = 3.72 / (rc[k] * taud)
            prr_wau[k] = min(rc[k] * odts, zeta / tau)
            pnr_wau[k] = prr_wau[k] / (c.AM_R * nu_c * c.D0R ** 3)
            pnc_wau[k] = min(nc[k] * odts,
                             prr_wau[k] / (c.AM_R * mvd_c[k] ** 3))

        # rain collecting cloud water via t_Efrw (f90:1715-1726)
        if L_qr[k] and mvd_r[k] > c.D0R and mvd_c[k] > c.D0C:
            lamr = 1.0 / ilamr[k]
            idx = 1 + int(c.NBR * math.log(mvd_r[k] / c.DR_BINS[0])
                          / math.log(c.DR_BINS[-1] / c.DR_BINS[0]))
            idx = min(idx, c.NBR)
            Ef_rw = tables.t_efrw[idx - 1, int(mvd_c[k] * 1.0e6) - 1]
            geo = (lamr + c.FV_R) ** (-cre[9])
            prr_rcw[k] = min(rc[k] * odts,
                             rhof[k] * c.T1_QR_QC * Ef_rw * rc[k]
                             * N0_r[k] * geo)
            pnc_rcw[k] = min(nc[k] * odts,
                             rhof[k] * c.T1_QR_QC * Ef_rw * nc[k]
                             * N0_r[k] * geo)
        # rain collecting aerosols, wet scavenging (f90:1728-1740); only
        # feeds the aerosol-aware nwfa/nifa tendencies.
        if is_aerosol_aware and L_qr[k] and mvd_r[k] > c.D0R:
            lamr = 1.0 / ilamr[k]
            geo = (lamr + c.FV_R) ** (-cre[9])
            ef_ra = _eff_aero(mvd_r[k], 0.04e-6, visco[k], rho[k],
                              temp[k], "r")
            pna_rca[k] = min(nwfa[k] * odts,
                             rhof[k] * c.T1_QR_QC * ef_ra * nwfa[k]
                             * N0_r[k] * geo)
            ef_rd = _eff_aero(mvd_r[k], 0.8e-6, visco[k], rho[k],
                              temp[k], "r")
            pnd_rcd[k] = min(nifa[k] * odts,
                             rhof[k] * c.T1_QR_QC * ef_rd * nifa[k]
                             * N0_r[k] * geo)

    # ---- frozen-species process rates (f90:1749-2286) ----------------------
    if not iiwarm:
        for k in range(nz):
            vts_boost[k] = 1.5
            tempc = temp[k] - 273.15
            idx_tc = max(1, min(_nint(-tempc), 45))
            idx_t = int((tempc - 2.5) / 5.0) - 1
            idx_t = max(1, -idx_t)
            idx_t = min(idx_t, c.NTB_T)

            idx_c = (_decade_idx(rc[k], c.NIC2, c.NTB_C)
                     if rc[k] > c.R_C_AXIS[0] else 1)
            idx_i = (_decade_idx(ri[k], c.NII2, c.NTB_I)
                     if ri[k] > c.R_I_AXIS[0] else 1)
            idx_i1 = (_decade_idx(ni[k], c.NII3, c.NTB_I1)
                      if ni[k] > c.NT_I_AXIS[0] else 1)
            if rr[k] > c.R_R_AXIS[0]:
                idx_r = _decade_idx(rr[k], c.NIR2, c.NTB_R)
                lamr = 1.0 / ilamr[k]
                lam_exp = lamr * (crg[3] * c.ORG2 * c.ORG1) ** c.BM_R
                N0_exp = c.ORG1 * rr[k] / c.AM_R * lam_exp ** cre[1]
                idx_r1 = _decade_idx(N0_exp, c.NIR3, c.NTB_R1)
            else:
                idx_r = 1
                idx_r1 = c.NTB_R1
            idx_s = (_decade_idx(rs[k], c.NIS2, c.NTB_S)
                     if rs[k] > c.R_S_AXIS[0] else 1)
            if rg[k] > c.R_G_AXIS[0]:
                idx_g = _decade_idx(rg[k], c.NIG2, c.NTB_G)
                lamg = 1.0 / ilamg[k]
                lam_exp = lamg * (cgg[3] * c.OGG2 * c.OGG1) ** c.BM_G
                N0_exp = c.OGG1 * rg[k] / c.AM_G * lam_exp ** cge[1]
                idx_g1 = _decade_idx(N0_exp, c.NIG3, c.NTB_G1)
            else:
                idx_g = 1
                idx_g1 = c.NTB_G1

            # deposition/sublimation prefactor (f90:1883-1900)
            otemp = 1.0 / temp[k]
            rvs = rho[k] * qvsi[k]
            rvs_p = rvs * otemp * (c.LSUB * otemp * c.ORV - 1.0)
            rvs_pp = rvs * (otemp * (c.LSUB * otemp * c.ORV - 1.0)
                            * otemp * (c.LSUB * otemp * c.ORV - 1.0)
                            + (-2.0 * c.LSUB * otemp ** 3 * c.ORV)
                            + otemp * otemp)
            gamsc = c.LSUB * diffu[k] / tcond[k] * rvs_p
            alphsc = (0.5 * (gamsc / (1.0 + gamsc)) ** 2
                      * rvs_pp / rvs_p * rvs / rvs_p)
            alphsc = max(1.0e-9, alphsc)
            xsat = ssati[k]
            if abs(xsat) < 1.0e-9:
                xsat = 0.0
            t1_subl = (4.0 * c.PI * (1.0 - alphsc * xsat
                                     + 2.0 * alphsc ** 2 * xsat ** 2
                                     - 5.0 * alphsc ** 3 * xsat ** 3)
                       / (1.0 + gamsc))

            # snow collecting cloud water via t_Efsw (f90:1902-1935)
            if L_qc[k] and mvd_c[k] > c.D0C:
                xDs = 0.0
                if L_qs[k]:
                    xDs = smoc[k] / smob[k]
                if xDs > c.D0S:
                    idx = 1 + int(c.NBS * math.log(xDs / c.DS_BINS[0])
                                  / math.log(c.DS_BINS[-1]
                                             / c.DS_BINS[0]))
                    idx = min(idx, c.NBS)
                    Ef_sw = tables.t_efsw[idx - 1,
                                          int(mvd_c[k] * 1.0e6) - 1]
                    prs_scw[k] = (rhof[k] * c.T1_QS_QC * Ef_sw * rc[k]
                                  * smoe[k])
                    pnc_scw[k] = min(nc[k] * odts,
                                     rhof[k] * c.T1_QS_QC * Ef_sw
                                     * nc[k] * smoe[k])
                # graupel collecting cloud water (f90:1915-1935);
                # nested inside the L_qc block exactly as the reference.
                if rg[k] >= c.R_G_AXIS[0] and mvd_c[k] > c.D0C:
                    xDg = (c.BM_G + c.MU_G + 1.0) * ilamg[k]
                    vtg = (rhof[k] * c.AV_G * cgg[6] * c.OGG3
                           * ilamg[k] ** c.BV_G)
                    stoke_g = (mvd_c[k] * mvd_c[k] * vtg * c.RHO_W
                               / (9.0 * visco[k] * xDg))
                    if xDg > c.D0G:
                        if 0.4 <= stoke_g <= 10.0:
                            Ef_gw = 0.55 * math.log10(2.51 * stoke_g)
                        elif stoke_g < 0.4:
                            Ef_gw = 0.0
                        else:
                            Ef_gw = 0.77
                        prg_gcw[k] = (rhof[k] * c.T1_QG_QC * Ef_gw
                                      * rc[k] * N0_g[k]
                                      * ilamg[k] ** cge[9])
                        pnc_gcw[k] = min(nc[k] * odts,
                                         rhof[k] * c.T1_QG_QC * Ef_gw
                                         * nc[k] * N0_g[k]
                                         * ilamg[k] ** cge[9])

            # snow/graupel collecting aerosols (f90:1937-1959)
            if is_aerosol_aware:
                if rs[k] > c.R_S_AXIS[0]:
                    xDs = smoc[k] / smob[k]
                    ef_sa = _eff_aero(xDs, 0.04e-6, visco[k], rho[k],
                                      temp[k], "s")
                    pna_sca[k] = min(nwfa[k] * odts,
                                     rhof[k] * c.T1_QS_QC * ef_sa
                                     * nwfa[k] * smoe[k])
                    ef_sd = _eff_aero(xDs, 0.8e-6, visco[k], rho[k],
                                      temp[k], "s")
                    pnd_scd[k] = min(nifa[k] * odts,
                                     rhof[k] * c.T1_QS_QC * ef_sd
                                     * nifa[k] * smoe[k])
                if rg[k] > c.R_G_AXIS[0]:
                    xDg = (c.BM_G + c.MU_G + 1.0) * ilamg[k]
                    ef_ga = _eff_aero(xDg, 0.04e-6, visco[k], rho[k],
                                      temp[k], "g")
                    pna_gca[k] = min(nwfa[k] * odts,
                                     rhof[k] * c.T1_QG_QC * ef_ga
                                     * nwfa[k] * N0_g[k]
                                     * ilamg[k] ** cge[9])
                    ef_gd = _eff_aero(xDg, 0.8e-6, visco[k], rho[k],
                                      temp[k], "g")
                    pnd_gcd[k] = min(nifa[k] * odts,
                                     rhof[k] * c.T1_QG_QC * ef_gd
                                     * nifa[k] * N0_g[k]
                                     * ilamg[k] ** cge[9])

            # rain<->snow collection via tables (f90:1961-1997)
            if rr[k] >= c.R_R_AXIS[0]:
                js, jt, jr1, jr = idx_s - 1, idx_t - 1, idx_r1 - 1, \
                    idx_r - 1
                if rs[k] >= c.R_S_AXIS[0]:
                    if temp[k] < T_0:
                        prr_rcs[k] = -(tables.tmr_racs2[js, jt, jr1, jr]
                                       + tables.tcr_sacr2[js, jt, jr1, jr]
                                       + tables.tmr_racs1[js, jt, jr1, jr]
                                       + tables.tcr_sacr1[js, jt, jr1,
                                                          jr])
                        prs_rcs[k] = (tables.tmr_racs2[js, jt, jr1, jr]
                                      + tables.tcr_sacr2[js, jt, jr1, jr]
                                      - tables.tcs_racs1[js, jt, jr1, jr]
                                      - tables.tms_sacr1[js, jt, jr1, jr])
                        prg_rcs[k] = (tables.tmr_racs1[js, jt, jr1, jr]
                                      + tables.tcr_sacr1[js, jt, jr1, jr]
                                      + tables.tcs_racs1[js, jt, jr1, jr]
                                      + tables.tms_sacr1[js, jt, jr1, jr])
                        prr_rcs[k] = max(-rr[k] * odts, prr_rcs[k])
                        prs_rcs[k] = max(-rs[k] * odts, prs_rcs[k])
                        prg_rcs[k] = min((rr[k] + rs[k]) * odts,
                                         prg_rcs[k])
                        pnr_rcs[k] = (tables.tnr_racs1[js, jt, jr1, jr]
                                      + tables.tnr_racs2[js, jt, jr1, jr]
                                      + tables.tnr_sacr1[js, jt, jr1, jr]
                                      + tables.tnr_sacr2[js, jt, jr1, jr])
                    else:
                        prs_rcs[k] = (-tables.tcs_racs1[js, jt, jr1, jr]
                                      - tables.tms_sacr1[js, jt, jr1, jr]
                                      + tables.tmr_racs2[js, jt, jr1, jr]
                                      + tables.tcr_sacr2[js, jt, jr1, jr])
                        prs_rcs[k] = max(-rs[k] * odts, prs_rcs[k])
                        prr_rcs[k] = -prs_rcs[k]
                        pnr_rcs[k] = (tables.tnr_racs2[js, jt, jr1, jr]
                                      + tables.tnr_sacr2[js, jt, jr1, jr])
                    pnr_rcs[k] = min(nr[k] * odts, pnr_rcs[k])

                # rain<->graupel collection via tables (f90:1999-2018)
                if rg[k] >= c.R_G_AXIS[0]:
                    jg1, jg = idx_g1 - 1, idx_g - 1
                    if temp[k] < T_0:
                        prg_rcg[k] = (tables.tmr_racg[jg1, jg, jr1, jr]
                                      + tables.tcr_gacr[jg1, jg, jr1, jr])
                        prg_rcg[k] = min(rr[k] * odts, prg_rcg[k])
                        prr_rcg[k] = -prg_rcg[k]
                        pnr_rcg[k] = (tables.tnr_racg[jg1, jg, jr1, jr]
                                      + tables.tnr_gacr[jg1, jg, jr1, jr])
                        pnr_rcg[k] = min(nr[k] * odts, pnr_rcg[k])
                    else:
                        prr_rcg[k] = tables.tcg_racg[jg1, jg, jr1, jr]
                        prr_rcg[k] = min(rg[k] * odts, prr_rcg[k])
                        prg_rcg[k] = -prr_rcg[k]
                        pnr_rcg[k] = -5.0 * tables.tnr_gacr[jg1, jg, jr1,
                                                            jr]

            # ------------- processes only below 0 C (f90:2025-2281) ---------
            if temp[k] < T_0:
                vts_boost[k] = 1.0
                rate_max = (qv[k] - qvsi[k]) * rho[k] * odts * 0.999

                # Bigg freezing of rain (f90:2065-2076)
                jr, jr1, jtc = idx_r - 1, idx_r1 - 1, idx_tc - 1
                if rr[k] > c.R_R_AXIS[0]:
                    prg_rfz[k] = tables.tpg_qrfz[jr, jr1, jtc] * odts
                    pri_rfz[k] = tables.tpi_qrfz[jr, jr1, jtc] * odts
                    pni_rfz[k] = tables.tni_qrfz[jr, jr1, jtc] * odts
                    pnr_rfz[k] = min(nr[k] * odts,
                                     tables.tnr_qrfz[jr, jr1, jtc] * odts)
                elif rr[k] > R1 and temp[k] < c.HGFR:
                    pri_rfz[k] = rr[k] * odts
                    pnr_rfz[k] = nr[k] * odts
                    pni_rfz[k] = pnr_rfz[k]

                # Bigg freezing of cloud water (f90:2077-2086)
                if rc[k] > c.R_C_AXIS[0]:
                    jc = idx_c - 1
                    pri_wfz[k] = min(rc[k] * odts,
                                     tables.tpi_qcfz[jc, jtc] * odts)
                    pni_wfz[k] = min(Nt_c * odts,
                                     pri_wfz[k] / (2.0 * c.XM0I),
                                     tables.tni_qcfz[jc, jtc] * odts)
                elif rc[k] > R1 and temp[k] < c.HGFR:
                    pri_wfz[k] = rc[k] * odts
                    pni_wfz[k] = nc[k] * odts

                # deposition-condensation nucleation, Cooper (f90:2088-2101)
                if ssati[k] >= 0.25 or (ssatw[k] > eps
                                        and temp[k] < 253.15):
                    if dusty_ice and is_aerosol_aware:
                        xnc = _ice_demott(tempc, qv[k], qvs[k], qvsi[k],
                                          rho[k], nifa[k])
                    else:
                        xnc = min(250.0e3,
                                  c.TNO * math.exp(c.ATO
                                                   * (T_0 - temp[k])))
                    xni = ni[k] + (pni_rfz[k] + pni_wfz[k]) * dtsave
                    pni_inu[k] = 0.5 * (xnc - xni
                                        + abs(xnc - xni)) * odts
                    pri_inu[k] = min(rate_max, c.XM0I * pni_inu[k])
                    pni_inu[k] = pri_inu[k] / c.XM0I

                # Koop homogeneous freezing of aqueous aerosols
                # (f90:2103-2111)
                xni = (smo0[k] + ni[k] + (pni_rfz[k] + pni_wfz[k]
                                          + pni_inu[k]) * dtsave)
                if (is_aerosol_aware and homog_ice and xni <= 500.0e3
                        and temp[k] < 238.0 and ssati[k] >= 0.4):
                    xnc = _ice_koop(temp[k], qv[k], qvs[k], nwfa[k],
                                    dtsave)
                    pni_iha[k] = xnc * odts
                    pri_iha[k] = min(rate_max,
                                     c.XM0I * 0.1 * pni_iha[k])
                    pni_iha[k] = pri_iha[k] / (c.XM0I * 0.1)

                # cloud-ice deposition/sublimation (f90:2115-2148)
                if L_qi[k]:
                    lami = (c.AM_I * cig[2] * c.OIG1 * ni[k]
                            / ri[k]) ** c.OBMI
                    ilami = 1.0 / lami
                    xDi = max(c.D0I, (c.BM_I + c.MU_I + 1.0) * ilami)
                    xmi = c.AM_I * xDi ** c.BM_I
                    oxmi = 1.0 / xmi
                    pri_ide[k] = (c.C_CUBE * t1_subl * diffu[k]
                                  * ssati[k] * rvs * c.OIG1 * cig[5]
                                  * ni[k] * ilami)
                    if pri_ide[k] < 0.0:
                        pri_ide[k] = max(-ri[k] * odts, pri_ide[k],
                                         rate_max)
                        pni_ide[k] = pri_ide[k] * oxmi
                        pni_ide[k] = max(-ni[k] * odts, pni_ide[k])
                    else:
                        pri_ide[k] = min(pri_ide[k], rate_max)
                        tide = tables.tpi_ide[idx_i - 1, idx_i1 - 1]
                        prs_ide[k] = (1.0 - tide) * pri_ide[k]
                        pri_ide[k] = tide * pri_ide[k]

                    # ice -> snow autoconversion (f90:2135-2148)
                    if idx_i == c.NTB_I or xDi > 5.0 * c.D0S:
                        prs_iau[k] = ri[k] * 0.99 * odts
                        pni_iau[k] = ni[k] * 0.95 * odts
                    elif xDi < 0.1 * c.D0S:
                        prs_iau[k] = 0.0
                        pni_iau[k] = 0.0
                    else:
                        prs_iau[k] = min(ri[k] * 0.99 * odts,
                                         tables.tps_iaus[idx_i - 1,
                                                         idx_i1 - 1]
                                         * odts)
                        pni_iau[k] = min(ni[k] * 0.95 * odts,
                                         tables.tni_iaus[idx_i - 1,
                                                         idx_i1 - 1]
                                         * odts)

                # snow / graupel deposition-sublimation (f90:2151-2175)
                if L_qs[k]:
                    C_snow = (c.C_SQRD + (tempc + 1.5)
                              * (c.C_CUBE - c.C_SQRD) / (-30.0 + 1.5))
                    C_snow = max(c.C_SQRD, min(C_snow, c.C_CUBE))
                    prs_sde[k] = (C_snow * t1_subl * diffu[k] * ssati[k]
                                  * rvs * (c.T1_QS_SD * smo1[k]
                                           + c.T2_QS_SD * rhof2[k]
                                           * vsc2[k] * smof[k]))
                    if prs_sde[k] < 0.0:
                        prs_sde[k] = max(-rs[k] * odts, prs_sde[k],
                                         rate_max)
                    else:
                        prs_sde[k] = min(prs_sde[k], rate_max)

                if L_qg[k] and ssati[k] < -eps:
                    prg_gde[k] = (c.C_CUBE * t1_subl * diffu[k]
                                  * ssati[k] * rvs * N0_g[k]
                                  * (c.T1_QG_SD * ilamg[k] ** cge[10]
                                     + c.T2_QG_SD * vsc2[k] * rhof2[k]
                                     * ilamg[k] ** cge[11]))
                    if prg_gde[k] < 0.0:
                        prg_gde[k] = max(-rg[k] * odts, prg_gde[k],
                                         rate_max)
                    else:
                        prg_gde[k] = min(prg_gde[k], rate_max)

                # snow/rain collecting cloud ice (f90:2177-2201)
                if L_qi[k]:
                    lami = (c.AM_I * cig[2] * c.OIG1 * ni[k]
                            / ri[k]) ** c.OBMI
                    ilami = 1.0 / lami
                    xDi = max(c.D0I, (c.BM_I + c.MU_I + 1.0) * ilami)
                    xmi = c.AM_I * xDi ** c.BM_I
                    oxmi = 1.0 / xmi
                    if rs[k] >= c.R_S_AXIS[0]:
                        prs_sci[k] = (c.T1_QS_QI * rhof[k] * c.EF_SI
                                      * ri[k] * smoe[k])
                        pni_sci[k] = prs_sci[k] * oxmi
                    if rr[k] >= c.R_R_AXIS[0] and mvd_r[k] > 4.0 * xDi:
                        lamr = 1.0 / ilamr[k]
                        geo9 = (lamr + c.FV_R) ** (-cre[9])
                        pri_rci[k] = (rhof[k] * c.T1_QR_QI * c.EF_RI
                                      * ri[k] * N0_r[k] * geo9)
                        pnr_rci[k] = (rhof[k] * c.T1_QR_QI * c.EF_RI
                                      * ni[k] * N0_r[k] * geo9)
                        pni_rci[k] = pri_rci[k] * oxmi
                        prr_rci[k] = (rhof[k] * c.T2_QR_QI * c.EF_RI
                                      * ni[k] * N0_r[k]
                                      * (lamr + c.FV_R) ** (-cre[8]))
                        prr_rci[k] = min(rr[k] * odts, prr_rci[k])
                        prg_rci[k] = pri_rci[k] + prr_rci[k]

                # Hallett-Mossop rime splintering (f90:2204-2218)
                if prg_gcw[k] > eps and tempc > -8.0:
                    tf = 0.0
                    if -5.0 <= tempc < -3.0:
                        tf = 0.5 * (-3.0 - tempc)
                    elif -8.0 < tempc < -5.0:
                        tf = 0.33333333 * (8.0 + tempc)
                    pni_ihm[k] = 3.5e8 * tf * prg_gcw[k]
                    pri_ihm[k] = c.XM0I * pni_ihm[k]
                    prs_ihm[k] = (prs_scw[k] / (prs_scw[k] + prg_gcw[k])
                                  * pri_ihm[k])
                    prg_ihm[k] = (prg_gcw[k] / (prs_scw[k] + prg_gcw[k])
                                  * pri_ihm[k])

                # rimed snow -> graupel split + boost (f90:2220-2231)
                if prs_scw[k] > 2.0 * prs_sde[k] and prs_sde[k] > eps:
                    r_frac = min(30.0, prs_scw[k] / prs_sde[k])
                    g_frac = min(0.95, 0.15 + (r_frac - 2.0) * 0.028)
                    vts_boost[k] = min(1.5, 1.1 + (r_frac - 2.0) * 0.016)
                    prg_scw[k] = g_frac * prs_scw[k]
                    prs_scw[k] = (1.0 - g_frac) * prs_scw[k]

            else:
                # ------------- melting branch, T >= T_0 (f90:2235-2281) -----
                if L_qs[k]:
                    prr_sml[k] = ((tempc * tcond[k] - c.LVAP0 * diffu[k]
                                   * delQvs[k])
                                  * (c.T1_QS_ME * smo1[k] + c.T2_QS_ME
                                     * rhof2[k] * vsc2[k] * smof[k]))
                    prr_sml[k] = (prr_sml[k] + 4218.0 * c.OLFUS * tempc
                                  * (prr_rcs[k] + prs_scw[k]))
                    prr_sml[k] = min(rs[k] * odts, max(0.0, prr_sml[k]))
                    pnr_sml[k] = (smo0[k] / rs[k] * prr_sml[k]
                                  * 10.0 ** (-0.25 * tempc))
                    pnr_sml[k] = min(smo0[k] * odts, pnr_sml[k])
                    if ssati[k] < 0.0:
                        prs_sde[k] = (c.C_CUBE * t1_subl * diffu[k]
                                      * ssati[k] * rvs
                                      * (c.T1_QS_SD * smo1[k]
                                         + c.T2_QS_SD * rhof2[k]
                                         * vsc2[k] * smof[k]))
                        prs_sde[k] = max(-rs[k] * odts, prs_sde[k])

                if L_qg[k]:
                    prr_gml[k] = ((tempc * tcond[k] - c.LVAP0 * diffu[k]
                                   * delQvs[k]) * N0_g[k]
                                  * (c.T1_QG_ME * ilamg[k] ** cge[10]
                                     + c.T2_QG_ME * rhof2[k] * vsc2[k]
                                     * ilamg[k] ** cge[11]))
                    prr_gml[k] = min(rg[k] * odts, max(0.0, prr_gml[k]))
                    pnr_gml[k] = (N0_g[k] * cgg[2] * ilamg[k] ** cge[2]
                                  / rg[k] * prr_gml[k]
                                  * 10.0 ** (-0.5 * tempc))
                    if ssati[k] < 0.0:
                        prg_gde[k] = (c.C_CUBE * t1_subl * diffu[k]
                                      * ssati[k] * rvs * N0_g[k]
                                      * (c.T1_QG_SD * ilamg[k] ** cge[10]
                                         + c.T2_QG_SD * vsc2[k]
                                         * rhof2[k]
                                         * ilamg[k] ** cge[11]))
                        prg_gde[k] = max(-rg[k] * odts, prg_gde[k])

                # long-timestep riming reroute (f90:2277-2281)
                if dt > 120.0:
                    prr_rcw[k] = prr_rcw[k] + prs_scw[k] + prg_gcw[k]
                    prs_scw[k] = 0.0
                    prg_gcw[k] = 0.0

    # ---- conservation ratio-clamps (f90:2291-2387) --------------------------
    for k in range(nz):
        sump = (pri_inu[k] + pri_ide[k] + prs_ide[k] + prs_sde[k]
                + prg_gde[k] + pri_iha[k])
        rate_max = (qv[k] - qvsi[k]) * odts * 0.999
        if ((sump > eps and sump > rate_max)
                or (sump < -eps and sump < rate_max)):
            ratio = rate_max / sump
            pri_inu[k] *= ratio
            pri_ide[k] *= ratio
            pni_ide[k] *= ratio
            prs_ide[k] *= ratio
            prs_sde[k] *= ratio
            prg_gde[k] *= ratio
            pri_iha[k] *= ratio

        sump = (-prr_wau[k] - pri_wfz[k] - prr_rcw[k] - prs_scw[k]
                - prg_scw[k] - prg_gcw[k])
        rate_max = -rc[k] * odts
        if sump < rate_max and L_qc[k]:
            ratio = rate_max / sump
            prr_wau[k] *= ratio
            pri_wfz[k] *= ratio
            prr_rcw[k] *= ratio
            prs_scw[k] *= ratio
            prg_scw[k] *= ratio
            prg_gcw[k] *= ratio

        sump = pri_ide[k] - prs_iau[k] - prs_sci[k] - pri_rci[k]
        rate_max = -ri[k] * odts
        if sump < rate_max and L_qi[k]:
            ratio = rate_max / sump
            pri_ide[k] *= ratio
            prs_iau[k] *= ratio
            prs_sci[k] *= ratio
            pri_rci[k] *= ratio

        sump = (-prg_rfz[k] - pri_rfz[k] - prr_rci[k] + prr_rcs[k]
                + prr_rcg[k])
        rate_max = -rr[k] * odts
        if sump < rate_max and L_qr[k]:
            ratio = rate_max / sump
            prg_rfz[k] *= ratio
            pri_rfz[k] *= ratio
            prr_rci[k] *= ratio
            prr_rcs[k] *= ratio
            prr_rcg[k] *= ratio

        sump = prs_sde[k] - prs_ihm[k] - prr_sml[k] + prs_rcs[k]
        rate_max = -rs[k] * odts
        if sump < rate_max and L_qs[k]:
            ratio = rate_max / sump
            prs_sde[k] *= ratio
            prs_ihm[k] *= ratio
            prr_sml[k] *= ratio
            prs_rcs[k] *= ratio

        sump = prg_gde[k] - prg_ihm[k] - prr_gml[k] + prg_rcg[k]
        rate_max = -rg[k] * odts
        if sump < rate_max and L_qg[k]:
            ratio = rate_max / sump
            prg_gde[k] *= ratio
            prg_ihm[k] *= ratio
            prr_gml[k] *= ratio
            prg_rcg[k] *= ratio

        # symmetry re-enforcement (f90:2375-2385)
        pri_ihm[k] = prs_ihm[k] + prg_ihm[k]
        ratio = min(abs(prr_rcg[k]), abs(prg_rcg[k]))
        prr_rcg[k] = ratio * math.copysign(1.0, prr_rcg[k])
        prg_rcg[k] = -prr_rcg[k]
        if temp[k] > T_0:
            ratio = min(abs(prr_rcs[k]), abs(prs_rcs[k]))
            prr_rcs[k] = ratio * math.copysign(1.0, prr_rcs[k])
            prs_rcs[k] = -prr_rcs[k]

    # ---- tendency assembly + number clamps (f90:2393-2569) ------------------
    for k in range(nz):
        orho = 1.0 / rho[k]
        lfus2 = c.LSUB - lvap[k]
        # aerosol number tendencies (f90:2398-2408)
        if is_aerosol_aware:
            nwfaten[k] -= (pna_rca[k] + pna_sca[k] + pna_gca[k]
                           + pni_iha[k]) * orho
            nifaten[k] -= (pnd_rcd[k] + pnd_scd[k] + pnd_gcd[k]) * orho
            if dusty_ice:
                nifaten[k] -= pni_inu[k] * orho
            else:
                nifaten[k] = 0.0

        qvten[k] += (-pri_inu[k] - pri_iha[k] - pri_ide[k] - prs_ide[k]
                     - prs_sde[k] - prg_gde[k]) * orho
        qcten[k] += (-prr_wau[k] - pri_wfz[k] - prr_rcw[k] - prs_scw[k]
                     - prg_scw[k] - prg_gcw[k]) * orho
        ncten[k] += (-pnc_wau[k] - pnc_rcw[k] - pni_wfz[k] - pnc_scw[k]
                     - pnc_gcw[k]) * orho

        # cloud mass/number balance (f90:2428-2448); the reference divides
        # by the OLD rc(k) at :2432 — reproduced.
        xrc = max(R1, (qc1d[k] + qcten[k] * dtsave) * rho[k])
        xnc = max(2.0, (nc1d[k] + ncten[k] * dtsave) * rho[k])
        if xrc > R1:
            nu_c = min(15, _nint(1000.0e6 / xnc) + 2)
            lamc = (xnc * c.AM_R * ccg[2, nu_c] * ocg1[nu_c]
                    / rc[k]) ** c.OBMR
            xDc = (c.BM_R + nu_c + 1.0) / lamc
            if xDc < c.D0C:
                lamc = cce[2, nu_c] / c.D0C
                xnc = (ccg[1, nu_c] * ocg2[nu_c] * xrc / c.AM_R
                       * lamc ** c.BM_R)
                ncten[k] = (xnc - nc1d[k] * rho[k]) * odts * orho
            elif xDc > c.D0R * 2.0:
                lamc = cce[2, nu_c] / (c.D0R * 2.0)
                xnc = (ccg[1, nu_c] * ocg2[nu_c] * xrc / c.AM_R
                       * lamc ** c.BM_R)
                ncten[k] = (xnc - nc1d[k] * rho[k]) * odts * orho
        else:
            ncten[k] = -nc1d[k] * odts
        xnc = max(0.0, (nc1d[k] + ncten[k] * dtsave) * rho[k])
        if xnc > c.NT_C_MAX:
            ncten[k] = (c.NT_C_MAX - nc1d[k] * rho[k]) * odts * orho

        qiten[k] += (pri_inu[k] + pri_iha[k] + pri_ihm[k] + pri_wfz[k]
                     + pri_rfz[k] + pri_ide[k] - prs_iau[k] - prs_sci[k]
                     - pri_rci[k]) * orho
        niten[k] += (pni_inu[k] + pni_iha[k] + pni_ihm[k] + pni_wfz[k]
                     + pni_rfz[k] + pni_ide[k] - pni_iau[k] - pni_sci[k]
                     - pni_rci[k]) * orho

        # ice mass/number balance (f90:2464-2484)
        xri = max(R1, (qi1d[k] + qiten[k] * dtsave) * rho[k])
        xni = max(R2, (ni1d[k] + niten[k] * dtsave) * rho[k])
        if xri > R1:
            lami = (c.AM_I * cig[2] * c.OIG1 * xni / xri) ** c.OBMI
            xDi = (c.BM_I + c.MU_I + 1.0) / lami
            if xDi < 5.0e-6:
                lami = cie[2] / 5.0e-6
                xni = min(499.0e3, cig[1] * c.OIG2 * xri / c.AM_I
                          * lami ** c.BM_I)
                niten[k] = (xni - ni1d[k] * rho[k]) * odts * orho
            elif xDi > 300.0e-6:
                lami = cie[2] / 300.0e-6
                xni = cig[1] * c.OIG2 * xri / c.AM_I * lami ** c.BM_I
                niten[k] = (xni - ni1d[k] * rho[k]) * odts * orho
        else:
            niten[k] = -ni1d[k] * odts
        xni = max(0.0, (ni1d[k] + niten[k] * dtsave) * rho[k])
        if xni > 499.0e3:
            niten[k] = (499.0e3 - ni1d[k] * rho[k]) * odts * orho

        qrten[k] += (prr_wau[k] + prr_rcw[k] + prr_sml[k] + prr_gml[k]
                     + prr_rcs[k] + prr_rcg[k] - prg_rfz[k] - pri_rfz[k]
                     - prr_rci[k]) * orho
        nrten[k] += (pnr_wau[k] + pnr_sml[k] + pnr_gml[k]
                     - (pnr_rfz[k] + pnr_rcr[k] + pnr_rcg[k]
                        + pnr_rcs[k] + pnr_rci[k])) * orho

        # rain mass/number balance (f90:2515-2534)
        xrr = max(R1, (qr1d[k] + qrten[k] * dtsave) * rho[k])
        xnr = max(R2, (nr1d[k] + nrten[k] * dtsave) * rho[k])
        if xrr > R1:
            lamr = (c.AM_R * crg[3] * c.ORG2 * xnr / xrr) ** c.OBMR
            mvd_r[k] = (3.0 + c.MU_R + 0.672) / lamr
            if mvd_r[k] > 2.5e-3:
                mvd_r[k] = 2.5e-3
                lamr = (3.0 + c.MU_R + 0.672) / mvd_r[k]
                xnr = crg[2] * c.ORG3 * xrr * lamr ** c.BM_R / c.AM_R
                nrten[k] = (xnr - nr1d[k] * rho[k]) * odts * orho
            elif mvd_r[k] < c.D0R * 0.75:
                mvd_r[k] = c.D0R * 0.75
                lamr = (3.0 + c.MU_R + 0.672) / mvd_r[k]
                xnr = crg[2] * c.ORG3 * xrr * lamr ** c.BM_R / c.AM_R
                nrten[k] = (xnr - nr1d[k] * rho[k]) * odts * orho
        else:
            qrten[k] = -qr1d[k] * odts
            nrten[k] = -nr1d[k] * odts

        qsten[k] += (prs_iau[k] + prs_sde[k] + prs_sci[k] + prs_scw[k]
                     + prs_rcs[k] + prs_ide[k] - prs_ihm[k]
                     - prr_sml[k]) * orho
        qgten[k] += (prg_scw[k] + prg_rfz[k] + prg_gde[k] + prg_rcg[k]
                     + prg_gcw[k] + prg_rci[k] + prg_rcs[k] - prg_ihm[k]
                     - prr_gml[k]) * orho

        # temperature tendency (f90:2550-2567)
        if temp[k] < T_0:
            tten[k] += (c.LSUB * ocp[k] * (pri_inu[k] + pri_ide[k]
                                           + prs_ide[k] + prs_sde[k]
                                           + prg_gde[k] + pri_iha[k])
                        + lfus2 * ocp[k] * (pri_wfz[k] + pri_rfz[k]
                                            + prg_rfz[k] + prs_scw[k]
                                            + prg_scw[k] + prg_gcw[k]
                                            + prg_rcs[k] + prs_rcs[k]
                                            + prr_rci[k] + prg_rcg[k])
                        ) * orho * (1 - ifdry)
        else:
            tten[k] += (c.LFUS * ocp[k] * (-prr_sml[k] - prr_gml[k]
                                           - prr_rcg[k] - prr_rcs[k])
                        + c.LSUB * ocp[k] * (prs_sde[k] + prg_gde[k])
                        ) * orho * (1 - ifdry)

    # ---- provisional state at t+dt (f90:2574-2656) --------------------------
    for k in range(nz):
        temp[k] = t1d[k] + dt * tten[k]
        otemp = 1.0 / temp[k]
        tempc = temp[k] - 273.15
        qv[k] = max(1.0e-10, qv1d[k] + dt * qvten[k])
        rho[k] = 0.622 * pres[k] / (R * temp[k] * (qv[k] + 0.622))
        rhof[k] = math.sqrt(c.RHO_NOT / rho[k])
        rhof2[k] = math.sqrt(rhof[k])
        qvs[k] = rslf(pres[k], temp[k])
        ssatw[k] = qv[k] / qvs[k] - 1.0
        if abs(ssatw[k]) < eps:
            ssatw[k] = 0.0
        diffu[k] = 2.11e-5 * (temp[k] / 273.15) ** 1.94 * (101325.0
                                                           / pres[k])
        if tempc >= 0.0:
            visco[k] = (1.718 + 0.0049 * tempc) * 1.0e-5
        else:
            visco[k] = (1.718 + 0.0049 * tempc
                        - 1.2e-5 * tempc * tempc) * 1.0e-5
        vsc2[k] = math.sqrt(rho[k] / visco[k])
        lvap[k] = c.LVAP0 + (2106.0 - 4218.0) * tempc
        tcond[k] = (5.69 + 0.0168 * tempc) * 1.0e-5 * 418.936
        ocp[k] = 1.0 / (c.CP * (1.0 + 0.887 * qv[k]))
        lvt2[k] = lvap[k] * lvap[k] * ocp[k] * c.ORV * otemp * otemp

        nwfa[k] = max(11.1e6, (nwfa1d[k] + nwfaten[k] * dt) * rho[k])

        if (qc1d[k] + qcten[k] * dt) > R1:
            rc[k] = (qc1d[k] + qcten[k] * dt) * rho[k]
            nc[k] = max(2.0, (nc1d[k] + ncten[k] * dt) * rho[k])
            if not is_aerosol_aware:
                nc[k] = Nt_c
            L_qc[k] = True
        else:
            rc[k] = R1
            nc[k] = 2.0
            L_qc[k] = False

        if (qi1d[k] + qiten[k] * dt) > R1:
            ri[k] = (qi1d[k] + qiten[k] * dt) * rho[k]
            ni[k] = max(R2, (ni1d[k] + niten[k] * dt) * rho[k])
            L_qi[k] = True
        else:
            ri[k] = R1
            ni[k] = R2
            L_qi[k] = False

        if (qr1d[k] + qrten[k] * dt) > R1:
            rr[k] = (qr1d[k] + qrten[k] * dt) * rho[k]
            nr[k] = max(R2, (nr1d[k] + nrten[k] * dt) * rho[k])
            L_qr[k] = True
            lamr = (c.AM_R * crg[3] * c.ORG2 * nr[k] / rr[k]) ** c.OBMR
            mvd_r[k] = (3.0 + c.MU_R + 0.672) / lamr
            if mvd_r[k] > 2.5e-3:
                mvd_r[k] = 2.5e-3
                lamr = (3.0 + c.MU_R + 0.672) / mvd_r[k]
                nr[k] = crg[2] * c.ORG3 * rr[k] * lamr ** c.BM_R / c.AM_R
            elif mvd_r[k] < c.D0R * 0.75:
                mvd_r[k] = c.D0R * 0.75
                lamr = (3.0 + c.MU_R + 0.672) / mvd_r[k]
                nr[k] = crg[2] * c.ORG3 * rr[k] * lamr ** c.BM_R / c.AM_R
        else:
            rr[k] = R1
            nr[k] = R2
            L_qr[k] = False

        if (qs1d[k] + qsten[k] * dt) > R1:
            rs[k] = (qs1d[k] + qsten[k] * dt) * rho[k]
            L_qs[k] = True
        else:
            rs[k] = R1
            L_qs[k] = False

        if (qg1d[k] + qgten[k] * dt) > R1:
            rg[k] = (qg1d[k] + qgten[k] * dt) * rho[k]
            L_qg[k] = True
        else:
            rg[k] = R1
            L_qg[k] = False

    # ---- recompute snow moments / graupel / rain PSD (f90:2662-2750) -------
    if not iiwarm:
        for k in range(nz):
            if not L_qs[k]:
                continue
            tc0 = min(-0.1, temp[k] - 273.15)
            smob[k] = rs[k] * c.OAMS
            smo2[k] = smob[k]
            a_, b_ = _field_ab(tc0, cse[1])
            smoc[k] = a_ * smo2[k] ** b_
            a_, b_ = _field_ab(tc0, cse[14])
            smod[k] = a_ * smo2[k] ** b_

        N0_min = c.GONV_MAX
        k_0 = kts
        for k in range(kte, kts - 1, -1):
            if temp[k] >= 270.65:
                k_0 = max(k_0, k)
        for k in range(kte, kts - 1, -1):
            if k > k_0 and L_qr[k] and mvd_r[k] > 100.0e-6:
                xslw1 = 4.01 + math.log10(mvd_r[k])
            else:
                xslw1 = 0.01
            ygra1 = 4.31 + math.log10(max(5.0e-5, rg[k]))
            zans1 = 3.1 + (100.0 / (300.0 * xslw1 * ygra1
                                    / (10.0 / xslw1 + 1.0 + 0.25 * ygra1)
                                    + 30.0 + 10.0 * ygra1))
            N0_exp = 10.0 ** zans1
            N0_exp = max(c.GONV_MIN, min(N0_exp, c.GONV_MAX))
            N0_min = min(N0_exp, N0_min)
            N0_exp = N0_min
            lam_exp = (N0_exp * c.AM_G * cgg[1] / rg[k]) ** c.OGE1
            lamg = lam_exp * (cgg[3] * c.OGG2 * c.OGG1) ** c.OBMG
            ilamg[k] = 1.0 / lamg
            N0_g[k] = N0_exp / (cgg[2] * lam_exp) * lamg ** cge[2]

    for k in range(kte, kts - 1, -1):
        lamr = (c.AM_R * crg[3] * c.ORG2 * nr[k] / rr[k]) ** c.OBMR
        ilamr[k] = 1.0 / lamr
        mvd_r[k] = (3.0 + c.MU_R + 0.672) / lamr
        N0_r[k] = nr[k] * c.ORG2 * lamr ** cre[2]

    # ---- saturation adjustment + droplet nucleation (f90:2780-2874) --------
    for k in range(nz):
        orho = 1.0 / rho[k]
        if (ssatw[k] > eps) or (ssatw[k] < -eps and L_qc[k]):
            clap = (qv[k] - qvs[k]) / (1.0 + lvt2[k] * qvs[k])
            for _ in range(3):
                fcd = qvs[k] * math.exp(lvt2[k] * clap) - qv[k] + clap
                dfcd = qvs[k] * lvt2[k] * math.exp(lvt2[k] * clap) + 1.0
                clap = clap - fcd / dfcd
            xrc = rc[k] + clap * rho[k]
            if xrc > R1:
                prw_vcd[k] = clap * odt
                if clap > eps:
                    if is_aerosol_aware:
                        xnc = max(2.0, _activ_ncloud(temp[k], w1d[k],
                                                     nwfa[k],
                                                     tables.tnccn_act))
                    else:
                        xnc = Nt_c          # f90:2795-2801
                    pnc_wcd[k] = (0.5 * (xnc - nc[k] + abs(xnc - nc[k]))
                                  * odts * orho)
                elif (clap < -eps and ssatw[k] < -1.0e-6
                      and is_aerosol_aware):
                    # evaporate drops smaller than Dc_star via tnc_wev
                    # (f90:2804-2851)
                    tempc = temp[k] - 273.15
                    otemp = 1.0 / temp[k]
                    rvs = rho[k] * qvs[k]
                    rvs_p = rvs * otemp * (lvap[k] * otemp * c.ORV - 1.0)
                    rvs_pp = rvs * (otemp * (lvap[k] * otemp * c.ORV
                                             - 1.0)
                                    * otemp * (lvap[k] * otemp * c.ORV
                                               - 1.0)
                                    + (-2.0 * lvap[k] * otemp ** 3
                                       * c.ORV) + otemp * otemp)
                    gamsc = lvap[k] * diffu[k] / tcond[k] * rvs_p
                    alphsc = (0.5 * (gamsc / (1.0 + gamsc)) ** 2
                              * rvs_pp / rvs_p * rvs / rvs_p)
                    alphsc = max(1.0e-9, alphsc)
                    xsat = ssatw[k]
                    if abs(xsat) < 1.0e-9:
                        xsat = 0.0
                    t1_evap = (2.0 * c.PI
                               * (1.0 - alphsc * xsat
                                  + 2.0 * alphsc ** 2 * xsat ** 2
                                  - 5.0 * alphsc ** 3 * xsat ** 3)
                               / (1.0 + gamsc))
                    dc_star = math.sqrt(
                        -2.0 * dt * t1_evap / (2.0 * c.PI) * 4.0
                        * diffu[k] * ssatw[k] * rvs / c.RHO_W)
                    idx_d = max(1, min(int(1.0e6 * dc_star), c.NBC))
                    idx_n = _nint(1.0 + float(c.NBC)
                                  * math.log(nc[k] / c.T_NC[0])
                                  / c.NIC1)
                    idx_n = max(1, min(idx_n, c.NBC))
                    idx_c = (_decade_idx(rc[k], c.NIC2, c.NTB_C)
                             if rc[k] > c.R_C_AXIS[0] else 1)
                    prw_vcd[k] = max(-rc[k] * 0.99 * orho * odt,
                                     prw_vcd[k])
                    pnc_wcd[k] = max(-nc[k] * 0.99 * orho * odt,
                                     -tables.tnc_wev[idx_d - 1,
                                                     idx_c - 1,
                                                     idx_n - 1]
                                     * orho * odt)
            else:
                prw_vcd[k] = -rc[k] * orho * odt
                pnc_wcd[k] = -nc[k] * orho * odt

            qvten[k] -= prw_vcd[k]
            qcten[k] += prw_vcd[k]
            ncten[k] += pnc_wcd[k]
            nwfaten[k] -= pnc_wcd[k]
            tten[k] += lvap[k] * ocp[k] * prw_vcd[k] * (1 - ifdry)
            rc[k] = max(R1, (qc1d[k] + dt * qcten[k]) * rho[k])
            nc[k] = max(2.0, (nc1d[k] + dt * ncten[k]) * rho[k])
            if not is_aerosol_aware:
                nc[k] = Nt_c
            qv[k] = max(1.0e-10, qv1d[k] + dt * qvten[k])
            temp[k] = t1d[k] + dt * tten[k]
            rho[k] = 0.622 * pres[k] / (R * temp[k] * (qv[k] + 0.622))
            qvs[k] = rslf(pres[k], temp[k])
            ssatw[k] = qv[k] / qvs[k] - 1.0

    # ---- rain evaporation (f90:2880-2960) -----------------------------------
    for k in range(nz):
        if (ssatw[k] < -eps) and L_qr[k] and not (prw_vcd[k] > 0.0):
            tempc = temp[k] - 273.15
            otemp = 1.0 / temp[k]
            orho = 1.0 / rho[k]
            rhof[k] = math.sqrt(c.RHO_NOT * orho)
            rhof2[k] = math.sqrt(rhof[k])
            diffu[k] = 2.11e-5 * (temp[k] / 273.15) ** 1.94 * (101325.0
                                                               / pres[k])
            if tempc >= 0.0:
                visco[k] = (1.718 + 0.0049 * tempc) * 1.0e-5
            else:
                visco[k] = (1.718 + 0.0049 * tempc
                            - 1.2e-5 * tempc * tempc) * 1.0e-5
            vsc2[k] = math.sqrt(rho[k] / visco[k])
            lvap[k] = c.LVAP0 + (2106.0 - 4218.0) * tempc
            tcond[k] = (5.69 + 0.0168 * tempc) * 1.0e-5 * 418.936
            ocp[k] = 1.0 / (c.CP * (1.0 + 0.887 * qv[k]))

            rvs = rho[k] * qvs[k]
            rvs_p = rvs * otemp * (lvap[k] * otemp * c.ORV - 1.0)
            rvs_pp = rvs * (otemp * (lvap[k] * otemp * c.ORV - 1.0)
                            * otemp * (lvap[k] * otemp * c.ORV - 1.0)
                            + (-2.0 * lvap[k] * otemp ** 3 * c.ORV)
                            + otemp * otemp)
            gamsc = lvap[k] * diffu[k] / tcond[k] * rvs_p
            alphsc = (0.5 * (gamsc / (1.0 + gamsc)) ** 2
                      * rvs_pp / rvs_p * rvs / rvs_p)
            alphsc = max(1.0e-9, alphsc)
            xsat = min(-1.0e-9, ssatw[k])
            t1_evap = (2.0 * c.PI * (1.0 - alphsc * xsat
                                     + 2.0 * alphsc ** 2 * xsat ** 2
                                     - 5.0 * alphsc ** 3 * xsat ** 3)
                       / (1.0 + gamsc))
            lamr = 1.0 / ilamr[k]

            if qv[k] / qvs[k] < 0.95 and rr[k] * orho <= 1.0e-8:
                prv_rev[k] = rr[k] * orho * odts
            else:
                prv_rev[k] = (t1_evap * diffu[k] * (-ssatw[k]) * N0_r[k]
                              * rvs
                              * (c.T1_QR_EV * ilamr[k] ** cre[10]
                                 + c.T2_QR_EV * vsc2[k] * rhof2[k]
                                 * (lamr + 0.5 * c.FV_R) ** (-cre[11])))
                rate_max = min(rr[k] * orho * odts,
                               (qvs[k] - qv[k]) * odts)
                prv_rev[k] = min(rate_max, prv_rev[k] * orho)
                # graupel-melt suppression of rain evap (f90:2940-2943)
                if prr_gml[k] > 0.0:
                    eva_factor = min(1.0, 0.01 + (0.99 - 0.01)
                                     * (tempc / 20.0))
                    prv_rev[k] *= eva_factor

            pnr_rev[k] = min(nr[k] * 0.99 * orho * odts,
                             prv_rev[k] * nr[k] / rr[k])

            qrten[k] -= prv_rev[k]
            qvten[k] += prv_rev[k]
            nrten[k] -= pnr_rev[k]
            nwfaten[k] += pnr_rev[k]
            tten[k] -= lvap[k] * ocp[k] * prv_rev[k] * (1 - ifdry)

            rr[k] = max(R1, (qr1d[k] + dt * qrten[k]) * rho[k])
            qv[k] = max(1.0e-10, qv1d[k] + dt * qvten[k])
            nr[k] = max(R2, (nr1d[k] + dt * nrten[k]) * rho[k])
            temp[k] = t1d[k] + dt * tten[k]
            rho[k] = 0.622 * pres[k] / (R * temp[k] * (qv[k] + 0.622))

    # ---- terminal velocities + CFL substep counts (f90:3198-3358) ----------
    # vt*k arrays are (kts:kte+1) with a zero top ghost (f90:3209-3216).
    vtrk = np.zeros(nz + 1)
    vtnrk = np.zeros(nz + 1)
    vtik = np.zeros(nz + 1)
    vtnik = np.zeros(nz + 1)
    vtsk = np.zeros(nz + 1)
    vtgk = np.zeros(nz + 1)
    onstep = [1.0] * 5
    ksed1 = [1] * 5

    nstep = 0
    for k in range(kte, kts - 1, -1):
        rhof[k] = math.sqrt(c.RHO_NOT / rho[k])
        if rr[k] > R1:
            lamr = (c.AM_R * crg[3] * c.ORG2 * nr[k] / rr[k]) ** c.OBMR
            vtrk[k] = (rhof[k] * c.AV_R * crg[6] * c.ORG3
                       * lamr ** cre[3] * (lamr + c.FV_R) ** (-cre[6]))
            # deliberately slower number fall to curb size sorting
            # (f90:3229-3233)
            vtnrk[k] = (rhof[k] * c.AV_R * crg[7] / crg[12]
                        * lamr ** cre[12]
                        * (lamr + c.FV_R) ** (-cre[7]))
        else:
            vtrk[k] = vtrk[k + 1]
            vtnrk[k] = vtnrk[k + 1]
        if max(vtrk[k], vtnrk[k]) > 1.0e-3:
            ksed1[0] = max(ksed1[0], k + 1)      # 1-based like Fortran
            delta_tp = dzq[k] / max(vtrk[k], vtnrk[k])
            nstep = max(nstep, int(dt / delta_tp + 1.0))
    if ksed1[0] == kte + 1:
        ksed1[0] = kte
    if nstep > 0:
        onstep[0] = 1.0 / nstep

    if not iiwarm:
        nstep = 0
        for k in range(kte, kts - 1, -1):
            if ri[k] > R1:
                lami = (c.AM_I * cig[2] * c.OIG1 * ni[k]
                        / ri[k]) ** c.OBMI
                ilami = 1.0 / lami
                vtik[k] = (rhof[k] * c.AV_I * cig[3] * c.OIG2
                           * ilami ** c.BV_I)
                vtnik[k] = (rhof[k] * c.AV_I * cig[6] / cig[7]
                            * ilami ** c.BV_I)
            else:
                vtik[k] = vtik[k + 1]
                vtnik[k] = vtnik[k + 1]
            if vtik[k] > 1.0e-3:
                ksed1[1] = max(ksed1[1], k + 1)
                nstep = max(nstep, int(dt / (dzq[k] / vtik[k]) + 1.0))
        if ksed1[1] == kte + 1:
            ksed1[1] = kte
        if nstep > 0:
            onstep[1] = 1.0 / nstep

        nstep = 0
        for k in range(kte, kts - 1, -1):
            if rs[k] > R1:
                xDs = smoc[k] / smob[k]
                Mrat = 1.0 / xDs
                ils1 = 1.0 / (Mrat * c.LAM0 + c.FV_S)
                ils2 = 1.0 / (Mrat * c.LAM1 + c.FV_S)
                t1_vts = c.KAP0 * csg[4] * ils1 ** cse[4]
                t2_vts = c.KAP1 * Mrat ** c.MU_S * csg[10] \
                    * ils2 ** cse[10]
                ils1 = 1.0 / (Mrat * c.LAM0)
                ils2 = 1.0 / (Mrat * c.LAM1)
                t3_vts = c.KAP0 * csg[1] * ils1 ** cse[1]
                t4_vts = c.KAP1 * Mrat ** c.MU_S * csg[7] \
                    * ils2 ** cse[7]
                vts = (rhof[k] * c.AV_S * (t1_vts + t2_vts)
                       / (t3_vts + t4_vts))
                if temp[k] > (T_0 + 0.1):
                    vtsk[k] = max(vts * vts_boost[k],
                                  vts * ((vtrk[k] - vts * vts_boost[k])
                                         / (temp[k] - T_0)))
                else:
                    vtsk[k] = vts * vts_boost[k]
            else:
                vtsk[k] = vtsk[k + 1]
            if vtsk[k] > 1.0e-3:
                ksed1[2] = max(ksed1[2], k + 1)
                nstep = max(nstep, int(dt / (dzq[k] / vtsk[k]) + 1.0))
        if ksed1[2] == kte + 1:
            ksed1[2] = kte
        if nstep > 0:
            onstep[2] = 1.0 / nstep

        nstep = 0
        for k in range(kte, kts - 1, -1):
            if rg[k] > R1:
                vtg = (rhof[k] * c.AV_G * cgg[6] * c.OGG3
                       * ilamg[k] ** c.BV_G)
                if temp[k] > T_0:
                    vtgk[k] = max(vtg, vtrk[k])
                else:
                    vtgk[k] = vtg
            else:
                vtgk[k] = vtgk[k + 1]
            if vtgk[k] > 1.0e-3:
                ksed1[3] = max(ksed1[3], k + 1)
                nstep = max(nstep, int(dt / (dzq[k] / vtgk[k]) + 1.0))
        if ksed1[3] == kte + 1:
            ksed1[3] = kte
        if nstep > 0:
            onstep[3] = 1.0 / nstep

    sed_debug = dict(vtrk=vtrk.copy(), vtnrk=vtnrk.copy(),
                     vtsk=vtsk.copy(), vtgk=vtgk.copy(),
                     vtik=vtik.copy(), onstep=list(onstep),
                     ksed1=list(ksed1), rr_pre=rr.copy(),
                     nr_pre=nr.copy(), rho_pre=rho.copy())

    # ---- substepped upwind sedimentation sweeps (f90:3365-3578) ------------
    # rain (NOT gated by l_sediment)
    sed_r = np.zeros(nz + 1)
    sed_n = np.zeros(nz + 1)
    nstep = _nint(1.0 / onstep[0])
    for _ in range(nstep):
        for k in range(kte, kts - 1, -1):
            sed_r[k] = vtrk[k] * rr[k]
            sed_n[k] = vtnrk[k] * nr[k]
        k = kte
        odzq = 1.0 / dzq[k]
        orho = 1.0 / rho[k]
        qrten[k] -= sed_r[k] * odzq * onstep[0] * orho
        nrten[k] -= sed_n[k] * odzq * onstep[0] * orho
        rr[k] = max(R1, rr[k] - sed_r[k] * odzq * dt * onstep[0])
        nr[k] = max(R2, nr[k] - sed_n[k] * odzq * dt * onstep[0])
        for k in range(ksed1[0] - 1, kts - 1, -1):
            odzq = 1.0 / dzq[k]
            orho = 1.0 / rho[k]
            qrten[k] += (sed_r[k + 1] - sed_r[k]) * odzq * onstep[0] \
                * orho
            nrten[k] += (sed_n[k + 1] - sed_n[k]) * odzq * onstep[0] \
                * orho
            rr[k] = max(R1, rr[k] + (sed_r[k + 1] - sed_r[k])
                        * odzq * dt * onstep[0])
            nr[k] = max(R2, nr[k] + (sed_n[k + 1] - sed_n[k])
                        * odzq * dt * onstep[0])
        if rr[kts] > R1 * 10.0:
            pptrain += sed_r[kts] * dt * onstep[0]

    # cloud-droplet sedimentation: dead code in the reference (quirk 1,
    # f90:3142-3162, 3414-3442) — velocities never assigned; OFF.

    if not iiwarm:
        # cloud ice (gated by l_sediment; f90:3447-3480)
        sed_i = np.zeros(nz + 1)
        nstep = _nint(1.0 / onstep[1])
        for _ in range(nstep):
            if l_sediment:
                for k in range(kte, kts - 1, -1):
                    sed_i[k] = vtik[k] * ri[k]
                    sed_n[k] = vtnik[k] * ni[k]
            else:
                sed_i[:] = 0.0
                sed_n[:] = 0.0
            k = kte
            odzq = 1.0 / dzq[k]
            orho = 1.0 / rho[k]
            qiten[k] -= sed_i[k] * odzq * onstep[1] * orho
            niten[k] -= sed_n[k] * odzq * onstep[1] * orho
            ri[k] = max(R1, ri[k] - sed_i[k] * odzq * dt * onstep[1])
            ni[k] = max(R2, ni[k] - sed_n[k] * odzq * dt * onstep[1])
            for k in range(ksed1[1] - 1, kts - 1, -1):
                odzq = 1.0 / dzq[k]
                orho = 1.0 / rho[k]
                qiten[k] += (sed_i[k + 1] - sed_i[k]) * odzq \
                    * onstep[1] * orho
                niten[k] += (sed_n[k + 1] - sed_n[k]) * odzq \
                    * onstep[1] * orho
                ri[k] = max(R1, ri[k] + (sed_i[k + 1] - sed_i[k])
                            * odzq * dt * onstep[1])
                ni[k] = max(R2, ni[k] + (sed_n[k + 1] - sed_n[k])
                            * odzq * dt * onstep[1])
            if ri[kts] > R1 * 10.0:
                pptice += sed_i[kts] * dt * onstep[1]

        # snow (f90:3504-3529)
        sed_s = np.zeros(nz + 1)
        nstep = _nint(1.0 / onstep[2])
        for _ in range(nstep):
            if l_sediment:
                for k in range(kte, kts - 1, -1):
                    sed_s[k] = vtsk[k] * rs[k]
            else:
                sed_s[:] = 0.0
            k = kte
            odzq = 1.0 / dzq[k]
            orho = 1.0 / rho[k]
            qsten[k] -= sed_s[k] * odzq * onstep[2] * orho
            rs[k] = max(R1, rs[k] - sed_s[k] * odzq * dt * onstep[2])
            for k in range(ksed1[2] - 1, kts - 1, -1):
                odzq = 1.0 / dzq[k]
                orho = 1.0 / rho[k]
                qsten[k] += (sed_s[k + 1] - sed_s[k]) * odzq \
                    * onstep[2] * orho
                rs[k] = max(R1, rs[k] + (sed_s[k + 1] - sed_s[k])
                            * odzq * dt * onstep[2])
            if rs[kts] > R1 * 10.0:
                pptsnow += sed_s[kts] * dt * onstep[2]

        # graupel (f90:3553-3578)
        sed_g = np.zeros(nz + 1)
        nstep = _nint(1.0 / onstep[3])
        for _ in range(nstep):
            if l_sediment:
                for k in range(kte, kts - 1, -1):
                    sed_g[k] = vtgk[k] * rg[k]
            else:
                sed_g[:] = 0.0
            k = kte
            odzq = 1.0 / dzq[k]
            orho = 1.0 / rho[k]
            qgten[k] -= sed_g[k] * odzq * onstep[3] * orho
            rg[k] = max(R1, rg[k] - sed_g[k] * odzq * dt * onstep[3])
            for k in range(ksed1[3] - 1, kts - 1, -1):
                odzq = 1.0 / dzq[k]
                orho = 1.0 / rho[k]
                qgten[k] += (sed_g[k + 1] - sed_g[k]) * odzq \
                    * onstep[3] * orho
                rg[k] = max(R1, rg[k] + (sed_g[k + 1] - sed_g[k])
                            * odzq * dt * onstep[3])
            if rg[kts] > R1 * 10.0:
                pptgraul += sed_g[kts] * dt * onstep[3]

        # ---- instant melt / instant freeze (f90:3584-3606) -----------------
        for k in range(nz):
            xri = max(0.0, qi1d[k] + qiten[k] * dt)
            if temp[k] > T_0 and xri > 0.0:
                qcten[k] += xri * odt
                ncten[k] += ni1d[k] * odt
                qiten[k] -= xri * odt
                niten[k] = -ni1d[k] * odt
                tten[k] -= c.LFUS * ocp[k] * xri * odt * (1 - ifdry)

            xrc = max(0.0, qc1d[k] + qcten[k] * dt)
            if temp[k] < c.HGFR and xrc > 0.0:
                lfus2 = c.LSUB - lvap[k]
                xnc = nc1d[k] + ncten[k] * dt
                qiten[k] += xrc * odt
                niten[k] += xnc * odt
                qcten[k] -= xrc * odt
                ncten[k] -= xnc * odt
                tten[k] += lfus2 * ocp[k] * xrc * odt * (1 - ifdry)

    # ---- apply tendencies, final PSD renorm, write back (f90:3623-3686) ----
    for k in range(nz):
        t1d[k] = t1d[k] + tten[k] * dt
        qv1d[k] = max(1.0e-10, qv1d[k] + qvten[k] * dt)
        qc1d[k] = qc1d[k] + qcten[k] * dt
        nc1d[k] = max(2.0 / rho[k], nc1d[k] + ncten[k] * dt)
        nwfa1d[k] = max(11.1e6 / rho[k],
                        min(9999.0e6 / rho[k],
                            nwfa1d[k] + nwfaten[k] * dt))
        nifa1d[k] = max(c.NA_IN1 * 0.01,
                        min(9999.0e6 / rho[k],
                            nifa1d[k] + nifaten[k] * dt))

        if qc1d[k] <= R1:
            qc1d[k] = 0.0
            nc1d[k] = 0.0
        else:
            nu_c = min(15, _nint(1000.0e6 / (nc1d[k] * rho[k])) + 2)
            lamc = (c.AM_R * ccg[2, nu_c] * ocg1[nu_c] * nc1d[k]
                    / qc1d[k]) ** c.OBMR
            xDc = (c.BM_R + nu_c + 1.0) / lamc
            if xDc < c.D0C:
                lamc = cce[2, nu_c] / c.D0C
            elif xDc > c.D0R * 2.0:
                lamc = cce[2, nu_c] / (c.D0R * 2.0)
            nc1d[k] = min(ccg[1, nu_c] * ocg2[nu_c] * qc1d[k] / c.AM_R
                          * lamc ** c.BM_R, c.NT_C_MAX / rho[k])

        qi1d[k] = qi1d[k] + qiten[k] * dt
        ni1d[k] = max(R2 / rho[k], ni1d[k] + niten[k] * dt)
        if qi1d[k] <= R1:
            qi1d[k] = 0.0
            ni1d[k] = 0.0
        else:
            lami = (c.AM_I * cig[2] * c.OIG1 * ni1d[k]
                    / qi1d[k]) ** c.OBMI
            ilami = 1.0 / lami
            xDi = (c.BM_I + c.MU_I + 1.0) * ilami
            if xDi < 5.0e-6:
                lami = cie[2] / 5.0e-6
            elif xDi > 300.0e-6:
                lami = cie[2] / 300.0e-6
            ni1d[k] = min(cig[1] * c.OIG2 * qi1d[k] / c.AM_I
                          * lami ** c.BM_I, 499.0e3 / rho[k])

        qr1d[k] = qr1d[k] + qrten[k] * dt
        nr1d[k] = max(R2 / rho[k], nr1d[k] + nrten[k] * dt)
        if qr1d[k] <= R1:
            qr1d[k] = 0.0
            nr1d[k] = 0.0
        else:
            lamr = (c.AM_R * crg[3] * c.ORG2 * nr1d[k]
                    / qr1d[k]) ** c.OBMR
            mvd_r[k] = (3.0 + c.MU_R + 0.672) / lamr
            if mvd_r[k] > 2.5e-3:
                mvd_r[k] = 2.5e-3
            elif mvd_r[k] < c.D0R * 0.75:
                mvd_r[k] = c.D0R * 0.75
            lamr = (3.0 + c.MU_R + 0.672) / mvd_r[k]
            nr1d[k] = crg[2] * c.ORG3 * qr1d[k] * lamr ** c.BM_R / c.AM_R

        qs1d[k] = qs1d[k] + qsten[k] * dt
        if qs1d[k] <= R1:
            qs1d[k] = 0.0
        qg1d[k] = qg1d[k] + qgten[k] * dt
        if qg1d[k] <= R1:
            qg1d[k] = 0.0

    out.update(pptrain=pptrain, pptsnow=pptsnow, pptgraul=pptgraul,
               pptice=pptice)
    out["sed_debug"] = sed_debug
    # process-rate capture for differential debugging / diag validation
    out["rates"] = {
        name: arr for name, arr in [
            ("prw_vcd", prw_vcd), ("pnc_wcd", pnc_wcd),
            ("prr_wau", prr_wau), ("pnr_wau", pnr_wau),
            ("pnc_wau", pnc_wau), ("prr_rcw", prr_rcw),
            ("pnc_rcw", pnc_rcw), ("pnr_rcr", pnr_rcr),
            ("prv_rev", prv_rev), ("pnr_rev", pnr_rev),
            ("prr_rcs", prr_rcs), ("prs_rcs", prs_rcs),
            ("prg_rcs", prg_rcs), ("pnr_rcs", pnr_rcs),
            ("prr_rcg", prr_rcg), ("prg_rcg", prg_rcg),
            ("pnr_rcg", pnr_rcg), ("pri_inu", pri_inu),
            ("pni_inu", pni_inu), ("pri_ihm", pri_ihm),
            ("pni_ihm", pni_ihm), ("pri_wfz", pri_wfz),
            ("pni_wfz", pni_wfz), ("pri_rfz", pri_rfz),
            ("pni_rfz", pni_rfz), ("pnr_rfz", pnr_rfz),
            ("pri_ide", pri_ide), ("pni_ide", pni_ide),
            ("prs_ide", prs_ide), ("pri_rci", pri_rci),
            ("pni_rci", pni_rci), ("pnr_rci", pnr_rci),
            ("prr_rci", prr_rci), ("prg_rci", prg_rci),
            ("pni_sci", pni_sci), ("prs_sci", prs_sci),
            ("pni_iau", pni_iau), ("prs_iau", prs_iau),
            ("prs_scw", prs_scw), ("pnc_scw", pnc_scw),
            ("prs_sde", prs_sde), ("prs_ihm", prs_ihm),
            ("prg_scw", prg_scw), ("prg_rfz", prg_rfz),
            ("prg_gde", prg_gde), ("prg_gcw", prg_gcw),
            ("pnc_gcw", pnc_gcw), ("prg_ihm", prg_ihm),
            ("prr_sml", prr_sml), ("pnr_sml", pnr_sml),
            ("prr_gml", prr_gml), ("pnr_gml", pnr_gml),
            ("pri_iha", pri_iha), ("pni_iha", pni_iha),
            ("pna_rca", pna_rca), ("pna_sca", pna_sca),
            ("pna_gca", pna_gca), ("pnd_rcd", pnd_rcd),
            ("pnd_scd", pnd_scd), ("pnd_gcd", pnd_gcd),
            ("tten", tten), ("qvten", qvten), ("qcten", qcten),
            ("qiten", qiten), ("qrten", qrten), ("qsten", qsten),
            ("qgten", qgten), ("niten", niten), ("nrten", nrten),
            ("ncten", ncten),
        ]}
    return out
