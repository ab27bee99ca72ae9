"""Physical constants, PSD parameters, table axes and derived gamma caches:
the benchmark's frozen copy of ``kid_tpu_torch/constants.py``, unchanged.

This is layer L1 of the framework: everything declared at module level in the
reference (module_mp_thompson09n.f90:28-363) plus the init-time derived
quantities of ``thompson_init`` (module_mp_thompson09n.f90:432-670) that do
not depend on runtime configuration.  All values are float64 numpy scalars /
arrays computed eagerly at import; the device code casts to its compute dtype.

Nothing here is a port of control flow — the reference fills these with
loops + a Lanczos ln-gamma; we use closed-form numpy (math.lgamma is the same
Lanczos family and agrees to ~1e-15 relative).
"""
from __future__ import annotations

import math

import numpy as np


def _gamma(y):
    """Γ(y) — reference computes WGAMMA=exp(GAMMLN) (module_mp_thompson09n.f90:4644-4651)."""
    return math.exp(math.lgamma(y))


# ----------------------------------------------------------------------------
# Fixed physical constants (module_mp_thompson09n.f90:34-177)
# ----------------------------------------------------------------------------
T_0 = 273.15
PI = 3.1415926536

RHO_W = 1000.0
RHO_S = 100.0
RHO_G = 500.0
RHO_I = 890.0

NT_C_MAX = 1999.0e6

NA_IN0 = 1.5e6
NA_IN1 = 0.5e6
NA_CCN0 = 300.0e6
NA_CCN1 = 50.0e6

MU_R = 0.0
MU_G = 0.0
MU_I = 0.0

# Field et al. (2005) double-gamma snow PSD (f90:75-79)
MU_S = 0.6357
KAP0 = 490.6
KAP1 = 17.46
LAM0 = 20.78
LAM1 = 3.29

GONV_MIN = 1.0e4
GONV_MAX = 3.0e6

# Mass power laws m = am * D**bm (f90:90-97)
AM_R = PI * RHO_W / 6.0
BM_R = 3.0
AM_S = 0.069
BM_S = 2.0
AM_G = PI * RHO_G / 6.0
BM_G = 3.0
AM_I = PI * RHO_I / 6.0
BM_I = 3.0

# Fallspeed power laws v = av * D**bv * exp(-fv*D) (f90:102-113)
AV_R = 4854.0
BV_R = 1.0
FV_R = 195.0
AV_S = 40.0
BV_S = 0.55
FV_S = 100.0
AV_G = 442.0
BV_G = 0.89
AV_I = 1847.5
BV_I = 1.0
AV_C = 0.316946e8
BV_C = 2.0

C_CUBE = 0.5
C_SQRD = 0.15

# Fixed collection efficiencies (f90:123-126)
EF_SI = 0.05
EF_RS = 0.95
EF_RG = 0.75
EF_RI = 0.95

R1 = 1.0e-12
R2 = 1.0e-6
EPS = 1.0e-15

# Cooper curve (f90:137-138)
TNO = 5.0
ATO = 0.304

RHO_NOT = 101325.0 / (287.05 * 298.0)

SC = 0.632
SC3 = SC ** (1.0 / 3.0)

HGFR = 235.16

RV = 461.5
ORV = 1.0 / RV
R_GAS = 287.04
CP = 1004.0
R_UNI = 8.314

K_B = 1.38065e-23
M_W = 18.01528e-3
M_A = 28.96e-3
N_AVO = 6.022e23
AR_VOLUME = 4.0 / 3.0 * PI * (2.5e-6) ** 3

LSUB = 2.834e6
LVAP0 = 2.5e6
LFUS = LSUB - LVAP0
OLFUS = 1.0 / LFUS

XM0I = 1.0e-12
D0C = 1.0e-6
D0R = 50.0e-6
D0S = 200.0e-6
D0G = 250.0e-6
D0I = (XM0I / AM_I) ** (1.0 / BM_I)
XM0S = AM_S * D0S ** BM_S
XM0G = AM_G * D0G ** BM_G

# ----------------------------------------------------------------------------
# Lookup table dimensions and axes (f90:179-315)
# ----------------------------------------------------------------------------
NBINS = 100
NBC = NBINS
NBI = NBINS
NBR = NBINS
NBS = NBINS
NBG = NBINS
NTB_C = 37
NTB_I = 64
NTB_R = 37
NTB_S = 28
NTB_G = 28
NTB_G1 = 28
NTB_R1 = 37
NTB_I1 = 55
NTB_T = 9
NTB_IN = 55
NTB_ARC = 7
NTB_ARW = 9
NTB_ART = 7
NTB_ARR = 5
NTB_ARK = 4


def _decade_axis(decades, last=None):
    """Axes like 1e-6,2e-6,...,9e-6,1e-5,... (mantissas 1..9 per decade)."""
    vals = []
    for d in decades:
        for m in range(1, 10):
            vals.append(m * 10.0 ** d)
    if last is not None:
        vals.append(last)
    return np.asarray(vals, dtype=np.float64)


# r_c (f90:215-220): 1e-6..1e-2
R_C_AXIS = _decade_axis([-6, -5, -4, -3], 1e-2)
assert R_C_AXIS.shape == (NTB_C,)
# r_i (f90:223-232): 1e-10..1e-3
R_I_AXIS = _decade_axis([-10, -9, -8, -7, -6, -5, -4], 1e-3)
assert R_I_AXIS.shape == (NTB_I,)
# r_r (f90:235-240): 1e-6..1e-2
R_R_AXIS = _decade_axis([-6, -5, -4, -3], 1e-2)
assert R_R_AXIS.shape == (NTB_R,)
# r_g (f90:243-247): 1e-5..1e-2
R_G_AXIS = _decade_axis([-5, -4, -3], 1e-2)
assert R_G_AXIS.shape == (NTB_G,)
# r_s (f90:250-254): 1e-5..1e-2
R_S_AXIS = _decade_axis([-5, -4, -3], 1e-2)
assert R_S_AXIS.shape == (NTB_S,)
# N0r_exp (f90:257-262): 1e6..1e10
N0R_EXP_AXIS = _decade_axis([6, 7, 8, 9], 1e10)
assert N0R_EXP_AXIS.shape == (NTB_R1,)
# N0g_exp (f90:265-269): 1e4..1e7
N0G_EXP_AXIS = _decade_axis([4, 5, 6], 1e7)
assert N0G_EXP_AXIS.shape == (NTB_G1,)
# Nt_i (f90:272-279): 1..1e6
NT_I_AXIS = _decade_axis([0, 1, 2, 3, 4, 5], 1e6)
assert NT_I_AXIS.shape == (NTB_I1,)
# Nt_IN (f90:296-303): 1..1e6
NT_IN_AXIS = _decade_axis([0, 1, 2, 3, 4, 5], 1e6)
assert NT_IN_AXIS.shape == (NTB_IN,)

# Aerosol activation table axes (f90:284-293)
TA_NA = np.array([10.0, 31.6, 100.0, 316.0, 1000.0, 3160.0, 10000.0])
TA_WW = np.array([0.01, 0.0316, 0.1, 0.316, 1.0, 3.16, 10.0, 31.6, 100.0])
TA_TK = np.array([243.15, 253.15, 263.15, 273.15, 283.15, 293.15, 303.15])
TA_RA = np.array([0.01, 0.02, 0.04, 0.08, 0.16])
TA_KA = np.array([0.2, 0.4, 0.6, 0.8])

# Field et al. (2005) snow-moment regression coefficients (f90:306-311)
SA = np.array([5.065339, -0.062659, -3.032362, 0.029469, -0.000285,
               0.31255, 0.000204, 0.003199, 0.0, -0.015952])
SB = np.array([0.476221, -0.015896, 0.165977, 0.007468, -0.000141,
               0.060366, 0.000079, 0.000594, 0.0, -0.003577])

# Temperatures for rain-snow collection tables (f90:314-315)
TC_AXIS = np.array([-0.01, -5., -10., -15., -20., -25., -30., -35., -40.])

# ----------------------------------------------------------------------------
# Derived gamma-exponent caches (thompson_init, f90:452-553).
# 1-based Fortran indices kept via a leading dummy slot for clarity of
# citation: CCE[j][n] == cce(j,n).
# ----------------------------------------------------------------------------
# Cloud: cce(1..5, 1..15), ccg likewise (f90:452-465).
_n = np.arange(1, 16, dtype=np.float64)
CCE = np.zeros((6, 16))
CCE[1, 1:] = _n + 1.0
CCE[2, 1:] = BM_R + _n + 1.0
CCE[3, 1:] = BM_R + _n + 4.0
CCE[4, 1:] = _n + BV_C + 1.0
CCE[5, 1:] = BM_R + _n + BV_C + 1.0
CCG = np.zeros((6, 16))
for _j in range(1, 6):
    for _i in range(1, 16):
        CCG[_j, _i] = _gamma(CCE[_j, _i])
OCG1 = np.zeros(16)
OCG2 = np.zeros(16)
OCG1[1:] = 1.0 / CCG[1, 1:]
OCG2[1:] = 1.0 / CCG[2, 1:]

# Ice: cie(1..7) (f90:467-483)
CIE = np.zeros(8)
CIE[1] = MU_I + 1.0
CIE[2] = BM_I + MU_I + 1.0
CIE[3] = BM_I + MU_I + BV_I + 1.0
CIE[4] = MU_I + BV_I + 1.0
CIE[5] = MU_I + 2.0
CIE[6] = BM_I * 0.5 + MU_I + BV_I + 1.0
CIE[7] = BM_I * 0.5 + MU_I + 1.0
CIG = np.zeros(8)
for _i in range(1, 8):
    CIG[_i] = _gamma(CIE[_i])
OIG1 = float(1.0 / CIG[1])
OIG2 = float(1.0 / CIG[2])
OBMI = 1.0 / BM_I

# Rain: cre(1..13) (f90:485-505)
CRE = np.zeros(14)
CRE[1] = BM_R + 1.0
CRE[2] = MU_R + 1.0
CRE[3] = BM_R + MU_R + 1.0
CRE[4] = BM_R * 2.0 + MU_R + 1.0
CRE[5] = MU_R + BV_R + 1.0
CRE[6] = BM_R + MU_R + BV_R + 1.0
CRE[7] = BM_R * 0.5 + MU_R + BV_R + 1.0
CRE[8] = BM_R + MU_R + BV_R + 3.0
CRE[9] = MU_R + BV_R + 3.0
CRE[10] = MU_R + 2.0
CRE[11] = 0.5 * (BV_R + 5.0 + 2.0 * MU_R)
CRE[12] = BM_R * 0.5 + MU_R + 1.0
CRE[13] = BM_R * 2.0 + MU_R + BV_R + 1.0
CRG = np.zeros(14)
for _i in range(1, 14):
    CRG[_i] = _gamma(CRE[_i])
OBMR = 1.0 / BM_R
ORE1 = float(1.0 / CRE[1])
ORG1 = float(1.0 / CRG[1])
ORG2 = float(1.0 / CRG[2])
ORG3 = float(1.0 / CRG[3])

# Snow: cse(1..18) (f90:507-530)
CSE = np.zeros(19)
CSE[1] = BM_S + 1.0
CSE[2] = BM_S + 2.0
CSE[3] = BM_S * 2.0
CSE[4] = BM_S + BV_S + 1.0
CSE[5] = BM_S * 2.0 + BV_S + 1.0
CSE[6] = BM_S * 2.0 + 1.0
CSE[7] = BM_S + MU_S + 1.0
CSE[8] = BM_S + MU_S + 2.0
CSE[9] = BM_S + MU_S + 3.0
CSE[10] = BM_S + MU_S + BV_S + 1.0
CSE[11] = BM_S * 2.0 + MU_S + BV_S + 1.0
CSE[12] = BM_S * 2.0 + MU_S + 1.0
CSE[13] = BV_S + 2.0
CSE[14] = BM_S + BV_S
CSE[15] = MU_S + 1.0
CSE[16] = 1.0 + (1.0 + BV_S) / 2.0
CSE[17] = CSE[16] + MU_S + 1.0
CSE[18] = BV_S + MU_S + 3.0
CSG = np.zeros(19)
for _i in range(1, 19):
    CSG[_i] = _gamma(CSE[_i])
OAMS = 1.0 / AM_S
OBMS = 1.0 / BM_S
OCMS = OAMS ** OBMS

# Graupel: cge(1..12) (f90:532-553)
CGE = np.zeros(13)
CGE[1] = BM_G + 1.0
CGE[2] = MU_G + 1.0
CGE[3] = BM_G + MU_G + 1.0
CGE[4] = BM_G * 2.0 + MU_G + 1.0
CGE[5] = BM_G * 2.0 + MU_G + BV_G + 1.0
CGE[6] = BM_G + MU_G + BV_G + 1.0
CGE[7] = BM_G + MU_G + BV_G + 2.0
CGE[8] = BM_G + MU_G + BV_G + 3.0
CGE[9] = MU_G + BV_G + 3.0
CGE[10] = MU_G + 2.0
CGE[11] = 0.5 * (BV_G + 5.0 + 2.0 * MU_G)
CGE[12] = 0.5 * (BV_G + 5.0) + MU_G
CGG = np.zeros(13)
for _i in range(1, 13):
    CGG[_i] = _gamma(CGE[_i])
OAMG = 1.0 / AM_G
OBMG = 1.0 / BM_G
OCMG = OAMG ** OBMG
OGE1 = float(1.0 / CGE[1])
OGG1 = float(1.0 / CGG[1])
OGG2 = float(1.0 / CGG[2])
OGG3 = float(1.0 / CGG[3])

# ----------------------------------------------------------------------------
# Collapsed rate constants (f90:558-591)
# ----------------------------------------------------------------------------
T1_QR_QC = float(PI * 0.25 * AV_R * CRG[9])
T1_QR_QI = float(PI * 0.25 * AV_R * CRG[9])
T2_QR_QI = float(PI * 0.25 * AM_R * AV_R * CRG[8])
T1_QG_QC = float(PI * 0.25 * AV_G * CGG[9])
T1_QS_QC = PI * 0.25 * AV_S
T1_QS_QI = PI * 0.25 * AV_S
T1_QR_EV = float(0.78 * CRG[10])
T2_QR_EV = float(0.308 * SC3 * math.sqrt(AV_R) * CRG[11])
T1_QS_SD = 0.86
T2_QS_SD = 0.28 * SC3 * math.sqrt(AV_S)
T1_QS_ME = PI * 4.0 * C_SQRD * OLFUS * 0.86
T2_QS_ME = PI * 4.0 * C_SQRD * OLFUS * 0.28 * SC3 * math.sqrt(AV_S)
T1_QG_SD = float(0.86 * CGG[10])
T2_QG_SD = float(0.28 * SC3 * math.sqrt(AV_G) * CGG[11])
T1_QG_ME = float(PI * 4.0 * C_CUBE * OLFUS * 0.86 * CGG[10])
T2_QG_ME = float(PI * 4.0 * C_CUBE * OLFUS * 0.28 * SC3 * math.sqrt(AV_G) * CGG[11])

# ----------------------------------------------------------------------------
# Log-index offsets for the decade/mantissa table index (f90:594-602)
# ----------------------------------------------------------------------------
NIC2 = int(round(math.log10(R_C_AXIS[0])))
NII2 = int(round(math.log10(R_I_AXIS[0])))
NII3 = int(round(math.log10(NT_I_AXIS[0])))
NIR2 = int(round(math.log10(R_R_AXIS[0])))
NIR3 = int(round(math.log10(N0R_EXP_AXIS[0])))
NIS2 = int(round(math.log10(R_S_AXIS[0])))
NIG2 = int(round(math.log10(R_G_AXIS[0])))
NIG3 = int(round(math.log10(N0G_EXP_AXIS[0])))
NIIN2 = int(round(math.log10(NT_IN_AXIS[0])))

# ----------------------------------------------------------------------------
# Size bins (thompson_init, f90:604-670)
# ----------------------------------------------------------------------------


def _log_bins(d_min, d_max, n):
    """Geometric bin edges/centers as in the reference (f90:612-658)."""
    edges = np.exp(np.arange(n + 1, dtype=np.float64) / n
                   * np.log(d_max / d_min) + np.log(d_min))
    centers = np.sqrt(edges[:-1] * edges[1:])
    widths = np.diff(edges)
    return centers, widths


# Cloud bins: linear, 1 micron steps from D0c (f90:604-610).
DC_BINS = D0C + 1.0e-6 * np.arange(NBC, dtype=np.float64)
DTC_BINS = np.full(NBC, 1.0e-6)
DTC_BINS[0] = D0C  # dtc(1) = D0c (f90:606)

DI_BINS, DTI_BINS = _log_bins(D0I, 5.0 * D0S, NBI)
DR_BINS, DTR_BINS = _log_bins(D0R, 0.005, NBR)
DS_BINS, DTS_BINS = _log_bins(D0S, 0.02, NBS)
DG_BINS, DTG_BINS = _log_bins(D0G, 0.05, NBG)

# Cloud droplet number bins, 1..3000 per cc (f90:661-670).
_tnc_centers, _ = _log_bins(1.0, 3000.0, NBC)
T_NC = _tnc_centers * 1.0e6
# nic1 is declared INTEGER in the reference (f90:195) and assigned the real
# log-ratio, which truncates toward zero — reproduce exactly (f90:670).
NIC1 = int(math.log(T_NC[-1] / T_NC[0]))
assert NIC1 == 7
