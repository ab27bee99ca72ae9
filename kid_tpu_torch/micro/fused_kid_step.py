"""The whole 1-D driver step as one hand-written CUDA kernel.

``fused_kid_step`` replaces ``kid_tpu/micro/pallas_step.py::fused_kid_step``
(the Pallas TPU kernel of the opt-in fused driver): from the raw
``KidState`` it computes the vertical MUSCL advection and the divergence
closure of all 12 channels, the provisional state ``q + (adv + div)*dt``,
the theta -> T Exner map, phases 2-20 of the microphysics
(``solver.core_from_tables``) and T -> theta.  The table-stage channels
``tv`` come from the caller, who builds them from the driver's own
provisional state (which advects only ``advected_fields(cfg)``), as the
reference does.

For a CUDA tensor the wrapper launches the kernel of
``csrc/fused_kid_step.cu``; for a CPU tensor it runs
``fused_kid_step_ref``, the plain PyTorch version.  There is no fallback
between the two.  ``fused_kid_step.launches`` counts the kernel launches
(a CUDA graph's replay adds its capture's, ``cuda_build.add_launches``).
The kernel reads m(t) from the card, so a captured launch reads each
replay's m.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from ..config import MicroConfig
from ..driver.advection import advective_tendency_z, divergence_tendency_z
from ..driver.loop import KidState
from . import cuda_build
from . import solver as S
from .state import ColumnState, Precip

N_KID = len(KidState._fields)
_P = ctypes.c_void_p
_I = ctypes.c_int
_D = ctypes.c_double
_ARGTYPES = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _D, _D, _D, _P, _P]


def _check_cfg(cfg: MicroConfig):
    if cfg.is_aerosol_aware:
        raise ValueError("fused_kid_step takes non-aerosol configs")


def tv_out(st: KidState, cfg: MicroConfig):
    """The tv rows of a new packed input ``x`` (see ``pack_kid_inputs``),
    for the table stage to write into."""
    return cuda_build.tail_rows(N_KID, len(S.tv_keys(cfg)), st.qv)


def pack_kid_inputs(st: KidState, tv, w_pat_prof, pres_prof, exner_prof,
                    rho0_prof, dz_prof, cfg: MicroConfig):
    """The kernel's inputs: ``x``, one contiguous (12 + ntv, ncol, nz)
    tensor of the ``KidState`` channels in their order and the
    ``solver.tv_keys(cfg)`` channels (where ``tv`` holds the rows of
    ``tv_out``, only the 12 are copied, into the tensor those rows belong
    to), and ``prof``, (5, nz + 1): the rho0*w face pattern, then pres,
    exner, rho0 and dz, each padded by one."""
    x = cuda_build.pack([*st], [tv[k] for k in S.tv_keys(cfg)], st.qv.shape)

    def row(a, pad):
        r = torch.as_tensor(a, dtype=x.dtype, device=x.device).reshape(-1)
        return F.pad(r, (0, pad))

    prof = torch.stack([row(w_pat_prof, 0)] + [
        row(a, 1) for a in (pres_prof, exner_prof, rho0_prof, dz_prof)])
    return x, prof


def launch_kid_packed(x, prof, mmod, cfg: MicroConfig, dt_f: float,
                      want_rates: bool):
    """Launch the kernel on ``x`` and ``prof`` (see ``pack_kid_inputs``) and
    ``mmod``, m(t) as a one-element tensor of their dtype and device which
    the kernel reads, on the current stream, without synchronising.
    Returns ``y`` (12 [+36], ncol, nz), the new state in ``KidState`` order
    and the ``solver.DIAG_KEYS`` profiles, and ``ppt`` (4, ncol)."""
    ncol, nz = cuda_build.check_packed(x, N_KID + len(S.tv_keys(cfg)),
                                       "fused_kid_step")
    _check_cfg(cfg)
    if (prof.shape != (5, nz + 1) or prof.dtype != x.dtype
            or prof.device != x.device or not prof.is_contiguous()):
        raise ValueError(f"profiles must be a contiguous (5, {nz + 1}) "
                         "tensor of the input's dtype and device")
    if (mmod.numel() != 1 or mmod.dtype != x.dtype
            or mmod.device != x.device):
        raise ValueError("mmod must be one value of the input's dtype on "
                         "its device")
    n_out = N_KID + (len(S.DIAG_KEYS) if want_rates else 0)
    y = torch.empty((n_out, ncol, nz), dtype=x.dtype, device=x.device)
    ppt = torch.empty((4, ncol), dtype=x.dtype, device=x.device)
    fn = cuda_build.kernel_function("fused_kid_step", x.dtype, _ARGTYPES)
    dt, _ = S._dt_pair(dt_f, x.dtype)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), prof.data_ptr(), y.data_ptr(),
                 ppt.data_ptr(), ncol, nz, int(cfg.iiwarm), int(want_rates),
                 int(cfg.l_sediment), float(cfg.nt_c), dt,
                 float(1 - cfg.ifdry), mmod.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"fused_kid_step kernel launch failed: cudaError "
                           f"{err}")
    fused_kid_step.launches += 1
    return y, ppt


def unpack_kid_outputs(y, ppt, want_rates: bool):
    """(KidState, Precip, diag dict) views of the kernel's outputs."""
    state = KidState(*y[:N_KID])
    diag = dict(zip(S.DIAG_KEYS, y[N_KID:])) if want_rates else {}
    return state, Precip(*ppt), diag


def fused_kid_step_ref(st: KidState, w_pat_prof, mmod, tv,
                       pres_prof, exner_prof, rho0_prof, dz_prof,
                       cfg: MicroConfig, dt_f: float, want_rates: bool):
    """The plain PyTorch version of the kernel on any device: the body of
    the reference kernel (pallas_step.py:129-163) on (1, nz) profile
    rows."""
    dtype, dev = st.qv.dtype, st.qv.device
    ncol, nz = st.qv.shape

    def row(a):
        return torch.as_tensor(a, dtype=dtype, device=dev).reshape(1, -1)

    w_face = mmod * row(w_pat_prof)                         # (1, nz+1)
    exner, rho0, dz = row(exner_prof), row(rho0_prof), row(dz_prof)
    dt, _ = S._dt_pair(dt_f, dtype)
    q = torch.stack(list(st))                               # all 12
    ten = (advective_tendency_z(q, w_face, rho0, dz)
           + divergence_tendency_z(q, w_face, rho0, dz))
    prov = dict(zip(KidState._fields, q + ten * dt))
    micro_in = ColumnState(
        t=prov["theta"] * exner, qv=prov["qv"], qc=prov["qc"],
        qi=prov["qi"], qr=prov["qr"], qs=prov["qs"], qg=prov["qg"],
        ni=prov["ni"], nr=prov["nr"], nc=prov["nc"], nwfa=prov["nwfa"],
        nifa=prov["nifa"])
    out, ppt, diag = S.core_from_tables(
        micro_in, row(pres_prof).expand(ncol, nz), dz.expand(ncol, nz), tv,
        cfg, dt_f, want_rates)
    new = KidState(
        theta=out.t / exner, qv=out.qv, qc=out.qc, qr=out.qr, nr=out.nr,
        qi=out.qi, ni=out.ni, qs=out.qs, qg=out.qg, nc=out.nc,
        nwfa=out.nwfa, nifa=out.nifa)
    return new, ppt, diag


def fused_kid_step(st: KidState, w_pat_prof, mmod, tv, pres_prof,
                   exner_prof, rho0_prof, dz_prof, cfg: MicroConfig,
                   dt_f: float, want_rates: bool):
    """One fused 1-D driver step for (ncol, nz) columns.

    Args:
      st:         the raw ``KidState`` (theta, not T).
      w_pat_prof: (nz+1,) rho0*w face pattern, the same for every column;
                  the faces' flux is ``mmod * w_pat_prof``.
      mmod:       the time modulation m(t), a 0-d tensor of the state's
                  dtype on its device (the kernel reads it there).
      tv:         the table-stage channels (``solver.tv_keys(cfg)``).
      pres/exner/rho0/dz_prof: (nz,) case profiles.
    A CPU tensor runs ``fused_kid_step_ref``; a CUDA tensor launches the
    kernel (float32 or float64, nz <= 256, non-aerosol configs) or raises.
    Returns (new KidState, Precip of (ncol,) tensors, diag dict)."""
    _check_cfg(cfg)
    dev = cuda_build.same_device("fused_kid_step", *st, *tv.values(), mmod)
    if dev.type == "cpu":
        return fused_kid_step_ref(st, w_pat_prof, mmod, tv, pres_prof,
                                  exner_prof, rho0_prof, dz_prof, cfg, dt_f,
                                  want_rates)
    if st.qv.dim() != 2:
        raise ValueError("fused_kid_step takes (ncol, nz) columns")
    x, prof = pack_kid_inputs(st, tv, w_pat_prof, pres_prof, exner_prof,
                              rho0_prof, dz_prof, cfg)
    y, ppt = launch_kid_packed(x, prof, mmod, cfg, dt_f, want_rates)
    return unpack_kid_outputs(y, ppt, want_rates)


fused_kid_step.launches = 0
