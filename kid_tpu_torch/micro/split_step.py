"""The aerosol-aware microphysics step as two hand-written CUDA kernels.

Aerosol-aware configurations cannot run as one kernel: the phase-14 table
lookups (CCN activation and the drop-evaporation number) read the
provisional state of phase 12, which depends on the phase 8-11
tendencies.  So the step splits in two around a lookup stage in torch ops
(``solver.aerosol_lookup_stage``):

  * ``fused_rates`` (phases 2-11) replaces
    ``kid_tpu/micro/pallas_step.py::fused_rates``; kernel
    ``csrc/fused_rates.cu``, plain version ``fused_rates_ref``
    (``solver.rates_from_tables``);
  * ``fused_post`` (phases 12-20) replaces
    ``kid_tpu/micro/pallas_step.py::fused_post``; kernel
    ``csrc/fused_post.cu``, plain version ``fused_post_ref``
    (``solver.post_from_p8``).

For a CUDA tensor each wrapper launches its kernel or raises; for a CPU
tensor it runs its plain version.  The kernels are built by
``cuda_build`` and bound with ``ctypes``; ``fused_rates.launches`` and
``fused_post.launches`` count the launches, and a CUDA graph's replay adds
the launches its capture recorded (``cuda_build.add_launches``).
"""
from __future__ import annotations

import ctypes

import torch

from ..config import MicroConfig
from . import cuda_build
from . import solver as S
from .state import ColumnState, Precip

N_STATE = len(ColumnState._fields)
AUX_KEYS = ("xnc_act", "wev")
_P = ctypes.c_void_p
_I = ctypes.c_int
_D = ctypes.c_double
_RATES_ARGS = [_P, _P, _I, _I, _I, _I, _D, _D, _D, _I, _I, _P]
_POST_ARGS = [_P, _P, _P, _I, _I, _I, _I, _I, _D, _D, _D, _P]


def _check(x, cfg: MicroConfig, n_in: int, name: str):
    ncol, nz = cuda_build.check_packed(x, n_in, name)
    if not cfg.is_aerosol_aware:
        raise ValueError(f"{name} takes aerosol-aware configs; the others "
                         "run fused_step")
    return ncol, nz


# ---- kernel A: phases 2-11 ------------------------------------------------

def tv_out(state: ColumnState, cfg: MicroConfig):
    """The tv rows of a new packed input of kernel A (see
    ``pack_rates_inputs``), for the table stage to write into."""
    return cuda_build.tail_rows(N_STATE + 1, len(S.tv_keys(cfg)), state.qv)


def pack_rates_inputs(state: ColumnState, pres, tv, cfg: MicroConfig):
    """Kernel A's one contiguous input, (13 + ntv, ncol, nz): the 12
    state channels, pres and the ``solver.tv_keys(cfg)`` channels.  Where
    ``tv`` holds the rows of ``tv_out``, only the first 13 are copied,
    into the tensor those rows belong to."""
    return cuda_build.pack([*state, pres], [tv[k] for k in S.tv_keys(cfg)],
                           state.qv.shape)


def launch_rates_packed(x, cfg: MicroConfig, dt_f: float, want_rates: bool):
    """Launch kernel A on ``x`` (see ``pack_rates_inputs``) on the current
    stream, without synchronising.  Returns ``y``, (15 [+33], ncol, nz):
    the ``solver.P8_OUT`` channels, then ``solver.P8_RATES``."""
    ncol, nz = _check(x, cfg, N_STATE + 1 + len(S.tv_keys(cfg)),
                      "fused_rates")
    n_out = len(S.P8_OUT) + (len(S.P8_RATES) if want_rates else 0)
    y = torch.empty((n_out, ncol, nz), dtype=x.dtype, device=x.device)
    fn = cuda_build.kernel_function("fused_rates", x.dtype, _RATES_ARGS)
    dt, _ = S._dt_pair(dt_f, x.dtype)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), y.data_ptr(), ncol, nz, int(cfg.iiwarm),
                 int(want_rates), float(cfg.nt_c), dt, float(1 - cfg.ifdry),
                 int(cfg.dusty_ice), int(cfg.homog_ice), stream)
    if err != 0:
        raise RuntimeError(f"fused_rates kernel launch failed: cudaError "
                           f"{err}")
    fused_rates.launches += 1
    return y


def unpack_rates_outputs(y, want_rates: bool) -> dict:
    """The p8 dict (views of ``y``)."""
    keys = S.P8_OUT + (S.P8_RATES if want_rates else ())
    return dict(zip(keys, y))


def fused_rates_ref(state: ColumnState, pres, tv, cfg: MicroConfig,
                    dt_f: float, want_rates: bool) -> dict:
    """The plain PyTorch version of kernel A on any device."""
    return S.rates_from_tables(state, pres, tv, cfg, dt_f, want_rates)


def fused_rates(state: ColumnState, pres, tv, cfg: MicroConfig, dt_f: float,
                want_rates: bool) -> dict:
    """Phases 2-11 of one aerosol-aware step for (ncol, nz) columns.

    ``tv`` holds the table-stage channels (``solver.tv_keys(cfg)``).  A
    CPU tensor runs ``fused_rates_ref``; a CUDA tensor launches the kernel
    (float32 or float64, nz <= 256) or raises.  Returns the p8 dict:
    ``solver.P8_OUT`` (+ ``P8_RATES`` with ``want_rates``)."""
    dev = cuda_build.same_device("fused_rates", *state, pres, *tv.values())
    if dev.type == "cpu":
        return fused_rates_ref(state, pres, tv, cfg, dt_f, want_rates)
    if state.qv.dim() != 2:
        raise ValueError("fused_rates takes (ncol, nz) columns")
    y = launch_rates_packed(pack_rates_inputs(state, pres, tv, cfg), cfg,
                            dt_f, want_rates)
    return unpack_rates_outputs(y, want_rates)


fused_rates.launches = 0


# ---- kernel B: phases 12-20 -----------------------------------------------

def pack_post_inputs(state: ColumnState, pres, dzq, p8: dict, aux: dict):
    """Kernel B's one contiguous input, (31, ncol, nz): the 12 state
    channels, pres, dzq, the 15 ``solver.P8_OUT`` channels, ``xnc_act``
    and ``wev``."""
    shape = state.qv.shape
    chans = ([*state, pres, dzq] + [p8[k] for k in S.P8_OUT]
             + [aux[k] for k in AUX_KEYS])
    return torch.stack([torch.broadcast_to(t, shape) for t in chans])


def launch_post_packed(x, cfg: MicroConfig, dt_f: float, want_rates: bool):
    """Launch kernel B on ``x`` (see ``pack_post_inputs``) on the current
    stream, without synchronising.  Returns ``y``, (12 [+3], ncol, nz):
    the new state, then prr_gml, prv_rev and pnr_rev, and ``ppt``,
    (4, ncol)."""
    ncol, nz = _check(x, cfg, N_STATE + 2 + len(S.P8_OUT) + len(AUX_KEYS),
                      "fused_post")
    y = torch.empty((N_STATE + (3 if want_rates else 0), ncol, nz),
                    dtype=x.dtype, device=x.device)
    ppt = torch.empty((4, ncol), dtype=x.dtype, device=x.device)
    fn = cuda_build.kernel_function("fused_post", x.dtype, _POST_ARGS)
    dt, _ = S._dt_pair(dt_f, x.dtype)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), y.data_ptr(), ppt.data_ptr(), ncol, nz,
                 int(cfg.iiwarm), int(want_rates), int(cfg.l_sediment),
                 float(cfg.nt_c), dt, float(1 - cfg.ifdry), stream)
    if err != 0:
        raise RuntimeError(f"fused_post kernel launch failed: cudaError "
                           f"{err}")
    fused_post.launches += 1
    return y, ppt


def unpack_post_outputs(y, ppt, p8: dict, want_rates: bool):
    """(ColumnState, Precip, diag dict) views of kernel B's outputs; the
    diag's 33 ``P8_RATES`` pass through from kernel A's ``p8``."""
    state = ColumnState(*y[:N_STATE])
    precip = Precip(*ppt)
    diag = {}
    if want_rates:
        diag = {k: p8[k] for k in S.P8_RATES}
        diag.update(zip(("prr_gml", "prv_rev", "pnr_rev"), y[N_STATE:]))
    return state, precip, diag


def fused_post_ref(state: ColumnState, pres, dzq, p8: dict, aux: dict,
                   cfg: MicroConfig, dt_f: float, want_rates: bool):
    """The plain PyTorch version of kernel B on any device."""
    return S.post_from_p8(state, pres, dzq, p8, cfg, dt_f, want_rates, aux)


def fused_post(state: ColumnState, pres, dzq, p8: dict, aux: dict,
               cfg: MicroConfig, dt_f: float, want_rates: bool):
    """Phases 12-20 of one aerosol-aware step for (ncol, nz) columns, from
    kernel A's ``p8`` and the lookup stage's ``aux`` (``xnc_act``,
    ``wev``).  A CPU tensor runs ``fused_post_ref``; a CUDA tensor
    launches the kernel (float32 or float64, nz <= 256) or raises.  The
    outputs are new tensors.  Returns (ColumnState, Precip of (ncol,)
    tensors, diag dict)."""
    dev = cuda_build.same_device("fused_post", *state, pres, dzq,
                       *[p8[k] for k in S.P8_OUT],
                       *[aux[k] for k in AUX_KEYS])
    if dev.type == "cpu":
        return fused_post_ref(state, pres, dzq, p8, aux, cfg, dt_f,
                              want_rates)
    if state.qv.dim() != 2:
        raise ValueError("fused_post takes (ncol, nz) columns")
    y, ppt = launch_post_packed(pack_post_inputs(state, pres, dzq, p8, aux),
                                cfg, dt_f, want_rates)
    return unpack_post_outputs(y, ppt, p8, want_rates)


fused_post.launches = 0
