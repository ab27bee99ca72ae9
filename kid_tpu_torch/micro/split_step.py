"""The aerosol-aware microphysics step as three hand-written CUDA kernels.

Aerosol-aware configurations cannot run as one kernel: the phase-14 table
lookups (CCN activation and the drop-evaporation number) read the
provisional state of phase 12, which depends on the phase 8-11
tendencies.  So the step splits in two around a lookup stage:

  * ``fused_rates`` (phases 2-11) replaces
    ``kid_tpu/micro/pallas_step.py::fused_rates``; kernel
    ``csrc/fused_rates.cu``, plain version ``fused_rates_ref``
    (``solver.rates_from_tables``);
  * ``lookup_stage`` (the phase-14 lookups) replaces the reference's XLA
    stage ``kid_tpu/micro/solver.py::aerosol_lookup_stage``; kernel
    ``csrc/lookup_stage.cu``, plain version ``lookup_stage_ref``
    (``solver.aerosol_lookup_stage``);
  * ``fused_post`` (phases 12-20) replaces
    ``kid_tpu/micro/pallas_step.py::fused_post``; kernel
    ``csrc/fused_post.cu``, plain version ``fused_post_ref``
    (``solver.post_from_p8``).

For a CUDA tensor each wrapper launches its kernel or raises; for a CPU
tensor it runs its plain version.  The kernels are built by
``cuda_build`` and bound with ``ctypes``; each wrapper counts its
launches in ``.launches``, and a CUDA graph's replay adds the launches its
capture recorded (``cuda_build.add_launches``).  Without rate profiles the
step writes ``fused_rates``' outputs and the lookups straight into the
rows that ``fused_post``'s packed input ends with (``post_out``), so its
pack copies only the head.
"""
from __future__ import annotations

import ctypes

import torch

from .. import constants as c
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
_LOOKUP_ARGS = [ctypes.POINTER(_P), ctypes.POINTER(ctypes.c_longlong), _P, _P,
                _P, _I, _I, _I, _D, _P]


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


def _check_out(out, n_out: int, x, name: str):
    """Raise unless ``out`` is a contiguous (n_out, *x.shape) tensor of
    ``x``'s dtype and device."""
    want = (n_out, *x.shape)
    if (tuple(out.shape) != want or out.dtype != x.dtype
            or out.device != x.device or not out.is_contiguous()):
        raise ValueError(f"{name}'s out must be a contiguous {want} tensor "
                         "of the inputs' dtype and device")


def _into_rows(out, keys, chans: dict, name: str) -> dict:
    """``chans[k]`` for each of ``keys`` copied into the rows of ``out``
    (checked as ``_check_out`` checks it); returns the rows by key."""
    _check_out(out, len(keys), chans[keys[0]], name)
    for row, k in zip(out, keys):
        row.copy_(chans[k])
    return dict(zip(keys, out))


def launch_rates_packed(x, cfg: MicroConfig, dt_f: float, want_rates: bool,
                        out=None):
    """Launch kernel A on ``x`` (see ``pack_rates_inputs``) on the current
    stream, without synchronising.  Returns ``y``, (15 [+33], ncol, nz):
    the ``solver.P8_OUT`` channels, then ``solver.P8_RATES``; ``out``,
    where given, is ``y``."""
    ncol, nz = _check(x, cfg, N_STATE + 1 + len(S.tv_keys(cfg)),
                      "fused_rates")
    n_out = len(S.P8_OUT) + (len(S.P8_RATES) if want_rates else 0)
    if out is None:
        y = torch.empty((n_out, ncol, nz), dtype=x.dtype, device=x.device)
    else:
        _check_out(out, n_out, x[0], "fused_rates")
        y = out
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
                    dt_f: float, want_rates: bool, out=None) -> dict:
    """The plain PyTorch version of kernel A on any device, copied into
    the rows of ``out`` (and returned as views of them) when given."""
    p8 = S.rates_from_tables(state, pres, tv, cfg, dt_f, want_rates)
    return p8 if out is None else _into_rows(
        out, S.P8_OUT + (S.P8_RATES if want_rates else ()), p8,
        "fused_rates")


def fused_rates(state: ColumnState, pres, tv, cfg: MicroConfig, dt_f: float,
                want_rates: bool, out=None) -> dict:
    """Phases 2-11 of one aerosol-aware step for (ncol, nz) columns.

    ``tv`` holds the table-stage channels (``solver.tv_keys(cfg)``).  A
    CPU tensor runs ``fused_rates_ref``; a CUDA tensor launches the kernel
    (float32 or float64, nz <= 256) or raises.  Returns the p8 dict:
    ``solver.P8_OUT`` (+ ``P8_RATES`` with ``want_rates``), as views of
    the rows of ``out``, a contiguous (15 [+33], ncol, nz) tensor, where
    given (the first rows of ``post_out``'s)."""
    dev = cuda_build.same_device("fused_rates", *state, pres, *tv.values())
    if dev.type == "cpu":
        return fused_rates_ref(state, pres, tv, cfg, dt_f, want_rates, out)
    if state.qv.dim() != 2:
        raise ValueError("fused_rates takes (ncol, nz) columns")
    y = launch_rates_packed(pack_rates_inputs(state, pres, tv, cfg), cfg,
                            dt_f, want_rates, out)
    return unpack_rates_outputs(y, want_rates)


fused_rates.launches = 0


# ---- the lookup stage: phase 14's table lookups ---------------------------

# the lookup kernel's input channels, in its order: the state's, pres, the
# cell-centred vertical velocity w, then kernel A's tendencies
LOOKUP_STATE = ("t", "qv", "qc", "nc", "nwfa")
LOOKUP_P8 = ("tten", "qvten", "qcten", "ncten", "nwfaten")
LOOKUP_CHANNELS = (*LOOKUP_STATE, "pres", "w", *LOOKUP_P8)
# the tables it reads, and their shapes
LOOKUP_TABLES = {"tnc_wev": (c.NBC, c.NTB_C, c.NBC),
                 "tnccn_corners": (len(c.TA_NA) * len(c.TA_WW)
                                   * len(c.TA_TK), 4)}


def lookup_stage_ref(state: ColumnState, pres, w1d, p8: dict, tables,
                     cfg: MicroConfig, dt_f: float, out=None) -> dict:
    """The plain PyTorch version of the lookup kernel on any device:
    ``solver.aerosol_lookup_stage``, copied into the rows of ``out`` (and
    returned as views of them) when given."""
    aux = S.aerosol_lookup_stage(state, pres, w1d, p8, tables, cfg, dt_f)
    return aux if out is None else _into_rows(out, AUX_KEYS, aux,
                                              "lookup_stage")


def launch_lookup(chans, tables, out, cfg: MicroConfig, dt_f: float):
    """Launch the lookup kernel on the 12 channels ``chans``
    (``LOOKUP_CHANNELS``, each (ncol, nz) with any strides) and the device
    ``tables``, writing ``xnc_act`` and ``wev`` into ``out``, (2, ncol,
    nz) contiguous, on the current stream without synchronising."""
    x = chans[0]
    if x.device.type != "cuda":
        raise ValueError(f"lookup_stage launches on a CUDA tensor, got "
                         f"{x.device}")
    tabs = [getattr(tables, k) for k in LOOKUP_TABLES]
    cuda_build.same_device("lookup_stage", *chans, *tabs)
    if x.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"lookup_stage takes float32 or float64, not "
                        f"{x.dtype}")
    if (len(chans) != len(LOOKUP_CHANNELS) or x.dim() != 2
            or any(t.shape != x.shape for t in chans)):
        raise ValueError(f"lookup_stage takes {len(LOOKUP_CHANNELS)} "
                         "(ncol, nz) channels")
    _check_out(out, len(AUX_KEYS), x, "lookup_stage")
    for (k, shape), t in zip(LOOKUP_TABLES.items(), tabs):
        if tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"table {k} must be a contiguous {shape} "
                             "tensor")
    ncol, nz = x.shape
    fn = cuda_build.kernel_function("lookup_stage", x.dtype, _LOOKUP_ARGS)
    ptrs = (_P * len(chans))(*[t.data_ptr() for t in chans])
    strides = (ctypes.c_longlong * (2 * len(chans)))(
        *[st for t in chans for st in t.stride()])
    dt, _ = S._dt_pair(dt_f, x.dtype)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        err = fn(ptrs, strides, tabs[0].data_ptr(), tabs[1].data_ptr(),
                 out.data_ptr(), ncol, nz, int(cfg.iiwarm), dt, stream)
    if err != 0:
        raise RuntimeError(f"lookup_stage kernel launch failed: cudaError "
                           f"{err}")
    lookup_stage.launches += 1


def lookup_stage(state: ColumnState, pres, w1d, p8: dict, tables,
                 cfg: MicroConfig, dt_f: float, out=None) -> dict:
    """The phase-14 lookups of one aerosol-aware step for (ncol, nz)
    columns, from the raw state and kernel A's ``p8``: ``xnc_act`` and
    ``wev`` (``AUX_KEYS``), as views of the rows of ``out``, a contiguous
    (2, ncol, nz) tensor (a new one when None; in the step the last rows
    of ``post_out``'s).

    A CPU tensor runs ``lookup_stage_ref``; a CUDA tensor launches the
    kernel (float32 or float64) or raises.  ``pres`` and ``w1d`` may be
    any views that broadcast to the state's shape."""
    shape = state.qv.shape
    chans = ([getattr(state, k) for k in LOOKUP_STATE]
             + [torch.broadcast_to(t, shape) for t in (pres, w1d)]
             + [p8[k] for k in LOOKUP_P8])
    dev = cuda_build.same_device("lookup_stage", *chans)
    if dev.type == "cpu":
        return lookup_stage_ref(state, pres, w1d, p8, tables, cfg, dt_f,
                                out)
    if out is None:
        out = torch.empty((len(AUX_KEYS), *shape), dtype=state.qv.dtype,
                          device=dev)
    launch_lookup(chans, tables, out, cfg, dt_f)
    return dict(zip(AUX_KEYS, out))


lookup_stage.launches = 0


# ---- kernel B: phases 12-20 -----------------------------------------------

def post_out(state: ColumnState):
    """The last 17 rows of a new packed input of kernel B (see
    ``pack_post_inputs``), for kernel A's ``P8_OUT`` channels and the
    lookups to write into."""
    return cuda_build.tail_rows(N_STATE + 2, len(S.P8_OUT) + len(AUX_KEYS),
                                state.qv)


def pack_post_inputs(state: ColumnState, pres, dzq, p8: dict, aux: dict):
    """Kernel B's one contiguous input, (31, ncol, nz): the 12 state
    channels, pres, dzq, the 15 ``solver.P8_OUT`` channels, ``xnc_act``
    and ``wev``.  Where those 17 are the rows of ``post_out``, only the
    first 14 are copied, into the tensor those rows belong to."""
    return cuda_build.pack([*state, pres, dzq],
                           [p8[k] for k in S.P8_OUT]
                           + [aux[k] for k in AUX_KEYS], state.qv.shape)


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
