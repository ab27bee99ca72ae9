"""The table stage of the microphysics step as one hand-written CUDA kernel.

``table_stage`` computes ``solver._table_stage(*solver._prologue(state,
pres, cfg), tables, cfg, dt)``: phases 2-7, the lookup indices, the table
gathers and the rates that consume them, as the ``solver.tv_keys(cfg)``
channels that ``fused_step``, ``fused_rates`` and ``fused_kid_step`` read.
The reference runs these two stages (``kid_tpu/micro/solver.py:1132`` and
``:1350``) as plain XLA, which its ``jit`` fuses; here they are one
kernel, ``csrc/table_stage.cu``.

For a CUDA tensor the wrapper launches the kernel or raises; for a CPU
tensor it runs ``table_stage_ref``, the plain PyTorch version.  There is
no fallback between the two.  The kernel writes into ``out`` when the
caller gives it: the rows that a kernel's packed input ends with
(``tv_out`` of ``fused_step``, ``split_step`` and ``fused_kid_step``), so
that the packs copy only the state.  ``table_stage.launches`` counts the
launches; a CUDA graph's replay adds the launches its capture recorded
(``cuda_build.add_launches``).  The kernel reads no host value, so a
capture holds it.
"""
from __future__ import annotations

import ctypes

import torch

from .. import constants as c
from ..config import MicroConfig
from . import cuda_build
from . import solver as S
from .state import ColumnState

N_IN = len(ColumnState._fields) + 1      # the state channels, then pres
# the tables the kernel reads, in its order, and their shapes
TABLES = ("racs", "racg", "qrfz", "qcfz", "iaus", "t_efrw", "t_efsw")
TABLE_SHAPES = {
    "racs": (c.NTB_S * c.NTB_T * c.NTB_R1 * c.NTB_R, len(S._RACS)),
    "racg": (c.NTB_G1 * c.NTB_G * c.NTB_R1 * c.NTB_R, len(S._RACG)),
    "qrfz": (c.NTB_R * c.NTB_R1 * 45, len(S._QRFZ)),
    "qcfz": (len(S._QCFZ), c.NTB_C * 45),
    "iaus": (len(S._IAUS), c.NTB_I * c.NTB_I1),
    "t_efrw": (c.NBR, c.NBC), "t_efsw": (c.NBS, c.NBC)}
_ARGTYPES = [ctypes.POINTER(ctypes.c_void_p),
             ctypes.POINTER(ctypes.c_longlong),
             ctypes.POINTER(ctypes.c_void_p), ctypes.c_void_p,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_double, ctypes.c_double, ctypes.c_void_p]


def _check(state: ColumnState, pres, tables, cfg: MicroConfig, out):
    """Raise unless the inputs are (ncol, nz) float32 or float64 channels
    on one device with its tables and ``out`` (None, or a contiguous
    (ntv, ncol, nz) tensor there).  Returns the input channels, each a
    (ncol, nz) view (pres may be broadcast), and the device."""
    tabs = [getattr(tables, k) for k in TABLES]
    dev = cuda_build.same_device("table_stage", *state, pres, *tabs)
    if state.qv.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"table_stage takes float32 or float64, not "
                        f"{state.qv.dtype}")
    shape = state.qv.shape
    if len(shape) != 2:
        raise ValueError(f"table_stage takes (ncol, nz) columns, got "
                         f"{tuple(shape)}")
    chans = [torch.broadcast_to(t, shape) for t in (*state, pres)]
    if out is not None:
        _check_out(out, chans[0], cfg)
    return chans, dev


def _check_out(out, x, cfg: MicroConfig):
    """Raise unless ``out`` is a contiguous (ntv, *x.shape) tensor of
    ``x``'s dtype and device."""
    want = (len(S.tv_keys(cfg)), *x.shape)
    if (tuple(out.shape) != want or out.dtype != x.dtype
            or out.device != x.device or not out.is_contiguous()):
        raise ValueError(f"out must be a contiguous {want} tensor of the "
                         f"inputs' dtype and device")


def table_stage_ref(state: ColumnState, pres, tables, cfg: MicroConfig,
                    dt_f: float, out=None) -> dict:
    """The plain PyTorch version of the kernel on any device: the tv dict
    of ``solver._table_stage(*solver._prologue(...))``, copied into the
    rows of ``out`` (and returned as views of them) when given."""
    tv = S._table_stage(*S._prologue(state, pres, cfg), tables, cfg, dt_f)
    if out is None:
        return tv
    keys = S.tv_keys(cfg)
    for row, k in zip(out, keys):
        row.copy_(tv[k])
    return dict(zip(keys, out))


def launch(chans, tables, out, cfg: MicroConfig, dt_f: float):
    """Launch the kernel on the 13 input channels ``chans`` (ColumnState's,
    then pres, each (ncol, nz) with any strides) and the device
    ``tables``, writing the tv channels into ``out``, (ntv, ncol, nz)
    contiguous, on the current stream without synchronising."""
    x = chans[0]
    if x.device.type != "cuda":
        raise ValueError(f"table_stage launches on a CUDA tensor, got "
                         f"{x.device}")
    cuda_build.same_device("table_stage", *chans,
                           *[getattr(tables, k) for k in TABLES])
    if len(chans) != N_IN or any(t.shape != x.shape for t in chans):
        raise ValueError(f"table_stage takes {N_IN} (ncol, nz) channels")
    _check_out(out, x, cfg)
    ncol, nz = x.shape
    if not 2 <= nz <= cuda_build.MAX_NZ or ncol < 1:
        raise ValueError(f"table_stage takes 2 <= nz <= {cuda_build.MAX_NZ} "
                         f"and ncol >= 1, got ({ncol}, {nz})")
    for k in TABLES:
        t = getattr(tables, k)
        if tuple(t.shape) != TABLE_SHAPES[k] or not t.is_contiguous():
            raise ValueError(f"table {k} must be a contiguous "
                             f"{TABLE_SHAPES[k]} tensor")
    fn = cuda_build.kernel_function("table_stage", x.dtype, _ARGTYPES)
    ptrs = (ctypes.c_void_p * N_IN)(*[t.data_ptr() for t in chans])
    strides = (ctypes.c_longlong * (2 * N_IN))(
        *[s for t in chans for s in t.stride()])
    tabs = (ctypes.c_void_p * len(TABLES))(
        *[getattr(tables, k).data_ptr() for k in TABLES])
    dt, _ = S._dt_pair(dt_f, x.dtype)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        err = fn(ptrs, strides, tabs, out.data_ptr(), ncol, nz,
                 int(cfg.iiwarm), int(cfg.is_aerosol_aware),
                 float(cfg.nt_c), dt, stream)
    if err != 0:
        raise RuntimeError(f"table_stage kernel launch failed: cudaError "
                           f"{err}")
    table_stage.launches += 1


def table_stage(state: ColumnState, pres, tables, cfg: MicroConfig,
                dt_f: float, out=None) -> dict:
    """The ``solver.tv_keys(cfg)`` channels of one microphysics step for
    (ncol, nz) columns, as views of the rows of ``out``, an (ntv, ncol,
    nz) tensor (a new one when None).

    A CPU tensor runs ``table_stage_ref``; a CUDA tensor launches the
    kernel (float32 or float64, nz <= 256) or raises.  ``pres`` may be
    any view that broadcasts to the state's shape."""
    chans, dev = _check(state, pres, tables, cfg, out)
    if dev.type == "cpu":
        return table_stage_ref(state, pres, tables, cfg, dt_f, out)
    keys = S.tv_keys(cfg)
    if out is None:
        out = torch.empty((len(keys), *state.qv.shape), dtype=state.qv.dtype,
                          device=dev)
    launch(chans, tables, out, cfg, dt_f)
    return dict(zip(keys, out))


table_stage.launches = 0
