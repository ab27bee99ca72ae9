"""WRF/MPAS-shaped host adapter: the ``mp_gt_driver`` API (twin of
``kid_tpu/driver/wrf_adapter.py``).

The reference keeps a 3-D (i,k,j) driver as the WRF-facing API
(module_mp_thompson09n.f90:806-1143).  This is its PyTorch twin:

  * accepts WRF-layout (i,k,j) tensors, flattens (i,j) into the batched
    column axis, runs the column solver once (``fused_step`` on the card),
    restores the layout;
  * maintains the precip accumulators RAINNC/RAINNCV/SNOWNC/GRAUPELNC and
    the snow ratio SR (f90:979-993);
  * applies the negative-qv repair: negative vapor is replaced by the
    neighbor-level average, floored at 1e-7 (f90:1095-1106);
  * optional effective-radius diagnostics (f90:1109-1122).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .. import spans
from ..config import MicroConfig
from ..device import check_on, resolve_device
from ..diag.moments import effective_radii
from ..micro import ColumnState, batched_microphysics
from ..micro.solver import DeviceTables


class WrfPrecip(NamedTuple):
    rainnc: torch.Tensor      # accumulated total precip (i, j)
    rainncv: torch.Tensor     # this-step total precip (i, j)
    snownc: torch.Tensor
    snowncv: torch.Tensor
    graupelnc: torch.Tensor
    graupelncv: torch.Tensor
    sr: torch.Tensor          # frozen-fraction "snow ratio" (i, j)


def _ikj_to_cols(a):
    """(i, k, j) -> (i*j, k)."""
    return torch.movedim(a, 1, -1).reshape(-1, a.shape[1])


def _cols_to_ikj(a, ni, nj):
    """(i*j, k) -> a contiguous (i, k, j) tensor."""
    return torch.movedim(a.reshape(ni, nj, a.shape[-1]), -1, 1).contiguous()


def _repair_negative_qv(qv):
    """Negative vapor of (ncol, nz) columns replaced by the neighbor-level
    mean, floored at 1e-7 (f90:1095-1106)."""
    qv_up = torch.cat([qv[:, 1:], qv[:, -1:]], 1)
    qv_dn = torch.cat([qv[:, :1], qv[:, :-1]], 1)
    qv_fix = torch.clamp(0.5 * (qv_up + qv_dn), min=1.0e-7)
    return torch.where(qv < 0.0, qv_fix, qv)


def mp_driver_3d(qv, qc, qr, qi, qs, qg, ni, nr, th, pii, p, w, dz,
                 dt, rainnc, snownc, graupelnc,
                 tables: DeviceTables, cfg: MicroConfig,
                 want_eff_rad: bool = False, device="cuda",
                 graphs: bool = True):
    """One microphysics step on a WRF-shaped (i, k, j) tile on ``device``.

    Args mirror mp_gt_driver's signature (f90:806-820): mixing ratios and
    numbers (i,k,j); ``th`` potential temperature; ``pii`` Exner; pressure,
    vertical velocity, layer thickness; accumulators (i,j).  Every tensor
    must lie on ``device``; raises without a GPU unless ``device="cpu"``.
    The reference compiles the whole call (``jax.jit``): on a card, with
    ``graphs``, it is captured as a CUDA graph once per (the tile's
    shapes, dtype, device, ``cfg``, ``dt``, ``want_eff_rad``, tables) and
    replayed (``micro.graphs.run``; ``graphs=False`` and the CPU run it
    eagerly).  A failed capture raises.

    Returns (fields dict, WrfPrecip, effective radii dict or None), the
    caller's own.  The call is the span ``kid.mp_driver_3d``.
    """
    from ..micro import graphs as G
    with spans.span("kid.mp_driver_3d"):
        dev = resolve_device(device)
        args = (qv, qc, qr, qi, qs, qg, ni, nr, th, pii, p, w, dz, rainnc,
                snownc, graupelnc)
        for a in args:
            check_on(a, dev)
        dt_f = float(dt)

        def body(*a):
            return _mp_driver_body(*a, dt_f, tables, cfg, want_eff_rad)

        return G.run(body, args, ("mp_driver_3d", cfg, dt_f, want_eff_rad,
                                  id(tables)), graphs)


def _mp_driver_body(qv, qc, qr, qi, qs, qg, ni, nr, th, pii, p, w, dz,
                    rainnc, snownc, graupelnc, dt, tables, cfg,
                    want_eff_rad):
    """``mp_driver_3d``'s step, eagerly: the layout moves, the column
    solver's body, the vapor repair, the accumulators and the radii."""
    ni_, nk, nj = qv.shape
    cols = _ikj_to_cols
    t_cols = cols(th) * cols(pii)                      # f90:937
    qv_c = cols(qv)
    p_c = cols(p)
    rho = 0.622 * p_c / (287.04 * t_cols * (qv_c + 0.622))
    state = ColumnState(
        t=t_cols, qv=qv_c, qc=cols(qc), qi=cols(qi), qr=cols(qr),
        qs=cols(qs), qg=cols(qg), ni=cols(ni), nr=cols(nr),
        # non-aerosol-aware defaults (f90:957-964)
        nc=cfg.nt_c / rho, nwfa=11.1e6 / rho,
        nifa=0.5e6 * 0.01 / rho)
    # the rate profiles are not returned, so the kernel skips them
    out, ppt, _ = batched_microphysics(
        state, p_c, cols(w), cols(dz), dt, tables, cfg, want_rates=False,
        device=p_c.device, graphs=False)

    qv_new = _repair_negative_qv(out.qv)
    fields = {
        "qv": _cols_to_ikj(qv_new, ni_, nj),
        "qc": _cols_to_ikj(out.qc, ni_, nj),
        "qr": _cols_to_ikj(out.qr, ni_, nj),
        "qi": _cols_to_ikj(out.qi, ni_, nj),
        "qs": _cols_to_ikj(out.qs, ni_, nj),
        "qg": _cols_to_ikj(out.qg, ni_, nj),
        "ni": _cols_to_ikj(out.ni, ni_, nj),
        "nr": _cols_to_ikj(out.nr, ni_, nj),
        "th": _cols_to_ikj(out.t, ni_, nj) / pii,
    }

    # precip accumulators (f90:979-993)
    shp = (ni_, nj)
    p_ra = ppt.rain.reshape(shp)
    p_sn = ppt.snow.reshape(shp)
    p_gr = ppt.graupel.reshape(shp)
    p_ic = ppt.ice.reshape(shp)
    rainncv = p_ra + p_sn + p_gr + p_ic
    precip = WrfPrecip(
        rainnc=rainnc + rainncv, rainncv=rainncv,
        snownc=snownc + p_sn + p_ic, snowncv=p_sn + p_ic,
        graupelnc=graupelnc + p_gr, graupelncv=p_gr,
        sr=(p_sn + p_gr + p_ic) / (rainncv + 1.0e-12))

    eff = None
    if want_eff_rad:
        re_qc, re_qi, re_qs = effective_radii(
            out.t, p_c, qv_new, out.qc, out.nc, out.qi, out.ni, out.qs,
            cfg.nt_c, cfg.is_aerosol_aware)
        eff = {"re_cloud": _cols_to_ikj(
                   torch.clamp(re_qc, 2.49e-6, 50.0e-6), ni_, nj),
               "re_ice": _cols_to_ikj(
                   torch.clamp(re_qi, 4.99e-6, 125.0e-6), ni_, nj),
               "re_snow": _cols_to_ikj(
                   torch.clamp(re_qs, 9.99e-6, 999.0e-6), ni_, nj)}
    return fields, precip, eff
