"""Flux-form transport by the prescribed kinematic flow (twin of
``kid_tpu/driver/advection.py``).

The KiD shell's ``d*_adv`` / ``d*_div`` tendencies (consumed at
mphys_thompson09n.f90:60-93): second-order MUSCL reconstruction with a van
Leer limiter on face mass fluxes rho0*w and rho0*u.  Vertically: zero flux
at the bottom and top, plus the 1-D divergence closure
``q * div(rho0 w)/rho0`` that turns the flux form into pure advection.
Horizontally (2-D cases): periodic in x; the stream-function fluxes are
exactly non-divergent, so there is no closure term.

``advect`` is the driver step's whole transport, its provisional state
and the head of the microphysics' packed input as one hand-written CUDA
kernel (``micro/csrc/advect.cu``), beside its plain version
``advect_ref``, the torch composition of the functions above.  The
reference leaves that code to XLA, which fuses it under ``jit``
(``kid_tpu/driver/loop.py:230-262``); the kernel is the port's
counterpart of that fusion.  For a CUDA tensor the wrapper launches the
kernel or raises; for a CPU tensor it runs the plain version.  There is
no fallback between the two.  ``advect.launches`` counts the launches; a
CUDA graph's replay adds the launches its capture recorded
(``cuda_build.add_launches``).  The kernel reads m(t) on the card, so a
captured launch reads each replay's m.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from ..micro import cuda_build


def _zero_end_faces(flux):
    """Zero the bottom/top boundary faces (zero-flux boundary)."""
    n = flux.shape[-1]
    kk = torch.arange(n, device=flux.device)
    return torch.where((kk == 0) | (kk == n - 1), 0.0, flux)


def _vanleer(r):
    """van Leer limiter phi(r) = (r + |r|) / (1 + |r|)."""
    return (r + torch.abs(r)) / (1.0 + torch.abs(r))


def _muscl_face_values(qpad, vel_face):
    """MUSCL face values along the last axis: ``qpad`` (..., n+2) cells
    with one ghost each side, ``vel_face`` (..., n+1) face fluxes; returns
    the (..., n+1) upwind face values."""
    dq = torch.diff(qpad, dim=-1)                      # (..., n+1)
    zero = torch.zeros_like(qpad[..., :1])
    dq_m = torch.cat([zero, dq], -1)                   # q_i - q_{i-1}
    dq_p = torch.cat([dq, zero], -1)                   # q_{i+1} - q_i
    eps = 1e-30
    r_up = dq_m / torch.where(torch.abs(dq_p) > eps, dq_p, eps)
    r_dn = dq_p / torch.where(torch.abs(dq_m) > eps, dq_m, eps)
    slope_up = _vanleer(r_up) * dq_p
    slope_dn = _vanleer(r_dn) * dq_m
    q_left = (qpad + 0.5 * slope_up)[..., :-1]         # donor cell i
    q_right = (qpad - 0.5 * slope_dn)[..., 1:]         # donor cell i+1
    return torch.where(vel_face >= 0.0, q_left, q_right)


def advective_tendency_z(q, rhow_face, rho0, dz):
    """d(q)/dt = -(1/rho0) d(F_z q)/dz, F_z = rho0*w at z-faces.

    Args:
      q:         (..., nz) tracer.
      rhow_face: (..., nz+1) vertical mass flux at faces.
      rho0:      (nz,) basic-state density at centers.
      dz:        (nz,) layer thickness.
    """
    qpad = torch.cat([q[..., :1], q, q[..., -1:]], -1)
    qf = _muscl_face_values(qpad, rhow_face)
    flux = _zero_end_faces(rhow_face * qf)
    return -(flux[..., 1:] - flux[..., :-1]) / (rho0 * dz)


def divergence_tendency_z(q, rhow_face, rho0, dz):
    """KiD 1-D mass-compensation term d*_div = q * div(rho0 w)/rho0."""
    flux = _zero_end_faces(rhow_face)
    return q * (flux[..., 1:] - flux[..., :-1]) / (rho0 * dz)


def advective_tendency_x_padded(q_padded, rhou_face, rho0, dx):
    """x-transport of a tracer padded with 2 ghost columns each side.

    Args:
      q_padded:  (..., ncol+4, nz) tracer, ghosts filled periodically (or
                 by a halo exchange when the columns are split).
      rhou_face: (ncol+1, nz) horizontal mass flux at the local x-faces.
      rho0:      (nz,) center density.
      dx:        scalar spacing.
    """
    qx = torch.movedim(q_padded, -2, -1)               # (..., nz, ncol+4)
    fx = rhou_face.transpose(0, 1)                     # (nz, ncol+1)
    fx_ext = torch.cat([fx[..., :1], fx, fx[..., -1:]], -1)
    qf = _muscl_face_values(qx, fx_ext)[..., 1:-1]
    flux = fx * qf
    ten = -(flux[..., 1:] - flux[..., :-1]) / (rho0[:, None] * dx)
    return torch.movedim(ten, -1, -2)


def advective_tendency_x(q, rhou_face, rho0, dx):
    """d(q)/dt = -(1/rho0) d(F_x q)/dx, F_x = rho0*u at x-faces; periodic.

    Args:
      q:         (ncol, nz) tracer.
      rhou_face: (ncol+1, nz) horizontal mass flux at x-faces
                 (rhou_face[0] == rhou_face[ncol], the periodic face).
      rho0:      (nz,) center density.
      dx:        scalar spacing.

    2 ghost cells per side give every retained face a full MUSCL stencil,
    so both copies of the periodic face get the same flux.
    """
    qpad = torch.cat([q[-2:], q, q[:2]], 0)
    return advective_tendency_x_padded(qpad, rhou_face, rho0, dx)


# ---- the step's transport as one kernel -----------------------------------

N_KID = 12                     # KidState's channels
# the row of the microphysics' packed input, in ColumnState order (t qv
# qc qi qr qs qg ni nr nc nwfa nifa), that each KidState channel (theta
# qv qc qr nr qi ni qs qg nc nwfa nifa) fills; theta's row holds T
HEAD_ROWS = (0, 1, 2, 4, 8, 3, 7, 5, 6, 9, 10, 11)
# the head's rows: the 12 state channels and pres, then dzq for fused_step
HEAD_SIZES = (N_KID + 1, N_KID + 2)
# the advected sets: warm, mixed phase, aerosol-aware (the first n
# KidState channels, loop.advected_fields)
N_ADVECTED = (5, 9, 12)
_ARGTYPES = [ctypes.POINTER(ctypes.c_void_p),
             ctypes.POINTER(ctypes.c_longlong), ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, ctypes.c_int, ctypes.c_double, ctypes.c_double,
             ctypes.c_double, ctypes.c_void_p]


class Transport(NamedTuple):
    """What a step's transport reads besides the state and m(t), on the
    state's device and in its dtype.

    ``ghosts`` (2-D only) says where the 2 ghost columns a side come from:
    None for the periodic wrap of the block's own columns, or an object
    whose ``left`` and ``right`` are (n_adv, 2, nz) tensors, the tracers
    in ``loop.advected_fields`` order (a rank's ``dist.mesh.Halo``)."""

    w_pat: torch.Tensor            # (ncol, nz+1) rho0*w' at z-faces
    u_pat: Optional[torch.Tensor]  # (ncol+1, nz) rho0*u' at x-faces; 1-D None
    rho0: torch.Tensor             # (nz,) centre density
    dz: torch.Tensor               # (nz,) layer thickness
    exner: torch.Tensor            # (nz,) or (1, nz)
    pres: torch.Tensor             # broadcasts to (ncol, nz)
    u0: float                      # background wind, m/s
    dx: float                      # x spacing, m
    dt: float                      # step, s
    ghosts: object = None


def ghost_padded(q, ghosts):
    """(n_adv, ncol, nz) -> (n_adv, ncol+4, nz): 2 ghost columns a side,
    from the periodic wrap (``ghosts`` None) or ``ghosts.left`` and
    ``.right``."""
    if ghosts is None:
        return torch.cat([q[:, -2:], q, q[:, :2]], 1)
    return torch.cat([ghosts.left, q, ghosts.right], 1)


def advect_ref(st, m, tr: Transport, n_adv: int, out, theta_out=None):
    """The plain PyTorch version of the kernel on any device: the torch
    composition of the step's transport, its rows written into ``out``
    (see ``advect``).  ``m`` may be a float or a 0-d tensor."""
    q = torch.stack(list(st[:n_adv]))
    w_face = m * tr.w_pat                        # rho0*w at z-faces
    # 1-D: flux form plus the divergence closure; 2-D: the stream-function
    # fluxes are non-divergent, so x-advection instead
    ten = advective_tendency_z(q, w_face, tr.rho0, tr.dz)
    if tr.u_pat is None:
        ten = ten + divergence_tendency_z(q, w_face, tr.rho0, tr.dz)
    else:
        u_face = tr.u0 * tr.rho0[None, :] + m * tr.u_pat
        ten = ten + advective_tendency_x_padded(ghost_padded(q, tr.ghosts),
                                                u_face, tr.rho0, tr.dx)
    prov = q + ten * tr.dt
    for c, row in enumerate(HEAD_ROWS):
        out[row].copy_(prov[c] if c < n_adv else st[c])
    out[0].copy_(prov[0] * tr.exner)
    out[N_KID].copy_(tr.pres)
    if len(out) > N_KID + 1:
        out[N_KID + 1].copy_(tr.dz)
    if theta_out is not None:
        theta_out.copy_(prov[0])
    return out


def _check(st, m, tr: Transport, n_adv: int, out, theta_out):
    """Raise unless the arguments are what ``advect`` takes; returns the
    device."""
    if len(st) != N_KID or n_adv not in N_ADVECTED:
        raise ValueError(f"advect takes the {N_KID} KidState channels and "
                         f"{'/'.join(map(str, N_ADVECTED))} advected ones")
    x = st[0]
    if x.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"advect takes float32 or float64, not {x.dtype}")
    if x.dim() != 2:
        raise ValueError(f"advect takes (ncol, nz) columns, got "
                         f"{tuple(x.shape)}")
    ncol, nz = x.shape
    two_d = tr.u_pat is not None
    if not 2 <= nz <= cuda_build.MAX_NZ or ncol < (2 if two_d else 1):
        raise ValueError(f"advect takes 2 <= nz <= {cuda_build.MAX_NZ} and "
                         f"ncol >= {2 if two_d else 1}, got ({ncol}, {nz})")
    ghosts = ([tr.ghosts.left, tr.ghosts.right]
              if two_d and tr.ghosts is not None else [])
    flows = [tr.w_pat] + ([tr.u_pat] if two_d else [])
    extra = [t for t in (theta_out,) if t is not None]
    if torch.is_tensor(m):
        extra.append(m)
    dev = cuda_build.same_device("advect", *st, *flows, tr.rho0, tr.dz,
                                 tr.exner, tr.pres, *ghosts, out, *extra)
    want = {"w_pat": (ncol, nz + 1), "u_pat": (ncol + 1, nz)}
    for name, t in zip(want, flows):
        if tuple(t.shape) != want[name]:
            raise ValueError(f"{name} must be {want[name]}, got "
                             f"{tuple(t.shape)}")
    if any(tuple(t.shape) != (ncol, nz) for t in st):
        raise ValueError("the state channels must share one (ncol, nz) shape")
    for name in ("rho0", "dz", "exner"):
        if getattr(tr, name).numel() != nz:
            raise ValueError(f"{name} must hold nz = {nz} values")
    torch.broadcast_to(tr.pres, (ncol, nz))   # raises unless it broadcasts
    if any(tuple(t.shape) != (n_adv, 2, nz) for t in ghosts):
        raise ValueError(f"the ghost columns must be ({n_adv}, 2, {nz})")
    if (out.dim() != 3 or out.shape[0] not in HEAD_SIZES
            or tuple(out.shape[1:]) != (ncol, nz) or not out.is_contiguous()):
        raise ValueError(f"out must be a contiguous (13 or 14, {ncol}, {nz}) "
                         f"tensor")
    if theta_out is not None and (tuple(theta_out.shape) != (ncol, nz)
                                  or not theta_out.is_contiguous()):
        raise ValueError(f"theta_out must be a contiguous ({ncol}, {nz}) "
                         f"tensor")
    return dev


def _strides(t) -> tuple:
    """(channel, column, level) element strides of an input of the kernel
    (None: a null pointer): a 3-D tensor's own, an (ncol, nz) view's
    behind a 0, a profile's level stride."""
    if t is None or t.dim() == 0:
        return (0, 0, 0)
    if t.dim() == 1:
        return (0, 0, t.stride(0))
    return ((0,) * (3 - t.dim())) + tuple(t.stride())


def launch(st, m, tr: Transport, n_adv: int, out, theta_out=None):
    """Launch the kernel on the current stream, without synchronising (the
    arguments as ``advect`` takes them; ``m`` a one-element tensor of the
    state's dtype on its card, which the kernel reads there)."""
    x = st[0]
    if x.device.type != "cuda":
        raise ValueError(f"advect launches on a CUDA tensor, got {x.device}")
    if (not torch.is_tensor(m) or m.numel() != 1 or m.dtype != x.dtype
            or m.device != x.device):
        raise ValueError("m must be one value of the state's dtype on its "
                         "device")
    ncol, nz = x.shape
    two_d = tr.u_pat is not None
    left = right = None
    if two_d and tr.ghosts is not None:
        left, right = tr.ghosts.left, tr.ghosts.right
    # in the order of the kernel's AdvIn
    inputs = [*st, tr.w_pat, tr.u_pat if two_d else None,
              torch.broadcast_to(tr.pres, (ncol, nz)), left, right, tr.rho0,
              tr.dz, tr.exner, m.reshape(())]
    ptrs = (ctypes.c_void_p * len(inputs))(
        *[None if t is None else t.data_ptr() for t in inputs])
    strides = (ctypes.c_longlong * (3 * len(inputs)))(
        *[v for t in inputs for v in _strides(t)])
    fn = cuda_build.kernel_function("advect", x.dtype, _ARGTYPES)
    theta_ptr = None if theta_out is None else theta_out.data_ptr()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        err = fn(ptrs, strides, out.data_ptr(), theta_ptr, out.shape[0],
                 ncol, nz, n_adv, int(two_d), float(tr.u0), float(tr.dx),
                 float(tr.dt), stream)
    if err != 0:
        raise RuntimeError(f"advect kernel launch failed: cudaError {err}")
    advect.launches += 1


def advect(st, m, tr: Transport, n_adv: int, out, theta_out=None):
    """One step's transport of the first ``n_adv`` channels of the
    ``KidState`` ``st`` (each (ncol, nz), any strides) at m(t) = ``m``.

    Writes into ``out``, a contiguous (13 or 14, ncol, nz) tensor, the
    head of the microphysics' packed input: the provisional state in
    ``ColumnState`` order (T = theta*exner, then the provisional or
    passed-through channels), pres and, with 14 rows, dzq; and into
    ``theta_out``, if given, the provisional theta.  A CPU tensor runs
    ``advect_ref``; a CUDA tensor launches the kernel (float32 or
    float64, nz <= 256, ``m`` a 0-d tensor on the card) or raises.
    Returns ``out``."""
    dev = _check(st, m, tr, n_adv, out, theta_out)
    if dev.type == "cpu":
        return advect_ref(st, m, tr, n_adv, out, theta_out)
    launch(st, m, tr, n_adv, out, theta_out)
    return out


advect.launches = 0
