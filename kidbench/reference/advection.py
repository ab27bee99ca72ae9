"""Flux-form transport by the prescribed kinematic flow: the benchmark's
frozen copy of ``kid_tpu_torch/driver/advection.py``, unchanged, which
the reference runs in float64 on the CPU.

The KiD shell's ``d*_adv`` / ``d*_div`` tendencies (consumed at
mphys_thompson09n.f90:60-93): second-order MUSCL reconstruction with a van
Leer limiter on face mass fluxes rho0*w and rho0*u.  Vertically: zero flux
at the bottom and top, plus the 1-D divergence closure
``q * div(rho0 w)/rho0`` that turns the flux form into pure advection.
Horizontally (2-D cases): periodic in x; the stream-function fluxes are
exactly non-divergent, so there is no closure term.
"""
from __future__ import annotations

import torch


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
