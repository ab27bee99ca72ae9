"""The benchmark's inputs, made on the device from the seed: the KiD
case's initial state with noise, and the WRF-shaped tiles of synthetic
mixed-phase columns.  Both sides of the comparison get these same inputs.

The noise of every column is drawn once from a fixed seed (``BASE``) and
the run's seed deals these columns out in an order of its own: every
seed gets the same set of columns, and so the same work, in another
place."""
from __future__ import annotations

import numpy as np
import torch

from .reference.kid import FIELDS, R_ON_CP, KidCase

P0 = 1.0e5
BASE = 20120701         # the fixed seed of the columns' noise


def generator(seed: int, device, salt: int = 0) -> torch.Generator:
    """A generator on ``device`` seeded with ``seed`` (any whole number)
    and ``salt`` (which keeps draws for other ranks or tiles apart),
    taken modulo 2**64."""
    gen = torch.Generator(device=device)
    gen.manual_seed((int(seed) + salt * 0x9E3779B97F4A7C15) % 2 ** 64)
    return gen


def column_sample(seed: int, n_total: int, n: int, salt: int) -> np.ndarray:
    """``n`` distinct indices below ``n_total`` drawn from the seed,
    sorted; ``salt`` keeps each use's draw apart."""
    rng = np.random.default_rng([int(seed) % 2 ** 64, salt])
    return np.sort(rng.choice(n_total, size=min(n, n_total), replace=False))


def initial_state(ref: KidCase, cfg: dict, seed: int, dtype, device,
                  ncol: int = 0, salt: int = 0) -> tuple:
    """The case's initial state at (``ncol`` or nx, nz), as a tuple in
    ``FIELDS`` order: the sounding with each cell's theta shifted by
    ``theta_K`` times a normal draw and its qv scaled by 1 + ``qv_rel``
    times one (a rank's block draws with its own ``salt``)."""
    gen = generator(BASE, device, salt)
    shape = (ncol or ref.nx, ref.nz)
    order = torch.randperm(shape[0], generator=generator(seed, device, salt),
                           device=device)
    noise = cfg["noise"]
    prof = ref.initial_profiles()

    def draw():
        return torch.randn(shape, generator=gen, device=device,
                           dtype=torch.float64)[order]

    def full(p):
        return torch.as_tensor(p, dtype=torch.float64,
                               device=device).expand(shape)

    out = {f: full(prof[f]) for f in FIELDS}
    out["theta"] = out["theta"] + noise["theta_K"] * draw()
    out["qv"] = out["qv"] * (1.0 + noise["qv_rel"] * draw())
    return tuple(out[f].to(dtype).contiguous() for f in FIELDS)


def example_tile(spec: dict, cfg: dict, seed: int, index: int, dtype,
                 device) -> dict:
    """One (i, k, j) tile of the reference bench's synthetic mixed-phase
    columns (``kid_tpu_torch.bench.example_batch``, parameters in
    ``spec``): a standard-atmosphere sounding with cloud, rain, ice, snow
    and graupel layers, each column's field scaled by 1 + ``column_noise``
    times a normal draw, floored at 0.  Returns the call's inputs by name:
    (i, k, j) fields and (i, j) precip accumulators."""
    ni, nk, nj = cfg["tile"]
    gen = generator(BASE, device, salt=index + 1)
    order = torch.randperm(ni * nj, generator=generator(
        seed, device, salt=index + 1), device=device)

    def draw(n_per_column, rand=torch.randn):
        """(ni, n, nj) draws, a column's set dealt out by the seed."""
        base = rand((ni * nj, n_per_column), generator=gen, device=device,
                    dtype=torch.float64)[order]
        return base.reshape(ni, nj, n_per_column).transpose(1, 2)

    zc = (np.arange(nk) + 0.5) * (spec["ztop_m"] / nk)
    p = spec["p_surface_Pa"] * np.exp(-zc / spec["p_scale_m"])
    t = np.maximum(spec["t_surface_K"] - spec["lapse_K_per_m"] * zc,
                   spec["t_min_K"])
    qv = spec["qv_surface"] * np.exp(-zc / spec["qv_scale_m"])

    def layer(lo, hi, value):
        above = zc > lo if lo is not None else True
        below = zc < hi if hi is not None else True
        return np.where(above & below, value, 0.0)

    prof = {k: layer(*v) for k, v in spec["layers"].items()}
    prof["ni"] = np.where(prof["qi"] > 0, spec["ni_where_qi"], 0.0)
    prof["nr"] = np.where(prof["qr"] > 0, spec["nr_where_qr"], 0.0)
    prof.update(qv=qv, t=t)

    def column(a):
        return torch.as_tensor(a, dtype=torch.float64,
                               device=device)[None, :, None]

    def noised(a):
        scale = 1.0 + spec["column_noise"] * draw(1)
        return torch.clamp(column(a) * scale, min=0.0)

    shape = (ni, nk, nj)
    pii = column((p / P0) ** R_ON_CP).expand(shape)
    tile = {k: noised(prof[k]) for k in ("qv", "qc", "qr", "qi", "qs", "qg",
                                         "ni", "nr")}
    tile.update(th=noised(t) / pii, pii=pii, p=column(p).expand(shape),
                w=torch.zeros(shape, dtype=torch.float64, device=device),
                dz=torch.full(shape, spec["ztop_m"] / nk,
                              dtype=torch.float64, device=device))
    for k in ("rainnc", "snownc", "graupelnc"):
        tile[k] = spec["accumulated_m"] * draw(1, torch.rand)[:, 0]
    return {k: v.to(dtype).contiguous() for k, v in tile.items()}
