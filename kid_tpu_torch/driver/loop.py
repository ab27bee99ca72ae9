"""KiD time loop: prescribed-flow advection -> microphysics -> update
(twin of ``kid_tpu/driver/loop.py``, 1-D and 2-D cases).

The adapter contract of mphys_thompson09n.f90:28-310 is kept:

  * microphysics sees the provisional state ``x + (adv + div)*dt``
    (mphys_thompson09n.f90:60-93);
  * theta <-> T through the fixed Exner profile (:60-61);
  * the microphysics output becomes the new state (the final update
    ``x + (adv + div + mphys)*dt`` telescopes, :198-245).

The reference compiles its loop (``jax.jit`` over ``lax.scan``,
kid_tpu/driver/loop.py:306-334).  Here the step is one function of static
device buffers (``StepLoop.advance``) that reads no host value: m(t) comes
from a device table at a device step counter, and the per-step precip and
profile streams go into a chunk buffer at that counter.  The m table is
computed on the host (``Case.modulation_table``, in the state's dtype as
the reference rounds it) and uploaded once a chunk of ``CHUNK_STEPS``
steps; the streams are copied out once a chunk.  On a CUDA device
``simulate`` captures the step once as a CUDA graph and replays it, one
replay a step; on the CPU, and on a card with ``graphs=False``, the same
step runs eagerly.  ``BLOCKS`` keeps, for each case and column block,
the flow patterns, built once, and the step last captured on them, keyed
on what the reference's ``jit`` makes static.  A sharded run
(``dist/mesh.py``) exchanges its halo as the first op of the step, so
that one replay is one whole step, as the reference's ``shard_map`` holds
its exchange inside its compiled program; only an exchange staged through
the host (gloo with CUDA tensors: a CUDA graph cannot hold it) runs on the
host between two steps, into ghost buffers that the step reads.
"""
from __future__ import annotations

import os
import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from .. import constants as c
from .. import spans
from ..device import check_on, resolve_device
from ..micro import ColumnState, column_microphysics, cuda_build
from ..micro.graphs import GRAPH_DEVICE_TYPES, LRUCache, capture
from ..micro.solver import device_tables, tv_keys
from ..tables.cache import get_tables
from . import advection
from .cases import Case

# The opt-in fused driver step (micro/fused_kid_step.py) for 1-D,
# non-aerosol cases: set to "1" to turn it on.
FUSED_DRIVER_ENV = "KID_TPU_TORCH_FUSED_DRIVER"
# steps of a chunk: m(t) is uploaded, and the streams copied out, once a
# chunk
CHUNK_STEPS = 16
# column blocks kept (``BLOCKS``), each with its flow and at most one
# captured step, which holds its step's intermediates on the card
BLOCK_CACHE_SIZE = 4
N_STATE = len(ColumnState._fields)


class KidState(NamedTuple):
    """Driver prognostics, all (nx, nz).  nc/nwfa/nifa are carried like
    the other tracers; in non-aerosol mode the solver forces nc itself and
    nothing reads nwfa, which drifts inertly (see the reference package)."""

    theta: torch.Tensor
    qv: torch.Tensor
    qc: torch.Tensor
    qr: torch.Tensor
    nr: torch.Tensor
    qi: torch.Tensor
    ni: torch.Tensor
    qs: torch.Tensor
    qg: torch.Tensor
    nc: torch.Tensor
    nwfa: torch.Tensor
    nifa: torch.Tensor


class StepOutputs(NamedTuple):
    """Per-step diagnostic streams, stacked over a leading time axis."""

    ppt_rain: torch.Tensor      # (n_steps, nx) surface precip per step
    ppt_snow: torch.Tensor
    ppt_graupel: torch.Tensor
    ppt_ice: torch.Tensor
    profiles: dict              # name -> (n_steps, nx, nz)


# the wrapper's microphysics-tendency back-outs (mphys_thompson09n.f90:
# 198-245): (micro_out - provisional)/dt
MPHYS_TENDENCY_NAMES = (
    "dtheta_mphys", "dqv_mphys", "dqc_mphys", "dqr_mphys", "dnr_mphys",
    "dqi_mphys", "dni_mphys", "dqs_mphys", "dqg_mphys")

# the solver's 36 per-level process-rate streams
# (module_mp_thompson09n.f90:2963-3124); keys of the solver diag dict
RATE_NAMES = (
    "prr_wau", "prr_rcw", "prv_rev", "pnr_wau", "pnr_rev", "pnr_rcr",
    "pri_inu", "pri_ide", "prs_ide", "prs_sde", "prg_gde", "pri_wfz",
    "prs_scw", "prg_scw", "prg_gcw", "pri_ihm", "pri_rfz", "prs_iau",
    "prs_sci", "pri_rci", "pni_inu", "pni_ihm", "pni_wfz", "pni_rfz",
    "pni_ide", "pni_iau", "pni_sci", "pni_rci", "prr_sml", "prr_gml",
    "pnr_rcs", "pnr_rcg", "pnr_rci", "pnr_sml", "pnr_gml", "pnr_rfz")

ALL_PROFILE_NAMES = KidState._fields + RATE_NAMES + MPHYS_TENDENCY_NAMES


def resolve_profile_names(profile_diags) -> tuple:
    """``False``/``()`` -> no streams; ``True`` -> every stream; a tuple
    of names selects those streams."""
    if profile_diags is True:
        return ALL_PROFILE_NAMES
    if not profile_diags:
        return ()
    names = tuple(profile_diags)
    unknown = [n for n in names if n not in ALL_PROFILE_NAMES]
    if unknown:
        raise ValueError(f"unknown diagnostic streams: {unknown}")
    return names


def initial_state(case: Case, dtype=torch.float64, device="cuda") -> KidState:
    """The case's initial sounding on ``device``, dry and cloud-free."""
    dev = resolve_device(device)
    grid = case.grid()
    shape = (case.nx, case.nz)
    nc0 = case.micro.nt_c / grid.rho0
    nwfa0 = (case.nwfa_init(grid.z) if case.nwfa_init is not None
             else 11.1e6 / grid.rho0)
    nifa0 = (case.nifa_init(grid.z) if case.nifa_init is not None
             else c.NA_IN1 * 0.01 / grid.rho0)

    def bcast(p):
        return torch.as_tensor(np.broadcast_to(p, shape).copy(),
                               dtype=dtype).to(dev)

    z = torch.zeros(shape, dtype=dtype, device=dev)
    return KidState(
        theta=bcast(case.theta_init(grid.z)), qv=bcast(case.qv_init(grid.z)),
        qc=z, qr=z, nr=z, qi=z, ni=z, qs=z, qg=z,
        nc=bcast(nc0), nwfa=bcast(nwfa0), nifa=bcast(nifa0))


def advected_fields(cfg) -> tuple:
    """The tracers the kinematic shell advects: the 9 scheme fields
    (mphys_thompson09n.f90:198-245), without the identically-zero ice
    species in warm-only cases; nc/nwfa/nifa only in aerosol mode."""
    if cfg.is_aerosol_aware:
        return KidState._fields
    if cfg.iiwarm:
        return ("theta", "qv", "qc", "qr", "nr")
    return ("theta", "qv", "qc", "qr", "nr", "qi", "ni", "qs", "qg")


def make_step(case: Case, tables, dtype, device, w_pat, u_pat_faces, pres2,
              ghosts, profile_names: tuple):
    """The per-step function (advect -> microphysics -> update).

    Args:
      w_pat:       (nx, nz+1) rho0*w z-face pattern.
      u_pat_faces: (nx+1, nz) rho0*u' x-face pattern; None for 1-D cases.
      pres2:       (nx, nz) pressure.
      ghosts:      where the 2 ghost columns a side of a 2-D case come
                   from: None for the periodic wrap, or the block's
                   ``dist.mesh.Halo``, whose buffers an exchange fills
                   before the step reads them; unused for 1-D cases.
      profile_names: from ``resolve_profile_names``.
    Returns ``step(state, m) -> (new state, (4, nx) precip, profiles)``,
    with ``m`` the time modulation m(t) as a 0-d tensor of ``dtype`` on
    ``device``: the step reads no host value.

    The transport, the provisional state and the head of the
    microphysics' packed input are one call of ``advection.advect`` (on a
    card one kernel), which writes into the rows of the first
    microphysics kernel's input; the table stage writes its tail, and the
    kernel reads it as it lies (``solver.column_microphysics``'s
    ``packed``)."""
    dev = resolve_device(device)
    grid = case.grid()

    def prof(a):
        return torch.as_tensor(a, dtype=dtype).to(dev)

    dz = prof(grid.dz)
    rho0 = prof(grid.rho0)
    rho_face = torch.cat([rho0[:1], 0.5 * (rho0[1:] + rho0[:-1]),
                          rho0[-1:]])
    exner = prof(grid.exner)[None, :]
    dzq2 = torch.broadcast_to(dz, pres2.shape)
    dt = case.dt
    odt = 1.0 / dt
    cfg = case.micro
    want_rates = any(n in RATE_NAMES for n in profile_names)
    # The fused driver step (advection of all 12 channels, provisional
    # state, Exner map and phases 2-20 in one kernel) is opt-in, as in the
    # reference, which measured it slower than the default there.  It
    # advects in z only, so 2-D cases never take it.  The table stage
    # still reads this step's provisional state, built from
    # ``advected_fields`` only, so nc/nwfa/nifa differ from the default
    # path's (ROADMAP.md, Queue 3).
    fused_driver = (case.is_1d and not cfg.is_aerosol_aware
                    and os.environ.get(FUSED_DRIVER_ENV, "0") == "1")
    if fused_driver:     # imported here: the module imports this one
        from ..micro.fused_kid_step import fused_kid_step, tv_out
        from ..micro.table_stage import table_stage
    tr = advection.Transport(w_pat, u_pat_faces, rho0, dz, exner, pres2,
                             case.u0, case.dx, dt, ghosts)
    n_adv = len(advected_fields(cfg))
    # the packed input: the head (the state channels and pres, then dzq
    # for fused_step), then the table stage's tail; the fused driver's
    # table stage reads a head of its own
    n_head = N_STATE + (1 if cfg.is_aerosol_aware or fused_driver else 2)
    n_tail = 0 if fused_driver else len(tv_keys(cfg))
    shape = tuple(pres2.shape)
    want_theta = "dtheta_mphys" in profile_names

    def step(st: KidState, m):
        x = torch.empty((n_head + n_tail, *shape), dtype=dtype, device=dev)
        theta = (torch.empty(shape, dtype=dtype, device=dev) if want_theta
                 else None)
        advection.advect(st, m, tr, n_adv, x[:n_head], theta)
        micro_in = ColumnState(*x[:N_STATE])
        pres = x[N_STATE]
        if fused_driver:
            # the kernel derives its own state from the raw one
            tv = table_stage(micro_in, pres, tables, cfg, float(dt),
                             out=tv_out(st, cfg))
            new, ppt, diag = fused_kid_step(
                st, w_pat[0], m, tv, pres2[0], exner, rho0, dz, cfg,
                float(dt), want_rates)
        else:
            w_cent = None              # cell-centred w, for activation
            if cfg.is_aerosol_aware:
                w_vel = m * w_pat / rho_face
                w_cent = 0.5 * (w_vel[:, 1:] + w_vel[:, :-1])
            dzq = dzq2 if cfg.is_aerosol_aware else x[N_STATE + 1]
            out, ppt, diag = column_microphysics(
                micro_in, pres, w_cent, dzq, dt, tables, cfg, want_rates,
                packed=x)
            new = KidState(
                theta=out.t / exner, qv=out.qv, qc=out.qc, qr=out.qr,
                nr=out.nr, qi=out.qi, ni=out.ni, qs=out.qs, qg=out.qg,
                nc=out.nc, nwfa=out.nwfa, nifa=out.nifa)
        new_named = new._asdict()
        profs = {}
        for name in profile_names:
            if name in diag:
                profs[name] = diag[name]
            elif name in new_named:
                profs[name] = new_named[name]
            else:
                f = name[1:-len("_mphys")]
                prov = theta if f == "theta" else getattr(micro_in, f)
                profs[name] = (new_named[f] - prov) * odt
        return new, torch.stack([ppt.rain, ppt.snow, ppt.graupel,
                                 ppt.ice]), profs

    return step


class Flow(NamedTuple):
    """A block of a case's columns on the device: its rows of the flow
    patterns and its pressure."""

    w_pat: torch.Tensor            # (ncol, nz+1) rho0*w at z-faces
    u_pat: Optional[torch.Tensor]  # (ncol+1, nz) rho0*u' at x-faces; 1-D None
    pres2: torch.Tensor            # (ncol, nz)


def build_flow(case: Case, dtype, device, lo: int = 0,
               hi: Optional[int] = None) -> Flow:
    """``Flow`` of columns ``lo:hi`` (default: all) of ``case`` on
    ``device``, with the stream function computed once for both patterns.
    The block's ``hi - lo + 1`` x-faces include the one it shares with its
    right neighbour.  ``BLOCKS`` keeps what this builds."""
    def put(a):
        return torch.tensor(np.asarray(a), dtype=dtype, device=device)

    with spans.span("kid.setup.flow"):
        grid = case.grid()
        hi = case.nx if hi is None else hi
        psi = None if case.is_1d else case._psi(grid)
        u_pat = (None if case.is_1d
                 else put(case.rhou_pattern(grid, psi)[lo:hi + 1]))
        return Flow(put(case.rhow_pattern(grid, psi)[lo:hi]), u_pat,
                    torch.broadcast_to(put(grid.pres), (hi - lo, case.nz)))


class StepLoop:
    """The time loop's device buffers and the step on them.

    ``advance`` takes one step from ``state``: it runs ``exchange``, the
    halo exchange a sharded step holds (``mesh.StepExchange``), if any,
    on ``state``, reads m(t) from ``m_buf`` at the device ``counter``,
    writes the step's precip and profiles into the chunk buffers ``ppt``
    and ``profiles`` at the counter and adds one to the counter; it reads
    no host value.  ``run`` takes steps eagerly, each new state replacing
    ``state``; ``step_in_place`` copies the new state into ``state``
    instead, so that a CUDA graph can capture it and its replays chain
    with no host work between them."""

    def __init__(self, step, shape: tuple, dtype, device, names: tuple,
                 exchange=None):
        self.step = step
        self.exchange = exchange
        self.state = None
        self.m_buf = torch.zeros(CHUNK_STEPS, dtype=dtype, device=device)
        self.counter = torch.zeros(1, dtype=torch.long, device=device)
        self.ppt = torch.empty((CHUNK_STEPS, 4, shape[0]), dtype=dtype,
                               device=device)
        self.profiles = {n: torch.empty((CHUNK_STEPS,) + shape, dtype=dtype,
                                        device=device) for n in names}

    def start_chunk(self, m_values: np.ndarray):
        """m(t) of the chunk's steps (one host-to-device copy, from pinned
        memory on a card) and the counter at 0."""
        src = torch.from_numpy(m_values)
        if self.m_buf.is_cuda:
            src = src.pin_memory()
        self.m_buf[:len(m_values)].copy_(src, non_blocking=True)
        self.counter.zero_()

    def advance(self) -> KidState:
        """One step from ``state``; returns the new state."""
        if self.exchange is not None:
            self.exchange(self.state)
        m = self.m_buf.index_select(0, self.counter).reshape(())
        new, ppt, profs = self.step(self.state, m)
        self.ppt.index_copy_(0, self.counter, ppt[None])
        for name, v in profs.items():
            self.profiles[name].index_copy_(0, self.counter, v[None])
        self.counter.add_(1)
        return new

    def step_in_place(self):
        for buf, t in zip(self.state, self.advance()):
            buf.copy_(t)

    def run(self, n: int, between=None):
        """``n`` steps, eagerly; ``between(state)``, if given, runs before
        each, outside the step."""
        for _ in range(n):
            if between is not None:
                between(self.state)
            self.state = self.advance()
        if self.exchange is not None:
            self.exchange.count(n)


class CapturedStep:
    """A ``StepLoop``'s ``step_in_place`` captured as a CUDA graph, on
    state buffers of its own.

    Before the capture, the kernel libraries are loaded and one warm-up
    ``advance`` runs on a side stream; its results, and its launches, are
    thrown away, and the state buffers stay as ``state0`` left them.
    ``launches`` are the kernel launches of one replay, which ``run`` adds
    to the wrappers' counts.  ``key`` is what the capture depends on
    beyond its ``Block`` (see ``run_steps``); ``tables`` are kept so that
    their identity in the key stays theirs.  ``ms``: the host time of the
    warm-up and the capture (the graph's capture starts with a device
    synchronize, so the warm-up is in it).  A step that holds a halo
    exchange exchanges in the warm-up, on every rank in the same order,
    and is captured in thread-local mode: ProcessGroupNCCL's watchdog
    thread queries CUDA events, which a global-mode capture forbids to
    every thread."""

    def __init__(self, loop: StepLoop, state0: KidState, key, tables):
        t0 = time.perf_counter()
        with spans.span("kid.capture"):
            self.loop, self.key, self.tables = loop, key, tables
            loop.state = KidState(*[t.clone() for t in state0])
            self.graph, self.launches, _ = capture(
                loop.advance, loop.step_in_place, loop.m_buf.device,
                "global" if loop.exchange is None else "thread_local")
        self.ms = (time.perf_counter() - t0) * 1e3

    def load(self, state0: KidState):
        for buf, t in zip(self.loop.state, state0):
            buf.copy_(t)

    def run(self, n: int, between=None):
        """``n`` steps: ``n`` replays on the current stream, each after
        ``between(state)`` if given (on the host, between two replays).
        Adds the launches, and the exchanges, of ``n`` replays."""
        for _ in range(n):
            if between is not None:
                between(self.loop.state)
            self.graph.replay()
        cuda_build.add_launches(self.launches, n)
        if self.loop.exchange is not None:
            self.loop.exchange.count(n)


class Block:
    """A block of a case's columns on a device, as ``BLOCKS`` keeps it: its
    ``Flow``, built once, as the reference's ``jit`` builds it once per
    compile, the step last captured on it (``captured``), if any, and, for
    a rank's block of a 2-D case, its ghost columns (``halo``, a
    ``dist.mesh.Halo``, made on its first sharded call), whose buffers
    that capture reads."""

    def __init__(self, flow: Flow):
        self.flow = flow
        self.captured: Optional[CapturedStep] = None
        self.halo = None

    def capture(self, key, build) -> CapturedStep:
        """The captured step for ``key``: the kept one if its key is
        ``key``, else ``build()``, which replaces it (the old graph and its
        memory go first)."""
        if self.captured is None or self.captured.key != key:
            self.captured = None
            self.captured = build()
        return self.captured


class BlockCache(LRUCache):
    """``Block``s by (case, dtype, device, lo, hi); beyond ``size`` the
    least recently used is dropped, and with it its flow and its captured
    step's graph and memory."""

    def get(self, case: Case, dtype, device, lo: int = 0,
            hi: Optional[int] = None) -> Block:
        """The ``Block`` of columns ``lo:hi`` (default: all) of ``case`` on
        ``device`` (a ``torch.device``), built on the first call."""
        return super().get((case, dtype, device, lo, hi), lambda: Block(
            build_flow(case, dtype, device, lo, hi)))


BLOCKS = BlockCache(BLOCK_CACHE_SIZE)


def simulate(state0: KidState, tables, case: Case, n_steps: int,
             profile_diags=False, istep0: int = 0, device="cuda",
             graphs: bool = True):
    """Run ``n_steps`` of a case from ``state0``; returns
    (final KidState, StepOutputs).  ``istep0`` is the number of steps
    already taken, so a run can be chunked over several calls.  Every
    tensor must lie on ``device``; raises without a GPU unless
    ``device="cpu"``.  On a card the step is captured as a CUDA graph and
    replayed (``graphs=False``: run eagerly); a failed capture or replay
    raises.  The returned tensors are the caller's own.  The call is the
    span ``kid.simulate``, which holds ``run_steps``' spans."""
    with spans.span("kid.simulate", istep0, n_steps):
        dev = resolve_device(device)
        check_on(state0.qv, dev)
        block = BLOCKS.get(case, state0.qv.dtype, state0.qv.device)
        return run_steps(state0, tables, case, n_steps, profile_diags,
                         istep0, dev, block, None, graphs)


def run_steps(state0: KidState, tables, case: Case, n_steps: int,
              profile_diags, istep0: int, device, block: Block, ghosts,
              graphs: bool = True, exchange=None, in_step: bool = False):
    """The time loop of ``simulate`` over the columns that ``state0``
    holds, which may be a block of the case's columns: ``block`` holds
    those columns' flow (see ``BLOCKS``), and ``ghosts`` says where their
    ghost columns come from (see ``make_step``).  With ``graphs`` on a
    CUDA device the step is captured on ``block`` once per (profile names,
    fused-driver switch, ``tables``, ``ghosts``, the exchange it holds) and
    replayed; ``ghosts`` must be the same in every call on a block (None,
    or the block's ``Halo``), or each call captures again.

    ``exchange(state)``, if given, fills the ghost buffers of ``ghosts``
    from the loop's current state (a sharded run's halo exchange),
    once a step.  ``in_step`` says where: as the step's first op
    (``StepLoop.advance``), so that a capture holds it and one replay is
    one whole step; ``exchange.count(n)`` then counts ``n`` steps'
    exchanges.  Otherwise on the host, outside the step (an exchange that
    no graph can hold): once for ``state0`` before anything else, so that
    a capture's warm-up reads filled ghosts and no collective runs inside
    the warm-up or the capture, then before every later step (one call
    for a call of no steps).

    Spans: ``kid.simulate.prepare``, from the checks through the capture
    or reuse and ``CapturedStep.load``, then ``drive``'s."""
    with spans.span("kid.simulate.prepare"):
        dev = resolve_device(device)
        for t in state0:
            check_on(t, dev)
        dtype = state0.qv.dtype
        shape = tuple(state0.qv.shape)
        fl = block.flow
        if fl.w_pat.shape != (shape[0], shape[1] + 1):
            raise ValueError(f"flow rows {tuple(fl.w_pat.shape)} do not fit "
                             f"the state's {shape}")
        names = resolve_profile_names(profile_diags)
        held = exchange if in_step else None
        between = None if in_step else exchange
        if between is not None:
            between(state0)                   # the first step's halo

        def new_loop():
            step = make_step(case, tables, dtype, dev, fl.w_pat, fl.u_pat,
                             fl.pres2, ghosts, names)
            return StepLoop(step, shape, dtype, dev, names, held)

        if graphs and dev.type in GRAPH_DEVICE_TYPES:
            key = (names, os.environ.get(FUSED_DRIVER_ENV, "0"), id(tables),
                   ghosts, held)
            captured = block.capture(key, lambda: CapturedStep(
                new_loop(), state0, key, tables))
            captured.load(state0)
            loop, run = captured.loop, captured.run
        else:
            loop = new_loop()
            loop.state = state0
            run = loop.run
    return drive(loop, run, case, n_steps, istep0, between)


def drive(loop: StepLoop, run, case: Case, n_steps: int, istep0: int,
          between=None):
    """``n_steps`` steps of ``loop`` from its ``state``, chunk by chunk:
    m(t) of a chunk's steps uploaded (``StepLoop.start_chunk``), then
    ``run(k, between)`` (``StepLoop.run`` or ``CapturedStep.run``), and
    the chunk's streams copied out.  ``between``, if given, runs before
    every step but the first, whose halo the caller has filled.  Returns
    (final KidState, StepOutputs), the caller's own.  Spans: a
    ``kid.chunk`` a chunk (``.upload``, ``.replay``, ``.streams``), then
    ``kid.simulate.finish``, the final state's clones."""
    state = loop.state
    dtype, dev = state.qv.dtype, state.qv.device
    shape = tuple(state.qv.shape)
    ppt = torch.empty((n_steps, 4, shape[0]), dtype=dtype, device=dev)
    profiles = {n: torch.empty((n_steps,) + shape, dtype=dtype, device=dev)
                for n in loop.profiles}
    for i0 in range(0, n_steps, CHUNK_STEPS):
        k = min(CHUNK_STEPS, n_steps - i0)
        with spans.span("kid.chunk"):
            with spans.span("kid.chunk.upload"):
                loop.start_chunk(case.modulation_table(istep0 + i0, k,
                                                       dtype))
            with spans.span("kid.chunk.replay"):
                if i0 == 0 and between is not None:
                    run(1)                # its halo was exchanged above
                    run(k - 1, between)
                else:
                    run(k, between)
            with spans.span("kid.chunk.streams"):
                ppt[i0:i0 + k] = loop.ppt[:k]
                for n, out in profiles.items():
                    out[i0:i0 + k] = loop.profiles[n][:k]
    with spans.span("kid.simulate.finish"):
        final = KidState(*[t.clone() for t in loop.state])
    return final, StepOutputs(
        ppt_rain=ppt[:, 0], ppt_snow=ppt[:, 1], ppt_graupel=ppt[:, 2],
        ppt_ice=ppt[:, 3], profiles=profiles)


def run_case(case: Case, dtype=torch.float64, n_steps=None,
             profile_diags=False, device="cuda"):
    """Tables + initial state + ``simulate`` on ``device``."""
    dev = resolve_device(device)
    tables = device_tables(get_tables(iiwarm=case.micro.iiwarm), dtype,
                           device=dev)
    state0 = initial_state(case, dtype, dev)
    n = case.n_steps if n_steps is None else n_steps
    return simulate(state0, tables, case, n, profile_diags, device=dev)
