"""Columns split over ranks with ``torch.distributed`` (twin of
``kid_tpu/dist/mesh.py``).

Each process is one rank.  Rank r of n owns the contiguous block of
columns ``[r*nloc, (r+1)*nloc)``, ``nloc = nx / n``, with the whole
vertical, on a ``torch.device`` given explicitly:

  * the microphysics is column-parallel (the reference's serial
    ``do i=1,nx`` loop, mphys_thompson09n.f90:54), so a step needs no
    communication apart from
  * the 2-column halo of the 2-D x-advection stencil: one ring exchange of
    the stacked edge columns of the tracers per step (``halo_exchange_x``),
    the counterpart of the reference's ``lax.ppermute`` pair.

The reference compiles every step of a shard into one program (``jax.jit``
over ``shard_map`` over ``lax.scan``, the exchange inside).  Here too the
exchange is the first thing of a rank's step wherever the transport takes
the device tensors as they are (NCCL, gloo on the CPU, and one rank,
whose wrap is local): ``Halo.swap`` packs the edge columns into a static
send slab and the ring's sends and receives land in the block's ghost
buffers, so that on a card the rank's CUDA graph of its step
(``driver/loop.py``) holds the whole step, one replay a step.  gloo with
CUDA tensors (several ranks sharing one card) stages the slabs through
host buffers, which no graph can hold: there ``Halo.exchange`` fills the
ghosts on the host between two steps, and the graph holds the rest
(``exchange_in_step`` chooses).  The CPU and ``graphs=False`` run the
same steps eagerly.

The vertical is never split.  Where a rank's result must equal the
single-process run bit for bit, it is because every column sees the same
operations on the same values; the exchange only moves values.
"""
from __future__ import annotations

import functools
import time
from datetime import timedelta
from typing import NamedTuple

import torch
import torch.distributed as dist

from .. import spans
from ..device import resolve_device
from ..driver.advection import advective_tendency_x_padded
from ..driver.loop import BLOCKS, KidState, advected_fields, run_steps

HALO = 2                 # ghost columns per side of the MUSCL x stencil
# a rank that waits this long for the others gives up (a peer has died)
TIMEOUT = timedelta(minutes=10)
PPT_NAMES = ("ppt_rain", "ppt_snow", "ppt_graupel", "ppt_ice")


def make_group(device, backend="gloo", init_method=None, rank=None,
               world_size=None):
    """The default process group, initialised here unless it already is,
    with this rank's ``device`` checked against the backend; returns the
    group.

    gloo takes any device: CUDA tensors cross through host buffers (see
    ``halo_exchange_x``), so several ranks may share one card.  NCCL needs
    every rank on a card of its own; the devices of all ranks are
    gathered and checked.  A CUDA device without a card raises."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        if dev.index is None:
            raise ValueError("name the card, e.g. 'cuda:0'")
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        dist.init_process_group(backend, init_method=init_method, rank=rank,
                                world_size=world_size, timeout=TIMEOUT)
    group = dist.group.WORLD
    backend = dist.get_backend(group)
    devices = [None] * dist.get_world_size(group)
    dist.all_gather_object(devices, str(dev), group=group)
    if backend == "nccl":
        if dev.type != "cuda" or len(set(devices)) != len(devices):
            raise ValueError(f"NCCL needs one card per rank; the ranks ask "
                             f"for {devices}")
    elif backend != "gloo":
        raise ValueError(f"backend {backend!r}: use 'gloo' or 'nccl'")
    return group


def column_block(nx: int, rank: int, world_size: int) -> tuple:
    """(first, end) column of ``rank``'s block; raises unless the ranks
    divide the columns evenly."""
    if nx % world_size:
        raise ValueError(f"{world_size} ranks do not divide {nx} columns")
    nloc = nx // world_size
    return rank * nloc, (rank + 1) * nloc


def _via_host(device, group) -> bool:
    """True where the group's backend cannot take a tensor on ``device``
    itself: gloo with a CUDA tensor."""
    return device.type == "cuda" and dist.get_backend(group) == "gloo"


def exchange_in_step(group, device) -> bool:
    """Whether a rank's halo exchange runs inside its step (``Halo.swap``,
    which a CUDA graph of the step then holds): yes unless gloo has to
    stage the slabs on ``device`` through host buffers, which one rank,
    whose wrap is local, never does."""
    return dist.get_world_size(group) == 1 or not _via_host(device, group)


def _ring(send, recv, group):
    """The ring's two sends and two receives, posted together and waited
    for (on a card, NCCL makes the current stream wait, not the host):
    ``send[0]``, my right edge, goes to my right neighbour's ``recv[0]``
    (its from_left), ``send[1]``, my left edge, to my left neighbour's
    ``recv[1]``.  Two ranks are each other's both neighbours: the tags
    (gloo) and the order of the ops (NCCL) keep the two directions
    apart."""
    n, rank = dist.get_world_size(group), dist.get_rank(group)
    nxt = dist.get_global_rank(group, (rank + 1) % n)
    prv = dist.get_global_rank(group, (rank - 1) % n)
    ops = [dist.P2POp(dist.isend, send[0], nxt, group, 0),
           dist.P2POp(dist.isend, send[1], prv, group, 1),
           dist.P2POp(dist.irecv, recv[0], prv, group, 0),
           dist.P2POp(dist.irecv, recv[1], nxt, group, 1)]
    for work in dist.batch_isend_irecv(ops):
        work.wait()


def halo_exchange_x(q, group, width: int = HALO, axis: int = 0):
    """Ring exchange of ``width`` edge columns with both neighbours.

    Returns (from_left, from_right): the left neighbour's rightmost and
    the right neighbour's leftmost ``width`` columns of the periodic
    domain.  ``axis`` is the column axis of ``q``, so the edge slab of
    every tracer (``Halo.exchange``: (n_adv, 2*width, nz)) goes in ONE
    send/recv pair per direction.
    On one rank the periodic wrap is taken locally (P2P refuses sends to
    oneself).

    With gloo and a CUDA tensor, the two slabs are copied to a host
    buffer, exchanged there (``_ring``) and copied back, explicitly, here:
    that is the path of several ranks on one card.  With NCCL the device
    tensors themselves are sent.  ``halo_exchange_x.calls`` counts every
    exchange, ``Halo.swap``'s too (``StepExchange.count``), and
    ``.seconds`` the host clock of the calls of this function (including
    the host copies and the wait for the device they imply) and of
    ``Halo.swap`` (its posting: NCCL makes no host wait; a replay of a
    graph that holds it adds nothing).  Both are the span
    ``kid.halo_exchange``, which a replay does not enter either."""
    t0 = time.perf_counter()
    with spans.span("kid.halo_exchange"):
        size = q.shape[axis]
        right = q.narrow(axis, size - width, width)
        left = q.narrow(axis, 0, width)
        if dist.get_world_size(group) == 1:
            out = right.clone(), left.clone()
        else:
            host = _via_host(q.device, group)
            slabs = torch.stack([right, left])       # one buffer, two slabs
            if host:
                slabs = slabs.cpu()
            got = torch.empty_like(slabs)
            _ring(slabs, got, group)
            if host:
                got = got.to(q.device)
            out = got[0], got[1]
    halo_exchange_x.calls += 1
    halo_exchange_x.seconds += time.perf_counter() - t0
    return out


halo_exchange_x.calls = 0
halo_exchange_x.seconds = 0.0


def sharded_tendency_x(q, rhou_face_local, rho0, dx, group):
    """Distributed x-advection of a (nloc, nz) tracer: halo exchange plus
    the local MUSCL fluxes.  Both copies of a block-boundary face see the
    same 4-cell stencil, so their fluxes are the same bits and the blocks
    conserve mass together as the periodic seam does."""
    left, right = halo_exchange_x(q, group, HALO, axis=0)
    return advective_tendency_x_padded(torch.cat([left, q, right], 0),
                                       rhou_face_local, rho0, dx)


class Halo:
    """The ghost columns of a rank's block: ``left`` and ``right``, each
    (n_adv, HALO, nz) on the block's device, the tracers in
    ``advected_fields`` order (``make_step``'s stacking order), the two
    halves of one receive slab ``recv`` (2, n_adv, HALO, nz) beside a
    send slab ``send`` of the same shape: static buffers, which a CUDA
    graph of the step reads and writes in place.  ``swap`` fills the
    ghosts inside the step, ``exchange`` between two steps; the step's
    transport (``driver.advection.advect``) reads them by index."""

    def __init__(self, case, dtype, device):
        self.idx = tuple(KidState._fields.index(f)
                         for f in advected_fields(case.micro))
        self.send = torch.zeros((2, len(self.idx), HALO, case.nz),
                                dtype=dtype, device=device)
        self.recv = torch.zeros_like(self.send)
        self.left, self.right = self.recv

    def swap(self, state: KidState, group):
        """The exchange inside the step, on the device: the right and the
        left edge columns of ``state``'s tracers packed into ``send``, then
        the ring's sends and receives (``_ring``), which land in ``left``
        and ``right``; on one rank the edges are packed into the ghosts
        themselves (the periodic wrap).  It reads no host value and copies
        nothing from the host, so a CUDA graph of the step holds it."""
        t0 = time.perf_counter()
        with spans.span("kid.halo_exchange"):
            one = dist.get_world_size(group) == 1
            slab = self.recv if one else self.send
            torch.stack([state[i][-HALO:] for i in self.idx], out=slab[0])
            torch.stack([state[i][:HALO] for i in self.idx], out=slab[1])
            if not one:
                _ring(self.send, self.recv, group)
        halo_exchange_x.seconds += time.perf_counter() - t0

    def exchange(self, state: KidState, group):
        """The edge columns of ``state``'s tracers, stacked as one
        (n_adv, 2*HALO, nz) slab, through ``halo_exchange_x``, on the host
        between two steps; the neighbours' edges are copied into ``left``
        and ``right``."""
        edges = torch.stack([torch.cat([state[i][:HALO], state[i][-HALO:]])
                             for i in self.idx])
        left, right = halo_exchange_x(edges, group, HALO, axis=1)
        self.left.copy_(left)
        self.right.copy_(right)


class StepExchange(NamedTuple):
    """A block's ``Halo.swap`` on ``group``, as ``run_steps`` holds it in
    the step.  Equal for the same halo and group, so that a later call on
    the block replays the same capture."""

    halo: Halo
    group: object

    def __call__(self, state: KidState):
        self.halo.swap(state, self.group)

    def count(self, n: int):
        """Adds ``n`` exchanges to ``halo_exchange_x.calls``: ``n`` steps
        ran, eagerly or as replays of a capture that holds the swap."""
        halo_exchange_x.calls += n


def simulate_sharded(state_local: KidState, tables, case, n_steps: int,
                     group, profile_diags=False, istep0: int = 0,
                     device="cuda", graphs: bool = True):
    """Distributed twin of ``driver.loop.simulate``: the same
    ``make_step`` physics on this rank's block of columns
    (``state_local``, see ``shard_state``), the edge columns of the
    tracers halo-exchanged once per step into the block's ``Halo``: as
    the step's first op, or on the host before the step where gloo
    stages CUDA tensors through the host (``exchange_in_step``).  On a
    card each rank captures its step as a CUDA graph and replays it
    (``graphs=False``: the eager loop; the CPU always runs it); a failed
    capture or replay raises.  Every rank must make the same calls in the
    same order.  The x flux is keyed on ``Case.is_1d``, so a widened 1-D
    case gets none and exchanges nothing.  Returns this rank's (final
    KidState, StepOutputs); ``gather_state`` collects them on rank 0.
    A captured step that holds NCCL sends and receives uses the group's
    communicator for as long as it lives: clear ``loop.BLOCKS`` before
    destroying the group.  Its spans are ``simulate``'s."""
    with spans.span("kid.simulate", istep0, n_steps):
        return _simulate_sharded(state_local, tables, case, n_steps, group,
                                 profile_diags, istep0, device, graphs)


def _simulate_sharded(state_local, tables, case, n_steps, group,
                      profile_diags, istep0, device, graphs):
    n, rank = dist.get_world_size(group), dist.get_rank(group)
    lo, hi = column_block(case.nx, rank, n)
    if state_local.qv.shape[0] != hi - lo:
        raise ValueError(f"rank {rank} holds {state_local.qv.shape[0]} "
                         f"columns, its block is {hi - lo}")
    dev = resolve_device(device)
    # this block's rows of the flow and its ghost buffers, made once per
    # case and block, so that a later call replays the same capture
    block = BLOCKS.get(case, state_local.qv.dtype, state_local.qv.device, lo,
                       hi)
    ghosts, exchange, in_step = None, None, False
    if not case.is_1d:
        if hi - lo < HALO:
            raise ValueError(f"a block of {hi - lo} columns is narrower "
                             f"than the {HALO}-column halo")
        if block.halo is None:
            block.halo = Halo(case, state_local.qv.dtype,
                              state_local.qv.device)
        ghosts = block.halo
        in_step = exchange_in_step(group, state_local.qv.device)
        exchange = (StepExchange(block.halo, group) if in_step else
                    functools.partial(block.halo.exchange, group=group))
    return run_steps(state_local, tables, case, n_steps, profile_diags,
                     istep0, dev, block, ghosts, graphs, exchange, in_step)


def shard_state(state: KidState, rank: int, world_size: int) -> KidState:
    """``rank``'s block of the columns of a global ``KidState`` (e.g. from
    ``convert.state_from_numpy``), as tensors of its own."""
    lo, hi = column_block(state.qv.shape[0], rank, world_size)
    return KidState(*[t[lo:hi].clone() for t in state])


def _gather_cols(t, dim: int, group):
    """Rank 0: the ranks' ``t`` concatenated along ``dim``, as numpy; the
    other ranks: None."""
    t = t.contiguous()
    if _via_host(t.device, group):
        t = t.cpu()
    root = dist.get_global_rank(group, 0)
    if dist.get_rank(group) != 0:
        dist.gather(t, None, dst=root, group=group)
        return None
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.gather(t, parts, dst=root, group=group)
    return torch.cat(parts, dim).cpu().numpy()


def gather_state(final: KidState, streams, group):
    """Collects the ranks' final states and streams on rank 0 as numpy:
    (fields {name: (nx, nz)}, ppt {ppt_*: (n_steps, nx)}, profiles
    {name: (n_steps, nx, nz)}); None on the other ranks."""
    fields = _gather_cols(torch.stack(list(final)), 1, group)
    ppt = _gather_cols(torch.stack([getattr(streams, k) for k in PPT_NAMES]),
                       2, group)
    profiles = {k: _gather_cols(v, 1, group)
                for k, v in streams.profiles.items()}
    if fields is None:
        return None
    return (dict(zip(KidState._fields, fields)), dict(zip(PPT_NAMES, ppt)),
            profiles)

