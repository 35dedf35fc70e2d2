"""Halo-exchange LP across processes: the schedule and its transport.

The framework-free part of ``repro/distributed/collectives.py``
(``HaloTransfer``, ``HaloSpec``, ``halo_spec``, ``wire_shard_len``),
copied so the port never imports the reference, and the collectives
that run the schedule across the ranks of a ``torch.distributed`` group:

  * :class:`LPGroup` — one rank's end of an lp group.  Its three
    collectives, an all-gather (``all_gather_into_tensor``), a sum
    all-reduce and the point-to-point rounds of the halo
    (``batch_isend_irecv``), all go through ``LPGroup._count``, which
    records per collective kind the payload the reference's HLO
    accounting gives one device (the gathered output, the reduced
    buffer, the slab of a round) and the bytes this rank sent
    (:class:`WireCounter`).
  * :func:`halo_rounds` — the one driver of the halo's rounds: issue
    order, deposit order and ``eager_sends``, for the uncoded
    :func:`halo_exchange` (the reference's, ``collectives.py:285``) and
    ``comm/wire.compressed_halo_exchange``.

Transport: an NCCL group moves tensors as they are (and refuses a CPU
tensor).  A gloo group moves host memory: a CUDA tensor is copied to the
host and back explicitly, decided by the group's backend, and the copies
are not wire bytes.  Payloads travel as their bytes (``uint8`` views),
so every wire dtype (bf16-as-int16, int8, packed int4) crosses the same
way; the all-reduce sums f32.

The tp-sharded twins (``sharded_ppermute``, ``sharded_all_gather``)
need a 2-D mesh: ROADMAP Queue 1 item 8.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class HaloTransfer:
    """One ppermute round: every rank ``j`` with a nonempty overlap
    between its window and the core of rank ``j + offset`` sends that slab.

    Slabs are padded to ``length`` (the max over senders); ``src_len``
    masks the padding to zero before the send.  ``src_start`` is in the
    sender's window coordinates, ``dst_start`` in the receiver's core
    coordinates, both in latent units.
    """

    offset: int
    length: int
    perm: Tuple[Tuple[int, int], ...]
    src_start: Tuple[int, ...]
    src_len: Tuple[int, ...]
    dst_start: Tuple[int, ...]


@dataclasses.dataclass(frozen=True)
class HaloSpec:
    """Static transfer schedule for halo-exchange LP reconstruction."""

    num_partitions: int
    window: int
    extent: int
    starts: Tuple[int, ...]
    core_start: Tuple[int, ...]
    core_end: Tuple[int, ...]
    core_pad: int                      # max core length (all-gather shard)
    transfers: Tuple[HaloTransfer, ...]

    @property
    def core_len(self) -> Tuple[int, ...]:
        return tuple(e - s for s, e in zip(self.core_start, self.core_end))

    @property
    def max_transfer(self) -> int:
        return max((t.length for t in self.transfers), default=0)

    @property
    def pad(self) -> int:
        """Zero rows a window buffer needs so every slab slice is in
        bounds."""
        return max(self.core_pad, self.max_transfer)


def halo_spec(plan) -> HaloSpec:
    """The exact transfer schedule of a uniform-window plan: for every
    rank pair (j, k) the slab is ``window_j ∩ core_k``, grouped by
    offset ``k - j`` so each group is one round."""
    K = plan.num_partitions
    core_len = [plan.core_end[k] - plan.core_start[k] for k in range(K)]
    transfers = []
    for d in [x for x in range(-(K - 1), K) if x != 0]:
        pairs = []
        for j in range(K):
            k = j + d
            if not 0 <= k < K:
                continue
            lo = max(plan.starts[j], plan.core_start[k])
            hi = min(plan.starts[j] + plan.window, plan.core_end[k])
            if hi > lo:
                pairs.append((j, k, lo, hi))
        if not pairs:
            continue
        length = max(hi - lo for (_, _, lo, hi) in pairs)
        src_start, src_len, dst_start = [0] * K, [0] * K, [0] * K
        perm = []
        for j, k, lo, hi in pairs:
            perm.append((j, k))
            src_start[j] = lo - plan.starts[j]
            src_len[j] = hi - lo
            dst_start[k] = lo - plan.core_start[k]
        transfers.append(HaloTransfer(
            offset=d, length=length, perm=tuple(perm),
            src_start=tuple(src_start), src_len=tuple(src_len),
            dst_start=tuple(dst_start),
        ))
    return HaloSpec(
        num_partitions=K,
        window=plan.window,
        extent=plan.extent,
        starts=tuple(plan.starts),
        core_start=tuple(plan.core_start),
        core_end=tuple(plan.core_end),
        core_pad=max(core_len),
        transfers=tuple(transfers),
    )


def wire_shard_len(n_elems: int, shard_size: int) -> int:
    """Per-rank chunk length of an ``n_elems`` flat wire split
    ``shard_size`` ways (last chunk zero-padded)."""
    return -(-n_elems // shard_size)


SHARDED_WIRE = "ROADMAP Queue 1 item 8 (hybrid LP x TP: the tp-sharded wire)"
KINDS = ("all-gather", "all-reduce", "collective-permute")


@dataclasses.dataclass
class WireCounter:
    """What one rank's LP collectives moved, in bytes.

    ``payload[kind]``: the reference's HLO accounting, per device — an
    all-gather's gathered output, an all-reduce's buffer, a permute
    round's slab (on every rank, with a peer or not; payload and scale
    meta each count).  ``sent``: the bytes this rank sent — a round's
    slab where it has a peer, an all-gather's piece once for each of the
    K-1 others (summed over a group, both are the ``comm_lp_halo*``
    totals), and an all-reduce's buffer as it is handed to the
    transport.  What an all-reduce puts on the wire beyond that is the
    transport's algorithm, which the counter cannot see: the byte model
    takes a ring's 2(K-1)/K of the buffer a rank
    (``comm_model.collective_wire_bytes``), the buffer itself at K = 2.
    ``calls``: collectives issued, per kind."""

    payload: Dict[str, int] = dataclasses.field(
        default_factory=lambda: dict.fromkeys(KINDS, 0))
    calls: Dict[str, int] = dataclasses.field(
        default_factory=lambda: dict.fromkeys(KINDS, 0))
    sent: int = 0

    def reset(self) -> None:
        self.payload = dict.fromkeys(KINDS, 0)
        self.calls = dict.fromkeys(KINDS, 0)
        self.sent = 0

    def snapshot(self) -> dict:
        return {"payload": dict(self.payload), "calls": dict(self.calls), "sent": self.sent}


def _nbytes(x: torch.Tensor) -> int:
    return x.numel() * x.element_size()


@dataclasses.dataclass(frozen=True)
class Round:
    """One point-to-point round of one rank: ``msg`` (payload, then
    meta) goes to ``dst`` and tensors of the same shapes and dtypes come
    from ``src``; None where the rank has no peer (a rank that sends
    nothing passes tensors of the round's shapes)."""

    msg: Tuple[torch.Tensor, ...]
    dst: Optional[int]
    src: Optional[int]


@dataclasses.dataclass
class LPGroup:
    """One rank's end of a 1-D lp group (``launch/mesh.make_lp_group``).

    ``group`` is the ``torch.distributed`` process group (None: the
    default one), ``device`` where this rank computes, ``counter`` the
    bytes its collectives moved."""

    rank: int
    size: int
    device: torch.device
    group: Optional[object] = None
    counter: WireCounter = dataclasses.field(default_factory=WireCounter)

    @property
    def backend(self) -> str:
        return dist.get_backend(self.group)

    # ------------------------------------------------------------ transport
    def _out(self, x: torch.Tensor) -> torch.Tensor:
        """``x``'s bytes as the backend takes them: a flat ``uint8`` view,
        copied to the host for a gloo group."""
        backend = self.backend
        if backend == "gloo":
            x = x.cpu() if x.is_cuda else x
        elif backend == "nccl":
            if not x.is_cuda:
                raise ValueError("an NCCL group moves CUDA tensors only, got a CPU tensor")
        else:
            raise ValueError(f"LP collectives run on gloo or NCCL, not {backend!r}")
        return x.contiguous().reshape(-1).view(torch.uint8)

    def _buffer(self, nbytes: int) -> torch.Tensor:
        dev = self.device if self.backend == "nccl" else torch.device("cpu")
        return torch.empty(nbytes, dtype=torch.uint8, device=dev)

    def _back(self, buf: torch.Tensor, like: torch.Tensor, shape) -> torch.Tensor:
        return buf.view(like.dtype).reshape(shape).to(like.device)

    def _count(self, kind: str, payload: int, sent: int) -> None:
        """THE byte count: every collective of the group passes here."""
        c = self.counter
        c.payload[kind] += payload
        c.calls[kind] += 1
        c.sent += sent

    # ---------------------------------------------------------- collectives
    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """``(size,) + x.shape``: every rank's ``x`` in rank order."""
        flat = self._out(x)
        out = self._buffer(flat.numel() * self.size)
        dist.all_gather_into_tensor(out, flat, group=self.group)
        self._count("all-gather", out.numel(), (self.size - 1) * flat.numel())
        return self._back(out, x, (self.size,) + tuple(x.shape))

    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of every rank's f32 ``x`` (a new tensor on x's device)."""
        if x.dtype != torch.float32:
            raise ValueError(f"the LP all-reduce sums f32, got {x.dtype}")
        if self.backend == "gloo":
            buf = x.to("cpu", copy=True).contiguous()   # host staging, never x itself
        else:
            self._out(x)                                # refuses a CPU tensor
            buf = x.contiguous().clone()
        dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=self.group)
        self._count("all-reduce", _nbytes(x), _nbytes(x))
        return buf.to(x.device)

    def issue(self, rnd: Round, tag: int = 0):
        """Start one round; returns a handle for :meth:`land`."""
        ops, bufs = [], []
        if rnd.dst is not None:
            for i, x in enumerate(rnd.msg):
                ops.append(dist.P2POp(dist.isend, self._out(x), rnd.dst, self.group,
                                      tag * 8 + i))
        if rnd.src is not None:
            for i, x in enumerate(rnd.msg):
                buf = self._buffer(_nbytes(x))
                bufs.append(buf)
                ops.append(dist.P2POp(dist.irecv, buf, rnd.src, self.group, tag * 8 + i))
        payload = sum(_nbytes(x) for x in rnd.msg)
        self._count("collective-permute", payload, payload if rnd.dst is not None else 0)
        reqs = dist.batch_isend_irecv(ops) if ops else []
        return rnd, bufs, reqs, ops           # ops keep the staged sends alive

    def land(self, handle) -> Optional[Tuple[torch.Tensor, ...]]:
        """Wait for a round; the tensors received, or None without a
        sender."""
        rnd, bufs, reqs, _ = handle
        for r in reqs:
            r.wait()
        if rnd.src is None:
            return None
        return tuple(self._back(b, x, x.shape) for b, x in zip(bufs, rnd.msg))


def halo_round(t: HaloTransfer, rank: int) -> Tuple[Optional[int], Optional[int]]:
    """``(dst, src)`` of ``rank`` in transfer ``t``: where its slab goes
    and whose slab it gets, None for no peer."""
    dst = next((k for j, k in t.perm if j == rank), None)
    src = next((j for j, k in t.perm if k == rank), None)
    return dst, src


def masked_slab(wpred: torch.Tensor, t: HaloTransfer, rank: int) -> torch.Tensor:
    """``rank``'s slab of round ``t``: ``t.length`` rows from its
    ``src_start``, the rows past its ``src_len`` multiplied by 0 (as the
    reference masks: a NaN there stays NaN)."""
    slab = wpred[t.src_start[rank]:t.src_start[rank] + t.length]
    valid = torch.arange(t.length, device=wpred.device) < t.src_len[rank]
    return slab * valid.reshape((t.length,) + (1,) * (wpred.ndim - 1))


def halo_rounds(spec: HaloSpec, eager_sends: bool, issue: Callable, deposit: Callable) -> None:
    """Run ``spec``'s rounds on one rank: ``issue(ti, t)`` starts round
    ``ti`` and returns what ``deposit(t, issued)`` lands.  Deposits go in
    ``spec.transfers`` order, the reference's sum order; each round is
    issued just before its deposit, or with ``eager_sends`` every round
    before the first deposit (``collectives.py:344``).  Every rank issues
    the rounds in the same order, so the sends and receives pair."""
    if eager_sends:
        issued = [issue(ti, t) for ti, t in enumerate(spec.transfers)]
        for t, got in zip(spec.transfers, issued):
            deposit(t, got)
        return
    for ti, t in enumerate(spec.transfers):
        deposit(t, issue(ti, t))


def halo_exchange(wpred: torch.Tensor, spec: HaloSpec, rank: int, group: LPGroup,
                  eager_sends: bool = False, shard_axis=None) -> torch.Tensor:
    """Cross-rank reduction of overlapping window predictions, halo only.

    ``wpred``: this rank's weighted f32 prediction, partition dim first,
    zero-padded at the end by ``spec.pad`` rows.  Returns the
    ``(core_pad + max_transfer, ...)`` accumulator whose first
    ``core_len[rank]`` rows hold the sum of every rank's contribution to
    this rank's core (unnormalized): the own core first, then each
    round's slab (:func:`halo_rounds`), as the reference sums.  A rank
    without a peer in a round sends nothing and deposits nothing (the
    reference deposits ppermute's zeros, which add nothing)."""
    if shard_axis is not None:
        raise NotImplementedError(f"shard_axis= is not ported yet: {SHARDED_WIRE}")
    acc_len = spec.core_pad + spec.max_transfer
    rest = tuple(wpred.shape[1:])
    acc = wpred.new_zeros((acc_len,) + rest)
    off = spec.core_start[rank] - spec.starts[rank]
    acc[:spec.core_pad] = wpred[off:off + spec.core_pad]

    def issue(ti, t):
        dst, src = halo_round(t, rank)
        slab = wpred.new_empty((t.length,) + rest) if dst is None else \
            masked_slab(wpred, t, rank)
        return group.issue(Round((slab,), dst, src), ti)

    def deposit(t, handle):
        got = group.land(handle)
        if got is not None:
            dst = t.dst_start[rank]
            acc[dst:dst + t.length] += got[0]

    halo_rounds(spec, eager_sends, issue, deposit)
    return acc
