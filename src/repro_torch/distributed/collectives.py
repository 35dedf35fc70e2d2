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

On a 2-D ``(lp, tp)`` group (:class:`HybridGroup`: rank ``m*T + t`` of the
world is device ``(m, t)``) every tp rank of LP group ``m`` holds the same
slabs.  The tp-sharded wire (``wire_shard_slice`` / ``wire_unshard`` /
``wire_unshard_rows``, :func:`sharded_ppermute`, :func:`sharded_all_gather`,
the reference's ``collectives.py:98-185``) ships each payload as T chunks,
one a tp rank, across the lp group (the **inter** tier), and one all-gather
over the tp group (the **intra** tier) reassembles it: a pure
rearrangement of bytes, so the sharded and unsharded wires give the same
bits.  The lp and tp groups of a rank share one :class:`WireCounter`,
which keeps each tier apart.
"""
from __future__ import annotations

import dataclasses
import math
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


def wire_shard_slice(x: torch.Tensor, shard_rank: int, shard_size: int) -> torch.Tensor:
    """Chunk ``shard_rank`` of a flat view of ``x``: ``wire_shard_len``
    elements of x's dtype, the tail chunk zero-padded, so every rank ships
    the same shape.  Flattening keeps the split exact for any slab shape and
    wire dtype (int8, bf16-as-int16, int4 packed along its last axis)."""
    flat = x.reshape(-1)
    s = wire_shard_len(flat.numel(), shard_size)
    if s * shard_size != flat.numel():
        flat = torch.cat([flat, flat.new_zeros(s * shard_size - flat.numel())])
    return flat[shard_rank * s:(shard_rank + 1) * s]


def wire_unshard(chunks: torch.Tensor, shape: Tuple[int, ...]) -> torch.Tensor:
    """The wire of ``shape`` from its ``(T, s)`` gathered chunks, the tail
    padding dropped: the exact inverse of T :func:`wire_shard_slice` calls."""
    n = math.prod(shape)
    return chunks.reshape(-1)[:n].reshape(shape)


def wire_unshard_rows(chunks: torch.Tensor, shape: Tuple[int, ...]) -> torch.Tensor:
    """The ``(K,) + shape`` table from a ``(T, K, s)`` stack of chunk
    columns (a tp gather of a K-row lp gather), each row's padding dropped:
    :func:`wire_unshard` a row."""
    K, n = chunks.shape[1], math.prod(shape)
    return chunks.transpose(0, 1).reshape(K, -1)[:, :n].reshape((K,) + tuple(shape))


KINDS = ("all-gather", "all-reduce", "collective-permute")
TIERS = ("inter", "intra")


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
    ``calls``: collectives issued, per kind.  ``tiers[tier]`` splits
    payload and sent bytes by link tier: ``inter`` for the lp group's
    collectives, ``intra`` for the tp group's (a 1-D group has only
    ``inter``); the totals above are their sums."""

    payload: Dict[str, int] = dataclasses.field(
        default_factory=lambda: dict.fromkeys(KINDS, 0))
    calls: Dict[str, int] = dataclasses.field(
        default_factory=lambda: dict.fromkeys(KINDS, 0))
    sent: int = 0
    tiers: Dict[str, dict] = dataclasses.field(default_factory=lambda: _zero_tiers())

    def reset(self) -> None:
        self.payload = dict.fromkeys(KINDS, 0)
        self.calls = dict.fromkeys(KINDS, 0)
        self.sent = 0
        self.tiers = _zero_tiers()

    def snapshot(self) -> dict:
        return {"payload": dict(self.payload), "calls": dict(self.calls), "sent": self.sent,
                "tiers": {t: {"payload": dict(v["payload"]), "sent": v["sent"]}
                          for t, v in self.tiers.items()}}


def _zero_tiers() -> Dict[str, dict]:
    return {t: {"payload": dict.fromkeys(KINDS, 0), "sent": 0} for t in TIERS}


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
    """One rank's end of a 1-D group (``launch/mesh.make_lp_group``): an
    lp group, or one axis of a :class:`HybridGroup`.

    ``group`` is the ``torch.distributed`` process group (None: the
    default one), ``device`` where this rank computes, ``counter`` the
    bytes its collectives moved, counted under ``tier``.  ``ranks`` are
    the members' world ranks in group order (None: the world itself);
    peers are named by group rank and sent to by world rank."""

    rank: int
    size: int
    device: torch.device
    group: Optional[object] = None
    counter: WireCounter = dataclasses.field(default_factory=WireCounter)
    tier: str = "inter"
    ranks: Optional[Tuple[int, ...]] = None

    @property
    def backend(self) -> str:
        return dist.get_backend(self.group)

    def world_rank(self, rank: int) -> int:
        return rank if self.ranks is None else self.ranks[rank]

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
        c.tiers[self.tier]["payload"][kind] += payload
        c.tiers[self.tier]["sent"] += sent

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
                ops.append(dist.P2POp(dist.isend, self._out(x), self.world_rank(rnd.dst),
                                      self.group, tag * 8 + i))
        if rnd.src is not None:
            for i, x in enumerate(rnd.msg):
                buf = self._buffer(_nbytes(x))
                bufs.append(buf)
                ops.append(dist.P2POp(dist.irecv, buf, self.world_rank(rnd.src), self.group,
                                      tag * 8 + i))
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


@dataclasses.dataclass
class HybridGroup:
    """One rank's end of a 2-D ``(lp, tp)`` group
    (``launch/mesh.make_hybrid_group``): ``lp`` is this rank's lp group
    (the ranks with its tp index, one per LP group, the LP ring), ``tp``
    its tp group (the ranks of its LP group).  Both count into one
    :class:`WireCounter`, the lp group under ``inter``, the tp group
    under ``intra``.  ``rank`` and ``size`` are the lp group's, as an
    engine that takes an :class:`LPGroup` reads them."""

    lp: LPGroup
    tp: LPGroup

    @property
    def rank(self) -> int:
        return self.lp.rank

    @property
    def size(self) -> int:
        return self.lp.size

    @property
    def tp_rank(self) -> int:
        return self.tp.rank

    @property
    def tp_size(self) -> int:
        return self.tp.size

    @property
    def mesh_shape(self) -> Tuple[int, int]:
        return (self.lp.size, self.tp.size)

    @property
    def device(self) -> torch.device:
        return self.lp.device

    @property
    def counter(self) -> WireCounter:
        return self.lp.counter

    @property
    def backend(self) -> str:
        return self.lp.backend


def lp_axis(mesh) -> LPGroup:
    """The lp group of an :class:`LPGroup` (itself) or a :class:`HybridGroup`."""
    return mesh.lp if isinstance(mesh, HybridGroup) else mesh


def tp_size(mesh) -> int:
    """The tp axis' size of a mesh: 1 off a mesh and on a 1-D group."""
    return mesh.tp_size if isinstance(mesh, HybridGroup) else 1


# ----------------------------------------------------- the sharded wire
def issue_round(group: LPGroup, rnd: Round, tag: int, shard: Optional[LPGroup] = None):
    """Start one halo round over ``group``.  With ``shard`` (the tp group)
    the round's payload, its first tensor, crosses as this rank's
    :func:`wire_shard_slice` and the rest (scale meta, identical on every
    tp rank) whole; :func:`land_round` reassembles it."""
    if shard is None:
        return group.issue(rnd, tag), None
    wire = rnd.msg[0]
    chunk = wire_shard_slice(wire, shard.rank, shard.size)
    return group.issue(Round((chunk,) + rnd.msg[1:], rnd.dst, rnd.src), tag), (wire, chunk)


def land_round(group: LPGroup, handle, shard: Optional[LPGroup] = None):
    """Wait for a round of :func:`issue_round`: the tensors received, or
    None without a sender.  Sharded, every rank then all-gathers the
    chunks over ``shard`` (a rank without a sender gathers zeros, as the
    reference's tp gather of ppermute's zeros does, so every tp rank of a
    group takes part) and unshards the payload."""
    h, sharded = handle
    got = group.land(h)
    if shard is None:
        return got
    wire, chunk = sharded
    piece = torch.zeros_like(chunk) if got is None else got[0]
    full = wire_unshard(shard.all_gather(piece), tuple(wire.shape))
    return None if got is None else (full,) + tuple(got[1:])


def sharded_ppermute(x: torch.Tensor, group: LPGroup, dst: Optional[int],
                     src: Optional[int], shard: LPGroup, tag: int = 0):
    """One point-to-point round with ``x`` sharded over ``shard``: this
    rank's 1/T chunk goes to ``dst`` across ``group``, the chunks from
    ``src`` are reassembled by one all-gather over ``shard``
    (``collectives.py:145``).  Returns ``src``'s ``x``, None without one."""
    got = land_round(group, issue_round(group, Round((x,), dst, src), tag, shard), shard)
    return None if got is None else got[0]


def sharded_all_gather(x: torch.Tensor, group: LPGroup, shard: LPGroup) -> torch.Tensor:
    """The all-gather of ``x`` over ``group`` with each contribution
    sharded over ``shard`` (``collectives.py:167``): the lp gather moves
    ``(K, 1/T chunk)``, one tp gather collects the chunk columns, and the
    ``(K,) + x.shape`` table is reassembled here."""
    rows = group.all_gather(wire_shard_slice(x, shard.rank, shard.size))
    return wire_unshard_rows(shard.all_gather(rows), tuple(x.shape))


def gather(group: LPGroup, x: torch.Tensor, shard: Optional[LPGroup] = None) -> torch.Tensor:
    """``group.all_gather(x)``, sharded over ``shard`` when given."""
    return group.all_gather(x) if shard is None else sharded_all_gather(x, group, shard)


def check_shard(group: LPGroup, shard: Optional[LPGroup]) -> Optional[LPGroup]:
    """The shard group to use: None for none or a tp axis of size 1; the
    lp group itself is refused (chunks of different senders' slabs would
    be reassembled: shapes agree, values are wrong; ``spmd.py:403``)."""
    if shard is None:
        return None
    if shard is group or (shard.group is not None and shard.group is group.group):
        raise ValueError("the shard axis must differ from the lp axis: wire chunks are "
                         "reassembled across the shard axis after the lp transfer")
    return shard if shard.size > 1 else None


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
                  eager_sends: bool = False,
                  shard_axis: Optional[LPGroup] = None) -> torch.Tensor:
    """Cross-rank reduction of overlapping window predictions, halo only.

    ``wpred``: this rank's weighted f32 prediction, partition dim first,
    zero-padded at the end by ``spec.pad`` rows.  Returns the
    ``(core_pad + max_transfer, ...)`` accumulator whose first
    ``core_len[rank]`` rows hold the sum of every rank's contribution to
    this rank's core (unnormalized): the own core first, then each
    round's slab (:func:`halo_rounds`), as the reference sums.  A rank
    without a peer in a round sends nothing and deposits nothing (the
    reference deposits ppermute's zeros, which add nothing).  ``shard_axis``
    (the tp group of a :class:`HybridGroup`) ships every slab sharded
    (:func:`issue_round`), bit-equal to the unsharded exchange."""
    shard_axis = check_shard(group, shard_axis)
    acc_len = spec.core_pad + spec.max_transfer
    rest = tuple(wpred.shape[1:])
    acc = wpred.new_zeros((acc_len,) + rest)
    off = spec.core_start[rank] - spec.starts[rank]
    acc[:spec.core_pad] = wpred[off:off + spec.core_pad]

    def issue(ti, t):
        dst, src = halo_round(t, rank)
        slab = wpred.new_empty((t.length,) + rest) if dst is None else \
            masked_slab(wpred, t, rank)
        return issue_round(group, Round((slab,), dst, src), ti, shard_axis)

    def deposit(t, handle):
        got = land_round(group, handle, shard_axis)
        if got is not None:
            dst = t.dst_start[rank]
            acc[dst:dst + t.length] += got[0]

    halo_rounds(spec, eager_sends, issue, deposit)
    return acc
