"""Process groups for LP: a port of ``repro/launch/mesh.py``.

* :func:`parse_mesh` — the ``--mesh MxT`` CLI argument (copied).
* :func:`make_lp_group` — the counterpart of ``make_hybrid_mesh(K, 1)``:
  this process's end of a ``torch.distributed`` group of K ranks, as a
  ``distributed.collectives.LPGroup`` (group, rank, device, byte
  counter).  Under ``torchrun`` it takes NCCL with one GPU a rank
  (``LOCAL_RANK``); ``device="cpu"`` takes gloo; ``backend="gloo"`` puts
  ranks that share one card on gloo (NCCL refuses two ranks of one
  communicator on the same device).  With ``tp > 1`` it is
  :func:`make_hybrid_group`.
* :func:`make_hybrid_group` — the counterpart of ``make_hybrid_mesh(M,
  T)``: world rank ``m*T + t`` is device ``(m, t)`` of ``reshape(lp,
  tp)``; this rank's lp group (the ranks with its ``t``) and tp group
  (the ranks with its ``m``) as a ``HybridGroup``.
* :func:`shrink_hybrid_group` — the counterpart of ``shrink_hybrid_mesh``:
  the survivors' group after an LP group is evicted.
* :func:`run_lp_world` — spawns a small world of ``M*T`` processes on
  this host, each running ``fn(group, *args)``, and returns their
  results.  ``fn`` must live in a module that imports no JAX (a spawned
  child imports only that module).  Every group gets a timeout and the
  world a deadline: a rank that fails fails the call, none can hang it.

NCCL with one GPU a rank (``torchrun``) is written but has run on no
machine with more than one card.
"""
from __future__ import annotations

import dataclasses
import datetime
import os
import time
import traceback
from pathlib import Path
from typing import Any, Callable, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.distributed.collectives import (HybridGroup, LPGroup, WireCounter, lp_axis,
                                                 tp_size)

GROUP_TIMEOUT_S = 60.0


def parse_mesh(spec: str) -> Tuple[int, int]:
    """Parse a ``--mesh MxT`` CLI argument into ``(lp_groups, tp)``.

    ``M`` is the LP group-axis size (== K partitions), ``T`` the
    intra-group tensor-parallel degree; ``"4x2"`` -> ``(4, 2)``.  A bare
    ``"4"`` means no tp axis, ``(4, 1)``.
    """
    parts = spec.lower().replace("×", "x").split("x")
    if not 1 <= len(parts) <= 2:
        raise ValueError(f"--mesh wants MxT (e.g. 4x2), got {spec!r}")
    try:
        m = int(parts[0])
        t = int(parts[1]) if len(parts) == 2 else 1
    except ValueError as e:
        raise ValueError(f"--mesh wants MxT (e.g. 4x2), got {spec!r}") from e
    if m < 2 or t < 1:
        raise ValueError(f"--mesh needs M>=2 LP groups and T>=1, got {spec!r}")
    return m, t


def make_lp_group(lp: int, tp: int = 1, device: DeviceLike = None,
                  backend: Optional[str] = None, init_method: Optional[str] = None,
                  rank: Optional[int] = None):
    """This process's end of an lp group of ``lp`` ranks (an ``LPGroup``),
    or with ``tp > 1`` of an ``(lp, tp)`` group (:func:`make_hybrid_group`).

    Joins the default process group if it is not up yet: ``init_method``
    and ``rank`` as given, else from ``torchrun``'s environment
    (``env://``, ``RANK``).  ``device``: ``cuda`` (default) is
    ``cuda:LOCAL_RANK`` on NCCL; ``cpu`` runs on gloo; with
    ``backend="gloo"`` CUDA ranks stage their collectives through host
    memory (ranks that share a card).  The world's size must be
    ``lp * tp``; its collectives time out after ``GROUP_TIMEOUT_S``, so a
    rank whose peer died fails instead of waiting forever.
    """
    if tp != 1:
        return make_hybrid_group(lp, tp, device, backend, init_method, rank)
    dev, _ = _join(lp, device, backend, init_method, rank)
    return LPGroup(rank=dist.get_rank(), size=lp, device=dev)


def make_hybrid_group(lp: int, tp: int, device: DeviceLike = None,
                      backend: Optional[str] = None, init_method: Optional[str] = None,
                      rank: Optional[int] = None) -> HybridGroup:
    """This process's end of an ``(lp, tp)`` group of ``lp * tp`` ranks,
    the layout of ``make_hybrid_mesh`` (``repro/launch/mesh.py:96``):
    world rank ``m*tp + t`` is LP group ``m``, tp rank ``t``.  Every rank
    makes every sub-group, in the same order (lp groups by ``t``, then tp
    groups by ``m``), as ``dist.new_group`` wants; it keeps its own two,
    which share one byte counter.  Arguments as :func:`make_lp_group`."""
    if lp < 1 or tp < 1:
        raise ValueError(f"an (lp, tp) group needs lp, tp >= 1, got ({lp}, {tp})")
    dev, backend = _join(lp * tp, device, backend, init_method, rank)
    m, t = divmod(dist.get_rank(), tp)
    timeout = datetime.timedelta(seconds=GROUP_TIMEOUT_S)
    layout = [[mm * tp + tt for tt in range(tp)] for mm in range(lp)]
    counter = WireCounter()
    mine = {}
    for tt in range(tp):
        ranks = [row[tt] for row in layout]
        pg = dist.new_group(ranks, backend=backend, timeout=timeout)
        if tt == t:
            mine["lp"] = LPGroup(m, lp, dev, pg, counter, "inter", tuple(ranks))
    for mm in range(lp):
        pg = dist.new_group(layout[mm], backend=backend, timeout=timeout)
        if mm == m:
            mine["tp"] = LPGroup(t, tp, dev, pg, counter, "intra", tuple(layout[mm]))
    return HybridGroup(lp=mine["lp"], tp=mine["tp"])


def shrink_hybrid_group(mesh, evicted_group: int, tp: Optional[int] = None):
    """The survivors' group after LP group ``evicted_group`` left
    (``repro/launch/mesh.py:57``): every other group keeps its ranks and
    tp layout, re-indexed.  ``mesh`` is a ``HybridGroup`` or a 1-D
    ``LPGroup``; ``tp``, when given, is checked against its tp size (a
    mismatch means the caller's bookkeeping diverged from the group).
    Refused below 2 LP groups.

    Only the survivors of this rank's lp ring call ``dist.new_group``
    (``use_local_synchronization=True``): the evicted ranks take no part
    and get None.  A survivor's tp group has the same members as before
    and is kept.  The counter carries over."""
    T = tp_size(mesh)
    if tp is not None and T != tp:
        raise ValueError(f"the group's tp axis has size {T}, the caller expected {tp}")
    lp = lp_axis(mesh)
    M = lp.size
    if not 0 <= evicted_group < M:
        raise ValueError(f"evicted group {evicted_group} not in [0, {M})")
    if M <= 2:
        raise ValueError(f"cannot shrink a {M}-group LP ring below 2 groups "
                         "(LP needs >= 2 partitions)")
    if lp.rank == evicted_group:
        return None
    survivors = [g for g in range(M) if g != evicted_group]
    ranks = tuple(lp.world_rank(g) for g in survivors)
    pg = dist.new_group(list(ranks), backend=lp.backend,
                        timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S),
                        use_local_synchronization=True)
    new_lp = LPGroup(survivors.index(lp.rank), M - 1, lp.device, pg, lp.counter, lp.tier,
                     ranks)
    return HybridGroup(lp=new_lp, tp=mesh.tp) if isinstance(mesh, HybridGroup) else new_lp


def _join(world: int, device: DeviceLike, backend: Optional[str], init_method: Optional[str],
          rank: Optional[int]) -> Tuple[torch.device, str]:
    """Join the default process group of ``world`` ranks (if it is not up
    yet); this rank's device and the backend."""
    dev = resolve_device(device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"LP groups run on nccl or gloo, not {backend!r}")
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError("an NCCL group needs device='cuda'")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0))
                           if backend == "nccl" else 0)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        kw = {}
        if rank is not None:
            kw.update(rank=rank, world_size=world)
        dist.init_process_group(backend, init_method=init_method or "env://",
                                timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S), **kw)
    size = dist.get_world_size()
    if size != world:
        raise ValueError(f"the process group has {size} ranks, the group wants {world}")
    if dist.get_backend() != backend:
        raise ValueError(f"the process group runs {dist.get_backend()!r}, wanted {backend!r}")
    return dev, backend


@dataclasses.dataclass(frozen=True)
class Evicted:
    """What :func:`run_lp_world` returns for a rank whose LP group was
    evicted mid-request (the engine raised ``runtime.faults.GroupEvicted``
    on it): the rank left the world on purpose, which counts as success."""

    rank: int
    group: int
    step: Optional[int]


def _rank_main(rank: int, size: int, tp: int, init_file: str, out_file: str, fn: Callable,
               args: Tuple, device: str, backend: Optional[str],
               threads: Optional[int]) -> None:
    """One spawned rank: join the group, run ``fn``, save its result (or
    its traceback) to ``out_file``.  A rank evicted from its LP ring
    (``GroupEvicted``) saves an :class:`Evicted` as its result."""
    from repro_torch.runtime.faults import GroupEvicted

    if threads:
        torch.set_num_threads(threads)
    try:
        group = make_lp_group(size, tp, device=device, backend=backend,
                              init_method=f"file://{init_file}", rank=rank)
        try:
            result = {"ok": True, "result": fn(group, *args)}
        except GroupEvicted as e:
            result = {"ok": True, "result": Evicted(rank, e.group, e.step)}
    except BaseException:             # the parent reports it; the exit code stops the world
        torch.save({"ok": False, "error": traceback.format_exc()}, out_file)
        raise
    torch.save(result, out_file)
    dist.destroy_process_group()


def run_lp_world(fn: Callable, size: int, args: Sequence[Any] = (), *, workdir: str,
                 tp: int = 1, device: DeviceLike = None, backend: Optional[str] = None,
                 deadline_s: float = 600.0, threads: Optional[int] = 1) -> List[Any]:
    """Run ``fn(group, *args)`` on each rank of a fresh world of
    ``size * tp`` spawned processes (``file://`` rendezvous and the
    ranks' results under ``workdir``) and return the ranks' results in
    world-rank order.  Each rank's group is :func:`make_lp_group`'s
    (``size``, ``tp``, ``device``, ``backend``; ``cuda`` by default,
    ``device="cpu"`` for a gloo world on the CPU): an ``LPGroup`` at
    ``tp = 1``, a ``HybridGroup`` beyond.  A rank that raises, or a world
    past ``deadline_s`` seconds, raises here after every process has been
    stopped; an evicted rank (:class:`Evicted`) is a success.  ``threads``:
    torch's CPU threads in each rank (1 keeps a CPU world from
    oversubscribing the host)."""
    import torch.multiprocessing as mp

    device = str(resolve_device(device))      # no card: raise before spawning
    work = Path(workdir)
    work.mkdir(parents=True, exist_ok=True)
    init = work / f"init_{os.getpid()}_{time.monotonic_ns()}"
    world = size * tp
    outs = [work / f"{init.name}_rank{r}.pt" for r in range(world)]
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_main,
                         args=(r, size, tp, str(init), str(outs[r]), fn, tuple(args), device,
                               backend, threads), daemon=True)
             for r in range(world)]
    for p in procs:
        p.start()
    end = time.monotonic() + deadline_s
    try:
        while any(p.is_alive() for p in procs):
            failed = [r for r, p in enumerate(procs) if p.exitcode not in (None, 0)]
            if failed or time.monotonic() > end:
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join(5)
    results, errors = [], []
    for r, p in enumerate(procs):
        res = torch.load(outs[r], weights_only=False) if outs[r].exists() else None
        if res is None:
            errors.append(f"rank {r}: exit code {p.exitcode}, no result"
                          + (" (deadline passed)" if time.monotonic() > end else ""))
        elif not res["ok"]:
            errors.append(f"rank {r}:\n{res['error']}")
        else:
            results.append(res["result"])
    for f in outs + [init]:
        f.unlink(missing_ok=True)
    if errors:
        raise RuntimeError("LP world failed:\n" + "\n".join(errors))
    return results
