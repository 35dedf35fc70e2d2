"""LP groups of processes: the 1-D part of ``repro/launch/mesh.py``.

* :func:`parse_mesh` — the ``--mesh MxT`` CLI argument (copied).
* :func:`make_lp_group` — the counterpart of ``make_hybrid_mesh(K, 1)``:
  this process's end of a ``torch.distributed`` group of K ranks, as a
  ``distributed.collectives.LPGroup`` (group, rank, device, byte
  counter).  Under ``torchrun`` it takes NCCL with one GPU a rank
  (``LOCAL_RANK``); ``device="cpu"`` takes gloo; ``backend="gloo"`` puts
  ranks that share one card on gloo (NCCL refuses two ranks of one
  communicator on the same device).
* :func:`run_lp_world` — spawns a small world of K processes on this
  host, each running ``fn(group, *args)``, and returns their results.
  ``fn`` must live in a module that imports no JAX (a spawned child
  imports only that module).  Every group gets a timeout and the world a
  deadline: a rank that fails fails the call, none can hang it.

A tp axis (T > 1) is ROADMAP Queue 1 item 8.
"""
from __future__ import annotations

import datetime
import os
import time
import traceback
from pathlib import Path
from typing import Any, Callable, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.distributed.collectives import LPGroup

HYBRID = "ROADMAP Queue 1 item 8 (hybrid LP x TP)"
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
                  rank: Optional[int] = None) -> LPGroup:
    """This process's end of an lp group of ``lp`` ranks.

    Joins the default process group if it is not up yet: ``init_method``
    and ``rank`` as given, else from ``torchrun``'s environment
    (``env://``, ``RANK``).  ``device``: ``cuda`` (default) is
    ``cuda:LOCAL_RANK`` on NCCL; ``cpu`` runs on gloo; with
    ``backend="gloo"`` CUDA ranks stage their collectives through host
    memory (ranks that share a card).  The group's size must be ``lp``;
    its collectives time out after ``GROUP_TIMEOUT_S``, so a rank whose
    peer died fails instead of waiting forever.
    """
    if tp != 1:
        raise NotImplementedError(f"a tp axis (T={tp}) is not ported yet: {HYBRID}")
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
            kw.update(rank=rank, world_size=lp)
        dist.init_process_group(backend, init_method=init_method or "env://",
                                timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S), **kw)
    size, me = dist.get_world_size(), dist.get_rank()
    if size != lp:
        raise ValueError(f"the process group has {size} ranks, the lp group wants {lp}")
    if dist.get_backend() != backend:
        raise ValueError(f"the process group runs {dist.get_backend()!r}, wanted {backend!r}")
    return LPGroup(rank=me, size=size, device=dev)


def _rank_main(rank: int, size: int, init_file: str, out_file: str, fn: Callable,
               args: Tuple, device: str, backend: Optional[str],
               threads: Optional[int]) -> None:
    """One spawned rank: join the group, run ``fn``, save its result (or
    its traceback) to ``out_file``."""
    if threads:
        torch.set_num_threads(threads)
    try:
        group = make_lp_group(size, device=device, backend=backend,
                              init_method=f"file://{init_file}", rank=rank)
        result = {"ok": True, "result": fn(group, *args)}
    except BaseException:             # the parent reports it; the exit code stops the world
        torch.save({"ok": False, "error": traceback.format_exc()}, out_file)
        raise
    torch.save(result, out_file)
    dist.destroy_process_group()


def run_lp_world(fn: Callable, size: int, args: Sequence[Any] = (), *, workdir: str,
                 device: DeviceLike = None, backend: Optional[str] = None,
                 deadline_s: float = 600.0, threads: Optional[int] = 1) -> List[Any]:
    """Run ``fn(group, *args)`` on each rank of a fresh world of ``size``
    spawned processes (``file://`` rendezvous and the ranks' results
    under ``workdir``) and return the ranks' results in rank order.
    ``device`` and ``backend`` go to each rank's :func:`make_lp_group`
    (``cuda`` by default; ``device="cpu"`` for a gloo world on the CPU).
    A rank that raises, or a world past ``deadline_s`` seconds, raises
    here after every process has been stopped.  ``threads``: torch's CPU
    threads in each rank (1 keeps a CPU world from oversubscribing the
    host)."""
    import torch.multiprocessing as mp

    device = str(resolve_device(device))      # no card: raise before spawning
    work = Path(workdir)
    work.mkdir(parents=True, exist_ok=True)
    init = work / f"init_{os.getpid()}_{time.monotonic_ns()}"
    outs = [work / f"{init.name}_rank{r}.pt" for r in range(size)]
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_main,
                         args=(r, size, str(init), str(outs[r]), fn, tuple(args), device,
                               backend, threads), daemon=True)
             for r in range(size)]
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
