"""Serving CLI of the port — LP video generation on one GPU or a group.

  PYTHONPATH=src python -m repro_torch.launch.serve --requests 4 --steps 6 \
      --partitions 2 --overlap 0.5 [--lp-impl auto] [--wire-codec int8-residual] \
      [--device cuda|cpu] [--elastic] [--inject-fault dead:3@2]

  PYTHONPATH=src torchrun --nproc-per-node 6 -m repro_torch.launch.serve \
      --partitions 3 --mesh 3x2 [--wire-codec int8] [--no-wire-shard] \
      [--eager-sends] [--elastic --inject-fault dead:1@3]

Serves ``wan21-dit-1.3b`` at its published widths in bf16 with random
weights.  ``--wire-codec`` (or ``--lp-impl halo``) runs every step through
the single-process halo wire mirror (``comm/wire.simulate_halo_forward``).
``--mesh MxT`` (M must equal ``--partitions``) serves across a group of
M*T ranks, M LP groups of T: under ``torchrun`` on NCCL with one GPU a
rank, with ``--device cpu`` on gloo (a world started by
``launch/mesh.run_lp_world``, or ``torchrun`` with the gloo ranks on the
CPU).  At T > 1 every rank runs the DiT on its group's window and the
halo wire is sharded over the tp ranks (``--no-wire-shard`` ships it
whole).  Every rank serves the same requests; only rank 0 prints them.
``--elastic`` evicts dead or straggling LP groups mid-request;
``--inject-fault`` scripts a drill (``runtime/faults.py``).  The ranks of
an evicted group leave (rank 0 says so if it was one of them).  The
codec-schedule and observability flags of the reference CLI are not
ported yet (ROADMAP Queue 1 items 7 and 9).
"""
from __future__ import annotations

import argparse

import torch.distributed as dist

from repro_torch.comm.codecs import CODEC_NAMES
from repro_torch.configs import get_config
from repro_torch.device import generator, resolve_device
from repro_torch.models import dit, frontends
from repro_torch.runtime.faults import GroupEvicted
from repro_torch.serving.engine import LPServingEngine, VideoRequest


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--steps", type=int, default=6)
    ap.add_argument("--partitions", type=int, default=2)
    ap.add_argument("--overlap", type=float, default=0.5)
    ap.add_argument("--frames-latent", type=int, default=6)
    ap.add_argument("--lp-impl", default="auto",
                    choices=["auto", "uniform", "shard_map", "halo", "halo_hybrid"],
                    help="LP engine; auto = psum math at K=2, halo beyond (hybrid halo "
                         "when the mesh has a tp axis).  On one device the halo family "
                         "runs the wire mirror when a codec is active or halo is named, "
                         "the uniform engine otherwise")
    ap.add_argument("--wire-codec", default=None, choices=list(CODEC_NAMES),
                    help="compress LP halo wire payloads (fixed codec)")
    ap.add_argument("--wire-nan-guard", default=True,
                    action=argparse.BooleanOptionalAction,
                    help="absorb NaN/Inf wire payloads by falling back to the "
                         "rank-local stale slab (bit-identical when every message "
                         "is finite)")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    ap.add_argument("--mesh", default=None,
                    help="MxT: serve across M LP groups of T ranks (M must equal "
                         "--partitions); NCCL under torchrun, gloo with --device cpu")
    ap.add_argument("--wire-shard", default=None, action=argparse.BooleanOptionalAction,
                    help="shard every halo payload over the tp ranks (1/T chunks across "
                         "the lp group, one tp all-gather; the same values).  Default: on "
                         "for a mesh with a tp axis")
    ap.add_argument("--eager-sends", default=None, action=argparse.BooleanOptionalAction,
                    help="issue all halo rounds before the first deposit.  Default: on "
                         "for a mesh with a tp axis")
    ap.add_argument("--elastic", action="store_true",
                    help="mid-request re-planning: the per-step hook evicts dead or "
                         "straggling LP groups through the health monitor")
    ap.add_argument("--inject-fault", default=None,
                    help="scripted serving-fault drill, e.g. 'dead:1@4,slow:0x2,corrupt@2'; "
                         "dead/slow need --elastic to recover")
    args = ap.parse_args(argv)

    mesh = None
    if args.mesh:
        from repro_torch.launch.mesh import make_lp_group, parse_mesh

        m, t = parse_mesh(args.mesh)
        if m != args.partitions:
            raise SystemExit(f"--mesh {args.mesh}: LP axis {m} != --partitions "
                             f"{args.partitions}")
        mesh = make_lp_group(m, t, device=args.device)
        device = mesh.device
    else:
        device = resolve_device(args.device)
    cfg = get_config("wan21-dit-1.3b")
    model = dit.init_params(cfg, generator(0, device), device)
    engine = LPServingEngine(model, cfg, num_partitions=args.partitions,
                             overlap_ratio=args.overlap, num_steps=args.steps,
                             lp_impl=args.lp_impl, wire_codec=args.wire_codec,
                             wire_nan_guard=args.wire_nan_guard, device=device, mesh=mesh,
                             eager_sends=args.eager_sends, wire_shard=args.wire_shard,
                             elastic=args.elastic, inject_fault=args.inject_fault)
    lead = mesh is None or dist.get_rank() == 0
    if lead:
        ranks = "" if mesh is None else \
            f" ranks={dist.get_world_size()} backend={mesh.backend}"
        print(f"engine: lp_impl={engine.lp_impl} codec={engine.codec.name} tp={engine.tp} "
              f"wire_shard={engine.wire_shard} device={device} "
              f"eager_sends={engine.eager_sends}{ranks}")
        if engine._fault_plan is not None:
            print(f"fault drill: {engine._fault_plan.describe()} (elastic={engine.elastic}, "
                  f"nan_guard={engine.wire_nan_guard})")
    for i in range(args.requests):
        engine.submit(VideoRequest(
            request_id=i,
            context=frontends.text_context(generator(i, device), 1, cfg, device),
            latent_shape=(args.frames_latent, 8, 12),
            seed=i,
        ))
    try:
        results = engine.run()
    except GroupEvicted as e:
        if lead:
            print(f"elastic: this rank's LP group {e.group} was evicted before step "
                  f"{e.step}; the survivors go on without it")
        return
    if not lead:
        return
    for r in sorted(results, key=lambda x: x.request_id):
        resumed = f" resumed_from={r.resumed_from_step}" if r.restarts else ""
        print(f"request {r.request_id}: latent {tuple(r.latent.shape)} "
              f"steps={r.num_steps} wait={r.queue_wait_s:.2f}s "
              f"e2e={r.e2e_s:.2f}s batch_wall={r.batch_wall_s:.1f}s "
              f"batch={r.batch_size} restarts={r.restarts}{resumed}")
    if engine.evictions:
        print(f"elastic: evictions={engine.evictions} K={engine.K} "
              f"steps_lost={engine.last_steps_lost}")


if __name__ == "__main__":
    main()
