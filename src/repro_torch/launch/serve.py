"""Serving CLI of the port — LP video generation on one GPU or an lp group.

  PYTHONPATH=src python -m repro_torch.launch.serve --requests 4 --steps 6 \
      --partitions 2 --overlap 0.5 [--lp-impl auto] [--wire-codec int8-residual] \
      [--device cuda|cpu]

  PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.serve \
      --partitions 4 --mesh 4 [--wire-codec int8] [--eager-sends]

Serves ``wan21-dit-1.3b`` at its published widths in bf16 with random
weights.  ``--wire-codec`` (or ``--lp-impl halo``) runs every step through
the single-process halo wire mirror (``comm/wire.simulate_halo_forward``).
``--mesh M`` (or ``Mx1``; M must equal ``--partitions``) serves across an
lp group of M ranks, one window each: under ``torchrun`` on NCCL with one
GPU a rank, with ``--device cpu`` on gloo (a world started by
``launch/mesh.run_lp_world``, or ``torchrun`` with the gloo ranks on the
CPU).  Every rank serves the same requests; only rank 0 prints them.
The codec-schedule, elastic, fault-drill and observability flags of the
reference CLI, and a tp axis, are not ported yet (ROADMAP Queue 1
items 7-10).
"""
from __future__ import annotations

import argparse

from repro_torch.comm.codecs import CODEC_NAMES
from repro_torch.configs import get_config
from repro_torch.device import generator, resolve_device
from repro_torch.models import dit, frontends
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
                    help="LP engine; auto = psum math at K=2, halo beyond.  On one "
                         "device the halo family runs the wire mirror when a codec "
                         "is active or halo is named, the uniform engine otherwise")
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
                    help="M or Mx1: serve across an lp group of M ranks (M must equal "
                         "--partitions); NCCL under torchrun, gloo with --device cpu")
    ap.add_argument("--eager-sends", default=None, action=argparse.BooleanOptionalAction,
                    help="issue all halo rounds before the first deposit (default off "
                         "on a 1-D mesh)")
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
                             eager_sends=args.eager_sends)
    lead = mesh is None or mesh.rank == 0
    if lead:
        ranks = "" if mesh is None else f" ranks={mesh.size} backend={mesh.backend}"
        print(f"engine: lp_impl={engine.lp_impl} codec={engine.codec.name} tp=1 "
              f"device={device} eager_sends={engine.eager_sends}{ranks}")
    for i in range(args.requests):
        engine.submit(VideoRequest(
            request_id=i,
            context=frontends.text_context(generator(i, device), 1, cfg, device),
            latent_shape=(args.frames_latent, 8, 12),
            seed=i,
        ))
    results = engine.run()
    if not lead:
        return
    for r in sorted(results, key=lambda x: x.request_id):
        resumed = f" resumed_from={r.resumed_from_step}" if r.restarts else ""
        print(f"request {r.request_id}: latent {tuple(r.latent.shape)} "
              f"steps={r.num_steps} wait={r.queue_wait_s:.2f}s "
              f"e2e={r.e2e_s:.2f}s batch_wall={r.batch_wall_s:.1f}s "
              f"batch={r.batch_size} restarts={r.restarts}{resumed}")


if __name__ == "__main__":
    main()
