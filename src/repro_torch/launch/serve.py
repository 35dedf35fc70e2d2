"""Serving CLI of the port — LP video generation on one GPU.

  PYTHONPATH=src python -m repro_torch.launch.serve --requests 4 --steps 6 \
      --partitions 2 --overlap 0.5 [--lp-impl auto] [--wire-codec int8-residual] \
      [--device cuda|cpu]

Serves ``wan21-dit-1.3b`` at its published widths in bf16 with random
weights.  ``--wire-codec`` (or ``--lp-impl halo``) runs every step through
the single-process halo wire mirror (``comm/wire.simulate_halo_forward``).
The codec-schedule, mesh, elastic, fault-drill and observability flags
of the reference CLI are not ported yet (ROADMAP Queue 1 items 6-10).
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
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config("wan21-dit-1.3b")
    model = dit.init_params(cfg, generator(0, device), device)
    engine = LPServingEngine(model, cfg, num_partitions=args.partitions,
                             overlap_ratio=args.overlap, num_steps=args.steps,
                             lp_impl=args.lp_impl, wire_codec=args.wire_codec,
                             wire_nan_guard=args.wire_nan_guard, device=device)
    print(f"engine: lp_impl={engine.lp_impl} codec={engine.codec.name} tp=1 "
          f"device={device}")
    for i in range(args.requests):
        engine.submit(VideoRequest(
            request_id=i,
            context=frontends.text_context(generator(i, device), 1, cfg, device),
            latent_shape=(args.frames_latent, 8, 12),
            seed=i,
        ))
    results = engine.run()
    for r in sorted(results, key=lambda x: x.request_id):
        resumed = f" resumed_from={r.resumed_from_step}" if r.restarts else ""
        print(f"request {r.request_id}: latent {tuple(r.latent.shape)} "
              f"steps={r.num_steps} wait={r.queue_wait_s:.2f}s "
              f"e2e={r.e2e_s:.2f}s batch_wall={r.batch_wall_s:.1f}s "
              f"batch={r.batch_size} restarts={r.restarts}{resumed}")


if __name__ == "__main__":
    main()
