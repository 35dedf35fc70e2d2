"""Serving load-test CLI of the port — offered-load replay + SLO report.
A port of ``repro/launch/loadtest.py``.

  PYTHONPATH=src python -m repro_torch.launch.loadtest --rate 2 --requests 12 \
      --steps 4 --partitions 2 [--arrivals poisson] [--seed 0] [--device cuda|cpu] \
      [--mix 'clip,shape=6x8x12,priority=interactive;...'] \
      [--slo 'interactive:30@0.99,standard:120@0.95'] \
      [--trace-out artifacts/load_trace.json] \
      [--metrics-out artifacts/load_metrics.jsonl] \
      [--report-out artifacts/slo_report.json]

Serves ``wan21-dit-1.3b`` at its published widths in bf16 with random
weights (seed 0), as ``launch/serve.py`` does, on the card unless
``--device cpu`` is given.  A seeded workload (``serving/loadgen.py`` —
Poisson or deterministic arrivals over a request-mix of ``(latent_shape,
guidance, psnr_floor, priority)`` classes) is replayed open-loop on a
virtual clock the engine advances by each batch's measured, synchronised
wall; then every request's lifecycle stamps are evaluated against the
``--slo`` deadlines (``obs/slo.py``): per-class queue-wait and e2e
p50/p99, violations, burn rate, goodput per device.  Before the replay,
every ``(shape, guidance)`` bucket in the workload is served at each batch
size 1..max_batch on a throwaway clock with no recorder, so no measured
batch pays a step-cache miss inside its wall (``--skip-warm`` disables;
the report's ``warmed`` field records which).

Offline mode re-derives the SAME report from a previously written trace
artifact — no engine, no torch device::

  python -m repro_torch.launch.loadtest --report-from artifacts/load_trace.json \
      [--slo ...] [--num-devices N]

Because the evaluator only ever reads the raw stamps, the offline report
equals the live one for the same serve (``tests/test_torch_loadgen.py``
and ``chip_smoke.py``'s phase ``serve_fleet`` hold them equal).

Fleet mode (``--replicas N``, N >= 2) serves the same workload through
``serving/router.ReplicaRouter`` — N engine replicas sharing one DiT
module, each with its own step cache and virtual clock, behind one
front-door queue with admission control (``--shed-watermark``),
redispatch on replica loss (``--max-redispatch``; kill a replica mid-run
with ``--inject-fault replica:1:dead@3``) and graceful quality
degradation.  The SLO report gains per-replica sections and disposition
accounting (completed / shed / terminally failed).

``--mesh MxT`` (M must equal ``--partitions``) serves across a group of
M*T ranks under ``torchrun`` (NCCL, one GPU a rank; gloo with
``--device cpu``), as ``serve --mesh`` does: every rank builds the same
workload and the same replicas, the engines' ranks agree on each batch's
wall, and only rank 0 prints and writes files.
"""
from __future__ import annotations

import argparse
import json
import os

from repro_torch.configs import get_config


def _add_engine_args(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--partitions", type=int, default=2)
    ap.add_argument("--overlap", type=float, default=0.5)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--lp-impl", default="auto",
                    choices=["auto", "uniform", "shard_map", "halo",
                             "halo_hybrid"])
    ap.add_argument("--wire-codec", default=None)
    ap.add_argument("--codec-schedule", default=None)
    ap.add_argument("--psnr-floor", type=float, default=None)
    ap.add_argument("--mesh", default=None,
                    help="MxT group of ranks under torchrun; M must equal "
                         "--partitions")
    ap.add_argument("--max-queue", type=int, default=None,
                    help="bound each engine queue: submit raises "
                         "QueueFull beyond this many queued requests "
                         "(default: unbounded)")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")


def _add_router_args(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--replicas", type=int, default=1,
                    help="serve through a ReplicaRouter over this many "
                         "engine replicas (1 = direct single-engine "
                         "replay)")
    ap.add_argument("--router-policy", default="least-loaded",
                    choices=["least-loaded", "round-robin"])
    ap.add_argument("--inject-fault", default=None,
                    help="fault drill plan; with --replicas scope "
                         "chunks per replica, e.g. 'replica:1:dead@3,"
                         "replica:0:slow:0x2' (runtime/faults.py)")
    ap.add_argument("--max-redispatch", type=int, default=2,
                    help="redispatch attempts for a request lost to a "
                         "replica death before terminal failure")
    ap.add_argument("--shed-watermark", type=int, default=None,
                    help="aggregate queue depth beyond which the "
                         "lowest-priority requests are shed (default: "
                         "8 x total batch capacity)")
    ap.add_argument("--degrade-watermark", type=int, default=None,
                    help="queue depth that triggers stepwise psnr_floor "
                         "relaxation (default: half the shed watermark)")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--rate", type=float, default=2.0,
                    help="offered load, requests/second (virtual time)")
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--arrivals", default="poisson",
                    choices=["poisson", "deterministic"])
    ap.add_argument("--seed", type=int, default=0,
                    help="workload seed: arrivals, mix assignment and "
                         "per-request latent seeds are all drawn from it "
                         "(same seed -> byte-identical workload)")
    ap.add_argument("--mix", default=None,
                    help="request-mix classes, ';'-separated "
                         "'name,shape=TxHxW[,guidance=G][,priority=P]"
                         "[,weight=W][,psnr=F]' (default: built-in 3-class "
                         "mix)")
    ap.add_argument("--slo", default=None,
                    help="SLO spec 'priority:deadline_s[@target],...' "
                         "(default: obs/slo.py DEFAULT_SLO_SPEC)")
    ap.add_argument("--num-devices", type=int, default=None,
                    help="devices the goodput is normalized over (default: "
                         "the ranks of --mesh, else torch.cuda.device_count() "
                         "on the card and 1 on the CPU; 1 offline)")
    ap.add_argument("--trace-out", default=None,
                    help="write the lifecycle trace artifact here (input "
                         "to --report-from)")
    ap.add_argument("--metrics-out", default=None,
                    help="write a metrics snapshot (.prom/.txt -> "
                         "Prometheus, else JSONL)")
    ap.add_argument("--report-out", default=None,
                    help="write the SLO report JSON here")
    ap.add_argument("--report-from", default=None, metavar="TRACE_JSON",
                    help="offline: recompute the SLO report from a trace "
                         "artifact instead of serving")
    ap.add_argument("--skip-warm", action="store_true",
                    help="skip serving every (shape, guidance) x batch-size "
                         "bucket before the replay; the first batch of each "
                         "then pays its step-cache misses inside the "
                         "measured wall, biasing the virtual timeline and "
                         "the SLO quantiles")
    _add_engine_args(ap)
    _add_router_args(ap)
    args = ap.parse_args(argv)

    from repro_torch.obs.slo import (
        SLOSpec,
        evaluate_slo,
        failures_from_trace,
        format_report,
        rows_from_trace,
        shed_from_trace,
    )

    if args.report_from:
        with open(args.report_from) as f:
            doc = json.load(f)
        rows = rows_from_trace(doc)
        shed = shed_from_trace(doc)
        failed = failures_from_trace(doc)
        # a routed serve is recognizable from its artifact alone (rows
        # carry replica identities / shed / terminal-failure events);
        # only then does the report gain the disposition block, so a
        # single-engine offline report stays byte-identical to its
        # live form
        routed = (shed or failed
                  or any(r.get("replica") is not None for r in rows))
        report = evaluate_slo(
            rows, spec=args.slo, num_devices=args.num_devices or 1,
            shed_rows=shed if routed else None,
            failed_rows=failed if routed else None)
        report["source"] = "trace"
        print(format_report(report))
        if args.report_out:
            _write_json(args.report_out, report)
            print(f"report: {args.report_out}")
        return report

    import torch
    import torch.distributed as dist

    from repro_torch.device import generator, resolve_device
    from repro_torch.models import dit
    from repro_torch.obs import FlightRecorder
    from repro_torch.serving.engine import LPServingEngine
    from repro_torch.serving.loadgen import (
        VirtualClock,
        WorkloadSpec,
        build_workload,
        parse_mix,
        run_workload,
        workload_digest,
    )

    if args.replicas < 1:
        raise SystemExit(f"--replicas must be >= 1, got {args.replicas}")
    mesh = None
    if args.mesh:
        from repro_torch.launch.mesh import make_lp_group, parse_mesh

        m, t = parse_mesh(args.mesh)
        if m != args.partitions:
            raise SystemExit(f"--mesh {args.mesh}: LP axis {m} != "
                             f"--partitions {args.partitions}")
        mesh = make_lp_group(m, t, device=args.device)
        device = mesh.device
    else:
        device = resolve_device(args.device)
    lead = mesh is None or dist.get_rank() == 0
    say = print if lead else (lambda *a, **k: None)

    spec = WorkloadSpec(rate_rps=args.rate, num_requests=args.requests,
                        arrivals=args.arrivals, seed=args.seed,
                        mix=parse_mix(args.mix))
    workload = build_workload(spec)
    say(f"workload: {len(workload)} requests at {args.rate}rps "
        f"({args.arrivals}, seed={args.seed}) "
        f"digest={workload_digest(workload)[:12]}")

    cfg = get_config("wan21-dit-1.3b")
    model = dit.init_params(cfg, generator(0, device), device)
    recorder = FlightRecorder()
    slo = SLOSpec.parse(args.slo)   # None -> documented default spec

    def _make_engine(inject_fault=None):
        # built without the recorder and on a throwaway clock: the
        # warm-up batches must pollute neither the trace nor the
        # replay's virtual timeline; both are swapped in post-warm.
        # Every replica serves the same DiT module (one copy of the
        # weights) through its own step cache.
        return LPServingEngine(model, cfg, num_partitions=args.partitions,
                               overlap_ratio=args.overlap,
                               num_steps=args.steps,
                               max_batch=args.max_batch,
                               max_queue=args.max_queue,
                               lp_impl=args.lp_impl,
                               wire_codec=args.wire_codec,
                               codec_schedule=args.codec_schedule,
                               psnr_floor=args.psnr_floor,
                               device=device, mesh=mesh,
                               inject_fault=inject_fault,
                               recorder=None,
                               clock=VirtualClock(),
                               slo=slo)

    if args.num_devices is not None:
        num_devices = args.num_devices
    elif mesh is not None:
        num_devices = dist.get_world_size()
    else:
        num_devices = torch.cuda.device_count() if device.type == "cuda" else 1
    if args.replicas == 1:
        clock = VirtualClock()
        engine = _make_engine(inject_fault=args.inject_fault)
        say(f"engine: lp_impl={engine.lp_impl} K={engine.K} "
            f"max_batch={engine.max_batch} steps={args.steps} "
            f"device={device} slo={engine.slo.spec}")
        if not args.skip_warm:
            nkeys = _warm_compiles(engine, cfg, workload)
            say(f"warm: {nkeys} bucket key(s) x batch sizes "
                f"1..{engine.max_batch} "
                f"({engine._compiler.compiles} step-cache misses pre-replay)")
        engine.recorder = recorder
        engine.clock = clock
        results = run_workload(engine, workload)
        report = evaluate_slo(recorder.request_rows, spec=engine.slo,
                              num_devices=num_devices,
                              recorder=recorder)
    else:
        from repro_torch.serving.router import ReplicaRouter

        engines = [_make_engine() for _ in range(args.replicas)]
        if not args.skip_warm:
            for r, eng in enumerate(engines):
                nkeys = _warm_compiles(eng, cfg, workload)
                say(f"warm replica {r}: {nkeys} bucket key(s) "
                    f"({eng._compiler.compiles} step-cache misses)")
        for eng in engines:
            eng.recorder = recorder
            eng.clock = VirtualClock()   # fresh, per-replica
        router = ReplicaRouter(
            engines, recorder=recorder, slo=slo,
            policy=args.router_policy,
            max_redispatch=args.max_redispatch,
            shed_watermark=args.shed_watermark,
            degrade_watermark=args.degrade_watermark,
            inject_fault=args.inject_fault)
        say(f"router: {args.replicas} replicas "
            f"policy={args.router_policy} "
            f"shed_watermark={router.shed_watermark} "
            f"max_redispatch={router.max_redispatch}"
            + (f" fault={args.inject_fault}" if args.inject_fault
               else ""))
        results = router.serve(workload)
        clock = max((rep.clock for rep in router.replicas),
                    key=lambda c: c.now)
        report = evaluate_slo(recorder.request_rows, spec=router.slo,
                              num_devices=num_devices,
                              recorder=recorder,
                              shed_rows=recorder.shed_rows,
                              failed_rows=recorder.failed_rows)
        report["router"] = {
            "replicas": args.replicas,
            "policy": args.router_policy,
            "states": [rep.state for rep in router.replicas],
            "degrade_level": router.degrade_level,
            **router.stats,
        }
    report["source"] = "live"
    report["warmed"] = not args.skip_warm
    report["workload"] = {
        "rate_rps": args.rate, "requests": len(workload),
        "arrivals": args.arrivals, "seed": args.seed,
        "digest": workload_digest(workload),
    }
    if not lead:
        return report
    print(format_report(report))
    print(f"served: {len(results)} results over "
          f"{report.get('makespan_s', 0.0):.2f}s virtual "
          f"({clock.now:.2f}s clock)")

    if args.trace_out:
        _ensure_dir(args.trace_out)
        recorder.write_trace(args.trace_out)
        print(f"trace: {args.trace_out} "
              f"({len(recorder.trace.events)} events)")
    if args.metrics_out:
        _ensure_dir(args.metrics_out)
        recorder.write_metrics(args.metrics_out)
        print(f"metrics: {args.metrics_out}")
    if args.report_out:
        _write_json(args.report_out, report)
        print(f"report: {args.report_out}")
    return report


def _warm_compiles(engine, cfg, workload) -> int:
    """Serve every ``(shape, guidance)`` bucket the replay can admit once at
    every batch size ``1..max_batch`` before the measured replay.

    Batch size is in the step-cache key and admission is ragged, so
    otherwise the first batch of each shape pays its step-cache misses
    (and the kernels' first launches) inside the measured wall, and
    ``_denoise_batch`` advances the virtual clock by that wall, biasing
    every downstream quantile and SLO verdict.  The engine must be on a
    throwaway clock with no recorder attached.  ``engine._compiler.compiles``
    counts the misses.
    """
    from repro_torch.device import generator
    from repro_torch.models import frontends
    from repro_torch.serving.engine import VideoRequest

    keys = sorted({(tuple(a.cls.latent_shape), float(a.cls.guidance))
                   for a in workload})
    rid = 1_000_000_000          # out of any real workload's id space
    for shape, guidance in keys:
        for n in range(1, engine.max_batch + 1):
            for _ in range(n):
                engine.submit(VideoRequest(
                    request_id=rid,
                    context=frontends.text_context(
                        generator(rid, engine.device), 1, cfg, engine.device),
                    latent_shape=shape, seed=rid, guidance=guidance))
                rid += 1
            engine.run()
    return len(keys)


def _ensure_dir(path: str) -> None:
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)


def _write_json(path: str, obj: dict) -> None:
    _ensure_dir(path)
    with open(path, "w") as f:
        json.dump(obj, f, indent=2, sort_keys=True)
        f.write("\n")


if __name__ == "__main__":
    main()
