"""The chip smoke's own rules, on the CPU.

* ``chip_smoke.device_ms`` (the profiler faked) sums the kernel records
  of a profiled window of ``reps`` calls.  A window that holds other
  than ``reps`` times one call's records is taken again; one still
  short after 3 tries gives no number (None), and ``timed_case`` flags
  the case with ``profiler_short`` and writes its time as JSON null.
* Phase ``serve_fleet`` in one process (the plain versions, the reduced
  DiT in f32; the fleet's arrival rates raised to the CPU's walls): its
  checks hold there too.  Phases ``lp_ranks``, ``hybrid_ranks`` and
  ``serve_policy`` are in files of their own
  (``test_torch_smoke_<phase>.py``), so that ``--dist loadfile`` spreads
  them over the workers.
* ``same_report`` holds an offline SLO report to the live one byte for
  byte, apart from the load-test CLI's notes on the live serve.
* Phase ``train``'s arithmetic: the flash launches a train step makes,
  and the hybrid model's SSD scan launches beside them (counted on the
  CPU by stand-in wrappers), the steps ``run_training`` runs around an
  injected failure (counted on a real run), the flash and SSD backward
  kernels' work and bound, and the model operations of a step; the
  xLSTM's grouped-scan launches a train step makes (train (f)) and the
  train CLI's (phase ``train_cli``), the grouped backward's work and
  bound, the device split's names of the new kernels, and the CLI's
  weights drawn on the CPU for both devices.
"""
import dataclasses
import importlib
import json
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def smoke():
    # importable by name: phase lp_ranks sends its rank function to
    # spawned processes, which import chip_smoke (and no JAX)
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    return importlib.import_module("chip_smoke")


def _fake_profiler(monkeypatch, records_per_window):
    """``torch.profiler.profile`` replaced by a window whose kernel record
    count is ``records_per_window(calls)``, 2 us of device time each, and
    whose marker kernel (``torch.cuda._sleep``), where one was launched,
    is a record of its own, 50 us long."""
    calls = []

    class Window:
        def __init__(self, activities):
            self.n = 0
            self.marked = False

        def __enter__(self):
            calls.append(self)
            return self

        def __exit__(self, *exc):
            return False

        def key_averages(self):
            count = records_per_window(self.n)
            marker = [SimpleNamespace(device_type=torch.autograd.DeviceType.CUDA,
                                      key="void at::cuda::(anonymous namespace)::spin_kernel",
                                      count=1, self_device_time_total=50.0)]
            return [SimpleNamespace(device_type=torch.autograd.DeviceType.CUDA, key="kernel",
                                    count=count, self_device_time_total=2.0 * count)] + \
                (marker if self.marked else [])

    def fn():
        if calls:
            calls[-1].n += 1

    def sleep(cycles):
        if calls:
            calls[-1].marked = True

    monkeypatch.setattr(torch.profiler, "profile", Window)
    monkeypatch.setattr(torch.cuda, "_sleep", sleep)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    return fn, calls


def test_device_ms_full_window_gives_its_time(smoke, monkeypatch):
    fn, calls = _fake_profiler(monkeypatch, lambda n: 3 * n)      # 3 kernels a call
    assert smoke.device_ms(fn, reps=10) == pytest.approx(3 * 2.0 / 1e3)
    assert len(calls) == 2                                         # one call, then the window


def test_device_ms_short_window_gives_no_number(smoke, monkeypatch, capsys):
    # every window of 10 calls loses one record: the profiler's drop
    fn, calls = _fake_profiler(monkeypatch, lambda n: 3 * n - (n > 1))
    assert smoke.device_ms(fn, reps=10) is None
    assert len(calls) == 6                                          # 3 tries
    assert "no time is kept" in capsys.readouterr().out
    rec = smoke.timed_case({"case": "c", "ms": None, "plain_ms": 0.01})
    assert rec["profiler_short"] is True
    assert json.loads(json.dumps(rec))["ms"] is None
    assert smoke.num(None) == "null" and smoke.num(0.5, ".2f") == "0.50"
    assert smoke.timed_case({"ms": 0.2, "plain_ms": 0.01})["profiler_short"] is False


def test_device_ms_with_no_device_time_fails(smoke, monkeypatch):
    fn, _ = _fake_profiler(monkeypatch, lambda n: 0)
    with pytest.raises(smoke.SmokeFailure, match="no device time"):
        smoke.device_ms(fn, reps=4)


def test_kernel_union_counts_overlapping_spans_once(smoke):
    """Phase lp_ranks' busy share: ranks that share the card report
    kernel spans that overlap (a time-sliced kernel's span covers the
    other ranks' slices); their union counts each nanosecond once."""
    import numpy as np

    spans = [np.array([[0, 10], [20, 30]]), np.array([[5, 25], [40, 41]]),
             np.zeros((0, 2), np.int64)]
    union_s, sum_s = smoke.kernel_union_s(spans)
    assert union_s == pytest.approx(31e-9) and sum_s == pytest.approx(41e-9)
    assert smoke.kernel_union_s([]) == (0.0, 0.0)


def test_rank_kernel_shapes_are_what_a_rank_passes(smoke, tmp_path):
    """The kernels phase holds int8_quantize and the wgmma kernel to their
    plain versions at ``rank_kernel_shapes``: the ranks of a halo world
    (the reduced DiT on the int8 wire, on the CPU) hand the wrappers
    exactly those shapes, one slab a quantize and one window's CFG pair an
    attention."""
    _check_rank_kernel_shapes(smoke, tmp_path, smoke.K, 1)


def test_hybrid_rank_kernel_shapes_are_what_a_rank_passes(smoke, tmp_path):
    """The same for the ranks of a 3 x 2 hybrid world (phase
    ``hybrid_ranks``): ``rank_kernel_shapes`` at K 3."""
    _check_rank_kernel_shapes(smoke, tmp_path, *smoke.HYBRID_MESH)


def _check_rank_kernel_shapes(smoke, tmp_path, M, T):
    import torch_dist_cases as cases
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import run_lp_world

    latent = (9, 8, 12)
    got = run_lp_world(cases.kernel_shapes_of_a_rank, M,
                       (latent, smoke.STEPS, smoke.R, "int8"), tp=T,
                       workdir=str(tmp_path), device="cpu", deadline_s=300)
    quant, attn = smoke.rank_kernel_shapes(get_config("wan21-dit-1.3b").reduced(), latent,
                                           size=M)
    assert len({F for _, F in quant}) == 3            # a round in each dim
    for rank in got:
        assert rank["quant"] == [(1,) + s for s in quant]
        assert rank["attn"] == [(2,) + s for s in attn]


def test_same_report_ignores_only_the_cli_notes(smoke):
    live = {"classes": {"standard": {"count": 2, "e2e_p50_s": 0.1}}, "makespan_s": 1.5,
            "source": "live", "warmed": True, "workload": {"seed": 0},
            "router": {"replicas": 2}}
    offline = {"classes": {"standard": {"count": 2, "e2e_p50_s": 0.1}}, "makespan_s": 1.5,
               "source": "trace"}
    assert smoke.same_report(live, offline)
    assert not smoke.same_report(live, {**offline, "makespan_s": 1.5000001})
    assert not smoke.same_report(live, {**offline, "replicas": {}})
    assert smoke.fleet_mix((9, 8, 12)) == \
        "i,shape=9x8x12,priority=interactive;s,shape=9x8x12,priority=standard,weight=2"


def test_serve_fleet_phase_on_the_cpu(smoke, tmp_path, monkeypatch):
    """Phase serve_fleet's checks (the replay's misses, launches per batch,
    clock advances and offline report; the fleet's kill, redispatch,
    stamps, replica rows, bit-equality to a bare engine and per-replica
    launches; the overload's sheds, degradation and restore; the CLI's
    reports) on the reduced DiT at a latent with all three dims usable at
    K 4, the arrival rates raised so that the CPU's short walls still
    queue, batch and shed."""
    from repro_torch.configs import get_config
    from repro_torch.device import generator
    from repro_torch.launch import loadtest
    from repro_torch.models import dit

    monkeypatch.setattr(smoke, "ROOT", tmp_path)          # the CLI's trace and reports
    monkeypatch.setattr(loadtest, "get_config", lambda name: get_config(name).reduced())
    cfg = get_config("wan21-dit-1.3b").reduced()
    model = dit.init_params(cfg, generator(0, "cpu"), "cpu")
    rec, counts = smoke.serve_fleet(cfg, model, device="cpu", latent=(9, 8, 12),
                                    rates={"a": 50.0, "b": 200.0, "c": 2000.0, "cli": 200.0})
    a, b, c = rec["a"], rec["b"], rec["c"]
    assert a["step_cache_misses"] == 0 and a["advances_s"] == a["batch_walls_s"]
    assert a["offline_equals_live"] and a["trace_errors"] == []
    assert b["states"] == ["healthy", "dead"] and b["stats"]["replica_deaths"] == 1
    assert b["first_batch_bit_equal"] and b["stamps_ok"] and b["rows_carry_replica"]
    assert b["report"]["disposition"]["accounted"] == smoke.FLEET_REQUESTS["b"]
    assert [x["killed"] for x in b["batches"]].count(True) == 1
    assert c["shed_ids"] and c["degrades"] and c["restored"]
    assert c["report"]["disposition"]["accounted"] == smoke.FLEET_REQUESTS["c"]
    assert rec["cli"]["offline_equals_live"] and rec["cli"]["router"]["states"][1] == "dead"
    assert (tmp_path / "chiprun_out" / "fleet_report_offline.json").exists()
    assert sorted(counts) == ["serve_fleet:a", "serve_fleet:b", "serve_fleet:c",
                              "serve_fleet:cli"]
    assert not any(v for n in counts.values() for v in n.values())


@pytest.mark.parametrize("k,remat", [(1, "none"), (2, "none"), (2, "full")])
def test_expected_train_launches_count_a_train_step(smoke, monkeypatch, k, remat):
    """The flash forward and backward launches of 2 train steps of the
    reduced dense model, counted by stand-ins for the two wrappers on the
    CPU (forward through ``FlashAttention``, remat's recompute included),
    equal ``expected_train_launches`` (on the card the forward's kernel is
    ``flash_attention_sm90`` and the backward's ``flash_attention_bwd_sm90``
    at granite's widths)."""
    from repro_torch import models
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ParallelConfig
    from repro_torch.data.pipeline import SyntheticLMStream
    from repro_torch.kernels import ops
    from repro_torch.models import attention
    from repro_torch.train.loop import make_train_step

    counts = {"flash_attention": 0, "flash_attention_bwd": 0}
    fwd, bwd = ops.flash_attention, ops.flash_attention_bwd

    def counted(name, fn):
        def call(*a, **kw):
            counts[name] += 1
            return fn(*a, **kw)
        return call

    monkeypatch.setattr(ops, "flash_attention", counted("flash_attention", fwd))
    monkeypatch.setattr(ops, "flash_attention_bwd", counted("flash_attention_bwd", bwd))
    # the CPU's attention is attention_chunked: send it through the autograd function
    monkeypatch.setattr(attention, "attention_chunked",
                        lambda q, k_, v, qp, kp, causal, window, kv_len, kv_chunk:
                        ops.flash_attention_autograd(q, k_, v, qp, kp, causal=causal,
                                                     window=window, kv_len=kv_len))
    cfg = get_config("granite-3-2b").reduced()
    model = models.build(cfg, "cpu")
    step_fn = make_train_step(model, ParallelConfig(remat=remat, microbatch=k))
    params = model.init(0)
    opt = step_fn.opt_init(params)
    data = SyntheticLMStream(cfg, batch=2, seq_len=8, device="cpu")
    for s in range(2):
        params, opt, _ = step_fn(params, opt, data.batch_at(s), s)
    want = smoke.expected_train_launches(cfg.num_layers, k, remat != "none", 2)
    assert sorted(want) == ["flash_attention_bwd_sm90", "flash_attention_sm90"]
    assert counts == {"flash_attention": want["flash_attention_sm90"],
                      "flash_attention_bwd": want["flash_attention_bwd_sm90"]}


@pytest.mark.parametrize("k,remat", [(1, "none"), (2, "full")])
def test_expected_hybrid_train_launches_count_a_train_step(smoke, monkeypatch, k, remat):
    """The kernel launches of 2 train steps of the reduced hybrid model,
    counted by stand-ins for the four wrappers on the CPU (the scan through
    ``MambaSSD``, attention through ``FlashAttention``; remat's recompute
    included), equal ``expected_hybrid_train_launches`` (on the card the
    forward flash is ``flash_attention_sm90`` and the backward
    ``flash_attention_bwd_sm90`` at Zamba2's D 80)."""
    from repro_torch import models
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ParallelConfig
    from repro_torch.data.pipeline import SyntheticLMStream
    from repro_torch.kernels import ops
    from repro_torch.models import attention, ssm
    from repro_torch.train.loop import make_train_step

    names = ("flash_attention", "flash_attention_bwd", "mamba_ssd", "mamba_ssd_bwd")
    counts = dict.fromkeys(names, 0)

    def counted(name, fn):
        def call(*a, **kw):
            counts[name] += 1
            return fn(*a, **kw)
        return call

    for name in names:
        monkeypatch.setattr(ops, name, counted(name, getattr(ops, name)))
    # the CPU's attention and scan run their plain functions: send them
    # through the autograd functions the card takes
    monkeypatch.setattr(attention, "attention_chunked",
                        lambda q, k_, v, qp, kp, causal, window, kv_len, kv_chunk:
                        ops.flash_attention_autograd(q, k_, v, qp, kp, causal=causal,
                                                     window=window, kv_len=kv_len))
    monkeypatch.setattr(ssm, "gated_linear_scan",
                        lambda x, a, dt, B, C, chunk, factorized:
                        ops.mamba_ssd_autograd(x.float(), a.float(), dt.float(),
                                               B[:, :, 0].float(), C[:, :, 0].float(), chunk))
    cfg = get_config("zamba2-2.7b").reduced()
    model = models.build(cfg, "cpu")
    step_fn = make_train_step(model, ParallelConfig(remat=remat, microbatch=k))
    params = model.init(0)
    opt = step_fn.opt_init(params)
    data = SyntheticLMStream(cfg, batch=2, seq_len=8, device="cpu")
    for s in range(2):
        params, opt, _ = step_fn(params, opt, data.batch_at(s), s)
    want = smoke.expected_hybrid_train_launches(cfg.num_layers, cfg.attn_every, k,
                                                remat != "none", 2)
    assert sorted(want) == ["flash_attention_bwd_sm90", "flash_attention_sm90", "mamba_ssd",
                            "mamba_ssd_bwd"]
    assert ops.bwd_kernel(torch.bfloat16, get_config("zamba2-2.7b").head_dim) \
        == "flash_attention_bwd_sm90"
    assert counts == {"flash_attention": want["flash_attention_sm90"],
                      "flash_attention_bwd": want["flash_attention_bwd_sm90"],
                      "mamba_ssd": want["mamba_ssd"], "mamba_ssd_bwd": want["mamba_ssd_bwd"]}
    assert counts["mamba_ssd_bwd"] == cfg.num_layers * k * 2


@pytest.mark.parametrize("steps,every,fail_at", [(6, 2, (3,)), (6, 2, ()), (25, 5, (7, 13)),
                                                 (6, 3, (3,))])
def test_drill_steps_counts_what_run_training_runs(smoke, tmp_path, steps, every, fail_at):
    from repro_torch.runtime.ft import FailureInjector, run_training

    ran = []

    def step(params, opt, batch, s):
        ran.append(s)
        return params, opt, {"loss": torch.zeros(())}

    rep = run_training(step, lambda: (torch.zeros(2), {"m": torch.zeros(2)}), lambda s: None,
                       steps, str(tmp_path), ckpt_every=every,
                       injector=FailureInjector(fail_at=fail_at))
    assert rep.restarts == len(fail_at) and rep.final_step == steps
    assert len(ran) == smoke.drill_steps(steps, every, fail_at)


def test_flash_bwd_work_and_bound(smoke):
    pairs = 2 * 2048 * 2049 // 2
    flops, nbytes = smoke.flash_bwd_work(2, 2048, 2048, 32, 8, 64, pairs)
    assert flops == 2.5 * 4 * pairs * 32 * 64
    q, kv = 2 * 2048 * 32 * 64, 2 * 2048 * 8 * 64
    # bf16 q, out, dout, dq, k, v, dk, dv; int32 positions; the f32 log-sum-exp
    assert nbytes == (4 * q + 4 * kv) * 2 + 2 * 2 * 2048 * 4 + 2 * 32 * 2048 * 4
    ms, by = smoke.bound(flops, nbytes)
    assert by == "operations" and ms == pytest.approx(flops / 989e12 * 1e3)
    assert smoke.bound(1.0, 3.35e9) == (pytest.approx(1.0), "bytes")


def test_device_split_puts_both_backwards_under_flash(smoke):
    """The profiled train step's split: both backward files' kernels (the
    wgmma one's ``bwd_delta``, ``bwd_dkdv`` and ``bwd_dq`` at either head dim
    included) under ``flash_bwd``, the wgmma forward and its pre-pass under
    ``flash_fwd``; the SSD scan's forward (both entries and its pre-pass)
    under ``ssd_fwd``, its backward's four kernels (the local terms, the
    carry, the chunk-local pass, the head groups' sum) under ``ssd_bwd``."""
    names = {"void (anonymous namespace)::bwd_delta<80>(...)": 1.0,
             "void (anonymous namespace)::bwd_dkdv<80>(CUtensorMap_st, ...)": 2.0,
             "void (anonymous namespace)::bwd_dq<64>(CUtensorMap_st, ...)": 4.0,
             "void (anonymous namespace)::bwd_prep<80>(...)": 8.0,
             "void (anonymous namespace)::flash_fwd_sm90<64>(...)": 16.0,
             "(anonymous namespace)::live_tiles_pass(...)": 32.0,
             "nvjet_hsh_128x256_64x4": 64.0, "void at::native::elementwise_kernel": 128.0,
             "void (anonymous namespace)::mamba_ssd_kernel<64, true>(...)": 256.0,
             "void (anonymous namespace)::mamba_ssd_prep<64>(...)": 512.0,
             "(anonymous namespace)::mamba_ssd_bwd_local(...)": 1024.0,
             "(anonymous namespace)::mamba_ssd_bwd_carry(...)": 2048.0,
             "void (anonymous namespace)::mamba_ssd_bwd_chunk<64>(...)": 4096.0,
             "(anonymous namespace)::mamba_ssd_bwd_heads(...)": 8192.0}
    assert smoke._split_kernels(names.items()) == {
        "flash_fwd": 48.0, "flash_bwd": 15.0, "ssd_fwd": 768.0, "ssd_bwd": 15360.0,
        "matmul": 64.0, "other": 128.0}


def test_train_flops(smoke):
    assert smoke.train_flops(10, 3, 0, 4, 2, 8) == 180.0
    assert smoke.train_flops(0, 0, 5, 4, 2, 8) == 12 * 5 * 2 * 8 * 4


def test_ssd_bwd_work_and_bound(smoke):
    """The SSD backward's work at Zamba2's training microbatch (2 x 2048, 80
    heads x 64, state 64, chunk 64): 8.10 G multiply-adds (eight products
    per (batch, head, chunk), the causal ones on their triangle, and the
    Gram per (batch, chunk): the kernel's split, whose elementwise sums
    stand for the two further products per reduction the plain formulas
    run) and 345 MB (x, dy, dx and the states in f32, the rest small).  In
    3xTF32 the products take 0.098 ms, the bytes 0.103 ms: the bytes bound
    it."""
    macs, nbytes = smoke.ssd_bwd_work(2, 2048, 80, 64, 64, 64)
    assert macs == 2 * 80 * 32 * (2 * 2080 * 64 + 2 * 2080 * 64 + 4 * 64 ** 3) \
        + 2 * 32 * 2080 * 64 == 8_103_526_400
    assert nbytes == 4 * (3 * 2 * 2048 * 80 * 64 + 2 * 32 * 80 * 64 * 64 + 4 * 2 * 2048 * 80
                          + 4 * 2 * 2048 * 64) == 344_981_504
    ms, by = smoke.bound(2.0 * macs * smoke.SSD_PASSES, nbytes, smoke.H100_TF32_FLOPS)
    assert by == "bytes" and ms == pytest.approx(0.10298, rel=1e-3)
    ops_ms = 2.0 * macs * smoke.SSD_PASSES / smoke.H100_TF32_FLOPS * 1e3
    assert ops_ms == pytest.approx(0.09822, rel=1e-3)


@pytest.mark.parametrize("table", ["FLASH_MUTANTS", "BWD_MUTANTS", "QB_MUTANTS", "SSD_MUTANTS",
                                   "SSD_BWD_MUTANTS", "WIDE_MUTANTS", "F32_MUTANTS",
                                   "WIDE_BWD_MUTANTS"])
def test_every_mutant_finds_its_source_text_once(smoke, table):
    """Each broken copy ``chip_smoke.py`` builds replaces a text that occurs
    exactly once in the source it names (``build_mutants`` refuses any
    other count on the card), and the replacement differs from it."""
    csrc = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
    mutants = getattr(smoke, table)
    assert mutants
    for name, spec in mutants.items():
        fname, old, new = spec if len(spec) == 3 else ("mamba_ssd_bwd.cu", *spec)
        assert (csrc / fname).read_text().count(old) == 1, (name, fname)
        assert old != new, name



def test_flash_mutant_builds_copy_every_header_their_sources_include(smoke):
    """A broken copy of a flash source is built in a directory that holds
    only the files ``chip_smoke.py`` copies there: every header that a
    flash source includes, and the headers those include, are in
    ``FLASH_HEADERS``."""
    import re

    csrc = ROOT / "src" / "repro_torch" / "kernels" / "csrc"

    def headers(name, seen):
        for inc in re.findall(r'#include "([^"]+)"', (csrc / name).read_text()):
            if inc not in seen:
                seen.add(inc)
                headers(inc, seen)
        return seen

    for src in sorted(csrc.glob("flash_*.cu")):
        assert headers(src.name, set()) <= set(smoke.FLASH_HEADERS), src.name


def test_family_runs_cover_the_configs_at_their_widths(smoke):
    """Phase lm_families' configs: each at its published widths, the depth
    cut only for llama3 and llama4; every decode stays inside its cache;
    danube's prompt passes its window; consistency is checked on the two
    dense configs whose decode follows a prompt."""
    from repro_torch.configs import get_config

    dims = {}
    for arch, spec in smoke.FAMILY_RUNS:
        cfg = smoke._family_cfg(arch, spec["layers"])
        full = get_config(arch)
        assert (cfg.d_model, cfg.num_heads, cfg.num_kv_heads) == \
            (full.d_model, full.num_heads, full.num_kv_heads)
        assert cfg.num_layers == (1 if arch in ("llama3-405b", "llama4-maverick-400b-a17b")
                                  else full.num_layers)
        n_req, prompt, gen, max_len, start = spec["decode"]
        assert start + prompt + gen - 1 <= max_len
        assert bool(spec.get("consistency")) == (start > 0)
        dims[arch] = cfg.head_dim
    assert dims == {"granite-moe-3b-a800m": 64, "internvl2-26b": 128, "h2o-danube-1.8b": 80,
                    "minitron-4b": 128, "llama3-405b": 128, "llama4-maverick-400b-a17b": 128}
    danube = dict(smoke.FAMILY_RUNS)["h2o-danube-1.8b"]
    assert danube["prefill"][1] > get_config("h2o-danube-1.8b").window


@pytest.mark.parametrize("arch,spec", [
    ("granite-moe-3b-a800m", dict(layers=None, prefill=(2, 24), decode=(2, 3, 3, 16, 0))),
    ("internvl2-26b", dict(layers=None, prefill=(1, 20), decode=(2, 1, 3, 16, 0))),
    ("h2o-danube-1.8b", dict(layers=None, prefill=(1, 24), decode=(2, 1, 4, 32, 24),
                             consistency=True)),
])
def test_lm_families_phase_on_the_cpu(smoke, arch, spec):
    """Phase lm_families' run of one config on the CPU at its reduced
    config (f32, the plain versions, so no launch is expected): the
    prefill, the cache filled from the prompts (danube: 24 tokens past its
    window of 16), the decode, the consistency check and the MoE routing
    against the CPU (here the same device: no set differs)."""
    from repro_torch.configs import get_config

    cfg = get_config(arch).reduced()
    rec, pre, dec = smoke.lm_family(arch, spec, "cpu", device="cpu", cfg=cfg)
    assert rec["layers"] == cfg.num_layers and len(rec["decode_step_s"]) == sum(
        spec["decode"][1:3]) - 1
    assert not any(pre.values()) and not any(dec.values())
    if cfg.is_moe:
        assert rec["routing_vs_cpu"]["top_k_sets_differ"] == 0
    if spec.get("consistency"):
        assert max(rec["prefill_vs_decode_max_abs"].values()) < 3e-2


def test_wide_scan_work_and_bound(smoke):
    """The grouped scan at xlstm-1.3b's prefill (2 x 4096, h = g = 4, p = n
    = 1024, chunk 128): 73.0 G multiply-adds, 146 GFLOP issued three times
    over in 3xTF32, 0.886 ms at 495 TFLOP/s against 0.160 ms for its 537 MB:
    operations bound it.  The normaliser (p = 1) is bound by its 268 MB of
    B and C: 0.080 ms."""
    macs, nbytes = smoke.wide_work(2, 4096, 4, 4, 1024, 1024, 128)
    assert macs == 256 * (8256 * 1024 + 2 * 128 * 1024 * 1024) + 256 * 8256 * 1024
    assert macs == pytest.approx(73.0e9, rel=2e-3) and nbytes == pytest.approx(537e6, rel=1e-3)
    ms, by = smoke.bound(2.0 * macs * smoke.SSD_PASSES, nbytes, smoke.H100_TF32_FLOPS)
    assert by == "operations" and ms == pytest.approx(0.886, rel=1e-3)
    macs1, nbytes1 = smoke.wide_work(2, 4096, 4, 4, 1, 1024, 128)
    ms1, by1 = smoke.bound(2.0 * macs1 * smoke.SSD_PASSES, nbytes1, smoke.H100_TF32_FLOPS)
    assert by1 == "bytes" and ms1 == pytest.approx(0.080, rel=2e-2)


def test_wide_mutants_each_name_a_case_the_kernels_phase_runs(smoke):
    assert set(smoke.WIDE_MUTANT_CATCHER) == set(smoke.WIDE_MUTANTS)
    src = (ROOT / "chip_smoke.py").read_text()
    for case in smoke.WIDE_MUTANT_CATCHER.values():
        assert src.count(f'("{case}",') == 1, case


def test_lm_xlstm_phase_on_the_cpu(smoke):
    """Phase lm_xlstm's run through ``lm_family`` on the CPU at the reduced
    config (f32, the plain scan, so no launch is expected): the cold and
    warm prefill, the decode of 2 requests x (3 + 3) tokens from an empty
    cache, the consistency check (f32 on both sides here: the reference's
    own small gap); then the one group's gap through ``stepped_gap``."""
    import torch
    from repro_torch import models
    from repro_torch.configs import get_config

    # a vocabulary short of its padding, as xlstm-1.3b's 50,304 of 50,432
    cfg = dataclasses.replace(get_config(smoke.XLSTM_ARCH).reduced(), vocab_size=500)
    assert cfg.padded_vocab_size > cfg.vocab_size
    spec = dict(smoke.XLSTM_RUN, prefill=(1, 24), decode=(2, 3, 3, 6, 0))
    rec, pre, dec = smoke.lm_family(smoke.XLSTM_ARCH, spec, "cpu", device="cpu", cfg=cfg)
    assert rec["layers"] == cfg.num_layers and len(rec["decode_step_s"]) == 5
    assert not any(pre.values()) and not any(dec.values())
    assert max(rec["prefill_vs_decode_max_abs"].values()) < 1e-4
    assert max(rec["bf16_vs_f32_max_abs"]["forward"], rec["bf16_vs_f32_max_abs"]["decode"]) < 1e-4
    assert 0 < rec["bf16_vs_f32_max_abs"]["f32_logit_max"] < 1e3     # the padded columns left out
    lm = models.build(cfg, "cpu")
    tokens = torch.randint(0, cfg.vocab_size, (1, 8), generator=torch.Generator().manual_seed(3))
    assert smoke.stepped_gap(lm, lm.init(2), cfg, tokens) < 1e-4


@pytest.mark.parametrize("arch,tokens,want", [
    ("xlstm-1.3b", 4096, ({"mamba_ssd_wide": 84}, {})),
    ("granite-moe-3b-a800m", 4096, ({"flash_attention_sm90": 32}, {"flash_decode": 32})),
])
def test_lm_launches_follow_the_family(smoke, arch, tokens, want):
    """The launches ``lm_family`` holds a prefill and a decode step to: the
    xLSTM's two scans an mLSTM block (6 groups x 7) and none a step; an
    attention family's flash kernels once a layer."""
    from repro_torch.configs import get_config

    assert smoke.lm_launches(get_config(arch), tokens) == want


def test_new_mutants_each_name_a_case_the_kernels_phase_runs(smoke):
    assert set(smoke.F32_MUTANT_CATCHER) == set(smoke.F32_MUTANTS) == set(smoke.F32_MUTANT_LIBS)
    assert set(smoke.WIDE_BWD_MUTANT_CATCHER) == set(smoke.WIDE_BWD_MUTANTS)
    src = (ROOT / "chip_smoke.py").read_text()
    for case in (*smoke.F32_MUTANT_CATCHER.values(), *smoke.WIDE_BWD_MUTANT_CATCHER.values()):
        assert src.count(f'("{case}",') == 1, case


def test_wide_bwd_mutants_each_name_a_case_the_kernels_phase_runs(smoke):
    """Each broken copy of the grouped scan's backward replaces a text that
    occurs once in its source (the kernel or the header it shares), is
    caught by a case the kernels phase runs, and is built beside every
    header those sources include (``WIDE_HEADERS``)."""
    import re

    csrc = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
    assert set(smoke.WIDE_BWD_MUTANT_CATCHER) == set(smoke.WIDE_BWD_MUTANTS)
    src = (ROOT / "chip_smoke.py").read_text()
    for name, (fname, old, new) in smoke.WIDE_BWD_MUTANTS.items():
        assert fname in ("mamba_ssd_wide_bwd.cu", *smoke.WIDE_HEADERS), name
        assert (csrc / fname).read_text().count(old) == 1 and old != new, name
        assert src.count(f'("{smoke.WIDE_BWD_MUTANT_CATCHER[name]}",') == 1, name
    for f in ("mamba_ssd_wide.cu", "mamba_ssd_wide_bwd.cu", *smoke.WIDE_HEADERS):
        for inc in re.findall(r'#include "([^"]+)"', (csrc / f).read_text()):
            assert inc in smoke.WIDE_HEADERS, (f, inc)


def test_wide_bwd_work_and_bound(smoke):
    """The grouped scan's backward at xlstm-1.3b's training microbatch (the
    value scan: 2 x 2048, h = g = 4, p = n = 1024, chunk 128): 74.1 G
    multiply-adds (four Q x n x p products and four causal Q^2 ones per
    (batch, head, chunk), the Gram per (batch, group, chunk)), 0.90 ms in
    3xTF32 at 495 TFLOP/s against 0.30 ms for its 1.01 GB: operations bound
    it.  The normaliser (p = 1) is bound by its bytes."""
    macs, nbytes = smoke.wide_bwd_work(2, 2048, 4, 4, 1024, 1024, 128)
    assert macs == 128 * (4 * 128 * 1024 * 1024 + 4 * 8256 * 1024) + 128 * 8256 * 1024
    assert macs == pytest.approx(74.1e9, rel=2e-3) and nbytes == pytest.approx(1.007e9, rel=1e-3)
    ms, by = smoke.bound(2.0 * macs * smoke.SSD_PASSES, nbytes, smoke.H100_TF32_FLOPS)
    assert by == "operations" and ms == pytest.approx(0.898, rel=2e-3)
    ms1, by1 = smoke.bound(2.0 * smoke.SSD_PASSES * smoke.wide_bwd_work(
        2, 2048, 4, 4, 1, 1024, 128)[0], smoke.wide_bwd_work(2, 2048, 4, 4, 1, 1024, 128)[1],
        smoke.H100_TF32_FLOPS)
    assert by1 == "bytes"


def test_split_kernels_names_the_new_kernels(smoke):
    """The device split of a train step: the grouped scan's forward
    (``wide_*``) under ``ssd_fwd``, its backward's kernels (the sweep or the
    narrow launch, the clusters' sum, dbc in either tile width) under
    ``ssd_bwd``, the f32 flash backward's three under ``flash_bwd`` and the
    f32 forward under ``flash_fwd``."""
    names = {"(anonymous namespace)::wide_prep(Params)": 1.0,
             "(anonymous namespace)::wide_scan(Params)": 2.0,
             "void (anonymous namespace)::wide_narrow<1>(Params)": 4.0,
             **{f"(anonymous namespace)::mamba_ssd_wide_bwd_{part}(Params)": 8.0
                for part in smoke.WIDE_BWD_PARTS if part not in ("narrow", "dbc", "sum")},
             "void (anonymous namespace)::mamba_ssd_wide_bwd_narrow<1>(Params)": 8.0,
             "void (anonymous namespace)::mamba_ssd_wide_bwd_dbc<128>(Params)": 8.0,
             "(anonymous namespace)::mamba_ssd_wide_bwd_sum(const float *, float *, long long, "
             "int)": 8.0,
             "void (anonymous namespace)::bwd_f32_prep<32>(Params)": 100.0,
             "void (anonymous namespace)::bwd_f32_dkdv<32>(Params)": 200.0,
             "void (anonymous namespace)::bwd_f32_dq<32>(Params)": 400.0,
             "void (anonymous namespace)::flash_fwd_f32<32, true>(Params)": 1000.0,
             "void at::native::vectorized_elementwise_kernel": 5000.0}
    assert smoke._split_kernels(names.items()) == {
        "flash_fwd": 1000.0, "flash_bwd": 700.0, "ssd_fwd": 7.0, "ssd_bwd": 56.0,
        "matmul": 0.0, "other": 5000.0}


@pytest.mark.parametrize("k,remat", [(1, "none"), (2, "full")])
def test_expected_xlstm_train_launches_count_a_train_step(smoke, monkeypatch, k, remat):
    """The grouped scan's launches in 2 train steps of the reduced xLSTM,
    counted on the CPU by stand-ins for the two wrappers (the scans sent
    through ``MambaSSDWide``, as on the card), equal
    ``expected_xlstm_train_launches``: two scans an mLSTM block, each once
    more under remat, and two backward launches."""
    from repro_torch import models
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ParallelConfig
    from repro_torch.data.pipeline import SyntheticLMStream
    from repro_torch.kernels import ops
    from repro_torch.models import xlstm
    from repro_torch.train.loop import make_train_step

    counts = {"mamba_ssd_wide": 0, "mamba_ssd_wide_bwd": 0}

    def counted(name, fn):
        def call(*a, **kw):
            counts[name] += 1
            return fn(*a, **kw)
        return call

    for name in counts:
        monkeypatch.setattr(ops, name, counted(name, getattr(ops, name)))
    monkeypatch.setattr(xlstm, "gated_linear_scan", lambda x, a, dt, B, C, chunk:
                        ops.mamba_ssd_wide_autograd(x.float(), a, dt, B.float(), C.float(),
                                                    chunk=chunk))
    cfg = get_config(smoke.XLSTM_ARCH).reduced()
    model = models.build(cfg, "cpu")
    step_fn = make_train_step(model, ParallelConfig(remat=remat, microbatch=k))
    params = model.init(0)
    opt = step_fn.opt_init(params)
    data = SyntheticLMStream(cfg, batch=2, seq_len=8, device="cpu")
    for s in range(2):
        params, opt, _ = step_fn(params, opt, data.batch_at(s), s)
    assert counts == smoke.expected_xlstm_train_launches(cfg, k, remat != "none", 2)
    assert smoke.expected_xlstm_train_launches(get_config(smoke.XLSTM_ARCH), 1, True, 1) == {
        "mamba_ssd_wide": 168, "mamba_ssd_wide_bwd": 84}


def test_expected_cli_launches_follow_the_family(smoke):
    """The train CLI's reduced configs (4 steps, no remat, one microbatch):
    one f32 flash forward and backward an attention layer, the hybrid's
    Mamba2 blocks one scan and one backward each, the xLSTM's mLSTM blocks
    two of each."""
    from repro_torch.configs import get_config

    got = {a: smoke.expected_cli_launches(get_config(a).reduced(), 4)
           for a in smoke.TRAIN_CLI_ARCHS}
    dense = {"flash_attention": 8, "flash_attention_bwd_f32": 8}
    assert got == {"granite-3-2b": dense, "h2o-danube-1.8b": dense,
                   "granite-moe-3b-a800m": dense, "internvl2-26b": dense,
                   "zamba2-2.7b": {**dense, "mamba_ssd": 16, "mamba_ssd_bwd": 16},
                   "xlstm-1.3b": {"mamba_ssd_wide": 16, "mamba_ssd_wide_bwd": 16}}
    assert {get_config(a).reduced().head_dim for a in smoke.TRAIN_CLI_ARCHS} == {32, 64}
    assert get_config("h2o-danube-1.8b").reduced().window == 16


def test_cpu_drawn_init_keeps_the_cpu_weights(smoke):
    """Inside ``cpu_drawn_init`` a model's ``init`` draws on the CPU (the
    weights the CPU run of the CLI starts from), and ``models.build`` is
    restored after it."""
    import torch
    from repro_torch import models, tree
    from repro_torch.configs import get_config

    cfg = get_config("granite-3-2b").reduced()
    build = models.build
    want = tree.flatten(build(cfg, "cpu").init(0))[0]
    with smoke.cpu_drawn_init():
        got = tree.flatten(models.build(cfg, "cpu").init(0))[0]
    assert models.build is build
    assert len(got) == len(want) and all(torch.equal(a, b) for a, b in zip(got, want))
