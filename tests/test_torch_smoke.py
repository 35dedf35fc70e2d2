"""The chip smoke's own rules, on the CPU.

* ``chip_smoke.device_ms`` (the profiler faked) sums the kernel records
  of a profiled window of ``reps`` calls.  A window that holds other
  than ``reps`` times one call's records is taken again; one still
  short after 3 tries gives no number (None), and ``timed_case`` flags
  the case with ``profiler_short`` and writes its time as JSON null.
* Phases ``lp_ranks`` and ``hybrid_ranks`` at a reduced size on gloo
  worlds of CPU ranks (the plain versions, the reduced DiT in f32): their
  checks hold there too.
"""
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
    count is ``records_per_window(calls)``, 2 us of device time each."""
    calls = []

    class Window:
        def __init__(self, activities):
            self.n = 0

        def __enter__(self):
            calls.append(self)
            return self

        def __exit__(self, *exc):
            return False

        def key_averages(self):
            count = records_per_window(self.n)
            return [SimpleNamespace(device_type=torch.autograd.DeviceType.CUDA, key="kernel",
                                    count=count, self_device_time_total=2.0 * count)]

    def fn():
        if calls:
            calls[-1].n += 1

    monkeypatch.setattr(torch.profiler, "profile", Window)
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


def test_lp_ranks_phase_on_the_cpu(smoke, tmp_path, monkeypatch):
    """The phase's checks (each rank bit-equal to the one-process run, the
    bytes of the model, the launch counts: none on the CPU) on the
    reduced DiT, at a latent with all three dims usable at K 4."""
    from repro_torch.configs import get_config
    from repro_torch.device import generator
    from repro_torch.models import dit

    monkeypatch.setattr(smoke, "ROOT", tmp_path)          # the worlds' rendezvous files
    cfg = get_config("wan21-dit-1.3b").reduced()
    model = dit.init_params(cfg, generator(0, "cpu"), "cpu")
    rec, counts = smoke.lp_ranks(cfg, model, device="cpu", latent=(9, 8, 12))
    runs = rec["runs"]
    assert len(runs) == 2 * sum(len(r) for r in smoke.LP_WORLDS.values())
    assert all(r["bit_equal"] and r["bytes"] == r["model_bytes"] and r["bytes_ok"]
               and r["step_payloads_ok"] for r in runs)
    assert sorted(counts) == sorted(f"lp_ranks:{n}" for w in smoke.LP_WORLDS.values()
                                    for n, _ in w)
    assert not any(v for c in counts.values() for v in c.values())


def test_hybrid_ranks_phase_on_the_cpu(smoke, tmp_path, monkeypatch):
    """The phase's checks (a 3 x 2 world bit-equal to the one-process run,
    the sharded wire to the unsharded one, the bytes of the model per tier,
    the eviction drill's outcome and latents, launches: none on the CPU)
    on the reduced DiT, at a latent with all three dims usable at K 3."""
    from repro_torch.configs import get_config
    from repro_torch.device import generator
    from repro_torch.models import dit

    monkeypatch.setattr(smoke, "ROOT", tmp_path)
    cfg = get_config("wan21-dit-1.3b").reduced()
    model = dit.init_params(cfg, generator(0, "cpu"), "cpu")
    rec, counts = smoke.hybrid_ranks(cfg, model, device="cpu", latent=(9, 8, 12))
    assert len(rec["runs"]) == 2 * len(smoke.HYBRID_RUNS)
    assert all(r["bit_equal"] and r["bytes_ok"] and r["step_payloads_ok"] for r in rec["runs"])
    assert [r["sharded_equals_unsharded"] for r in rec["runs"] if r["run"] == "fp32-shard"] \
        == [True, True]
    drill = rec["drill"]
    assert drill["left"] == [2, 3] and drill["bit_equal"] and drill["second_request_ok"]
    assert drill["outcome"][0][:3] == (1, 2, (2, 2)) and drill["ran_ok"]
    assert sorted(counts) == sorted([f"hybrid_ranks:{n}" for n, _, _ in smoke.HYBRID_RUNS]
                                    + ["hybrid_ranks:drill"])
    assert not any(v for c in counts.values() for v in c.values())


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
