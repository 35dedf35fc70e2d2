"""Phase ``serve_policy`` of ``chip_smoke.py`` in one process, at a reduced
size (the plain versions, the reduced DiT in f32): its checks hold there
too. A file of its own, so that ``pytest-xdist``'s ``--dist loadfile``
runs it beside the rest of ``test_torch_smoke.py``."""
import importlib
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def smoke():
    # importable by name: the phases' rank functions go to spawned
    # processes, which import chip_smoke (and no JAX)
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    return importlib.import_module("chip_smoke")


def test_serve_policy_phase_on_the_cpu(smoke):
    """Phase serve_policy's checks (the explicit schedule's misses, trace,
    per-step wire bytes, serve counters and reconciliation; the
    single-segment schedule bit-equal to the fixed ``int8`` wire; ``auto``
    at 40 dB; launches: none on the CPU) on the reduced DiT, at a latent
    with all three dims usable at K 4."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.device import generator
    from repro_torch.models import dit, frontends
    from repro_torch.serving.engine import LPServingEngine, VideoRequest

    cfg = get_config("wan21-dit-1.3b").reduced()
    model = dit.init_params(cfg, generator(0, "cpu"), "cpu")
    latent = (9, 8, 12)
    reqs = [VideoRequest(i, frontends.text_context(generator(100 + i, "cpu"), 1, cfg, "cpu"),
                         latent, seed=i) for i in range(2)]
    fixed = LPServingEngine(model, cfg, num_partitions=smoke.K, overlap_ratio=smoke.R,
                            num_steps=smoke.STEPS, max_batch=2, device="cpu", wire_codec="int8")
    for r in reqs:
        fixed.submit(dataclasses.replace(r))
    int8 = {r.request_id: r.latent for r in fixed.run()}
    rec, counts = smoke.serve_policy(cfg, model, reqs, int8, device="cpu", latent=latent)
    ex = rec["explicit"]
    assert ex["step_codecs"] == list(smoke.SCHEDULE_CODECS) and ex["step_cache_misses"] == 4
    assert ex["wire_steps_ok"] and ex["serve_counters_ok"] and ex["reconciliation_ok"]
    assert ex["trace_errors"] == [] and ex["wire_bytes"] < ex["fp32_halo_bytes"]
    assert rec["single_segment_bit_equal"] and rec["auto"]["spec"] != smoke.SCHEDULE
    assert rec["spans"]["flash_kernels"] == 0 and not any(counts.values())
    assert len(rec["recorder_cost_wall_s"]["bare"]) == 2
