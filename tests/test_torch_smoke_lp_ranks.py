"""Phase ``lp_ranks`` of ``chip_smoke.py`` on gloo worlds of CPU ranks, at
a reduced size (the plain versions, the reduced DiT in f32): its checks
hold there too. A file of its own, so that ``pytest-xdist``'s ``--dist
loadfile`` runs it beside the rest of ``test_torch_smoke.py``."""
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
    runs, scheduled = rec["runs"], rec["scheduled"]
    assert len(runs) == 2 * sum(len(r) for r in smoke.LP_WORLDS.values())
    assert all(r["bit_equal"] and r["bytes"] == r["model_bytes"] and r["bytes_ok"]
               and r["step_payloads_ok"] for r in runs)
    # the scheduled, recorded request of the K-4 world
    assert scheduled["run"] == "lp_ranks" and scheduled["spec"] == smoke.SCHEDULE
    assert scheduled["bit_equal"] and scheduled["bytes_ok"] and scheduled["same_plan"]
    assert scheduled["recorder_equals_counter"]
    assert sorted(counts) == sorted([f"lp_ranks:{n}" for w in smoke.LP_WORLDS.values()
                                     for n, _ in w] + ["lp_ranks:scheduled"])
    assert not any(v for c in counts.values() for v in c.values())
