"""Phase ``hybrid_ranks`` of ``chip_smoke.py`` on a 3 x 2 gloo world of CPU
ranks, at a reduced size (the plain versions, the reduced DiT in f32):
its checks hold there too. A file of its own, so that ``pytest-xdist``'s
``--dist loadfile`` runs it beside the rest of ``test_torch_smoke.py``."""
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
    runs, scheduled = rec["runs"], rec["scheduled"]
    assert len(runs) == 2 * len(smoke.HYBRID_RUNS)
    assert all(r["bit_equal"] and r["bytes_ok"] and r["step_payloads_ok"] for r in runs)
    assert scheduled["bit_equal"] and scheduled["recorder_equals_counter"]
    assert scheduled["lp_impl"] == "halo_hybrid" and scheduled["wire_shard"] is True
    assert scheduled["sent"]["intra"] > 0
    assert [r["sharded_equals_unsharded"] for r in rec["runs"] if r["run"] == "fp32-shard"] \
        == [True, True]
    drill = rec["drill"]
    assert drill["left"] == [2, 3] and drill["bit_equal"] and drill["second_request_ok"]
    assert drill["outcome"][0][:3] == (1, 2, (2, 2)) and drill["ran_ok"]
    assert sorted(counts) == sorted([f"hybrid_ranks:{n}" for n, _, _ in smoke.HYBRID_RUNS]
                                    + ["hybrid_ranks:drill", "hybrid_ranks:scheduled"])
    assert not any(v for c in counts.values() for v in c.values())
