"""The port stands alone, and runs where it is told to.

* No file of ``src/repro_torch/`` nor ``chip_smoke.py`` imports JAX or
  the JAX package ``repro`` (an AST scan; the fleet layer's three modules
  named), and the package imports and serves with ``jax`` blocked in
  ``sys.modules`` (a subprocess), a scheduled, recorded request
  (``policy/``, ``obs/``) and a routed load test with a replica kill
  (``serving/loadgen``, ``serving/router``, ``launch/loadtest``) included.
* Without CUDA, the entry points raise unless given ``device="cpu"``,
  the LM's (``models.build``, ``transformer.init_params``, the serve
  steps) and the load-test CLI (``--device cpu``; ``--report-from`` needs
  no device) included.
* CPU tensors never reach a kernel, coded requests and the hybrid LM's
  prefill and decode included: the launch counters stay at 0.
* ``ops.guidance_update``, an entry point of its own: CPU tensors take
  the plain version and launch nothing; a CUDA tensor goes to the kernel
  or raises, never to the plain version.
"""
import ast
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from repro_torch import device as tdevice
from repro_torch import models
from repro_torch.configs import get_config
from repro_torch.diffusion import generate_lp, make_guided_denoiser
from repro_torch.kernels import ops
from repro_torch.launch import serve
from repro_torch.models import dit, frontends, transformer
from repro_torch.serving import serve_step
from repro_torch.serving.engine import LPServingEngine, VideoRequest

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _port_files():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 20
    return files


def test_no_jax_or_reference_imports():
    bad = []
    for path in _port_files():
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                roots = [a.name.split(".")[0] for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                roots = [(node.module or "").split(".")[0]]
            else:
                continue
            bad += [f"{path.relative_to(ROOT)}:{node.lineno} {r}" for r in roots
                    if r in FORBIDDEN]
    assert not bad, bad


BLOCKED = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None          # any `import jax` now raises ImportError
sys.modules["repro"] = None
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
from repro_torch.launch import serve
full_width = serve.get_config
serve.get_config = lambda name: full_width(name).reduced()    # small enough for the CPU
serve.main(["--device", "cpu", "--requests", "1", "--steps", "2", "--frames-latent", "4"])
serve.main(["--device", "cpu", "--requests", "1", "--steps", "2", "--frames-latent", "4",
            "--partitions", "3", "--wire-codec", "displaced:int4-residual"])
import tempfile
with tempfile.TemporaryDirectory() as tmp:
    serve.main(["--device", "cpu", "--requests", "1", "--steps", "2", "--frames-latent", "4",
                "--partitions", "3", "--codec-schedule", "auto", "--trace-out",
                tmp + "/t.json", "--metrics-out", tmp + "/m.prom"])
from repro_torch.launch import loadtest
loadtest.get_config = serve.get_config
with tempfile.TemporaryDirectory() as tmp:
    loadtest.main(["--device", "cpu", "--requests", "3", "--rate", "50", "--steps", "2",
                   "--max-batch", "2", "--mix", "s,shape=4x8x12", "--replicas", "2",
                   "--inject-fault", "replica:1:dead@1", "--trace-out", tmp + "/l.json"])
    loadtest.main(["--report-from", tmp + "/l.json"])
from repro_torch import models
from repro_torch.configs import get_config
from repro_torch.serving.serve_step import make_decode_step, make_prefill_step
import torch
cfg = get_config("zamba2-2.7b").reduced()
lm = models.build(cfg, device="cpu")
params = lm.init(0)
tok = torch.zeros((1, 5), dtype=torch.long)
print("lm logits", tuple(make_prefill_step(lm, cfg)(params, {"tokens": tok}).shape))
make_decode_step(lm, cfg)(params, {"token": tok[:, :1], "position": torch.zeros(1, dtype=torch.long)},
                          lm.init_cache(1, 5))
assert not any(m == "jax" or m.startswith(("jax.", "repro.")) for m in sys.modules
               if sys.modules[m] is not None)
print("imported", len(names))
"""


def test_package_runs_with_jax_blocked():
    out = subprocess.run([sys.executable, "-c", BLOCKED], capture_output=True, text=True,
                         cwd=ROOT, env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"},
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "request 0: latent (1, 4, 8, 12, 4)" in out.stdout
    assert "codec=displaced:int4-residual" in out.stdout
    assert "lm logits (1, 1, 512)" in out.stdout
    assert "step policy: halo schedule=" in out.stdout and "trace: " in out.stdout
    assert "router: 2 replicas" in out.stdout and "disposition: completed=3" in out.stdout
    assert int(out.stdout.split("imported")[-1]) >= 34      # policy/ and obs/ included


def test_entry_points_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("wan21-dit-1.3b").reduced()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tdevice.resolve_device(None)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        dit.init_params(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        frontends.text_context(None, 1, cfg)
    model = dit.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LPServingEngine(model, cfg, num_partitions=2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--requests", "1"])
    assert LPServingEngine(model, cfg, num_partitions=2, device="cpu").device.type == "cpu"
    assert frontends.text_context(None, 1, cfg, device="cpu").shape == (1, 16, 128)


FLEET = ("serving/loadgen.py", "serving/router.py", "launch/loadtest.py")


def test_fleet_layer_stands_alone_and_needs_cuda(monkeypatch, tmp_path):
    from repro_torch.launch import loadtest

    files = {str(p.relative_to(ROOT / "src" / "repro_torch")) for p in _port_files()[:-1]}
    assert set(FLEET) <= files
    for rel in FLEET:
        tree = ast.parse((ROOT / "src" / "repro_torch" / rel).read_text())
        mods = {a.name.split(".")[0] for n in ast.walk(tree) if isinstance(n, ast.Import)
                for a in n.names}
        mods |= {(n.module or "").split(".")[0] for n in ast.walk(tree)
                 if isinstance(n, ast.ImportFrom) and n.level == 0}
        assert not mods & FORBIDDEN, (rel, mods & FORBIDDEN)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        loadtest.main(["--requests", "1"])
    trace = tmp_path / "t.json"
    trace.write_text('{"traceEvents": []}')
    assert loadtest.main(["--report-from", str(trace)])["requests"] == 0


def test_cpu_path_never_launches_a_kernel():
    ops.reset_launch_counts()
    cfg = get_config("wan21-dit-1.3b").reduced()
    model = dit.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    ctx = frontends.text_context(torch.Generator().manual_seed(1), 1, cfg, device="cpu")
    den = make_guided_denoiser(model, ctx, torch.zeros_like(ctx))
    z = torch.randn((1, 4, 8, 12, cfg.latent_channels), generator=torch.Generator().manual_seed(2))
    out = generate_lp(den, z, 2, 2, 0.5, cfg.patch_sizes, uniform=True)
    assert bool(torch.isfinite(out).all())
    eng = LPServingEngine(model, cfg, num_partitions=3, num_steps=2, wire_codec="int8",
                          device="cpu")
    eng.submit(VideoRequest(0, ctx, (4, 8, 12)))
    assert bool(torch.isfinite(eng.run()[0].latent).all())
    assert ops.launch_counts() == {"flash_attention": 0, "flash_attention_sm90": 0,
                                   "flash_decode": 0, "latent_blend": 0, "int8_quantize": 0,
                                   "dequant_blend": 0, "mamba_ssd": 0,
                                   "guidance_update": 0}


def test_lm_entry_points_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("zamba2-2.7b").reduced()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        models.build(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        models.build(get_config("wan21-dit-1.3b").reduced())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        transformer.init_params(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        transformer.init_cache(cfg, 1, 4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve_step.make_prefill_step(models.build(cfg), cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve_step.make_decode_step(models.build(cfg), cfg)
    lm = models.build(cfg, device="cpu")
    assert lm.device.type == "cpu"
    assert lm.init_cache(1, 4)["k"].device.type == "cpu"


def test_cpu_lm_path_never_launches_a_kernel():
    ops.reset_launch_counts()
    cfg = get_config("zamba2-2.7b").reduced()
    lm = models.build(cfg, device="cpu")
    params = lm.init(torch.Generator().manual_seed(0))
    tok = torch.randint(0, cfg.vocab_size, (2, 70), generator=torch.Generator().manual_seed(1))
    logits = serve_step.make_prefill_step(lm, cfg)(params, {"tokens": tok})
    assert tuple(logits.shape) == (2, 1, cfg.padded_vocab_size)
    cache = lm.init_cache(2, 4)
    dec = serve_step.make_decode_step(lm, cfg)
    for t in range(2):
        logits, cache = dec(params, {"token": tok[:, t:t + 1],
                                     "position": torch.full((2,), t)}, cache)
    assert bool(torch.isfinite(logits).all())
    assert set(ops.launch_counts().values()) == {0}
    assert "mamba_ssd" in ops.launch_counts()


def test_guidance_update_cpu_runs_plain_and_cuda_never_falls_back(monkeypatch):
    ops.reset_launch_counts()
    g = torch.Generator().manual_seed(3)
    z, c, u = (torch.randn((1, 4, 6, 8, 16), generator=g) for _ in range(3))
    out = ops.guidance_update(z, c, u, 5.0, -0.02)
    assert torch.equal(out, ops.ref.guidance_update_plain(z, c, u, 5.0, -0.02))
    assert set(ops.launch_counts().values()) == {0}
    # a CUDA tensor where no card (or no toolchain) is: the kernel's build
    # raises, and the plain version is never taken instead
    cuda = SimpleNamespace(shape=z.shape, dtype=torch.float32, device=torch.device("cuda"),
                           is_contiguous=lambda: True, data_ptr=lambda: 0, numel=z.numel)

    def no_card(name):
        raise RuntimeError(f"{name}: no CUDA device")

    def plain(*args):
        raise AssertionError("a CUDA tensor reached the plain version")

    monkeypatch.setattr(ops.build, "library", no_card)
    monkeypatch.setattr(ops.ref, "guidance_update_plain", plain)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ops.guidance_update(cuda, cuda, cuda, 5.0, -0.02)
    assert ops.guidance_update.launches == 0
