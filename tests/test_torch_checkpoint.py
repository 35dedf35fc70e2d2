"""The port's checkpoints, fault-tolerant training loop and train CLI, on
the CPU, against the JAX reference where the two meet.

* The reference's checkpoint tests (``tests/test_runtime.py``) mirrored:
  round trip, the LATEST pointer and retention, structure and shape
  mismatches refused, the async checkpointer.
* Cross-reads of f32 / int32 trees both ways: the reference restores a
  port checkpoint, the port a reference one, leaves bit-equal.
* bf16 leaves round-trip bit for bit in the port (the reference cannot
  restore them), and the port reads a reference checkpoint's bf16 leaves.
* ``run_training`` on the reference's toy regression: a clean run,
  recovery from failures, recovery equal to a clean run (losses within
  1e-6, as the reference's test), too many failures raised.
* The train CLI with ``--device cpu``.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.runtime import checkpoint as jckpt
from repro_torch import tree
from repro_torch.launch import train as train_cli
from repro_torch.runtime import checkpoint as ckpt
from repro_torch.runtime.ft import DeviceFailure, FailureInjector, run_training


def _tree(seed=0):
    rng = np.random.default_rng(seed)
    return {"a": torch.from_numpy(rng.normal(size=(4, 3)).astype(np.float32)),
            "nested": {"b": torch.arange(5, dtype=torch.int32)}}


def _equal(a, b):
    la, pa = tree.flatten(a)
    lb, pb = tree.flatten(b)
    assert pa == pb
    for x, y in zip(la, lb):
        x, y = torch.as_tensor(np.array(x)), torch.as_tensor(np.array(y))
        assert x.dtype == y.dtype and torch.equal(x, y)


def test_checkpoint_roundtrip(tmp_path):
    t = _tree()
    ckpt.save(str(tmp_path), 7, t)
    restored, meta = ckpt.restore(str(tmp_path), t)
    assert meta["step"] == 7 and meta["paths"] == ["a", "nested/b"]
    _equal(t, restored)


def test_checkpoint_latest_pointer_and_retention(tmp_path):
    t = _tree()
    for s in (1, 2, 3, 4, 5):
        ckpt.save(str(tmp_path), s, t, keep_last=2)
    assert ckpt.latest_step(str(tmp_path)) == 5
    steps = sorted(d for d in os.listdir(tmp_path) if d.startswith("step_"))
    assert steps == ["step_000000004", "step_000000005"]


def test_checkpoint_structure_mismatch_rejected(tmp_path):
    ckpt.save(str(tmp_path), 1, _tree())
    bad = {"a": torch.zeros((4, 3)), "nested": {"c": torch.zeros(5)}}
    with pytest.raises(ValueError, match="structure mismatch"):
        ckpt.restore(str(tmp_path), bad)


def test_checkpoint_shape_mismatch_rejected(tmp_path):
    ckpt.save(str(tmp_path), 1, _tree())
    bad = {"a": torch.zeros((4, 4)), "nested": {"b": torch.zeros(5, dtype=torch.int32)}}
    with pytest.raises(ValueError, match="shape"):
        ckpt.restore(str(tmp_path), bad)


def test_async_checkpointer(tmp_path):
    c = ckpt.AsyncCheckpointer(str(tmp_path))
    t = _tree()
    c.save(3, t)
    t["a"].zero_()                       # the host copy was taken at save()
    c.wait()
    assert ckpt.latest_step(str(tmp_path)) == 3
    restored, _ = ckpt.restore(str(tmp_path), t)
    _equal(_tree(), restored)


def _pair_tree(seed):
    """The same f32 / int32 tree (with a tuple, as run_training saves) in
    both packages' leaf types."""
    rng = np.random.default_rng(seed)
    np_tree = ({"w": rng.normal(size=(3, 5)).astype(np.float32),
                "layers": {"b": rng.normal(size=(2, 4)).astype(np.float32)}},
               {"m": rng.normal(size=(3,)).astype(np.float32), "step": np.int32(9)})
    return (jax.tree.map(jnp.asarray, np_tree),
            tree.map_tree(lambda a: torch.from_numpy(np.array(a)), np_tree))


def test_reference_restores_a_port_checkpoint(tmp_path):
    jt, tt = _pair_tree(1)
    ckpt.save(str(tmp_path), 4, tt)
    restored, meta = jckpt.restore(str(tmp_path), jt)
    assert meta["step"] == 4
    _equal(tt, jax.tree.map(np.asarray, restored))


def test_port_restores_a_reference_checkpoint(tmp_path):
    jt, tt = _pair_tree(2)
    jckpt.save(str(tmp_path), 6, jt)
    restored, meta = ckpt.restore(str(tmp_path), tt)
    assert meta["step"] == 6
    _equal(jax.tree.map(np.asarray, jt), restored)


def test_bf16_leaves_round_trip_bit_for_bit(tmp_path):
    rng = np.random.default_rng(3)
    t = {"w": torch.from_numpy(rng.normal(size=(6, 7)).astype(np.float32)).bfloat16(),
         "f": torch.ones(3), "i": torch.arange(4, dtype=torch.int32)}
    ckpt.save(str(tmp_path / "port"), 1, t)
    restored, meta = ckpt.restore(str(tmp_path / "port"), t)
    assert meta["dtypes"] == ["float32", "int32", "bfloat16"]
    assert restored["w"].dtype == torch.bfloat16
    assert torch.equal(restored["w"].view(torch.int16), t["w"].view(torch.int16))
    # a reference checkpoint of the same bf16 leaf (written as |V2) reads the same
    jckpt.save(str(tmp_path / "ref"), 1, {"w": jnp.asarray(t["w"].float().numpy(), jnp.bfloat16)})
    from_ref, _ = ckpt.restore(str(tmp_path / "ref"), {"w": t["w"]})
    assert torch.equal(from_ref["w"].view(torch.int16), t["w"].view(torch.int16))


# ---------------------------------------------------------- fault tolerance
def _toy_training(path, injector=None, num_steps=25):
    """y = <w, x> regression; deterministic batches by step (numpy)."""
    w_true = torch.tensor([1.0, -2.0, 3.0, 0.5])

    def init_state():
        return torch.zeros(4), {"m": torch.zeros(4), "step": torch.zeros((), dtype=torch.int32)}

    def batch_for_step(step):
        x = torch.from_numpy(np.random.default_rng(step).normal(size=(8, 4)).astype(np.float32))
        return x, x @ w_true

    def train_step(w, opt, batch, step):
        x, y = batch
        w = w.detach().requires_grad_()
        loss = ((x @ w - y) ** 2).mean()
        (g,) = torch.autograd.grad(loss, w)
        m = 0.9 * opt["m"] + g
        return (w - 0.05 * m).detach(), {"m": m, "step": opt["step"] + 1}, {"loss": loss.detach()}

    return run_training(train_step, init_state, batch_for_step, num_steps, str(path),
                        ckpt_every=5, injector=injector)


def test_ft_clean_run(tmp_path):
    rep = _toy_training(tmp_path / "clean")
    assert rep.final_step == 25 and rep.restarts == 0
    assert rep.losses[24] < rep.losses[0]


def test_ft_recovers_from_failures(tmp_path):
    rep = _toy_training(tmp_path / "faulty", injector=FailureInjector(fail_at=(7, 13)))
    assert rep.final_step == 25 and rep.restarts == 2


def test_ft_recovery_matches_clean_run(tmp_path):
    """Restart-replayed training lands on the same final state."""
    clean = _toy_training(tmp_path / "c")
    faulty = _toy_training(tmp_path / "f", injector=FailureInjector(fail_at=(12,)))
    assert abs(clean.losses[24] - faulty.losses[24]) < 1e-6
    assert clean.losses == faulty.losses


def test_ft_exceeds_max_restarts(tmp_path):
    with pytest.raises(DeviceFailure):
        _toy_training(tmp_path / "dead", injector=FailureInjector(fail_at=(3, 4, 6, 8, 9)))


def test_train_cli_on_the_cpu(tmp_path, capsys):
    rep = train_cli.main(["--arch", "granite-3-2b", "--steps", "4", "--batch", "2", "--seq",
                          "16", "--ckpt-every", "2", "--ckpt-dir", str(tmp_path),
                          "--device", "cpu"])
    assert rep.final_step == 4 and rep.restarts == 0 and sorted(rep.losses) == [0, 1, 2, 3]
    assert ckpt.latest_step(str(tmp_path)) == 4
    out = capsys.readouterr().out
    assert out.startswith("finished 4 steps; loss ") and str(tmp_path) in out
