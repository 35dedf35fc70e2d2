"""Atomic, restartable checkpoints in the reference's layout
(``repro/runtime/checkpoint.py``):

  <dir>/step_000123/
      meta.json            # step, leaf paths, shapes, dtypes, time, extra
      shard_00000.npz      # leaf_00000, leaf_00001, ... in tree order
  <dir>/LATEST             # atomic pointer (written last)

* atomic: written to ``step_X.tmp-<nonce>/`` then renamed; ``LATEST`` is
  updated only after the rename, so a crash mid-save never corrupts the
  restore path.
* retention: ``keep_last`` prunes old steps after a successful save.
* one host writes every leaf (the reference's addressable-shard logic
  reduces to this on one host).

Trees are flattened in JAX's order with JAX's paths (``repro_torch.tree``),
and f32 and integer leaves are written as the reference writes them, so
either package reads the other's checkpoint of such a tree.  A bf16 leaf
(numpy has no bf16) is written as its 2-byte pattern (int16) with
``bfloat16`` in ``meta["dtypes"]`` and restored bit for bit; a reference
checkpoint's bf16 leaf (stored as ``|V2``) is read the same way.  The
reference cannot restore bf16 leaves itself.  Both LM families' train
states round-trip bit for bit: the dense stack and the hybrid one (its
stacked Mamba2 leaves, the shared block, the LoRA stacks, f32 ``A_log`` /
``D`` / ``dt_bias`` beside bf16 weights) with their optimizer state.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import uuid
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch import tree as ptree
from repro_torch.obs.clock import wall_stamp_s


def _host_copy(leaf) -> Any:
    """A host copy of a tensor leaf (numbers and arrays as they are)."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True)
    return leaf


def _as_numpy(leaf) -> Tuple[np.ndarray, str]:
    """The array written for ``leaf`` and the dtype name recorded for it."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy(), "bfloat16"
        a = t.numpy()
    else:
        a = np.asarray(leaf)
    return a, str(a.dtype)


def save(ckpt_dir: str, step: int, tree: Any, extra_meta: Optional[Dict[str, Any]] = None,
         keep_last: int = 3) -> str:
    """Atomic save; returns the final step directory."""
    os.makedirs(ckpt_dir, exist_ok=True)
    final = os.path.join(ckpt_dir, f"step_{step:09d}")
    tmp = final + f".tmp-{uuid.uuid4().hex[:8]}"
    os.makedirs(tmp)
    leaves, paths = ptree.flatten(tree)
    arrays, dtypes = {}, []
    for i, leaf in enumerate(leaves):
        arrays[f"leaf_{i:05d}"], dt = _as_numpy(leaf)
        dtypes.append(dt)
    np.savez(os.path.join(tmp, "shard_00000.npz"), **arrays)
    meta = {
        "step": step,
        "paths": paths,
        "shapes": [list(a.shape) for a in arrays.values()],
        "dtypes": dtypes,
        "time": wall_stamp_s(),  # epoch stamp on purpose (not a duration)
        **(extra_meta or {}),
    }
    with open(os.path.join(tmp, "meta.json"), "w") as f:
        json.dump(meta, f)
    os.rename(tmp, final)
    # pointer last => restore never sees a partial save
    latest_tmp = os.path.join(ckpt_dir, f".LATEST.tmp-{uuid.uuid4().hex[:8]}")
    with open(latest_tmp, "w") as f:
        f.write(os.path.basename(final))
    os.rename(latest_tmp, os.path.join(ckpt_dir, "LATEST"))
    _retain(ckpt_dir, keep_last)
    return final


def _retain(ckpt_dir: str, keep_last: int) -> None:
    steps = sorted(d for d in os.listdir(ckpt_dir)
                   if d.startswith("step_") and ".tmp" not in d)
    for d in steps[:-keep_last] if keep_last > 0 else []:
        shutil.rmtree(os.path.join(ckpt_dir, d), ignore_errors=True)


def latest_step(ckpt_dir: str) -> Optional[int]:
    ptr = os.path.join(ckpt_dir, "LATEST")
    if not os.path.exists(ptr):
        return None
    with open(ptr) as f:
        name = f.read().strip()
    if not os.path.isdir(os.path.join(ckpt_dir, name)):
        return None
    return int(name.split("_")[1])


def _leaf_tensor(arr: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == "bfloat16":
        return torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(arr))


def restore(ckpt_dir: str, tree_like: Any, step: Optional[int] = None) -> Tuple[Any, Dict]:
    """Restore into the structure of ``tree_like``; validates layout.  Each
    leaf is a tensor of the saved dtype, on the device of ``tree_like``'s
    leaf where that is a tensor (else on the CPU)."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    d = os.path.join(ckpt_dir, f"step_{step:09d}")
    with open(os.path.join(d, "meta.json")) as f:
        meta = json.load(f)
    leaves, exp_paths = ptree.flatten(tree_like)
    if meta["paths"] != exp_paths:
        raise ValueError(
            "checkpoint tree structure mismatch "
            f"(ckpt has {len(meta['paths'])} leaves, expected {len(exp_paths)})")
    out = []
    with np.load(os.path.join(d, "shard_00000.npz")) as data:
        for i, leaf in enumerate(leaves):
            arr = data[f"leaf_{i:05d}"]
            want = tuple(leaf.shape) if hasattr(leaf, "shape") else None
            if want is not None and tuple(arr.shape) != want:
                raise ValueError(f"leaf {exp_paths[i]}: shape {arr.shape} != expected {want}")
            t = _leaf_tensor(arr, meta["dtypes"][i])
            out.append(t.to(leaf.device) if isinstance(leaf, torch.Tensor) else t)
    return ptree.unflatten(tree_like, out), meta


class AsyncCheckpointer:
    """Fire-and-forget saves on a worker thread; blocks on overlap."""

    def __init__(self, ckpt_dir: str, keep_last: int = 3):
        self.ckpt_dir = ckpt_dir
        self.keep_last = keep_last
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def save(self, step: int, tree: Any, extra_meta=None) -> None:
        self.wait()
        # the device -> host copy happens here (synchronously), so the train
        # loop may overwrite its tensors; the disk write is off-thread
        host_tree = ptree.map_tree(_host_copy, tree)

        def work():
            try:
                save(self.ckpt_dir, step, host_tree, extra_meta, self.keep_last)
            except BaseException as e:  # surfaced on next wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err
