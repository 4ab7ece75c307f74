"""Fault-tolerant checkpointing: atomic, manifest-driven, resumable.

Layout (the JAX package's, so a checkpoint written by either package
restores in the other):
         <dir>/step_00000123/
            manifest.json   {step, leaf paths, shapes/dtypes, extra}
            arr_<i>.npy     one file per tree leaf (copied to the host)
         <dir>/LATEST       -> atomic pointer file ("step_00000123")

A leaf's path is its keys as the JAX package's tree paths print them,
joined by "/": `['layers']` for a dict key, `.mu` for a field of a named
tuple, `[0]` for a tuple or list position; dict keys in sorted order, and
None holds no leaf. bfloat16 leaves are written as float32 (numpy has no
bfloat16) and cast back on restore.

Writes go to a temp directory then os.replace() — a crash mid-write can
never corrupt the last good checkpoint. Per-leaf np.save keeps host memory
to one leaf.
"""
from __future__ import annotations

import json
import os
from pathlib import Path
import shutil
import tempfile
import threading

import numpy as np
import torch

from ..models.params import map_leaves


def _flatten_with_paths(tree, prefix=()):
    """[(path, leaf)] in `map_leaves` order, which is the JAX package's
    flattening order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [kv for k in sorted(tree)
                for kv in _flatten_with_paths(tree[k], prefix + (f"[{k!r}]",))]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [kv for f in tree._fields
                for kv in _flatten_with_paths(getattr(tree, f), prefix + (f".{f}",))]
    if isinstance(tree, (list, tuple)):
        return [kv for i, v in enumerate(tree)
                for kv in _flatten_with_paths(v, prefix + (f"[{i}]",))]
    return [("/".join(prefix), tree)]


def _to_numpy(leaf) -> np.ndarray:
    if torch.is_tensor(leaf):
        t = leaf.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.cpu().numpy()
    return np.asarray(leaf)


def save_checkpoint(ckpt_dir, step: int, state, *, extra: dict | None = None,
                    keep: int = 3):
    """Atomically persist `state` (any tree of tensors or arrays) at `step`."""
    ckpt_dir = Path(ckpt_dir)
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    name = f"step_{step:08d}"
    final = ckpt_dir / name

    tmp = Path(tempfile.mkdtemp(dir=ckpt_dir, prefix=".tmp_"))
    try:
        manifest = {"step": int(step), "leaves": [], "extra": extra or {}}
        for i, (p, leaf) in enumerate(_flatten_with_paths(state)):
            arr = _to_numpy(leaf)
            np.save(tmp / f"arr_{i}.npy", arr)
            manifest["leaves"].append(
                {"i": i, "path": p, "shape": list(arr.shape), "dtype": str(arr.dtype)}
            )
        (tmp / "manifest.json").write_text(json.dumps(manifest))
        if final.exists():
            shutil.rmtree(final)
        os.replace(tmp, final)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    # atomic LATEST pointer
    ptr_tmp = ckpt_dir / ".LATEST.tmp"
    ptr_tmp.write_text(name)
    os.replace(ptr_tmp, ckpt_dir / "LATEST")
    _gc(ckpt_dir, keep)
    return final


class AsyncCheckpointer:
    """Background-thread checkpoint writer: the train loop hands over a
    host snapshot and keeps stepping while the previous save is written.
    The copy to the host happens synchronously, so the snapshot cannot see
    later in-place updates."""

    def __init__(self, ckpt_dir, keep: int = 3):
        self.ckpt_dir = ckpt_dir
        self.keep = keep
        self._thread: threading.Thread | None = None

    def save(self, step: int, state, *, extra=None):
        self.wait()  # at most one in-flight save
        snapshot = map_leaves(_to_numpy, state, is_leaf=torch.is_tensor)
        self._thread = threading.Thread(
            target=save_checkpoint, args=(self.ckpt_dir, step, snapshot),
            kwargs={"extra": extra, "keep": self.keep}, daemon=True,
        )
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None


def _gc(ckpt_dir: Path, keep: int):
    steps = sorted(d for d in ckpt_dir.iterdir() if d.name.startswith("step_"))
    for d in steps[:-keep]:
        shutil.rmtree(d, ignore_errors=True)


def latest_step(ckpt_dir) -> int | None:
    ptr = Path(ckpt_dir) / "LATEST"
    if not ptr.exists():
        return None
    name = ptr.read_text().strip()
    if not (Path(ckpt_dir) / name / "manifest.json").exists():
        # pointer ahead of a crashed write: fall back to newest complete dir
        cands = sorted(
            d for d in Path(ckpt_dir).iterdir()
            if d.name.startswith("step_") and (d / "manifest.json").exists()
        )
        return int(cands[-1].name.split("_")[1]) if cands else None
    return int(name.split("_")[1])


def restore_checkpoint(ckpt_dir, state_like, *, step: int | None = None):
    """Restore into the structure of `state_like` (a tree of tensors): each
    leaf takes its like's dtype and device. Returns (state, step, extra)."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    d = Path(ckpt_dir) / f"step_{step:08d}"
    manifest = json.loads((d / "manifest.json").read_text())
    by_path = {l["path"]: l for l in manifest["leaves"]}
    loaded = [torch.from_numpy(np.load(d / f"arr_{by_path[p]['i']}.npy")).to(
        dtype=like.dtype, device=like.device) for p, like in _flatten_with_paths(state_like)]
    it = iter(loaded)
    state = map_leaves(lambda _: next(it), state_like, is_leaf=torch.is_tensor)
    return state, manifest["step"], manifest.get("extra", {})
