"""Checkpointing, ported from ``repro/ckpt/checkpoint.py``: async,
content-hashed, atomic -- in the reference's on-disk format.

Layout (the reference's, byte for byte):
  <dir>/step_<N>/              (atomic: written as .tmp_step_<N>, renamed)
    manifest.json              step, leaf index, shapes/dtypes, sha256 per leaf
    <leafpath>.npy             one file per state leaf, its raw bytes as uint8

Leaf paths are the reference's (``params/layers/attn/wq``,
``opt_state/m/...``, ``step``), so a checkpoint written by the JAX package
restores here and one written here restores there.

Fault-tolerance properties:
  * atomic rename => a crash mid-save never yields a half checkpoint that
    restore would pick up;
  * sha256 per leaf => bit-rot / truncation detected at restore; corrupt
    checkpoints are skipped and the previous valid one used.
"""

from __future__ import annotations

import hashlib
import json
import os
import re
import shutil
import threading

import numpy as np
import torch

from repro_torch.tree import leaves_with_paths


def _flatten(tree) -> dict:
    return {"/".join(path): leaf for path, leaf in leaves_with_paths(tree)}


def _raw(t: torch.Tensor) -> np.ndarray:
    """A host copy of ``t``'s bytes as a flat uint8 array."""
    return t.detach().contiguous().cpu().reshape(-1).view(torch.uint8) \
        .numpy().copy()


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).split(".")[1]       # the numpy / ml_dtypes name


def _sha256(raw: np.ndarray) -> str:
    return hashlib.sha256(raw.tobytes()).hexdigest()


def save(state, step: int, directory: str, blocking: bool = True,
         extra_meta: dict | None = None) -> threading.Thread | None:
    """Write checkpoint for ``step``.  blocking=False returns the writer
    thread (async checkpointing: the caller continues training while the
    host thread serializes)."""
    # snapshot to host memory synchronously, write async
    flat = {k: (_raw(v), list(v.shape), _dtype_name(v.dtype))
            for k, v in _flatten(state).items()}

    def _write():
        final = os.path.join(directory, f"step_{step:08d}")
        tmp = os.path.join(directory, f".tmp_step_{step:08d}")
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp, exist_ok=True)
        manifest = {"step": step, "leaves": {},
                    "meta": extra_meta or {}}
        for key, (raw, shape, dtype) in flat.items():
            fname = key.replace("/", "__") + ".npy"
            np.save(os.path.join(tmp, fname), raw)
            manifest["leaves"][key] = {
                "file": fname, "shape": shape, "dtype": dtype,
                "sha256": _sha256(raw)}
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        shutil.rmtree(final, ignore_errors=True)
        os.rename(tmp, final)

    if blocking:
        _write()
        return None
    t = threading.Thread(target=_write, daemon=False)
    t.start()
    return t


def available_steps(directory: str) -> list[int]:
    if not os.path.isdir(directory):
        return []
    out = []
    for name in os.listdir(directory):
        m = re.fullmatch(r"step_(\d+)", name)
        if m:
            out.append(int(m.group(1)))
    return sorted(out)


def _load_leaf(path: str, spec: dict) -> tuple[np.ndarray, torch.Tensor]:
    """The leaf's raw bytes and the CPU tensor they hold."""
    raw = np.load(path)
    t = torch.from_numpy(raw.copy()).view(getattr(torch, spec["dtype"]))
    return raw, t.reshape(spec["shape"])


def _validate(path: str) -> dict | None:
    mf = os.path.join(path, "manifest.json")
    if not os.path.exists(mf):
        return None
    try:
        with open(mf) as f:
            manifest = json.load(f)
        for spec in manifest["leaves"].values():
            raw, t = _load_leaf(os.path.join(path, spec["file"]), spec)
            if list(t.shape) != spec["shape"] or \
                    _sha256(raw) != spec["sha256"]:
                return None
        return manifest
    except Exception:
        return None


def restore(directory: str, template, step: int | None = None):
    """Restore into the structure of ``template`` (a tree of tensors).
    Skips corrupt checkpoints, falling back to older ones.  Returns
    (tree of CPU tensors, step); the caller places them."""
    steps = available_steps(directory)
    if step is not None:
        steps = [s for s in steps if s <= step]
    for s in reversed(steps):
        path = os.path.join(directory, f"step_{s:08d}")
        manifest = _validate(path)
        if manifest is None:
            continue
        keys = list(_flatten(template))
        if any(k not in manifest["leaves"] for k in keys):
            continue
        out: dict = {}
        for key in keys:
            spec = manifest["leaves"][key]
            node = out
            *parents, last = key.split("/")
            for p in parents:
                node = node.setdefault(p, {})
            node[last] = _load_leaf(os.path.join(path, spec["file"]), spec)[1]
        return out, s
    raise FileNotFoundError(f"no valid checkpoint in {directory}")
