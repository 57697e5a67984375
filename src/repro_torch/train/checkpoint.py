"""Atomic checkpointing (counterpart of `repro/train/checkpoint.py`).

A checkpoint is a flat npz (one entry per tree path, the reference's path
strings) plus a json manifest with step, wall time and a sha256 of the
npz.  Each file is written to a temporary name, fsynced and renamed into
place, so a process killed mid-save never corrupts the restore path, and
a file whose digest does not match is skipped for an older step.  Arrays
are pulled to the host first; a restore places each leaf on the device
and in the dtype of the template's leaf.  The files are the reference's:
a checkpoint written by either package restores into the other's state.
"""
from __future__ import annotations

import hashlib
import json
import os
import time

import numpy as np
import torch

from repro_torch.tree import tree_flatten_with_path, tree_unflatten_like


def _host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _flatten(tree) -> dict[str, np.ndarray]:
    return {path: _host(leaf) for path, leaf in tree_flatten_with_path(tree)}


def _sha256(path: str) -> str:
    digest = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            digest.update(chunk)
    return digest.hexdigest()


class CheckpointManager:
    def __init__(self, directory: str, keep_n: int = 3):
        self.dir = directory
        self.keep_n = keep_n
        os.makedirs(directory, exist_ok=True)

    # ------------------------------------------------------------- save
    def save(self, step: int, payload: dict) -> str:
        """payload: {"state": tree, "step": int, ...extra json-ables}."""
        flat = _flatten(payload["state"])
        tmp = os.path.join(self.dir, f".tmp_{step}_{os.getpid()}.npz")
        final = os.path.join(self.dir, f"ckpt_{step:08d}.npz")
        with open(tmp, "wb") as f:
            np.savez(f, **flat)
            f.flush()
            os.fsync(f.fileno())  # data must hit disk before the rename does
        os.replace(tmp, final)  # atomic
        manifest = {
            "step": int(step),
            "time": time.time(),
            "file": os.path.basename(final),
            "sha256": _sha256(final),
            "n_arrays": len(flat),
        }
        mtmp = os.path.join(self.dir, f".tmp_manifest_{step}.json")
        with open(mtmp, "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(mtmp, os.path.join(self.dir, f"ckpt_{step:08d}.json"))
        self._gc()
        return final

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[: -self.keep_n]:
            for ext in ("npz", "json"):
                try:
                    os.remove(os.path.join(self.dir, f"ckpt_{s:08d}.{ext}"))
                except FileNotFoundError:
                    pass

    # ---------------------------------------------------------- restore
    def all_steps(self) -> list[int]:
        steps = []
        for name in os.listdir(self.dir):
            if name.startswith("ckpt_") and name.endswith(".json"):
                steps.append(int(name[5:13]))
        return sorted(steps)

    def restore(self, step: int, template=None) -> dict | None:
        """{"state", "step"} of `step`, or None when its files are missing
        or the npz does not match its manifest's digest.  With a template,
        the state is the template's tree with each leaf as a tensor in that
        leaf's dtype, shape and device; without, the flat {path: array}."""
        path = os.path.join(self.dir, f"ckpt_{step:08d}.npz")
        mpath = os.path.join(self.dir, f"ckpt_{step:08d}.json")
        if not (os.path.exists(path) and os.path.exists(mpath)):
            return None
        with open(mpath) as f:
            manifest = json.load(f)
        if _sha256(path) != manifest["sha256"]:
            return None  # corrupted: caller falls back to an older step
        with np.load(path) as npz:
            data = dict(npz)
        state = self._unflatten_like(template, data) if template is not None else data
        return {"state": state, "step": manifest["step"]}

    def restore_latest(self, template=None) -> dict | None:
        for step in reversed(self.all_steps()):
            out = self.restore(step, template)
            if out is not None:
                return out
        return None

    @staticmethod
    def _unflatten_like(template, flat: dict[str, np.ndarray]):
        leaves = []
        for path, leaf in tree_flatten_with_path(template):
            if isinstance(leaf, torch.Tensor):
                arr = torch.from_numpy(np.array(flat[path]))
                leaves.append(arr.to(device=leaf.device, dtype=leaf.dtype).reshape(leaf.shape))
            else:
                leaf = np.asarray(leaf)
                leaves.append(np.asarray(flat[path], dtype=leaf.dtype).reshape(leaf.shape))
        return tree_unflatten_like(template, leaves)
