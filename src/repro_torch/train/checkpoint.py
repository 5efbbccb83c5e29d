"""Checkpointing: atomic, async-capable (PyTorch port of
``repro.train.checkpoint``).

Layout: <dir>/step_<k>/ { manifest.json, arrays.npz }, the JAX package's
format: each leaf is keyed by the ``jax.tree_util.keystr`` of its path
(``"['lora']['layers'][0]['wq']['a']"``; dict keys sorted, tuple and list
entries by index), so either package restores the other's checkpoints.
Writes go to a temp directory and are renamed into place, so a crash
mid-save never corrupts the latest checkpoint.
"""
from __future__ import annotations

import json
import os
import pathlib
import shutil
import tempfile
import threading
from typing import Any, Dict, Optional

import numpy as np
import torch


def _key(k) -> str:
    return f"[{k!r}]"


def _flatten(tree, prefix: str = "", out: Optional[Dict] = None
             ) -> Dict[str, np.ndarray]:
    """keystr -> numpy array of every leaf, in ``jax.tree_util`` order."""
    out = {} if out is None else out
    if isinstance(tree, dict):
        for k in sorted(tree):
            _flatten(tree[k], prefix + _key(k), out)
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            _flatten(v, f"{prefix}[{i}]", out)
    elif isinstance(tree, torch.Tensor):
        out[prefix] = tree.detach().cpu().numpy()
    else:
        out[prefix] = np.asarray(tree)
    return out


def save(ckpt_dir: str, step: int, tree: Any, *, meta: Optional[Dict] = None,
         keep: int = 3) -> str:
    """Atomic synchronous save. Returns the checkpoint path."""
    return _write(ckpt_dir, step, _flatten(tree), meta, keep)


def _write(ckpt_dir: str, step: int, flat: Dict[str, np.ndarray],
           meta: Optional[Dict], keep: int) -> str:
    root = pathlib.Path(ckpt_dir)
    root.mkdir(parents=True, exist_ok=True)
    tmp = pathlib.Path(tempfile.mkdtemp(dir=root, prefix=".tmp_save_"))
    try:
        np.savez(tmp / "arrays.npz", **flat)
        manifest = {"step": step, "keys": sorted(flat), **(meta or {})}
        (tmp / "manifest.json").write_text(json.dumps(manifest, indent=1))
        final = root / f"step_{step:08d}"
        if final.exists():
            shutil.rmtree(final)
        os.rename(tmp, final)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    _gc(root, keep)
    return str(final)


class AsyncSaver:
    """Overlaps checkpoint I/O with the next training steps: the arrays are
    copied to the host before ``save`` returns, and a thread writes them.
    ``wait`` joins the write and raises what it raised."""

    def __init__(self):
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self.last_path: Optional[str] = None

    def save(self, ckpt_dir: str, step: int, tree: Any, *,
             meta: Optional[Dict] = None, keep: int = 3) -> None:
        self.wait()
        flat = _flatten(tree)

        def run():
            try:
                self.last_path = _write(ckpt_dir, step, flat, meta, keep)
            except BaseException as exc:  # noqa: BLE001 — raised by wait()
                self._error = exc

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err


def latest_step(ckpt_dir: str) -> Optional[int]:
    root = pathlib.Path(ckpt_dir)
    if not root.exists():
        return None
    steps = [int(p.name.split("_")[1]) for p in root.glob("step_*")]
    return max(steps) if steps else None


def restore(ckpt_dir: str, target: Any, step: Optional[int] = None) -> Any:
    """Restore into the structure of ``target``: each tensor leaf becomes a
    tensor of its dtype on its device; a non-tensor leaf becomes a numpy
    array of its dtype."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    path = pathlib.Path(ckpt_dir) / f"step_{step:08d}"
    with np.load(path / "arrays.npz") as blob:
        def visit(node, prefix):
            if isinstance(node, dict):
                return {k: visit(v, prefix + _key(k)) for k, v in node.items()}
            if isinstance(node, (tuple, list)):
                return type(node)(visit(v, f"{prefix}[{i}]")
                                  for i, v in enumerate(node))
            arr = blob[prefix]
            if isinstance(node, torch.Tensor):
                return torch.from_numpy(np.array(arr)).to(
                    device=node.device, dtype=node.dtype)
            return np.asarray(arr, dtype=np.asarray(node).dtype)
        return visit(target, "")


def read_manifest(ckpt_dir: str, step: Optional[int] = None) -> Dict:
    if step is None:
        step = latest_step(ckpt_dir)
    path = pathlib.Path(ckpt_dir) / f"step_{step:08d}" / "manifest.json"
    return json.loads(path.read_text())


def _gc(root: pathlib.Path, keep: int) -> None:
    steps = sorted(root.glob("step_*"))
    for p in steps[:-keep]:
        shutil.rmtree(p, ignore_errors=True)
