"""Atomic, verified, resumable checkpointing of torch state (numpy files).

Layout:
    <dir>/step_<N>/
        manifest.json        # keys, shapes, types, crc32s, step
        leaf_00000.npy …     # one file per leaf of the tree

A tree is nested dicts (keys in sorted order), lists, tuples and NamedTuples
whose leaves are tensors, numpy arrays and host ints or floats — for the
trainer, ``runtime.steps.state_tree``: the parameters by name, the optimizer
state and the step.

Guarantees, as in the reference's ``checkpoint/store.py``:
  * **Atomicity** — writes land in ``step_<N>.tmp`` and are ``os.rename``d
    only after the manifest (written last) is fsynced: a crash mid-write
    never yields a directory that ``latest_step`` will pick up.
  * **Integrity** — each leaf carries a crc32 in the manifest; restore
    verifies key, shape, type and crc before handing the tree over.
  * **Exact types** — a bf16 tensor has no numpy type: its bits are stored
    as ``uint16`` with ``bfloat16`` in the manifest, and restored bit-equal.
  * **Async** — ``AsyncCheckpointer`` copies the state to host memory
    synchronously (the trainer updates its tensors in place right after)
    and writes on a background thread; ``wait()`` joins before the next
    save or at exit.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import threading
import zlib
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.obs import metrics as _obs_metrics
from repro_torch.obs import report as _obs_report

_CKPT_FALLBACKS = _obs_metrics.REGISTRY.counter(
    "repro_checkpoint_fallbacks_total",
    "invalid checkpoints quarantined by restore_latest_valid while "
    "falling back to an older step")

_STEP_DIR = re.compile(r"step_(\d+)$")

#: torch types without a numpy type: their bits go through int16 / uint16
_BITS16 = (torch.bfloat16,)


class CheckpointError(AssertionError):
    """A checkpoint failed integrity verification (truncated manifest,
    tree/shape/type mismatch, crc failure).  ``restore_latest_valid``
    quarantines such a step and falls back instead of raising."""


def _step_dirs(ckpt_dir: str) -> List[int]:
    """Steps with a complete-looking directory (manifest present),
    ascending.  Non-step entries (``quarantine/``, ``*.tmp``) are
    ignored."""
    if not os.path.isdir(ckpt_dir):
        return []
    steps = []
    for d in os.listdir(ckpt_dir):
        m = _STEP_DIR.fullmatch(d)
        if m and os.path.exists(os.path.join(ckpt_dir, d, "manifest.json")):
            steps.append(int(m.group(1)))
    return sorted(steps)


def _flatten(tree: Any, key: str = "") -> List[Tuple[str, Any]]:
    """(key path, leaf) pairs in a fixed order."""
    if isinstance(tree, dict):
        return [kv for k in sorted(tree) for kv in
                _flatten(tree[k], f"{key}[{k!r}]")]
    if isinstance(tree, (list, tuple)):
        fields = getattr(tree, "_fields", None)
        return [kv for i, t in enumerate(tree) for kv in
                _flatten(t, f"{key}.{fields[i]}" if fields
                         else f"{key}[{i}]")]
    return [(key, tree)]


def _unflatten(template: Any, leaves) -> Any:
    if isinstance(template, dict):
        return {k: _unflatten(template[k], leaves) for k in sorted(template)}
    if isinstance(template, (list, tuple)):
        items = [_unflatten(t, leaves) for t in template]
        if hasattr(template, "_fields"):
            return type(template)(*items)
        return type(template)(items)
    return next(leaves)


def _to_host(leaf: Any) -> Any:
    """A copy of ``leaf`` on the host that later in-place updates of the
    live tensor cannot reach."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True)
    return leaf


def _describe(leaf: Any) -> Tuple[str, str, List[int]]:
    """-> (kind, type name, shape) of a leaf, without copying it."""
    if isinstance(leaf, torch.Tensor):
        return ("tensor", str(leaf.dtype).replace("torch.", ""),
                list(leaf.shape))
    if isinstance(leaf, (bool, int, float)):
        return type(leaf).__name__, str(np.asarray(leaf).dtype), []
    arr = np.asarray(leaf)
    return "ndarray", str(arr.dtype), list(arr.shape)


def _encode(leaf: Any) -> np.ndarray:
    """The array a leaf is written as (a bf16 tensor's bits as uint16)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        if t.dtype in _BITS16:
            return t.view(torch.int16).numpy().view(np.uint16)
        return t.numpy()
    return np.asarray(leaf)


def _decode(arr: np.ndarray, kind: str, dtype: str) -> Any:
    if kind == "tensor":
        tdt = getattr(torch, dtype)
        if tdt in _BITS16:
            return torch.from_numpy(arr.view(np.int16)).view(tdt)
        return torch.from_numpy(arr)
    if kind in ("bool", "int", "float"):
        return {"bool": bool, "int": int, "float": float}[kind](arr)
    return arr


def _crc(arr: np.ndarray) -> int:
    return zlib.crc32(np.ascontiguousarray(arr).reshape(-1).view(np.uint8))


def save(ckpt_dir: str, step: int, tree: Any,
         extra_meta: Optional[Dict[str, Any]] = None) -> str:
    """Synchronous atomic save.  Returns the final directory path."""
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)

    manifest: Dict[str, Any] = {"step": int(step), "leaves": [],
                                "meta": extra_meta or {}}
    for i, (key, leaf) in enumerate(_flatten(tree)):
        kind, dtype, _ = _describe(leaf)
        arr = _encode(leaf)
        fn = f"leaf_{i:05d}.npy"
        np.save(os.path.join(tmp, fn), arr, allow_pickle=False)
        manifest["leaves"].append({
            "key": key, "file": fn, "shape": list(arr.shape),
            "kind": kind, "dtype": dtype, "stored": str(arr.dtype),
            "crc32": _crc(arr)})
    mpath = os.path.join(tmp, "manifest.json")
    with open(mpath, "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def latest_step(ckpt_dir: str) -> Optional[int]:
    steps = _step_dirs(ckpt_dir)
    return steps[-1] if steps else None


def restore(ckpt_dir: str, template: Any, step: Optional[int] = None
            ) -> Tuple[Any, Dict[str, Any]]:
    """Restore into the structure of ``template`` (verified leaf by leaf
    against the manifest's keys, shapes, types and crc32s).  Tensor leaves
    come back as CPU tensors of the stored type (``load_into`` copies them
    into live tensors)."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise CheckpointError(f"no checkpoint under {ckpt_dir}")
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    try:
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
    except (OSError, ValueError) as exc:
        raise CheckpointError(
            f"corrupt manifest in step {step}: {exc}") from exc

    tpl = _flatten(template)
    if len(tpl) != len(manifest.get("leaves", [])):
        raise CheckpointError(
            f"corrupt checkpoint step {step}: {len(tpl)} template leaves "
            f"but {len(manifest.get('leaves', []))} in manifest")
    leaves = []
    for (key, tleaf), m in zip(tpl, manifest["leaves"]):
        if key != m["key"]:
            raise CheckpointError(f"tree mismatch: {key} != {m['key']}")
        try:
            arr = np.load(os.path.join(d, m["file"]), allow_pickle=False)
        except (OSError, ValueError) as exc:
            raise CheckpointError(
                f"corrupt leaf {key} in step {step}: {exc}") from exc
        if list(arr.shape) != m["shape"] or str(arr.dtype) != m["stored"]:
            raise CheckpointError(
                f"corrupt leaf {key} in step {step}: shape/type "
                f"{arr.shape}/{arr.dtype} != {m['shape']}/{m['stored']}")
        want = _describe(tleaf)
        if want != (m.get("kind"), m["dtype"], m["shape"]):
            raise CheckpointError(
                f"leaf {key} of step {step} is {m.get('kind')} {m['dtype']} "
                f"{m['shape']}; the template has {want}")
        if _crc(arr) != m["crc32"]:
            raise CheckpointError(f"corrupt leaf {key} in step {step}")
        leaves.append(_decode(arr, m["kind"], m["dtype"]))
    return _unflatten(template, iter(leaves)), manifest


@torch.no_grad()
def load_into(live: Any, restored: Any) -> Any:
    """``live`` with each tensor overwritten IN PLACE by the matching tensor
    of ``restored`` (same structure, e.g. from ``restore``), and every other
    leaf taken from ``restored``.  Returns the new tree."""
    pairs = zip((leaf for _, leaf in _flatten(live)),
                (leaf for _, leaf in _flatten(restored)))
    out = []
    for a, b in pairs:
        if isinstance(a, torch.Tensor):
            a.copy_(b)
            out.append(a)
        else:
            out.append(b)
    return _unflatten(live, iter(out))


def quarantine(ckpt_dir: str, step: int) -> Optional[str]:
    """Move an invalid checkpoint into ``<ckpt_dir>/quarantine/`` so
    ``latest_step`` stops offering it (best-effort; returns the new path,
    replacing any earlier quarantined copy of the same step)."""
    src = os.path.join(ckpt_dir, f"step_{step:08d}")
    qdir = os.path.join(ckpt_dir, "quarantine")
    dst = os.path.join(qdir, f"step_{step:08d}")
    try:
        os.makedirs(qdir, exist_ok=True)
        if os.path.exists(dst):
            shutil.rmtree(dst, ignore_errors=True)
        os.rename(src, dst)
        return dst
    except OSError:
        shutil.rmtree(src, ignore_errors=True)  # still unblock the parse
        return None


def restore_latest_valid(ckpt_dir: str, template: Any
                         ) -> Optional[Tuple[Any, Dict[str, Any], int]]:
    """Restore the newest checkpoint that passes verification.

    Invalid checkpoints (truncated manifest, crc/shape mismatch — e.g. a
    write interrupted by the very preemption being recovered from) are
    quarantined under ``<ckpt_dir>/quarantine/`` and the next-older step
    is tried, so a corrupt newest checkpoint costs one interval of
    replay, never the run.  Returns ``(tree, manifest, step)`` or None
    when no valid checkpoint exists."""
    for step in reversed(_step_dirs(ckpt_dir)):
        try:
            tree, manifest = restore(ckpt_dir, template, step)
            return tree, manifest, step
        except CheckpointError as exc:
            qpath = quarantine(ckpt_dir, step)
            _CKPT_FALLBACKS.inc()
            _obs_report.emit("ckpt", {
                "step": step, "action": "quarantine",
                "to": qpath or "<removed>"},
                text=f"invalid checkpoint skipped: {exc}")
    return None


def prune(ckpt_dir: str, keep: int = 3) -> None:
    """Keep the newest ``keep`` checkpoints (and remove stale .tmp dirs)."""
    if not os.path.isdir(ckpt_dir):
        return
    for d in os.listdir(ckpt_dir):
        if d.endswith(".tmp"):
            shutil.rmtree(os.path.join(ckpt_dir, d), ignore_errors=True)
    steps = sorted(s for s in (
        int(m.group(1)) for m in (
            _STEP_DIR.fullmatch(d) for d in os.listdir(ckpt_dir)) if m))
    for s in steps[:-keep] if keep else steps:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:08d}"),
                      ignore_errors=True)


class AsyncCheckpointer:
    """Copy to host memory synchronously, write on a background thread."""

    def __init__(self, ckpt_dir: str, keep: int = 3):
        self.ckpt_dir = ckpt_dir
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def save(self, step: int, tree: Any,
             extra_meta: Optional[Dict[str, Any]] = None) -> None:
        self.wait()
        host_tree = _unflatten(tree, (_to_host(leaf)
                                      for _, leaf in _flatten(tree)))

        def _write():
            try:
                save(self.ckpt_dir, step, host_tree, extra_meta)
                prune(self.ckpt_dir, self.keep)
            except BaseException as e:  # surfaced on next wait()
                self._error = e

        self._thread = threading.Thread(target=_write, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err
