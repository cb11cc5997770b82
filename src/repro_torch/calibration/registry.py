"""The device-model registry — fit once per device, load anywhere.

A registry is a plain directory of ``<device>.json`` files, each a
schema-versioned ``LinearCostModel`` (see ``core.model.SCHEMA_VERSION``).
Lookup order for ``load_model(device)``:

  1. a **fitted** model file in the registry directory (written by the
     calibration driver, ``python -m repro_torch.calibration``);
  2. a built-in **analytic** seed (``seeds.ANALYTIC_SEEDS``: the TPU-v5e
     datasheet seed plus cross-vendor GPU datasheet seeds).

The registry directory defaults to ``$REPRO_MODEL_REGISTRY`` or
``experiments/registry`` under the current working directory.
"""
from __future__ import annotations

import json
import os
import re
import shutil
from typing import Dict, Optional, Tuple

from repro_torch.calibration import seeds
from repro_torch.core.model import (FutureSchemaError, LinearCostModel,
                              ModelSchemaError)
from repro_torch.obs import metrics as _obs_metrics
from repro_torch.obs import report as _obs_report

REGISTRY_ENV = "REPRO_MODEL_REGISTRY"
DEFAULT_REGISTRY_DIR = os.path.join("experiments", "registry")

#: revision backups kept per device (``<safe>.rev<NNNN>.json``), written by
#: ``register_revision`` so a corrupted active file has somewhere to fall
#: back to
KEEP_REVISION_BACKUPS = 3

_FALLBACKS = _obs_metrics.REGISTRY.counter(
    "repro_registry_fallbacks_total",
    "corrupt registry model files quarantined and recovered from a "
    "previous revision or analytic seed, by device")


class UnknownDeviceError(KeyError):
    """No fitted or analytic model exists for the requested device."""

    def __init__(self, device: str, available: Dict[str, str]):
        self.device = device
        self.available = available
        listing = ", ".join(f"{n} ({k})" for n, k in sorted(available.items())) \
            or "<none>"
        super().__init__(
            f"no model for device {device!r}; available: {listing}. "
            f"Fit one with: python -m repro_torch.calibration "
            f"--device {device}")

    def __str__(self) -> str:  # KeyError would repr() the message
        return self.args[0]


def default_registry_dir() -> str:
    return os.environ.get(REGISTRY_ENV, DEFAULT_REGISTRY_DIR)


def _model_path(registry_dir: str, device: str) -> str:
    safe = re.sub(r"[^A-Za-z0-9._+-]", "_", device)
    return os.path.join(registry_dir, f"{safe}.json")


def _revision_backups(registry_dir: str, device: str):
    """Revision-backup paths for ``device``, newest revision first."""
    safe = re.sub(r"[^A-Za-z0-9._+-]", "_", device)
    pat = re.compile(re.escape(safe) + r"\.rev(\d+)\.json$")
    out = []
    try:
        names = os.listdir(registry_dir)
    except OSError:
        return []
    for fn in names:
        m = pat.fullmatch(fn)
        if m:
            out.append((int(m.group(1)), os.path.join(registry_dir, fn)))
    return [p for _, p in sorted(out, reverse=True)]


def _quarantine(path: str) -> Optional[str]:
    """Move a corrupt file aside as ``<path>.corrupt`` (best-effort)."""
    qpath = path + ".corrupt"
    try:
        os.replace(path, qpath)
        return qpath
    except OSError:
        return None


# ---------------------------------------------------------------------------
# Public API
# ---------------------------------------------------------------------------


def save_model(model: LinearCostModel, registry_dir: Optional[str] = None,
               name: Optional[str] = None) -> str:
    """Write ``model`` into the registry under ``name`` (default: its
    ``device`` field).  Returns the file path."""
    registry_dir = registry_dir or default_registry_dir()
    os.makedirs(registry_dir, exist_ok=True)
    path = _model_path(registry_dir, name or model.device)
    model.save(path)
    return path


def register_revision(model: LinearCostModel,
                      registry_dir: Optional[str] = None,
                      name: Optional[str] = None) -> Tuple[str, int]:
    """Register ``model`` as the next revision of ``name``'s entry.

    The online-calibration path (``calibration/online.py``) calls this on
    every drift refit: the existing registry file's ``meta["revision"]``
    (0 when absent or unreadable) is bumped by one, stamped into the model,
    and the file is rewritten.  The rewrite rolls the file mtime, so every
    consumer memoizing per-device conclusions on ``fingerprint(device)``
    (e.g. the kernel autotuner's block-choice memo) misses and re-derives
    against the refit weights.  Returns (path, new revision)."""
    registry_dir = registry_dir or default_registry_dir()
    name = name or model.device
    path = _model_path(registry_dir, name)
    prev = 0
    prev_valid = False
    if os.path.exists(path):
        try:
            with open(path) as f:
                prev = int(LinearCostModel.from_json_dict(
                    json.load(f)).meta.get("revision", 0))
            prev_valid = True
        except (OSError, ValueError, KeyError, TypeError):
            prev = 0
    if prev_valid:
        # keep the outgoing revision as a fallback target: the hardened
        # ``load_model`` degrades to the newest backup when the active
        # file is later found corrupt
        safe = re.sub(r"[^A-Za-z0-9._+-]", "_", name)
        try:
            shutil.copyfile(path, os.path.join(
                registry_dir, f"{safe}.rev{prev:04d}.json"))
            for old in _revision_backups(registry_dir,
                                         name)[KEEP_REVISION_BACKUPS:]:
                os.remove(old)
        except OSError:
            pass   # backups are best-effort; never fail the refit
    model.meta["revision"] = prev + 1
    return save_model(model, registry_dir, name=name), prev + 1


#: analytic seeds are pure functions of the datasheet constants, so one
#: shared instance per name serves every caller.  Returning the SAME
#: object each time also lets identity-keyed downstream memos hit — the
#: fused engine's per-program weight folds (``exprops.BasisProgram``)
#: cache per model instance, and the replan/straggler fast paths resolve
#: a model on every call.  Treated as read-only everywhere.
_SEED_CACHE: Dict[str, LinearCostModel] = {}


def _analytic_seed(device: str) -> Optional[LinearCostModel]:
    model = _SEED_CACHE.get(device)
    if model is None:
        builder = seeds.ANALYTIC_SEEDS.get(device)
        if builder is None:
            return None
        model = _SEED_CACHE[device] = builder()
    return model


def _load_hardened(device: str, registry_dir: Optional[str] = None
                   ) -> Tuple[LinearCostModel, Optional[str]]:
    """``load_model`` plus provenance: returns ``(model, fellback)`` where
    ``fellback`` is ``None`` on a clean load (fitted file or plain analytic
    seed) and ``"backup"``/``"seed"`` when a corrupt active file was
    quarantined and the load degraded — what ``load_models`` rolls up so a
    fleet caller can see at a glance which pools run on degraded models."""
    registry_dir = registry_dir or default_registry_dir()
    path = _model_path(registry_dir, device)
    if os.path.exists(path):
        try:
            return LinearCostModel.load(path), None
        except FutureSchemaError:
            raise
        except (OSError, ValueError, KeyError, TypeError) as exc:
            qpath = _quarantine(path)
            _FALLBACKS.inc(1, device=device)
            _obs_report.emit("registry", {
                "device": device, "action": "fallback",
                "quarantined": qpath or "<failed>"},
                text=f"corrupt model file ({type(exc).__name__}); "
                     f"falling back")
            for bpath in _revision_backups(registry_dir, device):
                try:
                    model = LinearCostModel.load(bpath)
                except (OSError, ValueError, KeyError, TypeError):
                    continue
                _obs_report.emit("registry", {
                    "device": device, "action": "fallback",
                    "revision": model.meta.get("revision", "?")},
                    text=f"recovered from backup {os.path.basename(bpath)}")
                return model, "backup"
            model = _analytic_seed(device)
            if model is not None:
                return model, "seed"
            raise UnknownDeviceError(device, list_models(registry_dir))
    model = _analytic_seed(device)
    if model is not None:
        return model, None
    raise UnknownDeviceError(device, list_models(registry_dir))


def load_model(device: str, registry_dir: Optional[str] = None
               ) -> LinearCostModel:
    """Load the model for ``device``: fitted registry file first, then the
    built-in analytic seeds.  Raises ``UnknownDeviceError`` otherwise.

    Hardened against corruption: a truncated/garbled active
    file is quarantined as ``*.corrupt`` and the load falls back to the
    newest valid revision backup (written by ``register_revision``), then
    the analytic seed — counted in ``repro_registry_fallbacks_total``.
    A FUTURE schema re-raises (an upgrade problem, not corruption)."""
    return _load_hardened(device, registry_dir)[0]


def load_models(names, registry_dir: Optional[str] = None
                ) -> Dict[str, LinearCostModel]:
    """Batch loader for a heterogeneous fleet: one hardened ``load_model``
    per distinct name, plus ONE ``[registry]`` rollup line naming which
    devices fell back (quarantined active file recovered from a revision
    backup or the analytic seed).  A corrupt model for one device type
    therefore degrades only that pool's placements — the other models load
    clean and the caller learns exactly which pool is priced on stale
    weights.  Unknown devices still raise ``UnknownDeviceError``: a pool
    naming a device nobody can price is a manifest error, not churn."""
    models: Dict[str, LinearCostModel] = {}
    fellback = []
    for name in dict.fromkeys(names):
        model, fb = _load_hardened(name, registry_dir)
        models[name] = model
        if fb:
            fellback.append(f"{name}:{fb}")
    _obs_report.emit("registry", {
        "loaded": len(models),
        "fallbacks": ",".join(fellback) or "none"},
        text="batch load")
    return models


def list_models(registry_dir: Optional[str] = None) -> Dict[str, str]:
    """Every loadable device name -> "fitted" | "analytic".  A fitted file
    shadows an analytic seed of the same name (as in ``load_model``)."""
    registry_dir = registry_dir or default_registry_dir()
    out: Dict[str, str] = {n: "analytic" for n in seeds.ANALYTIC_SEEDS}
    if os.path.isdir(registry_dir):
        for fn in sorted(os.listdir(registry_dir)):
            if not fn.endswith(".json") or re.search(r"\.rev\d+\.json$", fn):
                continue   # revision backups are fallbacks, not entries
            path = os.path.join(registry_dir, fn)
            try:
                with open(path) as f:
                    d = json.load(f)
                LinearCostModel.from_json_dict(d)
            except (OSError, ValueError, KeyError, TypeError, AttributeError):
                continue  # not a readable model file; skip, don't crash
            out[fn[:-len(".json")]] = "fitted"
    return out


def fingerprint(device: str, registry_dir: Optional[str] = None):
    """Cache-key stamp for ``device``'s registry state: (registry dir,
    fitted-file mtime or None).  Changes whenever a recalibration rewrites
    the fitted model or the registry dir is redirected — callers memoizing
    per-device results (e.g. the kernel autotuner) key on this so they
    never serve conclusions from a superseded model."""
    registry_dir = registry_dir or default_registry_dir()
    path = _model_path(registry_dir, device)
    try:
        mtime = os.stat(path).st_mtime_ns
    except OSError:
        mtime = None
    return (registry_dir, mtime)


def resolve_model(model, default: str = "tpu-v5e",
                  registry_dir: Optional[str] = None) -> LinearCostModel:
    """Normalize a model argument: ``None`` -> the ``default`` *analytic*
    seed (deterministic — a fitted file never shadows the None default),
    ``str`` -> registry lookup (fitted shadows analytic), and a
    ``LinearCostModel`` passes through.

    Same rules as ``core.predictor.resolve_model`` (which the plan-search /
    straggler / elastic layers call), plus the ``registry_dir`` override.
    """
    if model is None:
        seed = _analytic_seed(default)
        if seed is None:
            raise UnknownDeviceError(default, list_models(registry_dir))
        return seed
    if isinstance(model, str):
        return load_model(model, registry_dir)
    if isinstance(model, LinearCostModel):
        return model
    raise TypeError(f"expected model name, LinearCostModel or None; "
                    f"got {type(model).__name__}")
