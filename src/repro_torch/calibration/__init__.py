"""Calibration & device-model registry — the paper's fit-once-per-device,
predict-cheaply-anywhere loop as a subsystem.

Public surface (what is ported so far):

  * ``calibrate(device, ...)`` — run the measurement-kernel suite on the
    runtime device (the card by default), fit, report, and register the
    model (``python -m repro_torch.calibration`` is the CLI);
  * ``load_model(device)`` / ``save_model(model)`` / ``list_models()`` —
    the registry of fitted and analytic per-device models, with the same
    file format as the reference's, so a model file written by either
    package loads in the other;
  * ``resolve_model(x)`` — normalize ``None | name | LinearCostModel``.

The reference's online path (``telemetry.py``, ``online.py``) is not ported
yet.
"""
from repro_torch.calibration.calibrate import CalibrationResult, calibrate
from repro_torch.calibration.registry import (UnknownDeviceError,
                                              default_registry_dir,
                                              list_models, load_model,
                                              register_revision,
                                              resolve_model, save_model)
from repro_torch.calibration.seeds import (ANALYTIC_SEEDS, Datasheet,
                                           analytic_model)

__all__ = [
    "ANALYTIC_SEEDS", "CalibrationResult", "Datasheet", "UnknownDeviceError",
    "analytic_model", "calibrate", "default_registry_dir", "list_models",
    "load_model", "register_revision", "resolve_model", "save_model",
]
