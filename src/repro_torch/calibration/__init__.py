"""Calibration & device-model registry — the paper's fit-once-per-device,
predict-cheaply-anywhere loop as a subsystem.

Public surface:

  * ``calibrate(device, ...)`` — run the measurement-kernel suite on the
    runtime device (the card by default), fit, report, and register the
    model (``python -m repro_torch.calibration`` is the CLI);
  * ``load_model(device)`` / ``save_model(model)`` / ``list_models()`` —
    the registry of fitted and analytic per-device models, with the same
    file format as the reference's, so a model file written by either
    package loads in the other;
  * ``resolve_model(x)`` — normalize ``None | name | LinearCostModel``;
  * the **online** path — ``TelemetrySink`` (``telemetry.py``) buffering
    live (property vector, seconds) samples, ``OnlineCalibrator`` /
    ``DriftMonitor`` (``online.py``) tracking the fit with streaming RLS,
    flagging drift, and re-registering refit models with
    ``register_revision``.
"""
from repro_torch.calibration.calibrate import CalibrationResult, calibrate
from repro_torch.calibration.online import (DriftEvent, DriftMonitor,
                                            OnlineCalibrator)
from repro_torch.calibration.registry import (UnknownDeviceError,
                                              default_registry_dir,
                                              list_models, load_model,
                                              register_revision,
                                              resolve_model, save_model)
from repro_torch.calibration.seeds import (ANALYTIC_SEEDS, Datasheet,
                                           analytic_model)
from repro_torch.calibration.telemetry import (TelemetrySample,
                                               TelemetrySink, pv_fingerprint)

__all__ = [
    "ANALYTIC_SEEDS", "CalibrationResult", "Datasheet", "DriftEvent",
    "DriftMonitor", "OnlineCalibrator", "TelemetrySample", "TelemetrySink",
    "UnknownDeviceError", "analytic_model", "calibrate",
    "default_registry_dir", "list_models", "load_model", "pv_fingerprint",
    "register_revision", "resolve_model", "save_model",
]
