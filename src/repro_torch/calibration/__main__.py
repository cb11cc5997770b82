"""CLI for the calibration subsystem.

    # fit a model for the H100 in this machine and register it as gpu-h100
    PYTHONPATH=src python -m repro_torch.calibration --device gpu-h100 \
        --scale gpu --out experiments/registry

    # quick partial recalibration of the CPU (two kernel classes, fewer runs)
    PYTHONPATH=src python -m repro_torch.calibration --device cpu \
        --torch-device cpu --scale tiny --runs 8 \
        --classes stride1_global,arith --out /tmp/reg

    # inspect the registry
    PYTHONPATH=src python -m repro_torch.calibration --list
    PYTHONPATH=src python -m repro_torch.calibration --show tpu-v5e

``--device`` is the registry name of the fitted model, as in the reference;
the runtime device is ``--torch-device`` and defaults to the card.
"""
from __future__ import annotations

import argparse
import sys

from repro_torch.calibration import registry
from repro_torch.calibration.calibrate import calibrate
from repro_torch.core import mkernels
from repro_torch.core.model import ModelSchemaError


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.calibration",
        description="Fit, register and inspect per-device cost models.")
    ap.add_argument("--device", default="cpu",
                    help="registry name for the fitted model (default: cpu)")
    ap.add_argument("--torch-device", default="cuda",
                    help="device the kernels run on (default: cuda; pass "
                         "cpu to calibrate the CPU)")
    ap.add_argument("--out", metavar="DIR", default=None,
                    help="registry directory (default: $REPRO_MODEL_REGISTRY "
                         f"or {registry.DEFAULT_REGISTRY_DIR})")
    ap.add_argument("--scale", default="cpu", choices=mkernels.SCALES,
                    help="measurement-kernel size ladder (tiny = smoke, "
                         "gpu = one H100)")
    ap.add_argument("--runs", type=int, default=30,
                    help="timing runs per kernel (paper: 30)")
    ap.add_argument("--drop", type=int, default=4,
                    help="warmup runs discarded (paper: 4)")
    ap.add_argument("--ridge", type=float, default=1e-4,
                    help="unit-free ridge strength (0 disables)")
    ap.add_argument("--nonneg", action="store_true",
                    help="project weights to >= 0 (paper default: off)")
    ap.add_argument("--classes", default=None,
                    help="comma-separated kernel classes to measure "
                         "(default: full 9-class suite)")
    ap.add_argument("--dry-run", action="store_true",
                    help="fit and report but do not write the registry")
    ap.add_argument("--list", action="store_true", dest="list_",
                    help="list registered devices and exit")
    ap.add_argument("--show", metavar="DEVICE", default=None,
                    help="print a registered model's weight report and exit")
    args = ap.parse_args(argv)

    if args.list_:
        models = registry.list_models(args.out)
        width = max((len(n) for n in models), default=6)
        print(f"registry: {args.out or registry.default_registry_dir()}")
        for name, kind in sorted(models.items()):
            print(f"  {name:<{width}}  {kind}")
        return 0

    if args.show:
        try:
            model = registry.load_model(args.show, args.out)
        except (registry.UnknownDeviceError, ModelSchemaError) as e:
            # unknown device OR a registry file with a mismatched/unreadable
            # SCHEMA_VERSION: report clearly, don't traceback
            print(f"cannot load model {args.show!r}: {e}", file=sys.stderr)
            return 1
        print(model.interpretation_report())
        return 0

    classes = ([c.strip() for c in args.classes.split(",") if c.strip()]
               if args.classes else None)
    result = calibrate(
        args.device, scale=args.scale, runs=args.runs, drop=args.drop,
        ridge=args.ridge, nonneg=args.nonneg, classes=classes,
        registry_dir=args.out, write_registry=not args.dry_run,
        torch_device=args.torch_device)
    return 0 if result.model is not None else 1


if __name__ == "__main__":
    sys.exit(main())
