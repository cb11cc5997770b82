"""The reference's examples on the port, run as
``python -m repro_torch.examples.<name>``: ``quickstart``,
``kernel_autotune``, ``serve_decode``, ``train_smollm``,
``fault_tolerance``, ``fleet_churn``, ``autoshard_search``.

Each has ``main(argv=None)``, which returns a dict of what it printed.  An
example that touches a tensor runs on the card unless ``--device cpu`` is
given, and raises where there is none; checkpoints and registries go under
a temporary directory or ``/tmp/repro_torch_*``.
"""
from __future__ import annotations

import argparse

import torch


def add_device_arg(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the tensors live (default: the card)")


def device(name: str) -> torch.device:
    """``name`` as a device; ``cuda`` where there is no card raises."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device (torch.cuda.is_available() is "
                           "false); pass --device cpu to run on the CPU")
    return dev


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
