"""Subcommand dispatcher: ``python -m repro_torch.launch <cmd> …``.

    python -m repro_torch.launch fleet --manifest demo --steps 12
    python -m repro_torch.launch train --arch smollm-360m --reduced \
        --device cpu --steps 3
    python -m repro_torch.launch serve --arch llama3.2-3b --requests 4
    python -m repro_torch.launch autoshard --arch glm4-9b --shape train_4k

Each subcommand is the ``main(argv)`` of the matching
``repro_torch.launch`` module; the per-module entry points
(``python -m repro_torch.launch.train``) keep working unchanged.
``dryrun`` is listed as in the reference and waits for the multi-device
slice (ROADMAP A14).
"""
from __future__ import annotations

import importlib
import sys

_COMMANDS = ("fleet", "train", "serve", "autoshard", "dryrun")


def main(argv=None) -> None:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        print(__doc__.strip())
        print(f"\ncommands: {', '.join(_COMMANDS)}")
        raise SystemExit(0 if argv else 2)
    cmd, rest = argv[0], argv[1:]
    if cmd not in _COMMANDS:
        print(f"unknown command {cmd!r}; expected one of "
              f"{', '.join(_COMMANDS)}", file=sys.stderr)
        raise SystemExit(2)
    if cmd == "dryrun":
        raise NotImplementedError("repro_torch.launch dryrun: the "
                                  "multi-device dry run waits for the "
                                  "multi-device slice (A14)")
    importlib.import_module(f"repro_torch.launch.{cmd}").main(rest)


if __name__ == "__main__":
    main()
