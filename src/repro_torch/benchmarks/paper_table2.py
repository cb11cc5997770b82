"""Paper Table 2 on the port's device: the fitted weights, read as rates
(the counterpart of the reference's ``benchmarks/paper_table2.py``).

Prints the seconds-per-event weights of the model ``paper_table1`` fitted,
sorted by |weight|, beside the ``gpu-h100`` analytic seed's (the H100
datasheet's rates, ``calibration/seeds.py``) and the reference's TPU v5e
seed (a TPU's rates, kept as the reference prints them) — the paper's
point that the weights "allow direct conclusions about sustained typical
rates … and are directly comparable across devices".  Writes
``torch_paper_table2.json``: the fit under ``fit`` (the reference's
``cpu``: the fitted device varies here), ``gpu_h100_seed`` and
``tpu_v5e_seed``.

    PYTHONPATH=src python -m repro_torch.benchmarks.paper_table2 --scale gpu
"""
from __future__ import annotations

import argparse
import json
import os
from typing import Dict, Optional

from repro_torch.benchmarks import paper_table1
from repro_torch.calibration import seeds
from repro_torch.core import mkernels, predictor
from repro_torch.core.model import LinearCostModel

OUT_DIR = paper_table1.OUT_DIR


def main(argv=None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scale", default="gpu", choices=mkernels.SCALES)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=OUT_DIR)
    ap.add_argument("--registry", default=None)
    a = ap.parse_args(argv)
    return table(a.scale, a.device, a.out, a.registry)


def table(scale: str = "gpu", device: str = "cuda", out: str = OUT_DIR,
          registry: Optional[str] = None) -> Dict:
    name = paper_table1.model_name(device, scale)
    path = paper_table1.model_path(out, name, scale)
    if not os.path.exists(path):
        paper_table1.run(scale=scale, device=device, out=out,
                         registry=registry, verbose=False)
    fit = LinearCostModel.load(path)
    h100 = seeds.ANALYTIC_SEEDS["gpu-h100"]()
    tpu = predictor.tpu_v5e_weights()

    print(fit.interpretation_report())
    print()
    print(f"{'property':<44} {'fit':>12} {'h100 seed':>12} "
          f"{'v5e seed (TPU)':>15}")
    h_w = dict(zip(h100.keys, map(float, h100.weights)))
    t_w = dict(zip(tpu.keys, map(float, tpu.weights)))
    fmt = lambda v: f"{'None':>12}" if v is None else format(v, "12.3e")
    for k, w in sorted(zip(fit.keys, fit.weights), key=lambda kw: -abs(kw[1])):
        print(f"{k:<44} {w:12.3e} {fmt(h_w.get(k))} "
              f"{fmt(t_w.get(k)):>15}")
    result = {"device": fit.device,
              "fit": dict(zip(fit.keys, map(float, fit.weights))),
              "gpu_h100_seed": h_w, "tpu_v5e_seed": t_w}
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, "torch_paper_table2.json"), "w") as f:
        json.dump(result, f, indent=1)
    return result


if __name__ == "__main__":
    main()
