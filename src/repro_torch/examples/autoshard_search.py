"""Cost-model-driven plan search + heterogeneous load balancing — the
paper's §6.1/§6.2 applications, realized (the counterpart of the
reference's ``examples/autoshard_search.py``).

    PYTHONPATH=src python -m repro_torch.examples.autoshard_search

1. For three representative (arch × shape) cells, sweep the Plan space and
   rank it: thousands of predictions in milliseconds (the paper's 'rapid
   evaluation' claim at framework scale); then every mesh factorization
   of 1024 devices.
2. Schedule a mixed workload queue across two pools by predicted step
   times (load balancing).
3. Simulate a 5-node failure and re-plan (elastic).

Everything is ranked under the card's cost model, ``gpu-h100`` (a fitted
model in the registry, else the H100 datasheet seed), where the reference
ranks under the v5e analytic model; the step programs compose the card's
CUDA kernels, and the load balancing sizes its plans for an H100's 80 GB.
``run(model="tpu-v5e", kernels=kernelmodel.PALLAS_KERNELS,
hbm_budget=16e9)`` gives the reference's rankings and picks.  Host only.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

from repro_torch.configs.base import SHAPES
from repro_torch.configs.registry import ARCHS
from repro_torch.core import predictor
from repro_torch.distributed import elastic
from repro_torch.distributed.plan import H100_HBM_BYTES, plan_for
from repro_torch.kernels.ops import CARD_MODEL
from repro_torch.launch import autoshard

CELLS = (("glm4-9b", "train_4k"), ("mixtral-8x22b", "train_4k"),
         ("llama3-405b", "prefill_32k"))
POOLS = {"pod-A": {"data": 16, "model": 16},
         "pod-B": {"data": 8, "model": 8}}
QUEUE = (("smollm-360m", "train_4k"), ("glm4-9b", "prefill_32k"),
         ("mixtral-8x7b", "decode_32k"), ("mamba2-370m", "train_4k"))


def run(model: predictor.ModelLike = CARD_MODEL, kernels=None,
        hbm_budget: float = H100_HBM_BYTES) -> dict:
    model = predictor.resolve_model(model)
    out = {"model": model.device, "search": {}}
    print(f"cost model: {model.device} "
          f"({model.meta.get('source', 'unknown')})")

    # 1 — plan search ------------------------------------------------------
    for arch, shape in CELLS:
        t0 = time.perf_counter()
        plans = autoshard.candidate_plans(ARCHS[arch], SHAPES[shape])
        ranked = autoshard.search(arch, shape, top_k=3, model=model,
                                  kernels=kernels)
        dt = time.perf_counter() - t0
        print(f"\n{arch} × {shape}: ranked {len(plans)} plans "
              f"in {dt*1e3:.0f} ms")
        for t, p, mesh in ranked:
            print(f"  {t*1e3:9.2f} ms/step  fsdp={p.fsdp} "
                  f"mb={p.microbatches} remat={p.remat_policy} "
                  f"comp={p.compression}")
        out["search"][f"{arch}:{shape}"] = [
            (t, dataclasses.asdict(p), dict(mesh)) for t, p, mesh in ranked]

    # 1b — mesh-factorization sweep (the batched engine makes it cheap) ----
    t0 = time.perf_counter()
    swept = autoshard.search("glm4-9b", "train_4k", n_devices=1024,
                             top_k=3, model=model, kernels=kernels)
    dt = time.perf_counter() - t0
    print(f"\nglm4-9b × train_4k over every 1024-device mesh "
          f"factorization ({dt*1e3:.0f} ms):")
    for t, p, mesh in swept:
        print(f"  {t*1e3:9.2f} ms/step  mesh={mesh} fsdp={p.fsdp} "
              f"mb={p.microbatches} remat={p.remat_policy}")
    out["sweep_1024"] = [(t, dataclasses.asdict(p), dict(mesh))
                         for t, p, mesh in swept]

    # 2 — load balancing across two pools ----------------------------------
    print("\nload balancing a mixed queue over pod-A (16×16) and "
          "pod-B (8×8):")
    loads = {k: 0.0 for k in POOLS}
    out["balance"] = []
    for arch, shape in QUEUE:
        cfg, shp = ARCHS[arch], SHAPES[shape]
        best, best_pool, step_s = None, None, {}
        for pool, mesh in POOLS.items():
            p = plan_for(cfg, shp, tp_size=mesh["model"],
                         hbm_budget=hbm_budget)
            t = step_s[pool] = predictor.predict_step(
                cfg, shp, p, mesh, model, kernels=kernels).seconds
            finish = loads[pool] + t
            if best is None or finish < best:
                best, best_pool = finish, pool
        loads[best_pool] = best
        print(f"  {arch:>14} × {shape:<12} -> {best_pool} "
              f"(finishes at {best*1e3:.1f} ms)")
        out["balance"].append({"arch": arch, "shape": shape,
                               "pool": best_pool, "finish_s": best,
                               "step_s": step_s})

    # 3 — elastic re-plan after failure ------------------------------------
    print("\nelastic: glm4-9b train, 256 devices, 5 fail:")
    opt = elastic.on_failure(ARCHS["glm4-9b"], SHAPES["train_4k"],
                             prev_devices=256, lost=5, weights=model,
                             kernels=kernels)
    print(f"  new mesh {opt.shape}, predicted step "
          f"{opt.predicted_step_s*1e3:.1f} ms")
    out["elastic"] = {"mesh": dict(opt.shape),
                      "predicted_step_s": opt.predicted_step_s}
    return out


def main(argv=None) -> dict:
    argparse.ArgumentParser(
        description=__doc__.split("\n\n")[0]).parse_args(argv)
    return run()


if __name__ == "__main__":
    main()
