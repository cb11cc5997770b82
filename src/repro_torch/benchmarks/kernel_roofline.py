"""What the hand-written ``flash_attention`` kernel does to the roofline of
an attention-heavy cell, on the H100 (the counterpart of the reference's
``benchmarks/kernel_roofline.py``).

Method (a dry run on a fake world, no card needed):
  1. price the cell with the plain chunked attention dispatching
     (``runtime.flags.use_kernels(False)``; the reference's XLA path)
     -> full per-rank costs;
  2. price it with attention stubbed (``flags.stub_attention``) -> base;
  3. attention-attributable costs = (1) − (2);
  4. the kernel path's attention from first principles and the CUDA
     kernel's schedule (``kernels/flash_attention.schedule_props``) at the
     blocks ``autotune.best_block_sizes`` picks through ``gpu-h100``: q, k,
     v and o stream HBM once, the score tiles live on chip.

There is no VMEM on the card.  The kernel's on-chip loads (shared memory)
are priced through the ``gpu-h100`` analytic seed's weight for
``local:16:load`` (``calibration/seeds.py``: HBM rate × its
``local_bw_mult``), where the reference divides by "VMEM ≈ 20× HBM"; the
record's ``smem`` entries stand where the reference's ``vmem`` ones are.
The rates are the ``gpu-h100`` datasheet's (989e12 bf16 flop/s, 3.35e12
B/s HBM3, 450e9 B/s NVLink a direction), never a v5e's.

The plain path is priced as it runs on one rank (``extract_step``): the
chunk pairs that causal masking skips are not counted, and under context
parallelism rank 0 holds the first q-slice, the least work.  The
reference's rollup of its partitioned program counts every pair (the
skipped branch of its ``lax.cond`` too), so on a chunked cell its
attention-attributable share is larger by the skipped pairs.

One fake world per process: run this in a process of its own.

    PYTHONPATH=src python -m repro_torch.benchmarks.kernel_roofline \\
        --arch glm4-9b --shape prefill_32k
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
from typing import Dict, Optional, Sequence

from repro_torch.calibration import seeds
from repro_torch.configs.base import SHAPES
from repro_torch.configs.registry import ARCHS
from repro_torch.distributed.plan import H100_HBM_BYTES, plan_for
from repro_torch.kernels import autotune
from repro_torch.kernels import flash_attention as fa
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as lmesh
from repro_torch.runtime import flags

H100 = seeds.GPU_DATASHEETS["gpu-h100"]
PEAK = H100.matmul_flops[16]
HBM = H100.mem_bw
LINK = H100.link_bw
OUT_DIR = "experiments"


def _terms(flops: float, nbytes: float, coll: Dict[str, float]) -> Dict:
    return {"compute": flops / PEAK, "memory": nbytes / HBM,
            "collective": sum(coll.values()) / LINK}


def analyse(arch: str = "glm4-9b", shape_name: str = "prefill_32k", *,
            device: str = dryrun.STANDIN_DEVICE,
            mesh_shape: Optional[Sequence[int]] = None,
            n_layers: Optional[int] = None, seq_len: Optional[int] = None,
            out: str = OUT_DIR, verbose: bool = True) -> Dict:
    """The record of one cell.  ``mesh_shape`` (data, model) prices it on a
    fake world of that size instead of the production (16, 16);
    ``n_layers`` cuts its depth and ``seq_len`` its sequence (small cells
    on the CPU)."""
    cfg, shape = ARCHS[arch], SHAPES[shape_name]
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    if seq_len is not None:
        shape = dataclasses.replace(shape, seq_len=seq_len)
    if mesh_shape is None:
        mesh = lmesh.make_fake_production_mesh(device=device)
    else:
        lmesh.init_fake_world(mesh_shape[0] * mesh_shape[1])
        mesh = lmesh.make_mesh(tuple(mesh_shape), ("data", "model"),
                               device=device)
    tp = mesh.shape[1]
    plan = plan_for(cfg, shape, tp_size=tp, hbm_budget=H100_HBM_BYTES)
    n_dev = mesh.size()

    with flags.use_kernels(False):
        full = dryrun.price_cell(cfg, shape, mesh, plan)
        with flags.stub_attention():
            base = dryrun.price_cell(cfg, shape, mesh, plan)
    attn_flops = max(full.flops - base.flops, 0.0)
    attn_bytes = max(full.bytes_accessed - base.bytes_accessed, 0.0)

    # ---- the kernel path (per rank) -------------------------------------
    B, S = shape.global_batch, shape.seq_len
    H, KVH, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    n_attn = (cfg.n_layers // cfg.hybrid.attn_every
              if cfg.family == "hybrid" else cfg.n_layers)
    train = shape.kind == "train"
    # fwd + flash bwd ≈ 3 passes (bwd reads q, k, v, o, do; writes dq, dk,
    # dv)
    passes = 3.0 if train else 1.0
    bytes_elem = 2   # bf16 streams
    hbm_stream = (B * S * (2 * H + 4 * KVH) * dh * bytes_elem) * n_attn \
        * passes / n_dev
    blocks = autotune.best_block_sizes("flash_attention", {
        "B": B, "H": H, "KVH": KVH, "Sq": S, "Skv": S, "dh": dh,
        "causal": True, "window": cfg.sliding_window, "bits": 16},
        model="gpu-h100")
    props = fa.schedule_props(B, H, KVH, S, S, dh, causal=True,
                              window=cfg.sliding_window,
                              block_q=blocks["block_q"],
                              block_k=blocks["block_k"])
    kernel_flops = props["mxu:16"] * n_attn * (2.5 if train else 1.0) / n_dev
    smem_loads = props.get("local:16:load", 0.0) * n_attn * passes / n_dev
    seed_w = dict(zip(*_seed_weights()))
    smem_s = smem_loads * seed_w["local:16:load"]

    t_plain = _terms(full.flops, full.bytes_accessed, full.collective_bytes)
    t_kernel = _terms(base.flops + kernel_flops,
                      base.bytes_accessed + hbm_stream,
                      full.collective_bytes)
    t_kernel["smem"] = smem_s

    rec = {
        "arch": arch, "shape": shape_name, "n_devices": int(n_dev),
        "n_layers": cfg.n_layers, "rates": {"peak_bf16": PEAK, "hbm": HBM,
                                            "link": LINK},
        "autotuned_blocks": blocks,
        "attention_attributable": {"flops": attn_flops, "bytes": attn_bytes},
        "kernel_attention": {"flops": kernel_flops, "hbm_bytes": hbm_stream,
                             "smem_bytes": smem_loads * bytes_elem},
        "xla_terms_s": t_plain,
        "kernel_terms_s": t_kernel,
        "xla_dominant": max(t_plain, key=t_plain.get),
        "kernel_dominant": max(t_kernel, key=t_kernel.get),
        "memory_term_reduction":
            (t_plain["memory"] - t_kernel["memory"]) / t_plain["memory"]
            if t_plain["memory"] else 0.0,
        "step_bound_xla_s": max(t_plain.values()),
        "step_bound_kernel_s": max(t_kernel.values()),
    }
    if verbose:
        print(json.dumps(rec, indent=1))
        print(f"\nplain path : compute {t_plain['compute'] * 1e3:9.1f} ms | "
              f"memory {t_plain['memory'] * 1e3:9.1f} ms | "
              f"coll {t_plain['collective'] * 1e3:7.1f} ms  -> bound "
              f"{rec['step_bound_xla_s'] * 1e3:.1f} ms "
              f"({rec['xla_dominant']})")
        print(f"kernel path: compute {t_kernel['compute'] * 1e3:9.1f} ms | "
              f"memory {t_kernel['memory'] * 1e3:9.1f} ms | "
              f"coll {t_kernel['collective'] * 1e3:7.1f} ms | "
              f"smem {smem_s * 1e3:7.1f} ms -> bound "
              f"{rec['step_bound_kernel_s'] * 1e3:.1f} ms "
              f"({rec['kernel_dominant']})")
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(
            out, f"torch_kernel_roofline_{arch}_{shape_name}.json"),
            "w") as f:
        json.dump(rec, f, indent=1)
    return rec


def _seed_weights():
    m = seeds.ANALYTIC_SEEDS["gpu-h100"]()
    return m.keys, [float(w) for w in m.weights]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="glm4-9b")
    ap.add_argument("--shape", default="prefill_32k")
    ap.add_argument("--device", default=dryrun.STANDIN_DEVICE,
                    help="where the fake stand-ins live (default: cuda "
                         "where this PyTorch is built with it)")
    ap.add_argument("--mesh", default=None,
                    help="data,model ranks of a smaller fake world "
                         "(default: the production 16,16)")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the depth to this many layers")
    ap.add_argument("--seq", type=int, default=None,
                    help="cut the sequence to this many tokens")
    ap.add_argument("--out", default=OUT_DIR)
    a = ap.parse_args(argv)
    mesh = tuple(int(x) for x in a.mesh.split(",")) if a.mesh else None
    analyse(a.arch, a.shape, device=a.device, mesh_shape=mesh,
            n_layers=a.layers, seq_len=a.seq, out=a.out)


if __name__ == "__main__":
    main()
