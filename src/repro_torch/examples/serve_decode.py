"""Batched serving example: a continuous-batching decode server on a
reduced GLM-4-family model, with cost-model-predicted per-token latency and
model-informed admission (``admission="model"``): each refill decision is
scored through the fused decode/prefill basis programs and prints an
``[admit] … policy=model`` line (the counterpart of the reference's
``examples/serve_decode.py``).

    PYTHONPATH=src python -m repro_torch.examples.serve_decode \\
        [--device cpu] [--trace-json PATH] [--metrics-json PATH]

Every prediction is under the card's cost model, ``gpu-h100`` (a fitted
model in the registry, else the H100 datasheet seed): the full glm4-9b's
decode step on a 16 × 16 mesh of H100s, the admission scorer and the
simulated policies.  The server feeds prompts token by token, as the
reference's does, and its decode launches no hand-written kernel.

Deviation: the server's cache holds 256 rows where the reference's holds
128.  Every fed token advances the one position all slots share, so these
ten requests pass row 128; the reference clamps those writes onto its last
row, the port raises on a write beyond the cache.
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.configs.base import SHAPES
from repro_torch.configs.registry import get_arch
from repro_torch.core import predictor
from repro_torch.core.workload import WorkloadSpec
from repro_torch.distributed.plan import plan_for
from repro_torch.examples import add_device_arg, device, sync
from repro_torch.kernels.ops import CARD_MODEL
from repro_torch.models import transformer
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace
from repro_torch.runtime.server import DecodeServer, Request, simulate_serving

MESH = {"data": 16, "model": 16}
PROMPTS = [24, 20, 4, 5, 4, 6, 5, 4, 6, 5]
MAX_LEN = 256


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    add_device_arg(ap)
    ap.add_argument("--trace-json", default=None,
                    help="write a Chrome-trace/Perfetto JSON of the serve "
                         "run (prefill/decode spans + predicted overlay)")
    ap.add_argument("--metrics-json", default=None,
                    help="dump the metrics registry as JSON at exit")
    args = ap.parse_args(argv)
    dev = device(args.device)
    if args.trace_json:
        obs_trace.enable(process_name="serve_decode")

    cfg = get_arch("glm4-9b").reduced()
    model = transformer.init_params(cfg, device=dev, seed=0)
    server = DecodeServer(cfg, model, slots=4, max_len=MAX_LEN, seed=0,
                          admission="model", cost_model=CARD_MODEL,
                          device=dev)

    # cost-model prediction for the FULL arch on a 16x16 mesh — what this
    # decode step would cost on 256 H100s
    full = get_arch("glm4-9b")
    shape = SHAPES["decode_32k"]
    plan = plan_for(full, shape)
    pred = predictor.predict_step(full, shape, plan, MESH, CARD_MODEL)
    dominant = max(pred.terms, key=pred.terms.get)
    print(f"[serve] full glm4-9b decode_32k on 16x16 H100 ({CARD_MODEL}): "
          f"predicted {pred.seconds*1e3:.2f} ms/token/batch "
          f"(dominant: {dominant})")

    # occupancy-refined spec: the same fused program rescored at half-full
    # slots / half context — the refinement the admission scorer sweeps
    half = WorkloadSpec(phase="decode", global_batch=shape.global_batch,
                        seq_len=shape.seq_len,
                        active_slots=shape.global_batch // 2,
                        cache_tokens=shape.global_batch * shape.seq_len / 2)
    pred_half = predictor.predict_step(full, half, plan, MESH, CARD_MODEL)
    print(f"[serve] same cell at 50% slot occupancy / context: "
          f"{pred_half.seconds*1e3:.2f} ms/token/batch")

    # mixed prompt lengths, LONG ones first — the adversarial arrival order
    # for FIFO admission; the model policy reorders by predicted cost
    rng = np.random.default_rng(0)
    for rid, plen in enumerate(PROMPTS):
        server.submit(Request(
            rid=rid,
            prompt=rng.integers(2, cfg.vocab_size, plen).astype(np.int32),
            max_new=16))

    t0 = time.perf_counter()
    done = server.run()
    sync(dev)
    dt = time.perf_counter() - t0
    toks = sum(len(r.out) for r in done)
    print(f"[serve] reduced model on {dev}: {len(done)} requests, "
          f"{toks} tokens in {dt:.2f}s ({toks/max(dt, 1e-9):.1f} tok/s)")
    assert len(done) == len(PROMPTS) and all(len(r.out) >= 1 for r in done)
    for r in done[:3]:
        print(f"  req {r.rid}: {len(r.prompt)}-token prompt -> "
              f"{len(r.out)} new tokens")

    # the policies compared under the model's own physics (full arch)
    sims = {p: simulate_serving(full, [2048, 1024] + [16] * 8, 32, slots=4,
                                max_len=4096, policy=p, model=CARD_MODEL)
            for p in ("model", "fifo")}
    m_s, f_s = (sims[p]["mean_latency_s"] for p in ("model", "fifo"))
    print(f"[serve] simulated mean latency (model admission): "
          f"{m_s*1e3:.2f} ms vs fifo {f_s*1e3:.2f} ms "
          f"({f_s/max(m_s, 1e-12):.2f}x)")

    if args.trace_json:
        tracer = obs_trace.get_tracer()
        for line in tracer.report_lines():
            print(f"[trace] {line}")
        tracer.save(args.trace_json)
        print(f"[example] trace written to {args.trace_json}")
    if args.metrics_json:
        obs_metrics.REGISTRY.save_json(args.metrics_json)
        print(f"[example] metrics written to {args.metrics_json}")
    return {"device": str(dev), "predicted_s": pred.seconds,
            "dominant": dominant, "predicted_half_s": pred_half.seconds,
            "requests": len(done), "tokens": toks, "seconds": dt,
            "tok_per_s": toks / max(dt, 1e-9),
            "order": [r.rid for r in done],
            "simulated_mean_latency_s": {"model": m_s, "fifo": f_s}}


if __name__ == "__main__":
    main()
