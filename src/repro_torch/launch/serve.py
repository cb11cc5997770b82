"""Serving launcher: batched decode with continuous slot refill.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-3b \
        --requests 8 --max-new 24
    PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-2.7b \
        --reduced --device cpu

Serves the dense (llama3.2-3b, smollm-360m, ...), moe (mixtral-8x7b,
mixtral-8x22b), vision-language (qwen2-vl-7b, text only), ssm (mamba2-370m)
and hybrid (zamba2-2.7b) families.  The audio family (musicgen-medium, four
codebooks) raises ``NotImplementedError``: the server serves one codebook, as
the reference's does.

Runs on the GPU unless ``--device cpu`` is given; weights are random, made on
the device from ``--seed``.  The supervise / fault-plan / SLO options of the
reference arrive with their modules.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs.registry import ARCHS, get_arch
from repro_torch.models import transformer
from repro_torch.obs import metrics as _obs_metrics
from repro_torch.obs import trace as _obs_trace
from repro_torch.runtime.server import DecodeServer, Request


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", required=True, choices=sorted(ARCHS))
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=24)
    ap.add_argument("--max-len", type=int, default=256)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--trace-json", default=None, metavar="PATH",
                    help="write a Chrome-trace/Perfetto JSON of the serve "
                         "run (prefill/decode spans)")
    ap.add_argument("--metrics-json", default=None, metavar="PATH",
                    help="dump the metrics registry as JSON on exit")
    args = ap.parse_args(argv)

    if args.trace_json:
        _obs_trace.enable(process_name="serve")

    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    model = transformer.init_params(cfg, device=args.device, seed=args.seed)
    server = DecodeServer(cfg, model, slots=args.slots,
                          max_len=args.max_len, seed=args.seed,
                          device=args.device)

    rng = np.random.default_rng(args.seed)
    for rid in range(args.requests):
        plen = int(rng.integers(4, 17))
        prompt = rng.integers(2, cfg.vocab_size, size=plen).astype(np.int32)
        server.submit(Request(rid=rid, prompt=prompt, max_new=args.max_new))

    t0 = time.perf_counter()
    done = server.run()
    dt = time.perf_counter() - t0
    toks = sum(len(r.out) for r in done)
    where = torch.cuda.get_device_name(0) if args.device == "cuda" else "cpu"
    print(f"[serve] {len(done)} requests, {toks} tokens in {dt:.2f}s "
          f"({toks/dt:.1f} tok/s, slots={args.slots}, device={where})")
    for r in done[:3]:
        print(f"  req {r.rid}: prompt[:6]={r.prompt[:6].tolist()} "
              f"out[:8]={r.out[:8]}")

    tracer = _obs_trace.get_tracer()
    if args.trace_json:
        for line in tracer.report_lines():
            print(f"[trace] {line}")
        tracer.save(args.trace_json)
        print(f"[serve] trace written to {args.trace_json}")
    if args.metrics_json:
        _obs_metrics.REGISTRY.save_json(args.metrics_json)
        print(f"[serve] metrics written to {args.metrics_json}")


if __name__ == "__main__":
    main()
