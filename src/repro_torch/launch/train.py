"""Training launcher.

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-3b \
        --steps 3 --batch 2 --seq 4096
    PYTHONPATH=src python -m repro_torch.launch.train --arch zamba2-2.7b \
        --reduced --device cpu --steps 3 --batch 2 --seq 64 --ckpt /tmp/ck

Trains the dense, moe, audio, ssm and hybrid families with each
configuration's optimizer and remat policy on the synthetic packed corpus.
The vision-language family (qwen2-vl-7b) needs vision embeddings, which the
packed corpus does not make, and fails on its first batch, as in the
reference.  Runs on the GPU unless ``--device cpu`` is given;
weights are random, made on the device from ``--seed``.  The reference's
supervise / fault-plan / online-calibration options and its predicted-step
print arrive with their modules (ROADMAP A10, A13).
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.configs.registry import ARCHS, get_arch
from repro_torch.data.pipeline import DataConfig
from repro_torch.obs import metrics as _obs_metrics
from repro_torch.obs import trace as _obs_trace
from repro_torch.runtime.trainer import Trainer, TrainerConfig


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", required=True, choices=sorted(ARCHS))
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--reduced", action="store_true",
                    help="train the reduced same-family config (CPU scale)")
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--trace-json", default=None, metavar="PATH",
                    help="write a Chrome-trace/Perfetto JSON of the run "
                         "(train_step spans)")
    ap.add_argument("--metrics-json", default=None, metavar="PATH",
                    help="dump the metrics registry as JSON on exit")
    args = ap.parse_args(argv)

    if args.trace_json:
        _obs_trace.enable(process_name="train")

    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                    global_batch=args.batch, seed=args.seed,
                    n_codebooks=cfg.n_input_codebooks)
    tc = TrainerConfig(ckpt_dir=args.ckpt, ckpt_every=args.ckpt_every,
                       lr=args.lr, total_steps=args.steps, seed=args.seed)
    trainer = Trainer(cfg, dc, tc, device=args.device)
    where = torch.cuda.get_device_name(0) if args.device == "cuda" \
        else "cpu"
    print(f"[train] {cfg.name}: {cfg.n_params()/1e6:.1f}M params, "
          f"optimizer {cfg.optimizer}, remat {cfg.remat_policy}, "
          f"device={where}")
    hist = trainer.train(args.steps)
    print(f"[train] done: loss {hist[0]['loss']:.4f} -> "
          f"{hist[-1]['loss']:.4f}")

    tracer = _obs_trace.get_tracer()
    if args.trace_json:
        for line in tracer.report_lines():
            print(f"[trace] {line}")
        tracer.save(args.trace_json)
        print(f"[train] trace written to {args.trace_json}")
    if args.metrics_json:
        _obs_metrics.REGISTRY.save_json(args.metrics_json)
        print(f"[train] metrics written to {args.metrics_json}")


if __name__ == "__main__":
    main()
