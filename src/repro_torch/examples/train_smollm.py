"""End-to-end training driver: a ~100M-parameter SmolLM-family model
trained for a few hundred steps on the synthetic corpus, with async
checkpointing, kill-and-resume, and the online calibrator (the counterpart
of the reference's ``examples/train_smollm.py``).

    PYTHONPATH=src python -m repro_torch.examples.train_smollm \\
        [--steps 300] [--device cpu] [--resume] [--full]

The config is a width/depth-reduced SmolLM (still the same family:
GQA + RoPE + SwiGLU + tied embeddings); ``--full`` trains the whole
smollm-360m, which fits one H100.  The loss runs the hand-written
``flash_attention`` kernel inside the attention's autograd Function on the
card.  The loss must fall over the run.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import shutil

from repro_torch.configs.registry import get_arch
from repro_torch.data.pipeline import DataConfig
from repro_torch.examples import add_device_arg, device
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace
from repro_torch.runtime.trainer import Trainer, TrainerConfig

CKPT = "/tmp/repro_torch_smollm_ckpt"


def hundred_m_config():
    """~100M-param SmolLM-family config that trains in minutes."""
    base = get_arch("smollm-360m")
    return dataclasses.replace(
        base, name="smollm-100m", n_layers=6, d_model=512, n_heads=8,
        n_kv_heads=4, head_dim=64, d_ff=1536, vocab_size=49152,
        remat_policy="none",
    )


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    add_device_arg(ap)
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--ckpt", default=CKPT)
    ap.add_argument("--resume", action="store_true",
                    help="keep existing checkpoints (kill-and-resume demo)")
    ap.add_argument("--full", action="store_true",
                    help="train the full 360M config")
    ap.add_argument("--online-calibrate", action="store_true",
                    help="stream step timings into the online calibrator "
                         "(RLS refit + drift watch)")
    ap.add_argument("--telemetry-json", default=None,
                    help="write the telemetry ring buffer to this JSON "
                         "file at exit (requires --online-calibrate)")
    ap.add_argument("--trace-json", default=None,
                    help="write a Chrome-trace/Perfetto JSON of the run "
                         "(measured step spans + predicted overlay)")
    ap.add_argument("--metrics-json", default=None,
                    help="dump the metrics registry as JSON at exit")
    args = ap.parse_args(argv)
    dev = device(args.device)
    if args.trace_json:
        obs_trace.enable(process_name="train_smollm")

    cfg = get_arch("smollm-360m") if args.full else hundred_m_config()
    print(f"[example] {cfg.name}: {cfg.n_params()/1e6:.1f}M params on {dev}")

    if not args.resume and os.path.isdir(args.ckpt):
        shutil.rmtree(args.ckpt)

    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                    global_batch=args.batch, seed=11)
    tc = TrainerConfig(ckpt_dir=args.ckpt, ckpt_every=100, log_every=20,
                       lr=1e-3, warmup=30, total_steps=args.steps,
                       online_calibrate=args.online_calibrate,
                       calib_device=f"{cfg.name}-online")
    trainer = Trainer(cfg, dc, tc, device=dev)
    start = trainer.step
    hist = trainer.train(args.steps - start)

    first, last = hist[0], hist[-1]
    print(f"\n[example] steps {first['step']}..{last['step']}: "
          f"loss {first['loss']:.4f} -> {last['loss']:.4f}")
    assert last["loss"] < first["loss"], "loss must decrease"
    print(f"[example] checkpoints in {args.ckpt}: resume with --resume")

    if trainer.calibrator is not None:
        print("[calib] refit report:")
        print(trainer.calibrator.final_report())
        if args.telemetry_json:
            trainer.calibrator.sink.save(args.telemetry_json)
            print(f"[calib] telemetry saved to {args.telemetry_json} "
                  f"({len(trainer.calibrator.sink)} samples buffered)")

    if args.trace_json:
        tracer = obs_trace.get_tracer()
        for line in tracer.report_lines():
            print(f"[trace] {line}")
        tracer.save(args.trace_json)
        print(f"[example] trace written to {args.trace_json}")
    if args.metrics_json:
        obs_metrics.REGISTRY.save_json(args.metrics_json)
        print(f"[example] metrics written to {args.metrics_json}")
    return {"arch": cfg.name, "params": cfg.n_params(), "device": str(dev),
            "start": start, "end": trainer.step,
            "first_loss": first["loss"], "last_loss": last["loss"],
            "step_s": [m["time_s"] for m in hist]}


if __name__ == "__main__":
    main()
