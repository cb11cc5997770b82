"""Training launcher.

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-3b \
        --steps 3 --batch 2 --seq 4096
    PYTHONPATH=src python -m repro_torch.launch.train --arch zamba2-2.7b \
        --reduced --device cpu --steps 3 --batch 2 --seq 64 --ckpt /tmp/ck
    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m \
        --reduced --device cpu --steps 6 --batch 2 --seq 64 --ckpt /tmp/ck \
        --online-calibrate --fault-plan 'device_loss@3;slowdown@1'

Trains the dense, moe, audio, ssm and hybrid families with each
configuration's optimizer and remat policy on the synthetic packed corpus.
The vision-language family (qwen2-vl-7b) needs vision embeddings, which the
packed corpus does not make, and fails on its first batch, as in the
reference.  Runs on the GPU unless ``--device cpu`` is given;
weights are random, made on the device from ``--seed``.

Before training it prints the cost model's predicted step time of the full
architecture (not the ``--reduced`` one) at ``--batch`` × ``--seq`` on one
H100, priced by the registry name ``gpu-h100``: a model fitted on the card
(``python -m repro_torch.calibration --device gpu-h100``, in
``$REPRO_MODEL_REGISTRY`` or ``experiments/registry``) shadows the analytic
datasheet seed, and the line names which of the two priced it.  As in the
reference, the prediction is printed only and does not feed the trainer.

``--online-calibrate`` streams each step's synchronized wall time into an
``OnlineCalibrator`` (RLS refit + drift watch; ``--calib-device`` names the
refit models, ``--calib-auto-register`` writes them into the registry).
``--supervise`` (implied by ``--fault-plan``) trains under the
``Supervisor``: watchdog deadlines, backoff, elastic replan and checkpoint
resume on device loss.  ``--devices N`` is the fleet size the replan prices
meshes over (with ``--model``'s cost model from ``--registry``, ``gpu-h100``
when ``--model`` is not given); the run itself stays on one card: training
across several cards waits for the multi-device slice.  A
``corrupt_registry`` fault damages the registry file of the ``--model`` the
user gave; without ``--model`` it has no target and damages nothing, as in
the reference.
"""
from __future__ import annotations

import argparse
import dataclasses

import torch

from repro_torch.configs.base import SHAPES
from repro_torch.configs.registry import ARCHS, get_arch
from repro_torch.core import predictor
from repro_torch.data.pipeline import DataConfig
from repro_torch.obs import metrics as _obs_metrics
from repro_torch.obs import trace as _obs_trace
from repro_torch.distributed.plan import plan_for
from repro_torch.runtime.trainer import Trainer, TrainerConfig

#: the registry name that prices the predicted step
PREDICT_MODEL = "gpu-h100"


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
    ap.add_argument("--online-calibrate", action="store_true",
                    help="stream per-step timings into the online "
                         "calibrator (RLS refit + drift watch)")
    ap.add_argument("--calib-device", default=None,
                    help="registry device name for online refits "
                         "(default: '<arch>-online')")
    ap.add_argument("--calib-auto-register", action="store_true",
                    help="write drift-refit models into the registry "
                         "(bumps the model file revision)")
    ap.add_argument("--trace-json", default=None, metavar="PATH",
                    help="write a Chrome-trace/Perfetto JSON of the run "
                         "(train_step spans)")
    ap.add_argument("--metrics-json", default=None, metavar="PATH",
                    help="dump the metrics registry as JSON on exit")
    # --- supervised recovery / chaos (runtime/supervisor.py, faults.py) ---
    ap.add_argument("--supervise", action="store_true",
                    help="run under the Supervisor: watchdog deadlines, "
                         "backoff, elastic replan + checkpoint-resume on "
                         "device loss")
    ap.add_argument("--fault-plan", default=None, metavar="SPEC|PATH",
                    help="deterministic fault schedule — "
                         "'kind@step[:k=v,..];..' (e.g. "
                         "'corrupt_registry@7;device_loss@12') or a JSON "
                         "plan path; implies --supervise")
    ap.add_argument("--chaos-seed", type=int, default=0,
                    help="seed for fault payloads and backoff jitter")
    ap.add_argument("--devices", type=int, default=1,
                    help="fleet size the supervisor replans over")
    ap.add_argument("--model", default=None, metavar="DEVICE",
                    help="cost-model device name pricing the replan "
                         "candidates (hardened registry lookup; unset: the "
                         "card's, gpu-h100) and the target of a "
                         "corrupt_registry fault (unset: none)")
    ap.add_argument("--registry", default=None, metavar="DIR",
                    help="model-registry directory override")
    ap.add_argument("--watchdog-k", type=float, default=6.0,
                    help="watchdog deadline = k x max(predicted, median)")
    ap.add_argument("--max-recoveries", type=int, default=8)
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
                       lr=args.lr, total_steps=args.steps, seed=args.seed,
                       online_calibrate=args.online_calibrate,
                       calib_device=args.calib_device,
                       calib_auto_register=args.calib_auto_register)
    # the cost model's prediction of the full architecture's step
    shape = dataclasses.replace(SHAPES["train_4k"], seq_len=args.seq,
                                global_batch=args.batch)
    plan = plan_for(ARCHS[args.arch], SHAPES["train_4k"])
    model = predictor.resolve_model(PREDICT_MODEL)
    pred = predictor.predict_step(ARCHS[args.arch], shape, plan,
                                  {"data": 1, "model": 1}, model)
    print(f"[train] {ARCHS[args.arch].name}: predicted full-arch step "
          f"{pred.seconds*1e3:.1f}ms on 1 chip (model {model.device}, "
          f"source {model.meta.get('source', 'unknown')})")

    where = torch.cuda.get_device_name(0) if args.device == "cuda" \
        else "cpu"
    print(f"[train] {cfg.name}: {cfg.n_params()/1e6:.1f}M params, "
          f"optimizer {cfg.optimizer}, remat {cfg.remat_policy}, "
          f"device={where}")
    if args.supervise or args.fault_plan:
        from repro_torch.core.workload import WorkloadSpec
        from repro_torch.runtime.faults import FaultInjector, FaultPlan
        from repro_torch.runtime.supervisor import BackoffPolicy, Supervisor

        fplan = FaultPlan.parse(args.fault_plan, seed=args.chaos_seed) \
            if args.fault_plan else FaultPlan(seed=args.chaos_seed)
        injector = FaultInjector(fplan, ckpt_dir=args.ckpt,
                                 registry_dir=args.registry,
                                 registry_device=args.model)
        if fplan:
            print(f"[train] fault plan armed: {fplan.describe()}")
        workload = WorkloadSpec(phase="train", global_batch=args.batch,
                                seq_len=args.seq, name="train_live")
        sup = Supervisor(
            lambda mesh: Trainer(cfg, dc, tc, injector=injector,
                                 device=args.device),
            args.steps, cfg=ARCHS[args.arch], workload=workload,
            n_devices=args.devices, model=args.model or PREDICT_MODEL,
            registry_dir=args.registry, injector=injector,
            watchdog_k=args.watchdog_k,
            backoff=BackoffPolicy(seed=args.chaos_seed),
            max_recoveries=args.max_recoveries)
        hist = sup.run()
        sup.report()
        trainer = sup.trainer
    else:
        trainer = Trainer(cfg, dc, tc, device=args.device)
        hist = trainer.train(args.steps)
    print(f"[train] done: loss {hist[0]['loss']:.4f} -> "
          f"{hist[-1]['loss']:.4f}")
    if trainer.calibrator is not None:
        print("[calib] refit report:")
        print(trainer.calibrator.final_report())

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
