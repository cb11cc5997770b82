"""Fault-tolerance walkthrough: train, 'crash', resume exactly; then a
straggler appears and is mitigated; finally the whole loop runs under the
Supervisor with an injected device loss (the counterpart of the
reference's ``examples/fault_tolerance.py``).

    PYTHONPATH=src python -m repro_torch.examples.fault_tolerance \\
        [--device cpu]

The replayed and the supervised losses must equal the first run's at rtol
1e-5, which on the card needs every op of the step to give the same
result run to run.  The Supervisor replans the mesh over the survivors
under the card's cost model, ``gpu-h100``.  Checkpoints go under
``/tmp/repro_torch_ft_*``.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import shutil

import numpy as np

from repro_torch.configs.registry import get_arch
from repro_torch.core.workload import WorkloadSpec
from repro_torch.data.pipeline import DataConfig
from repro_torch.examples import add_device_arg, device
from repro_torch.kernels.ops import CARD_MODEL
from repro_torch.runtime.faults import Fault, FaultInjector, FaultPlan
from repro_torch.runtime.straggler import StragglerMonitor
from repro_torch.runtime.supervisor import BackoffPolicy, Supervisor
from repro_torch.runtime.trainer import Trainer, TrainerConfig

CKPT = "/tmp/repro_torch_ft_ckpt"
CHAOS_CKPT = "/tmp/repro_torch_ft_chaos_ckpt"


def tiny_cfg():
    return get_arch("smollm-360m").reduced()


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    add_device_arg(ap)
    ap.add_argument("--ckpt", default=CKPT)
    ap.add_argument("--chaos-ckpt", default=CHAOS_CKPT)
    args = ap.parse_args(argv)
    dev = device(args.device)
    if os.path.isdir(args.ckpt):
        shutil.rmtree(args.ckpt)
    cfg = tiny_cfg()
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=64, global_batch=4,
                    seed=3)
    tc = TrainerConfig(ckpt_dir=args.ckpt, ckpt_every=10, log_every=1000,
                       total_steps=40, save_on_exit=False)

    # phase 1: train 25 steps, checkpoints at 10/20, then 'crash'
    t1 = Trainer(cfg, dc, tc, device=dev)
    t1.train(25)
    losses_1 = [m["loss"] for m in t1.history]
    print(f"[ft] phase 1 trained to step {t1.step} (ckpt at 20), 'crash'")
    del t1

    # phase 2: a fresh process resumes from the last durable checkpoint
    t2 = Trainer(cfg, dc, tc, device=dev)
    assert t2.step == 20, t2.step
    t2.train(5)  # replays steps 20..24 — same data, same rng
    losses_2 = [m["loss"] for m in t2.history]
    # determinism: the replayed steps reproduce the original losses
    np.testing.assert_allclose(losses_1[20:25], losses_2, rtol=1e-5)
    replay_rel = float(np.max(np.abs(np.subtract(losses_1[20:25], losses_2))
                              / np.abs(losses_2)))
    print(f"[ft] resumed at 20, replayed to {t2.step}: losses match "
          f"the pre-crash run (max rel diff {replay_rel:.1e})")

    # phase 3: straggler mitigation
    mon = StragglerMonitor(n_hosts=8, predicted_step_s=0.10, k=2.0,
                           ewma=0.0, policy="rescale")
    times = [0.1] * 8
    times[3] = 0.9  # host 3 degrades
    events = mon.observe(step=t2.step, host_times_s=times)
    print(f"[ft] straggler events: "
          f"{[(e.host, round(e.observed_s, 2), e.action) for e in events]}")
    print(f"[ft] skip-and-rescale weight: {mon.rescale_weight():.3f} "
          f"(gradient rescaled over 7 healthy hosts)")
    assert events and events[0].host == 3
    del t2

    # phase 4: the same crash-and-resume loop, but unattended — the
    # Supervisor detects the (injected) device loss, replans the mesh
    # over the 7 survivors, restores the last valid checkpoint, and
    # replays to completion with the same losses as phases 1+2
    if os.path.isdir(args.chaos_ckpt):
        shutil.rmtree(args.chaos_ckpt)
    tc_chaos = dataclasses.replace(tc, ckpt_dir=args.chaos_ckpt)
    injector = FaultInjector(
        FaultPlan(faults=(Fault("device_loss", 13),), seed=1),
        ckpt_dir=args.chaos_ckpt)
    workload = WorkloadSpec(phase="train", global_batch=dc.global_batch,
                            seq_len=dc.seq_len, name="ft_chaos")
    sup = Supervisor(
        lambda mesh: Trainer(cfg, dc, tc_chaos, injector=injector,
                             device=dev),
        25, cfg=get_arch("smollm-360m"), workload=workload,
        n_devices=8, model=CARD_MODEL, injector=injector,
        backoff=BackoffPolicy(base_s=0.0, max_s=0.0, jitter=0.0, seed=1))
    hist = sup.run()
    sup.report()
    assert len(sup.recoveries) == 1 and sup.n_devices == 7
    supervised = [m["loss"] for m in hist]
    np.testing.assert_allclose(losses_1, supervised, rtol=1e-5)
    print(f"[ft] supervised chaos run: device lost at step 13, "
          f"recovered in {sup.mttr_s()*1e3:.0f}ms, losses still match")
    return {"device": str(dev), "losses": losses_1, "replayed": losses_2,
            "replay_max_rel_diff": replay_rel, "supervised": supervised,
            "straggler_host": events[0].host,
            "rescale_weight": mon.rescale_weight(),
            "survivors": sup.n_devices, "recoveries": len(sup.recoveries),
            "steps_run": 25 + 5 + sup.steps_run,
            "mttr_s": sup.mttr_s()}


if __name__ == "__main__":
    main()
