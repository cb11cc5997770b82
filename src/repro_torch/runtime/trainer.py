"""Trainer: the fault-tolerant training loop.

Wires together data pipeline → train_step → async checkpointing →
straggler monitor, with resume from the newest valid checkpoint on
construction, so a restart after preemption continues exactly where the dead
run stopped: the data pipeline is addressed by the checkpointed step — no
iterator state to recover.

It runs on the card (``device="cuda"``) and raises where there is none; the
caller asks for the CPU (``device="cpu"``), as the tests do.  Random initial
weights come from a ``torch.Generator`` on the device seeded with
``TrainerConfig.seed``.

Not ported yet, each raising ``NotImplementedError`` until its slice: the
online calibrator (``online_calibrate``, ``calibrator=``; A13) and the fault
injector (``injector=``; A13).  As in the reference, the straggler monitor's
predicted step time is an argument (``predicted_step_s``); a caller that
wants the cost model's builds it with ``StragglerMonitor.from_model`` or
``core.predictor.predict_plans``.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

import torch

from repro_torch.checkpoint import store
from repro_torch.configs.base import ArchConfig
from repro_torch.data.pipeline import DataConfig, PackedLoader
from repro_torch.distributed.plan import Plan
from repro_torch.obs import metrics as _obs_metrics
from repro_torch.obs import report as _obs_report
from repro_torch.obs import trace as _obs_trace
from repro_torch.optim import optimizers as opt
from repro_torch.runtime import steps
from repro_torch.runtime.straggler import StragglerMonitor

_STEP_SECONDS = _obs_metrics.REGISTRY.histogram(
    "repro_train_step_seconds", "measured trainer step wall seconds")


@dataclass
class TrainerConfig:
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 50
    keep_ckpts: int = 3
    log_every: int = 10
    seed: int = 0
    lr: float = 3e-4
    warmup: int = 20
    total_steps: int = 1000
    async_ckpt: bool = True
    save_on_exit: bool = True  # False simulates preemption mid-interval
    # online calibration (calibration/online.py) raises until it is ported;
    # its registry settings arrive with it
    online_calibrate: bool = False


class Trainer:
    def __init__(self, cfg: ArchConfig, data_cfg: DataConfig,
                 tc: TrainerConfig, plan: Optional[Plan] = None,
                 predicted_step_s: Optional[float] = None,
                 calibrator=None, injector=None, device="cuda"):
        if calibrator is not None or tc.online_calibrate:
            raise NotImplementedError(
                "online calibration (calibration/online.py) waits for its "
                "slice (A13)")
        if injector is not None:
            raise NotImplementedError(
                "fault injection (runtime/faults.py) waits for its slice "
                "(A13)")
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "Trainer: no CUDA device (torch.cuda.is_available() is "
                "false); pass device='cpu' to train on the CPU")
        self.cfg = cfg
        self.tc = tc
        self.loader = PackedLoader(data_cfg)
        self.optimizer = opt.get_optimizer(cfg.optimizer)
        lr = opt.warmup_cosine(tc.lr, tc.warmup, tc.total_steps)
        plan = plan or Plan(dp_axes=())
        self.step_fn = steps.make_train_step(cfg, self.optimizer, plan,
                                             lr_schedule=lr)
        gen = torch.Generator(self.device).manual_seed(tc.seed)
        self.state = steps.init_train_state(cfg, gen, self.optimizer,
                                            device=self.device)
        self.monitor = StragglerMonitor(
            n_hosts=1, predicted_step_s=predicted_step_s or 1.0)
        self.ckpt = (store.AsyncCheckpointer(tc.ckpt_dir, tc.keep_ckpts)
                     if tc.ckpt_dir and tc.async_ckpt else None)
        self.history: List[Dict[str, float]] = []

        # ---- resume (newest VALID checkpoint: an invalid one — e.g. a
        # write the preemption itself interrupted — is quarantined and
        # the next-older step restored instead of crashing the restart)
        if tc.ckpt_dir:
            live = steps.state_tree(self.state)
            restored = store.restore_latest_valid(tc.ckpt_dir, live)
            if restored is not None:
                tree, _, latest = restored
                tree = store.load_into(live, tree)
                self.state = steps.TrainState(
                    self.state.params, tree["opt_state"], tree["step"])
                _obs_report.emit("trainer", text=f"resumed from step "
                                                 f"{latest}")

    # ------------------------------------------------------------------
    @property
    def step(self) -> int:
        return int(self.state.step)

    def _save(self, blocking: bool = False):
        if not self.tc.ckpt_dir:
            return
        tree = steps.state_tree(self.state)
        if self.ckpt is not None and not blocking:
            self.ckpt.save(self.step, tree)
        else:
            if self.ckpt is not None:
                self.ckpt.wait()
            store.save(self.tc.ckpt_dir, self.step, tree)
            store.prune(self.tc.ckpt_dir, self.tc.keep_ckpts)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def train(self, n_steps: int,
              on_metrics: Optional[Callable[[int, Dict], None]] = None
              ) -> List[Dict[str, float]]:
        tracer = _obs_trace.get_tracer()
        for _ in range(n_steps):
            step = self.step
            batch = {k: torch.from_numpy(v).to(self.device)
                     for k, v in self.loader.batch(step).items()}
            pred_s = self.monitor.predicted_step_s
            t0 = time.perf_counter()
            with tracer.span("train_step", predicted_s=pred_s, step=step):
                self.state, metrics = self.step_fn(self.state, batch)
                self._sync()
            dt = time.perf_counter() - t0
            _STEP_SECONDS.observe(dt)
            self.monitor.observe(step, [dt])

            m = {"step": step, "loss": float(metrics["loss"]),
                 "grad_norm": float(metrics["grad_norm"]),
                 "lr": float(metrics["lr"]), "time_s": dt}
            self.history.append(m)
            if on_metrics:
                on_metrics(step, m)
            elif step % self.tc.log_every == 0:
                _obs_report.emit(
                    "trainer",
                    text=f"step {step:5d} loss {m['loss']:.4f} "
                         f"gnorm {m['grad_norm']:.3f} {dt*1e3:.0f}ms")
            if self.tc.ckpt_dir and (step + 1) % self.tc.ckpt_every == 0:
                self._save()
        if self.tc.ckpt_dir and self.tc.save_on_exit:
            self._save(blocking=True)
        elif self.ckpt is not None:
            self.ckpt.wait()
        return self.history
