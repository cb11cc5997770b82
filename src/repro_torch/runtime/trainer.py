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

With ``online_calibrate`` (or a ``calibrator=``) the per-step timings also
feed an ``OnlineCalibrator`` (``calibration/online.py``): each step records
(the step's property vector, measured seconds) into the telemetry sink, the
streaming RLS tracks the fit, and a drift event triggers a refit and a
straggler-threshold re-anchor.  A ``[calib]`` report line (sample counts,
windowed relative error, drift status, refit epochs) prints every
``log_every`` steps.  The step's seconds are the wall time to
``torch.cuda.synchronize`` after it, never a launch time.  An ``injector``
(``runtime/faults.py``) lands its faults through the reference's hooks:
``step_begin`` before the step, ``perturb_step_time`` and
``perturb_telemetry`` on the measured time.  As in the reference, the
straggler monitor's predicted step time is an argument
(``predicted_step_s``); a caller that wants the cost model's builds it with
``StragglerMonitor.from_model`` or ``core.predictor.predict_plans``.
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
    # --- online calibration (calibration/online.py) ---
    online_calibrate: bool = False
    calib_device: Optional[str] = None      # registry name for refit models
    calib_registry: Optional[str] = None    # registry dir override
    calib_auto_register: bool = False       # write refits into the registry


class Trainer:
    def __init__(self, cfg: ArchConfig, data_cfg: DataConfig,
                 tc: TrainerConfig, plan: Optional[Plan] = None,
                 predicted_step_s: Optional[float] = None,
                 calibrator=None, injector=None, device="cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "Trainer: no CUDA device (torch.cuda.is_available() is "
                "false); pass device='cpu' to train on the CPU")
        self.cfg = cfg
        self.tc = tc
        # optional FaultInjector (runtime/faults.py); every hook below is
        # behind `is not None`, so the hot path is untouched when chaos
        # is off
        self.injector = injector
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

        # ---- online calibration ----
        self.calibrator = calibrator
        if self.calibrator is None and tc.online_calibrate:
            from repro_torch.calibration.online import OnlineCalibrator
            self.calibrator = OnlineCalibrator(
                None, device=tc.calib_device or f"{cfg.name}-online",
                registry_dir=tc.calib_registry,
                auto_register=tc.calib_auto_register)
        self._step_pv = None
        if self.calibrator is not None:
            # the live step's property vector: this trainer runs the whole
            # batch on one device, so the pv is the single-device cell of
            # (cfg × the ACTUAL data workload × the plan) over the kernels
            # the card launches
            from repro_torch.core import predictor
            from repro_torch.core.workload import WorkloadSpec
            live = WorkloadSpec(phase="train",
                                global_batch=data_cfg.global_batch,
                                seq_len=data_cfg.seq_len,
                                name="train_live")
            self._step_pv = predictor.plan_property_vector(
                cfg, live, plan, {"data": 1})

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
            if self.injector is not None:
                # may corrupt state files or raise DeviceLossError — BEFORE
                # the step runs, so the supervisor resumes at exactly this
                # step and batch semantics stay exact
                self.injector.step_begin(step)
            batch = {k: torch.from_numpy(v).to(self.device)
                     for k, v in self.loader.batch(step).items()}
            # the model's prediction for THIS step — the straggler monitor
            # carries it (re-anchored on every refit)
            pred_s = self.monitor.predicted_step_s
            t0 = time.perf_counter()
            with tracer.span("train_step", predicted_s=pred_s, step=step):
                self.state, metrics = self.step_fn(self.state, batch)
                self._sync()
            dt = time.perf_counter() - t0
            if self.injector is not None:
                # scheduled slowdowns/spikes scale the OBSERVED time: the
                # monitor, watchdog, histogram and calibrator all see the
                # same perturbed measurement, as they would a real straggler
                dt = self.injector.perturb_step_time(step, dt)
            _STEP_SECONDS.observe(dt)
            self.monitor.observe(step, [dt])
            if self.calibrator is not None:
                sample = dt
                if self.injector is not None:
                    sample = self.injector.perturb_telemetry(step, dt)
                ev = self.calibrator.observe(self._step_pv, sample,
                                             step=step,
                                             tag="train", phase="train")
                if ev is not None:
                    # refit already happened inside observe(); re-anchor the
                    # straggler threshold to the refit model's prediction
                    self.monitor.reanchor(
                        self.calibrator.model.predict(self._step_pv))
                    _obs_report.emit(
                        "calib",
                        text=f"drift detected at step {step} "
                             f"(direction={ev.direction}, onset seq "
                             f"{ev.onset_seq}): refit epoch "
                             f"{self.calibrator.refits}, revision "
                             f"{self.calibrator.revision}")

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
            if self.calibrator is not None \
                    and step % self.tc.log_every == 0:
                _obs_report.emit("calib",
                                 text=self.calibrator.report_line())
            if self.tc.ckpt_dir and (step + 1) % self.tc.ckpt_every == 0:
                self._save()
        if self.tc.ckpt_dir and self.tc.save_on_exit:
            self._save(blocking=True)
        elif self.ckpt is not None:
            self.ckpt.wait()
        return self.history
