"""Trainer: LoRA fine-tuning loop with checkpoint/restart fault tolerance,
straggler monitoring, deterministic resumable data and async checkpoints
(PyTorch port of ``repro.train.trainer``).

The restart path is the paper's deployment story at fleet scale: frozen
base weights are write-once (load from the pretrained artifact), so a
restart only restores the LoRA adapters + optimizer moments + step counter
— megabytes, not the hundreds of GB a full-FT restart would move.

Randomness comes from generators on the trainer's device seeded from
``tc.seed``: the base from ``seed``, the adapters from ``seed + 1`` and
each step's weight noise from ``(seed + 17, step)``, so a restart at step
k draws what an uninterrupted run draws at step k.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch import DeviceLike, resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.core import lora as lora_lib
from repro_torch.data.pipeline import ShardInfo
from repro_torch.dist.fault import FaultCoordinator, RestartPolicy
from repro_torch.models.transformer import ExecConfig, init_params
from repro_torch.optim import adamw
from repro_torch.train import checkpoint as ckpt_lib
from repro_torch.train.steps import TrainHParams, make_train_step


@dataclass
class TrainerConfig:
    seq_len: int = 128
    global_batch: int = 8
    steps: int = 50
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 20
    keep_ckpts: int = 3
    hparams: TrainHParams = field(default_factory=TrainHParams)
    seed: int = 0
    log_every: int = 10


def _generator(device: torch.device, seed: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


class Trainer:
    def __init__(self, cfg: ModelConfig, tc: TrainerConfig, dataset, *,
                 exec_cfg: ExecConfig = ExecConfig(), params=None,
                 fault: Optional[FaultCoordinator] = None,
                 step_hook: Optional[Callable[[int], None]] = None,
                 device: DeviceLike = None):
        self.cfg, self.tc, self.dataset = cfg, tc, dataset
        self.exec_cfg = exec_cfg
        self.device = resolve_device(device)
        self.params = (params if params is not None else init_params(
            cfg, _generator(self.device, tc.seed), device=self.device))
        self.lora = lora_lib.init_lora_params(
            cfg, _generator(self.device, tc.seed + 1), device=self.device)
        self.opt_state = adamw.init(self.lora)
        self.step = 0
        self.metrics_log: List[Dict[str, float]] = []
        self.fault = fault or FaultCoordinator(RestartPolicy())
        self.saver = ckpt_lib.AsyncSaver()
        self._step_fn = make_train_step(cfg, exec_cfg, tc.hparams)
        self._step_hook = step_hook  # test injection point (failures/delays)

    # ------------------------------------------------------------------
    def _batch(self, step: int) -> Dict[str, torch.Tensor]:
        b = self.dataset.batch(step, self.tc.global_batch, self.tc.seq_len,
                               ShardInfo())
        return {k: torch.from_numpy(np.ascontiguousarray(v)).to(self.device)
                for k, v in b.items()}

    def _noise_rng(self, step: int) -> Optional[torch.Generator]:
        if not self.exec_cfg.noise.enabled:
            return None
        return _generator(self.device,
                          (self.tc.seed + 17) * 1_000_003 + step)

    def train_state(self):
        return {"lora": self.lora, "opt": self.opt_state._asdict(),
                "step": torch.tensor(self.step, dtype=torch.int32)}

    def _load_state(self, state):
        self.lora = state["lora"]
        self.opt_state = adamw.AdamWState(**state["opt"])
        self.step = int(state["step"])

    def save_ckpt(self, sync: bool = False) -> None:
        if not self.tc.ckpt_dir:
            return
        state = self.train_state()
        if sync:
            ckpt_lib.save(self.tc.ckpt_dir, self.step, state,
                          keep=self.tc.keep_ckpts)
        else:
            self.saver.save(self.tc.ckpt_dir, self.step, state,
                            keep=self.tc.keep_ckpts)

    def maybe_restore(self) -> bool:
        if not self.tc.ckpt_dir:
            return False
        last = ckpt_lib.latest_step(self.tc.ckpt_dir)
        if last is None:
            return False
        state = ckpt_lib.restore(self.tc.ckpt_dir, self.train_state(), last)
        self._load_state(state)
        return True

    # ------------------------------------------------------------------
    def run(self) -> List[Dict[str, float]]:
        while self.step < self.tc.steps:
            if self._step_hook:
                self._step_hook(self.step)
            t0 = time.time()
            batch = self._batch(self.step)
            self.lora, self.opt_state, m = self._step_fn(
                self.params, self.lora, self.opt_state, batch,
                self._noise_rng(self.step))
            loss = float(m["loss"])
            dt = time.time() - t0
            self.fault.on_step(self.step, dt)
            self.step += 1
            rec = {"step": self.step, "loss": loss, "sec": dt,
                   "grad_norm": float(m.get("grad_norm", np.nan))}
            self.metrics_log.append(rec)
            if self.step % self.tc.log_every == 0:
                print(f"step {self.step:5d} loss {loss:.4f} "
                      f"({dt*1e3:.0f} ms)")
            if self.tc.ckpt_dir and self.step % self.tc.ckpt_every == 0:
                self.save_ckpt()
        self.saver.wait()
        return self.metrics_log

    def run_with_restarts(self) -> List[Dict[str, float]]:
        """Fault-tolerant loop: on any step failure, restore the last
        checkpoint and continue (bounded by the restart policy)."""
        while True:
            try:
                return self.run()
            except Exception as exc:  # noqa: BLE001 — anything kills a step
                self.saver.wait()
                if not self.fault.should_restart(exc):
                    raise
                restored = self.maybe_restore()
                print(f"[fault] restart #{self.fault.restarts} after "
                      f"{type(exc).__name__}; restored={restored} "
                      f"at step {self.step}")
