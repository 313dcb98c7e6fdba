"""Training loop with the reference's fault-tolerance contract.

* async checkpoints every ``ckpt_every`` steps, auto-resume from the
  latest COMMITted step (partial saves skipped);
* stateless data: batch = f(seed, step), so a resume replays the exact
  stream;
* straggler watchdog: a per-step deadline at ``watchdog_factor`` x the
  running p95; a trip records the event;
* failure injection (``inject_failure_at``) for the restart tests;
* optional int8 + error-feedback gradient compression ahead of the
  update.

One device; the reference's ``mesh`` and ``remesh`` belong to the
sharded slice (ROADMAP item 13d).  The step runs eagerly: autograd
through the model's loss, then :func:`~repro_torch.optim.apply_updates`,
which updates the params and the optimizer state in place where the
reference donates them.
"""
from __future__ import annotations

import dataclasses
import os
import tempfile
import time
from typing import Callable

import torch

from ..checkpointing import CheckpointManager
from ..data.synthetic import DataConfig, batch_for_step
from ..device import resolve_device
from ..models.common import init_params, tree_leaves, tree_map
from ..models.registry import ArchDef
from ..optim import AdamWConfig, apply_updates, init_opt_state
from ..optim import compress as gcomp
from ..sharding import ShardCtx


def _default_ckpt_dir() -> str:
    return os.path.join(tempfile.gettempdir(), "repro_torch_ckpt")


@dataclasses.dataclass(frozen=True)
class TrainLoopConfig:
    total_steps: int = 100
    ckpt_every: int = 50
    ckpt_dir: str = dataclasses.field(default_factory=_default_ckpt_dir)
    keep_ckpts: int = 3
    log_every: int = 10
    watchdog_factor: float = 5.0
    watchdog_min_history: int = 8
    grad_compression: bool = False
    inject_failure_at: int | None = None     # for fault-tolerance tests
    seed: int = 0


class InjectedFailure(RuntimeError):
    pass


def make_train_step(arch: ArchDef, opt_cfg: AdamWConfig, ctx: ShardCtx,
                    compression: bool = False) -> Callable:
    """``train_step(params, opt_state, batch[, err])`` -> (params,
    opt_state, metrics[, err]); params, state and ``err`` are updated in
    place.  With ``cfg.accum_steps`` > 1 microbatch i is rows
    i*B/accum .. (i+1)*B/accum - 1; its grads are summed in f32 in
    microbatch order and divided by ``accum``, as the reference's scan
    does."""
    cfg = arch.cfg
    accum = max(1, cfg.accum_steps)

    def value_and_grad(params, batch):
        leaves = [t.requires_grad_() for t in
                  tree_leaves(params, torch.is_tensor)]
        loss, metrics = arch.loss(params, batch, cfg, ctx)
        grads = torch.autograd.grad(loss, leaves)
        return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
                grads)

    def grads_of(params, batch):
        if accum == 1:
            loss, metrics, grads = value_and_grad(params, batch)
        else:
            micro = {k: v.reshape((accum, v.shape[0] // accum)
                                  + v.shape[1:])
                     for k, v in batch.items()}
            grads, loss_sum = None, None
            for i in range(accum):
                loss, _, g = value_and_grad(
                    params, {k: v[i] for k, v in micro.items()})
                if grads is None:
                    grads = [torch.zeros(x.shape, dtype=torch.float32,
                                         device=x.device) for x in g]
                    loss_sum = torch.zeros((), dtype=torch.float32,
                                           device=loss.device)
                for a, b in zip(grads, g):
                    a.add_(b)
                del g
                loss_sum = loss_sum + loss
            loss = loss_sum / accum
            for a in grads:
                a.div_(accum)
            metrics = {"loss": loss}
        it = iter(grads)
        return loss, metrics, tree_map(lambda _: next(it), params,
                                       torch.is_tensor)

    def train_step(params, opt_state, batch, err=None):
        loss, metrics, grads = grads_of(params, batch)
        if compression:
            grads, err = gcomp.compress_tree(grads, err)
        params, opt_state, opt_metrics = apply_updates(
            params, grads, opt_state, opt_cfg)
        del grads
        metrics = {**metrics, **opt_metrics, "loss_total": loss}
        if compression:
            return params, opt_state, metrics, err
        return params, opt_state, metrics

    # the step's loss, metrics and grads alone, without the update
    train_step.grads_of = grads_of
    return train_step


class Trainer:
    def __init__(self, arch: ArchDef, opt_cfg: AdamWConfig,
                 loop_cfg: TrainLoopConfig,
                 data_cfg: DataConfig | None = None, device=None):
        self.arch = arch
        self.cfg = arch.cfg
        self.opt_cfg = opt_cfg
        self.loop_cfg = loop_cfg
        self.device = resolve_device(device)
        self.ctx = ShardCtx()
        self.data_cfg = data_cfg or DataConfig(
            vocab=self.cfg.vocab, seq_len=min(self.cfg.max_seq, 128),
            global_batch=8, seed=loop_cfg.seed)
        self.ckpt = CheckpointManager(loop_cfg.ckpt_dir,
                                      keep=loop_cfg.keep_ckpts)
        self._step_times: list[float] = []
        self.events: list[dict] = []
        self._train_step = make_train_step(
            arch, opt_cfg, self.ctx, compression=loop_cfg.grad_compression)

        self.params = None
        self.opt_state = None
        self.err = None
        self.step = 0

    # -- state ---------------------------------------------------------------
    def init_state(self, gen: torch.Generator | None = None):
        """Params from ``gen`` (default: a generator on the trainer's
        device seeded with ``loop_cfg.seed``), fresh optimizer state."""
        if gen is None:
            gen = torch.Generator(self.device).manual_seed(self.loop_cfg.seed)
        specs = self.arch.param_specs(self.cfg)
        self.params = init_params(gen, specs, self.device)
        self.opt_state = init_opt_state(self.params, self.opt_cfg)
        if self.loop_cfg.grad_compression:
            self.err = gcomp.init_error(self.params)
        self.step = 0

    def _state_tree(self):
        t = {"params": self.params, "opt": self.opt_state}
        if self.err is not None:
            t["err"] = self.err
        return t

    def try_resume(self) -> bool:
        """Resume from the latest valid checkpoint; returns True if
        resumed."""
        if self.params is None:
            self.init_state()
        step, tree = self.ckpt.restore_latest(self._state_tree())
        if step is None:
            return False
        self.params = tree["params"]
        self.opt_state = tree["opt"]
        self.err = tree.get("err", self.err)
        self.step = step
        self.events.append({"kind": "resume", "step": step})
        return True

    # -- loop ----------------------------------------------------------------
    def _deadline(self) -> float | None:
        hist = self._step_times
        if len(hist) < self.loop_cfg.watchdog_min_history:
            return None
        p95 = sorted(hist)[int(0.95 * (len(hist) - 1))]
        return p95 * self.loop_cfg.watchdog_factor

    def run_step(self) -> dict:
        lc = self.loop_cfg
        if lc.inject_failure_at is not None and \
                self.step == lc.inject_failure_at:
            raise InjectedFailure(f"injected failure at step {self.step}")
        batch = batch_for_step(self.data_cfg, self.step, self.device)
        t0 = time.monotonic()
        out = self._train_step(self.params, self.opt_state, batch,
                               *([self.err] if self.err is not None else []))
        if self.err is not None:
            self.params, self.opt_state, metrics, self.err = out
        else:
            self.params, self.opt_state, metrics = out
        metrics = {k: float(v) for k, v in metrics.items()}
        dt = time.monotonic() - t0
        deadline = self._deadline()
        if deadline is not None and dt > deadline:
            # straggler trip: on a fleet this triggers re-slicing; here
            # the event is recorded (the step already completed)
            self.events.append({"kind": "straggler", "step": self.step,
                                "seconds": dt, "deadline": deadline})
        self._step_times.append(dt)
        if len(self._step_times) > 64:
            self._step_times.pop(0)
        self.step += 1
        metrics["step_seconds"] = dt
        return metrics

    def run(self, steps: int | None = None) -> list[dict]:
        lc = self.loop_cfg
        steps = steps if steps is not None else lc.total_steps
        if self.params is None and not self.try_resume():
            self.init_state()
        history = []
        while self.step < steps:
            metrics = self.run_step()
            if self.step % lc.log_every == 0 or self.step == steps:
                history.append({"step": self.step, **metrics})
            if self.step % lc.ckpt_every == 0:
                self.ckpt.save_async(self.step, self._state_tree())
        self.ckpt.save_async(self.step, self._state_tree())
        self.ckpt.wait()
        return history
