"""Training loop: eager train step (sharded over a device mesh when one
is given), fault tolerance, straggler detection (the port of
`repro.train.trainer`).

Fault tolerance model: any step may raise (device loss, preemption,
injected fault).  The Trainer restores params/opt-state from the last
checkpoint, re-seeks the deterministic data pipeline to the restored step,
and continues — the token stream consumed is identical to a run without
the failure.

The step is eager: the loss, its gradients by autograd, and AdamW in place
(`repro_torch.optim.apply_updates`); the JAX package's jitted, donated
step.  With a `DeviceMesh` (`repro_torch.launch.mesh`) the parameters,
m, v and the batch are DTensors placed by their logical axes and the
shape's rules, the step runs inside `sharding_context`, and the gradients
are pinned to the weights' placements (a ``Partial`` sum reduce-scattered
to a sharded weight, not all-reduced); AdamW updates each rank's shards
in place, so new parameters, m and v keep those placements.

Straggler mitigation: per-step wall time is tracked with an EMA mean/var;
steps slower than ``mu + z*sigma`` are flagged (logged, counted, and
surfaced via ``straggler_events``).
"""
from __future__ import annotations

import dataclasses
import logging
import time
from typing import Callable, Optional

import torch

from ..launch import mesh as meshlib
from ..models.model import Model
from ..models.params import tree_leaves, tree_map
from ..optim import OptConfig, apply_updates, init_opt_state

log = logging.getLogger("repro_torch.train")


class StragglerMonitor:
    def __init__(self, zscore: float = 4.0, warmup: int = 5):
        self.z = zscore
        self.warmup = warmup
        self.n = 0
        self.mean = 0.0
        self.var = 0.0
        self.events = []

    def observe(self, step: int, dt: float) -> bool:
        self.n += 1
        if self.n <= self.warmup:
            # Welford warmup
            d = dt - self.mean
            self.mean += d / self.n
            self.var += d * (dt - self.mean)
            return False
        sigma = max((self.var / max(self.n - 1, 1)) ** 0.5, 1e-6)
        is_straggler = dt > self.mean + self.z * sigma
        if is_straggler:
            self.events.append((step, dt))
            log.warning("straggler step %d: %.3fs (mu=%.3fs sigma=%.3fs)",
                        step, dt, self.mean, sigma)
        d = dt - self.mean
        self.mean += d / self.n
        self.var += d * (dt - self.mean)
        return is_straggler


def make_train_step(model: Model, opt_cfg: OptConfig, mesh=None,
                    rules=None) -> Callable:
    """The (params, opt_state, batch) -> (params, opt_state, metrics) step:
    loss, gradients, AdamW in place.  params: trainable tensors; with a
    ``mesh``, DTensors placed by `repro_torch.launch.mesh` under ``rules``
    (default `DEFAULT_RULES`), and the step runs sharded."""

    def step(params, opt_state, batch):
        loss = model.loss_fn(params, batch)
        grads = torch.autograd.grad(loss, tree_leaves(params))
        it = iter(grads)
        grads = tree_map(lambda p: pin(next(it), p), params)
        params, opt_state, metrics = apply_updates(params, grads, opt_state,
                                                   opt_cfg)
        metrics["loss"] = loss.detach()
        return params, opt_state, metrics

    if mesh is None:
        return step
    rules = rules or meshlib.DEFAULT_RULES

    def sharded_step(params, opt_state, batch):
        with meshlib.sharding_context(mesh, rules):
            params, opt_state, metrics = step(params, opt_state, batch)
            metrics["loss"] = metrics["loss"].full_tensor()
        return params, opt_state, metrics

    return sharded_step


def pin(grad, weight):
    """``grad`` in ``weight``'s placements (the reference's sharding
    constraint on the gradients): a ``Partial`` sum is reduce-scattered
    to a sharded weight, all-reduced only to a replicated one."""
    if not meshlib.is_dtensor(weight) or tuple(grad.placements) == tuple(
            weight.placements):
        return grad
    return grad.redistribute(weight.device_mesh, weight.placements)


@dataclasses.dataclass
class TrainResult:
    steps_done: int
    losses: list
    restarts: int
    straggler_events: list


class Trainer:
    """``params``: an initial parameter tree (tensors, for example
    `params_from_jax`'s); otherwise parameters are drawn from ``seed`` in
    ``param_dtype`` by a `torch.Generator` on ``device`` (the card unless
    ``cpu`` is asked).

    With ``mesh`` (a `DeviceMesh` over the process group's ranks, on
    ``device``'s type) every rank draws the same parameters leaf by leaf
    and keeps each leaf's shards before it draws the next (no collective;
    a rank holds one full leaf at a time beside its shards), placed by
    their logical axes under ``rules`` (default `DEFAULT_RULES`); a given
    ``params`` tree is distributed the same way.  Each batch is the
    pipeline's global batch, of which a rank keeps its shard by the
    inputs' axes."""

    def __init__(self, model: Model, opt_cfg: OptConfig, pipeline,
                 ckpt=None, mesh=None, rules=None,
                 param_dtype=torch.float32, seed: int = 0, params=None,
                 device=None):
        self.model = model
        self.opt_cfg = opt_cfg
        self.pipeline = pipeline
        self.ckpt = ckpt
        self.mesh = mesh
        self.rules = rules or meshlib.DEFAULT_RULES
        self.monitor = StragglerMonitor()
        self.step_fn = make_train_step(model, opt_cfg, mesh, self.rules)
        if mesh is None and params is None:
            model.init(seed, param_dtype, device, trainable=True)
        elif mesh is None:
            model.load(params, trainable=True)
        elif params is None:  # each leaf drawn whole, then its shard kept
            model.init(seed, param_dtype, device, trainable=True,
                       place=lambda t, spec: meshlib.distribute(
                           t, mesh, meshlib.sharding_for(
                               spec.axes, t.shape, mesh, self.rules)))
        else:
            with torch.no_grad():
                model.load(meshlib.distribute_tree(
                    tree_map(lambda t: t.detach(), params),
                    model.param_axes(), mesh, self.rules), trainable=True)
        self.params = model.params
        self.opt_state = init_opt_state(self.params)
        self.step = 0
        if ckpt is not None and ckpt.latest_step() is not None:
            self.restore()

    def _state(self):
        return {"params": self.params, "opt": self.opt_state}

    def _batch(self, step: int) -> dict:
        """The pipeline's batch at ``step`` on the model's device; under a
        mesh, each rank's shard of it by the inputs' logical axes."""
        dev = self.model.device
        batch = {k: torch.from_numpy(v).to(dev) for k, v in
                 self.pipeline.batch_at(step).items()}
        if self.mesh is None:
            return batch
        ax = ("act_batch", "act_seq")
        return {k: meshlib.distribute(v, self.mesh, meshlib.sharding_for(
            ax, v.shape, self.mesh, self.rules)) for k, v in batch.items()}

    @torch.no_grad()
    def restore(self):
        state, meta = self.ckpt.restore(self._state())
        tree_map(lambda dst, src: dst.copy_(src), self.params,
                 state["params"])
        tree_map(lambda dst, src: dst.copy_(src),
                 {"m": self.opt_state["m"], "v": self.opt_state["v"]},
                 {"m": state["opt"]["m"], "v": state["opt"]["v"]})
        self.opt_state["step"] = state["opt"]["step"].cpu()
        self.step = int(meta["step"])
        log.info("restored checkpoint at step %d", self.step)

    def save(self, step: int):
        if self.ckpt is not None:
            self.ckpt.save(step, self._state())

    def run(self, num_steps: int, *, ckpt_every: int = 50,
            fault_injector: Optional[Callable[[int], None]] = None,
            max_restarts: int = 3) -> TrainResult:
        losses = []
        restarts = 0
        begin = step = self.step
        end = begin + num_steps
        while step < end:
            try:
                if fault_injector is not None:
                    fault_injector(step)  # may raise (simulated node loss)
                batch = self._batch(step)
                t0 = time.perf_counter()
                self.params, self.opt_state, metrics = self.step_fn(
                    self.params, self.opt_state, batch)
                loss = float(metrics["loss"])
                dt = time.perf_counter() - t0
                self.monitor.observe(step, dt)
                losses.append(loss)
                step += 1
                if ckpt_every and step % ckpt_every == 0:
                    self.save(step)
            except KeyboardInterrupt:
                raise
            except Exception as e:  # noqa: BLE001 — fault-tolerance path
                restarts += 1
                log.warning("step %d failed (%s); restart %d", step, e,
                            restarts)
                if restarts > max_restarts or self.ckpt is None:
                    raise
                if self.ckpt.latest_step() is not None:
                    self.restore()
                    step = self.step
        self.step = step
        if self.ckpt is not None:
            self.save(step)
            self.ckpt.wait()
        return TrainResult(step - begin, losses, restarts,
                           self.monitor.events)
