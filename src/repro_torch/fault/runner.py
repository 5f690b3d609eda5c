"""Resilient training runner: checkpoint / restart / elastic rescale (the
reference's ``fault/runner.py``).

``ResilientTrainer.run`` drives the train step with
  * periodic async checkpoints (params + optimizer + data-iterator step),
  * failure injection hooks (tests raise SimulatedFailure at chosen steps),
  * restart-from-latest-checkpoint with bitwise-identical data replay
    (the pipeline is a pure function of the step counter),
  * elastic rescale: ``rescale(new_mesh)`` makes the next restore re-split
    the state by its logical axes under the new mesh -- a checkpoint
    written on a 4-rank mesh loads on 2 ranks.
The restore target is the state's skeleton on the ``meta`` device
(``launch.specs.train_state_specs``), the counterpart of the reference's
``jax.eval_shape(init_state_fn)``.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional

from ..checkpoint import CheckpointStore
from ..core.power import Device
from ..data.pipeline import DataConfig, make_batch
from ..models.config import ArchConfig
from .monitor import HeartbeatMonitor, StragglerTracker


def _mesh_of(state):
    """The mesh a sharded state's leaves lie on (None for a plain one)."""
    from torch.distributed.tensor import DTensor
    p = next(state.model.parameters())
    return p.device_mesh if isinstance(p, DTensor) else None


class SimulatedFailure(RuntimeError):
    pass


@dataclass
class RunReport:
    losses: List[float]
    restarts: int
    straggler_steps: List[int]
    final_step: int


class ResilientTrainer:
    """``step_fn(state, batch) -> (state, metrics)``; ``init_state_fn()``
    a fresh state; ``state_axes``: the state's logical axes
    (``train.step.state_axes``; with ``err`` when the state carries the
    pod compression's residuals); ``mesh``: restore onto it (default: the
    mesh of the state ``init_state_fn`` returns, if it is sharded);
    ``device``: where an unsharded restore goes (default: the CUDA
    card)."""

    def __init__(self, arch: ArchConfig, dcfg: DataConfig, step_fn,
                 init_state_fn: Callable[[], Any], ckpt_dir: str,
                 ckpt_every: int = 10, state_axes=None, mesh=None,
                 device: Device = None):
        self.arch = arch
        self.dcfg = dcfg
        self.step_fn = step_fn
        self.init_state_fn = init_state_fn
        self.store = CheckpointStore(ckpt_dir)
        self.ckpt_every = ckpt_every
        self.state_axes = state_axes
        self.mesh = mesh
        self.device = device
        self.monitor = HeartbeatMonitor(timeout_s=60.0)
        self.straggler = StragglerTracker()

    def _restore_or_init(self):
        from ..launch.specs import train_state_specs
        step = self.store.latest_step()
        if step is None:
            state = self.init_state_fn()
            if self.mesh is None:
                # a restart restores onto the mesh the first state lay on,
                # not into whole tensors on every rank
                self.mesh = _mesh_of(state)
            return state, 0
        compress = self.state_axes is not None and \
            self.state_axes.err is not None
        like, axes = train_state_specs(self.arch, compress)
        state, extra = self.store.restore(
            step, like, mesh=self.mesh, axes=self.state_axes or axes,
            device=self.device)
        return state, int(extra["data_step"])

    def rescale(self, new_mesh) -> None:
        """Elastic rescale: re-place the latest checkpoint on a new mesh."""
        self.mesh = new_mesh

    def run(self, n_steps: int,
            fail_at: Optional[Dict[int, Exception]] = None,
            max_restarts: int = 8) -> RunReport:
        fail_at = dict(fail_at or {})
        losses: List[float] = []
        restarts = 0
        while True:
            try:
                state, data_step = self._restore_or_init()
                while data_step < n_steps:
                    if data_step in fail_at:
                        raise fail_at.pop(data_step)
                    t0 = time.monotonic()
                    batch = make_batch(self.arch, self.dcfg, data_step)
                    state, metrics = self.step_fn(state, batch)
                    loss = float(metrics["loss"])
                    losses.append(loss)
                    self.straggler.record(data_step,
                                          time.monotonic() - t0)
                    self.monitor.beat("worker0")
                    data_step += 1
                    if data_step % self.ckpt_every == 0:
                        self.store.save(data_step, state,
                                        extra=dict(data_step=data_step))
                self.store.save(n_steps, state,
                                extra=dict(data_step=n_steps))
                self.store.wait()
                return RunReport(losses=losses, restarts=restarts,
                                 straggler_steps=self.straggler.flagged_steps,
                                 final_step=n_steps)
            except SimulatedFailure:
                restarts += 1
                if restarts > max_restarts:
                    raise
                # the new incarnation must not inherit detector state: old
                # step times would poison the straggler median, and the dead
                # worker would re-alarm dead_workers() forever
                self.straggler.reset()
                self.monitor.deregister("worker0")
                self.store.wait()
