"""Fault-tolerance runtime: the preemption-safe training driver, straggler
statistics, and the capacity-overflow retry hook for external drivers.

The port of the reference package's ``runtime/ft.py``, on one process or
on the data ranks of a mesh (``launch/mesh.py``):

1. Checkpoint and restart: periodic asynchronous checkpoints, and a
   SIGTERM/SIGINT handler that makes the loop stop and write a final
   checkpoint before it returns (preemption on spot or maintenance
   events).  The old handlers come back on every exit.
2. Straggler detection: an EMA of each step's wall time; a step slower than
   ``straggler_factor`` x the EMA is counted and logged.
3. Shuffle-capacity overflow retry: ``run_with_overflow_retry`` rebuilds a
   plan with doubled slack until its table no longer overflows.

On a mesh the ranks agree on a preemption (an all-reduce MAX of the flag
before each step), so all of them stop at one step and save together; a
save gathers the state's blocks (``shardings``, a tree of specs: the
ZeRO-1 moments) into whole leaves on every rank, a collective they all
join, and rank 0 alone writes them; ``maybe_resume`` gives each rank its
block.  Straggler statistics stay per rank.

Departure (ROADMAP.md §3): ``FTConfig.keep`` reaches the saver and is the
number of checkpoints kept; the reference keeps 3 whatever it says.
"""
from __future__ import annotations

import os
import signal
import tempfile
import time
from dataclasses import dataclass, field
from typing import Any, Callable

import numpy as np

import torch

from ..checkpoint import AsyncSaver, copy_into, latest_step, restore
from ..models import sharding
from ..models.lm import leaves


def _default_ckpt_dir() -> str:
    return os.path.join(tempfile.gettempdir(), "repro_torch_ckpt")


@dataclass
class FTConfig:
    ckpt_dir: str = field(default_factory=_default_ckpt_dir)
    ckpt_every: int = 50
    keep: int = 3
    straggler_factor: float = 3.0
    max_retries: int = 3


@dataclass
class StepStats:
    times: list = field(default_factory=list)
    ema: float = 0.0
    stragglers: int = 0

    def record(self, dt: float, factor: float) -> bool:
        self.times.append(dt)
        straggler = self.ema > 0 and dt > factor * self.ema
        self.ema = dt if self.ema == 0 else 0.9 * self.ema + 0.1 * dt
        self.stragglers += int(straggler)
        return straggler


class TrainDriver:
    """Preemption-safe step loop around a train step.

    ``step_fn(state, batch) -> (state, loss)``; ``state`` a nested dict of
    tensors (``{"params": LM.tree(), "opt": ...}``), checkpointed whole.
    On a ``mesh`` with more than one rank, ``shardings`` (a tree of specs
    over ``state``, leaves it does not reach whole) lays the state out
    (module docstring).  A resume writes into the live state's own
    tensors, wherever they are."""

    def __init__(self, cfg: FTConfig, state, step_fn: Callable,
                 metadata: dict | None = None, mesh=None, shardings=None):
        self.cfg = cfg
        self.state = state
        self.step_fn = step_fn
        self.metadata = metadata or {}
        self.mesh = mesh if mesh is not None and mesh.world.size > 1 else None
        self.shardings = shardings if self.mesh is not None else None
        self.saver = AsyncSaver(cfg.ckpt_dir, keep=cfg.keep)
        self.stats = StepStats()
        self.step = 0
        self._preempted = False
        self._old_handlers = {}

    # -- preemption ---------------------------------------------------------
    def _handler(self, signum, frame):
        self._preempted = True

    def install_signal_handlers(self):
        for sig in (signal.SIGTERM, signal.SIGINT):
            self._old_handlers[sig] = signal.signal(sig, self._handler)

    def restore_signal_handlers(self):
        for sig, h in self._old_handlers.items():
            signal.signal(sig, h)
        self._old_handlers = {}

    # -- resume ---------------------------------------------------------------
    def maybe_resume(self) -> bool:
        """Restore the latest checkpoint, if any, into the live state in
        place (the model's parameters stay the tensors its blocks view);
        a leaf the checkpoint lacks keeps its value."""
        if latest_step(self.cfg.ckpt_dir) is None:
            return False
        tree, self.step, _meta = restore(self.cfg.ckpt_dir, self.state,
                                         device="cpu", shardings=self.shardings,
                                         mesh=self.mesh)
        copy_into(self.state, tree)
        return True

    # -- across ranks ---------------------------------------------------------
    def _agreed_preemption(self) -> bool:
        """The flag, MAX over the ranks (every rank calls this each step)."""
        if self.mesh is None:
            return self._preempted
        dev = next(leaves(self.state))[1].device
        flag = torch.tensor([float(self._preempted)], device=dev)
        return bool(self.mesh.world.all_reduce(flag, "max").item())

    def save(self) -> None:
        """Checkpoint the state at this step: on a mesh, the blocks gathered
        on every rank, then written by rank 0 alone."""
        tree = self.state
        if self.mesh is not None:
            tree = sharding.gather_tree(self.state, self.shardings, self.mesh)
            if self.mesh.rank != 0:
                return
        self.saver.save(self.step, tree, self.metadata)

    # -- main loop -------------------------------------------------------------
    def run(self, batches, num_steps: int, log_every: int = 10,
            log_fn=print) -> dict:
        self.install_signal_handlers()
        losses = []
        try:
            for batch in batches:
                if self.step >= num_steps:
                    break
                if self._agreed_preemption():
                    self._preempted = True
                    break
                t0 = time.perf_counter()
                self.state, loss = self.step_fn(self.state, batch)
                loss = float(loss)
                dt = time.perf_counter() - t0
                straggler = self.stats.record(dt, self.cfg.straggler_factor)
                self.step += 1
                losses.append(loss)
                if straggler:
                    log_fn(f"[ft] straggler step {self.step}: {dt:.3f}s "
                           f"(ema {self.stats.ema:.3f}s)")
                if self.step % log_every == 0:
                    log_fn(f"step {self.step} loss {loss:.4f} {dt*1e3:.1f}ms")
                if self.step % self.cfg.ckpt_every == 0:
                    self.save()
            if self._preempted:
                log_fn(f"[ft] preemption signal — checkpointing at step {self.step}")
            self.save()
            self.saver.wait()
            if self.mesh is not None:
                torch.distributed.barrier()   # rank 0's files are in place
        finally:
            self.restore_signal_handlers()
        return {"steps": self.step, "losses": losses,
                "stragglers": self.stats.stragglers,
                "mean_step_s": float(np.mean(self.stats.times)) if self.stats.times else 0.0}


def run_with_overflow_retry(build_and_run: Callable[[float], Any],
                            base_slack: float = 2.0, max_retries: int = 3):
    """``build_and_run(slack)`` returns a DTable; while its overflow flag is
    set, the plan is rebuilt with doubled slack.  Returns (table, attempts);
    raises a typed ``CapacityOverflow`` (a RuntimeError) after
    ``max_retries`` retries.  A shim over :meth:`RetryPolicy.run_slack`."""
    from .retry import RetryPolicy
    return RetryPolicy(max_retries=max_retries, scope="global").run_slack(
        build_and_run, base_slack)
