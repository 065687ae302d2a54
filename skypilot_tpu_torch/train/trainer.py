"""Training loop: loss, gradients and AdamW in PyTorch, on one card or
over a mesh of rank processes.

Counterpart of skypilot_tpu/train/trainer.py.  Without a mesh the
trainer runs on one device.  With one (``mesh=``, ``rules=``; one
process a rank, parallel/mesh.py) it holds this rank's blocks of the
parameters and of AdamW's moments under the rules, splits each batch by
``BATCH_SPEC``, adds each gradient in rank order over the data axes
(dp, fsdp, sp) that the model's own collectives have not summed it over
(a leaf split over fsdp comes back reduce-scattered over fsdp from the
model's gather), and clips by the norm of the global gradient, decided
on the device and the same on every rank.
The optimizer is the JAX package's ``optax.chain(clip_by_global_norm,
adamw(warmup_cosine_decay))`` written out in torch with optax's numerics,
updating the parameters and moments in place (the counterpart of the JAX
step's donation).  Checkpoints go through ``skypilot_tpu_torch.ckpt`` in
the JAX package's on-disk format, under the JAX Trainer's state keys
(``_state_dict``), so a run saved by either package resumes in the
other.  ``fit`` reports the JAX Trainer's metrics and ``train_fit``
steplog record.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import logging
import math
import os
import time
from typing import Any, Callable, Dict, Iterator, List, NamedTuple, Optional

import numpy as np
import torch

from skypilot_tpu_torch.ckpt import format as ckpt_format
from skypilot_tpu_torch.ckpt import manager as ckpt_manager
from skypilot_tpu_torch.device import resolve_device
from skypilot_tpu_torch.parallel import collectives
from skypilot_tpu_torch.parallel import sharding as sharding_lib
from skypilot_tpu_torch.telemetry import metrics as telemetry_metrics
from skypilot_tpu_torch.telemetry import steplog
from skypilot_tpu_torch.telemetry.profiler import profile_window
from skypilot_tpu_torch.utils import env_contract

logger = logging.getLogger(__name__)

# Dense bf16 tensor-core peak of one H100 SXM (NVIDIA data sheet): the
# default MFU denominator on a card.  On the CPU, 1e12 as the JAX package.
H100_BF16_FLOPS = 989e12
CPU_FLOPS = 1e12

# Opt-in per-step sync timing for run_step: a device synchronize per step
# gives honest step wall times but bills one round trip per step, so it
# must never be on during fit's end-to-end-timed steady block.
_STEP_METRICS_ENV = 'SKYTPU_STEP_METRICS'


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 3e-4
    weight_decay: float = 0.1
    warmup_steps: int = 100
    total_steps: int = 1000
    max_grad_norm: float = 1.0
    b1: float = 0.9
    b2: float = 0.95
    # Adam first-moment dtype ('bfloat16' halves mu's memory and
    # traffic).  None = the params' dtype.  The second moment always
    # takes the params' dtype, as optax gives it: bf16 params keep a bf16
    # nu.
    mu_dtype: Optional[str] = None


def warmup_cosine_decay_schedule(init_value: float, peak_value: float,
                                 warmup_steps: int, decay_steps: int,
                                 end_value: float = 0.0
                                 ) -> Callable[[int], float]:
    """optax.warmup_cosine_decay_schedule (exponent 1) of the step count:
    linear from init_value to peak_value over warmup_steps, then cosine
    down to end_value at decay_steps.  The count is the host's, so
    reading the schedule costs no device round trip."""
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    decay = decay_steps - warmup_steps
    if decay <= 0:
        raise ValueError('The cosine_decay_schedule requires positive '
                         f'decay_steps, got decay_steps={decay}.')

    def schedule(count: int) -> float:
        if count < warmup_steps:
            frac = 1.0 - min(max(count, 0), warmup_steps) / warmup_steps
            return (init_value - peak_value) * frac + peak_value
        t = min(count - warmup_steps, decay)
        cosine = 0.5 * (1.0 + math.cos(math.pi * t / decay))
        return peak_value * ((1.0 - alpha) * cosine + alpha)

    return schedule


@functools.lru_cache(maxsize=1024)
def _in_dtype(x: float, dtype: torch.dtype) -> float:
    """x rounded to `dtype`, as a Python float.  JAX casts a Python
    scalar to the dtype of the array it meets (a bf16 leaf multiplies by
    bf16(0.1)); torch would keep it in f32, so every scalar of the update
    goes through here first."""
    return torch.tensor(x, dtype=torch.float32).to(dtype).item()


def global_norm(leaves: List[torch.Tensor]) -> torch.Tensor:
    """optax.global_norm: sqrt of the sum of each leaf's sum of squares,
    each in the leaf's dtype, on the device."""
    return torch.sqrt(sum(torch.sum(x * x) for x in leaves))


class Optimizer:
    """``chain(clip_by_global_norm(max_grad_norm), adamw(schedule, b1, b2,
    weight_decay, mu_dtype))`` with optax's numerics: the clip scales by
    max_norm / norm only when norm >= max_norm (no epsilon, decided on
    the device); the schedule is read at the count before the update;
    eps 1e-8 outside the root, eps_root 0; weight decay lr * wd * p on
    every leaf; mu in mu_dtype (default the leaf's), nu in the leaf's."""

    eps = 1e-8

    def __init__(self, config: TrainConfig):
        self.config = config
        self.schedule = warmup_cosine_decay_schedule(
            init_value=0.0, peak_value=config.learning_rate,
            warmup_steps=config.warmup_steps,
            decay_steps=max(config.total_steps, config.warmup_steps + 1),
            end_value=config.learning_rate * 0.1)
        self.mu_dtype = (getattr(torch, config.mu_dtype)
                         if config.mu_dtype else None)

    def init(self, params: List[torch.Tensor]) -> Dict[str, Any]:
        return {'count': 0,
                'mu': [torch.zeros_like(p, dtype=self.mu_dtype or p.dtype)
                       for p in params],
                'nu': [torch.zeros_like(p) for p in params]}

    @torch.no_grad()
    def update(self, grads: List[torch.Tensor], state: Dict[str, Any],
               params: List[torch.Tensor],
               g_norm: Optional[torch.Tensor] = None) -> torch.Tensor:
        """One step on `params` in place; advances `state`.  Returns the
        global norm of `grads` (before the clip), on the device; a mesh
        passes the global gradient's (`g_norm`), of which `grads` are
        this rank's blocks."""
        c = self.config
        if g_norm is None:
            g_norm = global_norm(grads)
        keep = g_norm < c.max_grad_norm
        count = state['count']
        lr = self.schedule(count)
        # The bias corrections in f32, as optax computes them.
        bc1 = float(1 - np.float32(c.b1) ** (count + 1))
        bc2 = float(1 - np.float32(c.b2) ** (count + 1))

        def like(x: float, t: torch.Tensor) -> float:
            return _in_dtype(x, t.dtype)

        for i, (g, p) in enumerate(zip(grads, params)):
            g = torch.where(keep, g, (g / g_norm.to(g.dtype))
                            * like(c.max_grad_norm, g))
            mu, nu = state['mu'][i], state['nu'][i]
            mu = like(1 - c.b1, g) * g + like(c.b1, mu) * mu
            nu = like(1 - c.b2, g) * (g * g) + like(c.b2, nu) * nu
            mu_hat = mu / like(bc1, mu)
            nu_hat = nu / like(bc2, nu)
            u = mu_hat / (torch.sqrt(nu_hat) + like(self.eps, nu_hat))
            u = u + like(c.weight_decay, p) * p
            u = u * like(-lr, u)
            p.copy_(p + u)
            state['mu'][i] = mu.to(self.mu_dtype) if self.mu_dtype else mu
            state['nu'][i] = nu
        state['count'] = count + 1
        return g_norm


# The JAX package's make_optimizer(config): clip by global norm, then AdamW
# on the warmup-cosine schedule, as one Optimizer.
make_optimizer = Optimizer


def synthetic_batches(batch_size: int, seq_len: int, vocab_size: int,
                      seed: int = 0) -> Iterator[Dict[str, np.ndarray]]:
    """Deterministic synthetic token stream (benches / smoke tests): the
    JAX package's draws, so both packages see the same tokens."""
    rng = np.random.default_rng(seed)
    while True:
        yield {'tokens': rng.integers(
            0, vocab_size, (batch_size, seq_len + 1), dtype=np.int32)}


def tree_leaves(tree: Any) -> List[torch.Tensor]:
    """The leaves of a nested dict in ``jax.tree.leaves`` order (keys
    sorted), so leaf lists compare one to one across the packages."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def tree_map(fn: Callable[[torch.Tensor], Any], tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


# optax's chain state for make_optimizer, as the JAX Trainer checkpoints
# it: (clip: EmptyState, (adamw's ScaleByAdamState, add_decayed_weights:
# EmptyState, ScaleByScheduleState)).  The flatten of ckpt.format renders
# a field as `.name`, so these give the JAX package's leaf keys.
class EmptyState(NamedTuple):
    pass


class ScaleByAdamState(NamedTuple):
    count: Any
    mu: Any
    nu: Any


class ScaleByScheduleState(NamedTuple):
    count: Any


# The mesh axes over which ranks see different tokens: a gradient is a
# partial sum over each of them that the model has not summed it over.
DATA_AXES = ('dp', 'fsdp', 'sp')


class Trainer:
    """Runs train steps of `loss_fn(params, batch)` on one device, or on
    this rank's blocks of a mesh.

    The trainer owns the parameter tensors it is given: it updates them
    in place.  ``Trainer(loss_fn, params, config).fit(batches,
    num_steps, ...)`` on one device; the device is the CUDA card unless
    `device` says otherwise.  With ``mesh=`` and ``rules=`` (the
    reference's ``Trainer(loss_fn, params, mesh, rules, config)``),
    params is the global tree (numpy arrays or tensors), cut here to
    this rank's blocks, or those blocks already (``params_sharded``,
    e.g. from ``init_params(..., shard=sharding.init_shard(...))``);
    loss_fn takes this rank's blocks and its rows of the batch and must
    return the global batch's loss on every rank (``llama.loss_fn(...,
    mesh=mesh)``).  Call ``run_step`` (and ``fit``) on the main thread
    when emergency saves are on: the signal handler runs there, and the
    trainer holds it off while a step writes the state."""

    def __init__(self, loss_fn: Callable[[Any, Dict[str, torch.Tensor]],
                                         torch.Tensor],
                 params: Any, config: TrainConfig = TrainConfig(),
                 device=None, *, mesh=None,
                 rules: Optional[sharding_lib.PartitionRules] = None,
                 params_sharded: bool = False):
        self.device = resolve_device(device)
        self.config = config
        self.tx = make_optimizer(config)
        self.mesh = mesh
        if mesh is not None:
            if rules is None:
                raise ValueError('a mesh needs its partition rules')
            if not params_sharded:
                params = sharding_lib.shard_params(params, mesh, rules)
            self._shardings = tree_leaves(
                sharding_lib.param_shardings(params, mesh, rules))
        self.params = tree_map(
            lambda p: torch.as_tensor(p).detach().to(self.device)
            .requires_grad_(), params)
        self._leaves = tree_leaves(self.params)
        self.opt_state = self.tx.init(self._leaves)
        self.step = 0
        self._loss_fn = loss_fn
        self._ckpt_managers: Dict[str, ckpt_manager.CheckpointManager] = {}
        self._auto_ckpt = None  # set by enable_checkpointing

    @property
    def world(self) -> int:
        """The ranks of the mesh (1 without one)."""
        return 1 if self.mesh is None else self.mesh.size

    @property
    def shared_card(self) -> bool:
        """Ranks of a gloo mesh on CUDA devices, which share cards."""
        return (self.mesh is not None and self.world > 1
                and self.mesh.backend == 'gloo'
                and self.device.type == 'cuda')

    def _to_device(self, value) -> torch.Tensor:
        t = torch.as_tensor(value)
        if self.device.type == 'cuda':
            # From pinned memory the copy is asynchronous: a pageable
            # copy would wait for the previous step to finish.
            t = t.pin_memory()
        return t.to(self.device, non_blocking=True)

    def run_step(self, batch: Dict[str, np.ndarray]
                 ) -> Dict[str, torch.Tensor]:
        """One step; returns {'loss', 'grad_norm'} as device scalars
        (reading them waits for the step).  With ``SKYTPU_STEP_METRICS``
        set, the step ends in a device synchronize and its wall time is
        observed as ``TRAIN_STEP_SECONDS{phase="sync"}``."""
        sync = bool(os.environ.get(_STEP_METRICS_ENV))
        start = time.perf_counter() if sync else 0.0
        if self.mesh is not None:
            batch = {k: sharding_lib.shard_tensor(torch.as_tensor(v),
                                                  sharding_lib.BATCH_SPEC,
                                                  self.mesh)
                     for k, v in batch.items()}
        batch = {k: self._to_device(v) for k, v in batch.items()}
        loss = self._loss_fn(self.params, batch)
        grads = list(torch.autograd.grad(loss, self._leaves))
        g_norm = None
        if self.mesh is not None:
            grads = self._sum_over_data(grads)
            g_norm = self._global_norm(grads)
        with self._holding_signals():
            grad_norm = self.tx.update(grads, self.opt_state, self._leaves,
                                       g_norm)
            self.step += 1
        telemetry_metrics.TRAIN_STEPS.inc()
        if self._auto_ckpt is not None and \
                self._auto_ckpt.should_save(self.step):
            # Async: the loop pays only the device->host snapshot (which
            # also waits for this step); bytes hit disk on the writer
            # thread while later steps run.
            self._save(self._auto_ckpt, blocking=False)
        if sync:
            if self.device.type == 'cuda':
                torch.cuda.synchronize(self.device)
            telemetry_metrics.TRAIN_STEP_SECONDS.labels(phase='sync').observe(
                time.perf_counter() - start)
        return {'loss': loss.detach(), 'grad_norm': grad_norm}

    def _sum_over_data(self, grads: List[torch.Tensor]
                       ) -> List[torch.Tensor]:
        """Each gradient added in rank order over the data axes its leaf
        is not split over (a leaf split over fsdp arrives already
        reduce-scattered over fsdp by the model's gather)."""
        out = []
        for g, sh in zip(grads, self._shardings):
            split = sharding_lib.spec_axes(sh.spec)
            axes = tuple(a for a in DATA_AXES if a not in split)
            out.append(collectives.all_reduce_sum(g, self.mesh, axes))
        return out

    def _global_norm(self, grads: List[torch.Tensor]) -> torch.Tensor:
        """The norm of the global gradient: each leaf's sum of squares
        (in its dtype, as global_norm) added in rank order over the axes
        its leaf is split over, so a replicated block counts once; then
        the leaves' in leaf order.  The same bits on every rank."""
        sums = [torch.sum(g * g) for g in grads]
        groups: Dict[tuple, List[int]] = {}
        for i, (s, sh) in enumerate(zip(sums, self._shardings)):
            axes = tuple(a for a in sharding_lib.spec_axes(sh.spec)
                         if self.mesh.axis_size(a) > 1)
            groups.setdefault((axes, s.dtype), []).append(i)
        for (axes, _), idx in groups.items():
            if axes:
                total = collectives.all_reduce_sum(
                    torch.stack([sums[i] for i in idx]), self.mesh, axes)
                for j, i in enumerate(idx):
                    sums[i] = total[j]
        return torch.sqrt(sum(sums))

    def _holding_signals(self):
        """The optimizer writes the state leaf by leaf: an emergency save
        that ran in between would commit a mix of two steps.  Hold the
        auto-checkpoint manager's signals until the state is whole."""
        if self._auto_ckpt is None:
            return contextlib.nullcontext()
        return self._auto_ckpt.hold_signals()

    def fit(self, batches: Iterator[Dict[str, np.ndarray]], num_steps: int,
            log_every: int = 10,
            tokens_per_batch: Optional[int] = None,
            flops_per_token: Optional[float] = None,
            peak_flops: Optional[float] = None) -> Dict[str, float]:
        """Run steps; returns a summary with steady-state throughput.

        Timing as the JAX package's: the warmup steps end each in a host
        fetch, then the steady block is timed end to end with one fetch
        at its end.  With tokens_per_batch, tokens/s; with
        flops_per_token as well, MFU = achieved / peak_flops (default:
        989e12, one H100's dense bf16 peak, on a card; 1e12 on the
        CPU).

        Telemetry as the JAX Trainer's: each warmup step observed
        (phase=warmup), the steady block as its per-step average
        (phase=steady), the loss, grad-norm, tokens/s and MFU gauges,
        and a ``train_fit`` steplog record; the steady block runs inside
        a ``SKYTPU_PROFILE_DIR`` profiler window."""
        if num_steps <= 0:
            return {'loss': float('nan'), 'step_time_s': float('nan')}
        if self.mesh is not None and self.mesh.rank != 0:
            log_every = 0        # one rank logs: all hold the same loss
        warmup = min(max(1, min(num_steps // 3, 4)), num_steps - 1)
        last_metrics: Dict[str, torch.Tensor] = {}
        for _ in range(warmup):
            step_start = time.perf_counter()
            last_metrics = self.run_step(next(batches))
            loss = float(last_metrics['loss'])  # host fetch = barrier
            telemetry_metrics.TRAIN_STEP_SECONDS.labels(
                phase='warmup').observe(time.perf_counter() - step_start)
            if log_every:
                print(f'warmup step {self.step}: loss={loss:.4f}')
        timed = num_steps - warmup
        with profile_window('trainer_fit'):
            start = time.perf_counter()
            for i in range(timed):
                last_metrics = self.run_step(next(batches))
                if log_every and (i + 1) % log_every == 0:
                    print(f'step {self.step} dispatched')
            final_loss = float(last_metrics['loss'])  # barrier, the block
            step_time = (time.perf_counter() - start) / timed
        grad_norm = float(last_metrics['grad_norm'])
        for _ in range(timed):
            telemetry_metrics.TRAIN_STEP_SECONDS.labels(
                phase='steady').observe(step_time)
        telemetry_metrics.TRAIN_LOSS.set(final_loss)
        telemetry_metrics.TRAIN_GRAD_NORM.set(grad_norm)
        out = {'loss': final_loss, 'step_time_s': step_time,
               'grad_norm': grad_norm}
        if tokens_per_batch:
            out['tokens_per_sec'] = tokens_per_batch / step_time
            telemetry_metrics.TRAIN_TOKENS_PER_SEC.set(out['tokens_per_sec'])
            if flops_per_token:
                if peak_flops is None:
                    peak_flops = (H100_BF16_FLOPS
                                  if self.device.type == 'cuda'
                                  else CPU_FLOPS) * self.world
                    if self.shared_card and log_every:
                        print(f'note: MFU over {self.world} x the peak of '
                              f'one card, with {self.world} gloo ranks on '
                              f'one card: not a multi-card rate')
                out['mfu'] = (flops_per_token * out['tokens_per_sec']
                              / peak_flops)
                telemetry_metrics.TRAIN_MFU.set(out['mfu'])
        if steplog.enabled():
            steplog.write({'kind': 'train_fit', 'step': self.step,
                           'step_time_s': step_time, 'loss': final_loss,
                           'grad_norm': grad_norm,
                           'tokens_per_sec': out.get('tokens_per_sec'),
                           'mfu': out.get('mfu')})
        return out

    # ---- checkpointing (skypilot_tpu_torch.ckpt, the JAX package's
    # sharded format and state keys) ---------------------------------------
    def checkpoint_manager(self, path: str, **manager_kwargs):
        """The (cached) CheckpointManager for one checkpoint root."""
        manager = self._ckpt_managers.get(path)
        if manager is None:
            manager = ckpt_manager.CheckpointManager(path, **manager_kwargs)
            self._ckpt_managers[path] = manager
        return manager

    def enable_checkpointing(self, path: str,
                             save_interval_steps: int = 0,
                             keep_last: Optional[int] = None,
                             keep_every: Optional[int] = None,
                             emergency_save: bool = True):
        """Attach auto-checkpointing to the step loop: every
        ``save_interval_steps`` steps run_step kicks off an ASYNC save
        (the loop stalls only for the device->host snapshot), retention
        GC applies keep_last/keep_every after each commit, and — with
        emergency_save — SIGTERM triggers one blocking save of the state
        between two steps before the process dies.  On a mesh the
        interval saves block (every rank writes its windows and meets the
        others at the commit), and there is no emergency save: a signal
        reaches one rank, and a save needs all of them.  Returns the
        manager."""
        manager = self.checkpoint_manager(
            path, save_interval_steps=save_interval_steps,
            keep_last=keep_last, keep_every=keep_every)
        manager.save_interval_steps = save_interval_steps
        manager.keep_last = keep_last
        manager.keep_every = keep_every
        manager.register_state_provider(
            lambda: (self.step, self._state_dict()))
        if emergency_save and self.world == 1:
            manager.install_signal_handlers()
        self._auto_ckpt = manager
        return manager

    def _state_dict(self):
        """The JAX Trainer's state tree: params, and optax's chain state
        with the one host count as both int32 counts (Adam's and the
        schedule's, equal in every run)."""
        count = torch.tensor(self.opt_state['count'], dtype=torch.int32)
        params, mu, nu = self.params, self.opt_state['mu'], \
            self.opt_state['nu']
        if self.mesh is not None:
            # This rank's windows of the global leaves, each written by
            # its one owner.
            count = ckpt_format.Shard(count, (), [],
                                      owner=self.mesh.rank == 0)
            params, mu, nu = (ckpt_format.tree_unflatten(self.params, [
                self._window(x, sh) for x, sh in
                zip(leaves, self._shardings)]) for leaves in
                (self._leaves, mu, nu))
        else:
            mu = ckpt_format.tree_unflatten(self.params, mu)
            nu = ckpt_format.tree_unflatten(self.params, nu)
        adam = ScaleByAdamState(count=count, mu=mu, nu=nu)
        return {'params': params,
                'opt_state': (EmptyState(),
                              (adam, EmptyState(),
                               ScaleByScheduleState(count=count)))}

    def _window(self, x: torch.Tensor, sh) -> ckpt_format.Shard:
        shape = sharding_lib.global_shape(sh.spec, x.shape, self.mesh)
        return ckpt_format.Shard(x, shape, sh.bounds(shape), sh.owner)

    def save_checkpoint(self, path: str, blocking: bool = True) -> None:
        """Checkpoint params + optimizer state at the current step.

        blocking=False returns after the device->host snapshot and lets
        the background writer commit the bytes — call
        ``wait_for_checkpoints`` (or rely on the atomic commit: an
        unfinished save is simply invisible to restore)."""
        self._save(self.checkpoint_manager(path), blocking)

    def _save(self, manager, blocking: bool) -> None:
        """A save of the state at this step.  On a mesh every save is
        blocking and ends in a barrier, so every rank sees the step
        committed when it returns (the writers rendezvous in the
        manager's barriers, which a writer thread must not race)."""
        if self.mesh is None or self.world == 1:
            manager.save(self.step, self._state_dict(), blocking=blocking)
            return
        manager.save(self.step, self._state_dict(), blocking=True)
        import torch.distributed as dist
        dist.barrier()

    def wait_for_checkpoints(self, path: Optional[str] = None) -> None:
        """Drain in-flight async saves (all roots, or one)."""
        managers = ([self._ckpt_managers[path]] if path is not None
                    else list(self._ckpt_managers.values()))
        for manager in managers:
            manager.wait_until_finished()

    def close(self) -> None:
        """Shut down every cached CheckpointManager: drains and joins
        each async writer thread and uninstalls signal handlers.  Safe
        to call more than once."""
        managers, self._ckpt_managers = list(
            self._ckpt_managers.values()), {}
        self._auto_ckpt = None
        for manager in managers:
            manager.close()

    def _install_restored(self, step: int, restored) -> None:
        """Copy a restored state into the live tensors, in place: the
        parameters stay the tensors autograd differentiates against
        (``_leaves``), so training goes on from the restored values."""
        adam, _, schedule = restored['opt_state'][1]
        counts = {int(adam.count), int(schedule.count)}
        if len(counts) != 1:
            raise ValueError(f'checkpoint step {step}: Adam count '
                             f'{int(adam.count)} and schedule count '
                             f'{int(schedule.count)} differ; this trainer '
                             f'keeps one count')
        pairs = [(dst, src) for dsts, srcs in (
            (self._leaves, tree_leaves(restored['params'])),
            (self.opt_state['mu'], tree_leaves(adam.mu)),
            (self.opt_state['nu'], tree_leaves(adam.nu)))
            for dst, src in zip(dsts, srcs)]
        for dst, src in pairs:
            if dst.shape != src.shape or dst.dtype != src.dtype:
                raise ValueError(
                    f'checkpoint step {step}: a leaf of shape '
                    f'{tuple(src.shape)} {src.dtype} for a trainer leaf '
                    f'of {tuple(dst.shape)} {dst.dtype}')
        with self._holding_signals(), torch.no_grad():
            for dst, src in pairs:
                dst.copy_(src)
            self.opt_state['count'] = counts.pop()
            self.step = step

    def restore_checkpoint(self, path: str, step: int) -> None:
        """Restore an explicit step (hash-verified)."""
        restored = self.checkpoint_manager(path).restore(
            step, self._state_dict())
        self._install_restored(step, restored)

    def restore_latest(self, path: str) -> Optional[int]:
        """Restore the newest COMMITTED checkpoint under ``path``,
        skipping uncommitted/corrupt steps.  Returns the restored step,
        or None when no trustworthy checkpoint exists (state is left
        untouched).

        Elastic resume: when the checkpoint was written by a different
        process grid than this run's (``SKYTPU_RESUME_TOPOLOGY``), the
        manager restores through ``restore_resharded``: each leaf is
        assembled from its global index-map."""
        manager = self.checkpoint_manager(path)
        writer_grid = env_contract.resume_topology()
        if writer_grid is not None and writer_grid != manager.process_count:
            logger.info(
                f'Elastic resume: checkpoint written by a '
                f'{writer_grid}-process grid, this run has '
                f'{manager.process_count}; restore will reshard')
        result = manager.restore_latest(self._state_dict())
        if result is None:
            return None
        step, restored = result
        self._install_restored(step, restored)
        return step
