"""GPipe pipeline parallelism over a 'pp' mesh axis.

Counterpart of skypilot_tpu/parallel/pipeline.py.  The reference runs
the schedule as one ``lax.scan`` inside ``shard_map``, with the stages'
hand-offs as ``lax.ppermute``.  Here every rank is a process that runs
its own stage (parallel/mesh.py), and the schedule is a Python loop.

Schedule: plain GPipe fill-drain, as the reference's.  T = M + S - 1
ticks for M microbatches over S stages.  At tick t stage s computes
microbatch t - s, when there is one, and hands its output to stage
s + 1 (one send and one receive a rank and tick, over the pp ring).
An idle tick computes nothing; the reference computes garbage there and
masks it out, which gives the same result.  Only the last stage emits.
Its outputs are broadcast over pp, where the reference adds them over pp
in f32 with zeros from the other stages: the same bits, every dtype.

The whole schedule is one ``torch.autograd.Function``.  Its forward
keeps each microbatch's stage graph.  Its backward drives GPipe's drain
itself: microbatch M - 1 first, each stage's input gradient handed back
to stage s - 1 over the inverse ring, one tick at a time.  So every
rank issues its sends, receives and the stage's own collectives (tp,
fsdp, the sp ring, remat's recompute) in one fixed order, which
autograd's engine would not promise across microbatches.  The inputs
are replicated over pp and so are their gradients: the input's comes
from stage 0 (a broadcast) and the stacked parameters' from each stage
(a gather over pp), the reference's transposes.
"""
from __future__ import annotations

from typing import Any, Callable, List

import torch

from skypilot_tpu_torch.parallel import collectives

StageFn = Callable[[Any, torch.Tensor], torch.Tensor]


def _flatten(tree) -> List[torch.Tensor]:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flatten(tree[k])]
    return [tree]


def _unflatten(tree, leaves):
    it = iter(leaves)

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(node[k]) for k in sorted(node)}
        return next(it)
    return walk(tree)


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def stack_stages(layer_params, num_stages: int):
    """(L, ...) stacked layer params -> (S, L/S, ...) stage-major views
    (axis 0 is the stage)."""
    def reshape(x):
        n_layers = x.shape[0]
        assert n_layers % num_stages == 0, (
            f'{n_layers} layers not divisible by {num_stages} stages')
        return x.view(num_stages, n_layers // num_stages, *x.shape[1:])
    return _tree_map(reshape, layer_params)


class _Schedule:
    """One GPipe run on this rank: the stage's graphs of the forward,
    kept for the drain."""

    def __init__(self, stage_fn, tree, mesh, axis_name, num_microbatches,
                 keep: bool):
        self.stage_fn, self.tree, self.keep = stage_fn, tree, keep
        self.mesh, self.axis = mesh, axis_name
        self.m = num_microbatches
        self.s_count = mesh.axis_size(axis_name)
        self.stage = mesh.axis_index(axis_name)
        self.saved = []
        self.params = []

    def ticks(self) -> int:
        return self.m + self.s_count - 1

    def microbatch(self, t: int):
        m = t - self.stage
        return m if 0 <= m < self.m else None

    def hop(self, x: torch.Tensor, shift: int) -> torch.Tensor:
        return collectives.permute(x, self.mesh, self.axis, shift)

    def forward(self, h: torch.Tensor, leaves, input_grad: bool):
        x_mb = h.detach().reshape(self.m, h.shape[0] // self.m,
                                  *h.shape[1:])
        self.params = [leaf.detach()[self.stage].requires_grad_(self.keep)
                       for leaf in leaves]
        tree = _unflatten(self.tree, self.params)
        last = self.stage == self.s_count - 1
        outputs = torch.empty_like(x_mb)
        idle = torch.zeros_like(x_mb[0])
        self.saved = [None] * self.m
        state = None
        for t in range(self.ticks()):
            m = self.microbatch(t)
            y = None
            if m is not None:
                x = x_mb[m] if self.stage == 0 else state
                x = x.detach().requires_grad_(
                    self.keep and (input_grad or self.stage > 0))
                with torch.set_grad_enabled(self.keep):
                    y = self.stage_fn(tree, x)
                if self.keep:
                    self.saved[m] = (x, y)
                if last:
                    outputs[m] = y.detach()
            if t + 1 < self.ticks():
                state = self.hop(idle if y is None else y.detach(), 1)
        out = collectives.broadcast(outputs, self.mesh, self.axis,
                                    self.s_count - 1)
        return out.reshape(h.shape)

    def backward(self, grad_out: torch.Tensor, input_grad: bool):
        g_mb = grad_out.reshape(self.m, grad_out.shape[0] // self.m,
                                *grad_out.shape[1:])
        last = self.stage == self.s_count - 1
        acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
               for p in self.params]
        grad_h = torch.zeros_like(g_mb) if input_grad else None
        idle = torch.zeros_like(g_mb[0])
        g_state = None
        for t in reversed(range(self.ticks())):
            m = self.microbatch(t)
            gx = None
            if m is not None:
                x, y = self.saved[m]
                self.saved[m] = None
                gy = g_mb[m] if last else g_state
                inputs = ([x] if x.requires_grad else []) + self.params
                grads = torch.autograd.grad(y, inputs, gy,
                                            allow_unused=True)
                if x.requires_grad:
                    gx, grads = grads[0], grads[1:]
                for a, g in zip(acc, grads):
                    if g is not None:
                        a.add_(g)
                if self.stage == 0 and gx is not None and input_grad:
                    grad_h[m] = gx
            if t > 0:
                g_state = self.hop(idle if gx is None else gx, -1)
        leaf_grads = [collectives.all_gather(
            a.to(p.dtype), self.mesh, self.axis)
            for a, p in zip(acc, self.params)]
        self.params = []
        if input_grad:
            grad_h = collectives.broadcast(grad_h, self.mesh, self.axis, 0)
            grad_h = grad_h.reshape(grad_out.shape)
        return grad_h, leaf_grads


class _Pipeline(torch.autograd.Function):

    @staticmethod
    def forward(ctx, sched: _Schedule, h, *leaves):
        ctx.sched = sched
        return sched.forward(h, leaves, ctx.needs_input_grad[1])

    @staticmethod
    def backward(ctx, grad_out):
        grad_h, leaf_grads = ctx.sched.backward(
            grad_out.contiguous(), ctx.needs_input_grad[1])
        ctx.sched = None
        return (None, grad_h, *leaf_grads)


def pipeline_apply(stage_fn: StageFn, stage_params, h: torch.Tensor, *,
                   mesh, num_microbatches: int,
                   axis_name: str = 'pp') -> torch.Tensor:
    """Run h (B, ...) through the S stages of stage_fn over mesh axis
    `axis_name`; every rank of the axis returns the whole result.

    stage_params: a tree with a leading stage axis S (stack_stages'
    views), the same on every rank of the axis; this rank's stage is
    row axis_index(axis_name).  stage_fn(params_for_stage, h_mb) -> h_mb
    applies one stage to one microbatch of B / num_microbatches rows.

    The reference's ``seq_axis`` (the sequence split inside the manual
    region) has no counterpart: a rank's h is already its block of any
    other axis (llama.forward_pipelined's tokens are the rank's sequence
    block under sp), and stage_fn runs that axis's collectives itself."""
    num_stages = mesh.axis_size(axis_name)
    if num_stages == 1:
        return stage_fn(_tree_map(lambda x: x[0], stage_params), h)
    if h.shape[0] % num_microbatches:
        raise ValueError(f'batch {h.shape[0]} does not divide into '
                         f'{num_microbatches} microbatches')
    leaves = _flatten(stage_params)
    keep = torch.is_grad_enabled() and (
        h.requires_grad or any(x.requires_grad for x in leaves))
    sched = _Schedule(stage_fn, stage_params, mesh, axis_name,
                      num_microbatches, keep)
    return _Pipeline.apply(sched, h, *leaves)
