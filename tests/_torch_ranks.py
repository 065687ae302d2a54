"""Rank processes for the port's mesh tests (test_torch_mesh.py,
test_torch_tp.py, test_torch_multihost.py).

This module imports torch and the port, never jax nor the JAX package:
the spawned children import it (and only it) to run their side.  A
RankPool starts `world` processes once, joined over gloo on the CPU, and
runs each case's function on every rank; the functions below take numpy
inputs and return numpy outputs, which the tests hold against the JAX
package in the parent.
"""
from __future__ import annotations

import multiprocessing
import os
import queue
import socket
import traceback
from datetime import timedelta

import numpy as np

_TIMEOUT_S = 240


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(('localhost', 0))
        return s.getsockname()[1]


def _serve(rank, world, port, inbox, outbox):
    os.environ.setdefault('OMP_NUM_THREADS', '1')
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    try:
        dist.init_process_group(
            'gloo', init_method=f'tcp://localhost:{port}', world_size=world,
            rank=rank, timeout=timedelta(seconds=_TIMEOUT_S))
    except BaseException:
        outbox.put((rank, False, traceback.format_exc()))
        return
    outbox.put((rank, True, 'ready'))
    parent = os.getppid()
    while True:
        try:
            task = inbox.get(timeout=5)
        except queue.Empty:
            if os.getppid() != parent:
                break       # the pool's process died: do not linger
            continue
        if task is None:
            break
        name, kwargs = task
        try:
            outbox.put((rank, True, globals()[name](**kwargs)))
        except BaseException:
            outbox.put((rank, False, traceback.format_exc()))
    dist.destroy_process_group()


class RankPool:
    """`world` gloo rank processes, started once and reused: run(name,
    **kwargs) calls the function `name` of this module on every rank
    and returns the ranks' results in rank order.  A failed rank raises
    in the parent with its traceback, and the pool is restarted on the
    next run (its collectives may be torn)."""

    def __init__(self, world: int):
        self.world = world
        self._procs = []
        self._start()

    def _start(self):
        ctx = multiprocessing.get_context('spawn')
        port = _free_port()
        self._outbox = ctx.Queue()
        self._inboxes = [ctx.Queue() for _ in range(self.world)]
        self._procs = [ctx.Process(target=_serve, daemon=True,
                                   args=(r, self.world, port,
                                         self._inboxes[r], self._outbox))
                       for r in range(self.world)]
        for p in self._procs:
            p.start()
        self._collect()

    def _collect(self):
        results = {}
        try:
            for _ in range(self.world):
                rank, ok, out = self._outbox.get(timeout=_TIMEOUT_S)
                if not ok:
                    raise RuntimeError(f'rank {rank} failed:\n{out}')
                results[rank] = out
        except BaseException:
            self.close()
            raise
        return [results[r] for r in range(self.world)]

    def run(self, name: str, **kwargs):
        if not self._procs:
            self._start()
        for inbox in self._inboxes:
            inbox.put((name, kwargs))
        return self._collect()

    def close(self):
        for inbox, p in zip(self._inboxes, self._procs):
            if p.is_alive():
                try:
                    inbox.put(None)
                except (OSError, ValueError):
                    pass
        for p in self._procs:
            p.join(timeout=10)
            if p.is_alive():
                p.kill()
                p.join()
        self._procs = []


# ---- helpers on the rank side ---------------------------------------------

def _cfg(kind='llama', **kw):
    import torch
    from skypilot_tpu_torch.models import llama, moe
    kw['dtype'] = getattr(torch, kw.get('dtype', 'float32'))
    cls = moe.MoeConfig if kind == 'moe' else llama.LlamaConfig
    return cls(**kw)


def _params(tree, cfg):
    from skypilot_tpu_torch.models import llama
    return llama.params_from_numpy(tree, cfg, 'cpu')


def _mesh(tp, dp=1, n_kv_heads=None):
    from skypilot_tpu_torch.infer import tp as tp_lib
    return tp_lib.make_tp_mesh(tp, n_kv_heads=n_kv_heads, dp=dp)


def _np(x):
    import torch
    if x.dtype == torch.bfloat16:
        x = x.float()
    return x.detach().cpu().numpy()


# ---- cases ------------------------------------------------------------------

def collectives_case(seed, shape, dtype, axes_sizes, chunks_list):
    """Every collective of parallel/collectives.py on each rank's own
    seeded input: (this rank's input, its results)."""
    import torch
    from skypilot_tpu_torch.parallel import collectives as coll
    from skypilot_tpu_torch.parallel import mesh as mesh_lib
    import torch.distributed as dist
    names = tuple(axes_sizes)
    shape_m = tuple(axes_sizes.values())
    mesh = mesh_lib.Mesh(np.arange(dist.get_world_size()).reshape(shape_m),
                         names)
    rng = np.random.default_rng(seed + 1000 * mesh.rank)
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)
                         ).to(getattr(torch, dtype))
    out = {'x': _np(x), 'coords': mesh.coords}
    for ax in names:
        out[f'gather/{ax}'] = _np(coll.ring_all_gather(x, mesh, ax))
        out[f'gather_tiled/{ax}'] = _np(
            coll.ring_all_gather(x, mesh, ax, tiled=True))
        out[f'scatter/{ax}'] = _np(coll.ring_reduce_scatter(x, mesh, ax))
    out['allreduce'] = _np(coll.all_reduce_sum(x, mesh, names))
    for c in chunks_list:
        seen = []
        red, res = coll.pipelined_psum(
            x, mesh, names, chunks=c,
            on_chunk=lambda ci, lo, span: seen.append((ci, lo,
                                                       span.shape[-1])))
        out[f'psum/{c}'] = _np(red)
        out[f'psum_chunks/{c}'] = seen
    return out


def mesh_case(tp, dp, n_kv_heads):
    """The tp mesh's layout on this rank."""
    mesh = _mesh(tp, dp, n_kv_heads)
    return {'shape': dict(mesh.shape), 'coords': mesh.coords,
            'fiber_model': mesh.fiber(('tp', 'tpq')),
            'fiber_dp': mesh.fiber('dp') if 'dp' in mesh.axis_names
            else [mesh.rank]}


def layout_case(configs):
    """make_mesh / make_multislice_mesh's rank layout for each (dp, fsdp,
    tp, num_slices) in configs, and this rank's coordinates."""
    from skypilot_tpu_torch.parallel import mesh as mesh_lib
    out = []
    for dp, fsdp, tp, slices in configs:
        cfg = mesh_lib.MeshConfig(dp=dp, fsdp=fsdp, tp=tp)
        mesh = mesh_lib.make_multislice_mesh(cfg, slices)
        out.append({'ranks': mesh.devices.tolist(), 'coords': mesh.coords,
                    'fiber_dp': mesh.fiber('dp')})
    return out


def init_case(cfg_kw, kind, seed, tp, n_kv_heads):
    """init_sharded_params' blocks and their shapes on this rank."""
    import torch
    from skypilot_tpu_torch.infer import tp as tp_lib
    cfg = _cfg(kind, **cfg_kw)
    mesh = _mesh(tp, 1, n_kv_heads)
    gen = torch.Generator().manual_seed(seed)
    tree = tp_lib.init_sharded_params(cfg, gen, mesh, 'cpu')

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        return _np(node)
    return walk(tree)


def generate_case(tree, cfg_kw, kind, gen_kw, tp, dp, prompts, max_new,
                  shards=False, quantize=False):
    """Greedy tokens of Generator(mesh=) and the prefill logits of the
    same prompts (llama_infer.prefill under the mesh)."""
    import warnings

    import torch
    from skypilot_tpu_torch.infer import engine, llama_infer, quant
    from skypilot_tpu_torch.infer import tp as tp_lib
    warnings.simplefilter('ignore', DeprecationWarning)
    cfg = _cfg(kind, **cfg_kw)
    mesh = _mesh(tp, dp, cfg.n_kv_heads) if tp * dp > 1 else None
    params = _params(tree, cfg)
    if quantize:
        params = quant.quantize_weights(params)
    if shards:
        params = tp_lib.shard_params(params, mesh)
    gen_cfg = engine.GeneratorConfig(**gen_kw)
    g = engine.Generator(params, cfg, gen_cfg, mesh=mesh, device='cpu')
    toks = g.generate(prompts, max_new_tokens=max_new)
    bucket = max(len(p) for p in prompts)
    tokens = np.zeros((len(prompts), bucket), np.int32)
    for i, p in enumerate(prompts):
        tokens[i, :len(p)] = p
    cache = llama_infer.init_cache(tp_lib.local_config(cfg, mesh),
                                   len(prompts), bucket, device='cpu')
    with torch.no_grad():
        logits, _ = llama_infer.prefill(
            g.params, torch.from_numpy(tokens), cfg, cache,
            torch.tensor([len(p) for p in prompts]), mesh=mesh)
    return {'tokens': toks, 'logits': _np(logits), 'overlap': g.overlap,
            'shapes': {k: tuple(v.shape) for k, v in
                       g.params['layers']['attn'].items()
                       if not isinstance(v, dict)},
            'migrations': dict(g.migrations),
            'cache_heads': tp_lib.local_config(cfg, mesh).n_kv_heads}


def batcher_case(tree, cfg_kw, kind, gen_kw, tp, dp, requests,
                 decode_chunk=8):
    """The batcher's results under a mesh.  requests: (prompt,
    max_new_tokens) pairs."""
    import warnings

    from skypilot_tpu_torch.infer import engine
    from skypilot_tpu_torch.infer.serving import ContinuousBatcher
    warnings.simplefilter('ignore', DeprecationWarning)
    cfg = _cfg(kind, **cfg_kw)
    mesh = _mesh(tp, dp, cfg.n_kv_heads)
    b = ContinuousBatcher(_params(tree, cfg), cfg,
                          engine.GeneratorConfig(**gen_kw),
                          decode_chunk=decode_chunk, mesh=mesh,
                          device='cpu')
    rids = [b.submit(list(p), max_new_tokens=n) for p, n in requests]
    b.run_until_idle()
    fused = b._fuse_policy.stats.steps if b._fuse_policy else 0
    return {'results': [b.result(r) for r in rids], 'fused_steps': fused,
            'overlap': b.overlap, 'spec_proposed': b.spec_proposed,
            'graphs': b.graphs is None}


def overlap_case(tree, cfg_kw, gen_kw, tp, dp, prompts, max_new, chunks):
    """Generator tokens and each decode step's last hidden states (the
    input of the final norm) for each overlap chunk count (1: the
    synchronous path, overlap_collectives False)."""
    import dataclasses as dc
    from skypilot_tpu_torch.infer import engine, llama_infer
    cfg = _cfg(**cfg_kw)
    mesh = _mesh(tp, dp, cfg.n_kv_heads)
    params = _params(tree, cfg)
    out = {}
    orig = llama_infer._final
    for c in chunks:
        seen = []

        def final(h, *args):
            seen.append(_np(h))
            return orig(h, *args)
        llama_infer._final = final
        try:
            gen_cfg = dc.replace(engine.GeneratorConfig(**gen_kw),
                                 overlap_collectives=c > 1,
                                 overlap_chunks=c if c > 1 else None)
            g = engine.Generator(params, cfg, gen_cfg, mesh=mesh,
                                 device='cpu')
            toks = g.generate(prompts, max_new_tokens=max_new)
        finally:
            llama_infer._final = orig
        out[c] = {'tokens': toks, 'hidden': seen, 'overlap': g.overlap}
    return out


def combine_project_case(seed, rows, d_model, widths, chunks_list):
    """_combine_then_project on this rank's seeded partial (the same
    h, gain and weights on every rank) at each chunk count, and the
    synchronous path's h + _combine(partial), K3's plain version and
    the whole products."""
    import torch
    from skypilot_tpu_torch.infer import llama_infer
    from skypilot_tpu_torch.ops import rmsnorm as rmsnorm_ops
    mesh = _mesh(4, 1, None)
    gen = torch.Generator().manual_seed(seed)
    h = torch.randn(rows, 1, d_model, generator=gen)
    gain = 1.0 + 0.1 * torch.randn(d_model, generator=gen)
    weights = [torch.randn(d_model, f, generator=gen) * d_model ** -0.5
               for f in widths]
    part = torch.randn(rows, 1, d_model,
                       generator=torch.Generator().manual_seed(
                           seed + 1 + mesh.rank))
    h_sync = h + llama_infer._combine(part, mesh)
    x = rmsnorm_ops.rms_norm(h_sync, gain, eps=1e-5)
    out = {'sync': {'h': _np(h_sync), 'y': [_np(x @ w) for w in weights]}}
    for c in chunks_list:
        h_new, ys = llama_infer._combine_then_project(
            part, h, gain, weights, mesh, c, 1e-5)
        out[c] = {'h': _np(h_new), 'y': [_np(y) for y in ys]}
    return out


def graphs_case():
    """graphs=True under a gloo mesh raises with the reason; None
    resolves off and says why (checked with a CPU device, where graphs
    are off anyway, through the shared blocker)."""
    import torch
    from skypilot_tpu_torch.infer import engine
    mesh = _mesh(2, 1, None)
    return {'cuda': engine.graphs_blocker(torch.device('cuda'), mesh),
            'cuda_nomesh': engine.graphs_blocker(torch.device('cuda'), None)}


def collective_share_case(tree, cfg_kw, gen_kw, tp, share):
    """set_collective_share on a sharded batcher: the seconds moved to
    the 'collective' phase and the counter's delta."""
    from skypilot_tpu_torch.infer import engine
    from skypilot_tpu_torch.infer.serving import ContinuousBatcher
    from skypilot_tpu_torch.telemetry import metrics
    cfg = _cfg(**cfg_kw)
    mesh = _mesh(tp, 1, cfg.n_kv_heads)
    ticks = iter(range(10 ** 6))
    b = ContinuousBatcher(_params(tree, cfg), cfg,
                          engine.GeneratorConfig(**gen_kw), mesh=mesh,
                          device='cpu', profiler_clock=lambda: next(ticks))
    mode = 'sync' if b.overlap is None else 'overlapped'

    def counter():
        return metrics.REGISTRY.get_sample_value(
            'skytpu_infer_mesh_collective_seconds_total',
            {'mode': mode}) or 0.0
    before = counter()
    b.set_collective_share(share)
    collective = 0.0
    rid = b.submit([5, 9, 2, 7], max_new_tokens=6)
    while not b.is_done(rid):
        b.step()
        collective += b._profiler.last_phases.get('collective', 0.0)
    return {'collective': collective, 'counter': counter() - before,
            'devices': {a: metrics.REGISTRY.get_sample_value(
                'skytpu_infer_mesh_devices', {'axis': a})
                for a in mesh.shape},
            'per_shard': metrics.REGISTRY.get_sample_value(
                'skytpu_infer_mesh_pool_blocks_live_per_shard'),
            'result': b.result(rid)}


def hf_case(model_dir, tp, n_kv_heads):
    """load_hf_model_sharded's blocks on this rank."""
    from skypilot_tpu_torch.models import convert
    mesh = _mesh(tp, 1, n_kv_heads)
    params, cfg = convert.load_hf_model_sharded(model_dir, mesh,
                                                device='cpu')

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        return _np(node)
    return {'params': walk(params), 'n_layers': cfg.n_layers}


def hf_train_case(model_dir, mesh_kw):
    """load_hf_model_sharded's blocks under LLAMA_RULES on a training
    mesh, and the blocks shard_params cuts from the whole load."""
    from skypilot_tpu_torch.models import convert
    from skypilot_tpu_torch.parallel import sharding
    mesh = _train_mesh(mesh_kw)
    got, _ = convert.load_hf_model_sharded(model_dir, mesh, device='cpu',
                                           rules=sharding.LLAMA_RULES)
    full, _ = convert.load_hf_model(model_dir, device='cpu')
    want = sharding.shard_params(full, mesh, sharding.LLAMA_RULES)
    return {'got': _tree_np(got), 'want': _tree_np(want),
            'whole': _tree_np(full)}


def exit_on_rank_one(local_rank, world):
    """A launch_local_ranks target whose rank 1 exits with code 3."""
    if local_rank == 1:
        raise SystemExit(3)


# ---- training meshes (test_torch_train_mesh.py) ---------------------------

def _train_mesh(mesh_kw):
    from skypilot_tpu_torch.parallel import mesh as mesh_lib
    return mesh_lib.make_mesh(mesh_lib.MeshConfig(**mesh_kw))


def _trainer(tree, cfg_kw, kind, mesh_kw, tc_kw, batch_spec=None):
    import torch
    from skypilot_tpu_torch.models import llama, moe
    from skypilot_tpu_torch.parallel import sharding
    from skypilot_tpu_torch.train import trainer
    cfg = _cfg(kind, **cfg_kw)
    mesh = _train_mesh(mesh_kw) if mesh_kw else None
    model = moe if kind == 'moe' else llama
    rules = sharding.MOE_RULES if kind == 'moe' else sharding.LLAMA_RULES
    params = _params(tree, cfg)
    kw = {} if mesh is None else {'mesh': mesh, 'rules': rules}

    def loss(p, b):
        if mesh is None:
            return model.loss_fn(p, b, cfg)
        return model.loss_fn(p, b, cfg, mesh=mesh, rules=rules)
    del torch
    return trainer.Trainer(loss, params, trainer.TrainConfig(**tc_kw),
                           device='cpu', **kw), mesh, rules


def train_case(tree, cfg_kw, kind, mesh_kw, tc_kw, batches):
    """Trainer steps on `batches` (global (B, S + 1) token arrays) on
    this rank's blocks of `tree`: each step's loss and grad_norm (with
    their bits), and the parameters after, put back together."""
    from skypilot_tpu_torch.parallel import sharding
    tr, mesh, rules = _trainer(tree, cfg_kw, kind, mesh_kw, tc_kw)
    out = {'loss': [], 'grad_norm': [], 'bits': []}
    for b in batches:
        m = tr.run_step({'tokens': b})
        out['loss'].append(float(m['loss']))
        out['grad_norm'].append(float(m['grad_norm']))
        out['bits'].append((m['loss'].double().item(),
                            m['grad_norm'].double().item()))
    out['params'] = (sharding.gather_params(tr.params, mesh, rules)
                     if mesh is not None else
                     _tree_np(tr.params))
    return out


def _tree_np(tree):
    if isinstance(tree, dict):
        return {k: _tree_np(v) for k, v in tree.items()}
    return _np(tree)


def ckpt_save_case(tree, cfg_kw, kind, mesh_kw, tc_kw, batches, root,
                   restore_from=None):
    """Trainer steps on this rank's blocks (after restoring the newest
    step under `restore_from` when given), then a save under `root`;
    returns the state put back together, as train_case does."""
    from skypilot_tpu_torch.parallel import sharding
    tr, mesh, rules = _trainer(tree, cfg_kw, kind, mesh_kw, tc_kw)
    restored = None
    if restore_from is not None:
        restored = tr.restore_latest(restore_from)
    losses = [float(tr.run_step({'tokens': b})['loss']) for b in batches]
    if root is not None:
        tr.save_checkpoint(root)
    tr.close()

    def whole(leaves):
        from skypilot_tpu_torch.ckpt import format as ckpt_format
        t = ckpt_format.tree_unflatten(tr.params, leaves)
        return (sharding.gather_params(t, mesh, rules) if mesh is not None
                else _tree_np(t))
    return {'step': tr.step, 'restored': restored, 'losses': losses,
            'params': whole(tr._leaves), 'mu': whole(tr.opt_state['mu']),
            'nu': whole(tr.opt_state['nu'])}


def ring_case(q, k, v, do, mesh_kw, causal, head_axis):
    """parallel/ring_attention.ring_attention of the global q, k, v on
    this rank: its output block and where it lies, and the gradients of
    sum(out * do's block) with respect to the global q, k, v (this
    rank's share: the parent adds them over the ranks)."""
    import torch
    from skypilot_tpu_torch.parallel import ring_attention, sharding
    mesh = _train_mesh(mesh_kw)
    qt, kt, vt = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    out = ring_attention.ring_attention(
        qt, kt, vt, mesh, causal=causal, head_axis=head_axis)
    spec = sharding.P(('dp', 'fsdp'), 'sp', head_axis, None)
    bounds = sharding.block_bounds(spec, q.shape, mesh)
    d = torch.tensor(do)[tuple(slice(a, b) for a, b in bounds)]
    (out * d).sum().backward()
    return {'out': _np(out), 'bounds': bounds,
            'grads': [_np(t.grad) for t in (qt, kt, vt)]}


def grad_collectives_case(seed, dtype):
    """Each autograd collective of parallel/collectives.py on a
    dp 2 x tp 2 mesh: its forward and the gradient it sends back for a
    cotangent, for every rank's input drawn from `seed` + rank."""
    import torch
    from skypilot_tpu_torch.parallel import collectives
    mesh = _train_mesh({'dp': 2, 'tp': 2})
    dt = getattr(torch, dtype)
    g = torch.Generator().manual_seed(seed + mesh.rank)
    x = torch.randn(4, 6, generator=g).to(dt)
    ct = torch.randn(8, 6, generator=g).to(dt)
    out = {}
    cases = {
        'gather_scatter': (lambda t: collectives.gather_scatter(
            t, mesh, 'dp', 0), ct),
        'gather_scatter_dim1': (lambda t: collectives.gather_scatter(
            t, mesh, 'tp', 1), ct.reshape(4, 12)),
        'sum_forward': (lambda t: collectives.sum_forward(
            t, mesh, ('dp', 'tp')), ct[:4]),
        'sum_backward': (lambda t: collectives.sum_backward(
            t, mesh, 'tp'), ct[:4]),
        'split_gather': (lambda t: collectives.split_gather(
            t, mesh, 'dp', 0), ct[:2]),
        'ring_permute': (lambda t: collectives.ring_permute(
            t, mesh, 'tp'), ct[:4]),
    }
    for name, (fn, cot) in cases.items():
        t = x.clone().requires_grad_()
        y = fn(t)
        (grad,) = torch.autograd.grad(y, t, cot)
        out[name] = (_np(y), _np(grad))
    return {'rank': mesh.rank, 'coords': mesh.coords, 'results': out}


def forward_case(tree, cfg_kw, kind, mesh_kw, tokens):
    """The sharded forward on this rank: llama.forward's logits block
    (its rows over dp x fsdp, its sequence block over sp, its vocabulary
    block over tp), or moe.hidden_states' rows and sequence block and
    the aux loss, with the block's bounds."""
    import torch
    from skypilot_tpu_torch.models import llama, moe
    from skypilot_tpu_torch.parallel import sharding
    cfg = _cfg(kind, **cfg_kw)
    mesh = _train_mesh(mesh_kw)
    rules = sharding.MOE_RULES if kind == 'moe' else sharding.LLAMA_RULES
    params = sharding.shard_params(_params(tree, cfg), mesh, rules)
    t = torch.as_tensor(tokens)
    rows = sharding.shard_tensor(t, sharding.P(('dp', 'fsdp'), 'sp'), mesh)
    with torch.no_grad():
        if kind == 'moe':
            h, aux = moe.hidden_states(params, rows, cfg, mesh=mesh)
            spec, out = sharding.P(('dp', 'fsdp'), 'sp'), {
                'aux': float(aux)}
            shape = (t.shape[0], t.shape[1], cfg.d_model)
        else:
            h = llama.forward(params, rows, cfg, mesh=mesh)
            spec, out = sharding.LOGITS_SPEC, {}
            shape = (t.shape[0], t.shape[1], cfg.vocab_size)
    out.update(out=_np(h), bounds=sharding.block_bounds(spec, shape, mesh))
    return out


# ---- pipelines (test_torch_pipeline.py) -----------------------------------

def _pp_loss(cfg, mesh, rules, num_microbatches, sequence_axis=None):
    import functools
    from skypilot_tpu_torch.models import llama
    fwd = functools.partial(llama.forward_pipelined, mesh=mesh,
                            num_microbatches=num_microbatches,
                            sequence_axis=sequence_axis)

    def loss(p, b):
        return llama.loss_fn(p, b, cfg, mesh=mesh, rules=rules,
                             forward_fn=fwd)
    return loss


def pipeline_case(tree, cfg_kw, mesh_kw, tokens, num_microbatches,
                  sequence_axis=None):
    """forward_pipelined on this rank: its logits block (rows over dp x
    fsdp, sequence block over sp, vocabulary block over tp) and where it
    lies; then the loss of loss_fn(forward_fn=forward_pipelined) on the
    global batch `tokens` (B, S + 1) and its gradient, summed over the
    data axes as the Trainer sums it and put back together."""
    import torch
    from skypilot_tpu_torch.models import llama
    from skypilot_tpu_torch.parallel import sharding
    from skypilot_tpu_torch.train import trainer
    cfg = _cfg('llama', **cfg_kw)
    mesh = _train_mesh(mesh_kw)
    rules = sharding.LLAMA_RULES
    params = sharding.shard_params(_params(tree, cfg), mesh, rules)
    t = torch.as_tensor(tokens)
    rows = sharding.shard_tensor(t[:, :-1], sharding.BATCH_SPEC, mesh)
    shards = llama.Shards(mesh, rules)
    n = rows.shape[1] // shards.sp
    block = rows[:, shards.sp_index * n:(shards.sp_index + 1) * n]
    with torch.no_grad():
        logits = llama.forward_pipelined(
            params, block, cfg, mesh=mesh,
            num_microbatches=num_microbatches, sequence_axis=sequence_axis)
    spec = sharding.LOGITS_SPEC
    shape = (t.shape[0], t.shape[1] - 1, cfg.vocab_size)
    tr = trainer.Trainer(_pp_loss(cfg, mesh, rules, num_microbatches,
                                  sequence_axis), params,
                         device='cpu', mesh=mesh, rules=rules,
                         params_sharded=True)
    batch = {'tokens': sharding.shard_tensor(t, sharding.BATCH_SPEC, mesh)}
    loss = tr._loss_fn(tr.params, batch)
    grads = tr._sum_over_data(list(torch.autograd.grad(loss, tr._leaves)))
    from skypilot_tpu_torch.ckpt import format as ckpt_format
    g_tree = ckpt_format.tree_unflatten(tr.params, grads)
    return {'out': _np(logits), 'bounds': sharding.block_bounds(
        spec, shape, mesh), 'loss': float(loss.detach()),
        'grads': sharding.gather_params(g_tree, mesh, rules)}


def pp_train_case(tree, cfg_kw, mesh_kw, tc_kw, batches, num_microbatches,
                  sequence_axis=None):
    """train_case with the pipelined loss: each step's loss and grad
    norm (and their bits), and the parameters after, put together."""
    from skypilot_tpu_torch.parallel import sharding
    from skypilot_tpu_torch.train import trainer
    cfg = _cfg('llama', **cfg_kw)
    mesh = _train_mesh(mesh_kw)
    rules = sharding.LLAMA_RULES
    tr = trainer.Trainer(_pp_loss(cfg, mesh, rules, num_microbatches,
                                  sequence_axis), _params(tree, cfg),
                         trainer.TrainConfig(**tc_kw), device='cpu',
                         mesh=mesh, rules=rules)
    out = {'loss': [], 'grad_norm': [], 'bits': []}
    for b in batches:
        m = tr.run_step({'tokens': b})
        out['loss'].append(float(m['loss']))
        out['grad_norm'].append(float(m['grad_norm']))
        out['bits'].append((m['loss'].double().item(),
                            m['grad_norm'].double().item()))
    out['params'] = sharding.gather_params(tr.params, mesh, rules)
    return out


def pipeline_apply_case(mesh_kw, num_microbatches, seed):
    """pipeline_apply of a plain stage function (per stage two layers of
    h -> tanh(h * w_l + b_l), 4 layers in all) over the mesh's pp
    stages, on h (8, 8, 4) in `num_microbatches` microbatches: the
    output and the gradients of sum(out * c) with respect to h and to
    the stacked weights.  mesh_kw None: the layers one after another on
    this process."""
    import torch
    from skypilot_tpu_torch.parallel import pipeline
    gen = torch.Generator().manual_seed(seed)
    h = torch.randn(8, 8, 4, generator=gen).requires_grad_()
    layers = {'w': torch.randn(4, 4, generator=gen),
              'b': torch.randn(4, 4, generator=gen)}
    layers = {k: v.requires_grad_() for k, v in layers.items()}
    c = torch.randn(8, 8, 4, generator=gen)

    def stage_fn(p, x):
        for i in range(p['w'].shape[0]):
            x = torch.tanh(x * p['w'][i] + p['b'][i])
        return x
    if mesh_kw is None:
        out = stage_fn(layers, h)
    else:
        mesh = _train_mesh(mesh_kw)
        out = pipeline.pipeline_apply(
            stage_fn, pipeline.stack_stages(layers, mesh.axis_size('pp')),
            h, mesh=mesh, num_microbatches=num_microbatches)
    gh, gw = torch.autograd.grad((out * c).sum(), [h, layers['w']])
    return {'out': _np(out), 'grad_h': _np(gh), 'grad_w': _np(gw)}


def pp_sp_refused_case(cfg_kw):
    """forward_pipelined on a pp 2 x sp 2 mesh without sequence_axis
    raises; returns the message."""
    import torch
    from skypilot_tpu_torch.models import llama
    cfg = _cfg('llama', **cfg_kw)
    mesh = _train_mesh({'pp': 2, 'sp': 2})
    try:
        llama.forward_pipelined({}, torch.zeros((2, 8), dtype=torch.long),
                                cfg, mesh=mesh, num_microbatches=2)
    except ValueError as e:
        return str(e)
    return 'not refused'


# ---- post-training meshes (test_torch_sft.py) ------------------------------

def lora_mesh_case(kind, tree, adapters, cfg_kw, lcfg_kw, mesh_kw, tc_kw,
                   batches, beta=0.1):
    """LoRA-SFT (kind 'sft') or LoRA-DPO ('dpo') steps of the adapters
    `adapters` (a numpy tree) over the frozen base `tree`, on this
    rank's blocks of a mesh (mesh_kw) or one device (None): each step's
    loss and grad norm (and their bits), the adapters after, and their
    merge with the base put together (lora.merge_lora: on a mesh rank
    0's, None on the others)."""
    import torch
    from skypilot_tpu_torch.parallel import sharding
    from skypilot_tpu_torch.train import dpo, lora, sft, trainer
    cfg = _cfg('llama', **cfg_kw)
    mesh = _train_mesh(mesh_kw) if mesh_kw else None
    rules = sharding.LLAMA_RULES
    base = _params(tree, cfg)
    if mesh is not None:
        base = sharding.shard_params(base, mesh, rules)
    lcfg = lora.LoraConfig(**lcfg_kw)
    if kind == 'sft':
        loss = lora.wrap_loss(
            lambda p, b: sft.sft_loss_fn(p, b, cfg, mesh=mesh, rules=rules),
            base, lcfg, mesh, rules)
    else:
        def loss(ad, b):
            policy = lora.apply_lora(base, ad, lcfg, mesh, rules)
            return dpo.dpo_loss_fn(policy, base, b, cfg, beta=beta,
                                   mesh=mesh, rules=rules)
    kw = {} if mesh is None else {'mesh': mesh, 'rules': lora.LORA_RULES}
    tr = trainer.Trainer(loss, lora.adapters_from_numpy(adapters, 'cpu'),
                         trainer.TrainConfig(**tc_kw), device='cpu', **kw)
    out = {'loss': [], 'grad_norm': [], 'bits': []}
    for b in batches:
        m = tr.run_step(b)
        out['loss'].append(float(m['loss']))
        out['grad_norm'].append(float(m['grad_norm']))
        out['bits'].append((m['loss'].double().item(),
                            m['grad_norm'].double().item()))
    out['params'] = _tree_np(tr.params)
    merged = lora.merge_lora(base, tr.params, lcfg, mesh, rules)
    out['merged'] = (None if merged is None else trainer.tree_map(
        lambda x: x.numpy().copy(), merged))
    del torch
    return out


def grpo_mesh_case(tree, cfg_kw, mesh_kw, kw, prompts, steps):
    """GrpoTrainer steps on a mesh (mesh_kw) or one device (None): each
    step's metrics and every rollout (prompt, completion) in order."""
    import torch
    from skypilot_tpu_torch.parallel import sharding
    from skypilot_tpu_torch.train import rl
    from skypilot_tpu_torch.train.train_rl import make_rewards
    torch.set_num_threads(1)
    cfg = _cfg('llama', **cfg_kw)
    mesh = _train_mesh(mesh_kw) if mesh_kw else None
    seen = []
    band = make_rewards(cfg.vocab_size)['token-band']

    def reward(prompt, completion):
        seen.append((list(map(int, prompt)), list(map(int, completion))))
        return band(prompt, completion)
    tr = rl.GrpoTrainer(
        _params(tree, cfg) if mesh is None else tree, cfg, reward,
        device='cpu', mesh=mesh,
        rules=None if mesh is None else sharding.LLAMA_RULES, **kw)
    metrics = [tr.step(prompts) for _ in range(steps)]
    tr.close()
    return {'metrics': [{k: m[k] for k in ('loss', 'reward_mean',
                                           'reward_std', 'step')}
                        for m in metrics], 'seen': seen,
            'rollout_bytes': tr.rollout_bytes}


def audit_mesh_case(tree, cfg_kw, extra_combine=False):
    """The compile-budget audit's mesh_decode entry on this rank (every
    rank runs it: its generations and checked steps are collective).
    extra_combine: each layer's attention output goes through one more
    combine (of its halves, so the values stay the same), the defect the
    collective budget must catch."""
    import torch
    from skypilot_tpu_torch.analysis import audit
    from skypilot_tpu_torch.infer import llama_infer
    torch.set_num_threads(1)
    cfg = _cfg('llama', **cfg_kw)
    orig = llama_infer._attn_out
    if extra_combine:
        def twice(o, attn_p, mesh):
            return llama_infer._combine(orig(o, attn_p, mesh) * 0.5, mesh)
        llama_infer._attn_out = twice
    try:
        return audit.audit_mesh_decode(device='cpu', cfg=cfg,
                                       params=_params(tree, cfg))
    finally:
        llama_infer._attn_out = orig
