"""The engines' compiled decode chunks (CUDA graphs, engine.ChunkGraphs)
and the fixed-buffer discipline they rest on.

On the CPU (LLAMA_DEBUG at 2 layers, f32, seeded numpy weights carried
across with llama.params_from_numpy):
- the batcher's device rows, tables and arena keep their addresses
  across admission, decode, verify and fused chunks and a cancel (on a
  legacy plane, between migrations), and so do the Generator's;
- the graph keys are the reference's static-argument sets: (n,
  all_greedy, nucleus) for a decode chunk (led by the cache length on a
  legacy plane), (all_greedy, nucleus) for verify, n - 1 for a fused
  chunk's tail, n for the Generator;
- ChunkGraphs restores the launch counts a capture ticked and adds one
  capture's counts per replay; a failed capture raises with the counts
  restored;
- a stand-in for the card that records instead of running a capture and
  reruns the body on replay gives the eager path's greedy tokens (also
  on a MoE config), and the JAX batcher's;
- graphs=True without a card raises.

On the card (`cuda` marker; these skip here, and need no JAX: the
weights come from llama.init_params): graph and eager give
identical greedy tokens at LLAMA_DEBUG f32 (pooled, spec_k=3,
fuse_budget, int8 KV and weights, 'paged', the pooled Generator; a
MoE config, pooled and spec_k=3), each
key is captured once over a multi-request run, and replays of a sampled
chunk draw fresh noise from the same distribution as the eager path.

Run the card's tests on a machine with one:
    python -m pytest tests/test_torch_graphs.py -q -m cuda
"""
import dataclasses
import warnings

import numpy as np
import pytest

torch = pytest.importorskip('torch')

from skypilot_tpu_torch.infer import engine, sampling  # noqa: E402
from skypilot_tpu_torch.infer.engine import (  # noqa: E402
    ChunkGraphs, Generator, GeneratorConfig)
from skypilot_tpu_torch.infer.serving import ContinuousBatcher  # noqa: E402
from skypilot_tpu_torch.models import llama, moe  # noqa: E402
from skypilot_tpu_torch.ops import _kernels, rmsnorm  # noqa: E402
from skypilot_tpu_torch.ops import decode_attention  # noqa: E402

CFG = llama.LLAMA_DEBUG
# A MoE config at LLAMA_DEBUG's attention widths (head_dim 128, which the
# card's decode kernels take): 4 experts, top 2, f32.
MOE_HD128 = dataclasses.replace(
    moe.MOE_DEBUG, d_model=256, n_heads=2, n_kv_heads=1, d_ff=512)
KW = dict(max_seq_len=128, batch_size=3, prompt_buckets=[16, 32],
          prefill_chunk=24, kv_block_size=16)
PROMPT_LENGTHS = (5, 12, 30, 3, 9)
BUDGETS = [10, 6, 8, 12, 5]


@pytest.fixture(scope='module')
def debug_params():
    """The JAX package's LLAMA_DEBUG weights from PRNGKey(0), and the
    port's copy of them.  (The card's machine has no JAX: the card's
    tests use card_params.)"""
    jax = pytest.importorskip('jax')
    from skypilot_tpu.models import llama as j_llama
    jp = j_llama.init_params(j_llama.LLAMA_DEBUG, jax.random.PRNGKey(0))
    tree = jax.tree.map(lambda x: np.asarray(x, np.float32), jp)
    return jp, llama.params_from_numpy(tree, CFG, 'cpu')


def _prompts(lengths=PROMPT_LENGTHS, seed=0):
    rng = np.random.RandomState(seed)
    return [[int(t) for t in rng.randint(1, 512, size=n)] for n in lengths]


def _batcher(tp, graphs=None, cfg=CFG, **extra):
    with warnings.catch_warnings():
        warnings.simplefilter('ignore', DeprecationWarning)
        return ContinuousBatcher(tp, cfg, GeneratorConfig(**KW, **extra),
                                 decode_chunk=4, device='cpu',
                                 graphs=graphs)


def _serve(b, prompts=None, budgets=BUDGETS, each=None):
    rids = [b.submit(p, max_new_tokens=n)
            for p, n in zip(prompts or _prompts(), budgets)]
    for _ in range(500):
        if not (b.num_active or b.num_queued):
            return [b.result(r) for r in rids]
        b.step()
        if each is not None:
            each()
    raise AssertionError('batcher did not go idle')


# ---- stand-ins for the card -------------------------------------------------

class _Recorder:
    """In place of a batcher's ChunkGraphs: runs every chunk eagerly and
    records its key."""

    def __init__(self):
        self.keys = []

    def run(self, key, body):
        self.keys.append(key)
        return body()

    def clear(self):
        self.keys.append('clear')


def _flat(out):
    return list(out) if isinstance(out, tuple) else [out]


class _Replay:
    def __init__(self, body, out):
        self.body, self.out = body, out

    def replay(self):
        for dst, src in zip(_flat(self.out), _flat(self.body())):
            dst.copy_(src)


class _CpuCard:
    """ChunkGraphs' backend on the CPU: a capture runs body on the
    engine's state and puts the state back (a capture records and runs
    nothing); a replay reruns body and writes its outputs into the
    tensors the capture returned (a replay rewrites them in place)."""

    def __init__(self, state):
        self.state = state          # () -> the engine's state tensors

    def eager(self, body):
        return body()

    def clear(self):
        pass

    def capture(self, body):
        tensors = self.state()
        saved = [t.clone() for t in tensors]
        out = body()
        for t, s in zip(tensors, saved):
            t.copy_(s)
        return _Replay(body, out), out


def _batcher_state(b):
    extra = [b._draft] if b._drafter is not None else []
    tables = [b._tables_dev] if b.pooled else []
    return list(b._rows) + tables + extra + list(b._cache.values())


def _with_cpu_graphs(b):
    b.graphs = ChunkGraphs(b.device, backend=_CpuCard(
        lambda: _batcher_state(b)))
    return b


# ---- (a) fixed buffers ------------------------------------------------------

def _row_ptrs(b):
    names = ('_token', '_positions', '_done', '_limit', '_temp_row',
             '_top_p_row')
    ptrs = {n: getattr(b, n).data_ptr() for n in names}
    if b.pooled:
        ptrs['_tables_dev'] = b._tables_dev.data_ptr()
    if b._drafter is not None:
        ptrs['_draft'] = b._draft.data_ptr()
    return ptrs


def _cache_ptrs(b):
    return {k: t.data_ptr() for k, t in b._cache.items()}


def test_batcher_buffers_keep_their_addresses_pooled(debug_params):
    """spec_k=3 and fuse_budget=8 with a 30-token chunked prompt: verify,
    fused and plain chunks all run, a request is cancelled mid-decode,
    and no device row, the tables or the arena moves."""
    _, tp = debug_params
    b = _batcher(tp, spec_k=3, fuse_budget=8)
    rows, cache = _row_ptrs(b), _cache_ptrs(b)
    prompts = _prompts()
    rids = [b.submit(p, max_new_tokens=n) for p, n in zip(prompts, BUDGETS)]
    cancelled = False
    for _ in range(300):
        if not (b.num_active or b.num_queued):
            break
        b.step()
        assert _row_ptrs(b) == rows and _cache_ptrs(b) == cache
        if not cancelled and len(b.partial(rids[3])) > 2:
            b.cancel(rids[3])
            cancelled = True
            assert _row_ptrs(b) == rows and _cache_ptrs(b) == cache
    assert cancelled and b.spec_proposed > 0
    assert b._fuse_policy.stats.steps > 0
    assert b.pool.arena is b._cache


def test_batcher_buffers_keep_their_addresses_paged(debug_params):
    """The legacy 'paged' plane: the rows never move; the slot cache
    moves only at a migration, which drops every graph."""
    _, tp = debug_params
    b = _batcher(tp, decode_impl='paged')
    b.graphs = _Recorder()
    rows, cache = _row_ptrs(b), _cache_ptrs(b)
    seen = [dict(b.migrations)]

    def check():
        nonlocal cache
        assert _row_ptrs(b) == rows
        if b.migrations != seen[-1]:
            seen.append(dict(b.migrations))
            cache = _cache_ptrs(b)
        assert _cache_ptrs(b) == cache
        assert b.graphs.keys.count('clear') == sum(b.migrations.values())

    # The 30-token prompt (chunked) grows the cache past 64 rows; the
    # other request, still live after it, shrinks it back.
    _serve(b, _prompts((30, 5), seed=4), [40, 50], each=check)
    assert b.migrations['grow'] and b.migrations['shrink']
    assert len(seen) >= 3


def test_generator_buffers_keep_their_addresses(debug_params):
    _, tp = debug_params
    gen = Generator(tp, CFG, GeneratorConfig(
        max_seq_len=128, batch_size=3, prompt_buckets=[16, 64],
        decode_chunk=4, kv_block_size=16, spec_k=3), device='cpu')
    ptrs = [t.data_ptr() for t in gen._rows + (gen._tables_dev, gen._draft)]
    arena = {k: t.data_ptr() for k, t in gen.pool.arena.items()}
    for seed in (5, 6):
        gen.generate(_prompts((5, 40, 9), seed=seed), max_new_tokens=12)
        assert [t.data_ptr() for t in gen._rows + (
            gen._tables_dev, gen._draft)] == ptrs
        assert {k: t.data_ptr() for k, t in gen.pool.arena.items()} == arena


# ---- (b) keys ---------------------------------------------------------------

@pytest.mark.parametrize('extra,want', [
    ({}, {('decode', 4, True, False)}),
    (dict(spec_k=3), {('verify', True, False)}),
    (dict(fuse_budget=8), {('decode', 4, True, False),
                           ('decode', 3, True, False)}),
], ids=['plain', 'spec', 'fused'])
def test_batcher_graph_keys(debug_params, extra, want):
    """The keys are the reference's static arguments: _decode's (n,
    all_greedy, nucleus), _verify's (all_greedy, nucleus), and the plain
    chunk of n - 1 after a fused step 0.  Tokens are the eager path's."""
    _, tp = debug_params
    b = _batcher(tp, **extra)
    eager = _serve(b)
    b = _batcher(tp, **extra)
    b.graphs = _Recorder()
    assert _serve(b) == eager
    assert want <= set(b.graphs.keys)
    assert all(k[0] == 'decode' and len(k) == 4 or k[0] == 'verify'
               and len(k) == 3 for k in b.graphs.keys)


def test_batcher_graph_keys_sampling_and_legacy(debug_params):
    """Sampled requests key on (all_greedy, nucleus) from the active
    slots' host mirrors; a legacy plane's keys lead with the cache
    length."""
    _, tp = debug_params
    b = _batcher(tp)
    b.graphs = _Recorder()
    r = b.submit([5, 6, 7], max_new_tokens=6, temperature=0.9)
    b.run_until_idle()
    s = b.submit([5, 6, 7], max_new_tokens=6, temperature=0.9, top_p=0.5)
    b.run_until_idle()
    assert list(dict.fromkeys(b.graphs.keys)) == [
        ('decode', 4, False, False), ('decode', 4, False, True)]
    assert len(b.result(r)) == len(b.result(s)) == 6
    b = _batcher(tp, decode_impl='inplace')
    b.graphs = _Recorder()
    _serve(b, _prompts((5, 9), seed=2), [6, 9])
    assert {k for k in b.graphs.keys if k != 'clear'} == {
        ('decode', 64, 4, True, False)}


def test_generator_graph_keys(debug_params):
    _, tp = debug_params
    gen = Generator(tp, CFG, GeneratorConfig(
        max_seq_len=128, batch_size=2, prompt_buckets=[16],
        decode_chunk=4, kv_block_size=16, spec_k=3), device='cpu')
    gen.graphs = _Recorder()
    gen._spec_policy.ema = 0.0              # plain chunks, then a probe
    gen.generate(_prompts((5, 9)), max_new_tokens=10)
    assert set(gen.graphs.keys) == {('decode', 4), ('verify',)}


# ---- (c) launch counts ------------------------------------------------------

class _StandIn:
    """A card that launches nothing: capture runs body (which ticks the
    counts as a real capture does) and replay does nothing."""

    def eager(self, body):
        return body()

    def capture(self, body):
        return self, body()

    def replay(self):
        pass

    def clear(self):
        self.cleared = True


def _tick():
    rmsnorm.rms_norm.launches += 3
    decode_attention.decode_attention_pooled.launches += 2
    decode_attention.decode_attention_pooled.launches_split += 2
    return torch.zeros(2)


def test_chunk_graphs_count_replays_not_captures():
    graphs = ChunkGraphs(torch.device('cpu'), backend=_StandIn())
    k1 = decode_attention.decode_attention_pooled
    before = _kernels.launch_counts()
    out = graphs.run('a', _tick)            # eager run, then the capture
    assert (rmsnorm.rms_norm.launches, k1.launches, k1.launches_split) == (
        before[_index(rmsnorm.rms_norm, 'launches')] + 3,
        before[_index(k1, 'launches')] + 2,
        before[_index(k1, 'launches_split')] + 2)
    assert graphs.captures == 1 and graphs.replays == 0
    one = _kernels.launch_counts()
    for i in range(1, 4):
        replayed = graphs.run('a', _tick)
        assert replayed is graphs._graphs['a'].out and replayed is not out
        delta = [a - b for a, b in zip(_kernels.launch_counts(), one)]
        assert delta[_index(rmsnorm.rms_norm, 'launches')] == 3 * i
        assert delta[_index(k1, 'launches_split')] == 2 * i
        assert sum(delta) == 7 * i
    assert graphs.captures == 1 and graphs.replays == 3
    assert graphs.capture_seconds >= 0.0
    graphs.clear()
    assert graphs.keys() == [] and graphs.backend.cleared


def _index(wrapper, attr):
    return _kernels.COUNTERS.index((wrapper, attr))


def test_chunk_graphs_failed_capture_raises_and_restores_counts():
    class Broken(_StandIn):
        def capture(self, body):
            body()
            raise RuntimeError('capture refused')

    graphs = ChunkGraphs(torch.device('cpu'), backend=Broken())
    before = _kernels.launch_counts()
    with pytest.raises(RuntimeError, match='capture refused'):
        graphs.run('a', _tick)
    after = _kernels.launch_counts()
    # The eager run's launches stand, the capture's are gone.
    assert sum(after) - sum(before) == 7
    assert graphs.keys() == [] and graphs.captures == 0


def test_every_wrapper_counts_in_the_registry():
    from skypilot_tpu_torch.ops import attention
    registered = {(w.__name__, a) for w, a in _kernels.COUNTERS}
    for w in (rmsnorm.rms_norm, attention.flash_attention,
              attention.flash_attention_dq, attention.flash_attention_dkv,
              decode_attention.decode_attention_pooled,
              decode_attention.decode_attention,
              decode_attention.decode_window_attention_pooled,
              decode_attention.fused_step_attention_pooled):
        for attr in ('launches', 'launches_tc', 'launches_split',
                     'launches_lse'):
            if hasattr(w, attr):
                assert (w.__name__, attr) in registered


# ---- the graph path on a stand-in card --------------------------------------

@pytest.mark.parametrize('extra', [
    {}, dict(spec_k=3), dict(fuse_budget=8),
    dict(kv_cache_dtype='int8', weights_dtype='int8'),
    dict(decode_impl='paged'), dict(decode_impl='inplace')],
    ids=['pooled', 'spec', 'fused', 'int8', 'paged', 'inplace'])
def test_batcher_graph_path_gives_eager_tokens(debug_params, extra):
    """Capture records (the state is put back), replay reruns the body
    into the captured outputs: the batcher's tokens equal the eager
    path's, each key is captured once (once per bucket on a legacy
    plane), and chunks are replayed."""
    _, tp = debug_params
    want = _serve(_batcher(tp, **extra))
    b = _with_cpu_graphs(_batcher(tp, **extra))
    assert _serve(b) == want
    assert b.graphs.replays > 0
    if b.pooled:
        assert b.graphs.captures == len(b.graphs.keys())


def test_batcher_graph_path_matches_jax(debug_params):
    from skypilot_tpu.infer import engine as j_engine
    from skypilot_tpu.infer import serving as j_serving
    from skypilot_tpu.models import llama as j_llama
    jp, tp = debug_params
    jb = j_serving.ContinuousBatcher(jp, j_llama.LLAMA_DEBUG,
                                     j_engine.GeneratorConfig(**KW),
                                     decode_chunk=4)
    j_rids = [jb.submit(p, max_new_tokens=n)
              for p, n in zip(_prompts(), BUDGETS)]
    jb.run_until_idle()
    b = _with_cpu_graphs(_batcher(tp))
    assert _serve(b) == [jb.result(r) for r in j_rids]
    assert b.graphs.replays > 0


def test_generator_graph_path_gives_eager_tokens(debug_params):
    _, tp = debug_params
    kw = dict(max_seq_len=128, batch_size=3, prompt_buckets=[16, 64],
              decode_chunk=4, kv_block_size=16, spec_k=3)
    prompts = _prompts((5, 40, 9), seed=5)
    want = Generator(tp, CFG, GeneratorConfig(**kw), device='cpu').generate(
        prompts, max_new_tokens=20)
    gen = Generator(tp, CFG, GeneratorConfig(**kw), device='cpu')
    gen.graphs = ChunkGraphs(gen.device, backend=_CpuCard(
        lambda: list(gen._rows) + [gen._tables_dev, gen._draft]
        + list(gen.pool.arena.values())))
    for _ in range(2):                      # the second call replays
        assert gen.generate(prompts, max_new_tokens=20) == want
    assert gen.graphs.replays > 0
    assert gen.graphs.captures == len(gen.graphs.keys())


def test_batcher_graph_path_gives_eager_tokens_moe():
    """The same on a MoE config (MOE_HD128: the expert bank in every
    captured decode chunk): the graph path's tokens equal the eager
    path's, each key captured once."""
    tp = moe.init_params(MOE_HD128, torch.Generator().manual_seed(0), 'cpu')
    want = _serve(_batcher(tp, cfg=MOE_HD128))
    b = _with_cpu_graphs(_batcher(tp, cfg=MOE_HD128))
    assert _serve(b) == want
    assert b.graphs.replays > 0
    assert b.graphs.captures == len(b.graphs.keys())


# ---- (d) no card ------------------------------------------------------------

def test_graphs_true_without_a_card_raises(debug_params):
    _, tp = debug_params
    with pytest.raises(ValueError, match='needs a CUDA device'):
        _batcher(tp, graphs=True)
    with pytest.raises(ValueError, match='needs a CUDA device'):
        Generator(tp, CFG, GeneratorConfig(max_seq_len=128), device='cpu',
                  graphs=True)
    with pytest.raises(ValueError, match='needs a CUDA device'):
        engine.chunk_graphs(True, torch.device('cpu'))
    with pytest.raises(NotImplementedError, match='item 15'):
        Generator(tp, CFG, GeneratorConfig(max_seq_len=128,
                                           decode_impl='inplace'),
                  device='cpu', graphs=True)
    assert _batcher(tp).graphs is None
    assert _batcher(tp, graphs=False).graphs is None


# ---- on the card ------------------------------------------------------------

@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device (torch.cuda.is_available() is '
                    'false)')
    try:
        _kernels._nvcc()
    except RuntimeError:
        pytest.skip('needs nvcc to build the kernels')
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device('cuda')


@pytest.fixture(scope='module')
def card_params():
    """LLAMA_DEBUG f32 weights from a seed, on the card."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device (torch.cuda.is_available() is '
                    'false)')
    return llama.init_params(CFG, torch.Generator().manual_seed(0), 'cuda')


def _card_batcher(tp, graphs, cfg=CFG, **extra):
    with warnings.catch_warnings():
        warnings.simplefilter('ignore', DeprecationWarning)
        return ContinuousBatcher(tp, cfg, GeneratorConfig(**KW, **extra),
                                 decode_chunk=4, device='cuda',
                                 graphs=graphs)


@pytest.mark.cuda
@pytest.mark.parametrize('extra', [
    {}, dict(spec_k=3), dict(fuse_budget=8),
    dict(kv_cache_dtype='int8', weights_dtype='int8'),
    dict(decode_impl='paged')],
    ids=['pooled', 'spec', 'fused', 'int8', 'paged'])
def test_card_graphs_give_eager_tokens(cuda, card_params, extra):
    """Identical greedy tokens from the graphs and the eager chunks;
    every key captured exactly once (per bucket on 'paged'), replays
    counted, and the launch counts of the graph run those of the eager
    run."""
    tp = card_params
    counted = (rmsnorm.rms_norm, decode_attention.decode_attention_pooled,
               decode_attention.decode_attention,
               decode_attention.decode_window_attention_pooled)
    runs = {}
    for graphs in (False, True):
        b = _card_batcher(tp, graphs, **extra)
        before = [c.launches for c in counted]
        runs[graphs] = (_serve(b), [c.launches - n
                                    for c, n in zip(counted, before)])
    assert runs[True][0] == runs[False][0]
    assert runs[True][1] == runs[False][1]
    assert b.graphs.replays > 0
    if b.pooled:
        assert b.graphs.captures == len(b.graphs.keys())


@pytest.mark.cuda
def test_card_generator_graphs_give_eager_tokens(cuda, card_params):
    tp = card_params
    kw = dict(max_seq_len=128, batch_size=3, prompt_buckets=[16, 64],
              decode_chunk=4, kv_block_size=16)
    prompts = _prompts((5, 40, 9), seed=5)
    for extra in ({}, dict(spec_k=3)):
        want = Generator(tp, CFG, GeneratorConfig(**kw, **extra),
                         device='cuda', graphs=False).generate(
                             prompts, max_new_tokens=20)
        gen = Generator(tp, CFG, GeneratorConfig(**kw, **extra),
                        device='cuda')
        for _ in range(2):
            assert gen.generate(prompts, max_new_tokens=20) == want
        assert gen.graphs.replays > 0
        assert gen.graphs.captures == len(gen.graphs.keys())


@pytest.mark.cuda
def test_card_each_key_captured_once(cuda, card_params):
    """Eight requests through three slots, greedy and sampled: every key
    is captured once, however many chunks replay it."""
    b = _card_batcher(card_params, True, spec_k=3)
    rids = []
    for i, p in enumerate(_prompts((5, 12, 30, 3, 9, 7, 20, 4), seed=3)):
        rids.append(b.submit(p, max_new_tokens=12,
                             temperature=0.8 if i % 3 == 0 else None))
    b.run_until_idle()
    assert all(len(b.result(r)) == 12 for r in rids)
    assert b.graphs.captures == len(b.graphs.keys())
    assert b.graphs.replays > 0


@pytest.mark.cuda
def test_card_sampled_replays_draw_fresh_noise(cuda):
    """One graph over a sampled step replayed many times: two replays
    draw different tokens, and the tokens of the replays follow the
    softmax as the eager draws do (the statistic of
    test_torch_spec_fused.py's sampled-acceptance test)."""
    vocab, n = 8, 4000
    logits = torch.from_numpy(np.random.RandomState(3).randn(
        1, vocab).astype(np.float32)).cuda().expand(n, vocab).contiguous()
    temp = torch.ones((n,), device='cuda')
    top_p = torch.full((n,), 0.9, device='cuda')
    rng = torch.Generator(device='cuda').manual_seed(0)
    graphs = ChunkGraphs(torch.device('cuda'), (rng,))

    def body():
        return sampling.sample_logits_batched(logits, rng, temp, top_p)

    eager = body().cpu().numpy()
    first = graphs.run('s', body).cpu().numpy()     # eager + capture
    a = graphs.run('s', body).cpu().numpy()
    b = graphs.run('s', body).cpu().numpy()
    assert graphs.replays == 2 and not np.array_equal(a, b)
    want = torch.softmax(sampling._mask_top_p(logits[:1], 0.9), -1)[0]
    for draws in (eager, first, a, b):
        emp = np.bincount(draws, minlength=vocab) / n
        assert np.abs(emp - want.cpu().numpy()).sum() < 0.1


@pytest.mark.cuda
def test_card_generator_sampled_graphs(cuda, card_params):
    """A sampled Generator (a float top_p, which must stay a scalar
    operand inside a capture) through its graphs: in-vocabulary tokens,
    chunks replayed, and another seed draws other tokens."""
    gen = Generator(card_params, CFG, GeneratorConfig(
        max_seq_len=128, batch_size=2, prompt_buckets=[16],
        decode_chunk=4, kv_block_size=16, temperature=0.8, top_p=0.9),
        device='cuda')
    prompts = _prompts((5, 9), seed=7)
    a = gen.generate(prompts, max_new_tokens=16, seed=1)
    b = gen.generate(prompts, max_new_tokens=16, seed=2)
    assert gen.graphs.replays > 0 and a != b
    assert all(0 <= t < CFG.vocab_size for row in a + b for t in row)


@pytest.mark.cuda
def test_card_engine_with_graphs_is_freed(cuda, card_params):
    """A batcher's graphs, their pool and its arena go with it: nothing
    of it stays allocated once the last reference is dropped."""
    import gc
    import weakref
    allocated = []
    for _ in range(2):      # the first run makes what the process keeps
        b = _card_batcher(card_params, None, spec_k=3)
        _serve(b)
        assert b.graphs.captures > 0
        ref = weakref.ref(b)
        del b
        gc.collect()
        torch.cuda.synchronize()
        assert ref() is None
        allocated.append(torch.cuda.memory_allocated())
    assert allocated[1] == allocated[0]


@pytest.mark.cuda
@pytest.mark.parametrize('extra', [{}, dict(spec_k=3)],
                         ids=['pooled', 'spec'])
def test_card_moe_graphs_give_eager_tokens(cuda, extra):
    """MOE_HD128 on the card: the expert bank inside the captured decode
    (and verify) chunks gives the eager chunks' greedy tokens, each key
    captured once, chunks replayed, and the same launch counts."""
    tp = moe.init_params(MOE_HD128, torch.Generator().manual_seed(0),
                         'cuda')
    counted = (rmsnorm.rms_norm, decode_attention.decode_attention_pooled,
               decode_attention.decode_window_attention_pooled)
    runs = {}
    for graphs in (False, True):
        b = _card_batcher(tp, graphs, cfg=MOE_HD128, **extra)
        before = [c.launches for c in counted]
        runs[graphs] = (_serve(b), [c.launches - n
                                    for c, n in zip(counted, before)])
    assert runs[True] == runs[False]
    assert b.graphs.replays > 0
    assert b.graphs.captures == len(b.graphs.keys())
