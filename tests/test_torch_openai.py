"""The port's replica surface (skypilot_tpu_torch/infer/replica.py: the
OpenAI routes, text prompts, streaming, embeddings) and
``llama_infer.encode`` / ``quant.quantized_bytes``, on the CPU, held
against the JAX package.

What must hold:
- the ten behaviours of tests/test_openai_api.py on the port's replica
  (served in process on the CPU): /v1/models, the completion and chat
  schemas, token-id prompts, SSE framing with one terminal finish chunk,
  the chat stream's role chunk first, the error shapes, greedy
  determinism, per-request sampling and /v1/embeddings;
- the same request bodies give the same response bodies (ids and
  `created` aside) as the reference's own ``attach_openai_routes`` over
  the JAX batcher on the same weights, and the greedy completion text is
  the byte-decoded ids of the JAX batcher; a stream's deltas
  concatenate to the plain completion's text;
- a request's X-Skytpu-Trace-Id header keys its spans;
- ``encode`` equals the JAX ``llama_infer.encode`` in f32 (1e-5), in
  bf16 (stated below) and on int8 weights, and a row's vector does not
  depend on the batch or bucket it rides in;
- ``quantized_bytes`` equals the JAX package's, plain and int8.

At LLAMA_DEBUG (2 layers), weights from one JAX draw
(llama.params_from_numpy).
"""
import asyncio
import importlib.util
import json
import os
import socket
import sys
import threading
import urllib.error
import urllib.request
import warnings

import numpy as np
import pytest

torch = pytest.importorskip('torch')

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from skypilot_tpu.infer import engine as j_engine  # noqa: E402
from skypilot_tpu.infer import llama_infer as j_llama_infer  # noqa: E402
from skypilot_tpu.infer import quant as j_quant  # noqa: E402
from skypilot_tpu.infer import serving as j_serving  # noqa: E402
from skypilot_tpu.models import llama as j_llama  # noqa: E402
from skypilot_tpu_torch.infer import llama_infer, quant, replica  # noqa: E402
from skypilot_tpu_torch.infer.engine import GeneratorConfig  # noqa: E402
from skypilot_tpu_torch.infer.serving import ContinuousBatcher  # noqa: E402
from skypilot_tpu_torch.models import llama  # noqa: E402
from skypilot_tpu_torch.telemetry import spans  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = llama.LLAMA_DEBUG
J_CFG = j_llama.LLAMA_DEBUG
GEN = dict(max_seq_len=128, batch_size=4, temperature=0.0)


@pytest.fixture(scope='module')
def models():
    jp = j_llama.init_params(J_CFG, jax.random.PRNGKey(0))
    tree = jax.tree.map(lambda x: np.asarray(x, np.float32), jp)
    return jp, llama.params_from_numpy(tree, CFG, 'cpu')


def _free_port():
    s = socket.socket()
    s.bind(('127.0.0.1', 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _reference_replica(jp):
    """The reference's BatcherDriver and attach_openai_routes
    (examples/scripts/serve_llama.py) over a JAX batcher, served by
    aiohttp on a thread; returns (base url, stop)."""
    from aiohttp import web
    spec = importlib.util.spec_from_file_location(
        'serve_llama_reference',
        os.path.join(ROOT, 'examples', 'scripts', 'serve_llama.py'))
    sys.path.insert(0, os.path.join(ROOT, 'examples', 'scripts'))
    try:
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
    finally:
        sys.path.pop(0)
    with warnings.catch_warnings():
        warnings.simplefilter('ignore', DeprecationWarning)
        batcher = j_serving.ContinuousBatcher(
            jp, J_CFG, j_engine.GeneratorConfig(**GEN), max_queue=16)
    driver = module.BatcherDriver(batcher)
    app = web.Application()
    module.attach_openai_routes(app, driver, J_CFG, None,
                                model_name='debug', default_max_tokens=16,
                                eos_token=None)
    loop = asyncio.new_event_loop()
    runner = web.AppRunner(app)
    loop.run_until_complete(runner.setup())
    port = _free_port()
    loop.run_until_complete(web.TCPSite(runner, '127.0.0.1', port).start())
    thread = threading.Thread(target=loop.run_forever, daemon=True)
    thread.start()

    def stop():
        asyncio.run_coroutine_threadsafe(runner.cleanup(), loop).result(30)
        loop.call_soon_threadsafe(loop.stop)
        thread.join(30)
    return f'http://127.0.0.1:{port}', stop


@pytest.fixture(scope='module')
def servers(models):
    """(port url, reference url, the port batcher's span buffer)."""
    jp, tp = models
    buf = spans.SpanBuffer()
    batcher = ContinuousBatcher(tp, CFG, GeneratorConfig(**GEN),
                                max_queue=16, device='cpu', span_buffer=buf)
    server, thread = replica.serve(batcher, '127.0.0.1', 0, 'debug', 16)
    ref_url, stop = _reference_replica(jp)
    try:
        yield (f'http://127.0.0.1:{server.server_address[1]}', ref_url,
               buf)
    finally:
        replica.shutdown_replica(server, thread)
        stop()


@pytest.fixture
def server(servers):
    return servers[0]


def _post(url, payload, headers=None):
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(),
        headers={'Content-Type': 'application/json', **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _post_stream(url, payload):
    """-> list of SSE data payloads (raw strings, [DONE] included)."""
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(),
        headers={'Content-Type': 'application/json'})
    with urllib.request.urlopen(req, timeout=120) as r:
        assert r.headers['Content-Type'].startswith('text/event-stream')
        buf = r.read()
    return [block[len('data: '):]
            for block in buf.decode().split('\n\n')
            if block.startswith('data: ')]


# ---- the ten behaviours of tests/test_openai_api.py -------------------------

def test_models_endpoint(server):
    with urllib.request.urlopen(server + '/v1/models', timeout=30) as r:
        body = json.loads(r.read())
    assert body['object'] == 'list'
    assert body['data'][0]['id'] == 'debug'


def test_completions_schema(server):
    status, body = _post(server + '/v1/completions',
                         {'prompt': 'hello tpu', 'max_tokens': 6})
    assert status == 200
    assert body['object'] == 'text_completion'
    assert body['id'].startswith('cmpl-')
    assert body['model'] == 'debug'
    [choice] = body['choices']
    assert choice['index'] == 0
    assert isinstance(choice['text'], str)
    assert choice['finish_reason'] == 'length'
    assert body['usage']['completion_tokens'] == 6
    assert body['usage']['total_tokens'] == \
        body['usage']['prompt_tokens'] + 6


def test_completions_token_id_prompt(server):
    status, body = _post(server + '/v1/completions',
                         {'prompt': [5, 9, 2], 'max_tokens': 4})
    assert status == 200
    assert body['usage']['prompt_tokens'] == 3


def test_chat_completions_schema(server):
    status, body = _post(
        server + '/v1/chat/completions',
        {'messages': [{'role': 'user', 'content': 'hi'}],
         'max_tokens': 5})
    assert status == 200
    assert body['object'] == 'chat.completion'
    assert body['id'].startswith('chatcmpl-')
    [choice] = body['choices']
    assert choice['message']['role'] == 'assistant'
    assert isinstance(choice['message']['content'], str)
    assert choice['finish_reason'] == 'length'


def test_completions_streaming_sse(server):
    events = _post_stream(server + '/v1/completions',
                          {'prompt': 'stream me', 'max_tokens': 8,
                           'stream': True})
    assert events[-1] == '[DONE]'
    parsed = [json.loads(e) for e in events[:-1]]
    assert all(p['object'] == 'text_completion' for p in parsed)
    # Exactly one terminal chunk carries the finish_reason.
    finishes = [p['choices'][0]['finish_reason'] for p in parsed]
    assert finishes[-1] == 'length'
    assert all(f is None for f in finishes[:-1])
    assert any(p['choices'][0]['text'] for p in parsed)


def test_chat_streaming_role_then_content(server):
    events = _post_stream(
        server + '/v1/chat/completions',
        {'messages': [{'role': 'user', 'content': 'hi'}],
         'max_tokens': 6, 'stream': True})
    assert events[-1] == '[DONE]'
    parsed = [json.loads(e) for e in events[:-1]]
    assert all(p['object'] == 'chat.completion.chunk' for p in parsed)
    assert parsed[0]['choices'][0]['delta'].get('role') == 'assistant'
    assert any(p['choices'][0]['delta'].get('content') for p in parsed)
    assert parsed[-1]['choices'][0]['finish_reason'] == 'length'


def test_openai_error_shapes(server):
    status, body = _post(server + '/v1/completions',
                         {'prompt': 'x', 'n': 3})
    assert status == 400
    assert body['error']['type'] == 'invalid_request_error'
    status, body = _post(server + '/v1/completions', {})
    assert status == 400
    status, body = _post(server + '/v1/chat/completions',
                         {'messages': []})
    assert status == 400


def test_completions_greedy_deterministic(server):
    a = _post(server + '/v1/completions',
              {'prompt': [5, 6, 7], 'max_tokens': 6})[1]
    b = _post(server + '/v1/completions',
              {'prompt': [5, 6, 7], 'max_tokens': 6})[1]
    assert a['choices'][0]['text'] == b['choices'][0]['text']


def test_completions_per_request_sampling(server):
    payload = {'prompt': [5, 9, 2], 'max_tokens': 6,
               'temperature': 0.8, 'top_p': 0.9}
    status, body = _post(server + '/v1/completions', payload)
    assert status == 200
    assert body['choices'][0]['text'] is not None
    greedy = {'prompt': [5, 9, 2], 'max_tokens': 6, 'temperature': 0}
    _, b1 = _post(server + '/v1/completions', greedy)
    _, b2 = _post(server + '/v1/completions', greedy)
    assert b1['choices'][0]['text'] == b2['choices'][0]['text']
    status, body = _post(server + '/v1/completions',
                         {'prompt': [5], 'top_p': 0.0})
    assert status == 400
    assert body['error']['type'] == 'invalid_request_error'


def test_embeddings_endpoint(server):
    payload = {'input': [[5, 9, 2], [7, 7]]}
    status, body = _post(server + '/v1/embeddings', payload)
    assert status == 200, body
    assert body['object'] == 'list' and len(body['data']) == 2
    v0 = body['data'][0]['embedding']
    assert len(v0) == 256  # LLAMA_DEBUG d_model
    assert body['usage']['prompt_tokens'] == 5
    _, body2 = _post(server + '/v1/embeddings', payload)
    assert body2['data'][0]['embedding'] == v0
    assert body['data'][1]['embedding'] != v0
    status, body3 = _post(server + '/v1/embeddings', {'input': 'hello'})
    assert status == 200 and len(body3['data']) == 1
    status, err = _post(server + '/v1/embeddings', {'input': []})
    assert status == 400
    assert err['error']['type'] == 'invalid_request_error'


# ---- against the reference's routes over the JAX batcher --------------------

def _strip(body):
    return {k: v for k, v in body.items() if k not in ('id', 'created')}


PARITY_REQUESTS = [
    ('/v1/completions', {'prompt': 'hello tpu', 'max_tokens': 6}),
    ('/v1/completions', {'prompt': [5, 9, 2], 'max_tokens': 4}),
    ('/v1/completions', {'prompt': ['one string'], 'max_tokens': 5}),
    ('/v1/completions', {'prompt': 'cut here', 'max_tokens': 12,
                         'stop': ['\x00', 'x']}),
    ('/v1/chat/completions', {'messages': [{'role': 'user',
                                            'content': 'hi'}],
                              'max_tokens': 5}),
    ('/v1/completions', {'prompt': 'x', 'n': 3}),
    ('/v1/completions', {}),
    ('/v1/completions', {'prompt': [5, 9999]}),
    ('/v1/chat/completions', {'messages': []}),
    ('/v1/completions', {'prompt': [5], 'top_p': 0.0}),
    ('/v1/embeddings', {'input': []}),
    ('/v1/embeddings', {'input': [[1, 600]]}),
    ('/v1/embeddings', {'input': [{'a': 1}]}),
]


@pytest.mark.parametrize('route,payload', PARITY_REQUESTS,
                         ids=[f'{r}-{i}' for i, (r, _) in
                              enumerate(PARITY_REQUESTS)])
def test_bodies_match_the_reference_replica(servers, route, payload):
    port, ref, _ = servers
    status, body = _post(port + route, payload)
    ref_status, ref_body = _post(ref + route, payload)
    assert status == ref_status
    if status != 200:
        # The same status and envelope; the messages are each engine's.
        assert body['error']['type'] == ref_body['error']['type']
        return
    assert _strip(body) == _strip(ref_body)


def test_greedy_text_is_the_jax_batchers_bytes(servers, models):
    jp, _ = models
    prompt = 'hello tpu'
    ids = [b % CFG.vocab_size for b in prompt.encode('utf-8')]
    with warnings.catch_warnings():
        warnings.simplefilter('ignore', DeprecationWarning)
        jb = j_serving.ContinuousBatcher(jp, J_CFG,
                                         j_engine.GeneratorConfig(**GEN))
    rid = jb.submit(ids, max_new_tokens=9)
    jb.run_until_idle()
    want = bytes(t % 256 for t in jb.result(rid)).decode(
        'utf-8', errors='replace')
    status, body = _post(servers[0] + '/v1/completions',
                         {'prompt': prompt, 'max_tokens': 9})
    assert status == 200 and body['choices'][0]['text'] == want
    status, gen = _post(servers[0] + '/generate',
                        {'prompt': prompt, 'max_new_tokens': 9})
    assert status == 200 and bytes(
        t % 256 for t in gen['output_ids']).decode(
            'utf-8', errors='replace') == want


@pytest.mark.parametrize('chat', [False, True], ids=['completion', 'chat'])
def test_stream_concatenates_to_the_plain_text(servers, chat):
    port, ref, _ = servers
    route = '/v1/chat/completions' if chat else '/v1/completions'
    payload = ({'messages': [{'role': 'user', 'content': 'stream me'}]}
               if chat else {'prompt': 'stream me'})
    payload['max_tokens'] = 10
    _, plain = _post(port + route, payload)
    texts = []
    for url in (port, ref):
        events = _post_stream(url + route, dict(payload, stream=True))
        assert events[-1] == '[DONE]'
        parsed = [json.loads(e) for e in events[:-1]]
        if chat:
            assert parsed[0]['choices'][0]['delta'] == {
                'role': 'assistant'}
            texts.append(''.join(p['choices'][0]['delta'].get('content', '')
                                 for p in parsed))
        else:
            texts.append(''.join(p['choices'][0]['text'] for p in parsed))
        assert parsed[-1]['choices'][0]['finish_reason'] == 'length'
    want = (plain['choices'][0]['message']['content'] if chat
            else plain['choices'][0]['text'])
    assert texts == [want, want]


def test_embeddings_match_the_reference_replica(servers):
    port, ref, _ = servers
    payload = {'input': [[5, 9, 2], 'some text', [7] * 70]}
    (status, body), (ref_status, ref_body) = (
        _post(url + '/v1/embeddings', payload) for url in (port, ref))
    assert status == ref_status == 200
    assert body['usage'] == ref_body['usage']
    got = np.asarray([d['embedding'] for d in body['data']])
    want = np.asarray([d['embedding'] for d in ref_body['data']])
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_trace_header_keys_the_request_spans(servers):
    port, _, buf = servers
    status, _ = _post(port + '/v1/completions',
                      {'prompt': [4, 4, 4], 'max_tokens': 3},
                      headers={'X-Skytpu-Trace-Id': 'trace-openai-1'})
    assert status == 200
    status, _ = _post(port + '/generate',
                      {'prompt_ids': [4, 4, 5], 'max_new_tokens': 3},
                      headers={'X-Skytpu-Trace-Id': 'trace-generate-1'})
    assert status == 200
    for trace_id in ('trace-openai-1', 'trace-generate-1'):
        names = [s['name'] for s in buf.snapshot()
                 if s.get('trace_id') == trace_id]
        assert {'queue_wait', 'admit', 'prefill_chunk', 'delivery'} <= \
            set(names), names


# ---- encode and quantized_bytes ----------------------------------------------

TOKENS = np.random.RandomState(5).randint(0, 512, size=(4, 64)).astype(
    np.int32)
LENGTHS = np.asarray([64, 5, 1, 30], np.int32)


def _encode_both(jp, tp, jcfg, cfg):
    want = np.asarray(j_llama_infer.encode(
        jp, jnp.asarray(TOKENS), jcfg, jnp.asarray(LENGTHS)))
    got = llama_infer.encode(tp, torch.as_tensor(TOKENS), cfg,
                             torch.as_tensor(LENGTHS)).numpy()
    assert got.dtype == np.float32 and got.shape == (4, CFG.d_model)
    return got, want


def test_encode_matches_jax_f32(models):
    jp, tp = models
    got, want = _encode_both(jp, tp, J_CFG, CFG)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_encode_matches_jax_int8_weights(models):
    jp, tp = models
    got, want = _encode_both(j_quant.quantize_weights(jp),
                             quant.quantize_weights(tp), J_CFG, CFG)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_encode_matches_jax_bf16(models):
    """bf16 on both sides, the same bf16 weights: every product rounds to
    bf16 (one ulp 2^-8 relative) in an order that differs between XLA
    and torch, over 2 layers, and the f32 mean pools 1-64 such rows.
    Bound: 4 bf16 ulps of each vector's largest element, and cosine
    0.9999."""
    import dataclasses
    jp, _ = models
    jcfg = dataclasses.replace(J_CFG, dtype=jnp.bfloat16)
    cfg = dataclasses.replace(CFG, dtype=torch.bfloat16)
    jp16 = jax.tree.map(lambda x: x.astype(jnp.bfloat16), jp)
    tree = jax.tree.map(lambda x: np.asarray(x.astype(jnp.float32)), jp16)
    tp16 = llama.params_from_numpy(tree, cfg, 'cpu')
    got, want = _encode_both(jp16, tp16, jcfg, cfg)
    scale = np.abs(want).max(axis=1, keepdims=True)
    assert np.all(np.abs(got - want) <= 4 * 2.0 ** -8 * scale)
    cos = (got * want).sum(1) / np.linalg.norm(got, axis=1) / \
        np.linalg.norm(want, axis=1)
    assert cos.min() >= 0.9999


def test_encode_row_does_not_depend_on_batch_or_bucket(models):
    _, tp = models
    full = llama_infer.encode(tp, torch.as_tensor(TOKENS), CFG,
                              torch.as_tensor(LENGTHS))
    for i, n in enumerate(LENGTHS):
        for bucket in (int(n), 16 * -(-int(n) // 16)):
            alone = llama_infer.encode(
                tp, torch.as_tensor(TOKENS[i:i + 1, :bucket]), CFG,
                torch.as_tensor(LENGTHS[i:i + 1]))
            torch.testing.assert_close(alone[0], full[i], atol=1e-5,
                                       rtol=1e-5)


def test_quantized_bytes_matches_jax(models):
    jp, tp = models
    assert quant.quantized_bytes(tp) == j_quant.quantized_bytes(jp) == \
        4 * CFG.num_params()
    assert quant.quantized_bytes(quant.quantize_weights(tp)) == \
        j_quant.quantized_bytes(j_quant.quantize_weights(jp))
