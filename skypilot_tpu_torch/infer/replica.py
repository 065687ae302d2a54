"""Serve replica: HTTP front end over the continuous batcher.

Counterpart of examples/scripts/serve_llama.py (``BatcherDriver``,
``build_generator``, ``attach_openai_routes`` and the ``/health`` and
``/generate`` routes), on the standard library's
``http.server.ThreadingHTTPServer`` (one thread per connection; the
batcher runs on one scheduler thread of its own).

POST /generate, JSON: ``{"prompt_ids": [1, 2, 3], "max_new_tokens": 32}``
with token ids in [0, vocab), or ``{"prompt": "text", ...}``, encoded as
its UTF-8 bytes mod the vocabulary (the reference's fallback without a
tokenizer; the port has none).  A malformed request is a 400, never
silently defaulted.  The response carries ``output_ids``,
``num_generated``, ``latency_s`` and ``ttft_s`` (seconds from admission
queue entry to the first token).  Under continuous batching the sampling
noise is engine-level, so a per-request ``seed`` is not supported: it is
type-checked and acknowledged with ``"seed_ignored": true``, as the JAX
replica does.

The OpenAI surface (``attach_openai_routes``): POST /v1/completions and
/v1/chat/completions (``"stream": true`` answers with server-sent events,
``data: {json}`` chunks ended by ``data: [DONE]``, written and flushed
one by one; the connection closes after the stream), GET /v1/models,
and POST /v1/embeddings (mean-pooled final hidden states,
``llama_infer.encode``, run under the driver's lock with the batch padded
to a power of two).  Errors are ``{"error": {"message", "type"}}`` with
type ``invalid_request_error`` on a 400.  An ``X-Skytpu-Trace-Id`` header
is bound around ``submit`` (telemetry/trace.py), so the request's spans
carry it.

Run:  python -m skypilot_tpu_torch.infer.replica --model debug --port 8000
(random weights from --seed, or --hf-model DIR, a local HF checkpoint
directory; add --device cpu to serve on the host).  ``--tp k`` serves one
replica from k rank processes of this host (infer/multihost.py): each
holds its shards (random weights drawn into them, or read from --hf-model
with ``convert.load_hf_model_sharded``), rank 0 serves HTTP through a
MultiHostBatcher and the others replay its calls; /v1/embeddings is
refused there (its forward is not part of the replayed call stream).
"""
from __future__ import annotations

import argparse
import json
import threading
import time
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Dict, List, Optional, Tuple

from skypilot_tpu_torch.infer import block_pool as block_pool_lib
from skypilot_tpu_torch.telemetry import trace as trace_lib

_MAX_NEW_TOKENS_CAP = 256
# Inputs a /v1/embeddings request may carry.
_MAX_EMBED_INPUTS = 64
# Seconds a stream waits for the next scheduler tick before it looks
# again (the driver wakes it after every tick).
_STREAM_POLL_S = 0.05


class BatcherDriver:
    """Bridges the request threads to the batcher's scheduler: one
    thread owns the card and steps while work exists; request threads
    submit and wait on an event, or follow a request tick by tick
    (``partial``).  The lock is held across whole decode chunks."""

    def __init__(self, batcher):
        self.batcher = batcher
        self.lock = threading.Lock()
        self.wake = threading.Event()
        # Notified after every scheduler tick (streams wait on it).
        self.ticked = threading.Condition()
        self.done_events: Dict[int, threading.Event] = {}
        self.failed: Dict[int, str] = {}   # rid -> error message
        self.abandoned: set = set()        # rids whose client went away
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name='batcher-driver')
        self._thread.start()

    def submit(self, prompt, max_new, temperature=None, top_p=None):
        with self.lock:
            rid = self.batcher.submit(prompt, max_new_tokens=max_new,
                                      temperature=temperature, top_p=top_p)
            ev = threading.Event()
            self.done_events[rid] = ev
        self.wake.set()
        return rid, ev

    def result(self, rid) -> Tuple[List[int], Optional[float]]:
        """(tokens, ttft seconds) of a finished request; raises
        RuntimeError if the engine failed it."""
        with self.lock:
            self.done_events.pop(rid, None)
            if rid in self.failed:
                raise RuntimeError(self.failed.pop(rid))
            ttft = self.batcher.ttft(rid)
            return self.batcher.result(rid), ttft

    def partial(self, rid) -> List[int]:
        """Tokens so far (a stream's poll); raises RuntimeError if the
        engine failed the request."""
        with self.lock:
            if rid in self.failed:
                raise RuntimeError(self.failed.pop(rid))
            return self.batcher.partial(rid)

    def abandon(self, rid) -> None:
        """The client went away (or its stream ended): reap the request's
        bookkeeping now if it finished, else as soon as it does."""
        with self.lock:
            self.done_events.pop(rid, None)
            self.failed.pop(rid, None)
            try:
                if self.batcher.is_done(rid):
                    self.batcher.result(rid)   # discard
                else:
                    self.abandoned.add(rid)
            except KeyError:
                pass

    def wait_tick(self, timeout: float) -> None:
        with self.ticked:
            self.ticked.wait(timeout)

    def close(self, timeout: float = 30.0) -> None:
        self._stop.set()
        self.wake.set()
        self._thread.join(timeout)

    def _loop(self):
        while not self._stop.is_set():
            with self.lock:
                busy = self.batcher.num_active or self.batcher.num_queued
            if not busy:
                self.wake.wait(timeout=0.05)
                self.wake.clear()
                continue
            with self.lock:
                try:
                    self.batcher.step()
                except Exception as e:  # noqa: BLE001 — keep serving
                    # Fail the in-flight requests as HTTP errors and
                    # KEEP SERVING: a dead scheduler thread would hang
                    # every later request behind a green /health.
                    msg = f'engine error: {e!r}'
                    for rid, ev in list(self.done_events.items()):
                        self.failed[rid] = msg
                        ev.set()
                    continue
                for rid, ev in list(self.done_events.items()):
                    if self.batcher.is_done(rid):
                        ev.set()
                for rid in list(self.abandoned):
                    if self.batcher.is_done(rid):
                        self.batcher.result(rid)   # discard
                        self.abandoned.discard(rid)
            with self.ticked:
                self.ticked.notify_all()


# ---- text <-> ids without a tokenizer ----------------------------------------

def _encode_text(text: str, config) -> List[int]:
    """Text as its UTF-8 bytes mod the vocabulary."""
    return [b % config.vocab_size for b in str(text).encode('utf-8')]


def _decode_ids(ids: List[int]) -> str:
    return bytes(t % 256 for t in ids).decode('utf-8', errors='replace')


def _chat_to_ids(messages, config) -> List[int]:
    text = ''.join(f"{m.get('role', 'user')}: {m.get('content', '')}\n"
                   for m in messages) + 'assistant: '
    return _encode_text(text, config)


class _HTTPError(Exception):
    """A request that ends in a JSON error response."""

    def __init__(self, status: int, body: Dict[str, Any],
                 headers: Optional[Dict[str, str]] = None):
        super().__init__(status)
        self.status, self.body, self.headers = status, body, headers or {}


def _openai_error(status: int, message: str,
                  kind: str = 'invalid_request_error',
                  headers: Optional[Dict[str, str]] = None) -> _HTTPError:
    return _HTTPError(status, {'error': {'message': message, 'type': kind}},
                      headers)


class ReplicaServer(ThreadingHTTPServer):
    """/health and /generate over a BatcherDriver; more routes join
    ``get_routes``/``post_routes`` (``attach_openai_routes``).  A GET
    route is ``fn(handler)``, a POST route ``fn(handler, raw_body)``;
    each answers through ``handler.send_json`` or streams."""

    daemon_threads = True

    def __init__(self, address, driver: BatcherDriver, config,
                 model_name: str, default_max_new_tokens: int = 64):
        super().__init__(address, _Handler)
        self.driver = driver
        self.config = config
        self.vocab_size = config.vocab_size
        self.model_name = model_name
        self.default_max_new_tokens = default_max_new_tokens
        self.get_routes: Dict[str, Callable] = {'/health': self._health}
        self.post_routes: Dict[str, Callable] = {
            '/generate': lambda handler, raw: handler.send_json(
                *self.generate(raw, handler.headers.get(
                    trace_lib.TRACE_HEADER)))}

    def _health(self, handler) -> None:
        handler.send_json(200, {'status': 'ok', 'model': self.model_name})

    def submit(self, prompt_ids, max_new, temperature=None, top_p=None,
               trace_id=None):
        """driver.submit with the request's trace id bound."""
        with trace_lib.trace_scope(trace_id):
            return self.driver.submit(prompt_ids, max_new, temperature,
                                      top_p)

    def generate(self, raw: bytes, trace_id: Optional[str] = None
                 ) -> Tuple[int, Dict[str, Any], Dict[str, str]]:
        """(status, JSON body, extra headers) for one /generate body."""
        try:
            body = json.loads(raw or b'null')
            if not isinstance(body, dict):
                raise TypeError('request body must be a JSON object')
            if 'prompt_ids' in body:
                prompt_ids = [int(t) for t in body['prompt_ids']]
                bad = [t for t in prompt_ids
                       if not 0 <= t < self.vocab_size]
                if bad:
                    return 400, {'error': f'prompt_ids out of range '
                                          f'[0, {self.vocab_size}): '
                                          f'{bad[:5]}'}, {}
            elif 'prompt' in body:
                prompt_ids = _encode_text(body['prompt'], self.config)
            else:
                return 400, {'error': "provide 'prompt_ids' (token ids) or "
                                      "'prompt' (text, byte encoded)"}, {}
            max_new = min(int(body.get('max_new_tokens',
                                       self.default_max_new_tokens)),
                          _MAX_NEW_TOKENS_CAP)
            seed_sent = 'seed' in body
            if seed_sent:
                int(body['seed'])   # type-checked though unused
        except (TypeError, ValueError) as e:
            return 400, {'error': f'malformed request: {e}'}, {}
        if not prompt_ids:
            return 400, {'error': 'empty prompt'}, {}
        t0 = time.monotonic()
        try:
            rid, ev = self.submit(prompt_ids, max_new, trace_id=trace_id)
        except block_pool_lib.PoolExhaustedError as e:
            # Transient exhaustion -> retryable 503 + Retry-After; a
            # request that can never fit the pool -> 400.
            if e.retry_after_s is None:
                return 400, {'error': str(e)}, {}
            return 503, {'error': str(e)}, {
                'Retry-After': str(max(1, int(e.retry_after_s + 0.999)))}
        except ValueError as e:
            return 400, {'error': str(e)}, {}
        ev.wait()
        try:
            out, ttft = self.driver.result(rid)
        except RuntimeError as e:
            return 500, {'error': str(e)}, {}
        resp = {'output_ids': out, 'num_generated': len(out),
                'latency_s': round(time.monotonic() - t0, 3),
                'ttft_s': ttft}
        if seed_sent:
            resp['seed_ignored'] = True
        return 200, resp, {}


class _Handler(BaseHTTPRequestHandler):
    server: ReplicaServer

    def send_json(self, status: int, body: Dict[str, Any],
                  headers: Optional[Dict[str, str]] = None) -> None:
        data = json.dumps(body).encode()
        self.send_response(status)
        self.send_header('Content-Type', 'application/json')
        self.send_header('Content-Length', str(len(data)))
        for k, v in (headers or {}).items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(data)

    def start_stream(self) -> None:
        """Headers of a server-sent-events response; the body follows
        chunk by chunk and ends when the connection closes."""
        self.send_response(200)
        self.send_header('Content-Type', 'text/event-stream')
        self.send_header('Cache-Control', 'no-cache')
        self.send_header('Connection', 'close')
        self.end_headers()
        self.close_connection = True

    def write_chunk(self, data: bytes) -> None:
        self.wfile.write(data)
        self.wfile.flush()

    def _route(self, routes, *args):
        fn = routes.get(self.path)
        if fn is None:
            self.send_json(404, {'error': f'no route {self.path}'})
            return
        try:
            fn(self, *args)
        except _HTTPError as e:
            self.send_json(e.status, e.body, e.headers)

    def do_GET(self):  # noqa: N802 (http.server's naming)
        self._route(self.server.get_routes)

    def do_POST(self):  # noqa: N802
        length = int(self.headers.get('Content-Length') or 0)
        raw = self.rfile.read(length)
        self._route(self.server.post_routes, raw)

    def log_message(self, format, *args):  # noqa: A002 — quiet by default
        del format, args


# ---- the OpenAI surface -------------------------------------------------------

def attach_openai_routes(server: ReplicaServer, *, model_name: str,
                         default_max_tokens: int,
                         eos_token: Optional[int] = None) -> None:
    """Add /v1/completions, /v1/chat/completions, /v1/models and
    /v1/embeddings to `server` (the reference's routes, validation,
    error shapes, usage, finish_reason and stop handling)."""
    driver, config = server.driver, server.config

    def finish_reason(out):
        return 'stop' if (eos_token is not None and out
                          and out[-1] == eos_token) else 'length'

    def strip_eos(out):
        if eos_token is not None and out and out[-1] == eos_token:
            return out[:-1]
        return out

    def apply_stop(text, stop):
        """(text, hit): truncated at the first stop sequence."""
        if not stop:
            return text, False
        seqs = [stop] if isinstance(stop, str) else list(stop)
        cut = min((text.find(s) for s in seqs if s and text.find(s) >= 0),
                  default=-1)
        if cut >= 0:
            return text[:cut], True
        return text, False

    def parse(raw: bytes, *, chat: bool):
        """-> (prompt_ids, opts); raises _HTTPError."""
        try:
            body = json.loads(raw or b'null')
        except ValueError:
            raise _openai_error(400, 'invalid JSON body') from None
        try:
            if not isinstance(body, dict):
                raise ValueError('request body must be a JSON object')
            if int(body.get('n', 1)) != 1:
                raise _openai_error(400, 'only n=1 is supported')
            if chat:
                messages = body.get('messages')
                if not isinstance(messages, list) or not messages:
                    raise ValueError("'messages' must be a non-empty list")
                ids = _chat_to_ids(messages, config)
            else:
                prompt = body.get('prompt')
                if isinstance(prompt, str):
                    ids = _encode_text(prompt, config)
                elif isinstance(prompt, list) and prompt and \
                        all(isinstance(t, int) for t in prompt):
                    ids = [int(t) for t in prompt]
                elif isinstance(prompt, list) and len(prompt) == 1 and \
                        isinstance(prompt[0], str):
                    ids = _encode_text(prompt[0], config)
                else:
                    raise ValueError(
                        "'prompt' must be a string, a token-id list, or "
                        'a single-string list')
            bad = [t for t in ids if not 0 <= t < config.vocab_size]
            if bad:
                raise ValueError(f'token ids out of range: {bad[:5]}')
            opts = {
                'max_tokens': min(int(body.get('max_tokens',
                                               default_max_tokens)),
                                  _MAX_NEW_TOKENS_CAP),
                'stream': bool(body.get('stream', False)),
                'stop': body.get('stop'),
                # Per-request sampling, honored per decode slot; absent
                # -> the server defaults.
                'temperature': (None if body.get('temperature') is None
                                else float(body['temperature'])),
                'top_p': (None if body.get('top_p') is None
                          else float(body['top_p'])),
            }
        except (TypeError, ValueError) as e:
            raise _openai_error(400, str(e)) from None
        if not ids:
            raise _openai_error(400, 'empty prompt')
        return ids, opts

    def usage(prompt_ids, out):
        return {'prompt_tokens': len(prompt_ids),
                'completion_tokens': len(out),
                'total_tokens': len(prompt_ids) + len(out)}

    def stream(handler, rid, ev, opts, *, chat, rid_str, created):
        def chunk(delta_text=None, finish=None, first=False):
            if chat:
                delta = {}
                if first:
                    delta['role'] = 'assistant'
                if delta_text:
                    delta['content'] = delta_text
                choice = {'index': 0, 'delta': delta,
                          'finish_reason': finish}
                obj = 'chat.completion.chunk'
            else:
                choice = {'index': 0, 'text': delta_text or '',
                          'logprobs': None, 'finish_reason': finish}
                obj = 'text_completion'
            payload = {'id': rid_str, 'object': obj, 'created': created,
                       'model': model_name, 'choices': [choice]}
            return f'data: {json.dumps(payload)}\n\n'.encode()

        def emit_safe_length(text, stop, final):
            """How much of `text` can stream now without retraction: hold
            back a trailing replacement character (a multi-byte character
            decodes as U+FFFD until its last byte arrives) and any suffix
            that is a prefix of a stop sequence."""
            n = len(text)
            if not final:
                while n > 0 and text[n - 1] == '�':
                    n -= 1
                seqs = ([stop] if isinstance(stop, str)
                        else list(stop or []))
                for s in seqs:
                    for k in range(min(len(s), n), 0, -1):
                        if text[n - k:n] == s[:k]:
                            n -= k
                            break
            return n

        handler.start_stream()
        sent_text = ''
        stopped = False
        try:
            if chat:
                handler.write_chunk(chunk(first=True))
            while True:
                done = ev.is_set()
                out = strip_eos(driver.partial(rid))
                if not done:
                    # Hold the newest token back, as the reference does
                    # (with a tokenizer its text can change when the next
                    # token completes a merge).
                    out = out[:-1] if out else out
                text, hit = apply_stop(_decode_ids(out), opts['stop'])
                safe = text[:emit_safe_length(text, opts['stop'],
                                              final=hit or done)]
                if safe.startswith(sent_text) and \
                        len(safe) > len(sent_text):
                    handler.write_chunk(chunk(safe[len(sent_text):]))
                    sent_text = safe
                if hit:
                    stopped = True
                    break
                if done:
                    break
                driver.wait_tick(_STREAM_POLL_S)
            final = driver.partial(rid)
            reason = 'stop' if stopped else finish_reason(final)
            handler.write_chunk(chunk(finish=reason))
            handler.write_chunk(b'data: [DONE]\n\n')
        finally:
            driver.abandon(rid)  # reap whether finished or cut short

    def complete(handler, raw, *, chat: bool):
        prompt_ids, opts = parse(raw, chat=chat)
        created = int(time.time())
        rid_str = ('chatcmpl-' if chat else 'cmpl-') + uuid.uuid4().hex[:24]
        try:
            rid, ev = server.submit(
                prompt_ids, opts['max_tokens'], opts['temperature'],
                opts['top_p'],
                trace_id=handler.headers.get(trace_lib.TRACE_HEADER))
        except block_pool_lib.PoolExhaustedError as e:
            # retry_after_s set: transient exhaustion, a retryable 503;
            # None: the request can never fit the pool, a 400.
            if e.retry_after_s is None:
                raise _openai_error(400, str(e)) from None
            raise _openai_error(
                503, str(e), 'overloaded_error',
                {'Retry-After': str(max(1, int(e.retry_after_s + 0.999)))}
            ) from None
        except ValueError as e:
            raise _openai_error(400, str(e)) from None
        if opts['stream']:
            stream(handler, rid, ev, opts, chat=chat, rid_str=rid_str,
                   created=created)
            return
        ev.wait()
        try:
            out, _ = driver.result(rid)
        except RuntimeError as e:
            raise _openai_error(500, str(e), 'server_error') from None
        finish = finish_reason(out)
        trimmed = strip_eos(out)
        text, hit = apply_stop(_decode_ids(trimmed), opts['stop'])
        if hit:
            finish = 'stop'
        if chat:
            choice = {'index': 0,
                      'message': {'role': 'assistant', 'content': text},
                      'finish_reason': finish}
            obj = 'chat.completion'
        else:
            choice = {'index': 0, 'text': text, 'logprobs': None,
                      'finish_reason': finish}
            obj = 'text_completion'
        handler.send_json(200, {
            'id': rid_str, 'object': obj, 'created': created,
            'model': model_name, 'choices': [choice],
            'usage': usage(prompt_ids, trimmed)})

    def models(handler):
        handler.send_json(200, {
            'object': 'list',
            'data': [{'id': model_name, 'object': 'model', 'created': 0,
                      'owned_by': 'skypilot-tpu'}]})

    def embeddings(handler, raw):
        try:
            body = json.loads(raw or b'null')
            if not isinstance(body, dict):
                raise ValueError('request body must be a JSON object')
            items = body.get('input')
            if items is None:
                raise ValueError("'input' is required")
            if isinstance(items, str) or (
                    isinstance(items, list) and items
                    and isinstance(items[0], int)):
                items = [items]
            if not isinstance(items, list) or not items or \
                    len(items) > _MAX_EMBED_INPUTS:
                raise ValueError(f"'input' must be 1..{_MAX_EMBED_INPUTS} "
                                 f'strings or token-id lists')
            ids_list = []
            for item in items:
                if isinstance(item, list):
                    ids = list(item)
                elif isinstance(item, str):
                    ids = _encode_text(item, config)
                else:
                    raise ValueError(
                        'each input must be a string or a token-id '
                        f'list, got {type(item).__name__}')
                if not ids:
                    raise ValueError('empty input')
                bad = [t for t in ids
                       if not isinstance(t, int)
                       or not 0 <= t < config.vocab_size]
                if bad:
                    raise ValueError(
                        f'token ids must be ints in [0, '
                        f'{config.vocab_size}): {bad[:5]}')
                ids_list.append(ids)
            vecs, n_tokens = embed(driver, config, ids_list)
        except (TypeError, ValueError) as e:
            raise _openai_error(400, str(e)) from None
        handler.send_json(200, {
            'object': 'list', 'model': model_name,
            'data': [{'object': 'embedding', 'index': i,
                      'embedding': [float(x) for x in vecs[i]]}
                     for i in range(len(ids_list))],
            'usage': {'prompt_tokens': n_tokens,
                      'total_tokens': n_tokens}})

    server.post_routes['/v1/completions'] = \
        lambda handler, raw: complete(handler, raw, chat=False)
    server.post_routes['/v1/chat/completions'] = \
        lambda handler, raw: complete(handler, raw, chat=True)
    server.post_routes['/v1/embeddings'] = embeddings
    server.get_routes['/v1/models'] = models


def embed(driver: BatcherDriver, config, ids_list: List[List[int]]):
    """(vectors (n, d) f32 numpy, prompt tokens) of token-id lists
    through ``llama_infer.encode`` on the batcher's weights, under the
    driver's lock (one owner of the card).  The rows are right-padded to
    the smallest prompt bucket that holds the longest, and the batch to
    a power of two (pad rows carry length 1 over token 0 and are dropped
    from the reply), so few shapes reach the kernels; raises ValueError
    past the largest bucket."""
    import numpy as np
    import torch

    from skypilot_tpu_torch.infer import llama_infer

    batcher = driver.batcher
    if getattr(batcher, 'mesh', None) is not None:
        raise ValueError('embeddings are not served by a tensor-parallel '
                         'replica: the worker ranks replay the scheduler '
                         'calls only')
    longest = max(len(i) for i in ids_list)
    bucket = next((b for b in batcher.buckets if longest <= b), None)
    if bucket is None:
        raise ValueError(f'input length {longest} exceeds the largest '
                         f'bucket {batcher.buckets[-1]}')
    n_real = len(ids_list)
    n_pad = 1
    while n_pad < n_real:
        n_pad *= 2
    tokens = np.zeros((n_pad, bucket), np.int32)
    lengths = np.ones((n_pad,), np.int32)
    for i, ids in enumerate(ids_list):
        tokens[i, :len(ids)] = np.asarray(ids, np.int32)
        lengths[i] = len(ids)
    with driver.lock, torch.inference_mode():
        dev = batcher.device
        vecs = llama_infer.encode(
            batcher.params, torch.as_tensor(tokens, device=dev), config,
            torch.as_tensor(lengths, device=dev)).cpu().numpy()
    return vecs[:n_real], int(lengths[:n_real].sum())


def serve(batcher, host: str = '127.0.0.1', port: int = 0,
          model_name: str = 'llama', default_max_new_tokens: int = 64,
          eos_token: Optional[int] = None
          ) -> Tuple[ReplicaServer, threading.Thread]:
    """Start a replica over `batcher` (with the OpenAI routes) in a
    background thread; returns the server (``server.server_address`` has
    the bound port) and the thread.  ``shutdown_replica`` stops both and
    the driver."""
    driver = BatcherDriver(batcher)
    server = ReplicaServer((host, port), driver, batcher.config,
                           model_name, default_max_new_tokens)
    attach_openai_routes(server, model_name=model_name,
                         default_max_tokens=default_max_new_tokens,
                         eos_token=eos_token)
    thread = threading.Thread(target=server.serve_forever, daemon=True,
                              name='replica-http')
    # Returned to the caller; shutdown_replica joins it.
    thread.start()  # skytpu-allow: SKY503
    return server, thread


def shutdown_replica(server: ReplicaServer, thread: threading.Thread,
                     timeout: float = 30.0) -> None:
    server.shutdown()
    server.server_close()
    thread.join(timeout)
    server.driver.close(timeout)


MODEL_SIZES = ('debug', 'tiny-tp', '1b', '8b')


def _tiny_tp():
    import torch

    from skypilot_tpu_torch.models import llama
    # A smoke size whose 4 KV heads divide over a tp mesh (LLAMA_DEBUG's
    # one KV head cannot), as the reference's 'tiny-tp'.
    return llama.LlamaConfig(
        vocab_size=512, d_model=128, n_layers=2, n_heads=8, n_kv_heads=4,
        d_ff=256, max_seq_len=512, dtype=torch.float32, remat=False)


TINY_TP = _tiny_tp()


def build_generator(model_size: str = 'debug', max_seq_len: int = 2048,
                    temperature: float = 0.0, hf_model: str = '',
                    batch_size: int = 8, *, device=None, seed: int = 0,
                    kv_cache_dtype=None, weights_dtype=None,
                    prefill_chunk=None, decode_chunk: int = 16,
                    max_queue: Optional[int] = None, mesh_builder=None):
    """(batcher, config) of an entry point: the model is the local HF
    checkpoint directory `hf_model` (models/convert.py), else the
    `model_size` preset with random weights from `seed`; on `device`
    (default: the card).  max_seq_len is capped at the model's.  Without
    a tokenizer there is no eos token (the reference takes it from one).
    mesh_builder: config -> mesh (infer/multihost.make_replica_mesh) for
    one rank of a tensor-parallel replica, whose weights are then drawn
    or read straight into its shards.  Shared by the replica and
    batch_infer, as the reference's build_generator."""
    import torch

    from skypilot_tpu_torch.device import resolve_device
    from skypilot_tpu_torch.infer.engine import GeneratorConfig
    from skypilot_tpu_torch.infer.serving import ContinuousBatcher
    from skypilot_tpu_torch.models import convert, llama

    from skypilot_tpu_torch.infer import tp as tp_lib

    device = resolve_device(device)
    mesh = None
    if hf_model:
        if mesh_builder is None:
            params, config = convert.load_hf_model(hf_model, device=device)
        else:
            config = convert.read_hf_config(hf_model)
            mesh = mesh_builder(config)
            params, config = convert.load_hf_model_sharded(
                hf_model, mesh, device=device)
    else:
        config = {'8b': llama.LLAMA3_8B, '1b': llama.LLAMA_1B,
                  'debug': llama.LLAMA_DEBUG,
                  'tiny-tp': TINY_TP}[model_size]
        generator = torch.Generator(device=device)
        generator.manual_seed(seed)
        if mesh_builder is None:
            params = llama.init_params(config, generator, device)
        else:
            mesh = mesh_builder(config)
            params = tp_lib.init_sharded_params(config, generator, mesh,
                                                device)
    batcher = ContinuousBatcher(
        params, config,
        GeneratorConfig(max_seq_len=min(max_seq_len, config.max_seq_len),
                        batch_size=batch_size, temperature=temperature,
                        prefill_chunk=prefill_chunk,
                        kv_cache_dtype=kv_cache_dtype,
                        weights_dtype=weights_dtype),
        decode_chunk=decode_chunk, max_queue=max_queue, device=device,
        mesh=mesh)
    return batcher, config


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--model', '--model-size', dest='model',
                        choices=MODEL_SIZES, default='debug')
    parser.add_argument('--hf-model', default='',
                        help='serve a local HF checkpoint directory '
                             'instead of random weights')
    parser.add_argument('--host', default='0.0.0.0')
    parser.add_argument('--port', type=int, default=8000)
    parser.add_argument('--device', default=None,
                        help='cuda (default) or cpu')
    parser.add_argument('--seed', type=int, default=0)
    parser.add_argument('--batch-size', type=int, default=8)
    parser.add_argument('--max-seq-len', type=int, default=2048)
    parser.add_argument('--temperature', type=float, default=0.0,
                        help='the default of requests that name none')
    parser.add_argument('--prefill-chunk', type=int, default=None)
    parser.add_argument('--kv-cache-dtype', default=None,
                        choices=[None, 'int8'],
                        help='int8: quantized KV arena (per-row scales)')
    parser.add_argument('--weights-dtype', default=None,
                        choices=[None, 'int8'],
                        help='int8: weight-only quantization '
                             '(per-out-channel scales)')
    parser.add_argument('--decode-chunk', type=int, default=16)
    parser.add_argument('--max-new-tokens', type=int, default=64)
    parser.add_argument('--tp', type=int, default=1,
                        help='serve from this many rank processes of '
                             'this host (one card each, or sharing it)')
    args = parser.parse_args(argv)
    if args.tp > 1:
        from skypilot_tpu_torch.infer import multihost
        multihost.launch_local_ranks(args.tp, _replica_rank, (vars(args),))
        return 0
    _serve_replica(args, build_generator(
        args.model, args.max_seq_len, args.temperature, args.hf_model,
        args.batch_size, device=args.device, seed=args.seed,
        kv_cache_dtype=args.kv_cache_dtype,
        weights_dtype=args.weights_dtype, prefill_chunk=args.prefill_chunk,
        decode_chunk=args.decode_chunk, max_queue=4 * args.batch_size)[0])
    return 0


def rank_generator(local_rank: int, world: int, args):
    """One rank of a `world`-process replica: join the host's process
    group (the env contract launch_local_ranks set), build the batcher
    over this rank's shards on its device, and open the control channel.
    Returns (the batcher, or on rank 0 the MultiHostBatcher over it;
    the channel)."""
    from skypilot_tpu_torch.infer import multihost
    device = multihost.rank_device(args.device, local_rank)
    info = multihost.initialize_from_env(
        backend=multihost.default_backend(args.device, world),
        procs_per_host=world, local_rank=local_rank)
    batcher, _ = build_generator(
        args.model_size if hasattr(args, 'model_size') else args.model,
        args.max_seq_len, args.temperature, args.hf_model,
        args.batch_size, device=device, seed=args.seed,
        kv_cache_dtype=args.kv_cache_dtype,
        weights_dtype=args.weights_dtype, prefill_chunk=args.prefill_chunk,
        decode_chunk=getattr(args, 'decode_chunk', 16),
        max_queue=4 * args.batch_size,
        mesh_builder=lambda cfg: multihost.make_replica_mesh(
            n_kv_heads=cfg.n_kv_heads))
    if info['rank'] == 0:
        channel = multihost.ControlChannel.head(info['control_port'],
                                                world - 1)
        return multihost.MultiHostBatcher(batcher, channel), channel
    channel = multihost.ControlChannel.connect(info['coordinator_host'],
                                               info['control_port'])
    return batcher, channel


def _replica_rank(local_rank: int, world: int, argd: dict) -> None:
    from skypilot_tpu_torch.infer import multihost
    batcher, channel = rank_generator(local_rank, world,
                                      argparse.Namespace(**argd))
    if channel.role == 'worker':
        multihost.worker_loop(batcher, channel)
        return
    try:
        _serve_replica(argparse.Namespace(**argd), batcher)
    finally:
        batcher.shutdown()


def _serve_replica(args, batcher) -> None:
    """Warm `batcher`, serve it over HTTP until interrupted."""
    # Warm the path so the first request does not pay the kernel build.
    warm = batcher.submit([1, 1], max_new_tokens=2)
    batcher.run_until_idle()
    batcher.result(warm)
    name = args.hf_model or args.model
    server, thread = serve(batcher, args.host, args.port, name,
                           args.max_new_tokens)
    print(json.dumps({'serving': name, 'port': server.server_address[1]}),
          flush=True)
    try:
        thread.join()
    except KeyboardInterrupt:
        pass
    finally:
        shutdown_replica(server, thread)


if __name__ == '__main__':
    raise SystemExit(main())
