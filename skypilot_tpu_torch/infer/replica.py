"""Serve replica: HTTP front end over the continuous batcher.

Counterpart of examples/scripts/serve_llama.py's ``BatcherDriver`` and its
``/health`` and ``/generate`` routes, on the standard library's
``http.server.ThreadingHTTPServer`` (one thread per connection; the
batcher runs on one scheduler thread of its own).

POST /generate, JSON: ``{"prompt_ids": [1, 2, 3], "max_new_tokens": 32}``
with token ids in [0, vocab).  A malformed request is a 400, never
silently defaulted.  The response carries ``output_ids``,
``num_generated``, ``latency_s`` and ``ttft_s`` (seconds from admission
queue entry to the first token).  Text prompts, the OpenAI routes and
per-request ``seed`` are ROADMAP.md Queue A item 13; a ``seed`` is
type-checked and acknowledged with ``"seed_ignored": true``, as the JAX
replica does.

Run:  python -m skypilot_tpu_torch.infer.replica --model debug --port 8000
(random weights from --seed; add --device cpu to serve on the host).
"""
from __future__ import annotations

import argparse
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, List, Optional, Tuple

from skypilot_tpu_torch.infer import block_pool as block_pool_lib

_MAX_NEW_TOKENS_CAP = 256


class BatcherDriver:
    """Bridges the request threads to the batcher's scheduler: one
    thread owns the card and steps while work exists; request threads
    submit and wait on an event.  The lock is held across whole decode
    chunks."""

    def __init__(self, batcher):
        self.batcher = batcher
        self.lock = threading.Lock()
        self.wake = threading.Event()
        self.done_events: Dict[int, threading.Event] = {}
        self.failed: Dict[int, str] = {}   # rid -> error message
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


class ReplicaServer(ThreadingHTTPServer):
    """/health and /generate over a BatcherDriver."""

    daemon_threads = True

    def __init__(self, address, driver: BatcherDriver, vocab_size: int,
                 model_name: str, default_max_new_tokens: int = 64):
        super().__init__(address, _Handler)
        self.driver = driver
        self.vocab_size = vocab_size
        self.model_name = model_name
        self.default_max_new_tokens = default_max_new_tokens

    def generate(self, raw: bytes
                 ) -> Tuple[int, Dict[str, Any], Dict[str, str]]:
        """(status, JSON body, extra headers) for one /generate body."""
        try:
            body = json.loads(raw or b'null')
            if not isinstance(body, dict):
                raise TypeError('request body must be a JSON object')
            if 'prompt_ids' not in body:
                return 400, {'error': "provide 'prompt_ids' (token ids)"}, {}
            prompt_ids = [int(t) for t in body['prompt_ids']]
            bad = [t for t in prompt_ids if not 0 <= t < self.vocab_size]
            if bad:
                return 400, {'error': f'prompt_ids out of range '
                                      f'[0, {self.vocab_size}): {bad[:5]}'}, {}
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
            rid, ev = self.driver.submit(prompt_ids, max_new)
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

    def _send(self, status: int, body: Dict[str, Any],
              headers: Optional[Dict[str, str]] = None) -> None:
        data = json.dumps(body).encode()
        self.send_response(status)
        self.send_header('Content-Type', 'application/json')
        self.send_header('Content-Length', str(len(data)))
        for k, v in (headers or {}).items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(data)

    def do_GET(self):  # noqa: N802 (http.server's naming)
        if self.path == '/health':
            self._send(200, {'status': 'ok',
                             'model': self.server.model_name})
        else:
            self._send(404, {'error': f'no route {self.path}'})

    def do_POST(self):  # noqa: N802
        if self.path != '/generate':
            self._send(404, {'error': f'no route {self.path}'})
            return
        length = int(self.headers.get('Content-Length') or 0)
        status, body, headers = self.server.generate(self.rfile.read(length))
        self._send(status, body, headers)

    def log_message(self, format, *args):  # noqa: A002 — quiet by default
        del format, args


def serve(batcher, host: str = '127.0.0.1', port: int = 0,
          model_name: str = 'llama', default_max_new_tokens: int = 64
          ) -> Tuple[ReplicaServer, threading.Thread]:
    """Start a replica over `batcher` in a background thread; returns
    the server (``server.server_address`` has the bound port) and the
    thread.  ``shutdown_replica`` stops both and the driver."""
    driver = BatcherDriver(batcher)
    server = ReplicaServer((host, port), driver, batcher.config.vocab_size,
                           model_name, default_max_new_tokens)
    thread = threading.Thread(target=server.serve_forever, daemon=True,
                              name='replica-http')
    thread.start()
    return server, thread


def shutdown_replica(server: ReplicaServer, thread: threading.Thread,
                     timeout: float = 30.0) -> None:
    server.shutdown()
    server.server_close()
    thread.join(timeout)
    server.driver.close(timeout)


def main(argv=None) -> int:
    import torch

    from skypilot_tpu_torch.device import resolve_device
    from skypilot_tpu_torch.infer.engine import GeneratorConfig
    from skypilot_tpu_torch.infer.serving import ContinuousBatcher
    from skypilot_tpu_torch.models import llama

    presets = {'8b': llama.LLAMA3_8B, '1b': llama.LLAMA_1B,
               'debug': llama.LLAMA_DEBUG}
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--model', choices=sorted(presets), default='debug')
    parser.add_argument('--host', default='0.0.0.0')
    parser.add_argument('--port', type=int, default=8000)
    parser.add_argument('--device', default=None,
                        help='cuda (default) or cpu')
    parser.add_argument('--seed', type=int, default=0)
    parser.add_argument('--batch-size', type=int, default=8)
    parser.add_argument('--max-seq-len', type=int, default=2048)
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
    args = parser.parse_args(argv)

    config = presets[args.model]
    device = resolve_device(args.device)
    generator = torch.Generator(device=device)
    generator.manual_seed(args.seed)
    params = llama.init_params(config, generator, device)
    batcher = ContinuousBatcher(
        params, config,
        GeneratorConfig(max_seq_len=min(args.max_seq_len,
                                        config.max_seq_len),
                        batch_size=args.batch_size,
                        prefill_chunk=args.prefill_chunk,
                        kv_cache_dtype=args.kv_cache_dtype,
                        weights_dtype=args.weights_dtype),
        decode_chunk=args.decode_chunk, max_queue=4 * args.batch_size,
        device=device)
    # Warm the path so the first request does not pay the kernel build.
    warm = batcher.submit([1, 1], max_new_tokens=2)
    batcher.run_until_idle()
    batcher.result(warm)
    server, thread = serve(batcher, args.host, args.port, args.model,
                           args.max_new_tokens)
    print(json.dumps({'serving': args.model,
                      'port': server.server_address[1]}), flush=True)
    try:
        thread.join()
    except KeyboardInterrupt:
        pass
    finally:
        shutdown_replica(server, thread)
    return 0


if __name__ == '__main__':
    raise SystemExit(main())
