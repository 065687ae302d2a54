#!/usr/bin/env python3
"""Phase 20 of chip_smoke.py alone: the compile-budget audit
(skypilot_tpu_torch/analysis/audit.py) on the card.  Builds the kernels
(or reuses the build), then (b) serves LLAMA_DEBUG f32 requests through
graphed batchers watched from construction (pooled with spec_k and
fuse_budget, and the legacy 'paged' plane across its cache buckets) in
place of phases 5-7's 8B batchers, and runs chip_smoke.audit_path: (a)
run_audit with real graphs, (b) those batchers' graph budgets, (c) a
decode chunk that reads int(token[0]) must fail the audit.

Run from the root of a checkout on a card:
    python3 scripts/torch_audit_smoke.py
"""
from __future__ import annotations

import json
import os
import sys
import time
import warnings

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

import chip_smoke as cs  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

# LLAMA_DEBUG batchers standing in for phases 5-7's (decode_chunk 4).
ARMS = {
    'pooled spec+fused': dict(max_seq_len=256, batch_size=3,
                              prompt_buckets=[16, 64], prefill_chunk=32,
                              fuse_budget=40, spec_k=3),
    'paged': dict(max_seq_len=256, batch_size=3, prompt_buckets=[16, 64],
                  decode_impl='paged', cache_buckets=[64, 128, 256]),
}


def serve_budgets(params, cfg):
    """Each arm's graph budgets over 6 requests that cross its buckets."""
    from skypilot_tpu_torch.analysis import audit
    from skypilot_tpu_torch.infer.engine import GeneratorConfig
    from skypilot_tpu_torch.infer.serving import ContinuousBatcher
    rng = np.random.RandomState(3)
    prompts = [[int(t) for t in rng.randint(1, cfg.vocab_size, size=n)]
               for n in (5, 60, 12, 40, 3, 50)]
    out = {}
    for name, kw in ARMS.items():
        with warnings.catch_warnings():
            warnings.simplefilter('ignore', DeprecationWarning)
            b = ContinuousBatcher(params, cfg, GeneratorConfig(**kw),
                                  decode_chunk=4, device='cuda')
        audit.watch(b)
        before = audit.addresses(b)
        rids = [b.submit(p, max_new_tokens=n)
                for p, n in zip(prompts, (150, 20, 90, 30, 120, 10))]
        b.run_until_idle()
        for r in rids:
            b.result(r)
        out[name] = audit.graph_budgets(b, before)
        out[name]['migrations'] = dict(b.migrations)
        b.close()
    return out


def main(argv) -> int:
    if not torch.cuda.is_available():
        print('torch_audit_smoke: no CUDA device', file=sys.stderr)
        return 2
    from skypilot_tpu_torch.models import llama
    from skypilot_tpu_torch.ops import _kernels
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cs.CARD['line'] = cs.nvidia_smi_line()
    cs.CARD['kind'] = torch.cuda.get_device_name(0)
    start = time.perf_counter()
    _kernels.LIBRARY.get()
    cs.log(f'build {time.perf_counter() - start:.1f} s; {cs.CARD["line"]}')
    cfg = llama.LLAMA_DEBUG
    params = llama.init_params(
        cfg, torch.Generator(device='cuda').manual_seed(0), 'cuda')
    t0 = time.perf_counter()
    budgets = serve_budgets(params, cfg)
    cs.log(f'served the budget arms in {time.perf_counter() - t0:.1f} s')
    t0 = time.perf_counter()
    audit_s = cs.audit_path(budgets)
    cs.log(json.dumps({'card': cs.CARD['line'], 'run_audit_s': audit_s,
                       'phase_s': time.perf_counter() - t0,
                       'seconds': time.perf_counter() - start}))
    return 0


if __name__ == '__main__':
    sys.exit(main(sys.argv[1:]))
