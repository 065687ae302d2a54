"""The port's offline entry points on the CPU: ``python -m
skypilot_tpu_torch.infer.batch_infer`` and ``python -m
skypilot_tpu_torch.train.eval_ppl`` (the cases of tests/test_batch_infer.py
and tests/test_eval_ppl.py), with eval_ppl's NLL held against the JAX
package's ``nll_and_count`` computation (examples/scripts/eval_ppl.py).

What must hold:
- batch_infer writes one line per prompt ({"id", "prompt_tokens",
  "output_ids"}), ids defaulting to the line index, text prompts byte
  encoded, and a rerun gives the same tokens;
- ``--resume`` skips the ids already written and appends the rest, so
  every id is written exactly once, and the resumed lines equal an
  uninterrupted run's (greedy, f32);
- ``--dp``/``--fsdp``/``--tp`` above 1 score eval_ppl on a training
  mesh, its NLL within 1e-5 relative of one rank's;
- eval_ppl prints {"perplexity", "nll", "tokens", "seqs"}, drops and
  reports a ragged tail, reads JSONL "text" lines, refuses a corpus
  shorter than one window, and is deterministic;
- its summed NLL equals the JAX computation's on the same weights and
  windows to 1e-5 relative, with and without ``--loss-chunk``.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip('torch')

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from skypilot_tpu.models import llama as j_llama  # noqa: E402
from skypilot_tpu.ops import losses as j_losses  # noqa: E402
from skypilot_tpu_torch.models import llama  # noqa: E402
from skypilot_tpu_torch.train import eval_ppl  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(module, args, timeout=300):
    # One torch thread: several test workers share the host's cores.
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS='1')
    return subprocess.run(
        [sys.executable, '-m', f'skypilot_tpu_torch.{module}'] + args
        + ['--device', 'cpu'], cwd=ROOT, capture_output=True, text=True,
        env=env, timeout=timeout)


def _batch(args):
    return _run('infer.batch_infer', args)


def _rows(path):
    return [json.loads(line) for line in open(path, encoding='utf-8')]


SMALL = ['--model-size', 'debug', '--batch-size', '2', '--max-seq-len',
         '64']


def test_batch_infer_end_to_end(tmp_path):
    inp = tmp_path / 'prompts.jsonl'
    with open(inp, 'w', encoding='utf-8') as f:
        for i in range(7):
            f.write(json.dumps({'id': f'p{i}',
                                'prompt_ids': [5 + i, 9, 2]}) + '\n')
        f.write(json.dumps({'prompt': 'text prompt'}) + '\n')
    out = tmp_path / 'gen.jsonl'
    proc = _batch(['--input', str(inp), '--output', str(out),
                   '--max-new-tokens', '6'] + SMALL)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert 'batch_infer: 8 prompts (0 already done)' in proc.stdout
    rows = _rows(out)
    assert len(rows) == 8
    assert {r['id'] for r in rows} == {f'p{i}' for i in range(7)} | {7}
    assert all(len(r['output_ids']) == 6 for r in rows)
    assert all(set(r) == {'id', 'prompt_tokens', 'output_ids'}
               for r in rows)
    assert {r['id']: r['prompt_tokens'] for r in rows}[7] == \
        len('text prompt')
    out2 = tmp_path / 'gen2.jsonl'
    proc = _batch(['--input', str(inp), '--output', str(out2),
                   '--max-new-tokens', '6'] + SMALL)
    assert proc.returncode == 0
    assert {r['id']: r['output_ids'] for r in rows} == \
        {r['id']: r['output_ids'] for r in _rows(out2)}


def test_batch_infer_resume_skips_done(tmp_path):
    inp = tmp_path / 'prompts.jsonl'
    with open(inp, 'w', encoding='utf-8') as f:
        for i in range(4):
            f.write(json.dumps({'id': i, 'prompt_ids': [7, i + 1]})
                    + '\n')
    out = tmp_path / 'gen.jsonl'
    # A preempted run that finished ids 0 and 2.
    with open(out, 'w', encoding='utf-8') as f:
        f.write(json.dumps({'id': 0, 'prompt_tokens': 2,
                            'output_ids': [1]}) + '\n')
        f.write(json.dumps({'id': 2, 'prompt_tokens': 2,
                            'output_ids': [1]}) + '\n')
    proc = _batch(['--input', str(inp), '--output', str(out),
                   '--max-new-tokens', '4', '--resume'] + SMALL)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert '2 prompts (2 already done)' in proc.stdout
    rows = _rows(out)
    assert sorted(r['id'] for r in rows) == [0, 1, 2, 3]
    assert sum(1 for r in rows if r['output_ids'] == [1]) == 2


def test_batch_infer_resume_after_a_cut_writes_each_id_once(tmp_path):
    """A run cut after some lines (a torn last line included), resumed:
    every id exactly once, and the resumed lines equal an uninterrupted
    run's."""
    inp = tmp_path / 'prompts.jsonl'
    rng = np.random.RandomState(4)
    with open(inp, 'w', encoding='utf-8') as f:
        for i in range(10):
            if i % 2:
                f.write(json.dumps({'prompt': f'text {i} ' * (i + 1)})
                        + '\n')
            else:
                f.write(json.dumps({'prompt_ids': [int(t) for t in rng.randint(
                    0, 512, size=3 + 4 * i)]}) + '\n')
    full = tmp_path / 'full.jsonl'
    small = SMALL[:-1] + ['128']
    proc = _batch(['--input', str(inp), '--output', str(full),
                   '--max-new-tokens', '5'] + small)
    assert proc.returncode == 0, proc.stderr
    lines = open(full, encoding='utf-8').read().splitlines()
    cut = tmp_path / 'cut.jsonl'
    cut.write_text('\n'.join(lines[:4]) + '\n' + lines[4][:9])
    proc = _batch(['--input', str(inp), '--output', str(cut),
                   '--max-new-tokens', '5', '--resume'] + small)
    assert proc.returncode == 0, proc.stderr
    assert '6 prompts (4 already done)' in proc.stdout
    got = [json.loads(line) for line in
           open(cut, encoding='utf-8').read().splitlines()[:4]]
    tail = open(cut, encoding='utf-8').read().splitlines()[4]
    got += [json.loads(line) for line in
            open(cut, encoding='utf-8').read().splitlines()[5:]]
    assert tail.startswith(lines[4][:9])        # the torn line stays
    ids = sorted(r['id'] for r in got)
    assert ids == list(range(10))
    want = {r['id']: r['output_ids'] for r in _rows(full)}
    assert {r['id']: r['output_ids'] for r in got} == want


def test_entry_points_refuse_meshes_naming_11g(tmp_path):
    """eval_ppl's --dp 2 and --fsdp 2 score on a training mesh of 2 rank
    processes (gloo), their NLL within 1e-5 relative of one rank's;
    batch_infer's serving tp (--tp) is carried, and a --tp 2 run gives
    the --tp 1 run's output (one process a rank, gloo); so is
    eval_ppl's --tp, on the same training mesh as --dp and --fsdp."""
    inp = tmp_path / 'p.jsonl'
    inp.write_text(json.dumps({'prompt_ids': [1, 2]}) + '\n'
                   + json.dumps({'prompt': 'two ranks'}) + '\n')
    corpus = tmp_path / 'corpus.txt'
    corpus.write_text('the quick brown fox jumps over the lazy dog. ' * 40)
    scored = [_run('train.eval_ppl', ['--data-file', str(corpus),
                                      '--seq-len', '32', '--batch-size', '4',
                                      '--max-batches', '2', '--loss-chunk',
                                      '16', *flag])
              for flag in ((), ('--dp', '2'), ('--fsdp', '2'))]
    assert all(p.returncode == 0 for p in scored), \
        [p.stderr[-2000:] for p in scored]
    one, *meshes = (json.loads(p.stdout.splitlines()[-1]) for p in scored)
    for got in meshes:
        # f32: each rank's sum, and the ranks' added in rank order.
        assert got['nll'] == pytest.approx(one['nll'], rel=1e-5)
        assert (got['tokens'], got['seqs']) == (one['tokens'], one['seqs'])
    outs = []
    for tp in ('1', '2'):
        out = tmp_path / f'o{tp}.jsonl'
        proc = _batch(['--input', str(inp), '--output', str(out),
                       '--model-size', 'tiny-tp', '--max-new-tokens', '6',
                       '--batch-size', '2', '--tp', tp])
        assert proc.returncode == 0, proc.stdout + proc.stderr
        outs.append(_rows(out))
    assert outs[0] == outs[1] and len(outs[0]) == 2
    lines = [_run('train.eval_ppl', ['--data-file', str(corpus),
                                     '--seq-len', '32', '--batch-size', '2',
                                     '--max-batches', '2', '--loss-chunk',
                                     '16', '--tp', tp])
             for tp in ('1', '2')]
    assert all(p.returncode == 0 for p in lines), lines[1].stderr
    one, two = (json.loads(p.stdout.splitlines()[-1]) for p in lines)
    # f32 NLL: the two ranks' partial products sum in another order.
    assert two['nll'] == pytest.approx(one['nll'], rel=1e-5)
    assert (two['tokens'], two['seqs']) == (one['tokens'], one['seqs'])


# ---- eval_ppl ------------------------------------------------------------------

def _ppl(args):
    proc = _run('train.eval_ppl', args)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return json.loads(proc.stdout.strip().splitlines()[-1]), proc.stdout


def test_eval_ppl_end_to_end(tmp_path):
    corpus = tmp_path / 'corpus.txt'
    corpus.write_text('the quick brown fox jumps over the lazy dog. '
                      * 300)
    args = ['--data-file', str(corpus), '--seq-len', '32',
            '--batch-size', '2', '--max-batches', '3']
    out, stdout = _ppl(args)
    assert 1.0 < out['perplexity'] < 5000.0
    assert out['tokens'] == 3 * 2 * 32 and out['seqs'] == 6
    assert 'note: dropping 1 tail window(s) (409 windows, batch 2)' in stdout
    out2, _ = _ppl(args)
    assert out2 == out
    chunked, _ = _ppl(args + ['--loss-chunk', '8'])
    assert chunked['nll'] == pytest.approx(out['nll'], rel=1e-5)


def test_eval_ppl_jsonl_and_too_small(tmp_path):
    small = tmp_path / 'small.txt'
    small.write_text('tiny')
    proc = _run('train.eval_ppl', ['--data-file', str(small),
                                   '--seq-len', '64'])
    assert proc.returncode != 0
    assert 'corpus too small' in proc.stdout + proc.stderr
    jl = tmp_path / 'corpus.jsonl'
    with open(jl, 'w', encoding='utf-8') as f:
        for _ in range(40):
            f.write(json.dumps({'text': 'some text for evaluation '
                                        * 8}) + '\n')
    out, _ = _ppl(['--data-file', str(jl), '--seq-len', '32',
                   '--batch-size', '2', '--max-batches', '2'])
    assert out['tokens'] == 2 * 2 * 32


@pytest.mark.parametrize('loss_chunk', [0, 16], ids=['forward', 'chunked'])
def test_eval_ppl_nll_matches_jax(loss_chunk):
    """The port's nll_and_count against the JAX script's computation
    (llama.forward + token_logprobs, or hidden_states +
    chunked_token_logprobs) on one JAX draw of LLAMA_DEBUG, f32."""
    import dataclasses
    jcfg = dataclasses.replace(j_llama.LLAMA_DEBUG, loss_chunk=loss_chunk)
    cfg = dataclasses.replace(llama.LLAMA_DEBUG, loss_chunk=loss_chunk)
    jp = j_llama.init_params(jcfg, jax.random.PRNGKey(0))
    tp = llama.params_from_numpy(
        jax.tree.map(lambda x: np.asarray(x, np.float32), jp), cfg, 'cpu')
    text = 'the perplexity of a small random model over bytes. ' * 30
    ids = eval_ppl.corpus_ids_from_text(text, cfg.vocab_size)
    window = 48 + 1
    stream = np.asarray(ids[:3 * window], np.int32).reshape(3, window)
    tokens = jnp.asarray(stream)
    if loss_chunk:
        h = j_llama.hidden_states(jp, tokens[:, :-1], jcfg)
        lp = j_losses.chunked_token_logprobs(
            h, jp['lm_head'], tokens[:, 1:], chunk_size=loss_chunk)
    else:
        logits = j_llama.forward(jp, tokens[:, :-1], jcfg)
        lp = j_losses.token_logprobs(logits, tokens[:, 1:])
    want, want_count = float(-lp.sum()), int(lp.size)
    nll, count = eval_ppl.nll_and_count(
        tp, torch.as_tensor(stream, dtype=torch.int64), cfg)
    assert count == want_count == 3 * 48
    assert float(nll) == pytest.approx(want, rel=1e-5)
