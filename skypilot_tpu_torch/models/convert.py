"""HuggingFace checkpoints -> the port's stacked parameter tree (Llama,
Mistral, Gemma, Qwen2 and Mixtral families).

Counterpart of skypilot_tpu/models/convert.py: the same per-family config
mapping (auto-detected from ``model_type``) and refusals, and the same
tree, the layout ``llama.init_params`` and ``moe.init_params`` give:

- llama: the base mapping, with rope_scaling 'llama3'.
- mistral, mixtral: the usable context is capped at the sliding window
  (where sliding-window attention is full causal attention); an explicit
  ``max_seq_len`` beyond it is refused.
- gemma: gelu-tanh gated MLP, embeddings scaled by sqrt(d_model),
  decoupled head_dim, tied lm_head and the (1 + w) RMSNorm, folded into
  the stored norm weights (the offset added in f32, rounded once).
- qwen2: q/k/v biases (config.attn_bias); use_sliding_window is refused.
- mixtral: the per-(layer, expert) w1/w3/w2 linears become the
  (L, E, d, ff)/(L, E, ff, d) banks of models/moe.py and gate.weight the
  (L, d, E) router; router_impl 'dense' (exact dropless top-k).

HF ``nn.Linear.weight`` is (out, in); this package stores (in, out), so
every projection is transposed on the way in.  HF rotary is rotate_half,
as ops/rope.py, so Q/K need no permutation.

``load_hf_model`` reads a LOCAL checkpoint directory only (config.json
and safetensors, or torch ``.bin`` files): it needs neither
``transformers`` nor ``safetensors``, and parses the safetensors format
itself.  It streams: each stacked leaf is allocated once on the target
device in config.dtype and filled one layer (and one expert) at a time,
so the host holds about one source tensor, memory-mapped, at a time.
This is the one-card counterpart of the reference's
``load_hf_model_sharded``; the mesh version waits for ROADMAP item 11(g).
"""
from __future__ import annotations

import dataclasses
import glob
import json
import math
import mmap
import os
import struct
import types
import warnings
from typing import Any, Callable, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from skypilot_tpu_torch.device import resolve_device
from skypilot_tpu_torch.models import llama, moe

Params = llama.Params


def config_from_hf(hf_config: Any, dtype: torch.dtype = torch.bfloat16,
                   **overrides: Any) -> llama.LlamaConfig:
    """Map an HF config (a ``config.json`` dict, or an object with
    attributes such as a ``transformers`` config) to this package's
    LlamaConfig, or MoeConfig for Mixtral.

    Raises on config features the model stack does not implement:
    converting cleanly into subtly wrong numerics is the worst failure
    of a weights bridge."""
    if isinstance(hf_config, Mapping):
        hf_config = types.SimpleNamespace(**hf_config)
    scaling = getattr(hf_config, 'rope_scaling', None)
    rope_scaling = None
    if scaling and float(scaling.get('factor', 1.0)) != 1.0:
        rope_type = scaling.get('rope_type', scaling.get('type', ''))
        if rope_type != 'llama3':
            raise NotImplementedError(
                f'rope_scaling type {rope_type!r} is not implemented in '
                "skypilot_tpu.ops.rope (supported: 'llama3', the "
                'Llama-3.1/3.2 scheme).')
        rope_scaling = tuple(sorted(
            (k, float(v) if isinstance(v, (int, float)) else v)
            for k, v in scaling.items()))
    model_type = getattr(hf_config, 'model_type', 'llama')
    if model_type not in ('llama', 'mistral', 'gemma', 'qwen2',
                          'mixtral'):
        raise NotImplementedError(
            f'model_type {model_type!r} is not supported '
            "(supported: 'llama', 'mistral', 'gemma', 'qwen2', "
            "'mixtral').")

    hf_head_dim = getattr(hf_config, 'head_dim', None)
    derived = hf_config.hidden_size // hf_config.num_attention_heads
    head_dim_override = None
    if hf_head_dim is not None and hf_head_dim != derived:
        # Gemma-7B: head_dim 256 with hidden/heads = 192.
        head_dim_override = int(hf_head_dim)

    family: Dict[str, Any] = {}
    if model_type == 'qwen2':
        family = {'attn_bias': True}
        if getattr(hf_config, 'use_sliding_window', False):
            # Applies only above max_window_layers: a per-layer mixed
            # attention this stack does not implement.
            raise NotImplementedError(
                'qwen2 use_sliding_window=True (per-layer mixed '
                'sliding-window attention) is not implemented')
    elif model_type == 'gemma':
        act = getattr(hf_config, 'hidden_activation', None) or \
            getattr(hf_config, 'hidden_act', 'gelu_pytorch_tanh')
        if act not in ('gelu', 'gelu_pytorch_tanh'):
            raise NotImplementedError(f'gemma activation {act!r}')
        family = {'mlp_act': 'gelu_tanh',
                  'embed_scale': float(hf_config.hidden_size) ** 0.5}
    elif model_type in ('mistral', 'mixtral'):
        window = getattr(hf_config, 'sliding_window', None)
        if window is not None:
            explicit = overrides.get('max_seq_len')
            if explicit is not None and explicit > window:
                raise NotImplementedError(
                    f'Mistral sliding-window attention (window='
                    f'{window}) is not implemented for sequences '
                    f'beyond the window; pass max_seq_len<={window}.')
            if hf_config.max_position_embeddings > window:
                family['max_seq_len'] = int(window)

    family.setdefault('max_seq_len', hf_config.max_position_embeddings)
    config_cls = llama.LlamaConfig
    if model_type == 'mixtral':
        config_cls = moe.MoeConfig
        family.update(
            n_experts=hf_config.num_local_experts,
            top_k=hf_config.num_experts_per_tok,
            router_aux_weight=float(getattr(
                hf_config, 'router_aux_loss_coef', 0.02)),
            # A converted checkpoint reproduces its source's numerics:
            # exact dropless routing (override 'capacity' to finetune
            # with the dropping dispatch).
            router_impl='dense')
    cfg = config_cls(
        vocab_size=hf_config.vocab_size,
        d_model=hf_config.hidden_size,
        n_layers=hf_config.num_hidden_layers,
        n_heads=hf_config.num_attention_heads,
        n_kv_heads=hf_config.num_key_value_heads,
        d_ff=hf_config.intermediate_size,
        rope_theta=float(getattr(hf_config, 'rope_theta', 500000.0)),
        rope_scaling=rope_scaling,
        norm_eps=float(hf_config.rms_norm_eps),
        head_dim_override=head_dim_override,
        dtype=dtype,
        **family)
    return dataclasses.replace(cfg, **overrides) if overrides else cfg


# ---- the tree -----------------------------------------------------------

def _leaves(config: llama.LlamaConfig):
    """(tree path, HF name template under the layer prefix, the shape of
    one tensor in this package's layout, transposed) of every stacked
    leaf; {e} in a template is the expert."""
    d, ff = config.d_model, config.d_ff
    q, kv = config.n_heads * config.head_dim, \
        config.n_kv_heads * config.head_dim
    out = [
        (('ln1',), 'input_layernorm.weight', (d,), False),
        (('ln2',), 'post_attention_layernorm.weight', (d,), False),
        (('attn', 'wq'), 'self_attn.q_proj.weight', (d, q), True),
        (('attn', 'wk'), 'self_attn.k_proj.weight', (d, kv), True),
        (('attn', 'wv'), 'self_attn.v_proj.weight', (d, kv), True),
        (('attn', 'wo'), 'self_attn.o_proj.weight', (q, d), True),
    ]
    if config.attn_bias:   # Qwen2: q/k/v biases
        out += [(('attn', 'bq'), 'self_attn.q_proj.bias', (q,), False),
                (('attn', 'bk'), 'self_attn.k_proj.bias', (kv,), False),
                (('attn', 'bv'), 'self_attn.v_proj.bias', (kv,), False)]
    if hasattr(config, 'n_experts'):   # Mixtral's block_sparse_moe
        m = 'block_sparse_moe.'
        out += [
            (('moe', 'router'), m + 'gate.weight', (d, config.n_experts),
             True),
            (('moe', 'w_gate'), m + 'experts.{e}.w1.weight', (d, ff), True),
            (('moe', 'w_up'), m + 'experts.{e}.w3.weight', (d, ff), True),
            (('moe', 'w_down'), m + 'experts.{e}.w2.weight', (ff, d), True),
        ]
    else:
        out += [(('mlp', 'w_gate'), 'mlp.gate_proj.weight', (d, ff), True),
                (('mlp', 'w_up'), 'mlp.up_proj.weight', (d, ff), True),
                (('mlp', 'w_down'), 'mlp.down_proj.weight', (ff, d), True)]
    return out


def _build(get: Callable[[str], torch.Tensor], has: Callable[[str], bool],
           config: llama.LlamaConfig, norm_offset: float,
           device: torch.device) -> Params:
    """The parameter tree from a source of HF tensors: `get(name)` gives
    one CPU tensor in the source's dtype, `has(name)` says whether the
    source holds it.  Each leaf is allocated once on `device` in
    config.dtype and filled tensor by tensor: each goes to `device` in
    its own dtype and is transposed and cast there in one copy (the
    transpose exact, the cast one rounding).  Norms take the offset in
    f32, then one rounding."""
    prefix = 'model.'
    if not has(prefix + 'embed_tokens.weight') and \
            has('embed_tokens.weight'):
        prefix = ''

    def leaf(names, shape, transpose, offset=0.0, lead=()):
        out = torch.empty((*lead, *shape), dtype=config.dtype,
                          device=device)
        rows = out.view(-1, *shape)
        for row, name in zip(rows, names):
            src = get(name).to(device)
            if transpose:
                src = src.T
            if tuple(src.shape) != shape:
                raise ValueError(
                    f'{name}: shape {tuple(src.shape)} in this package\'s '
                    f'layout, the config needs {shape}')
            row.copy_(src.float() + offset if offset else src)
            del src   # drops the source's memory map before the next
        return out

    d, nl = config.d_model, config.n_layers
    n_experts = getattr(config, 'n_experts', 1)
    embed = leaf([prefix + 'embed_tokens.weight'], (config.vocab_size, d),
                 False)
    layers: Params = {}
    for path, template, shape, transpose in _leaves(config):
        experts = '{e}' in template
        names = [f'{prefix}layers.{i}.' + template.format(e=e)
                 for i in range(nl)
                 for e in (range(n_experts) if experts else [0])]
        node = layers
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = leaf(
            names, shape, transpose,
            offset=norm_offset if path[0] in ('ln1', 'ln2') else 0.0,
            lead=(nl, n_experts) if experts else (nl,))
    tree = {'embed': embed, 'layers': layers,
            'final_norm': leaf([prefix + 'norm.weight'], (d,), False,
                               offset=norm_offset)}
    if has('lm_head.weight'):
        tree['lm_head'] = leaf(['lm_head.weight'], (d, config.vocab_size),
                               True)
    else:   # tied embeddings: a transposed copy, made on the device
        tree['lm_head'] = embed.T.contiguous()
    return tree


def hf_state_dict_to_params(state_dict: Mapping[str, Any],
                            config: llama.LlamaConfig,
                            norm_offset: float = 0.0,
                            device=None) -> Params:
    """An HF state_dict (torch tensors or numpy arrays) -> the stacked
    tree ``llama.init_params`` (``moe.init_params`` for a MoeConfig)
    gives, in config.dtype on `device` (default: the CUDA card).

    norm_offset is added to every RMSNorm weight: Gemma stores its norms
    as w with the runtime scale (1 + w), so 1.0 folds that into the
    weights and the norm kernel stays family-free."""
    def get(name: str) -> torch.Tensor:
        w = state_dict[name]
        if isinstance(w, torch.Tensor):
            return w.detach().cpu()
        return torch.from_numpy(np.ascontiguousarray(w))

    return _build(get, state_dict.__contains__, config, norm_offset,
                  resolve_device(device))


# ---- reading a checkpoint directory ----------------------------------------

_SAFETENSORS_DTYPES = {'BF16': torch.bfloat16, 'F16': torch.float16,
                       'F32': torch.float32}


def read_safetensors_header(path: str) -> Tuple[Dict[str, Any], int]:
    """(header, data start) of a safetensors file: an 8-byte
    little-endian header length n, n bytes of JSON (possibly padded with
    spaces), then the data; each entry's ``data_offsets`` count from the
    end of the header.  The '__metadata__' entry is dropped."""
    with open(path, 'rb') as f:
        raw = f.read(8)
        if len(raw) != 8:
            raise ValueError(f'{path}: not a safetensors file (too short)')
        (n,) = struct.unpack('<Q', raw)
        header = json.loads(f.read(n))
    header.pop('__metadata__', None)
    return header, 8 + n


class _SafetensorsReader:
    """Random access to the tensors of a directory's safetensors files.
    ``get`` maps the bytes of one tensor and returns a CPU tensor over
    them; the map closes when the tensor is dropped."""

    def __init__(self, files):
        self._entries: Dict[str, Tuple[str, torch.dtype, tuple, int]] = {}
        for path in files:
            header, start = read_safetensors_header(path)
            for name, info in header.items():
                if info['dtype'] not in _SAFETENSORS_DTYPES:
                    raise ValueError(
                        f'{path}: {name} has dtype {info["dtype"]}; the '
                        f'loader reads {sorted(_SAFETENSORS_DTYPES)}')
                dtype = _SAFETENSORS_DTYPES[info['dtype']]
                shape = tuple(info['shape'])
                begin, end = info['data_offsets']
                nbytes = math.prod(shape) * dtype.itemsize
                if end - begin != nbytes:
                    raise ValueError(
                        f'{path}: {name} spans {end - begin} bytes, its '
                        f'shape {shape} and dtype need {nbytes}')
                self._entries[name] = (path, dtype, shape, start + begin)

    def __contains__(self, name: str) -> bool:
        return name in self._entries

    def get(self, name: str) -> torch.Tensor:
        path, dtype, shape, offset = self._entries[name]
        count = math.prod(shape)
        if count == 0:
            return torch.empty(shape, dtype=dtype)
        base = offset - offset % mmap.ALLOCATIONGRANULARITY
        with open(path, 'rb') as f:
            view = mmap.mmap(f.fileno(), offset - base +
                             count * dtype.itemsize, offset=base,
                             access=mmap.ACCESS_READ)
        with warnings.catch_warnings():
            # Read-only by design: every caller copies out of it.
            warnings.filterwarnings('ignore', message='The given buffer')
            flat = torch.frombuffer(view, dtype=dtype, count=count,
                                    offset=offset - base)
        return flat.view(shape)


class _TorchBinReader:
    """The tensors of a directory's ``pytorch_model*.bin`` files, each
    file loaded memory-mapped (``weights_only``) when first needed.
    `where` maps each tensor's name to its file, when an index gives it;
    else every file is loaded to learn its names."""

    def __init__(self, files, where: Optional[Dict[str, str]] = None):
        self._loaded: Dict[str, Dict[str, torch.Tensor]] = {}
        self._where = where or {name: path for path in files
                                for name in self._load(path)}

    def _load(self, path: str) -> Dict[str, torch.Tensor]:
        if path not in self._loaded:
            self._loaded[path] = torch.load(path, map_location='cpu',
                                            weights_only=True, mmap=True)
        return self._loaded[path]

    def __contains__(self, name: str) -> bool:
        return name in self._where

    def get(self, name: str) -> torch.Tensor:
        return self._load(self._where[name])[name]


def _open_checkpoint(model_dir: str):
    """The reader of a directory's weights: safetensors (one file, or
    the files named by model.safetensors.index.json), else torch .bin."""
    index = os.path.join(model_dir, 'model.safetensors.index.json')
    if os.path.exists(index):
        with open(index, encoding='utf-8') as f:
            weight_map = json.load(f)['weight_map']
        reader = _SafetensorsReader(sorted(
            {os.path.join(model_dir, f) for f in weight_map.values()}))
        missing = [n for n in weight_map if n not in reader]
        if missing:
            raise ValueError(f'{index} names tensors its files do not '
                             f'hold: {missing[:5]}')
        return reader
    files = sorted(glob.glob(os.path.join(model_dir, '*.safetensors')))
    if files:
        return _SafetensorsReader(files)
    index = os.path.join(model_dir, 'pytorch_model.bin.index.json')
    if os.path.exists(index):
        with open(index, encoding='utf-8') as f:
            weight_map = json.load(f)['weight_map']
        return _TorchBinReader([], {n: os.path.join(model_dir, f)
                                    for n, f in weight_map.items()})
    files = sorted(glob.glob(os.path.join(model_dir, 'pytorch_model*.bin')))
    if files:
        return _TorchBinReader(files)
    raise FileNotFoundError(
        f'no *.safetensors or pytorch_model*.bin files under '
        f'{model_dir!r}')


def load_hf_model(model_dir: str, dtype: torch.dtype = torch.bfloat16,
                  device=None, **config_overrides: Any
                  ) -> Tuple[Params, llama.LlamaConfig]:
    """Load a LOCAL HF checkpoint directory (config.json with
    safetensors or pytorch_model*.bin weights; the family from its
    model_type) and return (params, config) ready for the Trainer and
    the serving engines, on `device` (default: the CUDA card).  It
    downloads nothing: a hub name raises."""
    if not os.path.isdir(model_dir):
        raise FileNotFoundError(
            f'{model_dir!r} is not a local directory: this package loads '
            f'local HF checkpoint directories only (config.json and '
            f'*.safetensors or pytorch_model*.bin) and downloads nothing')
    with open(os.path.join(model_dir, 'config.json'),
              encoding='utf-8') as f:
        hf_config = json.load(f)
    config = config_from_hf(hf_config, dtype=dtype, **config_overrides)
    norm_offset = 1.0 if hf_config.get('model_type') == 'gemma' else 0.0
    reader = _open_checkpoint(model_dir)
    params = _build(reader.get, reader.__contains__, config, norm_offset,
                    resolve_device(device))
    return params, config


# The reference's name for it, kept by its recipes and scripts.
load_hf_llama = load_hf_model
