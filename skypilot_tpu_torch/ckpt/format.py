"""Sharded checkpoint on-disk format: per-array shards + hashed manifest.

Counterpart of skypilot_tpu/ckpt/format.py, writing and reading the same
files: a checkpoint written by either package restores in the other.
Layout of one committed step under a checkpoint root::

    <root>/step_<N>/
        arr_00000.npy            # one file per pytree leaf
        arr_00001.npy
        ...
        manifest-p00000.json     # per-process shard manifest (hashes)
        manifest.json            # merged manifest, written by process 0
        COMMITTED                # commit marker

Atomicity protocol: everything is written into ``<root>/.tmp.step_<N>``;
the merged manifest and the ``COMMITTED`` marker land in the temp dir
*before* the single ``os.rename`` to ``step_<N>``.  The rename is the
one commit point — a crash at any earlier moment leaves only a
``.tmp.*`` dir that discovery never trusts, so restore can never see a
half-written checkpoint.  A ``step_<N>`` dir carrying a manifest but no
marker (or vice versa) is treated as corrupt and skipped.

Multihost: every process writes the leaves it owns (round-robin by leaf
index) plus its own ``manifest-p<K>.json``.  ``save_pytree`` runs a
two-barrier protocol — process 0 removes stale staging dirs, barrier
(nobody writes into a dir that is about to be cleaned), every process
writes its shards, barrier, process 0 merges the per-process manifests,
writes the marker, and performs the commit rename.  The barrier is a
``Callable[[str], None]`` taking a per-phase tag (the manager defaults
it to ``torch.distributed.barrier``); multihost callers MUST supply one
or peer shards can be lost mid-write.  Per-leaf SHA-256 content hashes
in the manifest let restore detect bit rot / torn writes on any host.

Manifest v2 (elastic resume): every entry records the leaf's **global**
shape and the index-slice of the global array its shard file covers
(``slice``: per-dimension ``[start, stop)`` pairs), plus the writer
process.  A leaf may be split across several shard files (one a
:class:`Shard` window), and restore assembles any window of
the global array by reading ONLY the shard files that overlap it, so a
checkpoint written by N processes restores under any M-process grid.  v1
manifests carry no ``slice``/``global_shape``; each entry is read as one
full-coverage shard.

Leaves and keys.  A leaf is a torch tensor (on any device) or a numpy
array; restore returns CPU torch tensors.  Trees are nested dicts (keys
sorted), tuples, lists and namedtuples, flattened by this module's own
``flatten_with_keys``, whose key strings are ``jax.tree_util.keystr``'s:
``['k']`` for a dict key, ``[i]`` for a sequence index, ``.name`` for a
namedtuple field.  bfloat16 leaves are stored as numpy stores an
``ml_dtypes.bfloat16`` array (a ``'<V2'`` header over the raw bits, the
manifest saying ``'bfloat16'``), so the same state gives byte-identical
shard files in both packages.

A process that holds a window of a leaf (a training mesh's block, or
any layout of the global array) gives it as a :class:`Shard` leaf:
the window, its place in the global array and the global shape,
written by the one process that owns that window (a replicated block
has one owner), and restored into by every process that holds it.  Its
shard files are v2 slice entries, so any grid, and either package,
restores them.  Plain leaves are written whole, round-robin over the
processes.

Legacy checkpoints: a ``step_<N>`` dir with neither manifest nor marker
is an old Orbax checkpoint.  Discovery reports it as committed with
``fmt='orbax'``, as the JAX package does; this package has no Orbax
reader, so restoring one raises (the manager walks past it).
"""
from __future__ import annotations

import concurrent.futures
import dataclasses
import hashlib
import io
import json
import logging
import os
import re
import shutil
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

logger = logging.getLogger(__name__)

MANIFEST = 'manifest.json'
MARKER = 'COMMITTED'
STEP_PREFIX = 'step_'
TMP_PREFIX = '.tmp.'
_STEP_RE = re.compile(r'step_(\d+)$')

FORMAT_VERSION = 2

# Chaos hook: tests install a callable(stage, path) that may raise to
# simulate a crash/kill at a named point of the save protocol.  Stages,
# in order: 'shard_written' (after each leaf file), 'process_manifest'
# (after manifest-p<K>.json), 'pre_commit' (merged manifest + marker in
# the temp dir, rename not yet done), 'committed' (after the rename).
# The read side fires reshard stages too: 'reshard_planned' (window
# computed, nothing read yet), 'reshard_shard_read' (after each shard
# file), 'reshard_leaf_assembled' (after each leaf window is built),
# 'reshard_restored' (whole tree assembled).
_stage_hook: Optional[Callable[[str, str], None]] = None


def set_stage_hook(hook: Optional[Callable[[str, str], None]]
                   ) -> Optional[Callable[[str, str], None]]:
    """Install a save-protocol chaos hook; returns the previous one."""
    global _stage_hook
    previous = _stage_hook
    _stage_hook = hook
    return previous


def _stage(stage: str, path: str) -> None:
    if _stage_hook is not None:
        _stage_hook(stage, path)


class CorruptCheckpointError(Exception):
    """A step dir failed integrity checks (missing marker/manifest,
    unparseable manifest, missing shard, or SHA-256 mismatch)."""


@dataclasses.dataclass(frozen=True)
class StepInfo:
    step: int
    path: str
    fmt: str  # 'sharded' | 'orbax'


def step_dir(root: str, step: int) -> str:
    return os.path.join(root, f'{STEP_PREFIX}{step}')


def tmp_dir(root: str, step: int) -> str:
    # Deterministic (no uuid): every process of a multihost save must
    # agree on the staging dir.  Stale leftovers from a crashed save are
    # removed by the next save of the same step / clean_stale_tmp.
    return os.path.join(root, f'{TMP_PREFIX}{STEP_PREFIX}{step}')


# ---- trees --------------------------------------------------------------

def _children(node) -> Optional[List[Tuple[str, Any]]]:
    """(key string, child) pairs of an inner node; None for a leaf."""
    if node is None:
        return []
    if isinstance(node, dict):
        return [(f'[{k!r}]', node[k]) for k in sorted(node)]
    if isinstance(node, tuple) and hasattr(node, '_fields'):
        return [(f'.{name}', getattr(node, name)) for name in node._fields]
    if isinstance(node, (tuple, list)):
        return [(f'[{i}]', child) for i, child in enumerate(node)]
    return None


def flatten_with_keys(pytree) -> Tuple[List[Tuple[str, Any]], Any]:
    """Flatten to [(keypath-string, leaf)] + treedef, in
    ``jax.tree_util.tree_flatten_with_path``'s order.  The treedef is
    the tree itself; ``tree_unflatten`` reads only its structure."""
    out: List[Tuple[str, Any]] = []

    def walk(node, prefix: str) -> None:
        children = _children(node)
        if children is None:
            out.append((prefix, node))
            return
        for key, child in children:
            walk(child, prefix + key)

    walk(pytree, '')
    return out, pytree


def tree_unflatten(treedef, leaves) -> Any:
    """Rebuild ``treedef``'s structure with ``leaves`` in flatten order."""
    it = iter(leaves)

    def build(node):
        if node is None:
            return None
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        if isinstance(node, tuple) and hasattr(node, '_fields'):
            return type(node)(*(build(c) for c in node))
        if isinstance(node, (tuple, list)):
            return type(node)(build(c) for c in node)
        return next(it)

    return build(treedef)


# ---- leaves and shard files ---------------------------------------------

class Shard:
    """A leaf given as this process's window of a global array: `local`
    (tensor or numpy) is the window `window` (per-dimension [start,
    stop)) of an array of shape `global_shape`.  On save only an `owner`
    writes it (`local` may be None elsewhere); on restore `window` is
    what comes back.  A leaf to the tree functions (it is neither a dict
    nor a sequence)."""

    __slots__ = ('local', 'global_shape', 'window', 'owner')

    def __init__(self, local, global_shape, window, owner: bool = True):
        self.local = local
        self.global_shape = tuple(int(d) for d in global_shape)
        self.window = [(int(a), int(b)) for a, b in window]
        self.owner = bool(owner)

    def with_local(self, local) -> 'Shard':
        return Shard(local, self.global_shape, self.window, self.owner)


# bfloat16 has no numpy dtype here (no ml_dtypes): it is held as its raw
# int16 bits and written under ml_dtypes' '.npy' description.
_BF16 = 'bfloat16'
_BF16_DESCR = '<V2'


def _host_array(leaf) -> Tuple[np.ndarray, str]:
    """(numpy array of the leaf's bits, manifest dtype name).  A tensor
    on a card is copied to the host (which waits for the work that
    produced it); a CPU tensor is viewed, not copied."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.contiguous().view(torch.int16).numpy(), _BF16
        arr = t.numpy()
        return arr, str(arr.dtype)
    arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _storage_dtype(name: str) -> np.dtype:
    """The numpy dtype that holds a manifest dtype's bits."""
    if name == _BF16:
        return np.dtype(np.int16)
    return np.dtype(name)


def _npy_parts(local: np.ndarray, dtype_name: str
               ) -> Tuple[bytes, memoryview]:
    """The '.npy' file of one shard as (header, data), byte for byte
    what ``np.save`` writes for it (for bfloat16: for the ml_dtypes
    array).  The data is the array's own memory wherever it is
    contiguous in the file's order, so nothing is copied."""
    header = np.lib.format.header_data_from_array_1_0(local)
    if dtype_name == _BF16:
        header['descr'] = _BF16_DESCR
    buf = io.BytesIO()
    np.lib.format.write_array_header_1_0(buf, header)
    # np.save writes an F-ordered array's elements in F order: the C
    # order of its transpose.
    data = np.ascontiguousarray(local.T if header['fortran_order']
                                else local)
    return buf.getvalue(), memoryview(data.reshape(-1).view(np.uint8))


def _parse_npy(data: bytes) -> np.ndarray:
    """The array of a '.npy' file's bytes, as a view of them (np.load of
    a buffer would copy)."""
    buf = io.BytesIO(data)
    version = np.lib.format.read_magic(buf)
    if version == (1, 0):
        shape, fortran, dtype = np.lib.format.read_array_header_1_0(buf)
    elif version == (2, 0):
        shape, fortran, dtype = np.lib.format.read_array_header_2_0(buf)
    else:
        raise ValueError(f'.npy format version {version}')
    if dtype.hasobject:
        raise ValueError('object arrays are not checkpoint leaves')
    arr = np.frombuffer(data, dtype=dtype, count=int(np.prod(shape)),
                        offset=buf.tell())
    return arr.reshape(shape[::-1]).T if fortran else arr.reshape(shape)


def _to_torch(arr: np.ndarray, dtype_name: str) -> torch.Tensor:
    t = torch.from_numpy(arr)
    return t.view(torch.bfloat16) if dtype_name == _BF16 else t


def _atomic_write_bytes(path: str, *parts) -> str:
    """Write ``parts`` as one file, fsynced, then renamed into place;
    returns the SHA-256 of its bytes."""
    digest = hashlib.sha256()
    for part in parts:
        digest.update(part)
    tmp = path + '.part'
    with open(tmp, 'wb') as f:
        for part in parts:
            f.write(part)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    return digest.hexdigest()


# Shard files are hashed, written and read by up to this many threads,
# one leaf each: hashlib, file I/O and fsync run without the GIL, so one
# thread would leave the disk and the other cores idle.
_IO_THREADS = min(8, os.cpu_count() or 1)


def _map_threads(fn: Callable[[Any], Any], items: List[Any]) -> List[Any]:
    """[fn(x) for x in items] on up to _IO_THREADS threads.  Every call
    ends before the first error (in item order) is raised."""
    if _IO_THREADS == 1 or len(items) <= 1:
        return [fn(x) for x in items]
    with concurrent.futures.ThreadPoolExecutor(
            max_workers=_IO_THREADS, thread_name_prefix='ckpt-io') as pool:
        futures = [pool.submit(fn, x) for x in items]
    return [f.result() for f in futures]


# ---- index-slice helpers (manifest v2) ----------------------------------
#
# A slice spec is a per-dimension list of [start, stop) pairs into the
# leaf's GLOBAL array.  v1 entries carry no spec: they cover the whole
# leaf.

SliceSpec = List[Tuple[int, int]]


def full_slice(shape) -> SliceSpec:
    return [(0, int(dim)) for dim in shape]


def entry_global_shape(entry: Dict[str, Any]) -> List[int]:
    """Global leaf shape; v1 entries store whole leaves, so their local
    shape IS the global shape."""
    return list(entry.get('global_shape', entry['shape']))


def entry_slice(entry: Dict[str, Any]) -> SliceSpec:
    """The [start, stop) window of the global array this shard file
    covers (full coverage for v1 entries)."""
    spec = entry.get('slice')
    if spec is None:
        return full_slice(entry['shape'])
    return [(int(s), int(e)) for s, e in spec]


def _elements(spec: SliceSpec) -> int:
    n = 1
    for start, stop in spec:
        n *= max(0, stop - start)
    return n


def even_row_shard(key: str, global_shape, process_index: int,
                   process_count: int) -> Optional[SliceSpec]:
    """The canonical sharded layout: partition axis 0 evenly across the
    process grid.  Leaves whose leading axis does not divide evenly are
    written whole by one deterministic owner (replicated for readers).
    None means this process owns no window of the leaf."""
    import zlib
    if process_count <= 1:
        return full_slice(global_shape)
    shape = tuple(int(d) for d in global_shape)
    if shape and shape[0] >= process_count and shape[0] % process_count == 0:
        rows = shape[0] // process_count
        spec = full_slice(shape)
        spec[0] = (process_index * rows, (process_index + 1) * rows)
        return spec
    # Un-partitionable leaf: deterministic owner by key hash (stable
    # across processes, unlike builtins.hash).
    owner = zlib.crc32(key.encode()) % process_count
    return full_slice(shape) if owner == process_index else None


def even_row_windows(pytree, process_index: int, process_count: int):
    """`pytree` with each leaf given as process `process_index`'s
    even_row_shard window, a :class:`Shard`: on save the owned windows
    are written (the layout the JAX package writes with
    ``shard_spec=even_row_shard``), on restore each comes back as its
    window.  A leaf this process does not own is the whole leaf with
    owner=False (written by its one owner, read whole)."""
    named, treedef = flatten_with_keys(pytree)
    leaves = []
    for key, leaf in named:
        shape = tuple(int(d) for d in np.shape(leaf))
        window = even_row_shard(key, shape, process_index, process_count)
        owned = window is not None
        window = window or full_slice(shape)
        local = leaf[tuple(slice(a, b) for a, b in window)] if shape \
            else leaf
        leaves.append(Shard(local, shape, window, owned))
    return tree_unflatten(treedef, leaves)


def write_process_shards(root: str, step: int, pytree,
                         process_index: int = 0,
                         process_count: int = 1) -> Dict[str, Any]:
    """Write this process's leaves + per-process manifest into the temp
    dir.  Whole leaves are assigned round-robin by flatten index
    (replicated layout) so a multihost save spreads disk bandwidth
    across hosts; a :class:`Shard` leaf is written by its owner as its
    window (sharded layout).
    Returns the per-process manifest dict (entries + bytes written)."""
    # No rmtree here: peer processes may already be writing into the
    # shared staging dir.  Stale leftovers are removed by process 0 in
    # save_pytree, before the pre-write barrier releases any writer.
    staging = tmp_dir(root, step)
    os.makedirs(staging, exist_ok=True)
    named_leaves, _ = flatten_with_keys(pytree)
    jobs = []
    for i, (key, leaf) in enumerate(named_leaves):
        if isinstance(leaf, Shard):
            if not leaf.owner:
                continue
            arr, dtype_name = _host_array(leaf.local)
            # Per-process filename: several processes may each hold a
            # window of the same leaf index.
            jobs.append((i, key, f'arr_{i:05d}-p{process_index:05d}.npy',
                         arr, dtype_name, leaf.window, leaf.global_shape))
            continue
        if i % process_count != process_index:
            continue
        arr, dtype_name = _host_array(leaf)
        jobs.append((i, key, f'arr_{i:05d}.npy', arr, dtype_name,
                     full_slice(arr.shape), arr.shape))

    def write(job) -> Dict[str, Any]:
        i, key, filename, local, dtype_name, window, global_shape = job
        header, data = _npy_parts(local, dtype_name)
        path = os.path.join(staging, filename)
        sha256 = _atomic_write_bytes(path, header, data)
        _stage('shard_written', path)
        return {
            'index': i,
            'key': key,
            'file': filename,
            'sha256': sha256,
            'dtype': dtype_name,
            'shape': list(local.shape),
            'global_shape': list(global_shape),
            'slice': [[s, e] for s, e in window],
            'process': process_index,
            'bytes': len(header) + data.nbytes,
        }

    entries = _map_threads(write, jobs)
    total_bytes = sum(e['bytes'] for e in entries)
    process_manifest = {
        'version': FORMAT_VERSION,
        'step': step,
        'process_index': process_index,
        'process_count': process_count,
        'num_leaves': len(named_leaves),
        'entries': entries,
        'bytes': total_bytes,
    }
    _atomic_write_bytes(
        os.path.join(staging, f'manifest-p{process_index:05d}.json'),
        json.dumps(process_manifest, indent=1).encode())
    _stage('process_manifest', staging)
    return process_manifest


def _group_by_index(entries: List[Dict[str, Any]]
                    ) -> Dict[int, List[Dict[str, Any]]]:
    groups: Dict[int, List[Dict[str, Any]]] = {}
    for entry in entries:
        groups.setdefault(int(entry['index']), []).append(entry)
    return groups


def _validate_coverage(entries: List[Dict[str, Any]], num_leaves: int,
                       step: int) -> None:
    """Every leaf index 0..num_leaves-1 must be present, and each leaf's
    shard windows must tile its global shape exactly (writer contract:
    windows are disjoint, so covered-element count is a complete
    check)."""
    groups = _group_by_index(entries)
    if set(groups) != set(range(num_leaves)):
        missing = sorted(set(range(num_leaves)) - set(groups))
        raise CorruptCheckpointError(
            f'step {step}: shard entries cover leaves {sorted(groups)} '
            f'but the tree has {num_leaves} leaves (missing {missing} — '
            f'a writer process died or its shards were lost)')
    for index, group in groups.items():
        global_shape = entry_global_shape(group[0])
        total = 1
        for dim in global_shape:
            total *= int(dim)
        covered = 0
        for entry in group:
            if entry_global_shape(entry) != global_shape:
                raise CorruptCheckpointError(
                    f'step {step}: leaf {index} shards disagree on the '
                    f'global shape ({entry_global_shape(entry)} vs '
                    f'{global_shape})')
            spec = entry_slice(entry)
            for (start, stop), dim in zip(spec, global_shape):
                if not 0 <= start < stop <= int(dim):
                    raise CorruptCheckpointError(
                        f'step {step}: leaf {index} shard '
                        f'{entry["file"]} slice {spec} exceeds global '
                        f'shape {global_shape}')
            covered += _elements(spec)
        if covered != total:
            raise CorruptCheckpointError(
                f'step {step}: leaf {index} shards cover {covered} of '
                f'{total} elements — missing shard for a dead process?')


def commit(root: str, step: int, process_count: int = 1,
           metadata: Optional[Dict[str, Any]] = None) -> str:
    """Process-0-only: merge per-process manifests, write marker, rename.

    Callers must have passed the job-level barrier first (every process
    finished write_process_shards).  Returns the committed dir path."""
    staging = tmp_dir(root, step)
    merged_entries: List[Dict[str, Any]] = []
    num_leaves = None
    for p in range(process_count):
        path = os.path.join(staging, f'manifest-p{p:05d}.json')
        if not os.path.exists(path):
            raise CorruptCheckpointError(
                f'commit of step {step}: missing shard manifest for '
                f'process {p} (barrier violated or writer died)')
        with open(path, 'r', encoding='utf-8') as f:
            pm = json.load(f)
        num_leaves = pm['num_leaves']
        merged_entries.extend(pm['entries'])
    merged_entries.sort(key=lambda e: (e['index'], entry_slice(e)))
    if num_leaves is not None:
        _validate_coverage(merged_entries, num_leaves, step)
    manifest = {
        'version': FORMAT_VERSION,
        'step': step,
        'process_count': process_count,
        'entries': merged_entries,
        'bytes': sum(e['bytes'] for e in merged_entries),
        'metadata': metadata or {},
    }
    _atomic_write_bytes(os.path.join(staging, MANIFEST),
                        json.dumps(manifest, indent=1).encode())
    # Marker BEFORE the rename: the rename is the single atomic commit
    # point, and a committed dir always carries its marker.
    _atomic_write_bytes(os.path.join(staging, MARKER), b'')
    _stage('pre_commit', staging)
    final = step_dir(root, step)
    if os.path.isdir(final):
        # Re-save of an existing step (e.g. emergency save racing the
        # interval save): replace the old committed dir.
        shutil.rmtree(final)
    os.rename(staging, final)
    _stage('committed', final)
    return final


def save_pytree(root: str, step: int, pytree,
                process_index: int = 0, process_count: int = 1,
                metadata: Optional[Dict[str, Any]] = None,
                barrier: Optional[Callable[[str], None]] = None
                ) -> Optional[str]:
    """Full save flow for one process.  Non-zero processes return after
    writing their shards (None); process 0 commits and returns the
    committed dir.

    ``barrier(tag)`` is the job-level rendezvous; with ``process_count
    > 1`` it is REQUIRED (the manager defaults it) — without it process
    0 could clean staging dirs peers are writing, or commit before peer
    shards land.  Protocol: p0 cleans stale staging, barrier('clean'),
    everyone writes, barrier('write'), p0 commits."""
    if process_count > 1 and barrier is None:
        raise ValueError(
            f'multihost save of step {step} (process_count='
            f'{process_count}) requires a barrier: without one, commit '
            f'and staging cleanup race the peer shard writes')
    os.makedirs(root, exist_ok=True)
    if process_index == 0:
        # Only the committer cleans, and only before the barrier below
        # releases any process into writing — so a staging dir is never
        # deleted while a peer writes into it.
        clean_stale_tmp(root)
    if barrier is not None:
        barrier(f'skytpu_ckpt_clean_step{step}')
    write_process_shards(root, step, pytree, process_index, process_count)
    if barrier is not None:
        barrier(f'skytpu_ckpt_write_step{step}')
    if process_index != 0:
        return None
    return commit(root, step, process_count, metadata)


def scan_steps(root: str) -> Tuple[List[StepInfo], List[str]]:
    """Discover step dirs under root.

    Returns (committed, corrupt_paths), committed sorted by step
    ascending.  Committed means: our marker + manifest both present
    (fmt='sharded'), or neither present (a completed legacy Orbax dir,
    fmt='orbax' — Orbax stages into differently-named tmp dirs, so a
    plain step_<N> is complete).  A dir with only one of the two is a
    torn commit: reported corrupt, never trusted."""
    committed: List[StepInfo] = []
    corrupt: List[str] = []
    if not os.path.isdir(root):
        return committed, corrupt
    for name in os.listdir(root):
        match = _STEP_RE.fullmatch(name)
        path = os.path.join(root, name)
        if not match or not os.path.isdir(path):
            continue
        step = int(match.group(1))
        has_marker = os.path.exists(os.path.join(path, MARKER))
        has_manifest = os.path.exists(os.path.join(path, MANIFEST))
        if has_marker and has_manifest:
            committed.append(StepInfo(step, path, 'sharded'))
        elif not has_marker and not has_manifest:
            committed.append(StepInfo(step, path, 'orbax'))
        else:
            corrupt.append(path)
    committed.sort(key=lambda info: info.step)
    return committed, corrupt


def latest_step(root: str) -> Optional[int]:
    """Newest committed step under root (None when there is none).
    Uncommitted temp dirs and torn commits are invisible here."""
    committed, _ = scan_steps(root)
    return committed[-1].step if committed else None


def load_manifest(root: str, step: int) -> Dict[str, Any]:
    path = os.path.join(step_dir(root, step), MANIFEST)
    try:
        with open(path, 'r', encoding='utf-8') as f:
            return json.load(f)
    except (OSError, ValueError) as e:
        raise CorruptCheckpointError(
            f'step {step}: unreadable manifest: {e}') from e


def _resolve_storage(step: int, entry: Dict[str, Any]) -> np.dtype:
    try:
        return _storage_dtype(entry['dtype'])
    except TypeError as e:
        raise CorruptCheckpointError(
            f'step {step}: shard {entry["file"]} has dtype '
            f'{entry["dtype"]!r}, which this package cannot hold: {e}'
        ) from e


def _read_entry_array(directory: str, step: int,
                      entry: Dict[str, Any]) -> np.ndarray:
    """Read one shard file, verify its SHA-256, and reinterpret it as
    the manifest dtype's storage (the .npy header degrades bfloat16 to
    raw void bytes, read back as int16 bits)."""
    path = os.path.join(directory, entry['file'])
    try:
        with open(path, 'rb') as f:
            data = f.read()
    except OSError as e:
        raise CorruptCheckpointError(
            f'step {step}: missing shard {entry["file"]}: {e}') from e
    digest = hashlib.sha256(data).hexdigest()
    if digest != entry['sha256']:
        raise CorruptCheckpointError(
            f'step {step}: hash mismatch on {entry["file"]} '
            f'(manifest {entry["sha256"][:12]}…, got {digest[:12]}…)')
    try:
        arr = _parse_npy(data)
    except ValueError as e:
        raise CorruptCheckpointError(
            f'step {step}: shard {entry["file"]} is not a readable .npy '
            f'file: {e}') from e
    storage = _resolve_storage(step, entry)
    if arr.dtype != storage:
        try:
            arr = arr.view(storage)
        except (TypeError, ValueError) as e:
            raise CorruptCheckpointError(
                f'step {step}: shard {entry["file"]} has dtype '
                f'{arr.dtype} but manifest says '
                f'{entry["dtype"]!r}: {e}') from e
    if list(arr.shape) != list(entry['shape']):
        raise CorruptCheckpointError(
            f'step {step}: shard {entry["file"]} has shape '
            f'{list(arr.shape)} but manifest says {entry["shape"]}')
    return arr


def _grouped_manifest_leaves(manifest: Dict[str, Any], named_leaves,
                             step: int
                             ) -> List[List[Dict[str, Any]]]:
    """Manifest entries grouped per template leaf (in flatten order),
    validating leaf count and key paths against the template."""
    groups = _group_by_index(manifest['entries'])
    if set(groups) != set(range(len(named_leaves))):
        raise CorruptCheckpointError(
            f'step {step}: manifest covers leaf indices '
            f'{sorted(groups)}, template has {len(named_leaves)} leaves')
    out = []
    for i, (key, _) in enumerate(named_leaves):
        group = sorted(groups[i], key=entry_slice)
        for entry in group:
            if entry['key'] != key:
                raise CorruptCheckpointError(
                    f'step {step}: manifest key {entry["key"]!r} does '
                    f'not match template leaf {key!r}')
        out.append(group)
    return out


def assemble_leaf_window(directory: str, step: int,
                         entries: List[Dict[str, Any]],
                         want: Optional[SliceSpec] = None,
                         stats: Optional[Dict[str, int]] = None
                         ) -> torch.Tensor:
    """Build one window of a leaf's global array as a CPU tensor,
    reading ONLY the shard files that overlap it.  ``want=None`` means
    the full global array.  Raises CorruptCheckpointError when the
    window is not fully covered (e.g. the shard of a dead writer process
    is missing from the manifest-visible files)."""
    global_shape = entry_global_shape(entries[0])
    if want is None:
        want = full_slice(global_shape)
    if len(want) != len(global_shape):
        raise CorruptCheckpointError(
            f'step {step}: requested window rank {len(want)} does not '
            f'match leaf rank {len(global_shape)}')
    storage = _resolve_storage(step, entries[0])
    window_shape = tuple(stop - start for start, stop in want)
    out = np.empty(window_shape, dtype=storage)
    covered = 0
    for entry in entries:
        spec = entry_slice(entry)
        # Per-dim overlap between the wanted window and this shard.
        overlap = [(max(ws, es), min(we, ee))
                   for (ws, we), (es, ee) in zip(want, spec)]
        if any(start >= stop for start, stop in overlap):
            if stats is not None:
                stats['files_skipped'] = stats.get('files_skipped', 0) + 1
            continue
        arr = _read_entry_array(directory, step, entry)
        _stage('reshard_shard_read', os.path.join(directory,
                                                  entry['file']))
        if stats is not None:
            stats['files_read'] = stats.get('files_read', 0) + 1
            stats['bytes_read'] = (stats.get('bytes_read', 0) +
                                   int(entry['bytes']))
        dst = tuple(slice(start - ws, stop - ws)
                    for (start, stop), (ws, _) in zip(overlap, want))
        src = tuple(slice(start - es, stop - es)
                    for (start, stop), (es, _) in zip(overlap, spec))
        out[dst] = arr[src]
        covered += _elements(overlap)
    if covered != _elements(want):
        raise CorruptCheckpointError(
            f'step {step}: window {want} only covered for {covered} of '
            f'{_elements(want)} elements — shard file(s) missing for '
            f'part of the leaf (dead writer process?)')
    return _to_torch(out, entries[0]['dtype'])


def restore_pytree(root: str, step: int, template) -> Any:
    """Load a sharded checkpoint as CPU tensors shaped like
    ``template``, assembling each leaf's FULL global array from
    whatever shard layout wrote it (v1 whole-leaf or v2 windows).
    Every shard's SHA-256 is verified against the manifest; any
    mismatch raises CorruptCheckpointError."""
    return restore_pytree_resharded(root, step, template)


def restore_pytree_resharded(root: str, step: int, template,
                             stats: Optional[Dict[str, int]] = None
                             ) -> Any:
    """Restore under a (possibly different) process grid.

    A :class:`Shard` template leaf names the window of the global array
    THIS process wants, and only the shard files that overlap it are
    read and hash-verified; any other leaf comes back global (the full
    replicated leaf).  Whatever grid wrote the step, a window comes
    back the same.  The read is
    side-effect free: a crash at any reshard stage leaves the committed
    step dirs untouched."""
    directory = step_dir(root, step)
    if not os.path.exists(os.path.join(directory, MARKER)):
        raise CorruptCheckpointError(
            f'step {step}: no {MARKER} marker — uncommitted or torn save')
    manifest = load_manifest(root, step)
    named_leaves, treedef = flatten_with_keys(template)
    groups = _grouped_manifest_leaves(manifest, named_leaves, step)
    _stage('reshard_planned', directory)

    def assemble(job):
        group, template_leaf = job
        want = (template_leaf.window if isinstance(template_leaf, Shard)
                else None)
        leaf_stats: Dict[str, int] = {}
        leaf = assemble_leaf_window(directory, step, group, want,
                                    leaf_stats)
        _stage('reshard_leaf_assembled', directory)
        return leaf, leaf_stats

    results = _map_threads(
        assemble, [(group, leaf) for (_, leaf), group in
                   zip(named_leaves, groups)])
    leaves = [leaf for leaf, _ in results]
    if stats is not None:
        for _, leaf_stats in results:
            for name, value in leaf_stats.items():
                stats[name] = stats.get(name, 0) + value
        stats['leaves'] = len(leaves)
        stats['writer_process_count'] = int(
            manifest.get('process_count', 1))
    _stage('reshard_restored', directory)
    return tree_unflatten(treedef, leaves)


def remove_step(root: str, step: int) -> None:
    path = step_dir(root, step)
    if os.path.isdir(path):
        shutil.rmtree(path)


def clean_stale_tmp(root: str) -> List[str]:
    """Remove leftover staging dirs from crashed saves.  Only safe when
    no save is in flight: ``save_pytree`` calls it on process 0 before
    the pre-write barrier releases any process into writing."""
    removed = []
    if not os.path.isdir(root):
        return removed
    for name in os.listdir(root):
        if name.startswith(TMP_PREFIX):
            path = os.path.join(root, name)
            try:
                shutil.rmtree(path)
                removed.append(path)
            except OSError as e:
                logger.warning(f'Could not remove stale checkpoint '
                               f'staging dir {path}: {e}')
    return removed
