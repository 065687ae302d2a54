"""Open-loop virtual-time fleet simulator.

Drives REAL `ContinuousBatcher` replicas (infer/serving.py) — the
actual admission path, grouped prefill, radix prefix-cache install and
lockstep decode all execute, on the card (the kernels of the pooled
plane) or on the CPU when asked — but accounts time with a
deterministic token-cost model instead of the wall clock:

    step_cost = step_overhead_s
              + prefill_tokens * prefill_cost_per_token_s
              + decode_tokens  * decode_cost_per_token_s

where prefill/decode token counts are integer deltas observed from the
batcher (prefix-cache `tokens_saved` shrinks the prefill charge — a
warm head really is cheaper).  Wall-clock never enters the summary, so
the same `TrafficConfig` seed and `SimConfig` always produce the same
SERVE_SUMMARY, on any machine.

Open-loop means arrivals are fixed in advance by the trace: an
overloaded fleet builds queues (and its TTFT tail blows up) instead of
throttling the generator — the regime where routing policy and
autoscaling actually matter.

The simulator routes through a real `LoadBalancingPolicy` (the object
under test) and can optionally feed an `Autoscaler` with the same
virtual-time reports the load balancer sends the controller
(`ttft_ms` / `queue_depth` / `prefix_hit_ratio`), applying its
SCALE_UP/SCALE_DOWN decisions as live replica churn.

Chaos mode (`chaos_cfg`): a seeded fault schedule kills, preempts
(with notice), stalls, or partitions replicas at virtual-time points,
and the simulator plays its own load balancer's failure-handling role
with the REAL primitives from `serve/failover.py`:

- Detection is honest: a probe pass observes only reachability
  (kill/partition fail it) and a progress watchdog catches stalls —
  `failure_threshold` consecutive bad probes open the replica's
  circuit, removing it from routing; half-open probes on the
  `utils/backoff.py` schedule let a healed replica rejoin.
- Every token is journaled in a `SessionJournal` AT DELIVERY (a
  partitioned replica's computed-but-undelivered tokens are never
  committed).  When a circuit opens, its open sessions are re-admitted
  on survivors by deterministic replay — prompt + committed tokens
  re-prefilled, budget shrunk to the un-delivered remainder — so
  greedy sessions are bit-exact with a fault-free run and no token is
  dropped or duplicated (`session_outputs()` is the witness).
- A preemption notice drains the replica and hands its sessions off
  between decode chunks via the same cancel/replay path.
- Replica death reports to the autoscaler as a terminal FAILED info:
  dead capacity is REPLACED (scale-up), never averaged into load.

With `chaos_cfg=None` the extra machinery is inert and the simulator
is behaviorally identical (same RNG draws, same cost charges, same
summary) to the pre-chaos implementation.

Counterpart of skypilot_tpu/serve/traffic/simulator.py: the same
configs, the same draws, the same cost charges and the same summary.
The replicas are the port's batchers, which count the same admissions,
tokens, prefix hits, tier copies and pool blocks, so a run gives the
JAX simulator's SERVE_SUMMARY on the same configs.  `FleetSimulator`
takes three keyword-only seams: `model_config` (default LLAMA_DEBUG),
`params` (default `llama.init_params` from a generator seeded by
`model_seed`; one tree shared by every replica) and `device` (default
the card; a CPU-only host must pass device='cpu').
"""
from __future__ import annotations

import dataclasses
import itertools
import math
import random
from typing import Any, Callable, Dict, List, Optional, Set

from skypilot_tpu_torch.serve import failover as failover_lib
from skypilot_tpu_torch.serve import load_balancing_policies as lb_policies
from skypilot_tpu_torch.serve import slo as slo_lib
from skypilot_tpu_torch.serve.autoscalers import AutoscalerDecisionOperator
from skypilot_tpu_torch.serve.serve_state import ReplicaStatus
from skypilot_tpu_torch.serve.traffic.generator import (Arrival,
                                                        TrafficConfig,
                                                        generate_trace)
from skypilot_tpu_torch.telemetry import accounting as accounting_lib
from skypilot_tpu_torch.telemetry import doctor as doctor_lib
from skypilot_tpu_torch.telemetry import metrics as telemetry_metrics
from skypilot_tpu_torch.telemetry import spans as spans_lib
from skypilot_tpu_torch.telemetry import trace as trace_lib
from skypilot_tpu_torch.utils.backoff import Backoff

FAULT_KINDS = ('kill', 'preempt', 'stall', 'partition')


def _session_trace_id(sid: int) -> str:
    """Deterministic per-session trace id (the LB header analogue):
    the trace a sim run exports must be byte-identical per seed, so
    ids derive from the session index, not uuid4."""
    return f'{sid:016x}'


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """One scheduled fault against one replica (virtual time).

    kinds:
      kill      — the replica vanishes without notice (spot loss, host
                  death).  Detected by failed probes; sessions fail
                  over by replay; the autoscaler sees FAILED capacity.
      preempt   — preemption WITH notice: the replica drains and its
                  sessions hand off to survivors between decode
                  chunks.  No detection latency.
      stall     — the replica stops making progress for `duration_s`
                  but still answers probes (wedged device, GC pause).
                  Only the progress watchdog catches it.
      partition — the replica keeps computing but nothing it produces
                  is delivered for `duration_s` (network fault).
                  Probes fail; the journal's at-delivery commit rule
                  is what keeps its zombie tokens out of the stream.
    """
    t: float
    kind: str
    replica: int
    duration_s: float = 0.0

    def __post_init__(self) -> None:
        if self.kind not in FAULT_KINDS:
            raise ValueError(f'kind must be one of {FAULT_KINDS}, '
                             f'got {self.kind!r}')
        if self.kind in ('stall', 'partition') and self.duration_s <= 0:
            raise ValueError(f'{self.kind} fault needs duration_s > 0')


@dataclasses.dataclass
class ChaosConfig:
    """Fault schedule + detection knobs (virtual seconds)."""
    events: List[FaultEvent] = dataclasses.field(default_factory=list)
    # Consecutive failed probes before a circuit opens.
    failure_threshold: int = 3
    # Progress watchdog: a replica with in-flight work that advances
    # nothing for this long counts as a failed probe.
    stall_timeout_s: float = 1.5
    # Half-open probe schedule for OPEN circuits.
    probe_backoff_initial_s: float = 0.5
    probe_backoff_cap_s: float = 8.0

    def __post_init__(self) -> None:
        if self.failure_threshold < 1:
            raise ValueError('failure_threshold must be >= 1')
        if self.stall_timeout_s <= 0:
            raise ValueError('stall_timeout_s must be positive')


@dataclasses.dataclass
class SimConfig:
    """Fleet + cost-model knobs (all time is VIRTUAL seconds)."""
    policy: str = 'least_load'
    num_replicas: int = 2
    # SERVE_SUMMARY goodput counts completions whose TTFT met this SLO.
    slo_ttft_s: float = 2.0
    # Per-token decode-cadence target for the SLO burn-rate monitor
    # (None = TPOT signal disabled; TTFT always uses slo_ttft_s).
    slo_tpot_s: Optional[float] = None
    # Fleet scheduling quantum: arrivals dispatch and replicas catch up
    # once per tick.  Smaller = finer TTFT resolution, more host loops.
    tick_s: float = 0.25
    # Token-cost model (the determinism contract: costs are charged
    # from integer token-count deltas, never from the wall clock).
    prefill_cost_per_token_s: float = 1e-3
    decode_cost_per_token_s: float = 2e-3
    step_overhead_s: float = 5e-3
    # Replica engine shape (LLAMA_DEBUG scale by default).
    batch_size: int = 4
    max_seq_len: int = 256
    decode_chunk: int = 4
    prefix_cache_mb: Optional[float] = 4.0
    prefix_block: int = 64
    # Chunked prefill + piggyback (None = off, the batcher defaults):
    # prefill_chunk routes long prompts through the incremental lane;
    # fuse_budget additionally piggybacks their windows onto decode
    # chunks.  Fused tokens are charged INLINE at the fused rate (None
    # = the dedicated prefill rate) and subtracted from the completion
    # charge, so the sweep can price the piggyback's better overlap
    # before committing kernel time.
    prefill_chunk: Optional[int] = None
    fuse_budget: Optional[int] = None
    fused_prefill_cost_per_token_s: Optional[float] = None
    # Host KV tier (None = off, the batcher default): evicted prefix
    # blocks spill to per-replica host DRAM and dispatch-time hints
    # prefetch them back ahead of admission.  Copy traffic is charged
    # to the replica's vclock at these link bandwidths (GB/s), so a
    # sweep can price the tier's transfer cost before committing a
    # real host link.  Requires prefix_cache_mb (the tier spills
    # prefix-cache evictions).
    host_tier_mb: Optional[float] = None
    tier_spill_gbps: float = 8.0
    tier_prefetch_gbps: float = 8.0
    # Fleet doctor (None = off): evaluate the telemetry/doctor.py rule
    # registry every `doctor_cadence_s` VIRTUAL seconds over the
    # plane's existing signals (SLO burn, tier churn, breaker opens,
    # pool high-water, backpressure retries).  Incidents land in
    # summary()['doctor']; with `postmortem_dir` set (or
    # SKYTPU_POSTMORTEM_DIR in the env) each opened incident dumps a
    # flight-recorder bundle built ONLY from virtual-clock sources, so
    # bundles are byte-identical per seed.
    doctor_cadence_s: Optional[float] = None
    doctor_thresholds: Optional[Dict[str, float]] = None
    postmortem_dir: Optional[str] = None
    # Disaggregated prefill/decode pools (serve/disagg.py; 0 = off):
    # the first `prefill_replicas` replicas form a dedicated prefill
    # pool.  Cold prompts of at least `disagg_cold_prompt_tokens`
    # tokens route there, prefill, then hand their KV blocks to the
    # decode replica the handoff scheduler's hashring chose, as a
    # SHA-256-verified host image; the decode replica adopts it into
    # its host tier and stages it through the ordinary prefetch path.
    # Transfer time is charged through the existing tier link model
    # (export at tier_spill_gbps on the exporter's clock, transit at
    # tier_prefetch_gbps before the image lands), so disagg runs stay
    # replay-deterministic.  A handoff whose transfer exceeds
    # `handoff_late_s` counts as late (the DOC203 doctor signal).
    # Requires host_tier_mb; incompatible with chaos_cfg.
    prefill_replicas: int = 0
    disagg_cold_prompt_tokens: int = 64
    handoff_late_s: float = 0.25
    # KV cache layout for every replica (None = model dtype; 'int8' =
    # quantized KV with per-token scales).  Handoff images ship either
    # layout unchanged — the parity tests run both.
    kv_cache_dtype: Optional[str] = None
    # prefix_affinity bounded-load factor (ignored by other policies).
    load_factor: float = 1.25
    model_seed: int = 0
    # Seeds the tie-break RNG the policies use, so routing (and hence
    # the whole summary) is reproducible.
    route_seed: int = 0
    max_ticks: int = 200_000

    def __post_init__(self) -> None:
        if self.num_replicas < 1:
            raise ValueError(f'num_replicas must be >= 1, '
                             f'got {self.num_replicas}')
        if self.tick_s <= 0:
            raise ValueError(f'tick_s must be positive, got {self.tick_s}')
        for field in ('prefill_cost_per_token_s', 'decode_cost_per_token_s',
                      'step_overhead_s'):
            if getattr(self, field) < 0:
                raise ValueError(f'{field} must be >= 0')
        if self.fused_prefill_cost_per_token_s is not None and \
                self.fused_prefill_cost_per_token_s < 0:
            raise ValueError(
                'fused_prefill_cost_per_token_s must be >= 0')
        if self.fuse_budget is not None and self.prefill_chunk is None:
            raise ValueError(
                'fuse_budget requires prefill_chunk (the piggyback '
                'rides the incremental chunked-prefill lane)')
        if self.host_tier_mb is not None and self.host_tier_mb < 0:
            raise ValueError(
                f'host_tier_mb must be >= 0 (0/None disables the '
                f'tier), got {self.host_tier_mb}')
        if self.doctor_cadence_s is not None and self.doctor_cadence_s <= 0:
            raise ValueError(f'doctor_cadence_s must be positive, '
                             f'got {self.doctor_cadence_s}')
        if self.postmortem_dir and self.doctor_cadence_s is None:
            raise ValueError(
                'postmortem_dir requires doctor_cadence_s: the flight '
                'recorder only dumps when the doctor opens incidents')
        if self.host_tier_mb and self.prefix_cache_mb is None:
            raise ValueError(
                'host_tier_mb requires prefix_cache_mb: the tier '
                'spills prefix-cache evictions, so without a prefix '
                'cache there is nothing to spill')
        for field in ('tier_spill_gbps', 'tier_prefetch_gbps'):
            if getattr(self, field) <= 0:
                raise ValueError(f'{field} must be positive, '
                                 f'got {getattr(self, field)}')
        if self.prefill_replicas:
            if self.prefill_replicas < 0:
                raise ValueError(f'prefill_replicas must be >= 0, '
                                 f'got {self.prefill_replicas}')
            if self.prefill_replicas >= self.num_replicas:
                raise ValueError(
                    'prefill_replicas must leave at least one decode '
                    f'replica: prefill={self.prefill_replicas}, '
                    f'num_replicas={self.num_replicas}')
            if not self.host_tier_mb:
                raise ValueError(
                    'disaggregation requires host_tier_mb: the KV '
                    'handoff ships through the host tier on both ends')
            if self.disagg_cold_prompt_tokens < 1:
                raise ValueError(
                    f'disagg_cold_prompt_tokens must be >= 1, got '
                    f'{self.disagg_cold_prompt_tokens}')
        if self.handoff_late_s <= 0:
            raise ValueError(f'handoff_late_s must be positive, '
                             f'got {self.handoff_late_s}')


@dataclasses.dataclass
class _ReqRecord:
    arrival_t: float
    prompt_len: int
    first_token_t: Optional[float] = None
    done_t: Optional[float] = None
    out_len: int = 0
    # Routed through the prefill pool (disaggregated serving): TPOT
    # tail analysis excludes these — the acceptance bar is that the
    # *steady decode* sessions stay flat while the cold burst lands.
    cold: bool = False


@dataclasses.dataclass
class _SessionState:
    """Fleet-side per-session bookkeeping (tokens live in the
    journal; this holds timing + the rid fence)."""
    rec: _ReqRecord
    # The batcher request id currently authorized to deliver for this
    # session.  Together with the journal's replica field it fences
    # zombies: a delivery is accepted only from (owner url, owner rid).
    rid: int
    # Cost-attribution tag (Arrival.tenant); survives failover so the
    # replayed work bills the same tenant.
    tenant: str = 'default'
    fault_detect_t: Optional[float] = None
    refirst_t: Optional[float] = None


class _ReplicaSim:
    """One replica: a real ContinuousBatcher plus a virtual clock."""

    def __init__(self, replica_id: int, url: str, batcher,
                 cfg: SimConfig,
                 span_buf: Optional[spans_lib.SpanBuffer] = None,
                 role: str = 'decode') -> None:
        self.replica_id = replica_id
        self.url = url
        self.batcher = batcher
        self.cfg = cfg
        # Disaggregated pool membership ('prefill' or 'decode'; every
        # replica of a non-disagg fleet is 'decode').
        self.role = role
        # rids admitted for prefill-only service: their single decode
        # token is a prefill-completion marker, never delivered; at
        # completion the request's KV blocks export as a handoff image
        # instead of finishing the session.
        self.handoff_rids: Set[int] = set()
        # The batcher records its spans here on THIS replica's virtual
        # clock (fixed pid = replica_id + 1; pid 0 is the sim plane).
        self.span_buf = span_buf
        self.vclock = 0.0
        self.draining = False
        # Chaos state (inert without a ChaosConfig).
        self.alive = True
        self.stalled_until = 0.0
        self.partitioned_until = 0.0
        self.last_progress_t = 0.0
        self.inflight: List[int] = []
        # Requests that finished while partitioned: done in the
        # batcher, but their tail tokens were never delivered.  They
        # stay resident until the partition heals (flush) or the
        # session is failed over (discard).
        self.parked: List[int] = []
        self.rid_sid: Dict[int, int] = {}
        self.rid_plen: Dict[int, int] = {}
        # Per-rid count of output tokens already committed downstream.
        # Deliveries suppressed by a partition leave this lagging, so
        # the backlog flushes (is not lost) when the link heals.
        self.delivered_upto: Dict[int, int] = {}
        # Per-rid prompt tokens already charged INLINE by fused steps:
        # subtracted from the completion-time prefill charge so fused
        # tokens are never billed twice.
        self.fused_tokens: Dict[int, int] = {}

    @property
    def busy(self) -> bool:
        return self.batcher.num_active > 0 or self.batcher.num_queued > 0

    def stalled(self, now: float) -> bool:
        return now < self.stalled_until

    def partitioned(self, now: float) -> bool:
        return now < self.partitioned_until

    def submit(self, prompt: List[int], max_new_tokens: int, sid: int,
               now: float, tenant: str = 'default') -> int:
        # An idle replica's clock has nothing to do before the request
        # exists; work can never be charged to the past.
        self.vclock = max(self.vclock, now)
        # The trace scope is the sim's stand-in for the LB's
        # X-Skytpu-Trace-Id header: the batcher stamps its spans with
        # the ambient trace id at submit.
        with trace_lib.trace_scope(_session_trace_id(sid)):
            rid = self.batcher.submit(prompt, max_new_tokens=max_new_tokens,
                                      tenant=tenant)
        self.rid_sid[rid] = sid
        self.rid_plen[rid] = len(prompt)
        self.inflight.append(rid)
        return rid

    def advance(self, now: float, deliver, complete) -> None:
        """Catch the replica up to fleet time `now`: step the batcher,
        charging the cost model, while it has work and is behind.  A
        dead replica is gone; a stalled one is frozen in place (its
        vclock resumes at the stall's end)."""
        if not self.alive or self.stalled(now):
            return
        if self.stalled_until:
            self.vclock = max(self.vclock, self.stalled_until)
        while self.busy and self.vclock <= now:
            self._step_once(deliver, complete)
        self.last_progress_t = now

    def _step_once(self, deliver: Callable[['_ReplicaSim', int, float],
                                           None],
                   complete: Callable[['_ReplicaSim', int, float],
                                      bool]) -> None:
        batcher = self.batcher
        pre_out = {rid: len(batcher._requests[rid].out)
                   for rid in self.inflight}
        pc = batcher._prefix
        pre_saved = pc.tokens_saved if pc is not None else 0
        fp = getattr(batcher, '_fuse_policy', None)
        pre_fused = fp.stats.prefill_tokens if fp is not None else 0
        inc_before = batcher._incremental
        # Host-tier determinism barrier: land every outstanding copy
        # BEFORE the step so drain timing is a pure function of the
        # schedule, not of how fast the copy thread ran.  Byte deltas
        # across [here, post-step] are then charged at the configured
        # link bandwidths — the tier's transfer-cost model.
        tier = batcher._tier
        if tier is not None:
            pre_spill_b = tier.spill_bytes
            pre_fetch_b = tier.prefetch_bytes
            batcher.tier_flush()
        batcher.step()
        saved_delta = (pc.tokens_saved - pre_saved) if pc is not None else 0
        # Fused piggyback accounting: chunk tokens a fused step carried
        # this tick are charged INLINE (at the fused rate) and banked
        # per rid, then subtracted from that rid's completion charge.
        # The owning request is the incremental lane's occupant — after
        # the step if the prefill is still in flight, before it if this
        # tick's chunk completed it (a one-tick admit+complete has
        # neither; its whole charge stays inline).
        fused_delta = (fp.stats.prefill_tokens - pre_fused
                       if fp is not None else 0)
        inline_only = 0
        if fused_delta:
            inc_owner = (batcher._incremental
                         if batcher._incremental is not None
                         else inc_before)
            if inc_owner is not None:
                self.fused_tokens[inc_owner.rid] = (
                    self.fused_tokens.get(inc_owner.rid, 0)
                    + fused_delta)
            else:
                inline_only = fused_delta
        newly_first: List[int] = []
        decode_tokens = 0
        for rid in self.inflight:
            out_len = len(batcher._requests[rid].out)
            delta = out_len - pre_out[rid]
            if pre_out[rid] == 0 and out_len > 0:
                newly_first.append(rid)
                delta -= 1    # the first token comes from the prefill
            decode_tokens += delta
        prefill_tokens = max(
            0, sum(self.rid_plen[rid] - self.fused_tokens.pop(rid, 0)
                   for rid in newly_first)
            - saved_delta - inline_only)
        fused_cost = (self.cfg.fused_prefill_cost_per_token_s
                      if self.cfg.fused_prefill_cost_per_token_s
                      is not None
                      else self.cfg.prefill_cost_per_token_s)
        self.vclock += (self.cfg.step_overhead_s
                        + prefill_tokens * self.cfg.prefill_cost_per_token_s
                        + decode_tokens * self.cfg.decode_cost_per_token_s
                        + fused_delta * fused_cost)
        if tier is not None:
            # Bytes that crossed the host link this step: flush-landed
            # spills plus hinted/parked prefetches.  Counters advance
            # only at drain, so every byte is charged exactly once.
            self.vclock += (
                (tier.spill_bytes - pre_spill_b)
                / (self.cfg.tier_spill_gbps * 1e9)
                + (tier.prefetch_bytes - pre_fetch_b)
                / (self.cfg.tier_prefetch_gbps * 1e9))
        for rid in self.inflight:
            if len(batcher._requests[rid].out) > pre_out[rid]:
                deliver(self, rid, self.vclock)
        still: List[int] = []
        for rid in self.inflight:
            if batcher.is_done(rid):
                if complete(self, rid, self.vclock):
                    batcher.result(rid)
                    self._drop_rid(rid)
                else:
                    self.parked.append(rid)
            else:
                still.append(rid)
        self.inflight = still

    def _drop_rid(self, rid: int) -> None:
        self.rid_sid.pop(rid, None)
        self.rid_plen.pop(rid, None)
        self.delivered_upto.pop(rid, None)
        self.fused_tokens.pop(rid, None)


def _percentile(samples: List[float], q: float) -> float:
    ordered = sorted(samples)
    rank = max(1, math.ceil(q * len(ordered)))
    return ordered[rank - 1]


def _frozen(value: Any) -> Callable[[], Any]:
    """A clock or source that returns `value` and references nothing
    else (close()'s replacement for closures over the simulator)."""
    return lambda: value


class FleetSimulator:
    """Replica fleet + policy + trace -> deterministic SERVE_SUMMARY."""

    def __init__(self, sim_cfg: Optional[SimConfig] = None,
                 traffic_cfg: Optional[TrafficConfig] = None,
                 chaos_cfg: Optional[ChaosConfig] = None, *,
                 model_config=None, params=None, device=None) -> None:
        """model_config: the replicas' llama.LlamaConfig (default
        LLAMA_DEBUG).  params: their one shared parameter tree, on
        `device` (default: llama.init_params from a torch.Generator
        seeded by sim_cfg.model_seed).  device: where the replicas run
        (default: the card; without one this raises unless
        device='cpu' is given)."""
        import torch

        from skypilot_tpu_torch.device import resolve_device
        from skypilot_tpu_torch.infer.engine import GeneratorConfig
        from skypilot_tpu_torch.models import llama

        self.cfg = sim_cfg or SimConfig()
        self.traffic = traffic_cfg or TrafficConfig()
        self.chaos = chaos_cfg
        self.device = resolve_device(device)
        self.model_config = model_config or llama.LLAMA_DEBUG
        if self.traffic.vocab_size > self.model_config.vocab_size:
            raise ValueError(
                f'traffic vocab_size {self.traffic.vocab_size} exceeds '
                f'model vocab_size {self.model_config.vocab_size}')
        # ONE param tree shared read-only by every replica: per-replica
        # weights would multiply device memory for no behavioral gain.
        if params is None:
            gen = torch.Generator(device=self.device)
            params = llama.init_params(self.model_config,
                                       gen.manual_seed(self.cfg.model_seed),
                                       self.device)
        self.params = params
        # eos_token=None: random debug weights would hit an arbitrary
        # eos at a weight-dependent step; without one, every request
        # emits exactly max_new_tokens — the cost model stays a pure
        # function of the trace.
        self.gen = GeneratorConfig(
            max_seq_len=self.cfg.max_seq_len,
            batch_size=self.cfg.batch_size,
            temperature=0.0,
            prefix_cache_mb=self.cfg.prefix_cache_mb,
            prefix_block=self.cfg.prefix_block,
            prefill_chunk=self.cfg.prefill_chunk,
            fuse_budget=self.cfg.fuse_budget,
            host_tier_mb=self.cfg.host_tier_mb,
            kv_cache_dtype=self.cfg.kv_cache_dtype)
        if self.cfg.policy == 'prefix_affinity':
            self.policy: lb_policies.LoadBalancingPolicy = \
                lb_policies.PrefixAffinityPolicy(
                    prefix_block=self.cfg.prefix_block,
                    load_factor=self.cfg.load_factor)
        else:
            self.policy = lb_policies.LoadBalancingPolicy.make(
                self.cfg.policy)
        self._ids = itertools.count(0)
        self._now = 0.0
        # Sim-plane spans (routing, session completion, failover) land
        # on pid 0; replica batchers get their own per-vclock buffers.
        self._span_buf = spans_lib.SpanBuffer(pid=0, tid=0,
                                              clock=lambda: self._now)
        self.slo = slo_lib.SLOMonitor(slo_lib.SLOConfig(
            ttft_target_s=self.cfg.slo_ttft_s,
            tpot_target_s=self.cfg.slo_tpot_s))
        # Fleet doctor + flight recorder (inert without a cadence).
        # Every recorder source is virtual-clock/sim-state derived —
        # the process-global SpanBuffer and REGISTRY are cumulative
        # across in-process runs and would break byte-determinism.
        self._doctor: Optional[doctor_lib.Doctor] = None
        self._recorder: Optional[doctor_lib.FlightRecorder] = None
        self._last_signals: Dict[str, float] = {}
        if self.cfg.doctor_cadence_s is not None:
            self._recorder = doctor_lib.FlightRecorder(
                self.cfg.postmortem_dir,
                spans_fn=self._doctor_spans,
                metrics_fn=lambda: dict(self._last_signals),
                pool_fn=self._pool_dump,
                tier_fn=self._tier_dump,
                ledger=self.fleet_ledger())
            self._doctor = doctor_lib.Doctor(
                thresholds=self.cfg.doctor_thresholds,
                recorder=self._recorder)
        self.replicas: List[_ReplicaSim] = []
        self.retired: List[_ReplicaSim] = []
        self.dead: List[_ReplicaSim] = []
        self._by_url: Dict[str, _ReplicaSim] = {}
        self.completed: List[_ReqRecord] = []
        self.dropped = 0
        self.scale_events: List[Any] = []
        self._report_ttfts: List[float] = []
        # Role-split autoscaler feeds (disagg only): cold-prompt TTFTs
        # are the prefill pool's signal, session TPOTs the decode
        # pool's.
        self._report_cold_ttfts: List[float] = []
        self._report_tpots: List[float] = []
        # Session plane: the journal is the exactly-once source of
        # truth for delivered tokens; _sessions holds timing + fences.
        self.journal = failover_lib.SessionJournal()
        self._sessions: Dict[int, _SessionState] = {}
        self._lost: Set[int] = set()
        self.sessions_recovered = 0
        self.sessions_handed_off = 0
        self.replayed_tokens = 0
        self.invariant_checks = 0
        self._failover_latencies: List[float] = []
        self.fault_log: List[Dict[str, Any]] = []
        # Disaggregated prefill/decode pools (inert when
        # prefill_replicas == 0).  Handoffs in transit are the sim's
        # third plane: exported on the prefill replica's clock, they
        # land on the decode replica once virtual time passes t_land.
        self._disagg = self.cfg.prefill_replicas > 0
        self._handoff_sched = None
        self._pending_handoffs: List[Dict[str, Any]] = []
        self._handoff_waits: List[float] = []
        self.handoffs = 0
        self.handoffs_late = 0
        self.handoffs_failed = 0
        self.handoff_export_bytes = 0
        self.handoff_ingest_bytes = 0
        self.cold_routed = 0
        self.decode_routed = 0
        if self._disagg:
            if chaos_cfg is not None:
                raise ValueError(
                    'chaos_cfg with prefill_replicas is unsupported: '
                    'handoff images in transit have no failover story '
                    'yet (fault the single-pool config instead)')
            from skypilot_tpu_torch.serve import disagg as disagg_lib
            self._disagg_lib = disagg_lib
            self._handoff_sched = disagg_lib.HandoffScheduler()
        self._breaker: Optional[failover_lib.CircuitBreaker] = None
        self._pending_faults: List[FaultEvent] = []
        if chaos_cfg is not None:
            # jitter=0: the probe schedule must be a pure function of
            # the failure sequence, and the breaker must not draw from
            # the route-seeded RNG stream (which would perturb routing
            # tie-breaks and break no-chaos/chaos bit-exactness).
            self._breaker = failover_lib.CircuitBreaker(
                failure_threshold=chaos_cfg.failure_threshold,
                backoff_factory=lambda: Backoff(
                    initial=chaos_cfg.probe_backoff_initial_s,
                    cap=chaos_cfg.probe_backoff_cap_s,
                    jitter=0.0))
            self._pending_faults = sorted(chaos_cfg.events,
                                          key=lambda e: e.t)
        for i in range(self.cfg.num_replicas):
            self.add_replica(role=('prefill'
                                   if i < self.cfg.prefill_replicas
                                   else 'decode'))

    # ---- fleet membership ------------------------------------------------
    def add_replica(self, role: str = 'decode') -> str:
        from skypilot_tpu_torch.infer.serving import ContinuousBatcher
        rid = next(self._ids)
        url = f'replica-{rid}'
        # The batcher's span clock reads the replica's vclock, so the
        # spans it emits are virtual-time (hence deterministic per
        # seed).  `cell` breaks the construction cycle: the clock must
        # exist before the batcher, the batcher before the replica.
        span_buf = spans_lib.SpanBuffer(pid=rid + 1, tid=0)
        cell: List[_ReplicaSim] = []
        # Per-replica cost ledger on the replica's virtual clock.
        # export_metrics=False: the Prometheus registry is process-
        # global and would mix the arms of a multi-run comparison.
        ledger = accounting_lib.CostLedger(export_metrics=False)
        # The StepProfiler's host timer is real and would make the
        # ledger's phase split machine-dependent; an event-tick clock
        # (every read advances one tick) keeps attribution a pure
        # function of the deterministic step schedule.  'Seconds' in
        # this replica's ledger are therefore profiler TICKS — the
        # conservation invariant and tenant shares are unit-free.
        ticks = itertools.count(1)
        batcher = ContinuousBatcher(self.params, self.model_config,
                                    self.gen,
                                    decode_chunk=self.cfg.decode_chunk,
                                    span_buffer=span_buf,
                                    span_clock=lambda: cell[0].vclock,
                                    ledger=ledger,
                                    profiler_clock=lambda: float(
                                        next(ticks)),
                                    device=self.device)
        rep = _ReplicaSim(rid, url, batcher, self.cfg, span_buf=span_buf,
                          role=role)
        cell.append(rep)
        rep.last_progress_t = self._now
        self.replicas.append(rep)
        self._by_url[url] = rep
        self._sync_policy()
        return url

    def remove_replica(self, replica_id: int) -> None:
        """Mark a replica DRAINING: it stops receiving new requests but
        finishes its in-flight work, then retires once idle."""
        for rep in self.replicas:
            if rep.replica_id == replica_id and not rep.draining:
                rep.draining = True
                self._sync_policy()
                return
        raise ValueError(f'No live replica with id {replica_id}')

    def _retire(self, rep: _ReplicaSim) -> None:
        """A drained replica leaves the fleet; its ring arcs and
        breaker state leave with it."""
        self.replicas.remove(rep)
        self._by_url.pop(rep.url, None)
        self.retired.append(rep)
        if self._breaker is not None:
            self._breaker.forget(rep.url)
        self._sync_policy()

    def _live(self) -> List[_ReplicaSim]:
        return [r for r in self.replicas if not r.draining]

    def _routable(self) -> List[_ReplicaSim]:
        if self._breaker is None:
            return self._live()
        return [r for r in self._live()
                if not self._breaker.is_open(r.url)]

    def _sync_policy(self) -> None:
        # The LB policy only ever routes the decode pool; the prefill
        # pool is the handoff scheduler's concern (cold dispatch picks
        # least-loaded prefill directly, landings follow the hashring).
        urls = [r.url for r in self._live() if r.role != 'prefill']
        if self._breaker is not None:
            urls = self._breaker.routable(urls, self._now)
        self.policy.set_ready_replicas(urls)
        if self._handoff_sched is not None:
            self._handoff_sched.set_members(
                {r.url: r.role for r in self._live()})
            for role in ('prefill', 'decode'):
                telemetry_metrics.SERVE_DISAGG_POOL_REPLICAS.labels(
                    role=role).set(sum(1 for r in self._live()
                                       if r.role == role))

    # ---- run loop --------------------------------------------------------
    def run(self, autoscaler=None) -> Dict[str, Any]:
        """Play the trace to completion; returns the summary dict.

        With `autoscaler`, every `get_decision_interval()` VIRTUAL
        seconds the fleet sends it the same report shape the load
        balancer sends the controller, then applies its decisions as
        replica churn (scale-down drains; scale-up pays cold caches —
        exactly the dynamics SLOAutoscaler's conservatism is about).
        """
        arrivals = generate_trace(self.traffic)
        # Policy tie-breaks draw from the module RNG; pin it for the
        # run (and restore after) so summaries are reproducible.
        rng_state = random.getstate()
        random.seed(self.cfg.route_seed)
        try:
            now = 0.0
            idx = 0
            pending = list(self._pending_faults)
            next_decision = (float(autoscaler.get_decision_interval())
                             if autoscaler is not None else None)
            next_doctor = (self.cfg.doctor_cadence_s
                           if self._doctor is not None else None)
            for tick in range(self.cfg.max_ticks):
                if idx >= len(arrivals) and self._settled():
                    break
                now += self.cfg.tick_s
                self._now = now
                while pending and pending[0].t <= now:
                    self._apply_fault(pending.pop(0), now)
                while idx < len(arrivals) and arrivals[idx].t <= now:
                    self._dispatch(arrivals[idx], idx)
                    idx += 1
                if self._pending_handoffs:
                    self._land_handoffs(now)
                for rep in list(self.replicas):
                    rep.advance(now, self._deliver, self._complete)
                if self.chaos is not None:
                    for rep in list(self.replicas):
                        self._flush_parked(rep, now)
                    self._probe_tick(now)
                for rep in [r for r in self.replicas
                            if r.draining and not r.busy]:
                    self._retire(rep)
                if autoscaler is not None and now >= next_decision:
                    self._autoscale_tick(autoscaler, now)
                    next_decision = now + autoscaler.get_decision_interval()
                if next_doctor is not None and now >= next_doctor:
                    self._doctor_tick(now)
                    next_doctor = now + self.cfg.doctor_cadence_s
            else:
                raise RuntimeError(
                    f'Simulation exceeded max_ticks={self.cfg.max_ticks} '
                    f'(fleet cannot drain the trace)')
            if self._doctor is not None:
                # Closing examination: a trace that drains before the
                # first cadence tick still gets one observation.
                self._doctor_tick(now)
            return self.summary(makespan=now)
        finally:
            random.setstate(rng_state)

    def _settled(self) -> bool:
        if self._pending_handoffs:
            # A KV image in transit has an idle decode slot waiting on
            # it: the fleet is quiet but the trace is not served.
            return False
        if self.chaos is None:
            return not any(r.busy for r in self.replicas)
        # A partitioned zombie can stay busy after every session it
        # computes for has been failed over — the journal, not the
        # batchers, says when the trace is truly served.
        return all(self.journal.record(sid).done
                   for sid in self._sessions)

    def _dispatch(self, arrival: Arrival, sid: int) -> None:
        if self._disagg and \
                len(arrival.prompt) >= self.cfg.disagg_cold_prompt_tokens:
            rep = self._pick_prefill()
            if rep is not None:
                self._dispatch_prefill(rep, arrival, sid)
                return
        if self._disagg:
            self.decode_routed += 1
        url = self.policy.select_replica({'prompt': arrival.prompt})
        if url is None:
            raise RuntimeError('No ready replicas to route to')
        self.policy.pre_execute_hook(url)
        rep = self._by_url[url]
        self._span_buf.record('lb.select', arrival.t, arrival.t,
                              trace_id=_session_trace_id(sid),
                              replica=url, policy=self.policy.name)
        # The LB's fire-and-forget tier warm-up, in-process: the hint
        # reaches the chosen replica ahead of the request, so a host-
        # resident prefix is staged back before admission consults the
        # trie (the prefetch-overlapped-into-admission path).
        rep.batcher.prefetch_hint(arrival.prompt)
        rid = rep.submit(arrival.prompt, arrival.max_new_tokens, sid,
                         now=arrival.t, tenant=arrival.tenant)
        # The journal's budget is the batcher's post-clamp budget, so
        # replay_spec() knows exactly how many tokens remain owed.
        budget = min(arrival.max_new_tokens,
                     self.cfg.max_seq_len - len(arrival.prompt))
        self.journal.open(sid, arrival.prompt, budget, url)
        self._sessions[sid] = _SessionState(
            rec=_ReqRecord(arrival_t=arrival.t,
                           prompt_len=len(arrival.prompt)),
            rid=rid, tenant=arrival.tenant)

    # ---- disaggregated prefill/decode handoff ----------------------------
    def _pick_prefill(self) -> Optional[_ReplicaSim]:
        """Least-loaded live prefill replica (ties break on url): the
        prefill pool is small and uniform, so a direct least-queued
        pick beats running a second LB policy for it."""
        pool = [r for r in self._live() if r.role == 'prefill']
        if not pool:
            return None
        return min(pool, key=lambda r: (r.batcher.num_queued
                                        + r.batcher.num_active, r.url))

    def _dispatch_prefill(self, rep: _ReplicaSim, arrival: Arrival,
                          sid: int) -> None:
        """Admit a cold prompt on the prefill pool.  The request runs
        with max_new_tokens=1 — its lone decode token is a completion
        marker, never committed — and the journal opens with the FULL
        budget so the decode-side resubmission owes every token."""
        self.cold_routed += 1
        self._span_buf.record('prefill.admit', arrival.t, arrival.t,
                              trace_id=_session_trace_id(sid),
                              replica=rep.url,
                              prompt_tokens=len(arrival.prompt))
        rid = rep.submit(arrival.prompt, 1, sid, now=arrival.t,
                         tenant=arrival.tenant)
        rep.handoff_rids.add(rid)
        budget = min(arrival.max_new_tokens,
                     self.cfg.max_seq_len - len(arrival.prompt))
        self.journal.open(sid, arrival.prompt, budget, rep.url)
        self._sessions[sid] = _SessionState(
            rec=_ReqRecord(arrival_t=arrival.t,
                           prompt_len=len(arrival.prompt), cold=True),
            rid=rid, tenant=arrival.tenant)

    def _start_handoff(self, rep: _ReplicaSim, rid: int, sid: int,
                       t: float) -> None:
        """Prefill finished: export the request's KV blocks as a
        framed host image, charge the export on the prefill replica's
        clock, pick a decode target on the hashring, and put the image
        in transit.  The prefill-side blocks are released by the
        export (release-after-export) — the pool must come back clean."""
        prompt = list(rep.batcher._requests[rid].prompt)
        trace_id = _session_trace_id(sid)
        res = rep.batcher.export_handoff(prompt, trace_id=trace_id)
        if rep.batcher.pooled:
            rep.batcher.pool.check_invariant()
            self.invariant_checks += 1
        if not res or not res['payload']:
            # Nothing exportable (prefix evicted under pressure):
            # recompute the prefill on the decode pool.
            self._fallback_decode(sid, prompt, t)
            return
        data = self._disagg_lib.encode_kv_image(
            prompt[:res['tokens']], self.cfg.prefix_block,
            res['payload'])
        # Export crosses the device->host link on the exporter's
        # clock; transit to the decode host runs at the prefetch link
        # rate before the image can land.  Both legs reuse the tier's
        # bandwidth model, so disagg timing stays replay-deterministic.
        rep.vclock += len(data) / (self.cfg.tier_spill_gbps * 1e9)
        t_exp = rep.vclock
        t_land = t_exp + len(data) / (self.cfg.tier_prefetch_gbps * 1e9)
        key = ','.join(map(str, prompt[:self.cfg.prefix_block]))
        target = self._handoff_sched.choose(key, exporter=rep.url)
        if target is None:
            self._fallback_decode(sid, prompt, t_exp)
            return
        self.handoffs += 1
        self.handoff_export_bytes += len(data)
        telemetry_metrics.SERVE_DISAGG_HANDOFFS.labels(
            outcome='shipped').inc()
        telemetry_metrics.SERVE_DISAGG_EXPORT_BYTES.inc(len(data))
        self._span_buf.record('handoff.export', t, t_exp,
                              trace_id=trace_id, replica=rep.url,
                              nbytes=len(data), tokens=res['tokens'])
        self._span_buf.record('handoff.transfer', t_exp, t_land,
                              trace_id=trace_id, source=rep.url,
                              target=target, nbytes=len(data))
        self._pending_handoffs.append({
            'sid': sid, 'target': target, 'prompt': prompt,
            'data': data, 't_exp': t_exp, 't_land': t_land})

    def _land_handoffs(self, now: float) -> None:
        """Ingest every in-transit image whose t_land has passed, in
        export order (deterministic)."""
        still: List[Dict[str, Any]] = []
        for ho in self._pending_handoffs:
            if ho['t_land'] > now:
                still.append(ho)
            else:
                self._ingest_handoff(ho, now)
        self._pending_handoffs = still

    def _ingest_handoff(self, ho: Dict[str, Any], now: float) -> None:
        sid = ho['sid']
        trace_id = _session_trace_id(sid)
        rep = self._by_url.get(ho['target'])
        if rep is None or not rep.alive or rep.draining:
            self._fallback_decode(sid, ho['prompt'], ho['t_land'])
            return
        try:
            img = self._disagg_lib.decode_kv_image(ho['data'])
        except self._disagg_lib.HandoffImageError:
            # Torn transfer (the SHA-256 caught it): the image is
            # garbage, recompute the prefill instead of splicing it.
            self._fallback_decode(sid, ho['prompt'], ho['t_land'])
            return
        adopted = rep.batcher.ingest_handoff(ho['prompt'], img.payload,
                                             trace_id=trace_id)
        if rep.batcher.pooled:
            rep.batcher.pool.check_invariant()
            self.invariant_checks += 1
        wait = ho['t_land'] - ho['t_exp']
        self._handoff_waits.append(wait)
        self.handoff_ingest_bytes += len(ho['data'])
        telemetry_metrics.SERVE_DISAGG_HANDOFFS.labels(
            outcome='ingested').inc()
        telemetry_metrics.SERVE_DISAGG_INGEST_BYTES.inc(len(ho['data']))
        telemetry_metrics.SERVE_DISAGG_TRANSFER_SECONDS.observe(wait)
        if wait > self.cfg.handoff_late_s:
            self.handoffs_late += 1
            telemetry_metrics.SERVE_DISAGG_HANDOFFS.labels(
                outcome='late').inc()
        # Resubmit the session on the decode replica at landing time.
        # The adopted nodes stage back through the ordinary prefetch
        # path (the hint lands at the next step's tier barrier), so
        # admission splices the handed-off blocks instead of
        # recomputing the prefill.
        # The policy didn't choose this target (the hashring did), but
        # its load accounting must still see the landed session — the
        # completion-side post_execute_hook will balance this.
        self.policy.pre_execute_hook(rep.url)
        spec = self.journal.replay_spec(sid)
        st = self._sessions[sid]
        rid = rep.submit(spec['prompt'], spec['max_new_tokens'], sid,
                         now=ho['t_land'], tenant=st.tenant)
        self.journal.reassign(sid, rep.url)
        st.rid = rid
        self._span_buf.record('handoff.land', ho['t_land'], now,
                              trace_id=trace_id, replica=rep.url,
                              nodes=adopted)

    def _fallback_decode(self, sid: int, prompt: List[int],
                         t: float) -> None:
        """Handoff could not complete (nothing exported, no decode
        target, or a corrupt image): the session is still owed every
        token, so admit it cold on the decode pool."""
        self.handoffs_failed += 1
        telemetry_metrics.SERVE_DISAGG_HANDOFFS.labels(
            outcome='failed').inc()
        url = self.policy.select_replica({'prompt': prompt})
        if url is None:
            raise RuntimeError('No ready decode replicas for handoff '
                               'fallback')
        self.policy.pre_execute_hook(url)
        rep = self._by_url[url]
        spec = self.journal.replay_spec(sid)
        st = self._sessions[sid]
        rid = rep.submit(spec['prompt'], spec['max_new_tokens'], sid,
                         now=t, tenant=st.tenant)
        self.journal.reassign(sid, url)
        st.rid = rid

    # ---- delivery plane --------------------------------------------------
    def _owns(self, rep: _ReplicaSim, rid: int, sid: int) -> bool:
        rec = self.journal.record(sid)
        return (rec.replica == rep.url and not rec.done
                and self._sessions[sid].rid == rid)

    def _deliver(self, rep: _ReplicaSim, rid: int, t: float) -> None:
        if rid in rep.handoff_rids:
            return      # prefill-stage marker token: never delivered
        sid = rep.rid_sid[rid]
        if not self._owns(rep, rid, sid):
            return      # zombie: ownership moved at failover
        if rep.partitioned(t):
            return      # computed, NOT delivered; backlog flushes at heal
        self._commit_fresh(rep, rid, sid, t)

    def _commit_fresh(self, rep: _ReplicaSim, rid: int, sid: int,
                      t: float) -> None:
        """Commit every output token of `rid` not yet delivered."""
        out = rep.batcher._requests[rid].out
        base = rep.delivered_upto.get(rid, 0)
        fresh = out[base:]
        if not fresh:
            return
        rep.delivered_upto[rid] = len(out)
        self.journal.commit(sid, fresh)
        st = self._sessions[sid]
        if st.rec.first_token_t is None:
            st.rec.first_token_t = t
            self._report_ttfts.append(t - st.rec.arrival_t)
            if st.rec.cold:
                self._report_cold_ttfts.append(t - st.rec.arrival_t)
            self.slo.observe_ttft(t - st.rec.arrival_t, now=t)
        if st.fault_detect_t is not None and st.refirst_t is None:
            st.refirst_t = t
            lat = t - st.fault_detect_t
            self._failover_latencies.append(lat)
            telemetry_metrics.SERVE_FAILOVER_LATENCY_SECONDS.observe(lat)
            self._span_buf.record('failover.resume', t, t,
                                  trace_id=_session_trace_id(sid),
                                  latency_s=lat)

    def _complete(self, rep: _ReplicaSim, rid: int, t: float) -> bool:
        """Returns True when the replica may discard the request; False
        parks it (finished behind a partition — the tail is undelivered
        and must survive until heal or failover)."""
        sid = rep.rid_sid[rid]
        if rid in rep.handoff_rids:
            # Prefill stage done: hand the KV image off instead of
            # finishing the session.
            rep.handoff_rids.discard(rid)
            self._start_handoff(rep, rid, sid, t)
            return True
        if not self._owns(rep, rid, sid):
            return True     # zombie: consume and discard
        if rep.partitioned(t):
            return False
        self.policy.post_execute_hook(rep.url)
        self._finish_session(sid, t)
        return True

    def _finish_session(self, sid: int, t: float) -> None:
        rec = self.journal.close(sid)
        st = self._sessions[sid]
        st.rec.done_t = t
        st.rec.out_len = len(rec.committed)
        self.completed.append(st.rec)
        if st.rec.first_token_t is not None and st.rec.out_len > 1:
            tpot = (t - st.rec.first_token_t) / (st.rec.out_len - 1)
            self.slo.observe_tpot(tpot, now=t)
            if self._disagg:
                self._report_tpots.append(tpot)
        self._span_buf.record('session.complete', t, t,
                              trace_id=_session_trace_id(sid),
                              tokens=st.rec.out_len)

    def _flush_parked(self, rep: _ReplicaSim, now: float) -> None:
        """Deliver the tails of requests that finished behind a now-
        healed partition: delayed, not lost."""
        if not rep.parked or rep.partitioned(now):
            return
        for rid in rep.parked:
            sid = rep.rid_sid[rid]
            if self._owns(rep, rid, sid):
                self._commit_fresh(rep, rid, sid, now)
                self.policy.post_execute_hook(rep.url)
                self._finish_session(sid, now)
            rep.batcher.result(rid)
            rep._drop_rid(rid)
        rep.parked = []

    # ---- chaos: faults, detection, failover ------------------------------
    def _apply_fault(self, ev: FaultEvent, now: float) -> None:
        telemetry_metrics.SERVE_CHAOS_FAULTS.labels(kind=ev.kind).inc()
        rep = next((r for r in self.replicas
                    if r.replica_id == ev.replica), None)
        self.fault_log.append({'t': round(ev.t, 3), 'kind': ev.kind,
                               'replica': ev.replica,
                               'applied': rep is not None})
        if rep is None:
            return      # already dead/retired: fault lands on a ghost
        if ev.kind == 'kill':
            rep.alive = False
        elif ev.kind == 'stall':
            rep.stalled_until = max(rep.stalled_until,
                                    now + ev.duration_s)
        elif ev.kind == 'partition':
            rep.partitioned_until = max(rep.partitioned_until,
                                        now + ev.duration_s)
        else:   # preempt, WITH notice: drain + immediate clean handoff
            if rep.draining:
                return
            rep.draining = True
            self._sync_policy()
            self._handoff(rep, now)

    def _probe_tick(self, now: float) -> None:
        """Per-tick health pass.  Probes observe reachability only
        (alive + not partitioned); the watchdog infers stalls from lack
        of progress.  The breaker turns consecutive failures into
        circuit opens and schedules half-open heal probes."""
        assert self._breaker is not None
        for rep in list(self.replicas):
            if rep.draining:
                continue
            url = rep.url
            reachable = rep.alive and not rep.partitioned(now)
            wd_stalled = bool(rep.inflight) and (
                now - rep.last_progress_t > self.chaos.stall_timeout_s)
            if self._breaker.is_open(url):
                if not self._breaker.probe_due(url, now):
                    continue
                if not rep.alive:
                    # The half-open probe found the host gone for
                    # good: confirmed death, stop probing.
                    self._fail_replica(rep, now)
                elif not rep.partitioned(now) and not rep.stalled(now):
                    # The probe is an end-to-end canary; a replica
                    # that is reachable AND unfrozen passes it.
                    self._breaker.note_success(url)
                    self._heal_replica(rep, now)
                else:
                    self._breaker.note_failure(url, now)
                continue
            if reachable and not wd_stalled:
                self._breaker.note_success(url)
            elif self._breaker.note_failure(url, now):
                self.fault_log.append({'t': round(now, 3),
                                       'event': 'circuit_open',
                                       'replica': rep.replica_id})
                self._fail_replica(rep, now)

    def _fail_replica(self, rep: _ReplicaSim, now: float) -> None:
        """The replica's circuit opened (or its death was confirmed):
        remove it from routing and replay its open sessions on
        survivors.  Dead replicas leave the fleet entirely — ring arcs
        and breaker state removed together — and report as terminal
        FAILED capacity to the autoscaler."""
        if not rep.alive and rep in self.replicas:
            self.replicas.remove(rep)
            self._by_url.pop(rep.url, None)
            self.dead.append(rep)
            self._breaker.forget(rep.url)
        self._sync_policy()
        if rep.alive and not rep.partitioned(now):
            # Stalled-but-reachable: cancel its zombie work now.  A
            # partitioned replica is unreachable — its zombies are
            # fenced by journal ownership and cancelled at heal.
            self._fence(rep, now)
        for sid in sorted(self.journal.sessions_on(rep.url)):
            self._replay_session(sid, now, planned=False)
        self._check_survivor_invariants()

    def _heal_replica(self, rep: _ReplicaSim, now: float) -> None:
        """A half-open probe succeeded: flush any delivery backlog the
        partition held up, cancel decodes whose sessions moved on, and
        rejoin the routing set."""
        self._fence(rep, now)
        self._sync_policy()
        self.fault_log.append({'t': round(now, 3), 'event': 'heal',
                               'replica': rep.replica_id})

    def _fence(self, rep: _ReplicaSim, now: float) -> None:
        """Clear everything resident on `rep`: flush parked tails that
        are still deliverable, discard the rest, cancel in-flight work
        (block release `check_invariant`-verified)."""
        self._flush_parked(rep, now)
        for rid in rep.parked:
            # Still parked => still partitioned: the tail was never
            # delivered and its session replays elsewhere.
            rep.batcher.result(rid)
            rep._drop_rid(rid)
        rep.parked = []
        for rid in list(rep.inflight):
            if rid in rep.batcher._requests:
                rep.batcher.cancel(rid)
            rep._drop_rid(rid)
        rep.inflight = []
        if rep.batcher.pooled:
            rep.batcher.pool.check_invariant()
            self.invariant_checks += 1

    def _handoff(self, rep: _ReplicaSim, now: float) -> None:
        """Preemption notice: move every open session to a survivor
        between decode chunks — cancel on the source (frees its
        blocks), replay prompt+committed on the target."""
        sids = sorted(self.journal.sessions_on(rep.url))
        self._fence(rep, now)
        for sid in sids:
            self._replay_session(sid, now, planned=True)
        self._check_survivor_invariants()

    def _replay_session(self, sid: int, now: float,
                        planned: bool) -> None:
        """Re-admit one session on a survivor, resuming at the first
        un-delivered token (exactly-once: the journal's committed
        prefix becomes part of the replayed prompt)."""
        st = self._sessions[sid]
        st.fault_detect_t = now
        st.refirst_t = None
        self._span_buf.record('failover.detect', now, now,
                              trace_id=_session_trace_id(sid),
                              planned=planned)
        spec = self.journal.replay_spec(sid)
        if spec is None:
            # Every budgeted token was already delivered — only the
            # completion event died with the replica.
            self._finish_session(sid, now)
            return
        url = self.policy.select_replica({'prompt': spec['prompt']})
        if url is None:
            self._lost.add(sid)
            self.journal.close(sid)
            telemetry_metrics.SERVE_FAILOVER_SESSIONS.labels(
                outcome='lost').inc()
            return
        self.policy.pre_execute_hook(url)
        rep = self._by_url[url]
        rid = rep.submit(spec['prompt'], spec['max_new_tokens'], sid,
                         now=now, tenant=st.tenant)
        self.journal.reassign(sid, url)
        st.rid = rid
        replayed = len(self.journal.record(sid).committed)
        self._span_buf.record('failover.replay', now, now,
                              trace_id=_session_trace_id(sid),
                              replayed=replayed, target=url)
        self.replayed_tokens += replayed
        if replayed:
            telemetry_metrics.SERVE_FAILOVER_REPLAYED_TOKENS.inc(replayed)
        if planned:
            self.sessions_handed_off += 1
            outcome = 'handed_off'
        else:
            self.sessions_recovered += 1
            outcome = 'recovered'
        telemetry_metrics.SERVE_FAILOVER_SESSIONS.labels(
            outcome=outcome).inc()

    def _check_survivor_invariants(self) -> None:
        for rep in self.replicas:
            if rep.batcher.pooled:
                rep.batcher.pool.check_invariant()
                self.invariant_checks += 1

    # ---- autoscaling -----------------------------------------------------
    def _autoscale_tick(self, autoscaler, now: float) -> None:
        if getattr(autoscaler, 'prefill', None) is not None and \
                getattr(autoscaler, 'decode', None) is not None:
            self._autoscale_roles(autoscaler, now)
            return
        autoscaler.collect_request_information({
            'ttft_ms': [t * 1000.0 for t in self._report_ttfts],
            'queue_depth': sum(r.batcher.num_queued
                               for r in self._routable()),
            'prefix_hit_ratio': self.prefix_hit_ratio(),
        })
        self._report_ttfts = []
        infos = []
        for r in self.replicas:
            status = ReplicaStatus.READY
            if self._breaker is not None and self._breaker.is_open(r.url):
                status = ReplicaStatus.NOT_READY
            infos.append({'replica_id': r.replica_id, 'status': status,
                          'launched_at': r.replica_id, 'is_spot': False,
                          'draining': r.draining})
        # Dead replicas report terminal: capacity to REPLACE (the
        # autoscaler sees alive < target and scales up), never load to
        # absorb.
        infos.extend({'replica_id': r.replica_id,
                      'status': ReplicaStatus.FAILED,
                      'launched_at': r.replica_id, 'is_spot': False}
                     for r in self.dead)
        for decision in autoscaler.generate_scaling_decisions(infos):
            if decision.operator is AutoscalerDecisionOperator.SCALE_UP:
                self.add_replica()
            else:
                self.remove_replica(decision.target)
        self.scale_events.append(
            {'t': round(now, 3), 'replicas': len(self._live())})

    def _autoscale_roles(self, autoscaler, now: float) -> None:
        """Feed a RoleAwareSLOAutoscaler (serve/disagg.py) its
        role-split report — cold-prompt TTFT burn for the prefill
        pool, session TPOT + queue for decode — and apply each pool's
        decisions inside that pool."""
        def _queue(role: str) -> int:
            return sum(r.batcher.num_queued for r in self._live()
                       if r.role == role)
        autoscaler.collect_request_information({
            'prefill': {
                'ttft_ms': [t * 1000.0
                            for t in self._report_cold_ttfts],
                'queue_depth': _queue('prefill'),
                'prefix_hit_ratio': self.prefix_hit_ratio(),
            },
            'decode': {
                'tpot_ms': [t * 1000.0 for t in self._report_tpots],
                'queue_depth': _queue('decode'),
                'prefix_hit_ratio': self.prefix_hit_ratio(),
            },
        })
        self._report_ttfts = []
        self._report_cold_ttfts = []
        self._report_tpots = []
        infos: Dict[str, List[Dict[str, Any]]] = {'prefill': [],
                                                  'decode': []}
        for r in self.replicas:
            infos[r.role].append({'replica_id': r.replica_id,
                                  'status': ReplicaStatus.READY,
                                  'launched_at': r.replica_id,
                                  'is_spot': False,
                                  'draining': r.draining})
        decisions = autoscaler.generate_scaling_decisions(
            infos['prefill'], infos['decode'])
        for role in sorted(decisions):
            for decision in decisions[role]:
                if decision.operator is \
                        AutoscalerDecisionOperator.SCALE_UP:
                    self.add_replica(role=role)
                else:
                    self.remove_replica(decision.target)
        self.scale_events.append(
            {'t': round(now, 3), 'replicas': len(self._live())})

    # ---- fleet doctor + cost attribution ---------------------------------
    def _all_reps(self) -> List[_ReplicaSim]:
        """Every replica that ever ran: retired and dead replicas'
        spend and health history are part of the story."""
        return self.replicas + self.retired + self.dead

    def close(self) -> None:
        """Shut down every replica batcher (joins the kv-tier copy
        threads), drop its CUDA graphs, and break the reference cycles
        that run through the simulator: each batcher's span clock reads
        its replica, and the sim-plane span clock and the flight
        recorder's sources read the simulator.  They are frozen at the
        end of the run, so the replicas, their batchers and arenas go
        with the last reference to the simulator, without a cyclic
        collection.  Summaries and ledgers stay readable; idempotent."""
        reps = self._all_reps()
        for rep in reps:
            rep.batcher.close()
            if rep.batcher.graphs is not None:
                rep.batcher.graphs.clear()
            rep.batcher._span_clock = _frozen(rep.vclock)
        self._span_buf.clock = _frozen(self._now)
        rec = self._recorder
        if rec is not None:
            rec._spans_fn = _frozen(rec._spans_fn())
            rec._metrics_fn = _frozen(rec._metrics_fn())
            rec._pool_fn = _frozen(rec._pool_fn())
            rec._tier_fn = _frozen(rec._tier_fn())
            ledgers = [rep.batcher._ledger for rep in reps]
            rec._ledger = accounting_lib.FleetLedgerView(_frozen(ledgers))

    def fleet_ledger(self) -> accounting_lib.FleetLedgerView:
        """Merged per-tenant cost rollup across the whole fleet (the
        ledger set is re-read per call — replicas churn)."""
        return accounting_lib.FleetLedgerView(
            lambda: [rep.batcher._ledger for rep in self._all_reps()])

    def _gather_signals(self, now: float) -> Dict[str, float]:
        """One doctor signal snapshot (see doctor.SIGNALS), every
        value derived from sim state on the virtual clock."""
        burn = self.slo.export(now)
        tier_agg = {'spills': 0, 'prefetches': 0, 'prefetch_late': 0}
        for rep in self._all_reps():
            tier = rep.batcher._tier
            if tier is None:
                continue
            # No tier_flush here: forcing copies to land between steps
            # would dodge the per-step byte charge and change vclocks —
            # the doctor must observe, never perturb.
            stats = tier.stats()
            for key in tier_agg:
                tier_agg[key] += stats[key]
        pool_total = pool_hwm = pool_free = 0
        for rep in self.replicas:
            if rep.batcher.pooled:
                stats = rep.batcher.pool.stats()
                pool_total += stats['blocks_total']
                pool_hwm += stats['hwm']
                pool_free += stats['blocks_free']
        return {
            'slo_burn_fast': float(burn['fast'] or 0.0),
            'slo_burn_slow': float(burn['slow'] or 0.0),
            'tier_prefetches': float(tier_agg['prefetches']),
            'tier_prefetch_late': float(tier_agg['prefetch_late']),
            'tier_spills': float(tier_agg['spills']),
            'breaker_opens': (float(self._breaker.opens_total)
                              if self._breaker is not None else 0.0),
            'pool_blocks_total': float(pool_total),
            'pool_hwm': float(pool_hwm),
            'pool_free': float(pool_free),
            'backpressure_retries': float(sum(
                rep.batcher.backpressure_retries
                for rep in self._all_reps())),
            'disagg_handoffs': float(self.handoffs),
            'disagg_handoff_late': float(self.handoffs_late),
        }

    def _doctor_tick(self, now: float) -> None:
        signals = self._gather_signals(now)
        # The recorder's metrics_fn reads this snapshot (sorted so the
        # bundle bytes are stable).
        self._last_signals = dict(sorted(signals.items()))
        self._doctor.observe(signals, now)

    def _doctor_spans(self) -> List[Dict[str, Any]]:
        """Virtual-clock span stream for postmortem bundles: sim plane
        + every replica, merged in virtual-time order (stable sort
        over a deterministic concatenation)."""
        spans: List[Dict[str, Any]] = list(self._span_buf.snapshot())
        for rep in self._all_reps():
            if rep.span_buf is not None:
                spans.extend(rep.span_buf.snapshot())
        spans.sort(key=lambda s: (s['t0'], s['t1']))
        return spans

    def _pool_dump(self) -> Dict[str, Any]:
        return {rep.url: rep.batcher.pool.stats()
                for rep in self.replicas if rep.batcher.pooled}

    # Deterministic subset of kv_tier stats: the *_seconds fields time
    # real copy threads with the wall clock and would break bundle
    # byte-determinism.
    _TIER_DUMP_KEYS = ('spills', 'spill_rejects', 'spill_bytes',
                       'prefetches', 'prefetch_bytes', 'prefetch_late',
                       'host_evictions', 'host_hits', 'device_hits',
                       'misses', 'host_blocks', 'host_resident',
                       'entries')

    def _tier_dump(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        for rep in self._all_reps():
            tier = rep.batcher._tier
            if tier is not None:
                stats = tier.stats()
                out[rep.url] = {key: stats[key]
                                for key in self._TIER_DUMP_KEYS}
        return out

    # ---- metrics ---------------------------------------------------------
    def export_trace(self, path: str) -> int:
        """Merge the sim-plane spans and EVERY replica's spans — live,
        retired, and dead (a killed replica's prefill/decode spans are
        part of the story) — into one Perfetto trace at `path`.  All
        timestamps are virtual and pids are fixed, so a fresh-path
        export is byte-identical for the same seeds.  Returns the
        event count written."""
        extra: List[Dict[str, Any]] = []
        for rep in self.replicas + self.retired + self.dead:
            if rep.span_buf is not None:
                extra.extend(rep.span_buf.events())
        return self._span_buf.export(path, extra_events=extra)

    def span_count(self) -> int:
        """Spans captured across the sim plane and all replicas."""
        return len(self._span_buf) + sum(
            len(rep.span_buf)
            for rep in self.replicas + self.retired + self.dead
            if rep.span_buf is not None)

    def prefix_hit_ratio(self) -> Optional[float]:
        hits = misses = 0
        for rep in self.replicas + self.retired:
            pc = rep.batcher._prefix
            if pc is not None:
                hits += pc.hits
                misses += pc.misses
        if hits + misses == 0:
            return None
        return hits / (hits + misses)

    def session_outputs(self) -> Dict[int, List[int]]:
        """Committed (delivered) tokens per session — the exactly-once
        witness: a chaos run's outputs must equal the fault-free run's
        bit for bit (greedy decode; no duplicates, no gaps)."""
        return {sid: list(self.journal.record(sid).committed)
                for sid in self._sessions}

    def summary(self, makespan: Optional[float] = None) -> Dict[str, Any]:
        recs = self.completed
        ttfts = [r.first_token_t - r.arrival_t for r in recs
                 if r.first_token_t is not None]
        tpots = [(r.done_t - r.first_token_t) / (r.out_len - 1)
                 for r in recs
                 if r.first_token_t is not None and r.out_len > 1]
        span = makespan
        if span is None:
            span = max((r.done_t for r in recs if r.done_t is not None),
                       default=0.0)
        met = sum(1 for r in recs
                  if r.first_token_t is not None and
                  r.first_token_t - r.arrival_t <= self.cfg.slo_ttft_s)
        hits = getattr(self.policy, 'affinity_hits', None)
        misses = getattr(self.policy, 'affinity_misses', None)
        affinity = None
        if hits is not None and (hits + misses) > 0:
            affinity = hits / (hits + misses)
        tokens_saved = sum(
            rep.batcher._prefix.tokens_saved
            for rep in self.replicas + self.retired
            if rep.batcher._prefix is not None)

        def _round(value):
            return None if value is None else round(value, 6)

        burn = self.slo.export(self._now)
        out = {
            'policy': self.policy.name,
            'requests': len(recs),
            'makespan_s': _round(span),
            'ttft_p50_ms': _round(
                _percentile(ttfts, 0.50) * 1000 if ttfts else None),
            'ttft_p99_ms': _round(
                _percentile(ttfts, 0.99) * 1000 if ttfts else None),
            'tpot_ms': _round(
                sum(tpots) / len(tpots) * 1000 if tpots else None),
            'tpot_p99_ms': _round(
                _percentile(tpots, 0.99) * 1000 if tpots else None),
            'goodput_rps': _round(met / span if span else 0.0),
            'slo_attainment': _round(met / len(recs) if recs else None),
            'slo_burn_fast': _round(burn['fast']),
            'slo_burn_slow': _round(burn['slow']),
            'affinity_hit_ratio': _round(affinity),
            'prefix_hit_ratio': _round(self.prefix_hit_ratio()),
            'prefix_tokens_saved': tokens_saved,
            'replicas': len(self._live()),
            'scale_events': self.scale_events,
        }
        if self.cfg.host_tier_mb:
            # Final barrier first: copies dispatched by the last steps
            # land now, so the aggregate is a pure function of the
            # schedule (same determinism contract as the cost model).
            agg = {k: 0 for k in
                   ('spills', 'spill_bytes', 'prefetches',
                    'prefetch_bytes', 'host_hits', 'device_hits',
                    'misses', 'prefetch_late', 'host_resident')}
            for rep in self.replicas + self.retired:
                tier = rep.batcher._tier
                if tier is None:
                    continue
                rep.batcher.tier_flush()
                stats = tier.stats()
                for k in agg:
                    agg[k] += stats[k]
            out['tier'] = agg
        if self._disagg:
            # Decode-session tail health is THE disagg acceptance
            # signal: the cold burst must not inflate the steady
            # sessions' per-token latency (they live on a pool the
            # burst never touches).
            decode_tpots = [
                (r.done_t - r.first_token_t) / (r.out_len - 1)
                for r in recs
                if not r.cold and r.first_token_t is not None
                and r.out_len > 1]
            cold_ttfts = [r.first_token_t - r.arrival_t for r in recs
                          if r.cold and r.first_token_t is not None]
            waits = self._handoff_waits
            out['disagg'] = {
                'prefill_replicas': sum(1 for r in self._live()
                                        if r.role == 'prefill'),
                'decode_replicas': sum(1 for r in self._live()
                                       if r.role == 'decode'),
                'cold_routed': self.cold_routed,
                'decode_routed': self.decode_routed,
                'handoffs': self.handoffs,
                'handoffs_late': self.handoffs_late,
                'handoffs_failed': self.handoffs_failed,
                'export_bytes': self.handoff_export_bytes,
                'ingest_bytes': self.handoff_ingest_bytes,
                'transfer_p50_ms': _round(
                    _percentile(waits, 0.50) * 1000 if waits else None),
                'transfer_p99_ms': _round(
                    _percentile(waits, 0.99) * 1000 if waits else None),
                'cold_ttft_p99_ms': _round(
                    _percentile(cold_ttfts, 0.99) * 1000
                    if cold_ttfts else None),
                'decode_tpot_p99_ms': _round(
                    _percentile(decode_tpots, 0.99) * 1000
                    if decode_tpots else None),
            }
        if len(self.traffic.tenants) > 1:
            # Cost attribution only earns a summary block when there
            # is more than one tenant to attribute between.
            out['acct'] = self.fleet_ledger().summary()
        if self._doctor is not None:
            counts: Dict[str, int] = {}
            for inc in self._doctor.incidents:
                counts[inc.rule] = counts.get(inc.rule, 0) + 1
            out['doctor'] = {
                'incidents': [inc.to_dict()
                              for inc in self._doctor.incidents],
                'incident_counts': dict(sorted(counts.items())),
                'postmortems': (len(self._recorder.dumped)
                                if self._recorder is not None else 0),
            }
        if self.chaos is not None:
            lat = self._failover_latencies
            out['chaos'] = {
                'faults': self.fault_log,
                'circuit_opens': self._breaker.opens_total,
                'sessions_recovered': self.sessions_recovered,
                'sessions_handed_off': self.sessions_handed_off,
                'sessions_lost': len(self._lost),
                'replayed_tokens': self.replayed_tokens,
                'failover_p50_ms': _round(
                    _percentile(lat, 0.50) * 1000 if lat else None),
                'failover_p99_ms': _round(
                    _percentile(lat, 0.99) * 1000 if lat else None),
                'invariant_checks': self.invariant_checks,
            }
        return out
