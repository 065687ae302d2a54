#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (skypilot_tpu_torch).

Run from the root of a checkout on a machine with one NVIDIA card:

    python3 chip_smoke.py

Phases (any failure exits non-zero):

1. device: needs torch.cuda; prints the card's name and power limit.
2. build: compiles skypilot_tpu_torch/csrc/*.cu with nvcc (in parallel)
   into build/torch_kernels/ and loads the library; fails if ptxas
   reports a spill in a tensor-core kernel (K2, K4, K5 and K6 in bf16 at
   hd 64, 128 and 256), in a K1/K7 decode kernel or a
   combine kernel (K1/K7 and K4), or in K3 (whose rows live in
   registers).
3. kernels: holds each hand-written kernel against its plain PyTorch
   version on the card, at the shapes the Llama-3-8B serving path gives
   it, in bf16 and f32 (and int8 arenas for the two paged attentions);
   times kernel, plain version and one PyTorch library call (CUDA events,
   median of 25, L2 flushed before each), and computes each kernel's
   bound from the bytes and operations of this run's inputs.  The paged
   kernels are also run on arenas poisoned past each window and outside
   the tables, and K7 (the contiguous decode, q (8, 8, 4, 128) over the
   1024-row bucket) on caches poisoned past each position, which must
   not change their output.  K2 without its lse is also held at phase
   15's shapes (q (8, 1024, 32, 128) and (4, 2048, 32, 128), kv 8,
   causal, bf16).  K1 and K7 take their split-KV route there
   (and on every main path): K1 is also timed with one slot at position
   8191 (T 128, LLAMA3_8B's max_seq_len), both (and their SDPA
   yardstick) are also timed as a replayed CUDA graph (device time
   without the wrapper's host work), and the combine pass alone is held
   to _combine_splits_plain on the partials of K1's bf16 launch and
   timed; K1 and the combine again at the shape of 10c's GRPO rollouts
   (LLAMA_1B: G 2 over 8 KV heads, 8 slots, a 2-block table), each with
   its own kernels line entry; K1 and the combine also at the decode
   shapes of 12a (Gemma-7B: 16 KV heads of 256, G 1) and 12b
   (Qwen2.5-1.5B: 2 KV heads of 128, G 6), and K1 in bf16 and over an
   int8 arena on tables in which 8 slots share the 16 blocks of one
   1,024-token head (phase 14's warm decode: the entries
   paged_decode[shared blocks] and [int8 shared blocks], their bound
   counting each shared byte once).  K2 with and without its lse at the
   prefill shapes of phase 12 (FLASH_SHAPES), f32 and bf16 at ragged S
   and then in bf16 at the shape, timed both ways: Gemma-7B's q (4, 512,
   16, 256) and Qwen2.5-1.5B's q (4, 512, 12, 128) over 2 KV heads, both
   of which must take the tensor-core route; K3 at the widths and eps of
   every main path (NORM_SHAPES: 4096 at 1e-5, Gemma-7B's 3072 and
   Qwen2.5-1.5B's 1536 at 1e-6) at 1, 8, 104, 264, 2048 and 4097 rows,
   timed at 8, 104 and 264 rows as a replayed graph (as decode replays
   it) and at 2048 eagerly, each beside F.rms_norm timed the same way,
   with the launch policy's configuration; the training kernels also at G 6,
   ragged and at 12b's LoRA-SFT shape (2, 2048, 12/2 heads, 128), and at
   hd 256 at G 8 and 1, ragged, and at 22a's Gemma-7B shape (1, 4096,
   16/16 heads, 256).  K4 (the window attention) takes its tensor-core route in bf16
   and over an int8 arena (the FMA route in f32), split-KV at both of
   its shapes: checked twice (bitwise), timed eager and as a replayed
   graph beside SDPA's, and its combine pass alone held to
   _combine_splits_plain on the partials of the verify bf16 launch; the
   same at hd 256 for Gemma-7B (16 KV heads, G 1) and Gemma-2B's MQA (1
   KV head, G 8), whose bf16 and int8 launches take the hd-256
   tensor-core kernel, and K1 over an int8 arena at Gemma-7B's decode.
   K4 again at phase 23's bench_spec verify (LLAMA_1B: 8 KV heads, G 2,
   W 13), its bf16 (tensor-core route) launch timed.  K2 (o, and its lse) is held to
   _flash_fwd_plain, its own numerics, and to _attention_plain, the JAX
   reference_attention's, at the prefill shape and ragged S.  The
   training kernels (K2 with its lse, K5 dq, K6 dk/dv) are held to their
   plain versions in bf16 and f32 at the LLAMA_1B training shape (8,
   1024, 16/8 heads, 128) and a ragged S, and in bf16 at the 8B trunk's
   (2, 4096, 32/8, 128), and timed at both train shapes; their library
   call is SDPA's forward with grad, and its backward (one time for dq,
   dk and dv) for K5 and K6.  The entries of K2, K5 and K6 carry their
   design, TFLOP/s and the ptxas registers and spill of the
   instantiation timed.
4. slice parity: a 2-layer LLAMA_DEBUG model in f32 served on the host
   (plain versions), on the card eagerly (graphs=False) and on the card
   through the engines' CUDA graphs (the default) from the same weights:
   identical greedy tokens on all three (plain, spec_k=3, fuse_budget,
   int8 KV and weights; the legacy batcher planes 'paged', 'inplace' and
   'paged' with int8 KV; the Generator on the pooled plane, with
   spec_k=3, and on 'paged', which stays eager), each graph key captured
   once and chunks replayed; allclose first-step logits; spec_k=3, the
   fused schedule, the legacy planes and the Generator give the plain
   schedule's tokens (int8 KV aside).  Training parity on the same model:
   first-step gradients under remat False, True and 'dots' on card and
   host, and 3 Trainer steps (loss, grad_norm) on both; and the
   first-step adapter gradients of LoRA-SFT and LoRA-DPO on both.  MoE
   parity on a 2-layer MoE model at LLAMA_DEBUG's attention widths (4
   experts, top 2, f32): identical greedy tokens on the host, the card
   eager and the card through graphs (pooled plane, plain and spec_k=3),
   and first-step gradients of moe.loss_fn card vs host under
   router_impl 'capacity' and 'dense'.
5. main path: random LLAMA3_8B bf16 weights on the card behind the HTTP
   replica (ContinuousBatcher, batch 8, max_seq_len 2048, prefill_chunk
   256, decode_chunk 16); 8 requests of 17..700 prompt tokens, 48 new
   tokens each, greedy, sent as one burst admitted in a fixed order;
   served first eagerly (graphs=False), then through the batcher's CUDA
   graphs (the main path): identical greedy tokens.  Each run prints
   decode tokens/s, graph captures, capture seconds (inside
   decode_seconds), replays and the live share of the decode chunks'
   slot-steps.
6. main path with speculative verify and fused steps, twice on phase 5's
   weights: (a) bf16 with spec_k 12 and fuse_budget 264, (b) the same
   with int8 KV and int8 weights.  The same 8 requests.
7. the legacy decode_impl='paged' plane (K7 over the bucketed slot
   cache) on phase 5's weights: the same 8 requests behind the replica
   (a) in bf16 and (b) with int8 KV, and (c) one Generator.generate of
   the 8 prompts.  K1 must not launch; the slot cache must grow, and
   shrink back to its smallest bucket for a short request afterwards.
   Prints TTFT, decode tokens/s, migrations and memory.
8. train path: Trainer(loss_fn, params, config).fit on random bf16
   weights, remat 'dots', chunked CE: (a) LLAMA_1B at the reference
   bench's settings (8 x 1024 tokens, loss_chunk 256, 12 steps, warmup 2
   of 12) through the port's bench (bench.bench_train, the training
   headline phase 23 reports), (b) LLAMA3_8B's widths at depth 2 (2 x
   4096 tokens, loss_chunk 512, 6 steps).  Prints step time, tokens/s,
   MFU against 989e12 (6N with and without the embedding), the losses,
   peak memory and launches per step.
9. checkpoints, LLAMA_1B at phase 8a's settings, under a temp dir that
   is removed after (fails early without ~28 GB free): (a) Trainer A
   takes 8 steps with async saves every 4 (keep_last 2); Trainer B,
   from another seed, restores the latest step, which must be 8 and
   equal A's state leaf by leaf (torch.equal); one forward and backward
   run twice from B's state must be bitwise repeatable, and 3 more
   steps of A and B on the same batches must give identical losses,
   grad norms and states.  Prints the snapshot stall
   and write + commit seconds a save, GB/s, restore seconds, and the
   step time with a save in flight beside 8a's.  (b) `python -m
   skypilot_tpu_torch.train.train_llama --model-size 1b --seq-len 1024
   --batch-size 8 --steps 16 --checkpoint-every 4` in a child process,
   sent SIGTERM once it has printed `saved step 8` and started staging
   step 12; relaunched with `--resume auto`, it must print `resumed
   from step N` for the newest committed step N and finish at step 16
   with a finite loss.  Prints the recovery seconds (relaunch to
   `resumed from step N`).
10. post-training, after the memory of phases 8-9 is freed: random
   LLAMA3_8B bf16 weights at all 32 layers (remat 'dots', loss_chunk
   512) as a frozen base.  (a) LoRA-SFT (rank 16, alpha 32, the attn
   target) through Trainer.fit, 6 steps of 2 x 2048 tokens from a
   {prompt, completion} JSONL the phase writes: the base never requires
   grad, its float64 checksum is unchanged, every B has moved; prints
   step time, tokens/s, completion tokens/s, peak memory, launches a
   step and MFU with its formula, (4N + 2N_adapted) x tokens/s / 989e12.
   (b) LoRA-DPO on the same base, 4 steps of 2 pairs x 1024 tokens, beta
   0.1: the step-0 loss must be log 2 (B = 0: policy = reference), and
   K2 must run without its lse in the reference passes; prints
   dpo_metrics.  (c) GRPO on LLAMA_1B (group 8, 2 prompts, 32 new
   tokens, temperature 1, kl_coef 0.05, 3 steps, the token-band reward):
   a greedy Generator over the Trainer's live tensors, captured before
   the steps, must then give a fresh Generator's tokens over a clone of
   the params; prints rollout and update seconds and the reward.  (d)
   train_sft (LoRA, checkpoint, --merge-save), train_dpo (LoRA) and
   train_rl at debug size as child processes: the merged file must equal
   merge_lora of the restored adapters bitwise and give the same greedy
   tokens; all finish with finite losses.
11. Mixtral-8x7B-v0.1's published widths (mixtral_config), random bf16
   weights, after phase 10's memory is freed.  (a) 16 of its 32 layers
   (23.48B parameters, 46.97 GB: the 32 do not fit the card) served as
   phase 5 serves LLAMA3_8B, through graphs (router_impl 'dense', the
   serving formulation): every request returns 48 tokens; prints phase
   5's stats and the decode step's bound, the streamed bytes over 3.35
   TB/s.  (c) LoRA-SFT of that frozen base once the batcher is released
   (rank 16, alpha 32, attn target, loss_chunk 512, 4 steps of 2 x 2048
   tokens): the base's checksum unchanged, every B moved; MFU counts
   (4 N_active + 2 N_adapted), N_active the attention, router and top 2
   experts a layer and the lm_head.  (b) Full-parameter training of a
   2-layer model at the same widths through train_moe.make_trainer
   (router_impl 'capacity', remat, 6 steps of 2 x 4096 tokens): finite
   losses and router aux losses; prints MFU = 6 N_active x tokens/s /
   989e12 with and without the lm_head.
12. HF checkpoints, each written by the script in HF's layout (names,
   (out, in) shapes, safetensors by hand, 5 GB shards with an index,
   random bf16 weights from a seed drawn on the card; it fails early,
   naming the bytes it needs, where the temp dir is short) and loaded by
   convert.load_hf_model onto the card.  (a) Gemma-7B's published
   config (google/gemma-7b's config.json: 28 layers, 16 heads of 256,
   ff 24576, vocab 256000, tied, norms stored as w - 1): 17.08 GB
   written, the port's tree 18.65 GB with the lm_head's copy; served as
   phase 5 serves LLAMA3_8B, through graphs; the directory deleted after
   (17.1 GB of disk at the peak).  (b) Qwen2.5-1.5B's (Qwen/Qwen2.5-1.5B:
   28 layers, 12 heads over 2 KV heads of 128, q/k/v biases, tied,
   max_position_embeddings 131072), served the same way, LoRA-SFT of the
   loaded base (rank 16 on attn, 3 steps of 2 x 2048), and `python -m
   skypilot_tpu_torch.train.train_sft --hf-model DIR --lora-rank 16
   --steps 3` as a child process.  Each load prints seconds, GB/s, the
   host's peak RSS growth (VmRSS sampled every 2 ms), which must stay
   below the model's bytes, and the device's peak;
   every leaf is held bitwise to the tensors drawn (drawn again), with
   each leaf's bit checksum.  The serves print phase 5's stats and the
   decode step against its bytes bound.  (c) 12a's Gemma-7B weights (all
   28 layers) serve the same requests with spec_k 12 and fuse_budget 264
   as phase 6 serves LLAMA3_8B, in bf16 and with int8 KV: every K4
   launch of both wrappers (verify and the fused lane at hd 256) on the
   tensor-core route, drafts proposed, fused steps run, every graph key
   captured once and chunks replayed; prints the accept rate and the
   share of each request's tokens equal to 12a's before the first
   difference (information: bf16 rounds differently on another
   schedule).  (d) Gemma-like (hd 256, gelu,
   the (1 + w) norm, tied) and Qwen2-like (biases, G 6, tied) configs
   at debug size in f32, each loaded on the host and on the card:
   bitwise equal leaves, allclose logits, identical greedy tokens on the
   host, the card eagerly and the card through graphs.
13. ResNet: (a) ResNet18Thin in f32 from one params_from_flax state on
   the host and on the card, one SGD-momentum step: loss, every
   gradient and update, running statistics held at RESNET_GRAD_REL /
   RESNET_ATOL, and the same step on the card with TF32 and with bf16
   convolutions, controls that must read past RESNET_GRAD_REL; (b)
   train_resnet's path, ResNet50 at batch 256 of
   224x224 in bf16 (2 warm-up, 10 timed steps: images/s, step ms, peak
   memory), then the entry point itself as a child process.
14. the prefix cache, the host KV tier and the prefill -> decode handoff
   on random LLAMA3_8B bf16 weights (phase 5's seed) at 8 of its 32
   layers (cut for time; the budgets follow the KV bytes a token),
   pooled plane through graphs, prefill_chunk = prefix_block = 256.
   (a) bench_prefix_reuse's shape: 8 requests sharing a 1,024-token head
   with their own 64-token tails, 48 new tokens, batch 8, prefix_cache_mb
   2048; after a warm-up on a disjoint head, a cold batch, then a warm one
   with new tails: the warm tokens equal a batcher without a prefix
   cache, the warm hits make no install/extract copy and one host sync
   an admission (as the cold ones), the trie's bytes stay in budget;
   prints TTFT, prefill and decode tokens/s, hits, misses, tokens saved,
   evictions, pool shares.  (b) bench_tier_reuse's shape: 12 heads of
   1,024 tokens (1.61 GB of KV), a device budget of a tenth of that, a
   host tier of twice it in pinned memory; every head once, then each
   revisited after a prefetch_hint; tier off, then on: identical tokens,
   every prefetched node's arena bytes equal (SHA-256) those gathered at
   its spill; prints the tier's counts, spill and prefetch GB/s beside a
   plain pinned 1 GB copy each way, revisit TTFTs, the pinned
   allocation's seconds and RSS.  (c) a prefill batcher and a decode
   batcher over one parameter dict, in bf16 and int8 KV: 4 cold
   1,040-token prompts prefilled, exported, encoded, decoded, ingested
   and served 48 tokens, and a fifth whose image has a flipped byte
   (refused, served cold): all equal single-pool serving; drain_sessions
   mid-decode holds the uninterrupted tokens so far, and the specs run
   on the other batcher; prints image bytes, encode/decode ms and
   export-to-first-token seconds.  (d) LLAMA_DEBUG f32 on the host, the
   card eagerly and through graphs: the Generator's warm path (pooled and
   'paged'), the batcher's pooled plane with an evicting budget and the
   host tier, its 'paged' plane (install/extract, K7), and drain_sessions
   resumed on a second batcher: identical tokens, warm equal cold and the
   uninterrupted run, pooled arenas allclose (the tiered runs' ticks
   start once every queued tier copy ran; one more card run without
   that logs how far its arena layout strays).
15. telemetry and the entry points around the batcher, LLAMA3_8B bf16 at
   8 of its 32 layers in process (phase 14's cut, from phase 5's seed,
   with its settings; the children of (d) and (e) at all 32).  (a) Phase 5's 8 requests (tenants a and b in turn) on two
   batchers on graphs, one built with a SpanBuffer and a CostLedger and
   one without: a warm-up burst on each, then in turns (on, off, off,
   on): identical tokens, the same host syncs and decode chunks, one
   queue_wait, ceil(P / 256) prefill_chunk and one delivery span a
   request, and the tenants' device seconds plus the fleet overhead
   equal the ledger's profiler wall to 1e-9; prints decode tokens/s on
   and off, the step-phase shares and the tenants' shares.
   (b) The replica on that batcher: a 600-byte text /v1/completions
   plain and streamed (the deltas concatenate to the plain text), a
   streamed /v1/chat/completions (the role chunk first), /v1/models, and
   a /generate with X-Skytpu-Trace-Id (its id on its spans); prints TTFT
   (the first SSE chunk with text) and latency.  (c) /v1/embeddings of
   phase 5's 8 prompts (K2 without its lse at n_pad 8, bucket 1024; K3):
   each input alone gives its in-batch vector, and each equals encode
   with the plain attention and norm patched in (cosine >= 0.999 both;
   max relative error 0.05), a gate that the same encode without its
   causal mask fails.  (d) batch_infer as a child process
   over 32 JSONL lines (16 text, 16 prompt_ids, 17-700 tokens, 32 new
   each), the first 12 output lines kept and the rest regenerated with
   --resume: 64 distinct ids, none twice, the kept lines unchanged;
   prints how many regenerated outputs equal the first run's, prompts/s
   and tokens/s.  (e) eval_ppl over the repo's SURVEY.md and README.md
   (seq 2048, batch 4, 4 batches) with --loss-chunk 0 and 512: the NLLs
   agree to 1e-3 relative (after one untimed batch); prints tokens/s and
   peak memory.
16. tensor-parallel serving (infer/tp.py, parallel/), its ranks spawned
   as processes that share cuda:0 over gloo (NCCL refuses two ranks on
   one GPU): every rank's kernels run at its own shapes and the
   collectives on CUDA tensors, but no number of it is a multi-card
   rate.  The parent built the kernels (phase 2); phases 16-18 reuse one
   pool of 2 and one of 4 rank processes (RankPool), spawned at first
   use: one failed rank fails the phase, and every rank's exit code is
   checked when the pools close (16a: a pool task whose rank 1 raises
   fails and discards its pool).  Phase 3 checks
   K1, K2 and K4 at the per-rank shapes and K3 at d 8192.  (a) 4 ranks:
   ring_all_gather (tiled and not), ring_reduce_scatter over 2 x 2 and
   4 ranks, pipelined_psum at 1-4 chunks, f32 and bf16, each bitwise the stack or sum in that rank's order computed in
   this process; a pool task whose rank 1 raises must fail.  (b)
   LLAMA3_8B's widths at 12 of 32 layers (cut for time) at tp 2 from
   init_sharded_params (seed 0): phase 5's 8 prompts capped at 256
   tokens, 64 new tokens in bf16 and over an int8 arena, 8 with
   spec_k 4 and fuse_budget 64 (K4), the combines synchronous,
   against tp 1 on the same weights: the
   first-step logits within TP_LOGITS_REL of the largest (each shard
   rounds its partial product to bf16), and each request's tokens
   matched before its first difference; an f32 config at tp 2 must give
   tp 1's tokens.  (c) LLAMA3_70B's widths at 4 of 80 layers (cut for
   time), tp 4: each rank's peak device memory is its shard, its arena
   and at most one drawn f32 slab, never the model; 4 requests against
   tp 1, through the overlapped combines (4 chunks).  (d)
   Qwen2.5-1.5B at tp 4 (tp_kv 2 x tpq 2) read by
   load_hf_model_sharded from HF-layout files, against load_hf_model.
   (e) LLAMA3_8B's widths at 4 layers, tp 2: the Generator at
   overlap_chunks 2 and 4 against the synchronous path (K3 and whole
   products): in f32 the greedy tokens must be identical; in bf16 the
   tokens matched before the first difference and every step's last
   hidden states' max abs difference (the first step's gated at
   TP_LOGITS_REL of its largest), as the factorised norm rounds its
   products differently; and one rank's projections a layer timed
   whole against the spans of 2 and 4 chunks, no collective.  (f) multihost_check on
   the card: a head and a worker through the control channel give the
   one-process tokens.
17. training meshes (the mesh Trainer, parallel/ring_attention.py,
   models/moe.py over ep), its ranks 4 processes sharing cuda:0 over
   gloo (no multi-card rate), every arm in one spawn, each against one
   card on the same seed and batches (the references first, in this
   process): (a) LLAMA_1B bf16 at 4 of its 16 layers (cut for time) at
   fsdp 2 x tp 2, 4 x 1024, 1 warm-up and
   3 timed steps: each step's loss and grad norm within MESH_LOSS_REL /
   MESH_NORM_REL (17e's loss within MESH_MOE_LOSS_REL), each rank's peak within its state share, a gathered
   layer and its gradient and one card's activations; (b) an f32 config
   at hd 128 at dp 2 x fsdp 2 and fsdp 2 x tp 2, 3 steps: losses and
   norms within 1e-5, parameters within test_torch_train's f32
   tolerance; (c) LLAMA3_8B's widths at 2 layers, fsdp 4, one step;
   (d) train_long_context's Trainer at sp 4, seq 8192, LLAMA_1B widths
   at 4 layers (ring attention: the sp ranks launch K3 only; the
   one-card reference K2/K5/K6); (e) train_moe's 'small' at ep 4 and ep
   2 x dp 2; (f) a checkpoint saved at fsdp 2 x tp 2 restores bitwise on
   one card (rank 0), which resumes and saves, and that restores
   bitwise at fsdp 2 x tp 2, which resumes; (g) allreduce_bench over 4
   ranks with --sharded-decode.
18. pipelines and post-training meshes (parallel/pipeline.py, the
   pipelined loss through llama.forward_pipelined, LoRA, DPO and GRPO
   on meshes, MoE's 'capacity' router under sp), 4 ranks sharing cuda:0
   over gloo in one spawn, each arm against one card on the same seed
   (the references first, in this process): (a) LLAMA_1B bf16 at 4 of
   its 16 layers (cut for time) at pp 2 x dp 2, 8 x 1024 in 4
   microbatches, 1 + 3 steps: losses within
   MESH_LOSS_REL and grad norms within MESH_NORM_REL; (b) 17b's f32
   config at pp 4 and pp 2 x fsdp 2: losses within 1e-6, parameters
   within 17b's bound; (c) pp 2 x sp 2 at 2 x 4096 on LLAMA_1B's widths
   at 4 layers (cut for time); (d) LoRA-SFT and LoRA-DPO, 2 steps each,
   of LLAMA3_8B's widths at 2 layers (cut for time) at fsdp 2 x tp 2, the
   SFT adapters merged by train_sft's --merge-save function on the mesh
   and held bitwise against one card's merge, DPO's second step held by
   its logprob sums (_hold_dpo), and one GRPO step
   on LLAMA_1B at dp 2 x fsdp 2 with 10c's settings (rollouts on the
   policy gathered whole: they equal one card's, and the first loss is
   held to its terms' size); (e) train_moe's 'small' with the 'capacity'
   router at sp 2 x ep 2, 17e's shapes, within MESH_MOE_LOSS_REL; (f)
   LLAMA3_8B's widths at 4 layers (cut for time) served at tp 2 on the
   'paged' (K7 per shard) and 'inplace' planes, bf16 and int8 KV, phase
   7's requests capped as in 16b, against tp 1 (prefill logits within
   TP_LOGITS_REL), each plane's decode steps fed the same tokens at tp 2
   and tp 1 (logits within TP_LOGITS_REL), and 16b's f32 config at tp 2
   on both planes, whose greedy tokens must equal tp 1's.  Phase 3 checks K7 at the per-shard shape
   and K2/K5/K6 at 18a's microbatch and 18d's rank shapes.
19. the serving fleet (serve/traffic/simulator.py: traffic, routing,
   SLO burn, autoscalers, failover, the fleet doctor, disaggregated
   prefill) over the port's batchers, the arms of the CPU parity tests
   (FLEET_ARMS): (a) least_load and prefix_affinity on the paired-run
   trace, (b) kill + preempt and stall + partition over their fault-free
   runs, (c) prefill_replicas 1 against the single pool, (d) the doctor
   scenario and the SLO autoscaler's scale-up.  LLAMA_DEBUG f32 on the
   card first: (a)'s prefix_affinity run twice, byte-identical summaries;
   (b) again on the host, summary and session_outputs() equal to the
   card's, outputs equal to the fault-free runs'; (c)'s outputs equal to
   the single pool's.  Then LLAMA3_8B's widths at 4 of its 32 layers
   (cut for time; bf16 weights and KV, random from seed 0, one tree
   shared by every replica), every arm once with every byte budget and
   link rate x8 (its KV bytes a token over LLAMA_DEBUG's): every
   request completes, no session lost, each at its
   token budget, and each summary equals LLAMA_DEBUG's but for the byte
   fields (32x) and the times the images' headers shift
   (fleet_summary_diff); the chaos and disagg arms report their tokens
   matched against their baselines.  Each arm's replicas, batchers and
   arenas must go with its closed simulator while the cyclic collector
   is off (FleetSimulator.close() breaks the cycles through it), and
   device memory must come back within 1% of its level before the
   phase.  Phase 3 checks K1 and K2 at the fleet's shapes.
20. the compile-budget audit (skypilot_tpu_torch/analysis/audit.py):
   (a) run_audit on the card, every entry's engines capturing real CUDA
   graphs (LLAMA_DEBUG's widths, f32, 2 layers, the reference's
   buckets): no check fails, mesh_decode is a skip (no process group)
   and the other skips are output_sharding (no mesh), every decode
   budget counted by the engines' ChunkGraphs; each entry's counts are
   logged.  (b) the graph budgets of the batchers phases 5, 6a, 6b, 7a
   and 7b served through (serve_path watches their graphs from
   construction): each key captured once a bucket visit (a 'paged'
   migration drops the graphs), pooled decode <= 2 keys, verify <= 1,
   fused tails <= 2, and the rows, tables and pooled arena at their
   first addresses.  (c) a batcher whose decode chunk reads
   int(token[0]) must fail the audit.
21. a tick's host syncs, held against the linter
   (skypilot_tpu_torch/analysis/linter.py): (a) ``python -m
   skypilot_tpu_torch.analysis --json --graph-stats`` as a child exits 0
   with the committed findings (no new one, the baseline matched) and a
   call graph with functions, call edges and thread entries; (b) the
   sync census: a ContinuousBatcher at LLAMA3_8B's widths (4 of its 32
   layers: the cut), bf16, random weights from seed 21, 8 slots,
   decode_impl 'pooled', graphs on, a prefix cache, warmed on one run
   of the census traffic (short prompts, one longer than prefill_chunk,
   one prefix hit) until every chunk key is captured; then 32 ticks of
   a second run under torch.cuda.set_sync_debug_mode('warn'), each
   synchronizing call counted by its innermost frame under
   skypilot_tpu_torch/ and its thread.  Every main-thread site must lie
   in engine.host_fetch or on a line the linter reports under SKY101 or
   SKY105 (new, allowed by a marker or baselined); other threads' sites
   are printed, not gated.  Prints the SYNC_CENSUS line (sites and
   counts, ticks, host_fetch calls, decode chunks, median tick time).
22. Gemma fine-tuning, as examples/gemma_finetune.yaml runs it
   (train_llama --hf-model google/gemma-7b --seq-len 4096): (a)
   Gemma-7B's config (GEMMA_7B) through convert.read_hf_config, cut to
   4 of its 28 layers, random bf16 weights from seed 0, Trainer.fit as
   train_llama builds it (the config's remat, its TrainConfig), 1 x 4096,
   6 steps: finite losses; prints step time, MFU (6 N x tokens/s /
   989e12, N with and without the lm_head), peak memory and the K2-lse,
   K5, K6 and K3 launches, and fails unless every K5 and K6 launch took
   the tensor-core route; (b) a Gemma-like config (2 heads of 256, 2
   layers, bf16) on the card and on the host from the same weights: the
   first step's q, k and v projection gradients and 3 Trainer steps'
   losses and grad norms within the printed bf16 bounds (GEMMA_*_REL);
   (c) a Gemma-7B-width checkpoint of 2 layers written in HF's layout
   (2.68 GB) and ``python -m skypilot_tpu_torch.train.train_llama
   --hf-model DIR --seq-len 4096 --steps 2 --data-file README.md`` as a
   child, which must print 2 finite losses (K5 and K6 on the tensor
   cores there too); the directory deleted after.  Phase 3 holds K5 and
   K6 at hd 256 against their plain versions (G 8 and 1, ragged S) and
   times them at 22a's shape.
23. the port's bench (skypilot_tpu_torch/bench.py, the counterpart of
   the JAX package's bench.py) at its card shapes: bench_decode (LLAMA_1B,
   16 slots, bf16, int8 KV and int8 weights + KV, the spans on/off arm and
   the legacy 'inplace' comparison), bench_spec (LLAMA_1B bf16, 8 slots,
   spec_k 12, both arms) and bench_prefix_reuse (LLAMA_1B, 8 requests on
   a 512-token head), then build_headline with phase 8a's training
   headline; then the verify window's logits against the decode step's
   at bench_spec's shapes (spec_verify_logits).  Fails if a sub-bench
   reports an error, pooled_path_cache_migrations is not 0, the
   high-acceptance arm accepted no draft, the two paths' logits differ
   by more than TP_LOGITS_REL of the largest, a scripts/bench_compare.py
   FIELDS path these fill (the training and decode ones) is missing or
   not finite, or the headline does not carry 8a's tokens/s.  Prints
   the headline, greedy_parity and agreeing_prefix_share as measured,
   and each sub-bench's seconds.
   Every phase prints its seconds, and the run its whole.

Every kernel of a main-path run must launch > 0 times in that run (the
counts are set to 0 just before it and read just after; a replayed graph
adds the launches its capture recorded, engine.ChunkGraphs); the window
kernel must launch from both verify and fused ticks, K7 (and never K1)
on every phase 7 path, and K2, K3, K5 and K6 from both train paths and
9a, and K2 with its lse, K3, K5 and K6 from 10a, 10b, 10c, 11b and 11c
(K1 from 10c's rollouts, K1, K2 and K3 from 11a, 12a and 12b, K2 with
its lse, K3, K5 and K6 from 12b's LoRA-SFT, K1 and K3 from 14a, 14b and
both 14c runs, K1, K2 and K3 from 15a, 15b and 15d (batch_infer's child
reports its counts), K2 without its lse and K3 from 15c and 15e, K1,
K2 and K3 from every serving path of phase 16, summed over its ranks,
and K4 from 16b's speculative arm; K2 with its lse, K3, K5 and K6 on
every rank of 17a, 17c and both 17e arms, K3 on every rank of 17d; K2
with its lse, K3, K5 and K6 from 18a, 18d's three arms (K1 too from
GRPO's rollouts), K3 from 18c and 18e, K2, K3 and K7 per shard (never
K1) from 18f's 'paged' arms and K2 and K3 (neither K1 nor K7) from its
'inplace' ones); K1 and K3 from every 8B arm of phase 19, and K2
from those that prefill whole prompts (all but (c)'s, whose prompts take
the chunked windows); K1, K2 and K3 from phase 21's census ticks; K2
with its lse, K3, K5 and K6 from 22a and 22c (its child reports its
counts); K1, K2, K3 and K4's verify windows from phase 23's bench
(8a runs its training headline); K2, K5 and K6 only on their
tensor-core route on every path (bf16 at head_dim 128, and 12a's K2 and
phase 22's K2, K5 and K6 at 256); K4 on phase 6's paths,
where it must also take its split route, on both 12c paths (hd 256)
and on phase 23's, on the tensor-core route only; K1 and K7 only on their split
route on every path of phases 5 to 7, 10c, 11a, 12a, 12b, 12c, 14, 15a, 15b,
15d, 18d's GRPO, 18f, 19 and 21 (B KV <= 128
< 2 x 132 SMs).  The last lines
of standard output are
the {"kernels": [...]} line, the nvidia-smi name/power-limit line, and
{"ok": true, "device": {...}}.
"""
from __future__ import annotations

import collections
import dataclasses
import gc
import hashlib
import json
import math
import os
import re
import shutil
import statistics
import struct
import subprocess
import sys
import tempfile
import threading
import time
import types
import urllib.request
import warnings
import weakref
import zlib

import numpy as np
import torch

# The card's peaks, defined once in the port's bench: HBM bytes/s, the
# dense tensor-core bf16 rate and the f32 FMA rate outside the tensor cores.
from skypilot_tpu_torch.bench import (  # noqa: E402
    CARD_F32_FLOPS as F32_FLOPS, CARD_HBM_BYTES_PER_S as HBM_BYTES_PER_S,
    CARD_PEAK_FLOPS as BF16_FLOPS)
TIMING_REPS = 25
# Tolerances of kernel vs plain version, (atol, rtol), by q's dtype.
# f32: both sides compute in f32 and differ only in summation order.
# bf16: the plain versions round scores (flash) or probabilities (all
# attentions) to bf16 where the kernels keep f32, and every output is
# rounded to bf16 (one ulp is 2^-8 relative), so the bound is a few bf16
# ulps.  An int8 arena takes its q dtype's tolerance: the kernels
# dequantize before each product, the plain versions scale after it.
TOL = {torch.float32: (2e-5, 2e-5), torch.bfloat16: (3e-2, 2e-2)}
# bf16 outputs whose plain version computes in f32 as the kernel does
# (the flash backward's dq, dk, dv; K7; K2's o against _flash_fwd_plain,
# where p is rounded to bf16 against the running max of a 64-key tile on
# the card and against the row's final max in the plain version: the
# same p up to one rounding each), elementwise: atol one bf16 ulp
# (2^-7) of the largest element of the same row (the row's elements
# share their sums' terms, so their f32 noise scales with it; a causal
# gradient's rows differ in scale by 50x), never below the f32
# summation-order atol (rows that cancel to ~0); rtol two ulps (2^-6):
# the f32 sums of both sides round to bf16 on either side of a boundary.
BF16_ROW_ULPS = (2 ** -7, 2 ** -6)
# Slice parity in f32: sums taken in another order across 2 layers (and,
# for int8, the scales applied before the product on the card and after
# it on the host).
LOGITS_TOL = (2e-4, 1e-4)
# Paged-attention shapes of the Llama-3-8B serving path (8 KV heads of
# G 4, head_dim 128, 64-row blocks, 32 blocks a slot at max_seq_len 2048).
KV_HEADS, GROUP, HEAD_DIM, BS, T_WIDTH = 8, 4, 128, 64, 32

CARD = {}
HERE = os.path.dirname(os.path.abspath(__file__))


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        timeout=60, check=True).stdout
    return out.strip().splitlines()[0].strip()


# ---- timing ---------------------------------------------------------------

_FLUSH = None


def time_ms(fn, reps: int = TIMING_REPS) -> float:
    """Median device time of fn() in ms, each call after an L2 flush
    (the serving path finds its operands cold in HBM)."""
    global _FLUSH
    if _FLUSH is None:
        _FLUSH = torch.empty(128 << 20, dtype=torch.uint8, device='cuda')
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        _FLUSH.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def graph_ms(fn, reps: int = TIMING_REPS) -> float:
    """time_ms of fn() captured once in a CUDA graph and replayed: the
    device time of its kernels without the host work of its wrapper
    (which time_ms counts where the host is slower than the L2 flush).
    The capture fails if fn reads a device value on the host."""
    fn()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return time_ms(graph.replay, reps)


def ptxas_report(build_log: str):
    """Registers and spilled bytes (stores + loads) of each kernel
    instantiation, by mangled name, from nvcc's -Xptxas=-v output."""
    report, name = {}, None
    for line in build_log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
            report[name] = {'registers': None, 'spill_bytes': 0}
            continue
        m = re.search(r'(\d+) bytes spill stores, (\d+) bytes spill loads',
                      line)
        if m and name:
            report[name]['spill_bytes'] += int(m.group(1)) + int(m.group(2))
        m = re.search(r'Used (\d+) registers', line)
        if m and name:
            report[name]['registers'] = int(m.group(1))
    return report


def bound(nbytes: float, flops: float, peak_flops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak_flops * 1e3
    return (t_bytes, 'bytes') if t_bytes >= t_ops else (t_ops, 'operations')


def check_close(name: str, out: torch.Tensor, ref: torch.Tensor,
                tol=None) -> float:
    """Max abs error of out against ref; fails past atol + rtol |ref|
    (atol may be a tensor that broadcasts against ref)."""
    atol, rtol = tol or TOL[ref.dtype]
    o, r = out.float(), ref.float()
    if not torch.isfinite(o).all():
        raise AssertionError(f'{name}: non-finite kernel output')
    err = (o - r).abs()
    excess = (err - (atol + rtol * r.abs())).max().item()
    max_err = err.max().item()
    if torch.is_tensor(atol):
        atol = f'{atol.min().item():.2e}..{atol.max().item():.2e}'
    log(f'  {name}: max_abs_err={max_err:.3e} (atol={atol} rtol={rtol})')
    if excess > 0:
        raise AssertionError(f'{name}: kernel disagrees with its plain '
                             f'version (max_abs_err {max_err:.3e})')
    return max_err


def row_tol(ref: torch.Tensor):
    """(atol, rtol) of an output computed in f32 on both sides:
    BF16_ROW_ULPS in bf16, with atol a tensor of one value per row; TOL
    otherwise."""
    if ref.dtype != torch.bfloat16:
        return TOL[ref.dtype]
    ulp, rtol = BF16_ROW_ULPS
    row_max = ref.float().abs().amax(-1, keepdim=True)
    return torch.clamp_min(ulp * row_max, TOL[torch.float32][0]), rtol


def sdpa(q, k, v, **kw):
    """scaled_dot_product_attention, the yardstick of both attentions."""
    return torch.nn.functional.scaled_dot_product_attention(
        q, k, v, enable_gqa=k.shape[1] != q.shape[1], **kw)


# ---- phase 3: kernels -----------------------------------------------------

# K3 at the widths of the main paths: name -> (d, eps, seed).  Phases 5-11
# run LLAMA3_8B's and Mixtral's 4096 at eps 1e-5; 12a Gemma-7B's 3072 and
# 12b Qwen2.5-1.5B's 1536, both at eps 1e-6.
NORM_SHAPES = {'rms_norm': (4096, 1e-5, 3),
               'rms_norm[Gemma-7B]': (3072, 1e-6, 14),
               'rms_norm[Qwen2.5-1.5B]': (1536, 1e-6, 15),
               'rms_norm[LLAMA3_70B d8192]': (8192, 1e-5, 24),
               # Phase 17's ranks: LLAMA_1B's 2048 (17a, 17d) and the
               # MoE 'small' model's 1024 (17e), 2048-8192 rows a rank.
               'rms_norm[LLAMA_1B d2048]': (2048, 1e-5, 25),
               'rms_norm[MoE small d1024]': (1024, 1e-5, 26)}


# K3's row counts: decode's 8 slots, verify's 8 x 13, the fused lane's
# 264 (all three replayed from graphs on the serving paths), a prefill
# chunk's 2048 (4 x 512) and two ragged ones; timed at the first four.
NORM_ROWS = (8, 104, 264, 2048, 1, 4097)
NORM_TIMED = (8, 104, 264, 2048)
NORM_GRAPH_ROWS = 264  # up to this many rows, timed as a replayed graph only


def check_rmsnorm(rmsnorm, name, ptxas):
    """K3 at NORM_SHAPES[name] against its plain version in f32 and bf16
    at every NORM_ROWS count; timed in bf16 at NORM_TIMED as a replayed
    graph (graph_ms: device time) and, above NORM_GRAPH_ROWS rows, also
    eagerly (time_ms, which counts the wrapper's host time where it
    outlasts the L2 flush), each beside F.rms_norm timed the same ways
    and its bound, with the launch policy's (threads a row, vectors a
    thread, blocks) and the ptxas registers and spill of the
    instantiation.  Returns its kernels line entry: the 2048-row numbers,
    and every count under `by_rows`."""
    from skypilot_tpu_torch.ops import _kernels
    d, eps, seed = NORM_SHAPES[name]
    gen = torch.Generator(device='cuda').manual_seed(seed)
    sms = _kernels.sm_count(torch.device('cuda'))
    by_rows, err_max = {}, 0.0
    for dtype in (torch.float32, torch.bfloat16):
        for rows in NORM_ROWS:
            x = torch.randn(rows, d, generator=gen, device='cuda').to(dtype)
            w = (1 + 0.1 * torch.randn(d, generator=gen, device='cuda')
                 ).to(dtype)
            want = rmsnorm._rms_norm_plain(x, w, eps)
            err = check_close(f'{name} {dtype} rows={rows}',
                              rmsnorm.rms_norm(x, w, eps), want,
                              row_tol(want))
            if dtype != torch.bfloat16 or rows not in NORM_TIMED:
                continue
            err_max = max(err_max, err)
            tpr, nv, grid = rmsnorm._norm_launch(rows, d, 2, sms)
            b_ms, by = bound(2 * x.numel() * 2 + d * 2, 4 * x.numel(),
                             BF16_FLOPS)

            def kernel(x=x, w=w):
                return rmsnorm.rms_norm(x, w, eps)

            def lib(x=x, w=w):
                return torch.nn.functional.rms_norm(x, (d,), w, eps)

            def plain(x=x, w=w):
                return rmsnorm._rms_norm_plain(x, w, eps)

            row = by_rows[rows] = {
                'graph_ms': graph_ms(kernel),
                'library_graph_ms': graph_ms(lib),
                'plain_graph_ms': graph_ms(plain),
                'bound_ms': b_ms,
                'launch': {'threads_a_row': tpr, 'vectors_a_thread': nv,
                           'blocks': grid},
                **_ptxas_of(ptxas, rf'rmsnorm_kernelI13__nv_bfloat16Li{nv}E'),
                'max_abs_err': err}
            row['bound_share'] = b_ms / row['graph_ms']
            if rows > NORM_GRAPH_ROWS:
                row.update(ms=time_ms(kernel), library_ms=time_ms(lib))
            log(f'  {name} bf16 ({rows}, {d}) [{tpr} x {nv}, {grid} blocks]: '
                f'graph {row["graph_ms"]:.4f} ms, F.rms_norm '
                f'{row["library_graph_ms"]:.4f}, plain '
                f'{row["plain_graph_ms"]:.4f}; eager '
                f'{row.get("ms", float("nan")):.4f}, F.rms_norm '
                f'{row.get("library_ms", float("nan")):.4f}; bound '
                f'{b_ms:.4f} ({b_ms / row["graph_ms"]:.0%} in the graph)')
    x = torch.randn(2048, d, generator=gen, device='cuda').bfloat16()
    w = (1 + 0.1 * torch.randn(d, generator=gen, device='cuda')).bfloat16()
    main = by_rows[2048]
    return {
        'name': name, 'route': 'cuda',
        'source': 'skypilot_tpu_torch/csrc/rmsnorm.cu',
        'replaces': 'skypilot_tpu/ops/rmsnorm.py:31',
        'shape': f'x (2048, {d}) bf16 eps {eps:g}',
        'max_abs_err': err_max, 'ms': main['ms'],
        'graph_ms': main['graph_ms'],
        'plain_ms': time_ms(lambda: rmsnorm._rms_norm_plain(x, w, eps)),
        'bound_ms': main['bound_ms'], 'bound_by': 'bytes',
        'library_ms': main['library_ms'],
        'library_graph_ms': main['library_graph_ms'],
        'design': K3_DESIGN, 'by_rows': by_rows,
    }


K3_DESIGN = ('rows in registers (16-byte vectors, one read of x), w in '
             'registers once a block, a warp a row at 2048 rows, more '
             'threads a row at few rows (ops/rmsnorm.py _norm_launch)')


def _ptxas_of(ptxas, pattern):
    """The ptxas registers and spill of the one instantiation whose
    mangled name matches `pattern` (a regular expression); fails where
    the report names none or several."""
    found = [i for n, i in ptxas.items() if re.search(pattern, n)]
    if len(found) != 1:
        raise AssertionError(f'ptxas report has {len(found)} {pattern}')
    return {'ptxas_registers': found[0]['registers'],
            'ptxas_spill_bytes': found[0]['spill_bytes']}


def _tc_entry(ptxas, stem, design=None):
    """The design of a kernel (TC_DESIGN, the flash kernels', by default)
    and the ptxas registers and spill of its instantiation `stem` (a
    mangled-name fragment)."""
    return {'design': design or TC_DESIGN, **_ptxas_of(ptxas, stem)}


# Mangled-name patterns of the timed K1/K7 instantiations (bf16 q,
# head_dim 128, the 4-row block of group 4; the cache bf16 or int8, i.e.
# signed char 'a') and of the bf16 combine kernel.
DECODE_KERNELS = {
    ('pooled', 'bf16'): r'decode_kernelI13__nv_bfloat16S\w*?_Li128ELi4E\w*PooledRows',
    ('pooled', 'int8'): r'decode_kernelI13__nv_bfloat16aLi128ELi4E\w*PooledRows',
    ('contig', 'bf16'): r'decode_kernelI13__nv_bfloat16S\w*?_Li128ELi4E\w*ContigRows',
    ('contig', 'int8'): r'decode_kernelI13__nv_bfloat16aLi128ELi4E\w*ContigRows',
    'combine': r'decode_combine_kernelI13__nv_bfloat16E',
}


def _check_fwd(at, q, k, v, causal, tag, need_lse=False):
    """K2's o (and lse) against _flash_fwd_plain (o per row in bf16,
    row_tol; lse f32) and against _attention_plain (o at TOL) and
    _attention_lse_plain.  Returns the max abs error against
    _flash_fwd_plain, o and lse."""
    if need_lse:
        o, lse = at.flash_attention_fwd(q, k, v, causal, need_lse=True)
    else:
        o, lse = at.flash_attention(q, k, v, causal=causal), None
    want, want_lse = at._flash_fwd_plain(q, k, v, causal)
    err = check_close(f'flash_attention o {tag}', o, want, row_tol(want))
    check_close(f'flash_attention o vs _attention_plain {tag}', o,
                at._attention_plain(q, k, v, causal))
    if lse is not None:
        err = max(err, check_close(f'flash_attention lse {tag}', lse,
                                   want_lse))
        check_close(f'flash_attention lse vs _attention_lse_plain {tag}',
                    lse, at._attention_lse_plain(q, k, causal))
    return err, o, lse


def check_flash(attention, ptxas):
    gen = torch.Generator(device='cuda').manual_seed(4)
    heads, kv_heads, hd = 32, 8, 128
    result = None
    for dtype in (torch.float32, torch.bfloat16):
        for batch, seq, causal in ((4, 512, True), (1, 700, True),
                                   (1, 700, False), (2, 64, True),
                                   (2, 1, True), (2, 63, False),
                                   (2, 65, True), (2, 129, False)):
            q = torch.randn(batch, seq, heads, hd, generator=gen,
                            device='cuda').to(dtype)
            k = torch.randn(batch, seq, kv_heads, hd, generator=gen,
                            device='cuda').to(dtype)
            v = torch.randn(batch, seq, kv_heads, hd, generator=gen,
                            device='cuda').to(dtype)
            err, _, _ = _check_fwd(attention, q, k, v, causal,
                                   f'{dtype} B={batch} S={seq} '
                                   f'causal={causal}')
            if dtype == torch.bfloat16 and seq == 512:
                nbytes = (2 * q.numel() + k.numel() + v.numel()) * 2
                pairs = batch * heads * seq * (seq + 1) // 2
                flops = 4 * hd * pairs
                b_ms, by = bound(nbytes, flops, BF16_FLOPS)
                qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
                ms = time_ms(lambda: attention.flash_attention(q, k, v))
                result = dict({
                    'name': 'flash_attention', 'route': 'cuda',
                    'source': 'skypilot_tpu_torch/csrc/flash_fwd.cu',
                    'replaces': 'skypilot_tpu/ops/attention.py:120',
                    'shape': f'q ({batch}, {seq}, {heads}, {hd}) kv '
                             f'{kv_heads} causal bf16',
                    'max_abs_err': err, 'ms': ms,
                    'plain_ms': time_ms(
                        lambda: attention._flash_fwd_plain(q, k, v)),
                    'bound_ms': b_ms, 'bound_by': by,
                    'library_ms': time_ms(
                        lambda: sdpa(qt, kt, vt, is_causal=True)),
                    'tflops': flops / ms / 1e9,
                }, **_tc_entry(ptxas, *TC_KERNELS['lse', 128]))
    # Without its lse at the shapes of phase 15's new callers: encode's
    # (15c: 8 rows of the 1024 bucket) and eval_ppl's (15e: 4 windows of
    # 2048).
    for batch, seq in ((8, 1024), (4, 2048)):
        q, k, v = (torch.randn(batch, seq, h, hd, generator=gen,
                               device='cuda').to(torch.bfloat16)
                   for h in (heads, kv_heads, kv_heads))
        _check_fwd(attention, q, k, v, True,
                   f'bf16 B={batch} S={seq} causal=True (phase 15)')
    return result


# K2 at the prefill shapes of phase 12 (phase 5's prefill chunk of 512
# rows over 4 requests), name -> ((B, S, H, KV, head_dim), the (H, KV) of
# its ragged checks, seed).  Gemma-7B: 16 heads of 256, MHA, on the
# tensor-core route that bf16 at head_dim 256 takes (one m16 tile a warp,
# 32-key tiles).  Qwen2.5-1.5B: 12 query heads over 2 KV heads of 128
# (G 6).
FLASH_SHAPES = {
    'flash_attention[Gemma-7B hd256]': ((4, 512, 16, 16, 256), (4, 2), 11),
    'flash_attention[Qwen2.5-1.5B G6 prefill]': ((4, 512, 12, 2, 128),
                                                 (12, 2), 16),
    # Phase 16's prefill on one rank: LLAMA3_8B at tp 2 (16 q heads over
    # 4 KV), LLAMA3_70B at tp 4 (16 over 2), Qwen2.5-1.5B at tp 4 (3
    # over 1: the overshard).
    'flash_attention[LLAMA3_8B tp2 rank prefill]': ((4, 512, 16, 4, 128),
                                                    (16, 4), 21),
    'flash_attention[LLAMA3_70B tp4 rank prefill]': ((4, 512, 16, 2, 128),
                                                     (16, 2), 22),
    'flash_attention[Qwen2.5-1.5B tp4 rank prefill]': ((4, 512, 3, 1, 128),
                                                       (3, 1), 23),
    # Phase 19's prefill at LLAMA3_8B: admission groups of 2 prompts in
    # the 128-token bucket.
    'flash_attention[LLAMA3_8B fleet prefill]': ((2, 128, 32, 8, 128),
                                                 (32, 8), 27),
}
TC_DESIGN_HD256 = ('mma.sync m16n8k16 bf16 -> f32, ldmatrix, cp.async x2; '
                   'one m16 tile a warp, 64-row q-tiles, 32-key tiles, two '
                   'blocks an SM')


def check_flash_at(attention, ptxas, name):
    """K2 at FLASH_SHAPES[name]: against its plain versions in f32 and
    bf16 at a ragged S, with and without the lse, then at the shape
    itself in bf16, checked, timed without and with its lse (eagerly and
    as a replayed graph: device time without the wrapper's host work)
    beside its bound and SDPA's; fails unless every bf16 launch at the
    shape takes the tensor-core route.  Returns its kernels line entry, with the
    design and the ptxas registers and spill of the instantiation."""
    at = attention
    (batch, seq, heads, kv, hd), ragged, seed = FLASH_SHAPES[name]
    gen = torch.Generator(device='cuda').manual_seed(seed)
    for dtype in (torch.float32, torch.bfloat16):
        for b, s, causal in ((1, 700, True), (2, 65, False)):
            q, k, v = _attn_operands(gen, b, s, *ragged, hd, dtype)[:3]
            for need_lse in (False, True):
                _check_fwd(at, q, k, v, causal,
                           f'{dtype} B={b} S={s} H={ragged[0]}/{ragged[1]} '
                           f'hd={hd} causal={causal} lse={need_lse}',
                           need_lse)
    q, k, v = _attn_operands(gen, batch, seq, heads, kv, hd,
                             torch.bfloat16)[:3]
    tc0 = at.flash_attention.launches_tc
    err, _, _ = _check_fwd(at, q, k, v, True, f'bf16 {name}')
    err_lse, _, _ = _check_fwd(at, q, k, v, True, f'bf16 {name} lse', True)
    tc = at.flash_attention.launches_tc - tc0
    if tc != 2:
        raise AssertionError(f'{name}: {tc} tensor-core launches of 2')
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * 2
    flops = 4 * hd * batch * heads * seq * (seq + 1) // 2
    b_ms, by = bound(nbytes, flops, BF16_FLOPS)
    lse_b_ms, _ = bound(nbytes + batch * heads * seq * 4, flops, BF16_FLOPS)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))

    def kernel():
        return at.flash_attention(q, k, v)

    def with_lse():
        return at.flash_attention_fwd(q, k, v, True, True)

    def lib():
        return sdpa(qt, kt, vt, is_causal=True)

    ms, lse_ms = time_ms(kernel), time_ms(with_lse)
    entry = {
        'name': name, 'route': 'cuda',
        'source': 'skypilot_tpu_torch/csrc/flash_fwd.cu',
        'replaces': 'skypilot_tpu/ops/attention.py:120',
        'shape': f'q ({batch}, {seq}, {heads}, {hd}) kv {kv} causal bf16',
        'max_abs_err': err, 'ms': ms, 'graph_ms': graph_ms(kernel),
        'plain_ms': time_ms(lambda: at._flash_fwd_plain(q, k, v)),
        'bound_ms': b_ms, 'bound_by': by,
        'library_ms': time_ms(lib), 'library_graph_ms': graph_ms(lib),
        'tflops': flops / ms / 1e9,
        'lse': {'ms': lse_ms, 'graph_ms': graph_ms(with_lse),
                'bound_ms': lse_b_ms, 'max_abs_err': err_lse},
        **_tc_entry(ptxas, f'flash_fwd_mma_kernelILi{hd}E',
                    TC_DESIGN_HD256 if hd == 256 else None),
    }
    entry['graph_tflops'] = flops / entry['graph_ms'] / 1e9
    log(f'  {name}: {ms:.4f} ms, graph {entry["graph_ms"]:.4f} ms '
        f'({entry["graph_tflops"]:.1f} TFLOP/s); with lse {lse_ms:.4f}, '
        f'graph {entry["lse"]["graph_ms"]:.4f}; bound {b_ms:.4f} by {by}, '
        f'plain {entry["plain_ms"]:.3f}, SDPA {entry["library_ms"]:.4f}, '
        f'graph {entry["library_graph_ms"]:.4f}; ptxas '
        f'{entry["ptxas_registers"]} registers, '
        f'{entry["ptxas_spill_bytes"]} bytes spilled')
    return entry


# Attention shapes of the train paths: (B, S, H, KV, head_dim), and the
# suffix of their kernels line names: LLAMA_1B, the 8B trunk, and 12b's
# LoRA-SFT of Qwen2.5-1.5B (12 query heads over 2 KV heads, G 6); then
# phase 17's per-rank shapes: LLAMA_1B at fsdp 2 x tp 2 (batch 4 over 2
# data shards, 8 of 16 heads over 4 of 8 KV heads), the 8B trunk at
# fsdp 4 (batch 4 x 2048 over 4 shards), train_moe's 'small' model at ep
# 4 (the batch is not split over ep) and at ep 2 x dp 2; then phase 18's:
# a pipeline stage's microbatch of 18a (LLAMA_1B, 8 rows over dp 2 in 4
# microbatches) and 18d's LoRA-SFT rank at LLAMA3_8B's widths (2 rows
# over fsdp 2, 16 of 32 heads over 4 of 8 KV heads); then phase 22's
# Gemma-7B at its training shape (1 x 4096, 16 heads of 256, MHA).
TRAIN_SHAPES = {'1b': (8, 1024, 16, 8, 128), '8b': (2, 4096, 32, 8, 128),
                'qwen': (2, 2048, 12, 2, 128),
                '1b rank': (2, 1024, 8, 4, 128),
                '8b rank': (1, 2048, 32, 8, 128),
                'moe ep4 rank': (4, 2048, 8, 4, 128),
                'moe ep2 dp2 rank': (2, 2048, 8, 4, 128),
                '1b pp mb': (1, 1024, 16, 8, 128),
                '8b lora rank': (1, 2048, 16, 4, 128),
                'gemma': (1, 4096, 16, 16, 256)}
TRAIN_SUFFIX = {'1b': '', '8b': '[8B trunk]', 'qwen': '[Qwen2.5-1.5B G6]',
                '1b pp mb': '[LLAMA_1B pp2 x dp2 microbatch]',
                '8b lora rank': '[8B widths LoRA fsdp2 x tp2 rank]',
                '1b rank': '[LLAMA_1B fsdp2 x tp2 rank]',
                '8b rank': '[8B trunk fsdp4 rank]',
                'moe ep4 rank': '[MoE small ep4 rank]',
                'moe ep2 dp2 rank': '[MoE small ep2 x dp2 rank]',
                'gemma': '[Gemma-7B hd256]'}


def _attn_operands(gen, batch, seq, heads, kv, hd, dtype):
    """q, k, v and an incoming gradient do, (B, S, H or KV, hd)."""
    return [torch.randn(batch, seq, h, hd, generator=gen,
                        device='cuda').to(dtype)
            for h in (heads, kv, kv, heads)]


def _check_train_kernels(at, q, k, v, do, causal, tag):
    """K2 with its lse (_check_fwd), K5 and K6 against their plain
    versions on the same inputs (o and lse from the kernel feed both
    backward sides).
    Returns the max abs errors by kernel (K2's over o and lse) and the
    kernels' outputs."""
    e_lse, o, lse = _check_fwd(at, q, k, v, causal, tag, need_lse=True)
    delta = at._delta(o, do).contiguous()
    want = at._flash_attention_dq_plain(q, k, v, do, lse, delta, causal)
    e_dq = check_close(
        f'flash_attention_dq {tag}',
        at.flash_attention_dq(q, k, v, do, lse, delta, causal), want,
        row_tol(want))
    del want
    got = at.flash_attention_dkv(q, k, v, do, lse, delta, causal)
    want = at._flash_attention_dkv_plain(q, k, v, do, lse, delta, causal)
    e_dkv = max(check_close(f'flash_attention_dkv {n} {tag}', g, w,
                            row_tol(w))
                for n, g, w in zip(('dk', 'dv'), got, want))
    return {'lse': e_lse, 'dq': e_dq, 'dkv': e_dkv}, o, lse, delta


# The bf16 tensor-core route of K2, K5 and K6 (timed below): the
# mangled-name stem of each instantiation in the ptxas report and its
# design, by (kernel, head_dim).
TC_DESIGN = 'mma.sync m16n8k16 bf16 -> f32, ldmatrix, cp.async x2'
TC_KERNELS = {
    ('lse', 128): ('flash_fwd_mma_kernelILi128E', TC_DESIGN),
    ('dq', 128): ('flash_bwd_dq_mma_kernelILi128E', TC_DESIGN),
    ('dkv', 128): ('flash_bwd_dkv_mma_kernelILi128E', TC_DESIGN),
    ('lse', 256): ('flash_fwd_mma_kernelILi256E', TC_DESIGN_HD256),
    ('dq', 256): ('flash_bwd_dq_mma_kernelILi256E',
                  TC_DESIGN + '; 8 warps of one m16 tile, 128-row q-tiles, '
                  '32-key tiles, one block an SM'),
    ('dkv', 256): ('flash_bwd_dkv_pair_mma_kernelILi256E',
                   TC_DESIGN + '; dk and dv split over 4 warp pairs of 16 '
                   'keys (p^T handed lane to lane through shared memory), '
                   '64-key blocks, 32-column passes, one block an SM'),
}


def check_flash_train(attention, ptxas):
    """K2 with its lse, K5 and K6 against their plain versions in f32
    and bf16 at the LLAMA_1B shape, a ragged S and a ragged S at G 6,
    and at head_dim 256 at a ragged S at G 8 and G 1; then, in bf16 and
    causal at every TRAIN_SHAPES shape, checked again and timed.  Returns the
    kernels line entries by (kernel, shape), each with the error measured
    at its own shape, its TFLOP/s, the design and the ptxas registers and
    spill of the instantiation timed."""
    at = attention
    gen = torch.Generator(device='cuda').manual_seed(7)
    for dtype in (torch.float32, torch.bfloat16):
        for batch, seq, heads, kv, hd, causal in (
                (8, 1024, 16, 8, 128, True), (2, 700, 16, 8, 128, True),
                (2, 700, 16, 8, 128, False), (2, 700, 12, 2, 128, True),
                # Gemma's head_dim: Gemma-2B's 8 query heads over 1 KV
                # head (G 8) and MHA (Gemma-7B's group).
                (2, 700, 8, 1, 256, True), (2, 700, 8, 1, 256, False),
                (2, 700, 4, 4, 256, True)):
            q, k, v, do = _attn_operands(gen, batch, seq, heads, kv, hd,
                                         dtype)
            _check_train_kernels(at, q, k, v, do, causal,
                                 f'{dtype} B={batch} S={seq} H={heads}/{kv} '
                                 f'hd={hd} causal={causal}')
            del q, k, v, do
    results = {}
    for key, (batch, seq, heads, kv, hd) in TRAIN_SHAPES.items():
        q, k, v, do = _attn_operands(gen, batch, seq, heads, kv, hd,
                                     torch.bfloat16)
        # At the 8B shape the plain versions hold several (2, 32, 4096,
        # 4096) f32 tensors, 4.3 GB each: they fit on the card at B 2.
        errs, o, lse, delta = _check_train_kernels(
            at, q, k, v, do, True,
            f'torch.bfloat16 B={batch} S={seq} H={heads} causal=True')
        pairs = batch * heads * seq * (seq + 1) // 2
        qb, kb, sb = q.numel() * 2, k.numel() * 2, lse.numel() * 4
        # Fewer repetitions of the plain versions at the 8B shape.
        plain_reps = 3 if seq > 2048 else TIMING_REPS
        shape = (f'q ({batch}, {seq}, {heads}, {hd}) kv {kv} causal bf16')
        qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_()
                      for t in (q, k, v))

        def lib_fwd():
            with torch.enable_grad():
                return sdpa(qt, kt, vt, is_causal=True)

        lib_out = lib_fwd()
        lib_do = do.transpose(1, 2)
        lib_bwd_ms = time_ms(lambda: torch.autograd.grad(
            lib_out, (qt, kt, vt), lib_do, retain_graph=True))
        rows = {
            'lse': ('flash_attention[lse]', 'flash_fwd.cu',
                    'skypilot_tpu/ops/attention.py:120',
                    lambda: at.flash_attention_fwd(q, k, v, True, True),
                    lambda: at._flash_fwd_plain(q, k, v, True),
                    2 * qb + 2 * kb + sb, 4 * hd * pairs, time_ms(lib_fwd)),
            'dq': ('flash_attention_dq', 'flash_bwd.cu',
                   'skypilot_tpu/ops/attention.py:257',
                   lambda: at.flash_attention_dq(q, k, v, do, lse, delta),
                   lambda: at._flash_attention_dq_plain(q, k, v, do, lse,
                                                        delta),
                   3 * qb + 2 * kb + 2 * sb, 6 * hd * pairs, lib_bwd_ms),
            'dkv': ('flash_attention_dkv', 'flash_bwd.cu',
                    'skypilot_tpu/ops/attention.py:279',
                    lambda: at.flash_attention_dkv(q, k, v, do, lse, delta),
                    lambda: at._flash_attention_dkv_plain(q, k, v, do, lse,
                                                          delta),
                    2 * qb + 4 * kb + 2 * sb, 8 * hd * pairs, lib_bwd_ms),
        }
        for kernel, (name, src, replaces, fn, plain, nbytes, flops,
                     lib_ms) in rows.items():
            b_ms, by = bound(nbytes, flops, BF16_FLOPS)
            ms = time_ms(fn)
            results[kernel, key] = {
                'name': name + TRAIN_SUFFIX[key],
                'route': 'cuda', 'source': f'skypilot_tpu_torch/csrc/{src}',
                'replaces': replaces, 'shape': shape,
                'max_abs_err': errs[kernel], 'ms': ms,
                'plain_ms': time_ms(plain, plain_reps), 'bound_ms': b_ms,
                'bound_by': by, 'library_ms': lib_ms,
                'tflops': flops / ms / 1e9,
            }
            results[kernel, key].update(_tc_entry(ptxas,
                                                  *TC_KERNELS[kernel, hd]))
            log(f'  {results[kernel, key]["name"]} {shape}: {ms:.3f} ms, '
                f'{flops / ms / 1e9:.1f} TFLOP/s (plain '
                f'{results[kernel, key]["plain_ms"]:.3f}, library '
                f'{lib_ms:.3f}, bound {b_ms:.4f} by {by})')
        del q, k, v, do, o, lse, delta, qt, kt, vt, lib_out, lib_do, rows
        torch.cuda.empty_cache()
    return results


def _tables(last_rows, n_blocks, seed, t_width=T_WIDTH):
    """Scattered block tables covering each slot's rows 0..last_rows[b]
    (capped at the table), drawn from blocks 1.. of the arena."""
    rng = np.random.RandomState(seed)
    perm = rng.permutation(np.arange(1, n_blocks))
    tables = np.zeros((len(last_rows), t_width), np.int32)
    for b, last in enumerate(last_rows):
        live = min(int(last) // BS + 1, t_width)
        tables[b, :live] = perm[b * t_width:b * t_width + live]
    return torch.as_tensor(tables, device='cuda')


def _arena(gen, dtype, n_blocks, int8, kv_heads=KV_HEADS, head_dim=HEAD_DIM):
    """A 2-layer (L, NB, BS, KV, hd) K/V arena, int8 with f32 scales when
    int8 (quantized from `dtype` values)."""
    from skypilot_tpu_torch.infer import llama_infer
    shape = (2, n_blocks, BS, kv_heads, head_dim)
    k = torch.randn(shape, generator=gen, device='cuda').to(dtype)
    v = torch.randn(shape, generator=gen, device='cuda').to(dtype)
    if not int8:
        return k, v, None, None
    (k8, ks), (v8, vs) = (llama_infer._quantize_kv(x) for x in (k, v))
    return k8, v8, ks, vs


def _poison(k, v, tables, last_rows, layer):
    """Copies of the arena with every block no table maps, and every row
    past each slot's last visible row, set to huge values."""
    value = 127 if k.dtype == torch.int8 else 1e4
    k2, v2 = k.clone(), v.clone()
    mapped = set(tables.flatten().tolist()) - {0}
    for blk in range(k.shape[1]):
        if blk not in mapped:
            k2[:, blk] = value
            v2[:, blk] = -value
    for b, last in enumerate(last_rows):
        if last < tables.shape[1] * BS - 1:
            blk = int(tables[b, last // BS])
            k2[layer, blk, last % BS + 1:] = value
            v2[layer, blk, last % BS + 1:] = -value
    return k2, v2


def _kv_bytes(keys, k):
    """Bytes of `keys` K and V rows of all KV heads (plus their f32
    scales for an int8 arena); k is (..., KV, hd)."""
    kv_heads, head_dim = k.shape[-2:]
    per_row = kv_heads * head_dim * k.element_size()
    if k.dtype == torch.int8:
        per_row += kv_heads * 4
    return 2 * keys * per_row


def _gathered(k, v, ks, vs, tables, layer, dtype):
    """(B, KV, S, hd) views of one layer through the tables in `dtype`
    (int8 dequantized): the library call's operands."""
    from skypilot_tpu_torch.ops import decode_attention as da
    k_g = da._gather_layer(k, tables, layer)
    v_g = da._gather_layer(v, tables, layer)
    if ks is not None:
        k_g = da._dequantize(k_g, da._gather_layer(ks, tables, layer), dtype)
        v_g = da._dequantize(v_g, da._gather_layer(vs, tables, layer), dtype)
    return k_g.transpose(1, 2), v_g.transpose(1, 2)


def _split_of(da, batch, capacity, kv_heads=KV_HEADS):
    """(splits, split_len) of a K1/K7 launch."""
    from skypilot_tpu_torch.ops import _kernels
    return da._decode_splits(batch, kv_heads, capacity, da._DECODE_CHUNK,
                             _kernels.sm_count(torch.device('cuda')))


def check_decode(decode_attention, ptxas):
    """K1 in f32, bf16 and on an int8 arena (bf16 q), then the combine
    pass alone on the partials of the bf16 launch, then K1 bf16 with one
    slot at position 8191; returns the kernels line entries of the bf16
    and int8 variants (the long-context row nested in the bf16 one) and
    of the combine."""
    da = decode_attention
    gen = torch.Generator(device='cuda').manual_seed(5)
    batch, layer = 8, 1
    n_blocks = 1 + batch * T_WIDTH
    capacity = T_WIDTH * BS
    # Mixed positions: 0, block edges (BS-1, BS), mid, and the table end.
    positions = torch.tensor([0, BS - 1, BS, 2 * BS + 5, 700, 1000,
                              1500, T_WIDTH * BS - 1], dtype=torch.int32,
                             device='cuda')
    last = positions.tolist()
    tables = _tables(last, n_blocks, 5)
    splits, split_len = _split_of(da, batch, capacity)
    results = {}
    for label, dtype, int8 in (('f32', torch.float32, False),
                               ('bf16', torch.bfloat16, False),
                               ('int8', torch.bfloat16, True)):
        q = torch.randn(batch, KV_HEADS, GROUP, HEAD_DIM, generator=gen,
                        device='cuda').to(dtype)
        k, v, ks, vs = _arena(gen, dtype, n_blocks, int8)

        def kernel(k=k, v=v):
            return da.decode_attention_pooled(
                q, k, v, tables, layer, positions, ks, vs)

        def plain():
            return da._decode_attention_plain(
                q, k, v, tables, layer, positions, ks, vs)

        out = kernel()
        err = check_close(f'decode_attention_pooled {label}', out, plain())
        if not torch.equal(kernel(), out):
            raise AssertionError(f'decode_attention_pooled {label}: two '
                                 f'calls differ')
        k2, v2 = _poison(k, v, tables, last, layer)
        if not torch.equal(kernel(k2, v2), out):
            raise AssertionError(f'decode_attention_pooled {label} read '
                                 f'keys past a position or outside its '
                                 f'table')
        del k2, v2
        if label == 'f32':
            continue
        if label == 'bf16':
            results['combine'] = _check_combine(
                da, q, k, v, tables, layer, positions, capacity, out, ptxas)
        live_keys = int(torch.clamp_max(positions.long() + 1,
                                        capacity).sum())
        nbytes = (2 * q.numel() * 2 + _kv_bytes(live_keys, k)
                  + tables.numel() * 4 + batch * 4)
        b_ms, by = bound(nbytes, 4 * HEAD_DIM * KV_HEADS * GROUP * live_keys,
                         BF16_FLOPS)
        kt, vt = _gathered(k, v, ks, vs, tables, layer, dtype)
        qs = q.reshape(batch, KV_HEADS * GROUP, 1, HEAD_DIM)
        mask = (torch.arange(kt.shape[2], device='cuda')[None, :]
                <= positions.long()[:, None])[:, None, None, :]
        results[label] = {
            'name': 'decode_attention_pooled'
                    + ('' if label == 'bf16' else '[int8]'),
            'route': 'cuda',
            'source': 'skypilot_tpu_torch/csrc/paged_decode.cu',
            'replaces': 'skypilot_tpu/ops/decode_attention.py:356',
            'shape': f'q ({batch}, {KV_HEADS}, {GROUP}, {HEAD_DIM}) bf16, '
                     f'{"int8" if int8 else "bf16"} arena, BS {BS} '
                     f'T {T_WIDTH}, live keys {live_keys}',
            'splits': splits, 'split_len': split_len,
            'max_abs_err': err, 'ms': time_ms(kernel),
            'graph_ms': graph_ms(kernel),
            'plain_ms': time_ms(plain), 'bound_ms': b_ms, 'bound_by': by,
            'library_ms': time_ms(lambda: sdpa(qs, kt, vt, attn_mask=mask)),
            'library_graph_ms': graph_ms(
                lambda: sdpa(qs, kt, vt, attn_mask=mask)),
            **_ptxas_of(ptxas, DECODE_KERNELS['pooled', label]),
        }
    results['bf16']['long_context'] = check_decode_long(da)
    return results


def _check_combine(da, q, k, v, tables, layer, positions, capacity, out,
                   ptxas, name='decode_combine'):
    """The combine kernel alone on the partials that K1's bf16 launch
    left in its scratch, against _combine_splits_plain (per row: both sum
    the same f32 terms in f32) and bitwise against the launch's own
    output; returns its kernels line entry, named `name`."""
    batch, kv_heads, group, head_dim = q.shape
    _, scratch, split_len = da._decode_attention_cuda(
        q, k, v, tables, layer, positions, None, None)
    if scratch is None:
        raise AssertionError(f'decode_attention_pooled: {name}\'s shape '
                             f'did not take the split route')
    acc, ml = da._split_partials(q, scratch)
    live = da._live_splits(positions, capacity, split_len)

    def kernel():
        return da._decode_combine_cuda(acc, ml, positions, capacity,
                                       split_len, q.dtype)

    def plain():
        return da._combine_splits_plain(ml[..., 0], ml[..., 1], acc,
                                        live).to(q.dtype)

    got, want = kernel(), plain()
    err = check_close(f'{name} bf16', got, want, row_tol(want))
    if not torch.equal(got, out):
        raise AssertionError(f'{name}: not the split launch\'s output')
    parts = int(live.sum()) * kv_heads * group
    nbytes = parts * (head_dim + 2) * 4 + got.numel() * 2 + batch * 4
    b_ms, by = bound(nbytes, parts * head_dim * 2, BF16_FLOPS)
    return {
        'name': name, 'route': 'cuda',
        'source': 'skypilot_tpu_torch/csrc/paged_decode.cu',
        'replaces': 'skypilot_tpu/ops/decode_attention.py:356',
        'shape': f'partials of K1 bf16: {acc.shape[2]} splits of '
                 f'{split_len} keys, {int(live.sum())} live over {batch} '
                 f'slots, KV {kv_heads}, G {group}, hd {head_dim}',
        'max_abs_err': err, 'ms': time_ms(kernel),
        'graph_ms': graph_ms(kernel), 'plain_ms': time_ms(plain),
        'bound_ms': b_ms, 'bound_by': by, 'library_ms': None,
        **_ptxas_of(ptxas, DECODE_KERNELS['combine']),
    }


# K1 over a whole LLAMA3_8B context: one slot at position 8191 (the
# 8192-token max_seq_len in 64-row blocks).
LONG_T_WIDTH = 8192 // BS


def check_decode_long(da):
    """K1 bf16, one slot at position 8191 (T 128): against its plain
    version, on a poisoned arena, timed with its bound and SDPA's."""
    gen = torch.Generator(device='cuda').manual_seed(9)
    layer, n_blocks = 1, 1 + LONG_T_WIDTH
    capacity = LONG_T_WIDTH * BS
    positions = torch.tensor([capacity - 1], dtype=torch.int32,
                             device='cuda')
    tables = _tables([capacity - 1], n_blocks, 9, LONG_T_WIDTH)
    q = torch.randn(1, KV_HEADS, GROUP, HEAD_DIM, generator=gen,
                    device='cuda').to(torch.bfloat16)
    k, v, _, _ = _arena(gen, torch.bfloat16, n_blocks, False)

    def kernel(k=k, v=v):
        return da.decode_attention_pooled(q, k, v, tables, layer, positions)

    def plain():
        return da._decode_attention_plain(q, k, v, tables, layer, positions)

    out = kernel()
    err = check_close('decode_attention_pooled bf16 position 8191', out,
                      plain())
    k2, v2 = _poison(k, v, tables, [capacity - 1], layer)
    if not torch.equal(kernel(k2, v2), out):
        raise AssertionError('decode_attention_pooled at position 8191 read '
                             'outside its table')
    del k2, v2
    splits, split_len = _split_of(da, 1, capacity)
    nbytes = 2 * q.numel() * 2 + _kv_bytes(capacity, k) + tables.numel() * 4 + 4
    b_ms, by = bound(nbytes, 4 * HEAD_DIM * KV_HEADS * GROUP * capacity,
                     BF16_FLOPS)
    kt, vt = _gathered(k, v, None, None, tables, layer, torch.bfloat16)
    qs = q.reshape(1, KV_HEADS * GROUP, 1, HEAD_DIM)
    return {
        'shape': f'q (1, {KV_HEADS}, {GROUP}, {HEAD_DIM}) bf16, bf16 arena, '
                 f'BS {BS} T {LONG_T_WIDTH}, position {capacity - 1}, '
                 f'{capacity} keys',
        'splits': splits, 'split_len': split_len,
        'max_abs_err': err, 'ms': time_ms(kernel),
        'graph_ms': graph_ms(kernel), 'plain_ms': time_ms(plain),
        'bound_ms': b_ms, 'bound_by': by,
        'library_ms': time_ms(lambda: sdpa(qs, kt, vt)),
        'library_graph_ms': graph_ms(lambda: sdpa(qs, kt, vt)),
    }


# K1 at the decode shapes of the serving and rollout paths beyond phase
# 5's: name -> (KV heads, group, head_dim, table width, positions).
#   G2: phase 10c's GRPO rollouts, LLAMA_1B (16 query heads over 8 KV
#     heads), the Generator's 8 slots over an arena of 128 rows (prompt
#     64 + 32 new tokens + 1, to a power of two): the rollouts' positions
#     (2..35), a full 64-token prompt's (64..97), block edges, the end.
#   Gemma-7B (12a): 16 KV heads of 256 (MHA, G 1), 8 slots of 2,048 rows;
#   Qwen2.5-1.5B (12b): 12 query heads over 2 KV heads of 128 (G 6).
# The positions of 12a/12b are those of phase 5's requests mid-decode.
SERVE_POSITIONS = [17 + 20, 60 + 20, 128 + 20, 250 + 20, 300 + 20,
                   450 + 20, 600 + 20, 700 + 20]
DECODE_SHAPES = {
    'G2': (8, 2, 128, 2, [2, 35, BS - 1, BS, BS + 2, 80, 97, 2 * BS - 1]),
    'Gemma-7B': (16, 1, 256, 32, SERVE_POSITIONS),
    'Qwen2.5-1.5B': (2, 6, 128, 32, SERVE_POSITIONS),
    # Phase 16's decode on one rank (its KV heads and their groups).
    'LLAMA3_8B tp2 rank': (4, 4, 128, 32, SERVE_POSITIONS),
    'LLAMA3_70B tp4 rank': (2, 8, 128, 32, SERVE_POSITIONS),
    'Qwen2.5-1.5B tp4 rank': (1, 3, 128, 32, SERVE_POSITIONS),
    # Phase 19's replicas at LLAMA3_8B: 2 slots (the serve, chaos and
    # autoscaler arms' batch_size) over a 256-row table (max_seq_len
    # 256), mid-decode after 64-token heads and their tails.
    'LLAMA3_8B fleet': (8, 4, 128, 4, [97, 150]),
}
# Phase 16b's K4 on one rank of LLAMA3_8B at tp 2: spec_k 4 verify
# windows and fuse_budget 64's lane.
TP_WINDOW_SHAPES = (('verify', [0, BS - 1, BS, 2 * BS + 5, 700, 1000, 1500,
                                T_WIDTH * BS - 1], 5), ('fused', [436], 64))


def check_decode_at(da, ptxas, label, seed, int8=False):
    """K1 (bf16 q; over an int8 arena with int8) at DECODE_SHAPES[label]
    against its plain version, twice bitwise, on a poisoned arena, timed
    with its bound and SDPA's (eager and as a replayed graph).  Returns
    its kernels line entry (the ptxas registers and spill of the
    instantiation: NG 4 rows a block for G <= 4, 8 above) and, over a
    bf16 arena, the combine's entry on that launch's partials
    (`decode_combine[<label>]`; None over int8: the combine is the same
    kernel)."""
    kv_heads, group, head_dim, t_width, last = DECODE_SHAPES[label]
    gen = torch.Generator(device='cuda').manual_seed(seed)
    batch, layer = len(last), 1
    n_blocks = 1 + batch * t_width
    capacity = t_width * BS
    positions = torch.tensor(last, dtype=torch.int32, device='cuda')
    tables = _tables(last, n_blocks, seed, t_width)
    splits, split_len = _split_of(da, batch, capacity, kv_heads)
    q = torch.randn(batch, kv_heads, group, head_dim, generator=gen,
                    device='cuda').to(torch.bfloat16)
    k, v, ks, vs = _arena(gen, torch.bfloat16, n_blocks, int8, kv_heads,
                          head_dim)
    name = f'{"int8 " if int8 else ""}{label}'

    def kernel(k=k, v=v):
        return da.decode_attention_pooled(q, k, v, tables, layer, positions,
                                          ks, vs)

    def plain():
        return da._decode_attention_plain(q, k, v, tables, layer, positions,
                                          ks, vs)

    out = kernel()
    err = check_close(f'decode_attention_pooled bf16 {name}', out, plain())
    if not torch.equal(kernel(), out):
        raise AssertionError(f'decode_attention_pooled {label}: two calls '
                             f'differ')
    k2, v2 = _poison(k, v, tables, last, layer)
    if not torch.equal(kernel(k2, v2), out):
        raise AssertionError(f'decode_attention_pooled {label} read keys '
                             f'past a position or outside its table')
    del k2, v2
    combine = None if int8 else _check_combine(
        da, q, k, v, tables, layer, positions, capacity, out, ptxas,
        name=f'decode_combine[{label}]')
    live_keys = int(torch.clamp_max(positions.long() + 1, capacity).sum())
    nbytes = (2 * q.numel() * 2 + _kv_bytes(live_keys, k)
              + tables.numel() * 4 + batch * 4)
    b_ms, by = bound(nbytes, 4 * head_dim * kv_heads * group * live_keys,
                     BF16_FLOPS)
    kt, vt = _gathered(k, v, ks, vs, tables, layer, torch.bfloat16)
    qs = q.reshape(batch, kv_heads * group, 1, head_dim)
    mask = (torch.arange(kt.shape[2], device='cuda')[None, :]
            <= positions.long()[:, None])[:, None, None, :]
    ng = 8 if group > 4 else 4
    entry = {
        'name': f'decode_attention_pooled[{name}]', 'route': 'cuda',
        'source': 'skypilot_tpu_torch/csrc/paged_decode.cu',
        'replaces': 'skypilot_tpu/ops/decode_attention.py:356',
        'shape': f'q ({batch}, {kv_heads}, {group}, {head_dim}) bf16, '
                 f'{"int8" if int8 else "bf16"} arena, BS {BS} T {t_width}, '
                 f'positions {last}, live keys {live_keys}',
        'splits': splits, 'split_len': split_len,
        'max_abs_err': err, 'ms': time_ms(kernel),
        'graph_ms': graph_ms(kernel),
        'plain_ms': time_ms(plain), 'bound_ms': b_ms, 'bound_by': by,
        'library_ms': time_ms(lambda: sdpa(qs, kt, vt, attn_mask=mask)),
        'library_graph_ms': graph_ms(
            lambda: sdpa(qs, kt, vt, attn_mask=mask)),
        **_ptxas_of(ptxas, (r'decode_kernelI13__nv_bfloat16a' if int8 else
                            r'decode_kernelI13__nv_bfloat16S\w*?_')
                    + rf'Li{head_dim}ELi{ng}E\w*PooledRows'),
    }
    log(f'  {entry["name"]}: {entry["ms"]:.4f} ms (graph '
        f'{entry["graph_ms"]:.4f}), bound {b_ms:.4f} by {by}, plain '
        f'{entry["plain_ms"]:.4f}, SDPA {entry["library_ms"]:.4f}')
    return entry, combine


# K1 at phase 14a's warm decode: 8 slots whose tables share the 16 blocks
# of one 1,024-token head (the prefix cache's splice), each with its own
# blocks for a 64-token tail and the tokens decoded so far.
SHARED_HEAD_BLOCKS = 1024 // BS
SHARED_POSITIONS = [1088 + d for d in (0, 6, 13, 19, 26, 32, 39, 47)]


def check_decode_shared(da, ptxas):
    """K1 in bf16 and over an int8 arena on tables in which every slot
    points at the same physical head blocks, against its plain version,
    twice bitwise, on a poisoned arena, timed with its bound (each
    shared byte counted once) and SDPA's over the gathered rows (eager
    and as a replayed graph).  Returns the kernels line entries
    'paged_decode[shared blocks]' and 'paged_decode[int8 shared
    blocks]'."""
    gen = torch.Generator(device='cuda').manual_seed(14)
    batch, layer = 8, 1
    last = SHARED_POSITIONS
    own = T_WIDTH - SHARED_HEAD_BLOCKS
    n_blocks = 1 + SHARED_HEAD_BLOCKS + batch * own
    perm = np.random.RandomState(14).permutation(np.arange(1, n_blocks))
    tables = np.zeros((batch, T_WIDTH), np.int32)
    for b, pos in enumerate(last):
        live = pos // BS + 1
        tables[b, :SHARED_HEAD_BLOCKS] = perm[:SHARED_HEAD_BLOCKS]
        lo = SHARED_HEAD_BLOCKS + b * own
        tables[b, SHARED_HEAD_BLOCKS:live] = perm[
            lo:lo + live - SHARED_HEAD_BLOCKS]
    tables = torch.as_tensor(tables, device='cuda')
    positions = torch.tensor(last, dtype=torch.int32, device='cuda')
    capacity = T_WIDTH * BS
    splits, split_len = _split_of(da, batch, capacity)
    live_keys = sum(p + 1 for p in last)
    unique_keys = SHARED_HEAD_BLOCKS * BS + sum(
        p + 1 - SHARED_HEAD_BLOCKS * BS for p in last)
    out_entries = {}
    for label, int8 in (('bf16', False), ('int8', True)):
        q = torch.randn(batch, KV_HEADS, GROUP, HEAD_DIM, generator=gen,
                        device='cuda').to(torch.bfloat16)
        k, v, ks, vs = _arena(gen, torch.bfloat16, n_blocks, int8)

        def kernel(k=k, v=v):
            return da.decode_attention_pooled(q, k, v, tables, layer,
                                              positions, ks, vs)

        def plain():
            return da._decode_attention_plain(q, k, v, tables, layer,
                                              positions, ks, vs)

        name = ('paged_decode[shared blocks]' if not int8
                else 'paged_decode[int8 shared blocks]')
        out = kernel()
        err = check_close(name, out, plain())
        if not torch.equal(kernel(), out):
            raise AssertionError(f'{name}: two calls differ')
        k2, v2 = _poison(k, v, tables, last, layer)
        if not torch.equal(kernel(k2, v2), out):
            raise AssertionError(f'{name} read keys past a position or '
                                 f'outside its table')
        del k2, v2
        nbytes = (2 * q.numel() * 2 + _kv_bytes(unique_keys, k)
                  + tables.numel() * 4 + batch * 4)
        b_ms, by = bound(nbytes, 4 * HEAD_DIM * KV_HEADS * GROUP * live_keys,
                         BF16_FLOPS)
        kt, vt = _gathered(k, v, ks, vs, tables, layer, torch.bfloat16)
        qs = q.reshape(batch, KV_HEADS * GROUP, 1, HEAD_DIM)
        mask = (torch.arange(kt.shape[2], device='cuda')[None, :]
                <= positions.long()[:, None])[:, None, None, :]
        entry = {
            'name': name, 'route': 'cuda',
            'source': 'skypilot_tpu_torch/csrc/paged_decode.cu',
            'replaces': 'skypilot_tpu/ops/decode_attention.py:356',
            'shape': f'q ({batch}, {KV_HEADS}, {GROUP}, {HEAD_DIM}) bf16, '
                     f'{"int8" if int8 else "bf16"} arena, BS {BS} '
                     f'T {T_WIDTH}, the {SHARED_HEAD_BLOCKS} head blocks '
                     f'shared by all {batch} slots, positions {last}, '
                     f'live keys {live_keys} ({unique_keys} distinct)',
            'splits': splits, 'split_len': split_len,
            'max_abs_err': err, 'ms': time_ms(kernel),
            'graph_ms': graph_ms(kernel),
            'plain_ms': time_ms(plain), 'bound_ms': b_ms, 'bound_by': by,
            'library_ms': time_ms(lambda: sdpa(qs, kt, vt, attn_mask=mask)),
            'library_graph_ms': graph_ms(
                lambda: sdpa(qs, kt, vt, attn_mask=mask)),
            **_ptxas_of(ptxas, DECODE_KERNELS['pooled', label]),
        }
        log(f'  {name}: {entry["ms"]:.4f} ms (graph '
            f'{entry["graph_ms"]:.4f}), bound {b_ms:.4f} by {by}, plain '
            f'{entry["plain_ms"]:.4f}, SDPA {entry["library_ms"]:.4f}')
        out_entries[label] = entry
        del k, v, ks, vs, kt, vt
    torch.cuda.empty_cache()
    return out_entries


# Mangled-name fragments of the timed K4 tensor-core instantiations by
# head_dim (the arena bf16 or int8, i.e. signed char 'a') and of its
# combine kernel, and the design of each.
WINDOW_KERNELS = {
    128: {'f32': 'paged_window_kernelIfLi128E',
          'bf16': 'paged_window_mma_kernelI13__nv_bfloat16Li128E',
          'int8': 'paged_window_mma_kernelIaLi128E',
          'combine': 'paged_window_combine_kernelILi128E'},
    256: {'bf16': 'paged_window_row16_mma_kernelI13__nv_bfloat16Li256E',
          'int8': 'paged_window_row16_mma_kernelIaLi256E',
          'combine': 'paged_window_combine_kernelILi256E'}}
_WINDOW_TC = ('mma.sync m16n8k16 bf16 -> f32, ldmatrix, cp.async x2, '
              '64-row tiles, split-KV + combine')
_WINDOW_TC256 = ('mma.sync m16n8k16 bf16 -> f32, ldmatrix, a 16-row tile '
                 'a block whose 4 warps divide the keys in 16-key chunks '
                 '(cp.async x3 a warp) and merge in shared memory, '
                 'split-KV + combine')
_WINDOW_COMBINE = 'a warp a row, its live splits in ascending order, f32'
WINDOW_DESIGN = {
    128: {'f32': ('f32 FMAs on the CUDA cores, a 128-thread block a (slot, '
                  'KV head, 16-row tile), key chunks staged in shared '
                  'memory, split-KV + combine'),
          'bf16': _WINDOW_TC,
          'int8': _WINDOW_TC + ', int8 -> bf16 in shared memory',
          'combine': _WINDOW_COMBINE},
    256: {'bf16': _WINDOW_TC256,
          'int8': _WINDOW_TC256 + ', int8 -> bf16 in shared memory',
          'combine': _WINDOW_COMBINE}}
# K4 at hd 256 (phase 12c's Gemma-7B: 16 KV heads, G 1; Gemma-2B's
# published MQA: 8 query heads over 1 KV head, G 8): (KV heads, group,
# tag) at phase 3's verify (spec_k 12) and fused-lane (fuse_budget 264)
# shapes.
WINDOW_HD256 = (('Gemma-7B', 16, 1), ('Gemma-2B MQA', 1, 8))


def check_window(decode_attention, ptxas, kv_heads=KV_HEADS, group=GROUP,
                 shapes=None, tag='', head_dim=HEAD_DIM,
                 timed=('bf16', 'int8')):
    """K4 at the verify shape (B 8, W 13) and the fused-lane shape (B 1,
    W 264 from row 436), in f32, bf16 and on an int8 arena (bf16 q):
    against the plain version, twice (bitwise), on poisoned arenas, and
    at W = 1 against K1; bf16 and int8 must take the tensor-core route
    and f32 the FMA route.  Then the combine pass alone on the partials
    of the verify bf16 launch.  Returns the kernels line entries of the
    `timed` variants (bf16 and int8 by default) and of the combine.
    kv_heads, group, head_dim, shapes ((lane, positions, W) pairs) and
    tag (appended to the entries' names) check another shape: phase
    16's per-rank one, Gemma's at hd 256, and phase 23's verify."""
    from skypilot_tpu_torch.ops import _kernels
    da = decode_attention
    counter = da.decode_window_attention_pooled
    gen = torch.Generator(device='cuda').manual_seed(6)
    layer = 1
    capacity = T_WIDTH * BS
    verify_pos = [0, BS - 1, BS, 2 * BS + 5, 700, 1000, 1500,
                  T_WIDTH * BS - 1]
    shapes = shapes or (('verify', verify_pos, 13), ('fused', [436], 264))
    results = {}
    for lane, pos_list, win in shapes:
        batch = len(pos_list)
        n_blocks = 1 + batch * T_WIDTH
        positions = torch.tensor(pos_list, dtype=torch.int32, device='cuda')
        last = [p + win - 1 for p in pos_list]
        tables = _tables(last, n_blocks, 6)
        splits, split_len = da._window_splits(
            batch, kv_heads, -(-win * group // da._WINDOW_ROWS[head_dim]),
            capacity, da._WINDOW_CHUNK,
            _kernels.sm_count(torch.device('cuda')))
        for label, dtype, int8 in (('f32', torch.float32, False),
                                   ('bf16', torch.bfloat16, False),
                                   ('int8', torch.bfloat16, True)):
            q = torch.randn(batch, win, kv_heads, group, head_dim,
                            generator=gen, device='cuda').to(dtype)
            k, v, ks, vs = _arena(gen, dtype, n_blocks, int8, kv_heads,
                                  head_dim)

            def kernel(k=k, v=v):
                return da.decode_window_attention_pooled(
                    q, k, v, tables, layer, positions, ks, vs)

            def plain():
                return da._decode_window_attention_plain(
                    q, k, v, tables, layer, positions, ks, vs)

            name = f'decode_window_attention_pooled {lane} {label}'
            name += f' {tag}' if tag else ''
            tc = counter.launches_tc
            out = kernel()
            if counter.launches_tc - tc != int(label != 'f32'):
                route = 'FMA' if label == 'f32' else 'tensor-core'
                raise AssertionError(f'{name}: not on the {route} route')
            err = check_close(name, out, plain())
            if not torch.equal(kernel(), out):
                raise AssertionError(f'{name}: two calls differ')
            k2, v2 = _poison(k, v, tables, last, layer)
            if not torch.equal(kernel(k2, v2), out):
                raise AssertionError(f'{name} read keys past its window '
                                     f'or outside its table')
            del k2, v2
            one = da.decode_window_attention_pooled(
                q[:, :1], k, v, tables, layer, positions, ks, vs)[:, 0]
            check_close(f'{name} W=1 vs K1', one, da.decode_attention_pooled(
                q[:, 0].contiguous(), k, v, tables, layer, positions, ks,
                vs))
            if label not in timed:
                continue
            if (lane, label) == ('verify', 'bf16'):
                results['combine'] = _check_window_combine(
                    da, q, k, v, tables, layer, positions, out, ptxas, tag)
            rows = torch.clamp_max(
                positions.long()[:, None] + torch.arange(win, device='cuda')
                + 1, capacity)                          # keys per row
            pairs = int(rows.sum()) * kv_heads * group
            keys = int(rows[:, -1].sum())
            nbytes = (2 * q.numel() * q.element_size() + _kv_bytes(keys, k)
                      + tables.numel() * 4 + batch * 4)
            b_ms, by = bound(nbytes, 4 * head_dim * pairs,
                             F32_FLOPS if label == 'f32' else BF16_FLOPS)
            kt, vt = _gathered(k, v, ks, vs, tables, layer, dtype)
            qs = q.permute(0, 2, 3, 1, 4).reshape(
                batch, kv_heads * group, win, head_dim)
            mask = (torch.arange(kt.shape[2], device='cuda')[None, None, :]
                    < rows[:, :, None])[:, None]        # (B, 1, W, S)
            # SDPA's row order is (KV, G, W); logged, not held to a bound.
            lib_out = sdpa(qs, kt, vt, attn_mask=mask)
            lib_err = (out.permute(0, 2, 3, 1, 4).reshape(lib_out.shape)
                       .float() - lib_out.float()).abs().max().item()
            log(f'  {name}: max_abs_err vs SDPA {lib_err:.3e}')
            q_name = 'f32' if label == 'f32' else 'bf16'
            suffix = lane if label == 'bf16' else f'{label} {lane}'
            suffix += f' {tag}' if tag else ''
            results[(lane, label)] = {
                'name': f'decode_window_attention_pooled[{suffix}]',
                'route': 'cuda',
                'source': 'skypilot_tpu_torch/csrc/paged_window.cu',
                'replaces': 'skypilot_tpu/ops/decode_attention.py:456',
                'shape': f'q ({batch}, {win}, {kv_heads}, {group}, '
                         f'{head_dim}) {q_name}, '
                         f'{"int8" if int8 else q_name} arena, BS {BS} '
                         f'T {T_WIDTH}, positions '
                         f'{pos_list if batch == 1 else f"{min(pos_list)}..{max(pos_list)}"}, '
                         f'{keys} keys',
                'splits': splits, 'split_len': split_len,
                'max_abs_err': err, 'ms': time_ms(kernel),
                'graph_ms': graph_ms(kernel),
                'plain_ms': time_ms(plain), 'bound_ms': b_ms,
                'bound_by': by,
                'library_ms': time_ms(
                    lambda: sdpa(qs, kt, vt, attn_mask=mask)),
                'library_graph_ms': graph_ms(
                    lambda: sdpa(qs, kt, vt, attn_mask=mask)),
                **_tc_entry(ptxas, WINDOW_KERNELS[head_dim][label],
                            WINDOW_DESIGN[head_dim][label]),
            }
            log(f'  {name}: {splits} splits of {split_len}, ms '
                f'{results[lane, label]["ms"]:.4f}, graph '
                f'{results[lane, label]["graph_ms"]:.4f}, library graph '
                f'{results[lane, label]["library_graph_ms"]:.4f}, bound '
                f'{b_ms:.4f} by {by}')
    return results


def _check_window_combine(da, q, k, v, tables, layer, positions, out,
                          ptxas, tag=''):
    """K4's combine kernel alone on the partials of the verify bf16
    launch, against _combine_splits_plain (per row: both sum the same f32
    terms in f32) and bitwise against the launch's own output; returns
    its kernels line entry."""
    batch, win, kv_heads, group, head_dim = q.shape
    capacity = tables.shape[1] * BS
    _, scratch, split_len = da._decode_window_attention_cuda(
        q, k, v, tables, layer, positions, None, None,
        da.decode_window_attention_pooled)
    if scratch is None:
        raise AssertionError('decode_window_attention_pooled: the verify '
                             'shape did not take the split route')
    acc, ml = da._split_partials(q, scratch)
    live = da._window_live_splits(positions, win, group, capacity,
                                  split_len)

    def kernel():
        return da._window_combine_cuda(acc, ml, positions, win, capacity,
                                       split_len)

    def plain():
        o = da._combine_splits_plain(ml[..., 0], ml[..., 1], acc, live)
        return o.reshape(batch, kv_heads, win, group, head_dim).permute(
            0, 2, 1, 3, 4).to(q.dtype)

    name = 'paged_window_combine' + (f'[{tag}]' if tag else '')
    got, want = kernel(), plain()
    err = check_close(f'{name} bf16', got, want, row_tol(want))
    if not torch.equal(got, out):
        raise AssertionError(f'{name}: not the split launch\'s output')
    parts = int(live.sum()) * kv_heads
    nbytes = parts * (head_dim + 2) * 4 + got.numel() * 2 + batch * 4
    b_ms, by = bound(nbytes, parts * head_dim * 2, BF16_FLOPS)
    return {
        'name': name,
        'route': 'cuda',
        'source': 'skypilot_tpu_torch/csrc/paged_window.cu',
        'replaces': 'skypilot_tpu/ops/decode_attention.py:456',
        'shape': f'partials of K4 verify bf16: {acc.shape[2]} splits of '
                 f'{split_len}, {int(live.sum())} live (row, split) pairs '
                 f'over {batch} slots x {win * group} rows, hd {head_dim}',
        'max_abs_err': err, 'ms': time_ms(kernel),
        'graph_ms': graph_ms(kernel), 'plain_ms': time_ms(plain),
        'bound_ms': b_ms, 'bound_by': by, 'library_ms': None,
        **_tc_entry(ptxas, WINDOW_KERNELS[head_dim]['combine'],
                    WINDOW_DESIGN[head_dim]['combine']),
    }


# K7's cache at the 8B serving shape of phase 7: batch 8, the 1024-row
# bucket that the 700-token prompt and its 48 new tokens need.  The timed
# positions give K1's 5,515 live keys inside 1024 rows.
CONTIG_LEN = 1024
CONTIG_POSITIONS = ([0, 63, 64, 133, 511, 700, 1000, 1023],
                    [63, 64, 288, 1000, 1023, 1023, 1023, 1023])


def check_contig_decode(decode_attention, ptxas, kv_heads=KV_HEADS,
                        group=GROUP, tag='', seed=8,
                        variants=('f32', 'bf16', 'int8')):
    """K7 in f32, bf16 and on an int8 cache (bf16 q) at q (8, 8, 4, 128)
    over a 2-layer (L, 8, 1024, 8, 128) cache (or `kv_heads` x `group`,
    the per-shard shape `tag` of 18f): against its plain version at two
    position sets (block edges, and K1's live-key count), and on a cache
    poisoned past each position.  Returns the kernels line entries of
    the bf16 and int8 variants, timed at the second set."""
    da = decode_attention
    gen = torch.Generator(device='cuda').manual_seed(seed)
    batch, layer = 8, 1
    shape = (2, batch, CONTIG_LEN, kv_heads, HEAD_DIM)
    results = {}
    for label, dtype, int8 in (('f32', torch.float32, False),
                               ('bf16', torch.bfloat16, False),
                               ('int8', torch.bfloat16, True)):
        if label not in variants:
            continue
        q = torch.randn(batch, kv_heads, group, HEAD_DIM, generator=gen,
                        device='cuda').to(dtype)
        k = torch.randn(shape, generator=gen, device='cuda').to(dtype)
        v = torch.randn(shape, generator=gen, device='cuda').to(dtype)
        ks = vs = None
        if int8:
            from skypilot_tpu_torch.infer import llama_infer
            (k, ks), (v, vs) = (llama_infer._quantize_kv(x) for x in (k, v))
        for pos_list in CONTIG_POSITIONS:
            positions = torch.tensor(pos_list, dtype=torch.int32,
                                     device='cuda')

            def kernel(k=k, v=v):
                return da.decode_attention(q, k, v, layer, positions, ks, vs)

            def plain():
                return da._decode_attention_contig_plain(
                    q, k, v, layer, positions, ks, vs)

            out, want = kernel(), plain()
            # Both sides keep the probabilities and the dequantized cache
            # in f32 and round only the output: per-row bf16 ulps.
            err = check_close(f'decode_attention {label} positions '
                              f'{pos_list}', out, want, row_tol(want))
            del want
            if not torch.equal(kernel(), out):
                raise AssertionError(f'decode_attention {label}: two calls '
                                     f'differ')
            value = 127 if int8 else 1e4
            k2, v2 = k.clone(), v.clone()
            for b, p in enumerate(pos_list):
                k2[layer, b, p + 1:] = value
                v2[layer, b, p + 1:] = -value
            if not torch.equal(kernel(k2, v2), out):
                raise AssertionError(f'decode_attention {label} read keys '
                                     f'past a position')
            del k2, v2
        if label == 'f32':
            continue
        live_keys = int((positions.long() + 1).sum())
        nbytes = 2 * q.numel() * 2 + _kv_bytes(live_keys, k) + batch * 4
        b_ms, by = bound(nbytes, 4 * HEAD_DIM * kv_heads * group * live_keys,
                         BF16_FLOPS)
        kt, vt = k[layer], v[layer]
        if int8:
            kt = da._dequantize(kt, ks[layer], dtype)
            vt = da._dequantize(vt, vs[layer], dtype)
        kt, vt = kt.transpose(1, 2), vt.transpose(1, 2)    # (B, KV, S, hd)
        qs = q.reshape(batch, kv_heads * group, 1, HEAD_DIM)
        mask = (torch.arange(CONTIG_LEN, device='cuda')[None, :]
                <= positions.long()[:, None])[:, None, None, :]
        splits, split_len = _split_of(da, batch, CONTIG_LEN, kv_heads)
        suffix = [t for t in (tag, 'int8' if int8 else '') if t]
        results[label] = {
            'name': 'decode_attention' + (f'[{", ".join(suffix)}]'
                                          if suffix else ''),
            'route': 'cuda',
            'source': 'skypilot_tpu_torch/csrc/paged_decode.cu',
            'replaces': 'skypilot_tpu/ops/decode_attention.py:202',
            'shape': f'q ({batch}, {kv_heads}, {group}, {HEAD_DIM}) bf16, '
                     f'{"int8" if int8 else "bf16"} cache (2, {batch}, '
                     f'{CONTIG_LEN}, {kv_heads}, {HEAD_DIM}), live keys '
                     f'{live_keys}',
            'splits': splits, 'split_len': split_len,
            'max_abs_err': err, 'ms': time_ms(kernel),
            'graph_ms': graph_ms(kernel),
            'plain_ms': time_ms(plain), 'bound_ms': b_ms, 'bound_by': by,
            'library_ms': time_ms(lambda: sdpa(qs, kt, vt, attn_mask=mask)),
            'library_graph_ms': graph_ms(
                lambda: sdpa(qs, kt, vt, attn_mask=mask)),
            **_ptxas_of(ptxas, DECODE_KERNELS['contig', label]),
        }
    return results


# ---- phase 4: slice parity ------------------------------------------------

def _settle_tier_each_tick(b):
    """Every tick of `b` starts once its host tier's copy engine has run
    each queued copy.  A spill completes when its copy does (at once on
    the host, at its CUDA event on the card, which the host's clock does
    not order), and until the tick's drain sees it, it holds one of the
    engine's slots: can_accept, and so which evictions spill and which
    blocks the trie hands out, would depend on the card's lag."""
    step = b.step

    def settled():
        b._tier.wait_pending()
        step()

    b.step = settled


def _serve_debug(params, cfg, dev, prompts, budgets, graphs=None,
                 settle=True, **extra):
    """settle: with a host tier, _settle_tier_each_tick."""
    from skypilot_tpu_torch.infer.engine import GeneratorConfig
    from skypilot_tpu_torch.infer.serving import ContinuousBatcher
    b = ContinuousBatcher(params, cfg, GeneratorConfig(
        max_seq_len=256, batch_size=3, prompt_buckets=[16, 64, 128],
        prefill_chunk=64, kv_block_size=16, **extra), decode_chunk=4,
        device=dev, graphs=graphs)
    if settle and b._tier is not None:
        _settle_tier_each_tick(b)
    rids = [b.submit(p, max_new_tokens=n) for p, n in zip(prompts, budgets)]
    b.run_until_idle()
    if b.pooled:
        b.pool.check_invariant()
    return b, [b.result(r) for r in rids]


def _generate_debug(params, cfg, dev, prompts, budgets, graphs=None,
                    **extra):
    """The lockstep Generator on the same prompts, each row cut to its
    request's budget (generate() runs twice: the second call replays
    the first one's graphs, and must return the same tokens)."""
    from skypilot_tpu_torch.infer.engine import Generator, GeneratorConfig
    gen = Generator(params, cfg, GeneratorConfig(
        max_seq_len=256, batch_size=len(prompts),
        prompt_buckets=[16, 64, 128], decode_chunk=4, kv_block_size=16,
        **extra), device=dev, graphs=graphs)
    out = gen.generate(prompts, max_new_tokens=max(budgets))
    again = gen.generate(prompts, max_new_tokens=max(budgets))
    if again != out:
        raise AssertionError(f'Generator {extra} on {dev}: a second '
                             f'generate() gave other tokens')
    if gen.pooled:
        gen.pool.check_invariant()
    return gen, [o[:n] for o, n in zip(out, budgets)]


def _card_and_host(label, run, params, cfg, prompts, budgets, extra):
    """The same requests on the host (plain versions), on the card
    eagerly (graphs=False) and on the card through the engine's graphs
    (the default): identical greedy tokens on all three.  The graph run
    must have replayed chunks and captured each key once (on a legacy
    plane: once per bucket it reached).  Returns {run: (engine,
    tokens)}."""
    out = {}
    for name, dev, graphs in (('host', 'cpu', None),
                              ('card eager', 'cuda', False),
                              ('card graphs', 'cuda', None)):
        out[name] = run(params[dev], cfg, dev, prompts, budgets,
                        graphs=graphs, **extra)
    eng = out['card graphs'][0]
    if eng.graphs is not None:
        g = eng.graphs
        if not g.replays or (getattr(eng, 'pooled', True)
                             and g.captures != len(g.keys())):
            raise AssertionError(f'{label}: {g.captures} captures of '
                                 f'{len(g.keys())} keys, {g.replays} '
                                 f'replays')
    _same_tokens(f'{label}: card graphs vs card eager',
                 out['card graphs'][1], out['card eager'][1])
    _same_tokens(f'{label}: card vs host', out['card graphs'][1],
                 out['host'][1])
    graphs = ('no graphs (eager)' if eng.graphs is None else
              f'{eng.graphs.captures} captures, {eng.graphs.replays} '
              f'replays')
    log(f'  {label}: greedy tokens identical on the host, the card eager '
        f'and the card through graphs ({graphs}; '
        f'{sum(len(o) for o in out["host"][1])} tokens)')
    return out


def _same_tokens(what, got, want):
    """Identical greedy tokens, or an error naming the first request and
    position where they part."""
    if got == want:
        return
    for i, (g, w) in enumerate(zip(got, want)):
        if g != w:
            at = next((j for j, (a, b) in enumerate(zip(g, w)) if a != b),
                      min(len(g), len(w)))
            raise AssertionError(f'{what}: request {i} differs at token {at}:'
                                 f' {g} vs {w}')
    raise AssertionError(f'{what}: {got} vs {want}')


def _logits_close(what, got, want):
    atol, rtol = LOGITS_TOL
    err = (got.cpu() - want).abs().max().item()
    log(f'  {what} max_abs_err={err:.3e} (atol={atol} rtol={rtol})')
    torch.testing.assert_close(got.cpu(), want, atol=atol, rtol=rtol)


def _debug_requests(vocab_size):
    """Phase 4's four requests: prompts of 5, 40, 100 and 17 tokens from
    seed 1, and their budgets of new tokens."""
    rng = np.random.RandomState(1)
    prompts = [[int(t) for t in rng.randint(1, vocab_size, size=n)]
               for n in (5, 40, 100, 17)]
    return prompts, [12, 9, 7, 10]


def slice_parity():
    from skypilot_tpu_torch.infer import block_pool, engine, llama_infer
    from skypilot_tpu_torch.models import llama

    cfg = llama.LLAMA_DEBUG
    params_cpu = llama.init_params(cfg, torch.Generator().manual_seed(0),
                                   'cpu')
    params = {'cpu': params_cpu, 'cuda': _to_device(params_cpu, 'cuda')}
    prompts, budgets = _debug_requests(cfg.vocab_size)

    tokens = np.zeros((2, 64), np.int64)
    tokens[0, :40] = prompts[1]
    tokens[1, :17] = prompts[3]
    lengths = np.asarray([40, 17], np.int32)
    logits = {}
    for dev in ('cpu', 'cuda'):
        cache = llama_infer.init_cache(cfg, 2, 64, device=dev)
        logits[dev], _ = llama_infer.prefill(
            params[dev], torch.as_tensor(tokens, device=dev), cfg, cache,
            torch.as_tensor(lengths, device=dev))
    _logits_close('prefill logits', logits['cuda'], logits['cpu'])

    # int8 weights and an int8 arena: prefill, then the first decode step
    # through K1's int8 variant.
    tables = np.arange(1, 9, dtype=np.int32).reshape(2, 4)
    first = logits['cpu'].argmax(-1).to(torch.int32)
    step = {}
    for dev in ('cpu', 'cuda'):
        p8 = engine.prepare_params(params[dev], engine.GeneratorConfig(
            weights_dtype='int8'))
        cache = llama_infer.init_cache(cfg, 2, 64, kv_dtype='int8',
                                       device=dev)
        _, cache = llama_infer.prefill(
            p8, torch.as_tensor(tokens, device=dev), cfg, cache,
            torch.as_tensor(lengths, device=dev))
        arena = block_pool.init_arena(cfg, 9, 16, kv_dtype='int8',
                                      device=dev)
        tbl = torch.as_tensor(tables, device=dev)
        llama_infer.scatter_prefill_pooled(cache, arena, tbl)
        step[dev], _ = llama_infer.decode_step_pooled(
            p8, first.to(dev), cfg, arena,
            torch.as_tensor(lengths, device=dev), tbl)
    _logits_close('int8 first decode step logits', step['cuda'], step['cpu'])

    runs = (('plain', {}), ('spec_k=3', dict(spec_k=3)),
            ('fuse_budget=16', dict(fuse_budget=16)),
            ('int8 KV + weights', dict(kv_cache_dtype='int8',
                                       weights_dtype='int8')))
    outs = {}
    for label, extra in runs:
        three = _card_and_host(label, _serve_debug, params, cfg, prompts,
                               budgets, extra)
        for name, (b, _) in three.items():
            if 'spec_k' in extra and not b.spec_proposed:
                raise AssertionError(f'{label} on {name}: no verify chunk')
            if 'fuse_budget' in extra and not b._fuse_policy.stats.steps:
                raise AssertionError(f'{label} on {name}: no fused step')
        outs[label, 'cuda'] = three['card graphs'][1]
    for label in ('spec_k=3', 'fuse_budget=16'):
        _same_tokens(f'{label} vs plain schedule', outs[label, 'cuda'],
                     outs['plain', 'cuda'])
    log('  spec_k=3 and fuse_budget=16 give the plain schedule\'s tokens')

    # The legacy planes (K7 on 'paged') through the batcher, and the
    # lockstep Generator on the pooled and 'paged' planes.
    legacy = (('batcher paged', _serve_debug, dict(decode_impl='paged')),
              ('batcher inplace', _serve_debug, dict(decode_impl='inplace')),
              ('batcher paged int8 KV', _serve_debug,
               dict(decode_impl='paged', kv_cache_dtype='int8')),
              ('Generator pooled', _generate_debug, {}),
              ('Generator pooled spec_k=3', _generate_debug, dict(spec_k=3)),
              ('Generator paged', _generate_debug,
               dict(decode_impl='paged')))
    with warnings.catch_warnings():
        warnings.simplefilter('ignore', DeprecationWarning)
        for label, run, extra in legacy:
            three = _card_and_host(label, run, params, cfg, prompts,
                                   budgets, extra)
            for name, (engine_obj, _) in three.items():
                if run is _serve_debug and not engine_obj.pooled and \
                        not engine_obj.migrations['grow']:
                    raise AssertionError(f'{label} on {name}: no migration')
            outs[label, 'cuda'] = three['card graphs'][1]
            if 'int8' not in label:
                _same_tokens(f'{label} vs the pooled batcher',
                             outs[label, 'cuda'], outs['plain', 'cuda'])
    log('  batcher paged / inplace / paged int8 KV and Generator pooled / '
        'spec_k=3 / paged: greedy tokens identical to the pooled '
        'batcher\'s (int8 aside)')


def _clone_to(tree, device):
    """A copy of a parameter tree on `device` (a Trainer updates the
    tensors it is given in place)."""
    if isinstance(tree, dict):
        return {k: _clone_to(v, device) for k, v in tree.items()}
    return tree.detach().clone().to(device)


def _grads_on(loss_fn, params, tokens, dev):
    """First-step gradients of loss_fn(params, {'tokens'}) on `dev`, from
    a copy of the params there; returned on the host."""
    from skypilot_tpu_torch.train import trainer
    p = trainer.tree_map(lambda t: t.requires_grad_(), _clone_to(params, dev))
    loss = loss_fn(p, {'tokens': torch.from_numpy(tokens).to(dev)})
    return [g.cpu() for g in torch.autograd.grad(loss,
                                                 trainer.tree_leaves(p))]


def _grads_close(label, got, want):
    """Card vs host gradients, leaf by leaf, within rtol 1e-4 and atol
    1e-4 x the leaf's largest element; none all zero.  Returns the
    largest error over that scale."""
    err = 0.0
    for g, w in zip(got, want):
        if not float(g.abs().max()) > 0:
            raise AssertionError(f'{label}: a zero gradient')
        scale = float(w.abs().max())
        err = max(err, float((g - w).abs().max()) / scale)
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-4 * scale)
    return err


def train_parity():
    """LLAMA_DEBUG f32 on the card (kernels) and the host (plain
    versions): first-step gradients under remat False, True and 'dots'
    (card vs host, and each remat setting vs none on the card), then 3
    Trainer steps with lr 1e-3 (loss and grad_norm of each)."""
    from skypilot_tpu_torch.models import llama
    from skypilot_tpu_torch.train import trainer

    cfg = llama.LLAMA_DEBUG
    params = llama.init_params(cfg, torch.Generator().manual_seed(0), 'cpu')
    # 63 input tokens: a ragged last tile in every attention kernel.
    tokens = next(trainer.synthetic_batches(4, 63, cfg.vocab_size))['tokens']
    grads = {}
    for remat, policy in ((False, None), (True, None), (True, 'dots')):
        c = dataclasses.replace(cfg, remat=remat, remat_policy=policy)
        for dev in ('cpu', 'cuda'):
            grads[policy or remat, dev] = _grads_on(
                lambda p, b: llama.loss_fn(p, b, c), params, tokens, dev)
    for key in (False, True, 'dots'):
        err = _grads_close(f'remat={key}', grads[key, 'cuda'],
                           grads[key, 'cpu'])
        same = max(float((a - b).abs().max() / b.abs().max())
                   for a, b in zip(grads[key, 'cuda'],
                                   grads[False, 'cuda']))
        log(f'  first-step gradients remat={key}: card vs host max '
            f'err/max|grad| {err:.2e} (tolerance 1e-4); vs remat=False '
            f'on the card {same:.2e}')
        if same > 1e-5:
            raise AssertionError(f'remat={key} changes the gradients on '
                                 f'the card by {same:.2e} of their scale')
    tc = trainer.TrainConfig(learning_rate=1e-3, warmup_steps=1,
                             total_steps=4)
    steps = {}
    for dev in ('cpu', 'cuda'):
        tr = trainer.Trainer(lambda p, b: llama.loss_fn(p, b, cfg),
                             _clone_to(params, dev), tc, device=dev)
        batches = trainer.synthetic_batches(4, 63, cfg.vocab_size)
        steps[dev] = [(float(m['loss']), float(m['grad_norm'])) for m in (
            tr.run_step(next(batches)) for _ in range(3))]
    log(f'  3 Trainer steps (loss, grad_norm): card {steps["cuda"]}, host '
        f'{steps["cpu"]}')
    np.testing.assert_allclose(steps['cuda'], steps['cpu'], rtol=1e-5)


def post_train_parity():
    """LoRA-SFT and LoRA-DPO on LLAMA_DEBUG f32, on the card (kernels) and
    the host (plain versions) from the same base and adapters (B drawn
    non-zero): first-step adapter gradients at train_parity's bound."""
    from skypilot_tpu_torch.models import llama
    from skypilot_tpu_torch.train import dpo, lora, sft, trainer

    cfg = llama.LLAMA_DEBUG
    params = llama.init_params(cfg, torch.Generator().manual_seed(0), 'cpu')
    lcfg = lora.LoraConfig(rank=4, alpha=8.0, targets='attn')
    gen = torch.Generator().manual_seed(2)
    adapters = trainer.tree_map(
        lambda t: t if t.any() else 0.02 * torch.randn(
            t.shape, generator=gen),
        lora.init_lora(params, lcfg, torch.Generator().manual_seed(1)))
    rng = np.random.default_rng(0)
    tokens = rng.integers(1, cfg.vocab_size, (6, 64), dtype=np.int32)
    mask = (rng.random((6, 63)) > 0.3).astype(np.float32)
    batches = {
        'sft': {'tokens': tokens[:4], 'loss_mask': mask[:4]},
        'dpo': {'tokens_chosen': tokens[:2], 'mask_chosen': mask[:2],
                'tokens_rejected': tokens[2:4], 'mask_rejected': mask[2:4]},
    }
    losses = {
        'sft': lambda base, ad, b: lora.wrap_loss(
            lambda p, bb: sft.sft_loss_fn(p, bb, cfg), base, lcfg)(ad, b),
        'dpo': lambda base, ad, b: dpo.dpo_loss_fn(
            lora.apply_lora(base, ad, lcfg), base, b, cfg),
    }
    for name, loss_fn in losses.items():
        grads = {}
        for dev in ('cpu', 'cuda'):
            ad = trainer.tree_map(lambda t: t.requires_grad_(),
                                  _clone_to(adapters, dev))
            batch = {k: torch.from_numpy(v).to(dev)
                     for k, v in batches[name].items()}
            loss = loss_fn(_clone_to(params, dev), ad, batch)
            grads[dev] = [g.cpu() for g in torch.autograd.grad(
                loss, trainer.tree_leaves(ad))]
        err = _grads_close(f'LoRA-{name}', grads['cuda'], grads['cpu'])
        log(f'  LoRA-{name} first-step adapter gradients ({len(grads["cpu"])}'
            f' leaves): card vs host max err/max|grad| {err:.2e} '
            f'(tolerance 1e-4)')


# A MoE config at LLAMA_DEBUG's attention widths (2 heads of 128 over one
# KV head: the card's kernels take head_dim 64, 128 or 256, MOE_DEBUG's is
# 32): 4 experts, top 2, f32, 2 layers.
def moe_debug_config():
    from skypilot_tpu_torch.models import moe
    return dataclasses.replace(moe.MOE_DEBUG, d_model=256, n_heads=2,
                               n_kv_heads=1, d_ff=512)


def moe_parity():
    """The MoE expert bank on the card (kernels, cuBLAS) and the host
    (plain versions) from the same f32 weights: identical greedy tokens
    on the host, the card eager and the card through graphs (the pooled
    plane, plain and spec_k=3: the bank inside every captured decode and
    verify chunk), and first-step gradients of moe.loss_fn card vs host
    under router_impl 'capacity' and 'dense' at train_parity's bound."""
    from skypilot_tpu_torch.models import moe
    from skypilot_tpu_torch.train import trainer

    cfg = moe_debug_config()
    params_cpu = moe.init_params(cfg, torch.Generator().manual_seed(0),
                                 'cpu')
    params = {'cpu': params_cpu, 'cuda': _to_device(params_cpu, 'cuda')}
    prompts, budgets = _debug_requests(cfg.vocab_size)
    for label, extra in (('MoE plain', {}), ('MoE spec_k=3',
                                             dict(spec_k=3))):
        three = _card_and_host(label, _serve_debug, params, cfg, prompts,
                               budgets, extra)
        if extra and not three['card graphs'][0].spec_proposed:
            raise AssertionError(f'{label}: no verify chunk')
    tokens = next(trainer.synthetic_batches(4, 63, cfg.vocab_size))['tokens']
    for impl in ('capacity', 'dense'):
        c = dataclasses.replace(cfg, router_impl=impl)
        grads = {dev: _grads_on(lambda p, b: moe.loss_fn(p, b, c),
                                params_cpu, tokens, dev)
                 for dev in ('cpu', 'cuda')}
        err = _grads_close(f'MoE {impl}', grads['cuda'], grads['cpu'])
        log(f'  MoE first-step gradients router_impl={impl!r} '
            f'({len(grads["cpu"])} leaves): card vs host max err/max|grad| '
            f'{err:.2e} (tolerance 1e-4)')


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    return tree.to(device)


# ---- phases 5 to 7: main paths ----------------------------------------------

# Prompt lengths of the 8 serving requests (48 new tokens each).
SERVE_LENGTHS = [17, 60, 128, 250, 300, 450, 600, 700]


def _graph_stats(graphs, before=(0, 0.0, 0)):
    """Captures, capture seconds and replays of an engine's graphs since
    `before` (zeros without graphs)."""
    now = ((graphs.captures, graphs.capture_seconds, graphs.replays)
           if graphs is not None else (0, 0.0, 0))
    return dict(zip(('graph_captures', 'graph_capture_s', 'graph_replays'),
                    (a - b for a, b in zip(now, before))))


def _burst(batcher, send, n):
    """Send n requests as one burst that the batcher admits in a fixed
    order: its ticks wait until all n are queued, and request i is sent
    once request i - 1 is queued.  So every run of a path prefills the
    same groups (a group's size changes the rounding of its bf16
    products) and two runs can be held to identical greedy tokens."""
    step, burst = batcher.step, threading.Event()
    batcher.step = lambda: step() if burst.is_set() else None
    threads = []
    try:
        for i in range(n):
            threads.append(threading.Thread(target=send, args=(i,)))
            threads[-1].start()
            deadline = time.perf_counter() + 60
            while batcher.num_queued <= i:
                if time.perf_counter() > deadline:
                    raise AssertionError(f'request {i} was never queued')
                time.sleep(0.001)
    finally:
        burst.set()
        del batcher.step           # the class's method again, no cycle
    for t in threads:
        t.join(900)


def serve_path(label, params, gen_config, counters, graphs=None, cfg=None,
               model='llama3-8b'):
    """Serve the 8 requests (one burst, _burst) through the HTTP replica
    with every launch count set to 0 just before and read just after;
    returns (the counts, the migrations, each request's tokens, the
    printed stats).  Fails unless every request returns 48 in-range
    tokens and the pool comes back empty (on a legacy plane: every slot
    comes back free and frozen, and one short request afterwards shrinks
    the slot cache to its smallest bucket).  graphs: the batcher's
    argument (None: graphs on the card); cfg, model: the model's config
    (LLAMA3_8B by default) and the name the replica gives it.  With
    graphs, the stats hold the batcher's graph budgets over the whole
    run (analysis/audit.py's graph_budgets: its graphs watched from
    construction, its rows, tables and arena held at their addresses),
    which phase 20 reads."""
    from skypilot_tpu_torch.analysis import audit
    from skypilot_tpu_torch.infer import engine, replica
    from skypilot_tpu_torch.infer.serving import ContinuousBatcher
    from skypilot_tpu_torch.models import llama

    cfg = cfg or llama.LLAMA3_8B
    torch.cuda.reset_peak_memory_stats()
    batcher = ContinuousBatcher(params, cfg, gen_config, decode_chunk=16,
                                device='cuda', graphs=graphs)
    addresses = None
    if batcher.graphs is not None:
        audit.watch(batcher)
        addresses = audit.addresses(batcher)
    # Warm-up (cuBLAS handles, allocator pools, the 16-step chunk's
    # graph), then count from zero.
    warm = batcher.submit([1, 2, 3], max_new_tokens=2)
    batcher.run_until_idle()
    batcher.result(warm)
    batcher.decode_tokens, batcher.decode_seconds = 0, 0.0
    batcher.spec_proposed = batcher.spec_accepted = 0
    batcher.slot_steps = batcher.live_slot_steps = 0
    warm_graphs = _graph_stats(batcher.graphs)
    torch.cuda.synchronize()
    resident_gb = torch.cuda.memory_allocated() / 1e9
    retries0 = torch.cuda.memory_stats()['num_alloc_retries']
    server, thread = replica.serve(batcher, '127.0.0.1', 0, model)
    url = f'http://127.0.0.1:{server.server_address[1]}'
    try:
        with urllib.request.urlopen(f'{url}/health', timeout=30) as r:
            health = json.loads(r.read())
        assert health['status'] == 'ok', health
        rng = np.random.RandomState(2)
        lengths = SERVE_LENGTHS
        prompts = [[int(t) for t in rng.randint(0, cfg.vocab_size, size=n)]
                   for n in lengths]
        max_new = 48
        responses = [None] * len(prompts)

        def send(i):
            body = json.dumps({'prompt_ids': prompts[i],
                               'max_new_tokens': max_new}).encode()
            req = urllib.request.Request(
                f'{url}/generate', data=body,
                headers={'Content-Type': 'application/json'})
            with urllib.request.urlopen(req, timeout=600) as r:
                responses[i] = json.loads(r.read())

        fuse0 = (batcher._fuse_policy.stats.steps,
                 batcher._fuse_policy.stats.prefill_tokens) \
            if batcher._fuse_policy else (0, 0)
        _zero(counters)
        syncs0 = engine.host_fetch.calls
        mig0 = dict(batcher.migrations)
        t0 = time.perf_counter()
        _burst(batcher, send, len(prompts))
        wall = time.perf_counter() - t0
        launches = _counts(counters)
        syncs = engine.host_fetch.calls - syncs0
    finally:
        replica.shutdown_replica(server, thread)
    for i, resp in enumerate(responses):
        if resp is None or resp.get('num_generated') != max_new:
            raise AssertionError(f'{label}: request {i} (prompt '
                                 f'{lengths[i]}): {resp}')
        if not all(0 <= t < cfg.vocab_size for t in resp['output_ids']):
            raise AssertionError(f'{label}: request {i}: token out of range')
    migrations = {k: v - mig0[k] for k, v in batcher.migrations.items()}
    cache_len = batcher._cache_len
    if batcher.pooled:
        batcher.pool.check_invariant()
        st = batcher.pool.stats()
        if st['blocks_live'] or st['reserved']:
            raise AssertionError(f'{label}: pool not returned: {st}')
    else:
        if sorted(batcher._free) != list(range(gen_config.batch_size)) \
                or not bool(batcher._done.all()):
            raise AssertionError(f'{label}: slots not returned: free '
                                 f'{batcher._free}')
        short = batcher.submit([1, 2, 3], max_new_tokens=2)
        batcher.run_until_idle()
        batcher.result(short)
        if batcher._cache_len != batcher.cache_buckets[0]:
            raise AssertionError(f'{label}: the slot cache stayed at '
                                 f'{batcher._cache_len} rows')
    ttfts = sorted(r['ttft_s'] for r in responses)
    run_graphs = _graph_stats(batcher.graphs, tuple(warm_graphs.values()))
    stats = {
        'card': CARD['line'],
        'graphs': batcher.graphs is not None,
        'requests': len(responses),
        'prompt_tokens': sum(lengths),
        'generated_tokens': sum(r['num_generated'] for r in responses),
        'wall_s': wall,
        'ttft_s_median': statistics.median(ttfts),
        'ttft_s_max': ttfts[-1],
        'decode_tokens_per_s': batcher.decode_tokens
        / batcher.decode_seconds,
        'decode_tokens': batcher.decode_tokens,
        'decode_seconds': batcher.decode_seconds,
        **run_graphs,
        # The same tokens over the decode seconds that were not capture.
        'decode_tokens_per_s_without_capture': batcher.decode_tokens / (
            batcher.decode_seconds - run_graphs['graph_capture_s']),
        'graph_captures_warmup': warm_graphs['graph_captures'],
        'graph_capture_s_warmup': warm_graphs['graph_capture_s'],
        'graph_keys': len(batcher.graphs.keys()) if batcher.graphs else 0,
        'live_slot_share': (batcher.live_slot_steps / batcher.slot_steps
                            if batcher.slot_steps else None),
        'spec_proposed': batcher.spec_proposed,
        'spec_accepted': batcher.spec_accepted,
        'fused_steps': (batcher._fuse_policy.stats.steps - fuse0[0]
                        if batcher._fuse_policy else 0),
        'fused_prefill_tokens': (
            batcher._fuse_policy.stats.prefill_tokens - fuse0[1]
            if batcher._fuse_policy else 0),
        'host_fetches': syncs,
        'migrations': migrations,
        'cache_len': cache_len,
        'resident_gb_before_requests': resident_gb,
        'peak_memory_gb': torch.cuda.max_memory_allocated() / 1e9,
        # The allocator's cache held by the process, and the cudaMallocs
        # that failed and emptied that cache to retry (each a device
        # synchronize and a free of every cached segment).
        'reserved_gb': torch.cuda.memory_reserved() / 1e9,
        'alloc_retries': torch.cuda.memory_stats()['num_alloc_retries']
        - retries0,
        'launches': launches,
    }
    if addresses is not None:
        stats['graph_budgets'] = audit.graph_budgets(batcher, addresses)
    log(f'  {label}: ' + json.dumps(stats))
    return launches, migrations, [r['output_ids'] for r in responses], stats


def generate_path(label, params, gen_config, counters):
    """One Generator.generate of the 8 serving prompts, 48 new tokens
    each, with every launch count set to 0 just before and read just
    after; returns the counts.  Fails unless every row returns 48
    in-range tokens."""
    from skypilot_tpu_torch.infer.engine import Generator
    from skypilot_tpu_torch.models import llama

    cfg = llama.LLAMA3_8B
    torch.cuda.reset_peak_memory_stats()
    gen = Generator(params, cfg, gen_config, device='cuda')
    gen.warmup()
    warm_graphs = _graph_stats(gen.graphs)
    torch.cuda.synchronize()
    resident_gb = torch.cuda.memory_allocated() / 1e9
    rng = np.random.RandomState(2)
    prompts = [[int(t) for t in rng.randint(0, cfg.vocab_size, size=n)]
               for n in SERVE_LENGTHS]
    _zero(counters)
    mig0 = dict(gen.migrations)
    t0 = time.perf_counter()
    out = gen.generate(prompts, max_new_tokens=48)
    wall = time.perf_counter() - t0
    launches = _counts(counters)
    for i, row in enumerate(out):
        if len(row) != 48 or not all(0 <= t < cfg.vocab_size for t in row):
            raise AssertionError(f'{label}: row {i} (prompt '
                                 f'{SERVE_LENGTHS[i]}): {len(row)} tokens')
    st = gen.last_stats
    stats = {
        'card': CARD['line'], 'rows': len(out),
        'prompt_tokens': sum(SERVE_LENGTHS),
        'generated_tokens': st['generated_tokens'], 'wall_s': wall,
        'ttft_s': st['ttft_s'],
        'decode_tokens_per_s': st['decode_tokens'] / st['decode_seconds'],
        'decode_tokens': st['decode_tokens'],
        'decode_seconds': st['decode_seconds'],
        **_graph_stats(gen.graphs, tuple(warm_graphs.values())),
        'live_slot_share': st['live_slot_steps'] / st['decode_tokens'],
        'host_fetches': st['host_fetches'],
        'migrations': {k: v - mig0[k] for k, v in gen.migrations.items()},
        'cache_len': st['cache_len'],
        'resident_gb_before_generate': resident_gb,
        'peak_memory_gb': torch.cuda.max_memory_allocated() / 1e9,
        'launches': launches,
    }
    log(f'  {label}: ' + json.dumps(stats))
    return launches


def train_path(label, cfg, batch, seq, steps, train_config, counters):
    """Trainer.fit on random bf16 weights with every launch count set to
    0 just before and read just after; returns the counts.  Fails unless
    the first and last losses are finite."""
    from skypilot_tpu_torch.models import llama
    from skypilot_tpu_torch.train import trainer

    params = llama.init_params(
        cfg, torch.Generator(device='cuda').manual_seed(0), 'cuda')
    first = next(trainer.synthetic_batches(batch, seq, cfg.vocab_size))
    with torch.no_grad():
        first_loss = float(llama.loss_fn(params, {'tokens': torch.as_tensor(
            first['tokens'], device='cuda')}, cfg))
    tr = trainer.Trainer(lambda p, b: llama.loss_fn(p, b, cfg), params,
                         train_config, device='cuda')
    del params
    torch.cuda.synchronize()
    resident_gb = torch.cuda.memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    n_all = cfg.num_params()
    n_matmul = n_all - cfg.vocab_size * cfg.d_model
    _zero(counters)
    t0 = time.perf_counter()
    out = tr.fit(trainer.synthetic_batches(batch, seq, cfg.vocab_size),
                 steps, log_every=0, tokens_per_batch=batch * seq,
                 flops_per_token=6 * n_all)
    wall = time.perf_counter() - t0
    launches = _counts(counters)
    if not (np.isfinite(first_loss) and np.isfinite(out['loss'])):
        raise AssertionError(f'{label}: loss {first_loss} -> {out["loss"]}')
    stats = {
        'card': CARD['line'],
        'params_b': n_all / 1e9, 'params_b_without_embed': n_matmul / 1e9,
        'tokens_per_step': batch * seq, 'steps': steps,
        'step_time_s': out['step_time_s'],
        'tokens_per_s': out['tokens_per_sec'],
        'mfu_6n_all': out['mfu'],
        'mfu_6n_without_embed': (6 * n_matmul * out['tokens_per_sec']
                                 / BF16_FLOPS),
        'first_loss': first_loss, 'last_loss': out['loss'],
        'grad_norm': out['grad_norm'], 'fit_wall_s': wall,
        'resident_gb_before_fit': resident_gb,
        'peak_memory_gb': torch.cuda.max_memory_allocated() / 1e9,
        'launches_per_step': {k: v / steps for k, v in launches.items()
                              if v},
    }
    log(f'  {label}: ' + json.dumps(stats))
    del tr
    gc.collect()
    torch.cuda.empty_cache()
    return launches, stats


def bench_train_path(counters):
    """8a: the port's training headline, bench.bench_train (LLAMA_1B
    bf16, remat 'dots', loss_chunk 256, 8 x 1024 tokens, 12 steps through
    Trainer.fit), with every launch count set to 0 just before and read
    just after.  Fails unless its loss is finite.  Returns (the counts,
    the stats it prints, (tokens/s, MFU) for phase 23's headline)."""
    from skypilot_tpu_torch import bench
    cfg, batch, seq, steps = bench.train_config('cuda')
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    n_all = cfg.num_params()
    n_matmul = n_all - cfg.vocab_size * cfg.d_model
    _zero(counters)
    t0 = time.perf_counter()
    tok_s, mfu, out, tr = bench.bench_train('cuda')
    wall = time.perf_counter() - t0
    launches = _counts(counters)
    tr.close()
    del tr
    if not np.isfinite(out['loss']):
        raise AssertionError(f'8a: loss {out["loss"]}')
    stats = {
        'card': CARD['line'],
        'params_b': n_all / 1e9, 'params_b_without_embed': n_matmul / 1e9,
        'tokens_per_step': batch * seq, 'steps': steps,
        'step_time_s': out['step_time_s'], 'tokens_per_s': tok_s,
        'mfu_6n_all': mfu,
        'mfu_6n_without_embed': 6 * n_matmul * tok_s / BF16_FLOPS,
        'last_loss': out['loss'], 'grad_norm': out['grad_norm'],
        'bench_train_wall_s': wall,
        'peak_memory_gb': torch.cuda.max_memory_allocated() / 1e9,
        'launches_per_step': {k: v / steps for k, v in launches.items()
                              if v},
    }
    log('  8a LLAMA_1B 8x1024 (bench.bench_train): ' + json.dumps(stats))
    gc.collect()
    torch.cuda.empty_cache()
    return launches, stats, (tok_s, mfu)


# ---- phase 9: checkpointing -------------------------------------------------

def _state_gb(cfg, mu_bytes=2):
    """GB of one checkpoint of `cfg` in bf16: params, mu, nu."""
    return cfg.num_params() * (2 + mu_bytes + 2) / 1e9


def _flat_state(tr):
    from skypilot_tpu_torch.ckpt import format as ckpt_format
    named, _ = ckpt_format.flatten_with_keys(tr._state_dict())
    return named


def _sample(name, **labels):
    from skypilot_tpu_torch.telemetry import metrics
    return metrics.REGISTRY.get_sample_value(name, labels) or 0.0


def _grads_twice(tr, batch):
    """Is one forward and backward of the train step bitwise
    repeatable?  Two of them from the trainer's state on one batch."""
    tokens = {'tokens': tr._to_device(batch['tokens'])}
    runs = []
    for _ in range(2):
        loss = tr._loss_fn(tr.params, tokens)
        grads = torch.autograd.grad(loss, tr._leaves)
        runs.append((loss.detach(), grads))
    (l1, g1), (l2, g2) = runs
    same = [torch.equal(a, b) for a, b in zip(g1, g2)]
    spread = max(float((a.float() - b.float()).abs().max()
                       / b.float().abs().max().clamp_min(1e-30))
                 for a, b in zip(g1, g2))
    return torch.equal(l1, l2) and all(same), spread


def checkpoint_path(cfg, train_config, counters, root, step_8a_s):
    """9a: Trainer A takes 8 steps of 8 x 1024 with async interval
    saves (every 4, keep_last 2); Trainer B from another seed restores
    the latest step, which must equal A's state leaf by leaf; then both
    take 3 more steps on the same batches.  Launch counts are taken over
    the whole run."""
    from skypilot_tpu_torch.models import llama
    from skypilot_tpu_torch.train import trainer

    def make(seed):
        params = llama.init_params(
            cfg, torch.Generator(device='cuda').manual_seed(seed), 'cuda')
        return trainer.Trainer(lambda p, b: llama.loss_fn(p, b, cfg), params,
                               train_config, device='cuda')

    batches = trainer.synthetic_batches(8, 1024, cfg.vocab_size)
    tr_a = make(0)
    manager = tr_a.enable_checkpointing(root, save_interval_steps=4,
                                        keep_last=2, emergency_save=False)
    snap0 = (_sample('skytpu_ckpt_save_duration_seconds_count',
                     phase='snapshot'),
             _sample('skytpu_ckpt_save_duration_seconds_sum',
                     phase='snapshot'))
    write0 = (_sample('skytpu_ckpt_save_duration_seconds_count',
                      phase='write'),
              _sample('skytpu_ckpt_save_duration_seconds_sum',
                      phase='write'))
    bytes0 = _sample('skytpu_ckpt_bytes_written_total')
    _zero(counters)
    step_s = []
    t0 = time.perf_counter()
    for _ in range(8):
        start = time.perf_counter()
        out = tr_a.run_step(next(batches))
        float(out['loss'])
        step_s.append(time.perf_counter() - start)
    loop_s = time.perf_counter() - t0
    start = time.perf_counter()
    tr_a.wait_for_checkpoints()
    drain_s = time.perf_counter() - start
    saves = (_sample('skytpu_ckpt_save_duration_seconds_count',
                     phase='write') - write0[0])
    write_s = (_sample('skytpu_ckpt_save_duration_seconds_sum',
                       phase='write') - write0[1])
    snap_s = (_sample('skytpu_ckpt_save_duration_seconds_sum',
                      phase='snapshot') - snap0[1])
    written = _sample('skytpu_ckpt_bytes_written_total') - bytes0
    if manager.all_steps() != [4, 8] or saves != 2:
        raise AssertionError(f'9a: committed {manager.all_steps()} after '
                             f'{saves} saves, expected [4, 8]')

    tr_b = make(1)
    torch.cuda.synchronize()
    start = time.perf_counter()
    restored = tr_b.restore_latest(root)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - start
    if restored != 8 or tr_b.step != 8 or tr_b.opt_state['count'] != 8:
        raise AssertionError(f'9a: restored step {restored}, step '
                             f'{tr_b.step}, count {tr_b.opt_state["count"]}')
    leaves = 0
    for (key, a), (_, b) in zip(_flat_state(tr_a), _flat_state(tr_b)):
        if not torch.equal(a, b):
            raise AssertionError(f'9a: restored leaf {key} differs')
        leaves += 1
    batch = next(batches)
    deterministic, spread = _grads_twice(tr_b, batch)
    if not deterministic:
        raise AssertionError(
            f'9a: one forward and backward run twice from one state is '
            f'not bitwise repeatable (largest gradient difference '
            f'{spread} of the leaf max): a resume can no longer be held '
            f'to the uninterrupted run bitwise')
    continued = []
    for i in range(3):
        got_a, got_b = tr_a.run_step(batch), tr_b.run_step(batch)
        pair = [(float(got_a[k]), float(got_b[k]))
                for k in ('loss', 'grad_norm')]
        continued.append(pair)
        if any(x != y or not np.isfinite(x) for x, y in pair):
            raise AssertionError(f'9a: continued step {i + 1} differs '
                                 f'after the restore: {pair}')
        batch = next(batches)
    launches = _counts(counters)
    for (key, a), (_, b) in zip(_flat_state(tr_a), _flat_state(tr_b)):
        if not torch.equal(a, b):
            raise AssertionError(f'9a: leaf {key} differs 3 steps after '
                                 f'the restore')
    stats = {
        'card': CARD['line'], 'checkpoint_gb': written / saves / 1e9,
        'leaves': leaves, 'saves': saves,
        'snapshot_s_per_save': snap_s / saves,
        'write_commit_s_per_save': write_s / saves,
        'write_gb_per_s': written / write_s / 1e9,
        'drain_wait_s': drain_s, 'loop_s_8_steps': loop_s,
        'step_s': step_s,
        'step_s_save_in_flight': statistics.median(step_s[4:7]),
        'step_s_8a': step_8a_s,
        'restore_s': restore_s,
        'restore_gb_per_s': written / saves / restore_s / 1e9,
        'step_bitwise_repeatable': deterministic,
        'continued_loss_grad_norm_a_b': continued,
    }
    log('  9a async saves, restore, continue: ' + json.dumps(stats))
    tr_a.close()
    tr_b.close()
    del tr_a, tr_b
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def recovery_path(root):
    """9b: a managed job's recovery through the entry point.  The first
    child trains 16 steps in chunks of 4 and is sent SIGTERM once it has
    committed step 8 and started staging the next save; the relaunch
    with --resume auto must resume from the newest committed step and
    finish."""
    import signal as signal_module
    from skypilot_tpu_torch.ckpt import format as ckpt_format
    cmd = [sys.executable, '-m', 'skypilot_tpu_torch.train.train_llama',
           '--model-size', '1b', '--seq-len', '1024', '--batch-size', '8',
           '--steps', '16', '--checkpoint-every', '4',
           '--checkpoint-dir', root]
    lines = []

    def run(args, watch):
        err = open(os.path.join(root, f'stderr{len(args)}.txt'), 'w+')
        start = time.perf_counter()
        proc = subprocess.Popen(cmd + args, stdout=subprocess.PIPE,
                                stderr=err, text=True, cwd=HERE)
        seen = {}
        try:
            for line in proc.stdout:
                line = line.rstrip('\n')
                lines.append(line)
                seen.setdefault(line, time.perf_counter() - start)
                if watch(line, proc):
                    break
            proc.stdout.close()
            rc = proc.wait(timeout=300)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        err.seek(0)
        return rc, seen, err.read()

    def stop_after_step_8(line, proc):
        if line != 'saved step 8':
            return False
        staging = ckpt_format.tmp_dir(root, 12)
        deadline = time.perf_counter() + 30
        while not os.path.isdir(staging) and time.perf_counter() < deadline:
            time.sleep(0.05)
        time.sleep(0.5)                  # inside the save of step 12
        proc.send_signal(signal_module.SIGTERM)
        return True

    rc1, seen1, err1 = run([], stop_after_step_8)
    committed = ckpt_format.latest_step(root)
    torn = [n for n in os.listdir(root) if n.startswith('.tmp.')]
    if rc1 != -signal_module.SIGTERM or committed is None or committed < 8:
        raise AssertionError(f'9b: first run rc {rc1}, newest committed '
                             f'step {committed}:\n' + '\n'.join(lines)
                             + err1[-3000:])
    rc2, seen2, err2 = run(['--resume', 'auto'], lambda line, proc: False)
    resumed = f'resumed from step {committed}'
    final = [line for line in seen2 if line.startswith('final: loss=')]
    if rc2 != 0 or resumed not in seen2 or 'saved step 16' not in seen2 \
            or not final or not np.isfinite(float(final[0].split()[1][5:])):
        raise AssertionError(f'9b: relaunch rc {rc2}, expected '
                             f'{resumed!r}:\n' + '\n'.join(lines)
                             + err2[-3000:])
    stats = {
        'card': CARD['line'], 'newest_committed_at_sigterm': committed,
        'torn_staging_left': torn,
        'first_run_s_to_saved_step_8': seen1['saved step 8'],
        'recovery_s_relaunch_to_resumed': seen2[resumed],
        'relaunch_s_to_final': seen2[final[0]], 'final': final[0],
    }
    log('  9b managed-job recovery: ' + json.dumps(stats))


# ---- phase 10: post-training ------------------------------------------------

def _checksum(tree):
    """Per leaf, the float64 sum and sum of squares of its elements
    (taken in slices of 2^26 elements, so a leaf is never copied whole
    in f64)."""
    from skypilot_tpu_torch.train.trainer import tree_leaves
    out = []
    for leaf in tree_leaves(tree):
        flat = leaf.detach().reshape(-1)
        acc = torch.zeros(2, dtype=torch.float64, device=leaf.device)
        for i in range(0, flat.numel(), 1 << 26):
            c = flat[i:i + (1 << 26)].double()
            acc += torch.stack([c.sum(), (c * c).sum()])
        out.append(tuple(acc.tolist()))
    return out


def _text(rng, n):
    letters = np.array(list('abcdefghijklmnopqrstuvwxyz   .,'))
    return ''.join(rng.choice(letters, n))


def _write_jsonl(path, rows):
    with open(path, 'w', encoding='utf-8') as f:
        for row in rows:
            f.write(json.dumps(row) + '\n')
    return path


def _post_train_data(root, seed=0):
    """{prompt, completion} and {prompt, chosen, rejected} JSONL files of
    random letters from a seed: SFT examples of ~2,300 bytes (a 2,048
    token row is full: 512 prompt bytes, the rest completion), DPO pairs
    of ~1,100 bytes, and short files for the debug-size entry points."""
    rng = np.random.default_rng(seed)
    sft = _write_jsonl(os.path.join(root, 'sft.jsonl'), [
        {'prompt': _text(rng, 512), 'completion': _text(rng, 1800)}
        for _ in range(16)])
    dpo = _write_jsonl(os.path.join(root, 'dpo.jsonl'), [
        {'prompt': _text(rng, 256), 'chosen': _text(rng, 900),
         'rejected': _text(rng, 900)} for _ in range(8)])
    small_sft = _write_jsonl(os.path.join(root, 'sft_small.jsonl'), [
        {'prompt': _text(rng, 40), 'completion': _text(rng, 80)}
        for _ in range(8)])
    small_dpo = _write_jsonl(os.path.join(root, 'dpo_small.jsonl'), [
        {'prompt': _text(rng, 30), 'chosen': _text(rng, 50),
         'rejected': _text(rng, 50)} for _ in range(8)])
    return sft, dpo, small_sft, small_dpo


def _encode(vocab_size):
    return lambda text: [b % vocab_size for b in text.encode('utf-8')]


def _adapted_elements(base, lcfg):
    from skypilot_tpu_torch.train import lora
    pattern = re.compile(lcfg.target_pattern)
    return sum(leaf.numel() for path, leaf in lora._flatten_with_paths(base)
               if pattern.search('/'.join(path)))


def lora_sft_path(base, cfg, data, counters, steps=6,
                  label='10a LoRA-SFT LLAMA3_8B', n=None,
                  n_note='no embedding'):
    """10a (and 11c): LoRA-SFT through Trainer.fit on the frozen bf16
    base: rank 16, alpha 32 on the attn target, 2 x 2048 tokens a step.
    The base never requires grad and its float64 checksum is unchanged
    after the steps; every B has moved from zero.  MFU counts (4N +
    2N_adapted) a token, N the parameters without the embedding unless
    `n` (described by `n_note`) is given.  Returns (launches, stats)."""
    from skypilot_tpu_torch.train import lora, sft, trainer
    tag = label.split()[0]
    lcfg = lora.LoraConfig(rank=16, alpha=32.0, targets='attn')
    leaves = trainer.tree_leaves(base)
    if any(t.requires_grad for t in leaves):
        raise AssertionError(f'{tag}: a base leaf requires grad')
    before = _checksum(base)
    adapters = lora.init_lora(base, lcfg,
                              torch.Generator(device='cuda').manual_seed(1))
    tr = trainer.Trainer(
        lora.wrap_loss(lambda p, b: sft.sft_loss_fn(p, b, cfg), base, lcfg),
        adapters, trainer.TrainConfig(learning_rate=1e-4, warmup_steps=2,
                                      total_steps=steps), device='cuda')
    masked = []

    def batches():
        for batch in sft.sft_batches(data, _encode(cfg.vocab_size), 2, 2048):
            masked.append(float(batch['loss_mask'].sum()))
            yield batch
    n = n or cfg.num_params() - cfg.vocab_size * cfg.d_model
    n_adapted = _adapted_elements(base, lcfg)
    torch.cuda.synchronize()
    resident_gb = torch.cuda.memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    _zero(counters)
    t0 = time.perf_counter()
    out = tr.fit(batches(), steps, log_every=0, tokens_per_batch=2 * 2048,
                 flops_per_token=4 * n + 2 * n_adapted,
                 peak_flops=BF16_FLOPS)
    wall = time.perf_counter() - t0
    launches = _counts(counters)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if any(t.requires_grad for t in leaves):
        raise AssertionError(f'{tag}: a base leaf requires grad after fit')
    if _checksum(base) != before:
        raise AssertionError(f'{tag}: the frozen base changed')
    unmoved = ['/'.join(p) for p, leaf in lora._flatten_with_paths(tr.params)
               if p[-1] == 'b' and not float(leaf.detach().abs().max()) > 0]
    if unmoved or not np.isfinite(out['loss']):
        raise AssertionError(f'{tag}: loss {out["loss"]}, B still zero: '
                             f'{unmoved}')
    share = sum(masked[:steps]) / (steps * 2 * 2048)
    stats = {
        'card': CARD['line'], 'layers': cfg.n_layers,
        'adapters': lora.split_shapes(tr.params),
        'tokens_per_step': 2 * 2048, 'steps': steps,
        'step_time_s': out['step_time_s'],
        'tokens_per_s': out['tokens_per_sec'],
        'completion_tokens_per_s': out['tokens_per_sec'] * share,
        'mfu': out['mfu'],
        'mfu_formula': f'(4N + 2N_adapted) x tokens/s / '
                       f'{BF16_FLOPS / 1e12:g}e12, '
                       f'N = {n} ({n_note}), N_adapted = {n_adapted}',
        'last_loss': out['loss'], 'grad_norm': out['grad_norm'],
        'fit_wall_s': wall, 'resident_gb_before_fit': resident_gb,
        'peak_memory_gb': peak_gb,
        'base_checksum_unchanged': True,
        'launches_per_step': {k: v / steps for k, v in launches.items()
                              if v},
    }
    log(f'  {label}: ' + json.dumps(stats))
    del tr, adapters
    return launches, stats


def lora_dpo_path(base, cfg, data, counters, steps=4, beta=0.1):
    """10b: LoRA-DPO on the same base, 2 pairs x 1024 tokens a step: the
    reference is the base (its passes under no_grad: K2 without its
    lse).  B = 0 at step 0, so the policy is the reference and the loss
    must be log 2 to f32 rounding (2 ulps).  Returns (launches, stats)."""
    import math
    from skypilot_tpu_torch.train import dpo, lora, trainer
    lcfg = lora.LoraConfig(rank=16, alpha=32.0, targets='attn')
    adapters = lora.init_lora(base, lcfg,
                              torch.Generator(device='cuda').manual_seed(2))

    def loss(ad, batch):
        return dpo.dpo_loss_fn(lora.apply_lora(base, ad, lcfg), base, batch,
                               cfg, beta=beta)
    tr = trainer.Trainer(loss, adapters, trainer.TrainConfig(
        learning_rate=1e-4, warmup_steps=1, total_steps=steps,
        weight_decay=0.0), device='cuda')
    batches = dpo.dpo_batches(data, _encode(cfg.vocab_size), 2, 1024)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero(counters)
    t0 = time.perf_counter()
    losses = [float(tr.run_step(next(batches))['loss'])
              for _ in range(steps)]
    wall = time.perf_counter() - t0
    launches = _counts(counters)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    batch = {k: torch.as_tensor(v, device='cuda')
             for k, v in next(batches).items()}
    metrics = {k: float(v) for k, v in dpo.dpo_metrics(
        lora.apply_lora(base, tr.params, lcfg), base, batch, cfg,
        beta=beta).items()}
    log2 = float(np.float32(math.log(2)))
    if abs(losses[0] - log2) > 2 * 2 ** -24 or not np.all(
            np.isfinite(losses)):
        raise AssertionError(f'10b: step-0 loss {losses[0]!r} is not log 2 '
                             f'({log2!r}): the reference and the policy '
                             f'passes compute differently; losses {losses}')
    no_lse = launches['flash_attention'] - launches['flash_attention[lse]']
    if no_lse <= 0:
        raise AssertionError('10b: K2 never ran without its lse (the '
                             'reference passes)')
    stats = {'card': CARD['line'], 'pairs_per_step': 2, 'seq_len': 1024,
             'beta': beta, 'losses': losses, 'step0_minus_log2':
             losses[0] - log2, 'steps_wall_s': wall,
             'step_s': wall / steps, 'dpo_metrics': metrics,
             'peak_memory_gb': peak_gb, 'k2_no_lse_launches': no_lse,
             'launches_per_step': {k: v / steps for k, v in
                                   launches.items() if v}}
    log('  10b LoRA-DPO LLAMA3_8B: ' + json.dumps(stats))
    del tr, adapters
    return launches, stats


def grpo_path(counters, steps=3):
    """10c: GRPO on LLAMA_1B at full size (group 8, 2 prompts a step,
    max_prompt_len 64, 32 new tokens, temperature 1, kl_coef 0.05, the
    entry point's token-band reward, lr 1e-4 as train_rl's default).  A
    greedy Generator over the Trainer's live tensors, its graphs
    captured before the first step, must after the steps give the tokens
    of a fresh Generator over a clone of the Trainer's params.  Returns
    (launches, stats)."""
    from skypilot_tpu_torch.infer.engine import Generator, GeneratorConfig
    from skypilot_tpu_torch.models import llama
    from skypilot_tpu_torch.train import rl
    from skypilot_tpu_torch.train.train_rl import make_rewards
    from skypilot_tpu_torch.train.trainer import tree_leaves, tree_map
    cfg = llama.LLAMA_1B
    params = llama.init_params(
        cfg, torch.Generator(device='cuda').manual_seed(0), 'cuda')
    tr = rl.GrpoTrainer(
        params, cfg, make_rewards(cfg.vocab_size)['token-band'],
        group_size=8, max_new_tokens=32, max_prompt_len=64, temperature=1.0,
        learning_rate=1e-4, kl_coef=0.05, total_steps=steps, device='cuda')
    del params
    initial = [t.detach().clone() for t in tree_leaves(tr.trainer.params)]
    gen_config = GeneratorConfig(max_seq_len=tr._gen_config.max_seq_len,
                                 batch_size=8)
    live = Generator(tr.trainer.params, cfg, gen_config, device='cuda')
    probe = [[(7 * (i + 3)) % cfg.vocab_size, 17, 42 + i] for i in range(8)]
    with torch.no_grad():
        before = live.generate(probe, max_new_tokens=32)
    prompts = [[(11 * (i + 1)) % cfg.vocab_size,
                (13 * (i + 1)) % cfg.vocab_size] for i in range(2)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero(counters)
    history = [tr.step(prompts) for _ in range(steps)]
    launches = _counts(counters)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if not all(np.isfinite(m['loss']) for m in history):
        raise AssertionError(f'10c: losses {history}')
    moved = sum(not torch.equal(a, b) for a, b in
                zip(initial, tree_leaves(tr.trainer.params)))
    if not moved:
        raise AssertionError('10c: the policy never changed')
    clone = tree_map(lambda t: t.detach().clone(), tr.trainer.params)
    with torch.no_grad():
        after = live.generate(probe, max_new_tokens=32)
        fresh = Generator(clone, cfg, gen_config,
                          device='cuda').generate(probe, max_new_tokens=32)
    _same_tokens('10c: the live Generator after the updates vs a fresh one '
                 'over a clone', after, fresh)
    stats = {
        'card': CARD['line'], 'group': 8, 'prompts_per_step': 2,
        'new_tokens': 32, 'kl_coef': 0.05, 'steps': steps,
        'rollout_s': [m['rollout_s'] for m in history],
        'update_s': [m['update_s'] for m in history],
        'reward_mean': [m['reward_mean'] for m in history],
        'loss': [m['loss'] for m in history],
        'leaves_moved': f'{moved} of {len(initial)}',
        'live_greedy_changed_by_the_updates': after != before,
        'live_generator_graph_replays': live.graphs.replays
        if live.graphs is not None else 0,
        'peak_memory_gb': peak_gb,
        'launches_per_step': {k: v / steps for k, v in launches.items()
                              if v},
    }
    log('  10c GRPO LLAMA_1B: ' + json.dumps(stats))
    tr.close()
    del tr, live, clone, initial
    return launches, stats


def _losses(stdout, prefix):
    return [float(line.split('loss=')[1].split()[0])
            for line in stdout.splitlines() if line.startswith(prefix)]


def entry_points_path(root, small_sft, small_dpo):
    """10d: train_sft (LoRA, checkpoint, merge), train_dpo (LoRA) and
    train_rl at debug size as child processes, run side by side.  The
    merged file must equal, bitwise, merge_lora of the adapters restored
    from train_sft's checkpoint, and give the same greedy tokens through
    the Generator; all three must finish with finite losses."""
    from skypilot_tpu_torch.ckpt import format as ckpt_format
    from skypilot_tpu_torch.infer.engine import Generator, GeneratorConfig
    from skypilot_tpu_torch.models import llama
    from skypilot_tpu_torch.train import lora, sft, trainer
    ckpt, merged = os.path.join(root, 'ckpt'), os.path.join(root, 'merge')
    mod = 'skypilot_tpu_torch.train.'
    cmds = {
        'sft': [mod + 'train_sft', '--data-file', small_sft, '--seq-len',
                '128', '--steps', '4', '--log-every', '1', '--lora-rank',
                '8', '--checkpoint-dir', ckpt, '--merge-save', merged],
        'dpo': [mod + 'train_dpo', '--data-file', small_dpo, '--seq-len',
                '96', '--steps', '3', '--log-every', '1', '--lora-rank',
                '8'],
        'rl': [mod + 'train_rl', '--model-size', 'debug', '--steps', '3'],
    }
    t0 = time.perf_counter()
    procs = {k: subprocess.Popen([sys.executable, '-m'] + v, cwd=HERE,
                                 stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE, text=True)
             for k, v in cmds.items()}
    outs = {}
    try:
        for key, proc in procs.items():
            out, err = proc.communicate(timeout=300)
            outs[key] = (proc.returncode, out, err,
                         time.perf_counter() - t0)
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    for key, (rc, out, err, _) in outs.items():
        prefix = 'rl step ' if key == 'rl' else 'step '
        losses = _losses(out, prefix)
        if rc != 0 or len(losses) != 3 + (key == 'sft') or not np.all(
                np.isfinite(losses)):
            raise AssertionError(f'10d {key}: rc {rc}\n{out}\n{err[-3000:]}')
    cfg = llama.LLAMA_DEBUG
    base = llama.init_params(cfg, torch.Generator(device='cuda').manual_seed(0),
                             'cuda')
    lcfg = lora.LoraConfig(rank=8)
    tr = trainer.Trainer(
        lora.wrap_loss(lambda p, b: sft.sft_loss_fn(p, b, cfg), base, lcfg),
        lora.init_lora(base, lcfg,
                       torch.Generator(device='cuda').manual_seed(1)),
        device='cuda')
    if tr.restore_latest(ckpt) != 4:
        raise AssertionError('10d: train_sft did not commit step 4')
    want = lora.merge_lora(base, tr.params, lcfg)
    got = ckpt_format.restore_pytree(os.path.join(merged, 'merged'), 0,
                                     {'params': want})['params']
    got_leaves = trainer.tree_leaves(got)
    want_leaves = trainer.tree_leaves(want)
    if not all(torch.equal(g, w.cpu()) for g, w in
               zip(got_leaves, want_leaves)):
        raise AssertionError('10d: the merged file differs from merge_lora '
                             'of the restored adapters')
    gen_config = GeneratorConfig(max_seq_len=128, batch_size=2)
    prompts = [[5, 9, 11], [7, 3, 300, 2]]
    with torch.no_grad():
        tokens = [Generator(tree, cfg, gen_config, device='cuda').generate(
            prompts, max_new_tokens=16)
            for tree in (trainer.tree_map(lambda t: t.cuda(), got), want)]
    _same_tokens('10d: greedy tokens of the merged file vs the in-process '
                 'merge', tokens[0], tokens[1])
    stats = {'card': CARD['line'],
             'children_s': {k: v[3] for k, v in outs.items()},
             'sft_losses': _losses(outs['sft'][1], 'step '),
             'dpo_losses': _losses(outs['dpo'][1], 'step '),
             'rl_losses': _losses(outs['rl'][1], 'rl step '),
             'merged_bitwise': True, 'greedy_tokens': tokens[0]}
    log('  10d entry points: ' + json.dumps(stats))
    tr.close()


# ---- phase 11: Mixtral-8x7B widths -----------------------------------------

def mixtral_config(n_layers, **overrides):
    """Mixtral-8x7B-v0.1's published widths, from its config.json on the
    Hugging Face hub (mistralai/Mixtral-8x7B-v0.1): vocab 32000, hidden
    4096, intermediate 14336, 32 heads over 8 KV heads (head_dim 128), 8
    local experts and 2 a token, rope_theta 1e6, rms_norm_eps 1e-5,
    max_position_embeddings 32768, router_aux_loss_coef 0.02; and
    router_impl 'dense', as skypilot_tpu/models/convert.py sets it for a
    converted Mixtral.  bf16, remat.  The depth is the caller's: the
    published 32 layers are 46.70B parameters, 93.4 GB in bf16 (the
    expert banks alone 90.2 GB, which int8 weights leave in bf16), past
    the card's 80 GB."""
    from skypilot_tpu_torch.models import moe
    return dataclasses.replace(moe.MoeConfig(
        vocab_size=32000, d_model=4096, n_layers=n_layers, n_heads=32,
        n_kv_heads=8, d_ff=14336, max_seq_len=32768, rope_theta=1e6,
        norm_eps=1e-5, n_experts=8, top_k=2, router_aux_weight=0.02,
        router_impl='dense', dtype=torch.bfloat16, remat=True), **overrides)


def moe_active_params(cfg):
    """(The parameters a token runs through in the layers: attention,
    the router and top_k experts a layer; the lm_head's).  The embedding
    is a row gather.  The dense formulation's unchosen experts, the
    capacity slots' padding and the dispatch/combine products are
    overhead, not model FLOPs."""
    d, hd = cfg.d_model, cfg.head_dim
    attn = 2 * d * cfg.n_heads * hd + 2 * d * cfg.n_kv_heads * hd
    layer = attn + d * cfg.n_experts + cfg.top_k * 3 * d * cfg.d_ff
    return cfg.n_layers * layer, d * cfg.vocab_size


def streamed_bytes(tree, key=''):
    """Bytes a decode step streams from the parameter tree: every leaf
    but the embedding table (a row gather)."""
    if isinstance(tree, dict):
        return sum(streamed_bytes(v, k) for k, v in tree.items())
    return 0 if key == 'embed' else tree.numel() * tree.element_size()


def bounded_serve_path(label, params, cfg, counters, model, **extra):
    """Phase 5's 8 requests (one burst, 48 new tokens each, greedy)
    through the replica and the ContinuousBatcher's CUDA graphs on the
    pooled plane, batch 8, max_seq_len 2048, prefill_chunk 256,
    decode_chunk 16 (11a, 12a, 12b; with `extra` GeneratorConfig fields,
    12c).  Prints, beside serve_path's stats, the decode step's bound: a
    step streams every parameter but the embedding (a row gather), so it
    takes at least those bytes over 3.35 TB/s (for 11a's dense
    formulation, every bank).  Returns (launches, stats, each request's
    tokens)."""
    from skypilot_tpu_torch.infer.engine import GeneratorConfig
    gen_config = GeneratorConfig(max_seq_len=2048, batch_size=8,
                                 prefill_chunk=256, **extra)
    launches, _, tokens, stats = serve_path(label, params, gen_config,
                                            counters, cfg=cfg, model=model)
    nbytes = streamed_bytes(params)
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    # Decode steps of the run: every step runs 8 slots, live or not.
    steps = stats['decode_tokens'] / stats['live_slot_share'] / 8
    step_ms = (stats['decode_seconds'] - stats['graph_capture_s']) \
        / steps * 1e3
    bound = {'card': CARD['line'], 'streamed_gb_a_step': nbytes / 1e9,
             'step_bound_ms': bound_ms,
             'batch8_tokens_per_s_bound': 8 / bound_ms * 1e3,
             'decode_steps': steps, 'step_ms_without_capture': step_ms,
             'step_share_of_bound': bound_ms / step_ms}
    log(f'  {label.split()[0]} decode bound (bytes / 3.35 TB/s): '
        + json.dumps(bound))
    return launches, dict(stats, **bound), tokens


def mixtral_train_path(counters, steps=6, batch=2, seq=4096):
    """11b: full-parameter Trainer.fit of moe.loss_fn through
    train_moe.make_trainer at Mixtral's widths, depth 2, router_impl
    'capacity', remat, 2 x 4096 tokens a step (bf16 params, grads, mu
    and nu: 8 bytes a parameter).  Fails unless the first and last
    losses and the router aux losses are finite.  Prints step time,
    tokens/s, MFU = 6 N_active x tokens/s / 989e12 with and without the
    lm_head, peak memory, launches a step, the first and last loss and
    the aux loss before and after.  Returns (launches, stats)."""
    from skypilot_tpu_torch.models import llama, moe
    from skypilot_tpu_torch.train import train_moe, trainer

    cfg = mixtral_config(2, router_impl='capacity')
    tr = train_moe.make_trainer(cfg, steps, 'cuda')
    first = torch.as_tensor(next(trainer.synthetic_batches(
        batch, seq, cfg.vocab_size))['tokens'], device='cuda')

    def loss_and_aux():
        with torch.no_grad():
            logits, aux = moe.forward(tr.params, first[:, :-1], cfg)
            ce = -llama.token_logprobs(logits, first[:, 1:]).mean()
            return float(ce + cfg.router_aux_weight * aux), float(aux)
    first_loss, first_aux = loss_and_aux()
    n_layers, n_head = moe_active_params(cfg)
    n_all = cfg.num_params()
    torch.cuda.synchronize()
    resident_gb = torch.cuda.memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    _zero(counters)
    t0 = time.perf_counter()
    out = tr.fit(trainer.synthetic_batches(batch, seq, cfg.vocab_size),
                 steps, log_every=0, tokens_per_batch=batch * seq,
                 flops_per_token=6 * (n_layers + n_head),
                 peak_flops=BF16_FLOPS)
    wall = time.perf_counter() - t0
    launches = _counts(counters)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    last_aux = loss_and_aux()[1]
    if not all(np.isfinite([first_loss, out['loss'], first_aux, last_aux])):
        raise AssertionError(f'11b: loss {first_loss} -> {out["loss"]}, '
                             f'aux {first_aux} -> {last_aux}')
    stats = {
        'card': CARD['line'], 'layers': cfg.n_layers,
        'params_b': n_all / 1e9, 'state_gb': n_all * 8 / 1e9,
        'active_params_b': (n_layers + n_head) / 1e9,
        'tokens_per_step': batch * seq, 'steps': steps,
        'step_time_s': out['step_time_s'],
        'tokens_per_s': out['tokens_per_sec'],
        'mfu_6n_active': out['mfu'],
        'mfu_6n_active_without_lm_head': (6 * n_layers * out['tokens_per_sec']
                                          / BF16_FLOPS),
        'mfu_formula': f'6 N_active x tokens/s / {BF16_FLOPS / 1e12:g}e12, '
                       f'N_active = {n_layers} (attention, router, top_k = '
                       f'{cfg.top_k} experts a layer) + {n_head} (lm_head)',
        'first_loss': first_loss, 'last_loss': out['loss'],
        'router_aux_first': first_aux, 'router_aux_last': last_aux,
        'grad_norm': out['grad_norm'], 'fit_wall_s': wall,
        'resident_gb_before_fit': resident_gb, 'peak_memory_gb': peak_gb,
        'launches_per_step': {k: v / steps for k, v in launches.items()
                              if v},
    }
    log('  11b train Mixtral widths, 2 layers, capacity: '
        + json.dumps(stats))
    tr.close()
    del tr
    gc.collect()
    torch.cuda.empty_cache()
    return launches, stats


def mixtral_path(counters, paths):
    """Phase 11 on one 16-layer base: (a) served; (c) LoRA-SFT of it once
    the batcher and its graph pool are released (so the base is drawn and
    freed once); then (b), a 2-layer model of its own, trained."""
    from skypilot_tpu_torch.models import moe
    cfg = mixtral_config(16)
    t0 = time.perf_counter()
    base = moe.init_params(cfg, torch.Generator(device='cuda').manual_seed(0),
                           'cuda')
    torch.cuda.synchronize()
    log(f'  Mixtral widths bf16 random weights, {cfg.n_layers} of 32 layers: '
        f'{cfg.num_params() / 1e9:.2f}B params, '
        f'{torch.cuda.memory_allocated() / 1e9:.2f} GB, in '
        f'{time.perf_counter() - t0:.1f} s')
    sub = time.perf_counter()
    paths['11a'], _, _ = bounded_serve_path(
        '11a Mixtral widths, 16 layers', base, cfg, counters,
        'mixtral-8x7b-16-layers')
    log(f'  11a: {time.perf_counter() - sub:.1f} s')
    gc.collect()
    torch.cuda.empty_cache()
    scratch = tempfile.mkdtemp(prefix='chip_smoke_moe_')
    try:
        sft_data = _post_train_data(scratch)[0]
        sub = time.perf_counter()
        n_layers, n_head = moe_active_params(cfg)
        paths['11c'], _ = lora_sft_path(
            base, dataclasses.replace(cfg, loss_chunk=512), sft_data,
            counters, steps=4, label='11c LoRA-SFT Mixtral widths, 16 layers',
            n=n_layers + n_head,
            n_note=f'active: attention, router and top_k = {cfg.top_k} '
                   f'experts a layer, and the lm_head; the dense '
                   f'formulation runs E/top_k = '
                   f'{cfg.n_experts // cfg.top_k}x the expert FLOPs counted')
        log(f'  11c: {time.perf_counter() - sub:.1f} s')
    finally:
        shutil.rmtree(scratch, ignore_errors=True)
    del base
    gc.collect()
    torch.cuda.empty_cache()
    sub = time.perf_counter()
    paths['11b'], _ = mixtral_train_path(counters)
    log(f'  11b: {time.perf_counter() - sub:.1f} s')


# ---- phase 12: HF checkpoints ---------------------------------------------

# Published configs, typed from each model's config.json on the Hugging
# Face hub (google/gemma-7b and Qwen/Qwen2.5-1.5B); nothing is fetched.
GEMMA_7B = {
    'architectures': ['GemmaForCausalLM'], 'model_type': 'gemma',
    'vocab_size': 256000, 'hidden_size': 3072, 'intermediate_size': 24576,
    'num_hidden_layers': 28, 'num_attention_heads': 16,
    'num_key_value_heads': 16, 'head_dim': 256, 'hidden_act': 'gelu',
    'rms_norm_eps': 1e-6, 'rope_theta': 10000.0, 'rope_scaling': None,
    'max_position_embeddings': 8192, 'attention_bias': False,
    'tie_word_embeddings': True, 'bos_token_id': 2, 'eos_token_id': 1,
    'pad_token_id': 0, 'torch_dtype': 'bfloat16'}
QWEN25_1_5B = {
    'architectures': ['Qwen2ForCausalLM'], 'model_type': 'qwen2',
    'vocab_size': 151936, 'hidden_size': 1536, 'intermediate_size': 8960,
    'num_hidden_layers': 28, 'num_attention_heads': 12,
    'num_key_value_heads': 2, 'hidden_act': 'silu', 'rms_norm_eps': 1e-6,
    'rope_theta': 1000000.0, 'max_position_embeddings': 131072,
    'max_window_layers': 28, 'sliding_window': 131072,
    'use_sliding_window': False, 'use_mrope': False,
    'tie_word_embeddings': True, 'bos_token_id': 151643,
    'eos_token_id': 151643, 'torch_dtype': 'bfloat16'}

_ST_DTYPES = {torch.bfloat16: 'BF16', torch.float16: 'F16',
              torch.float32: 'F32'}


def hf_tensor_specs(hf_config):
    """[(name, shape)] of an HF checkpoint of the llama, mistral, gemma,
    qwen2 or mixtral family, in HF's layout ((out, in) linears), in the
    order HF's modules hold them; no lm_head.weight when the embeddings
    are tied."""
    c = hf_config
    d, ff, vocab = c['hidden_size'], c['intermediate_size'], c['vocab_size']
    hd = c.get('head_dim') or d // c['num_attention_heads']
    q, kv = c['num_attention_heads'] * hd, c['num_key_value_heads'] * hd
    specs = [('model.embed_tokens.weight', (vocab, d))]
    for i in range(c['num_hidden_layers']):
        p = f'model.layers.{i}.'
        specs += [(p + 'self_attn.q_proj.weight', (q, d)),
                  (p + 'self_attn.k_proj.weight', (kv, d)),
                  (p + 'self_attn.v_proj.weight', (kv, d)),
                  (p + 'self_attn.o_proj.weight', (d, q))]
        if c['model_type'] == 'qwen2':
            specs += [(p + 'self_attn.q_proj.bias', (q,)),
                      (p + 'self_attn.k_proj.bias', (kv,)),
                      (p + 'self_attn.v_proj.bias', (kv,))]
        if c['model_type'] == 'mixtral':
            m = p + 'block_sparse_moe.'
            specs.append((m + 'gate.weight', (c['num_local_experts'], d)))
            for e in range(c['num_local_experts']):
                specs += [(f'{m}experts.{e}.w1.weight', (ff, d)),
                          (f'{m}experts.{e}.w2.weight', (d, ff)),
                          (f'{m}experts.{e}.w3.weight', (ff, d))]
        else:
            specs += [(p + 'mlp.gate_proj.weight', (ff, d)),
                      (p + 'mlp.up_proj.weight', (ff, d)),
                      (p + 'mlp.down_proj.weight', (d, ff))]
        specs += [(p + 'input_layernorm.weight', (d,)),
                  (p + 'post_attention_layernorm.weight', (d,))]
    specs.append(('model.norm.weight', (d,)))
    if not c.get('tie_word_embeddings', False):
        specs.append(('lm_head.weight', (vocab, d)))
    return specs


def draw_hf_tensor(name, shape, seed, dtype, device, gemma=False):
    """One random tensor of a checkpoint, a function of (seed, name) on a
    given device: linears at fan_in^-0.5, the embedding at 0.02, biases
    at 0.02, norms 1 + N(0, 0.1), stored as w - 1 (N(0, 0.1)) for Gemma,
    whose runtime scale is 1 + w."""
    gen = torch.Generator(device=device).manual_seed(
        seed * 1_000_003 + zlib.crc32(name.encode()))
    x = torch.randn(shape, generator=gen, device=device)
    if name.endswith('norm.weight'):
        x = x * 0.1 + (0.0 if gemma else 1.0)
    elif name.endswith('bias') or name.endswith('embed_tokens.weight'):
        x = x * 0.02
    else:
        x = x * shape[-1] ** -0.5
    return x.to(dtype)


def write_hf_checkpoint(directory, hf_config, make, dtype=torch.bfloat16,
                        shard_bytes=None):
    """Write a checkpoint directory in HF's layout: config.json, and the
    tensors of hf_tensor_specs(hf_config) in `dtype`, `make(name, shape)`
    drawing each as it is written (one tensor on the host at a time), as
    safetensors files: one, or shards of at most `shard_bytes` with a
    model.safetensors.index.json.  The format by hand: an 8-byte
    little-endian header length, the JSON header (padded with spaces to
    8 bytes) whose data_offsets count from its end, then the raw
    little-endian data.  Returns the bytes of tensor data written."""
    os.makedirs(directory, exist_ok=True)
    with open(os.path.join(directory, 'config.json'), 'w',
              encoding='utf-8') as f:
        json.dump(hf_config, f, indent=2)
    itemsize = torch.empty((), dtype=dtype).element_size()
    shards, size = [[]], 0
    for name, shape in hf_tensor_specs(hf_config):
        n = int(np.prod(shape)) * itemsize
        if shards[-1] and shard_bytes and size + n > shard_bytes:
            shards.append([])
            size = 0
        shards[-1].append((name, shape, n))
        size += n
    weight_map, total = {}, 0
    for s, shard in enumerate(shards):
        fname = ('model.safetensors' if len(shards) == 1 else
                 f'model-{s + 1:05d}-of-{len(shards):05d}.safetensors')
        header, offset = {'__metadata__': {'format': 'pt'}}, 0
        for name, shape, n in shard:
            header[name] = {'dtype': _ST_DTYPES[dtype], 'shape': list(shape),
                            'data_offsets': [offset, offset + n]}
            offset += n
        raw = json.dumps(header).encode()
        raw += b' ' * (-len(raw) % 8)
        with open(os.path.join(directory, fname), 'wb') as f:
            f.write(struct.pack('<Q', len(raw)))
            f.write(raw)
            for name, shape, n in shard:
                t = make(name, shape).to('cpu', dtype).contiguous()
                if tuple(t.shape) != tuple(shape):
                    raise AssertionError(f'{name}: drew {tuple(t.shape)}')
                f.write(t.reshape(-1).view(torch.uint8).numpy())
                weight_map[name] = fname
                total += n
    if len(shards) > 1:
        with open(os.path.join(directory, 'model.safetensors.index.json'),
                  'w', encoding='utf-8') as f:
            json.dump({'metadata': {'total_size': total},
                       'weight_map': weight_map}, f, indent=2)
    return total


# HF name -> (tree path, transposed) of the leaf a tensor lands in; the
# groups of the pattern are the layer and, for an expert, the expert.
HF_TO_TREE = [
    (r'model\.embed_tokens\.weight', ('embed',), False),
    (r'model\.layers\.(\d+)\.input_layernorm\.weight', ('layers', 'ln1'),
     False),
    (r'model\.layers\.(\d+)\.post_attention_layernorm\.weight',
     ('layers', 'ln2'), False),
    (r'model\.layers\.(\d+)\.self_attn\.([qkvo])_proj\.weight',
     ('layers', 'attn', 'w{}'), True),
    (r'model\.layers\.(\d+)\.self_attn\.([qkv])_proj\.bias',
     ('layers', 'attn', 'b{}'), False),
    (r'model\.layers\.(\d+)\.mlp\.(gate|up|down)_proj\.weight',
     ('layers', 'mlp', 'w_{}'), True),
    (r'model\.layers\.(\d+)\.block_sparse_moe\.gate\.weight',
     ('layers', 'moe', 'router'), True),
    (r'model\.layers\.(\d+)\.block_sparse_moe\.experts\.(\d+)\.w([123])'
     r'\.weight', ('layers', 'moe', None), True),
    (r'model\.norm\.weight', ('final_norm',), False),
    (r'lm_head\.weight', ('lm_head',), True),
]
_EXPERT_LEAF = {'1': 'w_gate', '3': 'w_up', '2': 'w_down'}


def _bits_sum(t):
    """A checksum of a tensor's bits: the int64 sum of its 16- or 32-bit
    words (transposes and stacking keep it), taken in slices of 2^26
    words so no int64 copy of a whole leaf is made."""
    words = torch.int16 if t.element_size() == 2 else torch.int32
    flat = t.contiguous().view(words).reshape(-1)
    return sum(int(flat[i:i + (1 << 26)].sum(dtype=torch.int64))
               for i in range(0, flat.numel(), 1 << 26))


def verify_hf_leaves(tree, hf_config, seed, dtype, device):
    """Every leaf of a converted tree against the tensors the writer drew
    (drawn again, one at a time, on `device`): each tensor's slice
    bitwise equal to its expected value (transposed for a linear, the
    norm offset 1 added in f32 and rounded once for Gemma), a tied
    lm_head bitwise the embedding's transpose, and each leaf's checksum
    equal to the sum of its expected tensors'.  Returns the checksums."""
    gemma = hf_config['model_type'] == 'gemma'
    want = {}
    for name, shape in hf_tensor_specs(hf_config):
        x = draw_hf_tensor(name, shape, seed, dtype, device, gemma)
        for pattern, path, transposed in HF_TO_TREE:
            m = re.fullmatch(pattern, name)
            if m:
                break
        else:
            raise AssertionError(f'{name}: no leaf for it')
        groups = m.groups()
        if path[-1] is None:
            path = path[:-1] + (_EXPERT_LEAF[groups[2]],)
            index = (int(groups[0]), int(groups[1]))
        else:
            if '{}' in path[-1]:
                path = path[:-1] + (path[-1].format(groups[1]),)
            index = (int(groups[0]),) if groups else ()
        if gemma and name.endswith('norm.weight'):
            x = (x.float() + 1.0).to(dtype)
        expected = x.T if transposed else x
        leaf = tree
        for key in path:
            leaf = leaf[key]
        if not torch.equal(leaf[index], expected):
            raise AssertionError(f'{name}: its slice of {"/".join(path)} is '
                                 f'not bitwise the tensor drawn')
        key = '/'.join(path)
        want[key] = want.get(key, 0) + _bits_sum(expected)
        del x, expected
    if 'lm_head' not in want:     # tied: the transposed embedding
        if not torch.equal(tree['lm_head'], tree['embed'].T):
            raise AssertionError('tied lm_head is not the embedding^T')
        want['lm_head'] = want['embed']
    from skypilot_tpu_torch.train.trainer import tree_leaves
    got = {}

    def walk(node, path):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, path + [k])
            else:
                got['/'.join(path + [k])] = _bits_sum(v)
    walk(tree, [])
    if got != want:
        raise AssertionError(f'leaf checksums differ: {got} vs {want}')
    if len(got) != len(tree_leaves(tree)):
        raise AssertionError('a leaf was not checked')
    return got


def _vm_rss():
    """The process's resident set in bytes (/proc/self/status VmRSS)."""
    with open('/proc/self/status', encoding='ascii') as f:
        for line in f:
            if line.startswith('VmRSS:'):
                return int(line.split()[1]) * 1024
    raise AssertionError('/proc/self/status reports no VmRSS')


class RssPeak:
    """The host's peak resident set during a block: VmRSS sampled every
    2 ms by a thread, against VmRSS at the start."""

    def __enter__(self):
        self.start = self.peak = _vm_rss()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._sample, daemon=True)
        self._thread.start()
        return self

    def _sample(self):
        while not self._stop.wait(0.002):
            self.peak = max(self.peak, _vm_rss())

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()
        self.peak = max(self.peak, _vm_rss())
        return False

    def stats(self):
        return {'host_rss_start_gb': self.start / 1e9,
                'host_peak_growth_gb_sampled': (self.peak - self.start) / 1e9}


def hf_load_path(label, hf_config, root, seed=0, dtype=torch.bfloat16,
                 shard_bytes=5 << 30):
    """Write a random checkpoint of `hf_config` in HF's layout under
    root (drawn on the card from `seed`; several shards with an index
    past `shard_bytes`), then load it with convert.load_hf_model onto the
    card.  Fails first if the disk under root is short, naming the bytes
    it needs.  Returns (params, config, directory, stats): seconds, GB,
    GB/s, the host's peak RSS growth, the device's peak, the leaf
    checksums (verify_hf_leaves)."""
    from skypilot_tpu_torch.models import convert
    from skypilot_tpu_torch.train import trainer
    itemsize = torch.empty((), dtype=dtype).element_size()
    nbytes = sum(int(np.prod(s)) for _, s in
                 hf_tensor_specs(hf_config)) * itemsize
    need = nbytes + (1 << 30)
    free = shutil.disk_usage(root).free
    if free < need:
        raise AssertionError(f'{label} needs {need} bytes free under {root} '
                             f'for its checkpoint, {free} are free')
    directory = os.path.join(root, label.split()[0])
    gemma = hf_config['model_type'] == 'gemma'
    t0 = time.perf_counter()
    write_hf_checkpoint(
        directory, hf_config,
        lambda name, shape: draw_hf_tensor(name, shape, seed, dtype, 'cuda',
                                           gemma),
        dtype, shard_bytes)
    write_s = time.perf_counter() - t0
    files = sorted(os.listdir(directory))
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    dev0 = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    with RssPeak() as rss:
        t0 = time.perf_counter()
        params, cfg = convert.load_hf_model(directory, dtype=dtype,
                                            device='cuda')
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
    device_peak = torch.cuda.max_memory_allocated()
    tree_bytes = sum(t.numel() * t.element_size()
                     for t in trainer.tree_leaves(params))
    t0 = time.perf_counter()
    checksums = verify_hf_leaves(params, hf_config, seed, dtype, 'cuda')
    stats = {
        'card': CARD['line'], 'files': files,
        'file_params_b': nbytes / itemsize / 1e9, 'file_gb': nbytes / 1e9,
        'tree_params_b': cfg.num_params() / 1e9, 'tree_gb': tree_bytes / 1e9,
        'write_s': write_s, 'load_s': load_s,
        'load_gb_per_s': nbytes / load_s / 1e9,
        **rss.stats(),
        'host_peak_growth_below_model': rss.peak - rss.start < nbytes,
        'device_gb_before': dev0 / 1e9,
        'device_peak_gb_during_load': device_peak / 1e9,
        'device_resident_gb_after': torch.cuda.memory_allocated() / 1e9,
        'leaves_bitwise': len(checksums), 'verify_s': time.perf_counter() - t0,
        'checksum_total': sum(checksums.values()),
    }
    if not stats['host_peak_growth_below_model']:
        raise AssertionError(f'{label}: the host grew by '
                             f'{(rss.peak - rss.start) / 1e9:.2f} GB during '
                             f'the load, the model is {nbytes / 1e9:.2f}')
    log(f'  {label} load: ' + json.dumps(stats))
    return params, cfg, directory, stats


def gemma_path(counters, paths, root):
    """12a: Gemma-7B's published widths at full depth from a checkpoint
    the script writes (17.08 GB, bf16, tied, norms stored as w - 1),
    loaded by convert.load_hf_model and served as phase 5 serves
    LLAMA3_8B; the directory is deleted when 12a ends.  12c: the same
    weights served with speculative verify and the fused prefill lane
    (gemma_spec_path)."""
    try:
        params, cfg, _, load = hf_load_path('12a Gemma-7B', GEMMA_7B, root)
        paths['12a'], serve, plain = bounded_serve_path(
            '12a Gemma-7B', params, cfg, counters, 'gemma-7b')
    finally:
        shutil.rmtree(os.path.join(root, '12a'), ignore_errors=True)
    t0 = time.perf_counter()
    gemma_spec_path(params, cfg, counters, paths, plain)
    log(f'  12c: {time.perf_counter() - t0:.1f} s')
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return load, serve


# 12c's two arms on 12a's weights: phase 6's speculation and fused lane
# (spec_k 12, fuse_budget 264) in bf16 and with int8 KV (int8 weights
# are left out: their per-call bf16 copy would cost the run's time).
GEMMA_SPEC = dict(spec_k=12, fuse_budget=264)
GEMMA_SPEC_ARMS = (('12c-bf16', {}), ('12c-int8', {'kv_cache_dtype': 'int8'}))


def _agreeing_prefix(got, want):
    """Each request's share of tokens equal to `want`'s before the first
    difference (bf16 rounds differently on another schedule)."""
    shares = []
    for g, w in zip(got, want):
        n = next((i for i, (a, b) in enumerate(zip(g, w)) if a != b),
                 min(len(g), len(w)))
        shares.append(n / max(len(w), 1))
    return shares


def gemma_spec_path(params, cfg, counters, paths, plain):
    """12c: Gemma-7B (12a's loaded weights, all 28 layers) serves phase
    5's 8 requests through the replica and the batcher's CUDA graphs with
    GEMMA_SPEC, in each of GEMMA_SPEC_ARMS.  Fails unless every K4 launch
    of both wrappers took the tensor-core route (K4 at hd 256), drafts
    were proposed, the fuse policy ran steps, and every graph key was
    captured once with chunks replayed.  Prints the accept rate and,
    as information, the share of each request's tokens equal to 12a's
    plain run (`plain`) before the first difference."""
    from skypilot_tpu_torch.ops import decode_attention as da
    k4 = [c.__name__ for c in (da.decode_window_attention_pooled,
                               da.fused_step_attention_pooled)]
    for key, extra in GEMMA_SPEC_ARMS:
        launches, stats, tokens = bounded_serve_path(
            f'{key} Gemma-7B spec+fused', params, cfg, counters,
            'gemma-7b', **GEMMA_SPEC, **extra)
        paths[key] = launches
        for name in k4:
            if not launches[name] or launches[f'{name}[tc]'] != \
                    launches[name]:
                raise AssertionError(
                    f'{key}: {name} launched {launches[name]} times, '
                    f'{launches[f"{name}[tc]"]} on the tensor-core route')
        if not stats['spec_proposed'] or not stats['fused_steps']:
            raise AssertionError(f'{key}: spec_proposed '
                                 f'{stats["spec_proposed"]}, fused steps '
                                 f'{stats["fused_steps"]}')
        budgets = stats['graph_budgets']
        captured = stats['graph_captures'] + stats['graph_captures_warmup']
        if not budgets['ok'] or captured != stats['graph_keys'] \
                or not stats['graph_replays']:
            raise AssertionError(f'{key}: graph keys {stats["graph_keys"]}, '
                                 f'{captured} captures, '
                                 f'{stats["graph_replays"]} replays, '
                                 f'budgets {budgets}')
        shares = _agreeing_prefix(tokens, plain)
        log(f'  {key}: ' + json.dumps({
            'card': CARD['line'],
            'accept_rate': stats['spec_accepted'] / stats['spec_proposed'],
            'spec_proposed': stats['spec_proposed'],
            'fused_steps': stats['fused_steps'],
            'decode_tokens_per_s': stats['decode_tokens_per_s'],
            'decode_tokens_per_s_without_capture':
                stats['decode_tokens_per_s_without_capture'],
            'step_share_of_bound': stats['step_share_of_bound'],
            'k4_launches': {n: launches[n] for n in k4},
            'k4_split_launches': {n: launches[f'{n}[split]'] for n in k4},
            'prefix_equal_to_12a': shares}))


def qwen_path(counters, paths, root):
    """12b: Qwen2.5-1.5B's published widths at full depth (3.09 GB, bf16,
    q/k/v biases, G 6, tied) loaded and served as 12a; then LoRA-SFT of
    the loaded base in this process (lora_sft_path: rank 16 on attn, 3
    steps of 2 x 2048 tokens, loss_chunk 512), and the entry point
    train_sft --hf-model DIR --lora-rank 16 --steps 3 as a child
    process, which must print 3 finite losses."""
    params, cfg, directory, load = hf_load_path('12b Qwen2.5-1.5B',
                                                QWEN25_1_5B, root)
    paths['12b'], serve, _ = bounded_serve_path(
        '12b Qwen2.5-1.5B', params, cfg, counters, 'qwen2.5-1.5b')
    gc.collect()
    torch.cuda.empty_cache()
    sft_data = _post_train_data(root)[0]
    paths['12b-sft'], sft_stats = lora_sft_path(
        params, dataclasses.replace(cfg, loss_chunk=512, remat=True,
                                    remat_policy='dots'),
        sft_data, counters, steps=3, label='12b LoRA-SFT Qwen2.5-1.5B')
    del params
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, '-m', 'skypilot_tpu_torch.train.train_sft',
         '--hf-model', directory, '--data-file', sft_data, '--seq-len',
         '2048', '--steps', '3', '--log-every', '1', '--lora-rank', '16',
         '--loss-chunk', '512'], cwd=HERE, capture_output=True, text=True,
        timeout=600)
    losses = _losses(proc.stdout, 'step ')
    if proc.returncode != 0 or len(losses) != 3 or not np.all(
            np.isfinite(losses)):
        raise AssertionError(f'12b train_sft --hf-model: rc '
                             f'{proc.returncode}\n{proc.stdout}\n'
                             f'{proc.stderr[-3000:]}')
    child = {'card': CARD['line'], 'seconds': time.perf_counter() - t0,
             'losses': losses, 'first_line': proc.stdout.splitlines()[0]}
    log('  12b train_sft --hf-model (child): ' + json.dumps(child))
    return load, serve, sft_stats, child


# 12d's debug-size configs: Gemma-like (head_dim 256 decoupled from
# hidden / heads, gelu, the (1 + w) norms, tied) and Qwen2-like (q/k/v
# biases, 6 query heads over 1 KV head, tied), f32.
HF_DEBUG = {
    'Gemma-like': dict(
        model_type='gemma', vocab_size=512, hidden_size=256,
        intermediate_size=512, num_hidden_layers=2, num_attention_heads=2,
        num_key_value_heads=2, head_dim=256, hidden_act='gelu',
        rms_norm_eps=1e-6, rope_theta=10000.0, max_position_embeddings=512,
        tie_word_embeddings=True),
    'Qwen2-like': dict(
        model_type='qwen2', vocab_size=512, hidden_size=768,
        intermediate_size=1024, num_hidden_layers=2, num_attention_heads=6,
        num_key_value_heads=1, rms_norm_eps=1e-6, rope_theta=1e6,
        max_position_embeddings=4096, use_sliding_window=False,
        tie_word_embeddings=True),
}


def hf_parity(root):
    """12d: each HF_DEBUG config written (f32, drawn on the host, sharded
    with an index) and loaded on the host and on the card: the same
    config, every leaf bitwise the same on both and against the draws;
    the first-step logits allclose (LOGITS_TOL), and phase 4's requests
    served with identical greedy tokens on the host, the card eagerly
    and the card through graphs."""
    from skypilot_tpu_torch.models import convert, llama
    from skypilot_tpu_torch.train import trainer
    for label, hf_config in HF_DEBUG.items():
        directory = os.path.join(root, label)
        gemma = hf_config['model_type'] == 'gemma'
        write_hf_checkpoint(
            directory, hf_config,
            lambda name, shape: draw_hf_tensor(name, shape, 1, torch.float32,
                                               'cpu', gemma),
            torch.float32, shard_bytes=4 << 20)
        host, cfg = convert.load_hf_model(directory, dtype=torch.float32,
                                          device='cpu')
        card, cfg_card = convert.load_hf_model(directory,
                                               dtype=torch.float32,
                                               device='cuda')
        if cfg_card != cfg:
            raise AssertionError(f'12d {label}: configs differ')
        verify_hf_leaves(host, hf_config, 1, torch.float32, 'cpu')
        if not all(torch.equal(a, b.cpu()) for a, b in zip(
                trainer.tree_leaves(host), trainer.tree_leaves(card))):
            raise AssertionError(f'12d {label}: card and host leaves differ')
        prompts, budgets = _debug_requests(cfg.vocab_size)
        tokens = torch.tensor([prompts[1][:40], prompts[3] + prompts[2][:23]])
        with torch.no_grad():
            want = llama.forward(host, tokens, cfg)
            got = llama.forward(card, tokens.cuda(), cfg)
        _logits_close(f'12d {label} forward logits card vs host', got, want)
        _card_and_host(f'12d {label}', _serve_debug,
                       {'cpu': host, 'cuda': card}, cfg, prompts, budgets, {})
        shutil.rmtree(directory)


# ---- phase 13: ResNet -------------------------------------------------------

# 13a's limits, f32 on both sides: each gradient and each parameter's
# update within RESNET_GRAD_REL of its leaf's largest element, the loss and
# the running statistics within RESNET_ATOL.  Both lie between the
# card-vs-host readings of the f32 step and those of its controls, the
# same step on the card with TF32 convolutions and with bf16 ones, which
# must read past RESNET_GRAD_REL.  On an H100: f32 3.2e-5 of a leaf's
# largest gradient, loss 2.6e-6, statistics 7.2e-7; TF32 0.44, 6.2e-4 and
# 1.6e-3; bf16 1.44, 1.6e-2 and 1.4e-2 (PERF.md, section 6).
RESNET_GRAD_REL, RESNET_ATOL = 2e-3, 1e-4


def _flax_shaped_state(model, seed):
    """A random {'params', 'batch_stats'} tree in flax's layout (HWIO
    kernels, the Dense kernel (in, out)) for `model`'s names, norms off
    their init (scale 1 + 0.2 N, bias and mean 0.1 N, var 1 + 0.5 |N|)."""
    rng = np.random.RandomState(seed)
    tree = {'params': {}, 'batch_stats': {}}
    for name, t in model.state_dict().items():
        *path, leaf = name.split('.')
        noise = rng.normal(size=tuple(t.shape)).astype(np.float32)
        if leaf == 'kernel':
            value = (noise * np.prod(t.shape[1:]) ** -0.5).transpose(
                2, 3, 1, 0)
        elif leaf == 'weight':
            leaf, value = 'kernel', (noise * t.shape[1] ** -0.5).T
        elif leaf == 'scale':
            value = 1 + 0.2 * noise
        elif leaf == 'var':
            value = 1 + 0.5 * np.abs(noise)
        else:
            value = 0.1 * noise
        node = tree['batch_stats' if leaf in ('mean', 'var') else 'params']
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = value
    return tree


def _resnet_step(dev, state, x, y, dtype=torch.float32):
    """One train_resnet step of ResNet18Thin (convolutions in `dtype`)
    from `state` on `dev`: (loss, gradients, state after), on the host."""
    from skypilot_tpu_torch.models import resnet
    from skypilot_tpu_torch.train import train_resnet
    model = resnet.ResNet18Thin(dtype=dtype)
    model.load_state_dict(state)
    model.to(dev)
    step = train_resnet.make_step(model, train_resnet.sgd(model))
    loss = float(step(x.to(dev), y.to(dev)))
    return (loss, {n: p.grad.cpu() for n, p in model.named_parameters()},
            {n: t.cpu() for n, t in model.state_dict().items()})


def _resnet_distance(state, want, got):
    """The readings of `got` against `want` (two _resnet_step results
    from `state`): the loss's distance, the largest gradient and update
    distance of any leaf over that leaf's largest, the running
    statistics' largest distance."""
    (l_w, g_w, s_w), (l_g, g_g, s_g) = want, got
    grad = upd = 0.0
    for name in g_w:
        grad = max(grad, float((g_g[name] - g_w[name]).abs().max())
                   / float(g_w[name].abs().max()))
        step = s_w[name] - state[name]
        upd = max(upd, float((s_g[name] - s_w[name]).abs().max())
                  / float(step.abs().max()))
    stats = max(float((s_g[n] - s_w[n]).abs().max()) for n in s_w
                if n.endswith(('.mean', '.var')))
    return {'loss': abs(l_g - l_w), 'grad_rel': grad, 'update_rel': upd,
            'running_stats_abs': stats}


def resnet_parity():
    """13a: ResNet18Thin in f32 on the host and on the card from the same
    params_from_flax state: one step of train_resnet's step (SGD with
    momentum 0.9, lr 0.1) on 4 random 32x32 images; the loss, every
    gradient, every parameter's update and the running statistics held
    at RESNET_GRAD_REL / RESNET_ATOL.  Then the controls: the same step
    on the card with TF32 convolutions and with bf16 ones, each of which
    must read past RESNET_GRAD_REL (the limit sees a lower-precision
    convolution path)."""
    from skypilot_tpu_torch.models import resnet
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.normal(size=(4, 32, 32, 3)).astype(np.float32))
    y = torch.arange(4) % 10
    state = resnet.params_from_flax(
        _flax_shaped_state(resnet.ResNet18Thin(), 0))
    host = _resnet_step('cpu', state, x, y)
    card = _resnet_distance(state, host, _resnet_step('cuda', state, x, y))
    torch.backends.cudnn.allow_tf32 = True
    try:
        tf32 = _resnet_distance(state, host,
                                _resnet_step('cuda', state, x, y))
    finally:
        torch.backends.cudnn.allow_tf32 = False
    bf16 = _resnet_distance(state, host, _resnet_step(
        'cuda', state, x, y, torch.bfloat16))
    log('  13a ResNet18Thin f32 one SGD step, card vs host: ' + json.dumps({
        'card': CARD['line'], 'loss': [host[0]], 'f32': card,
        'control_tf32_convs': tf32, 'control_bf16_convs': bf16,
        'limits': {'grad_update_rel': RESNET_GRAD_REL,
                   'loss_stats_abs': RESNET_ATOL}}))
    if max(card['loss'], card['running_stats_abs']) > RESNET_ATOL or max(
            card['grad_rel'], card['update_rel']) > RESNET_GRAD_REL:
        raise AssertionError(f'13a: the card\'s step is off the host\'s: '
                             f'{card}')
    for label, control in (('TF32', tf32), ('bf16', bf16)):
        if control['grad_rel'] <= RESNET_GRAD_REL:
            raise AssertionError(
                f'13a: the step with {label} convolutions reads within '
                f'RESNET_GRAD_REL ({control}): the limit does not see it')


def resnet_train_path(batch=256, size=224, warmup=2, steps=10):
    """13b: train_resnet's path on the card: ResNet50 (bf16 convolutions,
    channels_last, f32 parameters and norms), ones images and zero
    labels, SGD momentum 0.9; `warmup` steps, then `steps` timed; then
    the entry point itself as a child process at the same settings.
    Fails unless the losses are finite.  Prints images/s, step time and
    peak memory."""
    from skypilot_tpu_torch.models import resnet
    from skypilot_tpu_torch.train import train_resnet
    torch.manual_seed(0)
    model = resnet.ResNet50().cuda()
    step = train_resnet.make_step(model, train_resnet.sgd(model))
    images = torch.ones((batch, size, size, 3), dtype=torch.bfloat16,
                        device='cuda')
    labels = torch.zeros((batch,), dtype=torch.long, device='cuda')
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(warmup):
        loss = step(images, labels)
    first = float(loss)
    warm_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(steps):
        loss = step(images, labels)
    last = float(loss)
    elapsed = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 1e9
    del model, step, images, labels
    gc.collect()
    torch.cuda.empty_cache()
    proc = subprocess.run(
        [sys.executable, '-m', 'skypilot_tpu_torch.train.train_resnet',
         '--steps', str(steps), '--batch-size', str(batch), '--image-size',
         str(size)], cwd=HERE, capture_output=True, text=True, timeout=600)
    line = proc.stdout.strip().splitlines()[-1] if proc.stdout.strip() else ''
    if proc.returncode != 0 or not line.startswith('images/sec: '):
        raise AssertionError(f'13b train_resnet: rc {proc.returncode}\n'
                             f'{proc.stdout}\n{proc.stderr[-3000:]}')
    if not np.all(np.isfinite([first, last, float(line.split()[-1])])):
        raise AssertionError(f'13b: losses {first}, {last}; {line}')
    stats = {'card': CARD['line'], 'batch': batch, 'image_size': size,
             'warmup_steps': warmup, 'warmup_s': warm_s, 'steps': steps,
             'images_per_s': batch * steps / elapsed,
             'step_ms': elapsed / steps * 1e3, 'peak_memory_gb': peak,
             'loss_after_warmup': first, 'last_loss': last,
             'entry_point_line': line}
    log('  13b train_resnet ResNet50: ' + json.dumps(stats))
    return stats


# ---- phase 14: prefix cache, host tier, handoff ---------------------------

# prefix_block == prefill_chunk: a cold prompt longer than the chunk takes
# the same windows as a warm hit's suffix, so both write the same K/V.
PREFIX_BLOCK = 256


def _arena_sha(arena, ids):
    """SHA-256 over the arena blocks `ids` of every component (sorted),
    gathered as (L, n, ...) and read on the host, bf16 as its bits."""
    idx = torch.as_tensor(list(ids), dtype=torch.long,
                          device=arena['k'].device)
    h = hashlib.sha256()
    for comp in sorted(arena):
        t = arena[comp].index_select(1, idx).cpu()
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        h.update(t.numpy().tobytes())
    return h.hexdigest()


def _trie_node(pc, key):
    """The trie node covering the token prefix `key` (None if absent)."""
    node = pc._root
    for b in range(len(key) // pc.block):
        node = node.children.get(tuple(key[b * pc.block:(b + 1) * pc.block]))
        if node is None:
            return None
    return node


def _run_requests(b, prompts, max_new):
    """Submit `prompts` at once and run the batcher idle; returns (each
    request's tokens, each one's TTFT, the wall seconds)."""
    t0 = time.perf_counter()
    rids = [b.submit(p, max_new_tokens=max_new) for p in prompts]
    b.run_until_idle()
    wall = time.perf_counter() - t0
    ttfts = [b.ttft(r) for r in rids]
    return [b.result(r) for r in rids], ttfts, wall


def prefix_reuse_path(params, counters, paths, cfg=None, device='cuda'):
    """14a, bench_prefix_reuse's shape at LLAMA3_8B: 8 requests share one
    1,024-token head, each with its own 64-token tail, 48 new tokens;
    a cold batch (first sight of the head), then a warm one with new
    tails.  Gates: the warm tokens equal a batcher without a prefix cache
    on the same prompts; the warm hits dispatch no install or extract
    copy and make one host sync an admission, as the cold batch does;
    the trie's bytes (and its gauge) never pass prefix_cache_mb.  cfg,
    device: LLAMA3_8B on the card by default (a rehearsal passes a tiny
    config and the CPU)."""
    from skypilot_tpu_torch.infer import engine, prefix_cache
    from skypilot_tpu_torch.infer.engine import GeneratorConfig
    from skypilot_tpu_torch.infer.serving import ContinuousBatcher
    from skypilot_tpu_torch.models import llama
    from skypilot_tpu_torch.telemetry import metrics

    cfg = cfg or llama.LLAMA3_8B
    slots, head_len, tail, max_new = 8, 1024, 64, 48
    base = dict(max_seq_len=2048, batch_size=slots,
                prefill_chunk=PREFIX_BLOCK)
    b = ContinuousBatcher(params, cfg, GeneratorConfig(
        **base, prefix_block=PREFIX_BLOCK, prefix_cache_mb=2048),
        decode_chunk=16, device=device)
    pc = b._prefix
    peak = {'bytes': 0, 'gauge': 0.0}
    step, decode_chunk, chunks = b.step, b._decode_chunk, [0]

    def checked_step():
        step()
        peak['bytes'] = max(peak['bytes'], pc.bytes)
        peak['gauge'] = max(peak['gauge'], metrics.REGISTRY.get_sample_value(
            'skytpu_infer_prefix_bytes'))

    def counted_chunk(*args, **kwargs):
        chunks[0] += 1
        return decode_chunk(*args, **kwargs)

    b.step, b._decode_chunk = checked_step, counted_chunk
    vocab = cfg.vocab_size
    rng = np.random.RandomState(14)

    def make(head, salt):
        return [list(head) + [(salt + 7 * (i + 1) + j) % vocab
                              for j in range(tail)] for i in range(slots)]

    def run(prompts):
        keys = ('hits', 'misses', 'tokens_saved', 'evictions')
        before = {k: getattr(pc, k) for k in keys}
        shares0, syncs0, chunks0 = (b.pool.prefix_shares,
                                    engine.host_fetch.calls, chunks[0])
        b.decode_tokens, b.decode_seconds = 0, 0.0
        out, ttfts, wall = _run_requests(b, prompts, max_new)
        if any(len(o) != max_new for o in out):
            raise AssertionError(f'14a: {[len(o) for o in out]} tokens')
        tokens = sum(len(p) for p in prompts)
        stats = {k: getattr(pc, k) - before[k] for k in keys}
        stats.update(
            ttft_s_median=statistics.median(ttfts), ttft_s_max=max(ttfts),
            wall_s=wall, prompt_tokens=tokens,
            # Prompt tokens over the time until the last first token.
            prefill_tokens_per_s=tokens / max(ttfts),
            decode_tokens_per_s=b.decode_tokens / b.decode_seconds,
            prefix_shares=b.pool.prefix_shares - shares0,
            decode_chunks=chunks[0] - chunks0,
            host_fetches=engine.host_fetch.calls - syncs0)
        # One sync for each admission's first token, one a decode chunk.
        stats['syncs_per_admission'] = (
            stats['host_fetches'] - stats['decode_chunks']) / len(prompts)
        return out, stats

    # Warm-up on a disjoint token range: the cold windows, the hit path
    # and the decode graphs; then count from zero.
    warm_head = [int(t) for t in rng.randint(1, vocab // 2, size=head_len)]
    head = [int(t) for t in rng.randint(vocab // 2, vocab, size=head_len)]
    run(make(warm_head, 1))
    run(make(warm_head, 2))
    _zero(counters)
    _, cold = run(make(head, 3))
    real = prefix_cache.install_prefix, prefix_cache.extract_block

    def no_copy(*args, **kwargs):
        raise AssertionError('14a: an install/extract copy on the pooled '
                             'warm path')

    prefix_cache.install_prefix = prefix_cache.extract_block = no_copy
    try:
        warm_out, warm = run(make(head, 4))
    finally:
        prefix_cache.install_prefix, prefix_cache.extract_block = real
    paths['14a'] = _counts(counters)
    b.pool.check_invariant()
    st = b.pool.stats()
    if st['reserved'] or st['blocks_live'] != pc.node_count * (
            PREFIX_BLOCK // b.block_size):
        raise AssertionError(f'14a: pool {st} against {pc.node_count} '
                             f'trie nodes')
    if warm['hits'] != slots or warm['misses'] or \
            warm['tokens_saved'] != slots * head_len:
        raise AssertionError(f'14a: warm batch {warm}')
    if cold['syncs_per_admission'] != 1 or warm['syncs_per_admission'] != 1:
        raise AssertionError(f'14a: host syncs an admission: cold {cold}, '
                             f'warm {warm}')
    if peak['bytes'] > pc.capacity_bytes or peak['gauge'] > pc.capacity_bytes:
        raise AssertionError(f'14a: the trie held {peak} bytes, over its '
                             f'{pc.capacity_bytes}')
    del b, pc
    gc.collect()
    torch.cuda.empty_cache()
    ref = ContinuousBatcher(params, cfg, GeneratorConfig(**base),
                            decode_chunk=16, device=device)
    ref_out, _, _ = _run_requests(ref, make(head, 4), max_new)
    _same_tokens('14a: warm hits vs a batcher without a prefix cache',
                 warm_out, ref_out)
    del ref
    gc.collect()
    torch.cuda.empty_cache()
    stats = {'card': CARD['line'], 'requests': slots,
             'shared_head_tokens': head_len, 'tail_tokens': tail,
             'prefix_block': PREFIX_BLOCK, 'new_tokens': max_new,
             'cold': cold, 'warm': warm,
             'ttft_median_warm_over_cold': (warm['ttft_s_median']
                                            / cold['ttft_s_median']),
             'peak_trie_bytes': peak['bytes'],
             'prefix_cache_bytes': 2048 * 1024 * 1024,
             'launches': paths['14a']}
    log('  14a prefix reuse: ' + json.dumps(stats))
    log('  14a: warm tokens identical to a batcher without a prefix cache; '
        'no install/extract copy; one host sync an admission')


def _copy_gbps(nbytes=1 << 30, reps=5):
    """One plain pinned copy_ of `nbytes` each way (the host link's
    yardstick): GB/s of the median of `reps`, timed with CUDA events."""
    t0 = time.perf_counter()
    host = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
    pin_s = time.perf_counter() - t0
    dev = torch.empty(nbytes, dtype=torch.uint8, device='cuda')
    out = {'bytes': nbytes, 'pin_s': pin_s}
    for name, dst, src in (('h2d', dev, host), ('d2h', host, dev)):
        times = []
        for _ in range(reps + 1):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            dst.copy_(src, non_blocking=True)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / 1e3)
        out[f'{name}_gb_per_s'] = nbytes / statistics.median(times[1:]) / 1e9
    del host, dev
    torch.cuda.empty_cache()
    return out


def tier_path(params, counters, paths, cfg=None, device='cuda'):
    """14b, bench_tier_reuse's shape at LLAMA3_8B: 12 heads of 1,024
    tokens (48 trie nodes of 256 tokens, 1.61 GB of KV), a device prefix
    budget of a tenth of that working set by the reference's formula,
    a host tier of twice it; every head seen once, then revisited after
    churn with a prefetch_hint ahead of it; tier off, then on.  Gates:
    the two arms' tokens are identical; the first spilled node's arena
    bytes after its prefetch equal (SHA-256) those gathered at its
    spill.  Prints the tier's counts, spill and prefetch GB/s beside one
    plain pinned 1 GB copy each way, revisit TTFTs and the pinned
    allocation's seconds and host RSS.  cfg, device: as
    prefix_reuse_path's."""
    from skypilot_tpu_torch.infer.engine import GeneratorConfig
    from skypilot_tpu_torch.infer.serving import ContinuousBatcher
    from skypilot_tpu_torch.models import llama

    cfg = cfg or llama.LLAMA3_8B
    heads, head_len, tail, max_new = 12, 1024, 32, 4
    nodes_per_head = head_len // PREFIX_BLOCK
    working = heads * nodes_per_head
    node_bytes = (2 * cfg.n_layers * PREFIX_BLOCK * cfg.n_kv_heads
                  * cfg.head_dim * torch.empty((), dtype=cfg.dtype)
                  .element_size())
    budget_nodes = max(nodes_per_head + 1, working // 10)
    prefix_mb = budget_nodes * node_bytes / 2 ** 20
    host_mb = 2.0 * working * node_bytes / 2 ** 20
    rng = np.random.RandomState(15)
    vocab = cfg.vocab_size
    head_toks = [[int(t) for t in rng.randint(1, vocab, size=head_len)]
                 for _ in range(heads)]

    def tails(salt):
        return [[(salt + 11 * (i + 1) + j) % vocab for j in range(tail)]
                for i in range(heads)]

    def arm(tier_mb):
        rss0, t0 = _vm_rss(), time.perf_counter()
        b = ContinuousBatcher(params, cfg, GeneratorConfig(
            max_seq_len=2048, batch_size=2, prefill_chunk=PREFIX_BLOCK,
            prefix_block=PREFIX_BLOCK, prefix_cache_mb=prefix_mb,
            host_tier_mb=tier_mb), decode_chunk=16, device=device)
        build = {'build_s': time.perf_counter() - t0,
                 'host_rss_growth_gb': (_vm_rss() - rss0) / 1e9}
        tier, pc = b._tier, b._prefix
        spilled, fetched = {}, []
        if tier is not None:
            accept, start = tier.accept_spill, tier.start_prefetch

            def recording_spill(key, ids):
                # The bytes gathered at the spill, read before the blocks
                # free (outside every timed request).
                sha = _arena_sha(b.pool.arena, ids)
                ok = accept(key, ids)
                if ok:
                    spilled[key] = sha
                return ok

            def recording_prefetch(entries, dev_ids, nodes):
                fetched.extend((e.key, n) for e, n in zip(entries, nodes))
                return start(entries, dev_ids, nodes)

            tier.accept_spill = recording_spill
            tier.start_prefetch = recording_prefetch
            _zero(counters)
        outs = []
        for h, t in zip(head_toks, tails(3)):
            o, _, _ = _run_requests(b, [h + t], max_new)
            outs += o
        b.tier_flush()
        h0, m0 = pc.hits, pc.misses
        ttfts, verified = [], 0
        for h, t in zip(head_toks, tails(4)):
            if tier is not None:
                b.prefetch_hint(h + t)
                b.tier_flush()
            o, ttft, _ = _run_requests(b, [h + t], max_new)
            outs += o
            ttfts += ttft
            # Every node prefetched for this request, still in the trie
            # as it landed: its arena bytes against those of its spill.
            while fetched:
                key, node = fetched.pop()
                if node.tier != 'device' or _trie_node(pc, key) is not node:
                    continue
                if _arena_sha(b.pool.arena, node.data) != spilled[key]:
                    raise AssertionError('14b: a prefetched node\'s bytes '
                                         'differ from those spilled')
                verified += 1
        b.tier_flush()
        stats = dict(build, warm_hits=pc.hits - h0,
                     warm_misses=pc.misses - m0,
                     revisit_ttft_s_median=statistics.median(ttfts),
                     revisit_ttft_s_max=max(ttfts))
        if tier is not None:
            if not verified:
                raise AssertionError('14b: no spilled node was prefetched')
            s = tier.stats()
            stats.update({k: s[k] for k in (
                'spills', 'spill_rejects', 'prefetches', 'host_hits',
                'device_hits', 'misses', 'prefetch_late', 'host_evictions',
                'spill_bytes', 'prefetch_bytes', 'spill_seconds',
                'prefetch_seconds', 'prefetch_staging_seconds',
                'prefetch_h2d_seconds', 'host_nbytes', 'pin_seconds')})
            stats['spill_gb_per_s'] = s['spill_bytes'] / s['spill_seconds'] / 1e9
            stats['prefetch_gb_per_s'] = (s['prefetch_bytes']
                                          / s['prefetch_seconds'] / 1e9)
            stats['prefetch_h2d_gb_per_s'] = (
                s['prefetch_bytes'] / s['prefetch_h2d_seconds'] / 1e9
                if s['prefetch_h2d_seconds'] else None)
            stats['prefetched_nodes_sha256_equal'] = verified
            paths['14b'] = _counts(counters)
        b.pool.check_invariant()
        b.close()
        del b, tier, pc
        gc.collect()
        torch.cuda.empty_cache()
        return outs, stats

    off_out, off = arm(None)
    on_out, on = arm(host_mb)
    _same_tokens('14b: tier on vs tier off', on_out, off_out)
    stats = {'card': CARD['line'], 'heads': heads,
             'shared_head_tokens': head_len, 'working_set_nodes': working,
             'working_set_gb': working * node_bytes / 1e9,
             'device_budget_nodes': budget_nodes,
             'host_tier_mb': host_mb, 'tier_off': off, 'tier_on': on,
             'pinned_copy_1gb': _copy_gbps() if device == 'cuda' else None,
             'launches': paths['14b']}
    log('  14b host tier: ' + json.dumps(stats))
    log(f'  14b: tier-on tokens identical to tier-off ({len(on_out)} '
        f'requests); {on["prefetched_nodes_sha256_equal"]} prefetched '
        f'nodes equal their spills (SHA-256)')


def handoff_path(params, counters, paths, kv, cfg=None, device='cuda'):
    """14c, prefill -> decode handoff in one process: a prefill batcher
    and a decode batcher, each with its own arena, prefix cache and host
    tier, over one parameter dict.  Four cold 1,040-token prompts are
    prefilled (max_new_tokens=1), exported, encoded, decoded, ingested
    and served 48 tokens on the decode batcher; a fifth's image has one
    byte flipped, is refused and the prompt prefills cold.  Gates: the
    tokens of all five equal single-pool serving; drain_sessions on the
    single pool mid-decode returns each request's tokens so far (a
    prefix of the uninterrupted run's) and its remaining budget, and the
    specs re-submitted on the prefill batcher run to that budget.  How
    many of the resumed tokens equal the uninterrupted run's is printed,
    not gated: the resumed request computes its generated tokens' K/V in
    a prefill window where the single pool wrote them in decode steps
    (other products, other bf16 and int8 roundings); 14d holds the
    continuation bitwise in f32.  cfg, device: as
    prefix_reuse_path's."""
    from skypilot_tpu_torch.infer.engine import GeneratorConfig
    from skypilot_tpu_torch.infer.serving import ContinuousBatcher
    from skypilot_tpu_torch.models import llama
    from skypilot_tpu_torch.serve import disagg

    cfg = cfg or llama.LLAMA3_8B
    label = f'14c-{kv or "bf16"}'
    n, plen, max_new = 4, 1040, 48
    # Room for twice the five prompts' heads, on the card and on the host.
    elem = 1 if kv else torch.empty((), dtype=cfg.dtype).element_size()
    head_mb = ((n + 1) * (plen // PREFIX_BLOCK) * 2 * cfg.n_layers
               * PREFIX_BLOCK * cfg.n_kv_heads * (cfg.head_dim * elem
                                                  + (4 if kv else 0))
               / 2 ** 20)
    base = dict(max_seq_len=2048, batch_size=8, prefill_chunk=PREFIX_BLOCK,
                prefix_block=PREFIX_BLOCK, prefix_cache_mb=2 * head_mb,
                kv_cache_dtype=kv)
    rng = np.random.RandomState(16 if kv is None else 17)
    prompts = [[int(t) for t in rng.randint(1, cfg.vocab_size, size=plen)]
               for _ in range(n + 1)]
    single = ContinuousBatcher(params, cfg, GeneratorConfig(**base),
                               decode_chunk=16, device=device)
    want, _, _ = _run_requests(single, prompts, max_new)
    # A failover mid-decode: drained sessions (warm hits now).
    rids = [single.submit(p, max_new_tokens=max_new) for p in prompts[:n]]
    while min(len(single.partial(r)) for r in rids) < 17:
        single.step()
    specs = single.drain_sessions()
    if len(specs) != n or not all(
            0 < len(s['out']) < max_new and s['max_new_tokens'] == max_new
            and s['out'] == w[:len(s['out'])] and s['prompt'] == p
            for s, w, p in zip(specs, want, prompts)):
        raise AssertionError(f'14c: drained {[len(s["out"]) for s in specs]}'
                             f' tokens: not the uninterrupted run\'s')
    del single
    gc.collect()
    torch.cuda.empty_cache()
    pre = ContinuousBatcher(params, cfg, GeneratorConfig(
        **base, host_tier_mb=2 * head_mb), decode_chunk=16, device=device)
    dec = ContinuousBatcher(params, cfg, GeneratorConfig(
        **base, host_tier_mb=2 * head_mb), decode_chunk=16, device=device)
    _zero(counters)
    _run_requests(pre, prompts, 1)
    hits0 = dec._prefix.hits
    rids, export_to_first, image_bytes, enc_ms, dec_ms = [], [], [], [], []
    for i, p in enumerate(prompts):
        # One prompt's handoff, timed from its export to its first token
        # on the decode batcher (which decodes the earlier ones meanwhile).
        t0 = time.perf_counter()
        res = pre.export_handoff(p)
        if res is None or res['tokens'] != (plen - 1) // PREFIX_BLOCK \
                * PREFIX_BLOCK:
            raise AssertionError(f'14c: export of prompt {i}: {res}')
        t1 = time.perf_counter()
        data = disagg.encode_kv_image(p[:res['tokens']], PREFIX_BLOCK,
                                      res['payload'])
        t2 = time.perf_counter()
        if i == n:
            bad = bytearray(data)
            bad[len(bad) // 2] ^= 0x01
            try:
                disagg.decode_kv_image(bytes(bad))
            except disagg.CorruptImageError:
                # Refused: this prompt prefills cold.
                rids.append(dec.submit(p, max_new_tokens=max_new))
                continue
            raise AssertionError('14c: a flipped byte was not refused')
        img = disagg.decode_kv_image(data)
        t3 = time.perf_counter()
        if dec.ingest_handoff(p, img.payload) != img.nodes:
            raise AssertionError(f'14c: prompt {i} not adopted')
        dec.tier_flush()
        t4 = time.perf_counter()
        rids.append(dec.submit(p, max_new_tokens=max_new))
        while not dec.partial(rids[-1]):
            dec.step()
        # The first token reaches the host inside the tick's admission
        # (the tick's decode chunk comes after it).
        export_to_first.append(t4 - t0 + dec.ttft(rids[-1]))
        image_bytes.append(len(data))
        enc_ms.append((t2 - t1) * 1e3)
        dec_ms.append((t3 - t2) * 1e3)
    dec.run_until_idle()
    got = [dec.result(r) for r in rids]
    paths[label] = _counts(counters)
    _same_tokens(f'{label}: handoff (and the corrupt image\'s cold '
                 f'fallback) vs single-pool serving', got, want)
    if dec._prefix.hits - hits0 != n:
        raise AssertionError(f'14c: {dec._prefix.hits - hits0} warm hits')
    for b in (pre, dec):
        b.pool.check_invariant()
    # The drained sessions, re-submitted on the other batcher.
    resumed = [pre.submit(s['prompt'] + s['out'],
                          max_new_tokens=s['max_new_tokens'] - len(s['out']))
               for s in specs]
    pre.run_until_idle()
    continued = [s['out'] + pre.result(r) for s, r in zip(specs, resumed)]
    if any(len(c) != max_new for c in continued):
        raise AssertionError(f'14c: resumed {[len(c) for c in continued]}')
    same = [next((j for j, (a, w) in enumerate(zip(c, want[i]))
                  if a != w), max_new) - len(s['out'])
            for i, (c, s) in enumerate(zip(continued, specs))]
    stats = {'card': CARD['line'], 'kv_cache_dtype': kv, 'prompts': n,
             'prompt_tokens': plen, 'image_bytes': image_bytes,
             'encode_ms': enc_ms, 'decode_ms': dec_ms,
             'export_to_first_token_s': export_to_first,
             'decode_warm_hits': dec._prefix.hits - hits0,
             'adopted': dec._tier.adopted,
             'drained_out_tokens': [len(s['out']) for s in specs],
             # Resumed tokens equal to the uninterrupted run's before the
             # first that differs (of max_new - drained_out_tokens).
             'resumed_identical_tokens': same,
             'launches': paths[label]}
    log(f'  {label} handoff: ' + json.dumps(stats))
    log(f'  {label}: handoff tokens identical to single-pool serving; the '
        f'flipped image refused and its prompt served cold with the same '
        f'tokens; drained specs hold the uninterrupted prefix and resume')
    for b in (pre, dec):
        b.close()
    del pre, dec
    gc.collect()
    torch.cuda.empty_cache()


def _serve_debug_warm(params, cfg, dev, prompts, budgets, graphs=None,
                      settle=True, **extra):
    """_serve_debug's batcher serving the requests twice, cold then warm
    (the trie filled by the first pass); the passes must agree.  Closes
    the batcher's tier."""
    b, cold = _serve_debug(params, cfg, dev, prompts, budgets, graphs,
                           settle, **extra)
    rids = [b.submit(p, max_new_tokens=n) for p, n in zip(prompts, budgets)]
    b.run_until_idle()
    warm = [b.result(r) for r in rids]
    if warm != cold:
        raise AssertionError(f'batcher {extra} on {dev}: warm tokens differ '
                             f'from cold')
    if not b._prefix.hits:
        raise AssertionError(f'batcher {extra} on {dev}: no prefix hit')
    if b._tier is not None:
        b.tier_flush()
        # Unsettled, a lagging copy engine may leave no slot to spill or
        # prefetch through (_unsettled_tier_layout logs it).
        if settle and (not b._tier.spills or not b._tier.prefetches):
            raise AssertionError(f'batcher {extra} on {dev}: tier '
                                 f'{b._tier.stats()}')
    if b.pooled:
        b.pool.check_invariant()
    b.close()
    return b, warm


def _drain_resume_debug(params, cfg, dev, prompts, budgets, graphs=None,
                        **extra):
    """drain_sessions on a batcher after its first decode chunk, and the
    specs re-submitted (prompt + out, the budget left) on a second
    batcher: returns (the second batcher, each request's drained tokens
    followed by its resumed ones)."""
    from skypilot_tpu_torch.infer.engine import GeneratorConfig
    from skypilot_tpu_torch.infer.serving import ContinuousBatcher
    kw = dict(max_seq_len=256, batch_size=4, prompt_buckets=[16, 64, 128],
              prefill_chunk=64, kv_block_size=16, **extra)
    a, b = (ContinuousBatcher(params, cfg, GeneratorConfig(**kw),
                              decode_chunk=4, device=dev, graphs=graphs)
            for _ in range(2))
    for p, n in zip(prompts, budgets):
        a.submit(p, max_new_tokens=n)
    while a.num_queued or not a.num_active:
        a.step()
    specs = a.drain_sessions()
    if len(specs) != len(prompts) or a.num_active or a.num_queued:
        raise AssertionError(f'drain on {dev}: {len(specs)} specs')
    rids = [b.submit(s['prompt'] + s['out'],
                     max_new_tokens=s['max_new_tokens'] - len(s['out']))
            for s in specs]
    b.run_until_idle()
    out = [s['out'] + b.result(r) for s, r in zip(specs, rids)]
    for x in (a, b):
        x.pool.check_invariant()
        x.close()
    return b, out


def _device_nodes(batcher):
    """{token prefix: the arena block ids of its trie node} for every
    device-resident node of a pooled batcher's prefix cache."""
    out, stack = {}, [(batcher._prefix._root, ())]
    while stack:
        node, prefix = stack.pop()
        for key, child in node.children.items():
            if child.tier == 'device':
                out[prefix + key] = list(child.data)
            stack.append((child, prefix + key))
    return out


def _unsettled_tier_layout(label, params, cfg, prompts, budgets, extra,
                           host, want):
    """The tiered batcher once more on the card through graphs, its ticks
    NOT settled (_settle_tier_each_tick): its tokens must still be
    `want`; logged, not gated, how far its arena layout strays from the
    host's (the elements off at LOGITS_TOL, the trie's device nodes and
    their blocks, the tier's spills and rejects), the measure of what
    the settled runs take out."""
    atol, rtol = LOGITS_TOL
    free, got = _serve_debug_warm(params['cuda'], cfg, 'cuda', prompts,
                                  budgets, settle=False, **extra)
    _same_tokens(f'14d {label}: unsettled card vs settled', got, want)
    off = total = 0
    for comp, arr in free.pool.arena.items():
        close = torch.isclose(arr[:, 1:].cpu(), host.pool.arena[comp][:, 1:],
                              atol=atol, rtol=rtol)
        off += int((~close).sum())
        total += close.numel()
    nodes, host_nodes = _device_nodes(free), _device_nodes(host)
    common = sorted(set(nodes) & set(host_nodes))
    same_blocks = sum(nodes[k] == host_nodes[k] for k in common)
    common_close = sum(all(torch.allclose(
        arr[:, nodes[k]].cpu(), host.pool.arena[c][:, host_nodes[k]],
        atol=atol, rtol=rtol) for c, arr in free.pool.arena.items())
        for k in common)
    keys = ('spills', 'spill_rejects', 'prefetches', 'host_hits')
    log(f'  14d {label}, ticks not settled (not gated): ' + json.dumps({
        'tokens_identical': True, 'arena_elements_off': off,
        'arena_elements': total,
        'device_nodes_card': len(nodes), 'device_nodes_host': len(host_nodes),
        'common_nodes': len(common), 'common_same_blocks': same_blocks,
        'common_allclose': common_close,
        'tier_card': {k: free._tier.stats()[k] for k in keys},
        'tier_host': {k: host._tier.stats()[k] for k in keys}}))


def prefix_parity():
    """14d: a 2-layer LLAMA_DEBUG model in f32 on the host (plain
    versions), on the card eagerly and on the card through graphs: the
    Generator's warm path (pooled and 'paged': installs), the batcher's
    pooled plane with the host tier under an evicting budget and its
    'paged' plane (install/extract, K7): identical greedy tokens on all
    three, warm equal cold and equal to the plain engines' tokens, and
    the pooled arenas allclose card vs host (LOGITS_TOL; the tiered runs
    settled, _settle_tier_each_tick, and an unsettled one logged:
    _unsettled_tier_layout); and drain_sessions after a decode chunk,
    resumed on a second batcher, continues with the uninterrupted run's
    tokens."""
    from skypilot_tpu_torch.models import llama

    cfg = llama.LLAMA_DEBUG
    params_cpu = llama.init_params(cfg, torch.Generator().manual_seed(0),
                                   'cpu')
    params = {'cpu': params_cpu, 'cuda': _to_device(params_cpu, 'cuda')}
    rng = np.random.RandomState(3)
    head = [int(t) for t in rng.randint(1, cfg.vocab_size, size=32)]
    prompts = [head + [int(t) for t in rng.randint(1, cfg.vocab_size,
                                                   size=n)]
               for n in (3, 20, 60, 9)]
    budgets = [12, 9, 7, 10]
    prefix = dict(prefix_cache_mb=4, prefix_block=16)
    # One 16-row f32 block of LLAMA_DEBUG is 32 KiB: ~1.5 of them.
    tiered = dict(prefix_cache_mb=0.05, prefix_block=16, host_tier_mb=2)
    ref_gen = _generate_debug(params['cpu'], cfg, 'cpu', prompts, budgets)[1]
    ref_batch = _serve_debug(params['cpu'], cfg, 'cpu', prompts, budgets)[1]
    runs = (('Generator pooled, prefix', _generate_debug, prefix, ref_gen),
            ('Generator paged, prefix', _generate_debug,
             dict(prefix, decode_impl='paged'), ref_gen),
            ('batcher pooled, prefix + host tier', _serve_debug_warm,
             tiered, ref_batch),
            ('batcher paged, prefix', _serve_debug_warm,
             dict(prefix, decode_impl='paged'), ref_batch),
            ('drain_sessions, resumed on a second batcher',
             _drain_resume_debug, prefix, None))
    with warnings.catch_warnings():
        warnings.simplefilter('ignore', DeprecationWarning)
        for label, run, extra, ref in runs:
            three = _card_and_host(label, run, params, cfg, prompts,
                                   budgets, extra)
            if ref is None:     # uninterrupted: the batcher's own tokens
                ref = _serve_debug(params['cpu'], cfg, 'cpu', prompts,
                                   budgets, **extra)[1]
            _same_tokens(f'14d {label}: vs the engine without a prefix '
                         f'cache', three['card graphs'][1], ref)
            host, card = three['host'][0], three['card graphs'][0]
            if getattr(card, 'pool', None) is not None:
                atol, rtol = LOGITS_TOL
                for comp, arr in card.pool.arena.items():
                    torch.testing.assert_close(
                        arr[:, 1:].cpu(), host.pool.arena[comp][:, 1:],
                        atol=atol, rtol=rtol)
                log(f'  14d {label}: arena allclose card vs host')
            if getattr(card, '_tier', None) is not None:
                _unsettled_tier_layout(label, params, cfg, prompts, budgets,
                                       extra, host, three['card graphs'][1])
    log('  14d: warm equals cold and the engines without a prefix cache, '
        'on the host, the card eager and the card through graphs')


# ---- phase 15: telemetry, the OpenAI routes, encode, batch_infer, eval_ppl -

# The step phases of the batcher's profiler (telemetry/spans.py).
STEP_PHASES = ('admit', 'prefill', 'upload', 'decode', 'fused', 'spec_draft',
               'spec_verify', 'tier_wait', 'host_fetch')


def _metric(name, **labels):
    from skypilot_tpu_torch.telemetry import metrics
    return metrics.REGISTRY.get_sample_value(name, labels) or 0.0


def _serve_prompts(vocab_size):
    """Phase 5's 8 prompts (SERVE_LENGTHS tokens, the same draw)."""
    rng = np.random.RandomState(2)
    return [[int(t) for t in rng.randint(0, vocab_size, size=n)]
            for n in SERVE_LENGTHS]


def _telemetry_run(b, led, prompts, counters, label):
    """One burst of `prompts` (submitted at once: the admission groups are
    the same every run), 48 new tokens each, tenants a and b in turn, on
    `b`; `led` is the CostLedger `b` was built with (None: built without
    one, nor a SpanBuffer).  Returns (tokens, stats, launches, rids)."""
    sums0 = {p: _metric('skytpu_infer_step_phase_seconds_sum', phase=p)
             for p in STEP_PHASES}
    syncs0 = _metric('skytpu_infer_host_syncs_total')
    chunks0 = _metric('skytpu_infer_decode_chunk_duration_seconds_count')
    led0 = (led.steps, led.wall_seconds) if led else None
    b.decode_tokens, b.decode_seconds = 0, 0.0
    _zero(counters)
    t0 = time.perf_counter()
    rids = [b.submit(p, max_new_tokens=48, tenant='ab'[i % 2])
            for i, p in enumerate(prompts)]
    b.run_until_idle()
    wall = time.perf_counter() - t0
    launches = _counts(counters)
    out = [b.result(r) for r in rids]
    if any(len(o) != 48 for o in out):
        raise AssertionError(f'15a {label}: {[len(o) for o in out]} tokens')
    phases = {p: _metric('skytpu_infer_step_phase_seconds_sum', phase=p)
              - sums0[p] for p in STEP_PHASES}
    stats = {
        'card': CARD['line'], 'spans_and_ledger': led is not None,
        'wall_s': wall,
        'decode_tokens_per_s': b.decode_tokens / b.decode_seconds,
        'host_syncs': _metric('skytpu_infer_host_syncs_total') - syncs0,
        'decode_chunks': _metric(
            'skytpu_infer_decode_chunk_duration_seconds_count') - chunks0,
        # Shares of the burst's wall (submits included).
        'phase_share': {p: x / wall for p, x in phases.items() if x},
        'unattributed_share': 1.0 - sum(phases.values()) / wall,
    }
    if led is not None:
        stats['ledger_steps'] = led.steps - led0[0]
        stats['ledger_wall_s'] = led.wall_seconds - led0[1]
        if not 0.0 < stats['ledger_wall_s'] <= wall:
            raise AssertionError(f'15a {label}: the ledger counts '
                                 f'{stats["ledger_wall_s"]!r} s of steps in '
                                 f'a {wall!r} s burst')
        roll = led.tenant_rollup()
        billed = sum(bill.get('device_seconds', 0.0)
                     for bill in roll.values())
        if abs(billed - led.wall_seconds) > 1e-9 * led.wall_seconds:
            raise AssertionError(f'15a {label}: the tenants and _fleet are '
                                 f'billed {billed!r} s of a '
                                 f'{led.wall_seconds!r} s profiler wall')
    return out, stats, launches, rids


def telemetry_path(params, counters, paths, cfg=None, device='cuda'):
    """15a: phase 5's 8 requests (tenants a and b in turn) on two
    batchers on graphs (phase 5's settings), one built with a SpanBuffer
    and a CostLedger (span_buffer=, ledger=) and one without: a warm-up
    burst on each, then in turns (on, off, off, on).  Gates: the same
    tokens in all six; the same host syncs and decode chunks with and
    without; one queue_wait, ceil(P / 256) prefill_chunk and one
    delivery span a request; after each burst with the ledger, the
    tenants' and _fleet's device seconds equal its profiler wall to
    1e-9, and the steps it counts lie inside the burst's wall.  Returns
    the batcher with spans and its SpanBuffer (15b and 15c serve on
    it).  cfg, device: LLAMA3_8B on the card by default (a rehearsal
    passes a tiny config and the CPU)."""
    from skypilot_tpu_torch.infer.engine import GeneratorConfig
    from skypilot_tpu_torch.infer.serving import ContinuousBatcher
    from skypilot_tpu_torch.models import llama
    from skypilot_tpu_torch.telemetry import accounting, spans

    cfg = cfg or llama.LLAMA3_8B
    buf, led = spans.SpanBuffer(), accounting.CostLedger()
    with_spans, without = (ContinuousBatcher(
        params, cfg, GeneratorConfig(max_seq_len=2048, batch_size=8,
                                     prefill_chunk=256),
        decode_chunk=16, device=device, **kw)
        for kw in (dict(span_buffer=buf, ledger=led), {}))
    prompts = _serve_prompts(cfg.vocab_size)
    turns = {True: (with_spans, led), False: (without, None)}
    warm, _, _, _ = _telemetry_run(*turns[True], prompts, counters,
                                   'warm-up on')
    _same_tokens('15a: the warm-up bursts without and with spans and a '
                 'ledger', _telemetry_run(*turns[False], prompts, counters,
                                          'warm-up off')[0], warm)
    # On and off in turns (on, off, off, on); the first on run's counts
    # and spans are the ones checked and reported.
    runs = [_telemetry_run(*turns[on], prompts, counters, label)
            for on, label in ((True, 'on 1'), (False, 'off 1'),
                              (False, 'off 2'), (True, 'on 2'))]
    without.close()
    _, stats_on, launches, rids = runs[0]
    paths['15a'] = launches
    for out, stats, *_ in runs:
        _same_tokens(f'15a: spans and ledger {stats["spans_and_ledger"]} '
                     f'vs the warm-up burst', out, warm)
        for key in ('host_syncs', 'decode_chunks'):
            if stats[key] != stats_on[key]:
                raise AssertionError(
                    f'15a: {key} {stats_on[key]} with spans and a ledger, '
                    f'{stats[key]} in a run with them '
                    f'{stats["spans_and_ledger"]}')
    names = {rid: collections.Counter() for rid in rids}
    for span in buf.snapshot():
        if span.get('request_id') in names:
            names[span['request_id']][span['name']] += 1
    for rid, prompt in zip(rids, prompts):
        want = {'queue_wait': 1, 'delivery': 1,
                'prefill_chunk': -(-len(prompt) // 256)}
        got = {k: names[rid][k] for k in want}
        if got != want:
            raise AssertionError(f'15a: request {rid} (prompt '
                                 f'{len(prompt)}) spans {dict(names[rid])}')
    summary = led.summary()
    stats_on.update(
        spans=len(buf), span_names=dict(collections.Counter(
            s['name'] for s in buf.snapshot())),
        ledger_bursts='warm-up, on 1 and on 2',
        tenant_device_s=summary['tenant_device_seconds'],
        tenant_share=summary['attributed_share'],
        conservation_ratio=summary['conservation_ratio'])
    for _, stats, *_ in runs:
        log('  15a: ' + json.dumps(stats))
    rates = [f'{r[1]["decode_tokens_per_s"]:.2f}' for r in runs]
    log(f'  15a: decode tokens/s with spans and ledger {rates[0]} and '
        f'{rates[3]}, without {rates[1]} and {rates[2]}; identical '
        f'tokens, {stats_on["host_syncs"]:.0f} host syncs and '
        f'{stats_on["decode_chunks"]:.0f} decode chunks every run')
    return with_spans, buf


def _sse(url, path, payload, headers=None):
    """POST `payload` and read a server-sent-events reply to its end:
    (each event's seconds from the request and its data, the whole
    seconds)."""
    import http.client
    import urllib.parse

    parts = urllib.parse.urlsplit(url)
    conn = http.client.HTTPConnection(parts.hostname, parts.port,
                                      timeout=600)
    t0 = time.perf_counter()
    try:
        conn.request('POST', path, body=json.dumps(payload).encode(),
                     headers={'Content-Type': 'application/json',
                              **(headers or {})})
        resp = conn.getresponse()
        if resp.status != 200 or not resp.getheader(
                'Content-Type', '').startswith('text/event-stream'):
            raise AssertionError(f'15b {path}: {resp.status} '
                                 f'{resp.read()[:300]!r}')
        events = []
        while True:
            line = resp.readline()
            if not line:
                break
            if line.startswith(b'data: '):
                events.append((time.perf_counter() - t0,
                               line[6:].strip().decode()))
    finally:
        conn.close()
    return events, time.perf_counter() - t0


def _post_json(url, payload, headers=None):
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(),
        headers={'Content-Type': 'application/json', **(headers or {})})
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=600) as r:
        return json.loads(r.read()), time.perf_counter() - t0


def _readme_text(n):
    """The first n ASCII characters of the repo's README.md (one token a
    byte)."""
    with open(os.path.join(HERE, 'README.md'), encoding='utf-8') as f:
        text = ''.join(c for c in f.read() if ord(c) < 128)
    return (text * (n // len(text) + 1))[:n]


def openai_path(b, buf, counters, paths, cfg=None):
    """15b: the replica over 15a's batcher with spans (buf its
    SpanBuffer): a text /v1/completions plain
    and streamed (the deltas concatenate to the plain text), a streamed
    /v1/chat/completions (the role chunk first), /v1/models, and a
    /generate with the trace header (its id on that request's spans).
    Prints TTFT (the first SSE chunk with text) and the whole
    latency."""
    from skypilot_tpu_torch.infer import replica
    from skypilot_tpu_torch.models import llama

    cfg = cfg or llama.LLAMA3_8B
    server, thread = replica.serve(b, '127.0.0.1', 0, 'llama3-8b', 32)
    url = f'http://127.0.0.1:{server.server_address[1]}'
    stats = {'card': CARD['line']}
    _zero(counters)
    try:
        prompt = _readme_text(600)
        plain, stats['completion_s'] = _post_json(
            url + '/v1/completions', {'prompt': prompt, 'max_tokens': 32})
        if plain['usage'] != {'prompt_tokens': 600, 'completion_tokens': 32,
                              'total_tokens': 632} or \
                plain['choices'][0]['finish_reason'] != 'length':
            raise AssertionError(f'15b completion: {plain}')
        events, stats['stream_s'] = _sse(
            url, '/v1/completions',
            {'prompt': prompt, 'max_tokens': 32, 'stream': True})
        if events[-1][1] != '[DONE]':
            raise AssertionError(f'15b stream: ends {events[-1]}')
        chunks = [(t, json.loads(d)) for t, d in events[:-1]]
        text = ''.join(c['choices'][0]['text'] for _, c in chunks)
        if text != plain['choices'][0]['text']:
            raise AssertionError(f'15b: streamed {text!r} != plain '
                                 f'{plain["choices"][0]["text"]!r}')
        if [c['choices'][0]['finish_reason'] for _, c in chunks][-1] != \
                'length':
            raise AssertionError('15b stream: no terminal finish chunk')
        stats['stream_ttft_s'] = next(t for t, c in chunks
                                      if c['choices'][0]['text'])
        stats['stream_chunks'] = len(chunks)
        events, stats['chat_stream_s'] = _sse(
            url, '/v1/chat/completions',
            {'messages': [{'role': 'user', 'content': _readme_text(300)}],
             'max_tokens': 32, 'stream': True})
        chat = [(t, json.loads(d)) for t, d in events[:-1]]
        if events[-1][1] != '[DONE]' or \
                chat[0][1]['choices'][0]['delta'] != {'role': 'assistant'}:
            raise AssertionError(f'15b chat stream: {events[:2]}')
        stats['chat_ttft_s'] = next(
            t for t, c in chat if c['choices'][0]['delta'].get('content'))
        with urllib.request.urlopen(url + '/v1/models', timeout=60) as r:
            models = json.loads(r.read())
        if models['data'][0]['id'] != 'llama3-8b':
            raise AssertionError(f'15b models: {models}')
        gen, stats['generate_s'] = _post_json(
            url + '/generate', {'prompt': _readme_text(200),
                                'max_new_tokens': 16},
            headers={'X-Skytpu-Trace-Id': 'chip-smoke-15b'})
        traced = collections.Counter(
            s['name'] for s in buf.snapshot()
            if s.get('trace_id') == 'chip-smoke-15b')
        if not {'queue_wait', 'admit', 'prefill_chunk', 'delivery'} <= \
                set(traced) or gen['num_generated'] != 16:
            raise AssertionError(f'15b: trace spans {dict(traced)}, '
                                 f'{gen.get("num_generated")} tokens')
        stats['traced_spans'] = dict(traced)
        paths['15b'] = _counts(counters)
    finally:
        replica.shutdown_replica(server, thread)
    log('  15b: ' + json.dumps(stats))


def _cosine(a, b):
    return float((a * b).sum() / np.linalg.norm(a) / np.linalg.norm(b))


# 15c: the largest relative error (max |v - p| / max |p| a vector) of an
# embedding against encode with the plain attention and norm, bf16 over
# 32 layers.
EMBED_REL_TOL = 0.05


def embeddings_path(b, counters, paths, cfg=None):
    """15c: /v1/embeddings with phase 5's 8 prompts (17-700 tokens: K2
    without its lse at n_pad 8, bucket 1024; K3).  Gates: each input alone
    gives its in-batch vector (cosine >= 0.999), and each vector equals
    encode on the card with the plain attention and norm patched in
    (cosine >= 0.999, max relative error EMBED_REL_TOL), and the same
    encode with its causal mask dropped fails that gate."""
    from skypilot_tpu_torch.infer import llama_infer, replica
    from skypilot_tpu_torch.models import llama
    from skypilot_tpu_torch.ops import attention, rmsnorm

    cfg = cfg or llama.LLAMA3_8B
    prompts = _serve_prompts(cfg.vocab_size)
    server, thread = replica.serve(b, '127.0.0.1', 0, 'llama3-8b')
    url = f'http://127.0.0.1:{server.server_address[1]}/v1/embeddings'
    try:
        _zero(counters)
        body, batch_s = _post_json(url, {'input': prompts})
        alone, alone_s = [], []
        for p in prompts:
            one, s = _post_json(url, {'input': [p]})
            alone.append(np.asarray(one['data'][0]['embedding']))
            alone_s.append(s)
        paths['15c'] = _counts(counters)
    finally:
        replica.shutdown_replica(server, thread)
    vecs = np.asarray([d['embedding'] for d in body['data']])
    if vecs.shape != (8, cfg.d_model) or not np.isfinite(vecs).all() or \
            body['usage']['prompt_tokens'] != sum(SERVE_LENGTHS):
        raise AssertionError(f'15c: {vecs.shape}, {body["usage"]}')
    cos_alone = [_cosine(a, v) for a, v in zip(alone, vecs)]
    # encode with the plain attention and norm, on the card, on the
    # request's padded batch (the module attributes encode reads).
    tokens = np.zeros((8, 1024), np.int32)
    lengths = np.asarray(SERVE_LENGTHS, np.int32)
    for i, p in enumerate(prompts):
        tokens[i, :len(p)] = p
    real = attention.flash_attention, rmsnorm.rms_norm

    def plain_encode(mask):
        attention.flash_attention = (
            lambda q, k, v, causal=True: attention._attention_plain(
                q, k, v, causal and mask))
        rmsnorm.rms_norm = rmsnorm._rms_norm_plain
        try:
            with torch.inference_mode():
                return llama_infer.encode(
                    b.params, torch.as_tensor(tokens, device=b.device), cfg,
                    torch.as_tensor(lengths, device=b.device)).cpu().numpy()
        finally:
            attention.flash_attention, rmsnorm.rms_norm = real

    def against(ref):
        return ([_cosine(r, v) for r, v in zip(ref, vecs)],
                [float(np.abs(v - r).max() / np.abs(r).max())
                 for r, v in zip(ref, vecs)])

    def passes(cos, rel):
        return min(cos) >= 0.999 and max(rel) <= EMBED_REL_TOL

    cos_plain, rel = against(plain_encode(True))
    if min(cos_alone) < 0.999 or not passes(cos_plain, rel):
        raise AssertionError(f'15c: cosine alone {cos_alone}, against the '
                             f'plain versions {cos_plain}, max relative '
                             f'error {rel} (at most {EMBED_REL_TOL})')
    # The gate's power: the plain versions with the causal mask dropped
    # (a planted attention fault) must fail it.
    cos_fault, rel_fault = against(plain_encode(False))
    if passes(cos_fault, rel_fault):
        raise AssertionError(f'15c: the gate passes encode without its '
                             f'causal mask: cosine {cos_fault}, max '
                             f'relative error {rel_fault}')
    log('  15c: ' + json.dumps({
        'card': CARD['line'], 'batch_request_s': batch_s,
        'alone_request_s': alone_s, 'cosine_alone_min': min(cos_alone),
        'cosine_plain_min': min(cos_plain), 'max_rel_err_plain': max(rel),
        'max_rel_err_plain_each': rel, 'max_rel_err_gate': EMBED_REL_TOL,
        'planted_no_causal_mask': {'cosine_min': min(cos_fault),
                                   'max_rel_err': max(rel_fault)}}))


# The child's launch counts (_counts' keys) after an entry point runs in
# it, printed on its last line; its arguments follow the module name.
_CHILD = '''
import json, runpy, sys
from skypilot_tpu_torch.ops import attention, decode_attention, rmsnorm
module = sys.argv[1]
sys.argv = [module] + sys.argv[2:]
try:
    runpy.run_module(module, run_name='__main__', alter_sys=True)
except SystemExit as e:
    if e.code:
        raise
out = {}
for c in (decode_attention.decode_attention_pooled,
          attention.flash_attention, rmsnorm.rms_norm,
          decode_attention.decode_window_attention_pooled,
          decode_attention.fused_step_attention_pooled,
          attention.flash_attention_dq, attention.flash_attention_dkv,
          decode_attention.decode_attention):
    out[c.__name__] = c.launches
    for route, attr in %r.items():
        if hasattr(c, attr):
            out[c.__name__ + '[' + route + ']'] = getattr(c, attr)
print('LAUNCHES ' + json.dumps(out), flush=True)
'''


def _run_child(module, args, timeout=900):
    """Run an entry point as a child process; returns (its stdout lines,
    its launch counts)."""
    env = dict(os.environ, PYTHONPATH=HERE)
    proc = subprocess.run(
        [sys.executable, '-c', _CHILD % (ROUTES,), module] + args,
        cwd=HERE, env=env, capture_output=True, text=True, timeout=timeout)
    if proc.returncode != 0:
        raise AssertionError(f'{module} {" ".join(args)} exited '
                             f'{proc.returncode}:\n{proc.stdout[-3000:]}\n'
                             f'{proc.stderr[-3000:]}')
    lines = proc.stdout.splitlines()
    launches = json.loads(lines[-1][len('LAUNCHES '):])
    return lines[:-1], launches


def batch_infer_path(paths, root, model_size='8b', device_args=(),
                     vocab_size=128256):
    """15d: batch_infer as a child process over 32 JSONL lines (16 text,
    16 prompt_ids, 17-700 tokens, 32 new each; phase 5's settings), then
    the first 12 output lines kept and the rest regenerated with
    --resume.  Gates: 32 distinct ids, none twice, the 12 kept lines
    unchanged.  Prints how many of the 20 regenerated outputs equal the
    first run's (bf16: a batch's composition may change roundings), and
    prompts/s and tokens/s."""
    rng = np.random.RandomState(15)
    text = _readme_text(4000)
    inp = os.path.join(root, 'prompts.jsonl')
    lengths = [SERVE_LENGTHS[i % 8] + i // 8 for i in range(32)]
    with open(inp, 'w', encoding='utf-8') as f:
        for i, n in enumerate(lengths):
            if i % 2:
                rec = {'id': f'text-{i}', 'prompt': text[7 * i:7 * i + n]}
            else:
                rec = {'id': f'ids-{i}', 'prompt_ids': [
                    int(t) for t in rng.randint(0, vocab_size, size=n)]}
            f.write(json.dumps(rec) + '\n')
    args = ['--input', inp, '--model-size', model_size, '--max-seq-len',
            '1024', '--batch-size', '8', '--prefill-chunk', '256',
            '--max-new-tokens', '32'] + list(device_args)
    first = os.path.join(root, 'first.jsonl')
    t0 = time.perf_counter()
    out1, launches1 = _run_child('skypilot_tpu_torch.infer.batch_infer',
                                 args + ['--output', first])
    first_s = time.perf_counter() - t0
    with open(first, encoding='utf-8') as f:
        first_lines = f.read().splitlines()
    resumed = os.path.join(root, 'resumed.jsonl')
    with open(resumed, 'w', encoding='utf-8') as f:
        f.write('\n'.join(first_lines[:12]) + '\n')
    t0 = time.perf_counter()
    out2, launches2 = _run_child('skypilot_tpu_torch.infer.batch_infer',
                                 args + ['--output', resumed, '--resume'])
    resume_s = time.perf_counter() - t0
    with open(resumed, encoding='utf-8') as f:
        lines = f.read().splitlines()
    rows = [json.loads(line) for line in lines]
    ids = [r['id'] for r in rows]
    want_ids = {json.loads(line)['id'] for line in open(inp)}
    if len(rows) != 32 or len(set(ids)) != 32 or set(ids) != want_ids \
            or lines[:12] != first_lines[:12] \
            or any(len(r['output_ids']) != 32 for r in rows):
        raise AssertionError(f'15d: {len(rows)} lines, {len(set(ids))} '
                             f'distinct ids, kept lines unchanged: '
                             f'{lines[:12] == first_lines[:12]}')
    if not any('20 prompts (12 already done)' in line for line in out2):
        raise AssertionError(f'15d: resume said {out2}')
    by_id = {json.loads(line)['id']: json.loads(line)['output_ids']
             for line in first_lines}
    same = sum(by_id[r['id']] == r['output_ids'] for r in rows[12:])
    paths['15d'] = {k: launches1[k] + launches2[k] for k in launches1}
    log('  15d: ' + json.dumps({
        'card': CARD['line'], 'first_run_s': first_s,
        'resume_run_s': resume_s, 'first_run': out1[-1],
        'resume_run': out2[-1],
        'regenerated_equal_to_first_run': f'{same} of 20'}))


def eval_ppl_path(paths, counters, root, model_size='8b', device='cuda'):
    """15e: eval_ppl over a corpus of the repo's own SURVEY.md and
    README.md (seq 2048, batch 4, 4 batches), with --loss-chunk 0 and
    512, in this process, after one untimed batch.  Gate: the two NLLs
    agree to 1e-3 relative.  Prints tokens/s (the batches'
    device-synchronized seconds) and peak memory."""
    import contextlib
    import io

    from skypilot_tpu_torch.train import eval_ppl

    corpus = os.path.join(root, 'corpus.txt')
    with open(corpus, 'w', encoding='utf-8') as out:
        for name in ('SURVEY.md', 'README.md'):
            with open(os.path.join(HERE, name), encoding='utf-8') as f:
                out.write(f.read())
    real = eval_ppl.nll_and_count
    on_card = device == 'cuda'
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    results = {}
    args = ['--data-file', corpus, '--seq-len', '2048', '--batch-size', '4',
            '--model-size', model_size, '--device', device]
    # One untimed batch first: the shapes' first use (cuBLAS, the
    # allocator) lands outside the timed runs.
    with contextlib.redirect_stdout(io.StringIO()):
        eval_ppl.main(args + ['--max-batches', '1'])
    _zero(counters)
    for chunk in (0, 512):
        seconds = [0.0]

        def timed(*args, **kwargs):
            sync()
            t0 = time.perf_counter()
            out = real(*args, **kwargs)
            sync()
            seconds[0] += time.perf_counter() - t0
            return out

        eval_ppl.nll_and_count = timed
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        stdout = io.StringIO()
        try:
            with contextlib.redirect_stdout(stdout):
                eval_ppl.main(args + ['--max-batches', '4', '--loss-chunk',
                                      str(chunk)])
        finally:
            eval_ppl.nll_and_count = real
        line = json.loads(stdout.getvalue().strip().splitlines()[-1])
        line.update(tokens_per_s=line['tokens'] / seconds[0],
                    eval_s=seconds[0],
                    peak_memory_gb=(torch.cuda.max_memory_allocated() / 1e9
                                    if on_card else None))
        results[chunk] = line
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()
    paths['15e'] = _counts(counters)
    a, b = results[0]['nll'], results[512]['nll']
    if not (math.isfinite(a) and abs(a - b) <= 1e-3 * abs(a)) or \
            results[0]['tokens'] != 4 * 4 * 2048:
        raise AssertionError(f'15e: {results}')
    log('  15e: ' + json.dumps({'card': CARD['line'],
                                'loss_chunk_0': results[0],
                                'loss_chunk_512': results[512]}))


# Launch counts by route: '<name>[tc]' the tensor-core kernels of K2, K5
# and K6, '<name>[split]' the split-KV launches of K1 and K7, '<name>[lse]'
# K2's launches that wrote the lse.
# ---- phase 16: tensor-parallel serving --------------------------------------

# Phase 16 runs its ranks as processes that share cuda:0 over gloo: NCCL
# refuses two ranks on one GPU.  That checks every rank's kernels at its
# own shapes and the collectives' semantics on CUDA tensors; no number of
# it is a multi-card rate (NVLink is not on the path).
TP_NEW_TOKENS = 64
# Phase 5's prompt lengths capped at 256 (one prefill a prompt): every
# gloo combine waits for the card, which the ranks share by time
# slices, so a tick's decode chunk costs ~0.3 s a step at 8B.
TP_PROMPT_LENGTHS = [17, 60, 128, 250, 200, 150, 100, 230]
# 16b's first-step logits, bf16 at tp 2 against tp 1: each rank's
# partial products round to bf16 before the rank-order sum (one bf16
# ulp of a partial, ~2^-8 of its scale, a layer), where one card rounds
# the whole product once.  Gate: max |diff| below this share of the
# largest |logit| (measured values in PERF.md section 6).
TP_LOGITS_REL = 0.05


def _pool_process(rank, world, port, device, inbox, outbox):
    """One rank of a RankPool: gloo over 127.0.0.1:port on cuda:0 (or the
    CPU), then each (task, kwargs) of its inbox in turn, its (rank, ok,
    result or traceback) on the outbox, until None; exits 1 if it could
    not join the group."""
    import traceback
    from datetime import timedelta
    import torch.distributed as dist
    try:
        if device == 'cuda':
            torch.cuda.set_device(0)
        dist.init_process_group(
            'gloo', init_method=f'tcp://127.0.0.1:{port}',
            world_size=world, rank=rank, timeout=timedelta(seconds=600))
    except BaseException:
        outbox.put((rank, False, traceback.format_exc()))
        sys.exit(1)
    while True:
        job = inbox.get()
        if job is None:
            break
        task, kwargs = job
        try:
            outbox.put((rank, True, globals()[task](**kwargs)))
        except BaseException:
            outbox.put((rank, False, traceback.format_exc()))
        gc.collect()
        if device == 'cuda':
            torch.cuda.empty_cache()
    dist.destroy_process_group()
    sys.exit(0)


class RankPool:
    """`world` rank processes on `device`, spawned once and reused by
    every task of phases 16-18 (a spawn costs each rank its interpreter,
    torch, a CUDA context and its first kernels' warm-up): run(task,
    timeout, **kwargs) runs the function `task` of this module on every
    rank and returns the results in rank order.  A failed or silent rank
    kills the pool and raises; close() checks every exit code."""

    def __init__(self, world, device):
        import multiprocessing
        from skypilot_tpu_torch.infer import multihost
        ctx = multiprocessing.get_context('spawn')
        self.world = world
        self._outbox = ctx.Queue()
        self._inboxes = [ctx.Queue() for _ in range(world)]
        port = multihost.free_port()
        self._procs = [ctx.Process(
            target=_pool_process, daemon=True,
            args=(r, world, port, device, self._inboxes[r], self._outbox))
            for r in range(world)]
        for p in self._procs:
            p.start()

    def run(self, task, timeout, **kwargs):
        import queue as queue_lib
        for inbox in self._inboxes:
            inbox.put((task, kwargs))
        results, errors = {}, []
        deadline = time.monotonic() + timeout
        while len(results) + len(errors) < self.world:
            try:
                rank, ok, out = self._outbox.get(
                    timeout=max(1.0, deadline - time.monotonic()))
            except queue_lib.Empty:
                break
            (results.__setitem__(rank, out) if ok
             else errors.append((rank, out)))
        if errors or len(results) < self.world:
            self.kill()
            detail = errors[0][1] if errors else 'no result'
            raise AssertionError(f'{task}: ranks failed (results from '
                                 f'{sorted(results)}):\n{detail}')
        return [results[r] for r in range(self.world)]

    def kill(self):
        for p in self._procs:
            if p.is_alive():
                p.kill()
            p.join()

    def close(self):
        for inbox in self._inboxes:
            inbox.put(None)
        for p in self._procs:
            p.join(60)
        codes = [p.exitcode for p in self._procs]
        self.kill()
        if any(codes):
            raise AssertionError(f'rank pool of {self.world}: exit codes '
                                 f'{codes}')


_POOLS = {}


def pooled_ranks(world, task, timeout=900, **kwargs):
    """RankPool.run on the pool of `world` ranks on kwargs' device,
    started on first use; a failure kills and discards the pool, so the
    next task of that size starts a fresh one."""
    key = (world, kwargs.get('device', 'cuda'))
    if key not in _POOLS:
        _POOLS[key] = RankPool(*key)
    try:
        return _POOLS[key].run(task, timeout, **kwargs)
    except BaseException:
        _POOLS.pop(key).kill()
        raise


def close_rank_pools():
    """Stop every RankPool, each rank's exit code checked."""
    while _POOLS:
        _POOLS.popitem()[1].close()


def _kernel_counters():
    from skypilot_tpu_torch.ops import attention, decode_attention, rmsnorm
    da = decode_attention
    return [da.decode_attention_pooled, attention.flash_attention,
            rmsnorm.rms_norm, da.decode_window_attention_pooled,
            da.fused_step_attention_pooled, attention.flash_attention_dq,
            attention.flash_attention_dkv, da.decode_attention]


def _sum_counts(outs, key='counts'):
    total = collections.Counter()
    for o in outs:
        total.update(o[key])
    return dict(total)


def _tp_config(name):
    """Phase 16's configurations by name."""
    from skypilot_tpu_torch.models import llama
    return {
        # 16b at 12 of 32 layers, 16e and 18f at 4, cut for the run's
        # time (16b's memory gate needs the layers to outweigh the f32
        # embedding slab: at 8 a rank's shard and slab pass the model).
        '8b-12': dataclasses.replace(llama.LLAMA3_8B, n_layers=12),
        '8b-4': dataclasses.replace(llama.LLAMA3_8B, n_layers=4),
        '8b-4-f32': dataclasses.replace(llama.LLAMA3_8B, n_layers=4,
                                        dtype=torch.float32),
        '70b-4': dataclasses.replace(llama.LLAMA3_70B, n_layers=4),
        'f32-narrow': llama.LlamaConfig(
            vocab_size=32768, d_model=1024, n_layers=4, n_heads=8,
            n_kv_heads=4, d_ff=2816, max_seq_len=2048,
            dtype=torch.float32, remat=False),
        # Rehearses phase 16 on the host (device='cpu').
        'tiny': llama.LlamaConfig(
            vocab_size=512, d_model=128, n_layers=2, n_heads=8,
            n_kv_heads=4, d_ff=256, max_seq_len=2048, dtype=torch.bfloat16,
            remat=False),
        # Rehearses 18f on the host: head_dim 128, as K7 needs.
        'tiny-hd128': llama.LlamaConfig(
            vocab_size=512, d_model=128, n_layers=2, n_heads=4,
            n_kv_heads=2, d_ff=256, max_seq_len=2048, dtype=torch.bfloat16,
            remat=False, head_dim_override=128),
        'tiny-hd128-f32': llama.LlamaConfig(
            vocab_size=512, d_model=128, n_layers=2, n_heads=4,
            n_kv_heads=2, d_ff=256, max_seq_len=2048, dtype=torch.float32,
            remat=False, head_dim_override=128),
    }[name]


def tp_first_logits(params, cfg, prompts, mesh=None, device='cuda'):
    """Prefill logits (B, vocab) f32 of `prompts` (right-padded to the
    longest) through llama_infer.prefill, on the mesh's shards."""
    from skypilot_tpu_torch.infer import llama_infer
    from skypilot_tpu_torch.infer import tp as tp_lib
    longest = max(len(p) for p in prompts)
    tokens = torch.zeros((len(prompts), longest), dtype=torch.int32)
    for i, p in enumerate(prompts):
        tokens[i, :len(p)] = torch.tensor(p)
    cache = llama_infer.init_cache(tp_lib.local_config(cfg, mesh),
                                   len(prompts), longest, device=device)
    with torch.inference_mode():
        logits, _ = llama_infer.prefill(
            params, tokens.to(device), cfg, cache,
            torch.tensor([len(p) for p in prompts], device=device),
            mesh=mesh)
    return logits.float().cpu()


# 18f's gate on the legacy decode steps themselves: the same tokens fed
# to tp 2 and tp 1 for this many steps after the prefill, each step's
# logits within TP_LOGITS_REL (bf16 greedy tokens part at near ties).
FORCED_STEPS = 8


def tp_forced_decode(params, cfg, prompts, plane, kv_dtype, mesh=None,
                     device='cuda'):
    """Logits (FORCED_STEPS, B, vocab) f32 of the legacy plane `plane`'s
    decode steps (llama_infer.get_decode_fn) over a contiguous cache of
    the mesh's KV heads (int8 for kv_dtype 'int8') after a prefill of
    `prompts`; step j feeds each row token j of its prompt (mod its
    length), the same tokens at every tp."""
    from skypilot_tpu_torch.infer import llama_infer
    from skypilot_tpu_torch.infer import tp as tp_lib
    longest = max(len(p) for p in prompts)
    tokens = torch.zeros((len(prompts), longest), dtype=torch.int32)
    for i, p in enumerate(prompts):
        tokens[i, :len(p)] = torch.tensor(p)
    # K7 reads the cache in blocks of 64 rows.
    max_len = -(-(longest + FORCED_STEPS) // 64) * 64
    cache = llama_infer.init_cache(tp_lib.local_config(cfg, mesh),
                                   len(prompts), max_len, kv_dtype=kv_dtype,
                                   device=device)
    lengths = torch.tensor([len(p) for p in prompts], dtype=torch.int32,
                           device=device)
    with warnings.catch_warnings():
        warnings.simplefilter('ignore', DeprecationWarning)
        step = llama_infer.get_decode_fn(plane)
    out = []
    with torch.inference_mode():
        _, cache = llama_infer.prefill(params, tokens.to(device), cfg, cache,
                                       lengths, mesh=mesh)
        for j in range(FORCED_STEPS):
            fed = torch.tensor([p[j % len(p)] for p in prompts],
                               dtype=torch.int32, device=device)
            logits, cache = step(params, fed, cfg, cache, lengths + j,
                                 mesh=mesh)
            out.append(logits.float().cpu())
    return torch.stack(out)


def tp_serve(params, cfg, gen_kw, prompts, new_tokens, mesh=None,
             device='cuda', graphs=None):
    """Submit every prompt, then run the batcher to idle, with the
    launch counts zeroed just before and read just after.  Returns
    (tokens, counts, stats)."""
    from skypilot_tpu_torch.infer import quant
    from skypilot_tpu_torch.infer.engine import GeneratorConfig
    from skypilot_tpu_torch.infer.serving import ContinuousBatcher
    counters = _kernel_counters()
    b = ContinuousBatcher(params, cfg, GeneratorConfig(**gen_kw),
                          decode_chunk=gen_kw.get('decode_chunk', 16),
                          mesh=mesh, device=device, graphs=graphs)
    try:
        _zero(counters)
        if device == 'cuda':
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        rids = [b.submit(p, max_new_tokens=new_tokens) for p in prompts]
        b.run_until_idle()
        if device == 'cuda':
            torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = _counts(counters)
        out = [b.result(r) for r in rids]
        stats = {'seconds': seconds, 'decode_tokens': b.decode_tokens,
                 'decode_tokens_per_s': b.decode_tokens / max(
                     b.decode_seconds, 1e-9),
                 'spec_proposed': b.spec_proposed,
                 'fused_steps': (b._fuse_policy.stats.steps
                                 if b._fuse_policy else 0),
                 'overlap': b.overlap,
                 'graphs_off_reason': b.graphs_off_reason,
                 'arena_bytes': quant.quantized_bytes(
                     b.pool.arena if b.pool is not None else b._cache)}
    finally:
        b.close()
    for p, toks in zip(prompts, out):
        if len(toks) != new_tokens or not all(
                0 <= t < cfg.vocab_size for t in toks):
            raise AssertionError(f'a request returned {len(toks)} tokens '
                                 f'of {new_tokens}, or one out of range')
    return out, counts, stats


# Serving arms of phase 16 (16b-16d).  overlap_collectives False: the
# synchronous schedule, one gather a combine (16c keeps the default, the
# overlapped combines at 70B's widths; 16e holds them bitwise).
TP_ARMS = {
    'plain': dict(max_seq_len=2048, batch_size=8, prefill_chunk=256,
                  overlap_collectives=False),
    'overlap': dict(max_seq_len=2048, batch_size=8, prefill_chunk=256),
    'int8kv': dict(max_seq_len=2048, batch_size=8, prefill_chunk=256,
                   kv_cache_dtype='int8', overlap_collectives=False),
    # K4 per rank: verify windows (spec_k 4) and the fused lane (prompts
    # past 64 tokens ride the fused steps, one a tick: 4-step chunks).
    'spec': dict(max_seq_len=2048, batch_size=8, prefill_chunk=64,
                 spec_k=4, fuse_budget=64, overlap_collectives=False,
                 decode_chunk=4),
}


def rank_collectives(seed, device='cuda'):
    """16a on one rank of 4: every collective of parallel/collectives.py
    on this rank's seeded f32 and bf16 (8, 4096) inputs (drawn on the
    host, so the parent can draw every rank's), over a ('dp', 'tp') 2 x
    2 mesh and over all 4 ranks; plus the gather's and the backend's
    all-reduce's seconds on CUDA tensors."""
    import torch.distributed as dist
    from skypilot_tpu_torch.parallel import collectives as coll
    from skypilot_tpu_torch.parallel import mesh as mesh_lib
    mesh = mesh_lib.Mesh(np.arange(4).reshape(2, 2), ('dp', 'tp'))
    flat = mesh_lib.Mesh(np.arange(4), ('tp',))
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        x = _collective_input(seed, dist.get_rank(), dtype).to(device)
        res = {}
        for name, m, ax in (('dp', mesh, 'dp'), ('tp', mesh, 'tp'),
                            ('all', flat, 'tp')):
            res[f'gather/{name}'] = coll.ring_all_gather(x, m, ax)
            res[f'tiled/{name}'] = coll.ring_all_gather(x, m, ax,
                                                        tiled=True)
            res[f'scatter/{name}'] = coll.ring_reduce_scatter(x, m, ax)
        for c in (1, 2, 3, 4):
            res[f'psum/{c}'] = coll.pipelined_psum(x, flat, 'tp',
                                                   chunks=c)[0]
        res['allreduce'] = coll.all_reduce_sum(x, mesh, ('dp', 'tp'))
        if any(t.device.type != x.device.type for t in res.values()):
            raise AssertionError('a collective left the device')
        # numpy, not tensors: a tensor put on the queue is shared through
        # a file descriptor that dies with this process.
        out[str(dtype)] = {k: v.float().cpu().numpy()
                           for k, v in res.items()}
    timing = coll.all_gather_bench(flat, 'tp', payload_mb=8, iters=5,
                                   warmup=2, device=device)
    timing_ar = coll.psum_bench(flat, 'tp', payload_mb=8, iters=5,
                                warmup=2, device=device)
    return {'results': out, 'gather_8mb': timing, 'allreduce_8mb': timing_ar}


def _collective_input(seed, rank, dtype):
    gen = torch.Generator().manual_seed(seed * 100 + rank)
    return torch.randn(8, 4096, generator=gen).to(dtype)


def rank_fail(fail_rank, device='cuda'):
    """16a's check of the pool: rank `fail_rank` raises (None: none
    does), the others succeed."""
    import torch.distributed as dist
    if dist.get_rank() == fail_rank:
        raise RuntimeError(f'rank {fail_rank} fails on purpose')
    return {'ok': True, 'rank': dist.get_rank()}


def rank_serve(config, tp, seed, arms, prompt_lengths, hf_dir=None,
               forced=(), device='cuda'):
    """16b-16d on one rank: this rank's shards of `config` (drawn by
    init_sharded_params from `seed`, or read from hf_dir by
    load_hf_model_sharded), the first-step logits of the prompts, and
    each (arm of TP_ARMS, new tokens) of `arms` served through the
    batcher with the counts zeroed before it, then each (plane, kv
    dtype) of `forced` through tp_forced_decode.  Returns tokens,
    counts and stats by arm, rank 0's forced logits, and the rank's
    shard bytes and peak device memory."""
    from skypilot_tpu_torch.infer import quant
    from skypilot_tpu_torch.infer import tp as tp_lib
    from skypilot_tpu_torch.models import convert
    cuda = device == 'cuda'
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    if hf_dir:
        cfg = convert.read_hf_config(hf_dir)
        mesh = tp_lib.make_tp_mesh(tp, n_kv_heads=cfg.n_kv_heads)
        params, cfg = convert.load_hf_model_sharded(hf_dir, mesh,
                                                    device=device)
    else:
        cfg = _tp_config(config)
        mesh = tp_lib.make_tp_mesh(tp, n_kv_heads=cfg.n_kv_heads)
        params = tp_lib.init_sharded_params(
            cfg, torch.Generator(device=device).manual_seed(seed), mesh,
            device)
    if cuda:
        torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    init_peak = torch.cuda.max_memory_allocated() if cuda else 0
    shard = quant.quantized_bytes(params)
    prompts = _serve_prompts(cfg.vocab_size)
    prompts = [p[:n] for p, n in zip(prompts, prompt_lengths)]
    logits = tp_first_logits(params, cfg, prompts, mesh, device)
    out = {'rank': mesh.rank, 'coords': mesh.coords, 'shape': mesh.shape,
           'shard_bytes': shard, 'init_s': init_s, 'init_peak': init_peak,
           'logits': logits.numpy() if mesh.rank == 0 else None,
           'logits_sha': hashlib.sha256(logits.numpy().tobytes()).hexdigest(),
           'arms': {}}
    for arm, new_tokens in arms:
        toks, counts, stats = tp_serve(params, cfg, TP_ARMS[arm], prompts,
                                       new_tokens, mesh, device)
        out['arms'][arm] = {'tokens': toks, 'counts': counts,
                            'stats': stats, 'new_tokens': new_tokens}
    out['forced'] = {}
    for plane, kv_dtype in forced:
        got = tp_forced_decode(params, cfg, prompts, plane, kv_dtype, mesh,
                               device)
        out['forced'][(plane, kv_dtype)] = (got.numpy() if mesh.rank == 0
                                            else None)
    out['peak'] = torch.cuda.max_memory_allocated() if cuda else 0
    return out


def rank_overlap(config, tp, seed, chunks, new_tokens, device='cuda'):
    """16e on one rank: the Generator at each overlap chunk count (1 is
    the synchronous path: overlap_collectives False), its greedy tokens
    and every decode step's last hidden states (the final norm's
    input), each run's against the synchronous one's on this rank: the
    tokens matched before the first difference, and the hidden states'
    max abs difference over the steps before it."""
    from skypilot_tpu_torch.infer import engine, llama_infer
    from skypilot_tpu_torch.infer import tp as tp_lib
    cfg = _tp_config(config)
    mesh = tp_lib.make_tp_mesh(tp, n_kv_heads=cfg.n_kv_heads)
    params = tp_lib.init_sharded_params(
        cfg, torch.Generator(device=device).manual_seed(seed), mesh, device)
    prompts = [p[:48] for p in _serve_prompts(cfg.vocab_size)]
    counters = _kernel_counters()
    final = llama_infer._final
    runs = {}
    try:
        for c in chunks:
            seen = []

            def record(h, *args):
                seen.append(h.float().clone())
                return final(h, *args)
            llama_infer._final = record
            gen = engine.Generator(params, cfg, engine.GeneratorConfig(
                max_seq_len=256, batch_size=8, prompt_buckets=[64],
                decode_chunk=8, overlap_collectives=c > 1,
                overlap_chunks=c if c > 1 else None), mesh=mesh,
                device=device)
            _zero(counters)
            if device == 'cuda':
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            toks = gen.generate(prompts, max_new_tokens=new_tokens)
            if device == 'cuda':
                torch.cuda.synchronize()
            runs[c] = {'tokens': toks, 'hidden': seen, 'overlap': gen.overlap,
                       'seconds': time.perf_counter() - t0,
                       'counts': _counts(counters)}
    finally:
        llama_infer._final = final
    sync = runs[chunks[0]]
    out = {}
    for c, run in runs.items():
        matched = _matched(run['tokens'], sync['tokens'])
        # Decode step j reads token j: comparable while tokens 0..j match.
        steps = max(1, min(min(matched), len(run['hidden']),
                           len(sync['hidden'])))
        diffs = [(a - b).abs().max().item() for a, b in
                 zip(run['hidden'][:steps], sync['hidden'][:steps])]
        out[c] = {'tokens': run['tokens'], 'matched': matched,
                  'hidden_max_abs_diff': diffs,
                  'hidden_max_abs': [h.abs().max().item()
                                     for h in sync['hidden'][:steps]],
                  'overlap': run['overlap'], 'steps': len(run['hidden']),
                  'seconds': run['seconds'], 'counts': run['counts']}
    return out


def overlap_projection_ms(d_model, widths, chunks=(2, 4), rows=8,
                          eps=1e-5):
    """One rank's projections of a layer on the card, no collective: the
    synchronous path's h + partial, K3 and the whole products for q/k/v
    and gate/up, against _combine_then_project's span products at each
    chunk count (mesh None: the spans arrive without a gather).  widths:
    the rank's (wq, wk, wv, w_gate, w_up) output widths.  Returns ms
    (time_ms, eager) and graph ms by variant."""
    from skypilot_tpu_torch.infer import llama_infer, quant
    from skypilot_tpu_torch.ops import rmsnorm as rmsnorm_ops
    gen = torch.Generator(device='cuda').manual_seed(11)

    def draw(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen, device='cuda') * scale
                ).to(torch.bfloat16)
    h = draw(rows, 1, d_model)
    parts = [draw(rows, 1, d_model), draw(rows, 1, d_model)]
    gains = [1 + draw(d_model, scale=0.1), 1 + draw(d_model, scale=0.1)]
    groups = [[draw(d_model, f, scale=d_model ** -0.5) for f in widths[:3]],
              [draw(d_model, f, scale=d_model ** -0.5) for f in widths[3:]]]

    def whole():
        for part, gain, ws in zip(parts, gains, groups):
            x = rmsnorm_ops.rms_norm(h + part, gain, eps=eps)
            for w in ws:
                quant.matmul(x, w)

    def spans(c):
        def run():
            for part, gain, ws in zip(parts, gains, groups):
                llama_infer._combine_then_project(part, h, gain, ws, None,
                                                  c, eps)
        return run
    variants = {'whole': whole}
    variants.update({f'spans_{c}': spans(c) for c in chunks})
    with torch.inference_mode():
        return {name: {'ms': time_ms(fn), 'graph_ms': graph_ms(fn)}
                for name, fn in variants.items()}


def tp_collectives_path(device='cuda'):
    """16a: 4 ranks run every collective on f32 and bf16 CUDA tensors;
    each result is held bitwise to the stack or the sum in that rank's
    order computed here in one process (rank-order sums: rank 0 first;
    reduce-scatter: the ring's arrival order d+1, ..., d).  Then
    _pool_failure_check."""
    seed = 5
    outs = pooled_ranks(4, 'rank_collectives', timeout=240, seed=seed,
                     device=device)
    fibers = {'dp': lambda r: [r % 2, r % 2 + 2],
              'tp': lambda r: [r - r % 2, r - r % 2 + 1],
              'all': lambda r: [0, 1, 2, 3]}
    checked = 0
    for dtype in (torch.float32, torch.bfloat16):
        xs = [_collective_input(seed, r, dtype).to(device) for r in range(4)]
        total = xs[0]
        for x in xs[1:]:
            total = total + x
        for r, out in enumerate(outs):
            got = out['results'][str(dtype)]
            want = {'allreduce': total}
            for c in (1, 2, 3, 4):
                want[f'psum/{c}'] = total
            for name, fiber_of in fibers.items():
                fiber = fiber_of(r)
                n, d = len(fiber), fiber.index(r)
                stack = torch.stack([xs[p] for p in fiber])
                want[f'gather/{name}'] = stack
                want[f'tiled/{name}'] = stack.reshape(-1, 4096)
                c = 8 // n
                acc = xs[fiber[(d + 1) % n]][d * c:(d + 1) * c]
                for t in range(2, n + 1):
                    acc = acc + xs[fiber[(d + t) % n]][d * c:(d + 1) * c]
                want[f'scatter/{name}'] = acc
            for key, w in want.items():
                if not torch.equal(torch.from_numpy(got[key]),
                                   w.float().cpu()):
                    raise AssertionError(f'16a {key} {dtype} rank {r}: not '
                                         f'bitwise the one-process result')
                checked += 1
    _pool_failure_check(device)
    stats = {'card': CARD.get('line'), 'bitwise_checks': checked,
             'gather_8mb_s': outs[0]['gather_8mb']['time_s'],
             'gloo_allreduce_8mb_s': outs[0]['allreduce_8mb']['time_s'],
             'note': 'gloo over the host, 4 ranks on one card: not a '
                     'multi-card rate'}
    log('  16a collectives: ' + json.dumps(stats))
    return stats


def _pool_failure_check(device='cuda'):
    """16a's check of RankPool: a task whose rank 1 raises fails, naming
    that rank's traceback, and the pool of 2 is killed and discarded, so
    the next task of 2 ranks (16b's) starts a fresh pool, whose exit
    codes close_rank_pools checks."""
    key = (2, device)
    try:
        pooled_ranks(2, 'rank_fail', timeout=120, fail_rank=1,
                     device=device)
    except AssertionError as e:
        if 'rank 1 fails on purpose' not in str(e):
            raise
    else:
        raise AssertionError('16a: a pool task with a failing rank passed')
    if key in _POOLS:
        raise AssertionError('16a: the failed pool was not discarded')


def _matched(a, b):
    """Tokens of each request equal before its first difference."""
    out = []
    for x, y in zip(a, b):
        n = 0
        while n < min(len(x), len(y)) and x[n] == y[n]:
            n += 1
        out.append(n)
    return out


def _ranks_agree(outs, label):
    shas = {o['logits_sha'] for o in outs}
    if len(shas) != 1:
        raise AssertionError(f'{label}: ranks hold different logits')
    for arm in outs[0]['arms']:
        toks = [o['arms'][arm]['tokens'] for o in outs]
        if any(t != toks[0] for t in toks):
            raise AssertionError(f'{label} {arm}: ranks sampled different '
                                 f'tokens')


def tp_compare(label, outs, params, cfg, prompt_lengths, exact=False,
               device='cuda'):
    """The ranks' first-step logits and tokens against tp=1 on `params`
    (the same weights, whole, in this process): the logits' max abs
    difference, gated at TP_LOGITS_REL of the largest |logit| (or
    identical greedy tokens where exact), and each request's tokens
    matched before its first difference, by arm.  Returns the stats."""
    prompts = [p[:n] for p, n in zip(_serve_prompts(cfg.vocab_size),
                                     prompt_lengths)]
    one = tp_first_logits(params, cfg, prompts, device=device)
    got = torch.from_numpy(outs[0]['logits'])
    diff = (got - one).abs().max().item()
    scale = one.abs().max().item()
    stats = {'card': CARD.get('line'),
             'first_logits_max_abs_diff': diff, 'max_abs_logit': scale,
             'first_argmax_equal': int((got.argmax(-1) == one.argmax(-1))
                                       .sum()),
             'arms': {}}
    if not exact and diff > TP_LOGITS_REL * scale:
        raise AssertionError(f'{label}: first-step logits differ by {diff} '
                             f'(> {TP_LOGITS_REL} of {scale})')
    for arm, res in outs[0]['arms'].items():
        new_tokens = res['new_tokens']
        toks1, _, stats1 = tp_serve(params, cfg, TP_ARMS[arm], prompts,
                                    new_tokens, device=device)
        matched = _matched(res['tokens'], toks1)
        if exact and res['tokens'] != toks1:
            raise AssertionError(f'{label} {arm}: tp tokens differ from '
                                 f'tp=1 (matched {matched})')
        stats['arms'][arm] = {
            'matched_before_first_difference': matched,
            'identical_requests': sum(m == new_tokens for m in matched),
            'tp_decode_tokens_per_s': res['stats']['decode_tokens_per_s'],
            'tp1_decode_tokens_per_s': stats1['decode_tokens_per_s'],
            'tp_seconds': res['stats']['seconds'],
            'overlap': res['stats']['overlap'],
            'graphs_off_reason': res['stats']['graphs_off_reason'],
            'spec_proposed': res['stats']['spec_proposed'],
            'fused_steps': res['stats']['fused_steps']}
    log(f'  {label}: ' + json.dumps(stats))
    return stats


def tp_memory(label, outs, cfg):
    """Each rank's shard, arena and peak device bytes against the whole
    model's: a rank holds its shard, its arena and at most one drawn
    f32 slab (the largest, the (vocab, d) embedding), never the model."""
    from skypilot_tpu_torch.models import llama
    model = cfg.num_params() * torch.empty((), dtype=cfg.dtype).element_size()
    slab = cfg.vocab_size * cfg.d_model * 4
    rows = []
    for o in outs:
        arena = max(a['stats']['arena_bytes'] for a in o['arms'].values())
        row = {'rank': o['rank'], 'shard_gb': o['shard_bytes'] / 1e9,
               'arena_gb': arena / 1e9, 'init_peak_gb': o['init_peak'] / 1e9,
               'peak_gb': o['peak'] / 1e9, 'init_s': o['init_s']}
        limit = o['shard_bytes'] + arena + slab + (2 << 30)
        if o['peak'] > limit or o['peak'] >= model:
            raise AssertionError(f'{label} rank {o["rank"]}: peak '
                                 f'{o["peak"]} bytes, past its shard + '
                                 f'arena + one slab ({limit}) or the model '
                                 f'({model})')
        rows.append(row)
    stats = {'card': CARD.get('line'), 'model_gb': model / 1e9,
             'largest_f32_slab_gb': slab / 1e9, 'ranks': rows}
    del llama
    log(f'  {label} memory: ' + json.dumps(stats))
    return stats


def tp_serve_path(paths):
    """16b: LLAMA3_8B's widths at 12 of its 32 layers (cut for time) at
    tp 2, bf16, int8 KV and spec_k 4 + fuse_budget 64 (K4 per rank),
    against tp 1 on the same seed; then the f32 narrow config at tp 2,
    whose greedy tokens must equal tp 1's.  Its pool of 2 is the fresh
    one after 16a's failing pool (_pool_failure_check)."""
    from skypilot_tpu_torch.models import llama
    lengths = TP_PROMPT_LENGTHS
    outs = pooled_ranks(2, 'rank_serve', timeout=600, config='8b-12', tp=2,
                     seed=0, arms=[('plain', TP_NEW_TOKENS),
                                   ('int8kv', TP_NEW_TOKENS), ('spec', 8)],
                     prompt_lengths=lengths)
    _ranks_agree(outs, '16b')
    for arm, key in (('plain', '16b'), ('int8kv', '16b-int8'),
                     ('spec', '16b-spec')):
        paths[key] = _sum_counts([o['arms'][arm] for o in outs])
    cfg = _tp_config('8b-12')
    params = llama.init_params(
        cfg, torch.Generator(device='cuda').manual_seed(0), 'cuda')
    stats = tp_compare('16b LLAMA3_8B widths, 12 layers, tp 2 vs tp 1', outs,
                       params, cfg, lengths)
    stats['memory'] = tp_memory('16b', outs, cfg)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    outs = pooled_ranks(2, 'rank_serve', timeout=300, config='f32-narrow', tp=2,
                     seed=1, arms=[('plain', 32)], prompt_lengths=lengths)
    _ranks_agree(outs, '16b f32')
    cfg = _tp_config('f32-narrow')
    params = llama.init_params(
        cfg, torch.Generator(device='cuda').manual_seed(1), 'cuda')
    stats['f32'] = tp_compare('16b f32 narrow tp 2 vs tp 1', outs, params,
                              cfg, lengths, exact=True)
    return stats


def tp_70b_path(paths):
    """16c: LLAMA3_70B's widths at 4 of its 80 layers, tp 4: sharded
    random init (each rank's peak against its shard), 4 requests served,
    against tp 1 at the same depth (~11 GB on one card)."""
    from skypilot_tpu_torch.models import llama
    lengths = TP_PROMPT_LENGTHS[:4]
    outs = pooled_ranks(4, 'rank_serve', timeout=600, config='70b-4', tp=4,
                     seed=0, arms=[('overlap', 16)], prompt_lengths=lengths)
    _ranks_agree(outs, '16c')
    paths['16c'] = _sum_counts([o['arms']['overlap'] for o in outs])
    cfg = _tp_config('70b-4')
    memory = tp_memory('16c', outs, cfg)
    params = llama.init_params(
        cfg, torch.Generator(device='cuda').manual_seed(0), 'cuda')
    stats = tp_compare('16c LLAMA3_70B widths, 4 layers, tp 4 vs tp 1',
                       outs, params, cfg, lengths)
    stats['memory'] = memory
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return stats


def tp_qwen_path(paths, root):
    """16d: Qwen2.5-1.5B (2 KV heads) at tp 4 = tp_kv 2 x tpq 2, read by
    load_hf_model_sharded from HF-layout files (phase 12's writer and
    draws), against load_hf_model at tp 1."""
    from skypilot_tpu_torch.models import convert
    directory = os.path.join(root, 'qwen')
    write_hf_checkpoint(
        directory, QWEN25_1_5B,
        lambda name, shape: draw_hf_tensor(name, shape, 0, torch.bfloat16,
                                           'cuda'), torch.bfloat16)
    lengths = TP_PROMPT_LENGTHS
    outs = pooled_ranks(4, 'rank_serve', timeout=400, config=None, tp=4, seed=0,
                     arms=[('plain', 16)], prompt_lengths=lengths,
                     hf_dir=directory)
    _ranks_agree(outs, '16d')
    if outs[0]['shape'] != {'tp': 2, 'tpq': 2}:
        raise AssertionError(f'16d mesh {outs[0]["shape"]}')
    paths['16d'] = _sum_counts([o['arms']['plain'] for o in outs])
    params, cfg = convert.load_hf_model(directory, device='cuda')
    stats = tp_compare('16d Qwen2.5-1.5B tp 4 (2 x tpq 2) vs tp 1', outs,
                       params, cfg, lengths)
    stats['memory'] = tp_memory('16d', outs, cfg)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return stats


def tp_overlap_path(paths):
    """16e: LLAMA3_8B's widths at 4 layers (8 before phase 18, cut for
    time), tp 2: the Generator at
    overlap_chunks 2 and 4 against the synchronous path.  f32: greedy
    tokens identical.  bf16: tokens matched before the first difference
    and the hidden states' max abs difference, the first step's gated at
    TP_LOGITS_REL of its largest.  Then one rank's projections a layer
    (8B tp 2, 70B tp 4), whole against the spans."""
    chunks = [1, 2, 4]
    stats = {'card': CARD.get('line')}
    for config in ('8b-4-f32', '8b-4'):
        outs = pooled_ranks(2, 'rank_overlap', timeout=400, config=config,
                         tp=2, seed=0, chunks=chunks, new_tokens=16)
        sync = outs[0][chunks[0]]['tokens']
        for r, out in enumerate(outs):
            for c in chunks:
                want = None if c == 1 else c
                if out[c]['overlap'] != want:
                    raise AssertionError(f'16e: overlap {out[c]["overlap"]}')
                if out[c]['tokens'] != outs[0][c]['tokens']:
                    raise AssertionError(f'16e {config}: ranks differ')
                if config.endswith('f32') and out[c]['tokens'] != sync:
                    raise AssertionError(
                        f'16e {config} rank {r}: {c} chunks give other '
                        f'tokens than the synchronous path '
                        f'(matched {out[c]["matched"]})')
                first = out[c]['hidden_max_abs_diff'][0]
                if first > TP_LOGITS_REL * out[c]['hidden_max_abs'][0]:
                    raise AssertionError(
                        f'16e {config} rank {r}: {c} chunks\' first hidden '
                        f'states differ by {first}')
        if not config.endswith('f32'):
            paths['16e'] = _sum_counts([o[c] for o in outs for c in chunks])
        stats[config] = {
            str(c): {'matched_before_first_difference':
                     outs[0][c]['matched'],
                     'hidden_max_abs_diff': max(
                         max(o[c]['hidden_max_abs_diff']) for o in outs),
                     'first_hidden_max_abs_diff': max(
                         o[c]['hidden_max_abs_diff'][0] for o in outs),
                     'hidden_max_abs': outs[0][c]['hidden_max_abs'][0],
                     'seconds': outs[0][c]['seconds']}
            for c in chunks}
        stats[config]['decode_steps'] = outs[0][1]['steps']
    stats['projection_ms_8b_tp2'] = overlap_projection_ms(
        4096, (2048, 512, 512, 7168, 7168))
    stats['projection_ms_70b_tp4'] = overlap_projection_ms(
        8192, (2048, 256, 256, 7168, 7168))
    log('  16e overlap: ' + json.dumps(stats))
    return stats


def tp_channel_path():
    """16f: a head and one worker (two rank processes on the card over
    gloo) through the control channel: MultiHostBatcher submit, ping,
    step, result and shutdown; the head's greedy tokens equal the
    one-process baseline's (multihost_check.run_check)."""
    from skypilot_tpu_torch.infer import multihost_check
    t0 = time.perf_counter()
    base = multihost_check.baseline_decode('cuda')
    out = multihost_check.run_check(2, 1, timeout_s=300, baseline=base,
                                    device='cuda')
    stats = {'card': CARD.get('line'), 'tokens': out,
             'seconds': time.perf_counter() - t0}
    log('  16f control channel: ' + json.dumps(stats))
    return stats


ROUTES = {'tc': 'launches_tc', 'split': 'launches_split',
          'lse': 'launches_lse'}


# ---- phase 17: training meshes ---------------------------------------------

# Phases 17 and 18's configurations: LLAMA_1B at phase 8a's settings
# and at 4 of its 16 layers (17a, 17d, 18a, 18c), cut for time;
# an f32 config at hd 128 (phase 16e's widths, its 32,768 vocabulary and
# 4 layers, remat on so the recompute runs the fsdp gathers again),
# LLAMA3_8B's widths at 2 layers (17c, 18d), train_moe's 'small' model;
# 'tiny*' rehearse the phases on the host (device='cpu').
def _mesh_train_config(name):
    from skypilot_tpu_torch.models import llama
    from skypilot_tpu_torch.train import train_moe
    remat = dict(remat=True, remat_policy='dots')
    one_b = dataclasses.replace(llama.LLAMA_1B, max_seq_len=8192,
                                loss_chunk=256, **remat)
    tiny = llama.LlamaConfig(vocab_size=512, d_model=128, n_layers=2,
                             n_heads=8, n_kv_heads=4, d_ff=256,
                             max_seq_len=2048, dtype=torch.bfloat16,
                             loss_chunk=16, **remat)
    return {
        '1b': one_b,
        'f32': llama.LlamaConfig(
            vocab_size=32768, d_model=1024, n_layers=4, n_heads=8,
            n_kv_heads=4, d_ff=2816, max_seq_len=2048, dtype=torch.float32,
            remat=True),
        '8b-2': dataclasses.replace(llama.LLAMA3_8B, n_layers=2,
                                    max_seq_len=4096, loss_chunk=512,
                                    **remat),
        # LLAMA_1B at 4 of its 16 layers (17d, 18c), cut for time.
        '1b-4': dataclasses.replace(one_b, n_layers=4),
        'moe-small': train_moe.PRESETS['small'],
        'tiny': tiny,
        'tiny-4': dataclasses.replace(tiny, n_layers=4),
        'tiny-f32': dataclasses.replace(tiny, dtype=torch.float32),
        'tiny-f32-4': dataclasses.replace(tiny, dtype=torch.float32,
                                          n_layers=4),
        'tiny-moe': dataclasses.replace(
            train_moe.PRESETS['debug'], n_heads=4, n_kv_heads=2,
            dtype=torch.bfloat16, remat=True),
    }[name]


# bf16 tolerances of a mesh step against one card (17a, 17c-17e), set
# from the card's readings (PERF.md section 4): both compute in bf16 and
# round at other places (a rank rounds its partial products, and the
# combines and the fsdp reduce-scatter add bf16 partials), so
# activations differ by about one bf16 ulp an element; the loss, an f32
# mean over thousands of tokens, averages those out.  A dense step's
# loss: a few times the largest gap read on the card.  MoE's (17e) is
# larger: a rounded router logit flips a token's top-k experts now and
# then.  The gradient norm is itself rounded to bf16 (one ulp is 2^-8
# to 2^-7 of it): within two to four ulps.
MESH_LOSS_REL = 1e-4
MESH_MOE_LOSS_REL = 6e-4
MESH_NORM_REL = 2 ** -6
# f32 (17b): sums in another order only.
MESH_F32_REL = 1e-5

# Phase 17's arms: name -> (rank task, kwargs, one-card reference or
# None).  All run in ONE spawn of 4 ranks (a spawn costs ~10 s, and its
# first step pays the ranks' warm-up), in this order.
_TC_1B = dict(warmup_steps=2, total_steps=12)
_TC_F32 = dict(learning_rate=1e-3, warmup_steps=1, total_steps=8)
# 17a and 17d run LLAMA_1B at 4 of its 16 layers, cut for the run's
# time when phase 18 came.
MESH_ARMS = {
    '17a': ('mesh_train', dict(config='1b-4', mesh_kw={'fsdp': 2, 'tp': 2},
                               batch=4, seq=1024, steps=4, tc_kw=_TC_1B)),
    '17b-dp2-fsdp2': ('mesh_train', dict(
        config='f32', mesh_kw={'dp': 2, 'fsdp': 2}, batch=4, seq=256,
        steps=3, tc_kw=_TC_F32, gather=True)),
    '17b-fsdp2-tp2': ('mesh_train', dict(
        config='f32', mesh_kw={'fsdp': 2, 'tp': 2}, batch=4, seq=256,
        steps=3, tc_kw=_TC_F32, gather=True)),
    '17c': ('mesh_train', dict(config='8b-2', mesh_kw={'fsdp': 4}, batch=4,
                               seq=2048, steps=1,
                               tc_kw=dict(warmup_steps=2, total_steps=6))),
    '17d': ('rank_long_context', dict(config='1b-4', seq=8192)),
    '17e-ep4': ('rank_moe', dict(config='moe-small', mesh_kw={'ep': 4},
                                 batch=4, seq=2048, steps=2)),
    '17e-ep2dp2': ('rank_moe', dict(config='moe-small',
                                    mesh_kw={'ep': 2, 'dp': 2}, batch=4,
                                    seq=2048, steps=2)),
    '17f': ('rank_ckpt', dict(config='f32', mesh_kw={'fsdp': 2, 'tp': 2},
                              batch=4, seq=256, tc_kw=_TC_F32)),
}
# The host rehearsal's sizes (device='cpu').
# The bf16 arms keep 2,048 tokens a batch: the loss gates rest on
# their averaging.
MESH_ARMS_TINY = {
    '17a': dict(config='tiny', seq=512), '17b-dp2-fsdp2': dict(
        config='tiny-f32', seq=64), '17b-fsdp2-tp2': dict(
        config='tiny-f32', seq=64), '17c': dict(config='tiny', seq=512),
    '17d': dict(config='tiny', seq=2048), '17e-ep4': dict(
        config='tiny-moe', seq=512, batch=4), '17e-ep2dp2': dict(
        config='tiny-moe', seq=512, batch=4), '17f': dict(
        config='tiny-f32', seq=64)}


def _mesh_model(cfg):
    from skypilot_tpu_torch.models import llama, moe
    from skypilot_tpu_torch.parallel import sharding
    if hasattr(cfg, 'n_experts'):
        return moe, sharding.MOE_RULES
    return llama, sharding.LLAMA_RULES


def _state_bytes(tr):
    """A trainer's parameters, gradients and the two moments, in bytes
    (the gradients as the parameters)."""
    leaves = tr._leaves + tr.opt_state['mu'] + tr.opt_state['nu']
    return (sum(p.numel() * p.element_size() for p in leaves)
            + sum(p.numel() * p.element_size() for p in tr._leaves))


def _gathered_layer_bytes(tr, cfg):
    """The bytes of one layer's weights after this rank's fsdp gather:
    every stacked leaf's layer, its fsdp dims whole, the rest its
    block."""
    total = 0
    for x, sh in zip(tr._leaves, tr._shardings):
        if x.ndim and x.shape[0] == cfg.n_layers:
            n = tr.mesh.axis_size('fsdp') if 'fsdp' in str(sh.spec) else 1
            total += x[0].numel() * x.element_size() * n
    return total


def _np_tree(tree):
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    x = tree.detach().cpu()
    # A copy: on the host .cpu() is the parameter, updated in place.
    return np.array((x.float() if x.dtype == torch.bfloat16 else x).numpy())


def _whole(tr, mesh, rules):
    """The trainer's parameters put together (numpy) on every rank."""
    from skypilot_tpu_torch.parallel import sharding
    if mesh is None:
        return _np_tree(tr.params)
    return sharding.gather_params(tr.params, mesh, rules)


def mesh_train(config, mesh_kw=None, batch=4, seq=1024, steps=4, tc_kw=None,
               device='cuda', gather=False, counters=True, seed=0,
               restore=None, save=None, microbatches=None,
               sequence_axis=None):
    """`steps` Trainer steps of `config` from seed 0 on synthetic batches
    (seed `seed`): on this rank's blocks of a mesh (mesh_kw), or on one
    device (mesh_kw None; its checkpoints a one-process grid).  With
    `microbatches` the mesh's loss runs llama.forward_pipelined over its
    'pp' axis in that many microbatches (sequence_axis 'sp': pp x sp),
    each pp rank holding every layer, as the rules give.  Launch
    counts are set to 0 just before the steps and read just after.
    Returns each step's loss, grad norm and seconds, the peak device
    bytes, the state's bytes, the counts, and (gather) the parameters
    as restored and after the steps, put together (every rank gathers;
    rank 0 alone returns them, the same on every rank)."""
    from skypilot_tpu_torch.parallel import mesh as mesh_lib
    from skypilot_tpu_torch.parallel import sharding
    from skypilot_tpu_torch.train import trainer
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = _mesh_train_config(config)
    model, rules = _mesh_model(cfg)
    mesh = (mesh_lib.make_mesh(mesh_lib.MeshConfig(**mesh_kw))
            if mesh_kw else None)
    cuda = device == 'cuda'
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=device).manual_seed(0)
    tc = trainer.TrainConfig(**(tc_kw or {}))
    if mesh is None:
        params = model.init_params(cfg, gen, device)
        tr = trainer.Trainer(lambda p, b: model.loss_fn(p, b, cfg), params,
                             tc, device=device)
        for path in (restore, save):
            if path:
                tr.checkpoint_manager(path, process_index=0,
                                      process_count=1)
    else:
        params = model.init_params(cfg, gen, device,
                                   shard=sharding.init_shard(mesh, rules))
        loss = (_pipelined_loss(cfg, mesh, microbatches, sequence_axis)
                if microbatches else
                (lambda p, b: model.loss_fn(p, b, cfg, mesh=mesh)))
        tr = trainer.Trainer(loss, params, tc, device=device, mesh=mesh,
                             rules=rules, params_sharded=True)
    del params
    out = {'rank': 0 if mesh is None else mesh.rank, 'losses': [],
           'norms': [], 'step_s': []}
    if restore:
        out['restored'] = tr.restore_latest(restore)
        if gather:
            whole = _whole(tr, mesh, rules)
            if out['rank'] == 0:
                out['restored_params'] = whole
    kernels = _kernel_counters() if counters else []
    batches = trainer.synthetic_batches(batch, seq, cfg.vocab_size, seed)
    _zero(kernels)
    for _ in range(steps):
        t0 = time.perf_counter()
        m = tr.run_step(next(batches))
        out['losses'].append(float(m['loss']))
        out['norms'].append(float(m['grad_norm']))
        out['step_s'].append(time.perf_counter() - t0)
    out['counts'] = _counts(kernels)
    if save:
        tr.save_checkpoint(save)
    out['peak'] = torch.cuda.max_memory_allocated() if cuda else 0
    out['state_bytes'] = _state_bytes(tr)
    out['layer_bytes'] = (_gathered_layer_bytes(tr, cfg) if mesh is not None
                          else 0)
    if gather:
        whole = _whole(tr, mesh, rules)
        if out['rank'] == 0:
            out['params'] = whole
    tr.close()
    del tr
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    return out


def _pipelined_loss(cfg, mesh, microbatches, sequence_axis=None):
    """llama.loss_fn through forward_pipelined (the reference's
    forward_fn hook) on this rank's blocks."""
    from skypilot_tpu_torch.models import llama

    def forward(p, tokens, c):
        return llama.forward_pipelined(p, tokens, c, mesh=mesh,
                                       num_microbatches=microbatches,
                                       sequence_axis=sequence_axis)
    return lambda p, b: llama.loss_fn(p, b, cfg, mesh=mesh,
                                      forward_fn=forward)


def rank_long_context(config, seq, device='cuda'):
    """17d on one rank: train_long_context.make_trainer (the entry
    point's Trainer) at sp 4, one step of its synthetic batches."""
    import argparse
    from skypilot_tpu_torch.parallel import mesh as mesh_lib
    from skypilot_tpu_torch.train import train_long_context, trainer
    cfg = _mesh_train_config(config)
    mesh = mesh_lib.make_mesh(mesh_lib.MeshConfig(sp=4))
    if device == 'cuda':
        torch.cuda.reset_peak_memory_stats()
    tr = train_long_context.make_trainer(
        cfg, argparse.Namespace(steps=10), device, mesh)
    kernels = _kernel_counters()
    _zero(kernels)
    t0 = time.perf_counter()
    m = tr.run_step(next(trainer.synthetic_batches(1, seq, cfg.vocab_size)))
    out = {'rank': mesh.rank, 'losses': [float(m['loss'])],
           'norms': [float(m['grad_norm'])],
           'step_s': [time.perf_counter() - t0], 'counts': _counts(kernels),
           'peak': torch.cuda.max_memory_allocated() if device == 'cuda'
           else 0, 'state_bytes': _state_bytes(tr),
           'layer_bytes': _gathered_layer_bytes(tr, cfg)}
    tr.close()
    del tr
    gc.collect()
    if device == 'cuda':
        torch.cuda.empty_cache()
    return out


def rank_moe(config, mesh_kw, batch, seq, steps, device='cuda'):
    """17e on one rank (or one card, mesh_kw None): train_moe's Trainer,
    `steps` steps of its synthetic batches."""
    from skypilot_tpu_torch.parallel import mesh as mesh_lib
    from skypilot_tpu_torch.train import train_moe, trainer
    cfg = _mesh_train_config(config)
    mesh = (mesh_lib.make_mesh(mesh_lib.MeshConfig(**mesh_kw))
            if mesh_kw else None)
    if device == 'cuda':
        torch.cuda.reset_peak_memory_stats()
    tr = train_moe.make_trainer(cfg, steps, device, mesh=mesh)
    kernels = _kernel_counters()
    batches = trainer.synthetic_batches(batch, seq, cfg.vocab_size)
    _zero(kernels)
    out = {'rank': 0 if mesh is None else mesh.rank, 'losses': [],
           'norms': [], 'step_s': []}
    for _ in range(steps):
        t0 = time.perf_counter()
        m = tr.run_step(next(batches))
        out['losses'].append(float(m['loss']))
        out['norms'].append(float(m['grad_norm']))
        out['step_s'].append(time.perf_counter() - t0)
    out['counts'] = _counts(kernels)
    out['peak'] = torch.cuda.max_memory_allocated() if device == 'cuda' \
        else 0
    tr.close()
    del tr
    gc.collect()
    if device == 'cuda':
        torch.cuda.empty_cache()
    return out


def rank_ckpt(config, mesh_kw, batch, seq, tc_kw, root, device='cuda'):
    """17f on the ranks: the mesh trains 2 steps and saves; rank 0, as one
    card, restores that (bitwise the mesh's state), resumes a step and
    saves; the mesh restores that (bitwise rank 0's state) and resumes
    a step."""
    import torch.distributed as dist
    a, b = os.path.join(root, 'a'), os.path.join(root, 'b')
    saved = mesh_train(config, mesh_kw, batch, seq, 2, tc_kw, device,
                       gather=True, counters=False, save=a)
    one = None
    if dist.get_rank() == 0:
        one = mesh_train(config, None, batch, seq, 1, tc_kw, device,
                         gather=True, counters=False, seed=1, restore=a,
                         save=b)
        if one['restored'] != 2:
            raise AssertionError(f'17f: one card restored step '
                                 f'{one["restored"]} of the mesh\'s 2')
        _same_tree('17f mesh -> one card', one['restored_params'],
                   saved['params'])
    dist.barrier()
    back = mesh_train(config, mesh_kw, batch, seq, 1, tc_kw, device,
                      gather=True, counters=False, seed=2, restore=b)
    if one is not None:
        _same_tree('17f one card -> mesh', back['restored_params'],
                   one['params'])
    if back['restored'] != 3 or not np.isfinite(back['losses'][0]):
        raise AssertionError(f'17f: the mesh resumed at step '
                             f'{back["restored"]} with loss '
                             f'{back["losses"]}')
    return {'rank': back['rank'],
            'restored_steps': [one and one['restored'], back['restored']],
            'resumed_loss_one_card': one and one['losses'],
            'resumed_loss_mesh': back['losses']}


def _same_tree(label, got, want):
    for (key, g), (_, w) in zip(_tree_items(got), _tree_items(want)):
        if not np.array_equal(g, w):
            raise AssertionError(f'{label}: {key} not bitwise equal')


def rank_mesh_arms(arms, root, device='cuda'):
    """Every arm of phase 17 on this rank, in order (one spawn); each
    arm's result with its seconds."""
    import torch.distributed as dist
    out = {}
    for name, (task, kw) in arms.items():
        dist.barrier()
        t0 = time.perf_counter()
        if task == 'rank_ckpt':
            kw = dict(kw, root=root)
        out[name] = globals()[task](device=device, **kw)
        out[name]['seconds'] = time.perf_counter() - t0
    return out


def _tree_items(tree, prefix=''):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _tree_items(tree[k], f'{prefix}/{k}')
    else:
        yield prefix, tree


def _rel(a, b):
    return abs(a - b) / max(abs(b), 1e-30)


def _hold_steps(label, outs, one, loss_rel, norm_rel):
    """Every rank's step losses and grad norms bitwise the same, and
    within the tolerances of one card's.  Returns the worst relative
    differences."""
    for o in outs[1:]:
        if (o['losses'], o['norms']) != (outs[0]['losses'],
                                         outs[0]['norms']):
            raise AssertionError(f'{label}: ranks report different losses '
                                 f'or grad norms')
    worst = {'loss': 0.0, 'grad_norm': 0.0}
    for key, tol in (('losses', loss_rel), ('norms', norm_rel)):
        for i, (g, w) in enumerate(zip(outs[0][key], one[key])):
            rel = _rel(g, w)
            worst['loss' if key == 'losses' else 'grad_norm'] = max(
                worst['loss' if key == 'losses' else 'grad_norm'], rel)
            if not np.isfinite(g) or rel > tol:
                raise AssertionError(f'{label} step {i + 1}: {key} {g} vs '
                                     f'one card {w} (rel > {tol})')
    return worst


def _hold_memory(label, outs, one, gate=True):
    """Each rank's peak against its quarter (its share) of the state and
    one gathered layer; with `gate`, fails past that share, the layer's
    gradient and one card's activations (a rank sees fewer rows than one
    card)."""
    activations = max(0, one['peak'] - one['state_bytes'])
    rows = []
    for o in outs:
        share = o['state_bytes'] + 2 * o['layer_bytes']
        rows.append({'rank': o['rank'], 'peak_gb': o['peak'] / 1e9,
                     'state_share_gb': o['state_bytes'] / 1e9,
                     'gathered_layer_gb': o['layer_bytes'] / 1e9,
                     'peak_over_share_plus_layer': o['peak'] / max(
                         1, o['state_bytes'] + o['layer_bytes'])})
        if gate and o['peak'] > share + activations:
            raise AssertionError(f'{label} rank {o["rank"]}: peak '
                                 f'{o["peak"]} bytes > its state share, a '
                                 f'gathered layer and its gradient and one '
                                 f"card's activations ({share} + "
                                 f'{activations})')
    return {'one_card_peak_gb': one['peak'] / 1e9,
            'one_card_state_gb': one['state_bytes'] / 1e9, 'ranks': rows}


def _hold_kernels(label, outs, names, device='cuda'):
    """Each kernel of `names` launched on every rank (on the card: the
    host runs the plain versions); returns the counts summed over the
    ranks."""
    for o in outs if device == 'cuda' else ():
        for name in names:
            if o['counts'][name] <= 0:
                raise AssertionError(f'{name} never launched on rank '
                                     f'{o["rank"]} of {label}')
    return _sum_counts(outs)


_TRAIN_KERNELS = ('flash_attention', 'flash_attention[lse]', 'rms_norm',
                  'flash_attention_dq', 'flash_attention_dkv')


def _one_card(name, task, kw, device):
    """An arm's reference on one card (this process)."""
    if task == 'mesh_train':
        return mesh_train(**dict(kw, mesh_kw=None), device=device)
    if task == 'rank_moe':
        return rank_moe(**dict(kw, mesh_kw=None), device=device)
    # 17d: one card at the same depth and length runs K2/K5/K6.
    return mesh_train(kw['config'], None, 1, kw['seq'], 1,
                      dict(warmup_steps=2, total_steps=10), device)


def mesh_training_path(paths, root, device='cuda', tiny=False):
    """Phase 17: every arm of MESH_ARMS in one spawn of 4 ranks sharing
    the card over gloo, against its one-card reference run first in this
    process; then allreduce_bench (17g).  Returns the stats by arm."""
    arms = {name: (task, dict(kw, **(MESH_ARMS_TINY[name] if tiny else {})))
            for name, (task, kw) in MESH_ARMS.items()}
    refs, runs = {}, {}
    for name, (task, kw) in arms.items():
        if name == '17f':
            continue
        # Arms that differ only in their mesh share one reference.
        key = repr((task, sorted((k, v) for k, v in kw.items()
                                 if k != 'mesh_kw')))
        if key not in runs:
            t0 = time.perf_counter()
            runs[key] = _one_card(name, task, kw, device)
            runs[key]['seconds'] = time.perf_counter() - t0
        refs[name] = runs[key]
    t0 = time.perf_counter()
    outs = pooled_ranks(4, 'rank_mesh_arms', timeout=900, arms=arms, root=root,
                     device=device)
    spawn_s = time.perf_counter() - t0
    by_arm = {name: [o[name] for o in outs] for name in arms}
    card = CARD.get('line')
    note = '4 gloo ranks on one card: not a multi-card rate'
    stats = {'card': card, 'spawn_s': spawn_s, 'note': note}
    for name, ranks in by_arm.items():
        if name == '17f':
            continue
        one = refs[name]
        f32 = name.startswith('17b')
        loss_rel = (MESH_F32_REL if f32 else MESH_MOE_LOSS_REL
                    if name.startswith('17e') else MESH_LOSS_REL)
        worst = _hold_steps(name, ranks, one, loss_rel,
                            MESH_F32_REL if f32 else MESH_NORM_REL)
        names = ('rms_norm',) if name == '17d' else (
            tuple(n for n in _TRAIN_KERNELS if n != 'flash_attention[lse]')
            if f32 else _TRAIN_KERNELS)
        counts = _hold_kernels(name, ranks, names, device)
        if not f32:
            paths[name] = counts
        arm = {'mesh_s': ranks[0]['seconds'], 'one_card_s': one['seconds'],
               'losses': ranks[0]['losses'], 'one_card_losses':
               one['losses'], 'norms': ranks[0]['norms'],
               'one_card_norms': one['norms'], 'worst_rel': worst,
               'step_s': ranks[0]['step_s'], 'one_card_step_s':
               one['step_s']}
        if f32:
            arm['param_max_abs_diff'] = _hold_params(name, ranks[0], one,
                                                     arms[name][1])
        elif name.startswith('17e'):
            arm['peak_gb'] = [o['peak'] / 1e9 for o in ranks]
        else:
            arm['memory'] = _hold_memory(name, ranks, one,
                                         gate=name == '17a')
        stats[name] = arm
        log(f'  {name}: ' + json.dumps(dict(arm, card=card)))
    if device == 'cuda':
        _need('17d one card', refs['17d']['counts'], list(_TRAIN_KERNELS))
    stats['17f'] = dict(by_arm['17f'][0], mesh_s=by_arm['17f'][0]['seconds'],
                        bitwise=True)
    log('  17f: ' + json.dumps(dict(stats['17f'], card=card)))
    t0 = time.perf_counter()
    stats['17g'] = mesh_allreduce_path(('--device', 'cpu') if device == 'cpu'
                                       else ())
    stats['17g_s'] = time.perf_counter() - t0
    log('  17 seconds: ' + json.dumps(
        {'references': {n: r['seconds'] for n, r in refs.items()},
         'spawn': spawn_s, 'arms': {n: r[0]['seconds']
                                    for n, r in by_arm.items()},
         '17g': stats['17g_s']}))
    return stats


def _hold_params(label, got, one, kw):
    """17b: the parameters after the steps within the f32 tolerance of
    test_torch_train: 2 x the summed learning rates elementwise, 99% of
    elements within 1e-6 (Adam divides by sqrt(nu), so a near-zero
    gradient's rounding moves its element by up to the learning rate).
    Returns the largest difference."""
    from skypilot_tpu_torch.train import trainer
    schedule = trainer.make_optimizer(
        trainer.TrainConfig(**kw['tc_kw'])).schedule
    lrs = sum(schedule(i) for i in range(kw['steps']))
    worst = 0.0
    for (key, g), (_, w) in zip(_tree_items(got['params']),
                                _tree_items(one['params'])):
        err = np.abs(g - w)
        within = float((err <= 1e-6).mean())
        worst = max(worst, float(err.max()))
        if err.max() > 2 * lrs or within < 0.99:
            raise AssertionError(f'{label} {key}: max |diff| {err.max()} '
                                 f'(> {2 * lrs}) or {within:.4f} within '
                                 f'1e-6')
    return worst


def mesh_allreduce_path(device_args=()):
    """17g: allreduce_bench over 4 ranks with --sharded-decode, as a
    child process: its JSON line (a schedule check, not a rate)."""
    proc = subprocess.run(
        [sys.executable, '-m', 'skypilot_tpu_torch.train.allreduce_bench',
         '--ranks', '4', '--payload-mb', '64', '--iters', '5',
         '--sharded-decode', *device_args], capture_output=True, text=True,
        timeout=600)
    if proc.returncode:
        raise AssertionError(f'17g allreduce_bench exited '
                             f'{proc.returncode}:\n{proc.stderr[-4000:]}')
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    for key in ('payload_mb', 'ranks', 'time_s', 'algbw_gbps', 'busbw_gbps'):
        if key not in result['allreduce']:
            raise AssertionError(f'17g: no {key!r} in {result}')
    if result['sharded_decode']['overlap']['parity'] != 'bit-exact':
        raise AssertionError(f'17g: {result}')
    log('  17g: ' + json.dumps(dict(result, card=CARD.get('line'))))
    return result


# ---- phase 18: pipelines, post-training meshes, legacy planes under tp ----

# Phase 18's arms in ONE spawn of 4 ranks on cuda:0 over gloo, as phase
# 17's: name -> (rank task, kwargs).  18a LLAMA_1B bf16 at 4 of its 16
# layers (cut for time) at pp 2 x dp 2, phase 8a's global batch of 8 x
# 1024 in 4 microbatches (1 warm-up and 3 timed steps); 18b 17b's f32
# config at pp 4 and pp 2 x fsdp 2; 18c pp 2 x sp 2 at 2 x 4096 on
# LLAMA_1B's widths at 4 layers (depth cut for
# time: the sp ring attends in f32 products); 18d LoRA-SFT (2 x 2048 a
# step, 2 steps) and LoRA-DPO (2 pairs x 1024, 1 step) of LLAMA3_8B's
# widths at 2 layers (depth and steps cut for time; 17c's trunk) at fsdp
# 2 x tp 2, the SFT adapters merged on the mesh by train_sft's
# --merge-save function, and GRPO on LLAMA_1B at dp 2 x fsdp 2 with 10c's
# settings (1 step, cut for time); 18e train_moe's
# 'small' model with the 'capacity' router at sp 2 x ep 2, 17e's shapes.
_TC_PP = dict(warmup_steps=2, total_steps=12)
PP_ARMS = {
    '18a': ('mesh_train', dict(config='1b-4', mesh_kw={'pp': 2, 'dp': 2},
                               batch=8, seq=1024, steps=4, tc_kw=_TC_PP,
                               microbatches=4)),
    '18b-pp4': ('mesh_train', dict(
        config='f32', mesh_kw={'pp': 4}, batch=4, seq=256, steps=3,
        tc_kw=_TC_F32, gather=True, microbatches=4)),
    '18b-pp2-fsdp2': ('mesh_train', dict(
        config='f32', mesh_kw={'pp': 2, 'fsdp': 2}, batch=4, seq=256,
        steps=3, tc_kw=_TC_F32, gather=True, microbatches=2)),
    '18c': ('mesh_train', dict(config='1b-4', mesh_kw={'pp': 2, 'sp': 2},
                               batch=2, seq=4096, steps=2, tc_kw=_TC_PP,
                               microbatches=2, sequence_axis='sp')),
    '18d-sft': ('rank_lora', dict(kind='sft', config='8b-2',
                                  mesh_kw={'fsdp': 2, 'tp': 2}, seq=2048,
                                  steps=2, merge=True)),
    # 2 steps: the first step's loss is log 2 whatever the mesh does (B
    # is 0, so the policy is the reference); after an update at the
    # peak rate (rank_lora: no warmup) the second step's logprob sums
    # are gated (_hold_dpo).
    '18d-dpo': ('rank_lora', dict(kind='dpo', config='8b-2',
                                  mesh_kw={'fsdp': 2, 'tp': 2}, seq=1024,
                                  steps=2)),
    '18d-grpo': ('rank_grpo', dict(config='1b-grpo',
                                   mesh_kw={'dp': 2, 'fsdp': 2}, steps=1)),
    '18e': ('rank_moe', dict(config='moe-small', mesh_kw={'sp': 2, 'ep': 2},
                             batch=4, seq=2048, steps=2)),
}
# The host rehearsal's sizes (device='cpu').
PP_ARMS_TINY = {
    '18a': dict(config='tiny-4', seq=256), '18b-pp4': dict(
        config='tiny-f32-4', seq=64), '18b-pp2-fsdp2': dict(
        config='tiny-f32-4', seq=64), '18c': dict(config='tiny-4', seq=256),
    # LoRA's masked losses average a few hundred completion tokens: f32
    # here, where bf16 at tiny widths rounds past the card's gate.
    '18d-sft': dict(config='tiny-f32-4', seq=768), '18d-dpo': dict(
        config='tiny-f32-4', seq=512), '18d-grpo': dict(config='tiny-grpo'),
    '18e': dict(config='tiny-moe', seq=256)}
# 18d's LoRA: rank 16, alpha 32 on the attention projections (10a's).
_LORA_18D = dict(rank=16, alpha=32.0, targets='attn')


def _grpo_config(name):
    from skypilot_tpu_torch.models import llama
    if name == '1b-grpo':
        return llama.LLAMA_1B
    return dataclasses.replace(_mesh_train_config('tiny'), max_seq_len=512)


def rank_lora(kind, config, mesh_kw, seq, steps, data, root, merge=False,
              device='cuda'):
    """18d on one rank (mesh_kw None: one card): LoRA-SFT (kind 'sft') or
    LoRA-DPO ('dpo') of `config` from seed 0, adapters from seed 1, 2
    rows of `seq` tokens a step from the phase's JSONL file; with
    `merge`, on the mesh the adapters are then merged with the base by
    train_sft's --merge-save function (the whole tree, written by rank
    0), which rank 0 restores and holds bitwise against one card's merge
    of the same adapters over the whole base drawn again from seed 0."""
    import torch.distributed as dist
    from skypilot_tpu_torch.ckpt import format as ckpt_format
    from skypilot_tpu_torch.models import llama
    from skypilot_tpu_torch.parallel import mesh as mesh_lib
    from skypilot_tpu_torch.parallel import sharding
    from skypilot_tpu_torch.train import dpo, lora, sft, train_sft, trainer
    cfg = _mesh_train_config(config)
    mesh = (mesh_lib.make_mesh(mesh_lib.MeshConfig(**mesh_kw))
            if mesh_kw else None)
    rules = sharding.LLAMA_RULES
    cuda = device == 'cuda'
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    shard = None if mesh is None else sharding.init_shard(mesh, rules)
    base = llama.init_params(cfg, torch.Generator(device=device)
                             .manual_seed(0), device, shard=shard)
    lcfg = lora.LoraConfig(**_LORA_18D)
    adapters = lora.init_lora(base, lcfg, torch.Generator(device=device)
                              .manual_seed(1), mesh, rules)
    if kind == 'sft':
        loss = lora.wrap_loss(
            lambda p, b: sft.sft_loss_fn(p, b, cfg, mesh=mesh, rules=rules),
            base, lcfg, mesh, rules)
        batches = sft.sft_batches(data, _encode(cfg.vocab_size), 2, seq)
    else:
        def loss(ad, b):
            return dpo.dpo_loss_fn(lora.apply_lora(base, ad, lcfg, mesh,
                                                   rules), base, b, cfg,
                                   mesh=mesh, rules=rules)
        batches = dpo.dpo_batches(data, _encode(cfg.vocab_size), 2, seq)
    kw = {} if mesh is None else {'mesh': mesh, 'rules': lora.LORA_RULES}
    # No warmup: the first update moves the adapters at the peak rate,
    # so every loss after the first is an updated policy's.
    tr = trainer.Trainer(loss, adapters, trainer.TrainConfig(
        learning_rate=1e-4, warmup_steps=0, total_steps=steps,
        weight_decay=0.0 if kind == 'dpo' else 0.1), device=device, **kw)
    counters = _kernel_counters()
    out = {'rank': 0 if mesh is None else mesh.rank, 'losses': [],
           'norms': [], 'step_s': []}
    _zero(counters)
    for i in range(steps):
        batch = next(batches)
        if kind == 'dpo' and i == steps - 1:
            out['logprob_means'] = _dpo_logprob_means(
                tr.params, base, batch, cfg, lcfg, mesh, rules, device)
        t0 = time.perf_counter()
        m = tr.run_step(batch)
        out['losses'].append(float(m['loss']))
        out['norms'].append(float(m['grad_norm']))
        out['step_s'].append(time.perf_counter() - t0)
    out['counts'] = _counts(counters)
    out['peak'] = torch.cuda.max_memory_allocated() if cuda else 0
    if mesh is not None and merge:
        t0 = time.perf_counter()
        merged_dir = os.path.join(root, f'merged-{kind}')
        train_sft.merge_and_save(merged_dir, base, lcfg, tr.params, mesh,
                                 rules)
        out['merge_save_s'] = time.perf_counter() - t0
        if mesh.rank == 0:
            whole = llama.init_params(cfg, torch.Generator(device=device)
                                      .manual_seed(0), device)
            one = lora.merge_lora(whole, tr.params, lcfg)
            del whole
            saved = ckpt_format.restore_pytree(
                os.path.join(merged_dir, 'merged'), 0, {'params': one})
            named, _ = ckpt_format.flatten_with_keys(saved['params'])
            want, _ = ckpt_format.flatten_with_keys(one)
            for (key, g), (_, w) in zip(named, want):
                if not torch.equal(torch.as_tensor(g).cpu(), w.cpu()):
                    raise AssertionError(f'18d {kind}: the mesh\'s '
                                         f'--merge-save {key} is not one '
                                         f'card\'s merge bitwise')
            out['merge_bitwise'] = True
            del one, saved
        dist.barrier()
    tr.close()
    del tr, base
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    return out


@torch.no_grad()
def _dpo_logprob_means(adapters, base, batch, cfg, lcfg, mesh, rules,
                       device):
    """The mean over the batch's pairs of the policy's (base + adapters)
    and of the reference's (base) summed completion logprobs, chosen
    plus rejected: the sums whose differences the DPO loss takes, on
    this rank's rows as the Trainer cuts them."""
    from skypilot_tpu_torch.parallel import sharding
    from skypilot_tpu_torch.train import dpo, lora
    if mesh is not None:
        batch = {k: sharding.shard_tensor(torch.as_tensor(v),
                                          sharding.BATCH_SPEC, mesh)
                 for k, v in batch.items()}
    batch = {k: torch.as_tensor(v).to(device) for k, v in batch.items()}
    policy = lora.apply_lora(base, adapters, lcfg, mesh, rules)
    pi_c, pi_r, ref_c, ref_r = dpo._four_logprobs(policy, base, batch, cfg,
                                                  mesh, rules)
    return {'policy': float(dpo._pair_mean(pi_c + pi_r, mesh)),
            'reference': float(dpo._pair_mean(ref_c + ref_r, mesh))}


def _hold_dpo(ranks, one):
    """18d-dpo: every rank the same bits; the first step (B = 0: the
    policy is the reference, the loss log 2) gated as _hold_steps gates
    it; then, after the update, the policy's and the reference's summed
    completion logprobs (_dpo_logprob_means) within MESH_LOSS_REL of
    one card's, as the SFT loss (their mean) is held.  The second loss
    is reported, not gated: it is the log-sigmoid of beta x a
    difference of differences of such sums, each ~1,000 tokens, whose
    rounding at the sums' MESH_LOSS_REL is ~0.3 there (PERF.md)."""
    for o in ranks[1:]:
        if o['logprob_means'] != ranks[0]['logprob_means']:
            raise AssertionError('18d-dpo: ranks report different sums')
    first = [dict(o, losses=o['losses'][:1], norms=o['norms'][:1])
             for o in ranks]
    worst = _hold_steps('18d-dpo', first, dict(
        one, losses=one['losses'][:1], norms=one['norms'][:1]),
        MESH_LOSS_REL, MESH_NORM_REL)
    sums = {}
    for key in ('policy', 'reference'):
        got, want = ranks[0]['logprob_means'][key], one['logprob_means'][key]
        sums[key] = {'mesh': got, 'one_card': want, 'rel': _rel(got, want)}
        if not np.isfinite(got) or sums[key]['rel'] > MESH_LOSS_REL:
            raise AssertionError(f'18d-dpo: the {key}\'s summed logprobs '
                                 f'{got} vs one card {want} (rel > '
                                 f'{MESH_LOSS_REL})')
    worst['logprob_sums'] = max(v['rel'] for v in sums.values())
    worst['last_loss_abs_diff'] = abs(ranks[0]['losses'][-1]
                                      - one['losses'][-1])
    return worst, sums


def rank_grpo(config, mesh_kw, steps, device='cuda'):
    """18d's GRPO on one rank (mesh_kw None: one card), 10c's settings:
    group 8, 2 prompts, 32 new tokens from prompts of up to 64, temperature
    1, kl_coef 0.05, lr 1e-4.  The rollouts run on the policy gathered
    whole on every rank (rl.GrpoTrainer on a mesh).  Returns each step's
    loss and seconds, the first step's rollouts, the counts, the peak and
    the rollout tree's bytes."""
    from skypilot_tpu_torch.models import llama
    from skypilot_tpu_torch.parallel import mesh as mesh_lib
    from skypilot_tpu_torch.parallel import sharding
    from skypilot_tpu_torch.train import rl
    from skypilot_tpu_torch.train.train_rl import make_rewards
    cfg = _grpo_config(config)
    mesh = (mesh_lib.make_mesh(mesh_lib.MeshConfig(**mesh_kw))
            if mesh_kw else None)
    cuda = device == 'cuda'
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    params = llama.init_params(cfg, torch.Generator(device=device)
                               .manual_seed(0), device)
    seen = []
    band = make_rewards(cfg.vocab_size)['token-band']

    def reward(prompt, completion):
        seen.append(list(map(int, completion)))
        return band(prompt, completion)
    tr = rl.GrpoTrainer(
        params, cfg, reward, group_size=8, max_new_tokens=32,
        max_prompt_len=64, temperature=1.0, learning_rate=1e-4,
        kl_coef=0.05, total_steps=steps, device=device, mesh=mesh,
        rules=None if mesh is None else sharding.LLAMA_RULES)
    del params
    prompts = [[(11 * (i + 1)) % cfg.vocab_size,
                (13 * (i + 1)) % cfg.vocab_size] for i in range(2)]
    counters = _kernel_counters()
    _zero(counters)
    history = [tr.step(prompts) for _ in range(steps)]
    out = {'rank': 0 if mesh is None else mesh.rank,
           'losses': [m['loss'] for m in history],
           'reward_mean': [m['reward_mean'] for m in history],
           'rollout_s': [m['rollout_s'] for m in history],
           'update_s': [m['update_s'] for m in history],
           'first_rollouts': seen[:16], 'counts': _counts(counters),
           'peak': torch.cuda.max_memory_allocated() if cuda else 0,
           'rollout_bytes': tr.rollout_bytes}
    tr.close()
    del tr
    if mesh is None:
        out['loss_term_scale'] = _grpo_term_scale(cfg, prompts, seen[:16],
                                                  band, device)
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    return out


def _grpo_term_scale(cfg, prompts, completions, reward, device):
    """The size of the first GRPO loss's terms on one card: the masked
    mean of |advantage x log p| over the first step's completions under
    the initial policy (seed 0).  That loss is their signed mean, which
    the group-standardized advantages cancel nearly to zero, so a mesh's
    rounding is measured against this scale, not against the loss."""
    from skypilot_tpu_torch.models import llama
    from skypilot_tpu_torch.train import rl, sft
    group = len(completions) // len(prompts)
    rows = [p for p in prompts for _ in range(group)]
    adv = rl.group_advantages(np.asarray(
        [reward(p, c) for p, c in zip(rows, completions)]), group)
    pad_to = max(len(p) + len(c) for p, c in zip(rows, completions))
    batch = rl.build_batch(rows, completions, adv, pad_to)
    params = llama.init_params(cfg, torch.Generator(device=device)
                               .manual_seed(0), device)
    with torch.no_grad():
        lp = sft.token_logprobs(params, torch.as_tensor(
            batch['tokens'], device=device).long(), cfg)
    mask = torch.as_tensor(batch['completion_mask'], device=device)
    terms = (torch.as_tensor(batch['advantage'], device=device)[:, None]
             * lp).abs() * mask
    return float(terms.sum() / mask.sum())


def rank_pp_arms(arms, root, data, device='cuda'):
    """Every arm of PP_ARMS on this rank, in order (one spawn); each
    arm's result with its seconds."""
    import torch.distributed as dist
    out = {}
    for name, (task, kw) in arms.items():
        dist.barrier()
        t0 = time.perf_counter()
        if task == 'rank_lora':
            kw = dict(kw, root=root, data=data[kw['kind']])
        out[name] = globals()[task](device=device, **kw)
        out[name]['seconds'] = time.perf_counter() - t0
    return out


def _one_card_pp(name, task, kw, root, data, device):
    """An arm's reference on one card (this process): the same steps
    without a mesh (the sequential layer stack, one card's attention)."""
    kw = dict(kw, mesh_kw=None)
    if task == 'mesh_train':
        kw.pop('microbatches', None)
        kw.pop('sequence_axis', None)
        return mesh_train(**kw, device=device)
    if task == 'rank_lora':
        return rank_lora(**dict(kw, root=root, data=data[kw['kind']]),
                         device=device)
    return globals()[task](**kw, device=device)


def pp_training_path(paths, root, device='cuda', tiny=False):
    """Phase 18a-e: every arm of PP_ARMS in one spawn of 4 ranks sharing
    the card over gloo, against its one-card reference run first in this
    process.  Returns the stats by arm."""
    arms = {name: (task, dict(kw, **(PP_ARMS_TINY[name] if tiny else {})))
            for name, (task, kw) in PP_ARMS.items()}
    sft_data, dpo_data, _, _ = _post_train_data(root)
    data = {'sft': sft_data, 'dpo': dpo_data}
    refs, runs = {}, {}
    for name, (task, kw) in arms.items():
        key = repr((task, sorted((k, v) for k, v in kw.items()
                                 if k not in ('mesh_kw', 'microbatches'))))
        if key not in runs:
            t0 = time.perf_counter()
            runs[key] = _one_card_pp(name, task, kw, root, data, device)
            runs[key]['seconds'] = time.perf_counter() - t0
        refs[name] = runs[key]
    t0 = time.perf_counter()
    outs = pooled_ranks(4, 'rank_pp_arms', timeout=900, arms=arms, root=root,
                     data=data, device=device)
    spawn_s = time.perf_counter() - t0
    by_arm = {name: [o[name] for o in outs] for name in arms}
    card = CARD.get('line')
    stats = {'card': card, 'spawn_s': spawn_s,
             'note': '4 gloo ranks on one card: not a multi-card rate'}
    for name, ranks in by_arm.items():
        one = refs[name]
        f32 = name.startswith('18b')
        if name == '18d-grpo':
            stats[name] = _hold_grpo(ranks, one)
            paths[name] = _hold_kernels(
                name, ranks, ('decode_attention_pooled', 'rms_norm')
                + _TRAIN_KERNELS, device)
            continue
        loss_rel = (1e-6 if f32 else MESH_MOE_LOSS_REL if name == '18e'
                    else MESH_LOSS_REL)
        sums = None
        if name == '18d-dpo':
            worst, sums = _hold_dpo(ranks, one)
        else:
            worst = _hold_steps(name, ranks, one, loss_rel,
                                MESH_F32_REL if f32 else MESH_NORM_REL)
        # 18c's and 18e's stages attend over the sp ring (plain f32
        # products): K3 alone.
        names = (('rms_norm',) if name in ('18c', '18e') else
                 tuple(n for n in _TRAIN_KERNELS
                       if n != 'flash_attention[lse]') if f32
                 else _TRAIN_KERNELS)
        counts = _hold_kernels(name, ranks, names, device)
        if not f32:
            paths[name] = counts
        arm = {'mesh_s': ranks[0]['seconds'], 'one_card_s': one['seconds'],
               'losses': ranks[0]['losses'], 'one_card_losses':
               one['losses'], 'norms': ranks[0]['norms'],
               'one_card_norms': one['norms'], 'worst_rel': worst,
               'step_s': ranks[0]['step_s'],
               'one_card_step_s': one['step_s'],
               'peak_gb': [o['peak'] / 1e9 for o in ranks],
               'one_card_peak_gb': one['peak'] / 1e9}
        if f32:
            arm['param_max_abs_diff'] = _hold_params(name, ranks[0], one,
                                                     arms[name][1])
        if sums:
            arm['logprob_means_last_step'] = sums
        if arms[name][1].get('merge'):
            if not ranks[0].get('merge_bitwise'):
                raise AssertionError(f'{name}: the merge was not checked')
            arm['merge_bitwise'] = True
            arm['merge_save_s'] = ranks[0]['merge_save_s']
        stats[name] = arm
        log(f'  {name}: ' + json.dumps(dict(arm, card=card)))
    log('  18 seconds: ' + json.dumps(
        {'references': {n: r['seconds'] for n, r in refs.items()},
         'spawn': spawn_s, 'arms': {n: r[0]['seconds']
                                    for n, r in by_arm.items()}}))
    return stats


def _hold_grpo(ranks, one):
    """18d's GRPO: every rank the same losses, and their first step's
    rollouts the one card's for the same seed (the policy gathered whole
    is bitwise one card's before the first update); so the first step's
    loss (before any update, over the padded batch, the KL reference
    sharded) is one card's within MESH_LOSS_REL of its terms' size
    (_grpo_term_scale)."""
    for o in ranks:
        if o['losses'] != ranks[0]['losses']:
            raise AssertionError('18d-grpo: ranks report different losses')
        if o['first_rollouts'] != one['first_rollouts']:
            raise AssertionError('18d-grpo: a rank\'s first rollouts are '
                                 'not one card\'s')
    diff = abs(ranks[0]['losses'][0] - one['losses'][0])
    scale = one['loss_term_scale']
    if not np.isfinite(ranks[0]['losses']).all() or not (
            diff <= MESH_LOSS_REL * scale):
        raise AssertionError(f'18d-grpo: first loss {ranks[0]["losses"][0]}'
                             f' vs one card {one["losses"][0]}: |diff| '
                             f'{diff} > {MESH_LOSS_REL} x {scale}')
    stats = {'rollouts': 'the policy gathered whole on every rank',
             'rollout_tree_gb': ranks[0]['rollout_bytes'] / 1e9,
             'losses': ranks[0]['losses'], 'one_card_losses': one['losses'],
             'loss_abs_diff': [abs(a - b) for a, b in
                               zip(ranks[0]['losses'], one['losses'])],
             'loss_term_scale': scale,
             'first_loss_diff_over_scale': diff / scale,
             'reward_mean': ranks[0]['reward_mean'],
             'rollout_s': ranks[0]['rollout_s'],
             'update_s': ranks[0]['update_s'],
             'peak_gb': [o['peak'] / 1e9 for o in ranks],
             'one_card_peak_gb': one['peak'] / 1e9,
             'first_rollouts_identical': True, 'card': CARD.get('line')}
    log('  18d-grpo: ' + json.dumps(stats))
    return stats


# 18f: the legacy planes at tp 2, phase 7's requests (decode_chunk 16)
# with the prompts capped as in 16b.
LEGACY_NEW_TOKENS = 16
for _plane in ('paged', 'inplace'):
    for _kv in (None, 'int8'):
        TP_ARMS[_plane + ('-int8' if _kv else '')] = dict(
            max_seq_len=2048, batch_size=8, prefill_chunk=256,
            decode_impl=_plane, decode_chunk=16, kv_cache_dtype=_kv)
del _plane, _kv


def legacy_tp_path(paths, device='cuda', tiny=False):
    """18f: LLAMA3_8B's widths at 4 of its 32 layers (cut for time) at
    tp 2 on the 'paged' (K7 per shard) and 'inplace' planes, bf16 and
    int8 KV, served through the batcher against tp 1 on the same seed
    (prefill logits within TP_LOGITS_REL, ranks agreeing), and each
    plane's decode steps themselves held to tp 1's with the same tokens
    fed (tp_forced_decode: every step's logits within TP_LOGITS_REL);
    then 16b's f32 config at tp 2 on both planes, whose greedy tokens
    must equal tp 1's.  tiny: the host rehearsal's configs
    (device='cpu')."""
    from skypilot_tpu_torch.models import llama
    lengths = TP_PROMPT_LENGTHS
    planes = [(plane, kv) for plane in ('paged', 'inplace')
              for kv in (None, 'int8')]
    arms = [plane + ('-int8' if kv else '') for plane, kv in planes]
    bf16, f32 = (('tiny-hd128', 'tiny-hd128-f32') if tiny
                 else ('8b-4', 'f32-narrow'))
    with warnings.catch_warnings():
        warnings.simplefilter('ignore', DeprecationWarning)
        outs = pooled_ranks(2, 'rank_serve', timeout=600, config=bf16, tp=2,
                            seed=0, arms=[(a, LEGACY_NEW_TOKENS)
                                          for a in arms],
                            prompt_lengths=lengths, forced=planes,
                            device=device)
        _ranks_agree(outs, '18f')
        for arm in arms:
            paths[f'18f-{arm}'] = _sum_counts([o['arms'][arm] for o in outs])
        cfg = _tp_config(bf16)
        params = llama.init_params(
            cfg, torch.Generator(device=device).manual_seed(0), device)
        stats = tp_compare(f'18f {bf16} tp 2 vs tp 1 (legacy planes)', outs,
                           params, cfg, lengths, device=device)
        stats['first_logits_are'] = ('the prefill (llama_infer.prefill), '
                                     'shared by every arm')
        prompts = [p[:n] for p, n in zip(_serve_prompts(cfg.vocab_size),
                                         lengths)]
        forced = {}
        for (plane, kv), arm in zip(planes, arms):
            got = torch.from_numpy(outs[0]['forced'][(plane, kv)])
            one = tp_forced_decode(params, cfg, prompts, plane, kv,
                                   device=device)
            diffs = (got - one).abs().amax(dim=(1, 2))
            scales = one.abs().amax(dim=(1, 2))
            forced[arm] = {'steps': FORCED_STEPS,
                           'max_abs_diff': diffs.tolist(),
                           'max_abs_logit': scales.tolist(),
                           'worst_share': (diffs / scales).max().item()}
            if (diffs > TP_LOGITS_REL * scales).any():
                raise AssertionError(
                    f'18f {arm}: forced decode logits differ from tp 1 by '
                    f'{diffs.tolist()} (> {TP_LOGITS_REL} of '
                    f'{scales.tolist()})')
        stats['forced_decode'] = forced
        log('  18f forced decode steps, tp 2 vs tp 1: ' + json.dumps(
            {'card': CARD.get('line'), **forced}))
        del params
        gc.collect()
        outs = pooled_ranks(2, 'rank_serve', timeout=300, config=f32, tp=2,
                            seed=1, arms=[('paged', 32), ('inplace', 32)],
                            prompt_lengths=lengths, device=device)
        _ranks_agree(outs, '18f f32')
        cfg = _tp_config(f32)
        params = llama.init_params(
            cfg, torch.Generator(device=device).manual_seed(1), device)
        stats['f32'] = tp_compare(f'18f {f32} tp 2 vs tp 1 (paged, inplace)',
                                  outs, params, cfg, lengths, exact=True,
                                  device=device)
    if device == 'cuda':
        torch.cuda.empty_cache()
    return stats


# ---- phase 19: the serving fleet --------------------------------------------

# The arms' configurations are those of the port's CPU parity tests
# (tests/test_torch_fleet_sim.py, test_torch_doctor.py): name -> (arm,
# SimConfig kwargs, TrafficConfig kwargs, faults (kind, t, replica,
# duration), autoscaled).  The serve and chaos trace is the reference
# fixtures' 10 s one (the CPU tests cut it to 7 s).
FLEET_TRAFFIC = dict(seed=11, duration_s=10.0, base_rps=8.0, num_sessions=8,
                     num_heads=6, head_tokens=64, session_share=0.85)
FLEET_SIM = dict(num_replicas=3, batch_size=2, decode_chunk=4,
                 slo_ttft_s=1.5, prefill_cost_per_token_s=4e-3,
                 prefix_cache_mb=0.25)
FLEET_DISAGG_TRAFFIC = dict(seed=13, duration_s=5.0, base_rps=4.0,
                            session_share=0.5, num_sessions=4, num_heads=2,
                            head_tokens=40, tail_median=6,
                            singleton_median=96, singleton_sigma=0.2,
                            max_prompt_tokens=128, out_median=12,
                            out_sigma=0.3, max_out_tokens=20,
                            min_out_tokens=4)
FLEET_DISAGG_SIM = dict(policy='least_load', num_replicas=3, slo_ttft_s=1.0,
                        batch_size=4, decode_chunk=4, max_seq_len=256,
                        prefix_cache_mb=2.0, prefix_block=64,
                        prefill_chunk=16, host_tier_mb=4.0)
FLEET_ARMS = {
    'serve-ll': ('a', dict(FLEET_SIM, policy='least_load'), FLEET_TRAFFIC,
                 None, False),
    'serve-pa': ('a', dict(FLEET_SIM, policy='prefix_affinity'),
                 FLEET_TRAFFIC, None, False),
    'chaos-kp': ('b', dict(FLEET_SIM, policy='least_load'), FLEET_TRAFFIC,
                 (('kill', 3.5, 0, 0.0), ('preempt', 5.5, 1, 0.0)), False),
    'chaos-sp': ('b', dict(FLEET_SIM, policy='prefix_affinity'),
                 FLEET_TRAFFIC, (('stall', 2.0, 0, 5.0),
                                 ('partition', 3.0, 1, 4.0)), False),
    'disagg': ('c', dict(FLEET_DISAGG_SIM, prefill_replicas=1,
                         disagg_cold_prompt_tokens=65),
               FLEET_DISAGG_TRAFFIC, None, False),
    'single': ('c', FLEET_DISAGG_SIM, FLEET_DISAGG_TRAFFIC, None, False),
    'doctor': ('d', dict(policy='prefix_affinity', num_replicas=2,
                         slo_ttft_s=0.02, batch_size=4, decode_chunk=4,
                         prefix_cache_mb=0.25, host_tier_mb=8.0,
                         doctor_cadence_s=3.0,
                         doctor_thresholds={'spill_thrash_min_events': 3}),
               dict(seed=5, duration_s=12.0, base_rps=8.0, num_sessions=8,
                    num_heads=8, head_tokens=64,
                    tenants=('default', 'heavy')), None, False),
    'autoscale': ('d', dict(policy='least_load', num_replicas=1,
                            batch_size=2, decode_chunk=4,
                            prefill_cost_per_token_s=10e-3,
                            prefix_cache_mb=None),
                  dict(seed=2, duration_s=45.0, base_rps=1.5,
                       num_sessions=4, num_heads=2), None, True),
}
# The chaos runs' fault-free baselines and the disagg run's single pool.
FLEET_BASELINE = {'chaos-kp': 'serve-ll', 'chaos-sp': 'serve-pa',
                  'disagg': 'single'}
# Summary fields that count bytes: at `scale` times the KV bytes a token
# they grow by `scale`, less the images' headers, which do not scale.
FLEET_BYTE_FIELDS = ('tier.spill_bytes', 'tier.prefetch_bytes',
                     'disagg.export_bytes', 'disagg.ingest_bytes',
                     'acct.tenants.*.spill_bytes',
                     'acct.tenants.*.prefetch_bytes',
                     'acct.top.*.spill_bytes', 'acct.top.*.prefetch_bytes')
# Times an image's header shifts: it crosses the links at `scale` times
# the rate without growing, each leg by under FLEET_HEADER_BYTES / rate.
FLEET_HEADER_FIELDS = ('ttft_p99_ms', 'disagg.cold_ttft_p99_ms',
                       'disagg.transfer_p50_ms', 'disagg.transfer_p99_ms')
FLEET_HEADER_BYTES = 2048
FLEET_HEADER_MS = 1e-3


# The service spec fields the autoscalers read (the port reads a
# ServiceSpec's attributes from any object): test_serve_traffic.py's SLO
# scale-up run.
FLEET_SPEC = dict(min_replicas=1, max_replicas=2, num_overprovision=None,
                  target_qps_per_replica=None, target_p99_ttft_ms=300.0,
                  target_queue_depth_per_replica=None,
                  upscale_delay_seconds=20, downscale_delay_seconds=1200,
                  base_ondemand_fallback_replicas=None,
                  dynamic_ondemand_fallback=None, spot_placer=None,
                  autoscaling_enabled=True)


def _fleet_scaled(sim_kw, scale):
    """Every byte budget and link rate of a SimConfig times `scale`: the
    same MB then hold the same nodes, and the same bytes cross in the
    same virtual time (scale is a power of two: exactly)."""
    out = dict(sim_kw)
    for key in ('prefix_cache_mb', 'host_tier_mb'):
        if out.get(key):
            out[key] = out[key] * scale
    out['tier_spill_gbps'] = 8.0 * scale
    out['tier_prefetch_gbps'] = 8.0 * scale
    return out


def _memory(device):
    if device != 'cuda':
        return 0
    return torch.cuda.memory_allocated()


def _warm_cublas_streams():
    """cuBLAS keeps a 32 MiB workspace for each stream it has run a
    product on, for the life of the process: the current stream's and
    that of the engines' graph captures (engine.ChunkGraphs).  Run
    products on both before a phase reads its starting memory level, so
    the level holds the workspaces whether or not an earlier phase made
    them."""
    from skypilot_tpu_torch.infer import engine
    current = torch.cuda.current_stream()
    capture = engine.ChunkGraphs(torch.device('cuda')).backend.stream
    capture.wait_stream(current)
    for stream in (current, capture):
        with torch.cuda.stream(stream):
            for dtype in (torch.float32, torch.bfloat16):
                a = torch.ones(64, 64, device='cuda', dtype=dtype)
                torch.nn.functional.linear(a, a, a[0]).sum()
                (a @ a).sum()
    torch.cuda.synchronize()


def fleet_run(name, cfg, params, device, scale=1, counters=None):
    """One arm of FLEET_ARMS through the port's FleetSimulator: the
    summary, session_outputs(), each session's token budget, the trace's
    length, wall seconds, peak and resident device memory (before the
    replicas close) and, with `counters`, the launch counts of the run
    (set to 0 just before it)."""
    from skypilot_tpu_torch.serve import autoscalers
    from skypilot_tpu_torch.serve.traffic import generator, simulator
    _, sim_kw, traffic_kw, faults, autoscaled = FLEET_ARMS[name]
    sim_kw = _fleet_scaled(sim_kw, scale) if scale != 1 else dict(sim_kw)
    postmortems = None
    if 'doctor_cadence_s' in sim_kw:
        postmortems = tempfile.mkdtemp(prefix='chip_smoke_fleet_')
        sim_kw['postmortem_dir'] = postmortems
    chaos = None
    if faults:
        chaos = simulator.ChaosConfig(events=[
            simulator.FaultEvent(t=t, kind=kind, replica=rep, duration_s=d)
            for kind, t, rep, d in faults])
    traffic = generator.TrafficConfig(**traffic_kw)
    if device == 'cuda':
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    sim = simulator.FleetSimulator(simulator.SimConfig(**sim_kw), traffic,
                                   chaos, model_config=cfg, params=params,
                                   device=device)
    try:
        auto = None
        if autoscaled:
            auto = autoscalers.Autoscaler.from_spec(
                'fleet', types.SimpleNamespace(**FLEET_SPEC))
        if counters:
            _zero(counters)
        summary = sim.run(autoscaler=auto)
        if device == 'cuda':
            torch.cuda.synchronize()
        launches = _counts(counters) if counters else None
        seconds = time.perf_counter() - t0
        resident = _memory(device)
        peak = torch.cuda.max_memory_allocated() if device == 'cuda' else 0
        outputs = sim.session_outputs()
        trace = generator.generate_trace(traffic)
        budgets = {sid: min(a.max_new_tokens,
                            sim.cfg.max_seq_len - len(a.prompt))
                   for sid, a in enumerate(trace)}
        n_postmortems = (len(os.listdir(postmortems)) if postmortems
                         else None)
    finally:
        sim.close()
        if postmortems:
            shutil.rmtree(postmortems, ignore_errors=True)
    # close() broke the cycles through the simulator: its replicas, their
    # batchers and arenas go with it, with the cyclic collector off.
    batchers = [weakref.ref(rep.batcher) for rep in sim._all_reps()]
    gc.disable()
    try:
        del sim
        alive = sum(b() is not None for b in batchers)
        after = _memory(device)
    finally:
        gc.enable()
    if alive:
        raise AssertionError(f'{name}: {alive} of {len(batchers)} replica '
                             f'batchers outlived the closed simulator '
                             f'without a collection')
    if device == 'cuda':
        torch.cuda.empty_cache()
    return {'summary': summary, 'outputs': outputs, 'budgets': budgets,
            'arrivals': len(trace), 'seconds': seconds, 'peak': peak,
            'resident': resident, 'launches': launches,
            'postmortems': n_postmortems, 'replicas_freed': len(batchers),
            'after_close': after}


def _fleet_leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _fleet_leaves(v, path + (str(k),))
    elif isinstance(tree, list) and tree and isinstance(tree[0], dict):
        for i, v in enumerate(tree):
            yield from _fleet_leaves(v, path + (str(i),))
    else:
        yield path, tree


def _fleet_field(path):
    """('acct', 'tenants', 'heavy', 'spill_bytes') ->
    'acct.tenants.*.spill_bytes' (and acct.top's rows alike)."""
    if path[0] == 'acct' and len(path) == 4:
        return '.'.join((path[0], path[1], '*', path[3]))
    return '.'.join(path)


def fleet_summary_diff(small, big, scale):
    """How a summary at `scale` times the KV bytes a token differs from
    the small model's: {field: (small, big)} of the byte fields (each
    `scale` times, less the images' headers and the ledger's 6-decimal
    rounding) and of the header-shifted times (each within
    FLEET_HEADER_MS); raises on any other difference."""
    want, have = dict(_fleet_leaves(small)), dict(_fleet_leaves(big))
    if set(want) != set(have):
        raise AssertionError(f'summary fields differ: '
                             f'{sorted(set(want) ^ set(have))}')
    handoffs = want.get(('disagg', 'handoffs'), 0)
    moved = {}
    for path, value in want.items():
        field, got = _fleet_field(path), have[path]
        if got == value:
            continue
        if field in FLEET_BYTE_FIELDS:
            slack = scale * FLEET_HEADER_BYTES * handoffs
            ok = scale * value - slack - 1e-4 <= got <= scale * value + 1e-4
        elif field in FLEET_HEADER_FIELDS and handoffs:
            ok = abs(got - value) <= FLEET_HEADER_MS
        else:
            ok = False
        if not ok:
            raise AssertionError(f'summary field {".".join(path)}: {got} '
                                 f'at {scale}x the KV bytes, {value} at 1x')
        moved['.'.join(path)] = (value, got)
    return moved


def _fleet_complete(label, run):
    """Every request completed, none lost, every session at its token
    budget."""
    s = run['summary']
    if s['requests'] != run['arrivals']:
        raise AssertionError(f'{label}: {s["requests"]} of '
                             f'{run["arrivals"]} requests completed')
    if s.get('chaos', {}).get('sessions_lost', 0):
        raise AssertionError(f'{label}: {s["chaos"]["sessions_lost"]} '
                             f'sessions lost')
    short = {sid: (len(run['outputs'].get(sid, ())), budget)
             for sid, budget in run['budgets'].items()
             if len(run['outputs'].get(sid, ())) != budget}
    if short:
        raise AssertionError(f'{label}: sessions off their token budget '
                             f'(tokens, budget): {short}')


def _fleet_matched(outputs, reference):
    """Tokens of each session equal to the reference run's before their
    first difference, summed, and the sessions equal whole."""
    sids = sorted(reference)
    matched = _matched([outputs[s] for s in sids],
                       [reference[s] for s in sids])
    return {'tokens': sum(len(reference[s]) for s in sids),
            'matched': sum(matched),
            'sessions_equal': sum(outputs[s] == reference[s]
                                  for s in sids),
            'sessions': len(sids)}


def _fleet_log(label, run):
    s = run['summary']
    log(f'  {label}: {run["seconds"]:.1f} s, {s["requests"]} requests, '
        f'peak {run["peak"] / 2**30:.2f} GiB, resident '
        f'{run["resident"] / 2**30:.2f} GiB, '
        f'{run["after_close"] / 2**30:.2f} GiB once closed and dropped '
        f'({run["replicas_freed"]} replica batchers freed without a '
        f'collection)'
        + (f', {run["postmortems"]} postmortems'
           if run['postmortems'] is not None else ''))
    log(f'    summary {json.dumps(s, sort_keys=True)}')
    if run['launches'] is not None:
        log(f'    launches ' + json.dumps(
            {k: v for k, v in run['launches'].items() if v}))


FLEET_ORDER = ('serve-ll', 'serve-pa', 'chaos-kp', 'chaos-sp', 'disagg',
               'single', 'doctor', 'autoscale')


def fleet_path(paths, counters=None, device='cuda', big=None):
    """Phase 19: the serving fleet (serve/traffic/simulator.py) over the
    port's batchers, arms (a) serve, (b) chaos, (c) disagg, (d) doctor
    and autoscaler (FLEET_ARMS).

    LLAMA_DEBUG in f32 on `device` first: (a)'s prefix_affinity run
    twice, its two summaries byte-identical as JSON; (b)'s runs again on
    the host (the port's CPU path, the same weights), summary and
    session_outputs() equal to the card's, and their outputs equal to
    their fault-free runs'; (c)'s outputs equal to the single pool's.
    Then `big` (LLAMA3_8B's widths at 4 of its 32 layers, bf16 weights
    and KV, random from seed 0), every arm once with every byte budget
    and link rate times the KV bytes a token over LLAMA_DEBUG's (8):
    each run completes
    every request, none lost, every session at its token budget, and its
    summary equals the LLAMA_DEBUG run's but for the byte fields and the
    header-shifted times (fleet_summary_diff); on the card K1 (split
    route only) and K3 launch on every arm and K2 on every arm that
    prefills whole prompts (not (c): prompts over prefill_chunk 16 take
    the chunked windows, plain masked attention, in both packages).  The
    8B chaos and disagg arms report their sessions' tokens matched before
    the first difference against their baselines (bf16 replays
    re-prefill what was decoded: no gate).  Device memory after the
    phase, with every simulator closed and dropped, must be back within
    1% of its level before it.  Launch counts land in
    paths['19<arm>-<name>']."""
    from skypilot_tpu_torch.infer.block_pool import block_nbytes
    from skypilot_tpu_torch.models import llama
    debug = llama.LLAMA_DEBUG
    # LLAMA3_8B's widths at 4 of its 32 layers, cut for the run's time
    # (the KV bytes a token stay a power of two over LLAMA_DEBUG's).
    big_name = ('LLAMA3_8B 4 layers' if big is None
                else f'{big.n_layers}-layer d{big.d_model}')
    big = big or dataclasses.replace(llama.LLAMA3_8B, n_layers=4)
    # KV bytes a token (a one-row block) of each model's arena.
    big_bytes, debug_bytes = block_nbytes(big, 1), block_nbytes(debug, 1)
    scale = big_bytes // debug_bytes
    if scale * debug_bytes != big_bytes or scale & (scale - 1):
        raise AssertionError(f'KV bytes a token: {big_bytes} vs '
                             f'{debug_bytes}, not a power of two')
    gc.collect()
    if device == 'cuda':
        _warm_cublas_streams()
        torch.cuda.empty_cache()
    mem0 = _memory(device)
    stats = {'card': CARD.get('line'), 'scale': scale, 'arms': {}}
    small = llama.init_params(
        debug, torch.Generator(device=device).manual_seed(0), device)
    runs = {}
    for name in FLEET_ORDER:
        runs[name] = fleet_run(name, debug, small, device)
        _fleet_log(f'19{FLEET_ARMS[name][0]} {name} LLAMA_DEBUG f32',
                   runs[name])
        _fleet_complete(f'19 {name} LLAMA_DEBUG', runs[name])
    again = fleet_run('serve-pa', debug, small, device)
    a1, a2 = (json.dumps(r['summary'], sort_keys=True)
              for r in (runs['serve-pa'], again))
    if a1 != a2:
        raise AssertionError('19a: two LLAMA_DEBUG prefix_affinity runs '
                             'gave different summaries')
    log(f'  19a: two prefix_affinity runs byte-identical ({len(a1)} bytes '
        f'of JSON; {again["seconds"]:.1f} s)')
    host_params = _to_device(small, 'cpu')
    for name in ('chaos-kp', 'chaos-sp'):
        host = fleet_run(name, debug, host_params, 'cpu')
        if host['summary'] != runs[name]['summary']:
            raise AssertionError(f'19b {name}: host summary '
                                 f'{host["summary"]} != card summary '
                                 f'{runs[name]["summary"]}')
        _same_sessions(f'19b {name}: card vs host', runs[name]['outputs'],
                       host['outputs'])
        log(f'  19b {name}: host run ({host["seconds"]:.1f} s) equal to '
            f'the card\'s in summary and session_outputs()')
    for name, base in FLEET_BASELINE.items():
        _same_sessions(f'19 {name} vs {base} (LLAMA_DEBUG f32)',
                       runs[name]['outputs'], runs[base]['outputs'])
        log(f'  19 {name}: session_outputs() equal to {base}\'s '
            f'({sum(map(len, runs[name]["outputs"].values()))} tokens)')
    stats['debug'] = {n: {'seconds': r['seconds'], 'peak': r['peak'],
                          'summary': r['summary']} for n, r in runs.items()}
    del small, host_params
    gc.collect()
    t0 = time.perf_counter()
    params = llama.init_params(
        big, torch.Generator(device=device).manual_seed(0), device)
    if device == 'cuda':
        torch.cuda.synchronize()
    log(f'  {big.n_layers}-layer d{big.d_model} bf16 random weights '
        f'({big.num_params() / 1e9:.2f}B params, '
        f'{_memory(device) / 1e9:.2f} GB resident) in '
        f'{time.perf_counter() - t0:.1f} s; budgets and link rates x{scale}')
    bigs = {}
    k1, k2, k3 = (counters[:3] if counters else (None, None, None))
    for name in FLEET_ORDER:
        arm = FLEET_ARMS[name][0]
        run = bigs[name] = fleet_run(name, big, params, device, scale,
                                     counters)
        _fleet_log(f'19{arm} {name} {big_name}', run)
        _fleet_complete(f'19 {name} {big_name}', run)
        moved = fleet_summary_diff(runs[name]['summary'], run['summary'],
                                   scale)
        log(f'    equal to the LLAMA_DEBUG summary but for '
            + json.dumps(moved))
        entry = {'seconds': run['seconds'], 'peak': run['peak'],
                 'resident': run['resident'], 'moved': moved,
                 'summary': run['summary']}
        if counters:
            launches = run['launches']
            need = [k1.__name__, k3.__name__]
            if name not in ('disagg', 'single'):
                need.append(k2.__name__)
            _need(f'19 {name}', launches, need)
            if launches[f'{k1.__name__}[split]'] != launches[k1.__name__]:
                raise AssertionError(f'{k1.__name__} missed the split route '
                                     f'on the 19 {name} path')
            paths[f'19{arm}-{name}'] = launches
            entry['launches'] = {k: v for k, v in launches.items() if v}
        stats['arms'][name] = entry
    for name, base in FLEET_BASELINE.items():
        m = _fleet_matched(bigs[name]['outputs'], bigs[base]['outputs'])
        stats['arms'][name]['matched_vs_' + base] = m
        log(f'  19 {name} {big_name} vs {base}: {m["matched"]} of '
            f'{m["tokens"]} '
            f'tokens matched before the first difference, '
            f'{m["sessions_equal"]} of {m["sessions"]} sessions equal '
            f'(reported, no gate)')
    del params, bigs, runs
    gc.collect()
    if device == 'cuda':
        torch.cuda.empty_cache()
    mem1 = _memory(device)
    stats['memory'] = {'before': mem0, 'after': mem1}
    log(f'  19 device memory: {mem0} bytes allocated before the phase, '
        f'{mem1} after it')
    if mem1 > mem0 * 1.01 + (0 if mem0 else 2**20):
        raise AssertionError(f'19: {mem1} bytes allocated after the phase, '
                             f'{mem0} before it')
    log('  19: ' + json.dumps({'card': CARD.get('line'),
                               'arms': {n: {k: v for k, v in e.items()
                                            if k != 'summary'}
                                        for n, e in stats['arms'].items()},
                               'memory': stats['memory']}))
    return stats


# ---- phase 20: the compile-budget audit -------------------------------------

def host_read_control(device='cuda'):
    """A batcher whose decode chunk reads int(token[0]) (the defect the
    audit's no_callbacks check exists for), audited: returns its failed
    checks, which must not be empty.  Eager (graphs=False): a capture of
    that chunk would fail before the audit saw it."""
    from skypilot_tpu_torch.analysis import audit
    from skypilot_tpu_torch.infer.serving import ContinuousBatcher
    dev, cfg, params = audit._setup(device, None, None)
    b = ContinuousBatcher(params, cfg, audit._tiny_gen_config(),
                          decode_chunk=8, device=dev, graphs=False)
    steps = b._decode_steps

    def reads_the_host(n, all_greedy, nucleus):
        int(b._token[0])                      # the defect under test
        return steps(n, all_greedy, nucleus)
    b._decode_steps = reads_the_host
    try:
        report = audit.audit_batcher_decode(b)
        fails = [c for c in report['checks'] if c['status'] == 'fail']
    except Exception as e:  # noqa: broad -- run_audit's 'trace' failure
        fails = [{'name': 'trace', 'status': 'fail',
                  'detail': f'{type(e).__name__}: {e}'}]
    finally:
        del b._decode_steps
    return fails


def audit_path(budgets, device='cuda'):
    """Phase 20: (a) run_audit on `device`, with real graphs on a card:
    no check fails, mesh_decode is a skip with its reason (one process,
    no process group) and the only other skips are output_sharding (no
    mesh); on a card each decode budget was counted by ChunkGraphs;
    (b) `budgets` (serve_path's graph_budgets) all
    hold: each key captured once a bucket visit, pooled decode <= 2
    keys, verify <= 1, fused <= 2, rows, tables and arena at their
    addresses; (c) host_read_control's batcher fails the audit.
    `budgets`: graph_budgets by path (main passes phases 5, 6a, 6b, 7a
    and 7b's).  Returns the seconds of (a)."""
    from skypilot_tpu_torch.analysis import audit
    t0 = time.perf_counter()
    report = audit.run_audit(device=device)
    seconds = time.perf_counter() - t0
    bad = []
    for entry in report['entries']:
        name = entry['entry']
        counts = {k: v for k, v in entry.items()
                  if k not in ('entry', 'checks')}
        statuses = collections.Counter(c['status'] for c in entry['checks'])
        log(f'  20a {name}: {dict(statuses)} '
            + json.dumps(counts, sort_keys=True, default=str))
        for c in entry['checks']:
            log(f"    {c['status']} {c['name']}: {c['detail']}")
            if c['status'] == 'fail':
                bad.append(f"{name}.{c['name']}: {c['detail']}")
            elif c['status'] == 'skip' and not (
                    name == 'mesh_decode' or c['name'] == 'output_sharding'):
                bad.append(f"{name}.{c['name']} skipped: {c['detail']}")
    mesh = next(e for e in report['entries'] if e['entry'] == 'mesh_decode')
    if [c['status'] for c in mesh['checks']] != ['skip']:
        bad.append(f'mesh_decode is not a skip: {mesh["checks"]}')
    else:
        log(f"  20a mesh_decode skip: {mesh['checks'][0]['detail']}")
    if device == 'cuda':
        for entry in report['entries']:
            for c in entry['checks']:
                if 'counted by' in c['detail'] and \
                        'ChunkGraphs' not in c['detail']:
                    bad.append(f"{entry['entry']}.{c['name']} not counted "
                               f"by ChunkGraphs: {c['detail']}")
    if bad:
        raise AssertionError('phase 20a: ' + '; '.join(bad))
    log(f'  20a: run_audit on {device}: {len(report["entries"])} entries, '
        f'{sum(len(e["checks"]) for e in report["entries"])} checks, no '
        f'failure, in {seconds:.1f} s')
    for key, got in budgets.items():
        log(f'  20b {key}: ' + json.dumps(got, sort_keys=True, default=str))
        if not got['ok'] or (device == 'cuda'
                             and 'ChunkGraphs' not in got['counted_by']):
            raise AssertionError(f'phase 20b: the graph budgets of {key} '
                                 f'do not hold: {got}')
    fails = host_read_control(device)
    log('  20c: a decode chunk reading int(token[0]) fails the audit: '
        + json.dumps(fails))
    names = {c['name'] for c in fails}
    if not fails or not ('no_callbacks' in names or 'trace' in names):
        raise AssertionError(f'phase 20c: the host read passed the audit: '
                             f'{fails}')
    return seconds


# ---- phase 21: a tick's host syncs, held against the linter ---------------

CENSUS_TICKS = 32
CENSUS_LAYERS = 4           # of LLAMA3_8B's 32
_SYNC_WARNING = 'synchronizing CUDA operation'


def lint_child_start(root):
    """Start phase 21a's child, ``python -m skypilot_tpu_torch.analysis
    --json --graph-stats`` (lint_child_check reads it)."""
    proc = subprocess.Popen(
        [sys.executable, '-m', 'skypilot_tpu_torch.analysis', '--json',
         '--graph-stats'], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, cwd=root)
    return proc, time.perf_counter()


def lint_child_check(started):
    """Phase 21a: the child exits 0, its call graph has functions, call
    edges and thread entries, and its findings are the committed ones
    (no new finding, every baseline entry still matched: the baseline is
    what the CPU lint recorded).  Returns (the graph stats, the
    suppressed count, seconds from start to exit)."""
    from skypilot_tpu_torch.analysis import baseline
    proc, t0 = started
    try:
        stdout, stderr = proc.communicate(timeout=300)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f'phase 21a: the lint exited '
                             f'{proc.returncode}: {stdout[-3000:]}'
                             f'{stderr[-3000:]}')
    out = json.loads(stdout)
    graph = out['graph']
    if not (graph['functions'] and graph['call_edges']
            and graph['thread_entries']):
        raise AssertionError(f'phase 21a: degenerate call graph {graph}')
    if out['new'] or out['stale_baseline'] or not out['ok'] or \
            len(out['suppressed']) != len(baseline.load_baseline()):
        raise AssertionError(
            f'phase 21a: findings differ from the committed ones: '
            f'new {out["new"]}, stale {out["stale_baseline"]}, '
            f'{len(out["suppressed"])} suppressed')
    return graph, len(out['suppressed']), seconds


def lint_flagged(root, codes=('SKY101', 'SKY105')):
    """{(path, line)} of the port's findings under `codes`: new,
    baselined or allowed by a marker; and engine.host_fetch's
    (path, first line, last line)."""
    import ast as ast_lib
    from skypilot_tpu_torch.analysis import linter
    allowed = []
    found = linter.lint_paths([os.path.join(root, 'skypilot_tpu_torch')],
                              root=root, allowed=allowed)
    flagged = {(v.path, v.line) for v in found + allowed if v.code in codes}
    path = 'skypilot_tpu_torch/infer/engine.py'
    with open(os.path.join(root, path), encoding='utf-8') as f:
        tree = ast_lib.parse(f.read())
    fn = next(n for n in tree.body if isinstance(n, ast_lib.FunctionDef)
              and n.name == 'host_fetch')
    return flagged, (path, fn.lineno, fn.end_lineno)


def _site_status(site, flagged, host_fetch):
    """(in engine.host_fetch, on a flagged line) of a 'path:line' site
    (None: no package frame, neither)."""
    if site is None:
        return False, False
    where, line = site.rsplit(':', 1)
    path, first, last = host_fetch
    return (where == path and first <= int(line) <= last,
            (where, int(line)) in flagged)


def census_gate(sites, flagged, host_fetch):
    """The main-thread sites (thread 'MainThread') that lie neither in
    engine.host_fetch nor on a flagged line; sites: {(site, thread):
    count}, a site being 'path:line' or None (no package frame)."""
    return [(site, count)
            for (site, thread), count in sorted(sites.items(), key=str)
            if thread == 'MainThread'
            and not any(_site_status(site, flagged, host_fetch))]


def _census_hook(records, root):
    """A warnings.showwarning that counts each synchronizing-call warning
    by its innermost frame under skypilot_tpu_torch/ (path:line) and the
    thread that raised it."""
    package = os.path.join(root, 'skypilot_tpu_torch') + os.sep

    def hook(message, category, filename, lineno, file=None, line=None):
        if _SYNC_WARNING not in str(message):
            return
        site = None
        frame = sys._getframe(1)
        while frame is not None:
            name = frame.f_code.co_filename
            if name.startswith(package):
                site = (f'{os.path.relpath(name, root)}:'
                        f'{frame.f_lineno}')
                break
            frame = frame.f_back
        key = (site, threading.current_thread().name)
        with records['lock']:
            records['sites'][key] = records['sites'].get(key, 0) + 1
    return hook


def _census_prompts(rng, vocab):
    """The census traffic, in admission order: 15 short prompts, one
    longer than prefill_chunk (the 4th: chunked windows), and the 9th,
    the first to wait for a slot, sharing its first 2 x 64 tokens with
    the 1st (a prefix hit); max_new_tokens from 120 to 400, so requests
    finish and admit mid-run."""
    lengths = [150, 60, 33, 600, 90, 45, 70, 24, 160, 50, 80, 20, 110, 64,
               40, 17]
    prompts = [[int(t) for t in rng.randint(1, vocab, size=n)]
               for n in lengths]
    prompts[8][:128] = prompts[0][:128]
    budgets = [int(n) for n in rng.randint(120, 400, size=len(prompts))]
    return prompts, budgets


def sync_census(counters, root=None, ticks=CENSUS_TICKS):
    """Phase 21: (b) a ContinuousBatcher at LLAMA3_8B's widths
    (CENSUS_LAYERS of its 32 layers), bf16, random weights from seed 21,
    8 slots, decode_impl 'pooled', graphs on, a prefix cache; warmed on
    one run of the census traffic (every chunk key captured), then
    `ticks` ticks of a second run under
    torch.cuda.set_sync_debug_mode('warn'), each synchronizing call
    counted by site and thread (_census_hook).  The rest of the run is
    drained after, and every request must return its budget of in-range
    tokens.  (a), the lint as a child, runs beside the drain and the
    in-process lint, once the ticks are done.  Needs the card; raises
    without one.  Returns (the census, the launch counts of the census
    ticks, (a)'s (graph stats, baselined findings, seconds))."""
    if not torch.cuda.is_available():
        raise RuntimeError('phase 21b needs a CUDA device')
    from skypilot_tpu_torch.infer import engine
    from skypilot_tpu_torch.infer.engine import GeneratorConfig
    from skypilot_tpu_torch.infer.serving import ContinuousBatcher
    from skypilot_tpu_torch.models import llama
    root = root or os.path.dirname(os.path.abspath(__file__))
    cfg = dataclasses.replace(llama.LLAMA3_8B, n_layers=CENSUS_LAYERS)
    params = llama.init_params(
        cfg, torch.Generator(device='cuda').manual_seed(21), 'cuda')
    gen = GeneratorConfig(max_seq_len=2048, batch_size=8, prefill_chunk=256,
                          prefix_cache_mb=512, prefix_block=64)
    b = ContinuousBatcher(params, cfg, gen, decode_chunk=16, device='cuda')
    if b.graphs is None:
        raise AssertionError(f'phase 21b: graphs off: '
                             f'{b.graphs_off_reason}')
    rng = np.random.RandomState(21)

    def submit_run():
        prompts, budgets = _census_prompts(rng, cfg.vocab_size)
        return [(b.submit(p, max_new_tokens=n), n)
                for p, n in zip(prompts, budgets)]

    def finish(rids, label):
        b.run_until_idle()
        for rid, n in rids:
            out = b.result(rid)
            if len(out) != n or not all(0 <= t < cfg.vocab_size
                                        for t in out):
                raise AssertionError(f'phase 21b {label}: request {rid} '
                                     f'returned {len(out)} tokens of {n}')

    try:
        finish(submit_run(), 'warm-up')
        rids = submit_run()
        hits0 = b._prefix.hits
        torch.cuda.synchronize()
        records = {'lock': threading.Lock(), 'sites': {}}
        fetches0 = engine.host_fetch.calls
        graphs0 = (b.graphs.captures, b.graphs.replays)
        tick_ms = []
        _zero(counters)
        mode = torch.cuda.get_sync_debug_mode()
        with warnings.catch_warnings():
            warnings.simplefilter('always')
            warnings.showwarning = _census_hook(records, root)
            torch.cuda.set_sync_debug_mode('warn')
            try:
                for _ in range(ticks):
                    t0 = time.perf_counter()
                    b.step()
                    tick_ms.append((time.perf_counter() - t0) * 1e3)
            finally:
                torch.cuda.set_sync_debug_mode(mode)
        launches = _counts(counters)
        fetches = engine.host_fetch.calls - fetches0
        captures = b.graphs.captures - graphs0[0]
        replays = b.graphs.replays - graphs0[1]
        hits = b._prefix.hits - hits0
        child = lint_child_start(root)
        try:
            finish(rids, 'census run')
            flagged, host_fetch = lint_flagged(root)
        finally:
            lint = lint_child_check(child)
    finally:
        b.close()
    del b, params
    sites = records['sites']
    bad = census_gate(sites, flagged, host_fetch)
    census = {
        'ticks': ticks, 'layers': f'{CENSUS_LAYERS} of 32',
        'sites': [dict(zip(('in_host_fetch', 'flagged'),
                           _site_status(s, flagged, host_fetch)),
                       site=s, thread=t, count=c)
                  for (s, t), c in sorted(sites.items(), key=str)],
        'syncs': sum(sites.values()),
        'main_thread_syncs': sum(c for (s, t), c in sites.items()
                                 if t == 'MainThread'),
        'host_fetch_calls': fetches, 'decode_chunks': replays,
        'captures_during': captures, 'prefix_hits': hits,
        'median_tick_ms': statistics.median(tick_ms),
        'tick_ms_min_max': [min(tick_ms), max(tick_ms)],
        'card': CARD.get('line'),
    }
    log('SYNC_CENSUS ' + json.dumps(census, sort_keys=True))
    if bad:
        raise AssertionError(f'phase 21b: main-thread synchronizing calls '
                             f'the linter does not flag (SKY101/SKY105) and '
                             f'outside engine.host_fetch: {bad}')
    if captures:
        raise AssertionError(f'phase 21b: {captures} captures during the '
                             f'census ticks: the warm-up missed a key')
    if not hits:
        raise AssertionError('phase 21b: no prefix hit in the census ticks')
    return census, launches, lint


# ---- phase 22: Gemma fine-tuning --------------------------------------------

# examples/gemma_finetune.yaml runs train_llama.py --hf-model
# google/gemma-7b --seq-len 4096, one sequence a card.  22a trains 4 of
# Gemma-7B's 28 layers (the cut, for the run's time and memory), 22c's
# checkpoint holds 2.
GEMMA_TRAIN_LAYERS = 4
GEMMA_TRAIN_SEQ = 4096
GEMMA_TRAIN_STEPS = 6
GEMMA_CKPT_LAYERS = 2
# 22b: Gemma's attention at debug size (2 heads of 256, MHA, gelu-tanh,
# the sqrt(d) embedding scale) in bf16, card (kernels) vs host (plain
# versions).  The card rounds p to bf16 against a 32-key tile's running
# max (K2) and sums in other orders, so: losses within 1e-3 relative,
# grad norms (bf16 values) within two bf16 ulps (2^-6), and the first
# step's q, k and v projection gradients within 2^-5 of each leaf's
# largest element (the bound tests/test_torch_train.py holds the port's
# bf16 gradients to against the JAX package's).
GEMMA_LIKE = dict(d_model=512, n_heads=2, n_kv_heads=2, d_ff=1024,
                  mlp_act='gelu_tanh', embed_scale=512 ** 0.5,
                  dtype=torch.bfloat16, remat=True)
GEMMA_LOSS_REL, GEMMA_NORM_REL, GEMMA_GRAD_REL = 1e-3, 2 ** -6, 2 ** -5
_GEMMA_LAUNCHES = ('flash_attention[lse]', 'flash_attention_dq',
                   'flash_attention_dkv', 'rms_norm')


def gemma_config(directory, layers):
    """Gemma-7B's published config (GEMMA_7B) cut to `layers` of its 28,
    as train_llama --hf-model builds its config: convert.read_hf_config
    over the config.json written into `directory`."""
    from skypilot_tpu_torch.models import convert
    os.makedirs(directory, exist_ok=True)
    with open(os.path.join(directory, 'config.json'), 'w',
              encoding='utf-8') as f:
        json.dump(dict(GEMMA_7B, num_hidden_layers=layers), f)
    return convert.read_hf_config(directory)


def _gemma_tc(label, launches):
    """Fails unless K2 with its lse, K5, K6 and K3 launched on `label`'s
    path and every K5 and K6 launch took the tensor-core route."""
    log(f'  {label} launches: ' + json.dumps(
        {n: launches[n] for n in _GEMMA_LAUNCHES + (
            'flash_attention_dq[tc]', 'flash_attention_dkv[tc]')}))
    _need(label, launches, _GEMMA_LAUNCHES)
    for name in ('flash_attention_dq', 'flash_attention_dkv'):
        if launches[f'{name}[tc]'] != launches[name]:
            raise AssertionError(
                f'{label}: {launches[name]} {name} launches, '
                f'{launches[f"{name}[tc]"]} of them on the tensor-core route')


def gemma_train_path(counters, root, check_route=True):
    """22a: Gemma-7B's widths (d 3072, 16 heads of 256, ff 24576, vocab
    256000, gelu-tanh, sqrt(d) embedding scale; the (1 + w) norms are a
    checkpoint's layout, folded in at load) at GEMMA_TRAIN_LAYERS of its
    28 layers, random bf16 weights from seed 0 on the card, trained as
    train_llama trains without --resume: the config's remat (train_llama
    sets none), its TrainConfig, batch 1 x 4096, GEMMA_TRAIN_STEPS steps
    through Trainer.fit (train_path).  Prints the losses, step time,
    MFU = 6 N x tokens/s / 989e12 with N the layers and the lm_head and
    with N the layers alone, and peak memory; fails (with check_route)
    unless every K5 and K6 launch took the tensor-core route.  Returns
    the launches and train_path's stats."""
    from skypilot_tpu_torch.train import trainer
    cfg = gemma_config(os.path.join(root, '22a'), GEMMA_TRAIN_LAYERS)
    log(f'  22a config (convert.read_hf_config): d {cfg.d_model}, '
        f'{cfg.n_heads} heads of {cfg.head_dim} over {cfg.n_kv_heads}, ff '
        f'{cfg.d_ff}, vocab {cfg.vocab_size}, {cfg.mlp_act}, embed scale '
        f'{cfg.embed_scale:.3f}, remat {cfg.remat} ({cfg.remat_policy}), '
        f'loss_chunk {cfg.loss_chunk}; {cfg.n_layers} of 28 layers (the '
        f'cut)')
    steps = GEMMA_TRAIN_STEPS
    launches, stats = train_path(
        f'22a Gemma-7B widths, {cfg.n_layers} of 28 layers, 1x'
        f'{GEMMA_TRAIN_SEQ}', cfg, 1, GEMMA_TRAIN_SEQ, steps,
        trainer.TrainConfig(learning_rate=2e-5,
                            warmup_steps=min(100, steps // 10 + 1),
                            total_steps=steps), counters)
    v_d = cfg.vocab_size * cfg.d_model
    n_layers = cfg.num_params() - 2 * v_d
    rate = stats['tokens_per_s']
    log(f'  22a MFU = 6 N x tokens/s / {BF16_FLOPS / 1e12:g}e12 at '
        f'{rate:.1f} tokens/s: {6 * (n_layers + v_d) * rate / BF16_FLOPS:.4f}'
        f' with the lm_head (N = {(n_layers + v_d) / 1e9:.3f}B), '
        f'{6 * n_layers * rate / BF16_FLOPS:.4f} without it (N = '
        f'{n_layers / 1e9:.3f}B); step {stats["step_time_s"]:.4f} s, peak '
        f'{stats["peak_memory_gb"]:.2f} GB ({CARD["line"]})')
    if check_route:
        _gemma_tc('22a', launches)
    return launches, stats


def gemma_train_parity():
    """22b: a Gemma-like config (GEMMA_LIKE: head_dim 256, 2 layers) in
    bf16 on the card (K2, K3, K5, K6) and on the host (plain versions)
    from the same weights: the first step's q, k and v projection
    gradients, then 3 Trainer steps (loss and grad_norm of each), within
    GEMMA_GRAD_REL, GEMMA_LOSS_REL and GEMMA_NORM_REL."""
    from skypilot_tpu_torch.models import llama
    from skypilot_tpu_torch.train import trainer

    cfg = dataclasses.replace(llama.LLAMA_DEBUG, **GEMMA_LIKE)
    params = llama.init_params(cfg, torch.Generator().manual_seed(22), 'cpu')
    # 63 input tokens: a ragged last tile in every attention kernel.
    tokens = next(trainer.synthetic_batches(4, 63, cfg.vocab_size))['tokens']
    names = [n for n, _ in _tree_items(params)]
    grads = {dev: dict(zip(names, _grads_on(
        lambda p, b: llama.loss_fn(p, b, cfg), params, tokens, dev)))
        for dev in ('cpu', 'cuda')}
    worst = 0.0
    for name in ('/layers/attn/wq', '/layers/attn/wk', '/layers/attn/wv'):
        got, want = grads['cuda'][name].float(), grads['cpu'][name].float()
        scale = float(want.abs().max())
        err = float((got - want).abs().max()) / scale
        worst = max(worst, err)
        if not scale > 0 or err > GEMMA_GRAD_REL:
            raise AssertionError(f'22b: {name} gradient card vs host '
                                 f'{err:.3e} of its largest (bound '
                                 f'{GEMMA_GRAD_REL:g})')
    tc = trainer.TrainConfig(learning_rate=1e-3, warmup_steps=1,
                             total_steps=4)
    steps = {}
    for dev in ('cpu', 'cuda'):
        tr = trainer.Trainer(lambda p, b: llama.loss_fn(p, b, cfg),
                             _clone_to(params, dev), tc, device=dev)
        batches = trainer.synthetic_batches(4, 63, cfg.vocab_size)
        steps[dev] = [(float(m['loss']), float(m['grad_norm'])) for m in (
            tr.run_step(next(batches)) for _ in range(3))]
    loss_err = max(_rel(c[0], h[0]) for c, h in zip(steps['cuda'],
                                                    steps['cpu']))
    norm_err = max(_rel(c[1], h[1]) for c, h in zip(steps['cuda'],
                                                    steps['cpu']))
    log(f'  22b Gemma-like bf16 (hd {cfg.head_dim}, {cfg.n_layers} layers) '
        f'card vs host: q/k/v first-step gradients within {worst:.3e} of '
        f'their largest (bound {GEMMA_GRAD_REL:g}); 3 Trainer steps (loss, '
        f'grad_norm): card {steps["cuda"]}, host {steps["cpu"]}; losses '
        f'within {loss_err:.2e} (bound {GEMMA_LOSS_REL:g}), grad norms '
        f'{norm_err:.2e} (bound {GEMMA_NORM_REL:g})')
    if loss_err > GEMMA_LOSS_REL or norm_err > GEMMA_NORM_REL:
        raise AssertionError('22b: card and host Trainer steps disagree')


def gemma_entry_path(root):
    """22c: a Gemma-7B-width checkpoint of GEMMA_CKPT_LAYERS layers in
    HF's layout (phase 12's writer, bf16 from seed 22), then ``python -m
    skypilot_tpu_torch.train.train_llama --hf-model DIR --seq-len 4096
    --steps 2 --data-file README.md`` as a child process, which must
    print 2 finite losses; the directory is deleted after.  Returns the
    child's launch counts."""
    hf_config = dict(GEMMA_7B, num_hidden_layers=GEMMA_CKPT_LAYERS)
    nbytes = sum(int(np.prod(s)) for _, s in hf_tensor_specs(hf_config)) * 2
    free = shutil.disk_usage(root).free
    if free < nbytes + (1 << 30):
        raise AssertionError(f'22c needs {nbytes + (1 << 30)} bytes free '
                             f'under {root}, {free} are free')
    directory = os.path.join(root, '22c')
    try:
        t0 = time.perf_counter()
        write_hf_checkpoint(
            directory, hf_config,
            lambda name, shape: draw_hf_tensor(name, shape, 22,
                                               torch.bfloat16, 'cuda', True))
        write_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        lines, launches = _run_child(
            'skypilot_tpu_torch.train.train_llama',
            ['--hf-model', directory, '--seq-len', str(GEMMA_TRAIN_SEQ),
             '--steps', '2', '--data-file', os.path.join(HERE, 'README.md')])
        child_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(directory, ignore_errors=True)
    stdout = '\n'.join(lines)
    losses = (_losses(stdout, 'warmup step') + _losses(stdout, 'final:'))
    log(f'  22c checkpoint {nbytes / 1e9:.2f} GB '
        f'({nbytes / 2e9:.3f}B parameters) written in {write_s:.1f} s; '
        f'train_llama --hf-model in {child_s:.1f} s: losses {losses}; '
        + ' | '.join(ln for ln in lines if ln.startswith(('device=', 'final'))))
    if len(losses) != 2 or not np.isfinite(losses).all():
        raise AssertionError(f'22c: train_llama printed losses {losses}:\n'
                             f'{stdout[-3000:]}')
    _gemma_tc('22c', launches)
    return launches


# ---- phase 23: the port's bench ----------------------------------------------

# bench_spec's verify windows at its card shapes: 8 slots of LLAMA_1B
# (8 KV heads, G 2) at W 13 (spec_k 12), at positions 32-147 (32-token
# prompts, up to 115 of their 128 new tokens in).
BENCH_SPEC_WINDOW = (('verify', [32, 40, 48, 64, 80, 96, 128, 147], 13),)
# scripts/bench_compare.py's FIELDS paths that phase 23's sub-benches fill
# (the training headline and bench_decode's three variants).
BENCH_FILLED = ('llama_1b_tok_s_chip', 'decode.')
# bench_spec's verify against the plain decode step (SPEC_LOGIT_STEPS
# steps of LLAMA_1B bf16 at bench_spec's shapes): the logits of one token
# at one position from the two paths agree within TP_LOGITS_REL of the
# largest, phase 16e's bound for two schedules of the same bf16 products.
SPEC_LOGIT_STEPS = 4


def _script(name):
    """scripts/<name>.py, loaded by its path: bench_compare (standard
    library only: its FIELDS are the headline paths a diff of two runs
    reads) and torch_bench_diag."""
    import importlib.util
    path = os.path.join(HERE, 'scripts', f'{name}.py')
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _headline_value(headline, path):
    node = headline
    for part in path.split('.'):
        if not isinstance(node, dict) or part not in node:
            return None
        node = node[part]
    return node


def spec_verify_logits(steps=SPEC_LOGIT_STEPS):
    """What bench_spec's greedy parity rests on, in bf16:
    scripts/torch_bench_diag.py's spec part (loaded by its path) at
    LLAMA_1B bf16 and bench_spec's shapes: each step's plain decode step
    (8 rows, K1) and verify window (W 13: 104 rows, K4) on copies of one
    arena score the same token at the same position.  Returns the
    largest logit difference over the steps, the largest logit, the
    slots whose argmax the two agree on, and the pieces' differences."""
    from skypilot_tpu_torch.models import llama
    diag = _script('torch_bench_diag').spec_numerics(
        torch.bfloat16, torch.device('cuda'), llama.LLAMA_1B, steps)
    gc.collect()
    torch.cuda.empty_cache()
    return {'max_abs_diff': max(st['step_vs_verify13']['max_abs']
                                for st in diag['steps']),
            'max_abs_logit': max(st['max_abs_logit']
                                 for st in diag['steps']),
            'argmax_equal_a_step': [st['argmax_equal_step_verify13']
                                    for st in diag['steps']],
            'attention': diag['attention'],
            'products_rows8_vs_rows104_differing': {
                name: d['rows8_vs_rows104']['elems_differing']
                for name, d in diag['products'].items()}}


def bench_path(counters, train_headline, device='cuda'):
    """23: the port's bench (skypilot_tpu_torch/bench.py) at its card
    shapes: bench_decode, bench_spec and bench_prefix_reuse, then
    build_headline over them and phase 8a's training headline (8a runs
    bench.bench_train), with every launch count set to 0 just before and
    read just after.  Then spec_verify_logits.  Fails if a sub-bench
    reports an error, if pooled_path_cache_migrations is not 0, if
    bench_spec's high-acceptance arm accepted no draft, if the verify's
    logits differ from the decode step's by more than TP_LOGITS_REL of
    the largest, if a bench_compare FIELDS path these fill is missing or
    not a finite number, or if the headline does not carry 8a's
    tokens/s.  greedy_parity and agreeing_prefix_share are printed as
    measured: bf16 may round a verify row otherwise than a decode step
    (PERF.md).  Returns the launch counts."""
    from skypilot_tpu_torch import bench

    compare = _script('bench_compare')
    seconds = {}
    _zero(counters)
    subs = {}
    for name, fn in (('decode', bench.bench_decode),
                     ('spec', bench.bench_spec),
                     ('prefix', bench.bench_prefix_reuse)):
        t0 = time.perf_counter()
        subs[name] = fn(device)
        seconds[name] = time.perf_counter() - t0
        gc.collect()
        torch.cuda.empty_cache()
    launches = _counts(counters)
    tok_s, mfu = train_headline
    headline = bench.build_headline(tok_s, mfu, {}, subs['decode'], None,
                                    prefix=subs['prefix'],
                                    spec=subs['spec'])
    t0 = time.perf_counter()
    logits = spec_verify_logits()
    seconds['spec_verify_logits'] = time.perf_counter() - t0
    log('  23 BENCH_HEADLINE ' + json.dumps(headline))
    log('  23 ' + json.dumps({
        'card': CARD['line'],
        'seconds': {k: round(v, 1) for k, v in seconds.items()},
        'spec': {k: subs['spec'][k] for k in (
            'greedy_parity', 'agreeing_prefix_share', 'prefix_cache_mb',
            'spec_off', 'spec_off_adversarial', 'high_acceptance',
            'adversarial')},
        'spec_verify_logits': logits,
        'prefix': {k: subs['prefix'][k] for k in (
            'cold', 'warm', 'cold_tokens_saved', 'warm_tokens_saved',
            'hits', 'misses')},
        'decode': {k: subs['decode'][k] for k in (
            'span_overhead', 'bucketed_vs_fixed',
            'pooled_path_cache_migrations')},
        'rooflines': {v: {k: subs['decode'][v][k] for k in (
            'roofline_tok_s', 'roofline_streamed_tok_s',
            'steady_streamed_roofline_pct', 'latency_per_token_ms_p50',
            'latency_per_token_ms_p99')}
            for v in ('bf16', 'int8_kv', 'int8_w_kv')}}))
    for name, out in subs.items():
        if 'error' in out:
            raise AssertionError(f'23: bench_{name} reported {out["error"]}')
    if subs['decode']['pooled_path_cache_migrations'] != 0:
        raise AssertionError('23: the pooled decode variants migrated '
                             f'{subs["decode"]["pooled_path_cache_migrations"]}'
                             ' caches')
    if not subs['spec']['high_acceptance']['accept_rate'] > 0:
        raise AssertionError('23: bench_spec\'s high-acceptance arm '
                             'accepted no draft')
    if logits['max_abs_diff'] > TP_LOGITS_REL * logits['max_abs_logit']:
        raise AssertionError(f'23: the verify window\'s logits differ from '
                             f'the decode step\'s by {logits}')
    filled = [path for path, _ in compare.FIELDS
              if path.startswith(BENCH_FILLED)]
    if len(filled) != 7:
        raise AssertionError(f'23: bench_compare FIELDS filled here: {filled}')
    for path in filled:
        value = _headline_value(headline, path)
        if not isinstance(value, (int, float)) or not math.isfinite(value):
            raise AssertionError(f'23: headline {path} = {value!r}')
    if headline['llama_1b_tok_s_chip'] != round(tok_s, 1):
        raise AssertionError(f'23: headline llama_1b_tok_s_chip '
                             f'{headline["llama_1b_tok_s_chip"]}, 8a '
                             f'measured {tok_s}')
    return launches


def _same_sessions(what, got, want):
    """Equal session_outputs(), or an error naming the first session (by
    its place in sid order) and token where they part."""
    if sorted(got) != sorted(want):
        raise AssertionError(f'{what}: sessions {sorted(got)} vs '
                             f'{sorted(want)}')
    _same_tokens(what, [got[s] for s in sorted(got)],
                 [want[s] for s in sorted(want)])


def _zero(counters):
    for c in counters:
        c.launches = 0
        for attr in ROUTES.values():
            if hasattr(c, attr):
                setattr(c, attr, 0)


def _counts(counters):
    """Launch counts by wrapper name, and by route (ROUTES)."""
    out = {c.__name__: c.launches for c in counters}
    for route, attr in ROUTES.items():
        out.update({f'{c.__name__}[{route}]': getattr(c, attr)
                    for c in counters if hasattr(c, attr)})
    return out


def _need(label, launches, names):
    for name in names:
        if launches[name] <= 0:
            raise AssertionError(f'{name} was never launched on the {label} '
                                 f'path')


def main() -> int:
    if not torch.cuda.is_available():
        print('chip_smoke: torch.cuda.is_available() is false; this run '
              'needs an NVIDIA card', file=sys.stderr)
        return 2
    from skypilot_tpu_torch.infer.engine import GeneratorConfig
    from skypilot_tpu_torch.models import llama
    from skypilot_tpu_torch.ops import _kernels, attention, decode_attention
    from skypilot_tpu_torch.ops import rmsnorm
    from skypilot_tpu_torch.train import trainer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    CARD['line'] = nvidia_smi_line()
    CARD['kind'] = torch.cuda.get_device_name(0)
    run_start = time.perf_counter()
    clock = {'start': run_start, 'name': None}

    def phase(msg):
        """Log the seconds of the phase that ends, then the next one."""
        now = time.perf_counter()
        if clock['name']:
            log(f'  phase {clock["name"]}: {now - clock["start"]:.1f} s')
        clock.update(start=now, name=msg[1:msg.index('/')])
        log(msg)

    def last_phase_done():
        log(f'  phase {clock["name"]}: '
            f'{time.perf_counter() - clock["start"]:.1f} s')

    phase(f'[1/23] device: {CARD["line"]} | torch {torch.__version__} '
        f'cuda {torch.version.cuda}')

    phase('[2/23] build')
    _kernels.LIBRARY.get()
    log(f'  built {_kernels.LIBRARY.path.name} in '
        f'{_kernels.LIBRARY.build_seconds:.1f} s')
    (_kernels.BUILD_DIR / 'build.log').write_text(_kernels.LIBRARY.build_log)
    for line in _kernels.LIBRARY.build_log.splitlines():
        if 'spill' in line and ' 0 bytes spill stores' not in line:
            log(f'  ptxas: {line.strip()}')
    ptxas = ptxas_report(_kernels.LIBRARY.build_log)
    for name, info in ptxas.items():
        if '_mma_kernel' in name and info['spill_bytes']:
            raise AssertionError(f'tensor-core kernel {name} spills: {info}')
        if 'rmsnorm_kernel' in name and info['spill_bytes']:
            raise AssertionError(f'rmsnorm kernel {name} spills (its rows '
                                 f'live in registers): {info}')
        if ('decode_kernel' in name or 'combine_kernel' in name) \
                and info['spill_bytes']:
            raise AssertionError(f'decode kernel {name} spills: {info}')

    phase('[3/23] kernels vs plain versions')
    t0 = time.perf_counter()
    decode = check_decode(decode_attention, ptxas)
    decode['g2'], decode['combine g2'] = check_decode_at(
        decode_attention, ptxas, 'G2', 10)
    decode['gemma'], decode['combine gemma'] = check_decode_at(
        decode_attention, ptxas, 'Gemma-7B', 12)
    # 12c-int8's decode: K1 over an int8 arena at hd 256.
    decode['int8 gemma'], _ = check_decode_at(
        decode_attention, ptxas, 'Gemma-7B', 14, int8=True)
    decode['qwen'], decode['combine qwen'] = check_decode_at(
        decode_attention, ptxas, 'Qwen2.5-1.5B', 13)
    for seed, label in enumerate(('LLAMA3_8B tp2 rank',
                                  'LLAMA3_70B tp4 rank',
                                  'Qwen2.5-1.5B tp4 rank',
                                  'LLAMA3_8B fleet'), 30):
        decode[label], decode[f'combine {label}'] = check_decode_at(
            decode_attention, ptxas, label, seed)
    shared = check_decode_shared(decode_attention, ptxas)
    contig = check_contig_decode(decode_attention, ptxas)
    # K7 per tp shard (18f): LLAMA3_8B at tp 2, 4 KV heads of G 4 a rank.
    contig_rank = check_contig_decode(decode_attention, ptxas, kv_heads=4,
                                      group=4, tag='LLAMA3_8B tp2 rank',
                                      seed=33, variants=('bf16', 'int8'))
    window = check_window(decode_attention, ptxas)
    window_rank = check_window(decode_attention, ptxas, 4, 4,
                               TP_WINDOW_SHAPES, 'LLAMA3_8B tp2 rank')
    # Phase 23's verify windows: bench_spec's, LLAMA_1B in bf16.
    window_1b = check_window(decode_attention, ptxas, 8, 2,
                             BENCH_SPEC_WINDOW, 'LLAMA_1B', timed=('bf16',))
    window256 = {tag: check_window(decode_attention, ptxas, kv, group,
                                   tag=tag, head_dim=256)
                 for tag, kv, group in WINDOW_HD256}
    flash = {'flash_attention': check_flash(attention, ptxas)}
    flash.update({name: check_flash_at(attention, ptxas, name)
                  for name in FLASH_SHAPES})
    norm = {name: check_rmsnorm(rmsnorm, name, ptxas)
            for name in NORM_SHAPES}
    train = check_flash_train(attention, ptxas)
    k1 = decode_attention.decode_attention_pooled
    k4v = decode_attention.decode_window_attention_pooled
    k4f = decode_attention.fused_step_attention_pooled
    k7 = decode_attention.decode_attention
    k2, k3 = attention.flash_attention, rmsnorm.rms_norm
    k5, k6 = attention.flash_attention_dq, attention.flash_attention_dkv
    counters = [k1, k2, k3, k4v, k4f, k5, k6, k7]
    tiny = torch.zeros(1, device='cuda')
    read = torch.zeros(10 << 20, dtype=torch.bfloat16, device='cuda')
    log(f'  timing floor (time_ms): one tiny kernel '
        f'{time_ms(lambda: tiny.add_(1)):.4f} ms; torch.sum over 20 MB '
        f'{time_ms(read.sum):.4f} ms (bound 0.0063)')
    del tiny, read

    phase('[4/23] slice parity, LLAMA_DEBUG and MoE f32, card vs host')
    slice_parity()
    train_parity()
    post_train_parity()
    moe_parity()

    phase('[5/23] main path, LLAMA3_8B bf16 behind the HTTP replica')
    cfg = llama.LLAMA3_8B
    t0 = time.perf_counter()
    params = llama.init_params(
        cfg, torch.Generator(device='cuda').manual_seed(0), 'cuda')
    torch.cuda.synchronize()
    log(f'  LLAMA3_8B bf16 random weights: {cfg.num_params() / 1e9:.2f}B '
        f'params in {time.perf_counter() - t0:.1f} s')
    base = dict(max_seq_len=2048, batch_size=8, prefill_chunk=256)
    paths = {}
    # The same burst eagerly, then through graphs (the main path, whose
    # counts the kernels line reports): identical greedy tokens.
    eager5, _, eager_out, _ = serve_path('main path eager (graphs=False)',
                                      params, GeneratorConfig(**base),
                                      counters, graphs=False)
    budgets = {}
    paths['5'], _, graph_out, st = serve_path('main path', params,
                                           GeneratorConfig(**base), counters)
    budgets['5'] = st['graph_budgets']
    _same_tokens('phase 5: graphs vs eager', graph_out, eager_out)
    log(f'  phase 5: greedy tokens identical eager and through graphs '
        f'({sum(map(len, graph_out))} tokens)')
    for key, launches in (('5 eager', eager5), ('5', paths['5'])):
        _need(key, launches, [c.__name__ for c in (k1, k2, k3)])
        if launches[f'{k1.__name__}[split]'] != launches[k1.__name__]:
            raise AssertionError(f'{k1.__name__} missed the split route on '
                                 f'the {key} path')

    phase('[6/23] main path with spec_k 12 and fuse_budget 264: (a) bf16, '
        '(b) int8 KV and weights')
    spec = dict(base, spec_k=12, fuse_budget=264)
    paths['6a'], _, _, st = serve_path('6a bf16 spec+fused', params,
                                    GeneratorConfig(**spec), counters)
    budgets['6a'] = st['graph_budgets']
    paths['6b'], _, _, st = serve_path('6b int8 spec+fused', params,
                                    GeneratorConfig(
                                        **spec, kv_cache_dtype='int8',
                                        weights_dtype='int8'), counters)
    budgets['6b'] = st['graph_budgets']
    for key in ('6a', '6b'):
        _need(key, paths[key], [c.__name__ for c in (k1, k2, k3, k4v, k4f)]
              + [f'{c.__name__}[{r}]' for c in (k4v, k4f)
                 for r in ('tc', 'split')])

    phase("[7/23] legacy plane decode_impl='paged' (K7): (a) bf16 and (b) int8 "
        'KV behind the HTTP replica, (c) Generator.generate')
    legacy = dict(base, decode_impl='paged', decode_chunk=16)
    with warnings.catch_warnings():
        warnings.simplefilter('ignore', DeprecationWarning)
        paths['7a'], mig_a, _, st = serve_path('7a paged bf16', params,
                                            GeneratorConfig(**legacy),
                                            counters)
        budgets['7a'] = st['graph_budgets']
        paths['7b'], mig_b, _, st = serve_path(
            '7b paged int8 KV', params,
            GeneratorConfig(**legacy, kv_cache_dtype='int8'), counters)
        budgets['7b'] = st['graph_budgets']
        paths['7c'] = generate_path('7c Generator paged bf16', params,
                                    GeneratorConfig(**legacy), counters)
    for key in ('7a', '7b', '7c'):
        _need(key, paths[key], [c.__name__ for c in (k2, k3, k7)])
        if paths[key][k1.__name__]:
            raise AssertionError(f'{k1.__name__} launched on the {key} path')
    if not mig_a['grow'] + mig_b['grow']:
        raise AssertionError('the paged plane never grew its slot cache')
    del params
    gc.collect()
    torch.cuda.empty_cache()

    phase('[8/23] train path: (a) LLAMA_1B at the bench settings, (b) '
        'LLAMA3_8B widths at depth 2')
    remat = dict(remat=True, remat_policy='dots')
    cfg_1b = dataclasses.replace(llama.LLAMA_1B, max_seq_len=2048,
                                 loss_chunk=256, **remat)
    paths['8a'], stats_8a, headline_8a = bench_train_path(counters)
    paths['8b'], _ = train_path(
        '8b LLAMA3_8B widths, 2 layers, 2x4096', dataclasses.replace(
            llama.LLAMA3_8B, n_layers=2, max_seq_len=4096, loss_chunk=512,
            **remat),
        2, 4096, 6, trainer.TrainConfig(warmup_steps=2, total_steps=6),
        counters)

    phase('[9/23] checkpoints: (a) LLAMA_1B async saves, restore, continue '
          '(phase 8a settings), (b) a managed job SIGTERMed and resumed '
          'through train_llama --resume auto')
    scratch = tempfile.mkdtemp(prefix='chip_smoke_ckpt_')
    try:
        # 9a keeps 2 checkpoints and stages a third; 9b keeps all of 4
        # (steps 4, 8, 12, 16) and may leave a torn fifth.
        need_gb = 5 * _state_gb(cfg_1b) + 2
        free_gb = shutil.disk_usage(scratch).free / 1e9
        if free_gb < need_gb:
            raise AssertionError(
                f'phase 9 needs {need_gb:.1f} GB free under {scratch} for '
                f'LLAMA_1B checkpoints, {free_gb:.1f} GB are free')
        log(f'  {free_gb:.1f} GB free under {scratch}, {need_gb:.1f} needed')
        paths['9a'] = checkpoint_path(
            cfg_1b, trainer.TrainConfig(warmup_steps=2, total_steps=12),
            counters, os.path.join(scratch, '9a'), stats_8a['step_time_s'])
        shutil.rmtree(os.path.join(scratch, '9a'))
        os.makedirs(os.path.join(scratch, '9b'))
        recovery_path(os.path.join(scratch, '9b'))
    finally:
        shutil.rmtree(scratch, ignore_errors=True)

    phase('[10/23] post-training: (a) LoRA-SFT and (b) LoRA-DPO of LLAMA3_8B '
          'at 32 layers, (c) GRPO on LLAMA_1B, (d) the entry points')
    gc.collect()
    torch.cuda.empty_cache()
    scratch = tempfile.mkdtemp(prefix='chip_smoke_post_')
    try:
        sft_data, dpo_data, small_sft, small_dpo = _post_train_data(scratch)
        cfg_8b = dataclasses.replace(llama.LLAMA3_8B, max_seq_len=2048,
                                     loss_chunk=512, **remat)
        t0 = time.perf_counter()
        base = llama.init_params(
            cfg_8b, torch.Generator(device='cuda').manual_seed(0), 'cuda')
        torch.cuda.synchronize()
        log(f'  LLAMA3_8B bf16 base, {cfg_8b.n_layers} layers: '
            f'{cfg_8b.num_params() / 1e9:.2f}B params in '
            f'{time.perf_counter() - t0:.1f} s')
        sub = time.perf_counter()
        paths['10a'], _ = lora_sft_path(base, cfg_8b, sft_data, counters)
        log(f'  10a: {time.perf_counter() - sub:.1f} s')
        sub = time.perf_counter()
        paths['10b'], _ = lora_dpo_path(base, cfg_8b, dpo_data, counters)
        log(f'  10b: {time.perf_counter() - sub:.1f} s')
        del base
        gc.collect()
        torch.cuda.empty_cache()
        sub = time.perf_counter()
        paths['10c'], _ = grpo_path(counters)
        log(f'  10c: {time.perf_counter() - sub:.1f} s')
        gc.collect()
        torch.cuda.empty_cache()
        sub = time.perf_counter()
        entry_points_path(scratch, small_sft, small_dpo)
        log(f'  10d: {time.perf_counter() - sub:.1f} s')
    finally:
        shutil.rmtree(scratch, ignore_errors=True)

    phase('[11/23] Mixtral-8x7B widths, random bf16 weights: (a) 16 of 32 '
          'layers served, (c) LoRA-SFT of that base, (b) trained at depth 2')
    gc.collect()
    torch.cuda.empty_cache()
    mixtral_path(counters, paths)

    phase('[12/23] HF checkpoints written in HF\'s layout and loaded by '
          'convert.load_hf_model: (a) Gemma-7B and (b) Qwen2.5-1.5B at '
          'their published widths served, 12b LoRA-SFT in process and '
          'through train_sft --hf-model, (c) Gemma-7B served with spec_k 12 '
          'and fuse_budget 264 in bf16 and int8 KV, (d) debug-size parity '
          'card vs host')
    gc.collect()
    torch.cuda.empty_cache()
    scratch = tempfile.mkdtemp(prefix='chip_smoke_hf_')
    try:
        sub = time.perf_counter()
        gemma_path(counters, paths, scratch)
        log(f'  12a and 12c: {time.perf_counter() - sub:.1f} s')
        sub = time.perf_counter()
        qwen_path(counters, paths, scratch)
        log(f'  12b: {time.perf_counter() - sub:.1f} s')
        sub = time.perf_counter()
        hf_parity(scratch)
        log(f'  12d: {time.perf_counter() - sub:.1f} s')
    finally:
        shutil.rmtree(scratch, ignore_errors=True)

    phase('[13/23] ResNet: (a) ResNet18Thin one SGD step card vs host, (b) '
          'train_resnet\'s path, ResNet50 at batch 256 of 224x224')
    gc.collect()
    torch.cuda.empty_cache()
    resnet_parity()
    resnet_train_path()

    phase('[14/23] prefix cache, host tier and handoff at LLAMA3_8B bf16, '
          '8 of 32 layers: (a) prefix reuse, (b) the host tier, (c) the '
          'prefill -> decode handoff in bf16 and int8 KV, (d) debug-size '
          'parity card vs host')
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    # LLAMA3_8B's widths at 8 of its 32 layers (cut for the run's time;
    # the budgets follow the KV bytes a token), random from phase 5's
    # seed; phase 15 serves the same cut.
    cfg8 = dataclasses.replace(cfg, n_layers=8)
    params = llama.init_params(
        cfg8, torch.Generator(device='cuda').manual_seed(0), 'cuda')
    torch.cuda.synchronize()
    log(f'  LLAMA3_8B widths, 8 of 32 layers, bf16 random weights (phase '
        f'5\'s seed) in {time.perf_counter() - t0:.1f} s')
    for sub, run in (('14a', lambda: prefix_reuse_path(params, counters,
                                                       paths, cfg=cfg8)),
                     ('14b', lambda: tier_path(params, counters, paths,
                                               cfg=cfg8)),
                     ('14c', lambda: [handoff_path(params, counters, paths,
                                                   kv, cfg=cfg8)
                                      for kv in (None, 'int8')])):
        t0 = time.perf_counter()
        run()
        log(f'  {sub}: {time.perf_counter() - t0:.1f} s')
    del params
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    prefix_parity()
    log(f'  14d: {time.perf_counter() - t0:.1f} s')

    phase('[15/23] telemetry and the entry points around the batcher at '
          'LLAMA3_8B bf16, 8 of 32 layers in process, 32 in the children: '
          '(a) spans and the cost ledger on and off, (b) the OpenAI routes, '
          '(c) /v1/embeddings (encode), (d) batch_infer --resume, (e) '
          'eval_ppl')
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    params = llama.init_params(
        cfg8, torch.Generator(device='cuda').manual_seed(0), 'cuda')
    torch.cuda.synchronize()
    log(f'  LLAMA3_8B widths, 8 of 32 layers, bf16 random weights (phase '
        f'5\'s seed) in {time.perf_counter() - t0:.1f} s')
    t0 = time.perf_counter()
    served, span_buf = telemetry_path(params, counters, paths, cfg=cfg8)
    log(f'  15a: {time.perf_counter() - t0:.1f} s')
    for sub, run in (('15b', lambda: openai_path(served, span_buf, counters,
                                                 paths, cfg=cfg8)),
                     ('15c', lambda: embeddings_path(served, counters,
                                                     paths, cfg=cfg8))):
        t0 = time.perf_counter()
        run()
        log(f'  {sub}: {time.perf_counter() - t0:.1f} s')
    served.close()
    del served, params
    gc.collect()
    torch.cuda.empty_cache()
    scratch = tempfile.mkdtemp(prefix='chip_smoke_entry_')
    try:
        t0 = time.perf_counter()
        batch_infer_path(paths, scratch)
        log(f'  15d: {time.perf_counter() - t0:.1f} s')
        t0 = time.perf_counter()
        eval_ppl_path(paths, counters, scratch)
        log(f'  15e: {time.perf_counter() - t0:.1f} s')
    finally:
        shutil.rmtree(scratch, ignore_errors=True)

    phase('[16/23] tensor-parallel serving, rank processes sharing cuda:0 '
          'over gloo: (a) collectives, (b) LLAMA3_8B tp 2 (bf16, int8 KV, '
          'spec_k + fuse_budget) at 12 layers and an f32 config vs tp 1, '
          '(c) LLAMA3_70B widths at 4 layers, tp 4, (d) Qwen2.5-1.5B tp 4 '
          '(tp_kv 2 x tpq 2) from HF files, (e) overlap chunks 2 and 4 '
          'bitwise the sync path, (f) the control channel')
    gc.collect()
    torch.cuda.empty_cache()
    scratch = tempfile.mkdtemp(prefix='chip_smoke_tp_')
    try:
        for sub, run in (('16a', tp_collectives_path),
                         ('16b', lambda: tp_serve_path(paths)),
                         ('16c', lambda: tp_70b_path(paths)),
                         ('16d', lambda: tp_qwen_path(paths, scratch)),
                         ('16e', lambda: tp_overlap_path(paths)),
                         ('16f', tp_channel_path)):
            t0 = time.perf_counter()
            run()
            log(f'  {sub}: {time.perf_counter() - t0:.1f} s')
    finally:
        shutil.rmtree(scratch, ignore_errors=True)
    phase('[17/23] training meshes, rank processes sharing cuda:0 over '
          'gloo: (a) LLAMA_1B bf16 fsdp 2 x tp 2 vs one card, (b) f32 at '
          'dp 2 x fsdp 2 and fsdp 2 x tp 2, (c) LLAMA3_8B widths at 2 '
          'layers, fsdp 4, (d) train_long_context sp 4 (ring attention) at '
          'seq 8192, (e) train_moe small at ep 4 and ep 2 x dp 2, (f) '
          'checkpoints across mesh shapes, (g) allreduce_bench')
    gc.collect()
    torch.cuda.empty_cache()
    scratch = tempfile.mkdtemp(prefix='chip_smoke_mesh_')
    try:
        mesh_training_path(paths, scratch)
    finally:
        shutil.rmtree(scratch, ignore_errors=True)
    phase('[18/23] pipelines and post-training meshes, rank processes '
          'sharing cuda:0 over gloo: (a) LLAMA_1B bf16 pp 2 x dp 2, (b) f32 '
          'at pp 4 and pp 2 x fsdp 2, (c) pp 2 x sp 2 at 2 x 4096, (d) '
          'LoRA-SFT and LoRA-DPO of LLAMA3_8B widths at fsdp 2 x tp 2 with '
          '--merge-save, GRPO at dp 2 x fsdp 2, (e) MoE capacity at sp 2 x '
          'ep 2; (f) the legacy planes at tp 2 (K7 per shard)')
    gc.collect()
    torch.cuda.empty_cache()
    scratch = tempfile.mkdtemp(prefix='chip_smoke_pp_')
    try:
        t0 = time.perf_counter()
        pp_training_path(paths, scratch)
        log(f'  18a-e: {time.perf_counter() - t0:.1f} s')
        t0 = time.perf_counter()
        legacy_tp_path(paths)
        log(f'  18f: {time.perf_counter() - t0:.1f} s')
    finally:
        shutil.rmtree(scratch, ignore_errors=True)
    close_rank_pools()
    phase('[19/23] the serving fleet (serve/traffic/simulator.py) over the '
          'port\'s batchers: (a) least_load and prefix_affinity, (b) kill + '
          'preempt and stall + partition, (c) disaggregated prefill, (d) '
          'the doctor and the SLO autoscaler; LLAMA_DEBUG f32 on the card '
          '(and (b) on the host), then LLAMA3_8B bf16 at 4 layers')
    gc.collect()
    torch.cuda.empty_cache()
    fleet_path(paths, counters)
    phase('[20/23] the compile-budget audit (analysis/audit.py): (a) '
          'run_audit on the card with real graphs, (b) the graph budgets '
          'of phases 5-7\'s batchers, (c) a decode chunk that reads '
          'int(token[0]) must fail it')
    gc.collect()
    torch.cuda.empty_cache()
    audit_path(budgets)
    phase("[21/23] a tick's host syncs, held against the linter: (a) "
          'python -m skypilot_tpu_torch.analysis --json --graph-stats as a '
          'child, (b) the sync census of 32 warm ticks of a graphed '
          '8-slot batcher at LLAMA3_8B\'s widths, 4 of its 32 layers')
    gc.collect()
    torch.cuda.empty_cache()
    census, paths['21'], (graph, baselined, lint_s) = sync_census(counters)
    log(f'  21a: the lint as a child in {lint_s:.1f} s: exit 0, '
        f'{baselined} baselined findings, graph {json.dumps(graph)}')
    _need('21', paths['21'], [c.__name__ for c in (k1, k2, k3)])
    phase('[22/23] Gemma fine-tuning: (a) Gemma-7B widths at 4 of 28 layers, '
          '1 x 4096, through Trainer.fit, (b) a Gemma-like hd-256 config in '
          'bf16 card vs host, (c) train_llama --hf-model on a 2-layer '
          'Gemma-7B-width checkpoint as a child')
    gc.collect()
    torch.cuda.empty_cache()
    scratch = tempfile.mkdtemp(prefix='chip_smoke_gemma_')
    try:
        for sub, run in (('22a', lambda: gemma_train_path(counters,
                                                          scratch)[0]),
                         ('22b', gemma_train_parity),
                         ('22c', lambda: gemma_entry_path(scratch))):
            t0 = time.perf_counter()
            out = run()
            if out is not None:
                paths[sub] = out
            log(f'  {sub}: {time.perf_counter() - t0:.1f} s')
    finally:
        shutil.rmtree(scratch, ignore_errors=True)
    phase('[23/23] the port\'s bench (skypilot_tpu_torch/bench.py) at its '
          'card shapes: the training headline, bench_decode, bench_spec, '
          'bench_prefix_reuse, build_headline')
    gc.collect()
    torch.cuda.empty_cache()
    paths['23'] = bench_path(counters, headline_8a)
    _need('23', paths['23'], [c.__name__ for c in (k1, k2, k3, k4v)])
    last_phase_done()
    log(f'  whole run: {time.perf_counter() - run_start:.1f} s')
    # Phase 22's launches: K2 (all with its lse), K5 and K6 at Gemma-7B's
    # training shape, K3 at its width.
    gemma22 = ('22a', '22c')
    for key in ('8a', '8b', '9a', '10a', '10b', '10c', '11b', '11c') + gemma22:
        _need(key, paths[key], [c.__name__ for c in (k2, k3, k5, k6)]
              + [f'{k2.__name__}[lse]'])
    mesh17 = ('17a', '17c', '17e-ep4', '17e-ep2dp2')  # 17d: K3 only
    for key in mesh17:
        _need(key, paths[key], [c.__name__ for c in (k2, k3, k5, k6)]
              + [f'{k2.__name__}[lse]'])
    # 17d's sp ranks attend over the ring (plain f32 products): K3 only.
    _need('17d', paths['17d'], [k3.__name__])
    for key in ('18a', '18d-sft', '18d-dpo', '18d-grpo'):
        _need(key, paths[key], [c.__name__ for c in (k2, k3, k5, k6)]
              + [f'{k2.__name__}[lse]'])
    # 18c's and 18e's stages attend over the sp ring: K3 only.
    for key in ('18c', '18e'):
        _need(key, paths[key], [k3.__name__])
    _need('18d-grpo', paths['18d-grpo'], [k1.__name__])
    legacy18 = ('18f-paged', '18f-paged-int8', '18f-inplace',
                '18f-inplace-int8')
    for key in legacy18:
        _need(key, paths[key], [k2.__name__, k3.__name__])
        if paths[key][k1.__name__]:
            raise AssertionError(f'{k1.__name__} launched on the {key} '
                                 f'path')
    for key in ('18f-paged', '18f-paged-int8'):
        _need(key, paths[key], [k7.__name__])
    for key in ('18f-inplace', '18f-inplace-int8'):
        if paths[key][k7.__name__]:
            raise AssertionError(f'{k7.__name__} launched on the {key} '
                                 f'path')
    _need('10c', paths['10c'], [k1.__name__])
    for key in ('11a', '12a', '12b'):
        _need(key, paths[key], [c.__name__ for c in (k1, k2, k3)])
    gemma12c = tuple(key for key, _ in GEMMA_SPEC_ARMS)
    for key in gemma12c:
        _need(key, paths[key], [c.__name__ for c in (k1, k2, k3, k4v, k4f)]
              + [f'{c.__name__}[tc]' for c in (k4v, k4f)])
    _need('12b-sft', paths['12b-sft'], [c.__name__ for c in (k2, k3, k5, k6)]
          + [f'{k2.__name__}[lse]'])
    phase14 = ('14a', '14b', '14c-bf16', '14c-int8')
    for key in phase14:
        _need(key, paths[key], [c.__name__ for c in (k1, k3)])
    # Phase 15's serving paths decode (K1) and prefill (K2, K3); encode
    # and eval_ppl run K2 without its lse and K3.
    decode15 = ('15a', '15b', '15d')
    for key in decode15:
        _need(key, paths[key], [c.__name__ for c in (k1, k2, k3)])
    # Phase 16's ranks decode (K1) and prefill (K2, K3); 16b-spec runs
    # K4's verify windows and fused lane.
    tp16 = ('16b', '16b-int8', '16b-spec', '16c', '16d', '16e')
    for key in tp16:
        _need(key, paths[key], [c.__name__ for c in (k1, k2, k3)])
    _need('16b-spec', paths['16b-spec'], [k4v.__name__, k4f.__name__])
    for key in ('15c', '15e'):
        _need(key, paths[key], [c.__name__ for c in (k2, k3)])
        if paths[key][f'{k2.__name__}[lse]']:
            raise AssertionError(f'{k2.__name__} wrote its lse on the '
                                 f'{key} path')
    for key, launches in paths.items():
        # Every path runs bf16 at head_dim 128 (12a's and 12c's K2, 12c's
        # K4 and phase 22's K2, K5 and K6 at 256): the tensor-core route
        # only; and B KV (8 slots x 16, 8 or 2 KV heads) < 2 blocks an SM:
        # the split route only.
        route = [(c, 'tc') for c in (k2, k5, k6)]
        route += [(c, 'split') for c in (k1, k7)
                  if key[0] in '567' or key in ('10c', '11a', '12a', '12b',
                                                '18d-grpo', '21') + gemma12c
                  or key in phase14 or key in decode15 or key in legacy18
                  or key.startswith('19')]
        route += [(c, 'tc') for c in (k4v, k4f)
                  if key[0] == '6' or key in gemma12c or key == '23']
        for c, r in route:
            if launches[f'{c.__name__}[{r}]'] != launches[c.__name__]:
                raise AssertionError(
                    f'{c.__name__}: {launches[c.__name__]} launches on the '
                    f'{key} path, {launches[f"{c.__name__}[{r}]"]} of them on '
                    f'the {r} route')

    def entry(res, counter, keys):
        by_path = {k: paths[k][counter.__name__] for k in keys}
        out = dict(res, launches=sum(by_path.values()),
                   launches_by_path=by_path)
        for route, attr in ROUTES.items():
            if hasattr(counter, attr):
                out[attr] = sum(paths[k][f'{counter.__name__}[{route}]']
                                for k in keys)
        return out

    # K2 and K3 on every path; phase 12's widths have their own entries
    # (12b-sft's K2 launches all write the lse: its entry is the train
    # one at TRAIN_SHAPES['qwen']).
    hf = ('12a', '12b', '12b-sft') + gemma12c
    # Phase 17's K2 launches are its lse entries' (train rows below), its
    # K3 launches the per-rank widths' entries.
    rest = tuple(k for k in paths if k not in hf and k not in tp16
                 and not k.startswith(('17', '18', '19', '22', '23')))
    # Phase 19's 8B arms: K1 and K2 at the fleet's shapes (the disagg
    # arms prefill in chunked windows: no K2), K3 at 4096.
    fleet19 = tuple(k for k in paths if k.startswith('19'))
    tp8b = ('16b', '16b-int8', '16b-spec', '16e')
    kernels = [
        entry(decode['bf16'], k1, ('5', '6a', '11a', '21') + decode15),
        entry(decode['LLAMA3_8B tp2 rank'], k1, ('16b', '16b-spec', '16e')),
        entry(decode['LLAMA3_70B tp4 rank'], k1, ('16c',)),
        entry(decode['Qwen2.5-1.5B tp4 rank'], k1, ('16d',)),
        entry(decode['LLAMA3_8B fleet'], k1, fleet19),
        # Phase 23's K1 launches (LLAMA_1B's G 2; bench_decode's int8
        # variants among them) with 10c's shape.
        entry(decode['g2'], k1, ('10c', '18d-grpo', '23')),
        entry(decode['gemma'], k1, ('12a', '12c-bf16')),
        entry(decode['int8 gemma'], k1, ('12c-int8',)),
        entry(decode['qwen'], k1, ('12b',)),
        # 16b-int8's ranks run the same int8 instantiation over 4 KV
        # heads (a grid dimension) where 6b runs 8.
        entry(decode['int8'], k1, ('6b', '16b-int8')),
        # Phase 14's K1 launches decode slots whose tables share blocks.
        entry(shared['bf16'], k1, ('14a', '14b', '14c-bf16')),
        entry(shared['int8'], k1, ('14c-int8',)),
        # 18d's DPO references and GRPO rollouts run K2 without its lse
        # as 10b and 10c do.
        entry(flash['flash_attention'], k2, rest + ('18d-dpo', '18d-grpo',
                                                    '23')),
        entry(flash['flash_attention[Gemma-7B hd256]'], k2,
              ('12a',) + gemma12c),
        entry(flash['flash_attention[Qwen2.5-1.5B G6 prefill]'], k2,
              ('12b',)),
        entry(flash['flash_attention[LLAMA3_8B tp2 rank prefill]'], k2,
              tp8b + legacy18),
        entry(flash['flash_attention[LLAMA3_70B tp4 rank prefill]'], k2,
              ('16c',)),
        entry(flash['flash_attention[Qwen2.5-1.5B tp4 rank prefill]'], k2,
              ('16d',)),
        entry(flash['flash_attention[LLAMA3_8B fleet prefill]'], k2,
              fleet19),
        entry(norm['rms_norm'], k3, rest + tp8b + ('17c', '18d-sft',
                                                   '18d-dpo') + legacy18
              + fleet19),
        entry(norm['rms_norm[LLAMA_1B d2048]'], k3, ('17a', '17d', '18a',
                                                     '18c', '18d-grpo',
                                                     '23')),
        entry(norm['rms_norm[MoE small d1024]'], k3,
              ('17e-ep4', '17e-ep2dp2', '18e')),
        entry(norm['rms_norm[Gemma-7B]'], k3, ('12a',) + gemma22 + gemma12c),
        entry(norm['rms_norm[Qwen2.5-1.5B]'], k3, ('12b', '12b-sft', '16d')),
        entry(norm['rms_norm[LLAMA3_70B d8192]'], k3, ('16c',)),
        entry(window_rank['verify', 'bf16'], k4v, ('16b-spec',)),
        entry(window_rank['fused', 'bf16'], k4f, ('16b-spec',)),
        entry(window['verify', 'bf16'], k4v, ('6a',)),
        # Phase 23's verify windows: bench_spec's, bf16 on the tensor cores.
        entry(window_1b['verify', 'bf16'], k4v, ('23',)),
        entry(window['fused', 'bf16'], k4f, ('6a',)),
        entry(window['verify', 'int8'], k4v, ('6b',)),
        entry(window['fused', 'int8'], k4f, ('6b',)),
        # 12c's K4 at hd 256 (Gemma-7B); Gemma-2B's MQA shape (G 8) runs
        # the same instantiations, checked beside them, on no main path.
        *[entry(dict(window256['Gemma-7B'][lane, label],
                     gemma_2b_mqa=window256['Gemma-2B MQA'][lane, label]),
                counter, (f'12c-{label}',))
          for lane, counter in (('verify', k4v), ('fused', k4f))
          for label in ('bf16', 'int8')],
        entry(contig['bf16'], k7, ('7a', '7c')),
        entry(contig['int8'], k7, ('7b',)),
        # K7 per tp shard on 18f's 'paged' plane, summed over its ranks.
        entry(contig_rank['bf16'], k7, ('18f-paged',)),
        entry(contig_rank['int8'], k7, ('18f-paged-int8',)),
    ]
    # The combine runs inside every split launch of K1 and K7.
    split_paths = {k: paths[k][f'{c.__name__}[split]']
                   for c, keys in ((k1, ('5', '6a', '6b', '11a', '16b-int8',
                                         '21') + phase14 + decode15),
                                   (k7, ('7a', '7b', '7c', '18f-paged',
                                         '18f-paged-int8'))) for k in keys}
    kernels.append(dict(decode['combine'],
                        launches=sum(split_paths.values()),
                        launches_by_path=split_paths))
    for key, keys in (('combine g2', ('10c', '18d-grpo', '23')),
                      ('combine gemma', ('12a',) + gemma12c),
                      ('combine qwen', ('12b',)),
                      ('combine LLAMA3_8B tp2 rank', ('16b', '16b-spec',
                                                      '16e')),
                      ('combine LLAMA3_70B tp4 rank', ('16c',)),
                      ('combine Qwen2.5-1.5B tp4 rank', ('16d',)),
                      ('combine LLAMA3_8B fleet', fleet19)):
        by_path = {k: paths[k][f'{k1.__name__}[split]'] for k in keys}
        kernels.append(dict(decode[key], launches=sum(by_path.values()),
                            launches_by_path=by_path))
    # K4's combine runs inside every split launch of K4.
    window_split = {k: sum(paths[k][f'{c.__name__}[split]']
                           for c in (k4v, k4f)) for k in ('6a', '6b', '23')}
    kernels.append(dict(window['combine'],
                        launches=sum(window_split.values()),
                        launches_by_path=window_split))
    rank_split = {'16b-spec': sum(paths['16b-spec'][f'{c.__name__}[split]']
                                  for c in (k4v, k4f))}
    kernels.append(dict(window_rank['combine'], launches=rank_split['16b-spec'],
                        launches_by_path=rank_split))
    gemma_split = {k: sum(paths[k][f'{c.__name__}[split]']
                          for c in (k4v, k4f)) for k in gemma12c}
    kernels.append(dict(window256['Gemma-7B']['combine'],
                        gemma_2b_mqa=window256['Gemma-2B MQA']['combine'],
                        launches=sum(gemma_split.values()),
                        launches_by_path=gemma_split))
    kernels += [entry(train[name, key], counter, keys)
                for name, counter in (('lse', k2), ('dq', k5), ('dkv', k6))
                for key, keys in (('1b', ('8a', '9a', '10c', '18d-grpo')),
                                  ('8b', ('8b', '10a', '10b', '11b',
                                          '11c')),
                                  ('qwen', ('12b-sft',)),
                                  ('1b rank', ('17a',)),
                                  ('8b rank', ('17c',)),
                                  ('moe ep4 rank', ('17e-ep4',)),
                                  ('moe ep2 dp2 rank', ('17e-ep2dp2',)),
                                  ('1b pp mb', ('18a',)),
                                  ('8b lora rank', ('18d-sft', '18d-dpo')),
                                  ('gemma', gemma22))]
    log(json.dumps({'kernels': kernels}))
    log(CARD['line'])
    log(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': CARD['kind'],
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
