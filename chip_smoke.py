#!/usr/bin/env python3
"""GPU smoke test of the PyTorch port: builds the CUDA kernels from the
checkout's sources, holds each against its plain PyTorch version on the
card, serves full-width qwen3-4b (random weights, 36 layers) through the
port's paged and contiguous serving paths, trains it through the SATA
prefill kernels, serves it again through the shared-prefix page cache
and the int8 / sketch summary backends and under host swaps, a crash
and a corrupted swap handle, kills and resumes a serve from its
checkpoint, serves it under the QoS degradation ladder and with cascade
token retirement, serves full-width olmo-1b (depth cut to OLMO_LAYERS)
and full-width qwen3-moe-235b-a22b (depth cut to MOE_LAYERS layers, the
decode kernel at G = 16), trains qwen3-moe at full width, serves
full-width llama-3.2-vision-90b (depth cut to VLM_LAYERS) and
whisper-base (the decode kernel at D = 64) through their
cross-attention, serves full-width zamba2-2.7b (the Mamba2 backbone,
depth cut to ZAMBA_LAYERS, the decode kernel at D = 80 in its shared
block) and rwkv6-1.6b (no attention), runs the paper's SATA scheduler
and CIM estimation plane on its four workloads and the quickstart's
kernel step at a layer's width, times every kernel at its main path's
shape and the prefill kernel against its roofline, runs the scale-out
wrappers (tensor-parallel decode through the decode kernel,
sequence-sharded selection) on two ranks sharing the card, and trains
on a (data, model) mesh of those ranks: qwen3-4b, qwen3-moe, zamba2
and rwkv6, each against one device; then holds the dry run's counts on
meta tensors to the card's and rooflines two production cells.

    python3 chip_smoke.py            # needs one CUDA GPU (an H100 here)
    python3 chip_smoke.py --mutants  # phases 2 and 6 (and 8 for the
                                     # prefill kernel) on each of
                                     # MUTANTS: each must fail
    python3 chip_smoke.py --ab DIR   # phase 2, then this tree's decode
                                     # and prefill kernels and DIR's (an
                                     # earlier checkout) timed in turns
    python3 chip_smoke.py --ab-prefill DIR  # the prefill part of --ab alone
    python3 chip_smoke.py --mesh     # phases 1, 24-25 and 27 alone
    python3 chip_smoke.py --dryrun   # phases 1 and 26 alone

Phases (any failure exits non-zero; none is caught so a later one runs;
each prints its host seconds as a ``[phase]`` line):
  1. device and build — card name and power limit, torch/CUDA versions,
     one nvcc per kernel source, all started together;
  2. kernel vs plain version on the card, both layouts, at the main-path
     shape, at the main shape over aliased page tables (two slots' rows
     share 16 physical pages, one row maps a page twice in a row: the
     tables the prefix cache makes), at qwen3-moe's shape (B8 KV4 G16
     D128, page 64, bf16 and fp32), at whisper-base's (B8 KV8 G1 D64,
     page 64, bf16 and fp32), at zamba2-2.7b's (B8 KV32 G1 D80, page
     64, pos 192-255 of 512, bf16 and fp32), edge cases (G = 12 among
     them), and
     the refusal of G = 17 before any launch (fp32 <= 1e-5 max abs;
     bf16 <= 2e-2 max abs and at most 1% of the outputs off the plain
     version's bits; paged == contiguous bitwise, the contiguous cache
     being the pool's logical view);
  3. serve qwen3-4b paged (page 64) through ``repro_torch.launch.serve``;
     the paged kernel's launch count must equal layers x decode steps;
  4. the same requests on the contiguous layout: equal token streams;
  5. decode kernel timing at the main-path shape, at qwen3-moe's G = 16
     shape, at whisper-base's D = 64 and zamba2-2.7b's D = 80 shapes, at
     one slot (B1) and at a long row (pos ~4000): CUDA events
     (median of 30 runs, L2
     flushed before each, queued behind a device sleep so the events
     time the device, not the host) and the profiler's device time over
     the same calls (which also fails if the wrapper launches anything
     but the kernel), its bound from the bytes the output needs at 3.35
     TB/s, the plain version, and SDPA over the dense cache with the
     same mask as the library yardstick; one layer's exact re-plan on
     the host clock beside it; the contiguous kernel's partial mode
     (context-parallel decode: the fp32 output and each head's lse) at
     the main, G = 16, D = 64 and D = 80 cases with one more count-0
     row, against its plain version (``check_partial``: lse −inf and
     output 0 on that row, one partial combined alone == the default
     mode bitwise), timed beside the default mode;
  6. the SATA prefill kernels (compacted grid B3 in threshold, mask and
     block mode; dense grid B4) against their plain versions: fp32 <=
     1e-5, bf16 within phase 2's limits; admitted-key counts per row
     equal to the plain version's, except bf16 threshold mode (scores
     summed on the tensor cores), where every row's count must lie in
     ``admitted_window``'s range (the rows off the plain count are
     reported); B3 == B4 bitwise on the same plan, two launches bitwise
     equal;
     at the main shape, the rows where the kernel admits other keys than
     the chunked route's backward recompute selects (reported); the
     cases include zamba2-2.7b's shared block (BH 32, S 512, D 80, blocks
     128, causal threshold mode, top-k 64) in bf16 and fp32, and a
     context-parallel rank's call (``rows_case``, phase 25's cp job:
     BH 32, its 2,048 query rows at q_pos 2,048.. against 4,096 keys,
     causal threshold mode, top-k 64, bf16, D 128);
  7. the main path: ``launch.train.train`` on full-width qwen3-4b cut to
     TRAIN_LAYERS = 2 of its 36 layers (cut to make room for phase
     25 in the run's time limit), chunked selection
     (``topk_impl="bisect"``), batch 1, S = 4096, 4 steps; the
     compacted-grid kernel's launches must equal
     layers x steps x 2 (the forward and the remat recompute), the dense
     grid's 0; layer 0's kernel arguments are recorded on the way; then
     one more step under ``torch.profiler`` for the device time by
     kernel and the device's idle share;
  8. one forward + backward at full width (4 layers) with the kernel
     route on and off (``_attend``): the same loss and grad norm within
     ROUTE_RTOL, layer 0's attention output within ROUTE_ATTN_RTOL; then
     with ``remat`` "none", "dots" and "full": loss and grad norm within
     ROUTE_RTOL of "none"'s (bitwise equality reported), peak memory
     of each;
  9. the dense-selection route: ``make_prefill_step`` with
     ``topk_impl="sort"`` at full width, 4 layers, S = 2048, on the
     compacted and the dense grid: equal logits bitwise; layer 0's
     dense-grid arguments are recorded on the way;
 10. prefill kernels on the arguments recorded in phases 7 and 9, and
     B3 on phase 6's bf16 D = 80 case: kernel
     vs plain version (phase 6's limits), the body the kernel's entry
     point takes (bf16 must take the tensor cores), timing (CUDA events, median,
     L2 flushed), the bound from the flops and bytes this input needs,
     and SDPA with the equivalent boolean mask as the library yardstick;
 11. (phases 11-13a at PREFIX_LAYERS = 6 of the 36 layers, full width,
     for phase 26's time; phase 3's paged serve is repeated at that
     depth first, the fp32 stream for phase 12)
     phase 3's serve with prompts sharing their first 1000 tokens (15
     full pages + a 40-row partial page, copied on write), the prefix
     cache on and off: equal token streams, hit rate >= 14/16, copies on
     write and shared pages > 0, the paged kernel's launches = layers x
     decode steps, ``check_invariants`` after the run; prefill ms of a
     hit and a miss, decode step ms, pages held with and without;
 12. int8 summaries at ``replan=1``: phase 3's token stream; int8 +
     sketch re-plans every 8th step (plan width 8 pages) with the prefix
     cache on, phase 11's workload: every layer's final plan state holds
     int8 bounds containing the fp32 bounds of the cache's keys and
     ``kv_indices`` naming valid blocks; at the main shape
     ``sketch_replan`` with C·F >= nkb == ``full_replan`` bitwise; one
     layer's exact re-plan, int8 incremental step and int8 sketch re-plan
     on the host clock;
 13. faults: (a) phase 11's workload under ``fault_plan()`` — a slot
     preempted into a parked host-swap handle (the pool squeezed dry),
     a byte of it flipped (caught at the claim gate, quarantined,
     re-prefilled), a second parked handle, a crash that swaps every
     live slot to host in full and rebuilds the device cache and the
     allocator, then the squeeze returned: token streams equal phase
     11's, host swaps >= 2 pinning shared prefix pages, one crash, one
     corruption injected and detected, no requeue and no cold re-plan,
     the paged kernel's launches = layers x decode steps, the audit
     after the run; the swap path's ms, bytes, GB/s and crc32 share,
     the host's crc32 rate (in place and over a copy), the crash to the
     next decode step and device memory around the rebuild; (b) at CKPT_LAYERS layers, a serve killed after a
     checkpoint and resumed from disk equals the uninterrupted run;
 14. overload: (a) the QoS ladder at plan width SKETCH_BLOCKS, 12
     requests of 32 tokens through 8 slots, at LADDER_LAYERS of the 36
     layers (full width): with the ladder and no
     faults, with the ladder under ``ladder_spikes()`` (every request
     complete, no preemption, requeue or timeout, rungs down and up,
     every never-degraded request's stream equal to the fault-free
     run's, the per-slot planner's calls on two steps equal to the plain
     budget rank — a sort over bf16 scores, ties at the edge admitted —
     and the share of rung >= 1 rows above the budget reported), and
     without the ladder under the same spikes (load shed by host swap);
     (b) at RETIRE_LAYERS of the 36 layers (full width), phase 3's
     workload without retirement, then with retirement on (keep
     RETIRE_KEEP, watermark RETIRE_MARK) on a RETIRE_POOL-page pool:
     pages reclaimed mid-stream, after every pass and every step no
     layer's plan names a retired block and every hole maps page 0 on
     the card, ``check_invariants`` after the run, fewer deferred claims
     and steps than retirement off, and the never-firing twin equal to
     the run without retirement; the paged kernel's launches = layers x decode steps in
     every run, and held to its plain version on one recorded call of
     each (a row at rung >= 1; a table with holes);
 15. olmo-1b at full width (d_model 2048, 16 heads over 16 KV heads: G =
     1, the non-parametric norm), its 16 layers cut to OLMO_LAYERS = 6
     (for phase 25's time), phase 3's workload paged then
     contiguous: equal token streams, the kernel's launches = layers x
     steps;
 16. qwen3-moe-235b-a22b at full width (64 heads over 4 KV heads: G =
     16, 128 experts, top-8, d_ff 1536, group 128), its 94 layers cut to
     MOE_LAYERS = 8 (the weights fill ~42 GB), phase 3's workload paged then
     contiguous: equal token streams, launches = layers x steps, B1 on
     one recorded call within phase 2's limits, one recorded decode and
     one recorded prefill FFN call's expert ids and kept mask equal to
     the reference's one-hot form (``models.moe.moe_apply_ref``) and its
     output within MOE_TOL; the FFN's share of a step (CUDA events),
     prefill ms, capacity drops a step and peak memory;
 17. ``launch.train.train`` on full-width qwen3-moe-235b-a22b cut to the
     most layers whose weights, gradients and AdamW moments fit with
     HEADROOM to spare (``moe_train_layers``: 1), the SATA kernel route,
     batch 1, S = 4096, 3 steps: finite losses, grad norms and router
     aux losses, the compacted-grid kernel launched layers x steps x 2,
     the dense grid never, HEADROOM left; step s, tokens/s, peak memory;
 18. llama-3.2-vision-90b at full width (d_model 8192, 64 heads over 8
     KV heads, 1600 image tokens, a cross layer after every 4 self
     layers) cut to VLM_LAYERS = 25 (20 self, 5 cross), gates opened:
     16 requests of one prompt token, VLM_GEN (64) generated, through 8
     slots
     on the contiguous cache (the only vlm layout of the reference):
     every request complete, the contiguous kernel launched self layers
     x steps, one of its calls held to its plain version; then the
     reference's context-length gate (two paddings of one image context,
     VLM_GATE_STEPS greedy steps: bitwise equal logits with
     ``context_lengths``, different without); mean step, cross-attention
     ms a step (CUDA events), weights and peak memory;
 19. whisper-base at full width (6 + 6 layers, d_model 512, 8 heads over
     8 KV heads of 64: G = 1, D = 64, layernorm, GELU, 1500 frames): 16
     requests of one prompt token, WHISPER_GEN (192) generated, through
     8 slots,
     max_len 448 (7 pages of 64), paged then contiguous: equal token
     streams, each layout's kernel launched layers x steps, one B1 call
     at D = 64 held to its plain version; mean step, cross-attention ms a
     step and the encoder's ms;
 20. zamba2-2.7b at full width, depth cut to ZAMBA_LAYERS = 24 of its 54
     Mamba2 layers (for phases 25 and 27's time; d_model 2560, d_inner
     5120, 80 SSM heads x 64, state 64, conv 4; the shared decoder block
     after every 6, 4 applications, each with its own KV cache: 32 heads
     over 32 KV heads of 80, G = 1, D = 80): 8 requests of one prompt
     token, ZAMBA_GEN (256) generated, through 8 slots, max_len 512 (rows
     reach 4 pages), paged then contiguous: equal token streams, each
     layout's kernel launched 4 x steps, one B1 call at D = 80 held to
     its plain version; mean step, the 24 ``mamba2_decode`` calls' and
     the 4 shared blocks' ms a step (CUDA events), the fetch reduction,
     peak memory;
 21. rwkv6-1.6b at full width and depth (24 layers, d_model 2048, 32
     heads x 64, d_ff 7168, vocab 65536): 8 requests of one prompt
     token, RWKV_GEN (128) generated, through 8 slots on the contiguous
     layout (no KV cache): every request complete, every step's logits
     finite, no kernel of the port launched (the family has no
     attention); mean step and the time mix's ms a step (CUDA events);
 22. the paper's scheduler: (a) the four workloads of
     ``configs/workloads.py`` at their published sizes, seeds 0-2, masks
     made on the card by ``core.masks.synthetic_masks`` (k keys a row,
     equal to the CPU's from the same seed), the card's ``sort_keys`` ==
     ``sort_keys_psum`` head by head, ``coverage_ok`` on every schedule,
     the reference tests' gates on the modeled CIM numbers; the modeled
     gains beside the paper's and ``plan``'s host ms; (b) the
     quickstart's kernel step at qwen3-4b's heads: ``sata_attention`` in
     mask mode (BH 32, S 2048, D 128, blocks 128, bf16, KERNEL_TRACE
     masks) with and without the SATA sort on both grids: B3 and B4
     launched twice each, every output within TOL of
     ``sata_attention_reference``, the sorted route's recorded calls
     within phase 6's limits of their plain versions, B3 == B4 bitwise;
     block skip sorted vs unsorted, ``sata_block_plan``'s host ms; (c)
     ``launch.roofline.analyse_kernel`` at occupancy 0.25 / 0.5 / 0.75
     (into ``build/roofline``) and B4 / B3 in block mode on the same
     maps, timed as in phase 5, beside the modeled speedup;
 24. ``launch.mesh`` on MESH_RANKS (2) gloo ranks spawned on the one card
     (NCCL refuses two ranks of one communicator on one GPU), the
     kernels built in phase 1: (a) MESH_STEPS (3) carried
     ``tensor_parallel_decode_step``s at qwen3-4b's decode shape (B8 KV8
     G4 D128, max_len 4096, page 64, top-k 64, bf16), paged then
     contiguous: every step's output and plan leaves bitwise equal to the
     one-rank mesh's and to the plain single-device step's (whose kernel
     output is held to its plain version within phase 2's limits), paged
     == contiguous, each layout's kernel launched ranks x steps times (the
     counts read in each rank, summed), the other never; (b)
     ``sequence_sharded_attention`` at a qwen3-4b layer (BH 32, S 4096, D
     128, blocks 128, causal, k_sel 64, fp32): out, thresholds and block
     map bitwise equal to ``sequence_local_attention``'s, the per-shard
     fetches summing to the local count, every shard > 0; per-step ms a
     rank, the cache MB a rank copies a step, the attention's ms,
     host-staged MB and peak memory a rank;
 25. ``launch.train.train(mesh=)`` in phase 24's spawned world: full-width
     qwen3-4b cut to MESH_TRAIN_LAYERS = 2 layers, the SATA kernel route
     (B3 at D 128, blocks 128, remat full), batch 2, S 4096,
     MESH_TRAIN_STEPS = 2 steps, on the ("data", "model") meshes (2, 1)
     (FSDP: a rank holds half of every weight and takes one batch row)
     and (1, 2) (tensor parallel: a rank runs 16 of the 32 heads over 4
     of the 8 KV heads and half of d_ff, and half the vocabulary of the
     embedding, unembed and loss: its (B, S, V / 2) logits); and
     full-width qwen3-moe-235b-a22b cut to MESH_MOE_LAYERS = 1 layer
     (phase 17's depth), batch 1, S 4096, on (1, 2): a rank runs 64 of
     the 128 experts, 32 of 64 heads, half the vocabulary; and qwen3-4b
     again on (1, 2) with context parallelism on
     (``distributed.ctx.set_context_parallel`` under the ``seq_shard``
     specs): a rank runs all 32 heads on its 2,048 of the 4,096 rows
     against every key (B3 at Sq 2,048), the MLP, embedding and unembed
     in their regions entered through the sequence's all-gather, its
     attention weights (4 leaves a layer) gathered.  Each: losses
     and grad norms against the parent's one-device ``train`` of the
     same model and batches (MESH_TRAIN_RTOL, phase 8's 2e-3), B3
     launched layers x steps x 2 a rank (the counts read in each rank
     right after its ``train``, summed), B4 never, and the rank's first
     B3 call (recorded by ``FirstCall``: the rank's B x H / m rows) held
     to its plain version within phase 6's limits; every expert product
     on the rank's E / m experts and the logits V / m wide
     (``RegionProbe``), no leaf gathered over "model", and the tokens
     whose layer-0 top-k set at step 0 differs from one device's
     (reported); step s, peak
     memory and host-staged MB a rank (qwen3-4b's (1, 2) beside the
     gathered embedding's, TP_GATHERED), and the leaves kept sharded over
     "model".  Then full-width zamba2-2.7b cut to MESH_ZAMBA_LAYERS = 6
     layers (one application of the shared block), batch 1, S 4096, and
     full-width rwkv6-1.6b cut to MESH_RWKV_LAYERS = 2 layers, batch 1,
     S 1024 (its time scan is a per-position loop, replayed by the
     checkpoint: rwkv_chunk 256), in bf16 and in fp32 from the same
     weights (MESH_RWKV32), 2 steps each on one device (zamba2 and bf16
     rwkv6 a third step under ``torch.profiler``: device time by
     kernel) and on (1, 2): a rank runs 40 of zamba2's 80 ssm heads (B
     and C gathered after the conv, the gated norm's sum of squares
     summed) and 16 of its shared block's 32 heads on B3 at D 80, and
     16 of rwkv6's 32 heads and half its d_ff; losses and grad norms
     within MESH_TRAIN_RTOL of one device (rwkv6's grad norm after the
     first update within MESH_RWKV_TRAJ_RTOL: its trajectory is
     chaotic; bf16 rwkv6's step 0 within MESH_RWKV_BF16_RTOL, beside
     the witness: one device's bf16 step 0 against the fp32 run's),
     the leaves gathered over "model"
     (MESH_GATHERED: zamba2's ``shared_in``, nothing of rwkv6's), and B3
     launched the shared block's applications x steps a rank (outside
     the layers' remat: no recompute), never for rwkv6;
 26. the dry run (``launch.dryrun``): phase 7's training config at 1
     layer of full-width qwen3-4b, batch 1, S 4096, a train step and a
     prefill step, and the dry run's decode config at 1 layer, a serve
     step of DRYRUN_SLOTS (8) slots over a 4,096-token cache, each
     traced on meta tensors and run on the card (after a warm-up) under
     ``WorkCounter``: counted FLOPs, bytes and kernel calls equal
     exactly (the decode step's op count too), B3's (decode: the
     contiguous decode kernel's) launches equal its calls counted on
     meta; the predicted memory (arguments + the meta run's live
     peak) beside the card's peak, the card's step ms beside the
     roofline's modeled max(compute, memory); then, in subprocesses
     that see no card, ``python -m repro_torch.launch.roofline`` on
     DRYRUN_CELLS (qwen3-4b and qwen3-moe-235b-a22b at train_4k,
     qwen3-4b at decode_32k over the key split, rank 0 of the fake 16x16
     world at full depth): each probe's arguments,
     temp, FLOPs and collective bytes by kind, the three terms, the
     dominant one, host seconds.  These terms are modeled on the host
     at the H100's data-sheet peaks: no card runs them;
 27. ``train.step.make_serve_step(mesh=)`` in phase 24's spawned world,
     with the weights in "infer_tp" mode: full-width qwen3-4b cut to
     MESH_SERVE_LAYERS = 4 layers, 8 slots of max_len 4096 whose caches
     the parent filled on one device (``prefill_prompt`` /
     ``install_prefill`` of MESH_SERVE_PROMPTS, 64-2,048 tokens) and
     saved, each rank loading and keeping its blocks
     (``ShardLayout.block_cache``: 4 of the 8 KV heads), 8
     teacher-forced steps on (1, 2) fed one device's greedy tokens,
     paged and contiguous; then zamba2-2.7b (6 layers: 40 of 80 ssm
     heads, 16 of the shared block's 32 heads), rwkv6-1.6b (2 layers,
     contiguous) and qwen3-moe-235b-a22b (1 layer: 64 of 128 experts, 2
     of 4 KV heads), 4 steps each after 8 one-device steps from an
     empty cache, max_len 512.  Every run again in fp32 from the same
     weights (contiguous), qwen3-4b in bf16 with dense attention (no
     top-k selection), and qwen3-moe 2 steps on (2, 1) (MESH_SERVE_SPLIT:
     4 slots a data rank, fewer than its group, so the rank routes the
     gathered batch).  Each against one device's ``serve_step`` on the
     same cache: fp32 and the (2, 1) run within ROUTE_RTOL, rwkv6 within
     MESH_SERVE_RWKV_RTOL (C14) in bf16 and fp32, the other bf16 runs
     printed beside the witness (one device's bf16 logits against its
     fp32 twin's), argmax agreement reported, layer 0's plan rows after
     the first step equal, the decode kernel launched layers x steps a
     rank (the counts read in each rank, summed; none with dense
     attention), paged == contiguous bitwise on each rank; ms a step,
     host-staged MB and peak memory a rank.  These jobs run the head
     layout (``CACHE_SEQ_SHARD`` False in the ranks).  Then the
     context-parallel job (MESH_CP_RUNS, ``CACHE_SEQ_SHARD`` on: each
     rank holds its 2,048 of every slot's 4,096 keys): qwen3-4b, 4
     layers, 8 slots, contiguous, prompts MESH_CP_PROMPTS (keys on both
     ranks, a slot crossing the 2,048 boundary), 8 steps in bf16 and in
     fp32 from the same weights, and zamba2-2.7b (one shared block,
     ``shared_kv``) 4 steps in fp32, each against one device's
     ``serve_step`` (``mesh_cp_check``): fp32 within ROUTE_RTOL, bf16
     printed beside the witness, both ranks' logits bitwise equal, the
     contiguous kernel launched (in its partial mode) layers x steps a
     rank; the keys each step's thresholds admit on each rank (the
     contiguous split's imbalance), the rank's self-attention cache MB
     against the head layout's, ms a step, host-staged MB, peak memory.

The last stdout line is ``{"ok": true, "device": {...}}``; the line before
it is the ``kernels`` JSON, and the card's name and power limit are
printed on a line of their own before that.
"""
from __future__ import annotations

import contextlib
import dataclasses
import itertools
import json
import os
import subprocess
import sys
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12          # H100 SXM, NVIDIA data sheet
BF16_FLOPS_PER_S = 989e12
FP32_FLOPS_PER_S = 67e12
# max abs error against the plain version.  bf16 outputs are also held to
# the plain version's bits (the decode kernel's: the plain model of its
# split over a cluster, ``held_to_plain``): the kernel differs from it only
# in fp32 summation order, which flips the rounding of ~0.1% of the
# outputs, while an fp32 selection predicate or a missing bf16 rounding of
# p moves 25% or more of them (a 2e-2 max-abs limit alone lets the second
# pass).
TOL = {"float32": 1e-5, "bfloat16": 2e-2}
BF16_MISMATCH_MAX = 0.01    # share of bf16 outputs off the plain version
SRC_CU = "src/repro_torch/kernels/csrc/sata_decode.cu"
SRC_ATTN_CU = "src/repro_torch/kernels/csrc/sata_attention.cu"
REPLACES = {"paged": "src/repro/kernels/sata_decode.py:168",
            "contiguous": "src/repro/kernels/sata_decode.py:97",
            "compact": "src/repro/kernels/sata_attention.py:260",
            "dense": "src/repro/kernels/sata_attention.py:117"}
# phase 8, kernel route vs _attend.  The routes round p to bf16 at
# different points (per tile after the running max vs once after the full
# softmax) and sum in different orders, which moves each bf16 attention
# output by about one rounding step (2^-9 relative, uniform), so layer 0's
# attention output differs by ~2^-8 in relative Frobenius norm
# (ROUTE_ATTN_RTOL allows 2.5x that), and the loss and the grad norm,
# means over millions of such outputs, by far less (ROUTE_RTOL).
ROUTE_RTOL = 2e-3
ROUTE_ATTN_RTOL = 1e-2


def log(*a):
    print(*a, flush=True)


class PhaseClock:
    """Host seconds per phase, printed as each phase ends."""

    def __init__(self):
        self.t0 = self.t = time.time()

    def done(self, phase):
        now = time.time()
        log(f"[phase] {phase}: {now - self.t:.1f} s")
        self.t = now

    def total(self):
        log(f"[phase] all phases: {time.time() - self.t0:.1f} s")


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# inputs
# ---------------------------------------------------------------------------

def make_case(torch, *, b, kv, g, d, page, s, dtype, seed, device,
              pos_lo=1, pos_hi=None, topk=64, key_at_pos=False):
    """Random cache + the planner's own plan (``full_replan``) for it,
    the pool laid out through a shuffled page table.  ``key_at_pos``
    makes each row's key at pos 3·q of its first head, so that head
    selects it."""
    from repro_torch.core.decode_plan import full_replan
    rng = np.random.default_rng(seed)
    nkb = s // page
    q = torch.tensor(rng.standard_normal((b, kv, g, d)), dtype=dtype,
                     device=device)
    k = torch.tensor(rng.standard_normal((b, s, kv, d)), dtype=dtype,
                     device=device)
    v = torch.tensor(rng.standard_normal((b, s, kv, d)), dtype=dtype,
                     device=device)
    pos = torch.tensor(rng.integers(pos_lo, pos_hi or s, b),
                       dtype=torch.int32, device=device)
    if key_at_pos:
        k[torch.arange(b, device=device), pos.long()] = 3 * q[:, :, 0]
    idx, cnt, thr = full_replan(q, k, pos, topk_k=topk, k_block=page,
                                plan_blocks=nkb)
    n_pages = b * nkb + 1
    perm = rng.permutation(np.arange(1, n_pages))
    table = torch.tensor(perm.reshape(b, nkb), dtype=torch.int32,
                         device=device)
    kp = torch.zeros((n_pages, page, kv, d), dtype=dtype, device=device)
    vp = torch.zeros_like(kp)
    kp[table.long()] = k.reshape(b, nkb, page, kv, d)
    vp[table.long()] = v.reshape(b, nkb, page, kv, d)
    return dict(q=q, k=k, v=v, kp=kp, vp=vp, table=table, idx=idx,
                cnt=cnt, thr=thr, pos=pos, page=page)


def run_kernel(sd, c, paged):
    if paged:
        return sd.sata_decode_attention_paged_kernel(
            c["q"], c["kp"], c["vp"], c["table"], c["idx"], c["cnt"],
            c["thr"], c["pos"])
    return sd.sata_decode_attention_kernel(
        c["q"], c["k"], c["v"], c["idx"], c["cnt"], c["thr"], c["pos"],
        k_block=c["page"])


def run_plain(sd, c, paged, splits=1):
    if paged:
        return sd.sata_decode_attention_ref(
            c["q"], c["kp"], c["vp"], c["idx"], c["cnt"], c["thr"],
            c["pos"], k_block=c["page"], page_table=c["table"],
            splits=splits)
    return sd.sata_decode_attention_ref(
        c["q"], c["k"], c["v"], c["idx"], c["cnt"], c["thr"], c["pos"],
        k_block=c["page"], splits=splits)


def kernel_splits(sd, q, k_block):
    """The cluster the kernel splits each row of q over (its shape's
    ``launch_config``): the plain version's ``splits`` that models it."""
    return sd.launch_config(q.shape[2], q.shape[3], k_block,
                            q.dtype).cluster


def held_to_plain(torch, sd, got, args, kw, what):
    """A decode kernel output ``got`` against the plain version on the
    same arguments (unsplit: within TOL) and against the plain model of
    the kernel's split (within TOL, and bf16 at most BF16_MISMATCH_MAX
    of the outputs off its bits: the kernel sums in another fp32 order,
    while a split rounds p against each share's own running max, which
    moves ~15% of the bf16 outputs off the unsplit version's bits).
    Returns (error against the unsplit version, against the model, the
    share of outputs off the model's bits)."""
    tol = TOL[str(got.dtype).split(".")[-1]]
    splits = kernel_splits(sd, args[0], kw["k_block"])
    want = sd.sata_decode_attention_ref(*args, **kw)
    model = want if splits == 1 else sd.sata_decode_attention_ref(
        *args, splits=splits, **kw)
    errs = [float((got.float() - w.float()).abs().max()) if got.numel()
            else 0.0 for w in (want, model)]
    off = float((got != model).float().mean()) if got.numel() else 0.0
    assert max(errs) <= tol, f"{what}: {errs} > {tol}"
    if got.dtype == torch.bfloat16:
        assert off <= BF16_MISMATCH_MAX, f"{what}: {off:.4%} off"
    return errs[0], errs[1], off


def check_case(torch, sd, name, c):
    """Kernel vs plain (and the plain model of its split) in both layouts
    + paged == contiguous bitwise.  Returns the largest kernel-vs-plain
    error."""
    tol = TOL[str(c["q"].dtype).split(".")[-1]]
    outs = {}
    err = 0.0
    for paged in (False, True):
        got = run_kernel(sd, c, paged)
        torch.cuda.synchronize()
        assert got.shape == c["q"].shape, got.shape
        assert torch.isfinite(got).all(), f"{name}: non-finite output"
        lay = "paged" if paged else "contiguous"
        kk, vv = (c["kp"], c["vp"]) if paged else (c["k"], c["v"])
        e, e_model, off = held_to_plain(
            torch, sd, got, (c["q"], kk, vv, c["idx"], c["cnt"], c["thr"],
                             c["pos"]),
            dict(k_block=c["page"], page_table=c["table"] if paged else None),
            f"{name} {lay}")
        log(f"[kernel] {name} {lay}: max_abs_err={e:.3e} (tol {tol:g}), "
            f"{e_model:.3e} against the model of its "
            f"{kernel_splits(sd, c['q'], c['page'])}-way split, {off:.4%} "
            f"of outputs off the model's bits")
        err = max(err, e)
        outs[paged] = got
    assert torch.equal(outs[False], outs[True]), \
        f"{name}: paged != contiguous (must be bitwise equal)"
    return err


def edge_cases(torch, device):
    """Small shapes covering G in 1..8 and 12, D in {9, 16, 20, 24, 64,
    128} (every copy width), pages of 8..128 rows, fp32 and bf16, P == 0,
    count-0 rows, padding slots past the count, and pos inside a page
    with the key at pos selected."""
    f32, bf16 = torch.float32, torch.bfloat16
    specs = [  # (b, kv, g, d, page, s, dtype)
        (3, 2, 1, 16, 8, 64, f32),
        (2, 4, 2, 64, 16, 256, f32),
        (2, 2, 4, 128, 32, 512, f32),
        (2, 2, 8, 128, 128, 1024, bf16),
        (3, 2, 4, 64, 64, 512, bf16),
        # odd widths: 16-byte copies into padded rows, then 8-, 4- and
        # 2-byte copies; G padded to a power of two; a page of 1.5 chunks
        (2, 2, 3, 24, 16, 128, bf16),
        (2, 2, 3, 20, 16, 128, bf16),
        (2, 2, 5, 9, 8, 64, f32),
        (2, 1, 3, 9, 8, 64, bf16),
        (2, 2, 4, 128, 48, 480, bf16),
        # G past 8 and not a power of two: two PV head groups of 8, heads
        # 12..15 padding
        (2, 2, 12, 64, 16, 256, bf16),
        (2, 2, 12, 128, 64, 512, f32),
    ]
    for n, (b, kv, g, d, page, s, dt) in enumerate(specs):
        c = make_case(torch, b=b, kv=kv, g=g, d=d, page=page, s=s, dtype=dt,
                      seed=100 + n, device=device, topk=8)
        # count-0 rows, and padding slots past a shortened count
        c["cnt"] = c["cnt"].clone()
        c["cnt"][0, 0] = 0
        c["cnt"][-1, -1] = torch.clamp(c["cnt"][-1, -1] - 1, min=0)
        yield f"G{g}_D{d}_page{page}_{str(dt).split('.')[-1]}", c
    # pos inside a page, its key selected: the token <= pos test decides
    for dt in (f32, bf16):
        yield f"pos_inside_page_{str(dt).split('.')[-1]}", make_case(
            torch, b=4, kv=2, g=2, d=64, page=16, s=256, dtype=dt, seed=8,
            device=device, topk=8, key_at_pos=True)
    c = make_case(torch, b=2, kv=2, g=2, d=16, page=8, s=64, dtype=f32,
                  seed=7, device=device, topk=4)
    c["idx"] = c["idx"][..., :0].contiguous()                  # P == 0
    yield "P0", c
    yield from split_cases(torch, device)


def split_cases(torch, device):
    """The shares of a row split over a cluster (G 16, D 128, page 64)
    that may be empty: row (0, 0) has count 0; (0, 1) one entry and
    (1, 0) three, fewer than the cluster's ranks; (1, 1) plans four
    pages of which only the third holds keys <= pos, so every admitted
    key lies in one rank's share and the others admit none."""
    for n, dt in enumerate((torch.bfloat16, torch.float32)):
        c = make_case(torch, b=2, kv=2, g=16, d=128, page=64, s=1024,
                      dtype=dt, seed=10 + n, device=device, pos_lo=100,
                      pos_hi=128, topk=16)
        idx, cnt = c["idx"].clone(), c["cnt"].clone()
        cnt[0, 0], cnt[0, 1], cnt[1, 0] = 0, 1, min(3, int(cnt[1, 0]))
        idx[1, 1, :4] = torch.tensor([5, 6, 0, 7], dtype=idx.dtype)
        cnt[1, 1] = 4
        c.update(idx=idx, cnt=cnt)
        yield f"split_shares_G16_D128_{str(dt).split('.')[-1]}", c


def build_all(build, root, names=("sata_decode", "sata_attention")):
    """One nvcc per kernel source, all started together; prints each
    build's seconds and ptxas's registers and spills."""
    from concurrent.futures import ThreadPoolExecutor

    def timed(name):
        t = time.time()
        return build.build(name), time.time() - t

    with ThreadPoolExecutor(len(names)) as ex:
        libs = dict(zip(names, ex.map(timed, names)))
    for name, (lib, secs) in libs.items():
        log(f"[build] nvcc {name}.cu -> {os.path.relpath(lib, root)} in "
            f"{secs:.2f} s")
        ptxas = lib.parent / f"{lib.stem}.ptxas.txt"
        if ptxas.exists():
            for line in ptxas_lines(ptxas.read_text(), ""):
                log(f"[build] ptxas {name}: {line}")


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------

SLEEP_CYCLES = 50_000_000     # ~25-30 ms of an H100's SM clock


def time_ms(torch, fn, reps=30, warm=3):
    """Median ms of ``reps`` runs, each timed with CUDA events and
    preceded by a 256 MB write that evicts the 50 MB L2 (the serving
    loop reaches each layer's K/V cold).  The device first sleeps while
    the host queues every run, so the events time the device's work,
    not the host's launch path between them (a function that syncs
    inside still shows its host time)."""
    flush = torch.empty(64 * 2 ** 20, dtype=torch.float32, device="cuda")
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    evs = [(torch.cuda.Event(enable_timing=True),
            torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    torch.cuda._sleep(SLEEP_CYCLES)
    for a, z in evs:
        flush.zero_()
        a.record()
        fn()
        z.record()
    torch.cuda.synchronize()
    return float(np.median([a.elapsed_time(z) for a, z in evs]))


def wall_ms(torch, fn, reps=20, warm=3):
    """Median host-clock ms of ``reps`` synchronized runs: the time an
    eager chain of small operations takes in the serving loop, where
    the host's launch path, not the device, sets the pace."""
    for _ in range(warm):
        fn()
    ts = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ts.append(1e3 * (time.perf_counter() - t))
    return float(np.median(ts))


def device_ms(e):
    """A profiler row's own device time in ms."""
    us = getattr(e, "self_device_time_total", None)
    if us is None:
        us = getattr(e, "self_cuda_time_total", 0)
    return us / 1e3


def profiled_ms(torch, fn, kernel, reps=30, warm=3):
    """``time_ms`` under ``torch.profiler``: the event median and the
    mean device time of the kernels whose name holds ``kernel``.  Fails
    if anything but those kernels and the timing's own (the L2 flushes
    and one sleep) ran on the device, i.e. if the wrapper launched
    anything beside its kernel.  Returns (event ms, device ms or None
    when the profiler saw no device time)."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warm):               # outside the trace: a later
        fn()                            # trace may drop its first events
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        ms = time_ms(torch, fn, reps=reps, warm=0)
    cuda = torch.autograd.DeviceType.CUDA
    evs = [e for e in prof.key_averages()
           if getattr(e, "device_type", None) == cuda and device_ms(e) > 0]
    ours = [e for e in evs if kernel in e.key]
    if not ours:
        log(f"[profile] no device time for {kernel} (rows: "
            f"{[e.key[:60] for e in evs]})")
        return ms, None
    n = sum(e.count for e in ours)
    others = {e.key[:70]: e.count for e in evs if kernel not in e.key}
    assert n == reps, f"{kernel}: {n} launches, {reps} calls"
    assert sum(others.values()) <= reps + 1, \
        f"other kernels in the window: {others}"
    return ms, sum(device_ms(e) for e in ours) / n


def selection(torch, c):
    """The keys the output depends on, over the dense cache: ``scored``
    (B, KV, S), tokens <= pos in the row's planned blocks, and
    ``selected`` (B, KV, G, S), those with bf16(s) >= bf16(thr)."""
    from repro_torch.core.blockmap import bisect_select
    q, k = c["q"], c["k"]
    b, kv, g, d = q.shape
    s = k.shape[1]
    page = c["page"]
    sc = torch.einsum("bkgd,bskd->bkgs", q.float(), k.float()) / np.sqrt(d)
    tok = torch.arange(s, device=q.device)
    live = (torch.arange(c["idx"].shape[-1], device=q.device)
            < c["cnt"][..., None]).to(torch.int32)
    # padding slots repeat a live index: reduce, never overwrite
    planned = torch.zeros((b, kv, s // page), dtype=torch.int32,
                          device=q.device).scatter_reduce_(
        2, c["idx"].long(), live, reduce="amax").bool()
    scored = (planned.repeat_interleave(page, dim=2)
              & (tok <= c["pos"][:, None])[:, None])
    return scored, bisect_select(sc, c["thr"]) & scored[:, :, None]


def kernel_bound(torch, c, paged):
    """Least time for the function's work on an H100: the larger of the
    bytes it must move over 3.35 TB/s and its flops over the peak for the
    input type.  Bytes: the K rows it must score (tokens <= pos in the
    planned blocks), the V rows that at least one of the G heads selects,
    q, out and the plan, each once.  Flops: QK^T for every scored key and
    head, PV for every selected (head, key)."""
    q = c["q"]
    es = q.element_size()
    b, kv, g, d = q.shape
    scored, selected = selection(torch, c)
    k_rows = int(scored.sum())
    v_rows = int(selected.any(dim=2).sum())
    nbytes = ((k_rows + v_rows) * d * es + 2 * q.numel() * es
              + c["thr"].numel() * 4 + c["idx"].numel() * 4
              + c["cnt"].numel() * 4 + c["pos"].numel() * 4
              + (c["table"].numel() * 4 if paged else 0))
    flops = 2 * d * (g * k_rows + int(selected.sum()))
    peak = BF16_FLOPS_PER_S if es == 2 else FP32_FLOPS_PER_S
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations", k_rows, v_rows)


def sdpa_inputs(torch, c):
    """Dense-cache SDPA inputs with the kernel's selection as a boolean
    mask: planned blocks AND bf16(s) >= bf16(thr) AND token <= pos."""
    q, k, v = c["q"], c["k"], c["v"]
    b, kv, g, d = q.shape
    _, mask = selection(torch, c)
    qh = q.reshape(b, kv * g, 1, d)
    kh = k.permute(0, 2, 1, 3).contiguous()               # (B, KV, S, D)
    vh = v.permute(0, 2, 1, 3).contiguous()
    return qh, kh, vh, mask.reshape(b, kv * g, 1, k.shape[1])


def aliased_case(torch, dev):
    """The main shape with the page tables the shared-prefix cache makes:
    slots 0 and 1 map the same physical pages at logical pages 0-15 (a
    shared prefix) and slot 2 maps one physical page at logical pages 4
    and 5.  The contiguous cache is the pool's logical view through
    these tables, and the plan is the planner's for it."""
    from repro_torch.core.decode_plan import full_replan
    from repro_torch.core.paging import logical_kv_view
    c = make_case(torch, b=8, kv=8, g=4, d=128, page=64, s=4096,
                  dtype=torch.bfloat16, seed=3, device=dev, pos_lo=1024,
                  pos_hi=1088)
    tbl = c["table"].clone()
    tbl[1, :16] = tbl[0, :16]
    tbl[2, 5] = tbl[2, 4]
    k, v = logical_kv_view(c["kp"], tbl), logical_kv_view(c["vp"], tbl)
    idx, cnt, thr = full_replan(c["q"], k, c["pos"], topk_k=64, k_block=64,
                                plan_blocks=64)
    shared = (idx[:2, :, :, None] == torch.arange(16, device=dev))
    live = torch.arange(64, device=dev)[None, None, :] < cnt[:2, :, None]
    assert bool((shared.any(-1) & live).any(-1).all()), \
        "slots 0 and 1 must both plan pages of the shared prefix"
    c.update(table=tbl, k=k, v=v, idx=idx, cnt=cnt, thr=thr)
    return c


MAIN = "main_B8_KV8_G4_D128_page64_bf16"
# qwen3-moe-235b-a22b's serving shape: 64 query heads over 4 KV heads
G16 = "moe_B8_KV4_G16_D128_page64_bf16"
G16_FP32 = G16.removesuffix("bf16") + "fp32"
# whisper-base's serving shape: 8 heads over 8 KV heads of 64 (G = 1,
# D = 64), a 448-token decoder context in 7 pages of 64
D64 = "whisper_B8_KV8_G1_D64_page64_bf16"
# zamba2-2.7b's shared block: 32 heads over 32 KV heads of 2560 / 32 =
# 80 (G = 1, D = 80: 10 column vectors of 16 bytes, K rows of 160 bytes,
# five k-steps of 16), phase 20's 512-token context in 8 pages of 64
D80 = "zamba2_B8_KV32_G1_D80_page64_bf16"


def kernel_cases(torch, dev):
    """Phase 2's inputs: the main-path shape, the main shape over aliased
    page tables, the moe serving shape (G = 16), whisper-base's (G = 1,
    D = 64) and zamba2-2.7b's (G = 1, D = 80) in bf16 and fp32, then the
    edge cases."""
    yield MAIN, make_case(
        torch, b=8, kv=8, g=4, d=128, page=64, s=4096, dtype=torch.bfloat16,
        seed=0, device=dev, pos_lo=1024, pos_hi=1088)
    yield "aliased_pages_B8_KV8_G4_D128_page64_bf16", aliased_case(torch,
                                                                   dev)
    for dt, suffix in ((torch.bfloat16, "bf16"), (torch.float32, "fp32")):
        yield G16.removesuffix("bf16") + suffix, make_case(
            torch, b=8, kv=4, g=16, d=128, page=64, s=4096, dtype=dt,
            seed=4, device=dev, pos_lo=1024, pos_hi=1088)
    for dt, suffix in ((torch.bfloat16, "bf16"), (torch.float32, "fp32")):
        yield D64.removesuffix("bf16") + suffix, make_case(
            torch, b=8, kv=8, g=1, d=64, page=64, s=448, dtype=dt, seed=5,
            device=dev, pos_lo=256, pos_hi=384)
    for dt, suffix in ((torch.bfloat16, "bf16"), (torch.float32, "fp32")):
        yield D80.removesuffix("bf16") + suffix, make_case(
            torch, b=8, kv=32, g=1, d=80, page=64, s=512, dtype=dt, seed=6,
            device=dev, pos_lo=192, pos_hi=256)
    yield from edge_cases(torch, dev)


def check_refusal(torch, sd, dev):
    """A G with no kernel layout (17: past the 16 heads a row's layout
    holds) must raise before launching, naming G, D and k_block."""
    c = make_case(torch, b=1, kv=1, g=17, d=128, page=64, s=256,
                  dtype=torch.bfloat16, seed=9, device=dev, topk=8)
    for paged in (True, False):
        fn = sd.sata_decode_attention_paged_kernel if paged \
            else sd.sata_decode_attention_kernel
        before = fn.launches
        try:
            run_kernel(sd, c, paged)
        except ValueError as e:
            assert "G=17, D=128, k_block=64" in str(e), e
            msg = str(e)
        else:
            raise AssertionError("the kernel took G = 17")
        assert fn.launches == before, "a refused shape counted a launch"
    log(f"[kernel] G=17 refused before launch: {msg}")


def check_kernels(torch, sd, dev):
    """Phase 2: the kernel against its plain version on every case, and
    the refusal of a shape no layout fits.  Returns the main-path, the
    G = 16, the D = 64 and the D = 80 bf16 cases and the errors."""
    errs, keep = {}, {}
    for cname, c in kernel_cases(torch, dev):
        if cname in (MAIN, G16, G16_FP32, D64, D80):
            keep[cname] = c
            log(f"[kernel] {cname} plan: kv_counts mean "
                f"{float(c['cnt'].float().mean()):.2f} of "
                f"{c['idx'].shape[-1]} pages, pos {c['pos'].tolist()}")
        errs[cname] = check_case(torch, sd, cname, c)
    check_refusal(torch, sd, dev)
    return keep, errs


def check_partial(torch, sd, name, c, tag):
    """Phase 5: the decode kernel's partial mode (context-parallel
    decode: the fp32 output unrounded and each head's lse) against its
    plain version on a phase 2 case, contiguous, with one more row's
    count set to 0 (its lse must be −inf, its output 0), within TOL of
    the case's dtype (lse over its finite entries, the −inf ones equal),
    against the unsplit version and the model of the kernel's split;
    the partial combined alone (``KeySplit.combine`` on one rank) rounds
    to the default mode's bits; both modes timed.  Returns the largest
    error."""
    from repro_torch.distributed.sharding import KeySplit
    from repro_torch.launch.mesh import make_local_mesh
    cnt = c["cnt"].clone()
    cnt[-1, 0] = 0
    args = (c["q"], c["k"], c["v"], c["idx"], cnt, c["thr"], c["pos"])
    out, lse = sd.sata_decode_attention_kernel(*args, k_block=c["page"],
                                               partial=True)
    whole = sd.sata_decode_attention_kernel(*args, k_block=c["page"])
    one = KeySplit(make_local_mesh(device=c["q"].device)).combine(out, lse)
    torch.cuda.synchronize()
    tol = TOL[str(c["q"].dtype).split(".")[-1]]
    assert out.dtype == lse.dtype == torch.float32
    e_out = e_lse = 0.0
    for splits in {1, kernel_splits(sd, c["q"], c["page"])}:
        p_out, p_lse = sd.sata_decode_attention_ref(
            *args, k_block=c["page"], partial=True, splits=splits)
        dead = torch.isneginf(p_lse)
        assert torch.equal(torch.isneginf(lse), dead), f"{name}: −inf rows"
        assert bool(dead[-1, 0].all()) and bool((out[-1, 0] == 0).all()), \
            f"{name}: the count-0 row"
        e_out = max(e_out, float((out - p_out).abs().max()))
        e_lse = max(e_lse, float((lse - p_lse)[~dead].abs().max()))
    assert e_out <= tol and e_lse <= tol, (name, e_out, e_lse, tol)
    assert torch.equal(one.to(whole.dtype), whole), \
        f"{name}: one partial combined != the default mode's output"
    ms = time_ms(torch, lambda: sd.sata_decode_attention_kernel(
        *args, k_block=c["page"], partial=True))
    ms0 = time_ms(torch, lambda: sd.sata_decode_attention_kernel(
        *args, k_block=c["page"]))
    log(f"[kernel] {name} partial mode (contiguous): out max_abs_err "
        f"{e_out:.3e}, lse {e_lse:.3e} (tol {tol:g}); "
        f"{int(dead.sum())} (row, head) lse -inf, the count-0 row's among "
        f"them, out 0; combined alone == the default mode bitwise; "
        f"{ms:.4f} ms against the default mode's {ms0:.4f} (CUDA events) "
        f"{tag}")
    return max(e_out, e_lse)


def extra_decode_cases(torch, dev):
    """Phase 5's other shapes: one slot (B1: 8 rows, one block each on
    132 SMs) and a long row (pos ~4000 of 4096, ~63 planned pages)."""
    yield "B1_KV8_G4_D128_page64_bf16", make_case(
        torch, b=1, kv=8, g=4, d=128, page=64, s=4096, dtype=torch.bfloat16,
        seed=1, device=dev, pos_lo=1024, pos_hi=1088)
    yield "long_B8_KV8_G4_D128_page64_bf16_pos4000", make_case(
        torch, b=8, kv=8, g=4, d=128, page=64, s=4096, dtype=torch.bfloat16,
        seed=2, device=dev, pos_lo=3968, pos_hi=4032)


def time_decode(torch, sd, c, label, paged, tag):
    """The decode kernel on case ``c``: CUDA-event median and the
    profiler's device time over the same calls, the plain version, SDPA
    over the dense cache with the same mask, and the bound.  Returns
    the ``kernels`` row's timing fields."""
    layout = "paged" if paged else "contiguous"
    ms, dev_ms = profiled_ms(torch, lambda: run_kernel(sd, c, paged),
                             "sata_decode_kernel")
    plain_ms = time_ms(torch, lambda: run_plain(sd, c, paged), reps=20)
    qh, kh, vh, mask = sdpa_inputs(torch, c)
    lib_ms = time_ms(torch, lambda: torch.nn.functional
                     .scaled_dot_product_attention(
                         qh, kh, vh, attn_mask=mask, enable_gqa=True))
    del qh, kh, vh, mask
    bound_ms, bound_by, k_rows, v_rows = kernel_bound(torch, c, paged)
    dev_txt = "not measured" if dev_ms is None else f"{dev_ms:.4f} ms"
    log(f"[timing] decode kernel ({layout}) {label}, "
        f"{int(c['cnt'].sum())} planned pages, {k_rows} K rows scored, "
        f"{v_rows} V rows selected: kernel {ms:.4f} ms (profiler device "
        f"time {dev_txt}), bound {bound_ms:.4f} ms ({bound_by}), "
        f"{100 * bound_ms / ms:.1f}% of it; plain {plain_ms:.4f} ms, "
        f"SDPA+mask {lib_ms:.4f} ms {tag}")
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=lib_ms)


# ---------------------------------------------------------------------------
# SATA prefill kernels (compacted grid B3, dense grid B4)
# ---------------------------------------------------------------------------

def attn_case(torch, *, bh, s, d, qb, kb, dtype, mode, causal, seed, device,
              topk=8):
    """Random q/k/v and a plan for one kernel mode: ``threshold`` (the
    chunked planner's own thresholds and block map), ``mask`` (a random
    element mask with empty rows, and its tile occupancy) or ``block``
    (a random block map).  ``idx``/``cnt`` are the full compact plan of
    ``bm``; ``cut`` adds count-0 rows and padding slots past a
    shortened count."""
    from repro_torch.core.blockmap import block_occupancy, compact_kv_plan
    from repro_torch.core.selection import select_thresholds_chunked
    g = torch.Generator(device="cpu").manual_seed(seed)
    q, k, v = (torch.randn((bh, s, d), generator=g).to(device=device,
                                                       dtype=dtype)
               for _ in range(3))
    pos = torch.arange(s, dtype=torch.int32, device=device)[None, :, None] \
        .expand(bh, s, 1)
    c = dict(q=q, k=k, v=v, qb=qb, kb=kb, mode=mode, causal=causal,
             sel={})
    if mode == "threshold":
        thr, bm = select_thresholds_chunked(
            q, k, topk, causal=causal, chunk=min(1024, s), q_block=qb,
            k_block=kb)
        c["sel"]["thresholds"] = thr
    elif mode == "mask":
        mask = torch.rand((bh, s, s), generator=g) < 0.1
        mask[0, : min(qb, s) // 2] = False               # rows with no key
        mask = mask.to(device)
        bm = block_occupancy(mask, qb, kb)
        c["sel"]["mask"] = mask
    else:
        bm = (torch.rand((bh, s // qb, s // kb), generator=g) < 0.5).to(
            device)
    if causal and mode != "mask":
        c["sel"].update(causal=True, q_pos=pos, k_pos=pos)
    c["bm"] = bm
    c["idx"], c["cnt"] = compact_kv_plan(bm)
    return c


def run_attn(sa, c, *, plain, dense_grid=False, idx=None, cnt=None,
             admitted=None):
    """B3 (or, ``dense_grid``, B4) on case ``c``: the kernel or its plain
    version."""
    kw = dict(q_block=c["qb"], k_block=c["kb"], admitted=admitted)
    if dense_grid:
        fn = sa.sata_block_attention_ref if plain else sa.sata_block_attention
        return fn(c["q"], c["k"], c["v"], c["bm"], mask=c["sel"].get("mask"),
                  **kw)
    fn = sa.sata_block_attention_compact_ref if plain \
        else sa.sata_block_attention_compact
    return fn(c["q"], c["k"], c["v"], c["idx"] if idx is None else idx,
              c["cnt"] if cnt is None else cnt, **c["sel"], **kw)


def compare(torch, name, got, want, adm_got=None, adm_want=None,
            window=None):
    """Kernel vs plain: max abs error within TOL, bf16 outputs within
    BF16_MISMATCH_MAX of the plain version's bits, and admitted-key counts
    per row equal to the plain version's or, given ``window`` (lo, hi)
    from ``admitted_window``, inside it, with the rows whose count
    differs from the plain one reported.  Returns the max abs error."""
    tol = TOL[str(want.dtype).split(".")[-1]]
    assert got.shape == want.shape, (name, got.shape, want.shape)
    assert torch.isfinite(got).all(), f"{name}: non-finite output"
    e = float((got.float() - want.float()).abs().max()) if got.numel() \
        else 0.0
    off = float((got != want).float().mean()) if got.numel() else 0.0
    adm = "" if adm_got is None else \
        f", admitted keys {int(adm_got.sum())} vs {int(adm_want.sum())}"
    log(f"[attn-kernel] {name}: max_abs_err={e:.3e} (tol {tol:g}), "
        f"{off:.4%} of outputs off the plain version's bits{adm}")
    differ = outside = 0
    if adm_got is not None:
        differ = int((adm_got != adm_want).sum())
        if window is not None:
            lo, hi = window
            outside = int(((adm_got < lo) | (adm_got > hi)).sum())
            log(f"[attn-kernel] {name}: admitted keys inside the window in "
                f"every row: {outside == 0} ({outside} rows outside; {differ} "
                f"of {adm_got.numel()} rows differ from the plain count; "
                f"window lo < hi in {int((lo != hi).sum())} rows)")
    assert e <= tol, f"{name}: {e} > {tol}"
    if got.dtype == torch.bfloat16:
        assert off <= BF16_MISMATCH_MAX, f"{name}: {off:.4%} off"
    if window is None:
        assert differ == 0, \
            f"{name}: admitted-key counts differ in {differ} rows"
    assert outside == 0, f"{name}: {outside} rows outside the window"
    return e


def attn_window(torch, sa, c, cnt=None):
    """``admitted_window`` of case ``c`` where the kernel sums each score
    in the tensor cores' order (bf16 threshold mode), else None: the
    counts must then equal the plain version's."""
    if c["mode"] != "threshold" or c["q"].dtype != torch.bfloat16:
        return None
    return sa.admitted_window(
        c["q"], c["k"], c["idx"], c["cnt"] if cnt is None else cnt,
        q_block=c["qb"], k_block=c["kb"], **c["sel"])


def attn_body(torch, c, dense_grid):
    """The body ``csrc/sata_attention.cu`` takes for case ``c`` ("tensor
    cores" or "CUDA cores", by its entry point's own rule) and that
    body's dynamic shared memory in bytes."""
    import ctypes
    from repro_torch.kernels import build
    fn = build.load("sata_attention").sata_block_attention_body
    fn.argtypes = [ctypes.c_int] * 8 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    smem = ctypes.c_int(0)
    tc = fn(c["q"].shape[-1], c["qb"], c["kb"], int("mask" in c["sel"]),
            int("q_pos" in c["sel"]), int("thresholds" in c["sel"]),
            c["bm"].shape[-1] if dense_grid else c["idx"].shape[-1],
            int(c["q"].dtype == torch.bfloat16), ctypes.byref(smem))
    return ("tensor cores" if tc else "CUDA cores"), smem.value


def admitted_buffer(torch, c):
    bh, s = c["q"].shape[:2]
    return torch.zeros((bh, s), dtype=torch.int32, device=c["q"].device)


def check_attn_case(torch, sa, name, c):
    """B3 vs plain on the full plan and on a cut one (count-0 rows,
    padding slots), admitted counts held by ``compare``'s rule; where the
    mode exists on the dense grid, B4 vs plain and B3 == B4 bitwise.
    Returns B3's admitted-key counts per row on the full plan."""
    if c["q"].dtype == torch.bfloat16:      # every bf16 case is on the 16-grid
        body = attn_body(torch, c, False)[0]
        assert body == "tensor cores", f"{name}: bf16 on the {body}"
    cnt_cut = c["cnt"].clone()
    cnt_cut[0, 0] = 0
    cnt_cut[-1, -1] = torch.clamp(cnt_cut[-1, -1] - 1, min=0)
    for label, cnt in (("", None), (" cut plan", cnt_cut)):
        a_k, a_p = admitted_buffer(torch, c), admitted_buffer(torch, c)
        got = run_attn(sa, c, plain=False, cnt=cnt, admitted=a_k)
        want = run_attn(sa, c, plain=True, cnt=cnt, admitted=a_p)
        torch.cuda.synchronize()
        compare(torch, f"B3 {name}{label}", got, want, a_k, a_p,
                attn_window(torch, sa, c, cnt))
        if not label:
            full, adm_full = got, a_k
    if c["mode"] != "threshold" and not c["causal"]:
        a_k, a_p = admitted_buffer(torch, c), admitted_buffer(torch, c)
        got = run_attn(sa, c, plain=False, dense_grid=True, admitted=a_k)
        want = run_attn(sa, c, plain=True, dense_grid=True, admitted=a_p)
        torch.cuda.synchronize()
        compare(torch, f"B4 {name}", got, want, a_k, a_p)
        assert torch.equal(got, full), f"{name}: B3 != B4 (must be bitwise)"
        log(f"[attn-kernel] {name}: B3 == B4 bitwise: True")
    return adm_full


def recompute_flips(torch, c, admitted, name, tag=""):
    """Threshold mode: the rows where the kernel's admitted-key count
    differs from the selection of the chunked route's backward
    (``_selective_ref_chunked``: ``bf16(s) >= bf16(thr)`` on einsum
    scores over every key, causal, not only the planned tiles).  The
    kernel sums each score in its own fixed order, the recompute in the
    GEMM's, so a score on a bf16 rounding boundary can land on either
    side.  Reported, not asserted."""
    from repro_torch.core.blockmap import bisect_select, stream_score_chunks
    sel = c["sel"]
    bh, s, _ = c["q"].shape
    causal = bool(sel.get("causal"))
    pos = sel["q_pos"][0, :, 0] if causal else None
    kpos = sel["k_pos"][0, :, 0] if causal else None
    with torch.no_grad():
        n = stream_score_chunks(
            c["q"], c["k"], lambda sc, adm, t: (bisect_select(sc, t) & adm)
            .sum(-1, dtype=torch.int32), chunk=min(1024, s), causal=causal,
            q_pos=pos, k_pos=kpos, extras=(sel["thresholds"],))
    n = n.transpose(0, 1).reshape(bh, s)
    rows = int((n != admitted).sum())
    log(f"[attn-kernel] {name}: kernel vs backward recompute selection: "
        f"{rows} of {bh * s} rows differ, {int((n - admitted).abs().sum())} "
        f"keys ({int(admitted.sum())} admitted by the kernel, "
        f"{int(n.sum())} by the recompute) {tag}")
    return rows


ATTN_D80 = "threshold_causal_D80_qb128_kb128_bfloat16"


def d80_case(torch, dev, dtype):
    """zamba2-2.7b's shared block on the prefill kernel: 32 heads x D 80
    (zero-padded to 128 in shared memory), causal threshold mode at its
    top-k 64, blocks 128, S 512."""
    return attn_case(torch, bh=32, s=512, d=80, qb=128, kb=128, dtype=dtype,
                     mode="threshold", causal=True, seed=80, device=dev,
                     topk=64)


def rows_case(torch, dev, *, bh=32, sq=2048, sk=4096, d=128, blk=128,
              topk=64, seed=29):
    """A context-parallel rank's B3 call (phase 25's cp job): the last
    ``sq`` of ``sk`` query rows, their ``q_pos`` offset by ``sk - sq``,
    against all ``sk`` keys, causal threshold mode in bf16, the chunked
    planner's own thresholds and block map over those rows."""
    from repro_torch.core.blockmap import compact_kv_plan
    from repro_torch.core.selection import select_thresholds_chunked
    g = torch.Generator(device="cpu").manual_seed(seed)
    q = torch.randn((bh, sq, d), generator=g).to(dev, torch.bfloat16)
    k, v = (torch.randn((bh, sk, d), generator=g).to(dev, torch.bfloat16)
            for _ in range(2))
    q_pos = torch.arange(sk - sq, sk, dtype=torch.int32, device=dev)
    k_pos = torch.arange(sk, dtype=torch.int32, device=dev)
    thr, bm = select_thresholds_chunked(
        q, k, topk, q_pos=q_pos, k_pos=k_pos, causal=True,
        chunk=min(1024, sq), q_block=blk, k_block=blk)
    idx, cnt = compact_kv_plan(bm)
    return dict(q=q, k=k, v=v, qb=blk, kb=blk, mode="threshold",
                causal=True, bm=bm, idx=idx, cnt=cnt,
                sel=dict(thresholds=thr, causal=True,
                         q_pos=q_pos[None, :, None].expand(bh, sq, 1),
                         k_pos=k_pos[None, :, None].expand(bh, sk, 1)))


ATTN_ROWS = "rows_BH32_Sq2048_Sk4096_D128_blk128_threshold_causal_bf16"


def attn_cases(torch, dev):
    """Phase 6's inputs: the training shape in threshold mode, the
    dense-selection shape in mask mode, zamba2's D = 80 shape (bf16 and
    fp32), a context-parallel rank's rows (``rows_case``: Sq 2,048 at
    q_pos 2,048.. against Sk 4,096), then edge cases: D in {16, 32, 64,
    128}, q/k blocks 16..128 (unequal too), every mode causal and not,
    fp32 and bf16."""
    f32, bf16 = torch.float32, torch.bfloat16
    yield "main_BH32_S4096_D128_blk128_threshold_causal_bf16", attn_case(
        torch, bh=32, s=4096, d=128, qb=128, kb=128, dtype=bf16,
        mode="threshold", causal=True, seed=0, device=dev, topk=64)
    yield ATTN_ROWS, rows_case(torch, dev)
    yield "BH32_S2048_D128_blk128_mask_bf16", attn_case(
        torch, bh=32, s=2048, d=128, qb=128, kb=128, dtype=bf16,
        mode="mask", causal=False, seed=1, device=dev)
    for dt in (bf16, f32):
        name = ATTN_D80.replace("bfloat16", str(dt).split(".")[-1])
        yield name, d80_case(torch, dev, dt)
    specs = [  # (bh, s, d, qb, kb, dtype, mode, causal)
        (3, 64, 16, 16, 16, f32, "threshold", True),
        (2, 128, 64, 32, 32, f32, "threshold", False),
        (2, 256, 128, 64, 128, f32, "mask", False),
        (2, 128, 32, 32, 32, f32, "block", False),
        (2, 128, 32, 32, 16, f32, "block", True),
        (2, 256, 128, 128, 64, bf16, "block", True),
        (3, 512, 128, 128, 128, bf16, "threshold", True),
        (2, 192, 64, 64, 64, bf16, "mask", False),
        (2, 256, 64, 128, 128, bf16, "block", False),
        # the tensor cores at every width and mode: D 16 / 32 / 48 padded
        # to 64, 96 to 128; one consumer warpgroup (q_block <= 64), a
        # second one part-filled (80), k-blocks under 128
        (2, 128, 16, 16, 16, bf16, "threshold", True),
        (2, 128, 32, 32, 64, bf16, "mask", False),
        (2, 160, 48, 80, 80, bf16, "threshold", True),
        (2, 256, 64, 32, 32, bf16, "threshold", False),
        (2, 256, 80, 128, 128, bf16, "mask", False),
        (2, 256, 80, 64, 64, bf16, "block", True),
        (2, 128, 96, 64, 64, bf16, "block", False),
    ]
    for n, (bh, s, d, qb, kb, dt, mode, causal) in enumerate(specs):
        yield (f"{mode}{'_causal' if causal else ''}_D{d}_qb{qb}_kb{kb}_"
               f"{str(dt).split('.')[-1]}"), attn_case(
            torch, bh=bh, s=s, d=d, qb=qb, kb=kb, dtype=dt, mode=mode,
            causal=causal, seed=10 + n, device=dev)


def check_attn_kernels(torch, sa, dev, tag):
    """Phase 6: both prefill kernels against their plain versions on
    every case, an empty plan, two launches bitwise equal, and the main
    case's selection against the backward recompute's."""
    main = None
    for name, c in attn_cases(torch, dev):
        if main is None:
            main, main_name = c, name
            log(f"[attn-kernel] main plan: {int(c['cnt'].sum())} planned "
                f"tiles of {c['bm'].numel()}, P {c['idx'].shape[-1]}")
            main_adm = check_attn_case(torch, sa, name, c)
        else:
            check_attn_case(torch, sa, name, c)
    recompute_flips(torch, main, main_adm, main_name, tag)
    c = attn_case(torch, bh=2, s=64, d=16, qb=16, kb=16, dtype=torch.float32,
                  mode="threshold", causal=True, seed=99, device=dev)
    idx0 = c["idx"][..., :0].contiguous()                     # P == 0
    got = run_attn(sa, c, plain=False, idx=idx0)
    assert got.shape == c["q"].shape and not got.any(), "P0: not zeros"
    log("[attn-kernel] P0: zeros")
    a = run_attn(sa, main, plain=False)
    b = run_attn(sa, main, plain=False)
    torch.cuda.synchronize()
    assert torch.equal(a, b), "two launches differ"
    log("[attn-kernel] main: two launches bitwise equal: True")


def main_path_cfg(base, **kernel):
    """qwen3-4b at full width through the SATA kernel route, 128-blocks."""
    from repro_torch.models.config import SataKernelConfig
    return dataclasses.replace(
        base, remat="full",
        sata=dataclasses.replace(base.sata, kernel=SataKernelConfig(
            use=True, block=128, **kernel)))


class FirstCall:
    """While open, ``kernels.ops.<name>`` (the kernel route's dispatch to
    one prefill kernel) keeps the arguments of its first call, which in a
    forward pass is layer 0's, and passes every call on unchanged.  It
    launches nothing itself, so the launch counts stay the main path's."""

    def __init__(self, name):
        from repro_torch.kernels import ops
        self.ops, self.name, self.args, self.kw = ops, name, None, None

    def __enter__(self):
        self.fn = getattr(self.ops, self.name)
        setattr(self.ops, self.name, self)
        return self

    def __exit__(self, *exc):
        setattr(self.ops, self.name, self.fn)

    def __call__(self, *args, **kw):
        if self.args is None:
            self.args, self.kw = args, kw
        return self.fn(*args, **kw)


def planned_map(torch, idx, cnt, nkb):
    """(BH, nqb, nkb) bool: the k-blocks each row's plan visits (padding
    slots repeat a live index: reduce, never overwrite)."""
    live = (torch.arange(idx.shape[-1], device=idx.device)
            < cnt[..., None]).to(torch.int32)
    return torch.zeros(idx.shape[:2] + (nkb,), dtype=torch.int32,
                       device=idx.device).scatter_reduce_(
        2, idx.long(), live, reduce="amax").bool()


def recorded_case(torch, sa, rec, *, dense_grid):
    """A case as ``attn_case`` builds it, from the arguments a FirstCall
    recorded: the very tensors the main path handed the kernel."""
    import inspect
    from repro_torch.core.blockmap import compact_kv_plan
    fn = sa.sata_block_attention if dense_grid \
        else sa.sata_block_attention_compact
    bound = inspect.signature(fn).bind(*rec.args, **rec.kw)
    bound.apply_defaults()
    # q/k/v reach the kernel as the autograd Function's inputs: detach them
    # so phase 10's plain-version calls build no graph
    a = {n: x.detach() if isinstance(x, torch.Tensor) else x
         for n, x in bound.arguments.items()}
    kb = a["k_block"]
    sel = {n: a[n] for n in ("mask", "thresholds") if a.get(n) is not None}
    causal = bool(a.get("causal")) and a["mask"] is None
    if causal:
        sel.update(causal=True, q_pos=a["q_pos"], k_pos=a["k_pos"])
    if dense_grid:
        bm = a["block_map"].bool()
        idx, cnt = compact_kv_plan(bm)
    else:
        idx, cnt = a["kv_indices"], a["kv_counts"]
        bm = planned_map(torch, idx, cnt, a["k"].shape[1] // kb)
    mode = "mask" if "mask" in sel else \
        "threshold" if "thresholds" in sel else "block"
    return dict(q=a["q"], k=a["k"], v=a["v"], qb=a["q_block"], kb=kb,
                mode=mode, causal=causal, sel=sel, bm=bm, idx=idx, cnt=cnt)


def attended_pairs(torch, c):
    """(BH, Sq, Sk) bool: the pairs the kernel attends on case ``c``,
    planned tiles AND the mode's element selection.  Threshold mode
    scores with einsum here, so a score on a bf16 rounding boundary may
    fall on the other side than in the kernel (``recompute_flips``
    counts such rows)."""
    from repro_torch.core.blockmap import bisect_select
    q, k = c["q"], c["k"]
    bh, s, d = q.shape
    keep = c["bm"].repeat_interleave(c["qb"], 1).repeat_interleave(c["kb"], 2)
    sel = c["sel"]
    if "mask" in sel:
        keep &= sel["mask"].bool()
    if "thresholds" in sel:
        sc = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) \
            * (1.0 / np.sqrt(d))
        keep &= bisect_select(sc, sel["thresholds"])
        del sc
    if sel.get("causal"):
        keep &= (sel["k_pos"].reshape(bh, 1, -1)
                 <= sel["q_pos"].reshape(bh, -1, 1))
    return keep


def attn_bound(torch, c, admitted, keep):
    """Least time for the function's work on an H100: the larger of its
    flops over the peak for the input type and its bytes over
    3.35 TB/s, both counted from this input.  Flops: 2·D for each score
    the selection needs (mask mode: the selected pairs; threshold and
    block mode: the position-admissible pairs of the planned tiles) and
    2·D for each admitted key's PV product (``admitted``, the kernel's
    per-row counts).  Bytes, each once: q and the output; the K rows
    scored (mask mode: keys some row selects; else the planned k-blocks)
    and the V rows some row attends (``keep``); the plan, thresholds,
    positions and the mask bytes of planned tiles."""
    q = c["q"]
    bh, s, d = q.shape
    es = q.element_size()
    qb, kb, sel, planned = c["qb"], c["kb"], c["sel"], c["bm"]
    nqb, nkb = planned.shape[1:]
    tiles = int(planned.sum())
    pv = int(admitted.sum())
    v_rows = int(keep.any(dim=1).sum())
    if "mask" in sel:
        qk, k_rows = pv, v_rows
    else:
        k_rows = int(planned.any(dim=1).sum()) * kb
        if sel.get("causal"):
            qp = sel["q_pos"].reshape(bh, nqb, qb, 1)
            kp = sel["k_pos"].reshape(bh, nkb, 1, kb)
            qk = sum(int(((kp[:, None, j] <= qp).sum((-1, -2))
                          * planned[..., j]).sum()) for j in range(nkb))
        else:
            qk = tiles * qb * kb
    nbytes = ((2 * bh * s + k_rows + v_rows) * d * es
              + (c["idx"].numel() + c["cnt"].numel()) * 4)
    if "thresholds" in sel:
        nbytes += sel["thresholds"].numel() * 4
    if sel.get("causal"):
        nbytes += 4 * bh * s * 2
    if "mask" in sel:
        nbytes += tiles * qb * kb
    flops = 2 * d * (qk + pv)
    peak = BF16_FLOPS_PER_S if es == 2 else FP32_FLOPS_PER_S
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations",
            dict(tiles=tiles, qk_pairs=qk, pv_keys=pv, gflop=flops / 1e9,
                 mbytes=nbytes / 1e6))


def reset_attn_counts(sa):
    sa.sata_block_attention_compact.launches = 0
    sa.sata_block_attention.launches = 0


def attn_counts(sa):
    return (sa.sata_block_attention_compact.launches,
            sa.sata_block_attention.launches)


TRAIN_LAYERS = 2       # phase 7: full width, 2 of qwen3-4b's 36 layers


def train_main_path(torch, sa, dev, base, tag, *, steps=4, seq=4096):
    """Phase 7: ``train()`` on full-width qwen3-4b (TRAIN_LAYERS deep)
    through the compacted grid; returns layer 0's recorded kernel
    arguments as a case for phase 10 and the kernel's launch count."""
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.launch.train import train
    cfg = main_path_cfg(dataclasses.replace(base, topk_impl="bisect",
                                            n_layers=TRAIN_LAYERS))
    reset_attn_counts(sa)
    torch.cuda.reset_peak_memory_stats()
    t = time.time()
    with FirstCall("_block_attention_compact") as rec:
        out = train("qwen3-4b", cfg=cfg, steps=steps, batch=1, seq=seq,
                    log_every=1, device=dev)
    torch.cuda.synchronize()
    wall = time.time() - t
    n_b3, n_b4 = attn_counts(sa)
    want = cfg.n_layers * steps * 2
    log(f"[train] qwen3-4b full width, {cfg.n_layers} layers, batch 1, "
        f"S {seq}, chunked selection, remat full: losses "
        f"{[round(x, 4) for x in out['losses']]}, grad norms "
        f"{[round(x, 4) for x in out['gnorms']]}")
    log(f"[train] step seconds {[round(x, 3) for x in out['step_s']]}, "
        f"tokens/s {[round(seq / x, 1) for x in out['step_s']]}, peak "
        f"device memory {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} "
        f"GiB, {wall:.1f} s in all; compacted-grid launches {n_b3} "
        f"(= {cfg.n_layers} layers x {steps} steps x 2: forward + remat "
        f"recompute), dense-grid launches {n_b4} {tag}")
    assert all(np.isfinite(out["losses"])) and all(np.isfinite(out["gnorms"]))
    assert n_b3 == want, f"compacted-grid launches {n_b3} != {want}"
    assert n_b4 == 0, f"the dense grid ran {n_b4} times on the main path"
    batch = {k: torch.from_numpy(a).to(dev) for k, a in
             SyntheticLM(cfg, 1, seq, seed=0).next_batch().items()}
    profile_step(torch, cfg, out["final_state"], batch, tag)
    return recorded_case(torch, sa, rec, dense_grid=False), n_b3


def profile_step(torch, cfg, state, batch, tag, top=12, host_ops=True):
    """One more training step under ``torch.profiler``: device time by
    kernel (summed over launches; the top ones and the port's own) and
    the device's busy share of the step's wall time.  ``host_ops=False``
    records the device's kernels only (rwkv6's step runs ~10^5 eager ops,
    whose host-side events took the profiler 90 s to tabulate)."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.optim.adamw import OptConfig
    from repro_torch.train.step import make_train_step
    step_fn = make_train_step(cfg, OptConfig())
    torch.cuda.synchronize()
    acts = [ProfilerActivity.CPU] if host_ops else []
    with profile(activities=acts + [ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        t = time.time()
        step_fn(state, batch)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.time() - t)

    dev_ms = device_ms
    # kernels only: operator rows carry their kernels' device time too
    cuda = torch.autograd.DeviceType.CUDA
    evs = [e for e in prof.key_averages()
           if getattr(e, "device_type", None) == cuda and dev_ms(e) > 0]
    busy = sum(dev_ms(e) for e in evs)
    log(f"[profile] one training step: wall {wall_ms:.1f} ms (profiler "
        f"on), device busy {busy:.1f} ms = {100 * busy / wall_ms:.1f}% of "
        f"it; idle {100 * (1 - busy / wall_ms):.1f}% {tag}")
    # the top kernels, and the port's own wherever they rank
    ranked = sorted(evs, key=dev_ms, reverse=True)
    for e in ranked[:top] + [e for e in ranked[top:] if "sata_" in e.key]:
        log(f"[profile]   {dev_ms(e):9.2f} ms {100 * dev_ms(e) / busy:5.1f}% "
            f"x{e.count:<6d} {e.key[:90]}")


def route_on_off(torch, sa, dev, base, tag, *, layers=4, seq=4096):
    """Phase 8: one forward + backward at full width with the kernel
    route on and off (``_attend``): the same loss and grad norm within
    ROUTE_RTOL, and layer 0's attention output on the same input within
    ROUTE_ATTN_RTOL (relative Frobenius norm)."""
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.models.attention import attention_apply
    from repro_torch.models.config import SataKernelConfig
    from repro_torch.models.layers import _dtype, apply_norm, embed_apply
    from repro_torch.models.model import DenseModel, loss_fn
    on = main_path_cfg(dataclasses.replace(base, topk_impl="bisect",
                                           n_layers=layers))
    off = dataclasses.replace(on, sata=dataclasses.replace(
        on.sata, kernel=SataKernelConfig(use=False)))
    model = DenseModel(on, device=dev, seed=1)
    batch = {k: torch.from_numpy(a).to(dev) for k, a in
             SyntheticLM(on, 1, seq, seed=1).next_batch().items()}
    p0 = model["layers"][0]
    with torch.no_grad():
        x0 = apply_norm(p0["ln1"], on, embed_apply(
            model["embed"], batch["tokens"]).to(_dtype(on)))
    res = {}
    for name, cfg in (("kernel route", on), ("_attend", off)):
        model.zero_grad(set_to_none=True)
        reset_attn_counts(sa)
        t = time.time()
        loss, _ = loss_fn(model, cfg, batch)
        loss.backward()
        torch.cuda.synchronize()
        secs, counts = time.time() - t, attn_counts(sa)
        gn = float(torch.sqrt(sum(torch.sum(p.grad.float() ** 2)
                                  for p in model.parameters())))
        with torch.no_grad():
            attn0 = attention_apply(p0["attn"], cfg, x0).float()
        res[name] = (loss.item(), gn, attn0)
        log(f"[route] {name}: loss {res[name][0]:.6f}, grad norm {gn:.6f}, "
            f"fwd+bwd {secs:.2f} s, launches (B3, B4) {counts} {tag}")
    (l1, g1, a1), (l0, g0, a0) = res["kernel route"], res["_attend"]
    rel = {"loss": abs(l1 - l0) / abs(l0),
           "grad norm": abs(g1 - g0) / abs(g0),
           "layer-0 attention output": float(
               torch.linalg.vector_norm(a1 - a0)
               / torch.linalg.vector_norm(a0))}
    lim = {"loss": ROUTE_RTOL, "grad norm": ROUTE_RTOL,
           "layer-0 attention output": ROUTE_ATTN_RTOL}
    log("[route] kernel route vs _attend, relative: " + ", ".join(
        f"{n} {rel[n]:.3e} (limit {lim[n]:g})" for n in rel))
    bad = [n for n in rel if not rel[n] <= lim[n]]
    assert not bad, f"kernel route vs _attend differ in {bad}: {rel}"


def remat_policies(torch, sa, dev, base, tag, *, layers=4, seq=4096):
    """Phase 8, second part: one forward + backward on the kernel route
    with ``remat`` "none", "dots" and "full": the same loss and grad norm
    within ROUTE_RTOL, reporting where they are bitwise equal (a
    recompute that runs the same kernels at the same shapes gives the
    same bits), the compacted-grid launches (the forward, plus the
    recompute under "dots" and "full") and each policy's peak memory."""
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.models.model import DenseModel, loss_fn
    cfg = main_path_cfg(dataclasses.replace(base, topk_impl="bisect",
                                            n_layers=layers))
    model = DenseModel(cfg, device=dev, seed=1)
    batch = {k: torch.from_numpy(a).to(dev) for k, a in
             SyntheticLM(cfg, 1, seq, seed=1).next_batch().items()}
    res = {}
    for remat in ("none", "dots", "full"):
        rcfg = dataclasses.replace(cfg, remat=remat)
        model.zero_grad(set_to_none=True)
        reset_attn_counts(sa)
        torch.cuda.synchronize()
        base_mem = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t = time.time()
        loss, _ = loss_fn(model, rcfg, batch)
        loss.backward()
        torch.cuda.synchronize()
        secs = time.time() - t
        peak = (torch.cuda.max_memory_allocated() - base_mem) / 2 ** 30
        gn = torch.sqrt(sum(torch.sum(p.grad.float() ** 2)
                            for p in model.parameters()))
        res[remat] = (loss.detach(), gn, attn_counts(sa)[0])
        log(f"[remat] {remat}: loss {loss.item():.6f}, grad norm "
            f"{gn.item():.6f}, fwd+bwd {secs:.2f} s, peak memory above the "
            f"weights {peak:.2f} GiB, compacted-grid launches "
            f"{res[remat][2]} {tag}")
    l0, g0, _ = res["none"]
    for remat in ("dots", "full"):
        l1, g1, n = res[remat]
        rel = (abs(l1 - l0) / abs(l0)).item(), (abs(g1 - g0) / g0).item()
        assert max(rel) <= ROUTE_RTOL, f"remat {remat} vs none: {rel}"
        assert n == 2 * layers, f"remat {remat}: {n} launches"
        log(f"[remat] {remat} vs none: loss {rel[0]:.3e}, grad norm "
            f"{rel[1]:.3e} relative (limit {ROUTE_RTOL:g}); bitwise equal: "
            f"loss {bool(torch.equal(l1, l0))}, grad norm "
            f"{bool(torch.equal(g1, g0))}")
    assert res["none"][2] == layers


def prefill_schedules(torch, sa, dev, base, tag, *, layers=4, seq=2048):
    """Phase 9: the dense-selection route through ``make_prefill_step`` on
    both grids: equal logits bitwise.  Returns layer 0's recorded
    dense-grid arguments as a case for phase 10 and B4's launch count on
    its own run."""
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.kernels.ops import kernel_fetch_stats
    from repro_torch.models.model import DenseModel
    from repro_torch.train.step import make_prefill_step
    cfgs = {sch: main_path_cfg(dataclasses.replace(
        base, topk_impl="sort", n_layers=layers), schedule=sch)
        for sch in ("compact", "dense")}
    model = DenseModel(cfgs["compact"], device=dev, seed=2)
    tokens = torch.from_numpy(SyntheticLM(cfgs["compact"], 1, seq, seed=2)
                              .next_batch()["tokens"]).to(dev)
    logits, counts = {}, {}
    for sch, cfg in cfgs.items():
        reset_attn_counts(sa)
        t = time.time()
        with FirstCall("_block_attention_dense") as rec:
            logits[sch] = make_prefill_step(cfg)(model, {"tokens": tokens})
        torch.cuda.synchronize()
        counts[sch] = attn_counts(sa)
        log(f"[prefill] topk sort, {sch} grid, {layers} layers, S {seq}: "
            f"{time.time() - t:.2f} s, launches (B3, B4) {counts[sch]} {tag}")
        if sch == "dense":
            case = recorded_case(torch, sa, rec, dense_grid=True)
    assert counts["compact"] == (layers, 0), counts
    assert counts["dense"] == (0, layers), counts
    assert torch.isfinite(logits["compact"]).all()
    same = torch.equal(logits["compact"], logits["dense"])
    log(f"[prefill] compact == dense grid logits bitwise: {same}")
    assert same, "compacted and dense grid logits differ"
    stats = kernel_fetch_stats(case["bm"], q_block=case["qb"],
                               k_block=case["kb"], d=case["q"].shape[-1],
                               dtype_bytes=case["q"].element_size())
    log(f"[prefill] layer 0 kernel_fetch_stats: {json.dumps(stats)}")
    return case, counts["dense"][1]


def time_attn(torch, sa, c, name, tag, *, dense_grid=False,
              inputs="the main path's layer-0 arguments"):
    """Phase 10 for one kernel on a case (``inputs`` says which):
    kernel vs plain version (phase 6's limits), then the kernel, the
    plain version and SDPA with the equivalent mask timed, and the
    bound.  Returns the ``kernels`` row's numbers and the kernel's
    admitted-key counts."""
    a_k, a_p = admitted_buffer(torch, c), admitted_buffer(torch, c)
    got = run_attn(sa, c, plain=False, dense_grid=dense_grid, admitted=a_k)
    want = run_attn(sa, c, plain=True, dense_grid=dense_grid, admitted=a_p)
    torch.cuda.synchronize()
    err = compare(torch, f"{name} on {inputs}", got, want, a_k, a_p,
                  attn_window(torch, sa, c))
    del got, want
    ms = time_ms(torch, lambda: run_attn(sa, c, plain=False,
                                         dense_grid=dense_grid))
    plain_ms = time_ms(torch, lambda: run_attn(sa, c, plain=True,
                                               dense_grid=dense_grid),
                       reps=3, warm=1)
    bh, s, d = c["q"].shape
    keep = attended_pairs(torch, c)
    q4, k4, v4 = (c[n].reshape(1, bh, s, d) for n in ("q", "k", "v"))
    lib_ms = time_ms(torch, lambda: torch.nn.functional
                     .scaled_dot_product_attention(q4, k4, v4,
                                                   attn_mask=keep[None]))
    bound_ms, bound_by, n = attn_bound(torch, c, a_k, keep)
    del keep
    body, smem = attn_body(torch, c, dense_grid)
    if c["q"].dtype == torch.bfloat16:
        assert body == "tensor cores", f"{name}: bf16 on the {body}"
    log(f"[timing] {name}: BH {bh}, S {s}, D {d}, {c['qb']}x{c['kb']} "
        f"tiles, {c['mode']} mode, {n['tiles']} planned tiles of "
        f"{c['bm'].numel()}, {n['qk_pairs']} scores and {n['pv_keys']} "
        f"admitted keys needed ({n['gflop']:.2f} GFLOP, "
        f"{n['mbytes']:.1f} MB), {body}, {smem} bytes of dynamic shared "
        f"memory: kernel {ms:.4f} ms, bound "
        f"{bound_ms:.4f} ms ({bound_by}), plain {plain_ms:.2f} ms, "
        f"SDPA+mask {lib_ms:.4f} ms {tag}")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=lib_ms), a_k


def prefill_phases(torch, sa, dev, base, tag, clock):
    """Phases 7-10; returns the two prefill kernels' ``kernels`` rows."""
    c3, n_b3 = train_main_path(torch, sa, dev, base, tag)
    torch.cuda.empty_cache()
    clock.done("7 train qwen3-4b")
    route_on_off(torch, sa, dev, base, tag)
    torch.cuda.empty_cache()
    remat_policies(torch, sa, dev, base, tag)
    torch.cuda.empty_cache()
    clock.done("8 kernel route and remat policies")
    c4, n_b4 = prefill_schedules(torch, sa, dev, base, tag)
    torch.cuda.empty_cache()
    clock.done("9 dense-selection prefill")
    rows = []
    for fn, c, launches, dense_grid in (
            (sa.sata_block_attention_compact, c3, n_b3, False),
            (sa.sata_block_attention, c4, n_b4, True)):
        t, adm = time_attn(torch, sa, c, fn.__name__, tag,
                           dense_grid=dense_grid)
        if c["mode"] == "threshold":
            recompute_flips(torch, c, adm, f"{fn.__name__} main path", tag)
        rows.append({"name": fn.__name__, "route": "cuda",
                     "source": SRC_ATTN_CU,
                     "replaces": REPLACES["dense" if dense_grid
                                          else "compact"],
                     "launches": launches, **t})
    c80 = d80_case(torch, dev, torch.bfloat16)
    rows[0]["d80"], adm = time_attn(
        torch, sa, c80, "sata_block_attention_compact", tag,
        inputs=f"phase 6's {ATTN_D80} case (zamba2-2.7b)")
    recompute_flips(torch, c80, adm, f"{ATTN_D80} (zamba2-2.7b)", tag)
    del c80
    clock.done("10 prefill kernel timing")
    return rows


# ---------------------------------------------------------------------------
# phases 11-12: the shared-prefix cache and the summary backends
# ---------------------------------------------------------------------------

SHARED_PREFIX = 1000     # 15 full pages of 64 + a 40-row partial page
PREFIX_LAYERS = 6        # phases 11-13a: full width, 6 of the 36 layers
SKETCH_BLOCKS = 8        # phase 12's plan width P: 8 of 64 pages


@contextlib.contextmanager
def recording(module, name, seen, keep_last=False):
    """While open, ``module.<name>`` appends each call's (args, kwargs,
    result) to ``seen`` (only the last call with ``keep_last``) and is
    otherwise passed through unchanged."""
    fn = getattr(module, name)

    def rec(*args, **kw):
        out = fn(*args, **kw)
        if keep_last:
            seen.clear()
        seen.append((args, kw, out))
        return out

    setattr(module, name, rec)
    try:
        yield seen
    finally:
        setattr(module, name, fn)


def serve_full(torch, sd, serve, cfg, model, opts, label, tag, **kw):
    """One full-width serve on the paged layout (``kw`` goes to
    ``serve``): every request complete, the paged kernel launched
    layers × decode steps times."""
    sd.sata_decode_attention_paged_kernel.launches = 0
    sd.sata_decode_attention_kernel.launches = 0
    out = serve("qwen3-4b", smoke=False, cfg=cfg, model=model, options=opts,
                device=next(model.parameters()).device, **kw)
    torch.cuda.synchronize()
    n = sd.sata_decode_attention_paged_kernel.launches
    outs = out["outputs"]
    assert sorted(outs) == list(range(opts.n_requests)), sorted(outs)
    for r, toks in outs.items():
        assert len(toks) == opts.gen_len, (r, len(toks))
        assert all(0 <= x < cfg.vocab_size for x in toks), r
    assert n == cfg.n_layers * out["steps"], \
        f"{label}: {n} launches != {cfg.n_layers} x {out['steps']}"
    assert sd.sata_decode_attention_kernel.launches == 0
    occ, pf = out["page_occupancy"], out["prefill_ms_mean"]
    log(f"[{label}] {out['steps']} decode steps, mean decode step "
        f"{out['step_ms_mean']:.2f} ms, paged kernel launches {n} (= "
        f"{cfg.n_layers} layers x {out['steps']} steps), mean prefill "
        f"ms: hit {pf['hit']}, miss {pf['miss']}; pages held at peak "
        f"{occ['pages_in_use_peak']}/{occ['n_pages']} {tag}")
    return out, n


def prefix_cache_phase(torch, sd, serve, cfg, model, opts, tag):
    """Phase 11: phase 3's path with ``shared_prefix_len=1000``, served
    with the prefix cache on and off: equal token streams, hits, copies
    on write and shared pages, and the allocator's audit after the run.
    Returns the cache-on run's report."""
    from repro_torch.launch import serve as serve_mod
    sp_opts = dataclasses.replace(opts, shared_prefix_len=SHARED_PREFIX)
    on_cfg = dataclasses.replace(cfg, kv=dataclasses.replace(
        cfg.kv, prefix_cache=True))
    tries = []
    with recording(serve_mod, "PrefixCache", tries):
        on, _ = serve_full(torch, sd, serve, on_cfg, model, sp_opts,
                              "prefix on", tag)
    off, _ = serve_full(torch, sd, serve, cfg, model, sp_opts, "prefix off",
                        tag)
    assert on["outputs"] == off["outputs"], \
        "prefix cache on and off serve different token streams"
    p = on["prefix_cache"]
    assert p["hits"] * 16 >= 14 * p["requests"], p
    assert p["cow_copies"] > 0 and p["shared_pages_peak"] > 0, p
    assert len(tries) == 1, len(tries)
    trie = tries[0][2]
    trie.alloc.check_invariants(trie)
    log(f"[prefix] on == off token streams: True; hit rate "
        f"{p['hit_rate']:.4f} ({p['hits']}/{p['requests']}), prefill "
        f"tokens saved {p['prefill_tokens_saved']}/"
        f"{p['prefill_tokens_total']}, {p['cow_copies']} copies on write, "
        f"shared pages peak {p['shared_pages_peak']}, cached pages "
        f"{p['cached_pages']}, evictions {p['evictions']}, "
        f"{on['page_occupancy']['audits_run']} allocator audits + the "
        f"final check_invariants passed; pages held at peak with / "
        f"without the cache {on['page_occupancy']['pages_in_use_peak']} / "
        f"{off['page_occupancy']['pages_in_use_peak']} {tag}")
    return on


def check_final_plans(torch, cache, pos, max_len):
    """Phase 12's check of every layer's final plan state: the
    dequantized int8 bounds contain the fp32 bounds the cache's keys
    give (``summaries_from_cache``) for each slot the last step served,
    and every ``kv_indices`` entry below ``kv_counts`` names a block of
    the cache (at or before the slot's position when it was served)."""
    from repro_torch.core.decode_plan import (plan_summary_bounds,
                                              summaries_from_cache)
    from repro_torch.core.paging import logical_kv_view
    kv = cache["kv"]
    plan, blk = kv["plan"], kv["k_pages"].shape[2]
    nkb = max_len // blk
    served = (kv["page_table"][0, :, 0] != 0) & (pos < max_len)
    assert bool(served.any()), "the last step served no slot"
    sl = served.nonzero()[:, 0]
    n_blocks = 0
    for layer in range(plan["k_min"].shape[0]):
        one = {n: t[layer] for n, t in plan.items()}
        lo8, hi8 = plan_summary_bounds(one)
        keys = logical_kv_view(kv["k_pages"][layer], kv["page_table"][layer])
        lo, hi = summaries_from_cache(keys[sl], pos[sl], k_block=blk)
        live = torch.isfinite(lo[..., 0])
        assert bool((lo8[sl] <= lo).all()) and bool((hi8[sl] >= hi).all()), \
            f"layer {layer}: int8 bounds do not contain the fp32 bounds"
        n_blocks += int(live.sum())
        idx, cnt = one["kv_indices"], one["kv_counts"]
        used = (torch.arange(idx.shape[-1], device=idx.device)[None, None]
                < cnt[..., None])
        assert bool(((idx >= 0) & (idx < nkb))[used].all()), layer
        last = (pos[sl] // blk)[:, None, None]
        assert bool((idx[sl] <= last)[used[sl]].all()), layer
    return int(sl.numel()), n_blocks


def summary_phase(torch, sd, serve, cfg, model, opts, fp32_outputs, case,
                  tag):
    """Phase 12: int8 summaries at ``replan=1`` serve phase 3's stream;
    int8 + sketch re-plans every 8th step with the prefix cache on serve
    phase 11's workload, its final plan states checked on the card; at
    the main shape ``sketch_replan`` covering every block equals
    ``full_replan`` bitwise; and the planner's per-layer times."""
    from repro_torch.models import decode as dec
    dcfg = cfg.sata.decode
    int8 = dataclasses.replace(cfg, sata=dataclasses.replace(
        cfg.sata, decode=dataclasses.replace(dcfg, summary="int8")))
    out8, _ = serve_full(torch, sd, serve, int8, model, opts, "int8 replan 1",
                         tag)
    assert out8["outputs"] == fp32_outputs, \
        "int8 at replan=1 serves another token stream than fp32"
    log(f"[summary] int8 at replan=1 == fp32 token streams: True {tag}")
    sk = dataclasses.replace(cfg, sata=dataclasses.replace(
        cfg.sata, decode=dataclasses.replace(
            dcfg, summary="int8", replan=8, replan_mode="sketch",
            blocks=SKETCH_BLOCKS)),
        kv=dataclasses.replace(cfg.kv, prefix_cache=True))
    caches, steps = [], []
    sp_opts = dataclasses.replace(opts, shared_prefix_len=SHARED_PREFIX)
    with recording(dec, "init_cache", caches), \
            recording(dec, "serve_step", steps, keep_last=True):
        outs, _ = serve_full(torch, sd, serve, sk, model, sp_opts,
                             f"int8 sketch replan 8 P{SKETCH_BLOCKS} "
                             f"prefix on", tag)
    assert len(caches) == 1 and len(steps) == 1, (len(caches), len(steps))
    cache, last_pos = caches[0][2], steps[0][0][4]
    n_slots, n_blocks = check_final_plans(torch, cache, last_pos,
                                          opts.max_len)
    f = outs["decode_fetch"]
    log(f"[summary] final plan states, {cfg.n_layers} layers: int8 bounds "
        f"contain the fp32 bounds ({n_slots} served slots, {n_blocks} "
        f"(layer, slot, head, block) bounds), kv_indices valid; re-plans "
        f"{f['replans']:.2f} per (layer, slot), plan bytes "
        f"{f['plan_fetch_bytes']} vs kernel bytes "
        f"{f['kv_fetch_bytes_plan']} {tag}")
    del cache, caches, steps, last_pos
    planner_times(torch, case, tag)



def planner_times(torch, c, tag):
    """Phase 12 at the main shape (phase 2's main case): ``sketch_replan``
    with C·F >= nkb against ``full_replan``, bitwise; then one layer's
    planner on the host clock after ``torch.cuda.synchronize()``: the
    exact re-plan, the int8 incremental step and the int8 sketch re-plan
    at P = SKETCH_BLOCKS."""
    from repro_torch.core.decode_plan import (decode_plan_update,
                                              full_replan, init_decode_plan,
                                              quantize_summaries,
                                              sketch_replan,
                                              summaries_from_cache)
    b, kv, g, d = c["q"].shape
    s, blk = c["k"].shape[1], c["page"]
    lo, hi = summaries_from_cache(c["k"], c["pos"], k_block=blk)

    def plan_of(p, summary, step):
        plan = init_decode_plan(b, kv, s, d, blk, p, summary=summary,
                                device=c["q"].device)
        vals = quantize_summaries(lo, hi) if summary == "int8" else (lo, hi)
        for n, v in zip(("k_min", "k_max", "k_scale", "k_zero"), vals):
            plan[n].copy_(v)
        plan["step"].fill_(step)
        return plan

    full = full_replan(c["q"], c["k"], c["pos"], topk_k=64, k_block=blk,
                       plan_blocks=s // blk)
    sk = sketch_replan(c["q"], c["kp"], plan_of(None, "int8", 0), c["pos"],
                       topk_k=64, k_block=blk, page_table=c["table"])
    for name, x, y in zip(("kv_indices", "kv_counts", "thresholds"), sk,
                          full):
        assert torch.equal(x, y), f"sketch (C·F >= nkb) != full: {name}"
    log(f"[summary] main shape: sketch_replan (C·F = nkb = {s // blk}) == "
        f"full_replan bitwise (plans and thresholds) {tag}")
    runs = {"exact re-plan": (None, "fp32", 0, dict(replan_interval=1)),
            "int8 incremental step": (SKETCH_BLOCKS, "int8", 1,
                                      dict(replan_interval=8)),
            "int8 sketch re-plan": (SKETCH_BLOCKS, "int8", 0,
                                    dict(replan_interval=8,
                                         replan_mode="sketch"))}
    times = {}
    for name, (p, summary, step, kw) in runs.items():
        plan = plan_of(p, summary, step)

        def once():
            plan["step"].fill_(step)          # stay on (or off) the beat
            decode_plan_update(plan, c["q"], c["kp"], c["pos"], topk_k=64,
                               k_block=blk, page_table=c["table"], **kw)

        times[name] = wall_ms(torch, once, reps=20)
    log("[timing] planner per layer (B8, KV8, G4, D128, pages of 64, pos "
        "1024-1087, host clock after synchronize): " + ", ".join(
            f"{n} {t:.4f} ms" for n, t in times.items()) + f" {tag}")


# phase 13a's fault schedule over phase 11's workload, by loop step: slot 0
# is preempted and the pool squeezed dry in the same step, so its handle
# stays parked; a byte of that handle is flipped while it waits (caught
# at the claim gate: quarantine, trie invalidation, re-prefill); slot 1
# is preempted into a second parked handle; the crash turns that
# handle's pins into payload and swaps every live slot out in full; the
# restore returns the squeezed pages
FAULT_STEPS = {"park": 4, "corrupt": 6, "second": 8, "crash": 10,
               "restore": 12}
CKPT_LAYERS = 4          # phase 13b: full width, 4 layers
CKPT_POOL = 160          # pages: a checkpoint of a few hundred MB
CKPT_EVERY, CKPT_KILL = 8, 10


def fault_plan():
    from repro_torch.launch.faults import FaultPlan
    s = FAULT_STEPS
    return (FaultPlan()
            .preempt(s["park"], slot=0).pool_squeeze(s["park"], 10 ** 6)
            .corrupt_page(s["corrupt"], 0)
            .preempt(s["second"], slot=1)
            .crash_step(s["crash"])
            .pool_restore(s["restore"]))


class SwapClock:
    """Host-clock timing of the swap path inside one serve: each wrapped
    call (outermost only) is timed between ``torch.cuda.synchronize()``
    calls, with the crc32 time and bytes spent inside it; ``at`` and
    ``serve_step`` marks time the crash from its event to the next
    decode step, and ``init_cache`` marks device memory around the
    rebuild."""

    def __init__(self, torch):
        self.torch = torch
        self.rows = []          # (kind, ms, crc ms, crc bytes, pins)
        self.depth = 0
        self.crc_ms = self.crc_bytes = 0.0
        self.marks = {}

    def _sync_ms(self):
        self.torch.cuda.synchronize()
        return 1e3 * time.perf_counter()

    def timed(self, owner, name, kind):
        fn = getattr(owner, name)

        def wrapped(*a, **kw):
            top = self.depth == 0
            if top:
                self.crc_ms = self.crc_bytes = 0.0
                t = self._sync_ms()
            self.depth += 1
            try:
                out = fn(*a, **kw)
            finally:
                self.depth -= 1
            if top:
                pins = (int((out["resident"] >= 0).sum())
                        if kind == "swap_out" else 0)
                self.rows.append((kind, self._sync_ms() - t, self.crc_ms,
                                  self.crc_bytes, pins))
            return out
        return fn, wrapped

    def crc(self, fn):
        def wrapped(payload):
            t = time.perf_counter()
            out = fn(payload)
            self.crc_ms += 1e3 * (time.perf_counter() - t)
            self.crc_bytes += sum(v.nbytes for v in payload.values())
            return out
        return wrapped

    def mark(self, key, fn, when=lambda *a: True, memory=False):
        def wrapped(*a, **kw):
            if when(*a) and key + "_in" not in self.marks:
                self.marks[key + "_in"] = self._sync_ms()
                if memory:
                    self.marks[key + "_mem_in"] = \
                        self.torch.cuda.memory_allocated()
                out = fn(*a, **kw)
                self.marks[key + "_out"] = self._sync_ms()
                if memory:
                    self.marks[key + "_mem_out"] = \
                        self.torch.cuda.memory_allocated()
                return out
            return fn(*a, **kw)
        return wrapped

    def summary(self, kind):
        rows = [r for r in self.rows if r[0] == kind]
        ms = sum(r[1] for r in rows)
        crc_ms = sum(r[2] for r in rows)
        nbytes = sum(r[3] for r in rows)
        return len(rows), ms, crc_ms, nbytes


@contextlib.contextmanager
def swap_clock(torch, fp):
    """Install a ``SwapClock`` over the allocator's swap methods, the
    payload checksum, the plan capture / restore, ``fp``'s ``at`` (the
    crash event), ``serve_step`` (the first step after it) and
    ``init_cache`` (memory around the rebuild); undo on exit."""
    from repro_torch.core import paging
    from repro_torch.models import decode as dec
    clock = SwapClock(torch)
    patches = [(paging.PageAllocator, n, *clock.timed(
        paging.PageAllocator, n, n)) for n in
        ("swap_out", "swap_to_full", "swap_in", "verify_handle")]
    patches += [(dec, n, *clock.timed(dec, n, n))
                for n in ("capture_plan_state", "restore_plan_state")]
    crc = paging._payload_checksums
    patches.append((paging, "_payload_checksums", crc, clock.crc(crc)))
    crash = FAULT_STEPS["crash"]
    at = fp.at
    fp.at = clock.mark("crash", at, lambda step: step == crash, memory=True)
    step = dec.serve_step
    patches.append((dec, "serve_step", step, clock.mark(
        "after_crash", step, lambda *a: "crash_in" in clock.marks)))
    init = dec.init_cache
    patches.append((dec, "init_cache", init, clock.mark(
        "rebuild", init, lambda *a: "crash_in" in clock.marks,
        memory=True)))
    for owner, name, _, new in patches:
        setattr(owner, name, new)
    try:
        yield clock
    finally:
        for owner, name, old, _ in patches:
            setattr(owner, name, old)
        fp.at = at


def crc_rates(tag, nbytes=128 * 2 ** 20, reps=3):
    """The host's crc32 rate over one swap-sized payload: the port's
    ``_payload_checksums`` (the buffer in place) against the same sum
    over a ``tobytes()`` copy, in turns."""
    import zlib
    from repro_torch.core.paging import _payload_checksums
    a = np.random.default_rng(0).integers(-2 ** 15, 2 ** 15, nbytes // 2,
                                          dtype=np.int16)
    forms = {"in place": lambda: _payload_checksums({"a": a})["a"],
             "tobytes copy": lambda: zlib.crc32(a.tobytes())}
    best = {}
    for _ in range(reps):
        for name, fn in forms.items():
            t = time.perf_counter()
            crc = fn()
            best[name] = min(best.get(name, 1e9), time.perf_counter() - t)
            assert crc == zlib.crc32(a.tobytes()), name
    log(f"[faults] host crc32 over {nbytes / 1e6:.1f} MB (best of {reps}): "
        + ", ".join(f"{n} {nbytes / t / 1e9:.3f} GB/s"
                    for n, t in best.items()) + f" {tag}")


def fault_phase(torch, sd, cfg, model, opts, phase11, tag):
    """Phase 13a: phase 11's workload (prefix cache on, PREFIX_LAYERS) under
    ``fault_plan()``: the token streams must equal phase 11's, with two
    or more host swaps whose handles pin shared prefix pages, one crash
    restored from host swap, the corrupted handle quarantined, no
    requeue and no cold re-plan, the paged kernel launched layers x
    steps, and the allocator's audit passing after the run."""
    from repro_torch.launch import serve as serve_mod
    sp_opts = dataclasses.replace(opts, shared_prefix_len=SHARED_PREFIX)
    on_cfg = dataclasses.replace(cfg, kv=dataclasses.replace(
        cfg.kv, prefix_cache=True))
    fp = fault_plan()
    allocs = []
    sd.sata_decode_attention_paged_kernel.launches = 0
    sd.sata_decode_attention_kernel.launches = 0
    with recording(serve_mod, "PageAllocator", allocs), \
            swap_clock(torch, fp) as clock:
        out = serve_mod.serve("qwen3-4b", smoke=False, cfg=on_cfg,
                              model=model, options=sp_opts,
                              device=next(model.parameters()).device,
                              faults=fp)
        torch.cuda.synchronize()
    n = sd.sata_decode_attention_paged_kernel.launches
    assert out["outputs"] == phase11["outputs"], \
        "the fault run serves other token streams than phase 11"
    assert n == cfg.n_layers * out["steps"], \
        f"faults: {n} launches != {cfg.n_layers} x {out['steps']}"
    assert sd.sata_decode_attention_kernel.launches == 0
    o = out["page_occupancy"]
    assert o["host_swaps"] >= 2 and o["crashes"] == 1, o
    assert o["corrupt_pages_detected"] == o["corrupt_pages_injected"] == 1, o
    assert o["quarantined_pages"] > 0, o
    assert o["requeue_preemptions"] == 0 and o["swap_cold_replans"] == 0, o
    assert o["audits_run"] > 0, o
    pinned = [r for r in clock.rows if r[0] == "swap_out" and r[4] > 0]
    assert len(pinned) >= 2, "fewer than two swaps pinned shared pages"
    assert len(allocs) == 2, f"{len(allocs)} allocators (crash rebuilds 1)"
    alloc = allocs[-1][2]
    alloc.check_invariants()
    assert not alloc.swapped, "a swap handle is still outstanding"
    log(f"[faults] token streams == phase 11's: True; {out['steps']} "
        f"steps (phase 11: {phase11['steps']}), paged kernel launches {n} "
        f"(= {cfg.n_layers} x {out['steps']}); host swaps "
        f"{o['host_swaps']} ({len(pinned)} pinning shared pages), "
        f"restores {o['swap_restores']}, crashes {o['crashes']}, corrupt "
        f"injected/detected {o['corrupt_pages_injected']}/"
        f"{o['corrupt_pages_detected']}, quarantined pages "
        f"{o['quarantined_pages']}, trie nodes invalidated "
        f"{o['trie_nodes_invalidated']}, requeues "
        f"{o['requeue_preemptions']}, cold re-plans "
        f"{o['swap_cold_replans']}, re-prefilled tokens "
        f"{o['re_prefill_tokens']}, tokens salvaged "
        f"{o['tokens_salvaged']}, host swap bytes peak "
        f"{o['host_swap_bytes_peak']}, {o['audits_run']} audits + the "
        f"final check_invariants passed {tag}")
    for kind in ("swap_out", "swap_to_full", "swap_in", "verify_handle",
                 "capture_plan_state", "restore_plan_state"):
        k, ms, crc_ms, nbytes = clock.summary(kind)
        if not k:
            continue
        line = f"[faults] {kind}: {k} calls, {ms / k:.3f} ms each"
        if nbytes:
            line += (f", {nbytes / k / 1e6:.2f} MB payload each, "
                     f"{nbytes / ms / 1e6:.3f} GB/s, crc32 {crc_ms / k:.3f}"
                     f" ms each ({100 * crc_ms / ms:.1f}% of the call, "
                     f"{nbytes / crc_ms / 1e6:.3f} GB/s)")
        log(line + f" {tag}")
    crc_rates(tag)
    mk = clock.marks
    log(f"[faults] crash → first decode step after it "
        f"{mk['after_crash_in'] - mk['crash_in']:.1f} ms (the swap-outs "
        f"to host, the rebuild {mk['rebuild_out'] - mk['rebuild_in']:.1f}"
        f" ms, the re-admissions that fit); memory_allocated before the "
        f"crash {mk['crash_mem_in'] / 2 ** 30:.3f} GiB, at the rebuild "
        f"(old pool dropped) {mk['rebuild_mem_in'] / 2 ** 30:.3f} GiB, "
        f"after it {mk['rebuild_mem_out'] / 2 ** 30:.3f} GiB; swap restore "
        f"wall {1e3 * o['swap_restore_wall_s']:.1f} ms in all; mean decode "
        f"step {out['step_ms_mean']:.2f} ms (phase 11: "
        f"{phase11['step_ms_mean']:.2f}) {tag}")
    assert mk["rebuild_mem_in"] < mk["crash_mem_in"], \
        "the crash did not drop the device pool"
    return out


def checkpoint_phase(torch, sd, cfg, opts, dev, root, tag):
    """Phase 13b: phase 11's workload at full width and CKPT_LAYERS
    layers, a CKPT_POOL-page pool, under a schedule that parks a swap
    handle across a save: the run killed at CKPT_KILL after a save at
    CKPT_EVERY and resumed from disk serves the streams of the
    uninterrupted run, its cache restored onto the card."""
    import shutil
    from repro_torch.launch import serve as serve_mod
    from repro_torch.launch.faults import FaultPlan
    from repro_torch.models import decode as dec
    from repro_torch.models.model import DenseModel
    c4 = dataclasses.replace(cfg, n_layers=CKPT_LAYERS, kv=dataclasses.replace(
        cfg.kv, prefix_cache=True, pool_pages=CKPT_POOL))
    model = DenseModel(c4, device=dev, seed=0)
    sp_opts = dataclasses.replace(opts, shared_prefix_len=SHARED_PREFIX)
    d = os.path.join(root, "build", "serve_ckpt")
    shutil.rmtree(d, ignore_errors=True)

    def run(**res):
        fp = (FaultPlan().preempt(CKPT_EVERY - 1, slot=0)
              .defer_admission(CKPT_EVERY - 1).defer_admission(CKPT_EVERY))
        t = time.perf_counter()
        out = serve_mod.serve("qwen3-4b", smoke=False, cfg=c4, model=model,
                              options=sp_opts, device=dev, faults=fp,
                              resilience=serve_mod.ResilienceOptions(**res))
        torch.cuda.synchronize()
        return out, time.perf_counter() - t

    try:
        base, t_base = run()
        t = time.perf_counter()
        try:
            run(checkpoint_dir=d, checkpoint_every=CKPT_EVERY,
                kill_at_step=CKPT_KILL)
            raise AssertionError("kill_at_step did not stop the serve")
        except serve_mod.ServeKilled:
            t_kill = time.perf_counter() - t
        sizes = {s: sum(os.path.getsize(os.path.join(p, f))
                        for p, _, fs in os.walk(os.path.join(d, s))
                        for f in fs) for s in sorted(os.listdir(d))}
        caches = []
        with recording(dec, "init_cache", caches):
            out, t_res = run(checkpoint_dir=d, checkpoint_every=CKPT_EVERY,
                             resume=True)
        on_card = all(t.device.type == dev.type for _, _, c in caches
                      for t in _tensors(c))
        del caches
    finally:
        shutil.rmtree(d, ignore_errors=True)
    assert out["checkpoint"]["resumed_at"] == CKPT_EVERY, out["checkpoint"]
    assert out["outputs"] == base["outputs"], \
        "the resumed serve's token streams differ from the uninterrupted run"
    assert on_card, "the resumed cache is not on the card"
    assert base["page_occupancy"]["host_swaps"] >= 1
    log(f"[checkpoint] {CKPT_LAYERS} layers, {CKPT_POOL} pages: killed at "
        f"step {CKPT_KILL} after a save at {CKPT_EVERY}, resumed at "
        f"{out['checkpoint']['resumed_at']}: token streams == the "
        f"uninterrupted run's: True, resumed cache on the card: True; "
        f"checkpoints on disk "
        f"{', '.join(f'{k} {v / 1e6:.1f} MB' for k, v in sizes.items())};"
        f" wall: uninterrupted {t_base:.2f} s, killed run {t_kill:.2f} s, "
        f"resumed run {t_res:.2f} s {tag}")
    del model
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 14: the QoS ladder and cascade retirement
# ---------------------------------------------------------------------------

LADDER_REQUESTS, LADDER_GEN = 12, 32    # through phase 3's 8 slots
# 14a's depth: the per-slot planner runs once a layer, ~1.7 s of each
# ladder step at 36 layers (~0.5 s at 8); 4 keep full width, the
# requests, the spikes and every check, at ~4/36 of the time, so the
# whole run stays inside its time limit on a slow host
LADDER_LAYERS = 4
LADDER_CLEAR = 4
# run 2's loop steps whose per-slot plans are held to the plain budget
# rank: rung 3 (incremental steps, int8 ranking) and rung 1 (an exact
# re-plan every step)
LADDER_PROBE_STEPS = (6, 18)
LADDER_KERNEL_STEP = 6                  # B1's recorded call (rung 3)
RETIRE_POOL = 80        # pages: below the 8 x 17 that the slots need
RETIRE_KEEP, RETIRE_MARK = 0.5, 0.4
# 14b's depth (full width), for the run's time limit: at 36 layers its
# serves took ~190 s of a 1,181 s run on a slow host; the pool
# arithmetic is per layer
RETIRE_LAYERS = 6


def ladder_spikes():
    """The reference bench's spike schedule
    (``benchmarks/bench_decode.py::_bench_degradation``)."""
    from repro_torch.launch.faults import FaultPlan
    return FaultPlan().load_spike(4, 2).slow_step(5).load_spike(10, 1)


@contextlib.contextmanager
def patched(owner, name, make):
    """While open, ``owner.<name>`` is ``make(original)``."""
    fn = getattr(owner, name)
    setattr(owner, name, make(fn))
    try:
        yield fn
    finally:
        setattr(owner, name, fn)


def budget_top(torch, score, valid, k):
    """The plain budget rank: the valid entries whose bf16 score is at or
    above the row's k-th largest bf16 score, found by a sort — ties at
    the edge are admitted, as the bisection's ``bisect_select`` predicate
    admits them."""
    from repro_torch.core.selection import NEG_INF
    v = torch.where(valid, score, NEG_INF).to(torch.bfloat16)
    edge = v.sort(dim=-1, descending=True).values[..., k - 1:k]
    return valid & (v >= edge)


def model_device(model):
    return next(model.parameters()).device


class BudgetProbe:
    """Holds the per-slot planner calls of the steps in ``steps`` whose
    slot sits at a narrowed ``budget`` (the first ``limit`` of each kind
    a step: layer 0's slots) to the plain budget rank: an incremental
    step keeps exactly the blocks ``budget_top`` picks from the Quest
    upper bounds, an exact re-plan exactly those it picks among its
    selected blocks by best token score.  The checks run on the card
    inside the call, on its own inputs, and launch no decode kernel."""

    def __init__(self, torch, p, steps, limit=8):
        from repro_torch.core import decode_plan as dp
        self.torch, self.dp, self.p = torch, dp, p
        self.steps, self.limit = steps, limit
        self.step = -1
        self.seen = {}                  # (step, kind) -> calls checked
        self.rows = {"incremental": 0, "full": 0}

    def _take(self, kind, budget):
        if self.step not in self.steps or budget is None:
            return None
        key = (self.step, kind)
        if self.seen.get(key, 0) >= self.limit:
            return None
        k = int(budget.reshape(-1)[0])
        if k >= self.p:
            return None
        self.seen[key] = self.seen.get(key, 0) + 1
        return k

    def incremental(self, fn):
        torch, dp = self.torch, self.dp

        def wrapped(q, k_cache, plan, pos, **kw):
            out = fn(q, k_cache, plan, pos, **kw)
            k = self._take("incremental", kw.get("budget"))
            if k is not None:
                valid = dp._valid_blocks(plan, pos, kw["k_block"])
                vb = valid[:, None, :, None]
                lo, hi = dp.degraded_summary_bounds(plan, kw.get("quant"))
                ub = dp.block_upper_bounds(
                    q.float(), torch.where(vb, lo, 0.0),
                    torch.where(vb, hi, 0.0),
                    sm_scale=1.0 / np.sqrt(q.shape[-1])).amax(dim=2)
                want = budget_top(torch, ub, valid[:, None, :], k)
                idx, cnt = dp._compact_rows(want, self.p)
                assert torch.equal(idx, out[0]) and torch.equal(cnt, out[1]), \
                    f"step {self.step}: incremental plan at budget {k} is " \
                    f"not the plain budget rank"
                self.rows["incremental"] += int(cnt.numel())
            return out
        return wrapped

    def full(self, fn):
        torch, dp = self.torch, self.dp

        def wrapped(q, k_cache, pos, **kw):
            out = fn(q, k_cache, pos, **kw)
            k = self._take("full", kw.get("budget"))
            if k is not None:
                kb, live = kw["k_block"], kw.get("live_blk")
                s = k_cache.shape[1]
                nkb = s // kb
                idx0, cnt0, _ = fn(q, k_cache, pos, topk_k=kw["topk_k"],
                                   k_block=kb, plan_blocks=nkb,
                                   live_blk=live)
                occ0 = dp._plan_occupancy(idx0, cnt0, nkb)
                keys = k_cache.permute(0, 2, 1, 3).to(
                    torch.float32, memory_format=torch.contiguous_format)
                sc = dp._scores(q, keys, 1.0 / np.sqrt(q.shape[-1]))
                valid = torch.arange(s, device=sc.device) <= pos[:, None]
                if live is not None:
                    valid = valid & live.repeat_interleave(kb, dim=-1)
                sc = torch.where(valid[:, None, None, :], sc,
                                 dp.NEG_INF)
                blk = sc.amax(dim=2).reshape(*occ0.shape, kb).amax(-1)
                want = budget_top(torch, blk, occ0, k)
                idx, cnt = dp._compact_rows(want, kw["plan_blocks"])
                assert torch.equal(idx, out[0]) and torch.equal(cnt, out[1]), \
                    f"step {self.step}: exact re-plan at budget {k} is " \
                    f"not the plain budget rank"
                self.rows["full"] += int(cnt.numel())
            return out
        return wrapped


class KernelProbe:
    """Holds one main-path call of the paged decode kernel (B1; with
    ``paged=False`` the contiguous one, B2) to its plain version (phase
    2's limits), on the call's own inputs, right after the kernel ran:
    the first call after ``arm(check)`` whose inputs ``check`` accepts
    (it returns a note for the log, or None to wait for a later call).
    The kernel's output is the main path's own; the plain version
    launches no kernel, so the launch counts stay the main path's."""

    def __init__(self, torch, sd, paged=True):
        self.torch, self.sd, self.paged = torch, sd, paged
        self.check = None
        self.result = None

    def arm(self, check):
        if self.result is None:
            self.check = check

    def __call__(self, fn):
        torch, sd = self.torch, self.sd

        def held(out, args, kw, note):
            assert torch.isfinite(out).all()
            err, _, off = held_to_plain(torch, sd, out, args, kw,
                                        "the recorded call")
            self.result = (err, off, note)
            self.check = None

        def paged(q, kp, vp, table, idx, cnt, thr, pos):
            out = fn(q, kp, vp, table, idx, cnt, thr, pos)
            note = None if self.check is None else \
                self.check(table, idx, cnt, pos)
            if note is not None:
                held(out, (q, kp, vp, idx, cnt, thr, pos),
                     dict(k_block=kp.shape[1], page_table=table), note)
            return out

        def contiguous(q, k, v, idx, cnt, thr, pos, *, k_block):
            out = fn(q, k, v, idx, cnt, thr, pos, k_block=k_block)
            note = None if self.check is None else \
                self.check(None, idx, cnt, pos)
            if note is not None:
                held(out, (q, k, v, idx, cnt, thr, pos),
                     dict(k_block=k_block), note)
            return out
        return paged if self.paged else contiguous


def ladder_phase(torch, sd, serve, cfg, model, opts, tag):
    """Phase 14a: the QoS ladder at plan width SKETCH_BLOCKS, 12 requests
    of 32 tokens through 8 slots: run 1 with the ladder and no faults,
    run 2 with the ladder under ``ladder_spikes()``, run 3 without the
    ladder under the same spikes.  Returns kernel 1's check on a
    recorded call of run 2 and the three runs' launches."""
    from repro_torch.core import decode_plan as dp
    from repro_torch.kernels import ops
    from repro_torch.models import decode as dec
    p = SKETCH_BLOCKS
    lcfg = dataclasses.replace(cfg, sata=dataclasses.replace(
        cfg.sata, decode=dataclasses.replace(cfg.sata.decode, blocks=p),
        qos=dataclasses.replace(cfg.sata.qos, ladder=True,
                                clear_steps=LADDER_CLEAR)))
    off_cfg = dataclasses.replace(lcfg, sata=dataclasses.replace(
        lcfg.sata, qos=dataclasses.replace(lcfg.sata.qos, ladder=False)))
    lopts = dataclasses.replace(opts, n_requests=LADDER_REQUESTS,
                                gen_len=LADDER_GEN)
    run1, n1 = serve_full(torch, sd, serve, lcfg, model, lopts,
                          "ladder, no faults", tag)
    # run 2, watched: every step's degraded rows, the per-slot planner's
    # budget rank on the probe steps, B1 on a recorded call
    probe = BudgetProbe(torch, p, LADDER_PROBE_STEPS)
    kprobe = KernelProbe(torch, sd)
    acc = torch.zeros(6, dtype=torch.int64, device=model_device(model))

    def step_hook(fn):
        def wrapped(model_, cfg_, cache, tokens, pos):
            probe.step += 1
            if probe.step == LADDER_KERNEL_STEP:
                kprobe.arm(lambda table, idx, cnt, pos_: (
                    f"loop step {LADDER_KERNEL_STEP}, kv_counts max "
                    f"{int(cnt.max())} mean {float(cnt.float().mean()):.2f}"))
            out = fn(model_, cfg_, cache, tokens, pos)
            plan = cache["kv"]["plan"]
            cnt, bud = plan["kv_counts"], plan["budget"][..., None]
            deg = (plan["active"][..., None] & (bud < p)).expand_as(cnt)
            und = (plan["active"][..., None] & (bud >= p)).expand_as(cnt)
            acc.add_(torch.stack([
                deg.sum(), (deg & (cnt > bud)).sum(),
                torch.where(deg, cnt, 0).sum(), und.sum(),
                torch.where(und, cnt, 0).sum(), (cnt > p).sum()]))
            return out
        return wrapped

    with patched(dec, "serve_step", step_hook), \
            patched(dp, "incremental_plan", probe.incremental), \
            patched(dp, "full_replan", probe.full), \
            patched(ops, "sata_decode_attention_paged_kernel", kprobe):
        run2, n2 = serve_full(torch, sd, serve, lcfg, model, lopts,
                              "ladder, spikes", tag,
                              faults=ladder_spikes())
    run3, n3 = serve_full(torch, sd, serve, off_cfg, model, lopts,
                          "ladder off, spikes", tag, faults=ladder_spikes())
    n_deg, n_over, c_deg, n_und, c_und, n_wide = acc.tolist()
    assert n_wide == 0, "a plan named more blocks than its width"
    q, o2, o3 = run2["qos"], run2["page_occupancy"], run3["page_occupancy"]
    assert not run2["timed_out"] and o2["requeue_preemptions"] == 0
    assert o2["preemptions"] == 0, o2["preemptions"]
    assert q["rung_downs"] > 0 and q["rung_ups"] > 0, q
    clean = [r for r, tl in run2["degradation"].items() if not tl]
    assert clean, "every request was degraded"
    for r in clean:
        assert run2["outputs"][r] == run1["outputs"][r], \
            f"request {r} was never degraded but its stream differs"
    assert probe.rows["incremental"] and probe.rows["full"], probe.rows
    assert kprobe.result is not None, "B1's recorded call was not checked"
    assert o3["preemptions"] >= 1 and o3["requeue_preemptions"] == 0
    assert o3["host_swaps"] == o3["preemptions"], o3
    assert n_deg > 0, "no row sat at rung >= 1"
    err, off, note = kprobe.result
    log(f"[ladder] run 2: every request complete, {len(clean)} never "
        f"degraded (requests {clean}) == run 1 bitwise: True; rung_downs "
        f"{q['rung_downs']}, rung_ups {q['rung_ups']}, degraded_steps "
        f"{q['degraded_steps']}, load_spikes {q['load_spikes']}, slow_steps "
        f"{q['slow_steps']}, preemptions {o2['preemptions']}, requeues "
        f"{o2['requeue_preemptions']}, timeouts {len(run2['timed_out'])}; "
        f"run 3 (no ladder): preemptions {o3['preemptions']} = host swaps "
        f"{o3['host_swaps']}, requeues {o3['requeue_preemptions']} {tag}")
    log(f"[ladder] budget rung on the card: (layer, slot, head) rows at "
        f"rung >= 1 over run 2's steps {n_deg}, mean kv_counts "
        f"{c_deg / n_deg:.3f} (rung 0 rows {n_und}, mean "
        f"{c_und / max(n_und, 1):.3f}), rows above the budget of {p // 2} "
        f"{n_over} ({n_over / n_deg:.2%}: bf16 ties at the rank edge); "
        f"plain budget rank == the planner's on "
        f"{probe.rows['incremental']} incremental and {probe.rows['full']} "
        f"exact re-plan rows of steps {LADDER_PROBE_STEPS} {tag}")
    log(f"[ladder] B1 on a recorded call of run 2 ({note}): max_abs_err="
        f"{err:.3e}, {off:.4%} of outputs off the plain version's bits; "
        f"mean decode step: run 1 {run1['step_ms_mean']:.2f} ms, run 2 "
        f"{run2['step_ms_mean']:.2f} ms, run 3 (no ladder, batched "
        f"planner) {run3['step_ms_mean']:.2f} ms {tag}")
    return err, {"14a run 1": n1, "14a run 2": n2, "14a run 3": n3}


def retire_phase(torch, sd, serve, cfg, model, opts, phase3, tag):
    """Phase 14b: phase 3's workload with retirement on (keep
    RETIRE_KEEP, watermark RETIRE_MARK): run 1 on a RETIRE_POOL-page
    pool, watched after every retirement pass and every step; run 2 the
    same with retirement off; run 3, the never-firing twin (phase 3's
    pool, a watermark no slot reaches), must serve ``phase3``'s streams
    (phase 3's workload on this model without retirement).  Returns
    kernel 1's check on a recorded call with holes and the runs'
    launches."""
    from repro_torch.core import decode_plan as dp
    from repro_torch.kernels import ops
    from repro_torch.launch import serve as serve_mod
    from repro_torch.models import decode as dec

    def rcfg(mode, pool, mark=RETIRE_MARK):
        return dataclasses.replace(
            cfg, sata=dataclasses.replace(cfg.sata, retire=dataclasses.replace(
                cfg.sata.retire, mode=mode, keep=RETIRE_KEEP,
                watermark=mark)),
            kv=dataclasses.replace(cfg.kv, pool_pages=pool))

    allocs = []
    kprobe = KernelProbe(torch, sd)
    dev = model_device(model)
    bad = torch.zeros((), dtype=torch.int64, device=dev)
    nkb = opts.max_len // cfg.kv.page_size
    checks = {"passes": 0, "steps": 0, "holes_seen": 0}

    def dead_mask():
        alloc = allocs[0][2]
        m = np.zeros((opts.batch_slots, nkb), bool)
        for i, lps in enumerate(alloc.retired):
            m[i, list(lps)] = True
        return torch.as_tensor(m, device=dev)

    def check_plans(cache, dead, table):
        """No layer's plan names a dead block of an active slot and
        every layer's live mask is the allocator's; with ``table``,
        every hole maps the overflow page in every layer's page table
        on the card (the serve loop pushes the table after a pass)."""
        kv = cache["kv"]
        plan = kv["plan"]
        act = plan["active"][0]                                   # (B,)
        occ = dp._plan_occupancy(plan["kv_indices"], plan["kv_counts"], nkb)
        dead_a = dead & act[:, None]
        bad.add_((occ & dead_a[None, :, None, :]).sum())
        bad.add_(((plan["live_blk"] != ~dead) & act[None, :, None]).sum())
        if table:
            bad.add_((kv["page_table"] != 0)[:, dead_a].sum())

    def retire_hook(fn):
        def wrapped(cfg_, cache, slot, blocks):
            out = fn(cfg_, cache, slot, blocks)
            checks["passes"] += 1
            check_plans(cache, dead_mask(), table=False)

            def holes(table, idx, cnt, pos):
                # a row of an active slot whose table holds a hole
                dead = dead_mask()
                rows = [i for i in range(dead.shape[0])
                        if bool(dead[i].any())]
                if not rows:
                    return None
                i = rows[0]
                lps = dead[i].nonzero()[:, 0]
                assert bool((table[i, lps] == 0).all())
                return (f"slot {i}: {len(lps)} holes, table entries 0, "
                        f"kv_counts {cnt[i].tolist()}")
            kprobe.arm(holes)
            return out
        return wrapped

    def step_hook(fn):
        def wrapped(model_, cfg_, cache, tokens, pos):
            out = fn(model_, cfg_, cache, tokens, pos)
            if allocs:
                dead = dead_mask()
                checks["steps"] += 1
                checks["holes_seen"] = max(checks["holes_seen"],
                                           int(dead.sum()))
                check_plans(cache, dead, table=True)
            return out
        return wrapped

    with recording(serve_mod, "PageAllocator", allocs), \
            patched(dec, "retire_plan", retire_hook), \
            patched(dec, "serve_step", step_hook), \
            patched(ops, "sata_decode_attention_paged_kernel", kprobe):
        on, n1 = serve_full(torch, sd, serve, rcfg("on", RETIRE_POOL),
                            model, opts, f"retire on, {RETIRE_POOL} pages",
                            tag)
    assert len(allocs) == 1, len(allocs)
    alloc = allocs[0][2]
    alloc.check_invariants()
    off, n2 = serve_full(torch, sd, serve, rcfg("off", RETIRE_POOL), model,
                         opts, f"retire off, {RETIRE_POOL} pages", tag)
    twin, n3 = serve_full(torch, sd, serve, rcfg("on", 0, mark=2.0), model,
                          opts, "retire on, never fires", tag)
    assert int(bad) == 0, f"{int(bad)} retired-block violations on the card"
    r, oo, of = on["retirement"], on["page_occupancy"], off["page_occupancy"]
    first = min(t[0][0] for t in r["timelines"].values() if t)
    assert r["pages_reclaimed"] > 0 and first < on["steps"] - 1, r
    assert oo["pages_retired"] == r["pages_reclaimed"]
    assert checks["passes"] == r["events"] > 0, (checks, r["events"])
    assert kprobe.result is not None, "no B1 call over a table with holes"
    # at this page arithmetic admission control, not preemption, sheds
    # the load: retirement must admit more requests at once
    assert oo["preemptions"] <= of["preemptions"], (oo, of)
    assert oo["deferred_claims"] < of["deferred_claims"], (oo, of)
    assert on["steps"] < off["steps"], (on["steps"], off["steps"])
    assert twin["outputs"] == phase3["outputs"], \
        "retirement that never fires serves another stream than without it"
    assert twin["retirement"]["pages_reclaimed"] == 0
    err, off_bits, note = kprobe.result
    log(f"[retire] {RETIRE_POOL}-page pool, keep {RETIRE_KEEP}, watermark "
        f"{RETIRE_MARK}: {r['events']} retirement events (slot passes), "
        f"{r['pages_reclaimed']} pages reclaimed ({r['retired_tokens']} "
        f"tokens), first at loop step {first} of {on['steps']}; retire on "
        f"vs off: steps {on['steps']} vs {off['steps']}, preemptions "
        f"{oo['preemptions']} vs {of['preemptions']}, deferred claims "
        f"{oo['deferred_claims']} vs {of['deferred_claims']}, stalled "
        f"steps {oo['stalled_steps']} vs {of['stalled_steps']}, pages "
        f"held at peak {oo['pages_in_use_peak']} vs "
        f"{of['pages_in_use_peak']}; retire pass {on['retire_pass_ms_mean']:.2f}"
        f" ms mean on the host clock; mean decode step "
        f"{on['step_ms_mean']:.2f} vs {off['step_ms_mean']:.2f} ms {tag}")
    log(f"[retire] on the card after each of {checks['passes']} passes and "
        f"each of {checks['steps']} steps: no plan of any layer names a "
        f"retired block, every layer's live mask is the allocator's, every "
        f"hole (up to {checks['holes_seen']} at once) maps page 0; "
        f"check_invariants after the run passed; never-firing twin == "
        f"the run without retirement bitwise: True; head importance "
        f"{[round(x, 1) for x in r['head_importance']]} {tag}")
    log(f"[retire] B1 on a recorded call over a table with holes ({note}): "
        f"max_abs_err={err:.3e}, {off_bits:.4%} of outputs off the plain "
        f"version's bits {tag}")
    return err, {"14b run 1": n1, "14b run 2": n2, "14b run 3": n3}


def overload_phases(torch, sd, serve, cfg, opts, dev, tag):
    """Phase 14a on a fresh full-width model cut to LADDER_LAYERS layers,
    14b on one cut to RETIRE_LAYERS (first phase 3's workload on it
    without retirement, the stream its never-firing twin must serve);
    returns kernel 1's launches on their paths and its error on their
    recorded calls."""
    from repro_torch.models.model import DenseModel
    lcfg = dataclasses.replace(cfg, n_layers=LADDER_LAYERS)
    log(f"[ladder] depth cut: {LADDER_LAYERS} of qwen3-4b's "
        f"{cfg.n_layers} layers at full width (the per-slot planner's "
        f"time scales with the layers); requests, spikes and checks as "
        f"before")
    model = DenseModel(lcfg, device=dev, seed=0)
    err_a, n_a = ladder_phase(torch, sd, serve, lcfg, model, opts, tag)
    del model
    torch.cuda.empty_cache()
    rcfg = dataclasses.replace(cfg, n_layers=RETIRE_LAYERS)
    log(f"[retire] depth cut: {RETIRE_LAYERS} of qwen3-4b's "
        f"{cfg.n_layers} layers at full width; workload, pools and checks "
        f"as before, the never-firing twin held to phase 3's workload "
        f"served at this depth")
    model = DenseModel(rcfg, device=dev, seed=0)
    base, n0 = serve_full(torch, sd, serve, rcfg, model, opts,
                          f"retire baseline, {RETIRE_LAYERS} layers", tag)
    err_b, n_b = retire_phase(torch, sd, serve, rcfg, model, opts, base,
                              tag)
    del model
    torch.cuda.empty_cache()
    return {"paths": {**n_a, "14b baseline": n0, **n_b},
            "recorded_calls": {"14a": err_a, "14b": err_b}}


# ---------------------------------------------------------------------------
# phases 15-16: the rest of the dense family and the moe family
# ---------------------------------------------------------------------------

# qwen3-moe-235b-a22b at full width holds 3 x 128 x 4096 x 1536 bf16 expert
# weights a layer (4.83 GB), 0.14 GB of attention, 2.49 GB of embeddings:
# 12 of its 94 layers are ~62 GB of the card's 80 GB, with room left for
# the page pool, the prefill's workspace and the init's fp32 temporaries;
# 8 (~42 GB) since the whole run took 1,175.5 s of its 1,200 on a slow
# host
MOE_LAYERS = 8
MOE_TOL = 2e-2          # bf16 moe FFN output: index form vs one-hot einsums
MOE_PROBE_STEP = 10     # the decode step whose layer-0 FFN call is held


def serve_cfg(base, layout="paged"):
    """Phase 3's serving settings on ``base``: SATA decode on, bisect,
    decode block = page = 64, an exact re-plan every step."""
    from repro_torch.models.config import KVCacheConfig, SataDecodeConfig
    return dataclasses.replace(
        base, topk_impl="bisect",
        sata=dataclasses.replace(base.sata, decode=SataDecodeConfig(
            mode="on", block=64, replan=1)),
        kv=KVCacheConfig(layout=layout,
                         page_size=64 if layout == "paged" else 0))


def serve_layouts(torch, sd, serve, cfg, model, opts, label, tag,
                  wrap=contextlib.nullcontext, fewer_tiles=True):
    """Serve ``opts`` paged, then contiguous (vlm: contiguous only, the
    reference's one layout for it; ``wrap(layout)`` open around each
    run): every request complete with in-vocabulary tokens, the layout's
    kernel launched self-attention layers × decode steps times (hybrid:
    the shared block's applications, n_layers / hybrid_period) and the
    other never, fewer tiles fetched than dense (no more with
    ``fewer_tiles=False``: at a short context nearly every block holds a
    selected key), and equal token streams.  Returns {layout: (report,
    launches)}."""
    kv_layers = (cfg.n_layers // cfg.hybrid_period
                 if cfg.family == "hybrid" else len(model.layers))
    layouts = ("contiguous",) if cfg.family == "vlm" \
        else ("paged", "contiguous")
    runs = {}
    for layout in layouts:
        lcfg = cfg if layout == "paged" else serve_cfg(cfg, "contiguous")
        sd.sata_decode_attention_kernel.launches = 0
        sd.sata_decode_attention_paged_kernel.launches = 0
        torch.cuda.reset_peak_memory_stats()
        with wrap(layout):
            out = serve(cfg.name, smoke=False, cfg=lcfg, model=model,
                        options=opts, device=model_device(model))
        torch.cuda.synchronize()
        n_paged = sd.sata_decode_attention_paged_kernel.launches
        n_contig = sd.sata_decode_attention_kernel.launches
        outs = out["outputs"]
        assert sorted(outs) == list(range(opts.n_requests)), sorted(outs)
        for r, toks in outs.items():
            assert len(toks) == opts.gen_len, (r, len(toks))
            assert all(0 <= x < cfg.vocab_size for x in toks), r
        want = kv_layers * out["steps"]
        got, other = (n_paged, n_contig) if layout == "paged" \
            else (n_contig, n_paged)
        assert got == want, f"{label} {layout}: {got} launches != {want}"
        assert other == 0, f"{label} {layout}: the other layout's kernel ran"
        f = out["decode_fetch"]
        if fewer_tiles:
            assert f["kv_fetch_tiles_plan"] < f["kv_fetch_tiles_dense"], f
        assert f["kv_fetch_tiles_plan"] <= f["kv_fetch_tiles_dense"], f
        occ = out.get("page_occupancy", {})
        miss = out["prefill_ms_mean"]["miss"]
        log(f"[{label}] {layout}: {out['tokens_generated']} tokens, "
            f"{out['steps']} decode steps, {out['tok_per_s']:.2f} tok/s, "
            f"mean decode step {out['step_ms_mean']:.2f} ms, mean prefill "
            f"{'none' if miss is None else f'{miss:.1f} ms'}, kernel launches "
            f"{got} (= {kv_layers} layers x {out['steps']} steps), "
            f"fetch reduction {f['fetch_reduction']:.3f}x "
            f"({f['kv_fetch_tiles_plan']} vs {f['kv_fetch_tiles_dense']} "
            f"tiles), peak pages {occ.get('pages_in_use_peak', 'n/a')}/"
            f"{occ.get('n_pages', 'n/a')}, peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB {tag}")
        runs[layout] = (out, got)
    if len(runs) == 2:
        assert runs["paged"][0]["outputs"] == \
            runs["contiguous"][0]["outputs"], \
            f"{label}: paged and contiguous token streams differ"
        log(f"[{label}] paged == contiguous token streams: True")
    return runs


def describe(cfg) -> str:
    return (f"{cfg.n_layers} layers, d_model {cfg.d_model}, {cfg.n_heads}/"
            f"{cfg.n_kv_heads} heads x {cfg.hd}, d_ff {cfg.d_ff}, vocab "
            f"{cfg.vocab_size}, norm {cfg.norm_type}, qk_norm {cfg.qk_norm}, "
            f"{cfg.dtype}")


OLMO_LAYERS = 6          # phase 15: full width, 6 of olmo-1b's 16 layers


def olmo_phase(torch, sd, serve, opts, dev, tag):
    """Phase 15: olmo-1b at full width (the repo's config, the
    non-parametric norm, G = 1) and OLMO_LAYERS layers, random weights
    from a seed, phase 3's workload paged then contiguous.  Returns the
    paged kernel's launches."""
    from repro_torch.configs.archs import ARCHS
    from repro_torch.models.model import DenseModel
    cfg = serve_cfg(dataclasses.replace(ARCHS["olmo-1b"],
                                        n_layers=OLMO_LAYERS))
    model = DenseModel(cfg, device=dev, seed=0)
    assert not any(".ln" in n or "final_ln" in n
                   for n, _ in model.named_parameters())
    log(f"[olmo] olmo-1b: {describe(cfg)}; random weights (seed 0)")
    runs = serve_layouts(torch, sd, serve, cfg, model, opts, "olmo", tag)
    del model
    torch.cuda.empty_cache()
    return runs["paged"][1]


class MoEProbe:
    """Wraps ``models.decode.moe_apply`` in a serve: CUDA events around
    every call (decode and prefill apart), the routing's drops (device
    counters, read once at the end), and the arguments and outputs of
    one decode call (layer 0 of decode step MOE_PROBE_STEP) and one
    prefill call (the first) for the check against the one-hot form."""

    def __init__(self, torch, n_layers):
        self.torch, self.n_layers = torch, n_layers
        self.events = {"decode": [], "prefill": []}
        self.dropped_pairs = self.dropped_tokens = None
        self.routed = 0
        self.calls = {"decode": 0, "prefill": 0}
        self.recorded = {}

    def route(self, fn):
        def wrapped(p, cfg, tokens):
            r = fn(p, cfg, tokens)
            if tokens.shape[1] < cfg.moe_group_size:      # a decode group
                pairs, toks = (~r.keep).sum(), (~r.keep).all(-1).sum()
                if self.dropped_pairs is None:
                    self.dropped_pairs, self.dropped_tokens = pairs, toks
                else:
                    self.dropped_pairs += pairs
                    self.dropped_tokens += toks
                self.routed += r.keep.numel()
            return r
        return wrapped

    def apply(self, fn):
        torch = self.torch

        def wrapped(p, cfg, x):
            kind = "decode" if x.shape[1] == 1 else "prefill"
            a, z = (torch.cuda.Event(enable_timing=True),
                    torch.cuda.Event(enable_timing=True))
            a.record()
            y, aux = fn(p, cfg, x)
            z.record()
            self.events[kind].append((a, z))
            step = self.calls[kind] // self.n_layers
            if kind not in self.recorded and (
                    kind == "prefill" or step == MOE_PROBE_STEP):
                self.recorded[kind] = (p, x.clone(), y.clone())
            self.calls[kind] += 1
            return y, aux
        return wrapped

    def ms(self, kind):
        self.torch.cuda.synchronize()
        return sum(a.elapsed_time(z) for a, z in self.events[kind])


def check_moe_call(torch, cfg, p, x, y, label):
    """The recorded FFN call: the index form again on its input (bitwise
    its recorded output) against ``moe_apply_ref``, the reference's
    one-hot einsums in plain PyTorch: equal expert ids and kept mask, the
    output within MOE_TOL."""
    from repro_torch.models import moe
    with torch.inference_mode():            # as the serve that recorded it
        again, _ = moe.moe_apply(p, cfg, x)
        r = moe.route(p, cfg, moe._groups(cfg, x))
        want, _, ids, keep = moe.moe_apply_ref(p, cfg, x)
    torch.cuda.synchronize()
    assert torch.equal(again, y), f"{label}: a second run differs"
    assert torch.equal(r.expert_ids, ids), f"{label}: expert ids differ"
    assert torch.equal(r.keep, keep), f"{label}: kept masks differ"
    assert torch.isfinite(y).all()
    err = float((y.float() - want.float()).abs().max())
    off = float((y != want).float().mean())
    log(f"[moe] {label} ({x.shape[0] * x.shape[1]} tokens, "
        f"{ids.shape[0]} group(s) of {ids.shape[1]}, capacity {r.cap}): "
        f"expert ids and kept mask == "
        f"the one-hot form; {int((~keep).sum())} of {keep.numel()} "
        f"(token, k-slot) pairs dropped; output max_abs_err={err:.3e} "
        f"(tol {MOE_TOL:g}), {off:.4%} of outputs off its bits")
    assert err <= MOE_TOL, f"{label}: {err} > {MOE_TOL}"


def moe_phase(torch, sd, serve, opts, dev, tag, n_layers=MOE_LAYERS):
    """Phase 16: qwen3-moe-235b-a22b at full width cut to ``n_layers``
    layers (random weights from a seed), phase 3's workload paged then
    contiguous through the decode kernel at G = 16.  Checks the streams,
    the launches, the kernel against its plain version on one recorded
    call, and one decode and one prefill FFN call against the one-hot
    form; reports the step, the FFN's share of it, prefill and the
    capacity drops.  Returns the paged run's report and the kernel's error
    on the recorded call."""
    from repro_torch.configs.archs import ARCHS
    from repro_torch.kernels import ops
    from repro_torch.models import decode as dec
    from repro_torch.models import moe
    from repro_torch.models.model import DenseModel
    full = ARCHS["qwen3-moe-235b-a22b"]
    cfg = serve_cfg(dataclasses.replace(full, n_layers=n_layers))
    g = cfg.n_heads // cfg.n_kv_heads
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t = time.time()
    model = DenseModel(cfg, device=dev, seed=0)
    torch.cuda.synchronize()
    weights = sum(p.numel() * p.element_size() for p in model.parameters())
    log(f"[moe] qwen3-moe-235b-a22b: {describe(cfg)}, {cfg.n_experts} "
        f"experts, top-{cfg.experts_per_token}, group {cfg.moe_group_size}, "
        f"capacity factor {cfg.capacity_factor}, G = {g}; depth cut "
        f"{full.n_layers} -> {n_layers} layers (the most whose weights fit "
        f"one 80 GB card with the serving state); random weights (seed 0) "
        f"{weights / 1e9:.2f} GB built in {time.time() - t:.1f} s; device "
        f"memory allocated before {before / 2 ** 30:.2f} GiB {tag}")
    probes = {}
    kprobe = KernelProbe(torch, sd)
    kprobe.arm(lambda table, idx, cnt, pos: (
        f"kv_counts max {int(cnt.max())} mean "
        f"{float(cnt.float().mean()):.2f}"))

    @contextlib.contextmanager
    def wrap(layout):
        probes[layout] = probe = MoEProbe(torch, cfg.n_layers)
        with patched(dec, "moe_apply", probe.apply), \
                patched(moe, "route", probe.route), \
                patched(ops, "sata_decode_attention_paged_kernel", kprobe):
            yield

    runs = serve_layouts(torch, sd, serve, cfg, model, opts, "moe", tag,
                         wrap=wrap)
    peak = torch.cuda.max_memory_allocated()
    assert kprobe.result is not None, "B1's recorded call was not checked"
    kerr, koff, note = kprobe.result
    log(f"[moe] B1 on a recorded call at G = {g} ({note}): max_abs_err="
        f"{kerr:.3e}, {koff:.4%} of outputs off the bits of the plain model "
        f"of its split")
    out, _ = runs["paged"]
    probe = probes["paged"]
    steps = out["steps"]
    dec_ms, pre_ms = probe.ms("decode"), probe.ms("prefill")
    assert probe.calls["decode"] == n_layers * steps, probe.calls
    dropped, gone = int(probe.dropped_pairs), int(probe.dropped_tokens)
    for kind in ("decode", "prefill"):
        p, x, y = probe.recorded[kind]
        check_moe_call(torch, cfg, p, x, y,
                       f"recorded {kind} call (layer 0)")
    log(f"[moe] paged: mean decode step {out['step_ms_mean']:.2f} ms, of "
        f"it the moe FFN {dec_ms / steps:.2f} ms a step on CUDA events "
        f"({100 * dec_ms / steps / out['step_ms_mean']:.1f}%; "
        f"{n_layers} layers, every expert's weights read each step); "
        f"prefill {out['prefill_ms_mean']['miss']:.1f} ms a request, of it "
        f"the moe FFN {pre_ms / opts.n_requests:.1f} ms; capacity drops a "
        f"decode step, over its {n_layers} layers: {dropped / steps:.2f} "
        f"(token, k-slot) pairs of {probe.routed // steps} routed "
        f"({100 * dropped / probe.routed:.2f}%), {gone / steps:.2f} tokens "
        f"with every slot dropped; device "
        f"memory at peak {peak / 2 ** 30:.2f} GiB {tag}")
    del model, runs
    torch.cuda.empty_cache()
    return out, kerr


# ---------------------------------------------------------------------------
# phases 17-19: moe training, the vlm and audio families
# ---------------------------------------------------------------------------

MOE_TRAIN_STEPS = 3
MOE_TRAIN_SEQ = 4096
HEADROOM = 8e9          # bytes phase 17 must leave free on the card
# llama-3.2-vision-90b: 100 layers cut to 25 (20 self in 5 groups of 4,
# 5 cross), ~1.71 GB a layer in bf16 and 4.2 GB of embeddings: ~47 GB
# (35 until the whole run took 1,175.5 s of its 1,200 on a slow host)
VLM_LAYERS = 25
# tokens a vlm request generates: 64, cut from 256 when the whole run
# took 1,181 s of its 1,200 on a slow host
VLM_GEN = 64
VLM_PROBE_STEP = 50     # the decode step whose first B2 call is held
VLM_GATE_STEPS = 16     # decode steps of the context-length gate
VLM_GATE_LEN = 1000     # real image tokens of the 1600 in the gate
# whisper's decoder context is 448 tokens (7 pages of 64); a request
# generates 192 of them, cut from 384 with VLM_GEN
WHISPER_GEN, WHISPER_MAX_LEN = 192, 448
WHISPER_PROBE_STEP = 150


def n_params(cfg) -> int:
    from repro_torch.models.model import Model
    return sum(p.numel() for p in Model(cfg, device="meta").parameters())


def moe_train_layers(full) -> int:
    """The most qwen3-moe layers whose training state — bf16 weights and
    gradients, fp32 AdamW moments: 12 bytes a parameter — fits one 80 GB
    card with HEADROOM to spare for the step's activations."""
    n = 1
    while 12 * n_params(dataclasses.replace(full, n_layers=n + 1)) \
            + HEADROOM <= 80e9:
        n += 1
    return n


def moe_train_phase(torch, sa, dev, tag, *, steps=MOE_TRAIN_STEPS,
                    seq=MOE_TRAIN_SEQ):
    """Phase 17: ``train()`` on full-width qwen3-moe-235b-a22b cut to the
    most layers that fit with AdamW state (``moe_train_layers``),
    through the SATA kernel route (block 128, chunked selection), batch
    1, S 4096: finite losses, grad norms and router aux losses, the
    compacted-grid kernel launched layers x steps x 2 (forward and the
    remat recompute), the dense grid never, HEADROOM left on the card.
    Returns B3's launches."""
    from repro_torch.configs.archs import ARCHS
    from repro_torch.launch.train import train
    from repro_torch.models import model as mdl
    full = ARCHS["qwen3-moe-235b-a22b"]
    n_layers = moe_train_layers(full)
    cfg = main_path_cfg(dataclasses.replace(full, n_layers=n_layers,
                                            topk_impl="bisect"))
    state = [12 * n_params(dataclasses.replace(full, n_layers=n)) / 1e9
             for n in (n_layers, n_layers + 1)]
    log(f"[moe-train] qwen3-moe-235b-a22b: {describe(cfg)}, "
        f"{cfg.n_experts} experts, top-{cfg.experts_per_token}; depth cut "
        f"{full.n_layers} -> {n_layers} layer(s): weights, gradients and "
        f"AdamW moments {state[0]:.1f} GB ({state[1]:.1f} GB at "
        f"{n_layers + 1}, over 80 GB less {HEADROOM / 1e9:.0f} GB of "
        f"headroom) {tag}")
    torch.cuda.synchronize()
    reset_attn_counts(sa)
    torch.cuda.reset_peak_memory_stats()
    seen = []
    t = time.time()
    with recording(mdl, "nll_terms", seen):
        out = train("qwen3-moe-235b-a22b", cfg=cfg, steps=steps, batch=1,
                    seq=seq, log_every=1, device=dev)
    torch.cuda.synchronize()
    wall = time.time() - t
    peak = torch.cuda.max_memory_allocated()
    total = torch.cuda.get_device_properties(0).total_memory
    n_b3, n_b4 = attn_counts(sa)
    aux = [float(terms[2].detach()) for _, _, terms in seen]
    log(f"[moe-train] {n_layers} layer(s), batch 1, S {seq}, chunked "
        f"selection, remat full: losses "
        f"{[round(x, 4) for x in out['losses']]}, grad norms "
        f"{[round(x, 4) for x in out['gnorms']]}, router aux "
        f"{[round(x, 5) for x in aux]}")
    log(f"[moe-train] step seconds {[round(x, 3) for x in out['step_s']]}, "
        f"tokens/s {[round(seq / x, 1) for x in out['step_s']]}, peak "
        f"device memory {peak / 2 ** 30:.2f} GiB of {total / 2 ** 30:.2f} "
        f"GiB, {wall:.1f} s in all; compacted-grid launches {n_b3} (= "
        f"{n_layers} layer(s) x {steps} steps x 2: forward + remat "
        f"recompute), dense-grid launches {n_b4} {tag}")
    assert len(aux) == steps, aux
    assert all(np.isfinite(out["losses"])) and all(np.isfinite(out["gnorms"]))
    assert all(np.isfinite(aux)) and all(a > 0 for a in aux), aux
    assert n_b3 == n_layers * steps * 2, \
        f"compacted-grid launches {n_b3} != {n_layers * steps * 2}"
    assert n_b4 == 0, f"the dense grid ran {n_b4} times"
    assert total - peak >= HEADROOM, \
        f"{(total - peak) / 1e9:.1f} GB left, under {HEADROOM / 1e9:.0f}"
    del out
    torch.cuda.empty_cache()
    return n_b3


class CrossClock:
    """CUDA events around every ``cross_attention_decode`` call and
    around ``prefill_context``, and ``step_hook`` called with each
    serving step's index."""

    def __init__(self, torch, step_hook=None):
        self.torch, self.events, self.steps = torch, [], 0
        self.step_hook, self.enc = step_hook, None

    def cross(self, fn):
        torch = self.torch

        def wrapped(*a, **kw):
            e0, e1 = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
            e0.record()
            y = fn(*a, **kw)
            e1.record()
            self.events.append((e0, e1))
            return y
        return wrapped

    def step(self, fn):
        def wrapped(*a, **kw):
            if self.step_hook is not None:
                self.step_hook(self.steps)
            self.steps += 1
            return fn(*a, **kw)
        return wrapped

    def encoder(self, fn):
        """Events around ``prefill_context`` (audio: the encoder)."""
        torch = self.torch

        def wrapped(*a, **kw):
            self.enc = (torch.cuda.Event(enable_timing=True),
                        torch.cuda.Event(enable_timing=True))
            self.enc[0].record()
            out = fn(*a, **kw)
            self.enc[1].record()
            return out
        return wrapped

    def ms(self):
        self.torch.cuda.synchronize()
        return sum(a.elapsed_time(z) for a, z in self.events)


def kv_note(step):
    def note(table, idx, cnt, pos):
        return (f"decode step {step}, pos max {int(pos.max())}, kv_counts "
                f"max {int(cnt.max())} mean {float(cnt.float().mean()):.2f}")
    return note


def context_gate(torch, dec, model, cfg, dev, tag, *, b=2,
                 steps=VLM_GATE_STEPS, length=VLM_GATE_LEN):
    """The reference's context-length gate on the card: two paddings of
    the same image context past ``length`` decode ``steps`` greedy
    steps with bitwise equal logits once ``context_lengths`` is given,
    and differ without it."""
    rng = np.random.default_rng(2)
    s_ctx = cfg.n_image_tokens
    real = rng.standard_normal((b, s_ctx, cfg.d_model)).astype(np.float32)
    pads = []
    for scale in (1.0, 5.0):
        e = real.copy()
        e[:, length:] = scale * rng.standard_normal(
            (b, s_ctx - length, cfg.d_model))
        pads.append(e)
    tok0 = rng.integers(0, cfg.vocab_size, (b, 1))

    def run(embeds, with_lengths):
        batch = {"image_embeds": torch.from_numpy(embeds).to(dev)}
        if with_lengths:
            batch["context_lengths"] = torch.full((b,), length, device=dev)
        with torch.inference_mode():
            cache = dec.init_cache(cfg, b, 512, device=dev)
            dec.prefill_context(model, cfg, cache, batch)
            tok = torch.as_tensor(tok0, dtype=torch.int32, device=dev)
            out = []
            for t in range(steps):
                lg, cache = dec.serve_step(
                    model, cfg, cache, tok,
                    torch.full((b,), t, dtype=torch.int32, device=dev))
                out.append(lg.clone())
                tok = lg[:, 0].argmax(-1, keepdim=True).to(torch.int32)
            return torch.stack(out)

    with_len = [run(e, True) for e in pads]
    without = [run(e, False) for e in pads]
    torch.cuda.synchronize()
    for lg in with_len + without:
        assert torch.isfinite(lg).all()
    same = torch.equal(with_len[0], with_len[1])
    diff = float((without[0] - without[1]).abs().max())
    log(f"[vlm] context-length gate ({b} slots, {length} of {s_ctx} image "
        f"tokens real, {steps} decode steps): with context_lengths the "
        f"two paddings' logits bitwise equal: {same}; without, max |diff| "
        f"{diff:.3e} {tag}")
    assert same, "padded context reached the logits through the mask"
    assert diff > 0, "without lengths the paddings should differ"


def vlm_phase(torch, sd, serve, dev, tag, *, n_layers=VLM_LAYERS,
              gen_len=VLM_GEN):
    """Phase 18: llama-3.2-vision-90b at full width cut to ``n_layers``
    (the self layers in groups, a gated cross layer after each), gates
    opened, random weights from a seed: 16 requests of one prompt token
    through 8 slots on the contiguous cache (the only layout the
    reference serves vlm on), every self layer through B2; one B2 call
    held to its plain version; then the context-length gate.  Returns
    B2's launches."""
    from repro_torch.configs.archs import ARCHS
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import ServeOptions
    from repro_torch.models import attention as attn
    from repro_torch.models import decode as dec
    from repro_torch.models.model import Model, vlm_groups
    full = ARCHS["llama-3.2-vision-90b"]
    cfg = serve_cfg(dataclasses.replace(full, n_layers=n_layers),
                    "contiguous")
    n_cross, per_group = vlm_groups(cfg)
    n_self = n_cross * per_group
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t = time.time()
    model = Model(cfg, device=dev, seed=0)
    with torch.no_grad():
        for cl in model.cross_layers:       # tanh(0) = 0 closes them
            cl.gate.fill_(1.0)
            cl.gate_mlp.fill_(1.0)
    torch.cuda.synchronize()
    weights = sum(p.numel() * p.element_size() for p in model.parameters())
    log(f"[vlm] llama-3.2-vision-90b: {describe(cfg)}, {cfg.n_image_tokens} "
        f"image tokens; depth cut {full.n_layers} -> {n_layers} layers "
        f"({n_self} self in {n_cross} groups of {per_group}, {n_cross} "
        f"cross), gates opened (tanh 1); random weights (seed 0) "
        f"{weights / 1e9:.2f} GB built in {time.time() - t:.1f} s {tag}")
    opts = ServeOptions(n_requests=16, batch_slots=8, prompt_len=1,
                        gen_len=gen_len, max_len=512)
    kprobe = KernelProbe(torch, sd, paged=False)
    clock = CrossClock(torch, lambda i: i == VLM_PROBE_STEP and kprobe.arm(
        kv_note(i)))

    @contextlib.contextmanager
    def wrap(layout):
        with patched(attn, "cross_attention_decode", clock.cross), \
                patched(dec, "serve_step", clock.step), \
                patched(ops, "sata_decode_attention_kernel", kprobe):
            yield

    runs = serve_layouts(torch, sd, serve, cfg, model, opts, "vlm", tag,
                         wrap=wrap, fewer_tiles=False)
    out, n_b2 = runs["contiguous"]
    peak = torch.cuda.max_memory_allocated()
    assert len(clock.events) == n_cross * out["steps"], len(clock.events)
    assert kprobe.result is not None, "B2's recorded call was not checked"
    kerr, koff, note = kprobe.result
    log(f"[vlm] B2 on a recorded call at G = {cfg.n_heads // cfg.n_kv_heads}"
        f" ({note}): max_abs_err={kerr:.3e}, {koff:.4%} of outputs off the "
        f"plain version's bits")
    log(f"[vlm] mean decode step {out['step_ms_mean']:.2f} ms, of it "
        f"cross-attention {clock.ms() / out['steps']:.2f} ms a step on CUDA "
        f"events ({n_cross} layers over {cfg.n_image_tokens} image tokens); "
        f"B2 launches {n_b2} (= {n_self} self layers x {out['steps']} "
        f"steps); weights {weights / 1e9:.2f} GB, device memory at peak "
        f"{peak / 2 ** 30:.2f} GiB {tag}")
    context_gate(torch, dec, model, cfg, dev, tag)
    del model, runs
    torch.cuda.empty_cache()
    return n_b2, kerr


def whisper_phase(torch, sd, serve, dev, tag):
    """Phase 19: whisper-base at full width (6 encoder + 6 decoder
    layers, 8 heads over 8 KV heads of 64: G = 1, D = 64), random
    weights from a seed: the encoder once over each slot's 1500 frames,
    then 16 requests of one prompt token through 8 slots, paged then
    contiguous (B1 and B2 at D = 64): equal token streams; one B1 call
    held to its plain version.  Returns the two kernels' launches."""
    from repro_torch.configs.archs import ARCHS
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import ServeOptions
    from repro_torch.models import attention as attn
    from repro_torch.models import decode as dec
    from repro_torch.models.model import Model
    cfg = serve_cfg(ARCHS["whisper-base"])
    model = Model(cfg, device=dev, seed=0)
    log(f"[whisper] whisper-base: {describe(cfg)}, {cfg.encoder_layers} "
        f"encoder layers over {cfg.encoder_len} frames, mlp "
        f"{cfg.mlp_variant}; random weights (seed 0) {tag}")
    opts = ServeOptions(n_requests=16, batch_slots=8, prompt_len=1,
                        gen_len=WHISPER_GEN, max_len=WHISPER_MAX_LEN)
    kprobe = KernelProbe(torch, sd)
    clocks = {}

    @contextlib.contextmanager
    def wrap(layout):
        clocks[layout] = clock = CrossClock(
            torch, lambda i: layout == "paged" and i == WHISPER_PROBE_STEP
            and kprobe.arm(kv_note(i)))
        with patched(attn, "cross_attention_decode", clock.cross), \
                patched(dec, "serve_step", clock.step), \
                patched(dec, "prefill_context", clock.encoder), \
                patched(ops, "sata_decode_attention_paged_kernel", kprobe):
            yield

    runs = serve_layouts(torch, sd, serve, cfg, model, opts, "whisper", tag,
                         wrap=wrap, fewer_tiles=False)
    assert kprobe.result is not None, "B1's recorded call was not checked"
    kerr, koff, note = kprobe.result
    log(f"[whisper] B1 on a recorded call at G = 1, D = {cfg.hd} ({note}): "
        f"max_abs_err={kerr:.3e}, {koff:.4%} of outputs off the plain "
        f"version's bits")
    for layout, (out, n) in runs.items():
        e0, e1 = clocks[layout].enc
        log(f"[whisper] {layout}: mean decode step {out['step_ms_mean']:.2f}"
            f" ms, of it cross-attention "
            f"{clocks[layout].ms() / out['steps']:.2f} ms a step on CUDA "
            f"events ({cfg.n_layers} layers over {cfg.encoder_len} frames); "
            f"the encoder + cross K/V {e0.elapsed_time(e1):.1f} ms for "
            f"{opts.batch_slots} slots {tag}")
    del model
    torch.cuda.empty_cache()
    return runs["paged"][1], runs["contiguous"][1], kerr


# zamba2: 8 one-token requests through 8 slots, 256 generated over a
# 512-token context (8 pages of 64; rows reach 4), so the planner selects
ZAMBA_GEN, ZAMBA_MAX_LEN = 256, 512
ZAMBA_LAYERS = 24        # of 54: four applications of the shared block
ZAMBA_PROBE_STEP = 200          # the decode step whose first B1 call is held
RWKV_GEN, RWKV_MAX_LEN = 128, 256


def zamba2_phase(torch, sd, serve, dev, tag):
    """Phase 20: zamba2-2.7b at full width, ZAMBA_LAYERS of its 54 Mamba2
    layers (d_model 2560, d_inner 5120, 80 SSM heads x 64, state 64, conv
    4; the shared decoder block after every 6, 6 applications, 32 heads
    over 32 KV heads of 80: G = 1, D = 80), random weights from a seed:
    8 one-token requests through 8 slots, paged then contiguous: equal
    token streams, B1 / B2 launched 6 x steps, one B1 call held to its
    plain version; the mamba layers' and the shared blocks' ms a step
    on CUDA events.  Returns the two kernels' launches and the recorded
    call's error."""
    from repro_torch.configs.archs import ARCHS
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import ServeOptions
    from repro_torch.models import decode as dec
    from repro_torch.models.model import Model
    cfg = serve_cfg(dataclasses.replace(ARCHS["zamba2-2.7b"],
                                        n_layers=ZAMBA_LAYERS))
    t = time.time()
    model = Model(cfg, device=dev, seed=0)
    torch.cuda.synchronize()
    n_shared = cfg.n_layers // cfg.hybrid_period
    nbytes = sum(p.numel() * p.element_size() for p in model.parameters())
    log(f"[zamba2] zamba2-2.7b: {describe(cfg)}, d_inner {cfg.d_inner}, "
        f"{cfg.ssm_heads} SSM heads x {cfg.ssm_head_dim}, state "
        f"{cfg.ssm_state}, conv {cfg.ssm_conv}, the shared block after "
        f"every {cfg.hybrid_period} layers ({n_shared} applications); "
        f"random weights (seed 0), {nbytes / 1e9:.2f} GB, built in "
        f"{time.time() - t:.1f} s {tag}")
    opts = ServeOptions(n_requests=8, batch_slots=8, prompt_len=1,
                        gen_len=ZAMBA_GEN, max_len=ZAMBA_MAX_LEN)
    kprobe = KernelProbe(torch, sd)
    clocks = {}

    @contextlib.contextmanager
    def wrap(layout):
        mamba = CrossClock(torch, lambda i: layout == "paged"
                           and i == ZAMBA_PROBE_STEP
                           and kprobe.arm(kv_note(i)))
        shared = CrossClock(torch)
        clocks[layout] = (mamba, shared)
        with patched(dec, "mamba2_decode", mamba.cross), \
                patched(dec, "shared_block_decode", shared.cross), \
                patched(dec, "serve_step", mamba.step), \
                patched(ops, "sata_decode_attention_paged_kernel", kprobe):
            yield

    runs = serve_layouts(torch, sd, serve, cfg, model, opts, "zamba2", tag,
                         wrap=wrap, fewer_tiles=False)
    assert kprobe.result is not None, "B1's recorded call was not checked"
    kerr, koff, note = kprobe.result
    log(f"[zamba2] B1 on a recorded call at G = 1, D = {cfg.hd} ({note}): "
        f"max_abs_err={kerr:.3e}, {koff:.4%} of outputs off the plain "
        f"version's bits")
    for layout, (out, n) in runs.items():
        mamba, shared = clocks[layout]
        assert len(mamba.events) == cfg.n_layers * out["steps"]
        assert len(shared.events) == n_shared * out["steps"]
        m_ms, s_ms = mamba.ms() / out["steps"], shared.ms() / out["steps"]
        log(f"[zamba2] {layout}: mean decode step {out['step_ms_mean']:.2f}"
            f" ms; on CUDA events the {cfg.n_layers} mamba2_decode calls "
            f"{m_ms:.2f} ms a step ({m_ms / cfg.n_layers:.3f} ms a layer), "
            f"the {n_shared} shared blocks (planner + decode kernel + MLP) "
            f"{s_ms:.2f} ms a step ({s_ms / n_shared:.3f} ms each) {tag}")
    del model
    torch.cuda.empty_cache()
    return runs["paged"][1], runs["contiguous"][1], kerr


def rwkv_phase(torch, sd, sa, serve, dev, tag):
    """Phase 21: rwkv6-1.6b at full width and depth (24 layers, d_model
    2048, 32 heads x 64, d_ff 7168, vocab 65536), random weights from a
    seed, 8 one-token requests through 8 slots on the contiguous layout
    (the family has no KV cache to page): every request complete, every
    step's logits finite; the time mix's share of a step on CUDA
    events.  The family has no attention, so no kernel of the port may
    launch."""
    from repro_torch.configs.archs import ARCHS
    from repro_torch.launch.serve import ServeOptions
    from repro_torch.models import decode as dec
    from repro_torch.models.model import Model
    cfg = ARCHS["rwkv6-1.6b"]
    t = time.time()
    model = Model(cfg, device=dev, seed=0)
    torch.cuda.synchronize()
    nbytes = sum(p.numel() * p.element_size() for p in model.parameters())
    heads = cfg.d_model // cfg.rwkv_head_dim
    log(f"[rwkv6] rwkv6-1.6b: {describe(cfg)}, {heads} heads x "
        f"{cfg.rwkv_head_dim}; random weights "
        f"(seed 0), {nbytes / 1e9:.2f} GB, built in {time.time() - t:.1f} "
        f"s {tag}")
    opts = ServeOptions(n_requests=8, batch_slots=8, prompt_len=1,
                        gen_len=RWKV_GEN, max_len=RWKV_MAX_LEN)
    kernels = (sd.sata_decode_attention_paged_kernel,
               sd.sata_decode_attention_kernel,
               sa.sata_block_attention_compact, sa.sata_block_attention)
    for k in kernels:
        k.launches = 0
    tmix = CrossClock(torch)
    finite = []

    def checked(fn):
        def step(*a, **kw):
            logits, cache = fn(*a, **kw)
            finite.append(torch.isfinite(logits).all())
            return logits, cache
        return step

    torch.cuda.reset_peak_memory_stats()
    with patched(dec, "rwkv6_time_mix", tmix.cross), \
            patched(dec, "serve_step", checked):
        out = serve(cfg.name, smoke=False, cfg=cfg, model=model,
                    options=opts, device=dev)
    torch.cuda.synchronize()
    outs = out["outputs"]
    assert sorted(outs) == list(range(opts.n_requests)), sorted(outs)
    for r, toks in outs.items():
        assert len(toks) == opts.gen_len, (r, len(toks))
        assert all(0 <= x < cfg.vocab_size for x in toks), r
    assert len(finite) == out["steps"] and bool(torch.stack(finite).all()), \
        "non-finite logits"
    launched = [k.launches for k in kernels]
    assert launched == [0, 0, 0, 0], launched
    assert len(tmix.events) == cfg.n_layers * out["steps"]
    t_ms = tmix.ms() / out["steps"]
    share = 100 * t_ms / out["step_ms_mean"]
    log(f"[rwkv6] contiguous: {out['tokens_generated']} tokens, "
        f"{out['steps']} decode steps, {out['tok_per_s']:.2f} tok/s, mean "
        f"decode step {out['step_ms_mean']:.2f} ms, of it the time mix "
        f"{t_ms:.2f} ms on CUDA events ({share:.1f}%, "
        f"{t_ms / cfg.n_layers:.3f} ms a layer); every step's "
        f"logits finite; no kernel of the port launched (the family has "
        f"no attention); peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB {tag}")
    del model
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 22: the paper's scheduler and estimation plane, the quickstart's
# kernel step at a layer's width, and the kernel roofline
# ---------------------------------------------------------------------------

PLANE_SEEDS = (0, 1, 2)
# phase 22 (b): the quickstart's discrete-cluster trace (8 object regions,
# cluster scale 3, noise 0.3, the regime SATA's key sort targets) at
# qwen3-4b's heads and phase 6's mask shape: top-k 128 of 2048 keys
KERNEL_TRACE = dict(n_tokens=2048, k=128, cluster_scale=3.0,
                    discrete_clusters=8, noise=0.3)
ROOF_OCCS = (0.25, 0.5, 0.75)


def padded_tiles(tiled):
    """A tiled plan's local masks zero-padded to S_f x S_f: the masks
    ``coverage_ok`` resolves the sub-heads' local indices against."""
    s = tiled.s_f
    return np.array([np.pad(t.mask, ((0, s - t.mask.shape[0]),
                                     (0, s - t.mask.shape[1])))
                     for t in tiled.tiles])


def plane_phase(torch, dev, tag):
    """Phase 22 (a): the four paper workloads at their published sizes,
    seeds PLANE_SEEDS, masks made on the card: exactly k keys a row, the
    same masks as the CPU makes from the seed, the card's batched
    ``sort_keys`` == ``sort_keys_psum`` on the host head by head,
    ``coverage_ok`` on every schedule, and the reference tests' gates
    on the modeled CIM numbers (SATA beats dense in throughput and
    energy; gated saves energy but not time; MACs between the selected
    work and dense).  Prints the modeled gains beside the paper's and
    ``plan``'s host ms (the one measured time)."""
    from repro_torch.configs.workloads import WORKLOADS
    from repro_torch.core import (HwConfig, coverage_ok, plan,
                                  simulate_dense, simulate_gated,
                                  simulate_schedule, simulate_tiled_sata)
    from repro_torch.core.masks import synthetic_masks
    from repro_torch.core.sorting import sort_keys, sort_keys_psum
    hw = HwConfig()
    for w in WORKLOADS.values():
        rows = []
        for seed in PLANE_SEEDS:
            masks = synthetic_masks(seed, w.trace, w.n_heads, device=dev)
            assert masks.shape == (w.n_heads, w.n_tokens, w.n_tokens)
            assert (masks.sum(-1) == w.k).all(), f"{w.name}: not k a row"
            assert np.array_equal(masks, synthetic_masks(
                seed, w.trace, w.n_heads, device="cpu")), \
                f"{w.name} seed {seed}: card masks != CPU masks"
            order = sort_keys(torch.from_numpy(masks).to(dev)).cpu()
            order = order.numpy()
            for h in range(w.n_heads):
                assert np.array_equal(order[h], sort_keys_psum(masks[h])), \
                    f"{w.name} seed {seed} head {h}: sort_keys != psum"
            t = time.perf_counter()
            p = plan(masks, s_f=w.s_f)
            plan_ms = 1e3 * (time.perf_counter() - t)
            if p.tiled is None:
                assert coverage_ok(p.schedule, masks), w.name
                r = simulate_schedule(p.schedule, w.d_k, hw)
            else:
                assert coverage_ok(p.schedule, padded_tiles(p.tiled)), \
                    w.name
                r = simulate_tiled_sata(p.tiled, w.d_k, hw)
            d = simulate_dense(masks, w.d_k, hw)
            g = simulate_gated(masks, w.d_k, hw)
            gains = (r.throughput_gain(d), r.energy_eff_gain(d))
            assert min(gains) > 1.0, (w.name, seed, gains)
            assert g.latency_cycles == d.latency_cycles, w.name
            assert g.energy_pj < d.energy_pj, w.name
            assert masks.sum() * w.d_k <= r.macs <= d.macs, w.name
            rows.append((*gains, r.throughput_gain(g), r.energy_eff_gain(g),
                         p.stats.glob_q_frac, p.stats.avg_s_h_frac,
                         p.stats.avg_n_decrements, plan_ms))
        m = np.mean(rows, axis=0)
        log(f"[plane] {w.name} (N {w.n_tokens}, {w.n_heads} heads, K "
            f"{w.k}, S_f {w.s_f}, d_k {w.d_k}; seeds {PLANE_SEEDS}): "
            f"modeled CIM gains vs dense throughput {m[0]:.3f}x (paper "
            f"{w.paper_throughput_gain}x), energy {m[1]:.3f}x (paper "
            f"{w.paper_energy_gain}x); vs gated {m[2]:.3f}x, {m[3]:.3f}x; "
            f"GlobQ {m[4]:.3f} (paper {w.paper_glob_q}), S_h/N {m[5]:.4f} "
            f"(paper {w.paper_s_h_frac}), decrements {m[6]:.3f} (paper "
            f"{w.paper_n_dec}); plan {m[7]:.1f} ms on the host clock "
            f"(per seed {[round(x[7], 1) for x in rows]}) {tag}")


def kernel_step_phase(torch, sa, dev, tag):
    """Phase 22 (b): ``kernels.ops.sata_attention`` in mask mode at BH
    32, S 2048, D 128, blocks 128, bf16, on KERNEL_TRACE masks made by
    ``synthetic_masks`` on the card, with and without the SATA sort, on
    both grids.  Launches: B3 and B4 twice each.  Each output against
    ``sata_attention_reference`` within TOL (max abs; the oracle rounds
    p once after the whole softmax, not per tile, so its bits are not
    the kernel's: the share off them is reported); the sorted route's
    recorded B3 and B4 calls against their plain versions with phase 6's
    full limits; B3 == B4 bitwise on each plan.  Returns the launch
    counts and the recorded calls' errors."""
    from repro_torch.core.blockmap import (block_skip_fraction,
                                           sata_block_plan)
    from repro_torch.core.masks import SyntheticTrace, synthetic_masks
    from repro_torch.kernels import ops
    tr = SyntheticTrace(**KERNEL_TRACE)
    bh, s, d = 32, tr.n_tokens, 128
    t = time.perf_counter()
    mask = torch.from_numpy(synthetic_masks(0, tr, bh, device=dev)).to(dev)
    mask_s = time.perf_counter() - t
    assert bool((mask.sum(-1) == tr.k).all()), "masks: not k keys a row"
    g = torch.Generator(device="cpu").manual_seed(22)
    q, k, v = (torch.randn((bh, s, d), generator=g).to(dev, torch.bfloat16)
               for _ in range(3))
    ref = ops.sata_attention_reference(q, k, v, mask)
    outs, skip, rec = {}, {}, {}
    reset_attn_counts(sa)
    for use_sata in (True, False):
        for sch in ("compact", "dense"):
            fn = "_block_attention_" + sch
            with FirstCall(fn) as r:
                out, bm = ops.sata_attention(q, k, v, mask, q_block=128,
                                             k_block=128, use_sata=use_sata,
                                             schedule=sch)
            outs[use_sata, sch] = out
            skip[use_sata] = float(block_skip_fraction(bm))
            if use_sata:
                rec[sch] = recorded_case(torch, sa, r,
                                         dense_grid=sch == "dense")
    torch.cuda.synchronize()
    n_b3, n_b4 = attn_counts(sa)
    log(f"[kernel-step] masks (BH {bh}, S {s}, top-k {tr.k}, "
        f"{tr.discrete_clusters} clusters) on the card in {mask_s:.2f} s; "
        f"block skip sorted {skip[True]:.4f}, unsorted {skip[False]:.4f}; "
        f"launches B3 {n_b3}, B4 {n_b4} {tag}")
    assert (n_b3, n_b4) == (2, 2), (n_b3, n_b4)
    for (use_sata, sch), out in outs.items():
        compare_oracle(torch, f"sata_attention use_sata={use_sata} {sch}",
                       out, ref)
    for use_sata in (True, False):
        same = torch.equal(outs[use_sata, "compact"],
                           outs[use_sata, "dense"])
        log(f"[kernel-step] use_sata={use_sata}: B3 == B4 bitwise: {same}")
        assert same, f"use_sata={use_sata}: B3 != B4"
    del outs, ref
    errs = {}
    for sch, c in rec.items():
        dense_grid = sch == "dense"
        a_k, a_p = admitted_buffer(torch, c), admitted_buffer(torch, c)
        got = run_attn(sa, c, plain=False, dense_grid=dense_grid,
                       admitted=a_k)
        want = run_attn(sa, c, plain=True, dense_grid=dense_grid,
                        admitted=a_p)
        torch.cuda.synchronize()
        errs[sch] = compare(torch, f"{sch} grid on the sorted route's "
                            f"recorded call", got, want, a_k, a_p)
    del rec
    plan_ms = wall_ms(torch, lambda: sata_block_plan(mask, 128, 128),
                      reps=3, warm=1)
    log(f"[kernel-step] sata_block_plan (key sort: {s - 1} sequential "
        f"argmax steps over {bh} heads; query order; occupancy): "
        f"{plan_ms:.1f} ms on the host clock {tag}")
    return (n_b3, n_b4), errs


def compare_oracle(torch, name, got, want):
    """``got`` against the exact top-k oracle: max abs within TOL; the
    share of outputs off the oracle's bits reported."""
    tol = TOL[str(want.dtype).split(".")[-1]]
    assert torch.isfinite(got).all(), f"{name}: non-finite output"
    e = float((got.float() - want.float()).abs().max())
    off = float((got != want).float().mean())
    log(f"[kernel-step] {name} vs sata_attention_reference: max_abs_err="
        f"{e:.3e} (tol {tol:g}), {off:.4%} of outputs off the oracle's bits")
    assert e <= tol, f"{name}: {e} > {tol}"
    return e


def roofline_phase(torch, sa, dev, root, tag):
    """Phase 22 (c): ``launch.roofline.analyse_kernel`` at ROOF_OCCS
    (S 2048, D 64, BH 8, block 128: the reference's defaults) into
    ``build/roofline``, then B4 (dense grid) and B3 (compacted grid, P =
    occ) in block mode on the same ``fixed_occupancy_map`` maps, timed
    as phase 5 times (CUDA events, median, L2 flushed): B3 == B4
    bitwise and B3 against its plain version, the measured B4 / B3
    ratio beside the modeled speedup."""
    from repro_torch.core.blockmap import (compact_kv_plan,
                                           fixed_occupancy_map)
    from repro_torch.launch.roofline import analyse_kernel
    out_dir = os.path.join(root, "build", "roofline")
    g = torch.Generator(device="cpu").manual_seed(23)
    rows = []
    for occ_frac in ROOF_OCCS:
        r = analyse_kernel(occ_frac=occ_frac, out_dir=out_dir, verbose=False)
        sh = r["shape"]
        bh, s, d, blk = sh["bh"], sh["seq"], sh["d"], sh["block"]
        nkb = s // blk
        occ = max(1, int(occ_frac * nkb))
        bm_np = fixed_occupancy_map(np.random.default_rng(0), bh, nkb, nkb,
                                    occ)
        bm = torch.from_numpy(bm_np).to(dev)
        assert int(bm.sum()) * 2 * blk * d * 2 == \
            r["fetch"]["kv_fetch_bytes_compact"], "not the roofline's map"
        q, k, v = (torch.randn((bh, s, d), generator=g).to(dev,
                                                          torch.bfloat16)
                   for _ in range(3))
        idx, cnt = compact_kv_plan(bm, pad_to=occ)
        c = dict(q=q, k=k, v=v, qb=blk, kb=blk, mode="block", causal=False,
                 sel={}, bm=bm, idx=idx, cnt=cnt)
        a_k, a_p = admitted_buffer(torch, c), admitted_buffer(torch, c)
        b3 = run_attn(sa, c, plain=False, admitted=a_k)
        want = run_attn(sa, c, plain=True, admitted=a_p)
        b4 = run_attn(sa, c, plain=False, dense_grid=True)
        torch.cuda.synchronize()
        compare(torch, f"roofline occ {occ_frac} B3", b3, want, a_k, a_p)
        assert torch.equal(b3, b4), f"occ {occ_frac}: B3 != B4"
        ms3 = time_ms(torch, lambda: run_attn(sa, c, plain=False))
        ms4 = time_ms(torch, lambda: run_attn(sa, c, plain=False,
                                              dense_grid=True))
        t = r["terms_s"]
        log(f"[roofline] {r['cell']} ({bh} x {s} x {d}, block {blk}, P "
            f"{occ} of {nkb}): modeled compute {1e3 * t['compute_s']:.4f} "
            f"ms, memory dense {1e3 * t['memory_dense_s']:.4f} ms, compact "
            f"{1e3 * t['memory_compact_s']:.4f} ms, modeled speedup "
            f"{r['modeled_speedup']:.3f}x; measured B4 {ms4:.4f} ms, B3 "
            f"{ms3:.4f} ms, B4 / B3 {ms4 / ms3:.3f}x; B3 == B4 bitwise; "
            f"wrote {os.path.relpath(r['path'], root)} {tag}")
        rows.append({"occ": occ_frac, "b3_ms": ms3, "b4_ms": ms4,
                     "modeled_speedup": r["modeled_speedup"]})
        del q, k, v, b3, b4, want
    return rows


def scheduler_phases(torch, sa, dev, root, tag):
    """Phase 22 (a)-(c); returns B3's and B4's launches in (b), the
    errors of their recorded calls, and (c)'s timings."""
    plane_phase(torch, dev, tag)
    counts, errs = kernel_step_phase(torch, sa, dev, tag)
    torch.cuda.empty_cache()
    return counts, errs, roofline_phase(torch, sa, dev, root, tag)


# ---------------------------------------------------------------------------
# phase 23: two replicas around one cross-replica prefix index
# ---------------------------------------------------------------------------

REPLICA_LAYERS = 6       # phase 23: full width, 6 of qwen3-4b's 36 layers
# what a CPU rehearsal of phase 23's page arithmetic gives (the smoke
# model at page 64, prompt 1024, 1000 shared tokens, 16 requests through
# 8 slots), per replica: replica 0 publishes the 15 full pages of the
# shared prefix, replica 1's first claim migrates them (960 tokens), and
# every other claim hits its own trie at 1000 tokens
REPLICA_EXPECT = {"cross_replica_hits": (0, 1), "migrated_pages": (0, 15),
                  "migrated_tokens": (0, 960),
                  "index_pages_published": (15, 0)}
REPLICA_INDEX = {"pages_indexed": 15, "publishes": 32,
                 "pages_published": 15, "lookups": 32, "remote_hits": 1}


def replica_phase(torch, sd, cfg, opts, dev, tag):
    """Phase 23: ``serve_replicated`` of phase 11's workload (phase 3's
    path, 1000 shared prompt tokens, the prefix cache on) on two replicas
    around one ``SharedPrefixIndex``, model ``cfg`` at random weights
    (seed 0).  Every request completes on both; their streams are equal
    (``serve_replicated``'s own assert); each replica launches the paged
    kernel layers × steps times and the contiguous one never; each
    replica's allocator and trie pass ``check_invariants``; the counts
    equal ``REPLICA_EXPECT`` / ``REPLICA_INDEX``.  Prints each replica's
    step and prefill ms, the migration's host ms against the miss
    prefill it replaces, and the publishes' ms and bytes.  Returns the
    paged kernel's launches over both replicas."""
    from repro_torch.launch import serve as serve_mod
    from repro_torch.models.model import DenseModel
    cfg = dataclasses.replace(cfg, kv=dataclasses.replace(
        cfg.kv, prefix_cache=True))
    sp_opts = dataclasses.replace(opts, shared_prefix_len=SHARED_PREFIX)
    t = time.time()
    model = DenseModel(cfg, device=dev, seed=0)
    torch.cuda.synchronize()
    log(f"[replicas] qwen3-4b: {describe(cfg)}; random weights (seed 0) "
        f"built in {time.time() - t:.1f} s")
    launches = []

    def count(serve):
        def counted(*a, **kw):
            sd.sata_decode_attention_paged_kernel.launches = 0
            sd.sata_decode_attention_kernel.launches = 0
            out = serve(*a, **kw)
            torch.cuda.synchronize()
            launches.append((sd.sata_decode_attention_paged_kernel.launches,
                             sd.sata_decode_attention_kernel.launches))
            return out
        return counted

    tries, idxs = [], []
    t = time.time()
    with recording(serve_mod, "PrefixCache", tries), \
            recording(serve_mod, "SharedPrefixIndex", idxs), \
            patched(serve_mod, "serve", count):
        rep = serve_mod.serve_replicated(
            cfg.name, n_replicas=2, smoke=False, cfg=cfg, model=model,
            options=sp_opts, device=dev)
    wall = time.time() - t
    del model
    torch.cuda.empty_cache()
    assert rep["outputs_equal"] and len(launches) == 2 and len(tries) == 2
    for rid, (out, (n_paged, n_contig), (_, _, trie)) in enumerate(
            zip(rep["replicas"], launches, tries)):
        outs = out["outputs"]
        assert sorted(outs) == list(range(sp_opts.n_requests)), sorted(outs)
        for r, toks in outs.items():
            assert len(toks) == sp_opts.gen_len, (rid, r, len(toks))
            assert all(0 <= x < cfg.vocab_size for x in toks), (rid, r)
        assert n_paged == cfg.n_layers * out["steps"], \
            f"replica {rid}: {n_paged} launches != {cfg.n_layers} x " \
            f"{out['steps']}"
        assert n_contig == 0, f"replica {rid}: the contiguous kernel ran"
        trie.alloc.check_invariants(trie)
        r = out["replica"]
        for k, want in REPLICA_EXPECT.items():
            assert r[k] == want[rid], (rid, k, r[k], want[rid])
        pf, p = out["prefill_ms_mean"], out["prefix_cache"]
        log(f"[replicas] replica {rid}: {out['steps']} decode steps, mean "
            f"decode step {out['step_ms_mean']:.2f} ms, paged kernel "
            f"launches {n_paged} (= {cfg.n_layers} layers x {out['steps']} "
            f"steps), contiguous 0; mean prefill ms: miss {pf['miss']}, hit "
            f"{pf['hit']}, migrated {pf['migrated']}; "
            f"{r['cross_replica_hits']} cross-replica hits "
            f"({r['migrated_pages']} pages, "
            f"{r['migrated_tokens']} tokens), {r['index_pages_published']} "
            f"pages newly indexed; trie hits {p['hits']}/{p['requests']}, "
            f"prefill tokens saved {p['prefill_tokens_saved']}; "
            f"check_invariants passed {tag}")
    assert rep["index"] == REPLICA_INDEX, rep["index"]
    r0, r1 = (out["replica"] for out in rep["replicas"])
    miss = rep["replicas"][0]["prefill_ms_mean"]["miss"]
    publish_mb = (r0["publish_bytes"] + r1["publish_bytes"]) / 1e6
    n_pub = rep["index"]["publishes"]
    log(f"[replicas] migration (host clock): lookup "
        f"{r1['lookup_ms_mean']:.3f} ms a claim + ensure / scatter / "
        f"register {r1['migrate_ms_mean']:.3f} ms for "
        f"{r1['migrated_pages']} pages; the migrated claim's prefill "
        f"{rep['replicas'][1]['prefill_ms_mean']['migrated']:.1f} ms "
        f"against replica 0's miss prefill {miss:.1f} ms {tag}")
    log(f"[replicas] publish (gather + index, host clock): "
        f"{r0['publish_ms_mean']:.3f} / {r1['publish_ms_mean']:.3f} ms "
        f"a request (replica 0 / 1), {publish_mb:.1f} MB gathered over "
        f"{n_pub} publishes ({publish_mb / n_pub:.2f} MB each); the index "
        f"holds {idxs[0][2].host_bytes() / 1e6:.1f} MB on the host; "
        f"streams equal across replicas: True; both replicas "
        f"{wall:.1f} s {tag}")
    return sum(n for n, _ in launches)


# ---------------------------------------------------------------------------
# 24. scale-out on torch.distributed: two gloo ranks on the one card
# ---------------------------------------------------------------------------

MESH_RANKS = 2
MESH_STEPS = 3           # carried decode steps a layout
# qwen3-4b's decode shape (phase 2's main case) and one layer's prefill
# attention (its 32 heads, S 4096, blocks 128, top-k 64, fp32)
MESH_DECODE = dict(b=8, kv=8, g=4, d=128, s=4096, page=64, topk=64)
MESH_SEQ = dict(bh=32, s=4096, d=128, block=128, k_sel=64)
# phase 25: train(mesh=) on full-width qwen3-4b, 2 of its 36 layers, on
# (2, 1) and (1, 2) (vocab-parallel embedding, unembed and loss on the
# latter), and on full-width qwen3-moe-235b-a22b, 1 of its 94 layers
# (phase 17's depth), on (1, 2): 64 of its 128 experts a rank
MESH_TRAIN_LAYERS = 2
MESH_TRAIN_STEPS = 2     # step 0 and one step after an update
MESH_TRAIN = dict(batch=2, seq=4096, steps=MESH_TRAIN_STEPS, seed=0)
MESH_MOE = "qwen3-moe-235b-a22b"
MESH_MOE_LAYERS = 1
MESH_MOE_TRAIN = dict(batch=1, seq=4096, steps=MESH_TRAIN_STEPS, seed=0)
# zamba2-2.7b: 6 of its 54 layers (one application of the shared
# block); rwkv6-1.6b: 2 of its 24 layers, S cut to 1024 (its scan is an
# eager loop over positions), in its bf16 and again in fp32 from the
# same (bf16) weights (MESH_RWKV32): the fp32 run holds the regions to
# MESH_TRAIN_RTOL, and its one-device step 0 is the witness of bf16's
# own rounding error on the bf16 run's weights
MESH_ZAMBA, MESH_ZAMBA_LAYERS = "zamba2-2.7b", 6
MESH_ZAMBA_TRAIN = dict(batch=1, seq=4096, steps=MESH_TRAIN_STEPS, seed=0)
MESH_RWKV, MESH_RWKV_LAYERS = "rwkv6-1.6b", 2
MESH_RWKV32 = MESH_RWKV + " fp32"
MESH_RWKV_TRAIN = dict(batch=1, seq=1024, steps=MESH_TRAIN_STEPS, seed=0)
# (run, mesh shape, context parallelism): qwen3-4b on (1, 2) a second
# time with ``distributed.ctx.set_context_parallel(True)`` under the
# ``seq_shard`` specs (the reference dry run's train layout): a rank runs
# every head on its 2,048 of the 4,096 rows against all 4,096 keys, the
# MLP, embedding and unembed in their regions entered through the
# sequence's all-gather
MESH_TRAIN_RUNS = (("qwen3-4b", (2, 1), False), ("qwen3-4b", (1, 2), False),
                   ("qwen3-4b", (1, 2), True), (MESH_MOE, (1, 2), False),
                   (MESH_ZAMBA, (1, 2), False), (MESH_RWKV32, (1, 2), False),
                   (MESH_RWKV, (1, 2), False))
# the leaves each run gathers over "model" (ShardLayout's docstring):
# zamba2's shared_in only
MESH_GATHERED = {MESH_ZAMBA: 1}
# the one-device runs that take a third step under torch.profiler
MESH_PROFILED = (MESH_ZAMBA, MESH_RWKV)
# qwen3-4b on (1, 2) as this phase measured it before the vocab-parallel
# embedding (both ranks gathered the embedding and unembed and computed
# the whole (B, S, V) logits; H100 80GB HBM3, 700 W): a rank's
# host-staged MB over the 2 steps, peak GiB and step seconds
TP_GATHERED = dict(staged_mb=8022.9, peak_gib=29.73, step_s=(5.74, 6.44))
# bf16 mesh vs one device: every loss and grad norm within phase 8's
# ROUTE_RTOL (the data-parallel and row-parallel sums reorder the bf16
# model's fp32 accumulations; measured up to 1.4e-4 on an H100)
MESH_TRAIN_RTOL = ROUTE_RTOL
# rwkv6's grad norm after the first update: at random weights its
# trajectory is chaotic (ROADMAP C7: a 1e-7 relative weight perturbation
# moves SMOKE rwkv6's later grad norms by 0.56%), so past step 0 it is
# held to the bound C7 set for that trajectory (tests/test_torch_hybrid_
# ssm.py's RWKV_TRAJ_RTOL); its losses and step 0 stay at MESH_TRAIN_RTOL
MESH_RWKV_TRAJ_RTOL = 5e-2
# bf16 rwkv6's step-0 grad norm against one device's: its bf16 rounding
# is amplified past phase 8's limit.  On an H100 one device's own bf16
# step 0 lies 4.17e-2 off fp32 arithmetic on the same weights (the
# witness phase 25 prints), the mesh's 3.82e-2, and the two bf16 runs
# 3.36e-3 apart: held to a quarter of the witness, 3x that gap
MESH_RWKV_BF16_RTOL = 1e-2


def mesh_decode_inputs(torch, dev, shape, seed=24):
    """The bf16 cache (a CUDA generator's draws, so the parent and every
    rank make the same), a shuffled page table and its pool, each row's
    start position spread over the cache as in phase 2, the plan's
    summaries over the keys before it, and MESH_STEPS steps' queries.
    Step i appends the cache's key at start + i."""
    from repro_torch.core.decode_plan import (init_decode_plan,
                                              summaries_from_cache)
    b, kv, g, d, s, page = (shape[n] for n in ("b", "kv", "g", "d", "s",
                                               "page"))
    gen = torch.Generator(device=dev).manual_seed(seed)

    def draw(*size):
        return torch.randn(size, generator=gen, device=dev).to(torch.bfloat16)

    k, v = draw(b, s, kv, d), draw(b, s, kv, d)
    qs = [draw(b, kv, g, d) for _ in range(MESH_STEPS)]
    rng = np.random.default_rng(seed)
    pos0 = torch.tensor(rng.integers(1, s - MESH_STEPS, b), dtype=torch.int32,
                        device=dev)
    nkb = s // page
    table = torch.tensor(rng.permutation(np.arange(1, b * nkb + 1)).reshape(
        b, nkb), dtype=torch.int32, device=dev)
    kp = k.new_zeros((b * nkb + 1, page, kv, d))
    vp = torch.zeros_like(kp)
    kp[table.long()] = k.reshape(b, nkb, page, kv, d)
    vp[table.long()] = v.reshape(b, nkb, page, kv, d)
    plan = init_decode_plan(b, kv, s, d, page, device=dev)
    lo, hi = summaries_from_cache(k, pos0 - 1, k_block=page)
    plan["k_min"].copy_(lo)
    plan["k_max"].copy_(hi)
    return dict(k=k, v=v, kp=kp, vp=vp, table=table, qs=qs, pos0=pos0,
                plan=plan, page=page, topk=shape["topk"])


def mesh_decode_run(torch, step, c, layout):
    """MESH_STEPS carried steps of ``step(qg, k, v, k_new, pos, plan,
    table)`` in ``layout``; returns each step's (out, plan) on the host
    and its ms (CUDA events on the card, the host clock on the CPU)."""
    paged = layout == "paged"
    k, v = (c["kp"], c["vp"]) if paged else (c["k"], c["v"])
    table = c["table"] if paged else None
    rows = torch.arange(c["k"].shape[0], device=c["k"].device)
    plan, outs, ms = c["plan"], [], []
    for i, qg in enumerate(c["qs"]):
        pos = c["pos0"] + i
        k_new = c["k"][rows, pos.long()][:, None]
        t = span(torch, k.device)
        out, plan = step(qg, k, v, k_new, pos, plan, table)
        ms.append(t())
        outs.append((out.cpu(), {n: x.cpu() for n, x in plan.items()}))
    return outs, ms


def span(torch, dev):
    """Start a timer; calling the result gives the ms since: CUDA events
    on a CUDA device, the host clock on the CPU."""
    if dev.type != "cuda":
        t = time.perf_counter()
        return lambda: 1e3 * (time.perf_counter() - t)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()

    def stop():
        end.record()
        end.synchronize()
        return start.elapsed_time(end)
    return stop


def mesh_seq_inputs(torch, dev, shape, seed=25):
    gen = torch.Generator(device=dev).manual_seed(seed)
    return [torch.randn((shape["bh"], shape["s"], shape["d"]), generator=gen,
                        device=dev) for _ in range(3)]


def mesh_train_setup(run_name):
    """Phase 25's arch, model and ``train`` arguments for ``run_name``
    (an arch, or MESH_RWKV32): phase 7's route (the SATA kernel route,
    chunked selection, remat full) at MESH_TRAIN_LAYERS (qwen3-4b),
    MESH_MOE_LAYERS (qwen3-moe), MESH_ZAMBA_LAYERS or MESH_RWKV_LAYERS
    layers, full width, in the arch's dtype (fp32 for MESH_RWKV32)."""
    from repro_torch.configs.archs import ARCHS
    arch = run_name.split()[0]
    n, run = {MESH_MOE: (MESH_MOE_LAYERS, MESH_MOE_TRAIN),
              MESH_ZAMBA: (MESH_ZAMBA_LAYERS, MESH_ZAMBA_TRAIN),
              MESH_RWKV: (MESH_RWKV_LAYERS, MESH_RWKV_TRAIN)}.get(
        arch, (MESH_TRAIN_LAYERS, MESH_TRAIN))
    dtype = "float32" if run_name == MESH_RWKV32 else ARCHS[arch].dtype
    return arch, main_path_cfg(dataclasses.replace(
        ARCHS[arch], topk_impl="bisect", n_layers=n, dtype=dtype)), run


def mesh_train_model(run_name, dev, run):
    """The model ``train`` starts ``run_name`` from: None (the seed's
    own) but for MESH_RWKV32, whose fp32 weights are the bf16 run's."""
    if run_name != MESH_RWKV32:
        return None
    from repro_torch.models.model import Model
    _, cfg, _ = mesh_train_setup(MESH_RWKV)
    return Model(cfg, device=dev, seed=run["seed"]).float()


def mesh_b3_launches(cfg, steps):
    """B3's launches a rank over ``steps`` steps: one per attention call,
    twice for a layer under remat (the forward and the recompute; the
    backward recomputes through the plain version); zamba2's shared
    block runs outside the layers' remat, once every hybrid_period
    layers; rwkv6 has no attention."""
    if cfg.family == "ssm":
        return 0
    if cfg.family == "hybrid":
        return cfg.n_layers // cfg.hybrid_period * steps
    return cfg.n_layers * steps * 2


class RegionProbe:
    """While open, records how many experts each expert product of the
    rank runs (``models.moe._experts``), the vocab width of its logits
    (``models.model.unembed_apply``) and the first routing's top-k
    expert ids (``models.moe.route``: layer 0's in step 0's forward, on
    the host); the calls pass through unchanged."""

    def __init__(self):
        from repro_torch.models import model as mdl
        from repro_torch.models import moe
        self.mods = ((moe, "_experts"), (mdl, "unembed_apply"),
                     (moe, "route"))
        self.experts, self.vocab, self.route = set(), set(), None

    def __enter__(self):
        self.fns = [getattr(m, n) for m, n in self.mods]
        experts, unembed, route = self.fns

        def run_experts(p, xin, *a, **kw):
            self.experts.add(xin.shape[0])
            return experts(p, xin, *a, **kw)

        def run_unembed(*a, **kw):
            out = unembed(*a, **kw)
            self.vocab.add(out.shape[-1])
            return out

        def run_route(*a, **kw):
            out = route(*a, **kw)
            if self.route is None:
                self.route = out.expert_ids.cpu()
            return out
        for (m, n), f in zip(self.mods, (run_experts, run_unembed,
                                         run_route)):
            setattr(m, n, f)
        return self

    def __exit__(self, *exc):
        for (m, n), f in zip(self.mods, self.fns):
            setattr(m, n, f)


def mesh_train_key(name, shape, cp):
    return f"train {name} {shape}{' cp' if cp else ''}"


def mesh_train_rank(torch, dev, res, train_runs):
    """Phase 25 in one rank: ``train(mesh=)`` of each (arch, mesh shape,
    context parallelism) of ``train_runs``, the prefill kernels' counts
    set to 0 just before and read just after; then the rank's first B3
    call held to its plain version."""
    from repro_torch.distributed import ctx
    from repro_torch.distributed.sharding import ShardLayout
    from repro_torch.kernels import sata_attention as sa
    from repro_torch.launch import mesh as M
    from repro_torch.launch.train import train
    cuda = dev.type == "cuda"
    for name, shape, cp in train_runs:
        arch, cfg, run = mesh_train_setup(name)
        model = mesh_train_model(name, dev, run)
        mesh = M.make_train_mesh(*shape, device=dev)
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
        ctx.set_activation_shardings(ctx.make_activation_shardings(
            mesh, cfg, seq_shard=cp), mesh=mesh)
        ctx.set_context_parallel(cp)
        reset_attn_counts(sa)
        t0 = time.time()
        try:
            with FirstCall("_block_attention_compact") as rec, \
                    RegionProbe() as probe:
                out = train(arch, cfg=cfg, model=model, mesh=mesh,
                            log_every=100, **run)
        finally:
            ctx.set_context_parallel(False)
            ctx.clear()
        wall = time.time() - t0
        counts = attn_counts(sa)
        peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
        staged = mesh.host_staged_bytes
        del out["final_state"], model
        err, rows = None, None
        if rec.args is not None:          # rwkv6 calls no kernel
            c = recorded_case(torch, sa, rec, dense_grid=False)
            a_k, a_p = admitted_buffer(torch, c), admitted_buffer(torch, c)
            got = run_attn(sa, c, plain=False, admitted=a_k)
            want = run_attn(sa, c, plain=True, admitted=a_p)
            err = compare(torch, f"B3 on rank {mesh.index}'s "
                          f"{'rows' if cp else 'heads'}, {name} mesh "
                          f"{shape}", got, want, a_k, a_p,
                          attn_window(torch, sa, c))
            rows = tuple(c["q"].shape)
            del c, got, want, a_k, a_p
        del rec
        res[mesh_train_key(name, shape, cp)] = dict(
            losses=out["losses"], gnorms=out["gnorms"], step_s=out["step_s"],
            wall=wall, launches=counts, peak=peak, staged=staged, err=err,
            rows=rows, experts=sorted(probe.experts),
            vocab=sorted(probe.vocab), route=probe.route,
            leaves=ShardLayout(cfg, mesh, cp=cp).counts())


def mesh_rank(rank, world, tmp, device, dshape, sshape, train_runs=(),
              serve_runs=(), cp_runs=()):
    """One rank of phases 24, 25 and 27, started by ``mesh_phase`` (spawn):
    joins the gloo world through a FileStore in ``tmp``, runs the
    tensor-parallel decode steps in both layouts (the kernels' counts set
    to 0 just before each and read just after) and the sequence-sharded
    attention twice (the second timed), then phase 25's training runs
    (``mesh_train_rank``), phase 27's serve steps on the head layout
    (``mesh_serve_rank``, ``CACHE_SEQ_SHARD`` False) and its
    context-parallel job (``mesh_cp_rank``), and saves everything to
    ``tmp/rank<r>.pt``."""
    import torch
    import torch.distributed as dist
    from repro_torch.distributed import sharding
    from repro_torch.kernels import sata_decode as sd
    from repro_torch.launch import mesh as M
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"file://{tmp}/store",
                            rank=rank, world_size=world)
    try:
        dev = torch.device(device)
        mesh = M.make_shard_mesh(world, device=dev)
        c = mesh_decode_inputs(torch, dev, dshape)

        def tp(qg, k, v, k_new, pos, plan, table):
            return M.tensor_parallel_decode_step(
                mesh, qg, k, v, k_new, pos, plan, topk_k=c["topk"],
                k_block=c["page"], page_table=table)

        res = {}
        for layout in ("paged", "contiguous"):
            sd.sata_decode_attention_paged_kernel.launches = 0
            sd.sata_decode_attention_kernel.launches = 0
            res[layout] = mesh_decode_run(torch, tp, c, layout)
            res[f"{layout} launches"] = (
                sd.sata_decode_attention_paged_kernel.launches,
                sd.sata_decode_attention_kernel.launches)
            # the step's copy of the rank's KV / n heads of K and V
            cache = c["kp"] if layout == "paged" else c["k"]
            res[f"{layout} copied"] = 2 * cache.nbytes // world
        res["decode staged"] = mesh.host_staged_bytes
        del c
        q, k, v = mesh_seq_inputs(torch, dev, sshape)
        blk = sshape["block"]
        kw = dict(k_sel=sshape["k_sel"], q_block=blk, k_block=blk)
        first = M.sequence_sharded_attention(mesh, q, k, v, **kw)
        if dev.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
        staged = mesh.host_staged_bytes
        t = span(torch, dev)
        out, stats = M.sequence_sharded_attention(mesh, q, k, v, **kw)
        res["seq ms"] = t()
        res["seq staged"] = mesh.host_staged_bytes - staged
        res["seq peak"] = torch.cuda.max_memory_allocated(dev) \
            if dev.type == "cuda" else 0
        res["seq repeat"] = torch.equal(first[0], out)
        res["seq"] = (out.cpu(), {n: x.cpu() for n, x in stats.items()})
        del q, k, v, first, out, stats
        mesh_train_rank(torch, dev, res, train_runs)
        sharding.CACHE_SEQ_SHARD = False
        mesh_serve_rank(torch, dev, res, tmp, serve_runs)
        mesh_cp_rank(torch, dev, res, tmp, cp_runs)
        torch.save(res, os.path.join(tmp, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def mesh_plain_step(torch, c, sd):
    """The plain single-device step (phase 2's kind: summaries, exact
    re-plan, the decode kernel on every head at once) on a copy of the
    plan; the kernel's output is also held to its plain version on the
    same plan within phase 2's limits."""
    from repro_torch.core.decode_plan import (decode_plan_update,
                                              update_block_summaries)
    from repro_torch.kernels.ops import sata_decode_attention
    errs = []

    def step(qg, k, v, k_new, pos, plan, table):
        plan = {n: x.clone() for n, x in plan.items()}
        update_block_summaries(plan, k_new, pos, k_block=c["page"])
        plan, thr = decode_plan_update(plan, qg, k, pos, topk_k=c["topk"],
                                       k_block=c["page"], page_table=table)
        args = (qg, k, v, plan["kv_indices"], plan["kv_counts"], thr, pos)
        out = sata_decode_attention(*args, k_block=c["page"],
                                    page_table=table)
        errs.append(held_to_plain(
            torch, sd, out, args, dict(k_block=c["page"], page_table=table),
            "the plain single-device step")[0])
        return out, plan
    return step, errs


def mesh_equal(a, b, what):
    """Bitwise equality of a step list [(out, plan), ...] or of a
    sequence result (out, stats)."""
    if isinstance(a, dict):
        assert set(a) == set(b), (what, sorted(a), sorted(b))
        for n in a:
            mesh_equal(a[n], b[n], f"{what} {n}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), what
        for i, (x, y) in enumerate(zip(a, b)):
            mesh_equal(x, y, f"{what}[{i}]")
    else:
        assert a.dtype == b.dtype and a.shape == b.shape and \
            bool((a == b).all()), f"{what}: not bitwise equal"


def mesh_train_reference(torch, dev, tag, names):
    """Phase 25's one-device runs in the parent: ``train()`` of each of
    ``names``' models on the same batches, and for MESH_PROFILED one
    more step under ``torch.profiler`` (``profile_step``); returns, by
    run name, the losses, grad norms, step s and peak memory.  With both
    rwkv6 runs, prints the witness: bf16's step 0 against fp32
    arithmetic on the same weights."""
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.launch.train import train
    cuda = dev.type == "cuda"
    refs = {}
    for name in names:
        arch, cfg, run = mesh_train_setup(name)
        if cuda:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.time()
        with RegionProbe() as probe:
            out = train(arch, cfg=cfg, model=mesh_train_model(name, dev, run),
                        device=dev, log_every=100, **run)
        ref = refs[name] = dict(
            losses=out["losses"], gnorms=out["gnorms"],
            step_s=out["step_s"], route=probe.route,
            peak=torch.cuda.max_memory_allocated(dev) if cuda else 0,
            wall=time.time() - t0)
        if name in MESH_PROFILED and cuda:
            t0 = time.time()
            log(f"[mesh-train] {arch}, one device, a third step:")
            batch = {k: torch.from_numpy(a).to(dev) for k, a in SyntheticLM(
                cfg, run["batch"], run["seq"], seed=1).next_batch().items()}
            profile_step(torch, cfg, out["final_state"], batch, tag,
                         host_ops=cfg.family != "ssm")
            del batch
            log(f"[mesh-train] {arch}: the profiled step and its tables "
                f"{time.time() - t0:.1f} s {tag}")
        del out
        if cuda:
            torch.cuda.empty_cache()
        log(f"[mesh-train] one device: {name} full width, {cfg.n_layers} "
            f"layer(s), batch {run['batch']}, S {run['seq']}, "
            f"{'no attention' if cfg.family == 'ssm' else 'SATA kernel route'}"
            f": losses {ref['losses']}, grad norms {ref['gnorms']}, "
            f"step s {[round(x, 3) for x in ref['step_s']]}, peak memory "
            f"{ref['peak'] / 2 ** 30:.2f} GiB, {cfg.dtype}; train() "
            f"{ref['wall']:.1f} s {tag}")
    if MESH_RWKV in refs and MESH_RWKV32 in refs:
        bf, f32 = refs[MESH_RWKV], refs[MESH_RWKV32]
        log(f"[mesh-train] witness, one device, the same weights: "
            f"{MESH_RWKV} bf16 against fp32 arithmetic at step 0: loss "
            f"{rel(bf['losses'][0], f32['losses'][0]):.3e}, grad norm "
            f"{rel(bf['gnorms'][0], f32['gnorms'][0]):.3e} "
            f"(relative) {tag}")
    return refs


def rel(a, b):
    return abs(a - b) / abs(b)


def mesh_train_check(ranks, refs, train_runs, tag):
    """Phase 25's checks on the ranks' results; returns B3's launches on
    the meshes, summed over the ranks."""
    total = 0
    for name, shape, cp in train_runs:
        arch, cfg, run = mesh_train_setup(name)
        ref, m = refs[name], shape[1]
        want = mesh_b3_launches(cfg, run["steps"])
        key = mesh_train_key(name, shape, cp)
        # context-parallel: the attention's weights gathered over "model"
        # (wq, wk, wv, wo a layer), B3 on the rank's S / m query rows
        gathered = 4 * cfg.n_layers if cp else MESH_GATHERED.get(arch, 0)
        for r, res in enumerate(ranks):
            t = res[key]
            n_b3, n_b4 = t["launches"]
            total += n_b3
            rel_l = [rel(a, b) for a, b in zip(t["losses"], ref["losses"])]
            rel_g = [rel(a, b) for a, b in zip(t["gnorms"], ref["gnorms"])]
            note = ""
            if cfg.moe:        # tokens whose top-k set differs, layer 0
                a, b = (x.sort(dim=-1).values for x in (t["route"],
                                                         ref["route"]))
                moved = int((a != b).any(dim=-1).sum())
                note = (f"; layer 0's step-0 routing: {moved} of "
                          f"{a[..., 0].numel()} tokens with another top-"
                          f"{cfg.experts_per_token} set than one device")
            if name == MESH_RWKV and MESH_RWKV32 in refs:
                g32 = refs[MESH_RWKV32]["gnorms"][0]
                note = (f"; step 0's grad norm against fp32 arithmetic on "
                        f"the same weights {rel(t['gnorms'][0], g32):.3e} "
                        f"(one device's {rel(ref['gnorms'][0], g32):.3e})")
            if (arch, shape, cp) == ("qwen3-4b", (1, 2), False):
                note = (f" (with the embedding gathered: "
                          f"{TP_GATHERED['staged_mb']:,} MB, "
                          f"{TP_GATHERED['peak_gib']} GiB, step s "
                          f"{TP_GATHERED['step_s'][0]}-"
                          f"{TP_GATHERED['step_s'][1]})")
            b3_line = "no B3 call" if t["rows"] is None else (
                f"B3 on the rank's {t['rows'][0]} (B x H) x "
                f"{t['rows'][1]} query rows vs plain max_abs_err "
                f"{t['err']:.3e}" if cp else
                f"B3 on the rank's {t['rows'][0]} (B x H / m) rows vs "
                f"plain max_abs_err {t['err']:.3e}")
            log(f"[mesh-train] rank {r}/{MESH_RANKS} {name} mesh {shape} "
                f"(data, model){', context-parallel' if cp else ''}: "
                f"losses {t['losses']}, grad norms "
                f"{t['gnorms']}; relative to one device: losses "
                f"{[f'{x:.3e}' for x in rel_l]}, grad norms "
                f"{[f'{x:.3e}' for x in rel_g]}; step s "
                f"{[round(x, 3) for x in t['step_s']]} (one device "
                f"{[round(x, 3) for x in ref['step_s']]}; train() "
                f"{t['wall']:.1f} s); peak memory "
                f"{t['peak'] / 2 ** 30:.2f} GiB; host-staged "
                f"{t['staged'] / 1e6:.1f} MB over {run['steps']} steps"
                f"{note}; B3 launches {n_b3} (B4 {n_b4}; derived "
                f"{want}), {b3_line}; experts a product "
                f"{t['experts']} of {cfg.n_experts if cfg.moe else 0}; "
                f"logits width {t['vocab']} of {cfg.vocab_size}; leaves "
                f"{t['leaves']} {tag}")
            assert all(np.isfinite(t["losses"])) and \
                all(np.isfinite(t["gnorms"])), (key, r)
            assert (n_b3, n_b4) == (want, 0), (key, r, n_b3, n_b4, want)
            assert max(rel_l) <= MESH_TRAIN_RTOL, (key, r, rel_l)
            assert rel_g[0] <= (MESH_RWKV_BF16_RTOL if name == MESH_RWKV
                                else MESH_TRAIN_RTOL), (key, r, rel_g)
            assert max(rel_g[1:]) <= (MESH_RWKV_TRAJ_RTOL if cfg.family
                                      == "ssm" else MESH_TRAIN_RTOL), \
                (key, r, rel_g)
            assert t["vocab"] == [cfg.vocab_size // m], (key, r, t["vocab"])
            assert t["experts"] == ([cfg.n_experts // m] if cfg.moe
                                    else []), (key, r, t["experts"])
            assert t["leaves"]["gathered_over_model"] == gathered, \
                (key, r, t["leaves"])
            assert (t["rows"] is None) == (want == 0), (key, r)
            if cp:
                assert t["rows"][1] == run["seq"] // m, (key, r, t["rows"])
        assert ranks[0][key]["losses"] == ranks[1][key]["losses"], key
    return total


# ---------------------------------------------------------------------------
# 27. serve_step on a rank's view of a (data, model) mesh, in phase 24's world
# ---------------------------------------------------------------------------

# qwen3-4b at full width, MESH_SERVE_LAYERS of its 36 layers, 8 slots of
# MESH_SERVE_MAX_LEN, each prefilled on one device with a prompt of
# MESH_SERVE_PROMPTS tokens; then zamba2-2.7b (6 layers: one shared-block
# application), rwkv6-1.6b (2 layers) and qwen3-moe-235b-a22b (1 layer),
# each from an empty cache through MESH_SERVE_WARM one-device steps
MESH_SERVE_LAYERS = 4
MESH_SERVE_MESH = (1, 2)
MESH_SERVE_SLOTS = 8
MESH_SERVE_MAX_LEN = 4096
MESH_SERVE_PROMPTS = (1024, 700, 1500, 333, 2048, 900, 64, 1200)
MESH_SERVE_WARM = 8
# (arch, layers, checked steps, max_len, the bf16 layouts) on
# MESH_SERVE_MESH
MESH_SERVE_RUNS = (
    ("qwen3-4b", MESH_SERVE_LAYERS, 8, MESH_SERVE_MAX_LEN,
     ("paged", "contiguous")),
    (MESH_ZAMBA, 6, 4, 512, ("paged", "contiguous")),
    (MESH_RWKV, 2, 4, 512, ("contiguous",)),
    (MESH_MOE, 1, 4, 512, ("paged", "contiguous")))
# arch: (a data-split mesh, steps), bf16 and contiguous after the run's
# jobs: qwen3-moe on (2, 1) holds 4 of the 8 slots a data rank, fewer
# than its group of tokens, so a rank routes the gathered batch.  No
# "model" split, so nothing reorders a sum: held to ROUTE_RTOL.  Two
# steps: "infer_tp" keeps the experts' data split, so every step
# all-gathers the layer's 4.8 GB of experts through gloo's host staging
# (~10 s a step on the card's host)
MESH_SERVE_SPLIT = {MESH_MOE: ((2, 1), 2)}
# each run's twins, contiguous, on one device and on the mesh from the
# same (bf16) weights and fed the same tokens: "fp32" for every run, the
# check of the regions; "dense" (bf16, attention_variant "dense": no
# top-k selection) for MESH_SERVE_DENSE, the test of why a bf16 run
# lies further from one device than its row-parallel sums reorder
# (the bf16 selection, ``bf16(s) >= bf16(thr)``, turning a bf16 GEMM's
# other summation order into other admitted keys)
MESH_SERVE_TWINS = {"dense": dict(attention_variant="dense"),
                    "fp32": dict(dtype="float32")}       # fp32 last
MESH_SERVE_DENSE = ("qwen3-4b",)
# rwkv6's bound in bf16 and fp32 (C14: its bf16 scan state drifts)
MESH_SERVE_RWKV_RTOL = 1e-2
# phase 27's context-parallel job: the serving cache's keys split over
# "model" (``CACHE_SEQ_SHARD``, the reference's layout) on
# MESH_SERVE_MESH, contiguous.  (arch, layers, checked steps, max_len,
# dtypes: bf16 the seed's weights, fp32 the same weights ``.float()``ed,
# fp32 last).  qwen3-4b's prompts put keys on both ranks and cross the
# ranks' 2,048 boundary while stepping (2,047 → 2,048); zamba2's one
# shared block (6 layers) reads ``shared_kv``
MESH_CP_PROMPTS = (1024, 2100, 3000, 333, 2048, 4000, 64, 2047)
MESH_CP_RUNS = (
    ("qwen3-4b", MESH_SERVE_LAYERS, 8, MESH_SERVE_MAX_LEN, ("bf16", "fp32")),
    (MESH_ZAMBA, 6, 4, 512, ("fp32",)))


def mesh_serve_twins(arch):
    return [t for t in MESH_SERVE_TWINS
            if t != "dense" or arch in MESH_SERVE_DENSE]


def mesh_serve_limit(arch, twin, shape):
    """A job's bound on the logits relative to one device's: rwkv6's
    C14 bound, phase 8's ROUTE_RTOL in fp32 and on a mesh without a
    "model" split, and None (printed beside the witness, not held) for
    the other bf16 runs."""
    if arch == MESH_RWKV:
        return MESH_SERVE_RWKV_RTOL
    return ROUTE_RTOL if twin == "fp32" or shape[1] == 1 else None


def mesh_serve_cfg(arch, layers, layout, **over):
    """Phase 3's serving settings (``serve_cfg``) on full-width ``arch``
    cut to ``layers`` layers, with ``over`` (a twin's dtype or attention
    variant) replaced."""
    from repro_torch.configs.archs import ARCHS
    return serve_cfg(dataclasses.replace(ARCHS[arch], n_layers=layers,
                                         **over), layout)


def attention_calls(cfg) -> int:
    """Decode-kernel calls of one serve step: one per self-attention
    layer (hybrid: per shared-block application; ssm and dense
    attention: none)."""
    if cfg.family == "ssm" or cfg.attention_variant != "topk":
        return 0
    if cfg.family == "hybrid":
        return cfg.n_layers // cfg.hybrid_period
    return cfg.n_layers


def plan0_rows(cache, take=None):
    """Layer 0's plan rows (kv_indices, kv_counts) on the host, or None;
    ``take(path, leaf)`` maps each layer-0 leaf first (a rank's gather)."""
    for group in ("kv", "shared_kv"):
        if group in cache and "plan" in cache[group]:
            plan = cache[group]["plan"]
            return tuple(
                (take((group, "plan", f), plan[f][:1]) if take
                 else plan[f][:1])[0].to("cpu", copy=True)
                for f in ("kv_indices", "kv_counts"))
    return None


def mesh_serve_fill(torch, dev, model, cfgs, max_len,
                    prompts=MESH_SERVE_PROMPTS):
    """Each layout's whole cache of ``cfgs`` (layout: config), filled on
    one device: qwen3-4b's slots by ``prefill_prompt`` /
    ``install_prefill`` of ``prompts``, the other archs' by
    MESH_SERVE_WARM steps from an empty cache; paged, every slot's pages
    mapped.  The draws come from one seed, so a twin gets the same
    prompts and tokens.  Returns (caches, the first checked position of
    each slot, the first checked tokens)."""
    from repro_torch.core.paging import PageAllocator
    from repro_torch.models import decode as dec
    b = MESH_SERVE_SLOTS
    cfg = next(iter(cfgs.values()))
    caches, table = {}, None
    for lay, c in cfgs.items():
        caches[lay] = dec.init_cache(c, b, max_len, device=dev)
        if lay == "paged":
            n = max_len // 64
            alloc = PageAllocator(b * n + 1, b, n, 64, audit=False)
            for slot in range(b):
                assert alloc.ensure(slot, max_len - 1)
            table = alloc.table
            dec.set_page_table(c, caches[lay], table)
    rng = np.random.default_rng(27)
    if cfg.name.startswith("qwen3-4b"):
        pos0 = np.array(prompts, np.int32)
        for slot, n in enumerate(prompts):
            prompt = torch.from_numpy(rng.integers(
                0, cfg.vocab_size, (1, n)).astype(np.int32)).to(dev)
            _, state = dec.prefill_prompt(model, cfg, prompt, max_len)
            for lay, c in caches.items():
                dec.install_prefill(cfgs[lay], c, slot, state,
                                    table[slot] if lay == "paged" else None)
    else:
        pos0 = np.zeros(b, np.int32)
        for _ in range(MESH_SERVE_WARM):
            tok = torch.from_numpy(rng.integers(
                0, cfg.vocab_size, (b, 1)).astype(np.int32)).to(dev)
            for lay, c in caches.items():
                dec.serve_step(model, cfgs[lay], c, tok,
                               torch.from_numpy(pos0).to(dev))
            pos0 = pos0 + 1
    tok = torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, 1)).astype(
        np.int32))
    return caches, pos0, tok


def mesh_serve_steps(torch, dev, model, cfg, cache, pos0, steps, fed):
    """``steps`` teacher-forced ``serve_step``s on one device from
    ``pos0``, fed ``fed`` (a list the first run fills with its own
    greedy tokens): the logits, ms a step (CUDA events) and layer 0's
    plan rows after the first step."""
    from repro_torch.models import decode as dec
    logits, ms, plan0 = [], [], None
    for i in range(steps):
        clock = span(torch, dev)
        lg, _ = dec.serve_step(model, cfg, cache, fed[i].to(dev),
                               torch.from_numpy(pos0 + i).to(dev))
        ms.append(clock())
        if plan0 is None:
            plan0 = plan0_rows(cache)
        logits.append(lg.cpu())
        if len(fed) == i + 1:
            fed.append(lg[:, 0].argmax(dim=-1)[:, None].to(
                torch.int32).cpu())
    return dict(logits=logits, ms=ms, plan0=plan0)


def mesh_serve_reference(torch, sd, dev, tmp, tag, runs=MESH_SERVE_RUNS):
    """Phase 27's one-device half, in the parent, for each run: the
    seed-0 model in bf16, each layout's whole cache filled on one device
    (``mesh_serve_fill``) and saved to ``tmp/serve_<arch>.pt`` for the
    ranks, the checked steps on one device (the contiguous run's greedy
    tokens fed to both layouts, paged == contiguous bitwise); then each
    twin (``mesh_serve_twins``: the same weights, fp32 by ``.float()``),
    its contiguous cache filled the same way and saved as
    ``serve_<arch> <twin>.pt``, and the same steps fed the same tokens.
    The witness is the bf16 run's logits against the fp32 twin's.  The
    references go to ``tmp/serve_ref_<arch>.pt``."""
    from repro_torch.models.model import Model
    refs = {}
    for arch, layers, steps, max_len, layouts in runs:
        t0 = time.time()
        cfgs = {lay: mesh_serve_cfg(arch, layers, lay)
                for lay in sorted(layouts)}            # contiguous first
        model = Model(cfgs["contiguous"], device=dev, seed=0)
        caches, pos0, tok = mesh_serve_fill(torch, dev, model, cfgs,
                                            max_len)
        torch.save(caches, os.path.join(tmp, f"serve_{arch}.pt"))
        ref = {"pos0": pos0, "fed": [tok], "layers": layers}
        for lay in cfgs:
            ref[lay] = mesh_serve_steps(torch, dev, model, cfgs[lay],
                                        caches[lay], pos0, steps,
                                        ref["fed"])
        if len(layouts) == 2:
            mesh_equal(ref["paged"]["logits"], ref["contiguous"]["logits"],
                       f"{arch} one device: paged vs contiguous")
        del caches
        for twin in mesh_serve_twins(arch):
            c = {"contiguous": mesh_serve_cfg(arch, layers, "contiguous",
                                              **MESH_SERVE_TWINS[twin])}
            if twin == "fp32":
                model.float()
            caches, _, _ = mesh_serve_fill(torch, dev, model, c, max_len)
            torch.save(caches, os.path.join(tmp, f"serve_{arch} {twin}.pt"))
            ref[twin] = mesh_serve_steps(torch, dev, model, c["contiguous"],
                                         caches["contiguous"], pos0, steps,
                                         ref["fed"])
            del caches
        ref["witness"] = [rel_logits(a, b) for a, b in zip(
            ref["contiguous"]["logits"], ref["fp32"]["logits"])]
        torch.save(ref, os.path.join(tmp, f"serve_ref_{arch}.pt"))
        refs[arch] = ref
        del model
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        log(f"[mesh-serve] one device: {arch} full width, {layers} "
            f"layer(s), {MESH_SERVE_SLOTS} slots, max_len {max_len}, "
            f"{describe(cfgs['contiguous'])}: "
            f"{', '.join(f'{x:.2f}' for x in ref['contiguous']['ms'])} ms "
            f"a step (contiguous; CUDA events); bf16 logits against fp32 "
            f"arithmetic on the same weights (the witness) "
            f"{[f'{x:.3e}' for x in ref['witness']]}; filled and stepped "
            f"in {time.time() - t0:.1f} s {tag}")
    return refs


def rel_logits(a, b) -> float:
    """max |a - b| over the step's largest |b|."""
    return float((a.float() - b.float()).abs().max() / b.float().abs().max())


def mesh_serve_jobs(arch, steps, layouts):
    """(name, layout, twin or None, mesh, steps) of a run: the bf16
    layouts, then the twins (fp32 last: ``.float()`` does not go back)
    on MESH_SERVE_MESH, then its MESH_SERVE_SPLIT job."""
    jobs = [(arch, lay, None, MESH_SERVE_MESH, steps) for lay in layouts]
    jobs += [(f"{arch} {t}", "contiguous", t, MESH_SERVE_MESH, steps)
             for t in mesh_serve_twins(arch)]
    if arch in MESH_SERVE_SPLIT:
        jobs.append((arch, "contiguous", None, *MESH_SERVE_SPLIT[arch]))
    return jobs


def mesh_serve_rank(torch, dev, res, tmp, runs):
    """Phase 27 in one rank: for each run's jobs (``mesh_serve_jobs``),
    the seed-0 model sharded under "infer_tp" on the job's mesh (built
    again when the mesh changes), the rank's blocks of the whole cache
    the parent saved, then the checked steps through
    ``make_serve_step(mesh=)``, fed one device's tokens, the decode
    kernels' counts set to 0 just before and read just after; layer 0's
    plan rows after the first step gathered whole."""
    from repro_torch.distributed.sharding import (cache_leaves, gather,
                                                  map_cache)
    from repro_torch.kernels import sata_decode as sd
    from repro_torch.launch import mesh as M
    from repro_torch.models.model import Model
    from repro_torch.train.step import make_serve_step
    for arch, layers, steps, max_len, layouts in runs:
        ref = torch.load(os.path.join(tmp, f"serve_ref_{arch}.pt"),
                         weights_only=False)
        model = mesh = None
        t0 = time.time()
        for name, lay, twin, shape, n in mesh_serve_jobs(arch, steps,
                                                         layouts):
            cfg = mesh_serve_cfg(arch, layers, lay,
                                 **MESH_SERVE_TWINS.get(twin, {}))
            if mesh is None or mesh.shape != dict(zip(("data", "model"),
                                                      shape)):
                model = None
                if dev.type == "cuda":
                    torch.cuda.empty_cache()
                mesh = M.make_train_mesh(*shape, device=dev)
            step = make_serve_step(cfg, mesh=mesh, mode="infer_tp")
            if model is None:
                model = step.layout.shard_(Model(mesh_serve_cfg(
                    arch, layers, "contiguous"), device=dev, seed=0))
            if twin == "fp32":
                model.float()
            whole = torch.load(os.path.join(tmp, f"serve_{name}.pt"),
                               map_location="cpu", weights_only=False)[lay]
            specs = step.layout.cache_specs(whole)
            cache = map_cache(step.layout.block_cache(whole),
                              lambda _, x: x.to(dev))
            del whole
            if dev.type == "cuda":
                torch.cuda.synchronize()
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats(dev)
            staged = mesh.host_staged_bytes
            logits, ms, plan0 = [], [], None
            sd.sata_decode_attention_paged_kernel.launches = 0
            sd.sata_decode_attention_kernel.launches = 0
            for i in range(n):
                clock = span(torch, dev)
                lg, _ = step(model, cache, ref["fed"][i].to(dev),
                             torch.from_numpy(ref["pos0"] + i).to(dev))
                ms.append(clock())
                logits.append(lg.cpu())
                if i == 0:
                    plan0 = plan0_rows(cache, lambda p, x: gather(
                        x, specs[p], mesh))
            launches = (sd.sata_decode_attention_paged_kernel.launches,
                        sd.sata_decode_attention_kernel.launches)
            res[f"serve {name} {lay} {shape}"] = dict(
                logits=logits, ms=ms, plan0=plan0, launches=launches,
                staged=mesh.host_staged_bytes - staged,
                peak=torch.cuda.max_memory_allocated(dev)
                if dev.type == "cuda" else 0,
                heads={"/".join(k): tuple(v.shape) for k, v in
                       cache_leaves(cache)
                       if k[-1] in ("k", "k_pages", "ssm", "state")},
                leaves=step.layout.counts(), wall=time.time() - t0)
            t0 = time.time()
            del cache
        del model
        if dev.type == "cuda":
            torch.cuda.empty_cache()


def mesh_serve_check(ranks, refs, tag, runs=MESH_SERVE_RUNS):
    """Phase 27's checks on the ranks' results, every line printed before
    the first failure is raised; returns the paged and the contiguous
    kernel's launches over the ranks."""
    n = {"paged": 0, "contiguous": 0}
    fails = []
    for arch, layers, steps, max_len, layouts in runs:
        ref = refs[arch]
        witness = max(ref["witness"])
        jobs = mesh_serve_jobs(arch, steps, layouts)
        for (r, rank), (name, lay, twin, shape, k) in itertools.product(
                enumerate(ranks), jobs):
            cfg = mesh_serve_cfg(arch, layers, lay,
                                 **MESH_SERVE_TWINS.get(twin, {}))
            calls = attention_calls(cfg) * k
            want = ref[twin or lay]
            limit = mesh_serve_limit(arch, twin, shape)
            t = rank[f"serve {name} {lay} {shape}"]
            errs = [rel_logits(a, b) for a, b in zip(t["logits"],
                                                     want["logits"])]
            agree = np.mean([float((a[:, 0].argmax(-1) ==
                                    b[:, 0].argmax(-1)).float().mean())
                             for a, b in zip(t["logits"], want["logits"])])
            plan_eq = None if want["plan0"] is None else [
                float((a == b).float().mean()) for a, b in
                zip(t["plan0"], want["plan0"])]
            paged_n, contig_n = t["launches"]
            n["paged"] += paged_n
            n["contiguous"] += contig_n
            bound = (f"limit {limit:.1e}" if limit is not None else
                     f"not held; bf16's own error, the witness, "
                     f"{witness:.3e}")
            log(f"[mesh-serve] rank {r}/{MESH_RANKS} {name} {layers} "
                f"layer(s) {lay}, mesh {shape} (data, model), infer_tp: "
                f"logits relative to one device "
                f"{[f'{x:.3e}' for x in errs]} ({bound}); argmax agreement "
                f"{agree:.3f}; layer 0's first plan rows equal "
                f"(kv_indices, kv_counts share) {plan_eq}; "
                f"{', '.join(f'{x:.2f}' for x in t['ms'])} ms a step (one "
                f"device {', '.join(f'{x:.2f}' for x in want['ms'][:k])}; "
                f"CUDA events, both ranks on the card at once); decode "
                f"launches {paged_n} paged / {contig_n} contiguous "
                f"(derived {calls}); host-staged {t['staged'] / 1e6:.1f} "
                f"MB; peak memory {t['peak'] / 2 ** 30:.2f} GiB; the "
                f"rank's cache {t['heads']}; leaves {t['leaves']}; the "
                f"job's {t['wall']:.1f} s in the rank {tag}")
            want_n = (calls, 0) if lay == "paged" else (0, calls)
            for ok, what in (
                    (len(errs) == k and all(np.isfinite(errs)) and
                     (limit is None or max(errs) <= limit),
                     f"logits {errs} > {limit}"),
                    ((paged_n, contig_n) == want_n,
                     f"launches {(paged_n, contig_n)} != {want_n}"),
                    (plan_eq is None or plan_eq == [1.0, 1.0],
                     f"layer 0's plan rows {plan_eq}")):
                if not ok:
                    fails.append(f"{name} {lay} {shape} rank {r}: {what}")
            if lay == "paged":
                mesh_equal(t["logits"],
                           rank[f"serve {arch} contiguous {shape}"]["logits"],
                           f"rank {r} {arch} {shape}: paged vs contiguous")
    assert not fails, fails
    return n


def mesh_cp_cfg(arch, layers, dtype):
    return mesh_serve_cfg(arch, layers, "contiguous",
                          **({"dtype": "float32"} if dtype == "fp32" else {}))


def mesh_cp_reference(torch, dev, tmp, tag, runs=MESH_CP_RUNS):
    """The context-parallel job's one-device half, in the parent: for
    each run the seed-0 model in bf16, ``.float()``ed for fp32, each
    dtype's whole contiguous cache filled on one device
    (``mesh_serve_fill``, qwen3-4b from MESH_CP_PROMPTS) and saved to
    ``tmp/cp_<arch> <dtype>.pt``, then the checked steps on one device,
    the first dtype's greedy tokens fed to both.  The witness is the
    bf16 run's logits against the fp32 run's.  The references go to
    ``tmp/cp_ref_<arch>.pt``."""
    from repro_torch.models.model import Model
    refs = {}
    for arch, layers, steps, max_len, dtypes in runs:
        t0 = time.time()
        model = Model(mesh_cp_cfg(arch, layers, "bf16"), device=dev, seed=0)
        ref = {"fed": []}
        for dt in dtypes:
            cfg = mesh_cp_cfg(arch, layers, dt)
            if dt == "fp32":
                model.float()
            caches, pos0, tok = mesh_serve_fill(
                torch, dev, model, {"contiguous": cfg}, max_len,
                prompts=MESH_CP_PROMPTS)
            torch.save(caches, os.path.join(tmp, f"cp_{arch} {dt}.pt"))
            ref["pos0"] = pos0
            ref["fed"] = ref["fed"] or [tok]
            ref[dt] = mesh_serve_steps(torch, dev, model, cfg,
                                       caches["contiguous"], pos0, steps,
                                       ref["fed"])
            del caches
        if len(dtypes) == 2:
            ref["witness"] = [rel_logits(a, b) for a, b in zip(
                ref["bf16"]["logits"], ref["fp32"]["logits"])]
        torch.save(ref, os.path.join(tmp, f"cp_ref_{arch}.pt"))
        refs[arch] = ref
        del model
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        log(f"[mesh-cp] one device: {arch} full width, {layers} layer(s), "
            f"{MESH_SERVE_SLOTS} slots, max_len {max_len}, contiguous, "
            f"{'/'.join(dtypes)}: "
            + "; ".join(f"{dt} {', '.join(f'{x:.2f}' for x in ref[dt]['ms'])}"
                        f" ms a step" for dt in dtypes)
            + f" (CUDA events); filled and stepped in "
            f"{time.time() - t0:.1f} s {tag}")
    return refs


class AdmittedKeys:
    """Wraps ``core.decode_plan.full_replan`` while installed: the keys
    each call's threshold admits on the rank's share of the keys
    (``bf16(s) >= bf16(thr)`` at a position <= the slot's), summed over
    the slots, KV heads and query heads, one total a step (``step``
    starts the next)."""

    def __init__(self, torch):
        from repro_torch.core import decode_plan as dp
        self.torch, self.dp, self.fn = torch, dp, dp.full_replan
        self.steps = []

    def step(self):
        self.steps.append(0)

    def __enter__(self):
        torch, dp, fn = self.torch, self.dp, self.fn
        from repro_torch.core.blockmap import bisect_select

        def wrapped(q, k_cache, pos, **kw):
            out = fn(q, k_cache, pos, **kw)
            with torch.no_grad():
                s = k_cache.shape[1]
                sc = dp._scores(q, k_cache.permute(0, 2, 1, 3),
                                float(1.0 / np.sqrt(q.shape[-1])))
                valid = torch.arange(s, device=sc.device) <= pos[:, None]
                n = (bisect_select(sc, out[2]) & valid[:, None, None]).sum()
            self.steps[-1] += int(n)
            return out
        dp.full_replan = wrapped
        return self

    def __exit__(self, *exc):
        self.dp.full_replan = self.fn


def mesh_cp_rank(torch, dev, res, tmp, runs):
    """The context-parallel job in one rank: ``CACHE_SEQ_SHARD`` on, for
    each run and dtype the seed-0 model sharded under "infer_tp" on
    MESH_SERVE_MESH (``.float()``ed for fp32), the rank's share of the
    keys of the whole cache the parent saved, then the checked steps
    through ``make_serve_step(mesh=)`` fed one device's tokens, the
    decode kernels' counts set to 0 just before and read just after; the
    keys each step's thresholds admit on the rank (``AdmittedKeys``), and
    the rank's self-attention cache bytes against the head layout's
    (``CACHE_SEQ_SHARD`` False) on the same mesh."""
    from repro_torch.distributed import sharding
    from repro_torch.distributed.sharding import (ShardLayout, cache_leaves,
                                                  map_cache)
    from repro_torch.kernels import sata_decode as sd
    from repro_torch.launch import mesh as M
    from repro_torch.models.decode import kv_group
    from repro_torch.models.model import Model
    from repro_torch.train.step import make_serve_step
    was, sharding.CACHE_SEQ_SHARD = sharding.CACHE_SEQ_SHARD, True
    mesh = M.make_train_mesh(*MESH_SERVE_MESH, device=dev)

    def group_bytes(cache):
        return sum(t.nbytes for p, t in cache_leaves(cache)
                   if p[0] == kv_group(cache))
    try:
        for arch, layers, steps, max_len, dtypes in runs:
            ref = torch.load(os.path.join(tmp, f"cp_ref_{arch}.pt"),
                             weights_only=False)
            model = None
            for dt in dtypes:
                t0 = time.time()
                cfg = mesh_cp_cfg(arch, layers, dt)
                step = make_serve_step(cfg, mesh=mesh, mode="infer_tp")
                if model is None:
                    model = step.layout.shard_(Model(mesh_cp_cfg(
                        arch, layers, "bf16"), device=dev, seed=0))
                if dt == "fp32":
                    model.float()
                whole = torch.load(os.path.join(tmp, f"cp_{arch} {dt}.pt"),
                                   map_location="cpu",
                                   weights_only=False)["contiguous"]
                sharding.CACHE_SEQ_SHARD = False
                head = ShardLayout(cfg, mesh, mode="infer_tp").block_cache(
                    map_cache(whole, lambda _, x: x.to("meta")))
                sharding.CACHE_SEQ_SHARD = True
                cache = map_cache(step.layout.block_cache(whole),
                                  lambda _, x: x.to(dev))
                del whole
                if dev.type == "cuda":
                    torch.cuda.synchronize()
                    torch.cuda.empty_cache()
                    torch.cuda.reset_peak_memory_stats(dev)
                staged = mesh.host_staged_bytes
                logits, ms = [], []
                sd.sata_decode_attention_paged_kernel.launches = 0
                sd.sata_decode_attention_kernel.launches = 0
                with AdmittedKeys(torch) as adm:
                    for i in range(steps):
                        adm.step()
                        clock = span(torch, dev)
                        lg, _ = step(model, cache, ref["fed"][i].to(dev),
                                     torch.from_numpy(ref["pos0"] + i)
                                     .to(dev))
                        ms.append(clock())
                        logits.append(lg.cpu())
                res[f"cp {arch} {dt}"] = dict(
                    logits=logits, ms=ms, admitted=adm.steps,
                    launches=(sd.sata_decode_attention_paged_kernel.launches,
                              sd.sata_decode_attention_kernel.launches),
                    staged=mesh.host_staged_bytes - staged,
                    peak=torch.cuda.max_memory_allocated(dev)
                    if dev.type == "cuda" else 0,
                    cache_bytes=group_bytes(cache),
                    head_bytes=group_bytes(head),
                    keys={"/".join(k): tuple(v.shape) for k, v in
                          cache_leaves(cache) if k[-1] == "k"},
                    wall=time.time() - t0)
                del cache
            del model
            if dev.type == "cuda":
                torch.cuda.empty_cache()
    finally:
        sharding.CACHE_SEQ_SHARD = was


def mesh_cp_check(ranks, refs, tag, runs=MESH_CP_RUNS):
    """The context-parallel job's checks, every line printed before the
    first failure is raised: fp32 within ROUTE_RTOL of one device's
    logits relative to the step's largest (phase 8's limit: the
    row-parallel sums and the softmax's combine reorder fp32 sums), bf16
    printed beside the witness; the same logits on both ranks; the
    contiguous kernel (in its partial mode) launched layers x steps a
    rank and the paged one never.  Returns the contiguous launches over
    the ranks."""
    total, fails = 0, []
    for arch, layers, steps, max_len, dtypes in runs:
        ref = refs[arch]
        for dt in dtypes:
            cfg = mesh_cp_cfg(arch, layers, dt)
            calls = attention_calls(cfg) * steps
            limit = ROUTE_RTOL if dt == "fp32" else None
            for r, rank in enumerate(ranks):
                t = rank[f"cp {arch} {dt}"]
                errs = [rel_logits(a, b) for a, b in zip(
                    t["logits"], ref[dt]["logits"])]
                same = all(bool((a == b).all()) for a, b in zip(
                    t["logits"], ranks[0][f"cp {arch} {dt}"]["logits"]))
                total += t["launches"][1]
                bound = (f"limit {limit:.1e}" if limit is not None else
                         f"not held; bf16's own error, the witness, "
                         f"{max(ref['witness']):.3e}")
                log(f"[mesh-cp] rank {r}/{MESH_RANKS} {arch} {layers} "
                    f"layer(s) {dt}, mesh {MESH_SERVE_MESH} (data, model), "
                    f"the keys split over model: logits relative to one "
                    f"device {[f'{x:.3e}' for x in errs]} ({bound}); the "
                    f"ranks' logits bitwise equal {same}; keys admitted on "
                    f"the rank a step {t['admitted']}; "
                    f"{', '.join(f'{x:.2f}' for x in t['ms'])} ms a step "
                    f"(one device "
                    f"{', '.join(f'{x:.2f}' for x in ref[dt]['ms'])}; CUDA "
                    f"events, both ranks on the card at once); decode "
                    f"launches {t['launches'][0]} paged / "
                    f"{t['launches'][1]} contiguous (derived {calls}); the "
                    f"rank's self-attention cache {t['cache_bytes'] / 1e6:.1f}"
                    f" MB (the head layout's {t['head_bytes'] / 1e6:.1f} MB), "
                    f"its keys {t['keys']}; host-staged "
                    f"{t['staged'] / 1e6:.1f} MB; peak memory "
                    f"{t['peak'] / 2 ** 30:.2f} GiB; the job's "
                    f"{t['wall']:.1f} s in the rank {tag}")
                for ok, what in (
                        (len(errs) == steps and all(np.isfinite(errs)) and
                         (limit is None or max(errs) <= limit),
                         f"logits {errs} > {limit}"),
                        (same, "the ranks' logits differ"),
                        (t["launches"] == (0, calls),
                         f"launches {t['launches']} != {(0, calls)}")):
                    if not ok:
                        fails.append(f"{arch} {dt} rank {r}: {what}")
    assert not fails, fails
    return total


def mesh_phase(torch, sd, dev, tag, dshape=MESH_DECODE, sshape=MESH_SEQ,
               train_runs=MESH_TRAIN_RUNS, serve_runs=MESH_SERVE_RUNS,
               cp_runs=MESH_CP_RUNS):
    """Phase 24: ``launch.mesh`` on two gloo ranks sharing the card (NCCL
    refuses two ranks of one communicator on one GPU), each with its own
    CUDA context on the same device, the kernels already built (phase
    1).  The parent first runs the one-rank references and frees them:
    (a) MESH_STEPS carried ``tensor_parallel_decode_step``s on
    ``make_local_mesh()`` and the plain single-device step, both
    layouts; (b) ``sequence_local_attention``.  The ranks then run the
    same work sharded: each rank's decode outputs and plan leaves equal
    the one-rank mesh's and the plain step's bitwise, paged equals
    contiguous bitwise, each layout's kernel launched exactly ranks x
    steps times (summed over the ranks), the other never; the sharded
    attention's out, thresholds and block map equal the local run's
    bitwise, its per-shard fetches partition the local count, every
    shard > 0.  Prints per-step ms per rank (CUDA events), the
    attention's ms, host-staged MB and peak memory per rank.  Phase 25
    (``train_runs``) runs in the same world: the parent's one-device
    ``train`` of each model first (``mesh_train_reference``), then the
    ranks' ``train(mesh=)`` of each (model, mesh shape)
    (``mesh_train_rank``), checked by ``mesh_train_check``.  Phase 27
    (``serve_runs``) too: the parent's one-device caches and steps
    (``mesh_serve_reference``), the ranks' ``make_serve_step(mesh=)``
    (``mesh_serve_rank``), checked by ``mesh_serve_check``.  Returns
    the launches of the paged and the contiguous kernel, phase 25's B3
    launches and phase 27's decode launches by layout."""
    import tempfile

    import torch.multiprocessing as mp
    from repro_torch.launch import mesh as M
    t0 = time.time()
    c = mesh_decode_inputs(torch, dev, dshape)
    local = M.make_local_mesh(device=dev)

    def tp(qg, k, v, k_new, pos, plan, table):
        return M.tensor_parallel_decode_step(
            local, qg, k, v, k_new, pos, plan, topk_k=c["topk"],
            k_block=c["page"], page_table=table)

    plain, errs = mesh_plain_step(torch, c, sd)
    ref = {}
    for layout in ("paged", "contiguous"):
        ref[layout], ms1 = mesh_decode_run(torch, tp, c, layout)
        steps, _ = mesh_decode_run(torch, plain, c, layout)
        mesh_equal(ref[layout], steps, f"{layout}: one-rank mesh vs the "
                   f"plain step")
        log(f"[mesh] one-rank tensor_parallel_decode_step ({layout}, "
            f"B{dshape['b']} KV{dshape['kv']} G{dshape['g']} "
            f"D{dshape['d']} page {dshape['page']} bf16): "
            f"{', '.join(f'{x:.3f}' for x in ms1)} ms a step (CUDA "
            f"events); == the plain step bitwise; kernel vs plain version "
            f"max_abs_err {max(errs):.3e} {tag}")
    mesh_equal(ref["paged"], ref["contiguous"], "paged vs contiguous")
    del c
    q, k, v = mesh_seq_inputs(torch, dev, sshape)
    blk = sshape["block"]
    kw = dict(k_sel=sshape["k_sel"], q_block=blk, k_block=blk)
    first, _ = M.sequence_local_attention(q, k, v, **kw)
    t = span(torch, dev)
    lout, lstats = M.sequence_local_attention(q, k, v, **kw)
    local_ms = t()
    assert torch.equal(first, lout), "two local calls differ"
    lseq = (lout.cpu(), {n: x.cpu() for n, x in lstats.items()})
    del q, k, v, first, lout, lstats
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.time() - t0
    t0 = time.time()
    tref = mesh_train_reference(torch, dev, tag, dict.fromkeys(
        name for name, *_ in train_runs))
    t_train_ref = time.time() - t0

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.time()
        srefs = mesh_serve_reference(torch, sd, dev, tmp, tag, serve_runs)
        crefs = mesh_cp_reference(torch, dev, tmp, tag, cp_runs)
        t_serve_ref = time.time() - t0
        t0 = time.time()
        mp.start_processes(mesh_rank, args=(MESH_RANKS, tmp, str(dev),
                                            dshape, sshape, train_runs,
                                            serve_runs, cp_runs),
                           nprocs=MESH_RANKS, start_method="spawn")
        ranks = [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                            weights_only=False) for r in range(MESH_RANKS)]
    t_ranks = time.time() - t0
    n = {"paged": 0, "contiguous": 0}
    for r, res in enumerate(ranks):
        for layout in ("paged", "contiguous"):
            outs, ms = res[layout]
            mesh_equal(outs, ref[layout], f"rank {r} {layout}")
            paged_n, contig_n = res[f"{layout} launches"]
            n["paged"] += paged_n
            n["contiguous"] += contig_n
            want = (MESH_STEPS, 0) if layout == "paged" else (0, MESH_STEPS)
            assert (paged_n, contig_n) == want, \
                (r, layout, paged_n, contig_n)
            log(f"[mesh] rank {r}/{MESH_RANKS} tensor_parallel_decode_step "
                f"({layout}, {dshape['kv'] // MESH_RANKS} of "
                f"{dshape['kv']} KV heads): "
                f"{', '.join(f'{x:.3f}' for x in ms)} ms a step (CUDA "
                f"events, both ranks on the card at once); == the one-rank "
                f"mesh and the plain step bitwise; kernel launches "
                f"{paged_n} paged / {contig_n} contiguous; the rank's "
                f"heads of the cache copied a step "
                f"{res[f'{layout} copied'] / 1e6:.1f} MB {tag}")
        out, stats = res["seq"]
        assert res["seq repeat"], f"rank {r}: two sharded calls differ"
        mesh_equal(out, lseq[0], f"rank {r} sequence-sharded out")
        for name in ("thresholds", "block_map", "kv_counts"):
            mesh_equal(stats[name], lseq[1][name], f"rank {r} {name}")
        per = stats["fetched_tiles_per_shard"]
        assert int(per.sum()) == int(lseq[1]["fetched_tiles"]) and \
            bool((per > 0).all()), (per, lseq[1]["fetched_tiles"])
        log(f"[mesh] rank {r}/{MESH_RANKS} sequence_sharded_attention "
            f"(BH {sshape['bh']}, S {sshape['s']}, D {sshape['d']}, "
            f"blocks {blk}, causal, k_sel {sshape['k_sel']}, fp32): "
            f"{res['seq ms']:.2f} ms (CUDA events, second call) against "
            f"the one-rank sequence_local_attention's {local_ms:.2f} ms; "
            f"host-staged {res['seq staged'] / 1e6:.1f} MB "
            f"(decode: {res['decode staged'] / 1e6:.1f} MB over "
            f"{2 * MESH_STEPS} steps); peak memory "
            f"{res['seq peak'] / 2 ** 30:.2f} GiB; tiles fetched per shard "
            f"{per.tolist()} of {int(lseq[1]['fetched_tiles'])}; == the "
            f"local run bitwise {tag}")
    assert n == {"paged": MESH_RANKS * MESH_STEPS,
                 "contiguous": MESH_RANKS * MESH_STEPS}, n
    n_b3 = mesh_train_check(ranks, tref, train_runs, tag)
    n_serve = mesh_serve_check(ranks, srefs, tag, serve_runs)
    n_serve["cp"] = mesh_cp_check(ranks, crefs, tag, cp_runs)
    log(f"[mesh] one-rank references {t_ref:.1f} s (phase 25's one-device "
        f"train {t_train_ref:.1f} s, phase 27's one-device serve "
        f"{t_serve_ref:.1f} s); spawn + {MESH_RANKS} ranks "
        f"{t_ranks:.1f} s (phases 24, 25 and 27) {tag}")
    return n["paged"], n["contiguous"], n_b3, n_serve


def _tensors(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    else:
        yield tree


# one-line faults of the kernels that phases 2 and 6 must catch:
# name -> (source, line, mutated line)
MUTANTS = {
    "fp32_predicate": (SRC_CU, "return bf16_rn(s) >= thr; }",
                       "return s >= thr; }"),
    "unrounded_p": (SRC_CU, "const float pr = to_f32(from_f32<T>(p));",
                    "const float pr = p;"),
    "decode_pos_lt": (SRC_CU, "const bool live = tok <= pos_b;",
                      "const bool live = tok < pos_b;"),
    # the cluster's combine reads an empty share's m and o (which it never
    # wrote) as if the share had admitted keys
    "combine_no_guard": (SRC_CU, "    live[r] = lr[r] > 0.f;",
                         "    live[r] = r < cs;"),
    # the tensor-core body (bf16): an fp32 predicate, `<` for `<=` on the
    # causal test, l summed from the rounded p
    "attn_fp32_predicate": (SRC_ATTN_CU, "edge[h] = admit_edge(t);",
                            "edge[h] = t;"),
    "attn_causal_lt": (SRC_ATTN_CU, "sel = sel && kpos[key] <= qpos[h];",
                       "sel = sel && kpos[key] < qpos[h];"),
    "attn_l_of_rounded_p": (SRC_ATTN_CU, "rs[e >> 1] += pe[e];",
                            "rs[e >> 1] += bf16_rn(pe[e]);"),
    # the CUDA-core body (fp32): an fp32 predicate
    "attn_fma_fp32_predicate": (SRC_ATTN_CU,
                                "if (p.thr) sel = bf16_rn(sc) >= thr_sh[r];",
                                "if (p.thr) sel = sc >= thr_sh[r];"),
}
# prefill-kernel mutants also run through phase 8; these must fail it too
# (l of the rounded p moves single bf16 roundings, below its limits; the
# fp32 body does not run there)
PHASE8_MUST_CATCH = ("attn_fp32_predicate", "attn_causal_lt")
# decode mutants that a named phase-2 case must catch (any case of that
# name's prefix)
CASE_MUST_CATCH = {"decode_pos_lt": "pos_inside_page",
                   "combine_no_guard": "split_shares"}
PHASE8 = "phase8_route"

_MUTANT_CHILD = """
import sys
sys.path[:0] = [sys.argv[1], sys.argv[1] + "/src"]
import torch
import chip_smoke as cs
from repro_torch.configs.archs import ARCHS
from repro_torch.kernels import sata_attention as sa
from repro_torch.kernels import sata_decode as sd
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
dev = torch.device("cuda")
failed = []
if sys.argv[2] == "decode":
    suites = [(n, lambda c=c: cs.check_case(torch, sd, n, c))
              for n, c in cs.kernel_cases(torch, dev)]
else:
    suites = [(n, lambda n=n, c=c: cs.check_attn_case(torch, sa, n, c))
              for n, c in cs.attn_cases(torch, dev)]
    suites.append((cs.PHASE8, lambda: cs.route_on_off(
        torch, sa, dev, ARCHS["qwen3-4b"], "")))
for name, run in suites:
    try:
        run()
    except AssertionError as e:
        failed.append(name)
        print("[mutant] fails:", e, flush=True)
print("FAILED", ",".join(failed))
"""


def run_mutants(root: str) -> int:
    """``--mutants``: build each of ``MUTANTS`` in a temporary copy of the
    tree and run its kernel's cases (phase 2, or phase 6 and phase 8) on
    it.  Fails unless phase 2 or 6 catches every mutant and phase 8
    catches those of PHASE8_MUST_CATCH."""
    import shutil
    import tempfile
    missed = []
    for name, (src, old, new) in MUTANTS.items():
        with tempfile.TemporaryDirectory() as d:
            shutil.copytree(os.path.join(root, "src"), os.path.join(d, "src"),
                            ignore=shutil.ignore_patterns("__pycache__"))
            shutil.copy(os.path.abspath(__file__), d)
            cu = os.path.join(d, src)
            with open(cu) as f:
                text = f.read()
            assert text.count(old) == 1, f"{name}: {old!r} not found once"
            with open(cu, "w") as f:
                f.write(text.replace(old, new))
            suite = "decode" if src == SRC_CU else "attention"
            res = subprocess.run(
                [sys.executable, "-c", _MUTANT_CHILD, d, suite],
                capture_output=True, text=True, cwd=d)
        lines = res.stdout.splitlines()
        for line in lines[:-1]:
            log(f"[{name}] {line}")
        if res.returncode or not lines or not lines[-1].startswith("FAILED"):
            log(res.stderr[-4000:])
            return 1
        failed = [c for c in lines[-1].split(" ", 1)[-1].split(",") if c]
        kernel_cases = [c for c in failed if c != PHASE8]
        log(f"[{name}] caught by {len(kernel_cases)} kernel case(s): "
            f"{kernel_cases}" + ("" if suite == "decode" else
                                 f"; by phase 8: {PHASE8 in failed}"))
        if not kernel_cases:
            missed.append(name)
        want = CASE_MUST_CATCH.get(name)
        if want and not any(c.startswith(want) for c in kernel_cases):
            missed.append(f"{name} ({want})")
        if name in PHASE8_MUST_CATCH and PHASE8 not in failed:
            missed.append(f"{name} (phase 8)")
    log(f"mutants missed: {missed}")
    return 1 if missed else 0


def build_variant(build, src: str, lib) -> str:
    """Compile the kernel source ``src`` (a path; it may include the
    checkout's shared ``csrc/*.cuh``) into the library ``lib``; returns
    ptxas's report."""
    lib.parent.mkdir(parents=True, exist_ok=True)
    res = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-Xptxas", "-v",
                          "-I", str(build.CSRC), "-o", str(lib), str(src)],
                         capture_output=True, text=True)
    assert res.returncode == 0, res.stderr[-4000:]
    return res.stderr


def kernel_label(entry: str) -> str:
    """A decode kernel's instantiation from its mangled name
    (``sata_decode_kernel<bf16, 16>``); other names as they are."""
    import re
    m = re.search(r"sata_decode_kernelI(f|13__nv_bfloat16)Li(\d+)E", entry)
    if not m:
        return entry
    return (f"sata_decode_kernel<{'fp32' if m.group(1) == 'f' else 'bf16'}"
            f", {m.group(2)}>")


def ptxas_lines(text: str, key: str):
    """ptxas -v's register and spill lines for each kernel whose mangled
    name holds ``key``, each prefixed with its ``kernel_label``."""
    out, entry = [], None
    for line in text.splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1] if "'" in line else line.strip()
        elif entry and key in entry and ("registers" in line
                                         or "spill" in line):
            out.append(f"{kernel_label(entry)}: {line.strip()}")
    return out


def c_params(path: str, symbol: str):
    """The parameter names and ctypes kinds of the C entry point
    ``symbol`` in the source ``path``."""
    import ctypes
    import re
    with open(path) as f:
        sig = re.search(r'extern "C" int ' + symbol + r"\((.*?)\)",
                        f.read(), re.S).group(1)
    args = [a.split() for a in sig.split(",")]
    return ([a[-1].lstrip("*") for a in args],
            [ctypes.c_void_p if "*" in " ".join(a) else ctypes.c_int
             for a in args])


def parent_kernel(build, parent: str, name: str, symbol: str, argtypes):
    """Build ``parent``'s ``csrc/<name>.cu`` (an earlier checkout) and
    return its C entry point ``symbol``, called with this tree's argument
    list (``argtypes``): the arguments the parent does not take are
    dropped by name, so every argument it takes must be this tree's too;
    and ptxas's report."""
    import ctypes
    src = os.path.join(parent, os.path.dirname(SRC_CU), f"{name}.cu")
    names, kinds = c_params(src, symbol)
    mine, my_kinds = c_params(os.path.join(os.path.dirname(
        os.path.abspath(__file__)), os.path.dirname(SRC_CU), f"{name}.cu"),
        symbol)
    assert my_kinds == argtypes, f"{symbol}: argtypes are not the source's"
    assert all(n in mine and kinds[i] == my_kinds[mine.index(n)]
               for i, n in enumerate(names)), \
        f"{parent}: {symbol} has arguments this tree lacks"
    pick = [mine.index(n) for n in names]
    lib = build.BUILD_DIR / "parent" / f"lib{name}_parent.so"
    report = build_variant(build, src, lib)
    fn = getattr(ctypes.CDLL(str(lib)), symbol)
    fn.argtypes, fn.restype = kinds, ctypes.c_int

    def call(*a):
        return fn(*(a[i] for i in pick))
    call.params = names
    return call, report


def parent_launch_config(sd, parent: str):
    """``parent``'s ``kernels/sata_decode.py::launch_config`` as a
    function returning this tree's ``LaunchConfig`` (a parent without
    clusters: ``cluster`` 1), for the parent's build of the kernel."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "parent_sata_decode",
        os.path.join(parent, "src/repro_torch/kernels/sata_decode.py"))
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod          # dataclasses look their module up
    spec.loader.exec_module(mod)

    def config(*a):
        c = mod.launch_config(*a)
        return sd.LaunchConfig(**{f.name: getattr(c, f.name)
                                  for f in dataclasses.fields(c)})
    return config


@contextlib.contextmanager
def launching(module, fn, config=None):
    """While open, ``module``'s CUDA wrappers launch ``fn``, another build
    of their C entry point (and, given, stage it by ``config`` in place
    of ``module.launch_config``)."""
    old, old_config = module._launcher, getattr(module, "launch_config",
                                                None)
    old_rows = getattr(module, "_rows", None)
    module._launcher = lambda *_: fn
    if config is not None:
        module.launch_config = config
    if old_rows is not None and "q_pos_stride" not in getattr(
            fn, "params", ("q_pos_stride",)):
        # a parent without row strides reads (BH, S) positions: the copy
        # its own wrapper made on every call
        module._rows = lambda t, bh, n: (_contiguous_rows(t, bh, n), n)
    try:
        yield
    finally:
        module._launcher = old
        if config is not None:
            module.launch_config = old_config
        if old_rows is not None:
            module._rows = old_rows


def _contiguous_rows(t, bh, n):
    import torch
    return t.to(torch.int32).reshape(bh, n).contiguous()


# the cluster sizes ``--ab`` times this tree's decode kernel at, on each
# case (the shape's staging otherwise): whether a split pays at G <= 8 too
AB_CLUSTERS = (1, 2, 4, 8)


def max_clusters(build, c, cluster, smem_bytes) -> int:
    """The clusters of ``cluster`` decode-kernel blocks with
    ``smem_bytes`` each that the card holds at once at case ``c``'s G
    and dtype (``cudaOccupancyMaxActiveClusters``)."""
    import ctypes
    fn = build.load("sata_decode").sata_decode_max_clusters
    fn.argtypes, fn.restype = [ctypes.c_int] * 4, ctypes.c_int
    q = c["q"]
    return fn(q.shape[2], 1 if q.element_size() == 2 else 0, cluster,
              smem_bytes)


def run_ab(root: str, parent: str) -> int:
    """``--ab PARENT``: phase 2 on this tree's decode kernel, then this
    kernel and PARENT's (each staged by its own ``launch_config``) timed
    in turns (parent, this, this, parent) at phase 5's shapes (MAIN, G16,
    D64, D80, B1 and the long row), both layouts, with SDPA + mask and
    the bound beside them; this kernel at each of AB_CLUSTERS (paged);
    the decode probes at MAIN and G16; then ``ab_prefill``.  One process
    on one card."""
    import torch
    from repro_torch.kernels import build
    from repro_torch.kernels import sata_attention as sa
    from repro_torch.kernels import sata_decode as sd
    dev = torch.device("cuda")
    card = card_line()
    tag = f"[{card}]"
    log(f"[device] {card}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}")
    build_all(build, root)
    old, report = parent_kernel(build, parent, "sata_decode",
                                "sata_decode_attention", sd.ARGTYPES)
    for line in ptxas_lines(report, "sata_decode"):
        log(f"[ab] ptxas parent: {line}")
    old_config = parent_launch_config(sd, parent)
    keep, _ = check_kernels(torch, sd, dev)
    cases = [*((n, keep[n]) for n in (MAIN, G16, G16_FP32, D64, D80)),
             *extra_decode_cases(torch, dev)]
    base = sd.launch_config
    rows = []
    for name, c in cases:
        g, d = c["q"].shape[2:]
        for paged in (True, False):
            with launching(sd, old, old_config):
                got = run_kernel(sd, c, paged)
            want = run_plain(sd, c, paged)
            torch.cuda.synchronize()
            e = float((got.float() - want.float()).abs().max())
            assert e <= TOL["bfloat16"], f"parent {name}: {e}"
            ts = {"parent": [], "change": []}
            for who in ("parent", "change", "change", "parent"):
                with launching(sd, old, old_config) if who == "parent" \
                        else contextlib.nullcontext():
                    ts[who].append(time_ms(
                        torch, lambda: run_kernel(sd, c, paged)))
            qh, kh, vh, mask = sdpa_inputs(torch, c)
            lib_ms = time_ms(torch, lambda: torch.nn.functional
                             .scaled_dot_product_attention(
                                 qh, kh, vh, attn_mask=mask, enable_gqa=True))
            del qh, kh, vh, mask
            bound_ms = kernel_bound(torch, c, paged)[0]
            lay = "paged" if paged else "contiguous"
            row = dict(case=name, layout=lay, bound_ms=bound_ms,
                       sdpa_ms=lib_ms, **ts)
            if paged:
                row["clusters"], row["resident_clusters"] = {}, {}
                try:
                    for cs in AB_CLUSTERS:
                        cfg = dataclasses.replace(
                            base(g, d, c["page"], c["q"].dtype), cluster=cs)
                        sd.launch_config = lambda *_, cfg=cfg: cfg
                        row["clusters"][cs] = time_ms(
                            torch, lambda: run_kernel(sd, c, paged))
                        row["resident_clusters"][cs] = max_clusters(
                            build, c, cs, cfg.smem_bytes)
                finally:
                    sd.launch_config = base
            log(f"[ab] {name} {lay}: parent {ts['parent']} ms, change "
                f"{ts['change']} ms (in turns: parent, change, change, "
                f"parent); SDPA+mask {lib_ms:.4f} ms; bound {bound_ms:.5f} "
                f"ms; this kernel by cluster size "
                f"{row.get('clusters', 'not timed')}, clusters resident at "
                f"once {row.get('resident_clusters', '-')}; its staging "
                f"{base(g, d, c['page'], c['q'].dtype)} {tag}")
            rows.append(row)
    probes = {n: probe_decode(torch, sd, build, root, keep[n], n, tag)
              for n in (MAIN, G16)}
    for n in (MAIN, G16):
        probes[n]["phases"] = probe_phases(torch, sd, build, keep[n], n, tag)
    del cases, keep
    prefill = ab_prefill(torch, sa, build, parent, dev, tag)
    log(card)
    log(json.dumps({"ab": rows, "probes": probes, "ab_prefill": prefill}))
    return 0


def run_ab_prefill(root: str, parent: str) -> int:
    """``--ab-prefill PARENT``: ``ab_prefill`` alone, after building this
    tree's prefill kernel.  One process on one card."""
    import torch
    from repro_torch.kernels import build
    from repro_torch.kernels import sata_attention as sa
    dev = torch.device("cuda")
    card = card_line()
    tag = f"[{card}]"
    log(f"[device] {card}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}")
    build_all(build, root, names=("sata_attention",))
    prefill = ab_prefill(torch, sa, build, parent, dev, tag)
    log(card)
    log(json.dumps({"ab_prefill": prefill}))
    return 0


# phase 6's cases that ``--ab`` times against the parent: the training
# shape (threshold, causal), the dense-selection shape (mask) and
# zamba2-2.7b's D = 80 shape; the probes run at the first and the last
AB_PREFILL_CASES = ("main_BH32_S4096_D128_blk128_threshold_causal_bf16",
                    "BH32_S2048_D128_blk128_mask_bf16", ATTN_D80)
AB_PREFILL_PROBED = (AB_PREFILL_CASES[0], ATTN_D80)


def wrapper_work(torch, sa, c, name, tag):
    """The device kernels one B3 call on case ``c`` launches, by name,
    with their device ms (``torch.profiler``): anything beside the
    kernel is the wrapper's own work inside the timed call."""
    from torch.profiler import ProfilerActivity, profile
    run_attn(sa, c, plain=False)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            run_attn(sa, c, plain=False)
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    rows = {e.key[:80]: (e.count / 5, device_ms(e) / e.count)
            for e in prof.key_averages()
            if getattr(e, "device_type", None) == cuda and device_ms(e) > 0}
    for k, (n, ms) in rows.items():
        log(f"[probe] B3 {name}: device kernel {k!r}: {n:g} a call, "
            f"{ms:.4f} ms each {tag}")
    return {k: ms for k, (n, ms) in rows.items()}


def ab_prefill(torch, sa, build, parent, dev, tag):
    """``--ab`` for the prefill kernels: PARENT's ``sata_attention.cu``
    beside this tree's, ptxas's registers and spills for each body of
    both, then AB_PREFILL_CASES of phase 6 (BH32 S4096 threshold causal:
    B3; BH32 S2048 mask: B3 and B4; zamba2's D 80: B3): this kernel
    against its plain version (phase 6's checks), the parent against
    this kernel, both timed in turns (parent, change, change, parent),
    SDPA with the equivalent mask and the bound beside them; the
    wrapper's own device kernels and the probes at AB_PREFILL_PROBED."""
    old, report = parent_kernel(build, parent, "sata_attention",
                                "sata_block_attention", sa.ARGTYPES)
    mine = build.library_path("sata_attention")
    for who, text in (("parent", report), ("change", (
            mine.parent / f"{mine.stem}.ptxas.txt").read_text())):
        for line in ptxas_lines(text, "sata_block"):
            log(f"[ab] ptxas {who}: {line}")
    rows = []
    for name, c in attn_cases(torch, dev):
        if name not in AB_PREFILL_CASES:
            continue
        check_attn_case(torch, sa, name, c)
        keep = attended_pairs(torch, c)
        bh, s, d = c["q"].shape
        q4, k4, v4 = (c[n].reshape(1, bh, s, d) for n in ("q", "k", "v"))
        lib_ms = time_ms(torch, lambda: torch.nn.functional
                         .scaled_dot_product_attention(
                             q4, k4, v4, attn_mask=keep[None]))
        for dense_grid in (False, True) if c["mode"] == "mask" else (False,):
            kname = "B4" if dense_grid else "B3"
            adm = admitted_buffer(torch, c)
            got = run_attn(sa, c, plain=False, dense_grid=dense_grid,
                           admitted=adm)
            with launching(sa, old):
                ref = run_attn(sa, c, plain=False, dense_grid=dense_grid)
            torch.cuda.synchronize()
            e = float((got.float() - ref.float()).abs().max())
            assert e <= TOL["bfloat16"], f"parent {kname} {name}: {e}"
            del got, ref
            ts = {"parent": [], "change": []}
            for who in ("parent", "change", "change", "parent"):
                with launching(sa, old) if who == "parent" \
                        else contextlib.nullcontext():
                    ts[who].append(time_ms(torch, lambda: run_attn(
                        sa, c, plain=False, dense_grid=dense_grid)))
            bound_ms, bound_by, _ = attn_bound(torch, c, adm, keep)
            body, smem = attn_body(torch, c, dense_grid)
            log(f"[ab] {kname} {name}: parent {ts['parent']} ms, change "
                f"{ts['change']} ms (in turns: parent, change, change, "
                f"parent); SDPA+mask {lib_ms:.4f} ms; bound "
                f"{bound_ms:.4f} ms ({bound_by}); this tree's body: {body}, "
                f"{smem} bytes of dynamic shared memory; parent vs change "
                f"max abs {e:.3e} {tag}")
            rows.append(dict(kernel=kname, case=name, sdpa_ms=lib_ms,
                             bound_ms=bound_ms, body=body, smem=smem, **ts))
        del keep, q4, k4, v4
        if name in AB_PREFILL_PROBED:
            rows.append(dict(kernel="B3", case=name, probes=probe_prefill(
                torch, sa, build, c, name, tag), wrapper=wrapper_work(
                torch, sa, c, name, tag)))
        del c
        torch.cuda.empty_cache()
    return rows


# changes of the prefill kernel's tensor-core body that take a part of its
# work away, timed by ``--ab`` (their outputs are wrong)
PREFILL_PROBES = {
    "copies_and_barriers_only": (
        "      {\n        // S = Q K^T for the warpgroup's 64 rows",
        "      if (kThr) mbar_wait(normed + s, ph);\n"
        "      if (false) {\n        // S = Q K^T for the warpgroup's 64 rows"),
    "no_near_test": (
        "            near |= fabsf(sv[i] - eu[(i >> 1) & 1]) <= w[(i >> 1) & 1];",
        "            near |= false;"),
    "no_recheck": ("          if (__any_sync(0xffffffffu, near)) {",
                   "          if (__any_sync(0xffffffffu, near) && p.n_bh < 0) {"),
    "no_qk": ("        for (int ks = 0; ks < Dk / 16; ++ks) {",
              "        for (int i = 0; i < kTcKeys / 2; ++i) sv[i] = 0.f;\n"
              "        for (int ks = 0; ks < 0; ++ks) {"),
    "no_pv": ("        if (pv) {", "        if (false) {"),
    "no_kv_copies": ("      const int kv_chunks = kChunks;",
                     "      const int kv_chunks = 0;"),
}


def probe_prefill(torch, sa, build, c, name, tag):
    """Where B3's time goes on case ``c``: the kernel as built, with every
    plan row's count 0 (launch, prologue, epilogue), and with each of
    PREFILL_PROBES taken out.  Returns {label: ms}."""
    import ctypes
    from concurrent.futures import ThreadPoolExecutor
    run = lambda case=c: run_attn(sa, case, plain=False)  # noqa: E731
    out = {"as_built": time_ms(torch, run)}
    c0 = dict(c, cnt=torch.zeros_like(c["cnt"]))
    out["count_0_rows"] = time_ms(torch, lambda: run(c0))
    src = open(os.path.join(build.CSRC, "sata_attention.cu")).read()
    pdir = build.BUILD_DIR / "probe"
    pdir.mkdir(parents=True, exist_ok=True)
    # the probes of this source, built once per source
    stem = build.library_path("sata_attention").stem

    def compile_probe(probe):
        old, new = PREFILL_PROBES[probe]
        assert src.count(old) == 1, f"probe {probe}: {old!r} not found once"
        so = pdir / f"{stem}_{probe}.so"
        if not so.exists():
            (pdir / f"{stem}_{probe}.cu").write_text(src.replace(old, new))
            build_variant(build, pdir / f"{stem}_{probe}.cu", so)

    with ThreadPoolExecutor(len(PREFILL_PROBES)) as ex:
        list(ex.map(compile_probe, PREFILL_PROBES))
    for probe in PREFILL_PROBES:
        fn = ctypes.CDLL(str(pdir / f"{stem}_{probe}.so")).sata_block_attention
        fn.argtypes, fn.restype = sa.ARGTYPES, ctypes.c_int
        with launching(sa, fn):
            out[probe] = time_ms(torch, run)
    for k, v in out.items():
        log(f"[probe] B3 {name}, {k}: {v:.4f} ms {tag}")
    return out


# one-line changes of the decode kernel that take a part of its work away,
# timed by ``--ab`` to show where the time goes (their outputs are wrong)
PROBES = {
    "no_scoring": ("      for (int mt = warp; mt * 16 < C; mt += kWarps) {",
                   "      for (int mt = C; mt * 16 < C; mt += kWarps) {"),
    "no_k_copies": ("        one(x, [](void* d, const void* g) { copy_async(d, g, 16); });",
                    "        one(x, [](void* d, const void* g) {});"),
    "no_pv": ("      const int nb = min(nv - v0, VR);",
              "      const int nb = 0;"),
}
# (chunk, stages) at the main shape, with a 20-block window and 128 V rows
PROBE_RINGS = [(64, 2), (64, 4), (64, 8), (192, 2), (256, 2)]


def probe_decode(torch, sd, build, root, c, label, tag):
    """What bounds the decode kernel on case ``c`` (paged):
    the kernel with rows of count 0 (launch, prologue, epilogue), with
    the L2 warm (no flush, launches back to back), at other ring sizes,
    and with the PROBES taken out.  Returns {label: ms}."""
    import ctypes
    from concurrent.futures import ThreadPoolExecutor
    run = lambda case=c: run_kernel(sd, case, True)  # noqa: E731
    out = {"launch_config": time_ms(torch, run)}
    c0 = dict(c, cnt=torch.zeros_like(c["cnt"]))
    out["count_0_rows"] = time_ms(torch, lambda: run(c0))
    for _ in range(3):
        run()
    torch.cuda.synchronize()
    a, z = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda._sleep(SLEEP_CYCLES)
    a.record()
    for _ in range(30):
        run()
    z.record()
    torch.cuda.synchronize()
    out["warm_l2_back_to_back"] = a.elapsed_time(z) / 30
    base = sd.launch_config
    g, d = c["q"].shape[2:]
    try:
        for chunk, stages in PROBE_RINGS:
            n = sd.smem_bytes(g, d, c["page"], 2, chunk, stages, 20, 128)
            if n > sd.SMEM_MAX:
                continue
            sd.launch_config = lambda *_, cfg=sd.LaunchConfig(
                chunk, stages, 20, 128, n, base(
                    g, d, c["page"], c["q"].dtype).cluster): cfg
            out[f"chunk_{chunk}_stages_{stages}"] = time_ms(torch, run)
    finally:
        sd.launch_config = base
    src = open(os.path.join(root, SRC_CU)).read()
    pdir = build.BUILD_DIR / "probe"
    pdir.mkdir(parents=True, exist_ok=True)

    # the probes of this source, built once per source
    stem = build.library_path("sata_decode").stem

    def compile_probe(name):
        old, new = PROBES[name]
        assert src.count(old) == 1, f"probe {name}: {old!r} not found once"
        so = pdir / f"{stem}_{name}.so"
        if not so.exists():
            (pdir / f"{stem}_{name}.cu").write_text(src.replace(old, new))
            build_variant(build, pdir / f"{stem}_{name}.cu", so)

    with ThreadPoolExecutor(len(PROBES)) as ex:
        list(ex.map(compile_probe, PROBES))
    for name in PROBES:
        fn = ctypes.CDLL(str(pdir / f"{stem}_{name}.so")).sata_decode_attention
        fn.argtypes, fn.restype = sd.ARGTYPES, ctypes.c_int
        with launching(sd, fn):
            out[name] = time_ms(torch, run)
    for k, v in out.items():
        log(f"[probe] decode kernel, {label}, paged, {k}: {v:.4f} ms {tag}")
    return out


# an instrumented build of the decode kernel for ``--ab``: thread 0 of each
# block adds the global timer's ns between the points below to one of
# PHASES, and the block's entry and exit times are kept
# (``sata_decode_phases`` copies them out); (old, new) source substitutions
PHASES = ("prologue", "K wait", "scoring", "K copies", "close: pack",
          "close: block maxima", "close: prefix max", "close: p",
          "close: PV", "share out")
_NOW = 'asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t_));'
PHASE_STAMPS = (
    ("namespace {\n\n// threads a block",
     "namespace {\n\n__device__ unsigned long long g_phase[8192][12];\n"
     "#define PT(k) if (threadIdx.x == 0) { unsigned long long t_; " + _NOW +
     " pacc[k] += t_ - t_last; t_last = t_; }\n"
     "#define EDGE(k) if (threadIdx.x == 0 && blockIdx.x < 8192) { "
     "unsigned long long t_; " + _NOW + " g_phase[blockIdx.x][10 + k] = t_; }"
     "\n\n// threads a block"),
    ("  const int b = row / a.n_kv, h = row % a.n_kv;\n",
     "  const int b = row / a.n_kv, h = row % a.n_kv;\n"
     "  unsigned long long t_last = 0, pacc[10] = {};\n"
     "  if (threadIdx.x == 0) { unsigned long long t_; " + _NOW +
     " t_last = t_; }\n"),
    ("  __syncthreads();\n\n  auto block_of",
     "  __syncthreads();\n  PT(0)\n\n  auto block_of"),
    ("    wait_pending(S - 1);      // chunk i has landed\n    __syncthreads();\n",
     "    wait_pending(S - 1);      // chunk i has landed\n    __syncthreads();\n"
     "    PT(1)\n"),
    ("    __syncthreads();          // the slot is free; the chunk's selection "
     "is visible\n    issue_k(i + S);\n    commit_group();\n  }\n",
     "    PT(2)\n    __syncthreads();          // the slot is free; the chunk's "
     "selection is visible\n    issue_k(i + S);\n    commit_group();\n"
     "    PT(3)\n  }\n"),
    ("    const int nv = *nv_sh;\n", "    const int nv = *nv_sh;\n    PT(4)\n"),
    ("    __syncthreads();\n    // prefix max over the blocks",
     "    __syncthreads();\n    PT(5)\n    // prefix max over the blocks"),
    ("    __syncthreads();\n    // p of every (block, head, row)",
     "    __syncthreads();\n    PT(6)\n    // p of every (block, head, row)"),
    ("    __syncthreads();\n    // l = l * cw + sum_j",
     "    __syncthreads();\n    PT(7)\n    // l = l * cw + sum_j"),
    ("      __syncthreads();\n    }\n  };\n\n  // --- main loop",
     "      __syncthreads();\n    }\n    PT(8)\n  };\n\n  // --- main loop"),
    ("  // --- the share's output o[g][d] at the start of the ring",
     "  PT(9)\n  if (threadIdx.x == 0 && blockIdx.x < 8192)\n"
     "    for (int k = 0; k < 10; ++k) g_phase[blockIdx.x][k] = pacc[k];\n"
     "  // --- the share's output o[g][d] at the start of the ring"),
    ("  extern __shared__ __align__(16) unsigned char smem[];\n"
     "  const int G = GC <= 8 ? GC : a.G;\n  const int cs = a.cs",
     "  extern __shared__ __align__(16) unsigned char smem[];\n  EDGE(0)\n"
     "  const int G = GC <= 8 ? GC : a.G;\n  const int cs = a.cs"),
    ("  if (whole) return;\n", "  if (whole) {\n    EDGE(1)\n    return;\n  }\n"),
    ("  if (cs > 1) cluster_sync(cs);   // no rank leaves",
     "  EDGE(1)\n  if (cs > 1) cluster_sync(cs);   // no rank leaves"),
)


def probe_phases(torch, sd, build, c, label, tag):
    """Where each block's time goes on case ``c`` (paged, one launch after
    the L2 flush, the shape's own ``launch_config``): PHASES in µs from
    the PHASE_STAMPS build of the decode kernel, the median and the
    largest over the blocks that ran a share, and the blocks' spread of
    start and end.  The row's split and the combine are the time from a
    block's last phase to its end.  Returns {phase: [median, max]}."""
    import ctypes
    src = open(os.path.join(build.CSRC, "sata_decode.cu")).read()
    for old, new in PHASE_STAMPS:
        assert src.count(old) == 1, f"phase stamp: {old!r} not found once"
        src = src.replace(old, new)
    src += ('\nextern "C" int sata_decode_phases(void* host, int n) {\n'
            "  return (int)cudaMemcpyFromSymbol(host, g_phase, (size_t)n * "
            "12 * 8);\n}\n")
    pdir = build.BUILD_DIR / "probe"
    pdir.mkdir(parents=True, exist_ok=True)
    stem = build.library_path("sata_decode").stem
    so = pdir / f"{stem}_phases.so"
    if not so.exists():
        (pdir / f"{stem}_phases.cu").write_text(src)
        build_variant(build, pdir / f"{stem}_phases.cu", so)
    lib = ctypes.CDLL(str(so))
    fn, read = lib.sata_decode_attention, lib.sata_decode_phases
    fn.argtypes, fn.restype = sd.ARGTYPES, ctypes.c_int
    read.argtypes, read.restype = [ctypes.c_void_p, ctypes.c_int], ctypes.c_int
    q = c["q"]
    cfg = sd.launch_config(q.shape[2], q.shape[3], c["page"], q.dtype)
    blocks = q.shape[0] * q.shape[1] * cfg.cluster
    assert blocks <= 8192, blocks
    flush = torch.empty(64 * 2 ** 20, dtype=torch.float32, device="cuda")
    with launching(sd, fn):
        for _ in range(3):
            run_kernel(sd, c, True)
        torch.cuda.synchronize()
        flush.zero_()
        run_kernel(sd, c, True)
        torch.cuda.synchronize()
    t = np.zeros((blocks, 12), np.uint64)
    assert read(t.ctypes.data, blocks) == 0
    t = t.astype(np.float64)
    edges = (t[:, 10:] - t[:, 10].min()) / 1e3
    ran = t[:, :10].sum(1) > 0
    us = t[ran, :10] / 1e3
    out = {n: [float(np.median(us[:, k])), float(us[:, k].max())]
           for k, n in enumerate(PHASES)}
    rest = edges[ran, 1] - edges[ran, 0] - us.sum(1)
    out["combine"] = [float(np.median(rest)), float(rest.max())]
    out["start"] = [float(np.median(edges[:, 0])), float(edges[:, 0].max())]
    out["end"] = [float(np.median(edges[:, 1])), float(edges[:, 1].max())]
    log(f"[phases] decode kernel, {label}, paged, {int(ran.sum())} of "
        f"{blocks} blocks ran a share; µs median / max: " + "; ".join(
            f"{k} {a:.2f} / {b:.2f}" for k, (a, b) in out.items()) + f" {tag}")
    return out


# ---------------------------------------------------------------------------
# 26. the dry run: meta-tensor counts against the card, two production cells
# ---------------------------------------------------------------------------

DRYRUN_SEQ = 4096
DRYRUN_SLOTS = 8         # the decode calibration's slots
# phase 26's production cells modeled on the host; qwen3-4b's decode cell
# runs context-parallel decode (the keys split over "model")
DRYRUN_CELLS = (("qwen3-4b", "train_4k"), ("qwen3-moe-235b-a22b", "train_4k"),
                ("qwen3-4b", "decode_32k"))


def step_events_ms(torch, run, reps=3):
    """Median ms of ``reps`` synchronized runs of an eager step, CUDA
    events around each (the host's launch gaps included: a step's
    time)."""
    ts = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        z = torch.cuda.Event(enable_timing=True)
        a.record()
        run()
        z.record()
        z.synchronize()
        ts.append(a.elapsed_time(z))
    return float(np.median(ts))


def counts_differ(meta, card):
    """The ops whose counts differ between two ``WorkCounter``s."""
    names = sorted(set(meta.by_op) | set(card.by_op))
    return {n: (meta.by_op.get(n), card.by_op.get(n)) for n in names
            if meta.by_op.get(n) != card.by_op.get(n)}


def calibrate(torch, sa, dev, cfg, kind, tag, sd=None):
    """One ``kind`` ("train" or "prefill") step of ``cfg`` at batch 1,
    S DRYRUN_SEQ, or one "decode" step (``make_serve_step``) at
    DRYRUN_SLOTS slots over a DRYRUN_SEQ cache, on meta tensors and on
    the card (after a warm-up), each under ``launch.dryrun.WorkCounter``:
    FLOPs, bytes and kernel calls must be equal (decode: the op count
    too), and the card's launches of the step's kernel (B3; decode: the contiguous
    decode kernel, ``sd``) equal the calls counted on meta.  Prints the
    predicted memory (arguments + the meta run's peak of live bytes
    above them) beside the card's peak, and the card's step ms (CUDA
    events, no counter) beside the roofline's modeled max(compute,
    memory) of the counts.  Returns the counted card step's launches."""
    from repro_torch.launch.dryrun import WorkCounter
    from repro_torch.launch.roofline import H100_BF16_FLOPS, H100_HBM_BW
    from repro_torch.models import decode as dec
    from repro_torch.models.model import Model
    from repro_torch.optim.adamw import OptConfig
    from repro_torch.train.step import (init_train_state, make_prefill_step,
                                        make_serve_step, make_train_step)
    rng = np.random.default_rng(26)
    tok = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (1, DRYRUN_SEQ)).astype(np.int32))
    dtok = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (DRYRUN_SLOTS, 1)).astype(np.int32))

    def setup(device):
        t = tok.to(device)
        if kind == "decode":
            model = Model(cfg, device=device, seed=0)
            cache = dec.init_cache(cfg, DRYRUN_SLOTS, DRYRUN_SEQ,
                                   device=device)
            step = make_serve_step(cfg)
            d = dtok.to(device)
            pos = torch.full((), DRYRUN_SEQ // 2, dtype=torch.int32,
                             device=device)
            return (lambda: step(model, cache, d, pos)), [
                *model.parameters(), *_tensors(cache), d]
        if kind == "train":
            state = init_train_state(cfg, OptConfig(), device=device, seed=0)
            step = make_train_step(cfg, OptConfig())
            batch = {"tokens": t, "labels": t.clone()}
            held = [*state["params"].parameters(), state["opt"]["step"],
                    *state["opt"]["m"].values(), *state["opt"]["v"].values(),
                    *batch.values()]
            return (lambda: step(state, batch)), held
        model = Model(cfg, device=device, seed=0)
        step = make_prefill_step(cfg)
        return (lambda: step(model, {"tokens": t})), [*model.parameters(), t]

    run, held = setup(torch.device("meta"))
    args = sum(x.nbytes for x in held)
    t = time.time()
    with WorkCounter() as meta:
        run()
    meta_s = time.time() - t
    del run, held
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated()
    run, held = setup(dev)
    run()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_attn_counts(sa)
    if sd is not None:
        sd.sata_decode_attention_paged_kernel.launches = 0
        sd.sata_decode_attention_kernel.launches = 0
    with WorkCounter() as card:
        run()
        torch.cuda.synchronize()
    n_b3, n_b4 = attn_counts(sa)
    if kind == "decode":
        name = "sata_decode_attention_kernel"
        n_k, n_other = (sd.sata_decode_attention_kernel.launches,
                        sd.sata_decode_attention_paged_kernel.launches
                        + n_b3 + n_b4)
        what = "the contiguous decode kernel"
    else:
        name, n_k, n_other, what = ("sata_block_attention_compact", n_b3,
                                    n_b4, "B3")
    peak = torch.cuda.max_memory_allocated() - before
    ms = step_events_ms(torch, run)
    del run, held
    torch.cuda.empty_cache()
    diff = counts_differ(meta, card)
    if diff:
        log(f"[dryrun] {kind}: ops counted differently (meta, card): "
            f"{json.dumps(dict(list(diff.items())[:20]))}")
    assert card.flops == meta.flops and card.bytes == meta.bytes, \
        (kind, meta.flops, card.flops, meta.bytes, card.bytes)
    assert kind != "decode" or card.ops == meta.ops, (kind, meta.ops,
                                                      card.ops)
    assert card.kernels == meta.kernels, (kind, meta.kernels, card.kernels)
    calls = meta.kernels[name]["calls"]
    assert n_k == calls and n_other == 0, (kind, n_k, n_other, calls)
    compute = 1e3 * meta.flops / H100_BF16_FLOPS
    memory = 1e3 * meta.bytes / H100_HBM_BW
    shape = (f"{DRYRUN_SLOTS} slots over a {DRYRUN_SEQ}-token cache, "
             f"decode block {cfg.sata.kernel.block}" if kind == "decode"
             else f"batch 1, S {DRYRUN_SEQ}, kernel route, remat {cfg.remat}")
    log(f"[dryrun] {kind} step, qwen3-4b full width, {cfg.n_layers} layer, "
        f"{shape}: FLOPs {meta.flops} and bytes {meta.bytes} counted on "
        f"meta == on the card ({meta.ops} ops; {what} calls {calls} == "
        f"launches {n_k}; meta traced in {meta_s:.2f} s)")
    predicted = args + meta.peak_bytes
    log(f"[dryrun] {kind} memory: predicted {predicted / 2**30:.3f} GiB "
        f"(arguments {args / 2**30:.3f} + live peak "
        f"{meta.peak_bytes / 2**30:.3f}), card peak allocated "
        f"{peak / 2**30:.3f} GiB {tag}")
    log(f"[dryrun] {kind} time: card step {ms:.2f} ms (CUDA events, median "
        f"of 3, no counter) vs modeled max(compute {compute:.2f}, memory "
        f"{memory:.2f}) = {max(compute, memory):.2f} ms at the H100's "
        f"peaks: {ms / max(compute, memory):.2f}x {tag}")
    top = sorted(card.by_op.items(), key=lambda kv: -kv[1][2])[:5]
    log(f"[dryrun] {kind} most bytes: " + ", ".join(
        f"{n} x{c} {b / 2**30:.1f} GiB" for n, (c, f, b) in top))
    return n_k


def production_cells(root):
    """``python -m repro_torch.launch.roofline --arch A --shape S`` for
    each of DRYRUN_CELLS, each in a subprocess of its own, all at once
    (a fake 256-rank world never meets phases 24-25's gloo groups, and
    no subprocess sees the card): each probe's per-device arguments,
    temp, FLOPs and collective bytes by kind, the three terms modeled
    at the H100's data-sheet peaks, the dominant one, host seconds.
    Nothing here is measured on the card, so no line carries its tag."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="",
               PYTHONPATH=os.pathsep.join(
                   [os.path.join(root, "src"),
                    os.environ.get("PYTHONPATH", "")]))
    t = time.time()
    procs = [subprocess.Popen(
        [sys.executable, "-W", "ignore::FutureWarning", "-m",
         "repro_torch.launch.roofline", "--arch", arch, "--shape", shape],
        cwd=root, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for arch, shape in DRYRUN_CELLS]
    try:
        outs = [p.communicate(timeout=600) for p in procs]
    finally:
        for p in procs:
            p.kill()
            p.wait()
    for (arch, shape), p, (out, err) in zip(DRYRUN_CELLS, procs, outs):
        for line in out.splitlines():
            log(line)
        assert p.returncode == 0, err[-4000:]
        path = os.path.join(root, "build", "roofline",
                            f"{arch}__{shape}__pod1.json")
        with open(path) as f:
            r = json.load(f)
        terms = {k: round(v * 1e3, 3) for k, v in r["terms_s"].items()}
        log(f"[dryrun] {arch} x {shape} on the 16x16 mesh (rank 0, meta): "
            f"terms ms {terms} modeled on the host at the H100's "
            f"data-sheet peaks (not measured on a card), "
            f"{r['dominant']}-bound, useful {r['useful_ratio']:.3f}, "
            f"roofline fraction {r['roofline_fraction']:.3f}; probes "
            f"{[round(x, 1) for x in r['probe']['host_s']]} s on the host")
    log(f"[dryrun] {len(procs)} roofline subprocesses, side by side: "
        f"{time.time() - t:.1f} s")


def dryrun_phase(torch, sa, sd, dev, root, base, tag):
    """Phase 26: the dry run held to the card on qwen3-4b (phase 7's
    training config at 1 layer: train and prefill steps; the dry run's
    decode config at 1 layer: a serve step), then two production cells'
    rooflines.  Returns the B3 launches and the contiguous decode
    kernel's."""
    from repro_torch.launch.dryrun import main_path_cfg as cell_cfg
    cfg = main_path_cfg(dataclasses.replace(base, topk_impl="bisect",
                                            n_layers=1))
    n = calibrate(torch, sa, dev, cfg, "train", tag)
    n += calibrate(torch, sa, dev, cfg, "prefill", tag)
    n_dec = calibrate(torch, sa, dev, cell_cfg(dataclasses.replace(
        base, n_layers=1)), "decode", tag, sd=sd)
    production_cells(root)
    return n, n_dec


# ---------------------------------------------------------------------------

def main() -> int:
    # the training phase holds ~53 GB of parameters, gradients and moments
    # beside large transient buffers: let the allocator grow segments in
    # place rather than fragment
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False — this "
              "smoke test needs a CUDA GPU", file=sys.stderr)
        return 2
    root = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(root, "src", "repro_torch")):
        print("chip_smoke: src/repro_torch not found beside this script",
              file=sys.stderr)
        return 2
    if sys.argv[1:] == ["--mutants"]:
        return run_mutants(root)
    sys.path.insert(0, os.path.join(root, "src"))
    if sys.argv[1:2] == ["--ab"] and len(sys.argv) == 3:
        return run_ab(root, sys.argv[2])
    if sys.argv[1:2] == ["--ab-prefill"] and len(sys.argv) == 3:
        return run_ab_prefill(root, sys.argv[2])
    from repro_torch.configs.archs import ARCHS
    from repro_torch.kernels import build
    from repro_torch.kernels import sata_attention as sa
    from repro_torch.kernels import sata_decode as sd
    from repro_torch.launch.serve import ServeOptions, serve
    from repro_torch.models.model import DenseModel

    # no fp32 product on the path may run in TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = card_line()
    name = torch.cuda.get_device_name(0)
    tag = f"[{card}]"

    # --- 1. device and build
    clock = PhaseClock()
    log(f"[device] {card}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, {torch.cuda.device_count()} device(s); "
        f"tf32 matmul={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn={torch.backends.cudnn.allow_tf32}")
    build_all(build, root)
    clock.done("1 device and build")
    if sys.argv[1:] == ["--mesh"]:
        mesh_phase(torch, sd, dev, tag)
        clock.done("24-25, 27 scale-out, mesh training and mesh serving "
                   "on two ranks")
        clock.total()
        return 0
    if sys.argv[1:] == ["--dryrun"]:
        dryrun_phase(torch, sa, sd, dev, root, ARCHS["qwen3-4b"], tag)
        clock.done("26 dry run")
        clock.total()
        return 0

    # --- 2. kernel vs plain on the card
    keep, errs = check_kernels(torch, sd, dev)
    main_case = keep[MAIN]
    clock.done("2 kernel checks")

    # --- 3.-4. serve qwen3-4b at full width, paged, then contiguous
    base = ARCHS["qwen3-4b"]
    cfg = serve_cfg(base)
    opts = ServeOptions(n_requests=16, batch_slots=8, prompt_len=1024,
                        gen_len=64, max_len=4096)
    t = time.time()
    model = DenseModel(cfg, device=dev, seed=0)
    torch.cuda.synchronize()
    log(f"[serve] qwen3-4b: {describe(cfg)}; random weights (seed 0) "
        f"built in {time.time() - t:.1f} s")
    runs = serve_layouts(torch, sd, serve, cfg, model, opts, "serve", tag)
    del model
    torch.cuda.empty_cache()
    clock.done("3-4 serve qwen3-4b")

    # --- 5. kernel timing at the main-path shape, the moe shape (G = 16),
    # at B1 and at a long row
    kernels = []
    for layout in ("paged", "contiguous"):
        paged = layout == "paged"
        t = time_decode(torch, sd, main_case, "B8 KV8 G4 D128 page64 bf16",
                        paged, tag)
        t16 = time_decode(torch, sd, keep[G16], "B8 KV4 G16 D128 page64 "
                          "bf16 (qwen3-moe)", paged, tag)
        t64 = time_decode(torch, sd, keep[D64], "B8 KV8 G1 D64 page64 "
                          "bf16 (whisper-base)", paged, tag)
        t80 = time_decode(torch, sd, keep[D80], "B8 KV32 G1 D80 page64 "
                          "bf16 (zamba2-2.7b)", paged, tag)
        fn = sd.sata_decode_attention_paged_kernel if paged \
            else sd.sata_decode_attention_kernel
        kernels.append({
            "name": fn.__name__, "route": "cuda", "source": SRC_CU,
            "replaces": REPLACES[layout], "launches": runs[layout][1],
            "max_abs_err": max(errs.values()), **t, "g16": t16,
            "d64": t64, "d80": t80})
    # the contiguous kernel's partial mode (context-parallel decode)
    kernels[1]["partial_max_abs_err"] = max(
        check_partial(torch, sd, cname, keep[cname], tag)
        for cname in (MAIN, G16, D64, D80))
    kernels[1]["max_abs_err"] = max(kernels[1]["max_abs_err"],
                                    kernels[1]["partial_max_abs_err"])
    del keep
    for cname, c in extra_decode_cases(torch, dev):
        check_case(torch, sd, cname, c)
        for paged in (True, False):
            time_decode(torch, sd, c, cname, paged, tag)
        del c
    c = main_case
    # where a decode step's time goes: one layer's exact re-plan (the
    # served replan=1 path) at the same shape, beside the kernel
    from repro_torch.core.decode_plan import (decode_plan_update,
                                              init_decode_plan,
                                              summaries_from_cache,
                                              update_block_summaries)
    b = c["q"].shape[0]
    plan = init_decode_plan(b, 8, 4096, 128, 64, device=dev)
    lo, hi = summaries_from_cache(c["k"], c["pos"], k_block=64)
    plan["k_min"].copy_(lo)
    plan["k_max"].copy_(hi)
    k_new = c["k"][torch.arange(b, device=dev), c["pos"].long()][:, None]

    def planner():
        update_block_summaries(plan, k_new, c["pos"], k_block=64)
        decode_plan_update(plan, c["q"], c["kp"], c["pos"], topk_k=64,
                           k_block=64, page_table=c["table"])

    plan_ms = wall_ms(torch, planner, reps=20)
    step_ms = runs["paged"][0]["step_ms_mean"]
    per_layer = plan_ms + kernels[0]["ms"]
    log(f"[timing] per layer (paged, B8, exact re-plan over S=4096): "
        f"planner {plan_ms:.4f} ms (host clock) + decode kernel {kernels[0]['ms']:.4f} ms;"
        f" x {cfg.n_layers} layers = {cfg.n_layers * per_layer:.2f} ms of "
        f"the {step_ms:.2f} ms mean decode step "
        f"({100 * cfg.n_layers * per_layer / step_ms:.1f}%) {tag}")
    clock.done("5 decode kernel timing")
    # --- 6. the SATA prefill kernels against their plain versions
    check_attn_kernels(torch, sa, dev, tag)
    clock.done("6 prefill kernel checks")

    # --- 7.-10. the training path and the prefill kernels' timing
    kernels += prefill_phases(torch, sa, dev, base, tag, clock)

    # --- 11.-12. the shared-prefix cache and the summary backends, at
    # PREFIX_LAYERS: phase 3's paged serve again at that depth first, the
    # fp32 stream phase 12's int8 run must equal
    pcfg = serve_cfg(dataclasses.replace(base, n_layers=PREFIX_LAYERS))
    model = DenseModel(pcfg, device=dev, seed=0)
    fp32, _ = serve_full(torch, sd, serve, pcfg, model, opts,
                         f"fp32 {PREFIX_LAYERS} layers", tag)
    phase11 = prefix_cache_phase(torch, sd, serve, pcfg, model, opts, tag)
    summary_phase(torch, sd, serve, pcfg, model, opts, fp32["outputs"],
                  main_case, tag)
    clock.done("11-12 prefix cache and summary backends")

    # --- 13. host swap, crash, quarantine; serve checkpoint / resume
    fault_phase(torch, sd, pcfg, model, opts, phase11, tag)
    del model
    torch.cuda.empty_cache()
    checkpoint_phase(torch, sd, cfg, opts, dev, root, tag)
    clock.done("13 faults and checkpoint")

    # --- 14. the QoS ladder and cascade retirement
    kernels[0].update(overload_phases(torch, sd, serve, cfg, opts, dev,
                                      tag))
    clock.done("14 ladder and retirement")

    # --- 15. olmo-1b: the non-parametric norm, G = 1
    kernels[0]["paths"]["15 olmo-1b"] = olmo_phase(torch, sd, serve, opts,
                                                   dev, tag)
    clock.done("15 serve olmo-1b")

    # --- 16. qwen3-moe-235b-a22b: the moe FFN, the decode kernel at G = 16
    moe_out, kerr = moe_phase(torch, sd, serve, opts, dev, tag)
    kernels[0]["paths"]["16 qwen3-moe"] = \
        MOE_LAYERS * moe_out["steps"]
    kernels[0]["recorded_calls"]["16"] = kerr
    clock.done("16 serve qwen3-moe")

    # --- 17. qwen3-moe training through the compacted-grid kernel
    kernels[2]["paths"] = {"17 qwen3-moe training": moe_train_phase(
        torch, sa, dev, tag)}
    clock.done("17 train qwen3-moe")

    # --- 18. llama-3.2-vision-90b: cross layers, B2 at G = 8
    n_b2, kerr = vlm_phase(torch, sd, serve, dev, tag)
    kernels[1]["paths"] = {"18 llama-3.2-vision": n_b2}
    kernels[1]["recorded_calls"] = {"18": kerr}
    clock.done("18 serve llama-3.2-vision-90b")

    # --- 19. whisper-base: the encoder, B1 / B2 at D = 64
    n_b1, n_b2, kerr = whisper_phase(torch, sd, serve, dev, tag)
    kernels[0]["paths"]["19 whisper-base"] = n_b1
    kernels[1]["paths"]["19 whisper-base"] = n_b2
    kernels[0]["recorded_calls"]["19"] = kerr
    clock.done("19 serve whisper-base")

    # --- 20. zamba2-2.7b: the mamba backbone, B1 / B2 at D = 80
    n_b1, n_b2, kerr = zamba2_phase(torch, sd, serve, dev, tag)
    kernels[0]["paths"]["20 zamba2-2.7b"] = n_b1
    kernels[1]["paths"]["20 zamba2-2.7b"] = n_b2
    kernels[0]["recorded_calls"]["20"] = kerr
    clock.done("20 serve zamba2-2.7b")

    # --- 21. rwkv6-1.6b: the recurrent state, no kernel
    rwkv_phase(torch, sd, sa, serve, dev, tag)
    clock.done("21 serve rwkv6-1.6b")

    # --- 22. the paper's scheduler and estimation plane, the quickstart's
    # kernel step at a layer's width, the kernel roofline
    (n_b3, n_b4), kerr, roof = scheduler_phases(torch, sa, dev, root, tag)
    path = "22 quickstart kernel step"
    kernels[2]["paths"][path] = n_b3
    kernels[3].setdefault("paths", {})[path] = n_b4
    kernels[2].setdefault("recorded_calls", {})["22"] = kerr["compact"]
    kernels[3].setdefault("recorded_calls", {})["22"] = kerr["dense"]
    kernels[2]["roofline"] = roof
    for k in kernels:
        k["max_abs_err"] = max(k["max_abs_err"],
                               *k.get("recorded_calls", {}).values())
    clock.done("22 scheduler plane, kernel step and roofline")

    # --- 23. two replicas around the cross-replica prefix index
    kernels[0]["paths"]["23 replicas"] = replica_phase(
        torch, sd, serve_cfg(dataclasses.replace(base,
                                                 n_layers=REPLICA_LAYERS)),
        opts, dev, tag)
    clock.done("23 cross-replica prefix index")

    # --- 24.-25. tensor-parallel decode and sequence-sharded selection on
    # two gloo ranks sharing the card; then train(mesh=) in the same world
    n_b1, n_b2, n_b3, n_serve = mesh_phase(torch, sd, dev, tag)
    kernels[0]["paths"]["24 tensor-parallel decode"] = n_b1
    kernels[1]["paths"]["24 tensor-parallel decode"] = n_b2
    kernels[2]["paths"]["25 train(mesh=): qwen3-4b (2, 1) + (1, 2) + "
                        "(1, 2) context-parallel, qwen3-moe, zamba2, rwkv6 "
                        "bf16 and fp32 (1, 2)"] = n_b3
    path = ("27 make_serve_step(mesh=) (1, 2): qwen3-4b, zamba2, rwkv6, "
            "qwen3-moe, bf16 and fp32; (2, 1): qwen3-moe")
    kernels[0]["paths"][path] = n_serve["paged"]
    kernels[1]["paths"][path] = n_serve["contiguous"]
    kernels[1]["paths"]["27 context-parallel decode (1, 2), the keys split "
                        "over model, the partial mode: qwen3-4b bf16 and "
                        "fp32, zamba2 fp32"] = n_serve["cp"]
    clock.done("24-25, 27 scale-out, mesh training and mesh serving on "
               "two ranks")

    # --- 26. the dry run against the card; two production cells' rooflines
    n_b3, n_b2 = dryrun_phase(torch, sa, sd, dev, root, base, tag)
    kernels[2]["paths"]["26 dry-run calibration: qwen3-4b 1 layer, a "
                        "train and a prefill step"] = n_b3
    kernels[1]["paths"]["26 dry-run calibration: qwen3-4b 1 layer, a "
                        "serve step"] = n_b2
    clock.done("26 dry run")
    clock.total()
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
