#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Runs from the root of a checkout (it imports ``src/repro_torch``, never JAX
or the JAX package) and needs one CUDA card; with no card, or without the
rest of the repository, it exits non-zero before printing any result.

Phases, in order; any failure ends the run with a non-zero exit:

1. the card (``nvidia-smi`` name and power limit), torch and CUDA versions;
   TF32 off for matmuls and convolutions;
2. build every CUDA kernel from ``src/repro_torch/csrc`` (one ``nvcc`` per
   source, all at once);
3. each kernel against its plain PyTorch version on the card at the
   shapes of pquant-1.3b: the decode tier at M in {1, 4, 5, 8, 16, 32}, the
   prefill tier (``w1a8_matmul``, ``decoupled_matmul``, ``int8_matmul``,
   ``rmsnorm_quant``) at M in {33, 64, 512, 8192}, ``int8_matmul``,
   ``w1a8_matmul`` and ``decoupled_matmul`` also at 1024 (a chunked
   slice), ``int8_matmul`` at both tiers' rows.  The GEMMs and GEMVs must
   agree within rtol 1e-6 (they are built to agree bit for bit: the decode
   GEMVs are held with x and the output each in f32 and bf16, the prefill
   GEMMs and ``int8_matmul`` with the output in f32 and bf16,
   ``w1a8_matmul`` and ``int8_matmul`` also at ragged (K, N),
   ``decoupled_matmul`` at ragged (K, N, r); the prefill GEMMs log the
   route each shape takes); the bf16 GEMVs are timed at 4, 16 and 32 rows, the bf16
   ``int8_matmul`` above 32 rows, the bf16 ``w1a8_matmul`` at 8192, with
   the int8 TOP/s of each prefill GEMM; ``rmsnorm_quant`` within its stated
   tolerance (RMSNORM_*), timed in bf16 and f32, also held at d 2880 and
   100 (its two routes), with the route of each shape.  Prints the
   kernel's median time (CUDA events, weights, or ``rmsnorm_quant``'s
   rows, rotated through more copies than the 50 MB L2 holds), the
   host's time to issue one call, the plain version's time, the bound
   (bytes over the card's memory rate, or operations over its int8 rate)
   and, where one PyTorch call computes the same product
   (``torch._int_mm`` on the unpacked signs: the prefill GEMMs at every M,
   the decode GEMVs at 32 rows, the first M it takes), its time;
   ``decoupled_matmul`` also at the row counts of phase 8 (a)'s admission
   prefills (its prompts bucketed to 64-512 rows);
4. the slice at full width: pquant-1.3b from a fixed seed, exported packed,
   served by ``DecodeEngine`` to 4 requests of 8-token prompts (prefill M =
   32 rows) with 32 greedy new tokens.  Checks finite logits, one host
   transfer per call, the launch count of every kernel (layers x (5, 2, 1)
   x forwards) and a repeatable stream; prints TTFT, decode tokens/s and
   the time per step (medians of 5 runs), and the device's busy share and
   kernel time by name from torch.profiler;
5. the same export cut to 2 layers on the card and on the CPU (plain
   versions): prefill logits allclose within the stated tolerance, equal
   greedy streams — at 4 x 8 tokens (the decode tier) and at 40 x 8 tokens
   (the prefill tier: 320 prefill rows, then 40 decode rows);
6. the prefill tier at full width: the same model served by
   ``DecodeEngine`` to 64 requests of 128-token prompts (8192 prefill
   rows, then decode at 64 rows) with 16 greedy new tokens.  Checks finite
   logits, one host transfer per call, a repeatable stream and the launch
   counts (layers x (5, 2, 1) x forwards of ``w1a8_matmul`` /
   ``decoupled_matmul`` / ``int8_matmul``, none of the decode GEMVs);
   prints TTFT, ms/step and tokens/s (medians of 3) and the device's busy
   share and kernel time by name, of the whole generate and of the
   prefill alone; then drives ``ops.fused_rmsnorm_quant`` (the entry point of
   ``rmsnorm_quant``, which no model calls) on the prompts' 8192 x 2048
   embeddings and holds it to its plain version;
7. the status of every TPU kernel of the JAX package (ported and checked,
   or still to port);
8. continuous batching at full width: ``ContinuousBatchingEngine`` serves
   the same model (16 slots, 512 positions, blocks of 16, chunks of 8,
   greedy) to 32 requests from seed 0 (prompts of 16-384 tokens, 8-32 new
   tokens; 16 arrive at tick 0, then one per tick) in five configurations:
   (a) paged, one-shot admission; (b) paged, ``prefill_chunk`` 64; (c)
   paged with ``REPRO_PAGED_ATTN=0`` (the gather path); (d) dense; (e)
   paged with a third of the blocks (forces preemption).  Prints TTFT p50
   and p99, tokens/s, ms per engine step, the device busy share and the
   decode GEMVs' device time (engine steps 4-5 profiled on a second run),
   preemptions and launches per kernel; fails unless (c) equals (d) and
   (e) equals (a) stream for stream, (e) preempted, every pool drained,
   ``paged_attention`` launched layers x (decode steps + chunked slices)
   times on (a), (b), (e) and never on (c), (d), and every request
   finished once by length;
9. the kernel route against the gather route on a 2-layer cut of the same
   model and load: every paged attention call of (a) and (b) held to the
   gather on the same inputs (``PA_ATOL``); (a) against (c) with their
   decode-tier act-quant passes traced: each slot's decode logits within
   ``LOGIT_TOL`` of their scale before its first act-quant code that
   differs, and that code a rounding tie (as in phase 5); then the streams
   (a) vs (c), (b) vs (a) and (a) vs ``DecodeEngine`` batch-1 (8
   requests), equal or parting (with the top-2 gap of the teacher-forced
   reference at the parting, against ``NEAR_TIE``), and how many phase 8
   streams matched at full depth;
10. the QAT training step: ``trainer.make_train_step`` on full-width
   pquant-1.3b from ``SEED`` (f32 master, bf16 forward, remat on, accum
   1) at 4 x 2048 tokens a step from a seeded generator (labels the next
   tokens): 2 warm-up steps, 5 timed (synchronized wall), one profiled.
   The schedule's warm-up starts at lr 0, so step 0 must move no watched
   parameter and step 1 (lr > 0) at least one; one more step runs with
   CUDA's sync debug mode on and must not sync.  Prints the median ms a
   step, tokens/s, ``max_memory_allocated``, the model FLOPs a step (its
   formula printed) and TFLOP/s, the device's busy share and time by
   kernel; fails unless every loss, nll and gradient norm is finite and
   the first loss is within ln(vocab) +- 1.5.  Then card vs CPU: one
   ``loss_fn`` with gradients of a 2-layer f32 cut at 2 x 64 tokens, held
   by the rule of ``tests/test_torch_train.py``: every gradient leaf
   within ``GRAD_RTOL`` of its largest element with the CPU's act-quant
   decisions replayed on the card; primary flips (ties decided two ways)
   at most ``FLIP_RATE`` of the codes; the loss within ``TRAIN_ATOL``
   plus one flip's reach on the tokens that met a differing code.
   Training launches none of the seven kernels.
11. the training loop around the step: ``Trainer`` on the same model and
   tokens a step, data from the port's ``PrefetchIterator`` over
   ``SyntheticSource``.  First with probes off, then on (each a fresh
   Trainer: 2 warm-up steps, 5 timed by the Trainer's own ``step_time_s``,
   one more profiled): exactly one host sync a step (CUDA's sync debug
   mode), the median ms a step, the probes' share of it and the busy share.
   Then the lifecycle run (on 2 of the 24 layers, ``LOOP_LIFECYCLE_LAYERS``,
   so that the whole run keeps room for phases 13 and 14): 8 steps with probes, the democratization
   snapshot and a checkpoint every 4 (``keep=1``, into a temporary
   directory that the phase removes), history, trace and heartbeat files;
   step 6 writes NaN into a master leaf and reports a NaN loss, so the
   Trainer restores the checkpoint of step 4 (``from_step`` 5); checks one
   sync in each step without a checkpoint, snapshot or recovery, finite
   losses and probes, the history, the trace's events and the heartbeat.
   Then a second Trainer (another init seed) resumes from the last
   checkpoint: every leaf (params, moments, step) must equal the first
   Trainer's final state bit for bit; it takes the 2 remaining steps and
   saves nothing.
   Prints the seconds and bytes of each save (host snapshot, then the
   write, waited for at once) and restore, the peak memory, and fails if
   any of the seven kernels was launched.

12. pQuant's routed 8-bit experts (paper §3.3): pquant-1.3b with 8
   experts (``EXPERTS``; top-1 router, the 1-bit trunk the shared expert)
   at full width from ``SEED``, 2 of its 24 layers (``EXPERTS_LAYERS``:
   every layer alike, the counts per layer unchanged; the depth gives
   phases 13 and 14 room), exported packed (experts int8,
   one scale a (layer, expert) slice; router float).  (a) ``DecodeEngine``
   on [4]'s load: finite logits, one transfer a call, a repeatable
   stream, ``w1a8_gemv`` launched layers x 7 x forwards (q/k/v/o and the
   trunk's three linears; the experts run dequantized in float, as
   upstream) and no other kernel; TTFT, ms/step, tokens/s (medians of
   5), busy share and kernel time by name, the export's bytes.  (b) [6]'s
   load (8192 prefill rows, capacity 1280 an expert): ``w1a8_matmul``
   layers x 7 x forwards, no other kernel; TTFT and the tokens dropped by
   capacity in the prefill, summed over the layers.  (c)
   ``ContinuousBatchingEngine`` on [8] (a)'s load, paged on the kernel
   route and dense (admission prefill at exact length: chunking and
   bucketing are declined for routed configs): every request finished
   once by length, the pool drained, ``paged_attention`` launched layers
   x decode steps on the kernel route and never dense, the streams
   compared as phase 9 compares its full-depth ones (equal, or the top-2
   gap where one parts: one act-quant tie spreads); wall, TTFT p50 / p99.  (d)
   phase 5's checks on a 2-layer cut of the routed export, with the
   router choices that differ between card and CPU counted.  (e)
   ``make_train_step`` at [10]'s shape (bf16, remat; 2 warm-up and 5
   timed steps): finite losses, the first within ln V +- 1.5, ``aux``
   finite and above 0, step 0 (lr 0) leaves the router, step 1 moves it
   and every expert of layer 0 that took a token, no host sync in a step,
   ``qat_router_entropy`` of a probes step in [0, 1]; ms a step,
   tokens/s, peak memory, busy share, model TFLOP/s over the active
   parameters (one expert of eight; formula printed).  (f) [10]'s card
   vs CPU gradient check on a 2-layer f32 cut with 8 experts, the CPU's
   act-quant and routing decisions replayed on the card.

13. DeepSeek-MoE (``models/moe.py``): deepseek-moe-16b at full width and
   depth (28 layers: one dense of d_ff 10944, then 27 MoE layers of 64
   routed 1-bit experts top-6 of width 1408 and 2 shared decoupled
   experts; 16 heads of 128, r 128, vocab 102400 untied) from ``SEED``.
   (a) the packed export built on the card one layer at a time (16.4e9
   f32 latents do not fit), held leaf for leaf, bit for bit, to the
   one-shot export of the same latents on a 3-layer cut; its GB.  (b)
   ``DecodeEngine``, 4 requests of 8 tokens, 8 new: finite logits, one
   transfer, exactly 28 x 5 + 27 x 64 x 3 = 5324 ``w1a8_gemv``, 56
   ``decoupled_gemv`` and 28 ``int8_matmul`` launches a forward and no
   other kernel; TTFT, ms/step, tokens/s (medians of 2), busy share.
   (c) 16 requests of 256 tokens (4096 prefill rows, capacity 480 an
   expert), 8 new: the prefill's launches exactly 5324 ``w1a8_matmul``,
   56 ``decoupled_matmul`` and 28 ``int8_matmul``, the generate's with
   7 decode forwards on the GEMVs; TTFT and the routings dropped by
   capacity.  (d) ``ContinuousBatchingEngine`` on a 4-layer cut of the
   export (1 dense + 3 MoE), 4 slots of 160 positions, 5 requests from
   ``SEED`` (prompts 16-128, 8-16 new; ``MOE_CB``), paged on the kernel
   route and dense: each request finished once by length, the pool
   drained, ``paged_attention`` (head_dim 128) launched 4 x decode
   steps on the kernel route and never dense, the streams compared as
   phase 9 compares them.  (e) phase 5's checks on a 2-layer cut (the
   dense layer and the first MoE layer) at (b)'s prompts, with the
   CPU's router choices replayed on the card and the choices the card
   computes counted.  (f) ``make_train_step`` on a 3-layer cut (1 dense +
   2 MoE; bf16, remat, 2 x 2048 tokens): finite losses, the first within
   ln V +- 1.5, step 0 (lr 0) moves nothing watched, step 1 moves the
   first MoE layer's router, shared FFN and every expert that took a
   token, no host sync, ``qat_router_entropy`` in [0, 1], aux > 0; ms a
   step, tokens/s, peak memory, busy share, model TFLOP/s; then [10]'s
   card vs CPU gradient check on the 2-layer cut in f32 with both kinds
   of decision replayed.

14. sliding-window and local/global attention: gemma3-27b at full width
   and depth (62 layers: 10 repeats of 5 local layers, a 1024-token window
   at rope theta 1e4, and a global one at 1e6, then 2 local; 32 heads over
   16 KV heads of 128, GeGLU of 21504, r 1024, vocab 262144 tied) from
   ``SEED``.  (a) the packed export built on the card one block at a time
   (28.0e9 f32 latents do not fit), held leaf for leaf, bit for bit, to
   the one-shot export on a 12-layer cut (its segment stacked over two
   repeats, no ``lm_head``); its GB.  (b) ``DecodeEngine``, 4 requests of
   1100 tokens (every ring wraps in the prefill), 16 new: one transfer,
   exactly 310 ``w1a8_matmul``, 124 ``decoupled_matmul`` and 62
   ``int8_matmul`` launches in the prefill and 310 / 124 / 62 decode-tier
   launches a decode forward, no ``paged_attention`` (dense layout), no
   plain version called; TTFT (the prefill, synchronized where it ends)
   and ms/step from that generate, a second generate repeating the
   stream, the busy share of 3 decode steps.  (c)
   ``ContinuousBatchingEngine`` on the first 12 layers (two periods: 10
   local, 2 global), 4 slots of 1280 positions, 8 requests
   from ``SEED`` (prompts 64-256 and one of 1100, whose rings wrap, 8-16
   new; ``SWA_CB``; one-shot admission at exact length: a ring shorter
   than the slot declines the buckets), paged on
   the kernel route (the 2 global layers on the pool, the local layers
   on dense rings) and dense: each request finished once by length, the
   pool drained, ``paged_attention`` (GQA 32 over 16 heads of 128)
   launched 2 x (decode steps + slices) times on the kernel route and
   never dense, every paged attention call of the kernel route held to
   the gather route on the same inputs within ``PA_ATOL``, the streams
   compared as phase 9 compares them.  (d) a
   2-layer cut of the export (one local layer of a 32-token window, one
   global) at 4 x 48-token prompts, 2 new: phase 5's checks with its tie rule;
   then [10]'s card vs CPU gradient check on the same cut in f32 at 2 x 64
   tokens.  (e) h2o-danube-1.8b at full width (24 layers, each a
   4096-token window; 32 heads over 8 KV heads of 80, vocab 32000
   untied) on its first 8 layers, ``DecodeEngine`` on 2 requests of 4160
   tokens, 8 new: the launches (8 x (5, 2, 1) a forward, no
   ``paged_attention``), TTFT and ms/step.  (f) ``make_train_step`` on
   it at full width and depth (bf16,
   remat) at 1 x 6144 tokens (past the window): finite losses, the first
   within ln V +- 1.5, step 0 (lr 0) moves nothing watched and step 1
   does, no host sync; ms a step, tokens/s, peak memory, busy share.

15. Multi-head Latent Attention: deepseek-v2-236b at full width and
   depth (60 layers: one dense of d_ff 12288, then 59 MoE layers of 160
   routed 1-bit experts top-6 of width 1536 and 2 shared decoupled
   experts; MLA with 128 heads, q_lora 1536, kv_lora 512, qk 128 + 64
   rope, v 128; r 256, vocab 102400 untied) from ``SEED``, its latent
   caches dense and f32 in both layouts.  (a) the packed export built on
   the card one block at a time (236e9 f32 latents, one MoE block 15.1
   GB), held leaf for leaf, bit for bit, to the one-shot export on a
   3-layer cut (1 dense + 2 MoE); its GB by kind, the device memory held.
   (b) ``DecodeEngine``, 4 requests of 32 tokens, 8 new: one transfer, no
   plain version called, exactly the launches ``_mla_launches`` derives
   (a decode forward 60 x 5 + 59 x 160 x 3 = 28620 ``w1a8_gemv``, 60
   ``w1a8_matmul``: the latent expansion over 4 x 40 cache rows, 120
   ``decoupled_gemv``, 60 ``int8_matmul``; the 128-row prefill on the
   GEMMs but its experts' 8-row buffers); TTFT (synchronized where the
   prefill ends) and ms/step of two generates (the second repeating the
   stream); finite logits of a prefill and a decode step; the busy share
   of one decode step.  (c) 8 requests of 256 tokens (2048 prefill rows,
   capacity 96 an expert), one new token, twice: the launches exactly
   ``w1a8_matmul``, ``decoupled_matmul`` and ``int8_matmul``; TTFT and
   the routings dropped by capacity.  (d) ``ContinuousBatchingEngine`` on
   a 4-layer cut of the export (1 dense + 3 MoE), 4 slots of 272
   positions, 5 requests from ``SEED`` (prompts 16-256, 4-8 new;
   ``MLA_CB``), paged (no layer on the pool: the allocator's bookkeeping
   only) and dense: each request finished once by length, the pool
   drained, no ``paged_attention`` launch, a ``w1a8_matmul`` expansion a
   layer and decode step, every stream equal across the layouts.  (e)
   phase 5's checks on a 2-layer cut (the dense layer and the first MoE
   layer) at 4 x 8 tokens, 2 new, with the CPU's router choices replayed
   on the card; then the dense layer's MLA, an 8-token ``mla_chunk``
   against 8 ``mla_decode`` steps on the card: the latent caches and the
   outputs, each bit for bit or by how much, the outputs within
   ``LOGIT_TOL`` of their largest.  (f) ``make_train_step`` on a 2-layer cut at full width
   with 32 of the 160 routed experts (top-6 and the 2 shared kept; bf16,
   remat, 2 x 2048 tokens): finite losses, the first within ln V +- 1.5,
   step 0 moves nothing watched, step 1 moves the dense layer's MLA
   projections, ``q_norm``, ``kv_norm``, ``subln``, the router and every
   expert that took a token, no host sync; ms a step, tokens/s, peak
   memory, busy share, model TFLOP/s (attention at H (d_qk + d_v)); then
   [10]'s card vs CPU gradient check on the 2 layers in f32 with 8 routed
   experts, both kinds of decision replayed, under phase 13's rules.

Phase 3 also holds the kernels at deepseek-moe-16b's shapes (tagged
"moe"): the W1A8 linears (2048, 1408), (1408, 2048), (10944, 2048) and
(2816, 2048) at the decode rows (an expert's 8 rows, seven of them zero),
at an expert's 480 and 960 prefill rows (the last 80 zero) and at 4096;
the fused pairs (2048, 10944, 128) and (2048, 2816, 128); ``int8_matmul``
at K 128; ``paged_attention`` at head_dim 128 over 4 slots of 160
positions ("d128").  It holds them at phase 14's shapes too (tagged
"gemma" and "danube"): the W1A8 linears of gemma3-27b (5376, 4096),
(5376, 2048), (4096, 5376), (21504, 5376) and of h2o-danube-1.8b (2560,
2560), (2560, 640), (6912, 2560) at every decode row (timed at 4 / 2 rows
and at 32) and at the prefill rows 1100 and 4400 / 8320; the fused pairs
(5376, 21504, 1024) and (2560, 6912, 384) likewise; ``int8_matmul`` at K
1024 and 384; ``paged_attention`` at GQA 32 over 16 heads of 128 over 4
slots of 1280 positions ("gemma").  And at phase 15's (tagged "mla"):
the W1A8 linears of deepseek-v2-236b (5120, 1536), (1536, 24576), (5120,
576), (16384, 5120), (1536, 5120), (3072, 5120), (12288, 5120) at every
decode row (timed at 4 and at 32) and, on the GEMMs, at (c)'s 2048
prefill rows (an expert's at its capacity of 96, the last 16 rows zero),
the latent expansion (512, 32768) at (b)'s 160 cache rows and at 2048;
the fused pairs (5120, 3072, 256) and (5120, 12288, 256); ``int8_matmul``
at K 256.  Phase 3 also holds
``paged_attention`` against its plain version at phase 8's shapes (decode over ragged lengths up to 512, f32 and bf16 pools, GQA;
a 64-token chunked slice) within ``PA_ATOL``, beside its bound and the
time of ``scaled_dot_product_attention`` on the gathered view.

The line before the last is the JSON record of the ported kernels; the
last line is ``{"ok": true, "device": {...}}``.

    python3 chip_smoke.py --kernel NAME [--src OTHER/src]

with NAME any kernel of phase 3 (``w1a8_gemv``, ``decoupled_gemv``,
``int8_matmul``, ``w1a8_matmul``, ``decoupled_matmul``,
``paged_attention``, ``rmsnorm_quant``) runs phases 1-2, then only that
kernel's phase-3 rows (of the
``repro_torch`` under ``--src`` when given, say the ``src`` of a ``git
archive`` of the parent commit unpacked under ``_checkouts/``), prints
one JSON line of those rows and exits non-zero on any mismatch; it
never prints the ``{"ok": ...}`` line.  Two trees are timed in one call
by running it once for each, by turns.  The tree under ``--src`` must
have the wrappers this file calls (the GEMVs' ``out_dtype``,
``w1a8_matmul_route``, ``decoupled_matmul_route``); an older tree is
timed with its own ``chip_smoke.py``.

    python3 chip_smoke.py --serving [--src OTHER/src]

runs phases 1-2, 4, 6 and 8 alone, with their checks (of the tree under
``--src`` when given), and prints one JSON line of phase 6's summary and
phase 8's records.  It is how a kernel's redesign is timed end to end:
run it on the parent's tree and on the change's by turns, in one call.

    python3 chip_smoke.py --train

runs phases 1, 10 and 11 alone (no kernel build: training launches none)
and prints one JSON line of the summaries of phases 10 and 11.

    python3 chip_smoke.py --experts

runs phases 1, 2 and 12 alone and prints one JSON line of phase 12's
launch counts and summary.

    python3 chip_smoke.py --moe

runs phases 1, 2 and 13 alone and prints one JSON line of phase 13's
launch counts and summary.

    python3 chip_smoke.py --swa

runs phases 1, 2 and 14 alone and prints one JSON line of phase 14's
launch counts and summary.

    python3 chip_smoke.py --mla

runs phases 1, 2 and 15 alone and prints one JSON line of phase 15's
launch counts and summary.

    python3 chip_smoke.py --pairs OTHER_CHECKOUT N

times phase 4's decode path of this checkout against another one (say, a
``git archive`` of the parent commit unpacked under ``_checkouts/``) in N
alternating pairs of fresh processes, and prints the comparison as JSON.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import gc
import itertools
import json
import math
import statistics
import subprocess
import sys
import time
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SEED = 0

# pquant-1.3b decode-path shapes: (name, K, N[, r]) and the token rows
W1A8_SHAPES = ((2048, 2048), (5024, 2048))  # q/k/v/o; w1_down
DECOUPLED_SHAPE = (2048, 5024, 384)  # up/gate pairs: K, N, r
INT8_SHAPE = (384, 2048)  # w8_down: K, N
INT8_RAGGED = ((16, 64), (400, 72), (20, 66))  # general (K, N) of int8_matmul
ROWS = (1, 4, 5, 8, 16, 32)
PREFILL_ROWS = (33, 64, 512, 8192)
# phase 8 (a)'s admission prefills above the decode tier: prompts of 16-384
# tokens bucketed to a power of two (scheduler _bucket_len), batch 1
CB_ADMISSION_ROWS = (64, 128, 256, 512)
CHUNK_ROWS = 1024  # a chunked-prefill slice of phase 8 (b): 16 requests x 64 tokens
DECOUPLED_MATMUL_ROWS = tuple(sorted(set(PREFILL_ROWS + CB_ADMISSION_ROWS + (CHUNK_ROWS,))))
# general (K, N, r) of decoupled_matmul: N or r off 16, so the mma route
DECOUPLED_RAGGED = ((400, 72, 36), (2048, 5024, 100))
INT8_ROWS = ROWS + PREFILL_ROWS + (CHUNK_ROWS,)
W1A8_MATMUL_ROWS = (33, 64, 512, CHUNK_ROWS, 8192)
W1A8_RAGGED = ((400, 72), (16, 64))  # general (K, N) of w1a8_matmul (N 72: the mma route)
# deepseek-moe-16b's shapes (phase 13) that no pquant-1.3b path gives:
# the W1A8 linears' (K, N) with the rows the path gives each (an expert's
# capacity at decode is 8: 7 or more of its rows are sentinel zeros);
# the dense and shared up/gate pairs (K, N, r); w8_down at r 128
MOE_W1A8_SHAPES = ((2048, 1408), (1408, 2048), (10944, 2048), (2816, 2048))
MOE_W1A8_DECODE_ROWS = (8, 8, 4, 4)  # expert gate/up, expert down, dense and shared w1_down
MOE_EXPERT_ROWS = (480, 960)  # an expert's capacity at 4096 / 8192 prefill rows
MOE_PREFILL_ROWS = 4096  # [13] (c): 16 requests x 256 tokens
MOE_ADMISSION_ROWS = 128  # [13] (d)'s longest admission prefill (batch 1)
MOE_DECOUPLED_SHAPES = ((2048, 10944, 128), (2048, 2816, 128))
MOE_INT8_SHAPE = (128, 2048)
# gemma3-27b's and h2o-danube-1.8b's shapes (phase 14): the W1A8 linears
# (q, k/v, o, w1_down), the fused up/gate pair (K, N, r) and w8_down (K,
# N); the decode rows each path gives them (gemma's 4 requests and 4
# slots, danube's 2 requests) and the prefill rows ((b)'s 4 x 1100, (c)'s
# longest admission, 1100 at batch 1; (e)'s 2 x 4160)
SWA_W1A8_SHAPES = {"gemma": ((5376, 4096), (5376, 2048), (4096, 5376), (21504, 5376)),
                   "danube": ((2560, 2560), (2560, 640), (6912, 2560))}
SWA_DECOUPLED_SHAPES = {"gemma": (5376, 21504, 1024), "danube": (2560, 6912, 384)}
SWA_INT8_SHAPES = {"gemma": (1024, 5376), "danube": (384, 2560)}
SWA_DECODE_ROWS = {"gemma": 4, "danube": 2}
SWA_PREFILL_ROWS = {"gemma": (1100, 4400), "danube": (8320,)}
# deepseek-v2-236b's shapes (phase 15): the W1A8 linears (K, N): wq_down
# (and a routed expert's gate/up), wq_up, wkv_down (the latent and the
# shared rope key), wo, a routed expert's down, the shared and the dense
# FFN's w1_down; the latent expansion wkv_up over B x L cache rows; the
# shared and dense up/gate pairs (K, N, r) and w8_down (K, N); the rows of
# [15]: (b)'s 4 requests and its decode expansion over 4 x 40 positions,
# (c)'s 8 x 256 prefill rows and an expert's capacity there (96: 2048 x 6
# x 1.25 / 160)
MLA_W1A8_SHAPES = ((5120, 1536), (1536, 24576), (5120, 576), (16384, 5120), (1536, 5120),
                   (3072, 5120), (12288, 5120))
MLA_EXPERT_SHAPES = ((5120, 1536), (1536, 5120))
MLA_EXPAND_SHAPE = (512, 32768)
MLA_DECOUPLED_SHAPES = ((5120, 3072, 256), (5120, 12288, 256))
MLA_INT8_SHAPE = (256, 5120)
MLA_DECODE_ROWS, MLA_EXPAND_ROWS, MLA_PREFILL_ROWS, MLA_EXPERT_ROWS = 4, 160, 2048, 96
MAIN_ROWS = 4  # decode rows of the decode-tier path (4 requests)
SLOT_ROWS = 16  # decode rows of the continuous-batching path (16 slots)
BF16_GEMV_ROWS = (MAIN_ROWS, SLOT_ROWS, 32)  # the GEMV rows also timed in bf16
LIB_GEMV_ROWS = 32  # the GEMV rows timed beside torch._int_mm (it takes M > 16)
PREFILL_MAIN_ROWS = 8192  # prefill rows of the prefill-tier path (64 x 128 tokens)
RTOL = 1e-6  # kernel vs plain version (built to agree exactly)
# rmsnorm_quant vs its plain version: the kernel sums the squares in
# another order and its rsqrtf is not correctly rounded, so normed differs
# in its last bits; gamma must agree to RMSNORM_RTOL, every int8 code
# within one step, and at most RMSNORM_CODE_SHARE of the codes may differ
RMSNORM_RTOL = 1e-5
RMSNORM_CODE_SHARE = 1e-3
D_MODEL = 2048

# end-to-end run
BATCH, PROMPT, NEW_TOKENS = 4, 8, 32
TIMED_RUNS = 5
CUT_LAYERS, CUT_NEW_TOKENS = 2, 8
CUT_PREFILL_BATCH = 40  # 40 x 8 = 320 prefill rows, then 40 decode rows
# the prefill tier end to end
P_BATCH, P_PROMPT, P_NEW_TOKENS = 64, 128, 16
P_TIMED_RUNS = 3
# card vs CPU logits while no int8 activation code differs: the float ops
# around the kernels (norms, attention, SiLU, unembedding) round
# differently on the two devices and leave the logits ulps apart
LOGIT_TOL = 1e-3
# once a code differs (phase 5): the first one must be a rounding tie, its
# scaled values x * gamma on the two devices within BOUNDARY_TOL (of one
# int8 step), with the float inputs up to it within FLOAT_NOISE of max|x|
BOUNDARY_TOL = 1e-3
FLOAT_NOISE = 1e-5

# every pl.pallas_call of the JAX package: (name, file:line, ported by this path)
TPU_KERNELS = (
    ("w1a8_gemv", "src/repro/kernels/w1a8_gemv.py:119", "src/repro_torch/csrc/w1a8_gemv.cu"),
    ("decoupled_gemv", "src/repro/kernels/w1a8_gemv.py:223", "src/repro_torch/csrc/w1a8_gemv.cu"),
    ("int8_matmul", "src/repro/kernels/int8_matmul.py:61", "src/repro_torch/csrc/int8_matmul.cu"),
    ("w1a8_matmul", "src/repro/kernels/w1a8_matmul.py:92", "src/repro_torch/csrc/w1a8_matmul.cu"),
    ("decoupled_matmul", "src/repro/kernels/decoupled_matmul.py:108",
     "src/repro_torch/csrc/decoupled_matmul.cu"),
    ("paged_attention", "src/repro/kernels/paged_attention.py:227",
     "src/repro_torch/csrc/paged_attention.cu"),
    ("rmsnorm_quant", "src/repro/kernels/rmsnorm_quant.py:51",
     "src/repro_torch/csrc/rmsnorm_quant.cu"),
)


def log(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# Phase 1: the card
# ---------------------------------------------------------------------------


def phase_card(torch):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(smi)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    log(f"[1] card: {name} x{torch.cuda.device_count()}; torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}; python {sys.version.split()[0]}; TF32 off")
    # published dense peaks (NVIDIA data sheets): bytes/s, int8 ops/s
    peaks = (2.0e12, 1513e12) if "PCIe" in name else (3.35e12, 1979e12)
    log(f"[1] bound peaks: {peaks[0] / 1e12} TB/s, {peaks[1] / 1e12} int8 TOP/s")
    return smi, name, peaks


# ---------------------------------------------------------------------------
# Phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------


def _time(torch, fn, iters: int, reps: int = 7) -> float:
    """Device time of one call in ms: the median over ``reps`` of the mean
    of ``iters`` back-to-back calls between two CUDA events; ``fn(i)`` is
    the i-th call.  A spin kernel queued first keeps the device busy while
    the host enqueues the calls, so the events time the device's work and
    not the host's launch rate."""
    for i in range(3):
        fn(i)
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        # ~0.25 ms of spinning per call queued: more than the host takes to
        # issue one (15-125 us measured), or the device would idle between calls
        torch.cuda._sleep(iters * 500_000)
        e0.record()
        for i in range(iters):
            fn(i)
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1) / iters)
    return statistics.median(times)


def _host_us(torch, fn, iters: int = 100) -> float:
    """Host time to issue one call, in microseconds (the wrapper's checks,
    allocation and launch), with the device kept busy so nothing waits."""
    torch.cuda.synchronize()
    torch.cuda._sleep(iters * 500_000)
    t0 = time.perf_counter()
    for i in range(iters):
        fn(i)
    us = (time.perf_counter() - t0) / iters * 1e6
    torch.cuda.synchronize()
    return us


def _copies(nbytes: int) -> int:
    """Weight copies to rotate through so that each call finds its weights
    outside the 50 MB L2, as a decode step does (197 MB of weights)."""
    return max(2, -(-120 * 2**20 // nbytes))


def _close(a, b) -> float:
    """max |a - b|; raises unless |a - b| <= RTOL * |b| everywhere."""
    import torch

    err = (a - b).abs()
    if not torch.all(err <= RTOL * b.abs()):
        raise AssertionError(f"kernel disagrees with its plain version: max |err| {err.max().item()}")
    return err.max().item()


def _codes_close(q, q_ref, g, g_ref) -> float:
    """rmsnorm_quant against its plain version, to the stated tolerance:
    gamma within RMSNORM_RTOL, codes within one step, at most
    RMSNORM_CODE_SHARE of them different.  Returns max |gamma error|."""
    import torch

    g_err = (g - g_ref).abs()
    if not torch.all(g_err <= RMSNORM_RTOL * g_ref.abs()):
        raise AssertionError(f"rmsnorm_quant gamma off: max |err| {g_err.max().item()}")
    diff = (q.int() - q_ref.int()).abs()
    share = (diff > 0).float().mean().item()
    if diff.max().item() > 1 or share > RMSNORM_CODE_SHARE:
        raise AssertionError(f"rmsnorm_quant codes off: max step {diff.max().item()}, "
                             f"{share:.2e} of them differ")
    return g_err.max().item()


def _rmsnorm_route(x) -> str:
    """The route ``rmsnorm_quant`` takes for the rows x (with the warps a
    row on the warp route); a tree under ``--src`` from before the routes
    has one design (the block route's)."""
    from repro_torch.kernels import rmsnorm_quant as rq

    if not hasattr(rq, "rmsnorm_quant_route"):
        return "one design"
    route = rq.rmsnorm_quant_route(*x.shape, x.dtype, x.data_ptr())
    return f"warp, {rq.row_warps(*x.shape)} a row" if route == "warp" else route


def phase_kernels(torch, peaks, only=None):
    """Phase 3's GEMM and GEMV rows (``only``: one kernel's rows alone)."""
    from repro_torch.kernels import w1a8_gemv as wg
    from repro_torch.kernels import w1a8_matmul as wm
    from repro_torch.kernels import decoupled_matmul as dmm
    from repro_torch.kernels.decoupled_matmul import decoupled_matmul, decoupled_matmul_plain
    from repro_torch.kernels.int8_matmul import int8_matmul, int8_matmul_plain, int8_matmul_route
    from repro_torch.kernels.ref import unpack_ref
    from repro_torch.kernels.rmsnorm_quant import rmsnorm_quant, rmsnorm_quant_plain

    bw, ops_rate = peaks
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    f32 = dict(dtype=torch.float32, device=dev)
    dtypes = (torch.float32, torch.bfloat16)
    type_pairs = list(itertools.product(dtypes, repeat=2))  # (x, output) of the GEMVs

    def scalar(v):
        return torch.full((), v, **f32)

    def packed(k, n):
        return torch.randint(0, 256, (k // 8, n), generator=gen, device=dev, dtype=torch.uint8)

    def int8(*shape):
        return torch.randint(-127, 128, shape, generator=gen, device=dev, dtype=torch.int8)

    def scales(m):
        return torch.rand((m,), generator=gen, **f32) * 50 + 10

    def bound(nbytes, nops):
        t_b, t_o = nbytes / bw * 1e3, nops / ops_rate * 1e3
        return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")

    results = {}

    def record(name, m, shape, err, call, plain_call, b, library_call=None, tag="", nops=None):
        iters = 200 if m * shape[0] < 2**24 else 50 if m * shape[0] < 2**26 else 10
        ms = _time(torch, call, iters)
        host_us = _host_us(torch, call)
        plain_ms = _time(torch, plain_call, 3, 3)
        # the library calls read 8x the weight bytes (unpacked signs): a
        # quarter of the kernel's launches a mean
        library_ms = None if library_call is None else _time(torch, library_call,
                                                             max(10, iters // 4))
        label = f"{name} {tag}" if tag else name
        rate = "" if nops is None else f", {nops / ms / 1e9:.0f} int8 TOP/s"
        log(f"[3] {label} M={m} {shape}: max|err| {err:.3g}, kernel {ms * 1e3:.2f} us "
            f"(host {host_us:.1f} us/call{rate}), plain {plain_ms * 1e3:.1f} us, "
            f"bound {b[0] * 1e3:.3f} us ({b[1]}), "
            f"library {'none' if library_ms is None else f'{library_ms * 1e3:.2f} us'}")
        r = results.setdefault(name, {"max_abs_err": 0.0, "rows": {}})
        r["max_abs_err"] = max(r["max_abs_err"], err)
        r["rows"][(m,) + shape + ((tag,) if tag else ())] = dict(
            ms=ms, plain_ms=plain_ms, bound_ms=b[0], bound_by=b[1], library_ms=library_ms,
            host_us=host_us, **({} if nops is None else {"tops": nops / ms / 1e9}))

    def held(name, err):
        r = results.setdefault(name, {"max_abs_err": 0.0, "rows": {}})
        r["max_abs_err"] = max(r["max_abs_err"], err)

    def rows_int8_matmul():
        # int8_matmul serves every M: both tiers' row counts and the
        # chunked slice; held exactly in f32 and bf16, timed in f32 at
        # every M and in bf16 above the decode tier
        k, n = INT8_SHAPE
        ws = [int8(k, n) for _ in range(_copies(k * n))]
        wscale = scalar(1 / 0.0019)
        for m in INT8_ROWS:
            x = int8(m, k)
            gamma = scales(m)
            for dt in dtypes:
                err = _close(int8_matmul(x, ws[0], gamma, wscale, dt).float(),
                             int8_matmul_plain(x, ws[0], gamma, wscale, dt).float())
                if dt != torch.float32 and m <= 32:
                    held("int8_matmul", err)
                    continue  # held, not timed
                b = bound(m * k + k * n + m * 4 + 4 + m * n * dt.itemsize, 2 * m * k * n)
                # torch._int_mm's shape rule: M > 16, K and N multiples of 8
                library = (lambda i: torch._int_mm(x, ws[i % len(ws)])) if m > 16 else None
                record("int8_matmul", m, (k, n), err,
                       lambda i: int8_matmul(x, ws[i % len(ws)], gamma, wscale, dt),
                       lambda i: int8_matmul_plain(x, ws[0], gamma, wscale, dt), b, library,
                       tag="" if dt == torch.float32 else "bf16")
        # held, not timed: K not a multiple of 128, N ragged against the
        # tile, and a shape the shape rule sends to the GEMV route at any M
        for (k, n), m, dt in itertools.product(INT8_RAGGED, (33, 129, 1000), dtypes):
            x, w, gamma = int8(m, k), int8(k, n), scales(m)
            held("int8_matmul", _close(int8_matmul(x, w, gamma, wscale, dt).float(),
                                       int8_matmul_plain(x, w, gamma, wscale, dt).float()))
        log(f"[3] int8_matmul held exactly at (K, N) {INT8_RAGGED} x M (33, 129, 1000) x "
            f"f32, bf16")
        # deepseek-moe-16b's w8_down (K 128): held at every M of both tiers
        # and at [13]'s prefill rows, timed in f32 at its decode rows and
        # prefill rows
        k, n = MOE_INT8_SHAPE
        ws = [int8(k, n) for _ in range(_copies(k * n))]
        for m in INT8_ROWS + (MOE_PREFILL_ROWS,):
            x, gamma = int8(m, k), scales(m)
            err = max(_close(int8_matmul(x, ws[0], gamma, wscale, dt).float(),
                             int8_matmul_plain(x, ws[0], gamma, wscale, dt).float())
                      for dt in dtypes)
            held("int8_matmul", err)
            if m not in (MAIN_ROWS, MOE_PREFILL_ROWS):
                continue
            b = bound(m * k + k * n + m * 4 + 4 + m * n * 4, 2 * m * k * n)
            record("int8_matmul", m, (k, n), err,
                   lambda i: int8_matmul(x, ws[i % len(ws)], gamma, wscale),
                   lambda i: int8_matmul_plain(x, ws[0], gamma, wscale), b,
                   (lambda i: torch._int_mm(x, ws[i % len(ws)])) if m > 16 else None, tag="moe")
        # gemma3-27b's w8_down (K 1024, the last K of the tile route: all of
        # K resident in shared memory) and h2o-danube-1.8b's (K 384, N
        # 2560): held at every M of both tiers and at [14]'s prefill rows,
        # timed in f32 at the path's decode and prefill rows
        for tag, (k, n) in SWA_INT8_SHAPES.items():
            ws = [int8(k, n) for _ in range(_copies(k * n))]
            timed = (SWA_DECODE_ROWS[tag],) + SWA_PREFILL_ROWS[tag]
            for m in sorted(set(INT8_ROWS + timed)):
                x, gamma = int8(m, k), scales(m)
                err = max(_close(int8_matmul(x, ws[0], gamma, wscale, dt).float(),
                                 int8_matmul_plain(x, ws[0], gamma, wscale, dt).float())
                          for dt in dtypes)
                held("int8_matmul", err)
                if m not in timed:
                    continue
                b = bound(m * k + k * n + m * 4 + 4 + m * n * 4, 2 * m * k * n)
                record("int8_matmul", m, (k, n), err,
                       lambda i: int8_matmul(x, ws[i % len(ws)], gamma, wscale),
                       lambda i: int8_matmul_plain(x, ws[0], gamma, wscale), b,
                       (lambda i: torch._int_mm(x, ws[i % len(ws)])) if m > 16 else None, tag=tag)
        # deepseek-v2-236b's w8_down (K 256, N 5120): held at every M of
        # both tiers and at [15] (c)'s prefill rows, timed in f32 at its
        # decode and prefill rows
        k, n = MLA_INT8_SHAPE
        ws = [int8(k, n) for _ in range(_copies(k * n))]
        for m in INT8_ROWS + (MLA_PREFILL_ROWS,):
            x, gamma = int8(m, k), scales(m)
            err = max(_close(int8_matmul(x, ws[0], gamma, wscale, dt).float(),
                             int8_matmul_plain(x, ws[0], gamma, wscale, dt).float())
                      for dt in dtypes)
            held("int8_matmul", err)
            if m not in (MLA_DECODE_ROWS, MLA_PREFILL_ROWS):
                continue
            b = bound(m * k + k * n + m * 4 + 4 + m * n * 4, 2 * m * k * n)
            record("int8_matmul", m, (k, n), err,
                   lambda i: int8_matmul(x, ws[i % len(ws)], gamma, wscale),
                   lambda i: int8_matmul_plain(x, ws[0], gamma, wscale), b,
                   (lambda i: torch._int_mm(x, ws[i % len(ws)])) if m > 16 else None, tag="mla")
        log("[3] int8_matmul routes (M, K, N) at [14]'s shapes: " + ", ".join(
            f"{(m,) + s} {int8_matmul_route(m, *s)}" for tag, s in SWA_INT8_SHAPES.items()
            for m in (SWA_DECODE_ROWS[tag], 33) + SWA_PREFILL_ROWS[tag]))

    def rows_w1a8_gemv():
        # decode tier: fused act-quant GEMV (M <= 32); held exactly for x
        # and the output in f32 and bf16, timed all-f32 at every M and
        # all-bf16 at the two serving paths' decode rows (4, 16) and at 32
        lam = scalar(0.031)
        for k, n in W1A8_SHAPES:
            ws = [packed(k, n) for _ in range(_copies(k // 8 * n))]
            w_lib = unpack_ref(ws[0])  # the library call's unpacked +-1 weight
            for m in ROWS:
                x = torch.randn((m, k), generator=gen, **f32)
                x_lib = int8(m, k) if m == LIB_GEMV_ROWS else None
                for xt, dt in type_pairs:
                    xd = x.to(xt)
                    err = _close(wg.w1a8_gemv(xd, ws[0], lam, dt).float(),
                                 wg.w1a8_gemv_plain(xd, ws[0], lam, dt).float())
                    held("w1a8_gemv", err)
                    if xt != dt or (dt != torch.float32 and m not in BF16_GEMV_ROWS):
                        continue
                    b = bound(m * k * xt.itemsize + k // 8 * n + 4 + m * n * dt.itemsize,
                              2 * m * k * n)
                    record("w1a8_gemv", m, (k, n), err,
                           lambda i: wg.w1a8_gemv(xd, ws[i % len(ws)], lam, dt),
                           lambda i: wg.w1a8_gemv_plain(xd, ws[0], lam, dt), b,
                           (lambda i: torch._int_mm(x_lib, w_lib)) if m == LIB_GEMV_ROWS
                           else None, tag="" if dt == torch.float32 else "bf16")
        # deepseek-moe-16b's shapes: held exactly at every M with x and the
        # output f32 and bf16 (at M 8, seven rows of zeros: an expert's
        # sentinel rows, quantized with amax 0); timed in f32 at the rows
        # the path gives the shape and at 32 beside _int_mm
        for (k, n), m_path in zip(MOE_W1A8_SHAPES, MOE_W1A8_DECODE_ROWS):
            ws = [packed(k, n) for _ in range(_copies(k // 8 * n))]
            w_lib = unpack_ref(ws[0])
            for m in ROWS:
                x = torch.randn((m, k), generator=gen, **f32)
                if m == 8:
                    x[1:] = 0.0
                err = max(_close(wg.w1a8_gemv(x.to(dt), ws[0], lam, dt).float(),
                                 wg.w1a8_gemv_plain(x.to(dt), ws[0], lam, dt).float())
                          for dt in dtypes)
                held("w1a8_gemv", err)
                if m not in (m_path, LIB_GEMV_ROWS):
                    continue
                x_lib = int8(m, k)
                b = bound(m * k * 4 + k // 8 * n + 4 + m * n * 4, 2 * m * k * n)
                record("w1a8_gemv", m, (k, n), err,
                       lambda i: wg.w1a8_gemv(x, ws[i % len(ws)], lam),
                       lambda i: wg.w1a8_gemv_plain(x, ws[0], lam), b,
                       (lambda i: torch._int_mm(x_lib, w_lib)) if m == LIB_GEMV_ROWS else None,
                       tag="moe")
        # [14]'s shapes (gemma3-27b's K 21504 is 672 k32 steps over the
        # cluster; danube's N 640): held exactly at every M with x and the
        # output f32 and bf16, timed in f32 at the path's decode rows and at
        # 32 beside _int_mm
        for tag, shapes in SWA_W1A8_SHAPES.items():
            for k, n in shapes:
                ws = [packed(k, n) for _ in range(_copies(k // 8 * n))]
                w_lib = unpack_ref(ws[0])
                for m in sorted(set(ROWS + (SWA_DECODE_ROWS[tag],))):
                    x = torch.randn((m, k), generator=gen, **f32)
                    err = max(_close(wg.w1a8_gemv(x.to(dt), ws[0], lam, dt).float(),
                                     wg.w1a8_gemv_plain(x.to(dt), ws[0], lam, dt).float())
                              for dt in dtypes)
                    held("w1a8_gemv", err)
                    if m not in (SWA_DECODE_ROWS[tag], LIB_GEMV_ROWS):
                        continue
                    x_lib = int8(m, k)
                    b = bound(m * k * 4 + k // 8 * n + 4 + m * n * 4, 2 * m * k * n)
                    record("w1a8_gemv", m, (k, n), err,
                           lambda i: wg.w1a8_gemv(x, ws[i % len(ws)], lam),
                           lambda i: wg.w1a8_gemv_plain(x, ws[0], lam), b,
                           (lambda i: torch._int_mm(x_lib, w_lib)) if m == LIB_GEMV_ROWS
                           else None, tag=tag)
                del ws, w_lib
        # [15]'s shapes (deepseek-v2-236b: wo's K 16384, wq_up's N 24576,
        # wkv_down's N 576): held exactly at every M with x and the output
        # f32 and bf16 (the routed experts' shapes at M 8 with seven rows of
        # zeros, an expert's sentinel rows), timed in f32 at (b)'s 4 rows and
        # at 32 beside _int_mm
        for k, n in MLA_W1A8_SHAPES:
            ws = [packed(k, n) for _ in range(_copies(k // 8 * n))]
            w_lib = unpack_ref(ws[0])
            for m in ROWS:
                x = torch.randn((m, k), generator=gen, **f32)
                if m == 8 and (k, n) in MLA_EXPERT_SHAPES:
                    x[1:] = 0.0
                err = max(_close(wg.w1a8_gemv(x.to(dt), ws[0], lam, dt).float(),
                                 wg.w1a8_gemv_plain(x.to(dt), ws[0], lam, dt).float())
                          for dt in dtypes)
                held("w1a8_gemv", err)
                if m not in (MLA_DECODE_ROWS, LIB_GEMV_ROWS):
                    continue
                x_lib = int8(m, k)
                b = bound(m * k * 4 + k // 8 * n + 4 + m * n * 4, 2 * m * k * n)
                record("w1a8_gemv", m, (k, n), err,
                       lambda i: wg.w1a8_gemv(x, ws[i % len(ws)], lam),
                       lambda i: wg.w1a8_gemv_plain(x, ws[0], lam), b,
                       (lambda i: torch._int_mm(x_lib, w_lib)) if m == LIB_GEMV_ROWS else None,
                       tag="mla")
            del ws, w_lib

    def rows_decoupled_gemv():
        k, n, r = DECOUPLED_SHAPE
        w1s = [packed(k, n) for _ in range(_copies(k // 8 * n + k * r))]
        w8s = [int8(k, r) for _ in w1s]
        sc = [scalar(0.027), scalar(1 / 0.0021), scalar(1.0), scalar(1.0)]
        w_lib = torch.cat([unpack_ref(w1s[0]), w8s[0]], dim=1)  # both products in one call
        for m in ROWS:
            x = torch.randn((m, k), generator=gen, **f32)
            x_lib = int8(m, k) if m == LIB_GEMV_ROWS else None
            for xt, dt in type_pairs:
                xd = x.to(xt)
                got = wg.decoupled_gemv(xd, w1s[0], w8s[0], *sc, dt)
                want = wg.decoupled_gemv_plain(xd, w1s[0], w8s[0], *sc, dt)
                err = max(_close(got[0].float(), want[0].float()),
                          _close(got[1].float(), want[1].float()))
                held("decoupled_gemv", err)
                if xt != dt or (dt != torch.float32 and m not in BF16_GEMV_ROWS):
                    continue
                b = bound(m * k * xt.itemsize + k // 8 * n + k * r + 16
                          + m * (n + r) * dt.itemsize, 2 * m * k * (n + r))
                record("decoupled_gemv", m, (k, n, r), err,
                       lambda i: wg.decoupled_gemv(xd, w1s[i % len(w1s)], w8s[i % len(w8s)],
                                                   *sc, dt),
                       lambda i: wg.decoupled_gemv_plain(xd, w1s[0], w8s[0], *sc, dt), b,
                       (lambda i: torch._int_mm(x_lib, w_lib)) if m == LIB_GEMV_ROWS else None,
                       tag="" if dt == torch.float32 else "bf16")
        # deepseek-moe-16b's dense (N 10944) and shared (N 2816) pairs at r
        # 128: held at every M in f32 and bf16, timed in f32 at [13]'s decode
        # rows and at 32 beside _int_mm
        for k, n, r in MOE_DECOUPLED_SHAPES:
            w1s = [packed(k, n) for _ in range(_copies(k // 8 * n + k * r))]
            w8s = [int8(k, r) for _ in w1s]
            w_lib = torch.cat([unpack_ref(w1s[0]), w8s[0]], dim=1)
            for m in ROWS:
                x = torch.randn((m, k), generator=gen, **f32)
                err = 0.0
                for dt in dtypes:
                    got = wg.decoupled_gemv(x.to(dt), w1s[0], w8s[0], *sc, dt)
                    want = wg.decoupled_gemv_plain(x.to(dt), w1s[0], w8s[0], *sc, dt)
                    err = max(err, _close(got[0].float(), want[0].float()),
                              _close(got[1].float(), want[1].float()))
                held("decoupled_gemv", err)
                if m not in (MAIN_ROWS, LIB_GEMV_ROWS):
                    continue
                x_lib = int8(m, k)
                b = bound(m * k * 4 + k // 8 * n + k * r + 16 + m * (n + r) * 4,
                          2 * m * k * (n + r))
                record("decoupled_gemv", m, (k, n, r), err,
                       lambda i: wg.decoupled_gemv(x, w1s[i % len(w1s)], w8s[i % len(w8s)], *sc),
                       lambda i: wg.decoupled_gemv_plain(x, w1s[0], w8s[0], *sc), b,
                       (lambda i: torch._int_mm(x_lib, w_lib)) if m == LIB_GEMV_ROWS else None,
                       tag="moe")
        # [14]'s pairs: gemma3-27b's r 1024 (2.7x the widest r before) and
        # danube's; held at every M in f32 and bf16, timed in f32 at the
        # path's decode rows and at 32 beside _int_mm
        for tag, (k, n, r) in SWA_DECOUPLED_SHAPES.items():
            w1s = [packed(k, n) for _ in range(_copies(k // 8 * n + k * r))]
            w8s = [int8(k, r) for _ in w1s]
            w_lib = torch.cat([unpack_ref(w1s[0]), w8s[0]], dim=1)
            for m in sorted(set(ROWS + (SWA_DECODE_ROWS[tag],))):
                x = torch.randn((m, k), generator=gen, **f32)
                err = 0.0
                for dt in dtypes:
                    got = wg.decoupled_gemv(x.to(dt), w1s[0], w8s[0], *sc, dt)
                    want = wg.decoupled_gemv_plain(x.to(dt), w1s[0], w8s[0], *sc, dt)
                    err = max(err, _close(got[0].float(), want[0].float()),
                              _close(got[1].float(), want[1].float()))
                held("decoupled_gemv", err)
                if m not in (SWA_DECODE_ROWS[tag], LIB_GEMV_ROWS):
                    continue
                x_lib = int8(m, k)
                b = bound(m * k * 4 + k // 8 * n + k * r + 16 + m * (n + r) * 4,
                          2 * m * k * (n + r))
                record("decoupled_gemv", m, (k, n, r), err,
                       lambda i: wg.decoupled_gemv(x, w1s[i % len(w1s)], w8s[i % len(w8s)], *sc),
                       lambda i: wg.decoupled_gemv_plain(x, w1s[0], w8s[0], *sc), b,
                       (lambda i: torch._int_mm(x_lib, w_lib)) if m == LIB_GEMV_ROWS else None,
                       tag=tag)
            del w1s, w8s, w_lib
        # [15]'s shared (N 3072) and dense (N 12288) pairs at r 256: held at
        # every M in f32 and bf16, timed in f32 at (b)'s 4 rows and at 32
        # beside _int_mm
        for k, n, r in MLA_DECOUPLED_SHAPES:
            w1s = [packed(k, n) for _ in range(_copies(k // 8 * n + k * r))]
            w8s = [int8(k, r) for _ in w1s]
            w_lib = torch.cat([unpack_ref(w1s[0]), w8s[0]], dim=1)
            for m in ROWS:
                x = torch.randn((m, k), generator=gen, **f32)
                err = 0.0
                for dt in dtypes:
                    got = wg.decoupled_gemv(x.to(dt), w1s[0], w8s[0], *sc, dt)
                    want = wg.decoupled_gemv_plain(x.to(dt), w1s[0], w8s[0], *sc, dt)
                    err = max(err, _close(got[0].float(), want[0].float()),
                              _close(got[1].float(), want[1].float()))
                held("decoupled_gemv", err)
                if m not in (MLA_DECODE_ROWS, LIB_GEMV_ROWS):
                    continue
                x_lib = int8(m, k)
                b = bound(m * k * 4 + k // 8 * n + k * r + 16 + m * (n + r) * 4,
                          2 * m * k * (n + r))
                record("decoupled_gemv", m, (k, n, r), err,
                       lambda i: wg.decoupled_gemv(x, w1s[i % len(w1s)], w8s[i % len(w8s)], *sc),
                       lambda i: wg.decoupled_gemv_plain(x, w1s[0], w8s[0], *sc), b,
                       (lambda i: torch._int_mm(x_lib, w_lib)) if m == LIB_GEMV_ROWS else None,
                       tag="mla")
            del w1s, w8s, w_lib

    def rows_w1a8_matmul():
        # prefill tier on pre-quantized rows (M > 32): held exactly in f32
        # (the main path's activation type) and in bf16 (what upstream's
        # ops write) at every M and at ragged (K, N), timed in f32 at
        # every M and in bf16 at 8192 rows; the route each shape takes
        lam = scalar(0.031)
        for k, n in W1A8_SHAPES:
            ws = [packed(k, n) for _ in range(_copies(k // 8 * n))]
            w_lib = unpack_ref(ws[0])  # the library call's unpacked +-1 weight
            for m in W1A8_MATMUL_ROWS:
                x, gamma = int8(m, k), scales(m)
                for dt in dtypes:
                    err = _close(wm.w1a8_matmul(x, ws[0], gamma, lam, dt).float(),
                                 wm.w1a8_matmul_plain(x, ws[0], gamma, lam, dt).float())
                    if dt != torch.float32 and m != PREFILL_MAIN_ROWS:
                        held("w1a8_matmul", err)
                        continue
                    b = bound(m * k + k // 8 * n + m * 4 + 4 + m * n * dt.itemsize,
                              2 * m * k * n)
                    record("w1a8_matmul", m, (k, n), err,
                           lambda i: wm.w1a8_matmul(x, ws[i % len(ws)], gamma, lam, dt),
                           lambda i: wm.w1a8_matmul_plain(x, ws[0], gamma, lam, dt), b,
                           lambda i: torch._int_mm(x, w_lib),
                           tag="" if dt == torch.float32 else "bf16", nops=2 * m * k * n)
        for (k, n), m, dt in itertools.product(W1A8_RAGGED, (33, 129, 1000), dtypes):
            x, w, gamma = int8(m, k), packed(k, n), scales(m)
            held("w1a8_matmul", _close(wm.w1a8_matmul(x, w, gamma, lam, dt).float(),
                                       wm.w1a8_matmul_plain(x, w, gamma, lam, dt).float()))
        log(f"[3] w1a8_matmul held exactly at (K, N) {W1A8_RAGGED} x M (33, 129, 1000) x "
            f"f32, bf16; routes (M, K, N): " + ", ".join(
                f"{(m,) + s} {wm.w1a8_matmul_route(m, *s)}" for s in W1A8_SHAPES + W1A8_RAGGED
                for m in W1A8_MATMUL_ROWS))
        # deepseek-moe-16b's shapes at the rows [13] gives them: an expert's
        # capacity (480 at 4096 prefill rows, 960 at 8192; the last 80 rows
        # sentinel zeros, codes 0 at the scale of amax 0), the 4096 prefill
        # rows for q/k/v/o and the dense and shared w1_down, and [13] (d)'s
        # admission rows; held exactly in f32 and bf16, timed in f32
        moe_rows = [(s, m) for s in MOE_W1A8_SHAPES[:2] for m in MOE_EXPERT_ROWS + (16,)]
        moe_rows += [(s, m) for s in (W1A8_SHAPES[0],) + MOE_W1A8_SHAPES[2:]
                     for m in (MOE_ADMISSION_ROWS, MOE_PREFILL_ROWS)]
        for (k, n), m in moe_rows:
            if m <= 32:  # an expert's rows at a 128-row admission: held, not timed
                x, gamma, w = int8(m, k), scales(m), packed(k, n)
                held("w1a8_matmul", max(
                    _close(wm.w1a8_matmul(x, w, gamma, lam, dt).float(),
                           wm.w1a8_matmul_plain(x, w, gamma, lam, dt).float()) for dt in dtypes))
                continue
            ws = [packed(k, n) for _ in range(_copies(k // 8 * n))]
            w_lib = unpack_ref(ws[0])
            x, gamma = int8(m, k), scales(m)
            if m in MOE_EXPERT_ROWS:
                x[-80:] = 0
                gamma[-80:] = 127.0 / 1e-5
            err = max(_close(wm.w1a8_matmul(x, ws[0], gamma, lam, dt).float(),
                             wm.w1a8_matmul_plain(x, ws[0], gamma, lam, dt).float())
                      for dt in dtypes)
            b = bound(m * k + k // 8 * n + m * 4 + 4 + m * n * 4, 2 * m * k * n)
            record("w1a8_matmul", m, (k, n), err,
                   lambda i: wm.w1a8_matmul(x, ws[i % len(ws)], gamma, lam),
                   lambda i: wm.w1a8_matmul_plain(x, ws[0], gamma, lam), b,
                   lambda i: torch._int_mm(x, w_lib), tag="moe", nops=2 * m * k * n)
        log("[3] w1a8_matmul deepseek-moe-16b routes (M, K, N): " + ", ".join(
            f"{(m,) + s} {wm.w1a8_matmul_route(m, *s)}" for s, m in moe_rows))
        # [14]'s shapes at its prefill rows: held exactly in f32 and bf16,
        # timed in f32 beside _int_mm
        swa_rows = [(tag, s, m) for tag, shapes in SWA_W1A8_SHAPES.items() for s in shapes
                    for m in SWA_PREFILL_ROWS[tag]]
        for tag, (k, n), m in swa_rows:
            ws = [packed(k, n) for _ in range(_copies(k // 8 * n))]
            w_lib = unpack_ref(ws[0])
            x, gamma = int8(m, k), scales(m)
            err = max(_close(wm.w1a8_matmul(x, ws[0], gamma, lam, dt).float(),
                             wm.w1a8_matmul_plain(x, ws[0], gamma, lam, dt).float())
                      for dt in dtypes)
            b = bound(m * k + k // 8 * n + m * 4 + 4 + m * n * 4, 2 * m * k * n)
            record("w1a8_matmul", m, (k, n), err,
                   lambda i: wm.w1a8_matmul(x, ws[i % len(ws)], gamma, lam),
                   lambda i: wm.w1a8_matmul_plain(x, ws[0], gamma, lam), b,
                   lambda i: torch._int_mm(x, w_lib), tag=tag, nops=2 * m * k * n)
            del ws, w_lib
        log("[3] w1a8_matmul routes (M, K, N) at [14]'s shapes: " + ", ".join(
            f"{(m,) + s} {wm.w1a8_matmul_route(m, *s)}" for _, s, m in swa_rows))
        # [15]'s shapes: the latent expansion at (b)'s decode rows (4 x 40
        # cache positions) and at (c)'s prefill rows; the other linears at
        # (c)'s 2048 rows; a routed expert's at its capacity there (the last
        # 16 rows sentinel zeros); held exactly in f32 and bf16, timed in f32
        mla_rows = [(MLA_EXPAND_SHAPE, MLA_EXPAND_ROWS), (MLA_EXPAND_SHAPE, MLA_PREFILL_ROWS)]
        mla_rows += [(s, MLA_PREFILL_ROWS) for s in MLA_W1A8_SHAPES if s != (1536, 5120)]
        mla_rows += [(s, MLA_EXPERT_ROWS) for s in MLA_EXPERT_SHAPES]
        for (k, n), m in mla_rows:
            ws = [packed(k, n) for _ in range(_copies(k // 8 * n))]
            w_lib = unpack_ref(ws[0])
            x, gamma = int8(m, k), scales(m)
            if m == MLA_EXPERT_ROWS:
                x[-16:] = 0
                gamma[-16:] = 127.0 / 1e-5
            err = max(_close(wm.w1a8_matmul(x, ws[0], gamma, lam, dt).float(),
                             wm.w1a8_matmul_plain(x, ws[0], gamma, lam, dt).float())
                      for dt in dtypes)
            b = bound(m * k + k // 8 * n + m * 4 + 4 + m * n * 4, 2 * m * k * n)
            record("w1a8_matmul", m, (k, n), err,
                   lambda i: wm.w1a8_matmul(x, ws[i % len(ws)], gamma, lam),
                   lambda i: wm.w1a8_matmul_plain(x, ws[0], gamma, lam), b,
                   lambda i: torch._int_mm(x, w_lib), tag="mla", nops=2 * m * k * n)
            del ws, w_lib
        log("[3] w1a8_matmul routes (M, K, N) at [15]'s shapes: " + ", ".join(
            f"{(m,) + s} {wm.w1a8_matmul_route(m, *s)}" for s, m in mla_rows))

    def rows_decoupled_matmul():
        # held exactly in f32 and bf16 and timed in f32 at every M (the
        # prefill, (a)'s admission buckets and (b)'s slices), and held at
        # ragged (K, N, r); the route each shape takes
        route = dmm.decoupled_matmul_route
        k, n, r = DECOUPLED_SHAPE
        w1s = [packed(k, n) for _ in range(_copies(k // 8 * n + k * r))]
        w8s = [int8(k, r) for _ in w1s]
        sc = [scalar(0.027), scalar(1 / 0.0021), scalar(1.0), scalar(1.0)]
        w_lib = torch.cat([unpack_ref(w1s[0]), w8s[0]], dim=1)  # both products in one call
        for m in DECOUPLED_MATMUL_ROWS:
            x, gamma = int8(m, k), scales(m)
            err = 0.0
            for dt in dtypes:
                got = decoupled_matmul(x, w1s[0], w8s[0], gamma, *sc, out_dtype=dt)
                want = decoupled_matmul_plain(x, w1s[0], w8s[0], gamma, *sc, out_dtype=dt)
                err = max(err, _close(got[0].float(), want[0].float()),
                          _close(got[1].float(), want[1].float()))
            b = bound(m * k + k // 8 * n + k * r + m * 4 + 16 + m * (n + r) * 4,
                      2 * m * k * (n + r))
            record("decoupled_matmul", m, (k, n, r), err,
                   lambda i: decoupled_matmul(x, w1s[i % len(w1s)], w8s[i % len(w8s)], gamma,
                                              *sc),
                   lambda i: decoupled_matmul_plain(x, w1s[0], w8s[0], gamma, *sc), b,
                   lambda i: torch._int_mm(x, w_lib), nops=2 * m * k * (n + r))
        for (k, n, r), m, dt in itertools.product(DECOUPLED_RAGGED, (33, 129, 1000), dtypes):
            x, gamma = int8(m, k), scales(m)
            w1, w8 = packed(k, n), int8(k, r)
            got = decoupled_matmul(x, w1, w8, gamma, *sc, out_dtype=dt)
            want = decoupled_matmul_plain(x, w1, w8, gamma, *sc, out_dtype=dt)
            held("decoupled_matmul", max(_close(got[0].float(), want[0].float()),
                                         _close(got[1].float(), want[1].float())))
        log(f"[3] decoupled_matmul held exactly at (K, N, r) {DECOUPLED_RAGGED} x M (33, 129, "
            f"1000) x f32, bf16; routes (M, K, N, r): " + ", ".join(
                f"{(m,) + s} {route(m, *s)}" for s in (DECOUPLED_SHAPE,) + DECOUPLED_RAGGED
                for m in DECOUPLED_MATMUL_ROWS))
        # deepseek-moe-16b's dense and shared pairs at r 128: held exactly in
        # f32 and bf16 and timed in f32 at [13]'s prefill rows and its
        # longest admission prefill
        for k, n, r in MOE_DECOUPLED_SHAPES:
            w1s = [packed(k, n) for _ in range(_copies(k // 8 * n + k * r))]
            w8s = [int8(k, r) for _ in w1s]
            w_lib = torch.cat([unpack_ref(w1s[0]), w8s[0]], dim=1)
            for m in (MOE_ADMISSION_ROWS, MOE_PREFILL_ROWS):
                x, gamma = int8(m, k), scales(m)
                err = 0.0
                for dt in dtypes:
                    got = decoupled_matmul(x, w1s[0], w8s[0], gamma, *sc, out_dtype=dt)
                    want = decoupled_matmul_plain(x, w1s[0], w8s[0], gamma, *sc, out_dtype=dt)
                    err = max(err, _close(got[0].float(), want[0].float()),
                              _close(got[1].float(), want[1].float()))
                b = bound(m * k + k // 8 * n + k * r + m * 4 + 16 + m * (n + r) * 4,
                          2 * m * k * (n + r))
                record("decoupled_matmul", m, (k, n, r), err,
                       lambda i: decoupled_matmul(x, w1s[i % len(w1s)], w8s[i % len(w8s)],
                                                  gamma, *sc),
                       lambda i: decoupled_matmul_plain(x, w1s[0], w8s[0], gamma, *sc), b,
                       lambda i: torch._int_mm(x, w_lib), tag="moe", nops=2 * m * k * (n + r))
        log("[3] decoupled_matmul deepseek-moe-16b routes (M, K, N, r): " + ", ".join(
            f"{(m,) + s} {route(m, *s)}" for s in MOE_DECOUPLED_SHAPES
            for m in (MOE_ADMISSION_ROWS, MOE_PREFILL_ROWS)))
        # [14]'s pairs (gemma3-27b's r 1024) at its prefill rows: held
        # exactly in f32 and bf16, timed in f32 beside _int_mm
        for tag, (k, n, r) in SWA_DECOUPLED_SHAPES.items():
            w1s = [packed(k, n) for _ in range(_copies(k // 8 * n + k * r))]
            w8s = [int8(k, r) for _ in w1s]
            w_lib = torch.cat([unpack_ref(w1s[0]), w8s[0]], dim=1)
            for m in SWA_PREFILL_ROWS[tag]:
                x, gamma = int8(m, k), scales(m)
                err = 0.0
                for dt in dtypes:
                    got = decoupled_matmul(x, w1s[0], w8s[0], gamma, *sc, out_dtype=dt)
                    want = decoupled_matmul_plain(x, w1s[0], w8s[0], gamma, *sc, out_dtype=dt)
                    err = max(err, _close(got[0].float(), want[0].float()),
                              _close(got[1].float(), want[1].float()))
                b = bound(m * k + k // 8 * n + k * r + m * 4 + 16 + m * (n + r) * 4,
                          2 * m * k * (n + r))
                record("decoupled_matmul", m, (k, n, r), err,
                       lambda i: decoupled_matmul(x, w1s[i % len(w1s)], w8s[i % len(w8s)],
                                                  gamma, *sc),
                       lambda i: decoupled_matmul_plain(x, w1s[0], w8s[0], gamma, *sc), b,
                       lambda i: torch._int_mm(x, w_lib), tag=tag, nops=2 * m * k * (n + r))
            del w1s, w8s, w_lib
        log("[3] decoupled_matmul routes (M, K, N, r) at [14]'s shapes: " + ", ".join(
            f"{(m,) + s} {route(m, *s)}" for tag, s in SWA_DECOUPLED_SHAPES.items()
            for m in SWA_PREFILL_ROWS[tag]))
        # [15]'s shared and dense pairs at r 256 at (c)'s prefill rows: held
        # exactly in f32 and bf16, timed in f32 beside _int_mm
        m = MLA_PREFILL_ROWS
        for k, n, r in MLA_DECOUPLED_SHAPES:
            w1s = [packed(k, n) for _ in range(_copies(k // 8 * n + k * r))]
            w8s = [int8(k, r) for _ in w1s]
            w_lib = torch.cat([unpack_ref(w1s[0]), w8s[0]], dim=1)
            x, gamma = int8(m, k), scales(m)
            err = 0.0
            for dt in dtypes:
                got = decoupled_matmul(x, w1s[0], w8s[0], gamma, *sc, out_dtype=dt)
                want = decoupled_matmul_plain(x, w1s[0], w8s[0], gamma, *sc, out_dtype=dt)
                err = max(err, _close(got[0].float(), want[0].float()),
                          _close(got[1].float(), want[1].float()))
            b = bound(m * k + k // 8 * n + k * r + m * 4 + 16 + m * (n + r) * 4,
                      2 * m * k * (n + r))
            record("decoupled_matmul", m, (k, n, r), err,
                   lambda i: decoupled_matmul(x, w1s[i % len(w1s)], w8s[i % len(w8s)], gamma,
                                              *sc),
                   lambda i: decoupled_matmul_plain(x, w1s[0], w8s[0], gamma, *sc), b,
                   lambda i: torch._int_mm(x, w_lib), tag="mla", nops=2 * m * k * (n + r))
            del w1s, w8s, w_lib
        log("[3] decoupled_matmul routes (M, K, N, r) at [15]'s shapes: " + ", ".join(
            f"{(m,) + s} {route(m, *s)}" for s in MLA_DECOUPLED_SHAPES))

    def rows_rmsnorm_quant():
        # timed on bf16 and f32 rows of d_model at the prefill rows, x
        # rotated past the L2 as the GEMMs' weights are; held at 2880 (the
        # widest paper width: the warp route, each row's last chunks
        # ragged across its threads) and at 100 (not a multiple of 8: the
        # block route).  No PyTorch call computes the same function.
        d = D_MODEL
        norm_scale = torch.rand((d,), generator=gen, **f32) + 0.5
        routes = []
        for dt in (torch.bfloat16, torch.float32):
            for m in PREFILL_ROWS:
                xs = [(torch.randn((m, d), generator=gen, **f32) * 3).to(dt)
                      for _ in range(_copies(m * d * dt.itemsize))]
                q, g = rmsnorm_quant(xs[0], norm_scale)
                q_ref, g_ref = rmsnorm_quant_plain(xs[0], norm_scale)
                err = _codes_close(q, q_ref, g, g_ref)
                b = bound(m * d * dt.itemsize + d * 4 + m * d + m * 4, 0)
                record("rmsnorm_quant", m, (d,), err,
                       lambda i: rmsnorm_quant(xs[i % len(xs)], norm_scale),
                       lambda i: rmsnorm_quant_plain(xs[0], norm_scale), b,
                       tag="" if dt == torch.bfloat16 else "f32")
                routes.append(f"{(m, d, str(dt)[6:])} {_rmsnorm_route(xs[0])}")
        for dd, m, dt in itertools.product((2880, 100), (33, 1000), dtypes):
            x = (torch.randn((m, dd), generator=gen, **f32) * 3).to(dt)
            s = torch.rand((dd,), generator=gen, **f32) + 0.5
            q, g = rmsnorm_quant(x, s)
            q_ref, g_ref = rmsnorm_quant_plain(x, s)
            held("rmsnorm_quant", _codes_close(q, q_ref, g, g_ref))
            routes.append(f"{(m, dd, str(dt)[6:])} {_rmsnorm_route(x)}")
        log("[3] rmsnorm_quant held within its tolerance at d (2880, 100) x M (33, 1000) x "
            "f32, bf16; routes (M, d, x): " + ", ".join(routes))

    sections = {
        "int8_matmul": rows_int8_matmul,
        "w1a8_gemv": rows_w1a8_gemv,
        "decoupled_gemv": rows_decoupled_gemv,
        "w1a8_matmul": rows_w1a8_matmul,
        "decoupled_matmul": rows_decoupled_matmul,
        "rmsnorm_quant": rows_rmsnorm_quant,
    }
    for name, rows in sections.items():
        if only in (None, name):
            rows()
    if only is None:
        log("[3] library call: none computes a packed 1-bit product, so every packed kernel's "
            "is torch._int_mm on the unpacked +-1 signs (8x the weight bytes, pre-quantized "
            "int8 rows, no epilogue): w1a8_matmul's and decoupled_matmul's at every M, "
            f"w1a8_gemv's and decoupled_gemv's at {LIB_GEMV_ROWS} rows (_int_mm takes M > 16); "
            "int8_matmul's is torch._int_mm (integer product only, M > 16); rmsnorm_quant "
            "has none")
    return results


# paged_attention at the shapes of phase 8 (pquant-1.3b: 32 heads of 64,
# block 16, 512 positions a slot, 16 slots)
PA_SLOTS, PA_MAX_LEN, PA_BLOCK, PA_HEADS, PA_HEAD_DIM = 16, 512, 16, 32, 64
PA_CHUNK = 64  # the chunked-prefill slice of phase 8 (b)
PA_GQA_KV_HEADS = 8
# deepseek-moe-16b at [13] (d)'s shapes: 16 heads of 128 (head_dim 128 is
# the kernel's kMaxD), 4 slots of 160 positions; the chunk at position 64
PA_MOE = dict(slots=4, max_len=160, heads=16, head_dim=128, chunk_at=64)
# gemma3-27b at [14] (c)'s shapes: 32 query heads over 16 KV heads of 128
# (a group of 2), 4 slots of 1280 positions; a 64-token slice at 1024
PA_SWA = dict(slots=4, max_len=1280, heads=32, kv_heads=16, head_dim=128, chunk_at=1024)
PA_ATOL = 1e-5  # kernel vs plain version: the softmax reduction is reassociated
F32_PEAK = 67e12  # H100 SXM f32 FLOP/s outside the tensor cores (NVIDIA data sheet)


def phase_paged_attention(torch, peaks, results):
    """``paged_attention`` against its plain version on the card at the
    shapes phase 8 gives it: decode (T = 1) over 16 slots with ragged
    resident lengths up to 512, in f32 and bf16 pools and with GQA (32 query
    heads on 8 KV heads); and a chunked-prefill slice (T = 64 for one slot
    at position 256, the other 15 slots masked, as the engine sends it).
    Then at deepseek-moe-16b's (``PA_MOE``, head_dim 128): decode in f32 and
    bf16 pools and a 64-token slice, rows keyed with "d128"; and at
    gemma3-27b's (``PA_SWA``: GQA, 32 query heads over 16 KV heads of 128,
    1280 positions a slot), keyed with "gemma".
    Holds max |err| <= PA_ATOL; times the kernel (CUDA events, pools
    rotated past the 50 MB L2), the plain version, and the library call
    ``scaled_dot_product_attention`` on the already-gathered dense view
    under the same mask (the gather excluded: it is the work the kernel
    avoids).  Bound: the live K/V bytes plus q and the output over the
    card's memory rate, or the f32 operations over F32_PEAK."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    cases = (
        ("decode", 1, PA_HEADS, PA_HEADS, torch.float32),
        ("decode", 1, PA_HEADS, PA_HEADS, torch.bfloat16),
        ("decode", 1, PA_HEADS, PA_GQA_KV_HEADS, torch.float32),
        ("chunk", PA_CHUNK, PA_HEADS, PA_HEADS, torch.float32),
        ("chunk", PA_CHUNK, PA_HEADS, PA_HEADS, torch.bfloat16),
    )
    _paged_cases(torch, peaks[0], gen, results, cases, PA_SLOTS, PA_MAX_LEN, PA_HEAD_DIM, 256)
    h = PA_MOE["heads"]
    cases = (("decode", 1, h, h, torch.float32), ("decode", 1, h, h, torch.bfloat16),
             ("chunk", PA_CHUNK, h, h, torch.float32))
    _paged_cases(torch, peaks[0], gen, results, cases, PA_MOE["slots"], PA_MOE["max_len"],
                 PA_MOE["head_dim"], PA_MOE["chunk_at"], key_tag="d128")
    h, hkv = PA_SWA["heads"], PA_SWA["kv_heads"]
    cases = (("decode", 1, h, hkv, torch.float32), ("decode", 1, h, hkv, torch.bfloat16),
             ("chunk", PA_CHUNK, h, hkv, torch.float32))
    _paged_cases(torch, peaks[0], gen, results, cases, PA_SWA["slots"], PA_SWA["max_len"],
                 PA_SWA["head_dim"], PA_SWA["chunk_at"], key_tag="gemma")
    return results


def _paged_cases(torch, bw, gen, results, cases, b, max_len, d, chunk_at, key_tag=""):
    """Phase 3's paged_attention rows of one geometry: ``b`` slots of
    ``max_len`` positions in blocks of PA_BLOCK, head_dim ``d``; each case
    (kind, T, query heads, KV heads, pool dtype) held and timed."""
    import torch.nn.functional as F

    from repro_torch.kernels.paged_attention import paged_attention, paged_attention_plain

    dev = torch.device("cuda")
    bs = PA_BLOCK
    mb = max_len // bs
    nb = b * mb
    lens_decode = torch.randint(1, max_len + 1, (b,), generator=torch.Generator().manual_seed(SEED))
    lens_decode[0] = max_len
    for kind, t, hq, hkv, kv_dtype in cases:
        if kind == "decode":
            kv_lens = lens_decode.clone()
            start = kv_lens - 1
        else:  # one admitting slot; the others masked out (start 0, length 0)
            start = torch.zeros((b,), dtype=torch.int64)
            start[0] = chunk_at
            kv_lens = torch.ones((b,), dtype=torch.int64)
            kv_lens[0] = chunk_at + t
        start_d = start.to(torch.int32).to(dev)
        lens_d = kv_lens.to(torch.int32).to(dev)
        q = torch.randn((b, t, hq, d), generator=gen, device=dev)
        pool_bytes = nb * bs * hkv * d * (4 if kv_dtype == torch.float32 else 2)
        n_copies = max(2, -(-120 * 2**20 // (2 * pool_bytes)))
        pools = [tuple(torch.randn((nb, bs, hkv, d), generator=gen, device=dev).to(kv_dtype)
                       for _ in range(2)) for _ in range(n_copies)]
        table = torch.stack([torch.randperm(nb, generator=gen, device=dev)[:mb]
                             for _ in range(b)]).to(torch.int32)
        kp, vp = pools[0]
        got = paged_attention(q, kp, vp, table, start_d, lens_d)
        want = paged_attention_plain(q, kp, vp, table, start_d, lens_d)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        if not torch.isfinite(got).all() or err > PA_ATOL:
            raise AssertionError(f"paged_attention {kind} {kv_dtype}: max |err| {err} > {PA_ATOL}")
        # attended columns: row t of slot b sees min(start + t + 1, kv_len) of them
        rows = torch.arange(t)[None, :]
        cols = torch.minimum(start[:, None] + rows + 1, kv_lens[:, None]).sum().item() * hkv
        live = int(kv_lens.sum().item())
        elem = 4 if kv_dtype == torch.float32 else 2
        nbytes = 2 * live * hkv * d * elem + 2 * q.numel() * 4 + table.numel() * 4 + 8 * b
        nflops = 4 * d * cols * (hq // hkv)
        t_b, t_o = nbytes / bw * 1e3, nflops / F32_PEAK * 1e3
        bound = (t_b, "bytes") if t_b >= t_o else (t_o, "operations")
        # the library yardstick on the gathered dense (B, L, H, D) view
        kd = kp[table.long()].reshape(b, -1, hkv, d).float().transpose(1, 2)
        vd = vp[table.long()].reshape(b, -1, hkv, d).float().transpose(1, 2)
        col = torch.arange(kd.shape[2], device=dev)
        pos_rows = start_d.long()[:, None] + torch.arange(t, device=dev)[None]
        mask = ((col[None, None, :] <= pos_rows[:, :, None])
                & (col[None, None, :] < lens_d.long()[:, None, None]))[:, None]
        qt = q.transpose(1, 2)
        lib = F.scaled_dot_product_attention(qt, kd, vd, attn_mask=mask, enable_gqa=hq != hkv)
        lib_err = (lib.transpose(1, 2) - want).abs().max().item()
        ms = _time(torch, lambda i: paged_attention(q, *pools[i % n_copies], table, start_d,
                                                    lens_d), 50)
        plain_ms = _time(torch, lambda i: paged_attention_plain(q, kp, vp, table, start_d,
                                                                lens_d), 3, 3)
        library_ms = _time(torch, lambda i: F.scaled_dot_product_attention(
            qt, kd, vd, attn_mask=mask, enable_gqa=hq != hkv), 50)
        tag = f"{kind} T={t} Hq={hq} Hkv={hkv} D={d} B={b} {str(kv_dtype).split('.')[-1]}"
        log(f"[3] paged_attention {tag}: max|err| {err:.3g} (sdpa {lib_err:.3g}), kernel "
            f"{ms * 1e3:.2f} us, plain {plain_ms * 1e3:.1f} us, bound {bound[0] * 1e3:.3f} us "
            f"({bound[1]}; {nbytes / 1e6:.2f} MB, {nflops / 1e9:.3f} GFLOP), sdpa on the "
            f"gathered view {library_ms * 1e3:.2f} us")
        r = results.setdefault("paged_attention", {"max_abs_err": 0.0, "rows": {}})
        r["max_abs_err"] = max(r["max_abs_err"], err)
        r["rows"][(kind, t, hq, hkv, str(kv_dtype).split(".")[-1])
                  + ((key_tag,) if key_tag else ())] = dict(
            ms=ms, plain_ms=plain_ms, bound_ms=bound[0], bound_by=bound[1],
            library_ms=library_ms)
        del pools, kd, vd


# ---------------------------------------------------------------------------
# Phases 4 and 5: the slice end to end
# ---------------------------------------------------------------------------


def _tree(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree(fn, v) for v in tree]
    return fn(tree)


def _serving(torch):
    """pquant-1.3b at full width from ``SEED``, exported packed, with its
    ``DecodeEngine``, the prompts and the greedy sampler of the main path."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models import api
    from repro_torch.serve.engine import DecodeEngine, SamplerConfig
    from repro_torch.train.quantized_serving import quantize_params_for_serving

    cfg = get_config("pquant-1.3b")
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    latent = api.init_model(SEED, cfg, device=dev)
    params = quantize_params_for_serving(latent, cfg, packed=True)
    del latent
    torch.cuda.synchronize()
    log(f"[4] {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, d_ff {cfg.d_ff}, "
        f"r {cfg.quant.r}; init + packed export {time.perf_counter() - t0:.1f} s")
    prompts = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT),
                            generator=torch.Generator().manual_seed(SEED))
    greedy = SamplerConfig(temperature=0.0, top_k=0, max_new_tokens=NEW_TOKENS)
    eng = DecodeEngine(params, cfg, max_len=PROMPT + NEW_TOKENS, device=dev)
    return cfg, params, eng, prompts, greedy


def _time_generate(eng, prompts, greedy, stream, runs: int = TIMED_RUNS):
    """TTFT and full-generate wall times (s) over ``runs`` runs, each ended
    by its one device-to-host transfer; every stream must repeat
    ``stream``.  Returns (median TTFT, median generate, summary line)."""
    first = dataclasses.replace(greedy, max_new_tokens=1)
    ttfts, gens = [], []
    for _ in range(runs):
        t0 = time.perf_counter()
        eng.generate(prompts, first)
        ttfts.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        again = eng.generate(prompts, greedy)
        gens.append(time.perf_counter() - t0)
        if not (again == stream).all():
            raise AssertionError("a repeated generate gave another stream")
    ttft, t_gen = statistics.median(ttfts), statistics.median(gens)
    steps, batch = greedy.max_new_tokens - 1, prompts.shape[0]
    line = (f"over {runs} runs (host clock, each ended by its one transfer): TTFT median "
            f"{ttft * 1e3:.1f} ms (min {min(ttfts) * 1e3:.1f}, max {max(ttfts) * 1e3:.1f}); "
            f"generate median {t_gen * 1e3:.1f} ms (min {min(gens) * 1e3:.1f}, max "
            f"{max(gens) * 1e3:.1f}); decode {(t_gen - ttft) / steps * 1e3:.2f} ms/step, "
            f"{batch * steps / (t_gen - ttft):.1f} tokens/s at batch {batch}")
    return ttft, t_gen, line


def _layer_launches(cfg, per_layer: dict, forwards: int) -> tuple[dict, str]:
    """(kernel -> launches of ``forwards`` forwards whose every layer makes
    ``per_layer`` of them, how that was counted)."""
    return ({k: cfg.n_layers * v * forwards for k, v in per_layer.items()},
            f"{cfg.n_layers} layers x {tuple(v for v in per_layer.values() if v)} x {forwards} "
            "forwards")


def _counted_generate(torch, eng, prompts, greedy, want: dict, how: str, tag: str):
    """One ``generate`` between a reset and a read of the launch counters:
    checks one host transfer and, for each kernel in ``want``, exactly
    ``want[kernel]`` launches (``how`` says how they were counted).
    Returns (stream, launches, wall seconds)."""
    from repro_torch.kernels import _cuda

    before = eng.host_transfers
    torch.cuda.synchronize()
    _cuda.reset_launches()
    t0 = time.perf_counter()
    stream = eng.generate(prompts, greedy)
    t_gen = time.perf_counter() - t0
    launches = dict(_cuda.LAUNCHES)
    if eng.host_transfers - before != 1:
        raise AssertionError(f"{eng.host_transfers - before} host transfers in one generate")
    for name, n in want.items():
        if launches.get(name, 0) != n:
            raise AssertionError(f"{name}: {launches.get(name, 0)} launches, want {n} ({how})")
    log(f"[{tag}] launches in one generate: {launches} (= {how})")
    return stream, launches, t_gen


def phase_slice(torch):
    from repro_torch.models import api

    cfg, params, eng, prompts, greedy = _serving(torch)
    nbytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    log(f"[4] serving params {nbytes / 1e6:.1f} MB")
    dev = torch.device("cuda")
    logits, caches = api.prefill(params, {"tokens": prompts.to(dev)}, cfg, PROMPT + NEW_TOKENS)
    step_logits, _ = api.decode_step(params, logits.argmax(-1)[:, None], caches, PROMPT, cfg)
    if not (torch.isfinite(logits).all() and torch.isfinite(step_logits).all()):
        raise AssertionError("non-finite logits")
    eng.generate(prompts, greedy)  # warm-up (kernel libraries load)
    want = {"w1a8_gemv": 5, "decoupled_gemv": 2, "int8_matmul": 1,
            "w1a8_matmul": 0, "decoupled_matmul": 0}
    # one prefill + max_new_tokens - 1 decode steps
    stream, launches, _ = _counted_generate(
        torch, eng, prompts, greedy, *_layer_launches(cfg, want, greedy.max_new_tokens), "4")

    _, t_gen, line = _time_generate(eng, prompts, greedy, stream)
    log(f"[4] stream (request 0): {stream[0].tolist()}")
    log(f"[4] {line}")
    _profile(torch, eng, prompts, greedy, t_gen)
    return params, cfg, prompts, launches


def _profile(torch, eng, prompts, greedy, wall, tag: str = "4") -> float:
    """Where a generate's time goes on the device (:func:`_device_time`)."""
    return _device_time(torch, lambda: eng.generate(prompts, greedy), wall, tag, "generate")


def _device_time(torch, fn, wall, tag: str, what: str, top: int = 8) -> float:
    """torch.profiler's device time of every kernel of one ``fn()``, summed
    by name, the GEMMs' part of it, and the device's busy share of an
    unprofiled run's wall time ``wall`` (the profiler slows the host, not
    the kernels)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = {}
    for e in prof.events():
        # device-side kernels only: not CPU ops, not the annotate() spans
        if e.device_type != DeviceType.CUDA or e.name.startswith(("serve/", "kernels/", "train/")):
            continue
        us, n = rows.get(e.name, (0.0, 0))
        rows[e.name] = (us + e.device_time_total, n + 1)
    return _log_device_rows(rows, wall, tag, what, top)


def _log_device_rows(rows: dict, wall, tag: str, what: str, top: int) -> float:
    """Logs the device time of ``rows`` (kernel name -> (us, launches)):
    the busy share of ``wall``, the GEMMs' part, the ``top`` kernels.
    Returns the busy seconds."""
    busy = sum(us for us, _ in rows.values()) / 1e6
    gemm = sum(us for k, (us, _) in rows.items()
               if any(w in k.lower() for w in ("gemm", "nvjet", "cutlass", "xmma"))) / 1e6
    log(f"[{tag}] device busy {busy * 1e3:.2f} ms in a {wall * 1e3:.1f} ms {what} "
        f"({100 * busy / wall:.1f}%), GEMMs {gemm * 1e3:.2f} ms; kernels by device time:")
    for name, (us, n) in sorted(rows.items(), key=lambda kv: -kv[1][0])[:top]:
        log(f"[{tag}]   {us / 1e3:8.3f} ms  {n:6d}x  {name.replace('void at::native::', '')[:110]}")
    return busy


def _trace_rows(prof) -> dict:
    """Device time by kernel name, (us, launches), of a finished profile,
    read from its exported trace: kernels, copies and sets."""
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(path))
        events = json.loads(path.read_text())["traceEvents"]
    rows: dict = {}
    for e in events:
        if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"):
            us, n = rows.get(e["name"], (0.0, 0))
            rows[e["name"]] = (us + e.get("dur", 0), n + 1)
    if not rows:
        raise AssertionError("the profiler recorded no device activity")
    return rows


def _device_trace_time(torch, fn, wall, tag: str, what: str, top: int = 8) -> float:
    """:func:`_device_time` from a device-only profile read through its
    exported trace (as ``_cb_busy``): phase 12's routed generate and step
    hold tens of thousands of host ops, which the host-event profile takes
    a minute to record."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return _log_device_rows(_trace_rows(prof), wall, tag, what, top)


def _tree_paths(tree, prefix=""):
    """(path, leaf) of every leaf of a tree of dicts and lists."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _tree_paths(v, f"{prefix}/{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _tree_paths(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


def _leaves(tree):
    return (t for _, t in _tree_paths(tree))


class _ActQuantTrace:
    """Records every act-quant pass while active (its float input, codes
    and scales, on the host), so two runs of one forward can be compared
    pass by pass: the prefill tier's ``ops.quantize_act_int8``; the rows
    the decode GEMVs quantize in their prologue (``ops``'s
    ``_bit_linear_decode`` / ``_decoupled_decode`` wrapped, codes from the
    plain quantizer, which the kernels equal bit for bit); and every
    fake-quant pass (``quantization.quantize_activations_int8``, which on a
    packed export only the routed experts' float branch runs), as rows."""

    def __init__(self):
        self.passes = []

    def __enter__(self):
        from repro_torch.core import quantization
        from repro_torch.kernels import ops

        self._ops, self._orig = ops, ops.quantize_act_int8
        self._qz, self._qorig = quantization, quantization.quantize_activations_int8

        def traced(x):
            q, g = self._orig(x)
            self.passes.append((x.float().cpu(), q.cpu(), g.cpu()))
            return q, g

        def traced_fake(x):
            out, g = self._qorig(x)
            xf, gf = x.float().reshape(-1, x.shape[-1]), g.reshape(-1)
            codes = (xf * gf[:, None]).round().clamp(-127, 127).char()
            self.passes.append((xf.cpu(), codes.cpu(), gf.cpu()))
            return out, g

        def wrap_decode(fn):
            def traced_decode(xf, *args):
                x = xf.float()
                q, g = quantization.quantize_act_int8(x)
                self.passes.append((x.cpu(), q.cpu(), g.cpu()))
                return fn(xf, *args)
            return traced_decode

        self._decode = {n: getattr(ops, n) for n in ("_bit_linear_decode", "_decoupled_decode")}
        for n, fn in self._decode.items():
            setattr(ops, n, wrap_decode(fn))
        ops.quantize_act_int8 = traced
        quantization.quantize_activations_int8 = traced_fake
        return self

    def __exit__(self, *exc):
        self._ops.quantize_act_int8 = self._orig
        self._qz.quantize_activations_int8 = self._qorig
        for n, fn in self._decode.items():
            setattr(self._ops, n, fn)


class _ExpertChoices:
    """While active, every router of the port's forward (``routing._top_k``)
    appends its choice, a device tensor (no host sync), to ``choices``;
    with ``replay`` (another run's choices, in order), each router takes
    its choice from it instead, the gate prob read at that expert.  A model
    without routers records nothing."""

    def __init__(self, replay=None):
        self.choices, self.replay = [], replay

    def __enter__(self):
        from repro_torch.core import routing

        self._mod, self._orig = routing, routing._top_k
        it = iter(self.replay or ())

        def top_k(probs, k):
            vals, idx = self._orig(probs, k)
            self.choices.append(idx.detach())
            if self.replay is None:
                return vals, idx
            idx = next(it).to(probs.device)
            return probs.gather(-1, idx), idx

        routing._top_k = top_k
        return self

    def __exit__(self, *exc):
        self._mod._top_k = self._orig

    def host(self) -> list:
        return [c.cpu() for c in self.choices]


class _Drops:
    """While active, sums the (token, slot) pairs that every router's
    dispatch drops past its expert's capacity, on the device."""

    def __init__(self, torch):
        self.total = torch.zeros((), dtype=torch.long, device="cuda")
        self.routers = 0

    def __enter__(self):
        from repro_torch.core import routing

        self._mod, self._orig = routing, routing.topk_dispatch

        def dispatch(probs, cfg):
            d = self._orig(probs, cfg)
            self.total += (d["buffer_slot"] == d["capacity"]).sum()
            self.routers += 1
            return d

        routing.topk_dispatch = dispatch
        return self

    def __exit__(self, *exc):
        self._mod.topk_dispatch = self._orig


class _PlainKernels:
    """While active, ``ops`` calls each kernel's plain PyTorch version in
    place of the kernel (on the same device, with the same float ops around
    it): the reference a kernel path must equal bit for bit."""

    NAMES = ("w1a8_gemv", "decoupled_gemv", "int8_matmul", "w1a8_matmul", "decoupled_matmul")

    def __enter__(self):
        from repro_torch.kernels import ops
        from repro_torch.kernels import decoupled_matmul, int8_matmul, w1a8_gemv, w1a8_matmul

        self._ops = ops
        self._orig = {n: getattr(ops, n) for n in self.NAMES}
        plain = {"w1a8_gemv": w1a8_gemv.w1a8_gemv_plain,
                 "decoupled_gemv": w1a8_gemv.decoupled_gemv_plain,
                 "int8_matmul": int8_matmul.int8_matmul_plain,
                 "w1a8_matmul": w1a8_matmul.w1a8_matmul_plain,
                 "decoupled_matmul": decoupled_matmul.decoupled_matmul_plain}
        for n, fn in plain.items():
            setattr(ops, n, fn)
        return self

    def __exit__(self, *exc):
        for n, fn in self._orig.items():
            setattr(self._ops, n, fn)


def _compare_act_quant(torch, card, cpu, names=("card", "cpu")) -> dict:
    """Where two traces of one run part: the first pass whose float input
    differs, the first whose int8 codes differ (with the scaled values x *
    gamma of its first differing code on each side), and the largest float
    difference, relative to the pass's max |x|, up to that pass.  ``names``
    label the two runs."""
    a, b = names
    if len(card) != len(cpu):
        raise AssertionError(f"{len(card)} act-quant passes on the {a}, {len(cpu)} on the {b}")
    first_x = first_q = None
    flips, noise = 0, 0.0
    for i, ((xa, qa, ga), (xb, qb, gb)) in enumerate(zip(card, cpu)):
        if first_q is None:
            noise = max(noise, ((xa - xb).abs().max() / xb.abs().max()).item())
        if first_x is None and not torch.equal(xa, xb):
            first_x = (i, tuple(xa.shape), (xa - xb).abs().max().item())
        bad = (qa != qb).nonzero()
        flips += len(bad)
        if first_q is None and len(bad):
            r, c = bad[0].tolist()
            first_q = (i, tuple(xa.shape), len(bad), (xa[r, c] * ga[r]).item(),
                       (xb[r, c] * gb[r]).item())
    line = f"{len(card)} act-quant passes, {flips} codes differ in all"
    if first_x:
        line += (f"; float inputs first differ at pass {first_x[0]} {first_x[1]} "
                 f"(max |{a} - {b}| {first_x[2]:.3g})")
    if first_q:
        line += (f"; codes first differ at pass {first_q[0]} {first_q[1]} ({first_q[2]} of "
                 f"them; the first scaled to {first_q[3]!r} on the {a}, {first_q[4]!r} on "
                 f"the {b}); float inputs up to there differ by at most {noise:.3g} of max|x|")
    return {"flips": flips, "first_code": first_q, "noise": noise, "line": line}


def phase_cut(torch, params, cfg, prompts, tag: str = "5", decode_may_part: bool = False,
              cut=None, prefill_tier: bool = True, replay_choices: bool = False,
              new_tokens: int = CUT_NEW_TOKENS):
    """The first CUT_LAYERS layers at the decode-tier prompts (PR 11's
    check) and at CUT_PREFILL_BATCH x PROMPT tokens (the prefill tier in
    every forward), each run three ways: on the card, on the card with
    every kernel swapped for its plain version, and on the CPU (plain
    versions).

    * kernels vs plain versions on the card: logits and streams equal bit
      for bit (the same float ops around both);
    * card vs CPU: the float ops around the kernels (norms, attention)
      reduce in another order on each device, which leaves their outputs
      a few ulps apart.  Where that never moves an int8 activation code,
      logits must agree within LOGIT_TOL and the greedy streams must be
      equal (always, at the decode-tier prompts).  Where it does, at the
      prefill-tier prompts, the first code that differs must be a
      rounding tie broken by that noise (its scaled values on the two
      devices within BOUNDARY_TOL of each other, the float inputs up to
      it within FLOAT_NOISE), and the two devices may part from there: one
      code step moves the next layers' inputs by far more than an ulp and
      the difference spreads.

    With routed experts (N > 1) each run also records every router's
    choice in the prefill, and the choices that differ between the card
    and the CPU are counted and printed.  ``decode_may_part`` holds the
    decode-tier prompts to the prefill tier's rule as well (a first
    differing code that is a rounding tie may part the runs; the trace
    covers the decode GEMVs' act-quant too): phase 12 sets it.  ``tag``
    labels the lines.

    ``cut`` gives the cut's (params, cfg) directly (phase 13: a dense
    segment and an MoE segment); ``prefill_tier=False`` skips the prefill-tier
    prompts; ``replay_choices`` runs the CPU first and replays its router
    choices (prefill and decode) on the card, with the kernels and with
    their plain versions: a top-6 of 64 near-equal probs can go either way
    between two devices.  The choices the card computes are still counted
    against the CPU's.  ``new_tokens``: the greedy tokens a stream (phase 14
    takes 4: each CPU decode step of a gemma3-27b layer unpacks 0.4e9
    signs)."""
    import contextlib

    from repro_torch.kernels import _cuda
    from repro_torch.models import api
    from repro_torch.serve.engine import DecodeEngine, SamplerConfig

    if cut is None:
        gpu = dict(params)
        gpu["segments"] = [_tree(lambda t: t[:CUT_LAYERS].contiguous(), params["segments"][0])]
        cut = (gpu, dataclasses.replace(cfg, n_layers=CUT_LAYERS))
    gpu, cut = cut
    cpu = _tree(lambda t: t.cpu(), gpu)
    greedy = SamplerConfig(temperature=0.0, top_k=0, max_new_tokens=new_tokens)
    wide = torch.randint(0, cfg.vocab_size, (CUT_PREFILL_BATCH, PROMPT),
                         generator=torch.Generator().manual_seed(SEED + 1))
    cuda = torch.device("cuda")
    # the decode-tier prompts may part only with decode_may_part (phase 12)
    sets = ((prompts, decode_may_part),) + (((wide, True),) if prefill_tier else ())
    for batch_prompts, may_part in sets:
        rows = batch_prompts.numel()
        max_len = batch_prompts.shape[1] + new_tokens
        out = {}
        runs = (("card", gpu, cuda, False), ("card, plain versions", gpu, cuda, True),
                ("cpu", cpu, torch.device("cpu"), False))
        for name, tree, dev, plain in runs[2:] + runs[:2] if replay_choices else runs:
            t0 = time.perf_counter()
            _cuda.reset_launches()
            kernels = _PlainKernels() if plain else contextlib.nullcontext()
            replay = out["cpu"][4] if replay_choices and name != "cpu" else None
            with _ActQuantTrace() as trace, kernels, _ExpertChoices(replay) as routed:
                logits, _ = api.prefill(tree, {"tokens": batch_prompts.to(dev)}, cut, max_len)
                n_prefill = len(routed.choices)
                stream = DecodeEngine(tree, cut, max_len=max_len, device=dev).generate(
                    batch_prompts, greedy)
            launched = sum(_cuda.LAUNCHES.values())
            if launched == 0 if name == "card" else launched:
                raise AssertionError(f"{name}: {launched} kernel launches")
            choices = routed.host()
            out[name] = (logits.cpu(), stream, trace.passes, choices[:n_prefill], choices)
            log(f"[{tag}] {cut.n_layers}-layer cut, {rows} prefill rows, on the {name}: "
                f"{time.perf_counter() - t0:.1f} s, {launched} kernel launches")
        (lg, sg, tg, eg, eg_all), (lc, sc, tc, ec, ec_all) = out["card"], out["cpu"]
        lp, sp = out["card, plain versions"][:2]
        if eg:
            def differ(x, y):
                return sum(int((a != b).sum()) for a, b in zip(x, y, strict=True))

            line = (f"router choices that differ between the card and the CPU: "
                    f"{differ(eg, ec)} of {sum(a.numel() for a in eg)} ({len(eg)} routers)")
            if replay_choices:
                line += (f"; over the prefill and the decode {differ(eg_all, ec_all)} of "
                         f"{sum(a.numel() for a in eg_all)} ({len(eg_all)} router calls), "
                         "the CPU's replayed on the card")
            log(f"[{tag}] {rows} prefill rows: {line}")
        same = torch.equal(lg, lp) and bool((sg == sp).all())
        log(f"[{tag}] {rows} prefill rows: kernels vs plain versions on the card: logits max|diff| "
            f"{(lg - lp).abs().max().item():.3g}, streams equal: {bool((sg == sp).all())}")
        if not same:
            raise AssertionError("the kernels and their plain versions part on the card")
        cmp = _compare_act_quant(torch, tg, tc)
        diff = (lg - lc).abs().max().item()
        scale = lc.abs().max().item()
        log(f"[{tag}] {rows} prefill rows, card vs cpu: {cmp['line']}")
        log(f"[{tag}] {rows} prefill rows: logits max|card - cpu| {diff:.3g} (|logits| <= "
            f"{scale:.3g}, tolerance {LOGIT_TOL} x that); streams equal: {bool((sg == sc).all())}")
        if cmp["flips"] == 0 or not may_part:
            if diff > LOGIT_TOL * scale:
                raise AssertionError("card and CPU logits disagree")
            if not (sg == sc).all():
                raise AssertionError(f"card and CPU greedy streams differ:\n{sg}\n{sc}")
            continue
        s_card, s_cpu = cmp["first_code"][3:]
        if abs(s_card - s_cpu) > BOUNDARY_TOL or cmp["noise"] > FLOAT_NOISE:
            raise AssertionError("card and CPU act-quant codes part beyond float noise")
        log(f"[{tag}] {rows} prefill rows: the first differing code is a rounding tie (scaled "
            f"values {abs(s_card - s_cpu):.3g} apart, tolerance {BOUNDARY_TOL}); card and CPU "
            f"part from there")


# ---------------------------------------------------------------------------
# Phase 6: the prefill tier end to end
# ---------------------------------------------------------------------------


def phase_prefill(torch, params, cfg):
    """pquant-1.3b at full width, served to P_BATCH requests of P_PROMPT
    tokens: every packed linear of every forward runs the prefill tier.
    Returns ({kernel: launches}, summary dict)."""
    from repro_torch.kernels import _cuda, ops
    from repro_torch.kernels.rmsnorm_quant import rmsnorm_quant_plain
    from repro_torch.models import api
    from repro_torch.models.layers import embed
    from repro_torch.serve.engine import DecodeEngine, SamplerConfig

    dev = torch.device("cuda")
    max_len = P_PROMPT + P_NEW_TOKENS
    prompts = torch.randint(0, cfg.vocab_size, (P_BATCH, P_PROMPT),
                            generator=torch.Generator().manual_seed(SEED + 2))
    greedy = SamplerConfig(temperature=0.0, top_k=0, max_new_tokens=P_NEW_TOKENS)
    eng = DecodeEngine(params, cfg, max_len=max_len, device=dev)
    torch.cuda.reset_peak_memory_stats()
    logits, caches = api.prefill(params, {"tokens": prompts.to(dev)}, cfg, max_len)
    step_logits, _ = api.decode_step(params, logits.argmax(-1)[:, None], caches, P_PROMPT, cfg)
    if not (torch.isfinite(logits).all() and torch.isfinite(step_logits).all()):
        raise AssertionError("non-finite logits")
    kv_bytes = sum(t.numel() * t.element_size() for t in _leaves(caches))
    del logits, caches, step_logits
    log(f"[6] {P_BATCH} requests x {P_PROMPT} tokens = {P_BATCH * P_PROMPT} prefill rows, "
        f"then {P_BATCH} decode rows; dense KV cache of {max_len} positions "
        f"{kv_bytes / 1e9:.2f} GB; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    eng.generate(prompts, greedy)  # warm-up
    want = {"w1a8_matmul": 5, "decoupled_matmul": 2, "int8_matmul": 1,
            "w1a8_gemv": 0, "decoupled_gemv": 0}
    stream, launches, _ = _counted_generate(
        torch, eng, prompts, greedy, *_layer_launches(cfg, want, greedy.max_new_tokens), "6")
    ttft, t_gen, line = _time_generate(eng, prompts, greedy, stream, P_TIMED_RUNS)
    log(f"[6] stream (request 0): {stream[0].tolist()}")
    log(f"[6] {line}")
    busy = _profile(torch, eng, prompts, greedy, t_gen, "6")
    log("[6] the prefill alone (a one-token generate):")
    busy_first = _profile(torch, eng, prompts, dataclasses.replace(greedy, max_new_tokens=1),
                          ttft, "6")

    # rmsnorm_quant through its entry point, on the prompts' embeddings
    # with the first layer's pre-norm scale
    h = embed(params["embed"], prompts.to(dev), cfg)
    norm_scale = params["segments"][0]["b0"]["pre_norm"]["scale"][0]
    torch.cuda.synchronize()
    _cuda.reset_launches()
    q, g = ops.fused_rmsnorm_quant(h, norm_scale)
    launches["rmsnorm_quant"] = _cuda.LAUNCHES["rmsnorm_quant"]
    if launches["rmsnorm_quant"] != 1:
        raise AssertionError(f"fused_rmsnorm_quant launched rmsnorm_quant "
                             f"{launches['rmsnorm_quant']} times, want 1")
    q_ref, g_ref = rmsnorm_quant_plain(h.reshape(-1, h.shape[-1]), norm_scale)
    err = _codes_close(q.reshape(q_ref.shape), q_ref, g.reshape(-1), g_ref)
    log(f"[6] ops.fused_rmsnorm_quant on {tuple(h.shape)} {h.dtype}: 1 launch "
        f"({_rmsnorm_route(h.reshape(-1, h.shape[-1]))} route), gamma max|err| {err:.3g}, "
        "codes within the stated tolerance")
    summary = {"ttft_ms": ttft * 1e3, "ms_per_step": (t_gen - ttft) / (P_NEW_TOKENS - 1) * 1e3,
               "tokens_per_s": P_BATCH * (P_NEW_TOKENS - 1) / (t_gen - ttft),
               "device_busy_share": busy / t_gen, "prefill_busy_share": busy_first / ttft,
               "prefill_device_ms": busy_first * 1e3}
    return launches, summary


# ---------------------------------------------------------------------------
# Phases 8 and 9: continuous batching on the paged KV pool
# ---------------------------------------------------------------------------

CB_SLOTS, CB_MAX_LEN, CB_BLOCK, CB_CHUNK, CB_PREFILL_CHUNK = 16, 512, 16, 8, 64
CB_REQUESTS, CB_FIRST_WAVE = 32, 16  # 16 arrive at tick 0, then one per tick
CB_PROMPT, CB_NEW = (16, 384), (8, 32)  # inclusive ranges of the load
# a continuous-batching load: slots, positions a slot, requests, how many
# arrive at tick 0 (then one a tick), inclusive ranges of prompt and new
# tokens, and (when not 0) the last request's prompt length in place of its
# draw; phase 8's, and [13] (d)'s
CBLoad = collections.namedtuple("CBLoad", "slots max_len requests first_wave prompt new long",
                                defaults=(0,))
CB_LOAD = CBLoad(CB_SLOTS, CB_MAX_LEN, CB_REQUESTS, CB_FIRST_WAVE, CB_PROMPT, CB_NEW)
CB_PROFILE_STEPS = (4, 6)  # engine steps [a, b) profiled for the device busy share
NEAR_TIE = 1e-3  # top-2 logit gap under which two greedy streams may part
CB_CONFIGS = (  # name, layout, prefill_chunk, pool size (fraction of default), REPRO_PAGED_ATTN
    ("a", "paged", None, 1, "auto"),
    ("b", "paged", CB_PREFILL_CHUNK, 1, "auto"),
    ("c", "paged", None, 1, "0"),
    ("d", "dense", None, 1, "auto"),
    ("e", "paged", None, 3, "auto"),
)


def _cb_load(vocab: int, load: CBLoad = CB_LOAD):
    """A continuous-batching load from SEED (phase 8's by default):
    [(uid, prompt, max_new_tokens, arrival)]."""
    import numpy as np

    rng = np.random.default_rng(SEED)
    lens = rng.integers(load.prompt[0], load.prompt[1] + 1, load.requests)
    news = rng.integers(load.new[0], load.new[1] + 1, load.requests)
    if load.long:
        lens[-1] = load.long
    return [(i, rng.integers(0, vocab, int(n)).astype(np.int32), int(m),
             float(max(0, i - load.first_wave + 1)))
            for i, (n, m) in enumerate(zip(lens, news))]


class _PagedEnv:
    """Sets ``REPRO_PAGED_ATTN`` while active (None leaves it unset)."""

    def __init__(self, value):
        self.value = value

    def __enter__(self):
        import os

        self._old = os.environ.pop("REPRO_PAGED_ATTN", None)
        if self.value is not None:
            os.environ["REPRO_PAGED_ATTN"] = self.value
        return self

    def __exit__(self, *exc):
        import os

        os.environ.pop("REPRO_PAGED_ATTN", None)
        if self._old is not None:
            os.environ["REPRO_PAGED_ATTN"] = self._old


def _cb_engine(torch, params, cfg, layout, prefill_chunk, pool_div, load: CBLoad = CB_LOAD):
    from repro_torch.serve import ContinuousBatchingEngine, SamplerConfig

    greedy = SamplerConfig(temperature=0.0, top_k=0, max_new_tokens=load.new[1])
    default = load.slots * load.max_len // CB_BLOCK
    eng = ContinuousBatchingEngine(
        params, cfg, load.slots, load.max_len, greedy, layout=layout, block_size=CB_BLOCK,
        num_blocks=default // pool_div, chunk=CB_CHUNK, prefill_chunk=prefill_chunk,
        device=torch.device("cuda"))
    for uid, prompt, new, arrival in _cb_load(cfg.vocab_size, load):
        eng.submit(prompt, max_new_tokens=new, seed=uid, uid=uid, arrival=arrival)
    counts = {"chunks": 0, "slices": 0, "owners": []}
    run_chunk, prefill_tick = eng._run_chunk, eng._prefill_tick

    def chunk():  # counts decode chunks and notes each slot's request
        counts["chunks"] += 1
        counts["owners"].append([None if rs is None else rs.request.uid for rs in eng._slots])
        return run_chunk()

    def tick():
        before = eng.prefill_tokens
        out = prefill_tick()
        counts["slices"] += eng.prefill_tokens != before
        return out

    eng._run_chunk, eng._prefill_tick = chunk, tick
    return eng, counts


def _cb_run(torch, params, cfg, name, layout, prefill_chunk, pool_div, env,
            load: CBLoad = CB_LOAD):
    """One phase 8 run: serve ``load`` to the end on a fresh engine, each
    engine step ended by a synchronize.  Returns the run's record, the
    streams (uid -> tokens), the finish reasons and, per decode chunk, the
    request in each slot."""
    from repro_torch.kernels import _cuda

    with _PagedEnv(env):
        eng, counts = _cb_engine(torch, params, cfg, layout, prefill_chunk, pool_div, load)
        torch.cuda.synchronize()
        _cuda.reset_launches()
        steps, finished = [], []
        t_start = time.perf_counter()
        while eng._queue or eng._live() or eng._pending_finished:
            now, t0 = eng.now(), time.perf_counter()
            finished.extend(eng.step())
            torch.cuda.synchronize()
            steps.append((now, t0, time.perf_counter()))
        wall = time.perf_counter() - t_start
        launches = dict(_cuda.LAUNCHES)
    # wall-clock TTFT: from the start of the first step at or after the
    # arrival tick to the end of the step that sampled the first token
    ttft = []
    for f in finished:
        t_arr = min(t0 for now, t0, _ in steps if now >= f.arrival)
        t_first = max(t1 for now, _, t1 in steps if now == f.first_token_at)
        ttft.append((t_first - t_arr) * 1e3)
    rec = {
        "name": name, "layout": layout, "prefill_chunk": prefill_chunk,
        "num_blocks": eng.num_blocks, "paged_attn": env, "wall_s": wall,
        "engine_steps": len(steps), "ms_per_step": wall / len(steps) * 1e3,
        "tokens": eng.tokens_generated, "tokens_per_s": eng.tokens_generated / wall,
        "ttft_ms_p50": statistics.quantiles(ttft, n=100, method="inclusive")[49],
        "ttft_ms_p99": statistics.quantiles(ttft, n=100, method="inclusive")[98],
        "ttft_ticks_p50": sorted(f.first_token_at - f.arrival for f in finished)[
            len(finished) // 2],
        "preemptions_total": eng.preemptions, "decode_chunks": counts["chunks"],
        "decode_steps": counts["chunks"] * CB_CHUNK, "chunked_slices": counts["slices"],
        "host_transfers": eng.host_transfers, "launches": launches,
        "free_blocks": None if eng.allocator is None else eng.allocator.free_count,
        "step_walls": [t1 - t0 for _, t0, t1 in steps],
    }
    streams = {f.uid: f.tokens for f in finished}
    reasons = [f.finish_reason for f in finished]
    del eng
    torch.cuda.empty_cache()
    return rec, streams, reasons, counts["owners"]


def _cb_busy(torch, params, cfg, layout, prefill_chunk, pool_div, env, step_walls):
    """Device busy share of engine steps CB_PROFILE_STEPS: a second,
    deterministic run of the same load is profiled over those steps
    (device activity only, read from the exported trace: parsing every
    host op of a window this long takes the profiler minutes); the device
    time of its kernels, copies and sets is divided by the same steps'
    wall time in the unprofiled run (the profiler slows the host, not the
    kernels).  Returns (busy share, the six kernels with the most device
    time: [(name, (us, launches))], the device ms of each decode GEMV's
    kernels, every instantiation summed)."""
    from torch.profiler import ProfilerActivity, profile

    lo, hi = CB_PROFILE_STEPS
    with _PagedEnv(env):
        eng, _ = _cb_engine(torch, params, cfg, layout, prefill_chunk, pool_div)
        for _ in range(lo):
            eng.step()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(hi - lo):
                eng.step()
                torch.cuda.synchronize()
    by_name = _trace_rows(prof)
    busy_us = sum(us for us, _ in by_name.values())
    del eng
    torch.cuda.empty_cache()
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:6]
    gemv_ms = {g: sum(us for k, (us, _) in by_name.items() if f"{g}_kernel" in k) / 1e3
               for g in ("w1a8_gemv", "decoupled_gemv")}
    return busy_us / 1e6 / sum(step_walls[lo:hi]), top, gemv_ms


def phase_continuous(torch, params, cfg):
    """Phase 8: ``ContinuousBatchingEngine`` serving full-width pquant-1.3b
    (packed, greedy) to CB_REQUESTS ragged requests in five
    configurations; fails unless (c) equals (d) and (e) equals (a) stream
    for stream, (e) preempted, every paged pool drains, paged_attention
    launched layers x (decode steps + chunked slices) times on (a), (b),
    (e) and never on (c), (d), and every request finished once by length.
    Returns ({config: record}, {config: streams})."""
    recs, streams = {}, {}
    for name, layout, pc, div, env in CB_CONFIGS:
        rec, st, reasons, _ = _cb_run(torch, params, cfg, name, layout, pc, div, env)
        rec["device_busy_share"], top, rec["gemv_device_ms"] = _cb_busy(
            torch, params, cfg, layout, pc, div, env, rec.pop("step_walls"))
        recs[name], streams[name] = rec, st
        log(f"[8] ({name}) {json.dumps(rec)}")
        lo, hi = CB_PROFILE_STEPS
        log(f"[8] ({name}) device time by kernel over engine steps {lo}-{hi - 1}: " + "; ".join(
            f"{us / 1e3:.3f} ms {n}x {k[:60]}" for k, (us, n) in top))
        if sorted(st) != list(range(CB_REQUESTS)) or set(reasons) != {"length"} \
                or len(reasons) != CB_REQUESTS:
            raise AssertionError(f"({name}): requests did not each finish once by length")
        if rec["free_blocks"] is not None and rec["free_blocks"] != rec["num_blocks"]:
            raise AssertionError(f"({name}): {rec['free_blocks']} of {rec['num_blocks']} "
                                 "blocks free after the run")
        pa = rec["launches"].get("paged_attention", 0)
        want = 0 if env == "0" or layout == "dense" else \
            cfg.n_layers * (rec["decode_steps"] + rec["chunked_slices"])
        if pa != want:
            raise AssertionError(f"({name}): paged_attention launched {pa} times, want {want}")
    same = lambda x, y: all((streams[x][u] == streams[y][u]).all() for u in streams[x])
    if not same("c", "d"):
        raise AssertionError("(c) paged gather and (d) dense streams differ")
    if not same("e", "a") or recs["e"]["preemptions_total"] == 0:
        raise AssertionError("(e) did not preempt, or its streams differ from (a)")
    log("[8] (c) == (d) and (e) == (a) stream for stream; every paged pool drained")
    return recs, streams


def _first_parting(a, b):
    """Index of the first token where two streams differ, or None."""
    n = min(len(a), len(b))
    diff = [i for i in range(n) if a[i] != b[i]]
    return diff[0] if diff else (None if len(a) == len(b) else n)


def _near_tie(torch, params, cfg, prompt, ref, k) -> float:
    """Top-2 logit gap at step k of the reference stream, teacher-forced
    through ``forward`` (prompt + ref[:k])."""
    from repro_torch.models import api

    toks = torch.as_tensor(list(prompt) + list(ref[:k]), device="cuda")[None].long()
    logits, _ = api.forward(params, {"tokens": toks}, cfg)
    top = torch.topk(logits[0, -1].float(), 2).values
    return (top[0] - top[1]).item()


def _compare_streams(torch, params, cfg, load, x, y, label, tag: str = "9") -> int:
    """Streams x (the reference) vs y, uid -> tokens: prints how many are
    equal and, for each that parts, the top-2 gap of the teacher-forced
    reference at the first parted token against NEAR_TIE.  Returns how
    many are equal."""
    prompts = {uid: p for uid, p, _, _ in load}
    equal, ties = 0, 0
    for uid in y:
        k = _first_parting(x[uid], y[uid])
        if k is None:
            equal += 1
            continue
        gap = _near_tie(torch, params, cfg, prompts[uid], x[uid], k)
        ties += gap < NEAR_TIE
        log(f"[{tag}] {label}: request {uid} parts at token {k} ({x[uid][k]} vs {y[uid][k]}), "
            f"top-2 gap {gap:.3g}{' (a near-tie)' if gap < NEAR_TIE else ''}")
    log(f"[{tag}] {label}: {equal} of {len(y)} streams equal; of the {len(y) - equal} that part, "
        f"{ties} part at a near-tie (gap < {NEAR_TIE})")
    return equal


def _first_flips_by_slot(torch, passes_a, passes_b, steps) -> dict:
    """Per slot (a row of the CB_SLOTS-row decode passes), where two
    decode-tier act-quant traces of one engine trace first give a
    different int8 code while the slot decodes: slot -> (pass index,
    scaled value x * gamma of that code in a and in b, the largest float
    difference of the slot's inputs up to and in that pass, relative to its
    max |x|).  ``steps`` holds each decode step's (active mask, passes so
    far); an idle slot's row is skipped (its output is discarded, and its
    stale block table may name blocks another slot now writes).  Slots are
    independent rows: a code that differs in one slot moves no other
    slot's numbers."""
    if len(passes_a) != len(passes_b):
        raise AssertionError(f"{len(passes_a)} vs {len(passes_b)} act-quant passes")
    flips, noise = {}, torch.zeros(CB_SLOTS, dtype=torch.float64)
    step = 0
    for i, ((xa, qa, ga), (xb, qb, gb)) in enumerate(zip(passes_a, passes_b)):
        while step < len(steps) and steps[step][1] <= i:
            step += 1
        if xa.shape[0] != CB_SLOTS or step == len(steps):
            continue  # an admission prefill's rows are tokens, not slots
        active = steps[step][0]
        rel = ((xa - xb).abs().amax(dim=1) / xb.abs().amax(dim=1)).double().cpu()
        diff = (qa != qb)
        rows = diff.any(dim=1).cpu()
        for slot in range(CB_SLOTS):
            if slot in flips or not active[slot]:
                continue
            noise[slot] = max(noise[slot], rel[slot])
            if rows[slot]:
                c = diff[slot].nonzero()[0, 0].item()
                flips[slot] = (i, (xa[slot, c] * ga[slot]).item(),
                               (xb[slot, c] * gb[slot]).item(), noise[slot].item())
    return flips


class _DecodeLogits:
    """Records each decode step's (B, V) logits and active mask (on the
    host) while active, with ``count()`` at that step (the act-quant passes
    so far): the scheduler's ``api.decode_step`` is wrapped."""

    def __init__(self, count):
        self.count, self.steps = count, []

    def __enter__(self):
        from repro_torch.models import api

        self._api, self._orig = api, api.decode_step

        def traced(params, tokens, caches, pos, cfg, active=None):
            logits, caches = self._orig(params, tokens, caches, pos, cfg, active)
            self.steps.append((logits[:, -1].float().cpu(), active.cpu(), self.count()))
            return logits, caches

        api.decode_step = traced
        return self

    def __exit__(self, *exc):
        self._api.decode_step = self._orig


class _DecodeActQuantTrace:
    """Records every decode-tier act-quant pass while active: the float
    rows the GEMV kernels quantize in their prologue (``ops``'s
    ``_bit_linear_decode`` / ``_decoupled_decode`` are wrapped), with the
    codes and scales the plain quantizer gives them (the kernels' are the
    same bit for bit), kept on the device."""

    def __enter__(self):
        from repro_torch.core.quantization import quantize_act_int8
        from repro_torch.kernels import ops

        self.passes, self._ops = [], ops
        self._orig = {n: getattr(ops, n) for n in ("_bit_linear_decode", "_decoupled_decode")}

        def wrap(fn):
            def traced(xf, *args):
                x = xf.float().clone()
                self.passes.append((x, *quantize_act_int8(x)))
                return fn(xf, *args)
            return traced

        for n, fn in self._orig.items():
            setattr(ops, n, wrap(fn))
        return self

    def __exit__(self, *exc):
        for n, fn in self._orig.items():
            setattr(self._ops, n, fn)


class _PagedVsGather:
    """While active, every paged attention call also runs the gather path
    on the same inputs; keeps the largest |kernel - gather| over the rows
    that carry a token (a ragged slice's pad rows attend other columns by
    design)."""

    def __init__(self, torch):
        self.torch, self.max_err, self.calls = torch, 0.0, 0

    def __enter__(self):
        from repro_torch.models import attention

        self._mod, self._orig = attention, attention._paged_scores
        torch = self.torch

        def checked(q, kpool, vpool, table, posv, posmat, n_valid, read_to):
            out = self._orig(q, kpool, vpool, table, posv, posmat, n_valid, read_to)
            with _PagedEnv("0"):
                ref = self._orig(q, kpool, vpool, table, posv, posmat, n_valid, read_to)
            t = q.shape[1]
            rows = torch.arange(t, device=q.device)[None, :] < torch.as_tensor(
                n_valid, device=q.device).reshape(-1, 1)
            err = ((out - ref).abs().amax(dim=(2, 3)) * rows).max().item()
            self.max_err, self.calls = max(self.max_err, err), self.calls + 1
            return out

        attention._paged_scores = checked
        return self

    def __exit__(self, *exc):
        self._mod._paged_scores = self._orig


def phase_continuous_cut(torch, params, cfg, full_streams):
    """Phase 9: the kernel route against the gather route on a
    CUT_LAYERS-layer full-width cut, on the phase 8 load.

    * Every paged attention call of the kernel runs, (a) (decode steps)
      and (b) (decode steps and 64-token slices), is held to the gather
      route on the same inputs within PA_ATOL: the kernel's own tolerance,
      on the engine's data.
    * (a) against (c), the gather route, with both runs' decode-tier
      act-quant passes traced per slot (slots are independent rows): each
      slot's decode logits agree within LOGIT_TOL of their scale at every
      step before the slot's first act-quant code that differs between the
      runs, and that code is a rounding tie broken by the attention's float
      noise (scaled values within BOUNDARY_TOL, the slot's float inputs up
      to it within FLOAT_NOISE of max|x|), as in phase 5.  With no
      differing code every stream must be equal.
    * Streams (a) vs (c), (b) vs (a) and (a) vs the port's ``DecodeEngine``
      batch-1 (8 requests): how many are equal, and for each parting the
      top-2 gap of the teacher-forced reference at that token, against
      NEAR_TIE.  Reported, not held: once one code lands on the other side
      of a tie, the difference spreads through the slot's later steps and
      its greedy stream can part at wider gaps.

    Then prints how many phase 8 streams matched at full depth."""
    from repro_torch.serve import DecodeEngine, SamplerConfig

    cut = dataclasses.replace(cfg, n_layers=CUT_LAYERS)
    gpu = dict(params)
    gpu["segments"] = [_tree(lambda t: t[:CUT_LAYERS].contiguous(), params["segments"][0])]
    load = _cb_load(cfg.vocab_size)
    runs, logits, quant = {}, {}, {}
    for name, pc in (("a", None), ("b", CB_PREFILL_CHUNK)):
        with _PagedVsGather(torch) as check:
            if name == "a":
                with _DecodeActQuantTrace() as aq, _DecodeLogits(lambda: len(aq.passes)) as lg:
                    _, runs["a"], _, owners = _cb_run(torch, gpu, cut, "a", "paged", None, 1,
                                                      "1")
                logits["1"], quant["1"] = lg.steps, aq.passes
            else:
                _, runs["b"], _, _ = _cb_run(torch, gpu, cut, "b", "paged", pc, 1, "1")
        log(f"[9] {CUT_LAYERS}-layer cut, kernel route ({name}): {check.calls} paged attention "
            f"calls, max |kernel - gather| on the same inputs {check.max_err:.3g} "
            f"(tolerance {PA_ATOL})")
        if check.max_err > PA_ATOL:
            raise AssertionError("paged_attention and the gather path disagree in the trace")
    with _DecodeActQuantTrace() as aq, _DecodeLogits(lambda: len(aq.passes)) as lg:
        _, runs["c"], _, _ = _cb_run(torch, gpu, cut, "c", "paged", None, 1, "0")
    logits["0"], quant["0"] = lg.steps, aq.passes
    if len(logits["1"]) != len(logits["0"]):
        raise AssertionError("the kernel and gather runs took different engine traces")
    flips = _first_flips_by_slot(torch, quant["1"], quant["0"],
                                 [(aa, n) for _, aa, n in logits["1"]])
    del quant
    worst, compared = 0.0, 0
    for (la, aa, n_passes), (lc, _, _) in zip(logits["1"], logits["0"]):
        for slot in aa.nonzero().flatten().tolist():
            if slot in flips and n_passes > flips[slot][0]:
                continue  # this slot's step read its first differing code
            scale = lc[slot].abs().max().item()
            worst = max(worst, (la[slot] - lc[slot]).abs().max().item() / scale)
            compared += 1
    log(f"[9] decode logits, kernel vs gather route, each slot before its first differing "
        f"act-quant code: {compared} (step, slot) rows, max |diff| / max |logits| "
        f"{worst:.3g} (tolerance {LOGIT_TOL})")
    if worst > LOGIT_TOL:
        raise AssertionError("decode logits of the kernel and gather routes disagree")
    if not flips:
        if any((runs["a"][u] != runs["c"][u]).any() for u in runs["a"]):
            raise AssertionError("no act-quant code differs, yet the streams do")
        log("[9] no decode-tier act-quant code differs between the routes")
    else:
        gap = max(abs(f[1] - f[2]) for f in flips.values())
        noise = max(f[3] for f in flips.values())
        log(f"[9] decode-tier act-quant codes differ in {len(flips)} of {CB_SLOTS} slots; each "
            f"slot's first differing code is a rounding tie: scaled values at most {gap:.3g} "
            f"apart (tolerance {BOUNDARY_TOL}), float inputs up to it within {noise:.3g} of "
            f"max|x| (tolerance {FLOAT_NOISE}); a slot's logits part from there")
        if gap > BOUNDARY_TOL or noise > FLOAT_NOISE:
            raise AssertionError("kernel and gather routes part beyond a rounding tie")
    _compare_streams(torch, gpu, cut, load, runs["a"], runs["c"], "(a) vs (c), 2 layers")
    _compare_streams(torch, gpu, cut, load, runs["a"], runs["b"], "(b) vs (a), 2 layers")
    greedy = SamplerConfig(temperature=0.0, top_k=0, max_new_tokens=CB_NEW[1])
    dec = DecodeEngine(gpu, cut, max_len=CB_MAX_LEN, device=torch.device("cuda"))
    ref = {uid: dec.generate(p[None], dataclasses.replace(greedy, max_new_tokens=n))[0]
           for uid, p, n, _ in load[:8]}
    _compare_streams(torch, gpu, cut, load, ref, {u: runs["a"][u] for u in ref},
                     "(a) vs DecodeEngine batch-1, 2 layers")
    fa, fb, fc = full_streams["a"], full_streams["b"], full_streams["c"]
    dec = DecodeEngine(params, cfg, max_len=CB_MAX_LEN, device=torch.device("cuda"))
    ref = {uid: dec.generate(p[None], dataclasses.replace(greedy, max_new_tokens=n))[0]
           for uid, p, n, _ in load[:8]}
    eq = lambda x, y, us: sum(bool((x[u] == y[u]).all()) for u in us)
    log(f"[9] at {cfg.n_layers} layers: (a) vs (c) {eq(fa, fc, fa)} of {len(fa)} streams "
        f"equal, (b) vs (a) {eq(fa, fb, fa)} of {len(fa)}, (a) vs DecodeEngine batch-1 "
        f"{eq(fa, ref, ref)} of {len(ref)}")


# ---------------------------------------------------------------------------
# Phase 10: the QAT training step
# ---------------------------------------------------------------------------

TRAIN_BATCH, TRAIN_SEQ = 4, 2048  # 8192 tokens a step; 2048 is the paper's SEQ
TRAIN_WARMUP, TRAIN_TIMED = 2, 5
# total steps of the schedule: a warm-up of 50 steps from lr 0, so step 0
# moves no parameter and every later step does
TRAIN_TOTAL_STEPS = 1000
TRAIN_CUT_LAYERS, TRAIN_CUT_BATCH, TRAIN_CUT_SEQ = 2, 2, 64
# card vs CPU, the CPU tests' rule (tests/test_torch_train.py): every
# gradient leaf within GRAD_RTOL of its largest element with the CPU's
# act-quant decisions replayed on the card (and the loss within
# TRAIN_ATOL); primary flips (a code, or a row's AbsMax elements, decided
# two ways where both inputs agree within TIE_NOISE) at most FLIP_RATE of
# the codes; the loss as computed within TRAIN_ATOL + 2 * TRAIN_ATOL_FLIP
# times the share of tokens that met a differing code
TRAIN_ATOL, TRAIN_ATOL_FLIP = 1e-5, 5e-2
GRAD_RTOL = 1e-5
# with routed experts, the AbsMax element of each 8-bit slice: its
# gradient sums the whole (K, M) slice in f32, each device in its own
# order, while the slice's largest other element takes only the tokens
# its expert saw (about 1/N of them); held as tests/test_torch_train.py
# holds an AbsMax element's gradient (AMAX_TOL of the largest); so is a
# 0-d leaf (one layer's alpha or beta: deepseek-moe-16b's 2-layer cut
# leaves its layers unstacked), whose gradient sums the layer's whole
# (tokens, d_model) branch output in f32, each device in its own order
AMAX_TOL = 1e-4
# At gemma3-27b's widths (d_ff 21504, r 1024) one device's own f32 noise
# reaches those rules (on the CPU alone, one FFN layer deep, against f64:
# the 1-bit leaves 3.7e-6-4.4e-6 of their largest element, the 8-bit
# slices' AbsMax elements 3e-4-3e-3).  So on phase 14's cut at those widths
# (``phase_train_cut(f32_noise=True)``), and there only:
# * an 8-bit slice's AbsMax element takes, through the scale, the sum over
#   the whole slice of g_i (w_i gamma - round(w_i gamma)) / 127 (g the
#   gradient of the quantized weight, read from the CPU's gradient of the
#   slice's other elements): n = K x M terms of mixed sign, each device
#   rounding their f32 sum in its own order, a tree of about log2(n)
#   roundings of u = 2^-24 relative to sum |t_i|; it is also held within
#   2 log2(n) u sum |t_i|, the two devices' bounds added;
# * any other leaf that misses its rule is judged against an f64 run of
#   the same code on the card with the CPU's decisions replayed (the steps
#   the port keeps in f32 stay f32: norms, the attention softmax, the
#   loss): the card's f32 gradient may lie at most F64_JUDGE times as far
#   from it (max |.| over the leaf) as the CPU's f32 gradient does
F32_UNIT = 2.0**-24
F64_JUDGE = 2.0
FLIP_RATE = 1e-4
TIE_NOISE = 1e-3


def _train_batch(torch, vocab: int, b: int, s: int, seed: int, device):
    """b sequences of s tokens from a seeded generator; labels are the next
    tokens."""
    toks = torch.randint(0, vocab, (b, s + 1), generator=torch.Generator().manual_seed(seed))
    return {"tokens": toks[:, :-1].to(device), "labels": toks[:, 1:].to(device)}


def _train_flops(cfg, n_params: int, b: int, s: int) -> tuple[float, float]:
    """(model FLOPs of one step, FLOPs with remat's second forward) of a
    model with ``n_params`` (active) parameters, both vocabulary tables
    among them where the head is untied.  6 N T for the matmul weights
    (forward 2 N T, backward 4 N T; N without an untied input embedding,
    which is a gather, the tied table counted once, for the unembedding)
    plus 6 L B S^2 H (d_qk + d_v) for the attention matmuls (QK^T at H d_qk
    and AV at H d_v, 2 B S^2 H d each in the forward, over all S^2: no
    causal skip; under MLA d_qk = qk_nope + qk_rope and d_v = v_head_dim,
    else both head_dim), T = B S tokens; remat runs the layers' forward
    again (their weights: N without the vocabulary tables)."""
    t = b * s
    tables = cfg.vocab_size * cfg.d_model
    d_qk, d_v = _attn_widths(cfg)
    attn = 2 * b * s * s * cfg.n_heads * (d_qk + d_v) * cfg.n_layers
    model = 6 * (n_params - (0 if cfg.tie_embeddings else tables)) * t + 3 * attn
    layer_params = n_params - tables * (1 if cfg.tie_embeddings else 2)
    return model, model + 2 * layer_params * t + attn


def _attn_widths(cfg) -> tuple[int, int]:
    """(d_qk, d_v): a head's query/key and value widths."""
    if cfg.attn_type == "mla":
        return cfg.qk_nope_dim + cfg.qk_rope_dim, cfg.v_head_dim
    return cfg.head_dim, cfg.head_dim


def _flops_formula(cfg, n_params: int, b: int, s: int) -> str:
    """:func:`_train_flops`'s model FLOPs written out with this step's numbers."""
    d_qk, d_v = _attn_widths(cfg)
    n = n_params - (0 if cfg.tie_embeddings else cfg.vocab_size * cfg.d_model)
    return (f"6 x N x tokens + 6 x layers x batch x seq^2 x heads x (d_qk + d_v), N the "
            f"matmul parameters (without an untied input embedding) = 6 x {n} x {b * s} + 6 x "
            f"{cfg.n_layers} x {b} x {s}^2 x {cfg.n_heads} x ({d_qk} + {d_v})")


@contextlib.contextmanager
def _sync_log(torch):
    """While open, CUDA's sync debug mode warns at each host sync; yields the
    list of caught warnings as it grows.  torch warns "called a
    synchronizing CUDA operation" at each sync (and once that
    "Synchronization debug mode is a prototype feature")."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            yield caught
        finally:
            torch.cuda.set_sync_debug_mode(0)


def _sync_msgs(caught) -> list:
    return [str(w.message) for w in caught if "synchronizing" in str(w.message)]


def _syncs(torch, fn) -> list:
    """The host syncs of ``fn()`` that CUDA's sync debug mode reports."""
    with _sync_log(torch) as caught:
        fn()
    return _sync_msgs(caught)


def phase_train(torch, smi: str) -> dict:
    """[10] make_train_step on full-width pquant-1.3b (bf16 forward, remat
    on) at TRAIN_BATCH x TRAIN_SEQ tokens: warm-up steps, timed steps, one
    profiled step; checks the losses and that a step moved the weights."""
    from repro_torch.configs.registry import get_config
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.train import trainer

    cfg = get_config("pquant-1.3b")
    if cfg.dtype != "bfloat16" or not cfg.remat:
        raise AssertionError(f"{cfg.name}: dtype {cfg.dtype}, remat {cfg.remat}")
    dev = torch.device("cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    state = trainer.init_train_state(SEED, cfg, device=dev)
    torch.cuda.synchronize()
    n = sum(p.numel() for p in tree_leaves(state.params))
    log(f"[10] {cfg.name}: {n} parameters (f32 master + AdamW moments "
        f"{(torch.cuda.memory_allocated() - base) / 1e9:.2f} GB), init "
        f"{time.perf_counter() - t0:.1f} s; {TRAIN_BATCH} x {TRAIN_SEQ} tokens a step, "
        f"{cfg.dtype} forward, remat {cfg.remat}, accum 1, schedule of {TRAIN_TOTAL_STEPS} "
        f"steps (lr 0 at step 0, > 0 from step 1)")
    step = trainer.make_train_step(cfg, TRAIN_TOTAL_STEPS)
    batches = [_train_batch(torch, cfg.vocab_size, TRAIN_BATCH, TRAIN_SEQ, SEED + i, dev)
               for i in range(TRAIN_WARMUP + TRAIN_TIMED + 1)]
    watched = {"final_norm/scale": state.params["final_norm"]["scale"],
               "embed/table": state.params["embed"]["table"],
               "layer 0 wq": state.params["segments"][0]["b0"]["mixer"]["wq"]["w"][0]}
    before = {k: v.clone() for k, v in watched.items()}
    mets, walls = [], []
    for i, batch in enumerate(batches[:-1]):
        torch.cuda.synchronize()
        t = time.perf_counter()
        state, m = step(state, batch)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t)
        mets.append(m)
        if i == 0:
            unmoved = [k for k, v in watched.items() if torch.equal(v, before[k])]
            if len(unmoved) != len(watched):
                raise AssertionError("a step at lr 0 moved a parameter")
        if i == 1:
            moved = [k for k, v in watched.items() if not torch.equal(v, before[k])]
            if not moved:
                raise AssertionError("no watched parameter moved after a step at lr > 0")
    timed = walls[TRAIN_WARMUP:]
    wall = statistics.median(timed)
    # one more step with CUDA's sync debug mode on: the step must not wait
    # for the device (and the mode must catch the sync of an .item())
    if not _syncs(torch, lambda: torch.ones((), device=dev).item()):
        raise AssertionError("CUDA's sync debug mode caught no sync in .item()")
    syncs = _syncs(torch, lambda: step(state, batches[-2]))
    if syncs:
        raise AssertionError(f"{len(syncs)} host syncs in a step, the first: {syncs[0]}")
    busy = _device_time(torch, lambda: step(state, batches[-1]), wall, "10", "step", top=14)
    peak = torch.cuda.max_memory_allocated()
    vals = {k: torch.stack([m[k] for m in mets]).tolist() for k in mets[0]}
    for k in ("loss", "nll", "grad_norm"):
        if not all(math.isfinite(v) for v in vals[k]):
            raise AssertionError(f"non-finite {k}: {vals[k]}")
    if abs(vals["loss"][0] - math.log(cfg.vocab_size)) > 1.5:
        raise AssertionError(f"first loss {vals['loss'][0]} not within ln(V) +- 1.5")
    if vals["lr"][0] != 0.0 or not all(v > 0 for v in vals["lr"][1:]):
        raise AssertionError(f"lr {vals['lr']}")
    tokens = TRAIN_BATCH * TRAIN_SEQ
    model_flops, exec_flops = _train_flops(cfg, n, TRAIN_BATCH, TRAIN_SEQ)
    log(f"[10] losses {[round(v, 4) for v in vals['loss']]}; nll {[round(v, 4) for v in vals['nll']]}; "
        f"grad_norm {[round(v, 4) for v in vals['grad_norm']]}; lr {vals['lr']}; moved after "
        f"step 1: {moved}")
    log(f"[10] step wall (synchronized, host clock) over {TRAIN_TIMED} steps: median "
        f"{wall * 1e3:.1f} ms (min {min(timed) * 1e3:.1f}, max {max(timed) * 1e3:.1f}); "
        f"warm-up steps {[round(w * 1e3, 1) for w in walls[:TRAIN_WARMUP]]} ms; "
        f"{tokens / wall:.0f} tokens/s; peak memory {(peak - base) / 1e9:.2f} GB over the "
        f"{base / 1e9:.2f} GB held before the phase (max_memory_allocated {peak / 1e9:.2f} GB)")
    log(f"[10] model FLOPs a step = {_flops_formula(cfg, n, TRAIN_BATCH, TRAIN_SEQ)} "
        f"= {model_flops / 1e12:.2f} TFLOP ({exec_flops / 1e12:.2f} with remat's "
        f"second forward): {model_flops / wall / 1e12:.1f} TFLOP/s, "
        f"{100 * model_flops / wall / 989e12:.1f}% of the bf16 dense peak 989 TFLOP/s "
        f"(card: {smi})")
    return {"ms_per_step": wall * 1e3, "ms_steps": [w * 1e3 for w in timed],
            "tokens_per_s": tokens / wall, "peak_gb": (peak - base) / 1e9,
            "model_tflop": model_flops / 1e12,
            "tflop_per_s": model_flops / wall / 1e12, "device_busy": busy / wall,
            "losses": vals["loss"], "card": smi}


def _act_quant_decisions(torch, record: list, replay=None):
    """Context: every act-quant site of the port's forward appends (x *
    gamma, the elements holding max |x|) to ``record``; with ``replay``
    (another run's record), each site takes its codes and AbsMax elements
    from it instead and computes the rest as the port does (the STE, the
    clip, gamma from the mean of the chosen maxima)."""
    import contextlib

    from repro_torch.core import quantization as q

    @contextlib.contextmanager
    def ctx():
        orig = q.quantize_activations_int8
        it = iter(replay or ())

        def tapped(x):
            xf = x.detach().float()
            a = xf.abs()
            record.append(((xf * q.act_scale_int8(xf)).cpu(), (a == a.amax(-1, keepdim=True)).cpu()))
            if replay is None:
                return orig(x)
            v, ties = next(it)
            xf = x if x.dtype == torch.float64 else x.float()  # f64: phase_train_cut's judge
            mask = ties.to(x.device)
            amax = (torch.where(xf >= 0, xf, -xf) * mask).sum(-1, keepdim=True) / mask.sum(
                -1, keepdim=True)
            gamma = q.fdiv(q.INT8_QMAX, amax + q.EPS)
            codes = torch.round(v).to(x.device, xf.dtype)
            qq = q.clip(q.ste(xf * gamma, codes), -q.INT8_QMAX, q.INT8_QMAX)
            return (qq / gamma).to(x.dtype), gamma

        q.quantize_activations_int8 = tapped
        try:
            yield
        finally:
            q.quantize_activations_int8 = orig

    return ctx()


def _flips(rec_a, rec_b) -> dict:
    """Two runs' records compared site by site: primary flips, differing
    codes, all codes, and the tokens that met a differing code.  A site
    has one row a token, or (routed experts) is an (N, C, D) expert buffer
    with more rows than tokens, each row one token or a sentinel of
    zeros."""
    primary = differ = codes = buffer_rows = 0
    touched = None
    for (va, ta), (vb, tb) in zip(rec_a, rec_b, strict=True):
        near = (va - vb).abs() <= TIE_NOISE
        code = va.round().clamp(-127, 127) != vb.round().clamp(-127, 127)
        codes += code.numel()
        differ += int(code.sum())
        primary += int((code & near).sum()) + int(((ta != tb).any(-1) & near.all(-1)).sum())
        rows = code.reshape(-1, code.shape[-1]).any(-1)
        if touched is not None and rows.numel() != touched.numel():
            buffer_rows += int(rows.sum())
            continue
        touched = rows if touched is None else touched | rows
    return {"primary": primary, "differ": differ, "codes": codes,
            "tokens": min(touched.numel(), int(touched.sum()) + buffer_rows),
            "of": touched.numel()}


def _loss_grads(torch, params, batch, cfg, record, replay=None, choice_replay=None):
    """(loss, gradients, the routers' choices on the host); ``replay`` and
    ``choice_replay`` impose another run's act-quant and routing
    decisions."""
    from repro_torch.models import api
    from repro_torch.optim.adamw import tree_leaves, tree_map

    with _act_quant_decisions(torch, record, replay), _ExpertChoices(choice_replay) as routed:
        leaves = tree_map(lambda p: p.detach().clone().requires_grad_(), params)
        loss, metrics = api.loss_fn(leaves, batch, cfg)
        grads = torch.autograd.grad(loss, tree_leaves(leaves), materialize_grads=True)
    return loss.item(), grads, routed.host()


def phase_train_cut(torch, n_experts: int = 1, tag: str = "10", cfg=None,
                    init_on_card: bool = False, f32_noise: bool = False):
    """[10] card vs CPU: one loss_fn with gradients of a 2-layer cut of
    pquant-1.3b (with ``n_experts`` experts) in f32 (remat off) at
    TRAIN_CUT_BATCH x TRAIN_CUT_SEQ tokens, by the CPU tests' rule.  With
    routed experts the CPU's router choices are replayed on the card with
    its act-quant decisions; the choices that differ as computed are
    counted, their tokens join the loss's flip allowance, and the
    gradients as computed are held only where none differs; the AbsMax
    element of each expert's 8-bit slice is held to AMAX_TOL (its comment
    says why), every other element to GRAD_RTOL.  ``cfg`` gives the cut
    itself (phase 13: deepseek-moe-16b's dense layer and one MoE layer,
    whose top-6 router and shared 8-bit branch take the same two rules, and
    whose unstacked layers' 0-d leaves AMAX_TOL: its comment says why).  The
    first leaf that misses its rule fails the phase.  Only with
    ``f32_noise`` (phase 14's cut at gemma3-27b's widths, where one
    device's own f32 noise reaches those rules) does an 8-bit slice's
    AbsMax element, routed or not, take the larger of its rule and its f32
    summation bound, and is another leaf that misses judged against an f64
    run on the card (``F32_UNIT``'s comment).  ``init_on_card`` draws the
    latents on the card and copies them to the CPU (phase 14: gemma3-27b's
    262144 x 5376 embedding, slow to draw on the CPU)."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models import api
    from repro_torch.optim.adamw import tree_map, tree_paths

    if cfg is None:
        cfg = dataclasses.replace(get_config("pquant-1.3b", n_experts=n_experts),
                                  n_layers=TRAIN_CUT_LAYERS, dtype="float32", remat=False)
    routed_cfg = cfg.moe or cfg.quant.num_experts > 1
    cpu, dev = torch.device("cpu"), torch.device("cuda")
    if init_on_card:
        params = _tree(lambda t: t.cpu(), api.init_model(SEED, cfg, device=dev))
        torch.cuda.empty_cache()
    else:
        params = api.init_model(SEED, cfg, device=cpu)
    batch = _train_batch(torch, cfg.vocab_size, TRAIN_CUT_BATCH, TRAIN_CUT_SEQ, SEED, cpu)
    t0 = time.perf_counter()
    rec_cpu, rec_card, rec_replay = [], [], []
    loss_cpu, g_cpu, ch_cpu = _loss_grads(torch, params, batch, cfg, rec_cpu)
    t_cpu = time.perf_counter() - t0
    card = tree_map(lambda t: t.to(dev), params)
    card_batch = {k: v.to(dev) for k, v in batch.items()}
    loss_card, g_card, ch_card = _loss_grads(torch, card, card_batch, cfg, rec_card)
    loss_rep, g_rep, _ = _loss_grads(torch, card, card_batch, cfg, rec_replay, replay=rec_cpu,
                                     choice_replay=ch_cpu)
    f = _flips(rec_cpu, rec_card)
    moved = sum(int((a != b).sum()) for a, b in zip(ch_card, ch_cpu, strict=True))
    tol = TRAIN_ATOL + 2 * TRAIN_ATOL_FLIP * min(f["of"], f["tokens"] + moved) / f["of"]
    if (f["primary"] > FLIP_RATE * f["codes"] or abs(loss_card - loss_cpu) > tol
            or abs(loss_rep - loss_cpu) > TRAIN_ATOL):
        raise AssertionError(f"card vs CPU: loss {loss_card} / {loss_cpu} (replayed {loss_rep}), "
                             f"flips {f}, router choices moved {moved}")
    worst, worst_amax, worst_of_rule, misses = (0.0, ""), 0.0, 0.0, []
    exact = f["primary"] == 0 and moved == 0
    runs = {"replayed": g_rep, **({"as computed": g_card} if exact else {})}

    def miss(run, i, name, err, bound, what):
        if not f32_noise:
            raise AssertionError(f"card vs CPU ({run}): {what}{name} off by {err} (rule {bound})")
        misses.append((run, i, name, err, bound))

    for run, grads in runs.items():
        for i, ((path, w), a, b) in enumerate(zip(tree_paths(params), grads, g_cpu, strict=True)):
            name = "/".join(map(str, path))
            scale = b.abs().max().item()
            diff = (a.cpu() - b).abs()
            if w.ndim == 0:
                worst_amax = max(worst_amax, diff.item() / max(scale, 1e-30))
                if diff.item() > AMAX_TOL * scale + 1e-12:
                    miss(run, i, name, diff.item(), AMAX_TOL * scale, "the 0-d leaf ")
                continue
            if (routed_cfg or f32_noise) and str(path[-1]).startswith("w8"):
                red = (w.ndim - 2, w.ndim - 1)
                amax = w.abs() == w.abs().amax(dim=red, keepdim=True)
                rule = torch.full_like(w, (AMAX_TOL if routed_cfg else GRAD_RTOL) * scale)
                noise = _amax_sum_noise(w, b, amax) if f32_noise else torch.zeros_like(w)
                rule = torch.maximum(rule, noise)
                worst_amax = max(worst_amax, diff[amax].max().item() / max(scale, 1e-30))
                worst_of_rule = max(worst_of_rule, (diff / rule)[amax].max().item())
                if (diff > rule + 1e-12)[amax].any():
                    raise AssertionError(f"card vs CPU ({run}): an AbsMax element of {name} off "
                                         f"by {diff[amax].max().item()} (largest {scale}"
                                         + (f", f32 summation bound {noise.max().item()}"
                                            if f32_noise else "") + ")")
                diff = diff[~amax]
            err = diff.max().item()
            if err > GRAD_RTOL * scale + 1e-12:
                miss(run, i, name, err, GRAD_RTOL * scale, "")
            worst = max(worst, (err / max(scale, 1e-30), name))
    judged = ""
    if misses:
        held = {(run, i): runs[run][i].cpu() for run, i, *_ in misses}
        del card, g_card, g_rep, runs
        judged = _f64_judge(torch, params, card_batch, cfg, rec_cpu, ch_cpu, misses, held, g_cpu)
    routed = (f"; router choices differing card vs CPU: {moved} of "
              f"{sum(c.numel() for c in ch_cpu)}" if ch_cpu else "")
    if routed_cfg or f32_noise:
        routed += (f"; the 8-bit slices' AbsMax elements and the 0-d leaves within "
                   f"{worst_amax:.2e} of each leaf's largest (rule "
                   f"{AMAX_TOL if routed_cfg else GRAD_RTOL}, 0-d {AMAX_TOL}; the AbsMax elements "
                   f"at most {worst_of_rule:.3f} of their rule"
                   + (" or f32 summation bound)" if f32_noise else ")"))
    log(f"[{tag}] card vs CPU, {cfg.n_layers} layers in f32, {TRAIN_CUT_BATCH} x {TRAIN_CUT_SEQ} "
        f"tokens: loss {loss_card:.7f} / {loss_cpu:.7f} (replayed {loss_rep:.7f}; CPU "
        f"{t_cpu:.1f} s); {f['primary']} primary act-quant flips, {f['differ']} codes differ of "
        f"{f['codes']}, {f['tokens']} of {f['of']} tokens met one{routed}; gradients within "
        f"{worst[0]:.2e} of each leaf's largest (worst {worst[1]}; rule {GRAD_RTOL})"
        + (f"; {len(misses)} leaf checks missed the rules and were judged against f64: "
           f"{judged}" if misses else ""))
    return {"primary_flips": f["primary"], "router_choices_differing": moved,
            "grad_worst_rel": worst[0], "grad_worst_rel_absmax": worst_amax,
            "absmax_worst_of_rule": worst_of_rule, "judged_against_f64": len(misses)}


def _amax_sum_noise(w, g, amax):
    """The f32 summation bound of each 8-bit slice's AbsMax element
    (``F32_UNIT``'s comment): 2 log2(n) u sum_i |g_i| |w_i gamma -
    round(w_i gamma)| / 127 over the slice's other elements, in f64 on the
    CPU, broadcast to ``w``'s shape.  ``g``: the CPU's gradient of ``w``;
    ``amax``: the slice's AbsMax elements."""
    import torch

    red = (w.ndim - 2, w.ndim - 1)
    wd = w.double()
    gamma = 127.0 / (wd.abs().amax(dim=red, keepdim=True) + 1e-5)
    terms = g.double().abs() * (wd * gamma - torch.round(wd * gamma)).abs() / 127.0
    total = torch.where(amax, 0.0, terms).sum(dim=red, keepdim=True)
    n = w.shape[-2] * w.shape[-1]
    return (2 * math.log2(n) * F32_UNIT * total).float().expand_as(w)


def _f64_judge(torch, params, batch, cfg, rec_cpu, ch_cpu, misses, held, g_cpu) -> str:
    """The leaves that missed phase_train_cut's rules, judged as
    ``F32_UNIT``'s comment says: one f64 ``loss_fn`` with gradients on the
    card with the CPU's act-quant and routing decisions replayed; each
    missed leaf's card gradient (``held``, by (run, index)) at most
    F64_JUDGE times as far from it (max |.|) as the CPU's.  Raises
    otherwise; returns what it judged, as text."""
    from repro_torch.models import api
    from repro_torch.optim.adamw import tree_leaves, tree_map

    dev = torch.device("cuda")
    gc.collect()
    torch.cuda.empty_cache()
    with _act_quant_decisions(torch, [], rec_cpu), _ExpertChoices(ch_cpu):
        leaves = tree_map(lambda p: p.detach().to(dev, torch.float64).requires_grad_(), params)
        loss, _ = api.loss_fn(leaves, batch, cfg)
        ref = torch.autograd.grad(loss, tree_leaves(leaves), materialize_grads=True)
    del leaves
    lines = []
    for run, i, name, err, bound in misses:
        e_card = (held[(run, i)].to(dev, torch.float64) - ref[i]).abs().max().item()
        e_cpu = (g_cpu[i].to(dev, torch.float64) - ref[i]).abs().max().item()
        line = (f"{name} ({run}): card - cpu {err:.3g} against the rule's {bound:.3g}; from "
                f"f64 the card {e_card:.3g}, the CPU {e_cpu:.3g}")
        if e_card > F64_JUDGE * e_cpu:
            raise AssertionError(f"card vs CPU: {line}: the card is more than {F64_JUDGE}x "
                                 "the CPU's distance from f64")
        lines.append(line)
    del ref
    torch.cuda.empty_cache()
    return "; ".join(lines)


# ---------------------------------------------------------------------------
# Phase 11: the training loop around the step
# ---------------------------------------------------------------------------

# probes off / on: warm-up steps, then timed steps (the Trainer's own
# step_time_s: the step and its one metrics transfer), then one profiled
LOOP_WARMUP, LOOP_TIMED = 2, 5
# the lifecycle run: LOOP_STEPS steps, a checkpoint and a snapshot every
# LOOP_EVERY, a non-finite loss at step LOOP_POISON (after the checkpoint
# of step LOOP_EVERY: the recovery restores optimizer step LOOP_EVERY + 1),
# then a second Trainer resumes from the last checkpoint for the rest
LOOP_STEPS, LOOP_EVERY, LOOP_POISON = 8, 4, 6
# the lifecycle run and the resume take 2 of the 24 layers (checkpoints of
# about 2.4 GB, not 15.2), so that the whole run keeps room for [13] and [14]
LOOP_LIFECYCLE_LAYERS = 2


def _host_memory() -> str:
    info = dict(line.split(":", 1) for line in Path("/proc/meminfo").read_text().splitlines())
    return (f"MemAvailable {int(info['MemAvailable'].split()[0]) / 1e6:.1f} GB of "
            f"{int(info['MemTotal'].split()[0]) / 1e6:.1f} GB")


class _CheckpointIO:
    """While active, times every ``Checkpointer.save`` (the host snapshot,
    then the write, waited for at once) and ``restore``, in ``records``."""

    def __init__(self, torch):
        self.torch = torch
        self.records = []

    def __enter__(self):
        from repro_torch.checkpoint.checkpointer import Checkpointer

        self._cls, self._save, self._restore = Checkpointer, Checkpointer.save, Checkpointer.restore
        io = self

        def save(ck, step, tree, blocking=False):
            t0 = time.perf_counter()
            io._save(ck, step, tree, blocking)
            t1 = time.perf_counter()
            ck.wait()
            nbytes = sum(t.numel() * t.element_size()
                         for t in _leaves([tree["params"], tree["opt"]._asdict()]))
            io.records.append({"op": "save", "step": step, "snapshot_s": t1 - t0,
                               "write_s": time.perf_counter() - t1, "bytes": nbytes})

        def restore(ck, tree, step=None):
            ck.wait()
            t0 = time.perf_counter()
            out = io._restore(ck, tree, step)
            io.torch.cuda.synchronize()
            io.records.append({"op": "restore", "step": step if step is not None else
                               ck.latest_step(), "s": time.perf_counter() - t0})
            return out

        Checkpointer.save, Checkpointer.restore = save, restore
        return self

    def __exit__(self, *exc):
        self._cls.save, self._cls.restore = self._save, self._restore


def _state_leaves(state) -> list:
    return list(_leaves(state.params)) + list(_leaves(state.opt.mu)) + \
        list(_leaves(state.opt.nu)) + [state.opt.step]


def _finite_record(rec: dict) -> bool:
    return all(math.isfinite(v) for k, v in rec.items()
               if k in ("loss", "nll", "grad_norm") or k.startswith(("qat_", "demo_")))


def phase_trainer(torch, smi: str) -> dict:
    """[11] the Trainer at full width (pquant-1.3b, bf16 forward, remat on)
    on TRAIN_BATCH x TRAIN_SEQ tokens a step from the port's data pipeline:
    step time with probes off and on, a lifecycle run (checkpoints, the
    snapshot, a forced recovery, history, trace, heartbeat), then a resume;
    every check raises."""
    import os
    import shutil
    import tempfile

    from repro_torch.configs.registry import get_config
    from repro_torch.data.pipeline import DataConfig, PrefetchIterator, SyntheticSource
    from repro_torch.kernels import _cuda
    from repro_torch.train.trainer import Trainer, TrainerConfig

    cfg = get_config("pquant-1.3b")
    dev = torch.device("cuda")
    gc.collect()
    torch.cuda.empty_cache()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_trainer_")
    iters = []

    def data(n):
        it = PrefetchIterator(SyntheticSource(cfg.vocab_size, seed=SEED),
                              DataConfig(seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH, seed=SEED))
        iters.append(it)
        return itertools.islice(it, n)

    def tcfg(**kw):
        base = dict(total_steps=TRAIN_TOTAL_STEPS, log_every=10**9, seed=SEED,
                    heartbeat_path=None)
        return TrainerConfig(**dict(base, **kw))

    try:
        du = shutil.disk_usage(tmp)
        log(f"[11] {tmp}: disk free {du.free / 1e9:.1f} GB of {du.total / 1e9:.1f} GB; host "
            f"{_host_memory()}; device memory held {torch.cuda.memory_allocated() / 1e9:.2f} GB")
        _cuda.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        summary = {"card": smi}

        # (a) probes off, then on: step time, one sync a step, busy share
        for on in (False, True):
            tag = "on" if on else "off"
            tr = Trainer(cfg, tcfg(probes=on), data(LOOP_WARMUP + LOOP_TIMED), device=dev)
            syncs = _syncs(torch, tr.run)
            if len(syncs) != len(tr.history) or len(tr.history) != LOOP_WARMUP + LOOP_TIMED:
                raise AssertionError(f"probes {tag}: {len(syncs)} host syncs in "
                                     f"{len(tr.history)} steps: {sorted(set(syncs))}")
            if not all(_finite_record(r) for r in tr.history):
                raise AssertionError(f"probes {tag}: a non-finite value: {tr.history}")
            walls = [r["step_time_s"] for r in tr.history]
            wall = statistics.median(walls[LOOP_WARMUP:])
            tr.data = data(LOOP_WARMUP + LOOP_TIMED + 1)
            tr.start_step = LOOP_WARMUP + LOOP_TIMED  # one more step, profiled
            busy = _device_time(torch, tr.run, wall, "11", f"Trainer step, probes {tag}",
                                top=8 if not on else 16)
            last = tr.history[-2]
            log(f"[11] probes {tag}: step (Trainer's step_time_s, ended by its one metrics "
                f"transfer) median {wall * 1e3:.1f} ms over {LOOP_TIMED} steps (min "
                f"{min(walls[LOOP_WARMUP:]) * 1e3:.1f}, max {max(walls[LOOP_WARMUP:]) * 1e3:.1f}; "
                f"warm-up {[round(w * 1e3, 1) for w in walls[:LOOP_WARMUP]]}); one host sync a "
                f"step; losses {[round(r['loss'], 4) for r in tr.history[:-1]]}"
                + (f"; probes at step {last['step']}: " + json.dumps(
                    {k: round(v, 6) for k, v in last.items() if k.startswith("qat_")})
                   if on else ""))
            summary[f"ms_per_step_probes_{tag}"] = wall * 1e3
            summary[f"ms_steps_probes_{tag}"] = [w * 1e3 for w in walls[LOOP_WARMUP:]]
            summary[f"device_busy_probes_{tag}"] = busy / wall
            del tr
            gc.collect()
        on, off = summary["ms_per_step_probes_on"], summary["ms_per_step_probes_off"]
        summary["probes_share"] = (on - off) / on
        log(f"[11] probes' share of a step: ({on:.1f} - {off:.1f}) / {on:.1f} = "
            f"{100 * summary['probes_share']:.2f}% (card: {smi})")

        # (b) the lifecycle run: checkpoints, snapshots, history, trace,
        # heartbeat, a forced recovery; one sync a step that is neither a
        # checkpoint's, a snapshot's nor the recovery's
        paths = {k: os.path.join(tmp, k) for k in ("history.jsonl", "trace.jsonl", "heartbeat")}
        ck_dir = os.path.join(tmp, "ckpt")
        cfg = dataclasses.replace(cfg, n_layers=LOOP_LIFECYCLE_LAYERS)
        with _CheckpointIO(torch) as io:
            a = Trainer(cfg, tcfg(probes=True, log_every=1, ckpt_every=LOOP_EVERY, ckpt_dir=ck_dir,
                                  sensitivity_every=LOOP_EVERY,
                                  history_path=paths["history.jsonl"],
                                  trace_path=paths["trace.jsonl"],
                                  heartbeat_path=paths["heartbeat"]),
                        data(LOOP_STEPS), device=dev)
            a.ckpt.keep = 1
            orig, marks = a.step_fn, []

            def poisoned(state, batch):
                marks.append(len(caught))
                state, m = orig(state, batch)
                if len(marks) == LOOP_POISON + 1:  # a step that wrote non-finite values
                    state.params["final_norm"]["scale"].fill_(float("nan"))
                    m = dict(m, loss=torch.full((), float("nan"), device=dev))
                return state, m

            a.step_fn = poisoned
            t0 = time.perf_counter()
            with _sync_log(torch) as caught:
                a.run()
            t_run = time.perf_counter() - t0
            marks.append(len(caught))
            per_step = [len(_sync_msgs(caught[i:j])) for i, j in zip(marks, marks[1:])]
            plain = [s for s in range(LOOP_STEPS)
                     if s % LOOP_EVERY and s not in (LOOP_POISON, LOOP_STEPS - 1)]
            if any(per_step[s] != 1 for s in plain):
                raise AssertionError(f"host syncs by step {per_step}; steps {plain} must have one")
            recs = [json.loads(line) for line in Path(paths["history.jsonl"]).read_text().splitlines()]
            steps = [r["step"] for r in recs if "event" not in r]
            recovery = [r for r in recs if r.get("event") == "recovery"]
            want_steps = [s for s in range(LOOP_STEPS) if s != LOOP_POISON]
            if steps != want_steps or len(recovery) != 1:
                raise AssertionError(f"history steps {steps}, recoveries {recovery}")
            if recovery[0]["from_step"] != LOOP_EVERY + 1 or a.recoveries != 1:
                raise AssertionError(f"recovery {recovery[0]}: from_step must be {LOOP_EVERY + 1}")
            bad = [r["step"] for r in recs if "event" not in r and not _finite_record(r)]
            demo = [r["step"] for r in recs if "demo_score_ffn1" in r]
            if bad or demo != [0, LOOP_EVERY]:
                raise AssertionError(f"non-finite records at steps {bad}; snapshots at {demo}")
            if not all(torch.isfinite(t).all() for t in _leaves(a.state.params)):
                raise AssertionError("the recovery left a non-finite master weight")
            events = [json.loads(line) for line in Path(paths["trace.jsonl"]).read_text().splitlines()]
            kinds = [e["event"] for e in events]
            final = LOOP_EVERY + 1 + (LOOP_STEPS - 1 - LOOP_POISON)
            for kind, n in (("run_start", 1), ("step", len(want_steps)), ("checkpoint", 2),
                            ("restore", 1), ("recovery", 1), ("run_end", 1)):
                if kinds.count(kind) != n:
                    raise AssertionError(f"trace: {kinds.count(kind)} {kind} events, want {n}")
            heartbeat = Path(paths["heartbeat"]).read_text()
            if heartbeat != str(LOOP_STEPS - 1) or a.ckpt.all_steps() != [final]:
                raise AssertionError(f"heartbeat {heartbeat!r}, checkpoints {a.ckpt.all_steps()}")
            snap = next(r for r in recs if r.get("step") == LOOP_EVERY and "event" not in r)
            log(f"[11] lifecycle: {LOOP_STEPS} steps in {t_run:.1f} s (saves waited for); "
                f"history steps {steps}, recovery at step {recovery[0]['step']} from step "
                f"{recovery[0]['from_step']}; snapshots at steps {demo}, step {LOOP_EVERY}'s: "
                + json.dumps({k: round(v, 4) for k, v in snap.items() if k.startswith("demo_")})
                + f"; trace {len(events)} events ({', '.join(sorted(set(kinds)))}); host syncs "
                f"by step {per_step}; heartbeat {heartbeat!r}; checkpoints {a.ckpt.all_steps()}")
            saved = [t.detach().cpu() for t in _state_leaves(a.state)]
            del a, orig, poisoned
            gc.collect()

            # (c) resume: a second Trainer (another init seed) from the last
            # checkpoint; every leaf as saved, bit for bit; then the rest
            b = Trainer(cfg, tcfg(probes=True, ckpt_every=LOOP_EVERY, ckpt_dir=ck_dir,
                                  seed=SEED + 1), data(LOOP_STEPS), device=dev)
            b.ckpt = None  # restored; no more saves (the first Trainer's were timed)
            leaves = _state_leaves(b.state)
            differ = [i for i, (x, y) in enumerate(zip(leaves, saved))
                      if x.dtype != y.dtype or not torch.equal(x.cpu(), y)]
            if len(leaves) != len(saved) or differ or b.start_step != final:
                raise AssertionError(f"resume: start_step {b.start_step} (want {final}); "
                                     f"{len(differ)} leaves differ from the saved state")
            del saved, leaves
            hist = b.run()
            if [r["step"] for r in hist] != list(range(final, LOOP_STEPS)) or \
                    not all(_finite_record(r) for r in hist):
                raise AssertionError(f"resumed run: {hist}")
        peak = torch.cuda.max_memory_allocated()
        launched = {k: v for k, v in _cuda.LAUNCHES.items() if v}
        if launched:
            raise AssertionError(f"the training loop launched kernels: {launched}")
        saves = [r for r in io.records if r["op"] == "save"]
        restores = [r for r in io.records if r["op"] == "restore"]
        log(f"[11] resume: start_step {final}, every one of {len(_state_leaves(b.state))} "
            f"leaves (params, mu, nu, step) equal to the saved state, bit for bit; then steps "
            f"{[r['step'] for r in hist]}, losses {[round(r['loss'], 4) for r in hist]}")
        for r in saves:
            log(f"[11] save of step {r['step']}: {r['bytes'] / 1e9:.2f} GB, host snapshot "
                f"{r['snapshot_s']:.2f} s ({r['bytes'] / r['snapshot_s'] / 1e9:.2f} GB/s), then "
                f"write {r['write_s']:.2f} s ({r['bytes'] / r['write_s'] / 1e9:.2f} GB/s)")
        for r in restores:
            log(f"[11] restore of step {r['step']}: {r['s']:.2f} s "
                f"({saves[0]['bytes'] / r['s'] / 1e9:.2f} GB/s)")
        log(f"[11] peak memory {(peak - base) / 1e9:.2f} GB over the {base / 1e9:.2f} GB held "
            f"before the phase (max_memory_allocated {peak / 1e9:.2f} GB); no kernel launched "
            f"(card: {smi})")
        del b
        summary.update({
            "save_snapshot_s": [r["snapshot_s"] for r in saves],
            "save_write_s": [r["write_s"] for r in saves], "save_bytes": saves[0]["bytes"],
            "restore_s": [r["s"] for r in restores], "peak_gb": (peak - base) / 1e9,
            "recovery_from_step": LOOP_EVERY + 1, "host_syncs_by_step": per_step,
        })
        return summary
    finally:
        for it in iters:
            it.close()
        shutil.rmtree(tmp, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# Phase 12: pQuant's routed 8-bit experts (N > 1, paper §3.3)
# ---------------------------------------------------------------------------

EXPERTS = 8  # pquant-1.3b with N = 8, benchmarks/bench_memory.py's routed model
# [12] runs 2 of the 24 layers (every layer alike, stacked as at full
# depth, the launch counts per layer unchanged) so that the whole run keeps
# room for [13] and [14]
EXPERTS_LAYERS = 2
# (c): [8] (a)'s load, paged on the kernel route and dense: (name, layout,
# REPRO_PAGED_ATTN)
E_CB_CONFIGS = (("kernel", "paged", "auto"), ("dense", "dense", "auto"))


def _experts_model(torch):
    """pquant-1.3b with EXPERTS routed experts, from ``SEED``, exported
    packed: (cfg, params, export bytes)."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models import api
    from repro_torch.train.quantized_serving import quantize_params_for_serving

    cfg = dataclasses.replace(get_config("pquant-1.3b", n_experts=EXPERTS),
                              n_layers=EXPERTS_LAYERS)
    t0 = time.perf_counter()
    latent = api.init_model(SEED, cfg, device=torch.device("cuda"))
    params = quantize_params_for_serving(latent, cfg, packed=True)
    del latent
    torch.cuda.synchronize()
    nbytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    log(f"[12] {cfg.name} with {EXPERTS} experts: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"d_ff {cfg.d_ff}, r {cfg.quant.r}; init + packed export "
        f"{time.perf_counter() - t0:.1f} s; serving params {nbytes / 1e6:.1f} MB")
    return cfg, params, nbytes


def phase_experts_serving(torch, cfg, params) -> tuple[dict, dict]:
    """[12] (a)-(c): the routed export served at the decode tier, at the
    prefill tier and by the continuous batcher.  Returns ({kernel:
    launches summed over the three counted runs}, summary)."""
    from repro_torch.core import routing
    from repro_torch.models import api
    from repro_torch.serve.engine import DecodeEngine, SamplerConfig

    dev = torch.device("cuda")
    t_start = time.perf_counter()
    none = {"w1a8_gemv": 0, "decoupled_gemv": 0, "int8_matmul": 0, "w1a8_matmul": 0,
            "decoupled_matmul": 0}
    summary, total = {}, {}
    # (a) the decode tier: [4]'s load
    prompts = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT),
                            generator=torch.Generator().manual_seed(SEED))
    greedy = SamplerConfig(temperature=0.0, top_k=0, max_new_tokens=NEW_TOKENS)
    logits, caches = api.prefill(params, {"tokens": prompts.to(dev)}, cfg, PROMPT + NEW_TOKENS)
    step_logits, _ = api.decode_step(params, logits.argmax(-1)[:, None], caches, PROMPT, cfg)
    if not (torch.isfinite(logits).all() and torch.isfinite(step_logits).all()):
        raise AssertionError("non-finite logits")
    del logits, caches, step_logits
    eng = DecodeEngine(params, cfg, max_len=PROMPT + NEW_TOKENS, device=dev)
    # the counted run warms the engine for the timed ones
    stream, launches, _ = _counted_generate(
        torch, eng, prompts, greedy,
        *_layer_launches(cfg, dict(none, w1a8_gemv=7), greedy.max_new_tokens), "12")
    ttft, t_gen, line = _time_generate(eng, prompts, greedy, stream)
    log(f"[12] (a) decode tier, {BATCH} x {PROMPT} tokens, {NEW_TOKENS} new: {line}")
    busy = _device_trace_time(torch, lambda: eng.generate(prompts, greedy), t_gen, "12",
                              "generate")
    summary["decode"] = {"ttft_ms": ttft * 1e3,
                         "ms_per_step": (t_gen - ttft) / (NEW_TOKENS - 1) * 1e3,
                         "tokens_per_s": BATCH * (NEW_TOKENS - 1) / (t_gen - ttft),
                         "device_busy_share": busy / t_gen}
    total.update(launches)
    del eng
    log(f"[time] [12] (a) done at {time.perf_counter() - t_start:.1f} s")

    # (b) the prefill tier: [6]'s load (8192 prefill rows, capacity 1280)
    max_len = P_PROMPT + P_NEW_TOKENS
    prompts = torch.randint(0, cfg.vocab_size, (P_BATCH, P_PROMPT),
                            generator=torch.Generator().manual_seed(SEED + 2))
    greedy = SamplerConfig(temperature=0.0, top_k=0, max_new_tokens=P_NEW_TOKENS)
    with _Drops(torch) as drops:
        logits, _ = api.prefill(params, {"tokens": prompts.to(dev)}, cfg, max_len)
    dropped = int(drops.total.item())
    if not torch.isfinite(logits).all():
        raise AssertionError("non-finite logits")
    del logits
    eng = DecodeEngine(params, cfg, max_len=max_len, device=dev)
    stream, launches, _ = _counted_generate(
        torch, eng, prompts, greedy,
        *_layer_launches(cfg, dict(none, w1a8_matmul=7), greedy.max_new_tokens), "12")
    ttft, t_gen, line = _time_generate(eng, prompts, greedy, stream, P_TIMED_RUNS)
    log(f"[12] (b) prefill tier, {P_BATCH} x {P_PROMPT} tokens, {P_NEW_TOKENS} new: {line}")
    cap = routing.expert_capacity(P_BATCH * P_PROMPT, routing.RouterConfig(num_experts=EXPERTS))
    log(f"[12] (b) tokens dropped by capacity in the prefill: {dropped} over {drops.routers} "
        f"routers ({P_BATCH * P_PROMPT} tokens each, capacity {cap} an expert)")
    summary["prefill"] = {"ttft_ms": ttft * 1e3,
                          "ms_per_step": (t_gen - ttft) / (P_NEW_TOKENS - 1) * 1e3,
                          "tokens_per_s": P_BATCH * (P_NEW_TOKENS - 1) / (t_gen - ttft),
                          "dropped_tokens": dropped}
    for k, v in launches.items():
        total[k] = total.get(k, 0) + v
    del eng
    torch.cuda.empty_cache()
    log(f"[time] [12] (b) done at {time.perf_counter() - t_start:.1f} s")

    # (c) continuous batching on [8] (a)'s load
    streams = {}
    for name, layout, env in E_CB_CONFIGS:
        rec, st, reasons, _ = _cb_run(torch, params, cfg, name, layout, None, 1, env)
        rec.pop("step_walls")
        streams[name] = st
        if sorted(st) != list(range(CB_REQUESTS)) or set(reasons) != {"length"}:
            raise AssertionError(f"({name}): requests did not each finish once by length")
        if rec["free_blocks"] is not None and rec["free_blocks"] != rec["num_blocks"]:
            raise AssertionError(f"({name}): blocks left allocated after the run")
        pa = rec["launches"].get("paged_attention", 0)
        want = cfg.n_layers * rec["decode_steps"] if env == "auto" and layout == "paged" else 0
        if pa != want:
            raise AssertionError(f"({name}): paged_attention launched {pa} times, want {want}")
        log(f"[12] (c) {name}: wall {rec['wall_s']:.2f} s, {rec['tokens_per_s']:.1f} tokens/s, "
            f"TTFT p50 {rec['ttft_ms_p50']:.1f} / p99 {rec['ttft_ms_p99']:.1f} ms, "
            f"{rec['engine_steps']} engine steps, launches {rec['launches']}")
        summary[f"continuous_{name}"] = {k: rec[k] for k in (
            "wall_s", "tokens_per_s", "ttft_ms_p50", "ttft_ms_p99", "engine_steps", "launches")}
        if name == "kernel":
            for k, v in rec["launches"].items():
                total[k] = total.get(k, 0) + v
    load = _cb_load(cfg.vocab_size)
    equal = _compare_streams(torch, params, cfg, load, streams["dense"], streams["kernel"],
                             "(c) kernel route vs dense", tag="12")
    summary["continuous_kernel_vs_dense_equal"] = equal
    log(f"[time] [12] (c) done at {time.perf_counter() - t_start:.1f} s")
    return total, summary


def _train_cell(torch, smi: str, cfg, tag: str, part: str, batch: int, seq: int,
                n_timed: int, watch, active) -> dict:
    """``make_train_step`` on a model at full width (bf16 forward, remat) at
    ``batch`` x ``seq`` tokens: TRAIN_WARMUP warm-up steps, ``n_timed``
    timed, one profiled.  ``watch(params)`` gives ({name: a layer-stacked
    leaf of the first (routed) layer}, the names whose slice e is expert
    e's): step 0 (lr 0) moves none of them at that layer; step 1 moves
    every one, an expert's slice wherever that expert took a token in the
    step's forward.  ``active(n)`` gives (the parameters active a token,
    how they were counted).  Checks finite losses, the first within ln V
    +- 1.5, no host sync in a step and, on a routed model,
    ``qat_router_entropy`` in [0, 1] and aux > 0.  Returns the summary."""
    from repro_torch.models import api
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.train import trainer

    if cfg.dtype != "bfloat16" or not cfg.remat:
        raise AssertionError(f"{cfg.name}: dtype {cfg.dtype}, remat {cfg.remat}")
    routed = cfg.moe or cfg.quant.num_experts > 1
    dev = torch.device("cuda")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    state = trainer.init_train_state(SEED, cfg, device=dev)
    torch.cuda.synchronize()
    n = sum(p.numel() for p in tree_leaves(state.params))
    n_active, how = active(n)
    log(f"[{tag}] {part} {cfg.name}, {cfg.n_layers} layers: {n} parameters, {n_active} active "
        f"a token ({how}); master + AdamW moments {(torch.cuda.memory_allocated() - base) / 1e9:.2f} "
        f"GB, init {time.perf_counter() - t0:.1f} s; {batch} x {seq} tokens a step, "
        f"{cfg.dtype} forward, remat {cfg.remat}")
    step = trainer.make_train_step(cfg, TRAIN_TOTAL_STEPS)
    batches = [_train_batch(torch, cfg.vocab_size, batch, seq, SEED + i, dev)
               for i in range(TRAIN_WARMUP + n_timed + 1)]
    watched, per_expert = watch(state.params)
    before = {name: t[0].clone() for name, t in watched.items()}
    mets, walls = [], []
    for i, b in enumerate(batches[:-1]):
        torch.cuda.synchronize()
        t = time.perf_counter()
        with _ExpertChoices() if i == 1 else contextlib.nullcontext() as choices:
            state, m = step(state, b)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t)
        mets.append(m)
        if i == 0:
            moved = [name for name, t in watched.items() if not torch.equal(before[name], t[0])]
            if moved:
                raise AssertionError(f"a step at lr 0 moved {moved}")
        if i == 1:  # lr > 0; the choices of the step's forward (remat's rerun follows)
            used = sorted(set(choices.choices[0].flatten().tolist())) if routed else []
            still = [name for name in watched if name not in per_expert
                     and torch.equal(before[name], watched[name][0])]
            still += [(name, e) for e in used for name in per_expert
                      if torch.equal(before[name][e], watched[name][0][e])]
            if still:
                raise AssertionError(f"step 1 left {still} unmoved")
            log(f"[{tag}] {part} step 1 moved the first layer's {sorted(watched)}" + (
                f", each expert's slice of {list(per_expert)} for the {len(used)} experts that "
                "took tokens in the step's forward" if routed else ""))
    del before, watched
    timed = walls[TRAIN_WARMUP:]
    wall = statistics.median(timed)
    # as [10]: the mode must catch the sync of an .item() (its first use
    # also warns once that it is a prototype), then a step must not sync
    if not _syncs(torch, lambda: torch.ones((), device=dev).item()):
        raise AssertionError("CUDA's sync debug mode caught no sync in .item()")
    syncs = _syncs(torch, lambda: step(state, batches[-2]))
    if syncs:
        raise AssertionError(f"{len(syncs)} host syncs in a step, the first: {syncs[0]}")
    busy = _device_trace_time(torch, lambda: step(state, batches[-1]), wall, tag, "step",
                              top=14)
    peak = torch.cuda.max_memory_allocated()
    vals = {k: torch.stack([m[k] for m in mets]).tolist() for k in mets[0]}
    for k in ("loss", "nll", "grad_norm"):
        if not all(math.isfinite(v) for v in vals[k]):
            raise AssertionError(f"non-finite {k}: {vals[k]}")
    if abs(vals["loss"][0] - math.log(cfg.vocab_size)) > 1.5:
        raise AssertionError(f"first loss {vals['loss'][0]} not within ln(V) +- 1.5")
    aux = entropy = None
    if routed:
        with torch.no_grad():
            _, lm = api.loss_fn(trainer.cast_for_forward(state.params, torch.bfloat16),
                                batches[0], cfg)
        aux = lm["aux"].item()
        _, pm = trainer.make_train_step(cfg, TRAIN_TOTAL_STEPS, probes=True)(state, batches[0])
        entropy = pm["qat_router_entropy"].item()
        if not (math.isfinite(aux) and aux > 0 and math.isfinite(entropy) and 0 <= entropy <= 1):
            raise AssertionError(f"aux {aux}, qat_router_entropy {entropy}")
    tokens = batch * seq
    model_flops, _ = _train_flops(cfg, n_active, batch, seq)
    log(f"[{tag}] {part} losses {[round(v, 4) for v in vals['loss']]} (ln V "
        f"{math.log(cfg.vocab_size):.4f}); grad_norm {[round(v, 4) for v in vals['grad_norm']]}"
        + (f"; aux (after the steps) {aux:.6f}; qat_router_entropy {entropy:.6f}" if routed
           else ""))
    log(f"[{tag}] {part} step wall (synchronized, host clock) over {n_timed} steps: median "
        f"{wall * 1e3:.1f} ms (min {min(timed) * 1e3:.1f}, max {max(timed) * 1e3:.1f}); "
        f"{tokens / wall:.0f} tokens/s; no host sync in a step; peak memory "
        f"{(peak - base) / 1e9:.2f} GB over the {base / 1e9:.2f} GB held before "
        f"(max_memory_allocated {peak / 1e9:.2f} GB)")
    log(f"[{tag}] {part} model FLOPs a step = {_flops_formula(cfg, n_active, batch, seq)} "
        f"(the active parameters) = {model_flops / 1e12:.2f} TFLOP: "
        f"{model_flops / wall / 1e12:.1f} TFLOP/s, {100 * model_flops / wall / 989e12:.1f}% of "
        f"the bf16 dense peak 989 TFLOP/s (card: {smi})")
    del state, step, batches
    gc.collect()
    torch.cuda.empty_cache()
    return {"ms_per_step": wall * 1e3, "ms_steps": [w * 1e3 for w in timed],
            "tokens_per_s": tokens / wall, "peak_gb": (peak - base) / 1e9, "params": n,
            "active_params": n_active, "model_tflop": model_flops / 1e12,
            "tflop_per_s": model_flops / wall / 1e12, "device_busy": busy / wall,
            "losses": vals["loss"], "aux": aux, "router_entropy": entropy}


def phase_experts_train(torch, smi: str) -> dict:
    """[12] (e): ``make_train_step`` on the routed model at [10]'s shape."""
    from repro_torch.configs.base import param_count
    from repro_torch.configs.registry import get_config

    cfg = dataclasses.replace(get_config("pquant-1.3b", n_experts=EXPERTS),
                              n_layers=EXPERTS_LAYERS)
    n_8bit = param_count(cfg)["n_8bit"]

    def watch(params):
        ffn = params["segments"][0]["b0"]["ffn"]
        return ({"router": ffn["router"]["w"], "w8_up": ffn["w8_up"],
                 "w8_down": ffn["w8_down"]}, ("w8_up", "w8_down"))

    def active(n):
        return (n - n_8bit * (EXPERTS - 1) // EXPERTS,
                f"N - {EXPERTS - 1}/{EXPERTS} x n_8bit, n_8bit {n_8bit} from param_count")

    return _train_cell(torch, smi, cfg, "12", "(e)", TRAIN_BATCH, TRAIN_SEQ, TRAIN_TIMED,
                         watch, active)


def phase_experts(torch, smi: str) -> tuple[dict, dict]:
    """Phase 12: pquant-1.3b with EXPERTS routed 8-bit experts at full width
    (EXPERTS_LAYERS of its layers), served ((a)-(c)), cut to 2 layers on
    the card and the CPU ((d)), trained ((e)) and its gradients held card
    vs CPU ((f)).
    Returns ({kernel: launches of the counted runs}, summary)."""
    t0 = time.perf_counter()
    cfg, params, nbytes = _experts_model(torch)
    launches, summary = phase_experts_serving(torch, cfg, params)
    summary["export_bytes"] = nbytes
    prompts = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT),
                            generator=torch.Generator().manual_seed(SEED))
    phase_cut(torch, params, cfg, prompts, tag="12", decode_may_part=True)  # (d)
    log(f"[time] [12] (d) done at {time.perf_counter() - t0:.1f} s")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    summary["train"] = phase_experts_train(torch, smi)
    log(f"[time] [12] (e) done at {time.perf_counter() - t0:.1f} s")
    summary["train_cut"] = phase_train_cut(torch, n_experts=EXPERTS, tag="12")  # (f)
    summary["card"] = smi
    return launches, summary


# ---------------------------------------------------------------------------
# Phase 13: DeepSeek-MoE (models/moe.py)
# ---------------------------------------------------------------------------

MOE_ARCH = "deepseek-moe-16b"
# (a): the layer-by-layer export held to the one-shot export of the same
# latents on a cut of 1 dense + 2 MoE layers (the MoE segment stacked)
MOE_EXPORT_CHECK_LAYERS = 3
# (b) the decode tier; (b) and (c) timed over MOE_TIMED_RUNS runs (8 new
# and 2 runs, not 16 and 3: the whole run keeps room for [15])
MOE_BATCH, MOE_PROMPT, MOE_NEW = 4, 8, 8
MOE_P_BATCH, MOE_P_PROMPT, MOE_P_NEW = 16, 256, 8  # (c) the prefill tier: 4096 rows
MOE_TIMED_RUNS = 2
# (b)'s busy share: a generate of this many new tokens, profiled (a trace
# of the full generate's 87k launches takes the profiler about half a
# minute), against the wall of the same generate unprofiled
MOE_PROFILED_NEW = 4
# (d): 4 slots of 160 positions, 5 requests (4 at tick 0, then one: it
# waits for a slot), prompts of 16-128 tokens, 8-16 new; 5, not 8, so
# that the whole run keeps room for [14]
MOE_CB = CBLoad(4, 160, 5, 4, (16, 128), (8, 16))
# (d) on 1 dense + 3 MoE layers, not all 28: the whole run keeps room for [15]
MOE_CB_LAYERS = 4
MOE_CUT_LAYERS = 2  # (e) and (f)'s gradient cut: the dense layer and one MoE layer
# (f): 1 dense + 2 MoE (the MoE segment stacked); 3 layers and 2 timed
# steps, not 4 and 3: the whole run keeps room for [15]
MOE_TRAIN_LAYERS, MOE_TRAIN_BATCH, MOE_TRAIN_SEQ = 3, 2, 2048
MOE_TRAIN_TIMED = 2


MOE_KERNELS = ("w1a8_gemv", "decoupled_gemv", "int8_matmul", "w1a8_matmul", "decoupled_matmul")


def _forward_launches(cfg, tier: str) -> dict:
    """Kernel launches of one packed forward whose every linear sees
    ``tier``'s rows ("decode": at most 32, "prefill": more): each layer's
    q/k/v/o and its FFN's 1-bit down projection (the dense FFN's, or the
    shared experts') on the W1A8 kernel, its two up/gate pairs on the
    fused kernel and its 8-bit down projection on ``int8_matmul``; each
    MoE layer's experts (none in a dense config) one W1A8 call a slice and
    linear (upstream's ``_experts_apply_packed``)."""
    n_moe = cfg.n_layers - cfg.first_k_dense
    one, two = (("w1a8_gemv", "decoupled_gemv") if tier == "decode"
                else ("w1a8_matmul", "decoupled_matmul"))
    return dict({k: 0 for k in MOE_KERNELS},
                **{one: 5 * cfg.n_layers + (3 if cfg.glu else 2) * cfg.n_routed_experts * n_moe,
                   two: 2 * cfg.n_layers, "int8_matmul": cfg.n_layers})


def _add(a: dict, b: dict, times: int = 1) -> dict:
    out = dict(a)
    for k, v in b.items():
        out[k] = out.get(k, 0) + v * times
    return out


def _moe_cut(params, cfg, n: int):
    """(params, cfg) of the first ``n`` layers (n >= 2) of an exported MoE
    model with one dense layer: its MoE segment sliced on the layer axis,
    a segment of one repeat unstacked, as the export stores it."""
    k = n - cfg.first_k_dense
    seg = params["segments"][1]
    cut = dict(params)
    cut["segments"] = [params["segments"][0], _tree(lambda t: t[0].contiguous(), seg) if k == 1
                       else _tree(lambda t: t[:k], seg)]
    return cut, dataclasses.replace(cfg, n_layers=n)


def _stacked(make, n: int):
    """The trees ``make(0)`` .. ``make(n - 1)`` stacked leaf by leaf on a new
    leading axis, each copied into the stack and dropped before the next is
    made: the stack and one tree are held at once (two of deepseek-v2-236b's
    15.7 GB MoE blocks and their stack would not fit the card together)."""
    out = None
    for r in range(n):
        tree = make(r)
        if out is None:
            out = _tree(lambda t: t.new_empty((n,) + tuple(t.shape)), tree)
        _put(out, tree, r)
        del tree
    return out


def _put(dst, src, r: int) -> None:
    if isinstance(dst, dict):
        for k in dst:
            _put(dst[k], src[k], r)
    else:
        dst[r].copy_(src)


def _block_export(torch, cfg, one_shot: bool = False):
    """``cfg``'s packed serving export from SEED, made on the card one block
    at a time, over any segment plan: each block's latent params from a
    generator of its own, exported alone by ``quantize_params_for_serving``
    (whose scales do not depend on the stack a slice lies in), the exports
    of a segment's repeats stacked on the layer axis; the embedding, the
    final norm and the head (where untied) stay float.  With ``one_shot``
    the latent blocks are stacked first, from the same generators, and the
    whole latent tree exported at once: the reference the block-by-block
    export must equal (deepseek-moe-16b's 16.4e9, gemma3-27b's 28.0e9 and
    deepseek-v2-236b's 236e9 f32 latents fit on the card only as a cut)."""
    from repro_torch.models import transformer
    from repro_torch.models.layers import init_embedding, init_rmsnorm
    from repro_torch.train.quantized_serving import quantize_params_for_serving as export

    dev = torch.device("cuda")

    def gen(i):
        return torch.Generator(device=dev).manual_seed(SEED * 1000 + i)

    segs = []
    for seg in transformer.build_segments(cfg):
        def rep(r):  # the repeat's blocks, of absolute layers first + r * len + bi
            latent = {}
            for bi, spec in enumerate(seg.blocks):
                layer = seg.first_layer + r * len(seg.blocks) + bi
                latent[f"b{bi}"] = transformer._init_block(gen(1 + layer), spec, cfg, (), dev)
            return latent if one_shot else export(latent, cfg, packed=True)

        segs.append(rep(0) if seg.repeats == 1 else _stacked(rep, seg.repeats))
    tree = {"embed": init_embedding(gen(0), cfg.vocab_size, cfg.d_model, dev), "segments": segs,
            "final_norm": init_rmsnorm(cfg.d_model, (), dev)}
    if not cfg.tie_embeddings:
        tree["lm_head"] = init_embedding(gen(cfg.n_layers + 1), cfg.vocab_size, cfg.d_model, dev)
    return export(tree, cfg, packed=True) if one_shot else tree


def phase_moe_export(torch, cfg):
    """[13] (a): the export layer by layer, held leaf for leaf, exactly, to
    the one-shot export on a cut of MOE_EXPORT_CHECK_LAYERS layers; then
    the full model's.  Returns (params, bytes)."""
    t0 = time.perf_counter()
    cut = dataclasses.replace(cfg, n_layers=MOE_EXPORT_CHECK_LAYERS)
    a = dict(_tree_paths(_block_export(torch, cut)))
    b = dict(_tree_paths(_block_export(torch, cut, one_shot=True)))
    if list(a) != list(b):
        raise AssertionError(f"export trees differ: {sorted(set(a) ^ set(b))}")
    differ = [k for k in a if a[k].dtype != b[k].dtype or not torch.equal(a[k], b[k])]
    if differ:
        raise AssertionError(f"the layer-by-layer export differs from the one-shot export at "
                             f"{differ}")
    stacked = [k for k in a if k.startswith("/segments/1/") and a[k].ndim and
               a[k].shape[0] == MOE_EXPORT_CHECK_LAYERS - cfg.first_k_dense]
    log(f"[13] (a) {MOE_EXPORT_CHECK_LAYERS}-layer cut: the layer-by-layer export equals the "
        f"one-shot export of the same latents leaf for leaf, bit for bit ({len(a)} leaves, "
        f"{len(stacked)} of them stacked over its 2 MoE layers); {time.perf_counter() - t0:.1f} s")
    del a, b
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    params = _block_export(torch, cfg)
    torch.cuda.synchronize()
    leaves = dict(_tree_paths(params))
    nbytes = sum(t.numel() * t.element_size() for t in leaves.values())
    by_kind = {}
    for k, t in leaves.items():
        kind = ("packed 1-bit" if t.dtype == torch.uint8 else "int8" if t.dtype == torch.int8
                else "float")
        by_kind[kind] = by_kind.get(kind, 0) + t.numel() * t.element_size()
    log(f"[13] (a) {cfg.name}: {cfg.n_layers} layers ({cfg.first_k_dense} dense, d_ff "
        f"{cfg.d_ff}; {cfg.n_layers - cfg.first_k_dense} MoE: {cfg.n_routed_experts} experts "
        f"top-{cfg.moe_top_k} of width {cfg.d_ff_expert}, {cfg.n_shared_experts} shared), "
        f"d_model {cfg.d_model}, {cfg.n_heads} heads of {cfg.head_dim}, r {cfg.quant.r}, vocab "
        f"{cfg.vocab_size} untied; exported layer by layer in {time.perf_counter() - t0:.1f} s: "
        f"{nbytes / 1e9:.3f} GB (" + ", ".join(f"{k} {v / 1e9:.3f} GB" for k, v in by_kind.items())
        + f"); device memory held {torch.cuda.memory_allocated() / 1e9:.2f} GB")
    return params, nbytes


def phase_moe_serving(torch, cfg, params) -> tuple[dict, dict]:
    """[13] (b)-(d): DecodeEngine at the decode tier and at the prefill
    tier, and the continuous batcher on the paged kernel route and dense.
    Returns ({kernel: launches summed over the counted runs}, summary)."""
    from repro_torch.core import routing
    from repro_torch.kernels import _cuda
    from repro_torch.models import api
    from repro_torch.serve.engine import DecodeEngine, SamplerConfig

    dev = torch.device("cuda")
    t_start = time.perf_counter()
    summary, total = {}, {}
    decode = _forward_launches(cfg, "decode")
    # (b) the decode tier
    prompts = torch.randint(0, cfg.vocab_size, (MOE_BATCH, MOE_PROMPT),
                            generator=torch.Generator().manual_seed(SEED))
    greedy = SamplerConfig(temperature=0.0, top_k=0, max_new_tokens=MOE_NEW)
    max_len = MOE_PROMPT + MOE_NEW
    logits, caches = api.prefill(params, {"tokens": prompts.to(dev)}, cfg, max_len)
    step_logits, _ = api.decode_step(params, logits.argmax(-1)[:, None], caches, MOE_PROMPT, cfg)
    if not (torch.isfinite(logits).all() and torch.isfinite(step_logits).all()):
        raise AssertionError("non-finite logits")
    del logits, caches, step_logits
    eng = DecodeEngine(params, cfg, max_len=max_len, device=dev)
    stream, launches, _ = _counted_generate(
        torch, eng, prompts, greedy, _add({}, decode, MOE_NEW),
        f"(b) decode tier: {MOE_NEW} forwards x {decode} (no other kernel)", "13")
    ttft, t_gen, line = _time_generate(eng, prompts, greedy, stream, MOE_TIMED_RUNS)
    log(f"[13] (b) decode tier, {MOE_BATCH} x {MOE_PROMPT} tokens, {MOE_NEW} new: {line}")
    log(f"[13] (b) stream (request 0): {stream[0].tolist()}")
    short = dataclasses.replace(greedy, max_new_tokens=MOE_PROFILED_NEW)
    t0 = time.perf_counter()
    eng.generate(prompts, short)
    t_short = time.perf_counter() - t0
    busy = _device_trace_time(torch, lambda: eng.generate(prompts, short), t_short, "13",
                              f"generate of {MOE_PROFILED_NEW} new tokens", top=10)
    summary["decode"] = {"ttft_ms": ttft * 1e3,
                         "ms_per_step": (t_gen - ttft) / (MOE_NEW - 1) * 1e3,
                         "tokens_per_s": MOE_BATCH * (MOE_NEW - 1) / (t_gen - ttft),
                         "device_busy_share": busy / t_short, "launches": launches}
    total = _add(total, launches)
    del eng
    log(f"[time] [13] (b) done at {time.perf_counter() - t_start:.1f} s")

    # (c) the prefill tier: 4096 prefill rows (capacity 480 an expert),
    # then decode at 16 rows
    prompts = torch.randint(0, cfg.vocab_size, (MOE_P_BATCH, MOE_P_PROMPT),
                            generator=torch.Generator().manual_seed(SEED + 2))
    greedy = SamplerConfig(temperature=0.0, top_k=0, max_new_tokens=MOE_P_NEW)
    max_len = MOE_P_PROMPT + MOE_P_NEW
    prefill = _forward_launches(cfg, "prefill")
    torch.cuda.synchronize()
    _cuda.reset_launches()
    with _Drops(torch) as drops:
        logits, _ = api.prefill(params, {"tokens": prompts.to(dev)}, cfg, max_len)
    got = dict(_cuda.LAUNCHES)
    if got != {k: v for k, v in prefill.items() if v} or not torch.isfinite(logits).all():
        raise AssertionError(f"(c) prefill: launches {got}, want {prefill}; or non-finite logits")
    dropped = int(drops.total.item())
    del logits
    log(f"[13] (c) one prefill of {MOE_P_BATCH * MOE_P_PROMPT} rows: launches {got}, as "
        "predicted")
    eng = DecodeEngine(params, cfg, max_len=max_len, device=dev)
    stream, launches, _ = _counted_generate(
        torch, eng, prompts, greedy, _add(prefill, decode, MOE_P_NEW - 1),
        f"(c) prefill tier: 1 prefill forward x {prefill} + {MOE_P_NEW - 1} decode forwards x "
        f"{decode}", "13")
    ttft, t_gen, line = _time_generate(eng, prompts, greedy, stream, MOE_TIMED_RUNS)
    log(f"[13] (c) prefill tier, {MOE_P_BATCH} x {MOE_P_PROMPT} tokens, {MOE_P_NEW} new: {line}")
    rcfg = routing.RouterConfig(num_experts=cfg.n_routed_experts, top_k=cfg.moe_top_k,
                                capacity_factor=cfg.moe_capacity_factor)
    cap = routing.expert_capacity(MOE_P_BATCH * MOE_P_PROMPT, rcfg)
    routings = MOE_P_BATCH * MOE_P_PROMPT * cfg.moe_top_k * drops.routers
    log(f"[13] (c) routings dropped by capacity in the prefill: {dropped} of {routings} "
        f"({100 * dropped / routings:.2f}%) over {drops.routers} routers ({cfg.moe_top_k} a token, "
        f"capacity {cap} an expert)")
    summary["prefill"] = {"ttft_ms": ttft * 1e3,
                          "ms_per_step": (t_gen - ttft) / (MOE_P_NEW - 1) * 1e3,
                          "tokens_per_s": MOE_P_BATCH * (MOE_P_NEW - 1) / (t_gen - ttft),
                          "dropped_routings": dropped, "routings": routings,
                          "launches": launches}
    total = _add(total, launches)
    del eng
    torch.cuda.empty_cache()
    log(f"[time] [13] (c) done at {time.perf_counter() - t_start:.1f} s")

    # (d) continuous batching on a MOE_CB_LAYERS cut: paged on the kernel
    # route, and dense
    params, cfg = _moe_cut(params, cfg, MOE_CB_LAYERS)
    streams = {}
    for name, layout, env in E_CB_CONFIGS:
        rec, st, reasons, _ = _cb_run(torch, params, cfg, name, layout, None, 1, env, MOE_CB)
        rec.pop("step_walls")
        streams[name] = st
        if sorted(st) != list(range(MOE_CB.requests)) or set(reasons) != {"length"}:
            raise AssertionError(f"(d) {name}: requests did not each finish once by length")
        if rec["free_blocks"] is not None and rec["free_blocks"] != rec["num_blocks"]:
            raise AssertionError(f"(d) {name}: blocks left allocated after the run")
        pa = rec["launches"].get("paged_attention", 0)
        want = cfg.n_layers * rec["decode_steps"] if layout == "paged" else 0
        if pa != want:
            raise AssertionError(f"(d) {name}: paged_attention launched {pa} times, want {want}")
        log(f"[13] (d) {name}: wall {rec['wall_s']:.2f} s, {rec['tokens_per_s']:.1f} tokens/s, "
            f"TTFT p50 {rec['ttft_ms_p50']:.1f} / p99 {rec['ttft_ms_p99']:.1f} ms, "
            f"{rec['engine_steps']} engine steps, {rec['decode_steps']} decode steps, launches "
            f"{rec['launches']} (paged_attention at head_dim {cfg.head_dim}, {cfg.n_heads} heads: "
            f"{pa} = {cfg.n_layers} layers x {rec['decode_steps']} decode steps)")
        summary[f"continuous_{name}"] = {k: rec[k] for k in (
            "wall_s", "tokens_per_s", "ttft_ms_p50", "ttft_ms_p99", "engine_steps",
            "decode_steps", "launches")}
        if name == "kernel":
            total = _add(total, rec["launches"])
    load = _cb_load(cfg.vocab_size, MOE_CB)
    summary["continuous_kernel_vs_dense_equal"] = _compare_streams(
        torch, params, cfg, load, streams["dense"], streams["kernel"], "(d) kernel route vs dense",
        tag="13")
    log(f"[time] [13] (d) done at {time.perf_counter() - t_start:.1f} s")
    return total, summary


def phase_moe_train(torch, smi: str) -> dict:
    """[13] (f): ``make_train_step`` on a MOE_TRAIN_LAYERS-layer cut at full
    width (bf16 forward, remat) at MOE_TRAIN_BATCH x MOE_TRAIN_SEQ tokens."""
    from repro_torch.configs.registry import get_config

    cfg = dataclasses.replace(get_config(MOE_ARCH), n_layers=MOE_TRAIN_LAYERS)
    e, k = cfg.n_routed_experts, cfg.moe_top_k
    routed = (cfg.n_layers - cfg.first_k_dense) * 3 * e * cfg.d_model * cfg.d_ff_expert

    def watch(params):
        ffn = params["segments"][1]["b0"]["ffn"]  # the first MoE layer's, stacked
        return ({"router": ffn["router"]["w"], "shared/w1_up": ffn["shared"]["w1_up"],
                 "shared/w8_down": ffn["shared"]["w8_down"], "we_up": ffn["we_up"],
                 "we_down": ffn["we_down"]}, ("we_up", "we_down"))

    def active(n):
        return n - routed * (e - k) // e, f"{k} of the {e} routed experts"

    return _train_cell(torch, smi, cfg, "13", "(f)", MOE_TRAIN_BATCH, MOE_TRAIN_SEQ,
                         MOE_TRAIN_TIMED, watch, active)


def phase_moe(torch, smi: str) -> tuple[dict, dict]:
    """Phase 13: deepseek-moe-16b at full width and depth, exported layer
    by layer ((a)), served ((b)-(d)), cut to 2 layers on the card and the
    CPU ((e)), trained on a 4-layer cut and its gradients held card vs CPU
    on the 2-layer cut ((f)).  Returns ({kernel: launches of the counted
    runs}, summary)."""
    from repro_torch.configs.registry import get_config

    t0 = time.perf_counter()
    cfg = get_config(MOE_ARCH)
    params, nbytes = phase_moe_export(torch, cfg)
    log(f"[time] [13] (a) done at {time.perf_counter() - t0:.1f} s")
    launches, summary = phase_moe_serving(torch, cfg, params)
    summary["export_gb"] = nbytes / 1e9
    # (e) card vs CPU on the dense layer and the first MoE layer
    gpu, cut = _moe_cut(params, cfg, MOE_CUT_LAYERS)
    prompts = torch.randint(0, cfg.vocab_size, (MOE_BATCH, MOE_PROMPT),
                            generator=torch.Generator().manual_seed(SEED))
    phase_cut(torch, None, cfg, prompts, tag="13", decode_may_part=True, cut=(gpu, cut),
              prefill_tier=False, replay_choices=True)
    log(f"[time] [13] (e) done at {time.perf_counter() - t0:.1f} s")
    del params, gpu
    gc.collect()
    torch.cuda.empty_cache()
    summary["train"] = phase_moe_train(torch, smi)
    summary["train_cut"] = phase_train_cut(
        torch, tag="13", cfg=dataclasses.replace(cfg, n_layers=MOE_CUT_LAYERS, dtype="float32",
                                                 remat=False))
    log(f"[time] [13] (f) done at {time.perf_counter() - t0:.1f} s")
    summary["card"] = smi
    return launches, summary


# ---------------------------------------------------------------------------
# Phase 14: sliding-window and local/global attention
# ---------------------------------------------------------------------------

SWA_ARCH, DANUBE_ARCH = "gemma3-27b", "h2o-danube-1.8b"
# (a): the block-by-block export held to the one-shot export of the same
# latents on a cut of two repeats of (5 local + 1 global): its segment stacked
SWA_EXPORT_CHECK_LAYERS = 12
SWA_BATCH, SWA_PROMPT, SWA_NEW = 4, 1100, 16  # (b): every ring (1024) wraps in the prefill
SWA_BUSY_STEPS = 3  # (b)'s busy share: decode steps profiled
# (c): 4 slots of 1280 positions, 8 requests (4 at tick 0, then one a
# tick), prompts of 64-256 tokens but the last, of 1100, whose rings wrap in
# its admission and whose decode writes go on round them beside the pooled
# global layers; 8-16 new (2064 prompt tokens from the seed: a one-shot
# admission costs about ten eager launches a token and ring layer on the
# host, 241-402 us); on the first SWA_CB_LAYERS layers (2 global, 10 local),
# not all 62: the whole run keeps room for [15] (52 ring layers made the
# two runs 60 s)
SWA_CB = CBLoad(4, 1280, 8, 4, (64, 256), (8, 16), 1100)
SWA_CB_LAYERS = 12
# (d): a 2-layer cut (a local layer and a global one) whose window of 32
# the 48-token prompts wrap
SWA_CUT_WINDOW, SWA_CUT_PROMPT, SWA_CUT_NEW = 32, 48, 2  # 2 new, not 4: room for [15]
# (e): every ring (4096) wraps in the prefill; on the first DANUBE_SERVE_LAYERS
# layers, not all 24: the whole run keeps room for [15]
DANUBE_BATCH, DANUBE_PROMPT, DANUBE_NEW, DANUBE_MAX_LEN = 2, 4160, 8, 4224
DANUBE_SERVE_LAYERS = 8
# (f): positions past the 4096 window in one sequence
DANUBE_TRAIN_BATCH, DANUBE_TRAIN_SEQ, DANUBE_TRAIN_TIMED = 1, 6144, 2


class _PlainCalls:
    """While active, counts the calls of every kernel's plain version (a
    wrapper's route for CPU tensors) by name: on the card, none."""

    NAMES = {"w1a8_gemv": ("w1a8_gemv_plain", "decoupled_gemv_plain"),
             "int8_matmul": ("int8_matmul_plain",), "w1a8_matmul": ("w1a8_matmul_plain",),
             "decoupled_matmul": ("decoupled_matmul_plain",),
             "paged_attention": ("paged_attention_plain",)}

    def __enter__(self):
        import importlib

        self.calls = collections.Counter()
        self._orig = []
        for mod_name, fns in self.NAMES.items():
            mod = importlib.import_module(f"repro_torch.kernels.{mod_name}")
            for fn in fns:
                orig = getattr(mod, fn)
                self._orig.append((mod, fn, orig))

                def counted(*a, _o=orig, _n=fn, **k):
                    self.calls[_n] += 1
                    return _o(*a, **k)

                setattr(mod, fn, counted)
        return self

    def __exit__(self, *exc):
        for mod, fn, orig in self._orig:
            setattr(mod, fn, orig)


def _swa_generate(torch, cfg, params, part: str, batch: int, prompt: int, new: int,
                  max_len: int, repeat: bool) -> tuple[dict, dict]:
    """``DecodeEngine`` on ``batch`` prompts of ``prompt`` tokens from SEED,
    ``new`` greedy tokens: one counted generate (one prefill at the
    prefill tier, ``new - 1`` decode forwards at the decode tier, no other
    kernel, no plain version), its TTFT read where its prefill ends (a
    synchronize there) and its ms/step from the rest; with ``repeat`` a
    second generate must give the same stream.  Returns (launches,
    summary)."""
    from repro_torch.serve.engine import DecodeEngine, SamplerConfig

    dev = torch.device("cuda")
    prompts = torch.randint(0, cfg.vocab_size, (batch, prompt),
                            generator=torch.Generator().manual_seed(SEED))
    greedy = SamplerConfig(temperature=0.0, top_k=0, max_new_tokens=new)
    eng = DecodeEngine(params, cfg, max_len=max_len, device=dev)
    ends = []
    prefill = eng._prefill

    def timed_prefill(*a, **k):
        out = prefill(*a, **k)
        torch.cuda.synchronize()
        ends.append(time.perf_counter())
        return out

    eng._prefill = timed_prefill
    want = _add(_forward_launches(cfg, "prefill"), _forward_launches(cfg, "decode"), new - 1)
    want["paged_attention"] = 0  # the dense layout
    how = f"1 prefill forward + {new - 1} decode forwards, {cfg.n_layers} layers x (5, 2, 1)"
    t_start = time.perf_counter()
    with _PlainCalls() as plain:
        stream, launches, wall = _counted_generate(torch, eng, prompts, greedy, want, how, "14")
    if plain.calls:
        raise AssertionError(f"{part}: plain versions called on the card: {dict(plain.calls)}")
    ttft = ends[0] - t_start
    ms_step = (wall - ttft) / (new - 1) * 1e3
    steps = cfg.n_layers if not cfg.global_every else \
        cfg.n_layers - cfg.n_layers // cfg.global_every
    log(f"[14] {part} {cfg.name} DecodeEngine, {batch} x {prompt} tokens, {new} new: TTFT "
        f"{ttft * 1e3:.1f} ms ({1e6 * ttft / (steps * prompt):.1f} us a token and ring layer "
        f"over {steps} ring layers), generate {wall * 1e3:.1f} ms, decode {ms_step:.2f} ms/step, "
        f"{batch * (new - 1) / (wall - ttft):.1f} tokens/s")
    log(f"[14] {part} stream (request 0): {stream[0].tolist()}")
    summary = {"ttft_ms": ttft * 1e3, "generate_ms": wall * 1e3, "ms_per_step": ms_step,
               "launches": launches}
    if repeat:
        t0 = time.perf_counter()
        again = eng.generate(prompts, greedy)
        summary["generate_ms_again"] = (time.perf_counter() - t0) * 1e3
        if not (again == stream).all():
            raise AssertionError(f"{part}: a repeated generate gave another stream")
        log(f"[14] {part} a second generate repeats the stream ({summary['generate_ms_again']:.1f}"
            " ms)")
    del eng
    return launches, summary


def _swa_decode_busy(torch, cfg, params, batch: int, pos: int, max_len: int) -> float:
    """Device busy share of SWA_BUSY_STEPS decode steps at ``pos`` on a
    cache of random K/V (the share does not depend on the values): two
    warm-up steps, then the steps timed unprofiled and profiled."""
    from repro_torch.models import api

    dev = torch.device("cuda")
    caches = api.init_cache(cfg, batch, max_len, torch.float32, dev)
    for t in _leaves(caches):
        t.normal_(generator=torch.Generator(device=dev).manual_seed(SEED))
    tok = torch.zeros((batch, 1), dtype=torch.long, device=dev)

    def steps(n):
        for i in range(n):
            api.decode_step(params, tok, caches, pos + i, cfg)

    steps(2)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    steps(SWA_BUSY_STEPS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    busy = _device_trace_time(torch, lambda: steps(SWA_BUSY_STEPS), wall, "14",
                              f"{SWA_BUSY_STEPS} decode steps", top=8)
    return busy / wall


def phase_swa_export(torch, cfg):
    """[14] (a): gemma3-27b's export block by block, held leaf for leaf,
    exactly, to the one-shot export on a cut of SWA_EXPORT_CHECK_LAYERS
    layers (its segment stacked over two repeats); then the full model's.
    Returns (params, bytes)."""
    t0 = time.perf_counter()
    cut = dataclasses.replace(cfg, n_layers=SWA_EXPORT_CHECK_LAYERS)
    a = dict(_tree_paths(_block_export(torch, cut)))
    b = dict(_tree_paths(_block_export(torch, cut, one_shot=True)))
    if list(a) != list(b):
        raise AssertionError(f"export trees differ: {sorted(set(a) ^ set(b))}")
    differ = [k for k in a if a[k].dtype != b[k].dtype or not torch.equal(a[k], b[k])]
    if differ:
        raise AssertionError(f"the block-by-block export differs from the one-shot export at "
                             f"{differ}")
    reps = SWA_EXPORT_CHECK_LAYERS // cfg.global_every
    stacked = [k for k in a if k.startswith("/segments/0/") and a[k].shape[:1] == (reps,)]
    if "/lm_head/table" in a or len({k.split("/")[3] for k in stacked}) != cfg.global_every:
        raise AssertionError(f"cut tree: {sorted(a)[:8]}")
    log(f"[14] (a) {SWA_EXPORT_CHECK_LAYERS}-layer cut: the block-by-block export equals the "
        f"one-shot export of the same latents leaf for leaf, bit for bit ({len(a)} leaves, "
        f"{len(stacked)} of them stacked over its {reps} repeats of b0-b{cfg.global_every - 1}; "
        f"tied, no lm_head); {time.perf_counter() - t0:.1f} s")
    del a, b
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    params = _block_export(torch, cfg)
    torch.cuda.synchronize()
    leaves = dict(_tree_paths(params))
    nbytes = sum(t.numel() * t.element_size() for t in leaves.values())
    by_kind = {}
    for t in leaves.values():
        kind = ("packed 1-bit" if t.dtype == torch.uint8 else "int8" if t.dtype == torch.int8
                else "float")
        by_kind[kind] = by_kind.get(kind, 0) + t.numel() * t.element_size()
    log(f"[14] (a) {cfg.name}: {cfg.n_layers} layers ({cfg.n_layers // cfg.global_every} global, "
        f"the rest a {cfg.window_size}-token window), d_model {cfg.d_model}, {cfg.n_heads} heads "
        f"over {cfg.n_kv_heads} KV heads of {cfg.head_dim}, d_ff {cfg.d_ff} ({cfg.activation} GLU), "
        f"r {cfg.quant.r}, vocab {cfg.vocab_size} tied; exported block by block in "
        f"{time.perf_counter() - t0:.1f} s: {nbytes / 1e9:.3f} GB (" + ", ".join(
            f"{k} {v / 1e9:.3f} GB" for k, v in by_kind.items())
        + f"); device memory held {torch.cuda.memory_allocated() / 1e9:.2f} GB")
    return params, nbytes


def phase_swa_serving(torch, cfg, params) -> tuple[dict, dict]:
    """[14] (b) and (c): gemma3-27b's DecodeEngine past the window, and the
    continuous batcher on the paged kernel route (global layers on the
    pool, local layers on dense rings) and dense.  Returns ({kernel:
    launches of the counted runs}, summary)."""
    t0 = time.perf_counter()
    launches, summary = _swa_generate(torch, cfg, params, "(b)", SWA_BATCH, SWA_PROMPT, SWA_NEW,
                                      SWA_PROMPT + SWA_NEW, repeat=True)
    summary = {"decode": summary}
    summary["decode"]["device_busy_share"] = _swa_decode_busy(
        torch, cfg, params, SWA_BATCH, SWA_PROMPT, SWA_PROMPT + SWA_NEW)
    log(f"[time] [14] (b) done at {time.perf_counter() - t0:.1f} s")
    # (c) on the first SWA_CB_LAYERS layers: whole periods of the stacked segment
    cfg = dataclasses.replace(cfg, n_layers=SWA_CB_LAYERS)
    params = {"embed": params["embed"], "final_norm": params["final_norm"], "segments": [
        _tree(lambda t: t[:SWA_CB_LAYERS // cfg.global_every], params["segments"][0])]}
    n_global = cfg.n_layers // cfg.global_every
    if SWA_CB.long + SWA_CB.new[0] <= cfg.window_size:
        raise AssertionError("(c): no request's ring wraps")
    streams = {}
    for name, layout, env in E_CB_CONFIGS:
        with _PagedVsGather(torch) as check:
            rec, st, reasons, _ = _cb_run(torch, params, cfg, name, layout, None, 1, env, SWA_CB)
        if check.max_err > PA_ATOL:
            raise AssertionError(f"(c) {name}: paged_attention and the gather route disagree by "
                                 f"{check.max_err} on the same inputs")
        rec.pop("step_walls")
        streams[name] = st
        if sorted(st) != list(range(SWA_CB.requests)) or set(reasons) != {"length"}:
            raise AssertionError(f"(c) {name}: requests did not each finish once by length")
        if rec["free_blocks"] is not None and rec["free_blocks"] != rec["num_blocks"]:
            raise AssertionError(f"(c) {name}: blocks left allocated after the run")
        pa = rec["launches"].get("paged_attention", 0)
        want = n_global * (rec["decode_steps"] + rec["chunked_slices"]) if layout == "paged" else 0
        if pa != want:
            raise AssertionError(f"(c) {name}: paged_attention launched {pa} times, want {want}")
        log(f"[14] (c) {name}: wall {rec['wall_s']:.2f} s, {rec['tokens_per_s']:.1f} tokens/s, "
            f"TTFT p50 {rec['ttft_ms_p50']:.1f} / p99 {rec['ttft_ms_p99']:.1f} ms, "
            f"{rec['engine_steps']} engine steps, {rec['decode_steps']} decode steps, launches "
            f"{rec['launches']} (paged_attention, GQA {cfg.n_heads} over {cfg.n_kv_heads} heads of "
            f"{cfg.head_dim}: {pa} = {n_global} global layers x ({rec['decode_steps']} decode "
            f"steps + {rec['chunked_slices']} slices); {check.calls} paged attention calls held "
            f"to the gather route on the same inputs, max |kernel - gather| {check.max_err:.3g} "
            f"(tolerance {PA_ATOL}; the check's own gather calls are in the wall)")
        summary[f"continuous_{name}"] = {k: rec[k] for k in (
            "wall_s", "tokens_per_s", "ttft_ms_p50", "ttft_ms_p99", "engine_steps",
            "decode_steps", "launches")}
        if name == "kernel":
            launches = _add(launches, rec["launches"])
    summary["continuous_kernel_vs_dense_equal"] = _compare_streams(
        torch, params, cfg, _cb_load(cfg.vocab_size, SWA_CB), streams["dense"], streams["kernel"],
        "(c) kernel route vs dense", tag="14")
    log(f"[time] [14] (c) done at {time.perf_counter() - t0:.1f} s")
    return launches, summary


def phase_swa(torch, smi: str) -> tuple[dict, dict]:
    """Phase 14: gemma3-27b at full width and depth, exported block by
    block ((a)) and served ((b), (c)); a 2-layer cut of it on the card and
    the CPU, served and its gradients ((d)); h2o-danube-1.8b at full width
    and depth served ((e)) and trained ((f)).  Returns ({kernel: launches of
    the counted runs}, summary)."""
    from repro_torch.configs.registry import get_config

    t0 = time.perf_counter()
    cfg = get_config(SWA_ARCH)
    params, nbytes = phase_swa_export(torch, cfg)
    log(f"[time] [14] (a) done at {time.perf_counter() - t0:.1f} s")
    launches, summary = phase_swa_serving(torch, cfg, params)
    summary["export_gb"] = nbytes / 1e9
    # (d) card vs CPU on a local layer and a global one of the export
    seg = params["segments"][0]
    gpu = {"embed": params["embed"], "final_norm": params["final_norm"],
           "segments": [{"b0": _tree(lambda t: t[0].contiguous(), seg["b0"]),
                         "b1": _tree(lambda t: t[0].contiguous(),
                                     seg[f"b{cfg.global_every - 1}"])}]}
    del params, seg
    gc.collect()
    torch.cuda.empty_cache()
    cut = dataclasses.replace(cfg, n_layers=2, global_every=2, window_size=SWA_CUT_WINDOW)
    prompts = torch.randint(0, cfg.vocab_size, (SWA_BATCH, SWA_CUT_PROMPT),
                            generator=torch.Generator().manual_seed(SEED))
    phase_cut(torch, None, cfg, prompts, tag="14", decode_may_part=True, cut=(gpu, cut),
              prefill_tier=False, new_tokens=SWA_CUT_NEW)
    del gpu
    gc.collect()
    torch.cuda.empty_cache()
    summary["train_cut"] = phase_train_cut(
        torch, tag="14", cfg=dataclasses.replace(cut, dtype="float32", remat=False),
        init_on_card=True, f32_noise=True)
    log(f"[time] [14] (d) done at {time.perf_counter() - t0:.1f} s")
    # (e) h2o-danube-1.8b served past its window
    dcfg = get_config(DANUBE_ARCH)
    scfg = dataclasses.replace(dcfg, n_layers=DANUBE_SERVE_LAYERS)
    dparams = _block_export(torch, scfg)
    d_launches, summary["danube_decode"] = _swa_generate(
        torch, scfg, dparams, "(e)", DANUBE_BATCH, DANUBE_PROMPT, DANUBE_NEW, DANUBE_MAX_LEN,
        repeat=False)
    launches = _add(launches, d_launches)
    del dparams
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[time] [14] (e) done at {time.perf_counter() - t0:.1f} s")

    # (f) h2o-danube-1.8b trained past its window
    def watch(p):
        return {"wq": p["segments"][0]["b0"]["mixer"]["wq"]["w"],
                "w8_down": p["segments"][0]["b0"]["ffn"]["w8_down"]}, ()

    summary["danube_train"] = _train_cell(
        torch, smi, dcfg, "14", "(f)", DANUBE_TRAIN_BATCH, DANUBE_TRAIN_SEQ, DANUBE_TRAIN_TIMED,
        watch, lambda n: (n, "every parameter"))
    log(f"[time] [14] (f) done at {time.perf_counter() - t0:.1f} s")
    summary["card"] = smi
    return launches, summary


# ---------------------------------------------------------------------------
# Phase 15: Multi-head Latent Attention (deepseek-v2-236b)
# ---------------------------------------------------------------------------

MLA_ARCH = "deepseek-v2-236b"
# (a): the block-by-block export held to the one-shot export of the same
# latents on a cut of 1 dense + 2 MoE layers (the MoE segment stacked)
MLA_EXPORT_CHECK_LAYERS = 3
# (b) the decode tier: the prefill's 128 rows run the prefill GEMMs, each
# decode step's 4 rows the GEMVs, its latent expansion the 4 x 40 cache rows
MLA_BATCH, MLA_PROMPT, MLA_NEW = 4, 32, 8
MLA_P_BATCH, MLA_P_PROMPT = 8, 256  # (c) the prefill tier: 2048 rows
# (d): a 4-layer cut (1 dense + 3 MoE) of the export, 4 slots of 272
# positions, 5 requests (4 at tick 0), prompts of 16-256 tokens, 4-8 new
MLA_CB_LAYERS = 4
MLA_CB = CBLoad(4, 272, 5, 4, (16, 256), (4, 8))
MLA_CUT_LAYERS, MLA_CUT_NEW = 2, 2  # (e): the dense layer and the first MoE layer
# (e): the dense layer's chunk of MLA_STEPS_T tokens against as many decode
# steps, per-slot positions in a latent cache of MLA_STEPS_LEN positions
MLA_STEPS_T, MLA_STEPS_POS, MLA_STEPS_LEN = 8, (2, 5, 11, 20), 32
# (f): a 2-layer cut at full width with MLA_TRAIN_EXPERTS of the 160 routed
# experts (top-6 and the 2 shared kept), bf16, remat
MLA_TRAIN_LAYERS, MLA_TRAIN_EXPERTS = 2, 32
MLA_TRAIN_BATCH, MLA_TRAIN_SEQ, MLA_TRAIN_TIMED = 2, 2048, 2
# (f)'s card vs CPU gradient cut: the same 2 layers in f32 with 8 routed
# experts (top-6 kept), small enough for the CPU
MLA_GRAD_EXPERTS = 8


def _mla_launches(cfg, rows: int, latent_rows: int) -> dict:
    """Kernel launches of one packed forward of an MLA MoE model over
    ``rows`` token rows whose latent expansion reads ``latent_rows`` cache
    rows (B x the positions read), each linear on the decode GEMVs at most
    32 rows, else on the prefill GEMMs: a layer's wq_down, wq_up, wkv_down
    and wo at ``rows`` and its wkv_up at ``latent_rows``; its FFN's (the
    dense one's or the shared experts') 1-bit down projection, two up/gate
    pairs and 8-bit down projection at ``rows``; each MoE layer's routed
    experts one W1A8 call a slice and linear at their capacity."""
    from repro_torch.core import routing

    def one(m):
        return "w1a8_gemv" if m <= 32 else "w1a8_matmul"

    rcfg = routing.RouterConfig(num_experts=cfg.n_routed_experts, top_k=cfg.moe_top_k,
                                capacity_factor=cfg.moe_capacity_factor)
    out = _add({k: 0 for k in MOE_KERNELS}, {
        one(rows): 5, "decoupled_gemv" if rows <= 32 else "decoupled_matmul": 2,
        "int8_matmul": 1}, cfg.n_layers)
    out = _add(out, {one(latent_rows): 1}, cfg.n_layers)
    n_moe = cfg.n_layers - cfg.first_k_dense
    return _add(out, {one(routing.expert_capacity(rows, rcfg)): 3 * cfg.n_routed_experts}, n_moe)


def phase_mla_export(torch, cfg):
    """[15] (a): deepseek-v2-236b's export block by block, held leaf for leaf,
    exactly, to the one-shot export on a cut of MLA_EXPORT_CHECK_LAYERS
    layers; then the full model's.  Returns (params, bytes)."""
    t0 = time.perf_counter()
    cut = dataclasses.replace(cfg, n_layers=MLA_EXPORT_CHECK_LAYERS)
    a = dict(_tree_paths(_block_export(torch, cut)))
    peak_a = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    b = dict(_tree_paths(_block_export(torch, cut, one_shot=True)))
    if list(a) != list(b):
        raise AssertionError(f"export trees differ: {sorted(set(a) ^ set(b))}")
    differ = [k for k in a if a[k].dtype != b[k].dtype or not torch.equal(a[k], b[k])]
    if differ:
        raise AssertionError(f"the block-by-block export differs from the one-shot export at "
                             f"{differ}")
    stacked = [k for k in a if k.startswith("/segments/1/") and a[k].ndim and
               a[k].shape[0] == MLA_EXPORT_CHECK_LAYERS - cfg.first_k_dense]
    log(f"[15] (a) {MLA_EXPORT_CHECK_LAYERS}-layer cut: the block-by-block export equals the "
        f"one-shot export of the same latents leaf for leaf, bit for bit ({len(a)} leaves, "
        f"{len(stacked)} of them stacked over its 2 MoE layers); peak device memory "
        f"{peak_a / 1e9:.2f} GB block by block, {torch.cuda.max_memory_allocated() / 1e9:.2f} "
        f"GB one-shot; {time.perf_counter() - t0:.1f} s")
    del a, b
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = _block_export(torch, cfg)
    torch.cuda.synchronize()
    leaves = dict(_tree_paths(params))
    nbytes = sum(t.numel() * t.element_size() for t in leaves.values())
    by_kind = {}
    for t in leaves.values():
        kind = ("packed 1-bit" if t.dtype == torch.uint8 else "int8" if t.dtype == torch.int8
                else "float")
        by_kind[kind] = by_kind.get(kind, 0) + t.numel() * t.element_size()
    log(f"[15] (a) {cfg.name}: {cfg.n_layers} layers ({cfg.first_k_dense} dense, d_ff "
        f"{cfg.d_ff}; {cfg.n_layers - cfg.first_k_dense} MoE: {cfg.n_routed_experts} experts "
        f"top-{cfg.moe_top_k} of width {cfg.d_ff_expert}, {cfg.n_shared_experts} shared), "
        f"d_model {cfg.d_model}, MLA: {cfg.n_heads} heads, q_lora {cfg.q_lora_rank}, kv_lora "
        f"{cfg.kv_lora_rank}, qk {cfg.qk_nope_dim} + {cfg.qk_rope_dim} rope, v "
        f"{cfg.v_head_dim}; r {cfg.quant.r}, vocab {cfg.vocab_size} untied; exported block by "
        f"block in {time.perf_counter() - t0:.1f} s: {nbytes / 1e9:.3f} GB (" + ", ".join(
            f"{k} {v / 1e9:.3f} GB" for k, v in by_kind.items())
        + f"); device memory held {torch.cuda.memory_allocated() / 1e9:.2f} GB, peak "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    return params, nbytes, by_kind


def _mla_generate(torch, cfg, params, prompts, new: int, want: dict, how: str, part: str):
    """One counted ``DecodeEngine`` generate of ``new`` greedy tokens (no
    plain version called), its TTFT read where its prefill ends (a
    synchronize there), then a second generate that must repeat the
    stream.  Returns (launches, {ttft_ms, generate_ms: both runs, medians,
    ms_per_step, tokens_per_s}, the engine)."""
    from repro_torch.serve.engine import DecodeEngine, SamplerConfig

    greedy = SamplerConfig(temperature=0.0, top_k=0, max_new_tokens=new)
    eng = DecodeEngine(params, cfg, max_len=prompts.shape[1] + new, device=torch.device("cuda"))
    ends = []
    prefill = eng._prefill

    def timed_prefill(*a, **k):
        out = prefill(*a, **k)
        torch.cuda.synchronize()
        ends.append(time.perf_counter())
        return out

    eng._prefill = timed_prefill
    walls, ttfts = [], []
    with _PlainCalls() as plain:
        t0 = time.perf_counter()
        stream, launches, wall = _counted_generate(torch, eng, prompts, greedy, want, how, "15")
        ttfts.append(ends[-1] - t0)
        walls.append(wall)
        t0 = time.perf_counter()
        again = eng.generate(prompts, greedy)
        walls.append(time.perf_counter() - t0)
        ttfts.append(ends[-1] - t0)
    if plain.calls:
        raise AssertionError(f"{part}: plain versions called on the card: {dict(plain.calls)}")
    if not (again == stream).all():
        raise AssertionError(f"{part}: a repeated generate gave another stream")
    eng._prefill = prefill
    ttft, wall = statistics.median(ttfts), statistics.median(walls)
    b = prompts.shape[0]
    summary = {"ttft_ms": ttft * 1e3, "ttft_ms_runs": [t * 1e3 for t in ttfts],
               "generate_ms": wall * 1e3, "generate_ms_runs": [w * 1e3 for w in walls]}
    if new > 1:
        summary["ms_per_step"] = (wall - ttft) / (new - 1) * 1e3
        summary["tokens_per_s"] = b * (new - 1) / (wall - ttft)
    log(f"[15] {part} DecodeEngine, {b} x {prompts.shape[1]} tokens, {new} new, over 2 runs "
        f"(host clock; TTFT where the prefill ends, synchronized; the generate ended by its one "
        f"transfer): TTFT {[round(t * 1e3, 1) for t in ttfts]} ms, generate "
        f"{[round(w * 1e3, 1) for w in walls]} ms" + (
            f"; decode {summary['ms_per_step']:.2f} ms/step, {summary['tokens_per_s']:.2f} "
            f"tokens/s at batch {b}" if new > 1 else ""))
    log(f"[15] {part} stream (request 0): {stream[0].tolist()}; a second generate repeats it")
    summary["launches"] = launches
    return launches, summary, eng


def _mla_chunk_vs_steps(torch, params, cfg) -> dict:
    """[15] (e): the dense layer's packed MLA on the card, one
    MLA_STEPS_T-token ``mla_chunk`` at per-slot positions MLA_STEPS_POS
    (every token valid) against as many ``mla_decode`` steps from the same
    latent cache (noise, MLA_STEPS_LEN positions): the latent caches and
    the outputs, each bit for bit or by how much they differ, the outputs
    held within LOGIT_TOL of their largest (the tests hold the two on the
    CPU within 1e-5).  No plain version is called."""
    from repro_torch.models import attention

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    mp = params["segments"][0]["b0"]["mixer"]
    b, t = len(MLA_STEPS_POS), MLA_STEPS_T
    x = torch.randn((b, t, cfg.d_model), generator=gen, device=dev)
    chunked = {"ckv": torch.randn((b, MLA_STEPS_LEN, cfg.kv_lora_rank), generator=gen,
                                  device=dev),
               "krope": torch.randn((b, MLA_STEPS_LEN, cfg.qk_rope_dim), generator=gen,
                                    device=dev)}
    stepped = {k: v.clone() for k, v in chunked.items()}
    pos = torch.tensor(MLA_STEPS_POS, device=dev)
    with _PlainCalls() as plain:
        y, _ = attention.mla_chunk(mp, x, chunked, pos, cfg,
                                   attention.rope_at(pos, t, cfg.qk_rope_dim, cfg.rope_theta),
                                   lengths=torch.full((b,), t, device=dev))
        ys = torch.cat([attention.mla_decode(
            mp, x[:, i:i + 1], stepped, pos + i, cfg,
            attention.rope_at(pos + i, 1, cfg.qk_rope_dim, cfg.rope_theta))[0]
            for i in range(t)], dim=1)
    if plain.calls:
        raise AssertionError(f"(e) chunk vs steps: plain versions called: {dict(plain.calls)}")
    if not (torch.isfinite(y).all() and torch.isfinite(ys).all()):
        raise AssertionError("(e) chunk vs steps: non-finite outputs")
    out = {"outputs_bitwise": torch.equal(y, ys),
           "outputs_max_abs_diff": (y - ys).abs().max().item(),
           "outputs_max_abs": ys.abs().max().item(),
           "latents_bitwise": all(torch.equal(chunked[k], stepped[k]) for k in chunked),
           "latents_max_abs_diff": max((chunked[k] - stepped[k]).abs().max().item()
                                       for k in chunked)}
    log(f"[15] (e) the dense layer's MLA, a {t}-token mla_chunk at positions {MLA_STEPS_POS} "
        f"against {t} mla_decode steps on the card: latent caches bit for bit "
        f"{out['latents_bitwise']} (max |diff| {out['latents_max_abs_diff']:.3g}); outputs bit "
        f"for bit {out['outputs_bitwise']} (max |diff| {out['outputs_max_abs_diff']:.3g}, |y| <= "
        f"{out['outputs_max_abs']:.3g}, tolerance {LOGIT_TOL} x that)")
    if out["outputs_max_abs_diff"] > LOGIT_TOL * out["outputs_max_abs"]:
        raise AssertionError("(e) a chunk and its decode steps disagree on the card")
    return out


def phase_mla_serving(torch, cfg, params) -> tuple[dict, dict]:
    """[15] (b)-(d): DecodeEngine at the decode tier and at the prefill
    tier, and the continuous batcher on a 4-layer cut in both layouts.
    Returns ({kernel: launches summed over the counted runs}, summary)."""
    from repro_torch.core import routing
    from repro_torch.kernels import _cuda
    from repro_torch.models import api

    dev = torch.device("cuda")
    t_start = time.perf_counter()
    summary = {}
    # (b) the decode tier
    prompts = torch.randint(0, cfg.vocab_size, (MLA_BATCH, MLA_PROMPT),
                            generator=torch.Generator().manual_seed(SEED))
    max_len = MLA_PROMPT + MLA_NEW
    prefill = _mla_launches(cfg, MLA_BATCH * MLA_PROMPT, MLA_BATCH * MLA_PROMPT)
    decode = _mla_launches(cfg, MLA_BATCH, MLA_BATCH * max_len)
    log(f"[15] (b) a decode forward launches {decode}: {cfg.n_layers} x 5 W1A8 GEMVs (wq_down, "
        f"wq_up, wkv_down, wo, the FFN's w1_down) plus {cfg.n_layers - cfg.first_k_dense} x "
        f"{cfg.n_routed_experts} x 3 expert slices; {cfg.n_layers} latent expansions (wkv_up "
        f"over {MLA_BATCH} x {max_len} cache rows) on w1a8_matmul; {cfg.n_layers} x 2 "
        f"decoupled_gemv, {cfg.n_layers} int8_matmul")
    total, summary["decode"], eng = _mla_generate(
        torch, cfg, params, prompts, MLA_NEW, _add(prefill, decode, MLA_NEW - 1),
        f"1 prefill forward x {prefill} + {MLA_NEW - 1} decode forwards x {decode}", "(b)")
    del eng
    # finite logits of a prefill and a decode step, then the busy share of
    # one decode step (timed unprofiled, then profiled, on the same caches)
    with _PlainCalls() as plain:
        logits, caches = api.prefill(params, {"tokens": prompts.to(dev)}, cfg, max_len)
        tok = logits.argmax(-1)[:, None]
        step_logits, _ = api.decode_step(params, tok, caches, MLA_PROMPT, cfg)
        if not (torch.isfinite(logits).all() and torch.isfinite(step_logits).all()):
            raise AssertionError("(b) non-finite logits")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        api.decode_step(params, tok, caches, MLA_PROMPT, cfg)
        torch.cuda.synchronize()
        t_step = time.perf_counter() - t0
        busy = _device_trace_time(torch, lambda: api.decode_step(params, tok, caches, MLA_PROMPT,
                                                                 cfg),
                                  t_step, "15", "decode step", top=10)
    if plain.calls:
        raise AssertionError(f"(b): plain versions called on the card: {dict(plain.calls)}")
    summary["decode"]["device_busy_share"] = busy / t_step
    summary["decode"]["decode_step_ms"] = t_step * 1e3
    del logits, caches, step_logits
    log(f"[time] [15] (b) done at {time.perf_counter() - t_start:.1f} s")

    # (c) the prefill tier: 2048 rows (capacity 96 an expert), one token
    prompts = torch.randint(0, cfg.vocab_size, (MLA_P_BATCH, MLA_P_PROMPT),
                            generator=torch.Generator().manual_seed(SEED + 2))
    rows = MLA_P_BATCH * MLA_P_PROMPT
    prefill = _mla_launches(cfg, rows, rows)
    if prefill["w1a8_gemv"] or prefill["decoupled_gemv"]:
        raise AssertionError(f"(c) {rows} rows would reach a GEMV: {prefill}")
    with _Drops(torch) as drops:
        launches, summary["prefill"], eng = _mla_generate(
            torch, cfg, params, prompts, 1, prefill, f"1 prefill forward x {prefill}", "(c)")
    del eng
    total = _add(total, launches)
    rcfg = routing.RouterConfig(num_experts=cfg.n_routed_experts, top_k=cfg.moe_top_k,
                                capacity_factor=cfg.moe_capacity_factor)
    dropped = int(drops.total.item()) // 2  # two prefills
    routings = rows * cfg.moe_top_k * drops.routers // 2
    log(f"[15] (c) routings dropped by capacity in a prefill: {dropped} of {routings} "
        f"({100 * dropped / routings:.2f}%) over {drops.routers // 2} routers ({cfg.moe_top_k} a "
        f"token, capacity {routing.expert_capacity(rows, rcfg)} an expert)")
    summary["prefill"].update(dropped_routings=dropped, routings=routings)
    torch.cuda.empty_cache()
    log(f"[time] [15] (c) done at {time.perf_counter() - t_start:.1f} s")

    # (d) continuous batching on a 4-layer cut: paged (no MLA layer on the
    # pool: the allocator's bookkeeping only) and dense
    sliced, cut = _moe_cut(params, cfg, MLA_CB_LAYERS)
    streams = {}
    for name, layout in (("paged", "paged"), ("dense", "dense")):
        with _PlainCalls() as plain:
            rec, st, reasons, _ = _cb_run(torch, sliced, cut, name, layout, None, 1, "auto",
                                          MLA_CB)
        rec.pop("step_walls")
        streams[name] = st
        if plain.calls:
            raise AssertionError(f"(d) {name}: plain versions called: {dict(plain.calls)}")
        if sorted(st) != list(range(MLA_CB.requests)) or set(reasons) != {"length"} \
                or len(reasons) != MLA_CB.requests:
            raise AssertionError(f"(d) {name}: requests did not each finish once by length")
        if rec["free_blocks"] is not None and rec["free_blocks"] != rec["num_blocks"]:
            raise AssertionError(f"(d) {name}: blocks left allocated after the run")
        if rec["launches"].get("paged_attention", 0) or \
                rec["launches"].get("w1a8_matmul", 0) < cut.n_layers * rec["decode_steps"]:
            raise AssertionError(f"(d) {name}: launches {rec['launches']}: want no "
                                 "paged_attention and a w1a8_matmul expansion a layer and step")
        log(f"[15] (d) {name}: wall {rec['wall_s']:.2f} s, {rec['tokens_per_s']:.1f} tokens/s, "
            f"TTFT p50 {rec['ttft_ms_p50']:.1f} / p99 {rec['ttft_ms_p99']:.1f} ms, "
            f"{rec['engine_steps']} engine steps, {rec['decode_steps']} decode steps, launches "
            f"{rec['launches']} (no paged_attention: every layer keeps its dense latent cache)")
        summary[f"continuous_{name}"] = {k: rec[k] for k in (
            "wall_s", "tokens_per_s", "ttft_ms_p50", "ttft_ms_p99", "engine_steps",
            "decode_steps", "launches")}
        if name == "paged":
            total = _add(total, rec["launches"])
    equal = _compare_streams(torch, sliced, cut, _cb_load(cfg.vocab_size, MLA_CB),
                             streams["dense"], streams["paged"], "(d) paged vs dense", tag="15")
    if equal != MLA_CB.requests:
        raise AssertionError("(d) the paged layout's streams differ from the dense layout's "
                             "(the same computation: no MLA layer is on the pool)")
    summary["continuous_paged_vs_dense_equal"] = equal
    log(f"[time] [15] (d) done at {time.perf_counter() - t_start:.1f} s")
    return total, summary


def phase_mla_train(torch, smi: str) -> dict:
    """[15] (f): ``make_train_step`` on a MLA_TRAIN_LAYERS-layer cut at full
    width with MLA_TRAIN_EXPERTS routed experts (bf16 forward, remat) at
    MLA_TRAIN_BATCH x MLA_TRAIN_SEQ tokens."""
    from repro_torch.configs.registry import get_config

    cfg = dataclasses.replace(get_config(MLA_ARCH), n_layers=MLA_TRAIN_LAYERS,
                              n_routed_experts=MLA_TRAIN_EXPERTS)
    e, k = cfg.n_routed_experts, cfg.moe_top_k
    routed = (cfg.n_layers - cfg.first_k_dense) * 3 * e * cfg.d_model * cfg.d_ff_expert

    def watch(params):
        mixer = params["segments"][0]["b0"]["mixer"]  # the dense layer's MLA
        ffn = params["segments"][1]["b0"]["ffn"]  # the MoE layer's (a segment of one)
        lead = lambda t: t[None]  # noqa: E731  (the watch reads slice 0 of a stack)
        got = {name: lead(mixer[name]["w"]) for name in ("wq_down", "wq_up", "wkv_down",
                                                          "wkv_up", "wo")}
        got.update({name: lead(mixer[name]["scale"]) for name in ("q_norm", "kv_norm", "subln")})
        got.update({"router": lead(ffn["router"]["w"]), "we_up": lead(ffn["we_up"])})
        return got, ("we_up",)

    def active(n):
        return n - routed * (e - k) // e, f"{k} of the {e} routed experts"

    return _train_cell(torch, smi, cfg, "15", "(f)", MLA_TRAIN_BATCH, MLA_TRAIN_SEQ,
                       MLA_TRAIN_TIMED, watch, active)


def phase_mla(torch, smi: str) -> tuple[dict, dict]:
    """Phase 15: deepseek-v2-236b at full width and depth, exported block by
    block ((a)) and served ((b)-(d)); cut to 2 layers on the card and the
    CPU ((e)); trained on a 2-layer cut with fewer routed experts, and its
    gradients held card vs CPU ((f)).  Returns ({kernel: launches of the
    counted runs}, summary)."""
    from repro_torch.configs.registry import get_config

    t0 = time.perf_counter()
    cfg = get_config(MLA_ARCH)
    params, nbytes, by_kind = phase_mla_export(torch, cfg)
    log(f"[time] [15] (a) done at {time.perf_counter() - t0:.1f} s")
    launches, summary = phase_mla_serving(torch, cfg, params)
    summary["export_gb"] = nbytes / 1e9
    summary["export_gb_by_kind"] = {k: v / 1e9 for k, v in by_kind.items()}
    # (e) card vs CPU on the dense layer and the first MoE layer
    gpu, cut = _moe_cut(params, cfg, MLA_CUT_LAYERS)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    prompts = torch.randint(0, cfg.vocab_size, (MLA_BATCH, 8),
                            generator=torch.Generator().manual_seed(SEED))
    phase_cut(torch, None, cfg, prompts, tag="15", decode_may_part=True, cut=(gpu, cut),
              prefill_tier=False, replay_choices=True, new_tokens=MLA_CUT_NEW)
    summary["chunk_vs_steps"] = _mla_chunk_vs_steps(torch, gpu, cut)
    log(f"[time] [15] (e) done at {time.perf_counter() - t0:.1f} s")
    del gpu
    gc.collect()
    torch.cuda.empty_cache()
    summary["train"] = phase_mla_train(torch, smi)
    summary["train_cut"] = phase_train_cut(
        torch, tag="15", init_on_card=True, cfg=dataclasses.replace(
            cfg, n_layers=MLA_TRAIN_LAYERS, n_routed_experts=MLA_GRAD_EXPERTS, dtype="float32",
            remat=False))
    log(f"[time] [15] (f) done at {time.perf_counter() - t0:.1f} s")
    summary["card"] = smi
    return launches, summary


def swa(torch) -> int:
    """Phases 1, 2 and 14 alone: prints one JSON line of phase 14's launch
    counts and summary."""
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _cuda  # fails outside a checkout of the repo

    smi, _, _ = phase_card(torch)
    t0 = phase_build(_cuda)
    launches, summary = phase_swa(torch, smi)
    log(f"[time] [14] done at {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"launches": launches, "swa": summary}, default=str))
    return 0


def mla(torch) -> int:
    """Phases 1, 2 and 15 alone: prints one JSON line of phase 15's launch
    counts and summary."""
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _cuda  # fails outside a checkout of the repo

    smi, _, _ = phase_card(torch)
    t0 = phase_build(_cuda)
    launches, summary = phase_mla(torch, smi)
    log(f"[time] [15] done at {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"launches": launches, "mla": summary}, default=str))
    return 0


def train(torch) -> int:
    """Phases 1, 10 and 11 alone: prints one JSON line of the summaries of
    phases 10 and 11."""
    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch  # noqa: F401  (fails outside a checkout of the repo)

    smi, _, _ = phase_card(torch)
    summary = phase_train(torch, smi)
    phase_train_cut(torch)
    loop = phase_trainer(torch, smi)
    print(json.dumps({"step": summary, "trainer": loop}))
    return 0


def moe(torch) -> int:
    """Phases 1, 2 and 13 alone: prints one JSON line of phase 13's launch
    counts and summary."""
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _cuda  # fails outside a checkout of the repo

    smi, _, _ = phase_card(torch)
    t0 = phase_build(_cuda)
    launches, summary = phase_moe(torch, smi)
    log(f"[time] [13] done at {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"launches": launches, "moe": summary}, default=str))
    return 0


def experts(torch) -> int:
    """Phases 1, 2 and 12 alone: prints one JSON line of phase 12's launch
    counts and summary."""
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _cuda  # fails outside a checkout of the repo

    smi, _, _ = phase_card(torch)
    t0 = phase_build(_cuda)
    launches, summary = phase_experts(torch, smi)
    log(f"[time] [12] done at {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"launches": launches, "experts": summary}, default=str))
    return 0


# ---------------------------------------------------------------------------
# Decode timing of two checkouts, side by side
# ---------------------------------------------------------------------------


def time_slice(torch, src: Path) -> int:
    """Phase 4's timing alone, of the ``repro_torch`` package under ``src``
    (no profile, no other phase): prints one JSON line of TTFT, generate
    time and decode ms/step (medians of ``TIMED_RUNS``) and the stream's
    digest."""
    import hashlib

    sys.path.insert(0, str(src))
    from repro_torch.kernels import _cuda

    _cuda.build()
    _, _, eng, prompts, greedy = _serving(torch)
    eng.generate(prompts, greedy)  # warm-up
    stream = eng.generate(prompts, greedy)
    ttft, t_gen, _ = _time_generate(eng, prompts, greedy, stream)
    print(json.dumps({"ttft_ms": ttft * 1e3, "generate_ms": t_gen * 1e3,
                      "ms_per_step": (t_gen - ttft) / (NEW_TOKENS - 1) * 1e3,
                      "stream": hashlib.sha256(stream.tobytes()).hexdigest()[:16]}))
    return 0


def pairs(other: Path, n: int) -> int:
    """Decode timing of this checkout against ``other`` (another commit's
    checkout, e.g. a ``git archive`` unpacked under ``_checkouts/``, which
    git ignores): ``n`` pairs of fresh processes, each running this file's
    :func:`time_slice` on one tree, in the order other, this / this, other
    by turns.  Prints each run, then one JSON line: per-pair decode ms/step
    and TTFT, this tree's wins, medians, the other tree's quartiles and the
    median per-pair ratio.  Fails if the greedy streams differ."""
    import numpy as np

    runs = {"other": [], "this": []}
    for i in range(n):
        order = (("other", other), ("this", ROOT))
        for side, tree in order if i % 2 == 0 else order[::-1]:
            t0 = time.perf_counter()
            p = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py"), "--time-slice",
                                str(tree / "src")], capture_output=True, text=True, timeout=900)
            if p.returncode:
                raise RuntimeError(f"{side} run {i} failed:\n{p.stdout[-2000:]}{p.stderr[-4000:]}")
            r = json.loads(p.stdout.strip().splitlines()[-1])
            runs[side].append(r)
            log(f"[pairs] pair {i} {side}: {json.dumps(r)} ({time.perf_counter() - t0:.0f} s)")
    step = {k: np.array([r["ms_per_step"] for r in v]) for k, v in runs.items()}
    ttft = {k: np.array([r["ttft_ms"] for r in v]) for k, v in runs.items()}
    streams = {r["stream"] for v in runs.values() for r in v}
    print(json.dumps({
        "pairs": n,
        "ms_per_step": {k: v.tolist() for k, v in step.items()},
        "ttft_ms": {k: v.tolist() for k, v in ttft.items()},
        "wins_step": int((step["this"] < step["other"]).sum()),
        "wins_ttft": int((ttft["this"] < ttft["other"]).sum()),
        "median_step": {k: float(np.median(v)) for k, v in step.items()},
        "median_ttft": {k: float(np.median(v)) for k, v in ttft.items()},
        "other_step_quartiles": np.percentile(step["other"], [25, 75]).tolist(),
        "median_step_ratio": float(np.median(step["this"] / step["other"])),
        "streams_equal": len(streams) == 1,
    }))
    return 0 if len(streams) == 1 else 1


# ---------------------------------------------------------------------------


def phase_build(_cuda) -> float:
    """Phase 2: build every kernel; returns the perf_counter at its start."""
    t0 = time.perf_counter()
    built = _cuda.build()
    log(f"[2] kernel build: {time.perf_counter() - t0:.1f} s "
        f"({', '.join(f'{k} {v:.1f} s' for k, v in built.items()) or 'cached'}) "
        f"into {_cuda.build_dir()}")
    return t0


def one_kernel(torch, kernel: str, src: Path) -> int:
    """Phases 1-2, then phase 3's rows of one kernel alone, of the
    ``repro_torch`` package under ``src``: prints one JSON line of those
    rows (time, host us, plain time, bound and library time per shape).
    A mismatch against the plain version raises, so the exit is non-zero."""
    sys.path.insert(0, str(src))
    from repro_torch.kernels import _cuda  # fails outside a checkout of the repo

    smi, _, peaks = phase_card(torch)
    phase_build(_cuda)
    if kernel == "paged_attention":
        res = phase_paged_attention(torch, peaks, {})[kernel]
    else:
        res = phase_kernels(torch, peaks, only=kernel)[kernel]
    print(json.dumps({
        "kernel": kernel, "src": str(src), "card": smi, "max_abs_err": res["max_abs_err"],
        "rows": [{"shape": list(key), **row} for key, row in res["rows"].items()],
    }))
    return 0


def serving(torch, src: Path) -> int:
    """Phases 1-2, 4, 6 and 8 of the ``repro_torch`` package under ``src``
    (no kernel rows, no cut comparisons), with their checks: prints one
    JSON line of phase 6's summary and phase 8's records."""
    sys.path.insert(0, str(src))
    from repro_torch.kernels import _cuda  # fails outside a checkout of the repo

    smi, _, _ = phase_card(torch)
    phase_build(_cuda)
    params, cfg, _, _ = phase_slice(torch)
    _, p_summary = phase_prefill(torch, params, cfg)
    cb_recs, _ = phase_continuous(torch, params, cfg)
    print(json.dumps({"src": str(src), "card": smi, "prefill": p_summary,
                      "continuous": cb_recs}, default=str))
    return 0


def main(torch) -> int:
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _cuda  # fails outside a checkout of the repo

    smi, name, peaks = phase_card(torch)
    t0 = phase_build(_cuda)

    def lap(phase):
        log(f"[time] {phase} done at {time.perf_counter() - t0:.1f} s")

    results = phase_kernels(torch, peaks)
    phase_paged_attention(torch, peaks, results)
    lap("[3]")
    params, cfg, prompts, launches = phase_slice(torch)
    lap("[4]")
    phase_cut(torch, params, cfg, prompts)
    lap("[5]")
    p_launches, p_summary = phase_prefill(torch, params, cfg)
    log(f"[6] summary: {json.dumps(p_summary)}")
    lap("[6]")
    cb_recs, cb_streams = phase_continuous(torch, params, cfg)
    lap("[8]")
    phase_continuous_cut(torch, params, cfg, cb_streams)
    lap("[9]")
    del params, prompts, cb_streams  # the serving phases' device memory, before training
    gc.collect()
    torch.cuda.empty_cache()
    t_summary = phase_train(torch, smi)
    phase_train_cut(torch)
    log(f"[10] summary: {json.dumps(t_summary)}")
    lap("[10]")
    l_summary = phase_trainer(torch, smi)
    log(f"[11] summary: {json.dumps(l_summary)}")
    lap("[11]")
    e_launches, e_summary = phase_experts(torch, smi)
    log(f"[12] summary: {json.dumps(e_summary, default=str)}")
    lap("[12]")
    m_launches, m_summary = phase_moe(torch, smi)
    log(f"[13] summary: {json.dumps(m_summary, default=str)}")
    lap("[13]")
    s_launches, s_summary = phase_swa(torch, smi)
    log(f"[14] summary: {json.dumps(s_summary, default=str)}")
    lap("[14]")
    l_launches, l_summary = phase_mla(torch, smi)
    log(f"[15] summary: {json.dumps(l_summary, default=str)}")
    lap("[15]")
    c_launches = cb_recs["a"]["launches"]

    status = [{"name": n, "replaces": rep,
               "status": "ported" if src else "to port",
               **({"checked": n in results} if src else {})}
              for n, rep, src in TPU_KERNELS]
    log("[7] kernel status: " + json.dumps(status))

    # each kernel's row in the record: the shape its path runs most (the
    # decode GEMVs at the decode tier's 4 rows; the prefill kernels at the
    # 8192 prefill rows, against q/k/v/o for w1a8_matmul and on the
    # path's f32 rows for rmsnorm_quant; paged_attention at phase 8's
    # decode shape); launches from each path's counted run: [4] decode,
    # [6] prefill, [8] continuous batching in configuration (a), [12] the
    # routed experts' (a) decode, (b) prefill and (c) kernel-route runs,
    # [13] deepseek-moe-16b's (b) decode, (c) prefill and generate and (d)
    # kernel-route runs, [14] gemma3-27b's (b) generate and (c) kernel-route
    # run and h2o-danube-1.8b's (e) generate, [15] deepseek-v2-236b's (b)
    # decode and (c) prefill generates and (d) paged run
    main_key = {
        "w1a8_gemv": (MAIN_ROWS,) + W1A8_SHAPES[0],
        "decoupled_gemv": (MAIN_ROWS,) + DECOUPLED_SHAPE,
        "int8_matmul": (PREFILL_MAIN_ROWS,) + INT8_SHAPE,
        "w1a8_matmul": (PREFILL_MAIN_ROWS,) + W1A8_SHAPES[0],
        "decoupled_matmul": (PREFILL_MAIN_ROWS,) + DECOUPLED_SHAPE,
        "rmsnorm_quant": (PREFILL_MAIN_ROWS, D_MODEL, "f32"),
        "paged_attention": ("decode", 1, PA_HEADS, PA_HEADS, "float32"),
    }
    record = []
    for n, rep, src in TPU_KERNELS:
        if not src:
            continue
        res = results[n]
        key = main_key[n]
        by_path = {"decode": launches.get(n, 0), "prefill": p_launches.get(n, 0),
                   "continuous": c_launches.get(n, 0), "experts": e_launches.get(n, 0),
                   "moe": m_launches.get(n, 0), "swa": s_launches.get(n, 0),
                   "mla": l_launches.get(n, 0)}
        record.append({
            "name": n, "route": "cuda", "source": src, "replaces": rep,
            "shape": list(key), "launches": sum(by_path.values()), "launches_by_path": by_path,
            "max_abs_err": res["max_abs_err"], **res["rows"][key],
        })
    print(json.dumps({"kernels": record}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser(description="Smoke test of the port on one CUDA card.")
    ap.add_argument("--pairs", nargs=2, metavar=("CHECKOUT", "N"),
                    help="time decode against another checkout in N alternating pairs")
    ap.add_argument("--kernel", choices=[n for n, _, _ in TPU_KERNELS],
                    help="phases 1-2 and this kernel's phase-3 rows only")
    ap.add_argument("--serving", action="store_true",
                    help="phases 1-2, 4, 6 and 8 only (end-to-end serving; run on two trees "
                    "by turns to time a kernel's redesign against its parent)")
    ap.add_argument("--src", metavar="SRC", help="with --kernel or --serving: the src/ tree "
                    "to import repro_torch from (default: this checkout's)")
    ap.add_argument("--train", action="store_true",
                    help="phases 1, 10 and 11 only (training; no kernel build)")
    ap.add_argument("--experts", action="store_true",
                    help="phases 1, 2 and 12 only (pquant-1.3b with 8 routed experts)")
    ap.add_argument("--moe", action="store_true",
                    help="phases 1, 2 and 13 only (deepseek-moe-16b)")
    ap.add_argument("--swa", action="store_true",
                    help="phases 1, 2 and 14 only (gemma3-27b, h2o-danube-1.8b)")
    ap.add_argument("--mla", action="store_true",
                    help="phases 1, 2 and 15 only (deepseek-v2-236b: MLA)")
    ap.add_argument("--time-slice", metavar="SRC", help=argparse.SUPPRESS)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        sys.exit(2)
    if args.time_slice:
        sys.exit(time_slice(torch, Path(args.time_slice)))
    if args.train:
        sys.exit(train(torch))
    if args.experts:
        sys.exit(experts(torch))
    if args.moe:
        sys.exit(moe(torch))
    if args.swa:
        sys.exit(swa(torch))
    if args.mla:
        sys.exit(mla(torch))
    src = Path(args.src).resolve() if args.src else ROOT / "src"
    if args.kernel:
        sys.exit(one_kernel(torch, args.kernel, src))
    if args.serving:
        sys.exit(serving(torch, src))
    if args.pairs:
        sys.exit(pairs(Path(args.pairs[0]).resolve(), int(args.pairs[1])))
    sys.exit(main(torch))
