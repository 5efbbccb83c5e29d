"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Imports nothing of JAX or of the JAX package. Phases, each printing JSON:

  1. device  — needs CUDA (exits non-zero without it); prints the card's
               name and power limit as nvidia-smi reports them.
  2. build   — compiles every CUDA source of the port with nvcc, in
               parallel (one nvcc per source), from the checkout alone.
  3. kernels — each kernel against its plain PyTorch version on the card,
               at the main path's shapes, with its tolerance; median times
               of kernel, plain version and a one-call PyTorch yardstick
               (``library_ms``, never used by the port), and the bound:
               the larger of bytes moved / 3.35 TB/s and flops / 67 TFLOP/s
               (f32 outside the tensor cores; H100 SXM data sheet).
               Every case also gives the bound of the kernel's own
               arithmetic (``bound_pieces_ms``: three bf16 products on
               the tensor cores at 989 TFLOP/s for crossbar, three TF32
               products at 495 TFLOP/s for flash and the chunked wkv
               kernel, beside the latter's f32 SIMT work), the kernel's device
               time from a profiler trace (``device_ms``; crossbar: cold,
               over copies of the weight that exceed the L2, for M <= 128,
               warm beside it), the yardstick's device time
               (``library_device_ms``; for flash with the SDPA kernels that
               ran), the host's time to issue one call, and both crossbar
               kernels forced at M = 8 .. 1024 on one shape (the
               crossover). Flash: contiguous prefill and decode; paged
               mixed (chunked prefill) and decode (a pure decode tick).
               Crossbar and flash also at the paper models' shapes: their
               three K/N pairs (1-4 MB of codes) at M = 8 and 1024, and
               every flash case at 16 query and 16 kv heads (a group of 1).
               wkv: decode, a prefill chunk of 128, a ragged chunk, small
               decays with exact zeros, a 512-token prompt, each on the
               kernel the wrapper picks (the register recurrence below
               T = 8, the chunked tensor-core kernel from there on), and
               both kernels forced at T = 1 .. 128 (the crossover).
               The train step's backward kernels, at the shapes one of its
               microbatches (2 of 4 x 512 tokens) gives them:
               ``crossbar_matmul_t`` (dx = g . dequant(W)^T) at M = 1024
               on llama3.2-1b's and the paper models' (K, N) pairs
               against ``torch.matmul(g, W_deq.T)``, and llama's pairs
               also at the whole batch's M = 2048; ``flash_attention_bwd``
               at B = 2,
               T = S = 512 causal with 32/8 and 16/16 heads against SDPA's
               backward, llama's heads also at B = 4, and with a window
               and a softcap on a small shape. Each backward case's line
               also gives ``before_device_ms``, its device time before the
               kernels' Hopper redesign, copied from PERF.md (not measured
               here; ``before_from`` says so). A case whose trace holds
               no kernel of its names (``device_ms`` 0) fails. (The wkv
               backward kernel's cases come after the train phase, in
               phase 6.) Then gemma2-9b's (since slice 14): the crossbar
               at its five (K, N) pairs at M = 8 and 1024; flash at head
               dim 256 with 16 query and 8 kv heads and softcap 50:
               contiguous prefill of 4608 tokens with the 4096 window and
               decode over 4640 keys, paged mixed (chunks of 128) and
               decode (tables 320 wide), and the ring kernel
               (``ring_flash_attention``: rings of 4096 read with the
               chunk's own keys) with a chunk of 128 and at decode; and
               flash at head dim 128 (32/8 heads), a 512-token prefill
               and 8 decode rows over 1024 keys. SDPA has no softcap, so
               the gemma cases have no library time. Then the MoE models'
               (since slice 15): ``grouped_crossbar_matmul`` on
               llama4-scout-17b-a16e's 16 expert stacks of (5120, 8192)
               and (8192, 5120) and mixtral-8x22b's 8 of (6144, 16384)
               and (16384, 6144), int8 and int4, at 8 decode rows on 8
               distinct experts and on one expert, and 1024 prefill rows
               spread uniformly and skewed with one expert empty, each on
               the kernel the MoE layer picks; every row past a slot's
               count must be 0; the bound counts only the experts hit;
               the library time is ``torch.bmm`` over the JAX package's
               dropless buffer (C = T rows per slot) with the dequantized
               stack. Then flash at head dim 128 with 40/8 heads
               (llama4-scout, a GQA group of 5) and 48/8 (mixtral, a group
               of 6: its 4400-token prefill with the 4096 window, and the
               ring kernel on rings of 4096; SDPA over the gathered [ring ;
               chunk] K/V with the visibility mask is its library time).
               Then (since slice 16) flash at the heads of the three
               head-dim-128 forwards: 48/8 (internlm2-20b), 32/8
               (mistral-nemo-12b) and 64/8 (chameleon-34b, a GQA group of
               8): contiguous prefill of 512 tokens and 8 decode rows over
               1024 keys, paged mixed and decode, each against SDPA. At
               head dims 128 and 256 the flash cases run ``wg_body`` (wgmma;
               decode through the work list over the live keys). Then
               jamba-1.5-large-398b's (since slice 17): ``selective_scan``
               at d_in 16384 and d_state 16 (a decode tick on 8 slots,
               the n-gram verify tick of 5 steps, a 128-token chunk on 8
               slots, the same ragged with one row idle, a 512-token and
               a 4096-token prompt; the register kernel below
               ``CHUNK_MIN_T``, the tiled kernel from it, since slice
               19), within 1e-5 of max |y| and of max |h_final|, the same
               bits twice, one launch a call, bound by the largest of
               bytes, f32 operations and exponentials (16 a clock per
               SM at the card's maximum SM clock), no library time; the crossbar at its Mamba projections
               (8192 x 32768, 16384 x 8192) at M = 8 and 1024; the grouped
               crossbar decoding 8 tokens top-2 over its 16 expert stacks
               of (8192, 24576) and (24576, 8192). Then the MoE decode's
               (since slice 18; the grouped decode kernel runs a work
               list over the live row groups, and llama4-scout's grouped
               cases add 8 tokens top-2): ``moe_route`` and
               ``moe_combine`` at llama4-scout's, mixtral's and jamba's
               routers (16 / 8 / 16 experts, top-1 / 2 / 2) at a decode
               tick (8 tokens) and a mixed tick (8 x 128 with the
               engine's ragged chunk lens), each against its plain
               version on the card (``moe_ops.compare_routes``: ids where
               the plain margin is >= 1e-5, rows, bases, counts and
               buffer rows bit-equal, gates, weights and aux within 1e-6;
               the combine within 1e-6 of max |y|), the same bits twice,
               with the plain version's device ms and kernels a call
               beside, bound by bytes, no library call; then a whole
               dropless MoE layer at full width (llama4-scout at both
               ticks, mixtral at decode) against ``streamed_moe`` within
               1e-4 of max |y| on the real tokens, its device ms and
               kernels a call.
  4. serve   — for each model the port serves, full width and full depth
               (random weights from a seed), on an M8F8 crossbar base with
               two rank-32 adapters, served by the port's paged engine: 8
               greedy requests (prompts 64-512 tokens, two sharing a
               256-token prefix), 32 new tokens each. Then two requests
               are teacher-forced through ``forward`` with the kernels
               and, as the reference, with the plain versions (dequantized
               weights, ``ref_attention``, the plain wkv recurrence); the
               engine's sampled logits and the kernel forward's logits
               must agree with the reference. Each path has its own
               launch counts: the counters are zeroed just before the
               engine serves and read just after, then zeroed just before
               the kernel forwards and read just after; each kernel of the
               path must show exactly its launches per tick (engine) or
               per forward. Models, in order:
                 llama3.2-1b — crossbar + paged flash (engine), crossbar +
                               contiguous flash (forward); the prefix
                               cache serves the shared prefix;
                 gemma2-9b   — 42 layers at d 3584, ``max_len`` 5120,
                               two of the eight prompts 4300-4800 tokens
                               long (past the 4096 window: the rings wrap):
                               crossbar + paged flash on the 21 global
                               layers + the ring kernel on the 21 sliding
                               ones (engine), crossbar + contiguous flash
                               (forward: the long request and a short
                               one); the prefix cache is off (per-slot
                               rings); a traced window of 8 graph decode
                               ticks gives the device ms of crossbar,
                               paged and ring flash; its engine is freed
                               before the plain reference (the f32
                               weights need its memory);
                 rwkv6-7b    — crossbar + wkv (engine and forward: the
                               chunked kernel for the prompts' chunks, the
                               recurrence for decode steps, never the
                               chunked one in a pure decode tick); the
                               prefix cache is off (recurrent state);
                 paper-gpt2-medium, paper-bloom-560m — the paper's own
                               models (LayerNorm, 16/16 heads, a tanh-GELU
                               MLP: six crossbar matrices per layer;
                               vocabularies of 50257 and 250880), as
                               llama3.2-1b;
                 llama4-scout-17b-a16e — ``moe_serve_phase``: d 5120, 40/8
                               heads of 128 with qk-norm, 16 experts of
                               8192 (top-1) and a shared expert, a
                               vocabulary of 202048, at 24 of its 48
                               layers (the M8F8 codes of all 48 take 106
                               GB), its base drawn and quantized one layer
                               at a time; per tick exactly 168 crossbar
                               (attention and shared expert), 72 grouped
                               (the expert stacks), 24 paged flash, and
                               (since slice 18) 24 ``moe_route`` and 24
                               ``moe_combine`` launches (the kernel
                               forward likewise per forward); a traced
                               window of 8 graph decode
                               ticks; the engine freed, two requests
                               teacher-forced through the kernels and
                               through ``streamed_reference`` (one layer's
                               dequantized f32 weights at a time), both
                               paths' MoE routing recorded
                               (``moe.ROUTES``, the engine's through
                               ``EngineRoutes``): every routing flip
                               against the reference is listed with the
                               reference's top-k margin (a flip at a
                               margin of ``FLIP_MARGIN`` or more fails),
                               and the logits are held to 1e-3 at every
                               position before a path's first flip;
                 jamba-1.5-large-398b — ``moe_serve_phase`` at one scan
                               period, 8 of its 72 layers (1 attention
                               with 64/8 heads of 128, 7 Mamba with d_in
                               16384 and d_state 16, 16 experts of 24576
                               top-2 on 4 of them; the M8F8 codes of one
                               period take 48.8 GB, two would not fit),
                               adapters also on mamba_in and mamba_out;
                               per tick exactly 30 crossbar, 12 grouped,
                               1 paged flash, 7 ``selective_scan``, 4
                               ``moe_route`` and 4 ``moe_combine``
                               launches; the prefix cache off (per-slot
                               Mamba state); the reference streams each
                               MoE layer one expert at a time
                               (``streamed_moe``) and runs the Mamba
                               layers' plain conv and scan; then n-gram
                               speculation (k = 4, 32 new tokens) on the
                               same geometry, its logits and routing held
                               to the streamed reference, with a
                               recurrent rollback of the Mamba state.
                               After its serve (since slice 19), two
                               waves of 8 prompts of 256 tokens on the
                               engine, the second's two mixed ticks
                               traced as replays (``mixed_window``:
                               the 7 scans' device ms of a mixed tick).
               The engine runs its mixed step as CUDA graphs, one per
               (chunk, table) signature: the first tick of a signature
               eagerly, then captured; every later tick by replay (each
               replay adds its graph's launches to the counts). The serve
               line reports the graphs captured, the replays, the capture
               time and the graphs' pool bytes, and the phase fails unless
               every tick was a capture or a replay. A traced window of
               replays must hold every port launch the replays counted;
               a trace can drop a kernel record inside a replay, so a
               short window is traced again on the next ticks (the next
               wave for ``mixed_window``), ``TRACE_ATTEMPTS`` windows in
               all, each window's counts kept in its ``attempts``.
               llama3.2-1b is then served again, by the dense oracle engine
               (``serve_dense`` line: the same weights, adapters and
               requests, ``max_batch`` 8, a 1024-position arena): each
               prompt prefilled whole, then one decode step over every
               slot a tick, captured as one CUDA graph at the first
               decode tick and replayed after it; its sampled logits
               against the teacher-forced plain forward (1e-3), its
               crossbar and contiguous flash launches exact, its KV bytes
               beside the paged engine's.
               Speculative decoding (``spec`` lines) after the serve of
               llama3.2-1b and rwkv6-7b, on the same adapters and requests,
               with ``record_logits``: llama3.2-1b with the n-gram drafter
               (k = 4, 32 new tokens) over the M8F8 base, then with the
               int4 self-drafter (k = 4, 16 new tokens) over the
               dequantized f32 base (the self-drafter takes no quantized
               base); rwkv6-7b with the n-gram drafter (k = 4, 32 new
               tokens). Every emitted token's logits row against the
               teacher-forced plain forward of the request's own tokens
               (1e-3; rwkv6-7b 2e-2 of the largest logit); every tick a
               verify-graph capture or replay; the launches exact per
               tick (the target) and per draft call (the drafter: k
               forwards of int4 crossbar and contiguous flash), its draft
               graphs captured once a signature and replayed; rwkv6-7b
               must have a recurrent rollback. Reported: accept rate,
               drafted, accepted and rolled-back tokens, rolled-back
               pages, decode tok/s and ms a decode tick beside the serve
               phase's (spec off), and ``tokens_equal_spec_off``. Then
               prefix persistence (``persist`` line, llama3.2-1b): the
               serve phase's engine saves its index under ``build/``, a
               new engine loads it (pages loaded = pages saved, bit-equal
               to the file) and serves a shared-prefix request alone: a
               hit on its first tick, its logits within 1e-3, its launches
               exact.
               Each model's engine and weights are freed before the next.
     profile — after the serve of llama3.2-1b, rwkv6-7b and
               paper-gpt2-medium, three more waves of 8 prompts of 256 on
               the same engine: the first captures every signature the
               waves meet; the second runs the engine's eager step, the
               third replays the graphs (the same signatures, so the same
               work). Each of those two: its first (mixed) tick untraced
               (host wall), its second traced under torch.profiler with
               CUDA activity only; once every slot decodes, a window of
               ticks untraced, then the next window traced. Each traced
               window: device busy share (device time over wall, both of
               that window), time by kernel, and the crossbar's, flash's
               and wkv's device time and shares of it; a
               ``profile_compare`` line puts eager and graph side by side.
     forward — after the serves (``forward_phase``), teacher-forced
               forwards at full width, kernels against the plain versions
               (1e-3 on every position's logits before a routing flip),
               launches exact: mixtral-8x22b at 2 of its 56 layers (top-2
               over 8 experts with renormalised gates; a 4400-token prompt
               past its 4096 window, then 4 decode steps over the ring),
               musicgen-medium at full depth from precomputed embeddings
               (48 layers, d 1536, 24/24 heads of 64, LayerNorm, GELU);
               since slice 16, at 8 layers each, a 512-token prompt and 4
               decode steps: internlm2-20b (d 6144, 48/8 heads of 128),
               mistral-nemo-12b (d 5120, 32/8 heads of 128: a query width
               of 4096 below d_model) and chameleon-34b (d 8192, 64/8
               heads of 128 with qk-norm, from precomputed embeddings).
  5. train   — after the served models, each freed before and after:
               llama3.2-1b, then paper-gpt2-medium, then rwkv6-7b, at
               full width and depth on an M8F8 base with one rank-32
               adapter on wq/wv (rwkv: r_proj/v_proj; B drawn non-zero),
               SyntheticLM batches of 4 x 512 in 2 microbatches, AdamW at
               lr 1e-3 with warmup-cosine. The first step's loss and every
               LoRA gradient through the kernels against the plain
               versions' (dequantized weights, torch.matmul, ref
               attention, the plain wkv recurrence, autograd) on the card:
               relative 1e-4 on the loss, relative L2 1e-3 per leaf; then
               5 steps' losses the same way; every step's launches of
               crossbar_matmul, crossbar_matmul_t, flash_attention and
               flash_attention_bwd (rwkv: rwkv6_wkv_chunk and
               rwkv6_wkv_bwd) held exactly. rwkv6-7b's gradients are
               ill-conditioned at depth, so its checks run on a 2-layer
               model at full width (``CHECK_LAYERS``), with bounds of
               1e-3 on the losses and 5e-3 per leaf set from the
               gradients' measured sensitivity, and the rest at all 32
               layers. Then the path: 20 steps (rwkv6-7b
               10)
               through the port's ``Trainer`` (its batches, its adapter
               init, an async checkpoint every 10 steps into
               ``build/chip_smoke_ckpt/``), with the launch counts zeroed
               just before and read just after: step ms and the loss curve
               from its metrics log, tokens/s, peak memory; then 6 steps
               of the same step function without the Trainer (the
               Trainer's own host cost). A second
               ``Trainer`` restores step 20 onto the card (bit-equal
               adapters and moments), and ``run_with_restarts`` survives a
               step that fails once: the re-run step's loss equals the
               first try's. One more step of the first trainer, traced,
               gives the device busy share and the device ms by kernel,
               with CPU activity and a profiler range around each port
               launch, so that each launch whose kernel record the trace
               lost is named by its enclosing range (``lost_by_range``),
               the shortfall beside the numbers; a trace that lost a
               training kernel's records is taken again with another
               step, up to 3 times (the phase fails if the third is still
               incomplete); rwkv6-7b's trace is also retaken if it lost a
               wkv backward launch, and must show the chunked wkv
               backward kernel. Then ``remat_check``: one
               step's loss and LoRA gradients with ``ExecConfig.remat``
               off and on, bit-equal (GPT-2's with weight noise), the
               launches held exactly (each forward kernel twice with
               remat), and the peak memory of each.
               GPT-2 then takes two noise-aware ``Trainer`` steps
               (sigma_rel 0.02): finite losses and no crossbar launch
               (noisy weights are dense products, as in JAX). Then GPT-2
               again on an M4F4 base (its ``train`` line says ``"base":
               "M4F4"``), int4 codes through ``crossbar_matmul`` and
               ``crossbar_matmul_t``: the same checks, with 10 ``Trainer``
               steps and the restore of step 10.
  6. kernels — after the train phase (so that the serve and train
               phases follow the same kernel cases as before these were
               added), in a process of their own (``late_kernel_phase``:
               after the train phase's traces a trace in the same process
               loses kernel records), the same checks for the int4 and
               Fig. 13 cases:
               ``crossbar_matmul`` in int4 at the paper models' shapes,
               int8 and int4 at the Fig. 13 fine-tunes' matrices ((128,
               128), (128, 512), (512, 128) at M = 16 x 64);
               ``crossbar_matmul_t`` in int4 at the microbatch shapes,
               int8 and int4 at Fig. 13's. Then the wkv backward kernels
               (``rwkv6_wkv_bwd``) against ``rwkv6_wkv_bwd_plain``, each
               gradient within 1e-4 of its max |.| and two calls giving
               the same bits: the chunked kernel at one rwkv6-7b train
               microbatch (B 2, T 512, H 64, N 64), the same with a row
               masked past 300 steps, and small decays with exact zeros;
               the recurrence at N = 32 and, as the "before" case, at the
               microbatch (``kernel="recurrent"``).
  7. figures — the paper's Fig. 9 (``benchmarks/torch_noise.py``) and
               Fig. 13 (``benchmarks/torch_quant_perplexity.py``) at their
               full protocols, and the serving-throughput workloads 1-3 and
               5 and 6 at their smoke sizes
               (``benchmarks/torch_serve_throughput.py``; workload 3
               speculates with the n-gram drafter, workload 5 serves
               reduced llama4-scout dropless against the capacity
               baseline, which must drop, workload 6 speculates on reduced
               jamba, which must roll its Mamba state back),
               each with the counts zeroed just before and read just
               after: one line each with its payload and seconds; fails on
               a non-finite number, a greedy check that fails or a kernel
               of its path with no launch. Then 20 Fig. 13 fine-tune steps
               on an M4F4 base with their launches held exactly.
  8. summary — the whole script's seconds, one ``{"kernels": [...]}``
               line (the backward kernels' launches from llama's train
               run, the wkv backward's from rwkv6-7b's, every path's count
               beside each kernel's), the nvidia-smi line, and last
               ``{"ok": true, "device": {...}}``.

Any failed phase raises (exit code 1) and the last line is never printed.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12      # H100 SXM, data sheet
F32_FLOPS_PER_S = 67e12        # H100 SXM f32 outside the tensor cores
BF16_FLOPS_PER_S = 989e12      # H100 SXM bf16 tensor cores, dense
TF32_FLOPS_PER_S = 495e12      # H100 SXM tf32 tensor cores, dense

CB_TOL = 1e-4                  # relative to max|y|: f32 sums, other order
FA_TOL = 2e-5                  # f32 softmax attention, other order
# flash backward: relative and absolute, as tests/test_attention.py holds
# the JAX package's custom VJP to ref_attention's gradients
FA_BWD_TOL = 1e-4
WKV_TOL = 1e-5                 # the f32 recurrence, each step's sums in
                               # another order (as for the Pallas kernel)
# selective scan: relative to max |y| and to max |h_final| (the same f32
# recurrence with fused multiply-adds, each y a dot product over the N
# states summed in another order)
SCAN_TOL = 1e-5
# engine and kernel forward vs the plain forward. llama3.2-1b: absolute,
# on logits of magnitude ~5 (16 f32 layers summed in other orders).
# rwkv6-7b: relative to the largest plain logit. Its 32 random-init layers
# amplify the ~1e-6 relative differences of f32 kernels that sum in
# another order, most at the first tokens of a sequence (there the wkv
# state holds one token, and each head's group-normed output is a scalar
# r.(u*k) times v, whose sign flips where that scalar is near 0), and more
# with every layer. At the positions checked (the last prompt token, the
# generated ones) that came to ~1e-2 of the largest logit on one NVIDIA
# H100 80GB HBM3 at 700 W (0.036 at max |logit| 4.49); the serve phase's
# logit_error_by_depth shows the growth by depth and along the prompt. A
# fault (a wrong decay, state carried wrongly) moves logits by their size.
LOGIT_TOL = 1e-3
RWKV_LOGIT_TOL_REL = 2e-2
# train step, kernels vs plain versions (dequantized weights, torch.matmul,
# ref attention, autograd) on the same state: the loss, relative; each
# LoRA leaf's gradient, relative L2 (f32 through 16-24 layers summed in
# other orders)
TRAIN_LOSS_TOL_REL = 1e-4
TRAIN_GRAD_TOL_REL = 1e-3
# rwkv6-7b at full width, on its first ``CHECK_LAYERS`` layers. Its LoRA
# gradients at random init are ill-conditioned: on one NVIDIA H100 80GB
# HBM3 at 700 W (``benchmarks/torch_rwkv_conditioning.py --grads``, one
# 2 x 512 microbatch), a 1e-6 relative weight perturbation moves them by
# up to 2.1e-4 at 2 layers, 2.5e-3 at 4 and 0.15 at 8 (llama3.2-1b: 1.2e-5
# at all 16), and a 2^-16 one (the crossbar kernels' two-bf16-piece split
# of their operand) by 2.0e-3, 0.091 and 2.1; 5 AdamW steps' losses by up
# to 3.3e-4 at 2 layers. At 8 layers no bound would tell a fault from
# rounding, so the check runs at 2, bounded at 2.5x and 3x the 2^-16
# movement; a fault (a wrong decay or dw) moves the gradients by their
# size.
RWKV_TRAIN_LOSS_TOL_REL = 1e-3
RWKV_TRAIN_GRAD_TOL_REL = 5e-3


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def ptxas_report(log: str) -> dict:
    """Registers a thread and spill bytes of each kernel, from one
    source's ``nvcc -Xptxas=-v`` output, by kernel name (demangled with
    ``c++filt`` where the toolkit's host has it)."""
    import re

    out, name = {}, None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            name = m.group(1)
            out[name] = {}
        elif name is not None:
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                          ln)
            if m:
                out[name]["spill_stores"] = int(m.group(1))
                out[name]["spill_loads"] = int(m.group(2))
            m = re.search(r"Used (\d+) registers", ln)
            if m:
                out[name]["registers"] = int(m.group(1))
    if out and shutil.which("c++filt"):
        names = list(out)
        plain = subprocess.run(["c++filt"], input="\n".join(names),
                               capture_output=True, text=True,
                               timeout=60).stdout.splitlines()
        if len(plain) == len(names):
            out = {p.replace("(anonymous namespace)::", ""): out[n]
                   for n, p in zip(names, plain)}
    return out


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0]


def timed(fn, reps: int, warmup: int = 2) -> float:
    """Median device milliseconds of ``fn()`` over ``reps`` runs."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def device_ms(fn, reps: int = 10) -> float:
    """Device milliseconds of the kernels that one ``fn()`` launches, from
    a torch.profiler trace of ``reps`` calls (CUDA activity only). Unlike
    ``timed``, this leaves out the host's time to issue the call, which
    dominates a small kernel's wall time on the stream."""
    return device_ms_by_name([fn] * reps, None)


def device_ms_by_name(fns, names) -> float:
    """Mean device milliseconds per call of ``fns`` (each called once, in
    order, under torch.profiler with CUDA activity only), counting only
    the kernels whose name holds one of ``names`` (all kernels if None)."""
    return sum(device_ms_per_kernel(fns, names).values())


@contextlib.contextmanager
def cuda_trace(cpu: bool = False):
    """``torch.profiler`` with CUDA activity (and CPU activity, where
    ``cpu``: the aten ops and ``record_function`` ranges), around the
    body. On the
    H100 a trace can lose the kernel records of the launches in its first
    milliseconds and of its last ones, though the kernels ran; an eager
    tick's first few launches after an idle pause can lose theirs too
    (``benchmarks/torch_trace_edges.py`` counts all three). So the body
    stands between two margins, each a marker kernel (``torch.cuda._sleep``,
    which ``device_events`` and ``lost_launches`` leave out), a
    synchronisation and ``TRACE_MARGIN_S`` of idle host."""
    from torch.profiler import ProfilerActivity, profile

    def margin():
        torch.cuda._sleep(MARGIN_CYCLES)
        torch.cuda.synchronize()
        time.sleep(TRACE_MARGIN_S)

    torch.cuda.synchronize()
    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if cpu else [])
    with profile(activities=acts) as prof:
        margin()
        yield prof
        torch.cuda.synchronize()
        margin()


def device_events(prof):
    """The device-side events (kernels, copies) of a ``cuda_trace``, its
    margins' marker kernels and the device spans of ``record_function``
    ranges (``named_launchers``) left out."""
    from torch.autograd import DeviceType

    return [e for e in prof.events() if e.device_type == DeviceType.CUDA
            and MARGIN_KERNEL not in e.name
            and not getattr(e, "is_user_annotation", False)
            and not e.name.startswith("port::")]


def lost_launches(prof) -> int:
    """Kernel launches in a ``cuda_trace`` whose kernel record the trace
    lacks (``lost_by_range``)."""
    return sum(lost_by_range(prof).values())


def device_ms_per_kernel(fns, names=None) -> dict:
    """As ``device_ms_by_name``, by kernel name (a port kernel's name must
    follow "(anonymous namespace)::")."""
    fns[0]()
    with cuda_trace() as prof:
        for fn in fns:
            fn()
    out = {}
    for e in device_events(prof):
        if names is None or any(f"(anonymous namespace)::{n}" in e.name
                                for n in names):
            out[e.name] = out.get(e.name, 0.0) + e.time_range.elapsed_us()
    return {k: us / 1e3 / len(fns) for k, us in out.items()}


def bound_ms(nbytes: float, flops: float) -> float:
    return 1e3 * max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S)


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------


# (K, N) of each model's crossbar-quantized layer matrices
LLAMA_KN = ((2048, 2048), (2048, 512), (2048, 8192), (8192, 2048))
RWKV_KN = ((4096, 4096), (4096, 14336), (14336, 4096))
# GPT-2-medium and BLOOM-560m: wq/wk/wv/wo, w1, w2
PAPER_KN = ((1024, 1024), (1024, 4096), (4096, 1024))
# gemma2-9b: wq, wk/wv, wo, w1/w3, w2
GEMMA_KN = ((3584, 4096), (3584, 2048), (4096, 3584), (3584, 14336),
            (14336, 3584))
# llama4-scout-17b-a16e's and mixtral-8x22b's expert matrices (w1/w3, w2)
LLAMA4_KN = ((5120, 8192), (8192, 5120))
MIXTRAL_KN = ((6144, 16384), (16384, 6144))
# jamba-1.5-large-398b's Mamba projections (in_proj, out_proj) and expert
# matrices (w1/w3, w2)
JAMBA_MAMBA_KN = ((8192, 32768), (16384, 8192))
JAMBA_KN = ((8192, 24576), (24576, 8192))
# the crossbar kernels' own names in a profiler trace
CB_KERNELS = ("crossbar_decode_kernel<", "crossbar_prefill_kernel<")
# the grouped entry point's: at decode the work list over the live row
# groups, at prefill the prefill kernel's body over slots' rows
GROUPED_KERNELS = ("grouped_live_decode_kernel<", "grouped_prefill_kernel<")
# the MoE layer's routing and layout, and its combine (csrc/moe_route.cu)
ROUTE_KERNELS = ("moe_route_kernel",)
COMBINE_KERNELS = ("moe_combine_kernel",)
# the flash kernels' (both entry points): flash_kernel<D, false> runs row
# tiles (prefill, chunks; wgmma from D = 128), flash_kernel<D, true> the
# warp split (decode, G*T <= 16 rows) at D <= 64; from D = 128 decode (G*T
# <= 8 rows) is flash_decode_kernel<D, RP> (f32 on the CUDA cores, the
# work list over the live keys)
FA_KERNELS = ("flash_kernel<", "flash_decode_kernel<")
# the ring entry point's kernels (their names hold FA_KERNELS' as a part:
# every match on them goes through the "(anonymous namespace)::" prefix)
RING_KERNELS = ("ring_flash_kernel<", "ring_flash_decode_kernel<")
# the backward kernels: the transposed crossbar read; flash's D_i, dk/dv
# and dq kernels
CB_T_KERNELS = ("crossbar_t_kernel<",)
FA_BWD_KERNELS = ("flash_bwd_",)
# the train phase's batch (sequences x tokens) and its microbatches; the
# backward kernels' cases take the shapes one microbatch gives them
TRAIN_BATCH, TRAIN_SEQ, TRAIN_MICROBATCHES = 4, 512, 2
TRAIN_MB = TRAIN_BATCH // TRAIN_MICROBATCHES        # sequences: 2
TRAIN_M = TRAIN_MB * TRAIN_SEQ                      # rows: 1024
L2_BYTES = 50e6                # H100 SXM L2; cold timings rotate past it
COLD_BYTES = 100e6             # codes touched between two uses of a weight
# each end of a profiler trace: a marker kernel (its name in the trace) of
# about a microsecond, then idle host time (``cuda_trace``)
MARGIN_KERNEL = "spin_kernel"
MARGIN_CYCLES = 2000
TRACE_MARGIN_S = 0.05
# traced windows a serve may take in all when a window's trace lost a port
# kernel's record (``traced_ticks``)
TRACE_ATTEMPTS = 3
# the runtime and driver calls that launch one kernel, as a trace names them
LAUNCH_API = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
              "cuLaunchKernelEx")
DECODE_M = 128                 # cases up to this M are also timed cold


def cold_copies(qt):
    """Distinct copies of ``qt`` with at least COLD_BYTES of codes, so that
    each call in a rotation finds its weight outside the L2, as every
    layer's weight is in the engine."""
    from repro_torch.core import quant
    n = max(2, int(np.ceil(COLD_BYTES / qt.codes.numel())))
    return [qt] + [quant.QuantizedTensor(qt.codes.clone(), qt.scales.clone(),
                                         qt.bits, qt.block, qt.orig_shape)
                   for _ in range(n - 1)]


def host_us(fn, reps: int = 200) -> float:
    """Host microseconds to issue one ``fn()`` (no synchronisation inside
    the loop; the device keeps up with these small kernels)."""
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(reps):
        fn()
    dt = time.perf_counter() - t
    torch.cuda.synchronize()
    return 1e6 * dt / reps


def crossbar_case(dev, g, model, bits, K, N, M, qt, w_deq, kernel="auto"):
    from repro_torch.kernels.crossbar_matmul import ops as cb_ops

    x = torch.randn(M, K, generator=g, device=dev)
    y = cb_ops.crossbar_matmul(x, qt, kernel=kernel)
    y_plain = cb_ops.crossbar_matmul_plain(x, qt)
    torch.cuda.synchronize()
    err = float((y - y_plain).abs().max())
    tol = CB_TOL * float(y_plain.abs().max())
    nbytes = (x.numel() * 4 + qt.codes.numel() + qt.scales.numel() * 4
              + M * N * 4)
    call = lambda: cb_ops.crossbar_matmul(x, qt, kernel=kernel)  # noqa: E731
    case = {
        "name": "crossbar_matmul", "model": model, "bits": bits,
        "kernel": kernel, "shape": {"M": M, "K": K, "N": N},
        "max_abs_err": err, "tol": tol,
        "ms": timed(call, 20),
        "device_ms_warm": device_ms_by_name([call] * 10, CB_KERNELS),
        "host_us": host_us(call),
        "plain_ms": timed(lambda: cb_ops.crossbar_matmul_plain(x, qt), 5),
        "library_ms": timed(lambda: torch.matmul(x, w_deq), 20),
        "library_device_ms": device_ms(lambda: torch.matmul(x, w_deq)),
        "bound_ms": bound_ms(nbytes, 2.0 * M * K * N),
        # the same bound for the kernels' own arithmetic: three bf16
        # pieces of x, each against the codes on the tensor cores
        "bound_pieces_ms": 1e3 * max(nbytes / HBM_BYTES_PER_S,
                                     3 * 2.0 * M * K * N / BF16_FLOPS_PER_S),
        "bound_by": ("bytes" if nbytes / HBM_BYTES_PER_S
                     > 2.0 * M * K * N / F32_FLOPS_PER_S else "operations"),
    }
    if M <= DECODE_M:
        # each call on another copy of the weight: codes come from HBM
        copies = cold_copies(qt)
        case["cold_copies"] = len(copies)
        case["device_ms"] = device_ms_by_name(
            [lambda q=q: cb_ops.crossbar_matmul(x, q, kernel=kernel)
             for q in copies * max(1, 20 // len(copies))], CB_KERNELS)
        del copies
    else:
        case["device_ms"] = case["device_ms_warm"]
    return case


def crossbar_cases(dev, g, model, shapes, bits_list, extra_kn=None,
                   ms=(8, 1024)):
    """Each shape at each M of ``ms``; int8 ``extra_kn`` also at M = 32 and
    128, between decode and prefill."""
    from repro_torch.core import quant

    for bits in bits_list:
        for K, N in shapes:
            w = torch.randn(K, N, generator=g, device=dev) * (K ** -0.5)
            qt = quant.quantize(w, bits)
            w_deq = quant.dequantize(qt)
            m_list = ((8, 32, 128, 1024) if bits == 8 and (K, N) == extra_kn
                      else ms)
            for M in m_list:
                yield crossbar_case(dev, g, model, bits, K, N, M, qt, w_deq)


def crossover_cases(dev, g, K=4096, N=4096,
                    ms=(8, 16, 32, 64, 128, 256, 1024)):
    """Both crossbar kernels forced at each M on one rwkv6-7b shape: where
    the split-K decode kernel stops beating the wgmma prefill kernel."""
    from repro_torch.core import quant

    w = torch.randn(K, N, generator=g, device=dev) * (K ** -0.5)
    qt = quant.quantize(w, 8)
    w_deq = quant.dequantize(qt)
    for M in ms:
        for kernel in ("decode", "prefill"):
            yield crossbar_case(dev, g, "crossover", 8, K, N, M, qt, w_deq,
                                kernel)


def _sdpa_yardstick(q, k, v, mask):
    """One PyTorch call computing the same attention: SDPA with the
    visibility mask (GQA expanded to the query heads outside the call)."""
    B, T, Hq, D = q.shape
    G = Hq // k.shape[2]
    qh = q.transpose(1, 2)
    kh = k.repeat_interleave(G, dim=2).transpose(1, 2)
    vh = v.repeat_interleave(G, dim=2).transpose(1, 2)
    m = mask[:, None]
    return lambda: torch.nn.functional.scaled_dot_product_attention(
        qh, kh, vh, attn_mask=m)


def _attn_cost(q, mask, kv_bytes):
    """Bytes (q, positions, the K/V that this run's rows can see, out) and
    flops (4 D per visible (query head, key) pair) of one attention."""
    B, T, Hq, D = q.shape
    pairs = float(mask.sum()) * Hq
    nbytes = 2 * q.numel() * 4 + kv_bytes + B * T * 4
    return nbytes, 4.0 * D * pairs


def _flash_times(call, plain, sdpa, nbytes, flops, names=FA_KERNELS):
    """Times and bounds of one flash case: the kernel (events, and its own
    device time by profiler), the host's time to issue it, the plain
    version, SDPA (events, and its device time with the kernels that ran:
    f32 with a mask picks SDPA's backend; None where SDPA cannot compute
    the function: a softcap), the f32 bound and the bound of the kernels'
    own arithmetic (three TF32 products, 495 TFLOP/s)."""
    sdpa_kernels = (device_ms_per_kernel([sdpa] * 10) if sdpa is not None
                    else {})
    return {
        "ms": timed(call, 20),
        "device_ms": device_ms_by_name([call] * 10, names),
        "host_us": host_us(call),
        "plain_ms": timed(plain, 5),
        "library_ms": timed(sdpa, 20) if sdpa is not None else None,
        "library_device_ms": (sum(sdpa_kernels.values())
                              if sdpa is not None else None),
        "library_kernels": sorted(k[:100] for k in sdpa_kernels),
        "bound_ms": bound_ms(nbytes, flops),
        "bound_pieces_ms": 1e3 * max(nbytes / HBM_BYTES_PER_S,
                                     3 * flops / TF32_FLOPS_PER_S),
        "bound_by": ("bytes" if nbytes / HBM_BYTES_PER_S
                     > flops / F32_FLOPS_PER_S else "operations"),
    }


def _contiguous_case(dev, g, model, label, B, T, S, Hq, Hkv, D,
                     window=None, softcap=None):
    """One ``flash_attention`` case: B rows of T queries at the last T of S
    positions over S keys."""
    from repro_torch.kernels.flash_attention import ops as fa_ops

    q = torch.randn(B, T, Hq, D, generator=g, device=dev)
    k = torch.randn(B, S, Hkv, D, generator=g, device=dev)
    v = torch.randn(B, S, Hkv, D, generator=g, device=dev)
    qpos = (torch.arange(T, device=dev, dtype=torch.int32) + (S - T))
    qpos = qpos[None].expand(B, T).contiguous()
    kpos = torch.arange(S, device=dev, dtype=torch.int32)
    kpos = kpos[None].expand(B, S).contiguous()
    kw = dict(window=window, softcap=softcap)
    o = fa_ops.flash_attention(q, k, v, qpos, kpos, **kw)
    o_plain = fa_ops.flash_attention_plain(q, k, v, qpos, kpos, **kw)
    torch.cuda.synchronize()
    mask = fa_ops.visible_mask(qpos, kpos, window)      # (B, T, S)
    seen = mask.any(dim=1)                              # keys some row sees
    nbytes, flops = _attn_cost(q, mask, float(seen.sum()) * Hkv * D * 4 * 2)
    flags = {k: v for k, v in kw.items() if v is not None}
    return {
        "name": "flash_attention", "case": label, "model": model,
        "shape": {"B": B, "T": T, "S": S, "Hq": Hq, "Hkv": Hkv, "D": D,
                  **flags},
        "max_abs_err": float((o - o_plain).abs().max()), "tol": FA_TOL,
        **_flash_times(
            lambda: fa_ops.flash_attention(q, k, v, qpos, kpos, **kw),
            lambda: fa_ops.flash_attention_plain(q, k, v, qpos, kpos, **kw),
            _sdpa_yardstick(q, k, v, mask) if softcap is None else None,
            nbytes, flops),
    }


def flash_cases(dev, g, model, Hq, Hkv):
    """Contiguous prefill (the forward's whole 512-token prompt) and decode
    (8 rows over 1024 keys) at ``model``'s heads, D = 64."""
    for label, B, T, S in (("prefill", 1, 512, 512), ("decode", 8, 1, 1024)):
        yield _contiguous_case(dev, g, model, label, B, T, S, Hq, Hkv, 64)


def _paged_case(dev, g, model, Hq, Hkv, label, lens, clens, C, nb, P, D=64,
                softcap=None):
    from repro_torch.kernels.flash_attention import ops as fa_ops

    page = 16
    B = lens.shape[0]
    need = (lens + clens + page - 1) // page
    perm = torch.randperm(P, generator=g, device=dev)
    bt = torch.full((B, nb), -1, dtype=torch.int32, device=dev)
    used = 0
    for b in range(B):
        n = int(need[b])
        bt[b, :n] = perm[used:used + n].to(torch.int32)
        used += n
    kp = torch.randn(P, Hkv, page, D, generator=g, device=dev)
    vp = torch.randn(P, Hkv, page, D, generator=g, device=dev)
    q = torch.randn(B, C, Hq, D, generator=g, device=dev)
    pos = (lens[:, None] + torch.arange(C, device=dev)[None]).to(torch.int32)
    args = (q, kp, vp, pos, bt, lens, clens)
    kw = dict(page_size=page, softcap=softcap)
    o = fa_ops.paged_flash_attention(*args, **kw)
    o_plain = fa_ops.paged_flash_attention_plain(*args, **kw)
    torch.cuda.synchronize()
    kv_pos = fa_ops.paged_kv_pos(bt, lens, clens, page)
    mask = fa_ops.visible_mask(pos, kv_pos, None)
    valid = torch.arange(C, device=dev)[None] < clens[:, None]
    # only rows of real tokens are compared (pad rows are discarded by the
    # engine; a row that sees no key is 0 in both versions anyway)
    err = float((o - o_plain).abs()[valid].max())
    nbytes, flops = _attn_cost(q, mask,
                               float((kv_pos >= 0).sum()) * Hkv * D * 4 * 2)
    kg = fa_ops.gather_pages(kp, bt)
    vg = fa_ops.gather_pages(vp, bt)
    return {
        "name": "paged_flash_attention", "case": label, "model": model,
        "shape": {"B": B, "T": C, "nb": nb, "page": page, "Hq": Hq,
                  "Hkv": Hkv, "D": D,
                  **({"softcap": softcap} if softcap is not None else {}),
                  "contexts": (lens + clens).tolist()},
        "max_abs_err": err, "tol": FA_TOL,
        **_flash_times(
            lambda: fa_ops.paged_flash_attention(*args, **kw),
            lambda: fa_ops.paged_flash_attention_plain(*args, **kw),
            _sdpa_yardstick(q, kg, vg, mask) if softcap is None else None,
            nbytes, flops),
    }


def paged_cases(dev, g, model, Hq, Hkv):
    """Two batches as the engine builds them at ``model``'s heads, D = 64,
    pages of 16. mixed: 8 slots, chunk bucket 128 -- five prefill rows at
    various depths, two decode rows, one idle slot. decode: a pure decode
    tick of the serve phase's shape -- 8 slots, one row each, contexts
    64-544 (prompts of 64-512 plus up to 32 generated tokens), block
    tables 64 wide (max_len 1024)."""
    i32 = dict(dtype=torch.int32, device=dev)
    yield _paged_case(
        dev, g, model, Hq, Hkv, "mixed",
        torch.tensor([0, 128, 256, 384, 40, 700, 1000, 0], **i32),
        torch.tensor([128, 128, 128, 100, 128, 1, 1, 0], **i32), C=128,
        nb=63, P=512)
    lens = torch.linspace(63, 543, 8, device=dev).round().to(torch.int32)
    yield _paged_case(dev, g, model, Hq, Hkv, "decode", lens,
                      torch.ones(8, **i32), C=1, nb=64, P=512)


def _ring_case(dev, g, model, label, lens, clens, T, W, Hq, Hkv, D, window,
               softcap):
    """One ``ring_flash_attention`` case: a sliding layer's ring (B, Hkv, W,
    D) and the chunk's own K/V at the slots' lengths ``lens``."""
    from repro_torch.kernels.flash_attention import ops as fa_ops

    B = lens.shape[0]
    q = torch.randn(B, T, Hq, D, generator=g, device=dev)
    kr, vr = (torch.randn(B, Hkv, W, D, generator=g, device=dev)
              for _ in range(2))
    kc, vc = (torch.randn(B, T, Hkv, D, generator=g, device=dev)
              for _ in range(2))
    pos = (lens[:, None] + torch.arange(T, device=dev)[None]).to(torch.int32)
    args = (q, kr, vr, kc, vc, pos, lens, clens)
    kw = dict(window=window, softcap=softcap)
    o = fa_ops.ring_flash_attention(*args, **kw)
    o_plain = fa_ops.ring_flash_attention_plain(*args, **kw)
    torch.cuda.synchronize()
    kv_pos = fa_ops.ring_kv_pos(lens, clens, pos, W)
    mask = fa_ops.visible_mask(pos, kv_pos, window)
    valid = torch.arange(T, device=dev)[None] < clens[:, None]
    err = float((o - o_plain).abs()[valid].max())
    seen = mask.any(dim=1)
    nbytes, flops = _attn_cost(q, mask, float(seen.sum()) * Hkv * D * 4 * 2)
    # SDPA has no softcap; without one, SDPA over the gathered [ring ;
    # chunk] K/V with the visibility mask computes the same function
    sdpa = None
    if softcap is None:
        kg = torch.cat([kr.transpose(1, 2), kc], dim=1).contiguous()
        vg = torch.cat([vr.transpose(1, 2), vc], dim=1).contiguous()
        sdpa = _sdpa_yardstick(q, kg, vg, mask)
    return {
        "name": "ring_flash_attention", "case": label, "model": model,
        "shape": {"B": B, "T": T, "W": W, "Hq": Hq, "Hkv": Hkv, "D": D,
                  "window": window, "softcap": softcap,
                  "lens": lens.tolist(), "chunk_lens": clens.tolist()},
        "max_abs_err": err, "tol": FA_TOL,
        **_flash_times(lambda: fa_ops.ring_flash_attention(*args, **kw),
                       lambda: fa_ops.ring_flash_attention_plain(*args, **kw),
                       sdpa, nbytes, flops, RING_KERNELS),
    }


def gemma_attention_cases(dev, g):
    """gemma2-9b's attention (16 query and 8 kv heads of 256, softcap 50 on
    every layer, window 4096 on the sliding ones) at the serve phase's
    shapes: contiguous prefill of a 4608-token prompt with the window (a
    sliding layer of the kernel forward) and decode over 4640 keys (a
    global layer); paged mixed (8 slots, chunks of 128, contexts up to
    4800) and decode (a pure decode tick, tables 320 wide: max_len 5120);
    the ring kernel with a chunk of 128 and at decode, on rings of 4096
    that have wrapped, are filling and are empty. Then head_dim 128 at 32
    query and 8 kv heads (no model serves it yet: ROADMAP Queue 1 item
    19): a 512-token prefill and 8 decode rows over 1024 keys. SDPA has no
    softcap, so the gemma cases have no library time."""
    i32 = dict(dtype=torch.int32, device=dev)
    m, H, D, cap, W = "gemma2-9b", (16, 8), 256, 50.0, 4096
    yield _contiguous_case(dev, g, m, "prefill", 1, 4608, 4608, *H, D,
                           window=W, softcap=cap)
    yield _contiguous_case(dev, g, m, "decode", 1, 1, 4640, *H, D,
                           softcap=cap)
    yield _paged_case(
        dev, g, m, *H, "mixed",
        torch.tensor([0, 128, 2048, 4352, 40, 4700, 300, 0], **i32),
        torch.tensor([128, 128, 128, 100, 128, 1, 1, 0], **i32), C=128,
        nb=320, P=2600, D=D, softcap=cap)
    lens = torch.tensor([80, 200, 330, 440, 530, 4330, 4600, 4811], **i32)
    yield _paged_case(dev, g, m, *H, "decode", lens, torch.ones(8, **i32),
                      C=1, nb=320, P=2600, D=D, softcap=cap)
    yield _ring_case(
        dev, g, m, "chunk",
        torch.tensor([0, 128, 2048, 4096, 4352, 9000, 300, 0], **i32),
        torch.tensor([128, 128, 128, 100, 128, 1, 1, 0], **i32), 128, W,
        *H, D, W, cap)
    yield _ring_case(dev, g, m, "decode", lens, torch.ones(8, **i32), 1, W,
                     *H, D, W, cap)
    yield _contiguous_case(dev, g, "head_dim 128", "prefill", 1, 512, 512,
                           32, 8, 128)
    yield _contiguous_case(dev, g, "head_dim 128", "decode", 8, 1, 1024, 32,
                           8, 128)


# device ms of the backward kernels before their Hopper redesign (f32
# FMAs), copied from PERF.md's kernel table, not measured by this script:
# they go on the kernel phase's case lines beside the measured device ms,
# never into the kernels summary line. By (case, model, K, N) and
# (case, model).
BEFORE_FROM = ("PERF.md kernel table, 'before' column: the f32-FMA "
               "backward kernels on an NVIDIA H100 80GB HBM3, 700.00 W")
BEFORE_T_MS = {("microbatch", "llama3.2-1b", 2048, 2048): 0.3577,
               ("microbatch", "llama3.2-1b", 2048, 512): 0.0934,
               ("microbatch", "llama3.2-1b", 2048, 8192): 1.4162,
               ("microbatch", "llama3.2-1b", 8192, 2048): 1.4149,
               ("microbatch", "paper-gpt2-medium", 1024, 1024): 0.0976,
               ("microbatch", "paper-gpt2-medium", 1024, 4096): 0.3774,
               ("microbatch", "paper-gpt2-medium", 4096, 1024): 0.3588,
               ("whole batch", "llama3.2-1b", 2048, 2048): 0.7109,
               ("whole batch", "llama3.2-1b", 2048, 512): 0.1840,
               ("whole batch", "llama3.2-1b", 2048, 8192): 2.8227,
               ("whole batch", "llama3.2-1b", 8192, 2048): 2.8196}
BEFORE_FA_BWD_MS = {("causal", "llama3.2-1b"): 0.7498,
                    ("causal", "paper-gpt2-medium"): 0.3448,
                    ("causal, whole batch", "llama3.2-1b"): 1.1937,
                    ("window+softcap", "window+softcap"): 0.1678}


# the Fig. 13 fine-tunes' crossbar matrices (reduced paper-gpt2-medium, d
# 128, d_ff 512: wq/wk/wv/wo, w1, w2) and their rows (16 x 64 tokens)
FIG13_KN = ((128, 128), (128, 512), (512, 128))
FIG13_M = 16 * 64


# (model, (K, N) pairs, rows, case, code widths) of the transposed
# crossbar kernel's cases: int8 at the rows of one train microbatch
# (``TRAIN_M``) and llama's pairs also at the whole batch's rows (an extra:
# the train step never runs it); then int4 at the microbatch rows, and int8
# and int4 at the Fig. 13 fine-tunes' (K, N) pairs and rows
CB_T_CASES = (("llama3.2-1b", LLAMA_KN, TRAIN_M, "microbatch", (8,)),
              ("paper-gpt2-medium", PAPER_KN, TRAIN_M, "microbatch", (8,)),
              ("llama3.2-1b", LLAMA_KN, TRAIN_BATCH * TRAIN_SEQ,
               "whole batch", (8,)))
CB_T_CASES_SLICE10 = (
    ("llama3.2-1b", LLAMA_KN, TRAIN_M, "microbatch", (4,)),
    ("paper-gpt2-medium", PAPER_KN, TRAIN_M, "microbatch", (4,)),
    ("fig13", FIG13_KN, FIG13_M, "fig13 fine-tune", (8, 4)))


def crossbar_t_cases(dev, g, table=CB_T_CASES):
    """The transposed crossbar kernel (the backward's dx = g . dequant(W)^T
    from the same codes) at each entry of ``table``. Yardstick:
    ``torch.matmul(g, W_deq.T)`` on a pre-dequantized weight. Pieces bound:
    the kernel's three bf16 products (g's pieces against the codes) at 989
    TFLOP/s."""
    for model, shapes, M, case, bits_list in table:
        for bits in bits_list:
            for K, N in shapes:
                yield crossbar_t_case(dev, g, model, case, bits, K, N, M)


def crossbar_t_case(dev, g, model, case, bits, K, N, M):
    from repro_torch.core import quant
    from repro_torch.kernels.crossbar_matmul import ops as cb_ops

    w = torch.randn(K, N, generator=g, device=dev) * (K ** -0.5)
    qt = quant.quantize(w, bits)
    w_deq = quant.dequantize(qt)
    gy = torch.randn(M, N, generator=g, device=dev)
    dx = cb_ops.crossbar_matmul_t(gy, qt)
    dx_plain = cb_ops.crossbar_matmul_t_plain(gy, qt)
    torch.cuda.synchronize()
    nbytes = (gy.numel() * 4 + qt.codes.numel() + qt.scales.numel() * 4
              + M * K * 4)
    flops = 2.0 * M * K * N
    call = lambda: cb_ops.crossbar_matmul_t(gy, qt)  # noqa: E731
    lib = lambda: torch.matmul(gy, w_deq.T)          # noqa: E731
    before = BEFORE_T_MS.get((case, model, K, N)) if bits == 8 else None
    return {
        "name": "crossbar_matmul_t", "model": model, "bits": bits,
        "case": case, "shape": {"M": M, "K": K, "N": N},
        "max_abs_err": float((dx - dx_plain).abs().max()),
        "tol": CB_TOL * float(dx_plain.abs().max()),
        "ms": timed(call, 20),
        "device_ms": device_ms_by_name([call] * 10, CB_T_KERNELS),
        **({"before_device_ms": before, "before_from": BEFORE_FROM}
           if before is not None else {}),
        "host_us": host_us(call),
        "plain_ms": timed(lambda: cb_ops.crossbar_matmul_t_plain(gy, qt), 5),
        "library_ms": timed(lib, 20),
        "library_device_ms": device_ms(lib),
        "bound_ms": bound_ms(nbytes, flops),
        "bound_pieces_ms": 1e3 * max(nbytes / HBM_BYTES_PER_S,
                                     3 * flops / BF16_FLOPS_PER_S),
        "bound_by": ("bytes" if nbytes / HBM_BYTES_PER_S
                     > flops / F32_FLOPS_PER_S else "operations"),
    }


def _sdpa_bwd_yardstick(q, k, v, dout, mask):
    """One PyTorch call computing the same gradients: the backward of SDPA
    with the visibility mask, from leaves q, k, v (GQA expanded to the
    query heads outside the call; its backward sums dk and dv over each
    group)."""
    G = q.shape[2] // k.shape[2]
    ql, kl, vl = (t.detach().clone().requires_grad_(True) for t in (q, k, v))
    o = torch.nn.functional.scaled_dot_product_attention(
        ql.transpose(1, 2), kl.repeat_interleave(G, dim=2).transpose(1, 2),
        vl.repeat_interleave(G, dim=2).transpose(1, 2), attn_mask=mask[:, None])
    do = dout.transpose(1, 2)
    return lambda: torch.autograd.grad(o, (ql, kl, vl), do, retain_graph=True)


def flash_bwd_cases(dev, g):
    """The flash backward (dq, dk, dv from the forward kernel's out and
    lse) at one train microbatch's attention: B = ``TRAIN_MB``, T = S =
    512, causal, at llama3.2-1b's 32/8 heads and the paper models' 16/16;
    llama's heads also at the whole batch's B (an extra: the train step
    never runs it); and a window with a softcap on a small shape (SDPA has
    no softcap: no yardstick).
    Bound: bytes of q, k, v, out, dout, lse read and dq, dk, dv written;
    the five products of the FA-2 backward (10 D flops per visible (query
    head, key) pair) in f32. The kernels' own work recomputes S and dP in
    both passes, 14 D per pair, each product in three TF32 pieces at 495
    TFLOP/s (``bound_pieces_ms``)."""
    from repro_torch.kernels.flash_attention import ops as fa_ops

    D = 64
    for model, case, B, T, Hq, Hkv, window, softcap in (
            ("llama3.2-1b", "causal", TRAIN_MB, TRAIN_SEQ, 32, 8, None,
             None),
            ("paper-gpt2-medium", "causal", TRAIN_MB, TRAIN_SEQ, 16, 16,
             None, None),
            ("llama3.2-1b", "causal, whole batch", TRAIN_BATCH, TRAIN_SEQ,
             32, 8, None, None),
            ("window+softcap", "window+softcap", 2, 256, 8, 2, 64, 30.0)):
        q = torch.randn(B, T, Hq, D, generator=g, device=dev)
        dout = torch.randn(B, T, Hq, D, generator=g, device=dev)
        k = torch.randn(B, T, Hkv, D, generator=g, device=dev)
        v = torch.randn(B, T, Hkv, D, generator=g, device=dev)
        pos = torch.arange(T, device=dev, dtype=torch.int32)[None].expand(
            B, T).contiguous()
        out, lse = fa_ops._launch(q, k, v, pos, pos, window, softcap,
                                  with_lse=True)
        kw = dict(window=window, softcap=softcap)
        args = (q, k, v, pos, pos, out, lse, dout)
        got = fa_ops.flash_attention_bwd(*args, **kw)
        want = fa_ops.flash_attention_bwd_plain(*args, **kw)
        torch.cuda.synchronize()
        abs_err = max(float((a - b).abs().max()) for a, b in zip(got, want))
        over = max(float(((a - b).abs() - FA_BWD_TOL * b.abs()).max())
                   for a, b in zip(got, want))
        mask = fa_ops.visible_mask(pos, pos, window)
        pairs = float(mask.sum()) * Hq
        nbytes = 4.0 * (4 * q.numel() + 4 * k.numel() + lse.numel()
                        + 2 * pos.numel())
        flops, own = 10.0 * D * pairs, 14.0 * D * pairs
        call = lambda: fa_ops.flash_attention_bwd(*args, **kw)  # noqa: E731
        case = {
            "name": "flash_attention_bwd", "model": model, "case": case,
            "shape": {"B": B, "T": T, "S": T, "Hq": Hq, "Hkv": Hkv, "D": D,
                      "window": window, "softcap": softcap},
            "max_abs_err": abs_err, "max_err_over_rel": over,
            "tol": FA_BWD_TOL, "ok": over <= FA_BWD_TOL,
            "ms": timed(call, 20),
            "device_ms": device_ms_by_name([call] * 10, FA_BWD_KERNELS),
            "before_device_ms": BEFORE_FA_BWD_MS[(case, model)],
            "before_from": BEFORE_FROM,
            "host_us": host_us(call),
            "plain_ms": timed(
                lambda: fa_ops.flash_attention_bwd_plain(*args, **kw), 5),
            "library_ms": None, "library_device_ms": None,
            "bound_ms": bound_ms(nbytes, flops),
            "bound_pieces_ms": 1e3 * max(nbytes / HBM_BYTES_PER_S,
                                         3 * own / TF32_FLOPS_PER_S),
            "bound_by": ("bytes" if nbytes / HBM_BYTES_PER_S
                         > flops / F32_FLOPS_PER_S else "operations"),
        }
        if softcap is None:
            lib = _sdpa_bwd_yardstick(q, k, v, dout, mask)
            kern = device_ms_per_kernel([lib] * 10)
            case.update(library_ms=timed(lib, 20),
                        library_device_ms=sum(kern.values()),
                        library_kernels=sorted(n[:100] for n in kern))
        else:
            case["library"] = "none: scaled_dot_product_attention has no softcap"
        yield case


# the wkv kernels' own names in a profiler trace: the register recurrence
# (decode, short chunks) and the chunked tensor-core kernel
WKV_KERNELS = ("wkv_kernel<", "wkv_chunk_kernel")
WKV_LAUNCH_KEYS = ("rwkv6_wkv", "rwkv6_wkv_chunk")
# the selective scan's: the register kernel (decode, the verify tick) and
# the tiled kernel (chunks and prompts), one of them a call
SCAN_KERNELS = ("selective_scan_kernel<", "selective_scan_tile_kernel<")
# each launch count of ``kernels.LAUNCHES`` (both flash entry points run
# one kernel template) beside the kernels it counts in a profiler trace
LAUNCHED_AS = ((("crossbar_matmul",), CB_KERNELS),
               (("grouped_crossbar_matmul",), GROUPED_KERNELS),
               (("flash_attention", "paged_flash_attention"), FA_KERNELS),
               (("ring_flash_attention",), RING_KERNELS),
               (("rwkv6_wkv",), ("wkv_kernel<",)),
               (("rwkv6_wkv_chunk",), ("wkv_chunk_kernel",)),
               (("selective_scan",), SCAN_KERNELS),
               (("moe_route",), ROUTE_KERNELS),
               (("moe_combine",), COMBINE_KERNELS))


def _wkv_inputs(dev, g, B, T, H, N, decay="model", clens=None):
    """rwkv6-7b's wkv inputs: decays as the model makes them, exp(-exp(x))
    with x in [-6, -1] ("model"), or down to exact zeros ("small_decay":
    x in [-6, 3], and 1% of the decays exactly 0); ragged rows masked as
    the model masks them (k = 0, w = 1 past each row's length)."""
    r, k, v = (torch.randn(B, T, H, N, generator=g, device=dev)
               for _ in range(3))
    lo, hi = (-6.0, -1.0) if decay == "model" else (-6.0, 3.0)
    w = torch.exp(-torch.exp(lo + (hi - lo) * torch.rand(
        B, T, H, N, generator=g, device=dev)))
    if decay == "small_decay":
        zero = torch.rand(B, T, H, N, generator=g, device=dev) < 0.01
        w = torch.where(zero, 0.0, w)
    u = 0.5 * torch.ones(H, N, device=dev)
    s0 = torch.randn(B, H, N, N, generator=g, device=dev)
    if clens is not None:
        valid = (torch.arange(T, device=dev)[None] < torch.tensor(
            clens, device=dev)[:, None])[..., None, None]
        k = torch.where(valid, k, 0.0)
        w = torch.where(valid, w, 1.0)
    return r, k, v, w, u, s0


def _wkv_cost(B, T, H, N):
    """Bytes (r/k/v/w read, y written, the state read and written), f32
    flops of the recurrence (4 T N^2 per head), and the chunked kernel's
    own arithmetic: its three products ((r * P) S, (k * Q)^T V: 4 T N^2;
    A V: 2 T 16 N) in 3xTF32 on the tensor cores, and its f32 SIMT work
    (decay products 4 T N; A over each 16-step sub-chunk's 136 pairs, 2 N
    each, and its 120 running products, N each)."""
    nbytes = 5.0 * B * T * H * N * 4 + 2.0 * B * H * N * N * 4
    flops = 4.0 * B * T * H * N * N
    n_sub = -(-T // 16)
    tensor = 3 * (flops + 2.0 * B * T * H * 16 * N)
    simt = 4.0 * B * T * H * N + B * H * n_sub * (136 * 2.0 * N + 120.0 * N)
    return nbytes, flops, tensor, simt


def wkv_case(dev, g, label, T, decay="model", clens=None, kernel="auto",
             model="rwkv6-7b"):
    from repro_torch import kernels
    from repro_torch.kernels.rwkv6_wkv import ops as wkv_ops

    B, H, N = 8, 64, 64
    args = _wkv_inputs(dev, g, B, T, H, N, decay, clens)
    before = dict(kernels.LAUNCHES)
    y, s = wkv_ops.rwkv6_wkv(*args, kernel=kernel)
    ran = [k for k in WKV_LAUNCH_KEYS if kernels.LAUNCHES[k] != before[k]]
    if len(ran) != 1:
        raise AssertionError(f"one wkv call launched {ran}")
    y_plain, s_plain = wkv_ops.rwkv6_wkv_plain(*args)
    torch.cuda.synchronize()
    err = max(float((y - y_plain).abs().max()),
              float((s - s_plain).abs().max()))
    # the plain version's own scale: 1e-5 relative and absolute
    tol = WKV_TOL * (1.0 + max(float(y_plain.abs().max()),
                               float(s_plain.abs().max())))
    nbytes, flops, tensor, simt = _wkv_cost(B, T, H, N)
    call = lambda: wkv_ops.rwkv6_wkv(*args, kernel=kernel)  # noqa: E731
    chunked = ran == ["rwkv6_wkv_chunk"]
    return {
        "name": ran[0],
        "model": model, "case": label, "kernel": kernel,
        "shape": {"B": B, "T": T, "H": H, "N": N, "decay": decay,
                  **({"chunk_lens": list(clens)} if clens else {})},
        "max_abs_err": err, "tol": tol,
        "ms": timed(call, 20),
        "device_ms": device_ms_by_name([call] * 10, WKV_KERNELS),
        "host_us": host_us(call),
        "plain_ms": timed(lambda: wkv_ops.rwkv6_wkv_plain(*args), 5),
        "library_ms": None,
        "library": "none: no single PyTorch call computes this recurrence",
        "bound_ms": bound_ms(nbytes, flops),
        # the bound of the kernel's own arithmetic: the chunked kernel's
        # products in 3xTF32 at 495 TFLOP/s beside its f32 SIMT work; the
        # recurrence's own arithmetic is the f32 bound
        "bound_pieces_ms": (1e3 * max(nbytes / HBM_BYTES_PER_S,
                                      tensor / TF32_FLOPS_PER_S
                                      + simt / F32_FLOPS_PER_S)
                            if chunked else bound_ms(nbytes, flops)),
        "bound_by": ("bytes" if nbytes / HBM_BYTES_PER_S
                     > flops / F32_FLOPS_PER_S else "operations"),
    }


def wkv_cases(dev, g):
    """The wkv recurrence at rwkv6-7b's shapes (H = 64 heads of N = 64, 8
    slots), each kernel as the wrapper picks it: a decode tick, a prefill
    chunk of 128, a ragged chunk as the engine builds it (rows of various
    lengths, one idle), the chunk with small decays and exact zeros, and a
    whole 512-token prompt (the dense forward); then both kernels forced
    at the engine's chunk buckets T = 1 .. 128 (the crossover)."""
    for label, T, decay, clens in (
            ("decode", 1, "model", None), ("prefill", 128, "model", None),
            ("ragged", 128, "model", (128, 100, 64, 1, 0, 128, 37, 5)),
            ("small_decay", 128, "small_decay", None),
            ("prompt", 512, "model", None)):
        yield wkv_case(dev, g, label, T, decay, clens)
    for T in (1, 2, 4, 8, 16, 32, 64, 128):
        for kernel in ("recurrent", "chunk"):
            yield wkv_case(dev, g, f"crossover T={T}", T, kernel=kernel,
                           model="crossover")


# the wkv backward kernels' names in a profiler trace: the chunked
# tensor-core kernel (N = 64, the train path's) and the recurrence
WKV_BWD_KERNEL_OF = {"chunk": ("wkv_bwd_chunk_kernel",),
                     "recurrent": ("wkv_bwd_kernel<",)}
WKV_BWD_KERNELS = WKV_BWD_KERNEL_OF["chunk"] + WKV_BWD_KERNEL_OF["recurrent"]


def _wkv_bwd_cost(B, T, H, N):
    """Bytes (r/k/v/w/dy read and the four gradients written, u and du,
    s0, the state gradient and ds0) and f32 flops: per (b, t, h) the state
    recomputed, then dr, dk, dv, dw and the state gradient's step back,
    2 N^2 each (what the gradient needs, not the kernel's recomputes)."""
    nbytes = (9.0 * B * T * H * N + 3.0 * B * H * N * N + 2.0 * H * N) * 4
    return nbytes, 12.0 * B * T * H * N * N


def _wkv_bwd_tensor_flops(B, T, H, N):
    """The chunked backward kernel's products on the tensor cores, per
    (b, t, h): H = dY S^T, G = V dSe^T, (k * Q) dSe, (r * P)^T dY and the
    sweep's (k * Q)^T V, 2 N^2 each, and dA = dY V^T and A^T dY over a
    16-step sub-chunk, 2 16 N each."""
    return B * T * H * (10.0 * N * N + 64.0 * N)


def wkv_bwd_case(dev, g, label, B, T, H, N, decay="model", clens=None,
                 kernel="auto"):
    """``rwkv6_wkv_bwd`` against ``rwkv6_wkv_bwd_plain`` on the same
    inputs and gradients of y and the final state: each gradient within
    ``FA_BWD_TOL`` of its max |.|, and two calls giving the same bits. The
    device time is of the kernel that ``kernel`` picks (the chunked one at
    N = 64 unless forced), by its own name."""
    from repro_torch.kernels.rwkv6_wkv import ops as wkv_ops

    chunked = kernel == "chunk" or (kernel == "auto"
                                    and N == wkv_ops.CHUNK_N)
    args = _wkv_inputs(dev, g, B, T, H, N, decay, clens)
    dy = torch.randn(B, T, H, N, generator=g, device=dev)
    ds = torch.randn(B, H, N, N, generator=g, device=dev)
    call = lambda: wkv_ops.rwkv6_wkv_bwd(  # noqa: E731
        *args, dy, ds, kernel=kernel)
    got = call()
    again = call()
    want = wkv_ops.rwkv6_wkv_bwd_plain(*args, dy, ds)
    torch.cuda.synchronize()
    same_bits = all(torch.equal(a, b) for a, b in zip(got, again))
    errs = [float((a - b).abs().max()) for a, b in zip(got, want)]
    scales = [float(b.abs().max()) for b in want]
    rel = max(e / max(sc, 1e-30) for e, sc in zip(errs, scales))
    nbytes, flops = _wkv_bwd_cost(B, T, H, N)
    tensor = _wkv_bwd_tensor_flops(B, T, H, N)
    return {
        "name": "rwkv6_wkv_bwd", "model": "rwkv6-7b", "case": label,
        "kernel": "chunk" if chunked else "recurrent",
        "shape": {"B": B, "T": T, "H": H, "N": N, "decay": decay,
                  **({"chunk_lens": list(clens)} if clens else {})},
        "max_abs_err": max(errs), "max_abs_err_by_grad": errs,
        "max_rel_err": rel, "tol_rel": FA_BWD_TOL,
        "tol": FA_BWD_TOL * max(scales), "same_bits": same_bits,
        "ok": rel <= FA_BWD_TOL and same_bits and all(
            bool(torch.isfinite(x).all()) for x in got),
        "ms": timed(call, 20),
        "device_ms": device_ms_by_name(
            [call] * 10, WKV_BWD_KERNEL_OF["chunk" if chunked
                                           else "recurrent"]),
        "host_us": host_us(call, 50),
        "plain_ms": timed(lambda: wkv_ops.rwkv6_wkv_bwd_plain(*args, dy, ds),
                          3, warmup=1),
        "library_ms": None,
        "library": "none: no single PyTorch call computes this gradient",
        "bound_ms": bound_ms(nbytes, flops),
        **({"bound_pieces_ms": 1e3 * max(nbytes / HBM_BYTES_PER_S,
                                         3 * tensor / TF32_FLOPS_PER_S)}
           if chunked else {}),
        "bound_by": ("bytes" if nbytes / HBM_BYTES_PER_S
                     > flops / F32_FLOPS_PER_S else "operations"),
    }


def slice11_cases(dev, g):
    """The wkv backward kernels, taken after the train phase (so that the
    earlier phases run after the same kernel cases as before they were
    added): one rwkv6-7b train microbatch (B 2, T 512, H 64, N 64), the
    same with a row masked past 300 steps, small decays with exact zeros
    (the chunked kernel, as the train path runs them), N = 32 (128 heads
    of the same width: the recurrence), and the microbatch again through
    the recurrence (``kernel="recurrent"``, the kernel before the chunked
    one), in the same process."""
    yield (wkv_bwd_case(dev, g, label, B, T, H, N, decay, clens, kernel)
           for label, B, T, H, N, decay, clens, kernel in (
               ("microbatch", 2, 512, 64, 64, "model", None, "auto"),
               ("ragged", 2, 512, 64, 64, "model", (512, 300), "auto"),
               ("small_decay", 2, 512, 64, 64, "small_decay", None, "auto"),
               ("N=32", 2, 512, 128, 32, "model", None, "auto"),
               ("microbatch, before", 2, 512, 64, 64, "model", None,
                "recurrent")))


def _grouped_counts(dist, slots, dev):
    """Rows per slot of a grouped case: 8 decode rows on 8 distinct slots
    or on one slot, or 8 decode tokens each routed top-2 to two distinct
    slots (16 rows); 1024 prefill rows spread uniformly, or skewed (slot s
    takes a share ~ 1 / (s + 1)) with the last slot empty."""
    if dist == "decode_top2":
        c = torch.zeros(slots, dtype=torch.int64)
        gen = torch.Generator().manual_seed(slots + 2)
        for _ in range(8):
            c[torch.randperm(slots, generator=gen)[:2]] += 1
    elif dist == "decode_spread":
        c = torch.zeros(slots, dtype=torch.int64)
        c[torch.randperm(slots, generator=torch.Generator().manual_seed(
            slots))[:8]] = 1
    elif dist == "decode_one":
        c = torch.zeros(slots, dtype=torch.int64)
        c[slots // 2] = 8
    elif dist == "prefill_uniform":
        c = torch.full((slots,), 1024 // slots, dtype=torch.int64)
    else:
        share = 1.0 / torch.arange(1, slots + 1, dtype=torch.float64)
        share[-1] = 0.0
        c = torch.floor(1024 * share / share.sum()).to(torch.int64)
        c[0] += 1024 - int(c.sum())
    return c.to(torch.int32).to(dev)


def grouped_case(dev, g, model, bits, K, N, qt, w_deq, dist):
    """One ``grouped_crossbar_matmul`` case at ``dist``'s routing, on the
    kernel (and row tile) the MoE layer picks for that many rows. Bound:
    the codes and scales of the slots that hold rows, their x rows and the
    whole output, or the products of the live rows. Library: ``torch.bmm``
    over the JAX package's dropless buffer (C = T rows per slot: the
    decode rows are 8 sequences of 1 token, the 1024 prefill rows 8 of
    128) with the dequantized stack."""
    from repro_torch.kernels.crossbar_matmul import ops as cb_ops

    slots = qt.codes.shape[0]
    counts = _grouped_counts(dist, slots, dev)
    rows = int(counts.sum())
    kernel = cb_ops.grouped_kernel(rows, qt)
    tile = cb_ops.GROUPED_TILE[kernel]
    bases = torch.cat([torch.zeros(1, dtype=torch.int32, device=dev),
                       torch.cumsum((counts + tile - 1) // tile * tile, 0)
                       .to(torch.int32)])
    R = cb_ops.grouped_rows(rows, slots, tile)
    x = torch.randn(R, K, generator=g, device=dev)
    call = lambda: cb_ops.grouped_crossbar_matmul(  # noqa: E731
        x, qt, bases, counts, kernel)
    y = call()
    y_plain = cb_ops.grouped_crossbar_matmul_plain(x, qt, bases, counts)
    torch.cuda.synchronize()
    live = torch.zeros(R, dtype=torch.bool, device=dev)
    for b, c in zip(bases.tolist(), counts.tolist()):
        live[b:b + c] = True
    err = float((y - y_plain).abs().max())
    tol = CB_TOL * float(y_plain.abs().max())
    dead_zero = bool((y[~live] == 0).all())
    hit = int((counts > 0).sum())
    per_slot = qt.codes[0].numel() + qt.scales[0].numel() * 4
    nbytes = hit * per_slot + rows * K * 4 + R * N * 4
    flops = 2.0 * rows * K * N
    T = 1 if dist.startswith("decode") else 128
    xin = torch.randn(slots, 8 * T, K, generator=g, device=dev)
    library = lambda: torch.bmm(xin, w_deq)  # noqa: E731
    case = {
        "name": "grouped_crossbar_matmul", "case": dist, "model": model,
        "bits": bits, "kernel": kernel,
        "shape": {"rows": rows, "R": R, "slots": slots, "K": K, "N": N,
                  "counts": counts.tolist(), "slots_hit": hit},
        "max_abs_err": err, "tol": tol, "rows_past_counts_zero": dead_zero,
        "ms": timed(call, 20),
        "device_ms": device_ms_by_name([call] * 10, GROUPED_KERNELS),
        "host_us": host_us(call, 50),
        "plain_ms": timed(lambda: cb_ops.grouped_crossbar_matmul_plain(
            x, qt, bases, counts), 3, warmup=1),
        "library": "torch.bmm over the JAX dropless buffer "
                   f"({slots}, {8 * T}, {K}), dequantized weights",
        "library_ms": timed(library, 5, warmup=1),
        "library_device_ms": device_ms_by_name([library] * 3, None),
        "bound_ms": bound_ms(nbytes, flops),
        "bound_pieces_ms": 1e3 * max(nbytes / HBM_BYTES_PER_S,
                                     3 * flops / BF16_FLOPS_PER_S),
        "bound_by": ("bytes" if nbytes / HBM_BYTES_PER_S
                     > flops / F32_FLOPS_PER_S else "operations"),
    }
    case["ok"] = err <= tol and dead_zero
    del xin
    return case


GROUPED_DISTS = ("decode_spread", "decode_one", "prefill_uniform",
                 "prefill_skewed")


def grouped_cases(dev, g, model, slots, shapes, bits_list=(8, 4),
                  dists=GROUPED_DISTS):
    """``grouped_crossbar_matmul`` on ``model``'s expert stacks (``slots``
    of each (K, N)), at each routing of ``dists``."""
    from repro_torch.core import quant

    for bits in bits_list:
        for K, N in shapes:
            w = torch.randn(slots, K, N, generator=g, device=dev) * K ** -0.5
            qt = quant.quantize_slices(w, bits)
            del w
            w_deq = quant.dequantize(qt)
            for dist in dists:
                yield grouped_case(dev, g, model, bits, K, N, qt, w_deq, dist)
            del qt, w_deq
            gc.collect()
            torch.cuda.empty_cache()


def moe_attention_cases(dev, g):
    """The attention of the two MoE models at head_dim 128: llama4-scout's
    40 query and 8 kv heads (a GQA group of 5) and mixtral's 48/8 (a group
    of 6; its 4096 window): contiguous prefill (llama4: 512 tokens;
    mixtral: the forward phase's 4400-token prompt with the window) and 8
    decode rows over 1024 keys; paged mixed and decode as ``paged_cases``;
    mixtral's ring kernel with a chunk of 128 and at decode on rings of
    4096."""
    i32 = dict(dtype=torch.int32, device=dev)
    for m, H in (("llama4-scout-17b-a16e", (40, 8)),
                 ("mixtral-8x22b", (48, 8))):
        if m.startswith("mixtral"):
            yield _contiguous_case(dev, g, m, "prefill", 1, 4400, 4400, *H,
                                   128, window=4096)
        else:
            yield _contiguous_case(dev, g, m, "prefill", 1, 512, 512, *H,
                                   128)
        yield _contiguous_case(dev, g, m, "decode", 8, 1, 1024, *H, 128)
        yield _paged_case(
            dev, g, m, *H, "mixed",
            torch.tensor([0, 128, 256, 384, 40, 700, 1000, 0], **i32),
            torch.tensor([128, 128, 128, 100, 128, 1, 1, 0], **i32), C=128,
            nb=63, P=512, D=128)
        lens = torch.linspace(63, 543, 8, device=dev).round().to(torch.int32)
        yield _paged_case(dev, g, m, *H, "decode", lens,
                          torch.ones(8, **i32), C=1, nb=64, P=512, D=128)
    H, W = (48, 8), 4096
    yield _ring_case(
        dev, g, "mixtral-8x22b", "chunk",
        torch.tensor([0, 128, 2048, 4096, 4352, 9000, 300, 0], **i32),
        torch.tensor([128, 128, 128, 100, 128, 1, 1, 0], **i32), 128, W,
        *H, 128, W, None)
    lens = torch.tensor([80, 200, 330, 440, 530, 4330, 4600, 4811], **i32)
    yield _ring_case(dev, g, "mixtral-8x22b", "decode", lens,
                     torch.ones(8, **i32), 1, W, *H, 128, W, None)


def head_dim_128_cases(dev, g):
    """Flash at the heads of the three head-dim-128 forwards (slice 16):
    internlm2-20b's 48/8, mistral-nemo-12b's 32/8 and chameleon-34b's 64/8
    (a GQA group of 8): contiguous prefill of the forward's 512-token
    prompt and 8 decode rows over 1024 keys, paged mixed and decode as
    ``paged_cases``, each against SDPA."""
    i32 = dict(dtype=torch.int32, device=dev)
    for m, H in (("internlm2-20b", (48, 8)), ("mistral-nemo-12b", (32, 8)),
                 ("chameleon-34b", (64, 8))):
        yield _contiguous_case(dev, g, m, "prefill", 1, 512, 512, *H, 128)
        yield _contiguous_case(dev, g, m, "decode", 8, 1, 1024, *H, 128)
        yield _paged_case(
            dev, g, m, *H, "mixed",
            torch.tensor([0, 128, 256, 384, 40, 700, 1000, 0], **i32),
            torch.tensor([128, 128, 128, 100, 128, 1, 1, 0], **i32), C=128,
            nb=63, P=512, D=128)
        lens = torch.linspace(63, 543, 8, device=dev).round().to(torch.int32)
        yield _paged_case(dev, g, m, *H, "decode", lens,
                          torch.ones(8, **i32), C=1, nb=64, P=512, D=128)


def _scan_inputs(dev, g, B, T, D, N, clens=None):
    """jamba's scan inputs as its Mamba block makes them: dt =
    softplus(dt_proj(.) + dt_bias) (masked to 0 past each row's length),
    x the conv's SiLU output, B and C views of x_proj's output (its
    strides), a carried state h0; A = -(1..N) times a random scale per
    channel, as the GPU tests draw it (a trained A is no longer jamba's
    initial -(1..N) in every channel)."""
    r = D // 32                                    # dt_rank: d_model / 16
    dt = torch.nn.functional.softplus(
        torch.randn(B, T, D, generator=g, device=dev) - 4.0)
    if clens is not None:
        valid = (torch.arange(T, device=dev)[None]
                 < torch.tensor(clens, device=dev)[:, None])
        dt = dt * valid[..., None]
    xi = torch.nn.functional.silu(torch.randn(B, T, D, generator=g,
                                              device=dev))
    dbc = torch.randn(B, T, r + 2 * N, generator=g, device=dev)
    Bc, Cc = dbc[..., r:r + N], dbc[..., r + N:]
    A = -torch.arange(1, N + 1, device=dev, dtype=torch.float32).expand(
        D, N).contiguous() * torch.rand(D, 1, generator=g, device=dev)
    h0 = torch.randn(B, D, N, generator=g, device=dev)
    return dt, Bc, Cc, xi, A, h0


def _scan_cost(B, T, D, N):
    """Bytes (dt and x read, y written, B and C read, A read, the state
    read and written once), f32 operations (per step, channel and state:
    dt A, the decay times h, dt x B, their sum, h C and its sum; per step
    and channel dt x) and exponentials (one per step, channel and
    state)."""
    nbytes = 4.0 * (3 * B * T * D + 2 * B * T * N + D * N + 2 * B * D * N)
    flops = 6.0 * B * T * D * N + B * T * D
    return nbytes, flops, float(B * T * D * N)


# exponentials a clock on one SM: the special-function unit's rate on
# sm_90 (16 a clock per SM)
EXP_PER_CLOCK_SM = 16
_SFU = {}


def exp_ms(n_exp: float) -> float:
    """Milliseconds for ``n_exp`` exponentials at EXP_PER_CLOCK_SM on
    every SM of card 0 at its maximum SM clock (``clocks.max.sm``, read
    once by nvidia-smi)."""
    if not _SFU:
        out = subprocess.run(
            ["nvidia-smi", "-i", "0", "--query-gpu=clocks.max.sm",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, check=True, timeout=60)
        _SFU["mhz"] = float(out.stdout.strip().splitlines()[0])
        _SFU["sms"] = torch.cuda.get_device_properties(0).multi_processor_count
    rate = EXP_PER_CLOCK_SM * _SFU["sms"] * _SFU["mhz"] * 1e6
    return 1e3 * n_exp / rate


def scan_bound(B, T, D, N):
    """(parts, bound ms, bound_by) of the scan at (B, T, D, N): ``parts``
    the bytes' ms, the f32 operations' and, for information, the
    exponentials' on the special-function unit alone (``exp_ms``). The
    bound is the larger of bytes and f32: the FMA pipe can compute
    exponentials too (a polynomial), so the special-function unit's time
    is no floor of the function."""
    nbytes, flops, n_exp = _scan_cost(B, T, D, N)
    parts = {"bytes": 1e3 * nbytes / HBM_BYTES_PER_S,
             "f32": 1e3 * flops / F32_FLOPS_PER_S, "exp": exp_ms(n_exp)}
    by_bytes = parts["bytes"] >= parts["f32"]
    return (parts, parts["bytes"] if by_bytes else parts["f32"],
            "bytes" if by_bytes else "operations")


def scan_case(dev, g, label, B, T, clens=None, model="jamba-1.5-large-398b",
              D=16384, N=16):
    """``selective_scan`` at jamba's width (d_in 16384, d_state 16) against
    its plain version: within ``SCAN_TOL`` of max |y| and of max
    |h_final|, the same bits on two calls, one launch a call; an idle row
    keeps its state bit for bit. No single PyTorch call computes the scan:
    no library time. The bound is ``scan_bound``'s: the larger of the
    bytes and the f32 operations, the exponentials' time beside it."""
    from repro_torch import kernels
    from repro_torch.kernels.selective_scan import ops as scan_ops

    args = _scan_inputs(dev, g, B, T, D, N, clens)
    before = kernels.LAUNCHES["selective_scan"]
    y, h = scan_ops.selective_scan(*args)
    y2, h2 = scan_ops.selective_scan(*args)
    launched = kernels.LAUNCHES["selective_scan"] - before
    y_plain, h_plain = scan_ops.selective_scan_plain(*args)
    torch.cuda.synchronize()
    err_y = float((y - y_plain).abs().max())
    err_h = float((h - h_plain).abs().max())
    max_y, max_h = float(y_plain.abs().max()), float(h_plain.abs().max())
    same = bool(torch.equal(y, y2) and torch.equal(h, h2))
    parts, bound, bound_by = scan_bound(B, T, D, N)
    call = lambda: scan_ops.selective_scan(*args)  # noqa: E731
    by_kernel = device_ms_per_kernel([call] * 10, SCAN_KERNELS)
    case = {
        "name": "selective_scan", "model": model, "case": label,
        "kernel": ("tiled" if any("tile_kernel" in k for k in by_kernel)
                   else "recurrent"),
        "shape": {"B": B, "T": T, "D": D, "N": N,
                  **({"chunk_lens": list(clens)} if clens else {})},
        "max_abs_err": max(err_y, err_h),
        "max_rel_err": max(err_y / max_y, err_h / max_h),
        "tol": SCAN_TOL * max(max_y, max_h), "tol_rel": SCAN_TOL,
        "same_bits": same,
        "ms": timed(call, 20),
        "device_ms": sum(by_kernel.values()),
        "host_us": host_us(call),
        "plain_ms": timed(lambda: scan_ops.selective_scan_plain(*args), 3,
                          warmup=1),
        "library_ms": None,
        "library": "none: no single PyTorch call computes this scan",
        "bound_ms": bound,
        "bound_by": bound_by,
        "bound_parts_ms": parts,
        "exp_rate": {"per_clock_sm": EXP_PER_CLOCK_SM, **_SFU},
    }
    case["ok"] = (err_y <= SCAN_TOL * max_y and err_h <= SCAN_TOL * max_h
                  and same and launched == 2)
    if clens is not None and 0 in clens:        # an idle row keeps its state
        i = clens.index(0)
        case["idle_row_kept"] = bool(torch.equal(h[i], args[5][i]))
        case["ok"] = case["ok"] and case["idle_row_kept"]
    return case


# jamba's scan cases (label, B, T, chunk_lens): a decode tick on 8 slots,
# the n-gram verify tick (k = 4 drafts and the last token), a 128-token
# prefill chunk on 8 slots (also ragged as the engine masks it, one row
# idle), a 512-token prompt and a long prompt as the dense engine
# prefills it whole
SCAN_CASES = (("decode", 8, 1, None), ("verify", 8, 5, None),
              ("prefill", 8, 128, None),
              ("ragged", 8, 128, (128, 100, 64, 1, 0, 128, 37, 5)),
              ("prompt", 1, 512, None), ("long_prompt", 1, 4096, None))


def jamba_cases(dev, g):
    """jamba-1.5-large-398b's kernels (slice 17): ``selective_scan`` at
    the main path's shapes (``SCAN_CASES``); the crossbar at the Mamba
    projections (in_proj 8192 x 32768, out_proj 16384 x 8192) at M = 8
    and 1024; the grouped crossbar decoding 8 tokens top-2 over the 16
    expert stacks."""
    for label, B, T, clens in SCAN_CASES:
        yield scan_case(dev, g, label, B, T, clens)
    yield from crossbar_cases(dev, g, "jamba-1.5-large-398b", JAMBA_MAMBA_KN,
                              (8,))
    yield from grouped_cases(dev, g, "jamba-1.5-large-398b", 16, JAMBA_KN,
                             bits_list=(8,), dists=("decode_top2",))


# (model, experts, top_k, renormalised, d_model, shared expert) of the MoE
# models' routers (one slot an expert, as they are served), and the tokens
# (B, T) of a decode tick on 8 slots and of a mixed tick (every slot
# prefills 128; the engine's ragged chunk lens in the mask)
MOE_ROUTERS = (("llama4-scout-17b-a16e", 16, 1, False, 5120, True),
               ("mixtral-8x22b", 8, 2, True, 6144, False),
               ("jamba-1.5-large-398b", 16, 2, True, 8192, False))
MOE_TICKS = (("decode", 8, 1), ("mixed", 8, 128))
MIXED_CLENS = (128, 100, 64, 1, 0, 128, 37, 5)


def _tick_mask(dev, label, B, T):
    """Real tokens of a tick: all at decode; at a mixed tick the first
    ``MIXED_CLENS[b]`` of slot b's 128."""
    if label == "decode":
        return torch.ones(B, T, dtype=torch.bool, device=dev)
    return (torch.arange(T, device=dev)[None]
            < torch.tensor(MIXED_CLENS, device=dev)[:, None])


def device_kernels(fn, reps: int = 3):
    """(device ms, device kernels) per call of ``fn`` over ``reps`` traced
    calls: every kernel it launches, whoever wrote it."""
    fn()
    with cuda_trace() as prof:
        for _ in range(reps):
            fn()
    ev = device_events(prof)
    return (sum(e.time_range.elapsed_us() for e in ev) / 1e3 / reps,
            len(ev) / reps)


def moe_route_cases(dev, g):
    """``moe_route`` and ``moe_combine`` (slice 18) at the MoE models'
    decode and mixed ticks, each against its plain version on the same
    inputs (``moe_ops.compare_routes``: expert ids where the plain margin
    is >= 1e-5, rows, bases, counts and buffer rows bit-equal, gates,
    weights and aux within 1e-6 relative; the combine within 1e-6 of max
    |y|), with the plain version's device time and device kernels a call
    beside the kernel's. Router logits x @ W for a random f32 router of
    the model's width (``layers.dense_init``'s scale). Bound: the bytes
    each reads and writes once (no operation counts: a few per byte); no
    single PyTorch call computes either function."""
    from repro_torch.kernels.crossbar_matmul import ops as cb_ops
    from repro_torch.kernels.moe_route import ops as moe_ops

    for model, E, k, norm, d, has_shared in MOE_ROUTERS:
        router = torch.randn(d, E, generator=g, device=dev) * d ** -0.5
        for label, B, T in MOE_TICKS:
            n, A = B * T, B * T * k
            x = torch.randn(n, d, generator=g, device=dev)
            logits = x @ router
            mask = _tick_mask(dev, label, B, T).reshape(n)
            # the decode kernel's row tile at a decode tick, the prefill
            # kernel's at a mixed one (``cb_ops.grouped_kernel``'s pick at
            # these widths)
            tile = cb_ops.GROUPED_TILE["decode" if label == "decode"
                                       else "prefill"]
            kw = dict(top_k=k, tpe=1, norm_topk=norm, tile=tile,
                      R=cb_ops.grouped_rows(A, E, tile))
            route = lambda: moe_ops.moe_route(  # noqa: E731
                logits, mask, x, **kw)
            plain = lambda: moe_ops.moe_route_plain(  # noqa: E731
                logits, mask, x, **kw)
            got, again, want = route(), route(), plain()
            torch.cuda.synchronize()
            check = moe_ops.compare_routes(got, want)
            kept = want.weights > 0
            same = all(torch.equal(a, b) for a, b in zip(got[:-1], again[:-1]))
            same = same and torch.equal(got.xbuf[want.rows[kept]],
                                        again.xbuf[want.rows[kept]])
            n_kept = int(kept.sum())
            # tokens with a kept assignment: the x rows the kernel reads
            n_read = int(kept.reshape(n, k).any(1).sum())
            err = max(float((got.gate - want.gate).abs().max()),
                      float((got.aux - want.aux).abs().max()))
            scale = max(float(want.gate.abs().max()),
                        float(want.aux.abs().max()))
            nbytes = (n * E * 4 + n + n_read * d * 4 + n_kept * d * 4
                      + n * k * 12 + n * 4 + 12 + A * 12 + (2 * E + 1) * 4)
            plain_dev, plain_kernels = device_kernels(plain)
            shape = {"tokens": n, "E": E, "top_k": k, "d": d,
                     "R": kw["R"], "kept": n_kept}
            common = {"model": model, "case": label, "shape": shape,
                      "library": "none (no single PyTorch call)",
                      "library_ms": None, "bound_by": "bytes"}
            yield {"name": "moe_route", **common,
                   "check": check, "same_bits": same,
                   "max_abs_err": err, "tol": moe_ops.ROUTE_TOL * scale,
                   "ms": timed(route, 20),
                   "device_ms": device_ms_by_name([route] * 10,
                                                  ROUTE_KERNELS),
                   "host_us": host_us(route, 50),
                   "plain_ms": timed(plain, 5, warmup=1),
                   "plain_device_ms": plain_dev,
                   "plain_device_kernels": plain_kernels,
                   "bound_ms": bound_ms(nbytes, 0.0),
                   "ok": check["ok"] and check["layout_equal"] is not False
                   and same}
            out = torch.randn(kw["R"], d, generator=g, device=dev)
            shared = (torch.randn(n, d, generator=g, device=dev)
                      if has_shared else None)
            rows, w = want.rows.reshape(n, k), want.weights.reshape(n, k)
            comb = lambda: moe_ops.moe_combine(  # noqa: E731
                out, rows, w, shared)
            plain_c = lambda: moe_ops.moe_combine_plain(  # noqa: E731
                out, rows, w, shared)
            y, y2, yp = comb(), comb(), plain_c()
            torch.cuda.synchronize()
            err = float((y - yp).abs().max())
            nbytes = (n_kept * d * 4 + A * 12 + n * d * 4
                      + (n * d * 4 if has_shared else 0))
            plain_dev, plain_kernels = device_kernels(plain_c)
            yield {"name": "moe_combine", **common,
                   "shape": {**shape, "shared": has_shared},
                   "same_bits": bool(torch.equal(y, y2)),
                   "max_abs_err": err,
                   "tol": moe_ops.ROUTE_TOL * float(yp.abs().max()),
                   "ms": timed(comb, 20),
                   "device_ms": device_ms_by_name([comb] * 10,
                                                  COMBINE_KERNELS),
                   "host_us": host_us(comb, 50),
                   "plain_ms": timed(plain_c, 5, warmup=1),
                   "plain_device_ms": plain_dev,
                   "plain_device_kernels": plain_kernels,
                   "bound_ms": bound_ms(nbytes, 0.0),
                   "ok": err <= moe_ops.ROUTE_TOL * float(yp.abs().max())
                   and bool(torch.equal(y, y2))}
            del x, out, shared, got, again, want


# the whole MoE layers timed and checked: (model, ticks)
MOE_LAYERS = (("llama4-scout-17b-a16e", MOE_TICKS),
              ("mixtral-8x22b", MOE_TICKS[:1]))


def moe_layer(dev, g, cfg):
    """One MoE layer of ``cfg`` at full width, its expert stacks and
    shared expert M8F8 (the router f32), drawn one matrix at a time."""
    from repro_torch.core import quant
    from repro_torch.models import layers, moe

    d, ff, E = cfg.d_model, cfg.d_ff, cfg.moe.n_experts
    p = {"router": layers.dense_init(g, (d, E), device=dev,
                                     dtype=torch.float32)}
    names = ["w1", "w2"] + (["w3"] if cfg.mlp.startswith("gated") else [])
    for name in names:
        shape = (E, ff, d) if name == "w2" else (E, d, ff)
        w = layers.dense_init(g, shape, fan_in=shape[1], device=dev,
                              dtype=torch.float32)
        p[name] = quant.quantize_slices(w, 8)
        del w
    if cfg.moe.shared_expert:
        mlp = layers.init_mlp(cfg, g, device=dev, dtype=torch.float32)
        p["shared"] = {k: quant.quantize(v, 8) for k, v in mlp.items()}
    assert moe.live_slots(p["w1"]) == E
    return p


def moe_layer_cases(dev, g, layers_of=MOE_LAYERS):
    """A whole dropless MoE layer (``moe.apply_moe`` on CUDA tensors: the
    router's product, ``moe_route``, the grouped products, the activation,
    ``moe_combine``; llama4-scout's shared expert on the crossbar) at full
    width, held at ``CB_TOL`` of max |y| on the real tokens against
    ``streamed_moe`` (each expert's FF over its tokens with that expert's
    weights dequantized alone, the routing in torch ops); its device ms
    and device kernels a call (every kernel), and the ms of those that are
    neither the grouped nor the crossbar kernels (the layer's small
    kernels), beside the port kernels' launches a call."""
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.models import moe

    for model, ticks in layers_of:
        cfg = get_config(model)
        p = moe_layer(dev, g, cfg)
        p_ref = dequantize_but_experts(p)      # the shared expert in f32
        for label, B, T in ticks:
            x = torch.randn(B, T, cfg.d_model, generator=g, device=dev)
            mask = _tick_mask(dev, label, B, T)
            run = lambda: moe.apply_moe(  # noqa: E731
                cfg, p, x, token_mask=mask, dispatch="dropless")[0]
            kernels.reset_launches()
            y = run()
            launches = {k: n for k, n in kernels.LAUNCHES.items() if n}
            ref = streamed_moe(cfg, p_ref, x)[0]
            torch.cuda.synchronize()
            err = float((y - ref)[mask].abs().max())
            tol = CB_TOL * float(ref[mask].abs().max())
            dev_ms, n_kernels = device_kernels(run)
            big = device_ms_by_name([run] * 3, GROUPED_KERNELS + CB_KERNELS)
            yield {"name": "moe_layer", "model": model, "case": label,
                   "shape": {"B": B, "T": T, "d": cfg.d_model,
                             "d_ff": cfg.d_ff, "E": cfg.moe.n_experts,
                             "top_k": cfg.moe.top_k,
                             "real_tokens": int(mask.sum())},
                   "launches": launches, "max_abs_err": err, "tol": tol,
                   "ms": timed(run, 10), "device_ms": dev_ms,
                   "device_kernels": n_kernels,
                   "grouped_and_crossbar_device_ms": big,
                   "other_device_ms": dev_ms - big,
                   "plain": "streamed_moe (torch routing, each expert "
                            "dequantized alone)",
                   "plain_ms": timed(lambda: streamed_moe(cfg, p_ref, x),
                                     2, warmup=1)}
            del x, y, ref
        del p, p_ref
        gc.collect()
        torch.cuda.empty_cache()


def slice18_cases(dev, g):
    """The MoE decode's kernels (slice 18): ``moe_route`` and
    ``moe_combine`` at the three MoE models' ticks, then whole layers."""
    return (moe_route_cases(dev, g), moe_layer_cases(dev, g))


def slice15_cases(dev, g):
    """The MoE models' kernels: the grouped crossbar at llama4-scout's 16
    and mixtral's 8 expert stacks (int8 and int4), and their attention."""
    return (grouped_cases(dev, g, "llama4-scout-17b-a16e", 16, LLAMA4_KN,
                          dists=GROUPED_DISTS + ("decode_top2",)),
            grouped_cases(dev, g, "mixtral-8x22b", 8, MIXTRAL_KN),
            moe_attention_cases(dev, g))


def path_cases(dev, g):
    """The kernel phase's cases: every kernel at the serve and train
    paths' shapes."""
    return (crossbar_cases(dev, g, "llama3.2-1b", LLAMA_KN, (8, 4),
                           extra_kn=(8192, 2048)),
            crossbar_cases(dev, g, "rwkv6-7b", RWKV_KN, (8,),
                           extra_kn=(14336, 4096)),
            crossover_cases(dev, g),
            crossbar_cases(dev, g, "paper-gpt2-medium", PAPER_KN, (8,)),
            flash_cases(dev, g, "llama3.2-1b", 32, 8),
            paged_cases(dev, g, "llama3.2-1b", 32, 8),
            # the paper models' attention: 16 heads, a group of 1
            flash_cases(dev, g, "paper-gpt2-medium", 16, 16),
            paged_cases(dev, g, "paper-gpt2-medium", 16, 16),
            wkv_cases(dev, g),
            # the backward kernels of the train step
            crossbar_t_cases(dev, g), flash_bwd_cases(dev, g),
            # gemma2-9b's matrices and attention
            crossbar_cases(dev, g, "gemma2-9b", GEMMA_KN, (8,)),
            gemma_attention_cases(dev, g),
            # the MoE models' expert stacks and attention
            *slice15_cases(dev, g),
            # the head-dim-128 forwards' attention
            head_dim_128_cases(dev, g),
            # jamba's selective scan, Mamba projections and experts
            jamba_cases(dev, g),
            # the MoE layer's routing and combine kernels, whole layers
            *slice18_cases(dev, g))


def slice10_cases(dev, g):
    """The crossbar kernels' int4 cases and the Fig. 13 fine-tunes' shapes,
    taken after the train phase, so that the serve and train phases run
    after the same kernel cases as before they were added: int4
    ``crossbar_matmul`` at the paper models' shapes, int8 and int4 at Fig.
    13's (M = 16 x 64), and ``CB_T_CASES_SLICE10``."""
    return (crossbar_cases(dev, g, "paper-gpt2-medium", PAPER_KN, (4,)),
            crossbar_cases(dev, g, "fig13", FIG13_KN, (8, 4),
                           ms=(FIG13_M,)),
            crossbar_t_cases(dev, g, CB_T_CASES_SLICE10))


def kernel_phase(dev, cases_of=path_cases):
    """Every case of ``cases_of(dev, g)`` against its plain version, one
    line each; raises if any disagrees or measured no kernel."""
    g = torch.Generator(device=dev).manual_seed(0)
    cases = []
    for gen in cases_of(dev, g):
        for case in gen:
            case.setdefault("ok", case["max_abs_err"] <= case["tol"])
            # a device time of 0 means the trace held no kernel of that
            # name (a renamed kernel): the case did not measure its kernel
            if not case["device_ms"] > 0:
                case["ok"] = False
                case["fault"] = "no kernel of the case's names in the trace"
            emit({"phase": "kernel", **case})
            cases.append(case)
    bad = [c for c in cases if not c["ok"]]
    if bad:
        raise AssertionError(f"{len(bad)} kernel case(s) disagree with their "
                             f"plain versions: {bad}")
    return cases


LATE_FLAG = "--late-kernel-cases"


def late_kernel_phase():
    """``slice10_cases`` and ``slice11_cases`` in a process of their own
    (this script with ``LATE_FLAG``, the kernels already built): after the
    train phase's traces, a trace in the same process loses kernel records
    (on one NVIDIA H100 80GB HBM3 at 700 W, after some 10^5 traced
    events, 30% of a later trace's: ``benchmarks/torch_trace_volume.py``),
    so their device times are taken in a fresh one. Its case lines are
    emitted here; raises if it fails."""
    proc = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                           LATE_FLAG], capture_output=True, text=True,
                          timeout=600)
    cases = []
    for line in proc.stdout.splitlines():
        if line.startswith('{"phase": "kernel"'):
            cases.append(json.loads(line))
            print(line, flush=True)
    if proc.returncode != 0:
        raise AssertionError(f"the late kernel cases failed (rc "
                             f"{proc.returncode}): {proc.stderr[-4000:]}")
    return cases


# ---------------------------------------------------------------------------
# phase 4: serve each model at full width through the port's paged engine
# ---------------------------------------------------------------------------

# kernel -> launches per engine tick / per forward, for each model's path:
# one crossbar launch per quantized layer matrix (``n_quant``: seven per
# layer for llama wq/wk/wv/wo/w1/w3/w2 and rwkv r/k/v/g/o/ck/cv, six for
# the GELU models' wq/wk/wv/wo/w1/w2), one attention or wkv recurrence per
# layer ("wkv": the two wkv kernels together; the wrapper picks one by the
# chunk's T)
# (the engine's sliding-window layers run the ring kernel, its global ones
# the paged kernel; the forward's dense cache runs the contiguous kernel on
# every attention layer)
def path_launches(cfg, n_quant):
    L = cfg.n_layers
    if cfg.block_pattern == ("rwkv",):
        return ({"crossbar_matmul": n_quant, "wkv": L},
                {"crossbar_matmul": n_quant, "wkv": L})
    sliding = sum(cfg.attn_kind(i) == "sliding" for i in range(L))
    engine = {"crossbar_matmul": n_quant,
              "paged_flash_attention": L - sliding,
              "ring_flash_attention": sliding}
    return ({k: n for k, n in engine.items() if n},
            {"crossbar_matmul": n_quant, "flash_attention": L})


def full_attention_only(cfg) -> bool:
    """Every layer full attention: the engines' prefix cache is on."""
    return all(cfg.block_kind(i) == "attn" and cfg.attn_kind(i) == "full"
               for i in range(cfg.n_layers))


def merge_wkv(launches):
    """Nonzero launch counts, the two wkv kernels summed as "wkv"."""
    out = {k: n for k, n in launches.items()
           if n and k not in WKV_LAUNCH_KEYS}
    wkv = sum(launches.get(k, 0) for k in WKV_LAUNCH_KEYS)
    if wkv:
        out["wkv"] = wkv
    return out


def quantized_matrices(tree) -> int:
    """Layer matrices on the crossbar path (leaves are stacked per layer)."""
    from repro_torch.core import quant
    if quant.is_quantized(tree):
        return tree.codes.shape[0]
    if isinstance(tree, dict):
        return sum(quantized_matrices(v) for v in tree.values())
    if isinstance(tree, (tuple, list)):
        return sum(quantized_matrices(v) for v in tree)
    return 0


def teacher_forced(cfg, params, adapters, prompt, generated, adapter_id,
                   exec_cfg, dev):
    """Logits at each generated position: prefill the prompt, then decode
    the engine's own tokens one at a time over a dense cache."""
    from repro_torch.core import lora as lora_lib
    from repro_torch.models import transformer as tfm

    ads = lora_lib.stack_adapters(adapters)
    idx = torch.tensor([adapter_id], device=dev)
    toks = torch.as_tensor(np.asarray(prompt), device=dev)[None]
    lg, cache, _ = tfm.forward(cfg, params, {"tokens": toks}, lora=ads,
                               adapter_idx=idx, mode="prefill",
                               prefill_cache_len=len(prompt) + len(generated),
                               exec_cfg=exec_cfg)
    rows = [lg[0, -1]]
    for tok in generated[:-1]:
        lg, cache, _ = tfm.forward(
            cfg, params, {"tokens": torch.tensor([[tok]], device=dev)},
            lora=ads, adapter_idx=idx, mode="decode", cache=cache,
            exec_cfg=exec_cfg)
        rows.append(lg[0, -1])
    return torch.stack(rows)


def error_by_depth(cfg, params, plain_params, adapters, req, ref_ec, dev):
    """Kernel vs plain logits of one whole-prompt forward through the first
    L = P, 2P, 4P, ... layers only (P the scan period: 1, gemma2's 2): how
    the difference grows with depth, and where along the prompt it sits
    (its largest value, the position of that, the median over positions
    and the last position)."""
    from repro_torch.core import lora as lora_lib
    from repro_torch.core.lora import scan_period
    from repro_torch.models import transformer as tfm

    kw = dict(lora=lora_lib.stack_adapters(adapters),
              adapter_idx=torch.tensor([req.adapter_id], device=dev))
    toks = {"tokens": torch.as_tensor(np.asarray(req.prompt), device=dev)[None]}
    out, L = {}, scan_period(cfg)
    while L <= cfg.n_layers:
        cut = dataclasses.replace(cfg, n_layers=L)
        lk = tfm.forward(cut, params, toks, **kw)[0]
        lp = tfm.forward(cut, plain_params, toks, exec_cfg=ref_ec, **kw)[0]
        err = (lk - lp)[0].abs().amax(dim=-1)              # per position
        out[L] = {"max_abs": float(err.max()), "at": int(err.argmax()),
                  "median": float(err.median()), "last": float(err[-1]),
                  "max_abs_logit": float(lp.abs().max())}
        L *= 2
    return out


# the dense engine's traced window: its first tick and its length
DENSE_TRACE_AT, DENSE_TRACED = 8, 8


def dense_serve(dev, cfg, params, adapters, reqs, plain_params, ref_ec,
                n_quant, paged, *, max_len, max_batch, seed, checked):
    """The dense oracle engine on the paged engine's weights, adapters and
    requests: every prompt prefilled whole (eagerly, one forward each),
    then one decode step over all ``max_batch`` slots a tick, captured as
    one CUDA graph at the first decode tick and replayed after that. Its
    sampled logits against the teacher-forced plain forward of its own
    tokens (``LOGIT_TOL``); its launches exactly one crossbar per quantized
    matrix and one contiguous flash kernel per layer, per prefill and per
    decode tick; its KV bytes beside the paged engine's. ``paged``: the
    paged engine's serve line."""
    from repro_torch import kernels
    from repro_torch.serve.api import Request, make_engine

    eng = make_engine(cfg, params, adapters, mode="dense", device=dev,
                      max_batch=max_batch, max_len=max_len,
                      record_logits=True, seed=seed)
    fresh = [Request(uid=r.uid, prompt=r.prompt,
                     max_new_tokens=r.max_new_tokens, adapter_id=r.adapter_id)
             for r in reqs]
    kernels.reset_launches()
    for r in fresh:
        eng.submit(r)
    tick_s, trace = [], None
    t_serve = time.perf_counter()
    while eng.queue or any(r is not None for r in eng.slot_req):
        if len(tick_s) == DENSE_TRACE_AT and retrace(trace):
            # a window of replayed decode ticks, every slot busy, traced
            trace = traced_ticks(eng, DENSE_TRACED, eng.step, trace,
                                 TRACE_ATTEMPTS)
            continue
        t = time.perf_counter()
        eng.step()
        torch.cuda.synchronize()
        tick_s.append(time.perf_counter() - t)
    serve_s = time.perf_counter() - t_serve
    launches = {k: n for k, n in kernels.LAUNCHES.items() if n}
    done = eng.finished
    st = eng.stats()
    # every tick decoded (the loop runs while a slot is busy); each request
    # was prefilled once
    ticks = len(tick_s) + (trace["ticks_run"] if trace else 0)
    runs = ticks + len(fresh)
    want = {"crossbar_matmul": n_quant * runs,
            "flash_attention": cfg.n_layers * runs}
    checks = logit_checks(cfg, plain_params, adapters, eng, done, checked,
                          ref_ec, dev)
    cs = st.compile
    result = {
        "phase": "serve_dense", "model": cfg.name, "base": "M8F8",
        "adapters": len(adapters), "requests": len(fresh),
        "max_batch": max_batch, "max_len": max_len, "ticks": ticks,
        "serve_s": serve_s, "prefill_s": eng.prefill_s,
        "first_tick_ms": 1e3 * tick_s[0],
        "ms_per_decode_tick": 1e3 * statistics.median(tick_s[1:]),
        "decode_tick_ms": [1e3 * t for t in tick_s[1:]],
        "paged_ms_per_decode_tick": paged["ms_per_decode_tick"],
        "traced_decode_ticks": trace,
        "decode_tokens": st.decode_tokens,
        "prefill_tokens": st.prefill_tokens,
        "decode_tok_s": st.decode_tokens / max(sum(tick_s[1:]), 1e-9),
        "prefill_signatures": list(cs.prefill_signatures),
        "kv_bytes": st.kv_bytes, "paged_kv_bytes": paged["kv_bytes"],
        "graphs": {"captured": cs.compiled_steps, "replays": cs.replays,
                   "capture_ms": cs.capture_ms,
                   "pool_bytes": cs.graph_pool_bytes},
        "launches": launches, "expected_launches": want,
        "tokens_equal_paged": sum(done[r.uid].generated == r.generated
                                  for r in reqs),
        "logit_checks": checks, "logit_tol": LOGIT_TOL,
    }
    emit(result)
    problems = []
    if sorted(done) != sorted(r.uid for r in fresh) or any(
            len(done[r.uid].generated) != r.max_new_tokens for r in fresh):
        problems.append("unfinished or short requests")
    if launches != want:
        problems.append(f"launched {launches}, expected {want}")
    # the first decode tick ran eagerly and captured the graph; every later
    # one replayed it
    if cs.compiled_steps != 1 or cs.replays != ticks - 1:
        problems.append(f"{ticks} ticks, {cs.compiled_steps} graphs, "
                        f"{cs.replays} replays")
    if retrace(trace) or not trace["replayed"]:
        problems.append(f"no traced window of replayed ticks: {trace}")
    bad = [u for u, c in checks.items() if not c["finite"]
           or c["engine_vs_plain"] is None
           or c["engine_vs_plain"] > LOGIT_TOL]
    if bad:
        problems.append(f"sampled logits differ from the plain forward: "
                        f"{checks}")
    if problems:
        raise AssertionError("dense engine: " + "; ".join(problems))
    return result


def serve_loop(eng, reqs, trace_at=None):
    """Submit ``reqs`` (fresh copies) to ``eng`` and tick it to the end, a
    sync after each tick: (finished requests, tick seconds, tick kinds:
    "prefill" for a tick that prefilled a token, else "decode", decoded
    tokens per tick, the traced window). With ``trace_at``, the
    ``SPEC_TRACED`` ticks after the ``trace_at``-th run in a
    ``traced_ticks`` window instead, left out of the three lists."""
    from repro_torch.serve.api import Request

    for r in reqs:
        eng.submit(Request(uid=r.uid, prompt=r.prompt,
                           max_new_tokens=r.max_new_tokens,
                           adapter_id=r.adapter_id))
    tick_s, kind, decoded, trace = [], [], [], None
    while eng.queue or eng.sched.active():
        if len(tick_s) == trace_at and retrace(trace):
            trace = traced_ticks(eng, SPEC_TRACED, eng.step, trace,
                                 TRACE_ATTEMPTS)
            continue
        pf, dc = eng.prefill_tokens, eng.decode_tokens
        t = time.perf_counter()
        eng.step()
        torch.cuda.synchronize()
        tick_s.append(time.perf_counter() - t)
        kind.append("prefill" if eng.prefill_tokens > pf else "decode")
        decoded.append(eng.decode_tokens - dc)
    if trace is not None and not trace["complete"]:
        raise AssertionError(f"the serve ended before a traced window "
                             f"held every port kernel: {trace}")
    return eng.finished, tick_s, kind, decoded, trace


def logit_checks(cfg, plain_params, adapters, eng, done, uids, ref_ec, dev):
    """Every recorded logits row of each request in ``uids`` against the
    teacher-forced plain forward of its own tokens: per request the max
    absolute difference, the max |logit| of the reference and the share of
    positions whose argmax agrees."""
    checks = {}
    for uid in uids:
        r = done[uid]
        ref = teacher_forced(cfg, plain_params, adapters, r.prompt,
                             r.generated, r.adapter_id, ref_ec, dev)
        lg = torch.stack(eng.sampled_logits[uid])
        checks[uid] = {
            "positions": int(ref.shape[0]),
            "engine_vs_plain": (float((lg - ref).abs().max())
                                if lg.shape == ref.shape else None),
            "finite": bool(torch.isfinite(lg).all()),
            "max_abs_logit": float(ref.abs().max()),
            "argmax_agree": float((lg.argmax(-1) == ref.argmax(-1))
                                  .float().mean()),
        }
    return checks


def spec_serve(dev, cfg, params, adapters, reqs, plain_params, ref_ec,
               base_tokens, spec_off, *, drafter, k, max_new, base, max_len,
               max_slots, page_size, prefill_chunk, seed):
    """Speculative decoding through the port's paged engine on the serve
    phase's adapters and requests (``max_new`` new tokens each), with
    ``record_logits``; the counts zeroed just before and read just after.

    ``drafter="ngram"`` serves the serve phase's M8F8 weights ``params``;
    ``"selfdraft"`` serves the unquantized ``plain_params`` (the
    self-drafter quantizes them to int4 itself and takes no quantized
    base), its draft calls CUDA graphs of their own. Every emitted token's
    logits row against the teacher-forced plain forward of the request's
    own tokens (``LOGIT_TOL``; rwkv6-7b ``RWKV_LOGIT_TOL_REL`` of the
    largest logit); every tick a verify-graph capture or replay; each
    kernel's launches exact: per tick one crossbar per quantized matrix of
    the target and one paged flash (one wkv) per layer, per draft call k
    forwards of the drafter (one int4 crossbar per quantized matrix and one
    contiguous flash per layer each), and the draft graphs captured once a
    signature and replayed after. ``base_tokens``: the serve phase's
    tokens (spec off; ``tokens_equal_spec_off`` is reported, not held);
    ``spec_off``: its ms and tok/s to report beside."""
    from repro_torch import kernels
    from repro_torch.models import transformer as tfm
    from repro_torch.serve.api import make_engine
    from repro_torch.serve.spec import SpecConfig

    target = params if drafter == "ngram" else plain_params
    fresh = [dataclasses.replace(r, generated=[], done=False,
                                 finish_reason="", max_new_tokens=max_new)
             for r in reqs]
    eng = make_engine(cfg, target, adapters, mode="paged", device=dev,
                      max_slots=max_slots, max_len=max_len,
                      page_size=page_size, prefill_chunk=prefill_chunk,
                      spec=SpecConfig(k=k, drafter=drafter),
                      record_logits=True, seed=seed)
    kernels.reset_launches()
    t0 = time.perf_counter()
    done, tick_s, kind, decoded, trace = serve_loop(eng, fresh,
                                                    trace_at=SPEC_TRACE_AT)
    serve_s = time.perf_counter() - t0
    launches = {k_: n for k_, n in kernels.LAUNCHES.items() if n}
    st = eng.stats()
    cs, sp = st.compile, st.spec
    ticks = len(tick_s) + (trace["ticks_run"] if trace else 0)
    L = cfg.n_layers
    mixer = "wkv" if cfg.block_pattern == ("rwkv",) else "paged_flash_attention"
    want = {mixer: L * ticks}
    n_quant = quantized_matrices(target["layers"])
    if n_quant:
        want["crossbar_matmul"] = n_quant * ticks
    draft = {}
    if drafter == "selfdraft":
        dr = eng.drafter
        n_qd = quantized_matrices(dr.qparams["layers"])
        want["crossbar_matmul"] = want.get("crossbar_matmul", 0) + (
            n_qd * k * dr.calls)
        want["flash_attention"] = L * k * dr.calls
        draft = {"calls": dr.calls, "signatures": [list(s) for s in
                                                   sp.draft_signatures],
                 "graphs": len(dr._graphs), "replays": dr.replays,
                 "capture_ms": 1e3 * dr.capture_s,
                 "pool_bytes": dr.graph_pool_bytes,
                 "quantized_matrices": n_qd,
                 "bits": sorted({qt.bits for qt in tfm._quantized(
                     dr.qparams)})}
    uids = [r.uid for r in fresh]
    checks = logit_checks(cfg, plain_params, adapters, eng, done, uids,
                          ref_ec, dev)
    worst = max((c["engine_vs_plain"] for c in checks.values()
                 if c["engine_vs_plain"] is not None), default=None)
    tol = (RWKV_LOGIT_TOL_REL * max(c["max_abs_logit"]
                                    for c in checks.values())
           if cfg.block_pattern == ("rwkv",) else LOGIT_TOL)
    dc_s = [s for s, kd in zip(tick_s, kind) if kd == "decode"]
    dc_tokens = sum(n for n, kd in zip(decoded, kind) if kd == "decode")
    result = {
        "phase": "spec", "model": cfg.name, "base": base,
        "drafter": drafter, "k": k, "requests": len(fresh),
        "max_new": max_new, "ticks": ticks,
        "decode_ticks": len(dc_s), "serve_s": serve_s,
        "ms_per_decode_tick": 1e3 * sum(dc_s) / max(len(dc_s), 1),
        "decode_tok_s": dc_tokens / max(sum(dc_s), 1e-9),
        "spec_off_ms_per_decode_tick": spec_off["ms_per_decode_tick"],
        "spec_off_decode_tok_s": spec_off["decode_tok_s"],
        # the means above hold the ticks that captured a graph; the
        # medians are replayed ticks
        "median_ms_per_decode_tick": 1e3 * statistics.median(dc_s),
        "spec_off_median_ms_per_decode_tick": statistics.median(
            spec_off["decode_tick_ms"]),
        "decode_tokens_per_decode_tick": dc_tokens / max(len(dc_s), 1),
        "decode_tick_ms": [1e3 * t for t in dc_s],
        "traced_ticks": trace,
        "spec_steps": sp.steps, "accept_rate": sp.accept_rate,
        "drafted_tokens": sp.drafted_tokens,
        "accepted_tokens": sp.accepted_tokens,
        "rolled_back_tokens": sp.rolled_back_tokens,
        "rolled_back_pages": st.scheduler.rolled_back_pages,
        "recurrent_rollbacks": sp.recurrent_rollbacks,
        "decode_tokens": st.decode_tokens,
        "prefill_tokens": st.prefill_tokens,
        "tokens_equal_spec_off": sum(
            done[u].generated == base_tokens[u][:max_new] for u in uids),
        "graphs": {"captured": cs.compiled_steps, "replays": cs.replays,
                   "capture_ms": cs.capture_ms,
                   "pool_bytes": cs.graph_pool_bytes,
                   "signatures": [list(s) for s in cs.step_signatures]},
        "draft": draft, "launches": launches, "expected_launches": want,
        "logit_checks": checks, "logit_tol": tol, "worst": worst,
    }
    emit(result)
    problems = []
    if sorted(done) != sorted(uids) or any(
            len(done[u].generated) != max_new for u in uids):
        problems.append("unfinished or short requests")
    if merge_wkv(launches) != want:
        problems.append(f"launched {launches}, expected {want}")
    if (cs.compiled_steps != len(cs.step_signatures)
            or cs.compiled_steps + cs.replays != ticks):
        problems.append(f"{ticks} ticks, {cs.compiled_steps} verify graphs "
                        f"of {len(cs.step_signatures)} signatures, "
                        f"{cs.replays} replays")
    if draft and (draft["graphs"] != len(draft["signatures"])
                  or draft["graphs"] + draft["replays"] != draft["calls"]
                  or not draft["replays"] or draft["bits"] != [4]):
        problems.append(f"draft graphs: {draft}")
    if not sp.drafted_tokens or not sp.steps:
        problems.append("nothing was drafted")
    if trace is None:
        problems.append("no traced window of verify ticks")
    if cfg.block_pattern == ("rwkv",) and not sp.recurrent_rollbacks:
        problems.append("no recurrent rollback was exercised")
    bad = [u for u, c in checks.items() if not c["finite"]
           or c["engine_vs_plain"] is None or c["engine_vs_plain"] > tol]
    if bad:
        problems.append(f"logits of requests {bad} differ from the plain "
                        f"forward by more than {tol}")
    if problems:
        raise AssertionError(f"spec ({drafter}, {cfg.name}): "
                             + "; ".join(problems))
    del eng
    gc.collect()
    return result


PREFIX_FILE = Path(__file__).resolve().parent / "build" / "chip_smoke_prefix.npz"
# a spec run's traced window of verify ticks: its first tick and its length
# (after the prompts' prefill, every graph of a decode tick captured)
SPEC_TRACE_AT, SPEC_TRACED = 12, 4


def persist_serve(dev, cfg, params, adapters, req, plain_params, ref_ec,
                  n_quant, served, *, max_len, max_slots, page_size,
                  prefill_chunk, seed):
    """Prefix-cache persistence on the card: the serve phase's engine
    ``served`` (spec off) saves its index to ``PREFIX_FILE``; a fresh engine
    on the same weights loads it at construction (``loaded_pages`` equal to
    the pages saved, the restored pool pages bit-equal to the file's
    arrays), then serves ``req`` (a request of the shared prefix) alone:
    a prefix hit on its first tick, its logits within ``LOGIT_TOL`` of the
    teacher-forced plain forward, the launches exact per tick (the counts
    zeroed just before and read just after)."""
    from repro_torch import kernels
    from repro_torch.models import kvcache
    from repro_torch.serve.api import make_engine

    PREFIX_FILE.parent.mkdir(parents=True, exist_ok=True)
    t = time.perf_counter()
    saved = served.save_prefix_cache(str(PREFIX_FILE))
    save_s = time.perf_counter() - t
    t = time.perf_counter()
    eng = make_engine(cfg, params, adapters, mode="paged", device=dev,
                      max_slots=max_slots, max_len=max_len,
                      page_size=page_size, prefill_chunk=prefill_chunk,
                      prefix_cache_path=str(PREFIX_FILE), record_logits=True,
                      seed=seed)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t
    loaded = eng.stats().prefix_cache.loaded_pages
    z = np.load(PREFIX_FILE)
    restored = kvcache.gather_pages(eng.cache, eng.prefix.pages())
    bit_equal = all(np.array_equal(arr, z[f"pool_{li}_{name}"])
                    for li, entry in enumerate(restored)
                    for name, arr in entry.items())
    fresh = dataclasses.replace(req, generated=[], done=False,
                                finish_reason="")
    kernels.reset_launches()
    eng.submit(fresh)
    eng.step()
    torch.cuda.synchronize()
    first_hit = eng.stats().prefix_cache.hit_tokens
    done, tick_s, _, _, _ = serve_loop(eng, [])
    launches = {k: n for k, n in kernels.LAUNCHES.items() if n}
    ticks = len(tick_s) + 1
    want = {"crossbar_matmul": n_quant * ticks,
            "paged_flash_attention": cfg.n_layers * ticks}
    checks = logit_checks(cfg, plain_params, adapters, eng, done,
                          [fresh.uid], ref_ec, dev)
    st = eng.stats()
    result = {"phase": "persist", "model": cfg.name, "file": PREFIX_FILE.name,
              "file_bytes": PREFIX_FILE.stat().st_size,
              "pages_saved": saved, "loaded_pages": loaded,
              "restored_bit_equal": bit_equal, "save_s": save_s,
              "construct_and_load_s": load_s, "request": fresh.uid,
              "prompt_tokens": len(fresh.prompt),
              "first_tick_hit_tokens": first_hit,
              "prefill_tokens": st.prefill_tokens, "ticks": ticks,
              "graphs": st.compile.compiled_steps,
              "replays": st.compile.replays,
              "launches": launches, "expected_launches": want,
              "logit_checks": checks, "logit_tol": LOGIT_TOL}
    emit(result)
    problems = []
    if not saved or loaded != saved or not bit_equal:
        problems.append(f"{saved} pages saved, {loaded} loaded, bit-equal "
                        f"{bit_equal}")
    if first_hit <= 0:
        problems.append("no prefix hit on the first tick")
    if launches != want:
        problems.append(f"launched {launches}, expected {want}")
    c = checks[fresh.uid]
    if (not c["finite"] or c["engine_vs_plain"] is None
            or c["engine_vs_plain"] > LOGIT_TOL):
        problems.append(f"logits differ from the plain forward: {c}")
    if st.compile.compiled_steps + st.compile.replays != ticks:
        problems.append(f"{ticks} ticks, {st.compile.compiled_steps} graphs, "
                        f"{st.compile.replays} replays")
    if problems:
        raise AssertionError("prefix persistence: " + "; ".join(problems))
    del eng
    gc.collect()
    return result


def serve_phase(dev, cfg, *, n_requests=8, max_new=32, prompt_range=(64, 512),
                shared_prefix=256, max_len=1024, max_slots=8, page_size=16,
                prefill_chunk=128, seed=0, dense=False, specs=(),
                persist=False, long_prompts=None, trace_decode=None):
    """``long_prompts`` (n, (lo, hi)): the last n requests' prompts are
    drawn from [lo, hi] instead (past a sliding window), one of them is
    the long request teacher-forced, and the engine is freed before the
    plain reference (returned as None). ``trace_decode`` (at, n): once
    ``at`` ticks in a row have decoded, ``n`` ticks run in a
    ``traced_ticks`` window (counted with the serve's ticks)."""
    from repro_torch import kernels
    from repro_torch.configs.base import QuantConfig
    from repro_torch.core import lora as lora_lib
    from repro_torch.core import quant
    from repro_torch.models import kvcache, transformer as tfm
    from repro_torch.serve.api import Request, make_engine

    g = torch.Generator(device=dev).manual_seed(seed)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    base = tfm.init_params(cfg, g, device=dev)
    params = quant.quantize_params(base, QuantConfig(mha_bits=8, ff_bits=8))
    del base
    gc.collect()
    adapters = []
    for _ in range(2):
        ad = lora_lib.init_lora_params(cfg, g, device=dev)
        for entry in ad["layers"]:
            for ab in entry.values():    # a "trained" adapter: B != 0
                ab["b"].normal_(0.0, 0.02, generator=g)
        adapters.append(ad)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    n_quant = quantized_matrices(params["layers"])
    if not n_quant or n_quant % cfg.n_layers:
        raise AssertionError(f"{n_quant} quantized matrices in "
                             f"{cfg.n_layers} layers")
    resident_gb = torch.cuda.memory_allocated(dev) / 1e9

    rng = np.random.default_rng(seed)
    prefix = rng.integers(0, cfg.vocab_size, shared_prefix).astype(np.int32)
    reqs = []
    n_long, long_range = long_prompts or (0, None)
    for i in range(n_requests):
        lo, hi = (long_range if i >= n_requests - n_long else prompt_range)
        plen = int(rng.integers(lo, hi + 1))
        prompt = rng.integers(0, cfg.vocab_size, plen).astype(np.int32)
        if i in (1, 2):                  # two requests share a prefix
            plen = max(plen, shared_prefix + 16)
            prompt = np.concatenate([prefix, rng.integers(
                0, cfg.vocab_size, plen - shared_prefix).astype(np.int32)])
        reqs.append(Request(uid=i, prompt=prompt, max_new_tokens=max_new,
                            adapter_id=1 if i in (1, 2) else i % 2))

    eng = make_engine(cfg, params, adapters, mode="paged", device=dev,
                      max_slots=max_slots, max_len=max_len,
                      page_size=page_size, prefill_chunk=prefill_chunk,
                      record_logits=True, seed=seed)
    kernels.reset_launches()
    for r in reqs:
        eng.submit(r)
    tick_s, tick_kind, tick_decoded, tick_chunk = [], [], [], []
    trace, n_traced = None, 0
    t_serve = time.perf_counter()
    while eng.queue or eng.sched.active():
        if (trace_decode is not None and retrace(trace)
                and tick_kind[-trace_decode[0]:] == ["decode"]
                * trace_decode[0]):
            # a window of graph decode ticks, traced
            trace = traced_ticks(eng, trace_decode[1], eng.step, trace,
                                 TRACE_ATTEMPTS)
            n_traced = trace["ticks_run"]
            continue
        pf, dc = eng.prefill_tokens, eng.decode_tokens
        chunk = kernels.LAUNCHES["rwkv6_wkv_chunk"]
        t = time.perf_counter()
        eng.step()
        torch.cuda.synchronize()
        tick_s.append(time.perf_counter() - t)
        tick_kind.append("prefill" if eng.prefill_tokens > pf else "decode")
        tick_decoded.append(eng.decode_tokens - dc)
        tick_chunk.append(kernels.LAUNCHES["rwkv6_wkv_chunk"] - chunk)
    serve_s = time.perf_counter() - t_serve
    done = eng.finished
    serve_launches = dict(kernels.LAUNCHES)
    n_ticks = len(tick_s) + n_traced
    # the kernel path of forward (over a dense cache): a prefix sharer and
    # another, or a long request and a short one
    checked = [n_requests - 1, 0] if n_long else [1, 0]
    kernels.reset_launches()
    kernel_logits = {
        uid: teacher_forced(cfg, params, adapters, done[uid].prompt,
                            done[uid].generated, done[uid].adapter_id,
                            tfm.ExecConfig(), dev) for uid in checked}
    torch.cuda.synchronize()
    forward_launches = dict(kernels.LAUNCHES)
    n_forwards = sum(len(done[uid].generated) for uid in checked)

    if sorted(done) != list(range(n_requests)):
        raise AssertionError(f"unfinished requests: {sorted(done)}")
    short = {u: len(r.generated) for u, r in done.items()
             if len(r.generated) != max_new}
    if short:
        raise AssertionError(f"requests stopped early: {short}")
    per_tick, per_forward = path_launches(cfg, n_quant)
    for path, got, want in (
            ("engine", serve_launches,
             {k: n * n_ticks for k, n in per_tick.items()}),
            ("forward", forward_launches,
             {k: n * n_forwards for k, n in per_forward.items()})):
        # every kernel of the path, exactly as often as the path runs it;
        # no other kernel
        if merge_wkv(got) != want:
            raise AssertionError(f"the {path} launched {got}, expected "
                                 f"{want}")
        # rwkv: the prompts' chunks ran the chunked kernel, the decode
        # steps the recurrence
        if "wkv" in want and not all(got[k] for k in WKV_LAUNCH_KEYS):
            raise AssertionError(f"the {path} ran one wkv kernel only: "
                                 f"{got}")
    if any(n for n, kind in zip(tick_chunk, tick_kind) if kind == "decode"):
        raise AssertionError("a pure decode tick ran the chunked wkv kernel")
    st = eng.stats()
    cs = st.compile
    # every tick ran the mixed step as a CUDA graph: the first tick of each
    # signature eagerly before capturing it, every later one by replay
    if (cs.compiled_steps != len(cs.step_signatures)
            or cs.compiled_steps + cs.replays != n_ticks):
        raise AssertionError(f"{n_ticks} ticks, {cs.compiled_steps} "
                             f"graphs of {len(cs.step_signatures)} "
                             f"signatures, {cs.replays} replays")
    if trace_decode is not None and (retrace(trace)
                                     or not trace["replayed"]):
        raise AssertionError(f"no traced window of replayed decode ticks: "
                             f"{trace}")
    if st.prefix_cache.enabled != full_attention_only(cfg):
        raise AssertionError(f"prefix cache enabled={st.prefix_cache.enabled}"
                             f" on {cfg.name}")
    kv_bytes = kvcache.cache_bytes(eng.cache)
    sampled = {uid: torch.stack(eng.sampled_logits[uid]) for uid in checked}
    if n_long:
        # the plain reference's f32 weights need the engine's memory
        del eng
        gc.collect()
        torch.cuda.empty_cache()
        eng = None

    # reference: the same forward with the plain versions
    plain_params = quant.dequantize_params(params)
    ref_ec = tfm.ExecConfig(attn_impl="ref", rwkv_impl="ref")
    checks = {}
    for uid in checked:
        r = done[uid]
        ref = teacher_forced(cfg, plain_params, adapters, r.prompt,
                             r.generated, r.adapter_id, ref_ec, dev)
        eng_lg = sampled[uid]
        if not torch.isfinite(eng_lg).all():
            raise AssertionError(f"non-finite engine logits, request {uid}")
        if eng_lg.shape != ref.shape:
            raise AssertionError(f"logit shapes {eng_lg.shape} {ref.shape}")
        checks[uid] = {
            "positions": int(ref.shape[0]),
            "engine_vs_plain": float((eng_lg - ref).abs().max()),
            "kernel_forward_vs_plain": float(
                (kernel_logits[uid] - ref).abs().max()),
            "max_abs_logit": float(ref.abs().max()),
            "argmax_agree": float((eng_lg.argmax(-1) == ref.argmax(-1))
                                  .float().mean()),
        }
    worst = max(max(c["engine_vs_plain"], c["kernel_forward_vs_plain"])
                for c in checks.values())
    tol = (RWKV_LOGIT_TOL_REL * max(c["max_abs_logit"]
                                    for c in checks.values())
           if cfg.block_pattern == ("rwkv",) else LOGIT_TOL)
    by_depth = error_by_depth(cfg, params, plain_params, adapters,
                              done[checked[1]], ref_ec, dev)

    pf_s = sum(s for s, k in zip(tick_s, tick_kind) if k == "prefill")
    dc_s = sum(s for s, k in zip(tick_s, tick_kind) if k == "decode")
    dc_tokens = sum(n for n, k in zip(tick_decoded, tick_kind)
                    if k == "decode")
    n_dc_ticks = tick_kind.count("decode")
    result = {
        "phase": "serve", "model": cfg.name, "layers": cfg.n_layers,
        "d_model": cfg.d_model, "vocab": cfg.vocab_size, "base": "M8F8",
        "max_len": max_len, "prompt_lens": [len(r.prompt) for r in reqs],
        "checked": checked, "quantized_matrices": n_quant,
        "quantized_matrices_per_layer": n_quant // cfg.n_layers,
        "adapters": 2,
        "lora_rank": cfg.lora.rank, "requests": n_requests,
        "prompt_tokens": int(sum(len(r.prompt) for r in reqs)),
        "setup_s": setup_s, "serve_s": serve_s, "ticks": n_ticks,
        "traced_ticks": n_traced, "traced_decode_ticks": trace,
        "prefill_ticks": len(tick_s) - n_dc_ticks,
        "decode_ticks": n_dc_ticks,
        "ms_per_tick": 1e3 * serve_s / max(len(tick_s), 1),
        "ms_per_prefill_tick": 1e3 * pf_s / max(len(tick_s) - n_dc_ticks, 1),
        "ms_per_decode_tick": 1e3 * dc_s / max(n_dc_ticks, 1),
        "prefill_tick_ms": [1e3 * s for s, k in zip(tick_s, tick_kind)
                            if k == "prefill"],
        "decode_tick_ms": [1e3 * s for s, k in zip(tick_s, tick_kind)
                           if k == "decode"],
        "prefill_tokens": st.prefill_tokens,
        "decode_tokens": st.decode_tokens,
        # prefill ticks also carry the decode rows of other slots
        "prefill_tok_s": st.prefill_tokens / max(pf_s, 1e-9),
        "decode_tok_s": dc_tokens / max(dc_s, 1e-9),
        "tok_s": (st.prefill_tokens + st.decode_tokens) / serve_s,
        "prefix_cache_enabled": st.prefix_cache.enabled,
        "prefix_hit_tokens": st.prefix_cache.hit_tokens,
        "cow_forks": st.scheduler.cow_forks,
        "preemptions": st.scheduler.preemptions,
        "graphs": {"captured": cs.compiled_steps, "replays": cs.replays,
                   "capture_ms": cs.capture_ms,
                   "pool_bytes": cs.graph_pool_bytes,
                   "signatures": [list(sg) for sg in cs.step_signatures]},
        "serve_launches": serve_launches,
        "chunked_wkv_ticks": sum(1 for n in tick_chunk if n),
        "forward_launches": forward_launches, "forwards": n_forwards,
        "logit_checks": checks, "logit_tol": tol,
        "logit_error_by_depth": by_depth,
        "resident_weights_gb": resident_gb,
        "peak_mem_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
        "kv_bytes": kv_bytes,
    }
    emit(result)
    if worst > tol:
        raise AssertionError(f"teacher-forced logits differ by {worst} > "
                             f"{tol}: {checks}")
    if dense:
        result["dense_launches"] = dense_serve(
            dev, cfg, params, adapters, reqs, plain_params, ref_ec, n_quant,
            result, max_len=max_len, max_batch=max_slots, seed=seed,
            checked=checked)["launches"]
    geometry = dict(max_len=max_len, max_slots=max_slots,
                    page_size=page_size, prefill_chunk=prefill_chunk,
                    seed=seed)
    base_tokens = {u: r.generated for u, r in done.items()}
    for drafter, k, spec_new in specs:
        key = "spec" if drafter == "ngram" else drafter
        result[f"{key}_launches"] = spec_serve(
            dev, cfg, params, adapters, reqs, plain_params, ref_ec,
            base_tokens, result, drafter=drafter, k=k, max_new=spec_new,
            base="M8F8" if drafter == "ngram" else "f32", **geometry)[
                "launches"]
    if persist:
        result["persist_launches"] = persist_serve(
            dev, cfg, params, adapters, reqs[1], plain_params, ref_ec,
            n_quant, eng, **geometry)["launches"]
    del plain_params
    gc.collect()
    return result, eng


# ---------------------------------------------------------------------------
# the MoE models: llama4-scout served at full width, mixtral and musicgen
# forwards at full width, each held against its plain version
# ---------------------------------------------------------------------------

# a routing flip between a kernel path and the plain reference is a fault
# unless the reference's top-k margin there (the k-th router probability
# minus the (k+1)-th) is below this
FLIP_MARGIN = 1e-4


def quantized_kinds(tree):
    """(layer matrices on the crossbar path, expert stacks on the grouped
    one): quantized leaves stacked (n_sp, K, N) and (n_sp, slots, K, N)."""
    from repro_torch.core import quant
    if quant.is_quantized(tree):
        n = tree.codes.shape[0]
        return (0, n) if tree.ndim == 4 else (n, 0)
    kids = (tree.values() if isinstance(tree, dict)
            else tree if isinstance(tree, (tuple, list)) else ())
    out = (0, 0)
    for v in kids:
        a, b = quantized_kinds(v)
        out = (out[0] + a, out[1] + b)
    return out


class EngineRoutes:
    """The routing of every token a paged engine runs, by request and
    position: ``moe.ROUTES`` records each MoE layer's experts, and a
    wrapper of the engine's ``_replay`` maps a tick's rows to requests. A
    replayed graph rewrites the tensors its capture recorded, so each
    tick's experts are stacked into a tensor of their own right after the
    tick (on the device, no sync: ``table`` reads them after the run)."""

    def __init__(self, eng, cfg):
        from repro_torch.models import moe
        self.eng, self.moe = eng, moe
        self.layers = sum(cfg.is_moe_layer(i) for i in range(cfg.n_layers))
        self.graph_routes = {}
        self.ticks = []
        self._orig = eng._replay
        moe.ROUTES = []
        eng._replay = self._replay

    def _replay(self, sig, staged):
        from repro_torch.serve.engine import _segments
        eng, moe = self.eng, self.moe
        seg, _ = _segments(eng.layout.max_slots, *sig)
        host = staged.numpy()
        lens, clens = (host[o:o + n].copy() for o, n in
                       (seg["lens"], seg["clens"]))
        uids = {i: eng.sched.slots[i].req.uid for i in eng.sched.active()}
        had = sig in eng._graphs
        n0 = len(moe.ROUTES)
        out = self._orig(sig, staged)
        new = moe.ROUTES[n0:]
        del moe.ROUTES[n0:]
        if had:
            routes = self.graph_routes[sig]
        else:
            routes = new[:self.layers]
            if len(new) == 2 * self.layers:       # the capture's tensors
                self.graph_routes[sig] = new[self.layers:]
        # (L, B, C, k): a copy on the device, read by ``table``
        self.ticks.append((uids, lens, clens,
                           torch.stack([r["experts"] for r in routes])))
        return out

    def close(self):
        self.eng._replay = self._orig
        self.moe.ROUTES = None

    def table(self, reqs):
        """{uid: (positions, L, k) experts} over each request's stream (a
        position the prefix cache served comes from the request that
        computed it: same adapter, same tokens up to it)."""
        torch.cuda.synchronize()
        seen = {}
        for uids, lens, clens, ex in self.ticks:
            ex = ex.cpu().numpy()
            for i, uid in uids.items():
                for t in range(int(clens[i])):
                    seen.setdefault(uid, {})[int(lens[i]) + t] = ex[:, i, t]
        out = {}
        for uid, r in reqs.items():
            stream = np.concatenate([r.prompt, np.asarray(r.generated[:-1],
                                                          np.int32)])
            rows = []
            for pos in range(len(stream)):
                got = seen.get(uid, {}).get(pos)
                if got is None:
                    for u, o in reqs.items():
                        if (o.adapter_id == r.adapter_id
                                and len(o.prompt) > pos
                                and np.array_equal(o.prompt[:pos + 1],
                                                   stream[:pos + 1])
                                and pos in seen.get(u, {})):
                            got = seen[u][pos]
                            break
                if got is None:
                    raise AssertionError(f"no routing of request {uid} at "
                                         f"position {pos}")
                rows.append(got)
            out[uid] = np.stack(rows)
        return out


def forward_routes(entries, layers, key="experts"):
    """(positions, L, ...) of ``key`` ("experts" or "margin") over one
    sequence's prefill then decode steps, from ``moe.ROUTES`` entries (L,
    the MoE layers, per forward, batch of 1)."""
    steps = [entries[i:i + layers] for i in range(0, len(entries), layers)]
    return np.stack([np.concatenate([s[l][key][0].cpu().numpy()
                                     for s in steps])
                     for l in range(layers)], axis=1)


def streamed_moe(cfg, p, x, **_):
    """``moe.apply_moe`` under dropless routing as the plain reference
    computes it, one expert at a time: the routing as ``apply_moe``'s (f32
    router, top-k, renormalised gates; recorded in ``moe.ROUTES``), then
    each expert's FF over the tokens routed to it, with that expert's
    matrices dequantized alone (2.4 GB in f32 at jamba's width, where a
    layer's three stacks would take 38.6 GB), weighted by its gate. The
    shared expert, if any, is a plain MLP of dequantized weights."""
    from repro_torch.core import quant
    from repro_torch.models import layers, moe

    B, T, d = x.shape
    E, k = cfg.moe.n_experts, cfg.moe.top_k
    if moe.live_slots(p["w1"]) != E:
        raise ValueError("the streamed reference takes one slot per expert")
    probs = torch.softmax(torch.matmul(x.to(torch.float32), p["router"]), -1)
    gate, eidx = torch.topk(probs, k, dim=-1)
    if moe.ROUTES is not None:
        top = torch.topk(probs, min(k + 1, E), dim=-1).values
        margin = (top[..., k - 1] - top[..., k] if E > k
                  else torch.full_like(top[..., 0], float("inf")))
        moe.ROUTES.append({"experts": eidx, "margin": margin})
    if cfg.moe.router_norm_topk:
        gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)
    flat = x.reshape(B * T, d)
    ef, gf = eidx.reshape(B * T, k), gate.reshape(B * T, k)
    y = torch.zeros_like(flat)

    def mat(name, e):
        w = p[name]
        return quant.dequantize(w.layer(e)) if quant.is_quantized(w) else w[e]

    for e in range(E):
        wt = torch.where(ef == e, gf, torch.zeros_like(gf)).sum(-1)
        rows = torch.nonzero(wt, as_tuple=True)[0]
        if not rows.numel():
            continue
        xe = flat[rows]
        h = xe @ mat("w1", e)
        if cfg.mlp.startswith("gated"):
            h = layers.activation(cfg, h) * (xe @ mat("w3", e))
        else:
            h = layers.activation(cfg, h)
        y[rows] += (h @ mat("w2", e)) * wt[rows, None].to(x.dtype)
    y = y.reshape(B, T, d)
    if cfg.moe.shared_expert:
        y = y + layers.apply_mlp(cfg, p["shared"], x)
    zero = torch.zeros((), device=x.device)
    return y.to(x.dtype), {"lb_loss": zero, "router_z": zero,
                           "dropped_tokens": zero}


def dequantize_but_experts(tree):
    """One layer's tree with every quantized matrix dequantized to f32 but
    the expert stacks (quantized and 3-D), which ``streamed_moe``
    dequantizes one expert at a time."""
    from repro_torch.core import quant
    if quant.is_quantized(tree):
        return tree if tree.ndim == 3 else quant.dequantize(tree)
    if isinstance(tree, dict):
        return {k: dequantize_but_experts(v) for k, v in tree.items()}
    return tree


def streamed_reference(cfg, params, adapters, reqs, dev):
    """The plain reference of each request's teacher-forced logits (at the
    last prompt token and every generated one but the last) without ever
    holding more than one layer's dense weights but its experts, and one
    expert's: every request's whole stream goes through the model one
    layer at a time (train mode: causal ``ref_attention`` over the stream,
    the Mamba layers' plain conv and ``selective_scan_plain`` from a zero
    state), with that layer's f32 weights dequantized but its expert
    stacks (``streamed_moe`` takes them one expert at a time), and the MoE
    layers' routing recorded. Returns per request (logits, experts
    (positions, L, k), margins (positions, L))."""
    from repro_torch.core import lora as lora_lib
    from repro_torch.core.lora import layer_slice, scan_period
    from repro_torch.models import layers, moe
    from repro_torch.models import transformer as tfm

    ec = tfm.ExecConfig(attn_impl="ref", ssm_impl="ref",
                        moe_dispatch="dropless")
    ads = lora_lib.stack_adapters(adapters)
    seqs = [np.concatenate([r.prompt, np.asarray(r.generated[:-1], np.int32)])
            for r in reqs]
    xs = [layers.embed_tokens(cfg, params["embed"],
                              torch.as_tensor(s, device=dev)[None],
                              torch.float32) for s in seqs]
    routes = [[] for _ in reqs]
    margins = [[] for _ in reqs]
    P = scan_period(cfg)
    apply_moe = moe.apply_moe
    moe.apply_moe = streamed_moe
    try:
        for sp in range(cfg.n_layers // P):
            for pos in range(P):
                lp = dequantize_but_experts(
                    layer_slice(params["layers"][pos], sp))
                la = layer_slice(ads["layers"][pos], sp)
                for j, r in enumerate(reqs):
                    T = xs[j].shape[1]
                    moe.ROUTES = []
                    xs[j], _, _ = tfm._apply_position(
                        cfg, ec, pos, xs[j], lp, la, None,
                        torch.arange(T, device=dev, dtype=torch.int32)[None],
                        "train", None,
                        torch.tensor([r.adapter_id], device=dev), None, None,
                        None)
                    for e in moe.ROUTES:
                        routes[j].append(e["experts"][0].cpu())
                        margins[j].append(e["margin"][0].cpu())
                del lp
    finally:
        moe.apply_moe = apply_moe
        moe.ROUTES = None
    out = []
    for j, r in enumerate(reqs):
        x = layers.apply_norm(cfg, params["final_norm"],
                              xs[j][:, len(r.prompt) - 1:])
        lg = layers.unembed(cfg, params["embed"], x)[0]
        out.append((lg, torch.stack(routes[j], 1).numpy(),
                    torch.stack(margins[j], 1).numpy()))
    return out


def routing_check(path_experts, ref_experts, ref_margin, first_row,
                  path_logits, ref_logits):
    """A path's routing and logits against the reference's. Every position
    and layer whose top-k expert set differs is a flip, listed with the
    reference's margin there; the logits are held only at rows whose
    position comes before the first flip (a flip moves the flipped token's
    output by O(1), and attention carries it to every later position).
    ``first_row``: the position of logits row 0."""
    a = np.sort(path_experts, -1)
    b = np.sort(ref_experts, -1)
    flips = [{"position": int(p), "layer": int(l),
              "experts": a[p, l].tolist(), "reference": b[p, l].tolist(),
              "margin": float(ref_margin[p, l])}
             for p, l in zip(*np.nonzero((a != b).any(-1)))]
    first = min((f["position"] for f in flips), default=None)
    rows = [j for j in range(ref_logits.shape[0])
            if first is None or first_row + j < first]
    err = (float((path_logits[rows] - ref_logits[rows]).abs().max())
           if rows else None)
    return {"flips": flips, "checked_rows": len(rows),
            "rows": int(ref_logits.shape[0]), "max_abs_err": err,
            "min_margin": float(ref_margin.min()),
            "flip_over_margin": [f for f in flips
                                 if f["margin"] >= FLIP_MARGIN]}


def layer_counts(cfg):
    """(attention layers, Mamba layers) of a model."""
    kinds = cfg.layer_kinds()
    return kinds.count("attn"), kinds.count("mamba")


def moe_layers(cfg) -> int:
    """MoE FF layers of a model: one ``moe_route`` and one ``moe_combine``
    launch each a tick or a forward under dropless dispatch."""
    return sum(map(cfg.is_moe_layer, range(cfg.n_layers)))


@contextlib.contextmanager
def plain_moe_routing():
    """``moe_route`` and ``moe_combine`` as their plain versions (torch
    ops) on CUDA tensors too, for the body: a reference path's routing
    and combine then run none of the kernels under test."""
    from repro_torch.kernels.moe_route import ops as moe_ops
    saved = moe_ops.moe_route, moe_ops.moe_combine
    moe_ops.moe_route = moe_ops.moe_route_plain
    moe_ops.moe_combine = moe_ops.moe_combine_plain
    try:
        yield
    finally:
        moe_ops.moe_route, moe_ops.moe_combine = saved


def mixed_window(eng, cfg, n_requests, seed):
    """A traced window of replayed mixed ticks on ``eng`` after its serve:
    two waves of ``n_requests`` prompts of two chunks each (two new tokens
    each, so the wave's first two ticks are mixed: every slot prefills a
    chunk). The first wave, by ``eng.step``, captures or replays the
    signatures that such a wave meets; the second wave's two mixed ticks
    are traced (``traced_ticks``) and must both replay and prefill a chunk
    in every slot. A trace that lost a port kernel's record is taken again
    on another such wave, up to ``TRACE_ATTEMPTS`` waves. Returns the
    traced window."""
    from repro_torch.serve.api import Request

    rng = np.random.default_rng(seed + 1)
    plen, trace = 2 * eng.prefill_chunk, None
    for wave in range(1 + TRACE_ATTEMPTS):
        if wave and not retrace(trace):
            break
        for i in range(n_requests):
            eng.submit(Request(
                uid=20_000 + 100 * wave + i, prompt=rng.integers(
                    0, cfg.vocab_size, plen).astype(np.int32),
                max_new_tokens=2, adapter_id=i % 2))
        if wave:
            trace = traced_ticks(eng, 2, eng.step, trace, TRACE_ATTEMPTS)
        while eng.queue or eng.sched.active():
            eng.step()
    torch.cuda.synchronize()
    if (not trace["replayed"] or trace["prefill_tokens_per_tick"]
            != n_requests * eng.prefill_chunk):
        raise AssertionError(f"the traced mixed ticks did not replay a "
                             f"chunk in every slot: {trace}")
    return trace


def moe_serve_phase(dev, cfg, *, layers=24, n_requests=8, max_new=32,
                    prompt_range=(64, 512), shared_prefix=256, max_len=1024,
                    max_slots=8, page_size=16, prefill_chunk=128, seed=0,
                    trace_decode=(8, 8), trace_mixed=False, spec=None,
                    lora_targets=None):
    """An MoE model at full width, depth cut to ``layers``, served as
    ``serve_phase`` serves (two rank-32 adapters with B != 0 on every
    LoRA target of the config, 8 greedy requests of 64-512 tokens, two
    sharing a prefix, 32 new tokens each, the graph-captured mixed step),
    on an M8F8 base drawn and quantized one leaf at a time
    (``init_quantized_params``: its f32 base would not fit). Each tick's
    launches exact: one crossbar launch per layer matrix (attention, the
    Mamba projections and the shared expert), one grouped launch per
    expert stack, one paged flash launch per attention layer, one
    ``selective_scan`` launch per Mamba layer; every tick a capture or a
    replay; a traced window of graph decode ticks; with ``trace_mixed``,
    after the serve, a traced window of replayed mixed ticks
    (``mixed_window``). Then the engine is freed, two requests are
    teacher-forced through ``forward`` with the kernels (over a dense
    cache) and through ``streamed_reference``; both
    paths' routing is held to the reference's (``routing_check``) and
    their logits to ``LOGIT_TOL`` before the first flip. With ``spec``
    (drafter, k, new tokens), ``moe_spec_pass`` then speculates on the same
    engine geometry. ``lora_targets`` replaces the config's LoRA targets.
    Returns (the serve line, None)."""
    from repro_torch import kernels
    from repro_torch.configs.base import QuantConfig
    from repro_torch.core import lora as lora_lib
    from repro_torch.models import kvcache, moe
    from repro_torch.models import transformer as tfm
    from repro_torch.serve.api import Request, make_engine

    full_layers = cfg.n_layers
    cfg = dataclasses.replace(cfg, n_layers=layers)
    if lora_targets is not None:
        cfg = dataclasses.replace(cfg, lora=dataclasses.replace(
            cfg.lora, targets=tuple(lora_targets)))
    g = torch.Generator(device=dev).manual_seed(seed)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    params = tfm.init_quantized_params(cfg, g, QuantConfig(mha_bits=8,
                                                           ff_bits=8),
                                       device=dev)
    adapters = []
    for _ in range(2):
        ad = lora_lib.init_lora_params(cfg, g, device=dev)
        for entry in ad["layers"]:
            for ab in entry.values():    # a "trained" adapter: B != 0
                ab["b"].normal_(0.0, 0.02, generator=g)
        adapters.append(ad)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    n_quant, n_grouped = quantized_kinds(params["layers"])
    resident_gb = torch.cuda.memory_allocated(dev) / 1e9

    rng = np.random.default_rng(seed)
    prefix = rng.integers(0, cfg.vocab_size, shared_prefix).astype(np.int32)
    reqs = []
    for i in range(n_requests):
        plen = int(rng.integers(prompt_range[0], prompt_range[1] + 1))
        prompt = rng.integers(0, cfg.vocab_size, plen).astype(np.int32)
        if i in (1, 2):                  # two requests share a prefix
            plen = max(plen, shared_prefix + 16)
            prompt = np.concatenate([prefix, rng.integers(
                0, cfg.vocab_size, plen - shared_prefix).astype(np.int32)])
        reqs.append(Request(uid=i, prompt=prompt, max_new_tokens=max_new,
                            adapter_id=1 if i in (1, 2) else i % 2))

    eng = make_engine(cfg, params, adapters, mode="paged", device=dev,
                      max_slots=max_slots, max_len=max_len,
                      page_size=page_size, prefill_chunk=prefill_chunk,
                      record_logits=True, seed=seed)
    route_log = EngineRoutes(eng, cfg)
    kernels.reset_launches()
    for r in reqs:
        eng.submit(r)
    tick_s, tick_kind, tick_decoded = [], [], []
    trace, n_traced = None, 0
    n_attn, n_mamba = layer_counts(cfg)
    t_serve = time.perf_counter()
    try:
        while eng.queue or eng.sched.active():
            if (retrace(trace) and tick_kind[-trace_decode[0]:]
                    == ["decode"] * trace_decode[0]):
                trace = traced_ticks(eng, trace_decode[1], eng.step, trace,
                                     TRACE_ATTEMPTS)
                n_traced = trace["ticks_run"]
                continue
            pf, dc = eng.prefill_tokens, eng.decode_tokens
            t = time.perf_counter()
            eng.step()
            torch.cuda.synchronize()
            tick_s.append(time.perf_counter() - t)
            tick_kind.append("prefill" if eng.prefill_tokens > pf
                             else "decode")
            tick_decoded.append(eng.decode_tokens - dc)
        serve_s = time.perf_counter() - t_serve
        serve_launches = dict(kernels.LAUNCHES)
        done = eng.finished
        engine_experts = route_log.table(done)
    finally:
        route_log.close()
    del route_log
    n_ticks = len(tick_s) + n_traced
    if sorted(done) != list(range(n_requests)):
        raise AssertionError(f"unfinished requests: {sorted(done)}")
    short = {u: len(r.generated) for u, r in done.items()
             if len(r.generated) != max_new}
    if short:
        raise AssertionError(f"requests stopped early: {short}")
    st = eng.stats()
    cs = st.compile
    n_moe = moe_layers(cfg)
    per_tick = {"crossbar_matmul": n_quant,
                "grouped_crossbar_matmul": n_grouped,
                "paged_flash_attention": n_attn,
                "selective_scan": n_mamba, "moe_route": n_moe,
                "moe_combine": n_moe}
    per_tick = {k: n for k, n in per_tick.items() if n}
    got = {k: n for k, n in serve_launches.items() if n}
    if got != {k: n * n_ticks for k, n in per_tick.items()}:
        raise AssertionError(f"the engine launched {got}, expected "
                             f"{per_tick} a tick over {n_ticks} ticks")
    if (cs.compiled_steps != len(cs.step_signatures)
            or cs.compiled_steps + cs.replays != n_ticks):
        raise AssertionError(f"{n_ticks} ticks, {cs.compiled_steps} "
                             f"graphs of {len(cs.step_signatures)} "
                             f"signatures, {cs.replays} replays")
    if retrace(trace) or not trace["replayed"]:
        raise AssertionError(f"no traced window of replayed decode ticks: "
                             f"{trace}")
    if (st.prefix_cache.enabled != full_attention_only(cfg)
            or st.moe.dropped_tokens):
        raise AssertionError(f"prefix cache {st.prefix_cache.enabled}, "
                             f"{st.moe.dropped_tokens} dropped tokens")
    mixed_trace = (mixed_window(eng, cfg, max_slots, seed) if trace_mixed
                   else None)
    checked = [1, 0]
    sampled = {uid: torch.stack(eng.sampled_logits[uid]) for uid in checked}
    kv_bytes = kvcache.cache_bytes(eng.cache)
    graph_pool_bytes = cs.graph_pool_bytes
    del eng
    gc.collect()
    torch.cuda.empty_cache()

    # the kernel path of forward over a dense cache, its routing recorded
    kernels.reset_launches()
    kernel_logits, kernel_experts = {}, {}
    try:
        for uid in checked:
            r = done[uid]
            moe.ROUTES = []
            kernel_logits[uid] = teacher_forced(
                cfg, params, adapters, r.prompt, r.generated, r.adapter_id,
                tfm.ExecConfig(moe_dispatch="dropless"), dev)
            kernel_experts[uid] = forward_routes(
                moe.ROUTES, sum(map(cfg.is_moe_layer, range(layers))))
    finally:
        moe.ROUTES = None
    torch.cuda.synchronize()
    forward_launches = {k: n for k, n in kernels.LAUNCHES.items() if n}
    n_forwards = sum(len(done[uid].generated) for uid in checked)
    want = {"crossbar_matmul": n_quant, "grouped_crossbar_matmul": n_grouped,
            "flash_attention": n_attn, "selective_scan": n_mamba,
            "moe_route": n_moe, "moe_combine": n_moe}
    want = {k: n for k, n in want.items() if n}
    if forward_launches != {k: n * n_forwards for k, n in want.items()}:
        raise AssertionError(f"the forward launched {forward_launches}, "
                             f"expected {want} a forward over {n_forwards}")

    t_ref = time.perf_counter()
    refs = streamed_reference(cfg, params, adapters,
                              [done[u] for u in checked], dev)
    ref_s = time.perf_counter() - t_ref
    checks, problems = {}, []
    for uid, (ref, ref_ex, ref_margin) in zip(checked, refs):
        first_row = len(done[uid].prompt) - 1
        if not torch.isfinite(sampled[uid]).all():
            problems.append(f"non-finite engine logits, request {uid}")
        c = {"positions": int(ref.shape[0]),
             "max_abs_logit": float(ref.abs().max())}
        for path, lg, ex in (("engine", sampled[uid], engine_experts[uid]),
                             ("kernel_forward", kernel_logits[uid],
                              kernel_experts[uid])):
            if ex.shape != ref_ex.shape or lg.shape != ref.shape:
                problems.append(f"{path} shapes {ex.shape} {lg.shape}, "
                                f"reference {ref_ex.shape} {ref.shape}")
                continue
            c[path] = routing_check(ex, ref_ex, ref_margin, first_row, lg,
                                    ref)
            c[path]["argmax_agree"] = float(
                (lg.argmax(-1) == ref.argmax(-1)).float().mean())
            if c[path]["flip_over_margin"]:
                problems.append(f"request {uid}, {path}: routing flips at "
                                f"margins >= {FLIP_MARGIN}")
            if (c[path]["max_abs_err"] is not None
                    and c[path]["max_abs_err"] > LOGIT_TOL):
                problems.append(f"request {uid}, {path}: logits differ by "
                                f"{c[path]['max_abs_err']} > {LOGIT_TOL}")
        checks[uid] = c
    n_checked = sum(c[p]["checked_rows"] for c in checks.values()
                    for p in ("engine", "kernel_forward") if p in c)
    if not n_checked:
        problems.append("no logits row before a routing flip")

    pf_s = sum(s for s, k in zip(tick_s, tick_kind) if k == "prefill")
    dc_s = sum(s for s, k in zip(tick_s, tick_kind) if k == "decode")
    dc_tokens = sum(n for n, k in zip(tick_decoded, tick_kind)
                    if k == "decode")
    n_dc_ticks = tick_kind.count("decode")
    result = {
        "phase": "serve", "model": cfg.name, "layers": layers,
        "depth_cut": f"{layers} of {full_layers} layers",
        "d_model": cfg.d_model, "vocab": cfg.vocab_size,
        "attention_layers": n_attn, "mamba_layers": n_mamba,
        "experts": cfg.moe.n_experts, "top_k": cfg.moe.top_k,
        "base": "M8F8 (drawn and quantized one leaf at a time)",
        "lora_targets": list(cfg.lora.targets),
        "max_len": max_len, "prompt_lens": [len(r.prompt) for r in reqs],
        "checked": checked, "quantized_matrices": n_quant,
        "grouped_stacks": n_grouped, "adapters": 2,
        "lora_rank": cfg.lora.rank, "requests": n_requests,
        "prompt_tokens": int(sum(len(r.prompt) for r in reqs)),
        "setup_s": setup_s, "serve_s": serve_s, "reference_s": ref_s,
        "ticks": n_ticks, "traced_ticks": n_traced,
        "traced_decode_ticks": trace,
        **({"traced_mixed_ticks": mixed_trace} if trace_mixed else {}),
        "prefill_ticks": len(tick_s) - n_dc_ticks,
        "decode_ticks": n_dc_ticks,
        "ms_per_tick": 1e3 * serve_s / max(len(tick_s), 1),
        "ms_per_prefill_tick": 1e3 * pf_s / max(len(tick_s) - n_dc_ticks, 1),
        "ms_per_decode_tick": 1e3 * dc_s / max(n_dc_ticks, 1),
        "prefill_tick_ms": [1e3 * s for s, k in zip(tick_s, tick_kind)
                            if k == "prefill"],
        "decode_tick_ms": [1e3 * s for s, k in zip(tick_s, tick_kind)
                           if k == "decode"],
        "prefill_tokens": st.prefill_tokens,
        "decode_tokens": st.decode_tokens,
        "decode_tok_s": dc_tokens / max(dc_s, 1e-9),
        "tok_s": (st.prefill_tokens + st.decode_tokens) / serve_s,
        "prefix_cache_enabled": st.prefix_cache.enabled,
        "prefix_hit_tokens": st.prefix_cache.hit_tokens,
        "preemptions": st.scheduler.preemptions,
        "moe": {"dispatch": st.moe.dispatch,
                "dropped_tokens": st.moe.dropped_tokens},
        "graphs": {"captured": cs.compiled_steps, "replays": cs.replays,
                   "capture_ms": cs.capture_ms, "pool_bytes": graph_pool_bytes,
                   "signatures": [list(sg) for sg in cs.step_signatures]},
        "serve_launches": serve_launches,
        "forward_launches": forward_launches, "forwards": n_forwards,
        "logit_checks": checks, "logit_tol": LOGIT_TOL,
        "flip_margin": FLIP_MARGIN,
        "resident_weights_gb": resident_gb,
        "peak_mem_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
        "kv_bytes": kv_bytes,
    }
    emit(result)
    if problems:
        raise AssertionError(f"{cfg.name}: " + "; ".join(problems))
    if spec is not None:
        drafter, k, spec_new = spec
        line = moe_spec_pass(
            dev, cfg, params, adapters, reqs, result, drafter=drafter, k=k,
            max_new=spec_new, max_len=max_len, max_slots=max_slots,
            page_size=page_size, prefill_chunk=prefill_chunk, seed=seed)
        result["spec_launches"] = line["launches"]
    del params
    gc.collect()
    return result, None


def moe_spec_pass(dev, cfg, params, adapters, reqs, served, *, drafter, k,
                  max_new, max_len, max_slots, page_size, prefill_chunk,
                  seed):
    """Speculative decoding on ``moe_serve_phase``'s weights, adapters,
    requests and engine geometry, checked as ``spec_serve`` checks
    llama3.2-1b's: every tick a verify-graph capture or replay, the
    launches exact per tick, something drafted, a traced window of verify
    ticks, a recurrent rollback on a model with per-slot state; and every
    emitted token's logits row held to ``streamed_reference`` of the
    request's own stream (``LOGIT_TOL`` before a path's first routing
    flip, no flip at a margin of ``FLIP_MARGIN`` or more; the engine's
    routing recorded by ``EngineRoutes``). ``served``: the serve line
    (its tokens and decode tick times are reported beside). Emits and
    returns the ``spec`` line."""
    from repro_torch import kernels
    from repro_torch.serve.api import make_engine
    from repro_torch.serve.spec import SpecConfig

    fresh = [dataclasses.replace(r, generated=[], done=False,
                                 finish_reason="", max_new_tokens=max_new)
             for r in reqs]
    eng = make_engine(cfg, params, adapters, mode="paged", device=dev,
                      max_slots=max_slots, max_len=max_len,
                      page_size=page_size, prefill_chunk=prefill_chunk,
                      spec=SpecConfig(k=k, drafter=drafter),
                      record_logits=True, seed=seed)
    route_log = EngineRoutes(eng, cfg)
    kernels.reset_launches()
    t0 = time.perf_counter()
    try:
        done, tick_s, kind, decoded, trace = serve_loop(
            eng, fresh, trace_at=SPEC_TRACE_AT)
        serve_s = time.perf_counter() - t0
        launches = {k_: n for k_, n in kernels.LAUNCHES.items() if n}
        engine_experts = route_log.table(done)
    finally:
        route_log.close()
    st = eng.stats()
    cs, sp = st.compile, st.spec
    ticks = len(tick_s) + (trace["ticks_run"] if trace else 0)
    n_attn, n_mamba = layer_counts(cfg)
    n_quant, n_grouped = quantized_kinds(params["layers"])
    per_tick = {"crossbar_matmul": n_quant,
                "grouped_crossbar_matmul": n_grouped,
                "paged_flash_attention": n_attn, "selective_scan": n_mamba,
                "moe_route": moe_layers(cfg), "moe_combine": moe_layers(cfg)}
    want = {k_: n * ticks for k_, n in per_tick.items() if n}
    sampled = {u: torch.stack(eng.sampled_logits[u]) for u in done}
    uids = [r.uid for r in fresh]
    del eng
    gc.collect()
    torch.cuda.empty_cache()

    t_ref = time.perf_counter()
    refs = streamed_reference(cfg, params, adapters, [done[u] for u in uids],
                              dev)
    ref_s = time.perf_counter() - t_ref
    checks, problems = {}, []
    for uid, (ref, ref_ex, ref_margin) in zip(uids, refs):
        lg, ex = sampled[uid], engine_experts[uid]
        c = {"positions": int(ref.shape[0]),
             "max_abs_logit": float(ref.abs().max()),
             "finite": bool(torch.isfinite(lg).all())}
        if ex.shape != ref_ex.shape or lg.shape != ref.shape:
            problems.append(f"request {uid}: shapes {ex.shape} {lg.shape}, "
                            f"reference {ref_ex.shape} {ref.shape}")
        else:
            c.update(routing_check(ex, ref_ex, ref_margin,
                                   len(done[uid].prompt) - 1, lg, ref))
            c["argmax_agree"] = float(
                (lg.argmax(-1) == ref.argmax(-1)).float().mean())
            if c["flip_over_margin"]:
                problems.append(f"request {uid}: routing flips at margins "
                                f">= {FLIP_MARGIN}")
            if c["max_abs_err"] is not None and c["max_abs_err"] > LOGIT_TOL:
                problems.append(f"request {uid}: logits differ by "
                                f"{c['max_abs_err']} > {LOGIT_TOL}")
        if not c["finite"]:
            problems.append(f"non-finite logits, request {uid}")
        checks[uid] = c
    if not sum(c.get("checked_rows", 0) for c in checks.values()):
        problems.append("no logits row before a routing flip")
    dc_s = [s for s, kd in zip(tick_s, kind) if kd == "decode"]
    dc_tokens = sum(n for n, kd in zip(decoded, kind) if kd == "decode")
    base_tokens = {r.uid: r.generated for r in reqs}
    result = {
        "phase": "spec", "model": cfg.name, "layers": cfg.n_layers,
        "base": "M8F8", "drafter": drafter, "k": k, "requests": len(fresh),
        "max_new": max_new, "ticks": ticks, "decode_ticks": len(dc_s),
        "serve_s": serve_s, "reference_s": ref_s,
        "ms_per_decode_tick": 1e3 * sum(dc_s) / max(len(dc_s), 1),
        "median_ms_per_decode_tick": (1e3 * statistics.median(dc_s)
                                      if dc_s else None),
        "spec_off_ms_per_decode_tick": served["ms_per_decode_tick"],
        "spec_off_median_ms_per_decode_tick": (
            statistics.median(served["decode_tick_ms"])
            if served["decode_tick_ms"] else None),
        "decode_tok_s": dc_tokens / max(sum(dc_s), 1e-9),
        "spec_off_decode_tok_s": served["decode_tok_s"],
        "decode_tokens_per_decode_tick": dc_tokens / max(len(dc_s), 1),
        "traced_ticks": trace,
        "spec_steps": sp.steps, "accept_rate": sp.accept_rate,
        "drafted_tokens": sp.drafted_tokens,
        "accepted_tokens": sp.accepted_tokens,
        "rolled_back_tokens": sp.rolled_back_tokens,
        "rolled_back_pages": st.scheduler.rolled_back_pages,
        "recurrent_rollbacks": sp.recurrent_rollbacks,
        "decode_tokens": st.decode_tokens,
        "prefill_tokens": st.prefill_tokens,
        # over the tokens both runs made
        "tokens_equal_spec_off": sum(
            done[u].generated[:len(base_tokens[u])]
            == base_tokens[u][:max_new] for u in uids),
        "graphs": {"captured": cs.compiled_steps, "replays": cs.replays,
                   "capture_ms": cs.capture_ms,
                   "pool_bytes": cs.graph_pool_bytes,
                   "signatures": [list(s) for s in cs.step_signatures]},
        "launches": launches, "expected_launches": want,
        "logit_checks": checks, "logit_tol": LOGIT_TOL,
        "flip_margin": FLIP_MARGIN,
    }
    emit(result)
    if sorted(done) != sorted(uids) or any(
            len(done[u].generated) != max_new for u in uids):
        problems.append("unfinished or short requests")
    if launches != want:
        problems.append(f"launched {launches}, expected {want}")
    if (cs.compiled_steps != len(cs.step_signatures)
            or cs.compiled_steps + cs.replays != ticks):
        problems.append(f"{ticks} ticks, {cs.compiled_steps} verify graphs "
                        f"of {len(cs.step_signatures)} signatures, "
                        f"{cs.replays} replays")
    if not sp.drafted_tokens or not sp.steps:
        problems.append("nothing was drafted")
    if trace is None:
        problems.append("no traced window of verify ticks")
    if not full_attention_only(cfg) and not sp.recurrent_rollbacks:
        problems.append("no recurrent rollback was exercised")
    if problems:
        raise AssertionError(f"spec ({drafter}, {cfg.name}): "
                             + "; ".join(problems))
    return result


def forward_phase(dev, cfg, *, layers=None, embeds=False, prompt_len=512,
                  decode_steps=4, seed=0):
    """A teacher-forced forward at full width (``layers`` cuts the depth):
    a prefill of ``prompt_len`` positions, then ``decode_steps`` decode
    steps over the dense cache, from tokens or (``embeds``) from
    precomputed embeddings, through the kernels on an M8F8 base and
    through the plain versions (dequantized weights, ``ref_attention``)
    on the same weights and inputs: the launches exact per forward, the
    logits of every position held to ``LOGIT_TOL`` before the first
    routing flip (MoE)."""
    from repro_torch import kernels
    from repro_torch.configs.base import QuantConfig
    from repro_torch.core import quant
    from repro_torch.models import moe
    from repro_torch.models import transformer as tfm

    full_layers = cfg.n_layers
    if layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    g = torch.Generator(device=dev).manual_seed(seed)
    t0 = time.perf_counter()
    params = tfm.init_quantized_params(cfg, g, QuantConfig(mha_bits=8,
                                                           ff_bits=8),
                                       device=dev)
    n_quant, n_grouped = quantized_kinds(params["layers"])
    T = prompt_len + decode_steps
    if embeds:
        stream = [{"embeds": 0.02 * torch.randn(1, n, cfg.d_model,
                                                generator=g, device=dev)}
                  for n in (prompt_len,) + (1,) * decode_steps]
    else:
        toks = torch.randint(0, cfg.vocab_size, (1, T), generator=g,
                             device=dev)
        stream = [{"tokens": toks[:, :prompt_len]}] + [
            {"tokens": toks[:, prompt_len + i:prompt_len + i + 1]}
            for i in range(decode_steps)]
    setup_s = time.perf_counter() - t0
    L = cfg.n_layers
    has_moe = n_grouped > 0

    def run(p, ec):
        moe.ROUTES = [] if has_moe else None
        try:
            lg, cache, _ = tfm.forward(cfg, p, stream[0], mode="prefill",
                                       prefill_cache_len=T, exec_cfg=ec)
            rows = [lg[0]]
            for inp in stream[1:]:
                lg, cache, _ = tfm.forward(cfg, p, inp, mode="decode",
                                           cache=cache, exec_cfg=ec)
                rows.append(lg[0])
            routes = forward_routes(moe.ROUTES, L) if has_moe else None
            margins = (forward_routes(moe.ROUTES, L, "margin") if has_moe
                       else None)
        finally:
            moe.ROUTES = None
        return torch.cat(rows), routes, margins

    kernels.reset_launches()
    t = time.perf_counter()
    lk, ek, _ = run(params, tfm.ExecConfig(moe_dispatch="dropless"))
    torch.cuda.synchronize()
    kernel_s = time.perf_counter() - t
    launches = {k: n for k, n in kernels.LAUNCHES.items() if n}
    n_fwd = 1 + decode_steps
    want = {"crossbar_matmul": n_quant * n_fwd, "flash_attention": L * n_fwd}
    if has_moe:
        want["grouped_crossbar_matmul"] = n_grouped * n_fwd
        want["moe_route"] = want["moe_combine"] = moe_layers(cfg) * n_fwd
    plain = quant.dequantize_params(params)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    t = time.perf_counter()
    with plain_moe_routing():
        lp, ep, mp = run(plain, tfm.ExecConfig(attn_impl="ref",
                                               moe_dispatch="dropless"))
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t
    if has_moe:
        check = routing_check(ek, ep, mp, 0, lk, lp)
    else:
        check = {"flips": [], "checked_rows": T, "rows": T,
                 "max_abs_err": float((lk - lp).abs().max()),
                 "flip_over_margin": []}
    result = {
        "phase": "forward", "model": cfg.name, "layers": L,
        "depth_cut": (f"{L} of {full_layers} layers" if L != full_layers
                      else None),
        "d_model": cfg.d_model, "heads": [cfg.n_heads, cfg.n_kv_heads],
        "head_dim": cfg.hd, "input": "embeds" if embeds else "tokens",
        "prompt_len": prompt_len, "decode_steps": decode_steps,
        "window": cfg.attn.window, "base": "M8F8",
        "quantized_matrices": n_quant, "grouped_stacks": n_grouped,
        "launches": launches, "expected_launches": want,
        "setup_s": setup_s, "kernel_s": kernel_s, "plain_s": plain_s,
        "finite": bool(torch.isfinite(lk).all()),
        "max_abs_logit": float(lp.abs().max()), "logit_tol": LOGIT_TOL,
        "check": check,
    }
    emit(result)
    problems = []
    if launches != want:
        problems.append(f"launched {launches}, expected {want}")
    if not result["finite"]:
        problems.append("non-finite logits")
    if check["flip_over_margin"]:
        problems.append(f"routing flips at margins >= {FLIP_MARGIN}")
    if check["max_abs_err"] is None or check["max_abs_err"] > LOGIT_TOL:
        problems.append(f"logits differ by {check['max_abs_err']}")
    if problems:
        raise AssertionError(f"{cfg.name} forward: " + "; ".join(problems))
    del plain
    gc.collect()
    torch.cuda.empty_cache()
    return result


def port_kernel_counts(kern, counts):
    """Each ``LAUNCHED_AS`` entry's port kernels among the trace events
    ``kern``, and its ``kernels.LAUNCHES`` delta from ``counts``."""
    traced = {"+".join(keys): sum(
        1 for e in kern if any(f"(anonymous namespace)::{m}" in e.name
                               for m in names))
        for keys, names in LAUNCHED_AS}
    counted = {"+".join(keys): sum(counts[k] for k in keys)
               for keys, _ in LAUNCHED_AS}
    return traced, counted


def traced_ticks(eng, n, tick, earlier=None, attempts=1):
    """``n`` engine ticks, each by ``tick()``, in a ``cuda_trace``: wall,
    device time and the port kernels' device time per tick, device busy
    share (device time over the traced wall), launches and prefill tokens
    per tick, and the top kernels by device time.

    Holds the port kernels in the trace against ``kernels.LAUNCHES``. When
    every tick replayed a graph, the counts were added from what each
    capture counted, and the trace must hold exactly as many of each port
    kernel: that shows the replays ran them. Otherwise the wrappers counted
    their own launches, and the trace may hold fewer by no more than the
    launches whose kernel record it lost (``lost_launches``), never more.

    A trace can also lose a kernel record inside a replay, with no launch
    call to name it by. A window that comes out short is marked
    ``"complete": False`` and returned while this is not the
    ``attempts``-th window; the caller then traces the next ``n`` ticks,
    passing this one as ``earlier``. The short windows' counts stay in
    ``attempts``, their ticks in ``ticks_run``. A trace that holds more
    than was counted, or the last window that is short, fails."""
    from repro_torch import kernels

    torch.cuda.synchronize()
    before = dict(kernels.LAUNCHES)
    pf, replays = eng.prefill_tokens, eng.replays
    with cuda_trace() as prof:
        t = time.perf_counter()
        for _ in range(n):
            tick()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t)
    counts = {k: kernels.LAUNCHES[k] - before[k] for k in before}

    kern = device_events(prof)
    by_name = {}
    for e in kern:
        by_name[e.name[:80]] = (by_name.get(e.name[:80], 0.0)
                                + e.time_range.elapsed_us())
    device_ms = sum(by_name.values()) / 1e3
    traced, counted = port_kernel_counts(kern, counts)
    replayed = eng.replays - replays == n
    lost = lost_launches(prof)
    short = sum(counted.values()) - sum(traced.values())
    over = any(traced[k] > counted[k] for k in traced)
    complete = not over and short <= (0 if replayed else lost)
    tries = (earlier["attempts"] if earlier else []) + [
        {"traced": traced, "counted": counted, "replayed": replayed,
         "lost_launches": lost}]
    if over or (not complete and len(tries) >= attempts):
        how = "every tick replayed" if replayed else "eager ticks"
        raise AssertionError(
            f"the trace holds {traced} port kernels, kernels.LAUNCHES "
            f"counted {counted} ({how}; {lost} kernel launches lost their "
            f"record; window {len(tries)} of {attempts}: {tries})")
    top = sorted(by_name.items(), key=lambda kv: kv[1], reverse=True)[:10]
    # the port's own kernels (csrc/*.cu), whatever their share of the tick
    own = {k: us / 1e3 / n for k, us in by_name.items()
           if any(f"(anonymous namespace)::{m}" in k
                  for m in CB_KERNELS + GROUPED_KERNELS + FA_KERNELS
                  + RING_KERNELS + WKV_KERNELS + SCAN_KERNELS
                  + ROUTE_KERNELS + COMBINE_KERNELS)}
    out = {"ticks": n, "traced_wall_ms_per_tick": wall_ms / n,
           "device_ms_per_tick": device_ms / n if kern else None,
           "device_busy_share": device_ms / wall_ms if kern else None,
           "prefill_tokens_per_tick": (eng.prefill_tokens - pf) / n,
           "launches_per_tick": {k: v / n for k, v in counts.items()},
           "traced_launches_per_tick": {k: v / n for k, v in traced.items()},
           "replayed": replayed, "trace_lost_launches": lost,
           "complete": complete, "attempts": tries,
           "ticks_run": n * len(tries),
           "top_device_ms_per_tick": {k: us / 1e3 / n for k, us in top},
           "port_kernels_device_ms_per_tick": own}
    for label, names in (("crossbar", CB_KERNELS),
                         ("grouped", GROUPED_KERNELS), ("flash", FA_KERNELS),
                         ("ring_flash", RING_KERNELS), ("wkv", WKV_KERNELS),
                         ("scan", SCAN_KERNELS), ("moe_route", ROUTE_KERNELS),
                         ("moe_combine", COMBINE_KERNELS)):
        ms = sum(v for k, v in own.items()
                 if any(f"(anonymous namespace)::{m}" in k for m in names))
        out[f"{label}_device_ms_per_tick"] = ms
        out[f"{label}_share_of_device"] = (ms * n / device_ms if kern
                                           else None)
    return out


def retrace(trace) -> bool:
    """Whether a serve still owes its traced window: none taken yet, or the
    last one's trace lost a port kernel's record (``traced_ticks``)."""
    return trace is None or not trace["complete"]


def untraced_ms(n, tick):
    """Host wall milliseconds per tick of ``n`` ticks, each by ``tick()``."""
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(n):
        tick()
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t) / n


def host_breakdown(eng, run, n):
    """Host milliseconds per tick of ``n`` untraced ticks by
    ``eng._advance(run)``, split at the engine's own calls: admission
    (``_admit``), page capacity (``sched.ensure``), copy-on-write forks
    (``_run_forks``), the rest before the step (``assembly``: chunk widths,
    the mixed batch packed into pinned memory), the step call (``run``:
    the input copy and the graph launch, or the eager forward's issue),
    sampling's issue (``sample_tokens``), the ``.cpu()`` read of the tokens
    (from sampling's return to the first emitted token: mostly waiting for
    the device), and the bookkeeping after it. Each wrapper costs about a
    microsecond. Beside them, in the same ticks, ``step_stream``: the
    stream's time from the step's first operation to its last (CUDA events
    around the step call; a graph runs it with no host gaps), and its share
    of the tick's wall."""
    from repro_torch.serve import engine as engine_mod

    clock = time.perf_counter
    acc = dict.fromkeys(("admit", "ensure", "forks", "total", "before_step",
                         "step_call", "sample_issue", "cpu_read",
                         "after_read"), 0.0)
    marks = {}

    def timed(name, fn):
        def wrapped(*a, **k):
            t = clock()
            try:
                return fn(*a, **k)
            finally:
                acc[name] += clock() - t
        return wrapped

    def emit_(*a, **k):
        marks.setdefault("emit", clock())
        return emit(*a, **k)

    def run_(sig, staged):
        marks["run"] = clock()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        out = run(sig, staged)
        ev[1].record()
        events.append(ev)
        marks["run_end"] = clock()
        return out

    def sample_(*a, **k):
        out = sample(*a, **k)
        marks["sampled"] = clock()
        return out

    events = []
    emit, sample = engine_mod._emit, engine_mod.sample_tokens
    sched = eng.sched
    eng._admit = timed("admit", eng._admit)
    eng._run_forks = timed("forks", eng._run_forks)
    engine_mod._emit = emit_
    sched.ensure = timed("ensure", sched.ensure)
    engine_mod.sample_tokens = sample_
    done = 0
    try:
        torch.cuda.synchronize()
        for _ in range(n):
            marks.clear()
            t0 = clock()
            eng._advance(run_)
            t1 = clock()
            if "emit" not in marks:      # no decode row left
                break
            done += 1
            acc["total"] += t1 - t0
            acc["before_step"] += marks["run"] - t0
            acc["step_call"] += marks["run_end"] - marks["run"]
            acc["sample_issue"] += marks["sampled"] - marks["run_end"]
            acc["cpu_read"] += marks["emit"] - marks["sampled"]
            acc["after_read"] += t1 - marks["emit"]
    finally:
        for name in ("_admit", "_run_forks"):
            del eng.__dict__[name]
        del sched.__dict__["ensure"]
        engine_mod._emit = emit
        engine_mod.sample_tokens = sample
    if not done:
        raise AssertionError("no decode tick to break down")
    torch.cuda.synchronize()
    out = {k: 1e3 * v / done for k, v in acc.items()}
    out["assembly"] = (out["before_step"] - out["admit"] - out["ensure"]
                       - out["forks"])
    out["step_stream"] = sum(a.elapsed_time(b)
                             for a, b in events[:done]) / done
    out["step_stream_share"] = out["step_stream"] / out["total"]
    out["ticks"] = done
    return out


def profile_wave(eng, cfg, tick, *, n_requests, prompt_len, window, seed,
                 run):
    """One wave of ``n_requests`` prompts of ``prompt_len`` on ``eng``,
    every tick by ``tick()``. Its first tick (every slot prefills a chunk)
    runs untraced (host wall), its second traced; once every slot decodes,
    4 ticks by ``eng._advance(run)`` give the host breakdown of a decode
    tick (``host_breakdown``), then ``window`` ticks run untraced and the
    next ``window`` traced. Device busy share is a traced window's device
    time over its own wall time. Returns (mixed, decode) results."""
    from repro_torch.serve.api import Request

    rng = np.random.default_rng(seed)
    for i in range(n_requests):
        eng.submit(Request(uid=10_000 * (seed + 1) + i, prompt=rng.integers(
            0, cfg.vocab_size, prompt_len).astype(np.int32),
            max_new_tokens=2 * window + 8, adapter_id=i % 2))
    pf = eng.prefill_tokens
    mixed = {"untraced_wall_ms_first_tick": untraced_ms(1, tick),
             **traced_ticks(eng, 1, tick)}
    if mixed["prefill_tokens_per_tick"] <= 0 or eng.prefill_tokens - pf < (
            2 * n_requests * eng.prefill_chunk):
        raise AssertionError(f"the wave's first ticks did not prefill a "
                             f"chunk in every slot: {mixed}")
    while True:                          # until a tick does no prefill
        pf = eng.prefill_tokens
        tick()
        if eng.prefill_tokens == pf:
            break
    # mid-decode, before any request of the wave finishes
    breakdown = host_breakdown(eng, run, 4)
    decode = {"untraced_wall_ms_per_tick": untraced_ms(window, tick),
              **traced_ticks(eng, window, tick),
              "host_breakdown_ms_per_tick": breakdown}
    while eng.queue or eng.sched.active():
        tick()
    return mixed, decode


def profile_phase(eng, cfg, dev, *, n_requests=8, prompt_len=256,
                  window=8):
    """Where a tick's time goes, with the step eager and as CUDA graphs, in
    the same run on the same engine: three waves of the same shape (so the
    same step signatures): the first by ``eng.step`` captures every
    signature the waves meet (not measured), the second runs the engine's
    eager step, the third replays the graphs. Each measured wave: its first
    two (mixed) ticks, every slot prefilling 128 tokens, and a decode
    window (``profile_wave``). Also reports the device time by kernel name,
    and the ratio of eager to graph for each number."""
    kw = dict(n_requests=n_requests, prompt_len=prompt_len, window=window)
    profile_wave(eng, cfg, eng.step, seed=1, run=eng._replay, **kw)
    replays = eng.replays
    eager = profile_wave(eng, cfg, lambda: eng._advance(eng._eager), seed=2,
                         run=eng._eager, **kw)
    if eng.replays != replays:
        raise AssertionError("the eager wave replayed a graph")
    captured = len(eng._graphs)
    graph = profile_wave(eng, cfg, eng.step, seed=3, run=eng._replay, **kw)
    if len(eng._graphs) != captured:
        raise AssertionError("the measured graph wave captured a graph")
    out = {}
    for name, runs in (("mixed", (eager[0], graph[0])),
                       ("decode", (eager[1], graph[1]))):
        for step, r in zip(("eager", "graph"), runs):
            emit({"phase": "profile", "model": cfg.name, "window": name,
                  "step": step, "slots": n_requests, **r})
        keys = ("untraced_wall_ms_first_tick", "untraced_wall_ms_per_tick",
                "traced_wall_ms_per_tick", "device_ms_per_tick",
                "device_busy_share")
        keys += ("host_breakdown_ms_per_tick",)
        out[name] = {step: {k: r[k] for k in keys if k in r}
                     for step, r in zip(("eager", "graph"), runs)}
    emit({"phase": "profile_compare", "model": cfg.name,
          "replays": eng.replays - replays, **out})


# ---------------------------------------------------------------------------
# phase 6: LoRA fine-tuning at full width through the port's train step
# ---------------------------------------------------------------------------

# every port kernel a train step launches, as a trace names them
TRAIN_KERNELS = (CB_KERNELS + CB_T_KERNELS + FA_KERNELS + FA_BWD_KERNELS
                 + WKV_KERNELS + WKV_BWD_KERNELS)
# the kernel groups of a train step's trace, and those each model's step
# must show (rwkv launches no flash, the attention models no wkv)
TRAIN_GROUPS = (("crossbar", CB_KERNELS), ("crossbar_t", CB_T_KERNELS),
                ("flash", FA_KERNELS), ("flash_bwd", FA_BWD_KERNELS),
                ("wkv", WKV_KERNELS), ("wkv_bwd", WKV_BWD_KERNELS))
ATTN_GROUPS = ("crossbar", "crossbar_t", "flash", "flash_bwd")
RWKV_GROUPS = ("crossbar", "crossbar_t", "wkv", "wkv_bwd")


def is_rwkv(cfg) -> bool:
    return cfg.block_pattern == ("rwkv",)


def train_launches(cfg, n_quant, microbatches, seq=TRAIN_SEQ, remat=False):
    """kernel -> launches per train step: each quantized matrix's forward
    once per microbatch, and its dx wherever the matmul's input needs a
    gradient: every one but those of layer 0 that read the frozen
    embedding only (the attention models' q/k/v projections; rwkv's r, k,
    v and g, whose token-shift mix is of the embedding too); one flash (or
    wkv: the chunked kernel from ``CHUNK_MIN_T`` on at N = 64) forward and
    one backward per layer and microbatch. With ``remat`` every forward
    kernel launches twice: the backward reruns each layer."""
    from repro_torch.kernels.rwkv6_wkv import ops as wkv_ops

    L, f = cfg.n_layers, 2 if remat else 1
    if is_rwkv(cfg):
        chunked = (seq >= wkv_ops.CHUNK_MIN_T
                   and cfg.rwkv.head_dim == wkv_ops.CHUNK_N)
        return {"crossbar_matmul": n_quant * microbatches * f,
                "crossbar_matmul_t": (n_quant - 4) * microbatches,
                "rwkv6_wkv_chunk" if chunked else "rwkv6_wkv":
                    L * microbatches * f,
                "rwkv6_wkv_bwd": L * microbatches}
    return {"crossbar_matmul": n_quant * microbatches * f,
            "crossbar_matmul_t": (n_quant - 3) * microbatches,
            "flash_attention": L * microbatches * f,
            "flash_attention_bwd": L * microbatches}


# the port's launch entry points (module, attribute), each wrapped in a
# profiler range of its name while a train step is traced, so that a
# launch whose kernel record the trace lost is named by its range
PORT_LAUNCHERS = (
    ("repro_torch.kernels.crossbar_matmul.ops", "_launch"),
    ("repro_torch.kernels.crossbar_matmul.ops", "grouped_crossbar_matmul"),
    ("repro_torch.kernels.crossbar_matmul.ops", "crossbar_matmul_t"),
    ("repro_torch.kernels.flash_attention.ops", "_launch"),
    ("repro_torch.kernels.flash_attention.ops", "flash_attention_bwd"),
    ("repro_torch.kernels.rwkv6_wkv.ops", "_launch"),
    ("repro_torch.kernels.rwkv6_wkv.ops", "rwkv6_wkv_bwd"),
    ("repro_torch.kernels.moe_route.ops", "moe_route"),
    ("repro_torch.kernels.moe_route.ops", "moe_combine"))


@contextlib.contextmanager
def named_launchers():
    """The port's launch entry points inside ``record_function`` ranges
    (``port::<module>.<name>``) for the body; restored after it."""
    import importlib

    from torch.profiler import record_function

    saved = []
    for mod_name, attr in PORT_LAUNCHERS:
        mod = importlib.import_module(mod_name)
        fn = getattr(mod, attr)
        label = f"port::{mod_name.split('.')[-2]}.{attr}"

        def ranged(*a, _fn=fn, _label=label, **kw):
            with record_function(_label):
                return _fn(*a, **kw)

        saved.append((mod, attr, fn))
        setattr(mod, attr, ranged)
    try:
        yield
    finally:
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)


def lost_by_range(prof) -> dict:
    """The launches in a ``cuda_trace`` whose kernel record the trace
    lacks (the launch call's own record is there, with the correlation id
    its kernel's record would carry; the margins' launches left out),
    counted by the innermost CPU range that encloses each launch call on
    its thread: with ``cpu=True`` an aten op, a port launch range of
    ``named_launchers`` or an autograd node; else none."""
    from torch.autograd import DeviceType

    events = prof.events()
    ids = {e.id for e in events if e.device_type == DeviceType.CUDA}
    cpu = [e for e in events if e.device_type == DeviceType.CPU]
    calls = sorted((e for e in cpu if e.name in LAUNCH_API),
                   key=lambda e: e.time_range.start)[1:-1]
    ranges = [e for e in cpu if e.name not in LAUNCH_API
              and not e.name.startswith("cuda")]
    out = {}
    for c in calls:
        if c.id in ids:
            continue
        t = c.time_range.start
        inner = [e for e in ranges if e.thread == c.thread
                 and e.time_range.start <= t <= e.time_range.end]
        name = (max(inner, key=lambda e: e.time_range.start).name
                if inner else "(no enclosing range)")
        out[name] = out.get(name, 0) + 1
    return out


def traced_step(run, groups=ATTN_GROUPS, attempts: int = 3, keep=()):
    """One train step ``run()`` in a ``cuda_trace`` with CPU activity and
    the port's launch ranges (``named_launchers``): its wall, device time
    and busy share (device time over the traced wall, which the CPU
    activity lengthens), the port kernels' device ms by name and by group,
    and the top kernels. A trace can lose kernel records: once every
    backward kernel of a llama step (with the forward's kept; the cause is
    not known), and a few launches in most traced steps. Each trace's
    lost launches are counted and named by the CPU range around each
    (``lost_by_range``) and stand beside the numbers (``lossless`` says
    whether there are none). A trace in which a group of ``groups`` has no
    device time is taken again with another step, up to ``attempts``
    times (no more: every traced event adds to what later traces lose,
    ``late_kernel_phase``), and so is one that lost a launch of a port
    launcher named in ``keep``; if the last is still incomplete, the phase
    fails. ``attempts`` lists every trace's."""
    tries = []
    for _ in range(attempts):
        with named_launchers(), cuda_trace(cpu=True) as prof:
            t = time.perf_counter()
            run()
            torch.cuda.synchronize()
            wall_ms = 1e3 * (time.perf_counter() - t)
        by_name = {}
        for e in device_events(prof):
            by_name[e.name[:80]] = (by_name.get(e.name[:80], 0.0)
                                    + e.time_range.elapsed_us() / 1e3)
        device = sum(by_name.values())
        own = {k: ms for k, ms in by_name.items()
               if any(f"(anonymous namespace)::{m}" in k
                      for m in TRAIN_KERNELS)}
        out = {"traced_wall_ms": wall_ms, "device_ms": device,
               "device_busy_share": device / wall_ms,
               "port_kernels_device_ms": own,
               "top_device_ms": dict(sorted(by_name.items(),
                                            key=lambda kv: kv[1],
                                            reverse=True)[:12])}
        for label, names in TRAIN_GROUPS:
            ms = sum(v for k, v in own.items() if any(m in k for m in names))
            out[f"{label}_device_ms"] = ms
            out[f"{label}_share_of_device"] = ms / device if device else None
        lost = lost_by_range(prof)
        out.update(lost_launches=sum(lost.values()), lost_by_range=lost)
        tries.append({"complete": all(out[f"{label}_device_ms"] > 0
                                      for label in groups)
                      and not any(k in name for name in lost for k in keep),
                      "lost_launches": out["lost_launches"],
                      "lost_by_range": lost, "device_ms": device})
        if tries[-1]["complete"]:
            break
    else:
        raise AssertionError(
            f"each of {attempts} traces of a train step lost a training "
            f"kernel's records: {tries}")
    out["attempts"] = tries
    out["lossless"] = out["lost_launches"] == 0
    return out


CKPT_ROOT = Path(__file__).resolve().parent / "build" / "chip_smoke_ckpt"
CKPT_EVERY = 10
BARE_STEPS = 6


def noise_launches(per_step):
    """A step's launches under weight noise: the noisy weights are dense
    products (as in JAX), so no crossbar kernel runs."""
    return {k: n for k, n in per_step.items()
            if k not in ("crossbar_matmul", "crossbar_matmul_t")}


def remat_check(cfg, params, lora, batch, microbatches, seq, dev, *,
                noise=False, seed=0):
    """One step's loss and LoRA gradients with ``ExecConfig.remat`` off
    and on (weight noise at sigma_rel 0.02 from a CUDA generator seeded
    alike, where ``noise``): bit-equal; the launches exactly
    ``train_launches`` (forward kernels twice with remat); peak device
    memory of each gradient pass above what was allocated before it."""
    from repro_torch import kernels
    from repro_torch.core.noise import NoiseConfig
    from repro_torch.models import transformer as tfm
    from repro_torch.optim import adamw
    from repro_torch.train import steps as st

    n_quant = quantized_matrices(params["layers"])
    runs = {}
    for remat in (False, True):
        ec = tfm.ExecConfig(remat=remat, noise=NoiseConfig(
            enabled=noise, sigma_rel=0.02))
        rng = (torch.Generator(device=dev).manual_seed(seed + 1) if noise
               else None)
        gc.collect()
        torch.cuda.synchronize()
        resident = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        kernels.reset_launches()
        t = time.perf_counter()
        loss, _, grads = st.accumulate_grads(st.make_loss_fn(cfg, ec), lora,
                                             params, batch, microbatches, rng)
        torch.cuda.synchronize()
        want = train_launches(cfg, n_quant, microbatches, seq, remat)
        runs[remat] = {
            "ms": 1e3 * (time.perf_counter() - t),
            "peak_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
            "above_resident_gb": (torch.cuda.max_memory_allocated(dev)
                                  - resident) / 1e9,
            "launches": {k: n for k, n in kernels.LAUNCHES.items() if n},
            "expected_launches": noise_launches(want) if noise else want,
            "loss": loss, "grads": list(adamw.leaves(grads)),
            "rng": rng.get_state() if noise else None}
    off, on = runs[False], runs[True]
    equal = (torch.equal(off["loss"], on["loss"])
             and all(torch.equal(a, b) for a, b in zip(off["grads"],
                                                       on["grads"]))
             and (not noise or torch.equal(off["rng"], on["rng"])))
    out = {"noise": noise, "bit_equal": equal,
           "loss": float(off["loss"]),
           **{f"{k}_{tag}": r[k] for tag, r in (("off", off), ("on", on))
              for k in ("ms", "peak_gb", "above_resident_gb", "launches",
                        "expected_launches")}}
    out["launches_exact"] = all(r["launches"] == r["expected_launches"]
                                for r in (off, on))
    return out


def make_train_state(cfg, dev, g, bits):
    """Random weights from ``g`` on an MnFm base and one rank-32 adapter
    on wq/wv whose B is drawn non-zero (at B = 0 the gradient of A is 0
    and hides a wrong dx)."""
    from repro_torch.configs.base import QuantConfig
    from repro_torch.core import lora as lora_lib
    from repro_torch.core import quant
    from repro_torch.models import transformer as tfm

    base = tfm.init_params(cfg, g, device=dev)
    params = quant.quantize_params(base, QuantConfig(mha_bits=bits[0],
                                                     ff_bits=bits[1]))
    del base
    gc.collect()
    lora = lora_lib.init_lora_params(cfg, g, device=dev)
    for entry in lora["layers"]:
        for ab in entry.values():
            ab["b"].normal_(0.0, 0.02, generator=g)
    return params, lora


def train_phase(dev, cfg, *, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
                microbatches=TRAIN_MICROBATCHES, steps=20, checked=5,
                noise_steps=0, bits=(8, 8), seed=0, check_layers=None):
    """LoRA fine-tuning of ``cfg`` at full width and depth on an MnFm base
    (``bits``, M8F8 by default; M4F4 puts int4 codes through
    ``crossbar_matmul`` and ``crossbar_matmul_t``; random weights from
    ``seed``), ``SyntheticLM`` batches of ``batch``
    x ``seq`` in ``microbatches``, AdamW at lr 1e-3 with warmup-cosine.
    The kernels' step against the plain versions' (dequantized weights,
    torch.matmul, ref attention, the plain wkv recurrence, autograd) on
    the card, with one rank-32 adapter on wq/wv whose B is drawn non-zero
    (``make_train_state``): the first step's loss and every LoRA
    gradient, then ``checked`` steps' losses, each path from the same
    start, at full depth or, with ``check_layers``, on a model of that
    many layers at full width (the plain path's activations of a deep
    model do not fit the card). Every checked step launches exactly
    ``train_launches`` of each kernel; the plain path none. Then the
    path: ``steps`` steps through
    the port's ``Trainer`` (its own adapter init and batches, an async
    checkpoint every ``CKPT_EVERY`` steps), the counts zeroed just before
    and read just after: step ms, tokens/s, peak memory and the loss
    curve from its metrics log; ``BARE_STEPS`` steps of the same step
    function without the Trainer beside them. A second ``Trainer``
    restores the last checkpoint onto the card and survives a step that
    fails once; one more step of the first, traced. ``noise_steps``
    noise-aware ``Trainer`` steps (sigma_rel 0.02): dense products of the
    noisy weights, so no crossbar launch. Last, at full depth,
    ``remat_check``, with weight noise where the model takes noise-aware
    steps."""
    from repro_torch import kernels
    from repro_torch.core import quant
    from repro_torch.core.noise import NoiseConfig
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.models import transformer as tfm
    from repro_torch.optim import adamw
    from repro_torch.train import steps as st
    from repro_torch.train.trainer import Trainer, TrainerConfig

    g = torch.Generator(device=dev).manual_seed(seed)
    t0 = time.perf_counter()
    ccfg = (cfg if check_layers is None
            else dataclasses.replace(cfg, n_layers=check_layers))
    params, lora = make_train_state(ccfg, dev, g, bits)
    widths = sorted({leaf.bits for leaf in adamw.leaves(params["layers"])
                     if quant.is_quantized(leaf)})
    ds = SyntheticLM(cfg.vocab_size, seed=seed)
    batches = [{k: torch.from_numpy(v).to(dev) for k, v in
                ds.batch(i, batch, seq).items()} for i in range(checked)]
    hp = st.TrainHParams(microbatches=microbatches, adamw=adamw.AdamWConfig(
        lr=1e-3, schedule=adamw.warmup_cosine(max(steps // 10, 1), steps)))
    ec_k = tfm.ExecConfig()
    ec_p = tfm.ExecConfig(attn_impl="ref", rwkv_impl="ref")
    check_step = train_launches(ccfg, quantized_matrices(params["layers"]),
                                microbatches, seq)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0

    # the first step's loss and gradients, kernels against plain versions
    plain_params = quant.dequantize_params(params)
    kernels.reset_launches()
    lk, _, gk = st.accumulate_grads(st.make_loss_fn(ccfg, ec_k), lora,
                                    params, batches[0], microbatches)
    torch.cuda.synchronize()
    grad_launches = dict(kernels.LAUNCHES)
    kernels.reset_launches()
    lp, _, gp = st.accumulate_grads(st.make_loss_fn(ccfg, ec_p), lora,
                                    plain_params, batches[0], microbatches)
    torch.cuda.synchronize()
    plain_launches = {k: n for k, n in kernels.LAUNCHES.items() if n}
    grad_err = [float((a - b).norm() / b.norm())
                for a, b in zip(adamw.leaves(gk), adamw.leaves(gp))]
    first = {"loss_kernels": float(lk), "loss_plain": float(lp),
             "loss_rel_err": abs(float(lk) - float(lp)) / abs(float(lp)),
             "grad_rel_err_by_leaf": grad_err,
             "grad_norm_by_leaf": [float(b.norm())
                                   for b in adamw.leaves(gp)]}
    del gk, gp

    # ``checked`` steps on each path from the same start
    step_k = st.make_train_step(ccfg, ec_k, hp)
    step_p = st.make_train_step(ccfg, ec_p, hp)
    sk = sp = (lora, adamw.init(lora))
    losses_k, losses_p, step_launches = [], [], []
    for i in range(checked):
        kernels.reset_launches()
        *sk, mk = step_k(params, *sk, batches[i])
        losses_k.append(float(mk["loss"]))
        step_launches.append({k: n for k, n in kernels.LAUNCHES.items() if n})
        kernels.reset_launches()
        *sp, mp = step_p(plain_params, *sp, batches[i])
        losses_p.append(float(mp["loss"]))
        if any(kernels.LAUNCHES.values()):
            plain_launches = {k: n for k, n in kernels.LAUNCHES.items() if n}
    del plain_params, sk, sp
    gc.collect()
    loss_err = [abs(a - b) / abs(b) for a, b in zip(losses_k, losses_p)]
    if check_layers is not None:
        # the checks ran on a shallower model: the full depth from here
        del params, lora
        gc.collect()
        torch.cuda.empty_cache()
        t = time.perf_counter()
        params, lora = make_train_state(cfg, dev, g, bits)
        torch.cuda.synchronize()
        setup_s += time.perf_counter() - t
    n_quant = quantized_matrices(params["layers"])
    per_step = train_launches(cfg, n_quant, microbatches, seq)
    step_k = st.make_train_step(cfg, ec_k, hp)

    # the path: ``steps`` steps through the Trainer, checkpointing
    ckpt_dir = CKPT_ROOT / cfg.name
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    tc = TrainerConfig(seq_len=seq, global_batch=batch, steps=steps,
                       ckpt_dir=str(ckpt_dir), ckpt_every=CKPT_EVERY,
                       hparams=hp, seed=seed, log_every=steps)
    tr = Trainer(cfg, tc, ds, params=params, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    kernels.reset_launches()
    log = tr.run()
    run_launches = dict(kernels.LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    step_ms = [1e3 * r["sec"] for r in log]
    curve = [r["loss"] for r in log]
    # the same step function without the Trainer around it, on batches
    # already on the card: what the Trainer's own host work costs
    bare_ms = []
    for i in range(BARE_STEPS):
        t = time.perf_counter()
        m = step_k(params, tr.lora, tr.opt_state, batches[i % checked])[2]
        float(m["loss"])
        bare_ms.append(1e3 * (time.perf_counter() - t))

    # a restart: a second Trainer restores the last checkpoint onto the
    # card, bit-equal; a step hook fails once, and ``run_with_restarts``
    # restores again and re-runs the step
    fail_at, failed = steps + 1, []

    def fail_once(step):
        if step == fail_at and not failed:
            failed.append(step)
            raise RuntimeError(f"injected failure at step {step}")

    tr2 = Trainer(cfg, dataclasses.replace(tc, steps=steps + 2), ds,
                  params=params, device=dev, step_hook=fail_once)
    restored = tr2.maybe_restore()
    mine = adamw.leaves((tr.lora, tr.opt_state.mu, tr.opt_state.nu))
    back = adamw.leaves((tr2.lora, tr2.opt_state.mu, tr2.opt_state.nu))
    restore_equal = restored and tr2.step == steps and all(
        a.device == b.device and torch.equal(a, b) for a, b in
        zip(mine, back))
    kernels.reset_launches()
    log2 = tr2.run_with_restarts()
    restart = {"restored_step": steps if restored else None,
               "restored_bit_equal": restore_equal,
               "restarts": tr2.fault.restarts,
               "steps": [r["step"] for r in log2],
               "losses": [r["loss"] for r in log2],
               "launches": {k: n for k, n in kernels.LAUNCHES.items() if n},
               "ckpt_bytes": sum(f.stat().st_size
                                 for f in ckpt_dir.rglob("*") if f.is_file())}
    del tr2
    def one_more_step():
        tr.tc = dataclasses.replace(tc, steps=tr.step + 1)
        tr.run()

    # rwkv6-7b's trace keeps every wkv backward launch's record
    trace = traced_step(one_more_step,
                        RWKV_GROUPS if is_rwkv(cfg) else ATTN_GROUPS,
                        keep=("rwkv6_wkv_bwd",) if is_rwkv(cfg) else ())
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    del tr
    gc.collect()

    noise = None
    if noise_steps:
        trn = Trainer(cfg, dataclasses.replace(tc, steps=noise_steps,
                                               ckpt_dir=None), ds,
                      exec_cfg=tfm.ExecConfig(noise=NoiseConfig(
                          enabled=True, sigma_rel=0.02)),
                      params=params, device=dev)
        kernels.reset_launches()
        nlosses = [r["loss"] for r in trn.run()]
        noise = {"sigma_rel": 0.02, "steps": noise_steps, "losses": nlosses,
                 "launches": {k: n for k, n in kernels.LAUNCHES.items() if n}}
        del trn

    # remat off and on, at full depth, after the path (which runs as it
    # did before remat was ported)
    remat = remat_check(cfg, params, lora, batches[0], microbatches, seq,
                        dev, noise=noise_steps > 0, seed=seed)
    gc.collect()

    loss_tol, grad_tol = ((RWKV_TRAIN_LOSS_TOL_REL, RWKV_TRAIN_GRAD_TOL_REL)
                          if is_rwkv(cfg) else
                          (TRAIN_LOSS_TOL_REL, TRAIN_GRAD_TOL_REL))
    med = statistics.median(step_ms[1:]) if steps > 1 else step_ms[0]
    # device time over the untraced Trainer step's median wall: the traced
    # wall also holds the CPU activity's own cost
    trace["busy_share_of_median_step"] = trace["device_ms"] / med
    result = {
        "phase": "train", "model": cfg.name, "layers": cfg.n_layers,
        "d_model": cfg.d_model, "vocab": cfg.vocab_size,
        "base": f"M{bits[0]}F{bits[1]}", "code_bits": widths,
        "quantized_matrices": n_quant, "lora_rank": cfg.lora.rank,
        "lora_targets": list(cfg.lora.targets), "batch": batch, "seq": seq,
        "microbatches": microbatches, "lr": 1e-3, "setup_s": setup_s,
        "check_layers": ccfg.n_layers, "check_launches_per_step": check_step,
        "first_step": first, "grad_tol_rel": grad_tol,
        "checked_losses_kernels": losses_k, "checked_losses_plain": losses_p,
        "checked_loss_rel_err": loss_err, "loss_tol_rel": loss_tol,
        "launches_per_step": per_step, "first_step_launches": grad_launches,
        "checked_step_launches": step_launches,
        "plain_launches": plain_launches, "steps": steps,
        "step_ms": step_ms, "first_step_ms": step_ms[0],
        "median_step_ms": med, "tokens_per_s": batch * seq / (med / 1e3),
        "bare_step_ms": bare_ms,
        "bare_median_step_ms": statistics.median(bare_ms[1:]),
        "peak_mem_gb": peak_gb, "loss_curve": curve,
        "run_launches": run_launches, "restart": restart,
        "traced_step": trace, "noise": noise, "remat": remat,
    }
    emit(result)
    problems = []
    if widths != sorted(set(bits)):
        problems.append(f"code widths {widths}, expected {bits}")
    if first["loss_rel_err"] > loss_tol or max(loss_err) > loss_tol:
        problems.append(f"losses differ: {first['loss_rel_err']}, {loss_err}")
    if max(grad_err) > grad_tol:
        problems.append(f"LoRA gradients differ: {grad_err}")
    if {k: n for k, n in grad_launches.items() if n} != check_step:
        problems.append(f"the first step launched {grad_launches}, expected "
                        f"{check_step}")
    if any(sl != check_step for sl in step_launches):
        problems.append(f"checked steps launched {step_launches}, expected "
                        f"{check_step} each")
    if is_rwkv(cfg) and not any(
            m in name for name in trace["port_kernels_device_ms"]
            for m in WKV_BWD_KERNEL_OF["chunk"]):
        problems.append(f"the traced step ran no chunked wkv backward: "
                        f"{trace['port_kernels_device_ms']}")
    if not (remat["bit_equal"] and remat["launches_exact"]):
        problems.append(f"remat: {remat}")
    if plain_launches:
        problems.append(f"the plain path launched {plain_launches}")
    want_run = {k: n * steps for k, n in per_step.items()}
    if {k: n for k, n in run_launches.items() if n} != want_run:
        problems.append(f"the {steps}-step run launched {run_launches}, "
                        f"expected {want_run}")
    if not all(np.isfinite(curve)):
        problems.append(f"non-finite losses: {curve}")
    want_restart = {k: n * 3 for k, n in per_step.items()}
    if (not restore_equal or restart["restarts"] != 1
            or restart["steps"] != [steps + 1, steps + 1, steps + 2]
            or abs(restart["losses"][0] - restart["losses"][1])
            > TRAIN_LOSS_TOL_REL * abs(restart["losses"][0])
            or restart["launches"] != want_restart):
        problems.append(f"the restart: {restart}, expected a bit-equal "
                        f"restore of step {steps}, one restart, steps "
                        f"{[steps + 1, steps + 1, steps + 2]} with the "
                        f"re-run step's loss equal, launches {want_restart}")
    if noise is not None:
        want_n = {k: n * noise_steps
                  for k, n in noise_launches(per_step).items()}
        if noise["launches"] != want_n or not all(
                np.isfinite(noise["losses"])):
            problems.append(f"noise-aware steps: {noise}, expected launches "
                            f"{want_n}")
    if problems:
        raise AssertionError(f"train phase of {cfg.name}: " + "; ".join(
            problems))
    return result


# ---------------------------------------------------------------------------
# phase 7: the paper figures that run the model, and the serving workloads
# ---------------------------------------------------------------------------

FIG13_COUNTED_STEPS = 20


def _numbers(tree):
    """Every float in a nested payload."""
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _numbers(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _numbers(v)
    elif isinstance(tree, float):
        yield tree


def fig13_counted_finetune(dev, steps=FIG13_COUNTED_STEPS):
    """``steps`` Fig. 13 fine-tune steps and the evaluation over an M4F4
    base (random weights: the launches do not depend on them), the counts
    zeroed just before and read just after; exactly ``train_launches`` a
    step (one microbatch) and one crossbar per quantized matrix and one
    flash kernel per layer for each evaluation batch."""
    from benchmarks import torch_quant_perplexity as qppl
    from repro_torch import kernels
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.models import transformer as tfm

    cfg = qppl.config()
    base = qppl.quantized(tfm.init_params(
        cfg, torch.Generator(device=dev).manual_seed(0), device=dev), "M4F4")
    n_quant = quantized_matrices(base["layers"])
    kernels.reset_launches()
    t = time.perf_counter()
    ppl = qppl.finetune_and_ppl(cfg, base, SyntheticLM(cfg.vocab_size,
                                                       seed=2), dev,
                                steps=steps)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t
    got = {k: n for k, n in kernels.LAUNCHES.items() if n}
    want = {k: n * steps for k, n in train_launches(cfg, n_quant, 1).items()}
    for k, n in (("crossbar_matmul", n_quant), ("flash_attention",
                                                 cfg.n_layers)):
        want[k] += n * qppl.EVAL_BATCHES
    result = {"phase": "figures", "figure": "fig13 counted fine-tune",
              "base": "M4F4", "steps": steps, "seconds": seconds,
              "ppl": ppl, "launches": got, "expected_launches": want}
    emit(result)
    if got != want or not np.isfinite(ppl):
        raise AssertionError(f"Fig. 13 fine-tune: launched {got}, expected "
                             f"{want}; ppl {ppl}")
    return result


def figures_phase(dev):
    """Fig. 9 (``benchmarks/torch_noise.py``), Fig. 13
    (``benchmarks/torch_quant_perplexity.py``) at their full protocols and
    the serving-throughput workloads 1-3, 5 and 6 at the JAX script's smoke
    sizes
    (``benchmarks/torch_serve_throughput.py``), each on the card with the
    counts zeroed just before and read just after; one line each with its
    payload and seconds. Fails on a non-finite number, a greedy check that
    fails, or a kernel of the path with no launch. Then 20 Fig. 13
    fine-tune steps with their launches held exactly."""
    import os

    from benchmarks import torch_noise
    from benchmarks import torch_quant_perplexity as qppl
    from benchmarks import torch_serve_throughput as tput
    from repro_torch import kernels

    def smoke_throughput():
        os.environ["BENCH_SMOKE"] = "1"
        try:
            return tput.run(dev)
        finally:
            os.environ.pop("BENCH_SMOKE")

    out = {}
    for name, run, must in (
            ("fig9", lambda: torch_noise.run(dev),
             ("flash_attention", "flash_attention_bwd")),
            ("fig13", lambda: qppl.run(dev),
             ("crossbar_matmul", "crossbar_matmul_t", "flash_attention",
              "flash_attention_bwd")),
            ("serve_throughput (smoke)", smoke_throughput,
             ("flash_attention", "paged_flash_attention", "selective_scan"))):
        kernels.reset_launches()
        t = time.perf_counter()
        payload = run()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t
        launches = {k: n for k, n in kernels.LAUNCHES.items() if n}
        emit({"phase": "figures", "figure": name, "seconds": seconds,
              "launches": launches, "payload": payload})
        problems = [f"no launch of {k}" for k in must if not launches.get(k)]
        if not all(np.isfinite(x) for x in _numbers(payload)):
            problems.append("a non-finite number in the payload")
        if name.startswith("serve") and not (
                payload["paged"]["greedy_matches_dense_oracle"]
                and payload["shared_prefix"]["greedy_matches_dense_oracle"]
                and payload["spec_decode"]["greedy_matches_dense_oracle"]
                and payload["moe_dropless"]["greedy_matches_dense_oracle"]
                and payload["spec_hybrid"]["greedy_matches_dense_oracle"]):
            problems.append("a greedy check failed")
        if name.startswith("serve") and not (
                payload["moe_dropless"]["capacity_dropped_tokens"] > 0):
            problems.append("the MoE capacity baseline dropped nothing")
        if name.startswith("serve") and not (
                payload["spec_hybrid"]["spec_on"]["recurrent_rollbacks"] > 0):
            problems.append("the hybrid's speculation never rolled back")
        if problems:
            raise AssertionError(f"{name}: " + "; ".join(problems))
        out[name] = {"seconds": seconds, "launches": launches,
                     "payload": payload}
    out["fig13 counted fine-tune"] = fig13_counted_finetune(dev)
    return out


# ---------------------------------------------------------------------------


# the models served, in order, and those whose engine is then profiled
SERVED = ("llama3.2-1b", "gemma2-9b", "rwkv6-7b", "paper-gpt2-medium",
          "paper-bloom-560m", "llama4-scout-17b-a16e", "jamba-1.5-large-398b")
# a model's serve geometry where not the default: gemma2-9b's two long
# prompts pass its 4096-token window (its rings wrap), and a window of its
# graph decode ticks is traced; llama4-scout (``moe_serve_phase``) at 24
# of its 48 layers (the M8F8 codes of 48 would take 106 GB), with a traced
# window of graph decode ticks; jamba-1.5-large-398b at one scan period, 8
# of its 72 layers (1 attention, 7 Mamba, 4 MoE FFs: 48.8 GB of M8F8 codes;
# two periods would not fit), its adapters also on the Mamba projections,
# a traced window of replayed mixed ticks after its serve, then n-gram
# speculation on the same engine geometry
SERVE_KW = {"gemma2-9b": dict(max_len=5120, long_prompts=(2, (4300, 4800)),
                              trace_decode=(8, 8)),
            "llama4-scout-17b-a16e": dict(layers=24, trace_decode=(8, 8)),
            "jamba-1.5-large-398b": dict(
                layers=8, trace_decode=(8, 8), trace_mixed=True,
                spec=("ngram", 4, 32),
                lora_targets=("wq", "wv", "mamba_in", "mamba_out"))}
# the forwards at full width after the serves (``forward_phase``):
# mixtral-8x22b at 2 of its 56 layers (top-2 over 8 experts, a prompt past
# its 4096 window: GQA group 6 through the windowed flash kernel, then
# decode over the ring), musicgen-medium at full depth from embeddings;
# the three head-dim-128 models at 8 layers each (the plain reference
# holds every layer's dequantized f32 weights at once: 2.8 GB a layer for
# chameleon-34b, 1.4 for internlm2-20b, 1.1 for mistral-nemo-12b, so full
# depth would not fit beside the codes; 8 layers keep it under 25 GB):
# internlm2-20b (48/8 heads), mistral-nemo-12b (32/8, a query width of 4096
# below its d_model of 5120), chameleon-34b (64/8, qk-norm, from its
# embeddings frontend)
FORWARDS = (("mixtral-8x22b", dict(layers=2, prompt_len=4400,
                                   decode_steps=4)),
            ("musicgen-medium", dict(embeds=True, prompt_len=512,
                                     decode_steps=4)),
            ("internlm2-20b", dict(layers=8, prompt_len=512,
                                   decode_steps=4)),
            ("mistral-nemo-12b", dict(layers=8, prompt_len=512,
                                      decode_steps=4)),
            ("chameleon-34b", dict(layers=8, embeds=True, prompt_len=512,
                                   decode_steps=4)))
PROFILED = ("llama3.2-1b", "rwkv6-7b", "paper-gpt2-medium")
# the models the dense oracle engine also serves (after the paged one)
DENSE = ("llama3.2-1b",)
# speculative decoding after a model's serve, on its weights, adapters and
# requests: (drafter, k, new tokens per request)
SPEC = {"llama3.2-1b": (("ngram", 4, 32), ("selfdraft", 4, 16)),
        "rwkv6-7b": (("ngram", 4, 32),)}
# the models whose serve engine saves its prefix index for a new engine
PERSISTED = ("llama3.2-1b",)
# the models fine-tuned, in order: base bits, Trainer steps (a multiple of
# CKPT_EVERY) and noise-aware steps; GPT-2 again on an int4 base
TRAINED = (("llama3.2-1b", (8, 8), 20, 0),
           ("paper-gpt2-medium", (8, 8), 20, 2),
           ("paper-gpt2-medium", (4, 4), 10, 0),
           ("rwkv6-7b", (8, 8), 10, 0))
# the depth at which a model's kernel step is held against the plain one,
# where not its full depth: rwkv6-7b's gradients are too ill-conditioned
# deeper (``RWKV_TRAIN_GRAD_TOL_REL``), and its plain path would not fit
# the card at 32 layers (the plain wkv recurrence under autograd keeps
# every step's state, ~3 GB a layer at 2 x 512 tokens)
CHECK_LAYERS = {"rwkv6-7b": 2}


def main() -> int:
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "run needs a CUDA card", file=sys.stderr)
        return 1
    src = Path(__file__).resolve().parent / "src"
    if not (src / "repro_torch").is_dir():
        # run outside a checkout: the port's package is not beside it
        print(f"chip_smoke: no package repro_torch under {src}; run this "
              f"script from a checkout of the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, str(src))
    sys.path.append(str(src.parent))        # the benchmarks package
    from repro_torch.configs import get_config
    from repro_torch.kernels import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    if sys.argv[1:] == [LATE_FLAG]:
        # the late kernel cases, in the process ``late_kernel_phase`` starts
        kernel_phase(dev, slice10_cases)
        kernel_phase(dev, slice11_cases)
        return 0
    smi = smi_line()
    emit({"phase": "device", "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda})

    t = time.perf_counter()
    logs = build.build(force=True)
    emit({"phase": "build", "seconds": time.perf_counter() - t,
          "sources": sorted(logs),
          "ptxas": {name: ptxas_report(log) for name, log in logs.items()}})

    cases = kernel_phase(dev)
    serves = {}
    for arch in SERVED:
        cfg = get_config(arch)
        if cfg.moe is not None:
            serves[arch], eng = moe_serve_phase(dev, cfg,
                                                **SERVE_KW.get(arch, {}))
        else:
            serves[arch], eng = serve_phase(dev, cfg, dense=arch in DENSE,
                                            specs=SPEC.get(arch, ()),
                                            persist=arch in PERSISTED,
                                            **SERVE_KW.get(arch, {}))
        if arch in PROFILED:
            profile_phase(eng, cfg, dev)
        del eng                          # free the model before the next
        gc.collect()
        torch.cuda.empty_cache()
    forwards = {}
    for arch, kw in FORWARDS:
        forwards[arch] = forward_phase(dev, get_config(arch), **kw)
        gc.collect()
        torch.cuda.empty_cache()
    trains = {}
    for arch, bits, steps, noise_steps in TRAINED:
        key = arch if bits == (8, 8) else f"{arch} M{bits[0]}F{bits[1]}"
        trains[key] = train_phase(dev, get_config(arch), bits=bits,
                                  steps=steps, noise_steps=noise_steps,
                                  check_layers=CHECK_LAYERS.get(arch))
        gc.collect()
        torch.cuda.empty_cache()
    cases += late_kernel_phase()
    figures = figures_phase(dev)

    # each kernel: its case at a main-path shape, and its launches from the
    # path it serves (the engine, the dense-cache forward for contiguous
    # flash, the llama train step's run for the backward kernels), with
    # every path's count beside it
    paths = {f"{a} {p.split('_')[0]}": r[p] for a, r in serves.items()
             for p in ("serve_launches", "forward_launches")}
    paths.update({f"{a} dense": r["dense_launches"] for a, r in serves.items()
                  if "dense_launches" in r})
    paths.update({f"{a} {k}": r[f"{k}_launches"] for a, r in serves.items()
                  for k in ("spec", "selfdraft", "persist")
                  if f"{k}_launches" in r})
    paths.update({f"{a} forward": r["launches"]
                  for a, r in forwards.items()})
    paths.update({f"{a} train": r["run_launches"] for a, r in trains.items()})
    paths.update({f"{f} figure": r["launches"] for f, r in figures.items()})
    rep = {"crossbar_matmul": ("llama3.2-1b serve",
                               {"bits": 8, "model": "llama3.2-1b",
                                "shape": {"M": 8, "K": 2048, "N": 8192}}),
           "grouped_crossbar_matmul": ("llama4-scout-17b-a16e serve",
                                       {"bits": 8, "case": "decode_spread",
                                        "model": "llama4-scout-17b-a16e"}),
           "flash_attention": ("llama3.2-1b forward",
                               {"case": "prefill", "model": "llama3.2-1b"}),
           "paged_flash_attention": ("llama3.2-1b serve",
                                     {"case": "mixed",
                                      "model": "llama3.2-1b"}),
           "ring_flash_attention": ("gemma2-9b serve",
                                    {"case": "chunk", "model": "gemma2-9b"}),
           "rwkv6_wkv": ("rwkv6-7b serve", {"case": "decode"}),
           "rwkv6_wkv_chunk": ("rwkv6-7b serve", {"case": "prefill"}),
           "selective_scan": ("jamba-1.5-large-398b serve",
                              {"case": "decode"}),
           "moe_route": ("llama4-scout-17b-a16e serve",
                         {"case": "decode",
                          "model": "llama4-scout-17b-a16e"}),
           "moe_combine": ("llama4-scout-17b-a16e serve",
                           {"case": "decode",
                            "model": "llama4-scout-17b-a16e"}),
           "crossbar_matmul_t": ("llama3.2-1b train",
                                 {"model": "llama3.2-1b", "bits": 8,
                                  "case": "microbatch",
                                  "shape": {"M": TRAIN_M, "K": 2048,
                                            "N": 8192}}),
           "flash_attention_bwd": ("llama3.2-1b train",
                                   {"case": "causal",
                                    "model": "llama3.2-1b"}),
           "rwkv6_wkv_bwd": ("rwkv6-7b train", {"case": "microbatch",
                                                "kernel": "chunk"})}
    sources = {"crossbar_matmul": "src/repro_torch/csrc/crossbar_matmul.cu",
               "grouped_crossbar_matmul":
                   "src/repro_torch/csrc/crossbar_matmul.cu",
               "crossbar_matmul_t": "src/repro_torch/csrc/crossbar_matmul.cu",
               "flash_attention": "src/repro_torch/csrc/flash_attention.cu",
               "flash_attention_bwd":
                   "src/repro_torch/csrc/flash_attention.cu",
               "paged_flash_attention":
                   "src/repro_torch/csrc/flash_attention.cu",
               "ring_flash_attention":
                   "src/repro_torch/csrc/flash_attention.cu",
               "rwkv6_wkv": "src/repro_torch/csrc/rwkv6_wkv.cu",
               "rwkv6_wkv_chunk": "src/repro_torch/csrc/rwkv6_wkv.cu",
               "rwkv6_wkv_bwd": "src/repro_torch/csrc/rwkv6_wkv.cu",
               "selective_scan": "src/repro_torch/csrc/selective_scan.cu",
               "moe_route": "src/repro_torch/csrc/moe_route.cu",
               "moe_combine": "src/repro_torch/csrc/moe_route.cu"}
    # the backward kernels replace what the JAX package computes by
    # autodiff around the same Pallas kernels' functions
    replaces = {
        "crossbar_matmul": "src/repro/kernels/crossbar_matmul/kernel.py:102",
        "grouped_crossbar_matmul":
            "src/repro/kernels/crossbar_matmul/kernel.py:102",
        "crossbar_matmul_t": "src/repro/kernels/crossbar_matmul/kernel.py:102",
        "flash_attention": "src/repro/kernels/flash_attention/kernel.py:81",
        "flash_attention_bwd": "src/repro/kernels/flash_attention/kernel.py:81",
        "paged_flash_attention":
            "src/repro/kernels/flash_attention/kernel.py:81",
        "ring_flash_attention":
            "src/repro/kernels/flash_attention/kernel.py:81",
        "rwkv6_wkv": "src/repro/kernels/rwkv6_wkv/kernel.py:59",
        "rwkv6_wkv_chunk": "src/repro/kernels/rwkv6_wkv/kernel.py:59",
        "rwkv6_wkv_bwd": "src/repro/kernels/rwkv6_wkv/kernel.py:59",
        # no Pallas kernel: the JAX function it replaces
        "selective_scan": "src/repro/models/ssm.py:89",
        "moe_route": "src/repro/models/moe.py:158",
        "moe_combine": "src/repro/models/moe.py:226"}
    # what the JAX package computes in place of each backward kernel
    autodiff_of = {
        "crossbar_matmul_t":
            "src/repro/core/hetero.py:81 (static_matmul: dequantize, dot)",
        "flash_attention_bwd":
            "src/repro/models/attention.py:244 (blocked_attention's VJP)",
        "rwkv6_wkv_bwd": "src/repro/models/rwkv.py:83 (wkv_scan)"}
    # what the JAX package computes in place of the grouped kernel, outside
    # any Pallas call
    einsum_of = {
        "grouped_crossbar_matmul":
            "src/repro/models/moe.py:213 (static_einsum over the dequantized "
            "expert stack, C = T rows per slot)"}
    # what the JAX package computes in place of the scan kernel
    scan_of = {
        "selective_scan":
            "src/repro/models/ssm.py:89 (_selective_scan: lax.scan over "
            "chunks, associative_scan inside, no Pallas call)"}
    # what the JAX package computes in place of the MoE layer's routing
    # and combine kernels, outside any Pallas call
    moe_of = {
        "moe_route":
            "src/repro/models/moe.py:158 (apply_moe's dropless branch: "
            "softmax, top_k, the aux losses, the one-hot cumsum rank, the "
            "scatter into the C = T-row buffer)",
        "moe_combine":
            "src/repro/models/moe.py:226 (take_along_axis of each "
            "assignment's row, times its gate, summed; the shared expert "
            "added)"}
    summary = []
    for name, (path, sel) in rep.items():
        c = next(c for c in cases if c["name"] == name
                 and all(c.get(k) == v for k, v in sel.items()))
        summary.append({
            "name": name, "route": "cuda", "source": sources[name],
            "replaces": replaces[name],
            **({"jax_autodiff_of": autodiff_of[name]}
               if name in autodiff_of else {}),
            **({"jax_einsum_of": einsum_of[name]}
               if name in einsum_of else {}),
            **({"jax_scan_of": scan_of[name]} if name in scan_of else {}),
            **({"jax_ops_of": moe_of[name]} if name in moe_of else {}),
            "launches": paths[path][name], "path": path,
            "launches_by_path": {p: counts.get(name, 0)
                                 for p, counts in paths.items()},
            "max_abs_err": c["max_abs_err"], "ms": c["ms"],
            "device_ms": c["device_ms"],
            "plain_ms": c["plain_ms"], "bound_ms": c["bound_ms"],
            "bound_by": c["bound_by"], "library_ms": c["library_ms"],
            **{k: c[k] for k in ("library", "library_device_ms",
                                 "library_kernels", "bound_pieces_ms",
                                 "host_us") if k in c},
            "at": c["shape"]})
        if name != "crossbar_matmul":   # every case of the kernel beside it
            summary[-1]["cases"] = [
                {k: o[k] for k in ("case", "model", "kernel", "bits",
                                   "shape", "max_abs_err", "tol",
                                   "max_rel_err",
                                   "same_bits",
                                   "tol_rel", "ms", "device_ms",
                                   "host_us", "plain_ms",
                                   "library_ms", "library_device_ms",
                                   "bound_ms", "bound_pieces_ms", "bound_by",
                                   "bound_parts_ms",
                                   "plain_device_ms", "plain_device_kernels",
                                   "check")
                 if k in o}
                for o in cases if o["name"] == name]
    emit({"phase": "total", "seconds": time.perf_counter() - t_start})
    emit({"kernels": summary})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
