#!/usr/bin/env python3
"""Drive the PyTorch port's paths on one NVIDIA card and hold each of its
hand-written kernels against the kernel's plain PyTorch version.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases, each printing its own lines:
  1. device  - the card's name, count, power limit and SM clock;
  2. build   - every kernel, compiled with nvcc for sm_90a from the sources
               in the checkout, all sources at once (ptxas summary, seconds);
  2b. lint   - the static analyzer's card half (repro_torch.analysis):
               the SASS contracts over `cuobjdump -sass` of the four
               builds (no MUFU transcendental, no .FTZ, no f32 atomic add
               in K1/K2), each kernel's registers and spills from ptxas,
               every registry plan and every results/tuning_torch.json
               entry against the card's own answer (the shared memory the
               kernel asks for equal to the plan's, at least one block an
               SM; K4's static shared memory against ptxas's for each of
               its instances), and one small launch of each kernel for its
               output dtype; any violation fails the run;
  3. check   - each kernel against its plain version on the card, bit for
               bit: olm_matmul_fused (K1) and olm_matmul_host (K2), against
               it and against each other, at every olm width and tier on a
               ragged shape, at K of 1, 3, 15, 17 and 33 lanes, M of 1, 5
               and 17 rows with a ragged N, w transposed (olm16, olm24 and
               olm32 at each), an all-subnormal tile, every GEMM shape of
               the serve path (its LM head included, at decode and
               prefill; their plain versions computed while the kernels
               build), online_mul (K4) and online_dot (K3) at a million
               and four thousand rows, tpmm (K5) at tpmm16 and tpmm8 under
               its three level cutoffs on a ragged shape, an all-subnormal
               row, the tile and split edges, A planes at an odd address
               and every serve GEMM shape; K3 also at a ragged B with K
               of 1, 3, 33 and 1024 lanes, an odd n, full working
               precision and operands at a 4-byte offset; the general
               kernel (`online_dot_any`, K4's too at one lane a row)
               through the public online_mul / online_dot at other
               delays (a negative one too) and estimate widths (wider
               than the datapath too), in its int64 lane, n of 36 and
               40, and K past 1024 lanes (streams of 64 and 128 bits),
               one launch each, and a configuration no kernel holds
               raising before any launch; K3 at the paper's
               configuration past 1024 lanes (aligned subtrees of 1024
               lanes merged by the row's last block) at a ragged B with
               K of 1024, 1025, 4096 and 8192 at n 16 and 32; F6's
               configurations (the selection condition holds, the
               residual leaves int32 or
               is not proven in it: K4 at (n, delta, t) = (24, 2, 4),
               (28, 2, 4) and (24, 3, 4), K3 at (24, 2, 4) with K of
               256, at least 2^16 lanes each) bit-equal in int64 lanes,
               and (32, 2, 5) raising before any launch; K1 and K2 at
               more row blocks than grid y holds (F7: 524,317 rows), on
               rows at both ends and across the z boundary; K1 at the
               weight-bearing GEMM
               shapes of ChatGLM3-6B (M of 4), Yi-34B and
               Qwen1.5-110B (M of 4; wide outputs on their first and last
               2048 columns), and at the eng.dot GEMM shapes of
               RecurrentGemma-9B (M of 4 and 7), Mamba2-130M,
               Mixtral-8x22B and Qwen3-MoE-235B-A22B (M of 4; outputs
               wider than 32768 on their first and last 2048 columns,
               M = 64 on those columns only; the plain versions of all
               these K1 shapes computed while the kernels build); K3
               and K4 against the paper's scalar model
               (core/inner_product.online_dot, core/online_mul.
               online_multiply) row by row; plus the smoke-size model
               under olm16 and under tpmm16 on the card against the same
               model on the CPU;
  4. time    - each kernel at those shapes (and the general K3/K4
               kernels at one shape each, K3 past 1024 lanes at
               InternLM2-1.8B's d_model and d_ff lanes a row at n 16 and
               32, K1 at ChatGLM3-6B's decode and prefill GEMMs and at
               the four families' decode GEMMs)
               beside its bound, its plain version (K1's where a call of
               it is at most PLAIN_TIMED_WORK of M x K x N) and a PyTorch
               context call: the median of CUDA
               event pairs, one per launch, with the L2 cache overwritten
               before each; a time below its bound fails the run;
  5. serve   - ServeEngine at the full published InternLM2-1.8B width,
               4 seeded requests, once under dot_mode="olm16" (every GEMM
               through K1) and once under "tpmm16" (every GEMM through K5):
               the path's kernel launch count must equal the GEMMs the
               forward passes issued. Each is run a second time with the
               kernel's launches (and, under tpmm16, the plane
               decompositions) between CUDA events, for their share of the
               wall, and under torch.profiler (the device's activity
               alone), for the device's busy share;
  6. paths   - the other two paths a user calls: olm_matmul(quantize="host")
               over one decoder layer's GEMMs at decode (K2), and the
               digit-level API online_mul / online_dot (K4, K3), each with
               the launch counts set to 0 just before and read just after;
  7. replay  - the fault-tolerant serving path at the full published
               InternLM2-1.8B width: the serve_faults bench's seed-0
               workload and fault plan (results/baseline/
               BENCH_serve_faults.json) through ServeEngine under olm16
               with the degrade ladder olm16 / olm16t12 / olm16t10 (every
               GEMM of every tier through K1), preemption, the numerics
               guard and the integrity audit; once fault-free, once
               faulted, and once fault-free with chunked prefill. Its 14
               step-counted rows must equal the baseline's and K1's
               launches the GEMMs of the forward passes run;
  8. dense   - the rest of the dense family: ChatGLM3-6B (QKV bias, half
               RoPE, 2 KV heads) at its full published width and depth,
               served like phase 5 under olm16 (launches == passes x 197,
               the same tokens twice); Model.forward and lm_loss on one
               (1, 32) batch under olm16 (the last position bit-identical
               to prefill's logits, the loss equal to a plain NLL to 1e-6);
               a native forward at (1, 1024), where attention runs the
               flash path, against the same forward with the plain path
               forced (within 3e-2 of the largest |logit|); Yi-34B (2
               layers) and Qwen1.5-110B (1 layer) at full published width:
               a 64-row prefill and two 4-lane decode steps under olm16,
               K1 launches == GEMMs;
  9. families - the recurrent and MoE families: RecurrentGemma-9B at its
               full published width, its depth cut to 14 of 38 layers
               (4 (rec, rec, attn) groups and the (rec, rec) remainder),
               served like phase 5 under olm16 but not profiled
               (launches == passes x 89, every prefill at its request's
               exact length, the same tokens twice, kv_report printed);
               a native prefill of 2100 tokens into a 2304-token cache,
               past the 2048-token window, so every attention ring rolls,
               and 4 decode steps, each within 3e-2 of the largest |logit|
               of forward over the 2104 tokens (the windowed flash path;
               also printed against forward with plain attention forced);
               Mamba2-130M at full width and depth served the same way,
               and profiled (launches == passes x 49, no K/V bytes), and a
               native 31-token prefill and one decode against forward;
               Mixtral-8x22B and Qwen3-MoE-235B-A22B (2 layers each) at
               full published width: a 64-row prefill and two 4-lane
               decode steps under olm16 (launches == passes x 9: the
               experts are plain matmuls, as in the reference), finite
               logits, and a finite, positive aux loss from forward; the
               assignments the expert capacity dropped are printed;
 10. tune    - the autotuner: `tuning.tune` under olm16 at the ten serve
               GEMM shapes into a temporary cache (every candidate plan
               timed and held bit-identical to the heuristic's), then
               SERVE's workload again under dot_tiling="auto" on that
               cache (the serve phase's olm16 tokens, launches == passes
               x 169, tuner misses 0 and hits == GEMMs), and the committed
               results/tuning_torch.json against this run's winners;
 11. crossattn - Llama-3.2-Vision-11B (its depth cut to 10 of 40 layers,
               2 of them cross-attention) and SeamlessM4T-medium (cut to 6
               of 12 encoder and 6 of 12 xdec layers) at full published
               width under olm16, frontend embeddings
               N(0, 1) from the seed: a 2 x 12 prefill and 3 decode steps
               with its memory, and forward over 12 and 15 tokens (the
               prefill bit-identical to forward's last position, each
               decode within 3e-2 of forward, launches == GEMMs), each
               call's wall and K1's share of it. K1 is also checked and
               timed at their new GEMM shapes (the 2048-row cross K/V and
               encoder GEMMs on their first and last 64 rows).

 12. train   - InternLM2-1.8B at full published width and depth trained
               on one synthetic batch (4 x 128) for 12 steps (f32 masters,
               bf16 compute, remat="block"; gate: the loss down by more
               than 0.05, every grad_norm finite), each step's wall,
               tokens/s and the peak memory, the forward and backward's
               peak with and without remat; microbatches=2 against 1 from
               the same state (params within 5e-3); one step with
               compressed gradients (the error state allocated, finite);
               2 steps under olm16 and 2 under tpmm16 at 2 x 32 (K1, then
               K5, launches == steps x (169 forward GEMMs + 144 recomputed
               by remat: checkpoint stops before each layer's last GEMM,
               whose output the backward does not need), every gradient
               zero, every param bit-equal to
               the decay-only update, the kernel's share of the wall);
               then the train CLI on Mamba2-130M at full width (batch 8,
               seq 256): 30 steps with checkpoints every 10 (the loss
               improves), then, its step-30 checkpoint removed, a resume
               to 30 (at step 20, the restored state bit-equal to the
               saved one, the stream's batch 20, steps 20-29 within 1e-3
               of the straight run's losses).
 13. shard   - the sharded path over two ranks that share the one card
               (NCCL refuses two ranks on one device): two processes,
               both on cuda:0, in one gloo group on 127.0.0.1, spawned
               once for this phase and the next (each runs this phase's
               parts, then the tp phase's), on ("data", "model") meshes;
               the single-device results they are held against come
               from this process while they start.
               (a) olm_matmul_sharded at InternLM2-1.8B's wq, wg, wd and
               head at M = 64 under olm16, and wq under olm32t16, each
               partitioned m, n and k over the (1, 2) mesh: m and n
               bit-identical to one device's K1, k within
               olm_error_bound, one K1 launch a call on each rank;
               (b) SERVE's workload at InternLM2-1.8B's full width and
               depth under olm16 through ServeEngine(engine=EngineSpec(
               shard="n"), mesh=) on (1, 2): the serve phase's tokens,
               K1 launches per rank == GEMMs issued, each rank's wall,
               busy share and peak memory; (c) the sharded train step on
               InternLM2-1.8B at full width with its depth cut to 4
               layers (two train states share the card), native, 3 steps
               of 4 x 128: on (1, 2) every param bit-equal to one
               device's, on (2, 1) within 5e-3 and each step's loss,
               grad_norm and the update's norm within SHARD_DATA_LIMITS
               of one device's (relative); one olm16 step with
               shard="n" (K1 launches per rank == GEMMs run, every
               gradient zero); the params saved on (2, 1) restored onto
               (1, 2) with the same bits; (d) the partitioned train step
               (jit_train_step, each rank its blocks of the f32 state
               drawn by init_train_state(sharder=)): (d1) InternLM2-1.8B
               as published on (1, 2), 3 native steps of the train
               phase's batch, each rank's state the specs' bytes, its
               peak at most SHARD_TP_PEAK of the train phase's, each
               step's loss and grad_norm and the update's norm within
               SHARD_TP_LIMITS of the train phase's first 3 steps; (d2)
               one olm16 step of (c)'s cut (K1 launches per rank ==
               GEMMs, layer 0's wq columns bit-equal to one device's K1,
               every gradient zero, the params the decay-only update's);
               (d3) Llama-3.2-Vision-11B's first pattern group at full
               width under fsdp_tp on (2, 1), remat "none", patches from
               the seed, 2 steps within SHARD_DATA_LIMITS of one device's;
               (d4) one native step of (d2)'s cut against its walk on a
               fake 2-rank world (FLOPs equal, peak within 5%);
  13b. tp    - the partitioned serve steps (jit_prefill_step /
               jit_decode_step: each rank holds its blocks of the bf16
               serve params at the Sharder's specs, drawn leaf by leaf by
               init_serve_params, and its block of the KV cache) on the
               shard phase's two ranks, a (1, 2) mesh,
               SERVE's prompts right-padded, 6 new tokens greedy:
               (a) InternLM2-1.8B as published under olm16 (K1 launches
               per rank == GEMMs issued; layer 0's wq input equal to one
               device's and its columns of the output bit-equal to one
               device's K1; the head's local logits bit-equal to K1 on
               the whole table's columns) and native bf16, the first
               prefill's logits within 3e-2 of one device's largest
               |logit|, equal tokens counted; (b) Yi-34B as published
               (60 layers, 68.8 GB of bf16 weights, which two whole
               copies would not fit) native: each rank's resident blocks
               equal to the specs' byte count, its logits within 3e-2 of
               one device's (the same init at one rank), max memory per
               rank; (c) one partitioned InternLM2 decode walked on meta
               over a fake 2-rank world (launch/dryrun.py): FLOPs equal to
               each rank's FlopCounterMode count, peak within 5% of its
               max_memory_allocated(); (d) InternLM2 at full width with
               15 query heads, one KV head and 2 layers, so the cache
               splits over its length and the heads do not divide the
               ranks, native, within 3e-2; (e) Mixtral-8x22B (experts
               split by d_ff) and Qwen3-MoE-235B-A22B (split by expert)
               at full width, 2 layers, under olm16: resident blocks
               equal to the specs' bytes, the init's peak at most the
               blocks and one whole f32 leaf, K1 launches == GEMMs, layer
               0's wq and the head's columns bit-equal to one device's
               K1, logits within 3e-2 of one device's (in rank 0's
               process after the ranks' parts), every rank's dispatch plans
               identical; (f) Mixtral at full width, 2 layers, one KV
               head and a window of 16, so the ring splits over its
               length, 20-token prompts that wrap it, native, within
               3e-2; (g) one partitioned decode of (e)'s Qwen3-MoE cut
               walked against each rank's step, as (c); (h)
               RecurrentGemma-9B as published (38 layers, the RG-LRU's
               w channels, state and conv over `model`, wo row-parallel)
               native: resident blocks equal to the specs' bytes, the
               init's peak at most the blocks and one whole f32 leaf,
               logits within 3e-2 of one device's (in this process, before
               the ranks); (i) RecurrentGemma at full width cut to one
               (rec, rec, attn) group under olm16: K1 launches == GEMMs,
               layer 0's wx and the head's columns bit-equal to one
               device's K1, logits within 3e-2; (j) Mamba2-130M as
               published under olm16, its weights whole on every rank and
               the batch over both axes (2 of the 4 rows a rank): K1 49
               launches a pass, each rank's logit rows within 3e-2 of one
               device's rows (bit-equality printed); (k) one partitioned
               decode of (h)'s arch walked as (c); (l) F10: (e)'s
               Qwen3-MoE cut served a second time, partitioned and on one
               device, every pass's logits bit-equal to the first serve's
               and the same tokens; (m) Llama-3.2-Vision-11B as published
               (40 layers, 8 cross layers, patches (4, 1024, 4096) from
               the seed) native: resident blocks equal to the specs'
               bytes, the init's peak at most the blocks and one whole f32
               leaf, logits within 3e-2 of one device's, equal tokens
               counted; (n) its first pattern group (4 attn + 1 cross)
               cut from the same blocks under olm16: K1 launches == GEMMs
               (36 a pass), layer 0's wq, the cross layer's wk (4 x 1024
               rows of memory) and the head's columns bit-equal to one
               device's K1; (o) SeamlessM4T-medium as published (12
               encoder + 12 xdec layers, frames (4, 1024, 1024)) native,
               and cut to 2 + 2 layers under olm16 (K1 33 a prefill, 21 a
               decode; the first encoder wq's columns bit-equal to one
               device's K1), within 3e-2; (p) one partitioned decode of
               (n)'s cut with its memory walked as (c);
  14. examples - the port's four examples (examples/*_torch.py) on the
               card at their documented settings, imported and run in
               this process: the quickstart, the numerics walk-through
               (K5 at tpmm8/16/24, K1 against its plain version, an olm16
               MLP and a tpmm16 smoke model), the batched serve under
               paged and contiguous KV, and the Mamba2-130M train twin at
               8 x 256 for 20 steps at lr 3e-3, whose loss must improve;
               the kernels' launches counted for the path;
  15. dryrun  - the dry run (launch/dryrun.py), which walks one rank's
               step on meta tensors: (a) held against the card on a
               one-rank mesh for the train phase's configuration
               (InternLM2-1.8B as published, 4 x 128, f32 masters, remat
               "block") and a prefill (4 x 128) and a decode step of it
               with bf16 serve params: the walk's dot FLOPs equal to
               FlopCounterMode's over the card's step, its peak live bytes
               within 5% of torch.cuda.max_memory_allocated(), its
               roofline bound at most 1.05 x the card's synchronized wall;
               (b) production cells over a fake world of 256 or 512
               ranks, in subprocesses on the host's CPU started with the
               check phase (InternLM2-1.8B train_4k on 16 x 16 and 2 x 16
               x 16, Mixtral-8x22B decode_32k, Mamba2-130M long_500k),
               each record's line printed. No kernel runs: the dry run
               runs the native GEMMs.

Each phase's wall is printed on a line of its own ("[wall] phase
<phase>: <s> s"), and each of its parts' before it ("[wall] part <phase>
<part>: <s> s"; a rank's parts as "[wall] part <phase> rank <r> <part>: <s>
s", each rank's own walls, sent back with its results); after the last
phase their sum, and the sum as a share of SMOKE_BUDGET_S.
The line before the last is a JSON object with one entry per kernel; the
last line is {"ok": true, "device": {...}}. Any failure exits non-zero
and prints no result; so does a machine without a CUDA card, and a
directory holding this script without the rest of the repository.
"""
from __future__ import annotations

import concurrent.futures
import contextlib
import dataclasses
import gc
import importlib.util
import io
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# The seconds a run of the script may spend in its phases, the build
# included: their sum is printed against it after the last phase, as a
# share.
SMOKE_BUDGET_S = 1000

HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory
INT8_OPS_PER_S = 1.979e15          # H100 SXM int8 tensor cores, dense
# Integer operations an SM can retire per clock: its 4 schedulers issue
# one 32-thread instruction each (the same 128 lanes the guide's 67 TFLOP/s
# float32 peak counts). The integer ALU pipe (LOP3, SHF, ISETP, SEL) takes
# only 64 lanes a clock, but IMAD issues to the FMA pipe, so a mix of the
# two issues up to 128: the issue rate is the bound (PERF.md).
INT_OPS_PER_SM_CLOCK = 128
RAGGED = (5, 70, 37)               # (M, K, N)
DECODE_GEMV = (4, 2048, 8192)      # an MLP up-projection at decode
PREFILL_GEMM = (64, 2048, 2048)    # a q/o projection of the 4 x 16 prefill
# K1/K2's edges: K of one lane, a two-level tree, a short tile, one and 17
# lanes past a tile; M on both sides of the 4- and 8-row blocks with N not a
# power of two; one row and three columns of a long K (blocks of more than
# 32 K tiles); each at olm16, olm24 (the 32-bit stream's limit) and olm32
# (64-bit streams)
K12_EDGES = (tuple((5, K, 37) for K in (1, 3, 15, 17, 33))
             + tuple((M, 70, 1003) for M in (1, 5, 17)) + ((1, 8192, 3),))
K12_EDGE_MODES = ("olm16", "olm24", "olm32")
# Every weight-bearing GEMM shape of the serve path: (K, N) of q/o, k/v,
# gate/up, down and the LM head, at the 4-lane decode and the 64-row prefill.
# K1, K2 and K5 are checked at each: K1/K2's launch plan differs by shape.
SERVE_KN = ((2048, 8192), (2048, 2048), (2048, 1024), (8192, 2048),
            (2048, 92544))
SERVE_SHAPES = tuple((M, K, N) for M in (4, 64) for K, N in SERVE_KN)
# Outputs of one call of the plain olm_matmul_ref in K1/K2's checks: wider
# GEMMs are checked against it a slice of columns at a time (an output's
# bits depend on its own column of w alone), to bound its int64
# temporaries at the 64-row LM head.
PLAIN_OUTPUTS = 1 << 17
# The time phase times the plain olm16 version (a warm-up call and a timed
# one) beside K1 where its M x K x N is at most this, about 0.6 s a call on
# the H100, and beside K1 and K2 at DECODE_GEMV and PREFILL_GEMM.
PLAIN_TIMED_WORK = 4 * 4096 * 8192
# K5's edges: M on both sides of the 16-row decode tile, K of 1, 31 and 33
# bytes (not whole 16-byte copies) and one long enough to split, N not a
# multiple of 8; and A planes starting at an odd address.
TPMM_EDGES = ((1, 2048, 1003), (16, 2048, 1003), (17, 2048, 1003),
              (4, 1, 37), (4, 31, 37), (4, 33, 37), (4, 8192, 1003),
              (17, 8192, 1003))
TPMM_ODD = (5, 2048, 1003)
TPMM_MODES = ("nbit", "full", "eq8")
MUL_B = 1 << 20
MUL_CASES = ((8, True), (16, True), (24, True), (32, True), (8, False),
             (16, False), (24, False))
DOT_B = 4096
DOT_CASES = tuple((K, n) for K in (16, 64, 256) for n in (8, 16, 32))
# K3's edges: a ragged B (a part-filled last group, persistent blocks with
# a group fewer than others), K of one lane, an odd tree, one lane past a
# power of two and the most lanes, an odd n (4-byte copies, a row stride
# that does not divide 32), full working precision, and operands at a
# 4-byte offset (4-byte copies at n = 16). (B, K, n, truncated)
DOT_RAGGED_B = DOT_B - 37
DOT_EDGES = (tuple((DOT_RAGGED_B, K, n, True) for K in (1, 3, 33, 1024)
                   for n in (8, 13, 16, 32))
             + ((DOT_RAGGED_B, 256, 16, False), (DOT_RAGGED_B, 33, 16, False)))
DOT_OFFSET = (1000, 33, 16)
# Configurations past the unrolled K3/K4 (another online delay or estimate
# width, full working precision at another delay, n past 32, a negative
# delay, an estimate wider than the datapath, the int64 lane) and K3 past
# 1024 lanes (streams of 64 and 128 bits): the public online_mul /
# online_dot must send each to a kernel (one launch) with the plain
# version's digits. (K, OnlinePrecision keywords); K4 takes the keywords
# alone at GENERAL_MUL_B rows.
GENERAL_CONFIGS = (dict(n=16, delta=4), dict(n=16, t=3),
                   dict(n=16, delta=2, t=1),
                   dict(n=16, delta=4, truncated=False, tail_gating=False),
                   dict(n=8, delta=0), dict(n=36), dict(n=8, delta=-1),
                   dict(n=2, delta=0, t=5, truncated=False), dict(n=5, t=8),
                   dict(n=24, t=1))
GENERAL_MUL_B = (1 << 16) + 37
GENERAL_DOT = (tuple((K, kw) for K in (33, 2048) for kw in GENERAL_CONFIGS)
               + tuple((K, dict(n=16)) for K in (300, 1025, 2048, 5000))
               + ((1500, dict(n=32)), ((1 << 16) + 1, dict(n=32))))
# A configuration no kernel holds (the residual's bound leaves int64): a
# CUDA operand must raise before any launch.
UNHELD = dict(n=36, delta=1)
# F6: the selection condition holds but the residual leaves int32 (the
# first two) or the overflow prover cannot show it stays there (the
# third): the general kernels run them in int64 lanes, which must give the
# plain version's digits over at least 2^16 lanes (K4 at GENERAL_MUL_B
# rows, K3 at F6_DOT's B x K); (32, 2, 5)'s bound leaves int64 too, so no
# kernel holds it and a CUDA operand must raise before any launch.
F6_CONFIGS = (dict(n=24, delta=2, t=4), dict(n=28, delta=2, t=4),
              dict(n=24, delta=3, t=4))
F6_DOT = (256, dict(n=24, delta=2, t=4), 256)      # (K, keywords, B)
F6_UNHELD = dict(n=32, delta=2, t=5)
# F7: K1/K2 at more row blocks (of 8 rows) than grid y holds, 65,535: the
# rows past it run in grid z. Checked on TALL_ROWS rows at both ends and
# across the boundary.
TALL = (65535 * 8 + 37, 16, 3)                     # (M, K, N)
TALL_ROWS = 64
GENERAL_DOT_B = 61
# one time each: K4 at delay 4 and in the int64 lane, K3 at delay 4 and
# K3 past 1024 lanes
GENERAL_TIMED = ((None, dict(n=16, delta=4), MUL_B),
                 (None, dict(n=24, t=1), MUL_B),          # the int64 lane
                 (None, dict(n=24, delta=2, t=4), MUL_B),  # F6, int64
                 (256, dict(n=16, delta=4), DOT_B),
                 (256, dict(n=24, delta=2, t=4), DOT_B),   # F6, int64
                 (2048, dict(n=16), 512))
# K3 at the paper's configuration past 1024 lanes a row (each row cut into
# aligned subtrees of 1024 lanes, the reference tree's level-10 nodes,
# merged by the row's last block): timed at InternLM2-1.8B's d_model (2048)
# and d_ff (8192) lanes a row at n 16 and 32, (B, K, n); held bit for bit
# against the plain version at a ragged LONG_B rows with K of one whole
# tree, one lane past it, and 4 and 8 subtrees
LONG_TIMED = tuple((B, K, n) for B, K in ((512, 2048), (128, 8192))
                   for n in (16, 32))
LONG_B = 131
LONG_CHECKS = tuple((LONG_B, K, n) for K in (1024, 1025, 4096, 8192)
                    for n in (16, 32))
# The examples phase: each twin with its arguments (the train twin cut to
# 20 steps at the train phase's CLI learning rate).
EXAMPLES = (("quickstart_torch", []), ("online_numerics_matmul_torch", []),
            ("serve_batched_torch", []),
            ("train_lm_torch", ["--steps", "20", "--lr", "3e-3"]))
# The dryrun phase. (a) The walk (launch/dryrun.py) held against the card
# on a one-rank mesh: the train phase's configuration (InternLM2-1.8B as
# published, f32 masters, remat "block", one 4 x 128 batch) and a prefill
# and a decode step of it with bf16 serve params at that batch and a
# 128-slot cache. The walk's FLOPs must equal FlopCounterMode's over the
# card's step, its peak be within DRYRUN_PEAK_TOL of the card's, and its
# roofline bound be at most DRYRUN_BOUND_SLACK x the card's wall. (b) The
# dry run's production cells, each command in a subprocess of its own (the
# smoke process never holds a fake default group), all at once on the
# host's CPU from the check phase on, while the card runs the earlier
# phases.
DRYRUN_CARD = (("train", 4, 128), ("prefill", 4, 128), ("decode", 4, 128))
DRYRUN_PEAK_TOL, DRYRUN_BOUND_SLACK = 0.05, 1.05
DRYRUN_CELLS = (("internlm2_1_8b", "train_4k", "--both-meshes"),
                ("mixtral_8x22b", "decode_32k"),
                ("mamba2_130m", "long_500k"))
# The rest of the dense family. K1 at ChatGLM3-6B's weight-bearing (K, N):
# q/o, k/v (2 KV heads of 128), gate/up, down and the 65024-wide head; at
# Yi-34B's and Qwen1.5-110B's k/v, down and heads. At M = 4 ChatGLM3's
# outputs are held whole, elsewhere the first and the last K1_SLICE
# columns of each (an output's bits depend on its own column of w alone).
CHATGLM_KN = ((4096, 4096), (4096, 256), (4096, 13696), (13696, 4096),
              (4096, 65024))
CUT_KN = ((7168, 1024), (20480, 7168), (7168, 64000), (8192, 1024),
          (49152, 8192), (8192, 152064))
K1_SLICE = 2048
# The recurrent and MoE families: K1 at every weight-bearing (K, N) that
# their eng.dot GEMMs give it (the MoE experts, the RG-LRU gates wa/wi and
# the SSD contractions are plain matmuls, as in the reference). M = 4 is a
# decode; RecurrentGemma also at M = 7, a ragged exact-length prefill
# (K1's 64-row prefill is held at the serve shapes). Outputs are held whole up to WHOLE_N columns at M of 4 and 7,
# elsewhere on their first and last K1_SLICE columns.
FAMILY_KN = {
    "recurrentgemma_9b": ((4096, 4096), (4096, 256), (4096, 12288),
                          (12288, 4096), (4096, 256000)),
    "mamba2_130m": ((768, 3352), (1536, 768), (768, 50280)),
    "mixtral_8x22b": ((6144, 6144), (6144, 1024), (6144, 32768)),
    "qwen3_moe_235b_a22b": ((4096, 4096), (4096, 256), (4096, 151936)),
}
RG_ROWS = (7,)
WHOLE_N = 32768
# The enc-dec and VLM families: K1 at the eng.dot (K, N) their GEMMs give
# it that no earlier family did, at a 4-lane decode (heads wider than
# WHOLE_N on their first and last K1_SLICE columns) and, for the cross
# K/V over 1024 patch tokens a lane and the encoder over 1024 frames a
# lane, at M = ENC_ROWS, checked on its first and last ENC_CHECK_ROWS
# rows (an output row's bits depend on its own row of x alone).
CROSS_KN = {
    "llama_3_2_vision_11b": ((4096, 1024), (4096, 14336), (14336, 4096),
                             (4096, 128256)),
    "seamless_m4t_medium": ((1024, 1024), (1024, 4096), (4096, 1024),
                            (1024, 256256)),
}
CROSS_ROWS_KN = {"llama_3_2_vision_11b": ((4096, 1024),),
                 "seamless_m4t_medium": ((1024, 1024), (1024, 4096),
                                         (4096, 1024))}
ENC_ROWS, ENC_CHECK_ROWS = 2048, 64
# The paper's scalar model as K3's and K4's oracle: (B, K, n) and (B, n)
ORACLE_DOT = (64, 256, 16)
ORACLE_MUL = (256, 16)
# The dense phase: ChatGLM3-6B at its full published width and depth
# served like SERVE, forward and lm_loss on one (1, FORWARD_LEN) batch, a
# native forward at (1, FLASH_LEN) (S * T past FLASH_MIN_ELEMS, so the
# flash path runs); Yi-34B and Qwen1.5-110B at full width with their depth
# cut to fit the card (f32 weights of 137.6 and 444.8 GB at full depth).
DENSE_ARCH = "chatglm3_6b"
FORWARD_LEN = 32
FLASH_LEN = 1024
CUT_DEPTH = (("yi_34b", 2), ("qwen1_5_110b", 1))
SERVE = dict(arch="internlm2_1_8b", modes=("olm16", "tpmm16"), requests=4,
             prompt=(4, 12), max_new=6, slots=4, max_len=128, block=16,
             seed=0)
SERVE_LAYERS = None                # None = the full published depth
# The families phase: RecurrentGemma-9B and Mamba2-130M at full width and
# depth served like SERVE under olm16; a prefill of RING_PROMPT tokens into
# a RING_MAX_LEN cache (past RecurrentGemma's 2048-token window, so every
# attention ring rolls) and RING_DECODES decode steps under native against
# forward; a MAMBA_PROMPT-token prefill and one decode against forward;
# Mixtral-8x22B and Qwen3-MoE-235B-A22B at full width with their depth cut
# (f32 weights of 562.5 and 927.0 GB at full depth).
RING_PROMPT, RING_MAX_LEN, RING_DECODES = 2100, 2304, 4
# RecurrentGemma-9B's depth here: 4 of its 12 (rec, rec, attn) groups and
# the (rec, rec) remainder of its 38 layers (depth cut: every layer kind,
# the remainder, 4 windowed rings that roll; the tp phase's (h) runs all
# 38 layers)
FAMILY_RG_LAYERS = 14
MAMBA_PROMPT = 31
MOE_DEPTH = (("mixtral_8x22b", 2), ("qwen3_moe_235b_a22b", 2))
# The crossattn phase: Llama-3.2-Vision-11B and SeamlessM4T-medium at full
# published width and depth under olm16, CROSS_LANES lanes with frontend
# embeddings N(0, 1) from the seed: a CROSS_PROMPT-token prefill, then
# CROSS_DECODES decode steps with the memory prefill returned, against
# forward over the prompt and over all CROSS_PROMPT + CROSS_DECODES tokens.
CROSS_ARCHS = ("llama_3_2_vision_11b", "seamless_m4t_medium")
CROSS_LANES, CROSS_PROMPT, CROSS_DECODES = 2, 12, 3
# their depth here (depth cut: Llama-3.2-Vision's first 2 of 8 (4 attn,
# cross) groups, Seamless's first 6 of 12 encoder and of 12 xdec layers;
# every layer kind, the memory's cross K/V at full width; the tp phase's
# (m) and (o) run them as published)
CROSS_DEPTH = {"llama_3_2_vision_11b": dict(n_layers=10),
               "seamless_m4t_medium": dict(n_layers=6, n_enc_layers=6)}
# The train phase: InternLM2-1.8B at full width and depth, f32 masters,
# bf16 compute, remat="block", overfitting one synthetic batch with the
# reference test's optimizer settings (tests/test_distributed_train.py:
# lr 3e-3, schedule_total 30, 12 steps); then 2 steps under each digit
# mode at M = 64 rows per GEMM
TRAIN = dict(arch="internlm2_1_8b", seed=0, batch=(4, 128), lr=3e-3,
             total=30, steps=12, kernel_batch=(2, 32), kernel_steps=2)
# and the train CLI at the reference example's settings
# (examples/train_lm.py: batch 8, seq 256)
CLI = dict(arch="mamba2_130m", batch=8, seq=256, lr=3e-3)
# The replay phase: benchmarks/run.py::serve_faults_bench's engine with
# its ladder's rungs replaced by olm16 ones, and its seed-0 workload and
# fault plan. vocab=512 keeps the baseline's arrival schedule and prompt
# lengths (and ids below 512 are tokens of the 92544-token vocabulary).
REPLAY_ENGINE = dict(slots=4, max_len=64, kv_layout="paged", kv_block_size=8,
                     kv_blocks=21, max_queue=8, preempt=True,
                     numerics_check=True, integrity_audit=True,
                     degrade_ladder=["olm16", "olm16t12", "olm16t10"])
REPLAY_WORKLOAD = dict(seed=0, n_requests=20, mean_interarrival_steps=2.0,
                       prompt_len_range=(4, 16), max_new_range=(4, 10),
                       vocab=512, deadline_every=6, deadline_steps=30,
                       priority_levels=2)
# Chunks of 8 tokens: the workload's prompts are 4-16 tokens, and a
# prompt is chunked only where it is longer than a chunk.
REPLAY_CHUNK = 8
REPLAY_REASONS = {"eos", "length", "max_len", "cache_full", "deadline",
                  "rejected", "numerics", "failed"}
# The shard phase: two ranks on the one card. InternLM2-1.8B's (K, N) of
# wq, wg, wd and the head at SHARD_ROWS rows under olm16 (and wq under
# olm32t16), each partitioned m, n and k over the (1, 2) mesh; the train
# half at full width with the depth cut to SHARD_TRAIN_LAYERS (a sharded
# and a whole train state on the card at once).
SHARD_RANKS, SHARD_ROWS = 2, 64
SHARD_GEMMS = (((2048, 2048), "olm16"), ((2048, 8192), "olm16"),
               ((8192, 2048), "olm16"), ((2048, 92544), "olm16"),
               ((2048, 2048), "olm32t16"))
SHARD_TRAIN_LAYERS, SHARD_TRAIN_STEPS = 4, 3
# (c) on (2, 1): each step's loss and grad_norm, and the update's norm,
# relative to one device's. The sound step read 2.6e-5, 1.1e-4 and 6.9e-3
# on the H100 (the bf16 GEMMs of 256 rows and of 512 differ in their last
# bits); a skipped sum over "data" 4.3e-3, 0.32 and 0.80, both ranks on
# one rank's rows 6.8e-3, 0.44 and 0.80, a missing divide 2.6e-5, 1.0 and
# 6.9e-3 (probes/sharded_train_faults.py)
SHARD_DATA_LIMITS = {"loss": 2.5e-4, "grad_norm": 1e-3, "update": 5e-2}
# (d) the partitioned train step (distributed/train.py's jit_train_step:
# each rank its blocks of the f32 state, the layers' collectives carrying
# a backward) on the same two ranks: (d1) TRAIN's arch as published on
# (1, 2), native, TRAIN's seed, batch, lr and schedule, SHARD_TP_STEPS
# steps on the train phase's one batch, held within SHARD_TP_LIMITS of
# the train phase's first SHARD_TP_STEPS steps, its state a rank the
# specs' bytes, its peak at most SHARD_TP_PEAK of the train phase's (a
# rank holding whole bf16 params and whole f32 gradients would read about
# 70%); (d2) (c)'s cut, one olm16 step at TRAIN["kernel_batch"] on (1, 2);
# (d3) SHARD_VLM (Llama-3.2-Vision-11B's first pattern group, 4 attn + 1
# cross) at full width under fsdp_tp on (2, 1), patches (4, 1024, 4096)
# from the seed, SHARD_VLM["steps"] steps held to one device's in this
# process;
# (d4) one native step of (d2)'s cut at TRAIN["batch"] walked on meta over
# a fake world of two ranks against each rank's step on the card (FLOPs
# equal, peak within SHARD_WALK_TOL).
SHARD_TP_STEPS = 3
SHARD_TP_PEAK = 0.6
# (d1)'s limits: SHARD_DATA_LIMITS but for grad_norm. The row-parallel sums
# and the Megatron pair's f32 gradient sums round bf16 otherwise than one
# device's GEMMs do, and over 24 layers two sound bf16 steps part: the
# H100 read 1.87e-3 and, in another run of the same code, 7.5e-4 on the
# second update's grad_norm (the first update amplifies last-bit
# differences; loss 1.30e-4 and 1.35e-4, update 3.2e-5 and 2.1e-5), and on
# the CPU at smoke width the partitioned and the one-device bf16 steps
# read up to 1.43e-3 apart while each sat 0.05-0.26% from the f32 step's
# grad_norm (at f32 they agree to 3e-7). A sum over `model` left out or a
# `data` reduce-scatter sliced moves grad_norm by 0.29-0.42
# (probes/tp_train_faults.py).
SHARD_TP_LIMITS = {**SHARD_DATA_LIMITS, "grad_norm": 5e-3}
# (d3)'s steps move every weight through gloo, which stages each
# collective through the host (~1 GB/s): a step's bf16 gathers over `data`
# and its f32 reduce-scatters, about 12 GB with remat "block", which
# gathers each layer's weights again in the backward. Remat "none" gathers
# them once (its peak a rank is remat "block"'s on the H100, 28.2 GB: it
# sits in AdamW); 2 steps hold an update's effect on the second step's
# loss and grad_norm and on the update's norm.
SHARD_VLM = dict(arch="llama_3_2_vision_11b", n_layers=5, remat="none",
                 steps=2)
SHARD_WALK_TOL = 0.05
# The tp phase: the partitioned serve steps (distributed/train.py's
# jit_prefill_step / jit_decode_step) on TP_RANKS ranks that share the card
# in a gloo group, a (data 1, model 2) mesh, bf16 serve params drawn by
# init_serve_params (no whole model on a rank). SERVE's four prompts
# right-padded into one batch, TP["new"] tokens each, greedy. (a) The
# serve arch as published under olm16 and native; (b) TP["big"] (Yi-34B,
# 68.8 GB of bf16 weights: two whole copies do not fit the card) as
# published, native; (c) one partitioned decode of (a)'s arch at
# TP_DECODE walked on meta over a fake world of TP_RANKS ranks against
# each rank's step on the card; (d) (a)'s arch at full width with
# TP_CUT's heads and depth, whose KV cache splits over its length and
# whose query heads do not divide `model`, native; (e) MOE_DEPTH's MoE
# cuts at full width under olm16; (f) TP_RING's ring split over its
# length, native; (g) one partitioned decode of (e)'s Qwen3-MoE cut at
# TP_DECODE walked as (c); (h) TP["rec"] (RecurrentGemma-9B, the RG-LRU's
# channels over `model`) as published, native; (i) TP["rec"] at full
# width cut to TP_REC_CUT, one (rec, rec, attn) group, under olm16; (j)
# TP["ssm"] (Mamba2-130M: the weights whole on every rank, the batch over
# both axes) as published under olm16; (k) one partitioned decode of
# (h)'s arch at TP_DECODE walked as (c); (l) F10: TP_F10's cut from (e)
# served twice, partitioned and on one device, with the same bits each
# time; (m) TP["vlm"] (Llama-3.2-Vision-11B) as published, native, on
# patches from the seed (`tp_front`); (n) its TP_VLM_CUT (one pattern
# group) cut from the same blocks under olm16; (o) TP["encdec"]
# (SeamlessM4T-medium) as published, native, and its TP_ENCDEC_CUT under
# olm16; (p) one partitioned decode of (n)'s cut, with its memory, at
# TP_DECODE walked as (c). Logits within TP_LOGIT_TOL of the single
# device's largest |logit| over the real vocabulary (the repo's
# flash-attention gate).
TP_RANKS = 2
TP = dict(arch="internlm2_1_8b", big="yi_34b", rec="recurrentgemma_9b",
          ssm="mamba2_130m", vlm="llama_3_2_vision_11b",
          encdec="seamless_m4t_medium", max_len=32, new=6, seed=0)
TP_VLM_CUT = dict(n_layers=5)
TP_ENCDEC_CUT = dict(n_layers=2, n_enc_layers=2)
TP_REC_CUT = dict(n_layers=3)
TP_F10 = "qwen3_moe_235b_a22b"
TP_DECODE = ("decode", 4, 32)      # (kind, batch, cache slots)
TP_CUT = dict(n_layers=2, n_heads=15, n_kv_heads=1, head_dim=128)
TP_LOGIT_TOL = 3e-2
# (f): Mixtral at full width with one KV head and a window of 16, so the
# ring splits over its length on the two ranks (8 slots a rank); prompts
# of TP_RING_LEN tokens, longer than the ring, and TP["new"] tokens each
TP_RING = dict(n_layers=2, n_kv_heads=1, sliding_window=16)
TP_RING_LEN = 20
# each process of the phase that holds a big model allocates with
# segments that grow in place
TP_ALLOC = "expandable_segments:True"


class Laps:
    """The walls of a process's parts, in order: each call closes the
    running part and opens `name` (none where it is None). `rows` holds
    (part, seconds); `say(part, seconds)`, where given, prints each part
    as it closes."""

    def __init__(self, say=None):
        self.rows, self.say, self._open = [], say, None

    def __call__(self, name=None) -> None:
        now = time.monotonic()
        if self._open is not None:
            done, t0 = self._open
            self.rows.append((done, now - t0))
            if self.say is not None:
                self.say(done, now - t0)
        self._open = None if name is None else (name, now)


def free_card() -> None:
    """Give back every block of the card that nothing holds any more."""
    import torch
    gc.collect()
    torch.cuda.empty_cache()


def print_laps(phase: str, who: str, rows) -> None:
    """A child process's part walls as the parent's [wall] part lines."""
    for name, s in rows:
        print(f"[wall] part {phase} {who} {name}: {s:.1f} s", flush=True)


def tp_one(tmp: str, laps) -> None:
    """(b)'s single device, in rank 0's process before the ranks' parts
    (segments that grow in place: the smoke's own process, after its
    phases, holds segments that no longer leave the weights in one piece):
    TP["big"] whole in bf16 (the sharded init at one rank), served like
    the ranks; its first logits, tokens, init wall and peak to
    tmp/one.pt."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.distributed.train import init_serve_params
    from repro_torch.models.model import Model
    dev = torch.device("cuda", 0)
    big = get_config(TP["big"])
    laps("(b) one device, draw")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    params = init_serve_params(Model(big, device=dev), None, TP["seed"])
    torch.cuda.synchronize()
    init_s = time.monotonic() - t0
    laps("(b) one device, serve")
    first, tokens, passes, wall = tp_whole_serve(
        big, params, "native", tp_prompts(big.vocab_size), dev)
    torch.save(dict(first=first.cpu(), tokens=tokens, passes=passes,
                    wall=wall, init_s=init_s,
                    peak=torch.cuda.max_memory_allocated()),
               os.path.join(tmp, "one.pt"))
    del params, first
    free_card()


def gemms_per_pass(cfg, encoder: bool = False) -> int:
    """The eng.dot GEMMs of one forward pass of `cfg`: an attention layer
    issues q, k, v, o and its MLP's (none for a MoE layer: the experts
    are plain matmuls), a cross-attention layer the same, an xdec layer
    both attentions' and its MLP's, a recurrent layer wx, wy, wo and its
    MLP's, an SSD layer win and wout, and the LM head one; with `encoder`,
    also the encoder's layers (4 and a GELU MLP's 2 each), which a pass
    that takes frames runs first."""
    mlp = 3 if cfg.mlp_type == "swiglu" else 2
    per_kind = {"attn": 4 + (0 if cfg.n_experts else mlp), "cross": 4 + mlp,
                "xdec": 8 + mlp, "rec": 3 + mlp, "ssm": 2}
    return (sum(per_kind[k] for k in cfg.layer_kinds) + 1
            + (6 * cfg.n_enc_layers if encoder else 0))


def tp_cross_wk(cfg) -> int:
    """The index, within one forward pass's eng.dot GEMMs, of the first
    cross layer's wk: after each earlier "attn" layer's 7 (a SwiGLU MLP)
    and the cross layer's wq."""
    kinds = cfg.layer_kinds
    assert set(kinds[:kinds.index("cross")]) == {"attn"}
    return 7 * kinds.index("cross") + 1


def tp_cut_params(params, cut):
    """The first cut.n_layers decoder layers and cut.n_enc_layers encoder
    layers of a tree of serve params (whole or a rank's blocks), the rest
    as it is: the params of `cut` drawn from the same leaves."""
    out = dict(params, layers=params["layers"][:cut.n_layers])
    if "encoder" in params:
        out["encoder"] = dict(params["encoder"], layers=params["encoder"][
            "layers"][:cut.n_enc_layers])
    return out


def tp_prompts(vocab: int):
    """SERVE's prompts, drawn as the serve phase draws them."""
    import numpy as np
    rng = np.random.default_rng(SERVE["seed"])
    lo, hi = SERVE["prompt"]
    return [rng.integers(0, vocab, int(rng.integers(lo, hi + 1))).astype(
        np.int32) for _ in range(SERVE["requests"])]


def tp_ring_prompts(vocab: int):
    """(f)'s prompts: SERVE["requests"] of TP_RING_LEN tokens each, one
    length, so that no lane's ring holds a right-padded prompt's padding."""
    import numpy as np
    rng = np.random.default_rng(SERVE["seed"] + 1)
    return [rng.integers(0, vocab, TP_RING_LEN).astype(np.int32)
            for _ in range(SERVE["requests"])]


def rel_real(got, want, vocab: int) -> float:
    """The largest |got - want| over the largest |want|, on the `vocab`
    real columns of two logits tensors: a padded vocabulary's columns hold
    -1e9 on both sides, and a largest |want| taken over them would make
    any difference look small."""
    got, want = got[..., :vocab], want[..., :vocab]
    return float((got - want).abs().max() / want.abs().max())


def tp_front(cfg, dev):
    """(the batch key, SERVE["requests"] rows of frontend embeddings (B,
    n_frontend_tokens, d_model) f32 from the seed) of a cross-attention
    arch, None for the others."""
    import torch
    from repro_torch.distributed.train import MEMORY_KEYS
    if cfg.family not in MEMORY_KEYS:
        return None
    g = torch.Generator(device=dev).manual_seed(TP["seed"])
    return MEMORY_KEYS[cfg.family], torch.randn(
        (SERVE["requests"], cfg.n_frontend_tokens, cfg.d_model),
        generator=g, device=dev)


def tp_greedy(prefill, decode, params, cache, prompts, dev, whole,
              rows=None, every=None, front=None):
    """Greedy serve of right-padded `prompts`, TP["new"] tokens each:
    (the prefill's logits, each request's tokens, the forward passes).
    `whole` turns a step's logits into the whole vocabulary's; `rows`
    takes a batch-major tensor to the rows this rank serves (a batch
    split over `model`); `every`, a list, gets each pass's logits;
    `front` (`tp_front`) adds the frontend's embeddings to the prefill's
    batch, and each decode takes back the memory the prefill returned."""
    import torch
    lens = torch.tensor([len(p) for p in prompts], device=dev)
    toks = torch.zeros((len(prompts), max(map(len, prompts))),
                       dtype=torch.int32, device=dev)
    for i, p in enumerate(prompts):
        toks[i, :len(p)] = torch.from_numpy(p).to(dev)
    if rows is not None:
        lens, toks = rows(lens), rows(toks)
    batch = {"tokens": toks}
    if front is not None:
        key, emb = front
        batch[key] = emb if rows is None else rows(emb)
    seen = [] if every is None else every
    first, cache, memory = prefill(params, batch, cache, last_index=lens - 1)
    extra = () if memory is None else (memory,)
    seen.append(first)
    tok = whole(first).argmax(-1)
    out, pos = [tok], lens.clone()
    for _ in range(TP["new"] - 1):
        logits, cache = decode(params, tok, pos, cache, *extra)
        seen.append(logits)
        tok = whole(logits).argmax(-1)
        out.append(tok)
        pos = pos + 1
    return first, torch.stack(out, 1).tolist(), TP["new"]


def same_bits(a, b) -> bool:
    """Two lists of logits equal bit for bit, pass for pass."""
    return len(a) == len(b) and all(bits_equal(x, y) for x, y in zip(a, b))


def tp_whole_serve(cfg, params, mode, prompts, dev, every=None):
    """One device's greedy serve of `prompts` (tp_greedy) on whole params
    under `mode`: (the prefill's logits, tokens, passes, wall ending in a
    synchronize); `every` as tp_greedy's; a cross-attention arch on its
    frontend's embeddings (`tp_front`)."""
    import torch
    from repro_torch.core.numerics import DotEngine
    from repro_torch.models.model import Model
    model = Model(cfg, DotEngine(mode=mode), device=dev)
    cache = model.init_cache(len(prompts), TP["max_len"])
    torch.cuda.synchronize()
    t0 = time.monotonic()
    first, tokens, passes = tp_greedy(
        lambda p, b, c, last_index: model.prefill(p, b, c,
                                                  last_index=last_index),
        model.decode_step, params, cache, prompts, dev, lambda t: t,
        every=every, front=tp_front(cfg, dev))
    torch.cuda.synchronize()
    return first, tokens, passes, time.monotonic() - t0


@contextlib.contextmanager
def olm_calls(keep):
    """The olm_matmul calls made in the block: a list with (x, output) of
    each call whose index is in `keep`, None for the others."""
    from repro_torch.kernels.online_dot import matmul
    real, seen = matmul.olm_matmul, []

    def recorded(x, w, **kw):
        out = real(x, w, **kw)
        seen.append((x.clone(), out.clone()) if len(seen) in keep else None)
        return out

    matmul.olm_matmul = recorded
    try:
        yield seen
    finally:
        matmul.olm_matmul = real


@contextlib.contextmanager
def route_plans():
    """The dispatch plan (token per slot, each assignment's slot, its keep
    flag) of every batch row a models/moe._route_rows call routes in the
    block, on the CPU, in call and row order."""
    import torch
    from repro_torch.models import moe
    real, plans = moe._route_rows, []

    def recorded(*a, **kw):
        plan = real(*a, **kw)
        plans.extend(torch.cat([plan[0], plan[1],
                                plan[4].to(plan[0].dtype)], dim=1).cpu())
        return plan

    moe._route_rows = recorded
    try:
        yield plans
    finally:
        moe._route_rows = real


def tp_moe_one(tmp: str, laps) -> None:
    """(e)'s and (f)'s single device, in rank 0's process after the
    ranks' parts: each MoE cut whole in bf16 (the sharded init at one
    rank), served like the ranks under olm16, layer 0's wq held against
    each rank's columns and K1 on the whole head table's columns at each
    rank's head input against the rank's local logits, bit for bit, and
    TP_F10's cut served once more for (l); then (f)'s ring cut native.
    Its results to tmp/moe_one.pt."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.distributed.train import init_serve_params
    from repro_torch.kernels.online_dot.matmul import olm_matmul
    from repro_torch.models.model import Model
    dev = torch.device("cuda", 0)
    ranks = [torch.load(os.path.join(tmp, f"tp{r}.pt"))["moe"]
             for r in range(TP_RANKS)]
    out = {}
    for arch, depth in MOE_DEPTH:
        laps(f"(e) {arch} one device, draw")
        cfg = dataclasses.replace(get_config(arch), n_layers=depth)
        params = init_serve_params(Model(cfg, device=dev), None, TP["seed"])
        laps(f"(e) {arch} one device, serve")
        runs = [[]]
        with olm_calls({0}) as seen:
            first, tokens, passes, wall = tp_whole_serve(
                cfg, params, "olm16", tp_prompts(cfg.vocab_size), dev,
                every=runs[0])
        f10 = None
        if arch == TP_F10:
            # (l) the same serve again: the same bits, pass for pass
            laps(f"(l) {arch} one device, serve again")
            runs.append([])
            _, again, _, wall2 = tp_whole_serve(
                cfg, params, "olm16", tp_prompts(cfg.vocab_size), dev,
                every=runs[1])
            f10 = dict(bits=same_bits(*runs), tokens=again == tokens,
                       passes=len(runs[0]), walls=(wall, wall2))
        del runs
        laps(f"(e) {arch} one device, columns")
        x0, out0 = seen[0]
        table = params["unembed"]["table"]
        n_wq, n_head = out0.shape[1] // TP_RANKS, table.shape[0] // TP_RANKS
        bits = []
        for r, res in enumerate(ranks):
            x, o = res[arch]["wq"]
            hx, hout = res[arch]["head"]
            want = olm_matmul(hx.to(dev), table[r * n_head:(r + 1) * n_head]
                              .T.to(torch.float32), n_bits=16)
            bits.append((bits_equal(x.to(dev), x0) and bits_equal(
                o.to(dev), out0[:, r * n_wq:(r + 1) * n_wq]),
                bits_equal(hout.to(dev), want)))
        out[arch] = dict(first=first.cpu(), tokens=tokens, passes=passes,
                         wall=wall, bits=bits, n_wq=n_wq, n_head=n_head,
                         f10=f10)
        del params, table, seen, x0, out0
        free_card()
    laps("(f) one device")
    ring = dataclasses.replace(get_config("mixtral_8x22b"), **TP_RING)
    params = init_serve_params(Model(ring, device=dev), None, TP["seed"])
    first, tokens, passes, wall = tp_whole_serve(
        ring, params, "native", tp_ring_prompts(ring.vocab_size), dev)
    out["ring"] = dict(first=first.cpu(), tokens=tokens, passes=passes,
                       wall=wall)
    torch.save(out, os.path.join(tmp, "moe_one.pt"))
    del params, first
    free_card()


def tp_rank(rank: int, world: int, tmp: str, laps) -> None:
    """The tp phase's (a)-(p) on this rank's blocks (`ranks_main`), its
    results in tmp/tp<r>.pt for the parent to hold against one device;
    raises on a launch count or a byte count that is off."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.numerics import DotEngine
    from repro_torch.distributed.collectives import (all_gather_dim,
                                                     shard_dims)
    from repro_torch.distributed.partition import Partition
    from repro_torch.distributed.sharding import Sharder, path_leaves
    from repro_torch.distributed.train import (init_serve_cache,
                                               init_serve_params,
                                               jit_decode_step,
                                               jit_prefill_step,
                                               serve_block_bytes)
    from repro_torch.kernels.online_dot import matmul_kernel as k12
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_local_mesh, mesh_shape
    from repro_torch.launch.shapes import ShapeCase
    from repro_torch.models.model import Model

    dev = torch.device("cuda", 0)
    res = {}

    def say(msg):
        print(f"[tp r{rank}] {msg}", flush=True)

    mesh = make_local_mesh(1, world, device_type="cuda")

    def whole(t):
        return all_gather_dim(t, 1, mesh, "model")

    def mine(sharder):
        """This rank's rows of a batch-major tensor under the
        sharder's batch spec."""
        return lambda t: shard_dims(t, sharder.batch_spec(), mesh)

    def blocks(cfg):
        """(the sharder, this rank's serve blocks, their bytes, the
        init's wall): the resident bytes equal to the specs' count."""
        sharder = Sharder(mesh, cfg)
        sharder.set_batch(SERVE["requests"])
        torch.cuda.synchronize()
        t0 = time.monotonic()
        params = init_serve_params(Model(cfg, device=dev), sharder,
                                   TP["seed"])
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        held = sum(t.untyped_storage().nbytes()
                   for _, t in path_leaves(params))
        want = serve_block_bytes(cfg, sharder)
        if held != want:
            raise RuntimeError(f"{cfg.name}: {held} bytes of blocks "
                               f"resident, the specs give {want}")
        return sharder, params, held, wall

    def serve(cfg, sharder, params, mode, prompts, every=None):
        """Greedy serve of `prompts` (tp_greedy) through the
        partitioned steps: (the prefill's logits, tokens, passes,
        wall). Where the Sharder replicates the weights the rank
        serves its rows of the batch, every column of them."""
        model = Model(cfg, DotEngine(mode=mode), device=dev)
        cache = init_serve_cache(model, sharder, len(prompts),
                                 TP["max_len"])
        front = tp_front(cfg, dev)
        prefill = jit_prefill_step(
            model, sharder, params,
            ["tokens"] + ([] if front is None else [front[0]]), cache)
        decode = jit_decode_step(model, sharder, params, cache,
                                 has_memory=front is not None)
        if sharder.replicated:
            rows, cols = mine(sharder), (lambda t: t)
        else:
            rows, cols = None, whole
        torch.cuda.synchronize()
        t0 = time.monotonic()
        first, tokens, passes = tp_greedy(prefill, decode, params, cache,
                                          prompts, dev, cols, rows,
                                          every, front)
        torch.cuda.synchronize()
        return first.cpu(), tokens, passes, time.monotonic() - t0

    # (a) the serve arch as published, olm16 and native -------------
    laps("(a) draw")
    cfg = get_config(TP["arch"])
    prompts = tp_prompts(cfg.vocab_size)
    sharder, params, held, init_s = blocks(cfg)
    say(f"(a) {cfg.name} on {mesh_shape(mesh)}: {held} bytes of serve "
        f"blocks resident (the specs' count), drawn in {init_s:.1f} s")
    per_pass = gemms_per_pass(cfg)
    laps("(a) olm16 serve")
    with olm_calls({0, per_pass - 1}) as seen:
        k12.launches = 0
        first, tokens, passes, wall = serve(cfg, sharder, params,
                                            "olm16", prompts)
        launched = k12.launches
    res["olm16"] = dict(first=first, tokens=tokens, wall=wall,
                        wq=seen[0], head=seen[per_pass - 1],
                        launches=launched, gemms=passes * per_pass)
    say(f"(a) olm16: {passes} forward passes in {wall:.3f} s (ends in "
        f"torch.cuda.synchronize), GEMMs issued {passes * per_pass}, "
        f"K1 launches {launched}")
    if launched != passes * per_pass:
        raise RuntimeError(f"(a) K1 launched {launched} times for "
                           f"{passes * per_pass} GEMMs")
    laps("(a) native serve")
    first, tokens, passes, wall = serve(cfg, sharder, params, "native",
                                        prompts)
    res["native"] = dict(first=first, tokens=tokens, wall=wall)
    say(f"(a) native bf16: {passes} forward passes in {wall:.3f} s")
    del params
    gc.collect()
    torch.cuda.empty_cache()

    # (c) one decode step against its walk -------------------------
    laps("(c)")
    kind, B, T = TP_DECODE
    sharder.set_batch(B)
    res["card"] = dryrun.card_step(cfg, ShapeCase("tp_decode", T, B,
                                                  kind), sharder)
    say(f"(c) one partitioned decode ({B} lanes, {T} slots): FLOPs "
        f"{res['card']['flops']}, peak {res['card']['peak']} B, walls "
        f"{[round(w * 1e3, 3) for w in res['card']['walls_s']]} ms")
    gc.collect()
    torch.cuda.empty_cache()

    # (d) the cache over its length, uneven heads -------------------
    laps("(d)")
    cut = dataclasses.replace(cfg, **TP_CUT)
    sharder, params, held, _ = blocks(cut)
    first, tokens, passes, wall = serve(cut, sharder, params, "native",
                                        prompts)
    res["cut"] = dict(first=first, tokens=tokens, wall=wall)
    say(f"(d) {cut.n_heads} heads / {cut.n_kv_heads} KV head at "
        f"{cut.n_layers} layers: {passes} passes in {wall:.3f} s")
    del params
    gc.collect()
    torch.cuda.empty_cache()

    def peaked_blocks(cfg, tag):
        """blocks(cfg) with the init's peak: (the sharder, the
        blocks, their bytes, the init's wall, its peak, the largest
        whole leaf in f32). The peak is this rank's blocks and one
        whole f32 leaf being drawn, no more."""
        biggest = max(t.numel() * 4 for _, t in path_leaves(
            Model(cfg, device="meta").init(0)))
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        sharder, params, held, init_s = blocks(cfg)
        init_peak = torch.cuda.max_memory_allocated() - base
        if init_peak > held + biggest:
            raise RuntimeError(
                f"{tag} {cfg.name}: the init peaked at {init_peak} B, "
                f"past its blocks {held} B and one whole f32 leaf "
                f"{biggest} B")
        return sharder, params, held, init_s, init_peak, biggest

    # (e) the MoE archs: experts split by d_ff, and by expert --------
    res["moe"] = {}
    for arch, depth in MOE_DEPTH:
        laps(f"(e) {arch}")
        t0 = time.monotonic()
        mcfg = dataclasses.replace(get_config(arch), n_layers=depth)
        sharder, params, held, init_s, init_peak, biggest = \
            peaked_blocks(mcfg, "(e)")
        part = Partition(sharder)
        per = gemms_per_pass(mcfg)
        runs = [[]]
        with olm_calls({0, per - 1}) as seen, route_plans() as plans:
            k12.launches = 0
            first, tokens, passes, wall = serve(
                mcfg, sharder, params, "olm16",
                tp_prompts(mcfg.vocab_size), every=runs[0])
            launched = k12.launches
        f10 = None
        if arch == TP_F10:
            # (l) F10: the same serve again, the same bits
            laps(f"(l) {arch}")
            runs.append([])
            _, again, _, wall2 = serve(mcfg, sharder, params, "olm16",
                                       tp_prompts(mcfg.vocab_size),
                                       every=runs[1])
            f10 = dict(bits=same_bits(*runs), tokens=again == tokens,
                       passes=len(runs[0]), walls=(wall, wall2))
            say(f"(l) {mcfg.name} partitioned, served twice: every "
                f"pass's logits bit-equal {f10['bits']} over "
                f"{f10['passes']} passes, tokens equal "
                f"{f10['tokens']}; walls {wall:.3f} and {wall2:.3f} s")
        del runs
        res["moe"][arch] = dict(
            first=first, tokens=tokens, wall=wall, wq=seen[0],
            head=seen[per - 1], launches=launched, gemms=passes * per,
            held=held, init_s=init_s, init_peak=init_peak,
            biggest=biggest, plans=plans, layout=part.experts_by,
            experts=part.expert_range(), f10=f10)
        say(f"(e) {mcfg.name} at {depth} layers, experts split "
            f"{part.experts_by} (this rank's experts "
            f"{part.expert_range()} of {mcfg.n_experts}): {held} B of "
            f"serve blocks resident (the specs' count), drawn in "
            f"{init_s:.1f} s, the init's peak {init_peak} B (blocks + "
            f"one whole f32 leaf of {biggest} B at most); olm16 "
            f"{passes} passes in {wall:.3f} s, GEMMs issued "
            f"{passes * per}, K1 launches {launched}, {len(plans)} "
            f"dispatch plans; the part {time.monotonic() - t0:.1f} s")
        if launched != passes * per:
            raise RuntimeError(f"(e) K1 launched {launched} times for "
                               f"{passes * per} GEMMs")
        del params, part
        gc.collect()
        torch.cuda.empty_cache()

    # (g) one partitioned MoE decode against its walk ----------------
    laps("(g)")
    t0 = time.monotonic()
    kind, B, T = TP_DECODE
    arch, depth = MOE_DEPTH[-1]
    mcfg = dataclasses.replace(get_config(arch), n_layers=depth)
    sharder = Sharder(mesh, mcfg)
    sharder.set_batch(B)
    res["moe_card"] = dryrun.card_step(
        mcfg, ShapeCase("tp_moe_decode", T, B, kind), sharder)
    say(f"(g) one partitioned {mcfg.name} decode ({B} lanes, {T} "
        f"slots): FLOPs {res['moe_card']['flops']}, peak "
        f"{res['moe_card']['peak']} B, walls "
        f"{[round(w * 1e3, 3) for w in res['moe_card']['walls_s']]} ms;"
        f" the part {time.monotonic() - t0:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()

    # (f) the ring over its length ----------------------------------
    laps("(f)")
    t0 = time.monotonic()
    ring = dataclasses.replace(get_config("mixtral_8x22b"), **TP_RING)
    sharder, params, held, _ = blocks(ring)
    part = Partition(sharder)
    kv = init_serve_cache(Model(ring, device="meta"), sharder,
                          SERVE["requests"], TP["max_len"])[0]["k"]
    first, tokens, passes, wall = serve(
        ring, sharder, params, "native",
        tp_ring_prompts(ring.vocab_size))
    res["ring"] = dict(first=first, tokens=tokens, wall=wall)
    say(f"(f) {ring.name} with {ring.n_kv_heads} KV head, window "
        f"{ring.sliding_window}, cache of {TP['max_len']} slots: the "
        f"ring over its length {not part.kv_by_heads}, this rank's "
        f"block of it {tuple(kv.shape)}; {TP_RING_LEN}-token prompts "
        f"and {passes} passes native in {wall:.3f} s; the part "
        f"{time.monotonic() - t0:.1f} s")
    if part.kv_by_heads or kv.shape[1] * TP_RANKS != \
            ring.sliding_window:
        raise RuntimeError("(f) the ring is not split over its length")
    del params, part
    gc.collect()
    torch.cuda.empty_cache()

    # (h) the recurrent arch as published, native --------------------
    laps("(h)")
    t0 = time.monotonic()
    rec = get_config(TP["rec"])
    sharder, params, held, init_s, init_peak, biggest = peaked_blocks(
        rec, "(h)")
    state = init_serve_cache(Model(rec, device="meta"), sharder,
                             SERVE["requests"], TP["max_len"])[0]
    w = rec.rnn_width // world
    if tuple(state["h"].shape) != (SERVE["requests"], w) or \
            tuple(state["conv"].shape) != (SERVE["requests"],
                                           rec.conv_width - 1, w):
        raise RuntimeError("(h) the RG-LRU state is not split over "
                           f"its channels: {state}")
    first, tokens, passes, wall = serve(rec, sharder, params, "native",
                                        tp_prompts(rec.vocab_size))
    res["rec"] = dict(first=first, tokens=tokens, wall=wall, held=held,
                      init_s=init_s, init_peak=init_peak,
                      biggest=biggest)
    say(f"(h) {rec.name} ({rec.n_layers} layers, RG-LRU width "
        f"{rec.rnn_width}) on {mesh_shape(mesh)}: {held} B of serve "
        f"blocks resident (the specs' count), drawn in {init_s:.1f} s, "
        f"the init's peak {init_peak} B (blocks + one whole f32 leaf of "
        f"{biggest} B at most); this rank's RG-LRU state h "
        f"{tuple(state['h'].shape)}, conv {tuple(state['conv'].shape)};"
        f" native {passes} passes in {wall:.3f} s; the part "
        f"{time.monotonic() - t0:.1f} s")
    del params, state
    gc.collect()
    torch.cuda.empty_cache()

    # (k) one partitioned decode of (h)'s arch against its walk -------
    laps("(k)")
    t0 = time.monotonic()
    kind, B, T = TP_DECODE
    sharder = Sharder(mesh, rec)
    sharder.set_batch(B)
    res["rec_card"] = dryrun.card_step(
        rec, ShapeCase("tp_rec_decode", T, B, kind), sharder)
    say(f"(k) one partitioned {rec.name} decode ({B} lanes, {T} "
        f"slots): FLOPs {res['rec_card']['flops']}, peak "
        f"{res['rec_card']['peak']} B, walls "
        f"{[round(w * 1e3, 3) for w in res['rec_card']['walls_s']]} ms;"
        f" the part {time.monotonic() - t0:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()

    # (i) the recurrent arch cut to one pattern group, olm16 ---------
    laps("(i)")
    t0 = time.monotonic()
    rcut = dataclasses.replace(rec, **TP_REC_CUT)
    sharder, params, held, _ = blocks(rcut)
    per = gemms_per_pass(rcut)
    with olm_calls({0, per - 1}) as seen:
        k12.launches = 0
        first, tokens, passes, wall = serve(rcut, sharder, params,
                                            "olm16",
                                            tp_prompts(rcut.vocab_size))
        launched = k12.launches
    res["rec_olm"] = dict(first=first, tokens=tokens, wall=wall,
                          wx=seen[0], head=seen[per - 1],
                          launches=launched, gemms=passes * per)
    say(f"(i) {rcut.name} at {rcut.n_layers} layers "
        f"{rcut.layer_kinds}: olm16 {passes} passes in {wall:.3f} s, "
        f"GEMMs issued {passes * per}, K1 launches {launched}; the part "
        f"{time.monotonic() - t0:.1f} s")
    if launched != passes * per:
        raise RuntimeError(f"(i) K1 launched {launched} times for "
                           f"{passes * per} GEMMs")
    del params
    gc.collect()
    torch.cuda.empty_cache()

    # (j) the SSM arch as published, olm16: whole weights, its rows ---
    laps("(j)")
    t0 = time.monotonic()
    ssm = get_config(TP["ssm"])
    sharder, params, held, _ = blocks(ssm)
    per = gemms_per_pass(ssm)
    k12.launches = 0
    first, tokens, passes, wall = serve(ssm, sharder, params, "olm16",
                                        tp_prompts(ssm.vocab_size))
    launched = k12.launches
    lanes = mine(sharder)(torch.arange(SERVE["requests"])).tolist()
    res["ssm"] = dict(first=first, tokens=tokens, wall=wall, held=held,
                      launches=launched, gemms=passes * per,
                      per=per, lanes=lanes)
    say(f"(j) {ssm.name}: {held} B of serve params resident (the "
        f"specs' count: every weight whole), the batch over "
        f"{sharder.batch_spec()[0]}, this rank's rows {lanes}; olm16 "
        f"{passes} passes in "
        f"{wall:.3f} s, GEMMs issued {passes * per}, K1 launches "
        f"{launched}; the part {time.monotonic() - t0:.1f} s")
    if launched != passes * per:
        raise RuntimeError(f"(j) K1 launched {launched} times for "
                           f"{passes * per} GEMMs")
    del params
    gc.collect()
    torch.cuda.empty_cache()

    # (m) the VLM arch as published, native --------------------------
    laps("(m)")
    t0 = time.monotonic()
    vlm = get_config(TP["vlm"])
    sharder, params, held, init_s, init_peak, biggest = peaked_blocks(
        vlm, "(m)")
    first, tokens, passes, wall = serve(vlm, sharder, params, "native",
                                        tp_prompts(vlm.vocab_size))
    res["vlm"] = dict(first=first, tokens=tokens, wall=wall, held=held,
                      init_s=init_s, init_peak=init_peak,
                      biggest=biggest)
    say(f"(m) {vlm.name} ({vlm.n_layers} layers, "
        f"{vlm.layer_kinds.count('cross')} cross) on {mesh_shape(mesh)}:"
        f" {held} B of serve blocks resident (the specs' count), drawn "
        f"in {init_s:.1f} s, the init's peak {init_peak} B (blocks + one "
        f"whole f32 leaf of {biggest} B at most); native {passes} passes "
        f"in {wall:.3f} s; the part {time.monotonic() - t0:.1f} s")

    # (n) its first pattern group, cut from the same blocks, olm16 ----
    laps("(n)")
    t0 = time.monotonic()
    vcut = dataclasses.replace(vlm, **TP_VLM_CUT)
    sharder = Sharder(mesh, vcut)
    sharder.set_batch(SERVE["requests"])
    per, wk_at = gemms_per_pass(vcut), tp_cross_wk(vcut)
    with olm_calls({0, wk_at, per - 1}) as seen:
        k12.launches = 0
        first, tokens, passes, wall = serve(
            vcut, sharder, tp_cut_params(params, vcut), "olm16",
            tp_prompts(vcut.vocab_size))
        launched = k12.launches
    res["vlm_olm"] = dict(first=first, tokens=tokens, wall=wall,
                          wq=seen[0], wk=seen[wk_at], head=seen[per - 1],
                          launches=launched, gemms=passes * per)
    say(f"(n) {vcut.name} at {vcut.n_layers} layers {vcut.layer_kinds}:"
        f" olm16 {passes} passes in {wall:.3f} s, GEMMs issued "
        f"{passes * per}, K1 launches {launched}; the cross wk GEMM "
        f"{tuple(seen[wk_at][0].shape)} -> {tuple(seen[wk_at][1].shape)};"
        f" the part {time.monotonic() - t0:.1f} s")
    if launched != passes * per:
        raise RuntimeError(f"(n) K1 launched {launched} times for "
                           f"{passes * per} GEMMs")
    del params, seen
    gc.collect()
    torch.cuda.empty_cache()

    # (p) one partitioned decode of (n)'s cut against its walk --------
    laps("(p)")
    t0 = time.monotonic()
    kind, B, T = TP_DECODE
    sharder = Sharder(mesh, vcut)
    sharder.set_batch(B)
    res["vlm_card"] = dryrun.card_step(
        vcut, ShapeCase("tp_vlm_decode", T, B, kind), sharder)
    say(f"(p) one partitioned {vcut.name} decode at {vcut.n_layers} "
        f"layers ({B} lanes, {T} slots, the memory's rows): FLOPs "
        f"{res['vlm_card']['flops']}, peak {res['vlm_card']['peak']} B, "
        f"walls "
        f"{[round(w * 1e3, 3) for w in res['vlm_card']['walls_s']]} ms;"
        f" the part {time.monotonic() - t0:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()

    # (o) the enc-dec arch as published, native; a 2 + 2 cut, olm16 ---
    laps("(o)")
    t0 = time.monotonic()
    enc = get_config(TP["encdec"])
    prompts = tp_prompts(enc.vocab_size)
    sharder, params, held, init_s = blocks(enc)
    first, tokens, passes, wall = serve(enc, sharder, params, "native",
                                        prompts)
    res["encdec"] = dict(first=first, tokens=tokens, wall=wall,
                         held=held, init_s=init_s)
    ecut = dataclasses.replace(enc, **TP_ENCDEC_CUT)
    sharder = Sharder(mesh, ecut)
    sharder.set_batch(SERVE["requests"])
    with olm_calls({0}) as seen:
        k12.launches = 0
        first, tokens, passes, olm_wall = serve(
            ecut, sharder, tp_cut_params(params, ecut), "olm16", prompts)
        launched = k12.launches
    gemms = gemms_per_pass(ecut, True) + (passes - 1) * gemms_per_pass(
        ecut)
    res["encdec_olm"] = dict(first=first, tokens=tokens, wall=olm_wall,
                             wq=seen[0], launches=launched, gemms=gemms)
    say(f"(o) {enc.name} ({enc.n_enc_layers} encoder + {enc.n_layers} "
        f"xdec layers): {held} B of serve blocks resident (the specs' "
        f"count), drawn in {init_s:.1f} s; native {passes} passes in "
        f"{wall:.3f} s; at {ecut.n_enc_layers} + {ecut.n_layers} layers "
        f"olm16 in {olm_wall:.3f} s, GEMMs issued {gemms} "
        f"({gemms_per_pass(ecut, True)} a prefill, "
        f"{gemms_per_pass(ecut)} a decode), K1 launches {launched}; the "
        f"part {time.monotonic() - t0:.1f} s")
    if launched != gemms:
        raise RuntimeError(f"(o) K1 launched {launched} times for "
                           f"{gemms} GEMMs")
    del params, seen
    gc.collect()
    torch.cuda.empty_cache()

    # (b) the big arch as published ----------------------------------
    laps("(b) draw")
    big = get_config(TP["big"])
    base = torch.cuda.memory_allocated()
    sharder, params, held, init_s = blocks(big)
    say(f"(b) {big.name} ({big.n_layers} layers, d_model "
        f"{big.d_model}) on {mesh_shape(mesh)}: {held} bytes of serve "
        f"blocks resident, the specs' count, drawn leaf by leaf in "
        f"{init_s:.1f} s; allocated {torch.cuda.memory_allocated() - base}"
        " B above the phase's start")
    torch.cuda.reset_peak_memory_stats()
    laps("(b) serve")
    first, tokens, passes, wall = serve(big, sharder, params, "native",
                                        tp_prompts(big.vocab_size))
    peak = torch.cuda.max_memory_allocated()
    res["big"] = dict(first=first, tokens=tokens, wall=wall, held=held,
                      init_s=init_s, peak=peak)
    say(f"(b) native bf16: {passes} passes in {wall:.3f} s; "
        f"max_memory_allocated {peak} B ({peak / 2**30:.2f} GiB)")
    del params
    torch.save(res, os.path.join(tmp, f"tp{rank}.pt"))


def smi(fields: str) -> str:
    out = subprocess.run(["nvidia-smi", f"--query-gpu={fields}",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


FLUSH_BYTES = 256 << 20            # > 5x the H100's 50 MB L2
SPIN_CYCLES = 1_000_000            # ~0.5 ms of the SM clock
_flush = []


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    """Median milliseconds of fn() over reps launches after warmup ones,
    each between its own pair of CUDA events, with the L2 cache
    overwritten before each (outside the events): every operand is read
    from device memory, as the serve reads each weight once a pass. A
    plain version that spends longer on the host than the spin kernel
    lasts is timed with its host gaps."""
    import torch
    if not _flush:
        _flush.append(torch.empty(FLUSH_BYTES // 4, dtype=torch.int32,
                                  device="cuda"))
    for _ in range(warmup):
        fn()
    spans = []
    for _ in range(reps):
        _flush[0].zero_()
        # a spin kernel keeps the stream busy while the host enqueues the
        # events and fn's launches, so the pair times the device alone
        torch.cuda._sleep(SPIN_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        spans.append((start, stop))
    torch.cuda.synchronize()
    times = sorted(a.elapsed_time(b) for a, b in spans)
    mid = len(times) // 2
    return times[mid] if len(times) % 2 else (times[mid - 1] + times[mid]) / 2


def device_busy(fn, name: str, laps=None):
    """Run fn() under torch.profiler: (seconds the device ran any kernel,
    seconds in kernels whose name holds `name`, device kernels seen).
    Only the device's activity is recorded, and read from the profiler's
    raw events: the host's ops, which no reading here takes, and the
    profiler's own table of events cost a full-width serve's trace tens of
    seconds to read (probes/device_busy_activities.py reads it each way).
    `laps` (Laps), where given, opens a part for reading the trace."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
        if laps is not None:
            laps(f"{name} trace read")
    cuda = torch.autograd.DeviceType.CUDA
    events = [(e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
              for e in prof.profiler.kineto_results.events()
              if e.device_type() == cuda]
    spans = sorted((a, b) for a, b, _ in events)
    busy, lo, hi = 0, None, None
    for a, b in spans:
        if hi is None or a > hi:
            busy += 0 if hi is None else hi - lo
            lo, hi = a, b
        else:
            hi = max(hi, b)
    busy += 0 if hi is None else hi - lo
    own = sum(b - a for a, b, kernel in events if name in kernel)
    return busy / 1e9, own / 1e9, len(spans)


def operands(shape, seed, device):
    import torch
    M, K, N = shape
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(M, K, device=device, generator=g)
    w = torch.randn(K, N, device=device, generator=g) * (2.0 / (K + N)) ** 0.5
    return x, w


def digits(shape, seed, device):
    import torch
    g = torch.Generator(device=device).manual_seed(seed)
    return tuple(torch.randint(-1, 2, shape, device=device, generator=g,
                               dtype=torch.int32) for _ in range(2))


def mode_bits(mode: str):
    body = mode[len("olm"):]
    n, _, p = body.partition("t")
    return int(n), (int(p) if p else None)


def bits_equal(a, b) -> bool:
    import torch
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.dtype == torch.float32:
        return torch.equal(a.view(torch.int32), b.view(torch.int32))
    return torch.equal(a, b)


def bound(byte_count: int, ops: float, rate: float):
    """(bound ms, "bytes" or "operations", bytes ms, operations ms)."""
    byte_ms = byte_count / HBM_BYTES_PER_S * 1e3
    op_ms = ops / rate * 1e3
    return (max(byte_ms, op_ms), "operations" if op_ms >= byte_ms else "bytes",
            byte_ms, op_ms)


def ptxas_summary(log: str) -> str:
    regs = [int(r) for r in re.findall(r"Used (\d+) registers", log)]
    spills = sum(int(s) for s in re.findall(r"(\d+) bytes spill stores", log))
    smem = [int(s) for s in re.findall(r"(\d+) bytes smem", log)] or [0]
    if not regs:
        return "no ptxas report"
    return (f"{len(regs)} kernels, {min(regs)}-{max(regs)} registers, "
            f"{spills} bytes of spill stores, up to {max(smem)} bytes smem")


def shard_vlm_batches(cfg, dev):
    """(d3)'s SHARD_VLM["steps"] whole batches: TRAIN["batch"] tokens of the
    synthetic stream and one set of patches (B, n_frontend_tokens,
    d_model) N(0, 1) from TRAIN's seed."""
    import torch
    from repro_torch.data.synthetic import SyntheticLMDataset
    B, S = TRAIN["batch"]
    data = SyntheticLMDataset(cfg, B, S, seed=TRAIN["seed"])
    g = torch.Generator(device=dev).manual_seed(TRAIN["seed"])
    patches = torch.randn((B, cfg.n_frontend_tokens, cfg.d_model),
                          generator=g, device=dev)
    return [{"tokens": torch.from_numpy(data.batch(i)["tokens"]).to(dev),
             "patches": patches} for i in range(SHARD_VLM["steps"])]


def update_sq(model, params, block=None) -> dict:
    """{path: the squared norm, in f64, of the leaf of `params` less the
    same leaf of `model`'s init from TRAIN's seed}: the init drawn again
    leaf by leaf (each cut to this rank's block by `block(path, leaf)`
    where given), so no copy of the start is kept while the steps run."""
    from repro_torch.distributed.sharding import path_leaves
    now = dict(path_leaves(params))
    out = {}

    def keep(path, t):
        if block is not None:
            t = block(path, t)
        out[path] = float((now[path].double() - t.double()).pow(2).sum())
        return t.new_zeros(())

    model.init(TRAIN["seed"], keep=keep)
    return out


def shard_partitioned(rank, dev, meshes, tmp, say, res, laps) -> None:
    """(d) of the shard phase on this rank (`shard_rank`): each part
    raises on a disagreement and leaves its numbers in res["tp_train"];
    `laps` (Laps) takes each part's wall."""
    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.core.numerics import DotEngine
    from repro_torch.data.synthetic import SyntheticLMDataset
    from repro_torch.distributed.collectives import shard_dims
    from repro_torch.distributed.sharding import Sharder, path_leaves
    from repro_torch.distributed.train import (block_shape,
                                               init_train_state,
                                               jit_train_step)
    from repro_torch.kernels.online_dot import matmul_kernel as k12
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import mesh_shape
    from repro_torch.launch.shapes import ShapeCase
    from repro_torch.models.model import Model
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.optim.schedule import cosine_schedule
    from repro_torch.tree import tree_leaves, tree_map

    opt_cfg = AdamWConfig(lr=TRAIN["lr"])
    ref = json.loads(Path(tmp, "train_tp.json").read_text())
    out = res["tp_train"] = {}

    def local(tree):
        return [t.to_local() for t in tree_leaves(tree)]

    def spec_bytes(cfg, sharder):
        """params, m and v of this rank's blocks, f32, from the specs"""
        sizes = mesh_shape(sharder.mesh)
        return 3 * sum(4 * math.prod(block_shape(
            t.shape, sharder.param_spec(p, tuple(t.shape)), sizes))
            for p, t in path_leaves(Model(cfg, device="meta").init(0)))

    def update_norm(model, sharder, params):
        """The whole update's norm from this rank's blocks: each leaf's
        squares summed over the axes that split it, a replicated leaf
        once (every rank holds it alike)."""
        def spec(path, t):
            return sharder.param_spec(path, tuple(t.shape))
        sq = update_sq(model, params, lambda path, t: shard_dims(
            t, spec(path, t), sharder.mesh))
        whole = dict(path_leaves(Model(model.cfg, device="meta").init(0)))
        sizes = mesh_shape(sharder.mesh)
        mine = torch.zeros(2, dtype=torch.float64)
        for path, v in sq.items():
            shape = tuple(whole[path].shape)
            if block_shape(shape, spec(path, whole[path]), sizes) != shape:
                mine[0] += v
            elif rank == 0:
                mine[1] += v
        dist.all_reduce(mine)
        return float(mine.sum()) ** 0.5

    def run_steps(tag, model, sharder, batches, one, limits):
        """A step a batch from the sharded init: the state's bytes,
        the walls, the peak, the readings against one device's `one`
        within `limits`."""
        laps(f"({tag}) draw")
        torch.cuda.synchronize()
        t0 = time.monotonic()
        state = init_train_state(model, seed=TRAIN["seed"], sharder=sharder)
        torch.cuda.synchronize()
        init_s = time.monotonic() - t0
        held = sum(t.numel() * t.element_size() for t in local(
            (state["params"], state["opt"]["m"], state["opt"]["v"])))
        want = spec_bytes(model.cfg, sharder)
        keys = list(batches[0])
        specs = sharder.batch_specs(keys)
        step = jit_train_step(model, sharder, state, keys, opt_cfg=opt_cfg,
                              schedule_total=TRAIN["total"])
        walls, seen = [], []
        torch.cuda.reset_peak_memory_stats()
        laps(f"({tag}) steps")
        for b in batches:
            rows = {k: shard_dims(v, specs[k], sharder.mesh)
                    for k, v in b.items()}
            torch.cuda.synchronize()
            t0 = time.monotonic()
            state, met = step(state, rows)
            torch.cuda.synchronize()
            walls.append(time.monotonic() - t0)
            seen.append([float(met["loss"]), float(met["grad_norm"])])
        peak = torch.cuda.max_memory_allocated()
        laps(f"({tag}) update norm")
        upd = update_norm(model, sharder, tree_map(
            lambda t: t.to_local(), state["params"]))
        read = {"loss": max(abs(a[0] - b[0]) / abs(b[0])
                            for a, b in zip(seen, one["metrics"])),
                "grad_norm": max(abs(a[1] - b[1]) / abs(b[1])
                                 for a, b in zip(seen, one["metrics"])),
                "update": abs(upd - one["update_norm"]) / one["update_norm"]}
        ok = held == want and all(read[k] <= limits[k] for k in read)
        out[tag] = dict(state_bytes=held, spec_bytes=want, init_s=init_s,
                        walls_s=walls, peak_bytes=peak, metrics=seen,
                        update_norm=upd, agree=ok, **read)
        say(f"({tag}) {model.cfg.name} ({model.cfg.n_layers} layers, "
            f"d_model {model.cfg.d_model}, {model.cfg.sharding_profile}) on "
            f"{mesh_shape(sharder.mesh)}, partitioned: state (params, m, v) "
            f"{held} B a rank, the specs' {want} B; drawn in {init_s:.1f} s; "
            f"{len(batches)} steps, walls {[round(w, 3) for w in walls]} s, "
            f"peak {peak} B ({peak / 2**30:.2f} GiB); loss and grad_norm by "
            f"step {seen}, update norm {upd!r}; relative to one device: "
            f"loss {read['loss']!r}, grad_norm {read['grad_norm']!r}, update "
            f"{read['update']!r} (limits {limits}): {ok}")
        if not ok:
            raise RuntimeError(f"({tag}) disagrees with one device")
        del state, step
        gc.collect()
        torch.cuda.empty_cache()
        return peak

    # (d1) TRAIN's arch as published, native -----------------------------
    cfg = get_config(TRAIN["arch"])
    B, S = TRAIN["batch"]
    sharder = Sharder(meshes[(1, 2)], cfg)
    sharder.set_batch(B)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in SyntheticLMDataset(
        cfg, B, S, seed=TRAIN["seed"]).batch(0).items()}
    peak = run_steps("d1", Model(cfg, device=dev), sharder,
                     [batch] * SHARD_TP_STEPS, ref["d1"], SHARD_TP_LIMITS)
    share = peak / ref["d1"]["peak"]
    out["d1"]["peak_share"] = share
    say(f"(d1) peak {peak} B, {100 * share:.1f}% of the train phase's "
        f"one-device {ref['d1']['peak']} B (at most "
        f"{100 * SHARD_TP_PEAK:.0f}%)")
    if share > SHARD_TP_PEAK:
        raise RuntimeError(f"(d1) peak {share:.3f} of one device's")

    # (d2) (c)'s cut, one olm16 step --------------------------------------
    laps("(d2)")
    cut = dataclasses.replace(cfg, n_layers=SHARD_TRAIN_LAYERS)
    kB, kS = TRAIN["kernel_batch"]
    sharder = Sharder(meshes[(1, 2)], cut)
    sharder.set_batch(kB)
    model = Model(cut, DotEngine(mode="olm16"), device=dev)
    kb = {k: torch.from_numpy(v).to(dev) for k, v in SyntheticLMDataset(
        cut, kB, kS, seed=TRAIN["seed"]).batch(0).items()}
    state = init_train_state(model, seed=TRAIN["seed"], sharder=sharder)
    start = [t.clone() for t in local(state["params"])]
    step = jit_train_step(model, sharder, state, ["tokens"],
                          opt_cfg=opt_cfg, schedule_total=TRAIN["total"])
    per_pass = gemms_per_pass(cut)
    recompute = per_pass - 1 - cut.n_layers
    torch.cuda.synchronize()
    k12.launches = 0
    t0 = time.monotonic()
    with olm_calls({0}) as calls:
        state, met = step(state, kb)
        torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launched = k12.launches
    wq = torch.load(os.path.join(tmp, "wq16.pt"))
    n = wq[1].shape[1] // 2
    x, got = calls[0]
    wq_ok = bits_equal(x, wq[0].to(dev)) and bits_equal(
        got, wq[1][:, rank * n:(rank + 1) * n].to(dev))
    zero = float(met["grad_norm"]) == 0.0
    lr = opt_cfg.lr * cosine_schedule(
        torch.tensor(0, dtype=torch.int32, device=dev), total=TRAIN["total"])
    decay = all(bits_equal(b, a - lr * (
        torch.zeros_like(a) / (torch.sqrt(torch.zeros_like(a))
                               + opt_cfg.eps) + opt_cfg.weight_decay * a))
        for a, b in zip(start, local(state["params"])))
    out["d2"] = dict(wall_s=wall, k1_launches=launched,
                     gemms=per_pass + recompute, wq_bits=wq_ok,
                     zero_grads=zero, decay_only=decay)
    res["launches"]["tp_train"] = launched
    say(f"(d2) {cut.name} at {cut.n_layers} layers, one olm16 partitioned "
        f"step of {kB} x {kS}: wall {wall:.3f} s, K1 launches {launched} "
        f"for {per_pass} forward GEMMs + {recompute} recomputed by remat; "
        f"layer 0's wq input and its {n} columns bit-equal to one device's "
        f"K1 {wq_ok}; grad_norm {float(met['grad_norm'])} (every gradient "
        f"zero: {zero}); params bit-equal to the decay-only update {decay}")
    if launched != per_pass + recompute or not (wq_ok and zero and decay):
        raise RuntimeError(f"(d2) olm16: {out['d2']}")
    del state, step, start, calls, wq, model
    gc.collect()
    torch.cuda.empty_cache()

    # (d3) Llama-3.2-Vision's first group under fsdp_tp on (2, 1) ---------
    vcfg = dataclasses.replace(get_config(SHARD_VLM["arch"]),
                               n_layers=SHARD_VLM["n_layers"],
                               remat=SHARD_VLM["remat"])
    sharder = Sharder(meshes[(2, 1)], vcfg)
    sharder.set_batch(B)
    run_steps("d3", Model(vcfg, device=dev), sharder,
              shard_vlm_batches(vcfg, dev), ref["d3"], SHARD_DATA_LIMITS)

    # (d4) (d2)'s cut, one native step against its walk ------------------
    laps("(d4)")
    sharder = Sharder(meshes[(1, 2)], cut)
    sharder.set_batch(B)
    out["d4"] = dryrun.card_step(cut, ShapeCase("shard_train", S, B,
                                                "train"), sharder)
    say(f"(d4) one partitioned native step of {cut.name} at "
        f"{cut.n_layers} layers, {B} x {S}: FLOPs {out['d4']['flops']}, "
        f"peak {out['d4']['peak']} B, walls "
        f"{[round(w, 3) for w in out['d4']['walls_s']]} s")
    gc.collect()
    torch.cuda.empty_cache()
    laps()


def shard_rank(rank: int, world: int, tmp: str, serve_tokens, laps) -> None:
    """The shard phase's (a)-(d) on this rank (`ranks_main`). Holds them
    against the single-device results the parent left in `tmp`, raises on
    any disagreement, and writes its numbers and its parts' walls to
    tmp/rank<r>.json."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.core.numerics import DotEngine, EngineSpec
    from repro_torch.data.synthetic import SyntheticLMDataset
    from repro_torch.distributed.collectives import gather_dtensor
    from repro_torch.distributed.sharding import Sharder
    from repro_torch.distributed.train import (build_train_step,
                                               distribute_state,
                                               gather_state,
                                               init_train_state,
                                               state_shardings)
    from repro_torch.kernels.online_dot import matmul_kernel as k12
    from repro_torch.kernels.online_dot.matmul import olm_error_bound
    from repro_torch.kernels.online_dot.matmul_sharded import (
        olm_matmul_sharded)
    from repro_torch.launch.mesh import make_local_mesh, mesh_shape
    from repro_torch.models.model import Model
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.serving.engine import Request, ServeEngine
    from repro_torch.tree import tree_leaves, tree_unflatten, tree_flatten

    dev = torch.device("cuda", 0)
    tag = f"[shard r{rank}]"
    res = {"gemms": [], "launches": {}}

    def say(msg):
        print(f"{tag} {msg}", flush=True)

    meshes = {s: make_local_mesh(*s, device_type="cuda")
              for s in ((1, 2), (2, 1))}
    say(f"backend {dist.get_backend()}, world {world}, meshes "
        f"{[mesh_shape(m) for m in meshes.values()]}, device "
        f"{torch.cuda.get_device_name(dev)}")
    mesh = meshes[(1, 2)]

    # (a) the sharded GEMMs against one device's K1 ------------------
    laps("(a)")
    ref = torch.load(os.path.join(tmp, "gemm.pt"))
    for i, ((K, N), mode) in enumerate(SHARD_GEMMS):
        n, p = mode_bits(mode)
        x, w = operands((SHARD_ROWS, K, N), 100 + i, dev)
        exact = (x.double() @ w.double())
        lim = olm_error_bound(x, w, n_bits=n, trunc=p).double()
        for part in ("m", "n", "k"):
            torch.cuda.synchronize()
            k12.launches = 0
            t0 = time.monotonic()
            out = olm_matmul_sharded(x, w, mesh=mesh, partition=part,
                                     n_bits=n, trunc=p)
            torch.cuda.synchronize()
            wall = time.monotonic() - t0
            launched = k12.launches
            row = dict(shape=[SHARD_ROWS, K, N], mode=mode, part=part,
                       wall_s=wall, k1_launches=launched)
            if part in ("m", "n"):
                row["bit_identical"] = bits_equal(
                    out, ref[f"{i}"].to(dev))
                # each rank receives the other ranks' blocks
                row["gather_bytes"] = (4 * SHARD_ROWS * N
                                       * (world - 1) // world)
                ok = row["bit_identical"]
            else:
                row["err_over_bound"] = float(
                    ((out.double() - exact).abs() / lim).max())
                ok = row["err_over_bound"] <= 1.0
            res["gemms"].append(row)
            say(f"(a) {mode} ({SHARD_ROWS}, {K}) @ ({K}, {N}) over "
                f"{part}: wall {wall * 1e3:.3f} ms, K1 launches "
                f"{launched}, " + (
                    f"bit-identical to one device {ok}, gathered "
                    f"{row['gather_bytes']} bytes into this rank"
                    if part != "k" else
                    f"largest |err| / bound {row['err_over_bound']:.4f}"))
            if not ok or launched != 1:
                raise RuntimeError(f"(a) {mode} {part} at ({K}, {N}) "
                                   "disagrees or launched K1 "
                                   f"{launched} times")
        del x, w, exact, lim, out
    res["launches"]["gemms"] = sum(r["k1_launches"]
                                   for r in res["gemms"])
    del ref

    # (b) the serve, every GEMM's columns split over the two ranks ----
    laps("(b) draw")
    cfg = get_config(SERVE["arch"])
    params = Model(cfg, device=dev).init(seed=SERVE["seed"])
    model = Model(cfg, DotEngine(mode="olm16"), device=dev)

    def seeded_engine():
        engine = ServeEngine(model, params, slots=SERVE["slots"],
                             max_len=SERVE["max_len"],
                             kv_block_size=SERVE["block"], device=dev,
                             engine=EngineSpec(shard="n"), mesh=mesh)
        rng = np.random.default_rng(SERVE["seed"])
        lo, hi = SERVE["prompt"]
        for rid in range(SERVE["requests"]):
            prompt = rng.integers(0, cfg.vocab_size, int(rng.integers(
                lo, hi + 1))).astype(np.int32)
            engine.submit(Request(rid=rid, prompt=prompt,
                                  max_new_tokens=SERVE["max_new"]))
        return engine

    engine = seeded_engine()
    passes = []
    for kind in ("prefill", "decode_step"):
        real = getattr(engine.model, kind)

        def counted(*a, _real=real, **kw):
            passes.append(1)
            return _real(*a, **kw)

        setattr(engine.model, kind, counted)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    laps("(b) serve, profiled")
    ran = []

    def run():
        # the serve, timed inside the profiler's window: its start and
        # the reading of its trace stay out of the wall
        k12.launches = 0
        t0 = time.monotonic()
        ran.append(engine.run())
        torch.cuda.synchronize()
        ran.extend((time.monotonic() - t0, k12.launches))

    busy, k1_s, n_events = device_busy(run, "olm_matmul")
    done, wall, launched = ran
    peak = torch.cuda.max_memory_allocated()
    gemms = len(passes) * gemms_per_pass(cfg)
    tokens = [r.output for r in sorted(done, key=lambda r: r.rid)]
    same = [list(map(int, t)) for t in tokens] == serve_tokens
    res["serve"] = dict(wall_s=wall, passes=len(passes), gemms=gemms,
                        k1_launches=launched, same_tokens=same,
                        peak_bytes=peak, busy_s=busy, k1_device_s=k1_s,
                        device_kernels=n_events)
    res["launches"]["serve"] = launched
    say(f"(b) {cfg.name} ({cfg.n_layers} layers, d_model "
        f"{cfg.d_model}) served under olm16 with shard='n' on "
        f"{mesh_shape(mesh)}, under torch.profiler: wall {wall:.3f} s "
        f"(ends in torch.cuda.synchronize), {len(passes)} forward passes, "
        f"GEMMs issued {gemms}, K1 launches {launched}; the serve phase's "
        f"single-device tokens: {same}; peak memory {peak} bytes "
        f"({peak / 2**30:.2f} GiB); this rank's kernels kept the device "
        f"busy {busy:.3f} s ({100 * busy / wall:.1f}% of the wall), K1 "
        f"{k1_s:.3f} s, {n_events} kernels")
    if launched != gemms or not same:
        raise RuntimeError(f"(b) K1 launched {launched} times for "
                           f"{gemms} GEMMs, same tokens {same}")
    del params, model, engine, done
    torch.cuda.empty_cache()

    # (c) the sharded train step -------------------------------------
    laps("(c) setup")
    cfg = dataclasses.replace(get_config(TRAIN["arch"]),
                              n_layers=SHARD_TRAIN_LAYERS)
    model = Model(cfg, device=dev)
    B, S = TRAIN["batch"]
    data = SyntheticLMDataset(cfg, B, S, seed=TRAIN["seed"])
    batches = [{k: torch.from_numpy(v).to(dev)
                for k, v in data.batch(i).items()}
               for i in range(SHARD_TRAIN_STEPS)]
    opt_cfg = AdamWConfig(lr=TRAIN["lr"])
    want = torch.load(os.path.join(tmp, "train.pt"), mmap=True)
    one = json.loads(Path(tmp, "train.json").read_text())
    sharders, train = {}, {}
    for shape, m in meshes.items():
        laps(f"(c) {shape}")
        sharders[shape] = sharder = Sharder(m, cfg)
        sharder.set_batch(B)
        state = distribute_state(sharder, init_train_state(
            model, seed=TRAIN["seed"]))
        step = build_train_step(model, sharder, opt_cfg=opt_cfg,
                                schedule_total=TRAIN["total"])
        walls, seen = [], []
        for b in batches:
            torch.cuda.synchronize()
            t0 = time.monotonic()
            state, met = step(state, b)
            torch.cuda.synchronize()
            walls.append(time.monotonic() - t0)
            seen.append([float(met["loss"]), float(met["grad_norm"])])
        got = tree_leaves(gather_state(state["params"]))
        # each step's loss and grad_norm, and the update (params
        # after minus before) against one device's, relative
        read = {
            "loss": max(abs(a[0] - b[0]) / abs(b[0])
                        for a, b in zip(seen, one["metrics"])),
            "grad_norm": max(abs(a[1] - b[1]) / abs(b[1])
                             for a, b in zip(seen, one["metrics"])),
            "update": sum(float((g.double() - r.to(dev).double())
                                .pow(2).sum())
                          for g, r in zip(got, want)) ** 0.5
            / one["update_norm"]}
        if shape == (1, 2):
            agree = all(bits_equal(g, r.to(dev))
                        for g, r in zip(got, want))
            worst = None
        else:
            # the sum over the data axis moves every one of these:
            # probes/sharded_train_faults.py plants its faults
            agree = all(torch.allclose(g, r.to(dev), atol=5e-3,
                                       rtol=5e-3)
                        for g, r in zip(got, want)) and all(
                read[k] <= SHARD_DATA_LIMITS[k] for k in read)
            worst = max(float((g - r.to(dev)).abs().max())
                        for g, r in zip(got, want))
        train[str(shape)] = dict(walls_s=walls, metrics=seen,
                                 agree=agree, worst_abs=worst, **read)
        say(f"(c) {cfg.name} at {cfg.n_layers} layers on "
            f"{mesh_shape(m)}: {SHARD_TRAIN_STEPS} steps of {B} x {S}, "
            f"walls {[round(w, 3) for w in walls]} s, loss and "
            f"grad_norm by step {seen}; relative to one device: "
            f"loss {read['loss']!r}, grad_norm {read['grad_norm']!r}, "
            f"update {read['update']!r}; params after the steps "
            + ("bit-equal to one device's" if shape == (1, 2) else
               "within 5e-3 of one device's (largest |diff| "
               f"{worst:.3e}) and the readings within "
               f"{SHARD_DATA_LIMITS}") + f": {agree}")
        if not agree:
            raise RuntimeError(f"(c) {shape} disagrees with one device")
        if shape == (2, 1):
            # saved on (2, 1), restored onto (1, 2)
            laps("(c) save and restore")
            ckpt = CheckpointManager(os.path.join(tmp, "ckpt"),
                                     async_save=False)
            t0 = time.monotonic()
            ckpt.save(SHARD_TRAIN_STEPS, {"params": state["params"]})
            t1 = time.monotonic()
            _, treedef = tree_flatten(state["params"])
            like = {"params": tree_unflatten(treedef, got)}
            back = ckpt.restore(like, shardings=state_shardings(
                sharders[(1, 2)], like))
            t2 = time.monotonic()
            same = all(bits_equal(gather_dtensor(r), g) for r, g in zip(
                tree_leaves(back), got))
            placed = tree_leaves(back)[0].placements
            train["restore"] = dict(same=same, save_s=t1 - t0,
                                    restore_s=t2 - t1)
            say(f"(c) params saved on (2, 1) in {t1 - t0:.1f} s and "
                f"restored onto (1, 2) ({placed}) in {t2 - t1:.1f} s: "
                f"bit-equal to what was saved {same}")
            if not same:
                raise RuntimeError("(c) the elastic restore changed bits")
            del back, like
        del state, got, step
        torch.cuda.empty_cache()
    del want
    # one olm16 step, every GEMM's columns split over the two ranks
    laps("(c) olm16")
    per_pass = gemms_per_pass(cfg)
    recompute = per_pass - 1 - cfg.n_layers
    B, S = TRAIN["kernel_batch"]
    kb = {k: torch.from_numpy(v).to(dev) for k, v in SyntheticLMDataset(
        cfg, B, S, seed=TRAIN["seed"]).batch(0).items()}
    step = build_train_step(model, sharders[(1, 2)], opt_cfg=opt_cfg,
                            schedule_total=TRAIN["total"],
                            engine_spec=EngineSpec(mode="olm16",
                                                   shard="n"))
    state = distribute_state(sharders[(1, 2)], init_train_state(
        model, seed=TRAIN["seed"]))
    torch.cuda.synchronize()
    k12.launches = 0
    t0 = time.monotonic()
    state, met = step(state, kb)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launched = k12.launches
    zero = float(met["grad_norm"]) == 0.0
    train["olm16"] = dict(wall_s=wall, k1_launches=launched,
                          gemms=per_pass + recompute, zero_grads=zero)
    res["launches"]["train"] = launched
    res["train"] = train
    say(f"(c) one olm16 step with shard='n' on (1, 2) at {B} x {S}: "
        f"wall {wall:.3f} s, K1 launches {launched} for {per_pass} "
        f"forward GEMMs + {recompute} recomputed by remat; grad_norm "
        f"{float(met['grad_norm'])} (every gradient zero: {zero})")
    if launched != per_pass + recompute or not zero:
        raise RuntimeError(f"(c) olm16: {launched} K1 launches for "
                           f"{per_pass + recompute} GEMMs, zero {zero}")
    del state, step, model
    gc.collect()
    torch.cuda.empty_cache()

    # (d) the partitioned train step ---------------------------------
    shard_partitioned(rank, dev, meshes, tmp, say, res, laps)
    res["walls"] = laps.rows
    with open(os.path.join(tmp, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)


def stop(ctx) -> None:
    """Terminate each process of a torch.multiprocessing context still
    alive."""
    for proc in ctx.processes:
        if proc.is_alive():
            proc.terminate()
            proc.join(30)


def await_ranks(ctx, events) -> None:
    """Wait in the smoke's process until every one of `events` is set. A
    rank that raised fails the call, and with it the script; so do ranks
    that all ended before setting them."""
    while not all(e.is_set() for e in events):
        if ctx.join(timeout=1.0) and not all(e.is_set() for e in events):
            raise SystemExit("the ranks ended before their results")


def wait_parent(event, parent: int) -> None:
    """Wait in a child process for the parent's `event`; raise if the
    parent (pid `parent`) is gone."""
    while not event.wait(1.0):
        if os.getppid() != parent:
            raise RuntimeError("the smoke's process is gone")


def ranks_main(rank: int, world: int, port: int, tmp: str, serve_tokens,
               events, parent: int) -> None:
    """One of the shard and tp phases' ranks: a process of its own on
    cuda:0 for both phases, in one gloo group of `world` ranks on
    127.0.0.1 (NCCL refuses two ranks on one device). It runs the shard
    phase's parts (`shard_rank`) once the parent's single-device results
    are in `tmp` (events["shard"]) and sets events["shard_done"][rank];
    then, once the parent's tp results are there (events["tp"]), rank 0
    runs (b)'s single device (`tp_one`), both ranks the tp phase's parts
    (`tp_rank`), and rank 0 (e) and (f)'s single device (`tp_moe_one`).
    Each part frees its memory before the next starts. The parts' walls
    go to the parent with each phase's results."""
    # Yi-34B's blocks fill most of the card that two ranks share: segments
    # that grow in place keep the init's freed f32 leaves from fragmenting
    # what the serve needs (read at the process's first allocation)
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = TP_ALLOC
    laps = Laps()
    laps("import and group")
    import torch
    import torch.distributed as dist
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(torch.device("cuda", 0))
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world)
    try:
        laps("wait for the parent's single device")
        wait_parent(events["shard"], parent)
        shard_rank(rank, world, tmp, serve_tokens, laps)
        free_card()
        events["shard_done"][rank].set()
        laps = Laps()
        laps("wait for the parent's single device")
        wait_parent(events["tp"], parent)
        if rank == 0:
            tp_one(tmp, laps)
        laps("wait for (b)'s single device")
        dist.barrier()
        tp_rank(rank, world, tmp, laps)
        free_card()
        laps("wait for the other rank")
        dist.barrier()
        if rank == 0:
            tp_moe_one(tmp, laps)
        laps()
        torch.save(laps.rows, os.path.join(tmp, f"tp_walls{rank}.pt"))
    finally:
        dist.destroy_process_group()


def main(exits: contextlib.ExitStack) -> int:
    """The phases, in order; `exits` stops the processes they start and
    removes their directories when the script ends, whatever the way."""
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card", file=sys.stderr)
        return 2
    from repro_torch.analysis import registry as lint_registry
    from repro_torch.analysis import sass as lint_sass
    from repro_torch.analysis import smem as lint_smem
    from repro_torch.configs import get_config, smoke_config
    from repro_torch.core.inner_product import online_dot as oracle_dot
    from repro_torch.core.numerics import DotEngine
    from repro_torch.core.online_mul import online_multiply
    from repro_torch.core.precision import OnlinePrecision
    from repro_torch.kernels import build
    from repro_torch.kernels.online_dot import kernel as k3
    from repro_torch.kernels.online_dot import matmul_kernel as k12
    from repro_torch.kernels.online_dot import tuning
    from repro_torch.kernels.online_dot.matmul import (_quantize_tiles,
                                                       _tile_plan,
                                                       olm_matmul,
                                                       olm_matmul_ref)
    from repro_torch.kernels.online_dot.ops import online_dot
    from repro_torch.kernels.online_dot.ref import (online_dot_batch_ref,
                                                    tree_levels)
    from repro_torch.kernels.online_mul import kernel as k4
    from repro_torch.kernels.online_mul.ops import online_mul
    from repro_torch.kernels.online_mul.ref import online_mul_batch_ref
    from repro_torch.kernels.tpmm import kernel as k5
    from repro_torch.kernels.tpmm import ops as tpmm_ops
    from repro_torch.kernels.tpmm.ops import (decompose_operands,
                                              tpmm_cost_model)
    from repro_torch.kernels.tpmm.ref import tpmm_ref
    from repro_torch.data.synthetic import SyntheticLMDataset
    from repro_torch.distributed.train import (build_train_step, cast_params,
                                               gather_state,
                                               init_train_state)
    from repro_torch.launch import train as train_cli
    from repro_torch.models.model import Model, lm_loss
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.optim.schedule import cosine_schedule
    from repro_torch.serving.engine import Request, ServeEngine
    from repro_torch.tree import tree_flatten, tree_leaves, tree_unflatten

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    def reset_counts():
        k12.launches = k12.host_launches = 0
        k3.launches = k4.launches = k5.launches = 0

    def read_counts():
        return {"olm_matmul_fused": k12.launches,
                "olm_matmul_host": k12.host_launches,
                "online_dot": k3.launches, "online_mul": k4.launches,
                "tpmm": k5.launches}

    walls, running = {}, []
    # the running phase's parts: part(name) closes the running part,
    # printing its wall on a line of its own, and opens `name`
    part = Laps(lambda name, s: print(
        f"[wall] part {running[-1][0]} {name}: {s:.1f} s", flush=True))

    def phase(name):
        """Close the running phase (and its running part), printing its wall
        on a line of its own, and open `name` (None closes the last)."""
        part()
        now = time.monotonic()
        if running:
            done, t0 = running.pop()
            walls[done] = now - t0
            print(f"[wall] phase {done}: {now - t0:.1f} s", flush=True)
        if name is not None:
            running.append((name, now))

    # 1. device --------------------------------------------------------
    phase("device")
    name, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    smi_line = smi("name,power.limit")
    clock_mhz = float(smi("clocks.max.sm").split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    print(f"[device] {name} x{count}, {sms} SMs, max SM clock {clock_mhz} MHz, "
          f"torch {torch.__version__} cuda {torch.version.cuda}; {smi_line}",
          flush=True)
    rate = sms * INT_OPS_PER_SM_CLOCK * clock_mhz * 1e6

    def plain_olm(xs, ws, a=0, b=None, n=16, p=None):
        """The plain version on columns a:b of w, PLAIN_OUTPUTS outputs a
        call."""
        b = ws.shape[1] if b is None else b
        step = max(1, PLAIN_OUTPUTS // xs.shape[0])
        return torch.cat([olm_matmul_ref(xs, ws[:, c:min(c + step, b)],
                                         n_bits=n, trunc=p)
                          for c in range(a, b, step)], dim=1)

    def k1_spans(N, whole):
        """The columns K1 is held on: all, or the first and the last
        K1_SLICE."""
        return ([(0, N)] if whole or N <= 2 * K1_SLICE
                else [(0, K1_SLICE), (N - K1_SLICE, N)])

    # The check phase's K1/K2 plain versions at every model's GEMM shapes
    # (the serve's, the dense family's M = 4 GEMMs, the recurrent, MoE,
    # enc-dec and VLM families'), on the columns and rows it holds the
    # kernels on, run on the card on a stream of their own, from a thread,
    # while nvcc builds the kernels on the host and the lint phase reads
    # them; the check phase draws the same operands again from their
    # seeds.
    WIDE_K1 = ((CHATGLM_KN, "chatglm3_6b", True),
               (CUT_KN, "yi_34b / qwen1_5_110b", False))
    side = torch.cuda.Stream(dev)

    def family_rows(arch):
        return (4,) + (RG_ROWS if arch == "recurrentgemma_9b" else ())

    def enc_spans():
        return ((0, ENC_CHECK_ROWS), (ENC_ROWS - ENC_CHECK_ROWS, ENC_ROWS))

    def plain_wide():
        out = {}
        t0 = time.monotonic()
        with torch.cuda.stream(side):
            for shape in SERVE_SHAPES:
                out[shape] = plain_olm(*operands(shape, 2, dev))
            for kns, _, whole in WIDE_K1:
                for K, N in kns:
                    xs, ws = operands((4, K, N), 13, dev)
                    out[(4, K, N)] = [plain_olm(xs, ws, a, b)
                                      for a, b in k1_spans(N, whole)]
            for arch, kns in FAMILY_KN.items():
                for M in family_rows(arch):
                    for K, N in kns:
                        xs, ws = operands((M, K, N), 15, dev)
                        out[(arch, M, K, N)] = [
                            plain_olm(xs, ws, a, b) for a, b in k1_spans(
                                N, M < 64 and N <= WHOLE_N)]
            for arch, kns in CROSS_KN.items():
                for K, N in kns:
                    xs, ws = operands((4, K, N), 17, dev)
                    out[(arch, 4, K, N)] = [
                        plain_olm(xs, ws, a, b)
                        for a, b in k1_spans(N, N <= WHOLE_N)]
                for K, N in CROSS_ROWS_KN[arch]:
                    xs, ws = operands((ENC_ROWS, K, N), 18, dev)
                    out[(arch, ENC_ROWS, K, N)] = [
                        plain_olm(xs[a:b].contiguous(), ws)
                        for a, b in enc_spans()]
            side.synchronize()
        return out, time.monotonic() - t0

    ahead = concurrent.futures.ThreadPoolExecutor(max_workers=1)
    wide = ahead.submit(plain_wide)

    # 2. build ---------------------------------------------------------
    phase("build")
    t0 = time.monotonic()
    built = build.build([k12.SOURCE, k3.SOURCE, k4.SOURCE, k5.SOURCE])
    for b in built.values():
        print(f"[build] {b.source}: {b.seconds:.1f} s; "
              f"{ptxas_summary(b.log)}")
    print(f"[build] all kernels in {time.monotonic() - t0:.1f} s", flush=True)

    # 2b. the static analyzer's card half -------------------------------
    phase("lint")
    violations, reports, exempt = lint_sass.run()
    print(f"[lint] SASS contracts over cuobjdump -sass of "
          f"{', '.join(reports)}: {len(violations)} violation(s); "
          f"instructions of the compiler's IEEE division slow path (the "
          f"subroutine FCHK calls, exempt): {exempt}", flush=True)
    for kernel, row in lint_sass.summarize(reports).items():
        print(f"[lint] {kernel}: {row['instances']} instances, registers "
              f"{row['registers'][0]}-{row['registers'][1]}, spill stores "
              f"{row['spill_stores']} B, spill loads {row['spill_loads']} B, "
              f"static smem up to {row['smem']} B")
    geometry = {"olm_matmul_fused": k12.geometry,
                "olm_matmul_host": k12.geometry, "online_dot": k3.geometry,
                "online_dot_any": k3.geometry, "tpmm": k5.geometry}
    cases = lint_registry.iter_cases() + lint_smem.tuning_cases()
    held = 0
    for case in cases:
        violations += lint_smem.check_plan(case)
        if case.kernel in geometry:
            violations += lint_smem.check_geometry(case,
                                                   geometry[case.kernel])
            held += 1
    mul = [k for k in reports["online_mul.cu"] if "online_mul_kernel" in k]
    print(f"[lint] {len(cases)} launch plans ({len(cases) - held} registry "
          f"plans of K4 held against ptxas's static shared memory of its "
          f"{len(mul)} instances, {len(lint_smem.tuning_cases())} "
          f"tuning_torch.json entries) against Hopper's limits; {held} "
          f"against the card's own shared memory and occupancy", flush=True)
    x, w = operands((5, 70, 37), 31, dev)
    xd, yd = digits((37, 16, 16), 32, dev)
    ap, bp, sa, sb = decompose_operands(x, w, n_bits=16)
    outputs = {
        "olm_matmul_fused": k12.olm_matmul_fused(x, w, n=16),
        "olm_matmul_host": olm_matmul(x, w, n_bits=16, quantize="host"),
        "online_dot": k3.online_dot_kernel(xd, yd, OnlinePrecision(n=16)),
        "online_dot_any": k3.online_dot_kernel(
            xd, yd, OnlinePrecision(n=16, delta=4)),
        "online_mul": k4.online_mul_kernel(xd[:, 0].contiguous(),
                                           yd[:, 0].contiguous(),
                                           OnlinePrecision(n=16)),
        "tpmm": k5.tpmm_kernel(ap, bp, sa, sb, n_bits=16)}
    torch.cuda.current_stream().synchronize()
    for kernel, out in outputs.items():
        violations += lint_sass.check_dtype(kernel, str(out.dtype),
                                            where=f"{kernel} small launch")
    print(f"[lint] output dtypes of one small launch each: "
          f"{ {k: str(v.dtype) for k, v in outputs.items()} }", flush=True)
    if violations:
        kinds = {}
        for v in violations:
            kinds.setdefault((v.contract, v.detail.split(": ")[-1].split()[0]),
                             v)
        for (contract, what), v in kinds.items():
            print(f"[lint] {contract} ({what}), first at {v.where}: "
                  f"{v.detail}", flush=True)
        raise SystemExit(f"the lint phase found {len(violations)} "
                         f"violation(s) of {len(kinds)} kinds")
    print("[lint] no violation", flush=True)
    del x, w, xd, yd, ap, bp, outputs

    # 3. each kernel against its plain version, bit for bit -------------
    phase("check")
    # The dryrun phase's production cells walk on meta tensors in
    # subprocesses of their own, on the host's CPU: started here, while the
    # check and time phases keep the card busy and the host mostly idle;
    # the dryrun phase reads them.
    out_dir = tempfile.mkdtemp(prefix="dryrun_torch_")
    exits.callback(shutil.rmtree, out_dir, ignore_errors=True)
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    procs = []
    for i, (arch, shape, *more) in enumerate(DRYRUN_CELLS):
        # each cell's output to a file: no pipe fills while nothing reads
        with open(Path(out_dir, f"cell{i}.log"), "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
                 arch, "--shape", shape, *more, "--out", out_dir], cwd=ROOT,
                env=env, stdout=log, stderr=subprocess.STDOUT))

    def stop_cells():
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()

    exits.callback(stop_cells)
    max_err = dict.fromkeys(read_counts(), 0.0)

    def hold(kernel, label, got, want):
        torch.cuda.synchronize()
        err = float((got.double() - want.double()).abs().max())
        max_err[kernel] = max(max_err[kernel], err)
        ok = bits_equal(got, want)
        if got.is_floating_point():
            ok = ok and bool(torch.isfinite(got).all())
        print(f"[check] {kernel} {label}: bit-identical={ok} "
              f"max_abs_err={err}", flush=True)
        if not ok:
            raise SystemExit(f"{kernel} disagrees with its plain version at "
                             f"{label}")

    def hold_both(label, xs, ws, n, p=None, transposed=False, want=None):
        """K1 and K2 against the plain version (`want`, else computed
        here) and K2 against K1; K1 also reading w through the transpose
        of an (N, K) row-major copy."""
        if want is None:
            want = plain_olm(xs, ws, n=n, p=p)
        fused = olm_matmul(xs, ws, n_bits=n, trunc=p)
        hold("olm_matmul_fused", label, fused, want)
        if transposed:
            hold("olm_matmul_fused", f"{label} w transposed",
                 olm_matmul(xs, ws.t().contiguous().t(), n_bits=n, trunc=p),
                 want)
        host = olm_matmul(xs, ws, n_bits=n, trunc=p, quantize="host")
        hold("olm_matmul_host", label, host, want)
        hold("olm_matmul_host", f"{label} against olm_matmul_fused", host,
             fused)

    part("K1/K2 ragged, edges, subnormal tile")
    x, w = operands(RAGGED, 1, dev)
    olm_modes = sorted(m for m in DotEngine.modes() if m.startswith("olm"))
    for mode in olm_modes:
        hold_both(f"{mode} M,K,N={RAGGED}", x, w, *mode_bits(mode))
    for shape in K12_EDGES:
        xs, ws = operands(shape, 12, dev)
        for mode in K12_EDGE_MODES:
            hold_both(f"{mode} M,K,N={shape}", xs, ws, *mode_bits(mode),
                      transposed=True)
    sub = x.clone()
    sub[0, :16] = 1e-40                      # an all-subnormal K tile
    zeroed = sub.clone()
    zeroed[0, :16] = 0.0
    hold_both(f"olm16 subnormal tile M,K,N={RAGGED}", sub, w, 16)
    for quantize in ("kernel", "host"):
        if not bits_equal(olm_matmul(sub, w, quantize=quantize),
                          olm_matmul(zeroed, w, quantize=quantize)):
            raise SystemExit("an all-subnormal tile did not contribute "
                             f"exactly 0 (quantize={quantize!r})")
    print("[check] all-subnormal tile contributes exactly 0 in K1 and K2: "
          "True")
    # F7: row blocks past grid y's 65,535 continue in grid z
    part("K1/K2 tall (F7)")
    M, K, N = TALL
    xs, ws = operands(TALL, 23, dev)
    grids = [k12.launch_plan(M, N, K, 16, host=host).launch_grid
             for host in (False, True)]
    fused = olm_matmul(xs, ws, n_bits=16)
    host = olm_matmul(xs, ws, n_bits=16, quantize="host")
    edge = 65535 * 8
    for a, b in ((0, TALL_ROWS), (edge - TALL_ROWS // 2, edge + TALL_ROWS // 2),
                 (M - TALL_ROWS, M)):
        want = olm_matmul_ref(xs[a:b].contiguous(), ws, n_bits=16)
        hold("olm_matmul_fused", f"olm16 M,K,N={TALL} rows {a}:{b} (launch "
             f"grid {grids[0]})", fused[a:b].contiguous(), want)
        hold("olm_matmul_host", f"olm16 M,K,N={TALL} rows {a}:{b} (launch "
             f"grid {grids[1]})", host[a:b].contiguous(), want)
    del xs, ws, fused, host, want
    torch.cuda.empty_cache()

    part("K4 and K3")
    for n, truncated in MUL_CASES:
        cfg = OnlinePrecision(n=n, truncated=truncated, tail_gating=truncated)
        xd, yd = digits((MUL_B, n), n, dev)
        want, _ = online_mul_batch_ref(xd, yd, n=n, truncated=truncated,
                                       tail_gating=truncated)
        hold("online_mul", f"B={MUL_B} n={n} "
             f"{'truncated' if truncated else 'full'}",
             k4.online_mul_kernel(xd, yd, cfg), want)
    xd, yd = digits((MUL_B - 37, 16), 3, dev)   # a ragged last block
    want, _ = online_mul_batch_ref(xd, yd, n=16)
    hold("online_mul", f"B={MUL_B - 37} n=16 truncated",
         k4.online_mul_kernel(xd, yd, OnlinePrecision(n=16)), want)
    for B, K, n, truncated in (tuple((DOT_B, K, n, True) for K, n in DOT_CASES)
                               + DOT_EDGES):
        cfg = OnlinePrecision(n=n, truncated=truncated, tail_gating=truncated)
        xd, yd = digits((B, K, n), K + n, dev)
        hold("online_dot", f"B={B} K={K} n={n} "
             f"{'truncated' if truncated else 'full'}",
             k3.online_dot_kernel(xd, yd, cfg),
             online_dot_batch_ref(xd, yd, n=n, truncated=truncated,
                                  tail_gating=truncated))
    B, K, n = DOT_OFFSET
    xd, yd = digits((B * K * n + 1,), 11, dev)
    xd, yd = xd[1:].view(B, K, n), yd[:-1].view(B, K, n)
    hold("online_dot", f"operands at a 4-byte offset B={B} K={K} n={n}",
         k3.online_dot_kernel(xd, yd, OnlinePrecision(n=n)),
         online_dot_batch_ref(xd, yd, n=n))
    # the paper's scalar model (core/inner_product, core/online_mul) as a
    # second oracle, independent of the plain versions, row by row
    part("K3 and K4 against the scalar model")
    B, K, n = ORACLE_DOT
    cfg = OnlinePrecision(n=n)
    xd, yd = digits((B, K, n), 21, dev)
    xl, yl = xd.cpu().tolist(), yd.cpu().tolist()
    t0 = time.monotonic()
    want = torch.tensor([oracle_dot(xl[b], yl[b], cfg).digits
                         for b in range(B)], dtype=torch.int32, device=dev)
    hold("online_dot", f"B={B} K={K} n={n} against the scalar model "
         f"core.inner_product.online_dot ({time.monotonic() - t0:.1f} s)",
         k3.online_dot_kernel(xd, yd, cfg), want)
    B, n = ORACLE_MUL
    cfg = OnlinePrecision(n=n)
    xd, yd = digits((B, n), 22, dev)
    xl, yl = xd.cpu().tolist(), yd.cpu().tolist()
    want = torch.tensor([online_multiply(xl[b], yl[b], cfg).z_digits
                         for b in range(B)], dtype=torch.int32, device=dev)
    hold("online_mul", f"B={B} n={n} against the scalar model "
         "core.online_mul.online_multiply", k4.online_mul_kernel(xd, yd, cfg),
         want)
    del xd, yd, want
    part("K3 and K4 general")
    for kw in GENERAL_CONFIGS + (dict(n=40),):
        cfg = OnlinePrecision(**kw)
        xd, yd = digits((GENERAL_MUL_B, cfg.n), cfg.n + cfg.delta, dev)
        before = k4.launches
        got, _ = online_mul(xd, yd, cfg)
        if k4.launches != before + 1:
            raise SystemExit(f"online_mul {kw} did not launch its kernel")
        want, _ = online_mul_batch_ref(
            xd, yd, n=cfg.n, delta=cfg.delta, t=cfg.t,
            truncated=cfg.truncated, tail_gating=cfg.tail_gating)
        hold("online_mul", f"B={GENERAL_MUL_B} {kw} ({k4.route(cfg)} kernel)",
             got, want)
    for K, kw in GENERAL_DOT:
        cfg = OnlinePrecision(**kw)
        B = GENERAL_DOT_B if K <= 5000 else 3
        xd, yd = digits((B, K, cfg.n), K + cfg.delta, dev)
        before = k3.launches
        got, _ = online_dot(xd, yd, cfg)
        if k3.launches != before + 1:
            raise SystemExit(f"online_dot K={K} {kw} did not launch its "
                             "kernel")
        hold("online_dot", f"B={B} K={K} {kw} "
             f"({k3.route(cfg, K)} kernel)", got,
             online_dot_batch_ref(xd, yd, n=cfg.n, delta=cfg.delta, t=cfg.t,
                                  truncated=cfg.truncated,
                                  tail_gating=cfg.tail_gating))
    part("K3 past 1024 lanes")
    for B, K, n in LONG_CHECKS:
        cfg = OnlinePrecision(n=n)
        xd, yd = digits((B, K, n), K + 3 * n, dev)
        trees = -(-K // k3.MAX_LANES)
        hold("online_dot", f"B={B} K={K} n={n} ({k3.route(cfg, K)} kernel, "
             f"{trees} subtree{'s' if trees > 1 else ''} a row)",
             k3.online_dot_kernel(xd, yd, cfg),
             online_dot_batch_ref(xd, yd, n=n))
    part("K3 and K4 F6")
    # F6: the general kernels' int64 lanes where the residual leaves int32
    for kw in F6_CONFIGS:
        cfg = OnlinePrecision(**kw)
        bits = k4.check_config(cfg)[2]
        xd, yd = digits((GENERAL_MUL_B, cfg.n), 40 + cfg.n, dev)
        before = k4.launches
        got, _ = online_mul(xd, yd, cfg)
        if k4.launches != before + 1:
            raise SystemExit(f"online_mul {kw} did not launch its kernel")
        want, _ = online_mul_batch_ref(xd, yd, **kw)
        hold("online_mul", f"F6 B={GENERAL_MUL_B} lanes {kw} "
             f"({k4.route(cfg)} kernel, {bits}-bit lanes)", got, want)
    K, kw, B = F6_DOT
    cfg = OnlinePrecision(**kw)
    bits = k4.check_config(cfg)[2]
    xd, yd = digits((B, K, cfg.n), 41, dev)
    before = k3.launches
    got, _ = online_dot(xd, yd, cfg)
    if k3.launches != before + 1:
        raise SystemExit(f"online_dot K={K} {kw} did not launch its kernel")
    hold("online_dot", f"F6 B={B} K={K} ({B * K} lanes) {kw} "
         f"({k3.route(cfg, K)} kernel, {bits}-bit lanes)", got,
         online_dot_batch_ref(xd, yd, **kw))
    for unheld in (UNHELD, F6_UNHELD):
        cfg = OnlinePrecision(**unheld)
        xd, yd = digits((GENERAL_DOT_B, 4, cfg.n), 5, dev)
        before = (k3.launches, k4.launches)
        for api, call in (("online_mul", lambda: online_mul(
                xd[:, 0].contiguous(), yd[:, 0].contiguous(), cfg)),
                          ("online_dot", lambda: online_dot(xd, yd, cfg))):
            try:
                call()
            except ValueError as e:
                print(f"[check] {api} {unheld}: raises before any launch "
                      f"({str(e)[:60]}...)", flush=True)
            else:
                raise SystemExit(f"{api} {unheld} did not raise")
        if (k3.launches, k4.launches) != before:
            raise SystemExit(f"{unheld} launched a kernel")
    del xd, yd, got, want

    subrow = x.clone()
    subrow[1] = 1e-40                        # an all-subnormal row

    def tpmm_cases(n_bits):
        """(label, operands) of every K5 check at one width."""
        yield (f"M,K,N={RAGGED}", decompose_operands(x, w, n_bits=n_bits))
        yield (f"subnormal row M,K,N={RAGGED}",
               decompose_operands(subrow, w, n_bits=n_bits))
        for shape in TPMM_EDGES:
            yield (f"M,K,N={shape}",
                   decompose_operands(*operands(shape, 9, dev), n_bits=n_bits))
        ap, *rest = decompose_operands(*operands(TPMM_ODD, 10, dev),
                                       n_bits=n_bits)
        odd = torch.empty(ap.numel() + 1, dtype=torch.int8,
                          device=dev)[1:].view(ap.shape)
        odd.copy_(ap)
        yield (f"A planes at an odd address M,K,N={TPMM_ODD}", (odd, *rest))
        for shape in SERVE_SHAPES:
            yield (f"M,K,N={shape}",
                   decompose_operands(*operands(shape, 4, dev), n_bits=n_bits))

    part("K5")
    for n_bits in (16, 8):
        for label, ops in tpmm_cases(n_bits):
            for mode in TPMM_MODES:
                hold("tpmm", f"tpmm{n_bits} {mode} {label}",
                     k5.tpmm_kernel(*ops, n_bits=n_bits, mode=mode),
                     tpmm_ref(*ops, n_bits=n_bits, mode=mode))
    del ops
    part("smoke model")
    scfg = dataclasses.replace(smoke_config(SERVE["arch"]),
                               compute_dtype="float32")
    cpu_model = Model(scfg, device="cpu")
    cpu_params = cpu_model.init(seed=0)
    gpu_params = {k: ([{a: {b: t.to(dev) for b, t in d.items()}
                        for a, d in layer.items()} for layer in v]
                      if k == "layers" else {b: t.to(dev) for b, t in v.items()})
                  for k, v in cpu_params.items()}
    toks = torch.from_numpy(np.random.default_rng(0)
                            .integers(0, scfg.vocab_size, (2, 7)))
    for mode in SERVE["modes"]:
        cpu_model = Model(scfg, DotEngine(mode=mode), device="cpu")
        gpu_model = Model(scfg, DotEngine(mode=mode), device=dev)
        want, _, _ = cpu_model.prefill(cpu_params, {"tokens": toks},
                                       cpu_model.init_cache(2, 8))
        got, _, _ = gpu_model.prefill(gpu_params, {"tokens": toks},
                                      gpu_model.init_cache(2, 8))
        rel = rel_real(got.cpu(), want, scfg.vocab_size)
        print(f"[check] smoke model {mode} f32 prefill logits, card vs CPU: "
              f"rel err {rel:.3e} (limit 1e-3)", flush=True)
        if not rel <= 1e-3:
            raise SystemExit(f"smoke model under {mode} on the card disagrees "
                             "with the CPU")

    # the checks that need no plain version from the side stream run
    # while it finishes; then the GEMM shapes it computed them for
    part("wait for the plain versions")
    t0 = time.monotonic()
    wants, side_s = wide.result()
    ahead.shutdown()
    torch.cuda.current_stream().wait_stream(side)
    side.synchronize()
    print(f"[check] the plain versions computed since the build phase "
          f"({side_s:.1f} s on their stream) ready after "
          f"{time.monotonic() - t0:.1f} s more", flush=True)
    part("K1/K2 serve shapes")
    for shape in SERVE_SHAPES:
        hold_both(f"olm16 M,K,N={shape}", *operands(shape, 2, dev), 16,
                  want=wants.pop(shape))
        torch.cuda.empty_cache()

    def hold_k1(label, xs, ws, whole, wants=None):
        """K1 on the whole GEMM against the plain version on all of its
        columns, or on the first and the last K1_SLICE (`wants`, one a
        span, else computed here)."""
        got = olm_matmul(xs, ws, n_bits=16)
        spans = k1_spans(ws.shape[1], whole)
        if wants is None:
            wants = [plain_olm(xs, ws, a, b) for a, b in spans]
        for (a, b), want in zip(spans, wants):
            hold("olm_matmul_fused", f"{label} columns {a}:{b}",
                 got[:, a:b].contiguous(), want)

    # (K1's 64-row prefill is held at the serve shapes above)
    part("K1 dense shapes")
    for kns, arch, whole in WIDE_K1:
        for K, N in kns:
            xs, ws = operands((4, K, N), 13, dev)
            hold_k1(f"olm16 {arch} M,K,N={(4, K, N)}", xs, ws, whole,
                    wants.pop((4, K, N)))
            del xs, ws
            torch.cuda.empty_cache()
    part("K1 family shapes")
    for arch, kns in FAMILY_KN.items():
        for M in family_rows(arch):
            for K, N in kns:
                xs, ws = operands((M, K, N), 15, dev)
                hold_k1(f"olm16 {arch} M,K,N={(M, K, N)}", xs, ws,
                        M < 64 and N <= WHOLE_N, wants.pop((arch, M, K, N)))
                del xs, ws
                torch.cuda.empty_cache()
    part("K1 cross shapes")
    for arch, kns in CROSS_KN.items():
        for K, N in kns:
            xs, ws = operands((4, K, N), 17, dev)
            hold_k1(f"olm16 {arch} M,K,N={(4, K, N)}", xs, ws,
                    N <= WHOLE_N, wants.pop((arch, 4, K, N)))
            del xs, ws
            torch.cuda.empty_cache()
        for K, N in CROSS_ROWS_KN[arch]:
            xs, ws = operands((ENC_ROWS, K, N), 18, dev)
            got = olm_matmul(xs, ws, n_bits=16)
            for (a, b), want in zip(enc_spans(),
                                    wants.pop((arch, ENC_ROWS, K, N))):
                hold("olm_matmul_fused", f"olm16 {arch} M,K,N="
                     f"{(ENC_ROWS, K, N)} rows {a}:{b}",
                     got[a:b].contiguous(), want)
            del xs, ws, got
            torch.cuda.empty_cache()
    assert not wants, wants.keys()


    # 4. times ---------------------------------------------------------
    phase("time")
    timed = {}

    def record(kernel, label, ms, plain_ms, byte_count, ops, op_rate,
               context=None):
        b_ms, by, byte_ms, op_ms = bound(byte_count, ops, op_rate)
        if ms < b_ms:
            raise SystemExit(f"{kernel} {label} timed {ms:.4f} ms, below its "
                             f"bound {b_ms:.4f} ms: the bound or the timing "
                             "is wrong")
        row = dict(label=label, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                   bound_by=by, context=context)
        timed.setdefault(kernel, []).append(row)
        ctx = f"; context {context}" if context else ""
        plain = ("not timed" if plain_ms is None
                 else f"{plain_ms:.3f} ms")
        print(f"[time] {kernel} {label}: {ms:.4f} ms; bound {b_ms:.4f} ms "
              f"({by}: bytes {byte_ms:.4f} ms, operations {op_ms:.4f} ms); "
              f"plain version {plain}{ctx}", flush=True)

    part("K1/K2 decode and prefill")
    for label, shape in (("decode_gemv", DECODE_GEMV),
                         ("prefill_gemm", PREFILL_GEMM)):
        M, K, N = shape
        x, w = operands(shape, 3, dev)
        mm_ms = cuda_ms(lambda: torch.matmul(x, w), reps=20, warmup=3)
        plain_ms = cuda_ms(lambda: olm_matmul_ref(x, w, n_bits=16), reps=1)
        ctx = f"torch.matmul f32 (not the same function) {mm_ms:.4f} ms"
        plans = [k12.launch_plan(M, N, K, 16, host=host, vec=host)
                 for host in (False, True)]
        planned = [f"{ctx}; plan bm x bn x tb {p.bm} x {p.bn} x {p.tb}"
                   for p in plans]
        record("olm_matmul_fused", f"olm16 {label} M={M} K={K} N={N}",
               cuda_ms(lambda: k12.olm_matmul_fused(x, w, n=16), reps=10,
                       warmup=2), plain_ms, (M * K + K * N + M * N) * 4,
               k12.int_ops(M, N, K, n=16), rate, planned[0])
        kt, T, xp, wpT = _tile_plan(x, w, 16)
        xd, sx = (t.contiguous() for t in _quantize_tiles(xp, kt, T, 16))
        wd, sw = (t.contiguous() for t in _quantize_tiles(wpT, kt, T, 16))
        grids = (xd.numel() + wd.numel() + sx.numel() + sw.numel()) * 4
        record("olm_matmul_host", f"olm16 {label} M={M} K={K} N={N}",
               cuda_ms(lambda: k12.olm_matmul_host(xd, sx, wd, sw, n=16),
                       reps=10, warmup=2), plain_ms, grids + M * N * 4,
               k12.int_ops(M, N, K, n=16, quantize=False), rate,
               planned[1])
        del xd, wd
    def timed_plain(x, w):
        """The plain olm16 version's time where its work is at most
        PLAIN_TIMED_WORK, else None (not timed)."""
        (M, K), N = x.shape, w.shape[1]
        return (cuda_ms(lambda: plain_olm(x, w), reps=1)
                if M * K * N <= PLAIN_TIMED_WORK else None)

    # K1 at ChatGLM3-6B's GEMMs: the 4-lane decode and the 64-row prefill
    # of the dense phase's serve
    part("K1 chatglm3 shapes")
    for M in (4, 64):
        for K, N in CHATGLM_KN:
            x, w = operands((M, K, N), 14, dev)
            plan = k12.launch_plan(M, N, K, 16)
            record("olm_matmul_fused", f"olm16 chatglm3_6b M={M} K={K} N={N}",
                   cuda_ms(lambda: k12.olm_matmul_fused(x, w, n=16),
                           reps=10 if M == 4 else 5, warmup=1),
                   timed_plain(x, w), (M * K + K * N + M * N) * 4,
                   k12.int_ops(M, N, K, n=16), rate,
                   f"plan bm x bn x tb {plan.bm} x {plan.bn} x {plan.tb}")
            del x, w
    # K1 at the recurrent and MoE families' decode GEMMs
    part("K1 family shapes")
    for arch, kns in FAMILY_KN.items():
        for K, N in kns:
            x, w = operands((4, K, N), 16, dev)
            plan = k12.launch_plan(4, N, K, 16)
            record("olm_matmul_fused", f"olm16 {arch} M=4 K={K} N={N}",
                   cuda_ms(lambda: k12.olm_matmul_fused(x, w, n=16), reps=5,
                           warmup=1),
                   timed_plain(x, w), (4 * K + K * N + 4 * N) * 4,
                   k12.int_ops(4, N, K, n=16), rate,
                   f"plan bm x bn x tb {plan.bm} x {plan.bn} x {plan.tb}")
            del x, w
            torch.cuda.empty_cache()
    # K1 at the enc-dec and VLM families' new shapes: a 4-lane decode and
    # the ENC_ROWS-row cross K/V and encoder GEMMs
    part("K1 cross shapes")
    for arch, kns in CROSS_KN.items():
        for M, K, N in ([(4, K, N) for K, N in kns]
                        + [(ENC_ROWS, K, N) for K, N in CROSS_ROWS_KN[arch]]):
            x, w = operands((M, K, N), 19, dev)
            plan = k12.launch_plan(M, N, K, 16)
            record("olm_matmul_fused", f"olm16 {arch} M={M} K={K} N={N}",
                   cuda_ms(lambda: k12.olm_matmul_fused(x, w, n=16),
                           reps=5 if M == 4 else 3, warmup=1),
                   timed_plain(x, w), (M * K + K * N + M * N) * 4,
                   k12.int_ops(M, N, K, n=16),
                   rate, f"plan bm x bn x tb {plan.bm} x {plan.bn} x "
                   f"{plan.tb}")
            del x, w
            torch.cuda.empty_cache()
    part("K4, K3 and the general kernels")
    for n, truncated in MUL_CASES[:4]:
        cfg = OnlinePrecision(n=n)
        xd, yd = digits((MUL_B, n), n, dev)
        record("online_mul", f"B={MUL_B} n={n}",
               cuda_ms(lambda: k4.online_mul_kernel(xd, yd, cfg), reps=20,
                       warmup=2),
               cuda_ms(lambda: online_mul_batch_ref(xd, yd, n=n), reps=1),
               3 * MUL_B * n * 4, k4.int_ops(MUL_B, cfg), rate)
    for K, n in DOT_CASES:
        cfg = OnlinePrecision(n=n)
        xd, yd = digits((DOT_B, K, n), K + n, dev)
        m = n + 2 * tree_levels(K)
        record("online_dot", f"B={DOT_B} K={K} n={n}",
               cuda_ms(lambda: k3.online_dot_kernel(xd, yd, cfg), reps=20,
                       warmup=2),
               cuda_ms(lambda: online_dot_batch_ref(xd, yd, n=n), reps=1),
               (2 * DOT_B * K * n + DOT_B * m) * 4,
               k3.int_ops(DOT_B, K, cfg), rate)
    for K, kw, B in GENERAL_TIMED:
        cfg = OnlinePrecision(**kw)
        n = cfg.n
        kw_ref = dict(n=n, delta=cfg.delta, t=cfg.t)
        if K is None:
            xd, yd = digits((B, n), n, dev)
            record("online_mul",
                   f"general B={B} {kw} ({k4.route(cfg)} kernel)",
                   cuda_ms(lambda: k4.online_mul_kernel(xd, yd, cfg),
                           reps=20, warmup=2),
                   cuda_ms(lambda: online_mul_batch_ref(xd, yd, **kw_ref),
                           reps=1),
                   3 * B * n * 4, k4.int_ops(B, cfg), rate)
            continue
        xd, yd = digits((B, K, n), K + n, dev)
        m = n + 2 * tree_levels(K)
        record("online_dot", f"general B={B} K={K} {kw} ({k3.route(cfg, K)} "
               "kernel)",
               cuda_ms(lambda: k3.online_dot_kernel(xd, yd, cfg), reps=20,
                       warmup=2),
               cuda_ms(lambda: online_dot_batch_ref(xd, yd, **kw_ref),
                       reps=1),
               (2 * B * K * n + B * m) * 4, k3.int_ops(B, K, cfg), rate)
    for B, K, n in LONG_TIMED:
        cfg = OnlinePrecision(n=n)
        xd, yd = digits((B, K, n), K + n, dev)
        m = n + 2 * tree_levels(K)
        record("online_dot", f"long B={B} K={K} n={n} ({k3.route(cfg, K)} "
               f"kernel, {-(-K // k3.MAX_LANES)} subtrees a row)",
               cuda_ms(lambda: k3.online_dot_kernel(xd, yd, cfg), reps=20,
                       warmup=2),
               cuda_ms(lambda: online_dot_batch_ref(xd, yd, n=n), reps=1),
               (2 * B * K * n + B * m) * 4, k3.int_ops(B, K, cfg), rate)
    del xd, yd
    part("K5")
    for n_bits, shapes in ((16, SERVE_SHAPES), (8, (DECODE_GEMV, PREFILL_GEMM))):
        for shape in shapes:
            M, K, N = shape
            x, w = operands(shape, 5, dev)
            ops = decompose_operands(x, w, n_bits=n_bits)
            cost = tpmm_cost_model(n_bits)
            D, pairs = cost["planes"], cost["pair_matmuls_truncated"]
            # context: one plane pair through torch._int_mm (int8 -> int32),
            # which needs more than 16 rows: M = 4 is padded to 32 rows
            a8 = torch.nn.functional.pad(ops[0][0], (0, 0, 0, max(0, 32 - M)))
            b8 = ops[1][0].contiguous()
            int_mm = cuda_ms(lambda: torch._int_mm(a8, b8), reps=10, warmup=2)
            dec_ms = cuda_ms(
                lambda: decompose_operands(x, w, n_bits=n_bits), reps=3)
            ctx = (f"torch._int_mm of one plane pair {int_mm:.4f} ms"
                   f"{' (rows padded to 32)' if M < 32 else ''}; plane "
                   f"decomposition of both operands {dec_ms:.4f} ms")
            record("tpmm", f"tpmm{n_bits} M={M} K={K} N={N}",
                   cuda_ms(lambda: k5.tpmm_kernel(*ops, n_bits=n_bits),
                           reps=21, warmup=2),
                   cuda_ms(lambda: tpmm_ref(*ops, n_bits=n_bits), reps=1),
                   D * (M * K + K * N) + 4 * (M + N) + 4 * M * N,
                   2 * M * N * K * pairs, INT8_OPS_PER_S, ctx)
            timed["tpmm"][-1]["int_mm_ms"] = int_mm
    del x, w, ops, a8, b8

    # 5. serve ---------------------------------------------------------
    phase("serve")
    _flush.clear()                           # keep the peak the serve's own
    torch.cuda.empty_cache()
    kernel_name = {"olm16": "olm_matmul_kernel", "tpmm16": "tpmm_kernel"}
    path_extra = {"olm16": [], "tpmm16": [("plane decomposition", tpmm_ops,
                                           "decompose_operands")]}
    path_kernel = {"olm16": ("olm_matmul_fused", k12, "olm_matmul_fused"),
                   "tpmm16": ("tpmm", k5, "tpmm_kernel")}
    launches, outputs, by_path = {}, {}, {}

    def describe(tag, cfg, cut=None):
        print(f"[{tag}] {cfg.name}: {cfg.n_layers} layers"
              f"{f' (depth cut from {cut})' if cut else ''}, d_model "
              f"{cfg.d_model}, {cfg.n_heads} heads / {cfg.n_kv_heads} KV "
              f"heads of {cfg.head_dim}, d_ff {cfg.d_ff}, vocab "
              f"{cfg.vocab_size}, qkv_bias {cfg.qkv_bias}, rope "
              f"{cfg.rope_style}; params {cfg.param_dtype} "
              f"({cfg.param_count() * 4 / 1e9:.1f} GB) from seed "
              f"{SERVE['seed']}, compute {cfg.compute_dtype}", flush=True)

    serve_stats = {}

    def serve(tag, cfg, params, mode, profile=True, engine_kw=None):
        """SERVE's workload through ServeEngine under `mode` (and
        `engine_kw`, ServeEngine's further keywords): a run with
        the launch counts set to 0 just before it (gates: every request
        answered, finite logits, launches == GEMMs issued; a model that
        cannot right-pad its prompts prefills each request alone at its
        exact length), a second with the path kernel's launches bracketed
        (the same tokens), under torch.profiler unless `profile` is False.
        Returns the first run's outputs by rid; its wall, GEMMs and, under
        dot_tiling="auto", the tuner cache's hits and misses go into
        serve_stats."""
        auto = (engine_kw or {}).get("dot_tiling") == "auto"
        part(f"{cfg.name} {mode} serve")
        model = Model(cfg, DotEngine(mode=mode), device=dev)
        prompt_lens = []

        def seeded_engine():
            engine = ServeEngine(model, params, slots=SERVE["slots"],
                                 max_len=SERVE["max_len"],
                                 kv_block_size=SERVE["block"], device=dev,
                                 **(engine_kw or {}))
            rng = np.random.default_rng(SERVE["seed"])
            lo, hi = SERVE["prompt"]
            for rid in range(SERVE["requests"]):
                prompt = rng.integers(0, cfg.vocab_size, int(rng.integers(
                    lo, hi + 1))).astype(np.int32)
                prompt_lens.append(len(prompt))
                engine.submit(Request(rid=rid, prompt=prompt,
                                      max_new_tokens=SERVE["max_new"]))
            return engine

        engine = seeded_engine()
        passes = {"prefill": 0, "decode": 0}
        finite, prefill_shapes = [], []

        def counted(kind, fn):
            def run(*a, **kw):
                out = fn(*a, **kw)
                passes[kind] += 1
                if kind == "prefill":
                    prefill_shapes.append(tuple(a[1]["tokens"].shape))
                finite.append(bool(torch.isfinite(out[0]).all()))
                return out
            return run

        engine.model.prefill = counted("prefill", engine.model.prefill)
        engine.model.decode_step = counted("decode", engine.model.decode_step)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        tuner = tuning.default_cache() if auto else None
        looked = (tuner.hits, tuner.misses) if auto else None
        reset_counts()
        t0 = time.monotonic()
        done = engine.run()
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        counts = read_counts()
        if auto:
            looked = (tuner.hits - looked[0], tuner.misses - looked[1])
        kernel, module, attr = path_kernel[mode]
        launches.setdefault(kernel, counts[kernel])
        by_path.setdefault(kernel, {})[f"{tag} {cfg.name} {mode}"] = \
            counts[kernel]
        per_pass = gemms_per_pass(cfg)
        gemms = (passes["prefill"] + passes["decode"]) * per_pass
        serve_stats[f"{tag} {mode}"] = dict(
            wall=wall, gemms=gemms, passes=passes["prefill"]
            + passes["decode"], tuner=looked)
        tokens = sum(len(r.output) for r in done)
        reasons = {r.rid: r.finish_reason
                   for r in sorted(done, key=lambda r: r.rid)}
        peak = torch.cuda.max_memory_allocated()
        print(f"[{tag}] {mode}: answered {len(done)}/{SERVE['requests']} "
              f"requests, {tokens} tokens, finish reasons {reasons}")
        print(f"[{tag}] {mode}: wall {wall:.3f} s (ends in "
              f"torch.cuda.synchronize), {tokens / wall:.3f} tokens/s, peak "
              f"memory {peak} bytes ({peak / 2**30:.2f} GiB)")
        print(f"[{tag}] {mode}: forward passes: {passes['prefill']} prefill, "
              f"{passes['decode']} decode; GEMMs issued {gemms} "
              f"({per_pass} a pass); kernel launches {counts}; prefill "
              f"shapes {prefill_shapes}", flush=True)
        kvr = engine.kv_report()
        print(f"[{tag}] {mode}: kv_report {dict(kvr)}", flush=True)
        if len(done) != SERVE["requests"]:
            raise SystemExit("not every request was answered")
        if any(r.finish_reason not in ("length", "eos") for r in done):
            raise SystemExit(f"unexpected finish reasons {reasons}")
        if not all(finite):
            raise SystemExit(f"non-finite logits in the {tag} phase")
        if counts[kernel] != gemms or gemms == 0:
            raise SystemExit(f"{kernel} launched {counts[kernel]} times for "
                             f"{gemms} GEMMs under {mode}")
        if not engine._bucketed and sorted(prefill_shapes) != sorted(
                (1, n) for n in prompt_lens):
            raise SystemExit(f"{cfg.name}: a prefill ran at another shape "
                             "than its request's exact length")

        # Where the serve time goes: the same requests again, every launch
        # of the path's kernel (and, under tpmm, every plane decomposition
        # of its operands) bracketed by CUDA events on its stream (an upper
        # bound on the device time: a gap while the host prepares a launch
        # counts too); with `profile`, the same run under torch.profiler
        # for the device's busy share.
        part(f"{cfg.name} {mode} serve again, bracketed"
             + (" and profiled" if profile else ""))
        engine = seeded_engine()
        parts = [(kernel, module, attr), *path_extra[mode]]
        spans = {label: [] for label, _, _ in parts}

        def bracketed(label, wrapped):
            def run(*a, **kw):
                start = torch.cuda.Event(enable_timing=True)
                stop = torch.cuda.Event(enable_timing=True)
                start.record()
                out = wrapped(*a, **kw)
                stop.record()
                spans[label].append((start, stop))
                return out
            return run

        originals = [getattr(m, at) for _, m, at in parts]
        for (label, m, at), fn in zip(parts, originals):
            setattr(m, at, bracketed(label, fn))
        second = []

        def run_again():
            t0 = time.monotonic()
            second.append(engine.run())
            torch.cuda.synchronize()
            second.append(time.monotonic() - t0)

        if profile:
            busy, kernel_s, n_events = device_busy(run_again,
                                                   kernel_name[mode], part)
        else:
            run_again()
        again, wall2 = second
        for (_, m, at), fn in zip(parts, originals):
            setattr(m, at, fn)
        secs = {label: sum(a.elapsed_time(b) for a, b in sp) / 1e3
                for label, sp in spans.items()}
        first = [r.output for r in sorted(done, key=lambda r: r.rid)]
        same = [r.output for r in sorted(again, key=lambda r: r.rid)] == first
        shares = ", ".join(f"{label} {secs[label]:.3f} s over "
                           f"{len(spans[label])} calls "
                           f"({100 * secs[label] / wall2:.1f}%)"
                           for label in spans)
        print(f"[{tag}] {mode}: breakdown, second run of the same requests: "
              f"wall {wall2:.3f} s, {shares}, everything else "
              f"{wall2 - sum(secs.values()):.3f} s; same tokens as the first "
              f"run: {same}", flush=True)
        if not same:
            raise SystemExit("a second serve of the same requests gave other "
                             "tokens")

        if not profile:
            return first
        # The device's busy share: the union of the device's kernel
        # intervals in the second run's trace over the first run's
        # (unprofiled) wall, and the path kernel's own device time from the
        # trace.
        if n_events:
            print(f"[{tag}] {mode}: profiled run (the second): {n_events} "
                  f"device kernels "
                  f"({n_events / gemms:.1f} a GEMM), device busy {busy:.3f} s"
                  f", {100 * busy / wall:.1f}% of the first run's wall (idle "
                  f"{100 * (1 - busy / wall):.1f}%); {kernel} device time "
                  f"{kernel_s:.4f} s", flush=True)
        else:
            print(f"[{tag}] {mode}: device busy share not measured (the "
                  "profiler saw no device kernels)", flush=True)
        return first

    cfg = get_config(SERVE["arch"])
    if SERVE_LAYERS is not None:
        cfg = dataclasses.replace(cfg, n_layers=SERVE_LAYERS)
        print(f"[serve] depth cut to {SERVE_LAYERS} of 24 layers; widths as "
              "published")
    describe("serve", cfg)
    part(f"{cfg.name} draw")
    params = Model(cfg, device=dev).init(seed=SERVE["seed"])
    for mode in SERVE["modes"]:
        outputs[mode] = serve("serve", cfg, params, mode)
    agree = sum(a == b for r1, r2 in zip(*outputs.values())
                for a, b in zip(r1, r2))
    print(f"[serve] olm16 and tpmm16 agree on {agree} of "
          f"{sum(map(len, outputs['olm16']))} generated tokens (random "
          "weights; both within their documented error)")
    part("free")
    del params
    torch.cuda.empty_cache()

    # 6. the host-quantize path and the digit-level API ------------------
    phase("paths")
    layer = [(2048, 2048), (2048, 1024), (2048, 1024), (2048, 2048),
             (2048, 8192), (2048, 8192), (8192, 2048)]   # q k v o g u d
    gemms = [operands((4, K, N), 6 + i, dev) for i, (K, N) in enumerate(layer)]
    reset_counts()
    host = [olm_matmul(xs, ws, n_bits=16, quantize="host") for xs, ws in gemms]
    torch.cuda.synchronize()
    counts = read_counts()
    launches["olm_matmul_host"] = counts["olm_matmul_host"]
    print(f"[paths] olm_matmul(quantize='host') over one decoder layer's 7 "
          f"GEMMs at decode: launches {counts}", flush=True)
    if counts["olm_matmul_host"] != len(layer):
        raise SystemExit("the host-quantize path did not launch "
                         "olm_matmul_host once per GEMM")
    for (xs, ws), got in zip(gemms, host):
        if not bits_equal(got, olm_matmul(xs, ws, n_bits=16)):
            raise SystemExit("the host-quantize path disagrees with the "
                             "fused one")
    del gemms, host

    n, K = 16, 256
    cfg = OnlinePrecision(n=n)
    xm, ym = digits((MUL_B, n), 7, dev)
    xdot, ydot = digits((DOT_B, K, n), 8, dev)
    reset_counts()
    _, z_int = online_mul(xm, ym, cfg)
    _, dot = online_dot(xdot, ydot, cfg)
    torch.cuda.synchronize()
    counts = read_counts()
    launches["online_mul"] = counts["online_mul"]
    launches["online_dot"] = counts["online_dot"]
    print(f"[paths] online_mul B={MUL_B} n={n} and online_dot B={DOT_B} K={K} "
          f"n={n}: launches {counts}", flush=True)
    if counts["online_mul"] != 1 or counts["online_dot"] != 1:
        raise SystemExit("the digit-level API did not go through its kernels")
    wts = torch.tensor(0.5 ** np.arange(1, n + 1), device=dev)
    exact = (xm.double() @ wts) * (ym.double() @ wts)
    mul_ulp = float((z_int.double() / 2 ** n - exact).abs().max()) * 2 ** n
    exact = ((xdot.double() @ wts) * (ydot.double() @ wts)).sum(-1)
    dot_ulp = float((dot - exact).abs().max()) * 2 ** n
    print(f"[paths] online_mul worst error {mul_ulp:.3f} ulp at 2^-{n} "
          f"(documented <= 1.1); online_dot {dot_ulp:.3f} ulp "
          f"(documented <= 1.1 per lane: {1.1 * K:.1f})", flush=True)
    if not (mul_ulp <= 1.1 and dot_ulp <= 1.1 * K):
        raise SystemExit("the digit-level API exceeds its documented error")

    # 7. the fault-tolerant serving path: a faulted replay ---------------
    phase("replay")
    from repro_torch.serving import (FaultConfig, FaultInjector,
                                     ReplayConfig, build_fault_plan,
                                     build_workload, run_replay)
    cfg = get_config(SERVE["arch"])
    if SERVE_LAYERS is not None:
        cfg = dataclasses.replace(cfg, n_layers=SERVE_LAYERS)
    per_pass = 7 * cfg.n_layers + 1
    part(f"{cfg.name} draw")
    params = Model(cfg, device=dev).init(seed=SERVE["seed"])
    model = Model(cfg, DotEngine(mode="olm16"), device=dev)
    workload = build_workload(ReplayConfig(**REPLAY_WORKLOAD))
    baseline = {r["op"]: r["derived"] for r in json.loads(
        (ROOT / "results" / "baseline" / "BENCH_serve_faults.json")
        .read_text())["rows"] if r["op"].startswith("serve_faults/s0/")}
    print(f"[replay] {cfg.name} at full width ({cfg.n_layers} layers, "
          f"d_model {cfg.d_model}, vocab {cfg.vocab_size}), params "
          f"{cfg.param_dtype} from seed {SERVE['seed']}, compute "
          f"{cfg.compute_dtype}; engine {REPLAY_ENGINE}; workload "
          f"{REPLAY_WORKLOAD}: vocab=512 keeps the baseline's arrival "
          "schedule and prompt lengths, and ids below 512 are tokens of "
          f"the {cfg.vocab_size}-token vocabulary", flush=True)

    def replay(label, faults=None, **extra):
        """One run of the workload: (done, report, engine, passes, K1
        launches by tier mode, wall seconds, peak bytes)."""
        part(label)
        engine = ServeEngine(model, params, device=dev, **REPLAY_ENGINE,
                             **extra)
        passes = {"prefill": 0, "prefill_chunk": 0, "decode_step": 0}
        by_mode, finite = {}, []
        for m in {id(m): m for m in engine._tier_models.values()}.values():
            for kind in passes:
                def run(*a, _fn=getattr(m, kind), _kind=kind,
                        _mode=m.eng.mode, **kw):
                    before = k12.launches
                    out = _fn(*a, **kw)
                    passes[_kind] += 1
                    by_mode[_mode] = (by_mode.get(_mode, 0) + k12.launches
                                      - before)
                    finite.append(bool(torch.isfinite(out[0]).all()))
                    return out
                setattr(m, kind, run)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.monotonic()
        done, rep = run_replay(engine, workload, faults=faults)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        counts = read_counts()
        for m in engine._tier_models.values():
            for kind in passes:
                m.__dict__.pop(kind, None)
        peak = torch.cuda.max_memory_allocated()
        tokens = sum(len(r.output) for r in done)
        n_pass = sum(passes.values())
        print(f"[replay] {label}: {rep['n']} requests, {tokens} tokens, "
              f"{rep['steps_total']} scheduler steps, wall {wall:.3f} s (ends "
              f"in torch.cuda.synchronize), {tokens / wall:.3f} tokens/s, "
              f"peak memory {peak} bytes ({peak / 2**30:.2f} GiB); forward "
              f"passes {passes}; K1 launches {counts['olm_matmul_fused']} for "
              f"{n_pass * per_pass} GEMMs, by tier {by_mode}; finish reasons "
              f"{rep['finish_reasons']}", flush=True)
        if counts["olm_matmul_fused"] != n_pass * per_pass or n_pass == 0:
            raise SystemExit(f"replay {label}: K1 launched "
                             f"{counts['olm_matmul_fused']} times for "
                             f"{n_pass * per_pass} GEMMs")
        if any(v for k, v in counts.items() if k != "olm_matmul_fused"):
            raise SystemExit(f"replay {label}: other kernels launched "
                             f"{counts}")
        if not all(finite):
            raise SystemExit(f"replay {label}: non-finite logits on the card")
        if rep["n"] != len(workload) or any(
                r.finish_reason not in REPLAY_REASONS for r in done):
            raise SystemExit(f"replay {label}: a request without a known "
                             "finish reason")
        return done, rep, engine

    # only `engine` and the injector keep a run's engine, and with it the
    # weights, past its run: both go at the phase's end
    ref_done, ref_rep = replay("fault-free")[:2]
    ref = {r.rid: (tuple(r.output), r.finish_reason) for r in ref_done}
    fc = FaultConfig(seed=0, horizon_steps=max(
        10, int(ref_rep["steps_total"]) * 2 // 3), exhaust_blocks=16,
        exhaust_hold_steps=6)
    inj = FaultInjector(build_fault_plan(fc))
    done, rep, engine = replay("faulted", faults=inj)
    stats, ctr = inj.summary(), engine.counters
    identical = 0
    for r in done:
        out, reason = tuple(r.output), r.finish_reason
        if (out, reason) == ref[r.rid]:
            identical += 1
            continue
        if not (r.n_preempts or r.n_retries or r.degrade_rung
                or reason in ("numerics", "deadline", "rejected",
                              "cache_full", "failed")):
            raise SystemExit(f"replay: rid {r.rid} diverged with no recorded "
                             "fault or recovery")
        if r.n_preempts and not r.degrade_rung and reason == ref[r.rid][1] \
                and out != ref[r.rid][0]:
            raise SystemExit(f"replay: rid {r.rid} was preempted and "
                             "recomputed into other tokens")
        if reason == "deadline" and not r.degrade_rung \
                and out != ref[r.rid][0][:len(out)]:
            raise SystemExit(f"replay: rid {r.rid}'s deadline stream is not "
                             "a clean prefix")
    rows = {"completed": rep["n"], "steps_total": rep["steps_total"],
            "injected_exhaust": stats.get("exhaust", 0),
            "injected_corrupt": stats.get("corrupt", 0),
            "injected_nan": stats.get("nan", 0),
            "injected_prefill_fail": stats.get("prefill_fail", 0),
            "preempted": int(ctr["preempted"]),
            "table_repairs": int(ctr["table_repairs"]),
            "prefill_retries": int(ctr["prefill_retries"]),
            "degraded": int(ctr["degraded"]),
            "n_deadline": rep["n_deadline"], "n_rejected": rep["n_rejected"],
            "n_numerics": rep["n_numerics"],
            "n_cache_full": rep["n_cache_full"]}
    kvr = engine.kv_report()
    print(f"[replay] faulted: injected {stats}; counters "
          f"{dict(sorted(ctr.items()))}; identical_to_ref {identical} of "
          f"{len(done)} (the baseline's bench, with its own ladder, "
          f"{baseline['serve_faults/s0/identical_to_ref']}); post-run "
          f"integrity_ok {kvr['integrity_ok']}, blocks held "
          f"{kvr['kv_blocks_held']}", flush=True)
    print(f"[replay] step-counted rows against the baseline: " + ", ".join(
        f"{k} {v} ({baseline['serve_faults/s0/' + k]})"
        for k, v in rows.items()), flush=True)
    for fam in ("exhaust", "corrupt", "nan", "prefill_fail"):
        if stats.get(fam, 0) < 1:
            raise SystemExit(f"replay: fault family {fam!r} never fired")
    if (rep["n_numerics"] != stats["nan"]
            or ctr["table_repairs"] != stats["corrupt"]
            or ctr["prefill_retries"] != stats["prefill_fail"]
            or ctr["preempted"] < 1):
        raise SystemExit("replay: an injected fault did not resolve to its "
                         "finish reason or recovery")
    if not kvr["integrity_ok"] or kvr["kv_blocks_held"] != 0:
        raise SystemExit("replay: post-run block accounting does not balance")
    if any(v != baseline["serve_faults/s0/" + k] for k, v in rows.items()):
        raise SystemExit("replay: a step-counted row differs from "
                         "results/baseline/BENCH_serve_faults.json")
    chunked = replay(f"fault-free, prefill_chunk={REPLAY_CHUNK}",
                     prefill_chunk=REPLAY_CHUNK)[0]
    outs = {r.rid: r.output for r in chunked}
    agree = sum(a == b for r in ref_done for a, b in zip(r.output,
                                                         outs[r.rid]))
    print(f"[replay] chunked prefill answered {len(chunked)} requests; "
          f"{agree} of {sum(len(r.output) for r in ref_done)} generated "
          "tokens agree with the unchunked fault-free run (chunks stretch "
          "the schedule, so requests wait, degrade or expire otherwise; the "
          "equality of chunked and unchunked prefill is held on the CPU)",
          flush=True)
    part("free")
    del params, model, engine, inj
    gc.collect()                # the injector and its engine form a cycle
    torch.cuda.empty_cache()

    # 8. the rest of the dense family -------------------------------------
    phase("dense")
    from repro_torch.models import layers
    from repro_torch.models.model import lm_loss
    cfg = get_config(DENSE_ARCH)
    per_pass = 7 * cfg.n_layers + 1
    describe("dense", cfg)
    torch.cuda.reset_peak_memory_stats()
    part(f"{cfg.name} draw")
    params = Model(cfg, device=dev).init(seed=SERVE["seed"])
    torch.cuda.synchronize()
    print(f"[dense] weights on the card: {torch.cuda.memory_allocated()} "
          "bytes", flush=True)
    serve("dense", cfg, params, "olm16")

    # forward and lm_loss at full width under olm16, against prefill and a
    # plain NLL
    part(f"{cfg.name} forward, prefill and lm_loss")
    model = Model(cfg, DotEngine(mode="olm16"), device=dev)
    toks = torch.from_numpy(np.random.default_rng(SERVE["seed"]).integers(
        0, cfg.vocab_size, (1, FORWARD_LEN))).to(dev)
    reset_counts()
    t0 = time.monotonic()
    logits, aux = model.forward(params, {"tokens": toks})
    torch.cuda.synchronize()
    t_fwd, fwd_k1 = time.monotonic() - t0, k12.launches
    t0 = time.monotonic()
    last, _, _ = model.prefill(params, {"tokens": toks},
                               model.init_cache(1, FORWARD_LEN))
    torch.cuda.synchronize()
    t_pre = time.monotonic() - t0
    total, parts = lm_loss(model, params, {"tokens": toks})
    lp = torch.log_softmax(logits[0, :-1].double(), dim=-1)
    nll = float(-lp.gather(-1, toks[0, 1:, None].long()).mean())
    loss_rel = abs(float(parts["loss"]) - nll) / abs(nll)
    same = bits_equal(logits[:, -1].contiguous(), last)
    print(f"[dense] forward (1, {FORWARD_LEN}) under olm16: {t_fwd:.3f} s, "
          f"{fwd_k1} K1 launches ({per_pass} GEMMs); prefill of the same "
          f"tokens {t_pre:.3f} s; last position bit-identical to prefill: "
          f"{same}; lm_loss {float(total):.6f} (aux {float(aux)}), a plain "
          f"NLL from forward's logits {nll:.6f}, rel diff {loss_rel:.2e} "
          "(limit 1e-6)", flush=True)
    if logits.shape != (1, FORWARD_LEN, cfg.vocab_padded) \
            or not bool(torch.isfinite(logits).all()):
        raise SystemExit("forward gave logits of another shape or non-finite")
    if fwd_k1 != per_pass:
        raise SystemExit(f"forward launched K1 {fwd_k1} times for {per_pass} "
                         "GEMMs")
    if not same:
        raise SystemExit("forward's last position differs from prefill")
    if not (np.isfinite(float(total)) and loss_rel <= 1e-6):
        raise SystemExit("lm_loss disagrees with the plain NLL")
    del logits, last, lp, total, parts

    # a native forward long enough for the flash path, against the same
    # forward with the plain path forced
    part(f"{cfg.name} flash and plain forwards")
    native = Model(cfg, DotEngine(mode="native"), device=dev)
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (1, FLASH_LEN))).to(dev)
    flash_calls = []
    real_flash, threshold = layers._attn_flash, layers.FLASH_MIN_ELEMS

    def counted_flash(*a, **kw):
        flash_calls.append(1)
        return real_flash(*a, **kw)

    layers._attn_flash = counted_flash
    try:
        native.forward(params, {"tokens": toks})       # warm-up
        torch.cuda.synchronize()
        t0 = time.monotonic()
        flash, _ = native.forward(params, {"tokens": toks})
        torch.cuda.synchronize()
        t_flash = time.monotonic() - t0
        layers.FLASH_MIN_ELEMS = 1 << 62               # the plain path
        t0 = time.monotonic()
        plain, _ = native.forward(params, {"tokens": toks})
        torch.cuda.synchronize()
        t_plain = time.monotonic() - t0
    finally:
        layers._attn_flash, layers.FLASH_MIN_ELEMS = real_flash, threshold
    rel = rel_real(flash, plain, cfg.vocab_size)
    print(f"[dense] native forward (1, {FLASH_LEN}) bf16: flash attention "
          f"{t_flash:.3f} s ({len(flash_calls)} flash calls over two "
          f"forwards), plain attention forced {t_plain:.3f} s; logits rel "
          f"diff {rel:.3e} of the largest |logit| (limit 3e-2)", flush=True)
    if len(flash_calls) != 2 * cfg.n_layers:
        raise SystemExit("the flash path did not run in every layer")
    if not (bool(torch.isfinite(flash).all()) and rel <= 3e-2):
        raise SystemExit("flash and plain attention disagree")
    peak = torch.cuda.max_memory_allocated()
    print(f"[dense] {cfg.name} peak memory over the phase {peak} bytes "
          f"({peak / 2**30:.2f} GiB)", flush=True)
    del params, model, native, flash, plain
    torch.cuda.empty_cache()

    # Yi-34B and Qwen1.5-110B at full width, depth cut to fit the card
    for arch, depth in CUT_DEPTH:
        full = get_config(arch)
        cfg = dataclasses.replace(full, n_layers=depth)
        per_pass = 7 * depth + 1
        part(f"{cfg.name} at {depth} layers")
        describe("dense", cfg, cut=full.n_layers)
        torch.cuda.reset_peak_memory_stats()
        params = Model(cfg, device=dev).init(seed=SERVE["seed"])
        model = Model(cfg, DotEngine(mode="olm16"), device=dev)
        toks = torch.from_numpy(np.random.default_rng(2).integers(
            0, cfg.vocab_size, (SERVE["slots"], 16))).to(dev)
        reset_counts()
        t0 = time.monotonic()
        lg, cache, _ = model.prefill(params, {"tokens": toks},
                                     model.init_cache(SERVE["slots"], 32))
        finite = [bool(torch.isfinite(lg).all())]
        for step in range(2):
            pos = torch.full((SERVE["slots"],), 16 + step, device=dev)
            lg, cache = model.decode_step(params, lg.argmax(-1), pos, cache)
            finite.append(bool(torch.isfinite(lg).all()))
        torch.cuda.synchronize()
        wall, k1 = time.monotonic() - t0, k12.launches
        peak = torch.cuda.max_memory_allocated()
        print(f"[dense] {cfg.name}: a {SERVE['slots']} x 16 prefill and two "
              f"{SERVE['slots']}-lane decode steps under olm16 in {wall:.3f} s;"
              f" K1 launches {k1} for {3 * per_pass} GEMMs; finite logits "
              f"{all(finite)}; peak memory {peak} bytes "
              f"({peak / 2**30:.2f} GiB)", flush=True)
        if k1 != 3 * per_pass or not all(finite):
            raise SystemExit(f"{cfg.name}: K1 launches or logits are wrong")
        by_path["olm_matmul_fused"][f"dense {cfg.name} olm16"] = k1
        del params, model, cache, lg
        torch.cuda.empty_cache()

    # 9. the recurrent and MoE families -----------------------------------
    phase("families")
    from repro_torch.models import moe as moe_mod
    gc.collect()                # nothing of the dense phase may stay
    torch.cuda.empty_cache()
    print(f"[families] memory on the card before the phase: "
          f"{torch.cuda.memory_allocated()} bytes", flush=True)

    def family_params(cfg, tag="families"):
        part(f"{cfg.name} draw")
        torch.cuda.reset_peak_memory_stats()
        t0 = time.monotonic()
        params = Model(cfg, device=dev).init(seed=SERVE["seed"])
        torch.cuda.synchronize()
        print(f"[{tag}] {cfg.name}: weights on the card "
              f"{torch.cuda.memory_allocated()} bytes, drawn in "
              f"{time.monotonic() - t0:.1f} s", flush=True)
        return params

    def held_to_forward(tag, model, params, toks, n_prompt, plain=False):
        """Prefill toks[:, :n_prompt], then decode the rest one token at a
        time (teacher-forced); each step's logits against forward's over
        the whole sequence at the same position, relative to forward's
        largest |logit| there, both on the real vocabulary's columns (gate
        3e-2). With `plain`, the steps are
        also printed against a forward with the plain attention path
        forced, whose bf16 scores the decode steps' plain path shares."""
        L = toks.shape[1]
        t0 = time.monotonic()
        full, _ = model.forward(params, {"tokens": toks})
        torch.cuda.synchronize()
        t_fwd = time.monotonic() - t0
        t0 = time.monotonic()
        lg, cache, _ = model.prefill(params, {"tokens": toks[:, :n_prompt]},
                                     model.init_cache(1, RING_MAX_LEN))
        steps = [(n_prompt - 1, lg)]
        for p in range(n_prompt, L):
            lg, cache = model.decode_step(params, toks[:, p],
                                          torch.tensor([p], device=dev),
                                          cache)
            steps.append((p, lg))
        torch.cuda.synchronize()
        t_dec = time.monotonic() - t0
        vocab = model.cfg.vocab_size
        errs = [rel_real(got, full[:, p], vocab) for p, got in steps]
        print(f"[families] {tag}: forward over {L} tokens {t_fwd:.3f} s; "
              f"prefill of {n_prompt} and {L - n_prompt} decode steps "
              f"{t_dec:.3f} s; rel err against forward by position "
              f"{dict(zip([p for p, _ in steps], errs))} (limit 3e-2)",
              flush=True)
        if plain:
            threshold = layers.FLASH_MIN_ELEMS
            layers.FLASH_MIN_ELEMS = 1 << 62
            try:
                ref, _ = model.forward(params, {"tokens": toks})
            finally:
                layers.FLASH_MIN_ELEMS = threshold
            print(f"[families] {tag}: against a forward with plain "
                  "attention forced, by position " + str({
                      p: rel_real(g, ref[:, p], vocab) for p, g in steps})
                  + "; flash against plain forward "
                  f"{rel_real(full, ref, vocab):.3e}",
                  flush=True)
            del ref
        finite = bool(torch.isfinite(full).all()) and all(
            bool(torch.isfinite(g).all()) for _, g in steps)
        if not finite or max(errs) > 3e-2:
            raise SystemExit(f"{tag}: decode disagrees with forward")

    # RecurrentGemma-9B at its full width, FAMILY_RG_LAYERS deep: served
    # under olm16 (K1 at every eng.dot GEMM), then a ring that rolls, under
    # native
    full = get_config("recurrentgemma_9b")
    cfg = dataclasses.replace(full, n_layers=FAMILY_RG_LAYERS)
    describe("families", cfg, cut=full.n_layers)
    print(f"[families] {cfg.name}: kinds {cfg.block_pattern} x "
          f"{cfg.pattern_groups} + {cfg.remainder_blocks}, window "
          f"{cfg.sliding_window}, rnn_width {cfg.rnn_width}; "
          f"{gemms_per_pass(cfg)} eng.dot GEMMs a pass", flush=True)
    params = family_params(cfg)
    serve("families", cfg, params, "olm16", profile=False)
    peak = torch.cuda.max_memory_allocated()
    print(f"[families] {cfg.name} serve peak memory {peak} bytes "
          f"({peak / 2**30:.2f} GiB)", flush=True)
    part(f"{cfg.name} ring against forward")
    native = Model(cfg, DotEngine(mode="native"), device=dev)
    n_ring = RING_PROMPT + RING_DECODES
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (1, n_ring))).to(dev)
    flash_calls = []
    real_flash = layers._attn_flash

    def counted_ring_flash(*a, **kw):
        flash_calls.append(kw.get("window"))
        return real_flash(*a, **kw)

    layers._attn_flash = counted_ring_flash
    try:
        held_to_forward(f"{cfg.name} native ring (window "
                        f"{cfg.sliding_window}, cache {RING_MAX_LEN})",
                        native, params, toks, RING_PROMPT, plain=True)
    finally:
        layers._attn_flash = real_flash
    n_attn = cfg.layer_kinds.count("attn")
    print(f"[families] {cfg.name}: flash attention calls {len(flash_calls)} "
          f"with window {set(flash_calls)} ({n_attn} attention layers in "
          f"forward and in prefill)", flush=True)
    if len(flash_calls) != 2 * n_attn or set(flash_calls) != {
            cfg.sliding_window}:
        raise SystemExit("the windowed flash path did not run in every "
                         "attention layer")
    peak = torch.cuda.max_memory_allocated()
    print(f"[families] {cfg.name} peak memory over the phase {peak} bytes "
          f"({peak / 2**30:.2f} GiB)", flush=True)
    del params, native, toks
    gc.collect()
    torch.cuda.empty_cache()

    # Mamba2-130M at its full width and depth: served under olm16, then a
    # prefill and one decode under native against forward
    cfg = get_config("mamba2_130m")
    describe("families", cfg)
    params = family_params(cfg)
    serve("families", cfg, params, "olm16")
    part(f"{cfg.name} prefill and decode against forward")
    model = Model(cfg, DotEngine(mode="olm16"), device=dev)
    engine = ServeEngine(model, params, slots=SERVE["slots"],
                         max_len=SERVE["max_len"],
                         kv_block_size=SERVE["block"], device=dev)
    resident = engine.kv_report()["kv_bytes_resident"]
    print(f"[families] {cfg.name}: kv_bytes_resident {resident} (no "
          "attention layer)", flush=True)
    if resident != 0:
        raise SystemExit(f"{cfg.name} holds K/V bytes")
    del engine, model
    toks = torch.from_numpy(np.random.default_rng(4).integers(
        0, cfg.vocab_size, (1, MAMBA_PROMPT + 1))).to(dev)
    held_to_forward(f"{cfg.name} native", Model(cfg, DotEngine(
        mode="native"), device=dev), params, toks, MAMBA_PROMPT)
    del params, toks
    gc.collect()
    torch.cuda.empty_cache()

    # Mixtral-8x22B and Qwen3-MoE-235B-A22B at full width, depth cut: the
    # experts are plain matmuls, so K1 runs each layer's 4 attention GEMMs
    real_route = moe_mod._route_rows
    routed = {"assignments": 0, "dropped": 0}

    def counted_route(*a, **kw):
        plan = real_route(*a, **kw)
        keep = plan[4]
        routed["assignments"] += keep.numel()
        routed["dropped"] += int((~keep).sum())
        return plan

    moe_mod._route_rows = counted_route
    try:
        for arch, depth in MOE_DEPTH:
            full = get_config(arch)
            cfg = dataclasses.replace(full, n_layers=depth)
            per_pass = gemms_per_pass(cfg)
            describe("families", cfg, cut=full.n_layers)
            print(f"[families] {cfg.name}: {cfg.n_experts} experts, "
                  f"{cfg.experts_per_token} a token, capacity factor "
                  f"{cfg.capacity_factor}, window {cfg.sliding_window}; "
                  f"{per_pass} eng.dot GEMMs a pass", flush=True)
            params = family_params(cfg)
            part(f"{cfg.name} prefill, decodes and forward")
            model = Model(cfg, DotEngine(mode="olm16"), device=dev)
            toks = torch.from_numpy(np.random.default_rng(5).integers(
                0, cfg.vocab_size, (SERVE["slots"], 16))).to(dev)
            routed.update(assignments=0, dropped=0)
            reset_counts()
            t0 = time.monotonic()
            lg, cache, _ = model.prefill(params, {"tokens": toks},
                                         model.init_cache(SERVE["slots"], 32))
            finite = [bool(torch.isfinite(lg).all())]
            for step in range(2):
                pos = torch.full((SERVE["slots"],), 16 + step, device=dev)
                lg, cache = model.decode_step(params, lg.argmax(-1), pos,
                                              cache)
                finite.append(bool(torch.isfinite(lg).all()))
            torch.cuda.synchronize()
            wall, k1 = time.monotonic() - t0, k12.launches
            serve_routed = dict(routed)
            by_path["olm_matmul_fused"][f"families {cfg.name} olm16"] = k1
            routed.update(assignments=0, dropped=0)
            t0 = time.monotonic()
            logits, aux = model.forward(params, {"tokens": toks})
            torch.cuda.synchronize()
            t_fwd, aux = time.monotonic() - t0, float(aux)
            finite.append(bool(torch.isfinite(logits).all()))
            peak = torch.cuda.max_memory_allocated()
            print(f"[families] {cfg.name}: a {SERVE['slots']} x 16 prefill "
                  f"and two {SERVE['slots']}-lane decode steps under olm16 "
                  f"in {wall:.3f} s; K1 launches {k1} for {3 * per_pass} "
                  f"GEMMs; routed assignments {serve_routed['assignments']},"
                  f" dropped by capacity {serve_routed['dropped']}; forward "
                  f"(4, 16) {t_fwd:.3f} s, aux loss {aux:.6f}, dropped "
                  f"{routed['dropped']} of {routed['assignments']}; finite "
                  f"logits {all(finite)}; peak memory {peak} bytes "
                  f"({peak / 2**30:.2f} GiB)", flush=True)
            if k1 != 3 * per_pass or not all(finite):
                raise SystemExit(f"{cfg.name}: K1 launches or logits are "
                                 "wrong")
            if not (np.isfinite(aux) and aux > 0):
                raise SystemExit(f"{cfg.name}: aux loss {aux} is not finite "
                                 "and positive")
            del params, model, cache, lg, logits
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        moe_mod._route_rows = real_route

    # 10. the autotuner: tune the serve's GEMM buckets, serve on them ------
    phase("tune")
    gc.collect()
    torch.cuda.empty_cache()
    cfg = get_config(SERVE["arch"])
    if SERVE_LAYERS is not None:
        cfg = dataclasses.replace(cfg, n_layers=SERVE_LAYERS)
    winners = {}
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "tuning_torch.json")
        cache = tuning.TuningCache(path)
        t0 = time.monotonic()
        part("tune")
        for M, K, N in SERVE_SHAPES:
            trace = []
            best = tuning.tune(M, N, K, 16, cache, trace=trace)
            base = tuning.heuristic_tiling(M, N, K, 16, sms=sms)
            times = {c.label(): ms for c, ms, _ in trace}
            want = next(out for c, _, out in trace if c == base)
            same = all(bits_equal(out, want) for _, _, out in trace)
            key = tuning.bucket_key(M, N, K, 16)
            winners[key] = ((M, N, K), best)
            plan_ms = {c: round(ms, 4) for c, ms in times.items()}
            print(f"[tune] olm16 M,K,N={(M, K, N)} ({key}): heuristic "
                  f"{base.label()} {times[base.label()]:.4f} ms, winner "
                  f"{best.label()} {times[best.label()]:.4f} ms "
                  f"({times[base.label()] / times[best.label()]:.3f}x); "
                  f"candidates (bm x bn x tb: ms) {plan_ms}; every "
                  f"candidate bit-identical to the heuristic's plan: {same}",
                  flush=True)
            if not same:
                raise SystemExit(f"a launch plan changed the bits at {key}")
            del trace, want
            torch.cuda.empty_cache()
        print(f"[tune] {len(SERVE_SHAPES)} buckets tuned in "
              f"{time.monotonic() - t0:.1f} s into {path}", flush=True)
        os.environ[tuning.CACHE_ENV] = path
        tuner = tuning.default_cache()
        if tuner.path != path:
            raise SystemExit("the tuner's default cache was made before "
                             "the tune phase")
        part(f"{cfg.name} draw")
        params = Model(cfg, device=dev).init(seed=SERVE["seed"])
        first = serve("tune", cfg, params, "olm16", profile=False,
                      engine_kw=dict(dot_tiling="auto"))
        del params
    part("against the committed plans")
    stats, fixed = serve_stats["tune olm16"], serve_stats["serve olm16"]
    hits, misses = stats["tuner"]
    print(f"[tune] serve under dot_tiling='auto': wall {stats['wall']:.3f} s "
          f"against the fixed plans' {fixed['wall']:.3f} s (serve phase); "
          f"{stats['passes']} passes x {gemms_per_pass(cfg)} = "
          f"{stats['gemms']} GEMMs; tuner hits {hits}, misses {misses}; "
          f"tokens equal to the serve phase's olm16 tokens: "
          f"{first == outputs['olm16']}", flush=True)
    if first != outputs["olm16"]:
        raise SystemExit("the tuned serve gave other tokens than the fixed "
                         "plans")
    if misses != 0 or hits != stats["gemms"]:
        raise SystemExit(f"tuner hits {hits} and misses {misses} for "
                         f"{stats['gemms']} GEMMs")
    committed = ROOT / "results" / "tuning_torch.json"
    if committed.exists():
        ref = tuning.TuningCache(str(committed), card=name)
        agree = sum(ref.lookup(*shape, 16) == best
                    for shape, best in winners.values())
        print(f"[tune] committed {committed.relative_to(ROOT)} (card "
              f"{ref.header}): its plan is this run's winner in {agree} of "
              f"{len(winners)} buckets, {ref.misses} absent or of another "
              "card", flush=True)
    else:
        print("[tune] no committed results/tuning_torch.json to compare",
              flush=True)
    torch.cuda.empty_cache()

    # 11. the enc-dec and VLM families --------------------------------------
    phase("crossattn")
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[crossattn] memory on the card before the phase: "
          f"{torch.cuda.memory_allocated()} bytes", flush=True)
    real_k1, spans = k12.olm_matmul_fused, []

    def bracketed_k1(*a, **kw):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        out = real_k1(*a, **kw)
        stop.record()
        spans.append((start, stop))
        return out

    def call_timed(calls, label, fn):
        """fn() between synchronizes: its wall and K1's bracketed share."""
        spans.clear()
        torch.cuda.synchronize()
        t0 = time.monotonic()
        out = fn()
        torch.cuda.synchronize()
        calls[label] = (time.monotonic() - t0,
                        sum(a.elapsed_time(b) for a, b in spans) / 1e3,
                        len(spans))
        return out

    for arch in CROSS_ARCHS:
        full = get_config(arch)
        cfg = dataclasses.replace(full, **CROSS_DEPTH[arch])
        key = "frames" if cfg.family == "encdec" else "patches"
        describe("crossattn", cfg, cut=full.n_layers)
        per_pass, with_enc = gemms_per_pass(cfg), gemms_per_pass(cfg, True)
        print(f"[crossattn] {cfg.name}: family {cfg.family}, kinds "
              f"{cfg.block_pattern} x {cfg.pattern_groups}, "
              f"{cfg.n_enc_layers} encoder layers, {cfg.n_frontend_tokens} "
              f"{key} a lane; {with_enc} eng.dot GEMMs a pass over {key}, "
              f"{per_pass} a decode step", flush=True)
        params = family_params(cfg, tag="crossattn")
        part(f"{cfg.name} prefill, decodes and forwards")
        model = Model(cfg, DotEngine(mode="olm16"), device=dev)
        g = torch.Generator(device=dev).manual_seed(SERVE["seed"])
        front = torch.randn(CROSS_LANES, cfg.n_frontend_tokens, cfg.d_model,
                            generator=g, device=dev)
        P, L = CROSS_PROMPT, CROSS_PROMPT + CROSS_DECODES
        toks = torch.from_numpy(np.random.default_rng(6).integers(
            0, cfg.vocab_size, (CROSS_LANES, L))).to(dev)
        calls = {}
        k12.olm_matmul_fused = bracketed_k1
        try:
            reset_counts()
            lg, cache, mem = call_timed(
                calls, f"prefill {P}", lambda: model.prefill(
                    params, {"tokens": toks[:, :P], key: front},
                    model.init_cache(CROSS_LANES, L + 1)))
            prefill_lg, steps = lg, []
            for p in range(P, L):
                lg, cache = call_timed(calls, f"decode at {p}",
                                  lambda: model.decode_step(
                                      params, toks[:, p], torch.full(
                                          (CROSS_LANES,), p, device=dev),
                                      cache, mem))
                steps.append((p, lg))
            short, _ = call_timed(calls, f"forward {P}", lambda: model.forward(
                params, {"tokens": toks[:, :P], key: front}))
            full, _ = call_timed(calls, f"forward {L}", lambda: model.forward(
                params, {"tokens": toks, key: front}))
            torch.cuda.synchronize()
            k1 = k12.launches
        finally:
            k12.olm_matmul_fused = real_k1
        peak = torch.cuda.max_memory_allocated()
        gemms = 3 * with_enc + CROSS_DECODES * per_pass
        same = bits_equal(prefill_lg, short[:, P - 1])
        errs = {p: rel_real(got, full[:, p], cfg.vocab_size)
                for p, got in steps}
        finite = all(bool(torch.isfinite(t).all()) for t in (
            prefill_lg, short, full, *(lg for _, lg in steps)))
        by_path["olm_matmul_fused"][f"crossattn {cfg.name} olm16"] = k1
        for label, (wall, k1_s, n) in calls.items():
            print(f"[crossattn] {cfg.name} {label}: wall {wall:.3f} s, K1 "
                  f"{k1_s:.3f} s over {n} launches ({100 * k1_s / wall:.1f}%)",
                  flush=True)
        print(f"[crossattn] {cfg.name}: K1 launches {k1} for {gemms} GEMMs; "
              f"prefill's last position bit-identical to forward over the "
              f"{P} prompt tokens: {same}; decode rel err against forward "
              f"over {L} tokens by position {errs} (limit 3e-2); finite "
              f"logits {finite}; memory {tuple(mem.shape)} {mem.dtype}; peak "
              f"memory {peak} bytes ({peak / 2**30:.2f} GiB)", flush=True)
        if k1 != gemms:
            raise SystemExit(f"{cfg.name}: K1 launched {k1} times for "
                             f"{gemms} GEMMs")
        if not same:
            raise SystemExit(f"{cfg.name}: prefill differs from forward")
        if not finite or max(errs.values()) > 3e-2:
            raise SystemExit(f"{cfg.name}: decode disagrees with forward")
        del params, model, front, cache, lg, prefill_lg, mem, short, full
        del steps
        gc.collect()
        torch.cuda.empty_cache()

    # 12. training ------------------------------------------------------------
    phase("train")
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[train] memory on the card before the phase: "
          f"{torch.cuda.memory_allocated()} bytes", flush=True)
    cfg = get_config(TRAIN["arch"])
    describe("train", cfg)
    model = Model(cfg, device=dev)
    B, S = TRAIN["batch"]
    batch = {k: torch.from_numpy(v).to(dev) for k, v in SyntheticLMDataset(
        cfg, B, S, seed=TRAIN["seed"]).batch(0).items()}
    opt_cfg = AdamWConfig(lr=TRAIN["lr"])

    def train_steps(step_fn, box, n, tag, batch=batch, first=0):
        """n synchronized steps from the state in the one-element list
        `box`, which it takes, so that no caller holds a state two steps
        old (three states of InternLM2-1.8B do not fit the card): (state,
        [(loss, grad_norm, wall, peak memory)]); the steps are printed
        from `first` on."""
        state, rows = box.pop(), []
        for i in range(first, first + n):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.monotonic()
            state, met = step_fn(state, batch)
            torch.cuda.synchronize()
            wall = time.monotonic() - t0
            peak = torch.cuda.max_memory_allocated()
            rows.append((float(met["loss"]), float(met["grad_norm"]), wall,
                         peak))
            toks = batch["tokens"].numel()
            print(f"[train] {tag} step {i}: loss {rows[-1][0]:.4f} grad_norm "
                  f"{rows[-1][1]:.4f} lr {float(met['lr']):.3e}; wall "
                  f"{wall:.3f} s, {toks / wall:.0f} tokens/s, peak memory "
                  f"{peak} bytes", flush=True)
        return state, rows

    # (a) native at full width and depth, f32 masters, bf16 compute,
    # remat="block": overfit one batch
    part(f"{cfg.name} draw")
    t0 = time.monotonic()
    box = [init_train_state(model, seed=TRAIN["seed"])]
    torch.cuda.synchronize()
    print(f"[train] {cfg.name}: state (params, m, v) on the card "
          f"{torch.cuda.memory_allocated()} bytes, drawn in "
          f"{time.monotonic() - t0:.1f} s; remat {cfg.remat}, batch {B} x "
          f"{S}, lr {TRAIN['lr']}, schedule_total {TRAIN['total']}",
          flush=True)
    step_fn = build_train_step(model, opt_cfg=opt_cfg,
                               schedule_total=TRAIN["total"])
    # the first SHARD_TP_STEPS steps' readings and the update's norm over
    # them: what the shard phase's (d1) holds its partitioned ranks to
    part(f"the first {SHARD_TP_STEPS} steps")
    state, rows = train_steps(step_fn, box, SHARD_TP_STEPS, "native")
    part(f"the first {SHARD_TP_STEPS} steps' update norm")
    first_update = sum(update_sq(model, state["params"]).values()) ** 0.5
    box = [state]
    del state
    part(f"steps {SHARD_TP_STEPS}-{TRAIN['steps'] - 1}")
    state, more = train_steps(step_fn, box, TRAIN["steps"] - SHARD_TP_STEPS,
                              "native", first=SHARD_TP_STEPS)
    rows += more
    peak = max(r[3] for r in rows)
    losses = [r[0] for r in rows]
    steady = sorted(r[2] for r in rows[1:])[len(rows[1:]) // 2]
    print(f"[train] {cfg.name} native: loss {losses[0]:.4f} -> "
          f"{losses[-1]:.4f} over {len(rows)} steps (gate: down by more than "
          f"0.05); median step wall after the first {steady:.3f} s, "
          f"{B * S / steady:.0f} tokens/s; peak memory {peak} bytes "
          f"({peak / 2**30:.2f} GiB); {smi_line}", flush=True)
    # the dryrun phase prints them beside its own one-rank step
    train_native = {"peak": peak, "wall": steady}
    train_first = {"metrics": [list(r[:2]) for r in rows[:SHARD_TP_STEPS]],
                   "update_norm": first_update, "peak": peak}
    print(f"[train] the first {SHARD_TP_STEPS} steps' update norm "
          f"{first_update!r} (the shard phase's (d1) reads it)", flush=True)
    if not all(np.isfinite(r[1]) for r in rows):
        raise SystemExit("train: a non-finite grad_norm")
    if not losses[-1] < losses[0] - 0.05:
        raise SystemExit(f"train: the loss went {losses[0]} -> {losses[-1]}")

    # the forward and backward alone, with and without remat: what the
    # graph holds after the forward, the peak, the wall (each twice, the
    # second printed: the first call of a model warms its caches)
    part("forward and backward, remat block and none, twice")
    for remat in ("block", "none") * 2:
        m = Model(dataclasses.replace(cfg, remat=remat), device=dev)
        leaves, treedef = tree_flatten(state["params"])
        live = [p.detach().requires_grad_(True) for p in leaves]
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.monotonic()
        loss, _ = lm_loss(m, cast_params(tree_unflatten(treedef, live), cfg),
                          batch)
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated() - base
        grads = torch.autograd.grad(loss, live)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        print(f"[train] forward + backward, remat {remat}: wall {wall:.3f} "
              f"s; after the forward the graph holds {held} bytes (the "
              f"cast weights and the saved activations); peak "
              f"{torch.cuda.max_memory_allocated() - base} bytes above the "
              f"state", flush=True)
        del m, leaves, live, loss, grads

    # (b) microbatches = 2 from the state (a) ends in, against one batch
    part("microbatches 2 against 1")
    p1 = step_fn(state, batch)[0]["params"]
    mb_fn = build_train_step(model, opt_cfg=opt_cfg, microbatches=2,
                             schedule_total=TRAIN["total"])
    two, _ = mb_fn(state, batch)
    worst, close = 0.0, True
    for a, b, p in zip(tree_leaves(p1), tree_leaves(two["params"]),
                       tree_leaves(state["params"])):
        worst = max(worst, float((a - b).abs().max() / (a - p).abs().max()))
        close &= bool(torch.allclose(b, a, atol=5e-3, rtol=5e-3))
    print(f"[train] microbatches 2 against 1 from step {TRAIN['steps']}: "
          f"params within 5e-3 abs and rel (the gate) {close}; the largest "
          f"difference {worst:.3e} of its leaf's largest update", flush=True)
    if not close:
        raise SystemExit("train: microbatches=2 disagrees with 1")
    del p1, two

    # (c) compressed gradients: one step, the error state allocated
    part("compressed gradients")
    cz_fn = build_train_step(model, opt_cfg=opt_cfg, compress_grads=True,
                             schedule_total=TRAIN["total"])
    cz, met = cz_fn(state, batch)
    ef_finite = cz["ef"] is not None and all(
        bool(torch.isfinite(e).all()) for e in tree_leaves(cz["ef"]))
    print(f"[train] compress_grads: loss {float(met['loss']):.4f}, error "
          f"state allocated and finite: {ef_finite} "
          f"({len(tree_leaves(cz['ef'] or {}))} leaves)", flush=True)
    if not (np.isfinite(float(met["loss"])) and ef_finite):
        raise SystemExit("train: the compressed step failed")
    del cz, met, state, step_fn, mb_fn, cz_fn, batch
    gc.collect()
    torch.cuda.empty_cache()

    # (d) the kernel path: every GEMM of the forward through K1 (olm16) or
    # K5 (tpmm16), and again through the checkpointed layers' recompute
    per_pass = gemms_per_pass(cfg)
    # remat runs each checkpointed layer's forward again in the backward,
    # but PyTorch's checkpoint stops once it has every tensor the backward
    # saved: a layer's last GEMM (the MLP's down projection) feeds only the
    # residual add, which saves nothing, so it does not run again; the LM
    # head is outside the checkpoints
    recompute = per_pass - 1 - cfg.n_layers
    B, S = TRAIN["kernel_batch"]
    kbatch = {k: torch.from_numpy(v).to(dev) for k, v in SyntheticLMDataset(
        cfg, B, S, seed=TRAIN["seed"]).batch(0).items()}
    for mode, (kernel, module, attr) in path_kernel.items():
        real, spans = getattr(module, attr), []

        def bracketed(*a, _real=real, **kw):
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            out = _real(*a, **kw)
            stop.record()
            spans.append((start, stop))
            return out

        part(f"{mode} steps")
        m = Model(cfg, DotEngine(mode=mode), device=dev)
        box = [init_train_state(m, seed=TRAIN["seed"])]
        fn = build_train_step(m, opt_cfg=opt_cfg,
                              schedule_total=TRAIN["total"])
        p0 = box[0]["params"]
        setattr(module, attr, bracketed)
        try:
            reset_counts()
            state, rows = train_steps(fn, box, TRAIN["kernel_steps"], mode,
                                      batch=kbatch)
            launched = read_counts()[kernel]
        finally:
            setattr(module, attr, real)
        k_s = sum(a.elapsed_time(b) for a, b in spans) / 1e3
        wall = sum(r[2] for r in rows)
        want = TRAIN["kernel_steps"] * (per_pass + recompute)
        by_path.setdefault(kernel, {})[f"train {cfg.name} {mode}"] = launched
        # the update of a zero gradient, recomputed in the step's op order:
        # step 1 has lr 0, step 2 the decay alone
        lr = opt_cfg.lr * cosine_schedule(
            torch.tensor(1, dtype=torch.int32, device=dev),
            total=TRAIN["total"])
        zero_moments = all(not bool(t.any()) for t in tree_leaves(
            (state["opt"]["m"], state["opt"]["v"])))
        same = all(bits_equal(b, a - lr * (
            torch.zeros_like(a) / (torch.sqrt(torch.zeros_like(a))
                                   + opt_cfg.eps) + opt_cfg.weight_decay * a))
            for a, b in zip(tree_leaves(p0), tree_leaves(state["params"])))
        print(f"[train] {mode}: {kernel} launches {launched} for "
              f"{TRAIN['kernel_steps']} steps x ({per_pass} forward GEMMs + "
              f"{recompute} recomputed by remat, each layer's last not) = "
              f"{want}; grad_norm "
              f"{[r[1] for r in rows]}, moments all zero {zero_moments}; "
              f"params bit-equal to the decay-only update {same}; "
              f"{kernel} {k_s:.3f} s over {len(spans)} launches of "
              f"{wall:.3f} s of step wall ({100 * k_s / wall:.1f}%)",
              flush=True)
        if launched != want:
            raise SystemExit(f"train: {kernel} launched {launched} times for "
                             f"{want} GEMMs")
        if any(r[1] != 0.0 for r in rows) or not zero_moments:
            raise SystemExit(f"train: a non-zero gradient under {mode}")
        if not same:
            raise SystemExit(f"train: {mode} params are not the decay's")
        del m, state, fn, p0, spans
        gc.collect()
        torch.cuda.empty_cache()
    del model, kbatch

    # (e) the train CLI on Mamba2-130M, the reference example's settings:
    # 30 steps with checkpoints, a resume of its step 20 to 30
    saved, restored, streamed, save_walls = {}, [], [], []
    ckpt_dirs = set()

    class Recording(train_cli.CheckpointManager):
        # the CLI's state rests as DTensors on its one-rank mesh: each leaf
        # is recorded whole; each save call's wall is the time the loop
        # waits in it (the write runs in the background unless it blocks)
        def save(self, step, tree, *, block=False):
            ckpt_dirs.add(self.dir)
            saved[step] = [t.detach().clone()
                           for t in tree_leaves(gather_state(tree))]
            t0 = time.monotonic()
            super().save(step, tree, block=block)
            save_walls.append(round(time.monotonic() - t0, 3))

        def restore(self, tree_like, step=None, shardings=None):
            out = super().restore(tree_like, step, shardings)
            # copies: on a one-rank mesh a leaf gathered whole is the
            # state's own storage, which the CLI's steps update in place
            # (jit_train_step takes its state donated)
            restored.append([t.clone() for t in tree_leaves(
                gather_state(out))])
            return out

    real_batch = SyntheticLMDataset.batch

    def recorded_batch(self, step):
        out = real_batch(self, step)
        streamed.append((step, out["tokens"]))
        return out

    def cli(argv):
        buf = io.StringIO()
        train_cli.CheckpointManager = Recording
        SyntheticLMDataset.batch = recorded_batch
        try:
            with contextlib.redirect_stdout(buf):
                summary = train_cli.main(argv)
        finally:
            train_cli.CheckpointManager = train_cli_manager
            SyntheticLMDataset.batch = real_batch
        for line in buf.getvalue().splitlines():
            print(f"[train] cli: {line}", flush=True)
        steps = {int(m[1]): float(m[2]) for m in re.finditer(
            r"^step +(\d+) loss (\S+)", buf.getvalue(), re.M)}
        return summary, steps

    train_cli_manager = train_cli.CheckpointManager
    with tempfile.TemporaryDirectory() as tmp:
        args = ["--arch", CLI["arch"], "--batch", str(CLI["batch"]),
                "--seq", str(CLI["seq"]), "--lr", str(CLI["lr"]),
                "--log-every", "1"]
        # run 1 goes straight to 30; its step-30 checkpoint removed, the
        # directory is a run's that stopped after step 20's checkpoint, and
        # run 2 resumes it to 30: steps 20-29 twice, once straight and once
        # resumed (the first 20 steps run once)
        t0 = time.monotonic()
        part("cli straight 30")
        one, straight = cli(args + ["--steps", "30", "--ckpt-every", "10",
                                    "--ckpt-dir", f"{tmp}/run"])
        t1 = time.monotonic()
        at20 = saved.pop(20)
        saved.clear()
        streamed.clear()
        (run_dir,) = ckpt_dirs
        shutil.rmtree(run_dir / f"step_{30:08d}")   # the manager's layout
        part("cli resumed to 30")
        two, resumed = cli(args + ["--steps", "30", "--ckpt-every", "10",
                                   "--ckpt-dir", f"{tmp}/run", "--resume"])
        t2 = time.monotonic()
        first_step, first_tokens = streamed[0]
        same_state = len(restored) == 1 and len(restored[0]) == len(at20) and \
            all(bits_equal(a, b) for a, b in zip(restored[0], at20))
        stream = SyntheticLMDataset(get_config(CLI["arch"]), CLI["batch"],
                                    CLI["seq"], seed=0).batch(20)["tokens"]
        same_batch = np.array_equal(first_tokens, stream)
        del at20, restored[:]
    saved.clear()
    rel = {k: abs(resumed[k] - straight[k]) / abs(straight[k])
           for k in range(20, 30)}
    print(f"[train] cli {CLI['arch']} (batch {CLI['batch']} x seq "
          f"{CLI['seq']}, lr {CLI['lr']}): run 1 straight {one['steps']} "
          f"steps in {t1 - t0:.1f} s, loss {one['loss_first']:.4f} -> "
          f"{one['loss_last']:.4f}, improved {one['loss_improved']}; its "
          f"step-30 checkpoint removed, run 2 resumed at step {first_step} "
          f"({two['steps']} steps in {t2 - t1:.1f} s), restored state "
          f"bit-equal to the saved one {same_state}, its first batch the "
          f"stream's step 20 {same_batch}, steps 20-29 within "
          f"{max(rel.values()):.2e} of the straight run's (gate 1e-3 "
          f"relative); each save call's wall in s, in order (the last of "
          f"each run blocks) {save_walls}", flush=True)
    if not one["loss_improved"]:
        raise SystemExit("train: the CLI's loss did not improve")
    if first_step != 20 or not same_state or not same_batch:
        raise SystemExit("train: the resume did not continue the run")
    if sorted(resumed) != list(range(20, 30)) or max(rel.values()) > 1e-3:
        raise SystemExit("train: the resumed run left the straight run")
    gc.collect()
    torch.cuda.empty_cache()

    # 13. the sharded path over two ranks on the one card -----------------
    phase("shard")
    import socket

    import torch.multiprocessing as mp
    from repro_torch.kernels.online_dot.matmul_sharded import (
        sharded_traffic)
    # The two ranks of this phase and of the tp phase: one spawn, one gloo
    # group, both phases' parts one after the other (`ranks_main`). They
    # import torch and join their group while this process computes the
    # single-device results they are held against.
    part("spawn the ranks")
    if SHARD_RANKS != TP_RANKS:
        raise SystemExit("the shard and tp phases share their ranks")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ranks_")
    exits.callback(shutil.rmtree, tmp, ignore_errors=True)
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    spawn = mp.get_context("spawn")
    events = {"shard": spawn.Event(), "tp": spawn.Event(),
              "shard_done": [spawn.Event() for _ in range(SHARD_RANKS)]}
    tokens = [[int(t) for t in out] for out in outputs["olm16"]]
    t_ranks = time.monotonic()
    ranks_ctx = mp.start_processes(
        ranks_main, args=(SHARD_RANKS, port, tmp, tokens, events,
                          os.getpid()),
        nprocs=SHARD_RANKS, join=False, start_method="spawn")
    exits.callback(stop, ranks_ctx)
    # the single-device results the ranks are held against: K1 at
    # each GEMM, and the native train step over the cut model
    part("(a) one device")
    refs = {}
    for i, ((K, N), mode) in enumerate(SHARD_GEMMS):
        n, p = mode_bits(mode)
        x, w = operands((SHARD_ROWS, K, N), 100 + i, dev)
        refs[f"{i}"] = olm_matmul(x, w, n_bits=n, trunc=p).cpu()
        tr = {how: sharded_traffic(SHARD_ROWS, N, K, partition=how,
                                   devices=SHARD_RANKS, n_bits=n, trunc=p)
              for how in ("m", "n", "k")}
        print(f"[shard] {mode} ({SHARD_ROWS}, {K}) @ ({K}, {N}): "
              f"sharded_traffic over {SHARD_RANKS}: local fused bytes "
              f"{ {k: v['local']['fused_bytes'] for k, v in tr.items()} }"
              f", collective bytes "
              f"{ {k: v['collective_bytes'] for k, v in tr.items()} }",
              flush=True)
    torch.save(refs, os.path.join(tmp, "gemm.pt"))
    del refs, x, w
    part("(c) one device")
    cfg = dataclasses.replace(get_config(TRAIN["arch"]),
                              n_layers=SHARD_TRAIN_LAYERS)
    describe("shard", cfg, cut=24)
    model = Model(cfg, device=dev)
    B, S = TRAIN["batch"]
    data = SyntheticLMDataset(cfg, B, S, seed=TRAIN["seed"])
    step_fn = build_train_step(model, opt_cfg=AdamWConfig(
        lr=TRAIN["lr"]), schedule_total=TRAIN["total"])
    state = init_train_state(model, seed=TRAIN["seed"])
    start = tree_leaves(state["params"])
    seen = []
    t0 = time.monotonic()
    for i in range(SHARD_TRAIN_STEPS):
        state, met = step_fn(state, {k: torch.from_numpy(v).to(dev)
                                     for k, v in data.batch(i).items()})
        seen.append([met["loss"], met["grad_norm"]])
    torch.cuda.synchronize()
    seen = [[float(v) for v in m] for m in seen]
    end = tree_leaves(state["params"])
    # the norm of the whole update, the (2, 1) check's denominator
    update = sum(float((e.double() - b.double()).pow(2).sum())
                 for e, b in zip(end, start)) ** 0.5
    print(f"[shard] one device: {SHARD_TRAIN_STEPS} steps in "
          f"{time.monotonic() - t0:.3f} s, loss and grad_norm by step "
          f"{seen}; update norm {update!r}; "
          f"{sum(t.numel() for t in end)} params", flush=True)
    torch.save([t.cpu() for t in end], os.path.join(tmp, "train.pt"))
    Path(tmp, "train.json").write_text(json.dumps(
        {"metrics": seen, "update_norm": update}))
    del model, step_fn, state, met, start, end
    gc.collect()
    torch.cuda.empty_cache()
    # (d2)'s one device: layer 0's wq under olm16 on the cut, at the
    # kernel batch (its input and output)
    part("(d2) one device")
    t0 = time.monotonic()
    kB, kS = TRAIN["kernel_batch"]
    m16 = Model(cfg, DotEngine(mode="olm16"), device=dev)
    params = m16.init(seed=TRAIN["seed"])
    kb = {k: torch.from_numpy(v).to(dev) for k, v in SyntheticLMDataset(
        cfg, kB, kS, seed=TRAIN["seed"]).batch(0).items()}
    with torch.no_grad(), olm_calls({0}) as calls:
        lm_loss(m16, cast_params(params, cfg), kb)
    torch.save([t.cpu() for t in calls[0]], os.path.join(tmp,
                                                         "wq16.pt"))
    del m16, params, kb, calls
    gc.collect()
    torch.cuda.empty_cache()
    # (d3)'s one device: SHARD_VLM whole, its steps
    part("(d3) one device")
    vcfg = dataclasses.replace(get_config(SHARD_VLM["arch"]),
                               n_layers=SHARD_VLM["n_layers"],
                               remat=SHARD_VLM["remat"])
    describe("shard (d3)", vcfg, cut=get_config(SHARD_VLM["arch"])
             .n_layers)
    vmodel = Model(vcfg, device=dev)
    state = init_train_state(vmodel, seed=TRAIN["seed"])
    vstep = build_train_step(vmodel, opt_cfg=AdamWConfig(
        lr=TRAIN["lr"]), schedule_total=TRAIN["total"])
    vseen = []
    torch.cuda.synchronize()
    t1 = time.monotonic()
    for b in shard_vlm_batches(vcfg, dev):
        state, met = vstep(state, b)
        vseen.append([float(met["loss"]), float(met["grad_norm"])])
    torch.cuda.synchronize()
    vwall = time.monotonic() - t1
    vupdate = sum(update_sq(vmodel, state["params"]).values()) ** 0.5
    print(f"[shard] (d3) one device: {len(vseen)} steps of "
          f"{vcfg.name} at {vcfg.n_layers} layers in {vwall:.3f} s, "
          f"loss and grad_norm by step {vseen}; update norm "
          f"{vupdate!r}", flush=True)
    del vmodel, state, vstep, met
    gc.collect()
    torch.cuda.empty_cache()
    Path(tmp, "train_tp.json").write_text(json.dumps({
        "d1": train_first,
        "d3": {"metrics": vseen, "update_norm": vupdate}}))
    print(f"[shard] (d)'s single-device references in "
          f"{time.monotonic() - t0:.1f} s", flush=True)
    events["shard"].set()
    # (d4)'s walk, in this process (no default group here) while the ranks
    # run
    part("(d4) walk")
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_abstract_mesh
    from repro_torch.launch.shapes import ShapeCase
    t1 = time.monotonic()
    walked, _, _ = dryrun.walk_cell(
        cfg, ShapeCase("shard_train", S, B, "train"),
        make_abstract_mesh((1, SHARD_RANKS), ("data", "model")))
    walk_s = time.monotonic() - t1
    part("ranks")
    await_ranks(ranks_ctx, events["shard_done"])
    ranks = [json.loads(Path(tmp, f"rank{r}.json").read_text())
             for r in range(SHARD_RANKS)]
    print(f"[shard] {SHARD_RANKS} ranks done in "
          f"{time.monotonic() - t_ranks:.1f} s (spawn included); (d4)'s walk "
          f"in this process meanwhile {walk_s:.1f} s", flush=True)
    for r, res in enumerate(ranks):
        print_laps("shard", f"rank {r}", res["walls"])
    part("results")
    # (d4): each rank's card step against the walk
    for r, res in enumerate(ranks):
        card = res["tp_train"]["d4"]
        rel = abs(card["peak"] - walked["bytes_per_device"]["peak"]) / \
            card["peak"]
        ok = card["flops"] == walked["flops"] and rel <= SHARD_WALK_TOL
        print(f"[shard] (d4) rank {r}: the walk's FLOPs "
              f"{walked['flops']} against the card's {card['flops']}, its "
              f"peak {walked['bytes_per_device']['peak']} B against the "
              f"card's {card['peak']} B ({100 * rel:.2f}% apart, at most "
              f"{100 * SHARD_WALK_TOL:.0f}%), the walk {walk_s:.1f} s: "
              f"{ok}", flush=True)
        if not ok:
            raise SystemExit(f"shard: (d4) rank {r}'s step is off its walk")
    for r, res in enumerate(ranks):
        tt = res["tp_train"]
        print(f"[shard] (d) rank {r}: d1 state {tt['d1']['state_bytes']} B, "
              f"peak {tt['d1']['peak_bytes']} B "
              f"({100 * tt['d1']['peak_share']:.1f}% of one device's), walls "
              f"{[round(w, 3) for w in tt['d1']['walls_s']]} s; d3 state "
              f"{tt['d3']['state_bytes']} B, peak {tt['d3']['peak_bytes']} "
              f"B, walls {[round(w, 3) for w in tt['d3']['walls_s']]} s; "
              f"{smi_line}", flush=True)
    # K1's launches on each rank, by part of the phase
    by_path["olm_matmul_fused"]["shard"] = {
        f"rank {r}": res["launches"] for r, res in enumerate(ranks)}
    rank_walls = {r: res["serve"]["wall_s"] for r, res in enumerate(ranks)}
    print(f"[shard] serve wall by rank {rank_walls} s against the serve "
          f"phase's "
          f"single-device olm16 "
          f"{serve_stats['serve olm16']['wall']:.3f} s; {smi_line}",
          flush=True)
    gc.collect()
    torch.cuda.empty_cache()

    # 13b. the partitioned serve steps over two ranks on the one card ------
    phase("tp")
    from repro_torch.distributed.train import init_serve_params
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_abstract_mesh
    from repro_torch.launch.shapes import ShapeCase
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[tp] memory on the card before the phase: "
          f"{torch.cuda.memory_allocated()} B allocated; {smi_line}",
          flush=True)

    def gate(tag, got, want, vocab):
        """Logits within TP_LOGIT_TOL of the single device's largest
        |logit| over the `vocab` real columns (the padding's hold -1e9):
        the gate's reading."""
        err = rel_real(got, want, vocab)
        print(f"[tp] {tag}: the first prefill's logits within {err:.3e} of "
              f"the single device's largest |logit| (gate {TP_LOGIT_TOL})",
              flush=True)
        if not err <= TP_LOGIT_TOL:
            raise SystemExit(f"tp: {tag} logits {err:.3e} off one device's")
        return err

    def same(a, b):
        return sum(x == y for p, q in zip(a, b) for x, y in zip(p, q))

    t_phase = time.monotonic()
    cfg = get_config(TP["arch"])
    prompts = tp_prompts(cfg.vocab_size)
    per_pass = gemms_per_pass(cfg)
    ones = {}
    # (a) on one device, on the same bf16 serve params
    part("(a) one device")
    params = init_serve_params(Model(cfg, device=dev), None, TP["seed"])
    with olm_calls({0}) as seen:
        ones["olm16"] = tp_whole_serve(cfg, params, "olm16", prompts, dev)
    wq0 = seen[0]
    ones["native"] = tp_whole_serve(cfg, params, "native", prompts, dev)
    # the whole weights the ranks' column blocks are held against
    wq_whole = params["layers"][0]["attn"]["wq"].cpu()
    head_whole = params["unembed"]["table"].cpu()
    del params
    part("(d) one device")
    cut = dataclasses.replace(cfg, **TP_CUT)
    params = init_serve_params(Model(cut, device=dev), None, TP["seed"])
    ones["cut"] = tp_whole_serve(cut, params, "native", prompts, dev)
    del params
    # (h), (i) and (j) on one device, on the same bf16 serve params
    t0 = time.monotonic()
    part("(h) one device")
    rec = get_config(TP["rec"])
    params = init_serve_params(Model(rec, device=dev), None, TP["seed"])
    ones["rec"] = tp_whole_serve(rec, params, "native",
                                 tp_prompts(rec.vocab_size), dev)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    part("(i) one device")
    rcut = dataclasses.replace(rec, **TP_REC_CUT)
    params = init_serve_params(Model(rcut, device=dev), None, TP["seed"])
    with olm_calls({0}) as seen:
        ones["rec_olm"] = tp_whole_serve(rcut, params, "olm16",
                                         tp_prompts(rcut.vocab_size), dev)
    wx0 = seen[0]
    rec_head = params["unembed"]["table"].cpu()
    del params, seen
    part("(j) one device")
    ssm = get_config(TP["ssm"])
    params = init_serve_params(Model(ssm, device=dev), None, TP["seed"])
    ones["ssm"] = tp_whole_serve(ssm, params, "olm16",
                                 tp_prompts(ssm.vocab_size), dev)
    del params
    print(f"[tp] one device, (h), (i) and (j): {time.monotonic() - t0:.1f} "
          "s, the inits included", flush=True)
    # (m) and (n), then (o), on one device: each arch's bf16 serve params
    # drawn once, served as published native and cut under olm16
    t0 = time.monotonic()
    vlm = get_config(TP["vlm"])
    vcut = dataclasses.replace(vlm, **TP_VLM_CUT)
    part("(m) one device")
    params = init_serve_params(Model(vlm, device=dev), None, TP["seed"])
    ones["vlm"] = tp_whole_serve(vlm, params, "native",
                                 tp_prompts(vlm.vocab_size), dev)
    part("(n) one device")
    with olm_calls({0, tp_cross_wk(vcut)}) as seen:
        ones["vlm_olm"] = tp_whole_serve(vcut, tp_cut_params(params, vcut),
                                         "olm16", tp_prompts(vcut.vocab_size),
                                         dev)
    vlm_wq0, vlm_wk0 = seen[0], seen[tp_cross_wk(vcut)]
    vlm_head = params["unembed"]["table"].cpu()
    del params, seen
    gc.collect()
    torch.cuda.empty_cache()
    enc = get_config(TP["encdec"])
    ecut = dataclasses.replace(enc, **TP_ENCDEC_CUT)
    part("(o) one device")
    params = init_serve_params(Model(enc, device=dev), None, TP["seed"])
    ones["encdec"] = tp_whole_serve(enc, params, "native",
                                    tp_prompts(enc.vocab_size), dev)
    with olm_calls({0}) as seen:
        ones["encdec_olm"] = tp_whole_serve(
            ecut, tp_cut_params(params, ecut), "olm16",
            tp_prompts(ecut.vocab_size), dev)
    enc_wq0 = seen[0]
    del params, seen
    print(f"[tp] one device, (m), (n) and (o): {time.monotonic() - t0:.1f} "
          "s, the inits included", flush=True)
    for tag, (first, tokens, passes, wall) in ones.items():
        ones[tag] = (first.cpu(), tokens, passes, wall)
        print(f"[tp] one device, {tag}: {passes} passes in {wall:.3f} s",
              flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    big = get_config(TP["big"])
    describe("tp", big)
    free, total = torch.cuda.mem_get_info()
    print(f"[tp] the card before the ranks' parts: {free} B free of "
          f"{total}; this process {torch.cuda.memory_reserved()} B reserved",
          flush=True)
    events["tp"].set()
    part("ranks")
    # the walks, in this process (no default group here) while the ranks
    # run: (c) InternLM2's decode
    kind, B, T = TP_DECODE
    t0_walk = time.monotonic()
    walked, coll, _ = dryrun.walk_cell(
        cfg, ShapeCase("tp_decode", T, B, kind),
        make_abstract_mesh((1, TP_RANKS), ("data", "model")))
    walk_s = time.monotonic() - t0_walk
    # (g) the MoE decode's walk
    arch, depth = MOE_DEPTH[-1]
    moe_cut = dataclasses.replace(get_config(arch), n_layers=depth)
    t0_walk = time.monotonic()
    walked_moe, coll_moe, _ = dryrun.walk_cell(
        moe_cut, ShapeCase("tp_moe_decode", T, B, kind),
        make_abstract_mesh((1, TP_RANKS), ("data", "model")))
    walk_moe_s = time.monotonic() - t0_walk
    # (k) the recurrent decode's walk
    t0_walk = time.monotonic()
    walked_rec, coll_rec, _ = dryrun.walk_cell(
        rec, ShapeCase("tp_rec_decode", T, B, kind),
        make_abstract_mesh((1, TP_RANKS), ("data", "model")))
    walk_rec_s = time.monotonic() - t0_walk
    # (p) the VLM cut's decode's walk, with its memory
    t0_walk = time.monotonic()
    walked_vlm, coll_vlm, _ = dryrun.walk_cell(
        vcut, ShapeCase("tp_vlm_decode", T, B, kind),
        make_abstract_mesh((1, TP_RANKS), ("data", "model")))
    walk_vlm_s = time.monotonic() - t0_walk
    t0 = time.monotonic()
    # a rank that raises fails this call, and with it the script
    while not ranks_ctx.join():
        pass
    ranks = [torch.load(os.path.join(tmp, f"tp{r}.pt"))
             for r in range(TP_RANKS)]
    one = torch.load(os.path.join(tmp, "one.pt"))
    moe_one = torch.load(os.path.join(tmp, "moe_one.pt"))
    print(f"[tp] the ranks done {time.monotonic() - t0:.1f} s after the "
          f"walks in this process: (c) {walk_s:.1f} s, (g) "
          f"{walk_moe_s:.1f} s, (k) {walk_rec_s:.1f} s, (p) "
          f"{walk_vlm_s:.1f} s", flush=True)
    for r in range(TP_RANKS):
        print_laps("tp", f"rank {r}", torch.load(
            os.path.join(tmp, f"tp_walls{r}.pt")))
    ones["big"] = (one["first"], one["tokens"], one["passes"], one["wall"])
    print(f"[tp] one device (rank 0's process), {big.name}: bf16 serve "
          f"params drawn in {one['init_s']:.1f} s, {one['passes']} passes "
          f"in {one['wall']:.3f} s, max_memory_allocated {one['peak']} B "
          f"({one['peak'] / 2**30:.2f} GiB)", flush=True)

    def gathered(tag):
        return torch.cat([r[tag]["first"] for r in ranks], dim=-1)

    part("results")

    # (a) bits: layer 0's wq and the head, each rank's columns
    n_wq = wq_whole.shape[1] // TP_RANKS
    n_head = head_whole.shape[0] // TP_RANKS
    bits = []
    for r, res in enumerate(ranks):
        x, out = res["olm16"]["wq"]
        cols = slice(r * n_wq, (r + 1) * n_wq)
        wq_ok = bits_equal(x, wq0[0]) and bits_equal(out, wq0[1][:, cols])
        hx, hout = res["olm16"]["head"]
        want = olm_matmul(hx.to(dev), head_whole[r * n_head:(r + 1) * n_head]
                          .to(dev).T.to(torch.float32), n_bits=16)
        head_ok = bits_equal(hout.to(dev), want)
        bits.append((wq_ok, head_ok))
        print(f"[tp] (a) rank {r}: layer 0's wq input equal to one device's"
              f" and its {n_wq} columns of the output bit-equal to one "
              f"device's K1: {wq_ok}; the head's {n_head} local logits "
              f"bit-equal to K1 on the whole table's columns at the rank's "
              f"input: {head_ok}; K1 launches {res['olm16']['launches']} "
              f"== GEMMs issued {res['olm16']['gemms']}", flush=True)
    if not all(all(b) for b in bits):
        raise SystemExit(f"tp: column blocks off one device's K1: {bits}")
    del wq0, wq_whole, head_whole
    gate("(a) olm16", gathered("olm16"), ones["olm16"][0], cfg.vocab_size)
    gate("(a) native bf16", gathered("native"), ones["native"][0],
         cfg.vocab_size)
    serve_tokens = [[int(t) for t in out] for out in outputs["olm16"]]
    n_tok = sum(map(len, serve_tokens))
    for tag in ("olm16", "native"):
        got = ranks[0][tag]["tokens"]
        print(f"[tp] (a) {tag}: tokens equal to one device's on the same "
              f"bf16 params {same(got, ones[tag][1])} of {n_tok}; to the "
              f"serve phase's olm16 tokens (f32 weights) "
              f"{same(got, serve_tokens)} of {n_tok}; wall by rank "
              f"{[round(r[tag]['wall'], 3) for r in ranks]} s against one "
              f"device's {ones[tag][3]:.3f} s", flush=True)
    # (c) the walk against each rank's step on the card
    for r, res in enumerate(ranks):
        card = res["card"]
        rel = walked["bytes_per_device"]["peak"] / card["peak"] - 1
        print(f"[tp] (c) rank {r}: FLOPs walk {walked['flops']} card "
              f"{card['flops']}; peak walk "
              f"{walked['bytes_per_device']['peak']} B card {card['peak']} "
              f"B ({rel:+.2%}; gate {DRYRUN_PEAK_TOL:.0%}); the walk's "
              f"collectives {coll['per_axis']} B, {coll['count']} calls",
              flush=True)
        if walked["flops"] != card["flops"] or abs(rel) > DRYRUN_PEAK_TOL:
            raise SystemExit(f"tp: the walk is off rank {r}'s step")
    # (d) and (b) against one device
    gate("(d) the cache over its length, uneven heads", gathered("cut"),
         ones["cut"][0], cut.vocab_size)
    gate(f"(b) {big.name}", gathered("big"), ones["big"][0], big.vocab_size)
    for r, res in enumerate(ranks):
        b = res["big"]
        print(f"[tp] (b) rank {r}: {b['held']} B of bf16 serve blocks "
              f"(the specs' count), drawn in {b['init_s']:.1f} s; serve "
              f"wall {b['wall']:.3f} s against one device's "
              f"{ones['big'][3]:.3f} s; max_memory_allocated {b['peak']} B "
              f"({b['peak'] / 2**30:.2f} GiB)", flush=True)
    print(f"[tp] (b) tokens equal to one device's "
          f"{same(ranks[0]['big']['tokens'], ones['big'][1])} of "
          f"{sum(map(len, ones['big'][1]))}; (d) "
          f"{same(ranks[0]['cut']['tokens'], ones['cut'][1])}", flush=True)
    # (e) the MoE archs against one device
    for arch, _ in MOE_DEPTH:
        one, name = moe_one[arch], get_config(arch).name
        for r, res in enumerate(ranks):
            e = res["moe"][arch]
            wq_ok, head_ok = one["bits"][r]
            print(f"[tp] (e) {name} rank {r}: experts split {e['layout']}, "
                  f"this rank's experts {e['experts']}; {e['held']} B of "
                  f"bf16 serve blocks (the specs' count), the init's peak "
                  f"{e['init_peak']} B; layer 0's wq input equal to one "
                  f"device's and its {one['n_wq']} columns bit-equal to "
                  f"one device's K1: {wq_ok}; the head's {one['n_head']} "
                  f"local logits bit-equal to K1 on the whole table's "
                  f"columns at the rank's input: {head_ok}; K1 launches "
                  f"{e['launches']} == GEMMs issued {e['gemms']}; wall "
                  f"{e['wall']:.3f} s against one device's "
                  f"{one['wall']:.3f} s", flush=True)
            if not (wq_ok and head_ok):
                raise SystemExit(f"tp: (e) {name} rank {r}'s column blocks "
                                 "off one device's K1")
        plans = [res["moe"][arch]["plans"] for res in ranks]
        alike = all(len(p) == len(plans[0]) and all(
            torch.equal(a, b) for a, b in zip(p, plans[0])) for p in plans)
        print(f"[tp] (e) {name}: {len(plans[0])} dispatch plans a rank, "
              f"every rank's identical: {alike}", flush=True)
        if not alike:
            raise SystemExit(f"tp: (e) {name}'s ranks routed apart")
        gate(f"(e) {name} olm16", torch.cat(
            [res["moe"][arch]["first"] for res in ranks], dim=-1),
            one["first"], get_config(arch).vocab_size)
        n_tok = sum(map(len, one["tokens"]))
        print(f"[tp] (e) {name}: tokens equal to one device's "
              f"{same(ranks[0]['moe'][arch]['tokens'], one['tokens'])} of "
              f"{n_tok}", flush=True)
    # (f) the ring over its length against one device
    ring = moe_one["ring"]
    gate("(f) the ring over its length", gathered("ring"), ring["first"],
         get_config("mixtral_8x22b").vocab_size)
    print(f"[tp] (f) tokens equal to one device's "
          f"{same(ranks[0]['ring']['tokens'], ring['tokens'])} of "
          f"{sum(map(len, ring['tokens']))}; wall by rank "
          f"{[round(r['ring']['wall'], 3) for r in ranks]} s against one "
          f"device's {ring['wall']:.3f} s", flush=True)
    def held_to_walk(tag, key, walked, coll, walk_s):
        """A decode's walk against each rank's step on the card (res[key]):
        FLOPs equal, peak within DRYRUN_PEAK_TOL."""
        for r, res in enumerate(ranks):
            card = res[key]
            rel = walked["bytes_per_device"]["peak"] / card["peak"] - 1
            print(f"[tp] {tag} rank {r}: FLOPs walk {walked['flops']} card "
                  f"{card['flops']}; peak walk "
                  f"{walked['bytes_per_device']['peak']} B card "
                  f"{card['peak']} B ({rel:+.2%}; gate "
                  f"{DRYRUN_PEAK_TOL:.0%}); the walk's collectives "
                  f"{coll['per_axis']} B, {coll['count']} calls, walked in "
                  f"{walk_s:.1f} s", flush=True)
            if walked["flops"] != card["flops"] or \
                    abs(rel) > DRYRUN_PEAK_TOL:
                raise SystemExit(f"tp: {tag} the walk is off rank {r}'s "
                                 "step")

    # (g) the MoE decode's walk against each rank's step on the card
    held_to_walk("(g)", "moe_card", walked_moe, coll_moe, walk_moe_s)
    # (h) the recurrent arch as published against one device
    for r, res in enumerate(ranks):
        h = res["rec"]
        print(f"[tp] (h) {rec.name} rank {r}: {h['held']} B of bf16 serve "
              f"blocks (the specs' count), drawn in {h['init_s']:.1f} s, "
              f"the init's peak {h['init_peak']} B (at most the blocks and "
              f"{h['biggest']} B); wall {h['wall']:.3f} s against one "
              f"device's {ones['rec'][3]:.3f} s", flush=True)
    gate(f"(h) {rec.name} native", gathered("rec"), ones["rec"][0],
         rec.vocab_size)
    n_tok = sum(map(len, ones["rec"][1]))
    print(f"[tp] (h) tokens equal to one device's "
          f"{same(ranks[0]['rec']['tokens'], ones['rec'][1])} of {n_tok}; "
          f"one device's tokens {ones['rec'][1]}, the ranks' "
          f"{ranks[0]['rec']['tokens']}", flush=True)
    # (i) the cut under olm16: wx's and the head's columns, bit for bit
    n_wx = wx0[1].shape[1] // TP_RANKS
    n_head = rec_head.shape[0] // TP_RANKS
    for r, res in enumerate(ranks):
        i = res["rec_olm"]
        x, out = i["wx"]
        wx_ok = bits_equal(x, wx0[0]) and bits_equal(
            out, wx0[1][:, r * n_wx:(r + 1) * n_wx])
        hx, hout = i["head"]
        head_ok = bits_equal(hout.to(dev), olm_matmul(
            hx.to(dev), rec_head[r * n_head:(r + 1) * n_head].to(dev).T
            .to(torch.float32), n_bits=16))
        print(f"[tp] (i) rank {r}: layer 0's wx input equal to one device's "
              f"and its {n_wx} columns of the output bit-equal to one "
              f"device's K1: {wx_ok}; the head's {n_head} local logits "
              f"bit-equal to K1 on the whole table's columns at the rank's "
              f"input: {head_ok}; K1 launches {i['launches']} == GEMMs "
              f"issued {i['gemms']}; wall {i['wall']:.3f} s against one "
              f"device's {ones['rec_olm'][3]:.3f} s", flush=True)
        if not (wx_ok and head_ok):
            raise SystemExit(f"tp: (i) rank {r}'s column blocks off one "
                             "device's K1")
    del wx0, rec_head
    gate(f"(i) {rcut.name} at {rcut.n_layers} layers olm16",
         gathered("rec_olm"), ones["rec_olm"][0], rcut.vocab_size)
    print(f"[tp] (i) tokens equal to one device's "
          f"{same(ranks[0]['rec_olm']['tokens'], ones['rec_olm'][1])} of "
          f"{sum(map(len, ones['rec_olm'][1]))}", flush=True)
    # (j) each rank's rows against one device's
    for r, res in enumerate(ranks):
        j = res["ssm"]
        lanes = j["lanes"]
        mine, want = j["first"], ones["ssm"][0][lanes]
        print(f"[tp] (j) {ssm.name} rank {r}: {j['held']} B resident (the "
              f"whole model); rows {lanes} bit-equal to one device's "
              f"rows: {bits_equal(mine, want)}; tokens equal "
              f"{same(j['tokens'], [ones['ssm'][1][i] for i in lanes])} of "
              f"{sum(map(len, j['tokens']))}; K1 launches {j['launches']} "
              f"== GEMMs issued {j['gemms']} ({j['per']} a pass); wall "
              f"{j['wall']:.3f} s against one device's "
              f"{ones['ssm'][3]:.3f} s", flush=True)
        gate(f"(j) {ssm.name} olm16 rank {r}'s rows", mine, want,
             ssm.vocab_size)
    # (k) the recurrent decode's walk against each rank's step
    held_to_walk("(k)", "rec_card", walked_rec, coll_rec, walk_rec_s)
    # (l) F10: two serves of the same requests, the same bits
    f10 = [("partitioned", f"rank {r}", res["moe"][TP_F10]["f10"])
           for r, res in enumerate(ranks)]
    f10.append(("one device", "", moe_one[TP_F10]["f10"]))
    for side, who, f in f10:
        print(f"[tp] (l) {get_config(TP_F10).name} {side} {who}: served "
              f"twice, every pass's logits bit-equal {f['bits']} over "
              f"{f['passes']} passes, tokens equal {f['tokens']}; walls "
              f"{[round(w, 3) for w in f['walls']]} s", flush=True)
        if not (f["bits"] and f["tokens"]):
            raise SystemExit(f"tp: (l) F10: {side} {who} gave other bits "
                             "on a second serve")
    # (m) the VLM arch as published against one device
    for r, res in enumerate(ranks):
        m = res["vlm"]
        print(f"[tp] (m) {vlm.name} rank {r}: {m['held']} B of bf16 serve "
              f"blocks (the specs' count), drawn in {m['init_s']:.1f} s, "
              f"the init's peak {m['init_peak']} B (at most the blocks and "
              f"{m['biggest']} B); wall {m['wall']:.3f} s against one "
              f"device's {ones['vlm'][3]:.3f} s", flush=True)
    gate(f"(m) {vlm.name} native", gathered("vlm"), ones["vlm"][0],
         vlm.vocab_size)
    print(f"[tp] (m) tokens equal to one device's "
          f"{same(ranks[0]['vlm']['tokens'], ones['vlm'][1])} of "
          f"{sum(map(len, ones['vlm'][1]))}", flush=True)
    # (n) the cut under olm16: wq's, the cross wk's and the head's columns
    n_wq, n_wk = vlm_wq0[1].shape[1] // TP_RANKS, \
        vlm_wk0[1].shape[1] // TP_RANKS
    n_head = vlm_head.shape[0] // TP_RANKS
    for r, res in enumerate(ranks):
        n = res["vlm_olm"]
        ok = []
        for (x, out), (x0, out0), w in ((n["wq"], vlm_wq0, n_wq),
                                        (n["wk"], vlm_wk0, n_wk)):
            ok.append(bits_equal(x, x0) and bits_equal(
                out, out0[:, r * w:(r + 1) * w]))
        hx, hout = n["head"]
        ok.append(bits_equal(hout.to(dev), olm_matmul(
            hx.to(dev), vlm_head[r * n_head:(r + 1) * n_head].to(dev).T
            .to(torch.float32), n_bits=16)))
        print(f"[tp] (n) rank {r}: layer 0's wq input equal to one device's "
              f"and its {n_wq} columns of the output bit-equal to one "
              f"device's K1: {ok[0]}; the cross layer's wk on the memory's "
              f"{tuple(n['wk'][0].shape)} rows, its {n_wk} columns: "
              f"{ok[1]}; the head's {n_head} local logits bit-equal to K1 "
              f"on the whole table's columns at the rank's input: {ok[2]}; "
              f"K1 launches {n['launches']} == GEMMs issued {n['gemms']}; "
              f"wall {n['wall']:.3f} s against one device's "
              f"{ones['vlm_olm'][3]:.3f} s", flush=True)
        if not all(ok):
            raise SystemExit(f"tp: (n) rank {r}'s column blocks off one "
                             "device's K1")
    del vlm_wq0, vlm_wk0, vlm_head
    gate(f"(n) {vcut.name} at {vcut.n_layers} layers olm16",
         gathered("vlm_olm"), ones["vlm_olm"][0], vcut.vocab_size)
    print(f"[tp] (n) tokens equal to one device's "
          f"{same(ranks[0]['vlm_olm']['tokens'], ones['vlm_olm'][1])} of "
          f"{sum(map(len, ones['vlm_olm'][1]))}", flush=True)
    # (o) the enc-dec arch, native as published and the cut under olm16
    n_wq = enc_wq0[1].shape[1] // TP_RANKS
    for r, res in enumerate(ranks):
        o, oo = res["encdec"], res["encdec_olm"]
        x, out = oo["wq"]
        wq_ok = bits_equal(x, enc_wq0[0]) and bits_equal(
            out, enc_wq0[1][:, r * n_wq:(r + 1) * n_wq])
        print(f"[tp] (o) {enc.name} rank {r}: {o['held']} B of bf16 serve "
              f"blocks (the specs' count), drawn in {o['init_s']:.1f} s; "
              f"native wall {o['wall']:.3f} s against one device's "
              f"{ones['encdec'][3]:.3f} s; the cut's first encoder wq on "
              f"{tuple(x.shape)} frame rows, its {n_wq} columns bit-equal "
              f"to one device's K1: {wq_ok}; K1 launches {oo['launches']} "
              f"== GEMMs issued {oo['gemms']}; olm16 wall {oo['wall']:.3f} "
              f"s against one device's {ones['encdec_olm'][3]:.3f} s",
              flush=True)
        if not wq_ok:
            raise SystemExit(f"tp: (o) rank {r}'s encoder wq columns off "
                             "one device's K1")
    del enc_wq0
    gate(f"(o) {enc.name} native", gathered("encdec"), ones["encdec"][0],
         enc.vocab_size)
    gate(f"(o) {ecut.name} at {ecut.n_enc_layers} + {ecut.n_layers} layers "
         "olm16", gathered("encdec_olm"), ones["encdec_olm"][0],
         ecut.vocab_size)
    print(f"[tp] (o) tokens equal to one device's: native "
          f"{same(ranks[0]['encdec']['tokens'], ones['encdec'][1])}, olm16 "
          f"{same(ranks[0]['encdec_olm']['tokens'], ones['encdec_olm'][1])}"
          f" of {sum(map(len, ones['encdec'][1]))}", flush=True)
    # (p) the VLM cut's decode's walk against each rank's step
    held_to_walk("(p)", "vlm_card", walked_vlm, coll_vlm, walk_vlm_s)
    print(f"[tp] the phase {time.monotonic() - t_phase:.1f} s; {smi_line}",
          flush=True)
    by_path["olm_matmul_fused"]["tp"] = {
        f"rank {r}": res["olm16"]["launches"] for r, res in enumerate(ranks)}
    for arch, _ in MOE_DEPTH:
        by_path["olm_matmul_fused"]["tp"].update({
            f"rank {r} (e) {get_config(arch).name}":
            res["moe"][arch]["launches"] for r, res in enumerate(ranks)})
    for tag, key in (("(i)", "rec_olm"), ("(j)", "ssm"), ("(n)", "vlm_olm"),
                     ("(o)", "encdec_olm")):
        by_path["olm_matmul_fused"]["tp"].update({
            f"rank {r} {tag}": res[key]["launches"]
            for r, res in enumerate(ranks)})
    del ranks, ones, moe_one
    gc.collect()
    torch.cuda.empty_cache()

    # 14. the port's examples --------------------------------------------
    phase("examples")
    reset_counts()
    results = {}
    for example, argv in EXAMPLES:
        part(example)
        t0 = time.monotonic()
        spec = importlib.util.spec_from_file_location(
            f"example_{example}", ROOT / "examples" / f"{example}.py")
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        text = io.StringIO()
        with contextlib.redirect_stdout(text):
            results[example] = module.main(argv)
        torch.cuda.synchronize()
        tail = text.getvalue().strip().splitlines()[-2:]
        print(f"[examples] {example} {' '.join(argv)}: "
              f"{time.monotonic() - t0:.1f} s; " + " | ".join(tail),
              flush=True)
    part()
    counts = read_counts()
    for kernel, n in counts.items():
        by_path.setdefault(kernel, {})["examples"] = n
    numerics = results["online_numerics_matmul_torch"]
    paged, contig = results["serve_batched_torch"]
    if not (numerics["olm_bitwise"] and numerics["finite"]
            and numerics["launches"]["olm_matmul_fused"] > 0
            and numerics["launches"]["tpmm"] > 0):
        raise SystemExit(f"the numerics example failed its checks: "
                         f"{numerics}")
    if not (paged["n"] == contig["n"] == 10 and paged["kv"]["integrity_ok"]
            and contig["kv"]["integrity_ok"]):
        raise SystemExit("the serve example did not answer its 10 requests "
                         "with its caches intact")
    if not results["train_lm_torch"]["loss_improved"]:
        raise SystemExit("the train example's loss did not improve")
    print(f"[examples] launches over the phase {counts}; numerics on "
          f"{numerics['device']}: K1 == plain bitwise, olm16 MLP rel "
          f"{numerics['mlp_rel']:.2e}, tpmm16 argmax agreement "
          f"{numerics['argmax_agree']:.3f}; serve KV resident paged "
          f"{paged['kv']['kv_bytes_resident']} B against contiguous "
          f"{contig['kv']['kv_bytes_resident']} B; train loss "
          f"{results['train_lm_torch']['loss_first']:.4f} -> "
          f"{results['train_lm_torch']['loss_last']:.4f}", flush=True)
    # 15. the dry run held against the card --------------------------------
    phase("dryrun")
    from repro_torch.launch import dryrun
    from repro_torch.launch.shapes import ShapeCase
    gc.collect()
    torch.cuda.empty_cache()
    reset_counts()
    # (a) the walk against the card, one rank
    cfg = get_config(TRAIN["arch"])
    for kind, Bd, Sd in DRYRUN_CARD:
        part(f"(a) {kind}")
        case = ShapeCase(f"card_{kind}", Sd, Bd, kind)
        got = dryrun.hold_against_card(cfg, case)
        pred, card = got["walk"], got["card"]
        terms = pred["terms"]
        peak_rel = pred["bytes_per_device"]["peak"] / card["peak"] - 1
        bound_s = terms["bound_s"]
        print(f"[dryrun] {cfg.name} {kind} {Bd} x {Sd} on a one-rank "
              f"mesh: FLOPs walk {pred['flops']} card {card['flops']}; "
              f"peak walk {pred['bytes_per_device']['peak']} B card "
              f"{card['peak']} B ({peak_rel:+.2%}; gate "
              f"{DRYRUN_PEAK_TOL:.0%}); bound {terms['dominant']} "
              f"{bound_s * 1e3:.3f} ms (compute {terms['compute_s'] * 1e3:.3f}"
              f", memory {terms['memory_s'] * 1e3:.3f}) against the "
              f"card's wall {card['wall_s'] * 1e3:.3f} ms (walls "
              f"{[round(w * 1e3, 3) for w in card['walls_s']]}), "
              f"{bound_s / card['wall_s']:.3f} of it (gate "
              f"{DRYRUN_BOUND_SLACK}); walk bytes {pred['bytes']}, "
              f"{pred['ops']} ops; {smi_line}", flush=True)
        if kind == "train":
            print(f"[dryrun] the train phase's single-device step of "
                  f"this configuration: peak {train_native['peak']} B, "
                  f"median wall {train_native['wall'] * 1e3:.1f} ms",
                  flush=True)
        if pred["flops"] != card["flops"]:
            raise SystemExit(f"dryrun: the walk's FLOPs of the {kind} "
                             f"step are not the card's")
        if abs(peak_rel) > DRYRUN_PEAK_TOL:
            raise SystemExit(f"dryrun: the walk's peak of the {kind} "
                             f"step is {peak_rel:+.2%} off the card's")
        if bound_s > DRYRUN_BOUND_SLACK * card["wall_s"]:
            raise SystemExit(f"dryrun: the {kind} step's roofline bound "
                             f"exceeds the card's wall")
        gc.collect()
        torch.cuda.empty_cache()
    # (b) the production cells
    part("(b) the cells' processes, what is left of them")
    for i, (proc, (arch, shape, *more)) in enumerate(zip(procs,
                                                         DRYRUN_CELLS)):
        proc.wait(timeout=600)
        text = Path(out_dir, f"cell{i}.log").read_text()
        lines = [ln for ln in text.splitlines()
                 if ln.startswith(("OK", "SKIP", "FAIL"))]
        for ln in lines:
            print(f"[dryrun] {ln}", flush=True)
        want = 2 if more else 1
        if proc.returncode != 0 or sum(
                ln.startswith("OK") for ln in lines) != want:
            raise SystemExit(f"dryrun: {arch} x {shape} failed (exit "
                             f"{proc.returncode}): {text[-2000:]}")
    for f in sorted(Path(out_dir).glob("*.json")):
        rec = json.loads(f.read_text())
        print(f"[dryrun] record {f.name}: peak "
              f"{rec['bytes_per_device']['peak']} B a rank, fits "
              f"{rec['fits']}, flops {rec['flops']}, collectives "
              f"{rec['collectives']['per_axis']}, "
              f"{rec['roofline']['dominant']} "
              f"{rec['roofline']['bound_s']:.4g} s", flush=True)
    counts = read_counts()
    for kernel, n in counts.items():
        by_path.setdefault(kernel, {})["dryrun"] = n
    print(f"[dryrun] launches over the phase {counts} (the dry run runs the "
          f"native GEMMs, as the reference's does)", flush=True)
    phase(None)
    print(f"[wall] phases: {json.dumps({k: round(v, 1) for k, v in walls.items()})}",
          flush=True)
    total = sum(walls.values())
    print(f"[wall] sum of phases: {total:.1f} s", flush=True)
    print(f"[wall] budget: {total:.1f} s of SMOKE_BUDGET_S {SMOKE_BUDGET_S} "
          f"s ({100 * total / SMOKE_BUDGET_S:.1f}%)", flush=True)

    # the kernels line --------------------------------------------------
    src = "src/repro_torch/csrc/"
    meta = {
        "olm_matmul_fused": ("olm_matmul.cu",
                             "src/repro/kernels/online_dot/matmul_kernel.py:269"),
        "olm_matmul_host": ("olm_matmul.cu",
                            "src/repro/kernels/online_dot/matmul_kernel.py:196"),
        "online_dot": ("online_dot.cu",
                       "src/repro/kernels/online_dot/kernel.py:87"),
        "online_mul": ("online_mul.cu",
                       "src/repro/kernels/online_mul/kernel.py:134"),
        "tpmm": ("tpmm.cu", "src/repro/kernels/tpmm/kernel.py:109"),
    }
    # the time each entry reports: the decode GEMV for the GEMM kernels
    shown = {"olm_matmul_fused": "decode_gemv", "olm_matmul_host": "decode_gemv",
             "online_dot": "K=256 n=16", "online_mul": "n=16",
             "tpmm": "tpmm16 M=4 K=2048 N=8192"}
    entries = []
    for kernel, (source, replaces) in meta.items():
        head = next(r for r in timed[kernel] if shown[kernel] in r["label"])
        entries.append({
            "name": kernel, "route": "cuda", "source": src + source,
            "replaces": replaces, "launches": launches[kernel],
            "max_abs_err": max_err[kernel], "ms": head["ms"],
            "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
            "bound_by": head["bound_by"], "library_ms": None,
            "shape": head["label"],
            "launches_by_path": by_path.get(kernel, {}),
            "times": [{k: r[k] for k in ("label", "ms", "plain_ms",
                                         "bound_ms", "bound_by")}
                      for r in timed[kernel] if r is not head]})
    print(smi_line)
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    with contextlib.ExitStack() as exits:
        code = main(exits)
    sys.exit(code)
