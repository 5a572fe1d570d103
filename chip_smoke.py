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
               prefill), online_mul (K4) and online_dot (K3) at a million
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
               raising before any launch; F6's configurations (the
               selection condition holds, the residual leaves int32 or
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
               M = 64 on those columns only); K3 and K4 against the
               paper's scalar model
               (core/inner_product.online_dot, core/online_mul.
               online_multiply) row by row; plus the smoke-size model
               under olm16 and under tpmm16 on the card against the same
               model on the CPU;
  4. time    - each kernel at those shapes (and the general K3/K4
               kernels at one shape each, K1 at ChatGLM3-6B's decode and
               prefill GEMMs and at the four families' decode GEMMs)
               beside its bound, its plain
               version and a PyTorch context call: the median of CUDA
               event pairs, one per launch, with the L2 cache overwritten
               before each; a time below its bound fails the run;
  5. serve   - ServeEngine at the full published InternLM2-1.8B width,
               4 seeded requests, once under dot_mode="olm16" (every GEMM
               through K1) and once under "tpmm16" (every GEMM through K5):
               the path's kernel launch count must equal the GEMMs the
               forward passes issued. Each is run a second time with the
               kernel's launches (and, under tpmm16, the plane
               decompositions) between CUDA events, for their share of the
               wall, and a third time under torch.profiler, for the
               device's busy share;
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
  9. families - the recurrent and MoE families: RecurrentGemma-9B (26
               RG-LRU layers, 12 windowed MQA layers) at its full
               published width and depth served like phase 5 under olm16
               but not profiled (launches == passes x 241, every prefill
               at its request's exact length, the same tokens twice,
               kv_report printed);
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
 11. crossattn - Llama-3.2-Vision-11B (40 layers, 8 cross-attention) and
               SeamlessM4T-medium (12 encoder + 12 xdec layers) at full
               published width and depth under olm16, frontend embeddings
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
               seq 256): 20 steps with checkpoints every 10 (the loss
               improves), a resume to 30 (at step 20, the restored state
               bit-equal to the saved one, the stream's batch 20) and a
               straight 30-step run (steps 20-29 within 1e-3 of the
               resumed run's losses).
 13. shard   - the sharded path over two ranks that share the one card
               (NCCL refuses two ranks on one device): two spawned
               processes, both on cuda:0, in a gloo group on 127.0.0.1,
               on ("data", "model") meshes; the single-device results
               they are held against come from this process first.
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
               (1, 2) with the same bits;
  14. examples - the port's four examples (examples/*_torch.py) on the
               card at their documented settings, imported and run in
               this process: the quickstart, the numerics walk-through
               (K5 at tpmm8/16/24, K1 against its plain version, an olm16
               MLP and a tpmm16 smoke model), the batched serve under
               paged and contiguous KV, and the Mamba2-130M train twin at
               8 x 256 for 20 steps at lr 3e-3, whose loss must improve;
               the kernels' launches counted for the path.

Each phase's wall is printed on a line of its own ("[wall] phase ..."),
and their sum after the last.
The line before the last is a JSON object with one entry per kernel; the
last line is {"ok": true, "device": {...}}. Any failure exits non-zero
and prints no result; so does a machine without a CUDA card, and a
directory holding this script without the rest of the repository.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import importlib.util
import io
import json
import os
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

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
# The examples phase: each twin with its arguments (the train twin cut to
# 20 steps at the train phase's CLI learning rate).
EXAMPLES = (("quickstart_torch", []), ("online_numerics_matmul_torch", []),
            ("serve_batched_torch", []),
            ("train_lm_torch", ["--steps", "20", "--lr", "3e-3"]))
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
MAMBA_PROMPT = 31
MOE_DEPTH = (("mixtral_8x22b", 2), ("qwen3_moe_235b_a22b", 2))
# The crossattn phase: Llama-3.2-Vision-11B and SeamlessM4T-medium at full
# published width and depth under olm16, CROSS_LANES lanes with frontend
# embeddings N(0, 1) from the seed: a CROSS_PROMPT-token prefill, then
# CROSS_DECODES decode steps with the memory prefill returned, against
# forward over the prompt and over all CROSS_PROMPT + CROSS_DECODES tokens.
CROSS_ARCHS = ("llama_3_2_vision_11b", "seamless_m4t_medium")
CROSS_LANES, CROSS_PROMPT, CROSS_DECODES = 2, 12, 3
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


def device_busy(fn, name: str):
    """Run fn() under torch.profiler: (seconds the device ran any kernel,
    seconds in kernels whose name holds `name`, device kernels seen)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) \
            as prof:
        fn()
        torch.cuda.synchronize()
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy, lo, hi = 0, None, None
    for a, b in spans:
        if hi is None or a > hi:
            busy += 0 if hi is None else hi - lo
            lo, hi = a, b
        else:
            hi = max(hi, b)
    busy += 0 if hi is None else hi - lo
    own = sum(e.time_range.end - e.time_range.start for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and name in e.name)
    return busy / 1e6, own / 1e6, len(spans)


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


def shard_rank(rank: int, world: int, port: int, tmp: str,
               serve_tokens) -> None:
    """One rank of the shard phase (a process of its own, on cuda:0, in a
    gloo group of `world` ranks on 127.0.0.1). Holds (a)-(c) against the
    single-device results the parent left in `tmp`, raises on any
    disagreement, and writes its numbers to tmp/rank<r>.json."""
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

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world)
    tag = f"[shard r{rank}]"
    res = {"gemms": [], "launches": {}}

    def say(msg):
        print(f"{tag} {msg}", flush=True)

    try:
        meshes = {s: make_local_mesh(*s, device_type="cuda")
                  for s in ((1, 2), (2, 1))}
        say(f"backend {dist.get_backend()}, world {world}, meshes "
            f"{[mesh_shape(m) for m in meshes.values()]}, device "
            f"{torch.cuda.get_device_name(dev)}")
        mesh = meshes[(1, 2)]

        # (a) the sharded GEMMs against one device's K1 ------------------
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
        k12.launches = 0
        t0 = time.monotonic()
        done = engine.run()
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        launched = k12.launches
        peak = torch.cuda.max_memory_allocated()
        gemms = len(passes) * gemms_per_pass(cfg)
        tokens = [r.output for r in sorted(done, key=lambda r: r.rid)]
        same = [list(map(int, t)) for t in tokens] == serve_tokens
        busy, k1_s, n_events = device_busy(seeded_engine().run, "olm_matmul")
        res["serve"] = dict(wall_s=wall, passes=len(passes), gemms=gemms,
                            k1_launches=launched, same_tokens=same,
                            peak_bytes=peak, busy_s=busy, k1_device_s=k1_s,
                            device_kernels=n_events)
        res["launches"]["serve"] = launched
        say(f"(b) {cfg.name} ({cfg.n_layers} layers, d_model "
            f"{cfg.d_model}) served under olm16 with shard='n' on "
            f"{mesh_shape(mesh)}: wall {wall:.3f} s (ends in "
            f"torch.cuda.synchronize), {len(passes)} forward passes, GEMMs "
            f"issued {gemms}, K1 launches {launched}; the serve phase's "
            f"single-device tokens: {same}; peak memory {peak} bytes "
            f"({peak / 2**30:.2f} GiB); profiled run: this rank's kernels "
            f"kept the device busy {busy:.3f} s ({100 * busy / wall:.1f}% "
            f"of the first run's wall), K1 {k1_s:.3f} s, {n_events} "
            "kernels")
        if launched != gemms or not same:
            raise RuntimeError(f"(b) K1 launched {launched} times for "
                               f"{gemms} GEMMs, same tokens {same}")
        del params, model, engine, done
        torch.cuda.empty_cache()

        # (c) the sharded train step -------------------------------------
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
        with open(os.path.join(tmp, f"rank{rank}.json"), "w") as f:
            json.dump(res, f)
    finally:
        dist.destroy_process_group()


def main() -> int:
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

    def phase(name):
        """Close the running phase, printing its wall on a line of its own,
        and open `name` (None closes the last)."""
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
                "tpmm": k5.geometry}
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
        "online_mul": k4.online_mul_kernel(xd[:, 0].contiguous(),
                                           yd[:, 0].contiguous(),
                                           OnlinePrecision(n=16)),
        "tpmm": k5.tpmm_kernel(ap, bp, sa, sb, n_bits=16)}
    torch.cuda.synchronize()
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

    def hold_both(label, xs, ws, n, p=None, transposed=False):
        """K1 and K2 against the plain version and K2 against K1; K1 also
        reading w through the transpose of an (N, K) row-major copy."""
        cols = max(1, PLAIN_OUTPUTS // xs.shape[0])
        want = torch.cat([olm_matmul_ref(xs, ws[:, c:c + cols], n_bits=n,
                                         trunc=p)
                          for c in range(0, ws.shape[1], cols)], dim=1)
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
    for shape in SERVE_SHAPES:
        hold_both(f"olm16 M,K,N={shape}", *operands(shape, 2, dev), 16)
        torch.cuda.empty_cache()
    # F7: row blocks past grid y's 65,535 continue in grid z
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

    def plain_olm16(xs, ws, a=0, b=None):
        """The plain olm16 version on columns a:b of w, PLAIN_OUTPUTS
        outputs a call."""
        b = ws.shape[1] if b is None else b
        step = max(1, PLAIN_OUTPUTS // xs.shape[0])
        return torch.cat([olm_matmul_ref(xs, ws[:, c:min(c + step, b)],
                                         n_bits=16)
                          for c in range(a, b, step)], dim=1)

    def hold_k1(label, xs, ws, whole):
        """K1 on the whole GEMM against the plain version on all of its
        columns, or on the first and the last K1_SLICE."""
        got = olm_matmul(xs, ws, n_bits=16)
        N = ws.shape[1]
        spans = ([(0, N)] if whole or N <= 2 * K1_SLICE
                 else [(0, K1_SLICE), (N - K1_SLICE, N)])
        for a, b in spans:
            hold("olm_matmul_fused", f"{label} columns {a}:{b}",
                 got[:, a:b].contiguous(), plain_olm16(xs, ws, a, b))

    # (K1's 64-row prefill is held at the serve shapes above)
    for M, kns, arch in ((4, CHATGLM_KN, "chatglm3_6b"),
                         (4, CUT_KN, "yi_34b / qwen1_5_110b")):
        for K, N in kns:
            xs, ws = operands((M, K, N), 13, dev)
            hold_k1(f"olm16 {arch} M,K,N={(M, K, N)}", xs, ws,
                    whole=M == 4 and arch == "chatglm3_6b")
            del xs, ws
            torch.cuda.empty_cache()
    for arch, kns in FAMILY_KN.items():
        rows = (4,) + (RG_ROWS if arch == "recurrentgemma_9b" else ())
        for M in rows:
            for K, N in kns:
                xs, ws = operands((M, K, N), 15, dev)
                hold_k1(f"olm16 {arch} M,K,N={(M, K, N)}", xs, ws,
                        whole=M < 64 and N <= WHOLE_N)
                del xs, ws
                torch.cuda.empty_cache()
    for arch, kns in CROSS_KN.items():
        for K, N in kns:
            xs, ws = operands((4, K, N), 17, dev)
            hold_k1(f"olm16 {arch} M,K,N={(4, K, N)}", xs, ws,
                    whole=N <= WHOLE_N)
            del xs, ws
            torch.cuda.empty_cache()
        for K, N in CROSS_ROWS_KN[arch]:
            xs, ws = operands((ENC_ROWS, K, N), 18, dev)
            got = olm_matmul(xs, ws, n_bits=16)
            for a, b in ((0, ENC_CHECK_ROWS),
                         (ENC_ROWS - ENC_CHECK_ROWS, ENC_ROWS)):
                hold("olm_matmul_fused", f"olm16 {arch} M,K,N="
                     f"{(ENC_ROWS, K, N)} rows {a}:{b}",
                     got[a:b].contiguous(),
                     plain_olm16(xs[a:b].contiguous(), ws))
            del xs, ws, got
            torch.cuda.empty_cache()

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

    for n_bits in (16, 8):
        for label, ops in tpmm_cases(n_bits):
            for mode in TPMM_MODES:
                hold("tpmm", f"tpmm{n_bits} {mode} {label}",
                     k5.tpmm_kernel(*ops, n_bits=n_bits, mode=mode),
                     tpmm_ref(*ops, n_bits=n_bits, mode=mode))
    del ops

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
        rel = float((got.cpu() - want).abs().max() / want.abs().max())
        print(f"[check] smoke model {mode} f32 prefill logits, card vs CPU: "
              f"rel err {rel:.3e} (limit 1e-3)", flush=True)
        if not rel <= 1e-3:
            raise SystemExit(f"smoke model under {mode} on the card disagrees "
                             "with the CPU")

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
    # K1 at ChatGLM3-6B's GEMMs: the 4-lane decode and the 64-row prefill
    # of the dense phase's serve (the plain version timed at M = 4 only:
    # at M = 64 it takes tens of seconds a shape)
    for M in (4, 64):
        for K, N in CHATGLM_KN:
            x, w = operands((M, K, N), 14, dev)
            plan = k12.launch_plan(M, N, K, 16)
            record("olm_matmul_fused", f"olm16 chatglm3_6b M={M} K={K} N={N}",
                   cuda_ms(lambda: k12.olm_matmul_fused(x, w, n=16),
                           reps=10 if M == 4 else 5, warmup=1),
                   cuda_ms(lambda: plain_olm16(x, w), reps=1) if M == 4
                   else None, (M * K + K * N + M * N) * 4,
                   k12.int_ops(M, N, K, n=16), rate,
                   f"plan bm x bn x tb {plan.bm} x {plan.bn} x {plan.tb}")
            del x, w
    # K1 at the recurrent and MoE families' decode GEMMs (the plain
    # version timed up to WHOLE_N columns)
    for arch, kns in FAMILY_KN.items():
        for K, N in kns:
            x, w = operands((4, K, N), 16, dev)
            plan = k12.launch_plan(4, N, K, 16)
            record("olm_matmul_fused", f"olm16 {arch} M=4 K={K} N={N}",
                   cuda_ms(lambda: k12.olm_matmul_fused(x, w, n=16), reps=5,
                           warmup=1),
                   cuda_ms(lambda: plain_olm16(x, w), reps=1)
                   if N <= WHOLE_N else None, (4 * K + K * N + 4 * N) * 4,
                   k12.int_ops(4, N, K, n=16), rate,
                   f"plan bm x bn x tb {plan.bm} x {plan.bn} x {plan.tb}")
            del x, w
            torch.cuda.empty_cache()
    # K1 at the enc-dec and VLM families' new shapes: a 4-lane decode and
    # the ENC_ROWS-row cross K/V and encoder GEMMs (the plain version timed
    # at M = 4 up to WHOLE_N columns)
    for arch, kns in CROSS_KN.items():
        for M, K, N in ([(4, K, N) for K, N in kns]
                        + [(ENC_ROWS, K, N) for K, N in CROSS_ROWS_KN[arch]]):
            x, w = operands((M, K, N), 19, dev)
            plan = k12.launch_plan(M, N, K, 16)
            record("olm_matmul_fused", f"olm16 {arch} M={M} K={K} N={N}",
                   cuda_ms(lambda: k12.olm_matmul_fused(x, w, n=16),
                           reps=5 if M == 4 else 3, warmup=1),
                   cuda_ms(lambda: plain_olm16(x, w), reps=1)
                   if M == 4 and N <= WHOLE_N else None,
                   (M * K + K * N + M * N) * 4, k12.int_ops(M, N, K, n=16),
                   rate, f"plan bm x bn x tb {plan.bm} x {plan.bn} x "
                   f"{plan.tb}")
            del x, w
            torch.cuda.empty_cache()
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
    del xd, yd
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
        (the same tokens), a third profiled unless `profile` is False.
        Returns the first run's outputs by rid; its wall, GEMMs and, under
        dot_tiling="auto", the tuner cache's hits and misses go into
        serve_stats."""
        auto = (engine_kw or {}).get("dot_tiling") == "auto"
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
        # counts too).
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
        t0 = time.monotonic()
        again = engine.run()
        torch.cuda.synchronize()
        wall2 = time.monotonic() - t0
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
        # The device's busy share: the same requests a third time under
        # torch.profiler, the union of the device's kernel intervals over
        # the first run's (unprofiled) wall, and the path kernel's own
        # device time from the trace.
        engine = seeded_engine()
        busy, kernel_s, n_events = device_busy(engine.run, kernel_name[mode])
        if n_events:
            print(f"[{tag}] {mode}: profiled run: {n_events} device kernels "
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
    params = Model(cfg, device=dev).init(seed=SERVE["seed"])
    for mode in SERVE["modes"]:
        outputs[mode] = serve("serve", cfg, params, mode)
    agree = sum(a == b for r1, r2 in zip(*outputs.values())
                for a, b in zip(r1, r2))
    print(f"[serve] olm16 and tpmm16 agree on {agree} of "
          f"{sum(map(len, outputs['olm16']))} generated tokens (random "
          "weights; both within their documented error)")
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
    params = Model(cfg, device=dev).init(seed=SERVE["seed"])
    torch.cuda.synchronize()
    print(f"[dense] weights on the card: {torch.cuda.memory_allocated()} "
          "bytes", flush=True)
    serve("dense", cfg, params, "olm16")

    # forward and lm_loss at full width under olm16, against prefill and a
    # plain NLL
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
    rel = float((flash - plain).abs().max() / plain.abs().max())
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
        largest |logit| there (gate 3e-2). With `plain`, the steps are
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
        errs = []
        for p, got in steps:
            want = full[:, p]
            errs.append(float((got - want).abs().max() / want.abs().max()))
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
                      p: float((g - ref[:, p]).abs().max()
                               / ref[:, p].abs().max()) for p, g in steps})
                  + "; flash against plain forward "
                  f"{float((full - ref).abs().max() / ref.abs().max()):.3e}",
                  flush=True)
            del ref
        finite = bool(torch.isfinite(full).all()) and all(
            bool(torch.isfinite(g).all()) for _, g in steps)
        if not finite or max(errs) > 3e-2:
            raise SystemExit(f"{tag}: decode disagrees with forward")

    # RecurrentGemma-9B at its full width and depth: served under olm16
    # (K1 at every eng.dot GEMM), then a ring that rolls, under native
    cfg = get_config("recurrentgemma_9b")
    describe("families", cfg)
    print(f"[families] {cfg.name}: kinds {cfg.block_pattern} x "
          f"{cfg.pattern_groups} + {cfg.remainder_blocks}, window "
          f"{cfg.sliding_window}, rnn_width {cfg.rnn_width}; "
          f"{gemms_per_pass(cfg)} eng.dot GEMMs a pass", flush=True)
    params = family_params(cfg)
    serve("families", cfg, params, "olm16", profile=False)
    peak = torch.cuda.max_memory_allocated()
    print(f"[families] {cfg.name} serve peak memory {peak} bytes "
          f"({peak / 2**30:.2f} GiB)", flush=True)
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
    real_route = moe_mod._route_row
    routed = {"assignments": 0, "dropped": 0}

    def counted_route(*a, **kw):
        plan = real_route(*a, **kw)
        keep = plan[4]
        routed["assignments"] += keep.numel()
        routed["dropped"] += int((~keep).sum())
        return plan

    moe_mod._route_row = counted_route
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
        moe_mod._route_row = real_route

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
        params = Model(cfg, device=dev).init(seed=SERVE["seed"])
        first = serve("tune", cfg, params, "olm16", profile=False,
                      engine_kw=dict(dot_tiling="auto"))
        del params
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
        cfg = get_config(arch)
        key = "frames" if cfg.family == "encdec" else "patches"
        describe("crossattn", cfg)
        per_pass, with_enc = gemms_per_pass(cfg), gemms_per_pass(cfg, True)
        print(f"[crossattn] {cfg.name}: family {cfg.family}, kinds "
              f"{cfg.block_pattern} x {cfg.pattern_groups}, "
              f"{cfg.n_enc_layers} encoder layers, {cfg.n_frontend_tokens} "
              f"{key} a lane; {with_enc} eng.dot GEMMs a pass over {key}, "
              f"{per_pass} a decode step", flush=True)
        params = family_params(cfg, tag="crossattn")
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
        errs = {p: float((got - full[:, p]).abs().max()
                         / full[:, p].abs().max()) for p, got in steps}
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

    def train_steps(step_fn, box, n, tag, batch=batch):
        """n synchronized steps from the state in the one-element list
        `box`, which it takes, so that no caller holds a state two steps
        old (three states of InternLM2-1.8B do not fit the card): (state,
        [(loss, grad_norm, wall, peak memory)])."""
        state, rows = box.pop(), []
        for i in range(n):
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
    state, rows = train_steps(step_fn, box, TRAIN["steps"], "native")
    peak = max(r[3] for r in rows)
    losses = [r[0] for r in rows]
    steady = sorted(r[2] for r in rows[1:])[len(rows[1:]) // 2]
    print(f"[train] {cfg.name} native: loss {losses[0]:.4f} -> "
          f"{losses[-1]:.4f} over {len(rows)} steps (gate: down by more than "
          f"0.05); median step wall after the first {steady:.3f} s, "
          f"{B * S / steady:.0f} tokens/s; peak memory {peak} bytes "
          f"({peak / 2**30:.2f} GiB); {smi_line}", flush=True)
    if not all(np.isfinite(r[1]) for r in rows):
        raise SystemExit("train: a non-finite grad_norm")
    if not losses[-1] < losses[0] - 0.05:
        raise SystemExit(f"train: the loss went {losses[0]} -> {losses[-1]}")

    # the forward and backward alone, with and without remat: what the
    # graph holds after the forward, the peak, the wall (each twice, the
    # second printed: the first call of a model warms its caches)
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
    # 20 steps with checkpoints, a resume to 30, a straight 30-step run
    saved, restored, streamed, save_walls = {}, [], [], []

    class Recording(train_cli.CheckpointManager):
        # the CLI's state rests as DTensors on its one-rank mesh: each leaf
        # is recorded whole; each save call's wall is the time the loop
        # waits in it (the write runs in the background unless it blocks)
        def save(self, step, tree, *, block=False):
            saved[step] = [t.detach().clone()
                           for t in tree_leaves(gather_state(tree))]
            t0 = time.monotonic()
            super().save(step, tree, block=block)
            save_walls.append(round(time.monotonic() - t0, 3))

        def restore(self, tree_like, step=None, shardings=None):
            out = super().restore(tree_like, step, shardings)
            restored.append(tree_leaves(gather_state(out)))
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
        t0 = time.monotonic()
        one, _ = cli(args + ["--steps", "20", "--ckpt-every", "10",
                             "--ckpt-dir", f"{tmp}/resumed"])
        t1 = time.monotonic()
        at20 = saved.pop(20)
        saved.clear()
        streamed.clear()
        two, resumed = cli(args + ["--steps", "30", "--ckpt-every", "10",
                                   "--ckpt-dir", f"{tmp}/resumed",
                                   "--resume"])
        t2 = time.monotonic()
        first_step, first_tokens = streamed[0]
        same_state = len(restored) == 1 and len(restored[0]) == len(at20) and \
            all(bits_equal(a, b) for a, b in zip(restored[0], at20))
        stream = SyntheticLMDataset(get_config(CLI["arch"]), CLI["batch"],
                                    CLI["seq"], seed=0).batch(20)["tokens"]
        same_batch = np.array_equal(first_tokens, stream)
        del at20, restored[:]
        three, straight = cli(args + ["--steps", "30", "--ckpt-every", "1000",
                                      "--ckpt-dir", f"{tmp}/straight"])
        t3 = time.monotonic()
    saved.clear()
    rel = {k: abs(resumed[k] - straight[k]) / abs(straight[k])
           for k in range(20, 30)}
    print(f"[train] cli {CLI['arch']} (batch {CLI['batch']} x seq "
          f"{CLI['seq']}, lr {CLI['lr']}): run 1 {one['steps']} steps in "
          f"{t1 - t0:.1f} s, loss {one['loss_first']:.4f} -> "
          f"{one['loss_last']:.4f}, improved {one['loss_improved']}; run 2 "
          f"resumed at step {first_step} ({two['steps']} steps in "
          f"{t2 - t1:.1f} s), restored state bit-equal to the saved one "
          f"{same_state}, its first batch the stream's step 20 {same_batch}; "
          f"run 3 straight {three['steps']} steps in {t3 - t2:.1f} s, steps "
          f"20-29 within {max(rel.values()):.2e} of the resumed run's "
          f"(gate 1e-3 relative); each save call's wall in s, in order "
          f"(the last of each run blocks) {save_walls}", flush=True)
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
    with tempfile.TemporaryDirectory() as tmp:
        # the single-device results the ranks are held against: K1 at
        # each GEMM, and the native train step over the cut model
        refs = {}
        for i, ((K, N), mode) in enumerate(SHARD_GEMMS):
            n, p = mode_bits(mode)
            x, w = operands((SHARD_ROWS, K, N), 100 + i, dev)
            refs[f"{i}"] = olm_matmul(x, w, n_bits=n, trunc=p).cpu()
            tr = {part: sharded_traffic(SHARD_ROWS, N, K, partition=part,
                                        devices=SHARD_RANKS, n_bits=n,
                                        trunc=p)
                  for part in ("m", "n", "k")}
            print(f"[shard] {mode} ({SHARD_ROWS}, {K}) @ ({K}, {N}): "
                  f"sharded_traffic over {SHARD_RANKS}: local fused bytes "
                  f"{ {k: v['local']['fused_bytes'] for k, v in tr.items()} }"
                  f", collective bytes "
                  f"{ {k: v['collective_bytes'] for k, v in tr.items()} }",
                  flush=True)
        torch.save(refs, os.path.join(tmp, "gemm.pt"))
        del refs, x, w
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
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            port = sock.getsockname()[1]
        tokens = [[int(t) for t in out] for out in outputs["olm16"]]
        t0 = time.monotonic()
        # a rank that raises fails this call, and with it the script
        mp.start_processes(shard_rank, args=(SHARD_RANKS, port, tmp, tokens),
                           nprocs=SHARD_RANKS, join=True,
                           start_method="spawn")
        ranks = [json.loads(Path(tmp, f"rank{r}.json").read_text())
                 for r in range(SHARD_RANKS)]
        print(f"[shard] {SHARD_RANKS} ranks done in "
              f"{time.monotonic() - t0:.1f} s (spawn included)", flush=True)
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

    # 14. the port's examples --------------------------------------------
    phase("examples")
    reset_counts()
    results = {}
    for example, argv in EXAMPLES:
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
    phase(None)
    print(f"[wall] phases: {json.dumps({k: round(v, 1) for k, v in walls.items()})}",
          flush=True)
    print(f"[wall] sum of phases: {sum(walls.values()):.1f} s", flush=True)

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
    sys.exit(main())
