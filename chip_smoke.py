"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

1. prints the card (nvidia-smi name and power limit), builds the CUDA kernels
   from mobilequant_tpu_torch/csrc into build/mqt_kernels and prints the build
   time;
2. holds each kernel against its plain PyTorch version on the card at the
   main paths' shapes (full-width TinyLlama-1.1B) and times kernel, plain
   version and, where one PyTorch call computes the same function, that call:
   among them staged_append (B=32, 32 staged columns; beside the floor of one
   launch, a 16-byte Tensor.zero_ on the same timer, and a 16-byte
   Tensor.copy_, which reads its input first), the o-tail (M=32, 128)
   and the chunk kernel (B=16 staggered, 32, 128; m 0 and 16; both policies),
   with the chunk step's per-stage times from its %globaltimer trace beside
   its parent's figures (PARENT_CHUNK_STAGE_US; W8, StableLM and Gemma too),
   the MLP block's row kernel also at M = 17, 65 (checked) and 1024 (timed),
   both MLP-block kernels (dp4a, row) at M = 1, 2, 4, 8 for the wrapper's fork,
   the kv4 decode attention over the int4 cache (B = 1, 32, 128 at pos0 192
   and a staggered B=32 past S/2; m 0 and 16; both policies; B=1 at pos 3
   with m=0 checked, not timed), the int8 decode attention (B = 1, 32; S =
   1024, 193 valid rows; B=1 with 5 valid rows checked), each with the
   thread-block cluster size its wrapper picked, and the prefill
   attention also on ragged shapes (B=2, T=100, positions from 37, valid
   137 / 120, G = 8 and 1, both policies; checked, not timed); the w13-gate
   kernel also at M = 2, 17 (checked, error 0) and 1024 (timed), W4 and W8
   (phases 2, 2w; Gemma's widths in 2g); the W4A8 matmul's tile path (o, w2,
   the head, and two widths off the 128-column grid, one of them N % 16 != 0
   for the 4-byte-copy edition, counted on the wrapper) and the qkv epilogue
   kernel (W4, W8 in 2w, StableLM's bias edition in 2s, Gemma's head-dim-256
   edition W4 and W8 in 2g, with Gemma's w2 and head) also at M = 9, 17, 65
   (checked) and 1024 (timed), at their M = 128 rows' tolerances; the whole-model kernel's B=1
   per-stage trace beside its parent's figures (PARENT_STAGE_US);
3. drives the routes on a W4A8 TinyLlama-1.1B pack (seeded synthetic
   weights, W4 head, int8 KV cache, relaxed policy), counting every kernel's
   launches from 0 around each run:
   - B=1 Generator.generate_fast with a 128-token prompt and 64 new tokens:
     the prefill kernels, then one whole-model launch (fused_model_w4) per
     decode token;
   - a 32-token-prompt generate_fast, whose prefill takes the whole-MLP-block
     kernel (fused_mlp_block_w4) in every layer;
   - 8 decode steps under KernelConfig.decode_per_layer(), one whole-layer
     launch (fused_layer_w4) per layer and step;
   - the serving batch: B=32 generate_fast (128-token prompt, 64 new tokens;
     5 on the host-bound staged routes, HOST_NEW)
     on the default staged route (W4A8 qkv / o, the MLP-block kernel and
     staged_append each step) and on the chunk route (one fused_model_w4_chunk
     launch and staged_append each step); B=128 decode of 8 steps after a
     32-token prompt on both; 8 B=32 steps on the o-tail route; for each,
     decode tok/s, and per step of a decode_loop the wall and device time,
     the device's idle share and the kernel launches (torch.profiler);
   and checks the kernel path's prefill and decode logits against the plain
   path's on the card, also for one B=4 decode step at staggered positions
   and for one 32-step staged chunk at B=32 on the default and chunk routes
   (the same tokens fed to each; logits of every step and flushed caches),
   with the whole-model and chunk kernels' plain versions moved onto the
   plain engine's numerics (engine_numerics) as the witnesses that the B=1
   and chunk routes' wiring is the engine's;
   - the int4 KV cache (a kv_bits=4 pack): generate_fast at B=1 and B=32
     (128-token prompts, HOST_NEW new tokens), B=128 (32-token prompt, 8 steps) and
     B=8 (496-token prompt, 33 new tokens: a chunk straddles S/2 = 512), one
     kv4 kernel launch per layer and step, and one 8-step B=32 chunk fed the
     same tokens on the kv4 kernel route, on that route with the kernel's
     plain version, on that route moved onto the plain engine's numerics
     (kv4_engine_numerics, the witness for its wiring), and on the plain
     path;
   - the attn() route: 8 B=1 decode steps, one decode attention launch per
     layer and step, against the plain path;
   - phase 2w and 3e, on a W8A8 pack of their own (per-tensor asymmetric W8
     layers, a W8 per-channel head, seeded; a generator of their own): each W8
     edition (qkv_rope and w13_gate at M=128, the MLP block's dp4a and row
     kernels at M = 1, 2, 8, 32, 128, the whole-model kernel with the W8 head
     at B = 1, 8, the whole-layer kernel, the chunk kernel with the W8 head at
     B = 16, 32, 48) and w8a8_matmul (M = 1, 8, 32 on qkv / o / w13 / w2,
     timed beside torch._int_mm and its parent's kernel, PARENT_W8A8_MS; M =
     2, 4, 9, 17, 33, 128 checked, and every M on StableLM's qkv width and
     on a width N % 16 != 0, the 4-byte-copy edition) against its plain
     version, then the W8 routes:
     B=1 generate_fast (qkv on the plain integer matmul and the W8 w13
     epilogue kernel, one W8 whole-model launch per token), a 32-token
     prompt (the W8 MLP block),
     decode_per_layer(), the attn_all() route (w8a8_matmul for qkv and o),
     B=32 on the entry config (one W8 chunk launch a step) and B=128 (the
     staged route), each with tok/s, wall / device ms a step, idle share and
     launches; the B=1 step and its engine-numerics witness, one 8-step B=32
     chunk on the serving route, its plain version, the engine's numerics and
     the plain path, and the attn_all() route against the plain path;
   - phase 2q: the weight-only kernels against their plain versions:
     wonly_matmul_stacked at M = 1, 8 on the TinyLlama projections in W4
     g128, W4 and W8 per channel (bf16 rows), w4a16_matmul at M = 1, 8, 128,
     each beside torch.matmul on the bf16-dequantized weight; then every
     edition the wrappers take, checked and not timed (W4 / W8 x per tensor
     / per channel / g128 x fp32 / bf16 rows at M = 1, 3, 8, and one-signed
     packs, offsets far outside the code range; row 13 per tensor / per
     channel x fp32 / bf16 at M = 1, 8, 100, 128, at 2048 -> 512 and
     512 -> 2048, and one-signed);
   - phase 3w: weight-only serving, Generator(ecfg.act_bits=16)
     .generate_fast at B=1 on TinyLlama-1.1B W4A16 g128 (seeded FP weights
     through convert.build_synthetic_wonly, bf16 activations, fp KV cache)
     with the fp head and the W4 head: a prefill with no kernel, then one
     wonly_matmul_stacked launch per projection and token (and one
     w4a8_matmul launch a token for the W4 head); a 16-step chain fed the
     same tokens on the kernel and the plain route, in fp32 and in bf16;
   - phase 3f: W8A8/h8 on the int4 cache through generate_fast at B = 1,
     32, 128 (one kv4 and one W8 MLP-block launch a layer and step), and
     an 8-step B=32 chunk on that route, with the kv4 kernel's plain version,
     on the plain engine's numerics (kv4_engine_numerics) and on the plain
     path;
   - phase 2m: the alternate MLP routes' kernels against their plain
     versions on the W8A8/h8 pack (and the W4A8 one for row 19): fused_mlp
     (M = 1, 8, 128; its raw sums and row sums exactly), fused_mlp_block
     (M = 1 mxu and vpu, 8, 128 RMSNorm, 8 LayerNorm), the W8 o-tail (M =
     32, 128) and w13_gate_w2 W4 / W8 (M = 128, 1024) beside its split path
     (w13_gate, then the w2 matmul of the JAX split route); rows 16 and 17
     also at the test-llama width;
   - phase 3m: the routes through the entry points on the W8A8/h8 pack:
     Generator(EngineConfig(use_pallas="mlp" / "mlpblock" / "mlpblockvpu"))
     .generate_fast at B=1 (128-token prompt, HOST_NEW new tokens; one launch of
     the route's kernel a layer and step), the W8 o-tail route
     (KernelConfig.otail()) at B = 32 and 128 with its 8-step B=32 chunk
     against its kernel's plain version and the plain path, the same chunk
     on the "mlp" and "mlpblock" routes against the plain path, and the T=128
     prefill on KernelConfig.prefill() with and without w2fold_kernel (W4A8
     and W8A8): wall, device time, launches;
   - phase 2s: StableLM-2-1.6B at full width (24 layers, 32 q / 32 kv heads,
     rotary on 16 of 64 head dims, LayerNorm with a bias, a q/k/v bias;
     seeded W4A8/h4 and W8A8/h8 packs): the LayerNorm edition of the
     whole-model kernel (B = 1, 8, with the head), the whole-layer kernel,
     the MLP block (M = 1, 2, 8, 32, 128), the chunk kernel (B = 32, 128)
     and the o-tail (M = 32, 128), W4 and W8, and the qkv epilogue and
     prefill attention kernels at its T=128 prefill (the bias, partial
     rotary, G = 1), each against its plain version with times and bounds;
   - phase 3s: StableLM serving on both packs through the entry points: B=1
     generate_fast (one whole-model launch a token), a 32-token prompt,
     decode_per_layer(), B=32 on the chunk route, the staged MLP-block route
     and the o-tail, the B=1 step and an 8-step B=32 chunk against the plain
     path with their engine-numerics witnesses (the chunk's equal bit for
     bit);
   - phase 2g: Gemma-2B at full width (18 layers, 8 q heads over one kv
     head of head_dim 256, full rotary, F 16384, vocab 256000, the head tied
     to the embedding; seeded W4A8/h4 and W8A8/h8 packs): the head-dim-256
     editions of the qkv epilogue kernel (W4, M=128), the prefill attention
     (T=128 into S=1024, T=S=1024 relaxed and strict; and its head-dim-128
     edition at one shape), the decode attention (B = 1, 32), the whole-model
     (B = 1, 8, the head folded) and whole-layer (B = 1) kernels (W4 and
     W8), the chunk kernel's hd-256 edition (B = 16, 32, 64, 128 relaxed and
     B=32 strict, pos0 192, 16 staged columns, the tied head folded; W4 and
     W8, with its per-stage times at B=32), and the other kernels of the
     Gemma routes at its widths (w13_gate at M=128 with gelu_tanh, the MLP
     block at M = 1, 32, W4 and W8; the W4 projections at M = 1, 32, 128 and
     the W4 head at Vp 258048), each against its plain version with times
     and bounds;
   - phase 3g: Gemma serving on both packs through the entry points: B=1
     generate_fast (one whole-model launch a token), decode_per_layer(),
     attn() at B = 1 and 32, the chunk gate against a copy of the JAX gate's
     terms at B = 8..136, B=32 on the entry config (W4: the staged MLP-block
     route; W8: one chunk launch a step), W4 on KernelConfig.chunk() at B=32
     and at B=128 (32-token prompt, 8 steps), the B=1 step with its
     engine-numerics witnesses, and a 32-step B=32 chunk on the chunk route
     (W4 KernelConfig.chunk(), W8 the entry config) against the chunk
     kernel's plain version, that plain version on the plain engine's
     numerics, and the plain path;
   - phases 2h / 3h: the registry's head-dim-128 models at full width
     (seeded synthetic packs): Qwen2-1.5B W4A8/h4 and W8A8/h8 (12 q heads
     over 2 kv heads, G = 6; a q/k/v bias; the tied 151,936-row head padded
     to 155,648; rope theta 1e6), Llama-3-8B W4A8/h4 (G = 4, rope theta
     5e5) and Llama-2-7B W4A8/h4 (G = 1), one model at a time. 2h: row 4 at
     each model's G (the G = 6 edition "prefill_attention[G6]", the others
     "prefill_attention[hd128]": T=128 into S=1024 relaxed and strict,
     T=S=1024 relaxed, a ragged B=2 T=100 checked), rows 15 and 10 at G = 6
     ("decode_attention[G6]", "kv4_decode_attention[G6]": B = 1, 32, both
     policies), rows 3 and 5 at the T=128 prefill, rows 1 / 2 (the head and
     o / w2 at M = 1, 32, beside torch._int_mm), row 6 (B = 1, 8, the head
     folded), row 7 (B=1) and row 11 (B = 32, 128; Llama-2 B = 32), each
     against its plain version with kernel, plain, library and bound ms.
     3h through the entry points: B=1 generate_fast (one whole-model
     launch a token) with the T=128 prefill's device profile, B=32 on the
     chunk and the staged routes, the int4 cache at B = 1, 32 and attn() at
     B=1 (Qwen2 W4: rows 10 and 15 at G = 6), the B=1 step and a 32-step B=32
     chunk against the plain path with the engine-numerics witnesses
     (exact) and H_*_VS_PLAIN; Llama-2-7B at B=1 and B=16 on the staged
     route; a ContinuousBatcher of 8 slots serving 8 Qwen2-1.5B requests;
   - phase 3k: the HF converter on the card: a seeded random Qwen2-1.5B
     checkpoint under HF names in bf16, written as two .safetensors shards
     under build/, read by models/convert.load_checkpoint(device="cuda")
     (seconds, GB/s), every leaf held to the drawn weights, then calibrated
     on synthetic tokens, packed W4A8/h4 and served at B=1;
   - phase 3q: the port's own quantization pipeline at TinyLlama-1.1B's full
     width (seeded fp32 params with three outlier embedding channels, 8 x
     256 synthetic calibration tokens): calibrate, the SmoothQuant LET init,
     recalibrate, e2equant (8 steps, remat) and omniquant over every layer,
     finalize, smooth_last and pack (W4A8/h4), with seconds per step and per
     layer and the peak memory; the LET fold and collect mode against the
     FP forward, cmd_pack --verify's engine-vs-sim comparison, then the pack
     served: B=1 generate_fast and the B=32 chunk route, each against the
     plain path with phase 3s's witnesses;
   - phase 3v: serving on TinyLlama-1.1B W4A8/h4 (int8 KV, relaxed, S 1024)
     through the entry points: (a) a ContinuousBatcher of 8 slots (buckets
     32 / 128 / 512, chunk_decode 16) serving 16 requests (prompts 17-480,
     budgets 8-64; half greedy, a quarter at temperature 0.8, a quarter
     top-k 40 / top-p 0.9); (b) 32 slots (chunk_prefill 128, chunk_decode
     16, KernelConfig.chunk()) serving 40; (c) spec_k 4 on a repeated prompt
     and generate_speculative_fast at B=1 with prompt lookup and a 4-layer
     self-draft; (d) an InferenceServer over HTTP loopback with 8 client
     threads: requests/s, tok/s, time to first token, read-backs and the
     device's idle share a tick, tokens per verify; a second run with the
     same seed must repeat every stream; every greedy stream must equal the
     sequential Generator's with every kernel on the plain engine's numerics
     (serve_witness), and on the kernel routes the agreeing share is
     reported;
   the decode-attention rows of phase 2, the int4-cache phase, the attn()
   phase and phases 2q, 3w, 3f, 2m, 3m, 2s, 3s, 2g, 3g, 2h, 3h, 3k, 3q and 3v draw their inputs from
   generators of their own, so what they draw moves no input of the other
   checks. No wrapper may run its plain version on the card: every counted
   run checks its plain-call counts;
4. prints one JSON line of per-kernel numbers, then the result line.

Bounds: bytes over 3.35 TB/s against the operations over their units'
rates: int8 tensor cores 1,979 TOP/s, fp32 CUDA cores 67 TFLOP/s (summed, as
the earlier rows always have), and for the kernels that run them (rows 4, 12,
13), fp16 / bf16 tensor cores 989 TFLOP/s (every split term counted, added to
the int8 products: the same units) and exp on the SFUs (16 a clock per SM at
1.98 GHz), the largest of the units, which overlap.

Any failure exits non-zero before the result line. Without a CUDA device, or
without the rest of the repository beside it, it exits non-zero at once.
Numbers go to chiprun_out/chip_smoke.json as well.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import io
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

import torch

HBM_BYTES_S = 3.35e12          # H100 SXM data sheet
INT8_OPS_S = 1979e12           # dense int8 tensor-core rate
FP32_OPS_S = 67e12             # fp32 outside the tensor cores
FP16_OPS_S = 989e12            # dense fp16 / bf16 tensor-core rate
FP64_OPS_S = 67e12             # dense fp64 tensor-core rate (the card's highest for fp64)
# exp on the special-function units: 16 a clock per SM (Hopper white paper) on
# 132 SMs at the H100 SXM's 1.98 GHz maximum boost clock (a lower bound takes
# the highest rate the card can reach)
SFU_OPS_S = 16 * 132 * 1.98e9
SEED = 0
PROMPT_LEN, NEW_TOKENS, MAX_SEQ = 128, 64, 1024
SHORT_PROMPT, PER_LAYER_STEPS, POS0 = 32, 8, 192
SERVE_B, BIG_B, BIG_STEPS, STAGED_M, CHUNK_COLS = 32, 128, 8, 16, 32
# the host-bound staged routes (every step hundreds to thousands of
# launches) run HOST_NEW new tokens and read their per-step loop over
# HOST_LOOP steps: their rate is the host's per-step cost, the same over 4
# steps as over 64, and the run stays within its time limit
HOST_NEW, HOST_LOOP = 5, 4
# the staged chunks of phases 3c, 3e, 3f, 3m and 3s held against the plain
# path run SHORT_CHAIN steps on the first of the CHUNK_COLS tokens drawn for
# them (their plain versions and the plain path cost 0.15-0.3 s a step at
# B=32, and their 32 steps took ~135 s of the script on the card); their
# limits are set from readings at that length. Phases 3b, 3g and 3h keep
# their CHUNK_COLS-step chains: every staged column of the chunk kernel's
# hd-64, hd-128 and hd-256 editions against its plain version
SHORT_CHAIN = 8
# the W8 o-tail route's SHORT_CHAIN-step B=32 chunk against the plain path:
# (logits rel, max int8 step, share of differing flushed bytes), about twice
# the reading on the card (2.83e-3; 2 steps on 0.22% of the K / V bytes; the
# 32-step chunk read 3.24e-3, 2 steps on 0.29%), as phase 3e holds its chunk
OTAIL_W8_VS_PLAIN = (5.7e-3, 4, 4.5e-3)
# the same chunk on the "mlp" route against the plain path: exact, as first
# read on the card (row 16's sums are exact and the engine's w2 epilogue is
# the plain path's own code); on the "mlpblock" route: about twice the
# reading (the o-tail's, byte for byte)
MLP_W8_VS_PLAIN = (0.0, 0, 0.0)
MLPBLOCK_W8_VS_PLAIN = (5.7e-3, 4, 4.5e-3)
# StableLM-2-1.6B (W4/h4, W8/h8) against the plain path: (logits rel, max
# int8 step, share of differing bytes), about twice the first readings on the
# card (the kernels there equal their plain versions, and the engine-numerics
# witnesses equal the plain path bit for bit; the random 24-layer MHA model
# grows the kernels' rounding far more than TinyLlama's): the T=128 prefill
# and the decode step after it, both routes fed the plain path's greedy token
# (read W4 3.94e-2, 7 steps on 7.63% of the K / V bytes, the step 4.82e-2;
# W8 4.32e-2, 7 steps on 7.40%, the step 3.78e-2; the prefill's layer 0 rows
# equal, the steps grow to 7 by the last layer), and the SHORT_CHAIN-step
# B=32 chunk (W4 3.93e-2, 8 steps on 10.1%; W8 3.16e-2, 5 steps on 14.8% of
# the flushed bytes; the 32-step chunk read W4 4.33e-2, 8 steps on 24.3%, W8
# 4.22e-2, 8 steps on 33.8%)
STABLELM_PREFILL_VS_PLAIN = {4: (8e-2, 15, 0.16), 8: (9e-2, 15, 0.15)}
STABLELM_STEP_VS_PLAIN = {4: 0.1, 8: 8e-2}
STABLELM_CHUNK_VS_PLAIN = {4: (7.9e-2, 16, 0.2), 8: (6.3e-2, 10, 0.3)}
# Gemma-2B (W4/h4, W8/h8) against the plain path, as StableLM's: the T=128
# prefill (logits rel, max int8 step, share of differing K / V bytes) and the
# decode step after it (logits rel), about twice the first readings on the
# card, the port's 2e-3 at least (the engine-numerics witnesses equal the
# plain path bit for bit). Read: W4 prefill 5.66e-8, 1 step on 7.4e-6 of the
# bytes, the step 0; W8 prefill 1.37e-3, 2 steps on 0.31%, the step 1.24e-3
GEMMA_PREFILL_VS_PLAIN = {4: (2e-3, 2, 2e-5), 8: (3e-3, 4, 7e-3)}
GEMMA_STEP_VS_PLAIN = {4: 2e-3, 8: 3e-3}
# the 32-step B=32 chunk on the chunk route (W4 KernelConfig.chunk(), W8 the
# entry config) against the plain path: (logits rel, max int8 step, share of
# differing flushed bytes), about twice the first readings on the card (the
# kernel equals its plain version there, and that plain version on the plain
# engine's numerics equals the plain path bit for bit). Read: W4 4.69e-3
# (one step; the others <= 1.13e-3), 12 steps on 0.052% of the K / V bytes;
# W8 0.237 (one step; 26 of 32 steps <= 4.3e-3), 48 steps on 0.69%: the
# chunk kernel's attention arithmetic (the JAX chunk kernel's) rounds
# otherwise than the engine's, and the random W8 model grows a moved byte
GEMMA_CHUNK_VS_PLAIN = {4: (1e-2, 24, 1.1e-3), 8: (0.5, 96, 1.4e-2)}


# the whole-model kernel's B=1 per-stage trace on the parent of its ring
# redesign (µs, mean per layer: qkv, attention, o_proj, w13_gate, w2; then
# the head), printed beside this run's (PERF.md §6, PR 13: TinyLlama W4 / W8
# read on 7beb975's kernel; Gemma-2B W4 from PR 11's run)
PARENT_STAGE_US = {"W4": (18.20, 11.51, 10.44, 20.03, 12.21, 33.79),
                   "W8": (19.81, 13.89, 11.92, 24.52, 15.64, 43.26),
                   "Gemma W4": (18.68, 19.95, 11.70, 36.51, 17.74, 104.48)}


def parent_stages(key: str) -> str:
    return ("    parent's kernel: " + ", ".join(
        f"{k} {v:.2f}" for k, v in zip(("qkv", "attention", "o_proj", "w13_gate", "w2", "head"),
                                       PARENT_STAGE_US[key])))


# row 14 on its parent's kernel (the dp4a gemv at M <= 8, the dp4a tile core
# above; csrc/w8a8_matmul.cu at commit fff0e15), ms by (M, projection) at
# TinyLlama's W8 widths, the layers rotated past the L2:
# scripts/torch_ab_fused_rows.py --rows w8 on that commit, H100 80GB HBM3 at
# 700 W, the mean of its two runs (parent first and last)
PARENT_W8A8_MS = {
    (1, "qkv"): 0.01352,
    (1, "o"): 0.01182,
    (1, "w13"): 0.03345,
    (1, "w2"): 0.02124,
    (8, "qkv"): 0.02751,
    (8, "o"): 0.02391,
    (8, "w13"): 0.07226,
    (8, "w2"): 0.05073,
    (32, "qkv"): 0.02869,
    (32, "o"): 0.02328,
    (32, "w13"): 0.0653,
    (32, "w2"): 0.03433}


# the chunk kernel's per-stage trace on the parent of its matvec stage's move
# onto the tile core (µs, mean per layer: norm1, qkv, attention, o_proj, the
# MLP block; then the head's norm and matvec, and the traced step), printed
# beside this run's: this script at commit ce8b21c on an H100 80GB HBM3 at
# 700 W, relaxed policy, pos0 192, 16 staged columns
CHUNK_STAGES = ("norm1", "qkv", "attention", "o_proj", "mlp_block", "head_norm", "head",
                "step_traced")
PARENT_CHUNK_STAGE_US = {
    "W4 B=32": (10.88, 26.21, 44.58, 23.92, 66.45, 8.90, 39.97, 3833.95),
    "W4 B=128": (10.63, 63.93, 160.27, 88.64, 310.33, 8.42, 85.54, 14037.57),
    "W8 B=32": (11.18, 31.37, 47.20, 28.12, 81.29, 7.97, 48.83, 4438.27),
    "StableLM w4 B=32": (13.52, 51.11, 52.89, 28.46, 77.71, 10.11, 92.19, 5470.78),
    "StableLM w8 B=32": (13.43, 55.71, 52.56, 29.98, 82.78, 10.46, 119.23, 5756.51),
    "Gemma w4 B=32": (12.14, 29.91, 30.18, 27.94, 114.91, 8.77, 206.34, 4086.62),
    "Gemma w8 B=32": (11.79, 32.16, 30.17, 28.29, 134.15, 8.22, 268.16, 4534.43)}


def chunk_stages(run, L: int, dev, label: str, parent: str) -> dict:
    """The chunk step's per-stage µs from its %globaltimer trace (run(trace)
    launches the kernel with it; the second of two runs is read), printed
    beside the parent's figures."""
    tr = torch.zeros(3 + 5 * L, dtype=torch.int64, device=dev)
    for _ in range(2):
        run(tr)
    torch.cuda.synchronize()
    dt = (tr[1:] - tr[:-1]).double().cpu() / 1e3
    st_us = dict(zip(CHUNK_STAGES, dt[:5 * L].reshape(L, 5).mean(0).tolist()
                     + [float(dt[5 * L]), float(dt[5 * L + 1]), float(dt.sum())]))
    print(f"  {label} stage us (mean per layer): "
          + ", ".join(f"{k} {v:.2f}" for k, v in st_us.items()), flush=True)
    print("    parent's kernel: " + ", ".join(
        f"{k} {v:.2f}" for k, v in zip(CHUNK_STAGES, PARENT_CHUNK_STAGE_US[parent])), flush=True)
    return st_us


T_START = time.perf_counter()
PHASE_START_S = {}             # phase -> seconds since the script started
PROFILE_S = [0.0, 0]           # seconds spent in device_profile, its calls


def phase(title: str) -> None:
    """Print a phase's header with the seconds since the script started."""
    t = time.perf_counter() - T_START
    PHASE_START_S[title.split(":")[0]] = t
    print(f"{title} [{t:.0f} s]", flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def bound(nbytes: float, int8_ops: float = 0.0, fp32_ops: float = 0.0,
          fp16_ops: float = 0.0, sfu_ops: float = 0.0, fp64_ops: float = 0.0):
    """(ms, "bytes" / "operations"): the larger of the bytes over the memory
    rate and the operations' time. A row of int8 and fp32 work only adds the
    two units' times, as those rows always have. A row with fp16 / bf16
    tensor-core, fp64 or SFU work (rows 4, 10, 12, 13, 15) takes the largest
    of its units' times, since the units overlap: the tensor cores (int8 and
    fp16 / bf16 products share them, so those two add), the fp32 CUDA cores,
    the fp64 units and the SFUs. fp16_ops already counts every split term of
    a product."""
    t_bytes = nbytes / HBM_BYTES_S
    t_tc = int8_ops / INT8_OPS_S + fp16_ops / FP16_OPS_S
    if fp16_ops or sfu_ops or fp64_ops:
        t_ops = max(t_tc, fp32_ops / FP32_OPS_S, sfu_ops / SFU_OPS_S, fp64_ops / FP64_OPS_S)
    else:
        t_ops = t_tc + fp32_ops / FP32_OPS_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def cold_count(nbytes: float, limit: int) -> int:
    """How many copies of an operand of nbytes a timing loop rotates over so
    that one pass reads 100 MB, twice the H100's 50 MB L2 (at most limit)."""
    return max(1, min(limit, -(-int(100e6) // max(int(nbytes), 1))))


def time_ms(fn, n: int = 20) -> float:
    """Mean device time of fn(i) over n calls: the calls are captured in one
    CUDA graph and replayed, so host-side launch cost is not in the number."""
    fn(0)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for i in range(2):
            fn(i)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(n):
            fn(i)
    graph.replay()
    torch.cuda.synchronize()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    graph.replay()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / n


def event_ms(fn, n: int = 3) -> float:
    """Mean time of fn() over n back-to-back calls between two CUDA events
    (for functions that read values back to the host, which a CUDA graph
    cannot capture)."""
    fn()
    torch.cuda.synchronize()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(n):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / n


def device_profile(fn, top: int = 8):
    """(device ms, [(kernel, ms, count)...], kernel launches) of one call of
    fn, from torch.profiler (CUPTI kernel records; the ctypes-launched kernels
    are among them)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    try:
        prof_ctx = profile(activities=acts, acc_events=True)
    except TypeError:                                # a torch without acc_events
        prof_ctx = profile(activities=acts)
    with prof_ctx as prof:
        fn()
        torch.cuda.synchronize()
    kern = []
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        t = getattr(e, "self_device_time_total", None)
        if t is None:
            t = e.self_cuda_time_total
        kern.append((e.key[:60], t / 1e3, e.count))
    kern.sort(key=lambda k: -k[1])
    PROFILE_S[0] += time.perf_counter() - t0
    PROFILE_S[1] += 1
    return sum(k[1] for k in kern), kern[:top], sum(k[2] for k in kern)


def jax_chunk_gate(c, max_seq_len: int, B: int) -> bool:
    """The JAX package's chunk_kernel_supported, term for term (with its
    layer_kernel_supported and w4_mlp_block_supported: mobilequant_tpu/ops/
    pallas_chunk.py, pallas_layer.py, pallas_mlp.py), copied here so that
    the port's gate is held against it on the card without importing the
    JAX package."""
    hd, Hq, Hkv = c.head_dim_, c.num_heads, c.num_kv_heads
    R, K, Ko, half_f = Hq + 2 * Hkv, c.hidden_size, Hq * hd, c.intermediate_size // 2
    if hd % 128 != 0 and not (hd == 64 and R % 2 == 0 and Hq % 2 == 0):
        return False
    cap = max(128, min(1024, (4 * 1024 * 1024) // (3 * K), half_f // 2))
    tfh = next((t for t in (1024, 512, 256, 128) if t <= cap and half_f % t == 0), 0)
    return (8 < B <= 128 and B % 8 == 0 and Hkv * max_seq_len * hd <= 4 * 1024 * 1024
            and K % 256 == 0 and Ko % 512 == 0 and (R * hd) % 128 == 0
            and max_seq_len % 128 == 0 and c.rotary_dim % 2 == 0 and Hq % Hkv == 0
            and K % 256 == 0 and c.intermediate_size % 256 == 0 and tfh != 0)


def run_staged_chunk(E, qops, packed, cfg, policy, kc, cache, toks, pos0, kv4=False):
    """One staged chunk fed `toks` (decode_loop's chunk body) -> (logits of
    every step, the flushed cache)."""
    dev = cache.k.device
    n = toks.shape[1]
    colsums, flush = ((qops.kv_colsums_packed, qops.kv_flush_packed) if kv4
                      else (E.kv_colsums, E._flush))
    Lc, Bc, Hc = cache.k.shape[:3]
    shape = (Lc, Bc, Hc, n, cfg.head_dim_)
    st = E.StagedKVCache(cache.k, cache.v, torch.zeros(shape, dtype=torch.int8, device=dev),
                         torch.zeros(shape, dtype=torch.int8, device=dev), 0,
                         colsums(cache.k))
    lgs = []
    for i in range(n):
        st = E._stage_pending(st, kc)
        p = pos0 + i
        lg, st = E.forward(packed, toks[:, i:i + 1], cfg, policy, positions=p[:, None],
                           kv_cache=st, cache_position=pos0, kv_valid_len=p + 1, kc=kc)
        lgs.append(lg[:, -1])
    st = E._stage_pending(st, kc)
    flush(cache.k, st.sk, pos0)
    flush(cache.v, st.sv, pos0)
    return torch.stack(lgs, 1), cache


def float_err(out, ref):
    d = (out.float() - ref.float()).abs().max().item()
    return d, d / max(ref.float().abs().max().item(), 1e-30)


def int8_err(out, ref):
    d = (out.to(torch.int32) - ref.to(torch.int32)).abs()
    return d.max().item(), d.gt(0).sum().item() / d.numel()


# phase 3q: the port's own quantization pipeline at TinyLlama-1.1B's full width,
# in the JAX CLI's quantize order, then the pack it makes served on the card
Q_CALIB, Q_SEQLEN = 8, 256            # calibration sequences (synthetic_tokens)
Q_E2E_SAMPLES, Q_E2E_EPOCHS = 2, 4    # e2equant: 8 steps of batch 1, remat on
Q_OMNI_SAMPLES = 2                    # omniquant: one epoch, every layer
Q_LET_PROMPT, Q_VERIFY_PROMPT, Q_NEW = 64, 12, 16
Q_OUTLIER_CHANNELS = [3, 17, 40]      # embedding columns x100, as tests/test_train.py
# The trained pack of a random 22-layer model amplifies rounding: the JAX
# package's own sim moves its logits by 1.3% when its ranges move by at most
# 9.2e-7 of themselves (scripts/quant_sim_sensitivity.py: test-llama at
# hidden 512, 2 layers, on the CPU, where the port's engine and sim equal the
# JAX package's on the same ranges), so the integer engine (an exact
# re-expression of the sim in real arithmetic) and the kernels (fp64 sums,
# the JAX kernels' attention arithmetic) land a few percent from the sim and
# the plain path. The witnesses hold the kernels and their wiring exactly
# (each kernel equals its plain version on the pack's own data, and the
# routes on the plain engine's numerics equal the plain path); the raw gaps
# are held at about twice the first readings on the card, as phases 3s / 3g
# hold theirs. Read: engine (prefill kernels) vs sim max_rel 6.71e-2 (the
# plain engine 7.23e-2; cmd_pack --verify's 5e-2 is not met), B=1 prefill /
# step vs plain 5.64e-2 / 5.88e-2 with K / V 7 steps apart on 4.95% of the
# bytes, the 16-step B=32 chunk 0.126 with 16 steps on 28.1% of them.
Q_VERIFY_MAX_REL = (0.14, 0.15)       # engine with the prefill kernels, plain engine
Q_B1_VS_PLAIN = (0.12, 15, 0.1)
Q_CHUNK_VS_PLAIN = (0.26, 32, 0.56)


def _tree_leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _tree_leaves(v)]
    return [tree]


class _LineLog:
    """A logger for the training loops that keeps their lines."""

    def __init__(self):
        self.lines = []

    def info(self, msg):
        self.lines.append(msg)


def phase_quantize(dev, counted, runs, failures, model="tinyllama-1.1b", prompt_len=PROMPT_LEN,
                   serve_b=SERVE_B, max_seq=MAX_SEQ, seqlen=Q_SEQLEN) -> dict:
    """Phase 3q: seeded FP params (outlier embedding channels) -> calibrate ->
    SmoothQuant LET init (alpha 0.5) -> recalibrate -> stats_to_ranges ->
    init_qstate -> e2equant (W4A8 strict policy, remat) and, beside it,
    omniquant over every layer -> finalize -> smooth_last (alpha 0.5) -> pack
    (W4A8/h4, int8 KV); checks the LET fold (FP logits rel 2e-3), collect mode
    (the FP forward, rtol 1e-5), finite and falling losses, finite state, the
    engine's prompt logits under the prefill kernels against the sim through
    the same head (cmd_pack --verify), and generate_fast at B=1 and on the
    B=32 chunk route against the plain path, with phase 3s's limits'
    structure (the witnesses exact, the raw gaps at about twice their
    readings: see Q_VERIFY_MAX_REL). counted(route, fn) runs fn with every
    kernel's counts from 0 and keeps them in runs[route]."""
    from mobilequant_tpu_torch.data.calib import synthetic_tokens
    from mobilequant_tpu_torch.models import get_config
    from mobilequant_tpu_torch.models import model as MM
    from mobilequant_tpu_torch.ops import qops
    from mobilequant_tpu_torch.ops.chunk_model import fused_model_w4_chunk_plain
    from mobilequant_tpu_torch.ops.fused_layer import fused_model_w4_plain
    from mobilequant_tpu_torch.quant import calibrate, qmodel, smooth, train
    from mobilequant_tpu_torch.quant.policy import default_policy, relax_16bit
    from mobilequant_tpu_torch.quant.quantizer import QuantConfig
    from mobilequant_tpu_torch.runtime import engine as E
    from mobilequant_tpu_torch.runtime.generate import Generator
    from mobilequant_tpu_torch.runtime.kernel_config import KernelConfig

    cuda = dev.type == "cuda"

    def clock():
        if cuda:
            torch.cuda.synchronize()
        return time.perf_counter()

    phase(f"phase 3q: quantize, {model} W4A8 (calibration, LET, e2equant / omniquant, "
          f"finalize, smooth_last, pack), then serve the pack")
    cfg = get_config(model)
    L = cfg.num_layers
    if cuda:
        torch.zeros(1, device=dev)            # the allocator's stats exist from here
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    base_bytes = torch.cuda.memory_allocated(dev) if cuda else 0
    # the sim and the training run in full fp32: the guard refuses TF32
    tf32_off = not torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        qmodel.require_fp32_matmuls("cuda")
        guard_raised = False
    except RuntimeError:                      # the expected outcome
        guard_raised = True
    torch.backends.cuda.matmul.allow_tf32 = False
    if not (tf32_off and guard_raised):
        failures.append(f"3q: TF32 was on ({not tf32_off}) or the fp32 guard did not raise")

    t0 = clock()
    params = MM.init_params(cfg, torch.Generator(device=dev).manual_seed(SEED), device=dev)
    params["embed"]["w"][:, Q_OUTLIER_CHANNELS] *= 100.0
    tokens = synthetic_tokens(cfg.vocab_size, nsamples=Q_CALIB, seqlen=seqlen)
    policy = default_policy(cfg, QuantConfig(bitwidth=4, is_per_channel=True, is_symmetric=True),
                            QuantConfig(bitwidth=8))
    init_s = clock() - t0
    t0 = clock()
    stats = calibrate.run_calibration(params, tokens, cfg, policy, batch_size=4)
    let0 = smooth.smoothquant_let_init(cfg, *calibrate.smooth_calib_inputs(stats, dev), params,
                                       alpha=0.5)
    stats = calibrate.run_calibration(params, tokens, cfg, policy, let=let0, batch_size=4)
    ranges = calibrate.stats_to_ranges(stats, policy, dev)
    calib_s = clock() - t0

    g = torch.Generator(device=dev).manual_seed(SEED + 17)
    prompt = torch.randint(0, cfg.vocab_size, (1, Q_LET_PROMPT), generator=g, device=dev)
    with torch.no_grad():
        fp, _ = MM.forward(params, prompt, cfg)
        folded, _ = MM.forward(smooth.fold_let(params, let0, cfg), prompt, cfg)
        col, _, _ = qmodel.qforward(params, None, prompt, cfg, policy, mode="collect")
    let_err = float_err(folded, fp)
    col_err = float_err(col, fp)
    col_ok = bool(((col - fp).abs() <= 1e-6 + 1e-5 * fp.abs()).all())
    del folded, col
    print(f"  FP params {init_s:.1f} s; calibration (two passes of {Q_CALIB} x {seqlen} tokens, "
          f"the SmoothQuant LET init between) {calib_s:.2f} s; LET fold vs FP logits rel "
          f"{let_err[1]:.3g}; collect mode vs FP rel {col_err[1]:.3g} (rtol 1e-5: {col_ok})",
          flush=True)
    if not let_err[1] <= 2e-3:
        failures.append(f"3q: the LET fold moved the FP logits by rel {let_err[1]}")
    if not col_ok:
        failures.append(f"3q: collect mode is not the FP forward (rel {col_err[1]})")

    tc = train.TrainConfig(epochs=Q_E2E_EPOCHS, batch_size=1, remat=True)
    stamps = []
    t0 = clock()
    qstate, hist = train.e2equant(
        params, train.init_qstate(params, cfg, policy, tc, ranges, let=let0, device=dev),
        tokens[:Q_E2E_SAMPLES], cfg, policy, tc,
        checkpoint_cb=lambda epoch, qs: stamps.append(clock()))
    e2e_s = clock() - t0
    step_s = (stamps[-1] - stamps[0]) / ((Q_E2E_EPOCHS - 1) * Q_E2E_SAMPLES)
    e2e_peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    finite_state = all(bool(torch.isfinite(t).all()) for t in _tree_leaves(qstate))
    print(f"  e2equant ({Q_E2E_SAMPLES} samples x {Q_E2E_EPOCHS} epochs, batch 1, remat): "
          f"{e2e_s:.2f} s, {step_s:.3f} s a step after the first epoch (teacher and first "
          f"epoch {stamps[0] - t0:.2f} s); epoch losses {hist}; state finite {finite_state}; "
          f"peak memory {e2e_peak / 2**30:.2f} GiB", flush=True)
    if not all(math.isfinite(h) for h in hist) or not hist[-1] < hist[0]:
        failures.append(f"3q: e2equant losses {hist} not finite or not falling")
    if not finite_state:
        failures.append("3q: a quant state leaf is not finite after e2equant")

    log = _LineLog()
    tc_o = train.TrainConfig(epochs=1, batch_size=1)
    t0 = clock()
    q_omni, _ = train.omniquant(params, train.init_qstate(params, cfg, policy, tc_o, ranges,
                                                          let=let0, device=dev),
                                tokens[:Q_OMNI_SAMPLES], cfg, policy, tc_o, logger=log)
    omni_s = clock() - t0
    losses = [float(m.rsplit(" ", 1)[1]) for m in log.lines if "final loss" in m]
    print(f"  omniquant ({Q_OMNI_SAMPLES} samples, one epoch): {omni_s:.2f} s, "
          f"{omni_s / L:.3f} s a layer; layer losses {losses[0]:.3e} .. {losses[-1]:.3e}",
          flush=True)
    if len(losses) != L or not all(math.isfinite(x) for x in losses) or not all(
            bool(torch.isfinite(t).all()) for t in _tree_leaves(q_omni)):
        failures.append(f"3q: omniquant layer losses {losses}")
    del q_omni

    t0 = clock()
    params_f, qfin = train.finalize(params, qstate, cfg, policy)
    del params
    am = calibrate.head_input_absmax(params_f, tokens, cfg)
    s_last = calibrate.smooth_last_scales(am, qmodel.head_weight(params_f, cfg), alpha=0.5)
    ecfg = E.EngineConfig(model=cfg, max_seq_len=max_seq, kv_bits=8, head_bits=4)
    packed = E.pack(params_f, qfin["ranges"], cfg, policy, ecfg, device=dev, smooth_last=s_last)
    pack_s = clock() - t0
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0

    # cmd_pack --verify: the engine's prompt logits under the prefill kernels
    # against the sim on the finalized params, the sim's hidden through the
    # same packed head (divided by s_last, which the engine's norm carries);
    # beside it the plain engine against the sim, and the prefill route on
    # the plain engine's numerics (prefill_engine_numerics) against the plain
    # engine, which must be equal
    T = Q_VERIFY_PROMPT
    vt = torch.randint(0, cfg.vocab_size, (1, T), generator=g, device=dev)

    def verify_forward(kc):
        return E.forward(packed, vt, cfg, policy, positions=torch.arange(T, device=dev)[None],
                         kv_cache=E.init_kv_cache(ecfg, 1, device=dev),
                         cache_position=torch.zeros(1, dtype=torch.int32, device=dev),
                         kv_valid_len=torch.full((1,), T, dtype=torch.int32, device=dev),
                         kc=kc)[0]
    eng = counted("q_verify", lambda: verify_forward(KernelConfig.prefill()))
    eng_plain = verify_forward(KernelConfig.none())
    with patched(prefill_engine_numerics(E, cfg)):
        eng_wit = counted("q_verify_witness", lambda: verify_forward(KernelConfig.prefill()))
    with torch.no_grad():
        h, _, _ = qmodel.qforward_hidden(params_f, qfin, vt, cfg, policy)
        sim = E.quantized_head_logits(h / s_last, packed["head_q"], cfg.vocab_size,
                                      use_kernel=False)
    v_abs, v_rel = float_err(eng, sim)
    vp_rel, vk_rel = float_err(eng_plain, sim)[1], float_err(eng, eng_plain)[1]
    vw_rel = float_err(eng_wit, eng_plain)[1]
    print(f"  finalize + smooth_last + pack {pack_s:.2f} s; peak memory {peak / 2**30:.2f} GiB "
          f"({(peak - base_bytes) / 2**30:.2f} above the phase's start); verify, {T} tokens: "
          f"engine (prefill kernels {({k: v for k, v in runs['q_verify'].items() if v})}) vs "
          f"sim max abs {v_abs:.4g}, max rel {v_rel:.4g}; the plain engine vs sim rel "
          f"{vp_rel:.4g}; kernels vs plain engine rel {vk_rel:.4g}; the prefill route on the "
          f"plain engine's numerics vs the plain engine rel {vw_rel:.3g}", flush=True)
    if not (v_rel < Q_VERIFY_MAX_REL[0] and vp_rel < Q_VERIFY_MAX_REL[1]) \
            or eng.shape != sim.shape:
        failures.append(f"3q: engine vs sim max_rel {v_rel} (max abs {v_abs}), the plain "
                        f"engine {vp_rel}")
    if vw_rel > 1e-6 or runs["q_verify_witness"]["prefill_attention"]:
        failures.append(f"3q: verify witness vs the plain engine rel {vw_rel}")
    del params_f, h, sim, eng, eng_plain, eng_wit

    # serving the pack: B=1 generate_fast; the prefill and one decode step on
    # the kernels against the plain path, with phase 3s's witnesses (the
    # prefill route on the plain engine's numerics, and the plain prefill,
    # then the decode() step with the whole-model kernel's plain version on
    # them: both equal the plain path)
    rpol = relax_16bit(policy)
    g1 = Generator(packed, cfg, rpol, ecfg, device=dev)
    p1 = torch.randint(0, cfg.vocab_size, (1, prompt_len), generator=g, device=dev).cpu().numpy()
    g1.generate_fast(p1, 4)
    toks1, st1 = counted("q_main", lambda: g1.generate_fast(p1, Q_NEW, return_stats=True))
    l1 = runs["q_main"]
    print(f"  B=1 generate_fast on the pack: prefill {st1['prefill_s'] * 1e3:.2f} ms, decode "
          f"{st1['decode_tok_s']:.2f} tok/s, launches {({k: v for k, v in l1.items() if v})}",
          flush=True)
    if toks1.shape != (1, Q_NEW) or l1["fused_model_w4"] != Q_NEW - 1 \
            or l1["w4a8_matmul_stacked"] != 2 * L or l1["w4a8_matmul"] != 1 \
            or l1["qkv_rope"] != L or l1["prefill_attention"] != L:
        failures.append(f"3q: B=1 launches {l1}")
    tp = torch.as_tensor(p1, device=dev)
    wit = {(E, "fused_model_w4"): fused_model_w4_plain, **engine_numerics(E, cfg, rpol)}
    res, nxt = {}, None
    for tag, kc_p, kc_d in (("plain", KernelConfig.none(), KernelConfig.none()),
                            ("kernel", KernelConfig.prefill(), KernelConfig.decode()),
                            ("witness", KernelConfig.none(), KernelConfig.decode()),
                            ("prefill_witness", KernelConfig.prefill(), None)):
        c1 = E.init_kv_cache(ecfg, 1, device=dev)
        with patched(prefill_engine_numerics(E, cfg) if tag == "prefill_witness" else {}):
            lg, c1 = counted(f"q_b1_prefill_{tag}", lambda: E.forward(
                g1.packed, tp, cfg, rpol, kv_cache=c1,
                cache_position=torch.zeros(1, dtype=torch.int32, device=dev),
                kv_valid_len=torch.full((1,), prompt_len, dtype=torch.int32, device=dev),
                kc=kc_p, logits_at=torch.full((1,), prompt_len - 1, device=dev)))
        if kc_d is None:
            res[tag] = (lg, None, c1)
            continue
        if nxt is None:                       # the plain path's token, fed to every step
            nxt = torch.argmax(lg[:, -1], -1)[:, None]
        p = torch.full((1,), prompt_len, dtype=torch.int32, device=dev)
        with patched(wit if tag == "witness" else {}):
            lg2, c1 = counted(f"q_b1_step_{tag}", lambda: E.forward(
                g1.packed, nxt, cfg, rpol, positions=p[:, None], kv_cache=c1,
                cache_position=p, kv_valid_len=p + 1, kc=kc_d))
        res[tag] = (lg, lg2, c1)
    e_pre = float_err(res["kernel"][0], res["plain"][0])
    e_dec = float_err(res["kernel"][1], res["plain"][1])
    e_cache = [int8_err(res["kernel"][2].k, res["plain"][2].k),
               int8_err(res["kernel"][2].v, res["plain"][2].v)]
    e_wit = float_err(res["witness"][1], res["plain"][1])[1]
    e_pwit = float_err(res["prefill_witness"][0], res["plain"][0])[1]
    wit_eq = all(bool(torch.equal(getattr(res[w][2], kv), getattr(res["plain"][2], kv)))
                 for w in ("witness",) for kv in ("k", "v"))
    print(f"  B=1 kernels vs plain: prefill logits rel {e_pre[1]:.3g}; decode step (the plain "
          f"path's token) rel {e_dec[1]:.3g}; K / V after the step {e_cache}; witnesses vs "
          f"plain: prefill rel {e_pwit:.3g}, step rel {e_wit:.3g}, caches equal {wit_eq}",
          flush=True)
    lim = Q_B1_VS_PLAIN
    if e_pre[1] > lim[0] or e_dec[1] > lim[0] or runs["q_b1_step_kernel"]["fused_model_w4"] != 1:
        failures.append(f"3q: B=1 kernels vs plain: prefill {e_pre[1]}, step {e_dec[1]}")
    if max(e[0] for e in e_cache) > lim[1] or max(e[1] for e in e_cache) > lim[2]:
        failures.append(f"3q: B=1 K / V caches kernel vs plain {e_cache}")
    if e_wit > 1e-6 or e_pwit > 1e-6 or not wit_eq or runs["q_b1_step_witness"]["fused_model_w4"]:
        failures.append(f"3q: B=1 witnesses vs plain: prefill {e_pwit}, step {e_wit}, "
                        f"caches equal {wit_eq}")

    # the serving batch on the chunk route, and one Q_NEW-step chunk fed the
    # same tokens on it, on it with the kernel's plain version, on that plain
    # version moved onto the plain engine's numerics (equal to the plain
    # path), and on the plain path
    gs = Generator(packed, cfg, rpol, dataclasses.replace(ecfg, use_pallas=KernelConfig.chunk()),
                   device=dev)
    pb = torch.randint(0, cfg.vocab_size, (serve_b, prompt_len), generator=g,
                       device=dev).cpu().numpy()
    gs.generate_fast(pb, 3)
    tkb, stb = counted("q_b32_chunk", lambda: gs.generate_fast(pb, Q_NEW, return_stats=True))
    lb = runs["q_b32_chunk"]
    print(f"  B={serve_b} chunk route on the pack: decode {stb['decode_tok_s']:.2f} tok/s, "
          f"launches {({k: v for k, v in lb.items() if v})}", flush=True)
    if tkb.shape != (serve_b, Q_NEW) or lb["fused_model_w4_chunk"] != Q_NEW - 1 \
            or lb["staged_append"] != Q_NEW - 1:
        failures.append(f"3q: B={serve_b} chunk launches {lb}")
    cb = E.init_kv_cache(ecfg, serve_b, device=dev)
    _, cb = gs.prefill(torch.as_tensor(pb, device=dev), cb)
    ftoks = torch.randint(0, cfg.vocab_size, (serve_b, Q_NEW), generator=g, device=dev)
    fpos = torch.full((serve_b,), prompt_len, dtype=torch.int32, device=dev)
    chain = {}
    plain_fn = {(E, "fused_model_w4_chunk"): fused_model_w4_chunk_plain}
    for tag, kc_c, stand_ins in (
            ("chunk", KernelConfig.chunk(), {}),
            ("chunk_plain_fn", KernelConfig.chunk(), plain_fn),
            ("chunk_engine_numerics", KernelConfig.chunk(),
             {**plain_fn, **engine_numerics(E, cfg, rpol)}),
            ("plain", KernelConfig.none(), {})):
        cc = E.EngineKVCache(cb.k.clone(), cb.v.clone())
        with patched(stand_ins):
            chain[tag] = counted(f"q_chain_{tag}", lambda: run_staged_chunk(
                E, qops, gs.packed, cfg, rpol, kc_c, cc, ftoks, fpos))
    window = slice(prompt_len, prompt_len + Q_NEW)
    chain_err = {}
    for tag, ref, lim in (("chunk", "chunk_plain_fn", (2e-3, 0, 0.0)),
                          ("chunk_engine_numerics", "plain", (1e-6, 0, 0.0)),
                          ("chunk", "plain", Q_CHUNK_VS_PLAIN)):
        e_l = float_err(chain[tag][0], chain[ref][0])
        e_k = int8_err(chain[tag][1].k[:, :, :, window], chain[ref][1].k[:, :, :, window])
        e_v = int8_err(chain[tag][1].v[:, :, :, window], chain[ref][1].v[:, :, :, window])
        fin = bool(torch.isfinite(chain[tag][0]).all())
        chain_err[f"{tag}_vs_{ref}"] = {"logits_rel": e_l[1], "k_rows": e_k, "v_rows": e_v}
        print(f"  B={serve_b} {Q_NEW}-step chunk, {tag} vs {ref}: logits rel {e_l[1]:.3g}; "
              f"flushed K rows {e_k}, V rows {e_v}", flush=True)
        if not fin or e_l[1] > lim[0] or max(e_k[0], e_v[0]) > lim[1] \
                or max(e_k[1], e_v[1]) > lim[2]:
            failures.append(f"3q: {tag} chunk vs {ref}: logits rel {e_l[1]}, rows {e_k} {e_v}")
    if runs["q_chain_chunk"]["fused_model_w4_chunk"] != Q_NEW \
            or runs["q_chain_chunk_plain_fn"]["fused_model_w4_chunk"] \
            or any(runs["q_chain_plain"].values()):
        failures.append(f"3q: chain launches {runs['q_chain_chunk']}")
    del g1, gs, packed, cb, chain
    if cuda:
        torch.cuda.empty_cache()
    return {"calibration_s": calib_s, "e2equant_s": e2e_s, "e2equant_s_per_step": step_s,
            "e2equant_epoch_losses": hist, "e2equant_peak_bytes": e2e_peak,
            "omniquant_s": omni_s, "omniquant_s_per_layer": omni_s / L,
            "omniquant_layer_losses": losses, "finalize_pack_s": pack_s,
            "peak_bytes": peak, "phase_start_bytes": base_bytes,
            "let_fold_logits_rel": let_err[1], "collect_vs_fp_rel": col_err[1],
            "verify_max_abs": v_abs, "verify_max_rel": v_rel,
            "b1_decode_tok_s": st1["decode_tok_s"], "b1_prefill_ms": st1["prefill_s"] * 1e3,
            "verify_plain_engine_vs_sim_rel": vp_rel, "verify_kernels_vs_plain_rel": vk_rel,
            "b1_prefill_rel_kernel_vs_plain": e_pre[1],
            "b1_step_rel_kernel_vs_plain": e_dec[1], "b1_caches_kernel_vs_plain": e_cache,
            "chunk_decode_tok_s": stb["decode_tok_s"], "chunk": chain_err,
            "launches": {k: runs[k] for k in ("q_verify", "q_main", "q_b32_chunk")}}


# phase 3v: serving through the continuous batcher, speculative decoding and
# the HTTP server, on TinyLlama-1.1B W4A8/h4 at full width (int8 KV, relaxed
# policy, S 1024)
V_SEED = 7                                  # the requests' own generator
V_PROMPTS, V_BUDGETS = (17, 480), (8, 64)   # prompt lengths, new-token budgets
V_A = dict(batch_slots=8, prefill_buckets=(32, 128, 512), chunk_decode=16)
V_B = dict(batch_slots=32, chunk_prefill=128, chunk_decode=16)
# (a) two refill waves of 8 slots, (b) 32 slots and a refill of 8: loads
# sized to the script's time limit beside the head-dim-128 models' phases.
# The request lists are drawn at their first sizes (V_A_DRAWN, V_B_DRAWN),
# which fixes the witnesses' requests and the repeated prompt drawn from the
# same generator: (c)'s one-layer witness stream holds 2 distinct tokens, the
# least its check takes, and a redrawn prompt gave it one
V_A_REQUESTS, V_B_REQUESTS = 16, 40
V_A_DRAWN, V_B_DRAWN = 24, 64
V_SPEC_K, V_SPEC_NEW, V_SELF_DRAFT, V_SELF_DRAFT_NEW = 4, 64, 4, 16
V_HTTP_CLIENTS, V_HTTP_PER_CLIENT = 8, 2
# The witnesses run the plain versions at full width, so they serve a
# shorter load of the same shapes: (a) the first 12 requests, (b) 40 requests a quarter greedy, (c)
# V_WITNESS_NEW tokens, each budget cut to at most V_WITNESS_BUDGET. A cut
# budget ends in the first chunked tick, so (b)'s witness leads with
# V_WITNESS_LONG greedy requests of budget V_WITNESS_LONG_BUDGET: once the
# short ones have drained (two ticks), they are left alone with more than a
# chunk_decode to go, and run pipelined ticks (decode loops chained on the
# device, _last_tokens handed across ticks), overlapped refills having run
# behind them; the witness fails if no pipelined tick ran.
V_WITNESS_A, V_WITNESS_B, V_WITNESS_BUDGET, V_WITNESS_NEW = 12, 40, 12, 24
V_WITNESS_LONG, V_WITNESS_LONG_BUDGET = 3, 64
# The witnesses serve the pack's first layer only: at full depth the random
# model's greedy streams are one repeated token (12027 in (c); the main
# runs report their count of distinct greedy tokens), which a wrong token or
# position would not change; one layer's streams follow their inputs, and a
# witness whose streams hold one token fails. The 4-layer
# self-draft is then the whole 1-layer model: the CPU tests hold the
# rejected-draft path.
V_WITNESS_LAYERS = 1
# On the kernel routes the batch's kernels (B = 8 whole-model steps, B = 32
# chunk steps, T = k verifies) could round differently from the sequential
# B = 1 Generator's, and on random weights a near-tie would then turn a
# greedy stream; the share of greedy tokens before each stream's first
# difference is reported and held. The first reading (H100 80GB HBM3, 700 W)
# was 1.0 on every route ((a), (b), (c) x 3, (d)): a gap of 0, so "about
# twice the gap" leaves no room, and 0.95 is held, which lets a late flip
# through and stops a route that has lost its equality. The witnesses
# (every kernel its plain version on the plain engine's numerics) hold the
# wiring exactly.
V_KERNEL_PREFIX_MIN = 0.95


def _prefix_share(outs, refs) -> float:
    """The share of tokens that lie before each stream's first difference
    from its reference."""
    agree = total = 0
    for o, r in zip(outs, refs):
        n = next((i for i, (a, b) in enumerate(zip(o, r)) if a != b), min(len(o), len(r)))
        agree += n
        total += len(r)
    return agree / max(total, 1)


def serve_witness(E, cfg, policy):
    """{(module, name): stand-in} that puts every kernel the serving routes
    launch onto the plain engine's numerics: the prefill kernels
    (prefill_engine_numerics), the whole-model, whole-layer and chunk kernels'
    plain versions with the engine's attention and fp32 norms
    (engine_numerics), staged_append's plain version, and the MLP-block
    kernel's plain version on the engine's fp32 norms. Under it a batcher and
    the sequential Generator compute the plain engine's function, so their
    greedy streams must be equal: what is left between them is the batcher's
    wiring (slots, buckets, chunks at an offset, the adopt copies, ragged
    positions, the verify)."""
    from mobilequant_tpu_torch.ops import mlp_block
    from mobilequant_tpu_torch.ops.chunk_model import fused_model_w4_chunk_plain
    from mobilequant_tpu_torch.ops.fused_layer import fused_layer_w4_plain, fused_model_w4_plain
    from mobilequant_tpu_torch.ops.staged_append import staged_append_plain
    from mobilequant_tpu_torch.ops.w4a8_matmul import layer_pack

    def mlp(x, norm_w, norm_b, w13, w2, meta, layer, act_kind="silu", site_on=(True,) * 9,
            norm_kind="rmsnorm"):
        return mlp_block.fused_mlp_block_w4_plain(x, norm_w[layer], norm_b[layer],
                                                  layer_pack(w13, layer), layer_pack(w2, layer),
                                                  meta, act_kind, site_on, norm_kind)
    return {**prefill_engine_numerics(E, cfg), **engine_numerics(E, cfg, policy),
            (E, "fused_model_w4"): fused_model_w4_plain,
            (E, "fused_layer_w4"): fused_layer_w4_plain,
            (E, "fused_model_w4_chunk"): fused_model_w4_chunk_plain,
            (E, "staged_append"): staged_append_plain,
            (E, "fused_mlp_block_w4"): mlp}


def phase_serve(dev, counted, runs, failures, model="tinyllama-1.1b", max_seq=MAX_SEQ,
                n_a=V_A_REQUESTS, n_b=V_B_REQUESTS, prompts=V_PROMPTS, budgets=V_BUDGETS,
                cfg_a=V_A, cfg_b=V_B, spec_new=V_SPEC_NEW, rep_len=200,
                witness_long=(V_WITNESS_LONG, V_WITNESS_LONG_BUDGET),
                witness_layers=V_WITNESS_LAYERS) -> dict:
    """Phase 3v: the serving path through its entry points on the card.
    (a) ContinuousBatcher, 8 slots, buckets, chunk_decode 16: n_a requests,
    half greedy, a quarter at temperature 0.8, a quarter top-k 40 / top-p
    0.9 (single-token ticks while one is live: the whole-model kernel at
    B = 8, ragged positions); (b) 32 slots, chunk_prefill 128, chunk_decode
    16 on KernelConfig.chunk(): n_b greedy / temperature requests (the chunk
    kernel and staged_append each step, the prefill kernels at start > 0);
    (c) spec_k 4 on a repetitive prompt, and generate_speculative_fast at
    B = 1 with prompt lookup and with a 4-layer self-draft; (d) an
    InferenceServer over HTTP loopback with 8 client threads. Requests/s,
    tok/s, time to first token (p50 / p99), read-backs per tick, the
    device's idle share per tick (the device time from torch.profiler over a
    second run of the same seed, which must repeat every stream, sampled
    ones too, over the first run's unprofiled wall time; the profiled run's
    own share is kept beside it) and tokens per verify. Every greedy stream
    equals the sequential Generator's under serve_witness, on the pack cut
    to witness_layers layers; on the kernel routes the agreeing share is
    reported (V_KERNEL_PREFIX_MIN)."""
    import threading
    import urllib.request

    import numpy as np

    from mobilequant_tpu_torch.convert import build_synthetic_packed
    from mobilequant_tpu_torch.quant.policy import relax_16bit
    from mobilequant_tpu_torch.runtime import engine as E
    from mobilequant_tpu_torch.runtime.generate import Generator, _cut
    from mobilequant_tpu_torch.runtime.kernel_config import KernelConfig
    from mobilequant_tpu_torch.runtime.sampling import SamplerConfig
    from mobilequant_tpu_torch.runtime.serve import ContinuousBatcher
    from mobilequant_tpu_torch.runtime.server import InferenceServer, make_http_server

    phase(f"phase 3v: serving, {model} W4A8/h4, int8 KV, relaxed (batcher, speculative, "
          f"HTTP)")
    packed, cfg, policy, ecfg = build_synthetic_packed(model, w_bits=4, head_bits=4,
                                                       max_seq_len=max_seq, seed=SEED,
                                                       device=dev)
    policy = relax_16bit(policy)
    ecfg_b = dataclasses.replace(ecfg, use_pallas=KernelConfig.chunk())
    rng = np.random.default_rng(V_SEED)
    V = cfg.vocab_size
    greedy = SamplerConfig(greedy=True)
    mix_a = [greedy, SamplerConfig(temperature=0.8), greedy,
             SamplerConfig(temperature=0.8, top_k=40, top_p=0.9)]
    mix_b = [greedy, SamplerConfig(temperature=0.8)]

    def draw(n, mix):
        return [(rng.integers(0, V, int(rng.integers(prompts[0], prompts[1] + 1))
                              ).astype(np.int32),
                 int(rng.integers(budgets[0], budgets[1] + 1)), mix[i % len(mix)])
                for i in range(n)]
    # the lists at their first sizes (V_A_DRAWN / V_B_DRAWN); the main runs
    # serve the first n_a / n_b
    reqs_a_all = draw(max(n_a, V_A_DRAWN), mix_a)
    reqs_b_all = draw(max(n_b, V_B_DRAWN), mix_b)
    reqs_a, reqs_b = reqs_a_all[:n_a], reqs_b_all[:n_b]
    rep = np.tile(rng.integers(0, V, 24), -(-rep_len // 24))[:rep_len].astype(np.int32)
    reqs_c = [(rep, spec_new, greedy)]
    reqs_d = draw(V_HTTP_CLIENTS * V_HTTP_PER_CLIENT, [greedy])

    def serve(reqs, ecfg_, kw, seed=SEED, model=None):
        pk, c = model or (packed, cfg)
        cb = ContinuousBatcher(pk, c, policy, ecfg_, device=dev, seed=seed, **kw)
        rids = [cb.submit(p, n, sampler=s) for p, n, s in reqs]
        outs = cb.run()
        torch.cuda.synchronize()
        return [outs[r] for r in rids], cb

    gen = Generator(packed, cfg, policy, ecfg, device=dev)

    def sequential(reqs, g=None):
        return [(g or gen).generate(p[None], n)[0].tolist() for p, n, s in reqs if s.greedy]

    def greedy_of(reqs, outs):
        return [o for (p, n, s), o in zip(reqs, outs) if s.greedy]

    serve(draw(2, [greedy]), ecfg, cfg_a)                 # warm-up (allocator, clocks)
    out = {}
    for tag, reqs, ecfg_, kw, must in (
            ("a", reqs_a, ecfg, cfg_a, ("fused_model_w4",)),
            ("b", reqs_b, ecfg_b, cfg_b, ("fused_model_w4_chunk", "staged_append", "qkv_rope",
                                          "prefill_attention", "w13_gate",
                                          "w4a8_matmul_stacked"))):
        outs, cb = counted(f"serve_{tag}", lambda: serve(reqs, ecfg_, kw))
        st = dict(cb.stats)
        box = {}

        def again():
            t0 = time.perf_counter()
            box["outs"], box["cb"] = serve(reqs, ecfg_, kw)
            box["wall_ms"] = (time.perf_counter() - t0) * 1e3
        dev_ms, top, n_k = device_profile(again)
        ticks = box["cb"].stats["ticks"]
        wall_ms = st["wall_s"] * 1e3 / st["ticks"]              # unprofiled, a tick
        st.update({"requests": len(reqs), "ticks_profiled": ticks,
                   "device_ms_per_tick": dev_ms / ticks,
                   "wall_ms_per_tick": wall_ms,
                   "wall_ms_per_tick_profiled": box["wall_ms"] / ticks,
                   "idle_share": 1.0 - dev_ms / ticks / wall_ms,
                   "idle_share_profiled": 1.0 - dev_ms / box["wall_ms"],
                   "kernel_launches_per_tick": n_k / ticks,
                   "host_syncs_per_tick": st["host_syncs"] / st["ticks"],
                   "launches_per_tick": {k: v / st["ticks"]
                                         for k, v in runs[f"serve_{tag}"].items() if v},
                   "top_kernels": [(k, ms / ticks, n / ticks) for k, ms, n in top],
                   "repeats": box["outs"] == outs and ticks == st["ticks"]})
        seq = sequential(reqs)
        st["greedy_prefix_share"] = _prefix_share(greedy_of(reqs, outs), seq)
        st["greedy_distinct_tokens"] = len({t for o in seq for t in o})
        out[tag] = {"stats": st, "outs": outs, "seq": seq}
        print(f"  ({tag}) {len(reqs)} requests, {kw}: {st['requests_s']:.2f} req/s, "
              f"{st['tok_s']:.1f} tok/s, TTFT p50 {st['ttft_p50_s'] * 1e3:.1f} ms p99 "
              f"{st['ttft_p99_s'] * 1e3:.1f} ms, {st['ticks']} ticks, read-backs / tick "
              f"{st['host_syncs_per_tick']:.2f}, pipelined ticks {st['pipelined_ticks']}; "
              f"device {dev_ms / ticks:.3f} ms / tick (profiled rerun) of {wall_ms:.3f} wall, "
              f"idle share {st['idle_share']:.3f} (against the profiled rerun's "
              f"{box['wall_ms'] / ticks:.3f} ms wall: {st['idle_share_profiled']:.3f}); "
              f"same seed repeats every stream: {st['repeats']}; "
              f"greedy tokens before the first difference from the sequential Generator: "
              f"{st['greedy_prefix_share']:.4f} ({st['greedy_distinct_tokens']} distinct "
              f"greedy tokens); launches / tick "
              f"{ {k: round(v, 2) for k, v in st['launches_per_tick'].items()} }", flush=True)
        if not st["repeats"]:
            failures.append(f"3v ({tag}): a second run with the same seed differs")
        if any(len(o) != n for o, (p, n, s) in zip(outs, reqs)):
            failures.append(f"3v ({tag}): a stream is not its budget long")
        if any(min(o) < 0 or max(o) >= V for o in outs):
            failures.append(f"3v ({tag}): token ids out of range")
        for k in must:
            if runs[f"serve_{tag}"][k] <= 0:
                failures.append(f"3v ({tag}): {k} was not launched {runs[f'serve_{tag}']}")
        del box

    # (c) speculative: the batcher's tail ticks and generate_speculative_fast
    outs_c, cb_c = counted("serve_spec", lambda: serve(reqs_c, ecfg, dict(cfg_a, spec_k=V_SPEC_K)))
    spec = {"batcher": dict(cb_c.stats)}
    for tag, sdl, n_new in (("lookup", 0, spec_new),
                            ("self_draft", V_SELF_DRAFT, min(spec_new, V_SELF_DRAFT_NEW))):
        gen.generate_speculative_fast(rep[None], 8, k=V_SPEC_K, self_draft_layers=sdl)
        toks, stc = counted(f"spec_{tag}", lambda: gen.generate_speculative_fast(
            rep[None], n_new, k=V_SPEC_K, self_draft_layers=sdl, return_stats=True))
        stc["tokens"] = toks[0].tolist()
        stc["host_syncs_per_chunk"] = stc["host_syncs"] / max(-(-stc["verify_calls"] // 8), 1)
        spec[tag] = stc
    box = {}

    def spec_prof():
        t0 = time.perf_counter()
        box["stats"] = gen.generate_speculative_fast(rep[None], 32, k=V_SPEC_K,
                                                     return_stats=True)[1]
        torch.cuda.synchronize()
        box["wall_ms"] = (time.perf_counter() - t0) * 1e3
    spec_prof()                                         # the same call, unprofiled
    wall_ms = box["wall_ms"]
    dev_ms, top, n_k = device_profile(spec_prof)
    nv = box["stats"]["verify_calls"]
    spec["profiled"] = {"verify_calls": nv, "wall_ms": wall_ms,
                        "wall_ms_profiled": box["wall_ms"], "device_ms": dev_ms,
                        "idle_share": 1.0 - dev_ms / wall_ms,
                        "idle_share_profiled": 1.0 - dev_ms / box["wall_ms"],
                        "kernel_launches_per_verify": n_k / nv,
                        "top_kernels": [(k, ms / nv, n / nv) for k, ms, n in top]}
    print(f"  (c) prompt-lookup call (prefill and {nv} verifies): wall {wall_ms:.2f} ms "
          f"(profiled {box['wall_ms']:.2f}), device {dev_ms:.2f} ms, idle share "
          f"{spec['profiled']['idle_share']:.3f} (against the profiled wall "
          f"{spec['profiled']['idle_share_profiled']:.3f}), {n_k / nv:.1f} kernel launches a "
          f"verify", flush=True)
    seq_c = sequential(reqs_c)[0]
    t0 = time.perf_counter()
    gen.generate(rep[None], spec_new)
    seq_c_s = time.perf_counter() - t0
    spec["sequential_decode_tok_s"] = spec_new / seq_c_s
    spec["prefix_share"] = {
        "batcher": _prefix_share(outs_c, [seq_c]),
        "lookup": _prefix_share([spec["lookup"]["tokens"]], [seq_c]),
        "self_draft": _prefix_share([spec["self_draft"]["tokens"]],
                                    [seq_c[:len(spec["self_draft"]["tokens"])]])}
    if runs["spec_lookup"]["w4a8_matmul_stacked"] <= 0 or runs["spec_self_draft"]["fused_layer_w4"] <= 0:
        failures.append(f"3v (c): verify / self-draft kernels not launched "
                        f"{runs['spec_lookup']} {runs['spec_self_draft']}")
    print(f"  (c) spec_k {V_SPEC_K} batcher: {cb_c.stats['tok_s']:.1f} tok/s, "
          f"{cb_c.stats['ticks']} ticks; generate_speculative_fast B=1: prompt lookup "
          f"{spec['lookup']['decode_tok_s']:.1f} tok/s, {spec['lookup']['tokens_per_verify']:.3f} "
          f"tokens / verify, {spec['lookup']['host_syncs']} read-backs; {V_SELF_DRAFT}-layer "
          f"self-draft {spec['self_draft']['decode_tok_s']:.1f} tok/s, "
          f"{spec['self_draft']['tokens_per_verify']:.3f} tokens / verify; sequential generate "
          f"{spec['sequential_decode_tok_s']:.1f} tok/s; agreeing prefix with the sequential "
          f"stream {spec['prefix_share']}", flush=True)
    out["c"] = spec

    # (d) the HTTP server: V_HTTP_CLIENTS client threads over loopback
    cb_d = ContinuousBatcher(packed, cfg, policy, ecfg, device=dev, seed=SEED, **cfg_a)
    srv = InferenceServer(cb_d).start()
    httpd = make_http_server(srv, port=0)
    port = httpd.server_address[1]
    th = threading.Thread(target=httpd.serve_forever, daemon=True)
    th.start()
    res, errs = [None] * len(reqs_d), []

    def client(c):
        for j in range(V_HTTP_PER_CLIENT):
            i = c * V_HTTP_PER_CLIENT + j
            p, n, _ = reqs_d[i]
            body = json.dumps({"prompt_ids": [int(t) for t in p], "max_new_tokens": n,
                               "temperature": 0.0}).encode()
            try:
                with urllib.request.urlopen(urllib.request.Request(
                        f"http://127.0.0.1:{port}/generate", data=body,
                        headers={"Content-Type": "application/json"}), timeout=300) as r:
                    res[i] = json.loads(r.read())["completion_ids"]
            except Exception as e:                        # noqa: BLE001
                errs.append(repr(e))
    try:
        t0 = time.perf_counter()
        clients = [threading.Thread(target=client, args=(c,)) for c in range(V_HTTP_CLIENTS)]
        for c in clients:
            c.start()
        for c in clients:
            c.join(timeout=600)
        wall_d = time.perf_counter() - t0
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/stats", timeout=30) as r:
            stats_d = json.loads(r.read())
    finally:
        httpd.shutdown()
        httpd.server_close()
        srv.close()
    seq_d = sequential(reqs_d)
    done = [r for r in res if r is not None]
    out["d"] = {"requests": len(reqs_d), "errors": errs, "wall_s": wall_d,
                "requests_s": len(done) / wall_d,
                "tok_s": sum(len(r) for r in done) / wall_d,
                "host_syncs": stats_d["host_syncs"],
                "prefix_share": _prefix_share([r or [] for r in res], seq_d)}
    print(f"  (d) HTTP, {V_HTTP_CLIENTS} clients x {V_HTTP_PER_CLIENT}: {len(done)} of "
          f"{len(reqs_d)} answered in {wall_d:.2f} s ({out['d']['requests_s']:.2f} req/s, "
          f"{out['d']['tok_s']:.1f} tok/s), errors {errs}, agreeing prefix with the "
          f"sequential Generator {out['d']['prefix_share']:.4f}", flush=True)
    if errs or len(done) != len(reqs_d):
        failures.append(f"3v (d): HTTP requests failed {errs}")

    # the witnesses: every kernel on the plain engine's numerics, on the
    # pack's first witness_layers layers (the full-depth random model gives
    # every prompt the same greedy token, a stream that would hide a wrong
    # token or position; a cut model's streams follow their inputs); the
    # batcher's greedy streams must equal the sequential Generator's
    wit = {}
    wpacked = {k: v for k, v in packed.items() if k != "kernel_prep"}
    wpacked["layers"] = _cut(packed["layers"], witness_layers)
    wpacked["ranges"] = _cut(packed["ranges"], witness_layers)
    wcfg = dataclasses.replace(cfg, num_layers=witness_layers)
    wecfg, wecfg_b = (dataclasses.replace(e, model=wcfg) for e in (ecfg, ecfg_b))
    wmodel = (wpacked, wcfg)
    gen_w = Generator(wpacked, wcfg, policy, wecfg, device=dev)

    def short(reqs):
        return [(p, min(n, V_WITNESS_BUDGET), s) for p, n, s in reqs]
    wit_a = short(reqs_a_all[:V_WITNESS_A])
    wit_b = [(p, witness_long[1], greedy) for p, n, s in reqs_b_all[:witness_long[0]]]
    wit_b += short([(p, n, greedy if i % 4 == 0 else mix_b[1])
                    for i, (p, n, s) in enumerate((reqs_b_all + reqs_a_all)[:V_WITNESS_B])])
    wit_new = min(spec_new, V_WITNESS_NEW)
    with patched(serve_witness(E, wcfg, policy)):
        for tag, reqs, ecfg_, kw in (("a", wit_a, wecfg, cfg_a), ("b", wit_b, wecfg_b, cfg_b),
                                     ("c", [(rep, wit_new, greedy)], wecfg,
                                      dict(cfg_a, spec_k=V_SPEC_K))):
            outs, cb_w = counted(f"serve_witness_{tag}",
                                 lambda: serve(reqs, ecfg_, kw, model=wmodel))
            seq = sequential(reqs, gen_w)
            got = greedy_of(reqs, outs)
            if tag == "c":
                for sdl in (0, V_SELF_DRAFT):
                    got.append(gen_w.generate_speculative_fast(
                        rep[None], wit_new, k=V_SPEC_K, self_draft_layers=sdl)[0].tolist())
                    seq.append(seq[0])
            wit[tag] = {"streams": len(seq), "equal": sum(a == b for a, b in zip(got, seq)),
                        "prefix_share": _prefix_share(got, seq),
                        "distinct_tokens": len({t for o in seq for t in o}),
                        "pipelined_ticks": cb_w.stats["pipelined_ticks"]}
            if tag == "b" and not cb_w.stats["pipelined_ticks"]:
                failures.append(f"3v witness (b): no pipelined tick ran {cb_w.stats}")
            if wit[tag]["distinct_tokens"] < 2:
                failures.append(f"3v witness ({tag}): the greedy streams hold one token")
            if any(runs[f"serve_witness_{tag}"].values()):
                failures.append(f"3v witness ({tag}) launched kernels "
                                f"{runs[f'serve_witness_{tag}']}")
            if wit[tag]["equal"] != wit[tag]["streams"]:
                failures.append(f"3v witness ({tag}): {wit[tag]}")
    print(f"  witnesses (every kernel on the plain engine's numerics), greedy streams equal "
          f"to the sequential Generator's: {wit}", flush=True)
    out["witness"] = wit
    shares = {"a": out["a"]["stats"]["greedy_prefix_share"],
              "b": out["b"]["stats"]["greedy_prefix_share"], "d": out["d"]["prefix_share"],
              **{f"c_{k}": v for k, v in spec["prefix_share"].items()}}
    out["kernel_prefix_share"] = shares
    if V_KERNEL_PREFIX_MIN is not None and min(shares.values()) < V_KERNEL_PREFIX_MIN:
        failures.append(f"3v: greedy tokens agreeing with the sequential Generator on the "
                        f"kernel routes {shares} < {V_KERNEL_PREFIX_MIN}")
    for tag in ("a", "b"):
        out[tag] = out[tag]["stats"]
    del packed, gen, wpacked, gen_w
    torch.cuda.empty_cache()
    return out


def engine_numerics(E, cfg, policy, attention=True, norms=True):
    """{(module, name): stand-in} that moves the chunk and whole-model kernels'
    plain versions (ops/chunk_model, ops/fused_layer) onto the plain engine
    path's numerics: their attention (engine._decode_light_attention: scores
    scaled by s_q·s_k, then 1/sqrt(hd); P normalised before P·V; fp32 sums)
    and the plain engine's fp32 RMS norms and LayerNorms (engine._rms,
    engine._layer_norm) in place of the kernels' fp64-summed rms_norm and
    layer_norm. With both, the chunk and B <= 8 routes compute what the plain
    engine path computes, so what remains between them is the route's wiring
    (K column sums, RoPE rows, positions, staged columns, the row writes and
    the flush)."""
    from mobilequant_tpu_torch.ops import chunk_model, fused_layer, mlp_block
    out = {}
    if attention:
        out[(chunk_model, "chunk_attention_plain")] = engine_attention(E, cfg, policy)
        out[(fused_layer, "layer_attention_plain")] = engine_layer_attention(E, cfg, policy)
    if norms:
        for mod in (chunk_model, fused_layer, mlp_block):
            out[(mod, "rms_norm")] = E._rms
            out[(mod, "layer_norm")] = E._layer_norm
    return out


@contextlib.contextmanager
def patched(stand_ins):
    """Set {(module, name): value} for the body of the with, then restore."""
    orig = {key: getattr(*key) for key in stand_ins}
    try:
        for (mod, name), val in stand_ins.items():
            setattr(mod, name, val)
        yield
    finally:
        for (mod, name), val in orig.items():
            setattr(mod, name, val)


def _engine_light(E, cfg, policy, q8, kc, vc, pos, m, Hq, Hkv, hd, **staged):
    """The plain engine's decode-light attention on a kernel's operands: q8
    (B, Nq) rows [q | k | v], the layer meta m (its attention section)."""
    B = q8.shape[0]

    def enc(i):
        return {"scale": m[i], "offset": m[i + 1]}
    lr = {"self_attn.qk_bmm": {"input": enc(6), "input2": enc(8), "output": enc(12)},
          "self_attn.pv_bmm": {"input": enc(15), "input2": enc(10)}}
    q = q8[:, :Hq * hd].reshape(B, 1, Hq, hd)
    k = q8[:, Hq * hd:(Hq + Hkv) * hd].reshape(B, Hkv, 1, hd)
    v = q8[:, (Hq + Hkv) * hd:].reshape(B, Hkv, 1, hd)
    out = E._decode_light_attention(q, k, v, kc, vc, lr, policy, pos, cfg, B, Hkv, Hq // Hkv,
                                    hd, **staged)
    return out.reshape(B, Hq * hd)


def engine_attention(E, cfg, policy):
    """A stand-in for ops/chunk_model.chunk_attention_plain that runs the plain
    engine's staged attention on the same operands."""
    def att(q8, kc, vc, kcs, skl, svl, pos, mst, m, Hq, Hkv, hd, qk_fq_on, pv_fq_on):
        return _engine_light(E, cfg, policy, q8, kc, vc, pos, m, Hq, Hkv, hd, ks=skl, vs=svl,
                             staged_len=mst, k_colsum=kcs)
    return att


def engine_layer_attention(E, cfg, policy):
    """A stand-in for ops/fused_layer.layer_attention_plain that runs the plain
    engine's (unstaged) decode-light attention on the same operands."""
    def att(q8, kc, vc, pos, m, Hq, Hkv, hd):
        return _engine_light(E, cfg, policy, q8, kc, vc, pos, m, Hq, Hkv, hd)
    return att


def prefill_engine_numerics(E, cfg):
    """{(module, name): stand-in} that moves the prefill route
    (KernelConfig.prefill()) onto the plain engine path's numerics: each
    prefill kernel becomes its plain version on the same operands, and the
    prefill attention (whose plain version repeats the JAX kernel's math) the
    plain engine's attention: integer scores, their fake-quant, the causal
    mask, torch.softmax, P·V. What remains between that route and the plain
    prefill is the route's wiring (the qkv epilogue's RoPE rows and segment
    quantization, the cache writes, the gate path, the head)."""
    import math
    from mobilequant_tpu_torch.models import model as MM
    from mobilequant_tpu_torch.ops import qops
    from mobilequant_tpu_torch.ops.qkv_rope import qkv_rope_plain
    from mobilequant_tpu_torch.ops.w13_gate import _fq, w13_gate_plain
    from mobilequant_tpu_torch.ops.w4a8_matmul import layer_pack, w4a8_matmul_plain

    def matmul(x, p, xs, xo):
        return w4a8_matmul_plain(x, p["wq"], p["scale"], p["offset"], p["colsum"],
                                 p.get("bias"), xs, xo)

    def attention(q8, k8, v8, meta, positions, valid, qk_fq=False, pv_fq=False):
        m = [float(v) for v in meta]
        B, Hkv, G, T, hd = q8.shape
        S = k8.shape[2]
        sc = qops.int_matmul_qk(q8.reshape(B, Hkv, G * T, hd), k8, m[0], m[1], m[2], m[3])
        sc = sc.reshape(B, Hkv, G, T, S)
        if qk_fq:
            sc = _fq(sc, m[6], m[7], m[8])
        mask = MM.causal_mask(positions, S, cfg.neg_inf, valid)
        p = torch.softmax(sc / math.sqrt(hd) + mask[:, :, None], dim=-1)
        if pv_fq:
            p = _fq(p, m[9], m[10], m[11])
        out = qops.int_matmul_pv(p.reshape(B, Hkv, G * T, S), v8, m[4], m[5])
        return out.reshape(B, Hkv, G, T, hd)

    return {(E, "prefill_attention"): attention,
            (E, "qkv_rope"): lambda h8, pk, ofq, outq, cs, hs, ho, l, hd, rot: qkv_rope_plain(
                h8, layer_pack(pk, l), ofq, outq, cs, hs, ho, hd, rot),
            (E, "w13_gate"): lambda h8, pk, meta, l, act, site_on=(True,) * 4: w13_gate_plain(
                h8, layer_pack(pk, l), meta, act, site_on),
            (E, "w4a8_matmul_stacked"): lambda x, pk, xs, xo, l: matmul(x, layer_pack(pk, l),
                                                                       xs, xo),
            (E, "w4a8_matmul"): matmul}


def kv4_engine_numerics(E, cfg, packed, policy):
    """{(module, name): stand-in} that moves the kv4 route onto the plain
    engine path's numerics: the kv4 kernel becomes the plain engine's kv4
    attention (engine._kv4_decode_light_attention: fp32 sums) on the same
    operands, and the MLP-block kernel its plain version on the engine's fp32
    norms. What remains between that route and the plain path is the route's
    wiring (the layer-stacked views, K column sums, staged columns, the
    packed flush)."""
    from mobilequant_tpu_torch.ops import mlp_block
    from mobilequant_tpu_torch.ops.w4a8_matmul import layer_pack

    def att(q8, kp, vp, kcs, sk, sv, k_new, v_new, meta, pos, m_staged, layer, *,
            qk_fq_on=False, pv_fq_on=False):
        BH, G, hd = q8.shape
        B = pos.shape[0]
        Hkv = BH // B

        def seq(t):                         # layer `layer`, (B·Hkv, ...) -> (B, Hkv, ...)
            return t[layer].reshape(B, Hkv, *t.shape[2:])
        out = E._kv4_decode_light_attention(
            q8, k_new.reshape(B, Hkv, 1, hd), v_new.reshape(B, Hkv, 1, hd), seq(kp), seq(vp),
            E.layer_ranges(packed["ranges"], layer), policy, pos, cfg, B, Hkv, G, hd,
            ks=seq(sk), vs=seq(sv), staged_len=m_staged, k_colsum=seq(kcs))
        return out.reshape(BH, G, hd)

    def mlp(x, norm_w, norm_b, w13, w2, meta, layer, act_kind="silu", site_on=(True,) * 9,
            norm_kind="rmsnorm"):
        return mlp_block.fused_mlp_block_w4_plain(x, norm_w[layer], norm_b[layer],
                                                  layer_pack(w13, layer), layer_pack(w2, layer),
                                                  meta, act_kind, site_on, norm_kind)
    return {(E, "kv4_decode_attention"): att, (E, "fused_mlp_block_w4"): mlp,
            (mlp_block, "rms_norm"): E._rms}


# phases 2h / 3h: the registry's head-dim-128 models at full width (seeded
# synthetic packs): Qwen2-1.5B (12 q heads over 2 kv heads: G = 6, a q/k/v
# bias, the tied 151,936-row head, rope theta 1e6), Llama-3-8B (G = 4, rope
# theta 5e5) and Llama-2-7B (G = 1)
H_MODELS = {"q4": ("qwen2-1.5b", 4), "q8": ("qwen2-1.5b", 8), "l3": ("llama-3-8b", 4),
            "l2": ("llama-2-7b", 4)}
H_NEW, H_LOOP = 33, 16               # B=1 / B=32 generate_fast tokens, loop steps read
H_STAGED_NEW = 5                     # the host-bound staged and int4 routes
H_ATTN_STEPS = 8                     # attn() at B=1 (row 15 at G = 6)
H_SERVE_REQUESTS, H_SERVE_PROMPTS, H_SERVE_BUDGETS = 8, (17, 200), (8, 24)
# each model against the plain path, as GEMMA_*_VS_PLAIN: the T=128 prefill
# (logits rel, max int8 step, share of differing K / V bytes), the decode step
# after it (logits rel) and the 32-step B=32 chunk on the chunk route (logits
# rel, max int8 step, share of differing flushed bytes), about twice the first
# readings on the card, the port's 2e-3 at least, as Gemma W4's where a
# reading was 0 (the kernels equal their plain versions there, and the
# engine-numerics witnesses equal the plain path bit for bit). Read: Qwen2
# W4 prefill 7.18e-8, its bytes equal, the step 0, the chunk 1.59e-3 with 7
# steps on 0.045% of the flushed bytes; Qwen2 W8 prefill 2.16e-3, 7 steps on
# 0.62%, the step 2.47e-3, the chunk 3.12e-3, 6 steps on 1.9%; Llama-3 W4
# prefill 8.2e-8, its bytes equal, the step 2.5e-7, the chunk 4.8e-4, 2 steps
# on 0.0014%
H_PREFILL_VS_PLAIN = {"q4": (2e-3, 2, 2e-5), "q8": (4.4e-3, 14, 1.3e-2), "l3": (2e-3, 2, 2e-5)}
H_STEP_VS_PLAIN = {"q4": 2e-3, "q8": 5e-3, "l3": 2e-3}
H_CHUNK_VS_PLAIN = {"q4": (3.2e-3, 14, 9e-4), "q8": (6.3e-3, 12, 3.9e-2),
                    "l3": (2e-3, 4, 2.8e-5)}


def _attn_lib_ms(time_ms, B, Hq, Hkv, T, hd, gen, dev, causal):
    """SDPA on bf16 over the same shapes, the kv heads expanded (the yardstick
    of rows 4, 10, 15)."""
    G = Hq // Hkv
    qd = torch.randn((B, Hq, T, hd), generator=gen, device=dev).to(torch.bfloat16)
    kd = torch.randn((B, Hkv, 1, causal, hd), generator=gen, device=dev).to(torch.bfloat16)
    kd = kd.expand(B, Hkv, G, causal, hd).reshape(B, Hq, causal, hd)
    vd = kd.clone()
    return time_ms(lambda i: torch.nn.functional.scaled_dot_product_attention(
        qd, kd, vd, is_causal=T > 1))


def phase_hd128_kernels(dev, key, pk, cfg, pol, strict_pol, record, check_row, failures,
                        max_seq=MAX_SEQ, prompt_len=PROMPT_LEN, serve_b=SERVE_B, big_b=BIG_B):
    """Phase 2h for one model: its kernels at its widths against their plain
    versions, with kernel, plain, library and bound ms (record). G = 6 (the
    Qwen2 packs): rows 4 ("prefill_attention[G6]": T=128 into S=1024 and
    T=S=1024, relaxed and strict), 15 and 10 ("decode_attention[G6]",
    "kv4_decode_attention[G6]": B = 1, 32, 193 valid rows / pos0 192, m 0 and
    16, both policies); Llama-3 / Llama-2: row 4 at G = 4 / 1
    ("prefill_attention[hd128]"); every model (W4; W8 where the pack is W8):
    row 3 (qkv + RoPE + bias, M=128), row 5 (M=128), rows 1 / 2 (the head at
    M = 1, 32; o and w2 at M = 1, 32), row 6 (B = 1, 8, the head folded), row
    7 (B=1) and row 11 (B = 32, 128; Llama-2 at B = 32 only: the chunk gate
    takes it at S 1024, but no route of phase 3h serves it on the chunk
    kernel)."""
    from mobilequant_tpu_torch.models import model as MM
    from mobilequant_tpu_torch.ops import _build, qops
    from mobilequant_tpu_torch.ops.chunk_model import (
        fused_model_w4_chunk, fused_model_w4_chunk_plain)
    from mobilequant_tpu_torch.ops.decode_attention import (
        cluster_size, decode_attention, decode_attention_plain)
    from mobilequant_tpu_torch.ops.fused_layer import (
        fused_layer_w4, fused_layer_w4_plain, fused_model_w4, fused_model_w4_plain)
    from mobilequant_tpu_torch.ops.kv4_attention import (
        kv4_cluster_size, kv4_decode_attention, kv4_decode_attention_plain)
    from mobilequant_tpu_torch.ops.prefill_attention import (
        prefill_attention, prefill_attention_plain)
    from mobilequant_tpu_torch.ops.qkv_rope import qkv_rope, qkv_rope_plain
    from mobilequant_tpu_torch.ops.w13_gate import w13_gate, w13_gate_plain
    from mobilequant_tpu_torch.ops.w4a8_matmul import (
        layer_pack, w4a8_matmul, w4a8_matmul_plain, w4a8_matmul_stacked)
    from mobilequant_tpu_torch.runtime import engine as E

    name, wb = H_MODELS[key]
    gen = torch.Generator(device=dev).manual_seed(SEED + 40 + sum(map(ord, key)))
    ly = pk["layers"]
    L, D, F = cfg.num_layers, cfg.hidden_size, cfg.intermediate_size
    hd, Hq, Hkv, rot = cfg.head_dim_, cfg.num_heads, cfg.num_kv_heads, cfg.rotary_dim
    G, Nq, Ko = Hq // Hkv, (Hq + 2 * Hkv) * hd, Hq * hd
    Vp = pk["head_q"]["wq"].shape[1]
    div = 2 if wb == 4 else 1
    sfx = "" if wb == 4 else "[w8]"
    tag = f"{name} W{wb}"
    sms = _build.sm_count(dev)
    gkw = dict(num_q_heads=Hq, num_kv_heads=Hkv, head_dim=hd, rotary_dim=rot,
               act_kind=cfg.hidden_act, norm_kind="rmsnorm")
    lr0 = E.layer_ranges(pk["ranges"], 0)
    print(f"  {tag}: {L} layers, {Hq} q heads over {Hkv} kv heads of {hd} (G {G}), K {D}, "
          f"F {F}, vocab {cfg.vocab_size} (Vp {Vp})"
          f"{', tied head' if cfg.tie_word_embeddings else ''}"
          f"{', q/k/v bias' if cfg.has_qkv_bias else ''}, rope theta {cfg.rope_theta:g}",
          flush=True)

    def strict_meta(meta):
        m = list(meta)
        m[6:9] = [80.0 / 65535, 32768.0, 65535.0]
        m[9:12] = [1.0 / 65535, 0.0, 65535.0]
        return m

    # ---- row 4 at this model's G (W4 packs: one set per model) -------------
    if wb == 4:
        a_name = "prefill_attention[G6]" if G == 6 else "prefill_attention[hd128]"
        ameta = E._attn_meta(lr0, pol, cfg)
        for T, S, strict in ((prompt_len, max_seq, False), (prompt_len, max_seq, True),
                             (max_seq, max_seq, False)):
            meta_a = strict_meta(ameta) if strict else list(ameta)
            q8 = torch.randint(-128, 128, (1, Hkv, G, T, hd), generator=gen, device=dev,
                               dtype=torch.int8)
            k8 = torch.randint(-128, 128, (1, Hkv, S, hd), generator=gen, device=dev,
                               dtype=torch.int8)
            v8 = torch.randint(-128, 128, k8.shape, generator=gen, device=dev, dtype=torch.int8)
            posi = torch.arange(T, device=dev, dtype=torch.int32)[None]
            valid = torch.full((1,), T, device=dev, dtype=torch.int32)
            out = prefill_attention(q8, k8, v8, meta_a, posi, valid, strict, strict)
            err = float_err(out, prefill_attention_plain(q8, k8, v8, meta_a, posi, valid,
                                                         strict, strict))
            ms = time_ms(lambda i: prefill_attention(q8, k8, v8, meta_a, posi, valid, strict,
                                                     strict))
            plain_ms = time_ms(lambda i: prefill_attention_plain(q8, k8, v8, meta_a, posi,
                                                                 valid, strict, strict), n=3)
            lib_ms = _attn_lib_ms(time_ms, 1, Hq, Hkv, T, hd, gen, dev, T)
            pstep = meta_a[9] * (v8.float() - (meta_a[5] - 128.0)).abs().max().item() \
                * meta_a[4]
            ok = err[0] <= 32 * pstep if strict else err[1] <= 1e-4
            vis = T * (T + 1) / 2
            nbytes = Hq * T * hd + 2 * Hkv * T * hd + T * 4 + 4 + Hq * T * hd * 4
            record(a_name, f"{name} T={T} S={S} Hkv={Hkv} G={G} "
                   f"{'strict' if strict else 'relaxed'}", err, ok, ms, plain_ms, lib_ms,
                   bound(nbytes, int8_ops=2.0 * Hq * vis * hd, fp16_ops=4.0 * Hq * vis * hd,
                         sfu_ops=Hq * vis),
                   note=(f"{err[0] / pstep:.2f} prob steps; " if strict else "")
                   + "library: SDPA bf16, causal",
                   main=(T, strict) == (prompt_len, False))
            del q8, k8, v8
        # ragged (checked): B=2, T=100 (not a multiple of the query tile),
        # positions from 37, valid 137 / 120, both policies
        for strict in (False, True):
            meta_a = strict_meta(ameta) if strict else list(ameta)
            q8 = torch.randint(-128, 128, (2, Hkv, G, 100, hd), generator=gen, device=dev,
                               dtype=torch.int8)
            k8 = torch.randint(-128, 128, (2, Hkv, max_seq, hd), generator=gen, device=dev,
                               dtype=torch.int8)
            v8 = torch.randint(-128, 128, k8.shape, generator=gen, device=dev, dtype=torch.int8)
            posi = (37 + torch.arange(100, device=dev, dtype=torch.int32))[None].repeat(2, 1)
            valid = torch.tensor([137, 120], device=dev, dtype=torch.int32)
            err = float_err(prefill_attention(q8, k8, v8, meta_a, posi, valid, strict, strict),
                            prefill_attention_plain(q8, k8, v8, meta_a, posi, valid, strict,
                                                    strict))
            pstep = meta_a[9] * (v8.float() - (meta_a[5] - 128.0)).abs().max().item() \
                * meta_a[4]
            check_row(a_name, f"{name} B=2 T=100 pos0 37 valid 137/120 "
                      f"{'strict' if strict else 'relaxed'}", err,
                      err[0] <= 32 * pstep if strict else err[1] <= 1e-4)
            del q8, k8, v8

    # ---- rows 15 and 10 at G = 6 (Qwen2 W4) --------------------------------
    if key == "q4":
        nval = POS0 + 1
        for Bd, strict in ((1, False), (1, True), (serve_b, False), (serve_b, True)):
            kcd = torch.randint(-128, 128, (2, Bd, Hkv, max_seq, hd), generator=gen, device=dev,
                                dtype=torch.int8)
            vcd = torch.randint(-128, 128, kcd.shape, generator=gen, device=dev,
                                dtype=torch.int8)
            q8d = torch.randint(-128, 128, (Bd, Hkv, G, hd), generator=gen, device=dev,
                                dtype=torch.int8)
            vld = torch.full((Bd,), nval, dtype=torch.int32, device=dev)
            meta_d = E._attn_meta(lr0, strict_pol if strict else pol, cfg)
            ncl = cluster_size(Bd, Hkv, max_seq, sms, G, hd)
            out = decode_attention(q8d, kcd[1], vcd[1], meta_d, vld)
            err = float_err(out, decode_attention_plain(q8d, kcd[1], vcd[1], meta_d, vld))
            ms = time_ms(lambda i: decode_attention(q8d, kcd[i % 2], vcd[i % 2], meta_d, vld))
            plain_ms = time_ms(lambda i: decode_attention_plain(q8d, kcd[1], vcd[1], meta_d,
                                                                vld), n=3)
            rows_d = Bd * Hkv * nval
            record("decode_attention[G6]", f"{name} B={Bd} S={max_seq} valid={nval} ncl={ncl} "
                   f"{'strict' if strict else 'relaxed'}", err,
                   err[0] == 0 and bool(torch.isfinite(out).all()), ms, plain_ms,
                   _attn_lib_ms(time_ms, Bd, Hq, Hkv, 1, hd, gen, dev, nval),
                   bound(Bd * Hq * hd + 2 * rows_d * hd + Bd * 4 + Bd * Hq * hd * 4,
                         int8_ops=2.0 * G * hd * rows_d, fp64_ops=2.0 * G * hd * rows_d,
                         sfu_ops=G * rows_d),
                   note="library: SDPA bf16 over the valid rows, kv heads expanded",
                   main=(Bd, strict) == (1, False))
            del kcd, vcd
        S2 = max_seq // 2
        for Bk in (1, serve_b):
            BH = Bk * Hkv
            kp4 = torch.randint(-128, 128, (2, BH, hd, S2), generator=gen, device=dev,
                                dtype=torch.int8)
            vp4 = torch.randint(-128, 128, kp4.shape, generator=gen, device=dev,
                                dtype=torch.int8)
            kcs4 = qops.kv_colsums_packed(kp4)
            sk4, sv4 = (torch.randint(-128, -112, (2, BH, CHUNK_COLS, hd), generator=gen,
                                      device=dev, dtype=torch.int8) for _ in "kv")
            kn4, vn4 = (torch.randint(-128, -112, (BH, hd), generator=gen, device=dev,
                                      dtype=torch.int8) for _ in "kv")
            q84 = torch.randint(-128, 128, (BH, G, hd), generator=gen, device=dev,
                                dtype=torch.int8)
            pos4 = torch.full((Bk,), POS0, dtype=torch.int32, device=dev)
            ncl = kv4_cluster_size(Bk, Hkv, S2, CHUNK_COLS, sms, G, hd)
            lo = Bk * min(POS0, S2)
            for mst, strict in ((0, False), (STAGED_M, False), (STAGED_M, True)):
                meta4 = E._attn_meta(lr0, strict_pol if strict else pol, cfg)
                nbytes = (BH * G * hd + Hkv * (2 * hd * lo + 4 * lo + 2 * Bk * mst * hd
                                               + 2 * Bk * hd) + Bk * 4 + BH * G * hd * 4)
                cols = Hkv * (lo + Bk * (mst + 1))

                def args4(l, mst=mst, meta4=meta4):
                    return (q84, kp4, vp4, kcs4, sk4, sv4, kn4, vn4, meta4, pos4, mst, l)
                out = kv4_decode_attention(*args4(1), qk_fq_on=strict, pv_fq_on=strict)
                err = float_err(out, kv4_decode_attention_plain(*args4(1), qk_fq_on=strict,
                                                                pv_fq_on=strict))
                ms = time_ms(lambda i, args4=args4, strict=strict: kv4_decode_attention(
                    *args4(i % 2), qk_fq_on=strict, pv_fq_on=strict))
                plain_ms = time_ms(lambda i, args4=args4, strict=strict:
                                   kv4_decode_attention_plain(*args4(1), qk_fq_on=strict,
                                                              pv_fq_on=strict), n=3)
                record("kv4_decode_attention[G6]",
                       f"{name} B={Bk} pos0={POS0} m={mst} ncl={ncl} "
                       f"{'strict' if strict else 'relaxed'}", err,
                       err[0] == 0 and bool(torch.isfinite(out).all()), ms, plain_ms,
                       _attn_lib_ms(time_ms, Bk, Hq, Hkv, 1, hd, gen, dev, POS0 + mst + 1),
                       bound(nbytes, int8_ops=2.0 * G * hd * cols, fp64_ops=2.0 * G * hd * cols,
                             sfu_ops=G * cols),
                       note="library: SDPA bf16 over the valid rows, kv heads expanded",
                       main=(Bk, mst, strict) == (serve_b, STAGED_M, False))
            del kp4, vp4, kcs4, sk4, sv4

    # ---- row 3 (W4 only: the JAX engine takes the qkv epilogue kernel on W4
    # packs) and row 5 at the T=128 prefill -----------------------------------
    h8 = torch.randint(-128, 128, (prompt_len, D), generator=gen, device=dev, dtype=torch.int8)
    if wb == 4:
        cos, sin = MM.rope_cos_sin(torch.arange(prompt_len, device=dev)[None], cfg)
        cs = E._rope_cs_rows(cos, sin, hd, rot)
        ofq, outq = E._qkv_ofq_rows(pk, pol), E._qkv_outq_rows(pk["ranges"], cfg, L, dev)
        qkv = ly["qkv_proj"]
        err = int8_err(qkv_rope(h8, qkv, ofq[1], outq[1], cs, 0.02, 121.0, 1, hd, rot),
                       qkv_rope_plain(h8, layer_pack(qkv, 1), ofq[1], outq[1], cs, 0.02, 121.0,
                                      hd, rot))
        ms = time_ms(lambda i: qkv_rope(h8, qkv, ofq[i % L], outq[i % L], cs, 0.02, 121.0,
                                        i % L, hd, rot))
        plain_ms = time_ms(lambda i: qkv_rope_plain(h8, layer_pack(qkv, 1), ofq[1], outq[1], cs,
                                                    0.02, 121.0, hd, rot), n=3)
        record("qkv_rope", f"{name} M={prompt_len} {D}->{Nq} hd {hd}"
               f"{' q/k/v bias' if cfg.has_qkv_bias else ''}", err, err[0] == 0, ms, plain_ms,
               None, bound(prompt_len * D + D // 2 * Nq + 11 * Nq * 4
                           + prompt_len * 2 * hd * 4 + prompt_len * Nq,
                           int8_ops=2.0 * prompt_len * D * Nq))
    bmeta = E._mlp_block_meta(E.layer_ranges(pk["ranges"], 1), pol, cfg)
    bso = E._mlp_block_site_on(pol)
    w13 = ly["w13_proj"]
    err = int8_err(w13_gate(h8, w13, bmeta, 1, cfg.hidden_act, bso[1:5]),
                   w13_gate_plain(h8, layer_pack(w13, 1), bmeta, cfg.hidden_act, bso[1:5]))
    ms = time_ms(lambda i: w13_gate(h8, w13, bmeta, i % L, cfg.hidden_act, bso[1:5]))
    plain_ms = time_ms(lambda i: w13_gate_plain(h8, layer_pack(w13, 1), bmeta, cfg.hidden_act,
                                                bso[1:5]), n=3)
    record(f"w13_gate{sfx}", f"{name} M={prompt_len} {D}->2x{F} {cfg.hidden_act}", err,
           err[0] == 0, ms, plain_ms, None,
           bound(prompt_len * D + D // div * 2 * F + 2 * F * 16 + prompt_len * F,
                 int8_ops=2.0 * prompt_len * D * 2 * F))

    # ---- rows 1 / 2 (W4): the head at M = 1, 32 (decode-sized rows: the
    # whole-model kernels fold it; the prefill and the staged route call
    # row 1), o and w2 at M = 1, 32 -------------------------------------------
    if wb == 4:
        hq = pk["head_q"]
        for what, Mr, p in (("head", 1, None), ("head", serve_b, None),
                            ("o", 1, ly["o_proj"]), ("o", serve_b, ly["o_proj"]),
                            ("w2", 1, ly["w2"]), ("w2", serve_b, ly["w2"])):
            if p is None:
                K, N, wname, xs, xo, lp = D, Vp, "w4a8_matmul", 1.0, 128.0, hq
                call = lambda x, i: w4a8_matmul(x, hq, 1.0, 128.0)          # noqa: E731
            else:
                K, N = p["wq"].shape[1] * 2, p["wq"].shape[2]
                wname, xs, xo, lp = "w4a8_matmul_stacked", 0.02, 121.0, layer_pack(p, 0)
                call = lambda x, i, p=p: w4a8_matmul_stacked(x, p, 0.02, 121.0, i % L)  # noqa
            x = torch.randint(-128, 128, (Mr, K), generator=gen, device=dev, dtype=torch.int8)
            err = float_err(call(x, 0), w4a8_matmul_plain(x, lp["wq"], lp["scale"],
                                                          lp["offset"], lp["colsum"],
                                                          lp.get("bias"), xs, xo))
            ms = time_ms(lambda i, x=x, call=call: call(x, i))
            plain_ms = time_ms(lambda i, x=x, lp=lp, xs=xs, xo=xo: w4a8_matmul_plain(
                x, lp["wq"], lp["scale"], lp["offset"], lp["colsum"], lp.get("bias"), xs, xo),
                n=3)
            wus = [qops.unpack_nibbles(hq["wq"] if p is None else p["wq"][j]).contiguous()
                   for j in range(cold_count(K * N, 1 if p is None else L))]
            xp = x if Mr > 16 else torch.cat(
                [x, torch.zeros((32 - Mr, K), dtype=torch.int8, device=dev)])
            lib_ms = time_ms(lambda i, xp=xp, wus=wus: torch._int_mm(xp, wus[i % len(wus)]))
            del wus
            record(wname, f"{name} M={Mr} {what} {K}->{N}", err, err[1] <= 1e-5, ms, plain_ms,
                   lib_ms, bound(Mr * K + K // 2 * N + 4 * N * 4 + Mr * N * 4,
                                 int8_ops=2.0 * Mr * K * N),
                   note=None if Mr > 16 else "library: torch._int_mm on rows padded to 32")

    # ---- rows 6 (B = 1, 8), 7 (B = 1) and 11 (B = 32, 128) ------------------
    layer_w = (D * Nq + Ko * D + D * 2 * F + F * D) // div
    vec = (Nq * 4 + D * 4 + 2 * F * 4 + D * 4) * 4 + 4 * D * 4 + Nq * 16 + 65 * 4
    head_b = D // div * Vp + 2 * Vp * 4 + 2 * D * 4
    kp = E._kernel_prep(pk, pol, cfg)
    hargs = (pk["head_q"], pk["norm"])
    for Bm in (1, 8):
        kc = torch.randint(-128, 128, (L, Bm, Hkv, max_seq, hd), generator=gen, device=dev,
                           dtype=torch.int8)
        vc = torch.randint(-128, 128, kc.shape, generator=gen, device=dev, dtype=torch.int8)
        posb = torch.tensor([POS0 - 3 * b for b in range(Bm)], dtype=torch.int32, device=dev)
        cos, sin = MM.rope_cos_sin(posb[:, None], cfg)
        csb = E._rope_cs_rows(cos, sin, hd, rot).reshape(Bm, 2, hd)
        x = torch.randn((Bm, D), generator=gen, device=dev)
        fargs = (x, posb, csb, kp["ofq"], ly["attn_norm"], ly["qkv_proj"], ly["o_proj"],
                 ly["mlp_norm"], ly["w13_proj"], ly["w2"], kc, vc, kp["meta"])
        valid = int(posb.sum())
        att_ops = 2.0 * Hq * hd * valid
        step_io = 2 * Bm * D * 4 + Bm * 2 * hd * 4 + Bm * 4
        out = fused_model_w4(*fargs, *hargs, **gkw)
        ref = fused_model_w4_plain(*fargs, *hargs, **gkw)
        e_x, e_lg, e_kv = float_err(out[0], ref[0]), float_err(out[2], ref[2]), \
            int8_err(out[1], ref[1])
        ms = time_ms(lambda i: fused_model_w4(*fargs, *hargs, **gkw), n=10)
        plain_ms = event_ms(lambda: fused_model_w4_plain(*fargs, *hargs, **gkw), n=2)
        nbytes = (L * (layer_w + vec + valid * Hkv * hd * 2 + Bm * 2 * Hkv * hd) + step_io
                  + head_b + Bm * Vp * 4)
        ops_i8 = L * (2.0 * Bm * (D * Nq + Ko * D + D * 2 * F + F * D) + att_ops) \
            + 2.0 * Bm * D * Vp
        record(f"fused_model_w4{sfx}", f"{name} B={Bm} L={L} S={max_seq} pos<={POS0} "
               f"+W{wb} head", (max(e_x[0], e_lg[0]), max(e_x[1], e_lg[1])),
               e_x[1] <= 2e-3 and e_lg[1] <= 2e-3 and e_kv[0] == 0, ms, plain_ms, None,
               bound(nbytes, int8_ops=ops_i8, fp32_ops=L * att_ops),
               note=f"kv_new max diff {e_kv[0]} on {e_kv[1]:.3g} of bytes; plain timed with "
                    f"events")
        if Bm == 1:
            out = fused_layer_w4(*fargs, 1, **gkw)
            ref = fused_layer_w4_plain(*fargs, 1, **gkw)
            e_x, e_kv = float_err(out[0], ref[0]), int8_err(out[1], ref[1])
            ms = time_ms(lambda i: fused_layer_w4(*fargs, i % L, **gkw))
            plain_ms = event_ms(lambda: fused_layer_w4_plain(*fargs, 1, **gkw), n=3)
            record(f"fused_layer_w4{sfx}", f"{name} B=1 S={max_seq} pos={POS0}", e_x,
                   e_x[1] <= 2e-3 and e_kv[0] == 0, ms, plain_ms, None,
                   bound(layer_w + vec + valid * Hkv * hd * 2 + 2 * Hkv * hd + step_io,
                         int8_ops=2.0 * (D * Nq + Ko * D + D * 2 * F + F * D) + att_ops,
                         fp32_ops=att_ops),
                   note=f"kv_new max diff {e_kv[0]} on {e_kv[1]:.3g} of bytes; plain timed "
                        f"with events")
        del kc, vc, fargs
    ckw = dict(gkw, qk_fq_on=False, pv_fq_on=False)
    for Bc in (serve_b,) if key == "l2" else (serve_b, big_b):
        kc = torch.randint(-128, 128, (L, Bc, Hkv, max_seq, hd), generator=gen, device=dev,
                           dtype=torch.int8)
        vc = torch.randint(-128, 128, kc.shape, generator=gen, device=dev, dtype=torch.int8)
        skc = torch.randint(-128, 128, (L, Bc, Hkv, CHUNK_COLS, hd), generator=gen,
                            device=dev, dtype=torch.int8)
        svc = torch.randint(-128, 128, skc.shape, generator=gen, device=dev,
                            dtype=torch.int8)
        kcs = E.kv_colsums(kc)
        pos0 = torch.tensor([POS0 - b % 8 for b in range(Bc)], dtype=torch.int32,
                            device=dev)
        cos, sin = MM.rope_cos_sin((pos0 + STAGED_M)[:, None], cfg)
        csb = E._rope_cs_rows(cos, sin, hd, rot).reshape(Bc, 2, hd)
        x = torch.randn((Bc, D), generator=gen, device=dev)
        valid = int(pos0.sum())
        rows_kv = valid + Bc * STAGED_M
        att_ops = 2.0 * Hq * hd * (rows_kv + Bc)
        nbytes = (L * (layer_w + vec + rows_kv * Hkv * hd * 2 + valid * Hkv * 4
                       + Bc * 2 * Hkv * hd)
                  + 2 * Bc * D * 4 + Bc * 2 * hd * 4 + Bc * 4 + head_b + Bc * Vp * 4)
        ops_i8 = L * (2.0 * Bc * (D * Nq + Ko * D + D * 2 * F + F * D) + att_ops) \
            + 2.0 * Bc * D * Vp
        cargs = (x, pos0, csb, kp["ofq"], ly["attn_norm"], ly["qkv_proj"], ly["o_proj"],
                 ly["mlp_norm"], ly["w13_proj"], ly["w2"], kc, vc, kcs, skc, svc, STAGED_M,
                 kp["meta"], *hargs)
        out = fused_model_w4_chunk(*cargs, **ckw)
        ref = fused_model_w4_chunk_plain(*cargs, **ckw)
        e_x, e_lg = float_err(out[0], ref[0]), float_err(out[2], ref[2])
        e_kv = int8_err(out[1], ref[1])
        ms = time_ms(lambda i: fused_model_w4_chunk(*cargs, **ckw), n=5)
        plain_ms = event_ms(lambda: fused_model_w4_chunk_plain(*cargs, **ckw), n=2)
        record(f"fused_model_w4_chunk{sfx}", f"{name} B={Bc} pos0<={POS0} m={STAGED_M} "
               f"relaxed +W{wb} head", (max(e_x[0], e_lg[0]), max(e_x[1], e_lg[1])),
               e_x[1] <= 2e-3 and e_lg[1] <= 2e-3 and e_kv[0] == 0, ms, plain_ms, None,
               bound(nbytes, int8_ops=ops_i8, fp32_ops=L * att_ops),
               note=f"kv_new max diff {e_kv[0]} on {e_kv[1]:.3g} of bytes; plain timed "
                    f"with events")
        del kc, vc, skc, svc, kcs, cargs
    torch.cuda.empty_cache()


def phase_hd128_serve(dev, key, pk, cfg, pol, ecfg, counted, runs, failures,
                      prompt_len=PROMPT_LEN, serve_b=SERVE_B, n_new=H_NEW, chunk_cols=CHUNK_COLS,
                      kv4_pack=None) -> dict:
    """Phase 3h for one model through the entry points, counted from 0 around
    each run (runs[f"h{key}_<route>"]): B=1 generate_fast (the prefill
    kernels, then one whole-model launch a token; a device profile of the
    T=128 prefill); Qwen2 / Llama-3: B=32 on the chunk route (W4
    KernelConfig.chunk(), W8 the entry config) and on the staged route (W4
    the entry config, W8 decode() at stacked_bt_max 128 without the chunk
    kernel), the B=1 step against the plain path with its engine-numerics
    witnesses, and a chunk_cols-step B=32 chunk on the chunk route against its
    kernel's plain version, that plain version on the plain engine's
    numerics (exact) and the plain path (H_*_VS_PLAIN); Qwen2 W4 also on the
    int4 cache (kv4_pack: B = 1, 32, the kv4 kernel a layer and step: row 10
    at G = 6) and on attn() at B=1 (row 15 at G = 6); Llama-2: B=1, and B=16
    on the entry config's staged route."""
    import numpy as np

    from mobilequant_tpu_torch.ops import qops
    from mobilequant_tpu_torch.ops.chunk_model import fused_model_w4_chunk_plain
    from mobilequant_tpu_torch.ops.fused_layer import fused_model_w4_plain
    from mobilequant_tpu_torch.runtime import engine as E
    from mobilequant_tpu_torch.runtime.generate import Generator
    from mobilequant_tpu_torch.runtime.kernel_config import KernelConfig

    name, wb = H_MODELS[key]
    L = cfg.num_layers
    gen = torch.Generator(device=dev).manual_seed(SEED + 60 + sum(map(ord, key)))
    out = {}

    def prompt(B, T=prompt_len):
        return torch.randint(0, cfg.vocab_size, (B, T), generator=gen, device=dev).cpu().numpy()

    def route(rname, g, pr, new, want, loop=0):
        """generate_fast on one route, its launches held to `want`; with loop,
        a profiled decode loop of min(loop, 4) steps from the prefill's state
        (device ms, launches and the idle share a step)."""
        g.generate_fast(pr, 3)                                  # warm-up
        tk, st = counted(f"h{key}_{rname}", lambda: g.generate_fast(pr, new, return_stats=True))
        r = {"batch": pr.shape[0], "prompt": pr.shape[1], "new_tokens": new,
             "decode_tok_s": st["decode_tok_s"], "prefill_ms": st["prefill_s"] * 1e3,
             "launches": runs[f"h{key}_{rname}"]}
        if loop:
            tp = torch.as_tensor(pr, device=dev)
            last, cache = g.prefill(tp, g.init_cache(pr.shape[0]))
            tok = torch.argmax(last, -1)[:, None]
            start = torch.full((pr.shape[0],), pr.shape[1], dtype=torch.int32, device=dev)
            n_p = min(loop, 4)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            g.decode(tok, cache, start, n_p)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
            d_ms, top, n_l = device_profile(lambda: g.decode(tok, cache, start, n_p))
            r.update(device_ms_per_step=d_ms / n_p, wall_ms_per_step=wall / n_p,
                     idle_share=1.0 - d_ms / wall, launches_per_step=n_l / n_p,
                     top_kernels=[(k, ms / n_p, c / n_p) for k, ms, c in top[:4]])
        out[rname] = r
        print(f"  h{key} {rname}: decode {st['decode_tok_s']:.2f} tok/s, prefill "
              f"{st['prefill_s'] * 1e3:.2f} ms"
              + (f", loop step wall {r['wall_ms_per_step']:.3f} ms, device "
                 f"{r['device_ms_per_step']:.3f} ms, idle {r['idle_share']:.3f}, "
                 f"{r['launches_per_step']:.1f} launches" if loop else "")
              + f"; counts { {k: v for k, v in r['launches'].items() if v} }", flush=True)
        if tk.shape != (pr.shape[0], new) or tk.min() < 0 or tk.max() >= cfg.vocab_size:
            failures.append(f"h{key} {rname}: bad tokens {tk.shape}")
        got = {k: r["launches"][k] for k in want}
        if got != want:
            failures.append(f"h{key} {rname}: launches {got}, expected {want}")
        return tk

    phase(f"phase 3h: {name} W{wb}A8/h{wb} serving, int8 KV, relaxed")
    steps = n_new - 1
    g1 = Generator(pk, cfg, pol, ecfg, device=dev)
    pr1 = prompt(1)
    want = {"fused_model_w4": steps, "prefill_attention": L, "w13_gate": L,
            "fused_mlp_block_w4": 0, "fused_layer_w4": 0, "fused_model_w4_chunk": 0}
    want.update({"qkv_rope": L, "w4a8_matmul_stacked": 2 * L, "w4a8_matmul": 1} if wb == 4
                else {"qkv_rope": 0, "w4a8_matmul_stacked": 0, "w4a8_matmul": 0})
    route("b1", g1, pr1, n_new, want, loop=H_LOOP)
    tp1 = torch.as_tensor(pr1, device=dev)
    pre_d, pre_t, pre_l = device_profile(lambda: g1.prefill(tp1, g1.init_cache(1)))
    out["b1"].update(prefill_device_ms=pre_d, prefill_kernel_launches=pre_l,
                     prefill_top_kernels=pre_t[:6])
    print(f"  h{key} T={prompt_len} prefill: wall {out['b1']['prefill_ms']:.3f} ms, device "
          f"{pre_d:.3f} ms, {pre_l} launches; "
          + ", ".join(f"{k[:28]} {ms_:.3f} ms x{c}" for k, ms_, c in pre_t[:4]), flush=True)
    if key == "l2":
        route("b16_staged", Generator(pk, cfg, pol, ecfg, device=dev), prompt(16), H_STAGED_NEW,
              {"fused_mlp_block_w4": L * (H_STAGED_NEW - 1), "staged_append": H_STAGED_NEW - 1,
               "fused_model_w4_chunk": 0, "fused_model_w4": 0}, loop=4)
        return out
    p32 = prompt(serve_b)
    kc_chunk = KernelConfig.chunk() if wb == 4 else KernelConfig.serving(cfg, pk, serve_b)
    kc_staged = (True if wb == 4 else
                 KernelConfig.decode().replace(stacked_bt_max=128))
    if not kc_chunk.chunk_kernel:
        failures.append(f"h{key}: no chunk kernel in the chunk route's config at B={serve_b}")
    gc = Generator(pk, cfg, pol, dataclasses.replace(ecfg, use_pallas=kc_chunk), device=dev)
    route("b32_chunk", gc, p32, n_new, {"fused_model_w4_chunk": steps, "staged_append": steps,
                                        "fused_mlp_block_w4": 0, "fused_model_w4": 0},
          loop=H_LOOP)
    route("b32_staged", Generator(pk, cfg, pol, dataclasses.replace(ecfg, use_pallas=kc_staged),
                                  device=dev), p32, H_STAGED_NEW,
          {"fused_mlp_block_w4": L * (H_STAGED_NEW - 1), "staged_append": H_STAGED_NEW - 1,
           "fused_model_w4_chunk": 0, "fused_model_w4": 0}, loop=4)
    if key == "q4":
        route("attn_b1", Generator(pk, cfg, pol, dataclasses.replace(
            ecfg, use_pallas=KernelConfig.attn()), device=dev), pr1, H_ATTN_STEPS + 1,
            {"decode_attention": H_ATTN_STEPS * L, "fused_model_w4": 0, "staged_append": 0})
    if kv4_pack is not None:
        pk4, pol4, ecfg4 = kv4_pack
        g4 = Generator(pk4, cfg, pol4, ecfg4, device=dev)
        for rname, pr in (("kv4_b1", pr1), ("kv4_b32", p32)):
            route(rname, g4, pr, H_STAGED_NEW,
                  {"kv4_decode_attention": L * (H_STAGED_NEW - 1), "fused_model_w4": 0,
                   "staged_append": H_STAGED_NEW - 1}, loop=4)
        del g4

    # B=1 against the plain path, with the witnesses (as phase 3g)
    res = {}
    wit = {(E, "fused_model_w4"): fused_model_w4_plain, **engine_numerics(E, cfg, pol)}
    nxt = None
    for tag, kc_p, kc_d in (("plain", KernelConfig.none(), KernelConfig.none()),
                            ("kernel", KernelConfig.prefill(), KernelConfig.decode()),
                            ("witness", KernelConfig.none(), KernelConfig.decode()),
                            ("prefill_witness", KernelConfig.prefill(), None)):
        cache = E.init_kv_cache(ecfg, 1, device=dev)
        with patched(prefill_engine_numerics(E, cfg) if tag == "prefill_witness" else {}):
            lg, cache = counted(f"h{key}_b1_prefill_{tag}", lambda: E.forward(
                g1.packed, tp1, cfg, pol, kv_cache=cache,
                cache_position=torch.zeros(1, dtype=torch.int32, device=dev),
                kv_valid_len=torch.full((1,), prompt_len, dtype=torch.int32, device=dev),
                kc=kc_p, logits_at=torch.full((1,), prompt_len - 1, device=dev)))
        pre = E.EngineKVCache(cache.k.clone(), cache.v.clone())
        if kc_d is None:
            res[tag] = (lg, None, cache, pre)
            continue
        if nxt is None:
            nxt = torch.argmax(lg[:, -1], -1)[:, None]
        p = torch.full((1,), prompt_len, dtype=torch.int32, device=dev)
        with patched(wit if tag == "witness" else {}):
            lg2, cache = counted(f"h{key}_b1_step_{tag}", lambda: E.forward(
                g1.packed, nxt, cfg, pol, positions=p[:, None], kv_cache=cache,
                cache_position=p, kv_valid_len=p + 1, kc=kc_d))
        res[tag] = (lg, lg2, cache, pre)
    e_pre = float_err(res["kernel"][0], res["plain"][0])
    e_dec = float_err(res["kernel"][1], res["plain"][1])
    e_cache = [int8_err(res["kernel"][3].k, res["plain"][3].k),
               int8_err(res["kernel"][3].v, res["plain"][3].v)]
    e_wit = float_err(res["witness"][1], res["plain"][1])
    wit_eq = all(bool(torch.equal(getattr(res["witness"][2], kv), getattr(res["plain"][2], kv)))
                 for kv in ("k", "v"))
    e_pwit = float_err(res["prefill_witness"][0], res["plain"][0])
    pwit_eq = all(bool(torch.equal(getattr(res["prefill_witness"][3], kv),
                                   getattr(res["plain"][3], kv))) for kv in ("k", "v"))
    fin = all(bool(torch.isfinite(r[0]).all()) and (r[1] is None or bool(
        torch.isfinite(r[1]).all())) for r in res.values())
    out["b1_step"] = {"prefill_logits_rel_kernel_vs_plain": e_pre[1],
                      "decode_logits_rel_kernel_vs_plain": e_dec[1],
                      "k_cache_kernel_vs_plain": e_cache[0], "v_cache_kernel_vs_plain": e_cache[1],
                      "prefill_witness_logits_rel_vs_plain": e_pwit[1],
                      "prefill_witness_caches_equal": pwit_eq,
                      "witness_logits_rel_vs_plain": e_wit[1], "witness_caches_equal": wit_eq}
    print(f"  h{key} prefill logits kernel vs plain: rel {e_pre[1]:.3g}; the step on the plain "
          f"path's token rel {e_dec[1]:.3g}; prefill K / V bytes (max step, share) {e_cache[0]} / "
          f"{e_cache[1]}; finite {fin}; prefill witness: rel {e_pwit[1]:.3g}, caches equal "
          f"{pwit_eq}; step witness: rel {e_wit[1]:.3g}, caches equal {wit_eq}", flush=True)
    lim = H_PREFILL_VS_PLAIN[key]
    if not fin or res["kernel"][0].shape != (1, 1, cfg.vocab_size) or e_pre[1] > lim[0]:
        failures.append(f"h{key} prefill logits kernel vs plain rel {e_pre[1]}, finite {fin}")
    if e_dec[1] > H_STEP_VS_PLAIN[key]:
        failures.append(f"h{key} decode logits kernel vs plain rel {e_dec[1]}")
    if max(e[0] for e in e_cache) > lim[1] or max(e[1] for e in e_cache) > lim[2]:
        failures.append(f"h{key} prefill K / V caches kernel vs plain {e_cache}")
    pruns = runs[f"h{key}_b1_prefill_prefill_witness"]
    if e_pwit[1] > 1e-6 or not pwit_eq or pruns["prefill_attention"] or pruns["w13_gate"]:
        failures.append(f"h{key} prefill witness vs plain: rel {e_pwit[1]}, caches equal "
                        f"{pwit_eq}, launches {pruns}")
    if runs[f"h{key}_b1_step_witness"]["fused_model_w4"] \
            or runs[f"h{key}_b1_step_kernel"]["fused_model_w4"] != 1 \
            or e_wit[1] > 1e-6 or not wit_eq:
        failures.append(f"h{key} B=1 witness vs plain: rel {e_wit[1]}, caches equal {wit_eq}, "
                        f"launches {runs[f'h{key}_b1_step_kernel']}")

    # one chunk_cols-step B=32 chunk fed the same tokens on the chunk route,
    # with the kernel's plain version, that plain version on the plain
    # engine's numerics (the wiring witness), and the plain path
    c32 = E.init_kv_cache(ecfg, serve_b, device=dev)
    _, c32 = gc.prefill(torch.as_tensor(p32, device=dev), c32)
    ftok = torch.randint(0, cfg.vocab_size, (serve_b, chunk_cols), generator=gen, device=dev)
    fpos = torch.full((serve_b,), prompt_len, dtype=torch.int32, device=dev)
    window = slice(prompt_len, prompt_len + chunk_cols)
    plain_chunk = {(E, "fused_model_w4_chunk"): fused_model_w4_chunk_plain}
    stand = {"chunk_plain_fn": plain_chunk,
             "chunk_engine_numerics": {**plain_chunk, **engine_numerics(E, cfg, pol)}}
    chn = {}
    for tag, kc_c in (("chunk", kc_chunk), *((w, kc_chunk) for w in stand),
                      ("plain", KernelConfig.none())):
        cc = E.EngineKVCache(c32.k.clone(), c32.v.clone())
        with patched(stand.get(tag, {})):
            chn[tag] = counted(f"h{key}_chain_{tag}", lambda: run_staged_chunk(
                E, qops, gc.packed, cfg, pol, kc_c, cc, ftok, fpos))
    cr = runs[f"h{key}_chain_chunk"]
    if cr["fused_model_w4_chunk"] != chunk_cols or cr["fused_mlp_block_w4"] \
            or runs[f"h{key}_chain_chunk_engine_numerics"]["fused_model_w4_chunk"] \
            or any(runs[f"h{key}_chain_plain"].values()):
        failures.append(f"h{key} chain launches {cr} / {runs[f'h{key}_chain_plain']}")
    out["chunk_vs_plain"] = {}
    for tag, ref, lim in (("chunk", "chunk_plain_fn", (2e-3, 0, 0.0)),
                          ("chunk_engine_numerics", "plain", (1e-6, 0, 0.0)),
                          ("chunk", "plain", H_CHUNK_VS_PLAIN[key])):
        e_l = float_err(chn[tag][0], chn[ref][0])
        stp = [float_err(chn[tag][0][:, i], chn[ref][0][:, i])[1] for i in range(chunk_cols)]
        e_k = int8_err(chn[tag][1].k[:, :, :, window], chn[ref][1].k[:, :, :, window])
        e_v = int8_err(chn[tag][1].v[:, :, :, window], chn[ref][1].v[:, :, :, window])
        fin = bool(torch.isfinite(chn[tag][0]).all())
        out["chunk_vs_plain"][f"{tag}_vs_{ref}"] = {
            "logits_rel": e_l[1], "logits_rel_per_step": stp, "k_rows": e_k, "v_rows": e_v,
            "finite": fin}
        print(f"  h{key} B={serve_b} {chunk_cols}-step chunk, {tag} vs {ref}: logits rel "
              f"{e_l[1]:.3g} (step 0: {stp[0]:.3g}); flushed K rows {e_k}, V rows {e_v}",
              flush=True)
        if not fin or e_l[1] > lim[0]:
            failures.append(f"h{key} {tag} chunk vs {ref}: logits rel {e_l[1]}, finite {fin}")
        if max(e_k[0], e_v[0]) > lim[1] or max(e_k[1], e_v[1]) > lim[2]:
            failures.append(f"h{key} {tag} chunk vs {ref}: flushed rows {e_k} {e_v}")
    del chn, c32, gc, g1
    return out


def phase_hd128_batcher(dev, pk, cfg, pol, ecfg, counted, runs, failures,
                        n=H_SERVE_REQUESTS, prompts=H_SERVE_PROMPTS,
                        budgets=H_SERVE_BUDGETS) -> dict:
    """A ContinuousBatcher of 8 slots (buckets 32 / 128 / 256, chunk_decode 16)
    serving n greedy Qwen2-1.5B requests, all submitted at t = 0: requests/s,
    tok/s and the whole-model launches; every stream of its budget's length
    within the vocabulary."""
    import numpy as np

    from mobilequant_tpu_torch.runtime.serve import ContinuousBatcher

    rng = np.random.default_rng(V_SEED + 19)
    reqs = [(rng.integers(0, cfg.vocab_size, int(rng.integers(prompts[0], prompts[1] + 1))
                          ).astype(np.int32), int(rng.integers(budgets[0], budgets[1] + 1)))
            for _ in range(n)]

    def serve():
        cb = ContinuousBatcher(pk, cfg, pol, ecfg, device=dev, seed=SEED, batch_slots=8,
                               prefill_buckets=(32, 128, 256), chunk_decode=16)
        rids = [cb.submit(p, b) for p, b in reqs]
        outs = cb.run()
        torch.cuda.synchronize()
        return [outs[r] for r in rids]
    serve()                                                    # warm-up
    t0 = time.perf_counter()
    outs = counted("hq4_batcher", serve)
    wall = time.perf_counter() - t0
    ntok = sum(len(o) for o in outs)
    r = {"requests": n, "requests_s": n / wall, "tok_s": ntok / wall, "wall_s": wall,
         "launches": runs["hq4_batcher"]}
    print(f"  hq4 batcher: {n} requests, {ntok} tokens in {wall:.3f} s: {r['requests_s']:.2f} "
          f"req/s, {r['tok_s']:.2f} tok/s; counts "
          f"{ {k: v for k, v in runs['hq4_batcher'].items() if v} }", flush=True)
    if [len(o) for o in outs] != [b for _, b in reqs] \
            or any(min(o) < 0 or max(o) >= cfg.vocab_size for o in outs) \
            or runs["hq4_batcher"]["fused_model_w4"] <= 0:
        failures.append(f"hq4 batcher: streams {[len(o) for o in outs]}, launches "
                        f"{runs['hq4_batcher']}")
    return r


# phase 3k: a random Qwen2-1.5B checkpoint under HF names, bf16, written as
# .safetensors shards, read back by the port's converter on the card
K_CALIB, K_SEQLEN, K_NEW = 4, 128, 16
_ST_NAMES = {torch.float32: "F32", torch.float16: "F16", torch.bfloat16: "BF16"}


def write_safetensors(path, tensors: dict) -> int:
    """A minimal .safetensors writer (the header of dtypes, shapes and byte
    offsets, padded to 8 bytes, then the raw bytes of each host tensor);
    returns the file's bytes."""
    import struct
    header, off = {}, 0
    for k, t in tensors.items():
        n = t.numel() * t.element_size()
        header[k] = {"dtype": _ST_NAMES[t.dtype], "shape": list(t.shape),
                     "data_offsets": [off, off + n]}
        off += n
    h = json.dumps(header).encode()
    h += b" " * (-len(h) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(h)) + h)
        for t in tensors.values():
            f.write(t.contiguous().view(torch.uint8).numpy().data)
    return 8 + len(h) + off


def phase_convert(dev, counted, runs, failures, model="qwen2-1.5b", max_seq=MAX_SEQ,
                  n_calib=K_CALIB, seqlen=K_SEQLEN, n_new=K_NEW) -> dict:
    """Phase 3k: draw a random checkpoint of `model` under HF names in bf16 on
    a seeded torch.Generator (weights N(0, 0.02²), norms 1 + N(0, 0.05²),
    q/k/v biases N(0, 0.1²)), write it to build/ as two .safetensors shards,
    load it with models/convert.load_checkpoint(device="cuda") (seconds and
    GB/s), check every leaf against the drawn weights (transposed, stacked,
    fp32: exact), calibrate on n_calib synthetic samples (quant/calibrate's
    entry points), pack W4A8/h4 and generate n_new tokens at B=1 (one whole-model
    launch a token)."""
    import shutil

    from mobilequant_tpu_torch.data.calib import synthetic_tokens
    from mobilequant_tpu_torch.models import get_config
    from mobilequant_tpu_torch.models.convert import load_checkpoint
    from mobilequant_tpu_torch.quant import calibrate
    from mobilequant_tpu_torch.quant.policy import default_policy, relax_16bit
    from mobilequant_tpu_torch.quant.quantizer import QuantConfig
    from mobilequant_tpu_torch.runtime import engine as E
    from mobilequant_tpu_torch.runtime.generate import Generator

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    phase(f"phase 3k: the HF converter, a random {model} checkpoint (bf16 .safetensors) "
          f"-> load_checkpoint -> calibrate -> pack W4A8/h4 -> generate")
    cfg = get_config(model)
    L, D, F = cfg.num_layers, cfg.hidden_size, cfg.intermediate_size
    qd, kvd = cfg.q_dim, cfg.kv_dim
    g = torch.Generator(device=dev).manual_seed(SEED + 70)

    def draw(*shape, std=0.02, mean=0.0):
        return (mean + std * torch.randn(shape, generator=g, device=dev)).to(torch.bfloat16)

    sd = {"model.embed_tokens.weight": draw(cfg.vocab_size, D),
          "model.norm.weight": draw(D, std=0.05, mean=1.0)}
    P = "model.layers.{}."
    for i in range(L):
        p = P.format(i)
        sd.update({p + "input_layernorm.weight": draw(D, std=0.05, mean=1.0),
                   p + "post_attention_layernorm.weight": draw(D, std=0.05, mean=1.0),
                   p + "self_attn.q_proj.weight": draw(qd, D),
                   p + "self_attn.k_proj.weight": draw(kvd, D),
                   p + "self_attn.v_proj.weight": draw(kvd, D),
                   p + "self_attn.o_proj.weight": draw(D, qd),
                   p + "mlp.gate_proj.weight": draw(F, D),
                   p + "mlp.up_proj.weight": draw(F, D),
                   p + "mlp.down_proj.weight": draw(D, F)})
        if cfg.has_qkv_bias:
            sd.update({p + "self_attn.q_proj.bias": draw(qd, std=0.1),
                       p + "self_attn.k_proj.bias": draw(kvd, std=0.1),
                       p + "self_attn.v_proj.bias": draw(kvd, std=0.1)})
    if not cfg.tie_word_embeddings:
        sd["lm_head.weight"] = draw(cfg.vocab_size, D)
    ckpt = Path(__file__).resolve().parent / "build" / f"ckpt_{model}"
    shutil.rmtree(ckpt, ignore_errors=True)
    ckpt.mkdir(parents=True)
    names = list(sd)
    half = len(names) // 2
    t0 = time.perf_counter()
    nbytes = sum(write_safetensors(ckpt / f"model-0000{j + 1}-of-00002.safetensors",
                                   {k: sd[k].cpu() for k in part})
                 for j, part in enumerate((names[:half], names[half:])))
    write_s = time.perf_counter() - t0
    sync()
    t0 = time.perf_counter()
    params = load_checkpoint(ckpt, cfg, "qwen2" if "qwen2" in model else "llama",
                             dtype=torch.float32, device=dev)
    sync()
    load_s = time.perf_counter() - t0
    shutil.rmtree(ckpt, ignore_errors=True)

    def want(fmt, transpose=True):
        return torch.stack([sd[fmt.format(i)].float().T if transpose else
                            sd[fmt.format(i)].float() for i in range(L)])
    ly = params["layers"]
    checks = [("embed", params["embed"]["w"], sd["model.embed_tokens.weight"].float()),
              ("norm", params["norm"]["w"], sd["model.norm.weight"].float()),
              ("norm.b", params["norm"]["b"], torch.zeros(D, device=dev))]
    for leaf, fmt, tr in (("attn_norm", "input_layernorm.weight", False),
                          ("mlp_norm", "post_attention_layernorm.weight", False),
                          ("q_proj", "self_attn.q_proj.weight", True),
                          ("k_proj", "self_attn.k_proj.weight", True),
                          ("v_proj", "self_attn.v_proj.weight", True),
                          ("o_proj", "self_attn.o_proj.weight", True),
                          ("w1", "mlp.gate_proj.weight", True), ("w3", "mlp.up_proj.weight", True),
                          ("w2", "mlp.down_proj.weight", True)):
        checks.append((leaf, ly[leaf]["w"], want(P + fmt, tr)))
        bias = P + fmt[:-6] + "bias"
        checks.append((leaf + ".b", ly[leaf]["b"], want(bias, False) if bias.format(0) in sd
                       else torch.zeros_like(ly[leaf]["b"])))
    bad = [n_ for n_, got, ref in checks if got.shape != ref.shape or not torch.equal(got, ref)]
    leaves_ok = not bad and all(v.device.type == dev.type and v.dtype == torch.float32
                                for v in _tree_leaves(params))
    del sd, checks
    print(f"  checkpoint: {nbytes / 1e9:.3f} GB in two shards (written in {write_s:.2f} s); "
          f"load_checkpoint to the card {load_s:.2f} s = {nbytes / 1e9 / load_s:.2f} GB/s; "
          f"every leaf equal to the drawn weights: {leaves_ok}"
          + (f" (differ: {bad})" if bad else ""), flush=True)
    if not leaves_ok:
        failures.append(f"3k: converted leaves differ from the checkpoint: {bad}")

    t0 = time.perf_counter()
    policy = default_policy(cfg, QuantConfig(bitwidth=4, is_per_channel=True, is_symmetric=True),
                            QuantConfig(bitwidth=8))
    tokens = synthetic_tokens(cfg.vocab_size, nsamples=n_calib, seqlen=seqlen)
    stats = calibrate.run_calibration(params, tokens, cfg, policy, batch_size=2)
    ranges = calibrate.stats_to_ranges(stats, policy, dev)
    ecfg = E.EngineConfig(model=cfg, max_seq_len=max_seq, kv_bits=8, head_bits=4)
    packed = E.pack(params, ranges, cfg, policy, ecfg, device=dev)
    sync()
    pack_s = time.perf_counter() - t0
    del params
    pol = relax_16bit(policy)
    gen = Generator(packed, cfg, pol, ecfg, device=dev)
    prompt = tokens[:1, :32]
    toks, st = counted("convert_b1", lambda: gen.generate_fast(prompt, n_new, return_stats=True))
    lg, _ = gen.prefill(torch.as_tensor(prompt, device=dev).long(), gen.init_cache(1))
    fin = bool(torch.isfinite(lg).all())
    r = {"checkpoint_gb": nbytes / 1e9, "write_s": write_s, "load_s": load_s,
         "load_gb_s": nbytes / 1e9 / load_s, "leaves_equal": leaves_ok,
         "calibrate_pack_s": pack_s, "decode_tok_s": st["decode_tok_s"],
         "prefill_ms": st["prefill_s"] * 1e3, "launches": runs["convert_b1"]}
    print(f"  calibrate ({n_calib} x {seqlen} synthetic tokens) + pack W4A8/h4: {pack_s:.2f} s; "
          f"generate_fast B=1: {n_new} tokens, decode {st['decode_tok_s']:.2f} tok/s, logits "
          f"finite {fin}; counts { {k: v for k, v in runs['convert_b1'].items() if v} }",
          flush=True)
    if toks.shape != (1, n_new) or toks.min() < 0 or toks.max() >= cfg.vocab_size or not fin \
            or runs["convert_b1"]["fused_model_w4"] != n_new - 1:
        failures.append(f"3k: generate from the converted checkpoint: tokens {toks.shape}, "
                        f"finite {fin}, launches {runs['convert_b1']}")
    del packed, gen
    torch.cuda.empty_cache()
    return r


def main() -> None:
    if not torch.cuda.is_available():
        fail("no CUDA device")
    try:
        from mobilequant_tpu_torch import ops
        from mobilequant_tpu_torch.convert import build_synthetic_packed, build_synthetic_wonly
        from mobilequant_tpu_torch.models import model as MM
        from mobilequant_tpu_torch.ops import _build
        from mobilequant_tpu_torch.ops import qops
        from mobilequant_tpu_torch.ops.chunk_model import (
            chunk_kernel_supported, fused_model_w4_chunk, fused_model_w4_chunk_plain)
        from mobilequant_tpu_torch.ops.decode_attention import (
            cluster_size, decode_attention, decode_attention_plain)
        from mobilequant_tpu_torch.ops.kv4_attention import (
            kv4_cluster_size, kv4_decode_attention, kv4_decode_attention_plain)
        from mobilequant_tpu_torch.ops.otail import (
            fused_otail_block_w4, fused_otail_block_w4_plain)
        from mobilequant_tpu_torch.ops.staged_append import staged_append, staged_append_plain
        from mobilequant_tpu_torch.ops.fused_mlp import fused_mlp, fused_mlp_plain
        from mobilequant_tpu_torch.ops.fused_mlp_block import (
            fused_mlp_block, fused_mlp_block_plain)
        from mobilequant_tpu_torch.ops.w13_gate_w2 import w13_gate_w2, w13_gate_w2_plain
        from mobilequant_tpu_torch.ops.fused_layer import (
            fused_layer_w4, fused_layer_w4_plain, fused_model_w4, fused_model_w4_plain)
        from mobilequant_tpu_torch.ops.mlp_block import (
            DP4A_ROWS, MLP_BLOCK, fused_mlp_block_w4, fused_mlp_block_w4_plain, mlp_args,
            mlp_tiles)
        from mobilequant_tpu_torch.ops.prefill_attention import (
            prefill_attention, prefill_attention_plain)
        from mobilequant_tpu_torch.ops.qkv_rope import qkv_rope, qkv_rope_plain
        from mobilequant_tpu_torch.ops.w13_gate import w13_gate, w13_gate_plain
        from mobilequant_tpu_torch.ops.w4a8_matmul import (
            layer_pack, w4a8_matmul, w4a8_matmul_plain, w4a8_matmul_stacked)
        from mobilequant_tpu_torch.ops.w8a8_matmul import w8a8_matmul, w8a8_matmul_plain
        from mobilequant_tpu_torch.ops.wonly_matmul import (
            w4a16_matmul, w4a16_matmul_plain, wonly_matmul_stacked, wonly_matmul_stacked_plain)
        from mobilequant_tpu_torch.quant.policy import relax_16bit
        from mobilequant_tpu_torch.quant.quantizer import QuantConfig
        from mobilequant_tpu_torch.runtime import engine as E
        from mobilequant_tpu_torch.runtime import wonly as W
        from mobilequant_tpu_torch.runtime.generate import Generator
        from mobilequant_tpu_torch.runtime.kernel_config import KernelConfig
    except ImportError as exc:
        fail(f"the port package is not beside this script ({exc})")

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)

    # ---- phase 1: build --------------------------------------------------
    out_dir = Path(__file__).resolve().parent / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    t0 = time.perf_counter()
    log = io.StringIO()
    with contextlib.redirect_stdout(log):               # ptxas resource lines
        _build.build(verbose=True)
    _build.lib()
    build_s = time.perf_counter() - t0
    (out_dir / "build_log.txt").write_text(log.getvalue())
    spills = [n for n in re.findall(r"(\d+) bytes spill stores", log.getvalue()) if int(n)]
    src_s = sorted(((float(t), src) for src, t in re.findall(r"\[nvcc (\S+)\] ([\d.]+) s",
                                                              log.getvalue())), reverse=True)
    print(f"kernel build: {build_s:.1f} s ({len(spills)} functions spill registers; "
          f"ptxas lines in chiprun_out/build_log.txt); slowest sources: "
          + ", ".join(f"{src} {t:.0f} s" for t, src in src_s[:5]), flush=True)

    # ---- the full-width model --------------------------------------------
    t0 = time.perf_counter()
    packed, cfg, policy, ecfg = build_synthetic_packed(
        "tinyllama-1.1b", w_bits=4, head_bits=4, max_seq_len=MAX_SEQ, seed=SEED,
        device=dev)
    strict_policy, policy = policy, relax_16bit(policy)
    torch.cuda.synchronize()
    print(f"synthetic TinyLlama-1.1B W4A8/h4 pack: {time.perf_counter() - t0:.1f} s",
          flush=True)
    ly = packed["layers"]
    L, D, F = cfg.num_layers, cfg.hidden_size, cfg.intermediate_size
    hd, Hq, Hkv = cfg.head_dim_, cfg.num_heads, cfg.num_kv_heads
    gen = torch.Generator(device=dev).manual_seed(SEED)
    failures = []

    # ---- phase 2: each kernel against its plain version ------------------
    rows = {}

    def record(name, shape, err, tol_ok, ms, plain_ms, lib_ms, bnd, note=None, main=False):
        """main: the row whose numbers stand in the kernels line (else the first)."""
        rows.setdefault(name, []).append({
            "shape": shape, "max_abs_err": err[0], "rel_or_frac": err[1],
            "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
            "bound_ms": bnd[0], "bound_by": bnd[1], "note": note, "main": main})
        print(f"  {name:18s} {shape:34s} err={err[0]:.3g} ({err[1]:.3g}) "
              f"kernel={ms:.4f} ms plain={plain_ms:.4f} ms "
              f"library={'-' if lib_ms is None else f'{lib_ms:.4f} ms'} "
              f"bound={bnd[0]:.4f} ms ({bnd[1]})", flush=True)
        if not tol_ok:
            failures.append(f"{name} {shape}: error {err}")

    checks = []                # shapes checked against the plain version, not timed

    def check_row(name, shape, err, ok):
        print(f"  {name} {shape}: err={err[0]:.3g} ({err[1]:.3g})", flush=True)
        checks.append({"name": name, "shape": shape, "max_abs_err": err[0], "rel": err[1],
                       "ok": ok})
        if not ok:
            failures.append(f"{name} {shape}: error {err}")

    def w13_gate_sweep(sfx, pk, meta, layers, act, so, K, Fw, div, g, tag=""):
        """Row 5 at the engine's other prompt lengths, against its plain
        version at error 0: M = 2 and 17 (ragged row tiles, split K) checked,
        M = 1024 timed as well."""
        for Mr in (2, 17, 1024):
            x = torch.randint(-128, 128, (Mr, K), generator=g, device=dev, dtype=torch.int8)
            out = w13_gate(x, pk, meta, 1, act, so)
            ref = w13_gate_plain(x, layer_pack(pk, 1), meta, act, so)
            err = int8_err(out, ref)
            shape = f"{tag}M={Mr} {K}->2x{Fw} {act}"
            if Mr < 1024:
                check_row(f"w13_gate{sfx}", shape, err, err[0] == 0)
                continue
            ms = time_ms(lambda i: w13_gate(x, pk, meta, i % layers, act, so))
            plain_ms = time_ms(lambda i: w13_gate_plain(x, layer_pack(pk, 1), meta, act, so), n=3)
            record(f"w13_gate{sfx}", shape, err, err[0] == 0, ms, plain_ms, None,
                   bound(Mr * K + K // div * 2 * Fw + 2 * Fw * 16 + Mr * Fw,
                         int8_ops=2.0 * Mr * K * 2 * Fw))

    def rand_w4(N, layers, g):
        """a seeded random stacked W4 pack D -> N (the N-tail shapes)"""
        return {"wq": torch.randint(-128, 128, (layers, D // 2, N), generator=g, device=dev,
                                    dtype=torch.int8),
                "scale": torch.rand((layers, 1, N), generator=g, device=dev) * 1e-3 + 1e-4,
                "offset": torch.randint(0, 16, (layers, 1, N), generator=g, device=dev).float(),
                "colsum": torch.randn((layers, N), generator=g, device=dev) * 100.0,
                "bias": torch.randn((layers, N), generator=g, device=dev)}

    def w4a8_sweep(pk, layers, g, tag="", Ms=(9, 17, 65, 1024)):
        """Rows 1 / 2 above the decode path (the tile kernel; pk a list of
        head copies: the head, row 1) at the engine's other prompt lengths,
        against the plain version at rel 1e-5: M = 9, 17, 65 (ragged 64-row
        tiles, split K) checked, M = 1024 timed as well. A width N % 16 != 0
        must launch the 4-byte-copy edition (its count on the wrapper)."""
        head = isinstance(pk, list)
        p0 = pk[0] if head else layer_pack(pk, 1)
        K, N = p0["wq"].shape[0] * 2, p0["wq"].shape[1]
        wrap, xs, xo = (w4a8_matmul, 1.0, 128.0) if head else (w4a8_matmul_stacked, 0.02, 121.0)
        edge = N % 16 != 0
        for Mr in Ms:
            x = torch.randint(-128, 128, (Mr, K), generator=g, device=dev, dtype=torch.int8)

            def call(i, x=x):
                if head:
                    return w4a8_matmul(x, pk[i % len(pk)], xs, xo)
                return w4a8_matmul_stacked(x, pk, xs, xo, (1 + i) % layers)
            n_edge = wrap.edge_launches
            err = float_err(call(0), w4a8_matmul_plain(x, p0["wq"], p0["scale"], p0["offset"],
                                                       p0["colsum"], p0.get("bias"), xs, xo))
            ok = err[1] <= 1e-5 and wrap.edge_launches - n_edge == edge
            shape = f"{tag}M={Mr} {K}->{N}" + (" 4-byte edition" if edge else "")
            if Mr < 1024:
                check_row(wrap.__name__, shape, err, ok)
                continue
            ms = time_ms(call)
            plain_ms = time_ms(lambda i, x=x: w4a8_matmul_plain(
                x, p0["wq"], p0["scale"], p0["offset"], p0["colsum"], p0.get("bias"), xs, xo),
                n=3)
            lib_ms = None              # torch._int_mm takes widths N % 8 == 0 only
            if N % 8 == 0:
                wus = [qops.unpack_nibbles(pk[j]["wq"] if head else pk["wq"][j]).contiguous()
                       for j in range(cold_count(K * N, len(pk) if head else layers))]
                lib_ms = time_ms(lambda i, x=x: torch._int_mm(x, wus[i % len(wus)]))
                del wus
            record(wrap.__name__, shape, err, ok, ms, plain_ms, lib_ms,
                   bound(Mr * K + K // 2 * N + 4 * N * 4 + Mr * N * 4,
                         int8_ops=2.0 * Mr * K * N))

    def qkv_sweep(sfx, pk, ofq_r, outq_r, layers, c, exact, g, tag="", timed=True):
        """Row 3 at the engine's other prompt lengths, against its plain
        version at the tolerance of its M = 128 row: M = 9, 17, 65 (ragged
        64-row tiles, split K) checked, M = 1024 timed as well (timed)."""
        hd_, rot_ = c.head_dim_, c.rotary_dim
        K, Nq_ = c.hidden_size, pk["wq"].shape[2]
        div = 2 if pk["wq"].shape[1] * 2 == K else 1
        for Mr in (9, 17, 65, 1024):
            cos_, sin_ = MM.rope_cos_sin(torch.arange(Mr, device=dev)[None], c)
            cs_ = E._rope_cs_rows(cos_, sin_, hd_, rot_)
            x = torch.randint(-128, 128, (Mr, K), generator=g, device=dev, dtype=torch.int8)
            err = int8_err(qkv_rope(x, pk, ofq_r[1], outq_r[1], cs_, 0.02, 121.0, 1, hd_, rot_),
                           qkv_rope_plain(x, layer_pack(pk, 1), ofq_r[1], outq_r[1], cs_,
                                          0.02, 121.0, hd_, rot_))
            ok = err[0] == 0 if exact else err[0] <= 1 and err[1] <= 1e-3
            shape = f"{tag}M={Mr} {K}->{Nq_} hd {hd_} rot {rot_}"
            if Mr < 1024 or not timed:
                check_row(f"qkv_rope{sfx}", shape, err, ok)
                continue
            ms = time_ms(lambda i, x=x, cs_=cs_: qkv_rope(x, pk, ofq_r[i % layers],
                                                          outq_r[i % layers], cs_, 0.02, 121.0,
                                                          i % layers, hd_, rot_))
            plain_ms = time_ms(lambda i, x=x, cs_=cs_: qkv_rope_plain(
                x, layer_pack(pk, 1), ofq_r[1], outq_r[1], cs_, 0.02, 121.0, hd_, rot_), n=3)
            record(f"qkv_rope{sfx}", shape, err, ok, ms, plain_ms, None,
                   bound(Mr * K + K // div * Nq_ + 11 * Nq_ * 4 + Mr * 2 * hd_ * 4 + Mr * Nq_,
                         int8_ops=2.0 * Mr * K * Nq_))

    def attn_bound(nbytes, scores, hd):
        """Row 4's bound: Q·Kᵀ in int8, P·V in fp16 as two split terms, one
        exp a score."""
        return bound(nbytes, int8_ops=2.0 * scores * hd, fp16_ops=2 * 2.0 * scores * hd,
                     sfu_ops=scores)

    phase("phase 2: kernels vs plain versions")
    heads = [packed["head_q"]] + [{k: v.clone() for k, v in packed["head_q"].items()}
                                  for _ in range(2)]       # 3 copies > L2
    mm_cases = [("qkv", 1, ly["qkv_proj"]), ("o", 1, ly["o_proj"]),
                ("w13", 1, ly["w13_proj"]), ("w2", 1, ly["w2"]), ("head", 1, None),
                ("o", 128, ly["o_proj"]), ("w2", 128, ly["w2"]),
                # the staged serving route's qkv / o at B = 32 and 128, the head at 32
                ("qkv", SERVE_B, ly["qkv_proj"]), ("o", SERVE_B, ly["o_proj"]),
                ("head", SERVE_B, None), ("qkv", BIG_B, ly["qkv_proj"])]
    for tag, Mr, pk in mm_cases:
        if pk is None:              # the head: w4a8_matmul over 3 head copies
            K, N = D, heads[0]["wq"].shape[1]
            name, xs, xo = "w4a8_matmul", 1.0, 128.0
            call = lambda x, i: w4a8_matmul(x, heads[i % 3], xs, xo)       # noqa: E731
            lp = heads[0]
        else:                       # a projection: w4a8_matmul_stacked over the layers
            K, N = pk["wq"].shape[1] * 2, pk["wq"].shape[2]
            name, xs, xo = "w4a8_matmul_stacked", 0.02, 121.0
            call = lambda x, i, pk=pk: w4a8_matmul_stacked(x, pk, xs, xo, i % L)  # noqa: E731
            lp = layer_pack(pk, 0)
        x = torch.randint(-128, 128, (Mr, K), generator=gen, device=dev, dtype=torch.int8)
        out = call(x, 0)
        ref = w4a8_matmul_plain(x, lp["wq"], lp["scale"], lp["offset"], lp["colsum"],
                                lp.get("bias"), xs, xo)
        err = float_err(out, ref)
        ms = time_ms(lambda i: call(x, i))
        plain_ms = time_ms(lambda i: w4a8_matmul_plain(
            x, lp["wq"], lp["scale"], lp["offset"], lp["colsum"], None, xs, xo), n=5)
        # yardstick: torch._int_mm (cuBLAS int8) on pre-unpacked weights,
        # rotated over enough layers (head copies) to read past the L2; it
        # takes M > 16 only, so fewer rows run padded to 32 (as row 14's)
        wus = [qops.unpack_nibbles(heads[j]["wq"] if pk is None else pk["wq"][j]).contiguous()
               for j in range(cold_count(K * N, 3 if pk is None else L))]
        xp = x if Mr > 16 else torch.cat(
            [x, torch.zeros((32 - Mr, K), dtype=torch.int8, device=dev)])
        lib_ms = time_ms(lambda i: torch._int_mm(xp, wus[i % len(wus)]))
        del wus
        nbytes = Mr * K + K // 2 * N + 4 * N * 4 + Mr * N * 4
        record(name, f"M={Mr} {tag} {K}->{N}", err, err[1] <= 1e-5, ms,
               plain_ms, lib_ms, bound(nbytes, int8_ops=2.0 * Mr * K * N),
               note=None if Mr > 16 else "library: torch._int_mm on rows padded to 32",
               main=(Mr, tag) in ((1, "w13"), (1, "head")))

    # rows 1 / 2 at the tile kernel's other prompt lengths (o, w2, the head)
    # and at two widths off the 128-column grid (N % 16 = 4: the 4-byte-copy
    # edition; N % 128 = 16), on a generator of their own
    pgen = torch.Generator(device=dev).manual_seed(SEED + 21)
    w4a8_sweep(ly["o_proj"], L, pgen, "o ")
    w4a8_sweep(ly["w2"], L, pgen, "w2 ")
    w4a8_sweep(heads, 1, pgen, "head ")
    for Nt in (500, 1040):
        w4a8_sweep(rand_w4(Nt, 2, pgen), 2, pgen, "N-tail ", Ms=(9, 17, 65, 128, 1024))

    # qkv_rope at M = 128 (the main path's prefill)
    Mr = PROMPT_LEN
    pos = torch.arange(Mr, device=dev)[None]
    cos, sin = MM.rope_cos_sin(pos, cfg)
    cs = E._rope_cs_rows(cos, sin, hd, cfg.rotary_dim)
    ofq = E._qkv_ofq_rows(packed, policy)
    outq = E._qkv_outq_rows(packed["ranges"], cfg, L, dev)
    h8 = torch.randint(-128, 128, (Mr, D), generator=gen, device=dev, dtype=torch.int8)
    Nq = ly["qkv_proj"]["wq"].shape[2]
    out = qkv_rope(h8, ly["qkv_proj"], ofq[0], outq[0], cs, 0.02, 121.0, 0, hd, cfg.rotary_dim)
    ref = qkv_rope_plain(h8, layer_pack(ly["qkv_proj"], 0), ofq[0], outq[0], cs, 0.02,
                         121.0, hd, cfg.rotary_dim)
    err = int8_err(out, ref)
    ms = time_ms(lambda i: qkv_rope(h8, ly["qkv_proj"], ofq[i % L], outq[i % L], cs, 0.02,
                                    121.0, i % L, hd, cfg.rotary_dim))
    plain_ms = time_ms(lambda i: qkv_rope_plain(h8, layer_pack(ly["qkv_proj"], 0), ofq[0],
                                                outq[0], cs, 0.02, 121.0, hd,
                                                cfg.rotary_dim), n=5)
    nbytes = Mr * D + D // 2 * Nq + 11 * Nq * 4 + Mr * 2 * hd * 4 + Mr * Nq
    record("qkv_rope", f"M={Mr} {D}->{Nq}", err, err[0] <= 1 and err[1] <= 1e-3, ms,
           plain_ms, None, bound(nbytes, int8_ops=2.0 * Mr * D * Nq))

    qkv_sweep("", ly["qkv_proj"], ofq, outq, L, cfg, False, pgen)

    # w13_gate at M = 128
    lr0 = E.layer_ranges(packed["ranges"], 0)
    meta = E._mlp_block_meta(lr0, policy, cfg)
    so = E._mlp_block_site_on(policy)[1:5]
    out = w13_gate(h8, ly["w13_proj"], meta, 0, cfg.hidden_act, so)
    ref = w13_gate_plain(h8, layer_pack(ly["w13_proj"], 0), meta, cfg.hidden_act, so)
    err = int8_err(out, ref)
    ms = time_ms(lambda i: w13_gate(h8, ly["w13_proj"], meta, i % L, cfg.hidden_act, so))
    plain_ms = time_ms(lambda i: w13_gate_plain(h8, layer_pack(ly["w13_proj"], 0), meta,
                                                cfg.hidden_act, so), n=5)
    nbytes = Mr * D + D // 2 * 2 * F + 2 * F * 16 + Mr * F
    record("w13_gate", f"M={Mr} {D}->2x{F}", err, err[0] == 0, ms,
           plain_ms, None, bound(nbytes, int8_ops=2.0 * Mr * D * 2 * F))
    w13_gate_sweep("", ly["w13_proj"], meta, L, cfg.hidden_act, so, D, F, 2,
                   torch.Generator(device=dev).manual_seed(SEED + 20))

    # prefill attention: the main path's shape (T=128 into the S=1024 cache)
    # first, then T=S=128 and T=S=1024, relaxed and strict
    G = Hq // Hkv
    ameta = E._attn_meta(lr0, policy, cfg)
    for T, S, strict in ((128, MAX_SEQ, False), (128, 128, False), (128, 128, True),
                         (1024, 1024, False), (1024, 1024, True)):
        meta_a = list(ameta)
        if strict:   # the strict policy's 16-bit score and prob sites
            meta_a[6:9] = [80.0 / 65535, 32768.0, 65535.0]
            meta_a[9:12] = [1.0 / 65535, 0.0, 65535.0]
        q8 = torch.randint(-128, 128, (1, Hkv, G, T, hd), generator=gen, device=dev,
                           dtype=torch.int8)
        k8 = torch.randint(-128, 128, (1, Hkv, S, hd), generator=gen, device=dev,
                           dtype=torch.int8)
        v8 = torch.randint(-128, 128, (1, Hkv, S, hd), generator=gen, device=dev,
                           dtype=torch.int8)
        posi = torch.arange(T, device=dev, dtype=torch.int32)[None]
        valid = torch.full((1,), T, device=dev, dtype=torch.int32)
        out = prefill_attention(q8, k8, v8, meta_a, posi, valid, strict, strict)
        ref = prefill_attention_plain(q8, k8, v8, meta_a, posi, valid, strict, strict)
        err = float_err(out, ref)
        ms = time_ms(lambda i: prefill_attention(q8, k8, v8, meta_a, posi, valid,
                                                 strict, strict))
        plain_ms = time_ms(lambda i: prefill_attention_plain(q8, k8, v8, meta_a, posi,
                                                             valid, strict, strict), n=3)
        qd = q8.float().reshape(1, Hq, T, hd).to(torch.bfloat16)
        kd = k8[:, :, :T].float().repeat_interleave(G, 1).to(torch.bfloat16)
        vd = v8[:, :, :T].float().repeat_interleave(G, 1).to(torch.bfloat16)
        lib_ms = time_ms(lambda i: torch.nn.functional.scaled_dot_product_attention(
            qd, kd, vd, is_causal=True))
        vis = T * (T + 1) / 2                            # causal (row, col) pairs
        nbytes = Hq * T * hd + 2 * Hkv * T * hd + T * 4 + 4 + Hq * T * hd * 4
        # strict: the prob fake-quant has a 1/65535 step, and a probability one
        # ulp off a rounding boundary (exp, the denominator's summation order)
        # moves by a whole step, i.e. the output by step·|v − o_v|·s_v; the
        # 16-bit score fake-quant makes many probabilities of a row equal, so
        # such flips come in groups (10.5 steps measured at T=S=1024):
        # allow 32 steps
        pstep = meta_a[9] * (v8.float() - (meta_a[5] - 128.0)).abs().max().item() * meta_a[4]
        ok_att = err[0] <= 32 * pstep if strict else err[1] <= 1e-4
        record("prefill_attention",
               f"T={T} S={S} {'strict' if strict else 'relaxed'}", err, ok_att,
               ms, plain_ms, lib_ms, attn_bound(nbytes, Hq * vis, hd))
    # ragged shapes (checked, not timed; a generator of their own): B=2, T=100
    # (not a multiple of the query tile), positions from 37, valid 137 / 120,
    # both policies, at TinyLlama's grouping (G=8, 4 kv heads) and StableLM's
    # (G=1, 32)
    rgen = torch.Generator(device=dev).manual_seed(SEED + 9)
    for Gr, Hkr in ((G, Hkv), (1, 32)):
        for strict in (False, True):
            meta_a = list(ameta)
            if strict:
                meta_a[6:9] = [80.0 / 65535, 32768.0, 65535.0]
                meta_a[9:12] = [1.0 / 65535, 0.0, 65535.0]
            q8 = torch.randint(-128, 128, (2, Hkr, Gr, 100, hd), generator=rgen, device=dev,
                               dtype=torch.int8)
            k8 = torch.randint(-128, 128, (2, Hkr, MAX_SEQ, hd), generator=rgen, device=dev,
                               dtype=torch.int8)
            v8 = torch.randint(-128, 128, k8.shape, generator=rgen, device=dev, dtype=torch.int8)
            posi = (37 + torch.arange(100, device=dev, dtype=torch.int32))[None].repeat(2, 1)
            valid = torch.tensor([137, 120], device=dev, dtype=torch.int32)
            out = prefill_attention(q8, k8, v8, meta_a, posi, valid, strict, strict)
            ref = prefill_attention_plain(q8, k8, v8, meta_a, posi, valid, strict, strict)
            err = float_err(out, ref)
            pstep = meta_a[9] * (v8.float() - (meta_a[5] - 128.0)).abs().max().item() * meta_a[4]
            ok_att = err[0] <= 32 * pstep if strict else err[1] <= 1e-4
            print(f"  prefill_attention B=2 T=100 pos 37.. valid 137/120 G={Gr} "
                  f"{'strict' if strict else 'relaxed'}: err={err[0]:.3g} ({err[1]:.3g})"
                  f"{f', {err[0] / pstep:.2f} prob steps' if strict else ''}", flush=True)
            checks.append({"name": "prefill_attention", "shape": f"B=2 T=100 pos0 37 valid "
                           f"137/120 G={Gr} {'strict' if strict else 'relaxed'}",
                           "max_abs_err": err[0], "rel": err[1], "ok": bool(ok_att)})
            if not ok_att:
                failures.append(f"prefill_attention ragged G={Gr} strict={strict}: error {err}")
    del q8, k8, v8

    # whole MLP block (no single PyTorch call computes it: library "-"), at
    # the decode-sized row counts and the 32-token prompt's M = 32
    lr1 = E.layer_ranges(packed["ranges"], 1)
    bmeta = E._mlp_block_meta(lr1, policy, cfg)
    bso = E._mlp_block_site_on(policy)
    mn, w13p, w2p = ly["mlp_norm"], ly["w13_proj"], ly["w2"]
    mlp_w = D // 2 * 2 * F + F // 2 * D                 # packed weight bytes
    mlp_vec = (2 * F + D) * 4 * 4 + 2 * D * 4 + 32 * 4  # aux rows, norm, meta

    def mlp_plain(x):
        return fused_mlp_block_w4_plain(x, mn["w"][1], mn["b"][1], layer_pack(w13p, 1),
                                        layer_pack(w2p, 1), bmeta, cfg.hidden_act, bso)

    def mlp_bound(Mr):
        return bound(2 * Mr * D * 4 + mlp_w + mlp_vec, int8_ops=2.0 * Mr * (D * 2 * F + F * D))

    for Mr in (1, 8, SHORT_PROMPT, 64, BIG_B):
        x = torch.randn((Mr, D), generator=gen, device=dev)
        out = fused_mlp_block_w4(x, mn["w"], mn["b"], w13p, w2p, bmeta, 1, cfg.hidden_act, bso)
        err = float_err(out, mlp_plain(x))
        ms = time_ms(lambda i, x=x: fused_mlp_block_w4(x, mn["w"], mn["b"], w13p, w2p, bmeta,
                                                       i % L, cfg.hidden_act, bso))
        plain_ms = time_ms(lambda i, x=x: mlp_plain(x), n=5)
        record("fused_mlp_block_w4", f"M={Mr} {D}->2x{F}->{D}", err, err[1] <= 2e-3, ms,
               plain_ms, None, mlp_bound(Mr), main=Mr == SHORT_PROMPT)
    # the wrapper's fork at mlp_block.DP4A_ROWS: both MLP-block kernels at
    # M = 1..8 (on inputs of their own, so that the later phases' inputs do
    # not depend on this comparison)
    def mlp_entry(kname, x, layer):
        if kname == "row":
            code, out, _ = mlp_tiles(MLP_BLOCK, x, w13p, w2p, bmeta, layer, cfg.hidden_act,
                                     mn["w"], mn["b"])
        else:
            keep = []
            a, out = mlp_args(x, mn["w"], mn["b"], w13p, w2p, bmeta, layer, cfg.hidden_act,
                              keep)
            code = _build.lib().mqt_fused_mlp_block(ctypes.addressof(a), _build.stream_ptr(dev))
        _build.check(code, f"fused_mlp_block_w4 {kname} kernel")
        return out

    fgen = torch.Generator(device=dev).manual_seed(SEED + 1)
    for Mr in (1, 2, 4, 8):
        x = torch.randn((Mr, D), generator=fgen, device=dev)
        ref = mlp_plain(x)
        plain_ms = time_ms(lambda i, x=x: mlp_plain(x), n=5)
        for kname in ("dp4a", "row"):
            err = float_err(mlp_entry(kname, x, 1), ref)
            ms = time_ms(lambda i, x=x, kname=kname: mlp_entry(kname, x, i % L))
            took = (Mr <= DP4A_ROWS) == (kname == "dp4a")
            record("fused_mlp_block_w4", f"M={Mr} {kname} kernel{' (wrapper)' if took else ''}",
                   err, err[1] <= 2e-3, ms, plain_ms, None, mlp_bound(Mr))

    # one row tile past 16 and 64 rows (checked), and the row kernel's walk
    # over eight 128-row steps (timed; the wrapper takes at most 128 rows, so
    # the walk is launched through the kernel's entry), on inputs of their own
    rgen = torch.Generator(device=dev).manual_seed(SEED + 3)
    for Mr in (17, 65, 1024):
        x = torch.randn((Mr, D), generator=rgen, device=dev)
        err = float_err(mlp_entry("row", x, 1), mlp_plain(x))
        if Mr < 1024:
            check_row("fused_mlp_block_w4", f"M={Mr} {D}->2x{F}->{D}", err, err[1] <= 2e-3)
            continue
        ms = time_ms(lambda i, x=x: mlp_entry("row", x, i % L))
        plain_ms = time_ms(lambda i, x=x: mlp_plain(x), n=3)
        record("fused_mlp_block_w4", f"M={Mr} {D}->2x{F}->{D} row kernel", err, err[1] <= 2e-3,
               ms, plain_ms, None, mlp_bound(Mr))

    # whole-layer (B=1) and whole-model (B=1, 8) decode kernels against their
    # plain versions, over a random full-length cache with positions near
    # POS0; the plain versions read their metas back to the host, so they are
    # timed with events over back-to-back calls, the kernels from CUDA graphs
    kp = E._kernel_prep(packed, policy, cfg)
    fkw = dict(num_q_heads=Hq, num_kv_heads=Hkv, head_dim=hd, rotary_dim=cfg.rotary_dim,
               act_kind=cfg.hidden_act)
    Nq, Ko, Vp = ly["qkv_proj"]["wq"].shape[2], Hq * hd, packed["head_q"]["wq"].shape[1]
    layer_w = D // 2 * Nq + Ko // 2 * D + mlp_w
    layer_vec = (Nq * 4 + D * 4 + 2 * F * 4 + D * 4) * 4 + 4 * D * 4 + Nq * 16 + 65 * 4
    head_bytes = D // 2 * Vp + 2 * Vp * 4 + 2 * D * 4
    for Bm in (1, 8):
        kc = torch.randint(-128, 128, (L, Bm, Hkv, MAX_SEQ, hd), generator=gen, device=dev,
                           dtype=torch.int8)
        vc = torch.randint(-128, 128, (L, Bm, Hkv, MAX_SEQ, hd), generator=gen, device=dev,
                           dtype=torch.int8)
        posb = torch.tensor([POS0 - 3 * b for b in range(Bm)], dtype=torch.int32, device=dev)
        cos, sin = MM.rope_cos_sin(posb[:, None], cfg)
        csb = E._rope_cs_rows(cos, sin, hd, cfg.rotary_dim).reshape(Bm, 2, hd)
        x = torch.randn((Bm, D), generator=gen, device=dev)
        fargs = (x, posb, csb, kp["ofq"], ly["attn_norm"], ly["qkv_proj"], ly["o_proj"],
                 ly["mlp_norm"], w13p, w2p, kc, vc, kp["meta"])
        valid = int(posb.sum())                          # cache rows read per layer
        att_ops = 2.0 * Hq * hd * valid                  # QK (int8) and PV (fp32) each
        # read or written once a step: x in and out, the RoPE rows, pos
        step_io = 2 * Bm * D * 4 + Bm * 2 * hd * 4 + Bm * 4
        out = fused_model_w4(*fargs, packed["head_q"], packed["norm"], **fkw)
        ref = fused_model_w4_plain(*fargs, packed["head_q"], packed["norm"], **fkw)
        e_x, e_lg, e_kv = float_err(out[0], ref[0]), float_err(out[2], ref[2]), int8_err(out[1], ref[1])
        ok = e_x[1] <= 2e-3 and e_lg[1] <= 2e-3 and e_kv[0] == 0
        ms = time_ms(lambda i: fused_model_w4(*fargs, packed["head_q"], packed["norm"], **fkw),
                     n=10)
        plain_ms = event_ms(lambda: fused_model_w4_plain(*fargs, packed["head_q"],
                                                         packed["norm"], **fkw), n=2)
        nbytes = (L * (layer_w + layer_vec + valid * Hkv * hd * 2 + Bm * 2 * Hkv * hd)
                  + step_io + head_bytes + Bm * Vp * 4)
        ops_i8 = L * (2.0 * Bm * (D * Nq + Ko * D + D * 2 * F + F * D) + att_ops) \
            + 2.0 * Bm * D * Vp
        record("fused_model_w4", f"B={Bm} L={L} S={MAX_SEQ} pos<={POS0} +head",
               (max(e_x[0], e_lg[0]), max(e_x[1], e_lg[1])), ok, ms, plain_ms, None,
               bound(nbytes, int8_ops=ops_i8, fp32_ops=L * att_ops),
               note=f"kv_new max diff {e_kv[0]} on {e_kv[1]:.3g} of bytes; "
                    f"plain timed with events")
        if Bm == 1:
            # inside the step: mean stage times over the layers, from the
            # kernel's global-timer trace (every stage then ends in a barrier)
            tr = torch.zeros(2 + 5 * L, dtype=torch.int64, device=dev)
            for _ in range(2):
                fused_model_w4(*fargs, packed["head_q"], packed["norm"], trace=tr, **fkw)
            torch.cuda.synchronize()
            dt = (tr[1:] - tr[:-1]).double().cpu() / 1e3
            per = dt[:5 * L].reshape(L, 5).mean(0).tolist()
            stage_us = dict(zip(("qkv", "attention", "o_proj", "w13_gate", "w2"), per))
            stage_us["head"] = float(dt[5 * L])
            stage_us["step_traced"] = float(dt.sum())
            print("  fused_model_w4 B=1 stage us (mean per layer): "
                  + ", ".join(f"{k} {v:.2f}" for k, v in stage_us.items()), flush=True)
            print(parent_stages("W4"), flush=True)
            out = fused_layer_w4(*fargs, 1, **fkw)
            ref = fused_layer_w4_plain(*fargs, 1, **fkw)
            e_x, e_kv = float_err(out[0], ref[0]), int8_err(out[1], ref[1])
            ok = e_x[1] <= 2e-3 and e_kv[0] == 0
            ms = time_ms(lambda i: fused_layer_w4(*fargs, i % L, **fkw))
            plain_ms = event_ms(lambda: fused_layer_w4_plain(*fargs, 1, **fkw), n=3)
            record("fused_layer_w4", f"B=1 S={MAX_SEQ} pos={POS0}", e_x, ok, ms, plain_ms, None,
                   bound(layer_w + layer_vec + valid * Hkv * hd * 2 + Bm * 2 * Hkv * hd + step_io,
                         int8_ops=2.0 * (D * Nq + Ko * D + D * 2 * F + F * D) + att_ops,
                         fp32_ops=att_ops),
                   note=f"kv_new max diff {e_kv[0]} on {e_kv[1]:.3g} of bytes; "
                        f"plain timed with events")
        del kc, vc

    # staged_append at B=32 with 32 staged columns: the chunk kernel's kv_new
    # halves as pending rows (views); yardstick: the two PyTorch column copies
    sk = torch.randint(-128, 128, (L, SERVE_B, Hkv, CHUNK_COLS, hd), generator=gen,
                       device=dev, dtype=torch.int8)
    sv = torch.randint(-128, 128, sk.shape, generator=gen, device=dev, dtype=torch.int8)
    kvp = torch.randint(-128, 128, (L, SERVE_B, 2 * Hkv, hd), generator=gen, device=dev,
                        dtype=torch.int8)
    pk, pv = kvp[:, :, :Hkv, None], kvp[:, :, Hkv:, None]
    for m in (0, 7, CHUNK_COLS - 1):
        ak, av = staged_append(sk.clone(), sv.clone(), pk, pv, m)
        rk, rv = staged_append_plain(sk.clone(), sv.clone(), pk, pv, m)
        ek, ev = int8_err(ak, rk), int8_err(av, rv)
        err = (max(ek[0], ev[0]), max(ek[1], ev[1]))
        ms = time_ms(lambda i, m=m: staged_append(ak, av, pk, pv, m), n=50)
        plain_ms = time_ms(lambda i, m=m: staged_append_plain(ak, av, pk, pv, m), n=50)
        lib_ms = time_ms(lambda i, m=m: (ak[:, :, :, m].copy_(pk[:, :, :, 0]),
                                         av[:, :, :, m].copy_(pv[:, :, :, 0])), n=50)
        record("staged_append", f"B={SERVE_B} cs={CHUNK_COLS} m={m}", err, err[0] == 0, ms,
               plain_ms, lib_ms, bound(4 * L * SERVE_B * Hkv * hd), main=m == 7,
               note="library: two Tensor.copy_ calls (K, V)")
    del sk, sv, kvp
    # the floor of one launch, with the same timer: a 16-byte Tensor.zero_;
    # beside it a 16-byte Tensor.copy_, a launch that reads its input first
    z16, y16 = torch.zeros((2, 4), dtype=torch.int32, device=dev)
    launch_floor_ms = time_ms(lambda i: z16.zero_(), n=50)
    copy_floor_ms = time_ms(lambda i: z16.copy_(y16), n=50)
    print(f"  launch floor: one 16-byte Tensor.zero_ {launch_floor_ms:.4f} ms, one 16-byte "
          f"Tensor.copy_ {copy_floor_ms:.4f} ms; staged_append m=7 "
          f"{next(r for r in rows['staged_append'] if r['main'])['ms']:.4f} ms", flush=True)

    # o-tail (o-proj + resid_add_1 + the MLP block) at M = 32 and 128
    omet = bmeta + E._otail_meta_ext(lr1, policy)
    oso = E._otail_site_on(policy)
    op = ly["o_proj"]
    o_w = Ko // 2 * D + D * 4 * 4
    for Mr in (SERVE_B, BIG_B):
        x = torch.randn((Mr, D), generator=gen, device=dev)
        a8 = torch.randint(-128, 128, (Mr, Ko), generator=gen, device=dev, dtype=torch.int8)
        out = fused_otail_block_w4(a8, x, op, mn["w"], mn["b"], w13p, w2p, omet, 1,
                                   cfg.hidden_act, bso, oso)
        plain = lambda i, x=x, a8=a8: fused_otail_block_w4_plain(    # noqa: E731
            a8, x, layer_pack(op, 1), mn["w"][1], mn["b"][1], layer_pack(w13p, 1),
            layer_pack(w2p, 1), omet, cfg.hidden_act, bso, oso)
        err = float_err(out, plain(0))
        ms = time_ms(lambda i, x=x, a8=a8: fused_otail_block_w4(
            a8, x, op, mn["w"], mn["b"], w13p, w2p, omet, i % L, cfg.hidden_act, bso, oso))
        plain_ms = time_ms(plain, n=5)
        record("fused_otail_block_w4", f"M={Mr} {Ko}->{D} + MLP block", err, err[1] <= 2e-3,
               ms, plain_ms, None,
               bound(Mr * Ko + 2 * Mr * D * 4 + o_w + mlp_w + mlp_vec,
                     int8_ops=2.0 * Mr * (Ko * D + D * 2 * F + F * D)),
               main=Mr == SERVE_B)

    # the chunk kernel (a whole staged step, 22 layers + the W4 head) against
    # its plain version: B=16 at staggered chunk starts, B=32 and B=128 at
    # POS0; m staged columns valid of CHUNK_COLS; relaxed and strict policies
    chunk_stage_us = {}
    for Bc, stag in ((16, True), (SERVE_B, False), (BIG_B, False)):
        kc = torch.randint(-128, 128, (L, Bc, Hkv, MAX_SEQ, hd), generator=gen, device=dev,
                           dtype=torch.int8)
        vc = torch.randint(-128, 128, kc.shape, generator=gen, device=dev, dtype=torch.int8)
        skc = torch.randint(-128, 128, (L, Bc, Hkv, CHUNK_COLS, hd), generator=gen,
                            device=dev, dtype=torch.int8)
        svc = torch.randint(-128, 128, skc.shape, generator=gen, device=dev, dtype=torch.int8)
        kcs = E.kv_colsums(kc)
        pos0 = torch.tensor([POS0 - (3 * b if stag else 0) for b in range(Bc)],
                            dtype=torch.int32, device=dev)
        x = torch.randn((Bc, D), generator=gen, device=dev)
        valid = int(pos0.sum())                          # cache rows read per layer
        for mst in (0, STAGED_M):
            cos, sin = MM.rope_cos_sin((pos0 + mst)[:, None], cfg)
            csb = E._rope_cs_rows(cos, sin, hd, cfg.rotary_dim).reshape(Bc, 2, hd)
            rows_kv = valid + Bc * mst                   # cache rows + staged columns
            att_ops = 2.0 * Hq * hd * (rows_kv + Bc)     # QK (int8) and PV (fp32) each
            # per layer: weights and vectors, the valid K/V rows, their K
            # column sums, kv_new; once a step: x in and out, the RoPE rows,
            # pos, the head and the logits
            nbytes = (L * (layer_w + layer_vec + rows_kv * Hkv * hd * 2 + valid * Hkv * 4
                           + Bc * 2 * Hkv * hd)
                      + 2 * Bc * D * 4 + Bc * 2 * hd * 4 + Bc * 4 + head_bytes + Bc * Vp * 4)
            ops_i8 = L * (2.0 * Bc * (D * Nq + Ko * D + D * 2 * F + F * D) + att_ops) \
                + 2.0 * Bc * D * Vp
            for strict in (False, True):
                pol_c = strict_policy if strict else policy
                kpc = E._kernel_prep(packed, pol_c, cfg)
                cargs = (x, pos0, csb, kpc["ofq"], ly["attn_norm"], ly["qkv_proj"], op,
                         ly["mlp_norm"], w13p, w2p, kc, vc, kcs, skc, svc, mst, kpc["meta"],
                         packed["head_q"], packed["norm"])
                ckw = dict(fkw, qk_fq_on=strict, pv_fq_on=strict)
                out = fused_model_w4_chunk(*cargs, **ckw)
                ref = fused_model_w4_chunk_plain(*cargs, **ckw)
                e_x, e_lg = float_err(out[0], ref[0]), float_err(out[2], ref[2])
                e_kv = int8_err(out[1], ref[1])
                ok = e_x[1] <= 2e-3 and e_lg[1] <= 2e-3 and e_kv[0] == 0
                ms = time_ms(lambda i: fused_model_w4_chunk(*cargs, **ckw), n=5)
                plain_ms = event_ms(lambda: fused_model_w4_chunk_plain(*cargs, **ckw), n=2)
                record("fused_model_w4_chunk",
                       f"B={Bc} pos0{'<=' if stag else '='}{POS0} m={mst} "
                       f"{'strict' if strict else 'relaxed'} +head",
                       (max(e_x[0], e_lg[0]), max(e_x[1], e_lg[1])), ok, ms, plain_ms, None,
                       bound(nbytes, int8_ops=ops_i8, fp32_ops=L * att_ops),
                       note=f"kv_new max diff {e_kv[0]} on {e_kv[1]:.3g} of bytes; "
                            f"plain timed with events",
                       main=(Bc, mst, strict) == (SERVE_B, STAGED_M, False))
                if mst == STAGED_M and not strict and Bc in (SERVE_B, BIG_B):
                    # per-stage times from the kernel's global-timer trace
                    chunk_stage_us[f"B={Bc}"] = chunk_stages(
                        lambda tr: fused_model_w4_chunk(*cargs, trace=tr, **ckw), L, dev,
                        f"fused_model_w4_chunk B={Bc} m={mst}", f"W4 B={Bc}")
        del kc, vc, skc, svc, kcs

    # ---- the int4-cache pack and the phases' own inputs ---------------------
    # (a generator of their own: the earlier checks' inputs stay as they were)
    kgen = torch.Generator(device=dev).manual_seed(SEED + 2)
    packed4, _, strict4, ecfg4 = build_synthetic_packed(
        "tinyllama-1.1b", w_bits=4, head_bits=4, max_seq_len=MAX_SEQ, seed=SEED, device=dev,
        kv_bits=4)
    policy4 = relax_16bit(strict4)
    lr4 = E.layer_ranges(packed4["ranges"], 0)

    def sdpa_ms(Bq, valid):
        """SDPA on dequantized bf16 over `valid` rows, GQA by expanding the kv
        heads (the library yardstick of the decode attention kernels)."""
        qd = torch.randn((Bq, Hq, 1, hd), generator=kgen, device=dev).to(torch.bfloat16)
        kd = torch.randn((Bq, Hkv, 1, valid, hd), generator=kgen, device=dev).to(torch.bfloat16)
        kd = kd.expand(Bq, Hkv, G, valid, hd).reshape(Bq, Hq, valid, hd)
        vd = kd.clone()
        return time_ms(lambda i: torch.nn.functional.scaled_dot_product_attention(qd, kd, vd))

    # kv4 decode attention over the packed cache (S/2 = 512 columns a plane):
    # B = 1, 32, 128 at pos0 POS0 and B=32 at staggered chunk starts 480..573
    # (the high plane); m staged columns valid of CHUNK_COLS; both policies.
    # Each (sequence, kv head) is one cluster of `ncl` blocks (the wrapper's
    # choice from the shapes), printed per shape; B=1 at pos 3 with m=0
    # (most stripes of the cluster empty) is checked, not timed
    S2 = MAX_SEQ // 2
    sms = _build.sm_count(dev)
    for Bk, stag in ((1, False), (SERVE_B, False), (BIG_B, False), (SERVE_B, True), (1, None)):
        BH = Bk * Hkv
        kp4 = torch.randint(-128, 128, (L, BH, hd, S2), generator=kgen, device=dev,
                            dtype=torch.int8)
        vp4 = torch.randint(-128, 128, kp4.shape, generator=kgen, device=dev, dtype=torch.int8)
        kcs4 = qops.kv_colsums_packed(kp4)
        sk4, sv4 = (torch.randint(-128, -112, (L, BH, CHUNK_COLS, hd), generator=kgen,
                                  device=dev, dtype=torch.int8) for _ in "kv")
        kn4, vn4 = (torch.randint(-128, -112, (BH, hd), generator=kgen, device=dev,
                                  dtype=torch.int8) for _ in "kv")
        q84 = torch.randint(-128, 128, (BH, G, hd), generator=kgen, device=dev,
                            dtype=torch.int8)
        pos4 = torch.tensor([3 if stag is None else 480 + 3 * b if stag else POS0
                             for b in range(Bk)], dtype=torch.int32, device=dev)
        ncl = kv4_cluster_size(Bk, Hkv, S2, CHUNK_COLS, sms, G, hd)
        print(f"  kv4_decode_attention B={Bk}: a cluster of {ncl} blocks a (sequence, kv head)",
              flush=True)
        for mst in ((0,) if stag is None else (0, STAGED_M)):
            # columns read: each packed column below pos holds a low and,
            # past S/2, a high position; its K column sums; the staged rows
            lo = sum(min(int(p), S2) for p in pos4.tolist())
            hi = sum(max(int(p) - S2, 0) for p in pos4.tolist())
            nbytes = (BH * G * hd + Hkv * (2 * hd * lo + 4 * (lo + hi)
                                           + 2 * Bk * mst * hd + 2 * Bk * hd)
                      + Bk * 4 + BH * G * hd * 4)
            cols = Hkv * (lo + hi + Bk * (mst + 1))
            lib_ms = sdpa_ms(Bk, int(pos4.max()) + mst + 1) if stag is not None else None
            for strict in (False, True):
                meta4 = E._attn_meta(lr4, strict4 if strict else policy4, cfg)

                def args4(l):
                    return (q84, kp4, vp4, kcs4, sk4, sv4, kn4, vn4, meta4, pos4, mst, l)
                out = kv4_decode_attention(*args4(1), qk_fq_on=strict, pv_fq_on=strict)
                ref = kv4_decode_attention_plain(*args4(1), qk_fq_on=strict, pv_fq_on=strict)
                err = float_err(out, ref)
                if stag is None:
                    shape = (f"B=1 pos0=3 m=0 ncl={ncl} {'strict' if strict else 'relaxed'}")
                    checks.append({"name": "kv4_decode_attention", "shape": shape,
                                   "max_abs_err": err[0], "rel": err[1]})
                    print(f"  kv4_decode_attention {shape} (checked) err={err[0]:.3g}", flush=True)
                    if err[0] != 0 or not bool(torch.isfinite(out).all()):
                        failures.append(f"kv4_decode_attention {shape}: error {err}")
                    continue
                ms = time_ms(lambda i: kv4_decode_attention(*args4(i % L), qk_fq_on=strict,
                                                            pv_fq_on=strict))
                plain_ms = time_ms(lambda i: kv4_decode_attention_plain(
                    *args4(1), qk_fq_on=strict, pv_fq_on=strict), n=3)
                record("kv4_decode_attention",
                       f"B={Bk} pos0{'=480+3b' if stag else '=' + str(POS0)} m={mst} "
                       f"{'strict' if strict else 'relaxed'}", err, err[0] == 0, ms, plain_ms,
                       lib_ms, bound(nbytes, int8_ops=2.0 * G * hd * cols,
                                     fp64_ops=2.0 * G * hd * cols, sfu_ops=G * cols),
                       note="library: SDPA bf16 over the valid rows, kv heads expanded",
                       main=(Bk, stag, mst, strict) == (SERVE_B, False, STAGED_M, False))
                rows["kv4_decode_attention"][-1]["cluster"] = ncl
        del kp4, vp4, kcs4, sk4, sv4

    # int8 decode attention (the attn() route's T = 1 kernel): 193 valid rows
    # of an S = 1024 cache, layers rotated while timing; a cluster of `ncl`
    # blocks a (sequence, kv head), printed per shape; B=1 with 5 valid rows
    # (most stripes of the cluster empty) checked, not timed
    DA_VALID = POS0 + 1
    for Bd, strict, nval in ((1, False, DA_VALID), (SERVE_B, False, DA_VALID),
                             (SERVE_B, True, DA_VALID), (1, False, 5), (1, True, 5)):
        kcd = torch.randint(-128, 128, (L, Bd, Hkv, MAX_SEQ, hd), generator=kgen, device=dev,
                            dtype=torch.int8)
        vcd = torch.randint(-128, 128, kcd.shape, generator=kgen, device=dev, dtype=torch.int8)
        q8d = torch.randint(-128, 128, (Bd, Hkv, G, hd), generator=kgen, device=dev,
                            dtype=torch.int8)
        vld = torch.full((Bd,), nval, dtype=torch.int32, device=dev)
        meta_d = E._attn_meta(lr0, strict_policy if strict else policy, cfg)
        ncl = cluster_size(Bd, Hkv, MAX_SEQ, sms, G, hd)
        out = decode_attention(q8d, kcd[1], vcd[1], meta_d, vld)
        err = float_err(out, decode_attention_plain(q8d, kcd[1], vcd[1], meta_d, vld))
        pol = "strict" if strict else "relaxed"
        if nval != DA_VALID:
            shape = f"B={Bd} S={MAX_SEQ} valid={nval} ncl={ncl} {pol}"
            checks.append({"name": "decode_attention", "shape": shape, "max_abs_err": err[0],
                           "rel": err[1]})
            print(f"  decode_attention {shape} (checked) err={err[0]:.3g}", flush=True)
            if err[0] != 0 or not bool(torch.isfinite(out).all()):
                failures.append(f"decode_attention {shape}: error {err}")
            del kcd, vcd
            continue
        print(f"  decode_attention B={Bd} {pol}: a cluster of {ncl} blocks a (sequence, kv head)",
              flush=True)
        ms = time_ms(lambda i: decode_attention(q8d, kcd[i % L], vcd[i % L], meta_d, vld))
        plain_ms = time_ms(lambda i: decode_attention_plain(q8d, kcd[1], vcd[1], meta_d, vld),
                           n=3)
        rows_d = Bd * Hkv * DA_VALID
        record("decode_attention", f"B={Bd} S={MAX_SEQ} valid={DA_VALID} "
               f"{'strict' if strict else 'relaxed'}", err, err[0] == 0, ms, plain_ms,
               sdpa_ms(Bd, DA_VALID),
               bound(Bd * Hq * hd + 2 * rows_d * hd + Bd * 4 + Bd * Hq * hd * 4,
                     int8_ops=2.0 * G * hd * rows_d, fp64_ops=2.0 * G * hd * rows_d,
                     sfu_ops=G * rows_d),
               note="library: SDPA bf16 over the valid rows, kv heads expanded",
               main=(Bd, strict) == (1, False))
        rows["decode_attention"][-1]["cluster"] = ncl
        del kcd, vcd

    # ---- phase 3: the main path --------------------------------------------
    phase("phase 3: generate_fast, TinyLlama-1.1B W4A8/h4, int8 KV, relaxed")
    g = Generator(packed, cfg, policy, ecfg, device=dev)
    prompt = torch.randint(0, cfg.vocab_size, (1, PROMPT_LEN), generator=gen,
                           device=dev).cpu().numpy()
    g.generate_fast(prompt, 4)                           # warm-up (allocator, clocks)
    runs = {}                                            # route -> launch counts
    route_s = {}                                         # route -> seconds of its call

    def counted(route, fn):
        """fn() with every kernel's counts from 0; the launches are kept under
        `route`, the call's seconds (to the card's last kernel) under
        route_s[route]. On the card no wrapper may run its plain version."""
        ops.reset_counts()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        route_s[route] = time.perf_counter() - t0
        runs[route] = ops.counts()
        plain = {k: v for k, v in ops.counts("plain_calls").items() if v}
        if plain:
            failures.append(f"{route}: plain versions ran on the card {plain}")
        return out

    toks, stats = counted("main", lambda: g.generate_fast(prompt, NEW_TOKENS,
                                                          return_stats=True))
    launches = runs["main"]
    print(f"  tokens {toks.shape} prefill {stats['prefill_s'] * 1e3:.2f} ms "
          f"decode {stats['decode_tok_s']:.2f} tok/s launches {launches}", flush=True)
    if toks.shape != (1, NEW_TOKENS) or toks.min() < 0 or toks.max() >= cfg.vocab_size:
        failures.append(f"bad tokens {toks.shape}")
    # one whole-model launch per decode token; the W4A8 kernel only in the
    # prefill (o and w2 per layer, the head)
    if launches["fused_model_w4"] != NEW_TOKENS - 1:
        failures.append(f"fused_model_w4 launched {launches['fused_model_w4']} times "
                        f"for {NEW_TOKENS - 1} decode tokens")
    if launches["w4a8_matmul_stacked"] != 2 * L or launches["w4a8_matmul"] != 1:
        failures.append(f"W4A8 launches {launches['w4a8_matmul_stacked']} (o, w2) and "
                        f"{launches['w4a8_matmul']} (head), expected {2 * L} and 1 "
                        f"(prefill only)")

    # the short-prompt route: the prefill's MLP blocks run the whole-block kernel
    short = prompt[:, :SHORT_PROMPT]
    toks_s, stats_s = counted("short_prompt", lambda: g.generate_fast(
        short, 8, return_stats=True))
    print(f"  {SHORT_PROMPT}-token prompt: prefill {stats_s['prefill_s'] * 1e3:.2f} ms, "
          f"launches {runs['short_prompt']}", flush=True)
    if runs["short_prompt"]["fused_mlp_block_w4"] != L or runs["short_prompt"]["w13_gate"]:
        failures.append(f"short prompt: MLP-block launches {runs['short_prompt']}")

    # the per-layer route: KernelConfig.decode_per_layer(), one whole-layer
    # launch per layer and decode step
    gpl = Generator(packed, cfg, policy,
                    dataclasses.replace(ecfg, use_pallas=KernelConfig.decode_per_layer()),
                    device=dev)
    gpl.generate_fast(prompt, 2)
    toks_pl, stats_pl = counted("per_layer", lambda: gpl.generate_fast(
        prompt, PER_LAYER_STEPS + 1, return_stats=True))
    same = bool((toks_pl == toks[:, :PER_LAYER_STEPS + 1]).all())
    print(f"  decode_per_layer: {stats_pl['decode_tok_s']:.2f} tok/s, launches "
          f"{runs['per_layer']}, greedy tokens equal to the main run's: {same}", flush=True)
    if runs["per_layer"]["fused_layer_w4"] != PER_LAYER_STEPS * L:
        failures.append(f"per-layer route: launches {runs['per_layer']}")

    # where the time goes: device time of one prefill and of 8 decode steps
    # (torch.profiler), against the wall times of the generate_fast run above
    tp = torch.as_tensor(prompt, device=dev)
    pcache = E.init_kv_cache(ecfg, 1, device=dev)
    pre_dev, pre_top, pre_n = device_profile(lambda: g.prefill(tp, pcache))
    start = torch.full((1,), PROMPT_LEN, dtype=torch.int32, device=dev)
    tok0 = torch.zeros((1, 1), dtype=torch.long, device=dev)
    dec_dev, dec_top, dec_n = device_profile(lambda: E.decode_loop(
        g.packed, tok0, pcache, start, 8, cfg, policy, g.ecfg.use_pallas))
    pl_dev, pl_top, pl_n = device_profile(lambda: E.decode_loop(
        g.packed, tok0, pcache, start, 8, cfg, policy, KernelConfig.decode_per_layer()))
    step_ms = 1e3 / stats["decode_tok_s"]
    pl_step_ms = 1e3 / stats_pl["decode_tok_s"]
    pre_ms = stats["prefill_s"] * 1e3
    breakdown = {"prefill_wall_ms": pre_ms, "prefill_device_ms": pre_dev,
                 "prefill_idle_share": 1.0 - pre_dev / pre_ms,
                 "prefill_top_kernels": pre_top, "prefill_kernel_launches": pre_n,
                 "decode_step_wall_ms": step_ms, "decode_step_device_ms": dec_dev / 8,
                 "decode_idle_share": 1.0 - dec_dev / 8 / step_ms,
                 "decode_top_kernels": [(k, ms / 8, n / 8) for k, ms, n in dec_top],
                 "decode_kernel_launches_per_step": dec_n / 8,
                 "per_layer_step_wall_ms": pl_step_ms,
                 "per_layer_step_device_ms": pl_dev / 8,
                 "per_layer_idle_share": 1.0 - pl_dev / 8 / pl_step_ms,
                 "per_layer_top_kernels": [(k, ms / 8, n / 8) for k, ms, n in pl_top],
                 "per_layer_kernel_launches_per_step": pl_n / 8}
    print(f"  prefill: wall {pre_ms:.3f} ms, device {pre_dev:.3f} ms; decode step: wall "
          f"{step_ms:.3f} ms, device {dec_dev / 8:.3f} ms, {dec_n / 8:.1f} launches; "
          f"per-layer route step: wall {pl_step_ms:.3f} ms, device {pl_dev / 8:.3f} ms, "
          f"{pl_n / 8:.1f} launches", flush=True)
    for tag, top in (("decode", dec_top), ("per-layer", pl_top)):
        for k, ms, n in top:
            print(f"    {tag}/step {ms / 8:8.4f} ms  x{n / 8:5.1f}  {k}", flush=True)

    # kernel path vs plain path on the card: prefill logits, then one decode
    # step; and the witness: the plain prefill, then the decode() step with the
    # whole-model kernel's plain version on the plain engine's attention and
    # fp32 norms (engine_numerics), which must give the plain path's step bit
    # for bit (the step's wiring is the engine's)
    t = torch.as_tensor(prompt, device=dev)
    res = {}
    b1_witness = {(E, "fused_model_w4"): fused_model_w4_plain,
                  **engine_numerics(E, cfg, policy)}
    for tag, kc_p, kc_d in (("kernel", KernelConfig.prefill(), KernelConfig.decode()),
                            ("plain", KernelConfig.none(), KernelConfig.none()),
                            ("witness", KernelConfig.none(), KernelConfig.decode())):
        cache = E.init_kv_cache(ecfg, 1, device=dev)
        lg, cache = E.forward(g.packed, t, cfg, policy, kv_cache=cache,
                              cache_position=torch.zeros(1, dtype=torch.int32, device=dev),
                              kv_valid_len=torch.full((1,), PROMPT_LEN, dtype=torch.int32,
                                                      device=dev),
                              kc=kc_p, logits_at=torch.full((1,), PROMPT_LEN - 1,
                                                            device=dev))
        nxt = torch.argmax(lg[:, -1], -1)[:, None]
        p = torch.full((1,), PROMPT_LEN, dtype=torch.int32, device=dev)
        with patched(b1_witness if tag == "witness" else {}):
            lg2, cache = counted(f"b1_step_{tag}", lambda: E.forward(
                g.packed, nxt, cfg, policy, positions=p[:, None], kv_cache=cache,
                cache_position=p, kv_valid_len=p + 1, kc=kc_d))
        res[tag] = (lg, lg2, cache, nxt)
    e_pre = float_err(res["kernel"][0], res["plain"][0])
    same_tok = bool(torch.equal(res["kernel"][3], res["plain"][3]))
    e_dec = float_err(res["kernel"][1], res["plain"][1])
    e_cache = [int8_err(res["kernel"][2].k, res["plain"][2].k),
               int8_err(res["kernel"][2].v, res["plain"][2].v)]
    e_wit = float_err(res["witness"][1], res["plain"][1])
    wit_equal = all(bool(torch.equal(getattr(res["witness"][2], kv), getattr(res["plain"][2], kv)))
                    for kv in ("k", "v"))
    finite = all(bool(torch.isfinite(r[0]).all() and torch.isfinite(r[1]).all())
                 for r in res.values())
    print(f"  prefill logits kernel vs plain: max abs {e_pre[0]:.3g} rel {e_pre[1]:.3g}; "
          f"decode step: rel {e_dec[1]:.3g} (same input token: {same_tok}); "
          f"K / V cache max diff, share of bytes {e_cache[0]} / {e_cache[1]}; finite {finite}; "
          f"witness (plain prefill, decode() step on engine numerics) vs plain: logits rel "
          f"{e_wit[1]:.3g}, caches equal {wit_equal}", flush=True)
    if not finite or res["kernel"][0].shape != (1, 1, cfg.vocab_size):
        failures.append("prefill logits not finite / wrong shape")
    if e_pre[1] > 2e-3:
        failures.append(f"prefill logits kernel vs plain rel {e_pre[1]}")
    # the kernels sum norms, softmax and P·V in fp64 where the plain path sums
    # in fp32, so a byte near a rounding boundary moves by a step, and with
    # random weights grows through the later layers (the limits of the chunk
    # route below, not one step: an earlier run measured 2 steps on 0.0045% of
    # the K bytes after 22 prefill layers and one step)
    if same_tok and e_dec[1] > 4e-3:
        failures.append(f"decode logits kernel vs plain rel {e_dec[1]}")
    if max(e[0] for e in e_cache) > 63 or max(e[1] for e in e_cache) > 2.5e-3:
        failures.append(f"K / V caches kernel vs plain {e_cache}")
    if runs["b1_step_witness"]["fused_model_w4"] or e_wit[1] > 1e-6 or not wit_equal:
        failures.append(f"B=1 witness vs plain: logits rel {e_wit[1]}, caches equal "
                        f"{wit_equal}, launches {runs['b1_step_witness']}")

    # B=4 decode step at staggered positions: whole-model kernel vs plain path
    B4 = 4
    p4 = torch.randint(0, cfg.vocab_size, (B4, SHORT_PROMPT), generator=gen, device=dev)
    c4 = E.init_kv_cache(ecfg, B4, device=dev)
    _, c4 = E.forward(g.packed, p4, cfg, policy, kv_cache=c4,
                      cache_position=torch.zeros(B4, dtype=torch.int32, device=dev),
                      kv_valid_len=torch.full((B4,), SHORT_PROMPT, dtype=torch.int32,
                                              device=dev),
                      kc=KernelConfig.prefill(),
                      logits_at=torch.full((B4,), SHORT_PROMPT - 1, device=dev))
    pos4 = torch.tensor([SHORT_PROMPT, SHORT_PROMPT - 3, SHORT_PROMPT - 1, SHORT_PROMPT - 7],
                        dtype=torch.int32, device=dev)
    tok4 = torch.randint(0, cfg.vocab_size, (B4, 1), generator=gen, device=dev)
    res4 = {}
    for tag, kc_d in (("kernel", KernelConfig.decode()), ("plain", KernelConfig.none())):
        cc = E.EngineKVCache(c4.k.clone(), c4.v.clone())
        res4[tag] = counted(f"b4_{tag}", lambda: E.forward(
            g.packed, tok4, cfg, policy, positions=pos4[:, None], kv_cache=cc,
            cache_position=pos4, kv_valid_len=pos4 + 1, kc=kc_d))
    e4 = float_err(res4["kernel"][0], res4["plain"][0])
    e4k = int8_err(res4["kernel"][1].k, res4["plain"][1].k)
    e4v = int8_err(res4["kernel"][1].v, res4["plain"][1].v)
    print(f"  B=4 staggered decode step, kernel vs plain: logits rel {e4[1]:.3g}; "
          f"K cache {e4k}, V cache {e4v}; launches {runs['b4_kernel']}", flush=True)
    if e4[1] > 2e-3 or not bool(torch.isfinite(res4["kernel"][0]).all()):
        failures.append(f"B=4 decode logits kernel vs plain rel {e4[1]}")
    if max(e4k[0], e4v[0]) > 1 or max(e4k[1], e4v[1]) > 1e-3:
        failures.append(f"B=4 caches kernel vs plain {e4k} {e4v}")
    if runs["b4_kernel"]["fused_model_w4"] != 1 or any(runs["b4_plain"].values()):
        failures.append(f"B=4 step launches {runs['b4_kernel']} / {runs['b4_plain']}")

    # the serving batch: chunked-staging decode at B = 32 (128-token prompt,
    # NEW_TOKENS new tokens, HOST_NEW on the default route) and B = 128
    # (32-token prompt, BIG_STEPS steps) on the default route (decode_loop's
    # entry config: W4A8 qkv / o, the MLP-block kernel, staged_append) and on
    # the chunk route (one fused_model_w4_chunk launch and one staged_append
    # per step); then BIG_STEPS B = 32 steps on the o-tail route
    phase("phase 3b: serving batch, chunked-staging decode")
    p32 = torch.randint(0, cfg.vocab_size, (SERVE_B, PROMPT_LEN), generator=gen,
                        device=dev).cpu().numpy()
    p128 = torch.randint(0, cfg.vocab_size, (BIG_B, SHORT_PROMPT), generator=gen,
                         device=dev).cpu().numpy()
    serve = {}

    def loop_numbers(gs, prompt_np, n):
        """wall time per step of an n-step decode_loop after a prefill of
        prompt_np; device time, launches per step and the idle share (against
        that loop's own wall time) from torch.profiler over a loop of at most 4
        steps from the same state."""
        Bq = prompt_np.shape[0]
        tp = torch.as_tensor(prompt_np, device=dev)
        last, cache = gs.prefill(tp, gs.init_cache(Bq))
        tok = torch.argmax(last, -1)[:, None]
        start = torch.full((Bq,), prompt_np.shape[1], dtype=torch.int32, device=dev)
        def fn(k):
            return gs.decode(tok, cache, start, k)
        def wall_ms(k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn(k)
            torch.cuda.synchronize()
            return (time.perf_counter() - t0) * 1e3

        fn(n)
        wall = wall_ms(n) / n
        # a short loop keeps the profiler's event buffers whole; its idle share
        # is taken against its own wall time (its chunk set-up and flush are
        # spread over n_p steps there)
        n_p = min(n, 4)
        wall_p = wall_ms(n_p)
        d_ms, top, n_l = device_profile(lambda: fn(n_p))
        return {"wall_ms_per_step": wall, "device_ms_per_step": d_ms / n_p,
                "idle_share": 1.0 - d_ms / wall_p, "launches_per_step": n_l / n_p,
                "loop_tok_s": Bq * 1e3 / wall, "profiled_steps": n_p,
                "top_kernels": [(k, ms / n_p, c / n_p) for k, ms, c in top]}

    for rname, kc_r in (("staged", True), ("chunk", KernelConfig.chunk())):
        gs = Generator(packed, cfg, policy, dataclasses.replace(ecfg, use_pallas=kc_r),
                       device=dev)
        b32_new, b32_loop = ((HOST_NEW, HOST_LOOP) if rname == "staged"
                             else (NEW_TOKENS, CHUNK_COLS))
        for tag, pr, n_new, n_loop in (("b32", p32, b32_new, b32_loop),
                                       ("b128", p128, BIG_STEPS + 1, BIG_STEPS)):
            gs.generate_fast(pr, 3)                      # warm-up
            route = f"{tag}_{rname}"
            tk, stt = counted(route, lambda: gs.generate_fast(pr, n_new, return_stats=True))
            nums = loop_numbers(gs, pr, n_loop)
            nums.update(decode_tok_s=stt["decode_tok_s"], prefill_ms=stt["prefill_s"] * 1e3,
                        launches=runs[route])
            serve[route] = nums
            print(f"  {route}: decode {stt['decode_tok_s']:.2f} tok/s (generate_fast), "
                  f"loop step wall {nums['wall_ms_per_step']:.3f} ms, device "
                  f"{nums['device_ms_per_step']:.3f} ms, idle {nums['idle_share']:.3f}, "
                  f"{nums['launches_per_step']:.1f} launches/step; counts {runs[route]}",
                  flush=True)
            for k, ms, c in nums["top_kernels"]:
                print(f"    {route}/step {ms:8.4f} ms  x{c:6.1f}  {k}", flush=True)
            steps = n_new - 1
            if tk.shape != (pr.shape[0], n_new) or tk.min() < 0 or tk.max() >= cfg.vocab_size:
                failures.append(f"{route}: bad tokens {tk.shape}")
            want = {"staged_append": steps, "fused_model_w4": 0,
                    "fused_model_w4_chunk": steps if rname == "chunk" else 0,
                    "fused_mlp_block_w4": 0 if rname == "chunk" else L * steps}
            got = {k: runs[route][k] for k in want}
            if got != want:
                failures.append(f"{route}: launches {got}, expected {want}")

    gs = Generator(packed, cfg, policy,
                   dataclasses.replace(ecfg, use_pallas=KernelConfig.otail()), device=dev)
    gs.generate_fast(p32, 3)
    _, stt = counted("b32_otail", lambda: gs.generate_fast(p32, BIG_STEPS + 1,
                                                           return_stats=True))
    serve["b32_otail"] = {"decode_tok_s": stt["decode_tok_s"], "launches": runs["b32_otail"]}
    print(f"  b32_otail: decode {stt['decode_tok_s']:.2f} tok/s, counts {runs['b32_otail']}",
          flush=True)
    if runs["b32_otail"]["fused_otail_block_w4"] != L * BIG_STEPS:
        failures.append(f"o-tail route: launches {runs['b32_otail']}")

    # kernel path vs plain path over one CHUNK_COLS-step chunk at B = 32, the
    # same tokens fed to every route: logits of every step and the flushed caches
    def staged_chunk(kc_c, cache, toks, pos0, packed_c=None, policy_c=None, kv4=False,
                     cfg_c=None):
        return run_staged_chunk(E, qops, packed_c or gs.packed, cfg_c or cfg,
                                policy_c or policy, kc_c, cache, toks, pos0, kv4)

    c32 = E.init_kv_cache(ecfg, SERVE_B, device=dev)
    _, c32 = gs.prefill(torch.as_tensor(p32, device=dev), c32)
    ftoks = torch.randint(0, cfg.vocab_size, (SERVE_B, CHUNK_COLS), generator=gen,
                          device=dev)
    fpos = torch.full((SERVE_B,), PROMPT_LEN, dtype=torch.int32, device=dev)
    window = slice(PROMPT_LEN, PROMPT_LEN + CHUNK_COLS)      # the flushed rows
    window_s = slice(PROMPT_LEN, PROMPT_LEN + SHORT_CHAIN)   # those of a SHORT_CHAIN chunk
    # the chunk route with the chunk kernel's plain version in its place (the
    # same function on the card: the wiring without the kernel), then with
    # the plain engine's attention, its fp32 norms, or both inside that plain
    # version (engine_numerics)
    witness = {"chunk_plain_fn": {},
               "chunk_engine_attention": engine_numerics(E, cfg, policy, norms=False),
               "chunk_engine_norms": engine_numerics(E, cfg, policy, attention=False),
               "chunk_engine_numerics": engine_numerics(E, cfg, policy)}
    chain = {}
    for tag, kc_c in (("staged", KernelConfig.serving(cfg, gs.packed, SERVE_B)),
                      ("chunk", KernelConfig.chunk()),
                      *((w, KernelConfig.chunk()) for w in witness),
                      ("plain", KernelConfig.none())):
        cc = E.EngineKVCache(c32.k.clone(), c32.v.clone())
        stand_ins = dict(witness.get(tag, {}))
        if tag in witness:
            stand_ins[(E, "fused_model_w4_chunk")] = fused_model_w4_chunk_plain
        with patched(stand_ins):
            chain[tag] = counted(f"chain_{tag}", lambda: staged_chunk(kc_c, cc, ftoks, fpos))
    if any(runs["chain_plain"].values()):
        failures.append(f"plain chain launched kernels {runs['chain_plain']}")
    # limits: (logits rel, max int8 diff, share of differing flushed bytes).
    # The chunk route with its kernel equals the route with the kernel's plain
    # version, and that plain version on the plain engine's numerics equals
    # the plain engine path: the wiring is the engine's. The kernels sum norms
    # in fp64 where the plain engine path sums in fp32 (as the JAX engine's
    # XLA body does), and the chunk kernel's attention scales scores and
    # rounds P·V as the JAX chunk kernel does, so a byte near a rounding
    # boundary can move by one step; with random weights such a byte grows
    # through the later layers and steps of its sequence (measured on the
    # card: step 0 at logits rel 3.7e-4, the chunk at 2.07e-3, 0.12% of the
    # flushed bytes off, by up to 31 steps). The default staged route (fp64
    # only in its MLP-block norms) is held to one step on 0.1% of the bytes,
    # the chunk route and its part-way witnesses to about twice the readings.
    chain_err = {}
    for tag, ref, lim in (("staged", "plain", (2e-3, 1, 1e-3)),
                          ("chunk", "chunk_plain_fn", (2e-3, 0, 0.0)),
                          ("chunk_engine_numerics", "plain", (2e-3, 0, 0.0)),
                          ("chunk_engine_attention", "plain", (4e-3, 63, 2.5e-3)),
                          ("chunk_engine_norms", "plain", (4e-3, 63, 2.5e-3)),
                          ("chunk", "plain", (4e-3, 63, 2.5e-3))):
        e_l = float_err(chain[tag][0], chain[ref][0])
        steps = [float_err(chain[tag][0][:, i], chain[ref][0][:, i])[1]
                 for i in range(CHUNK_COLS)]
        e_k = int8_err(chain[tag][1].k[:, :, :, window], chain[ref][1].k[:, :, :, window])
        e_v = int8_err(chain[tag][1].v[:, :, :, window], chain[ref][1].v[:, :, :, window])
        fin = bool(torch.isfinite(chain[tag][0]).all())
        chain_err[f"{tag}_vs_{ref}"] = {"logits_rel": e_l[1], "logits_rel_first_step": steps[0],
                                        "logits_rel_per_step": steps,
                                        "k_rows": e_k, "v_rows": e_v, "finite": fin}
        print(f"  B={SERVE_B} {CHUNK_COLS}-step chunk, {tag} vs {ref}: logits rel {e_l[1]:.3g} "
              f"(step 0: {steps[0]:.3g}); flushed K rows {e_k}, V rows {e_v} (max diff, "
              f"share of bytes)", flush=True)
        if not fin or e_l[1] > lim[0]:
            failures.append(f"{tag} chunk vs {ref}: logits rel {e_l[1]}, finite {fin}")
        if max(e_k[0], e_v[0]) > lim[1] or max(e_k[1], e_v[1]) > lim[2]:
            failures.append(f"{tag} chunk vs {ref}: flushed rows {e_k} {e_v}")

    # ---- phase 3c: the int4 KV cache -----------------------------------------
    # generate_fast on the kv4 pack at B = 1, 32, 128 and B = 8 from a
    # 496-token prompt (its 32-step chunk straddles S/2 = 512); decode_loop's
    # entry config: every step staged, one kv4 kernel launch per layer
    phase("phase 3c: int4 KV cache, TinyLlama-1.1B W4A8/h4, kv_bits 4, relaxed")
    g4 = Generator(packed4, cfg, policy4, ecfg4, device=dev)
    for route, Bq, Tp, n_new, n_loop in (("kv4_b1", 1, PROMPT_LEN, HOST_NEW, HOST_LOOP),
                                         ("kv4_b32", SERVE_B, PROMPT_LEN, HOST_NEW, HOST_LOOP),
                                         ("kv4_b128", BIG_B, SHORT_PROMPT, BIG_STEPS + 1,
                                          BIG_STEPS),
                                         ("kv4_b8_straddle", 8, 496, 33, CHUNK_COLS)):
        pr = torch.randint(0, cfg.vocab_size, (Bq, Tp), generator=kgen, device=dev).cpu().numpy()
        g4.generate_fast(pr, 3)                          # warm-up
        tk, stt = counted(route, lambda: g4.generate_fast(pr, n_new, return_stats=True))
        nums = loop_numbers(g4, pr, n_loop)
        nums.update(decode_tok_s=stt["decode_tok_s"], prefill_ms=stt["prefill_s"] * 1e3,
                    launches=runs[route], batch=Bq, prompt=Tp, new_tokens=n_new)
        serve[route] = nums
        print(f"  {route}: decode {stt['decode_tok_s']:.2f} tok/s (generate_fast), prefill "
              f"{stt['prefill_s'] * 1e3:.2f} ms, loop step wall {nums['wall_ms_per_step']:.3f} "
              f"ms, device {nums['device_ms_per_step']:.3f} ms, idle {nums['idle_share']:.3f}, "
              f"{nums['launches_per_step']:.1f} launches/step; counts {runs[route]}", flush=True)
        for k, ms, c in nums["top_kernels"]:
            print(f"    {route}/step {ms:8.4f} ms  x{c:6.1f}  {k}", flush=True)
        steps = n_new - 1
        if tk.shape != (Bq, n_new) or tk.min() < 0 or tk.max() >= cfg.vocab_size:
            failures.append(f"{route}: bad tokens {tk.shape}")
        want = {"kv4_decode_attention": L * steps, "staged_append": steps,
                "fused_mlp_block_w4": L * steps, "fused_model_w4": 0,
                "fused_model_w4_chunk": 0, "qkv_rope": 0}
        got = {k: runs[route][k] for k in want}
        if got != want:
            failures.append(f"{route}: launches {got}, expected {want}")

    # one SHORT_CHAIN-step B=32 chunk on the kv4 pack, the same tokens fed to
    # the kv4 kernel route, to that route with the kernel's plain version, to
    # that route on the plain engine's numerics (the witness that its wiring is
    # the engine's), and to the plain path: logits of every step and the
    # flushed (unpacked) rows
    c4 = E.init_kv_cache(ecfg4, SERVE_B, device=dev)
    p4 = torch.randint(0, cfg.vocab_size, (SERVE_B, PROMPT_LEN), generator=kgen, device=dev)
    _, c4 = g4.prefill(p4, c4)
    ftoks4 = torch.randint(0, cfg.vocab_size, (SERVE_B, CHUNK_COLS), generator=kgen,
                           device=dev)[:, :SHORT_CHAIN]
    chain4 = {}
    kc4 = KernelConfig.serving(cfg, g4.packed, SERVE_B)
    stand4 = {"kv4_kernel_plain_fn": {(E, "kv4_decode_attention"): kv4_decode_attention_plain},
              "kv4_engine_numerics": kv4_engine_numerics(E, cfg, g4.packed, policy4)}
    for tag, kc_c in (("kv4_kernel", kc4), ("kv4_kernel_plain_fn", kc4),
                      ("kv4_engine_numerics", kc4), ("kv4_plain", KernelConfig.none())):
        cc = E.EngineKVCache(c4.k.clone(), c4.v.clone())
        with patched(stand4.get(tag, {})):
            lg_c, cc = counted(f"chain_{tag}", lambda: staged_chunk(
                kc_c, cc, ftoks4, fpos, g4.packed, policy4, kv4=True))
        chain4[tag] = (lg_c, qops.unpack_kv_s(cc.k)[:, :, :, window_s],
                       qops.unpack_kv_s(cc.v)[:, :, :, window_s])
    wit4 = runs["chain_kv4_engine_numerics"]
    if runs["chain_kv4_kernel"]["kv4_decode_attention"] != L * SHORT_CHAIN \
            or any(runs["chain_kv4_plain"].values()) \
            or wit4["kv4_decode_attention"] or wit4["fused_mlp_block_w4"]:
        failures.append(f"kv4 chain launches {runs['chain_kv4_kernel']} / {wit4} / "
                        f"{runs['chain_kv4_plain']}")
    # limits: the kernel equals its plain version, and the route on the plain
    # engine's numerics equals the plain path. Against the plain path the
    # kernels' fp64 sums (the MLP block's norms, the kv4 softmax and P·V) move
    # a value near a rounding boundary by one 4-bit step, and one 4-bit step
    # moves a later step's logits by far more than one int8 step does (on the
    # card: 1 step on 0.002% of the flushed values gave logits rel 2.44e-3;
    # the CPU tests measure ~1e-2 for a handful of such values): held to one
    # step and about twice the readings of the SHORT_CHAIN-step chunk
    # (logits rel 2.77e-3, one step on 0.0065% of the V values)
    for tag, ref, lim in (("kv4_kernel", "kv4_kernel_plain_fn", (1e-6, 0, 0.0)),
                          ("kv4_engine_numerics", "kv4_plain", (1e-6, 0, 0.0)),
                          ("kv4_kernel", "kv4_plain", (5e-3, 1, 1.3e-4))):
        e_l = float_err(chain4[tag][0], chain4[ref][0])
        steps = [float_err(chain4[tag][0][:, i], chain4[ref][0][:, i])[1]
                 for i in range(SHORT_CHAIN)]
        e_k = int8_err(chain4[tag][1], chain4[ref][1])
        e_v = int8_err(chain4[tag][2], chain4[ref][2])
        fin = bool(torch.isfinite(chain4[tag][0]).all())
        chain_err[f"{tag}_vs_{ref}"] = {"logits_rel": e_l[1], "logits_rel_first_step": steps[0],
                                        "logits_rel_per_step": steps,
                                        "k_rows": e_k, "v_rows": e_v, "finite": fin}
        print(f"  kv4 B={SERVE_B} {SHORT_CHAIN}-step chunk, {tag} vs {ref}: logits rel "
              f"{e_l[1]:.3g} (step 0: {steps[0]:.3g}); flushed K rows {e_k}, V rows {e_v} "
              f"(max diff in 4-bit steps, share of values)", flush=True)
        if not fin or e_l[1] > lim[0]:
            failures.append(f"{tag} kv4 chunk vs {ref}: logits rel {e_l[1]}, finite {fin}")
        if max(e_k[0], e_v[0]) > lim[1] or max(e_k[1], e_v[1]) > lim[2]:
            failures.append(f"{tag} kv4 chunk vs {ref}: flushed rows {e_k} {e_v}")

    # ---- phase 3d: the attn() route ------------------------------------------
    # PER_LAYER_STEPS B=1 decode steps, each writing its row into the int8
    # cache and launching the decode attention kernel once per layer
    phase("phase 3d: the attn() route (int8 decode attention kernel), B=1")
    ga = Generator(packed, cfg, policy, dataclasses.replace(ecfg, use_pallas=KernelConfig.attn()),
                   device=dev)
    ga.generate_fast(prompt, 2)
    toks_a, stats_a = counted("attn_b1", lambda: ga.generate_fast(
        prompt, PER_LAYER_STEPS + 1, return_stats=True))
    print(f"  attn route: {stats_a['decode_tok_s']:.2f} tok/s, launches {runs['attn_b1']}",
          flush=True)
    if runs["attn_b1"]["decode_attention"] != PER_LAYER_STEPS * L \
            or runs["attn_b1"]["fused_model_w4"] or runs["attn_b1"]["staged_append"]:
        failures.append(f"attn route: launches {runs['attn_b1']}")
    if toks_a.shape != (1, PER_LAYER_STEPS + 1) or toks_a.min() < 0 \
            or toks_a.max() >= cfg.vocab_size:
        failures.append(f"attn route: bad tokens {toks_a.shape}")
    # against the plain path: the same tokens fed to both from one prefill cache
    _, ca0 = ga.prefill(t, E.init_kv_cache(ecfg, 1, device=dev))
    atoks = torch.randint(0, cfg.vocab_size, (1, PER_LAYER_STEPS), generator=kgen, device=dev)
    attn_res = {}
    for tag, kc_a in (("attn", KernelConfig.attn()), ("plain", KernelConfig.none())):
        cc = E.EngineKVCache(ca0.k.clone(), ca0.v.clone())
        lgs = []
        for i in range(PER_LAYER_STEPS):
            pa = torch.full((1,), PROMPT_LEN + i, dtype=torch.int32, device=dev)
            lg_a, cc = E.forward(g.packed, atoks[:, i:i + 1], cfg, policy, positions=pa[:, None],
                                 kv_cache=cc, cache_position=pa, kv_valid_len=pa + 1, kc=kc_a)
            lgs.append(lg_a[:, -1])
        attn_res[tag] = (torch.stack(lgs, 1), cc)
    arows = slice(PROMPT_LEN, PROMPT_LEN + PER_LAYER_STEPS)
    e_al = float_err(attn_res["attn"][0], attn_res["plain"][0])
    e_ak = int8_err(attn_res["attn"][1].k[:, :, :, arows], attn_res["plain"][1].k[:, :, :, arows])
    e_av = int8_err(attn_res["attn"][1].v[:, :, :, arows], attn_res["plain"][1].v[:, :, :, arows])
    print(f"  attn route vs plain over {PER_LAYER_STEPS} steps: logits rel {e_al[1]:.3g}; "
          f"written K rows {e_ak}, V rows {e_av}", flush=True)
    if e_al[1] > 2e-3 or not bool(torch.isfinite(attn_res["attn"][0]).all()):
        failures.append(f"attn route vs plain: logits rel {e_al[1]}")
    if max(e_ak[0], e_av[0]) > 1 or max(e_ak[1], e_av[1]) > 1e-3:
        failures.append(f"attn route vs plain: written rows {e_ak} {e_av}")

    # ---- phase 2w: the W8 editions and w8a8_matmul against their plain versions
    # (a W8A8/h8 pack of its own and a generator of its own, so that the
    # earlier phases' inputs stay as they were)
    phase("phase 2w: W8 editions vs plain versions, TinyLlama-1.1B W8A8/h8")
    wgen = torch.Generator(device=dev).manual_seed(SEED + 3)
    packed8, _, strict8, ecfg8 = build_synthetic_packed(
        "tinyllama-1.1b", w_bits=8, head_bits=8, max_seq_len=MAX_SEQ, seed=SEED, device=dev)
    policy8 = relax_16bit(strict8)
    ly8 = packed8["layers"]
    Vp8 = packed8["head_q"]["wq"].shape[1]
    mlp_w8 = D * 2 * F + F * D                             # W8 weight bytes
    layer_w8 = D * Nq + Ko * D + mlp_w8
    head_bytes8 = D * Vp8 + 2 * Vp8 * 4 + 2 * D * 4
    print(f"  W8 weight bytes: layers {L * layer_w8 / 1e6:.1f} MB, head {D * Vp8 / 1e6:.1f} MB",
          flush=True)

    # row 14 at M = 1, 8, 32 on the four projections (layers rotated while
    # timing, past the 50 MB L2), beside its parent's kernel (PARENT_W8A8_MS);
    # yardstick: torch._int_mm on the same W8 matrix, rows padded to 32
    w8_shapes = (("qkv", ly8["qkv_proj"]), ("o", ly8["o_proj"]), ("w13", ly8["w13_proj"]),
                 ("w2", ly8["w2"]))
    for Mr in (1, 8, 32):
        for tag, pk in w8_shapes:
            K, N = pk["wq"].shape[1], pk["wq"].shape[2]
            lp = layer_pack(pk, 0)
            x = torch.randint(-128, 128, (Mr, K), generator=wgen, device=dev, dtype=torch.int8)
            out = w8a8_matmul(x, pk, 0.02, 121.0, 0)
            ref = w8a8_matmul_plain(x, lp["wq"], lp["scale"], lp["offset"], lp["colsum"],
                                    lp["bias"], 0.02, 121.0)
            err = float_err(out, ref)
            ms = time_ms(lambda i, x=x, pk=pk: w8a8_matmul(x, pk, 0.02, 121.0, i % L))
            plain_ms = time_ms(lambda i, x=x, lp=lp: w8a8_matmul_plain(
                x, lp["wq"], lp["scale"], lp["offset"], lp["colsum"], lp["bias"], 0.02, 121.0),
                n=5)
            xp = x if Mr == 32 else torch.cat(
                [x, torch.zeros((32 - Mr, K), dtype=torch.int8, device=dev)])
            lib_ms = time_ms(lambda i, xp=xp, pk=pk: torch._int_mm(xp, pk["wq"][i % L]))
            parent = PARENT_W8A8_MS[(Mr, tag)]
            record("w8a8_matmul", f"M={Mr} {tag} {K}->{N}", err, err[1] <= 1e-6, ms, plain_ms,
                   lib_ms, bound(Mr * K + K * N + 4 * N * 4 + Mr * N * 4,
                                 int8_ops=2.0 * Mr * K * N),
                   note=f"parent's kernel {parent:.4f} ms ({ms / parent - 1:+.1%})"
                        + ("" if Mr == 32 else "; library: torch._int_mm on rows padded to 32"),
                   main=(Mr, tag) == (1, "w13"))

    # row 14 at the other row counts, against its plain version at rel 1e-6:
    # the four projections, StableLM-2-1.6B's qkv width (2048 -> 6144) and a
    # width off the 16-byte grid (N % 16 != 0: the 4-byte-copy edition, its
    # count on the wrapper)
    g14 = torch.Generator(device=dev).manual_seed(SEED + 14)
    w14 = [(tag + " ", pk, (2, 4, 9, 17, 33, 128)) for tag, pk in w8_shapes]
    for tag, N in (("StableLM qkv ", 6144), ("", 500)):
        w14.append((tag, {"wq": torch.randint(-128, 128, (2, D, N), generator=g14, device=dev,
                                              dtype=torch.int8),
                          "scale": torch.rand((2, 1, N), generator=g14, device=dev) * 1e-3 + 1e-4,
                          "offset": torch.randint(-8, 8, (2, 1, N), generator=g14,
                                                  device=dev).float(),
                          "colsum": torch.randn((2, N), generator=g14, device=dev) * 100.0,
                          "bias": torch.randn((2, N), generator=g14, device=dev)},
                     (1, 2, 4, 8, 9, 17, 32, 33, 128)))
    for tag, pk, ms_ in w14:
        lp = layer_pack(pk, 1)
        K, N = lp["wq"].shape
        edge = N % 16 != 0
        for Mr in ms_:
            x = torch.randint(-128, 128, (Mr, K), generator=g14, device=dev, dtype=torch.int8)
            n_edge = w8a8_matmul.edge_launches
            err = float_err(w8a8_matmul(x, pk, 0.02, 121.0, 1),
                            w8a8_matmul_plain(x, lp["wq"], lp["scale"], lp["offset"],
                                              lp["colsum"], lp["bias"], 0.02, 121.0))
            check_row("w8a8_matmul", f"{tag}M={Mr} {K}->{N}" + (" 4-byte edition" if edge else ""),
                      err, err[1] <= 1e-6 and w8a8_matmul.edge_launches - n_edge == edge)
    del w14

    # the W8 prefill epilogue kernels at M = 128
    Mr = PROMPT_LEN
    cos_p, sin_p = MM.rope_cos_sin(torch.arange(Mr, device=dev)[None], cfg)
    cs_p = E._rope_cs_rows(cos_p, sin_p, hd, cfg.rotary_dim)
    ofq8 = E._qkv_ofq_rows(packed8, policy8)
    outq8 = E._qkv_outq_rows(packed8["ranges"], cfg, L, dev)
    h8w = torch.randint(-128, 128, (Mr, D), generator=wgen, device=dev, dtype=torch.int8)
    qkv8 = ly8["qkv_proj"]
    out = qkv_rope(h8w, qkv8, ofq8[0], outq8[0], cs_p, 0.02, 121.0, 0, hd, cfg.rotary_dim)
    ref = qkv_rope_plain(h8w, layer_pack(qkv8, 0), ofq8[0], outq8[0], cs_p, 0.02, 121.0, hd,
                         cfg.rotary_dim)
    err = int8_err(out, ref)
    ms = time_ms(lambda i: qkv_rope(h8w, qkv8, ofq8[i % L], outq8[i % L], cs_p, 0.02, 121.0,
                                    i % L, hd, cfg.rotary_dim))
    plain_ms = time_ms(lambda i: qkv_rope_plain(h8w, layer_pack(qkv8, 0), ofq8[0], outq8[0],
                                                cs_p, 0.02, 121.0, hd, cfg.rotary_dim), n=5)
    record("qkv_rope[w8]", f"M={Mr} {D}->{Nq}", err, err[0] == 0, ms, plain_ms, None,
           bound(Mr * D + D * Nq + 11 * Nq * 4 + Mr * 2 * hd * 4 + Mr * Nq,
                 int8_ops=2.0 * Mr * D * Nq))
    qkv_sweep("[w8]", qkv8, ofq8, outq8, L, cfg, True,
              torch.Generator(device=dev).manual_seed(SEED + 22))
    lr8 = E.layer_ranges(packed8["ranges"], 1)
    meta8 = E._mlp_block_meta(lr8, policy8, cfg)
    so8 = E._mlp_block_site_on(policy8)
    w13w, w2w, mn8 = ly8["w13_proj"], ly8["w2"], ly8["mlp_norm"]
    out = w13_gate(h8w, w13w, meta8, 1, cfg.hidden_act, so8[1:5])
    ref = w13_gate_plain(h8w, layer_pack(w13w, 1), meta8, cfg.hidden_act, so8[1:5])
    err = int8_err(out, ref)
    ms = time_ms(lambda i: w13_gate(h8w, w13w, meta8, i % L, cfg.hidden_act, so8[1:5]))
    plain_ms = time_ms(lambda i: w13_gate_plain(h8w, layer_pack(w13w, 1), meta8, cfg.hidden_act,
                                                so8[1:5]), n=5)
    record("w13_gate[w8]", f"M={Mr} {D}->2x{F}", err, err[0] == 0, ms, plain_ms, None,
           bound(Mr * D + D * 2 * F + 2 * F * 16 + Mr * F, int8_ops=2.0 * Mr * D * 2 * F))
    w13_gate_sweep("[w8]", w13w, meta8, L, cfg.hidden_act, so8[1:5], D, F, 1,
                   torch.Generator(device=dev).manual_seed(SEED + 21))

    # the W8 MLP block: the dp4a kernel at M <= DP4A_ROWS, the row kernel above
    def mlp8_plain(x):
        return fused_mlp_block_w4_plain(x, mn8["w"][1], mn8["b"][1], layer_pack(w13w, 1),
                                        layer_pack(w2w, 1), meta8, cfg.hidden_act, so8)

    for Mr in (1, 2, 8, SHORT_PROMPT, BIG_B):
        x = torch.randn((Mr, D), generator=wgen, device=dev)
        out = fused_mlp_block_w4(x, mn8["w"], mn8["b"], w13w, w2w, meta8, 1, cfg.hidden_act, so8)
        err = float_err(out, mlp8_plain(x))
        ms = time_ms(lambda i, x=x: fused_mlp_block_w4(x, mn8["w"], mn8["b"], w13w, w2w, meta8,
                                                       i % L, cfg.hidden_act, so8))
        plain_ms = time_ms(lambda i, x=x: mlp8_plain(x), n=5)
        record("fused_mlp_block_w4[w8]",
               f"M={Mr} {'dp4a' if Mr <= DP4A_ROWS else 'row'} kernel {D}->2x{F}->{D}", err,
               err[1] <= 2e-3, ms, plain_ms, None,
               bound(2 * Mr * D * 4 + mlp_w8 + mlp_vec,
                     int8_ops=2.0 * Mr * (D * 2 * F + F * D)),
               main=Mr == BIG_B)

    # the W8 whole-model (B = 1, 8, with the W8 head) and whole-layer (B = 1)
    # kernels over random full-length caches, positions near POS0
    kp8 = E._kernel_prep(packed8, policy8, cfg)
    hargs8 = (packed8["head_q"], packed8["norm"])
    stage_us8 = {}
    for Bm in (1, 8):
        kc = torch.randint(-128, 128, (L, Bm, Hkv, MAX_SEQ, hd), generator=wgen, device=dev,
                           dtype=torch.int8)
        vc = torch.randint(-128, 128, kc.shape, generator=wgen, device=dev, dtype=torch.int8)
        posb = torch.tensor([POS0 - 3 * b for b in range(Bm)], dtype=torch.int32, device=dev)
        cos, sin = MM.rope_cos_sin(posb[:, None], cfg)
        csb = E._rope_cs_rows(cos, sin, hd, cfg.rotary_dim).reshape(Bm, 2, hd)
        x = torch.randn((Bm, D), generator=wgen, device=dev)
        fargs = (x, posb, csb, kp8["ofq"], ly8["attn_norm"], qkv8, ly8["o_proj"],
                 ly8["mlp_norm"], w13w, w2w, kc, vc, kp8["meta"])
        valid = int(posb.sum())
        att_ops = 2.0 * Hq * hd * valid
        step_io = 2 * Bm * D * 4 + Bm * 2 * hd * 4 + Bm * 4
        out = fused_model_w4(*fargs, *hargs8, **fkw)
        ref = fused_model_w4_plain(*fargs, *hargs8, **fkw)
        e_x, e_lg, e_kv = float_err(out[0], ref[0]), float_err(out[2], ref[2]), int8_err(out[1], ref[1])
        ok = e_x[1] <= 2e-3 and e_lg[1] <= 2e-3 and e_kv[0] == 0
        ms = time_ms(lambda i: fused_model_w4(*fargs, *hargs8, **fkw), n=10)
        plain_ms = event_ms(lambda: fused_model_w4_plain(*fargs, *hargs8, **fkw), n=2)
        nbytes = (L * (layer_w8 + layer_vec + valid * Hkv * hd * 2 + Bm * 2 * Hkv * hd)
                  + step_io + head_bytes8 + Bm * Vp8 * 4)
        ops_i8 = L * (2.0 * Bm * (D * Nq + Ko * D + D * 2 * F + F * D) + att_ops) \
            + 2.0 * Bm * D * Vp8
        record("fused_model_w4[w8]", f"B={Bm} L={L} S={MAX_SEQ} pos<={POS0} +W8 head",
               (max(e_x[0], e_lg[0]), max(e_x[1], e_lg[1])), ok, ms, plain_ms, None,
               bound(nbytes, int8_ops=ops_i8, fp32_ops=L * att_ops),
               note=f"kv_new max diff {e_kv[0]} on {e_kv[1]:.3g} of bytes; "
                    f"plain timed with events", main=Bm == 1)
        if Bm == 1:
            tr = torch.zeros(2 + 5 * L, dtype=torch.int64, device=dev)
            for _ in range(2):
                fused_model_w4(*fargs, *hargs8, trace=tr, **fkw)
            torch.cuda.synchronize()
            dt = (tr[1:] - tr[:-1]).double().cpu() / 1e3
            per = dt[:5 * L].reshape(L, 5).mean(0).tolist()
            stage_us8 = dict(zip(("qkv", "attention", "o_proj", "w13_gate", "w2"), per))
            stage_us8["head"] = float(dt[5 * L])
            stage_us8["step_traced"] = float(dt.sum())
            print("  fused_model_w4[w8] B=1 stage us (mean per layer): "
                  + ", ".join(f"{k} {v:.2f}" for k, v in stage_us8.items()), flush=True)
            print(parent_stages("W8"), flush=True)
            out = fused_layer_w4(*fargs, 1, **fkw)
            ref = fused_layer_w4_plain(*fargs, 1, **fkw)
            e_x, e_kv = float_err(out[0], ref[0]), int8_err(out[1], ref[1])
            ms = time_ms(lambda i: fused_layer_w4(*fargs, i % L, **fkw))
            plain_ms = event_ms(lambda: fused_layer_w4_plain(*fargs, 1, **fkw), n=3)
            record("fused_layer_w4[w8]", f"B=1 S={MAX_SEQ} pos={POS0}", e_x,
                   e_x[1] <= 2e-3 and e_kv[0] == 0, ms, plain_ms, None,
                   bound(layer_w8 + layer_vec + valid * Hkv * hd * 2 + 2 * Hkv * hd + step_io,
                         int8_ops=2.0 * (D * Nq + Ko * D + D * 2 * F + F * D) + att_ops,
                         fp32_ops=att_ops),
                   note=f"kv_new max diff {e_kv[0]} on {e_kv[1]:.3g} of bytes; "
                        f"plain timed with events")
        del kc, vc

    # the W8 chunk kernel with the W8 head: B=16 at staggered chunk starts,
    # B=32, and B=48 (the edge of the JAX gate that turns it on); m staged
    # columns of CHUNK_COLS; relaxed, and strict at B=32
    chunk_stage_us8 = {}
    for Bc, stag, cases in ((16, True, ((0, False), (STAGED_M, False))),
                            (SERVE_B, False, ((0, False), (STAGED_M, False), (STAGED_M, True))),
                            (48, False, ((STAGED_M, False),))):
        kc = torch.randint(-128, 128, (L, Bc, Hkv, MAX_SEQ, hd), generator=wgen, device=dev,
                           dtype=torch.int8)
        vc = torch.randint(-128, 128, kc.shape, generator=wgen, device=dev, dtype=torch.int8)
        skc = torch.randint(-128, 128, (L, Bc, Hkv, CHUNK_COLS, hd), generator=wgen,
                            device=dev, dtype=torch.int8)
        svc = torch.randint(-128, 128, skc.shape, generator=wgen, device=dev, dtype=torch.int8)
        kcs = E.kv_colsums(kc)
        pos0 = torch.tensor([POS0 - (3 * b if stag else 0) for b in range(Bc)],
                            dtype=torch.int32, device=dev)
        x = torch.randn((Bc, D), generator=wgen, device=dev)
        valid = int(pos0.sum())
        for mst, strict in cases:
            cos, sin = MM.rope_cos_sin((pos0 + mst)[:, None], cfg)
            csb = E._rope_cs_rows(cos, sin, hd, cfg.rotary_dim).reshape(Bc, 2, hd)
            rows_kv = valid + Bc * mst
            att_ops = 2.0 * Hq * hd * (rows_kv + Bc)
            nbytes = (L * (layer_w8 + layer_vec + rows_kv * Hkv * hd * 2 + valid * Hkv * 4
                           + Bc * 2 * Hkv * hd)
                      + 2 * Bc * D * 4 + Bc * 2 * hd * 4 + Bc * 4 + head_bytes8 + Bc * Vp8 * 4)
            ops_i8 = L * (2.0 * Bc * (D * Nq + Ko * D + D * 2 * F + F * D) + att_ops) \
                + 2.0 * Bc * D * Vp8
            kpc = E._kernel_prep(packed8, strict8 if strict else policy8, cfg)
            cargs = (x, pos0, csb, kpc["ofq"], ly8["attn_norm"], qkv8, ly8["o_proj"],
                     ly8["mlp_norm"], w13w, w2w, kc, vc, kcs, skc, svc, mst, kpc["meta"],
                     *hargs8)
            ckw = dict(fkw, qk_fq_on=strict, pv_fq_on=strict)
            out = fused_model_w4_chunk(*cargs, **ckw)
            ref = fused_model_w4_chunk_plain(*cargs, **ckw)
            e_x, e_lg = float_err(out[0], ref[0]), float_err(out[2], ref[2])
            e_kv = int8_err(out[1], ref[1])
            ok = e_x[1] <= 2e-3 and e_lg[1] <= 2e-3 and e_kv[0] == 0
            ms = time_ms(lambda i: fused_model_w4_chunk(*cargs, **ckw), n=5)
            plain_ms = event_ms(lambda: fused_model_w4_chunk_plain(*cargs, **ckw), n=2)
            record("fused_model_w4_chunk[w8]",
                   f"B={Bc} pos0{'<=' if stag else '='}{POS0} m={mst} "
                   f"{'strict' if strict else 'relaxed'} +W8 head",
                   (max(e_x[0], e_lg[0]), max(e_x[1], e_lg[1])), ok, ms, plain_ms, None,
                   bound(nbytes, int8_ops=ops_i8, fp32_ops=L * att_ops),
                   note=f"kv_new max diff {e_kv[0]} on {e_kv[1]:.3g} of bytes; "
                        f"plain timed with events",
                   main=(Bc, mst, strict) == (SERVE_B, STAGED_M, False))
            if (Bc, mst, strict) == (SERVE_B, STAGED_M, False):
                chunk_stage_us8[f"B={Bc}"] = chunk_stages(
                    lambda tr: fused_model_w4_chunk(*cargs, trace=tr, **ckw), L, dev,
                    f"fused_model_w4_chunk[w8] B={Bc} m={mst}", f"W8 B={Bc}")
        del kc, vc, skc, svc, kcs

    # ---- phase 3e: W8A8 serving --------------------------------------------
    # generate_fast and decode_loop on the W8/h8 pack through the port's
    # entry points, each route's launches counted from 0 around its run
    phase("phase 3e: generate_fast, TinyLlama-1.1B W8A8/h8, int8 KV, relaxed")
    serve8 = {}

    def w8_route(route, gen8, prompt_np, n_new, n_loop, want, store=None):
        """generate_fast on one route (its launch counts held to `want`), then
        decode_loop's per-step readings from the same state (loop_numbers),
        kept in `store` (serve8 unless given)."""
        store = serve8 if store is None else store
        vocab = gen8.config.vocab_size
        gen8.generate_fast(prompt_np, 3)                 # warm-up
        tk, stt = counted(route, lambda: gen8.generate_fast(prompt_np, n_new,
                                                            return_stats=True))
        nums = loop_numbers(gen8, prompt_np, n_loop)
        nums.update(decode_tok_s=stt["decode_tok_s"], prefill_ms=stt["prefill_s"] * 1e3,
                    launches=runs[route], batch=prompt_np.shape[0], prompt=prompt_np.shape[1],
                    new_tokens=n_new)
        store[route] = nums
        print(f"  {route}: decode {stt['decode_tok_s']:.2f} tok/s (generate_fast), prefill "
              f"{stt['prefill_s'] * 1e3:.2f} ms, loop step wall {nums['wall_ms_per_step']:.3f} "
              f"ms, device {nums['device_ms_per_step']:.3f} ms, idle {nums['idle_share']:.3f}, "
              f"{nums['launches_per_step']:.1f} launches/step; counts {runs[route]}", flush=True)
        for k, ms_, c in nums["top_kernels"]:
            print(f"    {route}/step {ms_:8.4f} ms  x{c:6.1f}  {k}", flush=True)
        if tk.shape != (prompt_np.shape[0], n_new) or tk.min() < 0 or tk.max() >= vocab:
            failures.append(f"{route}: bad tokens {tk.shape}")
        got = {k: runs[route][k] for k in want}
        if got != want:
            failures.append(f"{route}: launches {got}, expected {want}")
        return tk, stt

    steps = NEW_TOKENS - 1
    g8 = Generator(packed8, cfg, policy8, ecfg8, device=dev)
    prompt8 = torch.randint(0, cfg.vocab_size, (1, PROMPT_LEN), generator=wgen,
                            device=dev).cpu().numpy()
    # B=1: the W8 w13 epilogue kernel in the prefill (qkv on the plain integer
    # matmul, as the JAX engine keeps it on W8 packs), then exactly one W8
    # whole-model launch per token; o, w2 and the prefill head plain
    toks8, st8 = w8_route("w8_main", g8, prompt8, NEW_TOKENS, CHUNK_COLS,
                          {"fused_model_w4": steps, "qkv_rope": 0, "w13_gate": L,
                           "prefill_attention": L, "fused_mlp_block_w4": 0,
                           "w4a8_matmul": 0, "w4a8_matmul_stacked": 0, "w8a8_matmul": 0})
    tp8 = torch.as_tensor(prompt8, device=dev)
    pre8_dev, pre8_top, pre8_n = device_profile(
        lambda: g8.prefill(tp8, E.init_kv_cache(ecfg8, 1, device=dev)))
    serve8["w8_main"].update(prefill_device_ms=pre8_dev, prefill_kernel_launches=pre8_n,
                             prefill_top_kernels=pre8_top)
    print(f"  w8 prefill: wall {st8['prefill_s'] * 1e3:.3f} ms, device {pre8_dev:.3f} ms, "
          f"{pre8_n} launches", flush=True)
    # the 32-token prompt: the W8 MLP-block kernel in every prefill layer
    w8_route("w8_short_prompt", g8, prompt8[:, :SHORT_PROMPT], 8, 7,
             {"fused_mlp_block_w4": L, "w13_gate": 0, "fused_model_w4": 7})
    # the per-layer route: one W8 whole-layer launch per layer and step
    gpl8 = Generator(packed8, cfg, policy8,
                     dataclasses.replace(ecfg8, use_pallas=KernelConfig.decode_per_layer()),
                     device=dev)
    w8_route("w8_per_layer", gpl8, prompt8, PER_LAYER_STEPS + 1, PER_LAYER_STEPS,
             {"fused_layer_w4": PER_LAYER_STEPS * L, "fused_model_w4": 0})
    # the attn_all() route: W8 qkv and o through w8a8_matmul, the int8 decode
    # attention kernel and the W8 MLP block in every layer
    gaa8 = Generator(packed8, cfg, policy8,
                     dataclasses.replace(ecfg8, use_pallas=KernelConfig.attn_all()), device=dev)
    w8_route("w8_attn_all", gaa8, prompt8, PER_LAYER_STEPS + 1, PER_LAYER_STEPS,
             {"w8a8_matmul": 2 * L * PER_LAYER_STEPS, "decode_attention": L * PER_LAYER_STEPS,
              "fused_mlp_block_w4": L * PER_LAYER_STEPS, "fused_model_w4": 0})
    # the serving batch on the entry config: B=32 takes the W8 chunk kernel
    # (one launch a step), B=128 the staged route (the W8 MLP-block row kernel)
    gs8 = Generator(packed8, cfg, policy8, ecfg8, device=dev)
    p32w = torch.randint(0, cfg.vocab_size, (SERVE_B, PROMPT_LEN), generator=wgen,
                         device=dev).cpu().numpy()
    p128w = torch.randint(0, cfg.vocab_size, (BIG_B, SHORT_PROMPT), generator=wgen,
                          device=dev).cpu().numpy()
    if not KernelConfig.serving(cfg, gs8.packed, SERVE_B).chunk_kernel:
        failures.append("KernelConfig.serving does not take the chunk kernel for W8 at B=32")
    w8_route("w8_b32", gs8, p32w, NEW_TOKENS, CHUNK_COLS,
             {"fused_model_w4_chunk": steps, "staged_append": steps, "fused_model_w4": 0,
              "fused_mlp_block_w4": 0})
    w8_route("w8_b128", gs8, p128w, BIG_STEPS + 1, BIG_STEPS,
             {"fused_mlp_block_w4": L * BIG_STEPS, "staged_append": BIG_STEPS,
              "fused_model_w4_chunk": 0})

    # B=1 against the plain path: prefill logits, one decode() step, and the
    # witness (plain prefill, the decode() step with the W8 whole-model
    # kernel's plain version on the plain engine's numerics), which must equal
    # the plain step bit for bit
    res8 = {}
    wit8 = {(E, "fused_model_w4"): fused_model_w4_plain, **engine_numerics(E, cfg, policy8)}
    for tag, kc_p, kc_d in (("kernel", KernelConfig.prefill(), KernelConfig.decode()),
                            ("plain", KernelConfig.none(), KernelConfig.none()),
                            ("witness", KernelConfig.none(), KernelConfig.decode())):
        cache = E.init_kv_cache(ecfg8, 1, device=dev)
        lg, cache = E.forward(g8.packed, tp8, cfg, policy8, kv_cache=cache,
                              cache_position=torch.zeros(1, dtype=torch.int32, device=dev),
                              kv_valid_len=torch.full((1,), PROMPT_LEN, dtype=torch.int32,
                                                      device=dev),
                              kc=kc_p, logits_at=torch.full((1,), PROMPT_LEN - 1, device=dev))
        nxt = torch.argmax(lg[:, -1], -1)[:, None]
        p = torch.full((1,), PROMPT_LEN, dtype=torch.int32, device=dev)
        with patched(wit8 if tag == "witness" else {}):
            lg2, cache = counted(f"w8_b1_step_{tag}", lambda: E.forward(
                g8.packed, nxt, cfg, policy8, positions=p[:, None], kv_cache=cache,
                cache_position=p, kv_valid_len=p + 1, kc=kc_d))
        res8[tag] = (lg, lg2, cache, nxt)
    e8_pre = float_err(res8["kernel"][0], res8["plain"][0])
    same8 = bool(torch.equal(res8["kernel"][3], res8["plain"][3]))
    e8_dec = float_err(res8["kernel"][1], res8["plain"][1])
    e8_cache = [int8_err(res8["kernel"][2].k, res8["plain"][2].k),
                int8_err(res8["kernel"][2].v, res8["plain"][2].v)]
    e8_wit = float_err(res8["witness"][1], res8["plain"][1])
    wit8_equal = all(bool(torch.equal(getattr(res8["witness"][2], kv),
                                      getattr(res8["plain"][2], kv))) for kv in ("k", "v"))
    fin8 = all(bool(torch.isfinite(r[0]).all() and torch.isfinite(r[1]).all())
               for r in res8.values())
    print(f"  W8 prefill logits kernel vs plain: rel {e8_pre[1]:.3g}; decode step rel "
          f"{e8_dec[1]:.3g} (same input token: {same8}); K / V cache max diff, share of bytes "
          f"{e8_cache[0]} / {e8_cache[1]}; finite {fin8}; witness vs plain: logits rel "
          f"{e8_wit[1]:.3g}, caches equal {wit8_equal}", flush=True)
    if not fin8 or res8["kernel"][0].shape != (1, 1, cfg.vocab_size) or e8_pre[1] > 2e-3:
        failures.append(f"W8 prefill logits kernel vs plain rel {e8_pre[1]}, finite {fin8}")
    if same8 and e8_dec[1] > 4e-3:
        failures.append(f"W8 decode logits kernel vs plain rel {e8_dec[1]}")
    if max(e[0] for e in e8_cache) > 63 or max(e[1] for e in e8_cache) > 2.5e-3:
        failures.append(f"W8 K / V caches kernel vs plain {e8_cache}")
    if runs["w8_b1_step_witness"]["fused_model_w4"] or runs["w8_b1_step_kernel"]["fused_model_w4"] != 1 \
            or e8_wit[1] > 1e-6 or not wit8_equal:
        failures.append(f"W8 B=1 witness vs plain: logits rel {e8_wit[1]}, caches equal "
                        f"{wit8_equal}, launches {runs['w8_b1_step_witness']}")

    # one SHORT_CHAIN-step B=32 chunk fed the same tokens on the serving route
    # (the W8 chunk kernel), on that route with the kernel's plain version, on
    # that plain version moved onto the plain engine's numerics, and on the
    # plain path; held as the W4 chunk route is held above
    c32w = E.init_kv_cache(ecfg8, SERVE_B, device=dev)
    _, c32w = gs8.prefill(torch.as_tensor(p32w, device=dev), c32w)
    ftoks8 = torch.randint(0, cfg.vocab_size, (SERVE_B, CHUNK_COLS), generator=wgen,
                           device=dev)[:, :SHORT_CHAIN]
    kc_s8 = KernelConfig.serving(cfg, gs8.packed, SERVE_B)
    plain_chunk = {(E, "fused_model_w4_chunk"): fused_model_w4_chunk_plain}
    stand8 = {"w8_chunk_plain_fn": plain_chunk,
              "w8_chunk_engine_attention": {**plain_chunk, **engine_numerics(E, cfg, policy8,
                                                                             norms=False)},
              "w8_chunk_engine_norms": {**plain_chunk, **engine_numerics(E, cfg, policy8,
                                                                         attention=False)},
              "w8_chunk_engine_numerics": {**plain_chunk, **engine_numerics(E, cfg, policy8)}}
    chain8 = {}
    for tag, kc_c in (("w8_serving", kc_s8), *((w, kc_s8) for w in stand8),
                      ("w8_plain", KernelConfig.none())):
        cc = E.EngineKVCache(c32w.k.clone(), c32w.v.clone())
        with patched(stand8.get(tag, {})):
            chain8[tag] = counted(f"chain_{tag}", lambda: staged_chunk(
                kc_c, cc, ftoks8, fpos, gs8.packed, policy8))
    if runs["chain_w8_serving"]["fused_model_w4_chunk"] != SHORT_CHAIN \
            or any(runs["chain_w8_plain"].values()):
        failures.append(f"W8 chain launches {runs['chain_w8_serving']} / {runs['chain_w8_plain']}")
    # limits as the W4 route's: the kernel equals its plain version and that
    # plain version on the plain engine's numerics equals the plain path, the
    # raw gaps held to about twice their readings. On this pack the first run
    # measured the serving route against the plain path at logits rel 3.34e-3
    # with 0.51% / 0.57% of the flushed K / V bytes off by up to 2 steps (the
    # W4 pack: 2.07e-3, 0.12%, 31 steps), while both witnesses held exactly:
    # the same rounding, grown through another random model. The
    # SHORT_CHAIN-step chunk read at most 3.33e-3, 2 steps on 0.39% of the
    # flushed bytes (the serving route; its witnesses 3.01e-3 / 2.62e-3)
    for tag, ref, lim in (("w8_serving", "w8_chunk_plain_fn", (2e-3, 0, 0.0)),
                          ("w8_chunk_engine_numerics", "w8_plain", (2e-3, 0, 0.0)),
                          ("w8_chunk_engine_attention", "w8_plain", (7e-3, 4, 8e-3)),
                          ("w8_chunk_engine_norms", "w8_plain", (7e-3, 4, 8e-3)),
                          ("w8_serving", "w8_plain", (7e-3, 4, 8e-3))):
        e_l = float_err(chain8[tag][0], chain8[ref][0])
        stp = [float_err(chain8[tag][0][:, i], chain8[ref][0][:, i])[1] for i in range(SHORT_CHAIN)]
        e_k = int8_err(chain8[tag][1].k[:, :, :, window_s], chain8[ref][1].k[:, :, :, window_s])
        e_v = int8_err(chain8[tag][1].v[:, :, :, window_s], chain8[ref][1].v[:, :, :, window_s])
        fin = bool(torch.isfinite(chain8[tag][0]).all())
        chain_err[f"{tag}_vs_{ref}"] = {"logits_rel": e_l[1], "logits_rel_first_step": stp[0],
                                        "logits_rel_per_step": stp,
                                        "k_rows": e_k, "v_rows": e_v, "finite": fin}
        print(f"  W8 B={SERVE_B} {SHORT_CHAIN}-step chunk, {tag} vs {ref}: logits rel "
              f"{e_l[1]:.3g} (step 0: {stp[0]:.3g}); flushed K rows {e_k}, V rows {e_v}",
              flush=True)
        if not fin or e_l[1] > lim[0]:
            failures.append(f"{tag} chunk vs {ref}: logits rel {e_l[1]}, finite {fin}")
        if max(e_k[0], e_v[0]) > lim[1] or max(e_k[1], e_v[1]) > lim[2]:
            failures.append(f"{tag} chunk vs {ref}: flushed rows {e_k} {e_v}")

    # the attn_all() route against the plain path: the same tokens fed to both
    # from one prefill cache over PER_LAYER_STEPS steps
    _, ca8 = gaa8.prefill(tp8, E.init_kv_cache(ecfg8, 1, device=dev))
    atoks8 = torch.randint(0, cfg.vocab_size, (1, PER_LAYER_STEPS), generator=wgen, device=dev)
    aa8 = {}
    for tag, kc_a in (("attn_all", KernelConfig.attn_all()), ("plain", KernelConfig.none())):
        cc = E.EngineKVCache(ca8.k.clone(), ca8.v.clone())
        lgs = []
        for i in range(PER_LAYER_STEPS):
            pa = torch.full((1,), PROMPT_LEN + i, dtype=torch.int32, device=dev)
            lg_a, cc = E.forward(g8.packed, atoks8[:, i:i + 1], cfg, policy8,
                                 positions=pa[:, None], kv_cache=cc, cache_position=pa,
                                 kv_valid_len=pa + 1, kc=kc_a)
            lgs.append(lg_a[:, -1])
        aa8[tag] = (torch.stack(lgs, 1), cc)
    e8_al = float_err(aa8["attn_all"][0], aa8["plain"][0])
    e8_ak = int8_err(aa8["attn_all"][1].k[:, :, :, arows], aa8["plain"][1].k[:, :, :, arows])
    e8_av = int8_err(aa8["attn_all"][1].v[:, :, :, arows], aa8["plain"][1].v[:, :, :, arows])
    print(f"  W8 attn_all route vs plain over {PER_LAYER_STEPS} steps: logits rel "
          f"{e8_al[1]:.3g}; written K rows {e8_ak}, V rows {e8_av}", flush=True)
    if e8_al[1] > 2e-3 or not bool(torch.isfinite(aa8["attn_all"][0]).all()):
        failures.append(f"W8 attn_all route vs plain: logits rel {e8_al[1]}")
    if max(e8_ak[0], e8_av[0]) > 1 or max(e8_ak[1], e8_av[1]) > 1e-3:
        failures.append(f"W8 attn_all route vs plain: written rows {e8_ak} {e8_av}")

    # ---- phase 2q: the weight-only kernels against their plain versions ----
    # (packs and a generator of their own). Row 12 at M = 1 and 8 on the
    # TinyLlama projections of the W4 g128 pack phase 3w serves (bf16 rows,
    # layers rotated while timing) and of L-layer W4 / W8 per-channel stacks;
    # row 13 at M = 1, 8, 128 on q. Yardstick: torch.matmul of the bf16 rows
    # on the weight dequantized once to bf16 (cuBLAS on 4x the W4 bytes)
    phase("phase 2q: weight-only kernels vs plain versions, TinyLlama-1.1B W4A16 / W8A16")
    qgen = torch.Generator(device=dev).manual_seed(SEED + 5)
    pk_w16, _, pol_w16, ecfg_w16 = build_synthetic_wonly(
        "tinyllama-1.1b", w_bits=4, group_size=128, head_bits=16, act_dtype=torch.bfloat16,
        max_seq_len=MAX_SEQ, seed=SEED, device=dev)

    def pc_stack(bits, K, N, n_layers=L):
        ps = [qops.pack_weight(torch.randn((K, N), generator=qgen, device=dev) * 0.02,
                               QuantConfig(bitwidth=bits, is_per_channel=True))
              for _ in range(n_layers)]
        out = {k: torch.stack([p[k] for p in ps]) for k in ("wq", "scale", "offset")}
        out["bias"] = torch.zeros((n_layers, N), device=dev)
        return out

    proj_shapes = (("q", "q_proj", D, Hq * hd), ("k/v", "k_proj", D, Hkv * hd),
                   ("o", "o_proj", Hq * hd, D), ("w1/w3", "w1", D, F), ("w2", "w2", F, D))
    wq_layer_bytes = {}
    for tag_c, packs_c in (("W4 g128", pk_w16["packs"]),
                           ("W4 pc", {key: pc_stack(4, K, N) for _, key, K, N in proj_shapes}),
                           ("W8 pc", {key: pc_stack(8, K, N) for _, key, K, N in proj_shapes})):
        for tag_p, key, K, N in proj_shapes:
            pk = packs_c[key]
            Lc, Kr = pk["wq"].shape[0], pk["wq"].shape[1]
            G = pk["scale"].shape[1] if pk["scale"].dim() == 4 else 1
            lb = Kr * N + 2 * G * N * 4 + N * 4
            wq_layer_bytes[(tag_c, key)] = lb
            # the kernel's loop reads one layer a call, over copies of the
            # stack; the yardstick's over bf16 copies of the layers: both
            # read at least 100 MB a pass, past the 50 MB L2
            args = (pk["wq"], pk["scale"], pk["offset"], pk["bias"])
            stacks = [args] + [tuple(t.clone() for t in args)
                               for _ in range(cold_count(lb * Lc, 64) - 1)]
            n_k = max(20, cold_count(lb, Lc * len(stacks)))
            w_bf = [qops.dequant_weight(pk["wq"][j % Lc], pk["scale"][j % Lc],
                                        pk["offset"][j % Lc], K).to(torch.bfloat16)
                    for j in range(cold_count(2 * K * N, 128))]
            for Mr in (1, 8):
                x = torch.randn((Mr, K), generator=qgen, device=dev).to(torch.bfloat16)
                out = wonly_matmul_stacked(x, *args, 1)
                ref = wonly_matmul_stacked_plain(x, *args, 1)
                err = float_err(out, ref)
                ms = time_ms(lambda i, x=x, stacks=stacks, Lc=Lc: wonly_matmul_stacked(
                    x, *stacks[(i // Lc) % len(stacks)], i % Lc), n=n_k)
                plain_ms = time_ms(lambda i, x=x, args=args: wonly_matmul_stacked_plain(
                    x, *args, 1), n=5)
                lib_ms = time_ms(lambda i, x=x, w_bf=w_bf: torch.matmul(
                    x, w_bf[i % len(w_bf)]), n=max(20, len(w_bf)))
                record("wonly_matmul_stacked", f"{tag_c} M={Mr} {tag_p} {K}->{N}", err,
                       err[1] <= 1e-5, ms, plain_ms, lib_ms,
                       bound(wq_layer_bytes[(tag_c, key)] + Mr * K * 2 + Mr * N * 4,
                             fp16_ops=2.0 * Mr * K * N),   # bf16 rows: one term
                       note="library: torch.matmul, bf16 rows x the bf16-dequantized weight",
                       main=(tag_c, tag_p, Mr) == ("W4 g128", "w1/w3", 1))
            del w_bf, stacks
    # row 13: per-channel W4 q matrices (fp32 rows), one checked, enough of
    # them rotated while timing to read past the L2
    Nq13 = Hq * hd
    pk13 = pc_stack(4, D, Nq13, cold_count(D // 2 * Nq13, 64))
    w13s = [(pk13["wq"][j], pk13["scale"][j], pk13["offset"][j], pk13["bias"][j])
            for j in range(pk13["wq"].shape[0])]
    w13a = w13s[0]
    w_bf13 = [qops.dequant_weight(*w[:3], D).to(torch.bfloat16)
              for w in w13s[:cold_count(2 * D * Nq13, len(w13s))]]
    for Mr in (1, 8, PROMPT_LEN):
        x = torch.randn((Mr, D), generator=qgen, device=dev)
        err = float_err(w4a16_matmul(x, *w13a), w4a16_matmul_plain(x, *w13a))
        ms = time_ms(lambda i, x=x: w4a16_matmul(x, *w13s[i % len(w13s)]), n=len(w13s))
        plain_ms = time_ms(lambda i, x=x: w4a16_matmul_plain(x, *w13a), n=5)
        xb = x.to(torch.bfloat16)
        lib_ms = time_ms(lambda i, xb=xb: torch.matmul(xb, w_bf13[i % len(w_bf13)]),
                         n=max(20, len(w_bf13)))
        Nq = Hq * hd
        record("w4a16_matmul", f"M={Mr} q {D}->{Nq} (W4 per channel)", err, err[1] <= 1e-5,
               ms, plain_ms, lib_ms,
               bound(D // 2 * Nq + 3 * Nq * 4 + Mr * D * 4 + Mr * Nq * 4,
                     fp16_ops=3 * 2.0 * Mr * D * Nq),   # fp32 rows: three bf16 terms
               note="library: torch.matmul, bf16 rows x the bf16-dequantized weight",
               main=Mr == 1)
    del pk13, w13s, w13a, w_bf13
    # every edition the wrappers take, checked against the plain versions (not
    # timed; a generator of their own): row 12 W4 / W8 x per tensor / per
    # channel / g128 x fp32 / bf16 rows at M = 1, 3, 8 (q, 2048 -> 2048, layer
    # 1 of 2), and packs of one-signed weights (offsets far outside the code
    # range, W8 about -1000) per channel / g128 at M = 1, 8; row 13 per tensor
    # / per channel x fp32 / bf16 at M = 1, 8, 100, 128, per channel at
    # 2048 -> 512 and 512 -> 2048 (M = 100, 128: small splits, whose 64-row
    # sums outgrow the staged x), w2's 5632 -> 2048 (M = 100: 8-row tiles past
    # 2048 weight rows) and one-signed at M = 1, 100, 128
    egen = torch.Generator(device=dev).manual_seed(SEED + 10)

    def ed_stack(bits, kind, n_layers, K=D, N=Nq13, mean=0.0):
        cfg_q = QuantConfig(bitwidth=bits, is_per_channel=kind != "tensor",
                            group_size=128 if kind == "g128" else -1)
        ps = [qops.pack_weight(torch.randn((K, N), generator=egen, device=dev) * 0.02 + mean,
                               cfg_q) for _ in range(n_layers)]
        out = {k: torch.stack([p[k] for p in ps]) for k in ("wq", "scale", "offset")}
        out["bias"] = torch.randn((n_layers, N), generator=egen, device=dev) * 0.01
        return out

    def ed_check(name, shape, out, ref):
        err = float_err(out, ref)
        checks.append({"name": name, "shape": shape, "max_abs_err": err[0], "rel": err[1],
                       "ok": err[1] <= 1e-5})
        if err[1] > 1e-5:
            failures.append(f"{name} {shape}: error {err}")
        return err[1]

    for bits, kind, mean, mrs in (
            [(b, k, 0.0, (1, 3, 8)) for b in (4, 8) for k in ("tensor", "channel", "g128")]
            + [(b, k, 0.5, (1, 8)) for b in (4, 8) for k in ("channel", "g128")]):
        pk_e = ed_stack(bits, kind, 2, mean=mean)
        args = (pk_e["wq"], pk_e["scale"], pk_e["offset"], pk_e["bias"])
        tag = f"W{bits} {kind}{' one-signed' if mean else ''}"
        worst = 0.0
        for xdt in (torch.float32, torch.bfloat16):
            for Mr in mrs:
                x = torch.randn((Mr, D), generator=egen, device=dev).to(xdt)
                worst = max(worst, ed_check(
                    "wonly_matmul_stacked", f"{tag} {str(xdt)[6:]} M={Mr}",
                    wonly_matmul_stacked(x, *args, 1), wonly_matmul_stacked_plain(x, *args, 1)))
        print(f"  wonly_matmul_stacked {tag}, fp32 / bf16 rows, M = {mrs}: "
              f"worst rel {worst:.3g}", flush=True)
    for kind, K, N, mean, mrs in (("tensor", D, Nq13, 0.0, (1, 8, 100, PROMPT_LEN)),
                                   ("channel", D, Nq13, 0.0, (1, 8, 100, PROMPT_LEN)),
                                   ("channel", D, 512, 0.0, (100, PROMPT_LEN)),
                                   ("channel", 512, Nq13, 0.0, (100, PROMPT_LEN)),
                                   ("channel", F, D, 0.0, (100,)),
                                   ("channel", D, Nq13, 0.5, (1, 100, PROMPT_LEN))):
        pk_e = ed_stack(4, kind, 1, K, N, mean)
        w_e = (pk_e["wq"][0], pk_e["scale"][0], pk_e["offset"][0], pk_e["bias"][0])
        tag = f"{kind} {K}->{N}{' one-signed' if mean else ''}"
        worst = 0.0
        for xdt in (torch.float32, torch.bfloat16):
            for Mr in mrs:
                x = torch.randn((Mr, K), generator=egen, device=dev).to(xdt)
                worst = max(worst, ed_check("w4a16_matmul", f"{tag} {str(xdt)[6:]} M={Mr}",
                                            w4a16_matmul(x, *w_e), w4a16_matmul_plain(x, *w_e)))
        print(f"  w4a16_matmul {tag}, fp32 / bf16 rows, M = {mrs}: worst rel {worst:.3g}",
              flush=True)
    del pk_e

    # ---- phase 3w: weight-only serving through the entry points -----------
    # Generator(ecfg.act_bits=16).generate_fast at B=1 on TinyLlama-1.1B
    # W4A16 g128 (bf16 activations, fp KV cache), with the fp head (the JAX
    # bench's w4a16 row) and the W4 head (w4a16_h4): the prefill takes no
    # kernel, every decode projection one wonly_matmul_stacked launch, the W4
    # head one w4a8_matmul launch a token
    phase("phase 3w: generate_fast, TinyLlama-1.1B W4A16 g128, bf16, fp KV, B=1")
    wonly = {}
    prompt_w = torch.randint(0, cfg.vocab_size, (1, PROMPT_LEN), generator=qgen,
                             device=dev).cpu().numpy()
    n_proj = 7
    for route, hb in (("wonly_main", 16), ("wonly_h4", 4)):
        if hb == 16:
            gw = Generator(pk_w16, cfg, pol_w16, ecfg_w16, device=dev)
        else:
            pk_h, _, pol_h, ecfg_h = build_synthetic_wonly(
                "tinyllama-1.1b", w_bits=4, group_size=128, head_bits=4,
                act_dtype=torch.bfloat16, max_seq_len=MAX_SEQ, seed=SEED, device=dev)
            gw = Generator(pk_h, cfg, pol_h, ecfg_h, device=dev)
        gw.generate_fast(prompt_w, 4)                         # warm-up
        tk, stt = counted(route, lambda: gw.generate_fast(prompt_w, HOST_NEW,
                                                          return_stats=True))
        nums = loop_numbers(gw, prompt_w, HOST_LOOP)
        tpw = torch.as_tensor(prompt_w, device=dev)
        pre_d, pre_t, pre_l = device_profile(lambda: gw.prefill(tpw, gw.init_cache(1)))
        nums.update(decode_tok_s=stt["decode_tok_s"], prefill_ms=stt["prefill_s"] * 1e3,
                    prefill_device_ms=pre_d, prefill_kernel_launches=pre_l,
                    prefill_top_kernels=pre_t, launches=runs[route], batch=1,
                    prompt=PROMPT_LEN, new_tokens=HOST_NEW)
        wonly[route] = nums
        print(f"  {route}: decode {stt['decode_tok_s']:.2f} tok/s (generate_fast), prefill "
              f"{stt['prefill_s'] * 1e3:.2f} ms wall / {pre_d:.3f} ms device ({pre_l} "
              f"launches), loop step wall {nums['wall_ms_per_step']:.3f} ms, device "
              f"{nums['device_ms_per_step']:.3f} ms, idle {nums['idle_share']:.3f}, "
              f"{nums['launches_per_step']:.1f} launches/step; counts {runs[route]}", flush=True)
        for k, ms_, c in nums["top_kernels"]:
            print(f"    {route}/step {ms_:8.4f} ms  x{c:6.1f}  {k}", flush=True)
        if tk.shape != (1, HOST_NEW) or tk.min() < 0 or tk.max() >= cfg.vocab_size:
            failures.append(f"{route}: bad tokens {tk.shape}")
        steps_w = HOST_NEW - 1
        want = {"wonly_matmul_stacked": n_proj * L * steps_w,
                "w4a8_matmul": steps_w if hb == 4 else 0, "w4a16_matmul": 0,
                "fused_model_w4": 0, "w4a8_matmul_stacked": 0}
        got = {k: runs[route][k] for k in want}
        if got != want:
            failures.append(f"{route}: launches {got}, expected {want}")
        if hb == 4:
            del pk_h, gw
    # kernel route against the plain route: a prefill, then 16 decode steps fed
    # the same tokens, in fp32 activations (a pack of its own, the same seed)
    # and in the bf16 pack served above
    pk_w32, _, pol_w32, ecfg_w32 = build_synthetic_wonly(
        "tinyllama-1.1b", w_bits=4, group_size=128, head_bits=16, act_dtype=torch.float32,
        max_seq_len=MAX_SEQ, seed=SEED, device=dev)
    wtoks = torch.randint(0, cfg.vocab_size, (1, 16), generator=qgen, device=dev)
    wchain = {}
    for tag, pk_c, ecfg_c in (("fp32", pk_w32, ecfg_w32), ("bf16", pk_w16, ecfg_w16)):
        gc = Generator(pk_c, cfg, None, ecfg_c, device=dev)
        _, c0 = gc.prefill(torch.as_tensor(prompt_w, device=dev), gc.init_cache(1))
        res_w = {}
        for route_k in (True, False):
            cc = MM.KVCache(c0.k.clone(), c0.v.clone())
            lgs = []

            def chain_w(cc=cc, lgs=lgs, route_k=route_k):
                for i in range(wtoks.shape[1]):
                    pw = torch.full((1,), PROMPT_LEN + i, dtype=torch.int32, device=dev)
                    lg_w, _ = W.forward(gc.packed, wtoks[:, i:i + 1], cfg, positions=pw[:, None],
                                        kv_cache=cc, cache_position=pw, kv_valid_len=pw + 1,
                                        kc=KernelConfig.decode() if route_k else KernelConfig())
                    lgs.append(lg_w[:, -1])
                return torch.stack(lgs, 1)
            res_w[route_k] = counted(f"wonly_chain_{tag}_{'kernel' if route_k else 'plain'}",
                                     chain_w)
        e_w = float_err(res_w[True], res_w[False])
        fin = bool(torch.isfinite(res_w[True]).all())
        wchain[tag] = {"logits_rel": e_w[1], "max_abs": e_w[0], "finite": fin}
        print(f"  weight-only {tag} 16-step chain, kernel route vs plain route: logits rel "
              f"{e_w[1]:.3g} (max abs {e_w[0]:.3g})", flush=True)
        n_k = runs[f"wonly_chain_{tag}_kernel"]["wonly_matmul_stacked"]
        if n_k != n_proj * L * 16 or any(runs[f"wonly_chain_{tag}_plain"].values()):
            failures.append(f"weight-only {tag} chain launches {n_k}")
        # bf16: one bf16 rounding of a projection output in another sum order,
        # grown through 22 layers; held at about twice its first reading on the
        # card (2.14e-2)
        lim = 1e-4 if tag == "fp32" else 5e-2
        if not fin or e_w[1] > lim:
            failures.append(f"weight-only {tag} chain kernel vs plain: logits rel {e_w[1]}")
        del gc
    del pk_w32

    # ---- phase 3f: W8A8/h8 on the int4 KV cache ---------------------------
    # generate_fast at B = 1, 32, 128 on the entry config: every step staged,
    # one kv4 launch and one W8 MLP-block launch a layer, qkv / o / the W8
    # head on the plain integer matmul; then a SHORT_CHAIN-step B=32 chunk fed
    # the same tokens on that route, with the kv4 kernel's plain version, on
    # the plain engine's numerics (kv4_engine_numerics) and on the plain path
    phase("phase 3f: W8A8/h8 on the int4 KV cache, TinyLlama-1.1B, relaxed")
    fgen = torch.Generator(device=dev).manual_seed(SEED + 6)
    packed8k, _, strict8k, ecfg8k = build_synthetic_packed(
        "tinyllama-1.1b", w_bits=8, head_bits=8, max_seq_len=MAX_SEQ, seed=SEED, device=dev,
        kv_bits=4)
    policy8k = relax_16bit(strict8k)
    g8k = Generator(packed8k, cfg, policy8k, ecfg8k, device=dev)
    for route, Bq, Tp, n_new, n_loop in (("w8kv4_b1", 1, PROMPT_LEN, HOST_NEW, HOST_LOOP),
                                         ("w8kv4_b32", SERVE_B, PROMPT_LEN, HOST_NEW,
                                          HOST_LOOP),
                                         ("w8kv4_b128", BIG_B, SHORT_PROMPT, BIG_STEPS + 1,
                                          BIG_STEPS)):
        steps = n_new - 1
        pr = torch.randint(0, cfg.vocab_size, (Bq, Tp), generator=fgen, device=dev).cpu().numpy()
        w8_route(route, g8k, pr, n_new, n_loop,
                 {"kv4_decode_attention": L * steps, "staged_append": steps,
                  "fused_mlp_block_w4": L * steps, "fused_model_w4": 0,
                  "fused_model_w4_chunk": 0, "qkv_rope": 0, "w8a8_matmul": 0,
                  "prefill_attention": L, "w13_gate": L})
    c8k = E.init_kv_cache(ecfg8k, SERVE_B, device=dev)
    p8k = torch.randint(0, cfg.vocab_size, (SERVE_B, PROMPT_LEN), generator=fgen, device=dev)
    _, c8k = g8k.prefill(p8k, c8k)
    ftoks8k = torch.randint(0, cfg.vocab_size, (SERVE_B, CHUNK_COLS), generator=fgen,
                            device=dev)[:, :SHORT_CHAIN]
    kc8k = KernelConfig.serving(cfg, g8k.packed, SERVE_B)
    stand8k = {"w8kv4_kernel_plain_fn": {(E, "kv4_decode_attention"): kv4_decode_attention_plain},
               "w8kv4_engine_numerics": kv4_engine_numerics(E, cfg, g8k.packed, policy8k)}
    chain8k = {}
    for tag, kc_c in (("w8kv4_kernel", kc8k), ("w8kv4_kernel_plain_fn", kc8k),
                      ("w8kv4_engine_numerics", kc8k), ("w8kv4_plain", KernelConfig.none())):
        cc = E.EngineKVCache(c8k.k.clone(), c8k.v.clone())
        with patched(stand8k.get(tag, {})):
            lg_c, cc = counted(f"chain_{tag}", lambda: staged_chunk(
                kc_c, cc, ftoks8k, fpos, g8k.packed, policy8k, kv4=True))
        chain8k[tag] = (lg_c, qops.unpack_kv_s(cc.k)[:, :, :, window_s],
                        qops.unpack_kv_s(cc.v)[:, :, :, window_s])
    wit8k = runs["chain_w8kv4_engine_numerics"]
    if runs["chain_w8kv4_kernel"]["kv4_decode_attention"] != L * SHORT_CHAIN \
            or runs["chain_w8kv4_kernel"]["fused_mlp_block_w4"] != L * SHORT_CHAIN \
            or any(runs["chain_w8kv4_plain"].values()) \
            or wit8k["kv4_decode_attention"] or wit8k["fused_mlp_block_w4"]:
        failures.append(f"W8 kv4 chain launches {runs['chain_w8kv4_kernel']} / {wit8k} / "
                        f"{runs['chain_w8kv4_plain']}")
    # limits as phase 3c's: the kernel equals its plain version and the route
    # on the plain engine's numerics equals the plain path; the raw route
    # against the plain path is held at about twice its first reading on the
    # card (logits rel 4.96e-3, one 4-bit step on 0.052% / 0.048% of the K /
    # V values: the same rounding through another random model); the
    # SHORT_CHAIN-step chunk read 3.64e-3, one step on 0.019% of the values
    for tag, ref, lim in (("w8kv4_kernel", "w8kv4_kernel_plain_fn", (1e-6, 0, 0.0)),
                          ("w8kv4_engine_numerics", "w8kv4_plain", (1e-6, 0, 0.0)),
                          ("w8kv4_kernel", "w8kv4_plain", (7.3e-3, 1, 3.8e-4))):
        e_l = float_err(chain8k[tag][0], chain8k[ref][0])
        stp = [float_err(chain8k[tag][0][:, i], chain8k[ref][0][:, i])[1]
               for i in range(SHORT_CHAIN)]
        e_k = int8_err(chain8k[tag][1], chain8k[ref][1])
        e_v = int8_err(chain8k[tag][2], chain8k[ref][2])
        fin = bool(torch.isfinite(chain8k[tag][0]).all())
        chain_err[f"{tag}_vs_{ref}"] = {"logits_rel": e_l[1], "logits_rel_first_step": stp[0],
                                        "logits_rel_per_step": stp,
                                        "k_rows": e_k, "v_rows": e_v, "finite": fin}
        print(f"  W8 kv4 B={SERVE_B} {SHORT_CHAIN}-step chunk, {tag} vs {ref}: logits rel "
              f"{e_l[1]:.3g} (step 0: {stp[0]:.3g}); flushed K rows {e_k}, V rows {e_v} "
              f"(max diff in 4-bit steps, share of values)", flush=True)
        if not fin or e_l[1] > lim[0]:
            failures.append(f"{tag} W8 kv4 chunk vs {ref}: logits rel {e_l[1]}, finite {fin}")
        if max(e_k[0], e_v[0]) > lim[1] or max(e_k[1], e_v[1]) > lim[2]:
            failures.append(f"{tag} W8 kv4 chunk vs {ref}: flushed rows {e_k} {e_v}")
    del packed8k, g8k, c8k

    # ---- phase 2m: the alternate MLP routes' kernels against their plain versions
    # (inputs from a generator of their own, so the earlier phases' inputs
    # stay as they were). Rows 16 and 17 on the W8A8/h8 pack's per-layer
    # packs, row 18's W8 edition and row 19 (W4 and W8) on the stacked ones;
    # the layer rotates while timing (22 layers of 34.6 MB of W8 MLP weights
    # a pass, past the 50 MB L2). Row 19 beside its split path: w13_gate then
    # the w2 matmul the JAX split route runs (W4: w4a8_matmul_stacked; W8:
    # the plain integer matmul). Rows 16 and 17 also at the test-llama width
    # (hidden 64, F 128), the narrowest the tile kernel takes.
    phase("phase 2m: alternate MLP routes' kernels vs plain versions, TinyLlama-1.1B")
    mgen = torch.Generator(device=dev).manual_seed(SEED + 7)
    meta16 = meta8[:16]
    w13_vec = 2 * F * 4 * 4                                 # scale / offset / colsum / bias
    mlp_routes = {}
    for Mr in (1, 8, PROMPT_LEN):
        h8m = torch.randint(-128, 128, (Mr, D), generator=mgen, device=dev, dtype=torch.int8)
        out = fused_mlp(h8m, layer_pack(w13w, 1), layer_pack(w2w, 1), meta16, cfg.hidden_act)
        ref = fused_mlp_plain(h8m, layer_pack(w13w, 1), layer_pack(w2w, 1), meta16,
                              cfg.hidden_act)
        e_acc, e_rs = float_err(out[0], ref[0]), float_err(out[1], ref[1])
        ms = time_ms(lambda i, h=h8m: fused_mlp(h, layer_pack(w13w, i % L), layer_pack(w2w, i % L),
                                                meta16, cfg.hidden_act))
        plain_ms = time_ms(lambda i, h=h8m: fused_mlp_plain(
            h, layer_pack(w13w, 1), layer_pack(w2w, 1), meta16, cfg.hidden_act), n=5)
        record("fused_mlp", f"M={Mr} {D}->2x{F}->{D} raw sums", (max(e_acc[0], e_rs[0]),
               max(e_acc[1], e_rs[1])), e_acc[0] == 0 and e_rs[0] == 0, ms, plain_ms, None,
               bound(Mr * D + mlp_w8 + w13_vec + Mr * D * 4 + Mr * 4,
                     int8_ops=2.0 * Mr * (D * 2 * F + F * D)),
               note="acc and rsum held exactly", main=Mr == 1)
    x_ln = None
    for Mr, nk, mk in ((1, "rmsnorm", "mxu"), (1, "rmsnorm", "vpu"), (8, "rmsnorm", "mxu"),
                       (PROMPT_LEN, "rmsnorm", "mxu"), (8, "layernorm", "mxu")):
        x = torch.randn((Mr, D), generator=mgen, device=dev)
        args = (mn8["w"][1], mn8["b"][1], layer_pack(w13w, 1), layer_pack(w2w, 1), meta8,
                cfg.hidden_act, nk)
        out = fused_mlp_block(x, *args, mk)
        err = float_err(out, fused_mlp_block_plain(x, *args))
        ms = time_ms(lambda i, x=x, nk=nk, mk=mk: fused_mlp_block(
            x, mn8["w"][i % L], mn8["b"][i % L], layer_pack(w13w, i % L), layer_pack(w2w, i % L),
            meta8, cfg.hidden_act, nk, mk))
        plain_ms = time_ms(lambda i, x=x: fused_mlp_block_plain(x, *args), n=5)
        record("fused_mlp_block", f"M={Mr} {nk} {mk} {D}->2x{F}->{D}", err, err[1] <= 2e-3,
               ms, plain_ms, None,
               bound(2 * Mr * D * 4 + mlp_w8 + mlp_vec, int8_ops=2.0 * Mr * (D * 2 * F + F * D)),
               main=(Mr, mk) == (1, "mxu"))
    # row 18's W8 edition at M = 32 and 128
    op8 = ly8["o_proj"]
    omet8 = meta8 + E._otail_meta_ext(lr8, policy8)
    oso8 = E._otail_site_on(policy8)
    for Mr in (SERVE_B, BIG_B):
        x = torch.randn((Mr, D), generator=mgen, device=dev)
        a8 = torch.randint(-128, 128, (Mr, Ko), generator=mgen, device=dev, dtype=torch.int8)
        out = fused_otail_block_w4(a8, x, op8, mn8["w"], mn8["b"], w13w, w2w, omet8, 1,
                                   cfg.hidden_act, so8, oso8)
        plain = lambda i, x=x, a8=a8: fused_otail_block_w4_plain(    # noqa: E731
            a8, x, layer_pack(op8, 1), mn8["w"][1], mn8["b"][1], layer_pack(w13w, 1),
            layer_pack(w2w, 1), omet8, cfg.hidden_act, so8, oso8)
        err = float_err(out, plain(0))
        ms = time_ms(lambda i, x=x, a8=a8: fused_otail_block_w4(
            a8, x, op8, mn8["w"], mn8["b"], w13w, w2w, omet8, i % L, cfg.hidden_act, so8, oso8))
        plain_ms = time_ms(plain, n=5)
        record("fused_otail_block_w4[w8]", f"M={Mr} {Ko}->{D} + MLP block", err, err[1] <= 2e-3,
               ms, plain_ms, None,
               bound(Mr * Ko + 2 * Mr * D * 4 + Ko * D + mlp_w8 + mlp_vec + D * 16,
                     int8_ops=2.0 * Mr * (Ko * D + D * 2 * F + F * D)),
               main=Mr == SERVE_B)
    # row 19, W4 (the W4A8 pack of phases 2-3) and W8, at M = 128 and 1024
    lr4 = E.layer_ranges(packed["ranges"], 1)
    meta4, so4 = E._mlp_block_meta(lr4, policy, cfg), E._mlp_block_site_on(policy)
    mlp_w4 = D * F + F * D // 2
    for wb, pk, met, so, wbytes in ((4, ly, meta4, so4, mlp_w4), (8, ly8, meta8, so8, mlp_w8)):
        w13p, w2p = pk["w13_proj"], pk["w2"]
        name = "w13_gate_w2" if wb == 4 else "w13_gate_w2[w8]"
        for Mr in (PROMPT_LEN, MAX_SEQ):
            h8m = torch.randint(-128, 128, (Mr, D), generator=mgen, device=dev, dtype=torch.int8)
            out = w13_gate_w2(h8m, w13p, w2p, met, 1, cfg.hidden_act, so[1:5])
            ref = w13_gate_w2_plain(h8m, layer_pack(w13p, 1), layer_pack(w2p, 1), met,
                                    cfg.hidden_act, so[1:5])
            err = float_err(out, ref)
            ms = time_ms(lambda i, h=h8m: w13_gate_w2(h, w13p, w2p, met, i % L, cfg.hidden_act,
                                                      so[1:5]))
            plain_ms = time_ms(lambda i, h=h8m: w13_gate_w2_plain(
                h, layer_pack(w13p, 1), layer_pack(w2p, 1), met, cfg.hidden_act, so[1:5]), n=5)
            w2in = lr4["mlp.w2"]["input"] if wb == 4 else lr8["mlp.w2"]["input"]

            def split(i, h=h8m, w13p=w13p, w2p=w2p, met=met, so=so, wb=wb, w2in=w2in):
                a = w13_gate(h, w13p, met, i % L, cfg.hidden_act, so[1:5])
                if wb == 4:
                    return w4a8_matmul_stacked(a, w2p, w2in["scale"], w2in["offset"], i % L)
                return E._int_linear(a, w2in, w2p, i % L, KernelConfig(w4_matmul=True))
            split_ms = time_ms(split, n=5)
            mlp_routes[f"{name} M={Mr} split_ms"] = split_ms
            record(name, f"M={Mr} {D}->2x{F}->{D}", err, err[1] <= 2e-3, ms, plain_ms, None,
                   bound(Mr * D + wbytes + w13_vec + D * 16 + Mr * D * 4,
                         int8_ops=2.0 * Mr * (D * 2 * F + F * D)),
                   note=f"split path (w13_gate, then the w2 matmul of the JAX split route) "
                        f"{split_ms:.4f} ms", main=Mr == PROMPT_LEN)
    # the test-llama width (hidden 64, F 128): the tile kernel's narrowest shapes
    packed_t, cfg_t, pol_t, _ = build_synthetic_packed("test-llama", w_bits=8, head_bits=8,
                                                       max_seq_len=64, seed=SEED, device=dev)
    pol_t = relax_16bit(pol_t)
    lyt = packed_t["layers"]
    met_t = E._mlp_block_meta(E.layer_ranges(packed_t["ranges"], 1), pol_t, cfg_t)
    w13t, w2t = layer_pack(lyt["w13_proj"], 1), layer_pack(lyt["w2"], 1)
    ht = torch.randint(-128, 128, (5, cfg_t.hidden_size), generator=mgen, device=dev,
                       dtype=torch.int8)
    xt = torch.randn((5, cfg_t.hidden_size), generator=mgen, device=dev)
    nargs = (lyt["mlp_norm"]["w"][1], lyt["mlp_norm"]["b"][1], w13t, w2t, met_t)
    narrow = {"fused_mlp": [float_err(a, r) for a, r in zip(
                  fused_mlp(ht, w13t, w2t, met_t[:16]), fused_mlp_plain(ht, w13t, w2t,
                                                                          met_t[:16]))],
              "fused_mlp_block": [float_err(fused_mlp_block(xt, *nargs, norm_kind=nk),
                                            fused_mlp_block_plain(xt, *nargs, norm_kind=nk))
                                  for nk in ("rmsnorm", "layernorm")]}
    mlp_routes["test_llama_width_errors"] = narrow
    print(f"  test-llama width (M=5, hidden 64, F 128): fused_mlp {narrow['fused_mlp']}, "
          f"fused_mlp_block (rms, ln) {narrow['fused_mlp_block']}", flush=True)
    if any(e[0] for e in narrow["fused_mlp"]) \
            or any(e[1] > 2e-3 for e in narrow["fused_mlp_block"]):
        failures.append(f"rows 16 / 17 at the test-llama width: {narrow}")
    del packed_t

    # ---- phase 3m: the alternate MLP routes through the entry points ---------
    phase("phase 3m: the alternate MLP routes, TinyLlama-1.1B W8A8/h8 (W4A8/h4 for the "
          "w2-folded prefill)")
    # B=1 generate_fast on EngineConfig(use_pallas=<legacy mode>): the prefill
    # set, then every decode step staged with the route's kernel in each layer
    # (these host-bound routes' per-step loop readings over PER_LAYER_STEPS
    # steps, which keeps the run near ten minutes)
    steps = HOST_NEW - 1
    for mode, kernel in (("mlp", "fused_mlp"), ("mlpblock", "fused_mlp_block"),
                         ("mlpblockvpu", "fused_mlp_block")):
        gm = Generator(packed8, cfg, policy8, dataclasses.replace(ecfg8, use_pallas=mode),
                       device=dev)
        w8_route(f"w8_{mode}", gm, prompt8, HOST_NEW, PER_LAYER_STEPS,
                 {kernel: L * steps, "staged_append": steps, "fused_model_w4": 0,
                  "fused_mlp_block_w4": 0, "w13_gate": L, "prefill_attention": L})
    # the W8 staged route under KernelConfig.otail() at B = 32 and 128
    go8 = Generator(packed8, cfg, policy8,
                    dataclasses.replace(ecfg8, use_pallas=KernelConfig.otail()), device=dev)
    w8_route("w8_otail_b32", go8, p32w, HOST_NEW, PER_LAYER_STEPS,
             {"fused_otail_block_w4": L * steps, "staged_append": steps,
              "fused_model_w4_chunk": 0, "fused_mlp_block_w4": 0})
    w8_route("w8_otail_b128", go8, p128w, BIG_STEPS + 1, BIG_STEPS,
             {"fused_otail_block_w4": L * BIG_STEPS, "staged_append": BIG_STEPS,
              "fused_model_w4_chunk": 0, "fused_mlp_block_w4": 0})
    # one SHORT_CHAIN-step B=32 chunk fed the same tokens on the W8 o-tail
    # route, on that route with the kernel's plain version, and on the plain
    # path (the prefill cache and tokens of phase 3e's chain)
    def otail_plain(a8, x, o, nw, nb, w13, w2, meta, layer, act_kind="silu",
                    site_on=(True,) * 9, osite_on=(True,) * 4, norm_kind="rmsnorm"):
        return fused_otail_block_w4_plain(a8, x, layer_pack(o, layer), nw[layer], nb[layer],
                                          layer_pack(w13, layer), layer_pack(w2, layer), meta,
                                          act_kind, site_on, osite_on, norm_kind)
    # the same chunk on the "mlp" and "mlpblock" routes (decode_loop's config
    # for the legacy value at B=32), which holds the engine's side of each
    # route (the "mlp" route's w2 epilogue and resid_add_2) on the card
    chaino = {}
    for tag, kc_c, stand in (("w8_otail", KernelConfig.otail(), {}),
                             ("w8_otail_plain_fn", KernelConfig.otail(),
                              {(E, "fused_otail_block_w4"): otail_plain}),
                             ("w8_mlp", KernelConfig.serving(cfg, packed8, SERVE_B, "mlp"), {}),
                             ("w8_mlpblock",
                              KernelConfig.serving(cfg, packed8, SERVE_B, "mlpblock"), {}),
                             ("w8_otail_ref_plain", KernelConfig.none(), {})):
        cc = E.EngineKVCache(c32w.k.clone(), c32w.v.clone())
        with patched(stand):
            chaino[tag] = counted(f"chain_{tag}", lambda: staged_chunk(
                kc_c, cc, ftoks8, fpos, go8.packed, policy8))
    if runs["chain_w8_otail"]["fused_otail_block_w4"] != L * SHORT_CHAIN \
            or runs["chain_w8_otail_plain_fn"]["fused_otail_block_w4"] \
            or any(runs["chain_w8_otail_ref_plain"].values()):
        failures.append(f"W8 o-tail chain launches {runs['chain_w8_otail']}")
    for tag, kernel in (("w8_mlp", "fused_mlp"), ("w8_mlpblock", "fused_mlp_block")):
        got = {k: runs[f"chain_{tag}"][k] for k in (kernel, "fused_mlp_block_w4",
                                                    "fused_model_w4_chunk")}
        if got != {kernel: L * SHORT_CHAIN, "fused_mlp_block_w4": 0, "fused_model_w4_chunk": 0}:
            failures.append(f"{tag} chain launches {got}")
    # the kernel equals its plain version on the route; each route against the
    # plain path is held at about twice its first reading on the card
    for tag, ref, lim in (("w8_otail", "w8_otail_plain_fn", (2e-3, 0, 0.0)),
                          ("w8_otail", "w8_otail_ref_plain", OTAIL_W8_VS_PLAIN),
                          ("w8_mlp", "w8_otail_ref_plain", MLP_W8_VS_PLAIN),
                          ("w8_mlpblock", "w8_otail_ref_plain", MLPBLOCK_W8_VS_PLAIN)):
        e_l = float_err(chaino[tag][0], chaino[ref][0])
        e_k = int8_err(chaino[tag][1].k[:, :, :, window_s], chaino[ref][1].k[:, :, :, window_s])
        e_v = int8_err(chaino[tag][1].v[:, :, :, window_s], chaino[ref][1].v[:, :, :, window_s])
        fin = bool(torch.isfinite(chaino[tag][0]).all())
        chain_err[f"{tag}_vs_{ref}"] = {"logits_rel": e_l[1], "k_rows": e_k, "v_rows": e_v,
                                        "finite": fin}
        print(f"  W8 B={SERVE_B} {SHORT_CHAIN}-step chunk, {tag} vs {ref}: logits rel "
              f"{e_l[1]:.3g}; flushed K rows {e_k}, V rows {e_v}", flush=True)
        if not fin or e_l[1] > lim[0]:
            failures.append(f"{tag} chunk vs {ref}: logits rel {e_l[1]}, finite {fin}")
        if max(e_k[0], e_v[0]) > lim[1] or max(e_k[1], e_v[1]) > lim[2]:
            failures.append(f"{tag} chunk vs {ref}: flushed rows {e_k} {e_v}")
    # prefill at T = PROMPT_LEN on the prefill set with w2fold_kernel against
    # KernelConfig.prefill() (the split gate path), W4A8/h4 and W8A8/h8:
    # wall (host clock around a synchronised prefill), device time and
    # launches (torch.profiler), the route's launches counted from 0, and the
    # two prefills' logits against each other (the same function)
    fold_prefill = {}
    for tag, gp, pr in (("w4", g, prompt), ("w8", g8, prompt8)):
        tpf = torch.as_tensor(pr, device=dev)
        res_p = {}
        for set_name, kc_p in (("prefill", KernelConfig.prefill()),
                               ("w2fold", KernelConfig.prefill().replace(w2fold_kernel=True))):
            gp.prefill_kc = kc_p
            route = f"{tag}_prefill_{set_name}"
            lg_p, _ = counted(route, lambda: gp.prefill(tpf, gp.init_cache(1)))
            walls = []
            for _ in range(3):
                cache_p = gp.init_cache(1)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                gp.prefill(tpf, cache_p)
                torch.cuda.synchronize()
                walls.append((time.perf_counter() - t0) * 1e3)
            d_ms, top, n_l = device_profile(lambda: gp.prefill(tpf, gp.init_cache(1)))
            res_p[set_name] = {"wall_ms": sum(walls) / len(walls), "device_ms": d_ms,
                               "launches": n_l, "top_kernels": top, "counts": runs[route],
                               "logits": lg_p}
            print(f"  {route}: wall {res_p[set_name]['wall_ms']:.3f} ms, device {d_ms:.3f} ms, "
                  f"{n_l} launches; counts w13_gate {runs[route]['w13_gate']}, w13_gate_w2 "
                  f"{runs[route]['w13_gate_w2']}", flush=True)
            for k, ms_, c_ in top:
                print(f"    {route} {ms_:8.4f} ms  x{c_:6.1f}  {k}", flush=True)
        gp.prefill_kc = KernelConfig.prefill()
        e_p = float_err(res_p["w2fold"].pop("logits"), res_p["prefill"].pop("logits"))
        res_p["logits_rel_w2fold_vs_prefill"] = e_p[1]
        fold_prefill[tag] = res_p
        print(f"  {tag} prefill logits, w2fold vs split: rel {e_p[1]:.3g}", flush=True)
        if runs[f"{tag}_prefill_w2fold"]["w13_gate_w2"] != L \
                or runs[f"{tag}_prefill_w2fold"]["w13_gate"] \
                or runs[f"{tag}_prefill_prefill"]["w13_gate"] != L or e_p[1] > 2e-3:
            failures.append(f"{tag} w2-folded prefill: counts {runs[f'{tag}_prefill_w2fold']}, "
                            f"logits rel {e_p[1]}")
    mlp_routes["w2fold_prefill"] = fold_prefill

    # ---- phase 2s: StableLM's kernel editions against their plain versions --
    # StableLM-2-1.6B at full width (24 layers, hidden 2048, 32 q heads over
    # 32 kv heads of head_dim 64, rotary on 16 of them, LayerNorm with a bias,
    # a q/k/v bias; seeded synthetic W4A8/h4 and W8A8/h8 packs, inputs from a
    # generator of their own): the LayerNorm edition of rows 6, 7, 8, 11 and
    # 18, W4 and W8, and rows 3 and 4 at its T=128 prefill (partial rotary,
    # the q/k/v bias, G = 1)
    phase("phase 2s: StableLM-2-1.6B kernel editions vs plain versions")
    sgen = torch.Generator(device=dev).manual_seed(SEED + 11)
    spk = {}
    for wb in (4, 8):
        pk_s, cfg_s, strict_s, ecfg_s = build_synthetic_packed(
            "stablelm-2-1.6b", w_bits=wb, head_bits=wb, max_seq_len=MAX_SEQ, seed=SEED,
            device=dev)
        spk[wb] = (pk_s, strict_s, relax_16bit(strict_s), ecfg_s)
    Ls, Ds, Fs = cfg_s.num_layers, cfg_s.hidden_size, cfg_s.intermediate_size
    hds, Hqs, Hkvs, rots = cfg_s.head_dim_, cfg_s.num_heads, cfg_s.num_kv_heads, cfg_s.rotary_dim
    Nqs, Kos, Gs = (Hqs + 2 * Hkvs) * hds, Hqs * hds, Hqs // Hkvs
    Vps = spk[4][0]["head_q"]["wq"].shape[1]
    skw = dict(num_q_heads=Hqs, num_kv_heads=Hkvs, head_dim=hds, rotary_dim=rots,
               act_kind=cfg_s.hidden_act, norm_kind="layernorm")
    vec_s = (Nqs * 4 + Ds * 4 + 2 * Fs * 4 + Ds * 4) * 4 + 4 * Ds * 4 + Nqs * 16 + 65 * 4
    mlp_vec_s = (2 * Fs + Ds) * 4 * 4 + 2 * Ds * 4 + 32 * 4
    print(f"  StableLM-2-1.6B: rotary {rots} of {hds}, {Hqs} q / {Hkvs} kv heads, vocab "
          f"{cfg_s.vocab_size} (Vp {Vps}), q/k/v bias |b| max "
          f"{spk[4][0]['layers']['qkv_proj']['bias'].abs().max().item():.3f}", flush=True)
    # rows 3 and 4 at the W4 pack's T=128 prefill: the qkv epilogue kernel
    # with the q/k/v bias and rotary on 16 of 64 dims, the prefill attention
    # with one q head a kv head
    pk_s, _, pol_s, _ = spk[4]
    lys = pk_s["layers"]
    lr0s = E.layer_ranges(pk_s["ranges"], 0)
    cos_s, sin_s = MM.rope_cos_sin(torch.arange(PROMPT_LEN, device=dev)[None], cfg_s)
    cs_s = E._rope_cs_rows(cos_s, sin_s, hds, rots)
    ofq_s = E._qkv_ofq_rows(pk_s, pol_s)
    outq_s = E._qkv_outq_rows(pk_s["ranges"], cfg_s, Ls, dev)
    h8s = torch.randint(-128, 128, (PROMPT_LEN, Ds), generator=sgen, device=dev,
                        dtype=torch.int8)
    qkv_s = lys["qkv_proj"]
    out = qkv_rope(h8s, qkv_s, ofq_s[0], outq_s[0], cs_s, 0.02, 121.0, 0, hds, rots)
    ref = qkv_rope_plain(h8s, layer_pack(qkv_s, 0), ofq_s[0], outq_s[0], cs_s, 0.02, 121.0,
                         hds, rots)
    err = int8_err(out, ref)
    ms = time_ms(lambda i: qkv_rope(h8s, qkv_s, ofq_s[i % Ls], outq_s[i % Ls], cs_s, 0.02,
                                    121.0, i % Ls, hds, rots))
    plain_ms = time_ms(lambda i: qkv_rope_plain(h8s, layer_pack(qkv_s, 0), ofq_s[0], outq_s[0],
                                                cs_s, 0.02, 121.0, hds, rots), n=5)
    record("qkv_rope", f"StableLM M={PROMPT_LEN} {Ds}->{Nqs} rot {rots} +bias", err,
           err[0] <= 1 and err[1] <= 1e-3, ms, plain_ms, None,
           bound(PROMPT_LEN * Ds + Ds // 2 * Nqs + 11 * Nqs * 4 + PROMPT_LEN * 2 * hds * 4
                 + PROMPT_LEN * Nqs, int8_ops=2.0 * PROMPT_LEN * Ds * Nqs))
    qkv_sweep("", qkv_s, ofq_s, outq_s, Ls, cfg_s, False,
              torch.Generator(device=dev).manual_seed(SEED + 23), tag="StableLM +bias ")
    meta_as = E._attn_meta(lr0s, pol_s, cfg_s)
    T = PROMPT_LEN
    q8 = torch.randint(-128, 128, (1, Hkvs, Gs, T, hds), generator=sgen, device=dev,
                       dtype=torch.int8)
    k8 = torch.randint(-128, 128, (1, Hkvs, MAX_SEQ, hds), generator=sgen, device=dev,
                       dtype=torch.int8)
    v8 = torch.randint(-128, 128, k8.shape, generator=sgen, device=dev, dtype=torch.int8)
    posi = torch.arange(T, device=dev, dtype=torch.int32)[None]
    valid = torch.full((1,), T, device=dev, dtype=torch.int32)
    out = prefill_attention(q8, k8, v8, meta_as, posi, valid, False, False)
    err = float_err(out, prefill_attention_plain(q8, k8, v8, meta_as, posi, valid, False, False))
    ms = time_ms(lambda i: prefill_attention(q8, k8, v8, meta_as, posi, valid, False, False))
    plain_ms = time_ms(lambda i: prefill_attention_plain(q8, k8, v8, meta_as, posi, valid,
                                                         False, False), n=3)
    qd = q8.float().reshape(1, Hqs, T, hds).to(torch.bfloat16)
    kd = k8[:, :, :T].float().to(torch.bfloat16)
    vd = v8[:, :, :T].float().to(torch.bfloat16)
    lib_ms = time_ms(lambda i: torch.nn.functional.scaled_dot_product_attention(
        qd, kd, vd, is_causal=True))
    vis = T * (T + 1) / 2
    record("prefill_attention", f"StableLM T={T} S={MAX_SEQ} G={Gs} relaxed", err,
           err[1] <= 1e-4, ms, plain_ms, lib_ms,
           attn_bound(Hqs * T * hds + 2 * Hkvs * T * hds + T * 4 + 4 + Hqs * T * hds * 4,
                      Hqs * vis, hds))
    del q8, k8, v8, qd, kd, vd

    def ln_name(base, wb):
        return f"{base}[ln]" if wb == 4 else f"{base}[w8,ln]"

    stage_us_s, chunk_stage_us_s = {}, {}
    for wb in (4, 8):
        pk_s, _, pol_s, _ = spk[wb]
        lys = pk_s["layers"]
        div = 2 if wb == 4 else 1
        mlpw_s = (Ds * 2 * Fs + Fs * Ds) // div
        layer_ws = (Ds * Nqs + Kos * Ds) // div + mlpw_s
        head_s = Ds // div * Vps + 2 * Vps * 4 + 2 * Ds * 4
        mns, w13p_s, w2p_s, op_s = lys["mlp_norm"], lys["w13_proj"], lys["w2"], lys["o_proj"]
        lr1s = E.layer_ranges(pk_s["ranges"], 1)
        met_s, so_s = E._mlp_block_meta(lr1s, pol_s, cfg_s), E._mlp_block_site_on(pol_s)

        def mplain(x, met_s=met_s, so_s=so_s, mns=mns, w13p_s=w13p_s, w2p_s=w2p_s):
            return fused_mlp_block_w4_plain(x, mns["w"][1], mns["b"][1], layer_pack(w13p_s, 1),
                                            layer_pack(w2p_s, 1), met_s, cfg_s.hidden_act,
                                            so_s, "layernorm")

        # row 8: the dp4a kernel at M <= DP4A_ROWS, the row kernel above
        for Mr in (1, 2, 8, SHORT_PROMPT, BIG_B):
            x = torch.randn((Mr, Ds), generator=sgen, device=dev)
            margs = (mns["w"], mns["b"], w13p_s, w2p_s, met_s)
            out = fused_mlp_block_w4(x, *margs, 1, cfg_s.hidden_act, so_s, "layernorm")
            err = float_err(out, mplain(x))
            ms = time_ms(lambda i, x=x, margs=margs, so_s=so_s: fused_mlp_block_w4(
                x, *margs, i % Ls, cfg_s.hidden_act, so_s, "layernorm"))
            plain_ms = time_ms(lambda i, x=x, mplain=mplain: mplain(x), n=5)
            record(ln_name("fused_mlp_block_w4", wb),
                   f"StableLM M={Mr} {'dp4a' if Mr <= DP4A_ROWS else 'row'} kernel "
                   f"{Ds}->2x{Fs}->{Ds}", err, err[1] <= 2e-3, ms, plain_ms, None,
                   bound(2 * Mr * Ds * 4 + mlpw_s + mlp_vec_s,
                         int8_ops=2.0 * Mr * (Ds * 2 * Fs + Fs * Ds)), main=Mr == SERVE_B)
        # row 18 at M = 32, 128
        omet_s = met_s + E._otail_meta_ext(lr1s, pol_s)
        oso_s = E._otail_site_on(pol_s)
        for Mr in (SERVE_B, BIG_B):
            x = torch.randn((Mr, Ds), generator=sgen, device=dev)
            a8 = torch.randint(-128, 128, (Mr, Kos), generator=sgen, device=dev,
                               dtype=torch.int8)
            oargs = (op_s, mns["w"], mns["b"], w13p_s, w2p_s, omet_s)
            out = fused_otail_block_w4(a8, x, *oargs, 1, cfg_s.hidden_act, so_s, oso_s,
                                       "layernorm")
            plain = lambda i, x=x, a8=a8, omet_s=omet_s, so_s=so_s, oso_s=oso_s: (  # noqa: E731
                fused_otail_block_w4_plain(a8, x, layer_pack(op_s, 1), mns["w"][1], mns["b"][1],
                                           layer_pack(w13p_s, 1), layer_pack(w2p_s, 1), omet_s,
                                           cfg_s.hidden_act, so_s, oso_s, "layernorm"))
            err = float_err(out, plain(0))
            ms = time_ms(lambda i, x=x, a8=a8, oargs=oargs, so_s=so_s, oso_s=oso_s:
                         fused_otail_block_w4(a8, x, *oargs, i % Ls, cfg_s.hidden_act, so_s,
                                              oso_s, "layernorm"))
            plain_ms = time_ms(plain, n=5)
            record(ln_name("fused_otail_block_w4", wb), f"StableLM M={Mr} {Kos}->{Ds} + MLP block",
                   err, err[1] <= 2e-3, ms, plain_ms, None,
                   bound(Mr * Kos + 2 * Mr * Ds * 4 + Kos * Ds // div + mlpw_s + mlp_vec_s
                         + Ds * 16, int8_ops=2.0 * Mr * (Kos * Ds + Ds * 2 * Fs + Fs * Ds)),
                   main=Mr == SERVE_B)
        # rows 6 (B = 1, 8, with the head) and 7 (B = 1) over random full-length
        # caches, positions near POS0
        kps = E._kernel_prep(pk_s, pol_s, cfg_s)
        hargs_s = (pk_s["head_q"], pk_s["norm"])
        for Bm in (1, 8):
            kc = torch.randint(-128, 128, (Ls, Bm, Hkvs, MAX_SEQ, hds), generator=sgen,
                               device=dev, dtype=torch.int8)
            vc = torch.randint(-128, 128, kc.shape, generator=sgen, device=dev, dtype=torch.int8)
            posb = torch.tensor([POS0 - 3 * b for b in range(Bm)], dtype=torch.int32, device=dev)
            cos, sin = MM.rope_cos_sin(posb[:, None], cfg_s)
            csb = E._rope_cs_rows(cos, sin, hds, rots).reshape(Bm, 2, hds)
            x = torch.randn((Bm, Ds), generator=sgen, device=dev)
            fargs = (x, posb, csb, kps["ofq"], lys["attn_norm"], lys["qkv_proj"], op_s,
                     lys["mlp_norm"], w13p_s, w2p_s, kc, vc, kps["meta"])
            valid = int(posb.sum())
            att_ops = 2.0 * Hqs * hds * valid
            step_io = 2 * Bm * Ds * 4 + Bm * 2 * hds * 4 + Bm * 4
            out = fused_model_w4(*fargs, *hargs_s, **skw)
            ref = fused_model_w4_plain(*fargs, *hargs_s, **skw)
            e_x, e_lg, e_kv = float_err(out[0], ref[0]), float_err(out[2], ref[2]), \
                int8_err(out[1], ref[1])
            ok = e_x[1] <= 2e-3 and e_lg[1] <= 2e-3 and e_kv[0] == 0
            ms = time_ms(lambda i: fused_model_w4(*fargs, *hargs_s, **skw), n=10)
            plain_ms = event_ms(lambda: fused_model_w4_plain(*fargs, *hargs_s, **skw), n=2)
            nbytes = (Ls * (layer_ws + vec_s + valid * Hkvs * hds * 2 + Bm * 2 * Hkvs * hds)
                      + step_io + head_s + Bm * Vps * 4)
            ops_i8 = Ls * (2.0 * Bm * (Ds * Nqs + Kos * Ds + Ds * 2 * Fs + Fs * Ds) + att_ops) \
                + 2.0 * Bm * Ds * Vps
            record(ln_name("fused_model_w4", wb),
                   f"StableLM B={Bm} L={Ls} S={MAX_SEQ} pos<={POS0} +W{wb} head",
                   (max(e_x[0], e_lg[0]), max(e_x[1], e_lg[1])), ok, ms, plain_ms, None,
                   bound(nbytes, int8_ops=ops_i8, fp32_ops=Ls * att_ops),
                   note=f"kv_new max diff {e_kv[0]} on {e_kv[1]:.3g} of bytes; "
                        f"plain timed with events", main=Bm == 1)
            if Bm == 1:
                tr = torch.zeros(2 + 5 * Ls, dtype=torch.int64, device=dev)
                for _ in range(2):
                    fused_model_w4(*fargs, *hargs_s, trace=tr, **skw)
                torch.cuda.synchronize()
                dt = (tr[1:] - tr[:-1]).double().cpu() / 1e3
                per = dt[:5 * Ls].reshape(Ls, 5).mean(0).tolist()
                st_us = dict(zip(("qkv", "attention", "o_proj", "w13_gate", "w2"), per))
                st_us["head"], st_us["step_traced"] = float(dt[5 * Ls]), float(dt.sum())
                stage_us_s[f"w{wb}"] = st_us
                print(f"  {ln_name('fused_model_w4', wb)} B=1 stage us (mean per layer): "
                      + ", ".join(f"{k} {v:.2f}" for k, v in st_us.items()), flush=True)
                out = fused_layer_w4(*fargs, 1, **skw)
                ref = fused_layer_w4_plain(*fargs, 1, **skw)
                e_x, e_kv = float_err(out[0], ref[0]), int8_err(out[1], ref[1])
                ms = time_ms(lambda i: fused_layer_w4(*fargs, i % Ls, **skw))
                plain_ms = event_ms(lambda: fused_layer_w4_plain(*fargs, 1, **skw), n=3)
                record(ln_name("fused_layer_w4", wb), f"StableLM B=1 S={MAX_SEQ} pos={POS0}",
                       e_x, e_x[1] <= 2e-3 and e_kv[0] == 0, ms, plain_ms, None,
                       bound(layer_ws + vec_s + valid * Hkvs * hds * 2 + 2 * Hkvs * hds + step_io,
                             int8_ops=2.0 * (Ds * Nqs + Kos * Ds + Ds * 2 * Fs + Fs * Ds)
                             + att_ops, fp32_ops=att_ops),
                       note=f"kv_new max diff {e_kv[0]} on {e_kv[1]:.3g} of bytes; "
                            f"plain timed with events")
            del kc, vc
        # row 11 at B = 32 and 128, pos0 POS0, STAGED_M of CHUNK_COLS staged
        # columns valid, with the head
        for Bc in (SERVE_B, BIG_B):
            kc = torch.randint(-128, 128, (Ls, Bc, Hkvs, MAX_SEQ, hds), generator=sgen,
                               device=dev, dtype=torch.int8)
            vc = torch.randint(-128, 128, kc.shape, generator=sgen, device=dev, dtype=torch.int8)
            skc = torch.randint(-128, 128, (Ls, Bc, Hkvs, CHUNK_COLS, hds), generator=sgen,
                                device=dev, dtype=torch.int8)
            svc = torch.randint(-128, 128, skc.shape, generator=sgen, device=dev,
                                dtype=torch.int8)
            kcs = E.kv_colsums(kc)
            pos0 = torch.full((Bc,), POS0, dtype=torch.int32, device=dev)
            cos, sin = MM.rope_cos_sin((pos0 + STAGED_M)[:, None], cfg_s)
            csb = E._rope_cs_rows(cos, sin, hds, rots).reshape(Bc, 2, hds)
            x = torch.randn((Bc, Ds), generator=sgen, device=dev)
            valid = int(pos0.sum())
            rows_kv = valid + Bc * STAGED_M
            att_ops = 2.0 * Hqs * hds * (rows_kv + Bc)
            nbytes = (Ls * (layer_ws + vec_s + rows_kv * Hkvs * hds * 2 + valid * Hkvs * 4
                            + Bc * 2 * Hkvs * hds)
                      + 2 * Bc * Ds * 4 + Bc * 2 * hds * 4 + Bc * 4 + head_s + Bc * Vps * 4)
            ops_i8 = Ls * (2.0 * Bc * (Ds * Nqs + Kos * Ds + Ds * 2 * Fs + Fs * Ds) + att_ops) \
                + 2.0 * Bc * Ds * Vps
            cargs = (x, pos0, csb, kps["ofq"], lys["attn_norm"], lys["qkv_proj"], op_s,
                     lys["mlp_norm"], w13p_s, w2p_s, kc, vc, kcs, skc, svc, STAGED_M,
                     kps["meta"], *hargs_s)
            out = fused_model_w4_chunk(*cargs, **skw)
            ref = fused_model_w4_chunk_plain(*cargs, **skw)
            e_x, e_lg = float_err(out[0], ref[0]), float_err(out[2], ref[2])
            e_kv = int8_err(out[1], ref[1])
            ms = time_ms(lambda i: fused_model_w4_chunk(*cargs, **skw), n=5)
            plain_ms = event_ms(lambda: fused_model_w4_chunk_plain(*cargs, **skw), n=2)
            record(ln_name("fused_model_w4_chunk", wb),
                   f"StableLM B={Bc} pos0={POS0} m={STAGED_M} relaxed +W{wb} head",
                   (max(e_x[0], e_lg[0]), max(e_x[1], e_lg[1])),
                   e_x[1] <= 2e-3 and e_lg[1] <= 2e-3 and e_kv[0] == 0, ms, plain_ms, None,
                   bound(nbytes, int8_ops=ops_i8, fp32_ops=Ls * att_ops),
                   note=f"kv_new max diff {e_kv[0]} on {e_kv[1]:.3g} of bytes; "
                        f"plain timed with events", main=Bc == SERVE_B)
            if Bc == SERVE_B:
                chunk_stage_us_s[f"w{wb} B={Bc}"] = chunk_stages(
                    lambda tr: fused_model_w4_chunk(*cargs, trace=tr, **skw), Ls, dev,
                    f"{ln_name('fused_model_w4_chunk', wb)} B={Bc} m={STAGED_M}",
                    f"StableLM w{wb} B={Bc}")
            del kc, vc, skc, svc, kcs, cargs
        torch.cuda.empty_cache()

    # ---- phase 3s: StableLM serving through the entry points ---------------
    # W4A8/h4 and W8A8/h8 on the int8 cache, relaxed policy: B=1
    # generate_fast (128-token prompt, 64 new tokens; the prefill kernels,
    # then one whole-model launch a token), a 32-token prompt (the MLP block
    # in every prefill layer), decode_per_layer(), B=32 on the chunk route
    # (W4: KernelConfig.chunk(); W8: the entry config), the staged MLP-block
    # route (W4: the entry config; W8: KernelConfig.decode()) and the o-tail;
    # the B=1 step and one 8-step B=32 chunk against the plain path, with
    # their engine-numerics witnesses
    phase("phase 3s: StableLM-2-1.6B serving, W4A8/h4 and W8A8/h8, int8 KV, relaxed")
    serve_s, chain_s, b1_s = {}, {}, {}
    steps = NEW_TOKENS - 1
    for wb in (4, 8):
        pk_s, _, pol_s, ecfg_s = spk[wb]
        t = f"s{wb}"
        g_s = Generator(pk_s, cfg_s, pol_s, ecfg_s, device=dev)
        pr1 = torch.randint(0, cfg_s.vocab_size, (1, PROMPT_LEN), generator=sgen,
                            device=dev).cpu().numpy()
        want = {"fused_model_w4": steps, "prefill_attention": Ls, "w13_gate": Ls,
                "fused_mlp_block_w4": 0, "fused_layer_w4": 0}
        want.update({"qkv_rope": Ls, "w4a8_matmul_stacked": 2 * Ls, "w4a8_matmul": 1}
                    if wb == 4 else {"qkv_rope": 0, "w4a8_matmul_stacked": 0, "w4a8_matmul": 0})
        w8_route(f"{t}_main", g_s, pr1, NEW_TOKENS, CHUNK_COLS, want, store=serve_s)
        tp_s = torch.as_tensor(pr1, device=dev)
        pre_d, pre_t, pre_l = device_profile(lambda: g_s.prefill(tp_s, g_s.init_cache(1)))
        serve_s[f"{t}_main"].update(prefill_device_ms=pre_d, prefill_kernel_launches=pre_l,
                                    prefill_top_kernels=pre_t)
        print(f"  {t} prefill: device {pre_d:.3f} ms, {pre_l} launches", flush=True)
        w8_route(f"{t}_short_prompt", g_s, pr1[:, :SHORT_PROMPT], 8, 7,
                 {"fused_mlp_block_w4": Ls, "w13_gate": 0, "fused_model_w4": 7}, store=serve_s)
        gpl_s = Generator(pk_s, cfg_s, pol_s, dataclasses.replace(
            ecfg_s, use_pallas=KernelConfig.decode_per_layer()), device=dev)
        w8_route(f"{t}_per_layer", gpl_s, pr1, PER_LAYER_STEPS + 1, PER_LAYER_STEPS,
                 {"fused_layer_w4": PER_LAYER_STEPS * Ls, "fused_model_w4": 0}, store=serve_s)
        p32s = torch.randint(0, cfg_s.vocab_size, (SERVE_B, PROMPT_LEN), generator=sgen,
                             device=dev).cpu().numpy()
        kc_chunk = KernelConfig.chunk() if wb == 4 else KernelConfig.serving(cfg_s, pk_s, SERVE_B)
        kc_staged = True if wb == 4 else KernelConfig.decode()
        if wb == 8 and not kc_chunk.chunk_kernel:
            failures.append("KernelConfig.serving does not take the chunk kernel for W8 "
                            "StableLM at B=32")
        for rname, kc_r, n_new, n_loop, want in (
                ("b32_chunk", kc_chunk, NEW_TOKENS, CHUNK_COLS,
                 {"fused_model_w4_chunk": steps, "staged_append": steps,
                  "fused_mlp_block_w4": 0, "fused_model_w4": 0}),
                ("b32_staged", kc_staged, BIG_STEPS + 1, BIG_STEPS,
                 {"fused_mlp_block_w4": Ls * BIG_STEPS, "staged_append": BIG_STEPS,
                  "fused_model_w4_chunk": 0}),
                ("b32_otail", KernelConfig.otail(), BIG_STEPS + 1, BIG_STEPS,
                 {"fused_otail_block_w4": Ls * BIG_STEPS, "staged_append": BIG_STEPS,
                  "fused_model_w4_chunk": 0, "fused_mlp_block_w4": 0})):
            g_r = Generator(pk_s, cfg_s, pol_s, dataclasses.replace(ecfg_s, use_pallas=kc_r),
                            device=dev)
            w8_route(f"{t}_{rname}", g_r, p32s, n_new, n_loop, want, store=serve_s)
            del g_r

        # B=1 against the plain path: prefill logits, one decode() step, and
        # the witnesses: the prefill route on the plain engine's numerics
        # (prefill_engine_numerics), and the plain prefill, then the decode()
        # step with the whole-model kernel's plain version on the plain
        # engine's numerics
        res_s = {}
        wit_s = {(E, "fused_model_w4"): fused_model_w4_plain,
                 **engine_numerics(E, cfg_s, pol_s)}
        nxt = None          # the plain path's greedy token, fed to every decode step
        for tag, kc_p, kc_d in (("plain", KernelConfig.none(), KernelConfig.none()),
                                ("kernel", KernelConfig.prefill(), KernelConfig.decode()),
                                ("witness", KernelConfig.none(), KernelConfig.decode()),
                                ("prefill_witness", KernelConfig.prefill(), None)):
            cache = E.init_kv_cache(ecfg_s, 1, device=dev)
            with patched(prefill_engine_numerics(E, cfg_s) if tag == "prefill_witness" else {}):
                lg, cache = counted(f"{t}_b1_prefill_{tag}", lambda: E.forward(
                    pk_s, tp_s, cfg_s, pol_s, kv_cache=cache,
                    cache_position=torch.zeros(1, dtype=torch.int32, device=dev),
                    kv_valid_len=torch.full((1,), PROMPT_LEN, dtype=torch.int32, device=dev),
                    kc=kc_p, logits_at=torch.full((1,), PROMPT_LEN - 1, device=dev)))
            pre = E.EngineKVCache(cache.k.clone(), cache.v.clone())    # the prefill's rows
            if kc_d is None:
                res_s[tag] = (lg, None, cache, pre)
                continue
            if nxt is None:
                nxt = torch.argmax(lg[:, -1], -1)[:, None]
            p = torch.full((1,), PROMPT_LEN, dtype=torch.int32, device=dev)
            with patched(wit_s if tag == "witness" else {}):
                lg2, cache = counted(f"{t}_b1_step_{tag}", lambda: E.forward(
                    pk_s, nxt, cfg_s, pol_s, positions=p[:, None], kv_cache=cache,
                    cache_position=p, kv_valid_len=p + 1, kc=kc_d))
            res_s[tag] = (lg, lg2, cache, pre)
        same_s = bool(torch.equal(torch.argmax(res_s["kernel"][0][:, -1], -1)[:, None], nxt))
        e_pre = float_err(res_s["kernel"][0], res_s["plain"][0])
        e_dec = float_err(res_s["kernel"][1], res_s["plain"][1])
        e_cache = [int8_err(res_s["kernel"][2].k, res_s["plain"][2].k),
                   int8_err(res_s["kernel"][2].v, res_s["plain"][2].v)]
        e_layer = [[int8_err(getattr(res_s["kernel"][3], kv)[i],
                             getattr(res_s["plain"][3], kv)[i]) for i in range(Ls)]
                   for kv in ("k", "v")]
        e_wit = float_err(res_s["witness"][1], res_s["plain"][1])
        wit_eq = all(bool(torch.equal(getattr(res_s["witness"][2], kv),
                                      getattr(res_s["plain"][2], kv))) for kv in ("k", "v"))
        e_pwit = float_err(res_s["prefill_witness"][0], res_s["plain"][0])
        pwit_eq = all(bool(torch.equal(getattr(res_s["prefill_witness"][3], kv),
                                       getattr(res_s["plain"][3], kv))) for kv in ("k", "v"))
        fin = all(bool(torch.isfinite(r[0]).all()) and (r[1] is None or bool(
            torch.isfinite(r[1]).all())) for r in res_s.values())
        b1_s[t] = {"prefill_logits_rel_kernel_vs_plain": e_pre[1],
                   "decode_logits_rel_kernel_vs_plain": e_dec[1],
                   "kernel_prefill_greedy_token_is_plain": same_s,
                   "k_cache_kernel_vs_plain": e_cache[0], "v_cache_kernel_vs_plain": e_cache[1],
                   "prefill_k_per_layer": e_layer[0], "prefill_v_per_layer": e_layer[1],
                   "prefill_witness_logits_rel_vs_plain": e_pwit[1],
                   "prefill_witness_caches_equal": pwit_eq,
                   "witness_logits_rel_vs_plain": e_wit[1], "witness_caches_equal": wit_eq}
        print(f"  {t} prefill logits kernel vs plain: rel {e_pre[1]:.3g}; decode step on the "
              f"plain path's token rel {e_dec[1]:.3g} (the kernel prefill's greedy token is the "
              f"same: {same_s}); K / V cache max diff, share of bytes {e_cache[0]} / "
              f"{e_cache[1]}; finite {fin}; prefill "
              f"witness vs plain: logits rel {e_pwit[1]:.3g}, caches equal {pwit_eq}; step "
              f"witness vs plain: logits rel {e_wit[1]:.3g}, caches equal {wit_eq}", flush=True)
        print(f"  {t} prefill K / V max step per layer: "
              f"{[max(k[0], v[0]) for k, v in zip(*e_layer)]}", flush=True)
        lim = STABLELM_PREFILL_VS_PLAIN[wb]
        if not fin or res_s["kernel"][0].shape != (1, 1, cfg_s.vocab_size) or e_pre[1] > lim[0]:
            failures.append(f"{t} prefill logits kernel vs plain rel {e_pre[1]}, finite {fin}")
        if e_dec[1] > STABLELM_STEP_VS_PLAIN[wb]:
            failures.append(f"{t} decode logits kernel vs plain rel {e_dec[1]}")
        if max(e[0] for e in e_cache) > lim[1] or max(e[1] for e in e_cache) > lim[2]:
            failures.append(f"{t} K / V caches kernel vs plain {e_cache}")
        pruns = runs[f"{t}_b1_prefill_prefill_witness"]
        if e_pwit[1] > 1e-6 or not pwit_eq or pruns["prefill_attention"] or pruns["w13_gate"]:
            failures.append(f"{t} prefill witness vs plain: logits rel {e_pwit[1]}, caches "
                            f"equal {pwit_eq}, launches {pruns}")
        if runs[f"{t}_b1_step_witness"]["fused_model_w4"] \
                or runs[f"{t}_b1_step_kernel"]["fused_model_w4"] != 1 \
                or e_wit[1] > 1e-6 or not wit_eq:
            failures.append(f"{t} B=1 witness vs plain: logits rel {e_wit[1]}, caches equal "
                            f"{wit_eq}, launches {runs[f'{t}_b1_step_kernel']}")

        # one SHORT_CHAIN-step B=32 chunk fed the same tokens on the chunk
        # route, on that route with the kernel's plain version, on that plain
        # version moved onto the plain engine's numerics (attention and both
        # norms, the witness that the route's wiring is the engine's) and on
        # the plain path
        c32s = E.init_kv_cache(ecfg_s, SERVE_B, device=dev)
        _, c32s = g_s.prefill(torch.as_tensor(p32s, device=dev), c32s)
        ftok_s = torch.randint(0, cfg_s.vocab_size, (SERVE_B, CHUNK_COLS), generator=sgen,
                               device=dev)[:, :SHORT_CHAIN]
        plain_chunk = {(E, "fused_model_w4_chunk"): fused_model_w4_chunk_plain}
        stand_s = {f"{t}_chunk_plain_fn": plain_chunk,
                   f"{t}_chunk_engine_numerics": {**plain_chunk,
                                                  **engine_numerics(E, cfg_s, pol_s)}}
        chn = {}
        for tag, kc_c in ((f"{t}_chunk", kc_chunk), *((w, kc_chunk) for w in stand_s),
                          (f"{t}_plain", KernelConfig.none())):
            cc = E.EngineKVCache(c32s.k.clone(), c32s.v.clone())
            with patched(stand_s.get(tag, {})):
                chn[tag] = counted(f"chain_{tag}", lambda: staged_chunk(
                    kc_c, cc, ftok_s, fpos, pk_s, pol_s, cfg_c=cfg_s))
        if runs[f"chain_{t}_chunk"]["fused_model_w4_chunk"] != SHORT_CHAIN \
                or runs[f"chain_{t}_chunk_engine_numerics"]["fused_model_w4_chunk"] \
                or any(runs[f"chain_{t}_plain"].values()):
            failures.append(f"{t} chain launches {runs[f'chain_{t}_chunk']} / "
                            f"{runs[f'chain_{t}_plain']}")
        # the kernel equals its plain version, and that plain version on the
        # plain engine's numerics equals the plain path bit for bit; the raw
        # route against the plain path is held at about twice its first
        # reading on the card
        for tag, ref, lim in ((f"{t}_chunk", f"{t}_chunk_plain_fn", (2e-3, 0, 0.0)),
                              (f"{t}_chunk_engine_numerics", f"{t}_plain", (1e-6, 0, 0.0)),
                              (f"{t}_chunk", f"{t}_plain", STABLELM_CHUNK_VS_PLAIN[wb])):
            e_l = float_err(chn[tag][0], chn[ref][0])
            stp = [float_err(chn[tag][0][:, i], chn[ref][0][:, i])[1] for i in range(SHORT_CHAIN)]
            e_k = int8_err(chn[tag][1].k[:, :, :, window_s], chn[ref][1].k[:, :, :, window_s])
            e_v = int8_err(chn[tag][1].v[:, :, :, window_s], chn[ref][1].v[:, :, :, window_s])
            fin = bool(torch.isfinite(chn[tag][0]).all())
            chain_s[f"{tag}_vs_{ref}"] = {"logits_rel": e_l[1], "logits_rel_first_step": stp[0],
                                          "logits_rel_per_step": stp, "k_rows": e_k,
                                          "v_rows": e_v, "finite": fin}
            print(f"  {t} B={SERVE_B} {SHORT_CHAIN}-step chunk, {tag} vs {ref}: logits rel "
                  f"{e_l[1]:.3g} (step 0: {stp[0]:.3g}); flushed K rows {e_k}, V rows {e_v}",
                  flush=True)
            if not fin or e_l[1] > lim[0]:
                failures.append(f"{tag} chunk vs {ref}: logits rel {e_l[1]}, finite {fin}")
            if max(e_k[0], e_v[0]) > lim[1] or max(e_k[1], e_v[1]) > lim[2]:
                failures.append(f"{tag} chunk vs {ref}: flushed rows {e_k} {e_v}")
        del g_s, gpl_s, c32s, chn
    del spk
    torch.cuda.empty_cache()

    # ---- phase 2g: Gemma-2B's head-dim-256 editions against their plain versions
    # Gemma-2B at full width (18 layers, hidden 2048, 8 q heads over one kv
    # head of head_dim 256, full rotary, F 16384, vocab 256000, gelu_tanh,
    # RMSNorm on (1 + w), the head tied to the embedding; seeded synthetic
    # W4A8/h4 and W8A8/h8 packs, inputs from a generator of their own): row 3
    # at the W4 T=128 prefill, row 4 (T=128 into S=1024, T=S=1024 relaxed and
    # strict, and the head-dim-128 edition at one shape), row 15 (B = 1, 32),
    # rows 6 (B = 1, 8, the head folded) and 7 (B = 1) and row 11 (B = 16,
    # 32, 64, 128 relaxed, B = 32 strict), W4 and W8, and the other kernels
    # that the Gemma routes launch, at its widths
    phase("phase 2g: Gemma-2B head-dim-256 editions vs plain versions")
    ggen = torch.Generator(device=dev).manual_seed(SEED + 13)
    gpk = {}
    for wb in (4, 8):
        pk_g, cfg_g, strict_g, ecfg_g = build_synthetic_packed(
            "gemma-2b", w_bits=wb, head_bits=wb, max_seq_len=MAX_SEQ, seed=SEED, device=dev)
        gpk[wb] = (pk_g, strict_g, relax_16bit(strict_g), ecfg_g)
    Lg, Dg, Fg = cfg_g.num_layers, cfg_g.hidden_size, cfg_g.intermediate_size
    hdg, Hqg, Hkvg, rotg = cfg_g.head_dim_, cfg_g.num_heads, cfg_g.num_kv_heads, cfg_g.rotary_dim
    Nqg, Kog, Gg = (Hqg + 2 * Hkvg) * hdg, Hqg * hdg, Hqg // Hkvg
    Vpg = gpk[4][0]["head_q"]["wq"].shape[1]
    gkw = dict(num_q_heads=Hqg, num_kv_heads=Hkvg, head_dim=hdg, rotary_dim=rotg,
               act_kind=cfg_g.hidden_act, norm_kind="rmsnorm")
    vec_g = (Nqg * 4 + Dg * 4 + 2 * Fg * 4 + Dg * 4) * 4 + 4 * Dg * 4 + Nqg * 16 + 65 * 4
    print(f"  Gemma-2B: {Hqg} q heads over {Hkvg} kv head of {hdg}, rotary {rotg}, F {Fg}, "
          f"vocab {cfg_g.vocab_size} (Vp {Vpg}), tied head, {cfg_g.hidden_act}", flush=True)

    def hd_name(base, wb=4):
        return f"{base}[hd256]" if wb == 4 else f"{base}[w8,hd256]"

    # row 3 at the W4 T=128 prefill: 10 heads of 256 in 128-column tiles of
    # two 64-column runs (each column beside its RoPE partner)
    pk_g, _, pol_g, _ = gpk[4]
    lyg = pk_g["layers"]
    lr0g = E.layer_ranges(pk_g["ranges"], 0)
    cos_g, sin_g = MM.rope_cos_sin(torch.arange(PROMPT_LEN, device=dev)[None], cfg_g)
    cs_g = E._rope_cs_rows(cos_g, sin_g, hdg, rotg)
    ofq_g = E._qkv_ofq_rows(pk_g, pol_g)
    outq_g = E._qkv_outq_rows(pk_g["ranges"], cfg_g, Lg, dev)
    h8g = torch.randint(-128, 128, (PROMPT_LEN, Dg), generator=ggen, device=dev, dtype=torch.int8)
    qkv_g = lyg["qkv_proj"]
    out = qkv_rope(h8g, qkv_g, ofq_g[0], outq_g[0], cs_g, 0.02, 121.0, 0, hdg, rotg)
    ref = qkv_rope_plain(h8g, layer_pack(qkv_g, 0), ofq_g[0], outq_g[0], cs_g, 0.02, 121.0,
                         hdg, rotg)
    err = int8_err(out, ref)
    ms = time_ms(lambda i: qkv_rope(h8g, qkv_g, ofq_g[i % Lg], outq_g[i % Lg], cs_g, 0.02,
                                    121.0, i % Lg, hdg, rotg))
    plain_ms = time_ms(lambda i: qkv_rope_plain(h8g, layer_pack(qkv_g, 0), ofq_g[0], outq_g[0],
                                                cs_g, 0.02, 121.0, hdg, rotg), n=5)
    record(hd_name("qkv_rope"), f"Gemma M={PROMPT_LEN} {Dg}->{Nqg} hd {hdg} rot {rotg}", err,
           err[0] == 0, ms, plain_ms, None,
           bound(PROMPT_LEN * Dg + Dg // 2 * Nqg + 11 * Nqg * 4 + PROMPT_LEN * 2 * hdg * 4
                 + PROMPT_LEN * Nqg, int8_ops=2.0 * PROMPT_LEN * Dg * Nqg))
    # and at the other prompt lengths, W4 and W8 (the paired edition, error 0)
    for wb in (4, 8):
        pk_w, _, pol_w, _ = gpk[wb]
        qkv_sweep("[hd256]" if wb == 4 else "[w8,hd256]", pk_w["layers"]["qkv_proj"],
                  E._qkv_ofq_rows(pk_w, pol_w), E._qkv_outq_rows(pk_w["ranges"], cfg_g, Lg, dev),
                  Lg, cfg_g, True, torch.Generator(device=dev).manual_seed(SEED + 24 + wb),
                  tag="Gemma ", timed=wb == 4)
    # row 4: the hd-256 edition (G 8 in a block's 64 rows) at the main path's
    # T=128 and at T=S=1024 in both policies, the hd-128 edition at a
    # llama-3-8b-like shape (8 kv heads, G 4; no model of the port's registry
    # has head_dim 128 yet, so it is a checked shape of row 4's kernel, with
    # no launches of its own); SDPA on bf16 the yardstick
    ameta_g = E._attn_meta(lr0g, pol_g, cfg_g)
    for hda, Hkva, Ga, T, S, strict in ((hdg, Hkvg, Gg, PROMPT_LEN, MAX_SEQ, False),
                                        (hdg, Hkvg, Gg, MAX_SEQ, MAX_SEQ, False),
                                        (hdg, Hkvg, Gg, MAX_SEQ, MAX_SEQ, True),
                                        (128, 8, 4, PROMPT_LEN, MAX_SEQ, False)):
        meta_a = list(ameta_g)
        if strict:   # the strict policy's 16-bit score and prob sites
            meta_a[6:9] = [80.0 / 65535, 32768.0, 65535.0]
            meta_a[9:12] = [1.0 / 65535, 0.0, 65535.0]
        q8 = torch.randint(-128, 128, (1, Hkva, Ga, T, hda), generator=ggen, device=dev,
                           dtype=torch.int8)
        k8 = torch.randint(-128, 128, (1, Hkva, S, hda), generator=ggen, device=dev,
                           dtype=torch.int8)
        v8 = torch.randint(-128, 128, k8.shape, generator=ggen, device=dev, dtype=torch.int8)
        posi = torch.arange(T, device=dev, dtype=torch.int32)[None]
        valid = torch.full((1,), T, device=dev, dtype=torch.int32)
        out = prefill_attention(q8, k8, v8, meta_a, posi, valid, strict, strict)
        err = float_err(out, prefill_attention_plain(q8, k8, v8, meta_a, posi, valid, strict,
                                                     strict))
        ms = time_ms(lambda i: prefill_attention(q8, k8, v8, meta_a, posi, valid, strict,
                                                 strict))
        plain_ms = time_ms(lambda i: prefill_attention_plain(q8, k8, v8, meta_a, posi, valid,
                                                             strict, strict), n=3)
        Hqa = Hkva * Ga
        qd = q8.float().reshape(1, Hqa, T, hda).to(torch.bfloat16)
        kd = k8[:, :, :T].float().repeat_interleave(Ga, 1).to(torch.bfloat16)
        vd = v8[:, :, :T].float().repeat_interleave(Ga, 1).to(torch.bfloat16)
        lib_ms = time_ms(lambda i: torch.nn.functional.scaled_dot_product_attention(
            qd, kd, vd, is_causal=True))
        vis = T * (T + 1) / 2
        pstep = meta_a[9] * (v8.float() - (meta_a[5] - 128.0)).abs().max().item() * meta_a[4]
        ok_att = err[0] <= 32 * pstep if strict else err[1] <= 1e-4
        record("prefill_attention[hd256]" if hda == hdg else "prefill_attention",
               f"Gemma T={T} S={S} G={Ga} {'strict' if strict else 'relaxed'}" if hda == hdg
               else f"hd {hda} T={T} S={S} Hkv={Hkva} G={Ga} relaxed", err, ok_att, ms,
               plain_ms, lib_ms,
               attn_bound(Hqa * T * hda + 2 * Hkva * T * hda + T * 4 + 4 + Hqa * T * hda * 4,
                          Hqa * vis, hda),
               note=f"{err[0] / pstep:.2f} prob steps" if strict else None,
               main=T == PROMPT_LEN and hda == hdg)
        del q8, k8, v8, qd, kd, vd
    # row 15: B = 1, 32 at 193 valid rows of an S = 1024 cache, both policies
    # (the wrapper's cluster size printed), layers rotated while timing
    for Bd, strict in ((1, False), (1, True), (SERVE_B, False), (SERVE_B, True)):
        nval = POS0 + 1
        kcd = torch.randint(-128, 128, (Lg, Bd, Hkvg, MAX_SEQ, hdg), generator=ggen, device=dev,
                            dtype=torch.int8)
        vcd = torch.randint(-128, 128, kcd.shape, generator=ggen, device=dev, dtype=torch.int8)
        q8d = torch.randint(-128, 128, (Bd, Hkvg, Gg, hdg), generator=ggen, device=dev,
                            dtype=torch.int8)
        vld = torch.full((Bd,), nval, dtype=torch.int32, device=dev)
        meta_d = E._attn_meta(lr0g, gpk[4][1] if strict else pol_g, cfg_g)
        ncl = cluster_size(Bd, Hkvg, MAX_SEQ, sms, Gg, hdg)
        out = decode_attention(q8d, kcd[1], vcd[1], meta_d, vld)
        err = float_err(out, decode_attention_plain(q8d, kcd[1], vcd[1], meta_d, vld))
        ms = time_ms(lambda i: decode_attention(q8d, kcd[i % Lg], vcd[i % Lg], meta_d, vld))
        plain_ms = time_ms(lambda i: decode_attention_plain(q8d, kcd[1], vcd[1], meta_d, vld),
                           n=3)
        qd = torch.randn((Bd, Hqg, 1, hdg), generator=ggen, device=dev).to(torch.bfloat16)
        kd = torch.randn((Bd, Hkvg, 1, nval, hdg), generator=ggen, device=dev).to(torch.bfloat16)
        kd = kd.expand(Bd, Hkvg, Gg, nval, hdg).reshape(Bd, Hqg, nval, hdg)
        vd = kd.clone()
        lib_ms = time_ms(lambda i: torch.nn.functional.scaled_dot_product_attention(qd, kd, vd))
        rows_d = Bd * Hkvg * nval
        record(hd_name("decode_attention"), f"Gemma B={Bd} S={MAX_SEQ} valid={nval} ncl={ncl} "
               f"{'strict' if strict else 'relaxed'}", err,
               err[0] == 0 and bool(torch.isfinite(out).all()), ms, plain_ms, lib_ms,
               bound(Bd * Hqg * hdg + 2 * rows_d * hdg + Bd * 4 + Bd * Hqg * hdg * 4,
                     int8_ops=2.0 * Gg * hdg * rows_d, fp64_ops=2.0 * Gg * hdg * rows_d,
                     sfu_ops=Gg * rows_d),
               note="library: SDPA bf16 over the valid rows, the kv head expanded",
               main=(Bd, strict) == (1, False))
        rows[hd_name("decode_attention")][-1]["cluster"] = ncl
        del kcd, vcd, kd, vd
    # the other kernels of the Gemma routes at its widths (F 16384, gelu_tanh,
    # Vp 258048), layers rotated while timing: w13_gate at the T=128 prefill
    # and the MLP block's dp4a (M=1, the attn() route) and row (M=32, the
    # staged route) kernels, W4 and W8; the W4 projections (w4a8_matmul_stacked)
    # at the attn() route's M=1 and the staged route's M=32 qkv / o and at
    # the prefill's o / w2, and the W4 head (w4a8_matmul) at M = 1 and 32 (a
    # generator of their own: the later checks' inputs stay as they were)
    xgen = torch.Generator(device=dev).manual_seed(SEED + 14)
    for wb in (4, 8):
        pk_g, _, pol_g, _ = gpk[wb]
        lyg = pk_g["layers"]
        sfx, div = ("", 2) if wb == 4 else ("[w8]", 1)
        bmeta_g = E._mlp_block_meta(E.layer_ranges(pk_g["ranges"], 1), pol_g, cfg_g)
        bso_g = E._mlp_block_site_on(pol_g)
        w13g, w2g, mng = lyg["w13_proj"], lyg["w2"], lyg["mlp_norm"]
        actg = cfg_g.hidden_act
        out = w13_gate(h8g, w13g, bmeta_g, 1, actg, bso_g[1:5])
        ref = w13_gate_plain(h8g, layer_pack(w13g, 1), bmeta_g, actg, bso_g[1:5])
        err = int8_err(out, ref)
        ms = time_ms(lambda i, w13g=w13g, bmeta_g=bmeta_g, bso_g=bso_g: w13_gate(
            h8g, w13g, bmeta_g, i % Lg, actg, bso_g[1:5]))
        plain_ms = time_ms(lambda i, w13g=w13g, bmeta_g=bmeta_g, bso_g=bso_g: w13_gate_plain(
            h8g, layer_pack(w13g, 1), bmeta_g, actg, bso_g[1:5]), n=3)
        record(f"w13_gate{sfx}", f"Gemma M={PROMPT_LEN} {Dg}->2x{Fg} {actg}", err, err[0] == 0,
               ms, plain_ms, None,
               bound(PROMPT_LEN * Dg + Dg // div * 2 * Fg + 2 * Fg * 16 + PROMPT_LEN * Fg,
                     int8_ops=2.0 * PROMPT_LEN * Dg * 2 * Fg))
        w13_gate_sweep(sfx, w13g, bmeta_g, Lg, actg, bso_g[1:5], Dg, Fg, div,
                       torch.Generator(device=dev).manual_seed(SEED + 18 + wb), tag="Gemma ")

        def mplain_g(x, w13g=w13g, w2g=w2g, mng=mng, bmeta_g=bmeta_g, bso_g=bso_g):
            return fused_mlp_block_w4_plain(x, mng["w"][1], mng["b"][1], layer_pack(w13g, 1),
                                            layer_pack(w2g, 1), bmeta_g, actg, bso_g)

        for Mr in (1, SERVE_B):
            x = torch.randn((Mr, Dg), generator=xgen, device=dev)
            out = fused_mlp_block_w4(x, mng["w"], mng["b"], w13g, w2g, bmeta_g, 1, actg, bso_g)
            err = float_err(out, mplain_g(x))
            ms = time_ms(lambda i, x=x, w13g=w13g, w2g=w2g, mng=mng, bmeta_g=bmeta_g,
                         bso_g=bso_g: fused_mlp_block_w4(x, mng["w"], mng["b"], w13g, w2g,
                                                         bmeta_g, i % Lg, actg, bso_g))
            plain_ms = time_ms(lambda i, x=x, mplain_g=mplain_g: mplain_g(x), n=3)
            record(f"fused_mlp_block_w4{sfx}",
                   f"Gemma M={Mr} {'dp4a' if Mr <= DP4A_ROWS else 'row'} kernel "
                   f"{Dg}->2x{Fg}->{Dg} {actg}", err, err[1] <= 1e-5, ms, plain_ms, None,
                   bound(2 * Mr * Dg * 4 + (Dg * 2 * Fg + Fg * Dg) // div
                         + (2 * Fg + Dg) * 4 * 4 + 2 * Dg * 4 + 32 * 4,
                         int8_ops=2.0 * Mr * (Dg * 2 * Fg + Fg * Dg)))
    lyg, hq_g = gpk[4][0]["layers"], gpk[4][0]["head_q"]
    for tag, Mr, pk in (("qkv", 1, lyg["qkv_proj"]), ("o", 1, lyg["o_proj"]),
                        ("qkv", SERVE_B, lyg["qkv_proj"]), ("o", SERVE_B, lyg["o_proj"]),
                        ("o", PROMPT_LEN, lyg["o_proj"]), ("w2", PROMPT_LEN, lyg["w2"]),
                        ("head", 1, None), ("head", SERVE_B, None)):
        if pk is None:              # the tied head: one copy is 264 MB, past the L2
            K, N = Dg, Vpg
            name, xs, xo, lp = "w4a8_matmul", 1.0, 128.0, hq_g
            call = lambda x, i: w4a8_matmul(x, hq_g, xs, xo)       # noqa: E731
        else:
            K, N = pk["wq"].shape[1] * 2, pk["wq"].shape[2]
            name, xs, xo, lp = "w4a8_matmul_stacked", 0.02, 121.0, layer_pack(pk, 0)
            call = lambda x, i, pk=pk: w4a8_matmul_stacked(x, pk, xs, xo, i % Lg)  # noqa: E731
        x = torch.randint(-128, 128, (Mr, K), generator=xgen, device=dev, dtype=torch.int8)
        err = float_err(call(x, 0), w4a8_matmul_plain(x, lp["wq"], lp["scale"], lp["offset"],
                                                      lp["colsum"], lp.get("bias"), xs, xo))
        ms = time_ms(lambda i, x=x, call=call: call(x, i))
        plain_ms = time_ms(lambda i, x=x, lp=lp, xs=xs, xo=xo: w4a8_matmul_plain(
            x, lp["wq"], lp["scale"], lp["offset"], lp["colsum"], lp.get("bias"), xs, xo), n=3)
        wus = [qops.unpack_nibbles(hq_g["wq"] if pk is None else pk["wq"][j]).contiguous()
               for j in range(cold_count(K * N, 1 if pk is None else Lg))]
        xp = x if Mr > 16 else torch.cat(
            [x, torch.zeros((32 - Mr, K), dtype=torch.int8, device=dev)])
        lib_ms = time_ms(lambda i, xp=xp, wus=wus: torch._int_mm(xp, wus[i % len(wus)]))
        del wus
        record(name, f"Gemma M={Mr} {tag} {K}->{N}", err, err[1] <= 1e-5, ms, plain_ms, lib_ms,
               bound(Mr * K + K // 2 * N + 4 * N * 4 + Mr * N * 4, int8_ops=2.0 * Mr * K * N),
               note=None if Mr > 16 else "library: torch._int_mm on rows padded to 32")
    # rows 1 / 2 at the other prompt lengths: the prefill's w2, the tied head
    w4a8_sweep(lyg["w2"], Lg, xgen, "Gemma w2 ")
    w4a8_sweep([hq_g], 1, xgen, "Gemma head ", Ms=(9, 17, 65))
    torch.cuda.empty_cache()

    # rows 6 (B = 1, 8, with the head) and 7 (B = 1), W4 and W8, over random
    # full-length caches, positions near POS0; then row 11
    stage_us_g, chunk_stage_us_g = {}, {}
    cgen = torch.Generator(device=dev).manual_seed(SEED + 15)
    for wb in (4, 8):
        pk_g, _, pol_g, _ = gpk[wb]
        lyg = pk_g["layers"]
        div = 2 if wb == 4 else 1
        layer_wg = (Dg * Nqg + Kog * Dg + Dg * 2 * Fg + Fg * Dg) // div
        head_g = Dg // div * Vpg + 2 * Vpg * 4 + 2 * Dg * 4
        kpg = E._kernel_prep(pk_g, pol_g, cfg_g)
        hargs_g = (pk_g["head_q"], pk_g["norm"])
        for Bm in (1, 8):
            kc = torch.randint(-128, 128, (Lg, Bm, Hkvg, MAX_SEQ, hdg), generator=ggen,
                               device=dev, dtype=torch.int8)
            vc = torch.randint(-128, 128, kc.shape, generator=ggen, device=dev, dtype=torch.int8)
            posb = torch.tensor([POS0 - 3 * b for b in range(Bm)], dtype=torch.int32, device=dev)
            cos, sin = MM.rope_cos_sin(posb[:, None], cfg_g)
            csb = E._rope_cs_rows(cos, sin, hdg, rotg).reshape(Bm, 2, hdg)
            x = torch.randn((Bm, Dg), generator=ggen, device=dev)
            fargs = (x, posb, csb, kpg["ofq"], lyg["attn_norm"], lyg["qkv_proj"],
                     lyg["o_proj"], lyg["mlp_norm"], lyg["w13_proj"], lyg["w2"], kc, vc,
                     kpg["meta"])
            valid = int(posb.sum())
            att_ops = 2.0 * Hqg * hdg * valid
            step_io = 2 * Bm * Dg * 4 + Bm * 2 * hdg * 4 + Bm * 4
            out = fused_model_w4(*fargs, *hargs_g, **gkw)
            ref = fused_model_w4_plain(*fargs, *hargs_g, **gkw)
            e_x, e_lg, e_kv = float_err(out[0], ref[0]), float_err(out[2], ref[2]), \
                int8_err(out[1], ref[1])
            ok = e_x[1] <= 2e-3 and e_lg[1] <= 2e-3 and e_kv[0] == 0
            ms = time_ms(lambda i: fused_model_w4(*fargs, *hargs_g, **gkw), n=10)
            plain_ms = event_ms(lambda: fused_model_w4_plain(*fargs, *hargs_g, **gkw), n=2)
            nbytes = (Lg * (layer_wg + vec_g + valid * Hkvg * hdg * 2 + Bm * 2 * Hkvg * hdg)
                      + step_io + head_g + Bm * Vpg * 4)
            ops_i8 = Lg * (2.0 * Bm * (Dg * Nqg + Kog * Dg + Dg * 2 * Fg + Fg * Dg) + att_ops) \
                + 2.0 * Bm * Dg * Vpg
            record(hd_name("fused_model_w4", wb),
                   f"Gemma B={Bm} L={Lg} S={MAX_SEQ} pos<={POS0} +W{wb} head",
                   (max(e_x[0], e_lg[0]), max(e_x[1], e_lg[1])), ok, ms, plain_ms, None,
                   bound(nbytes, int8_ops=ops_i8, fp32_ops=Lg * att_ops),
                   note=f"kv_new max diff {e_kv[0]} on {e_kv[1]:.3g} of bytes; "
                        f"plain timed with events", main=Bm == 1)
            if Bm == 1:
                tr = torch.zeros(2 + 5 * Lg, dtype=torch.int64, device=dev)
                for _ in range(2):
                    fused_model_w4(*fargs, *hargs_g, trace=tr, **gkw)
                torch.cuda.synchronize()
                dt = (tr[1:] - tr[:-1]).double().cpu() / 1e3
                per = dt[:5 * Lg].reshape(Lg, 5).mean(0).tolist()
                st_us = dict(zip(("qkv", "attention", "o_proj", "w13_gate", "w2"), per))
                st_us["head"], st_us["step_traced"] = float(dt[5 * Lg]), float(dt.sum())
                stage_us_g[f"w{wb}"] = st_us
                print(f"  {hd_name('fused_model_w4', wb)} B=1 stage us (mean per layer): "
                      + ", ".join(f"{k} {v:.2f}" for k, v in st_us.items()), flush=True)
                if wb == 4:
                    print(parent_stages("Gemma W4"), flush=True)
                # row 7 is a B=1 kernel (the JAX whole-layer kernel asserts
                # M == 1); B=8 runs row 6's attention stage above
                out = fused_layer_w4(*fargs, 1, **gkw)
                ref = fused_layer_w4_plain(*fargs, 1, **gkw)
                e_x, e_kv = float_err(out[0], ref[0]), int8_err(out[1], ref[1])
                ms = time_ms(lambda i: fused_layer_w4(*fargs, i % Lg, **gkw))
                plain_ms = event_ms(lambda: fused_layer_w4_plain(*fargs, 1, **gkw), n=3)
                record(hd_name("fused_layer_w4", wb), f"Gemma B=1 S={MAX_SEQ} pos={POS0}",
                       e_x, e_x[1] <= 2e-3 and e_kv[0] == 0, ms, plain_ms, None,
                       bound(layer_wg + vec_g + valid * Hkvg * hdg * 2 + 2 * Hkvg * hdg
                             + step_io,
                             int8_ops=2.0 * (Dg * Nqg + Kog * Dg + Dg * 2 * Fg + Fg * Dg)
                             + att_ops, fp32_ops=att_ops),
                       note=f"kv_new max diff {e_kv[0]} on {e_kv[1]:.3g} of bytes; "
                            f"plain timed with events")
            del kc, vc
        # row 11's hd-256 edition at B = 16, 32, 64, 128 (the MI 1, 2, 4, 8
        # instantiations) relaxed, and strict at B = 32: pos0 POS0 (staggered
        # by b % 8 below it), STAGED_M of CHUNK_COLS staged columns valid, the
        # tied head folded (inputs from a generator of their own: the later
        # checks' inputs stay as they were)
        for Bc, strict in ((16, False), (SERVE_B, False), (SERVE_B, True), (64, False),
                           (BIG_B, False)):
            pol_c = gpk[wb][1] if strict else pol_g
            kpc = E._kernel_prep(pk_g, pol_c, cfg_g) if strict else kpg
            ckw = dict(gkw, qk_fq_on=bool(pol_c["self_attn.qk_bmm"].output.enabled),
                       pv_fq_on=bool(pol_c["self_attn.pv_bmm"].input.enabled))
            kc = torch.randint(-128, 128, (Lg, Bc, Hkvg, MAX_SEQ, hdg), generator=cgen,
                               device=dev, dtype=torch.int8)
            vc = torch.randint(-128, 128, kc.shape, generator=cgen, device=dev, dtype=torch.int8)
            skc = torch.randint(-128, 128, (Lg, Bc, Hkvg, CHUNK_COLS, hdg), generator=cgen,
                                device=dev, dtype=torch.int8)
            svc = torch.randint(-128, 128, skc.shape, generator=cgen, device=dev,
                                dtype=torch.int8)
            kcs = E.kv_colsums(kc)
            pos0 = torch.tensor([POS0 - b % 8 for b in range(Bc)], dtype=torch.int32,
                                device=dev)
            cos, sin = MM.rope_cos_sin((pos0 + STAGED_M)[:, None], cfg_g)
            csb = E._rope_cs_rows(cos, sin, hdg, rotg).reshape(Bc, 2, hdg)
            x = torch.randn((Bc, Dg), generator=cgen, device=dev)
            valid = int(pos0.sum())
            rows_kv = valid + Bc * STAGED_M
            att_ops = 2.0 * Hqg * hdg * (rows_kv + Bc)
            nbytes = (Lg * (layer_wg + vec_g + rows_kv * Hkvg * hdg * 2 + valid * Hkvg * 4
                            + Bc * 2 * Hkvg * hdg)
                      + 2 * Bc * Dg * 4 + Bc * 2 * hdg * 4 + Bc * 4 + head_g + Bc * Vpg * 4)
            ops_i8 = Lg * (2.0 * Bc * (Dg * Nqg + Kog * Dg + Dg * 2 * Fg + Fg * Dg) + att_ops) \
                + 2.0 * Bc * Dg * Vpg
            cargs = (x, pos0, csb, kpc["ofq"], lyg["attn_norm"], lyg["qkv_proj"], lyg["o_proj"],
                     lyg["mlp_norm"], lyg["w13_proj"], lyg["w2"], kc, vc, kcs, skc, svc,
                     STAGED_M, kpc["meta"], *hargs_g)
            out = fused_model_w4_chunk(*cargs, **ckw)
            ref = fused_model_w4_chunk_plain(*cargs, **ckw)
            e_x, e_lg = float_err(out[0], ref[0]), float_err(out[2], ref[2])
            e_kv = int8_err(out[1], ref[1])
            ms = time_ms(lambda i: fused_model_w4_chunk(*cargs, **ckw), n=5)
            plain_ms = event_ms(lambda: fused_model_w4_chunk_plain(*cargs, **ckw), n=2)
            record(hd_name("fused_model_w4_chunk", wb),
                   f"Gemma B={Bc} pos0<={POS0} m={STAGED_M} "
                   f"{'strict' if strict else 'relaxed'} +W{wb} head",
                   (max(e_x[0], e_lg[0]), max(e_x[1], e_lg[1])),
                   e_x[1] <= 2e-3 and e_lg[1] <= 2e-3 and e_kv[0] == 0, ms, plain_ms, None,
                   bound(nbytes, int8_ops=ops_i8, fp32_ops=Lg * att_ops),
                   note=f"kv_new max diff {e_kv[0]} on {e_kv[1]:.3g} of bytes; "
                        f"plain timed with events", main=(Bc, strict) == (SERVE_B, False))
            if (Bc, strict) == (SERVE_B, False):
                chunk_stage_us_g[f"w{wb} B={Bc}"] = chunk_stages(
                    lambda tr: fused_model_w4_chunk(*cargs, trace=tr, **ckw), Lg, dev,
                    f"{hd_name('fused_model_w4_chunk', wb)} B={Bc} m={STAGED_M}",
                    f"Gemma w{wb} B={Bc}")
            del kc, vc, skc, svc, kcs, cargs
        torch.cuda.empty_cache()

    # ---- phase 3g: Gemma-2B serving through the entry points ----------------
    # W4A8/h4 and W8A8/h8 on the int8 cache, relaxed policy: B=1 generate_fast
    # (128-token prompt, 64 new tokens; the prefill kernels, with row 3's
    # hd-256 edition on W4, then one whole-model launch a token),
    # decode_per_layer(), KernelConfig.attn() at B = 1 and 32 (row 15), B=32
    # on the entry config (W4: the staged MLP-block route; W8: the chunk
    # kernel, which KernelConfig.serving turns on for W8 at 8 < B <= 48), W4
    # on KernelConfig.chunk() at B = 32 and 128 (the 32-token prompt, 8
    # steps); the B=1 step with its engine-numerics witnesses, and one
    # 32-step B=32 chunk on the chunk route against the chunk kernel's plain
    # version, that plain version on the plain engine's numerics, and the
    # plain path
    phase("phase 3g: Gemma-2B serving, W4A8/h4 and W8A8/h8, int8 KV, relaxed")
    serve_g, chain_g, b1_g = {}, {}, {}
    # the chunk gate takes Gemma-2B (head_dim 256) where the JAX engine takes
    # its chunk kernel: the JAX gate's terms, copied (jax_chunk_gate)
    gate_g = {Bq: (chunk_kernel_supported(cfg_g, MAX_SEQ, Bq), jax_chunk_gate(cfg_g, MAX_SEQ, Bq))
              for Bq in (8, 16, 32, 48, 64, 128, 136)}
    if any(a != j for a, j in gate_g.values()) \
            or not all(gate_g[Bq][0] for Bq in (16, 32, 64, 128)):
        failures.append(f"the chunk gate on Gemma-2B (port, JAX terms) by B: {gate_g}")
    p128g = torch.randint(0, cfg_g.vocab_size, (BIG_B, SHORT_PROMPT), generator=cgen,
                          device=dev).cpu().numpy()
    for wb in (4, 8):
        pk_g, _, pol_g, ecfg_g = gpk[wb]
        t = f"g{wb}"
        g_g = Generator(pk_g, cfg_g, pol_g, ecfg_g, device=dev)
        pr1 = torch.randint(0, cfg_g.vocab_size, (1, PROMPT_LEN), generator=ggen,
                            device=dev).cpu().numpy()
        want = {"fused_model_w4": steps, "prefill_attention": Lg, "w13_gate": Lg,
                "fused_mlp_block_w4": 0, "fused_layer_w4": 0, "fused_model_w4_chunk": 0}
        want.update({"qkv_rope": Lg, "w4a8_matmul_stacked": 2 * Lg, "w4a8_matmul": 1}
                    if wb == 4 else {"qkv_rope": 0, "w4a8_matmul_stacked": 0, "w4a8_matmul": 0})
        w8_route(f"{t}_main", g_g, pr1, NEW_TOKENS, CHUNK_COLS, want, store=serve_g)
        tp_g = torch.as_tensor(pr1, device=dev)
        pre_d, pre_t, pre_l = device_profile(lambda: g_g.prefill(tp_g, g_g.init_cache(1)))
        serve_g[f"{t}_main"].update(prefill_device_ms=pre_d, prefill_kernel_launches=pre_l,
                                    prefill_idle_share=1.0 - pre_d / serve_g[f"{t}_main"][
                                        "prefill_ms"], prefill_top_kernels=pre_t)
        print(f"  {t} prefill: wall {serve_g[f'{t}_main']['prefill_ms']:.3f} ms, device "
              f"{pre_d:.3f} ms, {pre_l} launches", flush=True)
        for k, ms_, c in pre_t:
            print(f"    {t}/prefill {ms_:8.4f} ms  x{c:4d}  {k}", flush=True)
        gpl_g = Generator(pk_g, cfg_g, pol_g, dataclasses.replace(
            ecfg_g, use_pallas=KernelConfig.decode_per_layer()), device=dev)
        w8_route(f"{t}_per_layer", gpl_g, pr1, PER_LAYER_STEPS + 1, PER_LAYER_STEPS,
                 {"fused_layer_w4": PER_LAYER_STEPS * Lg, "fused_model_w4": 0}, store=serve_g)
        del gpl_g
        p32g = torch.randint(0, cfg_g.vocab_size, (SERVE_B, PROMPT_LEN), generator=ggen,
                             device=dev).cpu().numpy()
        ga_g = Generator(pk_g, cfg_g, pol_g, dataclasses.replace(
            ecfg_g, use_pallas=KernelConfig.attn()), device=dev)
        for rname, pr, n_new in (("attn_b1", pr1, PER_LAYER_STEPS + 1),
                                 ("attn_b32", p32g, BIG_STEPS + 1)):
            w8_route(f"{t}_{rname}", ga_g, pr, n_new, n_new - 1,
                     {"decode_attention": (n_new - 1) * Lg, "fused_model_w4": 0,
                      "staged_append": 0, "fused_model_w4_chunk": 0}, store=serve_g)
        del ga_g
        gs_g = Generator(pk_g, cfg_g, pol_g, ecfg_g, device=dev)     # the entry config
        kc_chunk = KernelConfig.chunk() if wb == 4 else KernelConfig.serving(cfg_g, pk_g,
                                                                              SERVE_B)
        if not kc_chunk.chunk_kernel:
            failures.append(f"{t}: the entry config takes no chunk kernel at B={SERVE_B}")
        chunk_want = {"staged_append": steps, "fused_model_w4_chunk": steps,
                      "fused_mlp_block_w4": 0, "fused_model_w4": 0}
        if wb == 4:
            # the entry config's staged route (W4 packs never take the chunk
            # kernel there), then KernelConfig.chunk() at B = 32 and 128
            w8_route(f"{t}_b32_staged", gs_g, p32g, BIG_STEPS + 1, BIG_STEPS,
                     {"fused_mlp_block_w4": Lg * BIG_STEPS, "staged_append": BIG_STEPS,
                      "fused_model_w4_chunk": 0, "fused_model_w4": 0}, store=serve_g)
            gc_g = Generator(pk_g, cfg_g, pol_g, dataclasses.replace(ecfg_g, use_pallas=kc_chunk),
                             device=dev)
            w8_route(f"{t}_b32_chunk", gc_g, p32g, NEW_TOKENS, CHUNK_COLS, chunk_want,
                     store=serve_g)
            w8_route(f"{t}_b128_chunk", gc_g, p128g, BIG_STEPS + 1, BIG_STEPS,
                     {**chunk_want, "staged_append": BIG_STEPS,
                      "fused_model_w4_chunk": BIG_STEPS}, store=serve_g)
            del gc_g
        else:
            w8_route(f"{t}_b32_chunk", gs_g, p32g, NEW_TOKENS, CHUNK_COLS, chunk_want,
                     store=serve_g)

        # B=1 against the plain path: prefill logits, one decode() step (both
        # fed the plain path's greedy token), and the witnesses: the prefill
        # route on the plain engine's numerics, and the plain prefill, then the
        # decode() step with the whole-model kernel's plain version on the
        # plain engine's numerics; each must equal the plain path bit for bit
        res_g = {}
        wit_g = {(E, "fused_model_w4"): fused_model_w4_plain,
                 **engine_numerics(E, cfg_g, pol_g)}
        nxt = None
        for tag, kc_p, kc_d in (("plain", KernelConfig.none(), KernelConfig.none()),
                                ("kernel", KernelConfig.prefill(), KernelConfig.decode()),
                                ("witness", KernelConfig.none(), KernelConfig.decode()),
                                ("prefill_witness", KernelConfig.prefill(), None)):
            cache = E.init_kv_cache(ecfg_g, 1, device=dev)
            with patched(prefill_engine_numerics(E, cfg_g) if tag == "prefill_witness" else {}):
                lg, cache = counted(f"{t}_b1_prefill_{tag}", lambda: E.forward(
                    pk_g, tp_g, cfg_g, pol_g, kv_cache=cache,
                    cache_position=torch.zeros(1, dtype=torch.int32, device=dev),
                    kv_valid_len=torch.full((1,), PROMPT_LEN, dtype=torch.int32, device=dev),
                    kc=kc_p, logits_at=torch.full((1,), PROMPT_LEN - 1, device=dev)))
            pre = E.EngineKVCache(cache.k.clone(), cache.v.clone())
            if kc_d is None:
                res_g[tag] = (lg, None, cache, pre)
                continue
            if nxt is None:
                nxt = torch.argmax(lg[:, -1], -1)[:, None]
            p = torch.full((1,), PROMPT_LEN, dtype=torch.int32, device=dev)
            with patched(wit_g if tag == "witness" else {}):
                lg2, cache = counted(f"{t}_b1_step_{tag}", lambda: E.forward(
                    pk_g, nxt, cfg_g, pol_g, positions=p[:, None], kv_cache=cache,
                    cache_position=p, kv_valid_len=p + 1, kc=kc_d))
            res_g[tag] = (lg, lg2, cache, pre)
        same_g = bool(torch.equal(torch.argmax(res_g["kernel"][0][:, -1], -1)[:, None], nxt))
        e_pre = float_err(res_g["kernel"][0], res_g["plain"][0])
        e_dec = float_err(res_g["kernel"][1], res_g["plain"][1])
        e_cache = [int8_err(res_g["kernel"][2].k, res_g["plain"][2].k),
                   int8_err(res_g["kernel"][2].v, res_g["plain"][2].v)]
        e_wit = float_err(res_g["witness"][1], res_g["plain"][1])
        wit_eq = all(bool(torch.equal(getattr(res_g["witness"][2], kv),
                                      getattr(res_g["plain"][2], kv))) for kv in ("k", "v"))
        e_pwit = float_err(res_g["prefill_witness"][0], res_g["plain"][0])
        pwit_eq = all(bool(torch.equal(getattr(res_g["prefill_witness"][3], kv),
                                       getattr(res_g["plain"][3], kv))) for kv in ("k", "v"))
        fin = all(bool(torch.isfinite(r[0]).all()) and (r[1] is None or bool(
            torch.isfinite(r[1]).all())) for r in res_g.values())
        b1_g[t] = {"prefill_logits_rel_kernel_vs_plain": e_pre[1],
                   "decode_logits_rel_kernel_vs_plain": e_dec[1],
                   "kernel_prefill_greedy_token_is_plain": same_g,
                   "k_cache_kernel_vs_plain": e_cache[0], "v_cache_kernel_vs_plain": e_cache[1],
                   "prefill_witness_logits_rel_vs_plain": e_pwit[1],
                   "prefill_witness_caches_equal": pwit_eq,
                   "witness_logits_rel_vs_plain": e_wit[1], "witness_caches_equal": wit_eq}
        print(f"  {t} prefill logits kernel vs plain: rel {e_pre[1]:.3g}; decode step on the "
              f"plain path's token rel {e_dec[1]:.3g} (the kernel prefill's greedy token is the "
              f"same: {same_g}); K / V cache max diff, share of bytes {e_cache[0]} / "
              f"{e_cache[1]}; finite {fin}; prefill witness vs plain: logits rel "
              f"{e_pwit[1]:.3g}, caches equal {pwit_eq}; step witness vs plain: logits rel "
              f"{e_wit[1]:.3g}, caches equal {wit_eq}", flush=True)
        lim = GEMMA_PREFILL_VS_PLAIN[wb]
        if not fin or res_g["kernel"][0].shape != (1, 1, cfg_g.vocab_size) or e_pre[1] > lim[0]:
            failures.append(f"{t} prefill logits kernel vs plain rel {e_pre[1]}, finite {fin}")
        if e_dec[1] > GEMMA_STEP_VS_PLAIN[wb]:
            failures.append(f"{t} decode logits kernel vs plain rel {e_dec[1]}")
        if max(e[0] for e in e_cache) > lim[1] or max(e[1] for e in e_cache) > lim[2]:
            failures.append(f"{t} K / V caches kernel vs plain {e_cache}")
        pruns = runs[f"{t}_b1_prefill_prefill_witness"]
        if e_pwit[1] > 1e-6 or not pwit_eq or pruns["prefill_attention"] or pruns["w13_gate"]:
            failures.append(f"{t} prefill witness vs plain: logits rel {e_pwit[1]}, caches "
                            f"equal {pwit_eq}, launches {pruns}")
        if runs[f"{t}_b1_step_witness"]["fused_model_w4"] \
                or runs[f"{t}_b1_step_kernel"]["fused_model_w4"] != 1 \
                or e_wit[1] > 1e-6 or not wit_eq:
            failures.append(f"{t} B=1 witness vs plain: logits rel {e_wit[1]}, caches equal "
                            f"{wit_eq}, launches {runs[f'{t}_b1_step_kernel']}")

        # one CHUNK_COLS-step B=32 chunk fed the same tokens on the chunk
        # route, on that route with the kernel's plain version, on that route
        # with the plain version on the plain engine's numerics (the witness
        # that the route's wiring is the engine's), and on the plain path
        c32g = E.init_kv_cache(ecfg_g, SERVE_B, device=dev)
        _, c32g = gs_g.prefill(torch.as_tensor(p32g, device=dev), c32g)
        ftok_g = torch.randint(0, cfg_g.vocab_size, (SERVE_B, CHUNK_COLS), generator=ggen,
                               device=dev)
        if wb == 8:             # the inputs, for scripts/probe_gemma_w8_chain.py
            torch.save({"prompt": torch.as_tensor(p32g), "tokens": ftok_g.cpu()},
                       out_dir / "gemma_w8_chain_inputs.pt")
        plain_chunk = {(E, "fused_model_w4_chunk"): fused_model_w4_chunk_plain}
        stand_g = {f"{t}_chunk_plain_fn": plain_chunk,
                   f"{t}_chunk_engine_numerics": {**plain_chunk,
                                                  **engine_numerics(E, cfg_g, pol_g)}}
        chn = {}
        for tag, kc_c in ((f"{t}_chunk", kc_chunk), *((w, kc_chunk) for w in stand_g),
                          (f"{t}_plain", KernelConfig.none())):
            cc = E.EngineKVCache(c32g.k.clone(), c32g.v.clone())
            with patched(stand_g.get(tag, {})):
                chn[tag] = counted(f"chain_{tag}", lambda: staged_chunk(
                    kc_c, cc, ftok_g, fpos, pk_g, pol_g, cfg_c=cfg_g))
        if runs[f"chain_{t}_chunk"]["fused_model_w4_chunk"] != CHUNK_COLS \
                or runs[f"chain_{t}_chunk"]["fused_mlp_block_w4"] \
                or runs[f"chain_{t}_chunk_engine_numerics"]["fused_model_w4_chunk"] \
                or any(runs[f"chain_{t}_plain"].values()):
            failures.append(f"{t} chain launches {runs[f'chain_{t}_chunk']} / "
                            f"{runs[f'chain_{t}_plain']}")
        for tag, ref, lim in ((f"{t}_chunk", f"{t}_chunk_plain_fn", (2e-3, 0, 0.0)),
                              (f"{t}_chunk_engine_numerics", f"{t}_plain", (1e-6, 0, 0.0)),
                              (f"{t}_chunk", f"{t}_plain", GEMMA_CHUNK_VS_PLAIN[wb])):
            e_l = float_err(chn[tag][0], chn[ref][0])
            stp = [float_err(chn[tag][0][:, i], chn[ref][0][:, i])[1] for i in range(CHUNK_COLS)]
            e_k = int8_err(chn[tag][1].k[:, :, :, window], chn[ref][1].k[:, :, :, window])
            e_v = int8_err(chn[tag][1].v[:, :, :, window], chn[ref][1].v[:, :, :, window])
            fin = bool(torch.isfinite(chn[tag][0]).all())
            chain_g[f"{tag}_vs_{ref}"] = {"logits_rel": e_l[1], "logits_rel_first_step": stp[0],
                                          "logits_rel_per_step": stp, "k_rows": e_k,
                                          "v_rows": e_v, "finite": fin}
            print(f"  {t} B={SERVE_B} {CHUNK_COLS}-step chunk, {tag} vs {ref}: logits rel "
                  f"{e_l[1]:.3g} (step 0: {stp[0]:.3g}); flushed K rows {e_k}, V rows {e_v}",
                  flush=True)
            if not fin or e_l[1] > lim[0]:
                failures.append(f"{tag} chunk vs {ref}: logits rel {e_l[1]}, finite {fin}")
            if max(e_k[0], e_v[0]) > lim[1] or max(e_k[1], e_v[1]) > lim[2]:
                failures.append(f"{tag} chunk vs {ref}: flushed rows {e_k} {e_v}")
        del g_g, gs_g, c32g, chn
    del gpk
    torch.cuda.empty_cache()

    # ---- phases 2h / 3h: the registry's head-dim-128 models ------------------
    hd128 = {}
    for key, (hname, hwb) in H_MODELS.items():
        phase(f"phase 2h: {hname} W{hwb}A8/h{hwb} kernels at its widths vs plain versions")
        pk_h, cfg_h, strict_h, ecfg_h = build_synthetic_packed(
            hname, w_bits=hwb, head_bits=hwb, max_seq_len=MAX_SEQ, seed=SEED, device=dev)
        pol_h = relax_16bit(strict_h)
        phase_hd128_kernels(dev, key, pk_h, cfg_h, pol_h, strict_h, record, check_row, failures)
        kv4_h = None
        if key == "q4":                    # row 10's G = 6 edition on its route
            pk4_h, _, strict4_h, ecfg4_h = build_synthetic_packed(
                hname, w_bits=4, head_bits=4, max_seq_len=MAX_SEQ, seed=SEED, device=dev,
                kv_bits=4)
            kv4_h = (pk4_h, relax_16bit(strict4_h), ecfg4_h)
        hd128[key] = phase_hd128_serve(dev, key, pk_h, cfg_h, pol_h, ecfg_h, counted, runs,
                                       failures, kv4_pack=kv4_h)
        if key == "q4":
            hd128[key]["batcher"] = phase_hd128_batcher(dev, pk_h, cfg_h, pol_h, ecfg_h,
                                                        counted, runs, failures)
        del pk_h, kv4_h
        torch.cuda.empty_cache()
    converted = phase_convert(dev, counted, runs, failures)

    quant = phase_quantize(dev, counted, runs, failures)
    serving_v = phase_serve(dev, counted, runs, failures)

    # ---- phase 4: report ---------------------------------------------------
    sources = {"w4a8_matmul": ("csrc/w4a8_matmul.cu",
                               "mobilequant_tpu/ops/pallas_matmul.py:59"),
               "w4a8_matmul_stacked": ("csrc/w4a8_matmul.cu",
                                       "mobilequant_tpu/ops/pallas_matmul.py:249"),
               "qkv_rope": ("csrc/qkv_rope.cu", "mobilequant_tpu/ops/pallas_qkv.py:126"),
               "prefill_attention": ("csrc/prefill_attention.cu",
                                     "mobilequant_tpu/ops/pallas_prefill_attention.py:201"),
               "w13_gate": ("csrc/w13_gate.cu", "mobilequant_tpu/ops/pallas_mlp.py:680"),
               "fused_mlp_block_w4": ("csrc/fused_rows.cu",
                                      "mobilequant_tpu/ops/pallas_mlp.py:950"),
               "fused_layer_w4": ("csrc/fused_layer.cu",
                                  "mobilequant_tpu/ops/pallas_layer.py:607"),
               "fused_model_w4": ("csrc/fused_layer.cu",
                                  "mobilequant_tpu/ops/pallas_layer.py:773"),
               "staged_append": ("csrc/staged_append.cu",
                                 "mobilequant_tpu/ops/pallas_scatter.py:38"),
               "fused_otail_block_w4": ("csrc/fused_rows.cu",
                                        "mobilequant_tpu/ops/pallas_mlp.py:828"),
               "fused_model_w4_chunk": ("csrc/fused_rows.cu",
                                        "mobilequant_tpu/ops/pallas_chunk.py:575"),
               "kv4_decode_attention": ("csrc/kv4_attention.cu",
                                        "mobilequant_tpu/ops/pallas_kv4.py:219"),
               "decode_attention": ("csrc/decode_attention.cu",
                                    "mobilequant_tpu/ops/pallas_attention.py:79"),
               "w8a8_matmul": ("csrc/w8a8_matmul.cu",
                               "mobilequant_tpu/ops/pallas_matmul.py:123"),
               "qkv_rope[w8]": ("csrc/qkv_rope.cu", "mobilequant_tpu/ops/pallas_qkv.py:126"),
               "w13_gate[w8]": ("csrc/w13_gate.cu", "mobilequant_tpu/ops/pallas_mlp.py:680"),
               "fused_mlp_block_w4[w8]": ("csrc/fused_rows_w8.cu",
                                          "mobilequant_tpu/ops/pallas_mlp.py:950"),
               "fused_layer_w4[w8]": ("csrc/fused_layer.cu",
                                      "mobilequant_tpu/ops/pallas_layer.py:607"),
               "fused_model_w4[w8]": ("csrc/fused_layer.cu",
                                      "mobilequant_tpu/ops/pallas_layer.py:773"),
               "fused_model_w4_chunk[w8]": ("csrc/fused_rows_w8.cu",
                                            "mobilequant_tpu/ops/pallas_chunk.py:575"),
               "wonly_matmul_stacked": ("csrc/wonly_matmul.cu",
                                        "mobilequant_tpu/ops/pallas_matmul.py:411"),
               "w4a16_matmul": ("csrc/wonly_matmul.cu",
                                "mobilequant_tpu/ops/pallas_matmul.py:180"),
               "fused_mlp": ("csrc/fused_mlp_tiles.cu", "mobilequant_tpu/ops/pallas_mlp.py:117"),
               "fused_mlp_block": ("csrc/fused_rows_w8.cu",
                                   "mobilequant_tpu/ops/pallas_mlp.py:301"),
               "fused_otail_block_w4[w8]": ("csrc/fused_otail_w8.cu",
                                            "mobilequant_tpu/ops/pallas_mlp.py:828"),
               "w13_gate_w2": ("csrc/fused_mlp_tiles.cu", "mobilequant_tpu/ops/pallas_mlp.py:1194"),
               "w13_gate_w2[w8]": ("csrc/fused_mlp_tiles.cu",
                                   "mobilequant_tpu/ops/pallas_mlp.py:1194")}
    # the head-dim-256 editions (Gemma-2B)
    sources["fused_model_w4_chunk[hd256]"] = ("csrc/fused_rows_hd256.cu",
                                              "mobilequant_tpu/ops/pallas_chunk.py:841")
    sources["fused_model_w4_chunk[w8,hd256]"] = ("csrc/fused_rows_hd256_w8.cu",
                                                 "mobilequant_tpu/ops/pallas_chunk.py:841")
    for base, src, rep in (
            ("qkv_rope", "qkv_rope.cu", "pallas_qkv.py:126"),
            ("prefill_attention", "prefill_attention.cu", "pallas_prefill_attention.py:201"),
            ("decode_attention", "decode_attention.cu", "pallas_attention.py:79"),
            ("fused_model_w4", "fused_layer_hd256.cu", "pallas_layer.py:773"),
            ("fused_layer_w4", "fused_layer_hd256.cu", "pallas_layer.py:607")):
        sources[f"{base}[hd256]"] = ("csrc/" + src, "mobilequant_tpu/ops/" + rep)
        sources[f"{base}[w8,hd256]"] = ("csrc/" + src, "mobilequant_tpu/ops/" + rep)
    # the LayerNorm editions (StableLM): the JAX kernels' layernorm branches
    for base, w4src, w8src, rep in (
            ("fused_model_w4", "fused_layer.cu", "fused_layer.cu", "pallas_layer.py:109"),
            ("fused_layer_w4", "fused_layer.cu", "fused_layer.cu", "pallas_layer.py:109"),
            ("fused_mlp_block_w4", "fused_rows_ln.cu", "fused_rows_ln.cu", "pallas_mlp.py:433"),
            ("fused_model_w4_chunk", "fused_rows.cu", "fused_rows_w8.cu", "pallas_chunk.py:293"),
            ("fused_otail_block_w4", "fused_rows.cu", "fused_otail_w8.cu", "pallas_mlp.py:433")):
        sources[f"{base}[ln]"] = ("csrc/" + w4src, "mobilequant_tpu/ops/" + rep)
        sources[f"{base}[w8,ln]"] = ("csrc/" + w8src, "mobilequant_tpu/ops/" + rep)
    # the route whose run each kernel's launch count is read from: the main
    # path (B=1 generate_fast) unless named here; each was counted from 0. A
    # W8 edition ("name[w8]") counts on its kernel's wrapper, on a W8 route.
    route_of = {"fused_mlp_block_w4": "b32_staged", "fused_layer_w4": "per_layer",
                "staged_append": "b32_staged", "fused_otail_block_w4": "b32_otail",
                "fused_model_w4_chunk": "b32_chunk", "kv4_decode_attention": "kv4_b32",
                "decode_attention": "attn_b1", "w8a8_matmul": "w8_attn_all",
                "w13_gate[w8]": "w8_main",
                "fused_mlp_block_w4[w8]": "w8_b128", "fused_layer_w4[w8]": "w8_per_layer",
                "fused_model_w4[w8]": "w8_main", "fused_model_w4_chunk[w8]": "w8_b32",
                "wonly_matmul_stacked": "wonly_main", "w4a16_matmul": "wonly_main",
                "qkv_rope[w8]": "w8_main", "fused_mlp": "w8_mlp",
                "fused_mlp_block": "w8_mlpblock", "fused_otail_block_w4[w8]": "w8_otail_b32",
                "w13_gate_w2": "w4_prefill_w2fold", "w13_gate_w2[w8]": "w8_prefill_w2fold"}
    route_of.update({"qkv_rope[hd256]": "g4_main", "prefill_attention[hd256]": "g4_main",
                     "decode_attention[hd256]": "g4_attn_b1",
                     "fused_model_w4[hd256]": "g4_main", "fused_model_w4[w8,hd256]": "g8_main",
                     "fused_layer_w4[hd256]": "g4_per_layer",
                     "fused_layer_w4[w8,hd256]": "g8_per_layer",
                     "fused_model_w4_chunk[hd256]": "g4_b32_chunk",
                     "fused_model_w4_chunk[w8,hd256]": "g8_b32_chunk"})
    # the G = 6 editions (Qwen2-1.5B) and row 4's hd-128 edition at G = 4 / 1
    # (Llama-3-8B, Llama-2-7B), each read on its model's route
    for base, src, rep in (
            ("prefill_attention", "prefill_attention.cu", "pallas_prefill_attention.py:201"),
            ("decode_attention", "decode_attention.cu", "pallas_attention.py:79"),
            ("kv4_decode_attention", "kv4_attention.cu", "pallas_kv4.py:219")):
        sources[f"{base}[G6]"] = ("csrc/" + src, "mobilequant_tpu/ops/" + rep)
    sources["prefill_attention[hd128]"] = sources["prefill_attention[G6]"]
    route_of.update({"prefill_attention[G6]": "hq4_b1", "decode_attention[G6]": "hq4_attn_b1",
                     "kv4_decode_attention[G6]": "hq4_kv4_b32",
                     "prefill_attention[hd128]": "hl3_b1"})
    for wb, tag in ((4, "[ln]"), (8, "[w8,ln]")):
        route_of.update({f"fused_model_w4{tag}": f"s{wb}_main",
                         f"fused_layer_w4{tag}": f"s{wb}_per_layer",
                         f"fused_mlp_block_w4{tag}": f"s{wb}_b32_staged",
                         f"fused_model_w4_chunk{tag}": f"s{wb}_b32_chunk",
                         f"fused_otail_block_w4{tag}": f"s{wb}_b32_otail"})
    # no runtime path calls w4a16_matmul, in the JAX package either: its
    # launches are the weight-only run's count (0, held there), and it may be
    # 0. qkv_rope's W8 edition has no route either (the JAX engine takes the
    # qkv epilogue kernel on W4 packs only): its launches are the W8 main
    # route's count on qkv_rope's wrapper (0, held there).
    off_route = {"w4a16_matmul", "qkv_rope[w8]"}
    kernels = []
    for name, shapes in rows.items():
        head = next((r for r in shapes if r["main"]), shapes[0])
        src, rep = sources[name]
        route = route_of.get(name, "main")
        n_launch = runs[route][name.split("[")[0]]
        if n_launch <= 0 and name not in off_route:
            failures.append(f"{name} was not launched on its route {route}")
        kernels.append({"name": name, "route": "cuda",
                        "source": "mobilequant_tpu_torch/" + src, "replaces": rep,
                        "launches": n_launch, "launch_route": route,
                        "max_abs_err": head["max_abs_err"],
                        "ms": head["ms"], "plain_ms": head["plain_ms"],
                        "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
                        "library_ms": head["library_ms"], "shape": head["shape"]})
    report = {"card": card, "build_s": build_s, "phase_start_s": PHASE_START_S,
              "device_profile_s": {"seconds": PROFILE_S[0], "calls": PROFILE_S[1]},
              "launch_floor_ms": {"zero_16B": launch_floor_ms, "copy_16B": copy_floor_ms},
              "report_s": time.perf_counter() - T_START, "kernels": kernels, "kernel_rows": rows,
              "kernel_checks": checks,
              "main_path": {"prefill_ms": stats["prefill_s"] * 1e3,
                            "decode_tok_s": stats["decode_tok_s"],
                            "prompt": PROMPT_LEN, "new_tokens": NEW_TOKENS,
                            "launches": launches,
                            "prefill_logits_rel_kernel_vs_plain": e_pre[1],
                            "decode_logits_rel_kernel_vs_plain": e_dec[1],
                            "breakdown": breakdown},
              "fused_model_stage_us": stage_us,
              "chunk_stage_us": chunk_stage_us,
              "serving": serve,
              "serving_chunk_vs_plain": chain_err,
              "routes": {"launches": runs, "seconds": route_s,
                         "short_prompt_prefill_ms": stats_s["prefill_s"] * 1e3,
                         "per_layer_decode_tok_s": stats_pl["decode_tok_s"],
                         "b4_decode_logits_rel_kernel_vs_plain": e4[1],
                         "b1_step": {"decode_logits_rel_kernel_vs_plain": e_dec[1],
                                     "k_cache_kernel_vs_plain": e_cache[0],
                                     "v_cache_kernel_vs_plain": e_cache[1],
                                     "witness_logits_rel_vs_plain": e_wit[1],
                                     "witness_caches_equal": wit_equal},
                         "attn_decode_tok_s": stats_a["decode_tok_s"],
                         "attn_vs_plain": {"logits_rel": e_al[1], "k_rows": e_ak,
                                           "v_rows": e_av}},
              "w8": {"serving": serve8, "fused_model_stage_us": stage_us8,
                     "chunk_stage_us": chunk_stage_us8,
                     "b1_step": {"prefill_logits_rel_kernel_vs_plain": e8_pre[1],
                                 "decode_logits_rel_kernel_vs_plain": e8_dec[1],
                                 "k_cache_kernel_vs_plain": e8_cache[0],
                                 "v_cache_kernel_vs_plain": e8_cache[1],
                                 "witness_logits_rel_vs_plain": e8_wit[1],
                                 "witness_caches_equal": wit8_equal},
                     "attn_all_vs_plain": {"logits_rel": e8_al[1], "k_rows": e8_ak,
                                           "v_rows": e8_av}},
              "weight_only": {"serving": wonly, "chain_kernel_vs_plain": wchain},
              "mlp_routes": mlp_routes,
              "stablelm": {"serving": serve_s, "fused_model_stage_us": stage_us_s,
                           "chunk_stage_us": chunk_stage_us_s, "b1_step": b1_s,
                           "chunk_vs_plain": chain_s},
              "quantize": quant,
              "hd128": hd128,
              "convert": converted,
              "serving_batcher": serving_v,
              "gemma": {"serving": serve_g, "fused_model_stage_us": stage_us_g,
                        "chunk_stage_us": chunk_stage_us_g, "b1_step": b1_g,
                        "chunk_gate": {str(k): v for k, v in gate_g.items()},
                        "chunk_vs_plain": chain_g}}
    (out_dir / "chip_smoke.json").write_text(json.dumps(report, indent=1))
    if failures:
        fail("; ".join(failures))
    print(f"card: {card}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
