#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main paths on one NVIDIA card and check them.

    python3 chip_smoke.py          # from the repo root, on a machine with a card
    python3 chip_smoke.py --time-wkv-bwd TREE   # the WKV backward of checkout TREE alone
    python3 chip_smoke.py --time-mamba-scan TREE   # the selective scan of checkout TREE alone
    python3 chip_smoke.py --time-jamba-engine TREE   # jamba's engine on checkout TREE's port
    python3 chip_smoke.py --time-mesh   # rwkv6-7b, no mesh against a (1, 1) mesh, in turns
    python3 chip_smoke.py --time-decode TREE   # kernel #1's decode rows of checkout TREE alone
    python3 chip_smoke.py --time-lm-host TREE   # phase 5's decode steps on checkout TREE's port

Ten main paths, each at the full width of its model:

* EPIM-ResNet-50 at 3-bit epitome-aware quantization,
  ``get_resnet("resnet50", "kernel-q3")`` -> ``prepack`` -> ``apply``: 45
  epitomized layers, each one launch of the fused int8 kernel (and at
  ``kernel``, 45 launches of the float32 epitome kernel);
* serving rwkv6-7b at kernel-q3 in bf16, ``get_config("rwkv6-7b",
  "kernel-q3")`` -> ``lm.init_params`` -> ``lm.prepack_params`` ->
  ``serve.generate``: 32 layers, each 8 launches of the fused int8 kernel
  per forward and one launch of the WKV kernel per prefill;
* the same at ``kernel``: each projection one launch of the epitome
  kernel's bf16 entry;
* a searched EPIM-ResNet-50 plan, ``get_resnet("resnet50",
  "evo-latency-q3")``: the Algorithm-1 search legalized to the kernel-exact
  families, 38 epitomized layers; and kernel #5, the dense int8
  ``ops.quant_matmul``, at rwkv6-7b's projection shapes;
* serving qwen2-72b at kernel-q3 in bf16 at full width and depth (80
  layers, d_model 8192, vocab 152064), the same entry points: attention
  (plain PyTorch, GQA, RoPE, KV cache) and the dense SwiGLU FFN, each of
  the 7 projections a launch of the fused int8 kernel per forward;
* serving gemma2-2b at kernel-q3 in bf16 (26 layers, local/global
  attention, softcaps, tied head) on a prompt longer than its window;
* the continuous-batching engine, ``launch.engine.EngineConfig(...).build()``
  -> ``submit`` -> ``step``, serving rwkv6-7b (dense slot rows) at full
  width and depth and qwen2-72b (block-paged KV, an oversubscribed pool)
  at full width cut to 16 layers, at kernel-q3 in bf16: bucketed and
  chunked prefill (kernel #4 from the carried state of the last chunk),
  fused decode macro-steps;
* serving phi3.5-moe at kernel-q3 with bf16 parameters (16 of its 32 layers, d_model
  4096, 16 experts of ff 6400, top 2, vocab 32064): attention and the MoE
  FFN (every expert on every token, the masked combine), kernel #1 at the
  four attention projections, through ``serve.generate`` and through
  ``launch.engine.EpimEngine``, whose MoE prompts prefill whole at their
  exact length;
* training rwkv6-7b at folded-q3 (fake-quantized epitomes) at full width
  and depth, ``train.loop.init_state`` -> ``make_train_step`` ->
  ``train_loop`` (what ``launch.train`` runs): each layer a launch of kernel
  #4 forward, again in the backward's recompute, and one of its backward
  kernel (``wkv6_chunked_bwd``);
* serving jamba-1.5-large at kernel-q3 in bf16 at published widths, its
  depth cut to one period of 8 of its 72 layers (7 Mamba, 1 attention;
  d_model 8192, d_inner 16384, 16 states, vocab 65536), its MoE FFN
  positions set to none (their
  experts wait on scale-out), through ``serve.generate`` and through
  ``launch.engine.EpimEngine``: each Mamba layer one launch of the
  selective-scan kernel (``mamba_scan``) a forward, prefill and decode
  alike, and kernel #1 at its 4 projections, the attention's 4 and the
  dense FFN's 3.

Besides, phase 15 tunes the searched ResNet-50 plan's kernel blocks on the
card and searches a plan by kernel latency measured there, and serves both;
phase 16 serves rwkv6-7b sharded by placement on a (1, 1) NCCL mesh
(``launch.mesh``), bit for bit against the same model without a mesh.

Phases:

1. build   — nvcc builds the kernels from ``src/repro_torch/kernels/csrc``;
             prints ptxas' registers, shared memory and spills, and the
             card's name and power limit as nvidia-smi gives them.
2. kernels — each of the three kernels at each of ResNet-50's 16 distinct
             kernel shapes (batch 32, 224x224) against its plain PyTorch
             version on the card, then timed beside its plain version and
             the torch.matmul yardstick, with its bounds; kernel #1's rows
             also time the fold (ops.fold_rows) that kernel #2 takes inside.
             Kernel and yardstick times are device times: 20 calls captured
             in a CUDA graph and replayed, timed by CUDA events (the eager
             time, host included, is kept beside them); the plain version is
             timed eagerly.  Bounds: the larger of the bytes over 3.35 TB/s
             and the operations over the peak of their type, the bf16 tensor
             cores (989 TFLOP/s) for the int8-code kernels #1, #2 and #5 and
             for #3's bf16 entry, three TF32 products for each FLOP (495
             TFLOP/s, 3xTF32) for #3's float32 entry and #4's four chunk
             products (the rest of #4's work at the fp32 rate, 67 TFLOP/s);
             the fp32-rate bound is kept beside it for every kernel; column
             blocks that read the same epitome columns give one product,
             whose operations are counted once (distinct_blocks).
3. forward — ResNet-50 kernel-q3, kernel and kernel-q3 with every layer's
             fold inside the kernel (fused_fold), from seeded weights at
             batch 32: each launch counter must rise by exactly 45 per
             forward; then the same model at batch 2 on the card against
             the plain versions on the CPU.
   The batch-32 forward is timed and its peak memory recorded; the batch-2
   check of each path is made again at four more seeds (weights and
   images) and its largest reading and margin logged.
4. LM kernels — the int8 kernel in bf16 and float32 at rwkv6-7b's three
             projection shapes, at prefill rows (4 x 256) and decode rows
             (4), and the WKV kernel at 4 x 256 tokens x 64 heads of 64 from
             a non-zero state with r, k, v in bf16 (the LM's, counted) and in
             float32, each against its plain version and timed;
             the bf16 rows also against a bf16 yardstick (bf16 x times the
             bf16-dequantized weight); the decode rows three times bit for
             bit, and timed L2-cold too (over copies of the codes and of the
             yardstick's weight past 64 MB, as a decode step reads 256
             distinct weights); the WKV kernel under strong decay (log w =
             -20) must stay finite.
5. LM path — rwkv6-7b kernel-q3 (bf16, 32 layers, full width) from seeded
             weights on the card: generate 32 greedy tokens for 4 prompts
             of 256 with exactly 8192 launches of the int8 kernel and 32 of
             the WKV kernel; then prefill and decode timed (three prefills
             must give the same logits bit for bit), peak memory and a
             profile of one prefill and one decode step.
6. LM card vs CPU — the same config in float32 cut to 2 layers: prefill and
             decode logits and greedy tokens of one 80-token prompt on the
             card against the plain versions on the CPU.
6b. LM kernel — rwkv6-7b at ``kernel``: the epitome kernel's bf16 entry at
             the three projection shapes, prefill and decode rows, against
             its plain version and timed beside cuBLAS bf16 and the per-call
             cast of E to bf16 (decode rows three times bit for bit, and
             L2-cold); then phase 5 at ``kernel`` (8192 launches of the
             epitome kernel, 32 of the WKV kernel, none of the int8 one),
             and phase 6 at ``kernel``.
7. quant_matmul — kernel #5 through ``ops.quant_matmul`` at rwkv6-7b's
             three dense projection shapes, float32 and bf16, prefill and
             decode rows, and a ragged T = 7 with leading dims: one launch
             per call, held against its plain version, then timed (the bf16
             rows also beside cuBLAS bf16 on the bf16 weight); then at
             the reference test's code scales, float32, each shape held
             against the float64 product, no less accurate than cuBLAS.
8. plan    — ``get_resnet("resnet50", "evo-latency-q3")``: the searched,
             legalized plan saved under build/ and reloaded with ``plan=``
             (identical per-layer configs); each of its kernel shapes against
             the plain versions and timed; the batch-32 forward with exactly
             38 launches of the int8 kernel, and the same plan with every
             fold inside the kernel (38 launches of that kernel only), each
             timed and held against the CPU at batch 2.
9. attention LMs — for qwen2-72b and gemma2-2b at kernel-q3: the int8
             kernel at each epitomized projection spec, bf16 (counted) and
             float32, at the path's prefill rows (4 x 256; 1 x 4608) and
             decode rows (4; 1), against its plain version, timed beside the
             cuBLAS float32 and bf16 yardsticks, decode rows three times bit
             for bit; then phase 5's generate (4 x 256 + 32 tokens, exactly
             7 x 80 launches a forward; 1 x 4608 + 16, exactly 5 x 26), three
             prefills bit for bit, timed and profiled; then phase 6 at full
             width cut to 2 float32 layers, at a float32 and an int8 KV cache
             (gemma2 with a window of 64 under a 256-token prompt).
10. engine — for rwkv6-7b (dense pool) and qwen2-72b at 16 of its 80
             layers (pages of 16, 48 of them, so admission defers): capacity 4, max_len 320, chunk 64, 8 greedy requests of
             5-288 tokens and 2 sampled, 16/24/32 new tokens.  At K = 4
             (counted), at K = 1 and in reverse order: every request
             completes with its tokens, in submission order; admitted =
             completed = 10, 6 slot reuses, no page held after the drain;
             launches exact (kernel #1 256 or 112 a forward, kernel #4 32 a
             prefill or chunk); K = 1 and the reverse order give the same
             tokens bit for bit.  Greedy requests against one-shot generate
             (all 8; 2 at qwen2-72b): first-token logits in float32 (the
             same weights) within 1e-4 of their scale (bf16's recorded
             beside the one-shot's own spread between 1 and 4 rows); tokens
             equal, or parting where the engine's own computation of the
             request replayed at 4 decode rows picks the engine's token
             (the one-shot decodes at 1 row).  Kernel #1 and #4 at the
             engine's rows against their plain versions and timed; a 2-layer
             float32 engine on the card against the CPU's (1e-4).
12. MoE LM — phi3.5-moe kernel-q3, bf16 parameters from seed 0, at the
             16 of its 32 layers, 1.5 GiB of the card left free
             (the bytes held logged): (a) kernel #1 at its two epitomized
             specs as phase 9 takes them; (b) phase 5's generate (4 x 256 +
             32, exactly 64 launches a forward at 16 layers), three
             prefills bit for bit, timed and profiled, the MoE FFNs' device
             time beside kernel #1's; (d) phase 10's requests through the
             engine on the same weights (pages of 16, none deferred): every
             prompt prefilled whole at its length, 69 micro-steps at K = 4,
             launches exact, K = 1 and reverse order bit for bit, requests
             0, 2, 4, 7 against one-shot in bf16 (a float32 pass of the
             full model does not fit beside it), kernel #1 at the engine's
             rows; then, the model freed, (c) phase 6 at 2 float32 layers
             with the router's experts equal on the card and the CPU (the
             smallest top-k logit gap logged) and phase 10's 2-layer
             float32 engine card vs CPU.
13. training — rwkv6-7b folded-q3, after phase 12 has freed the card:
             (a) the WKV backward kernel at 8 x 256 tokens x 64 heads of 64
             (bf16 r, k, v with a zero state, counted; float32 with h0 and
             dhT, and with neither; a ragged S = 250) against its plain
             version and against autograd through the chunked plain forward
             (the WKV gate), three launches bit for bit, timed beside its
             plain version and its bound (fp32 rate), and kernel #4 forward
             at the same shape; (b) 2 float32 layers at full width, 2 x 64
             tokens: loss, every gradient leaf and the parameters after one
             AdamW step on the card against the CPU; kernel and kernel-q3
             refuse backward() on the card; (c) 32 layers, bf16 compute,
             float32 AdamW moments, SyntheticData 8 x 256: a warm-up step
             (exactly 64 forward and 32 backward WKV launches, no kernel #1
             or #3; u, w0 and the E of wr/wk/wv with non-zero gradients),
             3 timed steps through train_loop (counted; losses and grad
             norms finite and > 0), one step profiled, the optimizer and
             fake quant timed, peak memory; the warm-up step again from a
             fresh state of the same seed: loss, gradients and new state bit
             for bit; (d) 2 layers: an async checkpoint at step 2 restored
             into a fresh state, whose steps 2-3 equal the straight run's bit
             for bit.
14. Mamba  — after phase 13 has freed the card: (a) the scan kernel at
             jamba's width (d_inner 16384, 16 states): 4 x 256 tokens with
             bf16 and float32 dt, x, B, C, a zero and a random h0, a ragged
             S = 250, S = 1 at batch 4 and 1, each against its plain
             version (mamba_scan_ref) at KERNEL_TOL on y and hT, timed
             beside it, its bound (bytes, or its operations at the fp32
             rate) and the SFU's time for its exponentials; bit for bit:
             128 + 128 tokens through hT against one launch, dt = 0 on the
             last 7 tokens leaving the state as it stood, three launches,
             bf16 against float32 of the same values, each row of a 4-row
             launch (S = 1, 128) against its 1-row launch, 8 one-token
             launches against one of 8; ptxas' registers and spills (a
             vector instance that spills fails).  (b) jamba kernel-q3, 8
             layers (one period), MoE positions none, bf16 (the bytes it
             holds logged, 1.5 GiB of the card left free): phase 5's generate
             (4 x 256 + 32; exactly 44 launches of kernel #1 and 7 of the
             scan a forward), three prefills bit for bit, timed and profiled, the
             scan's share of busy; kernel #1 at its specs and rows (bf16).
             (c) phase 10's requests through the engine on the same
             weights (pages of 16, chunk 64 rounded to 128: 9 chunks, 77
             micro-steps at K = 4, counted on the CPU), launches exact, K =
             1 and reverse order bit for bit, requests 1 and 4 against
             one-shot; the scan and kernel #1 at the engine's rows.  (d)
             float32 card against CPU: jamba's widths at 2 Mamba layers
             with the dense FFN, 2 x 64 tokens, and the jamba smoke config
             (16 layers: Mamba, attention, MoE) with the router's experts
             equal; backward() through the scan refuses on the card.
15. tuning — on phase 8's evo-latency-q3 plan at batch 32 x 224^2, with
             caches of its own under build/tune: (a) ``autotune.tune`` over
             the default grid (iters 5) at the plan's most-launched kernel
             shape: one line per candidate (bk, bn, fold), its time, bit
             identity and error against the float64 oracle; the winner no
             slower than the heuristic, source ``timed``, and a second call
             ``cache`` with no launch; (b) ``tune_plan(t=32, grid="tiny")``,
             the tuned plan saved under build/ and reloaded with ``plan=``:
             its batch-32 forward launches kernel #2 once per fused-fold
             winner and kernel #1 once per other layer, and where every
             winner is bit-identical its logits equal the untuned plan's
             bit for bit; both forwards timed, 5 times each, interleaved;
             (c) ``search_plan(cost=measured_cost_for("resnet50", t=1))``
             (population 16, 8 generations) and ``legalize_plan(cost=)``:
             the cost model stays available, then the same search twice from
             the warm cache, 0 timings each, whose plan JSON match byte for
             byte (and the cold one's but for each layer's source, memo
             against cache); the measured plan's batch-32 forward with
             exact launches; (d) ``calibrate_tiny_coefficients`` on the card
             beside the stored coefficients.  The phase's launches are its
             own, outside phase 11's sums.
16. mesh   — sharded serving on a (1, 1) NCCL mesh (one card: no traffic
             between ranks; the mesh path's layout, gathers and kernels):
             (a) rwkv6-7b from a plan searched (population 6, 3 iterations)
             and legalized for the mesh, every layer with a placement, at
             full width and depth in bf16: phase 5's generate and timed
             prefill and decode steps without a mesh, then with the packed
             tree laid out by placement (``lm.shard_params``; 256 int8 code
             leaves), logits and tokens bit for bit and launches equal, and
             both trees' prefill and decode step in turns (5 rounds;
             ``--time-mesh`` runs 20 alone);
             (b) ``python -m repro_torch.launch.plan run --mesh 1,1`` on the
             smoke plan in a subprocess, both ``bit-identical=True`` lines;
             (c) ``EngineConfig(mesh="1,1")`` serving phase 10's requests at
             K = 4, greedy tokens and launches equal to phase 10's.  The
             process group is destroyed at the end.  Its mesh runs' launches
             enter phase 11's sums, timed at the plan's shapes.
11. times  — each kernel's times and bounds summed over the launches of
             the main paths (the ResNet forwards, one LM generate at each
             variant and of each attention LM and of the MoE LM, the
             quant_matmul calls, the engine's K = 4 runs, the 3 timed
             training steps, jamba's generate and engine run, phase 17's
             3 mesh steps); kernel #2 beside kernel #1 plus the fold on
             each ResNet path.  Run last.
17. mesh training — after phase 16 has ended its process group: (a)
             phase 13 (c)'s rwkv6-7b folded-q3 (32 layers, bf16 compute,
             float32 parameters and moments, 8 x 256, seed 0) on a (1, 1)
             NCCL mesh through ``init_state(mesh=)``: the warm-up step's
             loss, gradients and new state bit for bit against phase 13's
             (64 launches of kernel #4 and 32 of its backward, no other),
             then 3 steps through ``train_loop`` (counted), their median
             ms and peak beside phase 13's; (b) at 2 layers an async
             checkpoint at step 2 of a mesh run, restored with
             ``shardings=`` on the mesh and on one card with no mesh, both
             runs' steps 2-3 the straight run's bit for bit; (c)
             ``torchrun --standalone --nproc-per-node 1 -m
             repro_torch.launch.train`` (NCCL) for 10 steps with a
             checkpoint, then for 14, which restores step 10: two
             processes, run one after the other beside (b).
18. dry run — (a) kernel #1 through ``ops.quant_epitome_matmul`` at
             rwkv6-7b's 3 and qwen2-72b's 4 projection specs in bf16: each
             row of a T-row call against the same row of a 1-row call, bit
             for bit, for T = 1, 2, 4, 8, 9, 16, 32, 33, 64 (every T <= 32,
             the decode loop, must match; past it the tensor-core loop's
             rows are reported), each shape then against its plain version
             and timed (counted launches); (b) ``launch/dryrun.py``, run in
             a subprocess on the host from the end of phase 1 (its tensors
             fake, its world of one), on phase 13's training step and phase
             5's prefill and decode step: its kernels' launches a step equal
             those the phases counted, its argument bytes are within 1 % of
             what the card allocated for the step's inputs, its roofline's
             bound and three terms (H100 data-sheet constants) are at most
             the step's measured device-busy time, its useful ratio is at
             most 1 and its roofline fraction at most 1.05, and its 1- and
             2-group probes extrapolate to the full trace's counts within
             0.1 %; the predicted peak beside the measured one.

Any failure exits nonzero.  The line before the last is a JSON object
listing the kernels; the last line is ``{"ok": true, "device": ...}``.
Details go to ``build/chip_smoke.json``.
"""
from __future__ import annotations

import dataclasses
import itertools
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

# phase 12 holds a 76 GiB model on an 80 GB card: grow segments rather than
# strand freed blocks (set before torch is imported)
os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
ROOT = Path(__file__).resolve().parent
BATCH, IMAGE, SEED = 32, 224, 0
SFU_EXP_S = 132 * 16 * 1.98e9   # H100 SXM exponentials a second: 16 a clock an SM at boost
# every kernel's bytes and operations, the H100's data-sheet rates and the
# bound a launch could reach on them are repro_torch.kernels.cost's
# (``_cost()``): the dry run counts the same work
FP_KERNEL = "epitome_matmul_blocks"
WKV = "wkv6_chunked"
L2_COLD_BYTES = 64 << 20    # code buffers rotated past the 50 MB L2 for cold timings
KERNEL_TOL = 2e-4           # |y - ref| <= tol + tol*|ref|, fp32 (tests/test_kernels.py:17-18)
BF16_TOL = 2e-2             # the same in bf16 (tests/test_kernels.py:17-18)
WKV_TOL = 1e-3              # the WKV, fp32 (tests/test_kernels.py:85)
# Logits of the card against the CPU, relative to max(1, max|logit|): the
# tolerance of the CPU parity tests against the JAX reference.  fp32 sums
# run in another order through 53 conv/matmul layers, each followed by
# batch-statistics BatchNorm that rescales the differences by 1/std.
# The LM's card-vs-CPU check keeps it: float32 through 2 layers of 8
# projections and the WKV recurrence, summed in other orders on the card.
LOGIT_TOL = 1e-4
LOGIT_SEEDS = (1, 2, 3, 4)   # more seeds for the ResNet logits check, beside SEED
LM_ARCH, LM_REQUESTS, LM_PROMPT, LM_NEW = "rwkv6-7b", 4, 256, 32
CPU_LAYERS, CPU_PROMPT, CPU_NEW = 2, 80, 4   # 80 = one 64-token chunk + a ragged 16
# the attention LMs at kernel-q3, bf16, full width and depth: (arch,
# requests, prompt, new tokens, kernel #1 launches a forward = epitomized
# sites x layers, overrides of the 2-layer float32 card-vs-CPU check and its
# prompt).  qwen2-72b takes rwkv6-7b's traffic; gemma2-2b one prompt longer
# than its 4096-token window, so its local layers mask on the card, and its
# CPU check a window of 64 under a 256-token prompt
ATTN_PATHS = (
    ("qwen2-72b", LM_REQUESTS, LM_PROMPT, LM_NEW, 7 * 80, {}, CPU_PROMPT),
    ("gemma2-2b", 1, 4608, 16, 5 * 26, {"window": 64}, 256),
)
# phase 10, the serving engine, both LMs at kernel-q3 in bf16 at full width
# from seed 0: (arch, KV page size (0 = dense rows), KV pool pages, depth
# (None: the config's), kernel #1 launches a forward, the greedy requests
# held to a one-shot generate).  qwen2-72b's pool is oversubscribed: its
# requests pin 2-20 pages each, and at 48 pages (below the 80 of four
# 20-page slots) admission defers at four steps of this schedule; at 52 or
# more it never would (the schedule's high-water mark is 52 pages, whatever
# the weights or the depth).  qwen2-72b's engine runs 16 of its 80 layers:
# its host-bound runs took 136-267 s at 80 on the H100's hosts, and the
# script must end within 1200 s on the slowest of them (phase 9 serves the
# 80 layers one-shot)
ENGINE_PATHS = (
    ("rwkv6-7b", 0, 0, None, 8 * 32, tuple(range(8))),
    ("qwen2-72b", 16, 48, 16, 7 * 16, (1, 4)),
)
ENGINE_CAPACITY, ENGINE_MAX_LEN, ENGINE_CHUNK, ENGINE_BLOCK = 4, 320, 64, 4
# greedy prompts: three fit a bucket (8, 64, 64), five take 2-5 chunks; then
# two sampled at temperature 0.8; new tokens cycle through 16, 24, 32
ENGINE_PROMPTS = (5, 37, 64, 65, 130, 200, 256, 288)
ENGINE_SAMPLED, ENGINE_TEMPERATURE = (6, 100), 0.8
ENGINE_NEW = (16, 24, 32)
ENGINE_CPU_PROMPTS = (5, 130)   # the 2-layer float32 card-vs-CPU engine run
# phase 12, the MoE LM: phi3.5-moe kernel-q3 at full width with bf16
# parameters (the published weights' dtype; float32 experts alone would be
# 161 GB), kernel #1 at wq, wk, wv and wo of every layer (the experts are
# plain batched matmuls, never epitomized).  Depth: the first of MOE_DEPTHS whose
# parameters leave MOE_WORKSPACE bytes of the card free (the phase peaks
# 1.1-1.4 GiB above its parameters on the H100); 16 of its 32 layers, which
# fit (32 did, with 1.64 GiB free), to keep the script within its time.  Its engine takes phase
# 10's requests on dense-capacity pages of 16 (kv_pages 0) and prefills
# every prompt whole at its length, so the K = 4 run makes MOE_MICRO decode
# micro-steps (the schedule, counted on the CPU at smoke size: it does not
# depend on the weights); MOE_ONESHOT are the greedy requests held to
# one-shot generate
MOE_ARCH, MOE_SITES = "phi3.5-moe-42b-a6.6b", 4
MOE_DEPTHS = (16,)
MOE_WORKSPACE = 3 << 29   # 1.5 GiB
MOE_PAGE, MOE_MICRO, MOE_ONESHOT = 16, 69, (0, 2, 4, 7)
# phase 13, training: rwkv6-7b folded-q3 (fake-quantized epitomes, the
# reference's QAT mode) at full width and depth, bf16 compute with float32
# parameters and AdamW moments (37.5 GB of state), TRAIN_BATCH x TRAIN_SEQ
# tokens a step; the card-vs-CPU and restart checks at CPU_LAYERS layers and
# TRAIN_CPU_BATCH x TRAIN_CPU_SEQ.  Gradients and parameters are held at the
# WKV gate |g - ref| <= GRAD_TOL + GRAD_TOL |ref|: the stricter of the WKV's
# (tests/test_kernels.py:85) and the reference's folded-gradient tolerance
# (rtol 1e-3, atol 1e-2; tests/test_epitome.py:91)
TRAIN_ARCH, TRAIN_VARIANT = "rwkv6-7b", "folded-q3"
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 8, 256, 3   # 5 steps until phase 17 came
TRAIN_CPU_BATCH, TRAIN_CPU_SEQ = 2, 64
TRAIN_CPU_LR = 1e-2         # the card-vs-CPU AdamW step: no warm-up, so it moves ~lr
GRAD_TOL = 1e-3
WKV_BWD = "wkv6_chunked_bwd"
# phase 14, Mamba: jamba-1.5-large at kernel-q3 in bf16 at published widths,
# cut to MAMBA_DEPTH layers, one period of its 72 (7 Mamba, 1 attention; the
# 72 layers' host-bound runs took 93-211 s), its MoE FFN positions set to
# none (a period of 8 layers holds four MoE FFNs of 19.3 GB each, which
# wait on scale-out), so its 4 dense FFNs stay; kernel #1
# at the 4 Mamba projections, the 4 attention ones and the 3 dense FFN ones
# of each layer (MAMBA_SITES a forward), the scan once a Mamba layer a
# forward.  The kernel is held at KERNEL_TOL on jamba's width (d_inner
# 16384, 16 states).  The engine takes phase 10's requests on pages of 16
# at chunk ENGINE_CHUNK, which rounds up to the scan's 128-token window; its
# K = 4 run makes MAMBA_MICRO decode micro-steps and MAMBA_CHUNKS prefill
# chunks (the schedule, counted on the CPU at smoke size)
MAMBA = "mamba_scan"
MAMBA_ARCH, MAMBA_FFN = "jamba-1.5-large-398b", ("dense", "none") * 4
MAMBA_DEPTH = 8
MAMBA_SITES, MAMBA_LAYERS = 7 * 4 + 1 * 4 + 4 * 3, 7
MAMBA_MICRO, MAMBA_CHUNKS, MAMBA_ONESHOT = 77, 9, (1, 4)
MAMBA_WORKSPACE = 3 << 29   # 1.5 GiB the phase needs free beside the parameters
# phase 16, sharded serving: rwkv6-7b from a plan searched (the reference
# test's search size) and legalized for a (1, 1) mesh, served on a (1, 1)
# NCCL mesh with its codes laid out by placement, held bit for bit to the
# same plan without a mesh; the plan CLI's own check on a smoke plan; and
# phase 10's rwkv6-7b requests through EngineConfig(mesh="1,1")
MESH_EVO = dict(population=6, iterations=3, seed=0)
MESH_PATH = f"{LM_ARCH} mesh 1,1"
MESH_TURNS = 5          # phase 16's in-turns rounds
MESH_AB_ROUNDS = 20     # --time-mesh
# phase 17, training on a mesh: phase 13 (c)'s rwkv6-7b on a (1, 1) NCCL mesh
# through init_state(mesh=), its warm-up step held to phase 13's bit for bit,
# then MESH_TRAIN_STEPS steps through train_loop (counted); the restart at
# CPU_LAYERS layers; the train CLI under torchrun, MESH_CLI_STEPS then more
MESH_TRAIN_STEPS = 3
MESH_TRAIN_PATH = f"{TRAIN_ARCH} {TRAIN_VARIANT} train mesh 1,1"
MESH_CLI_STEPS = (10, 14)
# phase 18, the dry run held to the card: (a) kernel #1's rows at rwkv6-7b's
# and qwen2-72b's specs (M, N, m, n, bm, bn; tests/test_torch_cuda.py's
# LM_SHAPES and QWEN2_SHAPES), bf16, a row of a T-row call against the same
# row of a 1-row call for each T of ROW_T; (b) launch/dryrun.py's trace of
# phase 13's step and phase 5's prefill and decode step on a fake world of
# one, started in a subprocess beside phase 2 (DRYRUN_TIMEOUT seconds)
ROW_T = (1, 2, 4, 8, 9, 16, 32, 33, 64)
ROW_SPECS = (("rwkv6-7b", (4096, 4096, 1024, 4096, 256, 256)),
             ("rwkv6-7b", (4096, 14336, 1024, 14336, 256, 256)),
             ("rwkv6-7b", (14336, 4096, 3584, 4096, 256, 256)),
             ("qwen2-72b", (8192, 8192, 2048, 8192, 256, 256)),
             ("qwen2-72b", (8192, 1024, 8192, 256, 256, 256)),
             ("qwen2-72b", (8192, 29568, 8192, 256, 256, 256)),
             ("qwen2-72b", (29568, 8192, 7392, 8192, 256, 256)))
DECODE_TIMED_T = (1, 4, 8, 16, 32)      # --time-decode
DRYRUN_TIMEOUT = 900
ARG_TOL = 0.01          # the dry run's argument bytes against the card's allocation
PROBE_TOL = 1e-3        # the dry run's probes against its full trace
SHARE_MAX = 1.05        # a roofline fraction past this is an impossible reading
LM_HOST_STEPS = 20      # --time-lm-host: decode steps timed a run
KERNELS = {   # kernel -> (source, the TPU kernel it replaces)
    "quant_epitome_matmul_blocks": (
        "src/repro_torch/kernels/csrc/quant_epitome_matmul.cu",
        "src/repro/kernels/quant_epitome_matmul.py:66"),
    "quant_epitome_matmul_fused_fold": (
        "src/repro_torch/kernels/csrc/quant_epitome_matmul.cu",
        "src/repro/kernels/quant_epitome_matmul.py:143"),
    "epitome_matmul_blocks": (
        "src/repro_torch/kernels/csrc/epitome_matmul.cu",
        "src/repro/kernels/epitome_matmul.py:50"),
    "wkv6_chunked": (
        "src/repro_torch/kernels/csrc/wkv6.cu",
        "src/repro/kernels/wkv6.py:58"),
    "quant_matmul": (
        "src/repro_torch/kernels/csrc/quant_matmul.cu",
        "src/repro/kernels/quant_matmul.py:41"),
    # kernel #4's gradient: the TPU package differentiates its jnp
    # recurrence (src/repro/models/ssm.py:127) and has no backward kernel
    "wkv6_chunked_bwd": (
        "src/repro_torch/kernels/csrc/wkv6_bwd.cu",
        "src/repro/kernels/wkv6.py:58"),
    # Mamba's scan: no TPU kernel; the reference runs an associative scan in
    # plain jnp inside a checkpointed window body
    "mamba_scan": (
        "src/repro_torch/kernels/csrc/mamba_scan.cu",
        "none (no TPU kernel): the jnp scan src/repro/models/ssm.py:320, :395-411"),
}
QUANT = "quant_epitome_matmul_blocks"


# phase 12 runs the helpers of phases 5-10 on the MoE LM and prints their
# lines under its own tags ([lm] -> [moe], ...)
_RETAG = {}


def log(*a):
    line = " ".join(str(x) for x in a)
    tag = next((t for t in _RETAG if line.startswith(t)), None)
    print(line if tag is None else _RETAG[tag] + line[len(tag):], flush=True)


def _cost():
    """``repro_torch.kernels.cost`` (the port's ``src`` is on the path by
    the time a phase runs): each kernel's bytes and operations, the card's
    data-sheet rates and the bounds on them."""
    from repro_torch.kernels import cost
    return cost


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(torch, fn, budget_ms: float = 40.0) -> float:
    """Mean device time of fn() over a run of launches, by CUDA events,
    after a warm-up call."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    reps = max(3, min(200, math.ceil(budget_ms / max(1e-3, 1e3 * (time.perf_counter() - t0)))))
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


_SIDE = {}


def graph_ms(torch, fn, calls: int = 20) -> float:
    """Device time of one fn() with the host out of the way: ``calls`` calls
    captured in one CUDA graph, the graph replayed and timed by CUDA events
    (time_ms), per call.  A kernel faster than its wrapper's host work (the
    decode rows) is timed eagerly at the host's pace, not its own."""
    fn()
    # one warm-up stream for every call: cuBLAS keeps a workspace per stream
    # it has run on, which would otherwise pile up in the memory readings
    if "stream" not in _SIDE:
        _SIDE["stream"] = torch.cuda.Stream()
    side = _SIDE["stream"]
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    ms = time_ms(torch, graph.replay) / calls
    del graph
    return ms


def device_breakdown(torch, fn) -> list:
    """Device time of one call of fn by kernel, [(name, ms, calls)] sorted
    by time, from torch.profiler; [] where the profiler sees no device
    time (then the breakdown is not measured)."""
    from torch.profiler import ProfilerActivity, profile
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
    except RuntimeError as e:       # no device tracing here: a gap, not a fault
        log(f"[profile] not measured: {e}")
        return []
    timed = [e for e in prof.key_averages() if (e.self_device_time_total or 0) > 0]
    # kernels where the profiler lists them on their own, else the ops that
    # launched them
    kernels = [e for e in timed if e.device_type == torch.autograd.DeviceType.CUDA]
    rows = [(e.key, e.self_device_time_total / 1e3, e.count) for e in kernels or timed]
    return sorted(rows, key=lambda r: -r[1])


def max_err(torch, y, ref, tol: float, what: str) -> float:
    """Largest |y - ref|; raises if y is not finite or any element is past
    tol + tol |ref|.  Compares in float32, or in float64 for a float64 ref."""
    dt = torch.float64 if ref.dtype == torch.float64 else torch.float32
    y, ref = y.to(dt), ref.to(dt)
    err = (y - ref).abs()
    bad = err > tol + tol * ref.abs()
    if not torch.isfinite(y).all() or bool(bad.any()):
        raise AssertionError(f"{what}: {int(bad.sum())} elements over tolerance, "
                             f"max |y - ref| = {float(err.max()):.3e}")
    return float(err.max())


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card is visible; this script measures the card "
              "and has no CPU mode", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    try:
        from repro_torch.configs import get_resnet
        from repro_torch.kernels import (KERNELS as WRAPPERS, _build, launch_counts,
                                         ops, ref, reset_launch_counts)
    except ImportError as e:
        print(f"chip_smoke: the port's package is not beside this script ({e})",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    card = card_line()
    report = {"card": card, "torch": torch.__version__, "cuda": torch.version.cuda}
    t_start = time.perf_counter()
    log(f"[env] {kind} | {card} | torch {torch.__version__} cuda {torch.version.cuda} "
        f"| python {sys.version.split()[0]}")

    # -- 1. build ---------------------------------------------------------
    t0 = time.perf_counter()
    built = _build.build_all()
    report["build_s"] = time.perf_counter() - t0
    log(f"[build] {len(built)} libraries in {report['build_s']:.1f} s (sm_90a)")
    report["ptxas"] = []
    for name, text in _build.build_log.items():
        for line in text.splitlines():
            if "Compiling entry" in line or "registers" in line or "spill" in line:
                report["ptxas"].append(f"{name}: {line.strip()}")
                log(f"[build] {name}: {line.strip()}")

    # the dry run of phase 18 (b), on the host beside the card's phases
    dry = start_dryrun()

    # -- the ResNet path's kernel shapes -----------------------------------
    r50 = get_resnet("resnet50", "kernel-q3")
    shapes = {}
    for l, spec in zip(r50.layers, r50.specs):
        if spec is None:
            continue
        T = BATCH * (l.out_hw ** 2 if l.kind == "conv" else 1)
        shapes.setdefault((spec, T), []).append(l.name)
    n_layers = sum(len(v) for v in shapes.values())
    log(f"[shapes] {n_layers} epitomized layers in {len(shapes)} kernel shapes")
    if n_layers != 45 or len(shapes) != 16:
        raise AssertionError("ResNet-50 kernel-q3 should have 45 epitomized layers "
                             "in 16 shapes")

    # -- 2. kernels against their plain versions, and their times ---------
    gen = torch.Generator(device=dev).manual_seed(SEED)
    rows = []
    for (spec, T), names in shapes.items():
        for r in check_and_time(torch, dev, gen, ops, ref, WRAPPERS, spec, T):
            r.update(layers=names, count=len(names), path="resnet50")
            rows.append(r)
            log(f"[kernels] {r['kernel']} ({spec.M},{spec.N})->({spec.m},{spec.n}) T={T} "
                f"bk={r['pack_bk']} x{len(names)}: max_err={r['max_abs_err']:.2e} "
                f"ms={r['ms']:.4f} (eager {r['ms_eager']:.4f}) plain_ms={r['plain_ms']:.4f} "
                f"library_ms={r['library_ms']:.4f} bound_ms={r['bound_ms']:.4f} "
                f"({r['bound_by']}) bound_fp32_ms={r['bound_fp32_ms']:.4f} "
                f"bound_tc_ms={_ms(r['bound_tc_ms'], 4)}" + _fold_note(r))
        torch.cuda.empty_cache()

    # -- 3. the ResNet path, full width -------------------------------------
    images = torch.randn(BATCH, IMAGE, IMAGE, 3, device=dev, generator=gen)
    small = images[:2].contiguous()
    epitomized = [l.name for l, s in zip(r50.layers, r50.specs) if s is not None]
    paths = [("kernel-q3", None, "quant_epitome_matmul_blocks"),
             ("kernel", None, "epitome_matmul_blocks"),
             ("kernel-q3", {n: (None, True) for n in epitomized},
              "quant_epitome_matmul_fused_fold")]
    launches, forwards = {}, []
    for variant, tuned, kernel in paths:
        label = variant + ("+fused_fold" if tuned else "")
        fwd = resnet_forward(
            torch, label, lambda device: get_resnet("resnet50", variant, tuned=tuned,
                                                    device=device),
            kernel, 45, images, small, launch_counts, reset_launch_counts)
        launches[kernel] = fwd["launches"]
        forwards.append(fwd)
    torch.cuda.empty_cache()
    report["logit_seeds"] = logits_over_seeds(
        torch, dev, get_resnet, forwards, [(variant, tuned) for variant, tuned, _ in paths])
    report["resnet_s"] = time.perf_counter() - t_start

    # -- 4-6. the LM path -----------------------------------------------------
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import lm
    lm_cfg = get_config(LM_ARCH, "kernel-q3")
    lm_rows, fold = lm_kernels(torch, dev, gen, ops, ref, WRAPPERS, lm, lm_cfg)
    rows += lm_rows
    torch.cuda.empty_cache()
    lm_run = lm_path(torch, dev, lm, serve, lm_cfg, "kernel-q3",
                     {QUANT: 8 * lm_cfg.n_layers * LM_NEW, WKV: lm_cfg.n_layers},
                     launch_counts, reset_launch_counts)
    launches.update({QUANT: launches[QUANT] + lm_run["launches"][QUANT],
                     "wkv6_chunked": lm_run["launches"]["wkv6_chunked"]})
    torch.cuda.empty_cache()
    lm_cpu = lm_card_vs_cpu(torch, dev, lm, get_config, LM_ARCH, "kernel-q3")
    report["lm_s"] = time.perf_counter() - t_start - report["resnet_s"]

    # -- 6b. the LM at kernel: kernel #3's bf16 entry on every projection -----
    t0 = time.perf_counter()
    fp_cfg = get_config(LM_ARCH, "kernel")
    rows += lm_fp_kernels(torch, dev, gen, ops, ref, WRAPPERS, lm, fp_cfg)
    torch.cuda.empty_cache()
    lm_fp_run = lm_path(torch, dev, lm, serve, fp_cfg, "kernel",
                        {FP_KERNEL: 8 * fp_cfg.n_layers * LM_NEW, WKV: fp_cfg.n_layers},
                        launch_counts, reset_launch_counts)
    launches[FP_KERNEL] += lm_fp_run["launches"][FP_KERNEL]
    launches["wkv6_chunked"] += lm_fp_run["launches"]["wkv6_chunked"]
    # its WKV launches run at the shape and dtype timed with the kernel-q3 path's
    wkv = next(r for r in lm_rows if r["kernel"] == WKV and r["count"])
    rows.append(dict(wkv, path=f"{LM_ARCH} kernel"))
    torch.cuda.empty_cache()
    lm_cpu += lm_card_vs_cpu(torch, dev, lm, get_config, LM_ARCH, "kernel")
    report["lm_kernel_s"] = time.perf_counter() - t0

    # -- 7. kernel #5 through ops.quant_matmul --------------------------------
    t0 = time.perf_counter()
    qm_rows, qm_f64 = quant_matmul_phase(torch, dev, gen, ops, ref, WRAPPERS,
                                          launch_counts, reset_launch_counts)
    rows += qm_rows
    launches["quant_matmul"] = sum(r["count"] for r in qm_rows)
    torch.cuda.empty_cache()
    report["quant_matmul_s"] = time.perf_counter() - t0

    # -- 8. a searched plan drives the ResNet path -----------------------------
    t0 = time.perf_counter()
    plan_rows, plan_run = plan_phase(torch, dev, gen, ops, ref, WRAPPERS, get_resnet,
                                     images, small, launch_counts, reset_launch_counts)
    rows += plan_rows
    for fwd in plan_run["forwards"]:
        launches[fwd["kernel"]] += fwd["launches"]
    forwards += plan_run["forwards"]
    report["plan_s"] = time.perf_counter() - t0

    # -- 9. the attention LMs at kernel-q3: qwen2-72b, gemma2-2b -------------
    attn_runs, attn_cpu, report["attention_s"] = [], [], {}
    for arch, requests, prompt, new, per_fwd, cpu_over, cpu_prompt in ATTN_PATHS:
        t0 = time.perf_counter()
        cfg = get_config(arch, "kernel-q3")
        sites = sum(site_specs(lm, cfg).values()) * cfg.n_groups
        if sites != per_fwd:
            raise AssertionError(f"{arch}: {sites} epitomized projections, expected {per_fwd}")
        rows += quant_lm_rows(torch, dev, gen, ops, ref, WRAPPERS, lm, cfg, arch,
                              ((requests * prompt, 1), (requests, new - 1)), requests)
        run = lm_path(torch, dev, lm, serve, cfg, "kernel-q3", {QUANT: per_fwd * new},
                      launch_counts, reset_launch_counts, requests, prompt, new)
        launches[QUANT] += run["launches"][QUANT]
        attn_runs.append(run)
        torch.cuda.empty_cache()
        attn_cpu += lm_card_vs_cpu(torch, dev, lm, get_config, arch, "kernel-q3",
                                   kv_bits=(16, 8), prompt_len=cpu_prompt, **cpu_over)
        report["attention_s"][arch] = time.perf_counter() - t0

    # -- 10. the serving engine: rwkv6-7b and qwen2-72b kernel-q3 ------------
    engine_rows, engine_runs, engine_cpu, report["engine_s"] = engine_phase(
        torch, dev, gen, ops, ref, WRAPPERS, lm, serve, get_config, launch_counts,
        reset_launch_counts)
    rows += engine_rows
    for run in engine_runs:
        launches[QUANT] += run["launches"][QUANT]
        launches[WKV] += run["launches"][WKV]

    # -- 12. the MoE LM: phi3.5-moe kernel-q3, one-shot and through the engine --
    import gc
    gc.collect()
    torch.cuda.empty_cache()
    moe_rows, moe_report = moe_phase(torch, dev, gen, ops, ref, WRAPPERS, lm, serve, get_config,
                                     launch_counts, reset_launch_counts)
    rows += moe_rows
    launches[QUANT] += (moe_report["lm"]["launches"][QUANT]
                        + moe_report["engine"]["launches"][QUANT])

    # -- 13. training: rwkv6-7b folded-q3 at full width and depth -----------------
    train_rows, train_report = train_phase(torch, dev, gen, ref, WRAPPERS, lm, get_config,
                                           launch_counts, reset_launch_counts)
    rows += train_rows
    launches[WKV] += train_report["run"]["launches"][WKV]
    launches[WKV_BWD] = train_report["run"]["launches"][WKV_BWD]

    # -- 14. Mamba: jamba-1.5-large kernel-q3 (one period of layers), the scan kernel --
    mamba_rows, mamba_report = mamba_phase(torch, dev, gen, ops, ref, WRAPPERS, lm, serve,
                                           get_config, launch_counts, reset_launch_counts)
    rows += mamba_rows
    launches[QUANT] += (mamba_report["lm"]["launches"][QUANT]
                        + mamba_report["engine"]["launches"][QUANT])
    launches[MAMBA] = (mamba_report["lm"]["launches"][MAMBA]
                       + mamba_report["engine"]["launches"][MAMBA])

    # -- 15. tuning and measured cost: the searched ResNet-50 plan -----------------
    gc.collect()
    torch.cuda.empty_cache()
    tune_report = tune_phase(torch, dev, get_resnet, images, launch_counts,
                             reset_launch_counts)

    # -- 16. sharded serving: rwkv6-7b on a (1, 1) NCCL mesh, laid out by placement --
    gc.collect()
    torch.cuda.empty_cache()
    mesh_rows, mesh_report = mesh_phase(
        torch, dev, gen, ops, ref, WRAPPERS, lm, serve, get_config, launch_counts,
        reset_launch_counts, lm_rows, engine_rows, engine_runs[0])
    rows += mesh_rows
    launches[QUANT] += mesh_report["launches"][QUANT]
    launches[WKV] += mesh_report["launches"][WKV]

    # -- 17. training on a (1, 1) NCCL mesh: phase 13's rwkv6-7b, restore, CLI --
    gc.collect()
    torch.cuda.empty_cache()
    mtrain_rows, mtrain_report = mesh_train_phase(
        torch, dev, lm, get_config, launch_counts, reset_launch_counts, train_report,
        train_rows)
    rows += mtrain_rows
    launches[WKV] += mtrain_report["launches"][WKV]
    launches[WKV_BWD] += mtrain_report["launches"][WKV_BWD]

    # -- 18. the dry run against phases 5 and 13; kernel #1's rows against T ------
    gc.collect()
    torch.cuda.empty_cache()
    dry_rows, dry_report = dryrun_phase(torch, dev, gen, ops, ref, WRAPPERS, launch_counts,
                                        reset_launch_counts, dry, lm_run, train_report["run"])
    rows += dry_rows
    launches[QUANT] += dry_report["row_check"]["launches"]

    # -- 11. times per kernel, summed over the main paths' launches -----------
    summary = []
    for name in KERNELS:
        mine = [r for r in rows if r["kernel"] == name]
        counted = [r for r in mine if r["count"]]
        per_run = lambda key: sum(r[key] * r["count"] for r in counted)
        by = {b: sum(r["bound_ms"] * r["count"] for r in counted if r["bound_by"] == b)
              for b in ("bytes", "operations")}
        lib = [r["library_ms"] for r in counted]
        paths_of = {}
        for r in counted:
            p = paths_of.setdefault(r["path"], dict(
                launches=0, ms=0.0, bound_ms=0.0, bound_fp32_ms=0.0, bound_tc_ms=0.0,
                plain_ms=0.0, library_ms=0.0, library_bf16_ms=0.0, fold_ms=0.0))
            p["launches"] += r["count"]
            for key in ("ms", "bound_ms", "bound_fp32_ms", "bound_tc_ms", "plain_ms",
                        "library_ms", "library_bf16_ms", "fold_ms"):
                p[key] = (None if r.get(key) is None or p[key] is None
                          else p[key] + r[key] * r["count"])
        summary.append({
            "name": name, "route": "cuda", "source": KERNELS[name][0],
            "replaces": KERNELS[name][1], "launches": launches[name],
            "max_abs_err": max(r["max_abs_err"] for r in mine),
            "ms": per_run("ms"), "plain_ms": per_run("plain_ms"),
            "bound_ms": per_run("bound_ms"), "bound_by": max(by, key=by.get),
            "library_ms": None if None in lib else per_run("library_ms"),
            "bound_fp32_ms": per_run("bound_fp32_ms"),
            "bound_tc_ms": per_run("bound_tc_ms"),
            "paths": paths_of})
        if sum(p["launches"] for p in paths_of.values()) != launches[name]:
            raise AssertionError(f"{name}: the timed shapes cover "
                                 f"{sum(p['launches'] for p in paths_of.values())} "
                                 f"launches, the main paths made {launches[name]}")
        log(f"[times] {name}: over the main paths' {launches[name]} launches "
            f"{summary[-1]['ms']:.3f} ms, bound {summary[-1]['bound_ms']:.3f} ms "
            f"(fp32 rate {summary[-1]['bound_fp32_ms']:.3f}, tensor cores "
            f"{_ms(summary[-1]['bound_tc_ms'])}); "
            + "; ".join(f"{p}: {v['launches']} launches {v['ms']:.3f} ms (bound "
                        f"{v['bound_ms']:.3f}, fp32 rate {v['bound_fp32_ms']:.3f}, tensor "
                        f"cores {_ms(v['bound_tc_ms'])}, plain "
                        f"{v['plain_ms']:.3f}, library {_ms(v['library_ms'])}, library bf16 "
                        f"{_ms(v['library_bf16_ms'])})"
                        for p, v in paths_of.items()))
    # kernel #2 against kernel #1 plus the fold it saves (ops.fold_rows timed
    # at each shape of the unfused path)
    fused_vs = {}
    for path in ("resnet50", "resnet50 evo-latency-q3"):
        k1 = next(k for k in summary if k["name"] == QUANT)["paths"].get(path)
        k2 = next(k for k in summary
                  if k["name"] == "quant_epitome_matmul_fused_fold")["paths"].get(path)
        if k1 and k2:
            fused_vs[path] = dict(fused_fold_ms=k2["ms"], blocks_ms=k1["ms"],
                                  fold_ms=k1["fold_ms"], library_ms=k2["library_ms"])
            log(f"[times] {path}: fused fold {k2['ms']:.3f} ms against blocks "
                f"{k1['ms']:.3f} + fold {k1['fold_ms']:.3f} = "
                f"{k1['ms'] + k1['fold_ms']:.3f} ms; library {_ms(k2['library_ms'])}")
    report["fused_fold_vs_blocks_plus_fold"] = fused_vs

    report.update(kernels=summary, shapes=rows, forwards=forwards, lm=lm_run, lm_kernel=lm_fp_run,
                  lm_card_vs_cpu=lm_cpu, attention_lms=attn_runs,
                  attention_card_vs_cpu=attn_cpu, engine=engine_runs,
                  engine_card_vs_cpu=engine_cpu, fold_probe=fold, plan=plan_run["plan"],
                  quant_matmul_vs_f64=qm_f64, moe=moe_report, train=train_report,
                  mamba=mamba_report, tuning=tune_report, mesh=mesh_report,
                  mesh_train=mtrain_report, dryrun=dry_report,
                  total_s=time.perf_counter() - t_start, card_end=card_line())
    out = ROOT / "build"
    out.mkdir(exist_ok=True)
    (out / "chip_smoke.json").write_text(json.dumps(report, indent=1))
    log(f"[done] {report['total_s']:.1f} s (ResNet {report['resnet_s']:.1f}, "
        f"LM {report['lm_s']:.1f}, LM kernel {report['lm_kernel_s']:.1f}, "
        f"quant_matmul {report['quant_matmul_s']:.1f}, "
        f"plan {report['plan_s']:.1f}, "
        + ", ".join(f"{a} {t:.1f}" for a, t in report["attention_s"].items()) + ", engine "
        + ", ".join(f"{a} {t:.1f}" for a, t in report["engine_s"].items())
        + f", MoE {moe_report['seconds']:.1f}, training {train_report['seconds']:.1f}, "
        f"Mamba {mamba_report['seconds']:.1f}, tuning {tune_report['seconds']:.1f}, "
        f"mesh {mesh_report['seconds']:.1f}, mesh training {mtrain_report['seconds']:.1f}, "
        f"dry run {dry_report['seconds']:.1f})")
    log(report["card_end"])
    # the kernels line holds measured numbers and bound_ms only: the fp32-rate
    # and tensor-core bounds stay in the log lines and in build/chip_smoke.json
    own = ("bound_fp32_ms", "bound_tc_ms")
    drop = lambda d: {key: val for key, val in d.items() if key not in own}
    line = [dict(drop(k), paths={p: drop(v) for p, v in k["paths"].items()})
            for k in summary]
    print(json.dumps({"kernels": line}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


def resnet_forward(torch, label, build, kernel, n_launches, images, small,
                   launch_counts, reset_launch_counts, repeats: int = 5) -> dict:
    """One ResNet-50 path at full width: ``build(device)`` gives the model,
    initialized from SEED and prepacked on the card; one batch forward must
    launch ``kernel`` exactly ``n_launches`` times and nothing else, then
    the forward is timed and profiled, and batch-2 logits on the card are
    held against the CPU (plain versions) at LOGIT_TOL."""
    model = build(images.device).init(torch.Generator().manual_seed(SEED)).prepack()
    with torch.no_grad():
        reset_launch_counts()
        logits = model.apply(images)
        torch.cuda.synchronize()
        counts = launch_counts()
        expect = {k: (n_launches if k == kernel else 0) for k in counts}
        if counts != expect:
            raise AssertionError(f"{label}: launches {counts}, expected {expect}")
        if logits.shape != (BATCH, 1000) or not torch.isfinite(logits).all():
            raise AssertionError(f"{label}: logits {tuple(logits.shape)} not finite")
        times, host = [], []
        torch.cuda.reset_peak_memory_stats()
        for _ in range(repeats):
            t0 = time.perf_counter()
            model.apply(images)
            host.append(1e3 * (time.perf_counter() - t0))   # until apply returns
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - t0))
        peak = torch.cuda.max_memory_allocated()
        breakdown = device_breakdown(torch, lambda: model.apply(images))
        y2 = model.apply(small).cpu()
        cpu = build("cpu").load_params(_to_cpu(model.params()))
        r2 = cpu.apply(small.cpu())
    scale = max(1.0, float(r2.abs().max()))
    err = float((y2 - r2).abs().max())
    if not err <= LOGIT_TOL * scale:
        raise AssertionError(f"{label}: batch-2 logits on the card differ from the "
                             f"CPU by {err:.3e} (> {LOGIT_TOL} * {scale:.3f})")
    fwd = dict(path=label, kernel=kernel, launches=counts[kernel],
               forward_ms_median=statistics.median(times), forward_ms=times,
               host_ms=host, device_breakdown=breakdown,
               device_busy_ms=sum(ms for _, ms, _ in breakdown),
               device_kernels=sum(n for _, _, n in breakdown),
               peak_bytes=peak, logits_max_abs=float(logits.abs().max()),
               b2_card_vs_cpu_max_abs_err=err, b2_ref_max_abs=scale)
    log(f"[forward] {label}: {kernel} launches={counts[kernel]} "
        f"b{BATCH} forward median {fwd['forward_ms_median']:.2f} ms "
        f"(runs {', '.join(f'{t:.2f}' for t in times)}; host returns after "
        f"{statistics.median(host):.2f}) peak {peak / 2**30:.2f} GiB; device busy "
        f"{fwd['device_busy_ms']:.2f} ms in {fwd['device_kernels']} kernels; "
        f"b2 card vs cpu max|dy|={err:.3e} (max|y|={scale:.3f})")
    for name, ms, n in breakdown[:8]:
        log(f"[profile] {label}: {ms:9.3f} ms  x{n:<4d} {name[:90]}")
    del model, cpu
    torch.cuda.empty_cache()
    return fwd


def logits_over_seeds(torch, dev, get_resnet, forwards, paths) -> dict:
    """The batch-2 logits check of each ResNet-50 path in ``paths``
    [(variant, tuned)] again at the seeds LOGIT_SEEDS (weights and images),
    each held at LOGIT_TOL; with phase 3's reading at SEED, the largest
    reading of each path and its margin, the gate over it."""
    out = {}
    for variant, tuned in paths:
        label = variant + ("+fused_fold" if tuned else "")
        build = lambda device: get_resnet("resnet50", variant, tuned=tuned, device=device)
        first = next(f for f in forwards if f["path"] == label)
        reads = [(SEED, first["b2_card_vs_cpu_max_abs_err"], first["b2_ref_max_abs"])]
        for seed in LOGIT_SEEDS:
            g = torch.Generator(device=dev).manual_seed(seed)
            images = torch.randn(2, IMAGE, IMAGE, 3, device=dev, generator=g)
            model = build(dev).init(torch.Generator().manual_seed(seed)).prepack()
            with torch.no_grad():
                y = model.apply(images).cpu()
                cpu = build("cpu").load_params(_to_cpu(model.params()))
                r = cpu.apply(images.cpu())
            scale = max(1.0, float(r.abs().max()))
            err = float((y - r).abs().max())
            if not torch.isfinite(y).all() or not err <= LOGIT_TOL * scale:
                raise AssertionError(f"{label} seed {seed}: batch-2 logits on the card "
                                     f"differ from the CPU by {err:.3e} (> {LOGIT_TOL} "
                                     f"* {scale:.3f})")
            reads.append((seed, err, scale))
            del model, cpu
        worst = max(reads, key=lambda r: r[1] / r[2])
        out[label] = dict(reads=reads, worst_seed=worst[0], worst_err=worst[1],
                          margin=LOGIT_TOL * worst[2] / max(worst[1], 1e-30))
        log(f"[seeds] {label}: b2 card vs cpu max|dy| "
            + ", ".join(f"seed {sd} {e:.3e} (max|y| {sc:.3f})" for sd, e, sc in reads)
            + f"; largest {worst[1]:.3e} at seed {worst[0]}, gate "
            f"{LOGIT_TOL * worst[2]:.3e}, margin {out[label]['margin']:.2f}x")
    torch.cuda.empty_cache()
    return out


def site_specs(lm, cfg) -> dict:
    """{epitome spec: projections per group through an epitome kernel} of
    the LM (dense projections, such as gemma2-2b's wk and wv, run none)."""
    out = {}
    for lc in lm.lm_layer_configs(cfg).values():
        if lc.is_epitome and lc.mode == "kernel":
            out[lc.spec] = out.get(lc.spec, 0) + 1
    return out


def quant_lm_rows(torch, dev, gen, ops, ref, wrappers, lm, cfg, path, runs,
                  rows_dec, dtypes=None) -> list:
    """Kernel #1 at an LM's epitomized projection specs, bf16 (counted when
    it is the path's dtype) and float32 (checked), at each (rows, forwards)
    of ``runs`` (a generate: its prefill's rows once, its decode rows
    ``new - 1`` times): each against its plain version, then timed beside
    it, the cuBLAS float32 and bf16 yardsticks on the dequantized weight and
    the bound; the decode rows (``rows_dec``) three times bit for bit, and
    L2-cold (over copies of the codes and of the yardstick's weight past
    64 MB, as a decode step reads every layer's weights once).  ``dtypes``
    narrows the (dtype, tolerance) pairs (default bf16 and float32)."""
    from repro_torch.core.quant import dequantize_packed
    sites = lm.lm_layer_configs(cfg)
    rows = []
    for spec, k in site_specs(lm, cfg).items():
        lc = next(v for v in sites.values() if v.spec == spec)
        E = torch.randn(spec.m, spec.n, device=dev, generator=gen) / math.sqrt(spec.M)
        p = ops.pack_epitome(E, spec, lc.quant)
        bn = p.bn
        cb = ops.spec_tables(spec, bn, dev).col_blocks
        gn = len(cb)
        cols = torch.cat([torch.arange(c * bn, (c + 1) * bn, device=dev)
                          for c in ops.kernel_col_blocks(spec, bn).tolist()])
        W = dequantize_packed(p.q, p.scales, p.zeros, (p.bk, bn))[:, cols].contiguous()
        Wb = W.bfloat16()
        n_cold = -(-L2_COLD_BYTES // p.q.numel()) + 1
        q_cold = [p.q.clone() for _ in range(n_cold)]
        W_cold = [W.clone() for _ in range(-(-L2_COLD_BYTES // (4 * W.numel())) + 1)]
        for T, forwards in runs:
            count = k * cfg.n_groups * forwards
            x = torch.randn(T, spec.M, device=dev, generator=gen)
            for dtype, tol in dtypes or ((torch.bfloat16, BF16_TOL), (torch.float32, KERNEL_TOL)):
                folded = ops.fold_rows(x.to(dtype), spec)
                f32 = folded.float()
                kernel = lambda q=p.q: wrappers[QUANT](folded, q, p.scales, p.zeros, cb,
                                                       bk=p.bk, bn=bn)
                plain = lambda: ref.quant_epitome_matmul_blocks_ref(
                    folded, p.q, p.scales, p.zeros, cb, p.bk, bn)
                # yardstick: one cuBLAS float32 product (TF32 off) of the same
                # activation values with the pre-expanded dequantized weight
                library = lambda: torch.matmul(f32, W)
                y = kernel()
                if y.dtype != dtype:
                    raise AssertionError(f"{QUANT}: {dtype} in, {y.dtype} out")
                dname = str(dtype).replace("torch.", "")
                err = max_err(torch, y, plain(), tol, f"{path} {QUANT} {dname} {spec} T={T}")
                nbytes, flops = _cost().quant_epitome_work(
                    T, spec.m, p.q.shape[1], gn, bn, distinct_blocks(cb), p.scales.numel(),
                    folded.element_size())
                row = timed_row(torch, QUANT, kernel, plain, library, nbytes, flops)
                row.update(M=spec.M, N=spec.N, m=spec.m, n=spec.n, bn=bn, T=T,
                           pack_bk=p.bk, dtype=dname, max_abs_err=err, path=path,
                           count=count if dtype == cfg.cdtype else 0)
                if dtype == torch.bfloat16:   # the bf16 yardstick: bf16 x, bf16 weight
                    row["library_bf16_ms"] = graph_ms(torch, lambda: torch.matmul(folded, Wb))
                if T == rows_dec:
                    # decode rows: three launches bit for bit, and L2-cold times
                    again = [kernel() for _ in range(3)]
                    if not all(torch.equal(a, again[0]) for a in again):
                        raise AssertionError(f"{path} {QUANT} {dname} T={T}: three decode "
                                             f"launches differ")
                    qc, wc = itertools.cycle(q_cold), itertools.cycle(W_cold)
                    row.update(
                        repeat_bit_for_bit=3,
                        ms_cold=graph_ms(torch, lambda: kernel(next(qc))),
                        library_ms_cold=graph_ms(torch, lambda: torch.matmul(f32, next(wc))),
                        cold_buffers=[n_cold, len(W_cold)])
                rows.append(row)
                log(f"[lm-kernels] {path}: {QUANT} {dname} ({spec.M},{spec.N})->({spec.m},"
                    f"{spec.n}) bk={p.bk} T={T} x{row['count']}: max_err={err:.2e} "
                    f"ms={row['ms']:.4f} (eager {row['ms_eager']:.4f}) "
                    f"plain_ms={row['plain_ms']:.4f} library_ms={row['library_ms']:.4f} "
                    f"(eager {row['library_ms_eager']:.4f}) "
                    f"library_bf16_ms={_ms(row.get('library_bf16_ms'), 4)} "
                    f"bound_ms={row['bound_ms']:.4f} ({row['bound_by']}) "
                    f"bound_fp32_ms={row['bound_fp32_ms']:.4f} "
                    f"bound_tc_ms={_ms(row['bound_tc_ms'], 4)}"
                    + (f"; L2-cold ms={row['ms_cold']:.4f} library_ms="
                       f"{row['library_ms_cold']:.4f} ({n_cold} code copies); 3 launches "
                       f"bit for bit" if T == rows_dec else ""))
            del x
        del E, p, W, Wb, q_cold, W_cold
        torch.cuda.empty_cache()
    return rows


def lm_kernels(torch, dev, gen, ops, ref, wrappers, lm, cfg):
    """The int8 kernel at rwkv6-7b's three projection shapes
    (quant_lm_rows at 4 x 256 and 4 rows); the WKV kernel at the prefill's
    shape from a non-zero state.  Each against its plain version, then
    timed beside it, the yardstick and the bound."""
    rows = quant_lm_rows(torch, dev, gen, ops, ref, wrappers, lm, cfg, LM_ARCH,
                         ((LM_REQUESTS * LM_PROMPT, 1), (LM_REQUESTS, LM_NEW - 1)),
                         LM_REQUESTS)
    rows_fold = fold_probe(torch, dev, gen, ops, next(iter(site_specs(lm, cfg))))
    rows += wkv_rows(torch, dev, gen, ref, wrappers, cfg, LM_ARCH, LM_REQUESTS, LM_PROMPT,
                     cfg.n_layers)
    return rows, rows_fold


def wkv_rows(torch, dev, gen, ref, wrappers, cfg, path, B, S, launches) -> list:
    """The WKV kernel at (B, S) tokens of the LM's heads from a non-zero
    state, with r, k, v in the LM's dtype (counted, ``launches``) and in
    float32 (checked and timed): each against its plain version, finite
    under strong decay (log w = -20), timed beside it and the bound."""
    H, K, L = cfg.n_heads, cfg.hd, min(cfg.rwkv_chunk, S)
    f = lambda *s: torch.randn(s, device=dev, generator=gen)
    r32, k32, v32 = f(B, S, H, K), f(B, S, H, K), f(B, S, H, K)
    lw, u, h0 = -torch.exp(f(B, S, H, K) * 0.5), f(H, K) * 0.1, f(B, H, K, K) * 0.5
    flops, products = _cost().wkv6_ops(B, S, H, K, L)
    rows = []
    for dtype in (cfg.cdtype, torch.float32):
        r, k_, v = (t.to(dtype) for t in (r32, k32, v32))
        dname = str(dtype).replace("torch.", "")
        kernel = lambda: wrappers[WKV](r, k_, v, lw, u, h0, chunk=L)
        # the plain version reads the same values cast to float32
        plain = lambda: ref.wkv6_chunked_ref(r, k_, v, lw, u, h0, chunk=L)
        (o, hT), (o_ref, h_ref) = kernel(), plain()
        err = max(max_err(torch, o, o_ref, WKV_TOL, f"{WKV} {dname} o"),
                  max_err(torch, hT, h_ref, WKV_TOL, f"{WKV} {dname} state"))
        o_s, h_s = wrappers[WKV](r, k_, v, torch.full_like(lw, -20.0), u, h0, chunk=L)
        if not (torch.isfinite(o_s).all() and torch.isfinite(h_s).all()):
            raise AssertionError(f"{WKV} {dname}: not finite under log w = -20")
        nbytes = _cost().wkv6_bytes(B, S, H, K, r.element_size(), h0 is not None)
        row = timed_row(torch, WKV, kernel, plain, None, nbytes, flops, dname, products)
        row.update(B=B, S=S, H=H, K=K, chunk=L, dtype=dname, max_abs_err=err,
                   path=path, count=launches if dtype == cfg.cdtype else 0)
        rows.append(row)
        log(f"[lm-kernels] {path}: {WKV} {dname} B={B} S={S} H={H} K={K} chunk={L} "
            f"x{row['count']}: max_err={err:.2e} (o and state) ms={row['ms']:.4f} (eager "
            f"{row['ms_eager']:.4f}) plain_ms={row['plain_ms']:.4f} library_ms=none "
            f"bound_ms={row['bound_ms']:.4f} ({row['bound_by']}) bound_fp32_ms="
            f"{row['bound_fp32_ms']:.4f} bound_tc_ms={row['bound_tc_ms']:.4f}; log w = -20 "
            f"stays finite")
    return rows


def lm_fp_kernels(torch, dev, gen, ops, ref, wrappers, lm, cfg) -> list:
    """Kernel #3's bf16 entry at the LM's three projection shapes, at prefill
    rows (4 x 256) and decode rows (4), as rwkv6-7b ``kernel`` runs it: a
    bf16 activation and the float32 epitome cast to bf16 by
    ops.epitome_matmul.  Each against its plain version, then timed beside
    it and cuBLAS bf16 on the same bf16 weight, with the decode rows three
    times bit for bit and L2-cold (over copies of E past 64 MB); beside
    them the time of the per-call cast E.to(bfloat16) of ops.epitome_matmul."""
    rows = []
    for spec, k in site_specs(lm, cfg).items():
        E = torch.randn(spec.m, spec.n, device=dev, generator=gen) / math.sqrt(spec.M)
        Eb = E.bfloat16()
        bn = spec.bn
        cb = ops.spec_tables(spec, bn, dev).col_blocks
        gn = len(cb)
        cols = torch.cat([torch.arange(c * bn, (c + 1) * bn, device=dev)
                          for c in ops.kernel_col_blocks(spec, bn).tolist()])
        Wb = Eb[:, cols].contiguous()
        cast_ms = graph_ms(torch, lambda: E.to(torch.bfloat16))
        E_cold = [Eb.clone() for _ in range(-(-L2_COLD_BYTES // (2 * Eb.numel())) + 1)]
        for T, count in ((LM_REQUESTS * LM_PROMPT, k * cfg.n_layers),
                         (LM_REQUESTS, k * cfg.n_layers * (LM_NEW - 1))):
            x = torch.randn(T, spec.M, device=dev, generator=gen).bfloat16()
            folded = ops.fold_rows(x, spec)
            kernel = lambda e=Eb: wrappers[FP_KERNEL](folded, e, cb, bn=bn)
            plain = lambda: ref.epitome_matmul_blocks_ref(folded, Eb, cb, bn)
            library = lambda: torch.matmul(folded, Wb)     # cuBLAS bf16, the same values
            y = kernel()
            if y.dtype != torch.bfloat16:
                raise AssertionError(f"{FP_KERNEL}: bfloat16 in, {y.dtype} out")
            err = max_err(torch, y, plain(), BF16_TOL, f"{FP_KERNEL} bfloat16 {spec} T={T}")
            row = timed_row(torch, FP_KERNEL, kernel, plain, library,
                            *_cost().epitome_work(T, spec.m, spec.n, gn, bn, distinct_blocks(cb),
                                                  2), "bfloat16")
            row.update(M=spec.M, N=spec.N, m=spec.m, n=spec.n, bn=bn, T=T, dtype="bfloat16",
                       max_abs_err=err, path=f"{LM_ARCH} kernel", count=count,
                       library_bf16_ms=row["library_ms"], cast_ms=cast_ms)
            if T == LM_REQUESTS:
                again = [kernel() for _ in range(3)]
                if not all(torch.equal(a, again[0]) for a in again):
                    raise AssertionError(f"{FP_KERNEL} bfloat16 T={T}: three launches differ")
                ec = itertools.cycle(E_cold)
                row.update(repeat_bit_for_bit=3, ms_cold=graph_ms(torch, lambda: kernel(next(ec))),
                           cold_buffers=[len(E_cold)])
            rows.append(row)
            log(f"[lm-kernels] {FP_KERNEL} bfloat16 ({spec.M},{spec.N})->({spec.m},{spec.n}) "
                f"T={T} x{count}: max_err={err:.2e} ms={row['ms']:.4f} "
                f"(eager {row['ms_eager']:.4f}) plain_ms={row['plain_ms']:.4f} "
                f"library_bf16_ms={row['library_ms']:.4f} bound_ms={row['bound_ms']:.4f} "
                f"({row['bound_by']}) bound_fp32_ms={row['bound_fp32_ms']:.4f} "
                f"bound_tc_ms={row['bound_tc_ms']:.4f}; E.to(bfloat16) cast_ms={cast_ms:.4f}"
                + (f"; L2-cold ms={row['ms_cold']:.4f} ({len(E_cold)} copies of E); 3 "
                   f"launches bit for bit" if T == LM_REQUESTS else ""))
        del E, Eb, Wb, E_cold
    return rows


def fold_probe(torch, dev, gen, ops, spec, runs: int = 20) -> dict:
    """How a bf16 fold repeats on the card: the distinct results of ``runs``
    identical folds by scatter-add (index_add_) summed in bf16 (the
    reference's dtype) and in float32 rounded once, and by the port's
    gather-and-sum (ops.fold_rows)."""
    x = torch.randn(LM_REQUESTS * LM_PROMPT, spec.M, device=dev, generator=gen).bfloat16()
    rmap = torch.as_tensor(spec.row_index_map(), device=dev)
    scatter = lambda dt: x.new_zeros(x.shape[0], spec.m, dtype=dt).index_add_(
        -1, rmap, x.to(dt)).bfloat16()
    folds = {"index_add_ bf16": [scatter(torch.bfloat16) for _ in range(runs)],
             "index_add_ f32": [scatter(torch.float32) for _ in range(runs)],
             "fold_rows": [ops.fold_rows(x, spec) for _ in range(runs)]}
    distinct = lambda ys: len({bytes(y.view(torch.int16).cpu().numpy().tobytes()) for y in ys})
    out = {k: distinct(v) for k, v in folds.items()}
    out.update(runs=runs, max_abs_bf16_vs_fold_rows=float(
        (folds["index_add_ bf16"][0].float() - folds["fold_rows"][0].float()).abs().max()))
    log(f"[fold] bf16 fold ({spec.M} -> {spec.m} rows, T={x.shape[0]}), distinct results "
        f"in {runs} runs: " + ", ".join(f"{k} {out[k]}" for k in folds)
        + f"; max |index_add_ bf16 - fold_rows| {out['max_abs_bf16_vs_fold_rows']:.3e}")
    return out


def distinct_blocks(cb) -> int:
    """Column blocks of a product that differ: blocks that read the same
    epitome columns (the table ``cb`` repeats, as when a 256-wide epitome
    serves N = 29568) give the same product, which the least work computes
    once; the bounds count its FLOPs once (its output is still written and
    counted in bytes for every block)."""
    return len(set(cb.tolist()))


def bounds(name, nbytes, flops, dtype="float32", products=None) -> dict:
    """The least time the card could take: the larger of the bytes over the
    memory rate and the operations over the peak of their type, the tensor
    cores for every kernel (``cost.tc_seconds``); the fp32-rate bound (all FLOPs at
    67 TFLOP/s) is kept beside it."""
    c = _cost()
    t_bytes = nbytes / c.HBM_BW * 1e3
    t_fp32 = flops / c.FP32_FLOPS * 1e3
    t_tc = c.tc_seconds(name, flops, dtype, products) * 1e3
    return dict(bytes=nbytes, flops=flops, bound_ms=max(t_bytes, t_tc),
                bound_by="bytes" if t_bytes > t_tc else "operations",
                bound_fp32_ms=max(t_bytes, t_fp32), bound_tc_ms=max(t_bytes, t_tc))


def timed_row(torch, name, kernel, plain, library, nbytes, flops, dtype="float32",
              products=None) -> dict:
    """Kernel and yardstick times on the device (graph_ms) and eager (host
    included), the plain version's eager time, and the bounds."""
    return dict(kernel=name, ms=graph_ms(torch, kernel), ms_eager=time_ms(torch, kernel),
                plain_ms=time_ms(torch, plain),
                library_ms=None if library is None else graph_ms(torch, library),
                library_ms_eager=None if library is None else time_ms(torch, library),
                **bounds(name, nbytes, flops, dtype, products))


def lm_path(torch, dev, lm, serve, cfg, variant, expect, launch_counts, reset_launch_counts,
            requests=LM_REQUESTS, prompt=LM_PROMPT, new=LM_NEW, built=None, keep=None,
            profile=True) -> dict:
    """An LM (``cfg``, at ``variant``) at full width and depth from seeded
    weights: generate ``new`` greedy tokens for ``requests`` prompts of
    ``prompt`` random tokens with exactly the launches of ``expect``
    ({kernel: launches}) and none of any other kernel, then prefill (three
    times, bit for bit) and decode timed and (``profile``) profiled.
    ``built`` (params, seconds) passes parameters the caller drew and
    keeps; ``keep`` (a dict) receives the generated tokens and the first
    prefill's logits."""
    from repro_torch.core.layers import unshard
    name = cfg.name
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params_alloc = None     # what the parameters took, for phase 18's dry run
    if built is None:
        alloc0 = torch.cuda.memory_allocated()
        params = lm.init_params(torch.Generator(device=dev).manual_seed(SEED), cfg, dev)
        params = lm.prepack_params(params, cfg)
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        params_alloc = torch.cuda.memory_allocated() - alloc0
    else:
        params, setup_s = built
    prompts = torch.randint(0, cfg.vocab, (requests, prompt), device=dev,
                            generator=torch.Generator(device=dev).manual_seed(SEED + 1))
    max_len = prompt + new + 1
    reset_launch_counts()
    t0 = time.perf_counter()
    toks, _ = serve.generate(params, cfg, prompts, max_len, new)
    torch.cuda.synchronize()
    generate_s = time.perf_counter() - t0
    counts = launch_counts()
    if counts != {k: expect.get(k, 0) for k in counts}:
        raise AssertionError(f"{name}: launches {counts}, expected {expect}")
    if tuple(toks.shape) != (requests, new) or int(toks.min()) < 0 \
            or int(toks.max()) >= cfg.vocab:
        raise AssertionError(f"{name}: tokens {tuple(toks.shape)} out of the vocab")
    with torch.no_grad():
        alloc0 = torch.cuda.memory_allocated()
        state0 = lm.init_decode_state(cfg, requests, max_len, dev)
        torch.cuda.synchronize()
        state_alloc = torch.cuda.memory_allocated() - alloc0
        pre, pre_host, outs = [], [], []
        reset_launch_counts()
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, state = lm.prefill(params, prompts, state0, cfg)
            pre_host.append(1e3 * (time.perf_counter() - t0))
            torch.cuda.synchronize()
            pre.append(1e3 * (time.perf_counter() - t0))
            outs.append(logits[:, -1].float())
        prefill_launches = {k: v // 3 for k, v in launch_counts().items() if v}
        finite(torch, logits, f"{name} prefill logits")
        # three identical prefills must repeat bit for bit (no atomics on the
        # path); and how close the first request's top two logits lie, what
        # a greedy token hangs on
        repeat_diff = max(float((o - outs[0]).abs().max()) for o in outs)
        if repeat_diff != 0.0:
            raise AssertionError(f"{name}: three identical prefills differ by "
                                 f"{repeat_diff:.3e} in their logits")
        top2 = torch.topk(outs[0][0], 2).values
        mixer = params["groups"][0]["L0"]["mixer"]
        w = mixer[next(k for k in ("wr", "wq", "in_proj") if k in mixer)]
        fingerprint = [float(unshard(params["embed"]).double().sum()), float(prompts.sum()),
                       int(unshard(w["Eq"]).long().sum()) if "Eq" in w
                       else float(unshard(w["E"]).double().sum())]
        if keep is not None:
            keep.update(tokens=toks, logits=outs[0])
        tok = torch.argmax(logits[:, -1], -1).to(torch.int32)[:, None]
        reset_launch_counts()
        logits, state = lm.decode_step(params, state, tok, prompt, cfg)   # warm-up
        decode_launches = {k: v for k, v in launch_counts().items() if v}
        dec, dec_host = [], []
        for i in range(5):
            tok = torch.argmax(logits[:, -1], -1).to(torch.int32)[:, None]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, state = lm.decode_step(params, state, tok, prompt + 1 + i, cfg)
            dec_host.append(1e3 * (time.perf_counter() - t0))
            torch.cuda.synchronize()
            dec.append(1e3 * (time.perf_counter() - t0))
        finite(torch, logits, f"{name} decode logits")
        peak = torch.cuda.max_memory_allocated()
        prof_pre = prof_dec = []
        if profile:
            prof_pre = device_breakdown(torch, lambda: lm.prefill(params, prompts, state0, cfg))
            prof_dec = device_breakdown(
                torch, lambda: lm.decode_step(params, state, tok, prompt + 6, cfg))
    decode_ms = statistics.median(dec)
    run = dict(arch=name, variant=variant, n_layers=cfg.n_layers, d_model=cfg.d_model,
               vocab=cfg.vocab, traffic=[requests, prompt, new],
               launches={k: counts[k] for k in expect},
               setup_s=setup_s, generate_s=generate_s, tokens_sample=toks[0, :8].tolist(),
               prefill_ms=pre, prefill_host_ms=pre_host, decode_ms=dec, decode_host_ms=dec_host,
               prefill_ms_median=statistics.median(pre), decode_ms_median=decode_ms,
               decode_tok_s=requests / (decode_ms / 1e3), peak_bytes=peak,
               prefill_device_breakdown=prof_pre, decode_device_breakdown=prof_dec,
               prefill_busy_ms=sum(ms for _, ms, _ in prof_pre),
               decode_busy_ms=sum(ms for _, ms, _ in prof_dec),
               decode_kernels_per_step=sum(n for _, _, n in prof_dec),
               prefill_kernels=sum(n for _, _, n in prof_pre),
               prefill_repeat_max_abs_diff=repeat_diff,
               first_token_top2=[float(t) for t in top2], fingerprint=fingerprint,
               params_alloc_bytes=params_alloc, state_alloc_bytes=state_alloc,
               prefill_launches=prefill_launches, decode_launches=decode_launches,
               max_len=max_len)
    log(f"[lm] {name} {variant} {str(cfg.cdtype).replace('torch.', '')} {cfg.n_layers} layers, "
        f"d_model {cfg.d_model}, vocab {cfg.vocab}: init+prepack {setup_s:.1f} s; generate "
        f"{requests}x{prompt}+{new} in {generate_s:.2f} s with "
        + ", ".join(f"{k} x{counts[k]}" for k in expect)
        + f"; tokens[0] {toks[0, :8].tolist()}; weights and prompts fingerprint {fingerprint}; "
        f"3 prefills differ by max|d logits| {repeat_diff:.3e}; request 0's top two "
        f"logits {float(top2[0]):.4f}, {float(top2[1]):.4f}")
    log(f"[lm] {name} {variant}: prefill median {run['prefill_ms_median']:.2f} ms (runs "
        f"{', '.join(f'{t:.2f}' for t in pre)}; host returns after "
        f"{statistics.median(pre_host):.2f}); decode step median {decode_ms:.2f} ms (runs "
        f"{', '.join(f'{t:.2f}' for t in dec)}; host returns after "
        f"{statistics.median(dec_host):.2f}) = {run['decode_tok_s']:.1f} tok/s; "
        f"peak {peak / 2**30:.2f} GiB; device kernels: prefill {run['prefill_kernels']}, "
        f"decode step {run['decode_kernels_per_step']}")
    for label, prof in (("prefill", prof_pre), ("decode", prof_dec)) if profile else ():
        log(f"[profile] lm {name} {variant} {label}: device busy "
            f"{sum(ms for _, ms, _ in prof):.3f} ms")
        for kname, ms, n in prof[:8]:
            log(f"[profile] lm {name} {variant} {label}: {ms:9.3f} ms  x{n:<5d} {kname[:90]}")
    del params, state, state0
    return run


def finite(torch, t, what):
    if not torch.isfinite(t.float()).all():
        raise AssertionError(f"{what} not finite")


def lm_card_vs_cpu(torch, dev, lm, get_config, arch, variant, kv_bits=(16,),
                   prompt_len=CPU_PROMPT, cfg=None, batch=1, **overrides) -> list:
    """``arch`` at ``variant`` in float32 at full width, cut to CPU_LAYERS
    layers (``overrides`` replace more fields; ``cfg`` gives the float32
    config whole): ``batch`` prompts of ``prompt_len`` through prefill and
    greedy decode on the CPU (plain versions), then the same tokens on the
    card, at each KV cache width of ``kv_bits``; logits held at LOGIT_TOL
    of their scale and the greedy tokens equal, a row's step whose CPU top
    two logits lie within the tolerance being held by its logits alone.
    One entry per cache width."""
    import dataclasses
    cfg0 = cfg or get_config(arch, variant, compute_dtype="float32", n_layers=CPU_LAYERS,
                             **overrides)
    card = lm.prepack_params(
        lm.init_params(torch.Generator(device=dev).manual_seed(SEED), cfg0, dev), cfg0)
    host = _to_cpu(card)
    prompt = torch.randint(0, cfg0.vocab, (batch, prompt_len),
                           generator=torch.Generator().manual_seed(SEED + 2))
    out = []
    for bits in kv_bits:
        cfg = dataclasses.replace(cfg0, kv_cache_bits=bits)

        def run(params, device, tokens=None):
            with torch.no_grad():
                state = lm.init_decode_state(cfg, batch, prompt_len + CPU_NEW, device)
                logits, state = lm.prefill(params, prompt.to(device), state, cfg)
                got, toks = [logits[:, -1].float().cpu()], []
                for i in range(CPU_NEW):
                    tok = (torch.argmax(got[-1], -1).to(torch.int32)[:, None] if tokens is None
                           else tokens[i])
                    toks.append(tok)
                    if i == CPU_NEW - 1:
                        break
                    logits, state = lm.decode_step(params, state, tok.to(device),
                                                   prompt_len + i, cfg)
                    got.append(logits[:, -1].float().cpu())
            return got, toks

        what = f"{arch} {variant} float32 {cfg.n_layers} layers kv {bits} bits"
        t0 = time.perf_counter()
        ref_logits, ref_toks = run(host, torch.device("cpu"))
        cpu_s = time.perf_counter() - t0
        got, _ = run(card, dev, ref_toks)
        steps = []
        for i, (a, b) in enumerate(zip(got, ref_logits)):
            scale = max(1.0, float(b.abs().max()))
            err = float((a - b).abs().max())
            if not err <= LOGIT_TOL * scale:
                raise AssertionError(f"{what}: step {i} logits on the card differ from the "
                                     f"CPU by {err:.3e} (> {LOGIT_TOL} * {scale:.3f})")
            gaps, sames = [], []
            for r in range(batch):
                top2 = torch.topk(b[r], 2).values
                gap = float(top2[0] - top2[1])
                same = int(torch.argmax(a[r])) == int(ref_toks[i][r])
                if not same and gap > LOGIT_TOL * scale:
                    raise AssertionError(f"{what}: step {i} row {r} greedy token "
                                         f"{int(torch.argmax(a[r]))} on the card, "
                                         f"{int(ref_toks[i][r])} on the CPU")
                if not same:
                    log(f"[lm-cpu] step {i} row {r}: top two CPU logits within {gap:.2e} of "
                        f"each other; held by its logits alone")
                gaps.append(gap)
                sames.append(same)
            steps.append(dict(max_abs_err=err, scale=scale, top2_gap=min(gaps),
                              same_token=all(sames)))
        errs = ", ".join(f"{st['max_abs_err']:.2e}" for st in steps)
        log(f"[lm-cpu] {what}"
            + "".join(f", {k} {v}" for k, v in overrides.items())
            + f", {batch}x{prompt_len}+{CPU_NEW}: card vs cpu logits max|d| per step {errs} "
            f"(max|logit| {max(st['scale'] for st in steps):.3f}); tokens "
            f"{[t[:, 0].tolist() for t in ref_toks]} equal; cpu run {cpu_s:.1f} s")
        out.append(dict(arch=arch, variant=variant, kv_cache_bits=bits, overrides=overrides,
                        n_layers=cfg.n_layers, batch=batch, prompt=prompt_len, steps=steps,
                        tokens=[t[:, 0].tolist() for t in ref_toks], cpu_s=cpu_s))
    del card, host
    torch.cuda.empty_cache()
    return out


def engine_phase(torch, dev, gen, ops, ref, wrappers, lm, serve, get_config,
                 launch_counts, reset_launch_counts):
    """Phase 10 for each of ENGINE_PATHS: the engine's runs and gates
    (engine_path), kernels #1 and #4 at the rows the engine gave them
    (counted by its K = 4 run), and the 2-layer float32 engine card vs CPU.
    Returns (kernel rows, runs, card-vs-CPU results, seconds per model)."""
    from repro_torch.launch import engine as engine_mod
    rows, runs, cpu, seconds = [], [], [], {}
    for arch, page_size, kv_pages, depth, per_fwd, oneshot in ENGINE_PATHS:
        t0 = time.perf_counter()
        cfg, built = get_config(arch, "kernel-q3"), None
        if depth is not None:
            cfg = get_config(arch, "kernel-q3", n_layers=depth)
            built = (cfg, lm.prepack_params(lm.init_params(
                torch.Generator(device=dev).manual_seed(SEED), cfg, dev), cfg))
        run = engine_path(torch, dev, lm, serve, engine_mod, get_config, arch, page_size,
                          kv_pages, per_fwd, oneshot, launch_counts, reset_launch_counts,
                          built=built, f32=True)
        del built
        torch.cuda.empty_cache()
        path = f"{arch} engine"
        rows += quant_lm_rows(torch, dev, gen, ops, ref, wrappers, lm, cfg, path,
                              sorted(run["forwards_by_rows"].items()), ENGINE_CAPACITY)
        if run["launches"][WKV]:
            for S, prefills in sorted(run["wkv_by_rows"].items()):
                rows += wkv_rows(torch, dev, gen, ref, wrappers, cfg, path, 1, S,
                                 cfg.n_layers * prefills)
        torch.cuda.empty_cache()
        cpu.append(engine_card_vs_cpu(torch, dev, lm, engine_mod, get_config, arch,
                                      page_size, kv_pages))
        runs.append(run)
        seconds[arch] = time.perf_counter() - t0
        log(f"[engine] {arch}: phase 10 {seconds[arch]:.1f} s")
    return rows, runs, cpu, seconds


def engine_requests(torch, Request, vocab) -> list:
    """Phase 10's requests: the greedy prompts, then the sampled ones, drawn
    from a seeded generator; new tokens cycle through ENGINE_NEW."""
    g = torch.Generator().manual_seed(SEED + 3)
    lens = ([(P, 0.0) for P in ENGINE_PROMPTS]
            + [(P, ENGINE_TEMPERATURE) for P in ENGINE_SAMPLED])
    return [Request(prompt=torch.randint(0, vocab, (P,), generator=g).tolist(),
                    max_new_tokens=ENGINE_NEW[i % len(ENGINE_NEW)], temperature=t,
                    seed=SEED + i)
            for i, (P, t) in enumerate(lens)]


def engine_drive(torch, eng, reqs, order, launch_counts, reset_launch_counts,
                 per_fwd) -> dict:
    """Submit ``reqs`` in ``order`` and step the engine until it is idle,
    the launch counters set to 0 just before; then gates 1-3: every request
    completes with exactly its max_new_tokens, in submission order; the
    stats (admitted = completed = n, slot reuses = n - capacity, pages
    within the pool, none held after the drain, every table row at the
    trash page); launches exact: kernel #1 ``per_fwd`` a forward (each
    bucketed prefill, prefill chunk and decode micro-step), kernel #4 once
    per RWKV layer a prefill or chunk, the Mamba scan once per Mamba layer
    a forward.  Records each step's wall time where
    it ran no prefill and admitted nothing (a macro-step's time) and the
    steps at which a free slot waited on pages."""
    n, cfg = len(reqs), eng.cfg
    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    handles = {i: eng.submit(reqs[i]) for i in order}
    step_ms, deferred = {}, 0
    while eng.n_pending or eng.n_active or eng._prefilling or eng._inflight:
        before = (eng.stats["admitted"], eng.stats["prefill_chunks"])
        ts = time.perf_counter()
        eng.step()
        dt = 1e3 * (time.perf_counter() - ts)
        if (eng.stats["admitted"], eng.stats["prefill_chunks"]) == before \
                and eng._inflight is not None:
            step_ms.setdefault(eng._inflight.k, []).append(dt)
        head = eng._pending[0].request if eng._pending else None
        deferred += bool(head and eng._prefilling is None and eng.n_active < eng.capacity
                         and not eng._pool.can_admit(len(head.prompt) + head.max_new_tokens))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts, st = launch_counts(), eng.stats
    comps = eng.drain()
    what = f"{cfg.name} engine K={eng.decode_block}"
    if [c.request_id for c in comps] != [handles[i].request_id for i in order]:
        raise AssertionError(f"{what}: completions not in submission order")
    for i in order:
        if len(handles[i].result().tokens) != reqs[i].max_new_tokens:
            raise AssertionError(f"{what}: request {i} has {len(handles[i].result().tokens)} "
                                 f"tokens, not {reqs[i].max_new_tokens}")
    pool = eng._pool
    table = pool.page_table
    checks = {"admitted == completed == n": st["admitted"] == st["completed"] == n,
              "slot_reuses == n - capacity": st["slot_reuses"] == n - eng.capacity,
              "pages_hwm <= kv_pages": st["pages_hwm"] <= st["pages_total"],
              "no page held after the drain": st["pages_used"] == 0,
              "every table row at the trash page":
                  table is None or bool((table == pool.page.trash).all())}
    bad = [k for k, ok in checks.items() if not ok]
    if bad:
        raise AssertionError(f"{what}: stats {st} fail {bad}")
    whole = sum(not eng.chunk or len(r.prompt) <= eng.chunk for r in reqs)
    prefills = whole + st["prefill_chunks"]
    rwkv = sum(kind == "rwkv" for kind, _ in cfg.full_pattern) * cfg.n_groups
    mamba = sum(kind == "mamba" for kind, _ in cfg.full_pattern) * cfg.n_groups
    forwards = prefills + st["decode_micro_steps"]
    expect = {QUANT: per_fwd * forwards, WKV: rwkv * prefills, MAMBA: mamba * forwards}
    if counts != {k: expect.get(k, 0) for k in counts}:
        raise AssertionError(f"{what}: launches {counts}, expected {expect}")
    ttft = sorted(c.ttft_s for c in comps)
    return dict(tokens={i: handles[i].result().tokens for i in order}, stats=st,
                wall_s=wall, launches={k: counts[k] for k in expect}, step_ms=step_ms,
                deferred_steps=deferred, ttft_p50_s=ttft[len(ttft) // 2], ttft_max_s=ttft[-1],
                tok_s=sum(len(c.tokens) for c in comps) / wall, whole_prefills=whole)


def one_shot_logits(torch, lm, params, cfg, prompt, toks, seq_len, step):
    """The one-shot greedy logits (float32, one row) at ``step`` of its
    tokens ``toks``: prefill, then ``step`` decode steps at batch 1."""
    with torch.no_grad():
        logits, state = lm.prefill(params, prompt, lm.init_decode_state(cfg, 1, seq_len,
                                                                         prompt.device), cfg)
        for i in range(step):
            tok = torch.tensor([[toks[i]]], dtype=torch.int32, device=prompt.device)
            logits, state = lm.decode_step(params, state, tok, prompt.shape[1] + i, cfg)
    return logits[0, -1].float()


def replay_at_rows(torch, lm, engine_mod, eng, req, toks, step, dev):
    """The engine's own computation of one request up to ``step``, outside
    the engine: its prefill (bucket or chunks, batch 1), the state put into
    a slot as the engine puts it (kv_pool.scatter_slot: a chunked
    prefill's K/V cut to the pool's ``seq_len`` rows and its dtype, so
    attention reduces over the engine's row count), copied to ``capacity``
    rows, and decode steps at that many rows over the tokens ``toks``
    (decode rows are independent: the engine's other rows change nothing).
    Returns row 0's logits at ``step``."""
    rows = eng.capacity
    with torch.no_grad():
        logits, one = engine_mod.prefill_prompt(eng.serve_params, eng.cfg, req.prompt,
                                                eng.seq_len, eng.chunk, dev)
        state = lm.init_decode_state(eng.cfg, 1, eng.seq_len, dev)
        for g, group in enumerate(state):
            for lk, layer in group.items():
                for k, v in layer.items():
                    v.copy_(one[g][lk][k][:, :v.shape[1]])
        state = [{lk: {k: torch.cat([v] * rows) for k, v in layer.items()}
                  for lk, layer in g.items()} for g in state]
        for i in range(step):
            tok = torch.full((rows, 1), toks[i], dtype=torch.int32, device=dev)
            pos = torch.full((rows,), len(req.prompt) + i, dtype=torch.int32, device=dev)
            logits, state = lm.decode_step(eng.serve_params, state, tok, pos, eng.cfg)
    return logits[0, -1].float()


def engine_vs_one_shot(torch, dev, lm, serve, engine_mod, eng, reqs, tokens, indices,
                       f32=True) -> list:
    """Gate 6: each greedy request of ``indices`` against the port's
    one-shot path alone on the card (``seq_len`` KV rows).  First-token
    logits of the engine's prefill against the one-shot prefill in float32
    (the same weights, computed in float32) within LOGIT_TOL of their
    scale.  In the path's bf16 the same difference is recorded beside the
    one-shot's own spread between 1 and ``capacity`` rows of the prompt,
    not gated: through 32-80 random bf16 layers a last-bit difference
    grows to a tenth of the logits' scale, the one-shot's included.  Tokens
    equal to the one-shot serve.generate's; where they part, the parting
    must be the row count's: the engine's computation of that request
    replayed at ``capacity`` rows (replay_at_rows) picks the engine's token
    there (printed with the step, the one-shot's top-two margin and the
    replay's logit difference).  Without ``f32`` (a model whose float32
    pass does not fit beside its bf16 weights) the float32 reading is not
    taken and the path's dtype is recorded alone."""
    cfg, params, rows = eng.cfg, eng.serve_params, eng.capacity
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    first = lambda c, prompt, batch: lm.prefill(
        params, torch.tensor([prompt] * batch, device=dev),
        lm.init_decode_state(c, batch, eng.seq_len, dev), c)[0][:, -1].float()
    out = []
    for i in indices:
        req = reqs[i]
        what = f"{cfg.name} engine request {i} (prompt {len(req.prompt)})"
        errs = {}
        with torch.no_grad():
            for c in ((cfg32, cfg) if f32 else (cfg,)):
                one = first(c, req.prompt, 1)[0]
                mine = engine_mod.prefill_prompt(params, c, req.prompt, eng.seq_len, eng.chunk,
                                                 dev)[0][0, -1].float()
                spread = float((first(c, req.prompt, rows)[0] - one).abs().max())
                errs[str(c.cdtype).replace("torch.", "")] = (
                    float((mine - one).abs().max()), max(1.0, float(one.abs().max())), spread)
        (e32, s32, sp32), (err, scale, spread) = errs.get("float32", (None,) * 3), errs[
            str(cfg.cdtype).replace("torch.", "")]
        if f32 and not e32 <= LOGIT_TOL * s32:
            raise AssertionError(f"{what}: float32 first-token logits differ from one-shot by "
                                 f"{e32:.3e} (> {LOGIT_TOL} * {s32:.3f})")
        prompt = torch.tensor([req.prompt], device=dev)
        one, _ = serve.generate(params, cfg, prompt, eng.seq_len, req.max_new_tokens)
        one = tuple(one[0].tolist())
        part = next((j for j, (x, y) in enumerate(zip(one, tokens[i])) if x != y), None)
        margin = step_err = None
        if part is not None:
            one_logits = one_shot_logits(torch, lm, params, cfg, prompt, one, eng.seq_len, part)
            top2 = torch.topk(one_logits, 2).values
            margin = float(top2[0] - top2[1])
            replay = replay_at_rows(torch, lm, engine_mod, eng, req, one, part, dev)
            step_err = float((replay - one_logits).abs().max())
            picked = int(torch.argmax(replay))
            log(f"[engine] {what}: parts from one-shot at step {part} (engine "
                f"{tokens[i][part]}, one-shot {one[part]}); one-shot top-two margin "
                f"{margin:.4e}; the engine's computation replayed at {rows} rows picks "
                f"{picked}, its logits {step_err:.4e} from the one-shot's")
            if picked != tokens[i][part]:
                raise AssertionError(f"{what}: tokens part from one-shot at step {part} "
                                     f"(margin {margin:.4e}) where the row count does not "
                                     f"explain it")
        out.append(dict(request=i, prompt=len(req.prompt), first_logit_err=err, scale=scale,
                        one_shot_rows_spread=spread, first_logit_err_f32=e32, scale_f32=s32,
                        one_shot_rows_spread_f32=sp32, tokens_equal=part is None,
                        parts_at=part, margin=margin, step_logit_err=step_err))
    return out


def engine_card_vs_cpu(torch, dev, lm, engine_mod, get_config, arch, page_size,
                       kv_pages) -> dict:
    """Gate 7: ``arch`` at kernel-q3 in float32 at full width cut to
    CPU_LAYERS layers, the same engine (phase 10's geometry, K = 4) on the
    card and on the CPU (plain versions) over greedy requests of
    ENGINE_CPU_PROMPTS: first-token logits within LOGIT_TOL of their scale
    and tokens equal (a step whose CPU top two lie within the tolerance
    held by its logits alone)."""
    cfg = get_config(arch, "kernel-q3", compute_dtype="float32", n_layers=CPU_LAYERS)
    card = lm.prepack_params(
        lm.init_params(torch.Generator(device=dev).manual_seed(SEED), cfg, dev), cfg)
    host = _to_cpu(card)
    g = torch.Generator().manual_seed(SEED + 4)
    reqs = [engine_mod.Request(prompt=torch.randint(0, cfg.vocab, (P,), generator=g).tolist(),
                               max_new_tokens=CPU_NEW) for P in ENGINE_CPU_PROMPTS]
    got = []                       # (tokens, first-token logits, seq_len): CPU, card
    t0 = time.perf_counter()
    for params, device in ((host, torch.device("cpu")), (card, dev)):
        eng = engine_mod.EpimEngine(cfg, params, capacity=ENGINE_CAPACITY,
                                    max_len=ENGINE_MAX_LEN, page_size=page_size,
                                    kv_pages=kv_pages, prefill_chunk=ENGINE_CHUNK,
                                    decode_block=ENGINE_BLOCK, device=device)
        handles = [eng.submit(r) for r in reqs]
        eng.drain()
        logits = [engine_mod.prefill_prompt(params, cfg, r.prompt, eng.seq_len, eng.chunk,
                                            device)[0][0, -1].float().cpu() for r in reqs]
        got.append(([h.result().tokens for h in handles], logits, eng.seq_len))
    cpu_s = time.perf_counter() - t0
    (cpu_toks, cpu_logits, seq_len), (card_toks, card_logits, _) = got
    what = f"{arch} kernel-q3 float32 {CPU_LAYERS} layers engine"
    out = []
    for i, r in enumerate(reqs):
        a, b = card_logits[i], cpu_logits[i]
        scale = max(1.0, float(b.abs().max()))
        err = float((a - b).abs().max())
        if not err <= LOGIT_TOL * scale:
            raise AssertionError(f"{what}: request {i} first-token logits on the card differ "
                                 f"from the CPU by {err:.3e} (> {LOGIT_TOL} * {scale:.3f})")
        ta, tb = card_toks[i], cpu_toks[i]
        part = next((j for j, (x, y) in enumerate(zip(ta, tb)) if x != y), None)
        if part is not None:
            top2 = torch.topk(one_shot_logits(torch, lm, host, cfg, torch.tensor([r.prompt]),
                                              tb, seq_len, part), 2).values
            gap = float(top2[0] - top2[1])
            if gap > LOGIT_TOL * scale:
                raise AssertionError(f"{what}: request {i} tokens {ta} on the card, {tb} on "
                                     f"the CPU")
            log(f"[engine-cpu] request {i} step {part}: CPU top two within {gap:.2e}; "
                f"held by its logits alone")
        out.append(dict(prompt=len(r.prompt), first_logit_err=err, scale=scale,
                        tokens=list(tb), tokens_equal=part is None))
    log(f"[engine-cpu] {what}, prompts {list(ENGINE_CPU_PROMPTS)} + {CPU_NEW}: card vs cpu "
        f"first-token logits max|d| " + ", ".join(f"{o['first_logit_err']:.2e}" for o in out)
        + f" (max|logit| {max(o['scale'] for o in out):.3f}); tokens equal "
        f"{[o['tokens_equal'] for o in out]}; both runs {cpu_s:.1f} s")
    del card, host
    torch.cuda.empty_cache()
    return dict(arch=arch, requests=out, seconds=cpu_s)


def engine_path(torch, dev, lm, serve, engine_mod, get_config, arch, page_size, kv_pages,
                per_fwd, oneshot, launch_counts, reset_launch_counts, built=None,
                micro=None, f32=None) -> dict:
    """Phase 10 for one LM: ``EngineConfig(...).build()`` at kernel-q3, bf16,
    full width and depth (or ``EpimEngine`` over ``built``, (cfg, params)
    the caller drew and keeps), serving phase 10's requests at K = 4
    (counted: gates 1-3), again at K = 1 and in reverse order (gates 1-3
    each; gates 4 and 5: every request's tokens equal the first run's bit
    for bit), then the greedy requests of ``oneshot`` against one-shot
    generate (gate 6).  A MoE model's engine prefills every prompt whole
    at its exact length (gated), and its K = 4 run makes ``micro`` decode
    micro-steps, the count of its schedule on the CPU.  ``f32`` (default:
    the engine built here) takes gate 6's float32 reading."""
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    geometry = dict(capacity=ENGINE_CAPACITY, max_len=ENGINE_MAX_LEN, page_size=page_size,
                    kv_pages=kv_pages, prefill_chunk=ENGINE_CHUNK)
    if built is None:
        eng = engine_mod.EngineConfig(arch=arch, epitome="kernel-q3",
                                      decode_block=ENGINE_BLOCK, seed=SEED, **geometry).build()
    else:
        eng = engine_mod.EpimEngine(*built, decode_block=ENGINE_BLOCK, device=dev, **geometry)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    cfg, params = eng.cfg, eng.serve_params
    sites = sum(site_specs(lm, cfg).values()) * cfg.n_groups
    if sites != per_fwd:
        raise AssertionError(f"{arch}: {sites} epitomized projections, expected {per_fwd}")
    reqs = engine_requests(torch, engine_mod.Request, cfg.vocab)
    n = len(reqs)
    drive = lambda e, order: engine_drive(torch, e, reqs, order, launch_counts,
                                          reset_launch_counts, per_fwd)
    main = drive(eng, range(n))
    peak = torch.cuda.max_memory_allocated()
    k1 = drive(engine_mod.EpimEngine(cfg, params, decode_block=1, device=dev, **geometry),
               range(n))
    rev = drive(engine_mod.EpimEngine(cfg, params, decode_block=ENGINE_BLOCK, device=dev,
                                      **geometry), range(n - 1, -1, -1))
    if kv_pages and not main["deferred_steps"]:
        raise AssertionError(f"{arch} engine: {kv_pages} pages never made admission defer")
    if not eng.bucket_prompts:
        exact = {("bucket", len(r.prompt)) for r in reqs}
        if eng.chunk or main["stats"]["prefill_chunks"] or eng._prefill_shapes != exact:
            raise AssertionError(f"{arch} engine: chunk {eng.chunk}, prefills "
                                 f"{sorted(eng._prefill_shapes)}: not every prompt whole at "
                                 f"its exact length")
    if micro is not None and main["stats"]["decode_micro_steps"] != micro:
        raise AssertionError(f"{arch} engine: {main['stats']['decode_micro_steps']} decode "
                             f"micro-steps, the schedule makes {micro}")
    for label, run in (("decode_block 1", k1), ("reverse order", rev)):
        diff = [i for i in range(n) if run["tokens"][i] != main["tokens"][i]]
        if diff:
            raise AssertionError(f"{arch} engine: {label} changes the tokens of requests "
                                 f"{diff} (bit for bit against decode_block {ENGINE_BLOCK})")
    t1 = time.perf_counter()
    vs = engine_vs_one_shot(torch, dev, lm, serve, engine_mod, eng, reqs, main["tokens"],
                            oneshot, f32=built is None if f32 is None else f32)
    oneshot_s = time.perf_counter() - t1
    st = main["stats"]
    # the forwards by row count: whole prefills at their bucket (a MoE
    # model's at the prompt's length), chunks at the chunk, decode
    # micro-steps at the capacity (kernel #1's T)
    by_T = {}
    for r in reqs:
        if not eng.chunk or len(r.prompt) <= eng.chunk:
            L = engine_mod.prefill_len(cfg, len(r.prompt), eng.seq_len)
            by_T[L] = by_T.get(L, 0) + 1
    by_T_wkv = dict(by_T)
    if st["prefill_chunks"]:
        by_T[eng.chunk] = by_T.get(eng.chunk, 0) + st["prefill_chunks"]
        by_T_wkv[eng.chunk] = by_T[eng.chunk]
    by_T[ENGINE_CAPACITY] = by_T.get(ENGINE_CAPACITY, 0) + st["decode_micro_steps"]
    med = lambda run, k: statistics.median(run["step_ms"][k]) if run["step_ms"].get(k) else None
    run = dict(arch=arch, n_layers=cfg.n_layers, d_model=cfg.d_model, vocab=cfg.vocab,
               geometry=dict(geometry, decode_block=ENGINE_BLOCK, seq_len=eng.seq_len,
                             chunk=eng.chunk),
               requests=[[len(r.prompt), r.max_new_tokens, r.temperature] for r in reqs],
               setup_s=setup_s, peak_bytes=peak, stats=st, launches=main["launches"],
               wall_s=main["wall_s"], tok_s=main["tok_s"], ttft_p50_s=main["ttft_p50_s"],
               ttft_max_s=main["ttft_max_s"], deferred_steps=main["deferred_steps"],
               macro_ms_k4=med(main, ENGINE_BLOCK), macro_ms_k1=med(k1, 1),
               k1=dict(wall_s=k1["wall_s"], tok_s=k1["tok_s"], stats=k1["stats"]),
               reverse=dict(wall_s=rev["wall_s"], tok_s=rev["tok_s"]),
               forwards_by_rows=by_T, wkv_by_rows=by_T_wkv, one_shot=vs, one_shot_s=oneshot_s,
               tokens_sample=list(main["tokens"][0][:8]), tokens=main["tokens"])
    p_tot = st["pages_total"]
    log(f"[engine] {arch} kernel-q3 bf16 {cfg.n_layers} layers, d_model {cfg.d_model}: "
        f"{n} requests ({len(ENGINE_PROMPTS)} greedy, {len(ENGINE_SAMPLED)} sampled), capacity "
        f"{ENGINE_CAPACITY}, max_len {ENGINE_MAX_LEN}, chunk {eng.chunk}, pages "
        f"{'dense' if not p_tot else f'{page_size} tokens x {p_tot}'}; build {setup_s:.1f} s")
    log(f"[engine] {arch} K={ENGINE_BLOCK}: wall {main['wall_s']:.2f} s, "
        f"{main['tok_s']:.1f} tok/s, TTFT p50 {1e3 * main['ttft_p50_s']:.1f} ms max "
        f"{1e3 * main['ttft_max_s']:.1f} ms, macro-steps {st['decode_steps']} "
        f"({st['decode_micro_steps']} micro), ms per macro-step K={ENGINE_BLOCK} "
        f"{_ms(run['macro_ms_k4'], 2)}, K=1 {_ms(run['macro_ms_k1'], 2)} (its run "
        f"{k1['wall_s']:.2f} s, {k1['stats']['decode_steps']} steps), prefill chunks "
        f"{st['prefill_chunks']} + {main['whole_prefills']} whole "
        f"({'bucketed' if eng.bucket_prompts else 'exact length'}), pages hwm "
        f"{st['pages_hwm']}/{p_tot}, steps with a slot waiting on pages "
        f"{main['deferred_steps']}, peak {peak / 2**30:.2f} GiB; launches "
        + ", ".join(f"{k} x{v}" for k, v in main["launches"].items())
        + f" (exact); K=1 and reverse order bit for bit; tokens[0] {run['tokens_sample']}")
    f32 = lambda o: ("" if o["first_logit_err_f32"] is None else
                     f", float32 {o['first_logit_err_f32']:.3e} of {o['scale_f32']:.2f} (rows "
                     f"{o['one_shot_rows_spread_f32']:.3e})")
    log(f"[engine] {arch} vs one-shot: "
        + "; ".join(f"request {o['request']} (prompt {o['prompt']}) first-token max|d| "
                    f"{o['first_logit_err']:.3e} of {o['scale']:.2f} (one-shot 1 vs "
                    f"{ENGINE_CAPACITY} rows {o['one_shot_rows_spread']:.3e}){f32(o)}, tokens "
                    f"{'equal' if o['tokens_equal'] else 'part at ' + str(o['parts_at'])}"
                    for o in vs) + f"; {oneshot_s:.1f} s")
    del eng, params
    return run


def moe_build(torch, dev, lm, get_config):
    """phi3.5-moe kernel-q3 with bf16 parameters drawn from SEED on the
    card, at the first depth of MOE_DEPTHS that leaves MOE_WORKSPACE bytes
    free.  Returns (cfg, params, {depth, bytes held, bytes free, setup s,
    the depths tried and the bytes each held})."""
    import gc
    tried = []
    for depth in MOE_DEPTHS:
        cfg = get_config(MOE_ARCH, "kernel-q3", param_dtype="bfloat16", n_layers=depth)
        t0 = time.perf_counter()
        params = lm.prepack_params(
            lm.init_params(torch.Generator(device=dev).manual_seed(SEED), cfg, dev), cfg)
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        torch.cuda.empty_cache()
        free, total = torch.cuda.mem_get_info()
        held = torch.cuda.memory_allocated()
        tried.append(dict(depth=depth, bytes=held, free=free))
        log(f"[moe] {MOE_ARCH} kernel-q3 bf16 at {depth} layers: parameters and all else "
            f"allocated {held / 2**30:.2f} GiB ({held} bytes), card free {free / 2**30:.2f} "
            f"of {total / 2**30:.2f} GiB; init+prepack {setup_s:.1f} s")
        if free >= MOE_WORKSPACE or depth == MOE_DEPTHS[-1]:
            return cfg, params, dict(depth=depth, bytes=held, free=free, total=total,
                                     setup_s=setup_s, tried=tried)
        del params
        gc.collect()
        torch.cuda.empty_cache()


class route_recorder:
    """Records every ``moe._route`` call while active: (device, expert
    indices, the smallest gap between each token's k-th and (k+1)-th
    router logit)."""

    def __init__(self, torch, moe):
        self.torch, self.moe, self.seen = torch, moe, []

    def __enter__(self):
        self.orig = orig = self.moe._route

        def rec(x2d, router, cfg):
            w, e = orig(x2d, router, cfg)
            top = self.torch.topk(x2d.float() @ router, cfg.top_k + 1, dim=-1).values
            self.seen.append((x2d.device.type, e.cpu(), float((top[:, -2] - top[:, -1]).min())))
            return w, e
        self.moe._route = rec
        return self

    def __exit__(self, *exc):
        self.moe._route = self.orig


def moe_phase(torch, dev, gen, ops, ref, wrappers, lm, serve, get_config, launch_counts,
              reset_launch_counts):
    """Phase 12: phi3.5-moe kernel-q3 (moe_build), (a) kernel #1 at its two
    epitomized specs (quant_lm_rows); (b) serve.generate, 4 x 256 + 32
    greedy, exactly MOE_SITES launches a layer a forward, three prefills
    bit for bit, timed and profiled, with the MoE FFNs' device time (one
    layer's moe_ffn at the prefill's and a decode step's rows, times the
    layers) beside kernel #1's; (d) the engine on the same weights
    (engine_path: exact-length prefills, K = 1 and reverse order bit for
    bit, one-shot), then kernel #1 at the engine's rows.  With the model
    freed, (c) the 2-layer float32 model card against CPU (logits, greedy
    tokens, the router's experts equal), and the 2-layer float32 engine.
    Returns (kernel rows, report)."""
    import gc
    from repro_torch.launch import engine as engine_mod
    from repro_torch.models import moe
    t_phase = time.perf_counter()
    _RETAG.update({"[lm]": "[moe]", "[lm-kernels]": "[moe-kernels]", "[lm-cpu]": "[moe-cpu]",
                   "[profile] lm": "[profile] moe", "[engine]": "[moe-engine]",
                   "[engine-cpu]": "[moe-cpu]"})
    cfg, params, built = moe_build(torch, dev, lm, get_config)
    sites = sum(site_specs(lm, cfg).values()) * cfg.n_groups
    if sites != MOE_SITES * cfg.n_layers:
        raise AssertionError(f"{MOE_ARCH}: {sites} epitomized projections, expected "
                             f"{MOE_SITES * cfg.n_layers}")
    per_fwd = MOE_SITES * cfg.n_layers
    # (a) kernel #1 at the path's prefill and decode rows
    rows = quant_lm_rows(torch, dev, gen, ops, ref, wrappers, lm, cfg, MOE_ARCH,
                         ((LM_REQUESTS * LM_PROMPT, 1), (LM_REQUESTS, LM_NEW - 1)), LM_REQUESTS)
    torch.cuda.empty_cache()
    # (b) serve.generate
    run = lm_path(torch, dev, lm, serve, cfg, "kernel-q3", {QUANT: per_fwd * LM_NEW},
                  launch_counts, reset_launch_counts, built=(params, built["setup_s"]))
    ffn0 = params["groups"][0]["L0"]["ffn"]
    share = {}
    with torch.no_grad():
        for label, S, busy, prof in (
                ("prefill", LM_PROMPT, run["prefill_busy_ms"], run["prefill_device_breakdown"]),
                ("decode", 1, run["decode_busy_ms"], run["decode_device_breakdown"])):
            h = torch.randn(LM_REQUESTS, S, cfg.d_model, device=dev, generator=gen).to(cfg.cdtype)
            layer_ms = time_ms(torch, lambda: moe.moe_ffn(ffn0, h, cfg))
            # the three expert products alone, as moe_dense runs them
            xe = h.reshape(-1, cfg.d_model).expand(cfg.n_experts, -1, -1)
            g = torch.bmm(xe, ffn0["w_gate"])
            bmm_ms = (2 * time_ms(torch, lambda: torch.bmm(xe, ffn0["w_gate"]))
                      + time_ms(torch, lambda: torch.bmm(g, ffn0["w_down"])))
            k1 = sum(ms for name, ms, _ in prof if "epim_mma::" in name)
            share[label] = dict(moe_layer_ms=layer_ms, moe_ms=layer_ms * cfg.n_layers,
                                moe_bmm_layer_ms=bmm_ms, moe_bmm_ms=bmm_ms * cfg.n_layers,
                                busy_ms=busy, kernel1_ms=k1)
            log(f"[moe] {label}: device busy {busy:.3f} ms; MoE FFN {layer_ms:.3f} ms a layer "
                f"x {cfg.n_layers} = {layer_ms * cfg.n_layers:.3f} ms "
                f"({100 * layer_ms * cfg.n_layers / busy:.1f} % of busy), its three expert "
                f"products {bmm_ms * cfg.n_layers:.3f} ms "
                f"({100 * bmm_ms * cfg.n_layers / busy:.1f} %); kernel #1 {k1:.3f} ms "
                f"({100 * k1 / busy:.1f} %)")
            del h, xe, g
    run.update(depth=built, moe_share=share)
    torch.cuda.empty_cache()
    # (d) the engine on the same weights
    eng_run = engine_path(torch, dev, lm, serve, engine_mod, get_config, MOE_ARCH, MOE_PAGE, 0,
                          per_fwd, MOE_ONESHOT, launch_counts, reset_launch_counts,
                          built=(cfg, params), micro=MOE_MICRO)
    exact = [o["request"] for o in eng_run["one_shot"] if o["first_logit_err"] == 0.0]
    log(f"[moe-engine] exact-length first-token logits bit-equal to one-shot's for requests "
        f"{exact} of {list(MOE_ONESHOT)}"
        + ("" if len(exact) == len(MOE_ONESHOT) else " (not all: see the lines above)"))
    del params, ffn0
    gc.collect()
    torch.cuda.empty_cache()
    rows += quant_lm_rows(torch, dev, gen, ops, ref, wrappers, lm, cfg, f"{MOE_ARCH} engine",
                          sorted(eng_run["forwards_by_rows"].items()), ENGINE_CAPACITY)
    torch.cuda.empty_cache()
    # (c) card against CPU, 2 float32 layers, the router's experts recorded
    with route_recorder(torch, moe) as rr:
        cpu = lm_card_vs_cpu(torch, dev, lm, get_config, MOE_ARCH, "kernel-q3")
    # the CPU's run first, then the card's on the same tokens
    n = len(rr.seen) // 2
    on_cpu = [(e, gap) for d, e, gap in rr.seen[:n]]
    on_card = [e for d, e, _ in rr.seen[n:]]
    if 2 * n != len(rr.seen) or {d for d, _, _ in rr.seen[:n]} != {"cpu"} \
            or {d for d, _, _ in rr.seen[n:]} != {dev.type} \
            or not all(torch.equal(a, b) for (a, _), b in zip(on_cpu, on_card)):
        raise AssertionError(f"{MOE_ARCH}: the router picks other experts on the card than "
                             f"on the CPU")
    gap = min(g for _, g in on_cpu)
    log(f"[moe-cpu] {MOE_ARCH} float32 {CPU_LAYERS} layers: the router's experts equal on the "
        f"card and the CPU over {len(on_cpu)} routings ({sum(e.shape[0] for e, _ in on_cpu)} "
        f"tokens); smallest gap between a token's k-th and (k+1)-th router logit {gap:.3e}")
    eng_cpu = engine_card_vs_cpu(torch, dev, lm, engine_mod, get_config, MOE_ARCH, MOE_PAGE, 0)
    seconds = time.perf_counter() - t_phase
    _RETAG.clear()
    log(f"[moe] phase 12 {seconds:.1f} s at {cfg.n_layers} layers"
        + ("" if cfg.n_layers == MOE_DEPTHS[0] else
           f" (cut from {MOE_DEPTHS[0]}: " + ", ".join(
               f"{t['depth']} layers held {t['bytes']} bytes, {t['free']} free"
               for t in built["tried"]) + ")"))
    return rows, dict(lm=run, engine=eng_run, card_vs_cpu=cpu, router=dict(
        routings=len(on_cpu), min_gap=gap), engine_card_vs_cpu=eng_cpu, seconds=seconds)



# -- phase 13: training ------------------------------------------------------------
def ptxas_of(log_text: str) -> dict:
    """{entry: (registers, spill store bytes, spill load bytes)} from an nvcc
    -Xptxas -v log."""
    out, entry = {}, None
    for line in log_text.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            entry = m.group(1)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and entry:
            out[entry] = [None, int(m.group(1)), int(m.group(2))]
        m = re.search(r"Used (\d+) registers", line)
        if m and entry:
            out.setdefault(entry, [None, 0, 0])[0] = int(m.group(1))
    return {k: tuple(v) for k, v in out.items()}


def wkv_bwd_rows(torch, dev, gen, ref, wrappers, cfg, path, launches) -> list:
    """Phase 13 (a): the WKV backward kernel at the training shape (B, S)
    against its plain version and against autograd through the chunked
    plain forward (the WKV gate), three times bit for bit, timed.  Cases:
    r, k, v in bf16 with a zero h0 and no dhT (the LM's, counted
    ``launches``), float32 with h0 and dhT, float32 with neither, and a
    ragged S."""
    from repro_torch.kernels import _build
    B, S, H, K = TRAIN_BATCH, TRAIN_SEQ, cfg.n_heads, cfg.hd
    f = lambda *s: torch.randn(s, device=dev, generator=gen)
    ptxas = ptxas_of(_build.build_log.get("wkv6_bwd", ""))
    rows = []
    for dtype, h0_kind, dh, seq in ((cfg.cdtype, "zero", False, S), (torch.float32, "random", True, S),
                                    (torch.float32, None, False, S),
                                    (cfg.cdtype, "random", True, S - 6)):
        dname = str(dtype).replace("torch.", "")
        r, k_, v = (f(B, seq, H, K).to(dtype) for _ in range(3))
        lw, u = -torch.exp(f(B, seq, H, K) * 0.5), f(H, K) * 0.1
        h0 = {None: None, "zero": torch.zeros(B, H, K, K, device=dev),
              "random": f(B, H, K, K) * 0.5}[h0_kind]
        do, dhT = f(B, seq, H, K), (f(B, H, K, K) if dh else None)
        what = f"{WKV_BWD} {dname} S={seq} h0={h0_kind} dhT={'random' if dh else None}"
        kernel = lambda: wrappers[WKV_BWD](r, k_, v, lw, u, h0, do, dhT)
        plain = lambda: ref.wkv6_chunked_bwd_ref(r, k_, v, lw, u, h0, do, dhT)
        outs = [kernel() for _ in range(3)]
        if not all(torch.equal(a, b) for o in outs[1:] for a, b in zip(o, outs[0])):
            raise AssertionError(f"{what}: three identical launches differ")
        names = ("dr", "dk", "dv", "dlogw", "du", "dh0")
        err = max(max_err(torch, a, b, WKV_TOL, f"{what} {n}")
                  for a, b, n in zip(outs[0], plain(), names))
        # autograd through the chunked plain forward (float32 r, k, v: the
        # plain version reads bf16 ones as these float32 values)
        ins = [t.float().requires_grad_(True) for t in (r, k_, v, lw, u)]
        state = None if h0 is None else h0.clone().requires_grad_(True)
        o, hT = ref.wkv6_chunked_ref(*ins, state, chunk=cfg.rwkv_chunk)
        out = (o * do).sum() + ((hT * dhT).sum() if dh else 0.0)
        grads = torch.autograd.grad(out, ins + ([state] if state is not None else []))
        err_auto = max(max_err(torch, a, b, WKV_TOL, f"{what} {n} (autograd)")
                       for a, b, n in zip(outs[0], grads, names))
        del ins, state, o, hT, out, grads, outs
        esz = r.element_size()
        nbytes = _cost().wkv_bwd_bytes(B, seq, H, K, esz, h0 is not None, dh)
        scratch = 4.0 * B * H * -(-seq // 64) * 4096     # a 64 x 64 state a chunk
        chunked = _cost().wkv_bwd_chunked_ops(B, seq, H, K)
        row = timed_row(torch, WKV_BWD, kernel, plain, None, nbytes,
                        _cost().wkv_bwd_ops(B, seq, H, K),
                        products=chunked)
        regs, st, ld = next((v for e, v in ptxas.items()
                             if "wkv6_bwd_kernel" in e and ("bfloat16" in e) == (esz == 2)),
                            (None, None, None))
        row.update(B=B, S=seq, H=H, K=K, dtype=dname, h0=h0_kind, dhT=dh, max_abs_err=err,
                   max_abs_err_autograd=err_auto, scratch_bytes=scratch, path=path,
                   chunked_flops=chunked[0], chunked_products=chunked[1], registers=regs,
                   spill_bytes=None if st is None else st + ld,
                   count=launches if (dtype == cfg.cdtype and h0_kind == "zero" and not dh
                                      and seq == S) else 0)
        rows.append(row)
        log(f"[train-kernels] {what} B={B} H={H} K={K} x{row['count']}: max_err "
            f"{err:.2e} (plain), {err_auto:.2e} (autograd of the chunked forward); 3 launches "
            f"bit for bit; ms={row['ms']:.4f} (eager {row['ms_eager']:.4f}) plain_ms="
            f"{row['plain_ms']:.3f} library_ms=none bound_ms={row['bound_ms']:.4f} "
            f"({row['bound_by']}; {nbytes / 1e9:.3f} GB; the chunked form's "
            f"{chunked[1] / 1e9:.2f} GFLOP of products at 3xTF32 and "
            f"{(chunked[0] - chunked[1]) / 1e9:.2f} at the fp32 rate: bound_tc_ms="
            f"{row['bound_tc_ms']:.4f}) bound_fp32_ms={row['bound_fp32_ms']:.4f} (the token "
            f"form's {row['flops'] / 1e9:.2f} GFLOP); scratch {scratch / 1e9:.4f} GB not "
            f"counted; " + ("ptxas: not built in this process" if regs is None else
                            f"ptxas {regs} registers, {row['spill_bytes']} bytes spilled"))
        del r, k_, v, lw, u, h0, do, dhT
        torch.cuda.empty_cache()
    return rows


def _checksum(torch, tensors) -> list:
    """Two integer sums of each tensor's bits (plain and position-weighted,
    both exact in int64 arithmetic, whatever the order): equal lists mean
    equal bits, short of a collision."""
    out = []
    for t in tensors:
        t = t.detach().contiguous()
        bits = t.view({4: torch.int32, 2: torch.int16, 1: torch.int8}[t.element_size()])
        bits = bits.reshape(-1).to(torch.int64)
        w = torch.arange(bits.numel(), device=bits.device) % 65521 + 1
        out.append((int(bits.sum()), int((bits * w).sum())))
        del bits, w
    return out


def train_card_vs_cpu(torch, dev, lm, get_config, loop, optimizer, SyntheticData, leaves):
    """Phase 13 (b): rwkv6-7b folded-q3 in float32 at full width, cut to
    CPU_LAYERS layers, TRAIN_CPU_BATCH x TRAIN_CPU_SEQ tokens: the loss and
    every gradient leaf on the card against the CPU (plain versions), and
    one AdamW step (lr TRAIN_CPU_LR, no warm-up) taken on both devices from
    the CPU's gradients, each parameter's change within 1e-3 lr of the
    CPU's.  The step is held on one set of gradients because Adam's first
    update g / (|g| + eps) is about +-lr per element: an element whose
    gradient lies within the devices' rounding of zero may take it in
    either sign, so the gradients are held leaf by leaf instead."""
    from repro_torch.train.tree import tree_map
    cfg = get_config(TRAIN_ARCH, TRAIN_VARIANT, compute_dtype="float32", n_layers=CPU_LAYERS)
    card = lm.init_params(torch.Generator(device=dev).manual_seed(SEED), cfg, dev)
    host = _to_cpu(card)
    batch = SyntheticData(cfg.vocab, TRAIN_CPU_SEQ, TRAIN_CPU_BATCH, seed=SEED).batch(0)
    opt = optimizer.AdamWConfig(lr=TRAIN_CPU_LR, warmup_steps=0)
    t0 = time.perf_counter()
    h_loss, h_grads = loop.loss_and_grads(host, batch, cfg)
    cpu_s = time.perf_counter() - t0
    c_loss, c_grads = loop.loss_and_grads(card, {k: v.to(dev) for k, v in batch.items()}, cfg)
    what = f"{TRAIN_ARCH} {TRAIN_VARIANT} float32 {CPU_LAYERS} layers"
    scale = max(1.0, abs(float(h_loss)))
    loss_err = abs(float(c_loss) - float(h_loss))
    if not loss_err <= LOGIT_TOL * scale:
        raise AssertionError(f"{what}: loss {float(c_loss)} on the card, {float(h_loss)} on "
                             f"the CPU")
    g_err, n_leaves = 0.0, len(leaves(h_grads))
    for i, (a, b) in enumerate(zip(leaves(c_grads), leaves(h_grads))):
        if bool(a.abs().max() > 0) != bool(b.abs().max() > 0):
            raise AssertionError(f"{what}: gradient leaf {i} is zero on one device only")
        g_err = max(g_err, max_err(torch, a.cpu(), b, GRAD_TOL, f"{what} gradient leaf {i}"))
    nonzero = sum(bool(b.abs().max() > 0) for b in leaves(h_grads))
    del c_grads
    old = [p.detach().clone() for p in leaves(host)]
    for params, grads in ((card, tree_map(lambda g: g.to(dev), h_grads)), (host, h_grads)):
        st = {"params": params, "opt": optimizer.adamw_init(params, opt),
              "step": torch.zeros((), dtype=torch.int32, device=leaves(params)[0].device)}
        loop.apply_grads(st, grads, opt)
        del st, grads
    step_tol, p_err, moved = 1e-3 * opt.lr, 0.0, 0.0
    for i, (p0, a, b) in enumerate(zip(old, leaves(card), leaves(host))):
        d_card, d_cpu = a.detach().cpu() - p0, b.detach() - p0
        err = float((d_card - d_cpu).abs().max())
        if not err <= step_tol:
            raise AssertionError(f"{what}: parameter {i} moved {err:.3e} apart in one AdamW "
                                 f"step on the same gradients (gate {step_tol:.1e})")
        p_err, moved = max(p_err, err), max(moved, float(d_cpu.abs().max()))
    if not moved > 0.5 * opt.lr:
        raise AssertionError(f"{what}: one AdamW step at lr {opt.lr} moved no parameter "
                             f"past {moved:.3e}")
    log(f"[train-cpu] {what}, {TRAIN_CPU_BATCH}x{TRAIN_CPU_SEQ}: loss {float(c_loss):.6f} card, "
        f"{float(h_loss):.6f} cpu (|d| {loss_err:.2e}); {n_leaves} gradient leaves, "
        f"{nonzero} non-zero on both, max |d| {g_err:.2e} (gate {GRAD_TOL} + {GRAD_TOL} |ref|); "
        f"one AdamW step at lr {opt.lr} on the CPU's gradients: changes up to {moved:.3e}, "
        f"card vs cpu max |d| {p_err:.2e} (gate {step_tol:.1e}); cpu loss and grads "
        f"{cpu_s:.1f} s")
    del card, host, h_grads, old
    torch.cuda.empty_cache()
    return dict(loss_card=float(c_loss), loss_cpu=float(h_loss), loss_err=loss_err,
                grad_max_abs_err=g_err, leaves=n_leaves, nonzero_leaves=nonzero,
                step_lr=opt.lr, step_max_change=moved, step_max_abs_err=p_err, cpu_s=cpu_s)


def train_refusals(torch, dev, lm, get_config, loop, leaves) -> list:
    """Phase 13: on the card, loss_fn's backward at kernel and kernel-q3
    (2 layers, full width, bf16) raises NotImplementedError."""
    out = []
    for variant in ("kernel", "kernel-q3"):
        cfg = get_config(TRAIN_ARCH, variant, n_layers=CPU_LAYERS)
        params = lm.prepack_params(
            lm.init_params(torch.Generator(device=dev).manual_seed(SEED), cfg, dev), cfg)
        for p in leaves(params):
            if p.is_floating_point():
                p.requires_grad_(True)
        toks = torch.randint(0, cfg.vocab, (1, 65), device=dev,
                             generator=torch.Generator(device=dev).manual_seed(SEED))
        loss = lm.loss_fn(params, {"tokens": toks[:, :-1], "labels": toks[:, 1:]}, cfg)
        try:
            loss.backward()
        except NotImplementedError as e:
            out.append(variant)
            log(f"[train] {TRAIN_ARCH} {variant} on the card: loss {float(loss.detach()):.4f}; "
                f"backward refused: {str(e)[:60]}...")
        else:
            raise AssertionError(f"{TRAIN_ARCH} {variant}: backward ran on the card")
        del params, loss
        torch.cuda.empty_cache()
    return out


def train_first_step(torch, loop, leaves, cfg, opt, state, batch0, launch_counts,
                     reset_launch_counts) -> tuple:
    """The warm-up step in its two parts (``loss_and_grads``, then
    ``apply_grads``): exactly 2 launches of kernel #4 and one of its
    backward a layer, no other kernel; u, w0 and the E of wr/wk/wv with
    non-zero gradients.  On a mesh the state's laid-out leaves are read
    whole.  Returns (state, loss, the gradients' checksums, the new
    state's checksums, grad norm)."""
    from repro_torch.core.layers import unshard
    per_step = {WKV: 2 * cfg.n_layers, WKV_BWD: cfg.n_layers}
    what = f"{TRAIN_ARCH} {TRAIN_VARIANT}"
    reset_launch_counts()
    loss, grads = loop.loss_and_grads(state["params"], batch0, cfg)
    torch.cuda.synchronize()
    counts = launch_counts()
    if counts != {k: per_step.get(k, 0) for k in counts}:
        raise AssertionError(f"{what}: a step launched {counts}, expected {per_step}")
    sums = _checksum(torch, leaves(grads))
    flat = leaves(grads)
    names = [n for n, _ in _named(state["params"])]
    wkv = [(g, name) for g, name in zip(flat, names) if "mixer" in name and (
        name.rsplit("/", 1)[-1] in ("u", "w0") or name.endswith(("wr/E", "wk/E", "wv/E")))]
    if len(wkv) != 5 * cfg.n_layers:
        raise AssertionError(f"{what}: {len(wkv)} leaves named u, w0, wr/wk/wv E, "
                             f"expected 5 a layer")
    for g, name in wkv:
        if not bool(g.abs().max() > 0):
            raise AssertionError(f"{what}: {name} has a zero gradient")
    state, metrics = loop.apply_grads(state, grads, opt)
    del grads, flat, wkv
    return (state, float(loss), sums, _checksum(torch, [unshard(t) for t in leaves(state)]),
            float(metrics["grad_norm"]))


def train_full(torch, dev, lm, get_config, loop, optimizer, SyntheticData, leaves,
               launch_counts, reset_launch_counts) -> dict:
    """Phase 13 (c): rwkv6-7b folded-q3 at full width and depth (bf16
    compute, float32 parameters and moments) through init_state ->
    make_train_step -> train_loop on SyntheticData(vocab, TRAIN_SEQ,
    TRAIN_BATCH): a warm-up step taken in its two parts (loss_and_grads,
    apply_grads) with the launches and non-zero gradients checked, then
    TRAIN_STEPS timed steps through train_loop (the main path, counted),
    one profiled, the optimizer and fake quant timed, and the warm-up step
    taken again from a fresh state of the same seed: loss, gradients and
    the new state bit for bit."""
    from repro_torch.core.quant import fake_quant
    cfg = get_config(TRAIN_ARCH, TRAIN_VARIANT)
    opt, tcfg = optimizer.AdamWConfig(), loop.TrainConfig(checkpoint_every=10 ** 9, log_every=1)
    data = SyntheticData(vocab=cfg.vocab, seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH, seed=SEED)
    per_step = {WKV: 2 * cfg.n_layers, WKV_BWD: cfg.n_layers}
    what = f"{TRAIN_ARCH} {TRAIN_VARIANT}"
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    alloc0 = torch.cuda.memory_allocated()
    state = loop.init_state(torch.Generator(device=dev).manual_seed(SEED), cfg, opt, tcfg, dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    state_alloc = torch.cuda.memory_allocated() - alloc0     # phase 18's dry run
    n_params = sum(p.numel() for p in leaves(state["params"]))
    state_bytes = sum(t.numel() * t.element_size() for t in leaves(state))
    batch0 = {k: v.to(dev) for k, v in data.batch(0).items()}
    first_step = lambda state: train_first_step(torch, loop, leaves, cfg, opt, state, batch0,
                                                launch_counts, reset_launch_counts)
    t0 = time.perf_counter()
    state, loss0, gsum0, ssum0, gn0 = first_step(state)
    warm_s = time.perf_counter() - t0
    if not (math.isfinite(loss0) and loss0 > 0 and math.isfinite(gn0) and gn0 > 0):
        raise AssertionError(f"{what}: warm-up loss {loss0}, grad norm {gn0}")
    # the main path: TRAIN_STEPS steps through train_loop, counted
    step_fn = loop.make_train_step(cfg, opt, tcfg)
    norms = []

    def recorded(st, batch):
        st, m = step_fn(st, batch)
        norms.append(float(m["grad_norm"]))
        return st, m
    reset_launch_counts()
    state, hist = loop.train_loop(state, recorded, data, 1 + TRAIN_STEPS, train_cfg=tcfg,
                                  log=lambda line: log(f"[train] {line}"))
    counts = launch_counts()
    expect = {k: v * TRAIN_STEPS for k, v in per_step.items()}
    if counts != {k: expect.get(k, 0) for k in counts}:
        raise AssertionError(f"{what}: {TRAIN_STEPS} steps launched {counts}, expected {expect}")
    if len(hist["loss"]) != TRAIN_STEPS or not all(
            math.isfinite(x) and x > 0 for x in hist["loss"] + norms):
        raise AssertionError(f"{what}: losses {hist['loss']}, grad norms {norms}")
    step_ms = statistics.median(hist["step_time"]) * 1e3
    peak = torch.cuda.max_memory_allocated()
    # one step profiled, and its WKV kernels' device time
    prof = device_breakdown(torch, lambda: step_fn(state, data.batch(1 + TRAIN_STEPS)))
    busy = sum(ms for _, ms, _ in prof)
    wkv_fwd = sum(ms for name, ms, _ in prof if "wkv6_kernel" in name)
    wkv_bwd = sum(ms for name, ms, _ in prof if "wkv6_bwd_kernel" in name or "du_reduce" in name)
    # the optimizer alone (two steps on one gradient) and fake quant per site
    _, grads = loop.loss_and_grads(state["params"], batch0, cfg)
    opt_ms = []
    for _ in range(2):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        loop.apply_grads(state, grads, opt)
        end.record()
        torch.cuda.synchronize()
        opt_ms.append(start.elapsed_time(end))
    del grads
    fq = 0.0
    g0 = state["params"]["groups"][0]
    with torch.no_grad():
        for name, lc in lm.lm_layer_configs(cfg).items():
            layer, kind, w = name.split("/")
            E = g0[layer][kind][w]["E"]
            fq += time_ms(torch, lambda: fake_quant(E, lc.spec, lc.quant))
    # the forward and its recompute quantize every site, the backward none
    fq_step = 2 * cfg.n_groups * fq
    del state
    import gc
    gc.collect()
    torch.cuda.empty_cache()
    # the warm-up step again, from a fresh state of the same seed
    state = loop.init_state(torch.Generator(device=dev).manual_seed(SEED), cfg, opt, tcfg, dev)
    state, loss1, gsum1, ssum1, _ = first_step(state)
    if loss1 != loss0 or gsum1 != gsum0 or ssum1 != ssum0:
        raise AssertionError(f"{what}: two steps from one state on one batch differ: loss "
                             f"{loss0} vs {loss1}, gradients equal {gsum1 == gsum0}, new "
                             f"state equal {ssum1 == ssum0}")
    del state
    gc.collect()
    torch.cuda.empty_cache()
    tokens_s = TRAIN_BATCH * TRAIN_SEQ / (step_ms / 1e3)
    run = dict(arch=TRAIN_ARCH, variant=TRAIN_VARIANT, n_layers=cfg.n_layers,
               d_model=cfg.d_model, d_ff=cfg.d_ff, vocab=cfg.vocab, params=n_params,
               state_bytes=state_bytes, state_alloc_bytes=state_alloc,
               batch=[TRAIN_BATCH, TRAIN_SEQ], init_s=init_s,
               warmup_s=warm_s, losses=hist["loss"], grad_norms=norms,
               step_ms=[t * 1e3 for t in hist["step_time"]], step_ms_median=step_ms,
               tokens_s=tokens_s, peak_bytes=peak, launches=counts, launches_per_step=per_step,
               device_busy_ms=busy, device_breakdown=prof[:20], wkv_fwd_ms=wkv_fwd,
               wkv_bwd_ms=wkv_bwd, optimizer_ms=opt_ms, fake_quant_ms=fq_step,
               repeat_loss=[loss0, loss1], grad_norm0=gn0,
               warmup=dict(loss=loss0, grads=gsum0, state=ssum0))
    log(f"[train] {what} bf16 compute, {cfg.n_layers} layers, d_model {cfg.d_model}, d_ff "
        f"{cfg.d_ff}, vocab {cfg.vocab}: {n_params} parameters, state {state_bytes / 2**30:.2f} "
        f"GiB, init {init_s:.1f} s, warm-up step {warm_s:.1f} s")
    log(f"[train] {what} {TRAIN_BATCH}x{TRAIN_SEQ}: step median {step_ms:.1f} ms (runs "
        f"{', '.join(f'{t * 1e3:.1f}' for t in hist['step_time'])}) = {tokens_s:.0f} tokens/s; "
        f"losses {', '.join(f'{x:.4f}' for x in hist['loss'])}; grad norms "
        f"{', '.join(f'{x:.3f}' for x in norms)}; launches {counts} over {TRAIN_STEPS} steps; "
        f"peak {peak / 2**30:.2f} GiB")
    log(f"[train] {what} one step: device busy {busy:.1f} ms of {step_ms:.1f}; WKV forward "
        f"{wkv_fwd:.2f} ms, backward {wkv_bwd:.2f} ms; fake quant {fq_step:.1f} ms (layer "
        f"0's 8 sites {fq:.3f} ms x 2 x {cfg.n_groups}); optimizer "
        f"{', '.join(f'{t:.1f}' for t in opt_ms)} ms; the warm-up step repeated from a fresh "
        f"state: loss, gradients and new state bit for bit")
    for kname, ms, n in prof[:10]:
        log(f"[profile] train {what}: {ms:9.3f} ms  x{n:<5d} {kname[:90]}")
    return run


def _named(tree, prefix=""):
    """(path, leaf) pairs of a parameter tree, in ``leaves`` order."""
    if isinstance(tree, dict):
        return [x for k, v in tree.items() for x in _named(v, f"{prefix}/{k}")]
    if isinstance(tree, list):
        return [x for i, v in enumerate(tree) for x in _named(v, f"{prefix}/{i}")]
    return [(prefix, tree)]


def train_restart(torch, dev, lm, get_config, loop, optimizer, SyntheticData, leaves,
                  CheckpointManager) -> dict:
    """Phase 13 (d): rwkv6-7b folded-q3 at full width cut to CPU_LAYERS
    layers: steps 0-1 with an async checkpoint at step 2, steps 2-3 on; a
    fresh state restored from the checkpoint takes steps 2-3 again, with
    the same losses and the same final state bit for bit."""
    import shutil
    cfg = get_config(TRAIN_ARCH, TRAIN_VARIANT, n_layers=CPU_LAYERS)
    opt, tcfg = optimizer.AdamWConfig(), loop.TrainConfig(checkpoint_every=2, log_every=10)
    data = SyntheticData(cfg.vocab, TRAIN_CPU_SEQ, TRAIN_CPU_BATCH, seed=SEED)
    step_fn = loop.make_train_step(cfg, opt, tcfg)
    directory = ROOT / "build" / "train_ckpt"
    shutil.rmtree(directory, ignore_errors=True)
    ckpt = CheckpointManager(str(directory), keep=1)
    quiet = lambda *a: None
    state = loop.init_state(torch.Generator(device=dev).manual_seed(SEED), cfg, opt, tcfg, dev)
    t0 = time.perf_counter()
    state, first = loop.train_loop(state, step_fn, data, 2, ckpt=ckpt, train_cfg=tcfg, log=quiet)
    save_s = time.perf_counter() - t0
    state, rest = loop.train_loop(state, step_fn, data, 4, train_cfg=tcfg, log=quiet)
    straight = _checksum(torch, leaves(state))
    del state
    torch.cuda.empty_cache()
    fresh = loop.init_state(torch.Generator(device=dev).manual_seed(SEED + 1), cfg, opt, tcfg, dev)
    t0 = time.perf_counter()
    step, restored = ckpt.restore(fresh)
    restore_s = time.perf_counter() - t0
    del fresh
    restored, again = loop.train_loop(restored, step_fn, data, 4, train_cfg=tcfg, log=quiet)
    ckpt_bytes = sum(p.stat().st_size for p in directory.rglob("*") if p.is_file())
    if step != 2 or again["loss"] != rest["loss"] or _checksum(torch, leaves(restored)) != straight:
        raise AssertionError(f"{TRAIN_ARCH}: the run restored at step {step} differs: losses "
                             f"{again['loss']} vs {rest['loss']}")
    log(f"[train-restart] {TRAIN_ARCH} {TRAIN_VARIANT} {CPU_LAYERS} layers, "
        f"{TRAIN_CPU_BATCH}x{TRAIN_CPU_SEQ}: async checkpoint at step 2 ({ckpt_bytes / 2**30:.2f} "
        f"GiB on disk; steps 0-1 and the write {save_s:.1f} s), restored into a fresh state in "
        f"{restore_s:.1f} s; steps 2-3 losses {', '.join(f'{x:.6f}' for x in again['loss'])} "
        f"and the final state equal the straight run's bit for bit")
    del restored
    shutil.rmtree(directory, ignore_errors=True)
    torch.cuda.empty_cache()
    return dict(losses=first["loss"] + rest["loss"], restored_losses=again["loss"],
                checkpoint_bytes=ckpt_bytes, save_s=save_s, restore_s=restore_s)


def train_phase(torch, dev, gen, ref, wrappers, lm, get_config, launch_counts,
                reset_launch_counts) -> tuple:
    """Phase 13: training.  Returns (kernel rows, report)."""
    import gc
    from repro_torch.train import loop, optimizer
    from repro_torch.train.checkpoint import CheckpointManager
    from repro_torch.train.data import SyntheticData
    from repro_torch.train.tree import leaves
    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    cfg = get_config(TRAIN_ARCH, TRAIN_VARIANT)
    path = f"{TRAIN_ARCH} {TRAIN_VARIANT} train"
    steps_fwd, steps_bwd = 2 * cfg.n_layers * TRAIN_STEPS, cfg.n_layers * TRAIN_STEPS
    rows = wkv_bwd_rows(torch, dev, gen, ref, wrappers, cfg, path, steps_bwd)
    # kernel #4 forward at the training shape (a zero state: rwkv_time_mix's)
    rows += wkv_rows(torch, dev, gen, ref, wrappers, cfg, path, TRAIN_BATCH, TRAIN_SEQ, steps_fwd)
    torch.cuda.empty_cache()
    card_cpu = train_card_vs_cpu(torch, dev, lm, get_config, loop, optimizer, SyntheticData,
                                 leaves)
    refused = train_refusals(torch, dev, lm, get_config, loop, leaves)
    run = train_full(torch, dev, lm, get_config, loop, optimizer, SyntheticData, leaves,
                     launch_counts, reset_launch_counts)
    restart = train_restart(torch, dev, lm, get_config, loop, optimizer, SyntheticData, leaves,
                            CheckpointManager)
    seconds = time.perf_counter() - t_phase
    log(f"[train] phase 13 {seconds:.1f} s")
    return rows, dict(run=run, card_vs_cpu=card_cpu, refused=refused, restart=restart,
                      seconds=seconds)


# -- phase 14: Mamba ---------------------------------------------------------------
def scan_inputs(torch, dev, gen, B, S, di, ds, h0="random"):
    f = lambda *s: torch.randn(s, device=dev, generator=gen)
    dt = torch.nn.functional.softplus(f(B, S, di) - 1.0)
    A = -torch.exp(f(di, ds) * 0.5)
    h = {"random": lambda: f(B, di, ds), "zero": lambda: torch.zeros(B, di, ds, device=dev),
         None: lambda: None}[h0]()
    return dt, f(B, S, di), f(B, S, ds), f(B, S, ds), A, f(di), h


def scan_rows(torch, dev, gen, ref, wrappers, cfg, path, cases) -> list:
    """Phase 14 (a): the scan kernel at jamba's width for each case (B, S,
    dtype of dt, x, B and C, h0 kind, launches counted): against its plain
    version on the same values at KERNEL_TOL (y and hT), timed beside it
    and the bound.  Returns the rows."""
    di, ds = cfg.mamba_d_inner, cfg.mamba_d_state
    rows = []
    for B, S, dtype, h0_kind, count in cases:
        dt, x, Bm, Cm, A, D, h0 = scan_inputs(torch, dev, gen, B, S, di, ds, h0_kind)
        dt, x, Bm, Cm = (t.to(dtype) for t in (dt, x, Bm, Cm))
        dname = str(dtype).replace("torch.", "")
        kernel = lambda: wrappers[MAMBA](dt, x, Bm, Cm, A, D, h0)
        plain = lambda: ref.mamba_scan_ref(dt, x, Bm, Cm, A, D, h0)
        (y, hT), (y_ref, h_ref) = kernel(), plain()
        what = f"{path} {MAMBA} {dname} B={B} S={S} h0 {h0_kind}"
        err = max(max_err(torch, y, y_ref, KERNEL_TOL, f"{what} y"),
                  max_err(torch, hT, h_ref, KERNEL_TOL, f"{what} hT"))
        nbytes = _cost().scan_bytes(B, S, di, ds, dt.element_size(), h0 is not None)
        row = timed_row(torch, MAMBA, kernel, plain, None, nbytes,
                        _cost().scan_ops(B, S, di, ds), dname)
        row.update(B=B, S=S, di=di, ds=ds, dtype=dname, h0=h0_kind, max_abs_err=err, path=path,
                   count=count, sfu_ms=B * S * di * ds / SFU_EXP_S * 1e3)
        rows.append(row)
        log(f"[mamba-kernels] {what} x{count}: max_err={err:.2e} (y and hT) ms={row['ms']:.4f} "
            f"(eager {row['ms_eager']:.4f}) plain_ms={row['plain_ms']:.4f} library_ms=none "
            f"bound_ms={row['bound_ms']:.4f} ({row['bound_by']}) sfu_ms={row['sfu_ms']:.4f}")
        del dt, x, Bm, Cm, y, hT, y_ref, h_ref
    return rows


def scan_ptxas(build_log: dict) -> dict:
    """Phase 14 (a): ptxas' registers and spills of the scan's instances
    <dtype, lanes, vector> from the mamba_scan library's nvcc log
    (``_build.build_log``, read back from beside a library built earlier).
    Raises if no vector instance (jamba's 16 states) is listed or one
    spills."""
    ptxas = ptxas_of(build_log.get("mamba_scan", ""))
    for entry, (regs, st, ld) in ptxas.items():
        log(f"[mamba-kernels] ptxas {entry}: {regs} registers, {st} / {ld} bytes spilled")
    spilled = [k for k, (_, st, ld) in ptxas.items() if "Lb1E" in k and st + ld]
    if spilled or not any("Lb1E" in k for k in ptxas):
        raise AssertionError(f"{MAMBA}: vector instances spill or are missing: {spilled}")
    return ptxas


def scan_bits(torch, dev, gen, wrappers, cfg) -> dict:
    """Phase 14 (a), bit for bit at jamba's width, 4 x 256 tokens: 128 + 128
    tokens carried through hT against one launch of 256; dt = 0 on the last
    7 tokens leaves hT at the state before them; three launches in a row;
    bf16 inputs against float32 inputs of the same values; at 4 x 1 and 4 x
    128 in bf16, each row of the 4-row launch against a 1-row launch of it;
    and 8 one-token launches (4 lanes a channel) against one launch of 8 (2
    lanes)."""
    di, ds = cfg.mamba_d_inner, cfg.mamba_d_state
    dt, x, Bm, Cm, A, D, h0 = ins = scan_inputs(torch, dev, gen, 4, 256, di, ds)
    k = wrappers[MAMBA]
    cut = lambda lo, hi, *ts: [t[:, lo:hi].contiguous() for t in ts]
    y, hT = k(*ins)
    ya, ha = k(*cut(0, 128, dt, x, Bm, Cm), A, D, h0)
    yb, hb = k(*cut(128, 256, dt, x, Bm, Cm), A, D, ha)
    split = torch.equal(torch.cat([ya, yb], 1), y) and torch.equal(hb, hT)
    tail = dt.clone()
    tail[:, -7:] = 0.0
    _, h_tail = k(tail, x, Bm, Cm, A, D, h0)
    _, h_before = k(*cut(0, 249, tail, x, Bm, Cm), A, D, h0)
    identity = torch.equal(h_tail, h_before)
    again = [k(*ins) for _ in range(3)]
    repeat = all(torch.equal(a, y) and torch.equal(h, hT) for a, h in again)
    bf = [t.bfloat16() for t in (dt, x, Bm, Cm)]
    yb16, hb16 = k(*bf, A, D, h0)
    y32, h32 = k(*(t.float() for t in bf), A, D, h0)
    widened = torch.equal(yb16, y32) and torch.equal(hb16, h32)
    out = dict(split_128_128=split, dt0_tail_identity=identity, three_launches=repeat,
               bf16_equals_widened_f32=widened)
    # the engine mixes 4-row micro-steps with batch-1 chunks: a row of a
    # 4-row launch gives the bits of a 1-row launch of that row
    for S in (1, 128):
        dt, x, Bm, Cm, A, D, h0 = scan_inputs(torch, dev, gen, 4, S, di, ds)
        dt, x, Bm, Cm = (t.bfloat16() for t in (dt, x, Bm, Cm))
        y, hT = k(dt, x, Bm, Cm, A, D, h0)
        one = [k(*(t[r:r + 1].contiguous() for t in (dt, x, Bm, Cm)), A, D,
                 h0[r:r + 1].contiguous()) for r in range(4)]
        out[f"batch_rows_4x{S}"] = all(torch.equal(y[r:r + 1], a) and torch.equal(hT[r:r + 1], h)
                                       for r, (a, h) in enumerate(one))
    # a launch of one token runs 4 lanes a channel, a longer one 2: 8 tokens
    # one launch at a time, carried through hT, against one launch of 8
    dt, x, Bm, Cm, A, D, h0 = scan_inputs(torch, dev, gen, 4, 8, di, ds)
    dt, x, Bm, Cm = (t.bfloat16() for t in (dt, x, Bm, Cm))
    y, hT = k(dt, x, Bm, Cm, A, D, h0)
    h, ys = h0, []
    for t in range(8):
        yt, h = k(*(u[:, t:t + 1].contiguous() for u in (dt, x, Bm, Cm)), A, D, h)
        ys.append(yt)
    out["token_by_token_4x8"] = torch.equal(torch.cat(ys, 1), y) and torch.equal(h, hT)
    log(f"[mamba-kernels] {MAMBA} bit for bit: " + ", ".join(f"{a} {v}" for a, v in out.items()))
    if not all(out.values()):
        raise AssertionError(f"{MAMBA}: not bit for bit: {out}")
    return out


def mamba_build(torch, dev, lm, get_config):
    """jamba kernel-q3 (MAMBA_FFN) in bf16 from SEED on the card.  Returns
    (cfg, params, {bytes held, card free, setup s})."""
    cfg = get_config(MAMBA_ARCH, "kernel-q3", ffn_pattern=MAMBA_FFN, n_layers=MAMBA_DEPTH)
    t0 = time.perf_counter()
    params = lm.prepack_params(
        lm.init_params(torch.Generator(device=dev).manual_seed(SEED), cfg, dev), cfg)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info()
    held = torch.cuda.memory_allocated()
    log(f"[mamba] {MAMBA_ARCH} kernel-q3 bf16 at {cfg.n_layers} layers, ffn {MAMBA_FFN[:2]} x 4: "
        f"parameters and all else allocated {held / 2**30:.2f} GiB ({held} bytes), card free "
        f"{free / 2**30:.2f} of {total / 2**30:.2f} GiB; init+prepack {setup_s:.1f} s")
    if free < MAMBA_WORKSPACE:
        raise AssertionError(f"{MAMBA_ARCH}: {free} bytes free beside the parameters, the phase "
                             f"needs {MAMBA_WORKSPACE}")
    return cfg, params, dict(n_layers=cfg.n_layers, bytes=held, free=free, total=total,
                             setup_s=setup_s)


def mamba_refusal(torch, dev, ops) -> str:
    """backward() through the scan on the card raises NotImplementedError
    naming the ROADMAP item of the scan's gradient."""
    from repro_torch.kernels.mamba_scan import GRAD_ITEM
    gen = torch.Generator(device=dev).manual_seed(SEED)
    dt, x, Bm, Cm, A, D, h0 = scan_inputs(torch, dev, gen, 1, 8, 64, 16)
    x.requires_grad_(True)
    y, _ = ops.mamba_scan(dt, x, Bm, Cm, A, D, h0)
    try:
        y.sum().backward()
    except NotImplementedError as e:
        if GRAD_ITEM not in str(e):
            raise AssertionError(f"{MAMBA}: the refusal does not name {GRAD_ITEM}: {e}")
        log(f"[mamba-cpu] backward() through the scan on the card refuses: {e}")
        return str(e)
    raise AssertionError(f"{MAMBA}: backward() on the card did not raise")


def mamba_phase(torch, dev, gen, ops, ref, wrappers, lm, serve, get_config, launch_counts,
                reset_launch_counts):
    """Phase 14: (a) the scan kernel at jamba's width (scan_rows,
    scan_bits); (b) jamba kernel-q3 at MAMBA_DEPTH (mamba_build): generate 4
    x 256 + 32 with exact launches, three prefills bit for bit, timed and
    profiled, the scan's share of busy; kernel #1 at its specs and rows;
    (c) the engine on the same weights (engine_path: chunks across the
    scan's windows, K = 1 and reverse order bit for bit, one-shot), with
    the scan and kernel #1 at the engine's rows; (d) card against CPU in
    float32: jamba's widths at 2 Mamba layers with the dense FFN, 2 x 64
    tokens, and the jamba smoke config (16 layers, MoE and attention) with
    the router's experts equal; backward() refuses on the card.  Returns
    (kernel rows, report)."""
    import dataclasses
    import gc
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch import engine as engine_mod
    from repro_torch.models import moe
    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    _RETAG.update({"[lm]": "[mamba]", "[lm-kernels]": "[mamba-kernels]", "[lm-cpu]": "[mamba-cpu]",
                   "[profile] lm": "[profile] mamba", "[engine]": "[mamba-engine]",
                   "[engine-cpu]": "[mamba-cpu]"})
    cfg = get_config(MAMBA_ARCH, "kernel-q3", ffn_pattern=MAMBA_FFN)
    new = LM_NEW
    # (a) the kernel alone at jamba's width: the generate's prefill and
    # decode shapes counted, the rest checked and timed
    rows = scan_rows(torch, dev, gen, ref, wrappers, cfg, MAMBA_ARCH, [
        (LM_REQUESTS, LM_PROMPT, torch.bfloat16, "zero", MAMBA_LAYERS),
        (LM_REQUESTS, LM_PROMPT, torch.bfloat16, "random", 0),
        (LM_REQUESTS, LM_PROMPT, torch.float32, "zero", 0),
        (LM_REQUESTS, LM_PROMPT, torch.float32, "random", 0),
        (LM_REQUESTS, 250, torch.bfloat16, "random", 0),
        (LM_REQUESTS, 1, torch.bfloat16, "random", MAMBA_LAYERS * (new - 1)),
        (1, 1, torch.bfloat16, "random", 0)])
    bits = scan_bits(torch, dev, gen, wrappers, cfg)
    from repro_torch.kernels import _build
    ptxas = scan_ptxas(_build.build_log)
    torch.cuda.empty_cache()
    # (b) the model at MAMBA_DEPTH layers
    cfg, params, built = mamba_build(torch, dev, lm, get_config)
    sites = sum(site_specs(lm, cfg).values()) * cfg.n_groups
    mamba_layers = sum(k == "mamba" for k, _ in cfg.full_pattern) * cfg.n_groups
    if (sites, mamba_layers) != (MAMBA_SITES, MAMBA_LAYERS):
        raise AssertionError(f"{MAMBA_ARCH}: {sites} epitomized projections and {mamba_layers} "
                             f"Mamba layers, expected {MAMBA_SITES} and {MAMBA_LAYERS}")
    run = lm_path(torch, dev, lm, serve, cfg, "kernel-q3",
                  {QUANT: MAMBA_SITES * new, MAMBA: MAMBA_LAYERS * new},
                  launch_counts, reset_launch_counts, built=(params, built["setup_s"]))
    share = {}
    for label in ("prefill", "decode"):
        busy = run[f"{label}_busy_ms"]
        prof = run[f"{label}_device_breakdown"]
        scan = sum(ms for name, ms, _ in prof if "mamba_scan" in name)
        k1 = sum(ms for name, ms, _ in prof if "epim_mma::" in name)
        share[label] = dict(busy_ms=busy, scan_ms=scan, kernel1_ms=k1)
        log(f"[mamba] {label}: device busy {busy:.3f} ms; the scan {scan:.3f} ms "
            f"({100 * scan / max(busy, 1e-9):.1f} % of busy), kernel #1 {k1:.3f} ms "
            f"({100 * k1 / max(busy, 1e-9):.1f} %)")
    run.update(depth=built, scan_share=share)
    torch.cuda.empty_cache()
    # (c) the engine on the same weights
    eng_run = engine_path(torch, dev, lm, serve, engine_mod, get_config, MAMBA_ARCH, 16, 0,
                          MAMBA_SITES, MAMBA_ONESHOT, launch_counts, reset_launch_counts,
                          built=(cfg, params), micro=MAMBA_MICRO, f32=True)
    if eng_run["stats"]["prefill_chunks"] != MAMBA_CHUNKS or eng_run["geometry"]["chunk"] != 128:
        raise AssertionError(f"{MAMBA_ARCH} engine: {eng_run['stats']['prefill_chunks']} chunks "
                             f"of {eng_run['geometry']['chunk']}, the schedule makes "
                             f"{MAMBA_CHUNKS} of 128")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    # kernel #1 at the generate's and the engine's rows (bf16, the path's)
    bf16_only = ((torch.bfloat16, BF16_TOL),)
    rows += quant_lm_rows(torch, dev, gen, ops, ref, wrappers, lm, cfg, MAMBA_ARCH,
                          ((LM_REQUESTS * LM_PROMPT, 1), (LM_REQUESTS, new - 1)), LM_REQUESTS,
                          dtypes=bf16_only)
    rows += quant_lm_rows(torch, dev, gen, ops, ref, wrappers, lm, cfg,
                          f"{MAMBA_ARCH} engine", sorted(eng_run["forwards_by_rows"].items()),
                          ENGINE_CAPACITY, dtypes=bf16_only)
    # the engine's scans: batch-1 prefills (bucket, chunk; h0 the carried
    # state, zero for a whole prompt), capacity-row decode
    cases = [(1, T, torch.bfloat16, "random", MAMBA_LAYERS * n)
             for T, n in sorted(eng_run["forwards_by_rows"].items()) if T != ENGINE_CAPACITY]
    cases.append((ENGINE_CAPACITY, 1, torch.bfloat16, "random",
                  MAMBA_LAYERS * eng_run["forwards_by_rows"][ENGINE_CAPACITY]))
    rows += scan_rows(torch, dev, gen, ref, wrappers, cfg, f"{MAMBA_ARCH} engine", cases)
    torch.cuda.empty_cache()
    # (d) card against CPU in float32
    wide = lm_card_vs_cpu(torch, dev, lm, get_config, MAMBA_ARCH, "kernel-q3", prompt_len=64,
                          batch=2, pattern=("mamba",), ffn_pattern=("dense",))
    smoke = dataclasses.replace(get_smoke_config(MAMBA_ARCH, "kernel-q3"),
                                compute_dtype="float32")
    with route_recorder(torch, moe) as rr:
        small = lm_card_vs_cpu(torch, dev, lm, get_config, MAMBA_ARCH, "kernel-q3",
                               prompt_len=64, batch=2, cfg=smoke)
    n = len(rr.seen) // 2
    if 2 * n != len(rr.seen) or not n or not all(
            torch.equal(a, b) for (_, a, _), (_, b, _) in zip(rr.seen[:n], rr.seen[n:])):
        raise AssertionError(f"{MAMBA_ARCH} smoke: the router picks other experts on the card "
                             f"than on the CPU")
    gap = min(g for _, _, g in rr.seen[:n])
    log(f"[mamba-cpu] {MAMBA_ARCH} smoke float32 {smoke.n_layers} layers: the router's experts "
        f"equal on the card and the CPU over {n} routings; smallest top-k gap {gap:.3e}")
    refusal = mamba_refusal(torch, dev, ops)
    seconds = time.perf_counter() - t_phase
    _RETAG.clear()
    log(f"[mamba] phase 14 {seconds:.1f} s")
    return rows, dict(lm=run, engine=eng_run, bits=bits, ptxas=ptxas,
                      card_vs_cpu=dict(wide=wide, smoke=small, router_min_gap=gap),
                      refusal=refusal, seconds=seconds)


QM_SHAPES = ((4096, 4096), (4096, 14336), (14336, 4096))   # rwkv6-7b's projections
QM_ROWS = (LM_REQUESTS * LM_PROMPT, LM_REQUESTS)             # prefill and decode rows
# the phase's weights at the scale of a model's layer, std about 1/sqrt(M) as
# the LM rows draw E (randn / sqrt(M)): a code std of 73.6 times a mean scale
# of 5.5e-3, divided by this times sqrt(M)
QM_CODE_STD = 73.6 * 5.5e-3


def quant_matmul_phase(torch, dev, gen, ops, ref, wrappers, launch_counts,
                       reset_launch_counts) -> tuple:
    """Kernel #5's path, ``ops.quant_matmul``, at rwkv6-7b's three dense
    projection shapes in float32 and bf16, at prefill and decode rows, and
    one ragged T = 7 with leading dims, with weights at a layer's scale
    (QM_CODE_STD): each call must launch the kernel once and nothing else,
    and agree with the plain version on the same inputs; then the kernel
    is timed beside its plain version, the yardstick (cuBLAS float32, TF32
    off, on the pre-dequantized weight) and the bound.  Returns the rows
    and the float64 check of ``quant_matmul_vs_f64``."""
    from repro_torch.core.quant import dequantize_packed
    cases = [(M, N, (T,), dt) for M, N in QM_SHAPES for T in QM_ROWS
             for dt in (torch.float32, torch.bfloat16)]
    cases += [(4096, 4096, (1, 7), dt) for dt in (torch.float32, torch.bfloat16)]
    rows, weights = [], {}
    for M, N, lead, dtype in cases:
        if (M, N) not in weights:
            weights.clear()
            torch.cuda.empty_cache()
            q, s, z = _codes(torch, dev, gen, M, N, QM_CODE_STD * math.sqrt(M))
            W = dequantize_packed(q, s, z, (256, 256))                    # (q + z) * s
            weights[(M, N)] = (q, s, z, W)
        q, s, z, W = weights[(M, N)]
        x = torch.randn(*lead, M, device=dev, generator=gen).to(dtype)
        reset_launch_counts()
        y = ops.quant_matmul(x, q, s, z)
        torch.cuda.synchronize()
        counts = launch_counts()
        expect = {k: int(k == "quant_matmul") for k in counts}
        if counts != expect:
            raise AssertionError(f"ops.quant_matmul: launches {counts}, expected {expect}")
        dname = str(dtype).replace("torch.", "")
        T = x.numel() // M
        if tuple(y.shape) != (*lead, N) or y.dtype != dtype:
            raise AssertionError(f"quant_matmul: {tuple(y.shape)} {y.dtype} out")
        tol = KERNEL_TOL if dtype == torch.float32 else BF16_TOL
        err = max_err(torch, y, ref.quant_matmul_ref(x, q, s, z), tol,
                      f"quant_matmul {dname} ({M},{N}) x{tuple(x.shape)}")
        xp = x.reshape(-1, M).contiguous()     # what ops hands the kernel
        xf = xp.float()
        row = timed_row(torch, "quant_matmul",
                        lambda: wrappers["quant_matmul"](xp, q, s, z),
                        lambda: ref.quant_matmul_ref(xp, q, s, z),
                        lambda: torch.matmul(xf, W),
                        *_cost().quant_matmul_work(T, M, N, s.numel(), x.element_size()))
        row.update(M=M, N=N, T=T, x_shape=list(x.shape), dtype=dname, max_abs_err=err,
                   path="quant_matmul", count=1)
        if dtype == torch.bfloat16:   # the bf16 yardstick: bf16 x, bf16 weight
            Wb = W.bfloat16()
            row["library_bf16_ms"] = graph_ms(torch, lambda: torch.matmul(xp, Wb))
            del Wb
        rows.append(row)
        log(f"[quant_matmul] {dname} ({M},{N}) x{tuple(x.shape)}: launches 1, "
            f"max_err={err:.2e} ms={row['ms']:.4f} (eager {row['ms_eager']:.4f}) "
            f"plain_ms={row['plain_ms']:.4f} library_ms={row['library_ms']:.4f} "
            f"library_bf16_ms={_ms(row.get('library_bf16_ms'), 4)} bound_ms={row['bound_ms']:.4f} "
            f"({row['bound_by']}) bound_fp32_ms={row['bound_fp32_ms']:.4f} "
            f"bound_tc_ms={row['bound_tc_ms']:.4f}")
    return rows, quant_matmul_vs_f64(torch, dev, gen, ref, wrappers)


def _codes(torch, dev, gen, M, N, s_div):
    """int8 codes over the whole range, zeros round(U(-3, 3)) and scales
    U(1e-3, 1e-2) / s_div per 256 x 256 tile, as tests/test_kernels.py:101-104
    draws them for s_div = 1."""
    q = torch.randint(-127, 128, (M, N), device=dev, generator=gen, dtype=torch.int8)
    s = (torch.rand(M // 256, N // 256, device=dev, generator=gen) * 9e-3 + 1e-3) / s_div
    z = torch.round(torch.rand(M // 256, N // 256, device=dev, generator=gen) * 6 - 3)
    return q, s, z


def quant_matmul_vs_f64(torch, dev, gen, ref, wrappers) -> list:
    """Kernel #5 and its plain version, each against the float64 product of
    the same float32 inputs, at the reference test's code scales (s_div = 1,
    outputs up to ~240) in float32, at each of rwkv6-7b's projection shapes
    and at prefill and decode rows.  Gated: every element of the kernel
    within the reference's tolerance of the float64 product, and the
    kernel's largest error no larger than the plain version's (cuBLAS), so
    that its fp32 sum order is held to the library's accuracy.  These are
    comparison launches and count for no path."""
    from repro_torch.core.quant import dequantize_packed
    out = []
    for M, N in QM_SHAPES:
        torch.cuda.empty_cache()
        q, s, z = _codes(torch, dev, gen, M, N, 1.0)
        W64 = dequantize_packed(q, s, z, (256, 256)).double()
        for T in QM_ROWS:
            x = torch.randn(T, M, device=dev, generator=gen)
            y, plain = wrappers["quant_matmul"](x, q, s, z), ref.quant_matmul_ref(x, q, s, z)
            exact = x.double() @ W64
            what = f"quant_matmul float32 ({M},{N}) T={T} against float64"
            kernel_err = max_err(torch, y, exact, KERNEL_TOL, what)
            plain_err = float((plain.double() - exact).abs().max())
            row = dict(M=M, N=N, T=T, max_abs_ref=float(exact.abs().max()),
                       kernel_vs_f64=kernel_err, plain_vs_f64=plain_err,
                       ratio=kernel_err / plain_err,
                       kernel_rms_vs_f64=float((y.double() - exact).pow(2).mean().sqrt()),
                       plain_rms_vs_f64=float((plain.double() - exact).pow(2).mean().sqrt()),
                       kernel_vs_plain=float((y - plain).abs().max()))
            log(f"[quant_matmul] {what} (max|y| {row['max_abs_ref']:.1f}): max error "
                f"kernel {kernel_err:.3e}, plain {plain_err:.3e} (ratio {row['ratio']:.3f}); "
                f"rms kernel {row['kernel_rms_vs_f64']:.3e}, plain "
                f"{row['plain_rms_vs_f64']:.3e}; kernel vs plain {row['kernel_vs_plain']:.3e}")
            if kernel_err > plain_err:
                raise AssertionError(f"{what}: the kernel's max error {kernel_err:.3e} "
                                     f"exceeds the plain version's {plain_err:.3e}")
            out.append(row)
        del q, s, z, W64
    return out


def plan_phase(torch, dev, gen, ops, ref, wrappers, get_resnet, images, small,
               launch_counts, reset_launch_counts) -> tuple:
    """A searched plan drives the ResNet path: ``get_resnet("resnet50",
    "evo-latency-q3")`` (Algorithm-1 search, legalized), its plan saved
    under build/ and reloaded with ``plan=``, which must give identical
    per-layer configs; every kernel shape of the plan checked against its
    plain version and timed; then the batch-32 forward with one launch of
    kernel #1 per epitomized layer, and the same plan with a tuned_blocks
    provenance that folds inside the kernel on every epitomized layer
    (kernel #2 only)."""
    import dataclasses
    from repro_torch.configs.registry import _evo_variant
    from repro_torch.core.quant import QuantConfig
    t0 = time.perf_counter()
    searched = get_resnet("resnet50", "evo-latency-q3", device="cpu")
    plan = _evo_variant("resnet50", "evo-latency-q3")
    search_s = time.perf_counter() - t0
    out = ROOT / "build"
    out.mkdir(exist_ok=True)
    path = out / "plan_resnet50_evo-latency-q3.json"
    plan.save(str(path))
    reloaded = get_resnet("resnet50", plan=str(path), device="cpu")
    if reloaded.cfgs != searched.cfgs or reloaded.specs != searched.specs:
        raise AssertionError("the reloaded plan builds other per-layer configs")
    n_ep = plan.n_epitomized
    if n_ep != 38 or plan.uniform_mode() != "kernel" or set(plan.bits()) != {3}:
        raise AssertionError(f"evo-latency-q3: {n_ep} epitomized layers, mode "
                             f"{plan.uniform_mode()}, bits {set(plan.bits())}")
    shapes = {}
    for l, spec in zip(searched.layers, searched.specs):
        if spec is not None:
            T = BATCH * (l.out_hw ** 2 if l.kind == "conv" else 1)
            shapes.setdefault((spec, T), []).append(l.name)
    # the same plan, folding inside the kernel on every epitomized layer:
    # the heuristic blocks, written as a tuner would write them
    tuned = {}
    for (spec, T), names in shapes.items():
        bk, bn = ops.pack_blocks(spec, QuantConfig(bits=3))
        for n in names:
            tuned[n] = {"bt": ops._pick_bt(T), "bk": bk, "bn": bn, "fused_fold": True}
    fused_plan = dataclasses.replace(plan, provenance={**plan.provenance,
                                                        "tuned_blocks": tuned})
    fused_path = out / "plan_resnet50_evo-latency-q3_fused_fold.json"
    fused_plan.save(str(fused_path))
    log(f"[plan] resnet50 evo-latency-q3: searched and legalized in {search_s:.2f} s; "
        f"{n_ep} epitomized of {len(plan.layers)} layers in {len(shapes)} kernel shapes, "
        f"snap error max {plan.snap_err_max:.3f}; best_curve "
        f"{plan.provenance['best_curve'][0]:.4f} -> {plan.provenance['best_curve'][-1]:.4f}; "
        f"predicted {plan.predicted['latency_s'] * 1e3:.3f} ms / "
        f"{plan.predicted['energy_j'] * 1e3:.3f} mJ / {plan.predicted['xbars']} XBs; "
        f"saved {path.relative_to(ROOT)}, reloaded with identical per-layer configs")
    rows = []
    for (spec, T), names in shapes.items():
        for r in check_and_time(torch, dev, gen, ops, ref, wrappers, spec, T,
                                names=(QUANT, "quant_epitome_matmul_fused_fold")):
            r.update(layers=names, count=len(names), path="resnet50 evo-latency-q3")
            rows.append(r)
            log(f"[plan-kernels] {r['kernel']} ({spec.M},{spec.N})->({spec.m},{spec.n}) "
                f"bm={spec.bm} bn={spec.bn} T={T} bk={r['pack_bk']} x{len(names)}: "
                f"max_err={r['max_abs_err']:.2e} ms={r['ms']:.4f} "
                f"plain_ms={r['plain_ms']:.4f} library_ms={r['library_ms']:.4f} "
                f"bound_ms={r['bound_ms']:.4f} ({r['bound_by']}) "
                f"bound_fp32_ms={r['bound_fp32_ms']:.4f} "
                f"bound_tc_ms={_ms(r['bound_tc_ms'], 4)}" + _fold_note(r))
        torch.cuda.empty_cache()
    forwards = [
        resnet_forward(torch, "evo-latency-q3",
                       lambda device: get_resnet("resnet50", plan=str(path), device=device),
                       QUANT, n_ep, images, small, launch_counts, reset_launch_counts),
        resnet_forward(torch, "evo-latency-q3+fused_fold",
                       lambda device: get_resnet("resnet50", plan=str(fused_path),
                                                 device=device),
                       "quant_epitome_matmul_fused_fold", n_ep, images, small,
                       launch_counts, reset_launch_counts)]
    info = dict(search_s=search_s, n_epitomized=n_ep, n_layers=len(plan.layers),
                kernel_shapes=len(shapes), snap_err_max=plan.snap_err_max,
                predicted=plan.predicted, best_curve=plan.provenance["best_curve"],
                plan_path=str(path.relative_to(ROOT)))
    return rows, dict(plan=info, forwards=forwards)


def check_and_time(torch, dev, gen, ops, ref, wrappers, spec, T, names=None):
    """The three kernels (or those in ``names``) at one main-path shape:
    each against its plain version on the same inputs, then timed beside its
    plain version and the yardstick, with the least time the card could
    take."""
    from repro_torch.core.quant import QuantConfig, dequantize_packed
    E = torch.randn(spec.m, spec.n, device=dev, generator=gen) / math.sqrt(spec.M)
    x = torch.randn(T, spec.M, device=dev, generator=gen)
    p = ops.pack_epitome(E, spec, QuantConfig(bits=3))
    bn = spec.bn
    tables = ops.spec_tables(spec, bn, x.device)
    cb, ro, fold = tables.col_blocks, tables.row_offsets, tables.fold
    # operands as ops.quant_epitome_matmul / ops.epitome_matmul hand them over
    q = p.q
    folded = ops.fold_rows(x, spec)
    ffold, fE = ops._pad_contraction(ops.fold_rows(x, spec), E, ops._pick_bk(spec.m))
    # the yardstick: one torch.matmul of the folded activation with the
    # pre-expanded (dequantized) weight; the port never calls it
    cols = torch.cat([torch.arange(c * bn, (c + 1) * bn, device=dev)
                      for c in ops.kernel_col_blocks(spec, bn).tolist()])
    W_q = dequantize_packed(q, p.scales, p.zeros, (p.bk, bn))[:, cols].contiguous()
    W_f = fE[:, cols].contiguous()
    gn = len(cb)
    calls = {
        "quant_epitome_matmul_blocks": (
            lambda: wrappers["quant_epitome_matmul_blocks"](
                folded, q, p.scales, p.zeros, cb, bk=p.bk, bn=bn),
            lambda: ref.quant_epitome_matmul_blocks_ref(
                folded, q, p.scales, p.zeros, cb, p.bk, bn),
            lambda: torch.matmul(folded, W_q)),
        "quant_epitome_matmul_fused_fold": (
            lambda: wrappers["quant_epitome_matmul_fused_fold"](
                x, q, p.scales, p.zeros, cb, ro, bm=spec.bm, bk=p.bk, bn=bn, fold=fold),
            lambda: ref.quant_epitome_matmul_fused_fold_ref(
                x, q, p.scales, p.zeros, cb, ro, bm=spec.bm, bk=p.bk, bn=bn),
            lambda: torch.matmul(folded, W_q)),
        "epitome_matmul_blocks": (
            lambda: wrappers["epitome_matmul_blocks"](ffold, fE, cb, bn=bn),
            lambda: ref.epitome_matmul_blocks_ref(ffold, fE, cb, bn),
            lambda: torch.matmul(ffold, W_f)),
    }
    # the bound: each input read once and the output written once, against
    # the FMAs of the contraction (the fused fold adds one add per input)
    c, (m, n), d = _cost(), q.shape, distinct_blocks(cb)
    work = {"quant_epitome_matmul_blocks": c.quant_epitome_work(
                T, m, n, gn, bn, d, p.scales.numel(), 4),
            "quant_epitome_matmul_fused_fold": c.fused_fold_work(
                T, spec.M, m, n, gn, bn, d, p.scales.numel(), len(ro)),
            "epitome_matmul_blocks": c.epitome_work(T, ffold.shape[1], fE.shape[1], gn, bn, d, 4)}
    rows = []
    for name, (kernel, plain, library) in calls.items():
        if names is not None and name not in names:
            continue
        err = max_err(torch, kernel(), plain(), KERNEL_TOL, f"{name} {spec} T={T}")
        row = timed_row(torch, name, kernel, plain, library, *work[name])
        row.update(M=spec.M, N=spec.N, m=spec.m, n=spec.n, bm=spec.bm, bn=bn, T=T,
                   pack_bk=p.bk, max_abs_err=err)
        if name == QUANT:   # the fold that kernel #2 takes inside: ops.fold_rows
            row["fold_ms"] = graph_ms(torch, lambda: ops.fold_rows(x, spec))
        rows.append(row)
    return rows


# -- phase 16: sharded serving -----------------------------------------------------
def _mesh_plan(arch: str, out: Path):
    """``arch``'s plan: searched (MESH_EVO), legalized for a (1, 1) mesh,
    every layer carrying a placement; saved to ``out``."""
    from repro_torch.pim.evo import EvoConfig
    from repro_torch.pim.plan import legalize_plan, search_plan
    plan = legalize_plan(search_plan(arch, objective="latency", weight_bits=3, act_bits=9,
                                     evo=EvoConfig(**MESH_EVO)),
                         mesh_shape={"data": 1, "model": 1})
    if not all(lp.placement is not None for lp in plan.layers):
        raise AssertionError(f"{arch}: a legalized layer carries no placement")
    if plan.provenance.get("placement_fallbacks"):
        raise AssertionError(f"{arch}: placement fallbacks on a (1, 1) mesh "
                             f"{plan.provenance['placement_fallbacks']}")
    plan.save(str(out))
    return plan


def mesh_phase(torch, dev, gen, ops, ref, wrappers, lm, serve, get_config, launch_counts,
               reset_launch_counts, lm_rows, engine_rows, engine_run):
    """Phase 16: sharded serving on a (1, 1) NCCL mesh (one card shows no
    traffic between ranks: what it shows is that the mesh path runs the
    same kernels on the same operands).  (a) rwkv6-7b from a searched,
    legalized plan: generate and the timed prefill and decode steps
    without a mesh, then with the packed tree laid out by placement on the
    mesh (``lm.shard_params``; the state by ``lm.state_specs``): logits
    and tokens bit for bit, launches equal; (b) ``plan run --mesh 1,1`` on
    the smoke plan as a subprocess, its two ``bit-identical=True`` lines;
    (c) ``EngineConfig(mesh="1,1")`` (``prepack_params(mesh=)``) serving
    phase 10's requests at K = 4, tokens and launches equal to phase 10's.
    Returns (kernel rows of the mesh runs, report)."""
    from repro_torch.core.layers import Sharded
    from repro_torch.launch import engine as engine_mod
    from repro_torch.launch import mesh as tmesh
    from repro_torch.models.common import set_mesh
    from repro_torch.train.tree import leaves
    t_phase = time.perf_counter()
    smoke_path = ROOT / "build" / "plan_rwkv6-7b-smoke_mesh.json"
    torch.cuda.reset_peak_memory_stats()
    plan, cfg, params, setup_s = _mesh_model(torch, dev, lm, get_config)
    _mesh_plan(f"{LM_ARCH}-smoke", smoke_path)
    per_fwd = sum(site_specs(lm, cfg).values()) * cfg.n_groups
    expect = {QUANT: per_fwd * LM_NEW, WKV: cfg.n_layers}
    report = dict(plan_specs={lp.name: str(lp.spec) for lp in plan.layers},
                  placements={lp.name: str(lp.placement) for lp in plan.layers})
    one_keep, sh_keep = {}, {}
    one = lm_path(torch, dev, lm, serve, cfg, "plan, no mesh", expect, launch_counts,
                  reset_launch_counts, built=(params, setup_s), keep=one_keep, profile=False)
    try:
        mesh = tmesh.mesh_for_plan(plan, 1, 1, dev)
        backend = torch.distributed.get_backend()
        if backend != "nccl":
            raise AssertionError(f"the card's mesh runs over {backend}, not NCCL")
        set_mesh(mesh)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        sharded = lm.shard_params(params, cfg, mesh)
        layout_s = time.perf_counter() - t0
        laid = [v for v in leaves(sharded["groups"]) if isinstance(v, Sharded)]
        codes = sum(1 for g in sharded["groups"] for k, v in _named_leaves(g)
                    if k.endswith("/Eq") and isinstance(v, Sharded))
        if codes != per_fwd:
            raise AssertionError(f"{codes} int8 code leaves laid out, expected {per_fwd}")
        sh = lm_path(torch, dev, lm, serve, cfg, "plan, mesh 1,1", expect, launch_counts,
                     reset_launch_counts, built=(sharded, layout_s), keep=sh_keep, profile=False)
        logits_ok = torch.equal(one_keep["logits"], sh_keep["logits"])
        toks_ok = torch.equal(one_keep["tokens"], sh_keep["tokens"])
        if not (logits_ok and toks_ok and one["launches"] == sh["launches"]):
            raise AssertionError(f"mesh 1,1 drifted from no mesh: logits {logits_ok}, tokens "
                                 f"{toks_ok}, launches {sh['launches']} vs {one['launches']}")
        log(f"[mesh] {LM_ARCH} plan ({', '.join(sorted(set(report['plan_specs'].values())))}) on "
            f"{tmesh.describe(mesh)}: {len(laid)} leaves laid out ({codes} int8 code leaves, "
            f"whole on the one rank); logits bit-identical={logits_ok} tokens "
            f"bit-identical={toks_ok}; launches {sh['launches']} (no mesh {one['launches']})")
        for label, run in (("no mesh", one), ("mesh 1,1", sh)):
            log(f"[mesh] {label}: prefill {run['prefill_ms_median']:.2f} ms, decode step "
                f"{run['decode_ms_median']:.2f} ms ({run['decode_tok_s']:.1f} tok/s), host "
                f"returns after {statistics.median(run['decode_host_ms']):.2f} ms, peak "
                f"{run['peak_bytes'] / 2**30:.2f} GiB; {card_line()}")
        turns = _in_turns(torch, dev, lm, cfg, {"no mesh": (params, None),
                                                 "mesh 1,1": (sharded, mesh)}, MESH_TURNS)
        log(f"[mesh] in turns ({MESH_TURNS} rounds after a warm-up, the order alternating): "
            + "; ".join(f"{k}: prefill {turns[k]['prefill']['median']:.2f} ms, decode step "
                        f"{turns[k]['decode']['median']:.2f} ms" for k in ("no mesh", "mesh 1,1"))
            + f"; mesh faster in {turns['faster_rounds']} rounds; {card_line()}")
        del params, sharded
        import gc
        gc.collect()
        torch.cuda.empty_cache()

        # (b) the plan CLI's own sharded-vs-one-rank check, in its own process
        t0 = time.perf_counter()
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            filter(None, [str(ROOT / "src"), os.environ.get("PYTHONPATH")])))
        cli = subprocess.run([sys.executable, "-m", "repro_torch.launch.plan", "run", "--plan",
                              str(smoke_path), "--mesh", "1,1", "--device", "cuda"],
                             capture_output=True, text=True, timeout=300, env=env, cwd=ROOT)
        cli_s = time.perf_counter() - t0
        for line in cli.stdout.splitlines():
            log(f"[mesh-cli] {line}")
        if cli.returncode != 0 or "logits bit-identical=True" not in cli.stdout \
                or "tokens bit-identical=True" not in cli.stdout:
            raise AssertionError(f"plan run --mesh 1,1 (rc {cli.returncode}): "
                                 f"{cli.stdout[-2000:]} {cli.stderr[-4000:]}")

        # (c) the engine on the mesh: phase 10's requests, tokens and launches
        t0 = time.perf_counter()
        eng = engine_mod.EngineConfig(
            arch=LM_ARCH, epitome="kernel-q3", mesh="1,1", decode_block=ENGINE_BLOCK, seed=SEED,
            capacity=ENGINE_CAPACITY, max_len=ENGINE_MAX_LEN, page_size=0, kv_pages=0,
            prefill_chunk=ENGINE_CHUNK).build()
        eng_setup_s = time.perf_counter() - t0
        if not isinstance(eng.serve_params["groups"][0]["L0"]["mixer"]["wr"]["Eq"], Sharded):
            raise AssertionError("EngineConfig(mesh='1,1') left the codes unlaid")
        reqs = engine_requests(torch, engine_mod.Request, eng.cfg.vocab)
        drive = engine_drive(torch, eng, reqs, range(len(reqs)), launch_counts,
                             reset_launch_counts, 8 * eng.cfg.n_layers)
        greedy = range(len(ENGINE_PROMPTS))
        diff = [i for i in range(len(reqs)) if drive["tokens"][i] != engine_run["tokens"][i]]
        if any(i in greedy for i in diff) or drive["launches"] != engine_run["launches"]:
            raise AssertionError(f"engine on mesh 1,1: requests {diff} differ from phase 10's, "
                                 f"launches {drive['launches']} vs {engine_run['launches']}")
        log(f"[mesh-engine] {LM_ARCH} kernel-q3 EngineConfig(mesh='1,1'): {len(reqs)} requests "
            f"in {drive['wall_s']:.2f} s ({drive['tok_s']:.1f} tok/s; phase 10 "
            f"{engine_run['wall_s']:.2f} s), build {eng_setup_s:.1f} s; tokens equal to phase "
            f"10's for {len(reqs) - len(diff)}/{len(reqs)} requests (every greedy one), "
            f"launches {drive['launches']} equal")
        del eng
    finally:
        tmesh.destroy_world()
    if torch.distributed.is_initialized():
        raise AssertionError("the phase left its process group up")
    torch.cuda.empty_cache()

    # kernel rows: #1 at the plan's specs and the generate's rows; #4 and the
    # engine's rows as phases 5 and 10 timed them (the same shapes and dtype)
    rows = quant_lm_rows(torch, dev, gen, ops, ref, wrappers, lm, cfg, MESH_PATH,
                         ((LM_REQUESTS * LM_PROMPT, 1), (LM_REQUESTS, LM_NEW - 1)), LM_REQUESTS,
                         dtypes=((torch.bfloat16, BF16_TOL),))
    wkv = next(r for r in lm_rows if r["kernel"] == WKV and r["count"])
    rows.append(dict(wkv, path=MESH_PATH))
    rows += [dict(r, path=f"{LM_ARCH} engine mesh 1,1") for r in engine_rows
             if r["path"] == f"{LM_ARCH} engine" and r["count"]]
    seconds = time.perf_counter() - t_phase
    report.update(lm=sh, lm_no_mesh=one, in_turns=turns, cli_s=cli_s, cli_stdout=cli.stdout,
                  engine=dict(wall_s=drive["wall_s"], tok_s=drive["tok_s"],
                              launches=drive["launches"], setup_s=eng_setup_s,
                              requests_equal=len(reqs) - len(diff)),
                  launches={k: sh["launches"][k] + drive["launches"][k] for k in (QUANT, WKV)},
                  seconds=seconds)
    log(f"[mesh] phase 16 {seconds:.1f} s (plan run subprocess {cli_s:.1f} s)")
    return rows, report


# -- phase 17: training on a mesh ---------------------------------------------------
class _ShapeRecorder:
    """Stands in for a kernel wrapper ``fn`` under its module's name: each
    call appends (r's (B, S, H, K), its dtype) to ``seen`` and calls
    ``fn``; ``launches`` reads and writes ``fn``'s, so the wrapper's own
    count (which it bumps through that name) is unchanged."""

    def __init__(self, fn):
        self.fn, self.seen = fn, []

    def __call__(self, r, *args, **kw):
        self.seen.append((tuple(r.shape), str(r.dtype).replace("torch.", "")))
        return self.fn(r, *args, **kw)

    launches = property(lambda self: self.fn.launches,
                        lambda self, n: setattr(self.fn, "launches", n))


def wkv_launch_shapes(run) -> tuple:
    """Runs ``run()`` with the WKV wrappers' names in ``kernels.wkv6``
    (those the autograd function calls) standing in by ``_ShapeRecorder``s.
    Returns (what ``run()`` returned, {kernel: the (shape, dtype) of each
    call})."""
    from repro_torch.kernels import wkv6 as mod
    names = {WKV: "wkv6_chunked", WKV_BWD: "wkv6_chunked_bwd"}
    recorders = {k: _ShapeRecorder(getattr(mod, n)) for k, n in names.items()}
    try:
        for k, n in names.items():
            setattr(mod, n, recorders[k])
        result = run()
    finally:
        for k, n in names.items():
            setattr(mod, n, recorders[k].fn)
    return result, {k: rec.seen for k, rec in recorders.items()}


def mesh_train_phase(torch, dev, lm, get_config, launch_counts, reset_launch_counts,
                     train_report, train_rows) -> tuple:
    """Phase 17: training on a (1, 1) NCCL mesh.  (a) phase 13 (c)'s model
    and batch laid out by ``init_state(mesh=)``: the warm-up step against
    phase 13's checksums, then MESH_TRAIN_STEPS steps through
    ``train_loop`` (counted, timed, peak); (b) ``mesh_train_restart``;
    (c) ``mesh_train_cli``.  Returns (the kernel rows of (a)'s steps,
    report)."""
    import gc
    from repro_torch.core.layers import Sharded
    from repro_torch.launch import mesh as tmesh
    from repro_torch.models.common import set_mesh
    from repro_torch.train import loop, optimizer
    from repro_torch.train.data import SyntheticData
    from repro_torch.train.tree import leaves
    t_phase = time.perf_counter()
    cfg = get_config(TRAIN_ARCH, TRAIN_VARIANT)
    opt, tcfg = optimizer.AdamWConfig(), loop.TrainConfig(checkpoint_every=10 ** 9, log_every=1)
    data = SyntheticData(vocab=cfg.vocab, seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH, seed=SEED)
    per_step = {WKV: 2 * cfg.n_layers, WKV_BWD: cfg.n_layers}
    what = f"{TRAIN_ARCH} {TRAIN_VARIANT} on the (1, 1) mesh"
    one = train_report["run"]
    try:
        mesh = tmesh.make_host_mesh(1, 1, dev)
        if torch.distributed.get_backend() != "nccl":
            raise AssertionError(f"the card's mesh runs over "
                                 f"{torch.distributed.get_backend()}, not NCCL")
        set_mesh(mesh)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        state = loop.init_state(torch.Generator(device=dev).manual_seed(SEED), cfg, opt, tcfg,
                                dev, mesh=mesh)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        laid = sum(isinstance(t, Sharded) for t in leaves(state))
        split = sum(isinstance(t, Sharded) and t.is_split() for t in leaves(state))
        if not laid or split:
            raise AssertionError(f"{what}: {laid} leaves laid out, {split} split")
        batch0 = {k: v.to(dev) for k, v in data.batch(0).items()}
        t0 = time.perf_counter()
        state, loss0, gsum0, ssum0, gn0 = train_first_step(
            torch, loop, leaves, cfg, opt, state, batch0, launch_counts, reset_launch_counts)
        warm_s = time.perf_counter() - t0
        same = dict(loss=loss0 == one["warmup"]["loss"], grads=gsum0 == one["warmup"]["grads"],
                    state=ssum0 == one["warmup"]["state"], grad_norm=gn0 == one["grad_norm0"])
        if not all(same.values()):
            raise AssertionError(f"{what}: the warm-up step differs from phase 13's: {same} "
                                 f"(loss {loss0} vs {one['warmup']['loss']})")
        step_fn = loop.make_train_step(cfg, opt, tcfg)
        reset_launch_counts()
        (state, hist), shapes = wkv_launch_shapes(lambda: loop.train_loop(
            state, step_fn, data, 1 + MESH_TRAIN_STEPS, train_cfg=tcfg,
            log=lambda line: log(f"[mesh-train] {line}")))
        counts = launch_counts()
        expect = {k: v * MESH_TRAIN_STEPS for k, v in per_step.items()}
        if counts != {k: expect.get(k, 0) for k in counts}:
            raise AssertionError(f"{what}: {MESH_TRAIN_STEPS} steps launched {counts}, "
                                 f"expected {expect}")
        # the rows below reuse phase 13's per-launch times: every launch of
        # this run must have the shape and dtype phase 13 timed
        train_path = f"{TRAIN_ARCH} {TRAIN_VARIANT} train"
        timed = {r["kernel"]: ((r["B"], r["S"], r["H"], r["K"]), r["dtype"])
                 for r in train_rows if r["count"] and r["path"] == train_path}
        for k, seen in shapes.items():
            if len(seen) != counts[k] or set(seen) != {timed.get(k)}:
                raise AssertionError(f"{what}: {k}'s {counts[k]} launches had shapes "
                                     f"{sorted(set(seen))} ({len(seen)} recorded), phase 13 "
                                     f"timed {timed.get(k)}")
        if len(hist["loss"]) != MESH_TRAIN_STEPS or not all(
                math.isfinite(x) and x > 0 for x in hist["loss"]):
            raise AssertionError(f"{what}: losses {hist['loss']}")
        step_ms = statistics.median(hist["step_time"]) * 1e3
        peak = torch.cuda.max_memory_allocated()
        del state, batch0
        gc.collect()
        torch.cuda.empty_cache()
        log(f"[mesh-train] {what} ({tmesh.describe(mesh)}), {TRAIN_BATCH}x{TRAIN_SEQ}: {laid} "
            f"state leaves laid out, none split; init {init_s:.1f} s, warm-up step {warm_s:.1f} "
            f"s: loss {loss0:.6f}, {len(gsum0)} gradient leaves, the new state's "
            f"{len(ssum0)} leaves and the grad norm {gn0:.6f} bit for bit equal to phase 13's "
            f"warm-up step; {MESH_TRAIN_STEPS} steps through train_loop: median "
            f"{step_ms:.1f} ms (runs {', '.join(f'{x * 1e3:.1f}' for x in hist['step_time'])}; "
            f"phase 13 {one['step_ms_median']:.1f}), losses "
            f"{', '.join(f'{x:.4f}' for x in hist['loss'])}, launches {counts}, each at "
            f"phase 13's timed shape ({timed}); peak "
            f"{peak / 2**30:.2f} GiB (phase 13 {one['peak_bytes'] / 2**30:.2f}); {card_line()}")
        # (c) the CLI's two processes (most of their time is start-up on the
        # host) run one after the other beside (b)
        import threading
        cli = {}

        def run_cli():
            try:
                cli.update(mesh_train_cli())
            except BaseException as e:          # raised below, in this thread
                cli["error"] = f"launch.train under torchrun: {e!r}"
        cli_thread = threading.Thread(target=run_cli)
        cli_thread.start()
        try:
            restart = mesh_train_restart(torch, dev, get_config, loop, optimizer, SyntheticData,
                                         leaves, mesh)
        finally:
            cli_thread.join()
    finally:
        tmesh.destroy_world()
    if torch.distributed.is_initialized():
        raise AssertionError("the phase left its process group up")
    for steps, out in zip(MESH_CLI_STEPS, cli.get("stdout", [])):
        for line in out.splitlines():
            log(f"[mesh-train-cli] --steps {steps}: {line}")
    if cli.get("error") or "seconds" not in cli:
        raise AssertionError(cli.get("error", "launch.train under torchrun did not report"))
    rows = [dict(r, path=MESH_TRAIN_PATH, count=per_step[r["kernel"]] * MESH_TRAIN_STEPS,
                 timing="phase 13's per-launch times at the shape each launch had")
            for r in train_rows if r["count"] and r["path"] == train_path]
    if sorted(r["kernel"] for r in rows) != sorted(per_step):
        raise AssertionError(f"phase 13's counted rows are {[r['kernel'] for r in rows]}")
    seconds = time.perf_counter() - t_phase
    log(f"[mesh-train] phase 17 {seconds:.1f} s (CLI runs {cli['seconds']:.1f} s beside the "
        f"restart's {restart['seconds']:.1f} s)")
    return rows, dict(init_s=init_s, warmup_s=warm_s, loss0=loss0, grad_norm0=gn0,
                      leaves_laid=laid, equal_to_phase_13=same, losses=hist["loss"],
                      step_ms=[x * 1e3 for x in hist["step_time"]], step_ms_median=step_ms,
                      step_ms_median_phase_13=one["step_ms_median"], peak_bytes=peak,
                      peak_bytes_phase_13=one["peak_bytes"], launches=counts,
                      restart=restart, cli=cli, seconds=seconds)


def mesh_train_restart(torch, dev, get_config, loop, optimizer, SyntheticData, leaves,
                       mesh) -> dict:
    """Phase 17 (b): phase 13 (d) on the mesh.  rwkv6-7b folded-q3 at
    CPU_LAYERS layers laid out on ``mesh``: steps 0-1 with an async
    checkpoint at step 2, steps 2-3 on; the checkpoint restored with
    ``shardings=loop.state_specs`` into a fresh state on the mesh, and
    into a fresh state on one card with no mesh: each takes steps 2-3 to
    the straight run's losses and final state bit for bit."""
    import shutil
    from repro_torch.core.layers import unshard
    t_start = time.perf_counter()
    from repro_torch.models.common import set_mesh
    from repro_torch.train.checkpoint import CheckpointManager
    cfg = get_config(TRAIN_ARCH, TRAIN_VARIANT, n_layers=CPU_LAYERS)
    opt, tcfg = optimizer.AdamWConfig(), loop.TrainConfig(checkpoint_every=2, log_every=10)
    data = SyntheticData(cfg.vocab, TRAIN_CPU_SEQ, TRAIN_CPU_BATCH, seed=SEED)
    step_fn = loop.make_train_step(cfg, opt, tcfg)
    directory = ROOT / "build" / "train_mesh_ckpt"
    shutil.rmtree(directory, ignore_errors=True)
    ckpt = CheckpointManager(str(directory), keep=1)
    quiet = lambda *a: None
    whole = lambda st: _checksum(torch, [unshard(t) for t in leaves(st)])
    fresh = lambda m: loop.init_state(torch.Generator(device=dev).manual_seed(SEED + 1), cfg,
                                      opt, tcfg, dev, mesh=m)
    state = loop.init_state(torch.Generator(device=dev).manual_seed(SEED), cfg, opt, tcfg, dev,
                            mesh=mesh)
    t0 = time.perf_counter()
    state, first = loop.train_loop(state, step_fn, data, 2, ckpt=ckpt, train_cfg=tcfg, log=quiet)
    save_s = time.perf_counter() - t0
    state, rest = loop.train_loop(state, step_fn, data, 4, train_cfg=tcfg, log=quiet)
    straight = whole(state)
    del state
    torch.cuda.empty_cache()
    out = {}
    for label, m in (("mesh 1,1", mesh), ("one card, no mesh", None)):
        set_mesh(m)
        target = fresh(m)
        t0 = time.perf_counter()
        step, restored = ckpt.restore(target, shardings=None if m is None
                                      else loop.state_specs(cfg, target))
        restore_s = time.perf_counter() - t0
        del target
        restored, again = loop.train_loop(restored, step_fn, data, 4, train_cfg=tcfg, log=quiet)
        if step != 2 or again["loss"] != rest["loss"] or whole(restored) != straight:
            raise AssertionError(f"{TRAIN_ARCH}: the run restored at step {step} on {label} "
                                 f"differs: losses {again['loss']} vs {rest['loss']}")
        out[label] = dict(restore_s=restore_s, losses=again["loss"])
        del restored
        torch.cuda.empty_cache()
    set_mesh(mesh)
    ckpt_bytes = sum(p.stat().st_size for p in directory.rglob("*") if p.is_file())
    shutil.rmtree(directory, ignore_errors=True)
    log(f"[mesh-train-restart] {TRAIN_ARCH} {TRAIN_VARIANT} {CPU_LAYERS} layers on the mesh, "
        f"{TRAIN_CPU_BATCH}x{TRAIN_CPU_SEQ}: async checkpoint at step 2 ({ckpt_bytes / 2**30:.2f} "
        f"GiB; steps 0-1 and the write {save_s:.1f} s), restored with shardings= on the mesh "
        f"({out['mesh 1,1']['restore_s']:.1f} s) and on one card with no mesh "
        f"({out['one card, no mesh']['restore_s']:.1f} s): steps 2-3 losses "
        f"{', '.join(f'{x:.6f}' for x in rest['loss'])} and the final state bit for bit "
        f"the straight mesh run's, both")
    return dict(losses=first["loss"] + rest["loss"], checkpoint_bytes=ckpt_bytes,
                save_s=save_s, restored=out, seconds=time.perf_counter() - t_start)


def mesh_train_cli() -> dict:
    """Phase 17 (c): ``launch.train`` under ``torchrun --standalone
    --nproc-per-node 1`` (NCCL) at the rwkv6-7b smoke config, folded-q3:
    MESH_CLI_STEPS[0] steps with a checkpoint directory, which prints the
    mesh it ran and ``done``; then MESH_CLI_STEPS[1], which restores the
    checkpoint of step MESH_CLI_STEPS[0] (one every max(10, steps // 5)).
    Returns (seconds, each run's stdout, and what failed, if anything);
    it logs nothing, for it runs beside (b)."""
    import shutil
    directory = ROOT / "build" / "train_cli_ckpt"
    shutil.rmtree(directory, ignore_errors=True)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        filter(None, [str(ROOT / "src"), os.environ.get("PYTHONPATH")])))
    t0 = time.perf_counter()
    outs = []
    for steps in MESH_CLI_STEPS:
        run = subprocess.run(
            [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node",
             "1", "-m", "repro_torch.launch.train", "--arch", TRAIN_ARCH, "--smoke", "--epitome",
             TRAIN_VARIANT, "--steps", str(steps), "--ckpt-dir", str(directory)],
            capture_output=True, text=True, timeout=300, env=env, cwd=ROOT)
        outs.append(run.stdout)
        if run.returncode != 0:
            return dict(seconds=time.perf_counter() - t0, stdout=outs, error=(
                f"launch.train --steps {steps} under torchrun (rc {run.returncode}): "
                f"{run.stdout[-2000:]} {run.stderr[-4000:]}"))
    shutil.rmtree(directory, ignore_errors=True)
    mesh_line = "[train] mesh: {'data': 1, 'model': 1} over 1 rank(s) (nccl, cuda)"
    want = f"[train] restored checkpoint at step {MESH_CLI_STEPS[0]}"
    error = None
    if not all(mesh_line in o and "[train] done" in o for o in outs) or want not in outs[1]:
        error = f"launch.train under torchrun: no mesh line, done line or '{want}'"
    return dict(seconds=time.perf_counter() - t0, stdout=outs, error=error)


def _in_turns(torch, dev, lm, cfg, trees, rounds: int) -> dict:
    """Phase 5's prefill and one decode step of each of ``trees`` ({label:
    (params, mesh or None)}), in turns for ``rounds`` rounds after one
    unrecorded warm-up round, the order reversed every other round: per
    label the median, the quartiles and every run (ms, device-synchronised,
    and when the host returned), and per metric the rounds in which the
    last label was faster than the first."""
    prompts = torch.randint(0, cfg.vocab, (LM_REQUESTS, LM_PROMPT), device=dev,
                            generator=torch.Generator(device=dev).manual_seed(SEED + 1))
    metrics = ("prefill", "prefill_host", "decode", "decode_host")
    runs = {k: {m: [] for m in metrics} for k in trees}
    with torch.no_grad():
        for i in range(rounds + 1):
            for name in (list(trees) if i % 2 == 0 else list(trees)[::-1]):
                params, mesh = trees[name]
                state = lm.init_decode_state(cfg, LM_REQUESTS, LM_PROMPT + LM_NEW + 1, dev,
                                             mesh=mesh)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                logits, state = lm.prefill(params, prompts, state, cfg)
                host = time.perf_counter()
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                tok = torch.argmax(logits[:, -1], -1).to(torch.int32)[:, None]
                torch.cuda.synchronize()
                t2 = time.perf_counter()
                lm.decode_step(params, state, tok, LM_PROMPT, cfg)
                host2 = time.perf_counter()
                torch.cuda.synchronize()
                t3 = time.perf_counter()
                if i:
                    for m, v in zip(metrics, (t1 - t0, host - t0, t3 - t2, host2 - t2)):
                        runs[name][m].append(1e3 * v)
    first, last = list(trees)
    out = {k: {m: dict(median=statistics.median(v), quartiles=statistics.quantiles(v, n=4),
                       runs=v) for m, v in r.items()} for k, r in runs.items()}
    out["faster_rounds"] = {m: sum(b < a for a, b in zip(runs[first][m], runs[last][m]))
                            for m in ("prefill", "decode")}
    return out


def _mesh_model(torch, dev, lm, get_config):
    """Phase 16's plan (searched and legalized for a (1, 1) mesh) and
    rwkv6-7b at it, prepacked: (plan, cfg, params, seconds of init and
    prepack)."""
    out_dir = ROOT / "build"
    out_dir.mkdir(exist_ok=True)
    plan = _mesh_plan(LM_ARCH, out_dir / "plan_rwkv6-7b_mesh.json")
    cfg = get_config(LM_ARCH, "off", plan=plan)
    t0 = time.perf_counter()
    params = lm.prepack_params(lm.init_params(torch.Generator(device=dev).manual_seed(SEED),
                                              cfg, dev), cfg)
    torch.cuda.synchronize()
    return plan, cfg, params, time.perf_counter() - t0


def time_mesh() -> int:
    """``python3 chip_smoke.py --time-mesh``: phase 16's rwkv6-7b without a
    mesh and laid out on a (1, 1) NCCL mesh, prefill and one decode step
    each in turns for MESH_AB_ROUNDS rounds (``_in_turns``).  One JSON line
    with the card line."""
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card is visible", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.launch import mesh as tmesh
    from repro_torch.models import lm
    from repro_torch.models.common import set_mesh
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.build_all()
    dev = torch.device("cuda")
    plan, cfg, params, _ = _mesh_model(torch, dev, lm, get_config)
    try:
        mesh = tmesh.mesh_for_plan(plan, 1, 1, dev)
        set_mesh(mesh)
        turns = _in_turns(torch, dev, lm, cfg, {"no mesh": (params, None), "mesh 1,1": (
            lm.shard_params(params, cfg, mesh), mesh)}, MESH_AB_ROUNDS)
    finally:
        tmesh.destroy_world()
    print(json.dumps(dict(card=card_line(), rounds=MESH_AB_ROUNDS, **turns)))
    return 0


def _named_leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _named_leaves(v, f"{prefix}/{k}")
    else:
        yield prefix, tree



# -- phase 18: the dry run against the card ------------------------------------------
_CHILDREN = []          # processes this script started, ended at exit


def _end_children():
    for proc in _CHILDREN:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def dryrun_calls() -> list:
    """Phase 18 (b)'s cells, ``launch/dryrun.py``'s ``run_cell`` keywords:
    phase 13's training step (its config, AdamW and TrainConfig, TRAIN_BATCH
    x TRAIN_SEQ) and phase 5's prefill (LM_REQUESTS x LM_PROMPT) and decode
    step (against its state of prompt + new + 1 rows), each on a fake
    (1, 1) world, the full-depth trace and the 1- and 2-group probes."""
    from repro_torch.configs import ShapeCell
    from repro_torch.launch import dryrun
    from repro_torch.train.loop import TrainConfig
    from repro_torch.train.optimizer import AdamWConfig
    one = dict(mesh_shape=[1, 1])
    return [dryrun.encode_call(arch=TRAIN_ARCH, epitome=TRAIN_VARIANT, opt_cfg=AdamWConfig(),
                               train_cfg=TrainConfig(checkpoint_every=10 ** 9, log_every=1),
                               shape=ShapeCell("phase13_train", TRAIN_SEQ, TRAIN_BATCH, "train"),
                               **one),
            dryrun.encode_call(arch=LM_ARCH, epitome="kernel-q3",
                               shape=ShapeCell("phase5_prefill", LM_PROMPT, LM_REQUESTS,
                                               "prefill"), **one),
            dryrun.encode_call(arch=LM_ARCH, epitome="kernel-q3",
                               shape=ShapeCell("phase5_decode", LM_PROMPT + LM_NEW + 1,
                                               LM_REQUESTS, "decode"), **one)]


def start_dryrun():
    """Start phase 18 (b)'s dry run in a subprocess on the host (one thread,
    at a lower priority, beside the card's phases); returns (process, start
    time).  It reads no device: its tensors are fake."""
    from repro_torch.launch import dryrun
    env = dict(os.environ, PYTHONPATH=dryrun.src_path(), OMP_NUM_THREADS="1")
    proc = subprocess.Popen(dryrun.subprocess_command(dryrun_calls()), stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env=env,
                            preexec_fn=lambda: os.nice(10))
    _CHILDREN.append(proc)
    return proc, time.perf_counter()


def row_check(torch, dev, gen, ops, ref, wrappers, launch_counts, reset_launch_counts):
    """Phase 18 (a): kernel #1 through ``ops.quant_epitome_matmul`` at each
    of ROW_SPECS, bf16: every row of a T-row call against the same row of
    a 1-row call, bit for bit, for each T of ROW_T.  The decode loop (T <=
    DECODE_ROWS) must sum a row as at one row; past it the tensor-core loop
    sums in another order, by design, and its differing rows are reported.
    Each shape's launches are then checked against the plain version and
    timed (their kernels rows).  Returns (rows, report)."""
    from repro_torch.core.epitome import EpitomeSpec
    from repro_torch.core.quant import QuantConfig, dequantize_packed
    from repro_torch.kernels.quant_epitome_matmul import DECODE_ROWS
    rows, differ, launches = [], {}, 0
    n_max = max(ROW_T)
    for arch, args in ROW_SPECS:
        spec = EpitomeSpec(*args)
        E = torch.randn(spec.m, spec.n, device=dev, generator=gen) / math.sqrt(spec.M)
        p = ops.pack_epitome(E, spec, QuantConfig(bits=3))
        x = torch.randn(n_max, spec.M, device=dev, generator=gen).bfloat16()
        reset_launch_counts()
        ones = torch.cat([ops.quant_epitome_matmul(x[i:i + 1], None, spec, packed=p)
                          for i in range(n_max)])
        key = f"{arch} ({spec.M},{spec.N})->({spec.m},{spec.n})"
        differ[key] = {}
        for T in ROW_T:
            y = ops.quant_epitome_matmul(x[:T], None, spec, packed=p)
            bad = int((y != ones[:T]).any(-1).sum())
            if bad:
                differ[key][T] = bad
        torch.cuda.synchronize()
        got = launch_counts()[QUANT]
        if got != n_max + len(ROW_T):
            raise AssertionError(f"[row-check] {key}: {got} launches of {QUANT}, expected "
                                 f"{n_max + len(ROW_T)}")
        launches += got
        log(f"[row-check] {key} bf16: rows of T-row calls against 1-row calls differ at "
            f"T = {dict(differ[key]) or 'none'} (rows differing)")
        # the launches' shapes, each against its plain version and timed
        cb = ops.spec_tables(spec, p.bn, dev).col_blocks
        gn = len(cb)
        cols = torch.cat([torch.arange(c * p.bn, (c + 1) * p.bn, device=dev)
                          for c in ops.kernel_col_blocks(spec, p.bn).tolist()])
        W = dequantize_packed(p.q, p.scales, p.zeros, (p.bk, p.bn))[:, cols].contiguous()
        for T in ROW_T:
            folded = ops.fold_rows(x[:T], spec)
            f32 = folded.float()
            kernel = lambda: wrappers[QUANT](folded, p.q, p.scales, p.zeros, cb, bk=p.bk, bn=p.bn)
            plain = lambda: ref.quant_epitome_matmul_blocks_ref(folded, p.q, p.scales, p.zeros,
                                                                 cb, p.bk, p.bn)
            err = max_err(torch, kernel(), plain(), BF16_TOL, f"[row-check] {key} T={T}")
            row = timed_row(torch, QUANT, kernel, plain, lambda: torch.matmul(f32, W),
                            *_cost().quant_epitome_work(T, spec.m, spec.n, gn, p.bn,
                                                        distinct_blocks(cb),
                                                        p.scales.numel(), 2))
            row.update(M=spec.M, N=spec.N, m=spec.m, n=spec.n, bn=p.bn, T=T, pack_bk=p.bk,
                       dtype="bfloat16", max_abs_err=err, path="row check",
                       count=1 + (n_max if T == 1 else 0))
            rows.append(row)
        del E, p, x, ones, W
        torch.cuda.empty_cache()
    late = {k: {T: n for T, n in v.items() if T <= DECODE_ROWS} for k, v in differ.items()}
    if any(late.values()):
        raise AssertionError(f"[row-check] kernel #1's decode loop sums a row by the row "
                             f"count: {late}")
    log(f"[row-check] every row at T <= {DECODE_ROWS} equals its 1-row call bit for bit "
        f"({launches} launches); past it the tensor-core loop's rows differ by design at "
        + "; ".join(f"{k}: T = {sorted(v)}" for k, v in differ.items() if v))
    return rows, dict(differ=differ, launches=launches)


def dryrun_phase(torch, dev, gen, ops, ref, wrappers, launch_counts, reset_launch_counts,
                 dry, lm_run, train_run) -> tuple:
    """Phase 18.  (a) ``row_check``.  (b) The dry run started after the
    build (``start_dryrun``): for phase 13's step and phase 5's prefill and
    decode step, its kernels' launches a step equal the launches the phase
    counted, exactly; its argument bytes are within ARG_TOL of how much
    ``torch.cuda.memory_allocated`` grew while the phase built what the
    step takes in (phase 13's training state; phase 5's prepacked
    parameters, plus the decode state for the decode step); its roofline's
    bound and each of its three terms are at most the step's device-busy
    time (``torch.profiler``): a bound above a measurement is a count that
    is wrong; its useful ratio is at most 1 and its roofline fraction at
    most SHARE_MAX (a share past either is an impossible reading); its
    probes' counts are within PROBE_TOL of the full trace's.  Printed, not
    gated: the predicted peak against the measured one, busy over the
    bound, the reference's MODEL_FLOPS over the counted FLOPs, the dry
    run's seconds.  Returns (kernel rows, report)."""
    t_phase = time.perf_counter()
    rows, checked = row_check(torch, dev, gen, ops, ref, wrappers, launch_counts,
                              reset_launch_counts)
    proc, t_start = dry
    out, err = proc.communicate(timeout=DRYRUN_TIMEOUT)
    if proc.returncode != 0:
        raise AssertionError(f"[dryrun] the dry run failed ({proc.returncode}): "
                             f"{err[-3000:]}")
    results = [json.loads(line) for line in out.strip().splitlines()]
    per_step = {k: v // TRAIN_STEPS for k, v in train_run["launches"].items() if v}
    real = (("phase 13 train step", train_run["state_alloc_bytes"], per_step,
             train_run["device_busy_ms"], train_run["peak_bytes"]),
            ("phase 5 prefill", lm_run["params_alloc_bytes"], lm_run["prefill_launches"],
             lm_run["prefill_busy_ms"], lm_run["peak_bytes"]),
            ("phase 5 decode step", lm_run["params_alloc_bytes"] + lm_run["state_alloc_bytes"],
             lm_run["decode_launches"], lm_run["decode_busy_ms"], lm_run["peak_bytes"]))
    report = dict(row_check=checked, cells=[])
    for r, (what, alloc, launched, busy_ms, peak) in zip(results, real):
        predicted = {k: v["launches"] for k, v in r["kernels"].items()}
        args = r["per_device"]["argument_bytes"]
        rl = r["roofline"]
        terms = {k: rl[k] for k in ("bound_s", "t_compute_s", "t_memory_s", "t_collective_s")}
        dense_ratio = rl["model_flops"] / (r["per_device"]["flops"] * r["n_chips"])
        probes = r["probe_vs_trace"]
        cell = dict(what=what, launches_predicted=predicted, launches_measured=launched,
                    argument_bytes=args, allocated_bytes=alloc, busy_ms=busy_ms,
                    peak_predicted=r["per_device"]["peak_bytes"], peak_measured=peak,
                    trace_s=r["trace_s"], probe_s=r["probe_s"], probe_vs_trace=probes,
                    model_flops_ratio=dense_ratio, roofline=rl, kernels=r["kernels"])
        report["cells"].append(cell)
        log(f"[dryrun] {what}: launches a step {predicted} (counted on the card {launched}); "
            f"arguments {args / 2**30:.3f} GiB (the card allocated {alloc / 2**30:.3f}); "
            f"bound {rl['bound_s'] * 1e3:.3f} ms ({rl['dominant']}: compute "
            f"{rl['t_compute_s'] * 1e3:.3f}, memory {rl['t_memory_s'] * 1e3:.3f}, collective "
            f"{rl['t_collective_s'] * 1e3:.3f}) against {busy_ms:.3f} ms busy "
            f"({busy_ms / 1e3 / rl['bound_s']:.1f}x); peak {cell['peak_predicted'] / 2**30:.2f} "
            f"GiB predicted, {peak / 2**30:.2f} measured; useful {rl['useful_ratio']:.4f} "
            f"(the reference's MODEL_FLOPS {dense_ratio:.4f}), roofline fraction "
            f"{rl['roofline_fraction']:.4f}; probes / trace {probes}; traced in "
            f"{r['trace_s']:.1f} s, probes {sum(r['probe_s']):.1f} s (torch {r['torch']}); "
            f"{card_line()}")
        if predicted != launched:
            raise AssertionError(f"[dryrun] {what}: the dry run counts {predicted} launches a "
                                 f"step, the card launched {launched}")
        if abs(args - alloc) > ARG_TOL * alloc:
            raise AssertionError(f"[dryrun] {what}: {args} argument bytes predicted, the card "
                                 f"allocated {alloc} (past {ARG_TOL:.0%})")
        over = {k: v for k, v in terms.items() if v * 1e3 > busy_ms}
        if over or busy_ms <= 0:
            raise AssertionError(f"[dryrun] {what}: roofline terms {over} (s) above the "
                                 f"measured {busy_ms} ms busy")
        if not (0 < rl["useful_ratio"] <= 1 and 0 < rl["roofline_fraction"] <= SHARE_MAX):
            raise AssertionError(f"[dryrun] {what}: useful ratio {rl['useful_ratio']} and "
                                 f"roofline fraction {rl['roofline_fraction']}: a share past "
                                 f"1 (or {SHARE_MAX}) is an impossible reading")
        off = {k: v for k, v in probes.items() if v is not None and abs(v - 1) > PROBE_TOL}
        if off:
            raise AssertionError(f"[dryrun] {what}: the probes' counts over the full trace's "
                                 f"{off}, past {PROBE_TOL}")
    report["dryrun_wall_s"] = time.perf_counter() - t_start
    report["seconds"] = time.perf_counter() - t_phase
    log(f"[dryrun] phase 18 {report['seconds']:.1f} s (the dry run's subprocess "
        f"{report['dryrun_wall_s']:.1f} s from its start after the build; its traces "
        f"{sum(c['trace_s'] for c in report['cells']):.1f} s)")
    return rows, report


def time_decode(tree: str) -> int:
    """``python3 chip_smoke.py --time-decode TREE``: kernel #1 of the port
    in checkout TREE at ROW_SPECS, bf16, T in DECODE_TIMED_T: device ms a
    launch (graph_ms, three readings) and the split its wrapper picks, as
    one JSON line.  To compare two checkouts' decode loops, run it for each
    in turn in one chip call (A, B, B, A)."""
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card is visible", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(tree).resolve() / "src"))
    from repro_torch.core.epitome import EpitomeSpec
    from repro_torch.core.quant import QuantConfig
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels.quant_epitome_matmul import (quant_epitome_matmul_blocks,
                                                          split_rows)
    _build.library("quant_epitome_matmul_bf16")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    out = dict(tree=tree, card=card_line(), shapes=[])
    for arch, args in ROW_SPECS:
        spec = EpitomeSpec(*args)
        E = torch.randn(spec.m, spec.n, device=dev, generator=gen) / math.sqrt(spec.M)
        p = ops.pack_epitome(E, spec, QuantConfig(bits=3))
        cb = ops.spec_tables(spec, p.bn, dev).col_blocks
        for T in DECODE_TIMED_T:
            folded = ops.fold_rows(torch.randn(T, spec.M, device=dev, generator=gen).bfloat16(),
                                   spec)
            kernel = lambda: quant_epitome_matmul_blocks(folded, p.q, p.scales, p.zeros, cb,
                                                         bk=p.bk, bn=p.bn)
            out["shapes"].append(dict(arch=arch, spec=list(args), T=T,
                                      split=split_rows(T, spec.m, len(cb), p.bn),
                                      ms=[graph_ms(torch, kernel) for _ in range(3)]))
        del E, p
    print(json.dumps(out))
    return 0


def time_lm_host(tree: str) -> int:
    """``python3 chip_smoke.py --time-lm-host TREE``: phase 5's rwkv6-7b at
    kernel-q3 from the port in checkout TREE, one prefill of LM_REQUESTS x
    LM_PROMPT, then a warm-up decode step and LM_HOST_STEPS timed ones:
    each step's host ms (until ``lm.decode_step`` returns) and wall ms
    (until the card is done), as one JSON line.  To compare two checkouts'
    host paths, run it for each in turn in one chip call (A, B, B, A)."""
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card is visible", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(tree).resolve() / "src"))
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.models import lm
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.build_all()
    dev = torch.device("cuda")
    cfg = get_config(LM_ARCH, "kernel-q3")
    params = lm.prepack_params(
        lm.init_params(torch.Generator(device=dev).manual_seed(SEED), cfg, dev), cfg)
    prompts = torch.randint(0, cfg.vocab, (LM_REQUESTS, LM_PROMPT), device=dev,
                            generator=torch.Generator(device=dev).manual_seed(SEED + 1))
    host, wall = [], []
    with torch.no_grad():
        state = lm.init_decode_state(cfg, LM_REQUESTS, LM_PROMPT + LM_HOST_STEPS + 2, dev)
        logits, state = lm.prefill(params, prompts, state, cfg)
        for i in range(LM_HOST_STEPS + 1):
            tok = torch.argmax(logits[:, -1], -1).to(torch.int32)[:, None]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, state = lm.decode_step(params, state, tok, LM_PROMPT + i, cfg)
            t_host = time.perf_counter() - t0
            torch.cuda.synchronize()
            if i:                                   # step 0 warms up
                host.append(1e3 * t_host)
                wall.append(1e3 * (time.perf_counter() - t0))
        finite(torch, logits, f"{LM_ARCH} decode logits")
    print(json.dumps(dict(tree=tree, card=card_line(), steps=LM_HOST_STEPS,
                          host_ms=host, wall_ms=wall, host_ms_median=statistics.median(host),
                          wall_ms_median=statistics.median(wall))))
    return 0


# -- phase 15: tuning and measured cost --------------------------------------------
FUSED = "quant_epitome_matmul_fused_fold"
TUNE_EVO = dict(population=16, iterations=8, seed=0)
TUNE_REPEATS = 5


def _source_free(plan_json: str) -> str:
    """A measured plan's JSON with each layer cost's ``source`` (timed, memo
    or cache: where the number came from) left out."""
    d = json.loads(plan_json)
    for layer in d["provenance"]["cost"]["layers"]:
        layer.pop("source")
    return json.dumps(d, sort_keys=True)


def _plan_forward(torch, label, model, images, expect, launch_counts, reset_launch_counts):
    """One batch forward of a plan's ResNet-50 with exact launch counts."""
    with torch.no_grad():
        reset_launch_counts()
        y = model.apply(images)
        torch.cuda.synchronize()
        counts = {k: v for k, v in launch_counts().items() if v}
    if counts != {k: v for k, v in expect.items() if v}:
        raise AssertionError(f"{label}: launches {counts}, expected {expect}")
    if y.shape != (BATCH, 1000) or not torch.isfinite(y).all():
        raise AssertionError(f"{label}: logits {tuple(y.shape)} not finite")
    return y, counts


def tune_phase(torch, dev, get_resnet, images, launch_counts, reset_launch_counts) -> dict:
    """Phase 15: kernel autotuning and measured cost on the card, on phase
    8's evo-latency-q3 plan (see the module docstring)."""
    import shutil
    from repro_torch.configs.registry import _evo_variant
    from repro_torch.kernels import autotune
    from repro_torch.pim.costmodel import measured_cost_for
    from repro_torch.pim.evo import EvoConfig
    from repro_torch.pim.plan import inventory_for, legalize_plan, search_plan
    from repro_torch.pim.simulator import calibrate_tiny_coefficients
    from repro_torch.pim.tables import TINY_CALIBRATION
    t_phase = time.perf_counter()
    root = ROOT / "build" / "tune"
    shutil.rmtree(root, ignore_errors=True)
    out = {"launches": {}}
    plan = _evo_variant("resnet50", "evo-latency-q3")
    n_ep = plan.n_epitomized
    shapes = {}
    for l, lp in zip(inventory_for("resnet50")(), plan.layers):
        if lp.spec is not None:
            T = BATCH * (l.rounds if l.kind == "conv" else 1)
            shapes.setdefault((lp.spec, T), []).append(l.name)

    # (a) the most-launched kernel shape over the default grid
    (spec, T), names = max(shapes.items(), key=lambda kv: len(kv[1]))
    t0 = time.perf_counter()
    res = autotune.tune(spec, 3, T, grid="default", iters=5, cache_dir=str(root / "a"),
                        device=dev)
    one_s = time.perf_counter() - t0
    for c in res.sweep:
        log(f"[tune] ({c['bk']}, {c['bn']}, {'fold' if c['fused_fold'] else 'blocks'}): "
            f"{c['us']:.2f} us bit_identical={c['bit_identical']} "
            f"max_err={c['max_err']:.3e}")
    for why in res.skipped:
        log(f"[tune] skipped, refused before launch: {why}")
    log(f"[tune] ({spec.M},{spec.N})->({spec.m},{spec.n}) bm={spec.bm} bn={spec.bn} T={T} "
        f"x{len(names)}: {len(res.sweep)} candidates in {one_s:.2f} s, winner "
        f"bk={res.blocks[1]} bn={res.blocks[2]} fused_fold={res.fused_fold} "
        f"{res.tuned_us:.2f} us against the heuristic's {res.heuristic_us:.2f} us, "
        f"bit_identical={res.bit_identical} max_err={res.max_err:.3e} source={res.source}")
    if res.source != "timed" or not res.tuned_us <= res.heuristic_us:
        raise AssertionError(f"tune: source {res.source}, {res.tuned_us} us against the "
                             f"heuristic's {res.heuristic_us} us")
    reset_launch_counts()
    again = autotune.tune(spec, 3, T, grid="default", iters=5, cache_dir=str(root / "a"),
                          device=dev)
    torch.cuda.synchronize()
    if again.source != "cache" or again.record() != res.record() or any(launch_counts().values()):
        raise AssertionError(f"tune: the second call's source is {again.source}, launches "
                             f"{launch_counts()}")
    out["one_shape"] = dict(M=spec.M, N=spec.N, m=spec.m, n=spec.n, bm=spec.bm, bn=spec.bn,
                            T=T, layers=names, seconds=one_s, record=res.record(),
                            sweep=list(res.sweep), skipped=list(res.skipped))

    # (b) the plan tuned at batch 32, saved, reloaded and served
    t0 = time.perf_counter()
    tuned = autotune.tune_plan(plan, t=BATCH, grid="tiny", cache_dir=str(root / "b"),
                               device=dev)
    sweep_s = time.perf_counter() - t0
    rec = tuned.provenance["tuned_blocks"]
    bad = {n: r["source"] for n, r in rec.items() if r["source"] not in ("timed", "cache")}
    if len(rec) != n_ep or bad:
        raise AssertionError(f"tune_plan: {len(rec)} records for {n_ep} layers, sources {bad}")
    path = ROOT / "build" / "plan_resnet50_evo-latency-q3_tuned.json"
    tuned.save(str(path))
    fused = sum(1 for r in rec.values() if r["fused_fold"])
    all_ident = all(r["bit_identical"] for r in rec.values())
    gen = lambda: torch.Generator().manual_seed(SEED)
    model_t = get_resnet("resnet50", plan=str(path), device=dev).init(gen()).prepack()
    model_u = get_resnet("resnet50", plan=plan, device=dev).init(gen()).prepack()
    y_t, out["launches"]["tuned"] = _plan_forward(
        torch, "tuned", model_t, images, {QUANT: n_ep - fused, FUSED: fused},
        launch_counts, reset_launch_counts)
    y_u, out["launches"]["untuned"] = _plan_forward(
        torch, "untuned", model_u, images, {QUANT: n_ep}, launch_counts, reset_launch_counts)
    same = bool(torch.equal(y_t, y_u))
    diff = float((y_t - y_u).abs().max())
    if all_ident and not same:
        raise AssertionError(f"every winner is bit-identical, yet the tuned logits differ "
                             f"from the untuned by {diff:.3e}")
    ms_t, ms_u = [], []
    with torch.no_grad():
        for _ in range(TUNE_REPEATS):
            for model, times in ((model_t, ms_t), (model_u, ms_u)):
                t0 = time.perf_counter()
                model.apply(images)
                torch.cuda.synchronize()
                times.append(1e3 * (time.perf_counter() - t0))
    del model_t, model_u, y_t, y_u
    torch.cuda.empty_cache()
    winners = {}
    for r in rec.values():
        k = f"bk={r['bk']} bn={r['bn']}{' fold' if r['fused_fold'] else ''}"
        winners[k] = winners.get(k, 0) + 1
    log(f"[tune-plan] evo-latency-q3 at t={BATCH}: {len(rec)} layers "
        f"({sum(r['source'] == 'timed' for r in rec.values())} timed, the rest from the "
        f"cache) in {sweep_s:.2f} s; {fused} fused-fold winners; every winner "
        f"bit-identical: {all_ident}; winners {winners}; saved "
        f"{path.relative_to(ROOT)}")
    log(f"[tune-plan] b{BATCH} forward: tuned median {statistics.median(ms_t):.2f} ms "
        f"(runs {', '.join(f'{t:.2f}' for t in ms_t)}), untuned median "
        f"{statistics.median(ms_u):.2f} ms (runs {', '.join(f'{t:.2f}' for t in ms_u)}); "
        f"launches {out['launches']['tuned']} against {out['launches']['untuned']}; "
        f"logits equal bit for bit: {same} (max |dy| {diff:.3e})")
    out["plan"] = dict(seconds=sweep_s, layers=len(rec), fused_fold_winners=fused,
                       all_bit_identical=all_ident, winners=winners,
                       logits_equal=same, logits_max_abs_diff=diff,
                       tuned_forward_ms=ms_t, untuned_forward_ms=ms_u,
                       tuned_blocks=rec, plan_path=str(path.relative_to(ROOT)))

    # (c) the measured search, cold then twice from the warm cache
    def measured(label):
        cm = measured_cost_for("resnet50", t=1, cache_dir=str(root / "c"), device=dev)
        t0 = time.perf_counter()
        sp = search_plan("resnet50", objective="latency", weight_bits=3, act_bits=9,
                         evo=EvoConfig(**TUNE_EVO), cost=cm)
        legal = legalize_plan(sp, cost=cm)
        seconds = time.perf_counter() - t0
        gens = sp.provenance["measured_elites"]
        cost = legal.provenance["cost"]
        row = dict(seconds=seconds, timings=cm.timings, lookups=cm.lookups,
                   available=cm.available, generations=len(gens),
                   measured_generations=sum(1 for g in gens if g["measured"]),
                   analytic_ms=cost["analytic_s"] * 1e3,
                   measured_ms=None if cost["measured_s"] is None else cost["measured_s"] * 1e3,
                   n_epitomized=legal.n_epitomized)
        log(f"[measured] {label}: {seconds:.2f} s, {cm.timings} timings for {cm.lookups} "
            f"layer lookups, {row['measured_generations']}/{len(gens)} generations ranked "
            f"by measured latency, available={cm.available}; legalized plan "
            f"{legal.n_epitomized} epitomized layers, analytic {row['analytic_ms']:.3f} ms "
            f"against measured {_ms(row['measured_ms'])} ms (kernels at t=1)")
        if not cm.available or row["measured_ms"] is None:
            raise AssertionError(f"measured search ({label}): the cost model degraded")
        return legal, row

    cold, out["measured_cold"] = measured("cold")
    warm, out["measured_warm"] = measured("warm")
    warm2, out["measured_warm2"] = measured("warm again")
    if out["measured_warm"]["timings"] or out["measured_warm2"]["timings"]:
        raise AssertionError("a search from the warm cache timed kernels")
    if warm.to_json() != warm2.to_json():
        raise AssertionError("two searches from the warm cache wrote different plans")
    if _source_free(cold.to_json()) != _source_free(warm.to_json()):
        raise AssertionError("the warm search's plan differs from the cold one's")
    mpath = ROOT / "build" / "plan_resnet50_measured.json"
    warm.save(str(mpath))
    model = get_resnet("resnet50", plan=str(mpath), device=dev).init(gen()).prepack()
    _, out["launches"]["measured"] = _plan_forward(
        torch, "measured plan", model, images, {QUANT: warm.n_epitomized},
        launch_counts, reset_launch_counts)
    del model
    torch.cuda.empty_cache()
    log(f"[measured] warm plans byte-identical: True; cold against warm equal but for each "
        f"layer's source; {mpath.relative_to(ROOT)}: b{BATCH} forward launches "
        f"{out['launches']['measured']}")

    # (d) the tiny calibration refit on the card
    cal = calibrate_tiny_coefficients(device=dev)
    out["calibration"] = dataclasses.asdict(cal)
    log(f"[calibrate] tiny-resnet on the card: A={cal.A:.4e} B={cal.B:.4e} (dense "
        f"{cal.measured_dense_s * 1e3:.3f} ms, kernel-q3 {cal.measured_epitome_s * 1e3:.3f} "
        f"ms, batch {cal.batch} at {cal.hw}^2); stored A={TINY_CALIBRATION.A:.4e} "
        f"B={TINY_CALIBRATION.B:.4e}")
    out["seconds"] = time.perf_counter() - t_phase
    log(f"[tune] phase 15 {out['seconds']:.1f} s; its own launches {out['launches']}")
    return out


def _ms(t, digits: int = 3) -> str:
    return "none" if t is None else f"{t:.{digits}f}"


def _fold_note(r) -> str:
    return f" fold_ms={r['fold_ms']:.4f}" if "fold_ms" in r else ""


def _to_cpu(tree):
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_cpu(v) for v in tree]
    return tree.detach().cpu()


def time_wkv_bwd(tree: str) -> int:
    """``python3 chip_smoke.py --time-wkv-bwd TREE``: the WKV backward kernel
    of the port in checkout TREE at phase 13's training shape (rwkv6-7b's
    heads, TRAIN_BATCH x TRAIN_SEQ, a zero h0 and no dhT), bf16 and float32
    r, k, v: device ms a launch (graph_ms, three readings), its largest
    error as a share of the WKV gate against the plain version, and its
    scratch bytes, as one JSON line.  To compare two checkouts' kernels,
    run it for each in turn in one chip call (A, B, B, A)."""
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card is visible", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(tree).resolve() / "src"))
    import ctypes
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels.wkv6 import wkv6_chunked_bwd
    _build.build_all()
    cfg = get_config(TRAIN_ARCH, TRAIN_VARIANT)
    B, S, H, K = TRAIN_BATCH, TRAIN_SEQ, cfg.n_heads, cfg.hd
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    f = lambda *s: torch.randn(s, device=dev, generator=gen)
    floats = ctypes.c_longlong()
    _build.check_launch(_build.library("wkv6_bwd").wkv6_chunked_bwd_scratch(
        B, S, H, ctypes.byref(floats)), "wkv6_chunked_bwd_scratch")
    out = dict(tree=tree, card=card_line(), B=B, S=S, H=H, K=K, scratch_bytes=4 * floats.value)
    for dtype in (torch.bfloat16, torch.float32):
        r, k, v = (f(B, S, H, K).to(dtype) for _ in range(3))
        lw, u, do = -torch.exp(f(B, S, H, K) * 0.5), f(H, K) * 0.1, f(B, S, H, K)
        kernel = lambda: wkv6_chunked_bwd(r, k, v, lw, u, None, do, None)
        got = kernel()
        over = max(float(((a - b).abs() / (WKV_TOL + WKV_TOL * b.abs())).max())
                   for a, b in zip(got, ref.wkv6_chunked_bwd_ref(r, k, v, lw, u, None, do, None)))
        out[str(dtype).replace("torch.", "")] = dict(
            ms=[graph_ms(torch, kernel) for _ in range(3)], over_gate=over)
    print(json.dumps(out))
    return 0


# --time-mamba-scan: the shapes (B, S, h0) that hold most of the scan's time
# in jamba's generate and engine run, and a decode step at batch 1
SCAN_TIMED = ((LM_REQUESTS, LM_PROMPT, "zero"), (LM_REQUESTS, 1, "random"), (1, 128, "random"),
              (1, 1, "random"))


def time_mamba_scan(tree: str) -> int:
    """``python3 chip_smoke.py --time-mamba-scan TREE``: the selective-scan
    kernel of the port in checkout TREE at jamba's width in bf16, at
    SCAN_TIMED: 4 x 256 with a zero h0 (the generate's prefill), 4 x 1 (a
    decode step or engine micro-step), 1 x 128 (an engine chunk) and 1 x 1,
    a random h0 at the last three.  Device ms a launch (graph_ms, three
    readings after 200 ms of launches), the largest error as a share of the
    gate (KERNEL_TOL, y and hT) against the plain version, the bytes bound,
    the SFU's time for the exponentials, and at S = 1 an L2-cold time over
    copies of h0 and A rotated past L2_COLD_BYTES; one JSON line with the
    card line.  To compare two checkouts' kernels, run it for each in turn
    in one chip call (A, B, B, A)."""
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card is visible", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(tree).resolve() / "src"))
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels.mamba_scan import mamba_scan
    _build.build_all()
    cfg = get_config(MAMBA_ARCH, "kernel-q3", ffn_pattern=MAMBA_FFN)
    di, ds = cfg.mamba_d_inner, cfg.mamba_d_state
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    out = dict(tree=tree, card=card_line(), di=di, ds=ds, dtype="bfloat16")
    for B, S, h0_kind in SCAN_TIMED:
        dt, x, Bm, Cm, A, D, h0 = scan_inputs(torch, dev, gen, B, S, di, ds, h0_kind)
        dt, x, Bm, Cm = (t.bfloat16() for t in (dt, x, Bm, Cm))
        kernel = lambda: mamba_scan(dt, x, Bm, Cm, A, D, h0)
        over = max(float(((a - r).abs() / (KERNEL_TOL + KERNEL_TOL * r.abs())).max())
                   for a, r in zip(kernel(), ref.mamba_scan_ref(dt, x, Bm, Cm, A, D, h0)))
        time_ms(torch, kernel, 200.0)       # the card's clocks up before the readings
        row = dict(h0=h0_kind, ms=[graph_ms(torch, kernel) for _ in range(3)], over_gate=over,
                   bound_ms=(_cost().scan_bytes(B, S, di, ds, 2, h0 is not None)
                             / _cost().HBM_BW * 1e3),
                   sfu_ms=B * S * di * ds / SFU_EXP_S * 1e3)
        if S == 1:
            pairs = [(A.clone(), h0.clone())
                     for _ in range(-(-L2_COLD_BYTES // (4 * (A.numel() + h0.numel()))) + 1)]
            cold = itertools.cycle(pairs)

            def kernel_cold():
                a, h = next(cold)
                return mamba_scan(dt, x, Bm, Cm, a, D, h)
            row.update(ms_cold=[graph_ms(torch, kernel_cold) for _ in range(3)],
                       cold_copies=len(pairs))
            del pairs
        out[f"{B}x{S}"] = row
        del dt, x, Bm, Cm, A, D, h0
    print(json.dumps(out))
    return 0


def time_jamba_engine(tree: str) -> int:
    """``python3 chip_smoke.py --time-jamba-engine TREE``: phase 14 (c)'s
    engine (jamba kernel-q3 from mamba_build, phase 10's requests and
    geometry) on the port of checkout TREE: one K = 4 run to warm up, then
    two K = 4 runs and one K = 1 run, each through engine_drive (its gates,
    launches exact): wall, tok/s, TTFT p50, median ms a macro-step; before
    the model, the scan wrapper's host time a call at 4 x 1 (2000 calls
    back to back, five readings).  One JSON line with the card line.  To
    compare two checkouts, run it for each in turn in one chip call (A, B,
    B, A)."""
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card is visible", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(tree).resolve() / "src"))
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build, launch_counts, reset_launch_counts
    from repro_torch.kernels.mamba_scan import mamba_scan
    from repro_torch.launch import engine as engine_mod
    from repro_torch.models import lm
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.build_all()
    dev = torch.device("cuda")
    out = dict(tree=tree, card=card_line())
    gen = torch.Generator(device=dev).manual_seed(SEED)
    cfg = get_config(MAMBA_ARCH, "kernel-q3", ffn_pattern=MAMBA_FFN)
    dt, x, Bm, Cm, A, D, h0 = scan_inputs(torch, dev, gen, LM_REQUESTS, 1, cfg.mamba_d_inner,
                                          cfg.mamba_d_state)
    dt, x, Bm, Cm = (t.bfloat16() for t in (dt, x, Bm, Cm))
    host_us = []
    for _ in range(5):
        for _ in range(200):
            mamba_scan(dt, x, Bm, Cm, A, D, h0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(2000):
            mamba_scan(dt, x, Bm, Cm, A, D, h0)
        host_us.append((time.perf_counter() - t0) / 2000 * 1e6)
        torch.cuda.synchronize()
    out["scan_host_us"] = host_us
    del dt, x, Bm, Cm, A, D, h0
    cfg, params, _ = mamba_build(torch, dev, lm, get_config)
    geometry = dict(capacity=ENGINE_CAPACITY, max_len=ENGINE_MAX_LEN, page_size=16, kv_pages=0,
                    prefill_chunk=ENGINE_CHUNK)
    reqs = engine_requests(torch, engine_mod.Request, cfg.vocab)

    def run(k):
        eng = engine_mod.EpimEngine(cfg, params, decode_block=k, device=dev, **geometry)
        r = engine_drive(torch, eng, reqs, range(len(reqs)), launch_counts,
                         reset_launch_counts, MAMBA_SITES)
        return dict(wall_s=r["wall_s"], tok_s=r["tok_s"], ttft_p50_s=r["ttft_p50_s"],
                    macro_ms=statistics.median(r["step_ms"][k]), launches=r["launches"])
    run(ENGINE_BLOCK)
    out.update(k4=[run(ENGINE_BLOCK) for _ in range(2)], k1=run(1))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    import atexit
    atexit.register(_end_children)
    if sys.argv[1:2] == ["--time-decode"]:
        sys.exit(time_decode(sys.argv[2] if len(sys.argv) > 2 else "."))
    if sys.argv[1:2] == ["--time-lm-host"]:
        sys.exit(time_lm_host(sys.argv[2] if len(sys.argv) > 2 else "."))
    if sys.argv[1:2] == ["--time-wkv-bwd"]:
        sys.exit(time_wkv_bwd(sys.argv[2] if len(sys.argv) > 2 else "."))
    if sys.argv[1:2] == ["--time-mamba-scan"]:
        sys.exit(time_mamba_scan(sys.argv[2] if len(sys.argv) > 2 else "."))
    if sys.argv[1:2] == ["--time-jamba-engine"]:
        sys.exit(time_jamba_engine(sys.argv[2] if len(sys.argv) > 2 else "."))
    if sys.argv[1:2] == ["--time-mesh"]:
        sys.exit(time_mesh())
    sys.exit(main())
