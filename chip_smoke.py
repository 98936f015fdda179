#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one CUDA card and
check it.

    python3 chip_smoke.py [--seed 0] [--out chiprun_out/chip_smoke.json]

Three paths of the port run here.  MapReduce: the paper's Table I row (K=16,
P=4, Q=16, N=1680) with ``wide_histogram_job(d=2048)``, each subfile
16,384 int32 tokens drawn from ``--seed`` in [0, 2^16); every per-key
total stays below 2^24, so every partial sum of the integer-valued float32
payloads is exact in any order and all results compare bit for bit.  LM
serving (``SERVE_CASES``), bf16 weights and stub frontend inputs drawn on
the card from ``--seed``: at full size qwen2-1.5b, rwkv6-3b and
deepseek-v2-lite-16b (MLA attention, 64-expert MoE with the sorted
dispatch), 8 slots x 2,048-token prompts into a 2,112-long cache;
hymba-1.5b, 8 slots x 2,560-token prompts past its 2,048 window (a
2,048-slot ring); whisper-large-v3, 8 slots x (1,500 stub frames, 416 +
32 decoder tokens: its 448-token context); and llava-next-34b at full
width and depth, 2 slots x (2,880 stub patch embeddings + 256 tokens),
with its fp32 check cut to 12 of its 60 layers.  qwen2-72b fits no card
whole: phase 10 runs it at full width, cut in depth, sharded over four
ranks on the one card (tensor parallelism); llama3-405b runs at
``reduced()`` (phase 7).  Training
(phase 9): Qwen2-1.5B at full width in fp32 (AdamW, 8 x 2,048 tokens of
the port's synthetic pipeline, two microbatches, remat), weights drawn on
the card from ``--seed``; RWKV6-3B the same at full width, cut to 16 of
its 32 layers (``TRAIN_RWKV_LAYERS``); all ten archs at ``reduced()``.

Phases, one printed line each (plus detail lines):

1. device   — ``nvidia-smi`` name and power limit, the card, and the
              kernels' build (one ``nvcc`` per source, all at once).
2. kernels  — each coded-combine kernel against its plain PyTorch version
              on the card, at the main path's launch shapes, at phase
              4c's (one server's share of them; the gradient
              reduce-scatter's [3, 1680 x 2048] with 0/1 coefficients)
              and at odd shapes, with CUDA-event times and the HBM
              bound; where one
              library call computes the same function (``xs.sum(0)``,
              ``torch.sub``, ``torch.bitwise_xor``) kernel and library are
              timed in turns (kernel, library, library, kernel); at the
              main shapes and at one server's (phase 4c's) both's device
              time per call (profiler; every main ``coded_decode`` row in
              float32 and bfloat16), taken after
              phase 7 so that its profiler sessions come last.  The
              decode's ``ptxas`` lines are printed here again.
3. shuffle  — ``hybrid_shuffle`` for r in {2, 3} x {unicast, coded} x
              {torch, kernel} and ``coded_xor`` on int32 payloads, bit-exact
              against the port's NumPy ``simulate_plan_shuffle`` and
              ``plan_shuffle_reference``.
4. engine   — ``run_job_distributed`` fused and legacy, binomial r in
              {1, 2, 3} and resolvable r = 2, every multicast x combine
              pairing: outputs bit-exact against the dense ``run_job``,
              costs and rack bytes equal to the closed forms; one profiled
              fused job.
4b. faults  — the recovery ladder at the same row under crash schedules.
4c. ranks   — the process form: 16 ranks on the card over gloo (NCCL
              refuses two ranks on one device), spawned once, each
              drawing the subfiles from ``--seed``.  Each runs fused
              ``run_job_distributed`` for binomial r in {1, 2, 3} x
              {(unicast, torch), (coded, kernel)}, resolvable r = 2 and
              one legacy r = 2 job, a ``coded_xor`` ``hybrid_shuffle`` on
              int32 at r = 2, and ``coded_reduce_scatter_r2(combine_impl=
              "kernel")`` on integer-valued chunk gradients of G = 1536 x
              8960 (one Qwen2-1.5B MLP projection) with no failure and
              rack 3 failed.  Gates: every rank's outputs bit-identical to
              the stacked job's and ``run_job``'s, its shuffle rows to the
              stacked shuffle's, every survivor's shard to the NumPy
              total; every rank's launches one server's; every rank on
              the card.  Walls: the slowest rank's, median of three after
              a warm call, beside the stacked job's timed the same way;
              the exchanges alone; spawn and rendezvous.
4d. locality — Section IV, run last (after phase 7 and phase 2's device
              times: profiles taken after its million-odd eager launches
              held about half of their kernel records).  First the Table
              I row with HDFS replicas (r_f = 3), r in {2, 3}: greedy,
              then the annealer on the card (64 chains, 1,500 steps; its
              step loop run again under ``set_sync_debug_mode("error")``,
              and 200 steps profiled), the fused coded kernel job under
              that placement bit-identical to the identity placement and
              ``run_job`` with one encode and one decode, every server
              mapping the placement's subfiles, and its simulated JCT
              below a random placement's.  Then the ten Table II rows of
              ``BENCH_locality.json`` through the port's ``table2_trials``
              (random, greedy, flow, local_search, and the annealer on
              the card warm-started from flow and greedy, 64 chains,
              1,000 steps): the four deterministic solvers' statistics
              and the flow-vs-random ``jct_gap`` equal the file's (the
              JAX package's numbers), the annealer >= flow, every solver
              above random.
4e. scheduler — after 4d, with no profiler session: the online scheduler,
              drift, calibration and the resilience policies.  (a)
              ``BENCH_sim.json`` rerun whole (K=8, P=4, 100 jobs, every
              sweep, each stream on a cleared plan cache): decisions
              exact, every float within 1e-12.  (b)
              ``BENCH_calibration.json``'s drift section (the stale model
              against the online refit after a 3x regime shift) within
              1e-12, and its determinism digest as the JAX package's
              bench gives it today (the file's predates the blame
              metrics).  (c) ``BENCH_resilience.json``'s frontier cells of
              the first three Table I rows at 10 seeds within 1e-12,
              ``hedged_vs_static`` (80 jobs, 30 probes) with exact
              decisions, and the trace determinism check.  (d) the
              calibration bench's phase-fit grid measured on the card
              (``measure_calibration_grid``, 5 iterations), fitted and
              written beside ``--out`` as ``h100_cost_model.json``; then
              the fused job's warm wall (best of 5) over the conformance
              grid under unicast/torch and coded/kernel (one encode and
              one decode a job at r >= 2), outputs equal to ``run_job``,
              a conformance fit per pairing with the simulator equal to
              its linear predictor within 1e-9 (errors against the
              bench's 0.35 band reported, not gated).  (e) one seeded
              ``run_scheduled`` stream on ``default_catalog(8, 4)`` with
              the H100 fit, every hybrid candidate placed by the annealer
              on the card, then again with the annealer on the CPU:
              decisions, ``JobStats``, trace and every placement
              identical; the ``choose`` wall per admission.  (f)
              ``obs_report.md`` / ``.html`` of the phase's registry and
              the stream, beside ``--out``.
5. lm kernels — ``flash_attention`` and ``wkv_scan`` against their plain
              versions at the serving path's prefill and decode shapes (bf16
              and fp32) and the odd shapes of tests/test_kernels.py, with
              times, bounds (bytes or tensor-core operations) and, for
              attention, the route each call took and
              ``scaled_dot_product_attention`` as the library yardstick,
              timed in turns with the kernel (kernel, SDPA, SDPA, kernel)
              at the prefill and at decode over 1,500 and 2,111 keys,
              and the card's own time per call of both and the kernel's
              device kernels per call (profiler); split-kv decode calls
              also against the plain split-kv algorithm.  WKV: the route
              each call took (``tensor_core`` for bf16 at Nk = Nv = 64,
              ``chunk_f32`` for fp32 at Nk <= 32 and S >= 16, ``step``
              otherwise), tensor-core calls also against their plain
              mirror ``wkv_subchunk_ref`` and chunk_f32 calls against
              ``wkv_chunk_f32_ref``, the kernels' ``ptxas`` lines, and the
              tensor-core and chunk_f32 kernels' shared memory and blocks
              an SM.  Head dims over
              128: MLA's absorbed attention at hd 576 at deepseek-v2-lite's
              serving shapes (16 query heads on one latent kv head; the
              8 x 2048 causal prefill into the 2,112-long cache, with v
              apart from k and with v = k as the model calls it, in bf16
              on the wide tensor-core route, also against its plain
              mirror ``attention_wide_ref`` and twice for the same bits,
              in fp32 on the TF32 ``mma_tf32`` route; a decode step over
              2,049 keys on split-kv; each timed in turns with SDPA;
              decode over per-batch valid keys) and one odd shape at hd
              192 (``LARGE_HD_ROUTE`` names each route).  Every
              ``mma_tf32`` call is also held against its plain mirror
              ``attention_mma_ref`` (split-TF32 products) and run twice
              for the same bits; its fp32 prefills at Qwen2's
              [8, 2048, 12, 128], MLA's [8, 2048, 16, 576] (v apart and
              v = k) and phase 10's ``tp_check`` are timed in turns with
              fp32 SDPA and profiled, with TFLOP/s of the function's
              work.  The new
              families' serving shapes (``FAMILY_TAGS``, bf16 timed
              against SDPA in turns and profiled): Hymba's windowed
              prefill and ring decode,
              Whisper's encoder (one query head per kv head, 1,500 keys off
              the 64-key tile), cross prefill and cross decode, LLaVA's
              prefill.  Phase 10's local heads (``TP_TAGS``: qwen2-72b's
              G = 8, the bf16 4 x 1,024 prefill, its last decode step
              over 1,056 slots and the fp32 2 x 256 check; DeepSeek-V2-
              Lite's G = 4 on the hd-576 latent head at the same shapes,
              v = k, and the prefill at G = 8, each dtype on the route
              ``TP_ROUTE`` names).  Hymba's SSM scan (``ssm_scan_phase``):
              its prefill on the WKV ``chunk_f32`` kernels in inclusive
              mode (also against their plain version ``wkv_chunk_f32_ref``,
              twice for the same bits, with the device kernels per call)
              and its decode step on the identity through the ``step``
              kernel, each against the plain inclusive recurrence.
6. serve    — per arch of ``SERVE_CASES``: ``generate`` (after a warm-up
              call, 1 new token three times for the time to first token,
              32 new tokens twice: greedy output identical; medians of the
              host-clock walls), ``serve`` (12 requests, prompts of 64 to
              the case's prompt length, 8-32 new tokens; skipped for
              whisper and llava, whose stub frontend inputs ``serve``
              does not carry), time to first token, decode ms per step,
              tokens/s, peak memory, a profiled decode step; then fp32 at
              full width: prefill and decode logits within 2e-3 of
              ``forward``'s (MoE through the capacity-less dispatch: the
              sorted one's capacity depends on how many tokens a call
              routes; hymba prefills 2,098 tokens so that its decode step
              reads a wrapped ring; llava at 12 of 60 layers, whose fp32
              weights would be 137.6 GB).  deepseek-v2-lite serves
              through the sorted dispatch (one group; at 8 decode slots
              each expert keeps one token-choice a step).
7. card vs cpu — at all ten archs' ``reduced()`` configs, the same weights
              and stub frontend inputs on the card (kernels) and on the
              CPU (plain versions): the same greedy tokens, logits within
              1e-4; the MoE archs (deepseek-v2-lite-16b, grok-1-314b) with
              ``dense_moe`` both ways, and the smallest gap between a
              token's k-th and (k+1)-th router probability reported.
9. train    — after phase 7 and phase 2's device times, before 4d,
              (b) first (its profiled step is the phase's first profiler
              session): (a) both backward kernels (``flash_attention_backward``,
              ``wkv_scan_backward``) against autograd through their plain
              versions, fp32 and bf16, at the training shapes
              (``TRAIN_FLASH_CASES``: Qwen2-1.5B's [4, 2048, 12, 128] on
              2 kv heads, Whisper's encoder and its 416 x 1,500 cross
              attention, Hymba's 2,048 window, MLA's hd 576;
              ``TRAIN_WKV_CASES``: RWKV6-3B's [8, 2048, 40, 64] and
              Hymba's SSM identity, and both at the [4, ...] microbatch
              their train steps launch), the same gradients twice bit for
              bit, CUDA-event, plain and (flash) SDPA-backward times in
              turns, the bound (flash: the function's 10 * hd FLOPs a
              visible pair), the route (flash ``tf32x3`` / ``tf32``, WKV
              ``chunk``, timed in turns with the ``step`` kernels it
              replaced at the same shape) and TFLOP/s, and the device
              time at the kernels line's rows (``BWD_PROFILED``; MLA's
              fp32 row where the profiler holds records,
              ``BWD_TRY_PROFILED``).  (b) Qwen2-1.5B at full
              width, fp32 parameters and AdamW moments, 8 x 2,048 tokens
              of the port's ``SyntheticPipeline`` in two microbatches, remat,
              ``TRAIN_STEPS`` steps of ``make_train_step``: loss finite
              and falling; the first step's launches counted; step wall
              (median of the later steps), tokens/s, peak memory, and the
              idle share of one more, profiled step, with the flash
              forward's (``mma_tf32``) share of its device time.  (b')
              RWKV6-3B the same, cut to 16 layers (12 if its peak passes
              75 GB): the full-width path of the WKV backward; gates:
              losses, ``wkv_scan`` 2 L x 2 launches on ``step`` (a forward
              and a remat recompute a layer and microbatch),
              ``wkv_scan_backward`` L x 2 on ``chunk``, no plain version;
              the WKV backward's device ms and share of the profiled
              step's busy time, the six largest kernels.  (c) one
              train step of all ten archs at ``reduced()`` (the MoE ones
              with both dispatches) on the card against the CPU: loss
              within 1e-5,
              each gradient leaf within 1e-4 of its own largest entry,
              the card's update within 1e-4 of each leaf's update of the
              CPU optimizer on the card's gradients.  (d) reduced
              qwen2 preempted before step 4 and resumed from its step-3
              checkpoint through ``run_with_restarts``, bit-identical to
              the uninterrupted run (in a spawned process with
              deterministic algorithms on and ``CUBLAS_WORKSPACE_CONFIG``
              set before its card starts; the other phases keep the
              default cuBLAS).
              (e) ``coded_r2`` on four ranks over gloo on the card,
              gradients within 1e-5 of the full-batch step under every
              single rack failure.
10. tp      — after 4e: tensor parallelism over four ranks on the card
              (gloo, spawned once; NCCL refuses two ranks on one
              device), each drawing its shards of the weights from
              ``--seed`` one leaf at a time.  (a) qwen2-72b at full width,
              2 of 80 layers, fp32, (data 1, model 4) under
              ``default_rules(fsdp=False)``: 2 slots x 256-token prompts,
              ``prefill`` and 8 greedy ``decode_step``s, then
              ``ServeEngine.generate``: logits within 1e-4 of the largest
              |logit| of the unsharded run on the card (this process,
              before the spawn), the same greedy tokens on every rank,
              each rank's weight bytes equal to the local bytes of
              ``param_pspecs``, and each rank's flash launches by route
              (fp32 prefill on ``mma_tf32``, decode on ``split_kv``).
              (b) the same at 4 of 80 layers in bf16, 4 slots x
              1,024-token prompts + 32 new tokens: time to first token,
              decode ms a step, tokens/s (the slowest rank's host walls),
              each rank's peak memory, spawn to rendezvous, the device
              bounds of the prefill and a decode step, and the share of
              the prefill and of the decode steps spent in the model-axis
              collectives (the largest over ranks; host clock, a
              synchronisation around each collective and each model call,
              in a run of its own); the routes (bf16 prefill on
              ``tensor_core`` at 8 query heads a kv head, decode on
              ``split_kv``); greedy agreement with the unsharded bf16 run
              printed, not gated.  Gloo on one card, not NCCL.  (c)
              reduced qwen2-72b (kv heads duplicated at model 4),
              DeepSeek-V2-Lite (MLA, experts split) and Grok-1 (kv heads
              duplicated, experts split), one AdamW step each (the
              capacity-less MoE dispatch) on (data 2, model 2) and on
              (data 1, model 4) with sequence TP: loss and clipping norm
              within 1e-5 of the unsharded full-batch step's, each
              gathered gradient leaf
              within 1e-4 of its largest entry, the gathered parameters
              within 1e-6 of each leaf's largest of the unsharded AdamW
              fed that gradient.  (d) ZeRO-3 composed with TP: Qwen2-1.5B
              at full width and depth on (data 2, model 2) under
              ``default_rules(False)`` (its FSDP overlay on 'data'), phase
              9 (b)'s configuration (seed, 8 x 2,048 tokens in two
              microbatches, remat, fp32 AdamW), two steps, the second on
              a collective clock: steps 1-2 loss and clipping norm
              within 1e-5 of phase 9 (b)'s; each rank's params, m and v
              bytes equal to the specs of ``train_state_pspecs(fsdp=
              True)``; flash by route (``mma_tf32`` forward, the
              backward's dq_mma / dkdv_mma) and no plain version; the step
              wall (the slowest rank's step 2, on the clock), tokens/s,
              each rank's peak, and the share of a step in the 'data'
              collectives (gathers, reduce-scatters, the replicated
              leaves' psum; host clock).  (e) one ZeRO-3 step of every
              arch at reduced() widened (no leaf of reduced() reaches the
              overlay's 2^16 elements) on (data 2, model 1) (two such
              meshes side by side under a 'pod' axis), the dense, VLM and
              MoE archs also on (2, 2), AdamW, and Adafactor on qwen2-72b at
              (2, 2): loss within 1e-5 of the unsharded step on the card,
              each gathered gradient leaf within 1e-4 of its largest
              entry, the gathered parameters within 1e-6 of the unsharded
              optimizer fed that gradient; flash and WKV, forward and
              backward, launched.  (f) the MoE family under a model axis:
              DeepSeek-V2-Lite at full width on (data 1, model 4), 16 of
              the 64 routed experts and 4 of the 16 MLA heads a rank
              (G = 4 on the one hd-576 latent head), the latent and its
              cache whole on every rank.  (f1) fp32, 2 of 27 layers (the
              dense first layer and one MoE layer), 2 slots x 256-token
              prompts, ``prefill`` and 8 greedy ``decode_step``s under
              the sorted dispatch and under ``dense_moe``: logits within
              1e-4 of the largest |logit| of the unsharded run on the card,
              the same greedy tokens on every rank and as that run, each
              rank's weight bytes equal to the specs' local bytes, flash
              by route (``mma_tf32`` prefill, ``split_kv`` decode).  (f2)
              bf16 at full depth, (b)'s shape (4 slots x 1,024-token
              prompts + 32 new): TTFT, decode ms a step, tokens/s (the
              slowest rank's host walls), each rank's peak, the device
              bounds of the prefill and a decode step, the model-axis
              collectives' shares, flash by route (``tensor_core_wide``
              prefill, ``split_kv`` decode, 27 a forward a rank, no plain
              version), the same tokens on every rank, and greedy
              agreement with the unsharded bf16 model (phase 6's weights)
              at that shape, printed, not gated.
8. kernels line — one JSON object with all eleven kernels: launches on
              the main path and per path, and numbers at the main path's
              largest shape (library times in turns, device times per
              call); for flash and WKV, launches by route (for flash also
              the device kernels per call each route took in phase 5's
              profile); for the two backward kernels, phase 9 (a)'s fp32
              row at Qwen2's and RWKV6-3B's training shapes (no Pallas
              kernel: ``replaces`` names the jnp function the JAX package
              differentiates); for the wide tensor-core flash kernel
              (``flash_attention_wide``, flash's ``tensor_core_wide``
              route), its launches serving DeepSeek-V2-Lite and phase 5's
              bf16 row with v = k; for the TF32 tensor-core flash kernel
              (``flash_attention_mma``, flash's ``mma_tf32`` route), its
              launches on the full-width Qwen2-1.5B train step and phase
              5's fp32 prefill rows; for the fp32 chunk-parallel WKV
              kernels (``wkv_scan_chunk_f32``, WKV's ``chunk_f32`` route),
              their launches serving Hymba-1.5B (every prefill's SSM
              scan) and phase 5's Hymba prefill row.

Launch counts are read per call: zeroed just before every
``hybrid_shuffle``, ``run_job_distributed``, ``generate``, ``serve``,
``forward``, ``prefill`` and ``decode_step`` call and read just after (in
phase 4c, in every rank around each timed call).  A coded shuffle with
``combine_impl="kernel"`` and packet arity >= 2 must launch one encode
and one decode (on the process form, in every rank), other shuffles
none; ``coded_reduce_scatter_r2`` one encode per destination rack; under
faults that holds on the ``none`` and ``restart`` rungs, and the degraded
rungs (``decode_around``, ``partial_remap``: unicast stage 1) launch
none; every LM forward (a prefill or one decode step) must launch its
kernels as ``per_forward`` counts them and call no plain version: 28
flash launches for qwen2-1.5b, 32 WKV launches for rwkv6-3b, 27 flash
launches for deepseek-v2-lite-16b, 32 flash and 32 WKV launches for
hymba-1.5b, 96 flash launches a whisper-large-v3 prefill (32 encoder, 32
self, 32 cross) and 64 a decode step, 60 flash launches for
llava-next-34b; every time-to-first-token call runs all of them on its
prefill route (flash ``tensor_core``, ``tensor_core_wide`` at MLA's hd 576;
WKV ``tensor_core`` for RWKV6, ``chunk_f32`` in inclusive mode for
Hymba's SSM), and the new families' and deepseek-v2-lite's decode steps
take ``split_kv`` (Hymba's SSM decode steps WKV ``step``).  A
full-width Qwen2-1.5B train step (two microbatches, remat) launches
2 x 2 x 28 flash forwards, all on ``mma_tf32`` (fp32; never split-kv),
and 2 x 28 flash backwards, and calls no plain version; a reduced train
step launches the WKV backward for rwkv6 and hymba and the flash backward
for every arch with attention; a rank's ``coded_r2`` gradient launches
one ``coded_encode`` a destination rack.  Main paths:
the fused engine for the linear pair, the int32 ``hybrid_shuffle`` for
the XOR pair, full-width serving for the LM kernels, training for the
backward kernels (the full-width Qwen2-1.5B step for flash, phase 9 (c)'s
reduced steps for WKV); the combine
kernels' ``ranks`` path (phase 4c), and the linear pair's ``placed`` path
(phase 4d) and ``scheduler`` path (phase 4e's coded/kernel conformance
cells) must launch too, and the ``tp`` path (phase 10, summed over its
ranks: the ``generate`` of (a) and (b), the steps of (c), (d) and (e) and
the serving of (f)) launches flash and WKV, forward and backward.

The last line is ``{"ok": true, "device": {...}}``.  Any failed check
raises and the script exits non-zero; without a CUDA card it exits 1 and
prints no result.  Imports nothing of JAX or of the JAX package ``repro``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import pathlib
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, NamedTuple, Optional, Tuple

ROOT = pathlib.Path(__file__).resolve().parent
K, P, Q, N, D = 16, 4, 16, 1680, 2048
TOKENS = 16384
SOURCE = "src/repro_torch/kernels/coded_combine/csrc/coded_combine.cu"
DECODE_SOURCE = ("src/repro_torch/kernels/coded_combine/csrc/"
                 "linear_decode.cuh")
XOR_SOURCE = "src/repro_torch/kernels/coded_combine/csrc/xor_stream.cuh"
FLASH_SOURCE = ("src/repro_torch/kernels/flash_attention/csrc/"
                "flash_attention.cu")
WIDE_SOURCE = ("src/repro_torch/kernels/flash_attention/csrc/"
               "flash_tc_wide.cuh")
MMA_SOURCE = "src/repro_torch/kernels/flash_attention/csrc/flash_mma.cuh"
WKV_SOURCE = "src/repro_torch/kernels/rwkv_scan/csrc/wkv_scan.cu"
CHUNK_F32_SOURCE = ("src/repro_torch/kernels/rwkv_scan/csrc/"
                    "wkv_chunk_f32.cuh")
REPLACES = {"coded_encode": "src/repro/kernels/coded_combine/kernel.py:58",
            "coded_decode": "src/repro/kernels/coded_combine/kernel.py:74",
            "xor_encode": "src/repro/kernels/coded_combine/kernel.py:91",
            "xor_decode": "src/repro/kernels/coded_combine/kernel.py:105",
            "flash_attention":
                "src/repro/kernels/flash_attention/kernel.py:74",
            "wkv_scan": "src/repro/kernels/rwkv_scan/kernel.py:77"}

# published peaks by the name nvidia-smi gives the card, at its full power
# limit (NVIDIA's data sheet, dense): HBM bytes/s, and the tensor cores'
# FLOP/s for each input dtype of the LM kernels (float32 inputs: the TF32
# rate, the fastest the card multiplies them).  "H100 80GB HBM3" is the SXM
# part.  The combine kernels do no multiply worth bounding (r - 1 adds or
# XORs per element read): their bound is bytes alone.
PEAKS = {"NVIDIA H100 80GB HBM3": {"hbm": 3.35e12, "bfloat16": 989e12,
                                   "float32": 495e12}}
KERNELS = ("coded_encode", "coded_decode", "xor_encode", "xor_decode")
LM_KERNELS = ("flash_attention", "wkv_scan")


def say(*parts) -> None:
    print(*parts, flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def _tol_text(rtol: float, atol: float) -> str:
    return "exact" if rtol == atol == 0 else f"rtol={rtol},atol={atol}"


class Counts:
    """Zero every kernel's launch count (and its plain-version count) just
    before a call and read them just after: (fn(), launches, plain).  The
    routes of the last call are left in ``routes``, by kernel (flash and
    WKV both have a route named ``tensor_core``)."""

    def __init__(self, torch, mods):
        self.torch, self.mods = torch, mods
        self.routes = {}

    def __call__(self, fn):
        for m in self.mods:
            m.reset_launch_counts()
        out = fn()
        self.torch.cuda.synchronize()
        launches, plain, self.routes = {}, {}, {}
        for m in self.mods:
            launches.update(m.LAUNCHES)
            plain.update(getattr(m, "PLAIN_CALLS", {}))
            if hasattr(m, "ROUTE_CALLS"):
                (kname,) = m.LAUNCHES
                self.routes[kname] = dict(m.ROUTE_CALLS)
        return out, launches, plain


def expected_launches(multicast: str, combine_impl: str, arity: int,
                      rung: str = "none"):
    """The launches one stacked shuffle makes: one encode and one decode
    for all K servers when a coded format runs on the kernels.  Under
    faults, the ``none`` and ``restart`` rungs run that failure-free
    shuffle; the degraded rungs (``decode_around``, ``partial_remap``) run
    stage 1 as unicast and launch nothing."""
    want = dict.fromkeys(KERNELS, 0)
    if rung not in ("none", "restart"):
        return want
    if combine_impl == "kernel" and multicast != "unicast" and arity >= 2:
        pair = (("xor_encode", "xor_decode") if multicast == "coded_xor"
                else ("coded_encode", "coded_decode"))
        want.update(dict.fromkeys(pair, 1))
    return want


def add_counts(total, counts) -> None:
    for k, v in counts.items():
        total[k] += v


def cuda_ms(torch, fn, reps: int = 5, inner: int = 10) -> float:
    """Median over ``reps`` of the mean time of ``inner`` back-to-back
    calls, by CUDA events (one warm-up call first)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def device_per_call(torch, fn, calls: int = 20, sessions: int = 3,
                    tries: int = 9):
    """(the card's own ms per call of ``fn``, device kernels per call), by
    torch.profiler: the median over ``sessions`` profiles of ``calls``
    calls each (``profile_once``).  Unlike back-to-back CUDA-event timing,
    the host's enqueue cost does not enter the time.

    The median, because a session now and then reads a time that belongs
    to no call of its own (on the H100 with torch 2.11, one session of
    roughly twenty read the bf16 decode's time under the fp32 decode's
    name): sessions more than 1 % apart are printed.  A profile with no
    kernel record at all (several in a row, now and then) is printed and
    taken again a second later, ``tries`` profiles at most; the median is
    then over the sessions that held records."""
    takes = []
    for attempt in range(tries):
        got = profile_once(torch, fn, calls)
        if got is None:
            say(f"  profiler: no kernel record in profile {attempt + 1} of "
                f"at most {tries}, taken again")
            time.sleep(1.0)
            continue
        takes.append(got)
        if len(takes) == sessions:
            break
    if not takes:
        raise RuntimeError(f"profiler: no kernel record in {tries} profiles "
                           f"of {calls} calls")
    takes.sort()
    if takes[-1][0] > 1.01 * takes[0][0]:
        say(f"  profiler: sessions read {[round(t[0], 6) for t in takes]} "
            f"ms a call; the median is kept")
    return takes[len(takes) // 2]


def profile_once(torch, fn, calls: int):
    """(device ms per call, device kernels per call) of one profile of
    ``calls`` calls, or None when it holds no kernel record: for each
    kernel name (copies and fills not counted), its mean device time times
    its launches per call.

    Launches per call are each name's event count over ``calls``, rounded,
    and at least one for a name with any record: the profiler often drops
    a few of a session's kernel records or hands them to the next session
    (on the H100 with torch 2.11: 17 or 18 of 20 records in most profiles
    of a run, and fewer the more sessions and records a process has taken:
    9 of 20 after phase 6 served three models and profiled their decode
    steps), and records lost or gained must not move the time.  Every
    count that is not a whole multiple of ``calls`` is printed."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    ms, kernels = 0.0, 0
    for ev in prof.key_averages():
        if (not str(getattr(ev, "device_type", "")).endswith("CUDA")
                or ev.key.startswith(("Memcpy", "Memset"))):
            continue
        per_call = max(round(ev.count / calls), 1)
        if ev.count % calls:
            say(f"  profiler: {ev.count} records of {ev.key[:60]} over "
                f"{calls} calls, counted as {per_call} a call")
        ms += device_us(ev) / 1e3 / ev.count * per_call
        kernels += per_call
    return (ms, kernels) if kernels else None


def bound(peaks, nbytes: float, flops: float = 0.0, dtype: str = ""):
    """(least time in ms the card needs, "bytes" or "operations"): the
    bytes over the HBM rate, or the FLOPs over the tensor cores' rate for
    the input dtype, whichever is larger.  No FLOPs: bound by bytes."""
    t_bytes = nbytes / peaks["hbm"] * 1e3
    t_ops = flops / peaks[dtype] * 1e3 if flops else 0.0
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# Phase 2: the four kernels against their plain versions
# ---------------------------------------------------------------------------

def combine_calls(torch, ops, ref, name, xs, c, f, unit):
    """(kernel, plain version, library call or None) of one combine kernel
    on [r, ...] streams ``xs`` (coefficients ``c``, packet ``f``; the
    decodes recover stream 0).  The library call is the one PyTorch call
    that computes the same function: ``xs.sum(0)`` and ``torch.sub`` for
    unit coefficients (the decode at r = 2), ``torch.bitwise_xor`` for
    int32 at r = 2."""
    known, r = xs[1:], xs.shape[0]
    if name == "coded_encode":
        return (lambda: ops.coded_encode(xs, c), lambda: ref.encode_ref(xs, c),
                (lambda: xs.sum(0)) if unit else None)
    if name == "coded_decode":
        return (lambda: ops.coded_decode(f, known, c),
                lambda: ref.decode_ref(f, known, c),
                (lambda: torch.sub(f, known[0])) if unit and r == 2 else None)
    words = xs.view(torch.int32)
    on_int = r == 2 and xs.dtype == torch.int32
    if name == "xor_encode":
        return (lambda: ops.xor_encode(xs), lambda: ref.xor_encode_ref(xs),
                (lambda: torch.bitwise_xor(words[0], words[1]))
                if on_int else None)
    return (lambda: ops.xor_decode(f, known),
            lambda: ref.xor_decode_ref(f, known),
            (lambda: torch.bitwise_xor(f, known[0])) if on_int else None)


def kernel_phase(torch, ops, ref, main_shapes, rank_shapes, grad_shape,
                 peaks, seed):
    """Compare and time every kernel; returns (rows, {kernel: row at the
    main path's largest launch shape}, main rows to profile).  Shapes: the
    main path's, the ranks path's (one server's coded shuffle; one
    destination of the coded gradient reduce-scatter, 0/1 coefficients),
    and odd ones.  A row with a library call times the kernel and the
    library in turns (kernel, library, library, kernel).  The main rows'
    and the ranks path's device times per call come later
    (``profile_main_rows``): every profiler session here would cost the
    later phases' profiles records."""
    dev = torch.device("cuda")
    odd = [(r, T, d) for r in (2, 3, 4) for T, d in
           ((1, 7), (257, 40), (300, 130))]
    rows, main, to_profile = [], {}, []

    def record(name, r, T, d, dtype, coeffs, err, tol, fn, plain, library,
               is_main, is_rank=False):
        n = T * d
        itemsize = torch.empty((), dtype=dtype).element_size()
        nbytes = (r + 1) * n * itemsize
        big = n >= 1 << 20
        reps, inner = (11, 40) if big else (5, 50)
        row = {"name": name, "r": r, "T": T, "d": d,
               "dtype": str(dtype).replace("torch.", ""),
               "coeffs": coeffs,
               "max_abs_err": err, "tolerance": tol,
               "plain_ms": cuda_ms(torch, plain, reps, inner),
               "library_ms": None, "bytes": nbytes}
        row["bound_ms"], row["bound_by"] = bound(peaks, nbytes)
        if library is None:
            row["ms"] = cuda_ms(torch, fn, reps, inner)
        else:
            # in turns: kernel, library, library, kernel
            turns = [cuda_ms(torch, f, reps, inner)
                     for f in (fn, library, library, fn)]
            row["ms_turns"] = [turns[0], turns[3]]
            row["library_ms_turns"] = [turns[1], turns[2]]
            row["ms"] = statistics.mean(row["ms_turns"])
            row["library_ms"] = statistics.mean(row["library_ms_turns"])
        rows.append(row)
        lib_ms = row["library_ms"]
        lib_txt = "null" if lib_ms is None else f"{lib_ms:.6f}"
        say(f"  kernel {name} r={r} T={T} d={d} {row['dtype']} "
            f"coeffs={row['coeffs']}: kernel_ms={row['ms']:.6f} "
            f"plain_ms={row['plain_ms']:.6f} library_ms={lib_txt} "
            f"bytes={nbytes} bound_ms={row['bound_ms']:.6f} bound / kernel "
            f"{row['bound_ms'] / row['ms']:.4f} max_abs_err={err!r} "
            f"tolerance={tol}")
        if library is not None:
            say(f"    in turns (kernel, library, library, kernel): "
                f"{turns[0]:.6f} {turns[1]:.6f} {turns[2]:.6f} "
                f"{turns[3]:.6f} ms; kernel / library "
                f"{row['ms'] / lib_ms:.4f}")
        if is_main or is_rank:
            to_profile.append(row)
        if is_main:
            main.setdefault(name, row)

    def err_of(a, b):
        return float((a.float() - b.float()).abs().max().item())

    g = torch.Generator(device=dev).manual_seed(seed)
    coeff_of = {"unit": lambda r: torch.ones(r, device=dev),
                "1..r": lambda r: torch.arange(1.0, r + 1.0, device=dev),
                "0/1": lambda r: torch.arange(r, device=dev) % 2 == 0}
    cases = ([(s, "unit", "main") for s in main_shapes]
             + [(s, "unit", "rank") for s in rank_shapes]
             + [(grad_shape, "0/1", "odd")]
             + [(s, "1..r", "odd") for s in odd])
    for (r, T, d), coeffs, kind in cases:
        is_main, is_rank = kind == "main", kind == "rank"
        unit = coeffs == "unit"           # the shuffle's coefficients
        for dtype in (torch.float32, torch.bfloat16):
            xs = torch.randn(r, T, d, generator=g, device=dev).to(dtype)
            c = coeff_of[coeffs](r).float()
            exact = unit and dtype == torch.float32
            enc_tol = (0.0 if exact else
                       1e-6 if dtype == torch.float32 else 3e-2)
            dec_tol = ((0.0, 0.0) if exact else
                       (1e-4, 1e-4) if dtype == torch.float32
                       else (1e-2, 0.15))
            f = ops.coded_encode(xs, c)
            f_ref = ref.encode_ref(xs, c)
            torch.testing.assert_close(f, f_ref, rtol=enc_tol, atol=enc_tol)
            dec = ops.coded_decode(f, xs[1:], c)
            dec_ref = ref.decode_ref(f, xs[1:], c)
            torch.testing.assert_close(dec, dec_ref, rtol=dec_tol[0],
                                       atol=dec_tol[1])
            # the round trip of tests/test_kernels.py (decode of stream 0)
            rt = (1e-4, 1e-4) if dtype == torch.float32 else (1e-2, 0.15)
            torch.testing.assert_close(dec, xs[0], rtol=rt[0], atol=rt[1])
            is_f32 = dtype == torch.float32
            record("coded_encode", r, T, d, dtype, coeffs, err_of(f, f_ref),
                   _tol_text(enc_tol, enc_tol),
                   *combine_calls(torch, ops, ref, "coded_encode", xs, c, f,
                                  unit), is_main and is_f32,
                   is_rank and is_f32)
            record("coded_decode", r, T, d, dtype, coeffs,
                   err_of(dec, dec_ref), _tol_text(*dec_tol),
                   *combine_calls(torch, ops, ref, "coded_decode", xs, c, f,
                                  unit), is_main, is_rank and is_f32)
        # XOR takes no coefficients: the 0/1 gradient row is linear only
        for dtype in (torch.int32, torch.uint32) if coeffs != "0/1" else ():
            xs = torch.randint(0, 2 ** 30, (r, T, d), generator=g,
                               device=dev, dtype=torch.int32).view(dtype)
            words = xs.view(torch.int32)
            f = ops.xor_encode(xs)
            check(torch.equal(f.view(torch.int32),
                              ref.xor_encode_ref(xs).view(torch.int32)),
                  f"xor_encode r={r} T={T} d={d} {dtype}")
            dec = ops.xor_decode(f, xs[1:])
            check(torch.equal(dec.view(torch.int32), words[0]),
                  f"xor_decode r={r} T={T} d={d} {dtype}")
            is_int = dtype == torch.int32
            for name in ("xor_encode", "xor_decode"):
                record(name, r, T, d, dtype, coeffs, 0.0, "exact",
                       *combine_calls(torch, ops, ref, name, xs, None, f,
                                      True), is_main and is_int and r == 2,
                       is_rank and is_int and r == 2)
        del xs
    torch.cuda.synchronize()
    return rows, main, to_profile


def profile_main_rows(torch, ops, ref, to_profile, seed):
    """Phase 2's main rows and the ranks path's (one server's shapes): the
    kernel's and the library call's device time per call (profiler), into
    each row, on inputs drawn anew at the row's
    shape (a device time does not depend on the values; holding phase 2's
    inputs to the end would add some 1.2 GB to the serving phases' peak
    memory)."""
    g = torch.Generator(device="cuda").manual_seed(seed + 404)
    for row in to_profile:
        r, T, d, name = row["r"], row["T"], row["d"], row["name"]
        if name.startswith("coded"):
            xs = torch.randn(r, T, d, generator=g, device="cuda").to(
                getattr(torch, row["dtype"]))
            c = torch.ones(r, device="cuda")
            f = ops.coded_encode(xs, c)
        else:
            xs = torch.randint(0, 2 ** 30, (r, T, d), generator=g,
                               device="cuda", dtype=torch.int32)
            c, f = None, ops.xor_encode(xs)
        fn, _, library = combine_calls(torch, ops, ref, name, xs, c, f, True)
        row["device_ms"], _ = device_per_call(torch, fn)
        row["library_device_ms"] = (None if library is None else
                                    device_per_call(torch, library)[0])
        lib_dev = row["library_device_ms"]
        say(f"  kernel {row['name']} r={row['r']} T={row['T']} d={row['d']} "
            f"{row['dtype']}: device time per call (profiler) kernel "
            f"{row['device_ms']:.6f} ms, library "
            f"{'null' if lib_dev is None else f'{lib_dev:.6f} ms'}"
            + ("" if lib_dev is None else
               f"; kernel / library {row['device_ms'] / lib_dev:.4f}")
            + f"; bound / kernel {row['bound_ms'] / row['device_ms']:.4f}")


def ptxas_entries(log: str, needle: str):
    """``ptxas -v`` lines (entry, stack and spills, registers) of every
    entry function whose mangled name holds ``needle``."""
    out, keep = [], False
    for line in log.splitlines():
        if "Compiling entry function" in line:
            keep = needle in line
        if keep and ("Compiling entry function" in line
                     or "registers" in line or "spill" in line):
            out.append(line.strip())
    return out


# ---------------------------------------------------------------------------
# Phase 3: the stacked shuffle against the NumPy oracles
# ---------------------------------------------------------------------------

def shuffle_phase(torch, np, cc, count, make_mesh, SchemeParams, seed):
    mesh = make_mesh((P, K // P), ("rack", "server"))
    rng = np.random.default_rng(seed + 1)
    runs, total = [], dict.fromkeys(KERNELS, 0)
    for r in (2, 3):
        p = SchemeParams(K=K, P=P, Q=Q, N=N, r=r)
        plan = cc.compile_hybrid_plan(p)
        for dtype, modes in ((np.float32, ("unicast", "coded")),
                             (np.int32, ("coded_xor",))):
            hi = 100 if dtype == np.float32 else 2 ** 30
            V = rng.integers(-hi if dtype == np.float32 else 0, hi,
                             size=(N, Q, D)).astype(dtype)
            ref = cc.plan_shuffle_reference(V, p)
            ref_dev = torch.as_tensor(ref, device=mesh.device)
            local = torch.as_tensor(cc.pack_local_values(V, plan),
                                    device=mesh.device)
            for mc in modes:
                # the NumPy re-execution of the wire format is an oracle too
                check(np.array_equal(cc.simulate_plan_shuffle(V, plan, mc),
                                     ref), f"simulate r={r} {mc}")
                for impl in ("torch", "kernel"):
                    def run():
                        torch.cuda.synchronize()
                        t0 = time.perf_counter()
                        out = cc.hybrid_shuffle(local, plan, mesh, mc, impl)
                        torch.cuda.synchronize()
                        return out, (time.perf_counter() - t0) * 1e3
                    (out, ms), counts, _ = count(run)
                    tag = f"hybrid_shuffle r={r} {mc} {impl}"
                    check(torch.equal(out, ref_dev), tag)
                    check(counts == expected_launches(mc, impl,
                                                      plan.mcast_arity),
                          f"{tag} launches {counts}")
                    add_counts(total, counts)
                    runs.append({"r": r, "multicast": mc,
                                 "combine_impl": impl,
                                 "dtype": np.dtype(dtype).name, "ms": ms,
                                 "launches": counts})
                    say(f"  shuffle r={r} {mc} {impl} "
                        f"{np.dtype(dtype).name} d={D}: bit-exact, "
                        f"wall_ms={ms:.3f} launches={counts}")
            del ref_dev, local
    return runs, total


# ---------------------------------------------------------------------------
# Phase 4: the engine, fused and legacy
# ---------------------------------------------------------------------------

def engine_phase(torch, np, eng, jobs, count, make_mesh, SchemeParams,
                 costs, reconcile, seed):
    mesh = make_mesh((P, K // P), ("rack", "server"))
    rng = np.random.default_rng(seed)
    subfiles = rng.integers(0, 1 << 16, size=(N, TOKENS)).astype(np.int32)
    job = jobs.wide_histogram_job(D)
    base = SchemeParams(K=K, P=P, Q=Q, N=N, r=2)
    dense = eng.run_job(job, subfiles, base, "hybrid").outputs
    torch.cuda.synchronize()
    check(tuple(dense.shape) == (Q, D) and bool(torch.isfinite(dense).all()),
          "dense run_job output shape / finiteness")
    runs = []
    totals = {path: dict.fromkeys(KERNELS, 0) for path in ("fused", "legacy")}
    configs = [("binomial", 1), ("binomial", 2), ("binomial", 3),
               ("resolvable", 2)]
    for fused in (True, False):
        path = "fused" if fused else "legacy"
        for family, r in configs:
            p = SchemeParams(K=K, P=P, Q=Q, N=N, r=r)
            scheme = "hybrid" if family == "binomial" else \
                "hybrid_resolvable"
            closed = (costs.hybrid_cost(p) if family == "binomial"
                      else costs.hybrid_resolvable_cost(p))
            # binomial packets carry r components, resolvable ones r - 1
            arity = r if family == "binomial" else r - 1
            for mc in ("unicast", "coded"):
                for impl in ("torch", "kernel"):
                    tag = f"{path} {family} r={r} {mc} {impl}"
                    want = expected_launches(mc, impl, arity)
                    walls = []
                    for _ in range(2):              # cold, then warm
                        def run():
                            t0 = time.perf_counter()
                            res = eng.run_job_distributed(
                                job, subfiles, p, mesh, fused=fused,
                                multicast=mc, combine_impl=impl,
                                scheme_family=family)
                            return res, (time.perf_counter() - t0) * 1e3
                        (res, ms), counts, _ = count(run)
                        walls.append(ms)
                        check(counts == want, f"engine {tag} launches "
                              f"{counts}, expected {want}")
                        add_counts(totals[path], counts)
                    check(torch.equal(res.outputs, dense),
                          f"engine {tag} outputs == run_job")
                    check((res.intra_cost, res.cross_cost)
                          == (closed.intra, closed.cross),
                          f"engine {tag} costs == closed form")
                    reconcile(res.intra_rack_bytes, res.cross_rack_bytes, p,
                              scheme, d=D, check=True)
                    runs.append({"fused": fused, "family": family, "r": r,
                                 "multicast": mc, "combine_impl": impl,
                                 "cold_ms": walls[0], "warm_ms": walls[1],
                                 "launches_per_job": want})
                    say(f"  engine {tag}: bit-exact vs run_job, costs and "
                        f"rack bytes = closed form, cold_ms={walls[0]:.3f} "
                        f"warm_ms={walls[1]:.3f} launches_per_job={want}")
    return runs, totals, subfiles, job, mesh


def profile_fused(torch, eng, count, job, subfiles, mesh, SchemeParams,
                  enable_tracing):
    """Device time by kernel, and the engine's host spans, for one warm
    fused r=2 coded/kernel job; also its launch counts."""
    from torch.profiler import ProfilerActivity, profile
    p = SchemeParams(K=K, P=P, Q=Q, N=N, r=2)
    kw = dict(fused=True, multicast="coded", combine_impl="kernel")
    eng.run_job_distributed(job, subfiles, p, mesh, **kw)
    enable_tracing(True)
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            def run():
                t0 = time.perf_counter()
                res = eng.run_job_distributed(job, subfiles, p, mesh, **kw)
                return res, (time.perf_counter() - t0) * 1e3
            (res, wall_ms), counts, _ = count(run)
    finally:
        enable_tracing(False)
    check(counts == expected_launches("coded", "kernel", 2),
          f"profiled fused job launches {counts}")
    busy, by_kernel = device_time(prof)
    # the engine's engine_phase spans, host clock, in ms
    spans = {k: v * 1e3 for k, v in (res.blame or {}).items()}
    return {"wall_ms": wall_ms, "device_busy_ms": busy, "span_ms": spans,
            "launches": counts, "by_kernel": by_kernel}


def device_us(ev) -> float:
    """A profiler event's summed device time in microseconds (its field
    is ``device_time_total`` in newer torch, ``cuda_time_total`` before)."""
    dev_us = getattr(ev, "device_time_total", None)
    return getattr(ev, "cuda_time_total", 0.0) if dev_us is None else dev_us


def device_time(prof):
    """(device busy ms, the 12 largest device-time entries) of a
    torch.profiler run."""
    top = []
    for ev in prof.key_averages():
        # device-side events (the kernels and copies themselves) only, so
        # an operator and the kernels it launched are not counted twice
        if not str(getattr(ev, "device_type", "")).endswith("CUDA"):
            continue
        dev_us = device_us(ev)
        if dev_us > 0:
            top.append((dev_us / 1e3, ev.count, ev.key))
    top.sort(reverse=True)
    return (sum(t for t, _, _ in top),
            [{"ms": t, "count": c, "name": k[:100]} for t, c, k in top[:12]])


# ---------------------------------------------------------------------------
# Phase 4b: the engine under faults (the recovery ladder)
# ---------------------------------------------------------------------------

def faults_phase(torch, np, eng, count, job, subfiles, mesh, SchemeParams,
                 dg, faults, degraded_rack_bytes, smi):
    """The recovery ladder at the Table I row on phase 4's subfiles: each
    configuration under three crash schedules (degraded rungs, asked for
    the coded format on the kernels, which they must not launch), then
    every server dead on attempt 0 (the restart rung: one coded kernel
    job).  Outputs bit-identical to the failure-free fused job; walls by
    the host clock around a call ending in ``torch.cuda.synchronize()``,
    the median of three calls after a warm one."""
    runs, total = [], dict.fromkeys(KERNELS, 0)

    def timed(fn, what, faulted=True, reps=3):
        """(output of the last call, median wall ms, launches of one call):
        every counted call must launch the same kernels; the faulted
        calls' launches make the path's total."""
        fn()                                              # warm
        walls, seen = [], []
        for _ in range(reps):
            def run():
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = fn()
                torch.cuda.synchronize()
                return out, (time.perf_counter() - t0) * 1e3
            (out, ms), counts, _ = count(run)
            walls.append(ms)
            seen.append(counts)
            if faulted:
                add_counts(total, counts)
        check(all(c == seen[0] for c in seen),
              f"faults {what}: launches differ between calls {seen}")
        return out, statistics.median(walls), seen[0]

    kw = dict(multicast="coded", combine_impl="kernel")
    for family, r in (("binomial", 1), ("binomial", 2), ("binomial", 3),
                      ("resolvable", 2)):
        p = SchemeParams(K=K, P=P, Q=Q, N=N, r=r)
        clean, clean_ms, _ = timed(lambda: eng.run_job_distributed(
            job, subfiles, p, mesh, scheme_family=family, **kw),
            f"{family} r={r} failure-free", faulted=False)
        base_send = eng.compile_hybrid_plan(p, family=family).n_send
        say(f"  faults {family} r={r} failure-free fused job: "
            f"wall_ms={clean_ms:.3f} n_send={base_send} [{smi}]")
        for name, inj in (("crash(3)", faults.FaultInjector.crash((3,))),
                          ("crash(0,5)",
                           faults.FaultInjector.crash((0, 5))),
                          ("rack_crash(1)",
                           faults.FaultInjector.rack_crash(p, 1))):
            tag = f"{family} r={r} {name}"
            res, ms, counts = timed(lambda: eng.run_job_distributed(
                job, subfiles, p, mesh, scheme_family=family,
                faults=faults.FaultSpec(inj), **kw), tag)
            rep = res.recovery
            dplan = dg.compile_degraded_plan(p, rep.failed, family=family)
            n_orph = int(dplan.orphan_subfiles.size)
            check(torch.equal(res.outputs, clean.outputs),
                  f"faults {tag}: outputs == failure-free fused job")
            want_rung = "partial_remap" if n_orph else "decode_around"
            check(rep.rung == want_rung and rep.n_remapped == n_orph
                  and (n_orph > 0) == (rep.rung == "partial_remap"),
                  f"faults {tag}: rung {rep.rung} n_remapped "
                  f"{rep.n_remapped}, expected {want_rung} {n_orph}")
            check(counts == expected_launches(kw["multicast"],
                                              kw["combine_impl"], r,
                                              rep.rung),
                  f"faults {tag}: a degraded rung launched {counts}")
            rb = degraded_rack_bytes(dplan, D)
            check((res.intra_rack_bytes, res.cross_rack_bytes)
                  == (rb.intra_total, rb.cross_total),
                  f"faults {tag}: rack bytes == degraded_rack_bytes")
            patch_bytes = (K * p.subfiles_per_layer * (Q // P) * D * 4
                           if n_orph else 0)
            runs.append({"family": family, "r": r, "schedule": name,
                         "failed": list(rep.failed), "rung": rep.rung,
                         "n_remapped": rep.n_remapped, "wall_ms": ms,
                         "clean_wall_ms": clean_ms,
                         "n_send": dplan.plan.n_send,
                         "base_n_send": base_send,
                         "patch_bytes": patch_bytes,
                         "cross_rack_bytes": res.cross_rack_bytes,
                         "launches": counts})
            say(f"  faults {tag}: {rep.rung} n_remapped={rep.n_remapped} "
                f"bit-exact, wall_ms={ms:.3f} (failure-free "
                f"{clean_ms:.3f}) n_send={dplan.plan.n_send} "
                f"patch_bytes={patch_bytes} launches={counts} [{smi}]")
        del clean
    # every server dead on attempt 0: the restart rung reruns the
    # failure-free coded kernel job
    p = SchemeParams(K=K, P=P, Q=Q, N=N, r=2)
    clean = eng.run_job_distributed(job, subfiles, p, mesh, **kw)
    spec = faults.FaultSpec(faults.FaultInjector.crash(tuple(range(K))),
                            max_restarts=2)
    res, ms, counts = timed(lambda: eng.run_job_distributed(
        job, subfiles, p, mesh, faults=spec, **kw), "all dead")
    rep = res.recovery
    check(rep.rung == "restart" and rep.restarts == 1
          and len(rep.backoff_delays) == 1,
          f"faults all dead: {rep}")
    check(torch.equal(res.outputs, clean.outputs),
          "faults all dead: outputs == failure-free fused job")
    check(counts == expected_launches("coded", "kernel", 2, rep.rung),
          f"faults all dead: restart launches {counts}")
    runs.append({"family": "binomial", "r": 2, "schedule": "all dead",
                 "rung": rep.rung, "restarts": rep.restarts,
                 "backoff_delays": list(rep.backoff_delays),
                 "wall_ms": ms, "launches": counts})
    say(f"  faults binomial r=2 all {K} dead: restart restarts=1 "
        f"backoff_s={rep.backoff_delays[0]:.6f} (recorded, not slept) "
        f"bit-exact, wall_ms={ms:.3f} launches={counts} [{smi}]")
    # one phase-timing row at the same configuration
    row = eng.measure_phase_timings(job, subfiles, p, mesh, iters=3)
    secs = dict(row["seconds"], shuffle=row["meta"]["shuffle_s"])
    check(row["meta"]["backend"] == "cuda"
          and all(math.isfinite(v) and v > 0 for v in secs.values()),
          f"measure_phase_timings: every phase finite and > 0: {secs}")
    say("  measure_phase_timings binomial r=2 (ms): " + " ".join(
        f"{k}={v * 1e3:.3f}" for k, v in secs.items()) + f" [{smi}]")
    return runs, total, row


# ---------------------------------------------------------------------------
# Phase 4c: the process form, one server a rank (16 ranks on the card)
# ---------------------------------------------------------------------------

# (fused, family, r, multicast, combine_impl) of every ranks job
RANK_JOBS = ([(True, "binomial", r, mc, impl) for r in (1, 2, 3)
              for mc, impl in (("unicast", "torch"), ("coded", "kernel"))]
             + [(True, "resolvable", 2, "coded", "kernel"),
                (False, "binomial", 2, "coded", "kernel")])
# one Qwen2-1.5B MLP projection: 1536 x 8960 gradient entries a chunk
GRAD_G = 1536 * 8960


def _device_sync(torch, dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _grad_chunk(np, coefs, c: int, lo: int, hi: int):
    """Entries [lo, hi) of gradient chunk ``c``: integer-valued float32 in
    [-1019, 1019] (six chunks sum exactly in any order), from the seeded
    ``coefs``; any slice is made without the rest of the chunk."""
    a, b = (int(v) for v in coefs[c])
    idx = np.arange(lo, hi, dtype=np.int64)
    return ((idx * a + b) % 2039 - 1019).astype(np.float32)


def _xor_payload(np, seed: int, size):
    """The int32 shuffle payload V[n, q, :] = base[n, q] ^ col, from
    ``seed``: any rows are made without the rest."""
    K_, P_, Q_, N_, D_ = size
    rng = np.random.default_rng(seed + 2)
    return (rng.integers(0, 2 ** 30, size=(N_, Q_), dtype=np.int64),
            rng.integers(0, 2 ** 30, size=D_, dtype=np.int64))


def ranks_rank(dev, seed: int, size, tokens: int, grad_G: int):
    """What each rank of phase 4c runs (module level: the ranks import it
    by name).  Every timed call starts after a barrier, with the launch
    counts zeroed just before it and read just after."""
    import hashlib
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.core import coded_collectives as cc
    from repro_torch.core import gradient_sync as gs
    from repro_torch.core.params import SchemeParams
    from repro_torch.distributed.collectives import all_to_all
    from repro_torch.distributed.meshes import make_process_mesh
    from repro_torch.kernels.coded_combine import ops
    from repro_torch.mapreduce import engine as eng
    from repro_torch.mapreduce import jobs
    from repro_torch.obs.tracing import enable_tracing

    t_ready = time.time()
    enable_tracing(True)               # this rank's engine spans (blame)
    K_, P_, Q_, N_, D_ = size
    mesh = make_process_mesh((P_, K_ // P_), ("rack", "server"), device=dev)
    dist.barrier()
    t_mesh = time.time()
    i, j = mesh.coords

    def timed(fn, reps=3):
        """(last output, host ms of each call, launches of each call)."""
        fn()                                                  # warm
        walls, launches = [], []
        for _ in range(reps):
            dist.barrier()
            ops.reset_launch_counts()
            _device_sync(torch, dev)
            t0 = time.perf_counter()
            out = fn()
            _device_sync(torch, dev)
            walls.append((time.perf_counter() - t0) * 1e3)
            launches.append(dict(ops.LAUNCHES))
        return out, walls, launches

    # the engine, on phase 4's subfiles (each rank draws them from --seed)
    subfiles = np.random.default_rng(seed).integers(
        0, 1 << 16, size=(N_, tokens)).astype(np.int32)
    job = jobs.wide_histogram_job(D_)
    res_jobs = {}
    for cfg in RANK_JOBS:
        fused, family, r, mc, impl = cfg
        p = SchemeParams(K=K_, P=P_, Q=Q_, N=N_, r=r)
        res, walls, launches = timed(lambda: eng.run_job_distributed(
            job, subfiles, p, mesh, fused=fused, multicast=mc,
            combine_impl=impl, scheme_family=family))
        res_jobs[cfg] = {"outputs": res.outputs.cpu(),
                         "device": res.outputs.device.type,
                         "spans_s": res.blame,
                         "costs": (res.intra_cost, res.cross_cost,
                                   res.intra_rack_bytes,
                                   res.cross_rack_bytes),
                         "walls_ms": walls, "launches": launches}
    del subfiles

    # the exchanges alone at the r = 2 shuffle's shapes: stage 1 over
    # 'rack' ([P * n_send, q_rack, d]), stage 2 over 'server' ([Kr,
    # n_layer, q_srv, d]), float32
    p = SchemeParams(K=K_, P=P_, Q=Q_, N=N_, r=2)
    plan = cc.compile_hybrid_plan(p)
    stage1 = torch.zeros((P_ * plan.n_send, Q_ // P_, D_), device=dev)
    stage2 = torch.zeros((p.Kr, p.subfiles_per_layer, Q_ // K_, D_),
                         device=dev)
    _, s1_ms, _ = timed(lambda: all_to_all(stage1, mesh, "rack"))
    _, s2_ms, _ = timed(lambda: all_to_all(stage2, mesh, "server"))
    del stage1, stage2

    # the coded_xor shuffle at r = 2 on int32 payloads, held in the rank
    # against its rows of the NumPy reference
    base, col = _xor_payload(np, seed, size)
    local = (base[plan.local_subfiles[i, j]][..., None] ^ col).astype(
        np.int32)                                             # [n_loc, Q, d]
    order = cc.reduce_ready_order(plan)[i, j]                 # [N]
    keys = list(p.keys_of_server(mesh.rank))
    want = (base[order][:, keys][..., None] ^ col).astype(np.int32)
    out, xor_ms, xor_launches = timed(lambda: cc.hybrid_shuffle(
        local, plan, mesh, "coded_xor", "kernel"))
    out = out.cpu().numpy()
    xor = {"exact": bool(np.array_equal(out, want)),
           "sha256": hashlib.sha256(out.tobytes()).hexdigest(),
           "walls_ms": xor_ms, "launches": xor_launches}
    del local, want, out

    # the coded gradient reduce-scatter: this rack's P - 1 chunks on the
    # card, its shard of the total from NumPy
    coefs = np.random.default_rng(seed + 3).integers(1, 2 ** 20, size=(6, 2))
    rack = mesh.axis_index("rack")
    shard = grad_G // P_
    total = sum(_grad_chunk(np, coefs, c, rack * shard, (rack + 1) * shard)
                for c in range(6))
    idx = torch.arange(grad_G, dtype=torch.int64, device=dev)
    cg = torch.stack([((idx * int(coefs[c][0]) + int(coefs[c][1])) % 2039
                       - 1019).to(torch.float32)
                      for c in gs.chunk_index_table(P_)[rack]])   # [P-1, G]
    del idx
    grad = {}
    for failed in (None, 3):
        got, ms, launches = timed(lambda: gs.coded_reduce_scatter_r2(
            cg, mesh, "rack", P_, failed=failed, combine_impl="kernel"))
        grad[failed] = {"exact": bool(np.array_equal(got.cpu().numpy(),
                                                     total)),
                        "survivor": rack != failed, "device": got.device.type,
                        "walls_ms": ms, "launches": launches}
    return {"rank": mesh.rank, "t_ready": t_ready, "t_mesh": t_mesh,
            "device": str(dev), "jobs": res_jobs, "xor": xor, "grad": grad,
            "stage1_ms": s1_ms, "stage2_ms": s2_ms}


def _max_median(walls_by_rank):
    """Median over calls of the slowest rank's wall in each call."""
    return statistics.median(max(call) for call in zip(*walls_by_rank))


def ranks_phase(torch, np, eng, cc, run_ranks, make_mesh, SchemeParams,
                costs, dev, size, tokens, grad_G, seed, subfiles, smi):
    """Phase 4c: 16 ranks on one card (gloo: NCCL refuses two ranks on one
    device), spawned once; see :func:`ranks_rank` for what each runs.
    Holds every rank's job outputs bit for bit against the stacked job's
    (timed here the same way: median of three after a warm call) and
    ``dense``, its shuffle against the stacked shuffle's rows, its launches
    against one server's, and its device.  ``subfiles`` are phase 4's,
    which every rank draws from ``seed`` itself."""
    import hashlib
    from repro_torch.kernels.coded_combine import ops
    from repro_torch.mapreduce import jobs

    K_, P_, Q_, N_, D_ = size
    mesh = make_mesh((P_, K_ // P_), ("rack", "server"), device=dev)
    job = jobs.wide_histogram_job(D_)
    dense = eng.run_job(job, subfiles, SchemeParams(K=K_, P=P_, Q=Q_, N=N_,
                                                    r=2), "hybrid",
                        device=dev).outputs

    def stacked_timed(fn):
        fn()
        walls = []
        for _ in range(3):
            _device_sync(torch, dev)
            t0 = time.perf_counter()
            out = fn()
            _device_sync(torch, dev)
            walls.append((time.perf_counter() - t0) * 1e3)
        return out, statistics.median(walls)

    stacked = {}
    for cfg in RANK_JOBS:
        fused, family, r, mc, impl = cfg
        p = SchemeParams(K=K_, P=P_, Q=Q_, N=N_, r=r)
        stacked[cfg] = stacked_timed(lambda: eng.run_job_distributed(
            job, subfiles, p, mesh, fused=fused, multicast=mc,
            combine_impl=impl, scheme_family=family))
    p2 = SchemeParams(K=K_, P=P_, Q=Q_, N=N_, r=2)
    plan = cc.compile_hybrid_plan(p2)
    base, col = _xor_payload(np, seed, size)
    V = torch.as_tensor(cc.pack_local_values(
        (base[..., None] ^ col).astype(np.int32), plan), device=dev)
    xor_out, xor_stacked_ms = stacked_timed(lambda: cc.hybrid_shuffle(
        V, plan, mesh, "coded_xor", "kernel"))
    xor_digests = [hashlib.sha256(o.cpu().numpy().tobytes()).hexdigest()
                   for o in xor_out]
    del V, xor_out

    t0 = time.time()
    per_rank = run_ranks(ranks_rank, K_, backend="gloo", device=dev.type,
                         args=(seed, size, tokens, grad_G), timeout_s=600)
    wall_s = time.time() - t0
    ready_s = max(r["t_ready"] for r in per_rank) - t0
    mesh_s = max(r["t_mesh"] for r in per_rank) - t0
    total = dict.fromkeys(KERNELS, 0)
    rows = []
    for rank, res in enumerate(per_rank):
        check(res["rank"] == rank and res["device"].startswith(dev.type),
              f"ranks: rank {rank} ran as {res['rank']} on {res['device']}")
    for cfg in RANK_JOBS:
        fused, family, r, mc, impl = cfg
        p = SchemeParams(K=K_, P=P_, Q=Q_, N=N_, r=r)
        closed = (costs.hybrid_cost(p) if family == "binomial"
                  else costs.hybrid_resolvable_cost(p))
        arity = r if family == "binomial" else r - 1
        want = expected_launches(mc, impl, arity)
        tag = (f"{'fused' if fused else 'legacy'} {family} r={r} {mc} "
               f"{impl}")
        s_out, s_ms = stacked[cfg]
        check(torch.equal(s_out.outputs, dense),
              f"ranks {tag}: stacked outputs == run_job")
        ref = s_out.outputs.cpu()
        for rank, res in enumerate(per_rank):
            got = res["jobs"][cfg]
            check(got["device"] == dev.type and torch.equal(got["outputs"],
                                                            ref),
                  f"ranks {tag}: rank {rank}'s outputs == the stacked job's "
                  f"and run_job's, on {got['device']}")
            check(got["costs"][:2] == (closed.intra, closed.cross)
                  and got["costs"][2:] == (s_out.intra_rack_bytes,
                                           s_out.cross_rack_bytes),
                  f"ranks {tag}: rank {rank}'s costs {got['costs']}")
            for counts in got["launches"]:
                check(counts == want, f"ranks {tag}: rank {rank} launched "
                      f"{counts}, one server's are {want}")
                add_counts(total, counts)
        ms = _max_median([res["jobs"][cfg]["walls_ms"] for res in per_rank])
        # the engine's spans of the last timed call, slowest rank each
        spans = {k: max(res["jobs"][cfg]["spans_s"][k] for res in per_rank)
                 * 1e3 for k in per_rank[0]["jobs"][cfg]["spans_s"]}
        rows.append({"config": tag, "ranks_wall_ms": ms,
                     "stacked_wall_ms": s_ms, "span_ms": spans,
                     "launches_per_rank": want})
        say(f"  ranks {tag}: {K_} ranks bit-exact vs the stacked job and "
            f"run_job, wall_ms={ms:.3f} (stacked {s_ms:.3f}) spans (host "
            f"ms, slowest rank) " + " ".join(f"{k}={v:.3f}" for k, v in
                                             spans.items())
            + f" launches_per_rank={want} [{smi}]")
    # the coded_xor shuffle
    want = expected_launches("coded_xor", "kernel", 2)
    for rank, res in enumerate(per_rank):
        x = res["xor"]
        check(x["exact"] and x["sha256"] == xor_digests[rank],
              f"ranks coded_xor shuffle: rank {rank} == the reference and "
              f"the stacked shuffle's rows")
        for counts in x["launches"]:
            check(counts == want, f"ranks coded_xor: rank {rank} launched "
                  f"{counts}")
            add_counts(total, counts)
    xor_ms = _max_median([res["xor"]["walls_ms"] for res in per_rank])
    say(f"  ranks hybrid_shuffle r=2 coded_xor kernel int32 d={D_}: "
        f"bit-exact vs the reference and the stacked shuffle, "
        f"wall_ms={xor_ms:.3f} (stacked {xor_stacked_ms:.3f}) "
        f"launches_per_rank={want} [{smi}]")
    # the gradient reduce-scatter
    grad_rows = {}
    for failed in (None, 3):
        want = dict(dict.fromkeys(KERNELS, 0), coded_encode=P_)
        for rank, res in enumerate(per_rank):
            g = res["grad"][failed]
            check(g["device"] == dev.type and
                  (g["exact"] or not g["survivor"]),
                  f"ranks coded_reduce_scatter_r2 failed={failed}: rank "
                  f"{rank}'s shard == the NumPy total")
            for counts in g["launches"]:
                check(counts == want, f"ranks coded_reduce_scatter_r2: rank "
                      f"{rank} launched {counts}")
                add_counts(total, counts)
        ms = _max_median([res["grad"][failed]["walls_ms"]
                          for res in per_rank])
        grad_rows[str(failed)] = ms
        say(f"  ranks coded_reduce_scatter_r2 kernel G={grad_G} "
            f"failed={failed}: every survivor's shard == the NumPy total, "
            f"wall_ms={ms:.3f} launches_per_rank={want} [{smi}]")
    s1 = _max_median([res["stage1_ms"] for res in per_rank])
    s2 = _max_median([res["stage2_ms"] for res in per_rank])
    say(f"  ranks exchanges alone at the r=2 shapes: stage 1 over 'rack' "
        f"{s1:.3f} ms, stage 2 over 'server' {s2:.3f} ms [{smi}]")
    say(f"  ranks spawn and rendezvous: every rank in its world "
        f"{ready_s:.3f} s and its mesh {mesh_s:.3f} s after the spawn; "
        f"the phase's ranks ran {wall_s:.3f} s")
    say("  ranks collectives: dist.all_to_all_single and dist.all_gather on "
        "CUDA tensors (gloo); staged through the host: none")
    say(f"  ranks nccl: not run: {torch.cuda.device_count()} card(s) here "
        f"and NCCL refuses two ranks on one device; run_ranks(backend="
        f"'nccl') puts rank k on cuda:k and needs a card a rank")
    return {"jobs": rows, "xor_wall_ms": xor_ms,
            "xor_stacked_wall_ms": xor_stacked_ms,
            "grad_wall_ms": grad_rows, "grad_G": grad_G,
            "stage1_ms": s1, "stage2_ms": s2, "ready_s": ready_s,
            "mesh_s": mesh_s, "ranks_s": wall_s, "staged": [],
            "nccl": "not run: one card"}, total


# ---------------------------------------------------------------------------
# Phase 4d: Section IV — placement, the simulator it feeds, a placed job
# ---------------------------------------------------------------------------

TABLE2_SOLVERS = ("random", "greedy", "flow", "local_search", "anneal")
DETERMINISTIC = ("random", "greedy", "flow", "local_search")
STAT_FIELDS = ("node_mean", "node_std", "rack_mean", "rack_std",
               "objective_mean")
# BENCH_locality.json was written by the JAX package's
# benchmarks/table2_locality.py from the same NumPy draws and arithmetic,
# so its statistics and simulated JCTs are expected bit-equal.  The 1e-12
# relative tolerance only leaves room for a NumPy on this machine that
# rounds the last place of a mean or std of five float64 values
# differently; any solver difference moves them by 1e-3 or more.
BENCH_RTOL = 1e-12


def _close(a: float, b: float) -> bool:
    return abs(a - b) <= BENCH_RTOL * max(abs(a), abs(b))


def table2_phase(np, pl, sim, SchemeParams, smi):
    """Phase 4d (a): the ten Table II rows of ``BENCH_locality.json`` with
    the benchmark's solver settings, the annealer on the card."""
    bench = json.loads((ROOT / "BENCH_locality.json").read_text())
    cl = bench["time_units_cluster"]
    kw = {"anneal": {"init_solvers": ("flow", "greedy"), "n_chains": 64,
                     "n_steps": 1000, "device": "cuda"},
          "local_search": {"max_sweeps": 20}}
    rows, exact = [], True
    for row, trow in zip(bench["table2"], bench["table2_time_units"]):
        K_, P_, r_f, N_ = row["params"]
        check(trow["params"] == row["params"],
              f"BENCH_locality.json rows align: {trow['params']}")
        p = SchemeParams(K=K_, P=P_, Q=K_, N=N_, r=2, r_f=r_f)
        t0 = time.perf_counter()
        res = pl.table2_trials(p, lam=bench["lam"], seed=bench["seed"],
                               n_trials=bench["n_trials"],
                               solvers=TABLE2_SOLVERS, per_solver_kwargs=kw)
        solve_s = time.perf_counter() - t0
        s = res.stats
        tag = f"table2 {tuple(row['params'])}"
        for name in DETERMINISTIC:
            for f in STAT_FIELDS:
                got, want = getattr(s[name], f), row["solvers"][name][f]
                check(_close(got, want), f"{tag} {name} {f} {got!r} == "
                      f"BENCH_locality.json's {want!r}")
                exact = exact and got == want
        a, fl = s["anneal"], s["flow"]
        check(a.objective_mean >= fl.objective_mean - 1e-6
              and a.node_mean >= fl.node_mean,
              f"{tag} anneal {a.objective_mean} / {a.node_mean} >= flow "
              f"{fl.objective_mean} / {fl.node_mean}")
        for name in TABLE2_SOLVERS[1:]:
            check(s[name].node_mean > s["random"].node_mean,
                  f"{tag} {name} node locality beats random's")
        topo = sim.RackTopology(P_, cross_bw=cl["cross_bw"],
                                intra_bw=cl["intra_bw"])
        cost = sim.CostModel(map=sim.PhaseCoeffs(0.0, cl["map_beta"]))
        t1 = time.perf_counter()
        gaps = [pl.jct_gap(t["flow"], t["random"], topo, cost_model=cost)
                for t in res.trials]
        sim_s = time.perf_counter() - t1
        j_ran = float(np.mean([g[0] for g in gaps]))
        j_opt = float(np.mean([g[1] for g in gaps]))
        check(_close(j_ran, trow["mean_jct_random"])
              and _close(j_opt, trow["mean_jct_flow"]),
              f"{tag} jct_gap means {j_ran!r}, {j_opt!r} == "
              f"BENCH_locality.json's {trow['mean_jct_random']!r}, "
              f"{trow['mean_jct_flow']!r}")
        exact = exact and (j_ran, j_opt) == (trow["mean_jct_random"],
                                             trow["mean_jct_flow"])
        check(j_opt < j_ran, f"{tag} optimized JCT {j_opt} < random {j_ran}")
        walls = {n: s[n].wall_s_mean * 1e3 for n in TABLE2_SOLVERS}
        rows.append({"params": row["params"],
                     "node_mean": {n: s[n].node_mean for n in TABLE2_SOLVERS},
                     "objective_mean": {n: s[n].objective_mean
                                        for n in TABLE2_SOLVERS},
                     "solver_wall_ms": walls, "mean_jct_random": j_ran,
                     "mean_jct_flow": j_opt, "solve_s": solve_s,
                     "sim_s": sim_s})
        say(f"  {tag}: deterministic solvers and jct_gap == "
            f"BENCH_locality.json; node % random/greedy/flow/local_search/"
            f"anneal " + "/".join(f"{100 * s[n].node_mean:.2f}"
                                  for n in TABLE2_SOLVERS)
            + f"; anneal obj {a.objective_mean:.4f} >= flow "
            f"{fl.objective_mean:.4f}; wall ms per call " + " ".join(
                f"{n}={w:.3f}" for n, w in walls.items())
            + f"; jct {j_ran:.6f} -> {j_opt:.6f} s; {solve_s:.3f} s solve, "
            f"{sim_s:.3f} s sim [{smi}]")
    return rows, exact


def placed_phase(torch, np, pl, sim, eng, cc, count, job, subfiles, mesh,
                 SchemeParams, hybrid_assignment, reconcile, seed, smi):
    """Phase 4d (b): the Table I row under an annealed placement.  HDFS
    replicas (r_f = 3) from ``seed``, greedy then the annealer on the card
    (warm start greedy, 64 chains, 1500 steps), then the fused coded
    kernel job under the placement on phase 4's subfiles against the
    identity placement and ``run_job``, and the simulated JCT of the
    placement against a random one of the same instance."""
    from repro_torch.placement.solvers import anneal_chains
    from repro_torch.core.assignment import hybrid_group_of_slot

    dense = eng.run_job(job, subfiles, SchemeParams(K=K, P=P, Q=Q, N=N, r=2),
                        "hybrid").outputs
    topo = sim.RackTopology(P, cross_bw=1e4, intra_bw=1e5)
    cost = sim.CostModel(map=sim.PhaseCoeffs(0.0, 1e-8))
    rows, total = [], dict.fromkeys(KERNELS, 0)
    for r in (2, 3):
        p = SchemeParams(K=K, P=P, Q=Q, N=N, r=r, r_f=3)
        replicas = pl.place_replicas(p, np.random.default_rng(seed), "hdfs")
        C = pl.locality_matrix(p, replicas)
        greedy = pl.solve(p, replicas, "greedy", C=C)
        tag = f"placed binomial r={r} N={N} C={C.shape[0]}x{C.shape[1]}"
        # the chains alone at the same size, from greedy and random starts
        gos = torch.as_tensor(hybrid_group_of_slot(p), dtype=torch.int64,
                              device="cuda")
        base = torch.as_tensor(np.stack([greedy.perm] + [
            np.random.default_rng(seed + k).permutation(N)
            for k in range(1, 64)]), device="cuda")
        Ct = torch.as_tensor(C, dtype=torch.float32, device="cuda")
        temps = torch.as_tensor(np.geomspace(1.0, 1e-3, 1500),
                                dtype=torch.float32, device="cuda")
        gen = torch.Generator(device="cuda")
        gen.manual_seed(seed)
        if r == 2:
            chains_profile = profile_chains(
                torch, anneal_chains, (base.clone(), Ct, gos, temps[:200],
                                       gen), smi)
        ann = pl.solve(p, replicas, "anneal", C=C,
                       rng=pl.solver_rng(seed, "anneal"),
                       init=[greedy.perm], n_chains=64, n_steps=1500,
                       device="cuda")
        check(ann.objective >= greedy.objective,
              f"{tag}: anneal objective {ann.objective} >= greedy "
              f"{greedy.objective}")
        # one host read at the end, none in the step loop (a synchronising
        # call would raise here)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        torch.cuda.set_sync_debug_mode("error")
        try:
            best = anneal_chains(base, Ct, gos, temps, gen)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        queued_ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        chains_ms = (time.perf_counter() - t0) * 1e3
        check(bool((best.sort(dim=1).values
                    == torch.arange(N, device="cuda")).all()),
              f"{tag}: the chains' best are permutations")
        # the job under the placement, against the identity placement
        check(not np.array_equal(ann.perm, np.arange(N)),
              f"{tag}: the placement moves subfiles")
        plan = cc.compile_hybrid_plan(p, perm=ann.perm)
        a = hybrid_assignment(p, ann.perm.tolist())
        for i in range(P):
            for j in range(K // P):
                check(sorted(plan.local_subfiles[i, j].tolist())
                      == sorted(a.subfiles_of_server[p.server_id(i, j)]),
                      f"{tag}: server ({i}, {j}) maps the placement's "
                      f"subfiles")
        want = expected_launches("coded", "kernel", r)
        kw = dict(fused=True, multicast="coded", combine_impl="kernel")
        walls = {}
        for name, placement in (("identity", None), ("placed", ann)):
            ms_list = []
            for _ in range(4):              # a warm call, then three timed
                def run():
                    t1 = time.perf_counter()
                    res = eng.run_job_distributed(job, subfiles, p, mesh,
                                                  placement=placement, **kw)
                    torch.cuda.synchronize()
                    return res, (time.perf_counter() - t1) * 1e3
                (res, ms), counts, _ = count(run)
                check(counts == want, f"{tag} {name}: launches {counts}, "
                      f"phase 4's fused r={r} coded kernel job {want}")
                if name == "placed":
                    add_counts(total, counts)
                ms_list.append(ms)
            walls[name] = statistics.median(ms_list[1:])
            check(torch.equal(res.outputs, dense),
                  f"{tag} {name}: outputs == run_job")
            reconcile(res.intra_rack_bytes, res.cross_rack_bytes, p,
                      "hybrid", d=D, check=True)
            if name == "identity":
                ident = res.outputs
        check(torch.equal(res.outputs, ident),
              f"{tag}: placed outputs == the identity placement's")
        ran = pl.solve(p, replicas, "random", C=C,
                       rng=pl.solver_rng(seed, "random"))
        t1 = time.perf_counter()
        j_opt = pl.simulate_placement(ann, topo, cost_model=cost).jct
        j_ran = pl.simulate_placement(ran, topo, cost_model=cost).jct
        sim_ms = (time.perf_counter() - t1) * 1e3
        check(j_opt < j_ran, f"{tag}: simulated JCT {j_opt} < random's "
              f"{j_ran}")
        rows.append({"r": r, "greedy": {"objective": greedy.objective,
                                        "node": greedy.node_locality,
                                        "rack": greedy.rack_locality,
                                        "wall_ms": greedy.wall_s * 1e3},
                     "anneal": {"objective": ann.objective,
                                "node": ann.node_locality,
                                "rack": ann.rack_locality,
                                "wall_ms": ann.wall_s * 1e3},
                     "random": {"node": ran.node_locality,
                                "rack": ran.rack_locality},
                     "chains_ms": chains_ms, "chains_queued_ms": queued_ms,
                     "identity_wall_ms": walls["identity"],
                     "placed_wall_ms": walls["placed"],
                     "launches_per_job": want, "jct_random": j_ran,
                     "jct_anneal": j_opt, "sim_ms": sim_ms})
        say(f"  {tag}: greedy obj {greedy.objective:.4f} node "
            f"{100 * greedy.node_locality:.2f}% rack "
            f"{100 * greedy.rack_locality:.2f}% ({greedy.wall_s * 1e3:.3f} "
            f"ms); anneal on cuda obj {ann.objective:.4f} node "
            f"{100 * ann.node_locality:.2f}% rack "
            f"{100 * ann.rack_locality:.2f}% ({ann.wall_s * 1e3:.3f} ms a "
            f"call; the chains alone {chains_ms:.3f} ms, "
            f"{chains_ms / 1500 * 1e3:.1f} us a step, queued in "
            f"{queued_ms:.3f} ms with no synchronisation) [{smi}]")
        say(f"  {tag}: fused coded kernel job under the placement bit-exact "
            f"vs the identity placement and run_job, every server maps the "
            f"placement's subfiles, rack bytes = closed form, "
            f"launches_per_job={want}; wall_ms placed {walls['placed']:.3f} "
            f"identity {walls['identity']:.3f} (median of three after a "
            f"warm call) [{smi}]")
        say(f"  {tag}: simulated JCT anneal {j_opt:.6f} s < random "
            f"{j_ran:.6f} s (node {100 * ran.node_locality:.2f}%), "
            f"RackTopology(P={P}, cross_bw=1e4, intra_bw=1e5), map beta "
            f"1e-8; {sim_ms:.3f} ms [{smi}]")
    return rows, total, chains_profile


def profile_chains(torch, anneal_chains, to_profile, smi):
    """The card's busy time under 200 profiled steps of phase 4d's r = 2
    chains."""
    from torch.profiler import ProfilerActivity, profile
    best, Ct, gos, temps, gen = to_profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        anneal_chains(best.clone(), Ct, gos, temps, gen)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    busy_ms, top = device_time(prof)
    check(busy_ms > 0, "the annealer's chains ran on the card")
    say(f"  anneal chains, {temps.shape[0]} profiled steps at the Table I "
        f"row (r=2): device busy {busy_ms:.3f} of {wall_ms:.3f} ms, idle "
        f"share {1 - busy_ms / wall_ms:.3f}; the largest: " + ", ".join(
            f"{k['name'][:40]} {k['ms']:.3f} ms x{k['count']}"
            for k in top[:4]) + f" [{smi}]")
    return {"steps": int(temps.shape[0]), "wall_ms": wall_ms,
            "device_busy_ms": busy_ms, "top": top}


# ---------------------------------------------------------------------------
# Phase 4e: the scheduler, drift, calibration and the resilience policies
# ---------------------------------------------------------------------------

# The settings of the JAX package's benchmarks/sim_bench.py,
# calibration_bench.py and resilience_bench.py, which wrote
# BENCH_sim.json, BENCH_calibration.json and BENCH_resilience.json: kept
# here because the card machine has no JAX.  The CPU tests
# (tests/test_torch_scheduler.py, test_torch_calibration.py,
# test_torch_resilience.py) pin this copy to the benches at their --smoke
# sizes.  The functions take the simulator's modules as arguments, so the
# same code runs over the port's and, in those tests, the JAX package's.
SCHED_K, SCHED_P = 8, 4
SIM_INTRA_BW, SIM_CROSS_BW = 1e7, 1e6
SIM_FIXED_BASELINES = (("coded", 2), ("hybrid", 2), ("uncoded", 1))
SIM_SIZES = {False: {"n_jobs": 100, "scales": (0.0, 0.5, 1.5),
                     "ratios": (0.02, 0.1, 0.5, 1.0),
                     "rates": (0.5, 2.0, 8.0), "n_seeds": 20},
             True: {"n_jobs": 40, "scales": (0.0, 1.0),
                    "ratios": (0.05, 1.0), "rates": (1.0, 8.0),
                    "n_seeds": 5}}
CAL_SHIFT_FACTOR = 3.0
# (n_jobs, t_shift) of the drift and of the determinism sections
CAL_DRIFT = {False: (60, 15.0), True: (30, 8.0)}
CAL_DETERMINISM = {False: (40, 10.0), True: (20, 6.0)}
RES_INTRA_BW, RES_CROSS_BW = 1e7, 1e6
# phase 4e gates the frontier cells of these leading Table I rows (the
# whole grid takes minutes on a host)
RES_ROWS = 3
# hedged_vs_static: (n_jobs, n_probe)
RES_HEDGED = {False: (80, 30), True: (30, 15)}
# the calibration bench's phase-fit grid (N, r, d) at K=8, P=4, Q=16, and
# its conformance grid (N, Q, d) x r with its tolerance band (set on CPU
# walls of the JAX package's fused pipeline)
CAL_GRID_POINTS = [(48, 2, 256), (48, 2, 1024), (96, 2, 512), (96, 2, 2048),
                   (96, 3, 1024), (192, 2, 1024)]
CONFORMANCE_SIZES = [(96, 16, 2048), (96, 16, 512), (192, 16, 1024)]
CONFORMANCE_RS = (1, 2, 3)
CONFORMANCE_TOL = 0.35
CONFORMANCE_TOKENS = 256
# the annealer stream of phase 4e (e): jobs of default_catalog(8, 4),
# chosen so the stream's replay with the annealer on the CPU stays well
# under 30 s
ANNEAL_STREAM_JOBS = 8
# its root switch 100x slower than the racks' aggregate: the server-rack
# regime, where hybrid admissions (each one placed) win
ANNEAL_STREAM_CROSS_BW = 1e5


def sim_default_cost(sim):
    """``benchmarks/sim_bench.py``'s ``DEFAULT_COST``."""
    return sim.CostModel(map=sim.PhaseCoeffs(alpha=2e-3, beta=5e-9),
                         pack=sim.PhaseCoeffs(alpha=5e-4, beta=2e-9),
                         reduce=sim.PhaseCoeffs(alpha=1e-3, beta=5e-9),
                         plan_compile=sim.PhaseCoeffs(alpha=5e-3,
                                                      beta=1e-6))


def res_bench_cost(sim):
    """``benchmarks/resilience_bench.py``'s ``BENCH_COST``."""
    return sim.CostModel(map=sim.PhaseCoeffs(alpha=1e-4, beta=2e-8),
                         pack=sim.PhaseCoeffs(alpha=5e-5, beta=1e-8),
                         reduce=sim.PhaseCoeffs(alpha=1e-4, beta=2e-8),
                         plan_compile=sim.PhaseCoeffs(alpha=5e-3,
                                                      beta=1e-6))


def cal_stale_cost(sim):
    """``benchmarks/calibration_bench.py``'s ``STALE_COST``."""
    return sim.CostModel(map=sim.PhaseCoeffs(1e-3, 5e-7),
                         pack=sim.PhaseCoeffs(5e-4, 2e-7),
                         reduce=sim.PhaseCoeffs(1e-3, 5e-7))


def bench_diff(got, want, path="", rtol=BENCH_RTOL):
    """Where ``got`` differs from a committed bench document: floats beyond
    ``rtol`` relative, anything else (keys, lengths, ints, bools, strings)
    at all."""
    if isinstance(want, dict):
        if not isinstance(got, dict) or set(got) != set(want):
            keys = sorted(got) if isinstance(got, dict) else got
            return [f"{path}: keys {keys!r} != {sorted(want)}"]
        return [d for k in sorted(want)
                for d in bench_diff(got[k], want[k], f"{path}.{k}", rtol)]
    if isinstance(want, list):
        if not isinstance(got, (list, tuple)) or len(got) != len(want):
            return [f"{path}: {got!r} != {want!r}"]
        return [d for i, (g, w) in enumerate(zip(got, want))
                for d in bench_diff(g, w, f"{path}[{i}]", rtol)]
    if isinstance(want, float) and not isinstance(got, bool) \
            and isinstance(got, (int, float)):
        ok = abs(got - want) <= rtol * max(abs(got), abs(want))
        return [] if ok else [f"{path}: {got!r} != {want!r}"]
    ok = type(got) is type(want) and got == want
    return [] if ok else [f"{path}: {got!r} != {want!r}"]


def sim_bench(np, sim, cc, costs, SchemeParams, table1_grid, smoke=False,
              seed=0):
    """``benchmarks/sim_bench.py``'s report (without its envelope): Table I
    as the zero-contention simulation, the straggler/r trade-off, and the
    adaptive scheduler against the fixed baselines over straggler, bandwidth
    skew and offered-load sweeps, each stream on a cleared plan cache."""
    cfg = SIM_SIZES[smoke]
    cost = sim_default_cost(sim)
    K_, P_ = SCHED_K, SCHED_P
    fns = {"uncoded": costs.uncoded_cost, "coded": costs.coded_cost,
           "hybrid": costs.hybrid_cost}
    table1 = []
    for (k, p_, q, n, r) in table1_grid:
        topo = sim.RackTopology(P=p_, cross_bw=1.0, intra_bw=10.0)
        params = SchemeParams(k, p_, q, n, r)
        for scheme, fn in fns.items():
            want = fn(params, check=False).weighted_time(10.0, 1.0)
            got = sim.simulate_single_job(sim.JobSpec("histogram", n, q, 1),
                                          topo, k, scheme, r,
                                          check=False).jct
            rel = abs(got - want) / max(abs(want), 1e-12)
            check(rel < 1e-9, f"sim JCT {got} == weighted_time {want}: "
                  f"{scheme} {(k, p_, q, n, r)}")
            table1.append({"params": [k, p_, q, n, r], "scheme": scheme,
                           "sim_jct": got, "weighted_time": want,
                           "rel_err": rel, "match": True})
    topo = sim.RackTopology(P=P_, cross_bw=SIM_CROSS_BW,
                            intra_bw=SIM_INTRA_BW)
    spec = sim.JobSpec("wide_histogram_d16", 336, 16, 16)
    tradeoff = []
    for scale in cfg["scales"]:
        for r in (1, 2, 3):
            jcts = []
            for s in range(cfg["n_seeds"]):
                model = (sim.ExponentialTail(scale) if scale
                         else sim.NoStragglers())
                jcts.append(sim.simulate_single_job(
                    spec, topo, K_, "hybrid", r, cost_model=cost,
                    stragglers=model, seed=s).jct)
            tradeoff.append({"tail_scale": scale, "r": r,
                             "mean_jct": float(np.mean(jcts)),
                             "p99_jct": float(np.percentile(jcts, 99))})

    def stream(jobs, topo, stragglers, adaptive, fixed=("coded", 2),
               expected_straggler=1.0):
        cc.plan_cache_clear()
        cluster = sim.ClusterSim(topo, K_, cost, stragglers, seed)
        chooser = sim.SchemeChooser(K_, cost_model=cost, adaptive=adaptive,
                                    fixed=fixed,
                                    expected_straggler=expected_straggler)
        stats, sched = sim.run_scheduled(jobs, cluster, chooser,
                                         policy="fifo", max_concurrent=4)
        jcts = np.asarray([s.jct for s in stats])
        picks = {}
        for s in stats:
            d = sched.decisions[s.job_id]
            picks[f"{d.scheme}:r{d.r}"] = picks.get(f"{d.scheme}:r{d.r}",
                                                    0) + 1
        return {"mean_jct": float(jcts.mean()),
                "p99_jct": float(np.percentile(jcts, 99)),
                "n_jobs": len(jcts), "decisions": picks}

    def point(jobs, topo, stragglers, expected_straggler=1.0):
        out = {"adaptive": stream(jobs, topo, stragglers, True,
                                  expected_straggler=expected_straggler)}
        for scheme, r in SIM_FIXED_BASELINES:
            out[f"fixed_{scheme}_r{r}"] = stream(jobs, topo, stragglers,
                                                 False, (scheme, r))
        return out

    catalog = sim.default_catalog(K_, P_)
    n_jobs = cfg["n_jobs"]
    stragglers_rows, skew_rows, load_rows = [], [], []
    for scale in cfg["scales"]:
        jobs = sim.PoissonWorkload(catalog, n_jobs, rate=4.0).generate(seed)
        model = sim.ExponentialTail(scale) if scale else sim.NoStragglers()
        row = point(jobs, topo, model, expected_straggler=1.0 + scale)
        row["tail_scale"] = scale
        stragglers_rows.append(row)
    for rho in cfg["ratios"]:
        skewed = sim.RackTopology(P=P_, cross_bw=SIM_INTRA_BW * rho,
                                  intra_bw=SIM_INTRA_BW)
        jobs = sim.PoissonWorkload(catalog, n_jobs, rate=4.0).generate(seed)
        row = point(jobs, skewed, sim.NoStragglers())
        row["cross_over_intra_bw"] = rho
        skew_rows.append(row)
    for rate in cfg["rates"]:
        jobs = sim.PoissonWorkload(catalog, n_jobs, rate=rate).generate(seed)
        row = point(jobs, topo, sim.NoStragglers())
        row["arrival_rate"] = rate
        load_rows.append(row)
    scenarios = {"straggler_r_tradeoff": tradeoff,
                 "stragglers": stragglers_rows,
                 "bandwidth_skew": skew_rows, "offered_load": load_rows}

    def beats_fixed(rows, baseline="fixed_coded_r2"):
        tol = 1.0 + 1e-9
        mean_a = [r["adaptive"]["mean_jct"] for r in rows]
        mean_b = [r[baseline]["mean_jct"] for r in rows]
        p99_a = [r["adaptive"]["p99_jct"] for r in rows]
        p99_b = [r[baseline]["p99_jct"] for r in rows]
        pointwise = all(a <= b * tol for a, b in zip(mean_a, mean_b)) and \
            all(a <= b * tol for a, b in zip(p99_a, p99_b))
        return pointwise and sum(mean_a) < sum(mean_b) and \
            sum(p99_a) < sum(p99_b)

    beats = {name: beats_fixed(scenarios[name])
             for name in ("stragglers", "bandwidth_skew", "offered_load")}
    return {"cluster": {"K": K_, "P": P_, "intra_bw": SIM_INTRA_BW,
                        "cross_bw": SIM_CROSS_BW},
            "cost_model_calibrated_from": None,
            "table1_zero_contention": {"rows": table1, "all_match": True},
            "scenarios": scenarios, "scheduler_beats_fixed_coded": beats}


def drift_run(sim, metrics, drift, n_jobs, seed, t_shift, recalibrate):
    """``calibration_bench._drift_run``: one seeded scheduled stream whose
    straggler regime shifts ``CAL_SHIFT_FACTOR``-fold at ``t_shift``."""
    K_, P_ = SCHED_K, SCHED_P
    stale = cal_stale_cost(sim)
    topo = sim.RackTopology(P=P_, cross_bw=2e5, intra_bw=2e6)
    cluster = sim.ClusterSim(topo, K=K_, cost_model=stale, seed=seed)
    cluster.at(t_shift, lambda: setattr(
        cluster, "stragglers",
        sim.DeterministicSlowdown((CAL_SHIFT_FACTOR,) * K_)))
    chooser = sim.SchemeChooser(K_, cost_model=stale,
                                compile_real_plans=False)
    monitor = drift.DriftMonitor(drift.DriftConfig(
        ewma_alpha=0.3, threshold=0.2, min_observations=3))
    sched = sim.MultiJobScheduler(chooser, policy="fifo", max_concurrent=2,
                                  drift=monitor, recalibrate=recalibrate)
    wl = sim.PoissonWorkload(sim.default_catalog(K_, P_), n_jobs=n_jobs,
                             rate=2.0)
    stats = sched.run(wl.generate(seed), cluster)
    post = []
    for s in stats:
        d = sched.decisions.get(s.job_id)
        if d is None or s.submit < t_shift:
            continue
        actual = s.finish - s.submit
        post.append(abs(d.est_jct - actual) / max(actual, 1e-12))
    return {"post_shift_rel_errs": post, "monitor": monitor.state(),
            "n_jobs": len(stats),
            "refit_trace_events": sum(
                1 for e in cluster.tracer.events if e.kind == "sched_refit"),
            "banked_regret_s": metrics.registry().counter(
                "stale_model_regret_seconds_total").value(layer="sim")}


def drift_section(np, sim, metrics, drift, smoke=False, seed=0):
    """``calibration_bench.drift``: the stale model against the online
    refit on the same stream, each on a reset registry."""
    n_jobs, t_shift = CAL_DRIFT[smoke]
    metrics.reset()
    stale = drift_run(sim, metrics, drift, n_jobs, seed, t_shift, False)
    metrics.reset()
    refit = drift_run(sim, metrics, drift, n_jobs, seed, t_shift, True)
    stale_mean = float(np.mean(stale["post_shift_rel_errs"]))
    refit_mean = float(np.mean(refit["post_shift_rel_errs"]))
    fired = refit["monitor"]["drift_events"] >= 1
    refits = refit["monitor"]["refits"]
    check(fired, "the EWMA drift detector fired after the regime shift")
    check(refits >= 1 and refit["refit_trace_events"] == refits,
          f"{refits} refits, {refit['refit_trace_events']} sched_refit "
          f"trace events")
    check(refit_mean < stale_mean, f"the online refit ({refit_mean}) beats "
          f"the stale model ({stale_mean}) after the shift")
    return {"n_jobs": n_jobs, "t_shift": t_shift,
            "shift_factor": CAL_SHIFT_FACTOR,
            "stale_mean_rel_err": stale_mean,
            "refit_mean_rel_err": refit_mean,
            "improvement": stale_mean / max(refit_mean, 1e-12),
            "drift_fired": fired, "refits": refits,
            "banked_regret_s": refit["banked_regret_s"],
            "stale_monitor": stale["monitor"],
            "refit_monitor": refit["monitor"], "ok": True}


def determinism_section(sim, metrics, drift, smoke=False, seed=0):
    """``calibration_bench.determinism``: the sha256 of the ``jct_*`` and
    ``stale_model*`` metrics after the refit stream, twice."""
    import hashlib
    n_jobs, t_shift = CAL_DETERMINISM[smoke]

    def snap_text():
        metrics.reset()
        drift_run(sim, metrics, drift, n_jobs, seed, t_shift, True)
        snap = metrics.snapshot()
        sub = {name: snap[name] for name in sorted(snap)
               if name.startswith("jct_") or name.startswith("stale_model")}
        return json.dumps(sub, sort_keys=True)

    a, b = snap_text(), snap_text()
    sha_a = hashlib.sha256(a.encode()).hexdigest()
    sha_b = hashlib.sha256(b.encode()).hexdigest()
    check(a == b, "jct_* metric snapshots bit-identical per seed")
    return {"n_jobs": n_jobs, "sha256": sha_a, "identical": sha_a == sha_b,
            "ok": True}


def resilience_frontier(res, sim, table1_rows, n_seeds):
    """``resilience_bench``'s frontier cells of ``table1_rows``."""
    regimes = res.straggler_regimes(exp_scale=1.0, rack_p=0.25,
                                    rack_factor=4.0)
    return res.cloning_vs_coding_frontier(
        rows=table1_rows, policies=res.DEFAULT_POLICIES, regimes=regimes,
        cost=res_bench_cost(sim), intra_bw=RES_INTRA_BW,
        cross_bw=RES_CROSS_BW, n_seeds=n_seeds, tasks_per_server=8)


def resilience_hedged(res, sim, cc, smoke=False, seed=0):
    """``resilience_bench``'s ``hedged_vs_static`` on a cleared plan cache
    (the bench process reaches it with none of its plans compiled)."""
    n_jobs, n_probe = RES_HEDGED[smoke]
    cc.plan_cache_clear()
    return res.hedged_vs_static_stream(
        K=8, P=4, stragglers=sim.RackCorrelated(0.25, 4.0),
        cost=res_bench_cost(sim), intra_bw=1e6, cross_bw=1e5, rate=4.0,
        n_jobs=n_jobs, n_probe=n_probe, seed=seed)


def resilience_determinism(res, sim, seed=7):
    """``resilience_bench._determinism_check``: one straggling frontier
    cell with speculation, simulated twice, gives the same trace."""
    def run():
        topo = sim.RackTopology(P=3, cross_bw=RES_CROSS_BW,
                                intra_bw=RES_INTRA_BW)
        cluster = sim.ClusterSim(topo, 9, res_bench_cost(sim),
                                 sim.ExponentialTail(1.0), seed,
                                 speculation=res.get_policy("late"))
        cluster.submit(sim.JobSpec("histogram", 72, 18, 1), "hybrid", 2)
        stats = cluster.run()
        return [s.jct for s in stats], list(cluster.trace)

    (j1, t1), (j2, t2) = run(), run()
    return j1 == j2 and t1 == t2


# BENCH_calibration.json's determinism sha256 (784734a6…) predates the
# scheduler's jct_blame_* and jct_component_* metrics: the JAX package's
# calibration bench, run today in its own order (conformance, drift,
# determinism), gives this digest, and so does the port
# (tests/test_torch_calibration.py runs both).
CAL_DETERMINISM_SHA256 = ("fc737def877437355224495c51c0d9bc"
                          "2501482c4cc8c15c4f74914329a183a0")


def h100_calibration(torch, np, cc, cal, eng, jobs, drift, count, mesh,
                     SchemeParams, out_dir, seed, smi):
    """Phase 4e (d): the calibration bench's phase-fit grid measured on the
    card and fitted, written to ``out_dir``; then the fused job's warm wall
    over the conformance grid under unicast/torch and coded/kernel, a
    conformance fit per pairing, and the simulator held to each fit's
    linear predictor."""
    points = [(SchemeParams(K=SCHED_K, P=SCHED_P, Q=16, N=n, r=r), d)
              for n, r, d in CAL_GRID_POINTS]
    cc.plan_cache_clear()
    t0 = time.perf_counter()
    rows = eng.measure_calibration_grid(jobs.wide_histogram_job, mesh,
                                        points, iters=5)
    grid_s = time.perf_counter() - t0
    for row in rows:
        secs = list(row["seconds"].values()) + [row["meta"]["shuffle_s"]]
        check(all(math.isfinite(s) and s > 0 for s in secs)
              and row["meta"]["backend"] == "cuda",
              f"calibration row N={row['meta']['N']} d={row['meta']['d']}: "
              f"finite positive seconds on the card {row['seconds']}")
    model, residuals = cal.calibrate_with_residuals(rows)
    cpu_model, _ = cal.load_default_cost_model()
    fit = {}
    for phase in ("map", "pack", "reduce", "plan_compile"):
        c, ref = model.phase_coeffs(phase), cpu_model.phase_coeffs(phase)
        res = residuals.get(phase, {})
        fit[phase] = {"alpha": c.alpha, "beta": c.beta,
                      "cpu_alpha": ref.alpha, "cpu_beta": ref.beta,
                      **res}
        say(f"  calibration {phase}: H100 alpha={c.alpha:.6e} s "
            f"beta={c.beta:.6e} s/unit (rmse {res.get('rmse_s', 0) * 1e3:.4f}"
            f" ms, rel_rmse {res.get('rel_rmse', 0):.4f}) | committed CPU "
            f"fit alpha={ref.alpha:.6e} beta={ref.beta:.6e} [{smi}]")
    path = pathlib.Path(out_dir) / "h100_cost_model.json"
    provenance = {"bench": "chip_smoke.phase_4e", "backend": "cuda",
                  "device": smi, "torch": torch.__version__,
                  "mesh_shape": [SCHED_P, SCHED_K // SCHED_P],
                  "points": [{"N": p.N, "Q": p.Q, "r": p.r, "d": d}
                             for p, d in points],
                  "iters": 5, "seed": seed}
    cal.save_cost_model(model, str(path), residuals=residuals,
                        provenance=provenance)
    reloaded, _ = cal.load_cost_model(str(path))
    check(reloaded == model, "the H100 cost model round-trips exactly")

    launches = dict.fromkeys(KERNELS, 0)
    conformance, dense = {}, {}
    for mc, impl in (("unicast", "torch"), ("coded", "kernel")):
        cells = []
        for n, q, d in CONFORMANCE_SIZES:
            job = jobs.wide_histogram_job(d)
            for r in CONFORMANCE_RS:
                p = SchemeParams(K=SCHED_K, P=SCHED_P, Q=q, N=n, r=r)
                rng = np.random.default_rng(seed * 1009 + r)
                subfiles = rng.integers(0, 1 << 16, size=(
                    n, CONFORMANCE_TOKENS)).astype(np.int32)
                want = expected_launches(mc, impl, r)

                def call():
                    t1 = time.perf_counter()
                    res = eng.run_job_distributed(job, subfiles, p, mesh,
                                                  fused=True, multicast=mc,
                                                  combine_impl=impl)
                    torch.cuda.synchronize()
                    return res, time.perf_counter() - t1
                best = math.inf
                for it in range(6):                 # warm, then best of 5
                    (res, s), counts, _ = count(call)
                    check(counts == want, f"conformance N={n} r={r} d={d} "
                          f"{mc}/{impl} launches {counts}, expected {want}")
                    add_counts(launches, counts)
                    if it:
                        best = min(best, s)
                key = (n, q, d, r)
                if key not in dense:
                    dense[key] = eng.run_job(job, subfiles, p,
                                             "hybrid").outputs
                check(torch.equal(res.outputs, dense[key]),
                      f"conformance {key} {mc}/{impl}: outputs == run_job")
                check(math.isfinite(best) and best > 0,
                      f"conformance {key}: wall {best}")
                cells.append({"p": p, "scheme": "hybrid", "d": d,
                              "measured_s": best})
        model_c = cal.fit_conformance(cells)
        for c in cells:
            lin = model_c.predict(c["p"], "hybrid", c["d"])
            simj = model_c.sim_stats(c["p"], "hybrid", c["d"]).jct
            check(abs(simj - lin) <= 1e-9 * max(lin, 1e-12),
                  f"{mc}/{impl} N={c['p'].N} r={c['p'].r} d={c['d']}: sim "
                  f"JCT {simj} == the linear predictor {lin}")
        report = cal.conformance_report(model_c, cells, via_sim=True)
        for row in report:
            check(all(math.isfinite(row[k]) and row[k] > 0
                      for k in ("measured_s", "predicted_s")),
                  f"conformance row finite and positive: {row}")
            drift.record_prediction(row["predicted_s"], row["measured_s"],
                                    layer="engine", scheme="hybrid")
            say(f"  conformance {mc}/{impl} N={row['N']} r={row['r']} "
                f"d={row['d']}: measured {row['measured_s'] * 1e3:.4f} ms, "
                f"sim {row['predicted_s'] * 1e3:.4f} ms, rel_err "
                f"{row['rel_err']:.4f} [{smi}]")
        errs = [row["rel_err"] for row in report]
        conformance[f"{mc}/{impl}"] = {
            "theta": list(model_c.theta), "cells": report,
            "max_rel_err": max(errs), "mean_rel_err": float(np.mean(errs)),
            "within_band": max(errs) <= CONFORMANCE_TOL}
        say(f"  conformance {mc}/{impl}: max rel err {max(errs):.4f}, mean "
            f"{float(np.mean(errs)):.4f} (the bench's band "
            f"{CONFORMANCE_TOL}, set on CPU walls: reported, not gated); "
            f"theta {[f'{t:.4e}' for t in model_c.theta]} [{smi}]")
    check(launches["coded_encode"] > 0 and launches["coded_decode"] > 0,
          f"the coded/kernel conformance cells launched the linear pair: "
          f"{launches}")
    return ({"grid_s": grid_s, "phase_fit": fit, "residuals": residuals,
             "artifact": str(path), "conformance": conformance},
            model, launches)


def scheduler_on_card(torch, np, sim, pl, cc, cost_model, seed, smi):
    """Phase 4e (e): one seeded ``run_scheduled`` stream on
    ``default_catalog(8, 4)`` with the H100 cost model, every hybrid
    candidate placed by the annealer on the card, then the same stream with
    the annealer on the CPU: decisions, ``JobStats`` and the trace must be
    identical, and every placement a permutation."""
    import dataclasses
    solver = pl.SOLVERS["anneal"]

    def stream(device):
        calls, walls = [], []

        def recording(p, C, rng, **kw):
            t1 = time.perf_counter()
            perm = solver(p, C, rng, **kw)
            calls.append({"N": p.N, "r": p.r, "device": str(kw["device"]),
                          "wall_s": time.perf_counter() - t1,
                          "perm": np.asarray(perm).tolist()})
            return perm

        cc.plan_cache_clear()
        topo = sim.RackTopology(P=SCHED_P, cross_bw=ANNEAL_STREAM_CROSS_BW,
                                intra_bw=SIM_INTRA_BW)
        cluster = sim.ClusterSim(topo, SCHED_K, cost_model,
                                 sim.ExponentialTail(0.5), seed)
        chooser = sim.SchemeChooser(SCHED_K, cost_model=cost_model,
                                    placement_solver="anneal",
                                    placement_device=device)
        choose = chooser.choose

        def timed_choose(spec, cl):
            t1 = time.perf_counter()
            d = choose(spec, cl)
            walls.append(time.perf_counter() - t1)
            return d
        chooser.choose = timed_choose
        jobs = sim.PoissonWorkload(sim.default_catalog(SCHED_K, SCHED_P),
                                   ANNEAL_STREAM_JOBS, rate=4.0
                                   ).generate(seed)
        pl.SOLVERS["anneal"] = recording
        try:
            t1 = time.perf_counter()
            stats, sched = sim.run_scheduled(jobs, cluster, chooser)
            wall = time.perf_counter() - t1
        finally:
            pl.SOLVERS["anneal"] = solver
        return ({"stats": [dataclasses.asdict(s) for s in stats],
                 "decisions": {k: dataclasses.asdict(v) for k, v in
                               sorted(sched.decisions.items())},
                 "trace": [dataclasses.astuple(e)
                           for e in cluster.tracer.events]},
                calls, walls, wall, stats, list(cluster.tracer.events))

    card, card_calls, card_walls, card_s, stats, events = stream("cuda")
    cpu, cpu_calls, _, cpu_s, _, _ = stream("cpu")
    check(card_calls and all(c["device"] == "cuda" for c in card_calls)
          and all(c["device"] == "cpu" for c in cpu_calls),
          "the annealer ran on the card, then on the CPU")
    check(all(sorted(c["perm"]) == list(range(c["N"]))
              for c in card_calls + cpu_calls),
          "every annealed placement is a permutation")
    check([c["perm"] for c in card_calls] == [c["perm"] for c in cpu_calls],
          f"the annealer's {len(card_calls)} placements on the card == on "
          f"the CPU")
    for part in ("decisions", "stats", "trace"):
        check(card[part] == cpu[part], f"the annealer stream's {part} on "
              f"the card == with the annealer on the CPU")
    picks = {}
    for d in card["decisions"].values():
        picks[f"{d['scheme']}:r{d['r']}"] = picks.get(
            f"{d['scheme']}:r{d['r']}", 0) + 1
    anneal_ms = [c["wall_s"] * 1e3 for c in card_calls]
    say(f"  (e) scheduler stream ({ANNEAL_STREAM_JOBS} jobs, anneal on "
        f"cuda): "
        f"decisions {picks}; choose wall per admission ms "
        + " ".join(f"{w * 1e3:.1f}" for w in card_walls)
        + f" (median {statistics.median(card_walls) * 1e3:.1f}); "
        f"{len(card_calls)} anneal calls, median "
        f"{statistics.median(anneal_ms):.1f} ms; stream {card_s:.2f} s, "
        f"{cpu_s:.2f} s replayed with the annealer on the CPU; decisions, "
        f"JobStats, trace and placements identical [{smi}]")
    return ({"n_jobs": ANNEAL_STREAM_JOBS, "decisions": picks,
             "choose_ms": [w * 1e3 for w in card_walls],
             "anneal_ms": anneal_ms, "card_stream_s": card_s,
             "cpu_stream_s": cpu_s}, stats, events)


def scheduler_phase(torch, np, sim, pl, res, cc, cal, costs, eng, jobs,
                    metrics, drift, report, count, SchemeParams, table1_grid,
                    make_mesh, out_dir, seed, smi):
    """Phase 4e: the committed simulator benches reproduced by the port's
    scheduler and resilience policies, the H100 calibration with the linear
    combine pair on its path, the annealer stream card against CPU, and the
    report."""
    info = {}
    # (a) BENCH_sim.json, every stream on a cleared plan cache
    t0 = time.perf_counter()
    want = json.loads((ROOT / "BENCH_sim.json").read_text())
    got = sim_bench(np, sim, cc, costs, SchemeParams, table1_grid)
    diffs = bench_diff(got, {k: want[k] for k in got})
    check(not diffs, f"BENCH_sim.json reproduced: {diffs[:5]}")
    check(all(got["scheduler_beats_fixed_coded"].values()),
          "the adaptive scheduler beats the fixed coded baseline")
    exact = got == {k: want[k] for k in got}
    info["sim_bench_s"] = time.perf_counter() - t0
    say(f"  (a) BENCH_sim.json: {len(got['table1_zero_contention']['rows'])}"
        f" Table I cells and every sweep's decisions and JCTs reproduced "
        f"({'bit for bit' if exact else f'within {BENCH_RTOL} rel'}); "
        f"{info['sim_bench_s']:.1f} s [{smi}]")
    # (b) BENCH_calibration.json: drift and determinism, on an empty
    # registry (a metric keeps the help string it was first declared
    # with, and the determinism digest hashes it)
    t0 = time.perf_counter()
    metrics.registry().clear()
    want = json.loads((ROOT / "BENCH_calibration.json").read_text())
    dr = drift_section(np, sim, metrics, drift)
    diffs = bench_diff(dr, want["drift"])
    check(not diffs, f"BENCH_calibration.json drift reproduced: "
          f"{diffs[:5]}")
    det = determinism_section(sim, metrics, drift)
    check(det["sha256"] == CAL_DETERMINISM_SHA256,
          f"determinism sha256 {det['sha256']} == the JAX package's "
          f"{CAL_DETERMINISM_SHA256}")
    info["calibration_bench_s"] = time.perf_counter() - t0
    say(f"  (b) BENCH_calibration.json: drift stale "
        f"{dr['stale_mean_rel_err']:.6f} -> refit "
        f"{dr['refit_mean_rel_err']:.6f}, {dr['refits']} refits "
        f"== the file; determinism sha256 {det['sha256'][:16]}… == the JAX "
        f"package's (the file's {want['determinism']['sha256'][:16]}… "
        f"predates the blame metrics); {info['calibration_bench_s']:.1f} s "
        f"[{smi}]")
    # (c) BENCH_resilience.json: the leading rows' frontier cells,
    # hedged_vs_static and the trace determinism check
    t0 = time.perf_counter()
    want = json.loads((ROOT / "BENCH_resilience.json").read_text())
    cells = resilience_frontier(res, sim, res.TABLE1_ROWS[:RES_ROWS],
                                want["n_seeds"])
    by_key = {(tuple(c["params"]), c["regime"], c["scheme"], c["r"],
               c["policy"]): c for c in want["frontier"]}
    n_exact = 0
    for c in cells:
        row = c.to_row()
        ref = by_key[(tuple(row["params"]), row["regime"], row["scheme"],
                      row["r"], row["policy"])]
        diffs = bench_diff(row, ref)
        check(not diffs, f"BENCH_resilience.json frontier cell {diffs[:3]}")
        n_exact += row == ref
    hedged = resilience_hedged(res, sim, cc)
    diffs = bench_diff(hedged, want["hedged_vs_static"])
    check(not diffs, f"BENCH_resilience.json hedged_vs_static: {diffs[:5]}")
    check(resilience_determinism(res, sim),
          "speculation-enabled trace deterministic")
    info["resilience_bench_s"] = time.perf_counter() - t0
    say(f"  (c) BENCH_resilience.json: {len(cells)} frontier cells of rows "
        f"{[list(r) for r in res.TABLE1_ROWS[:RES_ROWS]]} at n_seeds "
        f"{want['n_seeds']} ({n_exact} bit for bit, the rest within "
        f"{BENCH_RTOL} rel), hedged_vs_static (hedged p99 "
        f"{hedged['hedged']['p99_jct']:.6f} vs static "
        f"{hedged['static']['p99_jct']:.6f}, decisions exact) and the "
        f"trace determinism check; {info['resilience_bench_s']:.1f} s "
        f"[{smi}]")
    # (d) the H100 calibration, the linear pair on the coded/kernel cells
    t0 = time.perf_counter()
    mesh = make_mesh((SCHED_P, SCHED_K // SCHED_P), ("rack", "server"))
    cal_info, h100_model, launches = h100_calibration(
        torch, np, cc, cal, eng, jobs, drift, count, mesh, SchemeParams,
        out_dir, seed, smi)
    info["calibration"] = cal_info
    info["calibration_s"] = time.perf_counter() - t0
    say(f"  (d) H100 calibration: grid {cal_info['grid_s']:.1f} s, fit "
        f"written to {cal_info['artifact']}; conformance honest on both "
        f"pairings; launches {launches}; {info['calibration_s']:.1f} s "
        f"[{smi}]")
    # (e) the annealer stream, card against CPU
    t0 = time.perf_counter()
    info["stream"], stats, events = scheduler_on_card(
        torch, np, sim, pl, cc, h100_model, seed, smi)
    info["stream_s"] = time.perf_counter() - t0
    # (f) the report of the phase's registry and the card stream
    rep = report.build_report(events=events, stats=stats,
                              title="chip_smoke phase 4e")
    paths = [report.write_report(str(pathlib.Path(out_dir) / name), rep)
             for name in ("obs_report.md", "obs_report.html")]
    rows = {k: (len(v) if isinstance(v, (list, dict)) else 1)
            for k, v in rep.items() if k != "title"}
    rows["blame jobs"] = len(rep["blame"].get("jobs", ()))
    check(rows["blame jobs"] == ANNEAL_STREAM_JOBS and rows["scalars"] > 0
          and rows["prediction_hists"] > 0,
          f"the report holds the stream's jobs and the registry: {rows}")
    say(f"  (f) report: {', '.join(paths)}; rows by section {rows} [{smi}]")
    info["report_rows"] = rows
    return info, launches


# ---------------------------------------------------------------------------
# Phase 5: the LM kernels against their plain versions
# ---------------------------------------------------------------------------

def visible_pairs(Sq, Sk, q_offset, kv_valid, causal, window):
    """(query, key) pairs the masks keep for one (batch, head), and the
    number of distinct keys any query sees: the work this run's data
    needs."""
    valid = Sk if kv_valid is None else min(kv_valid, Sk)
    pairs, key_lo, key_hi = 0, Sk, 0
    for i in range(Sq):
        p = q_offset + i
        hi = min(valid, p + 1) if causal else valid
        lo = max(0, p - window + 1) if window is not None else 0
        if hi > lo:
            pairs += hi - lo
            key_lo, key_hi = min(key_lo, lo), max(key_hi, hi)
    return pairs, max(key_hi - key_lo, 0)


# (tag, B, Sq, Sk, H, KV, hd, causal, q_offset, kv_valid, window): Qwen2-1.5B
# prefill of 8 x 2048 and one decode step against a 2,112-long cache with
# 1,500 and with 2,111 valid keys, then the shapes of tests/test_kernels.py
FLASH_CASES = [
    ("prefill", 8, 2048, 2048, 12, 2, 128, True, 0, None, None),
    ("decode", 8, 1, 2112, 12, 2, 128, True, 1499, 1500, None),
    ("decode_2111", 8, 1, 2112, 12, 2, 128, True, 2110, 2111, None)] + [
    ("odd", B, Sq, Sk, H, KV, hd, causal, Sk - Sq if causal else 0, None,
     None)
    for B, Sq, Sk, H, KV, hd in ((2, 128, 128, 4, 4, 64),
                                 (1, 200, 200, 8, 2, 64),
                                 (2, 64, 256, 4, 1, 128))
    for causal in (True, False)] + [
    ("window", 1, 160, 160, 4, 2, 64, True, 0, None, 32),
    ("kv_valid", 2, 8, 128, 4, 4, 64, False, 0, 57, None),
    # head dims over 128: MLA's absorbed attention (deepseek-v2-lite:
    # kv_lora_rank 512 + rope_head_dim 64 = 576, 16 query heads on one
    # latent kv head) at phase 6's shapes: the 8 x 2048 causal prefill into
    # the 2,112-long latent cache (2,048 valid keys) with v drawn apart
    # from k and with v = k (the model's call: one latent tensor as both),
    # and the first decode step (2,049 valid keys), then per-batch valid
    # keys; then one odd shape at hd 192
    ("mla_prefill", 8, 2048, 2112, 16, 1, 576, True, 0, 2048, None),
    ("mla_prefill_shared", 8, 2048, 2112, 16, 1, 576, True, 0, 2048, None),
    ("mla_decode", 8, 1, 2112, 16, 1, 576, True, 2048, 2049, None),
    ("mla_decode_per_batch", 8, 1, 2112, 16, 1, 576, True, 2110,
     (2111, 1500, 1, 64, 2000, 777, 1024, 2048), None),
    ("odd_hd192", 2, 100, 230, 8, 2, 192, True, 130, 200, None),
    # phase 6's new families: Hymba's windowed prefill over 2,560-token
    # prompts (window 2,048) and a decode step over its full 2,048-slot
    # ring (no mask but the valid slots); Whisper's bidirectional encoder
    # at one query head per kv head over 1,500 frames, its cross-attention
    # prefill of the 416-token decoder prompt over the 1,500 encoder keys
    # and a cross decode step; LLaVA's prefill of 2,880 patches + 256
    # tokens into its 3,168-long cache
    ("hymba_prefill", 8, 2560, 2560, 25, 5, 64, True, 0, None, 2048),
    ("hymba_ring_decode", 8, 1, 2048, 25, 5, 64, False, 0, 2048, None),
    ("whisper_encoder", 8, 1500, 1500, 20, 20, 64, False, 0, None, None),
    ("whisper_cross_prefill", 8, 416, 1500, 20, 20, 64, False, 0, None,
     None),
    ("whisper_cross_decode", 8, 1, 1500, 20, 20, 64, False, 0, None, None),
    ("llava_prefill", 2, 3136, 3168, 56, 8, 128, True, 0, 3136, None),
    # phase 10's local heads (qwen2-72b at model 4: 16 query heads on 2 kv
    # heads, G = 8): (b)'s 4 x 1,024 prefill into its 1,056-long cache and
    # its last decode step (position 1,054), (a)'s fp32 2 x 256 prefill
    # into a 264-long cache
    ("tp_prefill", 4, 1024, 1056, 16, 2, 128, True, 0, 1024, None),
    ("tp_decode", 4, 1, 1056, 16, 2, 128, True, 1054, 1055, None),
    ("tp_check", 2, 256, 264, 16, 2, 128, True, 0, 256, None),
    # phase 10 (f)'s local heads (DeepSeek-V2-Lite at model 4: 4 of its 16
    # heads on the one hd-576 latent head, G = 4; at model 2, G = 8): (f2)'s
    # 4 x 1,024 prefill into its 1,056-long latent cache (v = k, the
    # model's call) and its last decode step, (f1)'s fp32 2 x 256 prefill
    # into a 264-long cache
    ("tp_mla_prefill", 4, 1024, 1056, 4, 1, 576, True, 0, 1024, None),
    ("tp_mla_prefill_g8", 4, 1024, 1056, 8, 1, 576, True, 0, 1024, None),
    ("tp_mla_decode", 4, 1, 1056, 4, 1, 576, True, 1054, 1055, None),
    ("tp_mla_check", 2, 256, 264, 4, 1, 576, True, 0, 256, None)]
FAMILY_TAGS = ("hymba_prefill", "hymba_ring_decode", "whisper_encoder",
               "whisper_cross_prefill", "whisper_cross_decode",
               "llava_prefill")
FLASH_TIMED = ("prefill", "decode", "decode_2111", "mla_prefill",
               "mla_prefill_shared", "mla_decode", "tp_mla_prefill"
               ) + FAMILY_TAGS
# the cases whose v is k (one tensor passed as both)
SHARED_KV_TAGS = ("mla_prefill_shared", "tp_mla_prefill",
                  "tp_mla_prefill_g8", "tp_mla_decode", "tp_mla_check")
# the fp32 prefills (route mma_tf32) also timed in turns with fp32 SDPA and
# profiled: Qwen2's, MLA's with v apart and v = k, phase 10's fp32 check
MMA_TIMED = ("prefill", "mla_prefill", "mla_prefill_shared", "tp_check")
# the bf16 route of each new family's shape (fp32 prefill: mma_tf32)
FAMILY_ROUTE = {"hymba_prefill": "tensor_core",
                "hymba_ring_decode": "split_kv",
                "whisper_encoder": "tensor_core",
                "whisper_cross_prefill": "tensor_core",
                "whisper_cross_decode": "split_kv",
                "llava_prefill": "tensor_core"}
# the routes of phase 10's shapes, by dtype
TP_TAGS = ("tp_prefill", "tp_decode", "tp_check", "tp_mla_prefill",
           "tp_mla_prefill_g8", "tp_mla_decode", "tp_mla_check")
TP_ROUTE = {("tp_prefill", "bfloat16"): "tensor_core",
            ("tp_prefill", "float32"): "mma_tf32",
            ("tp_decode", "bfloat16"): "split_kv",
            ("tp_decode", "float32"): "split_kv",
            ("tp_check", "bfloat16"): "tensor_core",
            ("tp_check", "float32"): "mma_tf32",
            **{(tag, dt): ("tensor_core_wide" if dt == "bfloat16"
                           else "mma_tf32")
               for tag in ("tp_mla_prefill", "tp_mla_prefill_g8",
                           "tp_mla_check")
               for dt in ("bfloat16", "float32")},
            **{("tp_mla_decode", dt): "split_kv"
               for dt in ("bfloat16", "float32")}}
# the route a head dim over 128 takes, by dtype: a bf16 prefill at hd 576
# on the wide tensor cores, fp32 and hd 192 on the TF32 mma route, decode
# split-kv
LARGE_HD_ROUTE = {
    **{(tag, dt): ("tensor_core_wide" if dt == "bfloat16" else "mma_tf32")
       for tag in ("mla_prefill", "mla_prefill_shared")
       for dt in ("bfloat16", "float32")},
    **{(tag, dt): "split_kv" for tag in ("mla_decode", "mla_decode_per_batch")
       for dt in ("bfloat16", "float32")},
    ("odd_hd192", "bfloat16"): "mma_tf32",
    ("odd_hd192", "float32"): "mma_tf32",
    **{key: route for key, route in TP_ROUTE.items()
       if key[0].startswith("tp_mla")}}
# split-kv against the plain split-kv algorithm, which also computes in fp32
# and rounds once: about one bf16 ulp of the output
FLASH_SPLIT_TOL = {"float32": (2e-5, 2e-5), "bfloat16": (1e-2, 1e-3)}
# (tag, B, S, h, Nk, Nv): RWKV6-3B prefill of 8 x 2048 and one decode step,
# then the ragged shapes of tests/test_kernels.py and a ragged one at
# RWKV6-3B's head width (bf16: the tensor-core route, last chunk masked)
WKV_CASES = [("prefill", 8, 2048, 40, 64, 64), ("decode", 8, 1, 40, 64, 64),
             ("ragged", 1, 64, 2, 16, 16), ("ragged", 2, 100, 3, 32, 32),
             ("ragged", 1, 128, 1, 64, 64), ("ragged", 2, 100, 3, 64, 64)]
# the tensor-core route against its plain mirror (the same TF32 operand
# rounding and chunks; tests/test_torch_wkv_cuda.py's MIRROR_TOL): a TF32
# operand that rounds the other way moves a product of order 20 by 2e-2,
# and the bf16 output may sit one ulp (2^-7 relative) apart
WKV_MIRROR_TOL = {"out": (2e-2, 2e-2), "state": (2e-2, 2e-2)}


def flash_phase(torch, fa, fa_ref, peaks, seed):
    """The flash kernels against ``attention_ref`` on the card, with the
    route each call took: the serving path's prefill and decode shapes
    (timed in turns with SDPA, the library yardstick: kernel, SDPA, SDPA,
    kernel) and the odd shapes of tests/test_kernels.py.  Split-kv calls
    are also held against the plain split-kv algorithm."""
    F = torch.nn.functional
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed + 101)
    rows, main = [], {}
    for (tag, B, Sq, Sk, H, KV, hd, causal, q_off, valid_case,
         window) in FLASH_CASES:
        # a tuple of valid lengths is one per batch row, a [B] tensor
        per_batch = isinstance(valid_case, tuple)
        valid = (torch.tensor(valid_case, device=dev) if per_batch
                 else valid_case)
        for dtype in (torch.bfloat16, torch.float32):
            q = torch.randn(B, Sq, H, hd, generator=g, device=dev).to(dtype)
            k = torch.randn(B, Sk, KV, hd, generator=g, device=dev).to(dtype)
            v = (k if tag in SHARED_KV_TAGS else torch.randn(
                B, Sk, KV, hd, generator=g, device=dev).to(dtype))
            kw = dict(causal=causal, q_offset=q_off, kv_valid=valid,
                      window=window)
            pos = torch.arange(q_off, q_off + Sq, device=dev)
            fa.reset_launch_counts()
            out = fa.flash_attention(q, k, v, **kw)
            torch.cuda.synchronize()
            routes = [r for r, n in fa.ROUTE_CALLS.items() if n]
            check(len(routes) == 1 and fa.LAUNCHES["flash_attention"] == 1,
                  f"flash {tag}: one launch by one route, got "
                  f"{fa.ROUTE_CALLS}")
            route = routes[0]
            dname = str(dtype).replace("torch.", "")
            check(hd <= 128 or route == LARGE_HD_ROUTE[(tag, dname)],
                  f"flash {tag} hd={hd} {dname}: route {route}, expected "
                  f"{LARGE_HD_ROUTE.get((tag, dname))}")
            check(tag not in FAMILY_ROUTE or dtype == torch.float32
                  or route == FAMILY_ROUTE[tag],
                  f"flash {tag}: route {route}, expected "
                  f"{FAMILY_ROUTE.get(tag)}")
            check(TP_ROUTE.get((tag, dname), route) == route,
                  f"flash {tag} {dname}: route {route}, expected "
                  f"{TP_ROUTE.get((tag, dname))}")
            want = fa_ref.attention_ref(q, k, v, pos, valid, causal=causal,
                                        window=window)
            tol = 2e-5 if dtype == torch.float32 else 2e-2
            torch.testing.assert_close(out, want, rtol=tol, atol=tol)
            err = float((out.float() - want.float()).abs().max().item())
            if route == "split_kv":
                split = fa_ref.attention_split_ref(
                    q, k, v, pos, valid, causal=causal, window=window,
                    chunk=fa.split_chunk(dtype, hd))
                s_rtol, s_atol = FLASH_SPLIT_TOL[dname]
                torch.testing.assert_close(out, split, rtol=s_rtol,
                                           atol=s_atol)
            mirror_err = None
            if route in ("tensor_core_wide", "mma_tf32"):
                # the kernel's own roundings (the wide route's blocks and
                # tiles too), and the same bits on a second call
                if route == "tensor_core_wide":
                    tile = fa.wide_key_tile(k, v)
                    check(tile == (64 if tag in SHARED_KV_TAGS else 32),
                          f"flash {tag}: key tile {tile}")
                    mirror = fa_ref.attention_wide_ref(
                        q, k, v, pos, valid, causal=causal, key_tile=tile)
                else:
                    mirror = fa_ref.attention_mma_ref(
                        q, k, v, pos, valid, causal=causal, window=window)
                s_rtol, s_atol = FLASH_SPLIT_TOL[dname]
                torch.testing.assert_close(out, mirror, rtol=s_rtol,
                                           atol=s_atol)
                mirror_err = float((out.float() - mirror.float()).abs()
                                   .max().item())
                again = fa.flash_attention(q, k, v, **kw)
                torch.cuda.synchronize()
                check(torch.equal(out, again),
                      f"flash {tag}: two calls gave different bits")
                del mirror, again
            # the pairs and keys each batch row's data needs
            pairs = keys = 0
            for b in range(B):
                vb = valid_case[b] if per_batch else valid_case
                p_b, k_b = visible_pairs(Sq, Sk, q_off, vb, causal, window)
                pairs, keys = pairs + p_b, keys + k_b
            size = q.element_size()
            n_kv = 1 if v is k else 2          # k and v read once each
            nbytes = size * (2 * q.numel() + n_kv * keys * KV * hd)
            flops = 4.0 * hd * pairs * H
            row = {"name": "flash_attention", "case": tag, "B": B, "Sq": Sq,
                   "Sk": Sk, "H": H, "KV": KV, "hd": hd, "causal": causal,
                   "q_offset": q_off, "kv_valid": valid_case,
                   "window": window, "v_is_k": v is k,
                   "dtype": dname, "route": route,
                   "max_abs_err": err, "mirror_max_abs_err": mirror_err,
                   "tolerance": f"rtol={tol},atol={tol}", "bytes": nbytes,
                   "flops": flops}
            row["bound_ms"], row["bound_by"] = bound(peaks, nbytes, flops,
                                                     dname)
            # the new families' shapes are timed against SDPA and profiled
            # at their serving dtype (bf16) alone, MLA's shared-kv prefill
            # and phase 10's check in fp32 only where they take mma_tf32:
            # every profiler session a process takes costs the later
            # sessions records
            is_main = (tag in FLASH_TIMED and (
                tag not in FAMILY_TAGS + SHARED_KV_TAGS
                or dtype == torch.bfloat16)) or (
                tag in MMA_TIMED and dtype == torch.float32)
            reps, inner = (5, 5) if is_main else (3, 10)
            if hd > 128 and route == "mma_tf32":    # ~22 ms a call
                reps, inner = 3, 2
            kernel = lambda: fa.flash_attention(q, k, v, **kw)
            row["plain_ms"] = cuda_ms(
                torch, lambda: fa_ref.attention_ref(
                    q, k, v, pos, valid, causal=causal, window=window),
                3, 2 if is_main else 10)
            row["library_ms"] = None
            if is_main:
                # one SDPA call on the keys the queries see (a causal
                # prefill: causal over the valid keys; a window: its boolean
                # mask; bidirectional or decode: the valid prefix)
                kv_n = valid or Sk
                qt = q.transpose(1, 2)
                kt, vt = (x[:, :kv_n].transpose(1, 2) for x in (k, v))
                sdpa_kw = {"is_causal": causal and Sq > 1}
                if window is not None:
                    qi = pos[:, None]
                    kj = torch.arange(kv_n, device=dev)[None, :]
                    sdpa_kw = {"attn_mask": (kj <= qi) & (kj > qi - window)}
                sdpa = lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, enable_gqa=True, **sdpa_kw)
                # a sanity check of the yardstick (its own bf16 rounding)
                lib_err = float((sdpa().transpose(1, 2).float()
                                 - want.float()).abs().max().item())
                check(lib_err < (1e-2 if dtype == torch.float32 else 0.1),
                      f"SDPA disagrees with the plain version: {lib_err}")
                # in turns: kernel, SDPA, SDPA, kernel
                turns = [cuda_ms(torch, fn, reps, inner)
                         for fn in (kernel, sdpa, sdpa, kernel)]
                row["ms_turns"] = [turns[0], turns[3]]
                row["library_ms_turns"] = [turns[1], turns[2]]
                row["ms"] = statistics.mean(row["ms_turns"])
                row["library_ms"] = statistics.mean(row["library_ms_turns"])
                row["tflops"] = flops / row["ms"] / 1e9
                row["device_ms"], row["device_kernels"] = device_per_call(
                    torch, kernel)
                row["library_device_ms"], _ = device_per_call(torch, sdpa)
                check(row["device_kernels"] >= 1,
                      f"flash {tag}: no kernel on the card in the profile")
                main.setdefault(tag, row)
            else:
                row["ms"] = cuda_ms(torch, kernel, reps, inner)
            rows.append(row)
            lib = row["library_ms"]
            mirror = ("" if mirror_err is None else
                      f" mirror_max_abs_err={mirror_err!r} (the same bits "
                      f"twice)")
            say(f"  kernel flash_attention {tag} B={B} Sq={Sq} Sk={Sk} H={H} "
                f"KV={KV} hd={hd} causal={causal} kv_valid={valid_case} "
                f"window={window} v_is_k={v is k} {row['dtype']} "
                f"route={route}: kernel_ms="
                f"{row['ms']:.6f} plain_ms={row['plain_ms']:.6f} library_ms="
                f"{'null' if lib is None else f'{lib:.6f}'} bound_ms="
                f"{row['bound_ms']:.6f} ({row['bound_by']}) "
                f"max_abs_err={err!r} tolerance={row['tolerance']}{mirror}")
            if is_main:
                say(f"    in turns (kernel, SDPA, SDPA, kernel): "
                    f"{turns[0]:.6f} {turns[1]:.6f} {turns[2]:.6f} "
                    f"{turns[3]:.6f} ms; kernel / SDPA "
                    f"{row['ms'] / lib:.3f}, bound / kernel "
                    f"{row['bound_ms'] / row['ms']:.3f}, "
                    f"{row['tflops']:.1f} TFLOP/s of the function's work; "
                    f"device time per "
                    f"call (profiler) kernel {row['device_ms']:.6f} ms "
                    f"in {row['device_kernels']:g} device kernels, "
                    f"SDPA {row['library_device_ms']:.6f} ms")
            del q, k, v, out, want
    return rows, main


def wkv_phase(torch, rw, rw_ref, peaks, seed):
    """The WKV kernels against the plain chunked recurrence on the card, with
    the route each call took: the serving path's prefill and decode shapes
    (bf16 streams with the fp32 decay the model computes, and all-fp32)
    and the ragged shapes of tests/test_kernels.py.  Tensor-core calls are
    also held against their plain mirror, ``wkv_subchunk_ref``."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed + 202)
    rows, main = [], {}
    for tag, B, S, h, Nk, Nv in WKV_CASES:
        rnd = lambda *s: torch.randn(s, generator=g, device=dev)
        r32, k32, v32 = rnd(B, S, h, Nk), rnd(B, S, h, Nk), rnd(B, S, h, Nv)
        log_w = -torch.exp(rnd(B, S, h, Nk))
        u, s0 = 0.1 * rnd(h, Nk), 0.1 * rnd(B, h, Nk, Nv)
        for dtype in (torch.bfloat16, torch.float32):
            r, k, v = (x.to(dtype) for x in (r32, k32, v32))
            rw.reset_launch_counts()
            out, sT = rw.wkv_scan(r, k, v, log_w, u, s0)
            torch.cuda.synchronize()
            routes = [w for w, n in rw.ROUTE_CALLS.items() if n]
            check(routes == [rw.route(dtype, S, Nk, Nv)]
                  and rw.LAUNCHES["wkv_scan"] == 1,
                  f"wkv {tag}: one launch on route "
                  f"{rw.route(dtype, S, Nk, Nv)}, got {rw.ROUTE_CALLS}")
            route = routes[0]
            # the recurrence at chunk 16: at chunk 64 its differences of
            # running sums drift up to 4.5e-4 from a float64 recurrence at
            # these decays, at 16 about 1.1e-4
            want, want_sT = rw.chunked_linear_recurrence(
                r, k, v, log_w, u=u, initial_state=s0, mode="rwkv",
                chunk=16, return_state=True)
            tol = 3e-4 if dtype == torch.float32 else 3e-2
            torch.testing.assert_close(out, want, rtol=tol, atol=tol)
            torch.testing.assert_close(sT, want_sT, rtol=tol, atol=tol)
            err = max(float((out.float() - want.float()).abs().max()),
                      float((sT - want_sT).abs().max()))
            mirror_err = None
            if route == "tensor_core":
                mo, ms = rw_ref.wkv_subchunk_ref(
                    r, k, v, log_w, u, s0, chunk=rw.TC_CHUNK,
                    sub=rw.TC_SUB, leaf=rw.TC_LEAF, tf32=True)
                for got, ref_, key in ((out, mo, "out"), (sT, ms, "state")):
                    m_rtol, m_atol = WKV_MIRROR_TOL[key]
                    torch.testing.assert_close(got, ref_, rtol=m_rtol,
                                               atol=m_atol)
                mirror_err = max(float((out.float() - mo.float()).abs()
                                       .max()),
                                 float((sT - ms).abs().max()))
                del mo, ms
            if route == "chunk_f32":
                # its plain version: the same chunks, blocks and sums
                mo, ms = rw_ref.wkv_chunk_f32_ref(r, k, v, log_w, u, s0,
                                                  mode="rwkv")
                torch.testing.assert_close(out, mo, rtol=tol, atol=tol)
                torch.testing.assert_close(sT, ms, rtol=tol, atol=tol)
                mirror_err = max(float((out - mo).abs().max()),
                                 float((sT - ms).abs().max()))
                del mo, ms
            size = r.element_size()
            n_in = B * S * h
            nbytes = (size * n_in * (2 * Nk + 2 * Nv) + 4 * n_in * Nk
                      + 4 * h * Nk + 8 * B * h * Nk * Nv)
            # per (t, i, j): k v product, bonus FMA, read FMA, decay FMA
            flops = 7.0 * n_in * Nk * Nv
            dname = str(dtype).replace("torch.", "")
            row = {"name": "wkv_scan", "case": tag, "B": B, "S": S, "h": h,
                   "Nk": Nk, "Nv": Nv, "dtype": dname,
                   "log_w_dtype": "float32", "route": route,
                   "max_abs_err": err, "mirror_max_abs_err": mirror_err,
                   "tolerance": f"rtol={tol},atol={tol}", "bytes": nbytes,
                   "flops": flops, "library_ms": None}
            row["bound_ms"], row["bound_by"] = bound(peaks, nbytes, flops,
                                                     dname)
            is_main = tag in ("prefill", "decode")
            row["ms"] = cuda_ms(torch, lambda: rw.wkv_scan(r, k, v, log_w, u,
                                                           s0),
                                5 if is_main else 3, 5 if is_main else 10)
            row["plain_ms"] = cuda_ms(
                torch, lambda: rw.chunked_linear_recurrence(
                    r, k, v, log_w, u=u, initial_state=s0, mode="rwkv",
                    chunk=64, return_state=True), 3, 1 if is_main else 5)
            if is_main:
                row["device_ms"], _ = device_per_call(
                    torch, lambda: rw.wkv_scan(r, k, v, log_w, u, s0))
            rows.append(row)
            if is_main:
                main.setdefault(tag, row)
            mirror = ("" if mirror_err is None else
                      f" mirror_max_abs_err={mirror_err!r}")
            say(f"  kernel wkv_scan {tag} B={B} S={S} h={h} Nk={Nk} Nv={Nv} "
                f"{row['dtype']} (log_w float32) route={route}: kernel_ms="
                f"{row['ms']:.6f} plain_ms={row['plain_ms']:.6f} "
                f"library_ms=null bound_ms={row['bound_ms']:.6f} "
                f"({row['bound_by']}) max_abs_err={err!r} "
                f"tolerance={row['tolerance']}{mirror}"
                + (f" device_ms={row['device_ms']:.6f}" if is_main else ""))
    return rows, main


# Hymba's SSM scan: its prefill over 8 x 2,560 tokens on the inclusive
# chunk_f32 kernels and one decode step on the WKV identity's step kernel;
# 25 heads, state 16, head 64, fp32 streams
SSM_CASES = [("hymba_inclusive_prefill", 8, 2560, 25, 16, 64, "chunk_f32"),
             ("hymba_inclusive_decode", 8, 1, 25, 16, 64, "step")]
# the fp32 tolerance of WKV_CASES
SSM_TOL = 3e-4


def ssm_scan_phase(torch, rw, rw_ref, ssm, linrec, peaks, seed):
    """``ssm.inclusive_scan`` on the card (one WKV call: the prefill on
    ``chunk_f32`` in inclusive mode, the decode step through the identity
    r = q * exp(log_w), u = 0, plus (q . k) v, on ``step``) against the
    plain ``chunked_linear_recurrence(mode="inclusive")`` at Hymba's shapes
    and, on ``chunk_f32``, against its plain version ``wkv_chunk_f32_ref``
    and twice for the same bits, with streams drawn as the SSM makes them
    (dt = softplus(.), log_w = dt * A, A = -[1..16]); times of the whole
    call and of the plain version (``wkv_chunk_f32_ref`` on chunk_f32, the
    chunked recurrence on step)."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed + 404)
    rows, main = [], {}
    for tag, B, S, h, Nk, Nv, route in SSM_CASES:
        rnd = lambda *s: torch.randn(s, generator=g, device=dev)
        q = rnd(B, S, h, Nk)
        dt = torch.nn.functional.softplus(rnd(B, S, h))
        A = -torch.linspace(1.0, float(Nk), Nk, device=dev)
        k, v = rnd(B, S, h, Nk) * dt[..., None], rnd(B, S, h, Nv)
        log_w, s0 = dt[..., None] * A, 0.1 * rnd(B, h, Nk, Nv)
        call = lambda: ssm.inclusive_scan(q, k, v, log_w, s0)
        rw.reset_launch_counts()
        out, sT = call()
        torch.cuda.synchronize()
        check(rw.LAUNCHES["wkv_scan"] == 1 and rw.ROUTE_CALLS[route] == 1
              and rw.PLAIN_CALLS["wkv_scan"] == 0,
              f"ssm scan {tag}: one WKV launch on {route}, got "
              f"{rw.ROUTE_CALLS}, plain {rw.PLAIN_CALLS}")
        recurrence = lambda: linrec.chunked_linear_recurrence(
            q, k, v, log_w, initial_state=s0, mode="inclusive", chunk=16,
            return_state=True)
        want, want_sT = recurrence()
        torch.testing.assert_close(out, want, rtol=SSM_TOL, atol=SSM_TOL)
        torch.testing.assert_close(sT, want_sT, rtol=SSM_TOL, atol=SSM_TOL)
        err = max(float((out - want).abs().max()),
                  float((sT - want_sT).abs().max()))
        del want, want_sT
        plain, mirror_err, same_bits = recurrence, None, None
        if route == "chunk_f32":
            plain = lambda: rw_ref.wkv_chunk_f32_ref(
                q, k, v, log_w, None, s0, mode="inclusive")
            mo, ms = plain()
            torch.testing.assert_close(out, mo, rtol=SSM_TOL, atol=SSM_TOL)
            torch.testing.assert_close(sT, ms, rtol=SSM_TOL, atol=SSM_TOL)
            mirror_err = max(float((out - mo).abs().max()),
                             float((sT - ms).abs().max()))
            del mo, ms
            again, again_sT = call()
            same_bits = bool(torch.equal(out, again)
                             and torch.equal(sT, again_sT))
            check(same_bits, f"ssm scan {tag}: two calls differ")
            del again, again_sT
        n_in = B * S * h
        # the function: q, k, log_w and v read once, out written once, the
        # state read and written
        nbytes = 4 * n_in * (3 * Nk + 2 * Nv) + 8 * B * h * Nk * Nv
        flops = 7.0 * n_in * Nk * Nv
        row = {"name": "wkv_scan", "case": tag, "B": B, "S": S, "h": h,
               "Nk": Nk, "Nv": Nv, "dtype": "float32", "route": route,
               "mode": "inclusive", "max_abs_err": err,
               "mirror_max_abs_err": mirror_err, "same_bits": same_bits,
               "tolerance": f"rtol={SSM_TOL},atol={SSM_TOL}",
               "bytes": nbytes, "flops": flops, "library_ms": None}
        if route == "chunk_f32":
            # what the three kernels move at this chunk length: (a) k,
            # log_w, v in, the chunk states and decays out; (b) those in,
            # the starting states out; (c) q, k, log_w, v and the starting
            # states in, out out
            chunks = -(-S // rw.CHUNK_F32)
            st = 4 * B * h * chunks * Nk * Nv
            dec = 4 * B * h * chunks * Nk
            row["kernel_bytes"] = (4 * n_in * (2 * Nk + Nv) + st + dec
                                   + st + dec + st
                                   + 4 * n_in * (3 * Nk + Nv) + st
                                   + 4 * n_in * Nv)
        row["bound_ms"], row["bound_by"] = bound(peaks, nbytes, flops,
                                                 "float32")
        row["ms"] = cuda_ms(torch, call, 5, 5)
        row["plain_ms"] = cuda_ms(torch, plain, 3, 1)
        row["device_ms"], row["device_kernels"] = device_per_call(torch,
                                                                  call)
        rows.append(row)
        main[tag] = row
        mirror = ("" if mirror_err is None else
                  f" mirror_max_abs_err={mirror_err!r} same_bits="
                  f"{same_bits}")
        say(f"  kernel wkv_scan {tag} (inclusive) B={B} S={S} h={h} "
            f"Nk={Nk} Nv={Nv} float32 route={route}: ms={row['ms']:.6f} "
            f"plain_ms={row['plain_ms']:.6f} library_ms=null bound_ms="
            f"{row['bound_ms']:.6f} ({row['bound_by']}) max_abs_err={err!r} "
            f"tolerance={row['tolerance']}{mirror} device_ms="
            f"{row['device_ms']:.6f} in {row['device_kernels']:g} device "
            f"kernels")
        del q, k, v, log_w, out
    return rows, main


# ---------------------------------------------------------------------------
# Phase 6: serving at full width
# ---------------------------------------------------------------------------

NEW = 32


class ServeCase(NamedTuple):
    """One arch served in phase 6.  ``prefill_routes``: the route every
    launch of each kernel takes in a time-to-first-token call;
    ``max_seq``: the cache length (None: prefix + prompt + new tokens);
    ``requests``: run ``serve`` on 12 requests (``serve`` carries no
    frontend inputs, so a model that takes them skips it); ``fp32``:
    (text tokens, prefilled tokens, layers) of the fp32 check at full
    width, layers None for the whole depth; ``profile_prefill``: profile
    one serving prefill too (where its time to first token goes)."""
    arch: str
    slots: int
    prompt: int
    prefill_routes: Dict[str, str]
    max_seq: Optional[int] = None
    requests: bool = True
    fp32: Tuple[int, int, Optional[int]] = (300, 298, None)
    profile_prefill: bool = False


SERVE_CASES = (
    # a 2,112-long cache: phase 5's decode cases read one of that length
    ServeCase("qwen2-1.5b", 8, 2048, {"flash_attention": "tensor_core"},
              2112),
    ServeCase("rwkv6-3b", 8, 2048, {"wkv_scan": "tensor_core"}, 2112),
    ServeCase("deepseek-v2-lite-16b", 8, 2048,
              {"flash_attention": "tensor_core_wide"}, 2112,
              profile_prefill=True),
    # prompts longer than the 2,048 window: the window masks in the
    # prefill and the ring (2,048 slots) wraps; the fp32 check prefills
    # 2,098 tokens so that its decode step reads a wrapped ring
    ServeCase("hymba-1.5b", 8, 2560, {"flash_attention": "tensor_core",
                                      "wkv_scan": "chunk_f32"},
              fp32=(2100, 2098, None)),
    # 1,500 stub frames; 416 + 32 tokens fill the 448-token decoder context
    ServeCase("whisper-large-v3", 8, 416, {"flash_attention": "tensor_core"},
              requests=False),
    # 2,880 stub patch embeddings + 256 tokens; 2 slots (68.8 GB of bf16
    # weights); the fp32 check (137.6 GB at full depth) at 12 of 60 layers
    ServeCase("llava-next-34b", 2, 256, {"flash_attention": "tensor_core"},
              requests=False, fp32=(60, 58, 12)),
)


def per_forward(cfg, prefill: bool) -> Dict[str, int]:
    """The LM kernels' launches in one forward of ``cfg``: flash once per
    attention (an enc-dec prefill: encoder, decoder self and cross; its
    decode step: self and cross), WKV once per RWKV or Hymba layer."""
    L = cfg.n_layers
    flash = 0 if cfg.attn_free else L
    if cfg.family == "encdec":
        flash = 2 * L + (cfg.encoder_layers if prefill else 0)
    wkv = L if (cfg.attn_free or cfg.ssm) else 0
    return {"flash_attention": flash, "wkv_scan": wkv}


def wall(torch, fn):
    """(fn(), host ms) with the card synchronised on both sides."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def serve_phase(torch, np, lm, serve, frontends, counts, cfg, case, seed,
                smi):
    """Drive ``ServeEngine.generate`` (and ``.serve``) at full width in
    bf16 (weights and frontend inputs drawn on the card from ``seed``; MoE
    layers on the sorted dispatch), check launch counts per call (every
    prefill launch on ``case.prefill_routes``), greedy determinism, and
    fp32 decode == forward; time it."""
    V = cfg.vocab_size
    slots, prompt = case.slots, case.prompt
    rng = np.random.default_rng(seed + 303)
    total = dict.fromkeys(KERNELS + LM_KERNELS, 0)
    routes = {k: {} for k in LM_KERNELS}
    pre, dec = per_forward(cfg, True), per_forward(cfg, False)
    front_n = cfg.n_frontend_tokens if cfg.frontend == "vision" else 0
    max_seq = case.max_seq or front_n + prompt + NEW

    def run(fn, want, what, want_routes=None):
        (out, ms), launches, plain = counts(lambda: wall(torch, fn))
        check(all(launches[k] == n for k, n in want.items())
              and not any(plain.values()),
              f"{cfg.name} {what}: launches {launches} plain {plain}, "
              f"expected {want} and no plain call")
        for k2, n in launches.items():
            total[k2] += n
        for k2, route in (want_routes or {}).items():
            got = counts.routes.get(k2, {})
            check(got.get(route) == want[k2],
                  f"{cfg.name} {what}: {k2} routes {got}, expected all "
                  f"{want[k2]} calls on {route}")
        for k2 in LM_KERNELS:
            for r, n in counts.routes.get(k2, {}).items():
                routes[k2][r] = routes[k2].get(r, 0) + n
        return out, ms

    def steps(n_decode):
        return {k: pre[k] + n_decode * dec[k] for k in LM_KERNELS}

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params, init_ms = wall(torch, lambda: lm.init_params(seed, cfg,
                                                         torch.bfloat16))
    n_params = sum(t.numel() for t in lm.leaves(params))
    dev = params["embed"].device
    front = frontends.frontend_inputs(
        torch.Generator(device=dev).manual_seed(seed + 505), cfg, slots,
        torch.bfloat16)
    eng = serve.ServeEngine(cfg, params, batch_slots=slots, max_seq=max_seq,
                            dtype=torch.bfloat16, seed=seed)
    prompts = rng.integers(0, V, (slots, prompt)).astype(np.int32)
    gen = lambda n: eng.generate(prompts, n, **front)
    # the first call at these shapes pays one-time costs (allocator growth,
    # GEMM heuristics), which would also bias decode_ms below: warm up
    first, _ = run(lambda: gen(1), pre, "generate 1 warm-up")
    # time to first token: the prefill and the first greedy token, every
    # prefill launch on its route
    ttft = [run(lambda: gen(1), pre, "generate 1",
                case.prefill_routes)[1] for _ in range(3)]
    toks, gen_a = run(lambda: gen(NEW), steps(NEW - 1), f"generate {NEW}")
    again, gen_b = run(lambda: gen(NEW), steps(NEW - 1),
                       f"generate {NEW} again")
    check(np.array_equal(toks, again) and np.array_equal(toks[:, :1], first),
          f"{cfg.name}: greedy generate differs between runs")
    check(toks.shape == (slots, NEW) and ((toks >= 0) & (toks < V)).all(),
          f"{cfg.name}: generated tokens out of range")
    ttft_ms, gen_ms = statistics.median(ttft), statistics.median([gen_a,
                                                                  gen_b])
    decode_ms = (gen_ms - ttft_ms) / (NEW - 1)
    res = {"arch": cfg.name, "n_params": n_params, "dtype": "bfloat16",
           "slots": slots, "prompt": prompt, "front_tokens": front_n,
           "frontend": sorted(front), "new_tokens": NEW, "max_seq": max_seq,
           "init_ms": init_ms, "ttft_ms": ttft_ms, "ttft_runs_ms": ttft,
           "generate_runs_ms": [gen_a, gen_b], "generate_ms": gen_ms,
           "decode_ms_per_step": decode_ms,
           "generate_tokens_per_s": slots * NEW / (gen_ms / 1e3),
           "launches_per_prefill": pre, "launches_per_decode_step": dec}
    serve_text = "serve skipped (it takes no frontend inputs)"
    if case.requests:
        # continuous batching: 12 requests, two waves of up to 8 slots
        reqs = [serve.Request(rng.integers(0, V, int(rng.integers(
            64, prompt + 1))).astype(np.int32), int(rng.integers(8, NEW + 1)))
            for _ in range(12)]
        want = {k: sum(steps(max(r.max_new_tokens
                                 for r in reqs[i:i + slots]) - 1)[k]
                       for i in range(0, len(reqs), slots))
                for k in LM_KERNELS}
        done, serve_ms = run(lambda: eng.serve(reqs), want,
                             "serve 12 requests")
        check(all(r.done and len(r.out_tokens) == r.max_new_tokens
                  for r in done),
              f"{cfg.name}: serve left a request unfinished")
        n_served = sum(r.max_new_tokens for r in done)
        res.update(serve_ms=serve_ms, serve_new_tokens=n_served,
                   serve_tokens_per_s=n_served / (serve_ms / 1e3),
                   serve_prompt_lens=[len(r.prompt) for r in reqs],
                   serve_max_new=[r.max_new_tokens for r in reqs])
        serve_text = (f"serve 12 requests {n_served} tokens in "
                      f"{serve_ms:.3f} ms "
                      f"({res['serve_tokens_per_s']:.1f} tok/s)")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    total_gb = torch.cuda.get_device_properties(dev).total_memory / 1e9
    prof = profile_decode(torch, lm, cfg, params, prompts, front, counts,
                          dec, slots, max_seq)
    pre_prof = (profile_prefill(torch, lm, cfg, params, prompts, front,
                                counts, pre, slots, max_seq)
                if case.profile_prefill else None)
    del eng, params, front
    torch.cuda.empty_cache()
    # fp32 at full width (a cut depth where fp32 weights outgrow the card):
    # prefill and decode logits equal forward's.  MoE layers take the
    # capacity-less dispatch here: the sorted one keeps C = f(tokens routed
    # in the call) choices an expert, so a decode step (2 tokens, C = 1)
    # drops choices that forward (600 tokens) keeps
    n_text, n_pre, depth = case.fp32
    cfg32 = cfg if depth is None else dataclasses.replace(cfg,
                                                          n_layers=depth)
    pre32, dec32 = per_forward(cfg32, True), per_forward(cfg32, False)
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False      # full fp32 products
    try:
        params = lm.init_params(seed, cfg32, torch.float32)
        toks32 = torch.as_tensor(rng.integers(0, V, (2, n_text)), device=dev)
        front32 = frontends.frontend_inputs(
            torch.Generator(device=dev).manual_seed(seed + 606), cfg32, 2)
        with torch.inference_mode():
            (full, _, _), _ = run(lambda: lm.forward(
                params, cfg32, toks32, dense_moe=True, **front32), pre32,
                "forward fp32")
            cache = lm.init_cache(cfg32, 2, front_n + n_text + 4,
                                  torch.float32, device=dev)
            (lg_pre, cache), _ = run(lambda: lm.prefill(
                params, cfg32, toks32[:, :n_pre], cache, dense_moe=True,
                **front32), pre32, "prefill fp32")
            (lg_dec, cache), _ = run(lambda: lm.decode_step(
                params, cfg32, toks32[:, n_pre], cache, front_n + n_pre,
                dense_moe=True), dec32, "decode_step fp32")
        check(bool(torch.isfinite(full).all())
              and tuple(full.shape) == (2, front_n + n_text, V),
              f"{cfg.name}: forward logits not finite or mis-shaped")
        errs = [float((lg_pre - full[:, front_n + n_pre - 1]).abs().max()),
                float((lg_dec - full[:, front_n + n_pre]).abs().max())]
        check(max(errs) < 2e-3, f"{cfg.name}: decode vs forward {errs}")
        del params, full, cache, front32
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    torch.cuda.empty_cache()
    res.update(peak_memory_gb=peak_gb, card_memory_gb=total_gb,
               free_at_peak_gb=total_gb - peak_gb,
               decode_vs_forward_fp32=errs,
               fp32_check={"text_tokens": n_text, "prefilled": n_pre,
                           "layers": cfg32.n_layers},
               profile=prof, prefill_profile=pre_prof, launches=total,
               routes=routes)
    shape = (f"{slots} x ({front_n} + {prompt})" if front_n
             else f"{slots} x {prompt}")
    front_text = "".join(f"; stub {k}" for k in res["frontend"])
    say(f"  serve {cfg.name}: {n_params} params bf16, init_ms={init_ms:.1f}"
        f"{front_text}; ttft_ms={ttft_ms:.3f} ({shape} prefill + first token) "
        f"decode_ms_per_step={decode_ms:.3f} generate {slots}x{NEW} tokens "
        f"in {gen_ms:.3f} ms ({res['generate_tokens_per_s']:.1f} tok/s); "
        f"{serve_text}; peak memory {peak_gb:.3f} GB of {total_gb:.3f}; "
        f"greedy identical on two runs [{smi}]")
    say(f"  serve {cfg.name} fp32 ({cfg32.n_layers} layers): |prefill - "
        f"forward| = {errs[0]!r}, |decode - forward| = {errs[1]!r} (limit "
        f"2e-3); launches a prefill {pre}, a decode step {dec}; routes "
        f"{routes}")
    say(f"  profile {cfg.name} decode step (x{prof['steps']}): wall_ms="
        f"{prof['wall_ms']:.3f} device_busy_ms={prof['device_busy_ms']:.3f} "
        f"device_idle_share={prof['idle_share']:.3f} [{smi}]")
    for k2 in prof["by_kernel"][:8]:
        say(f"    {k2['ms']:.3f} ms x{k2['count']} {k2['name']}")
    if pre_prof is not None:
        say(f"  profile {cfg.name} prefill: wall_ms="
            f"{pre_prof['wall_ms']:.3f} device_busy_ms="
            f"{pre_prof['device_busy_ms']:.3f} device_idle_share="
            f"{pre_prof['idle_share']:.3f}; flash's wide kernel "
            f"{pre_prof['flash_wide_ms']:.3f} device ms "
            f"({pre_prof['flash_wide_share']:.3f} of the busy time) [{smi}]")
        for k2 in pre_prof["by_kernel"][:8]:
            say(f"    {k2['ms']:.3f} ms x{k2['count']} {k2['name']}")
    return res


def profile_prefill(torch, lm, cfg, params, prompts, front, counts, pre,
                    slots, max_seq):
    """Device busy time, idle share and the wide flash kernel's device time
    of one warm serving prefill, by torch.profiler."""
    from torch.profiler import ProfilerActivity, profile
    dev = params["embed"].device
    tokens = torch.as_tensor(prompts, device=dev).long()
    with torch.inference_mode():
        def run():
            cache = lm.init_cache(cfg, slots, max_seq, torch.bfloat16,
                                  device=dev)
            return lm.prefill(params, cfg, tokens, cache, **front)
        run()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            (_, ms), launches, _ = counts(lambda: wall(torch, run))
    check(all(launches[k] == n for k, n in pre.items()),
          f"profiled prefill launches {launches}, expected {pre}")
    busy, by_kernel = device_time(prof)
    wide = sum(device_us(ev) for ev in prof.key_averages()
               if str(getattr(ev, "device_type", "")).endswith("CUDA")
               and "flash_tc_wide" in ev.key) / 1e3
    return {"wall_ms": ms, "device_busy_ms": busy,
            "idle_share": 1.0 - busy / ms, "flash_wide_ms": wide,
            "flash_wide_share": wide / busy if busy else 0.0,
            "by_kernel": by_kernel}


def profile_decode(torch, lm, cfg, params, prompts, front, counts, dec,
                   slots, max_seq, steps: int = 4):
    """Device busy time and idle share of ``steps`` warm decode steps after
    the serving prefill, by torch.profiler."""
    from torch.profiler import ProfilerActivity, profile
    dev = params["embed"].device
    n_front = front["prefix_embeds"].shape[1] if "prefix_embeds" in front \
        else 0
    pos0 = n_front + prompts.shape[1]
    with torch.inference_mode():
        cache = lm.init_cache(cfg, slots, max_seq, torch.bfloat16, device=dev)
        tokens = torch.as_tensor(prompts, device=dev).long()
        logits, cache = lm.prefill(params, cfg, tokens, cache, **front)
        tok = logits.argmax(-1)
        logits, cache = lm.decode_step(params, cfg, tok, cache, pos0)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            def run():
                lg = logits
                for i in range(steps):
                    lg, _ = lm.decode_step(params, cfg, lg.argmax(-1), cache,
                                           pos0 + 1 + i)
                return lg
            (_, ms), launches, _ = counts(lambda: wall(torch, run))
    check(all(launches[k] == steps * n for k, n in dec.items()),
          f"profiled decode launches {launches}, expected {steps} x {dec}")
    busy, by_kernel = device_time(prof)
    return {"steps": steps, "wall_ms": ms, "device_busy_ms": busy,
            "idle_share": 1.0 - busy / ms, "by_kernel": by_kernel}


# ---------------------------------------------------------------------------
# Phase 7: the card (kernels) against the CPU (plain versions)
# ---------------------------------------------------------------------------

# (arch, dense_moe): all ten archs, the MoE archs with both dispatches
CARD_VS_CPU = (("qwen2-1.5b", False), ("rwkv6-3b", False),
               ("deepseek-v2-lite-16b", False), ("deepseek-v2-lite-16b", True),
               ("grok-1-314b", False), ("grok-1-314b", True),
               ("granite-3-2b", False), ("qwen2-72b", False),
               ("llama3-405b", False), ("hymba-1.5b", False),
               ("whisper-large-v3", False), ("llava-next-34b", False))


def router_margin(torch, moe, fn):
    """(fn(), the smallest gap between a token's k-th and (k+1)-th router
    probability over every ``moe.route`` call ``fn`` makes): how far the
    routing was from a tie that the card and the CPU could break apart."""
    route, gaps = moe.route, []

    def spy(router_w, x, top_k):
        probs = torch.softmax(x.float() @ router_w.float(), dim=-1)
        top = probs.topk(top_k + 1, dim=-1).values
        gaps.append(float((top[:, top_k - 1] - top[:, top_k]).min()))
        return route(router_w, x, top_k)

    moe.route = spy
    try:
        out = fn()
    finally:
        moe.route = route
    return out, min(gaps)


def card_vs_cpu_phase(torch, np, lm, moe, serve, frontends, counts,
                      get_arch, seed):
    """At each arch's reduced() config, the same fp32 weights (and stub
    frontend inputs) on the card and on the CPU give the same greedy
    tokens, and logits within 1e-4 (fp32 on both sides, TF32 off; the sums
    run in other orders); MoE archs with each dispatch, beside their
    routing margin.  Hymba's 24-token prompts and 8 new tokens wrap its
    16-slot ring."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    total = dict.fromkeys(KERNELS + LM_KERNELS, 0)
    rows = []
    try:
        for name, dense_moe in CARD_VS_CPU:
            cfg = get_arch(name).reduced()
            p_cpu = lm.init_params(seed, cfg, device="cpu")
            p_gpu = tree_to(p_cpu, "cuda")
            front = frontends.frontend_inputs(
                torch.Generator().manual_seed(seed + 1), cfg, 2)
            front_gpu = tree_to(front, "cuda")
            prompts = np.random.default_rng(seed).integers(
                0, cfg.vocab_size, (2, 24)).astype(np.int32)
            cpu_eng = serve.ServeEngine(cfg, p_cpu, 2, 40,
                                        dense_moe=dense_moe, device="cpu")
            gpu_eng = serve.ServeEngine(cfg, p_gpu, 2, 40,
                                        dense_moe=dense_moe)
            margin = None
            if cfg.moe:
                want, margin = router_margin(
                    torch, moe, lambda: cpu_eng.generate(prompts, 8))
            else:
                want = cpu_eng.generate(prompts, 8, **front)
            got, launches, plain = counts(lambda: gpu_eng.generate(
                prompts, 8, **front_gpu))
            pre, dec = per_forward(cfg, True), per_forward(cfg, False)
            expect = {k: pre[k] + 7 * dec[k] for k in LM_KERNELS}
            what = f"{name} reduced dense_moe={dense_moe}"
            check(np.array_equal(got, want)
                  and all(launches[k] == n for k, n in expect.items())
                  and not any(plain.values()),
                  f"{what}: card {got.tolist()} vs cpu {want.tolist()}, "
                  f"launches {launches}, plain {plain}, router margin "
                  f"{margin}")
            toks = torch.as_tensor(prompts).long()
            with torch.inference_mode():
                lc = lm.forward(p_cpu, cfg, toks, dense_moe=dense_moe,
                                **front)[0]
                (lg, _, _), launches, _ = counts(
                    lambda: lm.forward(p_gpu, cfg, toks.cuda(),
                                       dense_moe=dense_moe, **front_gpu))
            err = float((lg.cpu() - lc).abs().max())
            check(err < 1e-4, f"{what}: card vs cpu logits {err}")
            for k2, n in launches.items():
                total[k2] += n
            rows.append({"arch": name, "dense_moe": dense_moe,
                         "greedy_equal": True, "max_abs_logit_err": err,
                         "router_margin": margin})
            say(f"  card vs cpu {what}: greedy tokens equal, max |logits| "
                f"error {err!r} (limit 1e-4)"
                + ("" if margin is None else
                   f"; smallest k-th/(k+1)-th router probability gap on "
                   f"the CPU {margin!r}"))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    return rows, total


def tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_to(v, device) for v in tree]
    return tree.to(device)


# ---------------------------------------------------------------------------
# Phase 9: training
# ---------------------------------------------------------------------------

BWD_KERNELS = ("flash_attention_backward", "wkv_scan_backward")
# (the WKV backward's main path takes its chunk route, included by
# csrc/wkv_backward.cu, whose step kernels take the other shapes)
BWD_SOURCES = {
    "flash_attention_backward":
        "src/repro_torch/kernels/flash_attention/csrc/flash_backward.cu",
    "wkv_scan_backward":
        "src/repro_torch/kernels/rwkv_scan/csrc/wkv_backward_chunk.cuh"}
# no Pallas kernel: the jnp functions the JAX package's jax.value_and_grad
# differentiates
BWD_REPLACES = {"flash_attention_backward":
                "src/repro/models/attention.py:25",
                "wkv_scan_backward": "src/repro/models/linrec.py:44"}
# gradients relative to the largest |gradient| of the tensor: fp32 FMAs in
# other orders; bf16 gradients are rounded to 2^-8 and the saved bf16
# output enters D = dO . O
BWD_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
# (tag, B, Sq, Sk, H, KV, hd, causal, window): Qwen2-1.5B's training
# microbatch (4 x 2,048, 12 heads on 2 kv heads), Whisper's encoder (one
# query head a kv head, 1,500 frames) and its cross attention (the
# 416-token decoder over the 1,500 encoder keys), Hymba's 2,048 window
# over 2,560 tokens, and MLA's hd 576 on one latent head (DeepSeek-V2-Lite:
# 16 heads), each at its serving batch: the plain version's S^2 scores fit
# the card at every one of them
TRAIN_FLASH_CASES = [
    ("qwen2_train", 4, 2048, 2048, 12, 2, 128, True, None),
    ("whisper_encoder", 8, 1500, 1500, 20, 20, 64, False, None),
    ("whisper_cross", 8, 416, 1500, 20, 20, 64, False, None),
    ("hymba_window", 8, 2560, 2560, 25, 5, 64, True, 2048),
    ("mla", 8, 2048, 2048, 16, 1, 576, True, None)]
# (tag, B, S, h, Nk, Nv): RWKV6-3B's time-mix over 8 x 2,048 and Hymba's
# SSM through the inclusive identity (r = q exp(log_w), u = 0) over
# 8 x 2,560: state 16 x head 64, log_w = dt * A with A in [-16, -1]; then
# each at the microbatch of four sequences its train step launches
TRAIN_WKV_CASES = [("rwkv6_train", 8, 2048, 40, 64, 64),
                   ("hymba_ssm", 8, 2560, 25, 16, 64),
                   ("rwkv6_train_micro", 4, 2048, 40, 64, 64),
                   ("hymba_ssm_micro", 4, 2560, 25, 16, 64)]
TRAIN_STEPS = 4
# the (a) rows the kernels line reports, fp32 and bf16, take the profiler's
# device time; the others CUDA events alone: late in the script profiler
# sessions lose records, and one of the 0.55 s hd-576 calls held none in
# nine sessions
BWD_PROFILED = ("qwen2_train", "rwkv6_train", "rwkv6_train_micro",
                "hymba_ssm_micro")
# rows whose fp32 device time is taken when the profiler holds records
# (events alone where it does not)
BWD_TRY_PROFILED = ("mla",)


def _rel(a, b) -> float:
    return float((a.float() - b.float()).abs().max()
                 / b.float().abs().max().clamp(min=1e-30))


def _sdpa_backward(torch, q, k, v, dout, causal, window):
    """One SDPA backward call (the library yardstick) on the kernel's
    inputs: autograd.grad of scaled_dot_product_attention's output, its
    graph kept, so each call is the backward alone."""
    F = torch.nn.functional
    qt, kt, vt = (x.detach().transpose(1, 2).requires_grad_()
                  for x in (q, k, v))
    kw = {"is_causal": causal}
    if window is not None:
        qi = torch.arange(q.shape[1], device=q.device)[:, None]
        kj = torch.arange(k.shape[1], device=q.device)[None, :]
        kw = {"attn_mask": (kj <= qi) & (kj > qi - window)}
    out = F.scaled_dot_product_attention(qt, kt, vt, enable_gqa=True, **kw)
    dt = dout.transpose(1, 2)

    def run():
        return [g.transpose(1, 2) for g in torch.autograd.grad(
            out, (qt, kt, vt), dt, retain_graph=True)]
    return run


def backward_phase(torch, fa, fab, fa_ref, rwb, rw_ref, peaks, seed, smi):
    """Phase 9 (a): both backward kernels against autograd through their
    plain versions on the card, fp32 and bf16, the same gradients twice bit
    for bit, CUDA-event, plain and (flash) SDPA-backward times in turns, the
    bound, and at ``BWD_PROFILED``'s rows the card's own time per call.  A
    WKV row on the ``chunk`` route is timed in turns with the ``step``
    kernels at its shape (what the route replaced)."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed + 901)
    rows, main = [], {}
    for tag, B, Sq, Sk, H, KV, hd, causal, window in TRAIN_FLASH_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype).replace("torch.", "")
            mk = lambda *s: torch.randn(*s, generator=g, device=dev).to(
                dtype)
            q, k, v = mk(B, Sq, H, hd), mk(B, Sk, KV, hd), mk(B, Sk, KV, hd)
            dout = mk(B, Sq, H, hd)
            # Whisper's cross attention: every query at position 0
            pos = (torch.zeros(Sq, dtype=torch.long, device=dev)
                   if Sq != Sk else torch.arange(Sq, device=dev))
            kw = dict(causal=causal, window=window, q_positions=pos)
            fa.reset_launch_counts()
            with torch.no_grad():
                out = fa.flash_attention(q, k, v, **kw)
            check(not fa.ROUTE_CALLS["split_kv"],
                  f"flash backward {tag}: the forward took split_kv")
            kernel = lambda: fab.flash_attention_backward(q, k, v, out, dout,
                                                          **kw)
            fab.reset_launch_counts()
            got, again = kernel(), kernel()
            torch.cuda.synchronize()
            check(fab.LAUNCHES["flash_attention_backward"] == 2,
                  f"flash backward {tag}: launches {fab.LAUNCHES}")
            plain = lambda: fa_ref.attention_backward_ref(
                q, k, v, dout, pos, causal=causal, window=window)
            want = plain()
            errs = [_rel(a, b) for a, b in zip(got, want)]
            check(all(torch.equal(a, b) for a, b in zip(got, again)),
                  f"flash backward {tag} {dname}: two calls differ")
            check(max(errs) < BWD_TOL[dname],
                  f"flash backward {tag} {dname}: errors {errs} against "
                  f"{BWD_TOL[dname]}")
            err = max(float((a.float() - b.float()).abs().max())
                      for a, b in zip(got, want))
            del want
            pairs = B * H * visible_pairs(Sq, Sk, 0, None, causal,
                                          window)[0]
            # the function's work, whatever the design: S, dP, dV, dK and
            # dQ, five products of 2 hd FLOPs a visible (row, key) pair
            flops = 10.0 * hd * pairs
            size = q.element_size()
            nbytes = size * 4 * (q.numel() + k.numel())
            b_ms, b_by = bound(peaks, nbytes, flops, dname)
            sdpa = _sdpa_backward(torch, q, k, v, dout, causal, window)
            lib_err = max(_rel(a, b) for a, b in zip(sdpa(), got))
            check(lib_err < (1e-2 if dtype == torch.float32 else 0.1),
                  f"SDPA backward disagrees with the kernel: {lib_err}")
            slow = hd > 128 or Sq * Sk * B * H > 4e9
            reps, inner = (3, 1) if slow else (3, 3)
            turns = [cuda_ms(torch, fn, reps, inner)
                     for fn in (kernel, sdpa, sdpa, kernel)]
            row = {"name": "flash_attention_backward", "case": tag, "B": B,
                   "Sq": Sq, "Sk": Sk, "H": H, "KV": KV, "hd": hd,
                   "causal": causal, "window": window, "dtype": dname,
                   "max_abs_err": err, "max_rel_err": max(errs),
                   "tolerance": f"{BWD_TOL[dname]} of max |grad|",
                   "bitwise_repeat": True, "flops": flops, "bytes": nbytes,
                   "bound_ms": b_ms, "bound_by": b_by,
                   "ms_turns": [turns[0], turns[3]],
                   "library_ms_turns": [turns[1], turns[2]],
                   "ms": statistics.mean([turns[0], turns[3]]),
                   "library_ms": statistics.mean([turns[1], turns[2]]),
                   "plain_ms": cuda_ms(torch, plain, 3, 1)}
            row["route"] = fab.route(dtype)
            row["tflops"] = flops / row["ms"] / 1e9
            row["device_ms"] = row["device_kernels"] = None
            if tag in BWD_PROFILED:
                row["device_ms"], row["device_kernels"] = device_per_call(
                    torch, kernel, calls=10)
            elif tag in BWD_TRY_PROFILED and dtype == torch.float32:
                try:
                    row["device_ms"], row["device_kernels"] = \
                        device_per_call(torch, kernel, calls=5, tries=3)
                except RuntimeError as e:      # no record: events only
                    say(f"  backward {tag}: {e}")
            rows.append(row)
            main.setdefault((tag, dname), row)
            say(f"  backward flash_attention_backward {tag} B={B} Sq={Sq} "
                f"Sk={Sk} H={H} KV={KV} hd={hd} causal={causal} "
                f"window={window} {dname} route={row['route']}: "
                f"kernel_ms={row['ms']:.6f} ({row['tflops']:.1f} TFLOP/s "
                f"of the function's work) {_device_text(row)} plain_ms="
                f"{row['plain_ms']:.6f} sdpa_backward_ms="
                f"{row['library_ms']:.6f} bound_ms={b_ms:.6f} ({b_by}) "
                f"max_rel_err={max(errs)!r} (limit {BWD_TOL[dname]}) "
                f"bitwise repeat; in turns {[round(t, 6) for t in turns]} "
                f"[{smi}]")
            del q, k, v, out, dout, got, again, sdpa
            torch.cuda.empty_cache()
    for tag, B, S, h, Nk, Nv in TRAIN_WKV_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype).replace("torch.", "")
            rnd = lambda *s: torch.randn(*s, generator=g, device=dev)
            if tag.startswith("hymba_ssm"):
                a = torch.linspace(1.0, 16.0, Nk, device=dev)
                log_w = -torch.nn.functional.softplus(rnd(B, S, h, Nk)) * a
                q, k = rnd(B, S, h, Nk), 0.5 * rnd(B, S, h, Nk)
                r = q * torch.exp(log_w)
                u = torch.zeros(h, Nk, device=dev)
            else:
                r, k = 0.5 * rnd(B, S, h, Nk), 0.5 * rnd(B, S, h, Nk)
                log_w, u = -torch.exp(rnd(B, S, h, Nk) - 1.0), \
                    0.5 * rnd(h, Nk)
            r, k = r.to(dtype), k.to(dtype)
            v, dout = rnd(B, S, h, Nv).to(dtype), rnd(B, S, h, Nv).to(dtype)
            kernel = lambda: rwb.wkv_scan_backward(r, k, v, log_w, u, dout)
            way = rwb.route(dtype, S, Nk, Nv)
            rwb.reset_launch_counts()
            got, again = kernel(), kernel()
            torch.cuda.synchronize()
            check(rwb.LAUNCHES["wkv_scan_backward"] == 2
                  and rwb.ROUTE_CALLS[way] == 2 and way == "chunk",
                  f"wkv backward {tag}: launches {rwb.LAUNCHES}, routes "
                  f"{rwb.ROUTE_CALLS}; want two on chunk")
            plain = lambda: rw_ref.wkv_backward_ref(r, k, v, log_w, u, dout)
            want = plain()
            errs = [_rel(a, b) for a, b in zip(got, want)]
            check(all(torch.equal(a, b) for a, b in zip(got, again)),
                  f"wkv backward {tag} {dname}: two calls differ")
            check(max(errs) < BWD_TOL[dname],
                  f"wkv backward {tag} {dname}: errors {errs} against "
                  f"{BWD_TOL[dname]}")
            err = max(float((a.float() - b.float()).abs().max())
                      for a, b in zip(got, want))
            del want
            size = r.element_size()
            # r, k, v, dout read, dr, dk, dv written; log_w read and dlog_w
            # written in fp32; u read, du written in fp32
            nbytes = (size * (4 * r.numel() + 3 * v.numel())
                      + 4 * 2 * log_w.numel() + 4 * 2 * u.numel())
            b_ms, b_by = bound(peaks, nbytes)
            # in turns with the step kernels: chunk, step, step, chunk
            was = lambda: rwb._launch_step(r, k, v, log_w, u, dout)
            turns = [cuda_ms(torch, fn, 3, 3)
                     for fn in (kernel, was, was, kernel)]
            row = {"name": "wkv_scan_backward", "case": tag, "B": B, "S": S,
                   "h": h, "Nk": Nk, "Nv": Nv, "dtype": dname, "route": way,
                   "max_abs_err": err, "max_rel_err": max(errs),
                   "tolerance": f"{BWD_TOL[dname]} of max |grad|",
                   "bitwise_repeat": True, "bytes": nbytes,
                   "bound_ms": b_ms, "bound_by": b_by,
                   "ms_turns": [turns[0], turns[3]],
                   "ms": statistics.mean([turns[0], turns[3]]),
                   "step_ms_turns": [turns[1], turns[2]],
                   "step_ms": statistics.mean([turns[1], turns[2]]),
                   "library_ms": None,
                   "plain_ms": cuda_ms(torch, plain, 3, 1)}
            row["device_ms"] = row["device_kernels"] = None
            if tag in BWD_PROFILED:
                row["device_ms"], row["device_kernels"] = device_per_call(
                    torch, kernel, calls=10)
            rows.append(row)
            main.setdefault((tag, dname), row)
            say(f"  backward wkv_scan_backward {tag} B={B} S={S} h={h} "
                f"Nk={Nk} Nv={Nv} {dname} route={way}: kernel_ms="
                f"{row['ms']:.6f} {_device_text(row)} was (step) "
                f"{row['step_ms']:.6f} ms plain_ms="
                f"{row['plain_ms']:.6f} bound_ms={b_ms:.6f} ({b_by}) "
                f"max_rel_err={max(errs)!r} (limit {BWD_TOL[dname]}) "
                f"bitwise repeat; in turns {[round(t, 6) for t in turns]} "
                f"[{smi}]")
            del r, k, v, dout, got, again
            torch.cuda.empty_cache()
    return rows, main


def _device_text(row) -> str:
    if row["device_ms"] is None:
        return "device_ms=not measured (CUDA events only)"
    return (f"device_ms={row['device_ms']:.6f} ({row['device_kernels']:g} "
            f"device kernels)")


def _train_run(torch, tr, opt, pipeline, counts, cfg, seed, smi):
    """A full-width train run: fp32 parameters and AdamW moments, a global
    batch of 8 x 2,048 tokens in two microbatches, remat, TRAIN_STEPS steps
    of ``make_train_step``.  The first step's launches are counted; the
    walls of the others are timed; one more step is profiled for the
    card's idle share.  Returns (info, the first step's launches, its
    plain-version calls, the profile)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    tc = tr.TrainConfig(n_microbatches=2, remat=True,
                        opt=opt.OptimizerConfig(lr=1e-3, warmup_steps=1,
                                                decay_steps=100))
    t0 = time.perf_counter()
    state = tr.init_train_state(seed, cfg, tc)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in opt.tree_leaves(state["params"]))
    pipe = pipeline.SyntheticPipeline(cfg, 8, 2048, seed=seed)
    step = tr.make_train_step(cfg, tc)
    losses, norms, walls, launches, routes = [], [], [], None, None
    for i in range(TRAIN_STEPS):
        batch = pipe.batch_at(i)
        if i == 0:
            ((state, m), ms), launches, plain = counts(
                lambda: wall(torch, lambda: step(state, batch)))
            routes = dict(counts.routes)
        else:
            (state, m), ms = wall(torch, lambda: step(state, batch))
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
        walls.append(ms)
        say(f"  train {cfg.name} step {i + 1}: loss {losses[-1]!r} "
            f"grad_norm {float(m['grad_norm'])!r} wall {ms:.1f} ms "
            f"[{smi}]")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    batch = pipe.batch_at(TRAIN_STEPS)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        (state, m), prof_ms = wall(torch, lambda: step(state, batch))
    busy, by_kernel = device_time(prof)
    step_ms = statistics.median(walls[1:])
    tokens = 8 * 2048
    info = {"arch": cfg.name, "n_layers": cfg.n_layers, "params": n_params,
            "dtype": "float32", "global_batch": [8, 2048],
            "n_microbatches": tc.n_microbatches, "remat": True,
            "optimizer": "adamw", "steps": TRAIN_STEPS, "losses": losses,
            "grad_norms": norms, "step_walls_ms": walls, "step_ms_median": step_ms,
            "tokens_per_s": tokens / step_ms * 1e3,
            "peak_memory_gb": peak_gb, "init_s": init_s,
            "launches_first_step": launches, "routes_first_step": routes,
            "profiled_step_ms": prof_ms, "device_busy_ms": busy,
            "idle_share": 1.0 - busy / prof_ms, "by_kernel": by_kernel}
    check(all(math.isfinite(x) for x in losses) and losses[-1] < losses[0],
          f"{cfg.name} training: losses {losses}")
    del state, m, batch
    return info, launches, plain, prof


def _profiled(prof, needle):
    """(device ms, records) of the profile's device kernels whose name
    holds ``needle``."""
    evs = [ev for ev in prof.key_averages()
           if str(getattr(ev, "device_type", "")).endswith("CUDA")
           and needle in ev.key]
    return sum(device_us(ev) for ev in evs) / 1e3, sum(ev.count for ev in evs)


def train_full_phase(torch, tr, opt, pipeline, counts, cfg, seed, smi):
    """Phase 9 (b): Qwen2-1.5B at full width (``_train_run``), gated on its
    flash launches: a forward and a remat recompute a layer and
    microbatch on ``mma_tf32``, one backward."""
    info, launches, plain, prof = _train_run(torch, tr, opt, pipeline,
                                             counts, cfg, seed, smi)
    routes = info["routes_first_step"] = info["routes_first_step"][
        "flash_attention"]
    L, n_micro = cfg.n_layers, info["n_microbatches"]
    want = {"flash_attention": 2 * L * n_micro,
            "flash_attention_backward": L * n_micro}
    check(all(launches[k] == n for k, n in want.items())
          and routes == {"tensor_core": 0, "tensor_core_wide": 0,
                         "split_kv": 0,
                         "mma_tf32": want["flash_attention"]}
          and not any(plain.values()),
          f"qwen2-1.5b train step launches {launches}, routes {routes}, "
          f"plain {plain}; want {want} on mma_tf32 (a forward and a remat "
          f"recompute a layer and microbatch, one backward)")
    # how much of the step the profile holds: its flash backward records
    # of the step's launches (the profiler drops records, and a dropped
    # record makes the card look idler than it was)
    records = sum(ev.count for ev in prof.key_averages()
                  if ev.key.startswith("void fa_bwd::dq_mma"))
    check(records > 0, "the profiled train step holds no flash backward "
          "record")
    # the flash forward's (mma_tf32) device time in the profiled step, and
    # how many of its launches the profile holds
    fwd_ms, fwd_records = _profiled(prof, "flash_mma")
    busy = info["device_busy_ms"]
    info.update({"profiled_flash_backward_records": [
                    records, want["flash_attention_backward"]],
                 "profiled_flash_forward_ms": fwd_ms,
                 "profiled_flash_forward_records": [
                    fwd_records, want["flash_attention"]],
                 "flash_forward_share": fwd_ms / busy})
    say(f"  train qwen2-1.5b full width ({info['params']} fp32 parameters, "
        f"AdamW, 8 x 2048 tokens in 2 microbatches, remat): step "
        f"{info['step_ms_median']:.1f} ms (median of steps "
        f"2-{TRAIN_STEPS}), {info['tokens_per_s']:.1f} tokens/s, peak "
        f"{info['peak_memory_gb']:.3f} GB allocated, losses "
        f"{[round(x, 4) for x in info['losses']]}; profiled step "
        f"{info['profiled_step_ms']:.1f} ms, device busy {busy:.1f} ms, "
        f"idle share {info['idle_share']:.3f} (the profile holds {records} "
        f"of {want['flash_attention_backward']} flash backward records); "
        f"the flash forward (mma_tf32) {fwd_ms:.1f} device ms, "
        f"{info['flash_forward_share']:.4f} of the busy time ({fwd_records} "
        f"of {want['flash_attention']} records) [{smi}]")
    for k in info["by_kernel"][:6]:
        say(f"    {k['ms']:.3f} ms x{k['count']} {k['name']}")
    del prof
    torch.cuda.empty_cache()
    return info, launches


# RWKV6-3B's full-width train step is cut in depth: a layer holds about 86 M
# parameters and the embedding and head 336 M, so 16 of its 32 layers come
# to about 1.71 B, some 57 GB at the ~33 bytes a parameter Qwen2-1.5B's
# step peaks at (fp32 weights, gradients, two AdamW moments, the functional
# update's copies, activations); all 32 would be about 100 GB.  Past
# TRAIN_RWKV_PEAK_GB it is cut again, to TRAIN_RWKV_LAYERS[1]
TRAIN_RWKV_LAYERS = (16, 12)
TRAIN_RWKV_PEAK_GB = 75.0


# the forward WKV call of (b')'s train microbatch, timed on its route
TRAIN_WKV_FORWARD = (4, 2048, 40, 64, 64)


def wkv_forward_row(torch, rw, peaks, seed, B, S, h, Nk, Nv):
    """One fp32 ``wkv_scan`` call at [B, S, h, Nk/Nv] (phase 5's inputs:
    gaussian streams, log_w = -exp of one): its route, its error against
    the chunk-16 recurrence, its ms by events and the plain version's (the
    chunk-64 recurrence), and its bound."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed + 203)
    rnd = lambda *s_: torch.randn(s_, generator=g, device=dev)
    r, k, v = rnd(B, S, h, Nk), rnd(B, S, h, Nk), rnd(B, S, h, Nv)
    log_w = -torch.exp(rnd(B, S, h, Nk))
    u, s0 = 0.1 * rnd(h, Nk), 0.1 * rnd(B, h, Nk, Nv)
    rw.reset_launch_counts()
    out, sT = rw.wkv_scan(r, k, v, log_w, u, s0)
    torch.cuda.synchronize()
    route = [w for w, n in rw.ROUTE_CALLS.items() if n]
    want, want_sT = rw.chunked_linear_recurrence(
        r, k, v, log_w, u=u, initial_state=s0, mode="rwkv", chunk=16,
        return_state=True)
    torch.testing.assert_close(out, want, rtol=3e-4, atol=3e-4)
    torch.testing.assert_close(sT, want_sT, rtol=3e-4, atol=3e-4)
    n_in = B * S * h
    nbytes = (4 * n_in * (3 * Nk + 2 * Nv) + 4 * h * Nk
              + 8 * B * h * Nk * Nv)
    row = {"B": B, "S": S, "h": h, "Nk": Nk, "Nv": Nv, "dtype": "float32",
           "route": route, "tolerance": "rtol=3e-4,atol=3e-4",
           "max_abs_err": max(float((out - want).abs().max()),
                              float((sT - want_sT).abs().max())),
           "ms": cuda_ms(torch, lambda: rw.wkv_scan(r, k, v, log_w, u, s0)),
           "plain_ms": cuda_ms(torch, lambda: rw.chunked_linear_recurrence(
               r, k, v, log_w, u=u, initial_state=s0, mode="rwkv",
               chunk=64, return_state=True), 3, 1), "library_ms": None}
    row["bound_ms"], row["bound_by"] = bound(peaks, nbytes,
                                             7.0 * n_in * Nk * Nv,
                                             "float32")
    return row


def train_rwkv_phase(torch, tr, opt, pipeline, counts, cfg, seed, smi,
                     rw=None, peaks=None):
    """Phase 9 (b'): RWKV6-3B at full width, cut in depth
    (``TRAIN_RWKV_LAYERS``), by ``_train_run``: the path that launches the
    WKV backward at full width.  Gated on its WKV launches: a forward and a
    remat recompute a layer and microbatch (``step``: fp32 at Nk 64), one
    backward on the ``chunk`` route, no plain version."""
    info = None
    for layers in TRAIN_RWKV_LAYERS:
        cut = dataclasses.replace(cfg, n_layers=layers)
        try:
            info, launches, plain, prof = _train_run(
                torch, tr, opt, pipeline, counts, cut, seed, smi)
        except torch.cuda.OutOfMemoryError:
            say(f"  train rwkv6-3b at {layers} layers ran out of memory: "
                f"cut further [{smi}]")
            torch.cuda.empty_cache()
            continue
        if info["peak_memory_gb"] <= TRAIN_RWKV_PEAK_GB:
            break
        say(f"  train rwkv6-3b at {layers} layers peaked at "
            f"{info['peak_memory_gb']:.3f} GB, past {TRAIN_RWKV_PEAK_GB} GB: "
            f"cut further [{smi}]")
        del prof
        torch.cuda.empty_cache()
    check(info is not None and info["peak_memory_gb"] <= TRAIN_RWKV_PEAK_GB,
          f"rwkv6-3b training fits under {TRAIN_RWKV_PEAK_GB} GB at "
          f"{TRAIN_RWKV_LAYERS[-1]} layers")
    L, n_micro = layers, info["n_microbatches"]
    info["cut"] = (f"{layers} of {cfg.n_layers} layers "
                   f"(dataclasses.replace(cfg, n_layers={layers})): all "
                   f"{cfg.n_layers} need about 100 GB of fp32 weights, "
                   f"gradients, AdamW moments and activations; the peak "
                   f"stays under {TRAIN_RWKV_PEAK_GB} GB")
    routes = info["routes_first_step"]
    want = {"wkv_scan": 2 * L * n_micro, "wkv_scan_backward": L * n_micro,
            "flash_attention": 0, "flash_attention_backward": 0}
    check(all(launches[k] == n for k, n in want.items())
          and routes["wkv_scan"]["step"] == want["wkv_scan"]
          and routes["wkv_scan_backward"] == {
              "chunk": want["wkv_scan_backward"], "step": 0}
          and not any(plain.values()),
          f"rwkv6-3b train step launches {launches}, routes {routes}, plain "
          f"{plain}; want {want}, wkv_scan on step (a forward and a remat "
          f"recompute a layer and microbatch), wkv_scan_backward on chunk")
    # the WKV backward's four device kernels (namespace wkvbc) in the
    # profiled step, and how many of its launches the profile holds
    bwd_ms, _ = _profiled(prof, "wkvbc::")
    _, records = _profiled(prof, "wkvbc::chunk_grads")
    check(records > 0, "the profiled rwkv6-3b step holds no WKV backward "
          "record")
    busy = info["device_busy_ms"]
    info.update({"profiled_wkv_backward_ms": bwd_ms,
                 "profiled_wkv_backward_records": [
                     records, want["wkv_scan_backward"]],
                 "wkv_backward_share": bwd_ms / busy})
    say(f"  train rwkv6-3b full width, cut to {info['cut']} "
        f"({info['params']} fp32 parameters, AdamW, 8 x 2048 tokens in 2 "
        f"microbatches, remat): step {info['step_ms_median']:.1f} ms "
        f"(median of steps 2-{TRAIN_STEPS}), {info['tokens_per_s']:.1f} "
        f"tokens/s, peak {info['peak_memory_gb']:.3f} GB allocated, losses "
        f"{[round(x, 4) for x in info['losses']]}; profiled step "
        f"{info['profiled_step_ms']:.1f} ms, device busy {busy:.1f} ms, "
        f"idle share {info['idle_share']:.3f}; the WKV backward (chunk) "
        f"{bwd_ms:.2f} device ms, {info['wkv_backward_share']:.4f} of the "
        f"busy time ({records} of {want['wkv_scan_backward']} records) "
        f"[{smi}]")
    for k in info["by_kernel"][:6]:
        say(f"    {k['ms']:.3f} ms x{k['count']} {k['name']}")
    del prof
    torch.cuda.empty_cache()
    # the step's forward WKV call, at its microbatch's shape, on its route
    row = info["wkv_forward"] = wkv_forward_row(torch, rw, peaks, seed,
                                                *TRAIN_WKV_FORWARD)
    check(row["route"] == ["step"],
          f"the train microbatch's forward WKV call took {row['route']}")
    say(f"  kernel wkv_scan rwkv6_train_micro B={row['B']} S={row['S']} "
        f"h={row['h']} Nk={row['Nk']} Nv={row['Nv']} float32 route=step "
        f"(the step's {want['wkv_scan']} forward launches): kernel_ms="
        f"{row['ms']:.6f} plain_ms={row['plain_ms']:.6f} library_ms=null "
        f"bound_ms={row['bound_ms']:.6f} ({row['bound_by']}) max_abs_err="
        f"{row['max_abs_err']!r} tolerance={row['tolerance']} [{smi}]")
    torch.cuda.empty_cache()
    return info, launches


def _leaf_errs(got, want, floor):
    """Each leaf's worst error relative to that leaf's own largest entry,
    or to ``floor`` where the leaf is smaller (zero up to rounding)."""
    return [float((a.cpu().float() - w.float()).abs().max())
            / max(float(w.abs().max()), floor) for a, w in zip(got, want)]


def train_card_vs_cpu_phase(torch, tr, opt, pipeline, counts, get_arch,
                            seed, smi):
    """Phase 9 (c): one ``make_train_step`` step at every arch's reduced()
    config from the same weights and batch on the card (kernels) and the
    CPU (plain versions), fp32 with TF32 off; the MoE archs with
    ``dense_moe`` both ways.  The gradients each step hands its optimizer
    are recorded.  Gates: loss within 1e-5; each gradient leaf within 1e-4
    of that leaf's largest entry (a leaf below 1e-3 of the tree's largest
    gradient is held to 1e-3 of it); the card's updated parameters within
    1e-4 of each leaf's update of the CPU optimizer applied to the card's
    own gradients (Adam's first step normalises each gradient element, so
    between two devices' gradients an element near zero moves its
    parameter by up to lr; this holds the optimizer's arithmetic on the
    card, and the gradient gate holds the gradients); and the card's step
    within 1e-4 of the CPU's step, absolute."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    total = dict.fromkeys(KERNELS + LM_KERNELS + BWD_KERNELS, 0)
    rows = []
    seen = []
    real_update = tr.optimizer_update

    def recording_update(grads, *rest):
        seen.append(grads)
        return real_update(grads, *rest)
    tr.optimizer_update = recording_update
    try:
        for name, dense_moe in CARD_VS_CPU:
            cfg = get_arch(name).reduced()
            tc = tr.TrainConfig(n_microbatches=1, remat=True,
                                dense_moe=dense_moe,
                                opt=opt.OptimizerConfig(lr=1e-3,
                                                        warmup_steps=1,
                                                        decay_steps=50))
            seq = 32 + (cfg.n_frontend_tokens if cfg.frontend == "vision"
                        else 0)
            batch = pipeline.SyntheticPipeline(cfg, 2, seq, seed=seed,
                                               device="cpu").batch_at(0)
            cpu = tr.init_train_state(seed, cfg, tc, device="cpu")
            gpu = tree_to(cpu, "cuda")
            bgpu = tree_to(batch, "cuda")
            step = tr.make_train_step(cfg, tc)
            seen.clear()
            new_cpu, m_cpu = step(cpu, batch)
            (new_gpu, m_gpu), launches, plain = counts(
                lambda: step(gpu, bgpu))
            g_cpu, g_gpu = seen
            want = opt.tree_leaves(g_cpu)
            floor = 1e-3 * max(float(w.abs().max()) for w in want)
            g_errs = _leaf_errs(opt.tree_leaves(g_gpu), want, floor)
            g_err = max(g_errs)
            # the CPU optimizer on the card's gradients
            ref_params, _, _ = real_update(tree_to(g_gpu, "cpu"),
                                           cpu["opt"], cpu["params"], tc.opt)
            old = opt.tree_leaves(cpu["params"])
            ref = opt.tree_leaves(ref_params)
            u_err = max(
                float((a.cpu() - r).abs().max())
                / max(float((r - o).abs().max()), 1e-3 * tc.opt.lr)
                for a, r, o in zip(opt.tree_leaves(new_gpu["params"]), ref,
                                   old))
            l_err = abs(float(m_gpu["loss"]) - float(m_cpu["loss"])) / abs(
                float(m_cpu["loss"]))
            p_err = max(float((a.cpu() - b).abs().max()) for a, b in zip(
                opt.tree_leaves(new_gpu["params"]),
                opt.tree_leaves(new_cpu["params"])))
            what = f"{name} reduced dense_moe={dense_moe}"
            uses = {"flash_attention_backward": not cfg.attn_free,
                    "wkv_scan_backward": bool(cfg.attn_free or cfg.ssm)}
            check(l_err < 1e-5 and g_err < 1e-4 and u_err < 1e-4
                  and p_err < 1e-4,
                  f"{what}: card vs cpu train step: loss {l_err}, grads "
                  f"{g_err} of each leaf's max (worst leaf "
                  f"{g_errs.index(g_err)}), update {u_err}, params {p_err}")
            check(all((launches[k] > 0) == u for k, u in uses.items())
                  and not any(plain.values()),
                  f"{what}: train step launches {launches}, plain {plain}; "
                  f"backward kernels expected {uses}")
            for k, n in launches.items():
                total[k] += n
            rows.append({"arch": name, "dense_moe": dense_moe,
                         "loss_rel_err": l_err, "grad_leaf_rel_err": g_err,
                         "update_rel_err": u_err, "param_abs_err": p_err,
                         "launches": launches})
            say(f"  train card vs cpu {what}: loss {l_err!r} (limit 1e-5), "
                f"grads {g_err!r} of each leaf's max |grad| over "
                f"{len(want)} leaves (limit 1e-4), card update {u_err!r} "
                f"of each leaf's update (limit 1e-4), params {p_err!r} "
                f"(limit 1e-4); backward launches "
                f"{ {k: launches[k] for k in BWD_KERNELS} } [{smi}]")
    finally:
        tr.optimizer_update = real_update
        torch.backends.cuda.matmul.allow_tf32 = prev
    return rows, total


def restart_rank(dev, seed: int):
    """What phase 9 (d)'s one spawned process runs (module level: it is
    imported by name): reduced qwen2 on the card, 6 steps with a checkpoint
    after step 3, preempted before step 4 and resumed through
    ``run_with_restarts``, and the uninterrupted run beside it, with
    deterministic algorithms on (the embedding's backward accumulates with
    atomics otherwise).  Returns the steps each run ran, the steps the
    resumed one reported, its tensors' count and device, and whether every
    tensor is bit-identical."""
    import tempfile

    import torch
    from repro_torch.configs import get_arch
    from repro_torch.data.pipeline import SyntheticPipeline
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train import fault
    from repro_torch.train import optimizer as opt
    from repro_torch.train import trainer as tr

    torch.use_deterministic_algorithms(True)
    cfg = get_arch("qwen2-1.5b").reduced()
    tc = tr.TrainConfig(n_microbatches=2, remat=True,
                        opt=opt.OptimizerConfig(lr=1e-3, warmup_steps=1,
                                                decay_steps=50))
    state0 = tr.init_train_state(seed, cfg, tc, device=dev)
    pipe = SyntheticPipeline(cfg, 4, 64, seed=seed, device=dev)
    step = tr.make_train_step(cfg, tc)

    def run(ckpt_dir, preempt_at):
        sim = fault.PreemptionSimulator(preempt_at)
        final, ran = {}, []

        def loop(start):
            s = state0 if start == 0 else ckpt.restore_checkpoint(
                state0, ckpt_dir)[0]
            for i in range(start, 6):
                if start == 0:
                    sim.check(i)
                s, m = step(s, pipe.batch_at(i))
                if i == 3:
                    ckpt.save_checkpoint(s, ckpt_dir, i)
                final["state"] = s
                ran.append(i)
                yield i, m
        done = [i for i, _ in fault.run_with_restarts(loop, ckpt_dir)]
        return final["state"], ran, done

    with tempfile.TemporaryDirectory() as tmp:
        straight, ran_a, _ = run(os.path.join(tmp, "a"), None)
        resumed, ran_b, done_b = run(os.path.join(tmp, "b"), 4)
    torch.cuda.synchronize()
    la, lb = opt.tree_leaves(straight), opt.tree_leaves(resumed)
    same = len(la) == len(lb) and all(
        a.dtype == b.dtype and torch.equal(a, b) for a, b in zip(la, lb))
    return ran_a, ran_b, done_b, len(la), str(la[0].device), same


def train_restart_phase(run_ranks, seed, smi):
    """Phase 9 (d): :func:`restart_rank` in one spawned process on the
    card, started with ``CUBLAS_WORKSPACE_CONFIG`` in its environment so
    that its cuBLAS is deterministic from its start, while this process
    and every other phase keep the default cuBLAS.  Gate: parameters,
    moments and counters bit-identical to the uninterrupted run."""
    key, before = "CUBLAS_WORKSPACE_CONFIG", os.environ.get(
        "CUBLAS_WORKSPACE_CONFIG")
    os.environ[key] = ":4096:8"
    try:
        (ran_a, ran_b, done_b, n, where, same), = run_ranks(
            restart_rank, 1, backend="gloo", device="cuda", args=(seed,),
            timeout_s=600.0)
    finally:
        if before is None:
            del os.environ[key]
        else:
            os.environ[key] = before
    check(ran_a == list(range(6)) and ran_b == list(range(6))
          and done_b[-1] == 5 and same and where.startswith("cuda"),
          f"restart on the card: steps {ran_a} / {ran_b}, bit-identical "
          f"{same}, on {where}")
    say(f"  train restart: reduced qwen2 on the card (a spawned process "
        f"with deterministic cuBLAS), preempted before step 4, resumed from "
        f"the step-3 checkpoint through run_with_restarts: {n} parameter, "
        f"moment and counter tensors bit-identical to the uninterrupted run "
        f"[{smi}]")
    return {"steps": 6, "checkpoint_at": 3, "preempt_at": 4,
            "tensors": n, "bit_identical": same}


TRAIN_PODS = 4
TRAIN_FAILED = (None, 0, 1, 2, 3)


def train_rank(dev, seed: int):
    """What each rank of phase 9 (e) runs (module level: the ranks import
    it by name): reduced qwen2's coded_r2 gradients on this rank's rack,
    with no failure and each rack failed, and its coded_encode launches."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.data.pipeline import SyntheticPipeline
    from repro_torch.distributed.meshes import make_process_mesh
    from repro_torch.kernels.coded_combine import ops
    from repro_torch.train import optimizer as opt
    from repro_torch.train import trainer as tr

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_arch("qwen2-1.5b").reduced()
    tc = tr.TrainConfig(n_microbatches=1, remat=True)
    params = tree_to(tr.init_train_state(seed, cfg, tc, device="cpu")
                     ["params"], dev)
    batch = SyntheticPipeline(cfg, 12, 16, seed=seed, device=dev).batch_at(0)
    mesh = make_process_mesh((TRAIN_PODS,), ("rack",), device=dev)
    coded = tr.make_coded_batch_r2(batch, TRAIN_PODS)
    out = {}
    for failed in TRAIN_FAILED:
        ops.reset_launch_counts()
        g, loss = tr.coded_grads_r2(params, cfg, tc, coded, mesh,
                                    failed=failed)
        torch.cuda.synchronize()
        out[failed] = ([x.cpu() for x in opt.tree_leaves(g)], float(loss),
                       dict(ops.LAUNCHES), str(g["embed"].device))
    return out


def train_ranks_phase(torch, tr, opt, pipeline, run_ranks, get_arch, seed,
                      smi):
    """Phase 9 (e): ``coded_r2`` on four ranks (one a rack) on the card
    over gloo, as phase 4c spawns them: every rank's gradient within 1e-5
    of the single-process full-batch step's largest entry, with no failure
    and with each rack failed, and one ``coded_encode`` launch per
    destination rack."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        cfg = get_arch("qwen2-1.5b").reduced()
        tc = tr.TrainConfig(n_microbatches=1, remat=True)
        params = tree_to(tr.init_train_state(seed, cfg, tc, device="cpu")
                         ["params"], "cuda")
        batch = pipeline.SyntheticPipeline(cfg, 12, 16,
                                           seed=seed).batch_at(0)
        g_ref, l_ref = tr.accumulate_grads(params, cfg, tc, batch)
        want = [x.cpu() for x in opt.tree_leaves(g_ref)]
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    scale = max(float(w.abs().max()) for w in want)
    t0 = time.perf_counter()
    results = run_ranks(train_rank, TRAIN_PODS, backend="gloo",
                        device="cuda", args=(seed,), timeout_s=600.0)
    ranks_s = time.perf_counter() - t0
    worst, launches = 0.0, dict.fromkeys(KERNELS, 0)
    for rank, out in enumerate(results):
        for failed in TRAIN_FAILED:
            grads, loss, ln, where = out[failed]
            err = max(float((a - w).abs().max())
                      for a, w in zip(grads, want)) / scale
            worst = max(worst, err)
            check(err < 1e-5 and abs(loss - float(l_ref)) < 1e-5 * abs(
                float(l_ref)) and where.startswith("cuda"),
                  f"coded_r2 rank {rank} failed={failed}: gradient {err} "
                  f"of max |grad|, loss {loss} vs {float(l_ref)}, on "
                  f"{where}")
            check(ln["coded_encode"] == TRAIN_PODS
                  and not ln["coded_decode"],
                  f"coded_r2 rank {rank} failed={failed}: launches {ln}, "
                  f"want {TRAIN_PODS} coded_encode (one a destination)")
            add_counts(launches, ln)
    say(f"  train coded_r2: {TRAIN_PODS} ranks on the card over gloo, "
        f"failed in {list(TRAIN_FAILED)}: every rank's gradient within "
        f"{worst!r} of max |grad| of the full-batch step (limit 1e-5), one "
        f"coded_encode a destination rack; launches {launches}; "
        f"{ranks_s:.1f} s [{smi}]")
    return {"pods": TRAIN_PODS, "failed": list(TRAIN_FAILED),
            "worst_grad_rel_err": worst, "launches": launches,
            "seconds": ranks_s}, launches


# ---------------------------------------------------------------------------
# Phase 10: tensor parallelism (qwen2-72b at full width on four ranks)
# ---------------------------------------------------------------------------

TP_RANKS = 4
TP_ARCH = "qwen2-72b"
# (layers of 80, dtype, slots, prompt tokens, new tokens)
TP_CHECK = (2, "float32", 2, 256, 8)
TP_TIMED = (4, "bfloat16", 4, 1024, 32)
# fp32 logits against the unsharded run, of the largest |logit|: the
# row-split products (wo, w2, the head) sum in rank order
TP_LOGIT_TOL = 1e-4
# (c): reduced qwen2-72b (8 query heads on 2 kv heads: duplicated at
# model 4), (data, model) and sequence TP, a batch of 8 x 64
TP_TRAIN = (((2, 2), False), ((1, 4), True))
TP_TRAIN_BATCH = (8, 64)
# the loss relative; each gradient leaf against its own largest entry (as
# phase 9 (c)); each updated parameter against the leaf's largest, of the
# unsharded AdamW fed the gathered gradient (the sharded clipping norm
# sums in another order: an ulp of p)
TP_LOSS_TOL, TP_GRAD_TOL, TP_PARAM_TOL = 1e-5, 1e-4, 1e-6
# (c)'s archs, each reduced(): qwen2-72b (kv heads duplicated at model 4),
# DeepSeek-V2-Lite (MLA, experts split by model), Grok-1 (kv heads
# duplicated, experts split by model); the capacity-less MoE dispatch, so
# that a data-split step's groups do not move its drops
TP_TRAIN_ARCHS = (TP_ARCH, "deepseek-v2-lite-16b", "grok-1-314b")
# (d): ZeRO-3 (default_rules' FSDP overlay on 'data') composed with TP on
# (data 2, model 2): Qwen2-1.5B at full width and depth in phase 9 (b)'s
# configuration (seed, SyntheticPipeline 8 x 2,048 tokens, two
# microbatches, remat, fp32 AdamW); Z3_STEPS steps timed, the last on the
# collective clock (its wall is the step wall).  Steps 1 and 2 held to
# phase 9 (b)'s loss and clipping norm within Z3_TOL relative.
# Z3_LAYERS cuts the depth (None: all 28 layers)
Z3_ARCH = "qwen2-1.5b"
Z3_MESH = (2, 2)
Z3_STEPS = 2
Z3_LAYERS = None
Z3_TOL = 1e-5
# (e): one step of every arch under ZeRO-3 on (data 2, model 1) (two such
# meshes side by side: a 'pod' axis the rules leave alone), the dense, VLM
# and MoE archs also on (data 2, model 2), AdamW, and Adafactor on
# qwen2-72b at (2, 2), against the unsharded step on the card.  At
# reduced() no leaf reaches the overlay's 2^16 elements, so every arch runs
# reduced() widened (z3_config, as tests/test_torch_zero3.py does); a batch
# of 8 x 64
Z3E_BATCH = (8, 64)
Z3E_POD_MESH = (2, 2, 1)
Z3E_TP_MESH = (2, 2)
Z3E_ADAFACTOR = "qwen2-72b"
# a gradient leaf below Z3E_FLOOR of its tree's largest (zero up to
# rounding: Whisper's key biases) is held against Z3E_FLOOR of it, as
# phase 9 (c) does
Z3E_FLOOR = 1e-3
# (f): DeepSeek-V2-Lite at full width on (data 1, model 4): 16 of the 64
# routed experts a rank, MLA's 16 heads 4 a rank on the one hd-576 latent
# head (G = 4).  (layers of 27: None all of them, dtype, slots, prompt
# tokens, new tokens): (f1) the fp32 check, cut to the dense first layer
# and one MoE layer, under the sorted dispatch and under dense_moe; (f2)
# timed, (b)'s shape at full depth
MOE_ARCH = "deepseek-v2-lite-16b"
MOE_CHECK = (2, "float32", 2, 256, 8)
MOE_TIMED = (None, "bfloat16", 4, 1024, 32)


def tp_config(get_arch, layers: int):
    """qwen2-72b at full width, cut to ``layers`` of its 80."""
    return dataclasses.replace(get_arch(TP_ARCH), n_layers=layers)


def moe_config(get_arch, layers: Optional[int]):
    """DeepSeek-V2-Lite at full width, cut to ``layers`` of its 27 (None:
    all of them)."""
    cfg = get_arch(MOE_ARCH)
    return cfg if layers is None else dataclasses.replace(cfg,
                                                          n_layers=layers)


def tp_prompts(np, cfg, slots: int, length: int, seed: int):
    return np.random.default_rng(seed + 1010).integers(
        0, cfg.vocab_size, (slots, length)).astype(np.int32)


def tp_train_config(tr, opt):
    return tr.TrainConfig(n_microbatches=1, remat=True, dense_moe=True,
                          opt=opt.OptimizerConfig(lr=1e-3, warmup_steps=2,
                                                  decay_steps=50))


def z3_config(cfg):
    """``cfg.reduced()`` widened so that the FSDP overlay splits leaves:
    vocabulary 2,048, d_ff 512, MoE experts of d_ff 128, Whisper's d_ff
    32,768 (its FFN biases ``[2, 32768]`` split by whole layers)."""
    cfg = cfg.reduced()
    kw = dict(vocab_size=2048, d_ff=512)
    if cfg.moe:
        kw["moe"] = dataclasses.replace(cfg.moe, d_ff_expert=128)
    if cfg.family == "encdec":
        kw["d_ff"] = 32768
    return dataclasses.replace(cfg, **kw)


def z3e_cases(ARCHS):
    """(arch, mesh shape, optimizer kind) of (e)."""
    out = [(a, Z3E_POD_MESH, "adamw") for a in sorted(ARCHS)]
    out += [(a, Z3E_TP_MESH, "adamw") for a in sorted(ARCHS)
            if ARCHS[a].family in ("dense", "vlm", "moe")]
    return out + [(Z3E_ADAFACTOR, Z3E_TP_MESH, "adafactor")]


def z3e_train_config(tr, opt, kind: str):
    return tr.TrainConfig(n_microbatches=1, remat=True, dense_moe=True,
                          opt=opt.OptimizerConfig(kind=kind, lr=1e-3,
                                                  warmup_steps=2,
                                                  decay_steps=50))


def tp_bounds(torch, lm, cfg, slots: int, plen: int, new: int, peaks):
    """The least device time (ms, and "bytes" or "operations") of (b)'s
    bf16 prefill and of its mean decode step on the one card that holds
    all four ranks: the bytes it must move (each layer weight and the head
    read once, the rows of the embedding table it looks up, the cache read
    and written) over the HBM rate, or its FLOPs (the 2-D weights', the
    head on the last position at prefill, attention on the visible pairs)
    over the bf16 tensor-core rate, whichever is larger."""
    meta = lm.init_params(0, cfg, torch.bfloat16, device="meta")
    trunk = lm.leaves(meta["group0"]) + [meta["final_norm"]]
    head = meta["embed" if cfg.tie_embeddings else "lm_head"].numel()
    w_bytes = 2 * (sum(x.numel() for x in trunk) + head)
    w_flops = 2 * sum(x.numel() for x in trunk if x.dim() == 2)
    H, hd, d, L = cfg.n_heads, cfg.head_dim, cfg.d_model, cfg.n_layers
    kv_tok = 2 * 2 * cfg.n_kv_heads * hd * L          # bf16 k and v bytes
    tokens = slots * plen
    pre = bound(peaks, w_bytes + tokens * (2 * d + kv_tok),
                w_flops * tokens + 2 * head * slots
                + 4 * hd * H * L * slots * plen * (plen + 1) / 2,
                "bfloat16")
    # decode step i (of new - 1) reads plen + i + 1 cached positions
    keys = plen + new / 2
    step = bound(peaks, w_bytes + slots * (2 * d + kv_tok * (keys + 1)),
                 (w_flops + 2 * head) * slots + 4 * hd * H * L * slots * keys,
                 "bfloat16")
    return pre, step


def moe_bounds(torch, lm, cfg, slots: int, plen: int, new: int, peaks):
    """(f2)'s least device time (ms, and "bytes" or "operations") of the
    bf16 prefill and of its mean decode step on the one card that holds
    all four ranks: the bytes the formulation must move (every weight and
    the head read once: the sorted dispatch runs every expert on its slots,
    as the JAX formulation does; the embedding rows looked up; the latent
    cache read and written) over the HBM rate, or its FLOPs (a token's
    active 2-D weights, its top-k experts' of the 3-D expert leaves, the
    head on the last position at prefill, MLA's absorbed attention at
    2 (R + rope) + 2 R a visible pair and head) over the bf16 tensor-core
    rate, whichever is larger."""
    meta = lm.init_params(0, cfg, torch.bfloat16, device="meta")
    trunk = [x for name in meta if name.startswith("group")
             for x in lm.leaves(meta[name])] + [meta["final_norm"]]
    head = meta["embed" if cfg.tie_embeddings else "lm_head"].numel()
    w_bytes = 2 * (sum(x.numel() for x in trunk) + head)
    m, mla = cfg.moe, cfg.mla
    active = 2 * (sum(x.numel() for x in trunk if x.dim() == 2)
                  + sum(x.numel() for x in trunk if x.dim() == 3)
                  * m.top_k // m.n_routed)
    R, lat = mla.kv_lora_rank, mla.kv_lora_rank + mla.rope_head_dim
    pair = (2 * lat + 2 * R) * cfg.n_heads * cfg.n_layers
    lat_tok = 2 * lat * cfg.n_layers                  # bf16 latent bytes
    d, tokens = cfg.d_model, slots * plen
    pre = bound(peaks, w_bytes + tokens * (2 * d + lat_tok),
                active * tokens + 2 * head * slots
                + pair * slots * plen * (plen + 1) / 2, "bfloat16")
    keys = plen + new / 2
    step = bound(peaks, w_bytes + slots * (2 * d + lat_tok * (keys + 1)),
                 (active + 2 * head) * slots + pair * slots * keys,
                 "bfloat16")
    return pre, step


def tp_greedy(torch, lm, params, cfg, prompts, new: int, dtype, dev,
              dense_moe: bool = False):
    """``prefill`` then ``new`` greedy ``decode_step``s: the logits of each
    (fp32, on the CPU, [new + 1, B, V]) and the tokens [new + 1, B]."""
    with torch.inference_mode():
        B, L = prompts.shape
        cache = lm.init_cache(cfg, B, L + new, dtype, device=dev)
        lg, cache = lm.prefill(params, cfg, torch.as_tensor(
            prompts, device=dev).long(), cache, dense_moe=dense_moe)
        steps, toks = [lg.float().cpu()], [lg.argmax(-1)]
        for i in range(new):
            lg, cache = lm.decode_step(params, cfg, toks[-1], cache, L + i,
                                       dense_moe=dense_moe)
            steps.append(lg.float().cpu())
            toks.append(lg.argmax(-1))
        return torch.stack(steps), torch.stack(toks).cpu()


class _CollectiveClock:
    """Host seconds in the model's collectives, by the model call they run
    in (``lm.prefill`` or ``lm.decode_step``), beside those calls' own
    walls, so each share is read within one run: every model call and
    every outermost collective call (``psum`` calls ``all_gather``) is
    timed between two device synchronisations."""

    NAMES = ("all_gather", "psum", "psum_scatter", "all_to_all")
    CALLS = ("prefill", "decode_step")

    def __init__(self, torch, col, lm):
        self.torch, self.lm, self.call, self.depth = torch, lm, None, 0
        self.wall = dict.fromkeys(self.CALLS, 0.0)
        self.coll = dict.fromkeys(self.CALLS, 0.0)
        self.saved = ([(col, n, getattr(col, n)) for n in self.NAMES]
                      + [(lm, n, getattr(lm, n)) for n in self.CALLS])

    def __enter__(self):
        for mod, name, fn in self.saved:
            setattr(mod, name, self._model(name, fn) if mod is self.lm
                    else self._collective(fn))
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self.saved:
            setattr(mod, name, fn)

    def share(self, call: str) -> float:
        return self.coll[call] / self.wall[call]

    def _model(self, name, fn):
        def timed(*args, **kwargs):
            self.torch.cuda.synchronize()
            t0, self.call = time.perf_counter(), name
            try:
                return fn(*args, **kwargs)
            finally:
                self.torch.cuda.synchronize()
                self.wall[name] += time.perf_counter() - t0
                self.call = None
        return timed

    def _collective(self, fn):
        def timed(*args, **kwargs):
            if self.depth or self.call is None:
                return fn(*args, **kwargs)
            self.torch.cuda.synchronize()
            t0 = time.perf_counter()
            self.depth += 1
            try:
                return fn(*args, **kwargs)
            finally:
                self.depth -= 1
                self.torch.cuda.synchronize()
                self.coll[self.call] += time.perf_counter() - t0
        return timed


class _AxisClock:
    """Host seconds in the collectives over one mesh axis during the calls
    run through :meth:`run`, beside those calls' walls: every outermost
    collective over the axis (``psum_scatter`` calls ``all_to_all``) is
    timed between two device synchronisations, as ``_CollectiveClock``
    times the model axis."""

    NAMES = ("all_gather", "psum", "psum_scatter", "all_to_all")

    def __init__(self, torch, col, axis: str):
        self.torch, self.col, self.axis = torch, col, axis
        self.on, self.depth, self.wall = False, 0, 0.0
        self.by_name = dict.fromkeys(self.NAMES, 0.0)
        self.saved = [(n, getattr(col, n)) for n in self.NAMES]

    def __enter__(self):
        for name, fn in self.saved:
            setattr(self.col, name, self._timed(name, fn))
        return self

    def __exit__(self, *exc):
        for name, fn in self.saved:
            setattr(self.col, name, fn)

    def run(self, fn):
        self.torch.cuda.synchronize()
        t0, self.on = time.perf_counter(), True
        try:
            return fn()
        finally:
            self.torch.cuda.synchronize()
            self.wall += time.perf_counter() - t0
            self.on = False

    def share(self) -> float:
        return sum(self.by_name.values()) / self.wall

    def _timed(self, name, fn):
        def timed(x, mesh, axis, *args, **kwargs):
            if self.depth or not self.on or axis != self.axis:
                return fn(x, mesh, axis, *args, **kwargs)
            self.torch.cuda.synchronize()
            t0 = time.perf_counter()
            self.depth += 1
            try:
                return fn(x, mesh, axis, *args, **kwargs)
            finally:
                self.depth -= 1
                self.torch.cuda.synchronize()
                self.by_name[name] += time.perf_counter() - t0
        return timed


def zero3_full_rank(torch, tr, opt, pipeline, sh, tpl, col, get_arch,
                    counts, mesh, seed: int, dev):
    """(d) in one rank: Qwen2-1.5B at full width under ZeRO-3 and TP on
    ``mesh`` (data 2, model 2).  Returns CPU numbers."""
    cfg = get_arch(Z3_ARCH)
    if Z3_LAYERS is not None:
        cfg = dataclasses.replace(cfg, n_layers=Z3_LAYERS)
    pol = sh.ShardingPolicy(mesh, sh.default_rules(False))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    tc = tr.TrainConfig(n_microbatches=2, remat=True,
                        opt=opt.OptimizerConfig(lr=1e-3, warmup_steps=1,
                                                decay_steps=100))
    t0 = time.perf_counter()
    params = tpl.init_shard_params(seed, cfg, pol, device=dev)
    state = {"params": params, "opt": opt.init_opt_state(params, tc.opt),
             "step": torch.zeros((), dtype=torch.int32, device=dev)}
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    state_bytes = tr.state_local_bytes(state, cfg, pol)
    param_bytes = tpl.local_bytes(params)
    del params
    pipe = pipeline.SyntheticPipeline(cfg, 8, 2048, seed=seed, device=dev)
    step = tr.make_train_step(cfg, tc)
    losses, norms, walls = [], [], []
    with sh.use_policy(pol), _AxisClock(torch, col, "data") as clock:
        for i in range(Z3_STEPS):
            batch = pipe.batch_at(i)
            if i == 0:
                ((state, m), ms), launches, plain = counts(
                    lambda: wall(torch, lambda: step(state, batch)))
                routes = dict(counts.routes["flash_attention"])
            elif i == Z3_STEPS - 1:         # the last, on the clock
                state, m = clock.run(lambda: step(state, batch))
                ms = clock.wall * 1e3
            else:
                (state, m), ms = wall(torch, lambda: step(state, batch))
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
            walls.append(ms)
    out = {"n_layers": cfg.n_layers, "losses": losses, "grad_norms": norms,
           "step_walls_ms": walls, "init_s": init_s,
           "state_bytes": state_bytes, "param_bytes": param_bytes,
           "peak_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
           "launches": launches, "plain": plain, "routes": routes,
           "data_collective_s": dict(clock.by_name),
           "data_collective_share": clock.share()}
    del state, m, batch
    torch.cuda.empty_cache()
    return out


def zero3_cases_rank(torch, tr, opt, pipeline, sh, tpl, get_arch, ARCHS,
                     counts, seed: int, dev):
    """(e) in one rank: each case of :func:`z3e_cases` under ZeRO-3; the
    loss and norm, the gathered gradient and updated parameters, and the
    launches."""
    from repro_torch.distributed.meshes import make_process_mesh
    meshes = {Z3E_POD_MESH: make_process_mesh(
                  Z3E_POD_MESH, ("pod", "data", "model"), device=dev),
              Z3E_TP_MESH: make_process_mesh(
                  Z3E_TP_MESH, ("data", "model"), device=dev)}
    out, total = {}, {}
    for arch, shape, kind in z3e_cases(ARCHS):
        cfg = z3_config(get_arch(arch))
        tc = z3e_train_config(tr, opt, kind)
        full = tr.init_train_state(seed, cfg, tc, device=dev)["params"]
        batch = pipeline.SyntheticPipeline(cfg, *Z3E_BATCH, seed=seed,
                                           device=dev).batch_at(0)
        pol = sh.ShardingPolicy(meshes[shape], sh.default_rules(False))
        local = opt.tree_map(lambda x: x.clone(),
                             tpl.shard_params(full, cfg, pol))
        state = {"params": local, "opt": opt.init_opt_state(local, tc.opt),
                 "step": torch.zeros((), dtype=torch.int32, device=dev)}
        with sh.use_policy(pol):
            (new, m), launches, plain = counts(
                lambda: tr.make_train_step(cfg, tc)(state, batch))
            grads, _ = tr._policy_grads(local, cfg, tc, batch, pol)
            grads = tpl.gather_params(grads, cfg, pol)
            params = tpl.gather_params(new["params"], cfg, pol)
        out[(arch, shape, kind)] = {
            "loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
            "grads": [x.cpu() for x in opt.tree_leaves(grads)],
            "params": [x.cpu() for x in opt.tree_leaves(params)],
            "plain": plain,
            "zero3_leaves": sum(k != "rep"
                                for k in tpl.layout(cfg, pol).zkinds)}
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        del full, local, state, new, grads, params
    return out, total


def moe_rank(torch, np, lm, serve, sh, tpl, col, get_arch, counts, pol,
             mesh, seed: int, dev):
    """(f) in one rank, on (data 1, model 4): (f1) the fp32 check under
    each dispatch, (f2) the timed bf16 serving at full depth.  Returns CPU
    tensors and numbers."""
    out = {}
    layers, _, slots, plen, new = MOE_CHECK
    cfg = moe_config(get_arch, layers)
    prompts = tp_prompts(np, cfg, slots, plen, seed)
    params = tpl.init_shard_params(seed, cfg, pol, torch.float32,
                                   device=dev)
    meta = lm.init_params(0, cfg, torch.float32, device="meta")
    out["weight_bytes"] = tpl.local_bytes(params)
    out["spec_bytes"] = sh.tree_local_bytes(
        meta, sh.param_pspecs(meta, pol), mesh)
    with sh.use_policy(pol):
        for name, dense in (("sorted", False), ("dense_moe", True)):
            (steps, toks), launches, plain = counts(lambda: tp_greedy(
                torch, lm, params, cfg, prompts, new, torch.float32, dev,
                dense_moe=dense))
            out[f"check {name}"] = {
                "logits": steps, "tokens": toks, "plain": plain,
                "routes": dict(counts.routes["flash_attention"])}
            out[f"launches f1 {name}"] = launches
    del params
    torch.cuda.empty_cache()

    layers, _, slots, plen, new = MOE_TIMED
    cfg = moe_config(get_arch, layers)
    prompts = tp_prompts(np, cfg, slots, plen, seed)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    params = tpl.init_shard_params(seed, cfg, pol, torch.bfloat16,
                                   device=dev)
    torch.cuda.synchronize()
    out["init_s"] = time.perf_counter() - t0
    out["timed_weight_bytes"] = tpl.local_bytes(params)
    with sh.use_policy(pol):
        eng = serve.ServeEngine(cfg, params, slots, plen + new,
                                torch.bfloat16, device=dev)
        eng.generate(prompts, 2)                          # warm-up
        _, out["ttft_ms"] = wall(torch, lambda: eng.generate(prompts, 1))
        (gen, out["generate_ms"]), launches, plain = counts(
            lambda: wall(torch, lambda: eng.generate(prompts, new)))
        out["timed_routes"] = dict(counts.routes["flash_attention"])
        out["timed_plain"] = plain
        with _CollectiveClock(torch, col, lm) as clock:
            eng.generate(prompts, 8)
    out.update(timed_tokens=gen,
               peak_gb=torch.cuda.max_memory_allocated(dev) / 1e9,
               collective_share={c: clock.share(c) for c in clock.CALLS})
    out["launches f2"] = launches
    del params, eng
    torch.cuda.empty_cache()
    return out


def tp_rank(dev, seed: int, t_spawn: float):
    """What each of phase 10's ranks runs (module level: the ranks import
    it by name), on a ('data', 'model') process mesh over the four ranks:
    (a) the fp32 check, (b) the timed bf16 serving, (c) the train steps,
    (d) Qwen2-1.5B at full width under ZeRO-3 and TP, (e) every arch under
    ZeRO-3, (f) DeepSeek-V2-Lite serving at full width.  Returns CPU
    tensors and numbers."""
    t_enter = time.time()
    import numpy as np
    import torch
    from repro_torch.configs import ARCHS, get_arch
    from repro_torch.data import pipeline
    from repro_torch.data.pipeline import SyntheticPipeline
    from repro_torch.distributed import collectives as col
    from repro_torch.distributed import sharding as sh
    from repro_torch.distributed import tensor_parallel as tpl
    from repro_torch.distributed.meshes import make_process_mesh
    from repro_torch.kernels.flash_attention import backward as fab
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.rwkv_scan import backward as rwb
    from repro_torch.kernels.rwkv_scan import ops as rw
    from repro_torch.models import lm
    from repro_torch.serve import engine as serve
    from repro_torch.train import optimizer as opt
    from repro_torch.train import trainer as tr

    torch.backends.cuda.matmul.allow_tf32 = False
    counts = Counts(torch, (fa, fab, rw, rwb))
    mesh = make_process_mesh((1, TP_RANKS), ("data", "model"), device=dev)
    pol = sh.ShardingPolicy(mesh, sh.default_rules(False, fsdp=False))
    out = {"rank": mesh.rank, "spawn_to_rendezvous_s": t_enter - t_spawn,
           "device": str(dev)}

    # (a) the fp32 check at 2 layers
    layers, dtype, slots, plen, new = TP_CHECK
    cfg = tp_config(get_arch, layers)
    prompts = tp_prompts(np, cfg, slots, plen, seed)
    params = tpl.init_shard_params(seed, cfg, pol, torch.float32,
                                   device=dev)
    meta = lm.init_params(0, cfg, torch.float32, device="meta")
    out["weight_bytes"] = tpl.local_bytes(params)
    out["spec_bytes"] = sh.tree_local_bytes(
        meta, sh.param_pspecs(meta, pol), mesh)
    with sh.use_policy(pol):
        (steps, toks), launches, plain = counts(lambda: tp_greedy(
            torch, lm, params, cfg, prompts, new, torch.float32, dev))
        out["check_routes"] = dict(counts.routes["flash_attention"])
        out["check_plain"] = plain
        eng = serve.ServeEngine(cfg, params, slots, plen + new,
                                torch.float32, device=dev)
        gen, gen_launches, _ = counts(lambda: eng.generate(prompts, new))
        out["check_generate_routes"] = dict(
            counts.routes["flash_attention"])
    out.update(check_logits=steps, check_tokens=toks,
               check_generate=gen, launches={"a": gen_launches})
    del params, eng
    torch.cuda.empty_cache()

    # (b) timed bf16 serving at 4 layers
    layers, dtype, slots, plen, new = TP_TIMED
    cfg = tp_config(get_arch, layers)
    prompts = tp_prompts(np, cfg, slots, plen, seed)
    torch.cuda.reset_peak_memory_stats(dev)
    params = tpl.init_shard_params(seed, cfg, pol, torch.bfloat16,
                                   device=dev)
    out["timed_weight_bytes"] = tpl.local_bytes(params)
    with sh.use_policy(pol):
        eng = serve.ServeEngine(cfg, params, slots, plen + new,
                                torch.bfloat16, device=dev)
        eng.generate(prompts, 2)                          # warm-up
        _, ttft_ms = wall(torch, lambda: eng.generate(prompts, 1))
        (gen, t_ms), launches, plain = counts(
            lambda: wall(torch, lambda: eng.generate(prompts, new)))
        out["timed_routes"] = dict(counts.routes["flash_attention"])
        out["timed_plain"] = plain
        with _CollectiveClock(torch, col, lm) as clock:
            eng.generate(prompts, 8)
    out.update(timed_tokens=gen, ttft_ms=ttft_ms, generate_ms=t_ms,
               peak_gb=torch.cuda.max_memory_allocated(dev) / 1e9,
               collective_share={c: clock.share(c) for c in clock.CALLS})
    out["launches"]["b"] = launches
    del params, eng
    torch.cuda.empty_cache()

    # (c) one AdamW step of each reduced arch of TP_TRAIN_ARCHS per mesh
    tc = tp_train_config(tr, opt)
    out["train"] = {}
    tmeshes = {shape: make_process_mesh(shape, ("data", "model"),
                                        device=dev)
               for shape in {shape for shape, _ in TP_TRAIN}}
    for arch in TP_TRAIN_ARCHS:
        cfg = get_arch(arch).reduced()
        full = tr.init_train_state(seed, cfg, tc, device=dev)["params"]
        batch = SyntheticPipeline(cfg, *TP_TRAIN_BATCH, seed=seed,
                                  device=dev).batch_at(0)
        for shape, seq in TP_TRAIN:
            rules = sh.default_rules(False, fsdp=False)
            tpol = sh.ShardingPolicy(tmeshes[shape], sh.with_sequence_tp(
                rules) if seq else rules)
            local = opt.tree_map(lambda x: x.clone(),
                                 tpl.shard_params(full, cfg, tpol))
            state = {"params": local,
                     "opt": opt.init_opt_state(local, tc.opt),
                     "step": torch.zeros((), dtype=torch.int32, device=dev)}
            with sh.use_policy(tpol):
                (new_state, m), launches, plain = counts(
                    lambda: tr.make_train_step(cfg, tc)(state, batch))
                routes = dict(counts.routes["flash_attention"])
                grads, _ = tr._policy_grads(local, cfg, tc, batch, tpol)
                grads = tpl.gather_params(grads, cfg, tpol)
                params = tpl.gather_params(new_state["params"], cfg, tpol)
            out["train"][(arch, shape, seq)] = {
                "loss": float(m["loss"]),
                "grad_norm": float(m["grad_norm"]),
                "grads": [x.cpu() for x in opt.tree_leaves(grads)],
                "params": [x.cpu() for x in opt.tree_leaves(params)],
                "routes": routes, "plain": plain}
            out["launches"][f"c {arch} {shape} seq_tp={seq}"] = launches
        del full, local, state, new_state, grads, params
    torch.cuda.empty_cache()

    # (d) Qwen2-1.5B at full width under ZeRO-3 and TP
    t0 = time.perf_counter()
    dmesh = make_process_mesh(Z3_MESH, ("data", "model"), device=dev)
    out["zero3_full"] = zero3_full_rank(torch, tr, opt, pipeline, sh, tpl,
                                        col, get_arch, counts, dmesh, seed,
                                        dev)
    out["zero3_full"]["part_s"] = time.perf_counter() - t0
    out["launches"]["d"] = out["zero3_full"]["launches"]

    # (e) every arch under ZeRO-3
    t0 = time.perf_counter()
    out["zero3_cases"], out["launches"]["e"] = zero3_cases_rank(
        torch, tr, opt, pipeline, sh, tpl, get_arch, ARCHS, counts, seed,
        dev)
    out["zero3_cases_s"] = time.perf_counter() - t0

    # (f) DeepSeek-V2-Lite at full width: experts and heads over 'model'
    t0 = time.perf_counter()
    out["moe"] = moe_rank(torch, np, lm, serve, sh, tpl, col, get_arch,
                          counts, pol, mesh, seed, dev)
    out["moe"]["part_s"] = time.perf_counter() - t0
    for key in ("f1 sorted", "f1 dense_moe", "f2"):
        out["launches"][key] = out["moe"].pop(f"launches {key}")
    return out


def zero3_refs(torch, tr, opt, pipeline, get_arch, ARCHS, seed,
               device="cuda"):
    """(e)'s references: each (arch, optimizer) of :func:`z3e_cases`
    unsharded on the card: the loss and norm of its step, its gradient,
    and the parameters before it (on the CPU)."""
    refs = {}
    for arch, _, kind in z3e_cases(ARCHS):
        if (arch, kind) in refs:
            continue
        cfg = z3_config(get_arch(arch))
        tc = z3e_train_config(tr, opt, kind)
        state = tr.init_train_state(seed, cfg, tc, device=device)
        batch = pipeline.SyntheticPipeline(cfg, *Z3E_BATCH, seed=seed,
                                           device=device).batch_at(0)
        grads, _ = tr.accumulate_grads(state["params"], cfg, tc, batch)
        before = [x.cpu() for x in opt.tree_leaves(state["params"])]
        _, m = tr.make_train_step(cfg, tc)(state, batch)
        refs[(arch, kind)] = {
            "loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
            "grads": [x.cpu() for x in opt.tree_leaves(grads)],
            "before": before, "tc": tc}
        del state, grads, m
    torch.cuda.empty_cache()
    return refs


def zero3_full_gates(res, ref9, smi):
    """(d)'s gates on one rank's results against phase 9 (b)'s run."""
    r, z = res["rank"], res["zero3_full"]
    L = z["n_layers"]
    for i in range(2):
        for key in ("losses", "grad_norms"):
            want, got = ref9[key][i], z[key][i]
            check(abs(got - want) <= Z3_TOL * abs(want),
                  f"tp (d) rank {r} step {i + 1}: {key[:-1]} {got!r}, "
                  f"phase 9 (b) {want!r} (limit {Z3_TOL} relative)")
    b = z["state_bytes"]
    check(b["held"] == b["specs"] and b["duplicated"] == 0,
          f"tp (d) rank {r}: state bytes {b} (params, m and v) against "
          f"train_state_pspecs(fsdp=True)")
    want = {"tensor_core": 0, "tensor_core_wide": 0, "split_kv": 0,
            "mma_tf32": 2 * L * 2}
    check(z["routes"] == want
          and z["launches"]["flash_attention_backward"] == L * 2
          and not any(z["plain"].values()),
          f"tp (d) rank {r}: flash forward by route {z['routes']} (want "
          f"{want}: a forward and a remat recompute a layer and "
          f"microbatch), backward launches "
          f"{z['launches']['flash_attention_backward']} (want {L * 2}, a "
          f"dq_mma and a dkdv_mma each), plain {z['plain']}")
def zero3_cases_gates(torch, opt, lm, get_arch, ARCHS, results, z3_refs,
                      smi):
    """(e)'s gates on every rank's results against :func:`zero3_refs`:
    each case's loss, gathered gradient and updated parameters, and the
    kernels launched.  Returns the rows, launches and part times."""
    from repro_torch.train.optimizer import init_opt_state, optimizer_update
    e_rows = []
    for case in z3e_cases(ARCHS):
        arch, shape, kind = case
        ref = z3_refs[(arch, kind)]
        loss, tree_top = ref["loss"], max(float(g.abs().max())
                                          for g in ref["grads"])
        worst_g = worst_p = 0.0
        first = results[0]["zero3_cases"][case]
        like = opt.tree_unflatten(
            lm.init_params(0, z3_config(get_arch(arch)),
                           device="meta"), ref["before"])
        for res in results:
            got = res["zero3_cases"][case]
            g_err = max(_leaf_errs(got["grads"], ref["grads"],
                                   Z3E_FLOOR * tree_top))
            tree = lambda leaves: opt.tree_unflatten(like, leaves)
            upd, _, _ = optimizer_update(
                tree(got["grads"]), init_opt_state(like, ref["tc"].opt),
                like, ref["tc"].opt)
            p_err = max(_leaf_errs(got["params"], opt.tree_leaves(upd),
                                   0.0))
            worst_g, worst_p = max(worst_g, g_err), max(worst_p, p_err)
            check(abs(got["loss"] - loss) <= Z3_TOL * abs(loss)
                  and g_err <= TP_GRAD_TOL and p_err <= TP_PARAM_TOL
                  and got["zero3_leaves"] > 0
                  and not any(got["plain"].values())
                  and all(torch.equal(a, b) for a, b in zip(
                      got["params"], first["params"])),
                  f"tp (e) {arch} {shape} {kind} rank {res['rank']}: "
                  f"loss {got['loss']} vs {loss}, gradient {g_err}, "
                  f"parameters {p_err}, {got['zero3_leaves']} ZeRO-3 "
                  f"leaves, plain {got['plain']}")
        e_rows.append({"arch": arch, "mesh": list(shape),
                       "optimizer": kind,
                       "zero3_leaves": first["zero3_leaves"],
                       "worst_grad_rel_err": worst_g,
                       "worst_param_rel_err": worst_p})
    e_launches = {}
    for res in results:
        for k, v in res["launches"]["e"].items():
            e_launches[k] = e_launches.get(k, 0) + v
    check(all(e_launches.get(k, 0) > 0 for k in (
              "flash_attention", "flash_attention_backward",
              "wkv_scan", "wkv_scan_backward")),
          f"tp (e): flash and WKV, forward and backward, launched under "
          f"ZeRO-3: {e_launches}")
    out = {"rows": e_rows, "launches": e_launches,
           "part_s_by_rank": [res["zero3_cases_s"] for res in results]}
    say(f"  tp (e): {len(e_rows)} ZeRO-3 steps (every arch at "
        f"reduced() widened on (data 2, model 1), the dense and VLM "
        f"archs on (2, 2), Adafactor on {Z3E_ADAFACTOR} at (2, 2)) "
        f"equal the unsharded step on the card: loss within {Z3_TOL}, "
        f"gradient within {max(r['worst_grad_rel_err'] for r in e_rows)!r}"
        f" of each leaf's max (limit {TP_GRAD_TOL}), parameters within "
        f"{max(r['worst_param_rel_err'] for r in e_rows)!r} (limit "
        f"{TP_PARAM_TOL}); launches {e_launches} [{smi}]")
    return out


def moe_gates(torch, np, lm, get_arch, results, moe_ref, peaks, smi):
    """(f)'s gates on every rank's results against the unsharded runs of
    this process, and (f2)'s numbers (the slowest rank's walls)."""
    L1, _, slots1, plen1, new1 = MOE_CHECK
    worst = {}
    for res in results:
        r, f = res["rank"], res["moe"]
        for name in ("sorted", "dense_moe"):
            ref_steps, ref_toks = moe_ref[name]
            got = f[f"check {name}"]
            scale = float(ref_steps.abs().max())
            err = float((got["logits"] - ref_steps).abs().max()) / scale
            worst[name] = max(worst.get(name, 0.0), err)
            check(err <= TP_LOGIT_TOL,
                  f"tp (f1) {name} rank {r}: logits {err!r} of max |logit| "
                  f"from the unsharded run (limit {TP_LOGIT_TOL})")
            check(torch.equal(got["tokens"],
                              results[0]["moe"][f"check {name}"]["tokens"])
                  and torch.equal(got["tokens"], ref_toks),
                  f"tp (f1) {name} rank {r}: greedy tokens differ between "
                  f"ranks or from the unsharded run")
            want = {"tensor_core": 0, "tensor_core_wide": 0,
                    "split_kv": L1 * new1, "mma_tf32": L1}
            check(got["routes"] == want and not any(got["plain"].values()),
                  f"tp (f1) {name} rank {r}: flash launches by route "
                  f"{got['routes']} (want {want}), plain {got['plain']}")
        check(f["weight_bytes"] == f["spec_bytes"],
              f"tp (f1) rank {r}: {f['weight_bytes']} weight bytes, the "
              f"specs give {f['spec_bytes']}")
        L = get_arch(MOE_ARCH).n_layers
        new = MOE_TIMED[4]
        want = {"tensor_core": 0, "tensor_core_wide": L,
                "split_kv": L * (new - 1), "mma_tf32": 0}
        check(f["timed_routes"] == want
              and not any(f["timed_plain"].values()),
              f"tp (f2) rank {r}: flash launches by route "
              f"{f['timed_routes']} (want {want}), plain "
              f"{f['timed_plain']}")
        check(np.array_equal(f["timed_tokens"],
                             results[0]["moe"]["timed_tokens"]),
              f"tp (f2) rank {r}: tokens differ from rank 0's")
    fs = [res["moe"] for res in results]
    f0 = fs[0]
    say(f"  tp (f1): {MOE_ARCH} at full width, {L1} of 27 layers (the "
        f"dense first layer and one MoE layer), fp32, (data 1, model "
        f"{TP_RANKS}): 16 experts and 4 of 16 heads a rank; prefill and "
        f"{new1} decode logits within {worst['sorted']!r} (sorted) and "
        f"{worst['dense_moe']!r} (dense_moe) of max |logit| of the "
        f"unsharded run (limit {TP_LOGIT_TOL}); greedy tokens identical "
        f"on every rank and to the unsharded run; weight bytes a rank "
        f"{f0['weight_bytes']} == the specs' local bytes; flash a rank by "
        f"route {f0['check sorted']['routes']} [{smi}]")
    _, _, slots, plen, new = MOE_TIMED
    cfg = moe_config(get_arch, MOE_TIMED[0])
    ttft = max(f["ttft_ms"] for f in fs)
    gen_ms = max(f["generate_ms"] for f in fs)
    step_ms = (gen_ms - ttft) / (new - 1)
    (pre_bound, pre_by), (step_bound, step_by) = moe_bounds(
        torch, lm, cfg, slots, plen, new, peaks)
    agree = float(np.mean(f0["timed_tokens"] == moe_ref["timed"]))
    info = {"arch": MOE_ARCH, "ranks": TP_RANKS, "backend": "gloo",
            "card": smi, "check": {
                "layers": L1, "dtype": MOE_CHECK[1], "slots": slots1,
                "prompt": plen1, "new": new1,
                "worst_logit_rel_err": worst,
                "weight_bytes_per_rank": f0["weight_bytes"],
                "routes_per_rank": f0["check sorted"]["routes"]},
            "timed": {
                "layers": cfg.n_layers, "dtype": MOE_TIMED[1],
                "slots": slots, "prompt": plen, "new": new,
                "ttft_ms": ttft, "generate_ms": gen_ms,
                "decode_ms_per_step": step_ms,
                "prefill_bound_ms": pre_bound, "prefill_bound_by": pre_by,
                "decode_step_bound_ms": step_bound,
                "decode_step_bound_by": step_by,
                "tokens_per_s": slots * new / (gen_ms / 1e3),
                "peak_gb_by_rank": [f["peak_gb"] for f in fs],
                "weight_gb_per_rank": f0["timed_weight_bytes"] / 1e9,
                "init_s_by_rank": [f["init_s"] for f in fs],
                "collective_share_prefill": max(
                    f["collective_share"]["prefill"] for f in fs),
                "collective_share_decode": max(
                    f["collective_share"]["decode_step"] for f in fs),
                "greedy_agreement_with_unsharded_bf16": agree,
                "routes_per_rank": f0["timed_routes"]},
            "part_s_by_rank": [f["part_s"] for f in fs]}
    t = info["timed"]
    say(f"  tp (f2): {MOE_ARCH} at full width and depth ({cfg.n_layers} "
        f"layers), bf16, {slots} slots x {plen}-token prompts + {new} new, "
        f"(data 1, model {TP_RANKS}), 4 ranks over gloo on one card: TTFT "
        f"{ttft!r} ms (the prefill's device bound {pre_bound!r} ms, "
        f"{pre_by}), decode {step_ms!r} ms a step (bound {step_bound!r} "
        f"ms, {step_by}), {t['tokens_per_s']!r} tokens/s; weights "
        f"{t['weight_gb_per_rank']!r} GB a rank, peak GB by rank "
        f"{t['peak_gb_by_rank']}; model-axis collectives "
        f"{t['collective_share_prefill']!r} of a prefill and "
        f"{t['collective_share_decode']!r} of a decode step (host clock, a "
        f"synchronisation around each); flash a rank by route "
        f"{f0['timed_routes']}; greedy agreement with the unsharded bf16 "
        f"run {agree!r} (not gated); part "
        f"{max(info['part_s_by_rank']):.1f} s [{smi}]")
    return info


def tp_phase(torch, np, lm, serve, tr, opt, pipeline, run_ranks, get_arch,
             peaks, seed, smi, ref9=None):
    """Phase 10: the unsharded references in this process, then one spawn
    of ``tp_rank`` on four ranks over gloo on the card; the gates and the
    printed numbers.  ``ref9``: phase 9 (b)'s run, which (d) is held to.
    Returns (info, launches summed over ranks and parts)."""
    from repro_torch.distributed import sharding as sh
    from repro_torch.train.optimizer import adamw_update, init_opt_state
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    t_phase = time.perf_counter()
    try:
        # (a) reference: the unsharded port, fp32, 2 layers
        layers, _, slots, plen, new = TP_CHECK
        cfg = tp_config(get_arch, layers)
        prompts = tp_prompts(np, cfg, slots, plen, seed)
        params = lm.init_params(seed, cfg, torch.float32, device="cuda")
        ref_steps, ref_toks = tp_greedy(torch, lm, params, cfg, prompts,
                                        new, torch.float32, "cuda")
        ref_gen = serve.ServeEngine(cfg, params, slots, plen + new,
                                    torch.float32, device="cuda"
                                    ).generate(prompts, new)
        del params
        torch.cuda.empty_cache()
        # (b) reference tokens: unsharded bf16, 4 layers
        layers, _, slots, plen, new = TP_TIMED
        cfg_b = tp_config(get_arch, layers)
        params = lm.init_params(seed, cfg_b, torch.bfloat16, device="cuda")
        ref_timed = serve.ServeEngine(cfg_b, params, slots, plen + new,
                                      torch.bfloat16, device="cuda"
                                      ).generate(
            tp_prompts(np, cfg_b, slots, plen, seed), new)
        del params
        torch.cuda.empty_cache()
        # (c) references: each arch's unsharded full-batch step
        tc = tp_train_config(tr, opt)
        train_refs = {}
        for arch in TP_TRAIN_ARCHS:
            rcfg = get_arch(arch).reduced()
            state = tr.init_train_state(seed, rcfg, tc, device="cuda")
            batch = pipeline.SyntheticPipeline(rcfg, *TP_TRAIN_BATCH,
                                               seed=seed,
                                               device="cuda").batch_at(0)
            ref_grads, _ = tr.accumulate_grads(state["params"], rcfg, tc,
                                               batch)
            _, ref_m = tr.make_train_step(rcfg, tc)(state, batch)
            train_refs[arch] = (state["params"], ref_grads, ref_m)
        del state, batch, ref_grads, ref_m
        # (f) references: the unsharded fp32 check under each dispatch,
        # and the unsharded bf16 model (phase 6's weights) at (f2)'s shape
        layers, _, slots, plen, new = MOE_CHECK
        mcfg = moe_config(get_arch, layers)
        params = lm.init_params(seed, mcfg, torch.float32, device="cuda")
        moe_ref = {name: tp_greedy(torch, lm, params, mcfg, tp_prompts(
            np, mcfg, slots, plen, seed), new, torch.float32, "cuda",
            dense_moe=dense)
            for name, dense in (("sorted", False), ("dense_moe", True))}
        del params
        torch.cuda.empty_cache()
        layers, _, slots, plen, new = MOE_TIMED
        mcfg = moe_config(get_arch, layers)
        params = lm.init_params(seed, mcfg, torch.bfloat16, device="cuda")
        moe_ref["timed"] = serve.ServeEngine(
            mcfg, params, slots, plen + new, torch.bfloat16,
            device="cuda").generate(tp_prompts(np, mcfg, slots, plen, seed),
                                    new)
        del params
        torch.cuda.empty_cache()
        # (e) references
        from repro_torch.configs import ARCHS
        z3_refs = zero3_refs(torch, tr, opt, pipeline, get_arch, ARCHS,
                             seed)
        ref_s = time.perf_counter() - t_phase
        t_spawn = time.time()
        t0 = time.perf_counter()
        results = run_ranks(tp_rank, TP_RANKS, backend="gloo",
                            device="cuda", args=(seed, t_spawn),
                            timeout_s=900.0)
        ranks_s = time.perf_counter() - t0

        # (a) gates
        scale = float(ref_steps.abs().max())
        worst = 0.0
        for res in results:
            r = res["rank"]
            check(res["device"].startswith("cuda"),
                  f"tp rank {r} ran on {res['device']}")
            err = float((res["check_logits"] - ref_steps).abs().max())
            worst = max(worst, err / scale)
            check(err <= TP_LOGIT_TOL * scale,
                  f"tp (a) rank {r}: logits {err / scale!r} of max "
                  f"|logit| from the unsharded run (limit {TP_LOGIT_TOL})")
            check(torch.equal(res["check_tokens"], ref_toks)
                  and np.array_equal(res["check_generate"], ref_gen),
                  f"tp (a) rank {r}: greedy tokens differ from the "
                  f"unsharded run")
            check(res["weight_bytes"] == res["spec_bytes"],
                  f"tp (a) rank {r}: {res['weight_bytes']} weight bytes, "
                  f"the specs give {res['spec_bytes']}")
            want = {"tensor_core": 0, "tensor_core_wide": 0,
                    "split_kv": TP_CHECK[0] * TP_CHECK[4],
                    "mma_tf32": TP_CHECK[0]}
            check(res["check_routes"] == want
                  and not any(res["check_plain"].values()),
                  f"tp (a) rank {r}: flash launches by route "
                  f"{res['check_routes']} (want {want}), plain "
                  f"{res['check_plain']}")
            # (b) routes: tensor-core prefill at G = 8, split-kv decode
            L_b, new_b = TP_TIMED[0], TP_TIMED[4]
            want = {"tensor_core": L_b, "tensor_core_wide": 0,
                    "split_kv": L_b * (new_b - 1), "mma_tf32": 0}
            check(res["timed_routes"] == want
                  and not any(res["timed_plain"].values()),
                  f"tp (b) rank {r}: flash launches by route "
                  f"{res['timed_routes']} (want {want})")
        first = results[0]
        check(all(np.array_equal(res["timed_tokens"], first["timed_tokens"])
                  for res in results),
              "tp (b): every rank returned the same tokens")
        say(f"  tp (a): {TP_ARCH} at full width, {TP_CHECK[0]} of 80 "
            f"layers, fp32, (data 1, model {TP_RANKS}) over gloo on one "
            f"card: prefill and {TP_CHECK[4]} decode logits within "
            f"{worst!r} of max |logit| of the unsharded run (limit "
            f"{TP_LOGIT_TOL}); greedy tokens identical on every rank; "
            f"weight bytes a rank {first['weight_bytes']} == the specs' "
            f"local bytes; flash a rank by route "
            f"{first['check_routes']} (generate "
            f"{first['check_generate_routes']}) [{smi}]")

        # (b) numbers: the slowest rank's
        ttft = max(res["ttft_ms"] for res in results)
        gen_ms = max(res["generate_ms"] for res in results)
        slots, new = TP_TIMED[2], TP_TIMED[4]
        step_ms = (gen_ms - ttft) / (new - 1)
        (pre_bound, pre_by), (step_bound, step_by) = tp_bounds(
            torch, lm, cfg_b, slots, TP_TIMED[3], new, peaks)
        agree = float(np.mean(first["timed_tokens"] == ref_timed))
        info = {"arch": TP_ARCH, "ranks": TP_RANKS, "backend": "gloo",
                "card": smi, "check": {
                    "layers": TP_CHECK[0], "dtype": TP_CHECK[1],
                    "slots": TP_CHECK[2], "prompt": TP_CHECK[3],
                    "new": TP_CHECK[4], "worst_logit_rel_err": worst,
                    "weight_bytes_per_rank": first["weight_bytes"],
                    "routes_per_rank": first["check_routes"]},
                "timed": {
                    "layers": TP_TIMED[0], "dtype": TP_TIMED[1],
                    "slots": slots, "prompt": TP_TIMED[3], "new": new,
                    "ttft_ms": ttft, "generate_ms": gen_ms,
                    "decode_ms_per_step": step_ms,
                    "prefill_bound_ms": pre_bound, "prefill_bound_by": pre_by,
                    "decode_step_bound_ms": step_bound,
                    "decode_step_bound_by": step_by,
                    "tokens_per_s": slots * new / (gen_ms / 1e3),
                    "peak_gb_by_rank": [res["peak_gb"] for res in results],
                    "weight_gb_per_rank": first["timed_weight_bytes"] / 1e9,
                    "spawn_to_rendezvous_s": [res["spawn_to_rendezvous_s"]
                                              for res in results],
                    "collective_share_prefill": max(
                        res["collective_share"]["prefill"]
                        for res in results),
                    "collective_share_decode": max(
                        res["collective_share"]["decode_step"]
                        for res in results),
                    "greedy_agreement_with_unsharded_bf16": agree,
                    "routes_per_rank": first["timed_routes"]},
                "reference_s": ref_s, "ranks_s": ranks_s}
        t = info["timed"]
        say(f"  tp (b): {TP_ARCH} at full width, {TP_TIMED[0]} of 80 "
            f"layers, bf16, {slots} slots x {TP_TIMED[3]}-token prompts + "
            f"{new} new, 4 ranks over gloo on one card (not NCCL): TTFT "
            f"{ttft!r} ms (the prefill's device bound {pre_bound!r} ms, "
            f"{pre_by}), decode {step_ms!r} ms a step (bound "
            f"{step_bound!r} ms, {step_by}), "
            f"{t['tokens_per_s']!r} tokens/s; peak GB by rank "
            f"{t['peak_gb_by_rank']}; spawn to rendezvous s "
            f"{t['spawn_to_rendezvous_s']}; model-axis collectives "
            f"{t['collective_share_prefill']!r} of a prefill and "
            f"{t['collective_share_decode']!r} of a decode step (host "
            f"clock, a synchronisation around each); greedy agreement "
            f"with the unsharded bf16 run {agree!r} (not gated) [{smi}]")

        # (c) gates: each rank's loss, gathered gradient and parameters
        train_rows = []
        for arch, (shape, seq) in ((a, m) for a in TP_TRAIN_ARCHS
                                   for m in TP_TRAIN):
            before, ref_grads, ref_m = train_refs[arch]
            want_grads = [g for g in opt.tree_leaves(ref_grads)]
            loss, gnorm = float(ref_m["loss"]), float(ref_m["grad_norm"])
            worst_g = worst_p = 0.0
            for res in results:
                got = res["train"][(arch, shape, seq)]
                grads = [g.cuda() for g in got["grads"]]
                g_err = max(_rel(a, b) for a, b in zip(grads, want_grads))
                upd, _, _ = adamw_update(
                    opt.tree_unflatten(before, grads),
                    init_opt_state(before, tc.opt), before, tc.opt)
                p_err = max(_rel(a.cuda(), b) for a, b in zip(
                    got["params"], opt.tree_leaves(upd)))
                worst_g, worst_p = max(worst_g, g_err), max(worst_p, p_err)
                check(abs(got["loss"] - loss) <= TP_LOSS_TOL * abs(loss)
                      and abs(got["grad_norm"] - gnorm)
                      <= TP_LOSS_TOL * abs(gnorm)
                      and g_err <= TP_GRAD_TOL and p_err <= TP_PARAM_TOL
                      and got["routes"].get("mma_tf32", 0) > 0
                      and not any(got["plain"].values()),
                      f"tp (c) {arch} {shape} seq_tp={seq} rank "
                      f"{res['rank']}: "
                      f"loss {got['loss']} vs {loss}, norm "
                      f"{got['grad_norm']} vs {gnorm}, gradient {g_err}, "
                      f"parameters {p_err}, routes {got['routes']}, plain "
                      f"{got['plain']}")
            train_rows.append({"arch": arch, "mesh": list(shape),
                               "seq_tp": seq,
                               "worst_grad_rel_err": worst_g,
                               "worst_param_rel_err": worst_p})
            say(f"  tp (c): reduced {arch}, (data {shape[0]}, model "
                f"{shape[1]})"
                f"{' with sequence TP' if seq else ''}: one AdamW step's "
                f"loss and norm within {TP_LOSS_TOL} of the unsharded "
                f"step's, gradient within {worst_g!r} of each leaf's max "
                f"(limit {TP_GRAD_TOL}), parameters within {worst_p!r} of "
                f"the unsharded AdamW on it (limit {TP_PARAM_TOL}) [{smi}]")
        info["train"] = train_rows

        # (d) gates and numbers: Qwen2-1.5B at full width under ZeRO-3
        for res in results:
            zero3_full_gates(res, ref9, smi)
        zs = [res["zero3_full"] for res in results]
        step_ms = max(statistics.median(z["step_walls_ms"][1:]) for z in zs)
        z0 = zs[0]
        d_info = {
            "arch": Z3_ARCH, "mesh": list(Z3_MESH), "rules":
            "default_rules(False): fsdp 'data'", "n_layers": z0["n_layers"],
            "depth_cut": Z3_LAYERS is not None, "steps": Z3_STEPS,
            "losses_by_rank": [z["losses"] for z in zs],
            "grad_norms_by_rank": [z["grad_norms"] for z in zs],
            "phase9b_losses": ref9["losses"][:Z3_STEPS],
            "phase9b_grad_norms": ref9["grad_norms"][:Z3_STEPS],
            "step_walls_ms_by_rank": [z["step_walls_ms"] for z in zs],
            "step_ms": step_ms, "tokens_per_s": 8 * 2048 / step_ms * 1e3,
            "peak_gb_by_rank": [z["peak_gb"] for z in zs],
            "param_gb_per_rank": z0["param_bytes"] / 1e9,
            "state_bytes_per_rank": z0["state_bytes"],
            "init_s_by_rank": [z["init_s"] for z in zs],
            "data_collective_share_by_rank": [z["data_collective_share"]
                                              for z in zs],
            "data_collective_s_by_rank": [z["data_collective_s"]
                                          for z in zs],
            "clocked_step": Z3_STEPS,
            "routes_per_rank": z0["routes"],
            "part_s_by_rank": [z["part_s"] for z in zs], "card": smi}
        info["zero3_full"] = d_info
        say(f"  tp (d): {Z3_ARCH} at full width, {z0['n_layers']} layers"
            f"{' (depth cut)' if Z3_LAYERS is not None else ''}, fp32 "
            f"AdamW under ZeRO-3 and TP on (data {Z3_MESH[0]}, model "
            f"{Z3_MESH[1]}), 4 ranks over gloo on one card: steps 1-2 "
            f"loss and norm within {Z3_TOL} of phase 9 (b)'s on every rank "
            f"(losses {z0['losses']!r}, norms {z0['grad_norms']!r}); "
            f"params {z0['param_bytes'] / 1e9!r} GB a rank, params + m + "
            f"v {z0['state_bytes']['held'] / 1e9!r} GB == the specs'; step "
            f"{step_ms!r} ms (the slowest rank's median of steps 2-"
            f"{Z3_STEPS}, step {Z3_STEPS} on the collective clock), "
            f"{d_info['tokens_per_s']!r} tokens/s; peak GB by "
            f"rank {d_info['peak_gb_by_rank']}; 'data' collectives "
            f"{max(d_info['data_collective_share_by_rank'])!r} of step "
            f"{Z3_STEPS} (the largest over ranks; host clock, a "
            f"synchronisation around each); flash by route a rank {z0['routes']}, "
            f"backward {z0['launches']['flash_attention_backward']}; part "
            f"{max(d_info['part_s_by_rank']):.1f} s [{smi}]")

        # (e) gates: each case's loss, gradient and parameters
        info["zero3_cases"] = zero3_cases_gates(torch, opt, lm, get_arch,
                                                ARCHS, results, z3_refs,
                                                smi)
        # (f) gates and numbers: DeepSeek-V2-Lite under a model axis
        info["moe"] = moe_gates(torch, np, lm, get_arch, results, moe_ref,
                                peaks, smi)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    launches = dict.fromkeys(("flash_attention", "flash_attention_backward",
                              "wkv_scan", "wkv_scan_backward"), 0)
    for res in results:
        for part in res["launches"].values():
            add_counts(launches, part)
    check(all(launches.values()),
          f"tp: flash forward and backward launched on the path: "
          f"{launches}")
    info["launches"] = launches
    info["phase_s"] = time.perf_counter() - t_phase
    return info, launches


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=str(ROOT / "chiprun_out" /
                                         "chip_smoke.json"))
    args = ap.parse_args(argv)

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import placement as pl
    from repro_torch import resilience as res
    from repro_torch import sim
    from repro_torch.configs import ARCHS, get_arch
    from repro_torch.core import coded_collectives as cc
    from repro_torch.core.assignment import hybrid_assignment
    from repro_torch.core import costs
    from repro_torch.core import degraded as dg
    from repro_torch.core.params import TABLE1_GRID, SchemeParams
    from repro_torch.distributed.launch import run_ranks
    from repro_torch.distributed.meshes import make_mesh
    from repro_torch.kernels import _build
    from repro_torch.data import pipeline
    from repro_torch.kernels.coded_combine import ops, ref
    from repro_torch.kernels.flash_attention import backward as fab
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.flash_attention import ref as fa_ref
    from repro_torch.kernels.rwkv_scan import backward as rwb
    from repro_torch.kernels.rwkv_scan import ops as rw
    from repro_torch.kernels.rwkv_scan import ref as rw_ref
    from repro_torch.mapreduce import engine as eng
    from repro_torch.mapreduce import jobs
    from repro_torch.models import frontends, linrec, lm, moe, ssm
    from repro_torch.obs import drift, metrics, report
    from repro_torch.obs.bytes import degraded_rack_bytes, reconcile
    from repro_torch.obs.tracing import enable_tracing
    from repro_torch.resilience import faults
    from repro_torch.serve import engine as serve
    from repro_torch.sim import calibration as cal
    from repro_torch.train import optimizer as opt
    from repro_torch.train import trainer as tr

    t_start = time.perf_counter()
    # ---- 1. device -------------------------------------------------------
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader", "--id=0"],
                         capture_output=True, text=True, timeout=60,
                         check=True).stdout.strip()
    say(smi)
    smi_name = smi.split(",")[0].strip()
    check(smi_name in PEAKS, f"no published peaks for the card {smi_name!r}; "
          f"known: {sorted(PEAKS)}")
    peaks = PEAKS[smi_name]
    name = torch.cuda.get_device_name(0)
    # one nvcc per kernel source, all started together
    t0 = time.perf_counter()
    with ThreadPoolExecutor(5) as pool:
        list(pool.map(lambda m: m.build(), (ops, fa, rw, fab, rwb)))
    build_s = time.perf_counter() - t0
    # an entry exists only if this process ran nvcc (else the library was
    # built earlier from the same sources and only loaded)
    nvcc = dict(_build.BUILD_LOG)
    how = ("; ".join(f"nvcc {k} {v[0]:.3f} s" for k, v in nvcc.items())
           or "loaded libraries built earlier from the same sources")
    say(f"phase device: {name}; torch {torch.__version__} cuda "
        f"{torch.version.cuda}; kernels ready in {build_s:.3f} s ({how}); "
        f"HBM {peaks['hbm']:.3e} B/s, tensor cores bf16 "
        f"{peaks['bfloat16']:.3e} / tf32 {peaks['float32']:.3e} FLOP/s "
        f"(data sheet of {smi_name})")
    for lib, (_, ptxas) in nvcc.items():
        for line in ptxas.splitlines():
            if ("Compiling entry function" in line or "registers" in line
                    or "spill" in line):
                say(f"  ptxas {lib}: {line.strip()}")

    # ---- 2. kernels ------------------------------------------------------
    main_shapes = []
    for r in (2, 3):
        plan = cc.compile_hybrid_plan(SchemeParams(K=K, P=P, Q=Q, N=N, r=r))
        main_shapes.append((r, K * P * plan.n_send * (Q // P), D))
    check(main_shapes == [(2, 17920, D), (3, 8960, D)],
          f"main-path launch shapes {main_shapes}")
    # phase 4c's: one server's share, and the gradient's [P-1, G/P]
    rank_shapes = [(r, T // K, d) for r, T, d in main_shapes]
    grad_shape = (P - 1, GRAD_G // P // D, D)
    kernel_rows, main_rows, to_profile = kernel_phase(
        torch, ops, ref, main_shapes, rank_shapes, grad_shape, peaks,
        args.seed)
    say(f"phase kernels: {len(kernel_rows)} kernel/shape/dtype cases match "
        f"their plain versions")
    # the decode instances (r = 1..4 compiled, 0 the runtime stream count)
    if "coded_combine" in nvcc:
        for line in ptxas_entries(nvcc["coded_combine"][1],
                                  "linear_decode_kernel"):
            say(f"  ptxas coded_decode: {line}")

    # ---- 3 + 4. the main paths, launch counts zeroed before each call ----
    count = Counts(torch, (ops,))
    shuffle_runs, shuffle_launches = shuffle_phase(
        torch, np, cc, count, make_mesh, SchemeParams, args.seed)
    say(f"phase shuffle: {len(shuffle_runs)} hybrid_shuffle runs bit-exact "
        f"vs simulate_plan_shuffle and plan_shuffle_reference; launches "
        f"{shuffle_launches}")
    torch.cuda.reset_peak_memory_stats()
    engine_runs, engine_launches, subfiles, job, mesh = engine_phase(
        torch, np, eng, jobs, count, make_mesh, SchemeParams, costs,
        reconcile, args.seed)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    say(f"phase engine: {len(engine_runs)} run_job_distributed runs "
        f"bit-exact vs run_job; peak device memory {peak_gb:.3f} GB; "
        f"launches fused {engine_launches['fused']} legacy "
        f"{engine_launches['legacy']}")
    profile = profile_fused(torch, eng, count, job, subfiles, mesh,
                            SchemeParams, enable_tracing)
    idle = 1.0 - profile["device_busy_ms"] / profile["wall_ms"]
    spans = " ".join(f"{k}={v:.3f}" for k, v in profile["span_ms"].items())
    say(f"  profile fused binomial r=2 coded kernel: wall_ms="
        f"{profile['wall_ms']:.3f} device_busy_ms="
        f"{profile['device_busy_ms']:.3f} device_idle_share={idle:.3f}; "
        f"engine spans (host ms) {spans}")
    for k in profile["by_kernel"][:8]:
        say(f"    {k['ms']:.3f} ms x{k['count']} {k['name']}")

    # ---- 4b. the engine under faults -------------------------------------
    t_faults = time.perf_counter()
    fault_runs, fault_launches, phase_row = faults_phase(
        torch, np, eng, count, job, subfiles, mesh, SchemeParams, dg,
        faults, degraded_rack_bytes, smi)
    say(f"phase faults: {len(fault_runs)} faulted run_job_distributed runs "
        f"bit-exact vs the failure-free fused job, each on its expected "
        f"rung; launches {fault_launches}; "
        f"{time.perf_counter() - t_faults:.1f} s [{smi}]")

    # ---- 4c. the process form: 16 ranks on the card ---------------------
    t_ranks = time.perf_counter()
    ranks_info, ranks_launches = ranks_phase(
        torch, np, eng, cc, run_ranks, make_mesh, SchemeParams, costs,
        mesh.device, (K, P, Q, N, D), TOKENS, GRAD_G, args.seed, subfiles,
        smi)
    say(f"phase ranks: {K} ranks on one card (gloo), every job, the "
        f"coded_xor shuffle and the coded gradient reduce-scatter "
        f"bit-exact, every rank on its server's launches; launches "
        f"{ranks_launches}; {time.perf_counter() - t_ranks:.1f} s [{smi}]")

    # ---- 5. the LM kernels ------------------------------------------------
    flash_rows, flash_main = flash_phase(torch, fa, fa_ref, peaks, args.seed)
    wkv_rows, wkv_main = wkv_phase(torch, rw, rw_ref, peaks, args.seed)
    ssm_rows, ssm_main = ssm_scan_phase(torch, rw, rw_ref, ssm, linrec,
                                        peaks, args.seed)
    wkv_case_routes = {}
    for row in wkv_rows:
        wkv_case_routes[row["route"]] = wkv_case_routes.get(row["route"],
                                                            0) + 1
    check(set(wkv_case_routes) == set(rw.ROUTES),
          f"phase 5's WKV cases ran on every route: {wkv_case_routes}")
    say(f"phase lm kernels: {len(flash_rows)} flash_attention and "
        f"{len(wkv_rows)} wkv_scan shape/dtype cases match their plain "
        f"versions; wkv_scan cases by route {wkv_case_routes}; "
        f"{len(ssm_rows)} SSM scans (prefill on chunk_f32, decode through "
        f"the identity on step) match the plain inclusive recurrence")
    # the WKV kernels as compiled, and the tensor-core and chunk_f32
    # kernels' shared memory and blocks an SM as the runtime reports them
    if "wkv_scan" in nvcc:
        for needle in ("wkv_fwd", "wkv_chunk_tc", "chunk_state",
                       "chunk_scan", "chunk_out"):
            for line in ptxas_entries(nvcc["wkv_scan"][1], needle):
                say(f"  ptxas wkv_scan: {line}")
    tc_smem, tc_blocks = rw.tc_occupancy()
    say(f"  wkv_scan tensor_core: {tc_smem} bytes of dynamic shared memory "
        f"a block, {tc_blocks} blocks an SM")
    f32_occ = {nk: rw.chunk_f32_occupancy(nk) for nk in (16, 32, 64)}
    for nk, (sa, ba, sc, bc) in f32_occ.items():
        say(f"  wkv_scan chunk_f32 Nk<={nk}: chunk_state {sa} bytes, {ba} "
            f"blocks an SM; chunk_out {sc} bytes, {bc} blocks an SM")
    check(all(o[1] >= 1 and o[3] >= 1 for o in f32_occ.values()),
          f"every chunk_f32 instance fits an SM: {f32_occ}")
    # the wide tensor-core flash kernel as compiled (both key tiles)
    if "flash_attention" in nvcc:
        for line in ptxas_entries(nvcc["flash_attention"][1],
                                  "flash_tc_wide_fwd"):
            say(f"  ptxas flash_attention tensor_core_wide: {line}")

    # ---- 6. serving at full width, launch counts per call ----------------
    counts = Counts(torch, (ops, fa, rw))
    serving = {}
    for case in SERVE_CASES:
        arch = case.arch
        t_arch = time.perf_counter()
        serving[arch] = serve_phase(torch, np, lm, serve, frontends, counts,
                                    ARCHS[arch], case, args.seed, smi)
        serving[arch]["phase_s"] = time.perf_counter() - t_arch
        say(f"phase serve {arch}: ServeEngine generate and serve at full "
            f"width on the card; launches {serving[arch]['launches']}; "
            f"{serving[arch]['phase_s']:.1f} s [{smi}]")

    # ---- 7. the card against the CPU at the reduced configs --------------
    cmp_rows, cmp_launches = card_vs_cpu_phase(
        torch, np, lm, moe, serve, frontends, counts, get_arch, args.seed)
    say(f"phase card vs cpu: all {len(ARCHS)} archs at reduced() "
        f"({', '.join(sorted({r['arch'] for r in cmp_rows}))}; the MoE "
        f"archs with both dispatches) give the same greedy tokens on the "
        f"card (kernels) and the CPU (plain versions)")
    check({r["arch"] for r in cmp_rows} == set(ARCHS),
          f"card vs cpu covered every arch: {sorted(ARCHS)}")

    # ---- 2, continued: device time per call of the main combine rows ----
    profile_main_rows(torch, ops, ref, to_profile, args.seed)
    say("phase kernels (device time): the main combine rows profiled")

    # ---- 9. training ------------------------------------------------------
    # (before 4d, for its profiles: see 4d)
    t_train = time.perf_counter()
    train_counts = Counts(torch, (ops, fa, rw, fab, rwb))
    # (b) first: its profiled step is phase 9's first profiler session
    full_info, full_launches = train_full_phase(
        torch, tr, opt, pipeline, train_counts, ARCHS["qwen2-1.5b"],
        args.seed, smi)
    say(f"phase train (b): Qwen2-1.5B trains at full width, loss "
        f"{full_info['losses'][0]!r} -> {full_info['losses'][-1]!r}; "
        f"launches a step {full_launches} [{smi}]")
    rwkv_info, rwkv_launches = train_rwkv_phase(
        torch, tr, opt, pipeline, train_counts, ARCHS["rwkv6-3b"],
        args.seed, smi, rw, peaks)
    say(f"phase train (b'): RWKV6-3B trains at full width, cut to "
        f"{rwkv_info['n_layers']} layers, loss {rwkv_info['losses'][0]!r} "
        f"-> {rwkv_info['losses'][-1]!r}; launches a step {rwkv_launches}; "
        f"routes {rwkv_info['routes_first_step']} [{smi}]")
    bwd_rows, bwd_main = backward_phase(torch, fa, fab, fa_ref, rwb, rw_ref,
                                        peaks, args.seed, smi)
    say(f"phase train (a): {len(bwd_rows)} backward kernel cases match "
        f"autograd through their plain versions, each bit for bit twice "
        f"[{smi}]")
    train_cmp_rows, train_cmp_launches = train_card_vs_cpu_phase(
        torch, tr, opt, pipeline, train_counts, get_arch, args.seed, smi)
    check({r["arch"] for r in train_cmp_rows} == set(ARCHS),
          f"train card vs cpu covered every arch: {sorted(ARCHS)}")
    say(f"phase train (c): a train step of all {len(ARCHS)} archs at "
        f"reduced() (the MoE archs with both dispatches) on the card equals "
        f"the CPU's; launches {train_cmp_launches} [{smi}]")
    restart_info = train_restart_phase(run_ranks, args.seed, smi)
    say(f"phase train (d): a preempted run resumed on the card is bit-"
        f"identical to the uninterrupted one [{smi}]")
    train_ranks_info, train_ranks_launches = train_ranks_phase(
        torch, tr, opt, pipeline, run_ranks, get_arch, args.seed, smi)
    train_s = time.perf_counter() - t_train
    say(f"phase train (e): coded_r2 on {TRAIN_PODS} ranks equals the "
        f"full-batch step under every single rack failure; phase train "
        f"{train_s:.1f} s [{smi}]")

    # ---- 4d. Section IV: placement, the simulator, a placed job ---------
    # (after every other profile, and the Table I row before Table II: on
    # the card, profiles taken after this phase's million-odd eager
    # launches held about half of their kernel records)
    t_loc = time.perf_counter()
    placed_rows, placed_launches, chains_profile = placed_phase(
        torch, np, pl, sim, eng, cc, count, job, subfiles, mesh,
        SchemeParams, hybrid_assignment, reconcile, args.seed, smi)
    t_table2 = time.perf_counter()
    table2_rows, table2_exact = table2_phase(np, pl, sim, SchemeParams, smi)
    table2_s = time.perf_counter() - t_table2
    locality_s = time.perf_counter() - t_loc
    say(f"phase locality: the ten Table II rows == BENCH_locality.json "
        f"({'bit for bit' if table2_exact else f'within {BENCH_RTOL} rel'}) "
        f"for random/greedy/flow/local_search and jct_gap, anneal on cuda "
        f">= flow, optimized JCT < random; the Table I row (r=2, 3) placed "
        f"by the annealer, bit-exact and on the combine kernels; launches "
        f"{placed_launches}; {table2_s:.1f} s Table II, {locality_s:.1f} s "
        f"the phase [{smi}]")

    # ---- 4e. the scheduler, drift, calibration, resilience ---------------
    # (after 4d, and with no profiler session of its own)
    t_sched = time.perf_counter()
    sched_info, sched_launches = scheduler_phase(
        torch, np, sim, pl, res, cc, cal, costs, eng, jobs, metrics, drift,
        report, count, SchemeParams, TABLE1_GRID, make_mesh,
        pathlib.Path(args.out).parent, args.seed, smi)
    sched_info["phase_s"] = time.perf_counter() - t_sched
    say(f"phase scheduler: BENCH_sim.json, the drift and determinism of "
        f"BENCH_calibration.json and the BENCH_resilience.json subset "
        f"reproduced; the H100 phase fit and conformance honest; the "
        f"annealer stream identical on the card and the CPU; launches "
        f"{sched_launches}; {sched_info['phase_s']:.1f} s [{smi}]")

    # ---- 10. tensor parallelism: qwen2-72b and DeepSeek-V2-Lite at full
    # width on 4 ranks ---------------------------------------------------
    tp_info, tp_launches = tp_phase(torch, np, lm, serve, tr, opt, pipeline,
                                    run_ranks, get_arch, peaks, args.seed,
                                    smi, full_info)
    say(f"phase tp: {TP_ARCH} and {MOE_ARCH} at full width on {TP_RANKS} "
        f"ranks (gloo, one card): the fp32 checks and the training gates "
        f"hold; launches "
        f"{tp_launches}; {tp_info['phase_s']:.1f} s [{smi}]")

    # ---- 8. kernels line -------------------------------------------------
    by_path = {"shuffle": shuffle_launches, **engine_launches,
               "profiled": profile["launches"], "faults": fault_launches,
               "ranks": ranks_launches, "placed": placed_launches,
               "scheduler": sched_launches,
               **{f"serve {a}": r["launches"] for a, r in serving.items()},
               "card_vs_cpu": cmp_launches,
               "train qwen2-1.5b": full_launches,
               "train rwkv6-3b": rwkv_launches,
               "train card_vs_cpu": train_cmp_launches,
               "train ranks": train_ranks_launches, "tp": tp_launches}
    # each kernel's main path: the fused engine for the linear pair, the
    # int32 hybrid_shuffle for the XOR pair, full-width serving for the LM
    # kernels
    main_path = {"coded_encode": "fused", "coded_decode": "fused",
                 "xor_encode": "shuffle", "xor_decode": "shuffle",
                 "flash_attention": "serve qwen2-1.5b",
                 "wkv_scan": "serve rwkv6-3b"}
    main_rows.update(flash_attention=flash_main["prefill"],
                     wkv_scan=wkv_main["prefill"])
    sources = {k: SOURCE for k in KERNELS}
    sources.update(coded_decode=DECODE_SOURCE,
                   xor_encode=XOR_SOURCE, xor_decode=XOR_SOURCE,
                   flash_attention=FLASH_SOURCE, wkv_scan=WKV_SOURCE)
    flash_routes = serving["qwen2-1.5b"]["routes"]["flash_attention"]
    check(flash_routes.get("tensor_core", 0) > 0
          and flash_routes.get("split_kv", 0) > 0,
          f"serving qwen2-1.5b took the tensor-core prefill and the "
          f"split-kv decode: {flash_routes}")
    # (the bf16 prefills all on tensor_core_wide, as each TTFT call
    # checked; mma_tf32 counts the fp32 check's forward and prefill)
    mla_routes = serving["deepseek-v2-lite-16b"]["routes"]["flash_attention"]
    check(mla_routes.get("tensor_core_wide", 0) > 0
          and mla_routes.get("split_kv", 0) > 0
          and not mla_routes.get("tensor_core", 0),
          f"serving deepseek-v2-lite-16b took the hd-576 wide tensor-core "
          f"prefill and the split-kv decode: {mla_routes}")
    wkv_routes = serving["rwkv6-3b"]["routes"]["wkv_scan"]
    check(wkv_routes.get("tensor_core", 0) > 0
          and wkv_routes.get("step", 0) > 0,
          f"serving rwkv6-3b took the tensor-core prefill and the step "
          f"decode: {wkv_routes}")
    # the new families: flash's tensor-core prefill (Hymba's window,
    # Whisper's bidirectional encoder and cross attention, LLaVA's prefix)
    # and split-kv decode (Hymba's ring, Whisper's self and cross), and
    # Hymba's SSM on WKV's step route
    family_routes = {a: serving[a]["routes"] for a in
                     ("hymba-1.5b", "whisper-large-v3", "llava-next-34b")}
    for a, r in family_routes.items():
        fl = r["flash_attention"]
        check(fl.get("tensor_core", 0) > 0 and fl.get("split_kv", 0) > 0,
              f"serving {a} took the tensor-core prefill and the split-kv "
              f"decode: {r}")
    hy = family_routes["hymba-1.5b"]["wkv_scan"]
    check(hy.get("chunk_f32", 0) > 0 and hy.get("step", 0) > 0
          and not hy.get("tensor_core", 0),
          f"serving hymba-1.5b ran its SSM prefills on the WKV chunk_f32 "
          f"route and its decode steps on step: {hy}")
    kernels = []
    for kname in KERNELS + LM_KERNELS:
        launches = by_path[main_path[kname]].get(kname, 0)
        check(launches > 0, f"{kname} launched on its main path "
              f"({main_path[kname]}): {by_path}")
        check(kname not in KERNELS or by_path["ranks"][kname] > 0,
              f"{kname} launched on the ranks path: {by_path['ranks']}")
        check(kname not in ("coded_encode", "coded_decode")
              or by_path["placed"][kname] > 0,
              f"{kname} launched on the placed path: {by_path['placed']}")
        check(kname not in ("coded_encode", "coded_decode")
              or by_path["scheduler"][kname] > 0,
              f"{kname} launched on the scheduler path: "
              f"{by_path['scheduler']}")
        row = main_rows[kname]
        kernels.append({"name": kname, "route": "cuda",
                        "source": sources[kname],
                        "replaces": REPLACES[kname],
                        "launches": launches,
                        "launches_by_path": {k: v.get(kname, 0)
                                             for k, v in by_path.items()},
                        "max_abs_err": row["max_abs_err"], "ms": row["ms"],
                        "plain_ms": row["plain_ms"],
                        "bound_ms": row["bound_ms"],
                        "bound_by": row["bound_by"],
                        "library_ms": row["library_ms"],
                        "device_ms": row["device_ms"],
                        "library_device_ms": row.get("library_device_ms")})
        if kname == "flash_attention":
            # device kernels per call, by route, as profiled in phase 5
            per_call = {r["route"]: r["device_kernels"] for r in flash_rows
                        if "device_kernels" in r}
            check(set(per_call) >= {r for r, n in flash_routes.items() if n},
                  f"every flash route of the main path profiled: "
                  f"{per_call}")
            # phase 5's checked calls at head dims over 128, by route
            large_hd = {}
            for r in flash_rows:
                if r["hd"] > 128:
                    large_hd[r["route"]] = large_hd.get(r["route"], 0) + 1
            check(set(large_hd) == {"mma_tf32", "split_kv",
                                    "tensor_core_wide"},
                  f"head dims over 128 ran on their three routes: "
                  f"{large_hd}")
            # the MLA path (hd 576): its launches by route, and phase 5's
            # rows at its prefill and decode shapes
            mla = {}
            for tag in ("mla_prefill", "mla_prefill_shared", "mla_decode"):
                row = flash_main[tag]
                mla[tag] = {k: row[k] for k in (
                    "B", "Sq", "Sk", "H", "KV", "hd", "kv_valid", "v_is_k",
                    "dtype", "route", "max_abs_err", "mirror_max_abs_err",
                    "ms", "device_ms", "plain_ms", "bound_ms", "bound_by",
                    "library_ms", "library_device_ms")}
            # the new families' rows of phase 5 (bf16, their serving
            # shapes) and their launches by route and per forward
            family = {tag: {k: flash_main[tag][k] for k in (
                "B", "Sq", "Sk", "H", "KV", "hd", "causal", "kv_valid",
                "window", "route", "max_abs_err", "ms", "device_ms",
                "plain_ms", "bound_ms", "bound_by", "library_ms",
                "library_device_ms")} for tag in FAMILY_TAGS}
            kernels[-1].update(launches_by_route=flash_routes,
                               device_kernels_per_call=per_call,
                               hd_over_128_calls_by_route=large_hd,
                               mla_launches_by_route=mla_routes,
                               mla_rows=mla,
                               family_launches_by_route={
                                   a: r["flash_attention"]
                                   for a, r in family_routes.items()},
                               tp_launches_by_route_per_rank={
                                   "check": tp_info["check"][
                                       "routes_per_rank"],
                                   "timed": tp_info["timed"][
                                       "routes_per_rank"],
                                   "moe check": tp_info["moe"]["check"][
                                       "routes_per_rank"],
                                   "moe timed": tp_info["moe"]["timed"][
                                       "routes_per_rank"]},
                               family_launches_per_forward={
                                   a: {"prefill": serving[a][
                                       "launches_per_prefill"][kname],
                                       "decode_step": serving[a][
                                       "launches_per_decode_step"][kname]}
                                   for a in family_routes},
                               family_rows=family,
                               tp_rows=[{k: r[k] for k in (
                                   "case", "B", "Sq", "Sk", "H", "KV", "hd",
                                   "kv_valid", "dtype", "route",
                                   "max_abs_err", "tolerance", "ms",
                                   "plain_ms", "bound_ms", "bound_by")}
                                   for r in flash_rows
                                   if r["case"] in TP_TAGS])
        if kname == "wkv_scan":
            # by route on the main path (prefill on tensor_core, decode's
            # one-step calls on step), and phase 5's checked cases
            # Hymba's SSM (the inclusive identity): phase 5's rows, its
            # launches by route and per forward
            inclusive = {tag: {k: row[k] for k in (
                "B", "S", "h", "Nk", "Nv", "route", "max_abs_err", "ms",
                "device_ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms")} for tag, row in ssm_main.items()}
            kernels[-1].update(launches_by_route=wkv_routes,
                               checked_cases_by_route=wkv_case_routes,
                               tc_smem_bytes=tc_smem,
                               tc_blocks_per_sm=tc_blocks,
                               hymba_launches_by_route=hy,
                               hymba_launches_per_forward={
                                   "prefill": serving["hymba-1.5b"][
                                       "launches_per_prefill"][kname],
                                   "decode_step": serving["hymba-1.5b"][
                                       "launches_per_decode_step"][kname]},
                               inclusive_rows=inclusive)
    # the chunk_f32 kernels (csrc/wkv_chunk_f32.cuh, three device kernels
    # a call): their main path is Hymba's serving, whose prefills take
    # them in inclusive mode; numbers at phase 5's Hymba prefill row
    row = ssm_main["hymba_inclusive_prefill"]
    launches = hy.get("chunk_f32", 0)
    check(launches > 0 and row["route"] == "chunk_f32",
          f"wkv_scan chunk_f32 launched on its main path (serve "
          f"hymba-1.5b): {hy}")
    kernels.append({"name": "wkv_scan_chunk_f32", "route": "cuda",
                    "source": CHUNK_F32_SOURCE,
                    "replaces": REPLACES["wkv_scan"],
                    "launches": launches,
                    "launches_by_route_serving_hymba": hy,
                    "launches_by_route_serving_rwkv6": wkv_routes,
                    "mode": "inclusive",
                    "max_abs_err": row["max_abs_err"],
                    "mirror_max_abs_err": row["mirror_max_abs_err"],
                    "same_bits": row["same_bits"], "ms": row["ms"],
                    "plain_ms": row["plain_ms"],
                    "bound_ms": row["bound_ms"],
                    "bound_by": row["bound_by"], "library_ms": None,
                    "device_ms": row["device_ms"],
                    "device_kernels_per_call": row["device_kernels"],
                    "kernel_bytes": row["kernel_bytes"],
                    "occupancy": {f"nk<={nk}": {
                        "chunk_state": {"smem_bytes": o[0],
                                        "blocks_per_sm": o[1]},
                        "chunk_out": {"smem_bytes": o[2],
                                      "blocks_per_sm": o[3]}}
                        for nk, o in f32_occ.items()},
                    "checked_rwkv_cases": wkv_case_routes.get("chunk_f32",
                                                              0)})
    # the backward kernels: launches on the full-width train paths (Qwen2's
    # step for flash, RWKV6-3B's for WKV), numbers at (a)'s rows of that
    # path's shape (fp32, the training dtype; WKV at the microbatch)
    bwd_path = {"flash_attention_backward": "train qwen2-1.5b",
                "wkv_scan_backward": "train rwkv6-3b"}
    bwd_row = {"flash_attention_backward": bwd_main[("qwen2_train",
                                                     "float32")],
               "wkv_scan_backward": bwd_main[("rwkv6_train_micro",
                                              "float32")]}
    for kname in BWD_KERNELS:
        launches = by_path[bwd_path[kname]].get(kname, 0)
        check(launches > 0, f"{kname} launched on its path "
              f"({bwd_path[kname]}): {by_path}")
        row = bwd_row[kname]
        kernels.append({"name": kname, "route": "cuda",
                        "source": BWD_SOURCES[kname],
                        "replaces": BWD_REPLACES[kname],
                        "launches": launches,
                        "launches_by_path": {k: v.get(kname, 0)
                                             for k, v in by_path.items()},
                        "max_abs_err": row["max_abs_err"], "ms": row["ms"],
                        "plain_ms": row["plain_ms"],
                        "bound_ms": row["bound_ms"],
                        "bound_by": row["bound_by"],
                        "library_ms": row["library_ms"],
                        "device_ms": row["device_ms"],
                        "max_rel_err": row["max_rel_err"],
                        "shape_case": row["case"],
                        "note": "no Pallas counterpart: the JAX package "
                                "differentiates its jnp formulation"})
    # the WKV backward's route on its path, and what it replaced there
    wkv_bwd = kernels[-1]
    wkv_routes_train = rwkv_info["routes_first_step"]["wkv_scan_backward"]
    check(wkv_routes_train == {"chunk": wkv_bwd["launches"], "step": 0},
          f"the rwkv6-3b train step's WKV backward all on chunk: "
          f"{wkv_routes_train}")
    wkv_bwd.update(
        launches_by_route=wkv_routes_train,
        step_ms=bwd_row["wkv_scan_backward"]["step_ms"],
        step_source="src/repro_torch/kernels/rwkv_scan/csrc/wkv_backward.cu",
        train_step_share=rwkv_info["wkv_backward_share"],
        rows={f"{r['case']} {r['dtype']}": {k: r[k] for k in (
            "route", "ms", "step_ms", "device_ms", "bound_ms", "plain_ms",
            "max_rel_err")} for r in bwd_rows
            if r["name"] == "wkv_scan_backward"})
    # the wide tensor-core flash kernel (bf16 prefill at MLA's hd 576,
    # flash_attention's tensor_core_wide route): launches on DeepSeek-V2-
    # Lite's serving path, numbers at phase 5's row of the model's call
    # (v is k), the v-differs row beside it
    wide, wide_split = flash_main["mla_prefill_shared"], \
        flash_main["mla_prefill"]
    check(wide["route"] == wide_split["route"] == "tensor_core_wide"
          and wide["dtype"] == wide_split["dtype"] == "bfloat16",
          f"phase 5's bf16 MLA prefills on tensor_core_wide: "
          f"{wide['route']}, {wide_split['route']}")
    wide_by_path = {f"serve {a}": r["routes"].get("flash_attention", {})
                    .get("tensor_core_wide", 0) for a, r in serving.items()}
    check(wide_by_path["serve deepseek-v2-lite-16b"]
          == mla_routes["tensor_core_wide"]
          and sum(wide_by_path.values()) == mla_routes["tensor_core_wide"],
          f"only DeepSeek-V2-Lite's serving launched the wide kernel: "
          f"{wide_by_path}")
    # phase 10 (f2): DeepSeek-V2-Lite at model 4, G = 4 (not a serving
    # path of one process: beside the main path, per rank)
    wide_by_path["tp (f2), per rank"] = tp_info["moe"]["timed"][
        "routes_per_rank"]["tensor_core_wide"]
    kernels.append({"name": "flash_attention_wide", "route": "cuda",
                    "source": WIDE_SOURCE,
                    "replaces": REPLACES["flash_attention"],
                    "launches": mla_routes["tensor_core_wide"],
                    "launches_by_path": wide_by_path,
                    "max_abs_err": wide["max_abs_err"],
                    "mirror_max_abs_err": wide["mirror_max_abs_err"],
                    "ms": wide["ms"], "plain_ms": wide["plain_ms"],
                    "bound_ms": wide["bound_ms"],
                    "bound_by": wide["bound_by"],
                    "library_ms": wide["library_ms"],
                    "device_ms": wide["device_ms"],
                    "library_device_ms": wide["library_device_ms"],
                    "shape_case": "mla_prefill_shared",
                    "v_differs_row": {k: wide_split[k] for k in (
                        "max_abs_err", "mirror_max_abs_err", "ms",
                        "plain_ms", "bound_ms", "library_ms", "device_ms",
                        "library_device_ms")},
                    # phase 10 (f2)'s local heads: G = 4 at [4, 1024, 4,
                    # 576] into 1,056 keys, v = k
                    "tp_g4_row": {k: flash_main["tp_mla_prefill"][k]
                                  for k in ("max_abs_err",
                                            "mirror_max_abs_err", "ms",
                                            "plain_ms", "bound_ms",
                                            "bound_by", "library_ms",
                                            "device_ms",
                                            "library_device_ms")},
                    "note": "flash_attention's tensor_core_wide route; its "
                            "launches are also in flash_attention's"})
    # the TF32 tensor-core flash kernel (flash_attention's mma_tf32 route:
    # every fp32 prefill): launches on the full-width Qwen2-1.5B train step
    # (a forward and a remat recompute a layer and microbatch), numbers at
    # phase 5's fp32 prefill rows: Qwen2's [8, 2048, 12, 128], MLA's
    # [8, 2048, 16, 576] with v apart and v = k, phase 10's check
    mma_rows = {r["case"]: r for r in flash_rows
                if r["route"] == "mma_tf32" and r["dtype"] == "float32"
                and r["case"] in MMA_TIMED}
    check(set(mma_rows) == set(MMA_TIMED),
          f"phase 5's fp32 prefills on mma_tf32: {sorted(mma_rows)}")
    mma_by_path = {f"serve {a}": r["routes"].get("flash_attention", {})
                   .get("mma_tf32", 0) for a, r in serving.items()}
    mma_by_path["train qwen2-1.5b"] = full_info["routes_first_step"][
        "mma_tf32"]
    mma_by_path["tp check, per rank"] = tp_info["check"][
        "routes_per_rank"].get("mma_tf32", 0)
    mma_by_path["tp (f1) check, per rank"] = tp_info["moe"]["check"][
        "routes_per_rank"].get("mma_tf32", 0)
    mma = mma_rows["prefill"]
    check(mma_by_path["train qwen2-1.5b"] > 0,
          f"the train step launched mma_tf32: {mma_by_path}")
    kernels.append({"name": "flash_attention_mma", "route": "cuda",
                    "source": MMA_SOURCE,
                    "replaces": REPLACES["flash_attention"],
                    "launches": mma_by_path["train qwen2-1.5b"],
                    "launches_by_path": mma_by_path,
                    "max_abs_err": mma["max_abs_err"],
                    "mirror_max_abs_err": mma["mirror_max_abs_err"],
                    "ms": mma["ms"], "plain_ms": mma["plain_ms"],
                    "bound_ms": mma["bound_ms"], "bound_by": mma["bound_by"],
                    "library_ms": mma["library_ms"],
                    "device_ms": mma["device_ms"],
                    "library_device_ms": mma["library_device_ms"],
                    "tflops": mma["tflops"], "shape_case": "prefill",
                    "fp32_rows": {tag: {k: r[k] for k in (
                        "B", "Sq", "Sk", "H", "KV", "hd", "kv_valid",
                        "v_is_k", "max_abs_err", "mirror_max_abs_err", "ms",
                        "ms_turns", "library_ms", "library_ms_turns",
                        "device_ms", "library_device_ms", "plain_ms",
                        "bound_ms", "bound_by", "tflops")}
                        for tag, r in mma_rows.items()},
                    "train_step_forward_share": full_info[
                        "flash_forward_share"],
                    "note": "flash_attention's mma_tf32 route; its launches "
                            "are also in flash_attention's"})
    say(f"phase kernels line: launches by path {by_path}")
    out = pathlib.Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps({
        "device": smi, "torch": torch.__version__, "build_s": build_s,
        "nvcc": nvcc, "engine_peak_memory_gb": peak_gb,
        "kernels": kernel_rows, "shuffle": shuffle_runs,
        "engine": engine_runs, "profile": profile,
        "faults": fault_runs, "phase_timings": phase_row,
        "ranks": ranks_info,
        "locality": {"table2": table2_rows, "table2_exact": table2_exact,
                     "table2_s": table2_s, "placed": placed_rows,
                     "chains_profile": chains_profile,
                     "phase_s": locality_s},
        "scheduler": sched_info,
        "lm_kernels": flash_rows + wkv_rows + ssm_rows, "serving": serving,
        "card_vs_cpu": cmp_rows, "launches": by_path,
        "train": {"backward": bwd_rows, "full_width": full_info,
                  "rwkv6_full_width": rwkv_info,
                  "card_vs_cpu": train_cmp_rows, "restart": restart_info,
                  "coded_r2": train_ranks_info, "phase_s": train_s},
        "tp": tp_info,
        "seconds": time.perf_counter() - t_start}, indent=1))
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
