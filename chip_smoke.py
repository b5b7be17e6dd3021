#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # from the root of a checkout

Phases, each of which fails the run on any error:

  1. build    compile every CUDA source of ``src/repro_torch/kernels/csrc``
  2. card     print the card's name and power limit (nvidia-smi)
  3. kernels  each kernel against its plain PyTorch version on the card, at
              the main path's shapes (Q=64, B=128; single and batched),
              with its time, the plain version's, a library call's where
              one exists, and the bound: min-plus (bitwise) and masked
              matmul (tolerance, and bitwise with the list order) walking
              the column lists, at the road density, a hub-like 25 % and
              fully finite blocks, an index past nblk (NaN plane) and -1
              (identity), beside an empty launch's time; the frontier
              (bitwise) and the push round (masked-matmul tolerance), and
              the fused visit: one launch of a whole K=64
              chunk, at every compiled cluster size and at Q = 64 and a
              ragged 60, against K plain visits on copies of a mid-run
              state of the main path (minplus dense, sparse and strict
              bitwise) or K unfused card visits (push bitwise; one visit
              within the tolerance of its plain version), each cluster
              size timed over a CUDA graph of the chunk's launch (and the
              path's size as one-visit launches and sparse).  3d: both
              kernels' gathered form (``xrow``) at a baselines round's
              shape on the main path's graph (every block against its
              source partition's rows), bitwise as above, timed beside the
              empty launch.  3c also runs the fused visit's random policy
              over the chunk (the threefry key split in the kernel),
              bitwise against its plain version or the unfused card
              megastep, key included, and times it.  3e: ``fg_threefry``
              over 2^20 counters and at the walk tape's and the split's
              shapes, bitwise against its plain version, timed
  4. parity   the engine on the card against the engine on the CPU
              (grid2d(32, 32), B=32, Q=16): sssp, bfs, cc and kreach
              bitwise in values, hops, edges, stats and visit order; ppr
              at the masked-matmul tolerance; then the fused engine on the
              card against the unfused one on the card (bitwise, ppr too)
              and against the fused engine on the CPU; cc and kreach again
              on erdos_renyi(1024, 1.5) (many components); the baselines
              backend on the card against the CPU for every kind (bitwise,
              ppr at the tolerance), one contraction launch a round
  5. path     ``FPPSession(grid2d(SIDE, SIDE), device="cuda")
              .plan(num_queries=64, fused=True)`` runs sssp, bfs, ppr and
              sssp with the sparse frontier on 64 seeded sources; sssp/bfs
              are checked against scipy's Dijkstra, ppr against mass
              conservation and the residual bound; one fused launch per
              chunk and no contraction launch, one device read per chunk;
              the sparse sssp bitwise equal to the dense one.  On
              grid2d(UNFUSED_PATH_SIDE) the unfused ``plan(num_queries=64)``
              runs the three kinds (each must launch its kernel once per
              relax round and once per visit) and the fused plan again:
              sssp/bfs bitwise equal, visits, rounds and chunks equal
              (ppr too), both against the oracles above.  Then one
              K=64 chunk per algebra and dispatch is timed and traced for
              the card's busy share; a fused chunk's trace must name one
              launch of the cluster kernel, an unfused one the list
              contraction kernel (its share of the card time).  5c: fused
              cc on the grid and on erdos_renyi(n, 1.5) against scipy's
              components, fused kreach (k=8) against ``oracles.kreach`` on
              4 sources, unfused cc and kreach (``UNFUSED_SIDE``) bitwise
              equal to fused; the baselines backend for sssp, bfs, ppr, cc
              and kreach, one launch a round, sssp/bfs against scipy's
              Dijkstra and every minplus kind bitwise equal to the engine
              (ppr within 4·eps·deg); ``plan(tune=True, fused=True)`` on 8
              sources; the applications: bc on 16 sources bitwise equal to
              ``bc_accumulate`` on scipy's levels, landmarks equal to the
              sssp values, ncp's profile.  5d: rw (length 32) on the engine
              and baselines backends, bitwise equal to each other, to the
              CPU and (8 walkers) to ``oracles.random_walk``, one threefry
              launch a step round; the random schedule fused (sssp bitwise
              the priority run's, ppr within 4·eps·deg, one launch and one
              read a chunk) and unfused at RANDOM_SIDE (the fused kernel's
              visit order); staggered streams (24 sources, 3 chunks, 40
              more: fused sssp and ppr, unfused sssp at RANDOM_SIDE, rw
              through 16 lanes) against the one-shot runs.  5e: graph
              serving (``serve/``) on the same graph and fused session:
              ``GraphServer(capacity=64, fused=True).serve()`` of phase
              5's sources bitwise equal to its fused sssp and ppr runs
              ("serve sync" lines); 384 requests of the six kinds from two
              tenants (3 of 4 from tenant0), Zipf-skewed sources, in six
              batches 0.5 s apart through ``serve_forever``, every one
              ``ok`` and equal to a synchronous replay and to one-shot
              runs (ppr within 4·eps·deg), hits ``cached`` and unbilled,
              one B5 launch a chunk, no contraction, threefry for rw
              ("serve mixed": q/s, p50/p99 latency per kind, host syncs
              per request, cache and dedup counters, the capacities the
              autoscaler built); an unfused pool at side 64 bitwise equal
              to the fused one (B1); the warm cache ("serve warm cache":
              each pool's first request cold and prewarmed, the cold
              build split into ``column_lists``, ``DeviceGraph.build``,
              chunks and the copy back); ``launch/serve.py --workload
              graph`` at road-ca ("serve cli").  5f: the distributed
              backend on grid2d(UNFUSED_PATH_SIDE) with phase 5's sources
              and plan, through ``launch/mesh.spawn``: four gloo ranks on
              the one card (mesh (1, 4): the six kinds; (2, 2): sssp and
              ppr; ``decode_attend_partitioned`` at starcoder2-7b's decode
              shape against ``decode_attend_local`` within 1e-5), then one
              NCCL rank (mesh (1, 1): sssp and ppr); every rank the same
              bits, bitwise equal to the engine but ppr (4·eps·deg, mass,
              residual bound), every rank's B1 (B2 for ppr, threefry for
              rw) count above zero; one ``{"distributed": ...}`` line
  6. flash    the flash-attention kernels against their plain version on
              the card at the LM paths' shapes (starcoder2-7b: H=36, Hkv=4,
              hd=128; (Sq, Skv, q_offset) = (512, 512, 0), (3000, 3000, 0),
              (4096, 4096, 0), (4096, 8192, 4096); bf16 on the tensor-core
              kernel and f32 on the FP32-core one; one windowed case;
              recurrentgemma-2b: H=10, Hkv=1, hd=256, window 2048 at
              (4096, 4096, 0) and (8192, 8192, 0), bf16 and f32;
              qwen3-moe-30b-a3b: H=32, Hkv=4, hd=128 at (4096, 4096, 0)
              and (4096, 8192, 4096), bf16 and f32; paligemma-3b: H=8,
              Hkv=1, hd=256, causal with a 256-key prefix at (512, 512)
              and (4096, 4096); whisper-base: H=Hkv=8, hd=64, the encoder
              (1536, 1536) and the cross-attention (224, 1536) non-causal
              with kv_len 1500, the decoder (224, 224) causal; bf16 and
              f32; one rank's heads on the meshes of 7e (9 / 1), 7f
              (8 / 1) and 8e (18 / 2) at every shape those phases launch),
              each shape timed over a CUDA graph beside PyTorch's
              SDPA as a yardstick (causal, GQA; a window, a prefix or
              padded keys as the equivalent boolean mask), each float32
              shape's share of its bound and ratio to SDPA printed, the
              plain version timed at each model's timed shape
              (``FLASH_TIMED``); then the float32 kernel at the edges of
              its key splits (``FLASH_F32_EDGES``: kv_len inside a split,
              empty splits under a window, a prefix, a strided cache
              prefix at q_offset > 0, no key, an unaligned base)
  7. lm       the LM serving path: ``build_model(starcoder2-7b)`` at full
              width and depth, ``Model.init`` from a seeded generator on the
              card, six prompts (512 to 8192 tokens) through
              ``ContinuousBatcher`` at batch 4, 32 new tokens each; every
              prefill attention call must launch the flash kernel.  Then the
              512-token prefill with the kernel against the same prefill
              with the plain attention, the reduced config served on the
              card against the CPU (float32 compute, same tokens), and each
              prompt's prefill traced for the flash kernel's share: every
              attention kernel there must be the tensor-core one
  7b. lm recurrent  the same path and checks, after starcoder2 is freed,
              for recurrentgemma-2b (hybrid: RG-LRU and window attention;
              its 8 attention layers launch the flash kernel at hd 256 once
              a prefill, 48 in all, every one the tensor-core kernel; check
              b on the 512- and 3000-token prefills) and falcon-mamba-7b
              (ssm: no flash and no graph kernel may launch); check c on
              each reduced config with prompts longer than the reduced
              window
  7c. lm moe  the same path and checks, after 7b's models are freed, for
              qwen3-moe-30b-a3b (128 experts, top-8; 48 layers launch the
              flash kernel once a prefill and twice for the 8192-token
              prompt, 336 in all, every one the tensor-core kernel; no
              graph kernel), with each prefill's share of entries dropped
              past capacity, check b's share of routing decisions that
              agree between the kernel's and the plain attention's
              prefills; check c also on phi3.5-moe's reduced config;
              ``launch/serve.py --no-reduced`` serves 4 requests
  7d. lm vlm, encdec  the same path and checks, after 7c's model is
              freed, for paligemma-3b (vlm: 256 seeded image embeddings a
              request before its text, 272 to 8192 positions, the
              prefix-LM mask in B6; 18 flash launches a prefill and 36 for
              the chunked 8192, 126 in all) and whisper-base (encdec: 1,500
              seeded frames a request, prompts of 4 to 224 tokens,
              max_len 448; 18 launches a prefill: 6 encoder, 6 self, 6
              cross; 108 in all), each request's extras through
              ``ContinuousBatcher``; check b and c with the extras; each
              ``launch/serve.py --no-reduced``
  7e. lm mesh  starcoder2-7b at full width, MESH_LAYERS of its 32 layers,
              on a (1, 4) mesh of four gloo ranks sharing the card
              (``launch/mesh.spawn``; ``rules_for``: heads, kv heads, MLP
              and vocabulary split four ways, the KV cache over the ranks on
              its sequence), phase 7's seed built whole by one rank at a
              time, two of phase 7's prompts (512, 2048 tokens, 4 new tokens
              each) through ``ContinuousBatcher(mesh=, rules=)``: a. every
              rank the same tokens; b. a teacher-forced prefill of 4 x 256
              and 4 decode steps within 5 % of the largest logit of one
              card's run of the same cut model (built after phase 7 frees
              its own); c. ``Model.logits`` (2048 tokens) with
              ``manual_tp`` (B6 on 9 / 1 heads a rank: every shape of
              7e in phase 6) against one card's
              forward; d. the reduced config in float32 on the four ranks
              against the port on the CPU (1e-5, same tokens); e. B6 once
              an attention layer and chunk on every rank, no
              graph kernel; one ``lm mesh run`` line (per rank: walls,
              prefill and decode seconds, decode tok/s, collectives a decode
              step, B6 launches, peak memory)
  7f. moe mesh  qwen3-moe-30b-a3b at full width, MOE_MESH_LAYERS of its 48
              layers, on the same (1, 4) mesh in the same world, after 7e's
              cases (``rules_for``: 32 of the 128 experts a rank, expert
              parallel over "model"; 8 / 1 heads of 128 a rank; the KV
              cache over the ranks on its sequence), built whole by one
              rank at a time from phase 7c's seed, two of 7c's prompts
              (512 tokens, and 8192 in two chunks; 8 new tokens) through
              ``ContinuousBatcher(mesh=, rules=)`` in bf16: a. every rank
              the same tokens and routing (calls, entries dropped, the
              picks' sha1); b. a teacher-forced prefill of 4 x 256 and 4
              decode steps against one card's run of the same cut model
              (built after 7c frees its own): in float32 within 1e-4 of
              the largest logit, a control with the combine in bf16
              beyond it; in bf16 at least 90 % of the picks and 75 % of
              the greedy tokens equal (MOE_MESH_DTYPES); c.
              ``Model.logits`` in float32 against one card's forward
              (1e-4); d. reduced qwen3-moe and phi3.5-moe in
              float32 on the ranks at (1, 4) and (2, 2) against the port on
              the CPU (1e-5, same tokens); e. B6 once an attention layer and
              chunk on every rank, no graph kernel; one ``lm mesh run`` line
              (per rank: walls, prefill and decode seconds, decode tok/s,
              collectives a decode step, B6 launches, peak GB, the share of
              entries dropped)
  7g. recurrent mesh  recurrentgemma-2b and falcon-mamba-7b at full
              width, RECURRENT_MESH_LAYERS of their layers (the hybrid in
              whole (rec, rec, attn) groups), on the same (1, 4) mesh in the
              same world, after 7f's cases (``rules_for``: d_inner 8192 and
              lru_width 2560 channel parallel over "model", 2048 and 640
              channels a rank; the hybrid's MLP split four ways, its 10 / 1
              heads of 256 computed whole on every rank, its ring cache of
              2048 slots whole on every rank), built whole by one rank at a
              time from phase 7b's seed, two of 7b's prompts (512 and 2048,
              4 new tokens) through ``ContinuousBatcher(mesh=, rules=)`` in
              bf16: a. every rank the same tokens; b. a teacher-forced
              prefill of 4 x 256 and 4 decode steps against one card's run
              of the same cut model (built in 7b after its full-depth runs):
              bf16 within MESH_LOGIT_RTOL, float32 within
              RECURRENT_MESH_F32_RTOL of the largest logit; c.
              ``Model.logits`` in float32 against one card's forward
              (RECURRENT_MESH_F32_RTOL); d. both reduced configs in float32
              on the ranks at (1, 4) and (2, 2) against the port on the CPU
              (LM_F32_TOL, scaled for the hybrid's tied embedding as check c
              of 7b); e. B6 once an attention layer and prefill on every
              rank for the hybrid, never for falcon-mamba, no graph kernel;
              one ``lm mesh run`` line an arch (per rank: walls, prefill and
              decode seconds, decode tok/s, collectives a decode step, B6
              launches, peak GB)
  8. train    the training path (``train/``, ``launch/train.py``).  8a:
              B6's gradient (``FlashAttentionFn``: the kernel forward, the
              plain flash backward) against autograd through the plain
              version at starcoder2's training shape (1 x 4096, 36 / 4
              heads of 128, causal, bf16) and at hd 16 in float32, one
              full-width attention layer's backward (wq, wk, wv, wo get
              gradients), and the plain backward's time beside SDPA's
              forward + backward.  8b: one float32 train step of the
              reduced config, card against CPU (same batch, drawn on each
              device bit for bit).  8c: a reduced run on the card killed by
              ``fault_hook`` after its step-4 checkpoint and restarted,
              bitwise equal to the uninterrupted run.  8d:
              ``launch/train.py``'s path for starcoder2-7b at full width
              with TRAIN_LAYERS of its 32 layers, batch 4 x 4096 in 4
              microbatches, TRAIN_STEPS AdamW steps: losses and grad norms
              finite, every parameter's moment non-zero, two flash
              launches per attention layer and microbatch (forward and
              remat), peak memory and tokens/s printed
  8e. train mesh  ``launch/train.run(..., mesh=)`` for starcoder2-7b at
              full width on a (2, 2) mesh of four gloo ranks sharing the
              card (tensor parallel over "model", 18 / 2 heads a rank;
              FSDP over "data"), TRAIN_MESH_LAYERS of its 32 layers, batch
              4 x 1024 in 2 microbatches, 2 AdamW steps; its ranks run in
              phase 7e's world after 7e's cases.  a. every rank the same
              loss and grad-norm bits, every replica of a leaf the same
              bits; b. the first step within TRAIN_MESH_LOSS_RTOL /
              TRAIN_MESH_NORM_RTOL of one card's; c. the reduced config in
              float32, 2 steps on the ranks against the CPU; d. its
              checkpoint resharded onto (1, 4) and 2 more steps against 4
              CPU steps; e. B6 twice an attention layer and microbatch on
              every rank, threefry for the batches, nothing else; f. the
              reduced qwen3-moe config in float32, 2 steps on the (2, 2)
              ranks (experts expert parallel, FSDP over "data") against the
              CPU: loss, ce and aux, params and moments as c, every rank
              the same metric bits; g. the reduced recurrentgemma-2b and
              falcon-mamba-7b configs the same way (their RG-LRU and ssm
              blocks channel parallel); h. check c's steps again with the
              layer-boundary carry whole (``"act_seq"`` off), bit for bit
              against c's, whose carries were the ranks' S / 2 rows; one
              ``train mesh`` line a rank (step wall, tokens/s, collectives
              a step and their seconds, peak GB, B6 launches, the carry)
  9. dry run   ``launch/dryrun.dry_step`` (one step on meta tensors, in
              this process) of three cuts just run on the card: 8d's
              training step (its B6 launches a step times TRAIN_STEPS
              equal to those 8d counted) and one decode step of each rank
              of 7e's and 7f's served models on MESH (its collectives
              equal to the ``Mesh.calls`` a decode step that rank
              counted); the predicted peak beside ``max_memory_allocated``
              (8d: over its steps; 7e, 7f: over a rank's first decode
              step, its peak counters reset before it) and the roofline's
              bound beside the measured step, printed (``dry run vs
              card``)
  10. report  fg_threefry's line and the kernel table as JSON lines (each
              kernel launched at least once on the paths), then the
              result line

It imports nothing of JAX or of the JAX package, and exits non-zero with no
result line when there is no CUDA device or the port is not beside it.
"""
from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

#: H100 SXM peaks (NVIDIA's data sheet, at a 700 W limit): HBM3 rate and
#: FP32 rate outside the tensor cores, for the bound of each kernel.  The
#: FP32 rate counts an FMA as two operations, so one FP32 instruction of
#: any kind issues at most at half of it
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12
PEAK_F32_INSTR_PER_S = PEAK_F32_OPS_PER_S / 2
#: int32 rate: an H100 SM has 64 INT32 lanes against 128 FP32 ones
#: (NVIDIA's Hopper architecture white paper)
PEAK_INT32_OPS_PER_S = PEAK_F32_INSTR_PER_S / 2
#: integer operations of one threefry-2x32 hash: the key schedule's two
#: xors, two initial adds, 20 rounds of add, rotate (one funnel shift) and
#: xor, five injections of three adds; and of jax's uniform from its words
#: (xor, shift, or, subtract)
THREEFRY_OPS, UNIFORM_OPS = 79, 4
#: counters of phase 3's threefry check and timing
THREEFRY_N = 1 << 20

#: grid side of the main path's graph (a cut of the paper's road graphs,
#: see PERF.md section 4)
SIDE = 192

#: grid side of the unfused cc and kreach runs.  kreach has no value
#: window, so at side 192 it takes ~40,500 visits and ~173,000 relax rounds,
#: which the host-paced unfused dispatch would need over a minute for; cc
#: takes 288 visits there (PERF.md section 4)
UNFUSED_SIDE = {"cc": SIDE, "kreach": 64}
#: grid side of phase 5d's unfused random-schedule and streaming runs:
#: unfused sssp takes 77-104 s at side 192 under priority, and the random
#: schedule ~2.2 times priority's visits (PERF.md section 5)
RANDOM_SIDE = 64
#: grid side of phase 5's unfused sssp, bfs and ppr runs, held against the
#: fused runs on the same grid: at side 192 the host-paced unfused sssp and
#: bfs took 90.0 and 111.2 s (PERF.md section 5); the fused runs stay at SIDE
UNFUSED_PATH_SIDE = 64

#: the LM serving path (PERF.md section 4): full width and depth, random
#: weights from a seeded generator on the card
LM_ARCH = "starcoder2-7b"
LM_PROMPTS = (512, 1000, 2048, 3000, 4096, 8192)
LM_BATCH, LM_NEW, LM_MAX_LEN = 4, 32, 8224
#: (Sq, Skv, q_offset, window) of the checks of the flash kernel: the path's
#: whole prefills and the 8192-token prompt's second chunk, plus one
#: windowed case (the hybrid family's mask; not on the dense path)
FLASH_CASES = ((512, 512, 0, None), (3000, 3000, 0, None),
               (4096, 4096, 0, None), (4096, 8192, 4096, None),
               (4096, 4096, 0, 1024))
#: phase 7b: the recurrent families at full width and depth, through the
#: same six prompts (PERF.md section 4); RG_ARCH is the hybrid, whose window
#: attention runs the flash kernel at head dim 256
LM_RECURRENT = ("recurrentgemma-2b", "falcon-mamba-7b")
RG_ARCH = LM_RECURRENT[0]
#: (Sq, Skv, q_offset, window) of recurrentgemma-2b's whole prefills
#: (H=10, Hkv=1, hd=256, window 2048) in phase 6: two of 7b's, then the
#: whole prompts of 7g's (the teacher prefill of 256 tokens, the served
#: prompts of 512 and 2048), which check f's "full" control runs on every
#: rank (7g itself runs them "seq": RG_SEQ_CASES)
RG_FLASH_CASES = ((4096, 4096, 0, 2048), (8192, 8192, 0, 2048),
                  (256, 256, 0, 2048), (512, 512, 0, 2048),
                  (2048, 2048, 0, 2048))
#: phase 7c: the moe family at full width and depth, through the same six
#: prompts (PERF.md section 4); its attention runs the flash kernel at 32
#: query heads over 4 key/value heads (groups of 8), hd 128.  phi3.5-moe
#: (83.75 GB in bf16) does not fit one card: it runs reduced only (check c)
MOE_ARCH = "qwen3-moe-30b-a3b"
MOE_REDUCED_ONLY = "phi3.5-moe-42b-a6.6b"
#: (Sq, Skv, q_offset, window) of qwen3-moe's 4096-token whole prefill and
#: the 8192-token prompt's second chunk in phase 6
MOE_FLASH_CASES = ((4096, 4096, 0, None), (4096, 8192, 4096, None))
#: phase 7d: the last two families at full width and depth.  paligemma-3b
#: (vlm: 256 image embeddings before each prompt, the prefix-LM mask):
#: text brings the positions to 272 (a captioning request) up to 8192 (the
#: chunked prefill, the image in its first chunk).  whisper-base (encdec:
#: 1,500 frames a request, 30 s of audio after the stub frontend): decoder
#: prompts up to 224 tokens, half its 448-token text context
VLM_ARCH, ENCDEC_ARCH = "paligemma-3b", "whisper-base"
VLM_IMAGE_TOKENS = 256
LM_SPECS = {
    VLM_ARCH: (tuple(T - VLM_IMAGE_TOKENS
                     for T in (272, 512, 1000, 2048, 4096, 8192)), LM_MAX_LEN),
    ENCDEC_ARCH: ((4, 32, 64, 128, 224, 224), 448),
}
#: phase 7e: starcoder2-7b at full width and depth on a (1, 4) mesh of four
#: gloo ranks that share the card (NCCL refuses two ranks on one GPU):
#: heads, kv heads, MLP and vocabulary split four ways, so each rank's B6
#: runs 9 query heads on 1 kv head of 128 (MESH_KEY in phase 6)
MESH_WORLD, MESH = 4, (1, 4)
MESH_KEY = LM_ARCH + " tp4"
#: 7e's depth: cut for time to MESH_LAYERS of starcoder2-7b's 32 when phase
#: 7g joined the world (it took the smoke from ~577 s to 635.5 s), held to
#: one card's run of the same cut model; widths are not cut
MESH_LAYERS = 8
#: the served prompts and new tokens of the mesh run: phase 7's cut to
#: two prompts (one wave at batch 4) and 4 new tokens, for time (gloo's
#: collectives among four ranks on one H100 cost milliseconds each: a
#: decode step of the four ranks is ~10 times phase 7's; PERF.md section
#: 5).  The chunked 8192-token prompt went when phase 7f joined the world
#: (its float32 sums took ~22 s of 7e's 30 s of prefill): phase 7f serves
#: it instead, so the chunked prefill on a mesh runs on the card there
MESH_PROMPTS, MESH_NEW = (512, 2048), 4
#: check b: a prefill of (rows, tokens) and this many greedy decode steps on
#: one card (phase 7), the mesh fed the same tokens; check c: the forward's
#: logits of one MESH_C_TOKENS-token row, every MESH_C_STRIDE-th position
MESH_B_BATCH, MESH_B_STEPS = (LM_BATCH, 256), 4
MESH_C_TOKENS, MESH_C_STRIDE = 2048, 16
#: checks b and c hold the mesh's bf16 logits to the one card's as check b
#: of phase 7 holds the plain attention's: within LM_LOGIT_RTOL of the
#: largest logit (the partial sums of a rank's heads and columns are added
#: in float32 and rounded to bf16 once, where one card rounds the whole
#: product once: bf16 roundings at other points, over 32 layers)
MESH_LOGIT_RTOL = 0.05
#: phase 7f: qwen3-moe-30b-a3b at full width on MESH, expert parallel over
#: "model" (32 of its 128 experts a rank), its attention tensor parallel
#: (8 / 1 heads of 128 a rank: MOE_MESH_KEY in phase 6).  Depth is cut by
#: memory: ``launch/distributed._lm_params`` builds the whole model on one
#: rank at a time while the others keep their shards, a peak of ~1.75
#: times the whole (~1.9 GB of embedding and float32 unembed and ~1.25 GB
#: a layer in bf16: ~108 GB at 48 layers), so 8 of 48 (~12 GB whole),
#: then for time MOE_MESH_LAYERS when phase 7g joined the world; widths
#: are not cut.  Two of phase 7c's prompts, 8 new
#: tokens; checks b and c as 7e's, against the same cut model on one card
#: (built after 7c frees its own), b with MOE_MESH_B_STEPS decode steps.
#: The 8192-token prompt runs the mesh's chunked prefill (two chunks of
#: PREFILL_CHUNK), which 7e no longer serves
MOE_MESH_LAYERS = 4
MOE_MESH_KEY = MOE_ARCH + " ep4"
MOE_MESH_PROMPTS, MOE_MESH_NEW = (512, 8192), 8
MOE_MESH_B_STEPS = 4
#: the compute dtypes of 7f's cut model: bf16 is the served path (checks a
#: and e, the timings), float32 holds checks b and c to one card within
#: MOE_MESH_F32_RTOL.  In bf16 the mesh's float32 partial sums round
#: differently from one card's bf16 sums, routing near-ties flip, and with
#: random weights (~14 % of entries dropped past capacity) a flipped pick
#: moves which later entries fit: the logits drift 6-11 % of the largest
#: (one card's kernel and plain attention disagree on 3.4 % of the picks,
#: 7c's check b), so bf16 is held by its routing and greedy tokens instead
MOE_MESH_DTYPES = ("bfloat16", "float32")
#: check b and c in float32, relative to the largest logit: the mesh reads
#: 8.0e-7 (b) and 2.3e-6 (c); a float32 config whose combine ran in bf16
#: (the control of :func:`moe_mesh_reference`, on one card) reads far above
#: it, which the phase checks in every run
MOE_MESH_F32_RTOL = 1e-4
#: check b in bf16: the share of the teacher prefill's picks equal to one
#: card's (97.5 % at 8 layers, 95.8 % at 24) and of the teacher steps'
#: greedy tokens (11 and 10 of 12) at least these; an expert block that
#: computed the wrong function would move every later layer's picks
#: (top-8 of 128 at random shares ~6 %)
MOE_MESH_BF16_PICKS, MOE_MESH_BF16_GREEDY = 0.9, 0.75
#: check d: the reduced moe configs in float32 on the four ranks at these
#: meshes against the port on the CPU
MOE_MESH_REDUCED = (MOE_ARCH, MOE_REDUCED_ONLY)
MOE_MESH_REDUCED_MESHES = ((1, 4), (2, 2))
#: phase 7g: the recurrent families at full width on MESH, channel parallel
#: over "model" (falcon-mamba-7b's d_inner 8192 and recurrentgemma-2b's
#: lru_width 2560: 2048 and 640 channels a rank), in the same world after
#: 7f's cases.  Depth cut for time to RECURRENT_MESH_LAYERS (the hybrid in
#: whole (rec, rec, attn) groups: two attention layers); widths are not
#: cut.  The prompts and checks b and c as 7e's, against the same cut model
#: on one card (built in 7b after its full-depth runs), b in both compute
#: dtypes (the served bf16 within MESH_LOGIT_RTOL), c in float32
RECURRENT_MESH_LAYERS = 6
RECURRENT_MESH_KEY = RG_ARCH + " tp4"
RECURRENT_MESH_DTYPES = ("bfloat16", "float32")
#: checks b and c in float32, relative to the largest logit: the mesh adds
#: its partial sums in another order than one card
RECURRENT_MESH_F32_RTOL = 1e-4
#: check c's row: the unembed's logits of a rank are all-gathered over the
#: model axis, and recurrentgemma-2b's 256,000-entry vocab makes a
#: 2048-token row 2.1 GB of float32 to move through gloo; 512 tokens
RECURRENT_MESH_C_TOKENS = 512
#: check d: the reduced recurrent configs in float32 on the four ranks at
#: these meshes against the port on the CPU
RECURRENT_MESH_REDUCED_MESHES = ((1, 4), (2, 2))
#: 7g's attention runs the reference's context-parallel "seq" policy (10
#: heads do not split over a model axis of 4): rank i runs every head on
#: its quarter of the query rows against every key, B6 at (S/4, S, i·S/4,
#: window 2048) for the teacher prefill (S = 256), the served prompts (512
#: and 2048) and check c's row (512); phase 6 holds each, and the uncut
#: run's 8192-token prefill's last rank (``scripts/lm_mesh.py --layers
#: 26``); row 6k is timed at the 2048-token prompt's last rank
RG_SEQ_KEY = RG_ARCH + " seq4"
RG_SEQ_CASES = tuple((S // MESH[1], S, i * S // MESH[1], 2048)
                     for S in (256, 512, 2048) for i in range(MESH[1])) + (
    (2048, 8192, 6144, 2048),)
#: check f: check b's float32 teacher prefill under "seq" against the same
#: ranks under ``rules_for(..., overrides=RECURRENT_MESH_FULL)`` (every
#: attention block computed whole: "full"), within RECURRENT_MESH_F32_RTOL
RECURRENT_MESH_FULL = {"seq": None}
#: phase 8e: ``launch/train.run`` for starcoder2-7b at full width on a (2, 2)
#: mesh of four gloo ranks sharing the card (``rules_for``: tensor parallel
#: over "model", 18 / 2 heads of 128 a rank, TRAIN_MESH_KEY in phase 6;
#: FSDP over "data"), cut for time to TRAIN_MESH_LAYERS of 32 layers and
#: TRAIN_MESH_STEPS steps at 8d's rate; batch 4 x 1024 in 2 microbatches
#: (one row a rank and microbatch).  Widths are not cut.  gloo paces it:
#: each layer's FSDP gather (~435 MB a rank) runs in the forward and again
#: in the remat, and its gradient's reduce-scatter in the backward.  One
#: layer since phase 7g joined the world (two took 35-42 s of it)
TRAIN_MESH = (2, 2)
TRAIN_MESH_LAYERS = 1
TRAIN_MESH_STEPS = 2
TRAIN_MESH_BATCH, TRAIN_MESH_SEQ, TRAIN_MESH_MICRO = 4, 1024, 2
TRAIN_MESH_KEY = LM_ARCH + " train tp2"
#: check b: the mesh's first step against one card's (the same cut config,
#: seeded state and batch), relative.  Both compute in bf16; the mesh adds
#: a row-parallel block's two partial products in float32 and rounds once,
#: where one card rounds the whole product once, so activations differ by
#: bf16 roundings in each layer.  The loss averages 4,096 tokens' nll; the
#: grad norm is a sum of squares over 0.9 B entries, dominated by the
#: embedding and unembed, whose gradients move with the logits
TRAIN_MESH_LOSS_RTOL = 0.01
TRAIN_MESH_NORM_RTOL = 0.05
#: checks c and d: the reduced config in float32 on the four ranks, its
#: seed, batch, rate and steps (c: TRAIN_MESH on the ranks; d: then
#: resharded onto RESHARD_MESH), against the port on the CPU
TRAIN_MESH_REDUCED_SEQ, TRAIN_MESH_REDUCED_LR = 64, 1e-3
RESHARD_MESH = (1, 4)
#: check h: check c's steps again with the layer-boundary carry whole
#: (``rules_for``'s overrides; ``"act_seq"`` splits it over "model" on
#: its sequence by default), bit for bit against check c's
TRAIN_MESH_WHOLE_CARRY = {"act_seq": None}
#: check g's last case: the reduced hybrid with recurrentgemma-2b's 10 / 1
#: heads (which a model axis of 4 does not split), one float32 step at
#: MESH: its attention "seq", B6's gradient at each rank's q_offset
RECURRENT_TRAIN_SEQ_HEADS = {"n_heads": 10, "n_kv_heads": 1}
#: (Sq, Skv, q_offset, window, causal, kv_len, prefix_len) of phase 6 per
#: model (the first four fields alone: causal, every key seen)
FLASH_SHAPES = {
    LM_ARCH: FLASH_CASES, RG_ARCH: RG_FLASH_CASES, MOE_ARCH: MOE_FLASH_CASES,
    # paligemma's whole prefills of 512 and 4096 positions
    VLM_ARCH: ((512, 512, 0, None, True, None, VLM_IMAGE_TOKENS),
               (4096, 4096, 0, None, True, None, VLM_IMAGE_TOKENS)),
    # whisper's encoder, cross-attention and decoder self-attention
    ENCDEC_ARCH: ((1536, 1536, 0, None, False, 1500, None),
                  (224, 1536, 0, None, False, 1500, None),
                  (224, 224, 0, None, True, None, None)),
    # one rank's share of starcoder2's heads: 7e's teacher prefill, its
    # served prompts and check c's row, then a whole 4096-token chunk and
    # the 8192-token prompt's second (``scripts/lm_mesh.py``'s uncut run)
    MESH_KEY: ((MESH_B_BATCH[1], MESH_B_BATCH[1], 0, None),
               *((T, T, 0, None) for T in MESH_PROMPTS),
               (4096, 4096, 0, None), (4096, 8192, 4096, None)),
    # one rank's share of starcoder2's heads in phase 8e's training forward
    TRAIN_MESH_KEY: ((TRAIN_MESH_SEQ, TRAIN_MESH_SEQ, 0, None),),
    # one rank's query rows of recurrentgemma-2b's prefills in phase 7g
    RG_SEQ_KEY: RG_SEQ_CASES,
    # one rank's share of qwen3-moe's heads in phase 7f: the teacher
    # prefill, the 512-token prompt, check c's row, and the 8192-token
    # prompt's two chunks
    MOE_MESH_KEY: ((MESH_B_BATCH[1], MESH_B_BATCH[1], 0, None),
                   (512, 512, 0, None),
                   (MESH_C_TOKENS, MESH_C_TOKENS, 0, None),
                   (4096, 4096, 0, None), (4096, 8192, 4096, None)),
}
#: the shape each model's kernel row is timed at (its plain version too)
FLASH_TIMED = {LM_ARCH: (4096, 4096), RG_ARCH: (4096, 4096, 0, 2048),
               MOE_ARCH: (4096, 4096), MESH_KEY: (max(MESH_PROMPTS),) * 2,
               MOE_MESH_KEY: (4096, 4096),
               TRAIN_MESH_KEY: (TRAIN_MESH_SEQ, TRAIN_MESH_SEQ),
               VLM_ARCH: FLASH_SHAPES[VLM_ARCH][1],
               ENCDEC_ARCH: FLASH_SHAPES[ENCDEC_ARCH][0],
               RG_SEQ_KEY: (512, 2048, 1536, 2048)}
#: the flash row's sub-rows (kernel table rows 6c/6d, 6e, 6f, 6g, 6h, 6i,
#: 6j, 6k)
FLASH_ROW_KEYS = {"hd256": RG_ARCH, "h32": MOE_ARCH, "prefix": VLM_ARCH,
                  "hd64": ENCDEC_ARCH, "tp4": MESH_KEY,
                  "train_tp2": TRAIN_MESH_KEY, "ep4": MOE_MESH_KEY,
                  "seq4": RG_SEQ_KEY}
#: check b's prompts (text tokens) per LM path: the kernel's prefill against
#: the plain attention's; none for the ssm, which has no attention
CHECK_B_TOKENS = {LM_ARCH: (512,), "recurrentgemma-2b": (512, 3000),
                  "falcon-mamba-7b": (), MOE_ARCH: (512,),
                  VLM_ARCH: (16, 3840), ENCDEC_ARCH: (224,)}
#: the ssm's prefills traced for where their time goes: one whose scan
#: runs in 512-token chunks and one that runs unchunked
TRACE_SSM_TOKENS = (512, 3000)
#: flash kernel against its plain version on the same inputs on the card.
#: bf16: the tensor-core kernel rounds p to bf16 as the operand of p.v,
#: which moves an output by at most 2^-9 * sum(p |v|) / l <= 2^-9 max|v|
#: (and far less in practice: the roundings take both signs), and both
#: sides round a float32 result to bf16 once, so a value next to a rounding
#: boundary may land one ulp (2^-8 relative) away: rtol = atol = 8e-3
#: covers both at unit-scale outputs.  float32: the FP32-core kernel, the
#: same products summed in another order (2e-6 on outputs below ~3)
FLASH_TOL = {"bfloat16": dict(rtol=8e-3, atol=8e-3),
             "float32": dict(rtol=0.0, atol=2e-6)}
#: phase 6's float32 edges of the key splits (the float32 kernel splits a
#: q tile's 64-key chunks over a cluster, ``fp32_splits``): (name, B, H,
#: Hkv, hd, Sq, Skv, masks, k/v view), each held against the plain version
#: at ``FLASH_TOL["float32"]``: kv_len ending inside the last split's last
#: chunk; a window whose lower edge leaves 3 chunks to 8 splits; causal with
#: a 300-key prefix; a strided cache prefix (``[:, :Skv]`` of a longer
#: cache, two batches) at q_offset 1024; no key seen; a base 4 bytes off a
#: 16-byte boundary (the kernel's 4-byte copies)
FLASH_F32_EDGES = (
    ("kv_len_in_split", 1, 1, 1, 128, 64, 2048,
     dict(causal=False, kv_len=1000), None),
    ("window_empty_splits", 1, 1, 1, 256, 64, 2048,
     dict(causal=True, window=100, q_offset=1984), None),
    ("prefix_causal", 1, 8, 1, 256, 512, 512,
     dict(causal=True, prefix_len=300), None),
    ("cache_prefix_offset", 2, 9, 1, 128, 256, 1280,
     dict(causal=True, q_offset=1024), "cache"),
    ("no_key", 1, 8, 8, 64, 224, 1536, dict(causal=False, kv_len=0), None),
    ("unaligned", 1, 4, 2, 128, 300, 300, dict(causal=True), "unaligned"),
)
#: H100 SXM bf16 tensor-core peak (data sheet, dense, 700 W): the least time
#: for attention's products on this card
PEAK_BF16_FLOPS_PER_S = 989e12

#: ppr's eps on every path of this script
PPR_EPS = 1e-4
#: the seed of every random schedule and random walk of this script
RANDOM_SEED = 0
#: masked-matmul tolerance against float32 matmul: sums reassociate.  The
#: card-vs-CPU ppr comparison uses it too: both sides run the port's code,
#: and only the spread's summation order differs between them
MM_RTOL, MM_ATOL = 1e-5, 2e-6
#: LM check c: card against CPU in float32 compute (the same products and
#: sums in another order: cuBLAS and the kernel against the CPU's)
LM_F32_TOL = dict(rtol=1e-5, atol=1e-5)
#: LM check b: the full-width bf16 prefill's logits with the flash kernel
#: against the plain attention, as a share of the largest logit.  The two
#: attention outputs differ by p's bf16 rounding and at most one bf16 ulp
#: (FLASH_TOL); over 32 bf16 layers those differences move the logits by a
#: small fraction of their range
LM_LOGIT_RTOL = 0.05


def _kernel_name(mangled: str) -> str:
    """``ns::name<A, B>`` from an Itanium-mangled kernel name as ptxas
    prints it (nested names, integer and bool template arguments; else as
    given)."""
    i, parts = 2, []
    if mangled[i:i + 1] == "N":
        i += 1
    while i < len(mangled) and mangled[i].isdigit():
        j = i
        while j < len(mangled) and mangled[j].isdigit():
            j += 1
        n = int(mangled[i:j])
        parts.append(mangled[j:j + n])
        i = j + n
    if not parts:
        return mangled
    args = re.match(r"I((?:L[ib]\d+E)+)E", mangled[i:])
    if args is None:
        return parts[-1]
    vals = [("true" if v == "1" else "false") if t == "b" else v
            for t, v in re.findall(r"L([ib])(\d+)E", args.group(1))]
    return f"{parts[-1]}<{', '.join(vals)}>"


def log(msg: str) -> None:
    print(msg, flush=True)


def eager_ms(torch, fn, iters: int = 200, warmup: int = 10) -> float:
    """Mean milliseconds per call of ``fn`` issued eagerly from Python
    (CUDA events around ``iters`` back-to-back calls): on these tiny
    shapes this is the host's enqueue rate, not the card's."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / iters


def device_ms(torch, fn, iters: int = 200) -> float:
    """Mean milliseconds per call of ``fn`` on the card: ``iters`` calls
    captured in one CUDA graph, replayed between CUDA events, so the host
    does not pace the launches (inputs stay L2-warm, as the visit's
    relax rounds find them)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    graph.replay()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / iters


def replay_ms(torch, fn, reset, count, reps: int = 3):
    """(total card ms, total count) of ``reps`` replays of ``fn`` captured
    once in a CUDA graph, each replay after ``reset()`` and between CUDA
    events; ``count()`` reads what one replay did (e.g. visits)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        reset()
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    total_ms, total = 0.0, 0
    for _ in range(reps):
        reset()
        torch.cuda.synchronize()
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        total_ms += a.elapsed_time(b)
        total += count()
    return total_ms, total


#: finite share of phase 3's blocks besides the main path's road density
#: (~4 entries a column): a hub-heavy block and a fully finite one
DENSE_SHARES = (("hub", 0.25), ("full", 1.0))


def phase_kernels(torch, ops, rng) -> dict:
    """Phase 3: both kernels against their plain versions at Q=64, B=128,
    at the road density, a hub-like one and fully finite blocks."""
    from repro_torch.core.engine import column_lists
    from repro_torch.kernels.minplus.ref import list_contract_ref

    Q, B, nblk = 64, 128, 16
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    # road-like +inf density: ~4 finite entries per block row, a sparse
    # frontier of finite distances
    w = np.where(rng.random((nblk, B, B)) < 4.0 / B,
                 rng.uniform(1.0, 11.0, (nblk, B, B)), np.inf)
    d = np.where(rng.random((Q, B)) < 0.3, rng.uniform(0.0, 50.0, (Q, B)),
                 np.inf)
    x = np.where(rng.random((Q, B)) < 0.3, rng.uniform(0.0, 1e-2, (Q, B)),
                 0.0)
    # the denser blocks come from a generator of their own, so the later
    # phases draw what they drew before
    rng_dense = np.random.default_rng(16)
    by_density = {"road": w}
    for label, share in DENSE_SHARES:
        by_density[label] = np.where(
            rng_dense.random((nblk, B, B)) < share,
            rng_dense.uniform(1.0, 11.0, (nblk, B, B)), np.inf)
    graphs = {}
    for label, wd in by_density.items():
        wd = wd.astype(np.float32)
        graphs[label] = (torch.tensor(wd, device=dev),
                         tuple(torch.from_numpy(a).to(dev)
                               for a in column_lists(wd)))
    dt = torch.tensor(d, dtype=torch.float32, device=dev)
    xt = torch.tensor(x, dtype=torch.float32, device=dev)
    single = torch.tensor([3], dtype=torch.int64, device=dev)
    batched = torch.tensor([2, 5, 11, 7, -1], dtype=torch.int64, device=dev)
    # an empty launch through the same harness: the least any launch takes
    floor_ms = device_ms(torch, lambda: torch.cuda._sleep(0))
    log(f"kernel floor (empty launch, CUDA graph): {floor_ms} ms")

    def bounds(name, inp, idx, blocks, lists):
        """(bound ms, bound_by, dense-tile bound ms) of one call."""
        S = idx.shape[0]
        real = idx[idx >= 0]
        wf = torch.isfinite(blocks.index_select(0, real)).float()
        # instructions these inputs need, per (q, u, v) with a finite
        # w[u, v] and a live x[q, u]: min-plus issues an add and a min
        # (two instructions; min is taken at the add's issue rate, which
        # it does not exceed), the masked matmul one FMA
        lhs = (torch.isfinite(inp) if name == "minplus"
               else inp != 0).float()
        pairs = float((lhs @ wf).sum())
        t_ops = pairs * (2.0 if name == "minplus" else 1.0) / (
            PEAK_F32_INSTR_PER_S)
        # x in, out, idx; each real block as the smaller of its list (8 B
        # an entry for min-plus, 4 for the masked matmul, and its B + 1
        # starts) and its dense f32 tile, which holds the same operand;
        # beside it the dense tiles alone
        col_ptr = lists[0].long()
        nnz = (col_ptr[real, B] - col_ptr[real, 0]).double()
        tile = 4.0 * B * B
        per_block = ((8.0 if name == "minplus" else 4.0) * nnz
                     + 4.0 * (B + 1)).clamp(max=tile)
        rows = 4.0 * (Q * B + S * Q * B) + 8 * S
        t_lists = (rows + float(per_block.sum())) / PEAK_BYTES_PER_S
        t_dense = (rows + tile * real.numel()) / PEAK_BYTES_PER_S
        return (1e3 * max(t_lists, t_ops),
                "bytes" if t_lists >= t_ops else "operations",
                1e3 * max(t_dense, t_ops))

    rows = {}
    for name, inp, fn in (("minplus", dt, ops.minplus),
                          ("masked_matmul", xt, ops.masked_matmul)):
        row = {}
        for form, idx in (("single", single), ("batched", batched)):
            t = {"ms_by_density": {}, "plain_ms_by_density": {},
                 "bound_ms_by_density": {}, "max_abs_err": 0.0}
            for label, (blocks, lists) in graphs.items():
                got = fn(inp, blocks, idx, lists)
                want = ops.plain(name, inp, blocks, idx)
                torch.cuda.synchronize()
                if name == "minplus":
                    if not torch.equal(got, want):
                        raise AssertionError(
                            f"minplus {form} ({label}) is not bitwise equal "
                            f"to its plain version")
                else:
                    torch.testing.assert_close(got, want, rtol=MM_RTOL,
                                               atol=MM_ATOL)
                    t["max_abs_err"] = max(t["max_abs_err"], float(
                        (got - want).abs().max()))
                    # the list order the fused visit shares, bit for bit
                    if not torch.equal(got, list_contract_ref(
                            name, inp, *lists, idx)):
                        raise AssertionError(
                            f"masked_matmul {form} ({label}) differs from "
                            f"the list order's bits")
                bound_ms, bound_by, dense_ms = bounds(name, inp, idx,
                                                      blocks, lists)
                ms = device_ms(torch, lambda: fn(inp, blocks, idx, lists))
                plain_ms = device_ms(
                    torch, lambda: ops.plain(name, inp, blocks, idx))
                t["ms_by_density"][label] = ms
                t["plain_ms_by_density"][label] = plain_ms
                t["bound_ms_by_density"][label] = bound_ms
                if label == "road":
                    t.update(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                             bound_by=bound_by, dense_tile_bound_ms=dense_ms,
                             eager_ms=eager_ms(
                                 torch, lambda: fn(inp, blocks, idx, lists)),
                             library_ms=None)
                    if name == "masked_matmul":
                        wv = blocks.index_select(0, idx[idx >= 0])
                        t["library_ms"] = device_ms(
                            torch, lambda: inp @ torch.isfinite(wv).float())
            t["floor_ms"] = floor_ms
            log(f"kernel {name} {form} S={idx.shape[0]}: " + json.dumps(t))
            row[form] = t
        # an index past nblk gives a NaN plane, -1 the identity plane
        blocks, lists = graphs["road"]
        idx = torch.tensor([3, nblk, -1], dtype=torch.int64, device=dev)
        got = fn(inp, blocks, idx, lists)
        ident = float("inf") if name == "minplus" else 0.0
        torch.cuda.synchronize()
        if not (torch.equal(got[0], fn(inp, blocks, single, lists)[0])
                and bool(got[1].isnan().all())
                and bool((got[2] == ident).all())):
            raise AssertionError(f"{name}: an index past nblk or -1 did not "
                                 f"give the NaN / identity plane")
        log(f"kernel {name}: index {nblk} (past nblk) gives a NaN plane, "
            f"-1 the identity plane")
        rows[name] = row
    return rows


def phase_gathered(torch, ops, floor_ms) -> dict:
    """Phase 3d: the gathered form of both kernels at a baselines round's
    shape on the main path's graph: every block (S = nblk) against its
    source partition's rows (X = P, ``xrow = blk_src``), Q = 64, B = 128,
    a seeded frontier over a third of the cells.  Min-plus bitwise against
    its plain version; the masked matmul bitwise with the list order and
    within the tolerance of its plain version.  Timed over a CUDA graph
    beside the empty launch's ``floor_ms``; the plain version on the host
    clock (it loops over x's rows)."""
    from repro_torch.core.engine import DeviceGraph
    from repro_torch.core.yielding import NO_YIELD
    from repro_torch.fpp import FPPSession
    from repro_torch.graphs.generators import grid2d
    from repro_torch.kernels.minplus.ref import list_contract_ref

    Q = 64
    bg, _ = FPPSession(grid2d(SIDE, SIDE, seed=0), device="cuda").plan(
        num_queries=Q).prepared()
    dg = DeviceGraph.build(bg, NO_YIELD, Q, device="cuda")
    P, B, S = bg.num_parts, bg.block_size, bg.blocks.shape[0]
    dev = dg.device
    idx = torch.arange(S, device=dev)
    xrow = torch.from_numpy(bg.blk_src.astype(np.int64)).to(dev)
    rng = np.random.default_rng(17)
    live = rng.random((P, Q, B)) < 0.3
    d = torch.tensor(np.where(live, rng.uniform(0.0, 50.0, (P, Q, B)),
                              np.inf), dtype=torch.float32, device=dev)
    x = torch.tensor(np.where(live, rng.uniform(0.0, 1e-2, (P, Q, B)), 0.0),
                     dtype=torch.float32, device=dev)
    blocks = dg.dense_blocks()
    wf = torch.isfinite(blocks).float()
    col_ptr = dg.col_ptr.long()
    nnz = (col_ptr[:, B] - col_ptr[:, 0]).double()
    rows = {}
    for name, inp, fn in (("minplus", d, ops.minplus),
                          ("masked_matmul", x, ops.masked_matmul)):
        minplus = name == "minplus"
        got = fn(inp, blocks, idx, dg.lists, xrow=xrow)
        want = ops.plain(name, inp, blocks, idx, xrow)
        torch.cuda.synchronize()
        err = 0.0
        if minplus:
            if not torch.equal(got, want):
                raise AssertionError("gathered minplus is not bitwise equal "
                                     "to its plain version")
        else:
            torch.testing.assert_close(got, want, rtol=MM_RTOL, atol=MM_ATOL)
            err = float((got - want).abs().max())
            order = torch.empty_like(got)
            for r in range(P):
                sel = torch.nonzero(xrow == r).squeeze(1)
                order[sel] = list_contract_ref(name, inp[r], *dg.lists,
                                               idx.index_select(0, sel))
            if not torch.equal(got, order):
                raise AssertionError("gathered masked_matmul differs from "
                                     "the list order's bits")
        # bytes: x, out, idx and xrow once, each block as the smaller of its
        # list and its dense tile; operations: the live (q, u, v) pairs
        tile = 4.0 * B * B
        lists = float(((8.0 if minplus else 4.0) * nnz + 4.0 * (B + 1))
                      .clamp(max=tile).sum())
        nbytes = 4.0 * (P * Q * B + S * Q * B) + 16.0 * S + lists
        lhs = (torch.isfinite(inp) if minplus else inp != 0).float()
        pairs = float(torch.bmm(lhs.index_select(0, xrow), wf).sum())
        t_bytes = nbytes / PEAK_BYTES_PER_S
        t_ops = pairs * (2.0 if minplus else 1.0) / PEAK_F32_INSTR_PER_S
        row = {
            "max_abs_err": err,
            "ms": device_ms(torch, lambda: fn(inp, blocks, idx, dg.lists,
                                              xrow=xrow), iters=50),
            "plain_ms": eager_ms(torch, lambda: ops.plain(
                name, inp, blocks, idx, xrow), iters=3, warmup=1),
            "bound_ms": 1e3 * max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None, "floor_ms": floor_ms,
            "S": S, "X": P, "Q": Q, "B": B, "mbytes": nbytes / 1e6,
            "pairs": pairs,
        }
        if not minplus:
            xg = inp.index_select(0, xrow)
            row["library_ms"] = device_ms(
                torch, lambda: torch.bmm(xg, torch.isfinite(blocks).float()),
                iters=20)
            row["library_is"] = ("torch.bmm(x[xrow], isfinite(w).float()), "
                                 "x gathered beforehand")
        log(f"kernel {name} gathered: " + json.dumps(row))
        rows[name] = row
    return rows


def phase_tiles(torch, rng) -> dict:
    """Phase 3b: the frontier and the push round against their plain
    versions at Q=64, B=128."""
    from repro_torch.kernels.frontier import ops as fops
    from repro_torch.kernels.frontier.ref import frontier_ref
    from repro_torch.kernels.ppr_push import ops as pops
    from repro_torch.kernels.ppr_push.ref import push_ref

    Q, B, dev = 64, 128, torch.device("cuda")
    qb = Q * B

    def put(a, dtype=torch.float32):
        return torch.tensor(a, dtype=dtype, device=dev)

    rows = {}
    # a visit's start: a few buffered ops over a half-settled distance row
    buf = put(np.where(rng.random((Q, B)) < 0.1,
                       rng.uniform(0.0, 50.0, (Q, B)), np.inf))
    dist = put(np.where(rng.random((Q, B)) < 0.5,
                        rng.uniform(0.0, 50.0, (Q, B)), np.inf))
    delta = 4.0
    got = fops.frontier(buf, dist, delta=delta)
    d1, srcs, alpha, _, _ = frontier_ref(buf, dist, delta=delta)
    torch.cuda.synchronize()
    for g, w in zip(got, (d1, srcs, alpha[:, 0])):
        if not torch.equal(g, w):
            raise AssertionError("frontier is not bitwise equal to its "
                                 "plain version")
    # each input read once, each output written once; ~5 f32 instructions
    # per cell (two compares, two mins, the window add)
    nbytes = 4.0 * (2 * qb + 2 * qb + Q)
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, 5.0 * qb / PEAK_F32_INSTR_PER_S
    rows["frontier"] = {
        "max_abs_err": 0.0,
        "ms": device_ms(torch, lambda: fops.frontier(buf, dist,
                                                     delta=delta)),
        "plain_ms": device_ms(torch, lambda: frontier_ref(buf, dist,
                                                          delta=delta)),
        "bound_ms": 1e3 * max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": None,
    }
    log("kernel frontier: " + json.dumps(rows["frontier"]))

    # one push round: a third of the residuals above eps*deg, road-like
    # block density
    deg = put(rng.integers(0, 6, B), torch.int32)
    p = put(rng.uniform(0.0, 1e-2, (Q, B)))
    r = put(np.where(rng.random((Q, B)) < 0.3,
                     rng.uniform(0.0, 2e-3, (Q, B)), 0.0))
    acc = put(rng.uniform(0.0, 1e-3, (Q, B)))
    w = put(np.where(rng.random((B, B)) < 4.0 / B,
                     rng.uniform(1.0, 11.0, (B, B)), np.inf))
    got = pops.ppr_push(p, r, acc, w, deg, alpha=0.15, eps=PPR_EPS)
    want = push_ref(p, r, acc, w, deg.float(), alpha=0.15, eps=PPR_EPS)
    torch.cuda.synchronize()
    err = 0.0
    for g, wt in zip(got, want[:3]):
        torch.testing.assert_close(g, wt, rtol=MM_RTOL, atol=MM_ATOL)
        err = max(err, float((g - wt).abs().max()))
    # the spread's FMAs per (q, u, v) with an active source and a finite
    # w[u, v], plus ~10 elementwise f32 instructions per cell
    pairs = float((want[3].float() @ torch.isfinite(w).float()).sum())
    nbytes = 4.0 * (3 * qb + B * B + B + 3 * qb)
    t_bytes = nbytes / PEAK_BYTES_PER_S
    t_ops = (pairs + 10.0 * qb) / PEAK_F32_INSTR_PER_S
    rows["ppr_push"] = {
        "max_abs_err": err,
        "ms": device_ms(torch, lambda: pops.ppr_push(
            p, r, acc, w, deg, alpha=0.15, eps=PPR_EPS)),
        "plain_ms": device_ms(torch, lambda: push_ref(
            p, r, acc, w, deg.float(), alpha=0.15, eps=PPR_EPS)),
        "bound_ms": 1e3 * max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": None,
    }
    log("kernel ppr_push: " + json.dumps(rows["ppr_push"]))
    return rows


def phase_threefry(torch) -> dict:
    """Phase 3e: ``fg_threefry`` over THREEFRY_N counters (``prng.uniform``
    of one key, the random policy's draw at a larger shape) against its
    plain version on the card, bitwise, and timed; then the walk tape's
    draw (two fold_ins and a uniform per element) and ``split`` at the
    shapes the paths give them (64 walkers, one key)."""
    from repro_torch.core import prng
    from repro_torch.kernels.threefry.ref import draw_ref

    dev = torch.device("cuda")
    key = prng.PRNGKey(0, dev)
    got = prng.uniform(key, (THREEFRY_N,))
    want = draw_ref(key, THREEFRY_N, uniform=True)
    if not torch.equal(got, want):
        raise AssertionError("fg_threefry's uniform differs from the plain "
                             "version")
    src = torch.arange(0, 64 * 571, 571, device=dev)
    step = torch.arange(64, device=dev) % 32
    if not torch.equal(prng.tape_uniform(key, src, step),
                       draw_ref(key, 64, folds=(src, step), iota=False,
                                uniform=True)):
        raise AssertionError("fg_threefry's tape draw differs from the "
                             "plain version")
    if not torch.equal(prng.split(key), torch.stack(draw_ref(key, 2), 1)):
        raise AssertionError("fg_threefry's split differs from the plain "
                             "version")
    ms = device_ms(torch, lambda: prng.uniform(key, (THREEFRY_N,)), iters=50)
    plain_ms = eager_ms(torch, lambda: draw_ref(key, THREEFRY_N,
                                                uniform=True), iters=5,
                        warmup=2)
    t_bytes = (4.0 * THREEFRY_N + 16) / PEAK_BYTES_PER_S
    t_ops = (THREEFRY_OPS + UNIFORM_OPS) * THREEFRY_N / PEAK_INT32_OPS_PER_S
    row = {"name": "threefry", "route": "cuda",
           "source": "src/repro_torch/kernels/csrc/threefry.cu",
           "replaces": None, "max_abs_err": 0.0, "ms": ms,
           "plain_ms": plain_ms, "bound_ms": 1e3 * max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "library_ms": None, "n": THREEFRY_N,
           "ms_is": f"card ms per launch, uniform over {THREEFRY_N} "
                    f"counters, CUDA graph"}
    log("kernel threefry: " + json.dumps(row))
    return row


def phase_contracts() -> list:
    """Phase 3f: every kernel's static contract (``kernels/contract.py``)
    against the built library: a contract's dynamic shared memory equals
    the library's own count (``fg_*_smem`` through the package's
    ``library_smem_bytes``; a kernel without dynamic shared memory has
    none), and the contract passes (``analysis/kernel_passes.py``) find no
    error.  One ``{"contracts": ...}`` line."""
    import importlib

    from repro_torch.analysis import kernel_passes
    from repro_torch.kernels.contract import all_contracts

    rows, bad = [], []
    for c in all_contracts():
        ops = importlib.import_module(c.module)
        count = getattr(ops, "library_smem_bytes", None)
        lib = count(c) if count is not None else None
        rows.append({"kernel": c.kernel, "grid": list(c.grid),
                     "threads": c.threads, "cluster": c.cluster,
                     "smem_bytes": c.smem_bytes, "library_smem_bytes": lib,
                     "wired": c.wired})
        if (lib if lib is not None else 0) != c.smem_bytes:
            bad.append(rows[-1])
    errors = [f.render() for f in kernel_passes.run()
              if f.severity == "error"]
    log(json.dumps({"contracts": rows, "pass_errors": errors}))
    if bad or errors:
        raise AssertionError(f"contracts: the libraries' shared memory "
                             f"differs from the contracts' {bad}, or the "
                             f"passes found errors {errors}")
    return rows


def _clone_state(state):
    from repro_torch.core.visit import VisitState
    return VisitState(tuple(x.clone() for x in state.planes),
                      state.buf.clone(), state.prio.clone(),
                      state.ops_count.clone(), state.stamp.clone())


def _copy_state(dst, src) -> None:
    for a, b in zip((*dst.planes, dst.buf, dst.prio, dst.ops_count,
                     dst.stamp),
                    (*src.planes, src.buf, src.prio, src.ops_count,
                     src.stamp)):
        a.copy_(b)


def _visit_bytes(torch, dg, order, nplanes, Q, B, list_bytes_per_entry):
    """Bytes the visits of ``order`` must move, each input read once and
    each output written once: own rows in and out, the per-column vectors
    and the metadata, and for each valid neighbour slot its buffer rows in
    and out and its value rows in; each block (the diagonal and each
    slot's) as the smaller of its column lists (``list_bytes_per_entry``
    per finite entry plus its B + 1 column starts) and its dense B x B f32
    tile, and, for comparison, as the dense tile alone.  Returns (lists,
    dense)."""
    qb4 = Q * B * 4.0
    col_ptr = dg.col_ptr.long()
    nnz = (col_ptr[:, -1] - col_ptr[:, 0]).double()
    blk = dg.nbr_blk.index_select(0, order)
    valid = blk >= 0
    blocks = torch.cat([dg.diag_blk.index_select(0, order), blk[valid]])
    nv, nslots = order.numel(), int(valid.sum())
    rows = (nv * (2 * (nplanes + 1) * qb4 + 12.0 * B + 12.0 * dg.num_parts
                  + 16.0 * Q)
            + nslots * (3 * qb4 + 4.0 * B))
    tile = B * B * 4.0
    lists = float((list_bytes_per_entry * nnz.index_select(0, blocks)
                   + 4.0 * (B + 1)).clamp(max=tile).sum())
    dense = blocks.numel() * tile
    return rows + lists, rows + dense


def phase_fused_kernel(torch) -> dict:
    """Phase 3c: the fused visit on the main path's graph.  One K=64 chunk
    takes the path to a mid-run state (Q = 64, and a ragged Q = 60); there
    one launch of a whole K=64 chunk, at every compiled cluster size, is
    held against K visits of its plain version (min-plus dense, sparse and
    strict: bitwise) or of the unfused megastep on the card (push:
    bitwise; one visit against the plain version at the masked-matmul
    tolerance) on copies of the same state.  Then one chunk's launch is
    captured in a CUDA graph and replayed between CUDA events at each
    cluster size (card ms per visit), and at the path's cluster size as
    K one-visit launches and, for min-plus, with the sparse frontier."""
    from repro_torch.core import prng
    from repro_torch.core.engine import FPPEngine
    from repro_torch.core.visit import make_megastep, minplus_algebra
    from repro_torch.fpp import FPPSession, planner
    from repro_torch.graphs.generators import grid2d
    from repro_torch.kernels.fused_visit.ops import (CLUSTER_SIZES,
                                                     cluster_size,
                                                     kernel_smem_bytes,
                                                     make_fused_visit,
                                                     smem_bytes)
    from repro_torch.kernels.fused_visit.ref import fused_step_ref

    g = grid2d(SIDE, SIDE, seed=0)
    Q, K = 64, 64
    sess = FPPSession(g, device="cuda").plan(num_queries=Q, fused=True)
    B = sess.current_plan.block_size
    path_c = cluster_size(Q)
    for alg, n in (("minplus", 1), ("push", 2)):
        if kernel_smem_bytes(alg, Q, B) != sess.mem.fused_working_set(B, Q,
                                                                       n):
            raise AssertionError(f"{alg}: the kernel's shared-memory layout "
                                 f"and the planner's model disagree")
        for q in (Q, 60):
            for c in CLUSTER_SIZES:
                if kernel_smem_bytes(alg, q, B, c) != smem_bytes(n, q, B, c):
                    raise AssertionError(f"{alg} Q={q} cluster {c}: the "
                                         f"kernel's layout and ops."
                                         f"smem_bytes disagree")
    srcs = np.random.default_rng(0).choice(g.n, Q, replace=False)
    bg, perm = sess.prepared()

    def same(x, y):
        return all(torch.equal(a, b) for a, b in zip(x, y))

    rows = {}
    for kind, mode in (("sssp", "minplus"), ("ppr", "push")):
        err = 0.0
        for q in (Q, 60):
            eng = FPPEngine(bg, mode=mode, num_queries=q, eps=PPR_EPS,
                            yield_config=planner.default_yield_config(kind,
                                                                      bg),
                            fused=True, device="cuda")
            state, _ = eng._megastep(eng.init_state(perm[srcs[:q]]), 0, K)
            counter, dg, P = K, eng.dg, eng.dg.num_parts

            def rows_of(s, st):      # the fused visit never touches slot P
                return (*s.planes, s.buf[:P], s.prio[:P], s.ops_count[:P],
                        s.stamp[:P], st)

            variants = [("dense", eng.algebra, "dense")]
            if mode == "minplus":
                window = eng.algebra.param("window")
                variants += [("sparse", eng.algebra, "sparse"),
                             ("strict", minplus_algebra(window, strict=True),
                              "dense")]
            for label, alg, fmode in variants:
                fv = make_fused_visit(dg, alg, eng.max_rounds, K=K,
                                      frontier_mode=fmode)
                want = _clone_state(state)
                wstats = fv.new_stats(want)
                if mode == "minplus":
                    for _ in range(K):
                        fv.ref(want, wstats, counter)
                else:
                    mega = make_megastep(dg, alg, eng.max_rounds, K=K)
                    want, ms = mega(want, counter, K)
                for c in CLUSTER_SIZES:
                    got = _clone_state(state)
                    gstats = fv.new_stats(got)
                    fv.launch(got, gstats, counter, K, c)
                    torch.cuda.synchronize()
                    if int(gstats[0]) != K:
                        raise AssertionError(
                            f"fused {kind} {label} Q={q} cluster {c}: "
                            f"{int(gstats[0])} visits, want {K}")
                    if mode == "minplus":
                        ok = same(rows_of(got, gstats), rows_of(want, wstats))
                    else:
                        ok = (same(rows_of(got, gstats)[:-1],
                                   rows_of(want, gstats)[:-1])
                              and (int(gstats[1]), K) == (ms.rounds,
                                                          ms.visits)
                              and torch.equal(gstats[-K:], ms.order))
                    if not ok:
                        raise AssertionError(
                            f"fused {kind} {label} Q={q} cluster {c}: one "
                            f"chunk's launch differs from "
                            + ("its plain version" if mode == "minplus"
                               else "the unfused card megastep"))
                    if mode == "push":
                        # one visit against the plain version
                        a, b = _clone_state(state), _clone_state(state)
                        sa, sb = fv.new_stats(a), fv.new_stats(b)
                        fv.launch(a, sa, counter, 1, c)
                        fv.ref(b, sb, counter)
                        torch.cuda.synchronize()
                        for x, y in zip(rows_of(a, sa), rows_of(b, sb)):
                            if not x.is_floating_point():
                                if not torch.equal(x, y):
                                    raise AssertionError(
                                        f"fused ppr Q={q} cluster {c}: one "
                                        f"visit's counts differ from its "
                                        f"plain version")
                                continue
                            torch.testing.assert_close(x, y, rtol=MM_RTOL,
                                                       atol=MM_ATOL)
                            fin = torch.isfinite(y)
                            if fin.any():
                                err = max(err, float(
                                    (x[fin] - y[fin]).abs().max()))
                log(f"kernel fused_visit {kind} {label} Q={q}: one chunk "
                    f"launch matches "
                    + ("its plain version bitwise" if mode == "minplus" else
                       "the unfused card megastep bitwise (one visit within "
                       "the masked-matmul tolerance of the plain version)")
                    + f" at clusters {list(CLUSTER_SIZES)}")

        # card ms per visit at each cluster size: one chunk's launch in a
        # CUDA graph, replayed from copies of the Q=64 mid-run state
        eng = FPPEngine(bg, mode=mode, num_queries=Q, eps=PPR_EPS,
                        yield_config=planner.default_yield_config(kind, bg),
                        fused=True, device="cuda")
        state, _ = eng._megastep(eng.init_state(perm[srcs]), 0, K)
        counter, dg = K, eng.dg
        fv = make_fused_visit(dg, eng.algebra, eng.max_rounds, K=K)
        static = _clone_state(state)
        stats, fresh = fv.new_stats(static), fv.new_stats(static)

        def reset():
            _copy_state(static, state)
            stats.copy_(fresh)

        by_cluster = {}
        for c in CLUSTER_SIZES:
            total_ms, visits = replay_ms(
                torch, lambda: fv.launch(static, stats, counter, K, c),
                reset, lambda: int(stats[0]))
            by_cluster[c] = total_ms / visits

        # the same chunk as K launches of one visit each (the design before
        # one launch per chunk), at the path's cluster size

        def one_visit_launches():
            for _ in range(K):
                fv.launch(static, stats, counter, 1, path_c)

        total_ms, visits = replay_ms(torch, one_visit_launches, reset,
                                     lambda: int(stats[0]))
        per_visit_launch_ms = total_ms / visits
        extra = {"ms_one_launch_per_visit": per_visit_launch_ms}
        if mode == "minplus":
            # the sparse frontier over the same chunk, at the path's cluster
            fvs = make_fused_visit(dg, eng.algebra, eng.max_rounds, K=K,
                                   frontier_mode="sparse")
            total_ms, visits = replay_ms(
                torch, lambda: fvs.launch(static, stats, counter, K, path_c),
                reset, lambda: int(stats[0]))
            extra["ms_sparse"] = total_ms / visits

        # the random policy over the same chunk at the path's cluster size
        # (the threefry key split in the kernel, once a visit): bitwise
        # against K visits of its plain version (min-plus) or of the
        # unfused card megastep (push), the carried key included; timed
        fvr = make_fused_visit(dg, eng.algebra, eng.max_rounds, K=K,
                               policy="random")
        key0 = prng.PRNGKey(RANDOM_SEED, "cuda")
        want, wkey = _clone_state(state), key0.clone()
        wstats = fvr.new_stats(want)
        if mode == "minplus":
            for _ in range(K):
                fvr.ref(want, wstats, counter, wkey)
        else:
            mega = make_megastep(dg, eng.algebra, eng.max_rounds,
                                 policy="random", K=K)
            want, ms = mega(want, counter, K, key0)
            wkey = ms.key
            wstats[0], wstats[1] = ms.visits, ms.rounds
            wstats[-K:] = ms.order
        got, gkey = _clone_state(state), key0.clone()
        gstats = fvr.new_stats(got)
        fvr.launch(got, gstats, counter, K, path_c, gkey)
        torch.cuda.synchronize()
        P = dg.num_parts
        planes = (lambda x: (*x.planes, x.buf[:P], x.prio[:P],
                             x.ops_count[:P], x.stamp[:P]))
        if not (int(gstats[0]) == K and torch.equal(gkey, wkey)
                and same(planes(got), planes(want))
                and torch.equal(gstats[:2], wstats[:2])
                and torch.equal(gstats[-K:], wstats[-K:])):
            raise AssertionError(f"fused {kind} random: one chunk's launch "
                                 f"differs from "
                                 + ("its plain version" if mode == "minplus"
                                    else "the unfused card megastep"))
        log(f"kernel fused_visit {kind} random: one chunk launch (cluster "
            f"{path_c}) bitwise equal to "
            + ("its plain version" if mode == "minplus" else
               "the unfused card megastep")
            + ", order " + json.dumps(gstats[-K:][:8].tolist()) + "...")
        rkey = key0.clone()

        def reset_random():
            reset()
            rkey.copy_(key0)

        total_ms, visits = replay_ms(
            torch, lambda: fvr.launch(static, stats, counter, K, path_c,
                                      rkey),
            reset_random, lambda: int(stats[0]))
        extra["ms_random"] = total_ms / visits

        # the plain version over the same chunk, host clock
        reset()
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(K):
            fv.ref(static, stats, counter)
        torch.cuda.synchronize()
        plain_ms = 1e3 * (time.perf_counter() - t) / max(int(stats[0]), 1)

        # the chunk's work, counted on its plain version: live (q, u, v)
        # pairs of every contraction (two f32 instructions each for
        # min-plus, one FMA for push) and the bytes each visit must move
        pairs = [0.0]

        def count(x, idx):
            real = idx[idx >= 0]
            if real.numel():
                lhs = (torch.isfinite(x) if mode == "minplus"
                       else x != 0).float()
                wf = torch.isfinite(
                    dg.dense_blocks().index_select(0, real)).float()
                pairs[0] += float((lhs @ wf).sum())

        reset()
        for _ in range(K):
            fused_step_ref(dg, fv.spec, static, stats, counter,
                           on_contract=count)
        nv = int(stats[0])
        order = stats[-K:][:nv].long()
        # min-plus reads each entry's u and w, push only its u
        nbytes, dense_bytes = _visit_bytes(torch, dg, order, len(state.planes),
                                           Q, B, 8.0 if mode == "minplus"
                                           else 4.0)
        ninstr = pairs[0] * (2.0 if mode == "minplus" else 1.0)
        t_bytes = nbytes / PEAK_BYTES_PER_S / nv
        t_ops = ninstr / PEAK_F32_INSTR_PER_S / nv
        row = {
            "max_abs_err": err, "ms": by_cluster[path_c],
            "plain_ms": plain_ms,
            "bound_ms": 1e3 * max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None, "cluster": path_c,
            "ms_by_cluster": by_cluster, **extra, "chunk_visits": nv,
            "bytes_per_visit": nbytes / nv,
            "dense_tile_bytes_per_visit": dense_bytes / nv,
            "dense_tile_bound_ms": 1e3 * max(
                dense_bytes / PEAK_BYTES_PER_S / nv, t_ops),
            "pairs_per_visit": pairs[0] / nv,
        }
        log(f"kernel fused_visit {kind}: " + json.dumps(row))
        rows[kind] = row
    return rows


def _engine_parity(label, bg, srcs, kind, mode, yc, **kw) -> None:
    """One kind's engine on the card against the engine on the CPU, each
    unfused and fused, and fused against unfused on the card: bitwise in
    values, hops, edges, stats and visit order (ppr: the masked-matmul
    tolerance between devices)."""
    from repro_torch.core.engine import FPPEngine

    res = {}
    for dev, fused in (("cuda", False), ("cpu", False), ("cuda", True),
                       ("cpu", True)):
        eng = FPPEngine(bg, mode=mode, num_queries=len(srcs), yield_config=yc,
                        eps=PPR_EPS, fused=fused, device=dev, **kw)
        res[dev, fused] = eng.run(srcs, record_order=True)

    def same(a, b):
        return (np.array_equal(a.values, b.values)
                and (a.residual is None) == (b.residual is None)
                and (a.residual is None
                     or np.array_equal(a.residual, b.residual))
                and np.array_equal(a.edges_processed, b.edges_processed))

    for what, a, b in (
            ("card vs CPU", res["cuda", False], res["cpu", False]),
            ("fused card vs fused CPU", res["cuda", True], res["cpu", True])):
        if kind == "ppr":
            np.testing.assert_allclose(a.values, b.values, rtol=MM_RTOL,
                                       atol=MM_ATOL,
                                       err_msg=f"ppr values, {what}")
            np.testing.assert_allclose(a.residual, b.residual,
                                       rtol=MM_RTOL, atol=MM_ATOL,
                                       err_msg=f"ppr residual, {what}")
            log(f"parity ppr {label} {what}: max diff "
                f"{np.abs(a.values - b.values).max():.3e} (rtol "
                f"{MM_RTOL}, atol {MM_ATOL}), visits {a.stats.visits} "
                f"vs {b.stats.visits}")
            continue
        if not (same(a, b) and a.stats == b.stats
                and a.visit_order == b.visit_order):
            raise AssertionError(f"{kind} {label} {what}: runs differ "
                                 f"({a.stats} vs {b.stats})")
        log(f"parity {kind} {label} {what}: bitwise equal, {a.stats}")
    # the fused kernel against the unfused megastep, both on the card:
    # bitwise for every kind (ppr's spread sums in one order on both)
    a, b = res["cuda", True], res["cuda", False]
    if not (same(a, b) and a.visit_order == b.visit_order
            and (a.stats.visits, a.stats.rounds) == (b.stats.visits,
                                                     b.stats.rounds)
            and a.stats.device_syncs == a.stats.host_syncs):
        raise AssertionError(f"{kind} {label}: fused card run differs from "
                             f"the unfused card run ({a.stats} vs "
                             f"{b.stats})")
    log(f"parity {kind} {label} fused card vs unfused card: bitwise equal, "
        f"{a.stats}")


def _check_baselines_launches(kind, counts, rounds) -> None:
    """A baselines run launches its contraction once a round, and nothing
    else."""
    need = "masked_matmul" if kind == "ppr" else "minplus"
    if counts[need] != rounds or sum(counts.values()) != rounds:
        raise AssertionError(f"baselines {kind}: launches {counts}, want "
                             f"{need} once per round ({rounds})")


def phase_parity(counters) -> None:
    """Phase 4: the engine on the card against the engine on the CPU, and
    the baselines backend on the card against the CPU, on grid2d(32, 32);
    cc and kreach also on a graph of many components."""
    from repro_torch.core.queries import WEIGHT_VARIANTS
    from repro_torch.fpp import FPPSession, planner
    from repro_torch.graphs.generators import erdos_renyi, grid2d

    Q = 16
    srcs = np.random.default_rng(2).choice(1024, Q, replace=False)
    graphs = {"grid2d(32, 32)": grid2d(32, 32, seed=1),
              "erdos_renyi(1024, 1.5)": erdos_renyi(1024, avg_deg=1.5,
                                                    seed=1)}
    for label, g in graphs.items():
        sess = FPPSession(g, device="cpu").plan(num_queries=Q, block_size=32)
        kinds = (("sssp", "minplus"), ("bfs", "minplus"), ("ppr", "push"),
                 ("cc", "cc"), ("kreach", "kreach"))
        if label != "grid2d(32, 32)":
            kinds = kinds[3:]
        for kind, mode in kinds:
            bg, perm = sess.prepared(weights=WEIGHT_VARIANTS.get(kind,
                                                                 "natural"))
            _engine_parity(label, bg, perm[srcs], kind, mode,
                           planner.default_yield_config(kind, bg),
                           hop_budget=8, hop_stride=sess.kreach_stride)

    # the baselines backend: one gathered launch a round on the card
    g = graphs["grid2d(32, 32)"]
    for kind in ("sssp", "bfs", "ppr", "cc", "kreach"):
        res, counts = {}, {}
        for dev in ("cuda", "cpu"):
            counters.reset()
            res[dev] = FPPSession(g, device=dev).plan(
                num_queries=Q, block_size=32).run(kind, srcs, eps=PPR_EPS,
                                                  backend="baselines")
            counts[dev] = counters.read()
        a, b = res["cuda"], res["cpu"]
        _check_baselines_launches(kind, counts["cuda"], a.stats["rounds"])
        if a.stats != b.stats or not np.array_equal(a.edges_processed,
                                                     b.edges_processed):
            raise AssertionError(f"baselines {kind}: card {a.stats} vs CPU "
                                 f"{b.stats}")
        if kind == "ppr":
            np.testing.assert_allclose(a.values, b.values, rtol=MM_RTOL,
                                       atol=MM_ATOL,
                                       err_msg="baselines ppr, card vs CPU")
        elif not (np.array_equal(a.values, b.values)
                  and (a.residual is None
                       or np.array_equal(a.residual, b.residual))):
            raise AssertionError(f"baselines {kind}: card and CPU differ")
        if any(counts["cpu"].values()):
            raise AssertionError(f"baselines {kind} on the CPU counted "
                                 f"launches: {counts['cpu']}")
        log(f"parity baselines {kind} card vs CPU: "
            + ("within the masked-matmul tolerance" if kind == "ppr"
               else "bitwise equal") + f", {a.stats}")


def phase_path(torch, counters) -> dict:
    """Phase 5: the main path at 64 queries, fused on the side-SIDE grid
    (sssp/bfs against scipy's Dijkstra, ppr's mass and residual); then
    unfused at :data:`UNFUSED_PATH_SIDE` against fused on that grid."""
    import scipy.sparse as sp
    from scipy.sparse.csgraph import dijkstra

    from repro_torch.fpp import FPPSession
    from repro_torch.graphs.generators import grid2d

    Q = 64
    t0 = time.perf_counter()
    launches = {}      # per kernel, summed over the path's runs

    def setup(side):
        g = grid2d(side, side, seed=0)
        csr = sp.csr_matrix((g.weights.astype(np.float64), g.indices,
                             g.indptr), shape=(g.n, g.n))
        srcs = np.random.default_rng(0).choice(g.n, Q, replace=False)
        return (g, csr, srcs, FPPSession(g, device="cuda").plan(num_queries=Q),
                FPPSession(g, device="cuda").plan(num_queries=Q, fused=True))

    def run(kind, ss, fmode, g, csr, srcs, side):
        """One run, checked against its oracle and for its launches."""
        fused = ss.current_plan.fused is True
        bg, _ = ss.prepared(weights={"bfs": "unit"}.get(kind, "natural"))
        counters.reset()
        torch.cuda.synchronize()
        t = time.perf_counter()
        res = ss.run(kind, srcs, eps=PPR_EPS, frontier_mode=fmode)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        counts = counters.read()
        st = res.stats
        if kind == "ppr":
            deg = np.maximum(g.out_degree(), 1)
            mass = res.values.sum(1) + res.residual.sum(1)
            if np.abs(mass - 1.0).max() > 1e-3:
                raise AssertionError(f"ppr mass {mass}")
            if not (res.residual <= PPR_EPS * deg + 1e-6).all():
                raise AssertionError("ppr residual above eps*deg")
        else:
            want = dijkstra(csr, indices=srcs, unweighted=(kind == "bfs"))
            got = res.values.astype(np.float64)
            if kind == "bfs":
                ok = np.array_equal(got, want)
            else:
                ok = (np.array_equal(np.isinf(got), np.isinf(want))
                      and np.allclose(got[np.isfinite(want)],
                                      want[np.isfinite(want)], rtol=1e-5))
            if not (ok and np.isfinite(got).all()):
                raise AssertionError(f"{kind} (side {side}) disagrees with "
                                     f"dijkstra")
        for name, c in _launched(kind, counts, st, fused).items():
            launches[name] = launches.get(name, 0) + c
        label = ("fused " if fused else "") + kind + (
            "-sparse" if fmode == "sparse" else "") + (
            f" side {side}" if side != SIDE else "")
        log(f"path {label}: " + json.dumps({
            "n": g.n, "m": g.m, "P": bg.num_parts, "B": bg.block_size,
            "Q": Q, "dmax": int(bg.nbr_blk.shape[1]),
            "visits": st["visits"], "rounds": st["rounds"],
            "host_syncs": st["host_syncs"],
            "device_syncs": st["device_syncs"], "wall_s": wall,
            "visits_per_s": st["visits"] / wall, "launches": counts}))
        return res

    def same_run(a, b, kind, what):
        """Bitwise equal answers (ppr: its stats only) and equal visits,
        rounds and chunks."""
        st, ref = a.stats, b.stats
        if (st["visits"], st["rounds"], st["host_syncs"]) != (
                ref["visits"], ref["rounds"], ref["host_syncs"]):
            raise AssertionError(f"{what} {kind}: visits, rounds or chunks "
                                 f"differ")
        if kind != "ppr" and not (
                np.array_equal(a.values, b.values)
                and np.array_equal(a.edges_processed, b.edges_processed)):
            raise AssertionError(f"{what} {kind}: not bitwise equal")

    # fused on the main path's graph: each kind once, sssp also sparse
    g, csr, srcs, sess, fsess = setup(SIDE)
    plan = sess.current_plan
    if fsess.current_plan.block_size != plan.block_size:
        raise AssertionError("the fused plan picked another block size")
    answers = {kind: run(kind, fsess, "dense", g, csr, srcs, SIDE)
               for kind in ("sssp", "bfs", "ppr")}
    same_run(run("sssp", fsess, "sparse", g, csr, srcs, SIDE),
             answers["sssp"], "sssp", "fused sparse against fused dense")
    # unfused against fused on the smaller grid (the unfused dispatch is
    # host-paced: 90-111 s for sssp and bfs at side 192)
    side = UNFUSED_PATH_SIDE
    gu, csru, su, usess, ufsess = setup(side)
    side_answers = {}         # the engine's answers phase 5f holds against
    for kind in ("sssp", "bfs", "ppr"):
        ures = run(kind, usess, "dense", gu, csru, su, side)
        fres = run(kind, ufsess, "dense", gu, csru, su, side)
        same_run(fres, ures, kind, f"side {side}: fused against unfused")
        side_answers[kind] = ures
    log(f"path side {side}: fused sssp and bfs bitwise equal to unfused, "
        f"ppr's visits, rounds and chunks equal")
    log(f"path setup+runs: {time.perf_counter() - t0:.1f} s, plan B="
        f"{plan.block_size}, method={plan.method}")
    bg, perm = sess.prepared()
    phase_profile(torch, bg, perm[srcs])
    return launches, {"sess": sess, "fsess": fsess, "srcs": srcs,
                      "csr": csr, "answers": answers,
                      "side": {"sess": usess, "srcs": su,
                               "answers": side_answers}}


def _canonical_cc(g) -> np.ndarray:
    """scipy's weak components of ``g`` as min-vertex-id labels (the port's
    canonical cc labels)."""
    import scipy.sparse as sp
    from scipy.sparse.csgraph import connected_components

    csr = sp.csr_matrix((np.ones(g.m), g.indices, g.indptr),
                        shape=(g.n, g.n))
    ncomp, lab = connected_components(csr, directed=False)
    mins = np.full(ncomp, g.n, dtype=np.int64)
    np.minimum.at(mins, lab, np.arange(g.n))
    return mins[lab].astype(np.float32)


def _launched(kind, counts, st, fused) -> dict:
    """Check one engine run's launches (fused: one launch per chunk and no
    contraction; unfused: one contraction launch per relax round and one
    per visit) and return what they add to the kernel table's counts."""
    if fused:
        if (counts["fused_visit"] != st["host_syncs"]
                or counts["minplus"] or counts["masked_matmul"]
                or st["device_syncs"] != st["host_syncs"]):
            raise AssertionError(f"fused {kind}: launches {counts}, stats "
                                 f"{st}; want one fused launch per chunk")
        tile = "ppr_push" if kind == "ppr" else "frontier"
        return {**counts, tile + "_in_fused": counts["fused_visit"]}
    need = "masked_matmul" if kind == "ppr" else "minplus"
    if counts[need] != st["rounds"] + st["visits"]:
        raise AssertionError(f"{kind}: launched {need} {counts[need]} "
                             f"times, want one per round and one per visit")
    return counts


def phase_kinds(torch, counters, ctx, launches) -> None:
    """Phase 5c: this slice's paths at 64 queries on the main path's graph:
    fused cc (the grid and a graph of many components) against scipy's
    components, fused kreach against the sequential oracle, unfused cc and
    kreach at :data:`UNFUSED_SIDE` against their fused runs, the
    baselines backend for every kind (one launch a round) against scipy
    and the engine, ``plan(tune=True, fused=True)``, and the applications
    (bc, landmarks, ncp).  Each run's counts are reset just before it and
    read just after, and added to ``launches``."""
    from scipy.sparse.csgraph import dijkstra

    from repro_torch.core import oracles
    from repro_torch.core.applications import bc_accumulate
    from repro_torch.fpp import FPPSession
    from repro_torch.graphs.generators import erdos_renyi, grid2d

    Q, K_HOPS = 64, 8
    sess, fsess, srcs = ctx["sess"], ctx["fsess"], ctx["srcs"]
    answers, csr, g = ctx["answers"], ctx["csr"], fsess.graph

    def add(counts):
        for name, c in counts.items():
            launches[name] = launches.get(name, 0) + c

    def drive(label, ss, kind, sources, **kw):
        counters.reset()
        torch.cuda.synchronize()
        t = time.perf_counter()
        res = ss.run(kind, sources, eps=PPR_EPS, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        counts = counters.read()
        bg, _ = ss.prepared()
        log(f"path {label}: " + json.dumps({
            "n": ss.graph.n, "m": ss.graph.m, "P": bg.num_parts,
            "B": bg.block_size, "Q": len(sources),
            "dmax": int(bg.nbr_blk.shape[1]), **res.stats, "wall_s": wall,
            "launches": counts}))
        return res, counts

    # cc, fused, on the grid and on a graph of many components
    ge = erdos_renyi(g.n, avg_deg=1.5, seed=0)
    esess = FPPSession(ge, device="cuda").plan(num_queries=Q, fused=True)
    for label, ss in (("grid", fsess), ("erdos_renyi(n, 1.5)", esess)):
        res, counts = drive(f"fused cc {label}", ss, "cc", srcs)
        add(_launched("cc", counts, res.stats, True))
        if ss is fsess:
            answers["cc"] = res
        want = _canonical_cc(ss.graph)
        if not (res.values == want[None]).all():
            raise AssertionError(f"fused cc ({label}) differs from scipy's "
                                 f"components")
        log(f"fused cc ({label}): {np.unique(want).size} components, equal "
            f"to scipy's in every lane")
    # kreach, fused, against the sequential oracle on four sources
    res, counts = drive("fused kreach", fsess, "kreach", srcs, k=K_HOPS)
    add(_launched("kreach", counts, res.stats, True))
    answers["kreach"] = res
    for i in range(4):
        vals, hops, _ = oracles.kreach(g, int(srcs[i]), K_HOPS)
        if not (np.array_equal(res.values[i], vals)
                and np.array_equal(res.residual[i], hops)):
            raise AssertionError(f"fused kreach source {srcs[i]} differs "
                                 f"from oracles.kreach")
    log(f"fused kreach k={K_HOPS}: values and hops bitwise equal to "
        f"oracles.kreach on 4 sources")

    # cc and kreach unfused, against their fused runs on the same graph
    for kind, side in UNFUSED_SIDE.items():
        gu = g if side == SIDE else grid2d(side, side, seed=0)
        su = srcs if side == SIDE else np.random.default_rng(0).choice(
            gu.n, Q, replace=False)
        usess = sess if side == SIDE else FPPSession(
            gu, device="cuda").plan(num_queries=Q)
        side = f"side {side}"
        ures, counts = drive(f"{kind} {side}", usess, kind, su, k=K_HOPS)
        add(_launched(kind, counts, ures.stats, False))
        fres, counts = drive(f"fused {kind} {side}", usess, kind, su,
                             k=K_HOPS, fused=True)
        add(_launched(kind, counts, fres.stats, True))
        if side == f"side {UNFUSED_PATH_SIDE}":
            ctx["side"]["answers"][kind] = ures
        if not (np.array_equal(ures.values, fres.values)
                and (kind == "cc" or np.array_equal(ures.residual,
                                                    fres.residual))
                and np.array_equal(ures.edges_processed,
                                   fres.edges_processed)
                and (ures.stats["visits"], ures.stats["rounds"])
                == (fres.stats["visits"], fres.stats["rounds"])):
            raise AssertionError(f"{kind} ({side}): unfused and fused runs "
                                 f"differ")
        log(f"{kind} {side}: unfused bitwise equal to fused")

    # the baselines backend, one gathered launch a round
    for kind in ("sssp", "bfs", "ppr", "cc", "kreach"):
        res, counts = drive(f"baselines {kind}", sess, kind, srcs, k=K_HOPS,
                            backend="baselines")
        _check_baselines_launches(kind, counts, res.stats["rounds"])
        add(counts)
        if kind == "ppr":
            deg = np.maximum(g.out_degree(), 1)
            diff = np.abs(res.values - answers["ppr"].values) / deg
            if diff.max() > 4 * PPR_EPS:
                raise AssertionError(f"baselines ppr is {diff.max()} per "
                                     f"unit of degree from the engine's")
            continue
        if kind in ("sssp", "bfs"):
            want = dijkstra(csr, indices=srcs, unweighted=(kind == "bfs"))
            got = res.values.astype(np.float64)
            ok = (np.array_equal(got, want) if kind == "bfs" else
                  np.array_equal(np.isinf(got), np.isinf(want))
                  and np.allclose(got[np.isfinite(want)],
                                  want[np.isfinite(want)], rtol=1e-5))
            if not ok:
                raise AssertionError(f"baselines {kind} disagrees with "
                                     f"dijkstra")
        ref = answers[kind]
        same = (np.array_equal(res.values, ref.values)
                and (kind != "kreach"
                     or np.array_equal(res.residual, ref.residual)))
        if not same:
            raise AssertionError(f"baselines {kind} is not bitwise equal to "
                                 f"the engine's answer")

    # plan(tune=True): every block size the memory model admits, measured
    t = time.perf_counter()
    tsess = FPPSession(g, device="cuda").plan(
        num_queries=Q, fused=True, tune=True, tune_sources=srcs[:8])
    tp = tsess.current_plan
    for row in tp.tuning_rows:
        log("tune row: " + json.dumps(dict(row)))
    log(f"tune: chose B={tp.block_size} (model B="
        f"{fsess.current_plan.block_size}) in "
        f"{time.perf_counter() - t:.1f} s")

    # the applications, through the fused plan
    counters.reset()
    t = time.perf_counter()
    bc, res = fsess.bc(srcs[:16])
    wall = time.perf_counter() - t
    add(_launched("bfs", counters.read(), res.stats, True))
    levels = dijkstra(csr, indices=srcs[:16], unweighted=True)
    if not np.array_equal(bc, bc_accumulate(g, srcs[:16], levels)):
        raise AssertionError("bc differs from bc_accumulate on scipy's "
                             "levels")
    log(f"app bc (16 sources): {wall:.3f} s, bitwise equal to "
        f"bc_accumulate on scipy's levels; max {bc.max():.1f}")
    counters.reset()
    t = time.perf_counter()
    ll, res = fsess.landmarks(srcs)
    wall = time.perf_counter() - t
    add(_launched("sssp", counters.read(), res.stats, True))
    if not np.array_equal(ll.dists, answers["sssp"].values):
        raise AssertionError("landmarks differ from the sssp values")
    log(f"app landmarks (64): {wall:.3f} s, equal to the sssp values")
    counters.reset()
    t = time.perf_counter()
    prof, res = fsess.ncp(srcs, eps=PPR_EPS)
    wall = time.perf_counter() - t
    add(_launched("ppr", counters.read(), res.stats, True))
    log(f"app ncp (64 seeds): {wall:.3f} s, profile "
        + json.dumps([None if not np.isfinite(v) else float(v)
                      for v in prof]))


def phase_random(torch, counters, ctx, launches) -> None:
    """Phase 5d: rw, the random policy and streaming at 64 queries on the
    main path's graph.  rw (length 32, the session's default) on the
    engine and baselines backends: bitwise equal to each other, to the
    CPU and, on 8 walkers, to ``oracles.random_walk``; one threefry launch
    a step round.  The random schedule, fused: sssp bitwise equal to the
    priority run, ppr within 4·eps·deg; unfused at :data:`RANDOM_SIDE`:
    the fused run's visit order.  Streaming: 24 sources, 3
    chunks, 40 more; fused sssp bitwise and ppr within 4·eps·deg of the
    one-shot union, one launch and one read per chunk; unfused sssp at
    side 64 bitwise; rw through 16 lanes bitwise equal to ``run("rw")``.
    Each run's counts are reset just before it and read just after, and
    added to ``launches``."""
    from repro_torch.core import oracles
    from repro_torch.core.engine import FPPEngine
    from repro_torch.fpp import FPPSession, planner
    from repro_torch.graphs.generators import grid2d

    Q, K, LEN = 64, 64, 32
    sess, fsess, srcs = ctx["sess"], ctx["fsess"], ctx["srcs"]
    answers, g = ctx["answers"], fsess.graph
    deg = np.maximum(g.out_degree(), 1)

    def add(counts):
        for name, c in counts.items():
            launches[name] = launches.get(name, 0) + c

    def drive(label, fn):
        counters.reset()
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        counts = counters.read()
        add(counts)
        return out, counts, wall

    def only(counts, **want):
        got = {k: v for k, v in counts.items() if v}
        if got != {k: v for k, v in want.items() if v}:
            raise AssertionError(f"launches {got}, want {want}")

    # rw on both backends, card against CPU and against the oracle replay
    csess = FPPSession(g, device="cpu").plan(num_queries=Q)
    runs = {}
    for bk in ("engine", "baselines"):
        res, counts, wall = drive(f"rw {bk}", lambda: sess.run(
            "rw", srcs, backend=bk, length=LEN, seed=RANDOM_SEED))
        st = res.stats
        only(counts, threefry=st["rounds"])
        runs[bk] = res
        log(f"path rw {bk}: " + json.dumps({
            "Q": Q, "length": LEN, **st, "wall_s": wall,
            "launches": counts}))
        cpu = csess.run("rw", srcs, backend=bk, length=LEN,
                        seed=RANDOM_SEED)
        if not (np.array_equal(res.values, cpu.values)
                and np.array_equal(res.edges_processed,
                                   cpu.edges_processed)
                and res.stats == cpu.stats):
            raise AssertionError(f"rw {bk}: card and CPU differ")
    a, b = runs["engine"], runs["baselines"]
    if not (np.array_equal(a.values, b.values)
            and np.array_equal(a.edges_processed, b.edges_processed)):
        raise AssertionError("rw: engine and baselines walks differ")
    if not (a.values.sum(axis=1) == LEN + 1).all():
        raise AssertionError("rw: an occupancy row does not count the "
                             "start and every step")
    walks = sess.random_walks(srcs, LEN, seed=RANDOM_SEED)
    cwalks = csess.random_walks(srcs, LEN, seed=RANDOM_SEED)
    for f in ("positions", "steps", "trajectory_hash", "occupancy"):
        if not np.array_equal(getattr(walks, f), getattr(cwalks, f)):
            raise AssertionError(f"random_walks {f}: card and CPU differ")
    bg, perm = sess.prepared()
    for i in range(8):
        path = oracles.random_walk(bg, int(perm[srcs[i]]), LEN,
                                   seed=RANDOM_SEED)
        if not (np.array_equal(np.bincount(path, minlength=g.n),
                               walks.occupancy[i])
                and path[-1] == perm[walks.positions[i]]):
            raise AssertionError(f"rw walker {i} differs from "
                                 f"oracles.random_walk")
    log("rw: engine and baselines bitwise equal, card equal to the CPU "
        "(positions, steps, hashes, occupancy), 8 walkers equal to "
        "oracles.random_walk")

    # the random schedule, fused, against the priority runs
    for kind in ("sssp", "ppr"):
        res, counts, wall = drive(f"fused random {kind}", lambda: fsess.run(
            kind, srcs, eps=PPR_EPS, schedule="random"))
        st = res.stats
        add({"ppr_push_in_fused" if kind == "ppr" else "frontier_in_fused":
             counts["fused_visit"]})
        only(counts, fused_visit=st["host_syncs"])
        if st["device_syncs"] != st["host_syncs"]:
            raise AssertionError(f"fused random {kind}: more than one read "
                                 f"a chunk")
        ref = answers[kind]
        if kind == "sssp" and not np.array_equal(res.values, ref.values):
            raise AssertionError("fused random sssp differs from the "
                                 "priority run")
        if kind == "ppr" and (np.abs(res.values - ref.values)
                              / deg).max() > 4 * PPR_EPS:
            raise AssertionError("fused random ppr is more than 4 eps deg "
                                 "from the priority run")
        log(f"path fused random {kind}: " + json.dumps({
            "Q": Q, **st, "wall_s": wall, "priority_visits":
            ref.stats["visits"], "launches": counts}))

    # unfused random sssp, its visit order against the fused one
    side = RANDOM_SIDE
    gu = grid2d(side, side, seed=0)
    su = np.random.default_rng(0).choice(gu.n, Q, replace=False)
    usess = FPPSession(gu, device="cuda").plan(num_queries=Q)
    bgu, permu = usess.prepared()
    yc = planner.default_yield_config("sssp", bgu)
    orders = {}
    for fused in (False, True):
        res, counts, wall = drive(
            f"random sssp side {side}", lambda: FPPEngine(
                bgu, num_queries=Q, yield_config=yc, schedule="random",
                seed=RANDOM_SEED, fused=fused, device="cuda").run(
                    permu[su], record_order=True))
        st = res.stats._asdict()
        orders[fused] = res
        if fused:
            add({"frontier_in_fused": counts["fused_visit"]})
            only(counts, fused_visit=st["host_syncs"])
        else:
            only(counts, minplus=st["rounds"] + st["visits"],
                 threefry=2 * st["visits"])
        log(f"path {'fused ' if fused else ''}random sssp side {side}: "
            + json.dumps({"Q": Q, **st, "wall_s": wall,
                          "launches": counts}))
    a, b = orders[False], orders[True]
    if not (a.visit_order == b.visit_order
            and np.array_equal(a.values, b.values)):
        raise AssertionError(f"random sssp side {side}: the unfused order "
                             f"or values differ from the fused run's")
    log(f"random sssp side {side}: unfused visit order ({len(a.visit_order)}"
        f" visits) bitwise equal to the fused kernel's")

    # streaming: 24 sources, three chunks, 40 more
    def staggered(ex, sources):
        qids = ex.submit(sources[:24])
        ex.pump(3 * K)
        qids += ex.submit(sources[24:])
        out = ex.run()
        return ex, np.stack([out[q] for q in qids])

    cases = [("sssp", fsess, True, srcs, answers["sssp"].values),
             ("ppr", fsess, True, srcs, answers["ppr"].values),
             ("sssp", usess, False, su, None)]
    for kind, ss, fused, sources, want in cases:
        (ex, got), counts, wall = drive(
            f"stream {kind}", lambda: staggered(ss.stream(
                kind, capacity=Q, eps=PPR_EPS, fused=fused, k_visits=K),
                sources))
        label = f"stream {'fused ' if fused else ''}{kind}" + (
            "" if ss is fsess else f" side {side}")
        if ex.host_syncs > -(-ex.visits // K) + 4:
            raise AssertionError(f"{label}: {ex.host_syncs} host syncs for "
                                 f"{ex.visits} visits")
        if fused:
            tile = "ppr_push" if kind == "ppr" else "frontier"
            add({tile + "_in_fused": counts["fused_visit"]})
            only(counts, fused_visit=ex.host_syncs)
        if want is None:
            want = ss.run(kind, sources).values
        if kind == "ppr":
            ok = (np.abs(got - want) / deg).max() <= 4 * PPR_EPS
        else:
            ok = np.array_equal(got, want)
        if not ok:
            raise AssertionError(f"{label} differs from the one-shot run")
        log(f"path {label}: " + json.dumps({
            "Q": Q, "visits": ex.visits, "host_syncs": ex.host_syncs,
            "wall_s": wall, "launches": counts}))
    (ex, got), counts, wall = drive("stream rw", lambda: staggered(
        sess.stream("rw", capacity=16, length=LEN, seed=RANDOM_SEED), srcs))
    if not np.array_equal(got, runs["engine"].values):
        raise AssertionError("stream rw differs from run('rw')")
    log("path stream rw (16 lanes): " + json.dumps({
        "Q": Q, "visits": ex.visits, "host_syncs": ex.host_syncs,
        "wall_s": wall, "launches": counts}))


#: phase 5e's mixed traffic: requests, arrival batches (one every
#: SERVE_GAP_S seconds, an open loop), the Zipf exponent over
#: SERVE_CANDIDATES sources, and the kinds in turn (kreach at k = 8, rw at
#: length 32 and seed 0, the server's defaults)
SERVE_REQUESTS, SERVE_BATCH, SERVE_GAP_S = 384, 64, 0.5
SERVE_ZIPF, SERVE_CANDIDATES = 1.1, 2048
SERVE_KINDS = ("sssp", "bfs", "ppr", "cc", "kreach", "rw")


def _serve_stream(g, seed: int = 0):
    """Phase 5e's arrival stream: (kind, source, tenant) per request,
    sources Zipf-skewed over a seeded candidate set, tenant0 sending 3 of
    every 4 requests."""
    rng = np.random.default_rng(seed)
    cand = rng.choice(np.flatnonzero(g.out_degree() > 0), SERVE_CANDIDATES,
                      replace=False)
    p = np.arange(1, SERVE_CANDIDATES + 1, dtype=np.float64) ** -SERVE_ZIPF
    picks = rng.choice(SERVE_CANDIDATES, SERVE_REQUESTS, p=p / p.sum())
    return [(SERVE_KINDS[i % len(SERVE_KINDS)], int(cand[j]),
             "tenant0" if i % 4 else "tenant1")
            for i, j in enumerate(picks)]


def phase_serve(torch, counters, ctx, launches) -> dict:
    """Phase 5e: graph serving on the card (``serve/``), on the main path's
    graph and its fused session (Q = 64, B = 128, P = 288).

    Synchronous parity: ``GraphServer(capacity=64, fused=True).serve()`` of
    phase 5's 64 sources, sssp and ppr, bitwise equal to phase 5's fused
    ``session.run`` (ppr's residual too), edges included, one B5 launch a
    chunk.  Mixed traffic: :data:`SERVE_REQUESTS` requests of the six
    kinds from two tenants through ``serve_forever`` in arrival batches,
    every response ``ok`` and equal to a synchronous ``serve()`` of the
    same stream on a fresh server and to a one-shot ``session.run`` of its
    source (bitwise; ppr within 4·eps·deg: its lanes share visits with
    other lanes, and the visit order follows them); hits ``cached`` with
    nothing billed; one B5 launch a chunk of the fused pools, no
    contraction, threefry for rw.  One unfused pool at ``UNFUSED_SIDE``
    (sssp, B1), bitwise equal to the fused pool there.  The warm cache:
    each pool's first request cold and prewarmed, and the cold build's
    split.  Then ``launch/serve.py --workload graph`` at road-ca.  Each
    run's counts are reset just before it and read just after, and added
    to ``launches``."""
    from repro_torch.core import engine as _engine
    from repro_torch.fpp import FPPSession, planner
    from repro_torch.fpp.streaming import build_stream_bundle
    from repro_torch.graphs.generators import grid2d
    from repro_torch.launch import serve as launch_serve
    from repro_torch.serve import GraphRequest, GraphServer, MegastepCache
    from repro_torch.serve.dispatch import load_kernels

    load_kernels()          # every library loaded before any lane starts
    Q, K = 64, 64
    fsess, srcs, answers = ctx["fsess"], ctx["srcs"], ctx["answers"]
    g = fsess.graph
    deg = np.maximum(g.out_degree(), 1)
    out = {}

    def add(counts):
        for name, c in counts.items():
            launches[name] = launches.get(name, 0) + c

    def drive(fn):
        counters.reset()
        torch.cuda.synchronize()
        t = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        counts = counters.read()
        add(counts)
        return res, counts, wall

    def server(**kw):
        return GraphServer(capacity=Q, k_visits=K, fused=True,
                           eps=PPR_EPS, **kw)

    def pool_syncs(srv):
        """Chunks of the server's fused pools (one host sync each)."""
        return sum(p.totals[1] for p in srv._pool_order if p.fused)

    def add_tiles(srv):
        """The frontier tile runs in every min-plus B5 launch, the push
        round in every push launch."""
        for tile, push in (("frontier", False), ("ppr_push", True)):
            add({tile + "_in_fused": sum(
                p.totals[1] for p in srv._pool_order
                if p.fused and (p.kind == "ppr") == push)})

    def only(label, counts, **want):
        got = {k: v for k, v in counts.items() if v}
        if set(got) != {k for k, v in want.items() if v} or any(
                v is not True and got.get(k, 0) != v
                for k, v in want.items()):
            raise AssertionError(f"{label}: launches {got}, want {want}")

    # synchronous parity with phase 5's fused runs
    for kind in ("sssp", "ppr"):
        srv = server()
        srv.register_graph("grid", fsess)
        rids = [srv.submit(GraphRequest(kind=kind, source=int(s),
                                        graph="grid")) for s in srcs]
        resp, counts, wall = drive(srv.serve)
        want = answers[kind]
        for i, rid in enumerate(rids):
            r = resp[rid]
            if not (r.status == "ok"
                    and np.array_equal(r.values, want.values[i])
                    and (kind != "ppr" or np.array_equal(r.residual,
                                                         want.residual[i]))
                    and r.stats["edges"] == want.edges_processed[i]):
                raise AssertionError(f"serve {kind}: request {i} differs "
                                     f"from phase 5's fused run")
        only(f"serve {kind}", counts, fused_visit=pool_syncs(srv))
        add_tiles(srv)
        log(f"serve sync {kind}: " + json.dumps({
            "requests": Q, "rounds": srv.rounds, "wall_s": wall,
            "launches": counts}))
    log("serve sync: sssp and ppr bitwise equal to phase 5's fused "
        "session.run (values, residual, edges)")

    # mixed traffic through the running lanes
    stream = _serve_stream(g)
    reqs = [GraphRequest(kind=k, source=s, graph="grid", tenant=t)
            for k, s, t in stream]
    batches = [reqs[i:i + SERVE_BATCH]
               for i in range(0, len(reqs), SERVE_BATCH)]
    conc = server()
    conc.register_graph("grid", fsess)

    def arrivals():
        for i, b in enumerate(batches):
            if i:
                time.sleep(SERVE_GAP_S)
            yield b

    resp, counts, wall = drive(lambda: conc.serve_forever(arrivals()))
    cstats = conc.stats()
    rids = sorted(resp)
    if len(rids) != len(reqs) or any(resp[r].status != "ok" for r in rids):
        raise AssertionError("serve mixed: a request got no ok response")
    only("serve mixed", counts, fused_visit=pool_syncs(conc),
         threefry=True, minplus=0, masked_matmul=0)
    add_tiles(conc)
    for r in rids:
        st = resp[r].stats
        if st.get("cached") and (st["visits"], st["edges"],
                                 st["host_syncs"]) != (0, 0.0, 0):
            raise AssertionError("serve mixed: a cache hit was billed")
    if not (cstats["cache_hits"] and cstats["coalesced"]):
        raise AssertionError(f"serve mixed: the result cache or dedup never "
                             f"fired: {cstats}")
    # the same stream, synchronously, on a fresh server sharing the bundles
    sync = server(cache=conc.cache)
    sync.register_graph("grid", fsess)

    def replay():
        for b in batches:
            sync.submit_all(b)
            sync.serve()
        return sync.responses

    sresp, scounts, swall = drive(replay)
    only("serve replay", scounts, fused_visit=pool_syncs(sync),
         threefry=True, minplus=0, masked_matmul=0)
    add_tiles(sync)
    # one-shot runs of every distinct source of each kind
    one = {}
    for kind in SERVE_KINDS:
        uniq = np.array(sorted({s for k, s, _ in stream if k == kind}))
        res, _, _ = drive(lambda: fsess.run(kind, uniq, eps=PPR_EPS, k=8,
                                            length=32, seed=0))
        one[kind] = {int(s): (res.values[i], None if res.residual is None
                              else res.residual[i])
                     for i, s in enumerate(uniq)}
    for r in rids:
        a, b = resp[r], sresp[r]
        v, res = one[a.kind][a.source]
        if a.kind == "ppr":
            ok = ((np.abs(a.values - b.values) / deg).max() <= 4 * PPR_EPS
                  and (np.abs(a.values - v) / deg).max() <= 4 * PPR_EPS)
        else:
            ok = (np.array_equal(a.values, b.values)
                  and np.array_equal(a.values, v)
                  and (res is None or np.array_equal(a.residual, res)))
        if not (b.status == "ok" and ok):
            raise AssertionError(f"serve mixed: request {r} ({a.kind}) "
                                 f"differs from the synchronous serve or "
                                 f"the one-shot run")
    lat = {k: [resp[r].stats["latency_s"] for r in rids
               if resp[r].kind == k] for k in SERVE_KINDS}
    caps = {}
    for key in conc.cache._cache:
        caps.setdefault(key[1], []).append(key[3])
    out["mixed"] = {
        "requests": len(reqs), "batches": len(batches),
        "gap_s": SERVE_GAP_S, "wall_s": wall,
        "requests_per_s": len(reqs) / wall,
        "latency_ms": {k: {"p50": float(np.percentile(v, 50)) * 1e3,
                           "p99": float(np.percentile(v, 99)) * 1e3}
                       for k, v in lat.items()},
        "host_syncs_per_request": float(np.mean(
            [resp[r].stats["host_syncs"] for r in rids])),
        "rounds": conc.rounds, "launches": counts,
        "capacities_built": {k: sorted(v) for k, v in caps.items()},
        "pools": cstats["pools"],
        "stats": {k: cstats[k] for k in (
            "cache_hits", "cache_misses", "cache_evictions", "cache_bytes",
            "coalesced", "fanout", "compile_cache")},
        "replay": {"wall_s": swall, "rounds": sync.rounds,
                   "launches": scounts}}
    log("serve mixed: " + json.dumps(out["mixed"]))
    log(f"serve mixed: {len(reqs)} requests ok, bitwise equal to the "
        f"synchronous replay and the one-shot runs (ppr within 4 eps deg)")

    # one unfused pool at side 64: B1 through serving, against fused
    side = UNFUSED_SIDE["kreach"]
    gu = grid2d(side, side, seed=0)
    usess = FPPSession(gu, device="cuda").plan(num_queries=Q)
    su = np.random.default_rng(0).choice(gu.n, Q, replace=False)
    vals = {}
    for fused in (False, True):
        srv = GraphServer(capacity=Q, k_visits=K, fused=fused)
        srv.register_graph("small", usess)
        ids = [srv.submit(GraphRequest(kind="sssp", source=int(s),
                                       graph="small")) for s in su]
        resp_u, counts, wall = drive(srv.serve)
        vals[fused] = np.stack([resp_u[i].values for i in ids])
        if fused:
            only("serve fused side 64", counts, fused_visit=pool_syncs(srv))
            add_tiles(srv)
        else:
            only("serve unfused side 64", counts, minplus=True)
        log(f"serve {'fused' if fused else 'unfused'} sssp side {side}: "
            + json.dumps({"requests": Q, "rounds": srv.rounds,
                          "wall_s": wall, "launches": counts}))
    if not np.array_equal(vals[False], vals[True]):
        raise AssertionError("serve side 64: the unfused pool differs from "
                             "the fused pool")

    # the warm cache: each pool's first request cold and prewarmed, and
    # the cold build split into the engine build, chunks and the copy back
    warm = {}
    src0 = int(srcs[0])
    for kind in ("sssp", "ppr"):
        row = {}
        for label, pre in (("cold", ()), ("prewarmed", ("sssp", "ppr"))):
            srv = server(autoscaler=None, cache=MegastepCache(),
                         prewarm=pre)
            srv.register_graph("grid", fsess)
            if pre:
                srv.cache.warm_async(fsess, "grid", kind, Q,
                                     **srv._warm_params(fsess, kind)).join()
            srv.start()
            try:
                t = time.perf_counter()
                r = srv.result(srv.submit(GraphRequest(
                    kind=kind, source=src0, graph="grid")), timeout=120)
                row[label + "_s"] = time.perf_counter() - t
            finally:
                srv.shutdown()
            row[label + "_build_s"] = srv.cache.stats()["compile_s"]
            want = answers[kind].values[0]
            if r.status != "ok" or not (
                    np.array_equal(r.values, want) if kind != "ppr" else
                    (np.abs(r.values - want) / deg).max() <= 4 * PPR_EPS):
                raise AssertionError(f"serve warm {kind}: wrong answer")
        bg, _ = fsess.prepared()
        yc = planner.default_yield_config(kind, bg)
        torch.cuda.synchronize()
        t = time.perf_counter()
        _engine.column_lists(np.ascontiguousarray(bg.blocks,
                                                  dtype=np.float32))
        row["column_lists_s"] = time.perf_counter() - t
        t = time.perf_counter()
        _engine.DeviceGraph.build(bg, yc, Q, "cuda")
        torch.cuda.synchronize()
        row["device_graph_build_s"] = time.perf_counter() - t
        t = time.perf_counter()
        bundle = build_stream_bundle(fsess, kind, Q, k_visits=K, fused=True,
                                     eps=PPR_EPS)
        torch.cuda.synchronize()
        row["bundle_build_s"] = time.perf_counter() - t
        ex = fsess.stream(kind, capacity=Q, k_visits=K, fused=True,
                          eps=PPR_EPS, megastep=bundle)
        times = {"chunk": 0.0, "harvest": 0.0}

        def timed(name, fn):
            def wrapper(*a, **kw):
                t0 = time.perf_counter()
                try:
                    return fn(*a, **kw)
                finally:
                    times[name] += time.perf_counter() - t0
            return wrapper

        ex._megastep = timed("chunk", ex._megastep)
        ex._harvest = timed("harvest", ex._harvest)
        (_, counts, wall) = drive(lambda: (ex.submit([src0]), ex.run()))
        add({("ppr_push" if kind == "ppr" else "frontier") + "_in_fused":
             counts["fused_visit"]})
        row.update({"chunks": ex.host_syncs, "chunk_s": times["chunk"],
                    "harvest_s": times["harvest"], "run_s": wall})
        warm[kind] = row
    out["warm"] = warm
    log("serve warm cache: " + json.dumps(warm))

    # the CLI, once, at road-ca (fused="auto": the unfused megastep)
    res, counts, wall = drive(lambda: launch_serve.main([
        "--workload", "graph", "--graph", "road-ca", "--kind", "mixed",
        "--requests", "8", "--batch", "4"]))
    if len(res) != 8 or any(r.status != "ok" for r in res.values()):
        raise AssertionError("launch/serve.py --workload graph failed")
    out["cli"] = {"wall_s": wall, "launches": counts}
    log("serve cli road-ca: " + json.dumps(out["cli"]))
    return out


#: the fused visit's kernels in a profiler trace (one per algebra, each
#: instantiated per cluster size: the last template argument)
#: phase 5f: the distributed backend.  Four gloo ranks share the card (NCCL
#: refuses two ranks on one GPU), then one NCCL rank runs a world of one
DIST_WORLD = 4
DIST_GLOO_RUNS = (((1, 4), ("sssp", "bfs", "ppr", "cc", "kreach", "rw")),
                  ((2, 2), ("sssp", "ppr")))
DIST_NCCL_RUNS = (((1, 1), ("sssp", "ppr")),)
#: the partitioned decode at starcoder2-7b's decode shape: (batch, cache
#: slots, heads, kv heads, head dim), a bf16 cache (q in float32, so the
#: comparison sees the combine, not a bf16 rounding of the output)
DIST_DECODE_SHAPE = (LM_BATCH, LM_MAX_LEN, 36, 4, 128)
DIST_DECODE_TOL = 1e-5
DIST_K_HOPS, DIST_RW_LENGTH = 8, 32


def phase_distributed(torch, ctx, launches, card: str) -> None:
    """Phase 5f: ``FPPSession.run(..., backend="distributed")`` on
    grid2d(UNFUSED_PATH_SIDE) with phase 5's 64 sources and plan (B = 128,
    P = 32), in a world of four gloo ranks that share the card (mesh (1, 4):
    the six kinds; mesh (2, 2): sssp and ppr; the partitioned decode at
    starcoder2-7b's decode shape on (1, 4)), then in a world of one NCCL
    rank (mesh (1, 1): sssp and ppr).  Every rank must return the same
    bits; sssp, bfs, cc, kreach and rw bitwise equal to the engine on the
    card (phase 5's and 5c's side-64 runs; cc and rw run here), ppr within
    4·eps·deg of it with its mass and residual bound; the decode within
    1e-5 of ``decode_attend_local`` on the whole cache.  Each rank resets
    its counts before each run and reads them after: each must have
    launched B1 (B2 for ppr, threefry for rw); the sums join
    ``launches``.  The walls are four processes sharing one card, so they
    measure the exchange's overhead, not scaling."""
    from repro_torch.launch import distributed as launcher
    from repro_torch.launch.mesh import spawn
    from repro_torch.models.attention import decode_attend_local

    side = ctx["side"]
    sess, srcs, answers = side["sess"], side["srcs"], dict(side["answers"])
    g = sess.graph
    Q = len(srcs)
    bg, _ = sess.prepared()
    answers["cc"] = sess.run("cc", srcs)
    answers["rw"] = sess.run("rw", srcs, length=DIST_RW_LENGTH,
                             seed=RANDOM_SEED)
    graph = ("grid2d", {"rows": UNFUSED_PATH_SIDE, "cols": UNFUSED_PATH_SIDE,
                        "seed": 0})

    def cases(runs):
        return [{"graph": graph, "mesh": mesh, "kind": kind,
                 "sources": srcs.tolist(), "num_queries": Q,
                 "block_size": None, "k": DIST_K_HOPS,
                 "length": DIST_RW_LENGTH, "seed": RANDOM_SEED,
                 "eps": PPR_EPS}
                for mesh, kinds in runs for kind in kinds]

    lengths = np.random.default_rng(5).integers(
        1, LM_MAX_LEN + 1, size=LM_BATCH).tolist()
    decode = {"decode": True, "mesh": (1, DIST_WORLD),
              "shape": DIST_DECODE_SHAPE, "seed": 7, "dtype": "bfloat16",
              "lengths": lengths}
    deg = g.out_degree()
    kernel_of = {"ppr": "masked_matmul", "rw": "threefry"}
    rows = []
    for backend, world, cs in (
            ("gloo", DIST_WORLD, cases(DIST_GLOO_RUNS) + [decode]),
            ("nccl", 1, cases(DIST_NCCL_RUNS))):
        t = time.perf_counter()
        per_rank = spawn(launcher.run_cases, world, backend,
                         args=(cs, None), timeout_s=120)
        log(f"distributed {backend} world of {world}: "
            f"{time.perf_counter() - t:.1f} s with the ranks' start")
        if not launcher.same_answers(per_rank):
            raise AssertionError(f"distributed {backend}: the ranks' "
                                 f"answers differ")
        for i, case in enumerate(cs):
            got = per_rank[0][i]
            counts = [r[i]["launches"] for r in per_rank]
            for name in ("minplus", "masked_matmul", "threefry"):
                launches[name] = launches.get(name, 0) + sum(
                    c[name] for c in counts)
            row = {"mesh": list(case["mesh"]), "backend": backend,
                   "wall_s": [r[i]["wall_s"] for r in per_rank],
                   "launches": counts}
            if case.get("decode"):
                q, k, v = launcher.decode_inputs(DIST_DECODE_SHAPE, 7,
                                                 "bfloat16")
                dev = torch.device("cuda")
                want = decode_attend_local(
                    q.to(dev), k.to(dev), v.to(dev),
                    torch.arange(LM_MAX_LEN, device=dev),
                    torch.tensor(lengths, device=dev)).cpu().numpy()
                err = float(np.abs(got["out"] - want).max())
                if not err <= DIST_DECODE_TOL:
                    raise AssertionError(f"partitioned decode off by {err}")
                rows.append({"op": "decode_attend_partitioned",
                             "shape": list(DIST_DECODE_SHAPE),
                             "lengths": lengths, "max_abs_err": err, **row})
                continue
            kind = case["kind"]
            need = kernel_of.get(kind, "minplus")
            if not all(c[need] > 0 for c in counts):
                raise AssertionError(f"distributed {backend} {kind} "
                                     f"{case['mesh']}: a rank launched no "
                                     f"{need}: {counts}")
            want = answers[kind]
            if kind == "ppr":
                err = np.abs(got["values"] - want.values) / np.maximum(deg, 1)
                mass = got["values"].sum(1) + got["residual"].sum(1)
                r = got["residual"][:, deg > 0]
                if not (err.max() <= 4 * PPR_EPS
                        and np.abs(mass - 1.0).max() <= 5e-3
                        and (r <= PPR_EPS * deg[deg > 0] + 1e-6).all()):
                    raise AssertionError(
                        f"distributed {backend} ppr {case['mesh']}: "
                        f"{err.max()} from the engine, mass {mass.min()}.."
                        f"{mass.max()}")
            elif not (np.array_equal(got["values"], want.values)
                      and (kind != "kreach"
                           or np.array_equal(got["residual"],
                                             want.residual))
                      and (kind != "rw"
                           or np.array_equal(got["edges"],
                                             want.edges_processed))):
                raise AssertionError(f"distributed {backend} {kind} "
                                     f"{case['mesh']}: not bitwise equal "
                                     f"to the engine")
            rows.append({"kind": kind,
                         "supersteps": got["stats"]["supersteps"],
                         "device_syncs": [r[i]["stats"]["device_syncs"]
                                          for r in per_rank],
                         "edges": float(got["edges"].sum()), **row})
    log("distributed: every rank the same bits; sssp, bfs, cc, kreach and "
        "rw bitwise equal to the engine, ppr within 4·eps·deg; the decode "
        f"within {DIST_DECODE_TOL}")
    log(json.dumps({"distributed": {
        "card": card, "graph": f"grid2d({UNFUSED_PATH_SIDE})", "n": g.n,
        "Q": Q, "B": bg.block_size, "P": bg.num_parts, "runs": rows}}))


FUSED_NAMES = {"minplus": "fused_minplus_kernel", "push": "fused_push_kernel"}
#: fg_minplus's and fg_masked_matmul's kernel in a profiler trace
CONTRACT_NAME = "list_contract_kernel"


def _cluster_of(key: str):
    """The cluster size in a traced fused kernel's name, e.g. ``8`` from
    ``(anonymous namespace)::fused_push_kernel<0, 8>(FusedArgs)``."""
    m = re.search(r"fused_\w+_kernel<[^<>]*?(\d+)>", key)
    return int(m.group(1)) if m else None


#: traced runs a trace check may take.  The profiler on the card has
#: dropped a kernel's event from a trace (once in a traced fused chunk,
#: once in a 32-launch prefill; the same code passed in every other traced
#: run), so a check that finds events missing, and none wrong or extra,
#: traces the same work again
TRACE_TRIES = 3


def trace_once(torch, warm, active):
    """``(key_averages, wall ms, result)`` of ``active()`` traced on the
    card, after ``warm()`` traced as a warm-up step whose events are
    dropped (a trace that starts with the tracer can lose kernel events)."""
    from torch.profiler import ProfilerActivity, profile, schedule

    traced, out = [], []
    with profile(activities=[ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1),
                 on_trace_ready=lambda pr: traced.append(
                     pr.key_averages())) as prof:
        for fn in (warm, active):
            t = time.perf_counter()
            out.append(fn())
            torch.cuda.synchronize()
            wall_ms = 1e3 * (time.perf_counter() - t)
            prof.step()
    return traced[-1], wall_ms, out[-1]


def _device_us(e) -> float:
    return (getattr(e, "self_device_time_total", None)
            or getattr(e, "self_cuda_time_total", 0.0))


def phase_profile(torch, bg, srcs) -> None:
    """Phase 5b: where a visit's time goes, over one steady K=64 chunk of
    the main path per algebra and dispatch (unfused, fused).  The chunk is
    timed on the host clock without the profiler, then the same chunk,
    from a copy of the same start state, is traced with
    ``torch.profiler`` (after one traced warm-up chunk from another copy,
    whose events are dropped) for the card's kernel time; the ratio is
    the card's busy share.  A fused chunk must show one launch of the
    cluster kernel, by name."""
    from repro_torch.core.engine import FPPEngine
    from repro_torch.core.visit import make_megastep
    from repro_torch.fpp import planner
    from repro_torch.kernels.fused_visit.ops import cluster_size

    for kind, mode, fused in (("sssp", "minplus", False),
                              ("ppr", "push", False),
                              ("sssp", "minplus", True),
                              ("ppr", "push", True)):
        eng = FPPEngine(bg, mode=mode, num_queries=64, eps=PPR_EPS,
                        yield_config=planner.default_yield_config(kind, bg),
                        device="cuda")
        mega = make_megastep(eng.dg, eng.algebra, eng.max_rounds, K=64,
                             fused=fused)
        state, _ = mega(eng.init_state(srcs), 0, 64)          # warm-up
        start = _clone_state(state)
        torch.cuda.synchronize()
        t = time.perf_counter()
        _, timed = mega(state, 64, 64)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t)
        want = [(cluster_size(64), 1)] if fused else []
        for attempt in range(1, TRACE_TRIES + 1):
            warm_state, traced_state = _clone_state(start), _clone_state(start)
            events, _, (_, traced) = trace_once(
                torch, lambda: mega(warm_state, 64, 64),
                lambda: mega(traced_state, 64, 64))
            rows = sorted(((_device_us(e), e.key, e.count) for e in events),
                          reverse=True)
            # a fused chunk is one launch of the cluster kernel, by name
            hits = [(k, n) for _, k, n in rows if FUSED_NAMES[mode] in k]
            got = [(_cluster_of(k), n) for k, n in hits]
            if got == want:
                break
            if got or not fused or attempt == TRACE_TRIES:
                raise AssertionError(
                    f"{'fused ' if fused else ''}{kind}: the traced chunk "
                    f"ran {hits}, want "
                    + (f"one launch of {FUSED_NAMES[mode]} with a cluster "
                       f"of {cluster_size(64)}" if fused else "none"))
            log(f"profile fused {kind}: trace {attempt} holds no event of "
                f"{FUSED_NAMES[mode]} (the tracer dropped it); tracing again")
        dev_ms = sum(r[0] for r in rows) / 1e3
        per_visit_wall = wall_ms / max(timed.visits, 1)
        per_visit_dev = dev_ms / max(traced.visits, 1)
        # an unfused chunk's contractions are the list kernel's launches
        contract = [(us, n) for us, k, n in rows if CONTRACT_NAME in k]
        if not fused and not contract:
            raise AssertionError(f"{kind}: the traced unfused chunk holds "
                                 f"no {CONTRACT_NAME} launch")
        contract_us = sum(us for us, _ in contract)
        log(f"profile {'fused ' if fused else ''}{kind}: " + json.dumps({
            "fused_kernels": hits,
            "contraction_kernel": {
                "launches": sum(n for _, n in contract),
                "device_ms_per_visit": contract_us / 1e3 / max(
                    traced.visits, 1),
                "share_of_device": (contract_us / 1e3 / dev_ms
                                    if dev_ms else None)},
            "visits": [timed.visits, traced.visits],
            "rounds": [timed.rounds, traced.rounds],
            "device_syncs": [timed.device_syncs, traced.device_syncs],
            "wall_ms_per_visit": per_visit_wall,
            "device_ms_per_visit": per_visit_dev if dev_ms else None,
            "device_busy_share": (per_visit_dev / per_visit_wall
                                  if dev_ms else None),
            "top_kernels_us": [[k[:60], round(us, 1), n]
                               for us, k, n in rows[:6]]}))


def _fcase(sq, skv, off=0, window=None, causal=True, kv_len=None,
           prefix_len=None) -> dict:
    """One flash shape of phase 6: the kernel's keyword arguments and the
    (Sq, Skv) it runs at."""
    return {"Sq": sq, "Skv": skv, "q_offset": off, "window": window,
            "causal": causal, "kv_len": kv_len, "prefix_len": prefix_len}


def _fkw(case) -> dict:
    return {k: case[k] for k in ("q_offset", "window", "causal", "kv_len",
                                 "prefix_len")}


def flash_heads(arch: str) -> tuple:
    """(H, Hkv, hd) of one of phase 6's models (:data:`FLASH_SHAPES`): a
    mesh key's are one rank's share of its model's heads."""
    from repro_torch.configs.base import get_config
    if arch == RG_SEQ_KEY:          # every head, on a rank's rows
        arch = RG_ARCH
    if arch in (MESH_KEY, TRAIN_MESH_KEY, MOE_MESH_KEY):
        cfg = get_config(MOE_ARCH if arch == MOE_MESH_KEY else LM_ARCH)
        n = TRAIN_MESH[1] if arch == TRAIN_MESH_KEY else MESH[1]
        return cfg.n_heads // n, cfg.n_kv_heads // n, cfg.head_dim_
    cfg = get_config(arch)
    return cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_


def flash_f32_edges(torch, gen) -> dict:
    """The float32 kernel at the edges of its key splits
    (:data:`FLASH_F32_EDGES`) against the plain version: {name: {"splits",
    "max_abs_err"}}.  Every case but the unaligned one runs at least two
    splits."""
    from repro_torch.kernels.flash_attention import ops as faops
    from repro_torch.kernels.flash_attention.ref import \
        flash_attention_gqa_ref

    dev = torch.device("cuda")
    out = {}
    for name, B, H, Hkv, hd, Sq, Skv, kw, view in FLASH_F32_EDGES:
        def rnd(*shape):
            return torch.randn(shape, generator=gen, device=dev)
        q = rnd(B, Sq, H, hd)
        if view == "cache":
            k, v = (rnd(B, Skv + 512, Hkv, hd)[:, :Skv] for _ in range(2))
        elif view == "unaligned":
            n = B * Skv * Hkv * hd
            k, v = (rnd(n + 1)[1:].view(B, Skv, Hkv, hd) for _ in range(2))
        else:
            k, v = rnd(B, Skv, Hkv, hd), rnd(B, Skv, Hkv, hd)
        splits = faops.fp32_splits(B, Sq, Skv, H, hd,
                                   faops._sm_count(q.device))
        if view != "unaligned" and splits < 2:
            raise AssertionError(f"float32 edge {name}: {splits} split")
        got = faops.flash_attention(q, k, v, **kw)
        want = flash_attention_gqa_ref(q, k, v, **kw)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, **FLASH_TOL["float32"])
        if name == "no_key" and bool(got.abs().max() != 0):
            raise AssertionError("float32 edge no_key: a row that sees no "
                                 "key is not 0")
        out[name] = {"splits": splits,
                     "max_abs_err": float((got - want).abs().max())}
        log(f"kernel flash_attention float32 edge {name}: {splits} splits, "
            f"max |err| {out[name]['max_abs_err']:.3e} (tol "
            f"{FLASH_TOL['float32']})")
    return out


def phase_flash(torch) -> dict:
    """Phase 6: the flash kernels against their plain version at the LM
    paths' shapes, each timed beside PyTorch's SDPA (the yardstick, never
    called by the port): starcoder2-7b's (hd 128), recurrentgemma-2b's
    (hd 256, MQA, window 2048), qwen3-moe-30b-a3b's (hd 128, 32 / 4
    heads), paligemma-3b's (hd 256, 8 / 1 heads, causal with a 256-key
    prefix) and whisper-base's (hd 64, 8 / 8 heads: the encoder and the
    cross-attention non-causal over 1,536 padded frames of which 1,500 are
    seen, the decoder causal) and one rank's query rows of
    recurrentgemma-2b's "seq" prefills in 7g (:data:`RG_SEQ_CASES`); the
    plain version timed at each model's timed shape (:data:`FLASH_TIMED`),
    each shape's bound beside its time."""
    import torch.nn.functional as F
    from torch.nn.attention.bias import causal_lower_right

    from repro_torch.kernels.flash_attention import ops as faops
    from repro_torch.kernels.flash_attention.ref import (
        attention_mask, flash_attention_gqa_ref)

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def inputs(heads, case, dtype):
        H, Hkv, hd = heads
        sq, skv = case["Sq"], case["Skv"]
        return tuple(torch.randn(shape, generator=gen, device=dev).to(dtype)
                     for shape in ((1, sq, H, hd), (1, skv, Hkv, hd),
                                   (1, skv, Hkv, hd)))

    def mask_of(case):
        return attention_mask(case["Sq"], case["Skv"], device=dev,
                              **_fkw(case))

    def library_ms(q, k, v, case):
        """SDPA on the same inputs in its [B, H, S, hd] layout, GQA: causal
        (bottom-right aligned when the queries sit at the end of the keys,
        as the chunked prefill's do), or with the equivalent boolean mask
        (a window, a prefix, padded keys)."""
        sq, skv, off = case["Sq"], case["Skv"], case["q_offset"]
        qs, ks, vs = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        plain_causal = (case["causal"] and case["window"] is None
                        and case["kv_len"] is None
                        and case["prefix_len"] is None)
        if not plain_causal:
            mask = mask_of(case)
        elif off == skv - sq:
            # at sq == skv this is SDPA's plain is_causal=True call
            mask = causal_lower_right(sq, skv)
        else:
            raise AssertionError(f"no SDPA yardstick for q_offset {off} at "
                                 f"({sq}, {skv})")
        return device_ms(torch, lambda: F.scaled_dot_product_attention(
            qs, ks, vs, attn_mask=mask, enable_gqa=True), iters=20)

    def flops_bytes(heads, case, dtype):
        # the (query, key) pairs the mask lets through, each 2*hd FMAs per
        # head (q.k and p.v), two operations per FMA; bytes: q, k, v read
        # once, out written once
        H, Hkv, hd = heads
        pairs = int(mask_of(case).sum())
        size = torch.tensor([], dtype=dtype).element_size()
        sq, skv = case["Sq"], case["Skv"]
        return (4.0 * H * hd * pairs,
                size * (2 * sq * H * hd + 2 * skv * Hkv * hd))

    rows = {}
    for arch, cases in FLASH_SHAPES.items():
        heads = flash_heads(arch)
        errs, by_shape = {}, []
        for dname, dtype in (("bfloat16", torch.bfloat16),
                             ("float32", torch.float32)):
            for case in map(lambda c: _fcase(*c), cases):
                if (case["window"] is not None and dtype != torch.bfloat16
                        and arch == LM_ARCH):
                    continue
                q, k, v = inputs(heads, case, dtype)
                kw = _fkw(case)
                got = faops.flash_attention(q, k, v, **kw)
                want = flash_attention_gqa_ref(q, k, v, **kw)
                torch.cuda.synchronize()
                torch.testing.assert_close(got, want, **FLASH_TOL[dname])
                err = float((got.float() - want.float()).abs().max())
                errs[dname] = max(errs.get(dname, 0.0), err)
                ms = device_ms(torch, lambda: faops.flash_attention(
                    q, k, v, **kw), iters=20)
                lib = library_ms(q, k, v, case)
                flops, nbytes = flops_bytes(heads, case, dtype)
                peak = (PEAK_BF16_FLOPS_PER_S if dtype == torch.bfloat16
                        else PEAK_F32_OPS_PER_S)
                bound = 1e3 * max(flops / peak, nbytes / PEAK_BYTES_PER_S)
                shape = {"dtype": dname, "H": heads[0], "Hkv": heads[1],
                         "hd": heads[2], **case, "max_abs_err": err,
                         "ms": ms, "library_ms": lib, "bound_ms": bound,
                         "share_of_bound": bound / ms,
                         "vs_library": ms / lib,
                         "tflop_per_s": flops / ms / 1e9}
                by_shape.append(shape)
                log(f"kernel flash_attention {dname} hd={heads[2]} "
                    + " ".join(f"{k}={v}" for k, v in case.items())
                    + f": max |err| {err:.3e} (tol {FLASH_TOL[dname]}), "
                    f"{ms:.4f} ms, SDPA {lib:.4f} ms ({ms / lib:.3f}x), "
                    f"{bound / ms:.1%} of its {bound:.4f} ms bound")
                del q, k, v, got, want
                torch.cuda.empty_cache()

        at_case = _fcase(*FLASH_TIMED[arch])
        for dname, dtype, peak in (("bfloat16", torch.bfloat16,
                                    PEAK_BF16_FLOPS_PER_S),
                                   ("float32", torch.float32,
                                    PEAK_F32_OPS_PER_S)):
            q, k, v = inputs(heads, at_case, dtype)
            plain_ms = device_ms(torch, lambda: flash_attention_gqa_ref(
                q, k, v, **_fkw(at_case)), iters=3)
            at = next(x for x in by_shape if x["dtype"] == dname
                      and all(x[key] == val for key, val in at_case.items()))
            flops, nbytes = flops_bytes(heads, at_case, dtype)
            t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES_PER_S
            rows[(arch, dname)] = {
                "max_abs_err": errs[dname], "ms": at["ms"],
                "plain_ms": plain_ms,
                "bound_ms": 1e3 * max(t_ops, t_bytes),
                "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                "library_ms": at["library_ms"],
                "timed_at": {**at_case, "H": heads[0], "Hkv": heads[1],
                             "hd": heads[2], "dtype": dname},
                "gflop": flops / 1e9, "mbytes": nbytes / 1e6}
            del q, k, v
            torch.cuda.empty_cache()
        rows[(arch, "ms_by_shape")] = by_shape
    row = {**rows[(LM_ARCH, "bfloat16")], "f32": rows[(LM_ARCH, "float32")],
           "ms_by_shape": rows[(LM_ARCH, "ms_by_shape")],
           "f32_edges": flash_f32_edges(torch, gen)}
    for key, arch in FLASH_ROW_KEYS.items():
        row[key] = {"arch": arch, **rows[(arch, "bfloat16")],
                    "f32": rows[(arch, "float32")],
                    "ms_by_shape": rows[(arch, "ms_by_shape")]}
    log("kernel flash_attention: " + json.dumps(row))
    return row


def _tree_leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _tree_leaves(v)
        else:
            yield v


def _prefill_launches(T: int, cfg) -> int:
    """Flash launches of one prefill of ``T`` positions (a vlm's image
    included): one per attention layer and chunk (the dense, moe and vlm
    families chunk; the ssm has no attention), and for encdec one per
    encoder layer and two per decoder layer (self and cross)."""
    from repro_torch.models.factory import build_model
    from repro_torch.models.transformer import (CHUNKED_FAMILIES,
                                                PREFILL_CHUNK)
    if cfg.family == "encdec":
        return (cfg.n_enc_layers or cfg.n_layers) + 2 * cfg.n_layers
    chunked = (cfg.family in CHUNKED_FAMILIES and T > PREFILL_CHUNK
               and T % PREFILL_CHUNK == 0)
    return build_model(cfg).n_attn_layers() * (
        T // PREFILL_CHUNK if chunked else 1)


def _state_bytes(torch, spec) -> int:
    """Bytes of a decode state from its tree of ``(shape, dtype)`` specs."""
    if spec is None:
        return 0
    if isinstance(spec[1], torch.dtype):
        return int(np.prod(spec[0])) * torch.tensor(
            [], dtype=spec[1]).element_size()
    return sum(_state_bytes(torch, part) for part in spec)


def lm_extras(cfg, rng):
    """A request's extra inputs, seeded: a vlm's image embeddings and an
    encdec's frames (``0.1 * N(0, 1)``, the stub frontends' outputs), or
    None."""
    from repro_torch.models.encdec import N_FRAMES
    n = {"vlm": cfg.num_image_tokens, "encdec": N_FRAMES}.get(cfg.family)
    if n is None:
        return None
    key = "image_embeds" if cfg.family == "vlm" else "frames"
    return {key: (0.1 * rng.normal(size=(n, cfg.d_model))).astype(
        np.float32)}


def lm_batch(torch, prompt, extras, device) -> dict:
    """A batch-1 prefill batch of ``prompt`` and its extras on ``device``,
    as ``ContinuousBatcher`` builds it."""
    batch = {"tokens": torch.as_tensor(prompt[None].astype(np.int64),
                                       device=device)}
    for k, v in (extras or {}).items():
        batch[k] = torch.as_tensor(v[None], device=device)
    return batch


def _positions(cfg, T: int) -> int:
    """Positions of a prefill of ``T`` tokens (a vlm's image included)."""
    return T + (cfg.num_image_tokens if cfg.family == "vlm" else 0)


def phase_lm(torch, counters, arch: str = LM_ARCH) -> dict:
    """Phase 7 (starcoder2-7b), 7b (the recurrent families), 7c (moe) and
    7d (vlm, encdec): one LM serving path at full width and depth, then its
    checks.  The prompts and the cache length are :data:`LM_SPECS`'s for
    the arch, else :data:`LM_PROMPTS` and :data:`LM_MAX_LEN`."""
    from repro_torch.configs.base import get_config
    from repro_torch.models.factory import build_model
    from repro_torch.serve.engine import (ContinuousBatcher, Request,
                                          make_prefill_step)

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_config(arch)
    lengths, max_len = LM_SPECS.get(arch, (LM_PROMPTS, LM_MAX_LEN))
    model = build_model(cfg)
    t = time.perf_counter()
    params = model.init(torch.Generator(device=dev).manual_seed(0), dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t
    leaves = list(_tree_leaves(params))
    state_bytes = _state_bytes(torch, model.decode_state_specs(LM_BATCH,
                                                               max_len))
    info = {"arch": cfg.name, "family": cfg.family,
            "n_layers": cfg.n_layers, "d_model": cfg.d_model,
            "num_params": cfg.num_params(),
            "param_elements": sum(x.numel() for x in leaves),
            "weight_bytes": sum(x.numel() * x.element_size() for x in leaves),
            "decode_state_bytes": state_bytes, "batch": LM_BATCH,
            "max_len": max_len, "max_new_tokens": LM_NEW,
            "init_s": init_s}
    log("lm config: " + json.dumps(info))

    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, T).astype(np.int32)
               for T in lengths]
    extras = [lm_extras(cfg, rng) for _ in lengths]
    step = make_prefill_step(model, max_len=max_len)
    prefills, t_run = [], [0.0]

    def timed_prefill(p, batch):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = step(p, batch)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        T = int(batch["tokens"].shape[1])
        prefills.append({"arch": cfg.name, "tokens": T,
                         "positions": _positions(cfg, T),
                         "prefill_s": t1 - t0, "ttft_s": t1 - t_run[0]})
        return out

    batcher = ContinuousBatcher(model, params, LM_BATCH, max_len,
                                device=dev, prefill_fn=timed_prefill)
    for rid, (p, ex) in enumerate(zip(prompts, extras)):
        batcher.submit(Request(rid=rid, prompt=p, max_new_tokens=LM_NEW,
                               extras=ex))
    torch.cuda.reset_peak_memory_stats()
    counters.reset()
    torch.cuda.synchronize()
    t_run[0] = time.perf_counter()
    out = batcher.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_run[0]
    counts = counters.read()

    # the path went through the kernel: one launch per attention layer and
    # chunk (none for the ssm), and no other kernel of the port
    want = sum(_prefill_launches(_positions(cfg, T), cfg) for T in lengths)
    if counts["flash_attention"] != want:
        raise AssertionError(f"lm {arch}: {counts['flash_attention']} flash "
                             f"launches, want {want}")
    others = {k: c for k, c in counts.items() if k != "flash_attention" and c}
    if others:
        raise AssertionError(f"lm {arch} launched graph kernels {others}")
    # d. completion: every request generated exactly LM_NEW in-vocab tokens
    for rid in range(len(prompts)):
        toks = out[rid]
        if len(toks) != LM_NEW or not all(0 <= x < cfg.vocab for x in toks):
            raise AssertionError(f"lm {arch} request {rid}: {len(toks)} "
                                 f"tokens {toks[:8]}...")
    prefill_s = sum(p["prefill_s"] for p in prefills)
    decode_tokens = batcher.tokens_out - len(prompts)
    for p in prefills:
        p["prefill_tok_per_s"] = p["positions"] / p["prefill_s"]
        log("lm prefill: " + json.dumps(p))
    run = {"arch": cfg.name, "requests": len(prompts),
           "tokens_out": batcher.tokens_out,
           "decode_steps": batcher.steps, "decode_tokens": decode_tokens,
           "prefill_s": prefill_s, "decode_s": wall - prefill_s,
           "decode_tok_per_s": decode_tokens / (wall - prefill_s),
           "prefill_tok_per_s": sum(_positions(cfg, T)
                                    for T in lengths) / prefill_s,
           "wall_s": wall, "launches": counts,
           "peak_mem_bytes": torch.cuda.max_memory_allocated()}
    log("lm run: " + json.dumps(run))

    decode = lm_decode_profile(torch, model, params, batcher.state)
    batches = [lm_batch(torch, p, ex, dev) for p, ex in zip(prompts, extras)]
    # the share of (token, choice) entries each prefill drops past its
    # experts' capacity, layer by layer (moe)
    drops = (lm_moe_drops(torch, model, params, batches, max_len)
             if cfg.family == "moe" else None)
    # b. the whole model with the kernel against the whole model with the
    # plain attention on the card, on the prefills of CHECK_B_TOKENS
    check_b = [lm_kernel_vs_plain(torch, model, params, batches[i],
                                  out[i][0], max_len)
               for i in sorted({lengths.index(T)
                                for T in CHECK_B_TOKENS[arch]})]
    # the flash kernel's share of each prefill and the prefill's top
    # kernels (traced, after the counts); the ssm, which launches no
    # kernel of the port, only at TRACE_SSM_TOKENS
    shares = lm_flash_share(torch, model, params, [
        b for b, p in zip(batches, prompts)
        if want or len(p) in TRACE_SSM_TOKENS], cfg, max_len)
    del batches
    del batcher
    del params
    torch.cuda.empty_cache()
    # what phase 7e holds the mesh to
    mesh_ref = lm_mesh_reference(torch) if arch == LM_ARCH else None
    # c. the reduced config on the card against the CPU
    check_c = lm_card_vs_cpu(torch, arch)
    return {"info": info, "prefills": prefills, "run": run,
            "launches": counts["flash_attention"], "decode": decode,
            "check_b": check_b, "drops": drops,
            "check_c": check_c, "flash_share": shares, "mesh_ref": mesh_ref}


def phase_lm_recurrent(torch, counters) -> dict:
    """Phase 7b: the hybrid (recurrentgemma-2b) and ssm (falcon-mamba-7b)
    serving paths at full width and depth, one after the other, each then
    once more through ``launch/serve.py --no-reduced`` (the CLI's own
    weights and prompts; its default cache covers the hybrid's window).
    Then the one-card runs of RECURRENT_MESH_LAYERS of their layers that
    phase 7g holds the mesh to (``"mesh_ref"``)."""
    from repro_torch.launch import serve

    out = {}
    for arch in LM_RECURRENT:
        out[arch] = phase_lm(torch, counters, arch)
        t = time.perf_counter()
        got = serve.main(["--arch", arch, "--no-reduced", "--requests", "4",
                          "--batch", "2", "--max-new", "4"])
        torch.cuda.empty_cache()
        if sorted(got) != [0, 1, 2, 3] or any(len(x) != 4
                                              for x in got.values()):
            raise AssertionError(f"lm cli {arch}: {got}")
        log(f"lm cli: {arch} --no-reduced, 4 requests served in "
            f"{time.perf_counter() - t:.2f} s")
    out["mesh_ref"] = recurrent_mesh_reference(torch)
    return out


def phase_lm_moe(torch, counters) -> dict:
    """Phase 7c: qwen3-moe-30b-a3b at full width and depth (after 7b has
    freed its models), then once more through ``launch/serve.py
    --no-reduced``; check c also on phi3.5-moe's reduced config.  Then
    the one-card run of MOE_MESH_LAYERS of its layers that phase 7f holds
    the mesh to (``"mesh_ref"``)."""
    from repro_torch.launch import serve

    out = phase_lm(torch, counters, MOE_ARCH)
    out["check_c_reduced_only"] = lm_card_vs_cpu(torch, MOE_REDUCED_ONLY)
    out["mesh_ref"] = moe_mesh_reference(torch)
    t = time.perf_counter()
    got = serve.main(["--arch", MOE_ARCH, "--no-reduced", "--requests", "4",
                      "--batch", "2", "--max-new", "4"])
    torch.cuda.empty_cache()
    if sorted(got) != [0, 1, 2, 3] or any(len(x) != 4 for x in got.values()):
        raise AssertionError(f"lm cli {MOE_ARCH}: {got}")
    log(f"lm cli: {MOE_ARCH} --no-reduced, 4 requests served in "
        f"{time.perf_counter() - t:.2f} s")
    return out


def phase_lm_vlm_encdec(torch, counters) -> dict:
    """Phase 7d: paligemma-3b (vlm) and whisper-base (encdec) at full width
    and depth, one after the other (after 7c has freed its model), each
    then once more through ``launch/serve.py --no-reduced``."""
    from repro_torch.launch import serve

    out = {}
    for arch in (VLM_ARCH, ENCDEC_ARCH):
        out[arch] = phase_lm(torch, counters, arch)
        t = time.perf_counter()
        got = serve.main(["--arch", arch, "--no-reduced", "--requests", "4",
                          "--batch", "2", "--max-new", "4"])
        torch.cuda.empty_cache()
        if sorted(got) != [0, 1, 2, 3] or any(len(x) != 4
                                              for x in got.values()):
            raise AssertionError(f"lm cli {arch}: {got}")
        log(f"lm cli: {arch} --no-reduced, 4 requests served in "
            f"{time.perf_counter() - t:.2f} s")
    return out


def lm_moe_drops(torch, model, params, batches, max_len) -> list:
    """Each prompt's prefill once more, its routing recorded: the share of
    (token, choice) entries dropped past capacity, over the whole prefill,
    in its worst layer and in its first and last (a chunked prompt: of the
    last chunk)."""
    from repro_torch.launch.distributed import RouteLog

    rows = []
    for batch in batches:
        with RouteLog() as rl:
            model.prefill(params, batch, max_len=max_len)
        shares = rl.dropped()
        rows.append({"tokens": int(batch["tokens"].shape[1]),
                     "calls": len(shares),
                     "dropped_share": sum(shares) / len(shares),
                     "dropped_share_worst_layer": max(shares),
                     "dropped_share_first_layer": shares[0],
                     "dropped_share_last_layer": shares[-1]})
        log("lm moe drops: " + json.dumps(rows[-1]))
    return rows


def lm_decode_profile(torch, model, params, state, steps: int = 4) -> dict:
    """Where a decode step's time goes: ``steps`` steps at batch 4 over the
    served state (all its ``max_len`` slots), each ending in a host read of
    the sampled tokens as in ``ContinuousBatcher``, timed on the host
    clock; then one more step under torch.profiler for the card's kernel
    time."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serve.engine import make_decode_step

    step = make_decode_step(model)
    tokens = torch.zeros((LM_BATCH, 1), dtype=torch.long, device="cuda")

    def one(state):
        nxt, _, state = step(params, tokens, state)
        tokens.copy_(torch.as_tensor(nxt.cpu().numpy().astype(np.int64)))
        return state

    state = one(state)                                       # warm-up
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(steps):
        state = one(state)
    wall_ms = 1e3 * (time.perf_counter() - t) / steps
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        state = one(state)
        torch.cuda.synchronize()
    rows = sorted(((getattr(e, "self_device_time_total", None)
                    or getattr(e, "self_cuda_time_total", 0.0), e.key,
                    e.count) for e in prof.key_averages()), reverse=True)
    dev_ms = sum(r[0] for r in rows) / 1e3
    res = {"arch": model.cfg.name, "wall_ms_per_step": wall_ms,
           "device_ms_per_step": dev_ms,
           "device_busy_share": dev_ms / wall_ms,
           "kernels_per_step": sum(n for us, _, n in rows if us > 0),
           "top_kernels_us": [[k[:60], round(us, 1), n]
                              for us, k, n in rows[:6]]}
    log("lm decode profile: " + json.dumps(res))
    return res


def lm_kernel_vs_plain(torch, model, params, batch, first_token,
                       max_len) -> dict:
    """Check b: the prefill logits with the flash kernel and with its plain
    version in every layer (same weights, same prompt and extras)."""
    from repro_torch.kernels.flash_attention.ref import \
        flash_attention_gqa_ref
    from repro_torch.launch.distributed import RouteLog
    from repro_torch.models import attention

    tok = batch["tokens"]
    with RouteLog() as kernel_routes:
        kernel, _ = model.prefill(params, batch, max_len=max_len)
    kernel_attend = attention.attend

    def plain_attend(q, k, v, q_offset=0, *, causal=True, window=None,
                     kv_len=None, prefix_len=None):
        return flash_attention_gqa_ref(q, k, v, causal=causal, window=window,
                                       q_offset=q_offset, kv_len=kv_len,
                                       prefix_len=prefix_len)

    attention.attend = plain_attend
    try:
        with RouteLog() as plain_routes:
            plain, _ = model.prefill(params, batch, max_len=max_len)
    finally:
        attention.attend = kernel_attend
    torch.cuda.synchronize()
    # the true vocab's columns: the padded ones hold -1e9 on both sides
    V = model.cfg.vocab
    kernel, plain = kernel[:, :V], plain[:, :V]
    diff = float((kernel - plain).abs().max())
    scale = float(plain.abs().max())
    res = {"arch": model.cfg.name, "tokens": int(tok.shape[1]),
           "max_abs_diff": diff,
           "max_abs_logit": scale, "rel": diff / scale,
           "tol_rel": LM_LOGIT_RTOL,
           "argmax_kernel": int(kernel.argmax(-1)[0]),
           "argmax_plain": int(plain.argmax(-1)[0]),
           "served_first_token": int(first_token)}
    if kernel_routes.calls:
        res["routing"] = kernel_routes.agreement(plain_routes)
    log(f"lm check b (kernel vs plain attention, {res['tokens']}-token "
        f"prefill): " + json.dumps(res))
    if diff > LM_LOGIT_RTOL * scale:
        raise AssertionError("lm: kernel and plain-attention logits differ "
                             "beyond the tolerance")
    if not (res["argmax_kernel"] == res["argmax_plain"]
            == res["served_first_token"]):
        raise AssertionError("lm: kernel and plain attention pick different "
                             "first tokens")
    return res


#: the flash kernels' names in a profiler trace: the tensor-core kernel
#: (bf16, the LM path's) and the FP32-core one (float32 only)
FLASH_TC_NAME, FLASH_FP32_NAME = "flash_tc_kernel", "flash_fp32_kernel"


def lm_flash_share(torch, model, params, batches, cfg, max_len) -> list:
    """Each prompt's prefill once more under torch.profiler: the flash
    kernel's card time against the prefill's card time and wall time.
    Every attention launch of the bf16 path must be the tensor-core kernel,
    one per attention layer and chunk (:func:`_prefill_launches`), and the
    FP32-core kernel must not appear."""
    rows = []
    for batch in batches:
        T = int(batch["tokens"].shape[1])
        torch.cuda.synchronize()
        want = _prefill_launches(_positions(cfg, T), cfg)

        def prefill():
            return model.prefill(params, batch, max_len=max_len)

        for attempt in range(1, TRACE_TRIES + 1):
            events, wall_ms, _ = trace_once(torch, prefill, prefill)
            flash_us = dev_us = 0.0
            n_tc = n_fp32 = 0
            for e in events:
                us = _device_us(e)
                dev_us += us
                if FLASH_TC_NAME in e.key:
                    flash_us += us
                    n_tc += e.count
                n_fp32 += e.count if FLASH_FP32_NAME in e.key else 0
            if n_tc == want and not n_fp32:
                break
            if n_fp32 or n_tc > want or attempt == TRACE_TRIES:
                raise AssertionError(f"lm: the {T}-token prefill ran "
                                     f"{n_tc} {FLASH_TC_NAME} (want {want}) "
                                     f"and {n_fp32} {FLASH_FP32_NAME} (want "
                                     f"0)")
            log(f"lm prefill trace: {T} tokens, trace {attempt} holds "
                f"{n_tc} of {want} {FLASH_TC_NAME} events (the tracer "
                f"dropped some); tracing again")
        top = sorted(((_device_us(e), e.key, e.count) for e in events),
                     reverse=True)[:5]
        row = {"arch": cfg.name, "tokens": T, "wall_ms": wall_ms,
               "device_ms": dev_us / 1e3, "flash_ms": flash_us / 1e3,
               "flash_tc_launches": n_tc,
               "flash_share_of_device": flash_us / dev_us if dev_us else None,
               "flash_share_of_wall": flash_us / 1e3 / wall_ms,
               "top_kernels_us": [[k[:60], round(us, 1), n]
                                  for us, k, n in top]}
        log("lm prefill trace: " + json.dumps(row))
        rows.append(row)
    return rows


def lm_mesh_reference(torch, layers=None) -> dict:
    """Phase 7e's one-card results: starcoder2-7b at full width cut to
    ``layers`` (default MESH_LAYERS) layers, built from phase 7's seed: a
    prefill of a seeded MESH_B_BATCH and MESH_B_STEPS greedy decode steps
    (the tokens fed and every step's logits; check b), the forward's
    logits of a seeded 1 x MESH_C_TOKENS row at every MESH_C_STRIDE-th
    position (check c), and phase 7's MESH_PROMPTS served with MESH_NEW
    tokens each (check a's report); the model is freed after."""
    import dataclasses

    from repro_torch.configs.base import get_config
    from repro_torch.models.factory import build_model
    from repro_torch.serve.engine import ContinuousBatcher, Request

    dev = torch.device("cuda")
    cfg = dataclasses.replace(get_config(LM_ARCH),
                              n_layers=layers or MESH_LAYERS)
    model = build_model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(0), dev)
    rng = np.random.default_rng(11)
    tokens = rng.integers(0, cfg.vocab, MESH_B_BATCH)
    ref = one_card_teacher(torch, model, params, tokens)
    ref["tokens"], ref["layers"] = tokens, cfg.n_layers
    ref["c_tokens"] = rng.integers(0, cfg.vocab, (1, MESH_C_TOKENS))
    logits, _ = model.logits(params, {"tokens": torch.as_tensor(
        ref["c_tokens"], device=dev)}, remat=False)
    ref["c_logits"] = logits[:, ::MESH_C_STRIDE].cpu().numpy()
    del logits
    batcher = ContinuousBatcher(model, params, LM_BATCH, LM_MAX_LEN,
                                device=dev)
    for rid, p in enumerate(mesh_prompts()):
        batcher.submit(Request(rid=rid, prompt=p, max_new_tokens=MESH_NEW))
    ref["served"] = batcher.run()
    del params, batcher
    torch.cuda.empty_cache()
    return ref


def mesh_prompts() -> list:
    """Phase 7's prompts of MESH_PROMPTS' lengths (its seeded draws)."""
    from repro_torch.configs.base import get_config
    rng = np.random.default_rng(0)
    by_len = {T: rng.integers(0, get_config(LM_ARCH).vocab, T).astype(
        np.int32) for T in LM_PROMPTS}
    return [by_len[T] for T in MESH_PROMPTS]


def _logit_diff(got, want, vocab, rtol=MESH_LOGIT_RTOL) -> dict:
    """The largest difference of two logit arrays over the true vocab, its
    share of the largest logit, and whether it is within ``rtol`` of it
    (None: not gated)."""
    got, want = got[..., :vocab], want[..., :vocab]
    diff = float(np.abs(got - want).max())
    scale = float(np.abs(want).max())
    return {"max_abs_diff": diff, "max_abs_logit": scale,
            "rel": diff / scale,
            "ok": None if rtol is None else diff <= rtol * scale}


def phase_lm_mesh(torch, ref, card, train_cases=(), moe_cases=(),
                  rec_cases=()) -> dict:
    """Phase 7e: starcoder2-7b at full width, cut to the depth of ``ref``
    (:func:`lm_mesh_reference`: MESH_LAYERS), on MESH, four gloo ranks
    sharing the card (``launch/mesh.spawn``,
    ``launch/distributed.run_lm_cases``), from phase 7's seed (each rank
    builds the model whole in turn and keeps its shards) with
    ``rules_for(cfg, mesh)``: phase 7's MESH_PROMPTS through
    ``ContinuousBatcher(mesh=, rules=)`` at batch LM_BATCH and
    ``max_len`` LM_MAX_LEN.  Checks: a. every rank the same tokens (the
    ones equal to one card's are reported); b. a teacher-forced prefill
    and MESH_B_STEPS decode steps against one card's logits of the same
    cut model; c. ``Model.logits`` with ``manual_tp`` against one card's
    forward; d. the reduced config in
    float32 on the same four ranks against the port unsharded on the CPU;
    e. B6 launched once an attention layer and chunk on every rank, and no
    graph kernel.  The walls are four processes on one card: they measure
    the exchange's overhead, not scaling.  The same world then runs phase
    7f's ``moe_cases``, 7g's ``rec_cases`` and 8e's ``train_cases``
    (``launch/distributed.run_mesh_cases``: the ranks start once); their
    per-rank results are returned under ``"moe_ranks"``, ``"rec_ranks"``
    and ``"train_ranks"`` for phases 7f, 7g and 8e to check."""
    import dataclasses

    from repro_torch.configs.base import get_config
    from repro_torch.launch import distributed as launcher
    from repro_torch.launch.mesh import spawn

    cfg = dataclasses.replace(get_config(LM_ARCH), n_layers=ref["layers"])
    prompts = mesh_prompts()
    full = {"arch": LM_ARCH, "mesh": MESH, "seed": 0,
            "config": {"n_layers": cfg.n_layers},
            "teacher": {"tokens": ref["tokens"], "steps": ref["steps"],
                        "max_len": LM_MAX_LEN},
            "logits": {"tokens": ref["c_tokens"], "stride": MESH_C_STRIDE,
                       "overrides": {"manual_tp": True}},
            "serve": {"prompts": prompts, "batch": LM_BATCH,
                      "max_len": LM_MAX_LEN, "new": MESH_NEW}}
    # d. the reduced config in float32, on the ranks and on the CPU
    (reduced,), want_d = _mesh_reduced_cases(torch, LM_ARCH, (MESH,))
    t = time.perf_counter()
    both = spawn(launcher.run_mesh_cases, MESH_WORLD, "gloo",
                 args=([full, reduced] + list(moe_cases) + list(rec_cases),
                       list(train_cases), None), timeout_s=300)
    world_s = time.perf_counter() - t
    per_rank = [lm for lm, _ in both]
    fulls, reds = [r[0] for r in per_rank], [r[1] for r in per_rank]

    # a. every rank the same tokens; those equal to phase 7's, reported
    toks = [r["serve"]["tokens"] for r in fulls]
    if any(x != toks[0] for x in toks[1:]):
        raise AssertionError("lm mesh: the ranks served different tokens")
    for rid, p in enumerate(prompts):
        if len(toks[0][rid]) != MESH_NEW or not all(
                0 <= x < cfg.vocab for x in toks[0][rid]):
            raise AssertionError(f"lm mesh request {rid}: {toks[0][rid][:8]}")
    same = sum(a == b for rid in range(len(prompts))
               for a, b in zip(toks[0][rid], ref["served"][rid]))
    # b and c against phase 7's one card, every rank the same bits
    for part, keys in (("teacher", ("prefill", "decode")), ("logits", ())):
        for r in fulls[1:]:
            for k in keys or (None,):
                a = r[part] if k is None else r[part][k]
                b = fulls[0][part] if k is None else fulls[0][part][k]
                if not np.array_equal(a, b):
                    raise AssertionError(f"lm mesh: the ranks' {part} "
                                         f"{k or ''} differ")
    got = fulls[0]
    check_b = {"prefill": _logit_diff(got["teacher"]["prefill"],
                                      ref["prefill"], cfg.vocab),
               "decode": _logit_diff(got["teacher"]["decode"],
                                     ref["decode"], cfg.vocab),
               "greedy_equal": int((got["teacher"]["decode"][..., :cfg.vocab]
                                    .argmax(-1)[:-1]
                                    == ref["steps"][1:]).sum()),
               "greedy_of": int(ref["steps"][1:].size),
               "tol_rel": MESH_LOGIT_RTOL}
    check_c = {**_logit_diff(got["logits"], ref["c_logits"], cfg.vocab),
               "rows": int(got["logits"].shape[1]), "tol_rel": MESH_LOGIT_RTOL}
    # d. the reduced config: the ranks against the port on the CPU
    rgot = [reds[0]["teacher"]["prefill"]] + list(reds[0]["teacher"]["decode"])
    want = want_d["logits"]
    d_err = max(float(np.abs(g - w).max()) for g, w in zip(rgot, want))
    check_d = {"max_abs_diff": d_err, "tol": LM_F32_TOL,
               "tokens_equal": all(r["serve"]["tokens"] == want_d["tokens"]
                                   for r in reds)}
    for g, w in zip(rgot, want):
        np.testing.assert_allclose(g, w, **LM_F32_TOL)
    # e. B6 once an attention layer and chunk on every rank, no graph kernel
    served = sum(_prefill_launches(T, cfg) for T in MESH_PROMPTS)
    before = (_prefill_launches(MESH_B_BATCH[1], cfg)
              + _prefill_launches(MESH_C_TOKENS, cfg))
    for r in fulls:
        for counts, want_n in ((r["serve"]["launches"], served),
                               (r["launches"], before)):
            others = {k: c for k, c in counts.items()
                      if k != "flash_attention" and c}
            if counts["flash_attention"] != want_n or others:
                raise AssertionError(f"lm mesh: a rank launched {counts}, "
                                     f"want {want_n} flash and nothing else")
    ranks = [{"rank": i, "params_s": r["params_s"],
              "wall_s": r["serve"]["wall_s"],
              "prefill_s": sum(r["serve"]["prefill_s"]),
              "decode_s": r["serve"]["decode_s"],
              "decode_steps": r["serve"]["decode_steps"],
              "decode_tok_per_s": r["serve"]["decode_tok_per_s"],
              "collectives_per_decode_step":
                  r["serve"]["collectives_per_decode_step"],
              "collectives": r["serve"]["collectives"],
              "b6_launches": r["serve"]["launches"]["flash_attention"],
              "peak_mem_bytes": r["peak_mem_bytes"],
              "decode_step_peak_bytes": r["serve"]["decode_step_peak_bytes"],
              "case_wall_s": r["wall_s"]} for i, r in enumerate(fulls)]
    res = {"card": card, "arch": LM_ARCH, "layers": cfg.n_layers,
           "mesh": list(MESH), "backend": "gloo", "world_s": world_s,
           "prompts": list(MESH_PROMPTS), "new": MESH_NEW,
           "tokens_equal_to_one_card": same,
           "tokens": sum(len(x) for x in toks[0].values()),
           "check_b": check_b, "check_c": check_c, "check_d": check_d,
           "ranks": ranks}
    log("lm mesh run: " + json.dumps(res))
    if not (check_b["prefill"]["ok"] and check_b["decode"]["ok"]
            and check_c["ok"]):
        raise AssertionError("lm mesh: the mesh's logits are off the one "
                             "card's beyond the tolerance")
    if not check_d["tokens_equal"]:
        raise AssertionError("lm mesh: the reduced config's tokens differ "
                             "from the CPU's")
    n_moe = len(moe_cases)
    return {"launches": sum(r["b6_launches"] for r in ranks),
            "moe_ranks": [r[2:2 + n_moe] for r in per_rank],
            "rec_ranks": [r[2 + n_moe:] for r in per_rank],
            "train_ranks": [tr for _, tr in both], **res}


def one_card_teacher(torch, model, params, tokens, steps=None,
                     n: int = MESH_B_STEPS) -> dict:
    """A prefill of ``tokens`` at LM_MAX_LEN on the params' device and
    ``n`` decode steps, greedy or fed ``steps``: the tokens fed and the
    prefill's and every step's float32 logits, as numpy."""
    dev = params["embed"]["embedding"].device
    logits, state = model.prefill(params, {"tokens": torch.as_tensor(
        tokens, device=dev)}, max_len=LM_MAX_LEN)
    out = {"prefill": logits.float().cpu().numpy(), "steps": [],
           "decode": []}
    for j in range(n):
        nxt = (torch.argmax(logits, dim=-1) if steps is None
               else torch.as_tensor(steps[j], device=dev))
        out["steps"].append(nxt.cpu().numpy())
        logits, state = model.decode(params, nxt[:, None], state)
        out["decode"].append(logits.float().cpu().numpy())
    out["steps"], out["decode"] = (np.stack(out[k])
                                   for k in ("steps", "decode"))
    return out


def moe_mesh_reference(torch, layers: int = MOE_MESH_LAYERS) -> dict:
    """Phase 7f's one-card results: qwen3-moe-30b-a3b at full width cut to
    ``layers`` layers in bf16 and MOE_MESH_LAYERS in float32 (the float32
    model is twice the bytes: at a deeper cut its whole copy and the
    other ranks' shards would not fit the shared card), built from the
    seed the ranks build it from, in each compute dtype of
    MOE_MESH_DTYPES: a prefill of a seeded
    MESH_B_BATCH and MOE_MESH_B_STEPS greedy decode steps (the tokens fed,
    every step's logits, the prefill's picks: check b) and, in float32,
    the forward's logits of a seeded 1 x MESH_C_TOKENS row at every
    MESH_C_STRIDE-th position (check c) and the control of check b's
    float32 gate: the same teacher-forced run with every moe layer's
    combine computed in bf16, its distance from the clean run; as numpy;
    each model is freed after."""
    import dataclasses

    from repro_torch.configs.base import get_config
    from repro_torch.launch.distributed import RouteLog
    from repro_torch.models import moe as moe_lib
    from repro_torch.models.factory import build_model

    def teacher(model, params, tokens, steps=None):
        return one_card_teacher(torch, model, params, tokens, steps,
                                MOE_MESH_B_STEPS)

    dev = torch.device("cuda")
    rng = np.random.default_rng(12)
    vocab = get_config(MOE_ARCH).vocab
    ref = {"tokens": rng.integers(0, vocab, MESH_B_BATCH),
           "c_tokens": rng.integers(0, vocab, (1, MESH_C_TOKENS))}
    for dtype in MOE_MESH_DTYPES:
        cfg = dataclasses.replace(
            get_config(MOE_ARCH), compute_dtype=dtype,
            n_layers=layers if dtype == "bfloat16" else MOE_MESH_LAYERS)
        model = build_model(cfg)
        params = model.init(torch.Generator(device=dev).manual_seed(0), dev)
        with RouteLog() as routes:
            out = teacher(model, params, ref["tokens"])
        out.update(layers=cfg.n_layers,     # the prefill's picks
                   picks=routes.summary(picks=True)["picks"][:cfg.n_layers])
        if dtype == "float32":
            logits, _ = model.logits(params, {"tokens": torch.as_tensor(
                ref["c_tokens"], device=dev)}, remat=False)
            out["c_logits"] = logits[:, ::MESH_C_STRIDE].cpu().numpy()
            del logits
            clean = moe_lib._combine
            moe_lib._combine = lambda c: clean(c.bfloat16()).to(c.dtype)
            try:
                bad = teacher(model, params, ref["tokens"], out["steps"])
            finally:
                moe_lib._combine = clean
            out["control"] = {
                k: _logit_diff(bad[k], out[k], cfg.vocab, MOE_MESH_F32_RTOL)
                for k in ("prefill", "decode")}
        ref[dtype] = out
        del params
        torch.cuda.empty_cache()
    return ref


def moe_mesh_cases(torch, ref, prompts=MOE_MESH_PROMPTS,
                   new=MOE_MESH_NEW) -> tuple:
    """Phase 7f's cases for the world phase 7e spawns: qwen3-moe-30b-a3b at
    full width cut as :func:`moe_mesh_reference` cut it, on MESH, its routing
    recorded, in bf16 (the teacher case of :func:`moe_mesh_reference`,
    phase 7c's ``prompts`` served with ``new`` tokens each) and in float32
    (the teacher case, the logits row), then the reduced moe configs in
    float32 at MOE_MESH_REDUCED_MESHES (check d).
    Returns (cases, what :func:`phase_lm_moe_mesh` holds them to)."""
    from repro_torch.configs.base import get_config

    cfg = get_config(MOE_ARCH)
    rng = np.random.default_rng(0)        # phase 7c's prompts
    by_len = {T: rng.integers(0, cfg.vocab, T).astype(np.int32)
              for T in LM_PROMPTS}
    cases = []
    for dtype in MOE_MESH_DTYPES:
        case = {"arch": MOE_ARCH, "mesh": MESH, "seed": 0,
                "config": {"n_layers": ref[dtype]["layers"],
                           "compute_dtype": dtype}, "routing": "picks",
                "teacher": {"tokens": ref["tokens"],
                            "steps": ref[dtype]["steps"],
                            "max_len": LM_MAX_LEN}}
        if dtype == "float32":
            case["logits"] = {"tokens": ref["c_tokens"],
                              "stride": MESH_C_STRIDE}
        else:                                  # the served path
            case["serve"] = {"prompts": [by_len[T] for T in prompts],
                             "batch": LM_BATCH, "max_len": LM_MAX_LEN,
                             "new": new}
        cases.append(case)
    reduced = {}
    for arch in MOE_MESH_REDUCED:
        cases_of, ctx = _mesh_reduced_cases(torch, arch,
                                            MOE_MESH_REDUCED_MESHES)
        cases += cases_of
        reduced[arch] = ctx
    return cases, {"ref": ref, "prompts": list(prompts), "new": new,
                   "reduced": reduced}


def _mesh_reduced_cases(torch, arch, meshes) -> tuple:
    """Check d's cases: ``arch``'s reduced config in float32 from weights
    seeded 1, a teacher-forced prefill and 4 decode steps and three
    prompts served, at each of ``meshes``; and the same on the CPU."""
    import dataclasses

    from repro_torch.configs.base import get_config
    from repro_torch.convert import lm_params_from_arrays
    from repro_torch.models.factory import build_model
    from repro_torch.serve.engine import ContinuousBatcher, Request

    rcfg = dataclasses.replace(get_config(arch).reduced(),
                               compute_dtype="float32")
    rmodel = build_model(rcfg)
    cpu = rmodel.init(torch.Generator().manual_seed(1), "cpu")

    def arrays(tree):
        return {k: arrays(v) if isinstance(v, dict) else v.float().numpy()
                for k, v in tree.items()}

    rrng = np.random.default_rng(1)
    teacher = {"tokens": rrng.integers(0, rcfg.vocab, (2, 24)),
               "steps": rrng.integers(0, rcfg.vocab, (4, 2)), "max_len": 32}
    serve = {"prompts": [rrng.integers(0, rcfg.vocab, T).astype(np.int32)
                         for T in (40, 100, 64)],
             "batch": 2, "max_len": 128, "new": 8}
    tree = arrays(cpu)
    cases = [{"arch": arch, "reduced": True, "mesh": m,
              "routing": rcfg.family == "moe",
              "config": {"compute_dtype": "float32"}, "arrays": tree,
              "teacher": teacher, "serve": serve} for m in meshes]
    cpu_p = lm_params_from_arrays(tree, rcfg, "cpu")
    lg, st = rmodel.prefill(cpu_p, {"tokens": torch.as_tensor(
        teacher["tokens"])}, max_len=teacher["max_len"])
    want = [lg.numpy()]
    for row in teacher["steps"]:
        lg, st = rmodel.decode(cpu_p, torch.as_tensor(row[:, None]), st)
        want.append(lg.numpy())
    b = ContinuousBatcher(rmodel, cpu_p, serve["batch"], serve["max_len"],
                          device="cpu")
    for rid, p in enumerate(serve["prompts"]):
        b.submit(Request(rid=rid, prompt=p, max_new_tokens=serve["new"]))
    return cases, {"meshes": [list(m) for m in meshes], "logits": want,
                   "tokens": b.run()}


def _routing_key(r: dict) -> tuple:
    """A rank's routing summary without its picks."""
    return tuple(sorted((k, v) for k, v in r.items() if k != "picks"))


def phase_lm_moe_mesh(torch, ranks: list, ctx: dict, card: str) -> dict:
    """Phase 7f: qwen3-moe-30b-a3b on MESH (expert parallel over "model"),
    from the per-rank results of the world phase 7e shared
    (:func:`moe_mesh_cases`).  Checks: a. every rank the same tokens, the
    same routing (calls, entries dropped, the picks' sha1) and the same
    logits; b. the teacher-forced prefill and MOE_MESH_B_STEPS decode
    steps against one card's run of the same cut model
    (:func:`moe_mesh_reference`) with the routing agreement of their
    prefills, as 7c's check b: in float32 within MOE_MESH_F32_RTOL of the
    largest logit, which the control (one card's combine in bf16) must
    exceed; in bf16 the picks and the greedy tokens at least
    MOE_MESH_BF16_PICKS and MOE_MESH_BF16_GREEDY of one card's (see
    MOE_MESH_DTYPES); c. ``Model.logits`` in float32 against one card's
    forward, within MOE_MESH_F32_RTOL; d. the reduced moe configs in
    float32 on the ranks at
    MOE_MESH_REDUCED_MESHES against the port on the CPU (LM_F32_TOL, the
    same tokens); e. B6 once an attention layer and chunk on every rank,
    no graph kernel.  One ``lm mesh run`` line (per rank of the served
    bf16 case: walls, prefill and decode seconds, decode tok/s,
    collectives a decode step, B6 launches, peak GB, the share of entries
    dropped)."""
    import dataclasses

    from repro_torch.configs.base import get_config
    from repro_torch.launch.distributed import RouteLog

    ref = ctx["ref"]
    cfgs = {d: dataclasses.replace(get_config(MOE_ARCH),
                                   n_layers=ref[d]["layers"])
            for d in MOE_MESH_DTYPES}
    cfg = cfgs["bfloat16"]
    n = len(MOE_MESH_DTYPES)
    by_dtype = {d: [r[i] for r in ranks]
                for i, d in enumerate(MOE_MESH_DTYPES)}
    served = by_dtype["bfloat16"]
    # a. every rank the same tokens, routing and logits
    toks = [r["serve"]["tokens"] for r in served]
    if any(x != toks[0] for x in toks[1:]):
        raise AssertionError("moe mesh: the ranks served different tokens")
    for rid in range(len(ctx["prompts"])):
        if len(toks[0][rid]) != ctx["new"] or not all(
                0 <= x < cfg.vocab for x in toks[0][rid]):
            raise AssertionError(f"moe mesh request {rid}: "
                                 f"{toks[0][rid][:8]}")
    for dtype, rs in by_dtype.items():
        if len({_routing_key(r["routing"]) for r in rs}) != 1:
            raise AssertionError(f"moe mesh {dtype}: the ranks routed "
                                 f"differently")
        for r in rs[1:]:
            for k in ("prefill", "decode"):
                if not np.array_equal(r["teacher"][k], rs[0]["teacher"][k]):
                    raise AssertionError(f"moe mesh {dtype}: the ranks' "
                                         f"teacher {k} differ")
            if "logits" in r and not np.array_equal(r["logits"],
                                                    rs[0]["logits"]):
                raise AssertionError(f"moe mesh {dtype}: the ranks' logits "
                                     f"differ")
    # b and c against one card's run of the cut model
    check_b = {}
    for dtype, rs in by_dtype.items():
        got, want = rs[0], ref[dtype]
        rtol = MOE_MESH_F32_RTOL if dtype == "float32" else None
        mesh_routes, card_routes = RouteLog(), RouteLog()
        mesh_routes.calls = [(torch.as_tensor(p).long(), None, None)
                             for p in got["routing"]["picks"][
                                 :want["layers"]]]
        card_routes.calls = [(torch.as_tensor(p).long(), None, None)
                             for p in want["picks"]]
        check_b[dtype] = {
            "prefill": _logit_diff(got["teacher"]["prefill"],
                                   want["prefill"], cfg.vocab, rtol),
            "decode": _logit_diff(got["teacher"]["decode"], want["decode"],
                                  cfg.vocab, rtol),
            "greedy_equal": int((got["teacher"]["decode"][..., :cfg.vocab]
                                 .argmax(-1)[:-1]
                                 == want["steps"][1:]).sum()),
            "greedy_of": int(want["steps"][1:].size),
            "routing": mesh_routes.agreement(card_routes),
            "dropped_share": got["routing"]["dropped_share"]}
    check_b["float32"].update(tol_rel=MOE_MESH_F32_RTOL,
                              control=ref["float32"]["control"])
    check_b["bfloat16"].update(min_picks_agree=MOE_MESH_BF16_PICKS,
                               min_greedy_share=MOE_MESH_BF16_GREEDY)
    got32 = by_dtype["float32"][0]
    check_c = {**_logit_diff(got32["logits"], ref["float32"]["c_logits"],
                             cfg.vocab, MOE_MESH_F32_RTOL),
               "rows": int(got32["logits"].shape[1]),
               "dtype": "float32", "tol_rel": MOE_MESH_F32_RTOL}
    # d. the reduced configs: the ranks against the port on the CPU
    check_d, i = {}, n
    for arch, want in ctx["reduced"].items():
        for m in want["meshes"]:
            reds = [r[i] for r in ranks]
            i += 1
            rgot = [reds[0]["teacher"]["prefill"]] + list(
                reds[0]["teacher"]["decode"])
            for g, w in zip(rgot, want["logits"]):
                np.testing.assert_allclose(g, w, **LM_F32_TOL)
            d = check_d[f"{arch} {m[0]}x{m[1]}"] = {
                "max_abs_diff": max(float(np.abs(g - w).max())
                                    for g, w in zip(rgot, want["logits"])),
                "tokens_equal": all(r["serve"]["tokens"] == want["tokens"]
                                    for r in reds),
                "ranks_routed_alike": len({_routing_key(r["routing"])
                                           for r in reds[:m[1]]}) == 1}
            if not (d["tokens_equal"] and d["ranks_routed_alike"]):
                raise AssertionError(f"moe mesh check d: {check_d}")
    # e. B6 once an attention layer and chunk on every rank, no graph kernel
    served_n = sum(_prefill_launches(T, cfg) for T in ctx["prompts"])
    teacher_n = _prefill_launches(MESH_B_BATCH[1], cfg)
    want_e = [(r["serve"]["launches"], served_n) for r in served] + [
        (r["launches"], teacher_n) for r in served] + [
        (r["launches"], sum(_prefill_launches(T, cfgs["float32"])
                            for T in (MESH_B_BATCH[1], MESH_C_TOKENS)))
        for r in by_dtype["float32"]]
    for counts, want_n in want_e:
        others = {k: c for k, c in counts.items()
                  if k != "flash_attention" and c}
        if counts["flash_attention"] != want_n or others:
            raise AssertionError(f"moe mesh: a rank launched {counts}, "
                                 f"want {want_n} flash and nothing else")
    lines = [{"rank": i, "params_s": r["params_s"],
              "wall_s": r["serve"]["wall_s"],
              "prefill_s": sum(r["serve"]["prefill_s"]),
              "decode_s": r["serve"]["decode_s"],
              "decode_steps": r["serve"]["decode_steps"],
              "decode_tok_per_s": r["serve"]["decode_tok_per_s"],
              "collectives_per_decode_step":
                  r["serve"]["collectives_per_decode_step"],
              "collectives": r["serve"]["collectives"],
              "b6_launches": r["serve"]["launches"]["flash_attention"],
              "peak_gb": (r["peak_mem_bytes"] or 0) / 1e9,
              "decode_step_peak_bytes": r["serve"]["decode_step_peak_bytes"],
              "dropped_share": r["routing"]["dropped_share"],
              "case_wall_s": r["wall_s"]} for i, r in enumerate(served)]
    res = {"card": card, "arch": MOE_ARCH, "layers": cfg.n_layers,
           "float32_layers": cfgs["float32"].n_layers,
           "mesh": list(MESH), "backend": "gloo",
           "experts_per_rank": cfg.moe.num_experts // MESH[1],
           "prompts": ctx["prompts"], "new": ctx["new"],
           "tokens": sum(len(x) for x in toks[0].values()),
           "check_b": check_b, "check_c": check_c, "check_d": check_d,
           "cases_wall_s": max(sum(x["wall_s"] for x in r) for r in ranks),
           "case_walls_s": [max(r[i]["wall_s"] for r in ranks)
                            for i in range(len(ranks[0]))],
           "float32_peak_gb": max((r["peak_mem_bytes"] or 0) / 1e9
                                  for r in by_dtype["float32"]),
           "ranks": lines}
    log("lm mesh run: " + json.dumps(res))
    f32, b16 = check_b["float32"], check_b["bfloat16"]
    if not (f32["prefill"]["ok"] and f32["decode"]["ok"] and check_c["ok"]):
        raise AssertionError("moe mesh: the mesh's float32 logits are off "
                             "the one card's beyond the tolerance")
    if any(c["ok"] for c in f32["control"].values()):
        raise AssertionError("moe mesh: a combine in bf16 passes the float32 "
                             f"gate: {f32['control']}")
    if (b16["routing"]["picks_agree"] < MOE_MESH_BF16_PICKS
            or b16["greedy_equal"] < MOE_MESH_BF16_GREEDY * b16["greedy_of"]):
        raise AssertionError("moe mesh: the bf16 mesh's routing or greedy "
                             "tokens are off one card's")
    return {"launches": sum(x["b6_launches"] for x in lines),
            "f32_launches": sum(r["launches"]["flash_attention"]
                                for r in by_dtype["float32"]), **res}


def recurrent_mesh_reference(torch, layers: int = RECURRENT_MESH_LAYERS,
                             archs=LM_RECURRENT) -> dict:
    """Phase 7g's one-card results, per arch of ``archs``: the model at
    full width cut to ``layers`` layers in bf16 and RECURRENT_MESH_LAYERS
    in float32, built from the seed the ranks build it from (phase 7b's),
    in each compute dtype of RECURRENT_MESH_DTYPES: a prefill of a seeded
    MESH_B_BATCH and MESH_B_STEPS greedy decode steps (check b) and, in
    float32, the forward's logits of a seeded 1 x RECURRENT_MESH_C_TOKENS
    row at every MESH_C_STRIDE-th position (check c); as numpy; each model
    is freed after."""
    import dataclasses

    from repro_torch.configs.base import get_config
    from repro_torch.models.factory import build_model

    dev = torch.device("cuda")
    out = {}
    for arch in archs:
        rng = np.random.default_rng(13)
        vocab = get_config(arch).vocab
        ref = out[arch] = {
            "tokens": rng.integers(0, vocab, MESH_B_BATCH),
            "c_tokens": rng.integers(0, vocab, (1, RECURRENT_MESH_C_TOKENS))}
        for dtype in RECURRENT_MESH_DTYPES:
            cfg = dataclasses.replace(
                get_config(arch), compute_dtype=dtype,
                n_layers=layers if dtype == "bfloat16"
                else RECURRENT_MESH_LAYERS)
            model = build_model(cfg)
            params = model.init(torch.Generator(device=dev).manual_seed(0),
                                dev)
            r = ref[dtype] = one_card_teacher(torch, model, params,
                                              ref["tokens"])
            r["layers"] = cfg.n_layers
            if dtype == "float32":
                logits, _ = model.logits(params, {"tokens": torch.as_tensor(
                    ref["c_tokens"], device=dev)}, remat=False)
                r["c_logits"] = logits[:, ::MESH_C_STRIDE].cpu().numpy()
                del logits
            del params
            torch.cuda.empty_cache()
    return out


def recurrent_mesh_cases(torch, ref, prompts=MESH_PROMPTS,
                         new=MESH_NEW, overrides=None) -> tuple:
    """Phase 7g's cases for the world phase 7e spawns, per arch of ``ref``
    (:func:`recurrent_mesh_reference`): the model at full width cut as the
    reference cut it, on MESH, in bf16 (the teacher case, phase 7b's
    ``prompts`` served with ``new`` tokens each) and in float32 (the
    teacher case, the logits row), under ``rules_for(..., overrides)``,
    then its reduced config in float32 at RECURRENT_MESH_REDUCED_MESHES
    (check d).  Returns (cases, what :func:`phase_lm_recurrent_mesh` holds
    them to)."""
    from repro_torch.configs.base import get_config

    cases, reduced = [], {}
    for arch, one in ref.items():
        rng = np.random.default_rng(0)        # phase 7b's prompts
        by_len = {T: rng.integers(0, get_config(arch).vocab, T).astype(
            np.int32) for T in LM_PROMPTS}
        for dtype in RECURRENT_MESH_DTYPES:
            case = {"arch": arch, "mesh": MESH, "seed": 0,
                    "overrides": overrides or {},
                    "config": {"n_layers": one[dtype]["layers"],
                               "compute_dtype": dtype},
                    "teacher": {"tokens": one["tokens"],
                                "steps": one[dtype]["steps"],
                                "max_len": LM_MAX_LEN}}
            if dtype == "float32":
                case["logits"] = {"tokens": one["c_tokens"],
                                  "stride": MESH_C_STRIDE}
                if get_config(arch).family == "hybrid" and not overrides:
                    # check f
                    case["control"] = {"tokens": one["tokens"],
                                       "max_len": LM_MAX_LEN,
                                       "overrides": RECURRENT_MESH_FULL}
            else:                                  # the served path
                case["serve"] = {"prompts": [by_len[T] for T in prompts],
                                 "batch": LM_BATCH, "max_len": LM_MAX_LEN,
                                 "new": new}
            cases.append(case)
        cases_of, reduced[arch] = _mesh_reduced_cases(
            torch, arch, RECURRENT_MESH_REDUCED_MESHES)
        cases += cases_of
    return cases, {"ref": ref, "prompts": list(prompts), "new": new,
                   "reduced": reduced}


def phase_lm_recurrent_mesh(torch, ranks: list, ctx: dict,
                            card: str) -> dict:
    """Phase 7g: the recurrent families on MESH (channel parallel over
    "model"), from the per-rank results of the world phase 7e shared
    (:func:`recurrent_mesh_cases`).  Per arch, checks: a. every rank the
    same tokens and logits; b. the teacher-forced prefill and MESH_B_STEPS
    decode steps against one card's run of the same cut model
    (:func:`recurrent_mesh_reference`): bf16 within MESH_LOGIT_RTOL and
    float32 within RECURRENT_MESH_F32_RTOL of the largest logit; c.
    ``Model.logits`` in float32 against one card's forward, within
    RECURRENT_MESH_F32_RTOL; d. the reduced config in float32 on the
    ranks at RECURRENT_MESH_REDUCED_MESHES against the port on the CPU
    (LM_F32_TOL, :func:`_tied_tol`; the same tokens); e. B6 once an
    attention layer and prefill on every rank (none for the ssm), no
    graph kernel; f. (the hybrid) every attention block of the prefills
    and of check c's forward "seq", and check b's float32 teacher prefill
    within RECURRENT_MESH_F32_RTOL of the largest logit of the same ranks'
    prefill under RECURRENT_MESH_FULL, whose blocks are all "full".  One
    ``lm mesh run`` line an arch (the attention blocks' layouts and the
    prefills' collectives; per rank of the served bf16 case: walls,
    prefill and decode seconds, each prompt's prefill layouts and
    collectives, decode tok/s, collectives a decode step, B6 launches,
    peak GB)."""
    import dataclasses

    from repro_torch.configs.base import get_config

    out, i = {"launches": 0, "f32_launches": 0}, 0
    for arch, ref in ctx["ref"].items():
        by_dtype = {}
        for d in RECURRENT_MESH_DTYPES:
            by_dtype[d] = [r[i] for r in ranks]
            i += 1
        cfgs = {d: dataclasses.replace(get_config(arch),
                                       n_layers=ref[d]["layers"])
                for d in RECURRENT_MESH_DTYPES}
        cfg = cfgs["bfloat16"]
        served = by_dtype["bfloat16"]
        # a. every rank the same tokens and logits
        toks = [r["serve"]["tokens"] for r in served]
        if any(x != toks[0] for x in toks[1:]):
            raise AssertionError(f"{arch} mesh: the ranks served different "
                                 f"tokens")
        for rid in range(len(ctx["prompts"])):
            if len(toks[0][rid]) != ctx["new"] or not all(
                    0 <= x < cfg.vocab for x in toks[0][rid]):
                raise AssertionError(f"{arch} mesh request {rid}: "
                                     f"{toks[0][rid][:8]}")
        for dtype, rs in by_dtype.items():
            for r in rs[1:]:
                for k in ("prefill", "decode"):
                    if not np.array_equal(r["teacher"][k],
                                          rs[0]["teacher"][k]):
                        raise AssertionError(f"{arch} mesh {dtype}: the "
                                             f"ranks' teacher {k} differ")
                if "logits" in r and not np.array_equal(r["logits"],
                                                        rs[0]["logits"]):
                    raise AssertionError(f"{arch} mesh {dtype}: the ranks' "
                                         f"logits differ")
                if "control" in r and not np.array_equal(
                        r["control"]["prefill"], rs[0]["control"]["prefill"]):
                    raise AssertionError(f"{arch} mesh {dtype}: the ranks' "
                                         f"control prefills differ")
        # b and c against one card's run of the cut model
        check_b = {}
        for dtype, rs in by_dtype.items():
            got, want = rs[0]["teacher"], ref[dtype]
            rtol = (RECURRENT_MESH_F32_RTOL if dtype == "float32"
                    else MESH_LOGIT_RTOL)
            check_b[dtype] = {
                "prefill": _logit_diff(got["prefill"], want["prefill"],
                                       cfg.vocab, rtol),
                "decode": _logit_diff(got["decode"], want["decode"],
                                      cfg.vocab, rtol),
                "greedy_equal": int((got["decode"][..., :cfg.vocab]
                                     .argmax(-1)[:-1]
                                     == want["steps"][1:]).sum()),
                "greedy_of": int(want["steps"][1:].size), "tol_rel": rtol}
        got32 = by_dtype["float32"][0]
        check_c = {**_logit_diff(got32["logits"], ref["float32"]["c_logits"],
                                 cfg.vocab, RECURRENT_MESH_F32_RTOL),
                   "rows": int(got32["logits"].shape[1]), "dtype": "float32",
                   "tol_rel": RECURRENT_MESH_F32_RTOL}
        # d. the reduced config: the ranks against the port on the CPU
        want_d, check_d = ctx["reduced"][arch], {}
        rcfg = get_config(arch).reduced()
        for m in want_d["meshes"]:
            reds = [r[i] for r in ranks]
            i += 1
            rgot = [reds[0]["teacher"]["prefill"]] + list(
                reds[0]["teacher"]["decode"])
            tol = _tied_tol(rcfg, want_d["logits"][0])
            for g, w in zip(rgot, want_d["logits"]):
                np.testing.assert_allclose(g, w, **tol)
            d = check_d[f"{m[0]}x{m[1]}"] = {
                "max_abs_diff": max(float(np.abs(g - w).max())
                                    for g, w in zip(rgot, want_d["logits"])),
                "tol": tol,
                "tokens_equal": all(r["serve"]["tokens"] == want_d["tokens"]
                                    for r in reds)}
            if not d["tokens_equal"]:
                raise AssertionError(f"{arch} mesh check d: {check_d}")
        # e. B6 once an attention layer and prefill on every rank (none for
        # the ssm), no graph kernel
        served_n = sum(_prefill_launches(T, cfg) for T in ctx["prompts"])
        want_e = [(r["serve"]["launches"], served_n) for r in served] + [
            (r["launches"], _prefill_launches(MESH_B_BATCH[1], cfg))
            for r in served] + [
            (r["launches"], sum(_prefill_launches(T, cfgs["float32"])
                                for T in (MESH_B_BATCH[1],
                                          RECURRENT_MESH_C_TOKENS))
             + ("control" in r) * _prefill_launches(MESH_B_BATCH[1],
                                                   cfgs["float32"]))
            for r in by_dtype["float32"]]
        for counts, want_n in want_e:
            others = {k: c for k, c in counts.items()
                      if k != "flash_attention" and c}
            if counts["flash_attention"] != want_n or others:
                raise AssertionError(f"{arch} mesh: a rank launched "
                                     f"{counts}, want {want_n} flash and "
                                     f"nothing else")
        # f. the attention blocks' layouts; "seq" against "full"
        r32 = by_dtype["float32"][0]
        layouts = {f"teacher {d}": rs[0]["teacher"]["prefill_layouts"]
                   for d, rs in by_dtype.items()}
        layouts["check c"] = r32["logits_layouts"]
        layouts["served"] = served[0]["serve"]["prefill_layouts"]
        check_f = None
        if "control" in r32:
            layouts["control"] = r32["control"]["prefill_layouts"]
            check_f = {**_logit_diff(r32["teacher"]["prefill"],
                                     r32["control"]["prefill"], cfg.vocab,
                                     RECURRENT_MESH_F32_RTOL),
                       "dtype": "float32",
                       "tol_rel": RECURRENT_MESH_F32_RTOL,
                       "prefill_collectives": {
                           "seq": r32["teacher"]["prefill_collectives"],
                           "full": r32["control"]["prefill_collectives"]},
                       "prefill_s": {"seq": r32["teacher"]["prefill_s"],
                                     "full": r32["control"]["prefill_s"]}}
            seq = [x for k, v in layouts.items() if k != "control"
                   for p in ([v] if k != "served" else v) for x in p]
            if set(seq) != {"seq"} or \
                    set(layouts["control"]) != {"full"} or \
                    not check_f["ok"]:
                raise AssertionError(f"{arch} mesh check f: {layouts} "
                                     f"{check_f}")
        lines = [{"rank": j, "params_s": r["params_s"],
                  "wall_s": r["serve"]["wall_s"],
                  "prefill_s": sum(r["serve"]["prefill_s"]),
                  "prefill_layouts": r["serve"]["prefill_layouts"],
                  "prefill_collectives": r["serve"]["prefill_collectives"],
                  "decode_s": r["serve"]["decode_s"],
                  "decode_steps": r["serve"]["decode_steps"],
                  "decode_tok_per_s": r["serve"]["decode_tok_per_s"],
                  "collectives_per_decode_step":
                      r["serve"]["collectives_per_decode_step"],
                  "collectives": r["serve"]["collectives"],
                  "b6_launches": r["serve"]["launches"]["flash_attention"],
                  "peak_gb": (r["peak_mem_bytes"] or 0) / 1e9,
                  "case_wall_s": r["wall_s"]} for j, r in enumerate(served)]
        res = {"card": card, "arch": arch, "family": cfg.family,
               "layers": cfg.n_layers,
               "float32_layers": cfgs["float32"].n_layers,
               "mesh": list(MESH), "backend": "gloo",
               "channels_per_rank": _channels(cfg) // MESH[1],
               "prompts": ctx["prompts"], "new": ctx["new"],
               "tokens": sum(len(x) for x in toks[0].values()),
               "check_b": check_b, "check_c": check_c, "check_d": check_d,
               "check_f": check_f, "layouts": layouts,
               "teacher_prefill_collectives": {
                   d: rs[0]["teacher"]["prefill_collectives"]
                   for d, rs in by_dtype.items()},
               "teacher_prefill_s": {d: rs[0]["teacher"]["prefill_s"]
                                     for d, rs in by_dtype.items()},
               "float32_case_walls_s": [r["wall_s"]
                                        for r in by_dtype["float32"]],
               "float32_peak_gb": max((r["peak_mem_bytes"] or 0) / 1e9
                                      for r in by_dtype["float32"]),
               "ranks": lines}
        log("lm mesh run: " + json.dumps(res))
        bad = [f"b {d} {k}" for d, c in check_b.items()
               for k in ("prefill", "decode") if not c[k]["ok"]]
        if bad or not check_c["ok"]:
            raise AssertionError(f"{arch} mesh: the mesh's logits are off "
                                 f"the one card's beyond the tolerance "
                                 f"({bad or 'c'})")
        out[arch] = res
        out["launches"] += sum(x["b6_launches"] for x in lines)
        out["f32_launches"] += sum(r["launches"]["flash_attention"]
                                   for r in by_dtype["float32"])
    return out


def _channels(cfg) -> int:
    """A recurrent block's channels (``"inner"``): the ssm's d_inner, the
    hybrid's lru_width."""
    from repro_torch.models import rglru, ssm
    return ssm.dims(cfg)[1] if cfg.family == "ssm" else rglru.lru_width(cfg)


def _tied_tol(cfg, logits) -> dict:
    """LM_F32_TOL, its absolute part scaled by the logits' range over the
    dense configs' |max| ~3.5 when the embedding is tied (the hybrid): rows
    of N(0, 1) with no 1/sqrt(d) scale make the logits ~10 times as large,
    and their sums' rounding with them."""
    if not cfg.tie_embeddings:
        return LM_F32_TOL
    scale = max(1.0, float(np.abs(np.asarray(logits)).max()) / 3.5)
    return dict(LM_F32_TOL, atol=LM_F32_TOL["atol"] * scale)


def lm_card_vs_cpu(torch, arch: str = LM_ARCH) -> dict:
    """Check c: the reduced config, float32 compute, served on the card and
    on the CPU from the same weights: the same tokens, and prefill logits
    within the float32 tolerance (:func:`_tied_tol`: scaled with a tied
    embedding).  The prompts are longer than the hybrid's reduced window of
    16; a vlm's and an encdec's requests bring their extras
    (:func:`lm_extras`)."""
    import dataclasses

    from repro_torch.configs.base import get_config
    from repro_torch.convert import lm_params_from_arrays
    from repro_torch.models.factory import build_model
    from repro_torch.serve.engine import ContinuousBatcher, Request

    cfg = dataclasses.replace(get_config(arch).reduced(),
                              compute_dtype="float32")
    model = build_model(cfg)
    cpu = model.init(torch.Generator().manual_seed(1), "cpu")

    def arrays(tree):
        return {k: arrays(v) if isinstance(v, dict) else v.float().numpy()
                for k, v in tree.items()}

    tree = arrays(cpu)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab, T).astype(np.int32)
               for T in (40, 100, 64)]
    extras = [lm_extras(cfg, rng) for _ in prompts]
    tokens, logits = {}, {}
    for dev in ("cuda", "cpu"):
        p = lm_params_from_arrays(tree, cfg, dev)
        b = ContinuousBatcher(model, p, 2, 128, device=dev)
        for rid, (pr, ex) in enumerate(zip(prompts, extras)):
            b.submit(Request(rid=rid, prompt=pr, max_new_tokens=8,
                             extras=ex))
        tokens[dev] = b.run()
        batch = lm_batch(torch, prompts[1], extras[1], dev)
        logits[dev] = model.prefill(p, batch, max_len=128)[0].cpu()
    diff = float((logits["cuda"] - logits["cpu"]).abs().max())
    tol = _tied_tol(cfg, logits["cpu"].numpy())
    res = {"arch": cfg.name + " reduced, float32", "tokens_equal":
           tokens["cuda"] == tokens["cpu"], "prefill_logit_max_diff": diff,
           "tol": tol}
    log("lm check c (card vs CPU): " + json.dumps(res))
    if not res["tokens_equal"]:
        raise AssertionError(f"lm: card and CPU generate different tokens: "
                             f"{tokens}")
    torch.testing.assert_close(logits["cuda"], logits["cpu"], **tol)
    return res


# ---------------------------------------------------------------------------
# phase 8: training

#: phase 8d: ``launch/train.py``'s path for starcoder2-7b at full width, its
#: depth cut to TRAIN_LAYERS of 32 so that float32 parameters, gradients
#: and both AdamW moments (16 bytes a parameter: 3.06 B parameters, 48.9
#: GB) fit one card; batch 4 x 4096 (train_4k's sequence) in the config's 4
#: microbatches, TRAIN_STEPS steps
TRAIN_LAYERS = 12
TRAIN_STEPS = 4
TRAIN_BATCH, TRAIN_SEQ, TRAIN_MICRO = 4, 4096, 4
#: 8d's ``--lr``: the CLI's default, 1e-3, is a rate for the reduced
#: configs.  AdamW's first step moves every parameter by about the rate,
#: in its gradient's sign; at this width and depth, with no warmup to
#: speak of, that raises the loss from random weights at any rate from
#: 1e-5 up, in float32 and through the plain attention alike
#: (``scripts/train_probe.py``).  At TRAIN_LR the loss must fall.
TRAIN_LR = 3e-6
#: threefry launches of one ``batch_for_step`` (fold_in, split, the tokens'
#: uniform; randint's split and two bit draws)
TRAIN_DRAWS = 6
#: 8a: the flash gradient (``FlashAttentionFn``: the kernel's forward, the
#: plain backward) against autograd through the plain version.  bf16 at
#: starcoder2's shape, as a share of each gradient's largest entry: both
#: sum in float32 and round once to bf16 (2^-8), but the kernel's output,
#: which the backward's ``rowsum(dout * out)`` reads, has p rounded to bf16
#: for p.v (FLASH_TOL); float32 at hd 16 absolute
TRAIN_GRAD_TOL = {"bfloat16": 2e-2, "float32": 1e-4}
#: 8b: a float32 train step of the reduced config, card against CPU
TRAIN_F32_TOL = dict(rtol=1e-5, atol=1e-5)
#: 8b: of the reduced config's 86,272 parameters, how many may differ by
#: more than TRAIN_F32_TOL after the step (each within AdamW's own
#: amplification of its gradient's difference, see train_card_vs_cpu)
TRAIN_AMPLIFIED_MAX = 16


def _state_to(torch, tree, dev):
    """A copy of a tree of dicts, NamedTuples and tensors on ``dev``."""
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        return tree.to(dev, copy=True)
    if isinstance(tree, dict):
        return {k: _state_to(torch, v, dev) for k, v in tree.items()}
    return type(tree)(*(_state_to(torch, v, dev) for v in tree))


def train_flash_grad(torch) -> dict:
    """8a: ``FlashAttentionFn`` on the card (one kernel launch, the plain
    backward) against autograd through the plain version on the same
    inputs: at starcoder2's training shape (1 x 4096, 36 / 4 heads of 128,
    causal, bf16) and at hd 16 in float32; then one full-width attention
    layer's backward, whose ``wq`` must get a gradient; then the plain
    backward's time at the training shape beside SDPA's forward +
    backward on the same inputs (the library yardstick; SDPA runs its own
    flash kernels) and B6's forward."""
    import torch.nn.functional as F

    from repro_torch.configs.base import get_config
    from repro_torch.kernels.flash_attention import ops as faops
    from repro_torch.kernels.flash_attention.ref import (
        flash_attention_bwd_ref, flash_attention_gqa_ref)
    from repro_torch.models import transformer as tfm

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(8)
    cfg = get_config(LM_ARCH)
    H, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    out, timed = {}, None
    for dtype, (S, h, hkv, d) in ((torch.bfloat16, (TRAIN_SEQ, H, Hkv, hd)),
                                  (torch.float32, (256, 4, 2, 16))):
        name = str(dtype).split(".")[1]
        shapes = ((1, S, h, d), (1, S, hkv, d), (1, S, hkv, d), (1, S, h, d))
        q, k, v, dout = (torch.randn(s, generator=gen, device=dev).to(dtype)
                         for s in shapes)
        leaves = [x.clone().requires_grad_() for x in (q, k, v)]
        n0 = faops.LAUNCHES["flash_attention"]
        o = faops.flash_attention(*leaves, causal=True)
        if type(o.grad_fn).__name__ != "FlashAttentionFnBackward" or \
                faops.LAUNCHES["flash_attention"] != n0 + 1:
            raise AssertionError(f"train 8a: the {name} call did not go "
                                 f"through FlashAttentionFn's launch "
                                 f"({o.grad_fn})")
        o.backward(dout)
        plain = [x.clone().requires_grad_() for x in (q, k, v)]
        flash_attention_gqa_ref(*plain, causal=True).backward(dout)
        errs = {}
        for label, a, b in zip("qkv", leaves, plain):
            err = float((a.grad.float() - b.grad.float()).abs().max())
            scale = float(b.grad.float().abs().max())
            errs["d" + label] = {"max_abs_err": err, "max_abs": scale}
            bound = TRAIN_GRAD_TOL[name] * (scale if dtype == torch.bfloat16
                                            else 1.0)
            if not err <= bound or scale == 0:
                raise AssertionError(f"train 8a {name}: d{label} differs by "
                                     f"{err} (bound {bound}, max {scale})")
        out[name] = {"shape": [1, S, h, hkv, d], "causal": True, **errs,
                     "tol": TRAIN_GRAD_TOL[name]}
        if dtype == torch.bfloat16:
            timed = (q, k, v, o.detach(), dout)
        del leaves, plain, o
    # one attention layer at full width: wq, wk and wv get gradients
    lp = tfm.init_layer(gen, cfg, "attn", dev)
    for t in lp["attn"].values():
        t.requires_grad_()
    x = torch.randn((1, 512, cfg.d_model), generator=gen, device=dev).to(
        cfg.cdtype)
    n0 = faops.LAUNCHES["flash_attention"]
    y, _ = tfm._apply_attn_layer(tfm.cast_layer_params(lp, cfg.cdtype), cfg,
                                 x, torch.arange(512, device=dev))
    y.float().square().mean().backward()
    grads = {k: float(lp["attn"][k].grad.abs().max())
             for k in ("wq", "wk", "wv", "wo")}
    if faops.LAUNCHES["flash_attention"] != n0 + 1 or \
            not all(g > 0 for g in grads.values()):
        raise AssertionError(f"train 8a: one layer's backward gave {grads}")
    out["layer_grad_max"] = grads
    del lp, x, y
    # times at the training shape (CUDA events around eager calls)
    q, k, v, o, dout = timed
    out["bwd_ms"] = eager_ms(torch, lambda: flash_attention_bwd_ref(
        q, k, v, o, dout, causal=True), iters=5, warmup=1)
    out["fwd_ms"] = eager_ms(torch, lambda: faops.flash_attention(
        q, k, v, causal=True), iters=10, warmup=2)
    qs, ks, vs = (x.transpose(1, 2).contiguous().requires_grad_()
                  for x in (q, k, v))
    dos = dout.transpose(1, 2).contiguous()

    def sdpa():
        F.scaled_dot_product_attention(qs, ks, vs, is_causal=True,
                                       enable_gqa=True).backward(dos)
    out["sdpa_fwd_bwd_ms"] = eager_ms(torch, sdpa, iters=10, warmup=2)
    out["plain_fwd_bwd_ms"] = out["fwd_ms"] + out["bwd_ms"]
    log("train 8a flash gradient: " + json.dumps(out))
    return out


def train_card_vs_cpu(torch) -> dict:
    """8b: one ``make_train_step`` step (2 microbatches, the CLI's default
    learning rate 1e-3) of starcoder2-7b ``reduced()`` in float32, on the
    card and on the CPU from the same state and the same batch (drawn on
    each device: equal bit for bit).  The loss and grad norm within
    TRAIN_F32_TOL; the gradients (the first moments, ``(1 - b1) g`` after
    one step) within TRAIN_F32_TOL; the updated parameters within
    TRAIN_F32_TOL plus what AdamW's first step makes of the gradients'
    difference: it moves a parameter by ``lr * g / (|g| + eps)``, so where
    ``|g|`` is near or below eps = 1e-8 (a sum that cancels) a gradient
    difference ``dg`` moves it by up to ``lr * eps * dg / (|g| + eps)^2``,
    capped at the largest move the step can make, ``lr * (1 + wd * |p|)``.
    The elements that need that term (``amplified``) are at most
    TRAIN_AMPLIFIED_MAX."""
    import dataclasses

    from repro_torch.configs.base import get_config
    from repro_torch.configs.shapes import ShapeConfig
    from repro_torch.models.factory import build_model
    from repro_torch.train.data import batch_for_step
    from repro_torch.train.optimizer import AdamW, constant, tree_leaves
    from repro_torch.train.train_step import init_train_state, make_train_step

    cfg = dataclasses.replace(get_config(LM_ARCH).reduced(),
                              compute_dtype="float32")
    model, opt, lr = build_model(cfg), AdamW(), 1e-3
    cpu = init_train_state(model, torch.Generator().manual_seed(1), opt,
                           device="cpu")
    card = _state_to(torch, cpu, torch.device("cuda"))
    shape = ShapeConfig("t", "train", 64, 4)
    step = make_train_step(model, opt, constant(lr), microbatches=2)
    bc = batch_for_step(cfg, shape, 0, device="cuda")
    bp = batch_for_step(cfg, shape, 0, device="cpu")
    for k in bp:
        if not torch.equal(bc[k].cpu(), bp[k]):
            raise AssertionError(f"train 8b: the card's batch {k} differs "
                                 f"from the CPU's")
    card, mc = step(card, bc)
    cpu, mp = step(cpu, bp)
    for k in ("loss", "ce", "grad_norm"):
        torch.testing.assert_close(mc[k].cpu(), mp[k], **TRAIN_F32_TOL)
    diff = grad_diff = 0.0
    amplified = 0
    tol = TRAIN_F32_TOL
    for a, b, ma, mb in zip(tree_leaves(card.params), tree_leaves(cpu.params),
                            tree_leaves(card.opt.mu), tree_leaves(cpu.opt.mu)):
        a, ma = a.cpu(), ma.cpu()
        torch.testing.assert_close(ma, mb, **tol)
        g = mb / (1 - opt.b1)
        dg = (ma - mb).abs() / (1 - opt.b1)
        plain = tol["atol"] + tol["rtol"] * b.abs()
        step_max = lr * (1 + opt.weight_decay * b.abs())
        bound = plain + torch.minimum(
            lr * opt.eps * dg / (g.abs() + opt.eps) ** 2, step_max)
        d = (a - b).abs()
        if not bool((d <= bound).all()):
            raise AssertionError(f"train 8b: parameters differ by "
                                 f"{float(d.max())} beyond the bound")
        amplified += int((d > plain).sum())
        diff = max(diff, float(d.max()))
        grad_diff = max(grad_diff, float(dg.max()))
    if amplified > TRAIN_AMPLIFIED_MAX:
        raise AssertionError(f"train 8b: {amplified} parameters differ "
                             f"beyond TRAIN_F32_TOL (at most "
                             f"{TRAIN_AMPLIFIED_MAX})")
    res = {"arch": cfg.name + " reduced, float32", "lr": lr,
           **{k: float(mp[k]) for k in ("loss", "grad_norm")},
           "loss_diff": float((mc["loss"].cpu() - mp["loss"]).abs()),
           "grad_max_diff": grad_diff, "param_max_diff": diff,
           "amplified": amplified,
           "amplified_max": TRAIN_AMPLIFIED_MAX, "tol": tol}
    log("train 8b card vs CPU: " + json.dumps(res))
    return res


def train_resume(torch) -> dict:
    """8c: a run of the reduced config (bf16 compute) on the card killed by
    ``fault_hook`` at step 6 after the step-4 checkpoint, then restarted:
    its loss history and final state equal the uninterrupted run's bit for
    bit."""
    import shutil

    from repro_torch.configs.base import get_config
    from repro_torch.configs.shapes import ShapeConfig
    from repro_torch.models.factory import build_model
    from repro_torch.train import checkpoint as ck
    from repro_torch.train.data import batch_for_step
    from repro_torch.train.loop import LoopConfig, run_loop
    from repro_torch.train.optimizer import AdamW, constant, tree_leaves
    from repro_torch.train.train_step import init_train_state, make_train_step

    dev = torch.device("cuda")
    cfg = get_config(LM_ARCH).reduced()
    model = build_model(cfg)
    shape = ShapeConfig("t", "train", 64, 4)
    step = make_train_step(model, AdamW(), constant(3e-3), microbatches=2)

    def fresh():
        return init_train_state(model, torch.Generator(device=dev)
                                .manual_seed(2), AdamW(), device=dev)

    def data(s):
        return batch_for_step(cfg, shape, s, device=dev)

    def quiet(*a):
        pass
    ckdir = os.path.join(ROOT, "build", "chip_smoke_ckpt")
    shutil.rmtree(ckdir, ignore_errors=True)
    full, fstats = run_loop(step, fresh(), data,
                            LoopConfig(n_steps=8, log_every=1), log=quiet)

    class Fault(Exception):
        pass

    def fault(s):
        if s == 6:
            raise Fault()
    lc = LoopConfig(n_steps=8, ckpt_every=4, ckpt_dir=ckdir, log_every=1)
    try:
        run_loop(step, fresh(), data, lc, log=quiet, fault_hook=fault)
        raise AssertionError("train 8c: the injected fault did not stop "
                             "the run")
    except Fault:
        pass
    if ck.latest_step(ckdir) != 4:
        raise AssertionError(f"train 8c: newest checkpoint "
                             f"{ck.latest_step(ckdir)}, want 4")
    resumed, rstats = run_loop(step, fresh(), data, lc, log=quiet)
    shutil.rmtree(ckdir, ignore_errors=True)
    want = [h for h in fstats.history if h["step"] >= 4]
    if rstats.restored_step != 4 or rstats.history != want:
        raise AssertionError(f"train 8c: the resumed history "
                             f"{rstats.history} is not {want}")
    leaves = list(zip(tree_leaves(full), tree_leaves(resumed)))
    bad = sum(not torch.equal(a, b) for a, b in leaves)
    if bad or int(resumed.step) != 8:
        raise AssertionError(f"train 8c: {bad} of {len(leaves)} state "
                             f"leaves differ after the resume")
    res = {"arch": cfg.name + " reduced", "restored_step": 4,
           "losses": [h["loss"] for h in fstats.history],
           "leaves_equal": len(leaves)}
    log("train 8c resume: " + json.dumps(res))
    return res


def _kernel_class(name: str) -> str:
    """The class of a traced kernel of a train step, by its name."""
    low = name.lower()
    if FLASH_TC_NAME in name:
        return "B6 forward"
    if "nvjet" in low:           # cuBLASLt's Hopper tensor-core kernels
        return "bf16 matmul"
    if "gemm" in low or "xmma" in low or "cutlass" in low:
        return "bf16 matmul" if "bf16" in low else "float32 matmul"
    if "elementwise" in low or "vectorized" in low or "unrolled" in low:
        return "elementwise"
    if "reduce" in low or "softmax" in low or "norm" in low:
        return "reductions"
    return "other"


def train_step_trace(torch, cfg, state) -> dict:
    """8d's breakdown: one more step of the same config (lr 1e-5) traced
    with torch.profiler, its card time by kernel class and its top
    kernels; then AdamW's update alone over the whole state (zero
    gradients), timed with CUDA events."""
    from repro_torch.configs.shapes import ShapeConfig
    from repro_torch.models.factory import build_model
    from repro_torch.train.data import batch_for_step
    from repro_torch.train.optimizer import AdamW, constant, tree_map
    from repro_torch.train.train_step import make_train_step

    opt = AdamW()
    step = make_train_step(build_model(cfg), opt, constant(1e-5),
                           microbatches=TRAIN_MICRO)
    batch = batch_for_step(cfg, ShapeConfig("t", "train", TRAIN_SEQ,
                                            TRAIN_BATCH), TRAIN_STEPS,
                           device="cuda")
    x = torch.ones((64, 64), device="cuda")
    events, wall_ms, (state, _) = trace_once(torch, lambda: x @ x,
                                             lambda: step(state, batch))
    classes, total = {}, 0.0
    for e in events:
        us = _device_us(e)
        total += us
        c = _kernel_class(e.key)
        classes[c] = classes.get(c, 0.0) + us / 1e3
    top = sorted(((_device_us(e), e.key, e.count) for e in events),
                 reverse=True)[:8]
    grads = tree_map(torch.zeros_like, state.params)
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    a.record()
    opt.update(grads, state.opt, state.params,
               torch.tensor(1e-5, device="cuda"))
    b.record()
    b.synchronize()
    del grads
    return {"traced_wall_ms": wall_ms, "device_ms": total / 1e3,
            "device_ms_by_class": classes,
            "top_kernels_ms": [[k[:70], round(us / 1e3, 3), n]
                               for us, k, n in top],
            "adamw_update_ms": a.elapsed_time(b)}


def train_full_width(torch, counters) -> dict:
    """8d: ``launch/train.py``'s path (``parse_args``, ``config_for``,
    ``run``) for starcoder2-7b at full width and TRAIN_LAYERS layers, at
    ``--lr`` TRAIN_LR: every step's loss and grad norm finite, the last
    step's loss below the first's (the bf16 gradients through
    ``FlashAttentionFn``, the remat and the accumulation over microbatches
    point downhill), every parameter's first moment non-zero somewhere
    (each got a gradient), the final norm moved, and the flash kernel
    launched twice per attention layer and microbatch (the forward and the
    remat's recompute)."""
    import dataclasses

    from repro_torch.launch import train as tlaunch
    from repro_torch.train.optimizer import tree_leaves

    args = tlaunch.parse_args([
        "--arch", LM_ARCH, "--steps", str(TRAIN_STEPS), "--batch",
        str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ), "--microbatches",
        str(TRAIN_MICRO), "--lr", str(TRAIN_LR)])
    cfg = dataclasses.replace(tlaunch.config_for(args), n_layers=TRAIN_LAYERS)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    counters.reset()
    t = time.perf_counter()
    state, stats = tlaunch.run(args, cfg, log_every=1,
                               log=lambda m: log("  " + m))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    counts = counters.read()
    per_step = TRAIN_LAYERS * TRAIN_MICRO * 2
    want = {"flash_attention": per_step * TRAIN_STEPS,
            "threefry": TRAIN_DRAWS * TRAIN_STEPS}
    got = {k: c for k, c in counts.items() if c}
    if got != want:
        raise AssertionError(f"train 8d: launches {got}, want {want}")
    hist = stats.history
    if len(hist) != TRAIN_STEPS or not all(
            np.isfinite(h["loss"]) and np.isfinite(h["grad_norm"])
            for h in hist):
        raise AssertionError(f"train 8d: history {hist}")
    if not hist[-1]["loss"] < hist[0]["loss"]:
        raise AssertionError(f"train 8d: the loss did not fall: "
                             f"{[h['loss'] for h in hist]}")
    idle = [i for i, m in enumerate(tree_leaves(state.opt.mu))
            if not bool((m != 0).any())]
    moved = bool((state.params["final_norm"]["scale"] != 1).any())
    if idle or not moved:
        raise AssertionError(f"train 8d: {len(idle)} parameters got no "
                             f"gradient; final norm moved: {moved}")
    n_params = sum(x.numel() for x in tree_leaves(state.params))
    tokens = TRAIN_BATCH * TRAIN_SEQ
    res = {"arch": cfg.name, "n_layers": cfg.n_layers, "of_layers": 32,
           "d_model": cfg.d_model, "params": n_params,
           "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
           "microbatches": TRAIN_MICRO, "steps": TRAIN_STEPS,
           "loss": [h["loss"] for h in hist],
           "grad_norm": [h["grad_norm"] for h in hist],
           "lr": [h["lr"] for h in hist],
           "step_s": stats.step_times,
           "tokens_per_s": [tokens / s for s in stats.step_times],
           "max_memory_allocated": torch.cuda.max_memory_allocated(),
           "flash_launches_per_step": per_step,
           "launches": counts["flash_attention"], "counts": got,
           "wall_s": wall}
    res["trace"] = train_step_trace(torch, cfg, state)
    res["busy_share"] = res["trace"]["device_ms"] / 1e3 / float(
        np.mean(stats.step_times))
    log("train 8d full width: " + json.dumps(res))
    del state
    torch.cuda.empty_cache()
    return res


def phase_train(torch, counters) -> dict:
    """Phase 8: training on the card, 8a-8d."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.empty_cache()
    res = {"grad": train_flash_grad(torch)}
    torch.cuda.empty_cache()
    res["card_vs_cpu"] = train_card_vs_cpu(torch)
    res["resume"] = train_resume(torch)
    res["full"] = train_full_width(torch, counters)
    res["launches"] = res["full"]["launches"]
    return res


# ---------------------------------------------------------------------------
# phase 8e: training on a mesh

def train_mesh_cases(torch) -> tuple:
    """Phase 8e's cases for the shared world (phase 7e spawns it): the
    full-width ``launch/train.run`` on TRAIN_MESH, and the reduced config
    in float32 from a seeded state (2 steps, a checkpoint, a reshard onto
    RESHARD_MESH, 2 more).  Returns (cases, what phase 8e holds them
    to)."""
    import dataclasses
    import shutil

    from repro_torch.configs.base import get_config
    from repro_torch.configs.shapes import ShapeConfig
    from repro_torch.convert import train_state_from_arrays
    from repro_torch.models.factory import build_model
    from repro_torch.train.data import batch_for_step
    from repro_torch.train.optimizer import AdamW, constant
    from repro_torch.train.train_step import init_train_state, make_train_step

    argv = ["--arch", LM_ARCH, "--steps", str(TRAIN_MESH_STEPS), "--batch",
            str(TRAIN_MESH_BATCH), "--seq", str(TRAIN_MESH_SEQ),
            "--microbatches", str(TRAIN_MESH_MICRO), "--lr", str(TRAIN_LR)]
    full = {"arch": LM_ARCH, "mesh": TRAIN_MESH, "argv": argv,
            "config": {"n_layers": TRAIN_MESH_LAYERS}}
    def numpy_state(st):
        def arrays(tree):
            return None if tree is None else {
                k: arrays(v) if isinstance(v, dict) else v.numpy().copy()
                for k, v in tree.items()}
        return {"params": arrays(st.params), "mu": arrays(st.opt.mu),
                "nu": arrays(st.opt.nu), "count": st.opt.count.numpy(),
                "step": st.step.numpy()}

    def seeded(arch, **fields):
        cfg = dataclasses.replace(get_config(arch).reduced(),
                                  compute_dtype="float32", **fields)
        st = init_train_state(build_model(cfg),
                              torch.Generator().manual_seed(1), AdamW(),
                              device="cpu")
        return cfg, numpy_state(st)
    rcfg, state = seeded(LM_ARCH)
    mcfg, mstate = seeded(MOE_ARCH)
    ckdir = os.path.join(ROOT, "build", "chip_smoke_mesh_ckpt")
    shutil.rmtree(ckdir, ignore_errors=True)
    reduced = {"arch": LM_ARCH, "reduced": True, "mesh": TRAIN_MESH,
               "config": {"compute_dtype": "float32"}, "state": state,
               "seq": TRAIN_MESH_REDUCED_SEQ, "batch": TRAIN_MESH_BATCH,
               "microbatches": TRAIN_MESH_MICRO,
               "lr": ("constant", (TRAIN_MESH_REDUCED_LR,)),
               "steps": TRAIN_MESH_STEPS, "ckpt_dir": ckdir,
               "reshard": [(RESHARD_MESH, TRAIN_MESH_STEPS)]}
    # the moe family: the reduced config's experts expert parallel over
    # "model", FSDP over "data" (phase 7f's training check)
    moe = {**reduced, "arch": MOE_ARCH, "state": mstate, "routing": True}
    del moe["ckpt_dir"], moe["reshard"]
    # check h: check c's 2 steps again with the carry whole
    whole = {k: v for k, v in reduced.items()
             if k not in ("ckpt_dir", "reshard")}
    whole["overrides"] = TRAIN_MESH_WHOLE_CARRY
    # the recurrent families: their RG-LRU and ssm blocks channel parallel
    # over "model", FSDP over "data" (phase 7g's training check), one step
    # at a time from the CPU's state (:func:`_train_mesh_stepwise`); then
    # the hybrid with 10 / 1 heads at MESH, whose attention runs "seq" (the
    # card's one run of its backward: B6's gradient at q_offset > 0)
    rec, rec_cases = [], []
    for arch, fields, mesh, n_steps in (
            [(arch, {}, TRAIN_MESH, TRAIN_MESH_STEPS)
             for arch in LM_RECURRENT]
            + [(RG_ARCH, RECURRENT_TRAIN_SEQ_HEADS, MESH, 1)]):
        cfg, s0 = seeded(arch, **fields)
        cpu = train_state_from_arrays(**s0, device="cpu")
        shape = ShapeConfig("t", "train", TRAIN_MESH_REDUCED_SEQ,
                            TRAIN_MESH_BATCH)
        step = make_train_step(build_model(cfg), AdamW(),
                               constant(TRAIN_MESH_REDUCED_LR),
                               microbatches=TRAIN_MESH_MICRO)
        states, metrics = [s0], []
        for s_ in range(n_steps):
            cpu, m = step(cpu, batch_for_step(cfg, shape, s_, device="cpu"))
            metrics.append({k: float(m[k]) for k in ("loss", "ce", "aux")})
            states.append(numpy_state(cpu))
        rec.append({"cfg": cfg, "states": states, "metrics": metrics,
                    "mesh": mesh})
        rec_cases += [{**moe, "arch": arch, "mesh": mesh, "state": states[s_],
                       "config": {"compute_dtype": "float32", **fields},
                       "steps": 1, "first_step": s_, "routing": False}
                      for s_ in range(n_steps)]
    return [full, reduced, moe, whole] + rec_cases, {
        "argv": argv, "rcfg": rcfg, "state": state, "ckdir": ckdir,
        "mcfg": mcfg, "mstate": mstate, "rec": rec}


def _shard_specs(cfg, mesh_shape) -> dict:
    """``{params leaf path: spec}`` of ``cfg`` on a (data, model) mesh."""
    from repro_torch.launch.steps import rules_for
    from repro_torch.models.factory import build_model
    from repro_torch.train.checkpoint import _flatten
    from repro_torch.train.optimizer import AdamState
    from repro_torch.train.train_step import TrainState, state_shardings

    model = build_model(cfg)
    rules = rules_for(cfg, dict(zip(("data", "model"), mesh_shape)))
    specs = state_shardings(TrainState(
        params=model.param_shapes(), opt=AdamState(None, None, None),
        step=None), model.param_axes(), rules)
    return _flatten(specs.params, specs=True)


class _RankAt:
    """Where rank ``rank`` of a (data, model) mesh sits (what
    ``sharding.shard_by_spec`` reads of a mesh), without a world."""

    def __init__(self, shape, rank):
        self.shape = dict(zip(("data", "model"), shape))
        self.coords = dict(zip(("data", "model"), (int(c) for c in
                                                   np.unravel_index(
                                                       rank, shape))))

    def index(self, axes):
        i = 0
        for a in axes:
            i = i * self.shape[a] + self.coords[a]
        return i


def _adamw_close(got: dict, want, specs, mesh_shape, rank, steps,
                 lr, updates=None) -> dict:
    """A rank's reduced state (``{checkpoint path: numpy}``) against its
    blocks of the CPU's state ``want`` after ``steps`` steps at ``lr``:
    the moments within TRAIN_F32_TOL; the params within TRAIN_F32_TOL plus
    what AdamW makes of the moments' differences (8b's allowance, for any
    step: the update's first-order change, ``lr * (|dm| / (s + eps) + |m|
    ds / (s + eps)^2)`` summed over the steps (the last ``updates`` of
    them when the two states were equal before those), ``s = sqrt(v)``, both
    bias-corrected), at most TRAIN_AMPLIFIED_MAX elements beyond
    TRAIN_F32_TOL."""
    from repro_torch.models.sharding import shard_by_spec
    from repro_torch.train.checkpoint import _flatten
    from repro_torch.train.optimizer import AdamW

    opt, tol = AdamW(), TRAIN_F32_TOL
    where = _RankAt(mesh_shape, rank) if mesh_shape else None
    flat = _flatten(want)

    def block(key, path):
        t = flat[key]
        if where is not None:
            t = shard_by_spec(t, specs[path], where)
        return t.numpy()
    bc1, bc2 = 1 - opt.b1 ** steps, 1 - opt.b2 ** steps
    worst = {"mu": 0.0, "nu": 0.0, "params": 0.0}
    amplified = 0
    for key in flat:
        if not key.startswith(".params::"):
            continue
        path = key[len(".params::"):]
        p, m, v = (block(pre + path, path) for pre in (
            ".params::", ".opt::.mu::", ".opt::.nu::"))
        gp, gm, gv = (got[pre + path] for pre in (
            ".params::", ".opt::.mu::", ".opt::.nu::"))
        for name, a, b in (("mu", gm, m), ("nu", gv, v)):
            np.testing.assert_allclose(a, b, **tol, err_msg=f"{name} {path}")
            worst[name] = max(worst[name], float(np.abs(a - b).max()))
        mh, s = m / bc1, np.sqrt(v / bc2)
        dm, ds = np.abs(gm / bc1 - mh), np.abs(np.sqrt(gv / bc2) - s)
        plain = tol["atol"] + tol["rtol"] * np.abs(p)
        slack = (updates or steps) * lr * (dm / (s + opt.eps)
                              + np.abs(mh) * ds / (s + opt.eps) ** 2)
        d = np.abs(gp - p)
        if not (d <= plain + slack).all():
            raise AssertionError(f"train 8e: {path} differs by "
                                 f"{float(d.max())} beyond the bound")
        amplified += int((d > plain).sum())
        worst["params"] = max(worst["params"], float(d.max()))
    if amplified > TRAIN_AMPLIFIED_MAX:
        raise AssertionError(f"train 8e: {amplified} parameters beyond "
                             f"TRAIN_F32_TOL (at most {TRAIN_AMPLIFIED_MAX})")
    return {"max_abs_diff": worst, "amplified": amplified}


def _check_train_mesh_launches(full: list) -> None:
    """8e's check e on each rank's launch counts."""
    per_step = TRAIN_MESH_LAYERS * TRAIN_MESH_MICRO * 2
    want = {"flash_attention": per_step * TRAIN_MESH_STEPS,
            "threefry": TRAIN_DRAWS * TRAIN_MESH_STEPS}
    for i, r in enumerate(full):
        got = {k: c for k, c in r["launches"].items() if c}
        if got != want or r["b6"] != [per_step] * TRAIN_MESH_STEPS:
            raise AssertionError(f"train 8e rank {i}: launches {got} "
                                 f"({r['b6']} a step), want {want}")


def _train_mesh_moe(torch, moe: list, ctx: dict) -> dict:
    """8e's check f: the reduced moe config's 2 steps on TRAIN_MESH (its
    experts expert parallel over "model", FSDP over "data") against the
    port on the CPU: ``loss``, ``ce`` and ``aux`` of each step within
    TRAIN_F32_TOL, each rank's state as :func:`_adamw_close`; every rank
    the same metric bits, and the ranks of a data row routed alike."""
    from repro_torch.configs.shapes import ShapeConfig
    from repro_torch.convert import train_state_from_arrays
    from repro_torch.models.factory import build_model
    from repro_torch.train.data import batch_for_step
    from repro_torch.train.optimizer import AdamW, constant
    from repro_torch.train.train_step import make_train_step

    steps = TRAIN_MESH_STEPS
    shape = ShapeConfig("t", "train", TRAIN_MESH_REDUCED_SEQ,
                        TRAIN_MESH_BATCH)
    mcfg = ctx["mcfg"]
    legs = [r["legs"][0] for r in moe]
    if any(leg["bits"] != legs[0]["bits"] for leg in legs[1:]):
        raise AssertionError("train 8e: the moe ranks' metric bits differ")
    rows = {}
    for i, r in enumerate(moe):
        key = _routing_key(r["routing"])
        if rows.setdefault(i // TRAIN_MESH[1], key) != key:
            raise AssertionError("train 8e: moe ranks of a data row routed "
                                 "differently")
    cpu = train_state_from_arrays(**ctx["mstate"], device="cpu")
    step = make_train_step(build_model(mcfg), AdamW(),
                           constant(TRAIN_MESH_REDUCED_LR),
                           microbatches=TRAIN_MESH_MICRO)
    for s_ in range(steps):
        cpu, m = step(cpu, batch_for_step(mcfg, shape, s_, device="cpu"))
        np.testing.assert_allclose(
            [legs[0][k][s_] for k in ("loss", "ce", "aux")],
            [float(m[k]) for k in ("loss", "ce", "aux")], **TRAIN_F32_TOL)
    mspecs = _shard_specs(mcfg, TRAIN_MESH)
    res_f = [_adamw_close(r["legs"][0]["state"], cpu, mspecs, TRAIN_MESH,
                          i, steps, TRAIN_MESH_REDUCED_LR)
             for i, r in enumerate(moe)]
    return {"arch": mcfg.name + " reduced", "mesh": list(TRAIN_MESH),
            "steps": steps, "loss": legs[0]["loss"], "aux": legs[0]["aux"],
            "cpu_loss": float(m["loss"]),
            "dropped_share": moe[0]["routing"]["dropped_share"],
            **max(res_f, key=lambda x: x["amplified"])}


def _train_mesh_stepwise(torch, runs: list, rec: dict) -> dict:
    """8e's check g for one recurrent config: each of its float32 steps on
    ``rec["mesh"]`` (the RG-LRU and ssm blocks channel parallel over
    "model", FSDP over "data"; at MESH, the 10-head hybrid's attention
    "seq"), taken by the ranks from the CPU's state before it (``runs[s]``
    from ``rec["states"][s]``), against the CPU's step: ``loss``, ``ce``,
    ``aux`` within TRAIN_F32_TOL, each rank's state as
    :func:`_adamw_close` for one update, every rank the same metric bits.
    One step at a time: the hybrid's first gradient has entries near
    AdamW's eps, where ``m / (sqrt(v) + eps)`` moves with float32 rounding
    and the next step's moments no longer show it."""
    from repro_torch.convert import train_state_from_arrays

    cfg, steps, mesh = rec["cfg"], len(rec["metrics"]), rec["mesh"]
    mspecs = _shard_specs(cfg, mesh)
    worst = []
    for s_ in range(steps):
        legs = [r[s_]["legs"][0] for r in runs]
        if any(leg["bits"] != legs[0]["bits"] for leg in legs[1:]):
            raise AssertionError(f"train 8e: the {cfg.name} ranks' metric "
                                 f"bits differ")
        want = rec["metrics"][s_]
        np.testing.assert_allclose([legs[0][k][0] for k in want],
                                   list(want.values()), **TRAIN_F32_TOL)
        cpu = train_state_from_arrays(**rec["states"][s_ + 1], device="cpu")
        worst += [_adamw_close(leg["state"], cpu, mspecs, mesh, i,
                               s_ + 1, TRAIN_MESH_REDUCED_LR, updates=1)
                  for i, leg in enumerate(legs)]
    return {"arch": cfg.name + " reduced", "mesh": list(mesh),
            "heads": [cfg.n_heads, cfg.n_kv_heads],
            "layouts": runs[0][0]["layouts"],
            "steps": steps, "loss": [r["legs"][0]["loss"][0]
                                     for r in runs[0]],
            "cpu_loss": [m["loss"] for m in rec["metrics"]],
            **max(worst, key=lambda x: x["amplified"])}


def _train_mesh_whole_carry(red: list, whole: list, rcfg) -> dict:
    """8e's check h: check c's 2 steps (the reduced config, 2 layers, its
    layer-boundary carry the rank's S / tp sequence rows under
    ``"act_seq"``) against the same steps on the same ranks under
    ``rules_for(..., overrides=TRAIN_MESH_WHOLE_CARRY)``: loss and grad
    norm bits, params and moments bit for bit on every rank; the layout
    log shows each forward's carries as rows of S / tp with it, whole
    without it.  Its seconds are the whole-carry case's wall plus the
    comparison."""
    t = time.perf_counter()
    tp = TRAIN_MESH[1]
    rows = TRAIN_MESH_BATCH // TRAIN_MESH_MICRO // TRAIN_MESH[0]
    S, D = TRAIN_MESH_REDUCED_SEQ, rcfg.d_model
    n = rcfg.n_layers * TRAIN_MESH_MICRO * TRAIN_MESH_STEPS
    for i, (a, b) in enumerate(zip(red, whole)):
        la, lb = a["legs"][0], b["legs"][0]
        if la["bits"] != lb["bits"]:
            raise AssertionError(f"train 8e check h rank {i}: loss or grad "
                                 f"norm bits differ with the whole carry")
        for path, x in la["state"].items():
            if not np.array_equal(x, lb["state"][path]):
                raise AssertionError(f"train 8e check h rank {i}: {path} "
                                     f"differs with the whole carry")
        # check c's leg comes first in the case's log (then d's reshard)
        if a["carries"][:n] != [("rows", (rows, S // tp, D))] * n or \
                b["carries"] != [("whole", (rows, S, D))] * n:
            raise AssertionError(f"train 8e check h rank {i}: carries "
                                 f"{a['carries'][:2]} / {b['carries'][:2]}")
    return {"mesh": list(TRAIN_MESH), "layers": rcfg.n_layers,
            "steps": TRAIN_MESH_STEPS, "carry": list(red[0]["carries"][1]),
            "whole": list(whole[0]["carries"][1]),
            "loss": red[0]["legs"][0]["loss"],
            "bitwise": True, "seconds": max(r["wall_s"] for r in whole)
            + time.perf_counter() - t}


def phase_train_mesh(torch, ranks: list, ctx: dict, card: str) -> dict:
    """Phase 8e: training on a mesh, from the per-rank results of the
    world phase 7e shared (:func:`train_mesh_cases`).  Checks: a. every
    rank the same loss and grad-norm bits, and every replica of a leaf
    (the ranks along an axis it is not split over) the same bits (sha1 of
    params, moments); b. the mesh's first step's loss and grad norm within
    TRAIN_MESH_LOSS_RTOL and TRAIN_MESH_NORM_RTOL of one card's
    (``launch/train.run`` here, the same argv and cut); c. the reduced
    config's 2 steps on TRAIN_MESH against the port on the CPU; d. its
    checkpoint resharded onto RESHARD_MESH and 2 more steps against 4 CPU
    steps; e. B6 twice per attention layer and microbatch on every rank
    (forward and remat), threefry TRAIN_DRAWS a step, nothing else; f.
    the reduced moe config (:func:`_train_mesh_moe`) and g. the
    reduced recurrent configs (:func:`_train_mesh_stepwise`), and the
    hybrid with 10 / 1 heads at MESH, its attention "seq"; h. check c's
    steps with the carry whole, bit for bit (:func:`_train_mesh_whole_carry`).
    One ``train mesh``
    line per rank: step wall, tokens/s, collectives a step, peak GB, B6
    launches."""
    import dataclasses

    from repro_torch.configs.shapes import ShapeConfig
    from repro_torch.convert import train_state_from_arrays
    from repro_torch.launch import train as tlaunch
    from repro_torch.models.factory import build_model
    from repro_torch.train.data import batch_for_step
    from repro_torch.train.optimizer import AdamW, constant
    from repro_torch.train.train_step import make_train_step

    full, red, moe, whole = ([r[i] for r in ranks] for i in range(4))
    rec_runs = [r[4:] for r in ranks]          # per rank, check g's cases
    steps = TRAIN_MESH_STEPS
    _check_train_mesh_launches(full)
    # a. every rank the same metric bits; replicas the same leaves
    if any(r["bits"] != full[0]["bits"] for r in full[1:]):
        raise AssertionError("train 8e: the ranks' loss or grad norm bits "
                             "differ")
    args = tlaunch.parse_args(ctx["argv"])
    cfg = dataclasses.replace(tlaunch.config_for(args),
                              n_layers=TRAIN_MESH_LAYERS)
    specs = _shard_specs(cfg, TRAIN_MESH)
    replicas = 0
    for path, spec in specs.items():
        split = {a for e in spec if e for a in
                 ((e,) if isinstance(e, str) else e)}
        seen = {}
        for r in full:
            where = tuple(r["coords"][a] for a in ("data", "model")
                          if a in split)
            for pre in (".params::", ".opt::.mu::", ".opt::.nu::"):
                d = r["digests"][pre + path]
                if (pre, where) in seen:
                    replicas += 1
                    if seen[(pre, where)] != d:
                        raise AssertionError(f"train 8e: replicas of "
                                             f"{pre}{path} differ")
                seen[(pre, where)] = d
    # b. one card's first step of the same cut config, argv and state
    torch.cuda.empty_cache()
    one_args = tlaunch.parse_args(ctx["argv"][:2] + ["--steps", "1"]
                                  + ctx["argv"][4:])
    state, stats = tlaunch.run(one_args, cfg, log=lambda m: None)
    one = stats.history[0]
    del state
    torch.cuda.empty_cache()
    mesh0 = full[0]["history"][0]
    check_b = {"loss": [mesh0["loss"], one["loss"]],
               "grad_norm": [mesh0["grad_norm"], one["grad_norm"]],
               "loss_rel": abs(mesh0["loss"] - one["loss"]) / abs(one["loss"]),
               "norm_rel": abs(mesh0["grad_norm"] - one["grad_norm"])
               / one["grad_norm"],
               "tol": [TRAIN_MESH_LOSS_RTOL, TRAIN_MESH_NORM_RTOL]}
    if not (check_b["loss_rel"] <= TRAIN_MESH_LOSS_RTOL
            and check_b["norm_rel"] <= TRAIN_MESH_NORM_RTOL):
        raise AssertionError(f"train 8e check b: {check_b}")
    # c and d. the reduced config: the ranks against the port on the CPU
    rcfg = ctx["rcfg"]
    cpu = train_state_from_arrays(**ctx["state"], device="cpu")
    step = make_train_step(build_model(rcfg), AdamW(),
                           constant(TRAIN_MESH_REDUCED_LR),
                           microbatches=TRAIN_MESH_MICRO)
    shape = ShapeConfig("t", "train", TRAIN_MESH_REDUCED_SEQ,
                        TRAIN_MESH_BATCH)
    checks = {}
    for leg, (mesh_shape, label) in enumerate(((TRAIN_MESH, "c"),
                                               (RESHARD_MESH, "d"))):
        for s in range(leg * steps, (leg + 1) * steps):
            cpu, m = step(cpu, batch_for_step(rcfg, shape, s, device="cpu"))
        rspecs = _shard_specs(rcfg, mesh_shape)
        n = (leg + 1) * steps
        res = [_adamw_close(r["legs"][leg]["state"], cpu, rspecs,
                            mesh_shape, i, n, TRAIN_MESH_REDUCED_LR)
               for i, r in enumerate(red)]
        loss = red[0]["legs"][leg]["loss"][-1]
        checks[label] = {"mesh": list(mesh_shape), "steps": n,
                         "loss": loss, "cpu_loss": float(m["loss"]),
                         **max(res, key=lambda x: x["amplified"])}
        np.testing.assert_allclose(loss, float(m["loss"]), **TRAIN_F32_TOL)
    checks["f"] = _train_mesh_moe(torch, moe, ctx)
    checks["g"], j = [], 0
    for rec in ctx["rec"]:
        n = len(rec["metrics"])
        checks["g"].append(_train_mesh_stepwise(
            torch, [r[j:j + n] for r in rec_runs], rec))
        j += n
    if set(checks["g"][-1]["layouts"]) != {"seq"}:
        raise AssertionError(f"train 8e check g: the 10-head hybrid's "
                             f"attention ran {checks['g'][-1]['layouts']}, "
                             f"want seq")
    checks["h"] = _train_mesh_whole_carry(red, whole, rcfg)
    import shutil
    shutil.rmtree(ctx["ckdir"], ignore_errors=True)
    tokens = TRAIN_MESH_BATCH * TRAIN_MESH_SEQ
    lines = []
    for i, r in enumerate(full):
        line = {"rank": i, "card": card, "mesh": list(TRAIN_MESH),
                "layers": TRAIN_MESH_LAYERS, "step_s": r["step_s"],
                "tokens_per_s": [tokens / t for t in r["step_s"]],
                "collectives_per_step": r["calls"],
                "collective_s_per_step": r["collective_s"],
                "peak_gb": (r["peak_mem_bytes"] or 0) / 1e9,
                "peak_reserved_gb": (r["peak_reserved_bytes"] or 0) / 1e9,
                "b6_launches": r["launches"]["flash_attention"],
                "carry": r["carries"][0] if r["carries"] else None,
                "loss": [h["loss"] for h in r["history"]],
                "grad_norm": [h["grad_norm"] for h in r["history"]],
                "case_wall_s": r["wall_s"]}
        log("train mesh: " + json.dumps(line))
        lines.append(line)
    res = {"arch": LM_ARCH, "layers": TRAIN_MESH_LAYERS, "check_a_replicas":
           replicas, "check_b": check_b, "check_c": checks["c"],
           "check_d": checks["d"], "check_f_moe": checks["f"],
           "check_g_recurrent": checks["g"], "check_h_act_seq": checks["h"],
           "reduced_walls_s": [r["wall_s"] for r in red],
           "moe_walls_s": [r["wall_s"] for r in moe],
           "recurrent_walls_s": [[r["wall_s"] for r in runs]
                                 for runs in rec_runs]}
    log("train 8e checks: " + json.dumps(res))
    return {"launches": sum(r["launches"]["flash_attention"] for r in full),
            "ranks": lines, **res}


class Counters:
    """Every kernel wrapper's launch count, reset and read together."""

    def __init__(self):
        from repro_torch.kernels.flash_attention import ops as faops
        from repro_torch.kernels.frontier import ops as fops
        from repro_torch.kernels.fused_visit import ops as fvops
        from repro_torch.kernels.minplus import ops as mops
        from repro_torch.kernels.ppr_push import ops as pops
        from repro_torch.kernels.threefry import ops as tfops
        self.mods = (mops, fops, pops, fvops, faops, tfops)

    def reset(self) -> None:
        for m in self.mods:
            m.reset_launches()

    def read(self) -> dict:
        return {k: v for m in self.mods for k, v in m.LAUNCHES.items()}


# ---------------------------------------------------------------------------
# phase 9: the dry run against the card


def _dry_roofline(rec, mesh_shape) -> dict:
    from repro_torch.launch import roofline
    shape, names = mesh_shape
    t = roofline.terms(rec["flops"], rec["bytes"],
                       rec["collectives"]["by_axis"], shape, names)
    return {**{k + "_s": v for k, v in t.items()},
            "bound_s": max(t.values()), "dominant": max(t, key=t.get)}


def phase_dryrun(torch, train: dict, lm_mesh: dict, moe_mesh: dict,
                 card: str) -> dict:
    """Phase 9 (module docstring): 8d's B6 launches a step times
    TRAIN_STEPS equal to the launches 8d counted, and every rank's
    collectives of one decode step of 7e's and 7f's models equal to the
    ``Mesh.calls`` a decode step that rank counted in the world; the
    predicted peak beside the measured one with their ratio (7e, 7f: the
    peak allocated over one decode step on the rank), the
    roofline's bound (the card's published rates, ``launch/roofline.py``)
    beside the measured step wall."""
    import dataclasses

    from repro_torch.configs.base import get_config
    from repro_torch.configs.shapes import ShapeConfig
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import DryMesh

    t0 = time.perf_counter()
    hbm = torch.cuda.get_device_properties(0).total_memory
    out = {"card": card, "total_memory": hbm}
    full = train["full"]
    cfg = dataclasses.replace(get_config(LM_ARCH),
                              n_layers=full["n_layers"],
                              microbatches=TRAIN_MICRO)
    rec = dryrun.dry_step(cfg, ShapeConfig("8d", "train", TRAIN_SEQ,
                                           TRAIN_BATCH))
    b6 = rec["launches"].get("flash_attention", 0)
    if b6 * TRAIN_STEPS != full["launches"] or \
            b6 != full["flash_launches_per_step"]:
        raise AssertionError(f"dry run 8d: {b6} B6 launches a step, the "
                             f"card {full['launches']} over {TRAIN_STEPS} "
                             f"steps")
    step = full["step_s"][1:] or full["step_s"]
    measured = full["max_memory_allocated"]
    out["8d"] = {"arch": cfg.name, "layers": cfg.n_layers,
                 "b6_launches_a_step": b6,
                 "b6_launches_counted": full["launches"],
                 "steps": TRAIN_STEPS, "flops": rec["flops"],
                 "bytes": rec["bytes"], "ops": rec["ops"],
                 "peak_bytes": rec["peak_bytes"],
                 "max_memory_allocated": measured,
                 "peak_ratio": rec["peak_bytes"] / measured,
                 **_dry_roofline(rec, ((1,), ("model",))),
                 "step_s_mean": float(np.mean(step)),
                 "dry_s": rec["seconds"]}
    out["8d"]["bound_over_step"] = (out["8d"]["bound_s"]
                                    / out["8d"]["step_s_mean"])
    for key, arch, res in (("7e", LM_ARCH, lm_mesh),
                           ("7f", MOE_ARCH, moe_mesh)):
        cfg = dataclasses.replace(get_config(arch), n_layers=res["layers"])
        shape = ShapeConfig(key, "decode", LM_MAX_LEN, LM_BATCH)
        rows = []
        for r in res["ranks"]:
            mesh = DryMesh(MESH, rank=r["rank"])
            rec = dryrun.dry_step(cfg, shape, mesh)
            calls = rec["collectives"]["calls"]
            if calls != r["collectives_per_decode_step"]:
                raise AssertionError(
                    f"dry run {key} rank {r['rank']}: {calls} collectives "
                    f"a decode step, the world counted "
                    f"{r['collectives_per_decode_step']}")
            measured = r["decode_step_peak_bytes"]
            wall = r["decode_s"] / max(r["decode_steps"], 1)
            roof = _dry_roofline(rec, (MESH, ("data", "model")))
            rows.append({"rank": r["rank"], "collectives": calls,
                         "collectives_counted":
                             r["collectives_per_decode_step"],
                         "collective_bytes": rec["collectives"]["bytes"],
                         "by_kind": rec["collectives"]["by_kind"],
                         "peak_bytes": rec["peak_bytes"],
                         "decode_step_max_memory_allocated": measured,
                         "peak_ratio": rec["peak_bytes"] / measured,
                         **roof, "decode_step_s": wall,
                         "bound_over_step": roof["bound_s"] / wall,
                         "dry_s": rec["seconds"]})
        out[key] = {"arch": arch, "layers": cfg.n_layers,
                    "mesh": list(MESH), "batch": LM_BATCH,
                    "max_len": LM_MAX_LEN, "ranks": rows}
    out["seconds"] = time.perf_counter() - t0
    log("dry run vs card: " + json.dumps(out))
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import repro_torch
    if not os.path.abspath(repro_torch.__file__).startswith(ROOT):
        print("chip_smoke: repro_torch is not beside this script",
              file=sys.stderr)
        return 2
    from repro_torch.kernels import _build
    from repro_torch.kernels.minplus import ops
    t_start = time.perf_counter()

    t = time.perf_counter()
    built = _build.build_all()
    log(f"build: {time.perf_counter() - t:.1f} s " + json.dumps(
        {k: round(v["seconds"], 2) for k, v in built.items()}))
    for name, info in built.items():
        for line in info["log"].splitlines():
            if "Compiling entry function" in line:
                log(f"  {name}: {_kernel_name(line.split(chr(39))[1])}")
            elif "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device "
        f"{torch.cuda.get_device_name(0)} total_memory "
        f"{torch.cuda.get_device_properties(0).total_memory}")

    phase_s = {"build": round(time.perf_counter() - t_start, 1)}

    def timed(name, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        phase_s[name] = round(time.perf_counter() - t, 1)
        log(f"phase {name}: {phase_s[name]} s")
        return out

    rng = np.random.default_rng(0)
    krows = {name: row["single"] for name, row in timed(
        "3 kernels", phase_kernels, torch, ops, rng).items()}
    for name, row in timed("3d gathered", phase_gathered, torch, ops,
                           krows["minplus"]["floor_ms"]).items():
        krows[name]["gathered"] = row
    krows.update(timed("3b tiles", phase_tiles, torch, rng))
    fused_rows = timed("3c fused kernel", phase_fused_kernel, torch)
    krows["fused_visit"] = {**fused_rows["sssp"], "push": fused_rows["ppr"]}
    threefry = timed("3e threefry", phase_threefry, torch)
    timed("3f contracts", phase_contracts)
    timed("4 parity", phase_parity, Counters())
    launches, ctx = timed("5 path", phase_path, torch, Counters())
    timed("5c kinds, baselines, tune, apps", phase_kinds, torch, Counters(),
          ctx, launches)
    timed("5d rw, random, streaming", phase_random, torch, Counters(), ctx,
          launches)
    timed("5e serve", phase_serve, torch, Counters(), ctx, launches)
    timed("5f distributed", phase_distributed, torch, ctx, launches, card)
    del ctx
    torch.cuda.empty_cache()
    krows["flash_attention"] = timed("6 flash", phase_flash, torch)
    from repro_torch.kernels.flash_attention import ops as faops
    f32_from = faops.FP32_LAUNCHES["flash_fp32_kernel"]
    lm = timed("7 lm", phase_lm, torch, Counters())
    lm_rec = timed("7b lm recurrent", phase_lm_recurrent, torch, Counters())
    rec_ref = lm_rec.pop("mesh_ref")
    lm_moe = timed("7c lm moe", phase_lm_moe, torch, Counters())
    lm_last = timed("7d lm vlm, encdec", phase_lm_vlm_encdec, torch,
                    Counters())
    train_cases, train_ctx = train_mesh_cases(torch)
    moe_cases, moe_ctx = moe_mesh_cases(torch, lm_moe.pop("mesh_ref"))
    rec_cases, rec_ctx = recurrent_mesh_cases(torch, rec_ref)
    lm_mesh = timed("7e lm mesh (and 7f's, 7g's and 8e's ranks)",
                    phase_lm_mesh, torch, lm["mesh_ref"], card, train_cases,
                    moe_cases, rec_cases)
    moe_mesh = timed("7f moe mesh checks", phase_lm_moe_mesh, torch,
                     lm_mesh.pop("moe_ranks"), moe_ctx, card)
    rec_mesh = timed("7g recurrent mesh checks", phase_lm_recurrent_mesh,
                     torch, lm_mesh.pop("rec_ranks"), rec_ctx, card)
    train = timed("8 train", phase_train, torch, Counters())
    train_mesh = timed("8e train mesh", phase_train_mesh, torch,
                       lm_mesh.pop("train_ranks"), train_ctx, card)
    timed("9 dry run", phase_dryrun, torch, train, lm_mesh, moe_mesh, card)
    # float32 launches of phases 7-8: this process's (checks c, the
    # one-card references of 7f and 7g, phase 8's float32 steps and
    # checks) and 7f's and 7g's float32 ranks'
    f32_launches = {
        "phases 7-8, this process":
            faops.FP32_LAUNCHES["flash_fp32_kernel"] - f32_from,
        "7f float32 ranks": moe_mesh.pop("f32_launches"),
        "7g float32 ranks": rec_mesh.pop("f32_launches")}
    launches["flash_attention"] = lm["launches"] + sum(
        r["launches"] for r in lm_rec.values()) + lm_moe["launches"] + sum(
        r["launches"] for r in lm_last.values()) + train["launches"] + \
        lm_mesh["launches"] + moe_mesh["launches"] + \
        rec_mesh["launches"] + train_mesh["launches"]
    launches["threefry"] = launches.get("threefry", 0) + \
        train["full"]["counts"]["threefry"]

    csrc = "src/repro_torch/kernels/csrc/"
    kernels = {
        "minplus": ("minplus.cu", "src/repro/kernels/minplus/minplus.py:105",
                    "minplus"),
        "masked_matmul": ("minplus.cu",
                          "src/repro/kernels/minplus/minplus.py:135",
                          "masked_matmul"),
        "frontier": ("frontier.cu",
                     "src/repro/kernels/frontier/frontier.py:69",
                     "frontier_in_fused"),
        "ppr_push": ("ppr_push.cu", "src/repro/kernels/ppr_push/push.py:79",
                     "ppr_push_in_fused"),
        "fused_visit": ("fused_visit.cu",
                        "src/repro/kernels/fused_visit/fused.py:465",
                        "fused_visit"),
        "flash_attention": ("flash_attention.cu",
                            "src/repro/kernels/flash_attention/flash.py:75",
                            "flash_attention"),
    }
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    table = []
    for name, (src, replaces, count) in kernels.items():
        row = {"name": name, "route": "cuda", "source": csrc + src,
               "replaces": replaces, "launches": launches[count],
               **{k: krows[name][k] for k in keys}}
        if row["library_ms"] is None:
            row["library_note"] = "no one-call PyTorch equivalent"
        if count != name:
            # the tile runs inside every fused launch of its algebra; its
            # own entry is not launched on the path
            row["launches_of"] = "fused_visit"
        if name in ("minplus", "masked_matmul"):
            row["ms_is"] = ("card ms per launch, S = 1, at the road "
                            "density (~4 finite entries a column), CUDA "
                            "graph")
            row.update({k: krows[name][k] for k in (
                "ms_by_density", "bound_ms_by_density", "floor_ms",
                "dense_tile_bound_ms", "gathered")})
        if name == "fused_visit":
            row["ms_is"] = ("card ms per visit (one K=64 chunk's launch, "
                            "CUDA graph), at the path's cluster size")
            row["launches_of"] = "one per K-visit chunk (= host_syncs)"
            extra = ("cluster", "ms_by_cluster", "ms_one_launch_per_visit",
                     "ms_random", "bytes_per_visit",
                     "dense_tile_bytes_per_visit", "dense_tile_bound_ms")
            row.update({k: krows[name][k] for k in extra})
            row["ms_sparse"] = krows[name]["ms_sparse"]
            row["push"] = {k: krows[name]["push"][k] for k in keys + extra}
        if name == "flash_attention":
            row["ms_is"] = ("card ms per launch at (Sq, Skv, q_offset) = "
                            "(4096, 4096, 0), bf16, CUDA graph")
            row["launches_of"] = ("the LM paths' prefills (7e's, 7f's "
                                  "and 7g's summed over their four "
                                  "ranks) and phase 8's "
                                  "training forwards and remat "
                                  "recomputes (8e's summed over its four "
                                  "ranks), all of them flash_tc_kernel "
                                  "(bf16, tensor cores)")
            row["launches_by_arch"] = {
                LM_ARCH: lm["launches"],
                **{a: r["launches"] for a, r in lm_rec.items()},
                MOE_ARCH: lm_moe["launches"],
                **{a: r["launches"] for a, r in lm_last.items()},
                MESH_KEY: lm_mesh["launches"],
                MOE_MESH_KEY: moe_mesh["launches"],
                RECURRENT_MESH_KEY: rec_mesh["launches"],
                LM_ARCH + " train": train["launches"],
                TRAIN_MESH_KEY: train_mesh["launches"]}
            # the training path's backward is the plain flash backward
            # (FlashAttentionFn), timed at the training shape beside SDPA's
            # forward + backward
            row["train"] = {k: train["grad"][k] for k in (
                "fwd_ms", "bwd_ms", "plain_fwd_bwd_ms", "sdpa_fwd_bwd_ms")}
            row["timed_at"] = krows[name]["timed_at"]
            # the FP32-core kernel (float32 inputs): not on the served
            # paths, which are bf16; the float32 gates drive it
            row["f32"] = {"kernel": "flash_fp32_kernel",
                          "launches": sum(f32_launches.values()),
                          "launches_by_phase": f32_launches,
                          **{k: krows[name]["f32"][k] for k in keys}}
            # recurrentgemma-2b's shape (hd 256, MQA, window 2048),
            # qwen3-moe-30b-a3b's (32 / 4 heads of 128), paligemma-3b's
            # (hd 256, 8 / 1, the prefix) and whisper-base's (hd 64, the
            # padded frames): their bf16 launches are the hybrid's
            # prefills (7b), the moe's (7c) and the vlm's and encdec's (7d)
            by_arch = row["launches_by_arch"]
            for key, arch in FLASH_ROW_KEYS.items():
                # row 6k's shapes are 7g's ranks' ("seq"; check f's
                # control runs 6c's whole shape there)
                n = by_arch[RECURRENT_MESH_KEY if arch == RG_SEQ_KEY
                            else arch]
                at = krows[name][key]
                row[key] = {
                    "arch": arch, "timed_at": at["timed_at"], "launches": n,
                    **{k: at[k] for k in keys},
                    "ms_by_shape": at["ms_by_shape"],
                    "f32": {"launches_of": "the f32 row's count",
                            **{k: at["f32"][k] for k in keys}}}
        table.append(row)
    # fg_threefry is no port of a Pallas kernel (the reference leaves
    # threefry to XLA): its own line, beside the table
    threefry["launches"] = launches.get("threefry", 0)
    threefry["launches_of"] = ("rw's step rounds (engine, baselines, "
                               "streaming lanes) and the unfused random "
                               "schedule's split and draw, 5d; the rw "
                               "serving pools, 5e; the distributed rw's "
                               "walkers, summed over ranks, 5f; the "
                               "training batches, 8d")
    idle = [r["name"] for r in table + [threefry] if not r["launches"]]
    if idle:
        raise AssertionError(f"kernels of the path launched no time: {idle}")
    log(json.dumps({"threefry": threefry}))
    log(json.dumps({"kernels": table}))
    log("phase seconds: " + json.dumps(phase_s))
    log(f"total: {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
