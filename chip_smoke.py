"""Smoke run of the PyTorch port on one NVIDIA GPU: build, check, roll out, train, stream, serve.

    python3 chip_smoke.py [--seed 1234] [--out results.json]

Phases, each printing one line per result; any failure exits nonzero:

1. device   -- needs CUDA (never continues on the CPU); prints the card's
               name and power limit, nvcc's and torch's versions;
2. build    -- compiles the CUDA kernels from ``fluid_llm_tpu_torch/csrc``;
3. kernels  -- each kernel against its plain PyTorch twin in bf16, at the
               rollout's shapes (exact attention, slot attention at the
               hidden convs' C 48 and the out conv's C 3), the training
               step's (flash forward, dq, dk/dv at (8, 601, 768); slot
               attention at C 48 and C 3 and its backward at 80 frames),
               a notf rollout step's (flash forward, dq, dk/dv at (8, 661,
               768) with 1 and 9 of the window's 10 frames valid; slot
               attention and its backward at 8 frames, C 48 and C 3),
               the streaming step's (slab decode attention over 11 slots
               of 64 rows, H 12: a wrapped ring, the first decode with 9
               slots unwritten, the 61-token prefill) and the serving linears'
               (int8 matmul w8a8 at the flagship's 60 and 61 rows and
               OPT's 661, w8a16 at OPT's 661 and 60 with its biases and at
               the flagship's 60), the stacked streaming step's (indexed
               linear at its five (M, K, N), M 60 and 61, layers 0 and 11
               of 12) and ``attn_impl="short"``'s (short attention at the
               training step's (8, 601, 768) and the rollout's (1, 661,
               768) with 7 of 10 window frames invalid): relative
               L2 error (bound REL_TOL) and device time per call, kernel,
               plain and the PyTorch library call that computes the same
               function (``library_ms``: ``scaled_dot_product_attention``
               with the same mask; its backward as device time, captured in
               a CUDA graph, with the backend that served it, beside dq +
               dk/dv; ``torch._int_mm`` on the
               quantised activations; bf16 ``F.linear`` on the weight
               already dequantised, or on the host-indexed view ``w[li]``),
               beside ``bound_ms``: the larger of the
               bytes moved over 3.35 TB/s and the operations over the peak
               of their type (989 bf16, 1,979 int8, 67 f32 T/s; H100 SXM);
               exact attention, the flash forward (its lse within
               LSE_TOL), the slab decode, the indexed linear, w8a8, w8a16,
               short attention, the flash dq and dk/dv, the slot-attention
               forward (also from a CUDA-graph replay) and backward and the
               segment kernels also repeated bit for bit, all but the sum
               with their launch geometry, and the segment
               sum equal bit for bit to a CPU walk of its CSR (each row's
               edges ascending, added in f32 from 0); then ("[plans]"
               lines) every launch plan of the indexed linear (column tile,
               K split) at the stacked streaming step's four shapes (M 60),
               of w8a16 (token tile, K split) at its six main-path shapes,
               of w8a8 (column tile, K split) at its nine above (each equal
               to the twin, beside ``_int_mm`` and w8a16), of short
               attention (64 or 128 query rows a block) at its two, of the
               slot forward (strip, column tile, ring, group, rows a unit)
               at its four ((1 or 80, 240, 64, 48 or 3)), of the segment
               gather (loads a lane in flight, warps a block, grid) at F
               128, 2 and 1 (bit for bit) and, for the bf16 segment sum's
               ring, its plan (edge rows a stage, stages, rows a warp,
               warps a block) and each plan one step from it at F 128 by
               senders and by receivers and F 512 by member (bit for bit
               the CSR walk), each against the twin and
               timed (w8a16 and the indexed linear beside the library
               call): the tables ``indexed_linear.plan``,
               ``quant_matmul.plan``, ``quant_matmul.w8a8_plan``,
               ``short_attention.plan``, ``grid_gnn_fused.fwd_plan``,
               ``segment_ops.gather_plan`` and ``segment_ops.sum_plan`` are
               read from; and the slab decode (the wrapped ring at H 6)
               and w8a16 at phase 24's eight rank-local shapes, in this one
               process, against the twin and timed beside SDPA and bf16
               ``F.linear`` ("[plans] rank-local").  The segment kernels
               also run at GraphViT's shapes (by the unsorted member ids of
               one collated batch at the EAGLE geometry: gathers at F 2, 64,
               128 and 512, sums at F 32, 128 and 512) and in bf16
               (MeshGraphNet's F 128 by the
               senders, GraphViT's F 512 by member: the sum equal bit for
               bit to the CSR walk in f32 rounded once, the gather to its
               twin); last the learned positions' add (f32) at the
               training step's 42 240 rows of 768 and the 350m rollout's
               21 120 of 1 024: the forward equal to its twin, the backward
               to the walk of its order (``pos_embed.grad_walk``) bit for
               bit, beside autograd through the twin and ``index_put_``;
4. slice    -- ``configs/training1.yaml`` (OPT-125m at full width and depth,
               DoRA r16 merged, BOS, see-init, MLPGNN, bf16) with seeded
               random weights on ``synthetic:1`` at seq_len 253, through
               ``inference.test_generate``: 251 rollout steps.  The launch
               counters must read 11x251 (exact attention, layers 0..10)
               and 3x251 (slot attention, 3 GATv2 convs); outputs finite;
               prints mean N-RMSE, wall time, peak device memory and
               rollout steps/s through the kernels and the twins in turns
               (each over a RATE_STEPS-step rollout);
5. agreement -- a 10-step rollout through the kernels against the same
               rollout through the plain twins (selected explicitly):
               relative error of the diffs per step, step 1 <= REL_TOL;
               then the device profile of a 20-step rollout (idle share);
6. train    -- the same configuration as published (DoRA unmerged, every
               configured dropout) on ``synthetic:8``, seed 1234: autoreg
               steps through ``Trainer`` on one repeated batch of 8, in
               turns through the kernels and through the twins.  Launches
               per kernel step must read 12 (flash forward, dq, dk/dv: 12
               layers) and 3 (slot attention forward and backward: 3
               convs); losses finite and the last below the first; every
               trainable group gets gradient.  Prints the median step ms of
               each, peak device memory and the device's idle share;
7. train agreement -- one step's loss and trainable gradient through the
               kernels against the twins, same weights, batch and dropout
               seed: loss within REL_TOL, gradient within GRAD_TOL;
8. entry points -- ``main`` for 2 epochs (checkpoints in a temporary
               folder), ``continue_train`` for 1 more, ``inference.main
               --checkpoint_dir`` rolls out from the last checkpoint:
               finite N-RMSE;
9. streaming -- phases 4 and 5 for ``configs/flagship_llama.yaml`` as
               published (the ``fluid/llama-125m`` backbone, 12 layers at
               d 768, rope_abs, absolute time, DoRA r16 merged, MLPGNN,
               bf16) through ``test_generate(streaming=True)``: 251 steps of
               the KV-cache rollout.  Launches must read 12x251 + 12 (slab
               decode attention, every layer of every step and of the
               prefill), 3x251 (slot attention) and 0 (exact attention);
10. flagship entry points -- ``main`` trains a copy of
               ``flagship_llama.yaml`` for 1 epoch on ``synthetic:8``;
               ``inference.main --streaming --checkpoint_dir`` serves 25
               steps from its checkpoint, then the exact ``inference.main``
               from the same checkpoint (LLaMA through the exact-window
               kernel), launches of each shown and checked;
11. serve   -- ``tools.serve.load_engine(quant="int8", qmm_mode="w8a8")``
               on phase 10's checkpoint (adapters merged, every backbone
               linear int8; w8a8 is the opt-in, w8a16 the default as in the
               JAX package; streaming auto-selected), ``serve`` on 127.0.0.1 in a
               thread, ``warmup``; one 251-step ``POST /v1/rollout`` and
               one of 50 steps from 3 context frames, ``GET /v1/stats``.
               Launches over one 251-step request must read 7x12x252
               (w8a8: q, k, v, o, gate, up, down of every layer of every
               step and of the prefill), 12x252 (slab decode), 3x251 (slot
               attention), 0 elsewhere; outputs finite, in physical units;
               10 steps kernels vs twins on the same int8 weights (step 1
               <= REL_TOL); int8 vs dense engines of the checkpoint over 3
               steps (mean |diff| / mean |dense| < 0.05); prints latency,
               steps/s, p50, peak memory, the backbone's weight bytes dense
               vs int8, and for a 50-step request of the int8 and of the
               dense engine the wall time, device time, device ops and
               idle share of each;
12. serve exact -- ``load_engine(quant="int8", qmm_mode="w8a16",
               streaming="off")`` on phase 8's ``training1.yaml``
               checkpoint (DoRA unmerged there): one 25-step request; w8a16
               launches 72 a step (6 linears x 12 layers), exact attention
               11 a step, w8a8 0; finite; 10 steps kernels vs twins on the
               same int8 weights (step 1 <= REL_TOL); the device time a
               step and idle share of a profiled 10-step rollout;
13. graph baselines -- ``baselines_cli.main`` at the EAGLE geometry
               (synthetic 84x42 mesh: 3 529 node rows and 20 480 edge rows a
               graph, batch 4, 15 blocks at width 128): MeshGraphNet for 2
               epochs of one step, validation, the 101-step eval of 4 test
               trajectories (N-RMSE, CSV, checkpoint), then GAT (4 heads) for
               1 epoch and a 26-step eval.  The segment gather and sum launches of each run
               must equal the count from the code (MeshGraphNet: 188 and 180
               a train step, 3 200 and 1 500 a 101-step trajectory); on one
               batch, a step's launches, step ms through the kernels and the
               twins in turns, the device profile, one step's loss and
               gradient kernels vs twins (f32, TF32 off; GRAPH_LOSS_TOL,
               GRAPH_GRAD_TOL) and the twins against themselves, and the
               segment sum repeated bit for bit (the kernels' whole step
               too, shown).  Phase 3 holds both kernels
               to their twins at these shapes (the gather bit for bit);
14. stacked streaming -- phase 9 with the weights prepared in the
               stacked-layer layout (``FLUID_SCAN_LAYERS=1``): launches must
               read 5x12x252 (indexed linear: qkv, o, gate, up, down of
               every layer of every step and of the prefill), 12x252 (slab
               decode), 3x251 (slot attention), 0 elsewhere; step 1 against
               the twins and against the unrolled layout of the same
               weights, each <= REL_TOL; the two layouts' steps/s in turns
               and each one's device and host profile;
15. short train -- phases 6 and 7 with the backbone built with
               ``attn_impl="short"``: 12 short-attention launches a step (the
               backward recomputes the twin), 0 flash, 3 and 3 slot;
16. short rollout -- phase 4 with ``attn_impl="short"`` on the stacked
               layout: 11x251 short-attention launches, 0 exact, 0 indexed
               linear (the stacked forward reads weight slices); step 1
               against the twins and the unrolled layout, the layouts timed
               in turns as in phase 14;
17. published data -- ``configs/training1.yaml`` as published on DeepMind
               MeshGraphNets-format pickles written into a temporary folder
               (cylinder: 8 train, 2 valid, 1 test trajectories of 1 900
               nodes x 600 steps; airfoil: 2 train, 1 valid of 5 000 nodes
               reaching beyond the crop box): training batches from
               ``num_workers`` 6 threads equal to serial ones bit for bit;
               batches/s serial and threaded over 3 x MAX_CACHE
               trajectories (every sample builds its trajectory);
               ``main`` for 1 epoch (load_dir, num_epochs and the checkpoint
               folder changed only): launches of one train step (12 flash
               forward, dq, dk/dv; 3 and 3 slot) and a 25-step validation
               rollout (11 exact, 3 slot a step); ``inference.main
               --checkpoint_dir`` 251 steps (11x251, 3x251), finite N-RMSE;
               the airfoil (13x7 patches after the trim): one autoreg step
               and a 10-step rollout, kernels vs twins (step 1 <= REL_TOL);
18. notf train -- that config with ``tf_mode: notf`` on those pickles, one
               batch of 8, ``parallel.remat`` off and on (``phase_notf``'s
               docstring has the launch counts: 99 flash forward, dq and
               dk/dv, 27 slot forward and backward a step; 198 and 54
               forwards with remat); losses finite and falling, every
               trainable group with gradient, step ms, peak memory, idle
               share; one step remat on vs off (bit for bit) and kernels
               vs twins (loss REL_TOL, each gradient leaf NOTF_LEAF_TOL,
               which the same gradient rounded to e4m3 must exceed on the
               median leaf);
19. switches -- on ``synthetic:8`` at full width, a few steps each, the loss
               falling: MLPGNN attention dropout 0.1 (0 slot launches in
               the training forward, 3 a step in the validation rollout),
               the CNN encoder and decoder, adafactor, and
               ``grad_accum_steps: 2`` (parameters unchanged after the first
               micro-batch, changed after the second);
20. graph baselines II -- at phase 13's geometry (synthetic 84x42 mesh,
               batch 4, 4 trajectories a split): GraphViT as published
               (w_size 512, clusters of 10, 4 heads) through
               ``baselines_cli.main`` for 2 epochs of one step, validation,
               the 51-step eval of 4 test trajectories, then ``--epoch 0``
               from its checkpoint (the same N-RMSE); segment launches equal
               to the count from the code (``graph_launches_per_step``); on
               one batch step ms through the kernels and the twins in turns,
               the device profile, one step kernels vs twins (f32,
               GRAPH_LOSS_TOL, GRAPH_GRAD_TOL).  ``--dtype bf16`` for
               MeshGraphNet and GraphViT, 1 epoch each (bf16 launches
               counted and nonzero), one step of each kernels vs twins
               (BF16_GRAPH_LOSS_TOL, BF16_GRAPH_GRAD_TOL), MeshGraphNet's
               step ms in bf16 and f32 in turns with the bf16 losses
               falling, and the device profile of each; DilResNet
               through ``baselines_cli`` on synthetic cylinder grids at
               238x238 (1 epoch, the 101-step eval, finite N-RMSE, its
               step ms); GATNet one forward and backward
               at the EAGLE edges, kernels vs twins;
21. MoE and quantized backbones -- ``configs/moe_cylinder.yaml`` as
               published (OPT-125m width, 6 layers, 4 experts top-2, cf
               1.25, bf16): the 251-step exact rollout through
               ``test_generate`` (the MoE final block runs whole: exact
               attention 6x251, slot 3x251), 50-step rates kernels and
               twins, 10 steps kernels vs twins each routing itself (step
               1 <= moe_bound: REL_TOL where no token flipped, wider by the
               flipped shares and the MoE output's share of the residual
               measured in the run), twins routed from the kernels' router
               probabilities (step 1 <= REL_TOL), the share of valid
               tokens routed to another expert set at step 1 <=
               MOE_FLIP_TOL; 4 autoreg steps through ``Trainer``
               (6 flash fwd/dq/dk-dv, 3 slot fwd/bwd a step; loss falling,
               ``moe_aux`` finite and positive, router and bank gradients),
               one expert_choice step (aux 0), ``main`` 1 epoch and
               ``inference --checkpoint_dir`` 25 steps; the flagship with a
               MoE MLP (4 experts top-2 cf 1.25) streamed 251 steps
               (slab decode 12x252) and ``apply_streaming`` over 5 frames
               against the banded dense forward (routing itself: moe_bound;
               from the dense forward's probabilities: REL_TOL); ``tools.serve --quant
               int8`` on the MoE checkpoint (25-step request: w8a16 4x6 a
               step, exact 6 a step; int8 vs dense < 0.05);
               ``training1.yaml`` trained over an nf4 (``llm_4bit_loading``),
               an int8 (w8a16 under autograd, 48 a step; w8a16 vs its
               twin on the step's 4808-row inputs and one step kernels vs
               twins, loss REL_TOL, gradient GRAD_TOL) and a bf16
               (``frozen_bf16``) frozen backbone: adapters move, frozen
               storage bit-identical, the nf4 checkpoint restored bit for
               bit; the flagship as int8 streamed 25 steps stacked and
               unrolled, equal bit for bit (w8a16 7x12x26, indexed 0);
22. weights in and out -- OPT-125m at full width and depth (12 layers,
               768, vocabulary 50 272, 2 050 position rows) written as an HF
               hub snapshot (``model.safetensors`` under HF's key names,
               drawn from the seed) into a temporary ``HF_HUB_CACHE``: the
               read and conversion seconds (``models/hf_import.py``), the
               read tensors equal to the written ones bit for bit; ``main``
               1 epoch of ``training1.yaml`` on ``synthetic:1`` imports it
               (the log says so; the checkpoint's frozen base equal to the
               written tensors bit for bit; BOS before the first step equal
               to ``embed_tokens[2]``; 12 flash fwd/dq/dk-dv, 3 slot bwd,
               3 + 3x25 slot fwd and 11x25 exact: one step and the
               validation); its model exported to a reference ``.pt``
               (``tools/reference_ckpt.export_state_dict``) and imported by
               ``python -m fluid_llm_tpu_torch.tools.reference_ckpt`` into a
               new run folder (its seconds); ``inference --checkpoint_dir``
               251 steps from both folders: per-step N-RMSE equal bit for
               bit, 11x251 exact and 3x251 slot launches each;
               ``tools.parity_harness --synthetic`` on the card (finite,
               reference null) and ``tools.postln_probe`` for OPT-125m on
               the CPU (finite R²);
23. parallel axes -- (a) ``python -m fluid_llm_tpu_torch.main --distributed
               --coordinator_address 127.0.0.1:<free port> --num_processes 1
               --process_id 0`` (one rank over nccl) on a copy of
               ``training1.yaml`` with 1 epoch, against the same run
               without ``--distributed``: logged losses, N-RMSE and launch
               counts equal bit for bit; (b) four ranks sharing the card
               over gloo (CUDA compute, collectives staged through host
               memory: nccl refuses two ranks on one device), each this
               script again (``--parallel-rank``), at the full width: one
               step on data 2 x model 2, fsdp 2 x model 2, pipe 2 (full
               fine-tuning), ring attention over model 2 and DoRA over an
               int8 frozen backbone on data 2 x model 2, each against the
               one-process step (loss REL_TOL, gradient GRAD_TOL),
               launches per rank (flash 12 a step at H 6, 24 a pipeline
               stage, 0 under the ring; slot 3 and 3; w8a16 48 at N/2 or
               K/2), the ranks' weights the parent's draw, a checkpoint written
               on the mesh and restored on it and in one process, and the
               25-step rollout of 2 trajectories on data 2 x model 2
               (exact attention 11x25 a rank at H 6) against one process
               (step 1 REL_TOL); the ranks' times labelled as from ranks
               sharing one card, not performance numbers;
24. expert axis and sharded serving -- inside phase 23's four ranks (their
               start-up paid once), against one-process references the
               parent writes first: (a) ``configs/moe_cylinder.yaml`` as
               published (OPT-125m width, 6 layers, 4 experts top-2, cf
               1.25, bf16, full fine-tuning) with its parallel keys set, one
               step on expert 4, data 2 x expert 2, model 2 x expert 2 and
               fsdp 2 x expert 2 (loss REL_TOL, gradient GRAD_TOL, moe_aux
               REL_TOL; flash 6 a step a rank, at H 6 under model 2; slot 3
               and 3; each rank's banks holding E/expert experts and its
               model and fsdp chunks), one expert_choice step on expert 2
               (aux 0), a checkpoint written on expert 4 and restored in one
               process (every tensor's SHA-1 equal), the 25-step MoE rollout
               of 4 trajectories on data 2 x expert 2 (exact attention 6x25,
               slot 3x25 a rank; step 1 REL_TOL); (b)
               ``configs/flagship_llama.yaml`` streamed 25 steps on data 2 x
               model 2 (6 heads a rank; slab decode 12x26, slot 3x25; step 1
               REL_TOL) and the slab decode at H 6 held to its twin on one
               call's inputs of each rank; (c) ``tools.serve`` over the four
               ranks with ``--quant int8`` (w8a16) on a flagship checkpoint
               written with model 2 (data 2 x model 2): rank 0 serves over
               HTTP, the others follow; ``/v1/info`` reports the mesh; a
               25-step request within REL_TOL of the one-process int8
               engine's reply, a second that fails on rank 1 before the
               rollout's first collective (its streaming cache out of
               memory) answered 500, a third equal to the first; w8a16
               7x12x26, slab decode 12x26, slot 3x25 in each rank's
               rollout; each rank's int8 storage equal bit for bit to
               its cut of the one-process quantization (w8a16 at the eight
               rank-local shapes, 60 and 61 rows: 768->384, 384->768,
               768->1024, 1024->768, is held to its twin and timed in
               phase 3's plans); (d) ``flagship_llama.yaml``
               fine-tuned in full (pipeline stages take no adapters)
               streamed 25 steps on pipe 2 x model 2 (each rank caches and
               runs its stage's 6 blocks at 6 heads, the hidden state
               handed stage to stage; slab decode 6x26, slot 3x25 a rank;
               step 1 REL_TOL against one process).  Every time of these
               ranks is of ranks sharing one card, not a performance number;
25. tools and core -- the native point locator (``core/_native.py``, g++)
               on the synthetic cylinder mesh at 238 equal to the NumPy
               locator (and through ``FLUID_LLM_TPU_NATIVE_LOCATOR=1``), both
               host times; ``core/cubic.resample_to_grid_cubic`` on the card
               (min_E gradients, 2 frames x 3 channels) within CUBIC_TOL of
               the f64 host evaluation; ``core/interp.resample_sequence`` on
               the card (10 frames x 3 channels) within RESAMPLE_TOL of the
               f64 numpy resample, timed, and ``to_grid`` equal to one of its
               frames bit for bit with the MeshInterp's mask;
               ``tools/plotting.plot_field`` raising ImportError and writing
               nothing where matplotlib is missing (writing its figure where
               it is present); ``tools/rollout_profile`` trace and
               trace_stream over TOOL_STEPS steps (device events
               summarised per category); ``tools/train_profile`` (3 traced
               steps, 12 flash dq a step); ``tools/flash_bench`` at L 661,
               1536, 4096 and 8192 against the twin (output REL_TOL, lse
               LSE_TOL, gradients REL_TOL) and timed; ``tools/watchdog``
               over ``training1.yaml`` for 2 epochs on ``synthetic:2``
               (batch 2, a 3-step validation) whose first child is killed
               (SIGKILL) by a wrapper passed as ``supervise(python=...)``
               once the first checkpoint is on disk (started in a thread
               before phase 23, beside whose ranks it runs, and waited for
               here): rc 0, one restart, ``continue_train`` from step_0,
               the newest checkpoint step_1; ``tools/ds_stats`` on phase
               17's 8 cylinder
               pickles, its means and stds against numpy over the raw
               fields.

Depth cut to keep the run inside its time (every check and path kept):
phases 18 and 20 run 2 notf steps a remat setting and one timed step a
turn; phases 4, 9, 14 and 16 time one RATE_STEPS-step (51) rollout
through the kernels and one through the twins where they timed 251-step
ones (phases 4 and 9 three, then two; 14 and 16 two; then 101 steps
each), and phases 14 and 16 each layout once over RATE_STEPS where they
timed 251 steps twice; phase 25's watchdog run goes beside phases 23-24;
phase 13's GAT evaluates 4 x 25 steps where it evaluated 4 x 100;
``device_ms`` replays its graph 15 times where it replayed it 25; phase
23 (a)'s process runs while (b)'s references are computed;
phase 11 posts one 251-step request (three, then two) and times one
50-step request of each engine (three, then two); phase 23 (a) trains 1
epoch where it trained 2, and (b)'s rollout runs 25 steps where it ran
251.  Every phase
prints its seconds ("[name] phase seconds"), the run all of them at the
end; ``--out`` writes them as ``phase_seconds``.  Phases 8 to 13 share
one temporary folder, removed at the end, phases 17 and 18 another, phase
20 a third, phase 21 a fourth, phase 22 a fifth and phases 23 and 24 a
sixth, phase 25 a seventh (phase 17's pickles kept for it).  Every phase
before 22 reads an empty ``HF_HUB_CACHE``, so ``main``
there trains the seeded draw whatever the host has cached.  An
exception inside a phase is recorded as a failure of that phase and the
run goes on; every failure is printed on stdout and stderr at the end, and
the run then exits 1 without a result.

The last line is ``{"ok": true, "device": {...}}``; the line before it the
``nvidia-smi`` name and power limit; before that one JSON line of kernel
results: the thirteen kernels, and the segment sum and gather in bf16 with
their launches from phase 20's two ``--dtype bf16`` runs.
"""

from __future__ import annotations

import argparse
import json
import logging
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import traceback
from unittest import mock

import torch

# Relative L2 bound, kernel vs twin, bf16.  The kernels keep scores, softmax
# weights and sums in f32 and round once; the twins round intermediates to
# bf16 (2^-8 ~ 3.9e-3 relative per rounding: attention probabilities, GATv2
# logits and weights).  Observed <= 6e-3 at these shapes (H100).
REL_TOL = 1e-2
# Relative L2 bound on the whole trainable gradient of one step, kernels vs
# twins: both run bf16 activations through 12 layers, and round attention
# differently (the twin its probabilities, the kernels p and ds as bf16
# tensor-core operands), so per-layer differences of a few 1e-3 compound
# through the backward over 12 layers and the decoder.
GRAD_TOL = 5e-2
# Absolute bound on the flash forward's row logsumexp against the twin's
# (f32 statistics on both sides; the kernel's exp2-domain max and log of the
# sum differ from torch.logsumexp by rounding only; observed ~1e-6).
LSE_TOL = 1e-4
STEPS = 251
RATE_STEPS = 51  # the timed rollouts' length (the window is full from step 10)
ROLLOUT_TOKENS = 11 * 60 + 1  # 10-frame window + see-init frame, 60 patches each, + BOS
TRAIN_BS = 8
TRAIN_TOKENS = 10 * 60 + 1  # 9 input frames + the see-init duplicate, 60 patches each, + BOS


def rel_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return ((a.float() - b.float()).norm() / b.float().norm()).item()


def device_ms(fn, inner: int = 10, n: int = 15, stream=None) -> float:
    """Device time of one call: ``inner`` calls captured in a CUDA graph,
    replayed ``n`` times between CUDA events; the median over ``inner``.
    The graph removes the host's launch gaps, which would otherwise be
    counted for kernels shorter than their launch overhead.  The warm-up
    and the capture run on ``stream`` (a new side stream by default)."""
    side = stream or torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up off the default stream
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for _ in range(inner):
            fn()
    graph.replay()
    times = []
    for _ in range(n):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def graph_replay(fn) -> torch.Tensor:
    """``fn``'s output from a CUDA graph that captured one call, replayed
    once (the capture runs on a side stream after one warm-up call)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        out = fn()
    graph.replay()
    torch.cuda.synchronize()
    return out


def event_ms(fn, n: int = 10) -> float:
    """Device time of one call between CUDA events, averaged over ``n``
    calls after a warm-up; for calls a CUDA graph cannot capture (a host
    synchronisation inside), launch gaps included."""
    for _ in range(3):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def sdpa_backward_ms(q, k, v, mask, dout, n_heads: int) -> tuple[float, str]:
    """Device time of the library's backward beside dq and dk/dv: autograd
    through one ``scaled_dot_product_attention`` call (the same mask),
    timed by :func:`device_ms`.  Autograd runs a backward on its forward's
    stream, so the forward, the warm-up and the capture share one side
    stream.  Returns the time and the SDPA backend that served it
    (``torch._fused_sdp_choice``) with the backward's largest device
    kernels (profiler, one call)."""
    from torch.nn.attention import SDPBackend

    heads = lambda t: t.unflatten(-1, (n_heads, -1)).transpose(1, 2)  # noqa: E731
    choice = torch._fused_sdp_choice(heads(q), heads(k), heads(v), attn_mask=mask)
    backend = next((b.name for b in SDPBackend.__members__.values() if int(b) == choice),
                   str(choice))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
        out, grad = sdpa(*leaves, mask, n_heads), heads(dout)
    step = lambda: torch.autograd.grad(out, leaves, grad, retain_graph=True)  # noqa: E731
    ms = device_ms(step, stream=side)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        with torch.cuda.stream(side):
            step()
        side.synchronize()
    kernels = sorted((e for e in prof.key_averages()
                      if e.device_type == torch.autograd.DeviceType.CUDA),
                     key=lambda e: -e.self_device_time_total)
    return ms, f"{backend}: {', '.join(_short(e.key) for e in kernels[:3])}"


# H100 SXM (NVIDIA data sheet, dense rates): HBM bytes/s and peak operations/s by type
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bf16": 989e12, "int8": 1979e12, "f32": 67e12}


def bound(n_bytes: float, ops: float, kind: str) -> dict:
    """The least time the card could take: the larger of ``n_bytes`` (each
    input read once, each output written once) over the memory rate and
    ``ops`` over the peak rate of their type; which of the two bounds it."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, ops / PEAK_OPS_PER_S[kind]
    return dict(bound_ms=max(t_bytes, t_ops) * 1e3,
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def sdpa(q, k, v, mask, n_heads: int):
    """The library call beside the attention kernels: packed (bs, L, H*hd)
    heads as (bs, H, L, hd) views, a boolean mask broadcast over heads."""
    heads = lambda t: t.unflatten(-1, (n_heads, -1)).transpose(1, 2)  # noqa: E731
    return torch.nn.functional.scaled_dot_product_attention(heads(q), heads(k), heads(v),
                                                            attn_mask=mask)


def run(cmd: list[str]) -> str:
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=60)
    return (res.stdout + res.stderr).strip()


def phase_device() -> dict:
    smi = run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"])
    print(f"[device] {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}; "
          f"nvidia-smi: {smi}")
    from fluid_llm_tpu_torch.ops import _build

    print(f"[device] nvcc: {run([_build._nvcc(), '--version']).splitlines()[-1]}")
    print(f"[device] torch {torch.__version__}, CUDA {torch.version.cuda}")
    return {"smi": smi, "name": torch.cuda.get_device_name(0)}


def phase_build() -> float:
    from fluid_llm_tpu_torch.ops import _build

    t0 = time.perf_counter()
    path = _build.build()
    _build.load()
    secs = time.perf_counter() - t0
    print(f"[build] {path.name} in {secs:.2f} s")
    name = "?"
    for line in path.with_suffix(".log").read_text().splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = _kernel_name(m.group(1))
        elif "spill" in line or "registers" in line:
            print(f"[build] ptxas {name}: {line.split(':', 1)[-1].strip()}")
    return secs


def _kernel_name(mangled: str) -> str:
    """``name<template args>`` of a mangled ``*_kernel`` entry: the source
    name that its length prefix spells out."""
    for d in re.finditer(r"\d+", mangled):
        for j in range(len(d.group())):  # "118slab...": the length may be "18"
            name = mangled[d.end():d.end() + int(d.group()[j:])]
            if name.endswith("_kernel"):
                args = re.match(r"I(\w+?)EE", mangled[d.end() + len(name):])
                return f"{name}<{args.group(1)}>" if args else name
    return mangled


def _slab_case(dev, state: str, g: torch.Generator):
    """Queries and a random 12-layer bf16 slab cache at the flagship's
    streaming shapes (R 10 frames of 60 tokens + 61 sinks: 11 slots of 64
    rows, H 12 x hd 64), read at layer 5.  ``wrapped``: 14 frames written,
    slot order != position order; ``first``: the first decode, ring slot 0
    and the sinks written; ``prefill``: the 61 sinks querying themselves,
    every ring slot unwritten."""
    from fluid_llm_tpu_torch.models import backbone as bb
    from fluid_llm_tpu_torch.ops import decode_attention as da

    cfg = bb.preset("fluid/llama-125m").replace(dtype=torch.bfloat16)
    R, frame, n_sink = 10, 60, 61
    cache = bb.init_streaming_cache(cfg, 1, n_sink, R, frame, device=dev)
    for name in ("k", "v"):
        cache[name].copy_((torch.randn(cache[name].shape, generator=g) * 0.5))
    base = lambda f: n_sink + f * frame  # noqa: E731
    ring = [-1] * R
    n_written = {"wrapped": R + 4, "first": 1, "prefill": 0}[state]
    for f in range(n_written):
        ring[f % R] = base(f)
    q0, P = (base(n_written - 1), frame) if n_written else (0, n_sink)
    cache["ring_pos"].copy_(torch.tensor(ring, dtype=torch.int32))
    cache["sink_pos"].copy_(torch.arange(n_sink, dtype=torch.int32))
    key_pos = da.pad_key_pos(bb.slab_key_positions(cache, frame))
    # q as the streaming step hands it over: rope'd heads, contiguous
    q = (torch.randn(1, P, cfg.d_model, generator=g) * 0.5).to(dev, torch.bfloat16)
    return q, cache, key_pos, torch.tensor([q0], dtype=torch.int32, device=dev), 5


def _allowed_causal(valid: torch.Tensor) -> torch.Tensor:
    """(bs, L, L) bool: ``backbone.make_masks``' rule, the kernels' mask."""
    L = valid.shape[1]
    causal = torch.ones(L, L, dtype=torch.bool, device=valid.device).tril()
    eye = torch.eye(L, dtype=torch.bool, device=valid.device)
    return (causal[None] & (valid != 0)[:, None, :]) | eye[None]


# the serving linears (mode, M, K, N, bias, on the mode's main path): the
# flagship's bias-free LLaMA linears (q/k/v/o 768x768, gate/up 768->2048,
# down 2048->768) at the streaming step's 60 rows and the prefill's 61;
# OPT-125m's biased ones (768x768, fc1 768->3072, fc2 3072->768) at the
# exact rollout's 661 rows and the sliced last block's 60 (q, o, fc1, fc2)
QMM_CASES = [
    ("w8a8", 60, 768, 768, False, True), ("w8a8", 60, 768, 2048, False, True),
    ("w8a8", 60, 2048, 768, False, True), ("w8a8", 61, 768, 768, False, True),
    ("w8a8", 61, 768, 2048, False, True), ("w8a8", 61, 2048, 768, False, True),
    ("w8a8", 661, 768, 768, True, False), ("w8a8", 661, 768, 3072, True, False),
    ("w8a8", 661, 3072, 768, True, False),
    ("w8a16", 661, 768, 768, True, True), ("w8a16", 661, 768, 3072, True, True),
    ("w8a16", 661, 3072, 768, True, True), ("w8a16", 60, 768, 768, True, True),
    ("w8a16", 60, 768, 3072, True, True), ("w8a16", 60, 3072, 768, True, True),
    ("w8a16", 60, 768, 2048, False, False), ("w8a16", 60, 2048, 768, False, False),
]


def phase_kernels(dev, failures: list) -> list[dict]:
    import torch.nn.functional as F

    from fluid_llm_tpu_torch.ops import _build
    from fluid_llm_tpu_torch.ops import decode_attention as da
    from fluid_llm_tpu_torch.ops import exact_attention as xa
    from fluid_llm_tpu_torch.ops import flash_attention as fa
    from fluid_llm_tpu_torch.ops import grid_gnn_fused as gf
    from fluid_llm_tpu_torch.ops import quant
    from fluid_llm_tpu_torch.ops import quant_matmul as qmm

    g = torch.Generator().manual_seed(0)
    rows = []
    for L, H, hd, n_invalid in [(ROLLOUT_TOKENS, 12, 64, 0), (ROLLOUT_TOKENS, 12, 64, 181),
                                (300, 16, 32, 37), (300, 6, 128, 0)]:
        D = H * hd
        # q/k/v as the backbone hands them over: column slices of one fused qkv
        qkv = (torch.randn(1, L, 3 * D, generator=g) * 0.5).to(dev, torch.bfloat16)
        q, k, v = qkv[..., :D], qkv[..., D:2 * D], qkv[..., 2 * D:]
        valid = (torch.arange(L)[None] >= n_invalid).int().to(dev)
        out = xa.causal_attention(q, k, v, valid, H, hd)
        ref = xa.causal_attention_ref(q, k, v, valid, H, hd)
        again = xa.causal_attention(q, k, v, valid, H, hd)
        twin_again = xa.causal_attention_ref(q, k, v, valid, H, hd)
        allowed = _allowed_causal(valid)
        torch.cuda.synchronize()
        rows.append(dict(
            kernel="exact_attention", shape=f"(1,{L},{D}) H{H} hd{hd} invalid{n_invalid}",
            main_path=(L == ROLLOUT_TOKENS), rel=rel_err(out, ref),
            max_abs_err=(out.float() - ref.float()).abs().max().item(),
            deterministic=bool(torch.equal(again, out)),
            twin_deterministic=bool(torch.equal(twin_again, ref)),
            geometry=f"{H} heads x 1 batch x {len(xa.query_tiles(L))} query tiles of "
                     f"{xa.TILE} rows",
            ms=device_ms(lambda: xa.causal_attention(q, k, v, valid, H, hd)),
            plain_ms=device_ms(lambda: xa.causal_attention_ref(q, k, v, valid, H, hd)),
            library_ms=device_ms(lambda: sdpa(q, k, v, allowed[:, None], H)),
            **bound(nbytes(q, k, v, valid, out), 4 * D * allowed.sum().item(), "bf16"),
        ))
    # the rollout's frame, the training step's 80 (8 samples x 10 frames) and
    # a notf rollout step's 8 (one frame of each sample), each at the hidden
    # convs' C 48 and the out conv's C 3
    for Bf, H, C in [(1, 1, 48), (1, 1, 3), (4, 2, 24), (TRAIN_BS * 10, 1, 48),
                     (TRAIN_BS * 10, 1, 3), (TRAIN_BS, 1, 48), (TRAIN_BS, 1, 3)]:
        xl, xr = (torch.randn(Bf, 240, 64, H * C, generator=g).to(dev, torch.bfloat16)
                  for _ in range(2))
        att = torch.randn(H, C, generator=g).to(dev, torch.bfloat16)
        out = gf.fused_slot_attention(xl, xr, att, H, C)
        ref = gf.slot_attention_ref(xl, xr, att, H, C)
        again = gf.fused_slot_attention(xl, xr, att, H, C)
        twin_again = gf.slot_attention_ref(xl, xr, att, H, C)
        replayed = graph_replay(lambda: gf.fused_slot_attention(xl, xr, att, H, C))
        torch.cuda.synchronize()
        strip, ytile, stages, group, unit_rows = gf.fwd_plan(Bf, 240, 64, H, C,
                                                             xl.element_size(),
                                                             _build.sm_count(dev))
        rows.append(dict(
            kernel="grid_slot_attention", shape=f"({Bf},240,64,{H * C}) H{H} C{C}",
            main_path=(H == 1), rel=rel_err(out, ref),
            max_abs_err=(out.float() - ref.float()).abs().max().item(),
            deterministic=bool(torch.equal(again, out) and torch.equal(replayed, out)),
            twin_deterministic=bool(torch.equal(twin_again, ref)),
            geometry=f"{gf.fwd_blocks(Bf, 240, 64, strip, ytile)} blocks ({Bf} frames x "
                     f"{len(gf.strips(240, strip))} strips of {strip} rows x "
                     f"{-(-64 // ytile)} column tiles of {ytile}), a ring of {stages} units "
                     f"of {unit_rows} rows, {gf.fwd_threads(ytile, H, group, unit_rows)} "
                     f"threads ({group} a (pixel, head))",
            ms=device_ms(lambda: gf.fused_slot_attention(xl, xr, att, H, C)),
            plain_ms=device_ms(lambda: gf.slot_attention_ref(xl, xr, att, H, C)),
            # per (pixel, channel): 5 slots of add, leaky relu, logit, weight
            library_ms=None, **bound(nbytes(xl, xr, att, out), 35 * xl.numel(), "f32"),
        ))
    # the training step's (8, 601), every token valid and 181 invalid, and a
    # notf rollout step's (8, 661): the window with 1 and with 9 of its 10
    # frames filled, as the rollout's first and last steps hand it over
    flash_cases = [(TRAIN_TOKENS, (torch.arange(TRAIN_TOKENS)[None] >= n).int(), f"invalid{n}",
                    n == 0) for n in (0, 181)]
    flash_cases += [(ROLLOUT_TOKENS, rollout_valid(n), f"notf {n} of 10 frames", False)
                    for n in (1, 9)]
    for L, valid_row, label, main in flash_cases:
        bs, H, hd = TRAIN_BS, 12, 64
        D = H * hd
        # training hands over q/k/v as three separate projection outputs
        q, k, v = ((torch.randn(bs, L, D, generator=g) * 0.5).to(dev, torch.bfloat16)
                   for _ in range(3))
        dout = torch.randn(bs, L, D, generator=g).to(dev, torch.bfloat16)
        valid = valid_row.expand(bs, L).contiguous().to(dev)
        out, lse = fa.flash_forward(q, k, v, valid, H, hd)
        ref_out, ref_lse = fa.flash_forward_ref(q, k, v, valid, H, hd)
        fwd_again, twin_fwd_again = (fa.flash_forward(q, k, v, valid, H, hd),
                                     fa.flash_forward_ref(q, k, v, valid, H, hd))
        dq, dk, dv = fa.flash_backward(q, k, v, valid, out, lse, dout, H, hd)
        rq, rk, rv = fa.flash_backward_ref(q, k, v, valid, out, lse, dout, H, hd)
        again = fa.flash_backward(q, k, v, valid, out, lse, dout, H, hd)
        twin_again = fa.flash_backward_ref(q, k, v, valid, out, lse, dout, H, hd)
        torch.cuda.synchronize()
        delta = fa.row_delta(out, dout, H, hd)
        shape = f"({bs},{L},{D}) H{H} hd{hd} {label}"
        plain_bwd = device_ms(lambda: fa.flash_backward_ref(q, k, v, valid, out, lse, dout, H, hd))
        allowed = _allowed_causal(valid)[:, None]
        pairs = allowed.sum().item()
        lib_bwd, backend = sdpa_backward_ms(q, k, v, allowed, dout, H)
        rows.append(dict(
            kernel="flash_attention_fwd", shape=shape, main_path=main,
            rel=rel_err(out, ref_out), max_abs_err=(out.float() - ref_out.float()).abs().max().item(),
            lse_max_abs_err=(lse - ref_lse).abs().max().item(),
            deterministic=bool(torch.equal(fwd_again[0], out) and torch.equal(fwd_again[1], lse)),
            twin_deterministic=bool(torch.equal(twin_fwd_again[0], ref_out)
                                    and torch.equal(twin_fwd_again[1], ref_lse)),
            geometry=f"{H} heads x {bs} batch x {len(fa.query_tiles(L))} query tiles of "
                     f"{fa.TILE} rows",
            ms=device_ms(lambda: fa.flash_forward(q, k, v, valid, H, hd)),
            plain_ms=device_ms(lambda: fa.flash_forward_ref(q, k, v, valid, H, hd)),
            library_ms=device_ms(lambda: sdpa(q, k, v, allowed, H)),
            **bound(nbytes(q, k, v, valid, out, lse), 4 * D * pairs, "bf16"),
        ))
        rows.append(dict(
            kernel="flash_attention_dq", shape=shape, main_path=main,
            rel=rel_err(dq, rq), max_abs_err=(dq.float() - rq.float()).abs().max().item(),
            deterministic=bool(torch.equal(again[0], dq)),
            twin_deterministic=bool(torch.equal(twin_again[0], rq)),
            geometry=f"{H} heads x {bs} batch x {len(fa.query_tiles(L))} query tiles of "
                     f"{fa.TILE} rows",
            ms=device_ms(lambda: fa.flash_dq(q, k, v, dout, lse, delta, valid, H, hd)),
            plain_ms=plain_bwd, library_ms=lib_bwd, library_backend=backend,
            **bound(nbytes(q, k, v, dout, lse, delta, valid, dq), 6 * D * pairs, "bf16"),
        ))
        rows.append(dict(
            kernel="flash_attention_dkv", shape=shape, main_path=main,
            rel=max(rel_err(dk, rk), rel_err(dv, rv)),
            max_abs_err=max((dk.float() - rk.float()).abs().max().item(),
                            (dv.float() - rv.float()).abs().max().item()),
            deterministic=bool(torch.equal(again[1], dk) and torch.equal(again[2], dv)),
            twin_deterministic=bool(torch.equal(twin_again[1], rk)
                                    and torch.equal(twin_again[2], rv)),
            geometry=f"{H} heads x {bs} batch x {len(fa.key_tiles(L))} key tiles of "
                     f"{fa.TILE} rows",
            ms=device_ms(lambda: fa.flash_dkv(q, k, v, dout, lse, delta, valid, H, hd)),
            plain_ms=plain_bwd, library_ms=lib_bwd, library_backend=backend,
            **bound(nbytes(q, k, v, dout, lse, delta, valid, dk, dv), 8 * D * pairs, "bf16"),
        ))
        pair_ms = rows[-2]["ms"] + rows[-1]["ms"]
        print(f"[kernels] flash backward {shape}: dq {rows[-2]['ms']:.4f} + dk/dv "
              f"{rows[-1]['ms']:.4f} = {pair_ms:.4f} ms against one SDPA backward {lib_bwd:.4f} "
              f"ms ({backend}; device time) and the plain backward {plain_bwd:.4f} ms: "
              f"{pair_ms / lib_bwd:.2f}x the library")
    for Bf, H, C in [(TRAIN_BS * 10, 1, 48), (TRAIN_BS * 10, 1, 3), (TRAIN_BS, 1, 48),
                     (TRAIN_BS, 1, 3)]:
        xl, xr, gout = (torch.randn(Bf, 240, 64, H * C, generator=g).to(dev, torch.bfloat16)
                        for _ in range(3))
        att = torch.randn(H, C, generator=g).to(dev, torch.bfloat16)
        got = gf.slot_attention_bwd(xl, xr, att, gout, H, C)
        want = gf.slot_attention_bwd_ref(xl, xr, att, gout, H, C)
        again = gf.slot_attention_bwd(xl, xr, att, gout, H, C)
        twin_again = gf.slot_attention_bwd_ref(xl, xr, att, gout, H, C)
        torch.cuda.synchronize()
        ytile, stages, group = gf.bwd_plan(64, H, C, xl.element_size())
        n_blocks = gf.bwd_blocks(Bf, 240, 64, ytile)
        rows.append(dict(
            kernel="grid_slot_attention_bwd", shape=f"({Bf},240,64,{H * C}) H{H} C{C}",
            main_path=(C == 48), rel=max(rel_err(a, b) for a, b in zip(got, want)),
            max_abs_err=max((a.float() - b.float()).abs().max().item() for a, b in zip(got, want)),
            deterministic=all(torch.equal(a, b) for a, b in zip(again, got)),
            twin_deterministic=all(torch.equal(a, b) for a, b in zip(twin_again, want)),
            geometry=f"{n_blocks} blocks ({Bf} frames x {len(gf.strips(240))} strips of "
                     f"{gf.STRIP} rows x {-(-64 // ytile)} column tiles of {ytile}), a ring of "
                     f"{stages} row units, {gf.bwd_threads(ytile, H, C)} threads ({group} a "
                     "(pixel, head)); then datt: "
                     f"{H * C} blocks of {gf.DATT_THREADS} threads (2 launches a call)",
            ms=device_ms(lambda: gf.slot_attention_bwd(xl, xr, att, gout, H, C)),
            plain_ms=device_ms(lambda: gf.slot_attention_bwd_ref(xl, xr, att, gout, H, C)),
            library_ms=None,  # twice the forward's work per (pixel, channel)
            **bound(nbytes(xl, xr, att, gout, *got), 70 * xl.numel(), "f32"),
        ))
    for state in ("wrapped", "first", "prefill"):
        q, cache, key_pos, q0, li = _slab_case(dev, state, g)
        out = da.slab_decode(q, cache["k"], cache["v"], key_pos, q0, li, 64)
        ref = da.slab_decode_ref(q, cache["k"], cache["v"], key_pos, q0, li, 64)
        again = da.slab_decode(q, cache["k"], cache["v"], key_pos, q0, li, 64)
        twin_again = da.slab_decode_ref(q, cache["k"], cache["v"], key_pos, q0, li, 64)
        P, D = q.shape[1:]
        tot = cache["k"].shape[2] * cache["k"].shape[3]
        n_splits, split_keys = da.split_plan(tot, D // 64, -(-P // da.QUERY_TILE), 1,
                                             _build.sm_count(q.device))
        allowed = key_pos[0, :tot][None] <= q0 + torch.arange(P, device=dev)[:, None]
        n_visible = allowed.any(0).sum().item()  # keys some query may see
        k_l, v_l = (cache[n][li].reshape(1, tot, D) for n in ("k", "v"))
        torch.cuda.synchronize()
        rows.append(dict(
            kernel="slab_decode_attention",
            shape=f"{state}: q {tuple(q.shape)}, cache {tuple(cache['k'].shape)} layer {li}",
            main_path=True, rel=rel_err(out, ref),
            max_abs_err=(out.float() - ref.float()).abs().max().item(),
            finite=bool(torch.isfinite(out).all()),
            deterministic=bool(torch.equal(again, out)),
            twin_deterministic=bool(torch.equal(twin_again, ref)),
            geometry=f"{n_splits} key splits of {split_keys} keys x {D // 64} heads x "
                     f"{-(-P // da.QUERY_TILE)} query tile = {n_splits * D // 64} blocks",
            ms=device_ms(lambda: da.slab_decode(q, cache["k"], cache["v"], key_pos, q0, li, 64)),
            plain_ms=device_ms(
                lambda: da.slab_decode_ref(q, cache["k"], cache["v"], key_pos, q0, li, 64)),
            library_ms=device_ms(lambda: sdpa(q, k_l, v_l, allowed[None, None], 12)),
            **bound(nbytes(q, out, key_pos[0, :tot]) + 2 * n_visible * D * 2,
                    4 * D * allowed.sum().item(), "bf16"),
        ))
    for mode, M, K, N, has_bias, main in QMM_CASES:
        qp = quant.quantize_weight(torch.randn(N, K, generator=g) * 0.02)
        q, scale = qp["q"].to(dev), qp["scale"].to(dev)
        x = torch.randn(M, K, generator=g).to(dev, torch.bfloat16)
        b = (torch.randn(N, generator=g) * 0.1).to(dev) if has_bias else None
        out = qmm.int8_matmul(x, q, scale, b, mode)
        ref = qmm.int8_matmul_ref(x, q, scale, b, mode)
        # the launch plan, and a repeat bit for bit
        extra = dict(
            deterministic=bool(torch.equal(qmm.int8_matmul(x, q, scale, b, mode), out)),
            twin_deterministic=bool(torch.equal(qmm.int8_matmul_ref(x, q, scale, b, mode), ref)))
        if mode == "w8a16":
            tile, k_split = qmm.plan(M, K, N, _build.sm_count(x.device))
            w_tiles = -(-N // qmm.W16_ROWS)
            extra["geometry"] = (f"{w_tiles} weight-row tiles of {qmm.W16_ROWS} x "
                                 f"{-(-M // tile)} token tiles of {tile} x K split {k_split} = "
                                 f"{w_tiles * -(-M // tile) * k_split} blocks")
        else:
            n_tile, k_split = qmm.w8a8_plan(M, K, N, _build.sm_count(x.device))
            extra["geometry"] = (f"{-(-N // n_tile)} column tiles of {n_tile} x "
                                 f"{-(-M // qmm.W8_ROWS)} token tiles of {qmm.W8_ROWS} x K split "
                                 f"{k_split} = {-(-N // n_tile) * -(-M // qmm.W8_ROWS) * k_split} "
                                 "blocks")
        if mode == "w8a8":  # the yardstick: the int32 product of the quantised operands
            xq, qt = qmm.quantize_act(x)[0], q.t().contiguous()
            library = lambda: torch._int_mm(xq, qt)  # noqa: E731
        else:  # bf16 F.linear on the weight already dequantised
            w = quant.dequantize_weight(q, scale, torch.bfloat16)
            b16 = b.to(torch.bfloat16) if has_bias else None
            library = lambda: F.linear(x, w, b16)  # noqa: E731
        torch.cuda.synchronize()
        rows.append(dict(
            kernel=f"quant_matmul_{mode}",
            shape=f"M {M} K {K} N {N} {'bias' if has_bias else 'no bias'}", main_path=main,
            rel=rel_err(out, ref), max_abs_err=(out.float() - ref.float()).abs().max().item(),
            finite=bool(torch.isfinite(out).all()),
            exact=bool(torch.equal(out, ref)) if mode == "w8a8" else None, **extra,
            ms=device_ms(lambda: qmm.int8_matmul(x, q, scale, b, mode)),
            plain_ms=device_ms(lambda: qmm.int8_matmul_ref(x, q, scale, b, mode)),
            library_ms=device_ms(library),
            **bound(nbytes(x, q, scale, b, out), 2 * M * N * K,
                    "int8" if mode == "w8a8" else "bf16"),
        ))
    rows += _indexed_linear_rows(dev, g) + _short_attention_rows(dev, g)
    rows += _segment_rows(dev, g) + _pos_embed_rows(dev, g)
    for r in rows:
        ok = (r["rel"] <= r.get("rel_tol", REL_TOL) and r.get("finite", True)
              and r.get("lse_max_abs_err", 0.0) <= LSE_TOL
              and r.get("exact") is not False and r.get("deterministic") is not False)
        lib = "none" if r["library_ms"] is None else f"{r['library_ms']:.4f} ms"
        notes = "" if r.get("exact") is None else \
            f", equal to {r.get('exact_to', 'the twin')} {r['exact']}"
        if r.get("deterministic") is not None:
            notes += (f", repeat bit-equal {r['deterministic']} (twin "
                      f"{r['twin_deterministic']})")
        if r.get("lse_max_abs_err") is not None:
            notes += f", lse max_abs {r['lse_max_abs_err']:.3e} (bound {LSE_TOL})"
        if r.get("geometry"):
            notes += f", launch: {r['geometry']}"
        print(f"[kernels] {r['kernel']} {r['shape']}: rel {r['rel']:.3e} "
              f"max_abs {r['max_abs_err']:.3e}{notes} "
              f"{'ok' if ok else 'FAIL'}; kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
              f"library {lib}, bound {r['bound_ms']:.4f} ms ({r['bound_by']}) (device time per "
              "call, median of 25 graph replays of 10 calls; the plain and library times of dq "
              "and dk/dv are the whole backward's)")
        if not ok:
            failures.append(f"kernel {r['kernel']} {r['shape']} rel {r['rel']} "
                            f"lse {r.get('lse_max_abs_err')} exact {r.get('exact')} "
                            f"deterministic {r.get('deterministic')}")
    return rows


# (M, K, N) of the stacked streaming step's linears (fluid/llama-125m, q/k/v
# packed): qkv, o, gate and up, down at the decode's 60 rows, and the
# prefill's 61 (the sinks and no frame, 61 tokens)
INDEXED_CASES = [(60, 768, 2304), (60, 768, 768), (60, 768, 2048), (60, 2048, 768),
                 (61, 768, 2304), (61, 768, 768), (61, 768, 2048), (61, 2048, 768)]


def _indexed_linear_rows(dev, g: torch.Generator) -> list[dict]:
    """The indexed linear against its twin at the stacked streaming step's
    shapes, at the first and the last of 12 layers; the library call is
    ``F.linear`` on the host-indexed view ``w[li]`` (cuBLAS, no copy)."""
    import torch.nn.functional as F

    from fluid_llm_tpu_torch.ops import _build
    from fluid_llm_tpu_torch.ops import indexed_linear as il

    rows, index = [], torch.arange(12, dtype=torch.int32, device=dev)
    weights = {}
    for M, K, N in INDEXED_CASES:
        if (K, N) not in weights:
            weights[K, N] = (torch.randn(12, N, K, generator=g) * 0.02).to(dev, torch.bfloat16)
        w = weights[K, N]
        x = torch.randn(M, K, generator=g).to(dev, torch.bfloat16)
        block_n, k_split = il.plan(M, K, N, _build.sm_count(x.device))
        for li in (0, 11):
            out = il.indexed_linear(x, w, None, index[li])
            ref = il.indexed_linear_ref(x, w, None, index[li])
            again = il.indexed_linear(x, w, None, index[li])
            twin_again = il.indexed_linear_ref(x, w, None, index[li])
            wl = w[li]
            torch.cuda.synchronize()
            rows.append(dict(
                kernel="indexed_linear", shape=f"M {M} K {K} N {N}, layer {li} of 12",
                main_path=True, rel=rel_err(out, ref),
                max_abs_err=(out.float() - ref.float()).abs().max().item(),
                finite=bool(torch.isfinite(out).all()),
                deterministic=bool(torch.equal(again, out)),
                twin_deterministic=bool(torch.equal(twin_again, ref)),
                geometry=f"{-(-M // il.ROW_TILE)} row x {N // block_n} column tiles of "
                         f"{block_n} x K split {k_split} (clusters of {k_split}) = "
                         f"{-(-M // il.ROW_TILE) * N // block_n * k_split} blocks",
                ms=device_ms(lambda: il.indexed_linear(x, w, None, index[li])),
                plain_ms=device_ms(lambda: il.indexed_linear_ref(x, w, None, index[li])),
                library_ms=device_ms(lambda: F.linear(x, wl)),
                **bound(nbytes(x, wl, out), 2 * M * N * K, "bf16"),
            ))
    return rows


def _indexed_linear_plans(dev, failures: list) -> list[dict]:
    """Every plan of the indexed linear (column tile, K split) at the
    stacked streaming step's four (M 60) shapes, layer 5 of 12: agreement
    with the twin (each plan sums K in its own order) and device time, the
    plan ``indexed_linear.plan`` takes marked, beside ``F.linear``."""
    import torch.nn.functional as F

    from fluid_llm_tpu_torch.ops import _build
    from fluid_llm_tpu_torch.ops import indexed_linear as il

    g = torch.Generator().manual_seed(7)
    index = torch.arange(12, dtype=torch.int32, device=dev)[5]
    sms = _build.sm_count(dev)
    res = []
    for M, K, N in INDEXED_CASES[:4]:
        w = (torch.randn(12, N, K, generator=g) * 0.02).to(dev, torch.bfloat16)
        x = torch.randn(M, K, generator=g).to(dev, torch.bfloat16)
        ref = il.indexed_linear_ref(x, w, None, index)
        chosen = il.plan(M, K, N, sms)
        timed = []
        for blocks, block_n, k_split in il.plans(M, K, N):
            if blocks > 2 * sms:
                continue
            with mock.patch.object(il, "plan", lambda *a, p=(block_n, k_split): p):
                out = il.indexed_linear(x, w, None, index)
                ms = device_ms(lambda: il.indexed_linear(x, w, None, index))
            torch.cuda.synchronize()
            rel = rel_err(out, ref)
            timed.append(dict(block_n=block_n, k_split=k_split, blocks=blocks, ms=ms, rel=rel,
                              chosen=(block_n, k_split) == chosen))
            if not rel <= REL_TOL:
                failures.append(f"indexed_linear plan ({block_n}, {k_split}) at M {M} K {K} "
                                f"N {N}: rel {rel}")
        library = device_ms(lambda: F.linear(x, w[5]))
        timed.sort(key=lambda r: r["ms"])
        print(f"[plans] indexed_linear M {M} K {K} N {N}: F.linear {library:.4f} ms; "
              + "; ".join(f"({r['block_n']}, {r['k_split']}) {r['blocks']} blocks "
                          f"{r['ms']:.4f}{' (plan)' if r['chosen'] else ''}" for r in timed)
              + f"; max rel {max(r['rel'] for r in timed):.1e}")
        res.append(dict(M=M, K=K, N=N, library_ms=library, plans=timed))
    return res


# (M, K, N) of the w8a16 kernel's paths, with bias: OPT-125m's exact
# rollout (q/k/v/o, fc1, fc2 at 661 rows and the sliced last block's 60)
# and training1.yaml's train step over an int8 frozen backbone (k/o, fc1,
# fc2 at 8 x 601 rows, phase 21; plan's grid rule, not swept)
W8A16_SHAPES = [(661, 768, 768), (661, 768, 3072), (661, 3072, 768),
                (60, 768, 768), (60, 768, 3072), (60, 3072, 768),
                (TRAIN_BS * TRAIN_TOKENS, 768, 768), (TRAIN_BS * TRAIN_TOKENS, 768, 3072),
                (TRAIN_BS * TRAIN_TOKENS, 3072, 768)]


def _w8a16_plans(dev, failures: list) -> list[dict]:
    """Every plan of the w8a16 kernel (token tile, K split; every unsplit
    grid, split ones up to four blocks an SM) at its paths' nine shapes,
    with bias: agreement with
    the twin and device time, ``quant_matmul.plan``'s choice marked,
    beside bf16 ``F.linear`` on the dequantised weight."""
    import torch.nn.functional as F

    from fluid_llm_tpu_torch.ops import _build
    from fluid_llm_tpu_torch.ops import quant
    from fluid_llm_tpu_torch.ops import quant_matmul as qmm

    g = torch.Generator().manual_seed(8)
    sms = _build.sm_count(dev)
    res = []
    for M, K, N in W8A16_SHAPES:
        qp = quant.quantize_weight(torch.randn(N, K, generator=g) * 0.02)
        q, scale = qp["q"].to(dev), qp["scale"].to(dev)
        x = torch.randn(M, K, generator=g).to(dev, torch.bfloat16)
        b = (torch.randn(N, generator=g) * 0.1).to(dev)
        ref = qmm.int8_matmul_ref(x, q, scale, b, "w8a16")
        chosen = qmm.plan(M, K, N, sms)
        timed = []
        for blocks, *p in qmm.plans(M, K, N):
            if blocks > 4 * sms and p[1] > 1:
                continue
            with mock.patch.object(qmm, "plan", lambda *a, p=tuple(p): p):
                out = qmm.qmm_w8a16(x, q, scale, b)
                ms = device_ms(lambda: qmm.qmm_w8a16(x, q, scale, b))
            torch.cuda.synchronize()
            rel = rel_err(out, ref)
            timed.append(dict(plan=tuple(p), blocks=blocks, ms=ms, rel=rel,
                              chosen=tuple(p) == chosen))
            if not rel <= REL_TOL:
                failures.append(f"w8a16 plan {tuple(p)} at M {M} K {K} N {N}: rel {rel}")
        w, b16 = quant.dequantize_weight(q, scale, torch.bfloat16), b.to(torch.bfloat16)
        library = device_ms(lambda: F.linear(x, w, b16))
        timed.sort(key=lambda r: r["ms"])
        print(f"[plans] quant_matmul_w8a16 M {M} K {K} N {N}: F.linear {library:.4f} ms; "
              + "; ".join(f"{r['plan']} {r['blocks']} blocks "
                          f"{r['ms']:.4f}{' (plan)' if r['chosen'] else ''}" for r in timed)
              + f"; max rel {max(r['rel'] for r in timed):.1e}")
        res.append(dict(M=M, K=K, N=N, library_ms=library, plans=timed))
    return res


# (M, K, N, bias) of phase 3's w8a8 rows (QMM_CASES): the flagship's
# bias-free linears at 60 and 61 rows, OPT-125m's biased ones at 661
W8A8_SHAPES = [case[1:5] for case in QMM_CASES if case[0] == "w8a8"]


def _w8a8_plans(dev, failures: list) -> list[dict]:
    """Every plan of the w8a8 kernel (column tile, K split; up to four blocks
    an SM) at phase 3's nine shapes: equal to the twin bit for bit (the
    int32 sums and the row maxima are exact in any order) and device time,
    ``quant_matmul.w8a8_plan``'s choice marked, beside ``torch._int_mm``
    on the quantised operands and w8a16's plan at the same shape."""
    from fluid_llm_tpu_torch.ops import _build
    from fluid_llm_tpu_torch.ops import quant
    from fluid_llm_tpu_torch.ops import quant_matmul as qmm

    g = torch.Generator().manual_seed(10)
    sms = _build.sm_count(dev)
    res = []
    for M, K, N, has_bias in W8A8_SHAPES:
        qp = quant.quantize_weight(torch.randn(N, K, generator=g) * 0.02)
        q, scale = qp["q"].to(dev), qp["scale"].to(dev)
        x = torch.randn(M, K, generator=g).to(dev, torch.bfloat16)
        b = (torch.randn(N, generator=g) * 0.1).to(dev) if has_bias else None
        ref = qmm.int8_matmul_ref(x, q, scale, b, "w8a8")
        chosen = qmm.w8a8_plan(M, K, N, sms)
        timed = []
        for blocks, *p in qmm.w8a8_plans(M, K, N):
            if blocks > 4 * sms:
                continue
            with mock.patch.object(qmm, "w8a8_plan", lambda *a, p=tuple(p): p):
                out = qmm.qmm_w8a8(x, q, scale, b)
                ms = device_ms(lambda: qmm.qmm_w8a8(x, q, scale, b))
            torch.cuda.synchronize()
            exact = bool(torch.equal(out, ref))
            timed.append(dict(plan=tuple(p), blocks=blocks, ms=ms, exact=exact,
                              chosen=tuple(p) == chosen))
            if not exact:
                failures.append(f"w8a8 plan {tuple(p)} at M {M} K {K} N {N}: not equal to "
                                "the twin")
        xq, qt = qmm.quantize_act(x)[0], q.t().contiguous()
        library = device_ms(lambda: torch._int_mm(xq, qt))
        w8a16 = device_ms(lambda: qmm.qmm_w8a16(x, q, scale, b))
        timed.sort(key=lambda r: r["ms"])
        print(f"[plans] quant_matmul_w8a8 M {M} K {K} N {N}: _int_mm {library:.4f} ms, w8a16 "
              f"{w8a16:.4f} ms; " + "; ".join(f"{r['plan']} {r['blocks']} blocks "
                                           f"{r['ms']:.4f}{' (plan)' if r['chosen'] else ''}"
                                           for r in timed)
              + f"; all equal to the twin {all(r['exact'] for r in timed)}")
        res.append(dict(M=M, K=K, N=N, library_ms=library, w8a16_ms=w8a16, plans=timed))
    return res


def _short_attention_plans(dev, failures: list) -> list[dict]:
    """Both plans of the short-attention kernel (64 or 128 query rows a
    block) at the training step's and the rollout's shapes: agreement with
    the twin over valid rows and device time, ``short_attention.plan``'s
    choice marked."""
    from fluid_llm_tpu_torch.ops import _build
    from fluid_llm_tpu_torch.ops import short_attention as sa

    g = torch.Generator().manual_seed(9)
    H, hd = 12, 64
    D = H * hd
    res = []
    for bs, L, valid in [(TRAIN_BS, TRAIN_TOKENS, None), (1, ROLLOUT_TOKENS, rollout_valid(3))]:
        q, k, v = ((torch.randn(bs, L, D, generator=g) * 0.5).to(dev, torch.bfloat16)
                   for _ in range(3))
        valid = (torch.ones(bs, L, dtype=torch.int32) if valid is None else valid).to(dev)
        keep = valid[0].bool()
        ref = sa.short_attention_ref(q, k, v, valid, H, hd)
        chosen = sa.plan(bs, L, H, hd, _build.sm_count(dev))
        timed = []
        for q_rows in sa.QUERY_ROWS:
            with mock.patch.object(sa, "plan", lambda *a, p=q_rows: p):
                out = sa.short_attention_fwd(q, k, v, valid, H, hd)
                ms = device_ms(lambda: sa.short_attention_fwd(q, k, v, valid, H, hd))
            torch.cuda.synchronize()
            rel = rel_err(out[:, keep], ref[:, keep])
            blocks = H * bs * len(sa.query_tiles(L, q_rows))
            timed.append(dict(q_rows=q_rows, blocks=blocks, ms=ms, rel=rel,
                              chosen=q_rows == chosen))
            if not rel <= REL_TOL:
                failures.append(f"short attention plan {q_rows} at ({bs}, {L}): rel {rel}")
        timed.sort(key=lambda r: r["ms"])
        print(f"[plans] short_attention ({bs}, {L}, {D}) H{H}: "
              + "; ".join(f"{r['q_rows']} query rows a block, {r['blocks']} blocks "
                          f"{r['ms']:.4f}{' (plan)' if r['chosen'] else ''}" for r in timed)
              + f"; max rel {max(r['rel'] for r in timed):.1e}")
        res.append(dict(bs=bs, L=L, plans=timed))
    return res


# (frames, C) of the slot forward's main path: the rollout's one frame and
# the training step's 80, at the hidden convs' C 48 and the out conv's C 3
SLOT_FWD_SHAPES = [(1, 48), (TRAIN_BS * 10, 48), (1, 3), (TRAIN_BS * 10, 3)]


def _slot_fwd_plans(dev, failures: list) -> list[dict]:
    """The slot forward's plans at its main path's four shapes, bf16:
    agreement with the twin and device time, ``grid_gnn_fused.fwd_plan``'s
    choice marked.  At 80 frames: whole rows, the strip, the rows a unit
    (written at a time) and the ring's depth; at one frame also column tiles
    of 32 and 16 pixels and groups of 2 and 4 times ``channel_group``'s (more
    threads a pixel, fewer chunks each)."""
    from fluid_llm_tpu_torch.ops import _build
    from fluid_llm_tpu_torch.ops import grid_gnn_fused as gf

    g = torch.Generator().manual_seed(11)
    res = []
    for Bf, C in SLOT_FWD_SHAPES:
        xl, xr = (torch.randn(Bf, 240, 64, C, generator=g).to(dev, torch.bfloat16)
                  for _ in range(2))
        att = torch.randn(1, C, generator=g).to(dev, torch.bfloat16)
        ref = gf.slot_attention_ref(xl, xr, att, 1, C)
        chosen = gf.fwd_plan(Bf, 240, 64, 1, C, 2, _build.sm_count(dev))
        rule = gf.channel_group(C)[1]
        timed = []
        for strip in (1, 2, 4) if Bf == 1 else (8, 15, 30):
            for ytile in (64, 32, 16) if Bf == 1 else (64,):
                for group in sorted({rule, min(32, 2 * rule), min(32, 4 * rule)}
                                    if Bf == 1 else {rule}):
                    most = gf.FWD_THREADS // gf.fwd_threads(ytile, 1, group)
                    units = {1} if ytile < 64 else {1, min(2, most, strip), min(4, most, strip)}
                    for unit_rows in sorted(units):
                        for stages in (4, 6, 12):
                            if gf.fwd_smem(ytile, stages, 1, C, 2, unit_rows) > gf.SMEM_SHARED:
                                continue
                            plan = (strip, ytile, stages, group, unit_rows)
                            with mock.patch.object(gf, "fwd_plan", lambda *a, p=plan: p):
                                out = gf.fused_slot_attention(xl, xr, att, 1, C)
                                ms = device_ms(lambda: gf.fused_slot_attention(xl, xr, att, 1, C))
                            torch.cuda.synchronize()
                            rel = rel_err(out, ref)
                            timed.append(dict(plan=plan, ms=ms, rel=rel, chosen=plan == chosen,
                                              blocks=gf.fwd_blocks(Bf, 240, 64, strip, ytile)))
                            if not rel <= REL_TOL:
                                failures.append(f"slot forward plan {plan} at ({Bf}, 240, 64, "
                                                f"{C}): rel {rel}")
        timed.sort(key=lambda r: r["ms"])
        print(f"[plans] grid_slot_attention ({Bf},240,64,{C}), (strip, ytile, ring, group, "
              "rows a unit): "
              + "; ".join(f"{r['plan']} {r['blocks']} blocks {r['ms']:.4f}"
                          f"{' (plan)' if r['chosen'] else ''}" for r in timed[:12])
              + f"; {len(timed)} plans, slowest {timed[-1]['ms']:.4f}; "
              f"max rel {max(r['rel'] for r in timed):.1e}")
        res.append(dict(Bf=Bf, C=C, plans=timed))
    return res


def _gather_plans(dev, failures: list) -> list[dict]:
    """The segment gather's plans (loads a lane in flight, warps a block,
    one tile a warp or a grid of up to a wave that walks them) at its main
    path's shapes (MeshGraphNet's F 128 and F 2) and GAT's F 1, on the EAGLE
    senders: each equal to the twin bit for bit, and timed,
    ``segment_ops.gather_plan``'s choice marked."""
    from fluid_llm_tpu_torch.ops import _build
    from fluid_llm_tpu_torch.ops import segment_ops as so

    g = torch.Generator().manual_seed(12)
    edges = eagle_edges(dev)
    n = int(edges.max()) + 1
    index = so.SegmentIndex(edges[..., 0], n)
    M, sms = index.ids.shape[0], _build.sm_count(dev)
    res = []
    for F in (128, 2, 1):
        x = torch.randn(index.n_rows, F, generator=g).to(dev)
        ref = so.gather_ref(x, index)
        vec = so.gather_vec(F, x, ref)
        chosen = so.gather_plan(M, F, vec)
        timed = []
        for depth in so.GATHER_DEPTHS:
            for warps in (2, 4, 8, 16):
                full = -(-so.gather_tiles(M, F // vec, depth) // warps)
                # one tile a warp, or a quarter, half or whole wave of resident
                # warps (64 an SM) walking the tiles
                for blocks in sorted({full} | {min(full, sms * (64 // warps) * q // 4)
                                              for q in (1, 2, 4)}):
                    plan = (depth, warps, blocks)
                    with mock.patch.object(so, "gather_plan", lambda *a, p=plan: p):
                        out = so.segment_gather(x, index)
                        ms = device_ms(lambda: so.segment_gather(x, index))
                    torch.cuda.synchronize()
                    exact = bool(torch.equal(out, ref))
                    timed.append(dict(depth=depth, warps=warps, blocks=blocks, ms=ms,
                                      exact=exact, chosen=plan == chosen))
                    if not exact:
                        failures.append(f"segment gather plan {plan} at F {F}: not the twin")
        timed.sort(key=lambda r: r["ms"])
        print(f"[plans] segment_gather ({n * edges.shape[0]}, {F}) -> ({M}, {F}), "
              f"{4 * vec}-byte vectors: "
              + "; ".join(f"depth {r['depth']} {r['warps']} warps {r['blocks']} blocks "
                          f"{r['ms']:.4f}{' (plan)' if r['chosen'] else ''}" for r in timed[:12])
              + f"; {len(timed)} plans, slowest {timed[-1]['ms']:.4f}; all bit for bit "
              f"{all(r['exact'] for r in timed)}")
        res.append(dict(F=F, plans=timed))
    return res


def _sum_bf16_plans(dev, failures: list) -> list[dict]:
    """``segment_ops.sum_plan``'s ring for the bf16 segment sum (K edge rows
    a stage, S stages, R rows a warp, W warps a block) and each plan one
    step from it (one of the four halved or doubled, within the kernel's
    bounds and shared memory) at its main path's shapes: MeshGraphNet's F
    128 by the EAGLE senders (each row's edges consecutive) and receivers
    (scattered) and GraphViT's F 512 by member, each equal to the CSR walk
    bit for bit and timed.  The plan was read from the whole sweep (every
    K of 4-32, S of 2-4, R of 2-16, W of 2-16); this keeps it checked."""
    from fluid_llm_tpu_torch.ops import segment_ops as so

    g = torch.Generator().manual_seed(13)
    edges = eagle_edges(dev)
    n = int(edges.max()) + 1
    cases = [(128, so.SegmentIndex(edges[..., 0], n), "edges[..., 0]"),
             (128, so.SegmentIndex(edges[..., 1], n), "edges[..., 1]"),
             (512, graphvit_members(dev), "cluster members")]
    res = []
    for F, index, by in cases:
        x = torch.randn(index.ids.shape[0], F, generator=g).to(dev, torch.bfloat16)
        ref = so.csr_walk(x, index)
        chosen = so.sum_plan(F)
        steps = {tuple(v * f if i == j else v for i, v in enumerate(chosen))
                 for j in range(4) for f in (0.5, 2)}
        plans = [chosen] + sorted(
            tuple(int(v) for v in p) for p in steps
            if all(v == int(v) for v in p) and 1 <= p[0] <= 32 and p[1] >= 1
            and 1 <= p[2] <= 32 and 1 <= p[3] <= so.RING_WARPS
            and so.ring_smem(F, tuple(int(v) for v in p)) <= so.SMEM_MAX)
        timed = []
        for plan in plans:
            with mock.patch.object(so, "sum_plan", lambda *a, p=plan: p):
                out = so.segment_sum_bf16(x, index)
                ms = device_ms(lambda: so.segment_sum_bf16(x, index))
            torch.cuda.synchronize()
            exact = bool(torch.equal(out, ref))
            timed.append(dict(plan=plan, ms=ms, exact=exact, chosen=plan == chosen))
            if not exact:
                failures.append(f"segment sum bf16 plan {plan} at F {F}: not the CSR walk")
        timed.sort(key=lambda r: r["ms"])
        print(f"[plans] segment_sum_bf16 ({index.ids.shape[0]}, {F}) by {by} -> "
              f"({index.n_rows}, {F}), (K, S, R, W): "
              + "; ".join(f"{r['plan']} {r['ms']:.4f}{' (plan)' if r['chosen'] else ''}"
                          for r in timed)
              + f"; all bit for bit {all(r['exact'] for r in timed)}")
        res.append(dict(F=F, by=by, plans=timed))
    return res


def _rank_local(dev, failures: list) -> list[dict]:
    """The slab decode and w8a16 at the rank-local shapes of phase 24's
    flagship under model 2, in this one process: the slab decode's wrapped
    ring (60 queries, 704 keys) at H 6 and w8a16 at W8A16_RANK_SHAPES (no
    bias, the grid rule's plan), each against the twin (REL_TOL), timed
    beside the library call (SDPA with the same mask; bf16 ``F.linear`` on
    the weight dequantised beforehand) and the bound."""
    import torch.nn.functional as F

    from fluid_llm_tpu_torch.ops import _build
    from fluid_llm_tpu_torch.ops import decode_attention as da
    from fluid_llm_tpu_torch.ops import quant
    from fluid_llm_tpu_torch.ops import quant_matmul as qmm

    smi = run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"]).strip()
    g = torch.Generator().manual_seed(20)
    rows = []
    q12, cache, key_pos, q0, li = _slab_case(dev, "wrapped", g)
    H, D = 6, 6 * 64  # the first 6 of 12 heads: a rank's under model 2
    q = q12[..., :D].contiguous()
    k, v = (cache[n][..., :D].contiguous() for n in ("k", "v"))
    P, tot = q.shape[1], k.shape[2] * k.shape[3]
    allowed = key_pos[0, :tot][None] <= q0 + torch.arange(P, device=dev)[:, None]
    k_l, v_l = (t[li].reshape(1, tot, D) for t in (k, v))
    out = da.slab_decode(q, k, v, key_pos, q0, li, 64)
    rel = rel_err(out, da.slab_decode_ref(q, k, v, key_pos, q0, li, 64))
    rows.append(dict(
        kernel="slab_decode_attention", shape=f"q {tuple(q.shape)}, {tot} keys, H {H}", rel=rel,
        ms=device_ms(lambda: da.slab_decode(q, k, v, key_pos, q0, li, 64)),
        plain_ms=device_ms(lambda: da.slab_decode_ref(q, k, v, key_pos, q0, li, 64)),
        library_ms=device_ms(lambda: sdpa(q, k_l, v_l, allowed[None, None], H)),
        **bound(nbytes(q, out, key_pos[0, :tot]) + 2 * allowed.any(0).sum().item() * D * 2,
                4 * D * allowed.sum().item(), "bf16")))
    for M, K, N in W8A16_RANK_SHAPES:
        qp = quant.quantize_weight(torch.randn(N, K, generator=g) * 0.02)
        wq, scale = qp["q"].to(dev), qp["scale"].to(dev)
        x = torch.randn(M, K, generator=g).to(dev, torch.bfloat16)
        out = qmm.qmm_w8a16(x, wq, scale, None)
        rel = rel_err(out, qmm.int8_matmul_ref(x, wq, scale, None, "w8a16"))
        w = quant.dequantize_weight(wq, scale, torch.bfloat16)
        rows.append(dict(
            kernel="quant_matmul_w8a16", rel=rel,
            shape=f"({M}, {K}, {N}) plan {qmm.plan(M, K, N, _build.sm_count(dev))}",
            ms=device_ms(lambda: qmm.qmm_w8a16(x, wq, scale, None)),
            plain_ms=device_ms(lambda: qmm.int8_matmul_ref(x, wq, scale, None, "w8a16")),
            library_ms=device_ms(lambda: F.linear(x, w)),
            **bound(nbytes(x, wq, scale, out), 2 * M * K * N, "bf16")))
    for r in rows:
        r["card"] = smi
        if not r["rel"] <= REL_TOL:
            failures.append(f"rank-local {r['kernel']} at {r['shape']}: rel {r['rel']}")
    print(f"[plans] rank-local shapes of model 2, one process ({smi}), ms kernel / twin / "
          "library (bound): " + "; ".join(
              f"{r['kernel']} {r['shape']} {r['ms']:.4f} / {r['plain_ms']:.4f} / "
              f"{r['library_ms']:.4f} ({r['bound_ms']:.4f} by {r['bound_by']}), rel {r['rel']:.2e}"
              for r in rows))
    return rows


def phase_plans(dev, failures: list) -> dict:
    """Every launch plan of the kernels that choose one per shape, timed at
    their main path's shapes: the tables ``indexed_linear.plan``,
    ``quant_matmul.plan``, ``quant_matmul.w8a8_plan``,
    ``short_attention.plan``, ``grid_gnn_fused.fwd_plan``,
    ``segment_ops.gather_plan`` and ``segment_ops.sum_plan`` are read from;
    then the slab decode and
    w8a16 at phase 24's rank-local shapes beside their library calls."""
    return dict(indexed_linear=_indexed_linear_plans(dev, failures),
                quant_matmul_w8a16=_w8a16_plans(dev, failures),
                quant_matmul_w8a8=_w8a8_plans(dev, failures),
                short_attention=_short_attention_plans(dev, failures),
                slot_attention_fwd=_slot_fwd_plans(dev, failures),
                segment_gather=_gather_plans(dev, failures),
                segment_sum_bf16=_sum_bf16_plans(dev, failures),
                rank_local=_rank_local(dev, failures))


def rollout_valid(n_valid_frames: int, frame: int = 60, window: int = 10) -> torch.Tensor:
    """(1, 661) int32 validity of the exact rollout's window with
    ``n_valid_frames`` frames filled: BOS and the see-init frame, then the
    window's invalid frames at the front, then its valid ones."""
    n_invalid = (window - n_valid_frames) * frame
    t = torch.arange(1 + (window + 1) * frame)
    return ((t < 1 + frame) | (t >= 1 + frame + n_invalid)).int()[None]


def _short_attention_rows(dev, g: torch.Generator) -> list[dict]:
    """The short-attention kernel against its twin at the training step's
    (8, 601, 768), every token valid, q/k/v three projection outputs, and
    the rollout's (1, 661, 768) with 7 of 10 window frames invalid, q/k/v
    column slices of one fused projection; the error over valid query rows
    (the forced-diagonal rows are checked finite).  The library call is
    ``scaled_dot_product_attention`` with the same mask."""
    from fluid_llm_tpu_torch.ops import _build
    from fluid_llm_tpu_torch.ops import short_attention as sa

    rows, H, hd = [], 12, 64
    D = H * hd
    for bs, L in [(TRAIN_BS, TRAIN_TOKENS), (1, ROLLOUT_TOKENS)]:
        if L == TRAIN_TOKENS:
            q, k, v = ((torch.randn(bs, L, D, generator=g) * 0.5).to(dev, torch.bfloat16)
                       for _ in range(3))
            valid = torch.ones(bs, L, dtype=torch.int32, device=dev)
        else:
            qkv = (torch.randn(bs, L, 3 * D, generator=g) * 0.5).to(dev, torch.bfloat16)
            q, k, v = qkv[..., :D], qkv[..., D:2 * D], qkv[..., 2 * D:]
            valid = rollout_valid(3).to(dev)
        out = sa.short_attention_fwd(q, k, v, valid, H, hd)
        ref = sa.short_attention_ref(q, k, v, valid, H, hd)
        again = sa.short_attention_fwd(q, k, v, valid, H, hd)
        twin_again = sa.short_attention_ref(q, k, v, valid, H, hd)
        allowed = _allowed_causal(valid)
        keep = valid[0].bool()
        q_rows = sa.plan(bs, L, H, hd, _build.sm_count(q.device))
        torch.cuda.synchronize()
        rows.append(dict(
            kernel="short_attention",
            shape=f"({bs},{L},{D}) H{H} hd{hd}, {int((valid == 0).sum()) // bs} invalid tokens",
            main_path=True, rel=rel_err(out[:, keep], ref[:, keep]),
            max_abs_err=(out[:, keep].float() - ref[:, keep].float()).abs().max().item(),
            finite=bool(torch.isfinite(out).all()),
            deterministic=bool(torch.equal(again, out)),
            twin_deterministic=bool(torch.equal(twin_again, ref)),
            geometry=f"{H} heads x {bs} batch x {len(sa.query_tiles(L, q_rows))} query tiles of "
                     f"{q_rows} rows = {H * bs * len(sa.query_tiles(L, q_rows))} blocks",
            ms=device_ms(lambda: sa.short_attention_fwd(q, k, v, valid, H, hd)),
            plain_ms=device_ms(lambda: sa.short_attention_ref(q, k, v, valid, H, hd)),
            library_ms=device_ms(lambda: sdpa(q, k, v, allowed[:, None], H)),
            **bound(nbytes(q, k, v, valid, out), 4 * D * allowed.sum().item(), "bf16"),
        ))
    return rows


# the EAGLE geometry of the graph baselines (BENCHMARKS.md:676-680): a
# synthetic 84x42 mesh has 3 528 nodes and 20 348 directed edges, collated
# to 3 529 and 20 480; batch 4
EAGLE_MESH, EAGLE_BS, EAGLE_BLOCKS = "84x42", 4, 15
EAGLE_GAT_EVAL = 26  # GAT's eval horizon in phase 13 (the CLI's default is 101)
# f32 sums in another order than the twin's atomics (observed: a few 1e-8)
SEGMENT_REL_TOL = 1e-6
# bf16: the same f32 sums rounded once, so an element may round the other
# way from the twin's (2^-8 relative at most, on one element in 2^16)
BF16_SEGMENT_REL_TOL = 1e-4
# (kernel, edge column, F, on MeshGraphNet's path): MGN sums edge rows into
# the senders (forward) and into the receivers (backward of the receivers
# gather) at F 128 and gathers node rows (F 128) and positions (F 2); GAT
# sums a head's 32 channels and its attention weights (F 1)
SEGMENT_CASES = [
    ("segment_sum", 0, 128, True), ("segment_sum", 1, 128, True),
    ("segment_sum", 0, 32, False), ("segment_sum", 0, 1, False),
    ("segment_gather", 0, 128, True), ("segment_gather", 1, 128, True),
    ("segment_gather", 0, 2, True), ("segment_gather", 0, 1, False),
]


def eagle_edges(dev) -> torch.Tensor:
    """(4, 20480, 2) int32 edge ids of one collated batch at the EAGLE
    geometry, RCM-relabeled as ``baselines_cli`` does."""
    from fluid_llm_tpu_torch.data.eagle_mesh import collate_graphs
    from fluid_llm_tpu_torch.data.reorder import reorder_sample
    from fluid_llm_tpu_torch.data.synthetic import SyntheticGraphDataset

    ds = SyntheticGraphDataset(n_trajectories=EAGLE_BS, mode="train", window_length=2,
                               mesh_nodes=tuple(int(v) for v in EAGLE_MESH.split("x")))
    samples = [reorder_sample(ds[i], "rcm") for i in range(EAGLE_BS)]
    batch = collate_graphs(samples, max(s.mesh_pos.shape[1] for s in samples),
                           max(s.edges.shape[0] for s in samples))
    return torch.from_numpy(batch["edges"][:, 0]).to(dev)


# (kernel, F, on the main path) by GraphViT's member ids: positions (F 2),
# node features (F 128) and the encoding (F 64) gathered by member, the
# tokens' gradient (F w_size 512) gathered back; the relative encoding (F
# 32) and the tokens (F 512) summed into members, the node features'
# gradient (F 128) summed back.  bf16 (``--dtype bf16``): MeshGraphNet's F
# 128 by its senders, GraphViT's F 512 by member.
GRAPHVIT_SEGMENT_CASES = [
    ("segment_gather", 2, True), ("segment_gather", 64, True), ("segment_gather", 128, True),
    ("segment_gather", 512, True), ("segment_sum", 32, True), ("segment_sum", 128, True),
    ("segment_sum", 512, True),
]
BF16_SEGMENT_CASES = [("segment_sum_bf16", "edges", 128), ("segment_gather_bf16", "edges", 128),
                      ("segment_sum_bf16", "members", 512),
                      ("segment_gather_bf16", "members", 512)]


def graphvit_members(dev):
    """The member index of one collated GraphViT batch at the EAGLE geometry
    (synthetic 84x42 mesh, batch 4, clusters of 10: 384 cluster slots of 10
    a graph after the collate's padding), RCM-relabeled as ``baselines_cli``
    does in f32: unsorted ids, ghost slots dropped."""
    from fluid_llm_tpu_torch.data.eagle_mesh import collate_graphs
    from fluid_llm_tpu_torch.data.reorder import reorder_sample
    from fluid_llm_tpu_torch.data.synthetic import SyntheticGraphDataset
    from fluid_llm_tpu_torch.models.baselines.graphvit import member_index

    ds = SyntheticGraphDataset(n_trajectories=EAGLE_BS, mode="train", window_length=2,
                               mesh_nodes=tuple(int(v) for v in EAGLE_MESH.split("x")),
                               n_cluster=10)
    samples = [reorder_sample(ds[i], "rcm") for i in range(EAGLE_BS)]
    b = collate_graphs(samples, max(s.mesh_pos.shape[1] for s in samples),
                       max(s.edges.shape[0] for s in samples),
                       max(s.cluster.shape[1] for s in samples), ghost_type_value=2)
    return member_index(torch.from_numpy(b["cluster"][:, 0]).to(dev),
                        torch.from_numpy(b["cluster_mask"][:, 0]).to(dev), b["mesh_pos"].shape[2])


def _segment_row(kernel: str, x: torch.Tensor, index, main: bool, by: str) -> dict:
    """One segment kernel against its twins on ``x`` (edge rows for a sum,
    node rows for a gather): relative and largest error against the plain
    twin, bit equality with the CSR walk (a sum: f32 sums in the kernel's
    order, bf16 rounded once) or the twin (a gather), a repeat, and device
    times beside the bound (bytes once over 3.35 TB/s; the sum's adds in
    f32) and the library call
    (``index_add`` into one extra row for dropped ids, ``index_select`` of
    the ids clamped at 0)."""
    from fluid_llm_tpu_torch.ops import segment_ops as so

    fn = getattr(so, kernel)
    ids = index.ids.long()
    rows = torch.where(ids >= 0, ids, index.n_rows)
    geometry = None
    gather = not kernel.startswith("segment_sum")
    if not gather:
        twin = so.segment_sum_ref
        zeros = torch.zeros(index.n_rows + 1, x.shape[1], dtype=x.dtype, device=x.device)
        library = lambda: torch.index_add(zeros, 0, rows, x)  # noqa: E731
        n_out, ops = index.n_rows * x.shape[1], x.numel()
        if kernel == "segment_sum_bf16" and x.shape[1] >= so.WIDE and x.shape[1] % 8 == 0:
            plan = K, S, R, W = so.sum_plan(x.shape[1])
            geometry = (f"ring of {S} stages of {K} edge rows a warp, {R} rows a warp, "
                        f"{W} warps a block, {so.ring_smem(x.shape[1], plan)} bytes of shared "
                        f"memory a block; the first {so.LONG_BLOCKS} rows of the long-first "
                        f"order a block each")
    else:
        twin = so.gather_ref
        clamped = ids.clamp(min=0)
        library = lambda: torch.index_select(x, 0, clamped)  # noqa: E731
        n_out, ops = ids.shape[0] * x.shape[1], 0
        vec = so.gather_vec(x.shape[1], x, x)
        depth, warps, blocks = so.gather_plan(ids.shape[0], x.shape[1], vec)
        geometry = (f"{blocks} blocks of {warps} warps, {depth} loads a lane in flight, "
                    f"{x.element_size() * vec}-byte vectors")
    out, ref = fn(x, index), twin(x, index)
    again, twin_again = fn(x, index), twin(x, index)
    torch.cuda.synchronize()
    if gather:
        exact, exact_to = bool(torch.equal(out, ref)), "the twin"
    else:  # IEEE f32 adds, one at a time: the same bits on any device
        exact, exact_to = bool(torch.equal(out, so.csr_walk(x, index))), "the CSR walk"
    return dict(
        kernel=kernel, shape=f"{'nodes' if gather else 'edges'} {tuple(x.shape)} "
        f"{x.dtype} by {by} -> {tuple(out.shape)}", main_path=main,
        rel=rel_err(out.float(), ref.float()), rel_tol=SEGMENT_REL_TOL if x.dtype == torch.float32
        else BF16_SEGMENT_REL_TOL,
        max_abs_err=(out.float() - ref.float()).abs().max().item(),
        exact=exact, exact_to=exact_to, deterministic=bool(torch.equal(again, out)),
        twin_deterministic=bool(torch.equal(twin_again, ref)),
        ms=device_ms(lambda: fn(x, index)), plain_ms=device_ms(lambda: twin(x, index)),
        library_ms=device_ms(library), geometry=geometry,
        **bound(nbytes(x, index.ids) + x.element_size() * n_out, ops, "f32"),
    )


def _segment_rows(dev, g: torch.Generator) -> list[dict]:
    """The segment sum and row gather against their twins at MeshGraphNet's
    and GAT's shapes (edge ids), GraphViT's (member ids) and in bf16."""
    from fluid_llm_tpu_torch.ops import segment_ops as so

    edges = eagle_edges(dev)
    n = int(edges.max()) + 1  # the ghost slot is the last node row
    by_edges = [so.SegmentIndex(edges[..., col], n) for col in (0, 1)]
    members = graphvit_members(dev)
    rows = []
    for kernel, col, F, main in SEGMENT_CASES:
        index = by_edges[col]
        rows_in = index.ids.shape[0] if kernel == "segment_sum" else index.n_rows
        x = torch.randn(rows_in, F, generator=g).to(dev)
        rows.append(_segment_row(kernel, x, index, main, f"edges[..., {col}]"))
    for kernel, F, main in GRAPHVIT_SEGMENT_CASES:
        rows_in = members.ids.shape[0] if kernel == "segment_sum" else members.n_rows
        x = torch.randn(rows_in, F, generator=g).to(dev)
        rows.append(_segment_row(kernel, x, members, main, "cluster members"))
    for kernel, by, F in BF16_SEGMENT_CASES:
        index = by_edges[0] if by == "edges" else members
        rows_in = index.ids.shape[0] if kernel == "segment_sum_bf16" else index.n_rows
        x = torch.randn(rows_in, F, generator=g).to(dev, torch.bfloat16)
        rows.append(_segment_row(kernel, x, index, True,
                                 "edges[..., 0]" if by == "edges" else "cluster members"))
    return rows


def _pos_embed_rows(dev, g: torch.Generator) -> list[dict]:
    """The learned positions' add (``ops/pos_embed``) at the training step's
    (64 windows x 11 frames x 60 patches, d 768) and the 350m rollout's (32
    windows, d 1024) shapes, tables 15 / 4 / 11, ids laid out as the data
    layer lays them (``data/pipeline.position_ids``): the forward equal to
    its twin bit for bit; the backward against autograd through the twin
    (whose backward is one ``index_put_(accumulate=True)`` a table, the
    library call, timed with the zero fills), equal bit for bit to the
    kernel's order (``grad_walk``) and repeated.  The twin's backward and
    the library call are timed between CUDA events (launch gaps included;
    they sort the ids), the kernels by graph replays.  Bound: bytes once
    over 3.35 TB/s (forward h, ids, tables and out; backward the gradient,
    ids and the tables' gradients), the adds in f32."""
    from fluid_llm_tpu_torch.data.pipeline import position_ids
    from fluid_llm_tpu_torch.ops import _build
    from fluid_llm_tpu_torch.ops import pos_embed as pe

    sizes = (15, 4, 11)
    rows = []
    for bs, d, backward in ((64, 768, True), (32, 1024, False)):
        ids = position_ids(11, 15, 4).reshape(1, -1, 3).expand(bs, -1, 3).reshape(-1, 3).to(dev)
        R = ids.shape[0]
        h = torch.randn(R, d, generator=g).to(dev)
        tables = [torch.randn(n, d, generator=g).to(dev) for n in sizes]
        out, ref = pe.pos_embed_fwd(h, *tables, ids), pe.pos_embed_ref(h, *tables, ids)
        again, twin_again = pe.pos_embed_fwd(h, *tables, ids), pe.pos_embed_ref(h, *tables, ids)
        torch.cuda.synchronize()
        rows.append(dict(
            kernel="pos_embed_fwd", shape=f"({R}, {d}) tables 15/4/11", main_path=True,
            rel=rel_err(out, ref), max_abs_err=(out - ref).abs().max().item(),
            exact=bool(torch.equal(out, ref)), deterministic=bool(torch.equal(again, out)),
            twin_deterministic=bool(torch.equal(twin_again, ref)), geometry=f"{-(-R * d // 4 // 1024)} blocks of 256 threads, "
            "4 16-byte vectors a thread",
            ms=device_ms(lambda: pe.pos_embed_fwd(h, *tables, ids)),
            plain_ms=device_ms(lambda: pe.pos_embed_ref(h, *tables, ids)), library_ms=None,
            **bound(nbytes(h, ids, *tables, out), 3 * R * d, "f32"),
        ))
        if not backward:
            continue
        gout = torch.randn(R, d, generator=g).to(dev)
        got = torch.cat(pe.pos_embed_grad(gout, ids, *sizes))
        again = torch.cat(pe.pos_embed_grad(gout, ids, *sizes))
        leaves = [t.detach().clone().requires_grad_() for t in tables]
        twin_out = pe.pos_embed_ref(h, *leaves, ids)
        twin_bwd = lambda: torch.autograd.grad(twin_out, leaves, gout, retain_graph=True)  # noqa: E731
        ref = torch.cat(twin_bwd())
        library = lambda: [torch.zeros(n, d, device=dev).index_put_(  # noqa: E731
            (ids[:, k],), gout, accumulate=True) for k, n in enumerate(sizes)]
        width, chunk = pe.grad_plan(R, d, sum(sizes), 4, _build.sm_count(dev))
        walk = pe.grad_walk(gout, pe.table_rows(ids, *sizes), sum(sizes), chunk)
        torch.cuda.synchronize()
        rows.append(dict(
            kernel="pos_embed_grad", shape=f"({R}, {d}) -> tables 15/4/11", main_path=True,
            rel=rel_err(got, ref), max_abs_err=(got - ref).abs().max().item(),
            exact=bool(torch.equal(got, walk)), exact_to="the walk of its order",
            deterministic=bool(torch.equal(again, got)),
            twin_deterministic=bool(torch.equal(torch.cat(twin_bwd()), ref)),
            geometry=f"{-(-R // chunk)} chunks of {chunk} rows x {-(-d // 4 // width)} slabs of "
            f"{width} threads, {pe.grad_smem(sum(sizes), width, 4)} bytes of shared memory a "
            "block; then the chunks' sums",
            ms=device_ms(lambda: pe.pos_embed_grad(gout, ids, *sizes)),
            plain_ms=event_ms(twin_bwd), library_ms=event_ms(library),
            **bound(nbytes(gout, ids, got), 3 * R * d, "f32"),
        ))
    return rows


CONFIG = os.path.join(os.path.dirname(os.path.abspath(__file__)), "configs", "training1.yaml")
FLAGSHIP = os.path.join(os.path.dirname(CONFIG), "flagship_llama.yaml")


def _counters():
    from fluid_llm_tpu_torch.ops import decode_attention as da
    from fluid_llm_tpu_torch.ops import exact_attention as xa
    from fluid_llm_tpu_torch.ops import flash_attention as fa
    from fluid_llm_tpu_torch.ops import grid_gnn_fused as gf
    from fluid_llm_tpu_torch.ops import indexed_linear as il
    from fluid_llm_tpu_torch.ops import quant_matmul as qmm
    from fluid_llm_tpu_torch.ops import segment_ops as so
    from fluid_llm_tpu_torch.ops import short_attention as sa

    return {"exact_attention": xa.causal_attention, "grid_slot_attention": gf.fused_slot_attention,
            "grid_slot_attention_bwd": gf.slot_attention_bwd,
            "flash_attention_fwd": fa.flash_forward, "flash_attention_dq": fa.flash_dq,
            "flash_attention_dkv": fa.flash_dkv, "slab_decode_attention": da.slab_decode,
            "quant_matmul_w8a8": qmm.qmm_w8a8, "quant_matmul_w8a16": qmm.qmm_w8a16,
            "segment_sum": so.segment_sum, "segment_gather": so.segment_gather,
            "segment_sum_bf16": so.segment_sum_bf16, "segment_gather_bf16": so.segment_gather_bf16,
            "indexed_linear": il.indexed_linear, "short_attention": sa.short_attention_fwd}


def reset_launches() -> None:
    for fn in _counters().values():
        fn.launches = 0


def read_launches() -> dict:
    return {name: fn.launches for name, fn in _counters().items()}


def phase_rollout(dev, seed: int, failures: list, *, streaming: bool, stacked: bool = False,
                  attn_impl: str = "auto", tag: str = "",
                  turns: tuple = (True, False, False, True)) -> dict:
    """A 251-step rollout of one configuration with seeded random weights on
    ``synthetic:1`` at seq_len 253: the main path through the entry point
    (launch counts), steps/s through the kernels and the twins in ``turns``,
    a 10-step agreement and a device profile.  ``streaming``: the flagship's
    KV-cache rollout; otherwise the OPT-125m exact rollout.  ``stacked``:
    the weights prepared in the stacked-layer layout (``FLUID_SCAN_LAYERS=1``),
    also held against the unrolled layout of the same weights;
    ``attn_impl``: the backbone's (``"short"``: the short-attention kernel)."""
    from fluid_llm_tpu_torch.config import Config
    from fluid_llm_tpu_torch import inference
    from fluid_llm_tpu_torch.data import get_dataset, make_batches
    from fluid_llm_tpu_torch.models.backbone import StackedLayers
    from fluid_llm_tpu_torch.rollout.generate import gen_seq, generate
    from fluid_llm_tpu_torch.rollout.streaming import gen_seq_streaming, generate_streaming

    tag = tag or ("streaming" if streaming else "slice")
    roll, gen = (gen_seq_streaming, generate_streaming) if streaming else (gen_seq, generate)
    cfg = Config.from_yaml(FLAGSHIP if streaming else CONFIG).replace(load_dir="synthetic:1")
    overrides = {} if attn_impl == "auto" else {"attn_impl": attn_impl}
    t0 = time.perf_counter()
    with mock.patch.dict(os.environ, {"FLUID_SCAN_LAYERS": "1" if stacked else "0"}):
        model = inference.build_seeded_model(cfg, seed, dev, **overrides)
    if isinstance(model.backbone.layers, StackedLayers) != stacked:
        failures.append(f"{tag}: layers {type(model.backbone.layers).__name__}, stacked {stacked}")
    test_ds = get_dataset(cfg.replace(seq_len=STEPS + 2), mode="test")
    batch = next(make_batches(test_ds, 1, shuffle=False, device=dev))
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    bcfg = model.backbone_cfg
    print(f"[{tag}] {cfg.llm_backbone}: {bcfg.n_layers} layers, d {bcfg.d_model}, "
          f"{bcfg.n_heads} heads, {bcfg.norm}, {bcfg.pos} positions, {bcfg.dtype}, attn_impl "
          f"{bcfg.attn_impl}, layers {type(model.backbone.layers).__name__}; "
          f"{cfg.pos_embedding_params.pos_embedding_type} embeddings, absolute time "
          f"{cfg.absolute_time_ids}; window or ring of {model.max_ctx_len} frames; "
          f"set-up {setup_s:.1f} s")

    # the main path, through the entry point a user calls
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    per_step, mean = inference.test_generate(model, test_ds, batch_size=1, pred_steps=STEPS,
                                             streaming=streaming)
    wall = time.perf_counter() - t0
    launches = read_launches()
    peak_mib = torch.cuda.max_memory_allocated() / 2**20
    want = dict.fromkeys(launches, 0)  # no gradient: no training kernel runs
    want["grid_slot_attention"] = cfg.decoder_params.gnn_layers * STEPS
    if streaming:  # every layer of every step, and of the prefill
        want["slab_decode_attention"] = bcfg.n_layers * (STEPS + 1)
        if stacked:  # and each of its linears (qkv, o, gate, up, down)
            lys = model.backbone.layers
            want["indexed_linear"] = (len(lys.attn) + len(lys.mlp)) * bcfg.n_layers * (STEPS + 1)
    else:  # layers 0..10; the sliced last block is plain
        attention = "short_attention" if attn_impl == "short" else "exact_attention"
        want[attention] = (bcfg.n_layers - 1) * STEPS
    print(f"[{tag}] test_generate(streaming={streaming}): {STEPS} steps in {wall:.3f} s (incl. "
          f"batch build); mean N-RMSE {mean:.5f}; peak device memory {peak_mib:.1f} MiB; "
          f"launches {launches} (want {want})")
    if launches != want:
        failures.append(f"{tag} launch counts {launches} != {want}")
    if per_step.shape != (STEPS,) or not bool(torch.isfinite(torch.from_numpy(per_step)).all()):
        failures.append(f"{tag} N-RMSE not finite or wrong length")

    # steady-state rate on a prepared batch, kernels and plain twins in turns
    rates = {True: [], False: []}
    want_shape = (1, RATE_STEPS + 1, 3, *model.ds_props.out_tot_size)
    for kernels in turns:
        model.kernels = kernels
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        states, _ = roll(model, batch, RATE_STEPS)
        torch.cuda.synchronize()
        rates[kernels].append(RATE_STEPS / (time.perf_counter() - t0))
        if tuple(states.shape) != want_shape or not bool(torch.isfinite(states).all()):
            failures.append(f"{tag} states {tuple(states.shape)} (want {want_shape}) or not "
                            f"finite (kernels {kernels})")
    steps_per_s, plain_steps_per_s = (statistics.median(rates[k]) for k in (True, False))
    print(f"[{tag}] {roll.__name__}: {steps_per_s:.2f} steps/s through the kernels (median; "
          f"runs {', '.join(f'{r:.2f}' for r in rates[True])}); plain twins "
          f"{plain_steps_per_s:.2f} (median; runs {', '.join(f'{r:.2f}' for r in rates[False])})")

    states, _, _, bc_mask, position_ids = batch
    out = {}
    for kernels in (True, False):
        model.kernels = kernels
        out[kernels] = gen(model, states[:, :1], bc_mask, position_ids, 10)[1]
    model.kernels = True
    errs = [rel_err(out[True][:, i], out[False][:, i]) for i in range(10)]
    ok = errs[0] <= REL_TOL
    print(f"[{tag} agreement] diffs rel err per step, kernels vs plain twins: "
          f"{', '.join(f'{e:.3e}' for e in errs)} (step 1 {'ok' if ok else 'FAIL'})")
    if not ok:
        failures.append(f"{tag} agreement step 1 rel {errs[0]}")
    # device time of a 20-step rollout against its unprofiled wall time
    n_prof = 20
    busy_ms, n_ops, idle, top = device_profile(
        lambda: gen(model, states[:, :1], bc_mask, position_ids, n_prof), 1,
        n_prof * 1e3 / steps_per_s, f"{tag} 20 steps")

    layout = None
    if stacked:  # the same weights in the unrolled layout, through its own kernels
        unrolled = inference.build_seeded_model(cfg, seed, dev, **overrides)
        ref = gen(unrolled, states[:, :1], bc_mask, position_ids, 10)[1]
        layout_errs = [rel_err(out[True][:, i], ref[:, i]) for i in range(10)]
        ok = layout_errs[0] <= REL_TOL
        print(f"[{tag} agreement] diffs rel err per step, stacked vs unrolled layout: "
              f"{', '.join(f'{e:.3e}' for e in layout_errs)} (step 1 {'ok' if ok else 'FAIL'})")
        if not ok:
            failures.append(f"{tag} stacked vs unrolled step 1 rel {layout_errs[0]}")
        # the layouts' wall time in turns, kernels on: the stacked views' host cost
        rates_by = {"stacked": [], "unrolled": []}
        for name in ("stacked", "unrolled"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            roll(model if name == "stacked" else unrolled, batch, RATE_STEPS)
            torch.cuda.synchronize()
            rates_by[name].append(RATE_STEPS / (time.perf_counter() - t0))
        med = {k: statistics.median(v) for k, v in rates_by.items()}
        print(f"[{tag} layouts] {roll.__name__} in turns: stacked {med['stacked']:.2f} steps/s "
              f"(runs {', '.join(f'{r:.2f}' for r in rates_by['stacked'])}); unrolled "
              f"{med['unrolled']:.2f} (runs {', '.join(f'{r:.2f}' for r in rates_by['unrolled'])})")
        u_busy, u_ops, u_idle, u_top = device_profile(
            lambda: gen(unrolled, states[:, :1], bc_mask, position_ids, n_prof), 1,
            n_prof * 1e3 / med["unrolled"], f"{tag} unrolled layout 20 steps")
        del unrolled
        layout = dict(rel_err=layout_errs, steps_per_s_runs=rates_by, steps_per_s=med,
                      unrolled_profile=dict(steps=n_prof, device_busy_ms=u_busy,
                                            device_ops=u_ops, idle_share=u_idle,
                                            top_device_ms=u_top))
    return dict(setup_s=setup_s, test_generate_s=wall, mean_n_rmse=mean, peak_mem_mib=peak_mib,
                steps_per_s=steps_per_s, steps_per_s_runs=rates[True],
                plain_steps_per_s=plain_steps_per_s, plain_steps_per_s_runs=rates[False],
                launches=launches, agreement_rel_err=errs, layout=layout,
                profile=dict(steps=n_prof, device_busy_ms=busy_ms, device_ops=n_ops,
                             idle_share=idle, top_device_ms=top))


TRAINABLE_PROBES = ("lora.layers.0.attn.q.A", "lora.layers.0.attn.q.B", "lora.layers.0.attn.v.m",
                    "input_emb.patch.mlp.0.weight", "decoder.gnn.convs.0.att",
                    "decoder.gnn.out.att", "bos")


def phase_train(dev, seed: int, failures: list, attn_impl: str = "auto", per_turn: int = 3):
    """Autoreg steps through ``Trainer`` on one repeated batch, in turns
    through the kernels and the twins; the training path's launch counts.
    ``attn_impl="short"``: the backbone's attention forward through the
    short-attention kernel (its backward the twin, recomputed)."""
    from fluid_llm_tpu_torch.config import Config
    from fluid_llm_tpu_torch.data import get_dataset, make_batches
    from fluid_llm_tpu_torch.main import build_model_and_trainer

    tag = "train" if attn_impl == "auto" else f"{attn_impl} train"
    overrides = {} if attn_impl == "auto" else {"attn_impl": attn_impl}
    cfg = Config.from_yaml(CONFIG).replace(load_dir=f"synthetic:{TRAIN_BS}", seed=seed)
    t0 = time.perf_counter()
    train_ds = get_dataset(cfg.replace(seq_len=cfg.autoreg_seq_len), mode="train")
    trainer = build_model_and_trainer(cfg, train_ds.ds_props(), dev, **overrides)
    model = trainer.model
    batch = next(make_batches(train_ds, TRAIN_BS, shuffle=True, seed=0, device=dev))
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    params = dict(model.named_parameters())
    n_train = sum(p.numel() for p in params.values() if p.requires_grad)
    n_frozen = sum(p.numel() for p in params.values() if not p.requires_grad)
    bcfg = model.backbone_cfg
    print(f"[{tag}] {cfg.llm_backbone}: {bcfg.n_layers} layers, {bcfg.dtype}, attn_impl "
          f"{bcfg.attn_impl}, DoRA r"
          f"{cfg.lora_config.r} unmerged, dropout {bcfg.dropout}/{cfg.lora_config.lora_dropout}/"
          f"{cfg.pos_embedding_params.input_emb_layer_dropout} (backbone/adapter/embedding); "
          f"batch {tuple(batch[0].shape)}, {TRAIN_TOKENS} tokens; {n_train} trainable, "
          f"{n_frozen} frozen parameters; set-up {setup_s:.1f} s")

    turns = (True, False, False, True)
    step_ms = {True: [], False: []}
    losses, peak_mib = [], 0.0
    reset_launches()  # the training path, driven from here
    for kernels in turns:
        model.kernels = kernels
        torch.cuda.reset_peak_memory_stats()
        for _ in range(per_turn):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss = trainer.train_step(batch)["loss"].item()
            step_ms[kernels].append((time.perf_counter() - t0) * 1e3)
            losses.append(loss)
        if kernels:
            peak_mib = max(peak_mib, torch.cuda.max_memory_allocated() / 2**20)
    launches = read_launches()
    model.kernels = True
    n_kernel_steps = per_turn * turns.count(True)
    convs = cfg.decoder_params.gnn_layers
    per_step = dict.fromkeys(launches, 0)
    per_step.update(grid_slot_attention=convs, grid_slot_attention_bwd=convs)
    if attn_impl == "short":  # the forward only: the backward is the twin
        per_step.update(short_attention=bcfg.n_layers)
    else:
        per_step.update(flash_attention_fwd=bcfg.n_layers, flash_attention_dq=bcfg.n_layers,
                        flash_attention_dkv=bcfg.n_layers)
    want = {k: v * n_kernel_steps for k, v in per_step.items()}
    med_k, med_t = statistics.median(step_ms[True]), statistics.median(step_ms[False])
    print(f"[{tag}] {len(losses)} autoreg steps on one batch (turns kernels/twins "
          f"{'/'.join('k' if t else 't' for t in turns)}, {per_turn} each): loss "
          f"{', '.join(f'{x:.5f}' for x in losses)}")
    print(f"[{tag}] step ms through the kernels: median {med_k:.2f} (runs "
          f"{', '.join(f'{x:.2f}' for x in step_ms[True])}); through the twins: median "
          f"{med_t:.2f} (runs {', '.join(f'{x:.2f}' for x in step_ms[False])}); peak device "
          f"memory over the kernel steps {peak_mib:.1f} MiB")
    print(f"[{tag}] launches over {n_kernel_steps} kernel steps {launches} (want {want}; "
          f"per step {per_step})")
    if launches != want:
        failures.append(f"{tag} launch counts {launches} != {want}")
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        failures.append(f"{tag} losses not finite or not falling: {losses}")
    no_grad = [n for n in TRAINABLE_PROBES
               if params[n].grad is None or not bool(params[n].grad.abs().sum() > 0)]
    if no_grad or any(p.grad is not None for p in params.values() if not p.requires_grad):
        failures.append(f"trainable parameters without gradient {no_grad}, or frozen with one")
    print(f"[{tag}] non-zero gradient on {', '.join(TRAINABLE_PROBES)}: "
          f"{'ok' if not no_grad else 'FAIL ' + str(no_grad)}")

    # device busy time per kernel step (profiler), against the unprofiled step
    busy_ms, n_ops, idle, top = device_profile(
        lambda: trainer.train_step(batch)["loss"].item(), 2, med_k, tag)
    return trainer, batch, dict(
        setup_s=setup_s, losses=losses, step_ms=step_ms[True], plain_step_ms=step_ms[False],
        median_step_ms=med_k, plain_median_step_ms=med_t, peak_mem_mib=peak_mib,
        launches=launches, launches_per_step=per_step, device_busy_ms=busy_ms,
        device_ops_per_step=n_ops, idle_share=idle, top_device_ms=top,
    )


def device_profile(fn, n: int, wall_ms: float, tag: str, track: tuple[str, ...] = ()):
    """Device busy ms per call of ``fn`` (profiler over ``n`` calls), device
    ops per call, the idle share against the unprofiled ``wall_ms`` per
    call, and the 8 largest device-time entries, then any other entry whose
    name contains one of ``track``; printed under ``tag``, with the host's
    side: the operators' self CPU time and count per call (the rest of the
    wall time is Python between them) and the 5 largest."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    device = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in device) / 1e3 / n
    n_ops = sum(e.count for e in device) / n
    idle = 1.0 - busy_ms / wall_ms if busy_ms > 0 else None
    ranked = sorted(device, key=lambda e: -e.self_device_time_total)
    ranked = ranked[:8] + [e for e in ranked[8:] if any(t in e.key for t in track)]
    top = [(_short(e.key), e.self_device_time_total / 1e3 / n) for e in ranked]
    host = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CPU]
    host_ms = sum(e.self_cpu_time_total for e in host) / 1e3 / n
    host_top = sorted(host, key=lambda e: -e.self_cpu_time_total)[:5]
    print(f"[{tag}] device busy {busy_ms:.3f} ms per call in {n_ops:.0f} device ops (profiler, "
          f"{n} calls) of {wall_ms:.3f} ms: idle share "
          f"{'not measured' if idle is None else f'{idle:.3f}'}; top: "
          + "; ".join(f"{k} {t:.3f} ms" for k, t in top))
    print(f"[{tag}] host (profiled): operators' self CPU {host_ms:.3f} ms in "
          f"{sum(e.count for e in host) / n:.0f} operators per call; top: "
          + "; ".join(f"{e.key} {e.self_cpu_time_total / 1e3 / n:.3f} ms ({e.count / n:.0f})"
                      for e in host_top))
    return busy_ms, n_ops, idle, top


def _short(key: str) -> str:
    """A profiler event's name without return type, namespaces or arguments."""
    return re.sub(r"^void |\(anonymous namespace\)::|at::native::", "", key).split("(")[0][:60]


def phase_train_agreement(trainer, batch, seed: int, failures: list,
                          tag: str = "train agreement") -> dict:
    """One step's loss and trainable gradient, kernels vs twins, from the
    same weights, batch and dropout seed (no optimizer step)."""
    model = trainer.model
    named = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
    res = {}
    for kernels in (True, False):
        model.kernels = kernels
        model.zero_grad(set_to_none=True)
        trainer.generator.manual_seed(seed)
        loss, _ = trainer.mode_loss(batch, "autoreg")
        loss.backward()
        res[kernels] = (loss.item(), {n: p.grad.detach().float().flatten() for n, p in named})
    model.kernels = True
    model.zero_grad(set_to_none=True)
    (lk, gk), (lt, gt) = res[True], res[False]
    loss_rel = abs(lk - lt) / abs(lt)
    grad_rel = rel_err(torch.cat(list(gk.values())), torch.cat(list(gt.values())))
    groups = {}
    for prefix in ("lora", "input_emb", "decoder", "bos"):
        names = [n for n in gk if n.split(".")[0] == prefix]
        groups[prefix] = rel_err(torch.cat([gk[n] for n in names]), torch.cat([gt[n] for n in names]))
    ok = loss_rel <= REL_TOL and grad_rel <= GRAD_TOL
    print(f"[{tag}] loss {lk:.6f} (kernels) vs {lt:.6f} (twins): rel {loss_rel:.3e} "
          f"(bound {REL_TOL}); trainable gradient rel L2 {grad_rel:.3e} (bound {GRAD_TOL}); by "
          f"group {', '.join(f'{k} {v:.3e}' for k, v in groups.items())} "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append(f"{tag} loss rel {loss_rel}, gradient rel {grad_rel}")
    return dict(loss_kernels=lk, loss_twins=lt, loss_rel=loss_rel, grad_rel=grad_rel,
                grad_rel_by_group=groups)


def phase_entry_points(dev, seed: int, failures: list, tmp: str) -> dict:
    """``main`` (2 epochs) -> ``continue_train`` (1 epoch) -> ``inference.main
    --checkpoint_dir``, on the card, checkpoints under ``tmp/runs``."""
    from fluid_llm_tpu_torch.config import Config
    from fluid_llm_tpu_torch import continue_train, inference
    from fluid_llm_tpu_torch import main as train_main
    from fluid_llm_tpu_torch.train import checkpoint as ckpt

    res = {}
    os.makedirs(tmp, exist_ok=True)
    runs = os.path.join(tmp, "runs")
    cfg_path = os.path.join(tmp, "training.yaml")
    Config.from_yaml(CONFIG).replace(load_dir=f"synthetic:{TRAIN_BS}", seed=seed, num_epochs=2,
                                     checkpoint_save_path=runs).to_yaml(cfg_path)
    jl = os.path.join(tmp, "metrics.jsonl")
    t0 = time.perf_counter()
    train_main.main(["--config_path", cfg_path, "--device", str(dev), "--metrics_jsonl", jl])
    res["main_s"] = time.perf_counter() - t0
    run = ckpt.get_save_folder(runs, -1)
    res["steps_after_main"] = sorted(d for d in os.listdir(run)
                                     if os.path.isdir(os.path.join(run, d)))
    ckpt.load_config(run).replace(num_epochs=1).to_yaml(os.path.join(run, "config.yaml"))
    t0 = time.perf_counter()
    continue_train.main(["--checkpoint_dir", runs, "--device", str(dev), "--metrics_jsonl", jl])
    res["continue_s"] = time.perf_counter() - t0
    with open(jl) as f:
        logs = [json.loads(line) for line in f]
    t0 = time.perf_counter()
    mean = inference.main(["--checkpoint_dir", runs, "--device", str(dev), "--load_dir",
                           "synthetic:1", "--seq_len", "27", "--pred_steps", "25"])
    res["inference_s"] = time.perf_counter() - t0
    res.update(epochs=[m["epoch"] for m in logs],
               train_loss=[m["train/Autoreg/loss"] for m in logs],
               val_n_rmse=[m.get("val/Gen/N_RMSE") for m in logs], inference_mean_n_rmse=mean)
    # validation runs every 3rd epoch of a run: main's first and continue_train's
    ok = (res["epochs"] == [0, 1, 1] and all(math.isfinite(x) for x in res["train_loss"])
          and [x is not None for x in res["val_n_rmse"]] == [True, False, True]
          and all(math.isfinite(x) for x in res["val_n_rmse"] if x is not None)
          and math.isfinite(mean))
    print(f"[entry points] main 2 epochs in {res['main_s']:.1f} s (checkpoints "
          f"{res['steps_after_main']}), continue_train 1 epoch in {res['continue_s']:.1f} s, "
          f"epochs logged {res['epochs']}, train loss {res['train_loss']}, val N-RMSE "
          f"{res['val_n_rmse']}; inference from the checkpoint, 25 steps in "
          f"{res['inference_s']:.1f} s: mean N-RMSE {mean:.5f} {'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append(f"entry points: {res}")
    return res


def phase_flagship_entry_points(dev, seed: int, failures: list, tmp: str) -> dict:
    """``main`` trains a copy of the flagship config for 1 epoch
    (checkpoints under ``tmp/runs``); from its checkpoint ``inference.main
    --streaming`` and the exact ``inference.main`` each roll out 25 steps;
    the launches of each run."""
    from fluid_llm_tpu_torch.config import Config
    from fluid_llm_tpu_torch import inference
    from fluid_llm_tpu_torch import main as train_main

    cfg = Config.from_yaml(FLAGSHIP)
    n_layers, convs, n_steps = 12, cfg.decoder_params.gnn_layers, 25
    res = {}
    os.makedirs(tmp, exist_ok=True)
    runs = os.path.join(tmp, "runs")
    cfg_path = os.path.join(tmp, "flagship.yaml")
    cfg.replace(load_dir=f"synthetic:{TRAIN_BS}", seed=seed, num_epochs=1,
                checkpoint_save_path=runs).to_yaml(cfg_path)
    reset_launches()
    t0 = time.perf_counter()
    train_main.main(["--config_path", cfg_path, "--device", str(dev)])
    res["main_s"] = time.perf_counter() - t0
    res["main_launches"] = read_launches()
    for streaming in (True, False):
        reset_launches()
        t0 = time.perf_counter()
        mean = inference.main(["--checkpoint_dir", runs, "--device", str(dev), "--load_dir",
                               "synthetic:1", "--seq_len", str(n_steps + 2), "--pred_steps",
                               str(n_steps)] + (["--streaming"] if streaming else []))
        key = "streaming" if streaming else "exact"
        res[f"{key}_s"], res[f"{key}_n_rmse"] = time.perf_counter() - t0, mean
        res[f"{key}_launches"] = read_launches()
    want_stream = dict.fromkeys(res["streaming_launches"], 0)
    want_stream.update(slab_decode_attention=n_layers * (n_steps + 1),
                       grid_slot_attention=convs * n_steps)
    want_exact = dict.fromkeys(res["exact_launches"], 0)
    want_exact.update(exact_attention=(n_layers - 1) * n_steps, grid_slot_attention=convs * n_steps)
    trained = res["main_launches"]
    ok = (res["streaming_launches"] == want_stream and res["exact_launches"] == want_exact
          and trained["flash_attention_fwd"] > 0 and trained["flash_attention_dkv"] > 0
          and trained["slab_decode_attention"] == 0
          and math.isfinite(res["streaming_n_rmse"]) and math.isfinite(res["exact_n_rmse"]))
    print(f"[flagship entry points] main 1 epoch of flagship_llama.yaml on synthetic:{TRAIN_BS} "
          f"in {res['main_s']:.1f} s, launches {trained}; inference --streaming from its "
          f"checkpoint, {n_steps} steps in {res['streaming_s']:.1f} s: N-RMSE "
          f"{res['streaming_n_rmse']:.5f}, launches {res['streaming_launches']} (want "
          f"{want_stream}); exact inference, {n_steps} steps in {res['exact_s']:.1f} s: N-RMSE "
          f"{res['exact_n_rmse']:.5f}, launches {res['exact_launches']} (want {want_exact}) "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append(f"flagship entry points: {res}")
    return res


def _client_frames(ds, n: int):
    """The first ``n`` raw grid frames and the mask of test trajectory 0, as
    a client holds them (physical units, the dataset's own grid)."""
    import numpy as np

    from fluid_llm_tpu_torch.core.interp import resample_to_grid

    src = ds.get_trajectory(0)
    grid = resample_to_grid(torch.from_numpy(src.node_states[:n]), torch.from_numpy(src.vert_idx),
                            torch.from_numpy(src.weights), torch.from_numpy(src.mask))
    return grid.numpy(), np.asarray(src.mask, np.uint8)


def _post_status(base: str, states, mask, pred_steps: int):
    """One ``POST /v1/rollout``: (HTTP status, reply)."""
    import urllib.error
    import urllib.request

    from fluid_llm_tpu_torch.tools import serve as srv

    body = json.dumps({"states": srv._b64(states), "shape": list(states.shape),
                       "mask": srv._b64(mask), "pred_steps": pred_steps}).encode()
    req = urllib.request.Request(f"{base}/v1/rollout", data=body,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=600) as r:
            return r.status, json.load(r)
    except urllib.error.HTTPError as e:
        return e.code, json.load(e)


def _post(base: str, states, mask, pred_steps: int):
    """One ``POST /v1/rollout`` that must succeed: (prediction, response,
    wall seconds)."""
    from fluid_llm_tpu_torch.tools import serve as srv

    t0 = time.perf_counter()
    code, out = _post_status(base, states, mask, pred_steps)
    wall = time.perf_counter() - t0
    if code != 200:
        raise RuntimeError(f"POST /v1/rollout answered {code}: {out}")
    return srv._unb64(out["states"], out["shape"], "float32"), out, wall


def _linear_bytes(backbone) -> int:
    """Bytes of the backbone's stored linear weights (int8 q and f32 scales,
    or the float weights)."""
    from fluid_llm_tpu_torch.ops.quant import QuantLinear

    return sum(nbytes(m.q, m.scale) if isinstance(m, QuantLinear) else nbytes(m.weight)
               for m in backbone.modules() if isinstance(m, (QuantLinear, torch.nn.Linear)))


def phase_serve(dev, failures: list, runs: str) -> dict:
    """The int8 serving daemon on the flagship checkpoint of phase 10, over
    HTTP on 127.0.0.1: launches of one 251-step request, agreement of the
    int8 kernels with their twins, int8 against dense, latency and memory."""
    import threading
    import urllib.request

    import numpy as np

    from fluid_llm_tpu_torch.rollout.streaming import generate_streaming
    from fluid_llm_tpu_torch.tools import serve as srv

    res = {}
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    eng = srv.load_engine(runs, buckets=(50, STEPS), quant="int8", qmm_mode="w8a8",
                          device=str(dev))
    res["load_s"] = time.perf_counter() - t0
    bcfg, model = eng.model.backbone_cfg, eng.model
    httpd = srv.serve(eng, "127.0.0.1", 0)
    server = threading.Thread(target=httpd.serve_forever, daemon=True)
    server.start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        t0 = time.perf_counter()
        eng.warmup()
        res["warmup_s"] = time.perf_counter() - t0
        grid, mask = _client_frames(eng.dataset, 3)
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        pred, out, wall = _post(base, grid[:1], mask, STEPS)
        launches = read_launches()
        res["peak_mem_mib"] = torch.cuda.max_memory_allocated() / 2**20
        lat = [wall]
        pred3, _, wall3 = _post(base, grid, mask, 50)
        with urllib.request.urlopen(f"{base}/v1/stats", timeout=60) as r:
            stats = json.load(r)
    finally:
        httpd.shutdown()
        httpd.server_close()
        server.join()
    convs = eng.cfg.decoder_params.gnn_layers
    want = dict.fromkeys(launches, 0)
    want.update(quant_matmul_w8a8=7 * bcfg.n_layers * (STEPS + 1),
                slab_decode_attention=bcfg.n_layers * (STEPS + 1),
                grid_slot_attention=convs * STEPS)
    inside = ~mask.astype(bool)
    in_units = abs(pred[0, 0][inside].mean() - grid[0, 0][inside].mean()) < 10 * (
        abs(grid[0, 0][inside].mean()) + 1)
    ok = (launches == want and pred.shape == (STEPS, 3, *grid.shape[-2:])
          and pred3.shape == (50, 3, *grid.shape[-2:]) and bool(np.isfinite(pred).all())
          and bool(np.isfinite(pred3).all()) and in_units and eng.streaming
          and stats["requests"] == len(lat) + 1 and stats["errors"] == 0)
    print(f"[serve] load_engine(quant=int8, w8a8) of {runs}: streaming {eng.streaming}, "
          f"{bcfg.n_layers} layers at d {bcfg.d_model}, loaded in {res['load_s']:.1f} s, warm-up "
          f"(buckets 50 and {STEPS}) {res['warmup_s']:.1f} s; {len(lat)} requests of {STEPS} "
          f"steps in "
          f"{', '.join(f'{x:.3f}' for x in lat)} s ({', '.join(f'{STEPS / x:.2f}' for x in lat)} "
          f"steps/s, over HTTP incl. the response); 50 steps from 3 context frames in "
          f"{wall3:.3f} s; /v1/stats latency {stats.get('latency_ms')}, by program "
          f"{stats['by_program']}; launches over one {STEPS}-step request {launches} (want "
          f"{want}); peak device memory {res['peak_mem_mib']:.1f} MiB; outputs "
          f"{pred.shape} finite and in physical units {'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append(f"serve: launches {launches} (want {want}), shapes {pred.shape} "
                        f"{pred3.shape}, in units {in_units}, stats {stats}")

    # kernels against twins on the same int8 weights, 10 steps
    batch = eng.build_batch(grid[:1], mask.astype(bool), 10)
    diffs = {}
    for kernels in (True, False):
        model.kernels = kernels
        diffs[kernels] = generate_streaming(model, *batch, 10)[1]
    model.kernels = True
    errs = [rel_err(diffs[True][:, i], diffs[False][:, i]) for i in range(10)]
    agree = errs[0] <= REL_TOL

    # int8 against dense serving of the same checkpoint: 50-step requests in
    # turns (wall time, then one profiled request each: device time, ops,
    # idle share), and the outputs over 3 steps
    dense = srv.load_engine(runs, buckets=(3, 50), device=str(dev))
    dense.warmup()
    engines = {"int8": eng, "dense": dense}
    walls = {k: [] for k in engines}
    for k, e in engines.items():
        t0 = time.perf_counter()
        e.request(grid[:1], mask, 50)
        walls[k].append((time.perf_counter() - t0) * 1e3)
    prof = {}
    for k, e in engines.items():
        wall50 = statistics.median(walls[k])
        busy_ms, n_ops, idle, top = device_profile(lambda: e.request(grid[:1], mask, 50), 1,
                                                   wall50, f"serve 50-step request, {k}")
        prof[k] = dict(steps=50, wall_ms=wall50, wall_ms_runs=walls[k], device_busy_ms=busy_ms,
                       device_ops=n_ops, idle_share=idle, top_device_ms=top)
    print(f"[serve] 50-step requests in turns, median wall ms per step: int8 "
          f"{prof['int8']['wall_ms'] / 50:.3f} (runs {', '.join(f'{x:.2f}' for x in walls['int8'])} "
          f"ms), dense {prof['dense']['wall_ms'] / 50:.3f} (runs "
          f"{', '.join(f'{x:.2f}' for x in walls['dense'])} ms); device ops a step int8 "
          f"{prof['int8']['device_ops'] / 50:.1f}, dense {prof['dense']['device_ops'] / 50:.1f}; "
          f"device busy ms a step int8 {prof['int8']['device_busy_ms'] / 50:.4f}, dense "
          f"{prof['dense']['device_busy_ms'] / 50:.4f}")
    quant_pred = eng.predict(grid[:1], mask, 3)
    dense_pred = dense.predict(grid[:1], mask, 3)
    int8_bytes = _linear_bytes(model.backbone)
    dense_bytes = _linear_bytes(dense.model.backbone)
    del eng, model, httpd, dense, engines
    q_vs_d = float(np.abs(quant_pred - dense_pred).mean() / (np.abs(dense_pred).mean() + 1e-6))
    close = q_vs_d < 0.05
    print(f"[serve agreement] diffs rel err per step, int8 kernels vs twins: "
          f"{', '.join(f'{e:.3e}' for e in errs)} (step 1 {'ok' if agree else 'FAIL'}); int8 vs "
          f"dense engines, 3 steps: mean |diff| / mean |dense| {q_vs_d:.4e} (bound 0.05) "
          f"{'ok' if close else 'FAIL'}; backbone linear weights {dense_bytes} bytes dense (bf16) "
          f"vs {int8_bytes} int8 (q + f32 scales)")
    if not agree or not close:
        failures.append(f"serve agreement step 1 {errs[0]}, int8 vs dense {q_vs_d}")
    res.update(launches=launches, request_s=lat, steps_per_s=[STEPS / x for x in lat],
               ctx3_50_steps_s=wall3, stats=stats, agreement_rel_err=errs,
               int8_vs_dense=q_vs_d, weight_bytes_dense=dense_bytes, weight_bytes_int8=int8_bytes,
               profile=prof["int8"], dense_profile=prof["dense"])
    return res


def phase_serve_exact(dev, failures: list, runs: str) -> dict:
    """The daemon's exact rollout with int8 weights in w8a16, on phase 8's
    ``training1.yaml`` checkpoint (OPT-125m, DoRA merged at load): one
    25-step request and its launches; 10 steps kernels vs twins on the same
    int8 weights."""
    import numpy as np

    from fluid_llm_tpu_torch.rollout.generate import generate
    from fluid_llm_tpu_torch.tools import serve as srv

    n_steps = 25
    t0 = time.perf_counter()
    eng = srv.load_engine(runs, buckets=(n_steps,), streaming="off", quant="int8",
                          qmm_mode="w8a16", device=str(dev))
    load_s = time.perf_counter() - t0
    grid, mask = _client_frames(eng.dataset, 1)
    eng.warmup()
    reset_launches()
    t0 = time.perf_counter()
    pred = eng.request(grid, mask, n_steps)
    wall = time.perf_counter() - t0
    launches = read_launches()
    n_layers, convs = eng.model.backbone_cfg.n_layers, eng.cfg.decoder_params.gnn_layers
    want = dict.fromkeys(launches, 0)
    want.update(quant_matmul_w8a16=6 * n_layers * n_steps,
                exact_attention=(n_layers - 1) * n_steps, grid_slot_attention=convs * n_steps)

    # kernels against twins on the same int8 weights, 10 steps
    model = eng.model
    batch = eng.build_batch(grid, mask.astype(bool), 10)
    diffs = {}
    for kernels in (True, False):
        model.kernels = kernels
        diffs[kernels] = generate(model, *batch, 10)[1]
    model.kernels = True
    errs = [rel_err(diffs[True][:, i], diffs[False][:, i]) for i in range(10)]
    # device time a step of the w8a16 rollout against its unprofiled wall time
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    generate(model, *batch, 10)
    torch.cuda.synchronize()
    wall10 = (time.perf_counter() - t0) * 1e3
    busy_ms, n_ops, idle, top = device_profile(lambda: generate(model, *batch, 10), 1, wall10,
                                               "serve exact 10 steps")
    print(f"[serve exact] device time a step {busy_ms / 10:.3f} ms in {n_ops / 10:.0f} device "
          f"ops (profiler); wall {wall10 / 10:.3f} ms a step; idle share "
          f"{'not measured' if idle is None else f'{idle:.3f}'}")
    ok = (launches == want and not eng.streaming and pred.shape == (n_steps, 3, *grid.shape[-2:])
          and bool(np.isfinite(pred).all()) and errs[0] <= REL_TOL)
    print(f"[serve exact] load_engine(quant=int8, w8a16, streaming off) of {runs}: "
          f"{eng.cfg.llm_backbone}, loaded in {load_s:.1f} s; one {n_steps}-step request in "
          f"{wall:.3f} s ({n_steps / wall:.2f} steps/s); launches {launches} (want {want}); "
          f"output {pred.shape} finite; diffs rel err per step, kernels vs twins: "
          f"{', '.join(f'{e:.3e}' for e in errs)} (step 1 bound {REL_TOL}) "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append(f"serve exact: launches {launches} (want {want}), shape {pred.shape}, "
                        f"agreement step 1 {errs[0]}")
    return dict(load_s=load_s, request_s=wall, launches=launches, agreement_rel_err=errs,
                profile=dict(steps=10, wall_ms=wall10, device_busy_ms=busy_ms, device_ops=n_ops,
                             idle_share=idle, top_device_ms=top))


def graph_launches_per_step(model: str, n_processor: int = 15, n_heads: int = 4,
                            dtype: str = "f32", nb_gn: int = 4) -> dict:
    """Segment launches of one rollout step of a window: kernel -> (forward,
    what the backward adds).  MeshGraphNet gathers positions at both edge
    ends, then in each block senders and receivers and sums once; GAT does
    both gathers and two sums (the weighted rows and the weights) per head
    of each block.  GraphViT gathers positions at both edge ends and by
    cluster member and sums the relative encoding into members (f32 under
    every dtype); its nb_gn encoder blocks and the retrieve block gather
    twice and sum once each, the pooling gathers node features and the
    encoding by member, and the tokens are summed into members.  The
    backward sums each gather of node features and gathers back each sum of
    edge features or tokens; the positions and the encoding take no
    gradient.  Under ``--dtype bf16`` all but the position and encoding
    calls run the bf16 kernels."""
    P, HP, blocks = n_processor, n_heads * n_processor, nb_gn + 1
    if model == "mgn":
        pos, fwd, bwd = (2, 0), (2 * P, P), (P, 2 * P)
    elif model == "gat":
        pos, fwd, bwd = (2, 0), (2 * HP, 2 * HP), (2 * HP, 2 * HP)
    else:
        pos, fwd, bwd = (3, 1), (2 * blocks + 2, blocks + 1), (blocks + 1, 2 * blocks + 1)
    net = "_bf16" if dtype == "bf16" else ""
    out = {"segment_gather": [pos[0], 0], "segment_sum": [pos[1], 0]}
    for kernel, f, b in (("segment_gather", fwd[0], bwd[0]), ("segment_sum", fwd[1], bwd[1])):
        counts = out.setdefault(kernel + net, [0, 0])
        counts[0] += f
        counts[1] += b
    return {k: tuple(v) for k, v in out.items()}


def want_launches(launches: dict, per_step: dict, train_steps: int, fwd_steps: int) -> dict:
    """Every kernel 0 but the segment kernels: ``train_steps`` rollout steps
    forward and backward, ``fwd_steps`` forward only."""
    want = dict.fromkeys(launches, 0)
    for k, (f, b) in per_step.items():
        want[k] = train_steps * (f + b) + fwd_steps * f
    return want


# One f32 MeshGraphNet step, kernels vs twins: the loss within 1e-5; the
# gradient within 1e-3 rel L2.  The twins' index_add_ adds with atomics in
# another order each run, which moves the forward's last bits and with
# them ReLUs whose pre-activation lies within rounding of 0: two runs of
# the twins themselves differed by up to 1.7e-4 (H100), the kernels and
# the twins by 2.5e-5 - 8.8e-5.  The kernels repeat bit for bit.  GraphViT
# is held to the same bounds.
GRAPH_LOSS_TOL, GRAPH_GRAD_TOL = 1e-5, 1e-3
# Under --dtype bf16 the twins' last-bit moves are rounded to bf16 where
# they cross a rounding boundary (2^-8 relative at that element), and
# carried through the window from there.
BF16_GRAPH_LOSS_TOL, BF16_GRAPH_GRAD_TOL = 1e-2, 5e-2


def _nonzero(launches: dict) -> dict:
    return {k: v for k, v in launches.items() if v}


def run_graph_cli(argv: list, tag: str, failures: list) -> dict:
    """``baselines_cli.main(argv)`` with the launch counters read around it:
    the segment launches must equal the count from the code (graph models),
    every other kernel 0; the checkpoint and a CSV row a step written; the
    N-RMSE and losses finite."""
    from fluid_llm_tpu_torch import baselines_cli as cli

    args = cli.parse_args(argv)
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = cli.main(argv)
    wall = time.perf_counter() - t0
    launches = read_launches()
    peak_mib = torch.cuda.max_memory_allocated() / 2**20
    if args.model == "dilresnet":
        per_step, want = {}, dict.fromkeys(launches, 0)
    else:
        per_step = graph_launches_per_step(args.model, args.n_processor, args.n_heads,
                                           args.dtype)
        val = math.ceil(args.n_traj / args.batch_size) * args.epoch * (args.horizon_val - 1)
        want = want_launches(launches, per_step, out["train_steps"] * (args.horizon_train - 1),
                             val + out["n_test"] * (args.horizon_eval - 1))
    with open(out["csv"]) as f:
        csv_rows = f.read().splitlines()
    n_rmse = out["n_rmse"]
    losses = out.get("val_loss", []) + out["train_loss"]
    ok = (launches == want and os.path.exists(out["checkpoint"])
          and len(csv_rows) == args.horizon_eval + 1 and n_rmse.shape == (args.horizon_eval,)
          and bool(torch.isfinite(torch.from_numpy(n_rmse)).all())
          and all(math.isfinite(x) for x in losses))
    eval_rate = out["eval_steps"] / out["eval_s"]
    print(f"[{tag}] baselines_cli {' '.join(argv[:argv.index('--device')])} in {wall:.1f} s: "
          f"{out['train_steps']} train steps (loss {out['train_loss']}; epochs "
          f"{', '.join(f'{x:.2f}' for x in out['epoch_s'])} s), val loss "
          f"{out.get('val_loss')}; eval of {out['n_test']} trajectories x "
          f"{args.horizon_eval - 1} steps at {eval_rate:.1f} steps/s, N-RMSE mean "
          f"{float(n_rmse.mean()):.5f}{', probes ' + str(out['probes']) if 'probes' in out else ''}"
          f", CSV {len(csv_rows) - 1} rows; peak device memory {peak_mib:.1f} MiB; launches "
          f"{_nonzero(launches)} (want {_nonzero(want)}, every other kernel 0: per rollout step "
          f"(forward, backward) {per_step}) {'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append(f"{tag} {argv[:4]}: launches {launches} (want {want}), summary {out}")
    return dict(wall_s=wall, peak_mem_mib=peak_mib, launches=launches, want=want,
                eval_steps_per_s=eval_rate, mean_n_rmse=float(n_rmse.mean()),
                n_rmse=[float(x) for x in n_rmse],
                **{k: v for k, v in out.items() if k != "n_rmse"})


def one_batch(args, dev):
    """The model of ``args`` (seed 1, as the CLI draws it), its normalizer
    state and the first training batch of its dataset on ``dev``."""
    from fluid_llm_tpu_torch import baselines_cli as cli
    from fluid_llm_tpu_torch.data.eagle_mesh import iterate_graph_batches

    model, norm = cli.build_model(args, dev)
    ds = cli.build_dataset(args, "train", args.horizon_train)
    batch = cli.to_device(next(iterate_graph_batches(
        ds, args.batch_size, shuffle=False, ghost_type_value=cli.ghost_type(args),
        reorder=cli.order_mode(args))), dev)
    return model, norm, batch


def step_turns(steps: dict, per_turn: int = 2) -> dict:
    """Each ``steps[key]()`` (one synchronised train step) timed in turns
    a, b, b, a: key -> wall ms of each step."""
    keys = list(steps)
    ms = {k: [] for k in keys}
    for key in keys + keys[::-1]:
        for _ in range(per_turn):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            steps[key]()
            ms[key].append((time.perf_counter() - t0) * 1e3)
    return ms


def kernels_vs_twins(args, model, norm, batch, seed: int) -> dict:
    """One window's loss and gradient through the kernels and the twins,
    from the same weights and noise, twice each (kernels, twins, kernels,
    twins): the relative differences, the kernels' repeat and the twins'
    own spread."""
    from fluid_llm_tpu_torch import baselines_cli as cli

    state = {k: v.clone() for k, v in model.state_dict().items()}
    noise = torch.Generator(device=batch["state"].device)
    runs = []
    for kernels in (True, False, True, False):
        model.load_state_dict(state)
        model.kernels = kernels
        model.zero_grad(set_to_none=True)
        noise.manual_seed(seed)
        _, oh, tgt, _ = cli.apply_model(args, model, norm, batch, train=True, generator=noise)
        loss = cli.graph_loss(args, oh, tgt, batch["mask"])
        loss.backward()
        runs.append((loss.item(), torch.cat([p.grad.flatten() for p in model.parameters()])))
    model.kernels = True
    (lk, gk), (lt, gt), (lk2, gk2), (_, gt2) = runs
    return dict(loss_kernels=lk, loss_twins=lt, loss_rel=abs(lk - lt) / abs(lt),
                grad_rel=rel_err(gk, gt), twin_repeat_grad_rel=rel_err(gt2, gt),
                step_repeat_bit_equal=lk == lk2 and bool(torch.equal(gk, gk2)))


def phase_graph_baselines(dev, seed: int, failures: list, tmp: str) -> dict:
    """``baselines_cli.main`` at the EAGLE geometry (synthetic 84x42 mesh,
    batch 4, 15 blocks at width 128): MeshGraphNet for 2 epochs of one
    step on 4 trajectories, validation, the 101-step eval of 4 test
    trajectories, checkpoint and CSV; GAT (4 heads) for 1 epoch and a
    26-step eval (EAGLE_GAT_EVAL).  The
    segment launches of each run must match the count from the code.  Then,
    on one MeshGraphNet batch: the launches of one train step, step ms
    through the kernels and the twins in turns, the device profile, and one
    step's loss and gradient kernels vs twins; the segment sum kernel
    repeated bit for bit on the batch's receivers."""
    from fluid_llm_tpu_torch import baselines_cli as cli
    from fluid_llm_tpu_torch.ops import segment_ops as so

    common = ["--dataset_path", "synthetic", "--mesh_nodes", EAGLE_MESH,
              "--batch_size", str(EAGLE_BS), "--n_processor", str(EAGLE_BLOCKS),
              "--n_traj", "4", "--device", str(dev), "--save_dir", os.path.join(tmp, "baselines")]
    # GAT's eval cut to 25 steps (EAGLE_GAT_EVAL): 21 steps/s at this geometry
    res = {name: run_graph_cli(["--model", name, "--epoch", str(epochs)] + extra + common,
                               "graph baselines", failures)
           for name, epochs, extra in (("mgn", 2, []),
                                       ("gat", 1, ["--horizon_eval", str(EAGLE_GAT_EVAL)]))}

    # one MeshGraphNet batch: a step's launches, step ms, profile, agreement
    args = cli.parse_args(["--model", "mgn"] + common)
    model, norm, batch = one_batch(args, dev)
    opt = cli.make_optimizer(model, args.lr)
    noise = torch.Generator(device=dev).manual_seed(seed)

    def step():
        return cli.train_step(args, model, norm, opt, batch, args.lr, noise)[1].item()

    reset_launches()
    step()
    step_launches = read_launches()
    want = want_launches(step_launches, graph_launches_per_step("mgn", args.n_processor),
                         args.horizon_train - 1, 0)

    def with_kernels(kernels):
        def run():
            model.kernels = kernels
            step()
        return run

    step_ms = step_turns({True: with_kernels(True), False: with_kernels(False)})
    model.kernels = True
    med_k, med_t = (statistics.median(step_ms[k]) for k in (True, False))
    print(f"[graph baselines] MeshGraphNet train step (batch {tuple(batch['state'].shape)}, "
          f"edges {tuple(batch['edges'].shape)}): launches {_nonzero(step_launches)} (want "
          f"{_nonzero(want)}, every other kernel 0); step ms through the kernels median "
          f"{med_k:.2f} (runs {', '.join(f'{x:.2f}' for x in step_ms[True])}), through the "
          f"twins median {med_t:.2f} (runs {', '.join(f'{x:.2f}' for x in step_ms[False])})")
    if step_launches != want:
        failures.append(f"graph baselines step launches {step_launches} != {want}")
    busy_ms, n_ops, idle, top = device_profile(step, 2, med_k, "graph baselines train step",
                                               track=("segment_",))

    agree = kernels_vs_twins(args, model, norm, batch, seed)
    n = batch["mesh_pos"].shape[2]
    receivers = batch["edges"][:, 0, :, 1]
    index = so.SegmentIndex(receivers, n)
    values = torch.randn(index.ids.shape[0], 128, device=dev, generator=noise)
    sum_repeat = bool(torch.equal(so.segment_sum(values, index), so.segment_sum(values, index)))
    index_ms = event_ms(lambda: so.SegmentIndex(receivers, n).csr())
    ok = (agree["loss_rel"] <= GRAPH_LOSS_TOL and agree["grad_rel"] <= GRAPH_GRAD_TOL
          and sum_repeat)
    print(f"[graph baselines agreement] one step, kernels vs twins: loss "
          f"{agree['loss_kernels']:.7f} vs {agree['loss_twins']:.7f} (rel "
          f"{agree['loss_rel']:.3e}, bound {GRAPH_LOSS_TOL}), gradient rel L2 "
          f"{agree['grad_rel']:.3e} (bound {GRAPH_GRAD_TOL}; the twins against themselves "
          f"{agree['twin_repeat_grad_rel']:.3e}); the kernels' step repeated bit for bit: "
          f"{agree['step_repeat_bit_equal']}; segment sum on the receivers (F 128) repeated bit "
          f"for bit: {sum_repeat}; one segment index (flatten, stable sort, search) "
          f"{index_ms:.4f} ms {'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append(f"graph baselines agreement: {agree}, segment sum repeat {sum_repeat}")
    res.update(launches=res["mgn"]["launches"], step_launches=step_launches,
               step_ms=step_ms[True], plain_step_ms=step_ms[False], median_step_ms=med_k,
               plain_median_step_ms=med_t, device_busy_ms=busy_ms, device_ops_per_step=n_ops,
               idle_share=idle, top_device_ms=top, sum_repeat_bit_equal=sum_repeat,
               index_ms=index_ms, **agree)
    return res


def phase_graph_baselines_2(dev, seed: int, failures: list, tmp: str) -> dict:
    """Phase 20 at the geometry of phase 13 (synthetic 84x42 mesh, batch 4,
    4 trajectories a split): GraphViT as published (w_size 512, clusters of
    10, 4 heads, 4 GNN and 4 attention blocks) through ``baselines_cli``
    for 2 epochs of one step, validation and the 51-step eval of 4 test
    trajectories, then ``--epoch 0`` from its checkpoint (the same N-RMSE
    bit for bit); on one GraphViT batch a train step's launches, step ms
    through the kernels and the twins in turns, the device profile and one
    step's loss and gradient kernels vs twins (GRAPH_LOSS_TOL,
    GRAPH_GRAD_TOL).  ``--dtype bf16`` for MeshGraphNet and GraphViT, 1
    epoch each (launch counts of the f32 and bf16 kernels); on one batch of
    each, one step kernels vs twins in bf16 (BF16_GRAPH_LOSS_TOL,
    BF16_GRAPH_GRAD_TOL), and MeshGraphNet's step ms in bf16 and f32 in
    turns with the bf16 losses falling.  DilResNet through ``baselines_cli``
    on synthetic cylinder grids at resolution 238 (1 epoch, the 101-step
    eval, its train step ms); GATNet one forward and backward at the EAGLE
    edges, kernels vs twins.  Each part prints its seconds."""
    from fluid_llm_tpu_torch import baselines_cli as cli

    common = ["--dataset_path", "synthetic", "--mesh_nodes", EAGLE_MESH,
              "--batch_size", str(EAGLE_BS), "--n_traj", "4", "--device", str(dev),
              "--save_dir", os.path.join(tmp, "baselines2")]
    res, seconds = {}, {}
    t0 = time.perf_counter()
    res["graphvit"] = run_graph_cli(["--model", "graphvit", "--epoch", "2"] + common,
                                    "graph baselines II", failures)
    again = run_graph_cli(["--model", "graphvit", "--epoch", "0"] + common,
                          "graph baselines II", failures)
    if again["n_rmse"] != res["graphvit"]["n_rmse"]:
        failures.append("graph baselines II: GraphViT --epoch 0 from the checkpoint gave "
                        "another N-RMSE")
    res["graphvit_reload_equal"] = again["n_rmse"] == res["graphvit"]["n_rmse"]
    seconds["graphvit_cli"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    args = cli.parse_args(["--model", "graphvit"] + common)
    model, norm, batch = one_batch(args, dev)
    opt = cli.make_optimizer(model, args.lr)
    noise = torch.Generator(device=dev).manual_seed(seed)

    def step():
        return cli.train_step(args, model, norm, opt, batch, args.lr, noise)[1].item()

    reset_launches()
    step()
    step_launches = read_launches()
    want = want_launches(step_launches, graph_launches_per_step("graphvit"),
                         args.horizon_train - 1, 0)

    def with_kernels(kernels):
        def run():
            model.kernels = kernels
            step()
        return run

    step_ms = step_turns({True: with_kernels(True), False: with_kernels(False)}, per_turn=1)
    model.kernels = True
    med_k, med_t = (statistics.median(step_ms[k]) for k in (True, False))
    print(f"[graph baselines II] GraphViT train step (batch {tuple(batch['state'].shape)}, "
          f"edges {tuple(batch['edges'].shape)}, clusters {tuple(batch['cluster'].shape)}): "
          f"launches {_nonzero(step_launches)} (want {_nonzero(want)}, every other kernel 0); "
          f"step ms through the kernels median {med_k:.2f} (runs "
          f"{', '.join(f'{x:.2f}' for x in step_ms[True])}), through the twins median "
          f"{med_t:.2f} (runs {', '.join(f'{x:.2f}' for x in step_ms[False])})")
    if step_launches != want:
        failures.append(f"graph baselines II GraphViT step launches {step_launches} != {want}")
    busy_ms, n_ops, idle, top = device_profile(step, 2, med_k, "graph baselines II GraphViT "
                                               "train step", track=("segment_",))
    agree = kernels_vs_twins(args, model, norm, batch, seed)
    ok = agree["loss_rel"] <= GRAPH_LOSS_TOL and agree["grad_rel"] <= GRAPH_GRAD_TOL
    print(f"[graph baselines II agreement] GraphViT one step, kernels vs twins (f32): "
          f"{_agreement(agree, GRAPH_LOSS_TOL, GRAPH_GRAD_TOL)} {'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append(f"graph baselines II GraphViT agreement: {agree}")
    res["graphvit_step"] = dict(
        launches=step_launches, step_ms=step_ms[True], plain_step_ms=step_ms[False],
        median_step_ms=med_k, plain_median_step_ms=med_t, device_busy_ms=busy_ms,
        device_ops_per_step=n_ops, idle_share=idle, top_device_ms=top, **agree)
    del model, opt, batch
    seconds["graphvit_step"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    bf16_launches = {}
    for name in ("mgn", "graphvit"):
        run = run_graph_cli(["--model", name, "--dtype", "bf16", "--epoch", "1"] + common,
                            "graph baselines II bf16", failures)
        res[f"{name}_bf16"] = run
        for k, v in run["launches"].items():
            bf16_launches[k] = bf16_launches.get(k, 0) + v
        if not (run["launches"]["segment_sum_bf16"] and run["launches"]["segment_gather_bf16"]):
            failures.append(f"graph baselines II bf16 {name}: no bf16 launches")
    res["bf16_launches"] = bf16_launches
    seconds["bf16_cli"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    for name in ("mgn", "graphvit"):
        args = cli.parse_args(["--model", name, "--dtype", "bf16"] + common)
        model, norm, batch = one_batch(args, dev)
        agree = kernels_vs_twins(args, model, norm, batch, seed)
        ok = agree["loss_rel"] <= BF16_GRAPH_LOSS_TOL and agree["grad_rel"] <= BF16_GRAPH_GRAD_TOL
        print(f"[graph baselines II agreement] {name} --dtype bf16 one step, kernels vs twins: "
              f"{_agreement(agree, BF16_GRAPH_LOSS_TOL, BF16_GRAPH_GRAD_TOL)} "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"graph baselines II {name} bf16 agreement: {agree}")
        res[f"{name}_bf16_agreement"] = agree
        if name == "mgn":
            res["mgn_bf16_vs_f32"] = _bf16_vs_f32(args, model, norm, batch, dev, seed, failures)
        del model, batch
    seconds["bf16_step"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    res["dilresnet"] = run_graph_cli(
        ["--model", "dilresnet", "--epoch", "1", "--n_traj", "4", "--batch_size", "4",
         "--resolution", "238", "--device", str(dev), "--save_dir",
         os.path.join(tmp, "baselines2")], "graph baselines II", failures)
    res["dilresnet_step"] = _dilresnet_step(dev, seed)
    seconds["dilresnet"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    res["gatnet"] = _gatnet_agreement(dev, seed, failures)
    seconds["gatnet"] = time.perf_counter() - t0
    print(f"[graph baselines II] seconds {', '.join(f'{k} {v:.1f}' for k, v in seconds.items())}")
    res["seconds"] = seconds
    return res


def _agreement(agree: dict, loss_tol: float, grad_tol: float) -> str:
    return (f"loss {agree['loss_kernels']:.7f} vs {agree['loss_twins']:.7f} (rel "
            f"{agree['loss_rel']:.3e}, bound {loss_tol}), gradient rel L2 {agree['grad_rel']:.3e} "
            f"(bound {grad_tol}; the twins against themselves "
            f"{agree['twin_repeat_grad_rel']:.3e}); the kernels' step repeated bit for bit: "
            f"{agree['step_repeat_bit_equal']}")


def _bf16_vs_f32(args, model, norm, batch, dev, seed: int, failures: list) -> dict:
    """MeshGraphNet's train step under ``--dtype bf16`` and f32 in turns on
    one batch (the same model and Adam state carried on), whether the bf16
    steps' losses fall, and the device profile of each."""
    import argparse

    from fluid_llm_tpu_torch import baselines_cli as cli

    f32 = argparse.Namespace(**dict(vars(args), dtype="f32"))
    opt = cli.make_optimizer(model, args.lr)
    noise = torch.Generator(device=dev).manual_seed(seed)
    losses = {"bf16": [], "f32": []}

    def step(a):
        def run():
            loss = cli.train_step(a, model, norm, opt, batch, a.lr, noise)[1]
            losses[a.dtype].append(loss.item())
        return run

    ms = step_turns({"bf16": step(args), "f32": step(f32)}, per_turn=1)
    med = {k: statistics.median(v) for k, v in ms.items()}
    bf16 = losses["bf16"]
    falling = all(math.isfinite(x) for x in bf16) and bf16[-1] < bf16[0]
    print(f"[graph baselines II] MeshGraphNet train step ms in turns: bf16 median "
          f"{med['bf16']:.2f} "
          f"(runs {', '.join(f'{x:.2f}' for x in ms['bf16'])}), f32 median {med['f32']:.2f} (runs "
          f"{', '.join(f'{x:.2f}' for x in ms['f32'])}); bf16 losses {losses['bf16']} falling: "
          f"{falling} {'ok' if falling else 'FAIL'}")
    if not falling:
        failures.append(f"graph baselines II: MeshGraphNet bf16 losses {losses['bf16']}")
    profiles = {a.dtype: device_profile(step(a), 2, med[a.dtype], f"graph baselines II "
                                        f"MeshGraphNet {a.dtype} train step", track=("segment_",))
                for a in (args, f32)}
    return dict(step_ms=ms, median_step_ms=med, losses=losses, falling=falling,
                device_busy_ms={k: v[0] for k, v in profiles.items()},
                device_ops_per_step={k: v[1] for k, v in profiles.items()},
                idle_share={k: v[2] for k, v in profiles.items()},
                top_device_ms={k: v[3] for k, v in profiles.items()})


def _dilresnet_step(dev, seed: int) -> dict:
    """DilResNet's train step (batch 4 of 5-frame windows at 238x238) ms,
    median of 4 after one warm-up."""
    from fluid_llm_tpu_torch import baselines_cli as cli
    from fluid_llm_tpu_torch.data.grid_images import iterate_image_batches
    from fluid_llm_tpu_torch.models.baselines.dilresnet import dilresnet_loss

    args = cli.parse_args(["--model", "dilresnet", "--resolution", "238", "--device", str(dev)])
    model, _ = cli.build_model(args, dev)
    opt = cli.make_optimizer(model, args.lr)
    state, mask = next(iterate_image_batches(cli.build_dataset(args, "train", args.horizon_train),
                                             4, shuffle=False))
    state, mask = torch.from_numpy(state).to(dev), torch.from_numpy(mask).to(dev)
    noise = torch.Generator(device=dev).manual_seed(seed)
    ms = []
    for i in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        opt.zero_grad(set_to_none=True)
        _, delta, target = model(state, mask, apply_noise=True, noise_std=args.noise_std,
                                 generator=noise)
        dilresnet_loss(delta, target).backward()
        opt.step()
        torch.cuda.synchronize()
        if i:
            ms.append((time.perf_counter() - t0) * 1e3)
    print(f"[graph baselines II] DilResNet train step (state {tuple(state.shape)}, 28 dilated "
          f"convs at width 48 a rollout step, cuDNN, TF32 off): median "
          f"{statistics.median(ms):.2f} ms (runs {', '.join(f'{x:.2f}' for x in ms)})")
    return dict(step_ms=ms, median_step_ms=statistics.median(ms))


def _gatnet_agreement(dev, seed: int, failures: list) -> dict:
    """GATNet (3 edge-featured GAT layers, 2 heads at width 32, a 1-head
    output of 4) on the EAGLE edges (4 graphs of 3 529 nodes and 20 480
    edges) with seeded inputs: one forward and backward through the kernels
    and the twins, the launches of the kernels' (4 gathers and 4 sums a
    layer: x at both edge ends, the softmax's two sums, and their
    backwards), loss within GRAPH_LOSS_TOL and gradient within
    GRAPH_GRAD_TOL."""
    from fluid_llm_tpu_torch.models.baselines.gatnet import GATNet

    edges = eagle_edges(dev)
    B, E = edges.shape[:2]
    n = int(edges.max()) + 1
    g = torch.Generator().manual_seed(seed)
    vert = torch.randn(B, n, 13, generator=g).to(dev)
    edge_in = torch.randn(B, E, 3, generator=g).to(dev)
    model = GATNet(13, 3, 4, generator=torch.Generator().manual_seed(1)).to(dev)
    runs = []
    for kernels in (True, False, False):
        model.kernels = kernels
        model.zero_grad(set_to_none=True)
        reset_launches()
        loss = (model(vert, edge_in, edges) ** 2).mean()
        loss.backward()
        runs.append((loss.item(), torch.cat([p.grad.flatten() for p in model.parameters()]),
                     read_launches()))
    model.kernels = True
    (lk, gk, launches), (lt, gt, twin_launches), (_, gt2, _) = runs
    want = want_launches(launches, {"segment_gather": (6, 6), "segment_sum": (6, 6)}, 1, 0)
    loss_rel, grad_rel = abs(lk - lt) / abs(lt), rel_err(gk, gt)
    ok = (loss_rel <= GRAPH_LOSS_TOL and grad_rel <= GRAPH_GRAD_TOL and launches == want
          and not any(twin_launches.values()))
    print(f"[graph baselines II agreement] GATNet forward and backward at the EAGLE edges, "
          f"kernels vs twins: loss {lk:.7f} vs {lt:.7f} (rel {loss_rel:.3e}, bound "
          f"{GRAPH_LOSS_TOL}), gradient rel L2 {grad_rel:.3e} (bound {GRAPH_GRAD_TOL}; the twins "
          f"against themselves {rel_err(gt2, gt):.3e}); launches {_nonzero(launches)} (want "
          f"{_nonzero(want)}) {'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append(f"graph baselines II GATNet: loss rel {loss_rel}, grad rel {grad_rel}, "
                        f"launches {launches}")
    return dict(loss_rel=loss_rel, grad_rel=grad_rel, launches=launches)


# Phases 17-19.  The pickles: the DeepMind MeshGraphNets layout at the size
# of its cylinder meshes (~1 900 nodes) and 600 steps; the airfoil's mesh
# (~5 000 nodes) reaches beyond the crop box on every side.
CYL_NODES, AIRFOIL_NODES, PICKLE_STEPS = (76, 25), (100, 50), 600
# Bound on the relative L2 error of each trainable gradient leaf of one
# notf step, kernels vs twins (both with remat), its worst leaf held to it.
# The twins take the slot attention's gradient from the slot backward's
# plain version (``slot_attention_bwd_ref``, f32 inside as the kernel).
# The control is a lower-precision gradient: the kernels' with each leaf
# rounded to float8 e4m3 (4 significant bits, scaled to the format's
# range), against the same twins; each run holds its median leaf above the
# bound.  A GATv2 conv's ``lin_r`` gradient is the residue of a pixel's
# five dlogits, which sum to 0; it vanishes wherever the five slot inputs
# lie on one side of the leaky ReLU's kink, as on the out conv here, so
# those leaves are held against a floor as well as their own norm:
# ZERO_FLOOR of the same conv's ``lin_l`` gradient, made of the same terms.
# Measured there against ``lin_l``: 5e-12 left by f32 rounding (kernels and
# twins), 2e-8 by bf16 dlogits (autograd through the bf16 forward twin,
# read beside); NOTF_LEAF_TOL of the floor, 1e-8, passes the first only.
NOTF_LEAF_TOL = 1e-2
ZERO_FLOOR = 1e-6


def e4m3(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 after scaling its largest entry to the
    format's largest, and scaled back."""
    scale = 448.0 / x.abs().max().clamp_min(1e-30)
    return (x * scale).to(torch.float8_e4m3fn).float() / scale


class SlotTwin(torch.autograd.Function):
    """The slot attention's plain forward, and in the backward the plain
    version of the slot backward kernel."""

    @staticmethod
    def forward(ctx, xl, xr, att, heads: int, cdim: int):
        from fluid_llm_tpu_torch.ops import grid_gnn_fused as gf

        ctx.save_for_backward(xl, xr, att)
        ctx.hc = (heads, cdim)
        return gf.slot_attention_ref(xl, xr, att, heads, cdim)

    @staticmethod
    def backward(ctx, g):
        from fluid_llm_tpu_torch.ops import grid_gnn_fused as gf

        xl, xr, att = ctx.saved_tensors
        dxl, dxr, datt = gf.slot_attention_bwd_ref(xl, xr, att, g.contiguous(), *ctx.hc)
        return dxl, dxr, datt.to(att.dtype), None, None


def write_mgn_pickles(folder: str, n: int, seed: int, nodes: tuple[int, int],
                      airfoil: bool = False) -> None:
    """``n`` trajectories ``save_<i>.pkl`` in the MGN layout (``mesh_pos`` f32
    (N, 2), ``cells`` int32 (F, 3), ``velocity`` (T, N, 2), ``pressure`` (T, N,
    1), ``density``) from the port's mesh generator and analytic flow; the
    airfoil's in its physical units, its mesh stretched to x in (-0.8, 3.2),
    y in (-1, 1.05)."""
    import pickle

    import numpy as np

    from fluid_llm_tpu_torch.data.synthetic import analytic_flow, make_cylinder_mesh

    os.makedirs(folder, exist_ok=True)
    for i in range(n):
        pos, faces = make_cylinder_mesh(seed + i, *nodes)
        if airfoil:
            pos = pos * np.array([2.5, 5.0]) + np.array([-0.8, -1.0])
        states = analytic_flow(pos, PICKLE_STEPS, seed + i)
        if airfoil:
            states = (states * np.array([50.0, 50.0, 6000.0], np.float32)[None, :, None]
                      + np.array([170.0, 0.0, 9.9e4], np.float32)[None, :, None])
        data = {"mesh_pos": pos.astype(np.float32), "cells": faces.astype(np.int32),
                "velocity": np.ascontiguousarray(states[:, :2].transpose(0, 2, 1)),
                "pressure": np.ascontiguousarray(states[:, 2:].transpose(0, 2, 1)),
                "density": np.ones((PICKLE_STEPS, len(pos), 1), np.float32)}
        with open(os.path.join(folder, f"save_{i}.pkl"), "wb") as f:
            pickle.dump(data, f)


def _want(launches: dict, **counts) -> dict:
    want = dict.fromkeys(launches, 0)
    want.update(counts)
    return want


def phase_published_data(dev, seed: int, failures: list, tmp: str) -> dict:
    """``configs/training1.yaml`` as published on MGN-format pickles: ``main``
    for 1 epoch (``num_workers: 6``: the threaded prefetch) with its
    validation, ``inference.main --checkpoint_dir`` (251 steps), the
    launches of each; threaded batches against serial ones; then the
    airfoil: one autoreg step and a 10-step rollout, kernels vs twins."""
    from fluid_llm_tpu_torch import inference
    from fluid_llm_tpu_torch import main as train_main
    from fluid_llm_tpu_torch.config import Config
    from fluid_llm_tpu_torch.data import get_dataset, make_batches
    from fluid_llm_tpu_torch.main import build_model_and_trainer
    from fluid_llm_tpu_torch.rollout.generate import generate

    t0 = time.perf_counter()
    cyl = os.path.join(tmp, "cylinder_dataset")
    for split, n, s0 in (("train", TRAIN_BS, 100), ("valid", 2, 200), ("test", 1, 200)):
        write_mgn_pickles(os.path.join(cyl, split), n, s0, CYL_NODES)
    air = os.path.join(tmp, "airfoil_dataset")
    for split, n, s0 in (("train", 2, 300), ("valid", 1, 400)):
        write_mgn_pickles(os.path.join(air, split), n, s0, AIRFOIL_NODES, airfoil=True)
    res = {"write_s": time.perf_counter() - t0}
    cfg = Config.from_yaml(CONFIG)
    runs = os.path.join(tmp, "runs")
    cfg_path = os.path.join(tmp, "training1_pickles.yaml")
    cfg.replace(load_dir=cyl, num_epochs=1, checkpoint_save_path=runs).to_yaml(cfg_path)
    n_layers, convs = 12, cfg.decoder_params.gnn_layers

    # the threaded prefetch's batches against the serial ones, bit for bit
    ds_cfg = cfg.replace(load_dir=cyl, seq_len=cfg.autoreg_seq_len)
    batches = {w: list(make_batches(get_dataset(ds_cfg, "train"), 2, shuffle=True, seed=0,
                                    num_workers=w)) for w in (0, cfg.num_workers)}
    same = len(batches[0]) == len(batches[cfg.num_workers]) == TRAIN_BS // 2 and all(
        torch.equal(a, b) for b0, bw in zip(batches[0], batches[cfg.num_workers])
        for a, b in zip(b0, bw))
    res["prefetch_equal"] = same
    print(f"[published data] {TRAIN_BS} train, 2 valid, 1 test cylinder pickles of "
          f"{CYL_NODES[0] * CYL_NODES[1]} nodes x {PICKLE_STEPS} steps, 2 + 1 airfoil ones of "
          f"{AIRFOIL_NODES[0] * AIRFOIL_NODES[1]} nodes, written in {res['write_s']:.1f} s; "
          f"training batches from {cfg.num_workers} threads equal to serial ones bit for bit: "
          f"{'ok' if same else 'FAIL'}")
    if not same:
        failures.append("published data: threaded batches differ from serial ones")

    # the prefetch's throughput where every sample misses the trajectory
    # cache: 3 x MAX_CACHE trajectories (links to the 8 pickles; each index
    # is its own cache entry), one epoch of batches of 8, serial and threaded
    from fluid_llm_tpu_torch.data.cylinder import MAX_CACHE

    many = os.path.join(tmp, "cylinder_many", "train")
    os.makedirs(many)
    n_many = 3 * MAX_CACHE
    for i in range(n_many):
        os.symlink(os.path.join(cyl, "train", f"save_{i % TRAIN_BS}.pkl"),
                   os.path.join(many, f"save_{i}.pkl"))
    rate = {}
    for w in (0, cfg.num_workers):
        ds = get_dataset(ds_cfg.replace(load_dir=os.path.dirname(many)), "train")
        t0 = time.perf_counter()
        n_batches = sum(1 for _ in make_batches(ds, TRAIN_BS, shuffle=True, seed=0,
                                                num_workers=w))
        rate[w] = n_batches / (time.perf_counter() - t0)
    res["prefetch_batches_per_s"] = rate
    print(f"[published data] batches of {TRAIN_BS} over {n_many} trajectories (cache "
          f"{MAX_CACHE}: every sample builds its trajectory), host wall clock: "
          f"{rate[0]:.3f} batches/s serial, {rate[cfg.num_workers]:.3f} with "
          f"{cfg.num_workers} threads ({rate[cfg.num_workers] / rate[0]:.2f}x)")

    reset_launches()
    t0 = time.perf_counter()
    jl = os.path.join(tmp, "metrics.jsonl")
    train_main.main(["--config_path", cfg_path, "--device", str(dev), "--metrics_jsonl", jl])
    res["main_s"], res["main_launches"] = time.perf_counter() - t0, read_launches()
    with open(jl) as f:
        log = json.loads(f.readline())
    val_steps = cfg.val_seq_len - 1  # one validation batch of 2, rolled out from its first state
    want_main = _want(res["main_launches"], flash_attention_fwd=n_layers,
                      flash_attention_dq=n_layers, flash_attention_dkv=n_layers,
                      grid_slot_attention=convs + convs * val_steps,
                      grid_slot_attention_bwd=convs,
                      exact_attention=(n_layers - 1) * val_steps)
    reset_launches()
    t0 = time.perf_counter()
    mean = inference.main(["--checkpoint_dir", runs, "--device", str(dev)])
    res["inference_s"], res["inference_launches"] = time.perf_counter() - t0, read_launches()
    want_inf = _want(res["inference_launches"], exact_attention=(n_layers - 1) * STEPS,
                     grid_slot_attention=convs * STEPS)
    res.update(train_loss=log["train/Autoreg/loss"], val_n_rmse=log.get("val/Gen/N_RMSE"),
               inference_mean_n_rmse=mean)
    ok = (res["main_launches"] == want_main and res["inference_launches"] == want_inf
          and math.isfinite(res["train_loss"]) and math.isfinite(res["val_n_rmse"] or math.nan)
          and math.isfinite(mean))
    print(f"[published data] main, 1 epoch of training1.yaml on {cyl}: {res['main_s']:.1f} s, "
          f"train loss {res['train_loss']:.5f}, val N-RMSE {res['val_n_rmse']}, launches "
          f"{res['main_launches']} (want {want_main}: one train step, a {val_steps}-step "
          f"validation rollout); inference --checkpoint_dir, {STEPS} steps in "
          f"{res['inference_s']:.1f} s: mean N-RMSE {mean:.5f}, launches "
          f"{res['inference_launches']} (want {want_inf}) {'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append(f"published data cylinder: {res}")

    # the airfoil: crop, flip, trimmed patches, masked normalisation
    acfg = cfg.replace(load_dir=air, seed=seed)
    train_ds = get_dataset(acfg.replace(seq_len=acfg.autoreg_seq_len), mode="train")
    trainer = build_model_and_trainer(acfg, train_ds.ds_props(), dev)
    model = trainer.model
    batch = next(make_batches(train_ds, 2, shuffle=False, device=dev))
    reset_launches()
    loss = trainer.train_step(batch)["loss"].item()
    step_launches = read_launches()
    valid_ds = get_dataset(acfg.replace(seq_len=12), mode="valid")
    states, _, _, bc_mask, pos = next(make_batches(valid_ds, 1, shuffle=False, device=dev))
    diffs = {}
    reset_launches()
    for kernels in (True, False):
        model.kernels = kernels
        diffs[kernels] = generate(model, states[:, :1], bc_mask, pos, 10)[1]
    roll_launches = read_launches()
    model.kernels = True
    errs = [rel_err(diffs[True][:, i], diffs[False][:, i]) for i in range(10)]
    props = train_ds.ds_props()
    want_step = _want(step_launches, flash_attention_fwd=n_layers, flash_attention_dq=n_layers,
                      flash_attention_dkv=n_layers, grid_slot_attention=convs,
                      grid_slot_attention_bwd=convs)
    want_roll = _want(roll_launches, exact_attention=(n_layers - 1) * 10,
                      grid_slot_attention=convs * 10)
    ok = (math.isfinite(loss) and errs[0] <= REL_TOL and step_launches == want_step
          and roll_launches == want_roll and bool(torch.isfinite(diffs[True]).all())
          and bool(torch.all(states[bc_mask] == 0)))
    res["airfoil"] = dict(patches=(props.Nx_patch, props.Ny_patch), loss=loss, rel_err=errs,
                          step_launches=step_launches, rollout_launches=roll_launches)
    print(f"[published data] airfoil: {props.Nx_patch}x{props.Ny_patch} patches after the "
          f"trim ({props.Nx_patch * props.Ny_patch * 10 + 1} training tokens), masked pixels "
          f"exactly 0; one autoreg step loss {loss:.5f}, launches {step_launches}; a 10-step "
          f"rollout, diffs rel err per step kernels vs twins "
          f"{', '.join(f'{e:.3e}' for e in errs)}, launches {roll_launches} (want {want_roll}) "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append(f"published data airfoil: {res['airfoil']}")
    return res


def _notf_trainer(dev, seed: int, cyl: str, remat: bool):
    from fluid_llm_tpu_torch.config import Config
    from fluid_llm_tpu_torch.data import get_dataset, make_batches
    from fluid_llm_tpu_torch.main import build_model_and_trainer

    base = Config.from_yaml(CONFIG)
    cfg = base.replace(load_dir=cyl, seed=seed,
                       teacher_forcing={**base.teacher_forcing.__dict__, "tf_mode": "notf"},
                       parallel={**base.parallel.__dict__, "remat": remat})
    ds = get_dataset(cfg.replace(seq_len=cfg.autoreg_seq_len), mode="train")
    trainer = build_model_and_trainer(cfg, ds.ds_props(), dev)
    return trainer, next(make_batches(ds, TRAIN_BS, shuffle=True, seed=0, device=dev))


def phase_notf(dev, seed: int, failures: list, tmp: str, n_steps: int = 3) -> dict:
    """``training1.yaml`` with ``tf_mode: notf`` on phase 17's cylinder
    pickles: ``Trainer.train_step(batch, "notf")`` on one batch of 8, with
    ``parallel.remat`` off and on.  A step rolls out 9 steps from the first
    state, differentiated end to end.  Launches a step: 11 x 9 = 99 flash
    forwards (the sliced last block is plain), 99 dq and 99 dk/dv, 3 x 9 =
    27 slot forwards and 27 slot backwards; with remat each step's forward
    runs again in the backward: 198 flash and 54 slot forwards; exact
    attention 0.  Then one step's loss and gradient remat on vs off, bit
    for bit (the same operations on the same inputs, recomputed; every
    kernel and twin on the path repeats bit for bit, phase 3), and kernels
    vs twins (both with remat: the twins' f32 attention probabilities of 9
    steps would not fit otherwise; the slot attention's gradient from its
    backward's plain version, see NOTF_LEAF_TOL): the loss within REL_TOL,
    each trainable leaf's gradient within NOTF_LEAF_TOL (so a fault
    confined to the ~100 entries of the ``att`` leaves shows), and the
    control, the kernels' gradient rounded to e4m3, above it on the median
    leaf; autograd through the bf16 forward twin is read beside."""
    cyl = os.path.join(tmp, "cylinder_dataset")
    n_layers, convs, rsteps = 12, 3, 9
    res, grads = {}, {}
    for remat in (False, True):
        trainer, batch = _notf_trainer(dev, seed, cyl, remat)
        model = trainer.model
        tag = f"notf remat={remat}"
        model.zero_grad(set_to_none=True)
        trainer.generator.manual_seed(seed)
        loss, _ = trainer.mode_loss(batch, "notf")
        loss.backward()
        grads[remat] = (loss.detach().float(), {
            n: p.grad.float().flatten() for n, p in model.named_parameters() if p.requires_grad})
        model.zero_grad(set_to_none=True)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        losses, step_ms = [], []
        for _ in range(n_steps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            losses.append(trainer.train_step(batch, "notf")["loss"].item())
            step_ms.append((time.perf_counter() - t0) * 1e3)
        launches = read_launches()
        peak_mib = torch.cuda.max_memory_allocated() / 2**20
        fwd = 2 if remat else 1
        per_step = _want(launches, flash_attention_fwd=fwd * (n_layers - 1) * rsteps,
                         flash_attention_dq=(n_layers - 1) * rsteps,
                         flash_attention_dkv=(n_layers - 1) * rsteps,
                         grid_slot_attention=fwd * convs * rsteps,
                         grid_slot_attention_bwd=convs * rsteps)
        want = {k: v * n_steps for k, v in per_step.items()}
        params = dict(model.named_parameters())
        no_grad = [n for n in TRAINABLE_PROBES
                   if params[n].grad is None or not bool(params[n].grad.abs().sum() > 0)]
        med = statistics.median(step_ms)
        ok = (launches == want and all(math.isfinite(x) for x in losses)
              and losses[-1] < losses[0] and not no_grad)
        print(f"[{tag}] {n_steps} notf steps on one batch of {TRAIN_BS} ({rsteps} rollout steps "
              f"each): loss {', '.join(f'{x:.5f}' for x in losses)}; step ms median {med:.1f} "
              f"(runs {', '.join(f'{x:.1f}' for x in step_ms)}); peak device memory "
              f"{peak_mib:.1f} MiB; launches {launches} (want per step {per_step}); gradient on "
              f"{', '.join(TRAINABLE_PROBES)}: {'ok' if not no_grad else no_grad} "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"{tag}: launches {launches} (want {want}), losses {losses}, "
                            f"no gradient {no_grad}")
        busy_ms, n_ops, idle, top = device_profile(
            lambda: trainer.train_step(batch, "notf")["loss"].item(), 1, med, tag)
        res[f"remat_{remat}"] = dict(losses=losses, step_ms=step_ms, median_step_ms=med,
                                     peak_mem_mib=peak_mib, launches_per_step=per_step,
                                     device_busy_ms=busy_ms, device_ops=n_ops, idle_share=idle,
                                     top_device_ms=top)
        if remat:
            from fluid_llm_tpu_torch.ops import grid_gnn

            agree = {}
            for run in ("kernels", "twins", "autograd twins"):
                model.kernels = run == "kernels"
                model.zero_grad(set_to_none=True)
                plain = grid_gnn.slot_attention_ref
                if run == "twins":
                    grid_gnn.slot_attention_ref = SlotTwin.apply
                try:
                    loss, _ = trainer.mode_loss(batch, "notf")
                    loss.backward()
                finally:
                    grid_gnn.slot_attention_ref = plain
                agree[run] = (loss.item(), {n: p.grad.float().flatten() for n, p in
                                            model.named_parameters() if p.requires_grad})
            model.kernels = True
            (lk, gk), (lt, gt), (la, ga) = (agree[r] for r in ("kernels", "twins",
                                                                "autograd twins"))
            loss_rel = abs(lk - lt) / abs(lt)
            floors = {n: ZERO_FLOOR * gt[n.replace(".lin_r.", ".lin_l.")].norm().item()
                      for n in gt if ".lin_r." in n}
            leaf_rel = {n: (gk[n] - gt[n]).norm().item()
                        / max(gt[n].norm().item(), floors.get(n, 0.0)) for n in gt}
            floored = {n: (gt[n].norm().item(), f) for n, f in floors.items()
                       if gt[n].norm().item() < f}
            autograd_rel = {n: rel_err(gk[n], ga[n]) for n in ga}
            control = {n: rel_err(e4m3(gk[n]), gt[n]) for n in gt}
            worst = sorted(leaf_rel, key=leaf_rel.get, reverse=True)
            worst_autograd = sorted(autograd_rel, key=autograd_rel.get, reverse=True)
            control_median = statistics.median(control.values())
            above = sum(v > NOTF_LEAF_TOL for v in control.values())
            ok = (loss_rel <= REL_TOL and leaf_rel[worst[0]] <= NOTF_LEAF_TOL < control_median)
            att = {n: leaf_rel[n] for n in leaf_rel if n.endswith(".att")}
            norms = {n: (gk[n].norm().item(), gt[n].norm().item(), ga[n].norm().item())
                     for n in dict.fromkeys(worst[:3] + worst_autograd[:3] + [
                         n.replace(".lin_r.", ".lin_l.") for n in floored])}
            res["kernels_vs_twins"] = dict(
                loss_kernels=lk, loss_twins=lt, loss_autograd_twins=la, loss_rel=loss_rel,
                leaf_rel=leaf_rel, worst_leaf=worst[0], worst_leaf_rel=leaf_rel[worst[0]],
                control_leaf_rel=control, control_median=control_median,
                control_leaves_above=above, autograd_twins_leaf_rel=autograd_rel,
                floors=floors, floored_leaves=floored,
                grad_norms=norms,
                whole_rel=rel_err(torch.cat(list(gk.values())), torch.cat(list(gt.values()))))
            print(f"[notf agreement] loss {lk:.6f} (kernels) vs {lt:.6f} (twins): rel "
                  f"{loss_rel:.3e} (bound {REL_TOL}); trainable gradient, {len(leaf_rel)} "
                  f"leaves each, against the twins with the slot backward's plain version: "
                  f"worst rel L2 {', '.join(f'{n} {leaf_rel[n]:.3e}' for n in worst[:4])} "
                  f"(bound {NOTF_LEAF_TOL}); lin_r leaves under their floor ({ZERO_FLOOR} of "
                  f"lin_l's gradient), norm vs floor: "
                  + (", ".join(f"{n} {a:.3e} vs {f:.3e}" for n, (a, f) in floored.items())
                     or "none") +
                  f"; the att leaves "
                  f"{', '.join(f'{n} {v:.3e}' for n, v in att.items())}; the control (each leaf "
                  f"rounded to e4m3): median leaf {control_median:.3e} (must exceed the bound), "
                  f"{above} of {len(control)} leaves above it; whole gradient "
                  f"{res['kernels_vs_twins']['whole_rel']:.3e} {'ok' if ok else 'FAIL'}")
            print(f"[notf agreement] against autograd through the bf16 forward twin (loss "
                  f"{la:.6f}): worst rel L2 "
                  f"{', '.join(f'{n} {autograd_rel[n]:.3e}' for n in worst_autograd[:4])}; "
                  f"gradient norms kernels / twins / autograd twins: "
                  + ", ".join(f"{n} {a:.4e} / {b:.4e} / {c:.4e}"
                              for n, (a, b, c) in norms.items()))
            if not ok:
                failures.append(f"notf kernels vs twins: loss rel {loss_rel}, worst leaf "
                                f"{worst[0]} {leaf_rel[worst[0]]}, control median "
                                f"{control_median}")
        del trainer, model, batch
    (l0, g0), (l1, g1) = grads[False], grads[True]
    unequal = [n for n in g0 if not torch.equal(g0[n], g1[n])]
    exact = bool(torch.equal(l0, l1)) and not unequal
    res["remat_vs_none"] = dict(bit_for_bit=exact, unequal_leaves=unequal,
                                loss_rel=abs((l1 - l0).item()) / abs(l0.item()))
    print(f"[notf remat] one step from the same weights, remat on vs off: loss and every "
          f"gradient leaf bit for bit: {exact} (loss {l0.item():.6f} vs {l1.item():.6f}; leaves "
          f"that differ: {unequal or 'none'}) {'ok' if exact else 'FAIL'}")
    if not exact:
        failures.append(f"notf remat vs none: loss {l0.item()} vs {l1.item()}, leaves {unequal}")
    return res


def phase_switches(dev, seed: int, failures: list, n_steps: int = 3) -> dict:
    """``training1.yaml`` on ``synthetic:8`` at full width, each switch a few
    autoreg steps on one batch, finite with the loss falling: MLPGNN
    attention dropout 0.1 (no slot-kernel launch in the training forward, 3
    a step in the validation rollout), the CNN encoder and decoder (768 =
    3·16·16), adafactor, and ``grad_accum_steps: 2`` (parameters unchanged
    after the first micro-batch, changed after the second)."""
    from fluid_llm_tpu_torch.config import Config
    from fluid_llm_tpu_torch.data import get_dataset, make_batches
    from fluid_llm_tpu_torch.main import build_model_and_trainer

    base = Config.from_yaml(CONFIG).replace(load_dir=f"synthetic:{TRAIN_BS}", seed=seed)
    switches = {
        "decoder dropout 0.1": base.replace(decoder_params={**base.decoder_params.__dict__,
                                                            "dropout": 0.1}),
        "CNN encoder + decoder": base.replace(
            encoder_params={**base.encoder_params.__dict__, "type": "CNN"},
            decoder_params={**base.decoder_params.__dict__, "type": "CNN"}),
        "adafactor": base.replace(optimizer="adafactor"),
        "grad_accum_steps 2": base.replace(grad_accum_steps=2),
    }
    res = {}
    for name, cfg in switches.items():
        ds = get_dataset(cfg.replace(seq_len=cfg.autoreg_seq_len), mode="train")
        trainer = build_model_and_trainer(cfg, ds.ds_props(), dev)
        batch = next(make_batches(ds, TRAIN_BS, shuffle=True, seed=0, device=dev))
        probe = next(p for n, p in trainer.model.named_parameters()
                     if n.startswith("input_emb") and p.requires_grad)
        moved, losses = [], []
        reset_launches()
        steps = 2 * n_steps if cfg.grad_accum_steps > 1 else n_steps
        for _ in range(steps):
            before = probe.detach().clone()
            losses.append(trainer.train_step(batch)["loss"].item())
            moved.append(not torch.equal(before, probe.detach()))
        launches = read_launches()
        slot = 0 if cfg.decoder_params.type == "CNN" or cfg.decoder_params.dropout > 0 else 3
        want = _want(launches, flash_attention_fwd=12 * steps, flash_attention_dq=12 * steps,
                     flash_attention_dkv=12 * steps, grid_slot_attention=slot * steps,
                     grid_slot_attention_bwd=slot * steps)
        # under accumulation the loss falls from one update to the next
        seen = losses[::2] if cfg.grad_accum_steps > 1 else losses
        ok = (launches == want and all(math.isfinite(x) for x in losses) and seen[-1] < seen[0]
              and moved == ([False, True] * n_steps if cfg.grad_accum_steps > 1
                            else [True] * n_steps))
        out = dict(losses=losses, params_moved=moved, launches=launches)
        if cfg.decoder_params.dropout > 0:
            val = get_dataset(cfg.replace(seq_len=cfg.autoreg_seq_len), mode="valid")
            reset_launches()
            trainer.val_step(next(make_batches(val, TRAIN_BS, shuffle=False, device=dev)))
            out["val_launches"] = read_launches()
            vwant = _want(out["val_launches"], exact_attention=11 * 9, grid_slot_attention=3 * 9)
            ok = ok and out["val_launches"] == vwant
        res[name] = out
        print(f"[switches] {name}: losses {', '.join(f'{x:.5f}' for x in losses)}, parameters "
              f"moved {moved}, launches {launches} (want {want})"
              + (f"; validation rollout launches {out['val_launches']}"
                 if "val_launches" in out else "") + f" {'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"switch {name}: {out}")
        del trainer, batch
    return res


# --------------------------------------------------------------------------
# phase 21: MoE backbones and training over quantized frozen backbones
# --------------------------------------------------------------------------

MOE = os.path.join(os.path.dirname(CONFIG), "moe_cylinder.yaml")
MOE_OVERRIDE = {"experts": 4, "top_k": 2, "capacity_factor": 1.25}  # the flagship's MoE cell
# Bounds on a MoE path, kernels vs twins (bf16).  Routing is
# discontinuous: a token whose top-k router scores are tied within the
# kernels' rounding (~2e-3 of probabilities ~0.5 wide) may take another
# expert set on one side.  MOE_FLIP_TOL bounds the share of valid
# token-layers that do.  Each comparison runs twice:
# - replayed: the twins route from the kernels' own router probabilities
#   (RouteLog(replay=)), so both sides take the same experts with the same
#   gates and only the kernels' rounding differs: the dense bound REL_TOL;
# - free: each side routes itself, bounded by moe_bound.  With no token
#   flipped that is REL_TOL.  A flipped token's MoE output changes by about
#   sqrt(2) x its own size (two gated experts' outputs, uncorrelated), so
#   layer l, where a share s_l of the tokens flipped, adds about
#   sqrt(2 s_l) x rho_l relative L2 error to the residual stream, where
#   rho_l = |MoE out| / |block out| over valid rows, measured in the same
#   run on the reference side.  Flips of different layers fall on different
#   tokens, so their errors add in quadrature; later layers carry an error
#   along at about its relative size (pre-LN residual stream).
MOE_FLIP_TOL = 0.02


def moe_bound(shares: list, rho: list) -> float:
    """The free comparison's relative L2 bound: REL_TOL, plus
    ``sqrt(sum_l 2 s_l rho_l^2)`` for the shares ``s_l`` of tokens flipped
    at layer ``l`` (see MOE_FLIP_TOL)."""
    return REL_TOL + math.sqrt(sum(2 * s * r * r for s, r in zip(shares, rho, strict=True)))


def _valid_norm(t: torch.Tensor, valid) -> torch.Tensor:
    """Frobenius norm of ``t``'s (bs, L, d) rows where ``valid`` (bs, L)."""
    return (t.float() if valid is None else t.float()[valid.bool()]).norm()


class RouteLog:
    """While entered, records every MoE layer call: the router's
    probabilities (``probs``), each token's expert set from them with the
    valid tokens (``calls``: the ``top_k`` argmax passes of
    ``moe_dispatch``, or the tokens an expert took) and the MoE output's
    norm over valid rows; with ``backbone``, each block's output norm over
    valid rows too (forward hooks: the rollout and the dense forward call
    blocks, ``apply_streaming`` does not).  ``replay``: probabilities, one
    a call in order, that routing reads in place of the run's own."""

    def __init__(self, backbone=None, replay=None):
        from fluid_llm_tpu_torch.models import backbone as bb

        self.bb, self.backbone, self.replay = bb, backbone, replay
        self.probs, self.calls, self.mlp_norms, self.block_norms = [], [], [], []

    def __enter__(self):
        import torch.nn.functional as F

        bb = self.bb
        real_dispatch, real_mlp = bb.moe_dispatch, bb.moe_mlp

        def dispatch(probs, cfg, valid=None, capacity_tokens=None):
            ok = torch.ones(probs.shape[:2], dtype=torch.bool, device=probs.device) \
                if valid is None else valid.bool()
            if cfg.moe_router == "expert_choice":
                chosen = real_dispatch(probs, cfg, valid, capacity_tokens).dispatch.sum(-1) > 0
            else:
                chosen, rest = torch.zeros_like(probs, dtype=torch.bool), probs
                for _ in range(cfg.moe_top_k):
                    oh = F.one_hot(rest.argmax(-1), probs.shape[-1]).bool()
                    chosen, rest = chosen | oh, rest.masked_fill(oh, -1.0)
            use = probs if self.replay is None else self.replay[len(self.probs)]
            self.probs.append(probs)
            self.calls.append((chosen, ok))
            return real_dispatch(use, cfg, valid, capacity_tokens)

        def mlp(h, m, cfg, valid=None, capacity_tokens=None):
            out, aux = real_mlp(h, m, cfg, valid, capacity_tokens)
            self.mlp_norms.append(_valid_norm(out, valid))
            return out, aux

        self._patches = [mock.patch.object(bb, "moe_dispatch", dispatch),
                         mock.patch.object(bb, "moe_mlp", mlp)]
        for patch in self._patches:
            patch.__enter__()
        self._hooks = [] if self.backbone is None else [
            layer.register_forward_hook(
                lambda mod, args, out: self.block_norms.append(_valid_norm(out[0], args[2])))
            for layer in self.backbone.layers]
        return self

    def __exit__(self, *exc):
        for hook in self._hooks:
            hook.remove()
        for patch in reversed(self._patches):
            patch.__exit__(*exc)

    def rho(self) -> list[float]:
        """|MoE out| / |block out| over valid rows, a call each."""
        return [(m / b).item() for m, b in zip(self.mlp_norms, self.block_norms, strict=True)]


def flip_counts(a: list, b: list) -> list[tuple[int, int]]:
    """For each call of two logs of the same calls: the valid tokens whose
    expert set differs, and the valid tokens."""
    counts = []
    for (ca, va), (cb, vb) in zip(a, b, strict=True):
        valid = va & vb
        counts.append((int(((ca != cb).any(-1) & valid).sum()), int(valid.sum())))
    return counts


def flip_share(counts: list) -> float:
    return sum(d for d, _ in counts) / max(sum(t for _, t in counts), 1)


def phase_moe_rollout(dev, seed: int, failures: list, tmp: str) -> dict:
    """``configs/moe_cylinder.yaml`` as published (OPT-125m width, 6 layers,
    4 experts top-2, cf 1.25, bf16) with seeded random weights: the 251-step
    exact rollout through ``inference.test_generate`` (the final block runs
    whole, so exact attention launches every layer of every step), steps/s
    through the kernels and the twins, a 10-step agreement with the share
    of tokens routed differently."""
    from fluid_llm_tpu_torch import inference
    from fluid_llm_tpu_torch.config import Config
    from fluid_llm_tpu_torch.data import get_dataset, make_batches
    from fluid_llm_tpu_torch.rollout.generate import gen_seq, generate

    cfg = Config.from_yaml(MOE).replace(load_dir="synthetic:1")
    t0 = time.perf_counter()
    model = inference.build_seeded_model(cfg, seed, dev)
    test_ds = get_dataset(cfg.replace(seq_len=STEPS + 2), mode="test")
    batch = next(make_batches(test_ds, 1, shuffle=False, device=dev))
    setup_s = time.perf_counter() - t0
    bcfg = model.backbone_cfg
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    per_step, mean = inference.test_generate(model, test_ds, batch_size=1, pred_steps=STEPS)
    wall = time.perf_counter() - t0
    launches = read_launches()
    peak_mib = torch.cuda.max_memory_allocated() / 2**20
    want = _want(launches, exact_attention=bcfg.n_layers * STEPS,
                 grid_slot_attention=cfg.decoder_params.gnn_layers * STEPS)
    finite = per_step.shape == (STEPS,) and bool(torch.isfinite(torch.from_numpy(per_step)).all())
    rates, n_rate = {}, min(50, STEPS)
    for kernels in (True, False):
        model.kernels = kernels
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        states, _ = gen_seq(model, batch, n_rate)
        torch.cuda.synchronize()
        rates[kernels] = n_rate / (time.perf_counter() - t1)
        finite = finite and bool(torch.isfinite(states).all())
    states, _, _, bc_mask, position_ids = batch
    out, logs = {}, {}
    n_agree = min(10, STEPS)
    agree = lambda: generate(model, states[:, :1], bc_mask, position_ids, n_agree)[1]
    for kernels in (True, False):
        model.kernels = kernels
        with RouteLog(model.backbone) as log:
            out[kernels] = agree()
        logs[kernels] = log
    model.kernels = False
    with RouteLog(replay=logs[True].probs):
        replayed = agree()
    model.kernels = True
    errs = [rel_err(out[True][:, i], out[False][:, i]) for i in range(n_agree)]
    replay_errs = [rel_err(out[True][:, i], replayed[:, i]) for i in range(n_agree)]
    n = bcfg.n_layers
    counts1 = flip_counts(logs[True].calls[:n], logs[False].calls[:n])
    flips1, n_flips1 = flip_share(counts1), sum(d for d, _ in counts1)
    flips = flip_share(flip_counts(logs[True].calls, logs[False].calls))
    rho1 = logs[False].rho()[:n]
    bound1 = moe_bound([d / max(t, 1) for d, t in counts1], rho1)
    ok = (launches == want and finite and len(logs[True].calls) == n_agree * n
          and errs[0] <= bound1 and replay_errs[0] <= REL_TOL and flips1 <= MOE_FLIP_TOL)
    n_prof = min(10, STEPS)
    busy_ms, n_ops, idle, top = device_profile(
        lambda: generate(model, states[:, :1], bc_mask, position_ids, n_prof), 1,
        n_prof * 1e3 / rates[True], f"moe rollout {n_prof} steps")
    print(f"[moe rollout] {cfg.llm_backbone}: {n} layers, d {bcfg.d_model}, {bcfg.moe_experts} "
          f"experts top-{bcfg.moe_top_k} ({bcfg.moe_router}), cf {bcfg.moe_capacity_factor}, "
          f"{bcfg.dtype}; set-up {setup_s:.1f} s; test_generate {STEPS} steps in {wall:.3f} s: "
          f"mean N-RMSE {mean:.5f}, peak device memory {peak_mib:.1f} MiB; launches {launches} "
          f"(want {want}); {n_rate}-step rollouts {rates[True]:.2f} steps/s through the kernels, "
          f"{rates[False]:.2f} through the twins")
    print(f"[moe rollout agreement] diffs rel err per step, kernels vs twins routing "
          f"themselves: {', '.join(f'{e:.3e}' for e in errs)} (step 1 bound moe_bound "
          f"{bound1:.3e}: |MoE out| / |block out| per layer {', '.join(f'{r:.3f}' for r in rho1)}); "
          f"twins routed from the kernels' probabilities: "
          f"{', '.join(f'{e:.3e}' for e in replay_errs)} (step 1 bound REL_TOL {REL_TOL}); valid "
          f"tokens routed to another expert set: step 1 {flips1:.4%} ({n_flips1} token-layers; "
          f"bound MOE_FLIP_TOL {MOE_FLIP_TOL:.0%}), over {n_agree} steps {flips:.4%} "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append(f"moe rollout: launches {launches} (want {want}), finite {finite}, "
                        f"step 1 rel {errs[0]} (bound {bound1}), replayed {replay_errs[0]}, "
                        f"flips {flips1}")
    return dict(setup_s=setup_s, test_generate_s=wall, mean_n_rmse=mean, peak_mem_mib=peak_mib,
                launches=launches, steps_per_s=rates[True], plain_steps_per_s=rates[False],
                agreement_rel_err=errs, agreement_bound=bound1, rho_step1=rho1,
                replayed_rel_err=replay_errs, flip_share_step1=flips1, flip_share_steps=flips,
                profile=dict(steps=n_prof, device_busy_ms=busy_ms, device_ops=n_ops,
                             idle_share=idle, top_device_ms=top))


def _train_steps(trainer, batch, n: int, kernels: bool = True) -> tuple[list, list, list]:
    """``n`` autoreg steps: losses, ``moe_aux`` (None for a dense model) and
    step ms."""
    trainer.model.kernels = kernels
    losses, aux, ms = [], [], []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = trainer.train_step(batch)
        losses.append(m["loss"].item())
        ms.append((time.perf_counter() - t0) * 1e3)
        aux.append(m["moe_aux"].item() if "moe_aux" in m else None)
    trainer.model.kernels = True
    return losses, aux, ms


def _train_launches(bcfg, convs: int, steps: int, **extra) -> dict:
    per_step = dict(flash_attention_fwd=bcfg.n_layers, flash_attention_dq=bcfg.n_layers,
                    flash_attention_dkv=bcfg.n_layers, grid_slot_attention=convs,
                    grid_slot_attention_bwd=convs, **extra)
    return _want(read_launches(), **{k: v * steps for k, v in per_step.items()})


def phase_moe_train(dev, seed: int, failures: list, tmp: str) -> dict:
    """The MoE config through ``Trainer`` (4 autoreg steps on one batch of
    8 through the kernels, 2 through the twins; launches, loss and aux),
    one expert_choice step, then ``main`` for 1 epoch and ``inference.main
    --checkpoint_dir`` from its checkpoint (25 steps)."""
    import dataclasses

    from fluid_llm_tpu_torch import inference
    from fluid_llm_tpu_torch import main as train_main
    from fluid_llm_tpu_torch.config import Config
    from fluid_llm_tpu_torch.data import get_dataset, make_batches
    from fluid_llm_tpu_torch.main import build_model_and_trainer

    cfg = Config.from_yaml(MOE).replace(load_dir=f"synthetic:{TRAIN_BS}", seed=seed)
    train_ds = get_dataset(cfg.replace(seq_len=cfg.autoreg_seq_len), mode="train")
    batch = next(make_batches(train_ds, TRAIN_BS, shuffle=True, seed=0, device=dev))
    res, convs = {}, cfg.decoder_params.gnn_layers
    for router, n_k, n_t in (("topk", 4, 2), ("expert_choice", 1, 0)):
        c = cfg.replace(moe=dataclasses.replace(cfg.moe, router=router))
        trainer = build_model_and_trainer(c, train_ds.ds_props(), dev)
        mlp = trainer.model.backbone.layers[0].mlp
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        losses, aux, ms = _train_steps(trainer, batch, n_k)
        want = _train_launches(trainer.model.backbone_cfg, convs, n_k)
        launches = read_launches()
        peak_mib = torch.cuda.max_memory_allocated() / 2**20
        plain_ms = _train_steps(trainer, batch, n_t, kernels=False)[2] if n_t else []
        prof = device_profile(lambda: trainer.train_step(batch)["loss"].item(), 2,
                              statistics.median(ms[1:]), f"moe train {router}") if n_t else None
        grads = all(p.grad is not None and bool(p.grad.abs().sum() > 0)
                    for p in (mlp.router.weight, mlp.experts["fc1"].weight))
        ok = (launches == want and all(math.isfinite(x) for x in losses + aux) and grads
              and (losses[-1] < losses[0] if n_k > 1 else True)
              and ((min(aux) > 0) if router == "topk" else aux == [0.0] * n_k))
        print(f"[moe train] {router}: {n_k} autoreg steps on one batch of {TRAIN_BS} "
              f"({TRAIN_TOKENS} tokens): loss {', '.join(f'{x:.5f}' for x in losses)}, moe_aux "
              f"{', '.join(f'{x:.5f}' for x in aux)}; step ms through the kernels "
              f"{', '.join(f'{x:.1f}' for x in ms)}, through the twins "
              f"{', '.join(f'{x:.1f}' for x in plain_ms) or '-'}; peak device memory "
              f"{peak_mib:.1f} MiB; router and expert gradients {grads}; launches {launches} "
              f"(want {want}) {'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"moe train {router}: losses {losses}, aux {aux}, launches "
                            f"{launches} (want {want}), grads {grads}")
        res[router] = dict(losses=losses, moe_aux=aux, step_ms=ms, plain_step_ms=plain_ms,
                           peak_mem_mib=peak_mib, launches=launches, profile=prof)
        n_layers = trainer.model.backbone_cfg.n_layers
        del trainer, mlp

    runs = os.path.join(tmp, "moe_runs")
    cfg_path = os.path.join(tmp, "moe.yaml")
    cfg.replace(num_epochs=1, checkpoint_save_path=runs).to_yaml(cfg_path)
    t0 = time.perf_counter()
    train_main.main(["--config_path", cfg_path, "--device", str(dev)])
    res["main_s"] = time.perf_counter() - t0
    reset_launches()
    t0 = time.perf_counter()
    mean = inference.main(["--checkpoint_dir", runs, "--device", str(dev), "--load_dir",
                           "synthetic:1", "--seq_len", "27", "--pred_steps", "25"])
    res.update(inference_s=time.perf_counter() - t0, inference_n_rmse=mean,
               inference_launches=read_launches(), runs=runs)
    want = _want(res["inference_launches"], exact_attention=n_layers * 25,
                 grid_slot_attention=convs * 25)
    ok = math.isfinite(mean) and res["inference_launches"] == want
    print(f"[moe train] main 1 epoch of moe_cylinder.yaml on synthetic:{TRAIN_BS} in "
          f"{res['main_s']:.1f} s; inference --checkpoint_dir, 25 steps in "
          f"{res['inference_s']:.1f} s: N-RMSE {mean:.5f}, launches "
          f"{res['inference_launches']} (want {want}) {'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append(f"moe main/inference: N-RMSE {mean}, launches "
                        f"{res['inference_launches']} (want {want})")
    return res


def phase_moe_streaming(dev, seed: int, failures: list, tmp: str) -> dict:
    """``configs/flagship_llama.yaml`` with a MoE MLP (4 experts, top-2, cf
    1.25: ``fluid/llama-125m`` gate/up/down banks) through
    ``test_generate(streaming=True)``, 251 steps; then
    ``test_moe_streaming_equals_banded_dense`` on the card: the backbone
    stepped frame by frame through ``apply_streaming`` (5 frames, a ring of
    3) against one dense forward of the same tokens under the banded mask,
    at ample capacity (cf 8: streaming sizes C per decode chunk, the dense
    forward per stream, ``backbone.py:1297-1308``): routing itself, and
    routed from the dense forward's probabilities through the kernels and
    through the twins (kernels vs twins on the same routing)."""
    from fluid_llm_tpu_torch import inference
    from fluid_llm_tpu_torch.config import Config, MoEConfig
    from fluid_llm_tpu_torch.data import get_dataset, make_batches
    from fluid_llm_tpu_torch.models import backbone as bb

    cfg = Config.from_yaml(FLAGSHIP).replace(load_dir="synthetic:1",
                                             moe=MoEConfig(**MOE_OVERRIDE))
    model = inference.build_seeded_model(cfg, seed, dev)
    bcfg = model.backbone_cfg
    test_ds = get_dataset(cfg.replace(seq_len=STEPS + 2), mode="test")
    reset_launches()
    t0 = time.perf_counter()
    per_step, mean = inference.test_generate(model, test_ds, batch_size=1, pred_steps=STEPS,
                                             streaming=True)
    wall = time.perf_counter() - t0
    launches = read_launches()
    want = _want(launches, slab_decode_attention=bcfg.n_layers * (STEPS + 1),
                 grid_slot_attention=cfg.decoder_params.gnn_layers * STEPS)
    finite = bool(torch.isfinite(torch.from_numpy(per_step)).all())

    # the banded oracle, on the model's own token stream
    states, _, _, _, pos_ids = next(make_batches(test_ds, 1, shuffle=False, device=dev))
    T, R, n_patch = min(5, states.shape[1]), 3, states.shape[2]
    spatial = pos_ids[:, :1, :, :2]
    frame = lambda f, t: model.embed_frames(states[:, f:f + 1], torch.cat(
        [spatial, torch.full_like(spatial[..., :1], t)], dim=-1))
    with torch.no_grad():
        x = torch.cat([model.bos.to(bcfg.dtype).expand(1, 1, -1), frame(0, 0)]
                      + [frame(f, f) for f in range(T)], dim=1)
    frame_of = torch.tensor([-1] * (1 + n_patch) + [f for f in range(T) for _ in range(n_patch)],
                            device=dev)
    pos = torch.arange(x.shape[1], device=dev)
    qf, kf = frame_of[:, None], frame_of[None, :]
    allowed = (pos[:, None] >= pos[None, :]) & ((kf == -1) | (kf > qf - R))
    backbone, n_sink = model.backbone, 1 + n_patch
    backbone.cfg = bcfg.replace(moe_capacity_factor=8.0)
    n = bcfg.n_layers
    # streaming routes the prefill and then each frame, every layer
    spans = [(0, n_sink)] + [(lo, lo + n_patch) for lo in range(n_sink, x.shape[1], n_patch)]

    def stream(replay=None, kernels=True):
        cache = bb.init_streaming_cache(backbone.cfg, 1, n_sink, R, n_patch, device=dev)
        with torch.no_grad(), RouteLog(replay=replay) as log:
            bb.apply_streaming(backbone, x[:, :n_sink], pos[:n_sink], cache, 0, prefill=True,
                               kernels=kernels)
            ys = [bb.apply_streaming(backbone, x[:, lo:hi], pos[lo:hi], cache, f % R,
                                     kernels=kernels)[0]
                  for f, (lo, hi) in enumerate(spans[1:])]
        return ys, log

    try:
        with torch.no_grad(), RouteLog(backbone) as dense_log:
            dense = backbone(x, positions=pos[None], allowed=allowed[None, None])
        reset_launches()
        ys, stream_log = stream()
        oracle_launches = read_launches()
        # the dense forward's probabilities, cut to each streamed chunk
        replay = [dense_log.probs[li][:, lo:hi] for lo, hi in spans for li in range(n)]
        ys_replay, ys_twin = stream(replay)[0], stream(replay, kernels=False)[0]
    finally:
        backbone.cfg = bcfg
    to_dense = lambda ys: [rel_err(y, dense[:, lo:hi]) for y, (lo, hi) in zip(ys, spans[1:])]
    errs, replay_errs, twin_errs = to_dense(ys), to_dense(ys_replay), to_dense(ys_twin)
    kt_errs = [rel_err(a, b) for a, b in zip(ys_replay, ys_twin)]
    chunks = [stream_log.calls[i * n:(i + 1) * n] for i in range(len(spans))]
    stream_by_layer = [(torch.cat([c[li][0] for c in chunks], 1),
                        torch.cat([c[li][1] for c in chunks], 1)) for li in range(n)]
    counts = flip_counts(stream_by_layer, dense_log.calls)
    flips, n_flips = flip_share(counts), sum(d for d, _ in counts)
    rho = dense_log.rho()
    bound = moe_bound([d / max(t, 1) for d, t in counts], rho)
    ok = (launches == want and finite and oracle_launches["slab_decode_attention"] == n * (T + 1)
          and max(errs) <= bound and max(replay_errs) <= REL_TOL and max(kt_errs) <= REL_TOL
          and flips <= MOE_FLIP_TOL)
    print(f"[moe streaming] flagship_llama.yaml with moe {MOE_OVERRIDE}: {n} layers "
          f"({bcfg.family}, gate/up/down banks), {bcfg.dtype}; test_generate(streaming=True) "
          f"{STEPS} steps in {wall:.3f} s: mean N-RMSE {mean:.5f}, launches {launches} (want "
          f"{want}); apply_streaming over {T} frames (ring {R}) against the banded dense forward "
          f"(cf 8): rel err per frame routing itself {', '.join(f'{e:.3e}' for e in errs)} "
          f"(bound moe_bound {bound:.3e}: |MoE out| / |block out| per layer "
          f"{', '.join(f'{r:.3f}' for r in rho)}), routed from the dense forward's probabilities "
          f"{', '.join(f'{e:.3e}' for e in replay_errs)} (bound REL_TOL {REL_TOL}; streamed "
          f"through the twins {', '.join(f'{e:.3e}' for e in twin_errs)}); streamed kernels vs "
          f"twins, both routed so: {', '.join(f'{e:.3e}' for e in kt_errs)} (bound REL_TOL "
          f"{REL_TOL}); tokens routed to another expert set {flips:.4%} ({n_flips}; bound "
          f"{MOE_FLIP_TOL:.0%}) {'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append(f"moe streaming: launches {launches} (want {want}), finite {finite}, "
                        f"oracle {oracle_launches}, rel {errs} (bound {bound}), replayed "
                        f"{replay_errs}, kernels vs twins {kt_errs}, flips {flips}")
    return dict(test_generate_s=wall, mean_n_rmse=mean, launches=launches,
                banded_rel_err=errs, banded_bound=bound, banded_rho=rho,
                banded_replayed_rel_err=replay_errs, banded_twin_rel_err=twin_errs,
                streamed_kernels_vs_twins=kt_errs, banded_flip_share=flips)


def phase_moe_serve(dev, seed: int, failures: list, tmp: str) -> dict:
    """``tools.serve`` with ``--quant int8`` (w8a16, the default; the expert
    banks int8 and dequantised at use, the router float) on the MoE
    checkpoint of ``phase_moe_train``, over HTTP on 127.0.0.1: one 25-step
    request and its launches (attention linears through w8a16, exact
    attention every layer), then int8 against the dense engine over 3
    steps, the bound of phase 11."""
    import threading

    import numpy as np

    from fluid_llm_tpu_torch.tools import serve as srv

    runs = os.path.join(tmp, "moe_runs")
    eng = srv.load_engine(runs, buckets=(3, 25), quant="int8", device=str(dev))
    bcfg = eng.model.backbone_cfg
    httpd = srv.serve(eng, "127.0.0.1", 0)
    server = threading.Thread(target=httpd.serve_forever, daemon=True)
    server.start()
    try:
        grid, mask = _client_frames(eng.dataset, 1)
        eng.warmup()
        reset_launches()
        pred, _, wall = _post(f"http://127.0.0.1:{httpd.server_address[1]}", grid, mask, 25)
        launches = read_launches()
    finally:
        httpd.shutdown()
        httpd.server_close()
        server.join()
    convs = eng.cfg.decoder_params.gnn_layers
    want = _want(launches, exact_attention=bcfg.n_layers * 25,
                 quant_matmul_w8a16=4 * bcfg.n_layers * 25, grid_slot_attention=convs * 25)
    dense = srv.load_engine(runs, buckets=(3, 25), device=str(dev))
    quant_pred, dense_pred = eng.predict(grid, mask, 3), dense.predict(grid, mask, 3)
    q_vs_d = float(np.abs(quant_pred - dense_pred).mean() / (np.abs(dense_pred).mean() + 1e-6))
    banks = eng.model.backbone.layers[0].mlp.experts["fc1"]
    ok = (launches == want and not eng.streaming and bool(np.isfinite(pred).all())
          and pred.shape == (25, 3, *grid.shape[-2:]) and q_vs_d < 0.05
          and banks.q.dtype == torch.int8 and banks.q.dim() == 3)
    print(f"[moe serve] load_engine(quant=int8) of the MoE checkpoint: exact rollout, expert "
          f"banks {tuple(banks.q.shape)} int8; one 25-step request over HTTP in {wall:.3f} s; "
          f"launches {launches} (want {want}); int8 vs dense engines, 3 steps: mean |diff| / "
          f"mean |dense| {q_vs_d:.4e} (bound 0.05) {'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append(f"moe serve: launches {launches} (want {want}), int8 vs dense {q_vs_d}")
    return dict(request_s=wall, launches=launches, int8_vs_dense=q_vs_d)


def _frozen_tensors(model) -> dict:
    trainable = {n for n, p in model.named_parameters() if p.requires_grad}
    return {n: t.detach().clone() for n, t in model.state_dict().items() if n not in trainable}


def _w8a16_train_inputs(trainer, batch, failures: list) -> list[dict]:
    """w8a16 against its twin on the card inputs of one int8-frozen train
    step's forward (each distinct (M, K, N) once: k/o, fc1, fc2 at 8 x 601
    rows, bias included), within REL_TOL, with the launch plan and the
    device times of the kernel and the twin."""
    from fluid_llm_tpu_torch.ops import _build
    from fluid_llm_tpu_torch.ops import quant_matmul as qmm

    seen, real = {}, qmm._forward

    def record(x, q, scale, bias, mode):
        seen.setdefault((x.numel() // x.shape[-1], q.shape[1], q.shape[0]),
                        (x.detach().clone(), q, scale, bias))
        return real(x, q, scale, bias, mode)

    with torch.no_grad(), mock.patch.object(qmm, "_forward", record):
        trainer.mode_loss(batch, "autoreg")
    res, sms = [], _build.sm_count(batch[0].device)
    for (M, K, N), (x, q, scale, b) in sorted(seen.items()):
        out, ref = qmm.qmm_w8a16(x, q, scale, b), qmm.int8_matmul_ref(x, q, scale, b, "w8a16")
        rel = rel_err(out, ref)
        r = dict(M=M, K=K, N=N, plan=qmm.plan(M, K, N, sms),
                 swept=(M, K, N) in qmm.SWEPT_PLANS, rel=rel,
                 ms=device_ms(lambda: qmm.qmm_w8a16(x, q, scale, b)),
                 plain_ms=device_ms(lambda: qmm.int8_matmul_ref(x, q, scale, b, "w8a16")))
        ok = rel <= REL_TOL
        print(f"[quant train int8] w8a16 on the train step's inputs M {M} K {K} N {N}, plan "
              f"{r['plan']}{' (swept)' if r['swept'] else ' (grid rule)'}: rel {rel:.3e} "
              f"(bound REL_TOL {REL_TOL}); {r['ms']:.4f} ms, twin {r['plain_ms']:.4f} ms "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"w8a16 at the int8 train step's M {M} K {K} N {N}: rel {rel}")
        res.append(r)
    if len(res) != 3:
        failures.append(f"w8a16 at the int8 train step: shapes {sorted(seen)} (want 3)")
    return res


def phase_quant_train(dev, seed: int, failures: list, tmp: str) -> dict:
    """``training1.yaml`` (OPT-125m, DoRA r16 on q/v) trained over a frozen
    backbone stored three ways, each through ``build_model_and_trainer``:
    ``llm_4bit_loading: true`` (nf4; 3 steps: adapters move, the frozen
    storage stays bit-identical, a checkpoint restores it bit for bit into
    a zeroed template); int8 (``quantize_backbone``; the k, o, fc1 and fc2
    linears through ``Int8Matmul``, the w8a16 kernel, under autograd); and
    ``frozen_bf16: true``."""
    import copy

    from fluid_llm_tpu_torch.config import Config
    from fluid_llm_tpu_torch.data import get_dataset, make_batches
    from fluid_llm_tpu_torch.main import build_model_and_trainer
    from fluid_llm_tpu_torch.ops.quant import NF4Linear, quantize_backbone
    from fluid_llm_tpu_torch.train import checkpoint as ckpt

    cfg = Config.from_yaml(CONFIG).replace(load_dir=f"synthetic:{TRAIN_BS}", seed=seed)
    train_ds = get_dataset(cfg.replace(seq_len=cfg.autoreg_seq_len), mode="train")
    batch = next(make_batches(train_ds, TRAIN_BS, shuffle=True, seed=0, device=dev))
    convs, res = cfg.decoder_params.gnn_layers, {}
    for kind, n_steps in (("nf4", 3), ("int8", 2), ("frozen_bf16", 2)):
        t0 = time.perf_counter()
        c = cfg.replace(llm_4bit_loading=kind == "nf4", frozen_bf16=kind == "frozen_bf16")
        trainer = build_model_and_trainer(c, train_ds.ds_props(), dev)
        model = trainer.model
        if kind == "int8":
            quantize_backbone(model.backbone, "int8")
        setup_s = time.perf_counter() - t0
        torch.cuda.reset_peak_memory_stats()
        frozen = _frozen_tensors(model)
        adapters = {n: p.detach().clone() for n, p in model.named_parameters()
                    if n.startswith("lora.")}
        reset_launches()
        losses, _, ms = _train_steps(trainer, batch, n_steps)
        launches = read_launches()
        peak_mib = torch.cuda.max_memory_allocated() / 2**20
        extra = dict(quant_matmul_w8a16=4 * model.backbone_cfg.n_layers) if kind == "int8" else {}
        want = _train_launches(model.backbone_cfg, convs, n_steps, **extra)
        params = dict(model.named_parameters())
        moved = all(not torch.equal(params[n], t) for n, t in adapters.items()
                    if n.endswith((".B", ".m")))
        still = all(torch.equal(t, frozen[n]) and t.dtype == frozen[n].dtype
                    for n, t in _frozen_tensors(model).items())
        dtypes = sorted({str(t.dtype).replace("torch.", "") for t in frozen.values()})
        ok = (launches == want and all(math.isfinite(x) for x in losses)
              and losses[-1] < losses[0] and moved and still)
        detail, extra_res = "", {}
        if kind == "nf4":
            ok = ok and isinstance(model.backbone.layers[11].mlp["fc2"], NF4Linear)
            ckpt.save_checkpoint(tmp, 1, model, trainer.opt, 1, c)
            template = copy.deepcopy(model)
            with torch.no_grad():
                for t in template.state_dict().values():
                    t.zero_()
            ckpt.restore_checkpoint(tmp, 1, template)
            restored = all(torch.equal(a, b) and a.dtype == b.dtype for a, b in zip(
                model.state_dict().values(), template.state_dict().values()))
            ok = ok and restored
            detail = f"; checkpoint restored bit for bit into a zeroed template {restored}"
            del template
        elif kind == "int8":
            extra_res = dict(
                w8a16_at_train_inputs=_w8a16_train_inputs(trainer, batch, failures),
                agreement=phase_train_agreement(trainer, batch, seed, failures,
                                                "quant train int8 agreement"))
        elif kind == "frozen_bf16":
            ok = ok and all(p.dtype == torch.bfloat16 for p in model.backbone.parameters())
        print(f"[quant train] {kind}: set-up {setup_s:.1f} s; {n_steps} autoreg steps on one "
              f"batch of {TRAIN_BS}: loss {', '.join(f'{x:.5f}' for x in losses)}, step ms "
              f"{', '.join(f'{x:.1f}' for x in ms)}, peak device memory {peak_mib:.1f} MiB; "
              f"adapters moved {moved}; frozen storage "
              f"({', '.join(dtypes)}) bit-identical {still}{detail}; launches {launches} (want "
              f"{want}) {'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"quant train {kind}: losses {losses}, moved {moved}, still {still}, "
                            f"launches {launches} (want {want})")
        prof = device_profile(lambda: trainer.train_step(batch)["loss"].item(), 1,
                              statistics.median(ms[1:]), f"quant train {kind}")
        res[kind] = dict(setup_s=setup_s, losses=losses, step_ms=ms, peak_mem_mib=peak_mib,
                         launches=launches, profile=prof, **extra_res)
        del trainer, model
    return res


def phase_stacked_int8(dev, seed: int, failures: list, tmp: str) -> dict:
    """The flagship as int8 (w8a16) streams 25 steps from the layer list
    and from the stacked layout of the same weights: equal bit for bit,
    w8a16 launches 7 a layer of every step and of the prefill in both, the
    indexed linear none (it is float-only, as in JAX)."""
    from fluid_llm_tpu_torch.config import Config
    from fluid_llm_tpu_torch.data import get_dataset, make_batches
    from fluid_llm_tpu_torch.models import backbone as bb
    from fluid_llm_tpu_torch.models.fluid_llm import FluidLLM
    from fluid_llm_tpu_torch.rollout.streaming import gen_seq_streaming
    from fluid_llm_tpu_torch.utils import set_seed

    cfg = Config.from_yaml(FLAGSHIP).replace(load_dir="synthetic:1")
    test_ds = get_dataset(cfg.replace(seq_len=27), mode="test")
    model = FluidLLM.build(cfg, test_ds.ds_props())
    model.init_weights(set_seed(seed))
    model.to(dev).prepare_inference_params("int8")
    batch = next(make_batches(test_ds, 1, shuffle=False, device=dev))
    n = model.backbone_cfg.n_layers
    out, launches, walls = {}, {}, {}
    for stacked in (False, True):
        if stacked:
            bb.stack_layers(model.backbone)
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out[stacked] = gen_seq_streaming(model, batch, 25)[0]
        torch.cuda.synchronize()
        walls[stacked] = time.perf_counter() - t0
        launches[stacked] = read_launches()
    want = _want(launches[False], quant_matmul_w8a16=7 * n * 26, slab_decode_attention=n * 26,
                 grid_slot_attention=cfg.decoder_params.gnn_layers * 25)
    equal = torch.equal(out[True], out[False])
    ok = (equal and isinstance(model.backbone.layers, bb.StackedLayers)
          and launches[True] == want and launches[False] == want)
    print(f"[stacked int8] flagship_llama.yaml as int8 (w8a16), 25 streaming steps: unrolled "
          f"{walls[False]:.3f} s, stacked {walls[True]:.3f} s; states equal bit for bit {equal}; "
          f"launches unrolled {launches[False]}, stacked {launches[True]} (want {want}) "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append(f"stacked int8: equal {equal}, launches {launches} (want {want})")
    return dict(equal=equal, launches=launches[True], unrolled_s=walls[False],
                stacked_s=walls[True])



HF_OPT = "facebook/opt-125m"


def hf_opt_tensors(seed: int) -> dict:
    """OPT-125m's decoder as ``OPTForCausalLM`` stores it (HF's key names,
    f32: 12 layers at d 768, ffn 3072, vocabulary 50 272, 2 050 position
    rows with OPT's two offset rows), drawn from a seeded generator."""
    g = torch.Generator().manual_seed(seed)
    d, ff = 768, 3072

    def normal(*shape, mean=0.0):
        return torch.randn(*shape, generator=g) * 0.02 + mean

    t = {"model.decoder.embed_tokens.weight": normal(50272, d),
         "model.decoder.embed_positions.weight": normal(2048 + 2, d)}
    for i in range(12):
        L = f"model.decoder.layers.{i}."
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            t[f"{L}self_attn.{name}.weight"], t[f"{L}self_attn.{name}.bias"] = normal(d, d), normal(d)
        for name, (n_out, n_in) in (("fc1", (ff, d)), ("fc2", (d, ff))):
            t[f"{L}{name}.weight"], t[f"{L}{name}.bias"] = normal(n_out, n_in), normal(n_out)
        for name in ("self_attn_layer_norm", "final_layer_norm"):
            t[f"{L}{name}.weight"], t[f"{L}{name}.bias"] = normal(d, mean=1.0), normal(d)
    t["model.decoder.final_layer_norm.weight"] = normal(d, mean=1.0)
    t["model.decoder.final_layer_norm.bias"] = normal(d)
    return t


def port_backbone_name(hf_key: str):
    """The port's ``FluidLLM`` parameter an OPT key lands on (written out
    here, apart from ``models/hf_import.py``), or None for the token table
    the backbone does not carry."""
    k = hf_key[len("model.decoder."):]
    if k == "embed_tokens.weight":
        return None
    if k == "embed_positions.weight":
        return "backbone.pos_embed"
    if k.startswith("final_layer_norm."):
        return "backbone.final_norm." + k.rsplit(".", 1)[1]
    m = re.fullmatch(r"layers\.(\d+)\.(.+)\.(weight|bias)", k)
    place = {"self_attn.q_proj": "attn.q", "self_attn.k_proj": "attn.k",
             "self_attn.v_proj": "attn.v", "self_attn.out_proj": "attn.o",
             "self_attn_layer_norm": "ln1", "final_layer_norm": "ln2",
             "fc1": "mlp.fc1", "fc2": "mlp.fc2"}[m.group(2)]
    return f"backbone.layers.{m.group(1)}.{place}.{m.group(3)}"


def write_snapshot(cache: str, name: str, tensors: dict) -> str:
    """An HF hub cache entry for ``name``: ``refs/main`` and a snapshot
    holding ``config.json`` and ``model.safetensors`` (an 8-byte
    little-endian header length, the JSON header, the raw f32 bytes)."""
    repo = os.path.join(cache, "models--" + name.replace("/", "--"))
    folder = os.path.join(repo, "snapshots", "0" * 40)
    os.makedirs(folder)
    os.makedirs(os.path.join(repo, "refs"))
    with open(os.path.join(repo, "refs", "main"), "w") as f:
        f.write("0" * 40)
    with open(os.path.join(folder, "config.json"), "w") as f:
        json.dump({"model_type": "opt", "architectures": ["OPTForCausalLM"],
                   "hidden_size": 768, "num_hidden_layers": 12, "num_attention_heads": 12,
                   "ffn_dim": 3072, "max_position_embeddings": 2048, "vocab_size": 50272,
                   "word_embed_proj_dim": 768, "do_layer_norm_before": True,
                   "activation_function": "relu", "torch_dtype": "float32"}, f)
    header, offset = {}, 0
    for key, t in tensors.items():
        n = t.numel() * t.element_size()
        header[key] = {"dtype": "F32", "shape": list(t.shape), "data_offsets": [offset, offset + n]}
        offset += n
    raw = json.dumps(header).encode()
    raw += b" " * (-len(raw) % 8)
    with open(os.path.join(folder, "model.safetensors"), "wb") as f:
        f.write(len(raw).to_bytes(8, "little"))
        f.write(raw)
        for t in tensors.values():
            f.write(t.contiguous().numpy().data)
    return folder


class _Records(logging.Handler):
    def __init__(self):
        super().__init__(logging.INFO)
        self.lines: list[str] = []

    def emit(self, record):
        self.lines.append(record.getMessage())


def _rollout_csv(runs: str, dev, csv_path: str) -> tuple[list, dict, float]:
    """``inference.main --checkpoint_dir`` for 251 steps: per-step N-RMSE
    (from its CSV), launches, seconds."""
    from fluid_llm_tpu_torch import inference

    reset_launches()
    t0 = time.perf_counter()
    inference.main(["--checkpoint_dir", runs, "--device", str(dev), "--load_dir", "synthetic:1",
                    "--csv", csv_path])
    secs, launches = time.perf_counter() - t0, read_launches()
    with open(csv_path) as f:
        per_step = [float(line.split(",")[1]) for line in f.read().splitlines()[1:]]
    return per_step, launches, secs


def phase_weights(dev, seed: int, failures: list, tmp: str) -> dict:
    """Weights in and out at OPT-125m's full width and depth: a synthetic HF
    cache (``HF_HUB_CACHE``) holding OPT-125m; ``main`` for 1 epoch of
    ``training1.yaml`` on ``synthetic:1`` imports it (the frozen base in
    the checkpoint equal to the written tensors bit for bit, BOS before the
    first step equal to ``embed_tokens[2]``, the flash and slot launches of
    one step and a 25-step validation); its model exported to a reference
    ``.pt`` (``tools/reference_ckpt.export_state_dict``), imported by
    ``python -m fluid_llm_tpu_torch.tools.reference_ckpt`` into a new run
    folder; ``inference --checkpoint_dir`` 251 steps from both folders,
    per-step N-RMSE equal bit for bit (11x251 exact, 3x251 slot each);
    ``parity_harness --synthetic`` on the card; ``postln_probe`` for
    OPT-125m on the CPU."""
    from fluid_llm_tpu_torch import main as train_main
    from fluid_llm_tpu_torch.config import Config
    from fluid_llm_tpu_torch.data import get_dataset
    from fluid_llm_tpu_torch.models import backbone as bb
    from fluid_llm_tpu_torch.models import hf_import
    from fluid_llm_tpu_torch.models.fluid_llm import FluidLLM
    from fluid_llm_tpu_torch.tools import parity_harness, postln_probe, reference_ckpt
    from fluid_llm_tpu_torch.train import checkpoint as ckpt

    t_phase = time.perf_counter()
    res = {}
    t0 = time.perf_counter()
    written = hf_opt_tensors(seed)
    res["draw_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    folder = write_snapshot(os.path.join(tmp, "hub"), HF_OPT, written)
    res["write_s"] = time.perf_counter() - t0
    res["snapshot_bytes"] = os.path.getsize(os.path.join(folder, "model.safetensors"))
    old_cache = os.environ.get("HF_HUB_CACHE")
    os.environ["HF_HUB_CACHE"] = os.path.join(tmp, "hub")
    handler = _Records()
    loggers = [logging.getLogger(n) for n in ("fluid_llm_tpu_torch.main",
                                              "fluid_llm_tpu_torch.hf_import")]
    levels = [lg.level for lg in loggers]
    for lg in loggers:
        lg.addHandler(handler)
        lg.setLevel(logging.INFO)
    try:
        # the import's two halves at OPT-125m: reading the files, converting
        t0 = time.perf_counter()
        sd, source = hf_import.read_snapshot(hf_import.snapshot_dir(HF_OPT))
        res["read_s"] = time.perf_counter() - t0
        reader_equal = (sorted(sd) == sorted(k[len("model."):] for k in written)
                        and all(torch.equal(sd[k[len("model."):]], t) for k, t in written.items()))
        t0 = time.perf_counter()
        hf_import.backbone_state_dict(sd, bb.preset(HF_OPT))
        res["convert_s"] = time.perf_counter() - t0
        del sd
        print(f"[weights] OPT-125m snapshot ({res['snapshot_bytes'] / 2**20:.1f} MiB f32 "
              f"safetensors) drawn in {res['draw_s']:.2f} s, written in {res['write_s']:.2f} s; "
              f"read from {source} in {res['read_s']:.2f} s, the written tensors bit for bit "
              f"{reader_equal}; converted to the port's state dict in {res['convert_s']:.2f} s")

        # main: import, train one step, validate, checkpoint
        runs = os.path.join(tmp, "runs")
        cfg_path = os.path.join(tmp, "training1.yaml")
        Config.from_yaml(CONFIG).replace(load_dir="synthetic:1", seed=seed, num_epochs=1,
                                         checkpoint_save_path=runs).to_yaml(cfg_path)
        real_build, seen = train_main.build_model_and_trainer, {}

        def build(*a, **kw):
            trainer = real_build(*a, **kw)
            seen["bos"] = trainer.model.bos.detach().cpu().clone()
            return trainer

        reset_launches()
        t0 = time.perf_counter()
        with mock.patch.object(train_main, "build_model_and_trainer", build):
            train_main.main(["--config_path", cfg_path, "--device", str(dev)])
        res["main_s"], res["main_launches"] = time.perf_counter() - t0, read_launches()
        loaded = f"Loaded pretrained backbone {HF_OPT}" in handler.lines
        val_steps, n_layers, convs = 25, 12, 3
        want_main = _want(res["main_launches"], flash_attention_fwd=n_layers,
                          flash_attention_dq=n_layers, flash_attention_dkv=n_layers,
                          grid_slot_attention=convs + convs * val_steps,
                          grid_slot_attention_bwd=convs,
                          exact_attention=(n_layers - 1) * val_steps)
        run = ckpt.get_save_folder(runs, -1)
        frozen = torch.load(os.path.join(run, "step_0", ckpt.STATE_FILE), map_location="cpu",
                            weights_only=True)["frozen"]
        pairs = [(port_backbone_name(k), t) for k, t in written.items()]
        base_equal = all(torch.equal(frozen[n], t) for n, t in pairs if n is not None)
        n_base = sum(n is not None for n, _ in pairs)
        bos_equal = torch.equal(seen["bos"], written["model.decoder.embed_tokens.weight"][2])
        step_ok = (reader_equal and loaded and base_equal and bos_equal
                   and res["main_launches"] == want_main
                   and n_base == len([k for k in frozen if k.startswith("backbone.")]))
        print(f"[weights] main, 1 epoch of training1.yaml on synthetic:1 in {res['main_s']:.1f} "
              f"s: log says loaded {loaded}; the checkpoint's {n_base} frozen base tensors equal "
              f"the written ones bit for bit {base_equal}; BOS before the first step equal to "
              f"embed_tokens[2] {bos_equal}; launches {_nonzero(res['main_launches'])} (want "
              f"{_nonzero(want_main)}, 0 elsewhere: one step, a {val_steps}-step validation) "
              f"{'ok' if step_ok else 'FAIL'}")

        # out through the reference format and back in through the CLI
        cfg_run = ckpt.load_config(run)
        t0 = time.perf_counter()
        probe = get_dataset(cfg_run.replace(seq_len=cfg_run.autoreg_seq_len), mode="valid")
        model = FluidLLM.build(cfg_run, probe.ds_props())
        ckpt.restore_checkpoint(run, 0, model)
        ref_pt = os.path.join(tmp, "reference_step_0.pt")
        torch.save({"params": cfg_run.to_dict(),
                    "state_dict": reference_ckpt.export_state_dict(model)}, ref_pt)
        res["export_s"] = time.perf_counter() - t0
        del model
        imported = os.path.join(tmp, "imported")
        t0 = time.perf_counter()
        cli = subprocess.run([sys.executable, "-m", "fluid_llm_tpu_torch.tools.reference_ckpt",
                              ref_pt, "--save_dir", os.path.join(imported, "000")],
                             cwd=os.path.dirname(os.path.dirname(CONFIG)), capture_output=True,
                             text=True, timeout=600)
        res["import_cli_s"] = time.perf_counter() - t0
        if cli.returncode != 0:
            raise RuntimeError(f"reference_ckpt CLI exited {cli.returncode}: {cli.stderr[-2000:]}")
        rolls = {name: _rollout_csv(r, dev, os.path.join(tmp, f"{name}.csv"))
                 for name, r in (("original", runs), ("imported", imported))}
        want_inf = _want(rolls["original"][1], exact_attention=(n_layers - 1) * STEPS,
                         grid_slot_attention=convs * STEPS)
        same = rolls["original"][0] == rolls["imported"][0]
        roll_ok = (same and len(rolls["original"][0]) == STEPS
                   and all(math.isfinite(x) for x in rolls["original"][0])
                   and all(r[1] == want_inf for r in rolls.values()))
        res.update(n_rmse_mean=statistics.fmean(rolls["original"][0]),
                   rollout_launches={k: r[1] for k, r in rolls.items()},
                   rollout_s={k: r[2] for k, r in rolls.items()}, n_rmse_equal=same)
        print(f"[weights] exported to a reference .pt in {res['export_s']:.1f} s; "
              f"reference_ckpt CLI imported it in {res['import_cli_s']:.1f} s "
              f"({cli.stdout.strip()}); inference --checkpoint_dir {STEPS} steps: original "
              f"{rolls['original'][2]:.1f} s, imported {rolls['imported'][2]:.1f} s, mean N-RMSE "
              f"{res['n_rmse_mean']:.6f}, per-step N-RMSE equal bit for bit {same}; launches "
              f"{_nonzero(rolls['original'][1])} / {_nonzero(rolls['imported'][1])} (want "
              f"{_nonzero(want_inf)}, 0 elsewhere) {'ok' if roll_ok else 'FAIL'}")

        # the parity harness on the card, the probe on the CPU
        reset_launches()
        t0 = time.perf_counter()
        record = parity_harness.main(["--synthetic", "--device", str(dev),
                                      "--out", os.path.join(tmp, "parity.json")])
        res["harness_s"], res["harness_launches"] = time.perf_counter() - t0, read_launches()
        t0 = time.perf_counter()
        r2 = postln_probe.readout_r2(HF_OPT)
        res["probe_s"] = time.perf_counter() - t0
        tools_ok = (math.isfinite(record["ours"]["n_rmse_mean"]) and record["reference"] is None
                    and math.isfinite(r2))
        res.update(harness_n_rmse_mean=record["ours"]["n_rmse_mean"], probe_r2=r2)
        print(f"[weights] parity_harness --synthetic on {dev}: {res['harness_s']:.1f} s, ours "
              f"mean N-RMSE {record['ours']['n_rmse_mean']:.5f}, reference "
              f"{record['reference']}, launches {_nonzero(res['harness_launches'])}; "
              f"postln_probe {HF_OPT} on the CPU: R^2 {r2:+.4f} in {res['probe_s']:.1f} s "
              f"{'ok' if tools_ok else 'FAIL'}")
    finally:
        for lg, level in zip(loggers, levels):
            lg.removeHandler(handler)
            lg.setLevel(level)
        if old_cache is None:
            os.environ.pop("HF_HUB_CACHE", None)
        else:
            os.environ["HF_HUB_CACHE"] = old_cache
    res["phase_s"] = time.perf_counter() - t_phase
    if not (step_ok and roll_ok and tools_ok):
        failures.append(f"weights in and out: import and train {step_ok}, round trip "
                        f"{roll_ok}, harness and probe {tools_ok}")
    return res


PARALLEL_RANKS = 4
# phase 23 (b)'s meshes of the four ranks: (name, parallel keys, config
# replacements, backbone overrides, the one-process reference step)
PARALLEL_CASES = (
    ("data 2 x model 2", {"model_axis": 2}, {}, {}, "dora"),
    ("fsdp 2 x model 2", {"model_axis": 2, "fsdp_axis": 2}, {}, {}, "dora"),
    ("pipe 2", {"pipe_axis": 2}, {"use_lora": False}, {"dropout": 0.0}, "full"),
    ("ring over model 2", {"model_axis": 2, "seq_sharded_acts": True, "ring_attention": True},
     {}, {}, "dora"),
    ("int8 frozen, data 2 x model 2", {"model_axis": 2}, {}, {}, "int8"),
)
# the one-process references: (config replacements, backbone overrides,
# frozen backbone storage)
PARALLEL_REFS = {"dora": ({}, {}, None), "full": ({"use_lora": False}, {"dropout": 0.0}, None),
                 "int8": ({}, {}, "int8")}
PARALLEL_LABEL = "ranks sharing one card, host-staged collectives; not performance numbers"
# phase 23 (b)'s rollout on data 2 x model 2 (251 steps until the expert
# axis took its time: its check reads step 1)
PARALLEL_STEPS = 25
# phase 24 (a): moe_cylinder.yaml's step on each mesh, against one process
EXPERT_CASES = (
    ("expert 4", {"expert_axis": 4}, "topk"),
    ("data 2 x expert 2", {"expert_axis": 2}, "topk"),
    ("model 2 x expert 2", {"model_axis": 2, "expert_axis": 2}, "topk"),
    ("fsdp 2 x expert 2", {"fsdp_axis": 2, "expert_axis": 2}, "topk"),
    ("expert_choice, expert 2", {"expert_axis": 2}, "expert_choice"),
)
# the rollouts of phase 24 and its served request
EXPERT_STEPS = 25
PIPE_STREAM_MESH = {"pipe_axis": 2, "model_axis": 2}  # phase 24 (d)
# w8a16 at the flagship's linears cut over model 2 (q, k, v; o; gate, up;
# down), the decode step's 60 rows and the prefill's 61
W8A16_RANK_SHAPES = [(M, K, N) for M in (60, 61)
                     for K, N in ((768, 384), (384, 768), (768, 1024), (1024, 768))]
# the entry-point driver of phase 23 (a): in one process, for each argument
# list of the JSON argv[1], ``python -m fluid_llm_tpu_torch.main`` (runpy, as
# the module's __main__), then its launch counters printed
ENTRY_DRIVER = (
    "import json, runpy, sys\n"
    "from chip_smoke import read_launches, reset_launches\n"
    "for argv in json.loads(sys.argv[1]):\n"
    "    reset_launches()\n"
    "    sys.argv = ['fluid_llm_tpu_torch.main'] + argv\n"
    "    runpy.run_module('fluid_llm_tpu_torch.main', run_name='__main__')\n"
    "    print('LAUNCHES ' + json.dumps(read_launches()), flush=True)\n")


def _parallel_cfg(seed: int, par: dict | None = None, **repl):
    from fluid_llm_tpu_torch.config import Config, ParallelConfig

    cfg = Config.from_yaml(CONFIG).replace(load_dir=f"synthetic:{TRAIN_BS}", seed=seed, **repl)
    return cfg.replace(parallel=ParallelConfig(**(par or {})))


def _one_step(trainer, batch, seed: int) -> tuple[float, float | None]:
    """One step's loss and balance loss (``moe_aux``, None for a dense
    model) and its trainable gradients (summed over the mesh's ranks), no
    optimizer step: ``phase_train_agreement``'s step."""
    from fluid_llm_tpu_torch.parallel.mesh import sync_grads

    trainer.model.zero_grad(set_to_none=True)
    trainer.generator.manual_seed(seed)
    with trainer.on_mesh(batch):
        loss, metrics = trainer.mode_loss(batch, "autoreg")
        loss.backward()
    sync_grads(trainer.model)
    aux = metrics.get("moe_aux")
    return loss.item(), None if aux is None else aux.item()


def _grad_distance(model, ref: dict) -> tuple[float, float]:
    """This rank's share of ``||g - ref||^2`` and ``||ref||^2`` over the
    trainable gradients: each chunk counted on one rank only (the ranks
    along the axes that do not cut it, and, for a stage's blocks, the
    pipe axis, at index 0)."""
    from fluid_llm_tpu_torch.parallel.mesh import _owner, local_tensor

    mesh = model.mesh
    d2 = r2 = 0.0
    for name, p in model.named_parameters():
        if p.grad is None:
            continue
        mod, leaf = _owner(model, name)
        cut = {a for _, a, _ in getattr(mod, "shards", {}).get(leaf, ())}
        if mesh.size("pipe") > 1 and name.startswith("backbone.layers."):
            cut.add("pipe")
        if any(mesh.coords[a] != 0 for a in mesh.axis_names if a not in cut):
            continue
        r = local_tensor(mod, leaf, ref[name].to(p.device))
        d2 += float(((p.grad.float() - r) ** 2).sum())
        r2 += float((r * r).sum())
    return d2, r2


def _rank_trainer(cfg, props, dev, over: dict, state: dict, quant=None):
    """``main.build_model_and_trainer``'s model and trainer on this rank,
    its weights the seeded draw the parent wrote (``state``; with ``quant``
    the backbone stored so first) rather than drawn again: built whole,
    moved, cut to this rank's part of the mesh."""
    from fluid_llm_tpu_torch.models.fluid_llm import FluidLLM
    from fluid_llm_tpu_torch.ops.quant import quantize_backbone
    from fluid_llm_tpu_torch.parallel.mesh import make_mesh, shard_model
    from fluid_llm_tpu_torch.train.trainer import Trainer

    model = FluidLLM.build(cfg, props, **over)
    if quant is not None:
        quantize_backbone(model.backbone, quant)
    model.load_state_dict(state)
    model.to(dev)
    shard_model(model, make_mesh(cfg.parallel))
    return Trainer(model)


def parallel_rank(rank: int, folder: str) -> None:
    """One rank of phase 23 (b): the four ranks share the card over gloo
    (collectives staged through host memory); each case of PARALLEL_CASES
    builds the seeded model whole, keeps this rank's part and takes one
    step on its rows of the batch; then the 251-step rollout on data 2 x
    model 2.  Rank 0 writes ``result.pt``."""
    import torch.distributed as dist

    from fluid_llm_tpu_torch import inference
    from fluid_llm_tpu_torch.data import get_dataset, make_batches
    from fluid_llm_tpu_torch.parallel import comm, launch
    from fluid_llm_tpu_torch.parallel.mesh import full_state_dict, shard_batch
    from fluid_llm_tpu_torch.train import checkpoint as ckpt

    spec = torch.load(os.path.join(folder, "spec.pt"), weights_only=False)
    seed = spec["seed"]
    dev = torch.device(spec["device"])
    if dev.type == "cuda":  # over gloo every rank on the one card, over nccl a card a rank
        dev = torch.device("cuda", rank % torch.cuda.device_count()
                           if spec["backend"] == "nccl" else dev.index or 0)
        torch.cuda.set_device(dev)
    logging.getLogger("fluid_llm_tpu_torch").setLevel(logging.WARNING)
    launch.start(spec["backend"], f"file://{folder}/init", PARALLEL_RANKS, rank, dev)
    world = comm.Group(list(range(PARALLEL_RANKS)), rank, None, spec["backend"])
    out = {}
    states = {key: torch.load(os.path.join(folder, f"state_{key}.pt"), weights_only=True)
              for key in PARALLEL_REFS}
    for name, par, repl, over, ref_key in PARALLEL_CASES:
        t0 = time.perf_counter()
        cfg = _parallel_cfg(seed, par, **repl)
        ds = get_dataset(cfg.replace(seq_len=cfg.autoreg_seq_len), mode="train")
        trainer = _rank_trainer(cfg, ds.ds_props(), dev, over, states[ref_key],
                                PARALLEL_REFS[ref_key][2])
        setup_s = time.perf_counter() - t0
        model = trainer.model
        batch = shard_batch(next(make_batches(ds, TRAIN_BS, shuffle=True, seed=0, device=dev)),
                            model.mesh)
        ref = torch.load(os.path.join(folder, f"ref_{ref_key}.pt"), weights_only=False)
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        loss, _ = _one_step(trainer, batch, seed)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = _nonzero(read_launches())
        sums = comm.all_reduce(torch.tensor(_grad_distance(model, ref["grads"]),
                                            dtype=torch.float64, device=dev), world).tolist()
        per_rank = [None] * PARALLEL_RANKS
        dist.all_gather_object(per_rank, dict(launches=launches, seconds=secs, setup_s=setup_s,
                                              rows=tuple(batch[0].shape)))
        res = dict(loss=loss, ref_loss=ref["loss"], grad_rel=math.sqrt(sums[0] / sums[1]),
                   per_rank=per_rank, mesh=model.mesh.shape,
                   heads=model.backbone.parallel.cfg.n_heads)
        if name == "data 2 x model 2":  # the checkpoint: written here, read back
            trainer.opt.step()
            runs = os.path.join(folder, "runs")
            ckpt.save_checkpoint(runs, 0, model, trainer.opt, 0, cfg)
            res["trainable"] = {n: t.cpu() for n, t in full_state_dict(model).items()
                                if n in model.trainable_names}
            again = _rank_trainer(cfg, ds.ds_props(), dev, over, states[ref_key])
            ckpt.restore_checkpoint(runs, 0, again.model, again.opt)
            mine, back = model.state_dict(), again.model.state_dict()
            differ = [None] * PARALLEL_RANKS
            dist.all_gather_object(differ, [n for n in mine if not torch.equal(mine[n], back[n])])
            res["restored_differ"] = differ
            res["restored_on_mesh"] = not any(differ)
            del again
        out[name] = res
        del trainer, model
        torch.cuda.empty_cache()
    cfg = _parallel_cfg(seed, {"model_axis": 2}).replace(load_dir="synthetic:2")
    model = inference.build_seeded_model(cfg, seed, dev)
    test_ds = get_dataset(cfg.replace(seq_len=PARALLEL_STEPS + 2), mode="test")
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    per_step, mean = inference.test_generate(model, test_ds, batch_size=2,
                                             pred_steps=PARALLEL_STEPS)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    per_rank = [None] * PARALLEL_RANKS
    dist.all_gather_object(per_rank, dict(launches=_nonzero(read_launches()), seconds=secs))
    out["rollout"] = dict(per_step=[float(x) for x in per_step], mean=mean, per_rank=per_rank,
                          mesh=model.mesh.shape, heads=model.backbone.parallel.cfg.n_heads)
    out["backend"] = spec["backend"]
    del model
    torch.cuda.empty_cache()
    out["expert"] = expert_rank(rank, folder, dev, seed, world)
    if rank == 0:
        torch.save(out, os.path.join(folder, "result.pt"))
    launch.finish()


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _entry_runs(argvs: list, tmp: str):
    """Start ``python -m fluid_llm_tpu_torch.main argv`` for each of
    ``argvs``, one after the other in a process of its own (ENTRY_DRIVER),
    and return ``collect``: ``collect()`` waits for the process and gives
    each run's logged metrics and launch counts, and the process's seconds;
    ``collect(kill=True)`` ends it."""
    jls = [os.path.join(tmp, f"entry{i}.jsonl") for i in range(len(argvs))]
    argvs = [a + ["--metrics_jsonl", jl] for a, jl in zip(argvs, jls)]
    root = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    proc = subprocess.Popen([sys.executable, "-c", ENTRY_DRIVER, json.dumps(argvs)], cwd=root,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)

    def collect(kill: bool = False) -> tuple[list, float]:
        if kill:
            proc.kill()
            proc.communicate()
            return [], time.perf_counter() - t0
        try:
            stdout, stderr = proc.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.communicate()
            raise
        secs = time.perf_counter() - t0
        if proc.returncode:
            raise RuntimeError(f"main exited {proc.returncode}: {stderr[-3000:]}")
        counts = [json.loads(x[len("LAUNCHES "):]) for x in stdout.splitlines()
                  if x.startswith("LAUNCHES ")]
        runs = []
        for jl, launches in zip(jls, counts):
            with open(jl) as f:
                runs.append(([json.loads(x) for x in f], launches))
        return runs, secs

    return collect


def phase_parallel(dev, seed: int, failures: list, tmp: str) -> dict:
    """Phase 23, the parallel axes.  (a) ``main --distributed`` with the
    three flags on one rank over nccl, against the same run without
    ``--distributed``: the logged losses and N-RMSE and the launch counts
    equal bit for bit, in a process that runs while this one computes
    (b)'s one-process references.  (b) Four ranks sharing the card over
    gloo, CUDA compute and host-staged collectives (nccl refuses two ranks on one
    device), at the full width of ``training1.yaml``: one step each on
    data 2 x model 2, fsdp 2 x model 2, pipe 2 (full fine-tuning,
    backbone dropout 0, 4 microbatches) and ring attention over model 2
    (601 tokens padded to 602), and DoRA over an int8 frozen backbone on
    data 2 x model 2 (w8a16 at (384, 768), (768, 384), (1536, 768),
    (768, 1536): 48 a step), each against the one-process step with
    the kernels (loss within REL_TOL, the trainable gradient's relative L2
    within GRAD_TOL: ``phase_train_agreement``'s bounds, as here bf16
    activations through 12 layers round at other places: each row-parallel
    linear's two bf16 partial outputs summed, in f32); launches per rank
    (flash 12 a step at H 6 under model 2, 24 a stage under pipe 2: 6
    blocks x 4 microbatches, 0 under the ring, whose hops are plain
    einsums); a checkpoint written on data 2 x model 2, restored onto that
    mesh (bit for bit) and in one process (equal to the mesh's gathered
    parameters, the frozen base the seeded draw); the 251-step rollout of 2
    trajectories on data 2 x model 2 (exact attention 11 x 251 a rank at H
    6), per-step N-RMSE against one process's (step 1 within REL_TOL).
    The ranks' times share one card and stage their collectives through
    the host: they are not performance numbers."""
    res = {}
    t_phase = time.perf_counter()
    os.makedirs(tmp, exist_ok=True)
    # (a) one rank over nccl through the entry point
    cfg_path = os.path.join(tmp, "entry.yaml")
    _parallel_cfg(seed).replace(num_epochs=1, save_on=False).to_yaml(cfg_path)
    base = ["--config_path", cfg_path, "--device", "cuda"]
    collect = _entry_runs(
        [base, base + ["--distributed", "--coordinator_address", f"127.0.0.1:{_free_port()}",
                       "--num_processes", "1", "--process_id", "0"]], tmp)
    # (b)'s one-process references while (a)'s process runs; then four
    # ranks on the card, which also run phase 24 (their start-up paid once)
    folder = os.path.join(tmp, "ranks")
    try:
        refs = parallel_references(dev, seed, folder)
        t0 = time.perf_counter()
        expert_refs = expert_references(dev, seed, folder)
        expert_s = time.perf_counter() - t0
    except BaseException:
        collect(kill=True)
        raise
    (plain, dist_run), secs = collect()
    ok_a = plain[0] == dist_run[0] and plain[1] == dist_run[1] and \
        dist_run[1]["flash_attention_fwd"] > 0
    res["entry"] = dict(plain=plain[0], distributed=dist_run[0], launches=_nonzero(plain[1]),
                        launches_distributed=_nonzero(dist_run[1]), seconds=secs)
    print(f"[parallel] (a) main, 1 epoch of training1.yaml on synthetic:{TRAIN_BS}, without "
          f"--distributed then with --distributed --num_processes 1 over nccl, in one process "
          f"of {secs:.1f} s; train loss {[m['train/Autoreg/loss'] for m in plain[0]]} / "
          f"{[m['train/Autoreg/loss'] for m in dist_run[0]]}; logs equal bit for bit "
          f"{plain[0] == dist_run[0]}, launches equal {plain[1] == dist_run[1]} "
          f"({_nonzero(dist_run[1])}) {'ok' if ok_a else 'FAIL'}")
    if not ok_a:
        failures.append(f"parallel (a): logs or launches differ: {res['entry']}")

    backend = "gloo"
    torch.save({"seed": seed, "backend": backend, "device": str(dev)},
               os.path.join(folder, "spec.pt"))
    t0 = time.perf_counter()
    got = spawn_ranks([sys.executable, os.path.abspath(__file__)], folder)
    ranks_s = time.perf_counter() - t0
    ok_b = check_parallel(dev, seed, folder, got, refs, res, failures)
    # phase 24: its references, the ranks' share, its checks
    t0 = time.perf_counter()
    expert = {}
    ok_24 = check_expert(dev, seed, folder, got["expert"], expert_refs, expert, failures)
    ranks_24 = sum(got["expert"][k] for k in ("a_s", "b_s", "c_s", "d_s"))
    expert_s += ranks_24 + time.perf_counter() - t0
    expert.update(refs_and_checks_s=expert_s - ranks_24, ranks_s=ranks_24,
                  parts_s={k: got["expert"][k] for k in ("a_s", "b_s", "c_s", "d_s")},
                  phase_s=expert_s)
    res.update(ranks_s=ranks_s, backend=backend, expert=expert,
               phase_s=time.perf_counter() - t_phase - expert_s)
    print(f"[parallel] (b) four ranks over {backend} in {ranks_s:.1f} s, start-up and phase 24's "
          f"{ranks_24:.1f} s on rank 0 included ({PARALLEL_LABEL}) {'ok' if ok_b else 'FAIL'}")
    print(f"[expert axis and sharded serving] phase seconds {expert_s:.1f} (rank 0: (a) "
          f"{got['expert']['a_s']:.1f}, (b) {got['expert']['b_s']:.1f}, (c) "
          f"{got['expert']['c_s']:.1f}, (d) {got['expert']['d_s']:.1f}; references and checks "
          f"{expert_s - ranks_24:.1f}) {'ok' if ok_24 else 'FAIL'}")
    return res


def parallel_references(dev, seed: int, folder: str) -> dict:
    """Phase 23 (b)'s one-process references: one step of each
    PARALLEL_REFS configuration (loss and gradients, written for the
    ranks), the frozen tensors of the DoRA model, and the 251-step rollout
    of 2 trajectories (per-step N-RMSE)."""
    from fluid_llm_tpu_torch import inference
    from fluid_llm_tpu_torch.data import get_dataset, make_batches
    from fluid_llm_tpu_torch.main import build_model_and_trainer
    from fluid_llm_tpu_torch.ops.quant import quantize_backbone

    os.makedirs(folder, exist_ok=True)
    out = {}
    for key, (repl, over, quant) in PARALLEL_REFS.items():
        cfg = _parallel_cfg(seed, **repl)
        ds = get_dataset(cfg.replace(seq_len=cfg.autoreg_seq_len), mode="train")
        trainer = build_model_and_trainer(cfg, ds.ds_props(), dev, pretrained=False, **over)
        if quant is not None:
            quantize_backbone(trainer.model.backbone, quant)
        torch.save({k: v.cpu() for k, v in trainer.model.state_dict().items()},
                   os.path.join(folder, f"state_{key}.pt"))  # the ranks' weights
        batch = next(make_batches(ds, TRAIN_BS, shuffle=True, seed=0, device=dev))
        reset_launches()
        loss, _ = _one_step(trainer, batch, seed)
        out[f"{key}_launches"] = _nonzero(read_launches())
        grads = {n: p.grad.float().cpu() for n, p in trainer.model.named_parameters()
                 if p.grad is not None}
        torch.save({"loss": loss, "grads": grads}, os.path.join(folder, f"ref_{key}.pt"))
        if key == "dora":
            trainable = {n for n, p in trainer.model.named_parameters() if p.requires_grad}
            out["frozen"] = {n: t.cpu() for n, t in trainer.model.state_dict().items()
                             if n not in trainable}
        del trainer, grads
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    cfg = _parallel_cfg(seed).replace(load_dir="synthetic:2")
    model = inference.build_seeded_model(cfg, seed, dev)
    test_ds = get_dataset(cfg.replace(seq_len=PARALLEL_STEPS + 2), mode="test")
    steps, out["roll_mean"] = inference.test_generate(model, test_ds, batch_size=2,
                                                      pred_steps=PARALLEL_STEPS)
    out["roll_steps"] = [float(x) for x in steps]
    return out


def spawn_ranks(cmd: list, folder: str, timeout: float = 600) -> dict:
    """``cmd --parallel-rank r --parallel-dir folder`` for every rank;
    rank 0's ``result.pt``."""
    procs = [subprocess.Popen(cmd + ["--parallel-rank", str(r), "--parallel-dir", folder],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(PARALLEL_RANKS)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    bad = [(r, p.returncode) for r, p in enumerate(procs) if p.returncode]
    if bad:
        raise RuntimeError(f"parallel ranks exited {bad}: {logs[bad[0][0]][-3000:]}")
    return torch.load(os.path.join(folder, "result.pt"), weights_only=False)


def check_parallel(dev, seed: int, folder: str, got: dict, refs: dict, res: dict,
                   failures: list) -> bool:
    """Phase 23 (b)'s checks of the ranks' results ``got`` against the
    one-process ``refs``, recorded in ``res``, printed."""
    from fluid_llm_tpu_torch.data import get_dataset
    from fluid_llm_tpu_torch.main import build_model_and_trainer
    from fluid_llm_tpu_torch.train import checkpoint as ckpt

    frozen, ref_steps, ref_mean = refs["frozen"], refs["roll_steps"], refs["roll_mean"]
    label = PARALLEL_LABEL if got["backend"] == "gloo" else "ranks over nccl, a card each"
    ok_b = True
    for name, par, repl, over, ref_key in PARALLEL_CASES:
        r = got[name]
        loss_rel = abs(r["loss"] - r["ref_loss"]) / abs(r["ref_loss"])
        want = {}
        m = r["mesh"].get("model", 1)
        if "pipe" in r["mesh"]:
            n = (12 // r["mesh"]["pipe"]) * 4  # its stage's blocks, every microbatch
            want = dict(flash_attention_fwd=n, flash_attention_dq=n, flash_attention_dkv=n)
        elif not par.get("ring_attention"):
            want = dict(flash_attention_fwd=12, flash_attention_dq=12, flash_attention_dkv=12)
        want.update(grid_slot_attention=3, grid_slot_attention_bwd=3)
        if ref_key == "int8":  # k, o, fc1, fc2 through Int8Matmul at N/2 or K/2
            want.update(quant_matmul_w8a16=4 * 12)
        counts_ok = all(pr["launches"] == want for pr in r["per_rank"])
        heads_ok = r["heads"] == 12 // (m if not par.get("ring_attention") else 1)
        ok = loss_rel <= REL_TOL and r["grad_rel"] <= GRAD_TOL and counts_ok and heads_ok
        ok_b &= ok
        res[name] = dict(loss=r["loss"], ref_loss=r["ref_loss"], loss_rel=loss_rel,
                         grad_rel=r["grad_rel"], mesh=r["mesh"], heads=r["heads"],
                         per_rank=r["per_rank"], want_launches=want)
        print(f"[parallel] (b) {name} {r['mesh']}, {r['heads']} heads a rank: loss "
              f"{r['loss']:.6f} vs one process {r['ref_loss']:.6f} (rel {loss_rel:.3e}, bound "
              f"{REL_TOL}); trainable gradient rel L2 {r['grad_rel']:.3e} (bound {GRAD_TOL}); "
              f"launches per rank {[pr['launches'] for pr in r['per_rank']]} (want {want}); rows "
              f"{r['per_rank'][0]['rows'][:1]}; set-up s "
              f"{[round(pr['setup_s'], 2) for pr in r['per_rank']]}, step s "
              f"{[round(pr['seconds'], 3) for pr in r['per_rank']]} ({label}) "
              f"{'ok' if ok else 'FAIL'}")
    # the checkpoint of data 2 x model 2 in one process
    name = "data 2 x model 2"
    cfg = _parallel_cfg(seed, PARALLEL_CASES[0][1])
    ds = get_dataset(cfg.replace(seq_len=cfg.autoreg_seq_len), mode="train")
    one = build_model_and_trainer(cfg, ds.ds_props(), dev, pretrained=False)
    ckpt.restore_checkpoint(os.path.join(folder, "runs"), 0, one.model, one.opt)
    state = one.model.state_dict()
    ck_ok = all(torch.equal(state[n].cpu(), t) for n, t in got[name]["trainable"].items()) and \
        all(torch.equal(state[n].cpu(), t) for n, t in frozen.items()) and \
        got[name]["restored_on_mesh"]
    del one
    print(f"[parallel] (b) checkpoint written on {name}: restored onto the mesh bit for bit "
          f"{got[name]['restored_on_mesh']}; in one process, trainable equal to the mesh's "
          f"and the frozen base to the seeded draw: {'ok' if ck_ok else 'FAIL'}")
    # the rollout
    roll = got["rollout"]
    # entry 0 is the context state itself (N-RMSE 0 on both); steps 1..251
    rel = [abs(a - b) / abs(b) for a, b in zip(roll["per_step"][1:], ref_steps[1:])]
    want_roll = dict(exact_attention=11 * PARALLEL_STEPS, grid_slot_attention=3 * PARALLEL_STEPS)
    roll_ok = rel[0] <= REL_TOL and all(pr["launches"] == want_roll for pr in roll["per_rank"]) \
        and all(math.isfinite(x) for x in roll["per_step"]) and roll["heads"] == 6
    res["rollout"] = dict(per_step=roll["per_step"], ref_per_step=[float(x) for x in ref_steps],
                          rel=rel, mean=roll["mean"], ref_mean=ref_mean, mesh=roll["mesh"],
                          per_rank=roll["per_rank"])
    print(f"[parallel] (b) rollout on {roll['mesh']}, 2 trajectories x {PARALLEL_STEPS} steps, "
          f"{roll['heads']} heads a rank: mean N-RMSE {roll['mean']:.5f} vs one process "
          f"{ref_mean:.5f}; per-step rel difference step 1 {rel[0]:.3e} (bound {REL_TOL}), "
          f"steps 1-10 max {max(rel[:10]):.3e}, all {max(rel):.3e}; launches per rank "
          f"{[pr['launches'] for pr in roll['per_rank']]} (want {want_roll}); rollout s "
          f"{[round(pr['seconds'], 2) for pr in roll['per_rank']]} ({label}) "
          f"{'ok' if roll_ok else 'FAIL'}")
    if not (ok_b and ck_ok and roll_ok):
        failures.append(f"parallel (b): steps {ok_b}, checkpoint {ck_ok}, rollout {roll_ok}")
    return ok_b and ck_ok and roll_ok


# -- phase 24: the expert axis and sharded serving ---------------------------


def _moe_cfg(seed: int, par: dict | None = None, router: str = "topk", **repl):
    """``configs/moe_cylinder.yaml`` as published, its parallel keys ``par``
    and its router ``router``."""
    import dataclasses

    from fluid_llm_tpu_torch.config import Config, ParallelConfig

    cfg = Config.from_yaml(MOE).replace(load_dir=f"synthetic:{TRAIN_BS}", seed=seed, **repl)
    cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, router=router))
    return cfg.replace(parallel=ParallelConfig(**(par or {})))


def _flagship_cfg(seed: int, par: dict | None = None):
    from fluid_llm_tpu_torch.config import Config, ParallelConfig

    cfg = Config.from_yaml(FLAGSHIP).replace(load_dir="synthetic:2", seed=seed)
    return cfg.replace(parallel=ParallelConfig(**(par or {})))


def _pipe_flagship_cfg(seed: int, par: dict | None = None):
    """The flagship fine-tuned in full (pipeline stages take no adapters)."""
    return _flagship_cfg(seed, par).replace(use_lora=False)


def _digest(state: dict) -> dict:
    """A SHA-1 of every tensor's bytes (a checkpoint compared bit for bit
    without moving it)."""
    import hashlib

    return {n: hashlib.sha1(t.detach().reshape(-1).contiguous().view(torch.uint8).cpu()
                            .numpy().tobytes()).hexdigest() for n, t in state.items()}


def _model_cut(whole: torch.Tensor, like: torch.Tensor, index: int) -> torch.Tensor:
    """Chunk ``index`` of ``whole`` along the one dim where ``like`` (a
    rank's tensor) is smaller: a tensor cut over the model axis."""
    if whole.shape == like.shape:
        return whole
    d = next(i for i, (a, b) in enumerate(zip(like.shape, whole.shape)) if a != b)
    return whole.narrow(d, index * like.shape[d], like.shape[d])


def _gather(obj, n: int) -> list:
    import torch.distributed as dist

    parts = [None] * n
    dist.all_gather_object(parts, obj)
    return parts


def expert_rank(rank: int, folder: str, dev, seed: int, world) -> dict:
    """Phase 24 on one of phase 23's ranks (their start-up paid once).
    (a) ``moe_cylinder.yaml``: one step on each mesh of EXPERT_CASES, a
    checkpoint written on expert 4, the EXPERT_STEPS-step rollout of 4
    trajectories on data 2 x expert 2; (b) ``flagship_llama.yaml`` streamed
    on data 2 x model 2, one slab-decode call's inputs kept; (c)
    ``tools.serve`` over the four ranks (data 2 x model 2, int8) on the
    parent's flagship checkpoint: rank 0 serves over HTTP, the others
    follow; one follower's streaming cache is out of memory once.  Every
    time here is of ranks sharing one card."""
    import threading

    from fluid_llm_tpu_torch import inference
    from fluid_llm_tpu_torch.data import get_dataset, make_batches
    from fluid_llm_tpu_torch.main import build_model_and_trainer
    from fluid_llm_tpu_torch.ops import decode_attention as da
    from fluid_llm_tpu_torch.parallel import comm
    from fluid_llm_tpu_torch.parallel.mesh import full_state_dict, shard_batch
    from fluid_llm_tpu_torch.tools import serve as srv
    from fluid_llm_tpu_torch.train import checkpoint as ckpt

    n = PARALLEL_RANKS
    out = {}
    t_a = time.perf_counter()
    for name, par, router in EXPERT_CASES:
        t0 = time.perf_counter()
        cfg = _moe_cfg(seed, par, router)
        ds = get_dataset(cfg.replace(seq_len=cfg.autoreg_seq_len), mode="train")
        trainer = build_model_and_trainer(cfg, ds.ds_props(), dev, pretrained=False)
        model = trainer.model
        setup_s = time.perf_counter() - t0
        batch = shard_batch(next(make_batches(ds, TRAIN_BS, shuffle=True, seed=0, device=dev)),
                            model.mesh)
        ref = torch.load(os.path.join(folder, f"ref_moe_{router}.pt"), weights_only=False)
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        loss, aux = _one_step(trainer, batch, seed)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = _nonzero(read_launches())
        sums = comm.all_reduce(torch.tensor(_grad_distance(model, ref["grads"]),
                                            dtype=torch.float64, device=dev), world).tolist()
        banks = {k: tuple(b.weight.shape)
                 for k, b in model.backbone.layers[0].mlp.experts.items()}
        per_rank = _gather(dict(launches=launches, seconds=secs, setup_s=setup_s,
                                rows=tuple(batch[0].shape), banks=banks,
                                coords=model.mesh.coords), n)
        res = dict(loss=loss, ref_loss=ref["loss"], aux=aux, ref_aux=ref["aux"],
                   grad_rel=math.sqrt(sums[0] / sums[1]), per_rank=per_rank,
                   mesh=model.mesh.shape, heads=model.backbone.parallel.cfg.n_heads)
        if name == "expert 4":  # the checkpoint: written here, read in one process
            trainer.opt.step()
            ckpt.save_checkpoint(os.path.join(folder, "moe_runs"), 0, model, trainer.opt, 0, cfg)
            res["digest"] = _digest(full_state_dict(model))
        out[name] = res
        del trainer, model, ref
        torch.cuda.empty_cache()
    cfg = _moe_cfg(seed, {"expert_axis": 2}).replace(load_dir="synthetic:4")
    model = inference.build_seeded_model(cfg, seed, dev)
    test_ds = get_dataset(cfg.replace(seq_len=EXPERT_STEPS + 2), mode="test")
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    per_step, mean = inference.test_generate(model, test_ds, batch_size=4,
                                             pred_steps=EXPERT_STEPS)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    out["moe rollout"] = dict(per_step=[float(x) for x in per_step], mean=mean,
                              mesh=model.mesh.shape,
                              per_rank=_gather(dict(launches=_nonzero(read_launches()),
                                                    seconds=secs), n))
    del model
    torch.cuda.empty_cache()
    out["a_s"] = time.perf_counter() - t_a

    # (b) the flagship streamed on data 2 x model 2
    t_b = time.perf_counter()
    model = inference.build_seeded_model(_flagship_cfg(seed, {"model_axis": 2}), seed, dev)
    test_ds = get_dataset(model.cfg.replace(seq_len=EXPERT_STEPS + 2), mode="test")
    real, calls, kept = da.slab_decode, [], {}

    def slab_decode(*args):
        calls.append(1)
        if len(calls) == model.backbone_cfg.n_layers + 1:  # layer 0 of the first decode
            kept["args"] = [a.clone() if torch.is_tensor(a) else a for a in args]
        return real(*args)

    torch.cuda.synchronize()
    with mock.patch.object(da, "slab_decode", slab_decode):
        # the kernel counts on the module's name: the wrapper while patched
        reset_launches()
        t0 = time.perf_counter()
        per_step, mean = inference.test_generate(model, test_ds, batch_size=2,
                                                 pred_steps=EXPERT_STEPS, streaming=True)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = _nonzero(read_launches())
    # the kept call against its twin, on this rank's heads (after the count)
    args = kept["args"]
    got_k = real(*args)
    want_k = da.slab_decode_ref(*args)
    rel = rel_err(got_k, want_k)
    ms, plain_ms = device_ms(lambda: real(*args)), device_ms(lambda: da.slab_decode_ref(*args))
    q, ck, cv, key_pos, _, li, _ = args  # the bytes of layer li's slabs, the scores' products
    keys = ck.shape[2] * ck.shape[3]
    slab_bound = bound(nbytes(q, ck[li], cv[li], key_pos, got_k),
                       4 * q.shape[0] * q.shape[1] * keys * q.shape[2], "bf16")
    out["streaming"] = dict(
        per_step=[float(x) for x in per_step], mean=mean, mesh=model.mesh.shape,
        heads=model.backbone.parallel.cfg.n_heads,
        per_rank=_gather(dict(launches=launches, seconds=secs, slab_rel=rel, slab_ms=ms,
                              slab_plain_ms=plain_ms, slab_bound=slab_bound,
                              q=tuple(args[0].shape), cache=tuple(args[1].shape)), n))
    del model, kept, args
    torch.cuda.empty_cache()
    out["b_s"] = time.perf_counter() - t_b

    # (c) the daemon over the four ranks
    t_c = time.perf_counter()
    t0 = time.perf_counter()
    eng = srv.load_engine(os.path.join(folder, "flagship_runs"), buckets=(EXPERT_STEPS,),
                          quant="int8", device=str(dev))
    load_s = time.perf_counter() - t0
    coords = eng.model.mesh.coords
    whole = torch.load(os.path.join(folder, "quant_storage.pt"), weights_only=True)
    mine = {k: t for k, t in eng.model.state_dict().items() if k.endswith((".q", ".scale"))}
    storage_ok = mine.keys() == whole.keys() and all(
        torch.equal(t.cpu(), _model_cut(whole[k], t, coords["model"])) for k, t in mine.items())
    del whole
    rollouts, host = [], eng._rollout_host

    def counted(*a, **kw):
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        res = host(*a, **kw)
        torch.cuda.synchronize()
        rollouts.append(dict(launches=_nonzero(read_launches()),
                             seconds=time.perf_counter() - t0))
        return res

    eng._rollout_host = counted
    replies = []
    if rank == 1:  # its third streaming cache (warm-up, request, this) is out of memory
        cache, made = eng._cache, []

        def failing(*a):
            made.append(1)
            if len(made) == 3:
                raise torch.cuda.OutOfMemoryError("the streaming cache did not fit on this "
                                                  "rank's device (chip_smoke phase 24's fault)")
            return cache(*a)

        eng._cache = failing
    if eng.lead:
        httpd = srv.serve(eng, "127.0.0.1", 0)
        server = threading.Thread(target=httpd.serve_forever, daemon=True)
        server.start()
        base = f"http://127.0.0.1:{httpd.server_address[1]}"
        try:
            eng.warmup()
            grid, mask = _client_frames(eng.dataset, 1)
            import urllib.request

            with urllib.request.urlopen(f"{base}/v1/info", timeout=60) as r:
                replies.append((200, json.load(r)))
            for _ in range(3):
                t0 = time.perf_counter()
                code, body = _post_status(base, grid, mask, EXPERT_STEPS)
                replies.append((code, body, time.perf_counter() - t0))
        finally:
            httpd.shutdown()
            httpd.server_close()
            server.join()
            eng.stop()
    else:
        eng.follow()
    per_rank = _gather(dict(rollouts=rollouts, storage_ok=storage_ok, n_storage=len(mine),
                            load_s=load_s, coords=coords,
                            heads=eng.model.backbone.parallel.cfg.n_heads), n)
    out["serve"] = dict(replies=replies, per_rank=per_rank, mesh=eng.model.mesh.shape)
    del eng
    torch.cuda.empty_cache()
    out["c_s"] = time.perf_counter() - t_c

    # (d) the flagship streamed over pipe 2 x model 2
    t_d = time.perf_counter()
    model = inference.build_seeded_model(_pipe_flagship_cfg(seed, PIPE_STREAM_MESH), seed, dev)
    test_ds = get_dataset(model.cfg.replace(seq_len=EXPERT_STEPS + 2), mode="test")
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    per_step, mean = inference.test_generate(model, test_ds, batch_size=2,
                                             pred_steps=EXPERT_STEPS, streaming=True)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    out["pipe streaming"] = dict(
        per_step=[float(x) for x in per_step], mean=mean, mesh=model.mesh.shape,
        heads=model.backbone.parallel.cfg.n_heads,
        per_rank=_gather(dict(launches=_nonzero(read_launches()), seconds=secs,
                              coords=model.mesh.coords,
                              stage=list(model.backbone.parallel.pipe.layers)), n))
    del model
    torch.cuda.empty_cache()
    out["d_s"] = time.perf_counter() - t_d
    return out


def expert_references(dev, seed: int, folder: str) -> dict:
    """Phase 24's one-process references, written for the ranks where they
    read them: one MoE step of each router (loss, balance loss, gradients),
    the EXPERT_STEPS-step MoE rollout of 4 trajectories, the flagship's
    streamed rollout of 2, a flagship checkpoint (``config.yaml`` with model
    2) and the one-process int8 engine on it (its reply to the request, its
    int8 storage)."""
    from fluid_llm_tpu_torch import inference
    from fluid_llm_tpu_torch.data import get_dataset, make_batches
    from fluid_llm_tpu_torch.main import build_model_and_trainer
    from fluid_llm_tpu_torch.tools import serve as srv
    from fluid_llm_tpu_torch.train import checkpoint as ckpt

    out = {}
    for router in ("topk", "expert_choice"):
        cfg = _moe_cfg(seed, None, router)
        ds = get_dataset(cfg.replace(seq_len=cfg.autoreg_seq_len), mode="train")
        trainer = build_model_and_trainer(cfg, ds.ds_props(), dev, pretrained=False)
        batch = next(make_batches(ds, TRAIN_BS, shuffle=True, seed=0, device=dev))
        reset_launches()
        loss, aux = _one_step(trainer, batch, seed)
        out[f"{router}_launches"] = _nonzero(read_launches())
        grads = {n: p.grad.float().cpu() for n, p in trainer.model.named_parameters()
                 if p.grad is not None}
        torch.save({"loss": loss, "aux": aux, "grads": grads},
                   os.path.join(folder, f"ref_moe_{router}.pt"))
        del trainer, grads
        torch.cuda.empty_cache()
    cfg = _moe_cfg(seed, {"expert_axis": 2}).replace(load_dir="synthetic:4")
    model = inference.build_seeded_model(cfg, seed, dev)
    test_ds = get_dataset(cfg.replace(seq_len=EXPERT_STEPS + 2), mode="test")
    steps, out["moe_mean"] = inference.test_generate(model, test_ds, batch_size=4,
                                                     pred_steps=EXPERT_STEPS)
    out["moe_steps"] = [float(x) for x in steps]
    del model
    model = inference.build_seeded_model(_flagship_cfg(seed), seed, dev)
    test_ds = get_dataset(model.cfg.replace(seq_len=EXPERT_STEPS + 2), mode="test")
    steps, out["stream_mean"] = inference.test_generate(model, test_ds, batch_size=2,
                                                        pred_steps=EXPERT_STEPS, streaming=True)
    out["stream_steps"] = [float(x) for x in steps]
    del model
    model = inference.build_seeded_model(_pipe_flagship_cfg(seed), seed, dev)
    steps, out["pipe_mean"] = inference.test_generate(model, test_ds, batch_size=2,
                                                      pred_steps=EXPERT_STEPS, streaming=True)
    out["pipe_steps"] = [float(x) for x in steps]
    del model
    cfg = _flagship_cfg(seed, {"model_axis": 2})
    ds = get_dataset(cfg.replace(seq_len=cfg.autoreg_seq_len), mode="train")
    trainer = build_model_and_trainer(cfg, ds.ds_props(), dev, pretrained=False)
    runs = os.path.join(folder, "flagship_runs")
    ckpt.save_checkpoint(ckpt.make_save_folder(runs), 0, trainer.model, trainer.opt, 0, cfg)
    del trainer
    one = srv.load_engine(runs, buckets=(EXPERT_STEPS,), quant="int8", device=str(dev))
    grid, mask = _client_frames(one.dataset, 1)
    out["serve_want"] = one.predict(grid, mask, EXPERT_STEPS)
    torch.save({k: t.cpu() for k, t in one.model.state_dict().items()
                if k.endswith((".q", ".scale"))}, os.path.join(folder, "quant_storage.pt"))
    del one
    torch.cuda.empty_cache()
    return out


def check_expert(dev, seed: int, folder: str, got: dict, refs: dict, res: dict,
                 failures: list) -> bool:
    """Phase 24's checks of the ranks' results against the one-process
    ``refs``, recorded in ``res``, printed."""
    import numpy as np

    from fluid_llm_tpu_torch.data import get_dataset
    from fluid_llm_tpu_torch.main import build_model_and_trainer
    from fluid_llm_tpu_torch.tools import serve as srv
    from fluid_llm_tpu_torch.train import checkpoint as ckpt

    label = PARALLEL_LABEL
    ok_all = True
    n_layers = 6  # moe_cylinder.yaml's
    for name, par, router in EXPERT_CASES:
        r = got[name]
        ep, m = r["mesh"].get("expert", 1), r["mesh"].get("model", 1)
        loss_rel = abs(r["loss"] - r["ref_loss"]) / abs(r["ref_loss"])
        aux_ok = (r["aux"] == 0.0 and r["ref_aux"] == 0.0) if router == "expert_choice" else \
            abs(r["aux"] - r["ref_aux"]) <= REL_TOL * abs(r["ref_aux"])
        want = dict(flash_attention_fwd=n_layers, flash_attention_dq=n_layers,
                    flash_attention_dkv=n_layers, grid_slot_attention=3,
                    grid_slot_attention_bwd=3)
        counts_ok = all(pr["launches"] == want for pr in r["per_rank"])
        # each rank's banks: its E / expert experts, its model columns or rows
        f = r["mesh"].get("fsdp", 1)
        banks_ok = all(pr["banks"] == {"fc1": (4 // ep, 3072 // m, 768 // f),
                                       "fc2": (4 // ep, 768 // f, 3072 // m)}
                       for pr in r["per_rank"])
        ok = (loss_rel <= REL_TOL and r["grad_rel"] <= GRAD_TOL and aux_ok and counts_ok
              and banks_ok and r["heads"] == 12 // m)
        ok_all &= ok
        res[name] = dict(loss=r["loss"], ref_loss=r["ref_loss"], loss_rel=loss_rel,
                         aux=r["aux"], ref_aux=r["ref_aux"], grad_rel=r["grad_rel"],
                         mesh=r["mesh"], heads=r["heads"], per_rank=r["per_rank"],
                         want_launches=want)
        print(f"[expert axis] (a) {name} {r['mesh']}, {r['heads']} heads and banks "
              f"{r['per_rank'][0]['banks']} a rank: loss {r['loss']:.6f} vs one process "
              f"{r['ref_loss']:.6f} (rel {loss_rel:.3e}, bound {REL_TOL}); moe_aux "
              f"{r['aux']} vs {r['ref_aux']}; trainable gradient rel L2 {r['grad_rel']:.3e} "
              f"(bound {GRAD_TOL}); launches per rank {[pr['launches'] for pr in r['per_rank']]} "
              f"(want {want}); banks per rank {[pr['banks']['fc1'] for pr in r['per_rank']]}; "
              f"set-up s {[round(pr['setup_s'], 2) for pr in r['per_rank']]}, step s "
              f"{[round(pr['seconds'], 3) for pr in r['per_rank']]} ({label}) "
              f"{'ok' if ok else 'FAIL'}")
    # the checkpoint of expert 4, in one process
    cfg = _moe_cfg(seed)
    ds = get_dataset(cfg.replace(seq_len=cfg.autoreg_seq_len), mode="train")
    one = build_model_and_trainer(cfg, ds.ds_props(), dev, pretrained=False)
    ckpt.restore_checkpoint(os.path.join(folder, "moe_runs"), 0, one.model, one.opt)
    ck_ok = _digest(one.model.state_dict()) == got["expert 4"]["digest"]
    del one
    print(f"[expert axis] (a) checkpoint written on expert 4, restored in one process: "
          f"{len(got['expert 4']['digest'])} tensors bit for bit {'ok' if ck_ok else 'FAIL'}")
    # the MoE rollout
    roll = got["moe rollout"]
    rel = [abs(a - b) / abs(b) for a, b in zip(roll["per_step"][1:], refs["moe_steps"][1:])]
    want_roll = dict(exact_attention=n_layers * EXPERT_STEPS, grid_slot_attention=3 * EXPERT_STEPS)
    roll_ok = rel[0] <= REL_TOL and all(pr["launches"] == want_roll for pr in roll["per_rank"]) \
        and all(math.isfinite(x) for x in roll["per_step"])
    res["moe rollout"] = dict(per_step=roll["per_step"], ref_per_step=refs["moe_steps"], rel=rel,
                              mesh=roll["mesh"], per_rank=roll["per_rank"])
    print(f"[expert axis] (a) MoE rollout on {roll['mesh']}, 4 trajectories x {EXPERT_STEPS} "
          f"steps: mean N-RMSE {roll['mean']:.5f} vs one process {refs['moe_mean']:.5f}; per-step "
          f"rel difference step 1 {rel[0]:.3e} (bound {REL_TOL}), all {max(rel):.3e}; launches "
          f"per rank {[pr['launches'] for pr in roll['per_rank']]} (want {want_roll}); rollout s "
          f"{[round(pr['seconds'], 2) for pr in roll['per_rank']]} ({label}) "
          f"{'ok' if roll_ok else 'FAIL'}")
    # (b) streaming
    st = got["streaming"]
    rel_s = [abs(a - b) / abs(b) for a, b in zip(st["per_step"][1:], refs["stream_steps"][1:])]
    want_s = dict(slab_decode_attention=12 * (EXPERT_STEPS + 1),
                  grid_slot_attention=3 * EXPERT_STEPS)
    st_ok = (rel_s[0] <= REL_TOL and st["heads"] == 6
             and all(pr["launches"] == want_s and pr["slab_rel"] <= REL_TOL
                     for pr in st["per_rank"]))
    res["streaming"] = dict(per_step=st["per_step"], ref_per_step=refs["stream_steps"],
                            rel=rel_s, mesh=st["mesh"], per_rank=st["per_rank"])
    print(f"[expert axis] (b) flagship_llama.yaml streamed on {st['mesh']}, {st['heads']} heads "
          f"a rank, 2 trajectories x {EXPERT_STEPS} steps: mean N-RMSE {st['mean']:.5f} vs one "
          f"process {refs['stream_mean']:.5f}; step 1 rel {rel_s[0]:.3e} (bound {REL_TOL}), all "
          f"{max(rel_s):.3e}; launches per rank {[pr['launches'] for pr in st['per_rank']]} "
          f"(want {want_s}); slab decode at q {st['per_rank'][0]['q']}, cache "
          f"{st['per_rank'][0]['cache']} vs its twin on each rank's inputs: rel "
          f"{[f'{pr['slab_rel']:.2e}' for pr in st['per_rank']]}, "
          f"{[round(pr['slab_ms'], 4) for pr in st['per_rank']]} ms (twin "
          f"{[round(pr['slab_plain_ms'], 4) for pr in st['per_rank']]}, bound "
          f"{st['per_rank'][0]['slab_bound']}); rollout s "
          f"{[round(pr['seconds'], 2) for pr in st['per_rank']]} ({label}) "
          f"{'ok' if st_ok else 'FAIL'}")
    # (c) the daemon
    sv = got["serve"]
    info, first, failed, again = sv["replies"]
    pred = lambda body: srv._unb64(body["states"], body["shape"], "float32")
    served_ok = first[0] == 200 and again[0] == 200 and failed[0] == 500
    rel_c = None
    if served_ok:
        want = refs["serve_want"]
        rel_c = float(np.linalg.norm(pred(first[1]) - want) / np.linalg.norm(want))
        served_ok = rel_c <= REL_TOL and np.array_equal(pred(again[1]), pred(first[1]))
    lead = sv["per_rank"][0]["rollouts"]
    want_c = dict(quant_matmul_w8a16=7 * 12 * (EXPERT_STEPS + 1),
                  slab_decode_attention=12 * (EXPERT_STEPS + 1),
                  grid_slot_attention=3 * EXPERT_STEPS)
    # warm-up, the request, the next one (the failed batch ran no rollout)
    counts_ok = all(len(pr["rollouts"]) == 3 and all(x["launches"] == want_c
                                                     for x in pr["rollouts"])
                    for pr in sv["per_rank"])
    storage_ok = all(pr["storage_ok"] for pr in sv["per_rank"])
    info_ok = info[1].get("mesh") == sv["mesh"] and info[1].get("ranks") == PARALLEL_RANKS
    serve_ok = served_ok and counts_ok and storage_ok and info_ok
    res["serve"] = dict(codes=[first[0], failed[0], again[0]], rel=rel_c,
                        error=failed[1].get("error"), per_rank=sv["per_rank"],
                        wall_s=[first[2], failed[2], again[2]], want_launches=want_c,
                        info=info[1])
    print(f"[expert axis] (c) tools.serve --quant int8 over {PARALLEL_RANKS} ranks on "
          f"{sv['mesh']}, {sv['per_rank'][0]['heads']} heads a rank: /v1/info mesh "
          f"{info[1].get('mesh')}; replies {first[0]}, {failed[0]} ({failed[1].get('error')}), "
          f"{again[0]}; the {EXPERT_STEPS}-step reply vs the one-process int8 engine rel "
          f"{rel_c} (bound {REL_TOL}), the third equal to the first "
          f"{served_ok}; int8 storage of every rank equal to its cut of the one-process "
          f"quantization: {storage_ok} ({sv['per_rank'][0]['n_storage']} tensors a rank); "
          f"launches of the request's rollout per rank "
          f"{[(pr['rollouts'][1:2] or [{}])[0].get('launches') for pr in sv['per_rank']]} "
          f"(want {want_c}); request wall s {[round(x[2], 2) for x in (first, failed, again)]}, "
          f"rollout s on rank 0 {[round(x['seconds'], 2) for x in lead]}, load s "
          f"{[round(pr['load_s'], 1) for pr in sv['per_rank']]} ({label}) "
          f"{'ok' if serve_ok else 'FAIL'}")
    # (d) streaming over pipeline stages
    pp = got["pipe streaming"]
    rel_d = [abs(a - b) / abs(b) for a, b in zip(pp["per_step"][1:], refs["pipe_steps"][1:])]
    want_d = dict(slab_decode_attention=6 * (EXPERT_STEPS + 1),
                  grid_slot_attention=3 * EXPERT_STEPS)
    stages_ok = all(pr["stage"] == [6 * pr["coords"]["pipe"] + i for i in range(6)]
                    for pr in pp["per_rank"])
    pipe_ok = (rel_d[0] <= REL_TOL and pp["heads"] == 6 and stages_ok
               and pp["mesh"] == {"data": 1, "fsdp": 1, "model": 2, "pipe": 2}
               and all(pr["launches"] == want_d for pr in pp["per_rank"])
               and all(math.isfinite(x) for x in pp["per_step"]))
    res["pipe streaming"] = dict(per_step=pp["per_step"], ref_per_step=refs["pipe_steps"],
                                 rel=rel_d, mesh=pp["mesh"], per_rank=pp["per_rank"])
    print(f"[expert axis] (d) flagship_llama.yaml (full fine-tune) streamed on {pp['mesh']}, "
          f"{pp['heads']} heads a rank, stages {[pr['stage'][0] for pr in pp['per_rank']]}.. "
          f"(6 blocks each), 2 trajectories x {EXPERT_STEPS} steps: mean N-RMSE "
          f"{pp['mean']:.5f} vs one process {refs['pipe_mean']:.5f}; step 1 rel {rel_d[0]:.3e} "
          f"(bound {REL_TOL}), all {max(rel_d):.3e}; launches per rank "
          f"{[pr['launches'] for pr in pp['per_rank']]} (want {want_d}); rollout s "
          f"{[round(pr['seconds'], 2) for pr in pp['per_rank']]} ({label}) "
          f"{'ok' if pipe_ok else 'FAIL'}")
    if not (ok_all and ck_ok and roll_ok and st_ok and serve_ok and pipe_ok):
        failures.append(f"expert axis: steps {ok_all}, checkpoint {ck_ok}, MoE rollout "
                        f"{roll_ok}, streaming {st_ok}, serve {serve_ok}, pipe streaming "
                        f"{pipe_ok}")
    return ok_all and ck_ok and roll_ok and st_ok and serve_ok and pipe_ok


TOOL_STEPS = 25  # BENCH_ROLLOUT_STEPS of phase 25's rollout profiles
CUBIC_TOL = 1e-5  # f32 device gather + 9-term FMA against the f64 host evaluation, relative
RESAMPLE_FRAMES = 10  # the window of phase 25's resample_sequence check
RESAMPLE_TOL = 1e-6  # f32 device gather + 3-term sum against the f64 host resample, relative
FLASH_BENCH_LENGTHS = (661, 1536, 4096, 8192)
WATCHDOG_WAIT_S = 600  # phase 25's wait for the watchdog run begun before phase 23
WATCHDOG_WRAPPER = """#!{python}
# python with these arguments; on the first launch the child is killed
# (SIGKILL) once a checkpoint of the run is on disk
import glob, os, signal, subprocess, sys, time
log, runs = {log!r}, {runs!r}
first = not os.path.exists(log)
with open(log, "a") as f:
    f.write(" ".join(sys.argv[1:]) + "\\n")
child = subprocess.Popen([{python!r}] + sys.argv[1:])
while first and child.poll() is None:
    done = glob.glob(os.path.join(runs, "*", "step_*.epoch"))
    if done:
        child.send_signal(signal.SIGKILL)
        child.wait()
        with open(log, "a") as f:
            f.write("killed after " + os.path.basename(done[0]) + "\\n")
        sys.exit(137)
    time.sleep(0.01)
sys.exit(child.wait() if not first else 3)  # 3: the first child ended unkilled
"""


def _host_ms(fn, n: int = 3) -> float:
    """The least host wall time of ``n`` calls of ``fn``, ms."""
    best = math.inf
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    return best * 1e3


def start_watchdog(dev, seed: int, tmp: str) -> dict:
    """Phase 25's watchdog run, started in a thread before phase 23 so that
    its three processes (the supervisor's two children and their imports,
    most of its time) run beside phases 23-24, whose ranks' times are not
    performance numbers: ``tools/watchdog.supervise`` over
    ``training1.yaml`` for 2 epochs on ``synthetic:2`` (batch 2, a 3-step
    validation), its ``python`` WATCHDOG_WRAPPER, which kills the first
    child once the first checkpoint is on disk.  Returns the job that
    :func:`phase_tools` waits for."""
    from fluid_llm_tpu_torch.config import Config
    from fluid_llm_tpu_torch.tools import watchdog

    wd = os.path.join(tmp, "watchdog")
    os.makedirs(wd)
    runs, log = os.path.join(wd, "runs"), os.path.join(wd, "launches.txt")
    cfg_path = os.path.join(wd, "training.yaml")
    Config.from_yaml(CONFIG).replace(
        load_dir="synthetic:2", batch_size=2, val_seq_len=4, seed=seed, num_epochs=2,
        save_model_each=1, num_workers=0, checkpoint_save_path=runs).to_yaml(cfg_path)
    wrapper = os.path.join(wd, "python")
    with open(wrapper, "w") as f:
        f.write(WATCHDOG_WRAPPER.format(python=sys.executable, log=log, runs=runs))
    os.chmod(wrapper, 0o755)
    repo = os.path.dirname(os.path.abspath(__file__))
    env = {"PYTHONPATH": os.pathsep.join([repo, os.environ.get("PYTHONPATH", "")])}
    job = dict(runs=runs, log=log, t0=time.perf_counter())

    def run():
        try:
            job["rc"] = watchdog.supervise(cfg_path, runs, max_restarts=2, backoff_s=0,
                                           extra_env=env, python=wrapper, device=str(dev))
        except BaseException as e:  # noqa: BLE001 -- raised again where phase 25 waits
            job["error"] = e
        job["seconds"] = time.perf_counter() - job["t0"]

    job["thread"] = threading.Thread(target=run, daemon=True)
    job["thread"].start()
    return job


def resample_checks(dev, seed: int, pos, faces, mi, tmp: str, smi: str) -> tuple[dict, dict]:
    """Phase 25's whole-window resample and figure checks on the mesh ``mi``
    (a MeshInterp of ``pos``, ``faces``): ``core/interp.resample_sequence``
    on the card over a RESAMPLE_FRAMES-frame window of the analytic flow's 3
    channels within RESAMPLE_TOL of the f64 numpy resample on the host
    (masked pixels 0), timed; ``to_grid`` on one frame: its mask
    ``mi.mask``, its data that frame bit for bit; ``tools/plotting.plot_field``
    without matplotlib (the card's machine has none) raising ImportError and
    writing no file, or with it writing its figure.  Returns (results, ok)."""
    import importlib.util

    import numpy as np

    from fluid_llm_tpu_torch.core import interp
    from fluid_llm_tpu_torch.data.synthetic import analytic_flow
    from fluid_llm_tpu_torch.tools import plotting

    res, ok = {}, {}
    states = analytic_flow(pos, RESAMPLE_FRAMES, seed)  # (T, 3, N)
    tables = [torch.as_tensor(a, device=dev) for a in (mi.vert_idx, mi.weights, mi.mask)]
    vals = torch.as_tensor(states, device=dev)
    got = interp.resample_sequence(vals, *tables)
    host = np.einsum("tchwk,hwk->tchw", states.astype(np.float64)[..., mi.vert_idx],
                     mi.weights.astype(np.float64))
    want = np.where(mi.mask, 0.0, host)
    got_np = got.cpu().numpy()
    err = float(np.abs(got_np - want).max() / np.abs(want).max())
    ms = device_ms(lambda: interp.resample_sequence(vals, *tables))
    ok["resample_sequence"] = (got_np.shape == want.shape and got_np.dtype == np.float32
                               and err <= RESAMPLE_TOL and bool((got_np[..., mi.mask] == 0).all()))
    res["resample_sequence"] = dict(rel_max_err=err, ms=ms, shape=list(got_np.shape), card=smi)
    print(f"[tools] resample_sequence on the card, {RESAMPLE_FRAMES} frames x 3 channels of "
          f"{len(pos)} nodes -> {got_np.shape[-2]} x {got_np.shape[-1]}: max |err| / max |host "
          f"f64| {err:.2e} (bound {RESAMPLE_TOL}), masked pixels 0; {ms:.4f} ms a call (device; "
          f"{smi}) {'ok' if ok['resample_sequence'] else 'FAIL'}")
    t = RESAMPLE_FRAMES // 2
    data, mask = interp.to_grid(vals[t], mi)
    ok["to_grid"] = bool(np.array_equal(mask, mi.mask) and data.device == vals.device
                         and torch.equal(data, got[t]))
    res["to_grid"] = dict(frame=t, equal=ok["to_grid"])
    print(f"[tools] to_grid on frame {t} on the card: mask equal to the MeshInterp's, data equal "
          f"bit for bit to that frame of resample_sequence {'ok' if ok['to_grid'] else 'FAIL'}")
    out = os.path.join(tmp, "field.png")
    has_mpl = importlib.util.find_spec("matplotlib") is not None
    try:
        plotting.plot_field(got_np[t, 0], out)
        raised = None
    except ImportError as e:
        raised = str(e)
    written = os.path.exists(out)
    ok["plot_field"] = (written and raised is None) if has_mpl else (raised is not None
                                                                     and not written)
    res["plot_field"] = dict(matplotlib=has_mpl, raised=raised, written=written)
    print(f"[tools] plot_field with matplotlib {'present' if has_mpl else 'missing'}: "
          f"{'raised ImportError (' + raised + ')' if raised else 'no ImportError'}, "
          f"figure {'written' if written else 'not written'} "
          f"{'ok' if ok['plot_field'] else 'FAIL'}")
    return res, ok


def phase_tools(dev, seed: int, failures: list, pickles: str, tmp: str, job: dict) -> dict:
    """Phase 25, the tools and core modules: the native locator against the
    NumPy one, the cubic resample on the card against its f64 host
    evaluation, :func:`resample_checks`, ``rollout_profile`` trace / trace_stream over
    TOOL_STEPS steps, ``train_profile``, ``flash_bench`` against the twin at
    FLASH_BENCH_LENGTHS (agreement held), the watchdog run ``job``
    (:func:`start_watchdog`) waited for and checked, ``ds_stats`` on phase
    17's cylinder pickles (``pickles``)."""
    import pickle

    import numpy as np

    from fluid_llm_tpu_torch.core import _native, cubic
    from fluid_llm_tpu_torch.core import triangulation as tri
    from fluid_llm_tpu_torch.data.synthetic import analytic_flow, make_cylinder_mesh
    from fluid_llm_tpu_torch.tools import ds_stats, flash_bench, profiling, rollout_profile
    from fluid_llm_tpu_torch.tools import train_profile
    from fluid_llm_tpu_torch.train import checkpoint as ckpt

    res, ok = {}, {}
    parts = {}
    # the native locator on the synthetic cylinder mesh at 238
    t0 = time.perf_counter()
    pos, faces = make_cylinder_mesh(seed, 40, 16)  # SyntheticCylinderDataset's mesh
    interp = tri.get_mesh_interpolation(pos, faces, 238)
    gx, gy = interp.grid_x, interp.grid_y
    t_b = time.perf_counter()
    _native.build()
    build_s = time.perf_counter() - t_b
    native = _native.locate(pos, faces, gx, gy)
    plain = tri._locate_numpy(pos, faces, gx, gy)
    numpy_ms = _host_ms(lambda: tri._locate_numpy(pos, faces, gx, gy))
    native_ms = _host_ms(lambda: _native.locate(pos, faces, gx, gy))
    one_ms = _host_ms(lambda: _native.locate(pos, faces, gx, gy, n_threads=1))
    os.environ["FLUID_LLM_TPU_NATIVE_LOCATOR"] = "1"
    try:
        switched = tri.get_mesh_interpolation(pos, faces, 238)
    finally:
        del os.environ["FLUID_LLM_TPU_NATIVE_LOCATOR"]
    ok["locator"] = bool(np.array_equal(native, plain) and np.array_equal(
        switched.tri_index, interp.tri_index) and np.array_equal(switched.weights, interp.weights))
    res["locator"] = dict(grid=list(gx.shape), triangles=len(faces), nodes=len(pos),
                          numpy_ms=numpy_ms, native_ms=native_ms, native_1thread_ms=one_ms,
                          threads=os.cpu_count(), build_s=build_s,
                          outside=int((native < 0).sum()))
    print(f"[tools] native locator ({_native.compiler()} {' '.join(_native.CXXFLAGS)}, built in "
          f"{build_s:.1f} s) on the synthetic cylinder mesh ({len(pos)} nodes, {len(faces)} "
          f"triangles) at 238 ({gx.shape[0]} x {gx.shape[1]} pixels): equal to the NumPy locator "
          f"{np.array_equal(native, plain)}, FLUID_LLM_TPU_NATIVE_LOCATOR=1 MeshInterp equal; "
          f"host ms (least of 3): NumPy {numpy_ms:.2f}, native {native_ms:.3f} on "
          f"{os.cpu_count()} threads, {one_ms:.3f} on one {'ok' if ok['locator'] else 'FAIL'}")
    # the cubic resample on the card against the f64 host evaluation
    states = analytic_flow(pos, 2, seed)  # (2, 3, N)
    cm = cubic.get_cubic_mesh_interpolation(pos, faces, gx, gy)
    grads = [cubic.estimate_gradients(pos, faces, states[t, c], "min_E")
             for t in range(2) for c in range(3)]
    nodal = [torch.tensor(np.stack(a).reshape(2, 3, -1), dtype=torch.float32, device=dev)
             for a in (states.reshape(6, -1), [g[0] for g in grads], [g[1] for g in grads])]
    tables = (cm.vert_idx, cm.wf, cm.wgx, cm.wgy, cm.mask)
    got = cubic.resample_to_grid_cubic(*nodal, *tables).cpu().numpy()
    want = np.stack([cubic._host_cubic_eval(cm, states[t, c].astype(np.float64), *grads[3 * t + c])
                     for t in range(2) for c in range(3)]).reshape(got.shape)
    cubic_err = float(np.abs(got - want).max() / np.abs(want).max())
    gpu_tables = [torch.as_tensor(t, device=dev) for t in tables]
    cubic_ms = device_ms(lambda: cubic.resample_to_grid_cubic(*nodal, *gpu_tables))
    ok["cubic"] = cubic_err <= CUBIC_TOL and bool((got[..., cm.mask] == 0).all())
    res["cubic"] = dict(rel_max_err=cubic_err, ms=cubic_ms, shape=list(got.shape))
    print(f"[tools] cubic resample (min_E gradients) on the card, 2 frames x 3 channels "
          f"-> {got.shape[-2]} x {got.shape[-1]}: max |err| / max |host f64| {cubic_err:.2e} "
          f"(bound {CUBIC_TOL}), masked pixels 0; {cubic_ms:.4f} ms a call (device) "
          f"{'ok' if ok['cubic'] else 'FAIL'}")
    parts["native and cubic"] = time.perf_counter() - t0

    # the whole-window resample, to_grid and a figure helper
    t0 = time.perf_counter()
    smi = run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"]).strip()
    more, more_ok = resample_checks(dev, seed, pos, faces, interp, tmp, smi)
    res.update(more)
    ok.update(more_ok)
    parts["resample and figures"] = time.perf_counter() - t0

    # rollout traces
    t0 = time.perf_counter()
    for name, streaming in (("trace", False), ("trace_stream", True)):
        reset_launches()
        summary = rollout_profile.trace(dev, streaming=streaming, steps=TOOL_STEPS)
        launches = _nonzero(read_launches())
        kern = "slab_decode_attention" if streaming else "exact_attention"
        ok[name] = summary is not None and summary["_total"] > 0 and launches.get(kern, 0) > 0
        res[name] = dict(summary=summary, launches=launches)
        print(f"[tools] rollout_profile {name}: device busy "
              f"{(summary or {}).get('_total', 0.0) / TOOL_STEPS:.3f} ms/step over the traced "
              f"rollout; launches of the tool's rollouts {launches} "
              f"{'ok' if ok[name] else 'FAIL'}")
    parts["rollout profile"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    trace_dir = os.path.join(tmp, "train_trace")
    reset_launches()
    losses = train_profile.run_trace(trace_dir, dev)
    launches = _nonzero(read_launches())
    summary = profiling.summarize_trace(trace_dir, divisor=train_profile.TRACED_STEPS, top=40)
    ok["train_profile"] = summary is not None and all(math.isfinite(x) for x in losses) and \
        launches.get("flash_attention_dq", 0) == 12 * (1 + train_profile.TRACED_STEPS)
    res["train_profile"] = dict(summary=summary, losses=losses, launches=launches)
    print(f"[tools] train_profile: losses {[round(x, 5) for x in losses]}, device busy "
          f"{(summary or {}).get('_total', 0.0) / train_profile.TRACED_STEPS:.3f} ms a traced "
          f"step; launches {launches} {'ok' if ok['train_profile'] else 'FAIL'}")
    parts["train profile"] = time.perf_counter() - t0

    # flash_bench: the kernels against the twin up to 8192 tokens
    t0 = time.perf_counter()
    rows = [flash_bench.bench_length(1, L, dev) for L in FLASH_BENCH_LENGTHS]
    ok["flash_bench"] = all(r["rel_out"] <= REL_TOL and r["lse_err"] <= LSE_TOL
                            and r["rel_grad"] <= REL_TOL for r in rows)
    res["flash_bench"] = dict(rows=rows, card=smi)
    print(f"[tools] flash_bench bs 1, H 12 x 64, bf16, valid L - 13, ms (CUDA events, mean of "
          f"10 after a warm call; {smi}): " + "; ".join(
              f"L {r['L']}: plain fwd {r['plain_fwd']:.4f}, flash fwd {r['flash_fwd']:.4f}, "
              f"plain f+b {r['plain_fb']:.4f}, flash f+b {r['flash_fb']:.4f} (rel out "
              f"{r['rel_out']:.2e}, lse {r['lse_err']:.1e}, rel grad {r['rel_grad']:.2e})"
              for r in rows) + f" {'ok' if ok['flash_bench'] else 'FAIL'}")
    parts["flash bench"] = time.perf_counter() - t0

    # the watchdog over a killed first child, started before phase 23
    t0 = time.perf_counter()
    job["thread"].join(WATCHDOG_WAIT_S)
    if job["thread"].is_alive():
        raise RuntimeError(f"the watchdog run did not end within {WATCHDOG_WAIT_S} s of phase 25")
    if "error" in job:
        raise job["error"]
    rc, runs = job["rc"], job["runs"]
    with open(job["log"]) as f:
        lines = f.read().splitlines()
    last = ckpt.latest_step(ckpt.get_save_folder(runs, -1))
    ok["watchdog"] = (rc == 0 and len(lines) == 3 and lines[1] == "killed after step_0.epoch"
                      and "fluid_llm_tpu_torch.main" in lines[0]
                      and "fluid_llm_tpu_torch.continue_train" in lines[2] and last == 1)
    res["watchdog"] = dict(rc=rc, launches=lines, last_step=last, seconds=job["seconds"])
    print(f"[tools] watchdog over training1.yaml (2 epochs on synthetic:2, batch 2), started "
          f"before phase 23 and run beside phases 23-24: rc {rc}, launches {lines}, newest "
          f"checkpoint step_{last}, {job['seconds']:.1f} s from its start "
          f"{'ok' if ok['watchdog'] else 'FAIL'}")
    parts["watchdog (the wait)"] = time.perf_counter() - t0

    # ds_stats on phase 17's cylinder pickles, against numpy over the raw fields
    t0 = time.perf_counter()
    train_dir = os.path.join(pickles, "cylinder_dataset", "train")
    stats = ds_stats.main(["--load_dir", train_dir, "--resolution", "238"])
    fields = []
    for name in sorted(os.listdir(train_dir)):
        with open(os.path.join(train_dir, name), "rb") as f:
            d = pickle.load(f)
        fields.append(np.concatenate([d["velocity"], d["pressure"]], -1).astype(np.float64))
    worst = 0.0  # each statistic's difference over its channel's std
    for c in range(3):
        vals = np.concatenate([x[..., c].ravel() for x in fields])
        diffs = np.concatenate([np.diff(x[..., c], axis=0).ravel() for x in fields])
        for kind, ref in (("state", vals), ("diff", diffs)):
            for k, v in (("mean", ref.mean()), ("std", ref.std())):
                worst = max(worst, abs(stats[c][f"{kind}_{k}"] - v) / ref.std())
    ok["ds_stats"] = worst <= 1e-9
    res["ds_stats"] = dict(stats=stats, rel_err=worst, trajectories=len(fields))
    print(f"[tools] ds_stats on {len(fields)} cylinder pickles: means and stds against numpy "
          f"over the raw fields, the largest difference {worst:.1e} of its channel's std (bound "
          f"1e-9) {'ok' if ok['ds_stats'] else 'FAIL'}")
    parts["ds_stats"] = time.perf_counter() - t0
    res.update(ok=ok, parts_s=parts)
    print(f"[tools] part seconds {json.dumps({k: round(v, 1) for k, v in parts.items()})}")
    bad = [k for k, v in ok.items() if not v]
    if bad:
        failures.append(f"tools: {bad}")
    return res


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seed", type=int, default=1234)
    parser.add_argument("--out", default=None,
                        help="also write every measurement of the run to this JSON file")
    parser.add_argument("--parallel-rank", type=int, default=None, help=argparse.SUPPRESS)
    parser.add_argument("--parallel-dir", default=None, help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; nothing runs on the CPU", file=sys.stderr)
        return 1
    if args.parallel_rank is not None:  # one rank of phase 23 (b), started by the phase
        parallel_rank(args.parallel_rank, args.parallel_dir)
        return 0
    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False  # f32 matmuls in full f32
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    failures: list[str] = []
    # the phases before 22 train and serve the seeded draw: no backbone the
    # host has cached is imported (phase 22 points ``main`` at its own cache)
    no_cache = tempfile.TemporaryDirectory()
    os.environ["HF_HUB_CACHE"] = no_cache.name

    seconds: dict[str, float] = {}  # every phase's, by name

    def phase(name: str, fn, *a, **kw):
        """``fn``'s result, or None after recording its exception as a
        failure of the phase (the run goes on, and exits 1); its seconds
        kept and printed."""
        t0 = time.perf_counter()
        try:
            return fn(*a, **kw)
        except Exception as e:  # noqa: BLE001 -- each phase reports, the run goes on
            traceback.print_exc()
            failures.append(f"phase {name} raised {type(e).__name__}: {e}")
            print(f"[{name}] FAIL: raised {type(e).__name__}: {e}")
            return None
        finally:
            seconds[name] = time.perf_counter() - t0
            print(f"[{name}] phase seconds {seconds[name]:.1f}")

    device = phase("device", phase_device)
    build_s = phase("build", phase_build)
    rows = phase("kernels", phase_kernels, dev, failures) or []
    plans = phase("plans", phase_plans, dev, failures)
    slice_res = phase("slice", phase_rollout, dev, args.seed, failures, streaming=False,
                      turns=(True, False))
    trained = phase("train", phase_train, dev, args.seed, failures)
    train_res = train_agree = None
    if trained is not None:
        trainer, train_batch, train_res = trained
        train_agree = phase("train agreement", phase_train_agreement, trainer, train_batch,
                            args.seed, failures)
        del trainer, train_batch, trained
    with tempfile.TemporaryDirectory() as tmp:  # phases 8-13: checkpoints, served again
        opt_dir, flagship_dir = os.path.join(tmp, "training1"), os.path.join(tmp, "flagship")
        entry_res = phase("entry points", phase_entry_points, dev, args.seed, failures, opt_dir)
        stream_res = phase("streaming", phase_rollout, dev, args.seed, failures, streaming=True,
                           turns=(True, False))
        flagship_res = phase("flagship entry points", phase_flagship_entry_points, dev,
                             args.seed, failures, flagship_dir)
        serve_res = phase("serve", phase_serve, dev, failures, os.path.join(flagship_dir, "runs"))
        serve_exact_res = phase("serve exact", phase_serve_exact, dev, failures,
                                os.path.join(opt_dir, "runs"))
        graph_res = phase("graph baselines", phase_graph_baselines, dev, args.seed, failures,
                          tmp)
    stacked_res = phase("stacked streaming", phase_rollout, dev, args.seed, failures,
                        streaming=True, stacked=True, tag="stacked streaming",
                        turns=(True, False))
    short_train = short_agree = None
    trained = phase("short train", phase_train, dev, args.seed, failures, attn_impl="short",
                    per_turn=2)
    if trained is not None:
        trainer, train_batch, short_train = trained
        short_agree = phase("short train agreement", phase_train_agreement, trainer, train_batch,
                            args.seed, failures, "short train agreement")
        del trainer, train_batch, trained
    short_res = phase("short rollout", phase_rollout, dev, args.seed, failures, streaming=False,
                      stacked=True, attn_impl="short", tag="short rollout", turns=(True, False))
    pickles = tempfile.TemporaryDirectory()  # phases 17-18 and 25: the pickles
    published_res = phase("published data", phase_published_data, dev, args.seed, failures,
                          pickles.name)
    notf_res = phase("notf train", phase_notf, dev, args.seed, failures, pickles.name, 2)
    switch_res = phase("switches", phase_switches, dev, args.seed, failures)
    with tempfile.TemporaryDirectory() as tmp:  # phase 20: checkpoints, read again
        graph2_res = phase("graph baselines II", phase_graph_baselines_2, dev, args.seed,
                           failures, tmp)
    t0 = time.perf_counter()
    moe_res = {}
    with tempfile.TemporaryDirectory() as tmp:  # phase 21: the MoE checkpoint, served again
        for key, name, fn in (("rollout", "moe rollout", phase_moe_rollout),
                              ("train", "moe train", phase_moe_train),
                              ("streaming", "moe streaming", phase_moe_streaming),
                              ("serve", "moe serve", phase_moe_serve),
                              ("quant_train", "quant train", phase_quant_train),
                              ("stacked_int8", "stacked int8", phase_stacked_int8)):
            moe_res[key] = phase(name, fn, dev, args.seed, failures, tmp)
    seconds["moe and quantized backbones"] = time.perf_counter() - t0
    print(f"[moe and quantized backbones] phase seconds "
          f"{seconds['moe and quantized backbones']:.1f}")
    with tempfile.TemporaryDirectory() as tmp:  # phase 22: the HF cache, runs, a reference .pt
        weights_res = phase("weights in and out", phase_weights, dev, args.seed, failures, tmp)
    watchdog_tmp = tempfile.TemporaryDirectory()  # phase 25's watchdog run, begun here
    job = phase("watchdog start", start_watchdog, dev, args.seed, watchdog_tmp.name)
    with tempfile.TemporaryDirectory() as tmp:  # phases 23-24: YAML, references, ranks' files
        parallel_res = phase("parallel axes", phase_parallel, dev, args.seed, failures, tmp)
    if parallel_res is not None:  # phase 24 ran inside phase 23's ranks: its own seconds
        seconds["expert axis and sharded serving"] = parallel_res["expert"]["phase_s"]
        seconds["parallel axes"] -= parallel_res["expert"]["phase_s"]
    with tempfile.TemporaryDirectory() as tmp:  # phase 25: traces
        tools_res = None if job is None else phase(
            "tools and core", phase_tools, dev, args.seed, failures, pickles.name, tmp, job)
    pickles.cleanup()
    watchdog_tmp.cleanup()
    seconds["total"] = time.perf_counter() - t_start
    print(f"[chip_smoke] phase seconds {json.dumps({k: round(v, 1) for k, v in seconds.items()})}")

    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(dict(device=device, build_s=build_s, kernel_checks=rows, plans=plans,
                           slice=slice_res, train=train_res,
                           train_agreement=train_agree, entry_points=entry_res,
                           streaming=stream_res, flagship_entry_points=flagship_res,
                           serve=serve_res, serve_exact=serve_exact_res,
                           graph_baselines=graph_res, stacked_streaming=stacked_res,
                           short_train=short_train, short_train_agreement=short_agree,
                           short_rollout=short_res, published_data=published_res,
                           notf=notf_res, switches=switch_res, graph_baselines_2=graph2_res,
                           moe_and_quantized=moe_res, weights=weights_res,
                           parallel=parallel_res, tools=tools_res, phase_seconds=seconds,
                           failures=failures),
                      f, indent=1, default=str)
    if failures:
        for failure in failures:
            print(f"chip_smoke FAILED: {failure}")
        print("chip_smoke FAILED: " + "; ".join(failures), file=sys.stderr)
        return 1

    # (source, TPU kernel it replaces, the main path whose run counts it)
    sources = {
        "exact_attention": ("fluid_llm_tpu_torch/csrc/exact_attention.cu",
                            "fluid_llm_tpu/ops/exact_attention.py:52", slice_res),
        "grid_slot_attention": ("fluid_llm_tpu_torch/csrc/grid_slot_attention.cu",
                                "fluid_llm_tpu/ops/grid_gnn_pallas.py:122", slice_res),
        "grid_slot_attention_bwd": ("fluid_llm_tpu_torch/csrc/grid_slot_attention.cu",
                                    "fluid_llm_tpu/ops/grid_gnn_pallas.py:161", train_res),
        "flash_attention_fwd": ("fluid_llm_tpu_torch/csrc/exact_attention.cu",
                                "fluid_llm_tpu/ops/flash_attention.py:55", train_res),
        "flash_attention_dq": ("fluid_llm_tpu_torch/csrc/flash_attention.cu",
                               "fluid_llm_tpu/ops/flash_attention.py:190", train_res),
        "flash_attention_dkv": ("fluid_llm_tpu_torch/csrc/flash_attention.cu",
                                "fluid_llm_tpu/ops/flash_attention.py:230", train_res),
        "slab_decode_attention": ("fluid_llm_tpu_torch/csrc/decode_attention.cu",
                                  "fluid_llm_tpu/ops/decode_attention.py:50", stream_res),
        "quant_matmul_w8a8": ("fluid_llm_tpu_torch/csrc/quant_matmul.cu",
                              "fluid_llm_tpu/ops/quant_matmul.py:113", serve_res),
        "quant_matmul_w8a16": ("fluid_llm_tpu_torch/csrc/quant_matmul.cu",
                               "fluid_llm_tpu/ops/quant_matmul.py:91", serve_exact_res),
        "segment_sum": ("fluid_llm_tpu_torch/csrc/segment_ops.cu",
                        "fluid_llm_tpu/ops/segment_sum_pallas.py:123", graph_res),
        "segment_gather": ("fluid_llm_tpu_torch/csrc/segment_ops.cu",
                           "fluid_llm_tpu/ops/segment_sum_pallas.py:142", graph_res),
        "segment_sum_bf16": ("fluid_llm_tpu_torch/csrc/segment_ops.cu",
                             "fluid_llm_tpu/ops/segment_sum_pallas.py:123",
                             {"launches": graph2_res["bf16_launches"]}),
        "segment_gather_bf16": ("fluid_llm_tpu_torch/csrc/segment_ops.cu",
                                "fluid_llm_tpu/ops/segment_sum_pallas.py:142",
                                {"launches": graph2_res["bf16_launches"]}),
        "indexed_linear": ("fluid_llm_tpu_torch/csrc/indexed_linear.cu",
                           "fluid_llm_tpu/ops/indexed_linear.py:35", stacked_res),
        "short_attention": ("fluid_llm_tpu_torch/csrc/short_attention.cu",
                            "fluid_llm_tpu/ops/short_attention.py:38", short_res),
    }
    kernels = []
    for name, (source, replaces, path_res) in sources.items():
        main_rows = [r for r in rows if r["kernel"] == name and r["main_path"]]
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=path_res["launches"][name],
            max_abs_err=max(r["max_abs_err"] for r in main_rows),
            ms=main_rows[0]["ms"], plain_ms=main_rows[0]["plain_ms"],
            bound_ms=main_rows[0]["bound_ms"], bound_by=main_rows[0]["bound_by"],
            library_ms=main_rows[0]["library_ms"],
        ))
    print(json.dumps({"kernels": kernels}))
    print(device["smi"])
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": device["name"],
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
