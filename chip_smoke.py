#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. the card: ``nvidia-smi`` name and power limit, torch's device name;
  2. build the CUDA kernels from ``src/repro_torch/kernels/csrc`` (time,
     and nvcc's register / spill summary);
  3. every kernel against its plain PyTorch version at the shapes the
     training paths give it and at ragged ones (flash: also GQA, a
     sliding window and GPT-3 2.7B's head dim 80; SSD: hymba's heads at
     a ragged sequence and the reduced configs' widths), in fp32 and
     bf16, the GEMM in all three operand layouts, and twice on the same
     inputs (bitwise equal); each in every built variant: each flash
     tile (bitwise equal to each other), each SSD chunk, each GEMM tile
     x split, each norm backward row partition (``*`` marks the one the
     autotuner resolves); each SSD entry at the shapes and chunks where
     the wrapper runs it: ssd_wgmma.cu's in bf16 at state 128 and 16,
     chunk 64, ssd.cu's elsewhere (fp32, chunk 32, the reduced configs'
     (16, 16));
  4. each kernel's time at each path's shape (CUDA events, and the
     device time of the kernel's own events under torch.profiler, per
     phase for the SSD kernels), its bound (and, for the GEMM, the flash
     and the SSD kernels, the bound of their 3xTF32 tensor-core design),
     its plain version's time and the one-call library equivalent where
     there is one;
  5. small models with the kernels against the same models on plain
     PyTorch ops (loss and gradients): fused vs unfused epilogues, flash
     vs naive attention (gpt3-medium, and GQA qwen2.5-3b with QKV bias
     at a sequence that is not a multiple of 64), the SSD kernels vs the
     chunked scan (mamba2), and all kernels vs plain ops (hymba, and the
     MoE models granite-moe and qwen2-moe with its shared expert and
     QKV bias); with the kernels inside, remat (full and dots) vs none
     and the chunked CE vs the whole CE; and token-by-token decode vs
     the kernels' full forward (granite-moe, and hymba with a window
     the decode's ring buffer wraps);
  6. the naive-attention path: ``repro_torch.launch.train`` at
     gpt3-medium's full width and depth (24 layers, d 1024, vocab
     50257), sequence 512, 4 steps with a node killed before step 2,
     asserting finite, decreasing losses, zero replica divergence, zero
     program builds across the failure and that every epilogue kernel
     launched;
  7. the flash path: the same at sequence 2048 with ``--attn-impl
     kernel``, asserting the same and that all six kernels launched;
  8. the mamba path: ``--arch mamba2-780m`` at full width and depth (48
     layers, d 1536, SSD heads 48 x 64, state 128, vocab 50280) at
     sequence 2048 with ``--ssd-impl kernel`` and microbatch 1,
     asserting the same and that each SSD kernel (fp32: ssd.cu's)
     launched once per layer and microbatch, the wgmma pair none;
  9. the lifecycle: gpt3-medium as in phase 7 (full width and depth,
     sequence 2048, flash kernels, 5 nodes, f 1, n0 2) on trainer A,
     warmed: a step; a node killed, recovery from the replicas, a step;
     a fresh node joined, a step; a snapshot saved asynchronously to a
     temporary directory while a step runs.  Trainer B restores that
     checkpoint onto the card with the data cursor and runs the same
     step: its loss and its state's content hashes must equal A's
     bitwise.  An eager (1F1B walker) trainer restored from it runs the
     step too, held to A's loss at the fp32 tolerance of
     tests/test_executor.py.  Asserts finite losses, zero divergence
     after every step, no build across fail -> recover -> join -> step,
     and that every fused and flash kernel launched; prints recovery and
     join seconds with the bytes copied, snapshot, save, wait and
     restore seconds with the bytes written, step times and the eager
     step's time and memory.
 10. the MoE path: ``--arch granite-moe-1b-a400m`` at full width and
     depth (24 layers, d 1024, 16 heads / 8 kv of 64, 32 experts of
     d_ff 512 top-8 in dense dispatch, vocab 49155) at sequence 2048,
     microbatch 1, with ``--attn-impl kernel``, 4 steps through a
     failure, asserting what phases 6-8 assert and that each fused and
     flash kernel launched once per layer and microbatch (gemm_bias
     three times: the fused QKV's forward, dx and dW).
 11. serving: qwen3-1.7b at full width (d 2048, 16 query / 8 kv heads
     of 128, vocab 151936), depth cut to 8 of 28 layers, fp32, behind
     ``repro_torch.launch.serve``'s engine (6 nodes, f 1, n0 2), 4 slots
     a replica, 16 requests of 64 prompt and 32 new tokens at
     temperature 0.8, unfailed and with a node killed after 8 ticks;
     asserts every request completes in both legs with bitwise-equal
     streams, no build across fail -> recover -> drain, at least one
     request replayed or migrated, no device->host read in two pure
     decode ticks (sync debug mode "error"), a greedy request's stream
     equal to a plain loop of ``Model.decode_step`` at the same batch,
     and no launch of the nine kernels (decode runs none, as in the
     reference); prints warm seconds, tokens/s, ms/token, TTFT p50/p99,
     recovery downtime, replayed / migrated counts, copy bytes, peak
     memory and the phase's seconds.
 12. multi-process: gpt3-medium as in phase 7 at microbatch 1 (full
     width, depth cut to 6 of 24 blocks, sequence 2048, flash kernels,
     5 nodes, f 1, n0 2).  Leg 1, the single-process trainer: 2 steps,
     a node recovered, 2 steps.  Leg 2, ``MultiHostExecutor`` with 3
     worker processes on the card (rank 1 hosts that node alone): the
     same plan; each step's loss and grad norm bitwise leg 1's; rank 1
     SIGKILLed, its death detected from the coordination channel within
     30 s; the two-phase recovery pulling layer state across processes
     (bytes fetched > 0), to leg 1's instances; 0 builds on the
     survivors, divergence 0, the snapshot's params bitwise leg 1's, and
     the kernels launched by the workers (none by the coordinator), each
     norm and flash kernel once per layer and microbatch.  Prints
     spawn, setup and warm seconds, each step's split into the grads
     phase, the wire and the commit with the bytes each way, kill ->
     detect seconds, the recovery breakdown, each surviving worker's
     peak memory, nvidia-smi's peak memory used and the phase's seconds.
 13. the single-program fast path: ``SPMDExecutor`` trains gpt3-medium
     at full width and depth (fp32, sequence 2048, the global batch 16
     as one program, remat full, the chunked CE at 512, the flash and
     epilogue kernels) on phase 7's weights and corpus.  Asserts: the
     executor's state (params, moments, step) equals the dry-run's
     args for the same model and batch on a 1 x 1 mesh, less the batch,
     within 0.1 %; the first step's loss equals a HeteroTrainer step's on
     the same weights and global batch (tests/test_executor.py's fp32
     tolerance); 4 steps with finite, falling losses, one program, no
     build after bind; each of the six kernels launched exactly as remat
     full derives (``spmd_launches``); a node killed through the
     engine's monitor: ``recover`` raises ExecutorUnsupported, the plan
     still covers every replica, a HeteroTrainer rebinds from the
     snapshot with bitwise params and divergence 0 and runs a warmed
     step with a finite loss and no build.  Prints each step's seconds,
     the peak memory beside the dry-run's predicted peak, the achieved
     TFLOP/s (the dry-run's FLOPs over the step) beside the fp32 peak,
     the rebind seconds and the rebound trainer's step.
 14. the SPMD data plane: ``SPMDExecutor`` over a data 2 x model 2
     ``ProcessMesh`` of 4 fresh rank processes sharing the card (gloo:
     NCCL puts one rank on a card), FSDP with ZeRO-1, on phase 13's
     model, weights, global batch (4 sequences a rank) and optimizer.
     Asserts: each rank's state bytes equal the dry-run's per-card args
     for this mesh less the batch; the first step's loss on every rank
     equals phase 13's first step and the params gathered after it track
     phase 13's (tests/test_executor.py's fp32 tolerance); 3 steps with
     finite, falling losses, bitwise equal across ranks; one program and
     no build after bind; each rank's launches ``spmd_launches(24, 3)``;
     the snapshot gathered to rank 0 rebinds a HeteroTrainer bitwise
     with divergence 0.  Prints each step's seconds, the bytes gathered,
     reduced, scattered and sent a step, each rank's peak memory and
     ``nvidia-smi``'s peak memory used.
 15. the pipeline across stage ranks: ``runtime/spmd_pipeline.py`` over
     4 stage processes of 6 blocks, M 4 microbatches of 2 (phase 13's
     first 8 sequences), no remat; the loss and the params after one
     ``make_pipeline_train_step`` held to one process's plain
     full-model step on the same sequences (the same tolerance); 3
     steps with falling losses, bitwise on every stage; each stage's
     launches 6 blocks x M x steps of each norm and flash kernel and
     three times that of ``gemm_bias``.  Prints the step times, the
     bytes each stage sent and reduced, and each stage's peak memory.
     15b: the same model and microbatches on stage 2 x data 2 (two stage
     groups, each running the whole pipeline), remat full, 2 steps: the
     losses held to phase 15's at tests/test_executor.py's fp32
     tolerance and bitwise on every rank, each stage's two data
     replicas bitwise equal after the steps, each rank's launches as
     remat full derives.
 16. the autotuner: each kernel tuned at the paths' shapes
     (``autotune.PATH_SHAPES``) into a scratch cache, printing each
     candidate's time, the winner and the packaged entry; asserts that
     with tuning off every path key resolves to the packaged table's
     entry, and that two fresh interpreters resolve the same.
 17. sequence parallelism and MoE over batch ranks: one world of 4 rank
     processes on data 2 x model 2 (FSDP + ZeRO-1, gloo) runs
     gpt3-medium (8 blocks, the sequence over model), granite-moe (4
     blocks, the router statistics over 4 batch ranks) and mamba2-780m
     (8 blocks), each held to a one-program ``SPMDExecutor`` on the
     same weights and sequences (``[seq]`` lines).
 18. Megatron tensor and expert parallelism (``strategy="tp"``): one
     world of 4 rank processes on data 2 x model 2 (ZeRO-1, gloo),
     global batch 2 (one sequence of 2048 a model group), phase 13's
     model options, 2 steps of 18a gpt3-medium (8 of 24 blocks, 8 heads
     a rank, the table whole), 18b granite-moe (8 of 24 blocks, 16 of 32
     experts a rank, GQA 8 / 4 heads) and 18c qwen3-1.7b (8 of 28
     blocks, GQA 8 / 4 heads of 128 with q/k norms, the tied table
     vocab-parallel), at full width.  Each is held to a one-program
     ``SPMDExecutor`` on the same weights and sequences: the first loss
     (and aux) at tests/test_executor.py's fp32 tolerance, the params
     after step 1 by its tracking rule; every rank's losses bitwise
     equal; after every step each leaf whose spec does not name the
     model axis bitwise equal across the model group; each rank's state
     bytes equal the dry-run's per-card args less the batch; one program;
     each rank's flash, GEMM and norm launches as remat full derives.
     Prints (``[tp]`` lines) the step seconds (rank 0's and the slowest
     rank's), the bytes a rank a step by kind and by tag beside the
     dry-run's all-reduce bytes for the same layout (a trace run beside
     the ranks), the launches and each rank's peak memory.
 19. the Mamba2 mixer under TP: phase 18's world and layout, each rank
     computing its whole heads, 2 steps of 19a mamba2-780m (8 of 48
     blocks, 24 Mamba2 heads of 64 a rank at state 128, the tied table
     vocab-parallel) and 19b hymba-1.5b (4 of 32 blocks, attention 15 /
     10 query heads over 3 / 2 kv heads a rank under its window of 2048,
     25 Mamba2 heads a rank at state 16, the table whole), at full width
     with the flash, epilogue and SSD kernels.  Held as phase 18 holds
     its scenarios, and each rank's "tp" and "ssm_norm" all-reduce bytes
     equal the count from the shapes (``tp_mixer_bytes``), printed
     beside their ratio to the dry-run's act + act-grad bytes (its trace
     runs beside phases 17 and 18).
     19c: hymba-1.5b at full width over data 1 x model 8, one world of 8
     rank processes of its own (gloo), 2 of 32 blocks, phase 13's first
     2 sequences, 2 steps: query heads 4 / 3 / ... / 3 of 25 over 5 kv
     heads, ranks 1, 4 and 6 straddling two kv groups, their heads run
     as two flash pieces a block (``TPContext.pieces``).  Held as phase
     19 holds its scenarios (the whole-leaf gradients of in_proj and the
     heads' vectors in the "tp" count); rank 1's flash launches twice
     rank 0's; each rank's peak beside the dry-run's per-card peak (its
     trace beside phases 17 and 18).  Phase 3 checks the pieces' flash
     shapes (``19c-1``..``19c-4``).
 20. the reference's default dtype, bf16 activations over fp32
     parameters: one program (``SPMDExecutor`` from ``build_model``,
     remat full, the chunked CE at 512, the flash, epilogue and SSD
     kernels) at full width and depth over phase 13's first 4 sequences
     of 2048: 20a qwen3-1.7b, 20b hymba-1.5b, 20c qwen2.5-3b, 20d
     musicgen-large (with 256 frame embeddings from a seed).  Each on
     one set of seeded weights: a plain fp32 forward loss (blocked
     attention, the chunked SSD scan, no fused epilogue, under no_grad),
     then 2 fp32 steps whose first loss equals it (tests/test_executor.py's
     fp32 tolerance), then 2 bf16 steps whose first loss is within
     ``BF16_LOSS_RTOL`` of the first fp32 loss; both falling.  Per run:
     one program, no build after bind, the state equal to the dry-run's
     args less the batch, each kernel's launches as the shapes count them
     (``seq_launches``); peak memory beside the dry-run's estimate and
     the achieved TFLOP/s beside the fp32 and bf16 peaks (the pricing's
     traces run on the host from the script's start).  20a and 20b go
     through phase 13's kill and a HeteroTrainer rebound from the bf16
     snapshot (divergence 0, no build).
 21. serving over the mesh: the prefill and decode bundles
     (``SPMDServer``) over one world of 4 rank processes on data 2 x
     model 2 (gloo), fp32, full width, phase 13's first 4 sequences of
     2048 as prompts: 21a qwen3-1.7b under TP (8 blocks, the tied table
     vocab-parallel), 21b hymba-1.5b under TP (8 blocks, whole kv groups
     3 / 2 a rank, 25 Mamba2 heads a rank), 21c granite-moe under FSDP
     (4 blocks, one row a rank).  Each case prefills, then decodes from
     an empty cache (teacher-forced ticks on the prompt, then greedy
     ticks), held to one program (the same Model without a mesh, on the
     card, on the same weights): the prefill's and the ticks' logits
     within tests/test_executor.py's fp32 tolerance at the logits'
     scale, the greedy tokens equal, the ranks' caches gathered within
     it; outputs replicated across a model group bitwise on its ranks;
     each rank's all-reduce bytes by tag (and FSDP's gathered bytes)
     equal to the count from the shapes; two programs a rank; each
     rank's prefill launches (``serve_launches``), and none in its
     decode ticks.  Prints the prefill
     seconds, the ms a tick, gloo's share of each, the bytes by kind and
     tag, the cache bytes a rank beside the spec's shard and the peaks.
Phases 3-4 also check and time the kernels at phase 20's shapes
(``P20_LABELS``), timed in bf16, and at phase 21's prefill shard shapes
(``SV_LABELS``, the kernels a prefill runs, fp32).  The autotuner reads an empty persisted
table in a temporary directory and never tunes in phases 1-15 and 17-20:
they run the packaged table's configurations (the heuristic at shapes
it has no entry for).  The last lines are the card line, a
``{"kernels": [...]}`` JSON line (each kernel's launches counted on the
path that reports it: phase 7 for the six, phase 8 for the SSD pair;
error, times, bound and the resolved ``config`` at the shapes that path
gives it; ``tp_launches``: rank 0's launches over phases 18, 19 and
19c's six scenarios; ``serve_launches``: rank 0's over phase 21's three
cases; ``bf16``: its launches over phase 20's four bf16 runs
and its bf16 error, times, bound and config at a phase 20 shape,
``reported_bf16``) and ``{"ok": true, "device": {...}}``.
Without a CUDA device, or without the repository beside it, it exits
non-zero and prints no result.

``run(device="cpu")`` rehearses the same control flow on the CPU, with
the plain versions standing in for the kernels (the tests do this).
"""
from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

# Published H100 SXM peaks (NVIDIA data sheet, dense): the bound of a
# kernel is the larger of bytes / memory rate and operations / peak.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"torch.float32": 67e12, "torch.bfloat16": 989e12}
# The tensor-core designs of gemm_bias, the three flash kernels and the
# two SSD kernels: fp32 runs three TF32 products per multiply-add
# (3xTF32) at the 495 TFLOP/s TF32 peak, bf16 one product at 989.
# Printed beside the bound above, which stays the kernels line's
# bound_ms.
TENSOR_CORE = ("gemm_bias", "flash_fwd", "flash_bwd_dq", "flash_bwd_dkdv",
               "gemm_bias_wgmma", "flash_fwd_wgmma", "flash_bwd_dq_wgmma",
               "flash_bwd_dkdv_wgmma", "ssd_fwd", "ssd_bwd", "ssd_fwd_wgmma",
               "ssd_bwd_wgmma")
TC_PEAK_FLOPS = {"torch.float32": 495e12 / 3, "torch.bfloat16": 989e12}

PATHS = {   # phase -> (label, argv on the card, argv of the CPU rehearsal)
    6: ("naive", ["--full", "--seq-len", "512", "--steps", "4", "--kill-at",
                 "2", "--device", "cuda"],
        ["--steps", "3", "--kill-at", "1", "--device", "cpu"]),
    7: ("flash", ["--full", "--seq-len", "2048", "--attn-impl", "kernel",
                  "--steps", "4", "--kill-at", "2", "--device", "cuda"],
        ["--steps", "3", "--kill-at", "1", "--attn-impl", "kernel",
         "--device", "cpu"]),
    # microbatch 1: at microbatch 2 the activations of 48 Mamba2 blocks
    # beside two replicas' weights and AdamW state overflow the 80 GB
    8: ("mamba", ["--arch", "mamba2-780m", "--full", "--seq-len", "2048",
                  "--microbatch", "1", "--ssd-impl", "kernel", "--steps", "4",
                  "--kill-at", "2", "--device", "cuda"],
        ["--arch", "mamba2-780m", "--steps", "3", "--kill-at", "1",
         "--ssd-impl", "kernel", "--device", "cpu"]),
    # microbatch 1 and dense dispatch: the reference driver's Model
    # (src/repro/launch/train.py builds it with the default moe_impl)
    10: ("moe", ["--arch", "granite-moe-1b-a400m", "--full", "--seq-len",
                 "2048", "--microbatch", "1", "--attn-impl", "kernel",
                 "--steps", "4", "--kill-at", "2", "--device", "cuda"],
         ["--arch", "granite-moe-1b-a400m", "--steps", "3", "--kill-at", "1",
          "--attn-impl", "kernel", "--device", "cpu"]),
}
#: launches of each SSD kernel on the mamba path's card run: one per
#: layer and microbatch, 48 layers x 16 microbatches x 4 steps
MAMBA_SSD_LAUNCHES = 48 * 16 * 4
#: launches on the moe path's card run: each norm and flash kernel once
#: per layer and microbatch, 24 layers x 16 microbatches x 4 steps;
#: gemm_bias three times (the fused QKV's forward, dx and dW)
MOE_LAUNCHES = {k: 24 * 16 * 4 for k in ("add_rmsnorm_fwd", "add_rmsnorm_bwd",
                                         "flash_fwd", "flash_bwd_dq",
                                         "flash_bwd_dkdv")}
MOE_LAUNCHES["gemm_bias"] = 3 * 24 * 16 * 4

FUSED_SOURCE = "src/repro_torch/kernels/csrc/fused.cu"
FLASH_SOURCE = "src/repro_torch/kernels/csrc/flash.cuh"
SSD_SOURCE = "src/repro_torch/kernels/csrc/ssd.cu"
SSD_WGMMA_SOURCE = "src/repro_torch/kernels/csrc/ssd_wgmma.cu"
FLASH_BWD_SOURCE = "src/repro_torch/kernels/csrc/flash_bwd_wgmma.cu"
FLASH_TPU = "src/repro/kernels/flash_attention.py"
KERNELS = {   # name -> (TPU kernel it replaces, CUDA source)
    "add_rmsnorm_fwd": ("src/repro/kernels/fused.py:47", FUSED_SOURCE),
    "add_rmsnorm_bwd": ("src/repro/kernels/fused.py:57", FUSED_SOURCE),
    "gemm_bias": ("src/repro/kernels/fused.py:167", FUSED_SOURCE),
    "flash_fwd": (f"{FLASH_TPU}:101", FLASH_SOURCE),
    "flash_bwd_dq": (f"{FLASH_TPU}:220", FLASH_SOURCE),
    "flash_bwd_dkdv": (f"{FLASH_TPU}:247+:274", FLASH_SOURCE),
    "ssd_fwd": ("src/repro/kernels/ssd.py:54", SSD_SOURCE),
    "ssd_bwd": ("src/repro/kernels/ssd.py:190", SSD_SOURCE),
    "gemm_bias_wgmma": ("src/repro/kernels/fused.py:167",
                        "src/repro_torch/kernels/csrc/gemm_wgmma.cu"),
    "flash_fwd_wgmma": (f"{FLASH_TPU}:101",
                        "src/repro_torch/kernels/csrc/flash_wgmma.cu"),
    "flash_bwd_dq_wgmma": (f"{FLASH_TPU}:220", FLASH_BWD_SOURCE),
    "flash_bwd_dkdv_wgmma": (f"{FLASH_TPU}:247+:274", FLASH_BWD_SOURCE),
    "ssd_fwd_wgmma": ("src/repro/kernels/ssd.py:54", SSD_WGMMA_SOURCE),
    "ssd_bwd_wgmma": ("src/repro/kernels/ssd.py:190", SSD_WGMMA_SOURCE),
}
#: the bf16 instances on wgmma and TMA that carry phase 20's QKV
#: GEMM and flash forward and backward, each beside the kernel whose
#: function, inputs, tolerances and bound it shares.  The wrapper picks
#: the instance from its operands (``takes_wgmma``): phases 3-4 hold and
#: time the wgmma entries at phase 20's shapes, in bf16, and the mma.sync
#: entries at the other shapes in fp32, and in bf16 where the inputs
#: reach them (rows TMA cannot read, head dims with no wgmma instance).
#: The SSD pair's wgmma instances (``SSD_WG``) run bf16 calls at state
#: 128 and 16, chunk 64 (``ssd.wgmma_at``): phases 3-4 hold and time
#: each SSD entry at the shapes, dtypes and chunks where the wrapper runs
#: it (``ssd_runs``): the wgmma pair in bf16, held at every SSD label
#: with their (P, N) and timed at the mamba path's shape and 20b's
WGMMA = {"gemm_bias_wgmma": "gemm_bias", "flash_fwd_wgmma": "flash_fwd",
         "flash_bwd_dq_wgmma": "flash_bwd_dq",
         "flash_bwd_dkdv_wgmma": "flash_bwd_dkdv",
         "ssd_fwd_wgmma": "ssd_fwd", "ssd_bwd_wgmma": "ssd_bwd"}


def base_of(name):
    """The kernel whose function ``name`` computes (itself, or the one a
    wgmma instance shares)."""
    return WGMMA.get(name, name)


def takes_wgmma(name, args, chunk=None):
    """Whether the wrapper of the QKV GEMM, a flash kernel or an SSD
    kernel runs its wgmma instance on the call ``args`` (SSD: at
    ``chunk``, default the call's) (else its mma.sync one)."""
    from repro_torch.kernels import flash, fused, ssd
    if base_of(name) in SSD:
        x, B, C = args[0], args[3], args[4]
        gy = args[6] if base_of(name) == "ssd_bwd" else None
        return ssd.instance(x, B, C, ssd_chunk(x, B, chunk), gy) is not None
    if base_of(name) == "gemm_bias":
        a, b = args[:2]
        return fused.gemm_config(
            a.shape[0], b.shape[1], a.shape[1], a.stride(), b.stride(),
            a.data_ptr(), b.data_ptr(), a.element_size()).maps is not None
    if base_of(name) == "flash_fwd":
        return flash.forward_instance(*args[:3], 64) is not None
    return flash.backward_instance(*args[:4], _FLASH_KERNEL[name],
                                   64) is not None


FUSED = ("add_rmsnorm_fwd", "add_rmsnorm_bwd", "gemm_bias")
FLASH = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkdv")
SSD = ("ssd_fwd", "ssd_bwd")
SSD_WG = ("ssd_fwd_wgmma", "ssd_bwd_wgmma")


def ssd_runs(name, label, args, device):
    """Whether SSD entry ``name`` (``SSD``: ssd.cu's mma.sync instance;
    ``SSD_WG``: ssd_wgmma.cu's) is what the wrapper runs on ``args`` at
    its resolved chunk: on the card the wrapper's choice
    (``takes_wgmma``); on the CPU rehearsal, where the plain versions
    stand in, the choice the card makes at the label's card shape
    (``ssd.wgmma_at``)."""
    if device.type == "cpu":
        from repro_torch.kernels import ssd
        P, N = dict(CARD_SHAPES["ssd"])[label][3:5]
        return (name in SSD_WG) == ssd.wgmma_at(args[0].dtype, P, N)
    return (name in SSD_WG) == takes_wgmma(name, args)


# Shapes per kernel: (label, shape).  Norms (M, d); GEMM (M, K, N) of
# x[M,K].W[K,N]; flash (B, S, H, KV, D, window).  A label that names a
# path (PATHS) is the shape that path gives the kernel: gpt3-medium with
# microbatch 2, so M = 4096 rows at phase 7's sequence 2048 and 1024 at
# phase 6's 512; mamba2-780m's SSD with phase 8's microbatch 1;
# granite-moe with phase 10's microbatch 1 (2048 rows, a fused QKV of
# 16 + 2 x 8 heads of 64 = 2048 columns, GQA with 2 query heads a kv
# head).  SSD
# (b, S, H, P, N, expanded): expanded B and C are one group viewed over
# the heads with head stride 0, as the Mamba2 block hands them over.
# Those shapes are checked and timed; the kernels line reports the shape
# of the path whose launches it counts (reported_path).
CARD_SHAPES = {
    "add_rmsnorm_fwd": [("flash", (4096, 1024)), ("naive", (1024, 1024)),
                        ("moe", (2048, 1024)), ("ragged", (1000, 999)),
                        ("tp-c", (2048, 2048)), ("tp-d", (2048, 1600)),
                        ("sv-a", (4096, 2048)), ("sv-b", (4096, 1600)),
                        ("20a", (8192, 2048)), ("20b", (8192, 1600)),
                        ("20d", (9216, 2048))],
    "add_rmsnorm_bwd": [("flash", (4096, 1024)), ("naive", (1024, 1024)),
                        ("moe", (2048, 1024)), ("ragged", (1000, 999)),
                        ("tp-c", (2048, 2048)), ("tp-d", (2048, 1600)),
                        ("20a", (8192, 2048)), ("20b", (8192, 1600)),
                        ("20d", (9216, 2048))],
    "gemm_bias": [("flash", (4096, 1024, 3072)), ("naive", (1024, 1024, 3072)),
                  ("moe", (2048, 1024, 2048)), ("ragged", (1000, 999, 3000)),
                  ("tp-a", (2048, 1024, 1536)), ("tp-b", (2048, 1024, 1024)),
                  ("tp-c", (2048, 2048, 2048)), ("tp-d", (2048, 1600, 1344)),
                  ("tp-e", (2048, 1600, 896)),
                  ("sv-a", (4096, 2048, 2048)), ("sv-b", (4096, 1600, 1344)),
                  ("sv-c", (4096, 1600, 896)),
                  ("20a", (8192, 2048, 4096)), ("20b", (8192, 1600, 2240)),
                  ("20c", (8192, 2048, 2560)), ("20d", (9216, 2048, 6144))],
    # gqa: qwen2.5-3b's heads (16 / kv 2, head dim 128) at a ragged
    # sequence; window: a sliding window of 256 (hymba's 2048 scaled
    # down) with hymba's group of 5 query heads per kv head; d80: GPT-3
    # 2.7B's 32 heads of 80 at a ragged sequence; 19c-1..19c-4: phase
    # 19c's flash pieces, 1-4 of hymba's query heads over one kv head
    # (checked in phase 3, not timed)
    "flash": [("flash", (2, 2048, 16, 16, 64, 0)),
              ("moe", (1, 2048, 16, 8, 64, 0)),
              ("gqa", (2, 1000, 16, 2, 128, 0)),
              ("window", (2, 1000, 20, 4, 64, 256)),
              ("d80", (1, 1000, 32, 32, 80, 0)),
              ("tp-a", (1, 2048, 8, 8, 64, 0)),
              ("tp-b", (1, 2048, 8, 4, 64, 0)),
              ("tp-c", (1, 2048, 8, 4, 128, 0)),
              ("tp-d", (1, 2048, 15, 3, 64, 2048)),
              ("tp-e", (1, 2048, 10, 2, 64, 2048)),
              ("tp-f", (1, 2048, 25, 5, 64, 2048)),
              ("sv-a", (2, 2048, 8, 4, 128, 0)),
              ("sv-b", (2, 2048, 15, 3, 64, 2048)),
              ("sv-c", (2, 2048, 10, 2, 64, 2048)),
              ("19c-1", (2, 2048, 1, 1, 64, 2048)),
              ("19c-2", (2, 2048, 2, 1, 64, 2048)),
              ("19c-3", (2, 2048, 3, 1, 64, 2048)),
              ("19c-4", (2, 2048, 4, 1, 64, 2048)),
              ("20a", (4, 2048, 16, 8, 128, 0)),
              ("20b", (4, 2048, 25, 5, 64, 2048)),
              ("20c", (4, 2048, 16, 2, 128, 0)),
              ("20d", (4, 2304, 32, 32, 64, 0))],
    # hymba: its SSD heads (50 x 64, state 16) at a ragged sequence;
    # reduced: the reduced configs' widths, per-head B and C
    "ssd": [("mamba", (1, 2048, 48, 64, 128, True)),
            ("hymba", (2, 1000, 50, 64, 16, True)),
            ("reduced", (2, 300, 8, 16, 16, False)),
            ("tp-d", (1, 2048, 25, 64, 16, True)),
            ("tp-g", (1, 2048, 24, 64, 128, True)),
            ("sv-b", (2, 2048, 25, 64, 16, True)),
            ("20b", (4, 2048, 50, 64, 16, True))],
}
CPU_SHAPES = {
    "add_rmsnorm_fwd": [("flash", (128, 64)), ("naive", (64, 64)),
                        ("moe", (64, 64)), ("ragged", (33, 47)),
                        ("tp-c", (64, 128)), ("tp-d", (64, 100)),
                        ("sv-a", (64, 128)), ("sv-b", (64, 100)),
                        ("20a", (64, 128)), ("20b", (64, 100)),
                        ("20d", (72, 128))],
    "add_rmsnorm_bwd": [("flash", (128, 64)), ("naive", (64, 64)),
                        ("moe", (64, 64)), ("ragged", (33, 47)),
                        ("tp-c", (64, 128)), ("tp-d", (64, 100)),
                        ("20a", (64, 128)), ("20b", (64, 100)),
                        ("20d", (72, 128))],
    "gemm_bias": [("flash", (128, 64, 192)), ("naive", (64, 64, 192)),
                  ("moe", (64, 64, 128)), ("ragged", (33, 47, 95)),
                  ("tp-a", (64, 64, 96)), ("tp-b", (64, 64, 64)),
                  ("tp-c", (64, 128, 128)), ("tp-d", (64, 100, 84)),
                  ("tp-e", (64, 100, 56)), ("sv-a", (64, 128, 128)),
                  ("sv-b", (64, 100, 84)), ("sv-c", (64, 100, 56)),
                  ("20a", (64, 128, 256)),
                  ("20b", (64, 100, 140)), ("20c", (64, 128, 160)),
                  ("20d", (72, 128, 384))],
    "flash": [("flash", (1, 64, 2, 2, 32, 0)), ("moe", (1, 64, 4, 2, 32, 0)),
              ("gqa", (1, 40, 4, 2, 32, 0)),
              ("window", (1, 40, 4, 1, 32, 16)), ("d80", (1, 40, 2, 2, 80, 0)),
              ("tp-a", (1, 64, 2, 2, 32, 0)), ("tp-b", (1, 64, 2, 1, 32, 0)),
              ("tp-c", (1, 64, 2, 1, 64, 0)), ("tp-d", (1, 40, 15, 3, 16, 40)),
              ("tp-e", (1, 40, 10, 2, 16, 40)),
              ("tp-f", (1, 40, 25, 5, 16, 40)),
              ("sv-a", (2, 40, 4, 2, 64, 0)), ("sv-b", (2, 40, 15, 3, 16, 40)),
              ("sv-c", (2, 40, 10, 2, 16, 40)),
              ("19c-1", (2, 40, 1, 1, 16, 40)),
              ("19c-2", (2, 40, 2, 1, 16, 40)),
              ("19c-3", (2, 40, 3, 1, 16, 40)),
              ("19c-4", (2, 40, 4, 1, 16, 40)),
              ("20a", (2, 40, 4, 2, 32, 0)), ("20b", (2, 40, 5, 1, 16, 40)),
              ("20c", (2, 40, 8, 1, 32, 0)), ("20d", (2, 45, 4, 4, 16, 0))],
    "ssd": [("mamba", (1, 100, 3, 16, 16, True)),
            ("hymba", (1, 70, 3, 16, 8, True)),
            ("reduced", (1, 33, 2, 8, 16, False)),
            ("tp-d", (1, 70, 5, 16, 8, True)),
            ("tp-g", (1, 100, 4, 16, 16, True)),
            ("sv-b", (2, 70, 5, 16, 8, True)),
            ("20b", (2, 70, 5, 16, 8, True))],
}
PATH_LABELS = tuple(label for label, _, _ in PATHS.values())
#: the shard shapes of phases 18 and 19 (one sequence of 2048 a rank,
#: model 2): tp-a gpt3-medium (8 heads of 64: a fused QKV of 1536
#: columns), tp-b granite-moe (GQA 8 / 4 heads of 64: 1024 columns),
#: tp-c qwen3-1.7b (GQA 8 / 4 heads of 128: 2048 columns at d 2048, and
#: its norms); hymba-1.5b's whole kv groups, tp-d on rank 0 (15 / 3
#: heads of 64 under its window of 2048: a fused QKV of 1344 columns at
#: K = d 1600, 12.5 tiles of 128; its norms at d 1600; its 25 Mamba2
#: heads of 64 at state 16) and tp-e on rank 1 (10 / 2 heads: 896
#: columns), tp-f its 25 / 5 heads whole (one program); tp-g
#: mamba2-780m's 24 Mamba2 heads of 64 a rank at state 128.  Checked in
#: phase 3 and timed in phase 4 as the paths' shapes are, with the
#: configuration the autotuner resolves for each (the heuristic where
#: its table has no entry)
TP_LABELS = ("tp-a", "tp-b", "tp-c", "tp-d", "tp-e", "tp-f", "tp-g")
#: phase 21's prefill shard shapes under TP (two sequences of 2048 a
#: rank, model 2): sv-a qwen3-1.7b (the fused QKV of 8 / 4 heads of 128,
#: 2048 columns at d 2048; flash at 8 / 4 heads of 128; norms at [4096,
#: 2048]); hymba-1.5b's whole kv groups, sv-b on rank 0 (15 / 3 heads of
#: 64 under its window: 1344 columns at d 1600; norms at d 1600; its 25
#: Mamba2 heads at state 16) and sv-c on rank 1 (10 / 2 heads: 896
#: columns).  21c's FSDP rank (one sequence, every head) runs the moe
#: path's shapes.  Only the kernels a prefill runs (``SERVE_KERNELS``),
#: in fp32, the dtype phase 21 serves in: checked in phase 3 in every
#: built variant and timed in phase 4 (phase 21 holds its decode ticks
#: to no launch)
SV_LABELS = ("sv-a", "sv-b", "sv-c")
SERVE_KERNELS = ("add_rmsnorm_fwd", "gemm_bias", "flash_fwd", "ssd_fwd")
#: phase 20's shapes, one program over 4 sequences (8192 tokens), each
#: checked in phase 3 and timed in phase 4 in bf16, the dtype phase 20
#: holds to fp32: 20a qwen3-1.7b (flash 16 / 8 heads of 128; the fused
#: QKV of 4096 columns at d 2048; norms at d 2048), 20b hymba-1.5b (25 /
#: 5 heads of 64 under its window of 2048; 2240 columns at d 1600; norms
#: at d 1600; its 50 Mamba2 heads of 64 at state 16), 20c qwen2.5-3b (16
#: / 2 heads of 128; 2560 columns), 20d musicgen-large (32 heads of 64
#: at 2304 positions, 9216 tokens with its frame embeddings; 6144
#: columns; norms at [9216, 2048])
P20_LABELS = ("20a", "20b", "20c", "20d")


def reported_path(name):
    """The label of the path whose launches, error and times the kernels
    line reports for ``name``."""
    return PATHS[8][0] if base_of(name) in SSD else PATHS[7][0]


def reported_bf16(name):
    """The phase 20 shape a kernel's ``bf16`` entry of the kernels line
    reports: qwen3-1.7b's (20a), the SSD's hymba-1.5b's (20b)."""
    return "20b" if base_of(name) in SSD else "20a"


class SmokeFailure(AssertionError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def _shapes(table, name):
    name = base_of(name)
    return table["flash" if name in FLASH else "ssd" if name in SSD else name]


# ----------------------------------------------------------------------
# Kernels, their plain versions, and how each is compared
# ----------------------------------------------------------------------
def kernel_table(device):
    """name -> (kernel, plain, library or None), all on the same inputs.
    On the CPU (rehearsal) the plain versions stand in for the kernels.
    The flash entries take the window as their last argument.  The QKV
    GEMM's and flash forward's wrappers pick their instance from the
    inputs, so a ``WGMMA`` entry is the same wrapper as its kernel's."""
    import torch
    from repro_torch.kernels import ref
    plain = {
        "add_rmsnorm_fwd": lambda x, r, w: ref.add_rmsnorm_ref(x, r, w, eps=1e-6),
        "add_rmsnorm_bwd": lambda res, w, gres, gh: ref.add_rmsnorm_bwd_ref(
            res, w, gres, gh, eps=1e-6),
        "gemm_bias": ref.matmul_bias_ref,
        "flash_fwd": lambda q, k, v, win: ref.flash_fwd_ref(q, k, v, window=win),
        "flash_bwd_dq": lambda q, k, v, g, lse, delta, win: ref.flash_bwd_ref(
            q, k, v, None, lse, g, window=win, delta=delta)[0],
        "flash_bwd_dkdv": lambda q, k, v, g, lse, delta, win: ref.flash_bwd_ref(
            q, k, v, None, lse, g, window=win, delta=delta)[1:],
        "ssd_fwd": lambda x, dt, A, B, C, chunk=None: ref.ssd_fwd_ref(
            x, dt, A, B, C, chunk=ssd_chunk(x, B, chunk)),
        "ssd_bwd": lambda x, dt, A, B, C, cst, gy, gs, chunk=None: (
            ref.ssd_bwd_ref(x, dt, A, B, C, cst, gy, gs,
                            chunk=ssd_chunk(x, B, chunk))),
    }
    library = {"gemm_bias": lambda a, b, bias: torch.addmm(bias, a, b),
               "flash_fwd": sdpa_forward}
    for name, of in WGMMA.items():
        plain[name] = plain[of]
        if of in library:
            library[name] = library[of]
    if device.type == "cpu":
        kern = plain
    else:
        from repro_torch.kernels import flash, fused, ssd
        kern = {
            "add_rmsnorm_fwd": lambda x, r, w: fused.add_rmsnorm_fwd(x, r, w, 1e-6),
            "add_rmsnorm_bwd": lambda res, w, gres, gh: fused.add_rmsnorm_bwd(
                res, w, gres, gh, 1e-6),
            "gemm_bias": fused.gemm_bias,
            "flash_fwd": flash.flash_fwd,
            "gemm_bias_wgmma": fused.gemm_bias,
            "flash_fwd_wgmma": flash.flash_fwd,
            "flash_bwd_dq": flash.flash_bwd_dq,
            "flash_bwd_dkdv": flash.flash_bwd_dkdv,
            "flash_bwd_dq_wgmma": flash.flash_bwd_dq,
            "flash_bwd_dkdv_wgmma": flash.flash_bwd_dkdv,
            "ssd_fwd": ssd.ssd_fwd,
            "ssd_bwd": ssd.ssd_bwd,
            "ssd_fwd_wgmma": ssd.ssd_fwd,
            "ssd_bwd_wgmma": ssd.ssd_bwd,
        }
    return {k: (kern[k], plain[k], library.get(k)) for k in KERNELS}


def ssd_chunk(x, B, chunk=None):
    """The SSD chunk of a call on x, B: ``chunk``, else the autotuner's
    (the kernels' on the card, the plain version's on the CPU)."""
    from repro_torch.kernels import ssd
    return ssd.resolve_chunk(x, B, chunk)


def sdpa_forward(q, k, v, window):
    """The library yardstick of the flash forward: one causal
    scaled_dot_product_attention call on [B, H, S, D] views, grouped
    query heads where there are fewer kv heads; with fewer queries than
    keys the causal mask is aligned to the keys' end
    (``causal_lower_right``, as the kernels align it).  A window no
    shorter than the keys (hymba's 2048 at S 2048) cuts no causal pair,
    so the causal call computes the same function.  Timed only; the
    port never calls it."""
    import torch
    check(window == 0 or window >= k.shape[1],
          "the SDPA yardstick is timed where no window cuts a causal pair")
    Sq, Sk = q.shape[1], k.shape[1]
    if Sq == Sk:
        kw = dict(is_causal=True)
    else:
        from torch.nn.attention.bias import causal_lower_right
        kw = dict(attn_mask=causal_lower_right(Sq, Sk))
    return torch.nn.functional.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        enable_gqa=q.shape[2] != k.shape[2], **kw)


def make_inputs(name, shape, dtype, device, seed, layout="fwd", chunk=None,
                draw_on_device=False):
    """Inputs for one kernel call.  Norms: shape = (M, d).  GEMM: shape =
    (M, K, N) of the forward x[M,K].W[K,N]; ``layout`` picks the product
    the fused QKV runs: fwd x.W+b, dx g.W^T (W read transposed), dW
    x^T.g (x read transposed).  Flash: shape = (B, S, H, KV, D, window)
    or (B, Sq, H, KV, D, window, Sk), the queries the last Sq of Sk
    positions; the backward kernels get the plain forward's lse and
    delta.  SSD:
    shape = (b, S, H, P, N, expanded), dt and A of the Mamba2 block's
    ranges (per-step decays e^(dt.A) of 0.3-1, so the state carries
    across chunks); the backward gets the plain forward's cstates at
    ``chunk`` (default: the call's, ``ssd_chunk``) and a nonzero state
    cotangent.  The numbers come from a CPU generator, or with
    ``draw_on_device`` from one on ``device`` (phase 20's shapes: drawing
    their 50-100 M numbers on the host took most of phases 3-4 there)."""
    import torch
    name = base_of(name)
    g = torch.Generator(device=device if draw_on_device else "cpu"
                        ).manual_seed(seed)

    def draw(s):
        return torch.randn(s, generator=g, device=g.device)

    def randn(*s, scale=1.0):
        return (draw(s) * scale).to(device=device, dtype=dtype)
    if name == "add_rmsnorm_fwd":
        M, d = shape
        return (randn(M, d), randn(M, d), randn(d, scale=0.2) + 1.0)
    if name == "add_rmsnorm_bwd":
        M, d = shape
        return (randn(M, d), randn(d, scale=0.2) + 1.0, randn(M, d), randn(M, d))
    if name in SSD:
        from repro_torch.kernels import ref
        b, S, H, P, N, expanded = shape
        x = randn(b, S, H, P)
        dt = torch.nn.functional.softplus(draw((b, S, H)) - 3.0).to(device)
        A = -torch.exp(draw((H,)) * 0.5).to(device)
        BC = [randn(b, S, 1, N).expand(b, S, H, N) if expanded
              else randn(b, S, H, N) for _ in range(2)]
        if name == "ssd_fwd":
            return (x, dt, A, *BC)
        cstates = ref.ssd_fwd_ref(x, dt, A, *BC,
                                  chunk=ssd_chunk(x, BC[0], chunk))[2]
        gstate = draw((b, H, P, N)).to(device)
        return (x, dt, A, *BC, cstates, randn(b, S, H, P), gstate)
    if name in FLASH:
        from repro_torch.kernels import ref
        B, S, H, KV, D, window, *rest = shape
        Sk = rest[0] if rest else S
        q, k, v = randn(B, S, H, D), randn(B, Sk, KV, D), randn(B, Sk, KV, D)
        if name == "flash_fwd":
            return (q, k, v, window)
        dout = randn(B, S, H, D)
        out, lse = ref.flash_fwd_ref(q, k, v, window=window)
        return (q, k, v, dout, lse, ref.flash_delta(out, dout), window)
    M, K, N = shape
    x, w = randn(M, K), randn(K, N, scale=K ** -0.5)
    if layout == "fwd":
        return (x, w, randn(N))
    if layout == "dx":
        return (randn(M, N), w.t(), None)
    return (x.t(), randn(M, N), None)


def _flat(out):
    return list(out) if isinstance(out, (tuple, list)) else [out]


def _conds(name, args, want, chunk=None):
    """Per output, its condition-aware scale, or None.  An output that
    is a sum of many terms (the norm's weight gradient over M rows; the
    GEMM's over K; the flash out and dq over kv positions; dk and dv over
    the G query heads and all q positions; every SSD output over the
    chunk's rows, its state and the chunks before or after it) rounds in
    proportion to the sum of its terms' magnitudes, not to the (often
    much smaller) result: that sum is its scale.  The SSD scales are the
    plain versions run on the inputs' magnitudes (all terms then
    positive; the backward with ``magnitudes=True``), at the call's
    chunk."""
    import torch
    name = base_of(name)
    scales = [None] * len(want)
    if name in SSD:
        from repro_torch.kernels import ref
        x, dt, A, B, C = args[:5]
        chunk = ssd_chunk(x, B, chunk)
        ax, aB, aC = (t.float().abs() for t in (x, B, C))
        fwd = ref.ssd_fwd_ref(ax, dt, A, aB, aC, chunk=chunk)
        if name == "ssd_fwd":
            return list(fwd)
        gy, gstate = args[6:]
        return list(ref.ssd_bwd_ref(ax, dt, A, aB, aC, fwd[2],
                                    gy.float().abs(), gstate.abs(),
                                    chunk=chunk, magnitudes=True))
    if name == "gemm_bias":
        a, b, _ = args
        scales[0] = a.float().abs() @ b.float().abs()
    elif name == "add_rmsnorm_bwd":
        res, _, _, gh = (t.float() for t in args)
        n = res * (res.square().mean(-1, keepdim=True) + 1e-6).rsqrt()
        scales[1] = (gh.abs() * n.abs()).sum(0)
    elif name == "flash_fwd":
        from repro_torch.kernels import ref
        q, k, v, window = args
        lse = want[1]
        p, _ = ref.flash_bwd_terms(q, k, v, lse, torch.zeros_like(q),
                                   torch.zeros_like(lse), window=window)
        scales[0] = torch.einsum("bkgqs,bskd->bqkgd", p, v.float().abs()
                                 ).reshape(q.shape)
    elif name in ("flash_bwd_dq", "flash_bwd_dkdv"):
        from repro_torch.kernels import ref
        q, k, v, dout, lse, delta, window = args
        B, S, H, D = q.shape
        KV = k.shape[2]
        p, ds = ref.flash_bwd_terms(q, k, v, lse, dout, delta, window=window)
        ds = ds.abs()

        def grouped(t):
            return t.float().abs().reshape(B, S, KV, H // KV, D)
        if name == "flash_bwd_dq":
            scales[0] = torch.einsum("bkgqs,bskd->bqkgd", ds, k.float().abs()
                                     ).reshape(B, S, H, D)
        else:
            scales[0] = torch.einsum("bkgqs,bqkgd->bskd", ds, grouped(q))
            scales[1] = torch.einsum("bkgqs,bqkgd->bskd", p, grouped(dout))
    return scales


def _tol(rtol, atol, ctol=0.0):
    return dict(rtol=rtol, atol=atol, ctol=ctol)


# An element fails when |kernel - plain| > atol + rtol.|plain| +
# ctol.cond, cond being the output's condition-aware scale (_conds).
# fp32: another summation order.  The norms rtol 1e-5 / atol 1e-6 (dw
# against its cond); the GEMM and the flash out 1e-4, the GEMM plus 1e-6
# of its cond (in the dW layout at the flash path's K = 4096 an output
# may be 2 % of its cond, and the two summation orders differed by
# 3.4e-7 of it); the flash lse 1e-5; the flash gradients 1e-4 against
# their cond; the SSD outputs rtol 1e-4 plus 1e-5 of their cond (the
# kernels' exp, cumsum and products round in another order than the
# plain versions', each term to ~1e-7 of its magnitude).
TOL_FP32 = {
    "add_rmsnorm_fwd": [_tol(1e-5, 1e-6)] * 2,
    "add_rmsnorm_bwd": [_tol(1e-5, 1e-6), _tol(0.0, 1e-6, 1e-5)],
    "gemm_bias": [_tol(1e-4, 1e-4, 1e-6)],
    "flash_fwd": [_tol(1e-4, 1e-4), _tol(1e-5, 1e-5)],
    "flash_bwd_dq": [_tol(0.0, 1e-4, 1e-4)],
    "flash_bwd_dkdv": [_tol(0.0, 1e-4, 1e-4)] * 2,
    "ssd_fwd": [_tol(1e-4, 1e-6, 1e-5)] * 3,
    "ssd_bwd": [_tol(1e-4, 1e-6, 1e-5)] * 5,
}
# bf16: both sides compute in fp32 from the same bf16 inputs and round
# once, so two results may sit one bf16 ulp apart (2^-7 relative):
# rtol 2e-2.  Elementwise outputs (magnitudes near 1) take atol 2e-2.  A
# sum of many terms is often only a few percent of its cond, so a cond
# term as loose as 2e-2 would pass a zeroed output: those get 1e-3 of
# their cond (the fp32 sums agree to ~1e-6 of it) and atol 1e-5.  The
# flash lse, the SSD states, ddt and dA are fp32 on both sides: as in
# fp32.
_SUM_BF16 = _tol(2e-2, 1e-5, 1e-3)
TOL_BF16 = {
    "add_rmsnorm_fwd": [_tol(2e-2, 2e-2)] * 2,
    "add_rmsnorm_bwd": [_tol(2e-2, 2e-2), _SUM_BF16],
    "gemm_bias": [_tol(2e-2, 2e-2)],
    "flash_fwd": [_SUM_BF16, _tol(1e-5, 1e-5)],
    "flash_bwd_dq": [_SUM_BF16],
    "flash_bwd_dkdv": [_SUM_BF16] * 2,
    "ssd_fwd": [_SUM_BF16] + TOL_FP32["ssd_fwd"][1:],
    "ssd_bwd": [_SUM_BF16, TOL_FP32["ssd_bwd"][1], TOL_FP32["ssd_bwd"][2],
                _SUM_BF16, _SUM_BF16],
}


def tolerances(name, dtype):
    """Per output: dict(rtol, atol, ctol)."""
    import torch
    return (TOL_BF16 if dtype == torch.bfloat16 else TOL_FP32)[base_of(name)]


def compare(name, kern, plain, args, dtype, chunk=None):
    """Hold kern against plain on ``args`` (SSD: at ``chunk``, default
    the call's); returns (max abs error, max of error / limit over the
    outputs' elements)."""
    import torch
    got, want = _flat(kern(*args)), _flat(plain(*args))
    err = ratio = 0.0
    for i, (a, b, cond, tol) in enumerate(zip(
            got, want, _conds(name, args, want, chunk),
            tolerances(name, dtype))):
        check(a.shape == b.shape and a.dtype == b.dtype,
              f"{name}[{i}]: {a.shape}/{a.dtype} vs {b.shape}/{b.dtype}")
        for side, t in (("kernel", a), ("plain", b)):
            check(torch.isfinite(t.float()).all().item(),
                  f"{name}[{i}]: non-finite {side} output")
        diff = (a.float() - b.float()).abs()
        limit = tol["atol"] + tol["rtol"] * b.float().abs()
        if cond is not None:
            limit = limit + tol["ctol"] * cond
        bad = diff > limit
        check(not bad.any().item(),
              f"{name}[{i}] {dtype}: {int(bad.sum())} of {bad.numel()} "
              f"elements off, max abs err {float(diff.max()):.3e} (tol {tol})")
        err = max(err, float(diff.max()))
        ratio = max(ratio, float((diff / limit).max()))
    again = _flat(kern(*args))
    check(all(torch.equal(a, b) for a, b in zip(got, again)),
          f"{name} {dtype}: two runs on the same inputs differ")
    return err, ratio


_FLASH_KERNEL = {"flash_fwd": "fwd", "flash_bwd_dq": "dq",
                 "flash_bwd_dkdv": "dkdv", "flash_fwd_wgmma": "fwd",
                 "flash_bwd_dq_wgmma": "dq", "flash_bwd_dkdv_wgmma": "dkdv"}


def variants(name, args, dtype, device):
    """Every built variant of kernel ``name`` for the call ``args``:
    [(label, kernel, chunk, resolved)], ``resolved`` marking the one the
    autotuner resolves (what the wrapper runs by default).  Flash: each
    built tile; SSD: each built chunk; the GEMM: each legal (tile,
    split); the norm backward: each candidate row partition.  On the CPU
    (rehearsal) only the resolved one, the plain version standing in."""
    import functools
    kern = kernel_table(device)[name][0]
    if device.type == "cpu":
        return [("resolved", kern, None, True)]
    from repro_torch.kernels import autotune, flash, fused, ssd
    if base_of(name) in FLASH:
        q = args[0]
        k = _FLASH_KERNEL[name]
        kw = "block_k" if k == "dkdv" else "block_q"
        want = dict(zip(("block_q", "block_k"), flash.resolve_tiles(q)))[kw]
        return [(f"{kw}={t}", functools.partial(kern, **{kw: t}), None,
                 t == want)
                for t in flash.tiles(k, q.shape[-1], dtype)]
    if base_of(name) in SSD:      # the chunks at which ``name`` runs
        want = ssd_chunk(args[0], args[3])
        return [(f"chunk={c}", functools.partial(kern, chunk=c), c, c == want)
                for c in ssd.CHUNKS
                if takes_wgmma(name, args, c) == (name in SSD_WG)]
    if base_of(name) == "gemm_bias":
        a, b = args[:2]
        cfg = fused.gemm_config(a.shape[0], b.shape[1], a.shape[1],
                                a.stride(), b.stride(), a.data_ptr(),
                                b.data_ptr(), a.element_size(),
                                autotune.backend_of(a.device))
        legal = (fused.gemm_candidates(a.shape[1], a.element_size())
                 if cfg.vec else [(64, 64, 1)])
        return [(f"{bm}x{bn}/split{sp}",
                 functools.partial(fused.gemm_bias, choice=(bm, bn, sp)),
                 None, (bm, bn, sp) == (cfg.bm, cfg.bn, cfg.splits))
                for bm, bn, sp in legal]
    if name == "add_rmsnorm_bwd":
        res = args[0]
        want = fused.norm_bwd_config(
            *res.shape, res.element_size(), [t.data_ptr() for t in args],
            autotune.backend_of(res.device)).rows_per_block
        return [(f"rows={n}", lambda *a, n=n: fused.add_rmsnorm_bwd(
                    *a, 1e-6, rows_per_block=n), None, n == want)
                for n in fused.norm_rows_candidates(*res.shape)]
    return [("rows=1", kern, None, True)]


def check_kernels(device, table, shapes):
    """Phase 3: every built variant of every kernel (``variants``)
    against the plain version, and rerun bitwise; the flash tiles also
    bitwise equal to each other.  At phase 20's full-size shapes only
    the resolved variant in bf16 (the autotuner held every candidate
    against its plain version when it tuned them, and phase 20 holds the
    fp32 kernels there to the plain forward).  Returns ({name: max abs error of the
    resolved variant at the reported path's shape in fp32}, the same at
    its phase 20 shape in bf16)."""
    import torch
    errors, errors_bf16 = {}, {}
    for name, (_, plain, _) in table.items():
        layouts = (("fwd", "dx", "dW") if base_of(name) == "gemm_bias"
                   else ("fwd",))
        ssd_k = base_of(name) in SSD
        for dtype in ((torch.bfloat16,) if name in WGMMA and not ssd_k
                      else (torch.float32, torch.bfloat16)):
            for label, shape in _shapes(shapes, name):
                p20 = label in P20_LABELS
                if p20 and dtype == torch.float32:
                    continue            # phase 20 holds fp32 end to end
                # phase 20's shapes run the wgmma instances, the others
                # in bf16 too where TMA reads them, so the mma.sync
                # entries are held off phase 20's shapes where their
                # inputs reach them (the card tests hold the wgmma
                # instances at other shapes); each SSD entry is held
                # wherever a call reaches it (``ssd_runs``; ``variants``:
                # at the chunks it runs)
                if (p20 == (name in WGMMA.values())
                        and (name in WGMMA or name in WGMMA.values())
                        and not (ssd_k and name in SSD_WG)):
                    continue
                if label in SV_LABELS and (dtype != torch.float32 or
                                           name not in SERVE_KERNELS):
                    continue            # phase 21 prefills in fp32
                for layout in (layouts[:1] if label in SV_LABELS
                               else layouts):
                    first = None
                    base = make_inputs(name, shape, dtype, device, seed=1,
                                       layout=layout, draw_on_device=p20)
                    if (dtype == torch.bfloat16 and name in WGMMA.values()
                            and not ssd_k and takes_wgmma(name, base)):
                        continue        # the wgmma instance's input
                    if name in SSD_WG and not ssd_runs(name, label, base,
                                                       device):
                        continue        # fp32, or (P, N) or rows of no
                        # wgmma instance
                    check(name not in WGMMA or device.type == "cpu"
                          or takes_wgmma(name, base),
                          f"{name} {label} {layout}: the inputs do not "
                          f"reach the wgmma instance")
                    for vlabel, kern, chunk, resolved in variants(
                            name, base, dtype, device):
                        if p20 and not resolved:
                            continue    # tuned and held by the autotuner
                        args = base if chunk is None else make_inputs(
                            name, shape, dtype, device, seed=1, layout=layout,
                            chunk=chunk, draw_on_device=p20)
                        run_plain = (plain if chunk is None else
                                     lambda *a, c=chunk: plain(*a, chunk=c))
                        err, ratio = compare(name, kern, run_plain, args,
                                             dtype, chunk)
                        if base_of(name) in FLASH and device.type == "cuda":
                            out = _flat(kern(*args))
                            first = first or out
                            check(all(torch.equal(a, b)
                                      for a, b in zip(first, out)),
                                  f"{name} {vlabel} {label}: tiles differ")
                        print(f"[check] {name:16s} {layout:3s} {label:6s} "
                              f"{str(dtype)[6:]:8s} {vlabel:16s} "
                              f"{'*' if resolved else ' '} shape={shape} "
                              f"max_abs_err={err:.3e} err/tol={ratio:.4f} "
                              f"deterministic=yes")
                        if (resolved and dtype == torch.float32
                                and label == reported_path(name)):
                            errors[name] = max(errors.get(name, 0.0), err)
                        if (resolved and dtype == torch.bfloat16
                                and label == reported_bf16(name)):
                            errors_bf16[name] = max(
                                errors_bf16.get(name, 0.0), err)
    return errors, errors_bf16


#: phase 3's and 4's flash shapes with fewer queries than keys, the
#: sequence shards of phase 17a: Sk keys and Sk / 2 queries at offsets
#: 0 (the first shard: Sq = Sk / 2 keys) and Sk / 2 (the last shard);
#: (head dim, heads, kv heads): gpt3-medium's and granite-moe's 64, a
#: GQA 128 (qwen2.5-3b's heads); windows 0 and 256 (the CPU rehearsal:
#: head dim 64 at Sk 64, window 16)
OFFSET_SK = {"cuda": 2048, "cpu": 64}
OFFSET_HEADS = ((64, 16, 8), (128, 16, 2))


def offset_shapes(device):
    """(label, shape, offset) of every phase 3 flash case at Sq < Sk."""
    on_card = device.type == "cuda"
    Sk = OFFSET_SK[device.type]
    Sq = Sk // 2
    win = 256 if on_card else 16
    return [(f"d{D}-w{window}-o{off}", (1, Sq, H, KV, D, window, Sq + off),
             off)
            for D, H, KV in (OFFSET_HEADS if on_card else OFFSET_HEADS[:1])
            for window in (0, win) for off in (0, Sk // 2)]


def _whole(args, off):
    """The same call over the whole sequence: ``args`` of a call with the
    queries the last Sq of Sk positions, its q (and dO, lse, delta)
    preceded by ``off`` rows (dO zero there, so those queries add
    nothing to dk and dv)."""
    import torch
    q, k, v = args[:3]
    g = torch.Generator(device="cpu").manual_seed(9)
    head = (torch.randn((q.shape[0], off, *q.shape[2:]), generator=g)
            .to(device=q.device, dtype=q.dtype))
    if len(args) == 4:
        return (torch.cat([head, q], 1), k, v, args[3])
    from repro_torch.kernels import ref
    qf = torch.cat([head, q], 1)
    gf = torch.cat([torch.zeros_like(head), args[3]], 1)
    lse = torch.cat([ref.flash_fwd_ref(qf, k, v, window=args[-1])[1]
                     [..., :off], args[4]], -1).contiguous()
    delta = torch.cat([torch.zeros_like(lse[..., :off]), args[5]],
                      -1).contiguous()
    return (qf, k, v, gf, lse, delta, args[-1])


def check_offset_flash(device, table):
    """Phase 3, the flash kernels with fewer queries than keys
    (``offset_shapes``): every built tile against its plain version in
    fp32 and bf16, rerun bitwise; on the card each also bitwise equal to
    the whole-sequence call's rows (``_whole``: out, lse and dq its last
    Sq rows, dk and dv all of them), which ties the offset path to the
    Sq == Sk one."""
    import torch
    for label, shape, off in offset_shapes(device):
        for dtype in (torch.float32, torch.bfloat16):
            for name in FLASH:
                plain = table[name][1]
                args = make_inputs(name, shape, dtype, device, seed=4)
                for vlabel, kern, _, resolved in variants(name, args, dtype,
                                                          device):
                    err, ratio = compare(name, kern, plain, args, dtype)
                    same = "-"
                    if device.type == "cuda" and off:
                        got = _flat(kern(*args))
                        whole = _flat(kern(*_whole(args, off)))
                        if name != "flash_bwd_dkdv":
                            whole = [whole[0][:, off:]] + [
                                t[..., off:] for t in whole[1:]]
                        check(all(torch.equal(a, b)
                                  for a, b in zip(got, whole)),
                              f"{name} {vlabel} {label} {dtype}: the offset "
                              f"call differs from the whole sequence's rows")
                        same = "yes"
                    print(f"[check] {name:16s} offset {label:14s} "
                          f"{str(dtype)[6:]:8s} {vlabel:16s} "
                          f"{'*' if resolved else ' '} Sq={shape[1]} "
                          f"Sk={shape[-1]} max_abs_err={err:.3e} "
                          f"err/tol={ratio:.4f} deterministic=yes "
                          f"bitwise_whole={same}")


# ----------------------------------------------------------------------
# Timing and bounds
# ----------------------------------------------------------------------
def time_ms(fn, args, device, iters):
    """Mean milliseconds per call: CUDA events around ``iters`` calls
    after a warm-up on the card; the host clock on the CPU rehearsal."""
    import torch
    for _ in range(3):
        fn(*args)
    if device.type == "cuda":
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn(*args)
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        fn(*args)
    return (time.perf_counter() - t0) * 1e3 / iters


def device_ms(fn, args, name, iters, tries=3):
    """(device milliseconds per call of kernel ``name``, the same per CUDA
    function): the events of its CUDA functions (``<name>_..kernel..`` in
    csrc/, e.g. the SSD kernels' three phases or the norm backward's row
    and dw kernels, each launched once a call) under torch.profiler over
    ``iters`` calls.  A session counts only if it recorded every such
    function exactly ``iters`` times: the profiler at times delivers a
    session's events late, in the next session, or not at all, so each
    try first runs an empty session that takes whatever an earlier one
    left behind, and a session short of events or holding others is run
    again, up to ``tries`` times.  (None, {}) where no session counts."""
    import re
    import torch
    from torch.profiler import ProfilerActivity, profile
    for _ in range(tries):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]):
            pass
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn(*args)
            torch.cuda.synchronize()
        per_fn, counts = {}, {}
        for evt in prof.key_averages():
            if name + "_" in evt.key and "kernel" in evt.key and evt.count:
                fn_name = re.search(r"(\w*kernel\w*)", evt.key).group(1)
                per_fn[fn_name] = per_fn.get(fn_name, 0.0) + getattr(
                    evt, "device_time_total",
                    getattr(evt, "cuda_time_total", 0.0)) / 1e3 / iters
                counts[fn_name] = counts.get(fn_name, 0) + evt.count
        if per_fn and all(c == iters for c in counts.values()):
            return sum(per_fn.values()), per_fn
    return None, {}


def _causal_pairs(S, window, Sk=None):
    """(q, k) pairs a causal (windowed) attention over S positions keeps;
    with Sk keys, the S queries are the last S of the Sk positions."""
    off = (Sk or S) - S
    return sum(min(i + off + 1, window) if window > 0 else i + off + 1
               for i in range(S))


def _ssd_work(name, shape, s, Q):
    """(bytes, flops) of one SSD kernel call.  Flops: the products of the
    reference's kernels, the intra-chunk [Q, Q] ones over the T =
    q(q+1)/2 causal pairs of a chunk's q rows, per (batch, head, chunk):
    forward 2T(N+P) + 4qPN, backward 2T(3N+2P) + 8qPN.  Bytes: x, B, C
    (one group when expanded), gy in ``s`` bytes, dt, A and the states
    in fp32; the forward writes y, the final state and cstates (the
    variant the training path runs), the backward dx, dB and dC per
    head, ddt and the dA partials; Q is the chunk."""
    b, S, H, P, N, expanded = shape
    nc = -(-S // Q)
    rows = [min(Q, S - c * Q) for c in range(nc)]
    tri = [q * (q + 1) // 2 for q in rows]
    bc_in = 2 * b * S * (1 if expanded else H) * N * s
    xn, dtn, state = b * S * H * P, b * S * H * 4, b * H * P * N * 4
    if name == "ssd_fwd":
        flops = sum(2 * t * (N + P) + 4 * q * P * N for t, q in zip(tri, rows))
        nbytes = 2 * xn * s + dtn + H * 4 + bc_in + state * (1 + nc)
    else:
        flops = sum(2 * t * (3 * N + 2 * P) + 8 * q * P * N
                    for t, q in zip(tri, rows))
        nbytes = (3 * xn * s + 2 * dtn + H * 4 + bc_in + state * (1 + nc)
                  + 2 * b * S * H * N * s + b * H * nc * 4)
    return nbytes, flops * b * H


def bound(name, shape, dtype, chunk=64):
    """(ms, 'bytes' | 'operations'): each input read once, each output
    written once, over 3.35 TB/s; operations over the type's peak."""
    nbytes, ops = work(name, shape, dtype, chunk)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_FLOPS[str(dtype)] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def tensor_core_bound(name, shape, dtype, chunk=64):
    """ms of a TENSOR_CORE kernel's operations at its design's
    tensor-core rate (fp32: 3 x ops / 495 TFLOP/s; bf16: ops / 989)."""
    return work(name, shape, dtype, chunk)[1] / TC_PEAK_FLOPS[str(dtype)] * 1e3


def work(name, shape, dtype, chunk=64):
    """(bytes, flops) of one call.  The flash kernels count their matrix
    products (2 flops per multiply-add) over the (q, k) pairs the causal
    mask keeps: 2 products in the forward, 3 in dq, 4 in dk/dv; the SSD
    kernels as ``_ssd_work`` at ``chunk``."""
    import torch
    name = base_of(name)
    s = torch.tensor([], dtype=dtype).element_size()
    if name in SSD:
        nbytes, ops = _ssd_work(name, shape, s, chunk)
    elif name == "add_rmsnorm_fwd":
        M, d = shape
        nbytes, ops = (4 * M * d + d) * s, 6 * M * d        # x, r in; res, h out
    elif name == "add_rmsnorm_bwd":
        M, d = shape
        nbytes, ops = (4 * M * d + d) * s + 4 * d, 12 * M * d
    elif name in FLASH:
        B, S, H, KV, D, window, *rest = shape
        Sk = rest[0] if rest else S
        qn, kvn, rows = B * S * H * D, B * Sk * KV * D, B * H * S * 4
        nbytes, products = {
            "flash_fwd": ((2 * qn + 2 * kvn) * s + rows, 2),
            "flash_bwd_dq": ((3 * qn + 2 * kvn) * s + 2 * rows, 3),
            "flash_bwd_dkdv": ((2 * qn + 4 * kvn) * s + 2 * rows, 4)}[name]
        ops = products * 2 * D * B * H * _causal_pairs(S, window, Sk)
    else:
        M, K, N = shape
        nbytes, ops = (M * K + K * N + M * N + N) * s, 2 * M * N * K
    return nbytes, ops


def sdpa_backward_ms(args, device, iters):
    """Library yardstick of the flash backward pair: causal
    scaled_dot_product_attention forward + backward, minus its forward."""
    import torch
    q, k, v, dout, _, _, window = args
    leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]

    def fwd_bwd():
        out = sdpa_forward(*leaves, window)
        return torch.autograd.grad(out, leaves, dout.transpose(1, 2))
    return (time_ms(fwd_bwd, (), device, iters)
            - time_ms(sdpa_forward, (*leaves, window), device, iters))


def time_offset_flash(device, table, iters):
    """Phase 4, the flash kernels at phase 17a's shard shapes (gpt3-
    medium's 16 heads of 64, one sequence, Sq = Sk / 2 against Sk = Sk /
    2 and Sk) beside the whole sequence of Sk, fp32: kernel, plain,
    library (SDPA with the mask aligned to the keys' end) and the bound
    over the causal pairs each computes."""
    import torch
    Sk = OFFSET_SK[device.type]
    for shape in ((1, Sk // 2, 16, 16, 64, 0), (1, Sk // 2, 16, 16, 64, 0, Sk),
                  (1, Sk, 16, 16, 64, 0)):
        for name in FLASH:
            kern, plain, _ = table[name]
            args = make_inputs(name, shape, torch.float32, device, seed=5)
            ms = time_ms(kern, args, device, iters)
            plain_ms = time_ms(plain, args, device, iters)
            lib_ms = (time_ms(sdpa_forward, args, device, iters)
                      if name == "flash_fwd" else
                      sdpa_backward_ms(args, device, iters)
                      if name == "flash_bwd_dq" else None)
            bms, by = bound(name, shape, torch.float32)
            tc = tensor_core_bound(name, shape, torch.float32)
            Sq, Sk = shape[1], shape[-1] if len(shape) > 6 else shape[1]
            sdpa = (" (SDPA fwd+bwd - fwd: dq and dk/dv together)"
                    if name == "flash_bwd_dq" else "")
            print(f"[time] {name:16s} Sq={Sq} Sk={Sk} fp32: kernel "
                  f"{ms:.4f} ms, plain {plain_ms:.4f} ms, library "
                  f"{'-' if lib_ms is None else f'{lib_ms:.4f} ms'}{sdpa}, "
                  f"bound {bms:.4f} ms ({by}, {_causal_pairs(Sq, 0, Sk)} "
                  f"causal pairs a head), tensor-core bound {tc:.4f} ms "
                  f"(3xTF32)")


def time_kernels(device, table, shapes, iters):
    """Phase 4 at each path's shape, in the dtype the path runs: fp32,
    and bf16 at phase 20's shapes (``P20_LABELS``).  Returns ({name: the
    row at the reported path's shape}, {name: the bf16 row at its
    reported phase 20 shape})."""
    import torch
    from repro_torch.kernels import autotune
    on_card = device.type == "cuda"
    backend = autotune.backend_of(device)
    rows, rows_bf16 = {}, {}
    for name, (kern, plain, lib) in table.items():
        ssd_k = base_of(name) in SSD
        for label, shape in _shapes(shapes, name):
            if label not in PATH_LABELS + TP_LABELS + P20_LABELS + SV_LABELS:
                continue
            if label in SV_LABELS and name not in SERVE_KERNELS:
                continue
            if not ssd_k and (label in P20_LABELS) != (name in WGMMA) and (
                    name in WGMMA or name in WGMMA.values()):
                continue    # phase 20's shapes run the wgmma instances only
            # the SSD wgmma pair also in bf16 at the mamba path's shape
            dtypes = ((torch.bfloat16,) if label in P20_LABELS or (
                name in SSD_WG and label == PATHS[8][0]) else (torch.float32,))
            for dtype in dtypes:
                dname = "bf16" if dtype == torch.bfloat16 else "fp32"
                # phase 20's shapes: fewer calls of the plain versions (10-50
                # ms a call)
                n = max(2, iters // 5) if label in P20_LABELS else iters
                tc_name = "1 bf16 product" if dname == "bf16" else "3xTF32"
                cfg = shape_config(backend, base_of(name), shape, dtype)
                args = make_inputs(name, shape, dtype, device, seed=2,
                                   draw_on_device=label in P20_LABELS)
                if ssd_k and not ssd_runs(name, label, args, device):
                    continue    # the call runs the SSD pair's other instance
                chunk = ssd_chunk(args[0], args[3]) if ssd_k else 64
                ms = time_ms(kern, args, device, iters)
                # at phase 20's shapes the profiler's time only where events
                # time the host (the norms) or it splits the phases (the SSD)
                profiled = on_card and (label not in P20_LABELS
                                        or name not in FLASH + ("gemm_bias",)
                                        ) and (name not in WGMMA or ssd_k)
                dev_ms, phases = (device_ms(kern, args, base_of(name), iters)
                                  if profiled else (None, {}))
                plain_ms = time_ms(plain, args, device, n)
                if base_of(name) in FLASH[1:]:
                    lib_ms = sdpa_backward_ms(args, device, iters)
                else:
                    lib_ms = (time_ms(lib, args, device, iters)
                              if lib is not None else None)
                bms, by = bound(name, shape, dtype, chunk)
                tc = (f", tensor-core bound "
                      f"{tensor_core_bound(name, shape, dtype, chunk):.4f}"
                      f" ms ({tc_name})" if name in TENSOR_CORE else "")
                row = {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                       "bound_ms": bms, "bound_by": by}
                if label == reported_path(name) and dtype == torch.float32:
                    rows[name] = row
                if label == reported_bf16(name):
                    rows_bf16[name] = {"shape": list(shape), **row}
                print(f"[time] {name:16s} fwd {label:5s} shape={shape} {dname}: "
                      f"kernel {ms:.4f} ms (profiler device time "
                      f"{'not measured' if dev_ms is None else f'{dev_ms:.4f} ms'}), "
                      f"plain {plain_ms:.4f} ms, library "
                      f"{'-' if lib_ms is None else f'{lib_ms:.4f} ms'}"
                      f"{' (SDPA fwd+bwd - fwd: dq and dk/dv together)' if base_of(name) in FLASH[1:] else ''}, "
                      f"bound {bms:.4f} ms ({by}){tc}; config "
                      f"{cfg['fwd'] if base_of(name) == 'gemm_bias' else cfg}")
                if len(phases) > 1:
                    print(f"[time] {name:16s} phases (profiler device ms): "
                          + ", ".join(f"{k} {v:.4f}" for k, v in phases.items()))
                if base_of(name) != "gemm_bias" or label in SV_LABELS:
                    continue
                for layout in ("dx", "dW"):
                    a = make_inputs(name, shape, dtype, device, seed=2,
                                    layout=layout,
                                    draw_on_device=label in P20_LABELS)
                    sh = ((shape[0], shape[2], shape[1]) if layout == "dx"
                          else (shape[1], shape[0], shape[2]))
                    kms = time_ms(kern, a, device, iters)
                    dms = (device_ms(kern, a, name, iters)[0]
                           if profiled else None)
                    pms = time_ms(plain, a, device, n)
                    lms = time_ms(torch.matmul, a[:2], device, iters)
                    bl, byl = bound(name, sh, dtype)
                    tcl = tensor_core_bound(name, sh, dtype)
                    print(f"[time] {name:16s} {layout:3s} {label:5s} shape={sh} "
                          f"{dname}: kernel {kms:.4f} ms (profiler device time "
                          f"{'not measured' if dms is None else f'{dms:.4f} ms'}), "
                          f"plain {pms:.4f} ms, library {lms:.4f} ms, "
                          f"bound {bl:.4f} ms ({byl}), tensor-core bound "
                          f"{tcl:.4f} ms ({tc_name}); config {cfg[layout]}")
    return rows, rows_bf16


# ----------------------------------------------------------------------
# End-to-end agreement on small models, then the three paths
# ----------------------------------------------------------------------
def _loss_and_grads(device, arch, seq, **model_kw):
    import torch
    from repro_torch.models import Model
    from repro_torch.utils.tree import tree_leaves, tree_unflatten_like
    g = torch.Generator(device="cpu").manual_seed(3)
    batch = {key: torch.randint(0, arch.vocab_size, (2, seq), generator=g
                                ).to(device) for key in ("tokens", "labels")}
    batch["mask"] = (torch.rand((2, seq), generator=g) >= 0.3).float().to(
        device)
    model = Model(arch, dtype=torch.float32, **model_kw)
    params = model.init(torch.Generator(device=device).manual_seed(0))
    leaves = [t.detach().requires_grad_(True) for t in tree_leaves(params)]
    loss, _ = model.loss(tree_unflatten_like(params, leaves), batch)
    return loss.detach(), torch.autograd.grad(loss, leaves)


def check_small_model(device):
    """Phase 5: the same small models, weights and batches (a 0/1 mask
    over about 30 % of the positions) through the kernels and through
    plain ops; remat and the chunked CE with the kernels inside against
    their absence.  Loss to 1e-5 relative, gradients to 1e-4; then
    decode against the kernels' forward (check_decode)."""
    from repro_torch.configs import get_arch, reduced

    def small(name):
        return reduced(get_arch(name), layers=2, d_model=128, vocab=512)
    gpt, qwen, mamba, hymba, granite, qmoe = (small(n) for n in (
        "gpt3_medium", "qwen2_5_3b", "mamba2_780m", "hymba_1_5b",
        "granite_moe_1b_a400m", "qwen2_moe_a2_7b"))
    kern = dict(attn_impl="kernel", fuse="fused", ssd_impl="kernel")
    plain = dict(attn_impl="naive", fuse="none", ssd_impl="chunked")
    cases = [  # (label, arch, seq, Model kwargs through kernels, plain)
        ("gpt3-medium fused vs unfused", gpt, 64,
         dict(attn_impl="naive", fuse="fused"),
         dict(attn_impl="naive", fuse="none")),
        ("gpt3-medium flash vs naive", gpt, 64,
         dict(attn_impl="kernel", fuse="fused"),
         dict(attn_impl="naive", fuse="fused")),
        ("qwen2.5-3b (GQA 4/2, QKV bias) S=200 flash vs naive", qwen, 200,
         dict(attn_impl="kernel", fuse="fused"),
         dict(attn_impl="naive", fuse="fused")),
        ("mamba2 (16 SSD heads, P 16, N 16) S=200 SSD kernels vs chunked",
         mamba, 200, dict(attn_impl="naive", fuse="fused", ssd_impl="kernel"),
         dict(attn_impl="naive", fuse="fused", ssd_impl="chunked")),
        ("hymba (attention + Mamba heads) S=200 all kernels vs plain ops",
         hymba, 200, kern, plain),
        ("granite-moe (4 experts top-2) S=200 all kernels vs plain ops",
         granite, 200, kern, plain),
        ("qwen2-moe (shared expert, QKV bias) S=200 all kernels vs plain "
         "ops", qmoe, 200, kern, plain),
        ("granite-moe remat full vs none, kernels in both", granite, 200,
         dict(kern, remat=True), dict(kern, remat=False)),
        ("hymba remat dots vs none, kernels in both", hymba, 200,
         dict(kern, remat=True, remat_policy="dots"),
         dict(kern, remat=False)),
        ("granite-moe chunked CE (chunks of 64) vs whole CE, kernels in "
         "both", granite, 200, dict(kern, loss_chunk=64), kern),
    ]
    for label, arch, seq, through, ref_kw in cases:
        lk, gk = _loss_and_grads(device, arch, seq, **through)
        ln, gn = _loss_and_grads(device, arch, seq, **ref_kw)
        check(math.isfinite(float(lk)), f"small model {label}: non-finite loss")
        check(abs(float(lk) - float(ln)) <= 1e-5 * abs(float(ln)) + 1e-6,
              f"small model {label}: loss {float(lk)} vs {float(ln)}")
        worst = max(float((a - b).abs().max()) for a, b in zip(gk, gn))
        check(worst <= 1e-4,
              f"small model {label}: gradient max abs diff {worst:.3e}")
        print(f"[model] {label}: loss {float(lk):.6f} vs {float(ln):.6f}, "
              f"gradient max abs diff {worst:.3e}")
    check_decode(device, granite, hymba)


def decode_gap(device, arch, S=40):
    """Max abs difference between the logits of token-by-token decode
    (plain products, the KV cache; the Mamba conv and SSM states) and
    those of the full forward through the kernels, over S positions."""
    import torch
    from repro_torch.models import Model
    model = Model(arch, dtype=torch.float32, attn_impl="kernel",
                  ssd_impl="kernel")
    params = model.init(torch.Generator(device=device).manual_seed(0))
    g = torch.Generator(device="cpu").manual_seed(4)
    tokens = torch.randint(0, arch.vocab_size, (2, S), generator=g).to(device)
    with torch.no_grad():
        full, _ = model.forward(params, tokens)
        cache = model.init_cache(2, S, device=device)
        steps = []
        for t in range(S):
            logits, cache = model.decode_step(params, tokens[:, t:t + 1],
                                              cache, t)
            steps.append(logits)
    return float((torch.cat(steps, 1) - full).abs().max())


def check_decode(device, granite, hymba):
    """Decode against the kernels' forward at every one of 40 positions:
    granite-moe, and hymba with its window cut to 16, so that the ring
    buffer wraps twice.  Logits to 1e-5."""
    import dataclasses
    for label, arch in (("granite-moe", granite),
                        ("hymba window 16", dataclasses.replace(
                            hymba, sliding_window=16))):
        worst = decode_gap(device, arch)
        check(worst <= 1e-5, f"decode {label}: logits max abs diff "
              f"{worst:.3e} against the forward")
        print(f"[decode] {label}: 40 positions one at a time vs the "
              f"kernels' forward, logits max abs diff {worst:.3e}")


def run_path(device, phase, kernels, exact=None):
    """Phases 6-8 and 10: one training run through a failure, with every
    launch count set to 0 just before it.  Returns the run's launch
    counts; on the card every kernel in ``kernels`` must have launched
    (``exact[name]`` times, where given)."""
    import gc
    import torch
    from repro_torch.kernels import build
    from repro_torch.launch import train
    label, card_argv, cpu_argv = PATHS[phase]
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    build.reset_launches()
    t0 = time.perf_counter()
    out = train.main(card_argv if device.type == "cuda" else cpu_argv)
    phase_s = time.perf_counter() - t0
    launches = dict(build.LAUNCHES)
    losses = out["losses"]
    check(all(math.isfinite(l) for l in losses), f"non-finite loss {losses}")
    check(losses[-1] < losses[0], f"loss did not decrease: {losses}")
    check(all(d == 0.0 for d in out["divergences"]),
          f"replica divergence {out['divergences']}")
    rec = out["recovery"]
    check(rec is not None, "no failure was injected")
    check(set(out["builds_after_step"]) == {rec["builds_before"]},
          f"program builds changed across fail -> recover -> step: "
          f"{rec['builds_before']} -> {out['builds_after_step']}")
    if device.type == "cuda":
        check(all(launches[k] > 0 for k in kernels),
              f"a kernel never launched on the {label} path: {launches}")
        check(exact is None or all(launches[k] == n for k, n in exact.items()),
              f"{label} path: {launches}, expected {exact}")
        mem = torch.cuda.max_memory_allocated() / 2**30
    else:
        mem = float("nan")
    print(f"[{label}] step seconds (host clock around synchronize): "
          f"{[round(s, 4) for s in out['step_seconds']]}")
    print(f"[{label}] recovery {rec['seconds']:.3f}s, builds "
          f"{rec['builds_before']} -> {out['builds_after_step'][-1]}, "
          f"max_memory_allocated {mem:.2f} GiB, phase {phase_s:.1f}s "
          f"(plan, build, warm, {len(losses)} steps), losses "
          f"{[round(l, 4) for l in losses]}, launches {launches}")
    return launches


#: phase 9's training setup (phase 7's: gpt3-medium at sequence 2048)
LIFECYCLE = dict(nodes=5, f=1, n0=2, global_batch=16, microbatch=2,
                 seq_len=2048, cpu_seq_len=32, cpu_layers=2)
#: tests/test_executor.py's fp32 tolerance (tree_allclose_ulp)
EXECUTOR_TOL = dict(atol=5e-7, rtol=5e-4)


def _alloc_retries():
    """cudaMalloc retries after freeing the allocator's cache (0 off
    the card)."""
    import torch
    if not torch.cuda.is_available():
        return 0
    return torch.cuda.memory_stats().get("num_alloc_retries", 0)


def run_lifecycle(device):
    """Phase 9: train -> fail -> recover -> join -> snapshot -> save
    (async, under a step) -> restore -> continue, compiled and eager, at
    phase 7's configuration.  Returns the phase's launch counts."""
    import gc
    import shutil
    import tempfile
    import torch
    from repro_torch.ckpt import CheckpointManager
    from repro_torch.configs import get_arch, reduced
    from repro_torch.core import EngineConfig, OobleckEngine, build_profile
    from repro_torch.data import ByteCorpus, GlobalBatchDispenser
    from repro_torch.kernels import build
    from repro_torch.launch.train import _TEXT, microbatches
    from repro_torch.models import Model
    from repro_torch.optim import adamw
    from repro_torch.runtime import HeteroTrainer, track_compiles
    from repro_torch.runtime.executor import avals_of
    on_card = device.type == "cuda"
    cfg = LIFECYCLE
    arch = get_arch("gpt3-medium")
    seq = cfg["seq_len"]
    if not on_card:
        arch, seq = reduced(arch, layers=cfg["cpu_layers"]), cfg["cpu_seq_len"]
    mb = cfg["microbatch"]
    model = Model(arch, dtype=torch.float32, attn_impl="kernel")
    engine = OobleckEngine(
        build_profile(arch, microbatch=mb, seq_len=seq),
        [f"node{i}" for i in range(cfg["nodes"])],
        EngineConfig(fault_tolerance=cfg["f"],
                     global_batch=cfg["global_batch"], microbatch=mb,
                     gpus_per_node=1, n0_override=cfg["n0"]))
    opt_cfg = adamw.AdamWConfig(lr=3e-3, warmup_steps=0, weight_decay=0.0)

    def sync():
        if on_card:
            torch.cuda.synchronize()

    def step(trainer, disp, label):
        """One step; (loss, seconds to its synchronize, bytes of device
        memory the step took above what was allocated before it)."""
        batches = disp.next_step(engine.batch.minibatch_sizes())
        sync()
        if on_card:
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        loss = float(trainer.step([microbatches(b, mb) for b in batches])
                     ["loss"])
        sync()
        secs = time.perf_counter() - t0
        div = trainer.replica_divergence()
        check(math.isfinite(loss), f"lifecycle {label}: loss {loss}")
        check(div == 0.0, f"lifecycle {label}: replica divergence {div}")
        extra = (torch.cuda.max_memory_allocated() - base) if on_card else 0
        print(f"[lifecycle] {label}: loss {loss!r}, {secs:.4f}s, "
              f"divergence 0, pipelines "
              f"{[i.template.num_nodes for i in engine.instances]}")
        return loss, secs, extra

    params = model.init(torch.Generator(device=device).manual_seed(0))
    a = HeteroTrainer(model, engine, params, opt_cfg)
    del params
    a.warm_templates()
    disp = GlobalBatchDispenser(ByteCorpus(_TEXT * 50, seq_len=seq))
    build.reset_launches()
    step(a, disp, "A step 0")
    builds = a.cache.stats.compiles
    with track_compiles() as log:
        victim = engine.instances[0].nodes[-1]
        t0 = time.perf_counter()
        info = a.recover({victim})
        sync()
        rec_s = time.perf_counter() - t0
        step(a, disp, f"A step 1 (after killing {victim})")
        t0 = time.perf_counter()
        jinfo = a.join(["fresh0"])
        sync()
        join_s = time.perf_counter() - t0
        step(a, disp, "A step 2 (after a join)")
    check(log.backend_compiles == 0 and a.cache.stats.compiles == builds,
          f"lifecycle: {log.backend_compiles} builds across fail -> recover "
          f"-> join -> step")
    print(f"[lifecycle] replica recovery {rec_s:.4f}s copying "
          f"{info['copied_bytes']} B; join {join_s:.4f}s copying "
          f"{jinfo['copied_bytes']} B; builds {builds} -> "
          f"{a.cache.stats.compiles}")

    ckdir = tempfile.mkdtemp(prefix="oobleck_chip_ckpt_")
    try:
        mgr = CheckpointManager(ckdir, num_layers=arch.num_layers)
        data_state = disp.state()
        t0 = time.perf_counter()
        snap = a.snapshot(data_state, 0)
        sync()
        snap_s = time.perf_counter() - t0
        template = avals_of(snap.params)
        template_opt = adamw.AdamWState(avals_of(snap.opt_state.step),
                                        avals_of(snap.opt_state.m),
                                        avals_of(snap.opt_state.v))
        t0 = time.perf_counter()
        mgr.save(snap)
        save_s = time.perf_counter() - t0
        del snap
        loss_a, secs_a, _ = step(a, disp, "A step 3 (under the async write)")
        t0 = time.perf_counter()
        mgr.wait()
        wait_s = time.perf_counter() - t0
        written = sum(os.path.getsize(os.path.join(mgr.shard_dir, f))
                      for f in os.listdir(mgr.shard_dir))
        sec = mgr.seconds
        print(f"[lifecycle] checkpoint: snapshot {snap_s:.4f}s (assembled "
              f"on the device), save() blocked {save_s:.4f}s (device -> "
              f"host copy {sec['host_copy']:.4f}s, hashes "
              f"{sec['hash']:.4f}s), writer {sec['write']:.4f}s, wait "
              f"{wait_s:.4f}s after the step, {written} B written in "
              f"{mgr.stats['saved_shards']} shards, "
              f"{mgr.stats['skipped_shards']} skipped")
        hashes_a = mgr.hashes(a.snapshot(disp.state(), 0))
        engine.attach_executor(None)
        del a
        gc.collect()

        t0 = time.perf_counter()
        restored = mgr.restore(template, template_opt, device=device)
        sync()
        restore_s = time.perf_counter() - t0
        check(restored.step == 3 and restored.data_state == data_state,
              f"lifecycle: restored step {restored.step}, data "
              f"{restored.data_state}")
        print(f"[lifecycle] restore {restore_s:.4f}s onto {device}; "
              f"replica recovery {rec_s:.4f}s against checkpoint "
              f"save + wait + restore {save_s + wait_s + restore_s:.4f}s")

        def restored_trainer(mode):
            tr = HeteroTrainer(model, engine, restored.params, opt_cfg,
                               mode=mode, opt_state=restored.opt_state)
            d = GlobalBatchDispenser(ByteCorpus(_TEXT * 50, seq_len=seq))
            d.restore(restored.data_state)
            return tr, d
        b, disp_b = restored_trainer("compiled")
        loss_b, _, extra_b = step(b, disp_b, "B step 3 (restored)")
        check(loss_b == loss_a, f"lifecycle: B's step-3 loss {loss_b!r} "
              f"!= A's {loss_a!r}")
        check(mgr.hashes(b.snapshot(disp_b.state(), 0)) == hashes_a,
              "lifecycle: B's state after step 3 differs from A's")
        engine.attach_executor(None)
        del b
        gc.collect()
        e, disp_e = restored_trainer("eager")
        del restored
        retries = _alloc_retries()
        loss_e, secs_e, extra_e = step(e, disp_e, "eager step 3 (restored)")
        retries = _alloc_retries() - retries
        tol = EXECUTOR_TOL["atol"] + EXECUTOR_TOL["rtol"] * abs(loss_a)
        check(abs(loss_e - loss_a) <= tol,
              f"lifecycle: eager loss {loss_e!r} vs A's {loss_a!r}")
        # the first eager step also grows the allocator's pool for the
        # walker's larger working set; the next one is the steady time
        _, secs_e4, _ = step(e, disp_e, "eager step 4")
        engine.attach_executor(None)
        del e
        gc.collect()
    finally:
        shutil.rmtree(ckdir, ignore_errors=True)
    launches = dict(build.LAUNCHES)
    if on_card:
        check(all(launches[k] > 0 for k in FUSED + FLASH),
              f"a kernel never launched in the lifecycle: {launches}")
    print(f"[lifecycle] B's step-3 loss and state hashes equal A's bitwise; "
          f"eager step 3 {secs_e:.4f}s ({retries} allocator retries), step 4 "
          f"{secs_e4:.4f}s, against compiled {secs_a:.4f}s; loss "
          f"{'bitwise equal' if loss_e == loss_a else 'within tolerance'}"
          f" ({loss_e!r} vs {loss_a!r}); memory above the state: eager "
          f"{extra_e / 2**30:.2f} GiB, compiled {extra_b / 2**30:.2f} GiB; "
          f"launches {launches}")
    return launches


#: phase 11's serving setup (``repro_torch.launch.serve``'s engine: 6
#: nodes, f 1, n0 2); the CPU rehearsal cuts the lengths and the depth.
#: On the card the depth is cut to 8 of qwen3-1.7b's 28 layers: the
#: phase's ticks are host-bound per layer, and the cut (14 since phase
#: 19, 8 since phases 15b and 21) keeps the script inside its time
#: limit.
SERVING = dict(arch="qwen3-1.7b", nodes=6, slots=4, prompt_len=64,
               decode_steps=32, requests=16, temperature=0.8, fail_at=8,
               layers=8, cpu_prompt_len=8, cpu_decode_steps=8,
               cpu_layers=2)


def run_serving(device):
    """Phase 11: serve through a node failure; returns the phase's
    launch counts."""
    import dataclasses
    import gc
    import numpy as np
    import torch
    from repro_torch.configs import get_arch, reduced
    from repro_torch.kernels import build
    from repro_torch.launch import serve
    from repro_torch.models import Model
    from repro_torch.runtime import (ProgramCache, track_compiles,
                                     track_host_transfers)
    from repro_torch.runtime.serve_exec import SamplingParams, ServeExecutor
    from repro_torch.utils import prng
    on_card = device.type == "cuda"
    cfg = SERVING
    arch = dataclasses.replace(get_arch(cfg["arch"]),
                               num_layers=cfg["layers"])
    P, N = cfg["prompt_len"], cfg["decode_steps"]
    if not on_card:
        arch = reduced(arch, layers=cfg["cpu_layers"])
        P, N = cfg["cpu_prompt_len"], cfg["cpu_decode_steps"]
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    build.reset_launches()
    t_phase = time.perf_counter()
    model = Model(arch, dtype=torch.float32, remat=False)
    params = model.init(torch.Generator(device=device).manual_seed(0))
    sample_key = prng.fold_in(prng.prng_key(0, device), 2)
    if on_card:
        # init stacks the blocks from per-block tensors: its peak holds
        # two copies of them, so serving's own peak is taken after it
        init_mem = torch.cuda.max_memory_allocated() / 2**30
        torch.cuda.reset_peak_memory_stats()
    else:
        init_mem = float("nan")
    prompts = serve.make_prompts(arch.vocab_size, cfg["requests"], P, 0)
    cache = ProgramCache()

    def executor(temperature):
        engine = serve.build_serving_engine(
            arch, nodes=[f"node{i}" for i in range(cfg["nodes"])])
        return ServeExecutor(
            model, params, engine, num_slots=cfg["slots"], max_len=P + N,
            max_new_cap=N, sampling=SamplingParams(temperature),
            sample_key=sample_key, cache=cache)

    def leg(fail_at):
        t0 = time.perf_counter()
        ex = executor(cfg["temperature"])
        warm_s = time.perf_counter() - t0
        with track_compiles() as log:
            wall_s = serve.serve_trace(ex, prompts, N, fail_at)
        check(len(ex.completed) == len(prompts),
              f"serving: {len(ex.completed)}/{len(prompts)} requests "
              f"completed (fail_at {fail_at})")
        tokens = sum(r.max_new for r in ex.completed)
        ttft = [r.first_token_s - r.arrival_s for r in ex.completed]
        label = f"failed at tick {fail_at}" if fail_at >= 0 else "unfailed"
        print(f"[serve] {label}: replicas {len(ex.replicas)}, warm "
              f"{warm_s:.3f}s, "
              f"{tokens} tokens in {wall_s:.3f}s ({tokens / wall_s:.1f} "
              f"tok/s, {wall_s / tokens * 1e3:.2f} ms/token), ttft p50 "
              f"{serve.percentile(ttft, 50) * 1e3:.1f} ms p99 "
              f"{serve.percentile(ttft, 99) * 1e3:.1f} ms, ticks "
              f"{ex.ticks}, builds in the trace {log.backend_compiles}")
        return ex, {r.rid: r.tokens for r in ex.completed}, log

    ex_a, streams_a, _ = leg(-1)
    replicas_a = len(ex_a.replicas)
    del ex_a
    ex_b, streams_b, log = leg(cfg["fail_at"])
    check(log.backend_compiles == 0,
          f"serving: {log.backend_compiles} builds across fail -> recover "
          f"-> drain")
    check(all(np.array_equal(streams_b[rid], toks)
              for rid, toks in streams_a.items()),
          "serving: a stream differs between the unfailed and failed legs")
    rec = ex_b.last_recovery
    check(rec is not None and rec["replayed"] + rec["migrated"] >= 1,
          f"serving: the failure moved no request: {rec}")
    print(f"[serve] recovery: downtime {rec['downtime_s'] * 1e3:.3f} ms, "
          f"replicas {replicas_a} -> {rec['replicas']}, replayed "
          f"{rec['replayed']}, migrated {rec['migrated']}, copy bytes "
          f"{rec['copy_bytes']} (modeled transfer "
          f"{rec['transfer_makespan_s'] * 1e3:.3f} ms); {len(streams_a)} "
          f"streams bitwise equal to the unfailed leg's")
    del ex_b

    # two pure decode ticks: no admission, no request finishing
    ex = executor(cfg["temperature"])
    for p in prompts[:2]:
        ex.submit(p, max_new=N)
    ex.tick()
    ex.synchronize()
    with track_host_transfers(device) as hlog:
        ex.tick()
        ex.tick()
    ex.synchronize()
    check(hlog.device_to_host == 0,
          f"serving: {hlog.device_to_host} device->host reads in two pure "
          f"decode ticks")
    del ex

    # greedy: the executor's stream against a plain loop of decode_step
    # at the executor's batch (the request in row 0, the others idle)
    ex = executor(0.0)
    ex.submit(prompts[0], max_new=N)
    ex.drain()
    got = ex.completed[0].tokens
    B = cfg["slots"]
    plain = model.init_cache(B, P + N, device=device)
    toks = [int(t) for t in prompts[0]]
    want = []
    with torch.no_grad():
        for t in range(P + N - 1):
            col = torch.zeros((B, 1), dtype=torch.int32, device=device)
            col[0, 0] = toks[t]
            logits, plain = model.decode_step(params, col, plain, t)
            if t >= P - 1:
                want.append(int(torch.argmax(logits[0, 0])))
                toks.append(want[-1])
    check(np.array_equal(got, np.asarray(want[:N], np.int32)),
          f"serving: greedy stream {got.tolist()} != plain decode "
          f"{want[:N]}")
    del ex
    launches = dict(build.LAUNCHES)
    check(all(n == 0 for n in launches.values()),
          f"serving launched a kernel: {launches}")
    mem = (torch.cuda.max_memory_allocated() / 2**30 if on_card
           else float("nan"))
    print(f"[serve] greedy stream equals a plain decode_step loop "
          f"({N} tokens); two pure decode ticks read nothing back "
          f"(sync debug mode \"error\" on the card); kernel launches "
          f"{launches}; max_memory_allocated {mem:.2f} GiB serving, "
          f"{init_mem:.2f} GiB during init, phase "
          f"{time.perf_counter() - t_phase:.1f}s")
    return launches


#: phase 12's multi-process setup: phase 7's gpt3-medium (full width,
#: sequence 2048, flash kernels, 5 nodes, f 1, n0 2, global batch 16) at
#: microbatch 1, in 3 worker processes with the reference test's
#: hosting: rank 1 hosts n2 alone, a non-lead member of replica (n0, n1,
#: n2), so killing it shrinks the replica rank 0 leads and the rebind
#: pulls layer state from rank 2.  Microbatch 1: the two lead workers
#: run their replicas' pipelines at the same time on the one card.
#: Depth cut to 6 of 24 blocks: the phase's time is mostly the star
#: design's socket traffic, which scales with the depth, and the cut
#: (12 since phase 19, 6 since phases 15b and 21) keeps the script
#: inside its time limit.
MULTIPROC = dict(nodes=5, f=1, n0=2, global_batch=16, microbatch=1,
                 seq_len=2048, layers=6, cpu_seq_len=32, cpu_layers=2,
                 cpu_microbatch=2,
                 hosting={"n0": 0, "n1": 0, "n2": 1, "n3": 2, "n4": 2})
#: launches summed over phase 12's workers: each norm and flash kernel
#: once per layer and microbatch, 12 layers x 16 microbatches x 4 steps;
#: gemm_bias three times (the fused QKV's forward, dx and dW)
MULTIPROC_LAUNCHES = {k: MULTIPROC["layers"] * 16 * 4 for k in
                      ("add_rmsnorm_fwd", "add_rmsnorm_bwd", "flash_fwd",
                       "flash_bwd_dq", "flash_bwd_dkdv")}
MULTIPROC_LAUNCHES["gemm_bias"] = 3 * MULTIPROC["layers"] * 16 * 4


def _tree_hashes(tree):
    """sha256 of each leaf's bytes, in flatten order."""
    import hashlib
    from repro_torch.runtime.coordination import leaf_bytes
    from repro_torch.utils.tree import tree_leaves
    return [hashlib.sha256(leaf_bytes(t)).hexdigest() for t in tree_leaves(tree)]


class _MemoryPeak:
    """Polls ``nvidia-smi``'s memory.used (MiB) on a thread: the card's
    peak across every process on it."""

    def __init__(self, on_card):
        import threading
        self.peak, self._stop = 0, threading.Event()
        self._thread = (threading.Thread(target=self._poll, daemon=True)
                        if on_card else None)
        if self._thread:
            self._thread.start()

    def _poll(self):
        while not self._stop.wait(0.5):
            r = subprocess.run(["nvidia-smi", "--query-gpu=memory.used",
                                "--format=csv,noheader,nounits"],
                               capture_output=True, text=True)
            if r.returncode == 0:
                self.peak = max(self.peak,
                                int(r.stdout.strip().splitlines()[0]))

    def stop(self):
        self._stop.set()
        if self._thread:
            self._thread.join()
        return self.peak


def run_multiprocess(device):
    """Phase 12: Oobleck's multi-process lifecycle.  Leg 1, the
    single-process HeteroTrainer: 2 steps, recover({n2}), 2 steps.  Leg
    2, MultiHostExecutor with 3 workers: the same plan, 2 steps bitwise
    equal to leg 1's, SIGKILL of rank 1 detected from the channel, the
    two-phase recovery pulling layer state across processes, 2 steps
    bitwise equal, 0 builds on the survivors, divergence 0, the
    snapshot's params bitwise leg 1's.  Returns the workers' launch
    counts, summed."""
    import gc
    import torch
    from repro_torch.data import ByteCorpus, GlobalBatchDispenser
    from repro_torch.kernels import build
    from repro_torch.launch.train import _TEXT, microbatches
    from repro_torch.runtime import HeteroTrainer
    from repro_torch.runtime.multihost import (MultiHostExecutor, build_setup,
                                               make_job_spec)
    on_card = device.type == "cuda"
    cfg = MULTIPROC
    seq, mb = cfg["seq_len"], cfg["microbatch"]
    if not on_card:
        seq, mb = cfg["cpu_seq_len"], cfg["cpu_microbatch"]
    nodes = [f"n{i}" for i in range(cfg["nodes"])]
    spec = make_job_spec(
        arch="gpt3-medium", layers=cfg["cpu_layers"], seq_len=seq,
        microbatch=mb, global_batch=cfg["global_batch"], f=cfg["f"],
        n0=cfg["n0"], nodes=nodes, hosting=cfg["hosting"], procs=3, seed=0,
        opt={"lr": 3e-3, "warmup_steps": 0, "weight_decay": 0.0},
        device=device.type, attn_impl="kernel", full=on_card,
        depth=cfg["layers"])
    t_phase = time.perf_counter()

    def sync():
        if on_card:
            torch.cuda.synchronize()

    def feed(disp, engine):
        return [microbatches(b, mb)
                for b in disp.next_step(engine.batch.minibatch_sizes())]

    # ---- leg 1: the single-process trainer on the same spec ----------
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    model, params, _, opt_cfg, engine = build_setup(spec)
    ref = HeteroTrainer(model, engine, params, opt_cfg)
    del params
    ref.warm_templates()
    fp0 = engine.plan_fingerprint()
    disp = GlobalBatchDispenser(ByteCorpus(_TEXT * 50, seq_len=seq))
    want, secs1 = [], []
    for step in range(4):
        if step == 2:
            ref.recover({"n2"})
            nodes_after = [list(i.nodes) for i in engine.instances]
        batches = feed(disp, engine)
        sync()
        t0 = time.perf_counter()
        out = ref.step(batches)
        want.append((float(out["loss"]), float(out["grad_norm"])))
        secs1.append(time.perf_counter() - t0)
    hashes1 = _tree_hashes(ref.full_params())
    mem1 = torch.cuda.max_memory_allocated() / 2**30 if on_card else 0.0
    print(f"[multiproc] leg 1 (one process): losses, grad norms "
          f"{want}; step seconds {[round(s, 4) for s in secs1]}; "
          f"max_memory_allocated {mem1:.2f} GiB")
    engine.attach_executor(None)
    del ref, engine, model
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    # ---- leg 2: the coordinator here, 3 worker processes -------------
    build.reset_launches()
    peak = _MemoryPeak(on_card)
    disp = GlobalBatchDispenser(ByteCorpus(_TEXT * 50, seq_len=seq))
    try:
        with MultiHostExecutor(spec, rpc_timeout=600.0) as mh:
            tm = mh.timing
            check(mh.engine.plan_fingerprint() == fp0,
                  "multiproc: the coordinator's plan differs from leg 1's")
            mh.warm_templates()
            print(f"[multiproc] 3 workers spawned and connected in "
                  f"{tm['spawn_s']:.2f}s; setup (params on {device.type}, "
                  f"shard trainer) {_rounded(tm['setup_s'])} s; warm "
                  f"{_rounded(tm['warm_s'])} s")
            got, secs2 = [], []

            def step(i):
                batches = feed(disp, mh.engine)
                t0 = time.perf_counter()
                out = mh.step(batches)
                got.append((float(out["loss"]), float(out["grad_norm"])))
                secs2.append(time.perf_counter() - t0)
                si = mh.last_step_info
                check(got[-1] == want[i], f"multiproc step {i}: {got[-1]!r} "
                      f"!= leg 1's {want[i]!r}")
                print(f"[multiproc] step {i}: loss, grad norm {got[-1]} "
                      f"bitwise leg 1's; {secs2[-1]:.4f}s = grads phase "
                      f"{si['grads_s']:.4f}s (workers' compute "
                      f"{si['grads_compute_s']:.4f}s, device->host + bytes "
                      f"{si['grads_pack_s']:.4f}s; {si['up_bytes']} B up) + "
                      f"commit {si['commit_s']:.4f}s (workers' unpack, "
                      f"upload, combine, update {si['commit_compute_s']:.4f}s;"
                      f" {si['down_bytes']} B down)")
            step(0)
            step(1)
            check(mh.replica_divergence() == 0, "multiproc: divergence")
            mh.mark_compiles()
            t0 = time.perf_counter()
            mh.kill_worker(1)
            dead, ranks = mh.detected_dead(timeout=30.0)
            detect_s = time.perf_counter() - t0
            check(dead == {"n2"} and ranks == {1},
                  f"multiproc: detected {dead}, {ranks}")
            t0 = time.perf_counter()
            info = mh.recover(dead)
            rec_s = time.perf_counter() - t0
            check(info["fetched_bytes"] > 0, f"multiproc: {info}")
            check([list(i.nodes) for i in mh.engine.instances] == nodes_after,
                  "multiproc: the recovered plan differs from leg 1's")
            bd = info["breakdown"]
            print(f"[multiproc] SIGKILL rank 1 -> detected {sorted(dead)} "
                  f"dead in {detect_s:.4f}s; recovery {rec_s:.4f}s (replan "
                  f"{bd['replan']:.4f}, transfer {bd['transfer']:.4f}, commit "
                  f"{bd['commit']:.4f}, barrier {bd['barrier']:.4f}), "
                  f"{info['fetched_bytes']} B fetched across processes in "
                  f"{info['fetches']} fetches, epoch {info['epoch']}")
            step(2)
            step(3)
            counts = mh.worker_counts()
            builds = {r: c["since_mark"] for r, c in counts.items()}
            check(sorted(builds) == [0, 2] and set(builds.values()) == {0},
                  f"multiproc: builds on the survivors {builds}")
            check(mh.replica_divergence() == 0, "multiproc: divergence")
            t0 = time.perf_counter()
            snap = mh.snapshot()
            snap_s = time.perf_counter() - t0
            check(_tree_hashes(snap.params) == hashes1,
                  "multiproc: snapshot params differ from leg 1's")
            del snap
            frames = {r: (round(s, 4), b)
                      for r, (s, b) in mh.server.slowest_frame.items()}
    finally:
        peak_mib = peak.stop()
    launches = {k: sum(c["launches"][k] for c in counts.values())
                for k in build.LAUNCHES}
    mine = dict(build.LAUNCHES)
    check(not any(mine.values()),
          f"multiproc: the coordinator launched kernels {mine}")
    if on_card:
        check(all(launches[k] == n for k, n in MULTIPROC_LAUNCHES.items()),
              f"multiproc: worker launches {launches}, expected "
              f"{MULTIPROC_LAUNCHES}")
    mem = {r: round(c["max_memory_allocated"] / 2**30, 2)
           for r, c in counts.items()}
    print(f"[multiproc] snapshot {snap_s:.4f}s, params bitwise leg 1's; "
          f"builds on the survivors {builds}; slowest reply frame per rank "
          f"(s, B) {frames}; max_memory_allocated per surviving worker "
          f"{mem} GiB; nvidia-smi memory.used peak {peak_mib} MiB")
    print(f"[multiproc] phase {time.perf_counter() - t_phase:.1f}s; worker "
          f"launches {launches}")
    return launches


#: phase 13's fast path: phase 7's gpt3-medium (full width and depth,
#: fp32, sequence 2048, launch/train.py's global batch 16, the same weights
#: and byte corpus; 5 nodes, f 1, n0 2) as ONE program over the global
#: batch, with the reference dry-run's memory settings: remat full and
#: the chunked CE (512 positions a chunk); the batch does not fit
#: without remat
SPMD = dict(nodes=5, f=1, n0=2, global_batch=16, microbatch=2, seq_len=2048,
            loss_chunk=512, steps=4, cpu_seq_len=32, cpu_layers=2)
#: fp32 FLOP/s outside the tensor cores (the H100 SXM data sheet)
FP32_PEAK = PEAK_FLOPS["torch.float32"]


#: phase 13's optimizer (phases 14 and 15 too)
SPMD_OPT = dict(lr=1e-3, warmup_steps=0, weight_decay=0.0)


def spmd_model(on_card, layers=None, **kw):
    """(arch, sequence, model) of phases 13-15: gpt3-medium at full width
    and depth on the card (reduced to ``layers``, default
    SPMD["cpu_layers"], in the CPU rehearsal), fp32, the flash and
    epilogue kernels, remat full and the chunked CE unless ``kw`` says
    otherwise."""
    import torch
    from repro_torch.configs import get_arch, reduced
    from repro_torch.models import Model
    arch, seq = get_arch("gpt3-medium"), SPMD["seq_len"]
    if not on_card:
        arch = reduced(arch, layers=layers or SPMD["cpu_layers"])
        seq = SPMD["cpu_seq_len"]
    opts = dict(dtype=torch.float32, attn_impl="kernel", fuse="fused",
                remat=True, remat_policy="full", loss_chunk=SPMD["loss_chunk"])
    opts.update(kw)
    return arch, seq, Model(arch, **opts)


def spmd_engine(arch, seq):
    """Phase 13's engine: 5 nodes, f 1, n0 2, the global batch 16 in
    microbatches of 2."""
    from repro_torch.core import EngineConfig, OobleckEngine, build_profile
    cfg = SPMD
    return OobleckEngine(
        build_profile(arch, microbatch=cfg["microbatch"], seq_len=seq),
        [f"node{i}" for i in range(cfg["nodes"])],
        EngineConfig(fault_tolerance=cfg["f"], global_batch=cfg["global_batch"],
                     microbatch=cfg["microbatch"], gpus_per_node=1,
                     n0_override=cfg["n0"]))


def spmd_launches(layers, steps):
    """Each kernel's launches over ``steps`` SPMD steps of ``layers``
    blocks under remat full: a block's forward runs twice a step (once
    forward, once recomputed in backward), its backward once.  Per block
    forward: one fused residual-add + RMSNorm (ln2), one flash forward,
    one fused-QKV GEMM; per block backward: one norm backward, one dq,
    one dk/dv, and the QKV GEMM's dx and dW (two gemm_bias launches)."""
    fwd, bwd = 2 * layers * steps, layers * steps
    return {"add_rmsnorm_fwd": fwd, "flash_fwd": fwd,
            "add_rmsnorm_bwd": bwd, "flash_bwd_dq": bwd,
            "flash_bwd_dkdv": bwd, "gemm_bias": fwd + 2 * bwd}


def run_spmd(device):
    """Phase 13: the single-program fast path (``SPMDExecutor``) at
    gpt3-medium's full width and depth, with the six flash and epilogue
    kernels inside, and its degradation through a node failure to a
    ``HeteroTrainer`` rebind.  Returns the SPMD steps' launch counts and,
    for phases 14 and 15, the global batch, the first step's loss and
    the params after it (on the host)."""
    import gc
    import numpy as np
    import torch
    from repro_torch.configs import ShapeConfig
    from repro_torch.core import verify_replica_coverage
    from repro_torch.core.monitor import NodeChangeMonitor
    from repro_torch.data import ByteCorpus, GlobalBatchDispenser
    from repro_torch.kernels import build
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.train import _TEXT, microbatches
    from repro_torch.optim import adamw
    from repro_torch.runtime import (ExecutorUnsupported, HeteroTrainer,
                                     ShardingStrategy, SPMDExecutor,
                                     track_compiles)
    from repro_torch.utils.tree import tree_leaves, tree_map
    on_card = device.type == "cuda"
    cfg = SPMD
    arch, seq, model = spmd_model(on_card)
    mb, gb = cfg["microbatch"], cfg["global_batch"]
    shape = ShapeConfig("phase13", seq, gb, "train")
    opt_cfg = adamw.AdamWConfig(**SPMD_OPT)

    def mk_engine():
        return spmd_engine(arch, seq)

    def sync():
        if on_card:
            torch.cuda.synchronize()

    t_phase = time.perf_counter()
    # the dry-run's terms for this model and batch on a 1 x 1 mesh, with
    # fp32 activations (derived on the host: FakeTensor traces)
    t0 = time.perf_counter()
    pred = dryrun.analyze(arch, shape, make_mesh((1, 1), ("data", "model")),
                          ShardingStrategy(), dtype=torch.float32,
                          loss_chunk=cfg["loss_chunk"], moe_impl="dense")
    pred_s = time.perf_counter() - t0
    nb = pred["bytes"]
    pred_peak = nb["args"] + nb["temps"] + nb["outputs"] - nb["alias"]
    flops = pred["roofline"]["flops_global"]

    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    engine_t = mk_engine()
    batches = GlobalBatchDispenser(ByteCorpus(_TEXT * 50, seq_len=seq)
                                   ).next_step(engine_t.batch.minibatch_sizes())
    batch = {k: np.concatenate([b[k] for b in batches])
             for k in ("tokens", "labels")}
    check(batch["tokens"].shape == (gb, seq), f"spmd batch {batch['tokens'].shape}")
    params = model.init(torch.Generator(device=device).manual_seed(0))

    # 2. the trainer's first step on the same weights and global batch
    trainer = HeteroTrainer(model, engine_t, params, opt_cfg)
    loss_h = float(trainer.step([microbatches(b, mb) for b in batches])["loss"])
    engine_t.attach_executor(None)
    del trainer
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    # 1. the executor's state against the dry-run's args less the batch
    base = torch.cuda.memory_allocated() if on_card else 0
    engine = mk_engine()
    t0 = time.perf_counter()
    ex = SPMDExecutor(model, params, opt_cfg, shape=shape, engine=engine)
    sync()
    bind_s = time.perf_counter() - t0
    held = (torch.cuda.memory_allocated() - base if on_card else
            sum(t.numel() * t.element_size()
                for t in tree_leaves((ex.params, ex.opt_state))))
    del params
    want = nb["args"] - dryrun.spec_bytes(arch, shape, make_mesh(
        (1, 1), ("data", "model")), ShardingStrategy(), model=model)["batch"]
    check(abs(held - want) <= 1e-3 * want,
          f"spmd state {held} B against the dry-run's args less the batch "
          f"{want} B")
    builds = ex.cache.stats.compiles
    check(builds == 1, f"spmd: bind built {builds} programs")

    # 3. steady state on the fixed batch, counting the kernels
    gc.collect()
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    build.reset_launches()
    losses, secs = [], []
    with track_compiles() as log:
        for i in range(cfg["steps"]):
            sync()
            t0 = time.perf_counter()
            loss = float(ex.step(batch)["loss"])
            sync()
            secs.append(time.perf_counter() - t0)
            losses.append(loss)
            if i == 0:      # phase 14 holds its first step to this one
                params1 = tree_map(lambda t: t.to("cpu", copy=True),
                                   ex.params)
    launches = dict(build.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    check(all(math.isfinite(l) for l in losses), f"spmd losses {losses}")
    check(all(b < a for a, b in zip(losses, losses[1:])),
          f"spmd losses do not fall: {losses}")
    check(ex.cache.stats.compiles == 1 and log.backend_compiles == 0,
          f"spmd: {ex.cache.stats.compiles} programs, "
          f"{log.backend_compiles} builds after bind")
    tol = EXECUTOR_TOL["atol"] + EXECUTOR_TOL["rtol"] * abs(loss_h)
    check(abs(losses[0] - loss_h) <= tol,
          f"spmd first loss {losses[0]!r} vs the trainer's {loss_h!r}")
    if on_card:
        # 5. every kernel exactly as the remat schedule derives
        want_l = spmd_launches(arch.num_layers, cfg["steps"])
        check({k: launches[k] for k in want_l} == want_l,
              f"spmd launches {launches}, expected {want_l}")
        check(pred["fits_hbm"] and peak <= 80 * 10**9,
              f"spmd peak {peak} B; the dry-run's fits {pred['fits_hbm']}")
    print(f"[spmd] bind {bind_s:.4f}s, state {held} B = dry-run args less "
          f"the batch {want} B; first loss {losses[0]!r} vs the trainer's "
          f"{loss_h!r}")
    print(f"[spmd] step seconds {[round(t, 4) for t in secs]}, losses "
          f"{[round(l, 4) for l in losses]}, programs 1, builds after bind "
          f"0, launches {launches}")
    steady = secs[-1]
    if not on_card:
        print(f"[spmd] peak memory and TFLOP/s: not measured (cpu "
              f"rehearsal); the dry-run's terms traced in {pred_s:.1f}s")
    else:
        print(f"[spmd] peak max_memory_allocated {peak / 2**30:.2f} GiB; the "
              f"dry-run's predicted peak {pred_peak / 2**30:.2f} GiB (args "
              f"{nb['args'] / 2**30:.2f} + temps {nb['temps'] / 2**30:.2f}; "
              f"traced {pred['traced']['attn_impl']} attention, {pred_s:.1f}s "
              f"on the host), measured/predicted "
              f"{peak / pred_peak:.3f}; {flops / 1e12:.2f} TFLOP a step (the "
              f"dry-run's products) over {steady:.4f}s = "
              f"{flops / steady / 1e12:.2f} TFLOP/s against the "
              f"{FP32_PEAK / 1e12:.0f} TFLOP/s fp32 peak")

    # 4. a node failure: the fast path refuses, the plan still changes,
    # a HeteroTrainer rebinds from the snapshot
    victim = engine.instances[0].nodes[-1]
    refused = False
    try:
        ex.recover({victim})
    except ExecutorUnsupported:
        refused = True
    check(refused, "spmd: recover did not raise ExecutorUnsupported")
    engine.monitor.inject(NodeChangeMonitor.FAIL, [victim])
    engine.monitor.poll(now=0.0)
    check(victim not in engine.nodes and
          verify_replica_coverage(engine.instances),
          f"spmd: the plan after killing {victim}: {engine.nodes}")
    snap = ex.snapshot()
    engine.attach_executor(None)
    del ex
    gc.collect()
    t0 = time.perf_counter()
    rebound = HeteroTrainer(model, engine, snap.params, opt_cfg,
                            opt_state=snap.opt_state)
    rebound.warm_templates()
    sync()
    rebind_s = time.perf_counter() - t0
    check(all(torch.equal(a, b) for a, b in zip(
        tree_leaves(rebound.full_params()), tree_leaves(snap.params))),
          "spmd: the rebound trainer's params differ from the snapshot's")
    check(rebound.replica_divergence() == 0.0, "spmd: rebound divergence")
    pbatches = GlobalBatchDispenser(ByteCorpus(_TEXT * 50, seq_len=seq)
                                    ).next_step(engine.batch.minibatch_sizes())
    with track_compiles() as log:
        sync()
        t0 = time.perf_counter()
        loss_r = float(rebound.step([microbatches(b, mb) for b in pbatches])
                       ["loss"])
        sync()
        step_r = time.perf_counter() - t0
    check(math.isfinite(loss_r) and log.backend_compiles == 0,
          f"spmd rebound step: loss {loss_r}, {log.backend_compiles} builds")
    engine.attach_executor(None)
    del rebound, snap
    gc.collect()
    print(f"[spmd] killed {victim}: recover raised ExecutorUnsupported, the "
          f"plan covers every replica ({[i.template.num_nodes for i in engine.instances]}); "
          f"HeteroTrainer rebound from the snapshot in {rebind_s:.4f}s "
          f"(params bitwise, divergence 0), its warmed step {step_r:.4f}s, "
          f"loss {loss_r!r}, 0 builds; phase "
          f"{time.perf_counter() - t_phase:.1f}s")
    return launches, {"batch": batch, "loss1": losses[0], "params1": params1}


#: phase 14: phase 13's model, weights, global batch and optimizer over
#: 4 rank processes sharing the card, a data 2 x model 2 mesh, FSDP with
#: ZeRO-1 (4 sequences a rank)
MESH = dict(shape=(2, 2), steps=3)
#: phase 15: 4 stage ranks of 6 blocks, M 4 microbatches of 2 (the first
#: 8 sequences of phase 13's batch), no remat, the chunked CE
PIPE = dict(stages=4, microbatches=4, microbatch=2, steps=3, cpu_layers=8)


def _sync(on_card):
    import torch
    if on_card:
        torch.cuda.synchronize()


def _world_device(on_card):
    from repro_torch.launch.mesh import init_world
    from repro_torch.utils.device import strict_fp32_numerics
    dev = init_world("cuda" if on_card else "cpu")
    if on_card:
        strict_fp32_numerics()
    return dev


def _params_track(a_leaves, b_leaves, lr):
    """tests/test_executor.py::assert_params_track: (max |a - b|, the
    fraction above lr / 10) over all leaves, and whether both hold."""
    worst, frac = 0.0, 0.0
    for a, b in zip(a_leaves, b_leaves):
        d = (a.float() - b.float()).abs()
        worst = max(worst, float(d.max()))
        frac = max(frac, float((d > lr / 10).float().mean()))
    return worst, frac, worst <= 2.5 * lr and frac < 1e-3


def mesh_rank(on_card, batch):
    """Phase 14, one rank's part (run by ``spawn_world``)."""
    import gc
    import torch
    from repro_torch.configs import ShapeConfig
    from repro_torch.kernels import build
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import ProcessMesh
    from repro_torch.optim import adamw
    from repro_torch.runtime import (HeteroTrainer, ShardingStrategy,
                                     SPMDExecutor, track_compiles)
    from repro_torch.runtime.sharding import gather_tree
    from repro_torch.utils.tree import tree_leaves, tree_map
    dev = _world_device(on_card)
    mesh = ProcessMesh(("data", "model"), MESH["shape"])
    arch, seq, model = spmd_model(on_card)
    shape = ShapeConfig("phase14", seq, SPMD["global_batch"], "train")
    opt_cfg = adamw.AdamWConfig(**SPMD_OPT)
    strategy = ShardingStrategy()
    base = torch.cuda.memory_allocated() if on_card else 0
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    ex = SPMDExecutor(model, params, opt_cfg, mesh=mesh, strategy=strategy,
                      shape=shape)
    del params
    gc.collect()
    _sync(on_card)
    bind_s = time.perf_counter() - t0
    held = sum(t.numel() * t.element_size()
               for t in tree_leaves((ex.params, ex.opt_state)))
    alloc = torch.cuda.memory_allocated() - base if on_card else held
    b = dryrun.spec_bytes(arch, shape, mesh, strategy, model=model)
    out = {"rank": mesh.rank, "coords": mesh.coords, "backend": mesh.backend,
           "held": held, "alloc": alloc, "want": b["args"] - b["batch"],
           "bind_s": bind_s, "builds_at_bind": ex.cache.stats.compiles}
    tr = mesh.transport
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    build.reset_launches()
    losses, secs, moved, comm_s = [], [], [], []
    with track_compiles() as log:
        for i in range(MESH["steps"]):
            tr.reset()
            _sync(on_card)
            t0 = time.perf_counter()
            losses.append(float(ex.step(batch)["loss"]))
            _sync(on_card)
            secs.append(time.perf_counter() - t0)
            moved.append(dict(tr.bytes))
            comm_s.append(tr.seconds)
            if i == 0:
                full = gather_tree(ex.pspecs, ex.params, mesh, to_root=True)
                out["params1"] = (tree_map(lambda t: t.cpu(), full)
                                  if full is not None else None)
                del full
    out.update(losses=losses, secs=secs, moved=moved, comm_s=comm_s,
               launches=dict(build.LAUNCHES),
               builds=ex.cache.stats.compiles + log.backend_compiles,
               peak=torch.cuda.max_memory_allocated() if on_card else 0,
               reserved=torch.cuda.max_memory_reserved() if on_card else 0)
    t0 = time.perf_counter()
    snap = ex.snapshot()
    out["snapshot_s"] = time.perf_counter() - t0
    del ex
    gc.collect()
    if snap is not None:
        engine = spmd_engine(arch, seq)
        t0 = time.perf_counter()
        rebound = HeteroTrainer(model, engine, snap.params, opt_cfg,
                                opt_state=snap.opt_state)
        _sync(on_card)
        out["rebind_s"] = time.perf_counter() - t0
        out["rebound_bitwise"] = all(torch.equal(a, b) for a, b in zip(
            tree_leaves(rebound.full_params()), tree_leaves(snap.params)))
        out["divergence"] = rebound.replica_divergence()
        out["snapshot_step"] = snap.step
        engine.attach_executor(None)
    return out


def run_mesh(device, p13):
    """Phase 14: ``SPMDExecutor`` over a data 2 x model 2 ``ProcessMesh``
    of 4 fresh rank processes (FSDP with ZeRO-1), held to phase 13's
    single program on the same weights and batch."""
    import gc
    import torch
    from repro_torch.launch.mesh import spawn_world, world_backend
    from repro_torch.runtime.collectives import GLOO_CUDA_OPS
    from repro_torch.utils.tree import tree_leaves
    on_card = device.type == "cuda"
    arch, _, _ = spmd_model(on_card)
    ranks_n = MESH["shape"][0] * MESH["shape"][1]
    t_phase = time.perf_counter()
    gc.collect()
    if on_card:         # the card's memory for the ranks
        torch.cuda.empty_cache()
    poller = _MemoryPeak(on_card)
    try:
        ranks = spawn_world("chip_smoke:mesh_rank", ranks_n,
                            {"on_card": on_card, "batch": p13["batch"]},
                            device=device, paths=[ROOT], timeout=600)
    finally:
        smi = poller.stop()
    r0 = ranks[0]
    print(f"[mesh] {ranks_n} rank processes, backend {r0['backend']} "
          f"(world_backend: {world_backend(device, ranks_n)}; the ranks "
          f"share one card; gloo takes CUDA tensors for "
          f"{sorted(GLOO_CUDA_OPS)}, send and recv stage through the host), "
          f"mesh data {MESH['shape'][0]} x model {MESH['shape'][1]}, "
          f"FSDP + ZeRO-1, bind {[round(r['bind_s'], 2) for r in ranks]}s")
    for r in ranks:
        check(r["held"] == r["want"],
              f"mesh rank {r['rank']}: state {r['held']} B, the dry-run's "
              f"per-card args less the batch {r['want']} B")
        check(abs(r["alloc"] - r["want"]) <= 1e-3 * r["want"],
              f"mesh rank {r['rank']}: memory_allocated {r['alloc']} B vs "
              f"{r['want']} B")
        check(r["losses"] == r0["losses"],
              f"mesh rank {r['rank']} losses {r['losses']} vs rank 0's "
              f"{r0['losses']}")
        check(r["builds_at_bind"] == 1 and r["builds"] == 1,
              f"mesh rank {r['rank']}: {r['builds_at_bind']} programs at "
              f"bind, {r['builds']} after")
        if on_card:
            want_l = spmd_launches(arch.num_layers, MESH["steps"])
            got = {k: r["launches"][k] for k in want_l}
            check(got == want_l, f"mesh rank {r['rank']} launches {got}, "
                  f"expected {want_l}")
    losses = r0["losses"]
    check(all(math.isfinite(x) for x in losses) and
          all(b < a for a, b in zip(losses, losses[1:])),
          f"mesh losses {losses}")
    tol = EXECUTOR_TOL["atol"] + EXECUTOR_TOL["rtol"] * abs(p13["loss1"])
    check(abs(losses[0] - p13["loss1"]) <= tol,
          f"mesh first loss {losses[0]!r} vs phase 13's {p13['loss1']!r}")
    worst, frac, ok = _params_track(tree_leaves(r0["params1"]),
                                    tree_leaves(p13["params1"]),
                                    SPMD_OPT["lr"])
    check(ok, f"mesh params after step 1 vs phase 13's: max {worst}, "
          f"fraction above lr/10 {frac}")
    check(r0["rebound_bitwise"] and r0["divergence"] == 0.0,
          f"mesh rebind: bitwise {r0['rebound_bitwise']}, divergence "
          f"{r0['divergence']}")
    print(f"[mesh] state {r0['held']} B a rank = the dry-run's per-card "
          f"args less the batch; memory_allocated "
          f"{[r['alloc'] for r in ranks]} B")
    print(f"[mesh] first loss {losses[0]!r} vs phase 13's {p13['loss1']!r}; "
          f"params after step 1 track phase 13's (max |diff| {worst:.3g}, "
          f"fraction above lr/10 {frac:.3g})")
    print(f"[mesh] step seconds {[round(t, 4) for t in r0['secs']]} (rank "
          f"0; slowest rank {[round(max(r['secs'][i] for r in ranks), 4) for i in range(MESH['steps'])]}), "
          f"losses {[round(x, 4) for x in losses]} bitwise on every rank, "
          f"programs 1, builds after bind 0")
    print(f"[mesh] bytes a step on rank 0 {r0['moved'][-1]}; host seconds "
          f"inside the collectives a step, rank 0 "
          f"{[round(x, 4) for x in r0['comm_s']]}")
    print(f"[mesh] launches a rank {r0['launches']}")
    if on_card:
        print(f"[mesh] peak max_memory_allocated a rank "
              f"{[round(r['peak'] / 2**30, 2) for r in ranks]} GiB "
              f"(max_memory_reserved "
              f"{[round(r['reserved'] / 2**30, 2) for r in ranks]}); "
              f"nvidia-smi memory.used peak {smi} MiB (4 ranks and this "
              f"process)")
    else:
        print("[mesh] peak memory: not measured (cpu rehearsal)")
    print(f"[mesh] snapshot gathered to rank 0 in {r0['snapshot_s']:.4f}s "
          f"(step {r0['snapshot_step']}), HeteroTrainer rebound in "
          f"{r0['rebind_s']:.4f}s: params bitwise, divergence 0; phase "
          f"{time.perf_counter() - t_phase:.1f}s")


def _pipe_batch(batch):
    """[M, b, S] tokens and labels: the first M x b sequences."""
    cfg = PIPE
    n = cfg["microbatches"] * cfg["microbatch"]
    return tuple(batch[k][:n].reshape(cfg["microbatches"], cfg["microbatch"],
                                      -1) for k in ("tokens", "labels"))


def pipe_rank(on_card, tokens, labels, axes=("stage",), shape=None,
              steps=None, remat=False):
    """Phase 15 (or 15b), one stage's part (run by ``spawn_world``) on a
    mesh of ``axes`` and ``shape`` (phase 15's: 4 stages)."""
    import hashlib
    import torch
    from repro_torch.kernels import build
    from repro_torch.launch.mesh import ProcessMesh
    from repro_torch.optim import adamw
    from repro_torch.runtime import track_compiles
    from repro_torch.runtime.spmd_pipeline import (make_pipeline_train_step,
                                                   stage_params)
    from repro_torch.utils.tree import tree_map
    from repro_torch.runtime.coordination import leaf_bytes
    from repro_torch.utils.tree import tree_leaves
    dev = _world_device(on_card)
    mesh = ProcessMesh(axes, shape or (PIPE["stages"],))
    steps = steps or PIPE["steps"]
    _, _, model = spmd_model(on_card, layers=PIPE["cpu_layers"], remat=remat)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    local = stage_params(params, mesh)
    del params
    tok = torch.from_numpy(tokens).to(dev)
    lab = torch.from_numpy(labels).to(dev)
    step = make_pipeline_train_step(model, adamw.AdamWConfig(**SPMD_OPT),
                                    mesh)
    opt = adamw.init(local)
    tr = mesh.transport
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    build.reset_launches()
    out = {"stage": mesh.axis_index("stage"), "coords": mesh.coords}
    losses, secs, moved, comm_s = [], [], [], []
    with track_compiles() as log:
        for i in range(steps):
            tr.reset()
            _sync(on_card)
            t0 = time.perf_counter()
            local, opt, stats = step(local, opt, tok, lab)
            losses.append(float(stats["loss"]))
            _sync(on_card)
            secs.append(time.perf_counter() - t0)
            moved.append(dict(tr.bytes))
            comm_s.append(tr.seconds)
            if i == 0:
                keep = local if mesh.rank == 0 else {"blocks": local["blocks"]}
                out["params1"] = tree_map(
                    lambda t: t.to("cpu", copy=True), keep)
    out.update(losses=losses, secs=secs, moved=moved, comm_s=comm_s,
               launches=dict(build.LAUNCHES), builds=log.backend_compiles,
               peak=torch.cuda.max_memory_allocated() if on_card else 0,
               reserved=torch.cuda.max_memory_reserved() if on_card else 0,
               hash=hashlib.sha256(b"".join(
                   leaf_bytes(t) for t in tree_leaves(local))).hexdigest())
    return out


def run_pipeline(device, batch):
    """Phase 15: ``runtime/spmd_pipeline.py`` over 4 stage ranks, held
    to one process's plain full-model step on the same sequences.
    Returns the stages' losses."""
    import gc
    import torch
    from repro_torch.launch.mesh import spawn_world
    from repro_torch.optim import adamw
    from repro_torch.utils.tree import tree_leaves, tree_map, tree_unflatten_like
    on_card = device.type == "cuda"
    cfg = PIPE
    t_phase = time.perf_counter()
    tokens, labels = _pipe_batch(batch)
    # one process's plain step on the same sequences: the microbatches'
    # mean losses averaged, their gradients accumulated, AdamW
    arch, _, model = spmd_model(on_card, layers=cfg["cpu_layers"], remat=False)
    check(arch.num_layers % cfg["stages"] == 0, f"{arch.num_layers} layers")
    params = model.init(torch.Generator(device=device).manual_seed(0))
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    total = torch.zeros((), device=device)
    _sync(on_card)
    t0 = time.perf_counter()
    with torch.enable_grad():
        for j in range(cfg["microbatches"]):
            mb = {"tokens": torch.from_numpy(tokens[j]).to(device),
                  "labels": torch.from_numpy(labels[j]).to(device)}
            loss, _ = model.loss(tree_unflatten_like(params, leaves), mb)
            (loss / cfg["microbatches"]).backward()
            total = total + loss.detach()
    loss_ref = float(total / cfg["microbatches"])
    grads = tree_unflatten_like(params, [p.grad for p in leaves])
    p_ref, _, _ = adamw.apply(adamw.AdamWConfig(**SPMD_OPT), params, grads,
                              adamw.init(params))
    _sync(on_card)
    plain_s = time.perf_counter() - t0
    p_ref = tree_map(lambda t: t.cpu(), p_ref)
    del params, leaves, grads, loss, total
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    poller = _MemoryPeak(on_card)
    try:
        stages = spawn_world("chip_smoke:pipe_rank", cfg["stages"],
                             {"on_card": on_card, "tokens": tokens,
                              "labels": labels},
                             device=device, paths=[ROOT], timeout=600)
    finally:
        smi = poller.stop()
    r0 = stages[0]
    losses = r0["losses"]
    for r in stages:
        check(r["losses"] == losses, f"pipeline stage {r['stage']} losses "
              f"{r['losses']} vs stage 0's {losses}")
        check(r["builds"] == 0, f"pipeline stage {r['stage']}: "
              f"{r['builds']} builds")
        if on_card:
            n = (arch.num_layers // cfg["stages"]) * cfg["microbatches"] \
                * cfg["steps"]
            want_l = {k: n for k in FUSED + FLASH}
            want_l["gemm_bias"] = 3 * n
            got = {k: r["launches"][k] for k in want_l}
            check(got == want_l, f"pipeline stage {r['stage']} launches "
                  f"{got}, expected {want_l}")
    check(all(math.isfinite(x) for x in losses) and
          all(b < a for a, b in zip(losses, losses[1:])),
          f"pipeline losses {losses}")
    tol = EXECUTOR_TOL["atol"] + EXECUTOR_TOL["rtol"] * abs(loss_ref)
    check(abs(losses[0] - loss_ref) <= tol,
          f"pipeline loss {losses[0]!r} vs the plain step's {loss_ref!r}")
    full = dict(r0["params1"])
    full["blocks"] = tree_map(lambda *xs: torch.cat(xs),
                              *[r["params1"]["blocks"] for r in stages])
    worst, frac, ok = _params_track(tree_leaves(full), tree_leaves(p_ref),
                                    SPMD_OPT["lr"])
    check(ok, f"pipeline params after one step vs the plain step's: max "
          f"{worst}, fraction above lr/10 {frac}")
    print(f"[pipeline] {cfg['stages']} stage ranks x "
          f"{arch.num_layers // cfg['stages']} blocks, M {cfg['microbatches']}"
          f" microbatches of {cfg['microbatch']}: loss {losses[0]!r} vs one "
          f"process's plain step {loss_ref!r} ({plain_s:.4f}s); params after "
          f"the step track it (max |diff| {worst:.3g}, fraction above lr/10 "
          f"{frac:.3g})")
    print(f"[pipeline] step seconds {[round(t, 4) for t in r0['secs']]} "
          f"(stage 0), losses {[round(x, 4) for x in losses]} bitwise on "
          f"every stage, builds 0; bytes a step on each stage "
          f"(point-to-point / reduced): "
          f"{[(r['moved'][-1]['p2p'], r['moved'][-1]['reduced']) for r in stages]}"
          f"; host seconds inside them, stage 0 "
          f"{[round(x, 4) for x in r0['comm_s']]}")
    print(f"[pipeline] launches a stage {r0['launches']}")
    if on_card:
        print(f"[pipeline] peak max_memory_allocated a stage "
              f"{[round(r['peak'] / 2**30, 2) for r in stages]} GiB "
              f"(max_memory_reserved "
              f"{[round(r['reserved'] / 2**30, 2) for r in stages]}); "
              f"nvidia-smi memory.used peak {smi} MiB (4 stages and this "
              f"process); phase {time.perf_counter() - t_phase:.1f}s")
    else:
        print(f"[pipeline] peak memory: not measured (cpu rehearsal); phase "
              f"{time.perf_counter() - t_phase:.1f}s")
    return losses


#: phase 15b: phase 15's model and microbatches on stage 2 x data 2 (two
#: stage groups of 2 stages, each running the whole pipeline on the same
#: microbatches), 2 steps, remat full: without it a stage of 12 blocks
#: holds 4 microbatches' activations, and the 4 ranks ran out of the
#: card (cuBLAS could not allocate its handle); the recompute repeats
#: the forward exactly, so the losses are phase 15's function
PIPE15B = dict(axes=("stage", "data"), shape=(2, 2), steps=2, remat=True)


def run_pipeline_beside(device, batch, losses15):
    """Phase 15b: the pipeline beside a data axis, held to phase 15's
    stage-only losses (``losses15``) at tests/test_executor.py's fp32
    tolerance, its two data replicas bitwise equal."""
    from repro_torch.launch.mesh import spawn_world
    on_card = device.type == "cuda"
    cfg = PIPE15B
    t_phase = time.perf_counter()
    arch, _, _ = spmd_model(on_card, layers=PIPE["cpu_layers"], remat=False)
    tokens, labels = _pipe_batch(batch)
    ranks = spawn_world("chip_smoke:pipe_rank", 4,
                        {"on_card": on_card, "tokens": tokens,
                         "labels": labels, "axes": cfg["axes"],
                         "shape": cfg["shape"], "steps": cfg["steps"],
                         "remat": cfg["remat"]},
                        device=device, paths=[ROOT], timeout=600)
    r0 = ranks[0]
    losses = r0["losses"]
    S = cfg["shape"][cfg["axes"].index("stage")]
    groups = {}
    for r in ranks:
        check(r["losses"] == losses, f"pipeline 15b rank {r['coords']} "
              f"losses {r['losses']} vs rank 0's {losses}")
        check(r["builds"] == 0, f"pipeline 15b: {r['builds']} builds")
        groups.setdefault(r["stage"], []).append(r)
        if on_card:
            # remat full: each block's forward twice a microbatch
            want_l = spmd_launches((arch.num_layers // S)
                                   * PIPE["microbatches"], cfg["steps"])
            got = {k: r["launches"][k] for k in want_l}
            check(got == want_l, f"pipeline 15b rank {r['coords']} launches "
                  f"{got}, expected {want_l}")
    for stage, members in groups.items():
        check(len(members) == 2 and members[0]["hash"] == members[1]["hash"],
              f"pipeline 15b stage {stage}: the data replicas' parameters "
              f"differ")
    for a, b in zip(losses, losses15):
        tol = EXECUTOR_TOL["atol"] + EXECUTOR_TOL["rtol"] * abs(b)
        check(abs(a - b) <= tol, f"pipeline 15b losses {losses} vs phase "
              f"15's {losses15}")
    print(f"[pipeline] 15b: stage {S} x data 2 ({arch.num_layers // S} "
          f"blocks a stage, M {PIPE['microbatches']} x "
          f"{PIPE['microbatch']} on each stage group, remat full): losses {losses} vs "
          f"phase 15's {losses15[:len(losses)]} (EXECUTOR_TOL; first "
          f"bitwise: {losses[0] == losses15[0]}), bitwise on every rank; "
          f"each stage's data replicas bitwise equal after "
          f"{cfg['steps']} steps; builds 0")
    print(f"[pipeline] 15b step seconds {[round(t, 4) for t in r0['secs']]} "
          f"(rank 0; slowest rank "
          f"{[round(max(r['secs'][i] for r in ranks), 4) for i in range(cfg['steps'])]}); "
          f"bytes a step (point-to-point / reduced) "
          f"{[(r['moved'][-1]['p2p'], r['moved'][-1]['reduced']) for r in ranks]}; "
          f"host seconds inside them, rank 0 "
          f"{[round(x, 4) for x in r0['comm_s']]}; peak max_memory_allocated "
          f"a rank "
          f"{[round(r['peak'] / 2**30, 2) for r in ranks] if on_card else 'not measured (cpu rehearsal)'}"
          f"{' GiB' if on_card else ''}; phase "
          f"{time.perf_counter() - t_phase:.1f}s")


# ----------------------------------------------------------------------
# Phase 17: sequence parallelism and MoE over batch ranks on the mesh
# ----------------------------------------------------------------------
#: phase 17's scenarios over one world of 4 rank processes on a data 2 x
#: model 2 mesh (FSDP + ZeRO-1), each against a one-program SPMDExecutor
#: on the same weights and sequences: name -> (arch, layers on the card
#: (None: all), global batch, model options).  17a: gpt3-medium, 2
#: sequences (rows over data, the sequence over model: 1024 positions a
#: rank, flash at Sq 1024 against Sk 1024 / 2048), depth cut to 8 of 24
#: blocks to keep the script inside its time limit (12 since phase 19, 8
#: since phases 15b and 21); 17b:
#: granite-moe, 4 sequences (one a rank: the router statistics over 4
#: batch ranks), depth cut to 4 of 24 blocks; 17c: mamba2-780m, 2
#: sequences (the mixer's input gathered over model, the scan on each
#: rank), depth cut to 8 of 48 blocks (17b from 8 and 17c from 16 since
#: phases 15b and 21).  The cuts keep the phase's gloo
#: traffic (each rank's gathered weights, through the host) inside its
#: time; the sequences are phase 13's first.
SEQ17 = {
    "17a": ("gpt3-medium", 8, 2, dict(attn_impl="kernel")),
    "17b": ("granite-moe-1b-a400m", 4, 4, dict(attn_impl="kernel")),
    "17c": ("mamba2-780m", 8, 2, dict(ssd_impl="kernel")),
}
SEQ17_STEPS = 2


def _scenario(name):
    """A phase 17 (``SEQ17``), 18 (``TP18``) or 19 (``TP19``, ``TP19C``)
    scenario."""
    return {**SEQ17, **TP18, **TP19, **TP19C}[name]


def seq_model(on_card, name):
    """(arch, sequence, model) of a phase 17, 18 or 19 scenario: phase 13's
    model options (fp32, the kernels, remat full, the chunked CE) at the
    scenario's width, its depth on the card (2 blocks and phase 13's CPU
    sequence in the CPU rehearsal)."""
    import dataclasses
    import torch
    from repro_torch.configs import get_arch, reduced
    from repro_torch.models import Model
    arch_name, layers, _, opts = _scenario(name)
    arch, seq = get_arch(arch_name), SPMD["seq_len"]
    if not on_card:
        arch, seq = reduced(arch, layers=2), SPMD["cpu_seq_len"]
        arch = dataclasses.replace(arch, **TP_CPU_FIELDS.get(name, {}))
    elif layers is not None:
        arch = dataclasses.replace(arch, num_layers=layers)
    model = Model(arch, dtype=torch.float32, fuse="fused", remat=True,
                  remat_policy="full", loss_chunk=SPMD["loss_chunk"], **opts)
    return arch, seq, model


def seq_launches(arch, steps):
    """Each kernel's launches a rank over ``steps`` phase 17-19 steps
    under remat full: a block's forward twice a step, its backward once
    (``spmd_launches``); a Mamba2 mixer launches one SSD forward and
    backward (over the whole sequence on every rank of a sequence group,
    at the rank's heads under TP); an SSM block no epilogue or flash
    kernel, a hybrid block both."""
    L = arch.num_layers
    ssd = ({"ssd_fwd": 2 * L * steps, "ssd_bwd": L * steps}
           if arch.ssm is not None else {"ssd_fwd": 0, "ssd_bwd": 0})
    if arch.family == "ssm":
        return {**ssd, **{k: 0 for k in FUSED + FLASH}}
    return {**spmd_launches(L, steps), **ssd}


def _seq_batch(gb, batch):
    """The scenario's global batch: phase 13's first ``gb`` sequences."""
    return {k: batch[k][:gb] for k in ("tokens", "labels")}


def seq_rank(on_card, batch):
    """Phase 17, one rank's part (run by ``spawn_world``): every scenario
    in turn on this world's data 2 x model 2 mesh."""
    import gc
    import torch
    from repro_torch.configs import ShapeConfig
    from repro_torch.kernels import build
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import ProcessMesh
    from repro_torch.optim import adamw
    from repro_torch.runtime import (ShardingStrategy, SPMDExecutor,
                                     track_compiles)
    from repro_torch.runtime.sharding import gather_tree
    from repro_torch.utils.tree import tree_leaves, tree_map
    dev = _world_device(on_card)
    mesh = ProcessMesh(("data", "model"), MESH["shape"])
    strategy = ShardingStrategy()
    tr = mesh.transport
    out = {"rank": mesh.rank, "coords": mesh.coords}
    for name, (_, _, gb, _) in SEQ17.items():
        arch, seq, model = seq_model(on_card, name)
        shape = ShapeConfig(f"phase17-{name}", seq, gb, "train")
        b = _seq_batch(gb, batch)
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        params = model.init(torch.Generator(device=dev).manual_seed(0))
        ex = SPMDExecutor(model, params, adamw.AdamWConfig(**SPMD_OPT),
                          mesh=mesh, strategy=strategy, shape=shape)
        del params
        held = sum(t.numel() * t.element_size()
                   for t in tree_leaves((ex.params, ex.opt_state)))
        want = dryrun.spec_bytes(arch, shape, mesh, strategy, model=model)
        bspec = strategy.batch_spec(mesh, gb)
        shard = strategy.seq_context(mesh, gb).shard(seq)
        r = {"held": held, "want": want["args"] - want["batch"],
             "rows_over": bspec[0] if bspec else None,
             "seq_over": shard.ctx.axis if shard.sliced else None,
             "rows": gb // mesh.size(bspec[0]) if bspec else gb,
             "positions": shard.stop - shard.start,
             "builds_at_bind": ex.cache.stats.compiles}
        build.reset_launches()
        losses, secs, moved, tagged = [], [], [], []
        with track_compiles() as log:
            for i in range(SEQ17_STEPS):
                tr.reset()
                _sync(on_card)
                t0 = time.perf_counter()
                stats = ex.step(b)
                losses.append(float(stats["loss"]))
                _sync(on_card)
                secs.append(time.perf_counter() - t0)
                moved.append(dict(tr.bytes))
                tagged.append({k: dict(v) for k, v in tr.tagged.items()})
                if i == 0:
                    r["aux1"] = float(stats["aux"])
                    full = gather_tree(ex.pspecs, ex.params, mesh,
                                       to_root=True)
                    r["params1"] = (tree_map(lambda t: t.cpu(), full)
                                    if full is not None else None)
                    del full
        r.update(losses=losses, secs=secs, moved=moved, tagged=tagged,
                 launches=dict(build.LAUNCHES),
                 builds=ex.cache.stats.compiles + log.backend_compiles,
                 peak=torch.cuda.max_memory_allocated() if on_card else 0)
        out[name] = r
        del ex
    return out


def _seq_reference(device, name, batch):
    """A scenario's one-program SPMDExecutor on this process's device:
    (first loss, its aux, the params after it on the host, seconds)."""
    import gc
    import torch
    from repro_torch.configs import ShapeConfig
    from repro_torch.optim import adamw
    from repro_torch.runtime import SPMDExecutor
    from repro_torch.utils.tree import tree_map
    on_card = device.type == "cuda"
    _, seq, model = seq_model(on_card, name)
    gb = _scenario(name)[2]
    params = model.init(torch.Generator(device=device).manual_seed(0))
    ex = SPMDExecutor(model, params, adamw.AdamWConfig(**SPMD_OPT),
                      shape=ShapeConfig(f"phase{name[:2]}-{name}", seq, gb,
                                       "train"))
    del params
    _sync(on_card)
    t0 = time.perf_counter()
    stats = ex.step(_seq_batch(gb, batch))
    _sync(on_card)
    secs = time.perf_counter() - t0
    out = (float(stats["loss"]), float(stats["aux"]),
           tree_map(lambda t: t.to("cpu", copy=True), ex.params), secs)
    del ex, stats
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    return out


def _tag_bytes(tagged):
    """{tag: bytes} of one step's tagged traffic, every kind summed."""
    return {tag: sum(kinds.values()) for tag, kinds in sorted(tagged.items())}


def run_seq(device, batch):
    """Phase 17: MoE over several batch ranks and sequence parallelism
    over the batch axes a small batch leaves uncovered, one world of 4
    fresh rank processes sharing the card (gloo), each scenario held to a
    one-program SPMDExecutor on the same weights and sequences."""
    import gc
    import torch
    from repro_torch.launch.mesh import spawn_world
    from repro_torch.utils.tree import tree_leaves
    on_card = device.type == "cuda"
    t_phase = time.perf_counter()
    refs = {name: _seq_reference(device, name, batch) for name in SEQ17}
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    ranks_n = MESH["shape"][0] * MESH["shape"][1]
    poller = _MemoryPeak(on_card)
    try:
        ranks = spawn_world("chip_smoke:seq_rank", ranks_n,
                            {"on_card": on_card, "batch": batch},
                            device=device, paths=[ROOT], timeout=900)
    finally:
        smi = poller.stop()
    for name in SEQ17:
        arch, seq, _ = seq_model(on_card, name)
        loss_ref, aux_ref, p_ref, ref_s = refs[name]
        r0 = ranks[0][name]
        losses = r0["losses"]
        for rank in ranks:
            r = rank[name]
            check(r["held"] == r["want"],
                  f"seq {name} rank {rank['rank']}: state {r['held']} B, the "
                  f"dry-run's per-card args less the batch {r['want']} B")
            check(r["losses"] == losses,
                  f"seq {name} rank {rank['rank']} losses {r['losses']} vs "
                  f"rank 0's {losses}")
            check(r["builds_at_bind"] == 1 and r["builds"] == 1,
                  f"seq {name} rank {rank['rank']}: {r['builds_at_bind']} "
                  f"programs at bind, {r['builds']} after")
            if on_card:
                want_l = seq_launches(arch, SEQ17_STEPS)
                got = {k: r["launches"][k] for k in want_l}
                check(got == want_l, f"seq {name} rank {rank['rank']} "
                      f"launches {got}, expected {want_l}")
        check(all(math.isfinite(x) for x in losses),
              f"seq {name} losses {losses}")
        tol = EXECUTOR_TOL["atol"] + EXECUTOR_TOL["rtol"] * abs(loss_ref)
        check(abs(losses[0] - loss_ref) <= tol,
              f"seq {name} first loss {losses[0]!r} vs one program's "
              f"{loss_ref!r}")
        atol = EXECUTOR_TOL["atol"] + EXECUTOR_TOL["rtol"] * abs(aux_ref)
        check(abs(r0["aux1"] - aux_ref) <= atol,
              f"seq {name} first aux {r0['aux1']!r} vs one program's "
              f"{aux_ref!r}")
        worst, frac, ok = _params_track(tree_leaves(r0["params1"]),
                                        tree_leaves(p_ref), SPMD_OPT["lr"])
        check(ok, f"seq {name} params after step 1 vs one program's: max "
              f"{worst}, fraction above lr/10 {frac}")
        print(f"[seq] {name} {arch.name} ({arch.num_layers} blocks, S "
              f"{seq}, global batch {SEQ17[name][2]}): rows over "
              f"{r0['rows_over']}, the sequence over {r0['seq_over']}: "
              f"{r0['rows']} rows of {r0['positions']} positions a rank; "
              f"first "
              f"loss {losses[0]!r} vs one program's {loss_ref!r} "
              f"({ref_s:.4f}s), aux {r0['aux1']!r} vs {aux_ref!r}; params "
              f"after step 1 track it (max |diff| {worst:.3g}, fraction "
              f"above lr/10 {frac:.3g})")
        slowest = [round(max(rk[name]["secs"][i] for rk in ranks), 4)
                   for i in range(SEQ17_STEPS)]
        print(f"[seq] {name} step seconds {[round(t, 4) for t in r0['secs']]}"
              f" (rank 0; slowest rank {slowest}), "
              f"losses {[round(x, 4) for x in losses]} bitwise on every "
              f"rank, programs 1, builds after bind 0; state "
              f"{r0['held']} B a rank = the dry-run's per-card args less "
              f"the batch")
        print(f"[seq] {name} bytes a step on rank 0 {r0['moved'][-1]}; of "
              f"them by what they carry (gathered + reduced + scattered) "
              f"{_tag_bytes(r0['tagged'][-1])}")
        print(f"[seq] {name} launches a rank {r0['launches']}")
        if on_card:
            print(f"[seq] {name} peak max_memory_allocated a rank "
                  f"{[round(rk[name]['peak'] / 2**30, 2) for rk in ranks]} "
                  f"GiB")
    if on_card:
        print(f"[seq] nvidia-smi memory.used peak {smi} MiB (4 ranks and "
              f"this process); phase {time.perf_counter() - t_phase:.1f}s")
    else:
        print(f"[seq] peak memory: not measured (cpu rehearsal); phase "
              f"{time.perf_counter() - t_phase:.1f}s")


# ----------------------------------------------------------------------
# Phase 18: Megatron tensor and expert parallelism on the mesh
# ----------------------------------------------------------------------
#: phase 18's scenarios over one world of 4 rank processes on a data 2 x
#: model 2 mesh (strategy "tp", ZeRO-1), each against a one-program
#: SPMDExecutor on the same weights and sequences: name -> (arch, layers
#: on the card (None: all), global batch, model options).  Global batch
#: 2: one sequence of 2048 a data rank, computed by its model group of
#: 2.  18a: gpt3-medium, depth cut to 8 of 24 blocks (8 heads a rank,
#: the table of 50257 rows whole);
#: 18b: granite-moe, depth cut to 8 of 24 blocks (16 of 32 experts a
#: rank in the dense dispatch, GQA 8 / 4 heads of 64, the tied table of
#: 49155 rows whole); 18c: qwen3-1.7b, depth cut to 8 of 28 blocks (GQA
#: 8 / 4 heads of 128 with q/k norms, the tied table vocab-parallel:
#: 75968 rows a rank).  The cuts keep the phase's gloo traffic (the
#: gradients' all-reduce and the moments' gathers through the host)
#: inside its time; the width is full and the sequences are phase 13's.
TP18 = {
    "18a": ("gpt3-medium", 8, 2, dict(attn_impl="kernel")),
    "18b": ("granite-moe-1b-a400m", 8, 2, dict(attn_impl="kernel")),
    "18c": ("qwen3-1.7b", 8, 2, dict(attn_impl="kernel")),
}
#: phase 19's scenarios, the same world and layout as phase 18's: the
#: Mamba2 mixer under TP, each rank computing its whole heads.  19a:
#: mamba2-780m (24 Mamba2 heads of 64 a rank at state 128, in_proj's
#: 6448 columns gathered at use, the tied table of 50280 rows
#: vocab-parallel: 25140 a rank), depth cut to 8 of 48 blocks as in
#: phase 17c; 19b: hymba-1.5b (attention 15 / 10 query heads over 3 / 2
#: kv heads a rank under its window of 2048, 25 Mamba2 heads of 64 a rank
#: at state 16, the branches under one f and one g, MLP 2752 columns a
#: rank, the table of 32001 rows whole), depth cut to 4 of 32 blocks.
#: The cuts keep the gloo traffic (in_proj's and the attention's weights
#: gathered at use, the gradients and ZeRO-1's gathers through the host)
#: inside the phase's time; the width is full.
TP19 = {
    "19a": ("mamba2-780m", 8, 2, dict(ssd_impl="kernel")),
    "19b": ("hymba-1.5b", 4, 2, dict(attn_impl="kernel", ssd_impl="kernel")),
}
#: phase 19c: hymba-1.5b at full width over data 1 x model 8, a world of
#: 8 rank processes of its own: query heads 4 / 3 / ... / 3 of 25 over 5
#: kv heads, ranks 1, 4 and 6 straddling two kv groups (two flash pieces
#: a block: ``TPContext.pieces``), every attention weight gathered at use,
#: in_proj (6482 columns) and the 50 heads' dt_bias / A_log / D whole
#: through f, 7 / 6 Mamba2 heads a rank; depth cut to 2 of 32 blocks,
#: phase 13's first 2 sequences.  The CPU rehearsal runs it on model 4
#: with the reduced hymba at 9 / 3 heads, which places pieces the same
#: way (``TP_CPU_FIELDS``)
TP19C = {
    "19c": ("hymba-1.5b", 2, 2, dict(attn_impl="kernel", ssd_impl="kernel")),
}
TP_PHASES = {"18": TP18, "19": TP19, "19c": TP19C}
TP_STEPS = 2
#: the reduced arch's fields replaced in the CPU rehearsal
TP_CPU_FIELDS = {"19c": {"num_heads": 9, "num_kv_heads": 3}}


def tp_mesh(on_card, phase):
    """The (data, model) mesh of a phase 18, 19 or 19c world."""
    if phase == "19c":
        return (1, 8) if on_card else (1, 4)
    return MESH["shape"]


def _replicated_hashes(ex):
    """sha256 of each leaf whose spec does not name the model axis."""
    import hashlib
    from repro_torch.runtime.coordination import leaf_bytes
    from repro_torch.runtime.sharding import spec_leaves
    return {p: hashlib.sha256(leaf_bytes(t)).hexdigest()
            for p, spec, t in spec_leaves(ex.pspecs, ex.params)
            if "model" not in spec}


def _whole_mixer_bytes(arch, model):
    """Bytes of a block's Mamba2 mixer and attention weights the spec
    keeps whole (the model axis does not divide the cut dimension): each
    taken through *f*, whose backward all-reduces its gradient, tagged
    "tp", once a step (tests/test_torch_spmd_tp_ssm.py counts the same)."""
    c = arch.ssm
    d_inner = c.expand * arch.d_model
    heads = d_inner // c.head_dim
    gn = c.n_groups * c.state_size
    conv_dim = d_inner + 2 * gn
    cut = {"in_proj": (arch.d_model * (2 * d_inner + 2 * gn + heads),
                       2 * d_inner + 2 * gn + heads),
           "conv_w": (c.conv_width * conv_dim, conv_dim),
           "conv_b": (conv_dim, conv_dim),
           "dt_bias": (heads, heads), "A_log": (heads, heads),
           "D": (heads, heads)}
    if arch.num_heads:
        q = arch.num_heads * arch.head_dim
        kv = arch.num_kv_heads * arch.head_dim
        cut.update(wq=(arch.d_model * q, q), wk=(arch.d_model * kv, kv),
                   wv=(arch.d_model * kv, kv))
    return 4 * sum(n for n, dim in cut.values() if dim % model)


def tp_mixer_bytes(arch, rows, positions, remat=True, model=2):
    """The all-reduce bytes a rank a step of a phase 19 scenario over a
    model axis of ``model``, by tag, counted from the shapes as
    tests/test_torch_spmd_tp_ssm.py counts them.  "tp": per block, each
    *g* in the forward and each *f* in the backward ([rows, positions, d]
    fp32): mamba2's mixer one of each (torch's checkpoint stops its
    recompute at the block's last saved tensor, the input of out_proj's
    product, so the *g* after it is not rerun); hymba's branch pair one
    of each, its *g* again in remat's recompute (the MLP's saved tensors
    come after it), and the MLP's one of each; plus the weights the spec
    keeps whole, through *f* (``_whole_mixer_bytes``: none of either
    model at model 2; hymba-1.5b's in_proj of 6482 columns and its 50
    heads' dt_bias, A_log and D at model 8).  "ssm_norm": the gated
    norm's sum of squares ([rows, positions, 1] fp32) forward, again in
    the recompute, and its cotangents' sum backward."""
    act = rows * positions * arch.d_model * 4
    extra = 1 if remat else 0
    acts = 2 if arch.family == "ssm" else 2 + extra + 2
    return {"tp": arch.num_layers * (acts * act
                                     + _whole_mixer_bytes(arch, model)),
            "ssm_norm": arch.num_layers * (2 + extra) * rows * positions * 4}


def tp_rank(on_card, batch, phase="18"):
    """Phase 18, 19 or 19c, one rank's part (run by ``spawn_world``):
    the phase's scenarios in turn on this world's mesh (``tp_mesh``)
    under ``tp``."""
    import gc
    import torch
    from repro_torch.configs import ShapeConfig
    from repro_torch.kernels import build
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import ProcessMesh
    from repro_torch.optim import adamw
    from repro_torch.runtime import (ShardingStrategy, SPMDExecutor,
                                     track_compiles)
    from repro_torch.runtime.sharding import gather_tree
    from repro_torch.utils.tree import tree_leaves, tree_map
    dev = _world_device(on_card)
    mesh = ProcessMesh(("data", "model"), tp_mesh(on_card, phase))
    strategy = ShardingStrategy(strategy="tp")
    tr = mesh.transport
    out = {"rank": mesh.rank, "coords": mesh.coords}
    for name, (_, _, gb, _) in TP_PHASES[phase].items():
        arch, seq, model = seq_model(on_card, name)
        shape = ShapeConfig(f"phase{phase}-{name}", seq, gb, "train")
        b = _seq_batch(gb, batch)
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        params = model.init(torch.Generator(device=dev).manual_seed(0))
        ex = SPMDExecutor(model, params, adamw.AdamWConfig(**SPMD_OPT),
                          mesh=mesh, strategy=strategy, shape=shape)
        del params
        held = sum(t.numel() * t.element_size()
                   for t in tree_leaves((ex.params, ex.opt_state)))
        want = dryrun.spec_bytes(arch, shape, mesh, strategy, model=model)
        tp = strategy.tp_context(mesh, arch)
        r = {"held": held, "want": want["args"] - want["batch"],
             "heads": tp.heads, "kv_heads": tp.kv_heads,
             "pieces": tp.pieces, "ssm_heads": tp.ssm_heads,
             "experts": tp.experts,
             "vocab": tp.vocab, "builds_at_bind": ex.cache.stats.compiles}
        build.reset_launches()
        losses, bits, secs, moved, tagged, hashes = [], [], [], [], [], []
        with track_compiles() as log:
            for i in range(TP_STEPS):
                tr.reset()
                _sync(on_card)
                t0 = time.perf_counter()
                stats = ex.step(b)
                losses.append(float(stats["loss"]))
                _sync(on_card)
                secs.append(time.perf_counter() - t0)
                bits.append(stats["loss"].cpu().numpy().tobytes())
                moved.append(dict(tr.bytes))
                tagged.append({k: dict(v) for k, v in tr.tagged.items()})
                hashes.append(_replicated_hashes(ex))
                if i == 0:
                    r["aux1"] = float(stats["aux"])
                    full = gather_tree(ex.pspecs, ex.params, mesh,
                                       to_root=True)
                    r["params1"] = (tree_map(lambda t: t.cpu(), full)
                                    if full is not None else None)
                    del full
        r.update(losses=losses, bits=bits, secs=secs, moved=moved,
                 tagged=tagged, hashes=hashes, comm_s=tr.seconds,
                 launches=dict(build.LAUNCHES),
                 builds=ex.cache.stats.compiles + log.backend_compiles,
                 peak=torch.cuda.max_memory_allocated() if on_card else 0)
        out[name] = r
        del ex
    return out


def tp_dryrun(on_card, phase="18"):
    """The dry-run of each phase 18, 19 or 19c scenario on an abstract
    mesh of the phase's shape (``tp_mesh``) under ``tp``
    (``launch/dryrun.py::analyze``: a trace on fake tensors, no device):
    {name: its collectives' bytes a device by kind and site, and its
    per-device args and temps}.  Printed as JSON: the phase runs it in a
    process of its own beside the ranks."""
    import torch
    from repro_torch.configs import ShapeConfig
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.runtime import ShardingStrategy
    out = {}
    for name, (_, _, gb, _) in TP_PHASES[phase].items():
        arch, seq, model = seq_model(on_card, name)
        a = dryrun.analyze(arch, ShapeConfig(f"phase{phase}-{name}", seq, gb,
                                             "train"),
                           make_mesh(tp_mesh(on_card, phase),
                                     ("data", "model")),
                           ShardingStrategy(strategy="tp"),
                           dtype=torch.float32, moe_impl=model.moe_impl,
                           loss_chunk=model.loss_chunk)
        nb = a["bytes"]
        out[name] = {"by_kind": a["ops"]["collective_bytes_by_kind"],
                     "by_site": a["ops"]["collective_bytes_by_site"],
                     "args": nb["args"], "temps": nb["temps"],
                     "peak": (nb["args"] + nb["temps"] + nb["outputs"]
                              - nb["alias"]),
                     "trace_s": a["trace_s"]}
    print(json.dumps(out))


def start_tp_dryrun(on_card, phase="18"):
    """``tp_dryrun`` in a fresh interpreter (the CPU, no card)."""
    return _host_process(f"tp_dryrun({on_card!r}, {phase!r})")


def run_tp(device, batch, phase="18", trace=None):
    """Phase 18 (Megatron tensor and expert parallelism), 19 (the
    Mamba2 mixer and hymba under it) or 19c (hymba's query heads
    straddling kv groups over model 8): one world of fresh rank processes
    sharing the card (gloo; 4, or 8 for 19c: ``tp_mesh``), each scenario
    held to a one-program SPMDExecutor on the same weights and
    sequences.  A rank whose query heads are several pieces launches the
    flash kernels once a piece.  ``trace``: the phase's dry-run
    (``start_tp_dryrun``), started here if None.  Returns rank 0's
    launches over the phase's scenarios."""
    import gc
    import torch
    from repro_torch.launch.mesh import spawn_world
    from repro_torch.utils.tree import tree_leaves
    on_card = device.type == "cuda"
    scenarios = TP_PHASES[phase]
    t_phase = time.perf_counter()
    trace = trace or start_tp_dryrun(on_card, phase)
    try:
        refs = {name: _seq_reference(device, name, batch)
                for name in scenarios}
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()
        shape = tp_mesh(on_card, phase)
        ranks_n = shape[0] * shape[1]
        poller = _MemoryPeak(on_card)
        try:
            ranks = spawn_world("chip_smoke:tp_rank", ranks_n,
                                {"on_card": on_card, "batch": batch,
                                 "phase": phase},
                                device=device, paths=[ROOT], timeout=900)
        finally:
            smi = poller.stop()
        t_wait = time.perf_counter()
        stdout, stderr = trace.communicate(timeout=600)
        wait_s = time.perf_counter() - t_wait
    finally:
        if trace.poll() is None:
            trace.kill()
            trace.wait()
    check(trace.returncode == 0, f"tp dry-run exited {trace.returncode}: "
          f"{stderr[-2000:]}")
    dry = json.loads(stdout.strip().splitlines()[-1])
    total = {}
    for name in scenarios:
        arch, seq, _ = seq_model(on_card, name)
        loss_ref, aux_ref, p_ref, ref_s = refs[name]
        r0 = ranks[0][name]
        losses = r0["losses"]
        for rank in ranks:
            r = rank[name]
            check(r["held"] == r["want"],
                  f"tp {name} rank {rank['rank']}: state {r['held']} B, the "
                  f"dry-run's per-card args less the batch {r['want']} B")
            check(r["bits"] == r0["bits"],
                  f"tp {name} rank {rank['rank']} losses {r['losses']} vs "
                  f"rank 0's {losses}: not bitwise")
            check(r["builds_at_bind"] == 1 and r["builds"] == 1,
                  f"tp {name} rank {rank['rank']}: {r['builds_at_bind']} "
                  f"programs at bind, {r['builds']} after")
            if on_card:
                want_l = seq_launches(arch, TP_STEPS)
                for k in FLASH:           # once a piece of its heads
                    want_l[k] *= len(r["pieces"] or (None,))
                got = {k: r["launches"][k] for k in want_l}
                check(got == want_l, f"tp {name} rank {rank['rank']} "
                      f"launches {got}, expected {want_l}")
        # the TP form of replica_divergence() == 0: every leaf whose spec
        # does not name the model axis, bitwise across the model group
        groups = {}
        for rank in ranks:
            groups.setdefault(rank["coords"]["data"], []).append(rank[name])
        n_whole = len(r0["hashes"][0])
        for members in groups.values():
            for other in members[1:]:
                check(other["hashes"] == members[0]["hashes"],
                      f"tp {name}: a replicated leaf differs across the "
                      f"model group")
        check(all(math.isfinite(x) for x in losses),
              f"tp {name} losses {losses}")
        tol = EXECUTOR_TOL["atol"] + EXECUTOR_TOL["rtol"] * abs(loss_ref)
        check(abs(losses[0] - loss_ref) <= tol,
              f"tp {name} first loss {losses[0]!r} vs one program's "
              f"{loss_ref!r}")
        atol = EXECUTOR_TOL["atol"] + EXECUTOR_TOL["rtol"] * abs(aux_ref)
        check(abs(r0["aux1"] - aux_ref) <= atol,
              f"tp {name} first aux {r0['aux1']!r} vs one program's "
              f"{aux_ref!r}")
        worst, frac, ok = _params_track(tree_leaves(r0["params1"]),
                                        tree_leaves(p_ref), SPMD_OPT["lr"])
        check(ok, f"tp {name} params after step 1 vs one program's: max "
              f"{worst}, fraction above lr/10 {frac}")
        mixer = (f", Mamba2 heads {r0['ssm_heads']}"
                 if r0["ssm_heads"] is not None else "")
        print(f"[tp] {name} {arch.name} ({arch.num_layers} blocks, S {seq}, "
              f"global batch {scenarios[name][2]}, data {shape[0]} x model "
              f"{shape[1]}): a "
              f"rank's query heads {r0['heads']}, kv heads {r0['kv_heads']}"
              f"{mixer}, experts {r0['experts']}, vocabulary rows "
              f"{r0['vocab']} (None: whole); first loss {losses[0]!r} vs one "
              f"program's {loss_ref!r} ({ref_s:.4f}s), aux {r0['aux1']!r} vs "
              f"{aux_ref!r}; params after step 1 track it (max |diff| "
              f"{worst:.3g}, fraction above lr/10 {frac:.3g})")
        slowest = [round(max(rk[name]["secs"][i] for rk in ranks), 4)
                   for i in range(TP_STEPS)]
        print(f"[tp] {name} step seconds {[round(t, 4) for t in r0['secs']]}"
              f" (rank 0; slowest rank {slowest}), host seconds inside the "
              f"collectives on rank 0 {r0['comm_s']:.4f} (gloo's share of "
              f"its steps {r0['comm_s'] / sum(r0['secs']):.3f}); losses "
              f"{[round(x, 4) for x in losses]} bitwise on every rank; "
              f"{n_whole} leaves not cut over model bitwise across the "
              f"model group after every step; programs 1, builds after "
              f"bind 0; state {r0['held']} B a rank = the dry-run's "
              f"per-card args less the batch")
        reduced_tags = {tag: kinds["reduced"] for tag, kinds in
                        sorted(r0["tagged"][-1].items())}
        d = dry[name]
        act = {k: round(v) for k, v in sorted(d["by_site"].items())
               if k.startswith("all-reduce")}
        print(f"[tp] {name} bytes a step on rank 0 {r0['moved'][-1]}; by "
              f"what they carry (gathered + reduced + scattered) "
              f"{_tag_bytes(r0['tagged'][-1])}; all-reduced by tag "
              f"{reduced_tags}; the dry-run's all-reduce bytes a device for "
              f"this layout by site {act} (ring bytes: 2 (k-1)/k of the "
              f"buffer, = the buffer at k 2; trace {d['trace_s']}s)")
        if arch.ssm is not None:
            want_b = tp_mixer_bytes(arch, scenarios[name][2] // shape[0], seq,
                                    model=shape[1])
            for rank in ranks:
                got_b = [{tag: t.get(tag, {}).get("reduced", 0)
                          for tag in want_b} for t in rank[name]["tagged"]]
                check(got_b == [want_b] * TP_STEPS,
                      f"tp {name} rank {rank['rank']} all-reduce bytes "
                      f"{got_b}, counted from the shapes {want_b}")
            acts = sum(v for k, v in d["by_site"].items()
                       if k in ("all-reduce act", "all-reduce act-grad"))
            ours = want_b["tp"] + want_b["ssm_norm"]
            print(f"[tp] {name} all-reduce bytes a rank a step: tp "
                  f"{want_b['tp']}, ssm_norm {want_b['ssm_norm']} = the "
                  f"count from the shapes on every rank; their sum over the "
                  f"dry-run's act + act-grad {round(acts)}: "
                  f"{ours / acts if acts else float('nan'):.5f}")
        print(f"[tp] {name} launches a rank {r0['launches']}")
        pieces = [len(rk[name]["pieces"] or (None,)) for rk in ranks]
        if max(pieces) > 1:
            # the first rank whose query heads straddle kv groups (rank 1
            # on model 8) against rank 0, whose heads are one piece
            s = pieces.index(max(pieces))
            rs = ranks[s][name]
            flash = {rank: {k: ranks[rank][name]["launches"][k]
                            for k in FLASH} for rank in (0, s)}
            check(not on_card or all(
                flash[s][k] == pieces[s] * flash[0][k] for k in FLASH),
                f"tp {name}: rank {s}'s flash launches {flash[s]} are not "
                f"{pieces[s]} x rank 0's {flash[0]}")
            print(f"[tp] {name} flash pieces a block by rank {pieces}: rank "
                  f"{s}'s query heads {rs['heads']} over kv heads "
                  f"{rs['kv_heads']} in pieces {rs['pieces']}; flash "
                  f"launches rank 0 {flash[0]}, rank {s} {flash[s]}")
        for k, v in r0["launches"].items():
            total[k] = total.get(k, 0) + v
        if on_card:
            print(f"[tp] {name} peak max_memory_allocated a rank "
                  f"{[round(rk[name]['peak'] / 2**30, 2) for rk in ranks]} "
                  f"GiB; the dry-run's per-card peak {d['peak'] / 2**30:.2f} "
                  f"GiB (args {d['args'] / 2**30:.2f}, temps "
                  f"{d['temps'] / 2**30:.2f}; rank 0's heads traced)")
    mem = (f"nvidia-smi memory.used peak {smi} MiB ({ranks_n} ranks and "
           f"this process)" if on_card else
           "peak memory: not measured (cpu rehearsal)")
    print(f"[tp] phase {phase}: {mem}; the dry-run's trace ended "
          f"{wait_s:.1f}s after the ranks; phase "
          f"{time.perf_counter() - t_phase:.1f}s")
    return total


# ----------------------------------------------------------------------
# Phase 20: the reference's default dtype, bf16 activations over fp32
# parameters, at full width and depth on one card
# ----------------------------------------------------------------------
#: phase 20's scenarios, each ONE program (SPMDExecutor) at full width
#: and depth: 20a qwen3-1.7b (28 blocks, GQA 16 / 8 heads of 128, q/k
#: norms, the tied table of 151936 rows), 20b hymba-1.5b (32 blocks, GQA
#: 25 / 5 under its window of 2048 beside 50 Mamba2 heads of 64 at state
#: 16), 20c qwen2.5-3b (36 blocks, GQA 16 / 2 heads of 128, QKV bias, the
#: tied table), 20d musicgen-large (48 blocks, 32 heads of 64, 256 audio
#: frame embeddings ahead of the 2048 tokens, vocab 2048)
BF16_MODELS = {"20a": "qwen3-1.7b", "20b": "hymba-1.5b", "20c": "qwen2.5-3b",
               "20d": "musicgen-large"}
#: the scenarios rebound through a kill: the rebound trainer holds two
#: replicas, 16 B of fp32 state a parameter each (about 49-51 GiB here;
#: 92-96 GiB for 20c and 20d, which one card cannot hold)
BF16_REBIND = ("20a", "20b")
#: phase 13's sequences (its first 4: the global batch cut from 16 to
#: keep the phase's time), microbatch 1 for the rebound trainer, 2 steps
#: a dtype; the weights and musicgen's frame embeddings from ``seed``
BF16 = dict(global_batch=4, microbatch=1, steps=2, seed=20, cpu_layers=2)
BF16_DTYPES = ("float32", "bfloat16")
#: the first bf16 loss against the first fp32 loss on the same weights
#: and batch: |bf16 - fp32| <= 1e-2 |fp32|, 2.5 bf16 ulps (2^-8 relative)
#: of the loss.  The loss is an fp32 mean of fp32 log-sum-exps over
#: hidden states rounded to bf16 at every block's products: each
#: position's error is a few ulps of its logits, and the mean over 8188
#: positions averages them
BF16_LOSS_RTOL = 1e-2
#: the kernels' entry points in ``kernels/ops.py`` and the kernel each
#: launches once a call in the forward
ENTRIES = {"fused_add_rmsnorm": "add_rmsnorm_fwd", "fused_qkv": "gemm_bias",
           "flash_attention": "flash_fwd", "ssd": "ssd_fwd"}


def bf16_model(on_card, name, dtype, plain=False):
    """(arch, sequence, frontend positions, model) of a phase 20
    scenario: ``runtime/spmd.py::build_model`` on a 1 x 1 mesh in
    ``dtype`` with the flash, epilogue and SSD kernels, remat full and
    the chunked CE, at full width and depth on the card (2 blocks and
    phase 13's CPU sequence in the CPU rehearsal); ``plain``: the plain
    path (blocked attention, the chunked SSD scan, no fused epilogue, no
    remat) for the forward anchor."""
    import torch
    from repro_torch.configs import get_arch, reduced
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import Model
    from repro_torch.runtime import ShardingStrategy
    from repro_torch.runtime.spmd import build_model
    arch, seq = get_arch(BF16_MODELS[name]), SPMD["seq_len"]
    if not on_card:
        arch = reduced(arch, layers=BF16["cpu_layers"])
        seq = SPMD["cpu_seq_len"]
    F = arch.frontend_tokens if arch.frontend else 0
    dt = getattr(torch, dtype)
    if plain:
        model = Model(arch, dtype=dt, attn_impl="blocked", ssd_impl="chunked",
                      fuse="none", remat=False, loss_chunk=SPMD["loss_chunk"])
    else:
        model = build_model(arch, ShardingStrategy(),
                            make_mesh((1, 1), ("data", "model")),
                            BF16["global_batch"], dtype=dt,
                            attn_impl="kernel", ssd_impl="kernel",
                            fuse="fused", loss_chunk=SPMD["loss_chunk"])
    return arch, seq, F, model


def bf16_shape(name, seq, F):
    from repro_torch.configs import ShapeConfig
    return ShapeConfig(f"phase{name}", seq + F, BF16["global_batch"], "train")


def bf16_dryrun(on_card):
    """Phase 20's pricing: ``launch/dryrun.py::analyze`` of each scenario
    on a 1 x 1 mesh in each dtype it runs (FakeTensor traces, no
    device).  Prints one JSON line a scenario as it ends, then
    all of them: {name: {dtype: bytes, predicted peak, fits, the global
    step's FLOPs, trace seconds}}."""
    import torch
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.runtime import ShardingStrategy
    torch.set_num_threads(1)
    out = {}
    for name in BF16_MODELS:
        for dtype in BF16_DTYPES:
            arch, seq, F, _ = bf16_model(on_card, name, dtype)
            a = dryrun.analyze(arch, bf16_shape(name, seq, F),
                               make_mesh((1, 1), ("data", "model")),
                               ShardingStrategy(), dtype=getattr(torch, dtype),
                               loss_chunk=SPMD["loss_chunk"], moe_impl="dense")
            nb = a["bytes"]
            out.setdefault(name, {})[dtype] = {
                **nb, "peak": (nb["args"] + nb["temps"] + nb["outputs"]
                               - nb["alias"]),
                "fits": a["fits_hbm"], "flops": a["roofline"]["flops_global"],
                "trace_s": a["trace_s"]}
        print(json.dumps({name: out[name]}), flush=True)
    print(json.dumps(out), flush=True)


def _host_process(call):
    """``call`` (a chip_smoke function call, as source) in a fresh
    interpreter on the CPU, its standard output piped."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [SRC, ROOT, os.environ.get("PYTHONPATH", "")]),
        CUDA_VISIBLE_DEVICES="")
    return subprocess.Popen(
        [sys.executable, "-c", f"import chip_smoke; chip_smoke.{call}"],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def start_bf16_dryrun(on_card):
    """``bf16_dryrun`` in a fresh interpreter (the CPU, no card)."""
    return _host_process(f"bf16_dryrun({on_card!r})")


class count_entries:
    """Counts the calls of the kernels' entry points (``ENTRIES``) while
    the block runs: on the CPU, where the plain versions stand in and no
    kernel launches, the forward half of a launch count."""

    def __enter__(self):
        from repro_torch.kernels import ops
        self.counts = dict.fromkeys(ENTRIES.values(), 0)
        self.saved = {n: getattr(ops, n) for n in ENTRIES}

        def counted(n, fn):
            def call(*args, **kw):
                self.counts[ENTRIES[n]] += 1
                return fn(*args, **kw)
            return call
        for n, fn in self.saved.items():
            setattr(ops, n, counted(n, fn))
        return self.counts

    def __exit__(self, *exc):
        from repro_torch.kernels import ops
        for n, fn in self.saved.items():
            setattr(ops, n, fn)


def forward_launches(want):
    """The forward half of a ``seq_launches`` count: what the entry
    points launch (the QKV GEMM's forward: its launches less the dx and
    dW of each backward)."""
    return {"add_rmsnorm_fwd": want["add_rmsnorm_fwd"],
            "gemm_bias": want["gemm_bias"] - 2 * want["add_rmsnorm_bwd"],
            "flash_fwd": want["flash_fwd"],
            "ssd_fwd": want["ssd_fwd"]}


def wgmma_launches(want):
    """A bf16 run's count: its flash forwards and QKV GEMMs (forward, dx,
    dW) and its SSD pair run the wgmma instances, which every phase 20
    shape takes, and their mma.sync instances launch none."""
    out = dict(want)
    for name, of in WGMMA.items():
        if of in out:
            out[name], out[of] = out[of], 0
    return out


def bf16_engine(arch, seq):
    """The engine of a rebound scenario: phase 13's (5 nodes, f 1, n0 2)
    over phase 20's global batch in microbatches of 1."""
    from repro_torch.core import EngineConfig, OobleckEngine, build_profile
    return OobleckEngine(
        build_profile(arch, microbatch=BF16["microbatch"], seq_len=seq),
        [f"node{i}" for i in range(SPMD["nodes"])],
        EngineConfig(fault_tolerance=SPMD["f"],
                     global_batch=BF16["global_batch"],
                     microbatch=BF16["microbatch"], gpus_per_node=1,
                     n0_override=SPMD["n0"]))


def _bf16_kill(ex, engine):
    """Phase 13's failure in bf16: a node killed through the engine's
    monitor, the executor's ``recover`` refused, the plan still covering
    every replica.  Returns {"victim", "snap": the executor's
    snapshot}."""
    from repro_torch.core import verify_replica_coverage
    from repro_torch.core.monitor import NodeChangeMonitor
    from repro_torch.runtime import ExecutorUnsupported
    victim = engine.instances[0].nodes[-1]
    refused = False
    try:
        ex.recover({victim})
    except ExecutorUnsupported:
        refused = True
    check(refused, "bf16: recover did not raise ExecutorUnsupported")
    engine.monitor.inject(NodeChangeMonitor.FAIL, [victim])
    engine.monitor.poll(now=0.0)
    check(victim not in engine.nodes and
          verify_replica_coverage(engine.instances),
          f"bf16: the plan after killing {victim}: {engine.nodes}")
    snap = ex.snapshot()
    engine.attach_executor(None)
    return {"victim": victim, "snap": snap}


def _bf16_rebind(device, killed, engine, model, seq, opt_cfg):
    """A HeteroTrainer rebound from the bf16 snapshot that ``killed``
    (``_bf16_kill``) hands over, the executor already freed: the
    trainer's two replicas and the snapshot fill most of the card, so
    the snapshot is dropped before the step.  The trainer syncs per
    layer: the bucketed plane's packed contributions are a second copy
    of both replicas' gradients, which with qwen3-1.7b's table untied (a
    copy for the head stage, as the reference's split makes) ran out of
    the 80 GB at the sync.  Returns (the victim, rebind
    seconds, step seconds, loss, the replicas' node counts)."""
    import gc
    import torch
    from repro_torch.data import ByteCorpus, GlobalBatchDispenser
    from repro_torch.launch.train import _TEXT, microbatches
    from repro_torch.runtime import HeteroTrainer, track_compiles
    from repro_torch.utils.tree import tree_leaves
    on_card = device.type == "cuda"
    snap = killed.pop("snap")
    t0 = time.perf_counter()
    rebound = HeteroTrainer(model, engine, snap.params, opt_cfg,
                            opt_state=snap.opt_state, sync_mode="perlayer")
    rebound.warm_templates()
    if on_card:
        torch.cuda.synchronize()
    rebind_s = time.perf_counter() - t0
    check(all(torch.equal(a, b) for a, b in zip(
        tree_leaves(rebound.full_params()), tree_leaves(snap.params))),
          "bf16: the rebound trainer's params differ from the snapshot's")
    check(rebound.replica_divergence() == 0.0, "bf16: rebound divergence")
    del snap
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    batches = GlobalBatchDispenser(ByteCorpus(_TEXT * 50, seq_len=seq)
                                   ).next_step(engine.batch.minibatch_sizes())
    with track_compiles() as log:
        t0 = time.perf_counter()
        loss = float(rebound.step([microbatches(b, BF16["microbatch"])
                                   for b in batches])["loss"])
        if on_card:
            torch.cuda.synchronize()
        step_s = time.perf_counter() - t0
    check(math.isfinite(loss) and log.backend_compiles == 0,
          f"bf16 rebound step: loss {loss}, {log.backend_compiles} builds")
    check(rebound.replica_divergence() == 0.0,
          "bf16: divergence after the rebound step")
    replicas = [i.template.num_nodes for i in engine.instances]
    engine.attach_executor(None)
    del rebound
    return killed["victim"], rebind_s, step_s, loss, replicas


def _bf16_scenario(device, name, batch):
    """One phase 20 scenario: the plain fp32 anchor, then 2 steps of one
    program in fp32 and in bf16 from the same weights (and, for
    ``BF16_REBIND``, the kill and rebind in bf16).  Returns its numbers,
    per dtype."""
    import gc
    import torch
    from repro_torch.kernels import build
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.optim import adamw
    from repro_torch.runtime import (ShardingStrategy, SPMDExecutor,
                                     track_compiles)
    from repro_torch.utils.tree import tree_leaves
    on_card = device.type == "cuda"
    gb, steps = BF16["global_batch"], BF16["steps"]
    mesh = make_mesh((1, 1), ("data", "model"))
    opt_cfg = adamw.AdamWConfig(**SPMD_OPT)

    def sync():
        if on_card:
            torch.cuda.synchronize()

    def free():
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()

    def weights(model):
        # the scenario's weights, drawn anew for each dtype: the same
        # generator and seed give the same tensors
        return model.init(torch.Generator(device=device).manual_seed(
            BF16["seed"]))

    arch, seq, F, model = bf16_model(on_card, name, "float32")
    shape = bf16_shape(name, seq, F)
    data = {k: torch.from_numpy(batch[k][:gb]).to(device, torch.int32)
            for k in ("tokens", "labels")}
    if F:       # musicgen's frame embeddings, in the specs' dtype
        data["frontend_embeds"] = (torch.randn(
            (gb, F, arch.d_model), device=device,
            generator=torch.Generator(device=device).manual_seed(
                BF16["seed"])) * 0.02).to(torch.bfloat16)
    check(tuple(data["tokens"].shape) == (gb, seq),
          f"bf16 {name} batch {tuple(data['tokens'].shape)}")
    spec = dryrun.spec_bytes(arch, shape, mesh, ShardingStrategy(),
                             model=model)
    want_state = spec["args"] - spec["batch"]
    want_l = seq_launches(arch, steps)
    out = {"arch": arch, "seq": seq, "F": F}

    # 1. the plain anchor: the forward alone, fp32, no kernel
    free()
    params = weights(model)
    plain = bf16_model(on_card, name, "float32", plain=True)[3]
    sync()
    t0 = time.perf_counter()
    with torch.no_grad():
        loss_plain = float(plain.loss(params, data)[0])
    sync()
    out["plain"] = (loss_plain, time.perf_counter() - t0)
    for dtype in BF16_DTYPES:
        if dtype == "bfloat16":
            model = bf16_model(on_card, name, dtype)[3]
            params = weights(model)
        engine = (bf16_engine(arch, seq)
                  if dtype == "bfloat16" and name in BF16_REBIND else None)
        free()
        base = torch.cuda.memory_allocated() if on_card else 0
        t0 = time.perf_counter()
        ex = SPMDExecutor(model, params, opt_cfg, mesh=mesh,
                          strategy=ShardingStrategy(), shape=shape,
                          engine=engine)
        sync()
        bind_s = time.perf_counter() - t0
        held = (torch.cuda.memory_allocated() - base if on_card else
                sum(t.numel() * t.element_size()
                    for t in tree_leaves((ex.params, ex.opt_state))))
        del params
        free()
        check(abs(held - want_state) <= 1e-3 * want_state,
              f"bf16 {name} {dtype}: state {held} B against the dry-run's "
              f"args less the batch {want_state} B")
        check(ex.cache.stats.compiles == 1,
              f"bf16 {name} {dtype}: bind built {ex.cache.stats.compiles}")
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        build.reset_launches()
        losses, secs = [], []
        with track_compiles() as log, count_entries() as entries:
            for _ in range(steps):
                sync()
                t0 = time.perf_counter()
                losses.append(float(ex.step(data)["loss"]))
                sync()
                secs.append(time.perf_counter() - t0)
        want = wgmma_launches(want_l) if dtype == "bfloat16" else want_l
        launches = {k: build.LAUNCHES[k] for k in want}
        check(all(math.isfinite(x) for x in losses)
              and all(b < a for a, b in zip(losses, losses[1:])),
              f"bf16 {name} {dtype} losses {losses}: not finite and falling")
        check(ex.cache.stats.compiles == 1 and log.backend_compiles == 0,
              f"bf16 {name} {dtype}: {ex.cache.stats.compiles} programs, "
              f"{log.backend_compiles} builds after bind")
        check(entries == forward_launches(want_l),
              f"bf16 {name} {dtype} entry calls {entries}, the count's "
              f"forward half {forward_launches(want_l)}")
        if on_card:
            check(launches == want, f"bf16 {name} {dtype} launches "
                  f"{launches}, counted from the shapes {want}")
        out[dtype] = dict(losses=losses, secs=secs, bind_s=bind_s,
                          held=held, launches=launches, entries=dict(entries),
                          peak=(torch.cuda.max_memory_allocated() if on_card
                                else 0))
        killed = _bf16_kill(ex, engine) if engine is not None else None
        del ex
        free()
        if killed is not None:
            out["rebind"] = _bf16_rebind(device, killed, engine, model, seq,
                                         opt_cfg)
            free()
    first32, first16 = out["float32"]["losses"][0], out["bfloat16"]["losses"][0]
    tol = EXECUTOR_TOL["atol"] + EXECUTOR_TOL["rtol"] * abs(loss_plain)
    check(abs(first32 - loss_plain) <= tol,
          f"bf16 {name}: first fp32 loss {first32!r} vs the plain forward's "
          f"{loss_plain!r}")
    gap = abs(first16 - first32) / abs(first32)
    check(gap <= BF16_LOSS_RTOL,
          f"bf16 {name}: first bf16 loss {first16!r} vs fp32 {first32!r}: "
          f"relative gap {gap:.3e} above {BF16_LOSS_RTOL}")
    out["tol"], out["gap"] = tol, gap
    return out


def _print_bf16(name, r, on_card):
    """A scenario's ``[bf16]`` lines as it ends: its losses against the
    plain forward and each other, each dtype's steps and launches, the
    rebind."""
    arch, seq, F = r["arch"], r["seq"], r["F"]
    f32, b16 = r["float32"], r["bfloat16"]
    loss_plain, plain_s = r["plain"]
    print(f"[bf16] {name} {arch.name} ({arch.num_layers} blocks, d "
          f"{arch.d_model}, S {seq}{f' + {F} frame embeddings' if F else ''}"
          f", global batch {BF16['global_batch']}, one program): plain fp32 "
          f"forward loss {loss_plain!r} ({plain_s:.4f}s); first fp32 loss "
          f"{f32['losses'][0]!r} (|diff| "
          f"{abs(f32['losses'][0] - loss_plain):.3e}, tol {r['tol']:.3e}); "
          f"first bf16 loss {b16['losses'][0]!r}, relative gap to fp32 "
          f"{r['gap']:.3e} (tol {BF16_LOSS_RTOL})")
    for dtype in BF16_DTYPES:
        d = r[dtype]
        print(f"[bf16] {name} {dtype}: bind {d['bind_s']:.4f}s, state "
              f"{d['held']} B = the dry-run's args less the batch; step "
              f"seconds {[round(t, 4) for t in d['secs']]}, losses "
              f"{d['losses']}, programs 1, builds after bind 0, "
              + (f"launches {d['launches']} = the count from the shapes, "
                 if on_card else "")
              + f"entry calls {d['entries']} = the count's forward half")
    if "rebind" in r:
        victim, rebind_s, step_s, loss, replicas = r["rebind"]
        print(f"[bf16] {name} bfloat16: killed {victim}: recover raised "
              f"ExecutorUnsupported, the plan covers every replica "
              f"({replicas}); HeteroTrainer rebound from the snapshot in "
              f"{rebind_s:.4f}s (params bitwise, divergence 0), its step "
              f"{step_s:.4f}s, loss {loss!r}, divergence 0, 0 builds")


def run_bf16(device, batch, trace=None):
    """Phase 20: each scenario (``BF16_MODELS``) as one program at full
    width and depth, held to the plain fp32 forward, then its bf16 run to
    its fp32 run; ``trace``: the phase's pricing (``start_bf16_dryrun``),
    started here if None, whose numbers are printed beside the measured
    peaks and rates.  Returns the kernels' launches over the bf16 runs
    of the four scenarios."""
    on_card = device.type == "cuda"
    t_phase = time.perf_counter()
    trace = trace or start_bf16_dryrun(on_card)
    runs = {}
    try:
        for name in BF16_MODELS:
            runs[name] = _bf16_scenario(device, name, batch)
            _print_bf16(name, runs[name], on_card)
        t_wait = time.perf_counter()
        stdout, stderr = trace.communicate(timeout=900)
        wait_s = time.perf_counter() - t_wait
    finally:
        if trace.poll() is None:
            trace.kill()
            trace.wait()
    check(trace.returncode == 0, f"bf16 dry-run exited {trace.returncode}: "
          f"{stderr[-2000:]}")
    dry = json.loads(stdout.strip().splitlines()[-1])
    total = {}
    for name, r in runs.items():
        for dtype in BF16_DTYPES:
            d, p = r[dtype], dry[name][dtype]
            flops, steady = p["flops"], d["secs"][-1]
            if on_card:
                print(f"[bf16] {name} {dtype}: peak max_memory_allocated "
                      f"{d['peak'] / 2**30:.2f} GiB; the dry-run's predicted "
                      f"peak {p['peak'] / 2**30:.2f} GiB (args "
                      f"{p['args'] / 2**30:.2f} + temps "
                      f"{p['temps'] / 2**30:.2f}), measured/predicted "
                      f"{d['peak'] / p['peak']:.3f}; {flops / 1e12:.2f} TFLOP "
                      f"a step over {steady:.4f}s = "
                      f"{flops / steady / 1e12:.2f} TFLOP/s, "
                      f"{flops / steady / FP32_PEAK:.3f} of the "
                      f"{FP32_PEAK / 1e12:.0f} TFLOP/s fp32 peak, "
                      f"{flops / steady / PEAK_FLOPS['torch.bfloat16']:.4f} "
                      f"of the 989 TFLOP/s bf16 dense peak")
            else:
                print(f"[bf16] {name} {dtype}: peak memory and TFLOP/s: not "
                      f"measured (cpu rehearsal); the dry-run's predicted "
                      f"peak {p['peak']} B, {flops:.4g} FLOP a step (trace "
                      f"{p['trace_s']}s)")
        for k, v in r["bfloat16"]["launches"].items():
            total[k] = total.get(k, 0) + v
    print(f"[bf16] phase 20: the dry-run's traces ended {wait_s:.1f}s after "
          f"the scenarios; phase {time.perf_counter() - t_phase:.1f}s")
    return total


# ----------------------------------------------------------------------
# Phase 21: the prefill and decode bundles run over the process mesh
# ----------------------------------------------------------------------
#: phase 21's cases over one world of 4 rank processes on data 2 x model
#: 2, each served by ``SPMDServer`` and held to one program (the same
#: Model without a mesh, on the card, on the same weights): name ->
#: (arch, blocks on the card, strategy, model options, (teacher-forced
#: ticks, greedy ticks) on the card).  Prompts: phase 13's first 4
#: sequences of 2048; fp32; full width.  21a: qwen3-1.7b under TP (8 /
#: 4 heads of 128 a rank, the tied table vocab-parallel: 75968 rows a
#: rank), 8 of 28 blocks as phase 18c; 21b: hymba-1.5b under TP (15 / 3
#: and 10 / 2 heads under its window of 2048, 25 Mamba2 heads a rank, the
#: table of 32001 rows whole), 8 of 32 blocks and 16 ticks, because the
#: spec's cut of its attention weights falls inside a head and its
#: in_proj is taken whole, so every tick gathers them at use (≈ 66 MB a
#: block, 529 MB a tick: at 64 + 32 ticks its decode took 109 s of the
#: phase's 170 s on an H100 whose host ran gloo slowly); 21c:
#: granite-moe under FSDP (one row a rank; the capacity dispatch for
#: prefill, the server's grouped one for decode), 4 of 24 blocks and 16
#: ticks, because FSDP gathers every weight on every tick.  The cuts keep
#: the gloo traffic inside the phase's time.
SERVE21 = {
    "21a": ("qwen3-1.7b", 8, "tp", dict(attn_impl="kernel"), (64, 32)),
    "21b": ("hymba-1.5b", 8, "tp", dict(attn_impl="kernel",
                                        ssd_impl="kernel"), (8, 8)),
    "21c": ("granite-moe-1b-a400m", 4, "fsdp", dict(attn_impl="kernel"),
            (8, 8)),
}
SERVE21_BATCH = 4
SERVE21_CPU_TICKS = (4, 2)


def serve_model(on_card, name):
    """(arch, sequence, (teacher-forced, greedy) ticks, model) of a phase
    21 case: fp32, the kernels, no remat, the capacity dispatch (the
    server's decode takes the grouped one); 2 blocks, phase 13's CPU
    sequence and a few ticks in the CPU rehearsal."""
    import dataclasses
    import torch
    from repro_torch.configs import get_arch, reduced
    from repro_torch.models import Model
    arch_name, layers, _, opts, ticks = SERVE21[name]
    arch, seq = get_arch(arch_name), SPMD["seq_len"]
    if on_card:
        arch = dataclasses.replace(arch, num_layers=layers)
    else:
        arch, seq, ticks = (reduced(arch, layers=2), SPMD["cpu_seq_len"],
                            SERVE21_CPU_TICKS)
    model = Model(arch, dtype=torch.float32, fuse="fused", remat=False,
                  moe_impl="capacity", **opts)
    return arch, seq, ticks, model


def serve_launches(arch):
    """Each kernel's launches in one prefill of a rank: a block's fused
    QKV, flash forward and fused residual-add + RMSNorm once (a Mamba2
    mixer's SSD forward once).  The decode ticks are held to none."""
    L = arch.num_layers
    out = {k: 0 for k in KERNELS}
    if arch.family != "ssm":
        out.update({k: L for k in ("add_rmsnorm_fwd", "gemm_bias",
                                   "flash_fwd")})
    if arch.ssm is not None:
        out["ssd_fwd"] = L
    return out


def serve_reduced_bytes(arch, strategy, rows, positions, vocab_cut,
                        groups=1):
    """The all-reduce (and broadcast) bytes of one call on a rank of data
    2 x model 2, by tag, counted from the shapes.  TP: per block each *g*
    ([rows, positions, d] fp32): the attention's or hymba's branch pair's
    one and the MLP's one; the gated norm's sum of squares ([rows,
    positions, 1]) under "ssm_norm"; the vocab-parallel embedding's *g*
    under "vocab".  FSDP: the MoE router's statistics ([groups, 2E + 1]
    fp32 a block) in prefill, where every rank holds other tokens."""
    act = rows * positions * arch.d_model * 4
    if strategy == "fsdp":
        m = arch.moe
        return {"router": (arch.num_layers * groups * (2 * m.num_experts + 1)
                           * 4 if m is not None and positions > 1 else 0)}
    acts = 1 if arch.family == "ssm" else 2
    return {"tp": arch.num_layers * acts * act,
            "ssm_norm": (arch.num_layers * rows * positions * 4
                         if arch.ssm is not None else 0),
            "vocab": act if vocab_cut else 0}


def _tensor_bytes(tree):
    from repro_torch.utils.tree import tree_leaves
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))


def serve_rank(on_card, batch):
    """Phase 21, one rank's part (run by ``spawn_world``): every case in
    turn on this world's data 2 x model 2 mesh."""
    import gc
    import hashlib
    import torch
    from repro_torch.configs import ShapeConfig
    from repro_torch.kernels import build
    from repro_torch.launch.mesh import ProcessMesh
    from repro_torch.runtime import ShardingStrategy, SPMDServer
    from repro_torch.runtime.sharding import sharded_dims, spec_leaves
    dev = _world_device(on_card)
    mesh = ProcessMesh(("data", "model"), MESH["shape"])
    tr = mesh.transport
    out = {"rank": mesh.rank, "coords": mesh.coords}
    for name, (_, _, strat, _, _) in SERVE21.items():
        arch, seq, (forced, greedy), model = serve_model(on_card, name)
        strategy = ShardingStrategy(strategy=strat)
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        params = model.init(torch.Generator(device=dev).manual_seed(0))
        server = SPMDServer(model, params, mesh, strategy,
                            ShapeConfig(f"phase21-{name}", seq,
                                        SERVE21_BATCH, "prefill"))
        # FSDP gathers each cut leaf whole once a call
        gathered = sum(t.numel() * t.element_size() for _, spec, t in
                       spec_leaves(server.pspecs, params)
                       if sharded_dims(spec))
        del params
        tp = server._model.tp
        tokens = torch.from_numpy(
            server.rows(batch["tokens"][:SERVE21_BATCH, :seq])).to(dev)
        r = {"rows": tokens.shape[0], "gathered_want": gathered,
             "kv_heads": tp.kv_heads if tp is not None else None,
             "ssm_heads": tp.ssm_heads if tp is not None else None,
             "vocab": tp.vocab if tp is not None else None}
        build.reset_launches()
        tr.reset()
        _sync(on_card)
        t0 = time.perf_counter()
        logits = server.prefill({"tokens": tokens})
        _sync(on_card)
        r.update(prefill_s=time.perf_counter() - t0, prefill_comm_s=tr.seconds,
                 prefill_bytes=dict(tr.bytes),
                 prefill_tagged={k: dict(v) for k, v in tr.tagged.items()},
                 launches=dict(build.LAUNCHES))
        full = server.gather_rows(logits)
        r["prefill"] = full.cpu() if mesh.rank == 0 else None
        hashes = [hashlib.sha256(logits.cpu().numpy().tobytes()).hexdigest()]
        cache = server.init_cache(forced + greedy)
        r["cache_held"] = _tensor_bytes(cache)
        tok, ticks, tick_s, comm_s, picks = tokens[:, :1], [], [], 0.0, []
        build.reset_launches()
        for t in range(forced + greedy):
            tr.reset()
            _sync(on_card)
            t0 = time.perf_counter()
            lg, cache = server.decode(tok, cache, t)
            _sync(on_card)
            tick_s.append(time.perf_counter() - t0)
            comm_s += tr.seconds
            if t == 0:
                r["tick_bytes"] = dict(tr.bytes)
                r["tick_tagged"] = {k: dict(v) for k, v in tr.tagged.items()}
            hashes.append(hashlib.sha256(lg.cpu().numpy().tobytes()
                                         ).hexdigest())
            whole = server.gather_rows(lg)
            if mesh.rank == 0:
                ticks.append(whole.cpu())
            nxt = lg[:, -1].argmax(-1, keepdim=True).to(torch.int32)
            if t + 1 >= forced:
                picks.append(server.gather_rows(nxt).cpu())
            tok = tokens[:, t + 1:t + 2] if t + 1 < forced else nxt
        r["decode_launches"] = dict(build.LAUNCHES)
        full = server.gather_cache(cache)
        r.update(tick_s=tick_s, decode_comm_s=comm_s, hashes=hashes,
                 ticks=torch.stack(ticks) if ticks else None,
                 picks=torch.cat(picks, 1),
                 cache=({p: {k: v.cpu() for k, v in leaves.items()}
                         for p, leaves in full.items()}
                        if mesh.rank == 0 else None),
                 builds=server.cache.stats.compiles,
                 peak=torch.cuda.max_memory_allocated() if on_card else 0)
        out[name] = r
        del server, cache, full
    return out


def serve_reference(device, name, batch):
    """A phase 21 case as one program on this process's device: the same
    Model without a mesh on the same weights, the prefill and the same
    ticks.  Returns its outputs on the host and the cache's spec bytes a
    rank of data 2 x model 2 (``cache_shardings``)."""
    import dataclasses
    import gc
    import torch
    from repro_torch.launch.mesh import group_size, make_mesh
    from repro_torch.runtime import ShardingStrategy
    from repro_torch.runtime.sharding import sharded_dims, spec_leaves
    from repro_torch.runtime.spmd import DECODE_MOE_IMPL
    on_card = device.type == "cuda"
    arch, seq, (forced, greedy), model = serve_model(on_card, name)
    decode = dataclasses.replace(model, moe_impl=DECODE_MOE_IMPL)
    params = model.init(torch.Generator(device=device).manual_seed(0))
    tokens = torch.from_numpy(batch["tokens"][:SERVE21_BATCH, :seq]
                              ).to(device)
    with torch.no_grad():
        _sync(on_card)
        t0 = time.perf_counter()
        prefill = model.prefill(params, tokens)
        _sync(on_card)
        prefill_s = time.perf_counter() - t0
        cache = model.init_cache(SERVE21_BATCH, forced + greedy, device)
        tok, ticks, picks, gaps = tokens[:, :1], [], [], []
        t0 = time.perf_counter()
        for t in range(forced + greedy):
            lg = decode.decode_step_(params, tok, cache, t)
            ticks.append(lg.cpu())
            nxt = lg[:, -1].argmax(-1, keepdim=True).to(torch.int32)
            if t + 1 >= forced:
                picks.append(nxt.cpu())
                top2 = lg[:, -1].topk(2, -1).values
                gaps.append(float((top2[:, 0] - top2[:, 1]).min()))
            tok = tokens[:, t + 1:t + 2] if t + 1 < forced else nxt
        _sync(on_card)
        tick_s = (time.perf_counter() - t0) / (forced + greedy)
    mesh = make_mesh(MESH["shape"], ("data", "model"))
    specs = ShardingStrategy(strategy=SERVE21[name][2]).cache_shardings(
        mesh, cache, SERVE21_BATCH)
    spec_bytes = sum(t.numel() * t.element_size() // math.prod(
        group_size(mesh, a) for _, a in sharded_dims(spec))
        for _, spec, t in spec_leaves(specs, cache))
    out = {"prefill": prefill.cpu(), "ticks": torch.stack(ticks),
           "picks": torch.cat(picks, 1), "gap": min(gaps),
           "cache": {p: {k: v.cpu() for k, v in leaves.items()}
                     for p, leaves in cache.items()},
           "spec_bytes": spec_bytes, "prefill_s": prefill_s,
           "tick_s": tick_s}
    del params, cache, prefill
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    return out


def _within(got, want):
    """(max |got - want|, the largest ratio of an element's error to its
    limit): the limit is tests/test_executor.py's fp32 tolerance at the
    scale of the element's row, the largest magnitude of ``want`` along
    the last dimension (the logits of a row share one scale, and
    elements near zero carry the rounding of the whole dot product; a
    cache's row is a head's vector or a state's last axis).  Within it
    where the ratio is at most 1."""
    got, want = got.float(), want.float()
    diff = (got - want).abs()
    limit = (EXECUTOR_TOL["atol"] + EXECUTOR_TOL["rtol"]
             * want.abs().amax(-1, keepdim=True))
    return float(diff.max()), float((diff / limit).max())


def run_serve(device, batch):
    """Phase 21: the prefill and decode bundles over one world of 4 fresh
    rank processes sharing the card (gloo), each case held to one
    program.  Returns rank 0's launches over the cases."""
    import gc
    import torch
    from repro_torch.launch.mesh import spawn_world
    on_card = device.type == "cuda"
    t_phase = time.perf_counter()
    refs = {name: serve_reference(device, name, batch) for name in SERVE21}
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    poller = _MemoryPeak(on_card)
    try:
        ranks = spawn_world("chip_smoke:serve_rank", 4,
                            {"on_card": on_card, "batch": batch},
                            device=device, paths=[ROOT], timeout=900)
    finally:
        smi = poller.stop()
    total = {}
    for name, (_, _, strat, _, _) in SERVE21.items():
        arch, seq, (forced, greedy), _ = serve_model(on_card, name)
        ref, r0 = refs[name], ranks[0][name]
        for rank in ranks:
            r = rank[name]
            check(r["builds"] == 2, f"serve {name} rank {rank['rank']}: "
                  f"{r['builds']} programs (one prefill, one decode)")
            check(torch.equal(r["picks"], r0["picks"]),
                  f"serve {name} rank {rank['rank']}: greedy tokens differ")
            if on_card:
                want_l = serve_launches(arch)
                got = {k: r["launches"][k] for k in want_l}
                check(got == want_l, f"serve {name} rank {rank['rank']} "
                      f"launches {got}, expected {want_l}")
            check(not any(r["decode_launches"].values()),
                  f"serve {name} rank {rank['rank']}: the decode ticks "
                  f"launched {r['decode_launches']}")
            rows, positions = r["rows"], seq
            want_b = serve_reduced_bytes(arch, strat, rows, positions,
                                         r["vocab"] is not None,
                                         groups=seq // min(1024, seq))
            got_b = {tag: r["prefill_tagged"].get(tag, {}).get("reduced", 0)
                     for tag in want_b}
            check(got_b == want_b, f"serve {name} rank {rank['rank']} "
                  f"prefill all-reduce bytes {got_b}, counted {want_b}")
            want_t = serve_reduced_bytes(arch, strat, rows, 1,
                                         r["vocab"] is not None)
            got_t = {tag: r["tick_tagged"].get(tag, {}).get("reduced", 0)
                     for tag in want_t}
            check(got_t == want_t, f"serve {name} rank {rank['rank']} tick "
                  f"all-reduce bytes {got_t}, counted {want_t}")
            if strat == "fsdp":
                for what in ("prefill_bytes", "tick_bytes"):
                    check(r[what]["gathered"] == r["gathered_want"],
                          f"serve {name} rank {rank['rank']} {what} "
                          f"gathered {r[what]['gathered']} B, the cut "
                          f"leaves' {r['gathered_want']} B")
            if r["vocab"] is not None:
                v = rows * arch.vocab_size * 4
                check(r["prefill_tagged"]["vocab"]["gathered"] == v,
                      f"serve {name}: the logits' gather "
                      f"{r['prefill_tagged']['vocab']['gathered']} B vs {v}")
        # outputs replicated across a model group: bitwise on its ranks
        groups = {}
        for rank in ranks:
            key = (rank["coords"]["data"] if strat == "tp" else rank["rank"])
            groups.setdefault(key, []).append(rank[name]["hashes"])
        for members in groups.values():
            check(all(m == members[0] for m in members),
                  f"serve {name}: a model group's ranks differ")
        perr, pratio = _within(r0["prefill"], ref["prefill"])
        check(pratio <= 1, f"serve {name} prefill logits off by {perr} "
              f"({pratio:.3g} of the limit) from one program's")
        check(torch.equal(r0["picks"], ref["picks"]),
              f"serve {name} greedy tokens {r0['picks'].tolist()} vs one "
              f"program's {ref['picks'].tolist()}")
        terr, tratio = _within(r0["ticks"], ref["ticks"])
        check(tratio <= 1, f"serve {name} decode logits off by {terr} "
              f"({tratio:.3g} of the limit)")
        cerr, cratio = 0.0, 0.0
        for p, leaves in ref["cache"].items():
            for k, v in leaves.items():
                e, ratio = _within(r0["cache"][p][k], v)
                cerr, cratio = max(cerr, e), max(cratio, ratio)
                check(ratio <= 1, f"serve {name} gathered cache {p}/{k} off "
                      f"by {e} ({ratio:.3g} of the limit)")
        held = [rank[name]["cache_held"] for rank in ranks]
        print(f"[mesh-serve] {name} {arch.name} ({arch.num_layers} blocks, "
              f"{strat}, data 2 x model 2, global batch {SERVE21_BATCH} x S "
              f"{seq}): {r0['rows']} rows a rank, kv heads {r0['kv_heads']}, "
              f"Mamba2 heads {r0['ssm_heads']}, vocabulary rows "
              f"{r0['vocab']} (None: whole); prefill logits within "
              f"{perr:.3g} of one program's ({pratio:.3g} of the limit, "
              f"EXECUTOR_TOL at a row's scale); {forced} teacher-forced + "
              f"{greedy} greedy ticks: tokens equal one program's, logits "
              f"within {terr:.3g} ({tratio:.3g} of the limit; smallest "
              f"top-2 gap of a greedy pick {ref['gap']:.4g}); the gathered "
              f"cache within {cerr:.3g} ({cratio:.3g} of the limit) of one "
              f"program's; the ticks launched no kernel on any rank")
        slow_p = max(rk[name]["prefill_s"] for rk in ranks)
        tick_ms = [1e3 * sum(rk[name]["tick_s"]) / len(rk[name]["tick_s"])
                   for rk in ranks]
        print(f"[mesh-serve] {name} prefill {r0['prefill_s']:.4f}s (rank 0; "
              f"slowest rank {slow_p:.4f}s; one program {ref['prefill_s']:.4f}s)"
              f", gloo's share {r0['prefill_comm_s'] / r0['prefill_s']:.3f}; "
              f"a decode tick {tick_ms[0]:.2f} ms (rank 0; slowest rank "
              f"{max(tick_ms):.2f}; one program {1e3 * ref['tick_s']:.2f} "
              f"ms), gloo's share "
              f"{r0['decode_comm_s'] / sum(r0['tick_s']):.3f}; outputs "
              f"replicated across a model group bitwise on its ranks; "
              f"programs 2 a rank")
        print(f"[mesh-serve] {name} bytes on rank 0: prefill {r0['prefill_bytes']}"
              f", by tag {_tag_bytes(r0['prefill_tagged'])}; a tick "
              f"{r0['tick_bytes']}, by tag {_tag_bytes(r0['tick_tagged'])}; "
              f"all-reduce bytes by tag = the count from the shapes on every "
              f"rank")
        print(f"[mesh-serve] {name} cache bytes a rank {held} (its rows and, "
              f"under TP, its heads) vs the spec's shard "
              f"{ref['spec_bytes']} (cache_shardings): "
              f"{'equal' if set(held) == {ref['spec_bytes']} else 'differ'}")
        print(f"[mesh-serve] {name} launches a rank {r0['launches']}")
        for k, v in r0["launches"].items():
            total[k] = total.get(k, 0) + v
        if on_card:
            print(f"[mesh-serve] {name} peak max_memory_allocated a rank "
                  f"{[round(rk[name]['peak'] / 2**30, 2) for rk in ranks]} "
                  f"GiB")
    mem = (f"nvidia-smi memory.used peak {smi} MiB (4 ranks and this "
           f"process)" if on_card else
           "peak memory: not measured (cpu rehearsal)")
    print(f"[mesh-serve] phase 21: {mem}; phase "
          f"{time.perf_counter() - t_phase:.1f}s")
    return total


def _rounded(d):
    return {k: round(v, 2) for k, v in d.items()}


# ----------------------------------------------------------------------
# Phase 16: the autotuner
# ----------------------------------------------------------------------
def shape_config(backend, name, shape, dtype=None):
    """The configuration the autotuner resolves for kernel ``name`` at
    ``shape`` in ``dtype`` (default fp32; the GEMM: its three
    products)."""
    import torch
    from repro_torch.kernels import autotune
    dt = dtype or torch.float32
    if name == "add_rmsnorm_fwd":
        return {"rows_per_block": 1}
    if name == "add_rmsnorm_bwd":
        return autotune.norm_config(backend, dt, *shape)
    if name == "gemm_bias":
        M, K, Nq = shape
        return {lay: autotune.gemm_config_of(backend, dt, m, n, k, layout)
                for lay, (m, n, k, layout) in (
                    ("fwd", (M, Nq, K, "kn")), ("dx", (M, K, Nq, "kk")),
                    ("dW", (K, Nq, M, "mn")))}
    if name in FLASH:
        fl = autotune.flash_config(backend, dt, shape[1], shape[4])
        key = "block_k" if name == "flash_bwd_dkdv" else "block_q"
        return {key: fl[key]}
    _, S, _, P, N, _ = shape
    return autotune.ssd_config(backend, dt, S, P, N)


def kernel_configs(device, shapes, dtype=None, reported=None):
    """name -> the configuration the autotuner resolves for the kernel at
    its reported shape (``reported``, default the path's) in ``dtype``
    (the GEMM: its three products)."""
    from repro_torch.kernels import autotune
    backend = autotune.backend_of(device)
    reported = reported or reported_path
    at = {name: dict(_shapes(shapes, name))[reported(name)]
          for name in KERNELS}
    return {name: shape_config(backend, base_of(name), at[name], dtype)
            for name in KERNELS}


#: run by fresh interpreters in phase 16: the configurations they resolve
_RESOLVE = ("import json, sys; sys.path.insert(0, {src!r}); "
            "from repro_torch.kernels import autotune; "
            "print(json.dumps({{k: v for d in autotune.PATH_SHAPES for k, v "
            "in autotune.resolve_paths({backend!r}, d).items()}}, "
            "sort_keys=True))")


def run_autotune(device):
    """Phase 16.  On the card: every kernel tuned at the paths' shapes
    (``autotune.PATH_SHAPES``) into a scratch cache, each candidate's
    time, the winner and the packaged entry printed.  Asserts that with
    tuning off each path key resolves to the packaged entry (to the
    heuristic for a card the table has no entry for), and that two fresh
    interpreters, spawned as the job's processes are (``child_env``),
    resolve exactly this process's configurations."""
    from repro_torch.kernels import autotune
    t_phase = time.perf_counter()
    backend = autotune.backend_of(device)
    if device.type == "cuda":
        scratch = autotune.AutotuneCache(os.devnull)
        winners = autotune.tune_paths(backend, cache=scratch)
        for key, cfg in winners.items():
            times = autotune.LAST_TIMES[key]
            print(f"[autotune] {key}: " + ", ".join(
                f"{c} {ms:.4f} ms" for c, ms in times.items())
                + f"; winner {cfg}, packaged "
                f"{autotune._packaged().get(key)}")
    else:
        print("[autotune] tuning: not measured (cpu rehearsal; it times "
              "the CUDA kernels)")
    resolved = {k: v for dtype in autotune.PATH_SHAPES
                for k, v in autotune.resolve_paths(backend, dtype).items()}
    ours = {k: v for k, v in autotune._packaged().items()
            if k.split("|")[1] == backend}
    for key, cfg in resolved.items():
        kind, _, dtype, shape = key.split("|")
        want = ours.get(key)
        if want is None:
            check(device.type == "cpu" or not ours, f"the packaged table "
                  f"has {backend} entries but none for {key}")
            want = autotune._heuristic(kind, backend, dtype,
                                       tuple(shape.split("x")))
        check(cfg == want, f"{key} resolves {cfg}, the table says {want}")
    env = autotune.child_env()
    code = _RESOLVE.format(src=SRC, backend=backend)
    outs = [subprocess.run([sys.executable, "-c", code], env=env,
                           capture_output=True, text=True, check=True,
                           timeout=300).stdout for _ in range(2)]
    mine = json.dumps(resolved, sort_keys=True)
    check(all(o.strip() == mine for o in outs),
          f"fresh interpreters resolve otherwise: {outs} vs {mine}")
    print(f"[autotune] {len(resolved)} path keys on {backend} resolve to "
          f"{'the packaged table' if ours and device.type == 'cuda' else 'the heuristic'} with "
          f"tuning off; two fresh interpreters resolve the same; phase "
          f"{time.perf_counter() - t_phase:.1f}s")


def card_line():
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"],
                       capture_output=True, text=True, check=True)
    return r.stdout.strip().splitlines()[0]


def run(device="cuda"):
    """All phases; returns the kernels record.  ``device="cpu"`` is the
    rehearsal: small shapes, the plain versions, the reduced model.  The
    autotuner reads an empty persisted table in a temporary directory and
    never tunes, whatever the machine has cached, so the training phases
    run the packaged table's configurations (or the heuristic's)."""
    import shutil
    import tempfile
    if SRC not in sys.path:
        sys.path.insert(0, SRC)
    from repro_torch.kernels import autotune
    tmp = tempfile.mkdtemp(prefix="chip_smoke_autotune_")
    path = os.path.join(tmp, "autotune.json")
    with open(path, "w") as f:
        f.write("{}")
    saved = {k: os.environ.get(k) for k in ("REPRO_AUTOTUNE",
                                            "REPRO_AUTOTUNE_CACHE")}
    os.environ.pop("REPRO_AUTOTUNE", None)
    os.environ["REPRO_AUTOTUNE_CACHE"] = path
    old = autotune.reset_cache(path)
    try:
        return _run(device)
    finally:
        autotune.reset_cache(old)
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        shutil.rmtree(tmp, ignore_errors=True)


def _run(device):
    import torch
    from repro_torch.utils.device import resolve_device, strict_fp32_numerics
    device = resolve_device(device)
    on_card = device.type == "cuda"
    if on_card:
        strict_fp32_numerics()
        card = card_line()
        print(f"[device] {card} | torch: {torch.cuda.get_device_name(0)} | "
              f"torch {torch.__version__} cuda {torch.version.cuda}")
        from repro_torch.kernels import build
        t0 = time.perf_counter()
        build.library()
        info = build.build_info()
        print(f"[build] {info.path} in "
              f"{time.perf_counter() - t0:.1f}s (nvcc {info.seconds:.1f}s; "
              f"each source's nvcc ended after "
              f"{ {k: round(v, 1) for k, v in info.compile_seconds.items()} })")
        print(build.ptxas_summary(info.log))
        shapes, iters = CARD_SHAPES, 50
    else:
        print("[device] cpu rehearsal: plain versions stand in for kernels")
        shapes, iters = CPU_SHAPES, 2
    # phase 20's pricing traces four full-size models on the host: it
    # runs beside phases 3-19 in one process
    trace20 = start_bf16_dryrun(on_card)
    try:
        record = _phases(device, on_card, shapes, iters, trace20)
    finally:
        if trace20.poll() is None:
            trace20.kill()
            trace20.wait()
    if on_card:
        print(card)
    print(json.dumps(record))
    return record


def _phases(device, on_card, shapes, iters, trace20):
    """Phases 3-21 after the card and the build; returns the kernels
    record."""
    import torch
    table = kernel_table(device)
    errors, errors_bf16 = check_kernels(device, table, shapes)
    check_offset_flash(device, table)
    timing, timing_bf16 = time_kernels(device, table, shapes, iters)
    time_offset_flash(device, table, iters)
    check_small_model(device)
    run_path(device, 6, FUSED)
    launches = run_path(device, 7, FUSED + FLASH)
    mamba = run_path(device, 8, SSD,
                     exact={**{k: MAMBA_SSD_LAUNCHES for k in SSD},
                            **dict.fromkeys(SSD_WG, 0)})
    launches.update({k: mamba[k] for k in SSD})
    run_lifecycle(device)
    run_path(device, 10, FUSED + FLASH, exact=MOE_LAUNCHES)
    run_serving(device)
    run_multiprocess(device)
    _, p13 = run_spmd(device)
    run_mesh(device, p13)
    losses15 = run_pipeline(device, p13["batch"])
    run_pipeline_beside(device, p13["batch"], losses15)
    run_autotune(device)
    # phase 19's and 19c's dry-runs trace full-size mixers on the host
    # for minutes: they run beside phases 17 and 18
    traces = {p: start_tp_dryrun(on_card, p) for p in ("19", "19c")}
    try:
        run_seq(device, p13["batch"])
        tp_launches = run_tp(device, p13["batch"])
        for p, trace in traces.items():
            for k, v in run_tp(device, p13["batch"], p, trace).items():
                tp_launches[k] = tp_launches.get(k, 0) + v
    finally:
        for trace in traces.values():
            if trace.poll() is None:
                trace.kill()
                trace.wait()
    bf16_launches = run_bf16(device, p13["batch"], trace20)
    launches21 = run_serve(device, p13["batch"])
    configs = kernel_configs(device, shapes)
    configs_bf16 = kernel_configs(device, shapes, torch.bfloat16,
                                  reported_bf16)
    def bf16(name):
        return {"launches": bf16_launches.get(name, 0),
                **({"max_abs_err": errors_bf16[name]}
                   if name in errors_bf16 else {}),
                **timing_bf16.get(name, {}), "config": configs_bf16[name]}
    # the wgmma instances run on phase 20's path alone, in bf16: their
    # launches are phase 20's, their numbers those at 20a's shape
    return {"kernels": [
        {"name": name, "route": "cuda", "source": source, "replaces": replaces,
         "launches": launches[name], "max_abs_err": errors[name],
         **timing[name], "config": configs[name],
         "tp_launches": tp_launches.get(name, 0),
         "serve_launches": launches21.get(name, 0),
         "bf16": bf16(name)}
        if name not in WGMMA else
        {"name": name, "route": "cuda", "source": source, "replaces": replaces,
         "dtype": "bfloat16", "path": "phase 20",
         **{k: v for k, v in bf16(name).items() if k != "config"},
         "config": configs_bf16[name]}
        for name, (replaces, source) in KERNELS.items()]}


def main():
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        print(f"chip_smoke: {SRC}/repro_torch not found: run from a checkout "
              f"of the repository", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible to PyTorch", file=sys.stderr)
        return 1
    run("cuda")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
