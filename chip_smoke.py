"""Drive ray_tpu_torch's serving path, training step, train library,
Tune, compiled DAGs, datasets and RL learners on one CUDA card and check
them.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) when it fails:
  1. the card's name and power limit (nvidia-smi);
  2. build every kernel from ray_tpu_torch/csrc with nvcc, in parallel,
     and count the tensor-core (HGMMA) instructions in each kernel's SASS:
     the bf16 K1, K2 and K3 must have some;
  3. each serving kernel (K1, K4) against its plain PyTorch version on
     the card, at the serving path's shapes, with its time beside the
     plain version's, a library call's where one computes the same
     function, and the least time the card could take (its bound); K4
     also at lengths on both sides of its split boundaries, at all slots
     full, in splits of one, two and three stages, at max_len 4096, and
     twice on the same inputs (bitwise equal);
  4. LLMEngine serving Llama-3-8B at full width (32 layers, random bf16
     weights from a fixed seed): concurrent greedy requests, a chunked
     long prompt and a prefix hit, with the kernels' launch counts over
     that phase; then the same requests tensor-parallel (``run_tp``): the
     model split into 2 shards, both on the one card, two prompts
     admitted through prefilled=, streams held to the same engine's at
     tp 1, K1 and K4 launched exactly twice as often, TTFT and TPOT of
     both, a tp-2 decode block traced and K4 at one shard's shape (4 kv
     heads) against its plain version; then the same requests through
     the monolithic cache
     (no K4 launch), speculative decoding (verify forwards, drafted
     tokens, paged_attention_verify against K4 per row) alternating with
     the same engine without it, with host seconds per engine stage,
     and the prefill/decode handoff (PrefillEngine payloads admitted
     through prefilled=), each with its launch counts and its streams
     held to the paged engine's (a stream passes a difference only if,
     from the first one on, each of its tokens is a near tie of a
     teacher-forced plain-attention forward's top logit). Every request
     runs under its own trace context; what the engine's observability
     reports is held to the phase's own counts (``check_obs``: K4's
     decode steps, prefix hits, the KV gauges, one queue, prefill and
     generate span per request, the decode batch spans, the device
     windows and duty cycle, the HBM row; the spec phase's drafted,
     accepted and rejected tokens; the PD phase's handoff bytes, now the
     bf16 payload's). The PD phase then runs again by handle in one
     process (prefill(device=True) parks the KV on the card; the engine
     admits the parked tensors and frees them; streams equal the host
     payload's). Then the hooks' host cost: the decode step's host
     wall with tracing and the device monitor on, off, on, off, and the
     host seconds inside the hooks per decode block (``run_hooks``); then
     a steady-state decode step (paged and monolithic), a verify forward
     and a prefill, timed and traced for the device's busy share;
  5. the same PD handoff through the port's runtime, after the driver
     frees its model: init() and two actors in their own worker
     processes, a prefill tier (K1) and a decode tier (K4), each with its
     own Llama-3-8B; the decode tier fetches each KV handle from the
     prefill tier (bytes and ms per handle), frees it, and its streams
     are held to the engine phase's; both tiers' device stores end
     empty and neither process loads jax or ray_tpu; then, on the same
     two actors, a compiled DAG (``run_dag_pd``): the prefill tier's
     stage returns prefill(device=True)'s payload, so only TensorRef
     handles ride the DAG's shm rings, the decode tier's stage admits it
     and returns the tokens; all 9 items executed before the first get,
     with the same bytes, empty stores and streams, and the stages'
     recv/compute seconds; then a two-actor DAG whose first stage
     returns an 8 MiB bf16 CUDA tensor, which the next stage receives
     staged to a CPU bf16 tensor, bitwise equal (MB/s);
     then the serve plane on a new init(): build_llm_deployment's app
     (Llama-3-8B at full width in one replica) answering run_engine's
     prompts as server-sent events through the HTTP proxy, through its
     DeploymentHandle and through stream_generate, and the prefix-hit
     repeat, with K1 and K4 counted in the replica's process and TTFT,
     TPOT and tok/s through the proxy beside the replica engine's own
     TTFT and the engine phase's; serve.delete frees the card; then
     build_pd_llm_deployment's prefill and decode replicas over the
     same prompts, with the decode replica's handoff bytes; streams
     held to the engine phase's, and no serve process loads jax,
     ml_dtypes or ray_tpu (the controller and the proxy no torch);
     then batch inference on a new init() (``run_data_llm``):
     data.llm's build_llm_processor over 48 dataset rows (the 9 prompts
     twice and 30 random ones) in 3 map batches through one engine actor
     with Llama-3-8B at full width, K1 and K4 counted in its process,
     rows in order, duplicates alike, streams held to the engine phase's,
     the card's memory back after the actor's kill; rows/s and tok/s;
  6. the training kernels (K1 with lse, K2, K3) against their plain
     versions at the training shapes (s 4096, a ragged 1000, non-causal),
     timed beside the plain versions, SDPA and their bounds (ms and
     TF/s), and K2 and K3 each twice on the same inputs (bitwise equal);
     then the same at one tensor shard's heads (16 query, 4 kv), the
     shape mesh A's shards run;
  7. a 2-layer full-width model's loss and gradients through the kernels
     against the same through plain attention;
  8. make_train_step on Llama-3-8B at full width cut to 8 layers (bf16,
     batch 2 x 4096) under each of the remat policies "full", "attn" and
     "dots", from the same weights: 2 warm-up and 5 timed steps with the
     kernels' launch counts (K1/K2/K3 per step 16/8/8 under "full",
     8/8/8 under the others), step time, tok/s, MFU and peak memory, one
     step traced for the device's busy share, and step 1's loss and grad
     norm held equal across the policies; then the same "dots" step over
     two meshes of four shards on the one card (``run_mesh``): mesh A
     (fsdp 2, tensor 2: K1 with lse, K2 and K3 exactly 32 times a step)
     and mesh B (tensor 2, context 2: ring attention, no kernel), each
     from the same weights, its first 3 losses and grad norms held to
     the single-device run's, step time, tok/s, peak memory and one
     traced step's busy time and idle share beside the single-device
     step's; then the MoE family (``run_moe``) at Mixtral-8x7B's widths:
     A, 4 layers on one device under "full" (b 1 x s 4096), step 1 with
     K1-K3 held to the same step with plain attention, 2 warm-up and 3
     timed steps with K1/K2/K3 exactly 8/4/4 a step, step time, tok/s,
     MFU, executed TF/s, peak memory, the aux loss and each layer's
     dropped share of top-k assignments, one step traced by kind (K1-K3,
     expert bmms, dispatch/combine einsums, routing, other GEMMs,
     optimizer); B, 2 layers over the expert mesh (fsdp 2, expert 2) of
     four shards on the card, 3 steps (b 2 x s 4096) held to the same
     layers on one device, K1/K2/K3 exactly 8/4/4 a step (the attention
     once per row block, shared by the expert shards); then RLlib
     (``run_rllib``): _gae, _vtrace and each update function (PPO,
     IMPALA, APPO, DQN, SAC, BC) on the card against the same update on
     the CPU from the same parameters, batch and host draws, with both
     times; then on a new init(num_cpus=4) each algorithm at its
     reference test's configuration, hidden (64, 64), the learner on
     cuda:0 behind CPU env runners and replay buffers: PPO for its
     test's 18 iterations, held to its bar, one PPO update traced
     (device busy, idle share, launches), IMPALA, APPO, DQN, SAC, BC on
     the test's logged expert and multi-agent PPO for 2-3 iterations
     each with their tests' checks; every learner tensor on cuda:0, the
     wall per iteration, runner and learner seconds and env steps/s; no
     runner or buffer process initialises CUDA or loads jax, optax,
     ml_dtypes or ray_tpu, and nvidia-smi lists no compute process
     that it did not list before the phase;
  9. the training path through the train library (``run_trainer``):
     init(), a TorchTrainer whose one worker trains Llama-3-8B's widths
     at 1 layer under "dots" for 6 steps on the card, saves through
     AsyncCheckpointer after step 3, dies once after step 4 and resumes
     from the checkpoint in a new worker; its losses held to the same
     steps in this process, its launches, checkpoint bytes, save and
     restore seconds and goodput anatomy printed, and no jax or ray_tpu
     in the worker;
     then a Tune sweep of trainer trials (``run_tune``): init() with the
     metrics endpoint, tune.Tuner over that TorchTrainer with two trials
     on the card at once (trainer_run's learning rate and one that
     diverges) under ASHA, 6 steps each: the diverging trial STOPPED at
     the step-3 rung, the winner TERMINATED with its losses held to
     run_trainer's, K1 (lse)/K2/K3 once per layer per step; while they
     run, one trial's worker profiled over the control plane (its folded
     stacks hold tune_fn), the CLI's ``stack`` run on it, and both
     workers' train_mfu and goodput series found in the head's
     /metrics; after fit(), the device and goodput views, the
     dashboard's pages and the CLI's status, list and goodput; then the
     winner's checkpoint served: serve.llm._load_model restores it on
     the card, weights bitwise the saved ones, and an LLMEngine
     generates 16 greedy tokens with exact K1 and K4 counts;
     then data-parallel training through the gradient ring
     (``run_dp``): init(), a TorchTrainer of two workers sharing the
     card, each training the same model at 1 layer from the same seed on
     its half of the batch (1 x 4096 tokens), 2, 2 and 1 steps in three
     modes: allreduce_gradients and the replicated AdamW (A),
     ShardedOptimizer (ZeRO-1) over ShardAdamW at the f32 wire (B), and
     with the int8 gradient reduce-scatter and the bf16 parameter
     allgather (C); A's and B's losses and grad norms held to one
     process's steps on the whole batch, the ranks' parameters bitwise
     equal, K1/K2/K3 launched 1/1/1 a step on each rank, C's int8
     reduce-scatter within the ring's bound, B's optimizer shard half
     the replicated moments, no nvcc, jax or ray_tpu in either worker;
     step walls, the ring's seconds, wire bytes, peak HBM and host RSS
     per worker;
     then the in-place elastic reshape (``run_elastic``): init(), an
     elastic TorchTrainer (num_workers=(1, 2)) of two workers on the
     card training the same model with ZeRO-1 and a peer mirror of each
     rank's shard every step; rank 1 SIGKILLs itself at step 2 after its
     backward, rank 0 catches PeerLostError, await_regroup()s,
     reshard()s its moments with the mirror to world 1, retries step 2
     on the whole batch and runs step 3: every step reported once at
     worlds [2, 1, 1], generation 1, one reshard and no lost step, the
     reshard's staleness 0, losses and grad norms held to run_dp's
     one-process trajectory, the moments after the reshard bitwise the
     old shard and the victim's, K1/K2/K3 4 times each in the survivor,
     no nvcc, jax or ray_tpu in either worker; the controller's
     worker_death audit writes one postmortem bundle from the survivor,
     holding its ledger with the ring round the kill caught and an HBM
     row equal to its torch.cuda.memory_allocated at the dump; recovery
     seconds, the reshard round, each mirror's bytes and seconds, step
     walls, peak HBM and host RSS per worker;
     then pipeline parallelism (``run_pipeline``): one process's 3 steps
     of Llama-3-8B's widths at 2 layers first, then init() and two
     PipelineStageActor stages in their own worker processes on the card
     (the embedding and layer 0; layer 1, the head and the loss),
     train.Pipeline driving 1f1b over 4 microbatches of 1 x 4096 tokens
     with SGD: run A, 3 steps over the device transport (TensorRef
     handles) with save_checkpoint after step 2, its losses held to the
     one process's (step 1 within 1e-4); run B, two new stages from
     other weights restored from that checkpoint, step 3 over the host
     transport, bitwise run A's step 3 in loss and both stages'
     parameters; K1 without lse (F ops), K1 with lse, K2 and K3 (B ops)
     4 times a step in each stage, every step reported, stage_stats at
     teardown, both device stores empty after it, no nvcc, jax,
     ml_dtypes or ray_tpu in either stage; step walls of both
     transports, each stage's bubble beside bubble_fraction(2, 4), the
     activations' hop through host memory (GB/s), the save and restore
     seconds and bytes, peak HBM and host RSS per stage;
  10. ``iter_device_batches`` at the training shape (``run_device_batches``):
     32 rows of 4096 tokens and targets in batches of 2 copied to the card
     with prefetch 1, each bitwise its host rows, the 8-layer model's loss
     on the first batch equal to its loss on the same tokens passed
     directly; each batch summed on the consumer's stream as it is
     yielded while every copy is held back, equal to the host's sums
     (the consumer waits on the copy); host-to-device MB/s;
  11. one JSON line with every kernel's numbers;
  12. the last line, {"ok": true, "device": {...}}.
Without a CUDA device it exits non-zero and prints no result.
"""

from __future__ import annotations

import asyncio
import dataclasses
import gc
import json
import os
import subprocess
import sys
import threading
import time
from collections import Counter

import numpy as np
import torch

PEAK_BYTES_S = 3.35e12      # H100 SXM HBM3
PEAK_BF16_FLOPS = 989e12    # H100 SXM dense bf16 tensor cores
SLEEP_CYCLES = 4_000_000    # ~2 ms of the card's clock (time_ms)
# K1, bf16: per (query row, head), |kernel - plain|_2 / |plain|_2 over
# head_dim. The two differ by the bf16 rounding of q*scale (the kernel
# folds the scale into q as the TPU kernel does) and of the output, each
# once: a few 1e-3 at any row's scale. A KV tile dropped or doubled moves
# a row by several percent.
K1_ROW_REL_TOL = 1e-2
K4_TOL = dict(atol=1e-4, rtol=0.0)    # f32 math on identical bf16 values
LOGITS_REL_TOL = 5e-2                 # 32 bf16 layers, kernel vs plain
# A served stream against plain attention, from its first difference with
# its reference stream on: at every position, the stream's token sits at
# most this far below plain attention's top logit, as a share of
# max|logit|. The logits come out of a bf16 lm_head, whose ulp at the top
# is 0.6-0.75% of max|logit| here, and the kernel paths' logits differ
# from plain attention's by up to 2e-2 of max|logit| (K1 vs plain
# prefill, run_engine): near ties measured 0 to 1.81e-2 (one to three
# ulps), so the limit is four ulps at most; a wrong token sits tens of
# percents below the top.
NEAR_TIE_REL_TOL = 3e-2
# K1's lse against the plain forward's: both fold q' the same way and sum
# exp in f32, so they differ by summation order (~1e-6 at lse ~ 10); a
# dropped or doubled 64-key tile moves a row's lse by >= ~1e-2.
LSE_ABS_TOL = 1e-3
# K2/K3, bf16: |kernel - plain|_2 / |plain|_2 per (query row, head) for
# dQ and per (key row, kv head) for dK/dV. The kernels round P (K2) and dS
# (K2, K3) to bf16 before their second product, as the TPU kernels do, and
# each output once; the plain versions keep p and dS in f32: ~4-6e-3 per
# row (tests/test_torch_flash_bf16.py). A dropped tile or head moves a row
# by percents.
BWD_ROW_REL_TOL = 1e-2
# K3, a query row that keeps one key (the first row of each head, causal):
# its dQ is zero in exact arithmetic (dS = p (dp - delta), p = 1 and
# delta = dp), and both sides hold the f32 rounding of dp - delta, a few
# ulps of the terms' size |dO_i| |v_j|, times sm_scale |k_j|. Such a row
# is held to ONE_KEY_ULPS of 2^-24 sm_scale |dO_i| |v_j| |k_j| instead of
# BWD_ROW_REL_TOL; a key wrongly kept moves it to dQ's scale, ~1e5 more.
ONE_KEY_ULPS = 64
# 2 bf16 layers at full width, loss and gradients through K1/K2/K3 vs the
# same through plain attention: bf16 rounds every matmul output (2^-8)
# and the two attention paths round at other points (q' before the
# scores vs the scores in f32), which moves the loss by ~1e-4 relative,
# the gradients' norm by ~1e-3 and each gradient's direction by ~1e-3.
TRAIN_LOSS_REL_TOL = 2e-3
TRAIN_GNORM_REL_TOL = 2e-2
TRAIN_GRAD_COS_MIN = 0.99


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``iters`` launches, each timed with
    CUDA events after a 128 MB write that evicts the 50 MB L2 cache (the
    serving path meets its operands cold: a layer's weights pass through
    L2 between two attention calls). A 2 ms device-side wait queued
    before each flush keeps the card behind the host, so that the host
    time of ``fn``'s Python wrapper (tens of us, more than a small
    kernel's run) is not counted as idle card time between the events."""
    flush = torch.empty(32 * 2 ** 20, dtype=torch.float32, device="cuda")
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        torch.cuda._sleep(SLEEP_CYCLES)
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        times.append((start, end))
        torch.cuda.synchronize()
    return float(np.mean([s.elapsed_time(e) for s, e in times]))


def row_rel(got: torch.Tensor, want: torch.Tensor) -> float:
    """Worst |got - want|_2 / |want|_2 over the last dim (a row of one
    head). A row whose reference norm is below 1e-3 of the mean row norm
    is measured against 1e-3 of the mean instead."""
    diff = torch.linalg.vector_norm(got.float() - want.float(), dim=-1)
    ref = torch.linalg.vector_norm(want.float(), dim=-1)
    return (diff / ref.clamp_min(1e-3 * ref.mean().item() + 1e-30)
            ).max().item()


def rel_l2(got: torch.Tensor, want: torch.Tensor) -> float:
    """|got - want|_2 / |want|_2 over the whole tensor."""
    return (torch.linalg.vector_norm(got.float() - want.float())
            / torch.linalg.vector_norm(want.float())).item()


def one_key_ulps(dq, dq_r, q, k, v, do, rows, keys) -> float:
    """Worst |dq - dq_r|_2 over the query rows ``rows`` (b, s, h, d
    layout), row rows[i] keeping the one key keys[i], in units of
    2^-24 sm_scale |dO_i| |v_j| |k_j| (see ONE_KEY_ULPS); head h reads
    kv head h // g."""
    g = q.shape[2] // k.shape[2]

    def norm(x, at):
        return torch.linalg.vector_norm(x[:, at].float(), dim=-1)

    diff = torch.linalg.vector_norm(
        dq[:, rows].float() - dq_r[:, rows].float(), dim=-1)
    unit = (2.0 ** -24 * q.shape[-1] ** -0.5 * norm(do, rows)
            * (norm(v, keys) * norm(k, keys)).repeat_interleave(g, dim=-1))
    return (diff / unit).max().item()


def bound_ms(work: dict):
    t_bytes = work["bytes"] / PEAK_BYTES_S * 1e3
    t_ops = work["flops"] / PEAK_BF16_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else
                                 "operations")


# kernel -> (a substring of the mangled names of the kernel functions
# that its bf16 path runs, whether they must run on the tensor cores)
KERNEL_FUNCTIONS = {
    "flash_attention_fwd": ("flash_fwd_kernel_wgmma", True),
    "flash_attention_bwd_dkv": ("flash_dkv_kernel_wgmma", True),
    "flash_attention_bwd_dq": ("flash_dq_kernel_wgmma", True),
    # K4, every pool dtype and shape: f32 FMA by design
    "paged_attention": ("paged_decode_kernel", False),
}


def check_sass(_build) -> dict:
    """HGMMA (wgmma) instructions in the SASS of each kernel's functions
    (``KERNEL_FUNCTIONS``), from cuobjdump of the built libraries. Fails
    when a bf16 K1, K2 or K3 function (d 64 and d 128) has none: it would
    not run on the tensor cores."""
    out = {}
    for name, (key, wgmma) in KERNEL_FUNCTIONS.items():
        per = {f: n for f, n in _build.sass_counts(name).items() if key in f}
        counts = sorted(per.values())
        print(f"SASS {name}: HGMMA in its {len(per)} functions matching "
              f"{key!r}: {counts}")
        if not per or (wgmma and min(counts) <= 0):
            raise SystemExit(f"{name}: a bf16 function lacks HGMMA: {per}")
        out[name] = {"bf16": "wgmma" if wgmma else "FMA loops",
                     "hgmma_in_sass": counts}
    return out


def tflops(work: dict, ms: float) -> float:
    return work["flops"] / ms / 1e9


def check_flash(fa, gen, h: int = 32, kvh: int = 8,
                label: str = "") -> dict:
    """K1 on the slice's shapes: prefill buckets (64, a ragged 100, 512)
    and chunked prefill (512 queries against the 1536-long accumulator
    at q_offset 512); Llama-3-8B heads by default: 32 query, 8 kv,
    head_dim 128. ``h``/``kvh`` set one tensor shard's heads (run_tp),
    ``label`` tags the printed lines."""
    d = 128
    cases = [(64, 64, None), (100, 100, None), (512, 512, None),
             (512, 1536, 512)]
    worst = worst_rel = 0.0
    timed = {}
    for sq, sk, off in cases:
        q = torch.randn((1, sq, h, d), generator=gen, device="cuda",
                        dtype=torch.bfloat16)
        k = torch.randn((1, sk, kvh, d), generator=gen, device="cuda",
                        dtype=torch.bfloat16)
        v = torch.randn((1, sk, kvh, d), generator=gen, device="cuda",
                        dtype=torch.bfloat16)

        def kernel():
            return fa.flash_attention_fwd(q, k, v, causal=True, q_offset=off)

        def plain():
            return fa.mha_reference(q, k, v, causal=True, q_offset=off)

        got, want = kernel(), plain()
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        row_rel = (torch.linalg.vector_norm(got.float() - want.float(),
                                            dim=-1)
                   / torch.linalg.vector_norm(want.float(), dim=-1)
                   .clamp_min(1e-30)).max().item()
        ok = row_rel <= K1_ROW_REL_TOL
        print(f"K1 flash{label} sq={sq} sk={sk} q_offset={off}: worst row "
              f"relative error {row_rel:.3e} (tol {K1_ROW_REL_TOL}), "
              f"max_abs_err {err:.3e}, output rms "
              f"{want.float().pow(2).mean().sqrt().item():.3e} "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"K1{label} disagrees with its plain version")
        worst_rel = max(worst_rel, row_rel)
        worst = max(worst, err)
        if (sq, sk) == (512, 512):
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))

            def library():
                return torch.nn.functional.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=True, enable_gqa=True)

            lib_err = (library().transpose(1, 2).float()
                       - want.float()).abs().max().item()
            if lib_err > 0.1:
                raise SystemExit(f"SDPA yardstick disagrees: {lib_err}")
            w = fa.work(1, sq, sk, h, kvh, d, 2)
            b, by = bound_ms(w)
            timed = dict(ms=time_ms(kernel), plain_ms=time_ms(plain),
                         library_ms=time_ms(library), bound_ms=b,
                         bound_by=by)
            print(f"K1 flash{label} s=512: kernel {timed['ms']:.4f} ms "
                  f"({tflops(w, timed['ms']):.1f} TF/s), plain "
                  f"{timed['plain_ms']:.4f} ms, SDPA {timed['library_ms']:.4f}"
                  f" ms ({tflops(w, timed['library_ms']):.1f} TF/s), bound "
                  f"{b:.4f} ms ({by})")
        if off is not None:
            b, by = bound_ms(fa.work(1, sq, sk, h, kvh, d, 2, q_offset=off))
            print(f"K1 flash{label} chunk sq={sq} sk={sk} q_offset={off}: "
                  f"kernel {time_ms(kernel):.4f} ms, plain "
                  f"{time_ms(plain):.4f} ms, bound {b:.4f} ms ({by})")
    return dict(max_abs_err=worst, max_row_rel_err=worst_rel, **timed)


def check_paged(pa, gen) -> dict:
    """K4 on the slice's shapes: 8 slots, 8 kv heads, group 4, head_dim
    128, block 16, table width 64 (max_len 1024), bf16 pool, uneven
    lengths from 1 to 1024 (3044 live tokens, timed) over disjoint tables
    whose blocks are a seeded permutation of the pool (so a kernel must
    read the table); lengths on both sides of each split boundary; all
    slots at 1024 (timed); the engine lengths again in splits of two and
    three 64-position stages (span 8 and 12 entries, timed beside the
    default span). Then table width 256 (max_len 4096: splits of three
    stages) at lengths on both sides of its stage and split edges, and
    all slots at 4096 (timed, also at spans of one and two stages). Each
    launched twice: bitwise equal."""
    slots, kvh, g, hd, bs = 8, 8, 4, 128, 16
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    err = 0.0

    def pool(w):
        nb = 1 + slots * w
        q = torch.randn((slots, kvh, g, hd), generator=gen, device="cuda",
                        dtype=torch.bfloat16)
        kp, vp = (torch.randn((nb, bs, kvh, hd), generator=gen,
                              device="cuda", dtype=torch.bfloat16)
                  for _ in range(2))
        tables = (1 + torch.randperm(slots * w, generator=gen,
                                     device="cuda")
                  ).to(torch.int32).reshape(slots, w)
        return q, kp, vp, tables

    def check(name, args, ls, span=None, timed=False):
        nonlocal err
        lengths = torch.tensor(ls, dtype=torch.int32, device="cuda")
        w = args[-1].shape[1]
        positions = (span or pa.split_span(slots, kvh, w, bs, sms)) * bs

        def kernel():
            return pa.paged_attention(*args, lengths, span=span)

        def plain():
            return pa.paged_attention_reference(*args, lengths)

        got, again, want = kernel(), kernel(), plain()
        torch.cuda.synchronize()
        e = (got - want).abs().max().item()
        ok = torch.allclose(got, want, **K4_TOL)
        same = torch.equal(got, again)
        print(f"K4 paged {name} lengths={ls} (width {w}, splits of "
              f"{positions} positions): max_abs_err {e:.3e} (tol atol "
              f"{K4_TOL['atol']}), twice "
              f"{'bitwise equal' if same else 'DIFFERENT'} "
              f"{'ok' if ok and same else 'FAIL'}")
        if not ok:
            raise SystemExit(f"K4 disagrees with its plain version ({name})")
        if not same:
            raise SystemExit(f"K4 launched twice gave different results "
                             f"({name})")
        err = max(err, e)
        if not timed:
            return None
        b, by = bound_ms(pa.work(ls, kvh, g, hd, 2, 2))
        t = dict(ms=time_ms(kernel), plain_ms=time_ms(plain), bound_ms=b,
                 bound_by=by, live_tokens=sum(ls),
                 split_positions=positions)
        print(f"K4 paged {name} ({sum(ls)} live tokens, splits of "
              f"{positions} positions): kernel {t['ms']:.4f} ms, plain "
              f"{t['plain_ms']:.4f} ms, bound {b:.4f} ms ({by}); no single "
              f"PyTorch call computes paged decode")
        return t

    engine = pool(64)
    span = pa.split_span(slots, kvh, 64, bs, sms) * bs
    lens = [1, 1024, 17, 300, 511, 64, 999, 128]
    out = dict(library_ms=None, **check("engine", engine, lens, timed=True))
    check("split edges", engine,
          [span - 1, span, span + 1, 2 * span, 2 * span + 1, 1024 - span,
           1024 - span + 1, 1023])
    out["all_1024"] = check("all 1024", engine, [1024] * slots, timed=True)
    out["span_ms"] = {str(span // bs): out["ms"]}
    for entries in (8, 12):
        t = check(f"engine, span {entries}", engine, lens, span=entries,
                  timed=True)
        out["span_ms"][str(entries)] = t["ms"]
    long = pool(256)
    span = pa.split_span(slots, kvh, 256, bs, sms) * bs
    check("max_len 4096 stage and split edges", long,
          [1, 63, 65, 129, span - 1, span + 1, 4096 - 63, 4096])
    out["all_4096"] = check("all 4096", long, [4096] * slots, timed=True)
    out["all_4096"]["span_ms"] = {str(span // bs): out["all_4096"]["ms"]}
    for entries in (4, 8):
        t = check(f"all 4096, span {entries}", long, [4096] * slots,
                  span=entries, timed=True)
        out["all_4096"]["span_ms"][str(entries)] = t["ms"]
    del engine, long
    return dict(max_abs_err=err, bitwise_twice=True, **out)


def reset_serving_counts() -> None:
    """Zero the serving kernels' launch counters and the verify forward
    count, just before a serving path is driven."""
    from ray_tpu_torch.llm import kvcache
    from ray_tpu_torch.ops import flash_attention as fa
    from ray_tpu_torch.ops import paged_attention as pa
    fa.flash_attention_fwd.launches = 0
    fa.flash_attention_fwd.lse_launches = 0
    pa.paged_attention.launches = 0
    kvcache.paged_verify_steps.launches = 0


def serving_counts() -> dict:
    """The counters ``reset_serving_counts`` zeroes, read just after a
    serving path ran; fails if the path wrote lse (serving never does)."""
    from ray_tpu_torch.llm import kvcache
    from ray_tpu_torch.ops import flash_attention as fa
    from ray_tpu_torch.ops import paged_attention as pa
    if fa.flash_attention_fwd.lse_launches:
        raise SystemExit("the serving path wrote lse "
                         f"{fa.flash_attention_fwd.lse_launches} times")
    return {"flash_attention_fwd": fa.flash_attention_fwd.launches,
            "paged_attention": pa.paged_attention.launches,
            "verify_forwards": kvcache.paged_verify_steps.launches}


def reset_obs() -> None:
    """Empty the port's metrics registry, event buffers and device-monitor
    state just before a serving path is driven (each engine registers its
    series when it is built), so what they hold after it is that path's."""
    from ray_tpu_torch.util import devmon, events, metrics
    metrics.reset()
    events.clear()
    devmon._reset_for_tests()


def metric(name: str, **tags) -> float:
    """A counter's or gauge's value in the port's registry (0 if unset)."""
    from ray_tpu_torch.util import metrics
    m = metrics._REGISTRY.get(name)
    return 0.0 if m is None else m._values.get(
        tuple(sorted(tags.items())), 0.0)


def hist(name: str):
    """(count, sum) of an untagged histogram in the port's registry."""
    from ray_tpu_torch.util import metrics
    m = metrics._REGISTRY.get(name)
    if m is None:
        return 0, 0.0
    return sum(m._counts.get((), [])), m._sums.get((), 0.0)


def live_hbm(model, into: dict):
    """A ``serve`` ``live`` hook: ``hbm_snapshot()`` taken while the
    engine still holds its KV pool, with the bytes the weights and the
    whole pool (every block, the trash block too) must hold on the card,
    stored in ``into``."""
    from ray_tpu_torch.llm import kvcache
    from ray_tpu_torch.util import devmon

    def hook(eng):
        into.update(
            rows=devmon.hbm_snapshot(),
            weights=sum(t.nbytes for t in model.parameters()),
            pool=kvcache.pool_block_bytes(eng._pool)
            * eng._pool["k"].shape[1])
    return hook


def check_obs(label: str, runs, prompts, stats, launches, cfg,
              card: str, hbm: dict) -> dict:
    """What the engine reported of a paged serving path just driven
    (``reset_obs`` before it), held to the path's own counts: K4's decode
    steps (its launches over the layers) equal
    ``llm_paged_attn_steps_total{impl="paged_flash"}``; the prefix-hit
    counter equals ``stats``; the KV gauges equal the pool's block bytes
    times (used + cached) and times free blocks; every request's trace
    has one queue, one prefill and one generate span, the generate
    span's kv_bytes the block's per-token bytes times prompt + output;
    every decode batch span names paged_flash; prefill and decode device
    windows exist and the duty cycle is in (0, 1]; ``hbm_snapshot`` taken
    while the engine was live (``live_hbm``) has one row, cuda:0, with
    weights + KV pool <= used <= peak <= limit = mem_get_info's total;
    llm_ttft_wall_s and llm_queue_s count every request. Prints one
    ``metrics`` line."""
    from ray_tpu_torch.util import devmon, events
    n = len(runs)
    bb = (cfg.n_layers * stats["block_size"] * cfg.n_kv_heads * cfg.head_dim
          * 2 * 2)                           # k and v, bf16
    steps = metric("llm_paged_attn_steps_total", impl="paged_flash")
    evs = events.dump()
    spans = {}
    for e in evs:
        if e.get("cat") == "request" and e.get("name") == "span":
            spans.setdefault(e["trace"], []).append(e)
    batches = [e for e in evs if e.get("cat") == "request"
               and e.get("name") == "batch"]
    windows = sorted({e["seg"] for e in evs
                      if e.get("cat") == "device_window"})
    duty = devmon.duty_cycle()
    rows = hbm["rows"]
    total = torch.cuda.mem_get_info()[1]
    ttft_n, ttft_sum = hist("llm_ttft_wall_s")
    queue_n, queue_sum = hist("llm_queue_s")
    bad = []
    if steps * cfg.n_layers != launches["paged_attention"] or steps <= 0:
        bad.append(f"paged_attn_steps {steps} x {cfg.n_layers} layers != "
                   f"K4 launches {launches['paged_attention']}")
    if metric("llm_prefix_hit_tokens_total") != stats["prefix_hit_tokens"]:
        bad.append("prefix hit tokens")
    kv = metric("llm_kv_cache_bytes")
    head = metric("llm_kv_cache_headroom_bytes")
    if kv != bb * (stats["blocks_used"] + stats["blocks_cached"]) \
            or head != bb * stats["blocks_free"]:
        bad.append(f"KV gauges {kv}, {head} vs block bytes {bb} and {stats}")
    for (out, _, _), p in zip(runs, prompts):
        segs = sorted(e["seg"] for e in spans.get(out["trace_id"], []))
        gen = [e for e in spans.get(out["trace_id"], [])
               if e["seg"] == "generate"]
        want = int(bb / stats["block_size"] * (len(p) + len(out["tokens"])))
        if segs != ["generate", "prefill", "queue"] or \
                gen[0]["kv_bytes"] != want:
            bad.append(f"trace {out['trace_id']}: spans {segs}, kv_bytes "
                       f"{[e.get('kv_bytes') for e in gen]} vs {want}")
    if not batches or {b["kv_impl"] for b in batches} != {"paged_flash"}:
        bad.append(f"batch spans {len(batches)}, impls "
                   f"{sorted({b['kv_impl'] for b in batches})}")
    if windows != ["decode", "prefill"] or not 0.0 < duty <= 1.0:
        bad.append(f"device windows {windows}, duty cycle {duty}")
    held = hbm["weights"] + hbm["pool"]
    if len(rows) != 1 or rows[0]["device"] != "cuda:0" or not (
            held <= rows[0]["used"] <= rows[0]["peak"] <= rows[0]["limit"]
            == total):
        bad.append(f"live hbm rows {rows}: weights {hbm['weights']} + KV "
                   f"pool {hbm['pool']} bytes (mem_get_info total {total})")
    if ttft_n != n or queue_n != n:
        bad.append(f"ttft/queue counts {ttft_n}/{queue_n} for {n} requests")
    out = dict(paged_attn_steps=steps, decode_batch_spans=len(batches),
               prefix_hit_tokens=metric("llm_prefix_hit_tokens_total"),
               kv_cache_bytes=kv, kv_headroom_bytes=head,
               gather_bytes_avoided=metric(
                   "llm_kv_gather_bytes_avoided_total"),
               ttft_wall_mean_s=ttft_sum / max(1, ttft_n),
               queue_mean_s=queue_sum / max(1, queue_n),
               tpot_mean_s=hist("llm_tpot_s")[1] / max(
                   1, hist("llm_tpot_s")[0]),
               duty_cycle=duty, hbm=rows[0] if rows else None,
               weights_bytes=hbm["weights"], kv_pool_bytes=hbm["pool"],
               traces=len(spans))
    print(f"metrics {label} [{card}]: {json.dumps(out)}")
    if bad:
        raise SystemExit(f"{label}: the engine's metrics, spans or device "
                         "monitor disagree: " + "; ".join(bad))
    return out


def latency(runs, wall: float) -> dict:
    """TTFT and TPOT p50 (ms) and generated tok/s of concurrent requests,
    each run (result, submitted at, done at) on the host clock."""
    ttft = [o["ttft_s"] for o, _, _ in runs]
    tpot = [(done - (t_sub + o["ttft_s"])) / (len(o["tokens"]) - 1)
            for o, t_sub, done in runs]
    toks = sum(len(o["tokens"]) for o, _, _ in runs)
    return dict(ttft_p50_ms=float(np.median(ttft)) * 1e3,
                tpot_p50_ms=float(np.median(tpot)) * 1e3,
                tok_s=toks / wall, wall_s=wall)


def latency_line(runs, wall: float) -> str:
    lat = latency(runs, wall)
    return (f"TTFT p50 {lat['ttft_p50_ms']:.1f} ms, TPOT p50 "
            f"{lat['tpot_p50_ms']:.2f} ms, {lat['tok_s']:.1f} generated "
            f"tok/s over {wall:.2f} s")


# LLMEngine's arguments in every serving phase
SERVE_KW = dict(max_slots=8, max_len=1024,
                prefill_buckets=(64, 128, 256, 512))


def serve(model, cfg, prompts, new, then=(), payloads=None, live=None,
          **kw):
    """Drive one LLMEngine (SERVE_KW and ``kw``): every prompt submitted
    at once (through ``prefilled=`` payloads where given), then each
    prompt of ``then`` alone, greedy, ``new`` tokens each; ``live(eng)``,
    where given, is called after the last request, before ``stop()``
    frees the engine's cache. Each request
    runs under its own trace context, minted and bound inside its
    coroutine as a serve replica binds it (none while request tracing is
    off); its result carries the context's ``trace_id``. Returns (runs,
    wall seconds of the concurrent part, runs of ``then``, stats); a run
    is (result, submitted at, done at) on the host clock."""
    from ray_tpu_torch.llm.engine import LLMEngine
    from ray_tpu_torch.util import tracing

    async def one(eng, p, payload=None):
        ctx = tracing.mint_context()
        tracing.set_request_context(ctx)
        t_sub = time.monotonic()
        extra = {} if payload is None else {"prefilled": payload}
        out = await eng.generate(p, max_new_tokens=new, **extra)
        out["trace_id"] = ctx.trace_id if ctx is not None else None
        return out, t_sub, time.monotonic()

    async def go():
        eng = LLMEngine(cfg, model, **SERVE_KW, **kw)
        t0 = time.monotonic()
        runs = await asyncio.gather(*[
            one(eng, p, None if payloads is None else payloads[i])
            for i, p in enumerate(prompts)])
        wall = time.monotonic() - t0
        later = [await one(eng, p) for p in then]
        if live is not None:
            live(eng)
        stats = eng.stats
        await eng.stop()
        return runs, wall, later, stats

    return asyncio.run(go())


def check_streams(model, cfg, label, prompts, got, want, exact=()):
    """Hold each stream in ``got`` to the one in ``want``: equal, or a
    near tie from its first differing position t on. One plain-attention
    forward over prompt + the ``got`` stream (teacher-forced) gives the
    logits at every position: at t the two candidates' logits differ by
    at most NEAR_TIE_REL_TOL x max|logit|, and at t and every later
    position the stream's token sits at most that far below the top
    logit. Indices in ``exact`` must be equal. Prints every position from
    t on where the stream leaves plain attention's argmax, with its
    margin; returns one record per differing stream."""
    from ray_tpu_torch.models import llama
    ref_cfg = dataclasses.replace(cfg, attn_impl="reference")
    flips = []
    for i, (p, a, b) in enumerate(zip(prompts, got, want)):
        if a == b:
            continue
        t = next((j for j, (x, y) in enumerate(zip(a, b)) if x != y), None)
        if i in exact or t is None:
            raise SystemExit(f"{label}: stream {i} differs from its "
                             f"reference: {a} vs {b}")
        seq = torch.tensor([p + a[:-1]], device="cuda")
        with torch.no_grad():
            # row j: the distribution of stream token j
            logits = llama.forward(model, seq, ref_cfg)[0, len(p) - 1:]
            logits = logits.float()
            top, scale = logits.amax(-1), logits.abs().amax(-1)
            picked = logits.gather(
                1, torch.tensor(a, device="cuda")[:, None])[:, 0]
            below = ((top - picked) / scale).tolist()
            tie = ((logits[t, a[t]] - logits[t, b[t]]).abs()
                   / scale[t]).item()
        off = [(j, below[j]) for j in range(t, len(a)) if below[j] > 0]
        worst = max([tie] + [m for _, m in off])
        ok = worst <= NEAR_TIE_REL_TOL
        print(f"{label}: stream {i} (prompt {len(p)} tokens) flips at "
              f"position {t}: {a[t]} vs {b[t]}, plain-attention logits "
              f"differ by {tie:.3e} of max|logit|; from there on the "
              f"stream leaves plain attention's argmax at "
              f"{[(j, round(m, 6)) for j, m in off]} (positions, margin); "
              f"worst {worst:.3e} (tol {NEAR_TIE_REL_TOL}) "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"{label}: stream {i} differs beyond a near "
                             "tie")
        flips.append(dict(stream=i, position=t, margin=tie,
                          off_argmax=off, worst=worst))
    return flips


def run_engine(card: str):
    """Llama-3-8B at full width through LLMEngine: 8 concurrent greedy
    requests (16-500 tokens) plus a 700-token prompt (chunked prefill,
    second piece at q_offset 512), then a request repeating a 256-token
    prefix of the first prompt (prefix hit)."""
    from ray_tpu_torch.llm import model as lm
    from ray_tpu_torch.models import llama

    cfg = llama.llama3_8b(dtype="bfloat16")
    t0 = time.monotonic()
    model = llama.init_params(
        torch.Generator(device="cuda").manual_seed(0), cfg)
    torch.cuda.synchronize()
    print(f"llama3_8b: {cfg.num_params() / 1e9:.2f}B params, bf16, random "
          f"weights (seed 0) in {time.monotonic() - t0:.1f} s")
    rng = np.random.default_rng(0)
    lens = [480] + [int(x) for x in rng.integers(16, 501, 7)] + [700]
    prompts = [[int(t) for t in rng.integers(0, cfg.vocab_size, n)]
               for n in lens]
    repeat = prompts[0][:256] + [int(t) for t in
                                 rng.integers(0, cfg.vocab_size, 40)]
    new = 32
    hbm = {}
    reset_serving_counts()
    reset_obs()
    first, wall, (hit,), stats = serve(model, cfg, prompts, new,
                                       then=[repeat],
                                       live=live_hbm(model, hbm))
    launches = serving_counts()
    obs = check_obs("engine", first + [hit], prompts + [repeat], stats,
                    launches, cfg, card, hbm)
    for out, _, _ in first + [hit]:
        toks = out["tokens"]
        if len(toks) != new or not all(0 <= t < cfg.vocab_size
                                       for t in toks):
            raise SystemExit(f"bad generation: {toks}")
    if hit[0]["prefix_hit_tokens"] <= 0:
        raise SystemExit("the repeated prefix took no prefix hit")
    if min(launches["flash_attention_fwd"],
           launches["paged_attention"]) <= 0:
        raise SystemExit(f"a kernel was not launched: {launches}")
    print(f"engine [{card}]: {len(first)} concurrent requests + 1 prefix "
          f"hit ({hit[0]['prefix_hit_tokens']} tokens), {new} new tokens "
          f"each; {latency_line(first, wall)}; launches {launches}; stats "
          f"{stats}")

    # one prefill through K1 vs the same prefill with plain attention
    n = 300
    padded = torch.tensor(lm.pad_prompt(prompts[0][:n], 512),
                          device="cuda")
    lk, _ = lm.prefill(model, padded, n, cfg, 512)
    lr, _ = lm.prefill(model, padded, n,
                       dataclasses.replace(cfg, attn_impl="reference"), 512)
    rel = ((lk - lr).abs().max() / lr.abs().max()).item()
    cos = torch.nn.functional.cosine_similarity(lk, lr, dim=0).item()
    same = int(lk.argmax()) == int(lr.argmax())
    print(f"prefill logits, K1 vs plain attention: max|diff|/max|ref| "
          f"{rel:.3e} (tol {LOGITS_REL_TOL}), cosine {cos:.6f}, argmax "
          f"{'equal' if same else 'differs'}")
    if not (np.isfinite(rel) and rel <= LOGITS_REL_TOL):
        raise SystemExit("prefill logits through K1 disagree")
    ref = dict(prompts=prompts, repeat=repeat, new=new,
               streams=[o["tokens"] for o, _, _ in first],
               hit_stream=hit[0]["tokens"],
               hit_tokens=hit[0]["prefix_hit_tokens"], obs=obs,
               latency=latency(first, wall))
    return launches, model, cfg, ref


TP = 2      # run_tp's tensor-parallel size, both shards on card 0


def check_paged_shard(pa, gen) -> dict:
    """K4 at one tensor shard's shape under tp 2: 8 slots, 4 kv heads
    (Llama-3-8B's 8 over 2 shards), group 4, head_dim 128, block 16,
    table width 64, bf16 pool, the engine lengths of ``check_paged``
    (3044 live tokens) over a seeded permutation of the pool: kernel
    against its plain version, timed beside it, with its byte bound."""
    slots, kvh, g, hd, bs, w = 8, 8 // TP, 4, 128, 16, 64
    nb = 1 + slots * w
    q = torch.randn((slots, kvh, g, hd), generator=gen, device="cuda",
                    dtype=torch.bfloat16)
    kp, vp = (torch.randn((nb, bs, kvh, hd), generator=gen, device="cuda",
                          dtype=torch.bfloat16) for _ in range(2))
    tables = (1 + torch.randperm(slots * w, generator=gen, device="cuda")
              ).to(torch.int32).reshape(slots, w)
    ls = [1, 1024, 17, 300, 511, 64, 999, 128]
    lengths = torch.tensor(ls, dtype=torch.int32, device="cuda")

    def kernel():
        return pa.paged_attention(q, kp, vp, tables, lengths)

    def plain():
        return pa.paged_attention_reference(q, kp, vp, tables, lengths)

    got, want = kernel(), plain()
    torch.cuda.synchronize()
    e = (got - want).abs().max().item()
    if not torch.allclose(got, want, **K4_TOL):
        raise SystemExit(f"K4 at the tp shard shape disagrees with its "
                         f"plain version: max_abs_err {e:.3e}")
    b, by = bound_ms(pa.work(ls, kvh, g, hd, 2, 2))
    out = dict(at=f"8 slots, {kvh} kv heads, g {g}, hd {hd}, bs {bs}, "
                  f"bf16 pool, {sum(ls)} live tokens",
               max_abs_err=e, ms=time_ms(kernel), plain_ms=time_ms(plain),
               bound_ms=b, bound_by=by, library_ms=None)
    print(f"K4 paged at the tp-{TP} shard shape ({out['at']}): "
          f"max_abs_err {e:.3e} (tol atol {K4_TOL['atol']}) ok; kernel "
          f"{out['ms']:.4f} ms, plain {out['plain_ms']:.4f} ms, bound "
          f"{b:.4f} ms ({by})")
    return out


def run_tp(model, cfg, ref: dict, fa, pa, gen, card: str) -> dict:
    """Tensor-parallel serving on the one card: run_engine's Llama-3-8B
    split into TP shards (``shard_params_for_serving`` over
    ``TensorMesh(("cuda:0",) * TP)``), the same 9 concurrent prompts (the
    700-token one chunked) and the prefix-hit repeat through the paged
    engine, two of the prompts admitted through ``prefilled=`` payloads
    of a PrefillEngine; then the same requests at tp 1. Streams at tp 2
    held to tp 1's (near-tie rule); K1 and K4 launched exactly TP times
    as often as at tp 1; TTFT and TPOT p50 of both; one tp-2 decode
    block traced (device busy, idle share); K1 (check_flash's cases) and
    K4 at the shard's heads against their plain versions."""
    from ray_tpu_torch.llm import kvcache, model as lm
    from ray_tpu_torch.llm.pd import PrefillEngine
    from ray_tpu_torch.parallel.tp import TensorMesh
    mesh = TensorMesh(("cuda:0",) * TP)
    t0 = time.monotonic()
    sharded = lm.shard_params_for_serving(model, mesh, cfg)
    torch.cuda.synchronize()
    shard_gb = sum(p.nbytes for p in sharded.shards[0].parameters()) / 1e9
    print(f"tp {TP}: {len(sharded.shards)} shards of {shard_gb:.2f} GB on "
          f"{[str(d) for d in mesh.devices]} in "
          f"{time.monotonic() - t0:.1f} s")
    prompts, new = ref["prompts"], ref["new"]
    pre = PrefillEngine(cfg, model, max_len=SERVE_KW["max_len"],
                        prefill_buckets=SERVE_KW["prefill_buckets"])
    shipped = (1, 2)
    runs = {}
    for tp, params, kw in ((TP, sharded, dict(mesh=mesh)), (1, model, {})):
        payloads = [pre.prefill(p) if i in shipped else None
                    for i, p in enumerate(prompts)]
        reset_serving_counts()
        first, wall, (hit,), stats = serve(params, cfg, prompts, new,
                                           then=[ref["repeat"]],
                                           payloads=payloads, **kw)
        runs[tp] = dict(first=first, wall=wall, hit=hit, stats=stats,
                        launches=serving_counts(),
                        latency=latency(first, wall))
        print(f"tp {tp} engine [{card}]: {latency_line(first, wall)}; "
              f"launches {runs[tp]['launches']}; prefix hit "
              f"{hit[0]['prefix_hit_tokens']} tokens; handoff_bytes "
              f"{stats['handoff_bytes']}")
    a, b = runs[TP], runs[1]
    if a["stats"]["tensor_parallel"] != TP or a["hit"][0][
            "prefix_hit_tokens"] != b["hit"][0]["prefix_hit_tokens"] or \
            a["hit"][0]["prefix_hit_tokens"] <= 0:
        raise SystemExit(f"tp {TP} engine: stats {a['stats']}, prefix hit "
                         f"{a['hit'][0]['prefix_hit_tokens']}")
    for key in ("flash_attention_fwd", "paged_attention"):
        n1 = b["launches"][key]
        if n1 <= 0 or n1 % cfg.n_layers or \
                a["launches"][key] != TP * n1:
            raise SystemExit(f"{key}: {a['launches'][key]} launches at tp "
                             f"{TP}, {n1} at tp 1 ({cfg.n_layers} layers)")
    print(f"tp {TP} launches [{card}]: K1 {a['launches']['flash_attention_fwd']}"
          f" = {TP} x {b['launches']['flash_attention_fwd']}, K4 "
          f"{a['launches']['paged_attention']} = {TP} x "
          f"{b['launches']['paged_attention']} ({cfg.n_layers} layers)")
    flips = check_streams(
        model, cfg, f"tp {TP} vs tp 1", prompts + [ref["repeat"]],
        [o["tokens"] for o, _, _ in a["first"] + [a["hit"]]],
        [o["tokens"] for o, _, _ in b["first"] + [b["hit"]]])
    slots, w, bs, n = 8, 64, 16, 8
    pool = kvcache.init_pool(cfg, 1 + slots * w, bs, torch.bfloat16,
                             "cuda", mesh)
    tables = (1 + torch.arange(slots * w, dtype=torch.int32,
                               device="cuda")).reshape(slots, w)
    lengths = torch.full((slots,), 512, dtype=torch.int32, device="cuda")
    tokens = torch.zeros((slots,), dtype=torch.int32, device="cuda")

    def decode_block():
        out, _ = kvcache.paged_decode_steps(
            sharded, pool, tables, lengths, tokens, None, None, cfg, n,
            impl="paged_flash")
        return out.cpu()

    step = trace_step(f"tp {TP} decode step (8 slots x 512 tokens)",
                      decode_block, n, card)
    shard_k1 = check_flash(fa, gen, 32 // TP, 8 // TP,
                           f" at the tp-{TP} shard heads")
    shard_k4 = check_paged_shard(pa, gen)
    del sharded, pool
    return dict(launches=a["launches"], launches_tp1=b["launches"],
                latency={str(TP): a["latency"], "1": b["latency"]},
                step=step, flips=flips, k1_shard=shard_k1,
                k4_shard=shard_k4)


def trace_step(name: str, fn, per: int, card: str) -> dict:
    """Host wall of ``fn`` (ending in a host copy) over 3 calls after a
    warm-up, per ``per`` steps, and one call traced with torch.profiler:
    the device's busy time (kernel intervals), its idle share, the
    attention kernels' time and the largest kernels, all per step."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    t0 = time.monotonic()
    for _ in range(3):
        fn()
    wall = (time.monotonic() - t0) / 3 / per * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
    kernels = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            kernels[e.name] = kernels.get(e.name, 0.0) + \
                e.time_range.elapsed_us() / 1e3 / per
    busy = sum(kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:6]
    idle = f"{1 - busy / wall:.3f}" if busy else "not measured"
    attn = {"K1": sum(v for k, v in kernels.items()
                      if _kernel_kind(k) == "K1"),
            "K4": sum(v for k, v in kernels.items()
                      if "paged_decode_kernel" in k)}
    print(f"{name} [{card}]: host wall {wall:.3f} ms, device busy "
          f"{busy:.3f} ms, device idle share {idle}; attention (ms): "
          + "; ".join(f"{k} {v:.3f}" for k, v in attn.items())
          + "; top kernels (ms): "
          + "; ".join(f"{k[:60]} {v:.3f}" for k, v in top))
    return dict(wall_ms=wall, busy_ms=busy, idle=idle, **attn)


def breakdown(model, cfg, card: str, mono: dict, verify: dict) -> None:
    """Where a steady-state step goes: one decode block (8 slots at 512
    cached tokens, 8 chained greedy steps, one host sync) and one
    512-token prefill, each timed and traced (``trace_step``); then the
    paged decode step's device time beside the monolithic one's and the
    verify forward's (traced in their phases at the same shape)."""
    from ray_tpu_torch.llm import kvcache, model as lm
    slots, w, bs, n = 8, 64, 16, 8
    pool = kvcache.init_pool(cfg, 1 + slots * w, bs, torch.bfloat16, "cuda")
    tables = (1 + torch.arange(slots * w, dtype=torch.int32,
                               device="cuda")).reshape(slots, w)
    lengths = torch.full((slots,), 512, dtype=torch.int32, device="cuda")
    tokens = torch.zeros((slots,), dtype=torch.int32, device="cuda")
    prompt = torch.zeros((512,), dtype=torch.int32, device="cuda")

    def decode_block():
        out, _ = kvcache.paged_decode_steps(
            model, pool, tables, lengths, tokens, None, None, cfg, n,
            impl="paged_flash")
        return out.cpu()

    def prefill():
        return lm.prefill(model, prompt, 512, cfg, 512)[0].cpu()

    paged = trace_step("decode step", decode_block, n, card)
    trace_step("prefill 512", prefill, 1, card)
    print(f"decode step at 8 slots x 512 tokens, device busy [{card}]: "
          f"paged {paged['busy_ms']:.3f} ms (K4 {paged['K4']:.3f}), "
          f"monolithic {mono['busy_ms']:.3f} ms, one verify forward at "
          f"w 5 {verify['busy_ms']:.3f} ms")


SPEC_K = 4      # LLMEngine's default draft length: verify width 5


def run_monolithic(model, cfg, ref: dict, card: str) -> dict:
    """LLMEngine(kv_block_size=0) on run_engine's 9 prompts and its prefix
    repeat: K1 launches, no K4 launch, every stream run_engine's apart
    from near-tie flips. Then one monolithic decode block (8 slots at 512
    cached tokens in a 1024-long cache, 8 chained steps) traced."""
    from ray_tpu_torch.llm import model as lm
    new = ref["new"]
    reset_serving_counts()
    first, wall, (hit,), stats = serve(model, cfg, ref["prompts"], new,
                                       then=[ref["repeat"]],
                                       kv_block_size=0)
    launches = serving_counts()
    print(f"monolithic engine [{card}]: {len(first)} concurrent requests "
          f"+ the prefix repeat, {new} new tokens each; "
          f"{latency_line(first, wall)}; launches {launches}; stats {stats}")
    if launches["flash_attention_fwd"] <= 0 or launches["paged_attention"]:
        raise SystemExit(f"the monolithic path must launch K1 and no K4: "
                         f"{launches}")
    if stats["paged"] or stats["cache_len"] != 1024:
        raise SystemExit(f"not a monolithic 1024-long cache: {stats}")
    flips = check_streams(
        model, cfg, "monolithic vs paged", ref["prompts"] + [ref["repeat"]],
        [o["tokens"] for o, _, _ in first] + [hit[0]["tokens"]],
        ref["streams"] + [ref["hit_stream"]])
    slots, n = 8, 8
    cache = lm.init_cache(cfg, slots, 1024, torch.bfloat16, "cuda")
    tokens = torch.zeros((slots,), dtype=torch.int32, device="cuda")

    def decode_block():
        cache["length"].fill_(512)
        out, _ = lm.decode_steps(model, cache, tokens, None, None, cfg, n)
        return out.cpu()

    step = trace_step("monolithic decode step", decode_block, n, card)
    del cache
    return dict(launches=launches, flips=flips, step=step)


def check_verify_vs_k4(pa, gen) -> float:
    """paged_attention_verify at the spec engine's shape (8 slots, w 5,
    bf16 pool, 8 kv heads, g 4, hd 128, block 16, width 64) against K4:
    row j of verify at cached lengths across block edges equals K4 with
    the query of row j at lengths + j + 1, within K4_TOL."""
    slots, wq, kvh, g, hd, bs, w = 8, SPEC_K + 1, 8, 4, 128, 16, 64
    nb = 1 + slots * w
    q = torch.randn((slots, wq, kvh, g, hd), generator=gen, device="cuda",
                    dtype=torch.bfloat16)
    kp, vp = (torch.randn((nb, bs, kvh, hd), generator=gen, device="cuda",
                          dtype=torch.bfloat16) for _ in range(2))
    tables = (1 + torch.randperm(nb - 1, generator=gen, device="cuda")
              ).to(torch.int32).reshape(slots, w)
    cached = torch.tensor([0, 11, 15, 16, 255, 508, 700, 1019],
                          dtype=torch.int32, device="cuda")
    steps = torch.arange(1, wq + 1, dtype=torch.int32, device="cuda")
    got = pa.paged_attention_verify(q, kp, vp, tables,
                                    cached[:, None] + steps[None])
    err = 0.0
    for j in range(wq):
        want = pa.paged_attention(q[:, j].contiguous(), kp, vp, tables,
                                  cached + j + 1)
        torch.cuda.synchronize()
        if not torch.allclose(got[:, j], want, **K4_TOL):
            raise SystemExit(f"verify row {j} disagrees with K4")
        err = max(err, (got[:, j] - want).abs().max().item())
    print(f"paged_attention_verify vs K4 per row (8 slots, w {wq}, cached "
          f"{cached.tolist()}): max_abs_err {err:.3e} (tol atol "
          f"{K4_TOL['atol']}) ok")
    return err


def engine_times(timers: dict):
    """Patch LLMEngine's admit, decode-block and verify entries (each ends
    in its one host sync) to add their calls and host seconds to
    ``timers``; returns the undo."""
    from ray_tpu_torch.llm.engine import LLMEngine
    saved = {}
    for name in ("_admit_impl", "_decode_impl", "_verify_impl"):
        real = saved[name] = getattr(LLMEngine, name)

        def wrap(self, *args, _real=real, _name=name, **kw):
            t0 = time.monotonic()
            try:
                return _real(self, *args, **kw)
            finally:
                rec = timers.setdefault(_name, [0, 0.0])
                rec[0] += 1
                rec[1] += time.monotonic() - t0
        setattr(LLMEngine, name, wrap)

    def undo():
        for name, real in saved.items():
            setattr(LLMEngine, name, real)
    return undo


def run_spec(model, cfg, pa, gen, card: str) -> dict:
    """Speculative decoding: 8 prompts of 256-480 tokens, each repeating
    its own random 48-token phrase, 64 new greedy tokens each, through
    LLMEngine(spec=True) and LLMEngine(spec=False) in the order spec,
    vanilla, vanilla, spec: verify forwards and drafted tokens (counted
    by wrapping spec.accept_tokens here) above zero, both spec drives'
    streams equal to the first vanilla drive's apart from near ties. Each
    drive prints its host seconds in admits, decode blocks, verify rounds
    and acceptance, and when its requests finished. Then the verify
    attention against K4 per row, and one verify forward (w 5, 8 slots at
    512 cached tokens) traced."""
    from ray_tpu_torch.llm import kvcache, spec
    rng = np.random.default_rng(2)
    prompts = []
    for n in rng.integers(256, 481, 8):
        phrase = [int(t) for t in rng.integers(0, cfg.vocab_size, 48)]
        prompts.append((phrase * (n // 48 + 1))[:n])
    new = 64
    seen = dict(rounds=0, drafted=0, accepted=0, emitted=0)
    real = spec.accept_tokens

    def drive(spec_on: bool):
        timers: dict = {}
        acc = [0, 0.0]
        blocks = dict(blocks=0, steps=0)
        real_decode = kvcache.paged_decode_steps

        def counting(logits, draft, **kw):
            t0 = time.monotonic()
            out = real(logits, draft, **kw)
            acc[0] += 1
            acc[1] += time.monotonic() - t0
            if draft:
                seen["rounds"] += 1
                seen["drafted"] += len(draft)
                seen["accepted"] += out[1]
                seen["emitted"] += len(out[0])
            return out

        def counting_decode(*args, **kw):
            blocks["blocks"] += 1
            blocks["steps"] += args[8]
            return real_decode(*args, **kw)

        spec.accept_tokens = counting
        kvcache.paged_decode_steps = counting_decode
        undo = engine_times(timers)
        try:
            reset_serving_counts()
            runs, wall, _, stats = serve(model, cfg, prompts, new,
                                         spec=spec_on)
            launches = serving_counts()
        finally:
            spec.accept_tokens = real
            kvcache.paged_decode_steps = real_decode
            undo()
        t_first = min(t for _, t, _ in runs)
        done = sorted(d - t_first for _, _, d in runs)
        parts = {k: timers.get(k, [0, 0.0]) for k in
                 ("_admit_impl", "_decode_impl", "_verify_impl")}
        rest = wall - sum(v[1] for v in parts.values()) - acc[1]
        print(f"{'spec=True ' if spec_on else 'spec=False'} [{card}]: "
              f"{latency_line(runs, wall)}; host s: admits "
              f"{parts['_admit_impl'][1]:.3f} ({parts['_admit_impl'][0]}), "
              f"decode blocks {parts['_decode_impl'][1]:.3f} "
              f"({blocks['blocks']} blocks, {blocks['steps']} steps), "
              f"verify rounds {parts['_verify_impl'][1]:.3f} "
              f"({parts['_verify_impl'][0]}), accept_tokens {acc[1]:.3f}, "
              f"rest {rest:.3f}; requests done at "
              f"{[round(d, 2) for d in done]} s; launches {launches}")
        return dict(runs=runs, wall=wall, stats=stats, launches=launches,
                    blocks=blocks, verify_s=parts["_verify_impl"][1],
                    decode_s=parts["_decode_impl"][1], done=done)

    reset_obs()
    spec_a = drive(True)
    van_a = drive(False)
    van_b = drive(False)
    spec_b = drive(True)
    launches = {k: spec_a["launches"][k] + spec_b["launches"][k]
                for k in spec_a["launches"]}
    blocks = {k: spec_a["blocks"][k] + spec_b["blocks"][k]
              for k in spec_a["blocks"]}
    rate = seen["accepted"] / max(1, seen["drafted"])
    per_fwd = seen["emitted"] / max(1, seen["rounds"])
    tps = [len(prompts) * new / d["wall"]
           for d in (spec_a, van_a, van_b, spec_b)]
    print(f"spec engine [{card}]: 8 prompts of {min(map(len, prompts))}-"
          f"{max(map(len, prompts))} tokens, {new} new tokens each, two "
          f"spec drives: {launches['verify_forwards']} verify forwards "
          f"against {blocks['blocks']} decode blocks ({blocks['steps']} "
          f"steps); drafted {seen['drafted']}, accepted {seen['accepted']} "
          f"(accept rate {rate:.3f}), {per_fwd:.2f} tokens per drafting "
          f"slot per verify forward; generated tok/s spec, vanilla, "
          f"vanilla, spec: {[round(x, 1) for x in tps]}; launches "
          f"{launches}; spec {spec_a['stats']['spec']}")
    if launches["verify_forwards"] <= 0 or seen["drafted"] <= 0:
        raise SystemExit(f"the spec drive ran no verify forward or drafted "
                         f"nothing: {launches}, {seen}")
    kinds = {k: metric("llm_spec_tokens_total", kind=k)
             for k in ("drafted", "accepted", "rejected")}
    print(f"metrics spec [{card}]: llm_spec_tokens_total {kinds}, "
          f"llm_spec_accept_rate (last finished request) "
          f"{metric('llm_spec_accept_rate'):.4f}; drafts counted by "
          f"wrapping accept_tokens: {seen['drafted']} drafted, "
          f"{seen['accepted']} accepted")
    if kinds["drafted"] != seen["drafted"] or kinds["accepted"] != \
            seen["accepted"] or \
            kinds["accepted"] + kinds["rejected"] != kinds["drafted"]:
        raise SystemExit(f"llm_spec_tokens_total {kinds} disagrees with "
                         f"the drafts counted: {seen}")
    want = [o["tokens"] for o, _, _ in van_a["runs"]]
    flips = []
    for tag, d in (("spec A", spec_a), ("spec B", spec_b),
                   ("vanilla B", van_b)):
        flips += check_streams(model, cfg, f"{tag} vs vanilla A", prompts,
                               [o["tokens"] for o, _, _ in d["runs"]], want)
    err = check_verify_vs_k4(pa, gen)

    slots, w, bs = 8, 64, 16
    pool = kvcache.init_pool(cfg, 1 + slots * w, bs, torch.bfloat16, "cuda")
    tables = (1 + torch.arange(slots * w, dtype=torch.int32,
                               device="cuda")).reshape(slots, w)
    lengths = torch.full((slots,), 512, dtype=torch.int32, device="cuda")
    tokens = torch.zeros((slots, SPEC_K + 1), dtype=torch.int32,
                         device="cuda")

    def verify():
        logits, _ = kvcache.paged_verify_steps(model, pool, tables, lengths,
                                               tokens, cfg)
        return logits.cpu()

    step = trace_step(f"verify forward w {SPEC_K + 1}", verify, 1, card)
    del pool
    return dict(launches=launches, flips=flips, accept_rate=rate,
                tokens_per_forward=per_fwd, verify_vs_k4_err=err,
                step=step, **seen, **blocks)


def run_pd(model, cfg, ref: dict, card: str) -> dict:
    """The prefill/decode handoff: PrefillEngine over run_engine's 9
    prompts (K1 launches), then a paged LLMEngine admitting the payloads
    through prefilled= (K4 launches). Streams of prompts of at most 512
    tokens equal run_engine's; the 700-token prompt's may differ by a
    near-tie flip. The payload ships in the cache dtype (bf16 as uint16
    bits), so handoff_bytes and llm_kv_handoff_bytes_total are the
    block-granular ship length x layers x kv heads x head_dim x 2 bytes x
    2 (k and v)."""
    from ray_tpu_torch.llm.pd import PrefillEngine
    prompts = ref["prompts"]
    pre = PrefillEngine(cfg, model, max_len=SERVE_KW["max_len"],
                        prefill_buckets=SERVE_KW["prefill_buckets"])
    reset_serving_counts()
    t0 = time.monotonic()
    payloads = [pre.prefill(p) for p in prompts]
    prefill_s = time.monotonic() - t0
    k1 = serving_counts()
    ship = [-(-len(p) // pre.block_size) * pre.block_size for p in prompts]
    want_bytes = (sum(ship) * cfg.n_layers * cfg.n_kv_heads * cfg.head_dim
                  * 2 * 2)
    dtypes = sorted({(p["kv_dtype"], str(p["k"].dtype)) for p in payloads})
    reset_serving_counts()
    reset_obs()
    runs, wall, _, stats = serve(model, cfg, prompts, ref["new"],
                                 payloads=payloads)
    k4 = serving_counts()
    counted = metric("llm_kv_handoff_bytes_total")
    print(f"PD handoff [{card}]: PrefillEngine over {len(prompts)} prompts "
          f"in {prefill_s:.2f} s (launches {k1}); decode engine "
          f"{latency_line(runs, wall)} (launches {k4}); payload KV "
          f"{dtypes}; handoff_bytes {stats['handoff_bytes']}, "
          f"llm_kv_handoff_bytes_total {counted:.0f} (expected "
          f"{want_bytes}, ship lengths {ship})")
    if k1["flash_attention_fwd"] <= 0 or k4["paged_attention"] <= 0:
        raise SystemExit(f"PD must launch K1 on the prefill side and K4 on "
                         f"the decode side: {k1}, {k4}")
    if dtypes != [("bfloat16", "uint16")]:
        raise SystemExit(f"the payload is not bf16 bits: {dtypes}")
    if stats["handoff_bytes"] != want_bytes or counted != want_bytes:
        raise SystemExit("handoff bytes are not the block-granular bf16 "
                         "payload")
    flips = check_streams(
        model, cfg, "PD vs unified", prompts,
        [o["tokens"] for o, _, _ in runs], ref["streams"],
        exact=[i for i, p in enumerate(prompts) if len(p) <= 512])
    handle = run_pd_handles(model, cfg, pre, prompts, ref["new"],
                            [o["tokens"] for o, _, _ in runs], want_bytes,
                            card)
    return dict(prefill=k1, decode=k4, flips=flips,
                handoff_bytes=stats["handoff_bytes"], want_bytes=want_bytes,
                handle=handle)


def run_pd_handles(model, cfg, pre, prompts, new, want, want_bytes,
                   card: str) -> dict:
    """The handoff by handle in one process: ``prefill(device=True)``
    parks each prompt's bf16 KV on the card behind TensorRef handles; a
    handle resolves to the parked CUDA tensor itself (no host copy); the
    engine admits the handles, and its streams equal the host payload's
    (``want``) token for token, with the same block-granular bytes
    counted. The engine frees every handle it admits."""
    from ray_tpu_torch.runtime.device_store import _store, get_device
    live0 = _store().live_count()
    reset_serving_counts()
    t0 = time.monotonic()
    handles = [pre.prefill(p, device=True) for p in prompts]
    prefill_s = time.monotonic() - t0
    k1 = serving_counts()
    for h in handles:
        for key in ("k", "v"):
            t = get_device(h[key])
            if not (t.is_cuda and t.dtype == torch.bfloat16
                    and get_device(h[key], "cuda") is t
                    and tuple(t.shape) == h[key].shape):
                raise SystemExit(f"handle {h[key]} does not resolve to its "
                                 "parked bf16 CUDA tensor")
    if _store().live_count() != live0 + 2 * len(prompts):
        raise SystemExit("prefill(device=True) parked "
                         f"{_store().live_count() - live0} tensors")
    reset_serving_counts()
    runs, wall, _, stats = serve(model, cfg, prompts, new, payloads=handles)
    k4 = serving_counts()
    got = [o["tokens"] for o, _, _ in runs]
    print(f"PD handoff by handle, one process [{card}]: prefill "
          f"{prefill_s:.2f} s (launches {k1}); decode "
          f"{latency_line(runs, wall)} (launches {k4}); handoff_bytes "
          f"{stats['handoff_bytes']} (expected {want_bytes}); store "
          f"{_store().stats()} after the drive")
    if k1["flash_attention_fwd"] <= 0 or k4["paged_attention"] <= 0:
        raise SystemExit(f"the handle path must launch K1 and K4: {k1}, "
                         f"{k4}")
    if got != want:
        raise SystemExit(f"PD by handle differs from the host payload's "
                         f"streams: {got} vs {want}")
    if stats["handoff_bytes"] != want_bytes:
        raise SystemExit("handle handoff bytes are not the block-granular "
                         "bf16 payload")
    if _store().live_count() != live0:
        raise SystemExit("the engine left admitted handles parked")
    return dict(prefill=k1, decode=k4)


def foreign_modules() -> list:
    """This process's modules of jax, ml_dtypes or the JAX package."""
    return sorted(m for m in sys.modules if m.split(".")[0] in
                  ("jax", "jaxlib", "ml_dtypes", "ray_tpu"))


class PrefillTier:
    """The prefill tier of the runtime PD phase, in its own worker
    process: Llama-3-8B at full width with run_engine's random bf16
    weights (seed 0), behind a PrefillEngine whose ``prefill`` parks the
    prompt KV on the card and returns TensorRef handles."""

    def __init__(self, cfg):
        from ray_tpu_torch.llm.pd import PrefillEngine
        from ray_tpu_torch.models import llama
        model = llama.init_params(
            torch.Generator(device="cuda").manual_seed(0), cfg)
        self.engine = PrefillEngine(
            cfg, model, max_len=SERVE_KW["max_len"],
            prefill_buckets=SERVE_KW["prefill_buckets"])

    def reset_counts(self):
        reset_serving_counts()

    def counts(self):
        """This process's launch counts, device store, foreign modules
        and pid."""
        from ray_tpu_torch.runtime.device_store import _store
        return (serving_counts(), _store().stats(), foreign_modules(),
                os.getpid())

    def prefill(self, tokens):
        return self.engine.prefill(tokens, device=True)

    def prefill_stage(self, tokens):
        """run_dag_pd's first stage, in the pinned loop's executor thread
        (the card made current there): the prompt and its
        ``prefill(device=True)`` payload, whose k/v are TensorRefs."""
        torch.cuda.set_device(0)
        return {"tokens": tokens,
                "prefilled": self.engine.prefill(tokens, device=True)}


class DecodeTier:
    """The decode tier of the runtime PD phase, in its own worker
    process: the same model behind a paged LLMEngine with an explicit
    pool (``pool_blocks``, so its footprint does not depend on which
    tier initialises first). ``generate`` admits a prefill result whose
    handles the engine fetches from the prefill tier (one fetch each,
    timed here with its bytes) and frees."""

    def __init__(self, cfg, pool_blocks: int):
        from ray_tpu_torch.llm.engine import LLMEngine
        from ray_tpu_torch.models import llama
        from ray_tpu_torch.runtime import device_store
        self.cfg = cfg
        self.model = llama.init_params(
            torch.Generator(device="cuda").manual_seed(0), cfg)
        self.engine = LLMEngine(cfg, self.model, **SERVE_KW,
                                kv_pool_blocks=pool_blocks)
        self.fetches = []       # (bytes, seconds) per cross-process fetch
        real = device_store.DeviceStore.get

        def timed(store, ref, device=None):
            t0 = time.monotonic()
            t = real(store, ref, device)
            self.fetches.append((t.nbytes, time.monotonic() - t0))
            return t
        device_store.DeviceStore.get = timed

    def reset_counts(self):
        reset_serving_counts()
        self.fetches.clear()

    def counts(self):
        from ray_tpu_torch.runtime.device_store import _store
        return (serving_counts(), _store().stats(), foreign_modules(),
                os.getpid(), list(self.fetches), self.engine.stats)

    async def generate(self, tokens, prefilled, new: int):
        """One request admitted from ``prefilled`` (the prefill tier's
        result: the runtime resolves the ObjectRef the driver passed),
        as (result, submitted at, done at) on this process's clock."""
        t_sub = time.monotonic()
        out = await self.engine.generate_prefilled(
            tokens, prefilled, max_new_tokens=new)
        return out, t_sub, time.monotonic()

    async def bind_loop(self):
        """Keeps the actor's event loop, where the engine's scheduler
        runs, for ``decode_stage``; run_dag_pd calls it before
        ``compile()``."""
        self.loop = asyncio.get_running_loop()

    def decode_stage(self, item, new: int):
        """run_dag_pd's second stage. It runs synchronously in the pinned
        loop's executor thread (the card made current there), while the
        engine's scheduler lives on the actor's event loop (kept by
        ``bind_loop``): the request is submitted to that loop and
        waited for here. Returns its ``new`` tokens and, on this
        process's clock, when the stage took and finished the item."""
        torch.cuda.set_device(0)
        t0 = time.monotonic()
        out = asyncio.run_coroutine_threadsafe(
            self.engine.generate_prefilled(
                item["tokens"], item["prefilled"], max_new_tokens=new),
            self.loop).result()
        return {"tokens": out["tokens"], "t0": t0, "t1": time.monotonic()}

    def check(self, prompts, got, want, exact):
        """check_streams on this tier's copy of the model (the driver has
        freed its own)."""
        return check_streams(self.model, self.cfg, "runtime PD vs unified",
                             prompts, got, want, exact=exact)


def run_runtime_pd(cfg, ref: dict, want_bytes: int, card: str) -> dict:
    """The disaggregated serving path through the port's runtime: init()
    starts a head, an agent and worker processes; a PrefillTier actor and
    a DecodeTier actor, each in its own process with its own Llama-3-8B
    on the card, serve run_engine's 9 prompts (32 new greedy tokens
    each). The driver submits every prefill, then hands each prefill
    result's ObjectRef to the decode tier, as the JAX package's PD
    ingress does (ray_tpu/serve/llm.py). Each tier reports its own
    process's launch counts (K1 > 0 in the prefill tier, K4 > 0 in the
    decode tier), device store (empty after the drive: the decode tier
    freed every handle it admitted) and modules (no jax, ml_dtypes or
    ray_tpu). The bytes fetched equal run_pd's block-granular bf16
    payload; streams are held to run_engine's at run_pd's bar."""
    import ray_tpu_torch
    prompts, new = ref["prompts"], ref["new"]
    pool_blocks = engine_pool_blocks()
    ray_tpu_torch.init(num_cpus=4)
    try:
        t0 = time.monotonic()
        pre = ray_tpu_torch.remote(PrefillTier).remote(cfg)
        dec = ray_tpu_torch.remote(DecodeTier).remote(cfg, pool_blocks)
        ray_tpu_torch.get([pre.reset_counts.remote(),
                           dec.reset_counts.remote()], timeout=600)
        print(f"runtime PD [{card}]: two tiers up, each with its own "
              f"Llama-3-8B, in {time.monotonic() - t0:.1f} s")
        t0 = time.monotonic()
        results = [pre.prefill.remote(p) for p in prompts]
        runs = ray_tpu_torch.get(
            [dec.generate.remote(p, r, new)
             for p, r in zip(prompts, results)], timeout=600)
        wall = time.monotonic() - t0
        k1, pre_store, pre_mods, pre_pid = ray_tpu_torch.get(
            pre.counts.remote(), timeout=60)
        k4, dec_store, dec_mods, dec_pid, fetches, stats = \
            ray_tpu_torch.get(dec.counts.remote(), timeout=60)
        got = [o["tokens"] for o, _, _ in runs]
        fetched = sum(b for b, _ in fetches)
        fetch_ms = [round(s * 1e3, 3) for _, s in fetches]
        # each handle's rate from its own bytes and time, GB/s
        rates = [b / s / 1e9 for b, s in fetches]
        print(f"runtime PD [{card}]: {len(prompts)} requests, {new} new "
              f"tokens each, drive wall {wall:.2f} s; decode tier "
              f"{latency_line(runs, wall)}; prefill tier launches {k1}, "
              f"decode tier launches {k4}; {len(fetches)} handles fetched, "
              f"{fetched} bytes (expected {want_bytes}), fetch ms per "
              f"handle p50 {np.median(fetch_ms):.3f} max "
              f"{max(fetch_ms):.3f}; GB/s per handle {min(rates):.3f}-"
              f"{max(rates):.3f}, all handles "
              f"{fetched / sum(s for _, s in fetches) / 1e9:.3f}; "
              f"(bytes, ms) per handle in fetch order "
              f"{[(b, m) for (b, _), m in zip(fetches, fetch_ms)]}; "
              f"handoff_bytes {stats['handoff_bytes']}; stores after the "
              f"drive: prefill {pre_store}, decode {dec_store}")
        if k1["flash_attention_fwd"] <= 0 or k4["paged_attention"] <= 0:
            raise SystemExit(f"runtime PD must launch K1 in the prefill "
                             f"tier and K4 in the decode tier: {k1}, {k4}")
        if pre_mods or dec_mods:
            raise SystemExit(f"a tier loaded jax or ray_tpu: {pre_mods}, "
                             f"{dec_mods}")
        if len(fetches) != 2 * len(prompts) or fetched != want_bytes \
                or stats["handoff_bytes"] != want_bytes:
            raise SystemExit("the fetched bytes are not the block-granular "
                             "bf16 payload")
        if pre_store["live_count"] or dec_store["live_count"]:
            raise SystemExit("a tier's device store is not empty")
        for toks in got:
            if len(toks) != new or not all(0 <= t < cfg.vocab_size
                                           for t in toks):
                raise SystemExit(f"bad generation: {toks}")
        flips = ray_tpu_torch.get(dec.check.remote(
            prompts, got, ref["streams"],
            [i for i, p in enumerate(prompts) if len(p) <= 512]),
            timeout=300)
        dag = run_dag_pd(pre, dec, ref, want_bytes, wall, card)
        for a in (pre, dec):
            ray_tpu_torch.kill(a)
    finally:
        ray_tpu_torch.shutdown()
    wait_exited([pre_pid, dec_pid], 60.0)
    print(f"runtime PD [{card}]: streams at run_pd's bar, "
          f"{len(flips)} near-tie flips "
          f"{[(f['stream'], f['position']) for f in flips]} (stream, "
          f"position); both tier processes exited")
    return dict(prefill=k1, decode=k4, flips=flips, wall_s=wall,
                fetch_ms=fetch_ms, fetched_bytes=fetched,
                latency=latency(runs, wall), dag=dag)


def shm_size() -> tuple:
    """(total, free) bytes of /dev/shm, where the DAG's rings live."""
    import shutil
    u = shutil.disk_usage("/dev/shm")
    return u.total, u.free


# The DAG's shm rings for run_dag_pd: an item's frame is the prompt, two
# TensorRef handles and the prefill's f32 logits (128256 x 4 = 513 KB),
# so 1 MiB slots; 4 slots a ring, 3 rings (driver -> prefill -> decode ->
# driver): 12 MiB of /dev/shm.
DAG_PD_SLOT_BYTES, DAG_PD_NSLOTS = 1 << 20, 4


def run_dag_pd(pre, dec, ref: dict, want_bytes: int, rpd_wall: float,
               card: str) -> dict:
    """The compiled DAG over run_runtime_pd's two tier actors, after that
    phase's own drive: ``compile(dec.decode_stage.bind(
    pre.prefill_stage.bind(inp), new))``. The prefill stage returns
    ``prefill(device=True)``'s payload, so only TensorRef handles (and the
    prompt and logits) ride the shm rings; the decode stage admits it and
    returns the request's tokens. All 9 ``execute`` calls go in before the
    first ``get``. Checks: K1 launched in the prefill tier and K4 in the
    decode tier during the drive; 18 handles fetched, 350,224,384 bytes
    (run_pd's), and the engine's handoff bytes grew by as much; both
    device stores empty after the drive; streams at run_pd's bar;
    ``teardown()`` hands both actors back (their sync methods answer).
    Prints the drive wall beside run_runtime_pd's, tok/s, the decode
    stage's wall per item and ``CompiledDag.stage_stats``. Then
    ``run_dag_staging``."""
    import ray_tpu_torch
    from ray_tpu_torch.dag import InputNode, compile
    prompts, new = ref["prompts"], ref["new"]
    get = ray_tpu_torch.get
    get([pre.reset_counts.remote(), dec.reset_counts.remote(),
         dec.bind_loop.remote()], timeout=60)
    hb0 = get(dec.counts.remote(), timeout=60)[5]["handoff_bytes"]
    total, free = shm_size()
    print(f"dag PD [{card}]: /dev/shm {total} bytes, {free} free; rings "
          f"of {DAG_PD_NSLOTS} x {DAG_PD_SLOT_BYTES} bytes")
    with InputNode() as inp:
        out = dec.decode_stage.bind(pre.prefill_stage.bind(inp), new)
    cd = compile(out, nslots=DAG_PD_NSLOTS, slot_bytes=DAG_PD_SLOT_BYTES)
    try:
        t0 = time.monotonic()
        futs = [cd.execute(p) for p in prompts]
        outs = [f.get(timeout=600) for f in futs]
        wall = time.monotonic() - t0
    finally:
        cd.teardown()
    # teardown hands the actors back: their sync methods answer again
    k1, pre_store, _, _ = get(pre.counts.remote(), timeout=60)
    k4, dec_store, _, _, fetches, stats = get(dec.counts.remote(),
                                              timeout=60)
    got = [o["tokens"] for o in outs]
    per_item = [o["t1"] - o["t0"] for o in outs]
    fetched = sum(b for b, _ in fetches)
    stage = {st["method"]: {k: round(v, 4) for k, v in st["timing"].items()}
             for st in cd.stage_stats or []}
    processed = {st["method"]: st["processed"]
                 for st in cd.stage_stats or []}
    print(f"dag PD [{card}]: {len(prompts)} items through prefill_stage -> "
          f"decode_stage, all executed before the first get: drive wall "
          f"{wall:.2f} s (runtime PD's concurrent drive {rpd_wall:.2f} s), "
          f"{len(prompts) * new / wall:.1f} generated tok/s; decode stage "
          f"wall per item p50 {np.median(per_item) * 1e3:.1f} ms, max "
          f"{max(per_item) * 1e3:.1f} ms; stage_stats (s) {stage}, items "
          f"processed {processed}; prefill tier launches {k1}, decode tier "
          f"launches {k4}; {len(fetches)} handles fetched, {fetched} bytes "
          f"(expected {want_bytes}); handoff_bytes +"
          f"{stats['handoff_bytes'] - hb0}; stores after the drive: prefill "
          f"{pre_store}, decode {dec_store}")
    if processed != {"prefill_stage": len(prompts),
                     "decode_stage": len(prompts)}:
        raise SystemExit(f"the DAG's stages processed {processed}")
    if k1["flash_attention_fwd"] <= 0 or k4["paged_attention"] <= 0:
        raise SystemExit(f"the DAG must launch K1 in the prefill tier and "
                         f"K4 in the decode tier: {k1}, {k4}")
    if len(fetches) != 2 * len(prompts) or fetched != want_bytes or \
            stats["handoff_bytes"] - hb0 != want_bytes:
        raise SystemExit("the DAG's handles did not carry the "
                         "block-granular bf16 payload")
    if pre_store["live_count"] or dec_store["live_count"]:
        raise SystemExit("a tier's device store is not empty after the DAG")
    for toks in got:
        if len(toks) != new or not all(0 <= t < 128256 for t in toks):
            raise SystemExit(f"bad generation: {toks}")
    flips = get(dec.check.remote(
        prompts, got, ref["streams"],
        [i for i, p in enumerate(prompts) if len(p) <= 512]), timeout=300)
    print(f"dag PD [{card}]: streams at run_pd's bar, {len(flips)} near-tie "
          f"flips {[(f['stream'], f['position']) for f in flips]}")
    staging = run_dag_staging(card)
    return dict(prefill=k1, decode=k4, wall_s=wall, per_item_s=per_item,
                stage_stats=stage, fetched_bytes=fetched, flips=flips,
                staging=staging)


class StageMake:
    """run_dag_staging's first stage: an 8 MiB bf16 tensor on the card,
    drawn from ``seed``, returned in a dict with an int."""

    def make(self, seed):
        torch.cuda.set_device(0)
        g = torch.Generator(device="cuda").manual_seed(seed)
        x = torch.randn((2048, 2048), generator=g, device="cuda")
        return {"x": x.to(torch.bfloat16), "n": seed}


class StageTake:
    """run_dag_staging's second stage: what arrived, and where."""

    def take(self, d):
        return {"x": d["x"], "n": d["n"], "device": d["x"].device.type}


def run_dag_staging(card: str) -> dict:
    """A two-actor DAG on the card: StageMake returns {"x": 8 MiB bf16
    CUDA tensor, "n": int}; the DAG stages the CUDA leaf to a CPU tensor
    before it enters the ring, and StageTake receives a CPU bf16 tensor,
    bitwise equal to the one this process draws from the same seed (it
    returns it through the sink ring). Slots are sized to fit /dev/shm:
    2 slots of 8 MiB + 64 KiB on each of the 3 rings where they fit, else
    1. One warm-up item, then 8 items executed at once; prints MB/s of the
    tensor bytes through the two hops."""
    import ray_tpu_torch
    from ray_tpu_torch.dag import InputNode, compile
    slot = (8 << 20) + (64 << 10)
    total, free = shm_size()
    nslots = 2 if 3 * 2 * slot <= free else 1
    a = ray_tpu_torch.remote(StageMake).remote()
    b = ray_tpu_torch.remote(StageTake).remote()
    with InputNode() as inp:
        out = b.take.bind(a.make.bind(inp))
    cd = compile(out, nslots=nslots, slot_bytes=slot)
    try:
        warm = cd.execute(100).get(timeout=300)
        t0 = time.monotonic()
        futs = [cd.execute(seed) for seed in range(8)]
        outs = [f.get(timeout=300) for f in futs]
        wall = time.monotonic() - t0
    finally:
        cd.teardown()
    for h in (a, b):
        ray_tpu_torch.kill(h)
    moved = sum(o["x"].numel() * o["x"].element_size() for o in outs)
    bad = []
    for seed, o in zip(range(8), outs):
        g = torch.Generator(device="cuda").manual_seed(seed)
        want = torch.randn((2048, 2048), generator=g,
                           device="cuda").to(torch.bfloat16).cpu()
        if not (o["device"] == "cpu" and o["n"] == seed
                and o["x"].dtype == torch.bfloat16
                and torch.equal(o["x"].view(torch.int16),
                                want.view(torch.int16))):
            bad.append(seed)
    mb_s = moved / wall / 1e6
    print(f"dag staging [{card}]: /dev/shm {total} bytes, {free} free; "
          f"{nslots} slots of {slot} bytes a ring; 8 items of an 8 MiB bf16 "
          f"CUDA tensor through make -> take -> driver in {wall:.3f} s: "
          f"{mb_s:.1f} MB/s of tensor bytes; arrived as CPU bf16, bitwise "
          f"equal: {not bad}")
    if bad or warm["device"] != "cpu":
        raise SystemExit(f"staged tensors differ for seeds {bad}")
    return dict(mb_s=mb_s, wall_s=wall, nslots=nslots, slot_bytes=slot)


def engine_pool_blocks() -> int:
    """The engine phase's pool at block 16: every slot at max_len plus
    one chain of prefix-cache headroom."""
    table_w = SERVE_KW["max_len"] // 16
    return SERVE_KW["max_slots"] * table_w + table_w


def wait_exited(pids, timeout_s: float) -> None:
    """Wait until each process in ``pids`` has exited (gone, or a zombie
    that holds nothing), so the tiers' models leave the card before the
    next phase; fails after ``timeout_s``."""
    deadline = time.monotonic() + timeout_s
    for pid in pids:
        while True:
            try:
                with open(f"/proc/{pid}/stat") as f:
                    state = f.read().rsplit(")", 1)[1].split()[0]
            except FileNotFoundError:
                break
            if state in ("Z", "X"):
                break
            if time.monotonic() > deadline:
                raise SystemExit(f"worker process {pid} did not exit")
            time.sleep(0.2)


def wait_card_back(free0: int, what: str, timeout_s: float = 120.0) -> int:
    """Wait until the card's free memory is back within 1 GiB of
    ``free0``, taken before ``what`` started its worker processes: a
    worker's memory leaves the card when its process has exited, which
    shutdown() waits for, so the first poll is expected to find it back
    (a guard; the polls it took are printed and returned)."""
    deadline = time.monotonic() + timeout_s
    polls = 1
    while torch.cuda.mem_get_info()[0] < free0 - (1 << 30):
        if time.monotonic() > deadline:
            raise SystemExit(
                f"card memory not back after {what}: free "
                f"{torch.cuda.mem_get_info()[0]} of {free0} before")
        time.sleep(0.5)
        polls += 1
    print(f"card memory back after {what}: {polls} poll(s) of "
          f"mem_get_info after shutdown() returned (1: already free)")
    return polls


def compute_apps() -> list:
    """The card's compute processes as nvidia-smi lists them, one entry a
    process. In a container nvidia-smi may give another pid than the
    process's own, or a placeholder such as "[N/A]", so entries are whole
    lines, compared as a multiset with an earlier listing."""
    out = subprocess.run(
        ["nvidia-smi", "--query-compute-apps=pid", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return [line.strip() for line in out.stdout.splitlines()
            if line.strip()]


# Loaded at every interpreter start of run_serve's and run_rllib's
# clusters (through PYTHONPATH): a thread writes the process's module
# names to $CHIP_SMOKE_MODULES/<pid>.txt once a second, and
# "<cuda-initialized>" once torch has initialised CUDA there, so the
# phase can tell what the controller, the proxy, each replica and each
# env runner imported.
MODULE_DUMP = """\
import os, sys, threading, time

def _cuda_initialized():
    cuda = getattr(sys.modules.get("torch"), "cuda", None)
    return cuda is not None and cuda.is_initialized()

def _dump():
    path = os.path.join(os.environ["CHIP_SMOKE_MODULES"], f"{os.getpid()}.txt")
    while True:
        names = sorted(sys.modules)
        if _cuda_initialized():
            names.append("<cuda-initialized>")
        with open(path + ".tmp", "w") as f:
            f.write("\\n".join(names))
        os.replace(path + ".tmp", path)
        time.sleep(1.0)

threading.Thread(target=_dump, daemon=True).start()
"""


def cluster_modules(dumps: str) -> dict:
    """pid -> (role, its jax/ml_dtypes/ray_tpu modules, loads torch) for
    every process of run_serve's cluster that wrote a module dump (this
    process wrote none). The controller loads the replica's
    module too (it creates replicas), so it is named first; a replica
    (an engine's, a PrefillEngine's or the PD ingress's) is then any
    process that loaded serve/replica.py, the proxy one that loaded
    serve/proxy.py."""
    out = {}
    for name in os.listdir(dumps):
        if not name.endswith(".txt"):
            continue
        with open(os.path.join(dumps, name)) as f:
            mods = set(f.read().split())
        role = None
        if "ray_tpu_torch.serve.controller" in mods:
            role = "controller"
        elif "ray_tpu_torch.serve.replica" in mods:
            role = "replica"
        elif "ray_tpu_torch.serve.proxy" in mods:
            role = "proxy"
        bad = sorted(m for m in mods if m.split(".")[0] in
                     ("jax", "jaxlib", "ml_dtypes", "ray_tpu"))
        out[int(name[:-4])] = (role, bad, "torch" in mods)
    return out


def sse_request(addr: dict, path: str, tokens, new: int) -> dict:
    """One request to the proxy as server-sent events: its tokens and,
    on the host clock, when it was sent and when its first and last
    ``data:`` events arrived."""
    import http.client
    conn = http.client.HTTPConnection(addr["host"], addr["port"],
                                      timeout=600)
    t_sub = time.monotonic()
    conn.request("POST", path,
                 body=json.dumps({"tokens": tokens, "max_new_tokens": new}),
                 headers={"Content-Type": "application/json",
                          "Accept": "text/event-stream"})
    resp = conn.getresponse()
    if resp.status != 200:
        raise RuntimeError(f"SSE request got HTTP {resp.status}: "
                           f"{resp.read()[:300]!r}")
    toks, first, last, done = [], None, None, False
    for raw in resp:
        line = raw.decode().strip()
        if line.startswith("data: ") and '"token"' in line:
            last = time.monotonic()
            first = first or last
            toks.append(json.loads(line[len("data: "):])["token"])
        elif line == "event: done":
            done = True
        elif line.startswith("event: "):
            raise RuntimeError(f"SSE stream ended with {line}: "
                               f"{resp.read()[:300]!r}")
    conn.close()
    if not done:
        raise RuntimeError("SSE stream closed without 'event: done'")
    return dict(tokens=toks, t_sub=t_sub, t_first=first, t_last=last)


def sse_batch(addr: dict, path: str, prompts, new: int) -> list:
    """Every prompt at once, one client thread per request."""
    import threading
    out, errs = [None] * len(prompts), []

    def one(i):
        try:
            out[i] = sse_request(addr, path, prompts[i], new)
        except BaseException as e:  # noqa: BLE001 — raised below
            errs.append(e)
    threads = [threading.Thread(target=one, args=(i,))
               for i in range(len(prompts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errs:
        raise SystemExit(f"an SSE request failed: {errs[0]!r}")
    return out


def stream_checks(label, prompts, got, want, new, vocab, pending) -> None:
    """Each stream has ``new`` tokens in the vocabulary; streams of
    prompts of at most 512 tokens equal ``want``; any other difference
    joins ``pending`` for check_streams' near-tie test once a model is
    on the card again."""
    for toks in got:
        if len(toks) != new or not all(0 <= t < vocab for t in toks):
            raise SystemExit(f"{label}: bad generation: {toks}")
    for i, (p, a, b) in enumerate(zip(prompts, got, want)):
        if a != b and len(p) <= 512:
            raise SystemExit(f"{label}: stream {i} (prompt {len(p)} "
                             f"tokens) differs: {a} vs {b}")
    if got != want:
        pending.append((label, got))


def serve_llm_config():
    """The LLMConfig of run_serve's replicas and run_data_llm's engine
    actor: Llama-3-8B at full width, bf16, seed 0, the engine phase's
    slots, max_len, buckets and pool at block 16."""
    from ray_tpu_torch.serve.llm import LLMConfig
    return LLMConfig(model="llama3_8b",
                     model_overrides={"dtype": "bfloat16"},
                     max_slots=SERVE_KW["max_slots"],
                     max_len=SERVE_KW["max_len"],
                     prefill_buckets=SERVE_KW["prefill_buckets"],
                     cache_dtype="bfloat16", seed=0, kv_block_size=16,
                     kv_pool_blocks=engine_pool_blocks())


def run_serve(ref: dict, want_bytes: int, rpd: dict, card: str) -> dict:
    """Llama-3-8B at full width served through the port's serve plane on
    ``ray_tpu_torch.init(num_cpus=8)``. (a) ``build_llm_deployment``'s
    app, its replica class given three probes (``reset_counts``,
    ``counts``, ``foreign_modules``) and nothing else: run_engine's 9
    prompts at once as server-sent events through the HTTP proxy (one
    client thread each; TTFT and TPOT from the first and last ``data:``
    event on the host clock, beside the replica engine's own TTFT), again
    through the DeploymentHandle, one through ``stream_generate``, then
    the prefix-hit repeat; K1 and K4 counted in the replica's process;
    then ``serve.delete`` until the replica's process has exited and the
    card's memory is back. (b) ``build_pd_llm_deployment`` (one prefill,
    one decode replica) over the same prompts through its ingress handle;
    the decode replica's handoff bytes equal run_pd's. Streams are held
    to run_engine's at run_pd's bar; no process of the cluster loads jax,
    ml_dtypes or ray_tpu, and the controller and the proxy load no torch
    (module dumps through a sitecustomize on the workers' PYTHONPATH).
    Each app gets one short warm-up request, not counted, so its first
    drive does not pay the replica's first CUDA calls."""
    import shutil
    import tempfile

    import ray_tpu_torch
    from ray_tpu_torch import serve
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.serve.llm import (_LLMServer, build_llm_deployment,
                                         build_pd_llm_deployment,
                                         stream_generate)

    class ChipLLMServer(_LLMServer):
        """build_llm_deployment's replica, with the phase's probes."""

        def reset_counts(self):
            reset_serving_counts()

        def counts(self):
            return serving_counts(), os.getpid()

        def foreign_modules(self):
            return foreign_modules()

    prompts, new = ref["prompts"], ref["new"]
    vocab = llama.llama3_8b().vocab_size
    cfg = serve_llm_config()
    app = build_llm_deployment(cfg)
    # the same deployment and options, the probes' subclass as its class
    app.deployment._target = ChipLLMServer
    warm = [int(t) for t in
            np.random.default_rng(1).integers(0, vocab, 64)]
    get = ray_tpu_torch.get
    pending = []
    free0 = torch.cuda.mem_get_info()[0]
    tmp = tempfile.mkdtemp(prefix="chip_smoke_serve_")
    site, dumps = os.path.join(tmp, "site"), os.path.join(tmp, "modules")
    os.mkdir(site)
    os.mkdir(dumps)
    with open(os.path.join(site, "sitecustomize.py"), "w") as f:
        f.write(MODULE_DUMP)
    # init() hands its workers this process's sys.path as PYTHONPATH;
    # they read the dump directory from the environment when they start
    os.environ["CHIP_SMOKE_MODULES"] = dumps
    sys.path.insert(0, site)
    try:
        ray_tpu_torch.init(num_cpus=8)
    finally:
        sys.path.remove(site)
    try:
        # (a) the unified app
        t0 = time.monotonic()
        h = serve.run(app, name="llm", ready_timeout_s=900.0)
        up_s = time.monotonic() - t0
        get(h.generate.remote(warm, max_new_tokens=4), timeout=600)
        get(h.reset_counts.remote(), timeout=60)
        st0 = get(h.stats.remote(), timeout=60)
        addr = serve.proxy_address()
        sse = sse_batch(addr, "/LLMServer", prompts, new)
        st1 = get(h.stats.remote(), timeout=60)
        t0 = time.monotonic()
        outs = get([h.generate.remote(p, max_new_tokens=new)
                    for p in prompts], timeout=600)
        handle_wall = time.monotonic() - t0
        sg = list(stream_generate(h, prompts[0], max_new_tokens=new))
        hit = get(h.generate.remote(ref["repeat"], max_new_tokens=new),
                  timeout=600)
        counts, replica_pid = get(h.counts.remote(), timeout=60)
        replica_mods = get(h.foreign_modules.remote(), timeout=60)
        stats = get(h.stats.remote(), timeout=60)

        sse_toks = [r["tokens"] for r in sse]
        handle_toks = [o["tokens"] for o in outs]
        ttft = [r["t_first"] - r["t_sub"] for r in sse]
        tpot = [(r["t_last"] - r["t_first"]) / (len(r["tokens"]) - 1)
                for r in sse]
        wall = max(r["t_last"] for r in sse) - min(r["t_sub"] for r in sse)
        proxy = dict(ttft_p50_ms=float(np.median(ttft)) * 1e3,
                     ttft_mean_ms=float(np.mean(ttft)) * 1e3,
                     tpot_p50_ms=float(np.median(tpot)) * 1e3,
                     tok_s=sum(map(len, sse_toks)) / wall, wall_s=wall)
        eng_ttft_ms = ((st1["ttft_sum"] - st0["ttft_sum"])
                       / (st1["ttft_count"] - st0["ttft_count"]) * 1e3)
        handle_ttft = float(np.median([o["ttft_s"] for o in outs])) * 1e3
        eng = ref["latency"]
        print(f"serve app [{card}]: Llama-3-8B replica up in {up_s:.1f} s; "
              f"{len(prompts)} SSE requests through the proxy, {new} new "
              f"tokens each: TTFT p50 {proxy['ttft_p50_ms']:.1f} ms (mean "
              f"{proxy['ttft_mean_ms']:.1f}), TPOT p50 "
              f"{proxy['tpot_p50_ms']:.2f} ms, {proxy['tok_s']:.1f} "
              f"generated tok/s over {wall:.2f} s; the replica engine's own "
              f"TTFT mean over those requests {eng_ttft_ms:.1f} ms (proxy "
              f"mean - engine mean {proxy['ttft_mean_ms'] - eng_ttft_ms:.1f}"
              f" ms: proxy, router, replica and SSE hops); through the "
              f"handle {len(prompts) * new / handle_wall:.1f} tok/s over "
              f"{handle_wall:.2f} s, engine TTFT p50 {handle_ttft:.1f} ms; "
              f"engine phase of this run TTFT p50 {eng['ttft_p50_ms']:.1f} "
              f"ms, TPOT p50 {eng['tpot_p50_ms']:.2f} ms, "
              f"{eng['tok_s']:.1f} tok/s; prefix-hit repeat "
              f"{hit['prefix_hit_tokens']} tokens (engine phase "
              f"{ref['hit_tokens']}); replica launches {counts}; replica "
              f"stats {stats}")
        if min(counts["flash_attention_fwd"], counts["paged_attention"]) \
                <= 0:
            raise SystemExit(f"the replica launched no K1 or K4: {counts}")
        if replica_mods:
            raise SystemExit(f"the replica loaded {replica_mods}")
        if hit["prefix_hit_tokens"] != ref["hit_tokens"]:
            raise SystemExit("the serve app's prefix hit differs from the "
                             "engine phase's")
        if sg != handle_toks[0]:
            raise SystemExit(f"stream_generate differs from the handle: "
                             f"{sg} vs {handle_toks[0]}")
        stream_checks("serve SSE vs unified", prompts, sse_toks,
                      ref["streams"], new, vocab, pending)
        stream_checks("serve handle vs unified", prompts, handle_toks,
                      ref["streams"], new, vocab, pending)
        serve.delete("llm")
        wait_exited([replica_pid], 120.0)
        deadline = time.monotonic() + 60
        while torch.cuda.mem_get_info()[0] < free0 - (1 << 30):
            if time.monotonic() > deadline:
                raise SystemExit(
                    f"card memory not back after serve.delete: free "
                    f"{torch.cuda.mem_get_info()[0]} of {free0} before")
            time.sleep(0.5)
        print(f"serve app [{card}]: deleted; replica process {replica_pid} "
              f"exited, card free memory {torch.cuda.mem_get_info()[0]} "
              f"bytes (before the app {free0})")

        # (b) the prefill/decode app
        t0 = time.monotonic()
        hp = serve.run(build_pd_llm_deployment(cfg, num_prefill_replicas=1,
                                               num_decode_replicas=1),
                       name="pd", ready_timeout_s=900.0)
        pd_up_s = time.monotonic() - t0
        dec = serve.get_deployment_handle("LLMDecode")
        get(hp.generate.remote(warm, max_new_tokens=4), timeout=600)
        bytes0 = get(dec.stats.remote(), timeout=60)["handoff_bytes"]
        t0 = time.monotonic()
        refs = [hp.generate.remote(p, max_new_tokens=new) for p in prompts]
        done, left = {}, list(refs)
        while left:
            ready, left = ray_tpu_torch.wait(left, num_returns=1,
                                             timeout=600)
            if not ready:
                raise SystemExit("the PD app did not answer in 600 s")
            for r in ready:
                done[r] = time.monotonic()
        pd_wall = time.monotonic() - t0
        pd_outs = get(refs, timeout=60)
        pd_stats = get(dec.stats.remote(), timeout=60)
        pd_bytes = pd_stats["handoff_bytes"] - bytes0
        e2e = [done[r] - t0 for r in refs]
        dec_ttft = [o["ttft_s"] for o in pd_outs]
        upper = [(e - t) / (len(o["tokens"]) - 1)
                 for e, t, o in zip(e2e, dec_ttft, pd_outs)]
        pd_lat = dict(ttft_p50_ms=float(np.median(dec_ttft)) * 1e3,
                      e2e_p50_ms=float(np.median(e2e)) * 1e3,
                      tpot_upper_p50_ms=float(np.median(upper)) * 1e3,
                      tok_s=sum(len(o["tokens"]) for o in pd_outs)
                      / pd_wall, wall_s=pd_wall)
        rl = rpd["latency"]
        print(f"serve PD app [{card}]: prefill + decode replicas and the "
              f"ingress up in {pd_up_s:.1f} s; {len(prompts)} requests "
              f"through the ingress handle: decode replica TTFT p50 "
              f"{pd_lat['ttft_p50_ms']:.1f} ms, end to end p50 "
              f"{pd_lat['e2e_p50_ms']:.1f} ms, TPOT p50 at most "
              f"{pd_lat['tpot_upper_p50_ms']:.2f} ms ((end to end - decode "
              f"TTFT) / 31: still holds the prefill and the hops), "
              f"{pd_lat['tok_s']:.1f} generated tok/s over {pd_wall:.2f} s; "
              f"runtime PD of this run: decode TTFT p50 "
              f"{rl['ttft_p50_ms']:.1f} ms, TPOT p50 {rl['tpot_p50_ms']:.2f}"
              f" ms, {rl['tok_s']:.1f} tok/s; unified app through the "
              f"proxy TTFT p50 {proxy['ttft_p50_ms']:.1f} ms, TPOT p50 "
              f"{proxy['tpot_p50_ms']:.2f} ms; decode replica handoff bytes "
              f"{pd_bytes} (expected {want_bytes}); decode stats {pd_stats}")
        if pd_bytes != want_bytes:
            raise SystemExit("the PD app's handoff bytes are not run_pd's")
        stream_checks("serve PD vs unified", prompts,
                      [o["tokens"] for o in pd_outs], ref["streams"], new,
                      vocab, pending)
        time.sleep(2.5)     # the module dumps' next round
        procs = cluster_modules(dumps)
        roles = sorted(r for r, _, _ in procs.values() if r)
        print(f"serve [{card}]: cluster processes by role {roles}; "
              f"jax/ml_dtypes/ray_tpu modules "
              f"{sorted({m for _, b, _ in procs.values() for m in b})}")
        if not {"controller", "proxy"} <= set(roles) or \
                roles.count("replica") < 4:
            raise SystemExit(f"module dumps missing for a serve process: "
                             f"{procs}")
        for pid, (role, bad, has_torch) in procs.items():
            if bad or (role in ("controller", "proxy") and has_torch):
                raise SystemExit(f"{role} process {pid} loaded {bad}"
                                 f"{' and torch' if has_torch else ''}")
        serve.shutdown()
    finally:
        ray_tpu_torch.shutdown()
        os.environ.pop("CHIP_SMOKE_MODULES", None)
    wait_exited(sorted(procs), 120.0)
    shutil.rmtree(tmp, ignore_errors=True)
    if pending:
        # a long prompt's stream differs: hold it to a near tie against a
        # teacher-forced forward of the same weights on the card
        mcfg = llama.llama3_8b(dtype="bfloat16")
        model = llama.init_params(
            torch.Generator(device="cuda").manual_seed(0), mcfg)
        for label, got in pending:
            check_streams(model, mcfg, label, prompts, got, ref["streams"],
                          exact=[i for i, p in enumerate(prompts)
                                 if len(p) <= 512])
        del model
        gc.collect()
        torch.cuda.empty_cache()
    return dict(launches=counts, proxy=proxy, engine_ttft_mean_ms=eng_ttft_ms,
                pd=pd_lat, pd_bytes=pd_bytes, pending=len(pending))

DATA_LLM_BATCH = 16     # rows per map batch: 48 rows make 3 batches


def data_llm_rows(ref: dict) -> list:
    """run_data_llm's 48 rows: run_engine's 9 prompts, then the same 9
    again, then 30 random prompts of 16-700 tokens (numpy seed 3)."""
    rng = np.random.default_rng(3)
    vocab = 128256
    extra = [rng.integers(0, vocab, int(n)).astype(np.int32)
             for n in rng.integers(16, 701, 30)]
    prompts = [np.array(p, np.int32) for p in ref["prompts"]] * 2 + extra
    return [{"id": i, "tokens": p} for i, p in enumerate(prompts)]


def run_data_llm(ref: dict, card: str) -> dict:
    """Batch inference of Llama-3-8B at full width through the port's
    datasets on a new ``init()``: ``build_llm_processor(serve_llm_config(),
    max_new_tokens=32, concurrency=1, batch_size=16)`` over
    ``data.from_items`` of ``data_llm_rows`` (3 map batches), then
    ``take_all()``. The processor's engine actor is ``_EngineActor`` given
    three probes (``reset_counts``, ``counts``, ``check``) and nothing else,
    swapped in for the processor's build only. Checks: 48 rows in input
    order, each with 32 in-vocab tokens; each duplicated prompt generates
    alike; the 9 prompts' streams at run_pd's bar against run_engine's;
    K1 and K4 launched in the engine actor's process, which loads no jax,
    ml_dtypes or ray_tpu; after ``kill(proc.engines[0])`` the process
    exits and the card's free memory comes back. Prints the wall of
    ``take_all()``, rows/s and generated tok/s."""
    import ray_tpu_torch
    from ray_tpu_torch import data
    from ray_tpu_torch.data import llm as data_llm

    class ChipEngineActor(data_llm._EngineActor):
        """build_llm_processor's engine actor, with the phase's probes."""

        def reset_counts(self):
            reset_serving_counts()

        def counts(self):
            return serving_counts(), os.getpid(), foreign_modules()

        def check(self, prompts, got, want, exact):
            eng = self._server.engine
            return check_streams(eng.params, eng.cfg, "data.llm vs unified",
                                 prompts, got, want, exact=exact)

    prompts, new = ref["prompts"], ref["new"]
    rows = data_llm_rows(ref)
    get = ray_tpu_torch.get
    free0 = torch.cuda.mem_get_info()[0]
    ray_tpu_torch.init(num_cpus=4)
    try:
        t0 = time.monotonic()
        engine_cls = data_llm._EngineActor
        data_llm._EngineActor = ChipEngineActor
        try:
            proc = data_llm.build_llm_processor(
                serve_llm_config(), max_new_tokens=new, concurrency=1,
                batch_size=DATA_LLM_BATCH)
        finally:
            data_llm._EngineActor = engine_cls
        eng = proc.engines[0]
        get(eng.reset_counts.remote(), timeout=900)   # its model is up
        up_s = time.monotonic() - t0
        ds = proc(data.from_items(rows))
        t0 = time.monotonic()
        out = ds.take_all()
        wall = time.monotonic() - t0
        counts, pid, mods = get(eng.counts.remote(), timeout=60)
        got = [[int(t) for t in np.asarray(r["generated_tokens"])]
               for r in out]
        n9 = len(prompts)
        print(f"data.llm [{card}]: engine actor (Llama-3-8B) up in "
              f"{up_s:.1f} s; {len(rows)} rows in {len(rows) // DATA_LLM_BATCH}"
              f" map batches of {DATA_LLM_BATCH}, {new} new tokens each: "
              f"take_all() {wall:.2f} s, {len(out) / wall:.2f} rows/s, "
              f"{sum(map(len, got)) / wall:.1f} generated tok/s; engine "
              f"actor launches {counts}")
        if [r["id"] for r in out] != [r["id"] for r in rows]:
            raise SystemExit("data.llm rows are not in input order")
        for toks in got:
            if len(toks) != new or not all(0 <= t < 128256 for t in toks):
                raise SystemExit(f"data.llm: bad generation: {toks}")
        if got[:n9] != got[n9:2 * n9]:
            raise SystemExit("data.llm: a duplicated prompt generated "
                             "differently")
        if min(counts["flash_attention_fwd"], counts["paged_attention"]) \
                <= 0:
            raise SystemExit(f"the engine actor launched no K1 or K4: "
                             f"{counts}")
        if mods:
            raise SystemExit(f"the engine actor loaded {mods}")
        exact = [i for i, p in enumerate(prompts) if len(p) <= 512]
        flips = get(eng.check.remote(prompts, got[:n9], ref["streams"],
                                     exact), timeout=300)
        ray_tpu_torch.kill(eng)
        wait_exited([pid], 120.0)
        deadline = time.monotonic() + 60
        while torch.cuda.mem_get_info()[0] < free0 - (1 << 30):
            if time.monotonic() > deadline:
                raise SystemExit(
                    f"card memory not back after the engine actor's kill: "
                    f"free {torch.cuda.mem_get_info()[0]} of {free0}")
            time.sleep(0.5)
    finally:
        ray_tpu_torch.shutdown()
    print(f"data.llm [{card}]: streams at run_pd's bar, {len(flips)} "
          f"near-tie flips {[(f['stream'], f['position']) for f in flips]}; "
          f"engine actor process {pid} exited, card free memory "
          f"{torch.cuda.mem_get_info()[0]} bytes (before {free0})")
    return dict(launches=counts, wall_s=wall, rows_s=len(out) / wall,
                tok_s=sum(map(len, got)) / wall, up_s=up_s, flips=flips)


def hook_timers(timers: dict):
    """Wrap the observability hooks the engine calls (the tracing and
    device-monitor record paths, context binding, the metric updates, the
    KV accounting) to add their host seconds and calls to ``timers`` by
    name, counting only the outermost hook of a nested call; returns the
    undo."""
    import threading

    from ray_tpu_torch.llm.engine import LLMEngine
    from ray_tpu_torch.util import devmon, metrics, tracing
    depth = threading.local()
    saved = []
    for owner, name in ((tracing, "record_request_span"),
                        (tracing, "record_batch_span"),
                        (tracing, "set_request_context"),
                        (tracing, "reset_request_context"),
                        (devmon, "record_device_window"),
                        (metrics.Counter, "inc"), (metrics.Gauge, "set"),
                        (metrics.Histogram, "observe"),
                        (LLMEngine, "_kv_account")):
        real = getattr(owner, name)
        saved.append((owner, name, real))
        key = f"{getattr(owner, '__name__', owner)}.{name}".split(".")[-2:]

        def wrap(*args, _real=real, _key=".".join(key), **kw):
            outer = getattr(depth, "n", 0) == 0
            depth.n = getattr(depth, "n", 0) + 1
            t0 = time.monotonic()
            try:
                return _real(*args, **kw)
            finally:
                depth.n -= 1
                if outer:
                    rec = timers.setdefault(_key, [0, 0.0])
                    rec[0] += 1
                    rec[1] += time.monotonic() - t0
        setattr(owner, name, wrap)

    def undo():
        for owner, name, real in saved:
            setattr(owner, name, real)
    return undo


def run_hooks(model, cfg, card: str) -> dict:
    """What the observability hooks cost on the host: LLMEngine
    (SERVE_KW) serving 8 random 480-token prompts (seed 3), 65 new greedy
    tokens each (one from the prefill, then 8 blocks of 8 decode steps at
    480-544 cached tokens, 512 on average), six times: request tracing
    and the device monitor on, off, on, off, on, off. They are switched
    by the module switches ``tracing._REQ`` and ``devmon._ENABLED``; the
    metrics registry has no switch and stays on; with tracing off no
    request gets a trace context, as behind an ingress that mints none. A
    drive's decode step host wall is the mean interval between
    consecutive decode blocks' starts (``_decode_impl`` entries; all 8
    slots are active from the first block on) over the block's steps.
    Its hook seconds per decode block are the host seconds inside the
    wrapped hooks (``hook_timers``) over the drive, divided by its decode
    blocks. K1 and K4 must launch."""
    from ray_tpu_torch.llm.engine import LLMEngine
    from ray_tpu_torch.util import devmon, tracing
    rng = np.random.default_rng(3)
    prompts = [[int(t) for t in rng.integers(0, cfg.vocab_size, 480)]
               for _ in range(8)]
    new = 65
    switches = (tracing._REQ, devmon._ENABLED)
    real_decode = LLMEngine._decode_impl
    drives = []
    reset_serving_counts()
    try:
        for on in (True, False) * 3:
            tracing._REQ = devmon._ENABLED = on
            starts, timers = [], {}

            def decode_impl(self, tokens, temps, top_ps, top_ks, block):
                starts.append((time.monotonic(), block))
                return real_decode(self, tokens, temps, top_ps, top_ks,
                                   block)

            LLMEngine._decode_impl = decode_impl
            undo = hook_timers(timers)
            try:
                runs, wall, _, _ = serve(model, cfg, prompts, new)
            finally:
                undo()
                LLMEngine._decode_impl = real_decode
            step_ms = [(b[0] - a[0]) / a[1] * 1e3
                       for a, b in zip(starts, starts[1:])]
            hook_s = sum(v[1] for v in timers.values())
            drives.append(dict(
                on=on, blocks=len(starts), step_ms=float(np.mean(step_ms)),
                hook_ms_per_block=hook_s / len(starts) * 1e3,
                hooks={k: [v[0], round(v[1] * 1e3, 3)]
                       for k, v in sorted(timers.items())},
                traced=sum(o["trace_id"] is not None for o, _, _ in runs)))
            d = drives[-1]
            print(f"hooks {'on ' if on else 'off'} [{card}]: decode step "
                  f"host wall {d['step_ms']:.3f} ms (mean of "
                  f"{len(step_ms)} block intervals / 8 steps; "
                  f"{[round(x, 2) for x in step_ms]}), hooks "
                  f"{d['hook_ms_per_block']:.4f} ms per decode block "
                  f"({d['blocks']} blocks; calls and ms by hook "
                  f"{d['hooks']}), {d['traced']} requests traced; "
                  f"{latency_line(runs, wall)}")
    finally:
        tracing._REQ, devmon._ENABLED = switches
    launches = serving_counts()
    if min(launches["flash_attention_fwd"], launches["paged_attention"]) <= 0:
        raise SystemExit(f"the hooks phase launched no K1 or K4: {launches}")
    if [d["traced"] for d in drives] != [8, 0] * 3:
        raise SystemExit(f"traced requests {[d['traced'] for d in drives]}")
    on = [d["step_ms"] for d in drives if d["on"]]
    off = [d["step_ms"] for d in drives if not d["on"]]
    print(f"hooks [{card}]: decode step host wall on {on} ms, off {off} ms "
          f"(on - off {np.mean(on) - np.mean(off):+.3f} ms); hooks "
          f"{[round(d['hook_ms_per_block'], 4) for d in drives]} ms per "
          f"decode block (on, off in turns); launches {launches}")
    return dict(launches=launches, drives=drives)


def check_train_kernels(fa, gen, h: int = 32, kvh: int = 8,
                        label: str = "") -> dict:
    """K1 with lse, K2 and K3 at the training path's shapes: Llama-3-8B
    heads (32 query, 8 kv, head_dim 128) by default, bf16, batch 1; s 4096
    causal (timed), a ragged 1000 causal and 1000 non-causal (checked).
    Each kernel gets the same inputs as its plain version (K2/K3 the
    kernel forward's lse and delta). ``h``/``kvh`` set one tensor shard's
    heads (run_mesh's mesh A: 16/4 at one batch row, its shards' shape),
    ``label`` tags the printed lines."""
    b, d = 1, 128
    worst = {"fwd": [0.0, 0.0, 0.0], "dkv": [0.0, 0.0], "dq": [0.0, 0.0]}
    timed = {}
    for s_, causal in ((4096, True), (1000, True), (1000, False)):
        q, do = (torch.randn((b, s_, h, d), generator=gen, device="cuda",
                             dtype=torch.bfloat16) for _ in range(2))
        k, v = (torch.randn((b, s_, kvh, d), generator=gen, device="cuda",
                            dtype=torch.bfloat16) for _ in range(2))
        kw = dict(causal=causal)

        def k1():
            return fa.flash_attention_fwd(q, k, v, with_lse=True, **kw)

        def k1_plain():
            return fa.flash_attention_fwd_reference(q, k, v, **kw)

        (o, lse), (o_r, lse_r) = k1(), k1_plain()
        delta = fa.attention_delta(o, do)
        args = (q, k, v, do, lse, delta)

        def k2():
            return fa.flash_attention_bwd_dkv(*args, **kw)

        def k2_plain():
            return fa.flash_attention_bwd_dkv_reference(*args, **kw)

        def k3():
            return fa.flash_attention_bwd_dq(*args, **kw)

        def k3_plain():
            return fa.flash_attention_bwd_dq_reference(*args, **kw)

        (dk, dv), (dk_r, dv_r) = k2(), k2_plain()
        dk2, dv2 = k2()
        dq, dq_r = k3(), k3_plain()
        dq2 = k3()
        first = 1 if causal else 0
        torch.cuda.synchronize()
        if not (torch.equal(dk, dk2) and torch.equal(dv, dv2)):
            raise SystemExit("K2 launched twice gave different dK/dV")
        if not torch.equal(dq, dq2):
            raise SystemExit("K3 launched twice gave different dQ")
        errs = {
            "fwd": (row_rel(o, o_r), (lse - lse_r).abs().max().item(),
                    (o.float() - o_r.float()).abs().max().item()),
            "dkv": (max(row_rel(dk, dk_r), row_rel(dv, dv_r)),
                    max((dk.float() - dk_r.float()).abs().max().item(),
                        (dv.float() - dv_r.float()).abs().max().item())),
            # rows >= 1 at dQ's own floor; row 0 (causal) keeps one key
            "dq": (row_rel(dq[:, first:], dq_r[:, first:]),
                   (dq.float() - dq_r.float()).abs().max().item()),
        }
        row0 = (one_key_ulps(dq, dq_r, q, k, v, do, [0], [0]) if causal
                else 0.0)
        ok = (errs["fwd"][0] <= K1_ROW_REL_TOL
              and errs["fwd"][1] <= LSE_ABS_TOL
              and errs["dkv"][0] <= BWD_ROW_REL_TOL
              and errs["dq"][0] <= BWD_ROW_REL_TOL
              and row0 <= ONE_KEY_ULPS)
        print(f"train kernels{label} h={h} kvh={kvh} s={s_} "
              f"causal={causal}: K1+lse worst row "
              f"rel {errs['fwd'][0]:.3e} (tol {K1_ROW_REL_TOL}), lse max "
              f"abs {errs['fwd'][1]:.3e} (tol {LSE_ABS_TOL}); K2 dK/dV "
              f"worst row rel {errs['dkv'][0]:.3e}, K3 dQ worst row rel "
              f"{errs['dq'][0]:.3e} (tol {BWD_ROW_REL_TOL}"
              f"{'; rows >= 1' if causal else ''}), row 0 (one key) "
              f"{row0:.2f} ulps (tol {ONE_KEY_ULPS}); max abs dK/dV "
              f"{errs['dkv'][1]:.3e} dQ {errs['dq'][1]:.3e} (grad rms "
              f"{dq_r.float().pow(2).mean().sqrt().item():.3e}); K2 and K3 "
              f"twice bitwise equal {'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"a training kernel{label} disagrees with "
                             "its plain version")
        for name, e in errs.items():
            worst[name] = [max(a, b_) for a, b_ in zip(worst[name], e)]
        if s_ != 4096:
            continue
        f = torch.nn.functional.scaled_dot_product_attention
        qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_(True)
                      for x in (q, k, v))
        out = f(qt, kt, vt, is_causal=True, enable_gqa=True)
        dot = do.transpose(1, 2)

        def lib_fwd():
            with torch.no_grad():
                return f(qt, kt, vt, is_causal=True, enable_gqa=True)

        def lib_bwd():
            return torch.autograd.grad(out, (qt, kt, vt), dot,
                                       retain_graph=True)

        lib = lib_bwd()
        lib_err = max(rel_l2(lib[0].transpose(1, 2), dq_r),
                      rel_l2(lib[1].transpose(1, 2), dk_r))
        if lib_err > 0.1:
            raise SystemExit(f"SDPA yardstick disagrees: {lib_err}")
        w1 = fa.work(b, s_, s_, h, kvh, d, 2, with_lse=True)
        wb = fa.work_bwd(b, s_, s_, h, kvh, d, 2)
        sdpa_bwd = time_ms(lib_bwd, iters=5)
        timed["fwd"] = dict(ms=time_ms(k1, iters=5),
                            plain_ms=time_ms(k1_plain, iters=5),
                            library_ms=time_ms(lib_fwd, iters=5))
        timed["dkv"] = dict(ms=time_ms(k2, iters=5),
                            plain_ms=time_ms(k2_plain, iters=5),
                            library_ms=sdpa_bwd)
        timed["dq"] = dict(ms=time_ms(k3, iters=5),
                           plain_ms=time_ms(k3_plain, iters=5),
                           library_ms=sdpa_bwd)
        # SDPA's backward does K2's and K3's work in one call
        w_sdpa = {"flops": wb["dkv"]["flops"] + wb["dq"]["flops"]}
        for name, w in (("fwd", w1), ("dkv", wb["dkv"]), ("dq", wb["dq"])):
            bms, by = bound_ms(w)
            timed[name].update(bound_ms=bms, bound_by=by)
            t = timed[name]
            lib_w = w1 if name == "fwd" else w_sdpa
            t["tflops"] = dict(kernel=tflops(w, t["ms"]),
                               plain=tflops(w, t["plain_ms"]),
                               library=tflops(lib_w, t["library_ms"]),
                               bound=tflops(w, bms))
            tf = t["tflops"]
            print(f"train kernel{label} {name} b=1 s=4096 h={h} kvh={kvh} "
                  f"causal: kernel "
                  f"{t['ms']:.4f} ms ({tf['kernel']:.1f} TF/s), plain "
                  f"{t['plain_ms']:.4f} ms ({tf['plain']:.1f} TF/s), SDPA "
                  f"{t['library_ms']:.4f} ms ({tf['library']:.1f} TF/s"
                  f"{'' if name == 'fwd' else ' over dQ, dK and dV'}), "
                  f"bound {bms:.4f} ms ({by}, {tf['bound']:.1f} TF/s)")
        print(f"  SDPA backward (dQ, dK, dV together) {sdpa_bwd:.4f} ms vs "
              f"K2 + K3 {timed['dkv']['ms'] + timed['dq']['ms']:.4f} ms; "
              f"SDPA vs plain dQ/dK relative L2 {lib_err:.3e}")
        del out, lib, qt, kt, vt
    out = {name: dict(max_abs_err=worst[name][-1],
                      max_row_rel_err=worst[name][0], **timed[name])
           for name in worst}
    out["fwd"]["lse_max_abs_err"] = worst["fwd"][1]
    return out


def check_train_parity(fa, card: str) -> None:
    """Llama-3-8B at full width cut to 2 layers (bf16, random weights
    from seed 1), batch 2 x 1024: one loss_fn + backward through the
    kernels and one through plain attention (attn_impl="reference") on
    the same weights and batch."""
    from ray_tpu_torch.models import llama
    cfg = llama.llama3_8b(n_layers=2, dtype="bfloat16")
    model = llama.init_params(torch.Generator(device="cuda").manual_seed(1),
                              cfg, trainable=True)
    toks = torch.tensor(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 1025)), device="cuda")
    batch = {"tokens": toks[:, :-1].contiguous(),
             "targets": toks[:, 1:].contiguous()}
    names = [n for n, _ in model.named_parameters()]
    runs = {}
    for impl in ("auto", "reference"):
        model.zero_grad(set_to_none=True)
        before = fa.flash_attention_bwd_dq.launches
        loss = llama.loss_fn(model, batch,
                             dataclasses.replace(cfg, attn_impl=impl))
        loss.backward()
        grads = [p.grad.detach().clone() for p in model.parameters()]
        runs[impl] = (loss.item(), grads,
                      fa.flash_attention_bwd_dq.launches - before)
    (lk, gk, nk), (lr, gr, nr) = runs["auto"], runs["reference"]
    if (nk, nr) != (cfg.n_layers, 0):
        raise SystemExit(f"K3 launches kernel/plain runs: {nk}/{nr}")
    norm_k = torch.sqrt(sum(g.float().pow(2).sum() for g in gk)).item()
    norm_r = torch.sqrt(sum(g.float().pow(2).sum() for g in gr)).item()
    cos = {n: torch.nn.functional.cosine_similarity(
        a.float().flatten(), b.float().flatten(), dim=0).item()
        for n, a, b in zip(names, gk, gr)}
    worst = min(cos, key=cos.get)
    loss_rel = abs(lk - lr) / abs(lr)
    norm_rel = abs(norm_k - norm_r) / norm_r
    ok = (np.isfinite(lk) and loss_rel <= TRAIN_LOSS_REL_TOL
          and norm_rel <= TRAIN_GNORM_REL_TOL
          and cos[worst] >= TRAIN_GRAD_COS_MIN)
    print(f"2-layer model [{card}], kernels vs plain attention: loss "
          f"{lk:.6f} vs {lr:.6f} (rel {loss_rel:.2e}, tol "
          f"{TRAIN_LOSS_REL_TOL}), grad norm {norm_k:.5f} vs {norm_r:.5f} "
          f"(rel {norm_rel:.2e}, tol {TRAIN_GNORM_REL_TOL}), worst "
          f"per-tensor grad cosine {cos[worst]:.6f} ({worst}; min "
          f"{TRAIN_GRAD_COS_MIN}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("the model's loss or gradients through the "
                         "kernels disagree with plain attention")


def _kernel_kind(name: str) -> str:
    low = name.lower()
    for key, kind in (("flash_fwd_kernel", "K1"), ("flash_dkv_kernel", "K2"),
                      ("flash_dq_kernel", "K3")):
        if key in low:
            return kind
    if any(t in low for t in ("gemm", "nvjet", "xmma", "cutlass")):
        return "GEMM"
    return "other"


TRAIN_POLICIES = ("full", "attn", "dots")
# Step 1 of the 8-layer train step under each remat policy, from the same
# weights and batch: the forward is the same ops on the same values, and
# a recompute (or a saved output) gives the backward the same values, so
# the loss and grad norm are expected bit for bit equal (printed). A
# policy that dropped or doubled a layer's gradient moves the grad norm
# by percents; the bounds allow only the f32 reordering of a sum.
POLICY_LOSS_REL_TOL = 1e-6
POLICY_GNORM_REL_TOL = 1e-5


def sync_cards() -> None:
    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)


class TrainLoop:
    """Steps of one train state on one batch: each step's host wall
    around a sync of every card, its loss and grad norm."""

    def __init__(self, state, step_fn, batch):
        self.state, self.step_fn, self.batch = state, step_fn, batch
        self.losses, self.norms, self.walls = [], [], []

    def step(self) -> None:
        sync_cards()
        t = time.monotonic()
        self.state, m = self.step_fn(self.state, self.batch)
        self.losses.append(m["loss"].item())
        self.norms.append(m["grad_norm"].item())
        sync_cards()
        self.walls.append(time.monotonic() - t)


def train_batch(cfg, b: int, s: int) -> dict:
    """The training phases' batch: b x s random tokens from seed 0,
    targets shifted by one, on the card."""
    toks = torch.tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (b, s + 1)), device="cuda")
    return {"tokens": toks[:, :-1].contiguous(),
            "targets": toks[:, 1:].contiguous()}


def reset_train_counts(fa) -> None:
    fa.flash_attention_fwd.launches = 0
    fa.flash_attention_fwd.lse_launches = 0
    fa.flash_attention_bwd_dkv.launches = 0
    fa.flash_attention_bwd_dq.launches = 0


def train_counts(fa) -> dict:
    return {"flash_attention_fwd": fa.flash_attention_fwd.launches,
            "flash_attention_fwd_lse": fa.flash_attention_fwd.lse_launches,
            "flash_attention_bwd_dkv": fa.flash_attention_bwd_dkv.launches,
            "flash_attention_bwd_dq": fa.flash_attention_bwd_dq.launches}


def ops_per_step(loop: TrainLoop) -> int:
    """The ops one more step of ``loop`` dispatches (every aten call the
    host issues, counted by a dispatch mode): the host's work a step."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            Count.n += 1
            return func(*args, **(kwargs or {}))

    with Count():
        loop.step()
    return Count.n


def trace_train(loop: TrainLoop, label: str, card: str) -> dict:
    """One more step of ``loop`` under the profiler: device busy time
    by kernel kind (over every card), the busiest card's idle share of
    the step's host wall, each attention kernel's time per launch and the
    top kernels; then the ops one more step dispatches
    (``ops_per_step``)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        loop.step()
    kinds, names, cards = {}, {}, {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            ms = e.time_range.elapsed_us() / 1e3
            kind = _kernel_kind(e.name)
            kinds[kind] = kinds.get(kind, 0.0) + ms
            t, c = names.get(e.name, (0.0, 0))
            names[e.name] = (t + ms, c + 1)
            cards[e.device_index] = cards.get(e.device_index, 0.0) + ms
    busy = max(cards.values(), default=0.0)
    wall_ms = loop.walls[-1] * 1e3
    idle = f"{1 - busy / wall_ms:.3f}" if busy else "not measured"
    per_launch = {k: names[n][0] / names[n][1] for n in names
                  for k in ("K1", "K2", "K3") if _kernel_kind(n) == k}
    top = sorted(names.items(), key=lambda kv: -kv[1][0])[:8]
    n_ops = ops_per_step(loop)
    per_card = ("" if len(cards) < 2 else " (per card: " + ", ".join(
        f"cuda:{i} {v:.1f}" for i, v in sorted(cards.items())) + ")")
    print(f"train step traced [{label}] [{card}]: host wall {wall_ms:.1f} "
          f"ms, device busy {busy:.1f} ms{per_card}, device idle share "
          f"{idle}; "
          f"{n_ops} ops dispatched by the next step; by "
          f"kind (ms): "
          + "; ".join(f"{k} {v:.1f}" for k, v in
                      sorted(kinds.items(), key=lambda kv: -kv[1]))
          + "; per launch (ms): "
          + "; ".join(f"{k} {v:.3f}" for k, v in sorted(per_launch.items()))
          + "; top kernels (ms, count): "
          + "; ".join(f"{k[:50]} {v[0]:.1f} x{v[1]}" for k, v in top))
    return {"kinds_ms": kinds, "per_launch_ms": per_launch,
            "busy_ms": busy, "wall_ms": wall_ms, "idle": idle,
            "ops": n_ops}


def train_policy(fa, card: str, policy: str) -> dict:
    """make_train_step on Llama-3-8B at its published widths (dim 4096,
    32/8 heads, ffn 14336, vocab 128256, rope 5e5) cut to 8 layers, bf16,
    remat ``policy``, f32 logits, no CE chunking; random weights from
    seed 0; one batch of 2 x 4096 random tokens (targets shifted by one);
    default_optimizer(3e-4, warmup 2, total 100). 2 warm-up steps, then 5
    timed steps whose launch counts must be K1 (all with lse) = 2 * 8 * 5
    under "full" and 8 * 5 under "attn" and "dots", K2 = K3 = 8 * 5; the
    peak memory of the timed steps; then one step traced."""
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.parallel import default_optimizer, make_train_step
    from ray_tpu_torch.parallel.mesh import global_norm

    cfg = llama.llama3_8b(n_layers=8, dtype="bfloat16", remat_policy=policy,
                          logits_dtype="float32", ce_chunk=0)
    b, s, steps = 2, 4096, 5
    opt = default_optimizer(learning_rate=3e-4, warmup_steps=2,
                            total_steps=100)
    init_fn, step_fn = make_train_step(cfg, optimizer=opt)
    t0 = time.monotonic()
    state = init_fn(torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    print(f"train [{policy}] [{card}]: llama3_8b widths, {cfg.n_layers} layers, "
          f"{cfg.num_params() / 1e9:.3f}B params, bf16, random weights "
          f"(seed 0) and AdamW state in {time.monotonic() - t0:.1f} s")
    loop = TrainLoop(state, step_fn, train_batch(cfg, b, s))
    del state
    for _ in range(2):
        loop.step()
    reset_train_counts(fa)
    torch.cuda.reset_peak_memory_stats()
    for _ in range(steps):
        loop.step()
    launches = train_counts(fa)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    losses, norms, walls = loop.losses, loop.norms, loop.walls
    n = cfg.n_layers * steps
    k1 = (2 if policy == "full" else 1) * n
    want = {"flash_attention_fwd": k1, "flash_attention_fwd_lse": k1,
            "flash_attention_bwd_dkv": n, "flash_attention_bwd_dq": n}
    per_step = "/".join(str(launches[k] // steps) for k in (
        "flash_attention_fwd_lse", "flash_attention_bwd_dkv",
        "flash_attention_bwd_dq"))
    print(f"train [{policy}] [{card}] losses {['%.5f' % x for x in losses]}, grad "
          f"norms {['%.4f' % x for x in norms]}; launches over the {steps} "
          f"timed steps {launches}, K1 (with lse)/K2/K3 per step {per_step}")
    if not all(np.isfinite(losses)) or not all(np.isfinite(norms)):
        raise SystemExit("a training loss or grad norm is not finite")
    if not losses[-1] < losses[1]:
        raise SystemExit(f"the loss did not fall: {losses}")
    if launches != want:
        raise SystemExit(f"launch counts {launches}, expected {want}")
    step_s = float(np.median(walls[2:]))
    tok_s = b * s / step_s
    mfu = tok_s * cfg.flops_per_token(s) / PEAK_BF16_FLOPS
    print(f"train step [{policy}] [{card}]: host wall median "
          f"{step_s * 1e3:.1f} ms (steps "
          f"{', '.join('%.1f' % (w * 1e3) for w in walls[2:])} ms), "
          f"{tok_s:.1f} tok/s, MFU {mfu:.4f} (flops_per_token(4096) "
          f"{cfg.flops_per_token(s):.4e} / 989 TF/s), peak memory "
          f"{peak_gb:.2f} GB (max_memory_allocated over the timed steps)")
    traced = trace_train(loop, policy, card)

    if policy == "full":
        params = list(loop.state.params.parameters())
        grads = [p.grad for p in params]

        def update():
            opt.update(loop.state.opt_state, params, grads,
                       global_norm(grads))

        print(f"optimizer update alone [{card}] (global norm, clip, AdamW over "
              f"{len(params)} tensors): {time_ms(update, iters=3):.1f} ms")
        del params, grads
    del loop
    gc.collect()
    torch.cuda.empty_cache()
    return {"launches": launches, "per_launch_ms": traced["per_launch_ms"],
            "step1": (losses[0], norms[0]), "losses": losses,
            "norms": norms, "step_ms": step_s * 1e3, "tok_s": tok_s,
            "mfu": mfu, "peak_gb": peak_gb, "kinds_ms": traced["kinds_ms"],
            "busy_ms": traced["busy_ms"], "idle": traced["idle"],
            "ops": traced["ops"]}


def run_train(fa, card: str) -> dict:
    """train_policy under "full", "attn" and "dots" from the same weights
    and batch, and step 1's loss and grad norm held equal across them
    (POLICY_*_REL_TOL; whether bitwise is printed)."""
    runs = {p: train_policy(fa, card, p) for p in TRAIN_POLICIES}
    loss0, norm0 = runs["full"]["step1"]
    for policy in TRAIN_POLICIES[1:]:
        loss, norm = runs[policy]["step1"]
        dl, dn = abs(loss - loss0) / abs(loss0), abs(norm - norm0) / norm0
        ok = dl <= POLICY_LOSS_REL_TOL and dn <= POLICY_GNORM_REL_TOL
        print(f"train step 1 [{policy}] vs [full] [{card}]: loss {loss!r} vs "
              f"{loss0!r} (rel {dl:.2e}, tol {POLICY_LOSS_REL_TOL}), grad "
              f"norm {norm!r} vs {norm0!r} (rel {dn:.2e}, tol "
              f"{POLICY_GNORM_REL_TOL}); bitwise "
              f"{loss == loss0 and norm == norm0} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"remat policy {policy!r} changed step 1")
    print(f"train policies [{card}] (policy: step ms, tok/s, MFU, peak GB, "
          f"K1/K2/K3 per step): " + "; ".join(
              f"{p}: {r['step_ms']:.1f}, {r['tok_s']:.1f}, {r['mfu']:.4f}, "
              f"{r['peak_gb']:.2f}, "
              + "/".join(str(r["launches"][k] // 5) for k in (
                  "flash_attention_fwd_lse", "flash_attention_bwd_dkv",
                  "flash_attention_bwd_dq"))
              for p, r in runs.items()))
    return runs


# The mesh phase (run_mesh): run_train's 8-layer "dots" step over two
# meshes of four shards, all on the one card (a repeated device stands in
# for four cards, with the real per-shard shapes and launches): mesh A
# splits the batch rows and the weights' width over fsdp and heads, ffn
# and vocab over tensor; mesh B splits heads over tensor and the sequence
# over context, where attention is the plain ring (no kernel). Each from
# run_train's weights and batch, its first MESH_PARITY_STEPS losses and
# grad norms held to the single-device "dots" run's at TRAIN_LOSS_REL_TOL
# and TRAIN_GNORM_REL_TOL: bf16 partial sums over the tensor shards (and
# the ring's f32 attention against K1-K3's bf16 rounding) move the loss by
# ~1e-4 and the grad norm by ~1e-3, as kernels against plain attention do
# (check_train_parity); a dropped shard or a doubled sum moves them by
# percents.
MESHES = {"A": dict(data=1, fsdp=2, tensor=2, context=1),
          "B": dict(data=1, fsdp=1, tensor=2, context=2)}
MESH_PARITY_STEPS = 3


def mesh_step(fa, card: str, name: str, single: dict,
              devices=("cuda:0",) * 4) -> dict:
    """make_train_step(cfg, mesh) on mesh ``name`` over ``devices``:
    the shards drawn from seed 0 (the same weights as run_train's), 2
    warm-up and 5 timed steps on run_train's batch with K1 (with lse), K2
    and K3 counted (mesh A: each 4 shards x 8 layers a step; mesh B: 0),
    the peak memory of the timed steps, one step traced; the first steps'
    losses and grad norms held to ``single``'s."""
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.parallel import (MeshSpec, default_optimizer,
                                        make_mesh, make_train_step)

    cfg = llama.llama3_8b(n_layers=8, dtype="bfloat16", remat_policy="dots",
                          logits_dtype="float32", ce_chunk=0)
    b, s, steps = 2, 4096, 5
    mesh = make_mesh(MeshSpec(**MESHES[name]), devices=devices)
    name = name if len(set(devices)) == 1 else f"{name} on {len(devices)} cards"
    init_fn, step_fn = make_train_step(
        cfg, mesh, optimizer=default_optimizer(
            learning_rate=3e-4, warmup_steps=2, total_steps=100))
    t0 = time.monotonic()
    state = init_fn(torch.Generator(device="cuda").manual_seed(0))
    sync_cards()
    shard_gb = sorted({sum(p.numel() * p.element_size()
                           for p in blk.parameters()) / 1e9
                       for blk in state.params.blocks})
    print(f"train mesh {name} [{card}]: {mesh.shape} on "
          f"{[str(d) for d in mesh.devices]}, "
          f"{cfg.n_layers} layers, drawn and sharded in "
          f"{time.monotonic() - t0:.1f} s; (fsdp, tensor) blocks of "
          f"{shard_gb} GB each")
    loop = TrainLoop(state, step_fn, train_batch(cfg, b, s))
    del state
    for _ in range(2):
        loop.step()
    reset_train_counts(fa)
    for d in set(mesh.devices):
        torch.cuda.reset_peak_memory_stats(d)
    for _ in range(steps):
        loop.step()
    launches = train_counts(fa)
    peak_gb = max(torch.cuda.max_memory_allocated(d)
                  for d in set(mesh.devices)) / 1e9
    shards = 4 if mesh.shape["context"] == 1 else 0
    n = shards * cfg.n_layers * steps
    want = {"flash_attention_fwd": n, "flash_attention_fwd_lse": n,
            "flash_attention_bwd_dkv": n, "flash_attention_bwd_dq": n}
    per_step = "/".join(str(launches[k] // steps) for k in (
        "flash_attention_fwd_lse", "flash_attention_bwd_dkv",
        "flash_attention_bwd_dq"))
    k = MESH_PARITY_STEPS
    loss_rel = max(abs(a - w) / abs(w) for a, w in
                   zip(loop.losses[:k], single["losses"][:k]))
    norm_rel = max(abs(a - w) / abs(w) for a, w in
                   zip(loop.norms[:k], single["norms"][:k]))
    ok = (all(np.isfinite(loop.losses)) and all(np.isfinite(loop.norms))
          and loss_rel <= TRAIN_LOSS_REL_TOL
          and norm_rel <= TRAIN_GNORM_REL_TOL and launches == want)
    print(f"train mesh {name} [{card}] losses "
          f"{['%.5f' % x for x in loop.losses]} (single device "
          f"{['%.5f' % x for x in single['losses'][:k]]}), grad norms "
          f"{['%.4f' % x for x in loop.norms]} (single "
          f"{['%.4f' % x for x in single['norms'][:k]]}); steps 1-{k} worst "
          f"rel loss {loss_rel:.2e} (tol {TRAIN_LOSS_REL_TOL}), grad norm "
          f"{norm_rel:.2e} (tol {TRAIN_GNORM_REL_TOL}); launches over the "
          f"{steps} timed steps {launches}, K1 (with lse)/K2/K3 per step "
          f"{per_step} (want {n // steps} each) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit(f"mesh {name}'s train step disagrees with the "
                         "single-device step or its launch counts")
    step_s = float(np.median(loop.walls[2:]))
    tok_s = b * s / step_s
    traced = trace_train(loop, f"mesh {name}", card)
    print(f"train step mesh {name} [{card}]: host wall median "
          f"{step_s * 1e3:.1f} ms (steps "
          f"{', '.join('%.1f' % (w * 1e3) for w in loop.walls[2:7])} ms), "
          f"{tok_s:.1f} tok/s, peak memory {peak_gb:.2f} GB (the fullest "
          f"card); single-device "
          f"\"dots\" in this run: {single['step_ms']:.1f} ms, "
          f"{single['tok_s']:.1f} tok/s, {single['peak_gb']:.2f} GB, busy "
          f"{single['busy_ms']:.1f} ms, idle {single['idle']}")
    del loop
    gc.collect()
    torch.cuda.empty_cache()
    return {"launches": launches, "step_ms": step_s * 1e3, "tok_s": tok_s,
            "peak_gb": peak_gb, "busy_ms": traced["busy_ms"],
            "idle": traced["idle"], "kinds_ms": traced["kinds_ms"],
            "ops": traced["ops"], "loss_rel": loss_rel,
            "norm_rel": norm_rel}


def run_mesh(fa, card: str, single: dict) -> dict:
    """mesh_step over mesh A and mesh B, beside run_train's "dots" run
    (``single``), and a table of them; where four cards are visible,
    mesh A also with each shard on its own card ("A4": every collective a
    copy between cards)."""
    runs = {name: mesh_step(fa, card, name, single) for name in MESHES}
    if torch.cuda.device_count() >= 4:
        runs["A4"] = mesh_step(fa, card, "A", single,
                               devices=[f"cuda:{i}" for i in range(4)])
    print(f"train meshes [{card}] (step ms, tok/s, peak GB, device busy ms, "
          f"idle share traced, ops a step, K1/K2/K3 a step): single dots: "
          f"{single['step_ms']:.1f}, {single['tok_s']:.1f}, "
          f"{single['peak_gb']:.2f}, {single['busy_ms']:.1f}, "
          f"{single['idle']}, {single['ops']}, 8/8/8; " + "; ".join(
              f"mesh {n} {MESHES[n[0]]}: {r['step_ms']:.1f}, "
              f"{r['tok_s']:.1f}, "
              f"{r['peak_gb']:.2f}, {r['busy_ms']:.1f}, {r['idle']}, "
              f"{r['ops']}, "
              + "/".join(str(r["launches"][k] // 5) for k in (
                  "flash_attention_fwd_lse", "flash_attention_bwd_dkv",
                  "flash_attention_bwd_dq"))
              for n, r in runs.items()))
    return runs


# The MoE phase (run_moe): the MoE family (models/moe.py) at Mixtral-8x7B's
# published widths (dim 4096, 32/8 heads, 8 experts of ffn 14336, top 2,
# capacity factor 1.25, vocab 32000) cut in depth: 32 layers are 47 B
# parameters, 94 GB in bf16 alone. A: 4 layers (6.07 B parameters; with
# their gradients and AdamW's two moments ~49 GB) on one device under
# "full", b 1 x s 4096. B: 2 layers over the expert mesh (fsdp 2, expert
# 2) of four shards on the one card, b 2 x s 4096, against the same two
# layers on one device. Step 1 of A with K1-K3 against the same step with
# the plain attention (check_train_parity's tolerances: kernels against
# plain move the loss by ~1e-4, the grad norm by ~1e-3); B's first
# MESH_PARITY_STEPS steps against one device's at the same tolerances
# (the expert partials in bf16 are summed over the expert shards in
# another order).
MOE_LAYERS = 4
MOE_MESH_LAYERS = 2
MOE_MESH = dict(data=1, fsdp=2, tensor=1, context=1, expert=2)


def moe_cfg(n_layers: int, attn_impl: str = "auto"):
    from ray_tpu_torch.models import moe
    return moe.mixtral_8x7b(n_layers=n_layers, dtype="bfloat16",
                            remat_policy="full", logits_dtype="float32",
                            attn_impl=attn_impl)


def moe_optimizer():
    from ray_tpu_torch.parallel import default_optimizer
    return default_optimizer(learning_rate=3e-4, warmup_steps=2,
                             total_steps=100)


def moe_executed_flops(cfg, b: int, s: int) -> float:
    """The FLOPs one "full"-remat step of ``cfg`` executes on b x s
    tokens, by my count: each layer's forward runs twice (the step's and
    the recompute's) and each matmul's backward is twice its forward; the
    matmuls are the projections, the router, the dispatch and combine
    einsums over all E x C capacity slots and the experts' three products
    over those slots; causal attention's forward is 2 b h s^2 hd (two
    products over half the pairs) and K2 + K3 3.5 times it; the lm_head
    runs once forward and its backward."""
    d, f, E = cfg.dim, cfg.ffn_dim, cfg.n_experts
    h, kvh, hd, C = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, \
        cfg.capacity(s)
    proj = 2 * b * s * (2 * d * h * hd + 2 * d * kvh * hd)
    route = 2 * b * s * d * E
    disp = 2 * 2 * b * s * E * C * d
    experts = 3 * 2 * b * E * C * d * f
    attn = 2 * b * h * s * s * hd
    layer = 4 * (proj + route + disp + experts) + 5.5 * attn
    return cfg.n_layers * layer + 3 * 2 * b * s * d * cfg.vocab_size


@torch.no_grad()
def moe_drops(model, cfg, batch) -> tuple:
    """A walk of ``model``'s layers on ``batch``'s tokens without grad:
    per layer the share of the top-k assignments that the capacity
    dropped, and the forward's aux loss (the sum over layers)."""
    from ray_tpu_torch.models import llama, moe
    toks = batch["tokens"]
    b, s = toks.shape
    x = model.embed(toks)
    pos = torch.arange(s, dtype=torch.int32, device=toks.device)[None]
    rc, rs = llama._rope_tables(pos.expand(b, s), cfg.head_dim,
                                cfg.rope_theta)
    drops, aux = [], 0.0
    for lyr in model.layers:
        x = llama._attn_block(lyr, x, rc, rs, cfg, cfg.attn_impl)
        y = llama._rmsnorm(x, lyr.mlp_norm, cfg.norm_eps)
        dispatch, _, a = moe._route(y, lyr.router, cfg)
        drops.append(1.0 - dispatch.sum().item()
                     / (b * s * cfg.experts_per_token))
        aux += a.item()
        del dispatch
        x = x + moe._moe_block(y, lyr, cfg)[0]
    return drops, aux


RANGES = ("moe_routing", "optimizer")    # trace_moe's profiler ranges


class _Ranged:
    """A module function wrapped in a profiler range named ``label``
    (the ranges of the traced MoE step's kinds)."""

    def __init__(self, fn, label: str):
        self.fn, self.label = fn, label

    def __call__(self, *args, **kw):
        from torch.profiler import record_function
        with record_function(self.label):
            return self.fn(*args, **kw)


def _moe_kind(ev, e_local: int) -> str:
    """The kind of the work of CPU op ``ev`` (which launched kernels):
    the expert products are batched over the experts (``aten.bmm`` with
    batch e_local), the dispatch and combine einsums over the rows;
    other matmuls are GEMMs; under the ranges ``moe_routing`` and
    ``optimizer`` (``_Ranged``) the routing's passes and the update."""
    chain, p = [], ev
    while p is not None:
        chain.append(p.name)
        p = p.cpu_parent
    if "optimizer" in chain:
        return "optimizer"
    if ev.name in ("aten::bmm", "aten::baddbmm"):
        shapes = ev.input_shapes or [[]]
        batch = shapes[0][0] if shapes and shapes[0] else None
        return "expert bmm" if batch == e_local else "dispatch/combine"
    if ev.name in ("aten::mm", "aten::addmm", "aten::matmul",
                   "aten::linear"):
        return "other GEMM"
    if "moe_routing" in chain:
        return "routing"
    return "other"


def trace_moe(loop: TrainLoop, card: str, e_local: int) -> dict:
    """One more step of ``loop`` under the profiler with shapes: device
    busy and idle share, and ms by kind: K1-K3 (by kernel name), the
    expert bmms, the dispatch and combine einsums, other GEMMs, the
    routing's passes (its forward and recompute, under a range; their
    backward counts as other), the optimizer's update (under a range)
    and the rest."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        loop.step()
    kinds, ops, busy = {}, {}, 0.0
    for e in prof.events():
        # the ranges' own spans on the device timeline are not kernels
        if e.device_type == DeviceType.CUDA and e.name not in RANGES:
            busy += e.time_range.elapsed_us() / 1e3
    for ev in prof.events():
        if ev.device_type != DeviceType.CPU or not ev.kernels:
            continue
        for kern in ev.kernels:
            kind = _kernel_kind(kern.name)
            if kind not in ("K1", "K2", "K3"):
                kind = _moe_kind(ev, e_local)
            kinds[kind] = kinds.get(kind, 0.0) + kern.duration / 1e3
            at = (kind, ev.name, str(ev.input_shapes)[:60])
            t, c = ops.get(at, (0.0, 0))
            ops[at] = (t + kern.duration / 1e3, c + 1)
    wall_ms = loop.walls[-1] * 1e3
    idle = f"{1 - busy / wall_ms:.3f}" if busy else "not measured"
    linked = sum(kinds.values())
    top = sorted(ops.items(), key=lambda kv: -kv[1][0])[:12]
    print(f"moe step traced [A] [{card}]: host wall {wall_ms:.1f} ms, "
          f"device busy {busy:.1f} ms, device idle share {idle}; by kind "
          f"(ms; {linked:.1f} ms of kernels linked to their ops): "
          + "; ".join(f"{k} {v:.1f}" for k, v in
                      sorted(kinds.items(), key=lambda kv: -kv[1]))
          + "; top ops (kind, op, input shapes: ms, kernels): "
          + "; ".join(f"{k[0]}, {k[1]}, {k[2]}: {v[0]:.1f} x{v[1]}"
                      for k, v in top))
    return {"kinds_ms": kinds, "busy_ms": busy, "wall_ms": wall_ms,
            "idle": idle}


class _RangedAdamW:
    """The step's optimizer with its update under the ``optimizer``
    profiler range (``trace_moe``)."""

    def __init__(self, opt):
        self.opt = opt

    def init(self, params):
        return self.opt.init(params)

    def update(self, *args):
        from torch.profiler import record_function
        with record_function("optimizer"):
            return self.opt.update(*args)


def moe_single(fa, card: str) -> dict:
    """A: make_train_step(cfg, model=moe) at MOE_LAYERS layers on the
    card from seed 0, b 1 x s 4096 (train_batch): first step 1's loss
    and grad norm with attn_impl="reference" on the same weights and
    batch (the gradients then cleared), then 2 warm-up and 3 timed steps
    with K1 (all with lse) 2L, K2 and K3 L a step; the drop shares and
    aux loss of a no_grad walk; one step traced by kind."""
    from ray_tpu_torch.models import moe
    from ray_tpu_torch.parallel import make_train_step
    from ray_tpu_torch.parallel.mesh import global_norm

    cfg = moe_cfg(MOE_LAYERS)
    b, s, steps = 1, 4096, 3
    init_fn, step_fn = make_train_step(cfg, model=moe,
                                       optimizer=_RangedAdamW(moe_optimizer()))
    t0 = time.monotonic()
    state = init_fn(torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    print(f"moe [A] [{card}]: mixtral_8x7b widths, {cfg.n_layers} layers, "
          f"{cfg.num_params() / 1e9:.3f}B params "
          f"({cfg.num_active_params() / 1e9:.3f}B active), bf16 (router "
          f"f32), capacity {cfg.capacity(s)} per expert, random weights "
          f"(seed 0) and AdamW state in {time.monotonic() - t0:.1f} s")
    batch = train_batch(cfg, b, s)
    drops0, aux0 = moe_drops(state.params, cfg, batch)
    print(f"moe [A] [{card}] at the drawn weights: aux loss {aux0:.5f} "
          f"(k = {cfg.experts_per_token} per layer at uniform load), "
          f"dropped share of top-k assignments per layer "
          f"{['%.4f' % d for d in drops0]}")
    params = list(state.params.parameters())
    reset_train_counts(fa)
    loss = moe.loss_fn(state.params, batch, moe_cfg(MOE_LAYERS,
                                                    "reference"))
    loss.backward()
    plain = (loss.item(), global_norm([p.grad for p in params]).item())
    if any(train_counts(fa).values()):
        raise SystemExit("the plain-attention step launched a kernel")
    for p in params:
        p.grad = None
    del loss, params
    loop = TrainLoop(state, step_fn, batch)
    del state
    for _ in range(2):
        loop.step()
    dl = abs(loop.losses[0] - plain[0]) / abs(plain[0])
    dn = abs(loop.norms[0] - plain[1]) / plain[1]
    ok = dl <= TRAIN_LOSS_REL_TOL and dn <= TRAIN_GNORM_REL_TOL
    print(f"moe step 1 [A] kernels vs plain attention [{card}]: loss "
          f"{loop.losses[0]!r} vs {plain[0]!r} (rel {dl:.2e}, tol "
          f"{TRAIN_LOSS_REL_TOL}), grad norm {loop.norms[0]!r} vs "
          f"{plain[1]!r} (rel {dn:.2e}, tol {TRAIN_GNORM_REL_TOL}) "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("the MoE step with the kernels disagrees with "
                         "plain attention")
    reset_train_counts(fa)
    torch.cuda.reset_peak_memory_stats()
    for _ in range(steps):
        loop.step()
    launches = train_counts(fa)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    n = cfg.n_layers * steps
    want = {"flash_attention_fwd": 2 * n, "flash_attention_fwd_lse": 2 * n,
            "flash_attention_bwd_dkv": n, "flash_attention_bwd_dq": n}
    per_step = "/".join(str(launches[k] // steps) for k in (
        "flash_attention_fwd_lse", "flash_attention_bwd_dkv",
        "flash_attention_bwd_dq"))
    losses, norms = loop.losses, loop.norms
    print(f"moe [A] [{card}] losses {['%.5f' % x for x in losses]}, grad "
          f"norms {['%.4f' % x for x in norms]}; launches over the {steps} "
          f"timed steps {launches}, K1 (with lse)/K2/K3 per step "
          f"{per_step} (want {2 * cfg.n_layers}/{cfg.n_layers}/"
          f"{cfg.n_layers})")
    if not all(np.isfinite(losses)) or not all(np.isfinite(norms)):
        raise SystemExit("a MoE loss or grad norm is not finite")
    if not losses[-1] < losses[1]:
        raise SystemExit(f"the MoE loss did not fall: {losses}")
    if launches != want:
        raise SystemExit(f"MoE launch counts {launches}, expected {want}")
    step_s = float(np.median(loop.walls[2:]))
    tok_s = b * s / step_s
    mfu = tok_s * cfg.flops_per_token(s) / PEAK_BF16_FLOPS
    executed = moe_executed_flops(cfg, b, s)
    drops, aux = moe_drops(loop.state.params, cfg, batch)
    print(f"moe step [A] [{card}]: host wall median {step_s * 1e3:.1f} ms "
          f"(steps {', '.join('%.1f' % (w * 1e3) for w in loop.walls[2:])}"
          f" ms), {tok_s:.1f} tok/s, MFU {mfu:.4f} (flops_per_token(4096) "
          f"{cfg.flops_per_token(s):.4e}, active parameters only, / 989 "
          f"TF/s), executed {executed / 1e12:.1f} TF a step = "
          f"{executed / step_s / 1e12:.1f} TF/s (moe_executed_flops), peak "
          f"memory {peak_gb:.2f} GB; after the last step: aux loss "
          f"{aux:.5f}, dropped share of top-k "
          f"assignments per layer {['%.4f' % d for d in drops]}")
    moe._routing = _Ranged(moe._routing, "moe_routing")
    try:
        traced = trace_moe(loop, card, cfg.n_experts)
    finally:
        moe._routing = moe._routing.fn
    del loop
    gc.collect()
    torch.cuda.empty_cache()
    return {"launches": launches, "step_ms": step_s * 1e3, "tok_s": tok_s,
            "mfu": mfu, "tflops_s": executed / step_s / 1e12,
            "peak_gb": peak_gb, "drops": drops, "aux": aux,
            "drops0": drops0, "aux0": aux0,
            "plain_rel": (dl, dn), **traced}


def moe_mesh_run(fa, card: str, devices) -> dict:
    """MOE_MESH_LAYERS layers from seed 0 on b 2 x s 4096, 3 steps: on
    one device (``devices`` None) or over MOE_MESH on ``devices``; the
    losses, grad norms, step walls, K1 (with lse)/K2/K3 per step and the
    peak memory of the fullest card."""
    from ray_tpu_torch.models import moe
    from ray_tpu_torch.parallel import MeshSpec, make_mesh, make_train_step

    cfg = moe_cfg(MOE_MESH_LAYERS)
    mesh = None if devices is None else make_mesh(MeshSpec(**MOE_MESH),
                                                  devices=devices)
    init_fn, step_fn = make_train_step(cfg, mesh, model=moe,
                                       optimizer=moe_optimizer())
    state = init_fn(torch.Generator(device="cuda").manual_seed(0))
    loop = TrainLoop(state, step_fn, train_batch(cfg, 2, 4096))
    del state
    sync_cards()
    for d in range(torch.cuda.device_count()):
        torch.cuda.reset_peak_memory_stats(d)
    per = []
    for _ in range(MESH_PARITY_STEPS):
        reset_train_counts(fa)
        loop.step()
        c = train_counts(fa)
        per.append((c["flash_attention_fwd_lse"],
                    c["flash_attention_bwd_dkv"],
                    c["flash_attention_bwd_dq"]))
    peak_gb = max(torch.cuda.max_memory_allocated(d)
                  for d in range(torch.cuda.device_count())) / 1e9
    out = {"losses": loop.losses, "norms": loop.norms, "per_step": per,
           "launches": [sum(x[i] for x in per) for i in range(3)],
           "step_ms": float(np.median(loop.walls[1:])) * 1e3,
           "peak_gb": peak_gb}
    del loop
    gc.collect()
    torch.cuda.empty_cache()
    return out


def run_moe(fa, card: str) -> dict:
    """A on one device (``moe_single``); then B: the 2-layer single-device
    run first (freed), then the expert mesh on ``("cuda:0",) * 4`` and,
    where four cards are visible, with each shard on its own card ("B4"):
    its first MESH_PARITY_STEPS losses and grad norms held to the single
    device's, and K1 (with lse)/K2/K3 exactly 2 row blocks x (2L, L, L)
    a step: the attention runs once per row block (fsdp 2), shared by
    the expert shards."""
    t0 = time.monotonic()
    single = moe_single(fa, card)
    one = moe_mesh_run(fa, card, None)
    L = MOE_MESH_LAYERS
    want = [(2 * 2 * L, 2 * L, 2 * L)] * MESH_PARITY_STEPS
    runs = {"B": ("cuda:0",) * 4}
    if torch.cuda.device_count() >= 4:
        runs["B4"] = tuple(f"cuda:{i}" for i in range(4))
    meshes = {}
    for name, devices in runs.items():
        r = moe_mesh_run(fa, card, devices)
        k = MESH_PARITY_STEPS
        loss_rel = max(abs(a - w) / abs(w) for a, w in
                       zip(r["losses"][:k], one["losses"][:k]))
        norm_rel = max(abs(a - w) / abs(w) for a, w in
                       zip(r["norms"][:k], one["norms"][:k]))
        ok = (all(np.isfinite(r["losses"])) and loss_rel <= TRAIN_LOSS_REL_TOL
              and norm_rel <= TRAIN_GNORM_REL_TOL and r["per_step"] == want)
        print(f"moe mesh {name} {MOE_MESH} [{card}] on {list(devices)}: "
              f"losses {['%.5f' % x for x in r['losses']]} (one device "
              f"{['%.5f' % x for x in one['losses']]}), grad norms "
              f"{['%.4f' % x for x in r['norms']]} (one device "
              f"{['%.4f' % x for x in one['norms']]}); worst rel loss "
              f"{loss_rel:.2e} (tol {TRAIN_LOSS_REL_TOL}), grad norm "
              f"{norm_rel:.2e} (tol {TRAIN_GNORM_REL_TOL}); K1 (with "
              f"lse)/K2/K3 per step {r['per_step']} (want {want[0]}; one "
              f"device {one['per_step'][0]}); step median "
              f"{r['step_ms']:.1f} ms (one device {one['step_ms']:.1f}), "
              f"peak {r['peak_gb']:.2f} GB (one device "
              f"{one['peak_gb']:.2f}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"MoE mesh {name} disagrees with one device "
                             "or its launch counts")
        meshes[name] = r
    print(f"moe phase [{card}]: {time.monotonic() - t0:.1f} s")
    return {"single": single, "one": one, "meshes": meshes}


# The RLlib phase (``run_rllib``): each algorithm of ray_tpu_torch.rllib at
# its reference test's configuration (tests/test_rllib.py), hidden (64, 64)
# (the only width the JAX package has), the learner on the card and the
# env runners and replay buffers CPU processes of a new init(num_cpus=4),
# as the reference places them. PPO runs its test's 18 iterations and is
# held to its bar; the others run RL_ITERS iterations each.
RL_PPO_ITERS = 18
RL_ITERS = {"IMPALA": 3, "APPO": 3, "DQN": 2, "SAC": 2, "BC": 2,
            "MultiAgentPPO": 2}
# one update of each function on the card against the same update on the
# CPU, from the same parameters, batch and host draws: every tensor after
# it within RL_UPDATE_TOL of that tensor's largest entry (f32 on both
# sides, TF32 off; cuBLAS and MKL sum in other orders; the CPU parity
# tests see up to 7.7e-6 between XLA and torch)
RL_UPDATE_TOL = 1e-4
# the env runners of the algorithms below: 2 + 2 + 2 + 2 + 1 + 1
RL_RUNNERS = 10
# where the learners must be (a CPU rehearsal of the phase sets the CPU)
RL_LEARNER_DEVICE = torch.device("cuda", 0)


def rl_gap(got, want) -> float:
    """Largest |got - want| over the tensors, each relative to the
    largest entry of its ``want``."""
    return max(float((g.detach().cpu() - w.detach()).abs().max()
                     / w.detach().abs().max().clamp_min(1e-6))
               for g, w in zip(got, want))


def rl_update_cases() -> dict:
    """name -> case(device) -> (step, state): ``step()`` runs one update
    (or one return computation) on fresh state on ``device`` and returns
    its outputs; ``state()`` the tensors it updated. Inputs are drawn from
    a seeded numpy generator and CPU torch generators, at the shapes the
    reference tests' configurations give each function."""
    import copy
    from ray_tpu_torch.rllib import appo, bc, dqn, impala, nets, ppo, sac
    rng = np.random.default_rng(0)

    def f(*s, scale=1.0):
        return torch.from_numpy((scale * rng.normal(size=s))
                                .astype(np.float32))

    def bern(p, *s):
        return torch.from_numpy((rng.random(s) < p).astype(np.float32))

    def ints(n, *s):
        return torch.from_numpy(rng.integers(0, n, s).astype(np.int32))

    def gen(seed):
        return torch.Generator().manual_seed(seed)

    T, N = 128, 16              # PPO: 2 runners x 8 envs x 128 steps
    rets = (torch.ones(T, N), f(T, N), bern(0.05, T, N), f(N))
    ppo_batch = {"obs": f(T, N, 4, scale=0.1), "actions": ints(2, T, N),
                 "logp": np.log(0.5) + f(T, N, scale=0.1)}
    ppo_batch["advantages"], ppo_batch["returns"] = ppo._gae(
        *rets, 0.99, 0.95)
    perms = ppo.draw_perms(gen(1), 4, T * N)
    frag = {"obs": f(64, 8, 4, scale=0.1), "actions": ints(2, 64, 8),
            "behavior_logp": np.log(0.5) + f(64, 8, scale=0.1),
            "rewards": torch.ones(64, 8), "dones": bern(0.05, 64, 8),
            "last_obs": f(8, 4, scale=0.1)}
    vt = (frag["behavior_logp"], frag["behavior_logp"] + f(64, 8, scale=0.3),
          frag["rewards"], frag["dones"], f(64, 8), f(8))
    dqn_b = {"obs": f(16, 64, 4, scale=0.1),
             "next_obs": f(16, 64, 4, scale=0.1), "actions": ints(2, 16, 64),
             "rewards": torch.ones(16, 64), "dones": bern(0.05, 16, 64)}
    sac_b = {"obs": f(8, 128, 3), "next_obs": f(8, 128, 3),
             "actions": 2 * torch.tanh(f(8, 128, 1)),
             "rewards": -f(8, 128).abs(), "dones": torch.zeros(8, 128)}
    noise = torch.randn((8, 2, 128, 1), generator=gen(2))
    bc_b = {"obs": f(16, 256, 4, scale=0.1), "actions": ints(2, 16, 256)}
    pol0 = ppo.init_policy(gen(0), 4, 2)
    q0 = dqn.init_q(gen(0), 4, 2)
    actor0, critic0 = sac.init_actor(gen(0), 3, 1), sac.init_critic(
        gen(0), 3, 1)

    def to(d, xs):
        return {k: v.to(d) for k, v in xs.items()} if isinstance(xs, dict) \
            else [v.to(d) for v in xs]

    def policy_case(update, batch, lr, *extra):
        def case(d):
            pol = copy.deepcopy(pol0).to(d)
            opt = nets.adam(pol.parameters(), lr)
            b, more = to(d, batch), to(d, extra)

            def step():
                out = update(pol, opt, b, *more)
                return list(out) if isinstance(out, tuple) else [out]
            return step, lambda: list(pol.parameters())
        return case

    def dqn_case(d):
        q = copy.deepcopy(q0).to(d)
        target = copy.deepcopy(q).requires_grad_(False)
        opt, b = nets.adam(q.parameters(), 1e-3), to(d, dqn_b)
        return (lambda: [dqn.dqn_update(q, target, opt, b)],
                lambda: list(q.parameters()))

    def sac_case(d):
        a, c = copy.deepcopy(actor0).to(d), copy.deepcopy(critic0).to(d)
        tc = copy.deepcopy(c).requires_grad_(False)
        la = torch.tensor(np.log(0.1), dtype=torch.float32, device=d,
                          requires_grad=True)
        opts = (nets.adam(a.parameters(), 1e-3),
                nets.adam(c.parameters(), 1e-3), nets.adam([la], 1e-3))
        b, nz = to(d, sac_b), noise.to(d)
        return (lambda: [sac.sac_update(a, c, tc, la, opts, b, nz,
                                        action_high=2.0)],
                lambda: [la, *a.parameters(), *c.parameters(),
                         *tc.parameters()])

    return {
        "_gae (128 x 16)": lambda d: (
            lambda: list(ppo._gae(*to(d, rets), 0.99, 0.95)), list),
        "_vtrace (64 x 8)": lambda d: (
            lambda: list(impala._vtrace(*to(d, vt), 0.99)), list),
        "ppo_update (4 x 4 of 512)": policy_case(
            ppo.ppo_update, ppo_batch, 3e-4, perms),
        "impala_update (64 x 8)": policy_case(
            impala.impala_update, frag, 6e-4),
        "appo_update (64 x 8)": policy_case(appo.appo_update, frag, 1e-3),
        "dqn_update (16 of 64)": dqn_case,
        "sac_update (8 of 128)": sac_case,
        "bc_update (16 of 256)": policy_case(bc.bc_update, bc_b, 1e-3),
    }


def rl_timed(step, d: torch.device):
    """(``step()``'s outputs, host ms until its work on ``d`` is done)."""
    t0 = time.perf_counter()
    out = step()
    if d.type == "cuda":
        torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def rl_updates_card_vs_cpu(card: str) -> dict:
    """Each case of ``rl_update_cases`` once on the card and once on the
    CPU, compared (outputs and updated state, RL_UPDATE_TOL), then three
    more calls each, timed (median ms; the card's synced)."""
    out = {}
    for name, case in rl_update_cases().items():
        runs = []
        for d in (RL_LEARNER_DEVICE, torch.device("cpu")):
            step, state = case(d)
            got, _ = rl_timed(step, d)
            snap = [t.detach().clone() for t in got + state()]
            ms = float(np.median([rl_timed(step, d)[1] for _ in range(3)]))
            runs.append((snap, ms))
        runs = dict(zip(("cuda", "cpu"), runs))
        gap = rl_gap(runs["cuda"][0], runs["cpu"][0])
        ok = gap <= RL_UPDATE_TOL
        print(f"rllib {name} [{card}]: card vs CPU largest gap {gap:.2e} "
              f"(tol {RL_UPDATE_TOL}); ms a call: card (synced) "
              f"{runs['cuda'][1]:.3f}, CPU {runs['cpu'][1]:.3f} "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"rllib {name}: the card's update disagrees "
                             "with the CPU's")
        out[name] = dict(gap=gap, card_ms=runs["cuda"][1],
                         cpu_ms=runs["cpu"][1])
    return out


def rl_learner_tensors(algo) -> list:
    """Every tensor a learner keeps: its nets' parameters (targets too),
    its Adam buffers and SAC's log_alpha."""
    mods = [getattr(algo, n) for n in ("policy", "q", "target_q", "actor",
                                       "critic", "target_critic")
            if hasattr(algo, n)] + list(getattr(algo, "nets", {}).values())
    opt = getattr(algo, "opt", None) or getattr(algo, "opts", ())
    opts = list(opt.values()) if isinstance(opt, dict) else \
        list(opt) if isinstance(opt, tuple) else [opt]
    return [p for m in mods for p in m.parameters()] + \
        [t for o in opts for t in (o.flat, o.grad, o.m, o.v)] + \
        ([algo.log_alpha] if hasattr(algo, "log_alpha") else [])


def rl_trace_ppo_update(algo, card: str) -> dict:
    """One ``ppo_update`` at PPO's shapes on a fresh fragment of the
    algorithm's runners, on a copy of its policy: host wall (median of 3,
    synced), then one traced with torch.profiler: the device's busy time
    (its events' intervals), idle share, and its launches (kernels, and
    the copies and fills)."""
    import copy

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import ray_tpu_torch
    from ray_tpu_torch.rllib import nets, ppo
    c = algo.cfg
    frags = ray_tpu_torch.get([r.sample.remote(algo.get_policy_params())
                               for r in algo.runners], timeout=300)
    batch = ppo.gae_batch(ppo.concat_fragments(frags), algo.device,
                          c.gamma, c.lam)
    n = batch["obs"].shape[0] * batch["obs"].shape[1]
    perms = ppo.draw_perms(torch.Generator().manual_seed(0), c.epochs,
                           n).to(algo.device)
    pol = copy.deepcopy(algo.policy)
    opt = nets.adam(pol.parameters(), c.lr)

    def step():
        return ppo.ppo_update(pol, opt, batch, perms,
                              minibatches=c.minibatches)
    rl_timed(step, algo.device)
    wall = float(np.median([rl_timed(step, algo.device)[1]
                            for _ in range(3)]))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        rl_timed(step, algo.device)
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    copies = [e for e in events if "memcpy" in e.name.lower()
              or "memset" in e.name.lower()]
    busy = sum(e.time_range.elapsed_us() for e in events) / 1e3
    steps = c.epochs * c.minibatches
    r = dict(wall_ms=wall, busy_ms=busy, idle=1 - busy / wall,
             launches=len(events), copies=len(copies), steps=steps)
    print(f"rllib ppo_update traced [{card}]: {steps} Adam steps of "
          f"{n // c.minibatches} rows, host wall {wall:.3f} ms (median of "
          f"3, synced), device busy {busy:.3f} ms, idle share "
          f"{r['idle']:.3f}; {len(events)} device launches a update "
          f"({len(events) - len(copies)} kernels, {len(copies)} copies or "
          f"fills), {len(events) / steps:.1f} a step")
    return r


def rl_algorithms() -> dict:
    """name -> (build(), the reference test's timesteps per iteration):
    each at its reference test's configuration, with zero-CPU runners."""
    from ray_tpu_torch import data, rllib

    def bc_data():
        e = rllib.CartPoleVec(16, seed=3)
        obs = e.reset_all()
        all_obs, all_act = [], []
        for _ in range(400):            # the reference test's expert
            act = ((obs[:, 2] + 0.5 * obs[:, 3]) > 0).astype(np.int32)
            all_obs.append(obs.copy())
            all_act.append(act)
            obs, _r, _d = e.step(act)
        return data.from_blocks([{"obs": np.concatenate(all_obs),
                                  "action": np.concatenate(all_act)}])

    # zero-CPU runners: every algorithm's start together under
    # init(num_cpus=4) (the buffers take one CPU each)
    zero = {"runner_options": {"num_cpus": 0}}
    fragments = dict(num_env_runners=2, num_envs_per_runner=8,
                     rollout_len=64, fragments_per_iter=2, **zero)
    return {
        "PPO": (lambda: rllib.PPO(rllib.PPOConfig(
            num_env_runners=2, num_envs_per_runner=8, rollout_len=128,
            seed=3, **zero)), 2 * 8 * 128),
        "IMPALA": (lambda: rllib.IMPALA(rllib.IMPALAConfig(
            seed=5, **fragments)), 2 * 8 * 64),
        "APPO": (lambda: rllib.APPO(rllib.APPOConfig(
            seed=11, **fragments)), 2 * 8 * 64),
        "DQN": (lambda: rllib.DQN(rllib.DQNConfig(
            num_env_runners=2, num_envs_per_runner=8, steps_per_call=64,
            learning_starts=512, updates_per_iter=32, seed=7, **zero)),
            2 * 8 * 64),
        "SAC": (lambda: rllib.SAC(rllib.SACConfig(
            num_env_runners=1, num_envs_per_runner=8, steps_per_call=50,
            learning_starts=400, batch_size=128, updates_per_iter=400,
            lr=1e-3, seed=0, **zero)), 8 * 50),
        "BC": (lambda: rllib.BC(bc_data(), rllib.BCConfig(
            eval_episodes=8, updates_per_iter=64)), None),
        "MultiAgentPPO": (lambda: rllib.MultiAgentPPO(
            rllib.MultiAgentPPOConfig(num_env_runners=1,
                                      num_envs_per_runner=8,
                                      rollout_len=128, seed=2, **zero)),
            1 * 8 * 128 * 2),
    }


def rl_check(name: str, results: list) -> str:
    """The reference tests' checks on an algorithm's short run (PPO's
    bar is held in run_rllib); returns what was checked."""
    last = results[-1]
    if name in ("IMPALA", "APPO"):
        rhos = [r["mean_rho"] for r in results]
        ok = any(abs(x - 1.0) > 1e-4 for x in rhos) and all(
            np.isfinite(x) and 0.0 < x < 100.0 for x in rhos)
        what = f"mean ratios {['%.5f' % x for x in rhos]}"
    elif name == "DQN":
        ok = all(np.isfinite(r["loss"]) for r in results) and \
            last["buffer_size"] > 512
        what = (f"losses {['%.4f' % r['loss'] for r in results]}, buffer "
                f"{last['buffer_size']}")
    elif name == "SAC":
        past = results[1:]      # iteration 1 sampled uniform torque
        ok = bool(past) and all(
            np.isfinite(r[k]) for r in past
            for k in ("critic_loss", "actor_loss", "alpha"))
        what = ", ".join(f"critic {r['critic_loss']:.3f} actor "
                         f"{r['actor_loss']:.3f} alpha {r['alpha']:.4f}"
                         for r in results)
    elif name == "BC":
        ok = last["dataset_size"] == 16 * 400 and np.isfinite(last["loss"])
        what = (f"losses {['%.4f' % r['loss'] for r in results]}, return "
                f"{last['episode_reward_mean']:.1f}")
    else:
        ok = set(last["policy_loss"]) == {"agent_0", "agent_1"} and all(
            np.isfinite(v) for v in last["policy_loss"].values())
        what = f"policy losses {last['policy_loss']}"
    if not ok:
        raise SystemExit(f"rllib {name} failed its checks: {what}")
    return what


def rl_stop(algo) -> None:
    """End an algorithm's actors (runners, replay buffer), so the next
    one's fit the cluster's CPUs."""
    import ray_tpu_torch
    if hasattr(algo, "stop"):
        algo.stop()
        return
    for a in [*getattr(algo, "runners", []),
              *([algo.buffer] if hasattr(algo, "buffer") else [])]:
        ray_tpu_torch.kill(a)


def run_rllib(card: str) -> dict:
    """The RLlib phase on a new init(num_cpus=4): every algorithm's
    learner on cuda:0 behind CPU runners (PPO for RL_PPO_ITERS iterations,
    held to its reference test's bar; the others RL_ITERS, with their
    tests' checks), each learner's tensors on cuda:0 after train(); the
    wall per iteration, runner and learner seconds and env steps/s of
    each; one PPO update traced; every update function on the card
    against the CPU; no runner or buffer process initialised CUDA or
    loaded jax, optax, ml_dtypes or ray_tpu (their module dumps), and
    nvidia-smi lists no compute process that it did not list before the
    phase, while every algorithm's runners are up and at its end."""
    import shutil
    import tempfile

    import ray_tpu_torch
    from ray_tpu_torch.rllib import PPO

    t_phase = time.monotonic()
    cpu0 = time.process_time()
    time.sleep(1.0)
    with open("/proc/loadavg") as f:
        load = f.read().split()[:3]
    print(f"rllib [{card}]: host load average {load}; this process holds "
          f"{threading.active_count()} Python threads and used "
          f"{time.process_time() - cpu0:.3f} s of CPU over 1 s of sleep")
    updates = rl_updates_card_vs_cpu(card)
    free0 = torch.cuda.mem_get_info()[0]
    apps0 = compute_apps()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_rllib_")
    site, dumps = os.path.join(tmp, "site"), os.path.join(tmp, "modules")
    os.mkdir(site)
    os.mkdir(dumps)
    with open(os.path.join(site, "sitecustomize.py"), "w") as f:
        f.write(MODULE_DUMP)
    os.environ["CHIP_SMOKE_MODULES"] = dumps
    sys.path.insert(0, site)
    try:
        ray_tpu_torch.init(num_cpus=4)
    finally:
        sys.path.remove(site)
    algos, trace = {}, None
    try:
        # every algorithm's runners and buffers start together, so their
        # processes' imports overlap
        t_up = time.monotonic()
        built = {name: (build(), per_iter) for name, (build, per_iter)
                 in rl_algorithms().items()}
        for name, (algo, per_iter) in built.items():
            t0 = time.monotonic()
            if hasattr(algo, "_inflight"):
                # every runner's first fragment ready, so that one
                # runner's later start does not leave the other to make
                # all of the few fragments consumed here (with fresh
                # weights each: ratio 1)
                ray_tpu_torch.wait(list(algo._inflight),
                                   num_returns=len(algo._inflight),
                                   timeout=300)
            iters = RL_PPO_ITERS if name == "PPO" else RL_ITERS[name]
            results, walls = [], []
            for _ in range(iters):
                t = time.monotonic()
                results.append(algo.train())
                walls.append(time.monotonic() - t)
                if per_iter is not None and \
                        results[-1]["timesteps_this_iter"] != per_iter:
                    raise SystemExit(f"rllib {name}: timesteps_this_iter "
                                     f"{results[-1]['timesteps_this_iter']}"
                                     f" != {per_iter}")
            off = [t for t in rl_learner_tensors(algo)
                   if t.device != RL_LEARNER_DEVICE]
            if off:
                raise SystemExit(f"rllib {name}: {len(off)} learner "
                                 f"tensors are not on {RL_LEARNER_DEVICE}")
            if isinstance(algo, PPO):
                rets = [r["episode_reward_mean"] for r in results]
                first = next((x for x in rets if x > 0), None)
                best = max(rets)
                if first is None or not best > max(60.0, 1.5 * first):
                    raise SystemExit(f"rllib PPO did not learn: first "
                                     f"{first}, best {best}")
                what = (f"first {first:.2f}, best {best:.2f} (bar "
                        f"{max(60.0, 1.5 * first):.2f})")
                trace = rl_trace_ppo_update(algo, card)
                # every algorithm's runners were started with PPO's
                apps_up = compute_apps()
            else:
                what = rl_check(name, results)
            rl_stop(algo)
            if name == "PPO":
                up_s = time.monotonic() - t_up - sum(walls[1:])
            # the first iteration may wait for the runners' processes to
            # start: medians over the others
            timers = [r["timers"] for r in results[1:]]
            r = {k: float(np.median([t[k] for t in timers]))
                 for k in timers[0]}
            r.update(iters=iters, wall_s=float(np.median(walls[1:])),
                     first_s=walls[0], phase_s=time.monotonic() - t0)
            r["steps_per_s"] = per_iter / r["wall_s"] if per_iter else None
            algos[name] = r
            print(f"rllib {name} [{card}]: {iters} iterations, train() "
                  f"wall {r['wall_s']:.3f} s (the first {walls[0]:.3f}); "
                  f"a iteration: "
                  + ", ".join(f"{k} {r[k]:.3f}" for k in timers[0])
                  + (f", {r['steps_per_s']:.0f} env steps/s" if per_iter
                     else "") + f" (medians after the first); {what}; "
                  f"{r['phase_s']:.1f} s in all ok")
            del algo
        del built
        apps_end = compute_apps()
        time.sleep(1.5)         # the dumps' last write
    finally:
        ray_tpu_torch.shutdown()
        os.environ.pop("CHIP_SMOKE_MODULES", None)
    # every process that wrote a dump is one of the cluster's workers
    # (the head and the agent run in this process): the runners, the
    # buffers (their class pickles by value and needs numpy alone) and
    # the idle pool
    me = str(os.getpid())
    workers = {}
    for fname in os.listdir(dumps):
        if fname.endswith(".txt") and fname[:-4] != me:
            with open(os.path.join(dumps, fname)) as f:
                workers[fname[:-4]] = set(f.read().split())
    shutil.rmtree(tmp, ignore_errors=True)
    with_torch = sum("torch" in mods for mods in workers.values())
    bad = {pid: sorted(m for m in mods if m.split(".")[0] in
                       ("jax", "jaxlib", "ml_dtypes", "optax", "ray_tpu"))
           for pid, mods in workers.items()}
    cuda_on = sorted(pid for pid, mods in workers.items()
                     if "<cuda-initialized>" in mods)
    mine = [m for m in sys.modules if m.split(".")[0] == "optax"] + \
        foreign_modules()
    added = {when: sorted((Counter(apps) - Counter(apps0)).elements())
             for when, apps in (("with every runner up", apps_up),
                                ("at the end", apps_end))}
    placement = (
        f"{len(workers)} worker processes ({with_torch} with torch, "
        f"{RL_RUNNERS} runners expected), CUDA initialised in "
        f"{cuda_on or 'none'}, foreign modules "
        f"{[b for b in bad.values() if b] or 'none'}; the driver's "
        f"{mine or 'none'}; nvidia-smi compute processes {apps0} before "
        f"the phase, {apps_up} with every runner up, {apps_end} at the end "
        f"(this process {me})")
    print(f"rllib placement [{card}]: {placement}")
    faults = [f for f, bad_ in (
        ("fewer worker processes loaded torch than there are runners",
         with_torch < RL_RUNNERS),
        ("a worker process initialised CUDA", cuda_on),
        ("a worker process loaded a foreign module", any(bad.values())),
        ("the driver loaded a foreign module", mine),
        (f"nvidia-smi lists new compute processes {added}",
         any(added.values()))) if bad_]
    if faults:
        raise SystemExit(f"rllib placement: {'; '.join(faults)} "
                         f"({placement})")
    gc.collect()
    torch.cuda.empty_cache()
    polls = wait_card_back(free0, "the RL phase")
    phase = time.monotonic() - t_phase
    print(f"rllib phase [{card}]: {phase:.1f} s, of which {up_s:.1f} s "
          "to build every algorithm and take PPO's first iteration (its "
          "runners' start with every other algorithm's)")
    return dict(updates=updates, algos=algos, trace=trace, polls=polls,
                phase_s=phase, up_s=up_s)


# The trainer phase: Llama-3-8B's widths at TRAINER_LAYERS (1, for the
# script's time limit) under "dots" through
# TorchTrainer, 6 steps of 2 x 4096 tokens, a checkpoint after step 3, the
# worker killed once before step 4 and the group restored from it. Its
# losses and grad norms against the same 6 steps of make_train_step in this
# process: the same kernels and cuBLAS calls on the same card and values,
# so they are expected bit for bit equal (printed); the bound allows only
# a reordered f32 sum, far below what one step's update moves (~1e-3). The
# grad norm of steps 4-6 is the tighter witness of a wrong restore of the
# AdamW moments.
TRAINER_STEPS, TRAINER_SAVE_AT, TRAINER_FAIL_AT = 6, 3, 4
TRAINER_REL_TOL = 1e-5
TRAINER_LAYERS = 1


def trainer_run(lr: float = 3e-4):
    """(cfg, state, step_fn, batch(step)) of the trainer phase, as the
    worker and the driver both build it (the tune phase's trials with
    their own peak learning rate ``lr``)."""
    # torch is imported in the body of each function that a worker runs:
    # a function pickled by value that names the module's global torch
    # makes every process that unpickles it (the trial actor, the train
    # controller) import torch first, ~7.5 s each on the chip host
    import torch
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.parallel import default_optimizer, make_train_step
    cfg = llama.llama3_8b(n_layers=TRAINER_LAYERS, dtype="bfloat16",
                          remat_policy="dots", logits_dtype="float32",
                          ce_chunk=0)
    init_fn, step_fn = make_train_step(cfg, optimizer=default_optimizer(
        learning_rate=lr, warmup_steps=2, total_steps=100))
    state = init_fn(torch.Generator(device="cuda").manual_seed(0))

    def batch(step: int) -> dict:
        toks = np.random.default_rng(100 + step).integers(
            0, cfg.vocab_size, (2, 4097))
        return {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    return cfg, state, step_fn, batch


def trainer_fn(config):
    """The trainer phase's train_fn, in the train worker: restores from
    the run's checkpoint when there is one, then takes the remaining
    steps, each inside a goodput step window (compute stamped around the
    synced step); saves through AsyncCheckpointer after step 3 (the host
    copy and the snapshot are the step path's ckpt_stall); after step 4,
    the first time, waits for the save to commit, writes its save numbers
    beside the checkpoint, waits until the controller holds steps 1-3's
    reports, and dies before reporting the step. Each step
    reports its loss, grad norm, K1/K2/K3 launches, goodput row and the
    train_mfu gauge."""
    import torch  # in the body: see trainer_run
    import ray_tpu_torch
    from ray_tpu_torch import train
    from ray_tpu_torch.ops import flash_attention as fa
    from ray_tpu_torch.parallel import mesh
    from ray_tpu_torch.train import ckptio
    from ray_tpu_torch.util import goodput, storage
    for f in (fa.flash_attention_fwd, fa.flash_attention_bwd_dkv,
              fa.flash_attention_bwd_dq):
        f.launches = 0
    fa.flash_attention_fwd.lse_launches = 0
    cfg, state, step_fn, batch = trainer_run()
    goodput.set_model_flops(cfg.flops_per_token(4096) * 2 * 4096)
    ctx = train.get_context()
    start, restore_s = 0, None
    if ctx.get_checkpoint() is not None:
        torch.cuda.synchronize()
        t0 = time.monotonic()
        params, opt, start = ckptio.restore(*mesh.numpy_template(state),
                                            checkpoint=ctx.get_checkpoint())
        mesh.state_from_numpy(state, params, opt)
        del params, opt
        torch.cuda.synchronize()
        restore_s = time.monotonic() - t0
    ck = ckptio.AsyncCheckpointer()
    save = {}
    for step in range(start + 1, TRAINER_STEPS + 1):
        counts = (fa.flash_attention_fwd.lse_launches,
                  fa.flash_attention_bwd_dkv.launches,
                  fa.flash_attention_bwd_dq.launches)
        t_step = time.monotonic()
        with ctx.trace_step():
            with goodput.interval("compute"):
                state, m = step_fn(state, batch(step))
                torch.cuda.synchronize()
            if step == TRAINER_SAVE_AT:
                t0 = time.monotonic()
                with goodput.interval("ckpt_stall"):
                    ck.save(step, *mesh.state_to_numpy(state))
                save["step_path_s"] = time.monotonic() - t0
        wall = time.monotonic() - t_step
        if step == TRAINER_FAIL_AT and not os.path.exists(config["marker"]):
            # the save's write overlapped this step; what is left of it
            # is the flush wait
            t0 = time.monotonic()
            ck.flush()
            save.update(flush_wait_s=time.monotonic() - t0,
                        write_s=hist("ckpt_save_s")[1],
                        commit_s=hist("ckpt_commit_s")[1],
                        ckptio_snapshot_s=hist("ckpt_snapshot_s")[1])
            storage.atomic_write_json(config["save_stats"], save)
            # the controller must hold steps 1-3's reports before the
            # worker dies (they leave the worker with the next poll)
            ctrl = train.get_controller(config["run"])
            while ray_tpu_torch.get(ctrl.status.remote(),
                                    timeout=60)["reports"] < step - 1:
                time.sleep(0.05)
            open(config["marker"], "w").close()
            os._exit(1)
        train.report({
            "step": step, "loss": m["loss"].item(),
            "grad_norm": m["grad_norm"].item(), "wall_s": wall,
            "resumed_from": start, "restore_s": restore_s,
            "launches": [fa.flash_attention_fwd.lse_launches - counts[0],
                         fa.flash_attention_bwd_dkv.launches - counts[1],
                         fa.flash_attention_bwd_dq.launches - counts[2]],
            "goodput": goodput.recent_rows()[-1],
            "mfu": metric("train_mfu", rank=str(ctx.get_world_rank())),
            "foreign": foreign_modules(),
            "cards": os.environ.get("CUDA_VISIBLE_DEVICES")})
    ck.close()


def run_trainer(card: str) -> dict:
    """The training path through the train library: the same 6 steps by
    make_train_step in this process first (then freed), then init(), one
    TorchTrainer(ScalingConfig(num_workers=1, use_gpu=True)) whose worker
    runs trainer_fn on the card with FailureConfig(max_failures=1) and a
    storage path in a temporary directory (removed after). Checks the
    resumed losses and grad norms against this process's, each step's
    K1/K2/K3 launches (TRAINER_LAYERS each under "dots"), the restart,
    that the worker saw one card and loaded no jax or ray_tpu; prints the checkpoint's bytes, the save and
    restore seconds and the goodput anatomy."""
    import shutil
    import tempfile

    import ray_tpu_torch
    from ray_tpu_torch.train import (FailureConfig, RunConfig,
                                     ScalingConfig, TorchTrainer, ckptio)
    cfg, state, step_fn, batch = trainer_run()
    want = []       # the tune phase's winner takes more steps
    for step in range(1, max(TRAINER_STEPS, TUNE_STEPS) + 1):
        state, m = step_fn(state, batch(step))
        want.append((m["loss"].item(), m["grad_norm"].item()))
    del state, m
    gc.collect()
    torch.cuda.empty_cache()
    root = tempfile.mkdtemp(prefix="chip_smoke_trainer_")
    free0 = torch.cuda.mem_get_info()[0]
    ray_tpu_torch.init(num_cpus=4, resources={
        "GPU": float(torch.cuda.device_count())})
    try:
        t0 = time.monotonic()
        res = TorchTrainer(
            trainer_fn,
            train_loop_config={"marker": os.path.join(root, "died_once"),
                               "save_stats": os.path.join(root, "save.json"),
                               "run": "chip-smoke-trainer"},
            scaling_config=ScalingConfig(num_workers=1, use_gpu=True),
            run_config=RunConfig(
                name="chip-smoke-trainer",
                storage_path=os.path.join(root, "ckpt"),
                failure_config=FailureConfig(max_failures=1))).fit()
        fit_s = time.monotonic() - t0
        if res.error is not None:
            raise SystemExit(f"the trainer failed: {res.error}")
        ckpt = os.path.join(root, "ckpt", ckptio.ckpt_dirname(
            TRAINER_SAVE_AT))
        man = ckptio.manifest_of(ckpt)
        with open(os.path.join(root, "save.json")) as f:
            save = json.load(f)
        died = os.path.exists(os.path.join(root, "died_once"))
    finally:
        ray_tpu_torch.shutdown()
        shutil.rmtree(root, ignore_errors=True)
    wait_card_back(free0, "the trainer")
    hist_ = res.metrics_history
    got = [(r["loss"], r["grad_norm"]) for r in hist_]
    ref = want[:TRAINER_STEPS]
    rel = max(abs(g[0] - w[0]) / abs(w[0]) for g, w in zip(got, ref))
    rel_norm = max(abs(g[1] - w[1]) / abs(w[1]) for g, w in zip(got, ref))
    launches = [sum(r["launches"][i] for r in hist_) for i in range(3)]
    rows = [r["goodput"] for r in hist_]
    anatomy = {c: sum(r[c] for r in rows) for c in (
        "wall_s", "compute", "ckpt_stall", "compile", "idle")}
    nbytes = sum(sh["bytes"] for sp in man["spaces"].values()
                 for sh in sp["shards"])
    print(f"trainer [{card}]: TorchTrainer, 1 worker on the card, "
          f"llama3_8b widths at {cfg.n_layers} layers ('dots'), fit "
          f"{fit_s:.1f} s; steps {[r['step'] for r in hist_]} resumed from "
          f"{[r['resumed_from'] for r in hist_]}, worker killed once "
          f"{died}; losses {[r[0] for r in got]} vs the driver's "
          f"{[w[0] for w in ref]} (max rel {rel:.2e}), grad norms "
          f"{[r[1] for r in got]} vs {[w[1] for w in ref]} (max rel "
          f"{rel_norm:.2e}; tol {TRAINER_REL_TOL} on each; bitwise "
          f"{got == ref}); step walls "
          f"{['%.3f' % r['wall_s'] for r in hist_]} s")
    print(f"trainer checkpoint [{card}]: step {man['step']}, "
          f"{nbytes} bytes (parameters as f32, moments as bf16 bits); "
          f"step path {save['step_path_s']:.2f} s (the copy off the card, "
          f"then ckptio's snapshot {save['ckptio_snapshot_s']:.2f} s), "
          f"background shard "
          f"write {save['write_s']:.2f} s, manifest commit "
          f"{save['commit_s']:.2f} s, flush wait after step 4 "
          f"{save['flush_wait_s']:.2f} s; restore "
          f"{hist_[-1]['restore_s']:.2f} s (read, hash, re-slice, onto "
          f"the card)")
    print(f"trainer goodput [{card}] over the 6 reported steps (s): "
          + ", ".join(f"{k} {v:.3f}" for k, v in anatomy.items())
          + f"; train_mfu gauge (last step) {hist_[-1]['mfu']:.4f}; worker "
          f"launches K1/K2/K3 {launches}; worker's jax/ray_tpu modules "
          f"{sorted({m for r in hist_ for m in r['foreign']})}; worker's "
          f"CUDA_VISIBLE_DEVICES {sorted({r['cards'] for r in hist_})}")
    if [r["step"] for r in hist_] != list(range(1, TRAINER_STEPS + 1)) \
            or [r["resumed_from"] for r in hist_] != [0] * 3 + [3] * 3 \
            or not died:
        raise SystemExit("the trainer did not resume steps 4-6 from the "
                         "step-3 checkpoint after one failure")
    if max(rel, rel_norm) > TRAINER_REL_TOL \
            or not all(np.isfinite(got).ravel()):
        raise SystemExit("the trainer's losses or grad norms differ from "
                         "the driver's")
    if any(r["launches"] != [cfg.n_layers] * 3 for r in hist_):
        raise SystemExit(f"trainer launches per step "
                         f"{[r['launches'] for r in hist_]}")
    if any(r["foreign"] for r in hist_):
        raise SystemExit("the train worker loaded jax or ray_tpu")
    if any(r["cards"] is None or "," in r["cards"] for r in hist_):
        raise SystemExit("the use_gpu worker was not pinned to one card")
    if anatomy["ckpt_stall"] <= 0 or not 0 < hist_[-1]["mfu"] < 1:
        raise SystemExit("the goodput ledger missed the save or the MFU")
    return {"launches": launches, "checkpoint_bytes": nbytes, **save,
            "restore_s": hist_[-1]["restore_s"], "goodput": anatomy,
            "want": want}


# --- a Tune sweep of trainer trials on the card ------------------------------
#
# One user flow: sweep, watch, pick the best, serve it. init() with the
# metrics endpoint (metrics_port=0), then tune.Tuner over a TorchTrainer
# (one worker, {"CPU": 1}) whose tune_fn trains trainer_run's model
# (Llama-3-8B widths at TRAINER_LAYERS, "dots", bf16, 2 x 4096 tokens of
# batch(step)) for TUNE_STEPS steps, a grid over the peak learning rate:
# trainer_run's 3e-4 and 0.1, which diverges (AdamW's first steps move
# every weight by ~lr, and the weights are ~0.016). Both trials run
# together, each worker holding the one H100. ASHAScheduler(grace 3,
# reduction 2) culls at step 3, the first step where the two losses can
# differ (the warmup's first update is at lr 0); max_t is TUNE_STEPS + 1
# because a trainer trial forwards its checkpoint in one report more than
# its steps, and a STOP at max_t before that report would end the winner
# STOPPED. ASHA is asynchronous: a trial that reaches every rung first is
# never culled there (the reference's trainer-trial ASHA test is a known
# flake for this reason), so the second trial builds its model beside the
# first and starts stepping once the first has taken its last step (its
# save then overlaps the second's steps): the rung holds the first
# trial's loss when the second reaches it. The stop takes a few of the
# second trial's steps to reach it (its reports cross the controller's
# and the trial's polls, and the winner's save loads the host: 2-4 steps
# after the rung on an H100 host), so the trials take TUNE_STEPS = 12
# steps and the second has 9 to go at the rung.
# The winner saves a parameters-only ckptio checkpoint at its last step
# (on tmpfs where there is one, as run_pipeline's: what is timed is the
# save, not the disk) and reports it. While the trials run, a watcher
# thread profiles the first trial's worker over the control plane, runs
# the CLI's `stack` on it and scrapes the head's /metrics for both
# workers' series.
TUNE_STEPS = 12
TUNE_LRS = (3e-4, 0.1)
TUNE_GRACE = 3
TUNE_PROFILE_S = 1.0
TUNE_NEW = 16           # greedy tokens the served winner generates


def tune_fn(config):
    """Each trial's train_fn, in its train worker: writes who it is
    (pid, runtime worker id) to config["dir"], builds trainer_run's
    model at config["lr"], waits (the second trial) for the first
    trial's marker, then takes TUNE_STEPS steps, each inside a goodput
    step window, reporting loss, grad norm, the K1-with-lse/K2/K3
    launches of the step, the train_mfu gauge, the peak HBM and the
    jax/ray_tpu modules; the first trial writes the marker after its
    last step, then saves its parameters (f32) through
    AsyncCheckpointer and reports the checkpoint and their fingerprint
    with that step."""
    import torch  # in the body: see trainer_run
    from ray_tpu_torch import train
    from ray_tpu_torch.ops import flash_attention as fa
    from ray_tpu_torch.train import ckptio
    from ray_tpu_torch.util import goodput, storage
    lead = config["lr"] == config["lead_lr"]
    me = {"pid": os.getpid(), "lr": config["lr"], "t_start": time.time(),
          "worker": os.environ["RAY_TPU_WORKER_ID"][:12]}
    storage.atomic_write_json(os.path.join(
        config["dir"], "lead.json" if lead else "other.json"), me)
    for f in (fa.flash_attention_fwd, fa.flash_attention_bwd_dkv,
              fa.flash_attention_bwd_dq):
        f.launches = 0
    fa.flash_attention_fwd.lse_launches = 0
    cfg, state, step_fn, batch = trainer_run(config["lr"])
    goodput.set_model_flops(cfg.flops_per_token(4096) * 2 * 4096)
    ctx = train.get_context()
    me["t_built"] = time.time()
    gate = os.path.join(config["dir"], "lead-done")
    if not lead:
        deadline = time.monotonic() + 300
        while not os.path.exists(gate):
            if time.monotonic() > deadline:
                raise RuntimeError("the first trial never finished")
            time.sleep(0.05)
    for step in range(1, TUNE_STEPS + 1):
        counts = (fa.flash_attention_fwd.lse_launches,
                  fa.flash_attention_bwd_dkv.launches,
                  fa.flash_attention_bwd_dq.launches)
        with ctx.trace_step():
            with goodput.interval("compute"):
                state, m = step_fn(state, batch(step))
                torch.cuda.synchronize()
        rep = {"step": step, "loss": m["loss"].item(),
               "grad_norm": m["grad_norm"].item(),
               "launches": [
                   fa.flash_attention_fwd.lse_launches - counts[0],
                   fa.flash_attention_bwd_dkv.launches - counts[1],
                   fa.flash_attention_bwd_dq.launches - counts[2]],
               "mfu": metric("train_mfu", rank=str(ctx.get_world_rank())),
               "peak_hbm": torch.cuda.max_memory_allocated(),
               "foreign": foreign_modules(), **me}
        ck = None
        if lead and step == TUNE_STEPS:
            open(gate, "w").close()
            rep["t_steps"] = time.time()
            t0 = time.monotonic()
            named = list(state.params.named_parameters())
            params = {n: p.detach().float().cpu().numpy() for n, p in named}
            saver = ckptio.AsyncCheckpointer()
            saver.save(step, params, block=True)
            ck = saver.last_committed()
            saver.close()
            del params
            rep.update(save_s=time.monotonic() - t0,
                       fingerprint=param_fingerprint(
                           p.float() for _, p in named))
        train.report(rep, checkpoint=ck)


def tune_series(text: str, worker: str) -> dict:
    """The head's /metrics lines pushed by runtime worker ``worker``:
    its train_mfu samples and its goodput_seconds_total samples."""
    out = {"train_mfu": [], "goodput_seconds_total": []}
    for line in text.splitlines():
        name = line.split("{", 1)[0].split(" ", 1)[0]
        if name in out and f'worker="{worker}"' in line:
            out[name].append(line)
    return out


def tune_watch(root: str, addr: str, maddr, live: dict,
               done: threading.Event) -> None:
    """The watcher thread of ``run_tune``, while fit() runs: once the
    first trial names its worker, profiles it over the control plane
    (head profile_target, TUNE_PROFILE_S at 100 Hz) and runs
    ``python -m ray_tpu_torch.scripts stack <pid>`` on it; then scrapes
    the head's /metrics every 0.25 s until both trials' workers show a
    train_mfu (rank label) and a goodput series, or fit() returns.
    Records everything in ``live``; an exception lands in
    live["error"]."""
    import urllib.request

    from ray_tpu_torch import scripts
    try:
        lead = os.path.join(root, "lead.json")
        while not os.path.exists(lead):
            if done.wait(0.05):
                raise RuntimeError("fit() returned before the first trial "
                                   "named its worker")
        with open(lead) as f:
            who = json.load(f)
        t0 = time.monotonic()
        prof = scripts._call_head(
            addr, "profile_target", timeout=60.0, target=str(who["pid"]),
            op="profile", duration_s=TUNE_PROFILE_S, hz=100)
        live["profile"] = dict(
            wall_s=time.monotonic() - t0, samples=prof.get("samples"),
            error=prof.get("error"), pid=prof.get("pid"),
            stacks=len(prof.get("folded") or {}),
            tune_fn=sum(c for k, c in (prof.get("folded") or {}).items()
                        if "tune_fn (" in k))
        t0 = time.monotonic()
        cli = subprocess.run(
            [sys.executable, "-m", "ray_tpu_torch.scripts", "stack",
             str(who["pid"]), "--address", addr],
            capture_output=True, text=True, timeout=120)
        live["stack"] = dict(rc=cli.returncode,
                             wall_s=time.monotonic() - t0,
                             lines=len(cli.stdout.splitlines()),
                             tune_fn="tune_fn" in cli.stdout,
                             stderr=cli.stderr[-400:])
        found = {}
        while True:
            with urllib.request.urlopen(
                    f"http://{maddr[0]}:{maddr[1]}/metrics",
                    timeout=30) as r:
                text = r.read().decode()
            for name in ("lead", "other"):
                path = os.path.join(root, f"{name}.json")
                if name in found or not os.path.exists(path):
                    continue
                with open(path) as f:
                    w = json.load(f)["worker"]
                got = tune_series(text, w)
                if all(got.values()):
                    found[name] = dict(at_s=time.monotonic() - t0,
                                       **{k: v[:2] for k, v in
                                          got.items()})
            live["series"] = dict(found)
            if len(found) == 2 or done.wait(0.25):
                break
    except Exception as e:          # noqa: BLE001 — re-raised by run_tune
        live["error"] = f"{type(e).__name__}: {e}"


def run_tune(card: str, want: list) -> dict:
    """The tune phase (see the comment block above). ``want`` is
    run_trainer's in-process (loss, grad norm) of batch(1..TUNE_STEPS)
    at lr 3e-4. Checks: the diverging trial STOPPED with fewer than TUNE_STEPS
    reports, the winner TERMINATED with all of them, K1 (lse)/K2/K3
    TRAINER_LAYERS times each in every reported step, the winner's
    losses and grad norms equal to ``want`` within TRAINER_REL_TOL; the
    watcher's profile holds tune_fn's frame, its CLI stack exits 0, and
    /metrics carried both workers' train_mfu and goodput series; after
    fit(), state.list_devices() has an HBM row of each trial's worker
    and goodput_from_events a row for each trial's steps, the
    dashboard's /, /goodput, /devices and /profile answer 200, the CLI's
    status, list actors and goodput exit 0, and no worker loaded jax or
    ray_tpu. Then serves the winner's checkpoint: serve.llm._load_model
    restores it on the card (its weights' fingerprint equal to the one
    the winner took of what it saved), and an LLMEngine over them
    generates TUNE_NEW greedy tokens for one prompt, K1 once per layer
    and K4 once per layer per decode step."""
    import shutil
    import tempfile
    import urllib.request

    import ray_tpu_torch
    from ray_tpu_torch import api, tune
    from ray_tpu_torch.serve.llm import LLMConfig, _load_model
    from ray_tpu_torch.train import RunConfig, ScalingConfig, TorchTrainer
    from ray_tpu_torch.util import state
    t_phase = time.monotonic()
    shm = "/dev/shm" if os.path.isdir("/dev/shm") else None
    root = tempfile.mkdtemp(prefix="chip_smoke_tune_", dir=shm)
    # the workers read these at start: their metrics reach the head and
    # their HBM rows the timeline within the short trials
    env = {"RAY_TPU_METRICS_EXPORT_INTERVAL_S": "0.5",
           "RAY_TPU_DEVMON_HBM_INTERVAL_S": "0.5"}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    free0 = torch.cuda.mem_get_info()[0]
    ray_tpu_torch.init(num_cpus=6, system_config={"metrics_port": 0})
    live: dict = {}
    done = threading.Event()
    try:
        addr = "%s:%d" % api._g.ctx.head_addr
        maddr = api._g.head.metrics_addr
        watcher = threading.Thread(target=tune_watch, daemon=True,
                                   args=(root, addr, maddr, live, done))
        watcher.start()
        t0 = time.monotonic()
        fit_at = time.time()
        grid = tune.Tuner(
            TorchTrainer(
                tune_fn, train_loop_config={"dir": root,
                                            "lead_lr": TUNE_LRS[0]},
                scaling_config=ScalingConfig(
                    num_workers=1, resources_per_worker={"CPU": 1}),
                run_config=RunConfig(name="chip-smoke-tune",
                                     storage_path=os.path.join(root,
                                                               "ckpt"))),
            param_space={"lr": tune.grid_search(list(TUNE_LRS))},
            tune_config=tune.TuneConfig(
                metric="loss", mode="min", max_concurrent_trials=2,
                scheduler=tune.ASHAScheduler(
                    metric="loss", mode="min", grace_period=TUNE_GRACE,
                    reduction_factor=2, max_t=TUNE_STEPS + 1))).fit()
        fit_s = time.monotonic() - t0
        done.set()
        watcher.join(timeout=120)
        gate_ts = os.path.getmtime(os.path.join(root, "lead-done"))
        t0 = time.monotonic()
        with urllib.request.urlopen(
                f"http://{maddr[0]}:{maddr[1]}/metrics", timeout=30) as r:
            text = r.read().decode()
        for name in ("lead", "other"):
            if name not in live.get("series", {}):
                with open(os.path.join(root, f"{name}.json")) as f:
                    got = tune_series(text, json.load(f)["worker"])
                if all(got.values()):
                    live.setdefault("series_after_fit", []).append(name)
        devices = state.list_devices()
        evs = ray_tpu_torch.timeline(all_nodes=True)
        steps = [e for e in evs if e.get("cat") == "goodput"
                 and e.get("name") == "step"]
        goodput = {"lead": state.goodput_from_events(
            [e for e in steps if e["ts"] < gate_ts]),
            "other": state.goodput_from_events(
                [e for e in steps if e["ts"] > gate_ts])}
        pages = {}
        for page in ("/", "/goodput", "/devices", "/profile"):
            with urllib.request.urlopen(
                    f"http://{maddr[0]}:{maddr[1]}{page}", timeout=60) as r:
                pages[page] = (r.status, len(r.read()))
        clis = {" ".join(a): subprocess.Popen(
            [sys.executable, "-m", "ray_tpu_torch.scripts", *a,
             "--address", addr], stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)
            for a in (("status",), ("list", "actors"), ("goodput",))}
        cli_rc = {}
        for k, proc in clis.items():
            out, err = proc.communicate(timeout=120)
            cli_rc[k] = (proc.returncode, len(out.splitlines()), err[-300:])
        views_s = time.monotonic() - t0
    finally:
        done.set()
        ray_tpu_torch.shutdown()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    wait_card_back(free0, "the tune trials")
    by_lr = {r.config["lr"]: r for r in grid}
    win, lose = by_lr[TUNE_LRS[0]], by_lr[TUNE_LRS[1]]
    win_steps = [m for m in win.all_reports if "step" in m][:TUNE_STEPS]
    lose_steps = [m for m in lose.all_reports if "step" in m]
    got = [(m["loss"], m["grad_norm"]) for m in win_steps]
    want = want[:TUNE_STEPS]
    rel = max(abs(g[0] - w[0]) / abs(w[0]) for g, w in zip(got, want))
    rel_n = max(abs(g[1] - w[1]) / abs(w[1]) for g, w in zip(got, want))
    pids = {"lead": win_steps[0]["pid"], "other": lose_steps[0]["pid"]}
    hbm_rows = {k: [d for d in devices if d["kind"] == "hbm"
                    and d["pid"] == pid] for k, pid in pids.items()}
    print(f"tune [{card}]: Tuner over TorchTrainer trials (llama3_8b "
          f"widths at {TRAINER_LAYERS} layer(s), 'dots', 2 x 4096 tokens), "
          f"grid lr {list(TUNE_LRS)}, ASHA grace {TUNE_GRACE} max_t "
          f"{TUNE_STEPS + 1}, 2 trials at once on the card; fit "
          f"{fit_s:.1f} s; winner lr {win.config['lr']} {win.status} with "
          f"{len(win_steps)} step reports, losses {[g[0] for g in got]} vs "
          f"run_trainer's {[w[0] for w in want]} (max rel {rel:.2e}), grad "
          f"norms {[g[1] for g in got]} vs {[w[1] for w in want]} (max rel "
          f"{rel_n:.2e}; tol {TRAINER_REL_TOL} on each; bitwise "
          f"{got == want}); loser lr {lose.config['lr']} {lose.status} "
          f"after {len(lose_steps)} step reports, losses "
          f"{[m['loss'] for m in lose_steps]}")
    print(f"tune workers [{card}]: peak HBM (max_memory_allocated) winner "
          f"{win_steps[-1]['peak_hbm'] / 2**30:.2f} GiB, loser "
          f"{lose_steps[-1]['peak_hbm'] / 2**30:.2f} GiB; launches K1/K2/K3 "
          f"per step winner {[m['launches'] for m in win_steps]}, loser "
          f"{[m['launches'] for m in lose_steps]}; train_mfu (last step) "
          f"winner {win_steps[-1]['mfu']:.4f}, loser "
          f"{lose_steps[-1]['mfu']:.4f}; the winner's parameter save "
          f"{win_steps[-1]['save_s']:.2f} s; modules "
          f"{sorted({x for m in win_steps + lose_steps for x in m['foreign']})}")
    last = win_steps[-1]
    print(f"tune wall [{card}]: from fit() to tune_fn in the winner's "
          f"worker {last['t_start'] - fit_at:.1f} s (loser "
          f"{lose_steps[0]['t_start'] - fit_at:.1f}), its model built "
          f"{last['t_built'] - last['t_start']:.1f} s, {TUNE_STEPS} steps "
          f"{last['t_steps'] - last['t_built']:.1f} s, the save "
          f"{last['save_s']:.1f} s, then to fit()'s return "
          f"{fit_at + fit_s - last['t_steps'] - last['save_s']:.1f} s")
    print(f"tune live [{card}]: profile of the winner's worker "
          f"{live.get('profile')}; CLI stack {live.get('stack')}; /metrics "
          f"series found while fit() ran {live.get('series')}, after it "
          f"{live.get('series_after_fit')}; watcher error "
          f"{live.get('error')}")
    print(f"tune views [{card}]: list_devices HBM rows per worker "
          f"{ {k: len(v) for k, v in hbm_rows.items()} }; goodput rows "
          f"(split at the winner's last report) "
          f"{ {k: [(r['rank'], r['steps'], round(r['goodput_fraction'], 4)) for r in v] for k, v in goodput.items()} }; "
          f"pages {pages}; CLI {cli_rc}; {views_s:.1f} s")
    bad = []
    if live.get("error"):
        bad.append(f"watcher: {live['error']}")
    if win.status != "TERMINATED" or [m["step"] for m in win_steps] != \
            list(range(1, TUNE_STEPS + 1)):
        bad.append(f"winner {win.status}, steps "
                   f"{[m['step'] for m in win_steps]}")
    if lose.status != "STOPPED" or not \
            TUNE_GRACE <= len(lose_steps) < TUNE_STEPS:
        bad.append(f"loser {lose.status} after {len(lose_steps)} steps")
    if not lose_steps or lose_steps[TUNE_GRACE - 1]["loss"] <= \
            win_steps[TUNE_GRACE - 1]["loss"]:
        bad.append("the diverging trial did not lose at the rung")
    if any(m["launches"] != [TRAINER_LAYERS] * 3
           for m in win_steps + lose_steps):
        bad.append("launches per step")
    if max(rel, rel_n) > TRAINER_REL_TOL or not np.isfinite(got).all():
        bad.append("the winner's losses or grad norms differ from "
                   "run_trainer's")
    if any(m["foreign"] for m in win_steps + lose_steps):
        bad.append("a trial worker loaded jax or ray_tpu")
    prof = live.get("profile") or {}
    if prof.get("error") or not prof.get("samples") or \
            not prof.get("tune_fn"):
        bad.append(f"profile {prof}")
    if (live.get("stack") or {}).get("rc") != 0:
        bad.append(f"CLI stack {live.get('stack')}")
    if len(live.get("series", {})) + len(live.get("series_after_fit",
                                                  [])) != 2:
        bad.append("/metrics lacks a trial worker's series")
    if not all(hbm_rows.values()):
        bad.append("list_devices lacks a trial worker's HBM row")
    # the loser's worker goes on stepping until the controller's stop
    # kills it, past the reports that reached the scheduler
    if [len(v) for v in goodput.values()] != [1, 1] or \
            goodput["lead"][0]["steps"] != TUNE_STEPS or not \
            len(lose_steps) <= goodput["other"][0]["steps"] <= TUNE_STEPS:
        bad.append(f"goodput rows {goodput}")
    if any(v[0] != 200 for v in pages.values()) or \
            any(v[0] != 0 for v in cli_rc.values()):
        bad.append(f"pages {pages}, CLI {cli_rc}")
    if bad:
        shutil.rmtree(root, ignore_errors=True)
        raise SystemExit("the tune phase failed: " + "; ".join(bad))

    # serve the winner's checkpoint
    t0 = time.monotonic()
    cfg, model = _load_model(LLMConfig(
        model="llama3_8b", model_overrides=dict(n_layers=TRAINER_LAYERS,
                                                dtype="bfloat16"),
        checkpoint=win.checkpoint.path, device="cuda"))
    torch.cuda.synchronize()
    load_s = time.monotonic() - t0
    same = param_fingerprint(p.float() for p in model.parameters()) == \
        win_steps[-1]["fingerprint"]
    shutil.rmtree(root, ignore_errors=True)
    prompt = [int(t) for t in np.random.default_rng(7).integers(
        0, cfg.vocab_size, 200)]
    reset_serving_counts()
    reset_obs()
    (run,), wall, _, stats = serve(model, cfg, [prompt], TUNE_NEW)
    launches = serving_counts()
    decode = metric("llm_paged_attn_steps_total", impl="paged_flash")
    toks = run[0]["tokens"]
    print(f"tune serve [{card}]: the winner's checkpoint "
          f"({win.checkpoint.path.rsplit('/', 1)[-1]}) restored onto the "
          f"card in {load_s:.2f} s, weights bitwise the saved ones {same}; "
          f"{TUNE_NEW} greedy tokens for a {len(prompt)}-token prompt in "
          f"{wall:.2f} s: {toks}; launches {launches}, decode steps "
          f"{decode}")
    del model
    gc.collect()
    torch.cuda.empty_cache()
    print(f"tune [{card}]: phase {time.monotonic() - t_phase:.1f} s")
    if not same:
        raise SystemExit("the served weights are not the checkpoint's")
    if len(toks) != TUNE_NEW or not all(0 <= t < cfg.vocab_size
                                        for t in toks):
        raise SystemExit(f"the served winner generated {toks}")
    if launches["flash_attention_fwd"] != cfg.n_layers or decode <= 0 or \
            launches["paged_attention"] != decode * cfg.n_layers:
        raise SystemExit(f"serve launches {launches}, decode steps {decode}")
    return {"launches": [sum(m["launches"][i] for m in win_steps
                             + lose_steps) for i in range(3)],
            "serve": launches, "fit_s": fit_s}


# --- data-parallel training through the gradient ring and ZeRO-1 ---------
#
# Two TorchTrainer workers share the one card (no use_gpu: it would pin
# one card each), each training trainer_run's model cut to DP_LAYERS
# (Llama-3-8B widths, 1 layer, bf16, "dots", f32 logits; 1.27 B
# parameters) from the same seed on its half of trainer_run's batch (1 x
# 4096 tokens). Three modes
# of DP_MODE_STEPS steps: (A) train.allreduce_gradients(mean) and the
# replicated AdamW; (B) ShardedOptimizer over ShardAdamW, f32 wire; (C)
# the same with the int8 gradient reduce-scatter and the bf16 parameter
# allgather. The gradients and parameters cross the host ring (numpy over
# shm) between the two worker processes. A and B: each step's loss (the
# ranks' mean) and grad norm held to one process's step on the whole
# 2 x 4096 batch at the mesh tolerances (TRAIN_LOSS_REL_TOL,
# TRAIN_GNORM_REL_TOL: f32 gradient sums in another order, and ZeRO's
# f32 moments against the replicated AdamW's bf16 ones); A, B and C: the
# ranks' parameters bitwise equal after the steps (a fingerprint of every
# parameter's bits); C: the int8 reduce-scatter of step 1's gradients
# within the ring's documented bound of the f32 one (dag/ring.py:
# elementwise (N * max block scale) / 2 of the sum, the
# allreduce_quant_error gauge); B: the optim_shard_bytes gauge half of
# the replicated moments' bytes at the f32 wire.
# the one-process trajectory's steps: run_elastic's three steps are held
# to it too
DP_STEPS = 3
DP_MODES = {"A": "allreduce", "B": "zero", "C": "zero_int8_bf16"}
# C takes one step: its checks (the int8 bound on step 1's gradients, the
# ranks' parameters bitwise equal after the step) need no more, and each
# of its steps costs about 50 s of the script's time on the host ring. A
# and B take two, so that a step runs on parameters and moments the
# previous one updated (three until the RL phase needed the time: a step
# of B costs ~20 s, of A ~10 s).
DP_MODE_STEPS = {"A": 2, "B": 2, "C": 1}
# 2 until the pipeline phase came after it; at 1 the whole script stays
# inside its time (the ring's time goes with the parameters, most of
# them the embedding and the head at any depth). run_elastic's model too.
DP_LAYERS = 1


def dp_run():
    """(cfg, opt, state) of the data-parallel phase: trainer_run's model
    at DP_LAYERS and its optimizer, on torch.device("cuda") explicitly."""
    import torch  # in the body: see trainer_run
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.parallel import default_optimizer, make_train_step
    cfg = llama.llama3_8b(n_layers=DP_LAYERS, dtype="bfloat16",
                          remat_policy="dots",
                          logits_dtype="float32", ce_chunk=0)
    opt = default_optimizer(learning_rate=3e-4, warmup_steps=2,
                            total_steps=100)
    init_fn, _ = make_train_step(cfg, device=torch.device("cuda"),
                                 optimizer=opt)
    return cfg, opt, init_fn(torch.Generator(device="cuda").manual_seed(0))


def dp_batch(cfg, step: int) -> dict:
    """trainer_run's batch of ``step``: 2 x 4096 tokens."""
    toks = np.random.default_rng(100 + step).integers(
        0, cfg.vocab_size, (2, 4097))
    return {"tokens": toks[:, :-1], "targets": toks[:, 1:]}


def param_fingerprint(params) -> list:
    """Per parameter (2- or 4-byte elements), two int64 sums of its bits
    (plain and position-weighted), computed on the card in chunks: equal
    parameters give equal fingerprints, and one differing element
    changes them."""
    import torch  # in the body: see trainer_run
    out = []
    for p in params:
        bits = p.detach().reshape(-1).view(
            {2: torch.int16, 4: torch.int32}[p.element_size()])
        s0 = s1 = 0
        for a in range(0, bits.numel(), 1 << 26):
            b = bits[a:a + (1 << 26)].to(torch.int64)
            w = torch.arange(a, a + b.numel(), device=b.device) % 65521 + 1
            s0 += int(b.sum())
            s1 += int((b * w).sum())
        out.append([s0, s1])
    return out


def dp_fn(config):
    """The data-parallel phase's train_fn, in each of the two workers:
    DP_MODE_STEPS steps in each of config["modes"], from the same seed, on
    this rank's half of each batch; writes what it saw to
    config["out"]/rank<r>.json (the controller keeps only rank 0's
    reports). The host staging of the ring (dag/ring.py stage_flat and
    stage_leaf off the card, tensor_like back onto it) is timed by
    wrapping them here."""
    import torch  # in the body: see trainer_run
    import threading

    from ray_tpu_torch import train
    from ray_tpu_torch.dag import ring as ring_mod
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.ops import flash_attention as fa
    from ray_tpu_torch.parallel import ShardAdamW, mesh
    from ray_tpu_torch.train.zero import ShardedOptimizer
    from ray_tpu_torch.util import events

    stage_s = {"d2h": 0.0, "h2d": 0.0}

    def timed(fn, key):
        def wrapper(*a, **kw):
            t0 = time.monotonic()
            try:
                return fn(*a, **kw)
            finally:
                stage_s[key] += time.monotonic() - t0
        return wrapper
    ring_mod.stage_flat = timed(ring_mod.stage_flat, "d2h")
    ring_mod.stage_leaf = timed(ring_mod.stage_leaf, "d2h")
    ring_mod.tensor_like = timed(ring_mod.tensor_like, "h2d")

    def rss():
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS"):
                    return int(line.split()[1]) * 1024
        return 0

    peak = {"rss": 0}
    done = threading.Event()

    def sample():        # the host RSS peak of each mode, every 0.1 s
        while not done.wait(0.1):
            peak["rss"] = max(peak["rss"], rss())
    threading.Thread(target=sample, daemon=True).start()

    dev = torch.device("cuda")
    ctx = train.get_context()
    rank = ctx.get_world_rank()
    kerns = (fa.flash_attention_fwd, fa.flash_attention_bwd_dkv,
             fa.flash_attention_bwd_dq)
    out = {"rank": rank, "modes": {}}
    for mode in config["modes"]:
        cfg, opt, state = dp_run()
        params = list(state.params.parameters())
        n_params = sum(p.numel() for p in params)
        so = None
        if mode != "A":
            so = ShardedOptimizer(
                ShardAdamW(opt, device=dev),
                **({"grad_quantize": "int8", "param_wire_dtype": "bfloat16"}
                   if mode == "C" else {}))
            zstate = so.init([p.detach() for p in params])
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        peak["rss"] = rss()
        rec = {"loss": [], "grad_norm": [], "wall_s": [], "launches": [],
               "allreduce_s": 0.0, "rs_s": 0.0, "ag_s": 0.0, "d2h_s": 0.0,
               "h2d_s": 0.0, "wire_bytes": 0.0, "n_params": n_params,
               "shard_bytes": metric("optim_shard_bytes") if so else None}
        for step in range(1, DP_MODE_STEPS[mode] + 1):
            b = dp_batch(cfg, step)
            mine = {k: torch.as_tensor(v[rank:rank + 1], device=dev)
                    for k, v in b.items()}
            fa.flash_attention_fwd.lse_launches = 0
            for f in kerns[1:]:
                f.launches = 0
            def counters():
                return (hist("allreduce_round_s")[1],
                        hist("reduce_scatter_round_s")[1],
                        hist("allgather_round_s")[1],
                        metric("allreduce_bytes_total"), dict(stage_s))
            before = counters()
            torch.cuda.synchronize()
            t0 = time.monotonic()
            for p in params:
                p.grad = None
            loss = llama.loss_fn(state.params, mine, cfg)
            loss.backward()
            grads = [p.grad for p in params]
            if mode == "C" and step == 1:
                # the codec's bound at the real shape, on this step's
                # gradients: int8 against f32 over the same ring
                torch.cuda.synchronize()
                fwd_bwd = time.monotonic() - t0
                ring = ctx.gradient_sync_ring()
                host = ring_mod.stage_flat(grads)[0]
                exact = ring.reduce_scatter(host, op="mean")
                quant = ring.reduce_scatter(host, op="mean",
                                            quantize="int8")
                del host
                rec["int8_err"] = float(np.abs(quant - exact).max())
                rec["int8_bound"] = float(
                    ring_mod.last_quant_error("int8"))
                del exact, quant
                torch.cuda.synchronize()
                # the check's rounds, staging and time are not the step's
                before = counters()
                t0 = time.monotonic() - fwd_bwd
            if so is None:
                grads = train.allreduce_gradients(grads, op="mean")
                gnorm = mesh.global_norm(grads)
                opt.update(state.opt_state, params, grads, gnorm)
                gnorm = gnorm.item()
            else:
                new, zstate = so.update(grads, zstate,
                                        [p.detach() for p in params])
                with torch.no_grad():
                    for p, q in zip(params, new):
                        p.copy_(q)
                del new
                gnorm = so.grad_norm
            del grads
            torch.cuda.synchronize()
            rec["wall_s"].append(time.monotonic() - t0)
            rec["loss"].append(loss.item())
            rec["grad_norm"].append(gnorm)
            rec["launches"].append([fa.flash_attention_fwd.lse_launches,
                                    kerns[1].launches, kerns[2].launches])
            rec["allreduce_s"] += hist("allreduce_round_s")[1] - before[0]
            rec["rs_s"] += hist("reduce_scatter_round_s")[1] - before[1]
            rec["ag_s"] += hist("allgather_round_s")[1] - before[2]
            rec["wire_bytes"] += metric("allreduce_bytes_total") - before[3]
            rec["d2h_s"] += stage_s["d2h"] - before[4]["d2h"]
            rec["h2d_s"] += stage_s["h2d"] - before[4]["h2d"]
        rec["fingerprint"] = param_fingerprint(params)
        rec["peak_hbm"] = torch.cuda.max_memory_allocated()
        rec["rss_peak"] = peak["rss"]
        out["modes"][mode] = rec
        del state, params, so, loss
        if mode != "A":
            del zstate
        gc.collect()
        torch.cuda.empty_cache()
    done.set()
    out["foreign"] = foreign_modules()
    out["compiles"] = [e.get("fn") for e in events.dump()
                       if e.get("name") == "compile"]
    with open(os.path.join(config["out"], f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    train.report({"done": True})


def dp_trajectory():
    """``(want, moment_bytes, cfg)``: one process's DP_STEPS steps of
    dp_run's model on the whole of each dp_batch, [(loss, grad norm)];
    the replicated moments' bytes at the f32 wire; the model's config.
    The model is freed before it returns."""
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.parallel import mesh
    cfg, opt, state = dp_run()
    params = list(state.params.parameters())
    want = []
    for step in range(1, DP_STEPS + 1):
        b = {k: torch.as_tensor(v, device="cuda")
             for k, v in dp_batch(cfg, step).items()}
        for p in params:
            p.grad = None
        loss = llama.loss_fn(state.params, b, cfg)
        loss.backward()
        grads = [p.grad for p in params]
        gnorm = mesh.global_norm(grads)
        opt.update(state.opt_state, params, grads, gnorm)
        want.append((loss.item(), gnorm.item()))
    moment_bytes = 2 * 4 * sum(p.numel() for p in params)   # f32 wire
    del state, params, grads, loss, b
    gc.collect()
    torch.cuda.empty_cache()
    return want, moment_bytes, cfg


def run_dp(card: str) -> dict:
    """The data-parallel phase (see DP_MODES above): one process's
    DP_STEPS steps on the whole batch in this process first (then
    freed), then init() and TorchTrainer(ScalingConfig(num_workers=2,
    resources_per_worker={"CPU": 1})) running dp_fn in two workers on the
    card. Checks the losses and grad norms (A, B), the ranks' parameters
    bitwise equal (A, B, C), K1/K2/K3 launched n_layers times a step on
    each rank, the int8 bound (C), the shard gauge (B), no nvcc and no
    jax or ray_tpu in either worker; prints per mode the step walls, the
    ring's seconds (reduce-scatter, allgather, fused allreduce, host
    staging each way), wire bytes per rank per step, peak HBM and host
    RSS per worker."""
    import shutil
    import tempfile

    import ray_tpu_torch
    from ray_tpu_torch.train import RunConfig, ScalingConfig, TorchTrainer
    want, moment_bytes, cfg = dp_trajectory()
    page = os.sysconf("SC_PAGE_SIZE")
    print(f"dp host [{card}]: RAM free "
          f"{os.sysconf('SC_AVPHYS_PAGES') * page / 2**30:.1f} of "
          f"{os.sysconf('SC_PHYS_PAGES') * page / 2**30:.1f} GiB; /dev/shm "
          f"(total, free) {shm_size()} bytes")
    root = tempfile.mkdtemp(prefix="chip_smoke_dp_")
    free0 = torch.cuda.mem_get_info()[0]
    ray_tpu_torch.init(num_cpus=4)
    try:
        t0 = time.monotonic()
        res = TorchTrainer(
            dp_fn, train_loop_config={"modes": list(DP_MODES),
                                      "out": root},
            scaling_config=ScalingConfig(num_workers=2,
                                         resources_per_worker={"CPU": 1}),
            run_config=RunConfig(name="chip-smoke-dp",
                                 storage_path=os.path.join(root, "ckpt"))
        ).fit()
        fit_s = time.monotonic() - t0
        if res.error is not None:
            raise SystemExit(f"the data-parallel trainer failed: "
                             f"{res.error}")
        ranks = []
        for r in range(2):
            with open(os.path.join(root, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
    finally:
        ray_tpu_torch.shutdown()
        shutil.rmtree(root, ignore_errors=True)
    wait_card_back(free0, "the data-parallel workers")
    bad = []
    for mode, what in DP_MODES.items():
        a, b = ranks[0]["modes"][mode], ranks[1]["modes"][mode]
        losses = [(x + y) / 2 for x, y in zip(a["loss"], b["loss"])]
        rel = max(abs(g - w[0]) / abs(w[0]) for g, w in zip(losses, want))
        rel_n = max(abs(g - w[1]) / abs(w[1])
                    for g, w in zip(a["grad_norm"], want))
        same = a["fingerprint"] == b["fingerprint"]
        same_n = a["grad_norm"] == b["grad_norm"]
        print(f"dp {mode} ({what}) [{card}]: 2 workers on the card, "
              f"llama3_8b widths at {cfg.n_layers} layers, 1 x 4096 "
              f"tokens each; losses {losses} vs one process's "
              f"{[w[0] for w in want]} (max rel {rel:.2e}, tol "
              f"{TRAIN_LOSS_REL_TOL}), grad norms {a['grad_norm']} vs "
              f"{[w[1] for w in want]} (max rel {rel_n:.2e}, tol "
              f"{TRAIN_GNORM_REL_TOL}); ranks' grad norms equal {same_n}, "
              f"parameters bitwise equal {same}; launches K1/K2/K3 per "
              f"step {a['launches']} and {b['launches']}")
        for r, rec in enumerate((a, b)):
            steps = len(rec["wall_s"])
            print(f"dp {mode} rank {r} [{card}]: step walls "
                  f"{['%.3f' % w for w in rec['wall_s']]} s; ring per step "
                  f"(s): reduce-scatter {rec['rs_s'] / steps:.3f}, "
                  f"allgather {rec['ag_s'] / steps:.3f}, allreduce "
                  f"(fused) {rec['allreduce_s'] / steps:.3f}, staging "
                  f"device->host {rec['d2h_s'] / steps:.3f}, host->device "
                  f"{rec['h2d_s'] / steps:.3f}; wire bytes per step "
                  f"{rec['wire_bytes'] / steps:.0f}; peak HBM "
                  f"{rec['peak_hbm'] / 2**30:.2f} GiB; peak host RSS "
                  f"{rec['rss_peak'] / 2**30:.2f} GiB")
        if mode in ("A", "B") and (rel > TRAIN_LOSS_REL_TOL
                                   or rel_n > TRAIN_GNORM_REL_TOL):
            bad.append(f"{mode}: losses or grad norms off one process's")
        if not (same and same_n):
            bad.append(f"{mode}: the ranks' parameters or norms differ")
        if not all(np.isfinite(a["loss"] + b["loss"] + a["grad_norm"])):
            bad.append(f"{mode}: non-finite loss or grad norm")
        for rec in (a, b):
            if rec["launches"] != \
                    [[cfg.n_layers] * 3] * DP_MODE_STEPS[mode]:
                bad.append(f"{mode}: launches {rec['launches']}")
        if mode == "B":
            for rec in (a, b):
                if abs(rec["shard_bytes"] - moment_bytes / 2) > 16:
                    bad.append(f"B: optim_shard_bytes {rec['shard_bytes']}"
                               f" is not half of {moment_bytes}")
            print(f"dp B shard [{card}]: optim_shard_bytes "
                  f"{[rec['shard_bytes'] for rec in (a, b)]} against the "
                  f"replicated moments' {moment_bytes} bytes at the f32 "
                  f"wire")
        if mode == "C":
            for r, rec in enumerate((a, b)):
                print(f"dp C int8 [{card}] rank {r}: step 1's gradient "
                      f"reduce-scatter, int8 against f32: max abs err "
                      f"{rec['int8_err']:.3e}, the ring's bound "
                      f"{rec['int8_bound']:.3e}")
                if not rec["int8_err"] <= rec["int8_bound"]:
                    bad.append(f"C: int8 error over its bound on rank {r}")
    for r in ranks:
        if r["foreign"] or r["compiles"]:
            bad.append(f"rank {r['rank']}: modules {r['foreign']}, nvcc "
                       f"builds {r['compiles']}")
    print(f"dp [{card}]: fit {fit_s:.1f} s for modes x steps "
          f"{DP_MODE_STEPS}; workers' jax/ray_tpu modules "
          f"{[r['foreign'] for r in ranks]}, nvcc builds "
          f"{[r['compiles'] for r in ranks]}")
    if bad:
        raise SystemExit("the data-parallel phase failed: " + "; ".join(bad))
    launches = {name: [sum(sum(s[i] for s in ranks[r]["modes"][m]["launches"])
                           for r in range(2) for m in ms)
                       for i in range(3)]
                for name, ms in (("train_dp_allreduce", ("A",)),
                                 ("train_dp_zero", ("B", "C")))}
    return {"launches": launches, "want": want}


# --- the in-place elastic reshape: a ZeRO-1 group losing a worker ----------
#
# run_dp's model, optimizer and batches in two TorchTrainer workers on the
# card, an elastic group (num_workers=(1, 2)) whose ShardedOptimizer
# mirrors each rank's ShardAdamW shard to its ring successor after init
# and after every step (mirror_interval_steps=1: two f32 moments of the
# half shard, 5.08 GB, staged once into shared memory). At step 2 rank 1
# dies (SIGKILL after its backward, before the reduce-scatter, once rank 0
# has finished its own backward, so both step-1 mirrors have landed and
# rank 0 is entering the reduce-scatter); rank 0, blocked in it, gets
# PeerLostError when the controller's rewire aborts the ring,
# await_regroup()s, reshard()s its moments with rank 1's mirror to the
# whole space on the card, retries step 2 on the whole batch and runs
# step 3. Held to run_dp's one-process trajectory at mode B's bars.
ELASTIC_STEPS = 3
ELASTIC_DIE_AT = 2
# mode B of run_dp measured 9.5e-06 (loss) and 3.5e-06 (grad norm) from
# one process on the H100 (PERF.md §5): f32 sums in another order. A
# moment segment lost or restored from a stale mirror moves the loss of
# the next steps by far more (Adam's first steps move every weight by
# ~lr).
ELASTIC_LOSS_REL_TOL = 1e-4
ELASTIC_GNORM_REL_TOL = 1e-3


def elastic_fn(config):
    """Each worker of the elastic phase: ELASTIC_STEPS steps on this
    rank's slice of dp_batch at the current world size, ZeRO-1 with a
    peer mirror every step. Rank 1 of the first incarnation writes what
    it saw to config["out"]/victim.json and config["marker"] (the wall
    time) and SIGKILLs itself at ELASTIC_DIE_AT after its backward, once
    rank 0 has marked its own backward done; the survivor writes
    config["out"]/survivor.json at the end."""
    import torch  # in the body: see trainer_run
    import signal
    import threading

    import ray_tpu_torch
    from ray_tpu_torch import train
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.ops import flash_attention as fa
    from ray_tpu_torch.parallel import ShardAdamW
    from ray_tpu_torch.train.zero import ShardedOptimizer
    from ray_tpu_torch.util import events, forensics

    def rss():
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS"):
                    return int(line.split()[1]) * 1024
        return 0

    peak = {"rss": rss()}
    done = threading.Event()

    def sample():
        while not done.wait(0.1):
            peak["rss"] = max(peak["rss"], rss())
    threading.Thread(target=sample, daemon=True).start()

    mirrors = []            # per posted mirror: step, bytes, seconds
    snapshot = ShardedOptimizer._snapshot

    def timed_snapshot(self, state):
        t0 = time.monotonic()
        blob = snapshot(self, state)
        mirrors.append({"step": blob["step"],
                        "bytes": blob["leaves"].nbytes,
                        "stage_s": time.monotonic() - t0})
        return blob
    ShardedOptimizer._snapshot = timed_snapshot

    # the controller's worker_death audit pulls this process's postmortem
    # dump (TrainWorker.forensics_dump on the actor thread): the card's
    # allocated bytes just before and after it, for its HBM row
    dumps = []
    local_dump = forensics.local_dump

    def measured_dump():
        before = torch.cuda.memory_allocated()
        out = local_dump()
        dumps.append({"before": before, "at": time.time(),
                      "after": torch.cuda.memory_allocated()})
        return out
    forensics.local_dump = measured_dump

    ctx = train.get_context()

    def landed():
        t0 = time.monotonic()
        ok = ctx.wait_mirror(timeout_s=600)
        mirrors[-1].update(landed=ok, land_wait_s=time.monotonic() - t0)

    dev = torch.device("cuda")
    cfg, opt, state = dp_run()
    params = list(state.params.parameters())
    so = ShardedOptimizer(ShardAdamW(opt, device=dev),
                          mirror_interval_steps=1)
    zstate = so.init([p.detach() for p in params])
    landed()
    fa.flash_attention_fwd.lse_launches = 0
    fa.flash_attention_bwd_dkv.launches = 0
    fa.flash_attention_bwd_dq.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rec = {"steps": [], "mirrors": mirrors, "dumps": dumps}

    def counts():
        return [fa.flash_attention_fwd.lse_launches,
                fa.flash_attention_bwd_dkv.launches,
                fa.flash_attention_bwd_dq.launches]

    def finish(name):
        done.set()
        rec.update(launches=counts(), rank=ctx.get_world_rank(),
                   peak_hbm=torch.cuda.max_memory_allocated(),
                   rss_peak=peak["rss"], foreign=foreign_modules(),
                   compiles=[e.get("fn") for e in events.dump()
                             if e.get("name") == "compile"])
        with open(os.path.join(config["out"], name), "w") as f:
            json.dump(rec, f)

    rec["n_layers"] = cfg.n_layers
    step = 1
    while step <= ELASTIC_STEPS:
        world, rank = ctx.get_world_size(), ctx.get_world_rank()
        rows = 2 // world
        mine = {k: torch.as_tensor(v[rank * rows:(rank + 1) * rows],
                                   device=dev)
                for k, v in dp_batch(cfg, step).items()}
        torch.cuda.synchronize()
        t0 = time.monotonic()
        for p in params:
            p.grad = None
        loss = llama.loss_fn(state.params, mine, cfg)
        loss.backward()
        entering = os.path.join(config["out"], "rank0_entering")
        if step == ELASTIC_DIE_AT and rank == 0 and ctx.generation == 0:
            open(entering, "w").close()
        if step == ELASTIC_DIE_AT and rank == 1 and ctx.generation == 0:
            # die once rank 0 has its backward too: both step-1 mirrors
            # have landed, and rank 0 is entering the reduce-scatter the
            # kill then leaves in flight
            deadline = time.monotonic() + 300
            while not os.path.exists(entering):
                if time.monotonic() > deadline:
                    raise RuntimeError("rank 0 never reached step 2")
                time.sleep(0.01)
            rec["moments_fp"] = param_fingerprint([zstate.mu, zstate.nu])
            finish("victim.json")
            with open(config["marker"], "w") as f:
                f.write(repr(time.time()))
            os.kill(os.getpid(), signal.SIGKILL)
        try:
            new, zstate = so.update([p.grad for p in params], zstate,
                                    [p.detach() for p in params])
        except train.PeerLostError as e:
            rec["lost_at"] = time.time()
            rec["lost_error"] = str(e)[:200]
            old_fp = param_fingerprint([zstate.mu, zstate.nu])
            cut = zstate.mu.numel()
            rec["regroup"] = train.await_regroup(timeout_s=300)
            t_r = time.monotonic()
            zstate = so.reshard(zstate)
            torch.cuda.synchronize()
            rec["reshard_wall_s"] = time.monotonic() - t_r
            rec["reshard_round_s"] = hist("train_reshard_round_s")[1]
            rec["reshard_event"] = [
                {k: e_[k] for k in ("dur", "size", "mirrors",
                                    "staleness_steps")}
                for e_ in events.dump() if e_.get("name") == "reshard"]
            rec["moments"] = {
                "dtype": str(zstate.mu.dtype),
                "device": str(zstate.mu.device), "count": zstate.count,
                "numel": zstate.mu.numel(), "cut": cut,
                "own_equal": param_fingerprint(
                    [zstate.mu[:cut], zstate.nu[:cut]]) == old_fp,
                "mirror_fp": param_fingerprint(
                    [zstate.mu[cut:], zstate.nu[cut:]])}
            continue                # retry the step on the whole batch
        with torch.no_grad():
            for p, q in zip(params, new):
                p.copy_(q)
        del new
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        if world > 1:
            landed()
        rec["steps"].append({"step": step, "world": world,
                             "loss": loss.item(), "grad_norm": so.grad_norm,
                             "wall_s": wall})
        train.report({"step": step, "world": world,
                      "generation": ctx.generation})
        rec["steps"][-1]["reported_at"] = time.time()
        step += 1
    status = ray_tpu_torch.get(
        train.get_controller(config["run"]).status.remote(), timeout=60)
    rec["restarts"] = status["restarts"]
    rec["lost_steps"] = status["lost_steps"]
    finish("survivor.json")


def run_elastic(card: str, want: list) -> dict:
    """The elastic phase (see the comment block above): init() and
    TorchTrainer(ScalingConfig(num_workers=(1, 2), resources_per_worker=
    {"CPU": 1}, sync_timeout_s=60, elastic_grow_interval_s=0)) running
    elastic_fn in two workers on the card; ``want`` is run_dp's
    one-process trajectory (loss, grad norm) of dp_batch's 3 steps.
    Checks every step reported once, worlds [2, 1, 1], generation 1, one
    reshard restart and no lost step, the reshard's staleness 0, losses
    and grad norms at ELASTIC_*_REL_TOL, the survivor's moments right
    after the reshard bitwise its old shard and then the victim's, K1/K2/
    K3 8 times each in the survivor, and no nvcc, jax or ray_tpu in
    either worker; prints recovery seconds, the reshard round, each
    mirror's bytes and seconds, step walls, peak HBM and host RSS per
    worker and the phase's wall."""
    import shutil
    import tempfile

    import ray_tpu_torch
    from ray_tpu_torch.train import (FailureConfig, RunConfig,
                                     ScalingConfig, TorchTrainer)
    t_phase = time.monotonic()
    root = tempfile.mkdtemp(prefix="chip_smoke_elastic_")
    marker = os.path.join(root, "victim_died_at")
    fx_dir = os.path.join(root, "forensics")
    # the controller actor's process reads its bundle directory from the
    # environment it inherits
    fx_saved = os.environ.get("RAY_TPU_FORENSICS_DIR")
    os.environ["RAY_TPU_FORENSICS_DIR"] = fx_dir
    free0 = torch.cuda.mem_get_info()[0]
    ray_tpu_torch.init(num_cpus=4)
    try:
        res = TorchTrainer(
            elastic_fn, train_loop_config={
                "out": root, "marker": marker, "run": "chip-smoke-elastic"},
            scaling_config=ScalingConfig(
                num_workers=(1, 2), resources_per_worker={"CPU": 1},
                sync_timeout_s=60.0, elastic_grow_interval_s=0.0),
            run_config=RunConfig(
                name="chip-smoke-elastic",
                storage_path=os.path.join(root, "ckpt"),
                failure_config=FailureConfig(max_failures=1))).fit()
        if res.error is not None:
            raise SystemExit(f"the elastic trainer failed: {res.error}")
        with open(os.path.join(root, "survivor.json")) as f:
            surv = json.load(f)
        with open(os.path.join(root, "victim.json")) as f:
            vict = json.load(f)
        with open(marker) as f:
            died_at = float(f.read())
        bundles = {}
        for name in sorted(os.listdir(fx_dir)) if os.path.isdir(fx_dir) \
                else []:
            with open(os.path.join(fx_dir, name)) as f:
                bundles[name] = json.load(f)
    finally:
        ray_tpu_torch.shutdown()
        shutil.rmtree(root, ignore_errors=True)
        if fx_saved is None:
            os.environ.pop("RAY_TPU_FORENSICS_DIR", None)
        else:
            os.environ["RAY_TPU_FORENSICS_DIR"] = fx_saved
    wait_card_back(free0, "the elastic workers")
    phase_s = time.monotonic() - t_phase
    hist_ = [m for m in res.metrics_history if "step" in m]
    steps = surv["steps"]
    losses = [(steps[0]["loss"] + vict["steps"][0]["loss"]) / 2] + \
        [s["loss"] for s in steps[1:]]
    norms = [s["grad_norm"] for s in steps]
    rel = max(abs(g - w[0]) / abs(w[0]) for g, w in zip(losses, want))
    rel_n = max(abs(g - w[1]) / abs(w[1]) for g, w in zip(norms, want))
    after = [s for s in steps if s["world"] == 1]
    recovery_s = after[0]["reported_at"] - died_at
    ev = surv["reshard_event"]
    mo = surv["moments"]
    bad = []
    if [m["step"] for m in hist_] != list(range(1, ELASTIC_STEPS + 1)):
        bad.append(f"steps reported {[m['step'] for m in hist_]}")
    if [m["world"] for m in hist_] != [2, 1, 1]:
        bad.append(f"worlds {[m['world'] for m in hist_]}")
    if hist_ and hist_[-1]["generation"] != 1:
        bad.append(f"generation {hist_[-1]['generation']}")
    if surv["restarts"] != {"reshard": 1.0} or surv["lost_steps"] != 0:
        bad.append(f"recoveries {surv['restarts']}, lost steps "
                   f"{surv['lost_steps']}")
    if len(ev) != 1 or ev[0]["staleness_steps"] != 0 \
            or ev[0]["mirrors"] != 1 or ev[0]["size"] != 1:
        bad.append(f"reshard events {ev}")
    if not (rel <= ELASTIC_LOSS_REL_TOL and rel_n <= ELASTIC_GNORM_REL_TOL):
        bad.append(f"losses {losses} or grad norms {norms} off one "
                   f"process's {want}")
    if not all(np.isfinite(losses + norms)):
        bad.append("non-finite loss or grad norm")
    if not (mo["own_equal"] and mo["mirror_fp"] == vict["moments_fp"]
            and mo["dtype"] == "torch.float32"
            and mo["device"].startswith("cuda") and mo["count"] == 1):
        bad.append(f"the resharded moments are not the old shard and the "
                   f"mirror: {mo}")
    # the survivor's forward-backward passes: steps 1 and 2 at world 2,
    # step 2's retry and step 3 at world 1; the victim's: steps 1 and 2
    layers = surv["n_layers"]
    if surv["launches"] != [4 * layers] * 3 \
            or vict["launches"] != [2 * layers] * 3:
        bad.append(f"launches K1/K2/K3: survivor {surv['launches']}, "
                   f"victim {vict['launches']}")
    for r in (surv, vict):
        if r["foreign"] or r["compiles"]:
            bad.append(f"rank {r['rank']}: modules {r['foreign']}, nvcc "
                       f"builds {r['compiles']}")
    if not all(m.get("landed") for m in surv["mirrors"] + vict["mirrors"]):
        bad.append("a mirror did not land")
    print(f"elastic [{card}]: 2 workers on the card, llama3_8b widths at "
          f"{layers} layers, ZeRO-1 with a peer mirror a step; "
          f"rank 1 SIGKILLed at step {ELASTIC_DIE_AT} after its backward; "
          f"steps {[m['step'] for m in hist_]} at worlds "
          f"{[m['world'] for m in hist_]}, generation "
          f"{hist_[-1]['generation'] if hist_ else None}; recoveries "
          f"{surv['restarts']}, lost steps {surv['lost_steps']}; losses "
          f"{losses} vs one process's {[w[0] for w in want]} (max rel "
          f"{rel:.2e}, tol {ELASTIC_LOSS_REL_TOL}), grad norms {norms} vs "
          f"{[w[1] for w in want]} (max rel {rel_n:.2e}, tol "
          f"{ELASTIC_GNORM_REL_TOL})")
    print(f"elastic reshard [{card}]: the survivor's PeerLostError "
          f"{surv['lost_at'] - died_at:.3f} s after the victim's death "
          f"({surv['lost_error']!r}); train_reshard_round_s "
          f"{surv['reshard_round_s']:.3f} s (wall with sync "
          f"{surv['reshard_wall_s']:.3f} s), event {ev}; moments after it "
          f"{mo['numel']} {mo['dtype']} on {mo['device']}, count "
          f"{mo['count']}, [0, {mo['cut']}) bitwise the old shard "
          f"{mo['own_equal']}, the rest bitwise the victim's live moments "
          f"{mo['mirror_fp'] == vict['moments_fp']}; recovery (victim's "
          f"death to the survivor's first report at world 1) "
          f"{recovery_s:.3f} s")
    for who, r in (("survivor", surv), ("victim", vict)):
        for m in r["mirrors"]:
            print(f"elastic mirror [{card}] {who}: step {m['step']}, "
                  f"{m['bytes']} bytes, staged in {m['stage_s']:.3f} s, "
                  f"landed {m.get('land_wait_s', float('nan')):.3f} s after "
                  f"posting")
        print(f"elastic {who} [{card}]: step walls "
              f"{[(s['world'], round(s['wall_s'], 3)) for s in r['steps']]}"
              f" (world, s); launches K1/K2/K3 {r['launches']}; peak HBM "
              f"{r['peak_hbm'] / 2**30:.2f} GiB; peak host RSS "
              f"{r['rss_peak'] / 2**30:.2f} GiB; modules {r['foreign']}, "
              f"nvcc builds {r['compiles']}")
    deaths = {n: b for n, b in bundles.items()
              if b.get("trigger") == "worker_death"}
    (bname, bundle), = deaths.items() if len(deaths) == 1 else \
        ((None, {}),)
    dump = (bundle.get("ranks") or {}).get(str(surv["rank"])) or {}
    # the round the kill caught: still in flight when the controller
    # pulled the dump, or already aborted by the survivor's PeerLostError
    inflight = [e for e in (dump.get("ledger") or {}).get("entries", ())
                if e.get("state") in ("in_flight", "aborted")]
    rows = [r for r in dump.get("hbm") or () if r["device"] == "cuda:0"]
    measured = surv["dumps"][0] if surv["dumps"] else {}
    print(f"elastic postmortem [{card}]: bundles {sorted(bundles)}; "
          f"worker_death bundle {bname} ({fx_dir}/{bname}, removed with "
          f"the phase's directory), audit findings "
          f"{bundle.get('findings')}, ranks {sorted(bundle.get('ranks') or {})}; "
          f"the survivor's ledger in flight at the kill "
          f"{[{k: e.get(k) for k in ('group', 'seq', 'kind', 'op', 'state', 'bytes', 'step')} for e in inflight]}; "
          f"its HBM row {rows} vs torch.cuda.memory_allocated around the "
          f"dump {measured}; recovery {recovery_s:.3f} s, the audit "
          f"included")
    if bname is None:
        bad.append(f"no single worker_death bundle: {sorted(bundles)}")
    if not inflight:
        bad.append("the survivor's ledger holds no round in flight")
    if len(rows) != 1 or not measured or not (
            min(measured["before"], measured["after"]) <= rows[0]["used"]
            <= max(measured["before"], measured["after"])):
        bad.append(f"the survivor's HBM row {rows} vs {measured}")
    print(f"elastic [{card}]: phase {phase_s:.1f} s")
    if bad:
        raise SystemExit("the elastic phase failed: " + "; ".join(bad))
    return {"launches": {"train_dp_elastic": [
        surv["launches"][i] + vict["launches"][i] for i in range(3)]}}


# --- pipeline parallelism: two stage actors on the card --------------------
#
# Llama-3-8B at full width cut to PIPE_LAYERS layers, bf16, random weights
# from PIPE_SEED: stage 0 holds the embedding and layer 0, stage 1 layer
# 1, the final norm, lm_head and the chunked cross-entropy (about 0.74 B
# parameters each; 4 layers until the RL phase needed the time, which
# goes with the checkpoint's bytes, most of them the embedding's and the
# head's at any depth). Each stage is a PipelineStageActor in a
# worker process of its own on the card whose stage function runs the
# port's model pieces (llama._layer, _rmsnorm, _rope_tables,
# fused_cross_entropy) through torch.func.functional_call; the
# optimizer is optax.sgd's shape over tensors. train.Pipeline drives
# 1f1b over PIPE_MB microbatches of 1 x 4096 tokens. Run A: PIPE_STEPS
# steps over the device transport (TensorRef handles in the shm rings,
# each fetched through its owner's host memory), save_checkpoint after
# step PIPE_SAVE_AFTER, its losses held to one process's steps on the
# same weights (the per-microbatch gradients summed in bf16, divided by
# PIPE_MB, the same SGD). Run B: two new stages from other weights,
# restore_checkpoint, then the last step over the host transport (the
# activations in the channels' frames): its loss and both stages'
# parameters bitwise run A's last step's.
PIPE_LAYERS = 2
PIPE_MB = 4
PIPE_STEPS = 3
PIPE_SAVE_AFTER = 2
PIPE_SEED = 7
PIPE_LR = 0.5
PIPE_CE_CHUNK = 1024
# Step 1: the same weights and the same forward without grad on the same
# values in both runs, so the mean loss is expected bit for bit equal
# (printed); the bound allows the f32 rounding of the loss's sums in
# another order. Later steps start from weights updated by gradients
# that each run sums in its own order: TRAIN_LOSS_REL_TOL.
PIPE_STEP1_REL_TOL = 1e-4
# K1, K1 with lse, K2, K3 per stage process per step: a stage's layers x
# the microbatches (each F op runs K1 without lse, each B op recomputes
# the forward with K1 with lse and runs K2 and K3).
PIPE_LAUNCHES_PER_STEP = PIPE_LAYERS // 2 * PIPE_MB
# the host transport's shm slots: one frame holds a microbatch's
# activation (1 x 4096 x 4096 bf16, 32 MiB) and its targets
PIPE_SLOT_BYTES = 40 << 20
# the object store's capacity for the phase: both stages' restore blobs
# are in it at once
PIPE_STORE_BYTES = 12 << 30
PIPE_LAYER_PARAMS = ("attn_norm", "wq", "wk", "wv", "wo", "mlp_norm",
                     "w_gate", "w_up", "w_down")


def pipe_cfg():
    from ray_tpu_torch.models import llama
    return llama.llama3_8b(n_layers=PIPE_LAYERS, dtype="bfloat16",
                           logits_dtype="float32")


def pipe_layout(cfg, stage: int) -> list:
    """(name, shape, fan_in, global index) of stage ``stage``'s
    parameters, named as PipeStageBody's; fan_in 0 marks a norm (ones).
    The global index seeds each tensor's draw, so a stage draws only its
    own tensors and the one-process reference draws the same ones."""
    d, f, v = cfg.dim, cfg.ffn_dim, cfg.vocab_size
    h, kvh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    shapes = {"attn_norm": ((d,), 0), "wq": ((h * hd, d), d),
              "wk": ((kvh * hd, d), d), "wv": ((kvh * hd, d), d),
              "wo": ((d, h * hd), h * hd), "mlp_norm": ((d,), 0),
              "w_gate": ((f, d), d), "w_up": ((f, d), d),
              "w_down": ((d, f), f)}
    half = cfg.n_layers // 2
    out, idx = [], 0
    if stage == 0:
        out.append(("embed.weight", (v, d), d, idx))
    idx += 1
    for i in range(cfg.n_layers):
        for name in PIPE_LAYER_PARAMS:
            shape, fan_in = shapes[name]
            suffix = name if name.endswith("norm") else f"{name}.weight"
            if (i < half) == (stage == 0):
                out.append((f"layers.{i % half}.{suffix}", shape, fan_in,
                            idx))
            idx += 1
    if stage == 1:
        out.append(("final_norm", (d,), 0, idx))
        out.append(("lm_head.weight", (v, d), d, idx + 1))
    return out


@torch.no_grad()
def pipe_params(cfg, stage: int, seed: int) -> dict:
    """Stage ``stage``'s bf16 parameters on the card: normal(0, 1) *
    fan_in^-0.5 drawn in f32 from a generator per tensor, norms at one."""
    out = {}
    for name, shape, fan_in, idx in pipe_layout(cfg, stage):
        if fan_in == 0:
            out[name] = torch.ones(shape, dtype=torch.bfloat16,
                                   device="cuda")
            continue
        gen = torch.Generator(device="cuda").manual_seed(
            seed * 100003 + idx)
        out[name] = (torch.randn(shape, generator=gen, device="cuda")
                     * fan_in ** -0.5).to(torch.bfloat16)
    return out


def pipe_body(cfg, stage: int):
    """Stage ``stage`` as a module on the meta device: it only names the
    parameters that functional_call hands in."""
    from torch import nn

    from ray_tpu_torch.models import llama

    class PipeStageBody(nn.Module):
        def __init__(self):
            super().__init__()
            f = dict(device="meta", dtype=torch.bfloat16)
            if stage == 0:
                self.embed = nn.Embedding(cfg.vocab_size, cfg.dim, **f)
            self.layers = nn.ModuleList(
                llama.LlamaLayer(cfg, **f)
                for _ in range(cfg.n_layers // 2))
            if stage == 1:
                self.final_norm = nn.Parameter(torch.empty(cfg.dim, **f))
                self.lm_head = nn.Linear(cfg.dim, cfg.vocab_size,
                                         bias=False, **f)

        def forward(self, x, targets):
            if stage == 0:
                x = self.embed(x)
            b, s, _ = x.shape
            pos = torch.arange(s, dtype=torch.int32, device=x.device)
            rc, rs = llama._rope_tables(pos[None].expand(b, s),
                                        cfg.head_dim, cfg.rope_theta)
            for lyr in self.layers:
                x = llama._layer(lyr, x, rc, rs, cfg, "auto")
            if stage == 0:
                return x, targets
            x = llama._rmsnorm(x, self.final_norm, cfg.norm_eps)
            # the head as a function of the tensor functional_call
            # handed in: the loss's checkpointed chunks recompute after
            # the call has put the meta parameter back
            import functools

            import torch.nn.functional as F
            head = functools.partial(F.linear, weight=self.lm_head.weight)
            return llama.fused_cross_entropy(
                x, head, {"targets": targets}, PIPE_CE_CHUNK,
                cfg.logits_dtype)
    return PipeStageBody()


def pipe_stage_fn(cfg, stage: int, params: dict, payload):
    """Stage ``stage``'s stage_fn(params, x): (tokens, targets) -> (h,
    targets) at stage 0, (h, targets) -> the loss at stage 1."""
    return torch.func.functional_call(pipe_body(cfg, stage), params,
                                      tuple(payload))


class PipeSGD:
    """optax.sgd(lr) in optax's shape over tensors: the update is
    ``-lr * g`` (PipelineStageActor adds it in the parameter's dtype)."""

    def __init__(self, lr: float):
        self.lr = lr

    def init(self, params):
        return ()

    def update(self, grads, state, params=None):
        return {k: -self.lr * g for k, g in grads.items()}, state


def pipe_batches(cfg) -> list:
    """PIPE_MB microbatches of 1 x 4096 tokens and their targets, as CPU
    tensors (what the driver feeds the first stage)."""
    toks = torch.from_numpy(np.random.default_rng(PIPE_SEED).integers(
        0, cfg.vocab_size, (PIPE_MB, 4097)))
    return [(toks[i:i + 1, :-1].contiguous(), toks[i:i + 1, 1:].contiguous())
            for i in range(PIPE_MB)]


def pipe_reference(cfg, mbs) -> list:
    """One process's PIPE_STEPS steps of the pipeline's model on the card:
    per microbatch, stage 1's loss of stage 0's output (a forward without
    grad, as the pipeline's F ops compute it) and the gradients of both
    stages' parameters (a forward with grad and its backward), summed in
    bf16 and divided by PIPE_MB, then PipeSGD. Returns each step's mean
    loss; the weights are freed."""
    params = [pipe_params(cfg, k, PIPE_SEED) for k in range(2)]
    fns = [lambda p, x, k=k: pipe_stage_fn(cfg, k, p, x) for k in range(2)]
    want = []
    for _ in range(PIPE_STEPS):
        acc, losses = None, []
        for tok, tgt in mbs:
            x = (tok.cuda(), tgt.cuda())
            with torch.no_grad():
                losses.append(fns[1](params[1],
                                     fns[0](params[0], x)).item())
            leaves = [{n: t.detach().requires_grad_(True)
                       for n, t in p.items()} for p in params]
            loss = fns[1](leaves[1], fns[0](leaves[0], x))
            names = [(k, n) for k in range(2) for n in leaves[k]]
            grads = torch.autograd.grad(
                loss, [leaves[k][n] for k, n in names])
            acc = list(grads) if acc is None else \
                [a + g for a, g in zip(acc, grads)]
            del loss, grads, leaves
        want.append(float(np.mean(np.asarray(losses, np.float32))))
        with torch.no_grad():
            for (k, n), g in zip(names, acc):
                p = params[k][n]
                params[k][n] = (p + (-PIPE_LR * (g * (1.0 / PIPE_MB)))
                                ).to(p.dtype)
        del acc
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return want


def rss_bytes() -> int:
    """This process's resident set (VmRSS), or 0 where /proc lacks it."""
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS"):
                return int(line.split()[1]) * 1024
    return 0


def pipe_stage_class():
    """PipelineStageActor with run_pipeline's probes, built where it is
    first needed (chip_smoke.py imports nothing of the port at module
    level): the stage draws its own parameters on the card, and counts
    the seconds and bytes of the TensorRefs it resolves (the activations'
    and gradients' hop through the producer's host memory)."""
    from ray_tpu_torch.dag import runtime as dag_runtime
    from ray_tpu_torch.train.pipeline import PipelineStageActor

    class PipeStage(PipelineStageActor):
        def __init__(self, cfg, stage: int, seed: int):
            import functools
            torch.cuda.set_device(0)
            super().__init__(functools.partial(pipe_stage_fn, cfg, stage),
                             pipe_params(cfg, stage, seed),
                             optimizer=PipeSGD(PIPE_LR),
                             is_last=stage == 1)
            self.hop = {"s": 0.0, "bytes": 0, "n": 0}
            self.rss_peak = 0
            threading.Thread(target=self._sample_rss, daemon=True).start()
            # one F and one B op on a microbatch of zeros at the real
            # shape, then discarded: the process's first forward and
            # backward (CUDA libraries, kernel modules, allocator) run
            # here, in both stages at once, instead of serialized down
            # the first step's schedule
            t0 = time.monotonic()
            s = 4096
            z = torch.zeros((1, s), dtype=torch.int64, device="cuda")
            h = torch.zeros((1, s, cfg.dim), dtype=torch.bfloat16,
                            device="cuda")
            self.pipe_forward(-1, (z, z) if stage == 0 else (h, z))
            self.pipe_backward(-1, None if stage == 1 else (h, None))
            self._acc, self._acc_n, self._losses = None, 0, []
            torch.cuda.synchronize()
            self.warm_s = time.monotonic() - t0
            resolve = dag_runtime._resolve_device_tree
            from ray_tpu_torch.runtime.device_store import TensorRef

            def timed(value, device=None):
                refs = []
                dag_runtime._map_tree_leaves(
                    lambda v: refs.append(v) if isinstance(v, TensorRef)
                    else None, value)
                t0 = time.monotonic()
                out = resolve(value, device)
                torch.cuda.synchronize()
                self.hop["s"] += time.monotonic() - t0
                self.hop["n"] += len(refs)
                self.hop["bytes"] += sum(
                    int(np.prod(r.shape)) * getattr(torch, r.dtype).itemsize
                    for r in refs)
                return out
            dag_runtime._resolve_device_tree = timed

        def _sample_rss(self):
            # the host RSS peak, every 0.1 s (the chip machine's
            # /proc/self/status has VmRSS, no VmHWM)
            while True:
                self.rss_peak = max(self.rss_peak, rss_bytes())
                time.sleep(0.1)

        def reset_counts(self):
            from ray_tpu_torch.ops import flash_attention as fa
            reset_train_counts(fa)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            self.hop = {"s": 0.0, "bytes": 0, "n": 0}
            self.rss_peak = rss_bytes()

        def counts(self) -> dict:
            from ray_tpu_torch.ops import flash_attention as fa
            from ray_tpu_torch.runtime.device_store import _store
            from ray_tpu_torch.util import events
            c = train_counts(fa)
            return {"launches": [
                c["flash_attention_fwd"] - c["flash_attention_fwd_lse"],
                c["flash_attention_fwd_lse"], c["flash_attention_bwd_dkv"],
                c["flash_attention_bwd_dq"]],
                "store": _store().stats(), "foreign": foreign_modules(),
                "compiles": [e.get("fn") for e in events.dump()
                             if e.get("name") == "compile"],
                "peak_hbm": torch.cuda.max_memory_allocated(),
                "rss_peak": self.rss_peak, "hop": dict(self.hop),
                "activation_bytes": metric(
                    "pipeline_activation_bytes_total"),
                "warm_s": self.warm_s, "pid": os.getpid()}

        def fingerprint(self) -> list:
            return param_fingerprint(
                [self.params[k] for k in sorted(self.params)])
    return PipeStage


def run_pipeline(card: str) -> dict:
    """The pipeline phase (see the comment block above): the one-process
    reference first (then freed), then init() and run A, its teardown,
    and run B. Checks run A's losses against the reference (step 1 within
    PIPE_STEP1_REL_TOL, later steps within TRAIN_LOSS_REL_TOL), run B's
    step bitwise run A's (loss and both stages' parameters), K1, K1 with
    lse, K2 and K3 PIPE_LAUNCHES_PER_STEP times a step in each stage
    process, every step's report, stage_stats at teardown, both device
    stores empty after it, activation bytes metered, and no jax,
    ml_dtypes, ray_tpu or nvcc in either stage process; prints the step
    walls of both transports, each stage's bubble against
    bubble_fraction(2, PIPE_MB), the activations' host hop, the save and
    restore seconds and bytes, peak HBM and host RSS per stage."""
    import shutil
    import tempfile

    import ray_tpu_torch
    from ray_tpu_torch.train import Pipeline, bubble_fraction
    t_phase = time.monotonic()
    cfg = pipe_cfg()
    mbs = pipe_batches(cfg)
    want = pipe_reference(cfg, mbs)
    ref_s = time.monotonic() - t_phase
    Stage = ray_tpu_torch.remote(max_concurrency=2)(pipe_stage_class())
    # the checkpoint on tmpfs where there is one: what is timed is the
    # pipeline's save and restore (snapshots over the object plane,
    # ckptio's archive, hash and atomic write), not the disk
    shm = "/dev/shm" if os.path.isdir("/dev/shm") else None
    root = tempfile.mkdtemp(prefix="chip_smoke_pipe_", dir=shm)
    from ray_tpu_torch.train import ckptio
    ck_s = {"write_shard": 0.0, "_assemble_space": 0.0}

    def timed(fn):
        def wrapper(*a, **kw):
            t0 = time.monotonic()
            try:
                return fn(*a, **kw)
            finally:
                ck_s[fn.__name__] += time.monotonic() - t0
        return wrapper
    originals = {n: getattr(ckptio, n) for n in ck_s}
    for n, fn in originals.items():
        setattr(ckptio, n, timed(fn))
    bad, runs = [], {}
    # a stage's checkpoint blob (its parameters at the f32 wire, 3.85 GB)
    # crosses the object plane whole, both ways
    free0 = torch.cuda.mem_get_info()[0]
    ray_tpu_torch.init(num_cpus=4,
                       system_config={"shm_store_bytes": PIPE_STORE_BYTES})
    try:
        later = None    # run B's stages, started during run A's save
        for run, seed, transport in (("A", PIPE_SEED, True),
                                     ("B", PIPE_SEED + 1, False)):
            t0 = time.monotonic()
            stages = later or [Stage.remote(cfg, k, seed) for k in range(2)]
            ray_tpu_torch.get([s.reset_counts.remote() for s in stages],
                              timeout=300)
            up_s = time.monotonic() - t0
            pipe = Pipeline(stages, num_microbatches=PIPE_MB,
                            schedule="1f1b", device=transport,
                            timeout_s=300.0,
                            **({} if transport else
                               dict(nslots=PIPE_MB,
                                    slot_bytes=PIPE_SLOT_BYTES)))
            rec = {"walls": [], "losses": [], "reports": [],
                   "launches": [], "up_s": up_s}
            try:
                first = 1
                if run == "B":
                    t0 = time.monotonic()
                    rec["restored"] = pipe.restore_checkpoint(path)
                    rec["restore_s"] = time.monotonic() - t0
                    first = rec["restored"] + 1
                    ray_tpu_torch.get([s.reset_counts.remote()
                                       for s in stages], timeout=60)
                for step in range(first, PIPE_STEPS + 1):
                    t0 = time.monotonic()
                    out = pipe.step(mbs)
                    rec["walls"].append(time.monotonic() - t0)
                    rec["losses"].append(out.loss)
                    print(f"pipeline {run} step {step} [{card}]: loss "
                          f"{out.loss}, wall {rec['walls'][-1]:.3f} s",
                          flush=True)
                    rec["reports"].append(
                        [(r["stage"], r["stats"]["step_s"],
                          r["stats"]["bubble_s"]) for r in out.reports])
                    rec["bubble_fraction"] = out.bubble_fraction
                    rec["launches"].append([c["launches"] for c in
                                            ray_tpu_torch.get(
                                                [s.counts.remote()
                                                 for s in stages],
                                                timeout=60)])
                    if run == "A" and step == PIPE_SAVE_AFTER:
                        # run B's two new stages come up (and warm up)
                        # under the save, which leaves the card idle;
                        # they join no pipeline until run A is torn
                        # down, and their warm-up ends before run A's
                        # next step (reset_counts waits for __init__)
                        later = [Stage.remote(cfg, k, PIPE_SEED + 1)
                                 for k in range(2)]
                        t0 = time.monotonic()
                        path = pipe.save_checkpoint(root, step=step)
                        rec["save_s"] = time.monotonic() - t0
                        rec["save_bytes"] = sum(
                            os.path.getsize(os.path.join(d, f))
                            for d, _, fs in os.walk(path) for f in fs)
                        ray_tpu_torch.get(
                            [s.reset_counts.remote() for s in later],
                            timeout=300)
                        rec["b_ready_s"] = time.monotonic() - t0
                rec["fingerprints"] = ray_tpu_torch.get(
                    [s.fingerprint.remote() for s in stages], timeout=120)
            finally:
                pipe.teardown(timeout=120.0)
            rec["stage_stats"] = pipe.stage_stats
            rec["counts"] = ray_tpu_torch.get(
                [s.counts.remote() for s in stages], timeout=60)
            for s in stages:
                ray_tpu_torch.kill(s)
            wait_exited([c["pid"] for c in rec["counts"]], 120)
            runs[run] = rec
    finally:
        ray_tpu_torch.shutdown()
        shutil.rmtree(root, ignore_errors=True)
        for n, fn in originals.items():
            setattr(ckptio, n, fn)
    wait_card_back(free0, "the pipeline's stages")
    a, b = runs["A"], runs["B"]
    rel = [abs(g - w) / abs(w) for g, w in zip(a["losses"], want)]
    if not rel[0] <= PIPE_STEP1_REL_TOL or \
            not all(r <= TRAIN_LOSS_REL_TOL for r in rel[1:]):
        bad.append(f"run A's losses {a['losses']} off one process's "
                   f"{want}")
    if not all(np.isfinite(a["losses"] + b["losses"])):
        bad.append("non-finite loss")
    if b.get("restored") != PIPE_SAVE_AFTER or \
            b["losses"] != a["losses"][PIPE_SAVE_AFTER:] or \
            b["fingerprints"] != a["fingerprints"]:
        bad.append(f"run B (restored at step {b.get('restored')}) is not "
                   f"run A's last step bitwise: losses {b['losses']} vs "
                   f"{a['losses'][PIPE_SAVE_AFTER:]}, parameters equal "
                   f"{b['fingerprints'] == a['fingerprints']}")
    for run, rec in runs.items():
        n = len(rec["walls"])
        per = [[[PIPE_LAUNCHES_PER_STEP * (i + 1)] * 4] * 2
               for i in range(n)]
        if rec["launches"] != per:
            bad.append(f"run {run}: launches (K1, K1 with lse, K2, K3) "
                       f"per stage after each step {rec['launches']}")
        stats = rec["stage_stats"] or []
        if sorted(r["stage"] for r in stats) != [0, 1] or \
                any(r["steps"] != n for r in stats):
            bad.append(f"run {run}: stage_stats {stats}")
        for k, c in enumerate(rec["counts"]):
            if c["store"]["live_count"] or c["store"]["live_bytes"]:
                bad.append(f"run {run} stage {k}: store {c['store']}")
            if c["foreign"] or c["compiles"]:
                bad.append(f"run {run} stage {k}: modules {c['foreign']}, "
                           f"nvcc builds {c['compiles']}")
            if not c["activation_bytes"] > 0:
                bad.append(f"run {run} stage {k}: no activation bytes")
    analytic = bubble_fraction(2, PIPE_MB)
    print(f"pipeline [{card}]: llama3_8b widths at {cfg.n_layers} layers, "
          f"2 stages ({cfg.n_layers // 2} a stage, the embedding on "
          f"stage 0, the head "
          f"and loss on stage 1), 1f1b over {PIPE_MB} microbatches of 1 x "
          f"4096 tokens; one process's reference {ref_s:.1f} s; run A "
          f"(device transport) losses {a['losses']} vs one process's "
          f"{want} (rel {['%.2e' % r for r in rel]}, step 1 tol "
          f"{PIPE_STEP1_REL_TOL}, later {TRAIN_LOSS_REL_TOL}); run B "
          f"(host transport, restored at step {b.get('restored')}) losses "
          f"{b['losses']}, parameters bitwise run A's "
          f"{b['fingerprints'] == a['fingerprints']}")
    for run, rec in runs.items():
        hops = [c["hop"] for c in rec["counts"]]
        up = (f"stages up in {rec['up_s']:.1f} s" if run == "A" else
              f"stages started at run A's save, ready "
              f"{a['b_ready_s']:.1f} s after it began")
        print(f"pipeline {run} [{card}]: {up}; "
              f"step walls {['%.3f' % w for w in rec['walls']]} s; per "
              f"step (stage, step_s, bubble_s) {rec['reports']}; measured "
              f"bubble fraction (last step, slowest stage) "
              f"{rec['bubble_fraction']:.3f} vs bubble_fraction(2, "
              f"{PIPE_MB}) {analytic:.3f}; launches (K1, K1 with lse, K2, "
              f"K3) per stage after each step {rec['launches']}")
        for k, (c, h) in enumerate(zip(rec["counts"], hops)):
            rate = h["bytes"] / h["s"] / 1e9 if h["s"] else float("nan")
            print(f"pipeline {run} stage {k} [{card}]: TensorRef "
                  f"resolves {h['n']} ({h['bytes']} bytes) in "
                  f"{h['s']:.3f} s ({rate:.3f} GB/s); activation bytes "
                  f"shipped {c['activation_bytes']:.0f}; store after "
                  f"teardown {c['store']}; peak HBM "
                  f"{c['peak_hbm'] / 2**30:.2f} GiB; peak host RSS "
                  f"{c['rss_peak'] / 2**30:.2f} GiB; modules {c['foreign']}, "
                  f"nvcc builds {c['compiles']}")
    print(f"pipeline host [{card}]: /dev/shm (total, free) {shm_size()} "
          f"bytes after the phase")
    print(f"pipeline checkpoint [{card}]: under {root}; save after step "
          f"{PIPE_SAVE_AFTER} {a.get('save_s', float('nan')):.1f} s "
          f"({ck_s['write_shard']:.1f} s of it in ckptio.write_shard, "
          f"the rest the stages' snapshots over the object plane), "
          f"{a.get('save_bytes', 0)} bytes; restore "
          f"{b.get('restore_s', float('nan')):.1f} s "
          f"({ck_s['_assemble_space']:.1f} s of it loading and hashing "
          f"the shards, the rest shipping the blobs and pipe_restore); "
          f"stage warm-up (one F and one B op before the run) "
          f"{[round(c['warm_s'], 1) for r in runs.values() for c in r['counts']]}"
          f" s; phase {time.monotonic() - t_phase:.1f} s")
    if bad:
        raise SystemExit("the pipeline phase failed: " + "; ".join(bad))
    return {"launches": {
        name: sum(rec["launches"][-1][k][i] for rec in runs.values()
                  for k in range(2))
        for i, name in enumerate(("train_pipeline_fwd",
                                  "train_pipeline_lse",
                                  "train_pipeline_k2",
                                  "train_pipeline_k3"))}}


COPY_SLEEP_CYCLES = 20_000_000   # ~10 ms at the H100's 1.98 GHz clock


def check_consumer_waits(ds, batch_size: int) -> list:
    """Consumes each batch of ``ds.iter_device_batches`` on the current
    stream as it is yielded, before any synchronize, while the copy
    stream is slowed: ``torch.cuda._sleep(COPY_SLEEP_CYCLES)`` is queued
    ahead of every column's copy (through ``torch.from_numpy``, which the
    iterator calls inside the copy stream's context). A consumer that did
    not wait on the copy's event would sum memory the copy has not
    written yet. Returns the indices of the batches whose int64 column
    sums, taken on the card as each batch was yielded, differ from the
    host's. The caller keeps its own batches alive, so no freed block
    still holds the right rows."""
    want = [[int(b[k].astype(np.int64).sum()) for k in sorted(b)]
            for b in ds.iter_batches(batch_size=batch_size)]
    real = torch.from_numpy

    def slowed(a):
        torch.cuda._sleep(COPY_SLEEP_CYCLES)
        return real(a)

    sums = []
    torch.from_numpy = slowed
    try:
        for b in ds.iter_device_batches(batch_size=batch_size, prefetch=1):
            sums.append(torch.stack([b[k].to(torch.int64).sum()
                                     for k in sorted(b)]))
    finally:
        torch.from_numpy = real
    torch.cuda.synchronize()
    got = [s.tolist() for s in sums]
    return [i for i in range(max(len(got), len(want)))
            if i >= len(got) or i >= len(want) or got[i] != want[i]]


def run_device_batches(card: str) -> dict:
    """``iter_device_batches`` at the training shape: ``data.from_numpy``
    of 32 rows of 4096 int32 tokens and their 4096 targets (one 32 x 4097
    draw, numpy seed 4, shifted by one), ``batch_size=2``, ``prefetch=1``,
    ``device=None`` (the card). Each batch must be on the card and bitwise
    its host rows. The train phase's model (Llama-3-8B's widths at 8
    layers, bf16, f32 logits, seed 0) gives ``loss_fn`` on the first
    batch equal to its loss on the same tokens moved to the card
    directly. ``check_consumer_waits`` then shows the consumer's stream
    waiting on each copy. Prints the host-to-device MB/s over the whole
    iteration (batching, pinning and copies; the consumer only checks),
    for the process's first iteration (cold: it pays the first pinned
    allocations and varies widely from run to run) and for a second one
    over the same dataset (warm)."""
    from ray_tpu_torch import data
    from ray_tpu_torch.models import llama
    cfg = llama.llama3_8b(n_layers=8, dtype="bfloat16",
                          logits_dtype="float32", ce_chunk=0)
    draw = np.random.default_rng(4).integers(
        0, cfg.vocab_size, (32, 4097)).astype(np.int32)
    host = {"tokens": draw[:, :-1], "targets": draw[:, 1:]}
    ds = data.from_numpy(host)
    torch.cuda.synchronize()
    t0 = time.monotonic()
    got = list(ds.iter_device_batches(batch_size=2, prefetch=1))
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    t0 = time.monotonic()
    again = list(ds.iter_device_batches(batch_size=2, prefetch=1))
    torch.cuda.synchronize()
    warm = time.monotonic() - t0
    del again
    moved = sum(t.numel() * t.element_size() for b in got
                for t in b.values())
    bad = [i for i, b in enumerate(got)
           if set(b) != set(host) or any(
               not (t.is_cuda and t.dtype == torch.int32
                    and np.array_equal(t.cpu().numpy(),
                                       host[k][2 * i:2 * i + 2]))
               for k, t in b.items())]
    raced = check_consumer_waits(ds, 2)
    model = llama.init_params(
        torch.Generator(device="cuda").manual_seed(0), cfg)
    direct = {k: torch.from_numpy(np.ascontiguousarray(v[:2])).cuda()
              for k, v in host.items()}
    with torch.no_grad():
        loss_it = llama.loss_fn(model, got[0], cfg).item()
        loss_direct = llama.loss_fn(model, direct, cfg).item()
    del model
    gc.collect()
    torch.cuda.empty_cache()
    mb_s, warm_mb_s = moved / wall / 1e6, moved / warm / 1e6
    print(f"iter_device_batches [{card}]: {len(got)} batches of 2 x 4096 "
          f"tokens + targets (int32) on the card in {wall * 1e3:.1f} ms, "
          f"{moved} bytes, {mb_s:.1f} MB/s host to device (a second pass, "
          f"warm: {warm * 1e3:.1f} ms, {warm_mb_s:.1f} MB/s); bitwise equal "
          f"to the host rows: {not bad}; loss_fn on batch 0 {loss_it!r}, "
          f"on the same tokens passed directly {loss_direct!r}; each "
          f"batch summed on the consumer's stream as it was yielded, the "
          f"copy stream slowed by {COPY_SLEEP_CYCLES} cycles per column: "
          f"batches whose sums differ from the host's {raced}")
    if raced:
        raise SystemExit(f"iter_device_batches: the consumer read batches "
                         f"{raced} before their copies finished")
    if len(got) != 16 or bad:
        raise SystemExit(f"iter_device_batches: {len(got)} batches, bad "
                         f"{bad}")
    if loss_it != loss_direct or not np.isfinite(loss_it):
        raise SystemExit("the loss over the iterator's batch differs")
    return dict(mb_s=mb_s, wall_s=wall, warm_mb_s=warm_mb_s,
                warm_wall_s=warm, loss=loss_it)


def share_bytecode() -> str:
    """Give this process and every process it starts (the cluster's
    workers, actors and stages, the CLI) one bytecode cache of their own
    in the temporary directory, removed at exit: the chip host's Python
    sets PYTHONDONTWRITEBYTECODE and its packages hold no bytecode, so
    each new process compiled torch's modules from source, at its
    `import torch` and again at a model's first custom-op registration
    (which imports torch._dynamo and sympy). The first process to import
    a module fills the cache."""
    import atexit
    import shutil
    import tempfile
    path = tempfile.mkdtemp(prefix="chip_smoke_pycache_")
    atexit.register(shutil.rmtree, path, True)
    os.environ.pop("PYTHONDONTWRITEBYTECODE", None)
    os.environ["PYTHONPYCACHEPREFIX"] = path
    sys.dont_write_bytecode = False
    sys.pycache_prefix = path
    return path


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device available", file=sys.stderr)
        return 1
    share_bytecode()
    from ray_tpu_torch.ops import _build
    from ray_tpu_torch.ops import flash_attention as fa
    from ray_tpu_torch.ops import paged_attention as pa

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"card: {card}")
    kind = torch.cuda.get_device_name(0)
    t_run = time.monotonic()

    def took(name: str) -> None:
        print(f"script clock [{card}]: {name} done at "
              f"{time.monotonic() - t_run:.1f} s")

    t0 = time.monotonic()
    reports = _build.build_all()
    from ray_tpu_torch.util import events
    compiles = [(e["fn"], round(e["dur"], 2)) for e in events.dump()
                if e.get("name") == "compile"]
    print(f"build: {len(reports)} kernel sources in "
          f"{time.monotonic() - t0:.1f} s; compiles recorded by the device "
          f"monitor (source, nvcc s): {compiles}")
    for name, log in reports.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")
    sass = check_sass(_build)
    took("build")

    gen = torch.Generator(device="cuda").manual_seed(1234)
    k1 = check_flash(fa, gen)
    k4 = check_paged(pa, gen)
    took("check_flash, check_paged")
    launches, model, cfg, ref = run_engine(card)
    took("run_engine")
    tp = run_tp(model, cfg, ref, fa, pa, gen, card)
    took("run_tp")
    gc.collect()
    torch.cuda.empty_cache()
    mono = run_monolithic(model, cfg, ref, card)
    spec = run_spec(model, cfg, pa, gen, card)
    pd = run_pd(model, cfg, ref, card)
    hooks = run_hooks(model, cfg, card)
    breakdown(model, cfg, card, mono["step"], spec["step"])
    took("run_monolithic, run_spec, run_pd, run_hooks, breakdown")
    del model
    gc.collect()
    torch.cuda.empty_cache()
    rpd = run_runtime_pd(cfg, ref, pd["want_bytes"], card)
    took("run_runtime_pd")
    served = run_serve(ref, pd["want_bytes"], rpd, card)
    took("run_serve")
    dllm = run_data_llm(ref, card)
    took("run_data_llm")

    serve_k1 = {"serve": launches["flash_attention_fwd"],
                "serve_tp": tp["launches"]["flash_attention_fwd"],
                "serve_monolithic": mono["launches"]["flash_attention_fwd"],
                "serve_spec": spec["launches"]["flash_attention_fwd"],
                "serve_pd": pd["prefill"]["flash_attention_fwd"],
                "serve_pd_handle": pd["handle"]["prefill"][
                    "flash_attention_fwd"],
                "serve_hooks": hooks["launches"]["flash_attention_fwd"],
                "serve_runtime_pd": rpd["prefill"]["flash_attention_fwd"],
                "serve_app": served["launches"]["flash_attention_fwd"],
                "data_llm": dllm["launches"]["flash_attention_fwd"],
                "dag_pd": rpd["dag"]["prefill"]["flash_attention_fwd"]}
    serve_k4 = {"serve": launches["paged_attention"],
                "serve_tp": tp["launches"]["paged_attention"],
                "serve_monolithic": mono["launches"]["paged_attention"],
                "serve_spec": spec["launches"]["paged_attention"],
                "serve_pd": pd["decode"]["paged_attention"],
                "serve_pd_handle": pd["handle"]["decode"]["paged_attention"],
                "serve_hooks": hooks["launches"]["paged_attention"],
                "serve_runtime_pd": rpd["decode"]["paged_attention"],
                "serve_app": served["launches"]["paged_attention"],
                "data_llm": dllm["launches"]["paged_attention"],
                "dag_pd": rpd["dag"]["decode"]["paged_attention"]}

    tk = check_train_kernels(fa, gen)
    tk_shard = check_train_kernels(fa, gen, 32 // TP, 8 // TP, " tp-shard")
    check_train_parity(fa, card)
    took("check_train_kernels, check_train_parity")
    train = run_train(fa, card)
    took("run_train")
    meshes = run_mesh(fa, card, train["dots"])
    took("run_mesh")
    gc.collect()
    torch.cuda.empty_cache()
    moe_run = run_moe(fa, card)
    took("run_moe")
    run_rllib(card)
    took("run_rllib")
    trainer = run_trainer(card)
    took("run_trainer")
    tuned = run_tune(card, trainer["want"])
    took("run_tune")
    dp = run_dp(card)
    took("run_dp")
    elastic = run_elastic(card, dp["want"])
    took("run_elastic")
    pipe = run_pipeline(card)
    took("run_pipeline")
    run_device_batches(card)
    took("run_device_batches")
    train_k = {name: {f"train_{p}": train[p]["launches"][key]
                      for p in TRAIN_POLICIES}
               for name, key in (("K1", "flash_attention_fwd_lse"),
                                 ("K2", "flash_attention_bwd_dkv"),
                                 ("K3", "flash_attention_bwd_dq"))}
    for i, (name, key) in enumerate((("K1", "flash_attention_fwd_lse"),
                                     ("K2", "flash_attention_bwd_dkv"),
                                     ("K3", "flash_attention_bwd_dq"))):
        for m, r in meshes.items():
            train_k[name][f"train_mesh_{m}"] = r["launches"][key]
        train_k[name]["train_moe"] = moe_run["single"]["launches"][key]
        for m, r in moe_run["meshes"].items():
            train_k[name]["train_moe_mesh" + ("" if m == "B" else
                                              "_4cards")] = r["launches"][i]
        train_k[name]["train_trainer"] = trainer["launches"][i]
        train_k[name]["train_tune"] = tuned["launches"][i]
        for path, counts in dict(dp["launches"],
                                 **elastic["launches"]).items():
            train_k[name][path] = counts[i]
    serve_k1["serve_tune"] = tuned["serve"]["flash_attention_fwd"]
    serve_k4["serve_tune"] = tuned["serve"]["paged_attention"]
    pipe_k = pipe["launches"]
    train_k["K1"]["train_pipeline_fwd"] = pipe_k["train_pipeline_fwd"]
    train_k["K1"]["train_pipeline_lse"] = pipe_k["train_pipeline_lse"]
    train_k["K2"]["train_pipeline"] = pipe_k["train_pipeline_k2"]
    train_k["K3"]["train_pipeline"] = pipe_k["train_pipeline_k3"]
    full_ms = train["full"]["per_launch_ms"]

    bwd_tol = {"row_rel_l2": BWD_ROW_REL_TOL}
    shard_at = (f"b=1 s=4096 h={32 // TP} kvh={8 // TP} d=128 bf16 causal "
                "(mesh A's shard)")
    sdpa_note = ("SDPA's backward computes dQ, dK and dV in one call: "
                 "compare it with K2 ms + K3 ms")
    kernels = [
        dict(name="flash_attention_fwd", route="cuda",
             tensor_cores=sass["flash_attention_fwd"],
             source="ray_tpu_torch/csrc/flash_attention_fwd.cu",
             replaces="ray_tpu/ops/pallas/flash_attention.py:79",
             launches=sum(serve_k1.values()) + sum(train_k["K1"].values()),
             launches_by_path=dict(serve_k1, **train_k["K1"]),
             at="b=1 s=4096 h=32 kvh=8 d=128 bf16 causal, with lse",
             tolerance={"row_rel_l2": K1_ROW_REL_TOL,
                        "lse_abs": LSE_ABS_TOL},
             card=card, train_per_launch_ms=full_ms.get("K1"),
             serving=dict(at="s=512 causal, no lse", **k1),
             serving_tp_shard=dict(
                 at=f"s=512 causal, no lse, {32 // TP} q / {8 // TP} kv "
                    "heads", **tp["k1_shard"]),
             train_tp_shard=dict(at=shard_at + ", with lse",
                                 **tk_shard["fwd"]), **tk["fwd"]),
        dict(name="flash_attention_bwd_dkv", route="cuda",
             tensor_cores=sass["flash_attention_bwd_dkv"],
             source="ray_tpu_torch/csrc/flash_attention_bwd.cu",
             replaces="ray_tpu/ops/pallas/flash_attention.py:212",
             launches=sum(train_k["K2"].values()),
             launches_by_path=train_k["K2"],
             at="b=1 s=4096 h=32 kvh=8 d=128 bf16 causal",
             tolerance=bwd_tol, card=card, library_note=sdpa_note,
             train_per_launch_ms=full_ms.get("K2"),
             train_tp_shard=dict(at=shard_at, **tk_shard["dkv"]),
             bitwise_twice=True, **tk["dkv"]),
        dict(name="flash_attention_bwd_dq", route="cuda",
             tensor_cores=sass["flash_attention_bwd_dq"],
             source="ray_tpu_torch/csrc/flash_attention_bwd.cu",
             replaces="ray_tpu/ops/pallas/flash_attention.py:263",
             launches=sum(train_k["K3"].values()),
             launches_by_path=train_k["K3"],
             at="b=1 s=4096 h=32 kvh=8 d=128 bf16 causal",
             tolerance=bwd_tol, card=card, library_note=sdpa_note,
             train_per_launch_ms=full_ms.get("K3"),
             train_tp_shard=dict(at=shard_at, **tk_shard["dq"]),
             bitwise_twice=True, **tk["dq"]),
        dict(name="paged_attention", route="cuda",
             tensor_cores=sass["paged_attention"],
             source="ray_tpu_torch/csrc/paged_attention.cu",
             replaces="ray_tpu/ops/pallas/paged_attention.py:60",
             launches=sum(serve_k4.values()), launches_by_path=serve_k4,
             at="8 slots, 8 kv heads, g 4, hd 128, bs 16, bf16 pool, "
                "3044 live tokens",
             library_note="no single PyTorch call computes paged decode",
             tolerance=K4_TOL, card=card, serving_tp_shard=tp["k4_shard"],
             **k4),
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
