"""Drive ray_tpu_torch's serving path and training step on one CUDA
card and check them.

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
     that phase; then the same requests through the monolithic cache
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
     bf16 payload's). Then the hooks' host cost: the decode step's host
     wall with tracing and the device monitor on, off, on, off, and the
     host seconds inside the hooks per decode block (``run_hooks``); then
     a steady-state decode step (paged and monolithic), a verify forward
     and a prefill, timed and traced for the device's busy share;
  5. the training kernels (K1 with lse, K2, K3) against their plain
     versions at the training shapes (s 4096, a ragged 1000, non-causal),
     timed beside the plain versions, SDPA and their bounds (ms and
     TF/s), and K2 and K3 each twice on the same inputs (bitwise equal);
  6. a 2-layer full-width model's loss and gradients through the kernels
     against the same through plain attention;
  7. make_train_step on Llama-3-8B at full width cut to 8 layers (bf16,
     full remat, batch 2 x 4096): 2 warm-up and 5 timed steps with the
     kernels' launch counts, step time, tok/s and MFU, then one step
     traced for the device's busy share;
  8. one JSON line with every kernel's numbers;
  9. the last line, {"ok": true, "device": {...}}.
Without a CUDA device it exits non-zero and prints no result.
"""

from __future__ import annotations

import asyncio
import dataclasses
import gc
import json
import subprocess
import sys
import time

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


def check_flash(fa, gen) -> dict:
    """K1 on the slice's shapes: prefill buckets (64, a ragged 100, 512)
    and chunked prefill (512 queries against the 1536-long accumulator
    at q_offset 512); Llama-3-8B heads: 32 query, 8 kv, head_dim 128."""
    h, kvh, d = 32, 8, 128
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
        print(f"K1 flash sq={sq} sk={sk} q_offset={off}: worst row "
              f"relative error {row_rel:.3e} (tol {K1_ROW_REL_TOL}), "
              f"max_abs_err {err:.3e}, output rms "
              f"{want.float().pow(2).mean().sqrt().item():.3e} "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit("K1 disagrees with its plain version")
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
            print(f"K1 flash s=512: kernel {timed['ms']:.4f} ms "
                  f"({tflops(w, timed['ms']):.1f} TF/s), plain "
                  f"{timed['plain_ms']:.4f} ms, SDPA {timed['library_ms']:.4f}"
                  f" ms ({tflops(w, timed['library_ms']):.1f} TF/s), bound "
                  f"{b:.4f} ms ({by})")
        if off is not None:
            b, by = bound_ms(fa.work(1, sq, sk, h, kvh, d, 2, q_offset=off))
            print(f"K1 flash chunk sq={sq} sk={sk} q_offset={off}: kernel "
                  f"{time_ms(kernel):.4f} ms, plain {time_ms(plain):.4f} ms,"
                  f" bound {b:.4f} ms ({by})")
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


def latency_line(runs, wall: float) -> str:
    """TTFT and TPOT p50 and generated tok/s of concurrent requests, each
    run (result, submitted at, done at) on the host clock."""
    ttft = [o["ttft_s"] for o, _, _ in runs]
    tpot = [(done - (t_sub + o["ttft_s"])) / (len(o["tokens"]) - 1)
            for o, t_sub, done in runs]
    toks = sum(len(o["tokens"]) for o, _, _ in runs)
    return (f"TTFT p50 {np.median(ttft) * 1e3:.1f} ms, TPOT p50 "
            f"{np.median(tpot) * 1e3:.2f} ms, {toks / wall:.1f} generated "
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
               hit_stream=hit[0]["tokens"], obs=obs)
    return launches, model, cfg, ref


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
    return dict(prefill=k1, decode=k4, flips=flips,
                handoff_bytes=stats["handoff_bytes"])


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


def check_train_kernels(fa, gen) -> dict:
    """K1 with lse, K2 and K3 at the training path's shapes: Llama-3-8B
    heads (32 query, 8 kv, head_dim 128), bf16, batch 1; s 4096 causal
    (timed), a ragged 1000 causal and 1000 non-causal (checked). Each
    kernel gets the same inputs as its plain version (K2/K3 the kernel
    forward's lse and delta)."""
    b, h, kvh, d = 1, 32, 8, 128
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
        print(f"train kernels s={s_} causal={causal}: K1+lse worst row "
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
            raise SystemExit("a training kernel disagrees with its plain "
                             "version")
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
            print(f"train kernel {name} b=1 s=4096 causal: kernel "
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


def run_train(fa, card: str) -> dict:
    """make_train_step on Llama-3-8B at its published widths (dim 4096,
    32/8 heads, ffn 14336, vocab 128256, rope 5e5) cut to 8 layers, bf16,
    full remat, f32 logits, no CE chunking; random weights from seed 0;
    one batch of 2 x 4096 random tokens (targets shifted by one);
    default_optimizer(3e-4, warmup 2, total 100). 2 warm-up steps, then 5
    timed steps whose launch counts must be K1 = 2 * 8 * 5 (all with
    lse), K2 = K3 = 8 * 5; then one step traced."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from ray_tpu_torch.models import llama
    from ray_tpu_torch.parallel import default_optimizer, make_train_step
    from ray_tpu_torch.parallel.mesh import global_norm

    cfg = llama.llama3_8b(n_layers=8, dtype="bfloat16", remat_policy="full",
                          logits_dtype="float32", ce_chunk=0)
    b, s, steps = 2, 4096, 5
    opt = default_optimizer(learning_rate=3e-4, warmup_steps=2,
                            total_steps=100)
    init_fn, step_fn = make_train_step(cfg, optimizer=opt)
    t0 = time.monotonic()
    state = init_fn(torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    print(f"train: llama3_8b widths, {cfg.n_layers} layers, "
          f"{cfg.num_params() / 1e9:.3f}B params, bf16, random weights "
          f"(seed 0) and AdamW state in {time.monotonic() - t0:.1f} s")
    toks = torch.tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (b, s + 1)), device="cuda")
    batch = {"tokens": toks[:, :-1].contiguous(),
             "targets": toks[:, 1:].contiguous()}
    losses, norms, walls = [], [], []

    def step():
        nonlocal state
        torch.cuda.synchronize()
        t = time.monotonic()
        state, m = step_fn(state, batch)
        losses.append(m["loss"].item())
        norms.append(m["grad_norm"].item())
        torch.cuda.synchronize()
        walls.append(time.monotonic() - t)

    for _ in range(2):
        step()
    fa.flash_attention_fwd.launches = 0
    fa.flash_attention_fwd.lse_launches = 0
    fa.flash_attention_bwd_dkv.launches = 0
    fa.flash_attention_bwd_dq.launches = 0
    torch.cuda.reset_peak_memory_stats()
    for _ in range(steps):
        step()
    launches = {"flash_attention_fwd": fa.flash_attention_fwd.launches,
                "flash_attention_fwd_lse": fa.flash_attention_fwd.lse_launches,
                "flash_attention_bwd_dkv": fa.flash_attention_bwd_dkv.launches,
                "flash_attention_bwd_dq": fa.flash_attention_bwd_dq.launches}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    n = cfg.n_layers * steps
    want = {"flash_attention_fwd": 2 * n, "flash_attention_fwd_lse": 2 * n,
            "flash_attention_bwd_dkv": n, "flash_attention_bwd_dq": n}
    print(f"train losses {['%.5f' % x for x in losses]}, grad norms "
          f"{['%.4f' % x for x in norms]}; launches over the {steps} timed "
          f"steps {launches}")
    if not all(np.isfinite(losses)) or not all(np.isfinite(norms)):
        raise SystemExit("a training loss or grad norm is not finite")
    if not losses[-1] < losses[1]:
        raise SystemExit(f"the loss did not fall: {losses}")
    if launches != want:
        raise SystemExit(f"launch counts {launches}, expected {want}")
    step_s = float(np.median(walls[2:]))
    tok_s = b * s / step_s
    mfu = tok_s * cfg.flops_per_token(s) / PEAK_BF16_FLOPS
    print(f"train step [{card}]: host wall median {step_s * 1e3:.1f} ms "
          f"(steps {', '.join('%.1f' % (w * 1e3) for w in walls[2:])} ms), "
          f"{tok_s:.1f} tok/s, MFU {mfu:.4f} (flops_per_token(4096) "
          f"{cfg.flops_per_token(s):.4e} / 989 TF/s), peak memory "
          f"{peak_gb:.1f} GB")

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step()
    kinds, names = {}, {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            ms = e.time_range.elapsed_us() / 1e3
            kind = _kernel_kind(e.name)
            kinds[kind] = kinds.get(kind, 0.0) + ms
            t, c = names.get(e.name, (0.0, 0))
            names[e.name] = (t + ms, c + 1)
    busy = sum(kinds.values())
    wall_ms = walls[-1] * 1e3
    idle = f"{1 - busy / wall_ms:.3f}" if busy else "not measured"
    per_launch = {k: names[n][0] / names[n][1] for n in names
                  for k in ("K1", "K2", "K3") if _kernel_kind(n) == k}
    top = sorted(names.items(), key=lambda kv: -kv[1][0])[:8]
    print(f"train step traced [{card}]: host wall {wall_ms:.1f} ms, device "
          f"busy {busy:.1f} ms, device idle share {idle}; by kind (ms): "
          + "; ".join(f"{k} {v:.1f}" for k, v in
                      sorted(kinds.items(), key=lambda kv: -kv[1]))
          + "; per launch at b=2 s=4096 (ms): "
          + "; ".join(f"{k} {v:.3f}" for k, v in sorted(per_launch.items()))
          + "; top kernels (ms, count): "
          + "; ".join(f"{k[:50]} {v[0]:.1f} x{v[1]}" for k, v in top))

    params = list(state.params.parameters())
    grads = [p.grad for p in params]

    def update():
        opt.update(state.opt_state, params, grads, global_norm(grads))

    print(f"optimizer update alone (global norm, clip, AdamW over "
          f"{len(params)} tensors): {time_ms(update, iters=3):.1f} ms")
    return {"launches": launches, "per_launch_ms": per_launch}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device available", file=sys.stderr)
        return 1
    from ray_tpu_torch.ops import _build
    from ray_tpu_torch.ops import flash_attention as fa
    from ray_tpu_torch.ops import paged_attention as pa

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"card: {card}")
    kind = torch.cuda.get_device_name(0)

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

    gen = torch.Generator(device="cuda").manual_seed(1234)
    k1 = check_flash(fa, gen)
    k4 = check_paged(pa, gen)
    launches, model, cfg, ref = run_engine(card)
    mono = run_monolithic(model, cfg, ref, card)
    spec = run_spec(model, cfg, pa, gen, card)
    pd = run_pd(model, cfg, ref, card)
    hooks = run_hooks(model, cfg, card)
    breakdown(model, cfg, card, mono["step"], spec["step"])
    del model
    gc.collect()
    torch.cuda.empty_cache()

    serve_k1 = {"serve": launches["flash_attention_fwd"],
                "serve_monolithic": mono["launches"]["flash_attention_fwd"],
                "serve_spec": spec["launches"]["flash_attention_fwd"],
                "serve_pd": pd["prefill"]["flash_attention_fwd"],
                "serve_hooks": hooks["launches"]["flash_attention_fwd"]}
    serve_k4 = {"serve": launches["paged_attention"],
                "serve_monolithic": mono["launches"]["paged_attention"],
                "serve_spec": spec["launches"]["paged_attention"],
                "serve_pd": pd["decode"]["paged_attention"],
                "serve_hooks": hooks["launches"]["paged_attention"]}

    tk = check_train_kernels(fa, gen)
    check_train_parity(fa, card)
    train = run_train(fa, card)
    tl = train["launches"]

    bwd_tol = {"row_rel_l2": BWD_ROW_REL_TOL}
    sdpa_note = ("SDPA's backward computes dQ, dK and dV in one call: "
                 "compare it with K2 ms + K3 ms")
    kernels = [
        dict(name="flash_attention_fwd", route="cuda",
             tensor_cores=sass["flash_attention_fwd"],
             source="ray_tpu_torch/csrc/flash_attention_fwd.cu",
             replaces="ray_tpu/ops/pallas/flash_attention.py:79",
             launches=sum(serve_k1.values()) + tl["flash_attention_fwd"],
             launches_by_path=dict(
                 serve_k1, train=tl["flash_attention_fwd"],
                 train_with_lse=tl["flash_attention_fwd_lse"]),
             at="b=1 s=4096 h=32 kvh=8 d=128 bf16 causal, with lse",
             tolerance={"row_rel_l2": K1_ROW_REL_TOL,
                        "lse_abs": LSE_ABS_TOL},
             card=card, train_per_launch_ms=train["per_launch_ms"].get("K1"),
             serving=dict(at="s=512 causal, no lse", **k1), **tk["fwd"]),
        dict(name="flash_attention_bwd_dkv", route="cuda",
             tensor_cores=sass["flash_attention_bwd_dkv"],
             source="ray_tpu_torch/csrc/flash_attention_bwd.cu",
             replaces="ray_tpu/ops/pallas/flash_attention.py:212",
             launches=tl["flash_attention_bwd_dkv"],
             at="b=1 s=4096 h=32 kvh=8 d=128 bf16 causal",
             tolerance=bwd_tol, card=card, library_note=sdpa_note,
             train_per_launch_ms=train["per_launch_ms"].get("K2"),
             bitwise_twice=True, **tk["dkv"]),
        dict(name="flash_attention_bwd_dq", route="cuda",
             tensor_cores=sass["flash_attention_bwd_dq"],
             source="ray_tpu_torch/csrc/flash_attention_bwd.cu",
             replaces="ray_tpu/ops/pallas/flash_attention.py:263",
             launches=tl["flash_attention_bwd_dq"],
             at="b=1 s=4096 h=32 kvh=8 d=128 bf16 causal",
             tolerance=bwd_tol, card=card, library_note=sdpa_note,
             train_per_launch_ms=train["per_launch_ms"].get("K3"),
             bitwise_twice=True, **tk["dq"]),
        dict(name="paged_attention", route="cuda",
             tensor_cores=sass["paged_attention"],
             source="ray_tpu_torch/csrc/paged_attention.cu",
             replaces="ray_tpu/ops/pallas/paged_attention.py:60",
             launches=sum(serve_k4.values()), launches_by_path=serve_k4,
             at="8 slots, 8 kv heads, g 4, hd 128, bs 16, bf16 pool, "
                "3044 live tokens",
             library_note="no single PyTorch call computes paged decode",
             tolerance=K4_TOL, card=card, **k4),
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
