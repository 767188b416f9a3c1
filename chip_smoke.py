"""Drive ray_tpu_torch's serving path on one CUDA card and check it.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) when it fails:
  1. the card's name and power limit (nvidia-smi);
  2. build every kernel from ray_tpu_torch/csrc with nvcc, in parallel;
  3. each kernel against its plain PyTorch version on the card, at the
     serving path's shapes, with its time beside the plain version's, a
     library call's where one computes the same function, and the least
     time the card could take (its bound);
  4. LLMEngine serving Llama-3-8B at full width (32 layers, random bf16
     weights from a fixed seed): concurrent greedy requests, a chunked
     long prompt and a prefix hit, with the kernels' launch counts over
     that phase; then a steady-state decode step and prefill, timed and
     traced for the device's busy share;
  5. one JSON line with every kernel's numbers;
  6. the last line, {"ok": true, "device": {...}}.
Without a CUDA device it exits non-zero and prints no result.
"""

from __future__ import annotations

import asyncio
import dataclasses
import json
import subprocess
import sys
import time

import numpy as np
import torch

PEAK_BYTES_S = 3.35e12      # H100 SXM HBM3
PEAK_BF16_FLOPS = 989e12    # H100 SXM dense bf16 tensor cores
# K1, bf16: per (query row, head), |kernel - plain|_2 / |plain|_2 over
# head_dim. The two differ by the bf16 rounding of q*scale (the kernel
# folds the scale into q as the TPU kernel does) and of the output, each
# once: a few 1e-3 at any row's scale. A KV tile dropped or doubled moves
# a row by several percent.
K1_ROW_REL_TOL = 1e-2
K4_TOL = dict(atol=1e-4, rtol=0.0)    # f32 math on identical bf16 values
LOGITS_REL_TOL = 5e-2                 # 32 bf16 layers, kernel vs plain


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
    L2 between two attention calls)."""
    flush = torch.empty(32 * 2 ** 20, dtype=torch.float32, device="cuda")
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        times.append((start, end))
    torch.cuda.synchronize()
    return float(np.mean([s.elapsed_time(e) for s, e in times]))


def bound_ms(work: dict):
    t_bytes = work["bytes"] / PEAK_BYTES_S * 1e3
    t_ops = work["flops"] / PEAK_BF16_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else
                                 "operations")


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
            b, by = bound_ms(fa.work(1, sq, sk, h, kvh, d, 2))
            timed = dict(ms=time_ms(kernel), plain_ms=time_ms(plain),
                         library_ms=time_ms(library), bound_ms=b,
                         bound_by=by)
            print(f"K1 flash s=512: kernel {timed['ms']:.4f} ms, plain "
                  f"{timed['plain_ms']:.4f} ms, SDPA {timed['library_ms']:.4f}"
                  f" ms, bound {b:.4f} ms ({by})")
        if off is not None:
            b, by = bound_ms(fa.work(1, sq, sk, h, kvh, d, 2, q_offset=off))
            print(f"K1 flash chunk sq={sq} sk={sk} q_offset={off}: kernel "
                  f"{time_ms(kernel):.4f} ms, plain {time_ms(plain):.4f} ms,"
                  f" bound {b:.4f} ms ({by})")
    return dict(max_abs_err=worst, max_row_rel_err=worst_rel, **timed)


def check_paged(pa, gen) -> dict:
    """K4 on the slice's shapes: 8 slots, 8 kv heads, group 4, head_dim
    128, block 16, table width 64 (max_len 1024), bf16 pool, uneven
    lengths from 1 to 1024 over disjoint tables whose blocks are a
    seeded permutation of the pool (so a kernel must read the table)."""
    slots, kvh, g, hd, bs, w = 8, 8, 4, 128, 16, 64
    nb = 1 + slots * w
    q = torch.randn((slots, kvh, g, hd), generator=gen, device="cuda",
                    dtype=torch.bfloat16)
    kp = torch.randn((nb, bs, kvh, hd), generator=gen, device="cuda",
                     dtype=torch.bfloat16)
    vp = torch.randn((nb, bs, kvh, hd), generator=gen, device="cuda",
                     dtype=torch.bfloat16)
    tables = (1 + torch.randperm(slots * w, generator=gen, device="cuda")
              ).to(torch.int32).reshape(slots, w)
    lens = [1, 1024, 17, 300, 511, 64, 999, 128]
    lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")

    def kernel():
        return pa.paged_attention(q, kp, vp, tables, lengths)

    def plain():
        return pa.paged_attention_reference(q, kp, vp, tables, lengths)

    got, want = kernel(), plain()
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    ok = torch.allclose(got, want, **K4_TOL)
    print(f"K4 paged lengths={lens}: max_abs_err {err:.3e} (tol atol "
          f"{K4_TOL['atol']}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("K4 disagrees with its plain version")
    full = torch.full_like(lengths, w * bs)
    got_full = pa.paged_attention(q, kp, vp, tables, full)
    want_full = pa.paged_attention_reference(q, kp, vp, tables, full)
    err = max(err, (got_full - want_full).abs().max().item())
    if not torch.allclose(got_full, want_full, **K4_TOL):
        raise SystemExit("K4 disagrees with its plain version at 1024")
    b, by = bound_ms(pa.work(lens, kvh, g, hd, 2, 2))
    timed = dict(ms=time_ms(kernel), plain_ms=time_ms(plain),
                 library_ms=None, bound_ms=b, bound_by=by)
    print(f"K4 paged: kernel {timed['ms']:.4f} ms, plain "
          f"{timed['plain_ms']:.4f} ms, bound {b:.4f} ms ({by}); all "
          f"slots at 1024: kernel "
          f"{time_ms(lambda: pa.paged_attention(q, kp, vp, tables, full)):.4f}"
          f" ms, bound {bound_ms(pa.work([w * bs] * slots, kvh, g, hd, 2, 2))[0]:.4f} ms")
    return dict(max_abs_err=err, **timed)


def run_engine(card: str):
    """Llama-3-8B at full width through LLMEngine: 8 concurrent greedy
    requests (16-500 tokens) plus a 700-token prompt (chunked prefill,
    second piece at q_offset 512), then a request repeating a 256-token
    prefix of the first prompt (prefix hit)."""
    from ray_tpu_torch.llm import model as lm
    from ray_tpu_torch.llm.engine import LLMEngine
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.ops import flash_attention as fa
    from ray_tpu_torch.ops import paged_attention as pa

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

    async def timed(eng, p):
        t_sub = time.monotonic()
        out = await eng.generate(p, max_new_tokens=new)
        return out, t_sub, time.monotonic()

    async def drive():
        eng = LLMEngine(cfg, model, max_slots=8, max_len=1024,
                        prefill_buckets=(64, 128, 256, 512))
        t_start = time.monotonic()
        first = await asyncio.gather(*[timed(eng, p) for p in prompts])
        wall = time.monotonic() - t_start
        hit = await timed(eng, repeat)
        stats = eng.stats
        await eng.stop()
        return first, wall, hit, stats

    fa.flash_attention_fwd.launches = 0
    pa.paged_attention.launches = 0
    first, wall, hit, stats = asyncio.run(drive())
    launches = {"flash_attention_fwd": fa.flash_attention_fwd.launches,
                "paged_attention": pa.paged_attention.launches}
    for out, _, _ in first + [hit]:
        toks = out["tokens"]
        if len(toks) != new or not all(0 <= t < cfg.vocab_size
                                       for t in toks):
            raise SystemExit(f"bad generation: {toks}")
    if hit[0]["prefix_hit_tokens"] <= 0:
        raise SystemExit("the repeated prefix took no prefix hit")
    if min(launches.values()) <= 0:
        raise SystemExit(f"a kernel was not launched: {launches}")
    ttft = [o["ttft_s"] for o, _, _ in first]
    tpot = [(done - (t_sub + o["ttft_s"])) / (len(o["tokens"]) - 1)
            for o, t_sub, done in first]
    print(f"engine [{card}]: {len(first)} concurrent requests + 1 prefix "
          f"hit ({hit[0]['prefix_hit_tokens']} tokens), {new} new tokens "
          f"each; TTFT p50 {np.median(ttft) * 1e3:.1f} ms, TPOT p50 "
          f"{np.median(tpot) * 1e3:.2f} ms, "
          f"{len(first) * new / wall:.1f} generated tok/s over "
          f"{wall:.2f} s; launches {launches}; stats {stats}")

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
    return launches, model, cfg


def breakdown(model, cfg, card: str) -> None:
    """Where a steady-state step goes: one decode block (8 slots at 512
    cached tokens, 8 chained greedy steps, one host sync) and one
    512-token prefill, each timed by the host clock around work ending in
    a sync, and traced once with torch.profiler for the device's busy
    time (kernel intervals) and its largest kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

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

    for name, fn, per in (("decode step", decode_block, n),
                          ("prefill 512", prefill, 1)):
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
        print(f"{name} [{card}]: host wall {wall:.3f} ms, device busy "
              f"{busy:.3f} ms, device idle share {idle}; top kernels (ms): "
              + "; ".join(f"{k[:60]} {v:.3f}" for k, v in top))


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
    print(f"build: {len(reports)} kernels in {time.monotonic() - t0:.1f} s")
    for name, log in reports.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    gen = torch.Generator(device="cuda").manual_seed(1234)
    k1 = check_flash(fa, gen)
    k4 = check_paged(pa, gen)
    launches, model, cfg = run_engine(card)
    breakdown(model, cfg, card)

    kernels = [
        dict(name="flash_attention_fwd", route="cuda",
             source="ray_tpu_torch/csrc/flash_attention_fwd.cu",
             replaces="ray_tpu/ops/pallas/flash_attention.py:79",
             launches=launches["flash_attention_fwd"],
             tolerance={"row_rel_l2": K1_ROW_REL_TOL}, card=card, **k1),
        dict(name="paged_attention", route="cuda",
             source="ray_tpu_torch/csrc/paged_attention.cu",
             replaces="ray_tpu/ops/pallas/paged_attention.py:60",
             launches=launches["paged_attention"],
             tolerance=K4_TOL, card=card, **k4),
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
