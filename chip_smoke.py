#!/usr/bin/env python
"""Drive the PyTorch port's serving and training paths (GPT-2 and
ResNet-50) once on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Phases, each a line of JSON on stdout; any failure raises (non-zero exit,
no final line):

1. env: the card (``nvidia-smi`` name and power limit), torch and CUDA.
2. build: every kernel under ``frl_distributed_ml_scaffold_tpu_torch/ops/
   csrc`` compiled by nvcc, all in parallel, the seconds it took, and the
   registers and spill bytes of the bf16 dQ and contiguous decode kernels
   (the full ``-Xptxas -v`` reports go to ``OUT_DIR/ptxas_*.txt``).
3. kernel checks: each kernel held against its plain PyTorch version on
   the card at the serving paths' shapes, bf16 and fp32, plus a
   dirty-cache check (NaN where no row's occupancy reaches must leave the
   output bit-identical); then timed against the plain version (and one
   library call where one computes the same function), beside its bound:
   - contiguous decode: 8 slots, 16 heads, head_dim 64, S in {128, 1024},
     occupancies 1, S, random and > S; then the edges of its split over
     positions through a strided q: S = 4096, one slot (8 splits), two
     slots (4 splits) and 24 slots (B*H = 384: one split), with kv_len
     1, > S and lengths no chunk divides; and the kernel alone at every
     split count at S = 1024;
   - paged decode and verify (T = 5): the same rows and heads, block size
     16, 64-column tables into a 513-block pool with shuffled tables,
     occupancies 1, 16, 17, 1024, > 1024 (a retired row) and random;
     verify query 0 must equal the paged decode kernel bit for bit. Then
     the edges of the bf16-q kernels' split (``csrc/paged_tc.cuh``): T =
     1..8 at every forced split count 1..8 over occupancies that cross
     split boundaries and kv_len - T + 1 < 1, one slot (8 splits) and 24
     slots (one split), through a strided q; each held to the plain
     version, NaN past every row's occupancy bit-identical, query 0
     equal to the decode at the same split count bit for bit; timed at
     every split count (``ms_by_splits``).
   - quantized cache (``csrc/quant_attention.cu``; for bf16 q all three
     through ``csrc/paged_tc.cuh``, the contiguous one without its
     table): the three kernels in int8, fp8_e4m3 and fp8_e5m2, bf16 and
     fp32 q, at the same shapes (contiguous S in {128, 1024} and the
     contiguous edges above, bf16 also at every forced split count 1..8;
     the paged pool and T = 5, and the paged edges above), each against
     its plain version; NaN in the scales (and 0x7F in the payloads) of
     every position no row's occupancy reaches leaves the output
     bit-identical; quantized verify query 0 equals the quantized paged
     decode bit for bit. Timed in the format its path runs, the
     contiguous one also at every split count (``ms_by_splits``).
4. path: GPT-2-medium at full width (``gpt2_medium_serve``, seeded random
   weights, bf16_mixed) serving 16 requests through ``build_engine`` with
   8 slots over the bucketed cache; the decode kernel must launch 24 times
   per decode step, and no other kernel. One decode step's logits through
   the kernel against ``impl="dense"``. Then a few steady decode steps
   under ``torch.profiler``: device busy time, idle share and the kernels
   that take the device time.
5. paged_path: the same model with ``serving.kv_block_size=16
   serving.speculate=ngram serving.speculate_k=4`` serving 16 requests (8
   sharing a 256-token system prompt, 2 repeating a 32-token pattern, 6
   random); the paged decode and verify kernels must launch 24 times per
   paged decode and verify step and no other kernel; prefix hits, block
   appends and drafts must happen, every reservation unwinds, and the
   pool block's bytes equal the estimate. Then a profiled window.
6. quant_path and quant_paged_path: phases 4 and 5 again with
   ``model.kv_cache_quant=int8`` (contiguous) and ``fp8_e4m3`` (paged),
   through the quantized kernels, the unquantized ones launching never;
   the cache's bytes per slot and the pool block's bytes (811008) equal
   their estimates. In quant_path's profiled window the only attention
   kernel on the device is ``paged_tc.cuh``'s contiguous mode.
7. fp32 checks: the same requests under the fp32 policy, two of them
   re-run alone through ``generate()``, token for token; and the paged
   requests through the fp32 paged + ngram engine against the fp32
   contiguous engine, token for token; both again over the int8
   contiguous and the fp8_e4m3 paged cache (``fp32_quant_check``). A
   differing greedy pick passes only where the top-2 logit gap there is
   below ``FP32_GAP_TOL``.
8. flash_kernel_checks: the three training-attention kernels
   (``csrc/flash_attention.cu``: forward, dQ, dK/dV) against their plain
   versions, O and lse, dQ, dK and dV, bf16 and fp32, causal and not, at
   the training path's [8, 1024, 16, 64], gpt2_long's [1, 8192, 16, 64],
   T = 1000 (not a multiple of the 64-row tile), T = 40 (below one tile)
   and head dims 32 and 128;
   then gradients through the autograd Function at the path shape
   against torch.autograd of the plain forward (fp32) and the plain
   backward (bf16). flash_kernel_timings: each kernel, its plain version
   and ``scaled_dot_product_attention`` (forward, or its backward), beside
   the bound, at both shapes, bf16, causal.
9. train_path: ``gpt2_medium_zero1`` with ``model.attention=flash`` at
   full width and depth (seeded weights, bf16_mixed, AdamW with the
   recipe's warmup, cosine and clip, dots remat, 64 x 1024 tokens in 8
   microbatches): one warm-up step (lr 0, the params must not move) and
   three timed steps; loss, grad_norm and lr per step, step seconds,
   tokens/s, model FLOPs and their share of the bf16 peak, peak memory;
   each step launches the forward kernel 384 times (twice per layer and
   microbatch: dots remat reruns it in the backward) and dQ and dK/dV 192
   times each, no serving kernel, and nothing falls back. train_profile:
   one more step under ``torch.profiler``.
10. fp32_train_check: one ``grad_accum=2`` step at full width, depth cut
   to 2 layers, through the kernels (``attention=flash``) and through the
   plain path (``attention=dense``) from the same weights and batch, fp32
   and then bf16_mixed: losses, every gradient and the params after it.
11. bn_kernel_checks / bn_kernel_timings: the two BatchNorm-backward
   kernels (``csrc/fused_bn.cu``: sums, dx) against their plain versions
   and, chained, against ``fallback_bwd``, bf16 and fp32, random gamma,
   at the rn50 path's (M, C) for the stem (3211264, 64), stage 1
   (802816, 256) and stage 4 (12544, 2048), and a ragged (12347, 100);
   timed beside their byte bounds and ``native_batch_norm_backward``.
   adamw_kernel_checks / adamw_kernel_timings: the AdamW kernel
   (``csrc/fused_adamw.cu``) against ``adamw_math`` on leaves of
   2359296, 2048000, 65536 and 65539 elements, the first and last again
   with a bf16 gradient (read in place); timed beside its bound
   (28 bytes an element) and ``torch._fused_adamw_``.
12. rn50_path: ``imagenet_rn50_ddp`` with ``model.fused_bn=true
   data.global_batch_size=256`` at full width and depth (seeded weights,
   bf16_mixed, the recipe's SGD with warmup, synthetic ImageNet batches
   on the card before the timed window): one warm-up step (lr 0: params
   unchanged, every running statistic moved) and three timed steps;
   loss, accuracy, grad_norm and lr per step, step seconds, images/s,
   FLOPs (``FlopCounterMode``) and their share of the bf16 peak, peak
   memory; each step launches each BN kernel 53 times and no other
   kernel. rn50_profile: one more step under ``torch.profiler``.
   rn50_adamw_path: the same with ``optimizer.name=fused_adamw``, two
   timed steps, the AdamW kernel 42 times per step.
13. fp32_rn50_check: one step of ResNet-50 (64 px, batch 8) through the
   kernels and through the plain path from the same weights and batch,
   fp32 and bf16_mixed, SGD and fused_adamw, and bf16 (bf16 gradients
   into the AdamW kernel) with fused_adamw: loss, every gradient,
   batch_stats and the params after it.
14. ``phase_seconds`` (the build, each phase above and the whole run),
   the ``kernels`` line (twelve kernels) and, last, ``{"ok": true,
   "device": ...}``.

Every launch count is set to 0 just before each path runs and read just
after it; a kernel's ``launches`` in the kernels line is that of its path.

Nothing here imports JAX. The CUDA check comes first: without a card the
script exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time

import torch

REPO = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(REPO, "chiprun_out")
# H100 SXM published peaks (NVIDIA data sheet, dense): HBM3 3.35 TB/s,
# bf16 tensor cores 989 TFLOP/s, fp32 outside the tensor cores 67 TFLOP/s.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
# Kernel vs plain version. bf16: both round the output to bf16 (ulp 2^-7
# relative) and the kernel rounds unnormalised probabilities where the
# plain version rounds normalised ones, so allow a few ulps at |o| <= 4.
# fp32: only summation order and expf differ.
TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-5}
# Greedy picks of the fp32 engine (batch 8) and generate() (batch 1) may
# take different cuBLAS algorithms; a differing pick passes only where the
# top-2 logit gap there is below this (fp32 reassociation noise).
FP32_GAP_TOL = 1e-3


def emit(key: str, value) -> None:
    print(json.dumps({key: value}), flush=True)


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(msg)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


# Kernels whose registers and spills the build line reports (nvcc's
# -Xptxas -v): those this script's latest redesigns touched.
PTXAS_KERNELS = ("flash_bwd_dq_tc_kernel", "decode_attention_kernel",
                 "paged_tc_kernel")


def ptxas_summary(reports: dict) -> list:
    """Registers and spill bytes of every instantiation of
    ``PTXAS_KERNELS`` from the build's ``-Xptxas -v`` reports, its
    template arguments demangled (bf16 / float, D, causal)."""
    out = []
    for source, report in reports.items():
        lines = report.splitlines()
        for i, line in enumerate(lines):
            if "Compiling entry function" not in line:
                continue
            mangled = line.split("'")[1]
            name = next((n for n in PTXAS_KERNELS if n in mangled), None)
            if name is None:
                continue
            args = re.search(name + r"I(.*?)EEv", mangled)
            args = args[1] if args else ""
            for pat, rep in ((r"13__nv_bfloat16", "bf16,"), (r"^f", "float,"),
                             (r"Li(\d+)E", r"\1,"), (r"Lb1E", "true,"),
                             (r"Lb0E", "false,")):
                args = re.sub(pat, rep, args)
            block = " ".join(lines[i + 1: i + 4])
            regs = re.search(r"Used (\d+) registers", block)
            spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                              r"loads", block)
            out.append({"source": source,
                        "kernel": f"{name}<{args.rstrip(',')}>",
                        "registers": int(regs[1]) if regs else None,
                        "spill_store_bytes": int(spill[1]) if spill else None,
                        "spill_load_bytes": int(spill[2]) if spill else None})
    return out


def cuda_time_ms(fn, repeats: int = 20, per_call: int = 1,
                 queued: bool = True) -> float:
    """Median over ``repeats`` of CUDA-event time of ``fn()``, divided by
    the ``per_call`` launches it makes. ``queued``: a spin kernel holds
    the stream while the host enqueues ``fn``'s launches, so the events
    time the device alone; without it they time what a caller that
    launches one by one sees (host overhead included)."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(repeats):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        if queued:
            torch.cuda._sleep(20_000_000)  # ~10 ms at H100 clocks
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / per_call)
    return statistics.median(times)


# ------------------------------------------------------------------ kernels

# Payload formats of the quantized kernels (csrc/quant_attention.cu).
QUANT_FORMATS = ("int8", "fp8_e4m3", "fp8_e5m2")
PAGED_BS, PAGED_COLS, VERIFY_T = 16, 64, 5


def cache_pair(gen, shape, dtype, fmt):
    """K and V of ``shape [..., H, D]`` from the generator, in ``dtype``
    or, with ``fmt``, quantized as the model writes its cache. Returns
    (k, v, scales): scales are the routers' ``k_scale`` / ``v_scale``
    keywords (bf16, ``shape`` without D), empty when unquantized."""
    from frl_distributed_ml_scaffold_tpu_torch.ops.quantization import quantize_kv

    k = torch.randn(shape, generator=gen, device="cuda")
    v = torch.randn(shape, generator=gen, device="cuda")
    if fmt is None:
        return k.to(dtype), v.to(dtype), {}
    (k, ks), (v, vs) = quantize_kv(k, fmt), quantize_kv(v, fmt)
    return k, v, {"k_scale": ks, "v_scale": vs}


def at(scales: dict, i) -> dict:
    """The scale keywords indexed like their cache."""
    return {name: s[i] for name, s in scales.items()}


def poisoned(k, v, scales: dict, dead):
    """Copies of a cache with NaN wherever ``dead`` (over its leading
    dims) is True: in K and V or, quantized, in the scales and as payload
    byte 0x7F (NaN in both fp8 formats; int8 has no NaN, and 0x7F is its
    largest value)."""
    from frl_distributed_ml_scaffold_tpu_torch.ops.quantization import byte_view

    if not scales:
        kd, vd = k.clone(), v.clone()
        kd[dead], vd[dead] = float("nan"), float("nan")
        return kd, vd, {}
    kd, vd = (byte_view(x).clone() for x in (k, v))
    kd[dead], vd[dead] = 0x7F, 0x7F
    sd = {name: s.clone() for name, s in scales.items()}
    for s in sd.values():
        s[dead] = float("nan")
    return kd.view(k.dtype), vd.view(v.dtype), sd


def held(what: str, got, want, dirty, dtype) -> float:
    """The kernel's output against its plain version within ``TOL``, and
    bit-identical with a poisoned cache. Returns the max abs error."""
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    check(math.isfinite(err) and err <= TOL[dtype],
          f"{what} {dtype}: max abs err {err} > {TOL[dtype]}")
    check(torch.equal(dirty, got),
          f"{what} {dtype}: output changed with NaN where no row's "
          "occupancy reaches")
    return err


def _worst(checks: list, key: str) -> float:
    return max(e[key] for e in checks if e["dtype"] == "bfloat16")


def timed(kernel, plain, library=None, *, layers: int) -> dict:
    """``kernel(i)`` and ``plain(i)`` (and ``library(i)``) swept over
    ``layers`` layers per timed call, as a step does (so each launch finds
    its cache outside L2, like the real step), in the order plain, kernel,
    kernel, plain, library; per launch. Plus the kernel's launches
    enqueued one by one from Python, as the step sees them."""
    def sweep(op):
        def fn():
            for i in range(layers):
                op(i)
        return fn

    ms = {}
    order = [("plain", plain), ("kernel", kernel), ("kernel2", kernel),
             ("plain2", plain)] + ([("library", library)] if library else [])
    for name, op in order:
        ms[name] = cuda_time_ms(sweep(op), per_call=layers)
    return {
        "ms": statistics.median([ms["kernel"], ms["kernel2"]]),
        "plain_ms": statistics.median([ms["plain"], ms["plain2"]]),
        "library_ms": ms.get("library"),
        "unqueued_ms": cuda_time_ms(sweep(kernel), per_call=layers,
                                    queued=False),
        "order_plain_kernel_kernel_plain": [
            ms["plain"], ms["kernel"], ms["kernel2"], ms["plain2"]],
    }


def attention_bound(kv_len, cap: int, q, dtype, fmt, blocks: int = 0) -> dict:
    """The least time of one launch. Bytes: K and V at every occupied
    (position, head), D elements of ``dtype`` each or, quantized, D
    payload bytes and a 2-byte scale; the ``blocks`` table entries the
    occupancy reaches; q, o and kv_len. Operations: 4 D per (query,
    position, head) the causal occupancy admits."""
    b, h, d = q.shape[1], q.shape[-2], q.shape[-1]
    t = q.shape[2] if q.dim() == 5 else 1
    elem = torch.finfo(dtype).bits // 8
    per_kv = d * elem if fmt is None else d + 2
    n = int(kv_len.clamp(1, cap).sum())
    nbytes = (2 * n * h * per_kv + 2 * b * t * h * d * elem
              + 4 * blocks + 4 * b)
    n_q = sum(int((kv_len - (t - 1) + j).clamp(1, cap).sum())
              for j in range(t))
    flops = 4 * n_q * h * d
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return {"bytes": nbytes, "flops": flops, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


QUANT_LIBRARY_NOTE = ("no single PyTorch call attends over a 1-byte cache "
                      "with per-position scales")


def decode_inputs(gen, dtype, s, *, fmt=None, b=8, h=16, d=64, layers=1):
    """q [L, B, H, D], caches [L, B, S, H, D] (strided views into a
    2S-capacity buffer, as a grown engine cache would be; quantized to
    ``fmt`` with scales [L, B, S, H]), kv_len [B]: occupancies 1, S, > S
    and random ones in between."""
    dev = "cuda"
    q = torch.randn((layers, b, h, d), generator=gen, device=dev).to(dtype)
    k, v, sc = cache_pair(gen, (layers, b, 2 * s, h, d), dtype, fmt)
    k, v = k[:, :, :s], v[:, :, :s]
    sc = {name: x[:, :, :s] for name, x in sc.items()}
    mid = torch.randint(2, s, (b - 3,), generator=gen, device=dev)
    kv_len = torch.cat([
        torch.tensor([1, s, s + 37], device=dev), mid,
    ]).to(torch.int32)
    return q, k, v, kv_len, sc


# Split edges of the contiguous kernels (csrc/decode_attention.cu and,
# quantized with bf16 q, csrc/paged_tc.cuh without its table), beyond the
# path's shapes: (B, H, S) and occupancies. kv_len 1, > S and values no
# split's chunk divides; S = 4096 at the path's 8 x 16 (one split, 16
# passes); one slot (8 splits); two slots (4 splits); B*H = 384 >= 2 x
# 132 SMs (one split).
DECODE_EDGES = {
    "S4096": (8, 16, 4096, [1, 4101, 3001, 2999, 129, 4095, 1025, 7]),
    "one_slot": (1, 16, 4096, [2999]),
    "two_slots": (2, 16, 1024, [1000, 1030]),
    "wide_BH": (24, 16, 1024, [1, 1029, 1000] + list(range(5, 1024, 49))),
}


def _decode_case(dtype, q, k, v, kv_len, sc, what: str,
                 splits=None) -> float:
    """One contiguous decode call held against its plain version, and
    bit-identical with NaN past each row's occupancy (the kernel must
    never read those positions). Through the router, or with ``splits``
    the launch wrapper at that split count."""
    from frl_distributed_ml_scaffold_tpu_torch.ops import decode_attention as da

    def run(k, v, sc):
        if splits is None:
            return da.decode_attention(q, k, v, kv_len, **sc)
        launch = da._flash_decode_quant if sc else da._flash_decode
        return launch(q, k, v, kv_len, **sc, splits=splits)

    got = run(k, v, sc)
    want = da.decode_attention(q, k, v, kv_len.clamp_min(1), impl="dense",
                               **sc)
    dead = torch.arange(k.shape[1], device="cuda")[None, :] >= kv_len[:, None]
    kd, vd, sd = poisoned(k, v, sc, dead)
    return held(what, got, want, run(kd, vd, sd), dtype)


def decode_checks(gen, fmt=None) -> list:
    """The contiguous decode kernel (over a cache quantized to ``fmt``,
    or not) against its plain version, bf16 and fp32, S in {128, 1024};
    then at the split edges of ``DECODE_EDGES`` through a strided q and,
    quantized with bf16 q, at S = 1024 at every forced split count."""
    from frl_distributed_ml_scaffold_tpu_torch.ops import decode_attention as da

    name = fmt or "unquantized"
    checks = []
    for dtype in (torch.bfloat16, torch.float32):
        dt = str(dtype).replace("torch.", "")
        for s in (128, 1024):
            q, k, v, kv_len, sc = decode_inputs(gen, dtype, s, fmt=fmt)
            q, k, v, sc = q[0], k[0], v[0], at(sc, 0)
            err = _decode_case(dtype, q, k, v, kv_len, sc,
                               f"decode kernel {name} S={s}")
            checks.append({"format": fmt or "none", "dtype": dt, "S": s,
                           "kv_len": kv_len.tolist(), "max_abs_err": err,
                           "tol": TOL[dtype], "dirty_cache_equal": True})
        if fmt is not None and dtype == torch.bfloat16:
            # The S = 1024 inputs at every split count 1..8.
            errs = [_decode_case(dtype, q, k, v, kv_len, sc,
                                 f"decode kernel {name} S=1024 splits={n}",
                                 splits=n)
                    for n in range(1, da.MAX_DECODE_SPLITS + 1)]
            checks.append({"format": fmt, "dtype": dt, "S": 1024,
                           "forced_splits": list(range(
                               1, da.MAX_DECODE_SPLITS + 1)),
                           "kv_len": kv_len.tolist(),
                           "max_abs_err": max(errs), "tol": TOL[dtype],
                           "dirty_cache_equal": True})
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        # The edges draw from a generator of their own, so the weights and
        # inputs of every later phase stay what they were without them.
        egen = torch.Generator(device="cuda").manual_seed(
            gen.initial_seed() + 1)
        for label, (b, h, s, lens) in DECODE_EDGES.items():
            d = 64
            q = torch.randn((b, h, 3 * d), generator=egen,
                            device="cuda").to(dtype)[..., d: 2 * d]
            k, v, sc = cache_pair(egen, (b, 2 * s, h, d), dtype, fmt)
            k, v = k[:, :s], v[:, :s]
            sc = {key: x[:, :s] for key, x in sc.items()}
            kv_len = torch.tensor(lens, dtype=torch.int32, device="cuda")
            err = _decode_case(dtype, q, k, v, kv_len, sc,
                               f"decode kernel {name} edge {label}")
            checks.append({"format": fmt or "none", "edge": label,
                           "dtype": dt, "B": b, "H": h, "S": s,
                           "q_strided": True,
                           "splits": da.decode_splits(b * h, s, sms),
                           "kv_len": lens, "max_abs_err": err,
                           "tol": TOL[dtype], "dirty_cache_equal": True})
    return checks


def time_decode(gen, s: int, fmt=None) -> dict:
    """The contiguous kernel (quantized to ``fmt`` or not), its plain
    version and, unquantized, one library call on the path's shapes
    (bf16 q, 24 layers' caches per timed call); then the kernel alone at
    every split count."""
    from frl_distributed_ml_scaffold_tpu_torch.ops import decode_attention as da

    layers, dtype = 24, torch.bfloat16
    q, k, v, kv_len, sc = decode_inputs(gen, dtype, s, fmt=fmt, layers=layers)
    scs = [at(sc, i) for i in range(layers)]
    lens = kv_len.clamp_min(1)
    pos = torch.arange(s, device="cuda")
    mask = (pos[None, :] < lens[:, None])[:, None, None, :]  # [B,1,1,S]

    def kernel(i):
        da.decode_attention(q[i], k[i], v[i], kv_len, **scs[i])

    def plain(i):
        da.decode_attention(q[i], k[i], v[i], lens, impl="dense", **scs[i])

    def library(i):
        torch.nn.functional.scaled_dot_product_attention(
            q[i][:, :, None], k[i].transpose(1, 2), v[i].transpose(1, 2),
            attn_mask=mask,
        )

    report = timed(kernel, plain, None if fmt else library, layers=layers)
    if fmt:
        report["library_note"] = QUANT_LIBRARY_NOTE
    report["splits"] = da.decode_splits(
        q.shape[1] * q.shape[2], s,
        torch.cuda.get_device_properties(0).multi_processor_count)
    # The kernel alone (no router) at every split count, against which
    # decode_splits' choice is read.
    launch = da._flash_decode_quant if fmt else da._flash_decode
    report["ms_by_splits"] = {
        n: cuda_time_ms(lambda n=n: [
            launch(q[i], k[i], v[i], kv_len, **scs[i], splits=n)
            for i in range(layers)], per_call=layers)
        for n in range(1, da.MAX_DECODE_SPLITS + 1)}
    return {"S": s, "format": fmt or "none", "kv_len": kv_len.tolist(),
            **report, **attention_bound(kv_len, s, q, dtype, fmt)}


def kernel_phase(gen) -> dict:
    checks = decode_checks(gen)
    emit("kernel_checks", checks)
    timings = [time_decode(gen, s) for s in (128, 1024)]
    emit("kernel_timings", timings)
    return {"max_abs_err": _worst(checks, "max_abs_err"),
            "timing": timings[-1]}


# ------------------------------------------------------------ paged kernels


def paged_inputs(gen, dtype, *, fmt=None, t=None, layers=1, b=8, h=16, d=64):
    """q ([L, B, H, D], or [L, B, T, H, D] for the verify tile), pools
    [L, N, bs, H, D] with N = B * 64 + 1 (block 0 the trash block;
    quantized to ``fmt`` with scale pools [L, N, bs, H]), shuffled tables
    [B, 64] over blocks 1.. and kv_len [B]: occupancies 1, 16, 17, 1024,
    > 1024 (a retired row) and random ones."""
    dev, bs, m = "cuda", PAGED_BS, PAGED_COLS
    n = b * m + 1
    qshape = (layers, b, h, d) if t is None else (layers, b, t, h, d)
    q = torch.randn(qshape, generator=gen, device=dev).to(dtype)
    k, v, sc = cache_pair(gen, (layers, n, bs, h, d), dtype, fmt)
    perm = torch.randperm(n - 1, generator=gen, device=dev) + 1
    tables = perm.view(b, m).to(torch.int32)
    cap = m * bs
    mid = torch.randint(2, cap, (b - 5,), generator=gen, device=dev)
    kv_len = torch.cat([
        torch.tensor([1, bs, bs + 1, cap, cap + 37], device=dev), mid,
    ]).to(torch.int32)
    return q, k, v, kv_len, tables, sc


def _used_positions(kv_len, tables, n_blocks):
    """[N, bs] bool: the pool positions some row's occupancy reaches."""
    bs = PAGED_BS
    used = torch.zeros((n_blocks, bs), dtype=torch.bool, device="cuda")
    pos = torch.arange(tables.shape[1] * bs, device="cuda")
    for row, n in enumerate(kv_len.clamp(1, pos.numel()).tolist()):
        p = pos[:n]
        used[tables[row, p // bs].long(), p % bs] = True
    return used


# Split edges of the paged kernels for bf16 q (csrc/paged_tc.cuh), beyond
# the path's shapes: (B, H, table columns, occupancies), block size 16.
# "grid": 16 columns (16 tiles, so every split count 1..8 has work),
# occupancies that cross split boundaries, one past the table and 2
# (kv_len - T + 1 < 1 from T = 3), swept over T = 1..8 and every forced
# split count. "one_slot": one row, 128 columns (paged_splits: 8).
# "wide": 24 slots, B*H = 384 >= 132 SMs (one split).
PAGED_EDGES = {
    "grid": (6, 4, 16, [2, 33, 97, 130, 200, 263]),
    "one_slot": (1, 16, 128, [1999]),
    "wide": (24, 16, 64, [1, 1030, 513] + list(range(7, 1024, 49))),
}


def _paged_edge_case(dtype, fmt, q, k, v, kv_len, tables, sc, kd, vd, sd,
                     splits, what: str) -> tuple:
    """The verify tile q ``[B, T, H, D]`` and the decode of its query 0
    (at occupancy kv_len - T + 1, through q[:, 0]'s strided view) at a
    split count (None: ``paged_splits``'s), each held to its plain version
    and bit-identical over the poisoned pools; query 0 equal to the
    decode bit for bit. Returns both max abs errors."""
    from frl_distributed_ml_scaffold_tpu_torch.ops import decode_attention as da

    t = q.shape[1]
    lens = kv_len.clamp_min(1)
    dec_lens = (kv_len - (t - 1)).clamp_min(1)
    outs, errs = {}, []
    for op, qq, n in (("verify", q, lens), ("decode", q[:, 0], dec_lens)):
        launch = getattr(da, f"_flash_paged_{op}")
        plain = getattr(da, f"dense_paged_{op}_attention")
        outs[op] = launch(qq, k, v, n, tables, splits=splits, **sc)
        want = plain(qq, k, v, n, tables, **sc)
        dirty = launch(qq, kd, vd, n, tables, splits=splits, **sd)
        errs.append(held(f"paged {op} kernel {fmt or 'unquantized'} {what}",
                         outs[op], want, dirty, dtype))
    check(torch.equal(outs["verify"][:, 0], outs["decode"]),
          f"paged verify {fmt or 'unquantized'} {dtype} {what}: query 0 "
          "differs from the paged decode kernel")
    return tuple(errs)


def paged_edge_checks(gen, dtype, fmt=None) -> list:
    """``PAGED_EDGES`` through ``_paged_edge_case``: "grid" at T = 1..8 x
    splits 1..8, the others at T = VERIFY_T and the default split. fp32 q
    runs the CUDA-core kernels, which take no split (the count is
    ignored). Inputs from a generator of their own, so every later
    phase's inputs stay what they were without these."""
    from frl_distributed_ml_scaffold_tpu_torch.ops import decode_attention as da

    egen = torch.Generator(device="cuda").manual_seed(gen.initial_seed() + 2)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = []
    for label, (b, h, m, lens) in PAGED_EDGES.items():
        d, bs = 64, PAGED_BS
        n = b * m + 1
        k, v, sc = cache_pair(egen, (n, bs, h, d), dtype, fmt)
        perm = torch.randperm(n - 1, generator=egen, device="cuda") + 1
        tables = perm.view(b, m).to(torch.int32)
        kv_len = torch.tensor(lens, dtype=torch.int32, device="cuda")
        dead = ~_used_positions(kv_len, tables, n)
        kd, vd, sd = poisoned(k, v, sc, dead)
        # q [B, 8, H, D]; tile T is its strided view q8[:, :T].
        q8 = torch.randn((b, da.MAX_VERIFY_TILE, h, d), generator=egen,
                         device="cuda").to(dtype)
        grid = label == "grid"
        cases = [(t, s) for t in range(1, da.MAX_VERIFY_TILE + 1)
                 for s in range(1, da.MAX_DECODE_SPLITS + 1)] if grid else [
            (VERIFY_T, None)]
        errs = [_paged_edge_case(dtype, fmt, q8[:, :t], k, v, kv_len, tables,
                                 sc, kd, vd, sd, s, f"{label} T={t} splits={s}")
                for t, s in cases]
        out.append({"format": fmt or "none", "edge": label,
                    "dtype": str(dtype).replace("torch.", ""),
                    "B": b, "H": h, "table_cols": m, "kv_len": lens,
                    "T": sorted({t for t, _ in cases}),
                    "splits": list(range(1, da.MAX_DECODE_SPLITS + 1))
                    if grid else da.paged_splits(b * h, m * bs, sms),
                    "cases": len(cases), "q_strided": True,
                    "verify_max_abs_err": max(e[0] for e in errs),
                    "decode_max_abs_err": max(e[1] for e in errs),
                    "tol": TOL[dtype], "dirty_equal": True,
                    "verify_query0_bit_equal_decode": True})
    return out


def paged_checks(gen, fmt=None) -> list:
    """The paged decode and verify kernels (over pools quantized to
    ``fmt``, or not) against their plain versions, bf16 and fp32; NaN in
    every pool position no row's occupancy reaches must leave the output
    bit-identical; verify query 0 must equal the paged decode kernel bit
    for bit. Then the split edges (``paged_edge_checks``)."""
    from frl_distributed_ml_scaffold_tpu_torch.ops import decode_attention as da

    checks = []
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v, kv_len, tables, sc = paged_inputs(gen, dtype, fmt=fmt)
        qt = torch.randn((8, VERIFY_T, 16, 64), generator=gen,
                         device="cuda").to(dtype)
        q, k, v, sc = q[0], k[0], v[0], at(sc, 0)
        dead = ~_used_positions(kv_len, tables, k.shape[0])
        kd, vd, sd = poisoned(k, v, sc, dead)
        entry = {"format": fmt or "none",
                 "dtype": str(dtype).replace("torch.", ""),
                 "block_size": PAGED_BS, "table_cols": PAGED_COLS,
                 "pool_blocks": k.shape[0], "kv_len": kv_len.tolist(),
                 "tol": TOL[dtype]}
        for op, qq in (("decode", q), ("verify", qt)):
            router = getattr(da, f"paged_{op}_attention")
            plain = getattr(da, f"dense_paged_{op}_attention")
            got = router(qq, k, v, kv_len, tables, **sc)
            want = plain(qq, k, v, kv_len, tables, **sc)
            dirty = router(qq, kd, vd, kv_len, tables, **sd)
            entry[f"{op}_max_abs_err"] = held(
                f"paged {op} kernel {fmt or 'unquantized'}", got, want,
                dirty, dtype)
            entry[f"{op}_dirty_equal"] = True
        # Query 0 is the single-token step at occupancy n - T + 1.
        dec0 = da.paged_decode_attention(
            qt[:, 0].contiguous(), k, v, kv_len - (VERIFY_T - 1), tables,
            **sc)
        torch.cuda.synchronize()
        check(torch.equal(got[:, 0], dec0),
              f"paged verify {fmt or 'unquantized'} {dtype}: query 0 "
              "differs from the paged decode kernel")
        entry["verify_query0_bit_equal_decode"] = True
        checks.append(entry)
    for dtype in (torch.bfloat16, torch.float32):
        checks += paged_edge_checks(gen, dtype, fmt)
    return checks


def time_paged(gen, op: str, fmt=None) -> dict:
    """A paged kernel (over pools quantized to ``fmt``, or not) and its
    plain version at the path's shapes (bf16 q, 24 layers' pools per
    timed call)."""
    from frl_distributed_ml_scaffold_tpu_torch.ops import decode_attention as da

    layers, dtype = 24, torch.bfloat16
    t = VERIFY_T if op == "verify" else None
    q, k, v, kv_len, tables, sc = paged_inputs(gen, dtype, fmt=fmt, t=t,
                                               layers=layers)
    scs = [at(sc, i) for i in range(layers)]
    router = getattr(da, f"paged_{op}_attention")
    reference = getattr(da, f"dense_paged_{op}_attention")

    def kernel(i):
        router(q[i], k[i], v[i], kv_len, tables, **scs[i])

    def plain(i):
        reference(q[i], k[i], v[i], kv_len, tables, **scs[i])

    cap = PAGED_COLS * PAGED_BS
    n = kv_len.clamp(1, cap).long()
    blocks = int(((n - 1) // PAGED_BS + 1).sum())
    # The kernel alone at every split count (router clamp done), against
    # which paged_splits' choice is read.
    lens = kv_len.clamp_min(1)
    launch = getattr(da, f"_flash_paged_{op}")
    by_splits = {
        s: cuda_time_ms(lambda s=s: [
            launch(q[i], k[i], v[i], lens, tables, splits=s, **scs[i])
            for i in range(layers)], per_call=layers)
        for s in range(1, da.MAX_DECODE_SPLITS + 1)}
    return {
        "op": op, "format": fmt or "none", "T": t or 1,
        "kv_len": kv_len.tolist(), **timed(kernel, plain, layers=layers),
        "splits": da.paged_splits(
            q.shape[1] * q.shape[-2], cap,
            torch.cuda.get_device_properties(0).multi_processor_count),
        "ms_by_splits": by_splits,
        "library_note": QUANT_LIBRARY_NOTE if fmt else
        "no single PyTorch call reads K/V through a block table",
        **attention_bound(kv_len, cap, q, dtype, fmt, blocks),
    }


def paged_kernel_phase(gen) -> dict:
    checks = paged_checks(gen)
    emit("paged_kernel_checks", checks)
    timings = {op: time_paged(gen, op) for op in ("decode", "verify")}
    emit("paged_kernel_timings", timings)
    return {f"paged_{op}_attention": {
        "max_abs_err": _worst(checks, f"{op}_max_abs_err"),
        "timing": timings[op]} for op in ("decode", "verify")}


def quant_kernel_phase(gen) -> dict:
    """The three quantized kernels through the same checks, in every
    payload format and q dtype; then timed in the format its path runs
    (int8 contiguous, fp8_e4m3 paged)."""
    contiguous, paged = [], []
    for fmt in QUANT_FORMATS:
        contiguous += decode_checks(gen, fmt)
        paged += paged_checks(gen, fmt)
    emit("quant_kernel_checks", {"decode": contiguous, "paged": paged})
    timings = {
        "decode_attention_quant": time_decode(gen, 1024, "int8"),
        "paged_decode_attention_quant": time_paged(gen, "decode", "fp8_e4m3"),
        "paged_verify_attention_quant": time_paged(gen, "verify", "fp8_e4m3"),
    }
    emit("quant_kernel_timings", timings)
    worst = {"decode_attention_quant": _worst(contiguous, "max_abs_err")}
    for op in ("decode", "verify"):
        worst[f"paged_{op}_attention_quant"] = _worst(paged,
                                                      f"{op}_max_abs_err")
    return {name: {"max_abs_err": worst[name], "timing": timings[name]}
            for name in timings}


# --------------------------------------------------------------------- path


def requests(seed: int, vocab: int):
    import numpy as np

    rng = np.random.default_rng(seed)
    lens = np.linspace(16, 512, 16).astype(int)
    rng.shuffle(lens)
    return [rng.integers(0, vocab, size=int(n)).astype(np.int32) for n in lens]


def serve(model, cfg, reqs, new_tokens: int):
    from frl_distributed_ml_scaffold_tpu_torch.serving import build_engine

    eng = build_engine(model, serving=cfg.serving, num_slots=8,
                       eos_id=50256, temperature=0.0)
    ids = [eng.submit(p, new_tokens) for p in reqs]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    done = {c.id: c for c in eng.run()}
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    check(sorted(done) == sorted(ids), "not every request completed")
    for rid, p in zip(ids, reqs):
        c = done[rid]
        check(c.finish_reason in ("eos", "length"),
              f"request {rid} finished {c.finish_reason}")
        n_new = len(c.tokens) - len(p)
        check(1 <= n_new <= new_tokens and (c.tokens[: len(p)] == p).all(),
              f"request {rid}: malformed completion")
        check(bool(((c.tokens >= 0) & (c.tokens < cfg.model.vocab_size)).all()),
              f"request {rid}: token out of range")
    return eng, [done[i] for i in ids], wall


# Launch counters: (name in the kernels line, module under ops/, function,
# attribute).
COUNTERS = [
    ("decode_attention", "decode_attention", "decode_attention", "launches"),
    ("paged_decode_attention", "decode_attention", "paged_decode_attention",
     "launches"),
    ("paged_verify_attention", "decode_attention", "paged_verify_attention",
     "launches"),
    ("decode_attention_quant", "decode_attention", "decode_attention",
     "quant_launches"),
    ("paged_decode_attention_quant", "decode_attention",
     "paged_decode_attention", "quant_launches"),
    ("paged_verify_attention_quant", "decode_attention",
     "paged_verify_attention", "quant_launches"),
    ("flash_attention_fwd", "flash_attention", "flash_fwd", "launches"),
    ("flash_attention_bwd_dq", "flash_attention", "flash_bwd_dq", "launches"),
    ("flash_attention_bwd_dkv", "flash_attention", "flash_bwd_dkv",
     "launches"),
    ("bn_bwd_sums", "fused_bn", "bn_sums", "launches"),
    ("bn_bwd_dx", "fused_bn", "bn_dx", "launches"),
    ("fused_adamw", "fused_adamw", "adamw_kernel", "launches"),
]


def _counted(module: str, fn: str):
    import importlib

    mod = importlib.import_module(
        f"frl_distributed_ml_scaffold_tpu_torch.ops.{module}")
    return getattr(mod, fn)


def reset_launches() -> None:
    for _, module, fn, attr in COUNTERS:
        setattr(_counted(module, fn), attr, 0)


def read_launches() -> dict:
    return {name: getattr(_counted(module, fn), attr)
            for name, module, fn, attr in COUNTERS}


def check_launches(counts: dict, per_step: dict, layers: int, what: str):
    """Each kernel in ``per_step`` (name -> steps of its kind) launched
    once per layer per step and at least once; every other kernel
    never."""
    for name, n in counts.items():
        if name in per_step:
            steps = per_step[name]
            check(n == steps * layers and n > 0,
                  f"{what}: {name} launched {n} times in {steps} steps of "
                  f"{layers} layers")
        else:
            check(n == 0, f"{what}: {name} launched {n} times")


def _suffix(cfg) -> str:
    return "" if cfg.model.kv_cache_quant == "none" else "_quant"


def _latencies(comps, wall) -> dict:
    n_tok = sum(len(c.tokens) - c.prompt_len for c in comps)
    tpot = [x for c in comps for x in c.token_latencies_s[1:]]
    ttft = [c.ttft_s for c in comps]
    return {
        "generated_tokens": n_tok, "wall_s": wall,
        "tokens_per_s": n_tok / wall,
        "ttft_mean_s": statistics.mean(ttft),
        "ttft_p50_s": statistics.median(ttft),
        "tpot_mean_s": statistics.mean(tpot),
        "tpot_p50_s": statistics.median(tpot),
    }


def path_phase(cfg, sd, seed: int, card: str) -> tuple:
    """The bucketed contiguous path of ``cfg`` (quantized cache or not):
    16 requests, 8 slots; the decode kernel of the cache's kind launches
    24 times per decode step and no other kernel runs; one decode step's
    logits through the kernel against ``impl="dense"``; a profiled
    window."""
    import dataclasses

    import numpy as np

    from frl_distributed_ml_scaffold_tpu_torch.models import generation
    from frl_distributed_ml_scaffold_tpu_torch.models.gpt import GPT
    from frl_distributed_ml_scaffold_tpu_torch.precision import get_policy

    model = GPT(cfg.model, get_policy(cfg.precision), device="cuda")
    model.load_state_dict(sd)
    reqs = requests(seed, cfg.model.vocab_size)
    serve(model, cfg, reqs[:2], 4)  # warm-up: cuBLAS handles, kernel load
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    eng, comps, wall = serve(model, cfg, reqs, 64)
    counts = read_launches()
    steps, layers = eng.stats["decode_steps"], cfg.model.num_layers
    kernel = "decode_attention" + _suffix(cfg)
    check_launches(counts, {kernel: steps}, layers, "path")
    grows = {k: v for k, v in eng.stats.items() if k.startswith("grow_")}
    check(bool(grows), "the run crossed no bucket growth")
    slot_bytes = generation.cache_bytes_per_slot(eng.cache, eng.num_slots)
    est = generation.estimate_cache_bytes_per_slot(cfg.model, eng.bucket)
    check(slot_bytes == est,
          f"cache bytes per slot {slot_bytes} != estimate {est}")

    # One decode step's logits: kernel vs impl="dense", same weights.
    dense = GPT(dataclasses.replace(cfg.model, decode_attention="dense"),
                model.policy, device="cuda")
    dense.load_state_dict(sd)
    rng = np.random.default_rng(seed + 1)
    lens = torch.tensor([16, 100, 257, 512, 33, 480, 64, 300],
                        dtype=torch.int32, device="cuda")
    prompt = torch.from_numpy(
        rng.integers(0, cfg.model.vocab_size, (8, 512)).astype(np.int32)
    ).cuda()
    tok = torch.from_numpy(
        rng.integers(0, cfg.model.vocab_size, (8,)).astype(np.int32)
    ).cuda()
    out = {}
    for name, m in (("kernel", model), ("dense", dense)):
        _, cache = generation._prefill(m, prompt, lens, cache_len=1024)
        out[name] = generation._decode_step(m, cache, tok)[0].float()
    err = (out["kernel"] - out["dense"]).abs().max().item()
    scale = max(1.0, out["dense"].abs().max().item())
    tol = 8 * torch.finfo(torch.bfloat16).eps * scale
    check(err <= tol, f"decode-step logits kernel vs dense: {err} > {tol}")
    del dense
    profile = profile_phase(model, cfg, reqs)
    if _suffix(cfg):
        # bf16 q over a quantized contiguous cache: paged_tc.cuh's
        # contiguous mode (kPaged = false) is the only attention kernel.
        att = profile["attention_kernels_s"]
        ok = [re.search(r"paged_tc_kernel<\d+, true, false>", n) for n in att]
        check(bool(att) and all(ok),
              f"quant path: attention kernels {sorted(att)} in the "
              "profiled window")
    return {
        "card": card, "config": cfg.name, "policy": cfg.precision.policy,
        "kv_cache_quant": cfg.model.kv_cache_quant,
        "layers": layers, "d_model": cfg.model.hidden_dim,
        "slots": eng.num_slots, "requests": len(comps),
        "prompt_lens": [len(p) for p in reqs], "new_tokens_max": 64,
        "finish": {k: v for k, v in eng.stats.items() if k.startswith("finish_")},
        "decode_steps": steps, "kernel_launches": counts[kernel],
        "launches": counts,
        "bucket_growth": grows, "final_bucket": eng.bucket,
        **_latencies(comps, wall),
        "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
        "cache_bytes_per_slot": slot_bytes,
        "estimate_cache_bytes_per_slot": est,
        "decode_logits_kernel_vs_dense": {"max_abs_err": err, "tol": tol},
    }, counts, profile


PAGED_OVERRIDES = ["serving.kv_block_size=16", "serving.speculate=ngram",
                   "serving.speculate_k=4"]
INT8_OVERRIDES = ["model.kv_cache_quant=int8"]
FP8_OVERRIDES = ["model.kv_cache_quant=fp8_e4m3"]
# GPT-2-medium's fp8 pool block of 16 positions: 24 layers x (K + V
# payloads 2*16*16*64 bytes + bf16 scales 2*16*16*2 bytes).
FP8_BLOCK_BYTES = 811008


def paged_requests(seed: int, vocab: int):
    """8 prompts sharing one 256-token system prompt with unique 16-256
    token tails, 2 repeating one 32-token pattern, 6 random of 16-512
    tokens, in a shuffled order."""
    import numpy as np

    rng = np.random.default_rng(seed + 7)
    system = rng.integers(0, vocab, size=256)
    pattern = rng.integers(0, vocab, size=32)
    reqs = [np.concatenate([system, rng.integers(0, vocab, size=int(n))])
            for n in np.linspace(16, 256, 8).astype(int)]
    reqs += [np.tile(pattern, reps) for reps in (4, 8)]
    reqs += [rng.integers(0, vocab, size=int(n))
             for n in rng.integers(16, 513, size=6)]
    order = rng.permutation(len(reqs))
    return [reqs[i].astype(np.int32) for i in order]


def paged_path_phase(cfg, sd, seed: int, card: str) -> tuple:
    """The paged + ngram path of ``cfg`` (quantized pools or not): the
    paged decode and verify kernels of the pool's kind launch 24 times
    per step of their kind and no other kernel runs; prefix hits, block
    appends and drafts happen; every reservation unwinds; the live block
    bytes equal the estimate. Then a profiled window."""
    from frl_distributed_ml_scaffold_tpu_torch.config import apply_overrides
    from frl_distributed_ml_scaffold_tpu_torch.models import generation
    from frl_distributed_ml_scaffold_tpu_torch.models.gpt import GPT
    from frl_distributed_ml_scaffold_tpu_torch.precision import get_policy

    cfgp = apply_overrides(cfg, PAGED_OVERRIDES)
    model = GPT(cfgp.model, get_policy(cfgp.precision), device="cuda")
    model.load_state_dict(sd)
    reqs = paged_requests(seed, cfgp.model.vocab_size)
    serve(model, cfgp, reqs[:2], 4)  # warm-up
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    eng, comps, wall = serve(model, cfgp, reqs, 64)
    counts = read_launches()
    st, layers = eng.stats, cfgp.model.num_layers
    sfx = _suffix(cfgp)
    check_launches(counts, {"paged_decode_attention" + sfx: st["decode_paged"],
                            "paged_verify_attention" + sfx: st["decode_verify"]},
                   layers, "paged path")
    for key in ("prefix_hits", "block_append", "spec_proposed"):
        check(st[key] > 0, f"paged path: stats[{key!r}] is 0")
    check(eng._reserved_future == 0 and not any(eng._slot_blocks),
          "paged path: reservations or slot blocks left after the run")
    est = generation.estimate_pool_block_bytes(cfgp.model, PAGED_BS)
    check(eng.block_bytes() == est,
          f"pool block bytes {eng.block_bytes()} != estimate {est}")
    if sfx:
        check(est == FP8_BLOCK_BYTES,
              f"quantized pool block {est} bytes, not {FP8_BLOCK_BYTES}")
    report = {
        "card": card, "config": cfgp.name,
        "overrides": PAGED_OVERRIDES + (
            [f"model.kv_cache_quant={cfgp.model.kv_cache_quant}"] if sfx else []),
        "policy": cfgp.precision.policy, "layers": layers,
        "d_model": cfgp.model.hidden_dim, "slots": eng.num_slots,
        "requests": len(comps), "prompt_lens": [len(p) for p in reqs],
        "new_tokens_max": 64,
        "finish": {k: v for k, v in st.items() if k.startswith("finish_")},
        "stats": dict(st),
        "launches": counts,
        **_latencies(comps, wall),
        "spec_accept_rate": st["spec_accepted"] / st["spec_proposed"],
        "tokens_per_slot_step": st["step_tokens"] / st["slot_steps"],
        "pool_blocks": eng.pool_blocks,
        "pool_peak_blocks": st["pool_peak_blocks"],
        "block_bytes": eng.block_bytes(),
        "estimate_pool_block_bytes": est,
        "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
    }
    profile = profile_phase(model, cfgp, reqs)
    del model
    return report, counts, profile


def _short_kernel_name(name: str) -> str:
    """A CUDA kernel's name without its return type and parameter list,
    cut to 100 characters."""
    name = name.removeprefix("void ").replace("(anonymous namespace)", "anon")
    return name.split("(", 1)[0][:100]


def profile_phase(model, cfg, reqs, steps: int = 8) -> dict:
    """Where a decode step's time goes: ``steps`` steady decode steps of
    8 live slots under ``torch.profiler``; device busy time is the union
    of the CUDA events' intervals."""
    from torch.profiler import ProfilerActivity, profile

    from frl_distributed_ml_scaffold_tpu_torch.serving import build_engine

    eng = build_engine(model, serving=cfg.serving, num_slots=8,
                       temperature=0.0)
    for p in reqs[:8]:
        eng.submit(p, steps + 2)
    eng.step()  # admissions and the first decode, outside the window
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            eng.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return {"decode_steps": steps, "slots": 8, "step_s": wall / steps,
            **device_profile(prof, wall)}


def device_profile(prof, wall: float) -> dict:
    """Device busy time (the union of the CUDA events' intervals), idle
    share of ``wall``, the kernels that take the device time and the host
    operators by self CPU time, from a finished ``torch.profiler``."""
    from torch.autograd import DeviceType

    spans, by_name = [], {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        a, b = e.time_range.start, e.time_range.end
        spans.append((a, b))
        name = _short_kernel_name(e.name)
        by_name[name] = by_name.get(name, 0.0) + (b - a) / 1e6
    busy, end = 0.0, None
    for a, b in sorted(spans):
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    busy /= 1e6  # profiler times are microseconds
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    attention = {name: t for name, t in by_name.items()
                 if re.search(r"attention_kernel|paged_tc_kernel", name)}
    # The host side: operators and runtime calls by self CPU time.
    host = sorted(prof.key_averages(), key=lambda a: -a.self_cpu_time_total)
    return {
        "wall_s": wall,
        "device_busy_s": busy if spans else "not measured",
        "device_idle_share": 1 - busy / wall if spans else "not measured",
        "cuda_events": len(spans),
        "top_device_s": [[name, t] for name, t in top],
        "attention_kernels_s": attention,
        "top_host_self_s": [[a.key[:80], a.self_cpu_time_total / 1e6, a.count]
                            for a in host[:12]],
    }


def fp32_phase(cfg, sd, seed: int) -> dict:
    from frl_distributed_ml_scaffold_tpu_torch.config.schema import PrecisionConfig
    from frl_distributed_ml_scaffold_tpu_torch.models import generation
    from frl_distributed_ml_scaffold_tpu_torch.models.gpt import GPT
    from frl_distributed_ml_scaffold_tpu_torch.precision import get_policy

    cfg32 = cfg.replace(precision=PrecisionConfig(policy="fp32"))
    model = GPT(cfg32.model, get_policy("fp32"), device="cuda")
    model.load_state_dict(sd)
    reqs = requests(seed, cfg.model.vocab_size)
    _, comps, _ = serve(model, cfg32, reqs, 64)
    report = []
    # The first request admitted and the longest prompt (admitted into a
    # refilled slot after bucket growth).
    picks = [0, max(range(len(reqs)), key=lambda i: len(reqs[i]))]
    for i in picks:
        c = comps[i]
        n_new = len(c.tokens) - c.prompt_len
        ref = generation.generate(
            model, torch.from_numpy(reqs[i])[None].cuda(),
            max_new_tokens=n_new, temperature=0.0, device="cuda",
        )[0].cpu().numpy()
        diff = [j for j in range(len(ref)) if ref[j] != c.tokens[j]]
        entry = {"request": i, "prompt_len": c.prompt_len, "new": n_new,
                 "identical": not diff}
        if diff:
            j = diff[0]
            with torch.no_grad():
                ctx = torch.from_numpy(c.tokens[:j])[None].cuda()
                logits, _ = generation._prefill(
                    model, ctx, None,
                    cache_len=generation.next_cache_bucket(
                        cfg.model.seq_len, j),
                )
            top2 = torch.topk(logits[0].float(), 2).values
            gap = (top2[0] - top2[1]).item()
            entry.update(first_diff_step=j - c.prompt_len, top2_gap=gap,
                         gap_tol=FP32_GAP_TOL)
            check(gap <= FP32_GAP_TOL,
                  f"fp32 engine vs generate(): request {i} differs at step "
                  f"{j - c.prompt_len} with top-2 gap {gap}")
        report.append(entry)
    del model
    return {"policy": "fp32", "allow_tf32": False, "requests": report}


def _top2_gap(model, cfg, tokens) -> float:
    """fp32 top-2 logit gap of the greedy pick after ``tokens``."""
    from frl_distributed_ml_scaffold_tpu_torch.models import generation

    with torch.no_grad():
        ctx = torch.from_numpy(tokens)[None].cuda()
        logits, _ = generation._prefill(
            model, ctx, None,
            cache_len=generation.next_cache_bucket(cfg.model.seq_len,
                                                   len(tokens)),
        )
    top2 = torch.topk(logits[0].float(), 2).values
    return (top2[0] - top2[1]).item()


def fp32_paged_phase(cfg, sd, seed: int) -> dict:
    """The paged requests through the fp32 paged + ngram engine, held
    token for token against the fp32 contiguous engine."""
    from frl_distributed_ml_scaffold_tpu_torch.config import apply_overrides
    from frl_distributed_ml_scaffold_tpu_torch.config.schema import PrecisionConfig
    from frl_distributed_ml_scaffold_tpu_torch.models.gpt import GPT
    from frl_distributed_ml_scaffold_tpu_torch.precision import get_policy

    cfg32 = cfg.replace(precision=PrecisionConfig(policy="fp32"))
    cfg32p = apply_overrides(cfg32, PAGED_OVERRIDES)
    model = GPT(cfg32.model, get_policy("fp32"), device="cuda")
    model.load_state_dict(sd)
    reqs = paged_requests(seed, cfg.model.vocab_size)
    eng, paged, _ = serve(model, cfg32p, reqs, 64)
    _, contiguous, _ = serve(model, cfg32, reqs, 64)
    report = []
    for i, (a, b) in enumerate(zip(paged, contiguous)):
        n = min(len(a.tokens), len(b.tokens))
        diff = [j for j in range(n) if a.tokens[j] != b.tokens[j]]
        entry = {"request": i, "prompt_len": a.prompt_len,
                 "new": len(a.tokens) - a.prompt_len,
                 "identical": not diff and len(a.tokens) == len(b.tokens)}
        if diff:
            j = diff[0]
            gap = _top2_gap(model, cfg32, a.tokens[:j])
            entry.update(first_diff_step=j - a.prompt_len, top2_gap=gap,
                         gap_tol=FP32_GAP_TOL)
            check(gap <= FP32_GAP_TOL,
                  f"fp32 paged vs contiguous engine: request {i} differs at "
                  f"step {j - a.prompt_len} with top-2 gap {gap}")
        else:
            check(len(a.tokens) == len(b.tokens),
                  f"fp32 paged vs contiguous engine: request {i} lengths "
                  "differ with no differing token")
        report.append(entry)
    stats = {k: eng.stats[k] for k in ("decode_paged", "decode_verify",
                                       "prefix_hits", "spec_accepted",
                                       "spec_proposed")}
    del model
    return {"policy": "fp32", "allow_tf32": False, "engine_stats": stats,
            "identical": sum(e["identical"] for e in report),
            "requests": report}


# ------------------------------------------------------------ flash kernels

# (B, T, H, D) of each check: the training path's attention, gpt2_long's,
# a T that is not a multiple of the kernels' 64-row tile, a T below one
# tile, and the other two head dims the kernels take.
FLASH_SHAPES = {
    "path": (8, 1024, 16, 64),
    "gpt2_long": (1, 8192, 16, 64),
    "ragged_T": (2, 1000, 4, 64),
    "short_T": (1, 40, 2, 64),
    "head_dim_32": (2, 256, 4, 32),
    "head_dim_128": (2, 256, 4, 128),
}
# Flash kernels vs their plain versions, as a fraction of
# max(1, max|plain|). bf16: both round each output to bf16 (ulp 2^-8
# relative) and round P (dS for dQ) to bf16 before a product, the kernel
# at its running max, the plain version at the row's global max; dK/dV's
# fp32 P and dS enter the tensor cores as bf16 hi + lo (about 16 bits).
# fp32 (and lse under both): every product is a full-fp32 FMA in the
# kernel and a full-fp32 matmul in the plain version (TF32 off), so only
# summation order differs, over up to 8192 terms; the bf16 kernels' exp
# is the special-function unit's 2^x of a log2(e)-prescaled score, a few
# fp32 ulps from exp.
FLASH_TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}
FLASH_ENTRIES = ("flash_attention_fwd", "flash_attention_bwd_dq",
                 "flash_attention_bwd_dkv")


def flash_inputs(gen, shape, dtype, n: int = 4) -> list:
    """``n`` tensors made in the public (B, T, H, D) layout and returned
    as (B, H, T, D) views of it, so the kernels read through strides as
    the training path has them."""
    return [torch.randn(shape, generator=gen, device="cuda").to(dtype)
            .transpose(1, 2) for _ in range(n)]


def flash_held(what: str, got, want, tol: float) -> dict:
    torch.cuda.synchronize()
    scale = max(1.0, want.float().abs().max().item())
    err = (got.float() - want.float()).abs().max().item()
    check(math.isfinite(err) and err <= tol * scale,
          f"{what}: max abs err {err} > {tol} x {scale}")
    return {"max_abs_err": err, "scale": scale}


def flash_checks(gen) -> list:
    """Each flash entry against its plain version at every shape of
    ``FLASH_SHAPES``, bf16 and fp32, causal and not: O and lse from the
    forward; dQ, dK and dV from the plain forward's residuals."""
    from frl_distributed_ml_scaffold_tpu_torch.ops import flash_attention as fa

    checks = []
    for label, shape in FLASH_SHAPES.items():
        for dtype in (torch.bfloat16, torch.float32):
            for causal in (True, False):
                q, k, v, do = flash_inputs(gen, shape, dtype)
                o, lse = fa.flash_fwd(q, k, v, causal=causal)
                o_ref, lse_ref = fa.dense_fwd_lse(q, k, v, causal=causal)
                dq = fa.flash_bwd_dq(q, k, v, o_ref, lse_ref, do,
                                     causal=causal)
                dk, dv = fa.flash_bwd_dkv(q, k, v, o_ref, lse_ref, do,
                                          causal=causal)
                want = fa.dense_bwd_lse(q, k, v, o_ref, lse_ref, do,
                                        causal=causal)
                tag = f"flash {label} {dtype} causal={causal}"
                entry = {"label": label, "shape_BTHD": list(shape),
                         "dtype": str(dtype).replace("torch.", ""),
                         "causal": causal, "tol": FLASH_TOL[dtype],
                         "lse_tol": FLASH_TOL[torch.float32]}
                for name, got, ref in (("o", o, o_ref), ("dq", dq, want[0]),
                                       ("dk", dk, want[1]),
                                       ("dv", dv, want[2])):
                    entry[name] = flash_held(f"{tag} {name}", got, ref,
                                             FLASH_TOL[dtype])
                entry["lse"] = flash_held(f"{tag} lse", lse, lse_ref,
                                          FLASH_TOL[torch.float32])
                checks.append(entry)
                del q, k, v, do, o, lse, o_ref, lse_ref, dq, dk, dv, want
    return checks


def flash_autograd_checks(gen) -> list:
    """Gradients through the autograd Function (forward kernel, then dQ
    and dK/dV kernels) at the path shape, causal: fp32 against
    ``torch.autograd`` of the plain forward; bf16 against the plain
    backward (autograd of the plain forward rounds its intermediate
    gradients to bf16 at other places than the kernels' rules)."""
    from frl_distributed_ml_scaffold_tpu_torch.ops import flash_attention as fa

    out = []
    shape = FLASH_SHAPES["path"]
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v, w = (x.transpose(1, 2) for x in flash_inputs(gen, shape,
                                                               dtype))
        leaves = [x.detach().requires_grad_() for x in (q, k, v)]
        before = fa.flash_attention.fallbacks
        o = fa.flash_attention(*leaves, causal=True)
        grads = torch.autograd.grad(o, leaves, w)
        check(fa.flash_attention.fallbacks == before,
              "flash_attention fell back at the path shape")
        ref_leaves = [x.detach().requires_grad_() for x in (q, k, v)]
        bhtd = [x.transpose(1, 2) for x in ref_leaves]
        o_ref, lse_ref = fa.dense_fwd_lse(*bhtd, causal=True)
        if dtype == torch.float32:
            ref = torch.autograd.grad(o_ref.transpose(1, 2), ref_leaves, w)
            against = "torch.autograd of dense_fwd_lse"
        else:
            with torch.no_grad():
                ref = [g.transpose(1, 2) for g in fa.dense_bwd_lse(
                    *bhtd, o_ref, lse_ref, w.transpose(1, 2), causal=True)]
            against = "dense_bwd_lse"
        entry = {"shape_BTHD": list(shape), "causal": True,
                 "dtype": str(dtype).replace("torch.", ""),
                 "against": against, "tol": FLASH_TOL[dtype]}
        entry["o"] = flash_held("autograd o", o.detach(), o_ref.transpose(1, 2),
                                FLASH_TOL[dtype])
        for name, g, r in zip(("dq", "dk", "dv"), grads, ref):
            entry[name] = flash_held(f"autograd {name} {dtype}", g, r,
                                     FLASH_TOL[dtype])
        out.append(entry)
        del q, k, v, w, leaves, o, grads, ref_leaves, bhtd, o_ref, ref
    return out


def flash_bound(shape, dtype, causal: bool, entry: str) -> dict:
    """The least time of one launch. Bytes: each input read once and each
    output written once (fwd: Q, K, V in, O and lse out; dQ: Q, K, V, O,
    dO, lse in, dQ out; dK/dV: the same in, dK and dV out). Operations:
    2 D per (query, key) pair the mask admits for each product (fwd: QK^T
    and PV; dQ: QK^T, dO V^T and dS K; dK/dV: QK^T, dO V^T, P^T dO and
    dS^T Q), plus delta = rowsum(dO O) once per row in the backward."""
    b, t, h, d = shape
    elem = torch.finfo(dtype).bits // 8
    rows = b * h * t
    pairs = b * h * (t * (t + 1) // 2 if causal else t * t)
    tensor = rows * d * elem
    n_in, n_out, n_prod = {"flash_attention_fwd": (3, 1, 2),
                           "flash_attention_bwd_dq": (5, 1, 3),
                           "flash_attention_bwd_dkv": (5, 2, 4)}[entry]
    nbytes = (n_in + n_out) * tensor + 4 * rows
    flops = 2 * d * pairs * n_prod
    if entry != "flash_attention_fwd":
        flops += 2 * rows * d
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return {"bytes": nbytes, "flops": flops, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def time_flash(gen, shape, layers: int) -> dict:
    """The three entries, their plain versions and the library's
    ``scaled_dot_product_attention`` (forward; its backward for the two
    backward rows, one call computing dq, dk and dv) at ``shape``, bf16,
    causal, over ``layers`` input sets per timed call. The plain version
    of both backward rows is ``dense_bwd_lse``, which computes all three
    gradients."""
    from frl_distributed_ml_scaffold_tpu_torch.ops import flash_attention as fa

    dtype = torch.bfloat16
    sets = [flash_inputs(gen, shape, dtype) for _ in range(layers)]
    res = [fa.dense_fwd_lse(q, k, v, causal=True) for q, k, v, _ in sets]
    lib_leaves = [[x.detach().requires_grad_() for x in st[:3]]
                  for st in sets]
    lib_out = [torch.nn.functional.scaled_dot_product_attention(
        *lv, is_causal=True) for lv in lib_leaves]

    def plain_bwd(i):
        fa.dense_bwd_lse(*sets[i][:3], *res[i], sets[i][3], causal=True)

    def library_bwd(i):
        torch.autograd.grad(lib_out[i], lib_leaves[i], sets[i][3],
                            retain_graph=True)

    ops = {
        "flash_attention_fwd": (
            lambda i: fa.flash_fwd(*sets[i][:3], causal=True),
            lambda i: fa.dense_fwd_lse(*sets[i][:3], causal=True),
            lambda i: torch.nn.functional.scaled_dot_product_attention(
                *sets[i][:3], is_causal=True)),
        "flash_attention_bwd_dq": (
            lambda i: fa.flash_bwd_dq(*sets[i][:3], *res[i], sets[i][3],
                                      causal=True),
            plain_bwd, library_bwd),
        "flash_attention_bwd_dkv": (
            lambda i: fa.flash_bwd_dkv(*sets[i][:3], *res[i], sets[i][3],
                                       causal=True),
            plain_bwd, library_bwd),
    }
    out = {}
    for name, (kernel, plain, library) in ops.items():
        out[name] = {"shape_BTHD": list(shape), "dtype": "bfloat16",
                     "causal": True,
                     **timed(kernel, plain, library, layers=layers),
                     **flash_bound(shape, dtype, True, name)}
    for name in FLASH_ENTRIES[1:]:
        out[name]["plain_note"] = "dense_bwd_lse: dq, dk and dv together"
        out[name]["library_note"] = ("scaled_dot_product_attention "
                                     "backward: dq, dk and dv together")
    return out


def flash_kernel_phase(gen) -> dict:
    torch.cuda.empty_cache()
    checks = flash_checks(gen)
    autograd = flash_autograd_checks(gen)
    emit("flash_kernel_checks", {"kernels_vs_plain": checks,
                                 "autograd": autograd})
    timings = {"path": time_flash(gen, FLASH_SHAPES["path"], layers=2),
               "gpt2_long": time_flash(gen, FLASH_SHAPES["gpt2_long"],
                                       layers=1)}
    emit("flash_kernel_timings", timings)
    torch.cuda.empty_cache()
    worst = {name: max(e[key]["max_abs_err"] for e in checks
                       if e["dtype"] == "bfloat16" and e["label"] == "path"
                       for key in keys)
             for name, keys in zip(FLASH_ENTRIES,
                                   (("o",), ("dq",), ("dk", "dv")))}
    return {name: {"max_abs_err": worst[name],
                   "timing": timings["path"][name]} for name in FLASH_ENTRIES}


# -------------------------------------------------------------------- train

TRAIN_OVERRIDES = ["model.attention=flash"]
# Optimizer steps timed after one warm-up step (step 0, lr 0 under the
# recipe's 2000-step warmup).
TRAIN_STEPS = 3
H100_BF16_PEAK = PEAK_FLOPS[torch.bfloat16]


def _train_setup(cfg, sd, device="cuda"):
    """Model, optimizer, schedule, state and loss of ``cfg`` over the
    weights ``sd``."""
    from frl_distributed_ml_scaffold_tpu_torch.models.gpt import GPT
    from frl_distributed_ml_scaffold_tpu_torch.precision import get_policy
    from frl_distributed_ml_scaffold_tpu_torch.trainer.optimizers import (
        make_optimizer,
    )
    from frl_distributed_ml_scaffold_tpu_torch.trainer.tasks import make_lm_loss
    from frl_distributed_ml_scaffold_tpu_torch.trainer.train_state import (
        TrainState,
    )

    policy = get_policy(cfg.precision)
    model = GPT(cfg.model, policy, device=device)
    model.load_state_dict(sd)
    tx, schedule = make_optimizer(cfg.optimizer, cfg.trainer)
    state = TrainState.create(dict(model.named_parameters()), tx,
                              with_ema=cfg.trainer.ema_decay > 0,
                              device=device)
    return model, policy, tx, schedule, state, make_lm_loss(model)


def _step_fn(cfg, loss_fn, tx, policy):
    from frl_distributed_ml_scaffold_tpu_torch.trainer.train_step import (
        make_train_step,
    )

    t = cfg.trainer
    return make_train_step(
        loss_fn, tx, policy, seed=t.seed, grad_accum=t.grad_accum,
        remat=t.remat, ema_decay=t.ema_decay,
        offload_opt_state=t.offload_opt_state, mesh=cfg.mesh,
        parallel=cfg.parallel, device="cuda")


def train_flops(cfg, n_params: int) -> dict:
    """Model FLOPs of one optimizer step (no recomputation counted):
    6 per parameter per token, plus causal attention's QK^T and PV,
    forward (4 D per admitted pair) and backward (twice that)."""
    m = cfg.model
    tokens = cfg.data.global_batch_size * m.seq_len
    hd = m.hidden_dim // m.num_heads
    pairs = m.seq_len * (m.seq_len + 1) // 2
    attn = (3 * 4 * hd * pairs * m.num_heads * cfg.data.global_batch_size
            * m.num_layers)
    return {"tokens": tokens, "params": n_params,
            "dense_flops": 6 * n_params * tokens, "attention_flops": attn,
            "flops": 6 * n_params * tokens + attn}


def train_phase(sd, card: str) -> tuple:
    """``gpt2_medium_zero1`` with ``model.attention=flash`` at full width
    and depth: one warm-up step (step 0, lr 0: the params must not move)
    and ``TRAIN_STEPS`` timed steps of 64 x 1024 tokens in 8 microbatches
    under dots remat and bf16_mixed. The forward kernel launches twice per
    layer and microbatch (once in the forward, once when the checkpointed
    region reruns it in the backward), dQ and dK/dV once each; no serving
    kernel runs and nothing falls back. Then one profiled step."""
    from torch.profiler import ProfilerActivity, profile

    from frl_distributed_ml_scaffold_tpu_torch.config import (
        apply_overrides,
        get_config,
    )
    from frl_distributed_ml_scaffold_tpu_torch.data.synthetic import SyntheticLM
    from frl_distributed_ml_scaffold_tpu_torch.ops import flash_attention as fa

    cfg = apply_overrides(get_config("gpt2_medium_zero1"), TRAIN_OVERRIDES)
    model, policy, tx, schedule, state, loss_fn = _train_setup(cfg, sd)
    step = _step_fn(cfg, loss_fn, tx, policy)
    data = SyntheticLM(cfg.data, split="train")
    gb = cfg.data.global_batch_size
    batches = [data.batch(s, gb) for s in range(TRAIN_STEPS + 2)]
    layers, accum = cfg.model.num_layers, cfg.trainer.grad_accum
    per_step = {"flash_attention_fwd": 2 * layers * accum,
                "flash_attention_bwd_dq": layers * accum,
                "flash_attention_bwd_dkv": layers * accum}
    start = {k: p.clone() for k, p in state.params.items()}
    fallbacks = fa.flash_attention.fallbacks
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    steps = []
    for s in range(1 + TRAIN_STEPS):
        before = read_launches()
        t0 = time.perf_counter()
        state, m = step(state, batches[s])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        after = read_launches()
        launched = {k: after[k] - before[k] for k in after}
        for name, n in launched.items():
            check(n == per_step.get(name, 0),
                  f"train_path step {s}: {name} launched {n} times, want "
                  f"{per_step.get(name, 0)}")
        rec = {"step": s, "lr": schedule(s), "loss": float(m["loss"]),
               "grad_norm": float(m["grad_norm"]), "step_s": wall,
               "tokens_per_s": gb * cfg.model.seq_len / wall}
        check(math.isfinite(rec["loss"]) and math.isfinite(rec["grad_norm"]),
              f"train_path step {s}: non-finite loss or grad_norm {rec}")
        steps.append(rec)
        if s == 0:
            check(rec["lr"] == 0.0, "step 0 lr is not 0 under warmup")
            check(all(torch.equal(state.params[k], p)
                      for k, p in start.items()),
                  "params moved at step 0 (lr 0)")
        elif s == 1:
            moved = sum(not torch.equal(state.params[k], p)
                        for k, p in start.items())
            check(moved > 0, "params did not move at step 1")
            del start
    counts = read_launches()
    check(fa.flash_attention.fallbacks == fallbacks,
          "flash_attention fell back on the training path")
    peak_mem = torch.cuda.max_memory_allocated()
    n_params = sum(p.numel() for p in state.params.values())
    flops = train_flops(cfg, n_params)
    timed_s = [r["step_s"] for r in steps[1:]]
    step_s = statistics.median(timed_s)
    report = {
        "card": card, "config": cfg.name, "overrides": TRAIN_OVERRIDES,
        "policy": cfg.precision.policy, "layers": layers,
        "d_model": cfg.model.hidden_dim, "heads": cfg.model.num_heads,
        "seq_len": cfg.model.seq_len, "global_batch": gb,
        "grad_accum": accum, "remat": cfg.trainer.remat,
        "optimizer": {"name": cfg.optimizer.name,
                      "lr": cfg.optimizer.learning_rate,
                      "warmup_steps": cfg.optimizer.warmup_steps,
                      "schedule": cfg.optimizer.schedule,
                      "clip": cfg.optimizer.grad_clip_norm},
        "steps": steps, "step_s_median": step_s,
        "tokens_per_s": flops["tokens"] / step_s,
        **flops,
        "model_tflops_per_s": flops["flops"] / step_s / 1e12,
        "share_of_bf16_peak": flops["flops"] / step_s / H100_BF16_PEAK,
        "max_memory_allocated_bytes": peak_mem,
        "launches": counts,
        "launches_per_step": per_step,
        "fallbacks": fa.flash_attention.fallbacks - fallbacks,
        "params_unchanged_after_step0": True,
        "params_changed_after_step1": True,
    }
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, m = step(state, batches[-1])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    profile_report = {"steps": 1, "step_s": wall,
                      **device_profile(prof, wall)}
    del model, state, step, prof
    torch.cuda.empty_cache()
    return report, counts, profile_report


def fp32_train_phase(sd) -> dict:
    """One ``grad_accum=2`` step of ``gpt2_medium_zero1`` at full width,
    depth cut to 2 layers, from the same weights and batch (16 x 1024
    tokens), once with ``attention=flash`` (the kernels) and once with
    ``attention=dense`` (the plain path), under the fp32 policy and then
    bf16_mixed; warmup off so the step's lr is the schedule's 3e-4.
    Losses, every gradient and the params after the step are compared.
    Tolerances: loss 1e-5 (fp32) / 2e-3 (bf16_mixed) relative; each
    gradient to ``tol * max|g| + floor * (largest |g| of any tensor)``,
    tol 1e-4 / 5e-2, floor 1e-6 / 1e-3 (the floor covers the key bias,
    whose exact gradient is 0, so both runs hold rounding noise there); params: at most 2 lr apart (one Adam step moves a param by at
    most lr past the shared weight decay), the mean at most 1e-3 lr /
    1e-1 lr (under bf16_mixed the two paths' bf16 gradients differ in
    sign where they are small, and Adam's first step is about sign(g)),
    except the key bias, whose Adam step normalises rounding
    noise in both runs (its mean is held to lr)."""
    from frl_distributed_ml_scaffold_tpu_torch.config import (
        apply_overrides,
        get_config,
    )
    from frl_distributed_ml_scaffold_tpu_torch.data.synthetic import SyntheticLM
    from frl_distributed_ml_scaffold_tpu_torch.ops import flash_attention as fa
    from frl_distributed_ml_scaffold_tpu_torch.trainer.train_step import (
        make_grad_fn,
    )

    layers = 2
    base = apply_overrides(get_config("gpt2_medium_zero1"), [
        f"model.num_layers={layers}", "trainer.grad_accum=2",
        "optimizer.warmup_steps=0", "data.global_batch_size=16"])
    sd2 = {k: v for k, v in sd.items()
           if not k.startswith("blocks.") or int(k.split(".")[1]) < layers}
    batch = SyntheticLM(base.data, split="train").batch(0, 16)
    report = {"layers": layers, "cut": "depth 24 -> 2, full width",
              "global_batch": 16, "grad_accum": 2, "remat": "dots",
              "warmup_steps": 0, "allow_tf32": False}
    fallbacks = fa.flash_attention.fallbacks
    for pol in ("fp32", "bf16_mixed"):
        runs = {}
        for attention in ("flash", "dense"):
            cfg = apply_overrides(base, [f"model.attention={attention}",
                                         f"precision.policy={pol}"])
            model, policy, tx, schedule, state, loss_fn = _train_setup(cfg,
                                                                       sd2)
            grad_fn = make_grad_fn(loss_fn, policy, grad_accum=2,
                                   remat=cfg.trainer.remat, device="cuda")
            reset_launches()
            loss, _, _, grads = grad_fn(state.params, state.extras, batch)
            counts = read_launches()
            want_fwd = 2 * layers * 2 if attention == "flash" else 0
            check(counts["flash_attention_fwd"] == want_fwd,
                  f"fp32_train_check {pol} {attention}: forward kernel "
                  f"launched {counts['flash_attention_fwd']} times")
            state, m = _step_fn(cfg, loss_fn, tx, policy)(state, batch)
            runs[attention] = {"loss": float(loss), "grads": grads,
                               "params": state.params,
                               "grad_norm": float(m["grad_norm"]),
                               "lr": schedule(0)}
            del model, state
        check(fa.flash_attention.fallbacks == fallbacks,
              f"fp32_train_check {pol}: flash_attention fell back")
        k_run, d_run = runs["flash"], runs["dense"]
        lr = d_run["lr"]
        loss_rel = abs(k_run["loss"] - d_run["loss"]) / abs(d_run["loss"])
        loss_tol = 1e-5 if pol == "fp32" else 2e-3
        check(loss_rel <= loss_tol,
              f"fp32_train_check {pol}: loss {k_run['loss']} vs "
              f"{d_run['loss']}")
        floor = (1e-6 if pol == "fp32" else 1e-3) * max(
            g.abs().max().item() for g in d_run["grads"].values())
        worst_grad, worst_param, worst_mean = 0.0, 0.0, 0.0
        tol = 1e-4 if pol == "fp32" else 5e-2
        for name, g in d_run["grads"].items():
            err = (k_run["grads"][name] - g).abs().max().item()
            lim = tol * g.abs().max().item() + floor
            check(err <= lim, f"fp32_train_check {pol}: grad {name} "
                  f"differs by {err} > {lim}")
            worst_grad = max(worst_grad, err / max(lim, 1e-30))
            dp = (k_run["params"][name] - d_run["params"][name]).abs()
            mean_lim = (1e-3 if pol == "fp32" else 1e-1) * lr
            if name.endswith("attn.key.bias"):  # Adam-normalised noise
                mean_lim = lr
            check(dp.max().item() <= 2 * lr and dp.mean().item() <= mean_lim,
                  f"fp32_train_check {pol}: param {name} after the step "
                  f"differs by {dp.max().item()} (mean {dp.mean().item()})")
            worst_param = max(worst_param, dp.max().item())
            worst_mean = max(worst_mean, dp.mean().item())
        report[pol] = {
            "loss_flash": k_run["loss"], "loss_dense": d_run["loss"],
            "loss_rel_diff": loss_rel, "loss_tol": loss_tol,
            "grad_norm_flash": k_run["grad_norm"],
            "grad_norm_dense": d_run["grad_norm"],
            "grad_tol": tol, "grad_floor": floor,
            "worst_grad_err_over_limit": worst_grad,
            "lr": lr, "param_max_abs_diff": worst_param,
            "param_mean_abs_diff_worst_tensor": worst_mean,
            "tensors": len(d_run["grads"]),
        }
        del runs, k_run, d_run
        torch.cuda.empty_cache()
    return report


# ---------------------------------------------------------------- resnet

# (M, C) of the BatchNorm layers the rn50 path gives the backward kernels
# at batch 256: the stem, a stage-1 expansion and stage 4's widest; plus a
# ragged shape (M not a multiple of any row step, C not a multiple of the
# 16-byte vector, so the one-element path runs).
BN_SHAPES = {"stem": (3211264, 64), "stage1": (802816, 256),
             "stage4": (12544, 2048), "ragged": (12347, 100)}
BN_EPS = 1e-5
# BN kernels vs their plain versions, as a fraction of max(1, max|plain|).
# Both compute in fp32 from the same inputs; they differ in summation
# order (over up to 3.2M rows for the sums) and rsqrtf against
# torch.rsqrt. dx in bf16 may round the other way: one bf16 ulp is 2^-7
# relative at most.
BN_TOL = {"sums": 1e-5, torch.bfloat16: 2 ** -7, torch.float32: 1e-5}
# The AdamW kernel vs adamw_math, absolute on p', m' and v' (values of
# order 1): IEEE operations in the same order; the plain version divides
# by a host scalar as a multiply by its reciprocal (PyTorch's rule), 1 ulp
# apart.
ADAMW_TOL = 1e-6
# Leaves of the path (numel): the stage-4 3x3 conv, the Dense head, the
# smallest that takes the kernel, and a ragged one (n % 4 != 0).
ADAMW_SIZES = {"stage4_conv3x3": 2359296, "dense": 2048000,
               "min_kernel": 65536, "ragged": 65539}
# Leaves checked again with a bf16 g (precision.policy=bf16's gradients).
ADAMW_BF16_G = ("stage4_conv3x3", "ragged")
ADAMW_HYPER = dict(b1=0.9, b2=0.999, eps=1e-8, wd=1e-4)
RN50_OVERRIDES = ["model.fused_bn=true", "data.global_batch_size=256"]
RN50_ADAMW_OVERRIDES = RN50_OVERRIDES + ["optimizer.name=fused_adamw"]
# Timed steps after one warm-up step (step 0, lr 0 under the recipe's
# 1565-step warmup).
RN50_STEPS, RN50_ADAMW_STEPS = 3, 2
# Per step on the rn50 path: one sums and one dx launch per BatchNorm
# (53 in ResNet-50); the AdamW kernel once per leaf of >= 65536 elements
# (42 of the 161).
RN50_BNS, RN50_LEAVES, RN50_BIG_LEAVES = 53, 161, 42


def bn_inputs(gen, m: int, c: int, dtype):
    """x (per-channel offsets and spreads), dy, a random scale (gamma,
    some negative) in ``dtype`` and x's fp32 batch statistics, as the
    forward leaves them."""
    from frl_distributed_ml_scaffold_tpu_torch.ops import fused_bn as fb

    shift = torch.randn(c, generator=gen, device="cuda")
    spread = torch.rand(c, generator=gen, device="cuda") * 2 + 0.5
    x = (torch.randn((m, c), generator=gen, device="cuda") * spread
         + shift).to(dtype)
    dy = torch.randn((m, c), generator=gen, device="cuda").to(dtype)
    scale = (torch.rand(c, generator=gen, device="cuda") * 2 - 0.5).to(dtype)
    bias = torch.zeros(c, device="cuda", dtype=dtype)
    _, mean, var = fb.bn_train_forward(x, scale, bias, BN_EPS, dtype)
    return x, dy, scale, mean, var


def bn_held(what: str, got, want, tol: float) -> float:
    torch.cuda.synchronize()
    scale = max(1.0, want.float().abs().max().item())
    err = (got.float() - want.float()).abs().max().item()
    check(math.isfinite(err) and err <= tol * scale,
          f"{what}: max abs err {err} > {tol} x {scale}")
    return err


def bn_checks(gen) -> list:
    """Both BN kernels against their plain versions at ``BN_SHAPES``, bf16
    and fp32, random gamma; then both chained (dx from the kernel's own
    sums) against ``fallback_bwd``."""
    from frl_distributed_ml_scaffold_tpu_torch.ops import fused_bn as fb

    out = []
    for label, (m, c) in BN_SHAPES.items():
        for dtype in (torch.bfloat16, torch.float32):
            x, dy, scale, mean, var = bn_inputs(gen, m, c, dtype)
            dbeta, dgamma = fb.bn_sums(x, dy, mean, var, BN_EPS)
            ref_b, ref_g = fb.sums_plain(x, dy, mean, var, BN_EPS)
            dx = fb.bn_dx(x, dy, scale, mean, var, ref_g, ref_b, BN_EPS, m)
            ref_dx = fb.dx_plain(x, dy, scale, mean, var, ref_g, ref_b,
                                 BN_EPS, m)
            chained = fb.bn_dx(x, dy, scale, mean, var, dgamma, dbeta,
                               BN_EPS, m)
            want = fb.fallback_bwd(x, dy, scale, mean, var, BN_EPS)
            tag = f"bn {label} {dtype}"
            out.append({
                "label": label, "M": m, "C": c,
                "dtype": str(dtype).replace("torch.", ""),
                "sums_tol": BN_TOL["sums"], "dx_tol": BN_TOL[dtype],
                "dbeta_err": bn_held(f"{tag} dbeta", dbeta, ref_b,
                                     BN_TOL["sums"]),
                "dgamma_err": bn_held(f"{tag} dgamma", dgamma, ref_g,
                                      BN_TOL["sums"]),
                "dx_err": bn_held(f"{tag} dx", dx, ref_dx, BN_TOL[dtype]),
                "chained_dx_err": bn_held(f"{tag} chained dx", chained,
                                          want[0], BN_TOL[dtype]),
            })
            del x, dy, scale, mean, var, dbeta, dgamma, dx, ref_dx, chained
            del want
    return out


def bn_bound(m: int, c: int, dtype, entry: str) -> dict:
    """Bytes: x and dy read once (and dx written once, for dx), and the
    per-channel vectors. Operations: 4 (sums) or 6 (dx) flops an element
    on the fp32 CUDA cores."""
    elem = torch.finfo(dtype).bits // 8
    n = m * c
    n_tensors, per_elem = {"bn_bwd_sums": (2, 4), "bn_bwd_dx": (3, 6)}[entry]
    nbytes = n_tensors * n * elem + 6 * 4 * c
    flops = per_elem * n
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[torch.float32] * 1e3
    return {"bytes": nbytes, "flops": flops, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def time_bn(gen, m: int, c: int) -> dict:
    """Both kernels, their plain versions and the library's
    ``native_batch_norm_backward`` (both passes in one call) at (M, C),
    bf16 as the path runs them. Every input set is at least 100 MB, past
    the 50 MB L2, so one set per timed call finds it cold."""
    from frl_distributed_ml_scaffold_tpu_torch.ops import fused_bn as fb

    x, dy, scale, mean, var = bn_inputs(gen, m, c, torch.bfloat16)
    dbeta, dgamma = fb.sums_plain(x, dy, mean, var, BN_EPS)
    invstd = torch.rsqrt(var + BN_EPS)
    weight = scale.float()

    def library(_):
        torch.ops.aten.native_batch_norm_backward(
            dy, x, weight, None, None, mean, invstd, True, BN_EPS,
            [True, True, True])

    ops = {
        "bn_bwd_sums": (lambda _: fb.bn_sums(x, dy, mean, var, BN_EPS),
                        lambda _: fb.sums_plain(x, dy, mean, var, BN_EPS)),
        "bn_bwd_dx": (lambda _: fb.bn_dx(x, dy, scale, mean, var, dgamma,
                                         dbeta, BN_EPS, m),
                      lambda _: fb.dx_plain(x, dy, scale, mean, var, dgamma,
                                            dbeta, BN_EPS, m)),
    }
    out = {}
    for name, (kernel, plain) in ops.items():
        out[name] = {"M": m, "C": c, "dtype": "bfloat16",
                     **timed(kernel, plain, library, layers=1),
                     **bn_bound(m, c, torch.bfloat16, name),
                     "library_note": ("aten native_batch_norm_backward: dx, "
                                      "dgamma and dbeta together")}
    return out


def bn_kernel_phase(gen) -> dict:
    torch.cuda.empty_cache()
    checks = bn_checks(gen)
    emit("bn_kernel_checks", checks)
    timings = {label: time_bn(gen, *BN_SHAPES[label])
               for label in ("stem", "stage1", "stage4")}
    emit("bn_kernel_timings", timings)
    torch.cuda.empty_cache()
    path = [e for e in checks
            if e["dtype"] == "bfloat16" and e["label"] != "ragged"]
    # The row's time: the stem, the path's largest BatchNorm.
    return {
        "bn_bwd_sums": {"max_abs_err": max(max(e["dbeta_err"],
                                               e["dgamma_err"]) for e in path),
                        "timing": timings["stem"]["bn_bwd_sums"]},
        "bn_bwd_dx": {"max_abs_err": max(e["dx_err"] for e in path),
                      "timing": timings["stem"]["bn_bwd_dx"]},
    }


def adamw_leaf(gen, n: int):
    """g, m, v (> 0) and p of one leaf, fp32, at the scales of a step."""
    g = torch.randn(n, generator=gen, device="cuda") * 1e-2
    m = torch.randn(n, generator=gen, device="cuda") * 1e-2
    v = torch.rand(n, generator=gen, device="cuda") * 1e-4
    p = torch.randn(n, generator=gen, device="cuda") * 0.05
    return g, m, v, p


def adamw_scalars(count: int = 5, lr: float = 1e-3):
    """(lr, bc1, bc2) of the step taken at ``count``."""
    t = count + 1
    return lr, 1.0 - ADAMW_HYPER["b1"] ** t, 1.0 - ADAMW_HYPER["b2"] ** t


def adamw_checks(gen) -> list:
    """The AdamW kernel against ``adamw_math`` on the same leaf, at each
    of ``ADAMW_SIZES`` with an fp32 g and at ``ADAMW_BF16_G`` with a bf16
    g: p', m' and v'."""
    from frl_distributed_ml_scaffold_tpu_torch.ops import fused_adamw as fa

    out = []
    lr, bc1, bc2 = adamw_scalars()
    cases = [(label, n, torch.float32) for label, n in ADAMW_SIZES.items()]
    cases += [(label, ADAMW_SIZES[label], torch.bfloat16)
              for label in ADAMW_BF16_G]
    for label, n, g_dtype in cases:
        g, m, v, p = adamw_leaf(gen, n)
        g = g.to(g_dtype)
        want = fa.adamw_math(g, m, v, p, lr, bc1, bc2, **ADAMW_HYPER)
        fa.adamw_kernel(p, g, m, v, lr, bc1, bc2, **ADAMW_HYPER)
        torch.cuda.synchronize()
        errs = {name: (got - ref).abs().max().item()
                for name, got, ref in zip(("p", "m", "v"), (p, m, v), want)}
        g_name = str(g_dtype).replace("torch.", "")
        for name, err in errs.items():
            check(math.isfinite(err) and err <= ADAMW_TOL,
                  f"adamw {label} g {g_name} {name}: max abs err {err} > "
                  f"{ADAMW_TOL}")
        out.append({"label": label, "numel": n, "g_dtype": g_name,
                    "tol": ADAMW_TOL,
                    **{f"{k}_err": e for k, e in errs.items()}})
    return out


def time_adamw(gen, n: int, layers: int = 8) -> dict:
    """The kernel, ``adamw_math`` and the library's ``torch._fused_adamw_``
    on ``layers`` leaves of ``n`` elements per timed call (28 n bytes
    each: 8 leaves of the path's largest outrun the L2). Each call moves
    its leaf one step further."""
    from frl_distributed_ml_scaffold_tpu_torch.ops import fused_adamw as fa

    lr, bc1, bc2 = adamw_scalars()
    leaves = [adamw_leaf(gen, n) for _ in range(layers)]
    steps = [torch.tensor(6.0, device="cuda") for _ in range(layers)]
    hp = ADAMW_HYPER

    def kernel(i):
        g, m, v, p = leaves[i]
        fa.adamw_kernel(p, g, m, v, lr, bc1, bc2, **hp)

    def library(i):
        g, m, v, p = leaves[i]
        torch._fused_adamw_([p], [g], [m], [v], [], [steps[i]], lr=lr,
                            beta1=hp["b1"], beta2=hp["b2"],
                            weight_decay=hp["wd"], eps=hp["eps"],
                            amsgrad=False, maximize=False)

    t = timed(kernel, lambda i: fa.adamw_math(*leaves[i], lr, bc1, bc2, **hp),
              library, layers=layers)
    nbytes, flops = 28 * n, 16 * n
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[torch.float32] * 1e3
    return {"numel": n, **t, "bytes": nbytes, "flops": flops,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_note": "torch._fused_adamw_ on the same leaf"}


def adamw_kernel_phase(gen) -> dict:
    torch.cuda.empty_cache()
    checks = adamw_checks(gen)
    emit("adamw_kernel_checks", checks)
    timings = {label: time_adamw(gen, ADAMW_SIZES[label])
               for label in ("stage4_conv3x3", "dense")}
    emit("adamw_kernel_timings", timings)
    torch.cuda.empty_cache()
    path = [e for e in checks
            if e["label"] in timings and e["g_dtype"] == "float32"]
    return {"fused_adamw": {
        "max_abs_err": max(max(e["p_err"], e["m_err"], e["v_err"])
                           for e in path),
        "timing": timings["stage4_conv3x3"]}}


def rn50_setup(cfg, gen, weights=None):
    """Model, policy, optimizer, schedule, state and loss of a ResNet
    ``cfg`` on the card; weights ``(params, extras)`` from
    ``init_resnet_params`` on ``gen`` unless given."""
    from frl_distributed_ml_scaffold_tpu_torch.models import create_model
    from frl_distributed_ml_scaffold_tpu_torch.models.convert import (
        init_resnet_params,
    )
    from frl_distributed_ml_scaffold_tpu_torch.precision import get_policy
    from frl_distributed_ml_scaffold_tpu_torch.trainer.optimizers import (
        make_optimizer,
    )
    from frl_distributed_ml_scaffold_tpu_torch.trainer.tasks import make_loss_fn
    from frl_distributed_ml_scaffold_tpu_torch.trainer.train_state import (
        TrainState,
    )

    policy = get_policy(cfg.precision)
    model = create_model(cfg.model, policy, in_channels=cfg.data.channels,
                         device="cuda")
    if weights is None:
        weights = init_resnet_params(cfg.model, gen,
                                     in_channels=cfg.data.channels)
    params, extras = weights
    model.load_state_dict({**params, **extras["batch_stats"]})
    tx, schedule = make_optimizer(cfg.optimizer, cfg.trainer)
    state = TrainState.create(params, tx, extras, device="cuda")
    return (model, policy, tx, schedule, state,
            make_loss_fn(model, cfg.data.name))


def rn50_batches(cfg, n: int) -> list:
    """``n`` synthetic ImageNet batches of the global batch, on the card
    before any timed window."""
    from frl_distributed_ml_scaffold_tpu_torch.data.imagenet import ImageNet

    data = ImageNet(cfg.data, split="train")
    gb = cfg.data.global_batch_size
    return [{k: torch.from_numpy(v).to("cuda")
             for k, v in data.batch(s, gb).items()} for s in range(n)]


def rn50_flops(loss_fn, policy, state, batch) -> int:
    """FLOPs of one forward and backward (convolutions and the head),
    counted by ``FlopCounterMode`` over one gradient pass."""
    from torch.utils.flop_counter import FlopCounterMode

    from frl_distributed_ml_scaffold_tpu_torch.trainer.train_step import (
        make_grad_fn,
    )

    grad_fn = make_grad_fn(loss_fn, policy, device="cuda")
    with FlopCounterMode(display=False) as counter:
        grad_fn(state.params, state.extras, batch)
    return counter.get_total_flops()


def rn50_phase(gen, card: str, overrides: list, steps: int, batches: list,
               profiled: bool) -> tuple:
    """``imagenet_rn50_ddp`` with ``overrides`` at full width and depth:
    one warm-up step (step 0, lr 0: params unchanged, every running
    statistic moved) and ``steps`` timed steps of 256 images. Each step
    launches each BN kernel 53 times, the AdamW kernel 42 times under
    fused_adamw, and no other kernel of the port. Then, if ``profiled``,
    one step under ``torch.profiler``."""
    from torch.profiler import ProfilerActivity, profile

    from frl_distributed_ml_scaffold_tpu_torch.config import (
        apply_overrides,
        get_config,
    )

    cfg = apply_overrides(get_config("imagenet_rn50_ddp"), overrides)
    model, policy, tx, schedule, state, loss_fn = rn50_setup(cfg, gen)
    step = _step_fn(cfg, loss_fn, tx, policy)
    n_params = sum(p.numel() for p in state.params.values())
    big = sum(p.numel() >= 65536 for p in state.params.values())
    n_bn = len(model.batch_norms())
    check(len(state.params) == RN50_LEAVES and big == RN50_BIG_LEAVES
          and n_bn == RN50_BNS,
          f"rn50: {len(state.params)} leaves, {big} of >= 65536 elements, "
          f"{n_bn} BatchNorms")
    per_step = {"bn_bwd_sums": RN50_BNS, "bn_bwd_dx": RN50_BNS}
    if cfg.optimizer.name == "fused_adamw":
        per_step["fused_adamw"] = RN50_BIG_LEAVES
    flops = rn50_flops(loss_fn, policy, state, batches[0])
    start = {k: p.clone() for k, p in state.params.items()}
    stats0 = {k: s.clone() for k, s in state.extras["batch_stats"].items()}
    gb = cfg.data.global_batch_size
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    rows = []
    for s in range(1 + steps):
        before = read_launches()
        t0 = time.perf_counter()
        state, m = step(state, batches[s % len(batches)])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        after = read_launches()
        for name in after:
            n = after[name] - before[name]
            check(n == per_step.get(name, 0),
                  f"{cfg.name} step {s}: {name} launched {n} times, want "
                  f"{per_step.get(name, 0)}")
        rec = {"step": s, "lr": schedule(s), "step_s": wall,
               "images_per_s": gb / wall,
               **{k: float(v) for k, v in m.items()}}
        check(math.isfinite(rec["loss"]) and math.isfinite(rec["grad_norm"]),
              f"rn50 step {s}: non-finite loss or grad_norm {rec}")
        rows.append(rec)
        if s == 0:
            check(rec["lr"] == 0.0, "rn50 step 0 lr is not 0 under warmup")
            check(all(torch.equal(state.params[k], p)
                      for k, p in start.items()),
                  "rn50: params moved at step 0 (lr 0)")
            still = [k for k, v in stats0.items()
                     if torch.equal(state.extras["batch_stats"][k], v)]
            check(not still, f"rn50: batch_stats {still[:4]} did not move at "
                  "step 0")
        elif s == 1:
            check(any(not torch.equal(state.params[k], p)
                      for k, p in start.items()),
                  "rn50: params did not move at step 1")
            del start
    counts = read_launches()
    peak = torch.cuda.max_memory_allocated()
    check(peak < 80e9, f"rn50: {peak} bytes allocated at peak")
    step_s = statistics.median(r["step_s"] for r in rows[1:])
    report = {
        "card": card, "config": cfg.name, "overrides": overrides,
        "policy": cfg.precision.policy, "depth": cfg.model.depth,
        "image_size": cfg.data.image_size, "global_batch": gb,
        "optimizer": {"name": cfg.optimizer.name,
                      "lr": cfg.optimizer.learning_rate,
                      "warmup_steps": cfg.optimizer.warmup_steps,
                      "schedule": cfg.optimizer.schedule,
                      "momentum": cfg.optimizer.momentum,
                      "weight_decay": cfg.optimizer.weight_decay},
        "params": n_params, "leaves": len(state.params),
        "batch_norms": n_bn, "steps": rows, "step_s_median": step_s,
        "images_per_s": gb / step_s, "flops_per_step": flops,
        "flops_counted_by": "FlopCounterMode over one forward and backward",
        "model_tflops_per_s": flops / step_s / 1e12,
        "share_of_bf16_peak": flops / step_s / H100_BF16_PEAK,
        "max_memory_allocated_bytes": peak,
        "launches": counts, "launches_per_step": per_step,
        "params_unchanged_after_step0": True,
        "batch_stats_moved_at_step0": True,
        "params_changed_after_step1": True,
    }
    profile_report = None
    if profiled:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            state, m = step(state, batches[-1])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        profile_report = {"steps": 1, "step_s": wall,
                          **device_profile(prof, wall)}
        del prof
    del model, state, step
    torch.cuda.empty_cache()
    return report, counts, profile_report


class PlainFusedAdamW:
    """``FusedAdamW``'s update with every leaf through ``adamw_math``:
    the plain version of the optimizer, for ``fp32_rn50_check``."""

    def __init__(self, tx):
        self.tx, self.init = tx, tx.init

    def update(self, grads, state, params, norm=None):
        from frl_distributed_ml_scaffold_tpu_torch.ops.fused_adamw import (
            adamw_math,
        )

        tx = self.tx
        lr, bc1, bc2 = tx.scalars(state["count"])
        for k, p in params.items():
            mu, nu = state["mu"][k], state["nu"][k]
            new = adamw_math(grads[k], mu, nu, p, lr, bc1, bc2, b1=tx.b1,
                             b2=tx.b2, eps=tx.eps, wd=tx.weight_decay)
            for t, n in zip((p, mu, nu), new):
                t.copy_(n)
        state["count"] += 1
        return state


# fp32_rn50_check, kernels vs the plain path (autograd through the plain
# forward; adamw_math for fused_adamw). The loss is one forward of
# identical ops: 1e-6 / 1e-3 relative. A gradient is held to tol * max|g|
# of its tensor + floor * (largest |g| of any tensor): the two backward
# formulas round differently (the closed form against autograd through
# E[x^2] - E[x]^2) and the difference grows 53 BatchNorms deep; under
# bf16_mixed both round every dx to bf16, at other values. batch_stats
# come from identical forwards: 1e-6 relative. The optimizer kernel is
# held on the kernel run's own gradients against the plain optimizer on
# the same gradients: 1e-6 absolute (ADAMW_TOL). End to end, SGD's first
# step moves a param by lr (1 + momentum) times its gradient, so two
# params differ by at most 2 lr times the gradient limit; Adam's first
# step is about lr sign(g), and a small gradient's sign is rounding noise,
# so there only the 2 lr bound holds.
# Under bf16 the compute is bf16_mixed's and the gradients are rounded
# once more to bf16 (2^-8 relative) for the optimizer: bf16_mixed's limits.
RN50_CHECK_TOL = {
    "fp32": {"loss": 1e-6, "grad": 1e-3, "floor": 1e-5, "stats": 1e-6},
    "bf16_mixed": {"loss": 1e-3, "grad": 1e-1, "floor": 1e-2, "stats": 1e-6},
    "bf16": {"loss": 1e-3, "grad": 1e-1, "floor": 1e-2, "stats": 1e-6},
}
# (policy, optimizer) pairs of fp32_rn50_check; bf16 sends bf16 gradients
# into the AdamW kernel.
RN50_CHECK_RUNS = [("fp32", "sgd"), ("fp32", "fused_adamw"),
                   ("bf16_mixed", "sgd"), ("bf16_mixed", "fused_adamw"),
                   ("bf16", "fused_adamw")]
RN50_CHECK = ["data.image_size=64", "data.global_batch_size=8",
              "optimizer.warmup_steps=0"]


def _rel_check(tag: str, got: dict, want: dict, tol: float,
               floor: float = 0.0) -> float:
    """Each tensor of ``got`` within ``tol * max|want| + floor`` of
    ``want``'s; returns the worst error over its limit."""
    worst = 0.0
    for name, w in want.items():
        err = (got[name] - w).abs().max().item()
        lim = tol * w.abs().max().item() + floor
        check(err <= lim, f"{tag} {name} differs by {err} > {lim}")
        worst = max(worst, err / max(lim, 1e-30))
    return worst


def fp32_rn50_phase(gen) -> dict:
    """One step of ResNet-50 (full width and depth, 64 px, batch 8,
    warmup off) from the same weights and batch through the kernels
    (``model.fused_bn=true``; the AdamW kernel) and through the plain
    path (``fused_bn=false``; ``adamw_math``), for each of
    ``RN50_CHECK_RUNS``: loss, every gradient, batch_stats, and the params
    after the update (``RN50_CHECK_TOL``)."""
    from frl_distributed_ml_scaffold_tpu_torch.config import (
        apply_overrides,
        get_config,
    )
    from frl_distributed_ml_scaffold_tpu_torch.models.convert import (
        init_resnet_params,
    )
    from frl_distributed_ml_scaffold_tpu_torch.trainer.train_step import (
        make_grad_fn,
    )

    base = apply_overrides(get_config("imagenet_rn50_ddp"), RN50_CHECK)
    weights = init_resnet_params(base.model, gen)
    batch = rn50_batches(base, 1)[0]
    report = {"cut": "224 -> 64 px, batch 8, full width and depth",
              "allow_tf32": False, "tol": RN50_CHECK_TOL,
              "optimizer_tol": ADAMW_TOL}
    for pol, opt in RN50_CHECK_RUNS:
        tol = RN50_CHECK_TOL[pol]
        runs = {}
        for fused in (True, False):
            cfg = apply_overrides(base, [
                f"precision.policy={pol}", f"optimizer.name={opt}",
                f"model.fused_bn={str(fused).lower()}"])
            model, policy, tx, schedule, state, loss_fn = rn50_setup(
                cfg, gen, weights)
            if opt == "fused_adamw" and not fused:
                tx = PlainFusedAdamW(tx)
            grad_fn = make_grad_fn(loss_fn, policy, device="cuda")
            reset_launches()
            loss, _, extras, grads = grad_fn(state.params, state.extras,
                                             batch)
            before = {k: p.clone() for k, p in state.params.items()}
            tx.update(grads, state.opt_state, state.params)
            counts = read_launches()
            want = {"bn_bwd_sums": RN50_BNS if fused else 0,
                    "bn_bwd_dx": RN50_BNS if fused else 0,
                    "fused_adamw": (RN50_BIG_LEAVES if fused
                                    and opt == "fused_adamw" else 0)}
            check(all(counts[k] == n for k, n in want.items()),
                  f"fp32_rn50_check {pol} {opt} fused={fused}: launches "
                  f"{counts}, want {want}")
            runs[fused] = {"loss": float(loss), "grads": grads,
                           "stats": extras["batch_stats"],
                           "params": state.params, "lr": schedule(0)}
            if fused and opt == "fused_adamw":
                # The plain optimizer on the kernel run's gradients.
                PlainFusedAdamW(tx).update(grads, tx.init(before),
                                           before)
                runs["optimizer_ref"] = before
            del model, state, before
        k_run, p_run = runs[True], runs[False]
        lr = p_run["lr"]
        loss_rel = abs(k_run["loss"] - p_run["loss"]) / abs(p_run["loss"])
        tag = f"fp32_rn50_check {pol} {opt}"
        check(loss_rel <= tol["loss"],
              f"{tag}: loss {k_run['loss']} vs {p_run['loss']}")
        floor = tol["floor"] * max(g.abs().max().item()
                                   for g in p_run["grads"].values())
        entry = {
            "loss_kernels": k_run["loss"], "loss_plain": p_run["loss"],
            "loss_rel_diff": loss_rel, "lr": lr,
            "worst_grad_err_over_limit": _rel_check(
                f"{tag}: grad", k_run["grads"], p_run["grads"],
                tol["grad"], floor),
            "worst_batch_stats_err_over_limit": _rel_check(
                f"{tag}: batch_stats", k_run["stats"], p_run["stats"],
                tol["stats"], tol["stats"]),
            "tensors": len(p_run["grads"]),
            "grad_dtypes": sorted({str(g.dtype).replace("torch.", "")
                                   for g in k_run["grads"].values()}),
        }
        if pol == "bf16":
            check(entry["grad_dtypes"] == ["bfloat16"],
                  f"{tag}: the optimizer got {entry['grad_dtypes']} "
                  "gradients, not bfloat16")
        worst = 0.0
        for name, p in p_run["params"].items():
            dp = (k_run["params"][name] - p).abs().max().item()
            g = p_run["grads"][name]
            lim = 2 * lr * (
                (tol["grad"] * g.abs().max().item() + floor)
                if opt == "sgd" else 1.0) + 1e-6
            check(dp <= lim, f"{tag}: param {name} after the update "
                  f"differs by {dp} > {lim}")
            worst = max(worst, dp)
        entry["param_max_abs_diff"] = worst
        if opt == "fused_adamw":
            ref = runs["optimizer_ref"]
            err = max((k_run["params"][k] - r).abs().max().item()
                      for k, r in ref.items())
            check(err <= ADAMW_TOL, f"{tag}: the AdamW kernel's params "
                  f"differ from adamw_math's by {err} on the same grads")
            entry["optimizer_vs_plain_same_grads"] = err
        report[f"{pol}_{opt}"] = entry
        del runs, k_run, p_run
        torch.cuda.empty_cache()
    return report


# --------------------------------------------------------------------- main


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from frl_distributed_ml_scaffold_tpu_torch.config import (
        apply_overrides,
        get_config,
    )
    from frl_distributed_ml_scaffold_tpu_torch.models.convert import init_params
    from frl_distributed_ml_scaffold_tpu_torch.ops import _build

    start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = nvidia_smi()
    print(card, flush=True)
    emit("env", {"nvidia_smi": card, "device": torch.cuda.get_device_name(0),
                 "count": torch.cuda.device_count(),
                 "torch": torch.__version__, "cuda": torch.version.cuda,
                 "python": sys.version.split()[0]})

    t0 = time.perf_counter()
    reports = _build.build_all()
    build_s = time.perf_counter() - t0
    os.makedirs(OUT_DIR, exist_ok=True)
    for name, rep in reports.items():
        with open(os.path.join(OUT_DIR, f"ptxas_{name}.txt"), "w") as f:
            f.write(rep)
    emit("build", {"seconds": build_s, "sources": _build.sources(),
                   "built_now": sorted(reports),
                   "ptxas": ptxas_summary(reports)})

    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    seconds = {"build": build_s}

    def timed_phase(name, fn, *fn_args):
        t = time.perf_counter()
        out = fn(*fn_args)
        seconds[name] = time.perf_counter() - t
        return out

    kern = {"decode_attention": timed_phase("kernel", kernel_phase, gen),
            **timed_phase("paged_kernel", paged_kernel_phase, gen)}
    cfg = get_config("gpt2_medium_serve")
    cfg_int8 = apply_overrides(cfg, INT8_OVERRIDES)
    cfg_fp8 = apply_overrides(cfg, FP8_OVERRIDES)
    # The weights come from the generator as the two phases above leave
    # it, so the paths serve the same model whatever phases follow.
    sd = init_params(cfg.model, gen)
    kern.update(timed_phase("quant_kernel", quant_kernel_phase, gen))
    # Each path runs with every launch count set to 0 just before it;
    # a kernel's count is that of the path that runs it.
    launches = {}
    for key, phase, c in (("path", path_phase, cfg),
                          ("paged_path", paged_path_phase, cfg),
                          ("quant_path", path_phase, cfg_int8),
                          ("quant_paged_path", paged_path_phase, cfg_fp8)):
        report, counts, profile = timed_phase(key, phase, c, sd, args.seed,
                                              card)
        launches.update({k: n for k, n in counts.items() if n})
        emit(key, report)
        emit(key.replace("path", "profile"), profile)
    emit("fp32_check", timed_phase("fp32_check", fp32_phase, cfg, sd,
                                   args.seed))
    emit("fp32_paged_check", timed_phase("fp32_paged_check", fp32_paged_phase,
                                         cfg, sd, args.seed))
    emit("fp32_quant_check", {
        "int8_contiguous_vs_generate": timed_phase(
            "fp32_quant_check_int8", fp32_phase, cfg_int8, sd, args.seed),
        "fp8_e4m3_paged_vs_contiguous": timed_phase(
            "fp32_quant_check_fp8", fp32_paged_phase, cfg_fp8, sd, args.seed),
    })
    kern.update(timed_phase("flash_kernel", flash_kernel_phase, gen))
    report, counts, profile = timed_phase("train_path", train_phase, sd, card)
    launches.update({k: n for k, n in counts.items() if n})
    emit("train_path", report)
    emit("train_profile", profile)
    emit("fp32_train_check", timed_phase("fp32_train_check",
                                         fp32_train_phase, sd))
    # The GPT weights are done with: the ResNet phases' peak memory is
    # their own.
    del sd
    torch.cuda.empty_cache()
    kern.update(timed_phase("bn_kernel", bn_kernel_phase, gen))
    kern.update(timed_phase("adamw_kernel", adamw_kernel_phase, gen))
    rn50_cfg = apply_overrides(get_config("imagenet_rn50_ddp"),
                               RN50_OVERRIDES)
    batches = timed_phase("rn50_data", rn50_batches, rn50_cfg,
                          RN50_STEPS + 2)
    report, counts, profile = timed_phase(
        "rn50_path", rn50_phase, gen, card, RN50_OVERRIDES, RN50_STEPS,
        batches, True)
    launches.update({k: counts[k] for k in ("bn_bwd_sums", "bn_bwd_dx")})
    emit("rn50_path", report)
    emit("rn50_profile", profile)
    report, counts, _ = timed_phase(
        "rn50_adamw_path", rn50_phase, gen, card, RN50_ADAMW_OVERRIDES,
        RN50_ADAMW_STEPS, batches, False)
    launches["fused_adamw"] = counts["fused_adamw"]
    emit("rn50_adamw_path", report)
    del batches
    emit("fp32_rn50_check", timed_phase("fp32_rn50_check", fp32_rn50_phase,
                                        gen))
    # Where the script's time limit goes: each phase (a path's includes
    # its warm-up and profiled window) and the whole of main().
    seconds["main_total"] = time.perf_counter() - start
    emit("phase_seconds", seconds)

    src = "frl_distributed_ml_scaffold_tpu_torch/ops/csrc/"
    ref = "frl_distributed_ml_scaffold_tpu/ops/"
    rows = [("decode_attention", "decode_attention.cu",
             "decode_attention.py:346"),
            ("paged_decode_attention", "paged_attention.cu",
             "decode_attention.py:444"),
            ("paged_verify_attention", "paged_attention.cu",
             "decode_attention.py:545"),
            ("decode_attention_quant", "quant_attention.cu",
             "decode_attention.py:394"),
            ("paged_decode_attention_quant", "quant_attention.cu",
             "decode_attention.py:496"),
            ("paged_verify_attention_quant", "quant_attention.cu",
             "decode_attention.py:599"),
            ("flash_attention_fwd", "flash_attention.cu",
             "flash_attention.py:100"),
            ("flash_attention_bwd_dq", "flash_attention.cu",
             "flash_attention.py:188"),
            ("flash_attention_bwd_dkv", "flash_attention.cu",
             "flash_attention.py:222"),
            ("bn_bwd_sums", "fused_bn.cu", "fused_bn.py:115"),
            ("bn_bwd_dx", "fused_bn.cu", "fused_bn.py:140"),
            ("fused_adamw", "fused_adamw.cu", "fused_adamw.py:56")]
    emit("kernels", [{
        "name": name,
        "route": "cuda",
        "source": src + cu,
        "replaces": ref + line,
        "launches": launches.get(name, 0),
        "max_abs_err": kern[name]["max_abs_err"],
        "ms": kern[name]["timing"]["ms"],
        "plain_ms": kern[name]["timing"]["plain_ms"],
        "bound_ms": kern[name]["timing"]["bound_ms"],
        "bound_by": kern[name]["timing"]["bound_by"],
        "library_ms": kern[name]["timing"]["library_ms"],
    } for name, cu, line in rows])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
