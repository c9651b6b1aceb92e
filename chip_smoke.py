#!/usr/bin/env python
"""Drive the PyTorch port's serving path once on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Phases, each a line of JSON on stdout; any failure raises (non-zero exit,
no final line):

1. env: the card (``nvidia-smi`` name and power limit), torch and CUDA.
2. build: every kernel under ``frl_distributed_ml_scaffold_tpu_torch/ops/
   csrc`` compiled by nvcc, all in parallel, and the seconds it took.
3. kernel checks: each kernel held against its plain PyTorch version on
   the card at the serving path's shapes (8 slots, 16 heads, head_dim 64,
   S in {128, 1024}, occupancies 1, S, random and > S), bf16 and fp32,
   plus a dirty-cache check; then timed against the plain version and one
   library call, beside its bound.
4. path: GPT-2-medium at full width (``gpt2_medium_serve``, seeded random
   weights, bf16_mixed) serving 16 requests through ``build_engine`` with
   8 slots; the decode kernel must launch 24 times per decode step. One
   decode step's logits through the kernel against ``impl="dense"``. Then
   a few steady decode steps under ``torch.profiler``: device busy time,
   idle share and the kernels that take the device time.
5. fp32 check: the same requests under the fp32 policy, two of them
   re-run alone through ``generate()``, token for token.
6. the ``kernels`` line and, last, ``{"ok": true, "device": ...}``.

Nothing here imports JAX. The CUDA check comes first: without a card the
script exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import json
import math
import os
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


def decode_inputs(gen, dtype, s, *, b=8, h=16, d=64, layers=1):
    """q [L, B, H, D], caches [L, B, S, H, D] (strided views into a
    2S-capacity buffer, as a grown engine cache would be), kv_len [B]:
    occupancies 1, S, > S and random ones in between."""
    dev = "cuda"
    q = torch.randn((layers, b, h, d), generator=gen, device=dev).to(dtype)
    kbuf = torch.randn((layers, b, 2 * s, h, d), generator=gen, device=dev)
    vbuf = torch.randn((layers, b, 2 * s, h, d), generator=gen, device=dev)
    k, v = kbuf.to(dtype)[:, :, :s], vbuf.to(dtype)[:, :, :s]
    mid = torch.randint(2, s, (b - 3,), generator=gen, device=dev)
    kv_len = torch.cat([
        torch.tensor([1, s, s + 37], device=dev), mid,
    ]).to(torch.int32)
    return q, k, v, kv_len


def kernel_phase(gen) -> dict:
    from frl_distributed_ml_scaffold_tpu_torch.ops import decode_attention as da

    checks, worst = [], 0.0
    for dtype in (torch.bfloat16, torch.float32):
        for s in (128, 1024):
            q, k, v, kv_len = decode_inputs(gen, dtype, s)
            q, k, v = q[0], k[0], v[0]
            got = da.decode_attention(q, k, v, kv_len)
            want = da.dense_decode_attention(q, k, v, kv_len.clamp_min(1))
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            check(math.isfinite(err) and err <= TOL[dtype],
                  f"decode kernel {dtype} S={s}: max abs err {err} > {TOL[dtype]}")
            # Dirty cache: NaN past each row's occupancy must not reach
            # the output (the kernel must never read those positions).
            kd, vd = k.clone(), v.clone()
            for row, n in enumerate(kv_len.tolist()):
                kd[row, min(n, s):] = float("nan")
                vd[row, min(n, s):] = float("nan")
            dirty = da.decode_attention(q, kd, vd, kv_len)
            torch.cuda.synchronize()
            check(torch.equal(dirty, got),
                  f"decode kernel {dtype} S={s}: output changed with garbage "
                  "past kv_len")
            checks.append({"dtype": str(dtype).replace("torch.", ""), "S": s,
                           "kv_len": kv_len.tolist(), "max_abs_err": err,
                           "tol": TOL[dtype], "dirty_cache_equal": True})
            if dtype == torch.bfloat16:
                worst = max(worst, err)
    emit("kernel_checks", checks)
    timings = [time_decode(gen, s) for s in (128, 1024)]
    emit("kernel_timings", timings)
    return {"max_abs_err": worst, "timing": timings[-1]}


def time_decode(gen, s: int) -> dict:
    """Kernel, plain version and one library call on the path's shapes,
    sweeping 24 layers' caches per timed call as a decode step does (so
    each launch finds its cache outside L2, like the real step)."""
    from frl_distributed_ml_scaffold_tpu_torch.ops import decode_attention as da

    layers, dtype = 24, torch.bfloat16
    q, k, v, kv_len = decode_inputs(gen, dtype, s, layers=layers)
    _, b, h, d = q.shape
    lens = kv_len.clamp_min(1)
    pos = torch.arange(s, device="cuda")
    mask = (pos[None, :] < lens[:, None])[:, None, None, :]  # [B,1,1,S]

    def run(op):
        def fn():
            for i in range(layers):
                op(q[i], k[i], v[i])
        return fn

    def kernel(qi, ki, vi):
        da.decode_attention(qi, ki, vi, kv_len)

    def plain(qi, ki, vi):
        da.dense_decode_attention(qi, ki, vi, lens)

    def library(qi, ki, vi):
        torch.nn.functional.scaled_dot_product_attention(
            qi[:, :, None], ki.transpose(1, 2), vi.transpose(1, 2),
            attn_mask=mask,
        )

    ms = {}
    for name, op in (("plain", plain), ("kernel", kernel), ("kernel2", kernel),
                     ("plain2", plain), ("library", library)):
        ms[name] = cuda_time_ms(run(op), per_call=layers)
    # What the decode step sees: launches enqueued one by one from Python.
    enqueue_ms = cuda_time_ms(run(kernel), per_call=layers, queued=False)
    n = lens.clamp(max=s).long()
    elem = torch.finfo(dtype).bits // 8
    nbytes = (2 * int(n.sum()) * h * d + 2 * b * h * d) * elem + 4 * b
    flops = 4 * int(n.sum()) * h * d
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return {
        "S": s, "kv_len": kv_len.tolist(),
        "ms": statistics.median([ms["kernel"], ms["kernel2"]]),
        "plain_ms": statistics.median([ms["plain"], ms["plain2"]]),
        "library_ms": ms["library"],
        "unqueued_ms": enqueue_ms,
        "order_plain_kernel_kernel_plain": [
            ms["plain"], ms["kernel"], ms["kernel2"], ms["plain2"]],
        "bytes": nbytes, "flops": flops,
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
    }


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


def path_phase(cfg, sd, seed: int, card: str) -> dict:
    import numpy as np

    from frl_distributed_ml_scaffold_tpu_torch.models import generation
    from frl_distributed_ml_scaffold_tpu_torch.models.gpt import GPT
    from frl_distributed_ml_scaffold_tpu_torch.ops import decode_attention as da
    from frl_distributed_ml_scaffold_tpu_torch.precision import get_policy

    model = GPT(cfg.model, get_policy(cfg.precision), device="cuda")
    model.load_state_dict(sd)
    reqs = requests(seed, cfg.model.vocab_size)
    serve(model, cfg, reqs[:2], 4)  # warm-up: cuBLAS handles, kernel load
    torch.cuda.reset_peak_memory_stats()
    da.decode_attention.launches = 0
    eng, comps, wall = serve(model, cfg, reqs, 64)
    launches = da.decode_attention.launches
    steps = eng.stats["decode_steps"]
    check(launches == steps * cfg.model.num_layers,
          f"decode kernel launched {launches} times in {steps} decode steps "
          f"of {cfg.model.num_layers} layers")
    grows = {k: v for k, v in eng.stats.items() if k.startswith("grow_")}
    check(bool(grows), "the run crossed no bucket growth")
    n_tok = sum(len(c.tokens) - c.prompt_len for c in comps)
    tpot = [x for c in comps for x in c.token_latencies_s[1:]]
    ttft = [c.ttft_s for c in comps]

    # One decode step's logits: kernel vs impl="dense", same weights.
    import dataclasses

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
    return {
        "card": card, "config": cfg.name, "policy": cfg.precision.policy,
        "layers": cfg.model.num_layers, "d_model": cfg.model.hidden_dim,
        "slots": eng.num_slots, "requests": len(comps),
        "prompt_lens": [len(p) for p in reqs], "new_tokens_max": 64,
        "finish": {k: v for k, v in eng.stats.items() if k.startswith("finish_")},
        "decode_steps": steps, "kernel_launches": launches,
        "bucket_growth": grows, "final_bucket": eng.bucket,
        "generated_tokens": n_tok, "wall_s": wall,
        "tokens_per_s": n_tok / wall,
        "ttft_mean_s": statistics.mean(ttft),
        "ttft_p50_s": statistics.median(ttft),
        "tpot_mean_s": statistics.mean(tpot),
        "tpot_p50_s": statistics.median(tpot),
        "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
        "decode_logits_kernel_vs_dense": {"max_abs_err": err, "tol": tol},
    }, launches, profile


def _short_kernel_name(name: str) -> str:
    """A CUDA kernel's name without its return type and parameter list,
    cut to 100 characters."""
    name = name.removeprefix("void ").replace("(anonymous namespace)", "anon")
    return name.split("(", 1)[0][:100]


def profile_phase(model, cfg, reqs, steps: int = 8) -> dict:
    """Where a decode step's time goes: ``steps`` steady decode steps of
    8 live slots under ``torch.profiler``; device busy time is the union
    of the CUDA events' intervals."""
    from torch.autograd import DeviceType
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
    return {
        "decode_steps": steps, "slots": 8, "wall_s": wall,
        "step_s": wall / steps,
        "device_busy_s": busy if spans else "not measured",
        "device_idle_share": 1 - busy / wall if spans else "not measured",
        "cuda_events": len(spans),
        "top_device_s": [[name, t] for name, t in top],
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


# --------------------------------------------------------------------- main


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from frl_distributed_ml_scaffold_tpu_torch.config import get_config
    from frl_distributed_ml_scaffold_tpu_torch.models.convert import init_params
    from frl_distributed_ml_scaffold_tpu_torch.ops import _build

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
                   "built_now": sorted(reports)})

    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    kern = kernel_phase(gen)

    cfg = get_config("gpt2_medium_serve")
    sd = init_params(cfg.model, gen)
    path, launches, profile = path_phase(cfg, sd, args.seed, card)
    emit("path", path)
    emit("profile", profile)
    emit("fp32_check", fp32_phase(cfg, sd, args.seed))

    t = kern["timing"]
    emit("kernels", [{
        "name": "decode_attention",
        "route": "cuda",
        "source": "frl_distributed_ml_scaffold_tpu_torch/ops/csrc/decode_attention.cu",
        "replaces": "frl_distributed_ml_scaffold_tpu/ops/decode_attention.py:346",
        "launches": launches,
        "max_abs_err": kern["max_abs_err"],
        "ms": t["ms"],
        "plain_ms": t["plain_ms"],
        "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"],
        "library_ms": t["library_ms"],
    }])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
