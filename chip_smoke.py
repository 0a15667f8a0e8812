#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (mxnet_tpu_torch) on one NVIDIA GPU and
check it end to end. Run from the root of a checkout:

    python3 chip_smoke.py

Phases, each printing one line of its own (any failure exits non-zero):

1. environment: torch/CUDA versions and the card's name and power limit
   (``nvidia-smi``); TF32 off for matmuls and cuDNN, so fp32 stays fp32;
2. build: every kernel of the served path, compiled with nvcc from the
   sources in this checkout (one nvcc per source, all started together);
3. kernels: each kernel's wrapper against its plain PyTorch version on
   the card, at the shapes the main path gives it, with CUDA-event times
   of the kernel, the plain version and a PyTorch library call doing the
   same function (``library_ms``, a yardstick the port never calls);
4. serve: ``DecodeEngine`` at the full width of the decode bench model
   (``TinyDecoder(vocab_size=1024, num_layers=4, num_heads=8,
   head_dim=64)``, 16 slots, max_seq_len 1152, prefill ladder 8/16/32,
   prefix cache on) answers 32 requests, some sharing a 32-token system
   prompt; every output must equal the port's no-cache oracle on the
   card, and every kernel of the path must have launched (counts reset
   just before, read just after).

The line before the last is a JSON object ``{"kernels": [...]}``; the
last line is ``{"ok": true, "device": {...}}``. Without a CUDA device, or
without the rest of the checkout beside it, the script exits non-zero
and prints no result.
"""
import json
import os
import subprocess
import sys
import time

import numpy as np

# H100 SXM published peaks (NVIDIA data sheet; dense, at the full 700 W)
PEAK_BYTES_S = 3.35e12
PEAK_FP32_FLOPS = 67e12

# the decode bench model and plane (the JAX package's bench.py,
# BENCH_DECODE full configuration)
MODEL = dict(vocab_size=1024, num_layers=4, num_heads=8, head_dim=64)
SLOTS, MAX_SEQ, PAGE = 16, 1152, 16
MAX_PAGES = MAX_SEQ // PAGE
N_REQ, OUT_CAP, SYSTEM_LEN = 32, 256, 32
OUT_MIX = [16] * 3 + [64] * 2 + [256, 512, 1024]
KERNEL_TOL = 1e-4  # fp32, another summation order than the plain einsum


def fail(msg):
    print("chip_smoke FAILED: %s" % msg, flush=True)
    sys.exit(1)


def phase(name, **fields):
    print(json.dumps({"phase": name, **fields}), flush=True)


def time_ms(fn, iters=50, warm=3):
    """Mean device time of ``fn()`` over ``iters`` runs, CUDA events."""
    import torch

    for _ in range(warm):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def build_all():
    """Start one nvcc per kernel source, all together, and wait."""
    from concurrent.futures import ThreadPoolExecutor

    from mxnet_tpu_torch.ops import _build

    names = sorted(f[:-3] for f in os.listdir(os.path.dirname(
        _build.source_path("x"))) if f.endswith(".cu"))
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=len(names)) as pool:
        list(pool.map(_build.load, names))
    secs = time.perf_counter() - t0
    ptxas = {n: [ln.strip() for ln in _build.build_log(n).splitlines()
                 if "registers" in ln or "spill" in ln] for n in names}
    return names, secs, ptxas


def _attention_case(rng, s, h, kh, d, seq_lens, q_pos=None):
    """Inputs of one paged-attention call on the card: q, pools sized like
    the engine's (S*max_pages + 1 pages), a page table of distinct pages
    per slot padded with the null page past each slot's end."""
    import torch

    n_pages = s * MAX_PAGES + 1
    dev = torch.device("cuda")
    q = torch.tensor(rng.randn(s, h, d).astype(np.float32), device=dev)
    kp = torch.tensor(rng.randn(n_pages, PAGE, kh, d).astype(np.float32),
                      device=dev)
    vp = torch.tensor(rng.randn(n_pages, PAGE, kh, d).astype(np.float32),
                      device=dev)
    perm = rng.permutation(np.arange(1, n_pages)).astype(np.int32)
    pt = perm[:s * MAX_PAGES].reshape(s, MAX_PAGES).copy()
    for i, n in enumerate(seq_lens):
        pt[i, -(-int(n) // PAGE):] = 0
    args = [q, kp, vp, torch.tensor(pt, device=dev),
            torch.tensor(np.asarray(seq_lens, np.int32), device=dev)]
    qp = (None if q_pos is None
          else torch.tensor(np.asarray(q_pos, np.int32), device=dev))
    return args, qp


def _bound(s, h, kh, d, limits):
    """Least time (ms) for the work these inputs need: each input byte
    read once, each output written once, on the card's peak rates."""
    toks = int(np.sum(limits))
    pages = int(np.sum(-(-np.asarray(limits) // PAGE)))
    nbytes = (2 * s * h * d * 4          # q in, out
              + toks * kh * d * 4 * 2    # the K and V rows attended
              + pages * 4 + s * 4 * 2)   # page ids, seq_lens (+ q_pos)
    flops = 4 * d * h * toks             # q.k and p.v
    t_bytes, t_ops = nbytes / PEAK_BYTES_S, flops / PEAK_FP32_FLOPS
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def check_kernels():
    """Each paged-attention shape of the main path: the kernel against
    the plain version on the same inputs, then timed."""
    import torch
    import torch.nn.functional as F

    from mxnet_tpu_torch.ops import paged_attention as pa

    rng = np.random.RandomState(0)
    ragged = [0, 1, 15, 16, 17, 31, 32, 33, 47, 100, 255, 256, 257, 600,
              1151, 1152]
    cases = [
        ("decode_bench", 8, 8, ragged, None),
        ("decode_gqa_8_over_2", 8, 2, ragged, None),
        ("decode_causal_q_pos", 8, 8, ragged,
         [max(0, n - 1 - (7 * i) % 13) for i, n in enumerate(ragged)]),
    ]
    results = {}
    worst = 0.0
    for name, h, kh, lens, qpos in cases:
        args, qp = _attention_case(rng, SLOTS, h, kh, 64, lens, qpos)
        got = pa.ragged_paged_attention(*args, q_pos=qp)
        torch.cuda.synchronize()
        want = pa.paged_attention_reference(*args, q_pos=qp)
        err = float((got - want).abs().max())
        worst = max(worst, err)
        if not torch.allclose(got, want, atol=KERNEL_TOL, rtol=KERNEL_TOL):
            fail("kernel %s disagrees with the plain version: max abs "
                 "err %.3g" % (name, err))
        results[name] = (args, qp, lens, h, kh, err)
        phase("kernel_check", case=name, max_abs_err=err, tol=KERNEL_TOL)

    # the prefix-hit tail: a 32-row chunk (the top prefill rung) of one
    # sequence at positions 32..51 over its own page row, causal
    dev = torch.device("cuda")
    args, _ = _attention_case(rng, 1, 8, 8, 64, [52])
    q = torch.tensor(rng.randn(32, 8, 64).astype(np.float32), device=dev)
    row = args[3][0]
    got = pa.paged_prefill_attention(q, args[1], args[2], row, 32, 20)
    torch.cuda.synchronize()
    idx = torch.arange(32, dtype=torch.int32, device=dev)
    want = pa.paged_attention_reference(
        q, args[1], args[2], row[None].expand(32, -1),
        torch.where(idx < 20, idx + 33, torch.zeros_like(idx)),
        q_pos=idx + 32)
    err = float((got - want).abs().max())
    worst = max(worst, err)
    if not torch.allclose(got, want, atol=KERNEL_TOL, rtol=KERNEL_TOL):
        fail("prefill-chunk kernel disagrees with the plain version: max "
             "abs err %.3g" % err)
    phase("kernel_check", case="prefill_chunk_32", max_abs_err=err,
          tol=KERNEL_TOL)

    def times(case, args, lens, h, kh):
        ms = time_ms(lambda: pa.ragged_paged_attention(*args))
        plain_ms = time_ms(lambda: pa.paged_attention_reference(*args))
        q, kp, vp, pt, sl = args
        t = MAX_PAGES * PAGE
        kg = kp[pt.long()].reshape(SLOTS, t, kh, 64).transpose(1, 2)
        vg = vp[pt.long()].reshape(SLOTS, t, kh, 64).transpose(1, 2)
        kg, vg = kg.contiguous(), vg.contiguous()
        mask = (torch.arange(t, device=dev)[None, :] < sl[:, None].long())
        mask = mask[:, None, None, :]
        qs = q[:, :, None, :]
        library_ms = time_ms(lambda: F.scaled_dot_product_attention(
            qs, kg, vg, attn_mask=mask))
        bound_ms, bound_by = _bound(SLOTS, h, kh, 64, lens)
        phase("kernel_time", case=case, ms=ms, plain_ms=plain_ms,
              library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by,
              library="scaled_dot_product_attention over K/V gathered "
                      "beforehand (gather not timed)")
        return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                    bound_by=bound_by, library_ms=library_ms)

    # times at the decode bench shape (the JSON line's numbers), then with
    # every slot at max_seq_len: the most bytes one tick's layer can read
    args, _qp, lens, h, kh, _err = results["decode_bench"]
    bench = times("decode_bench", args, lens, h, kh)
    full = [MAX_SEQ] * SLOTS
    args, _ = _attention_case(rng, SLOTS, 8, 8, 64, full)
    times("decode_full_%d" % MAX_SEQ, args, full, 8, 8)
    return {"name": "paged_attention", "route": "cuda",
            "source": "mxnet_tpu_torch/ops/csrc/paged_attention.cu",
            "replaces": "mxnet_tpu/ops/pallas_kernels.py:292",
            "max_abs_err": worst, **bench}


def serve():
    """The main path: submit -> admission -> prefill -> ticks -> fetch."""
    import torch

    from mxnet_tpu_torch import serving
    from mxnet_tpu_torch.ops import paged_attention as pa

    model = serving.TinyDecoder(**MODEL)
    params = model.init_params(0)  # no device given: the card
    rng = np.random.RandomState(0)
    system = rng.randint(1, MODEL["vocab_size"], SYSTEM_LEN)
    reqs = []
    for i in range(N_REQ):
        p = rng.randint(1, MODEL["vocab_size"], int(rng.randint(4, 24)))
        if i % 3 == 1:  # a third of the traffic shares a system prompt
            p = np.concatenate([system, p])
        reqs.append((p.astype(np.int32), min(OUT_MIX[i % len(OUT_MIX)],
                                             OUT_CAP)))
    eng = serving.DecodeEngine(
        model, params, num_slots=SLOTS, max_seq_len=MAX_SEQ,
        page_size=PAGE, prefill_buckets=(8, 16, 32), prefix_cache=True,
        timeout_ms=0, name="chip_smoke")
    try:
        eng.warmup()
        before = eng.stats()
        pa.ragged_paged_attention.launches = 0
        t0 = time.perf_counter()
        outs = [f.result(timeout=600)
                for f in [eng.submit(p, m) for p, m in reqs]]
        wall = time.perf_counter() - t0
        launches = pa.ragged_paged_attention.launches
        stats = eng.stats()
        profile_ticks(eng, rng)
    finally:
        eng.close()
    ticks = stats["ticks"] - before["ticks"]
    if stats["device"].split(":")[0] != "cuda":
        fail("the engine ran on %s, not the card" % stats["device"])
    if launches < ticks * MODEL["num_layers"]:
        fail("paged-attention kernel launched %d times for %d ticks x %d "
             "layers" % (launches, ticks, MODEL["num_layers"]))
    hits = stats["kvcache"]["prefix_hits"] - before["kvcache"]["prefix_hits"]
    if hits < 1 or stats["prefill_chunks"] < 1:
        fail("no prefix-cache hit ran the q_pos kernel path")
    bad = []
    for i, ((p, m), got) in enumerate(zip(reqs, outs)):
        ref = model.reference_generate(params, p, m)
        if got.shape != (m,) or not np.array_equal(got, ref):
            bad.append(i)
    if bad:
        fail("%d of %d outputs differ from the oracle (requests %s)"
             % (len(bad), len(reqs), bad[:8]))
    tokens = int(sum(len(o) for o in outs))
    phase("serve", requests=len(reqs), tokens=tokens, wall_s=wall,
          tokens_per_s=tokens / wall, ttft_p50_ms=stats["ttft_p50_ms"],
          tpot_p50_ms=stats["tpot_p50_ms"], ticks=ticks,
          kernel_launches=launches, prefix_hits=hits,
          prefill_chunks=stats["prefill_chunks"],
          outputs_equal_oracle=True, max_mem_gib=torch.cuda.
          max_memory_allocated() / 2 ** 30)
    return launches


def profile_ticks(eng, rng, n_req=SLOTS, new_tokens=64):
    """Where a tick's time goes: one wave of requests that fills every
    slot, traced with torch.profiler (device activity only). Prints the
    wave's wall time, the device's busy time (the kernels and copies of
    one stream do not overlap, so their durations add up) and the
    paged-attention kernel's share of it."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    reqs = [rng.randint(1, MODEL["vocab_size"], int(rng.randint(4, 24)))
            for _ in range(n_req)]
    ticks0 = eng.stats()["ticks"]
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for f in [eng.submit(p, new_tokens) for p in reqs]:
            f.result(timeout=600)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    ticks = eng.stats()["ticks"] - ticks0
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + \
                e.time_range.elapsed_us() / 1e3
    busy_ms = sum(by_name.values())
    if busy_ms <= 0.0:
        fail("the profiler saw no device time in the traced wave")
    paged_ms = sum(v for k, v in by_name.items() if "paged_attention" in k)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    phase("tick_profile", requests=n_req, ticks=ticks, wall_ms=wall_ms,
          device_busy_ms=busy_ms, device_busy_share=busy_ms / wall_ms,
          paged_attention_ms=paged_ms,
          paged_attention_share_of_busy=paged_ms / busy_ms,
          per_tick_wall_ms=wall_ms / max(ticks, 1),
          per_tick_busy_ms=busy_ms / max(ticks, 1),
          top_device_ms=[[k[:60], v] for k, v in top])


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(here, "mxnet_tpu_torch")):
        print("chip_smoke: mxnet_tpu_torch/ is not beside this script; run "
              "it from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, here)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(smi, flush=True)
    phase("environment", torch=torch.__version__, cuda=torch.version.cuda,
          device=torch.cuda.get_device_name(0), nvidia_smi=smi,
          tf32_matmul=False, tf32_cudnn=False)

    names, secs, ptxas = build_all()
    phase("build", kernels=names, seconds=secs, ptxas=ptxas)

    entry = check_kernels()
    entry["launches"] = serve()
    print(json.dumps({"kernels": [entry]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
