"""Sweep the tiling of ``mxnet_tpu_torch/ops/csrc/paged_attention.cu``
(kernel 1) and ``paged_spec_attention.cu`` (kernel 2) on the card: the
readings that chose their ``kSpan`` and kernel 1's chunk rows.

    python3 paged_attention_sweep.py [--ablate]

run from the root of a checkout on a machine with a CUDA device. It
builds copies of the kernel source (one nvcc each, in parallel, under the
ignored ``mxnet_tpu_torch/ops/_build/sweep/``): ``kSpan`` at 64, 128 and
256, and ``units_4``, the built span with ``kMaxUnits`` 4 (a chunk block
of 4 rows, not 8, at H = KH). It times kernel 1 (split + merge, device
time from torch.profiler through ``chip_smoke.device_ms_by_kernel``, and
CUDA events over back-to-back calls) at the decode bench shape (16
slots, H = KH = 8, D = 64, ragged lengths 0..1152), with every slot at
1152, with every slot under 90 (a young batch), and on the 64-row
(positions 512..575) and 32-row (32..51) prefill chunks. Every call is
checked against the plain version first. ``--ablate`` also builds two
variants at the built span, one without the attention math and one
without its shared-memory reads of K and V, to show where a chunk's time
goes. Kernel 2 is built at ``kSpan`` 64, 128 and 256 (``spec_span_*``)
and timed at the spec bench (16 slots, W = 5, limits 10..57), with every
slot at 1148..1152, at 600..604, and with every slot's rows straddling
position 128 (126..130) or 256 (254..258); at the built span also
``spec_tile_64`` (tiles of 64 tokens, not 32) and ``spec_4_blocks`` (4
blocks a SM, not 3, at D <= 64); ``--ablate`` adds ``spec_no_math``, the
built span without the attention math. The variants are made by
replacing lines of the source, so the script stops, naming the variant,
once the source no longer has them. Nothing selects a variant at run
time. One JSON line per reading.
"""
import ctypes
import json
import os
import subprocess
import sys

import numpy as np
import torch

import chip_smoke
from mxnet_tpu_torch.ops import _build
from mxnet_tpu_torch.ops import paged_attention as pa

SPANS = (64, 128, 256)
PAGE, MAX_PAGES, SLOTS = 16, 72, 16
# name: (span, [(text in the source, its replacement), ...]); kernel 1's
_VARIANTS = {
    "units_4": [("constexpr int kMaxUnits = kWarps;",
                 "constexpr int kMaxUnits = 4;")],
}
_ABLATIONS = {
    "no_math": [("    if (computes) {\n      for (int s0",
                 "    if (computes && g.D < 0) {\n      for (int s0")],
    "no_kv_reads": [
        ("        load_lane<DC>(kt + t * g.Ds, dc, kv);\n",
         "        for (int i = 0; i < kLD; ++i) kv[i] = qr[i];\n"),
        ("        load_lane<DC>(vt + t * g.Ds, dc, vv);\n",
         "        for (int i = 0; i < kLD; ++i) vv[i] = p;\n")],
}


def _edit(src, name, edits):
    for old, new in edits:
        if old not in src:
            raise SystemExit("variant %s no longer applies to the source"
                             % name)
        src = src.replace(old, new)
    return src


# kernel 2's: 64-token tiles (8 tokens a warp), 4 blocks a SM at D <= 64
_SPEC_VARIANTS = {
    "spec_tile_64": [("constexpr int kTile = 32;",
                      "constexpr int kTile = 64;")],
    "spec_4_blocks": [("DC <= 8 ? 3 : DC <= 16 ? 2 : 1",
                       "DC <= 8 ? 4 : DC <= 16 ? 2 : 1")],
}
_SPEC_ABLATIONS = {
    "spec_no_math": [("if (u >= units || pos >= lim[u]) continue;",
                      "if (u >= 0) continue;")],
}


def _variants(ablate):
    """{name: (span, source text)}: kernel 1's, then kernel 2's
    (``spec_*``)."""
    src = open(_build.source_path("paged_attention")).read()
    span_line = "constexpr int kSpan = %d;"
    out = {"span_%d" % s: (s, _edit(src, "span_%d" % s,
                                    [(span_line % pa.SPAN, span_line % s)]))
           for s in SPANS}
    more = dict(_VARIANTS, **(_ABLATIONS if ablate else {}))
    for name, edits in more.items():
        out[name] = (pa.SPAN, _edit(src, name, edits))
    spec = open(_build.source_path("paged_spec_attention")).read()
    for s in SPANS:
        out["spec_span_%d" % s] = (s, _edit(
            spec, "spec_span_%d" % s,
            [(span_line % pa.SPAN, span_line % s)]))
    more = dict(_SPEC_VARIANTS, **(_SPEC_ABLATIONS if ablate else {}))
    for name, edits in more.items():
        out[name] = (pa.SPAN, _edit(spec, name, edits))
    return out


def _build_all(variants):
    """Compile every variant, all at once; {name: (span, CDLL)}."""
    out_dir = os.path.join(os.path.dirname(_build.source_path("x")), "..",
                           "_build", "sweep")
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name, (span, text) in variants.items():
        cu = os.path.join(out_dir, name + ".cu")
        with open(cu, "w") as f:
            f.write(text)
        lib = os.path.join(out_dir, name + ".so")
        procs[name] = (span, lib, subprocess.Popen(
            [_build._nvcc(), *_build.FLAGS, "-o", lib, cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (span, lib, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit("nvcc failed for %s:\n%s" % (name, log))
        libs[name] = (span, ctypes.CDLL(lib))
    return libs


def _inputs(rng, rows, lens):
    """q (rows, 8, 64), pools of SLOTS * MAX_PAGES + 1 pages, a table of
    distinct pages (null page 0 past each row's length), lengths."""
    dev = torch.device("cuda")
    n_pages = SLOTS * MAX_PAGES + 1

    def rand(*shape):
        return torch.tensor(rng.randn(*shape).astype(np.float32), device=dev)
    q, kp, vp = rand(rows, 8, 64), rand(n_pages, PAGE, 8, 64), \
        rand(n_pages, PAGE, 8, 64)
    pt = rng.permutation(np.arange(1, n_pages))[:len(lens) * MAX_PAGES]
    pt = pt.astype(np.int32).reshape(len(lens), MAX_PAGES)
    for i, n in enumerate(lens):
        pt[i, -(-int(n) // PAGE):] = 0
    return q, kp, vp, torch.tensor(pt, device=dev), \
        torch.tensor(np.asarray(lens, np.int32), device=dev)


def _spec_runs(lib, span, cases, stream, scale):
    """[(case, call, out, want)] of kernel 2's entry point in ``lib``."""
    fn = lib.paged_spec_attention_f32
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 9 + [
        ctypes.c_float, ctypes.c_void_p]
    runs = []
    for case, (q, kp, vp, pt, sl) in cases.items():
        s, w = q.shape[:2]
        plan = pa._spec_plan(s, w, 8, 8, 64, PAGE, MAX_PAGES, span=span)
        ws = torch.empty(plan.workspace_numel, device=q.device)
        arrivals = torch.zeros(plan.tiles, dtype=torch.int32,
                               device=q.device)
        out = torch.empty_like(q)

        def call(q=q, kp=kp, vp=vp, pt=pt, sl=sl, ws=ws, out=out,
                 arrivals=arrivals, plan=plan, s=s, w=w):
            if fn(q.data_ptr(), kp.data_ptr(), vp.data_ptr(), pt.data_ptr(),
                  sl.data_ptr(), out.data_ptr(), ws.data_ptr(),
                  arrivals.data_ptr(), s, w, 8, 8, 64, PAGE, MAX_PAGES,
                  plan.nsplit, plan.tiles, scale, stream):
                raise SystemExit("launch failed")
        want = pa.paged_spec_attention_reference(
            q.reshape(s * w, 8, 64), kp, vp, pt, sl,
            scale=scale).reshape(q.shape)
        runs.append((case, call, out, want))
    return runs


def _spec_inputs(rng, lens):
    """Kernel 2's operands for per-row limits ``lens`` (SLOTS, W)."""
    q, kp, vp, pt, _ = _inputs(rng, SLOTS * lens.shape[1], lens.max(axis=1))
    return (q.reshape(SLOTS, lens.shape[1], 8, 64), kp, vp, pt,
            torch.tensor(lens.ravel(), device=q.device))


def main():
    if not torch.cuda.is_available():
        raise SystemExit("paged_attention_sweep: no CUDA device")
    ablate = sys.argv[1:] == ["--ablate"]
    rng = np.random.RandomState(0)
    decode = {
        "decode_bench": _inputs(rng, SLOTS, [0, 1, 15, 16, 17, 31, 32, 33, 47,
                                             100, 255, 256, 257, 600, 1151,
                                             1152]),
        "decode_full_1152": _inputs(rng, SLOTS, [1152] * SLOTS),
        "decode_short": _inputs(rng, SLOTS, [5, 9, 14, 20, 27, 33, 38, 44,
                                             51, 57, 62, 68, 73, 79, 84,
                                             88]),
    }
    chunks = {}
    for c, start, n in ((64, 512, 64), (32, 32, 20)):
        q, kp, vp, pt, _ = _inputs(rng, c, [start + n])
        chunks["prefill_chunk_%d" % c] = (q, kp, vp, pt[0].contiguous(),
                                          start, n)
    w = 5
    steps = np.arange(w, dtype=np.int32)
    spec = {
        "spec_bench": _spec_inputs(rng, np.asarray(
            [10 + int(rng.randint(0, 44)) + steps for _ in range(SLOTS)])),
        "spec_full_1152": _spec_inputs(rng, np.asarray(
            [1148 + steps] * SLOTS)),
        "spec_straddle_128": _spec_inputs(rng, np.asarray(
            [126 + steps] * SLOTS)),
        "spec_straddle_256": _spec_inputs(rng, np.asarray(
            [254 + steps] * SLOTS)),
        "spec_mid_600": _spec_inputs(rng, np.asarray(
            [600 + steps] * SLOTS)),
    }
    stream = torch.cuda.current_stream().cuda_stream
    scale = 1.0 / 8.0
    for name, (span, lib) in _build_all(_variants(ablate)).items():
        if name.startswith("spec_"):
            for case, call, out, want in _spec_runs(lib, span, spec, stream,
                                                    scale):
                call()
                torch.cuda.synchronize()
                err = float((out - want).abs().max())
                if name not in _SPEC_ABLATIONS and \
                        err > chip_smoke.KERNEL_TOL:
                    raise SystemExit("%s %s disagrees with the plain "
                                     "version: %g" % (name, case, err))
                by_kernel = chip_smoke.device_ms_by_kernel(
                    call, chip_smoke.KERNEL_2, iters=50, per_call=1)
                print(json.dumps({
                    "variant": name, "span": span, "case": case,
                    "max_abs_err": err,
                    "device_ms": sum(by_kernel.values()),
                    "ms": chip_smoke.time_ms(call, iters=200)}), flush=True)
            continue
        dec = lib.paged_attention_f32
        dec.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 + [
            ctypes.c_float, ctypes.c_void_p]
        pre = lib.paged_prefill_attention_f32
        pre.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 9 + [
            ctypes.c_float, ctypes.c_void_p]
        runs = []
        for case, (q, kp, vp, pt, sl) in decode.items():
            plan = pa._split_plan(SLOTS, 8, 8, 64, PAGE, MAX_PAGES, span=span)
            ws = torch.empty(plan.workspace_numel, device=q.device)
            out = torch.empty_like(q)

            def call(q=q, kp=kp, vp=vp, pt=pt, sl=sl, ws=ws, out=out,
                     plan=plan):
                if dec(q.data_ptr(), kp.data_ptr(), vp.data_ptr(),
                       pt.data_ptr(), sl.data_ptr(), None, out.data_ptr(),
                       ws.data_ptr(), SLOTS, 8, 8, 64, PAGE, MAX_PAGES,
                       plan.nsplit, scale, stream):
                    raise SystemExit("launch failed")
            want = pa.paged_attention_reference(q, kp, vp, pt, sl,
                                                scale=scale)
            runs.append((case, call, out, want, MAX_PAGES * PAGE))
        for case, (q, kp, vp, row, start, n) in chunks.items():
            c = q.shape[0]
            idx = torch.arange(c, dtype=torch.int32, device=q.device)
            want = pa.paged_attention_reference(
                q, kp, vp, row[None].expand(c, -1).contiguous(),
                torch.where(idx < n, idx + start + 1, torch.zeros_like(idx)),
                q_pos=idx + start, scale=scale)
            plan = pa._split_plan(c, 8, 8, 64, PAGE, MAX_PAGES, chunk=True,
                                  span=span)
            ws = torch.empty(plan.workspace_numel, device=q.device)
            out = torch.empty_like(q)

            def call(q=q, kp=kp, vp=vp, row=row, ws=ws, out=out, c=c,
                     start=start, n=n, plan=plan):
                if pre(q.data_ptr(), kp.data_ptr(), vp.data_ptr(),
                       row.data_ptr(), out.data_ptr(), ws.data_ptr(), c,
                       start, n, 8, 8, 64, PAGE, MAX_PAGES, plan.nsplit,
                       scale, stream):
                    raise SystemExit("launch failed")
            runs.append((case, call, out, want, start + n))
        for case, call, out, want, max_limit in runs:
            call()
            torch.cuda.synchronize()
            err = float((out - want).abs().max())
            if name in _ABLATIONS or err <= chip_smoke.KERNEL_TOL:
                by_kernel = chip_smoke.device_ms_by_kernel(
                    call, chip_smoke.KERNEL_1, iters=50,
                    per_call=1 + (max_limit > span))
                print(json.dumps({
                    "variant": name, "span": span, "case": case,
                    "max_abs_err": err,
                    "device_ms": sum(by_kernel.values()) if by_kernel
                    else None,
                    "device_ms_by_kernel": by_kernel,
                    "ms": chip_smoke.time_ms(call, iters=200)}), flush=True)
            else:
                raise SystemExit("%s %s disagrees with the plain version: "
                                 "%g" % (name, case, err))


if __name__ == "__main__":
    main()
