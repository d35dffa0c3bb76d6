#!/usr/bin/env python3
"""Drive the PyTorch port on one CUDA card and hold each kernel against its plain version.

Run from the root of a checkout:  python3 chip_smoke.py

Phases, each printing one JSON line, each fatal when it fails:
  1. card      nvidia-smi name and power limit; TF32 off for cuDNN and matmul
  2. build     both CUDA kernels built from csrc/ with nvcc (build seconds, ptxas
               report); fails on any spill
  3. kernels   each kernel against its plain version on the card: the fused
               bottleneck on the trained, BN-folded weights of layers 6 and 8 at
               the activations the pipeline hands it, and at 32x40x40x128 on
               seeded weights; the greedy keep mask on the trained model's
               decoded predictions and on a random stress case at k = 512,
               1024, 2048
  4. pipeline  build_pipeline(ckpt, device="cuda") at 640 px on seeded synth
               frames (B, 360, 640, 1) for B = 1, 8, 32, with every launch count
               set to 0 just before and read just after; then the same pipeline
               on the CPU (plain versions) for 2 frames
  5. times     pipeline ms/batch, each kernel's time at its main-path shapes
               beside its bound, its plain version and (bottleneck) cuDNN, the
               kernel and cuDNN timed in turns; the bottleneck also at
               32x40x40x128; the NMS scan steps (kept boxes) per image
  6. profile   device kernel time by name, the port's own kernels' device
               time, and the device's busy share over five pipeline calls at
               B = 32 (torch.profiler)
Then the `kernels` line and, last, {"ok": true, "device": {...}}. It exits
non-zero, with no result line, when there is no card or the port is missing.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
CKPT = ROOT / "runs_artifacts" / "spectrogram_yolo11n.ckpt"
# H100 SXM peaks (NVIDIA data sheet): f32 on the CUDA cores, TF32 on the
# tensor cores (dense), HBM3 bandwidth
PEAK_F32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
PEAK_HBM_BYTES = 3.35e12
TF32_PASSES = 3  # the bottleneck runs 3xTF32: three tensor-core products per f32 product
IOU_OPS = 14  # 4 min/max, 4 sub, 2 clamp, 1 mul, 2 add/sub, 1 div; the areas are per box
BATCHES = (1, 8, 32)


def emit(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}), flush=True)


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean milliseconds per call on the card, CUDA events around `iters` calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def phase_card():
    import torch

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(smi, flush=True)
    emit("card", nvidia_smi=smi, name=torch.cuda.get_device_name(0), count=torch.cuda.device_count(),
         torch=torch.__version__, cuda=torch.version.cuda, tf32=False)
    return smi


def phase_build():
    from spectrogram_yolov11_torch.utils import kernels

    t0 = time.perf_counter()
    secs = kernels.build_all(force=True)
    keys = ("Compiling entry function", "Used", "spill")  # kernel name, registers and shared memory, spills
    report = {name: [ln.strip() for ln in log.splitlines() if any(k in ln for k in keys)]
              for name, log in kernels.BUILD_LOG.items()}
    require(set(secs) == set(kernels.KERNELS), f"not every kernel was built: {sorted(secs)}")
    spills = [ln for lines in report.values() for ln in lines if "spill" in ln and " 0 bytes spill stores" not in ln]
    require(not spills, f"ptxas reports spills: {spills}")
    emit("build", seconds={k: round(v, 2) for k, v in secs.items()}, wall_s=round(time.perf_counter() - t0, 2),
         ptxas=report)


def phase_kernels(fn, model, frames_dev):
    import numpy as np
    import torch

    from spectrogram_yolov11_torch.ops.decode import decode_detections
    from spectrogram_yolov11_torch.ops.fused_conv import (
        bottleneck_reference,
        fused_bottleneck,
        pack_bottleneck_weights,
        unpack_bottleneck_weights,
    )
    from spectrogram_yolov11_torch.ops.nms import nms_candidates
    from spectrogram_yolov11_torch.ops.nms_kernel import greedy_keep, greedy_keep_reference

    # the activations the pipeline hands the first bottleneck of layers 6 and 8, at B = 32
    captured = {}

    def keep_input(mod, args):  # returns None: the forward's input stays as it is
        captured.setdefault(mod, args[0].permute(0, 2, 3, 1).contiguous())

    def keep_feats(mod, args, out):
        captured["feats"] = out

    firsts = {layer: next(m for m in model.model[layer].modules() if getattr(m, "fusable", False)) for layer in (6, 8)}
    hooks = [m.register_forward_pre_hook(keep_input) for m in firsts.values()]
    hooks.append(model.model[-1].register_forward_hook(keep_feats))
    fn(frames_dev)
    for h in hooks:
        h.remove()

    # (x, w1 pack, b1, w2 pack, b2): the layers' folded packs, and C = 128
    # (the scale s/m/l width) on seeded weights
    cases = {}
    for layer, mod in firsts.items():
        x = captured[mod]
        c = x.shape[-1]
        cases[f"layer{layer}"] = (x, mod.w1.view(2, 9, c, c), mod.b1, mod.w2.view(2, 9, c, c), mod.b2)
    g = torch.Generator(device="cuda").manual_seed(0)
    x, w1, b1, w2, b2 = (torch.randn(shape, generator=g, device="cuda") * scale for shape, scale in (
        ((32, 40, 40, 128), 1.0), ((3, 3, 128, 128), 0.05), ((128,), 0.1), ((3, 3, 128, 128), 0.05), ((128,), 0.1)))
    cases["c128"] = (x, pack_bottleneck_weights(w1), b1, pack_bottleneck_weights(w2), b2)
    bottleneck = {}
    for name, args in cases.items():
        x, p1, b1, p2, b2 = args
        plain_args = (x, unpack_bottleneck_weights(p1), b1, unpack_bottleneck_weights(p2), b2)
        got, ref = fused_bottleneck(*args), bottleneck_reference(*plain_args)
        torch.cuda.synchronize()
        err = (got - ref).abs()
        ok = bool((err <= 1e-4 + 1e-4 * ref.abs()).all())
        bottleneck[name] = dict(shape=list(x.shape), max_abs_err=float(err.max()),
                                max_rel_err=float((err / ref.abs().clamp_min(1e-3)).max()), ok=ok,
                                args=args, plain_args=plain_args)
        require(ok, f"fused bottleneck {name} disagrees with its plain version: max abs {float(err.max())}")
    require([bottleneck[n]["shape"] for n in ("layer6", "layer8", "c128")]
            == [[32, 40, 40, 32], [32, 20, 20, 64], [32, 40, 40, 128]],
            f"unexpected bottleneck shapes {[b['shape'] for b in bottleneck.values()]}")

    preds = decode_detections(captured["feats"], model.nc, model.stride)
    _, _, _, valid, offset_boxes = nms_candidates(preds, 0.25, model.nc, pre_nms_topk=512)
    nms_cases = {"trained_k512": (offset_boxes, valid)}
    rng = np.random.default_rng(0)
    for k, b in ((512, 32), (1024, 8), (2048, 8)):
        centers = rng.uniform(50, 600, (b, 24, 2))
        cxy = np.take_along_axis(centers, rng.integers(0, 24, (b, k))[..., None], 1) + rng.normal(0, 4, (b, k, 2))
        wh = rng.uniform(40, 60, (b, k, 2))
        cls = rng.integers(0, 2, (b, k, 1)) * 7680.0
        boxes = np.concatenate([cxy - wh / 2, cxy + wh / 2], -1) + cls
        nms_cases[f"stress_k{k}"] = (torch.from_numpy(boxes.astype(np.float32)).cuda(),
                                     torch.from_numpy(rng.uniform(size=(b, k)) > 0.1).cuda())
    nms = {}
    for name, (bx, vd) in nms_cases.items():
        got, ref = greedy_keep(bx, vd, 0.7), greedy_keep_reference(bx, vd, 0.7)
        torch.cuda.synchronize()
        mismatches = int((got != ref).sum())
        nms[name] = dict(shape=list(bx.shape), kept=int(got.sum()), valid=int(vd.sum()), mismatches=mismatches)
        require(mismatches == 0, f"greedy keep mask {name} differs from its plain version in {mismatches} entries")
    emit("kernels",
         fused_bottleneck={k: {n: v for n, v in d.items() if "args" not in n} for k, d in bottleneck.items()},
         greedy_keep=nms)
    return bottleneck, nms_cases["trained_k512"]


def phase_pipeline(fn, model, frames_dev, frames_np):
    import torch

    from spectrogram_yolov11_torch.engine.pipeline import build_pipeline
    from spectrogram_yolov11_torch.ops.fused_conv import fused_bottleneck
    from spectrogram_yolov11_torch.ops.nms_kernel import greedy_keep

    fused_bottleneck.launches = greedy_keep.launches = 0
    results = {bs: fn(frames_dev[:bs]) for bs in BATCHES}
    torch.cuda.synchronize()
    launches = {"fused_bottleneck": fused_bottleneck.launches, "greedy_keep": greedy_keep.launches}
    per_image = {bs: n.tolist() for bs, (out, n) in results.items()}
    out_max, n_max = results[BATCHES[-1]]
    require(out_max.shape == (BATCHES[-1], 300, 6) and bool(torch.isfinite(out_max).all()), "pipeline output malformed")
    require(int(n_max.sum()) > 0, f"no detections on {BATCHES[-1]} seeded frames")
    require(launches["fused_bottleneck"] == 6 * len(BATCHES),
            f"fused_bottleneck launched {launches['fused_bottleneck']} times in {len(BATCHES)} forwards, expected 6 each")
    require(launches["greedy_keep"] == len(BATCHES),
            f"greedy_keep launched {launches['greedy_keep']} times in {len(BATCHES)} calls")

    fn_cpu, _, _, _ = build_pipeline(CKPT, device="cpu")
    out_c, n_c = fn_cpu(frames_np[:2])
    out_g, n_g = (t.cpu() for t in fn(frames_dev[:2]))
    box_err = float((out_c[..., :4] - out_g[..., :4]).abs().max())
    require(torch.equal(n_c, n_g), f"CPU and GPU pipelines disagree on counts: {n_c.tolist()} vs {n_g.tolist()}")
    require(torch.equal(out_c[..., 5], out_g[..., 5]) and box_err <= 1e-2,
            f"CPU and GPU pipelines disagree: classes or boxes (max {box_err} px)")
    emit("pipeline", launches=launches, detections_per_image=per_image, total_largest_batch=int(n_max.sum()),
         cpu_vs_gpu={"n_cpu": n_c.tolist(), "n_gpu": n_g.tolist(), "max_box_err_px": box_err})
    return launches


def phase_times(fn, frames_dev, bottleneck, nms_trained):
    import torch
    import torch.nn.functional as F

    from spectrogram_yolov11_torch.ops.fused_conv import bottleneck_reference, fused_bottleneck
    from spectrogram_yolov11_torch.ops.nms_kernel import greedy_keep, greedy_keep_reference

    pipeline = {}
    for bs in BATCHES:
        x = frames_dev[:bs]
        ms = cuda_ms(lambda: fn(x), iters=20)
        pipeline[bs] = {"ms_per_batch": ms, "img_per_s": bs / ms * 1e3}

    shapes = {}
    for name, d in bottleneck.items():
        x, w1, b1, w2, b2 = d["plain_args"]
        bsz, h, w, c = x.shape
        xc = x.permute(0, 3, 1, 2)  # channels_last NCHW view, as the network holds it
        w1o, w2o = w1.permute(3, 2, 0, 1).contiguous(), w2.permute(3, 2, 0, 1).contiguous()

        def cudnn_chain():
            y = F.silu(F.conv2d(xc, w1o, b1, padding=1))
            return F.silu(F.conv2d(y, w2o, b2, padding=1)) + xc

        def kernel():
            return fused_bottleneck(*d["args"])

        # the kernel and cuDNN in turns (cuDNN's algorithm choice varies between calls)
        turns = [cuda_ms(f, iters=50) for f in (kernel, cudnn_chain, cudnn_chain, kernel)]
        flops = 2 * 2 * 9 * bsz * h * w * c * c
        nbytes = 4 * (2 * x.numel() + w1.numel() + w2.numel() + b1.numel() + b2.numel())
        tc_s, f32_s, bytes_s = TF32_PASSES * flops / PEAK_TF32_FLOPS, flops / PEAK_F32_FLOPS, nbytes / PEAK_HBM_BYTES
        shapes[name] = dict(
            shape=[bsz, h, w, c],
            launches_per_forward={"layer6": 2, "layer8": 4, "c128": 0}[name],
            ms=(turns[0] + turns[3]) / 2, library_ms=(turns[1] + turns[2]) / 2, turns_kernel_lib_lib_kernel=turns,
            plain_ms=cuda_ms(lambda: bottleneck_reference(*d["plain_args"]), iters=50),
            flops=flops, bytes=nbytes,
            bound_ms=max(tc_s, bytes_s) * 1e3,
            bound_by="operations, 3xTF32 on the tensor cores" if tc_s >= bytes_s else "bytes",
            bound_f32_cuda_cores_ms=max(f32_s, bytes_s) * 1e3,
        )
    shapes["layer8"]["note"] = "layers 8 and 25 both run two bottlenecks at this shape"
    shapes["c128"]["note"] = "the C3k width of scales s, m and l; not on the main path"
    for d in shapes.values():
        d["share_of_bound"] = d["bound_ms"] / d["ms"]
        d["share_of_f32_cuda_core_bound"] = d["bound_f32_cuda_cores_ms"] / d["ms"]

    bx, vd = nms_trained
    b, k = vd.shape
    nv = vd.sum(1).double()
    ops = float((nv * (nv - 1) / 2).sum()) * IOU_OPS
    nbytes = b * k * (16 + 1 + 1)
    steps = greedy_keep(bx, vd, 0.7).sum(1)  # the scan takes one step per kept box
    nms = dict(
        shape=[b, k], launches_per_call=1,
        scan_steps_per_image=steps.tolist(), scan_steps_mean=float(steps.double().mean()),
        valid_per_image_mean=float(nv.mean()),
        ms=cuda_ms(lambda: greedy_keep(bx, vd, 0.7), iters=50),
        plain_ms=cuda_ms(lambda: greedy_keep_reference(bx, vd, 0.7), iters=5),
        library_ms=None, ops=ops, bytes=nbytes,
        bound_ms=max(ops / PEAK_F32_FLOPS, nbytes / PEAK_HBM_BYTES) * 1e3,
        bound_by="operations" if ops / PEAK_F32_FLOPS >= nbytes / PEAK_HBM_BYTES else "bytes",
    )
    nms["share_of_bound"] = nms["bound_ms"] / nms["ms"]
    emit("times", pipeline=pipeline, fused_bottleneck=shapes, greedy_keep=nms,
         method="CUDA events over repeated calls after 3 warm-up calls; frames already on the card")
    return shapes, nms


def phase_profile(fn, frames_dev, calls: int = 5):
    """Where the device time goes in `calls` pipeline calls at the largest batch:
    torch.profiler's CUDA kernel events, summed by kernel name; busy share =
    kernel time over the span from the first kernel's start to the last's end."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    x = frames_dev[: BATCHES[-1]]
    fn(x)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn(x)
        torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    by_name = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    busy = sum(by_name.values())
    span = (max(e.time_range.end for e in kernels) - min(e.time_range.start for e in kernels)) / 1e3 if kernels else 0.0
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:15]
    port = {}  # the port's own kernels, device time per pipeline call
    for name, ms in by_name.items():
        for key in ("fused_bottleneck_kernel", "nms_mask_kernel", "nms_scan_kernel"):
            if key in name:
                port[key] = port.get(key, 0.0) + ms / calls
    emit("profile", batch=BATCHES[-1], calls=calls, kernel_launches=len(kernels), host_ms_under_profiler=host_ms,
         device_kernel_ms_per_call=busy / calls, device_span_ms_per_call=span / calls,
         busy_share=busy / span if span else None, port_kernels_device_ms_per_call=port,
         top_kernels_ms_per_call=[[name[:90], ms / calls] for name, ms in top])


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False: this script needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    try:
        from spectrogram_yolov11_torch.data.synth import synth_frames
        from spectrogram_yolov11_torch.engine.pipeline import build_pipeline
    except ImportError as e:
        print(f"chip_smoke: the port is missing beside this script ({e})", file=sys.stderr)
        return 2
    require(CKPT.exists(), f"missing checkpoint {CKPT}")

    smi = phase_card()
    phase_build()
    fn, model, nh, nw = build_pipeline(CKPT, device="cuda")
    frames_np = synth_frames(max(BATCHES), nh, nw, seed=0)
    with torch.inference_mode():
        frames_dev = torch.from_numpy(frames_np).cuda()
        bottleneck, nms_trained = phase_kernels(fn, model, frames_dev)
        launches = phase_pipeline(fn, model, frames_dev, frames_np)
        shapes, nms = phase_times(fn, frames_dev, bottleneck, nms_trained)
        phase_profile(fn, frames_dev)

    fb = [shapes["layer6"], shapes["layer8"]]

    def per_forward(key):
        return sum(d[key] * d["launches_per_forward"] for d in fb)

    fb_ops_bound = TF32_PASSES * per_forward("flops") / PEAK_TF32_FLOPS >= per_forward("bytes") / PEAK_HBM_BYTES
    kernels_line = [
        dict(name="fused_bottleneck", route="cuda", source="spectrogram_yolov11_torch/csrc/fused_bottleneck.cu",
             replaces="spectrogram_yolov11_tpu/ops/pallas_fused_conv.py:67",
             launches=launches["fused_bottleneck"],
             max_abs_err=max(d["max_abs_err"] for d in bottleneck.values()),
             ms=per_forward("ms"), plain_ms=per_forward("plain_ms"), bound_ms=per_forward("bound_ms"),
             bound_by="operations" if fb_ops_bound else "bytes", library_ms=per_forward("library_ms"),
             bound_f32_cuda_cores_ms=per_forward("bound_f32_cuda_cores_ms"),
             design="implicit GEMM, 3xTF32 wgmma (A in registers), TMA weight ring, persistent grid",
             note="times are per forward at B=32: 2 launches at 32x40x40x32 + 4 at 32x20x20x64; "
                  "bound_ms is 3xTF32 on the tensor cores"),
        dict(name="greedy_keep", route="cuda", source="spectrogram_yolov11_torch/csrc/greedy_nms.cu",
             replaces="spectrogram_yolov11_tpu/ops/pallas_nms.py:70",
             launches=launches["greedy_keep"], max_abs_err=0.0,
             ms=nms["ms"], plain_ms=nms["plain_ms"], bound_ms=nms["bound_ms"], bound_by=nms["bound_by"],
             library_ms=None, design="IoU bitmask of valid rows + one-warp scan from survivor to survivor",
             scan_steps_mean=nms["scan_steps_mean"],
             note="one launch per pipeline call; times at B=32, k=512 on the trained model's candidates"),
    ]
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels_line}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
