#!/usr/bin/env python3
"""Drive the PyTorch port on one CUDA card and hold each kernel against its plain version.

Run from the root of a checkout:  python3 chip_smoke.py

Phases, each printing one JSON line, each fatal when it fails:
  1. card      nvidia-smi name and power limit; torch's TF32 settings, left as
               torch sets them: the port holds its own f32 policy
               (utils.full_f32 around the network's forward, the device
               function and the plain bottleneck)
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
  7. predict   YOLO(ckpt).predict on 4 seeded .npy IQ captures (640 frames
               each), one call each with the launch counts set to 0 just
               before and read just after (6 bottleneck, 1 NMS launches per
               call); 2 of them again through a CPU YOLO(..., device="cpu")
               (counts and classes equal, boxes within 1e-2 px); then
               .predict(32 mixed-size uint8 arrays, batch=32) the same way.
               The greedy keep kernel against its plain version at predict's
               k = 1024 on the trained model's candidates, and both kernels
               against their plain versions at B = 1 on the inputs the first
               capture's predict call handed them (the first bottleneck of
               layers 6 and 8, the (1, 1024) NMS candidates). Times: predict ms
               per capture at B = 1 and per image at batch 32, split into
               IQ -> frame, letterbox, device function and host postprocess,
               and the IQ path at batch 32 composed from the ported functions;
               the device function back to back at B = 1 and 32; last, how
               far the head's outputs move when the first capture's forward
               runs with TF32 on (what the f32 policy holds off)
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
IQ_SAMPLES = 256 + 128 * 639  # one capture of 640 STFT frames at the IQ loader's n_fft 256, hop 128
ARRAY_SHAPES = ((360, 640, 1), (720, 1280, 3), (500, 333, 3))
PREDICT_BATCH = 32


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
    print(smi, flush=True)
    emit("card", nvidia_smi=smi, name=torch.cuda.get_device_name(0), count=torch.cuda.device_count(),
         torch=torch.__version__, cuda=torch.version.cuda,
         process_tf32={"cudnn": torch.backends.cudnn.allow_tf32, "matmul": torch.backends.cuda.matmul.allow_tf32},
         policy="left as torch sets them; the network's forward, the device function and the plain "
                "bottleneck run in full f32 (utils.full_f32), and so does the cuDNN chain timed as the library call")
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


def first_bottlenecks(model) -> dict:
    """The first fusable bottleneck of layers 6 and 8 (C3k widths 32 and 64)."""
    return {layer: next(m for m in model.model[layer].modules() if getattr(m, "fusable", False)) for layer in (6, 8)}


def keep_nhwc_input(captured: dict):
    """A forward pre-hook that keeps a module's first input as NHWC, once."""
    def hook(mod, args):  # returns None: the forward's input stays as it is
        captured.setdefault(mod, args[0].permute(0, 2, 3, 1).contiguous())
    return hook


def bottleneck_check(name: str, args) -> dict:
    """The fused bottleneck against its plain version on (x, w1 pack, b1, w2
    pack, b2), at 1e-4 abs/rel."""
    import torch

    from spectrogram_yolov11_torch.ops.fused_conv import (
        bottleneck_reference,
        fused_bottleneck,
        unpack_bottleneck_weights,
    )

    x, p1, b1, p2, b2 = args
    plain_args = (x, unpack_bottleneck_weights(p1), b1, unpack_bottleneck_weights(p2), b2)
    got, ref = fused_bottleneck(*args), bottleneck_reference(*plain_args)
    torch.cuda.synchronize()
    err = (got - ref).abs()
    ok = bool((err <= 1e-4 + 1e-4 * ref.abs()).all())
    require(ok, f"fused bottleneck {name} disagrees with its plain version: max abs {float(err.max())}")
    return dict(shape=list(x.shape), max_abs_err=float(err.max()),
                max_rel_err=float((err / ref.abs().clamp_min(1e-3)).max()), ok=ok, args=args, plain_args=plain_args)


def layer_case(mod, x):
    """(x, w1 pack, b1, w2 pack, b2) of a folded bottleneck at input x."""
    c = x.shape[-1]
    return x, mod.w1.view(2, 9, c, c), mod.b1, mod.w2.view(2, 9, c, c), mod.b2


def phase_kernels(fn, model, frames_dev):
    import numpy as np
    import torch

    from spectrogram_yolov11_torch.ops.decode import decode_detections
    from spectrogram_yolov11_torch.ops.fused_conv import pack_bottleneck_weights
    from spectrogram_yolov11_torch.ops.nms import nms_candidates
    from spectrogram_yolov11_torch.ops.nms_kernel import greedy_keep, greedy_keep_reference

    # the activations the pipeline hands the first bottleneck of layers 6 and 8, at B = 32
    captured = {}

    def keep_feats(mod, args, out):
        captured["feats"] = out

    firsts = first_bottlenecks(model)
    hooks = [m.register_forward_pre_hook(keep_nhwc_input(captured)) for m in firsts.values()]
    hooks.append(model.model[-1].register_forward_hook(keep_feats))
    fn(frames_dev)
    for h in hooks:
        h.remove()

    # (x, w1 pack, b1, w2 pack, b2): the layers' folded packs, and C = 128
    # (the scale s/m/l width) on seeded weights
    cases = {f"layer{layer}": layer_case(mod, captured[mod]) for layer, mod in firsts.items()}
    g = torch.Generator(device="cuda").manual_seed(0)
    x, w1, b1, w2, b2 = (torch.randn(shape, generator=g, device="cuda") * scale for shape, scale in (
        ((32, 40, 40, 128), 1.0), ((3, 3, 128, 128), 0.05), ((128,), 0.1), ((3, 3, 128, 128), 0.05), ((128,), 0.1)))
    cases["c128"] = (x, pack_bottleneck_weights(w1), b1, pack_bottleneck_weights(w2), b2)
    bottleneck = {name: bottleneck_check(name, args) for name, args in cases.items()}
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
    from spectrogram_yolov11_torch.ops.nms_kernel import greedy_keep
    from spectrogram_yolov11_torch.utils import full_f32

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

        @full_f32()
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
    nms = dict(nms_check(bx, vd), launches_per_call=1,
               scan_steps_per_image=greedy_keep(bx, vd, 0.7).sum(1).tolist())  # one scan step per kept box
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


def _mixed_arrays(n: int, seed: int):
    """n seeded uint8 BGR frames cycling through ARRAY_SHAPES: spectrogram
    content (data/synth.py), the 3-channel ones tinted so the batch is colour."""
    import numpy as np

    from spectrogram_yolov11_torch.data.synth import synth_frames

    out = []
    for i in range(n):
        h, w, c = ARRAY_SHAPES[i % len(ARRAY_SHAPES)]
        f = synth_frames(1, h, w, seed=seed + i)[0]
        out.append(f if c == 1 else (np.repeat(f, 3, -1) * np.array([1.0, 0.9, 0.8])).astype(np.uint8))
    return out


def nms_check(bx, vd):
    """The greedy keep kernel against its plain version on (boxes, valid), with
    its time, plain time and bound."""
    import torch

    from spectrogram_yolov11_torch.ops.nms_kernel import greedy_keep, greedy_keep_reference

    got, ref = greedy_keep(bx, vd, 0.7), greedy_keep_reference(bx, vd, 0.7)
    torch.cuda.synchronize()
    mismatches = int((got != ref).sum())
    require(mismatches == 0, f"greedy keep mask at k = {vd.shape[1]} differs from its plain version in {mismatches} entries")
    b, k = vd.shape
    nv = vd.sum(1).double()
    ops = float((nv * (nv - 1) / 2).sum()) * IOU_OPS
    nbytes = b * k * (16 + 1 + 1)
    d = dict(shape=[b, k], kept=int(got.sum()), valid=int(nv.sum()), mismatches=mismatches,
             scan_steps_mean=float(got.sum(1).double().mean()),
             ms=cuda_ms(lambda: greedy_keep(bx, vd, 0.7), iters=50),
             plain_ms=cuda_ms(lambda: greedy_keep_reference(bx, vd, 0.7), iters=5), library_ms=None,
             ops=ops, bytes=nbytes, bound_ms=max(ops / PEAK_F32_FLOPS, nbytes / PEAK_HBM_BYTES) * 1e3,
             bound_by="operations" if ops / PEAK_F32_FLOPS >= nbytes / PEAK_HBM_BYTES else "bytes")
    d["share_of_bound"] = d["bound_ms"] / d["ms"]
    return d


def _split_ms(stages, reps: int) -> dict:
    """Mean ms of each (name, fn) stage, run in turn `reps` times, each handed
    the previous one's result: CUDA events around the stages that queue device
    work, the host clock around "host_postprocess"; the card is idle at the
    start of every stage."""
    import torch

    totals = {name: 0.0 for name, _ in stages}
    for _ in range(reps):
        value = None
        for name, fn in stages:
            torch.cuda.synchronize()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            start.record()
            value = fn(value)
            end.record()
            torch.cuda.synchronize()
            totals[name] += (time.perf_counter() - t0) * 1e3 if name == "host_postprocess" else start.elapsed_time(end)
    return {name: t / reps for name, t in totals.items()}


def phase_predict():
    """YOLO(ckpt).predict on .npy captures and on uint8 arrays, on the card."""
    import tempfile

    import numpy as np
    import torch

    from spectrogram_yolov11_torch import YOLO
    from spectrogram_yolov11_torch.data.augment import letterbox_batch
    from spectrogram_yolov11_torch.data.loaders import iq_frame
    from spectrogram_yolov11_torch.data.synth import synth_iq
    from spectrogram_yolov11_torch.ops.decode import decode_detections
    from spectrogram_yolov11_torch.ops.fused_conv import fused_bottleneck
    from spectrogram_yolov11_torch.ops.nms import nms_candidates
    from spectrogram_yolov11_torch.ops.nms_kernel import greedy_keep

    model = YOLO(CKPT)  # predict runs on the card by default
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    nb = PREDICT_BATCH
    iq = np.stack([synth_iq(rng, IQ_SAMPLES)[0] for _ in range(nb)])
    arrays = _mixed_arrays(nb, seed=100)
    launches = {"fused_bottleneck": 0, "greedy_keep": 0}

    def counted(fn):
        fused_bottleneck.launches = greedy_keep.launches = 0
        out = fn()
        torch.cuda.synchronize()
        got = (fused_bottleneck.launches, greedy_keep.launches)
        launches["fused_bottleneck"] += got[0]
        launches["greedy_keep"] += got[1]
        require(got == (6, 1), f"predict launched fused_bottleneck {got[0]} and greedy_keep {got[1]} times in one "
                               "batch, expected 6 and 1")
        return out

    with tempfile.TemporaryDirectory() as tmp:
        paths = [str(Path(tmp) / f"capture{i}.npy") for i in range(4)]
        for p, capture in zip(paths, iq):
            np.save(p, capture)
        # the first call also keeps what it hands the kernels: the first bottleneck
        # of layers 6 and 8 its input, the NMS its (1, 1024) candidates (from the
        # Detect head's output, decoded and ranked as the device function does)
        net = model.model
        seen = {}

        def keep_feats(mod, args, out):
            seen["feats"] = out

        firsts = first_bottlenecks(net)
        hooks = [m.register_forward_pre_hook(keep_nhwc_input(seen)) for m in firsts.values()]
        hooks.append(net.model[-1].register_forward_hook(keep_feats))
        hooks.append(net.register_forward_pre_hook(lambda mod, args: seen.setdefault("x", args[0])))
        captures = [counted(lambda: model.predict(paths[0]))[0]]
        for h in hooks:
            h.remove()
        captures += [counted(lambda: model.predict(p))[0] for p in paths[1:]]
        with torch.inference_mode():
            b1_bottleneck = {f"layer{layer}": bottleneck_check(f"layer{layer} at B = 1", layer_case(mod, seen[mod]))
                             for layer, mod in firsts.items()}
            require([d["shape"] for d in b1_bottleneck.values()] == [[1, 40, 40, 32], [1, 20, 20, 64]],
                    f"unexpected B = 1 bottleneck shapes {[d['shape'] for d in b1_bottleneck.values()]}")
            preds = decode_detections(seen["feats"], net.nc, net.stride)
            _, _, _, valid1, offset1 = nms_candidates(preds, model.predictor.args.conf, net.nc, pre_nms_topk=1024)
            require(valid1.shape == (1, 1024), f"B = 1 predict candidates {tuple(valid1.shape)}, expected (1, 1024)")
            nms_b1 = nms_check(offset1, valid1)
        require(all(r.boxes.data.shape[1] == 6 and np.isfinite(r.boxes.data).all() for r in captures)
                and all(r.orig_img.shape == (640, 640, 3) for r in captures), "capture results malformed")
        require(sum(map(len, captures)) > 0, "no detections on 4 seeded captures")

        cpu = YOLO(CKPT, device="cpu")
        cpu_vs_gpu = []
        for p, g in zip(paths[:2], captures[:2]):
            c = cpu.predict(p)[0]
            require(len(c) == len(g) and np.array_equal(c.boxes.cls, g.boxes.cls),
                    f"CPU and GPU predict disagree on {p}: {c.boxes.cls.tolist()} vs {g.boxes.cls.tolist()}")
            err = float(np.abs(c.boxes.xyxy - g.boxes.xyxy).max(initial=0.0))
            require(err <= 1e-2, f"CPU and GPU predict boxes differ by {err} px")
            cpu_vs_gpu.append(dict(n=len(g), classes=g.boxes.cls.tolist(), max_box_err_px=err,
                                   frame_pixels_differing=int((c.orig_img != g.orig_img).sum())))

        batch32 = counted(lambda: model.predict(arrays, batch=nb))
        require(len(batch32) == nb and all(r.orig_shape == a.shape[:2] for r, a in zip(batch32, arrays))
                and all(np.isfinite(r.boxes.data).all() for r in batch32), "array results malformed")
        lb_gpu = letterbox_batch(arrays, 640, dev)
        require(torch.equal(lb_gpu.cpu(), letterbox_batch(arrays, 640, torch.device("cpu"))),
                "the letterbox on the card differs from the CPU's")

        # times: whole predict calls, host clock
        def per_call_ms(fn, reps):
            fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            return (time.perf_counter() - t0) * 1e3 / reps

        predict_capture_ms = per_call_ms(lambda: [model.predict(p) for p in paths], 5) / len(paths)
        predict_array_ms = per_call_ms(lambda: model.predict(arrays, batch=nb), 5) / nb

    # the stages, composed from the ported functions as the predictor runs them
    predictor = model.predictor
    dev_fn = predictor._device_fn
    x1 = torch.from_numpy(np.stack([iq[0].real, iq[0].imag], -1)).to(dev)
    x32 = torch.from_numpy(np.stack([iq.real, iq.imag], -1)).to(dev)

    def host_post(out_nv, frames):
        out, nv = out_nv
        return predictor.postprocess(out.cpu().numpy(), nv.cpu().numpy(), frames, ["x"] * len(frames), {})

    def stages(x):
        return [("iq_to_frame", lambda _: iq_frame(x)),
                ("letterbox", lambda f: (list(f), letterbox_batch(list(f), 640, dev))),
                ("device_fn", lambda fl: (fl[0], dev_fn(fl[1]))),
                ("host_postprocess", lambda fo: host_post(fo[1], fo[0]))]

    split_capture = _split_ms(stages(x1[None]), reps=10)
    split_iq32 = {k: v / nb for k, v in _split_ms(stages(x32), reps=5).items()}
    arr_stages = [("letterbox", lambda _: letterbox_batch(arrays, 640, dev)),
                  ("device_fn", lambda b: dev_fn(b)),
                  ("host_postprocess", lambda o: host_post(o, arrays))]
    split_arrays = {k: v / nb for k, v in _split_ms(arr_stages, reps=5).items()}
    # the device function back to back (the queue stays full), as the pipeline is timed
    frames1, lb32 = letterbox_batch(list(iq_frame(x1[None])), 640, dev), letterbox_batch(arrays, 640, dev)
    device_fn_back_to_back = {"capture_b1_ms": cuda_ms(lambda: dev_fn(frames1), iters=20),
                              "arrays_batch32_ms_per_image": cuda_ms(lambda: dev_fn(lb32), iters=20) / nb}

    # what the f32 policy holds off: the first capture's forward with TF32 on for cuDNN and matmul
    with torch.inference_mode():
        saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
        try:
            tf32_feats = type(net).forward.__wrapped__(net, seen["x"])
        finally:
            torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved
    tf32_err = max(float((a - b).abs().max()) for lv, lt in zip(seen["feats"], tf32_feats) for a, b in zip(lv, lt))

    # greedy keep at predict's k = 1024 on the trained model's candidates (the 32 IQ frames)
    frames32 = letterbox_batch(list(iq_frame(x32)), 640, dev)
    with torch.inference_mode():
        rgb = frames32.expand(-1, -1, -1, 3).flip(-1).float() / 255.0
        preds = decode_detections(model.model(rgb.permute(0, 3, 1, 2)), model.model.nc, model.model.stride)
    _, _, _, valid, offset_boxes = nms_candidates(preds, 0.25, model.model.nc, pre_nms_topk=1024)
    require(valid.shape == (nb, 1024), f"predict candidates {tuple(valid.shape)}, expected ({nb}, 1024)")
    nms_k1024 = nms_check(offset_boxes, valid)

    emit("predict", launches=launches, detections_per_capture=[len(r) for r in captures],
         detections_arrays_batch32=sum(map(len, batch32)), cpu_vs_gpu=cpu_vs_gpu,
         predict_ms_per_capture_b1=predict_capture_ms, predict_ms_per_image_batch32=predict_array_ms,
         split_ms_per_capture_b1=split_capture, split_ms_per_image_iq_batch32=split_iq32,
         split_ms_per_image_arrays_batch32=split_arrays, device_fn_back_to_back=device_fn_back_to_back,
         greedy_keep_k1024=nms_k1024,
         b1_kernel_checks={"fused_bottleneck": {k: {n: v for n, v in d.items() if "args" not in n}
                                                for k, d in b1_bottleneck.items()},
                           "greedy_keep": nms_b1},
         tf32_on_head_max_abs_diff=tf32_err,
         method="whole predict calls on the host clock after one warm call; stages by CUDA events, each "
                "started on an idle card, host_postprocess (D2H of out and frames, scale_boxes, Results) by "
                "the host clock; device_fn_back_to_back by CUDA events over 20 calls in a row")
    return launches, nms_k1024, b1_bottleneck


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
    predict_launches, nms_k1024, b1_bottleneck = phase_predict()

    fb = [shapes["layer6"], shapes["layer8"]]

    def per_forward(key):
        return sum(d[key] * d["launches_per_forward"] for d in fb)

    fb_ops_bound = TF32_PASSES * per_forward("flops") / PEAK_TF32_FLOPS >= per_forward("bytes") / PEAK_HBM_BYTES
    kernels_line = [
        dict(name="fused_bottleneck", route="cuda", source="spectrogram_yolov11_torch/csrc/fused_bottleneck.cu",
             replaces="spectrogram_yolov11_tpu/ops/pallas_fused_conv.py:67",
             launches=launches["fused_bottleneck"],
             launches_by_path={"pipeline": launches["fused_bottleneck"], "predict": predict_launches["fused_bottleneck"]},
             max_abs_err=max(d["max_abs_err"] for d in (*bottleneck.values(), *b1_bottleneck.values())),
             ms=per_forward("ms"), plain_ms=per_forward("plain_ms"), bound_ms=per_forward("bound_ms"),
             bound_by="operations" if fb_ops_bound else "bytes", library_ms=per_forward("library_ms"),
             bound_f32_cuda_cores_ms=per_forward("bound_f32_cuda_cores_ms"),
             design="implicit GEMM, 3xTF32 wgmma (A in registers), TMA weight ring, persistent grid",
             note="times are per forward at B=32: 2 launches at 32x40x40x32 + 4 at 32x20x20x64; "
                  "bound_ms is 3xTF32 on the tensor cores"),
        dict(name="greedy_keep", route="cuda", source="spectrogram_yolov11_torch/csrc/greedy_nms.cu",
             replaces="spectrogram_yolov11_tpu/ops/pallas_nms.py:70",
             launches=launches["greedy_keep"],
             launches_by_path={"pipeline": launches["greedy_keep"], "predict": predict_launches["greedy_keep"]},
             max_abs_err=0.0,
             ms=nms["ms"], plain_ms=nms["plain_ms"], bound_ms=nms["bound_ms"], bound_by=nms["bound_by"],
             library_ms=None, design="IoU bitmask of valid rows + one-warp scan from survivor to survivor",
             scan_steps_mean=nms["scan_steps_mean"],
             predict_k1024={k: nms_k1024[k] for k in ("shape", "ms", "plain_ms", "bound_ms", "bound_by",
                                                      "scan_steps_mean", "mismatches")},
             note="one launch per pipeline or predict batch; times at B=32, k=512 on the trained model's "
                  "candidates (predict_k1024: predict's k on the 32 IQ captures' candidates)"),
    ]
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels_line}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
