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
  8. half      the bf16 path (half=True): build_pipeline(ckpt, half=True); the
               bf16 kernel against its plain version on the inputs that
               pipeline hands the first bottleneck of layers 6 and 8 at B = 32,
               and at 32x40x40x128 on seeded weights; the bf16 pipeline at
               B = 1, 8, 32 with the counts set to 0 just before and read just
               after (6 bf16 bottleneck and 1 NMS launches per call, no f32
               bottleneck launch); times: each bf16 pipeline beside the f32 one
               in turns, the kernel in turns with the cuDNN bf16 chain, its
               plain version and its bound, and the profile at B = 32; then
               YOLO(ckpt).predict(..., half=True) on the 4 captures at B = 1 and
               the 32 arrays at batch 32, counted the same way, timed and split
               by stage; the kernel at predict's B = 1 shapes; and on 2
               captures the card's bf16 against the CPU's bf16 and the card's
               f32 (decoded predictions of every anchor, and the detections)
  9. val       the port's generator writes the spectrogram_synth val split (32
               PNG at 640 px, the packaged YAML's settings) into a temporary
               directory; YOLO(ckpt).val(data=..., batch=32) on the card in f32
               and with half=True, each with the counts set to 0 just before and
               read just after (6 + 1 launches per batch; 6 bf16 + 1 with
               half=True), P, R, mAP50 and mAP50-95 of each; the card's f32
               results_dict against the CPU's on the first 4 images (within
               1e-4); the bf16 mAP50-95 beside the CPU's bf16 and the card's
               bf16 with the plain bottleneck, and the card's f32, bf16 and
               bf16 with the plain bottleneck on 256 images; the keep kernel
               against its plain version on the first batch's (32, 2048)
               multi-label candidates, with the valid candidates, kept boxes
               (scan steps) per image, its time, device time and bound; the val
               call's time per image, split into host read and decode,
               letterbox and H2D, device function and host stats
Then the total time, the `kernels` line and, last, {"ok": true, "device":
{...}}. It exits non-zero, with no result line, when there is no card or the
port is missing.
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
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12
TF32_PASSES = 3  # the bottleneck runs 3xTF32: three tensor-core products per f32 product
IOU_OPS = 14  # 4 min/max, 4 sub, 2 clamp, 1 mul, 2 add/sub, 1 div; the areas are per box
BATCHES = (1, 8, 32)
IQ_SAMPLES = 256 + 128 * 639  # one capture of 640 STFT frames at the IQ loader's n_fft 256, hop 128
ARRAY_SHAPES = ((360, 640, 1), (720, 1280, 3), (500, 333, 3))
PREDICT_BATCH = 32
VAL_BATCH = 32
VAL_TOL = 1e-4  # the card's results_dict against the CPU's, per key


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
    pack, b2), in x's dtype: f32 at 1e-4 abs/rel; bf16 with every element
    within max|ref| * 2^-7 (two bf16 steps of the largest magnitude) and at
    most 1 % of them unequal (a sum in another order flips the rounding of a
    few intermediates)."""
    import torch

    from spectrogram_yolov11_torch.ops.fused_conv import (
        bottleneck_reference,
        bottleneck_reference_bf16,
        fused_bottleneck,
        unpack_bottleneck_weights,
        unpack_bottleneck_weights_bf16,
    )

    x, p1, b1, p2, b2 = args
    bf16 = x.dtype == torch.bfloat16
    unpack, plain = ((unpack_bottleneck_weights_bf16, bottleneck_reference_bf16) if bf16
                     else (unpack_bottleneck_weights, bottleneck_reference))
    plain_args = (x, unpack(p1), b1, unpack(p2), b2)
    got, ref = fused_bottleneck(*args), plain(*plain_args)
    torch.cuda.synchronize()
    ok = got.dtype == x.dtype
    got, ref = got.float(), ref.float()
    err = (got - ref).abs()
    d = dict(shape=list(x.shape), max_abs_err=float(err.max()))
    if bf16:
        d.update(tolerance=float(ref.abs().max()) * 2.0**-7, unequal_share=float((err > 0).double().mean()))
        ok = ok and d["max_abs_err"] <= d["tolerance"] and d["unequal_share"] <= 0.01
    else:
        d["max_rel_err"] = float((err / ref.abs().clamp_min(1e-3)).max())
        ok = ok and bool((err <= 1e-4 + 1e-4 * ref.abs()).all())
    require(ok, f"fused bottleneck {name} ({x.dtype}) disagrees with its plain version: {d}")
    return dict(d, ok=ok, args=args, plain_args=plain_args)


def bottleneck_times(name: str, d: dict) -> dict:
    """The fused bottleneck (its form for x's dtype) on a check's inputs, in
    turns with the cuDNN chain in the same dtype (conv + bias + SiLU twice,
    + x, on the channels_last view the network holds); its plain version; and
    its bound: 3xTF32 (f32) or bf16 on the tensor cores, against each input
    read and each output written once."""
    import torch
    import torch.nn.functional as F

    from spectrogram_yolov11_torch.ops.fused_conv import (
        bottleneck_reference,
        bottleneck_reference_bf16,
        fused_bottleneck,
    )
    from spectrogram_yolov11_torch.utils import full_f32

    x, w1, b1, w2, b2 = d["plain_args"]
    bf16 = x.dtype == torch.bfloat16
    bsz, h, w, c = x.shape
    xc = x.permute(0, 3, 1, 2)  # channels_last NCHW view, as the network holds it
    w1o, w2o = w1.permute(3, 2, 0, 1).contiguous(), w2.permute(3, 2, 0, 1).contiguous()
    b1c, b2c = b1.to(x.dtype), b2.to(x.dtype)  # cuDNN takes the bias in x's dtype

    @full_f32()
    def cudnn_chain():
        y = F.silu(F.conv2d(xc, w1o, b1c, padding=1))
        return F.silu(F.conv2d(y, w2o, b2c, padding=1)) + xc

    def kernel():
        return fused_bottleneck(*d["args"])

    plain = bottleneck_reference_bf16 if bf16 else bottleneck_reference
    # the kernel and cuDNN in turns (cuDNN's algorithm choice varies between calls)
    turns = [cuda_ms(f, iters=50) for f in (kernel, cudnn_chain, cudnn_chain, kernel)]
    flops = 2 * 2 * 9 * bsz * h * w * c * c
    nbytes = x.element_size() * (2 * x.numel() + w1.numel() + w2.numel()) + 4 * (b1.numel() + b2.numel())
    tc_s = flops / PEAK_BF16_FLOPS if bf16 else TF32_PASSES * flops / PEAK_TF32_FLOPS
    bytes_s = nbytes / PEAK_HBM_BYTES
    ms = (turns[0] + turns[3]) / 2
    out = dict(shape=[bsz, h, w, c], launches_per_forward={"layer6": 2, "layer8": 4, "c128": 0}[name],
               ms=ms, library_ms=(turns[1] + turns[2]) / 2, turns_kernel_lib_lib_kernel=turns,
               plain_ms=cuda_ms(lambda: plain(*d["plain_args"]), iters=50), flops=flops, bytes=nbytes,
               bound_ms=max(tc_s, bytes_s) * 1e3,
               bound_by=f"operations, {'bf16' if bf16 else '3xTF32'} on the tensor cores" if tc_s >= bytes_s else "bytes")
    out["share_of_bound"] = out["bound_ms"] / ms
    if not bf16:  # f32 could run on the CUDA cores too
        f32_s = max(flops / PEAK_F32_FLOPS, bytes_s)
        out.update(bound_f32_cuda_cores_ms=f32_s * 1e3, share_of_f32_cuda_core_bound=f32_s * 1e3 / ms)
    if name == "c128":
        out["note"] = "the C3k width of scales s, m and l; not on the main path"
    return out


def layer_case(mod, x):
    """(x, w1 pack, b1, w2 pack, b2) of a folded bottleneck at input x; the
    f32 pack is stored (18, C, C), the bf16 one (9, C, C)."""
    import torch

    c = x.shape[-1]
    w1, w2 = (w.view(2, 9, c, c) if w.dtype == torch.float32 else w for w in (mod.w1, mod.w2))
    return x, w1, mod.b1, w2, mod.b2


def c128_case(dtype):
    """(x, w1 pack, b1, w2 pack, b2) at 32x40x40x128 (the C3k width of scales
    s, m and l) on seeded weights, x and the packs for the kernel of `dtype`."""
    import torch

    from spectrogram_yolov11_torch.ops.fused_conv import pack_bottleneck_weights, pack_bottleneck_weights_bf16

    g = torch.Generator(device="cuda").manual_seed(0)
    x, w1, b1, w2, b2 = (torch.randn(shape, generator=g, device="cuda") * scale for shape, scale in (
        ((32, 40, 40, 128), 1.0), ((3, 3, 128, 128), 0.05), ((128,), 0.1), ((3, 3, 128, 128), 0.05), ((128,), 0.1)))
    pack = pack_bottleneck_weights_bf16 if dtype == torch.bfloat16 else pack_bottleneck_weights
    return x.to(dtype), pack(w1), b1, pack(w2), b2


def phase_kernels(fn, model, frames_dev):
    import numpy as np
    import torch

    from spectrogram_yolov11_torch.ops.decode import decode_detections
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
    cases["c128"] = c128_case(torch.float32)
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
    from spectrogram_yolov11_torch.ops.fused_conv import fused_bottleneck, fused_bottleneck_bf16
    from spectrogram_yolov11_torch.ops.nms_kernel import greedy_keep

    fused_bottleneck.launches = fused_bottleneck_bf16.launches = greedy_keep.launches = 0
    results = {bs: fn(frames_dev[:bs]) for bs in BATCHES}
    torch.cuda.synchronize()
    launches = {"fused_bottleneck": fused_bottleneck.launches, "greedy_keep": greedy_keep.launches}
    require(fused_bottleneck_bf16.launches == 0, "the f32 pipeline launched the bf16 bottleneck kernel")
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
    from spectrogram_yolov11_torch.ops.nms_kernel import greedy_keep

    pipeline = {}
    for bs in BATCHES:
        x = frames_dev[:bs]
        ms = cuda_ms(lambda: fn(x), iters=20)
        pipeline[bs] = {"ms_per_batch": ms, "img_per_s": bs / ms * 1e3}

    shapes = {name: bottleneck_times(name, d) for name, d in bottleneck.items()}
    shapes["layer8"]["note"] = "layers 8 and 25 both run two bottlenecks at this shape"

    bx, vd = nms_trained
    nms = dict(nms_check(bx, vd), launches_per_call=1,
               scan_steps_per_image=greedy_keep(bx, vd, 0.7).sum(1).tolist())  # one scan step per kept box
    emit("times", pipeline=pipeline, fused_bottleneck=shapes, greedy_keep=nms,
         method="CUDA events over repeated calls after 3 warm-up calls; frames already on the card")
    return shapes, nms


def phase_profile(fn, frames_dev, calls: int = 5, name: str = "profile"):
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
    for kname, ms in by_name.items():
        for key in ("fused_bottleneck_kernel", "nms_mask_kernel", "nms_scan_kernel"):
            if key in kname:
                port[key] = port.get(key, 0.0) + ms / calls
    emit(name, batch=BATCHES[-1], calls=calls, kernel_launches=len(kernels), host_ms_under_profiler=host_ms,
         device_kernel_ms_per_call=busy / calls, device_span_ms_per_call=span / calls,
         busy_share=busy / span if span else None, port_kernels_device_ms_per_call=port,
         top_kernels_ms_per_call=[[kname[:90], ms / calls] for kname, ms in top])


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


def launch_counters() -> dict:
    """Every kernel wrapper of the port, by the name the kernels line gives it."""
    from spectrogram_yolov11_torch.ops.fused_conv import fused_bottleneck, fused_bottleneck_bf16
    from spectrogram_yolov11_torch.ops.nms_kernel import greedy_keep

    return {"fused_bottleneck": fused_bottleneck, "fused_bottleneck_bf16": fused_bottleneck_bf16,
            "greedy_keep": greedy_keep}


def run_counted(fn, expect: dict, what: str):
    """fn() with every launch count set to 0 just before and read just after;
    fails unless the counts are `expect`. Returns (fn's result, the counts)."""
    import torch

    counters = launch_counters()
    for c in counters.values():
        c.launches = 0
    out = fn()
    torch.cuda.synchronize()
    got = {k: c.launches for k, c in counters.items()}
    require(got == expect, f"{what} launched {got}, expected {expect}")
    return out, got


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


def predict_inputs():
    """The predict phases' inputs: PREDICT_BATCH seeded IQ captures (complex64)
    and as many seeded mixed-size uint8 arrays."""
    import numpy as np

    from spectrogram_yolov11_torch.data.synth import synth_iq

    rng = np.random.default_rng(0)
    return np.stack([synth_iq(rng, IQ_SAMPLES)[0] for _ in range(PREDICT_BATCH)]), _mixed_arrays(PREDICT_BATCH, seed=100)


def host_ms_per_call(fn, reps: int) -> float:
    """Mean host-clock ms of fn() after one warm call (fn ends in a D2H copy)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) * 1e3 / reps


def predict_stage_times(predictor, iq, arrays):
    """The predictor's stages composed from the ported functions as it runs
    them: ms per capture at B = 1 and per image at batch len(iq) from IQ and
    from the arrays (_split_ms), and its device function back to back (the
    queue stays full, as the pipeline is timed)."""
    import numpy as np
    import torch

    from spectrogram_yolov11_torch.data.augment import letterbox_batch
    from spectrogram_yolov11_torch.data.loaders import iq_frame

    dev, nb = torch.device("cuda"), len(iq)
    dev_fn = predictor._device_fn
    x1 = torch.from_numpy(np.stack([iq[0].real, iq[0].imag], -1)).to(dev)
    xb = torch.from_numpy(np.stack([iq.real, iq.imag], -1)).to(dev)

    def host_post(out_nv, frames):
        out, nv = out_nv
        return predictor.postprocess(out.cpu().numpy(), nv.cpu().numpy(), frames, ["x"] * len(frames), {})

    def stages(x):
        return [("iq_to_frame", lambda _: iq_frame(x)),
                ("letterbox", lambda f: (list(f), letterbox_batch(list(f), 640, dev))),
                ("device_fn", lambda fl: (fl[0], dev_fn(fl[1]))),
                ("host_postprocess", lambda fo: host_post(fo[1], fo[0]))]

    split_capture = _split_ms(stages(x1[None]), reps=10)
    split_iq = {k: v / nb for k, v in _split_ms(stages(xb), reps=5).items()}
    arr_stages = [("letterbox", lambda _: letterbox_batch(arrays, 640, dev)),
                  ("device_fn", lambda b: dev_fn(b)),
                  ("host_postprocess", lambda o: host_post(o, arrays))]
    split_arrays = {k: v / nb for k, v in _split_ms(arr_stages, reps=5).items()}
    frames1, lb = letterbox_batch(list(iq_frame(x1[None])), 640, dev), letterbox_batch(arrays, 640, dev)
    back_to_back = {"capture_b1_ms": cuda_ms(lambda: dev_fn(frames1), iters=20),
                    "arrays_batch32_ms_per_image": cuda_ms(lambda: dev_fn(lb), iters=20) / nb}
    return split_capture, split_iq, split_arrays, back_to_back


def phase_predict():
    """YOLO(ckpt).predict on .npy captures and on uint8 arrays, on the card."""
    import tempfile

    import numpy as np
    import torch

    from spectrogram_yolov11_torch import YOLO
    from spectrogram_yolov11_torch.data.augment import letterbox_batch
    from spectrogram_yolov11_torch.data.loaders import iq_frame
    from spectrogram_yolov11_torch.ops.decode import decode_detections
    from spectrogram_yolov11_torch.ops.nms import nms_candidates

    model = YOLO(CKPT)  # predict runs on the card by default
    dev = torch.device("cuda")
    nb = PREDICT_BATCH
    iq, arrays = predict_inputs()
    launches = {"fused_bottleneck": 0, "greedy_keep": 0}

    def counted(fn):
        out, got = run_counted(fn, {"fused_bottleneck": 6, "fused_bottleneck_bf16": 0, "greedy_keep": 1},
                               "one f32 predict batch")
        launches["fused_bottleneck"] += got["fused_bottleneck"]
        launches["greedy_keep"] += got["greedy_keep"]
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
        predict_capture_ms = host_ms_per_call(lambda: [model.predict(p) for p in paths], 5) / len(paths)
        predict_array_ms = host_ms_per_call(lambda: model.predict(arrays, batch=nb), 5) / nb

    split_capture, split_iq32, split_arrays, device_fn_back_to_back = predict_stage_times(model.predictor, iq, arrays)
    x32 = torch.from_numpy(np.stack([iq.real, iq.imag], -1)).to(dev)

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


def phase_half(fn_f32, frames_dev):
    """The bf16 pipeline (build_pipeline(half=True)) at 640 px: the kernel
    against its plain version on the inputs the pipeline hands it, the launch
    counts of B = 1, 8, 32, then times beside the f32 pipeline and cuDNN."""
    import torch

    from spectrogram_yolov11_torch.engine.pipeline import build_pipeline

    fn, model, _, _ = build_pipeline(CKPT, device="cuda", half=True)
    require(model.dtype == torch.bfloat16, f"build_pipeline(half=True) gave a {model.dtype} model")
    # the inputs the bf16 pipeline hands the first bottleneck of layers 6 and 8, at B = 32
    captured = {}
    firsts = first_bottlenecks(model)
    hooks = [m.register_forward_pre_hook(keep_nhwc_input(captured)) for m in firsts.values()]
    fn(frames_dev)
    for h in hooks:
        h.remove()
    cases = {f"layer{layer}": layer_case(mod, captured[mod]) for layer, mod in firsts.items()}
    cases["c128"] = c128_case(torch.bfloat16)
    checks = {name: bottleneck_check(name, args) for name, args in cases.items()}
    require([checks[n]["shape"] for n in ("layer6", "layer8", "c128")]
            == [[32, 40, 40, 32], [32, 20, 20, 64], [32, 40, 40, 128]],
            f"unexpected bf16 bottleneck shapes {[c['shape'] for c in checks.values()]}")

    # the main path: the bf16 pipeline at every batch, counts set to 0 just before
    results, launches = run_counted(lambda: {bs: fn(frames_dev[:bs]) for bs in BATCHES},
                                    {"fused_bottleneck": 0, "fused_bottleneck_bf16": 6 * len(BATCHES),
                                     "greedy_keep": len(BATCHES)}, "the bf16 pipeline")
    out_max, n_max = results[BATCHES[-1]]
    require(out_max.shape == (BATCHES[-1], 300, 6) and out_max.dtype == torch.float32
            and bool(torch.isfinite(out_max).all()), "bf16 pipeline output malformed")
    require(int(n_max.sum()) > 0, f"no bf16 detections on {BATCHES[-1]} seeded frames")
    n_f32 = fn_f32(frames_dev)[1]

    # times: each pipeline beside the f32 one, in turns
    pipeline = {}
    for bs in BATCHES:
        xb = frames_dev[:bs]
        turns = [cuda_ms(lambda f=f: f(xb), iters=10) for f in (fn_f32, fn, fn, fn_f32)]
        bf16_ms, f32_ms = (turns[1] + turns[2]) / 2, (turns[0] + turns[3]) / 2
        pipeline[bs] = {"bf16_ms_per_batch": bf16_ms, "f32_ms_per_batch": f32_ms, "bf16_img_per_s": bs / bf16_ms * 1e3,
                        "turns_f32_bf16_bf16_f32": turns}

    shapes = {name: bottleneck_times(name, d) for name, d in checks.items()}
    emit("half", launches=launches, detections_per_image_b32=n_max.tolist(), f32_detections_per_image_b32=n_f32.tolist(),
         kernel_checks={k: {n: v for n, v in d.items() if "args" not in n} for k, d in checks.items()},
         pipeline=pipeline, fused_bottleneck_bf16=shapes,
         method="CUDA events over repeated calls after 3 warm-up calls; the pipelines and the kernel against cuDNN "
                "in turns (f32, bf16, bf16, f32 and kernel, cuDNN, cuDNN, kernel); bound: bf16 at 989 TFLOP/s "
                "against each input read and each output written once at 3.35 TB/s")
    phase_profile(fn, frames_dev, name="profile_half")
    return launches, checks, shapes


def phase_predict_half():
    """YOLO(ckpt).predict(..., half=True) on the predict phase's captures and
    arrays: launch counts, the kernel at B = 1, times and the stage split, and
    on 2 captures the card's bf16 against the CPU's bf16 and the card's f32."""
    import tempfile

    import numpy as np
    import torch

    from spectrogram_yolov11_torch import YOLO
    from spectrogram_yolov11_torch.data.augment import letterbox_batch
    from spectrogram_yolov11_torch.data.loaders import iq_frame
    from spectrogram_yolov11_torch.ops.decode import decode_detections

    yolo, yolo_f32, cpu = YOLO(CKPT), YOLO(CKPT), YOLO(CKPT, device="cpu")
    dev, nb = torch.device("cuda"), PREDICT_BATCH
    iq, arrays = predict_inputs()
    launches = {"fused_bottleneck_bf16": 0, "greedy_keep": 0}

    def counted(fn):
        out, got = run_counted(fn, {"fused_bottleneck": 0, "fused_bottleneck_bf16": 6, "greedy_keep": 1},
                               "one bf16 predict batch")
        launches["fused_bottleneck_bf16"] += got["fused_bottleneck_bf16"]
        launches["greedy_keep"] += got["greedy_keep"]
        return out

    def decoded(net, frames):
        with torch.inference_mode():
            rgb = frames.expand(-1, -1, -1, 3).flip(-1).float() / 255.0
            return decode_detections(net(rgb.permute(0, 3, 1, 2)), net.nc, net.stride)

    with tempfile.TemporaryDirectory() as tmp:
        paths = [str(Path(tmp) / f"capture{i}.npy") for i in range(4)]
        for p, capture in zip(paths, iq):
            np.save(p, capture)
        captures = [counted(lambda p=p: yolo.predict(p, half=True))[0] for p in paths]
        net = yolo.predictor.model
        require(net.dtype == torch.bfloat16 and yolo.model.dtype == torch.float32,
                "predict(half=True) did not run a bf16 copy of the model")
        require(all(r.boxes.data.dtype == np.float32 and np.isfinite(r.boxes.data).all() for r in captures)
                and sum(map(len, captures)) > 0, "bf16 capture results malformed or empty")
        # the kernel at predict's B = 1 shapes, on the inputs the first capture's call hands it
        seen = {}
        firsts = first_bottlenecks(net)
        hooks = [m.register_forward_pre_hook(keep_nhwc_input(seen)) for m in firsts.values()]
        counted(lambda: yolo.predict(paths[0], half=True))
        for h in hooks:
            h.remove()
        with torch.inference_mode():
            b1_checks = {f"layer{layer}": bottleneck_check(f"layer{layer} at B = 1", layer_case(mod, seen[mod]))
                         for layer, mod in firsts.items()}
        require([d["shape"] for d in b1_checks.values()] == [[1, 40, 40, 32], [1, 20, 20, 64]],
                f"unexpected B = 1 bf16 bottleneck shapes {[d['shape'] for d in b1_checks.values()]}")

        # 2 captures: the card's bf16 against the CPU's bf16 and the card's f32, over every anchor
        # (decoded predictions) and in the detections
        compare = []
        for p, x in zip(paths[:2], iq[:2]):
            frame = letterbox_batch(list(iq_frame(torch.from_numpy(np.stack([x.real, x.imag], -1))[None].to(dev))),
                                    640, dev)
            g, c, f = yolo.predict(p, half=True)[0], cpu.predict(p, half=True)[0], yolo_f32.predict(p)[0]
            pg = decoded(net, frame).cpu()
            pc = decoded(cpu.predictor.model, frame.cpu())
            pf = decoded(yolo_f32.predictor.model, frame).cpu()
            d_cpu = {k: float((pg[..., s] - pc[..., s]).abs().max()) for k, s in (("box_px", slice(0, 4)), ("score", slice(4, None)))}
            d_f32 = {k: float((pg[..., s] - pf[..., s]).abs().max()) for k, s in (("box_px", slice(0, 4)), ("score", slice(4, None)))}
            margin = float((pc[..., 4:].max(-1).values - 0.25).abs().min())
            require(all(d_cpu[k] <= 2 * d_f32[k] for k in d_cpu),
                    f"the card's bf16 lies {d_cpu} from the CPU's, more than twice its distance {d_f32} from the card's f32")
            if margin >= 3e-2:
                require(len(g) == len(c) and np.array_equal(g.boxes.cls, c.boxes.cls),
                        f"the card's and the CPU's bf16 predict disagree on {p}: {g.boxes.cls.tolist()} vs {c.boxes.cls.tolist()}")
            compare.append(dict(n_card_bf16=len(g), n_cpu_bf16=len(c), n_card_f32=len(f),
                                classes_card_bf16=g.boxes.cls.tolist(), classes_cpu_bf16=c.boxes.cls.tolist(),
                                classes_card_f32=f.boxes.cls.tolist(), best_score_margin_to_conf=margin,
                                counts_required_equal=margin >= 3e-2, max_diff_to_cpu_bf16=d_cpu,
                                max_diff_to_card_f32=d_f32))

        batch32 = counted(lambda: yolo.predict(arrays, batch=nb, half=True))
        require(len(batch32) == nb and all(r.orig_shape == a.shape[:2] for r, a in zip(batch32, arrays))
                and all(np.isfinite(r.boxes.data).all() for r in batch32), "bf16 array results malformed")
        predict_capture_ms = host_ms_per_call(lambda: [yolo.predict(p, half=True) for p in paths], 5) / len(paths)
        predict_array_ms = host_ms_per_call(lambda: yolo.predict(arrays, batch=nb, half=True), 5) / nb

    split_capture, split_iq32, split_arrays, back_to_back = predict_stage_times(yolo.predictor, iq, arrays)
    emit("predict_half", launches=launches, detections_per_capture=[len(r) for r in captures],
         detections_arrays_batch32=sum(map(len, batch32)), card_bf16_vs_cpu_bf16_and_card_f32=compare,
         predict_ms_per_capture_b1=predict_capture_ms, predict_ms_per_image_batch32=predict_array_ms,
         split_ms_per_capture_b1=split_capture, split_ms_per_image_iq_batch32=split_iq32,
         split_ms_per_image_arrays_batch32=split_arrays, device_fn_back_to_back=back_to_back,
         b1_kernel_checks={k: {n: v for n, v in d.items() if "args" not in n} for k, d in b1_checks.items()},
         method="as the predict phase; the card's bf16 held within twice its distance from the card's f32 of the "
                "CPU's bf16 (decoded predictions of every anchor), detections equal where every best score is "
                "3e-2 or more from conf")
    return launches, b1_checks


def nms_device_ms(bx, vd, calls: int = 10) -> dict:
    """Device ms of one greedy keep call, its mask and scan kernels apart, by torch.profiler over `calls` calls."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from spectrogram_yolov11_torch.ops.nms_kernel import greedy_keep

    greedy_keep(bx, vd, 0.7)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            greedy_keep(bx, vd, 0.7)
        torch.cuda.synchronize()
    ms = {"mask": 0.0, "scan": 0.0}
    for e in prof.events():
        for part in ms:
            if e.device_type == torch.autograd.DeviceType.CUDA and f"nms_{part}_kernel" in e.name:
                ms[part] += e.time_range.elapsed_us() / 1e3 / calls
    return dict(ms, total=ms["mask"] + ms["scan"])


def phase_val():
    """YOLO(ckpt).val on the card on the spectrogram_synth val split: counted
    f32 and bf16 runs, the CPU on 4 images, the keep kernel at (32, 2048) on
    the first batch's candidates, and the time per image by stage."""
    import tempfile

    import torch

    import spectrogram_yolov11_torch.nn.modules.block as block
    from spectrogram_yolov11_torch import YOLO
    from spectrogram_yolov11_torch.data.augment import letterbox_batch
    from spectrogram_yolov11_torch.data.dataset import YOLODataset, check_det_dataset, find_dataset_yaml
    from spectrogram_yolov11_torch.ops.decode import decode_detections
    from spectrogram_yolov11_torch.ops.fused_conv import bottleneck_reference_bf16, unpack_bottleneck_weights_bf16
    from spectrogram_yolov11_torch.ops.nms import nms_candidates
    from spectrogram_yolov11_torch.ops.nms_kernel import greedy_keep
    from spectrogram_yolov11_torch.utils import yaml_load

    yolo, dev = YOLO(CKPT), torch.device("cuda")
    with tempfile.TemporaryDirectory() as tmp:
        # the packaged dataset's val split (its train split is not needed here)
        t0 = time.perf_counter()
        data = check_det_dataset(dict(yaml_load(find_dataset_yaml("spectrogram_synth.yaml")), path=tmp, n_train=0))
        generate_s = time.perf_counter() - t0
        ds = YOLODataset(data["val"], imgsz=640)
        require(len(ds) == VAL_BATCH, f"the val split has {len(ds)} images, expected {VAL_BATCH}")

        # the main path: one batch of 32 in f32, then with half=True, counts set to 0 just before each
        results, launches, speed = {}, {}, {}
        for name, half, expect in (("f32", False, {"fused_bottleneck": 6, "fused_bottleneck_bf16": 0, "greedy_keep": 1}),
                                   ("bf16", True, {"fused_bottleneck": 0, "fused_bottleneck_bf16": 6, "greedy_keep": 1})):
            results[name], launches[name] = run_counted(lambda h=half: yolo.val(data=data, batch=VAL_BATCH, half=h),
                                                        expect, f"{name} val of one batch of {VAL_BATCH}")
            speed[name] = dict(yolo.validator.speed)
            require(list(results[name]) == ["metrics/precision(B)", "metrics/recall(B)", "metrics/mAP50(B)",
                                            "metrics/mAP50-95(B)", "fitness"]
                    and all(0.0 <= v <= 1.0 for v in results[name].values()), f"{name} val results malformed")
        require(results["f32"]["metrics/mAP50-95(B)"] > 0.5, f"f32 mAP50-95 {results['f32']} on the trained model")
        require(yolo.model.dtype == torch.float32, "val(half=True) changed the caller's f32 model")

        # the card's f32 against the CPU's on the first 4 images
        (Path(tmp) / "val4.txt").write_text("\n".join(ds.im_files[:4]))
        sub = dict(data, val=str(Path(tmp) / "val4.txt"))
        card4, cpu4 = yolo.val(data=sub, batch=4), YOLO(CKPT, device="cpu").val(data=sub, batch=4)
        diff4 = {k: abs(card4[k] - cpu4[k]) for k in card4}
        require(max(diff4.values()) <= VAL_TOL, f"the card's val on 4 images lies {diff4} from the CPU's")

        # where the card's bf16 mAP50-95 stands: beside the CPU's bf16 on the same 32 images and the card's bf16
        # with the plain bf16 bottleneck in the kernel's place (the module's name patched for those calls); then
        # f32, bf16 and bf16 with the plain bottleneck on 256 images of the same settings (the first 32 are the
        # split above), where a near-tie in one image weighs less
        key = "metrics/mAP50-95(B)"

        def plain_bottleneck_map(d) -> float:
            kernel = block.fused_bottleneck
            block.fused_bottleneck = lambda x, w1, b1, w2, b2: bottleneck_reference_bf16(
                x, unpack_bottleneck_weights_bf16(w1), b1, unpack_bottleneck_weights_bf16(w2), b2)
            try:
                return yolo.val(data=d, batch=VAL_BATCH, half=True)[key]
            finally:
                block.fused_bottleneck = kernel

        bf16_readings = {"card": results["bf16"][key], "card_plain_bottleneck": plain_bottleneck_map(data),
                         "cpu": YOLO(CKPT, device="cpu").val(data=data, batch=VAL_BATCH, half=True)[key]}
        wide = check_det_dataset(dict(data, path=Path(tmp) / "n256", train="images/train", val="images/val",
                                      n_val=8 * VAL_BATCH))
        map_256 = {"f32": yolo.val(data=wide, batch=VAL_BATCH)[key],
                   "bf16": yolo.val(data=wide, batch=VAL_BATCH, half=True)[key],
                   "bf16_plain_bottleneck": plain_bottleneck_map(wide)}

        # the keep kernel at (32, 2048) on the first batch's multi-label candidates
        with torch.inference_mode():
            frames = letterbox_batch([ds.load_image(i) for i in range(VAL_BATCH)], 640, dev, scaleup=False)
            rgb = frames.expand(-1, -1, -1, 3).flip(-1).float() / 255.0
            preds = decode_detections(yolo.model(rgb.permute(0, 3, 1, 2)), yolo.model.nc, yolo.model.stride)
            _, _, _, valid, offset_boxes = nms_candidates(preds, 0.001, yolo.model.nc, multi_label=True,
                                                          pre_nms_topk=2048)
            require(valid.shape == (VAL_BATCH, 2048), f"val candidates {tuple(valid.shape)}, expected ({VAL_BATCH}, 2048)")
            nms = nms_check(offset_boxes, valid)
            kept = greedy_keep(offset_boxes, valid, 0.7).sum(1).tolist()  # one scan step per kept box
            nms.update(valid_per_image=valid.sum(1).tolist(), kept_per_image=kept, scan_steps_per_image=kept,
                       device_ms_by_kernel=nms_device_ms(offset_boxes, valid))
            nms["device_ms"] = nms["device_ms_by_kernel"]["total"]

        # times: whole val calls (host clock) and the stages; host read and decode timed serially per image
        t0 = time.perf_counter()
        for i in range(len(ds)):
            ds.get_item(i)
        read_decode_ms = (time.perf_counter() - t0) * 1e3 / len(ds)
        times = {}
        for name, half in (("f32", False), ("bf16", True), ("bf16", True), ("f32", False)):
            t0 = time.perf_counter()
            yolo.val(data=data, batch=VAL_BATCH, half=half)
            times.setdefault(name, []).append({"val_call_ms_per_image": (time.perf_counter() - t0) * 1e3 / len(ds),
                                               **{f"{k}_ms_per_image": v for k, v in yolo.validator.speed.items()}})
    emit("val", images=len(ds), generate_s=generate_s, results=results, launches=launches,
         first_call_speed_ms_per_image=speed, card_vs_cpu_4_images={"card": card4, "cpu": cpu4, "abs_diff": diff4},
         bf16_map50_95=bf16_readings, map50_95_256_images=map_256,
         greedy_keep_k2048=nms, host_read_decode_ms_per_image=read_decode_ms, times_f32_bf16_bf16_f32=times,
         method="whole val calls on the host clock (validator built, loader threads, letterbox, device function, "
                "stats), f32 and bf16 in turns; the validator's stages by the host clock with the card synchronised "
                "after the letterbox (preprocess: letterbox and H2D; inference: device function and D2H; "
                "postprocess: un-letterbox and TP matching); host read and decode: YOLODataset.get_item per image, "
                "serially; the keep kernel as the other phases, and its device time by torch.profiler")
    return launches, nms


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
    t_start = time.perf_counter()

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
    with torch.inference_mode():
        half_launches, half_checks, half_shapes = phase_half(fn, frames_dev)
    predict_half_launches, b1_half = phase_predict_half()
    val_launches, nms_val = phase_val()

    def per_forward(key, shapes=shapes):
        return sum(shapes[n][key] * shapes[n]["launches_per_forward"] for n in ("layer6", "layer8"))

    fb_ops_bound = TF32_PASSES * per_forward("flops") / PEAK_TF32_FLOPS >= per_forward("bytes") / PEAK_HBM_BYTES
    kernels_line = [
        dict(name="fused_bottleneck", route="cuda", source="spectrogram_yolov11_torch/csrc/fused_bottleneck.cu",
             replaces="spectrogram_yolov11_tpu/ops/pallas_fused_conv.py:67",
             launches=launches["fused_bottleneck"],
             launches_by_path={"pipeline": launches["fused_bottleneck"], "predict": predict_launches["fused_bottleneck"],
                               "val": val_launches["f32"]["fused_bottleneck"]},
             max_abs_err=max(d["max_abs_err"] for d in (*bottleneck.values(), *b1_bottleneck.values())),
             ms=per_forward("ms"), plain_ms=per_forward("plain_ms"), bound_ms=per_forward("bound_ms"),
             bound_by="operations" if fb_ops_bound else "bytes", library_ms=per_forward("library_ms"),
             bound_f32_cuda_cores_ms=per_forward("bound_f32_cuda_cores_ms"),
             design="implicit GEMM, 3xTF32 wgmma (A in registers), TMA weight ring, persistent grid",
             note="times are per forward at B=32: 2 launches at 32x40x40x32 + 4 at 32x20x20x64; "
                  "bound_ms is 3xTF32 on the tensor cores"),
        dict(name="fused_bottleneck_bf16", route="cuda", source="spectrogram_yolov11_torch/csrc/fused_bottleneck.cu",
             replaces="spectrogram_yolov11_tpu/ops/pallas_fused_conv.py:67",
             launches=half_launches["fused_bottleneck_bf16"],
             launches_by_path={"pipeline_half": half_launches["fused_bottleneck_bf16"],
                               "predict_half": predict_half_launches["fused_bottleneck_bf16"],
                               "val_half": val_launches["bf16"]["fused_bottleneck_bf16"]},
             max_abs_err=max(d["max_abs_err"] for d in (*half_checks.values(), *b1_half.values())),
             unequal_share_max=max(d["unequal_share"] for d in (*half_checks.values(), *b1_half.values())),
             ms=per_forward("ms", half_shapes), plain_ms=per_forward("plain_ms", half_shapes),
             bound_ms=per_forward("bound_ms", half_shapes),
             bound_by="operations" if per_forward("flops", half_shapes) / PEAK_BF16_FLOPS
             >= per_forward("bytes", half_shapes) / PEAK_HBM_BYTES else "bytes",
             library_ms=per_forward("library_ms", half_shapes),
             design="the f32 kernel's tiles and schedule; bf16 wgmma m64nCk16 (A in registers) summed in its f32 "
                    "accumulator; intermediate and output rounded to bf16 as Pallas",
             note="times are per forward at B=32 of the bf16 pipeline: 2 launches at 32x40x40x32 + 4 at "
                  "32x20x20x64; bound_ms is bf16 on the tensor cores or HBM; library_ms is the cuDNN bf16 chain; "
                  "max_abs_err is in bf16 steps of up to 2^-7 max|ref|"),
        dict(name="greedy_keep", route="cuda", source="spectrogram_yolov11_torch/csrc/greedy_nms.cu",
             replaces="spectrogram_yolov11_tpu/ops/pallas_nms.py:70",
             launches=launches["greedy_keep"],
             launches_by_path={"pipeline": launches["greedy_keep"], "predict": predict_launches["greedy_keep"],
                               "pipeline_half": half_launches["greedy_keep"],
                               "predict_half": predict_half_launches["greedy_keep"],
                               "val": val_launches["f32"]["greedy_keep"], "val_half": val_launches["bf16"]["greedy_keep"]},
             max_abs_err=0.0,
             ms=nms["ms"], plain_ms=nms["plain_ms"], bound_ms=nms["bound_ms"], bound_by=nms["bound_by"],
             library_ms=None, design="IoU bitmask of valid rows + one-warp scan from survivor to survivor",
             scan_steps_mean=nms["scan_steps_mean"],
             predict_k1024={k: nms_k1024[k] for k in ("shape", "ms", "plain_ms", "bound_ms", "bound_by",
                                                      "scan_steps_mean", "mismatches")},
             val_k2048={k: nms_val[k] for k in ("shape", "ms", "device_ms", "plain_ms", "bound_ms", "bound_by",
                                                 "scan_steps_mean", "mismatches")},
             note="one launch per pipeline, predict or val batch; times at B=32, k=512 on the trained model's "
                  "candidates (predict_k1024: predict's k on the 32 IQ captures' candidates; val_k2048: the "
                  "validator's multi-label k on the val split's first batch)"),
    ]
    emit("total", seconds=time.perf_counter() - t_start)
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels_line}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
