#!/usr/bin/env python3
"""Drive the PyTorch port on one CUDA card and hold each kernel against its plain version.

Run from the root of a checkout:  python3 chip_smoke.py

Phases, each printing one JSON line, each fatal when it fails:
  1. card      nvidia-smi name and power limit; torch's TF32 settings, left as
               torch sets them: the port holds its own f32 policy
               (utils.full_f32 around the network's forward, the device
               function and the plain bottleneck)
  2. build     both CUDA kernels built from csrc/ with nvcc and the host
               library (the JPEG decoder's body, the PNG row filters) with the
               host C++ compiler, all at once (build seconds, ptxas report);
               fails on any spill
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
  10. images   JPEG frames: every committed fixture (tests/torch_data/jpeg/:
               the JAX generator's Spectrogram.yaml val split and one
               spectrogram_synth frame, small cv2 encodes of each decoder
               branch) decoded on the host to the SHA-256 and shape of
               cv2.imread's decode recorded beside them; YOLO(ckpt).predict on
               the fixture directory at batch 8 and on a glob of the small
               encodes (batch 1) at 320 px, and YOLO(ckpt).val on the fixture
               split at batch 8 in f32 and with half=True, each with the counts
               set to 0 just before and read just after (6 + 1 launches per
               batch; 6 bf16 + 1 with half=True), predict's counts, classes
               and frames equal to a CPU run's and boxes within 1e-2 px, the
               f32 results_dict within 1e-4 of the CPU's; each kernel against
               its plain version on the inputs the JPEG val handed it (global
               module hooks); decode ms per image (320 px, 640 px, 641 x 359)
               serially and in 8 threads, and predict ms per image from files
               at batch 8, split into read and decode, letterbox, device
               function and host postprocess
  11. serve    the KServe-v2 server (serve.py) on the card: InferenceServer on
               port 0 in f32 and with half=True; health, /v2 and the metadata
               document (its 64 px probe forward counted: 6 launches); 640 px
               letterboxed frames raw (UINT8, 3 channels) at B = 1, 3 (the
               4-bucket) and 32, each against a local AutoBackend(ckpt)
               forward of the same frames (boxes 1e-2 px, scores 1e-4); gray
               (1 channel), BYTES PNG (the port's encoder) and BYTES JPEG (the
               640 px fixture) each equal to the raw path on the pixels the
               server sees; a truncated BYTES payload gets a 400 and the
               server goes on; 32 client threads with one frame each, released
               together, in fewer than 32 dispatches (bottleneck launches / 6),
               each answer within the tolerance of its lone answer; one
               request with TF32 on for the process equal to one with it off;
               YOLO(url).predict(32 mixed-size arrays, batch=32) against
               YOLO(ckpt).predict (classes equal, boxes within 1e-3 px);
               YOLO(url).val on the 32-image synth split against YOLO(ckpt).val,
               f32 and through the bf16 server against val(half=True), per key
               within 1e-6; every call counted from 0 (6 bottleneck and 0 NMS
               launches per dispatch, bf16 on the half server; 1 NMS launch
               per client batch); each kernel on the server's own inputs (the
               first bottleneck of layers 6 and 8 at 640 and 64 px, f32 and
               bf16) and the keep kernel on the remote val's (32, 2048)
               candidates. Readings: requests/s and p50/p99 latency at
               concurrency 1, 8, 32 for raw UINT8 and BYTES JPEG (one 640 px
               frame per request; bf16 raw at 32) with the dispatches, from
               client threads in this process and from a client process of
               its own; a request's split (parse and decode, H2D, device,
               D2H, encode); the card's busy share over a concurrency-32 raw
               run from each
  12. train    the detect training step: the port's generator writes the
               synthetic split (128 train + 32 val PNG at 640 px) into a
               temporary directory; the trained model at 640 px, B = 16,
               amp=False, optimizer auto (AdamW) takes 20 steps
               (DetectionTrainer.train_step, do_step from the warmup ramp) on
               the train images through the val loader (a stand-in with no
               augmentation), counted (no kernel launches: training runs the
               bottlenecks unfused); then validate() of the EMA counted (6 +
               1 launches per val batch, no bf16 launch); each kernel on the
               inputs the first val batch gave it, against its plain version
               (the six bottlenecks at 16x40x40x32 and 16x20x20x64, also
               against BN folded from the EMA's weights now, so a stale fold
               fails; the keep kernel at (16, 2048)); and the card's val of
               the EMA against the CPU's on 4 images (within 1e-4).
               Readings: ms per step by CUDA events; train_step on 6 later
               steps, timed one by one with the split it records (forward,
               assigner + loss, backward, clip + update + EMA); the profile
               of 3 steps (busy share, top kernels,
               launches per step); peak memory; loss items per step; the same
               steps at B = 32 (or why not). Last, one accumulation step and
               one AdamW step at 160 px, B = 4, full width and depth, on the
               card with TF32 turned on for the process and on the CPU from the
               same weights and batch: loss items, grads, first moments,
               params, BN statistics and the EMA within the tolerances of
               tests/test_torch_train_step.py
  13. train_loop  YOLO(ckpt).train(data=<the synthetic split, 128 + 32 PNG at
               640 px>, epochs=3, batch=16, imgsz=640, amp=False,
               close_mosaic=1): the augmenting train loader (mosaic,
               warp, HSV and flips, the image half on the card by
               augment_batch), the epoch loop and each epoch's EMA val,
               counted from 0 around the call (no launch in the steps, 6 + 1
               per val batch) and per epoch by callbacks; augment_batch on the
               card against the CPU on the loader's first batch, and a
               sample's host cost serially; each kernel against its plain
               version on the first val's inputs; YOLO(best.ckpt).val against
               the metrics of the epoch best.ckpt was saved at (within 1e-4);
               a resume from last.ckpt as the first 2 epochs left it (epoch 2,
               the saved optimizer step and EMA updates). Readings: seconds per
               epoch, ms per step with the loader's wait, the wait, the split
               of train_step in epoch 1 (upload and augment among its parts, by
               CUDA events), the busy share over steps 3-5 of epoch 1 (the
               profiler's set-up lands in that epoch's time), val seconds, the
               final EMA's metrics, peak memory
  14. train_amp   bf16 training at amp=True, JAX's default: 20 steps of the
               trained model at 640 px, B = 16 on the val loader's batches
               (as phase train), counted (no launch: the training convs are
               cuDNN's); train_step's split on 6 later steps beside 6 of an
               f32 trainer; the profile of 3 steps of each (launches, device
               ms, busy share); peak memory; B = 32; the card's bf16 step
               against the CPU's at 160 px, B = 4, TF32 on, per quantity
               within 3 times the card's own bf16-to-f32 distance. Then
               YOLO(ckpt).train(epochs=2, batch=16, imgsz=640,
               close_mosaic=1) at the default amp, counted from 0 around the
               call and per epoch (each EMA val runs a bf16 copy of the EMA: 6
               bf16 bottleneck + 1 NMS launches per val batch, no f32
               bottleneck); each kernel against its plain version on the first
               val's inputs; last.ckpt's train_args.amp; the final EMA's bf16
               mAP beside the f32 loop's
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
JPEG_FIXTURES = ROOT / "tests" / "torch_data" / "jpeg"  # JAX-written JPEGs and cv2 encodes, cv2's digests beside them
IMAGES_IMGSZ = 320  # the fixture frames' own size: their scores lie 4e-4 or more from conf and iou there
IMAGES_BATCH = 8
TRAIN_IMGSZ, TRAIN_BATCH, TRAIN_STEPS = 640, 16, 20  # JAX's default imgsz and batch
TRAIN_CHECK, TRAIN_CHECK_BATCH = 160, 4  # the card's step against the CPU's
LOOP_EPOCHS = 3  # YOLO.train's epochs in phase train_loop, the last without mosaic
AMP_EPOCHS = 2  # YOLO.train's epochs at amp=True in phase train_amp, the last without mosaic
AMP_MULTIPLE = 3  # the card's bf16 step within this many times its bf16-to-f32 distance of the CPU's
SERVE_BATCHES = (1, 3, 32)  # raw requests' batches: 3 runs in the 4-bucket
SERVE_CONCURRENCY, SERVE_REQUESTS = (1, 8, 32), (40, 16, 8)  # client threads, and requests each sends back to back
# a served forward against the local one of the same frames at another batch (cuDNN picks its algorithm per
# batch): the port's forward tolerance of the CPU tests (tests/test_torch_pipeline.py)
SERVE_PX_TOL, SERVE_SCORE_TOL = 1e-2, 1e-4
SERVE_VAL_TOL = 1e-6  # remote val against local val on the card, per key: the same pixels through the same network


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
    require(set(secs) == {*kernels.KERNELS, *kernels.HOST_LIBS}, f"not every library was built: {sorted(secs)}")
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
    work, the host clock around the stages named host_*; the card is idle at
    the start of every stage."""
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
            totals[name] += (time.perf_counter() - t0) * 1e3 if name.startswith("host_") else start.elapsed_time(end)
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


def phase_images():
    """JPEG frames: every committed fixture decoded to cv2's recorded digest;
    YOLO(ckpt).predict from the fixture directory at batch 8 and from a glob,
    and YOLO(ckpt).val on the fixture split in f32 and bf16, each counted and
    held to the CPU; each kernel against its plain version on the inputs the
    JPEG val handed it; decode and predict-from-files times."""
    import hashlib
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np
    import torch

    from spectrogram_yolov11_torch import YOLO
    from spectrogram_yolov11_torch.data.augment import letterbox_batch
    from spectrogram_yolov11_torch.data.imageio import imread
    from spectrogram_yolov11_torch.engine.validator import VAL_PRE_NMS_TOPK
    from spectrogram_yolov11_torch.nn.modules.block import Bottleneck
    from spectrogram_yolov11_torch.nn.modules.head import Detect
    from spectrogram_yolov11_torch.ops.decode import decode_detections
    from spectrogram_yolov11_torch.ops.nms import nms_candidates

    # every fixture decodes to the shape and SHA-256 of cv2.imread's decode, recorded beside it
    recorded = json.loads((JPEG_FIXTURES / "cv2_decoded.json").read_text())["files"]
    listed = sorted(str(f.relative_to(JPEG_FIXTURES)) for f in JPEG_FIXTURES.rglob("*.jpg"))
    require(listed == sorted(recorded), f"fixtures {listed} are not those recorded {sorted(recorded)}")
    for name, d in recorded.items():
        img = imread(JPEG_FIXTURES / name)
        digest = hashlib.sha256(img.tobytes()).hexdigest()
        require(list(img.shape) == d["shape"] and digest == d["sha256"],
                f"{name} decodes to {img.shape} {digest}, cv2 to {d['shape']} {d['sha256']}")

    f32, bf16_expect = ({"fused_bottleneck": 6, "fused_bottleneck_bf16": 0, "greedy_keep": 1},
                        {"fused_bottleneck": 0, "fused_bottleneck_bf16": 6, "greedy_keep": 1})
    yolo, cpu = YOLO(CKPT), YOLO(CKPT, device="cpu")
    val_dir = JPEG_FIXTURES / "spectrogram" / "images" / "val"
    val_files = sorted(val_dir.glob("*.jpg"))
    glob_src = str(JPEG_FIXTURES / "*.jpg")  # the small encodes: samplings, restarts, 1 x 1 to 641 x 359, EXIF
    n_glob = len(list(JPEG_FIXTURES.glob("*.jpg")))
    predict_calls = {"directory_batch8": (str(val_dir), IMAGES_BATCH, f32),
                     "glob_batch1": (glob_src, 1, {k: n_glob * v for k, v in f32.items()})}
    predict, launches, cpu_vs_gpu = {}, {}, {}
    for key, (source, batch, expect) in predict_calls.items():
        predict[key], launches[f"predict_{key}"] = run_counted(
            lambda s=source, b=batch: yolo.predict(s, batch=b, imgsz=IMAGES_IMGSZ), expect, f"predict {key}")
        ref = cpu.predict(source, batch=batch, imgsz=IMAGES_IMGSZ)
        require(len(ref) == len(predict[key]) and [r.path for r in ref] == [g.path for g in predict[key]],
                f"predict {key}: the card's and the CPU's results are for other files")
        errs = []
        for g, c in zip(predict[key], ref):
            require(len(c) == len(g) and np.array_equal(c.boxes.cls, g.boxes.cls) and np.array_equal(c.orig_img, g.orig_img),
                    f"predict {key}: CPU and card disagree on {g.path}: {c.boxes.cls.tolist()} vs {g.boxes.cls.tolist()}")
            errs.append(float(np.abs(c.boxes.xyxy - g.boxes.xyxy).max(initial=0.0)))
        require(max(errs) <= 1e-2, f"predict {key}: CPU and card boxes differ by {max(errs)} px")
        cpu_vs_gpu[key] = {"images": len(ref), "detections": sum(map(len, ref)), "max_box_err_px": max(errs)}
    require(cpu_vs_gpu["directory_batch8"]["detections"] > 0, "no detections on the fixture directory")

    # val on the fixture split in f32 and bf16, counted; global hooks keep what each hands the kernels
    data = {"path": str(JPEG_FIXTURES / "spectrogram"), "val": "images/val", "names": {0: "LTE", 1: "RF"}}
    captured = {torch.float32: {}, torch.bfloat16: {}}

    def pre(mod, args):  # returns None: the input stays as it is
        if isinstance(mod, Bottleneck) and mod.fusable and not mod.training and args[0].dtype in captured:
            captured[args[0].dtype].setdefault(mod, args[0].permute(0, 2, 3, 1).contiguous())

    def post(mod, args, out):  # returns None: the output stays as it is
        if isinstance(mod, Detect) and not mod.training and out[0][0].dtype == torch.float32:
            captured[torch.float32].setdefault("feats", out)

    results = {}
    hooks = [torch.nn.modules.module.register_module_forward_pre_hook(pre),
             torch.nn.modules.module.register_module_forward_hook(post)]
    try:
        for name, half, expect in (("f32", False, f32), ("bf16", True, bf16_expect)):
            results[name], launches[f"val_{name}"] = run_counted(
                lambda h=half: yolo.val(data=data, batch=IMAGES_BATCH, half=h), expect, f"{name} val of the JPEG split")
    finally:
        for h in hooks:
            h.remove()
    cpu_val = cpu.val(data=data, batch=IMAGES_BATCH)
    diff = {k: abs(results["f32"][k] - cpu_val[k]) for k in cpu_val}
    require(max(diff.values()) <= VAL_TOL, f"the card's val of the JPEG split lies {diff} from the CPU's")
    require(results["f32"]["metrics/mAP50(B)"] > 0.5, f"f32 val of the JPEG split {results['f32']}")

    checks = {"fused_bottleneck": {}, "fused_bottleneck_bf16": {}}
    with torch.inference_mode():
        for dtype, key in ((torch.float32, "fused_bottleneck"), (torch.bfloat16, "fused_bottleneck_bf16")):
            for i, m in enumerate(m for m in captured[dtype] if m != "feats"):
                d = bottleneck_check(f"JPEG val {i}", layer_case(m, captured[dtype][m]))
                checks[key][f"bottleneck{i}"] = {k: v for k, v in d.items() if "args" not in k}
            shapes = sorted(c["shape"] for c in checks[key].values())
            require(shapes == [[IMAGES_BATCH, 20, 20, 64]] * 4 + [[IMAGES_BATCH, 40, 40, 32]] * 2,
                    f"{key}: JPEG val inputs {shapes}")
        preds = decode_detections(captured[torch.float32]["feats"], yolo.model.nc, yolo.model.stride)
        _, _, _, valid, offset_boxes = nms_candidates(preds, 0.001, yolo.model.nc, multi_label=True,
                                                      pre_nms_topk=VAL_PRE_NMS_TOPK)
        require(valid.shape == (IMAGES_BATCH, VAL_PRE_NMS_TOPK), f"JPEG val candidates {tuple(valid.shape)}")
        nms = nms_check(offset_boxes, valid)

    # readings: decode per image on the host, serially and in the loader's 8 threads; predict from files
    frame640 = JPEG_FIXTURES / "spectrogram_synth" / "images" / "val" / "00000.jpg"
    decode_ms = {}
    for key, files in (("320px", val_files), ("640px", [frame640]), ("641x359", [JPEG_FIXTURES / "641x359.jpg"])):
        reps = max(1, 64 // len(files))
        imread(files[0])
        t0 = time.perf_counter()
        for _ in range(reps):
            for f in files:
                imread(f)
        serial = (time.perf_counter() - t0) * 1e3 / (reps * len(files))
        with ThreadPoolExecutor(max_workers=8) as pool:
            t0 = time.perf_counter()
            list(pool.map(imread, files * (8 * reps)))
            threads8 = (time.perf_counter() - t0) * 1e3 / (8 * reps * len(files))
        decode_ms[key] = {"serial_ms_per_image": serial, "threads8_ms_per_image": threads8}
    predict_ms = host_ms_per_call(lambda: yolo.predict(str(val_dir), batch=IMAGES_BATCH, imgsz=IMAGES_IMGSZ), 10)
    predictor, dev = yolo.predictor, yolo.predictor.device

    def host_post(out_nv, frames):
        out, nv = out_nv
        return predictor.postprocess(out.cpu().numpy(), nv.cpu().numpy(), frames, [str(f) for f in val_files], {})

    stages = [("host_read_decode", lambda _: [imread(f) for f in val_files]),
              ("letterbox", lambda fr: (fr, letterbox_batch(fr, IMAGES_IMGSZ, dev))),
              ("device_fn", lambda fl: (fl[0], predictor._device_fn(fl[1]))),
              ("host_postprocess", lambda fo: host_post(fo[1], fo[0]))]
    split = {k: v / len(val_files) for k, v in _split_ms(stages, reps=10).items()}
    emit("images", fixtures_decoded_to_cv2_digest=len(recorded), launches=launches, predict_card_vs_cpu=cpu_vs_gpu,
         val_results=results, val_cpu_f32=cpu_val, val_abs_diff_f32=diff,
         kernel_checks={"fused_bottleneck": checks["fused_bottleneck"],
                        "fused_bottleneck_bf16": checks["fused_bottleneck_bf16"], "greedy_keep_k2048": nms},
         decode=decode_ms, predict_ms_per_image_from_files_batch8=predict_ms / len(val_files),
         split_ms_per_image_from_files_batch8=split, imgsz=IMAGES_IMGSZ,
         method="decode: imread of the fixtures on the host clock, serially and mapped over 8 threads (the "
                "loaders' pool), CPU readings of the card machine's host; predict: whole calls on the "
                "directory at batch 8 on the host clock after one warm call; the split by _split_ms (read and "
                "decode and host postprocess on the host clock, letterbox and device function by CUDA events)")
    return launches, checks, nms


def _post(url: str, head: dict, blob: bytes = b"") -> tuple:
    """POST a KServe v2 infer request -> (HTTP status, JSON header document)."""
    import urllib.error
    import urllib.request

    h = json.dumps(head).encode()
    req = urllib.request.Request(url, data=h + blob, method="POST",
                                 headers={"Content-Type": "application/json", "Inference-Header-Content-Length": str(len(h))})
    try:
        with urllib.request.urlopen(req, timeout=600) as r:
            payload, jlen = r.read(), r.headers.get("Inference-Header-Content-Length")
            return r.status, json.loads(payload[: int(jlen)] if jlen else payload)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _get_json(url: str) -> dict:
    import urllib.request

    with urllib.request.urlopen(url, timeout=600) as r:
        return json.loads(r.read())


def _forward_err(got, ref) -> dict:
    """Largest distance of decoded predictions (B, A, 4 + nc): boxes in px, scores."""
    import numpy as np

    require(got.shape == ref.shape and got.dtype == np.float32, f"served {got.dtype} {got.shape}, local {ref.shape}")
    return {"box_px": float(np.abs(got[..., :4] - ref[..., :4]).max()),
            "score": float(np.abs(got[..., 4:] - ref[..., 4:]).max())}


def _within_serve_tol(err: dict, what: str) -> dict:
    require(err["box_px"] <= SERVE_PX_TOL and err["score"] <= SERVE_SCORE_TOL,
            f"{what}: served predictions lie {err} from the local forward's")
    return err


def _load_run(send, clients: int, per_client: int) -> dict:
    """`clients` threads, released together by a barrier, each sending
    `per_client` requests back to back: requests/s over the wall time from the
    first start to the last reply, latency per request (host clock)."""
    import threading

    import numpy as np

    barrier, lat, errors, starts, ends = threading.Barrier(clients), [], [], [], []
    lock = threading.Lock()

    def client():
        try:
            barrier.wait()
            mine = []
            t_start = time.perf_counter()
            for _ in range(per_client):
                t0 = time.perf_counter()
                send()
                mine.append((time.perf_counter() - t0) * 1e3)
            with lock:
                lat.extend(mine)
                starts.append(t_start)
                ends.append(time.perf_counter())
        except Exception as e:  # reported below: a failed request fails the phase
            with lock:
                errors.append(repr(e))

    threads = [threading.Thread(target=client) for _ in range(clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    require(not errors and not any(t.is_alive() for t in threads), f"load run at concurrency {clients}: {errors[:3]}")
    wall = max(ends) - min(starts)
    return {"concurrency": clients, "requests": len(lat), "wall_s": wall, "requests_per_s": len(lat) / wall,
            "p50_ms": float(np.percentile(lat, 50)), "p99_ms": float(np.percentile(lat, 99)),
            "mean_ms": float(np.mean(lat))}


def serve_clients(url: str, payload: str, clients: int, per_client: int) -> None:
    """The client process of phase serve: `_load_run` of RemoteModel(url)
    requests carrying `payload` (a .npy frame batch sent raw, or an encoded
    image sent as BYTES); prints its result as one JSON line."""
    import numpy as np

    from spectrogram_yolov11_torch.serve import RemoteModel

    cli = RemoteModel(url)
    x = np.load(payload) if payload.endswith(".npy") else [Path(payload).read_bytes()]
    print(json.dumps(_load_run(lambda: cli(x), clients, per_client)), flush=True)


def _load_run_apart(url: str, payload: Path, clients: int, per_client: int) -> dict:
    """`serve_clients` in a process of its own (its own interpreter lock), stopped at its end or its time limit."""
    code = f"import chip_smoke as c; c.serve_clients({url!r}, {str(payload)!r}, {clients}, {per_client})"
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=600)
    require(out.returncode == 0, f"the client process failed ({out.returncode}): {out.stderr[-2000:]}")
    return json.loads(out.stdout.strip().splitlines()[-1])


def _busy(fn) -> dict:
    """The card's kernel time over fn() (torch.profiler, every thread's
    launches): busy share = kernel time over the span from the first kernel's
    start to the last's end."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    ks = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.time_range.elapsed_us() for e in ks) / 1e3
    span = (max(e.time_range.end for e in ks) - min(e.time_range.start for e in ks)) / 1e3 if ks else 0.0
    return {"kernels": len(ks), "device_kernel_ms": busy, "device_span_ms": span,
            "busy_share": busy / span if span else None, "run": out}


def phase_serve():
    """The KServe-v2 server on the card (f32 and half=True), its ingest paths,
    dynamic batching and YOLO(url) predict and val through it, counted; each
    kernel on the server's own inputs; request rates, latency, a request's
    split and the card's busy share under load."""
    import tempfile
    import threading

    import numpy as np
    import torch

    from spectrogram_yolov11_torch import YOLO
    from spectrogram_yolov11_torch.data.augment import letterbox_batch
    from spectrogram_yolov11_torch.data.dataset import check_det_dataset, find_dataset_yaml
    from spectrogram_yolov11_torch.data.imageio import imdecode
    from spectrogram_yolov11_torch.nn.autobackend import AutoBackend
    from spectrogram_yolov11_torch.ops.nms import nms_candidates
    from spectrogram_yolov11_torch.serve import (
        InferenceServer,
        RemoteModel,
        _encode_infer_response,
        _parse_infer_request,
        encode_images,
    )
    from spectrogram_yolov11_torch.utils import yaml_load

    f32_dispatch = {"fused_bottleneck": 6, "fused_bottleneck_bf16": 0, "greedy_keep": 0}
    bf16_dispatch = {"fused_bottleneck": 0, "fused_bottleneck_bf16": 6, "greedy_keep": 0}

    launches = {"serve": {}, "serve_half": {}}

    def counted(path: str, key: str, fn, expect: dict):
        out, got = run_counted(fn, expect, f"{path} {key}")
        launches[path][key] = got
        return out

    dev = torch.device("cuda")
    frames = letterbox_batch(_mixed_arrays(SERVE_BATCHES[-1], seed=300), 640, torch.device("cpu")).numpy()
    require(frames.shape == (SERVE_BATCHES[-1], 640, 640, 3), f"serve frames {frames.shape}")
    jpeg = (JPEG_FIXTURES / "spectrogram_synth" / "images" / "val" / "00000.jpg").read_bytes()
    jpeg_px = imdecode(jpeg)
    require(jpeg_px.shape == (640, 640, 3), f"the 640 px JPEG fixture decodes to {jpeg_px.shape}")
    local = AutoBackend(CKPT)  # the card, f32
    local_half = AutoBackend(CKPT, half=True)

    t0 = time.perf_counter()
    srv = InferenceServer({"spec": CKPT}, port=0).start()
    srv_half = InferenceServer({"spec": CKPT}, port=0, half=True).start()
    start_s = time.perf_counter() - t0
    try:
        base = f"http://127.0.0.1:{srv.port}"
        require(_get_json(base + "/v2/health/ready") == {} and _get_json(base + "/v2")["name"] == "spectrogram_yolov11_torch",
                "health or /v2 of the server")
        cli = counted("serve", "metadata_probe", lambda: RemoteModel(srv.url), f32_dispatch)
        cli_half = counted("serve_half", "metadata_probe", lambda: RemoteModel(srv_half.url), bf16_dispatch)
        md = _get_json(base + "/v2/models/spec")
        require(md["platform"] == "pytorch" and md["outputs"][0]["datatype"] == "FP32"
                and json.loads(md["parameters"]["metadata"])["names"] == {"0": "LTE", "1": "RF"}, f"metadata {md}")

        # raw UINT8 at B = 1, 3, 32 (3 runs in the 4-bucket), each against the local forward of the same frames
        errs = {}
        for b in SERVE_BATCHES:
            got = counted("serve", f"raw_b{b}", lambda b=b: cli(frames[:b])[0], f32_dispatch)
            errs[f"raw_b{b}"] = _within_serve_tol(_forward_err(got, local.forward(frames[:b]).cpu().numpy()), f"raw B={b}")
        raw32 = cli(frames)[0]
        # the other ingest paths, each against the raw path on the pixels the server sees
        b = SERVE_BATCHES[1]
        gray = np.ascontiguousarray(frames[:b, ..., :1])
        got = counted("serve", "gray_b3", lambda: cli(gray)[0], f32_dispatch)
        require(np.array_equal(got, cli(np.repeat(gray, 3, -1))[0]), "the gray upload differs from its 3-channel repeat")
        got = counted("serve", "bytes_png_b3", lambda: cli(encode_images(frames[:b]))[0], f32_dispatch)
        require(np.array_equal(got, cli(frames[:b])[0]), "BYTES PNG differs from the raw path")
        got = counted("serve", "bytes_jpeg_b3", lambda: cli([jpeg] * b)[0], f32_dispatch)
        require(np.array_equal(got, cli(np.stack([jpeg_px] * b))[0]), "BYTES JPEG differs from the raw path on its pixels")
        got = counted("serve_half", f"raw_b{SERVE_BATCHES[-1]}", lambda: cli_half(frames)[0], bf16_dispatch)
        errs[f"half_raw_b{SERVE_BATCHES[-1]}"] = _within_serve_tol(_forward_err(got, local_half.forward(frames).cpu().numpy()),
                                                 "the bf16 server against the local bf16 forward")

        # a truncated BYTES payload gets a 400, and the server goes on
        pngs = encode_images(frames[:2])
        blob = b"".join(len(x).to_bytes(4, "little") + x for x in pngs)
        head = {"inputs": [{"name": "images", "shape": [2], "datatype": "BYTES",
                            "parameters": {"binary_data_size": len(blob) - 100}}]}
        code, doc = counted("serve", "truncated_bytes", lambda: _post(f"{base}/v2/models/spec/infer", head, blob[:-100]),
                            {k: 0 for k in f32_dispatch})
        require(code == 400 and "ValueError" in doc.get("error", ""), f"a truncated BYTES payload got {code} {doc}")
        require(cli(encode_images(frames[:2]))[0].shape == (2, 8400, 6), "the server stopped serving after a 400")

        # dynamic batching: 32 clients, one frame each, released together; fewer dispatches than requests
        lone = [cli(frames[i : i + 1])[0] for i in range(SERVE_BATCHES[-1])]
        barrier, answers = threading.Barrier(SERVE_BATCHES[-1]), [None] * SERVE_BATCHES[-1]

        def one(i):
            barrier.wait()
            answers[i] = cli(frames[i : i + 1])[0]

        def burst():
            threads = [threading.Thread(target=one, args=(i,)) for i in range(SERVE_BATCHES[-1])]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=600)

        counters = launch_counters()
        for c in counters.values():
            c.launches = 0
        burst()
        torch.cuda.synchronize()
        dyn = {k: c.launches for k, c in counters.items()}
        launches["serve"]["dynamic_32_clients"] = dyn
        dispatches = dyn["fused_bottleneck"] / 6
        require(dyn["fused_bottleneck_bf16"] == 0 and dyn["greedy_keep"] == 0 and dyn["fused_bottleneck"] % 6 == 0,
                f"32 concurrent requests launched {dyn}")
        require(dispatches < SERVE_BATCHES[-1], f"32 concurrent requests took {dispatches} dispatches")
        dyn_err = {"box_px": 0.0, "score": 0.0}
        for a, lo in zip(answers, lone):
            e = _within_serve_tol(_forward_err(a, lo), "a request served in a group against itself alone")
            dyn_err = {k: max(dyn_err[k], e[k]) for k in e}

        # TF32 on for the process: a request still runs in f32 (the dispatcher thread keeps the policy)
        saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
        try:
            torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
            tf32_on = cli(frames[:1])[0]
            torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
            tf32_off = cli(frames[:1])[0]
        finally:
            torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved
        require(np.array_equal(tf32_on, tf32_off), f"TF32 on moves a served f32 request by {_forward_err(tf32_on, tf32_off)}")

        # YOLO(url).predict against YOLO(ckpt).predict on the card: 6 + 0 in the server, 1 NMS in the client
        arrays = _mixed_arrays(PREDICT_BATCH, seed=100)
        remote, yolo = YOLO(srv.url), YOLO(CKPT)
        got, launches["remote_predict"] = run_counted(lambda: remote.predict(arrays, batch=PREDICT_BATCH),
                                                      {"fused_bottleneck": 6, "fused_bottleneck_bf16": 0, "greedy_keep": 1},
                                                      "remote predict of 32 arrays")
        ref = yolo.predict(arrays, batch=PREDICT_BATCH)
        predict_err = 0.0
        for g, r in zip(got, ref):
            require(len(g) == len(r) and np.array_equal(g.boxes.cls, r.boxes.cls),
                    f"remote predict: {g.boxes.cls.tolist()} against local {r.boxes.cls.tolist()}")
            predict_err = max(predict_err, float(np.abs(g.boxes.xyxy - r.boxes.xyxy).max(initial=0.0)))
        require(predict_err <= 1e-3 and sum(map(len, ref)) > 0, f"remote predict boxes lie {predict_err} px from local")

        # val through each server against local val, on the 32-image synth split; the first remote val keeps
        # the decoded predictions its NMS takes
        with tempfile.TemporaryDirectory() as tmp:
            data = check_det_dataset(dict(yaml_load(find_dataset_yaml("spectrogram_synth.yaml")), path=tmp, n_train=0))
            seen, inner = [], remote.backend.forward
            remote.backend.forward = lambda x: seen.append(inner(x)) or seen[-1]
            try:
                rval, launches["remote_val"] = run_counted(
                    lambda: remote.val(data=data, batch=VAL_BATCH),
                    {"fused_bottleneck": 6, "fused_bottleneck_bf16": 0, "greedy_keep": 1}, "remote val")
            finally:
                remote.backend.forward = inner
            lval = yolo.val(data=data, batch=VAL_BATCH)
            rval_half, launches["remote_val_half"] = run_counted(
                lambda: YOLO(srv_half.url).val(data=data, batch=VAL_BATCH),
                {"fused_bottleneck": 0, "fused_bottleneck_bf16": 6, "greedy_keep": 1}, "remote val on the bf16 server")
            lval_half = yolo.val(data=data, batch=VAL_BATCH, half=True)
        val_diff = {k: abs(rval[k] - lval[k]) for k in lval}
        half_diff = {k: abs(rval_half[k] - lval_half[k]) for k in lval_half}
        require(max(val_diff.values()) <= SERVE_VAL_TOL and lval["metrics/mAP50-95(B)"] > 0.5,
                f"remote val {rval} against local {lval}")
        require(max(half_diff.values()) <= SERVE_VAL_TOL, f"bf16 remote val {rval_half} against local {lval_half}")

        # each kernel against its plain version on the server's own inputs: the first bottleneck of layers 6 and 8
        # in a 640 px dispatch of 32 and in a 64 px one (4x4 and 2x2 maps), f32 and bf16; the keep kernel on the
        # remote val's (32, 2048) multi-label candidates
        checks = {"fused_bottleneck": {}, "fused_bottleneck_bf16": {}}
        for key, server, c in (("fused_bottleneck", srv, cli), ("fused_bottleneck_bf16", srv_half, cli_half)):
            net = server.models["spec"].backend.model
            for size, x in (("640", frames), ("64", np.zeros((1, 64, 64, 3), np.uint8) + 90)):
                captured = {}
                hooks = [m.register_forward_pre_hook(keep_nhwc_input(captured)) for m in first_bottlenecks(net).values()]
                try:
                    c(x)
                finally:
                    for h in hooks:
                        h.remove()
                with torch.inference_mode():
                    for layer, mod in first_bottlenecks(net).items():
                        d = bottleneck_check(f"serve {size} px layer{layer}", layer_case(mod, captured[mod]))
                        checks[key][f"{size}px_layer{layer}"] = {k: v for k, v in d.items() if "args" not in k}
        require([checks["fused_bottleneck"][k]["shape"] for k in ("64px_layer6", "64px_layer8")]
                == [[1, 4, 4, 32], [1, 2, 2, 64]], f"64 px bottleneck inputs {checks['fused_bottleneck']}")
        with torch.inference_mode():
            preds = torch.tensor(seen[0], device=dev)
            _, _, _, valid, offset_boxes = nms_candidates(preds, 0.001, 2, multi_label=True, pre_nms_topk=2048)
            require(valid.shape == (VAL_BATCH, 2048), f"remote val candidates {tuple(valid.shape)}")
            nms = nms_check(offset_boxes, valid)

        # times: request rates and latency at concurrency 1, 8, 32 (raw UINT8 and BYTES JPEG, one 640 px frame
        # per request), dispatches counted; the bf16 server raw at 32
        one_raw, one_jpeg = frames[:1], [jpeg]
        loads = {}
        for name, c, payload in (("raw_uint8", cli, one_raw), ("bytes_jpeg", cli, one_jpeg), ("raw_uint8_half", cli_half, one_raw)):
            for conc, per in zip(SERVE_CONCURRENCY, SERVE_REQUESTS):
                if name == "raw_uint8_half" and conc != SERVE_CONCURRENCY[-1]:
                    continue
                for k in launch_counters().values():
                    k.launches = 0
                r = _load_run(lambda c=c, p=payload: c(p), conc, per)
                torch.cuda.synchronize()
                n = launch_counters()["fused_bottleneck"].launches + launch_counters()["fused_bottleneck_bf16"].launches
                r["dispatches"] = n / 6
                r["frames_per_dispatch"] = r["requests"] / max(n / 6, 1)
                loads[f"{name}_c{conc}"] = r

        # the split of one request (B = 1, 640 px) by stage, raw and JPEG: parse and decode, H2D, the device
        # forward, D2H, encode; the server's own functions in the order it runs them
        runner = srv.models["spec"]

        def body_of(inputs):
            specs, blobs = [], []
            for a in inputs:
                if isinstance(a, list):
                    bl = b"".join(len(x).to_bytes(4, "little") + x for x in a)
                    specs.append({"name": "images", "shape": [len(a)], "datatype": "BYTES", "parameters": {"binary_data_size": len(bl)}})
                else:
                    bl = a.tobytes()
                    specs.append({"name": "images", "shape": list(a.shape), "datatype": "UINT8", "parameters": {"binary_data_size": len(bl)}})
                blobs.append(bl)
            h = json.dumps({"inputs": specs, "outputs": [{"name": "output0", "parameters": {"binary_data": True}}]}).encode()
            return {"Inference-Header-Content-Length": str(len(h))}, h + b"".join(blobs)

        split = {}
        for name, payload in (("raw_uint8", one_raw), ("bytes_jpeg", one_jpeg)):
            hdrs, body = body_of([payload])
            stages = [("host_parse_decode", lambda _: runner._prep(_parse_infer_request(hdrs, bytearray(body))[1])),
                      ("h2d", lambda imgs: torch.from_numpy(imgs).to(dev)),
                      ("device", lambda x: runner.backend.forward(x.expand(-1, -1, -1, 3))),
                      ("d2h", lambda o: [o[:1].cpu().numpy()]),
                      ("host_encode", lambda outs: _encode_infer_response("spec", outs, True))]
            split[name] = _split_ms(stages, reps=20)
            split[name]["http_and_rest_ms"] = loads[f"{name}_c1"]["p50_ms"] - sum(split[name].values())
        busy = {"clients_in_process": _busy(lambda: _load_run(lambda: cli(one_raw), SERVE_CONCURRENCY[-1],
                                                                 SERVE_REQUESTS[-1]))}
        loads["raw_uint8_c32_profiled"] = busy["clients_in_process"].pop("run")

        # the same loads from a client process of its own: the server's capacity without the clients' Python work
        # under its interpreter lock (raw at 1 and 32 clients, JPEG at 32, 32 requests each at 32; raw at 32 profiled)
        with tempfile.TemporaryDirectory() as tmp:
            raw_path = Path(tmp) / "frame.npy"
            np.save(raw_path, one_raw)
            jpeg_path = JPEG_FIXTURES / "spectrogram_synth" / "images" / "val" / "00000.jpg"
            c_max, per_max = SERVE_CONCURRENCY[-1], 4 * SERVE_REQUESTS[-1]
            for name, payload, conc, per in (("raw_uint8", raw_path, 1, SERVE_REQUESTS[0]),
                                             ("raw_uint8", raw_path, c_max, per_max),
                                             ("bytes_jpeg", jpeg_path, c_max, per_max)):
                for k in launch_counters().values():
                    k.launches = 0
                r = _load_run_apart(srv.url, payload, conc, per)
                torch.cuda.synchronize()
                r["dispatches"] = launch_counters()["fused_bottleneck"].launches / 6
                r["frames_per_dispatch"] = r["requests"] / max(r["dispatches"], 1)
                loads[f"{name}_c{conc}_client_process"] = r
            busy["client_process"] = _busy(lambda: _load_run_apart(srv.url, raw_path, c_max, per_max))
            loads["raw_uint8_c32_client_process_profiled"] = busy["client_process"].pop("run")
    finally:
        srv.shutdown()
        srv_half.shutdown()
    emit("serve", server_start_s=start_s, launches=launches, dispatches_32_concurrent=dispatches,
         served_vs_local=errs, group_vs_alone=dyn_err, remote_predict_max_box_err_px=predict_err,
         remote_val=rval, local_val=lval, val_abs_diff=val_diff, remote_val_half=rval_half, local_val_half=lval_half,
         val_half_abs_diff=half_diff, kernel_checks={**checks, "greedy_keep_k2048": nms}, load=loads,
         split_ms_per_request=split, busy_c32=busy,
         method="requests through RemoteModel (a new HTTP connection each) from threads of this process to "
                "servers on 127.0.0.1; latency on the host clock per request; requests/s = requests over the "
                "wall time from the first client's start to the last reply; dispatches = bottleneck launches / 6; "
                "the split by _split_ms over the server's own functions (host_* on the host clock, H2D, device "
                "and D2H by CUDA events); busy share by torch.profiler over a concurrency-32 raw run; *_client_process: "
                "the clients in a process of their own (serve_clients), started after the server is up")
    return launches, checks, nms


def train_max_gt(ds) -> int:
    """The GT pad the JAX train loader sizes for a split (its data/dataset.py:157-165 with augment=True)."""
    most = max((len(lab["cls"]) for lab in ds.labels), default=0)
    return int(min(128, max(32, -(-int(most * 4 * 1.1) // 8) * 8)))


def train_batches(img_dir: str, imgsz: int, batch: int, device):
    """The train split as train batches (JAX's layout: img (B, S, S, 3) uint8 RGB,
    cls, bboxes normalised xywh, mask_gt) on `device`, through the port's val
    loader and the val letterbox: a stand-in with no augmentation until the
    train loader is ported."""
    import torch

    from spectrogram_yolov11_torch.data.augment import letterbox_batch
    from spectrogram_yolov11_torch.data.build import DataLoader
    from spectrogram_yolov11_torch.data.dataset import YOLODataset

    ds = YOLODataset(img_dir, imgsz=imgsz)
    ds = YOLODataset(img_dir, imgsz=imgsz, max_gt=train_max_gt(ds))
    out = []
    for b in DataLoader(ds, batch_size=batch, workers=8):
        if int(b["n_valid"]) < batch:  # drop_last, as the train loader
            break
        frames = letterbox_batch(b["img"], imgsz, device, scaleup=False)
        out.append({"img": frames.expand(-1, -1, -1, 3).flip(-1).contiguous(),
                    **{k: torch.from_numpy(b[k]).to(device) for k in ("cls", "bboxes", "mask_gt")}})
    return out


def timed_steps(trainer, batches, nis) -> dict:
    """train_step itself on `batches` at iterations `nis`, one by one: its ms
    by CUDA events around each call, and its split from the CUDA events
    train_step records between its parts (DetectionTrainer.split_events)."""
    import torch

    steps, split = [], {}
    for ni in nis:
        trainer.split_events = []
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        trainer.train_step(batches[ni % len(batches)], ni, trainer.step_due(ni))
        end.record()
        torch.cuda.synchronize()
        steps.append(start.elapsed_time(end))
        marks, trainer.split_events = trainer.split_events, None
        for (_, a), (name, b) in zip(marks, marks[1:]):
            split.setdefault(name, []).append(a.elapsed_time(b))
    return {"ms_per_step": steps, "split_ms_by_step": split}


def profile_steps(trainer, batches, ni0: int, n: int = 3, top: int = 12) -> dict:
    """n train steps under torch.profiler: kernel launches and device kernel
    ms per step, the device span per step, the busy share, the `top` kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for ni in range(ni0, ni0 + n):
            trainer.train_step(batches[ni % len(batches)], ni, trainer.step_due(ni))
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    by_name = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    busy = sum(by_name.values())
    span = (max(e.time_range.end for e in kernels) - min(e.time_range.start for e in kernels)) / 1e3
    return {"steps": n, "kernel_launches_per_step": len(kernels) / n, "device_kernel_ms_per_step": busy / n,
            "device_span_ms_per_step": span / n, "busy_share": busy / span,
            "top_kernels_ms_per_step": [[k[:90], ms / n]
                                        for k, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:top]]}


def new_trainer(data: dict, imgsz: int, batch: int, device: str, amp: bool = False):
    from spectrogram_yolov11_torch.engine.pipeline import load_model
    from spectrogram_yolov11_torch.engine.trainer import DetectionTrainer

    t = DetectionTrainer(load_model(CKPT)[0], {"data": data, "imgsz": imgsz, "batch": batch, "amp": amp,
                                               "optimizer": "auto", "device": device, "workers": 8})
    t.setup_model()
    t.setup_optimizer()
    return t


def train_card_vs_cpu(data: dict) -> dict:
    """One accumulation step and one AdamW step (ni 3 without, 4 with do_step;
    lr != 0 in the warmup) of the trained model at TRAIN_CHECK px, B =
    TRAIN_CHECK_BATCH, full width and depth, on the card with TF32 turned on for
    the process and on this machine's CPU, from the same weights and batch: the
    tolerances of tests/test_torch_train_step.py, which holds the CPU to JAX."""
    import numpy as np
    import torch

    from spectrogram_yolov11_torch.engine.optim import lr_at

    batch = train_batches(data["train"], TRAIN_CHECK, TRAIN_CHECK_BATCH, torch.device("cpu"))[0]
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    runs = {}
    try:
        for dev in ("cuda", "cpu"):
            t = new_trainer(dict(data), TRAIN_CHECK, TRAIN_CHECK_BATCH, dev)
            init = [p.detach().cpu().clone() for p in t.params]
            items, grads = [], None
            for ni, do_step in ((3, False), (4, True)):
                items.append(t.train_step(batch, ni, do_step)[1].cpu())
                if not do_step:
                    grads = [g.cpu().clone() for g in t.state["grad_buf"]]
            runs[dev] = (t, items, grads, init)
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved
    (tc, items_c, grads_c, init), (tp, items_p, grads_p, _) = runs["cuda"], runs["cpu"]
    items_err = max(float(((a - b).abs() / b.abs()).max()) for a, b in zip(items_c, items_p))
    require(items_err <= 1e-4, f"loss items on the card lie {items_err} (relative) from the CPU's")

    def leaf_errors(got, ref):
        top = max(float(r.abs().max()) for r in ref)
        worst = 0.0
        for g, r in zip(got, ref):
            scale, err = float(r.abs().max()), float((g.cpu() - r).abs().max())
            require(err <= (5e-4 * scale if scale >= 1e-6 * top else 1e-6 * top), f"leaf off by {err} (max {scale})")
            worst = max(worst, err / scale) if scale >= 1e-6 * top else worst
        return worst

    grads_err, mu_err = leaf_errors(grads_c, grads_p), leaf_errors(tc.state["opt"]["mu"], tp.state["opt"]["mu"])
    lr_main, lr_bias, _ = lr_at(tp.opt, 4)
    loose = total = 0
    for got, ref in ((tc.params, tp.params), (tc.state["ema"]["params"], tp.state["ema"]["params"])):
        for name, g, r, p0 in zip(tp.param_names, got, ref, init):
            r = r.detach()
            err = (g.detach().cpu() - r).abs()
            ulps = 4 * float(np.spacing(np.float32(r.abs().max())))
            lr = lr_bias if name.endswith("bias") else lr_main
            require(float(err.max()) <= 2 * lr + ulps, f"{name} on the card lies {float(err.max())} from the CPU's")
            loose += int((err > 1e-3 * float((r - p0).abs().max()) + ulps).sum())
            total += r.numel()
    require(loose <= 0.01 * total, f"{loose} of {total} parameter elements past the tight bound")
    stats_err = max(float((g.cpu() - r).abs().max() / r.abs().max()) for got, ref in (
        (tc.stats, tp.stats), (tc.state["ema"]["batch_stats"], tp.state["ema"]["batch_stats"])) for g, r in zip(got, ref))
    require(stats_err <= 1e-5, f"BN statistics on the card lie {stats_err} of their max from the CPU's")
    return dict(imgsz=TRAIN_CHECK, batch=TRAIN_CHECK_BATCH, process_tf32=True, items_card=[i.tolist() for i in items_c],
                items_cpu=[i.tolist() for i in items_p], items_max_rel_err=items_err,
                grads_worst_share_of_leaf_max=grads_err, mu_worst_share_of_leaf_max=mu_err,
                param_elements_past_tight_bound=loose, param_elements=total, bn_stats_worst_share_of_max=stats_err)


def phase_train():
    """The detect training step on the card: the trained model at TRAIN_IMGSZ px,
    B = TRAIN_BATCH, amp=False, optimizer auto (AdamW), on the synthetic
    split's train images; TRAIN_STEPS steps with do_step from the warmup ramp,
    counted (no kernel runs in training), then validate() of the EMA counted
    (6 + 1 launches per val batch); each kernel on the inputs the first val
    batch gave it, against its plain version (the bottlenecks also against BN
    folded from the EMA's weights now), and the card's val against the CPU's
    on 4 images; 6 later steps timed with their split, the profile of 3
    steps, B = 32; last the card's step against the CPU's at TRAIN_CHECK px
    with TF32 on."""
    import copy
    import tempfile

    import torch

    from spectrogram_yolov11_torch.data.dataset import check_det_dataset, find_dataset_yaml
    from spectrogram_yolov11_torch.engine.validator import VAL_PRE_NMS_TOPK, DetectionValidator
    from spectrogram_yolov11_torch.nn.modules.block import Bottleneck
    from spectrogram_yolov11_torch.ops.decode import decode_detections
    from spectrogram_yolov11_torch.ops.fused_conv import bottleneck_reference
    from spectrogram_yolov11_torch.ops.nms import nms_candidates
    from spectrogram_yolov11_torch.utils import yaml_load

    dev = torch.device("cuda")
    zero = {"fused_bottleneck": 0, "fused_bottleneck_bf16": 0, "greedy_keep": 0}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        data = check_det_dataset(dict(yaml_load(find_dataset_yaml("spectrogram_synth.yaml")), path=tmp))
        generate_s = time.perf_counter() - t0
        batches = train_batches(data["train"], TRAIN_IMGSZ, TRAIN_BATCH, dev)
        trainer = new_trainer(data, TRAIN_IMGSZ, TRAIN_BATCH, "cuda")
        opt = trainer.opt._asdict()
        require(opt["kind"] == "adamw" and len(batches) == opt["nb"] == 128 // TRAIN_BATCH,
                f"optimizer {opt}, {len(batches)} batches")

        # the main path: TRAIN_STEPS steps, counts set to 0 just before and read just after
        torch.cuda.reset_peak_memory_stats()

        def steps():
            out, start, end = [], torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for ni in range(TRAIN_STEPS):
                do_step = trainer.step_due(ni)
                out.append((ni, do_step, trainer.train_step(batches[ni % len(batches)], ni, do_step)))
            end.record()
            return out, start, end

        (done, start, end), launches = run_counted(steps, zero, f"{TRAIN_STEPS} train steps")
        steps_ms = start.elapsed_time(end)
        peak_gb = torch.cuda.max_memory_allocated() / 2**30
        losses = [[ni, do_step, float(loss), items.tolist()] for ni, do_step, (loss, items) in done]
        require(all(torch.isfinite(torch.tensor(r[3])).all() and r[2] > 0 for r in losses), f"losses {losses}")
        n_updates = trainer.state["ema_updates"]
        require(n_updates == sum(r[1] for r in losses) and n_updates >= 10, f"{n_updates} optimizer steps")

        # the EMA validated: 32 val images at batch TRAIN_BATCH, counted; hooks (which launch nothing) keep
        # what the first val batch hands each fused bottleneck and the head's output, the keep kernel's source
        n_val = len(list(Path(data["val"]).iterdir()))
        require(n_val % TRAIN_BATCH == 0, f"{n_val} val images")
        expect = {"fused_bottleneck": 6 * (n_val // TRAIN_BATCH), "fused_bottleneck_bf16": 0,
                  "greedy_keep": n_val // TRAIN_BATCH}
        model = trainer.ema_eval_model()  # the model validate() scores, made here so it can be hooked
        fused = {name: m for name, m in model.named_modules() if isinstance(m, Bottleneck) and m.fusable}
        captured = {}

        def keep_feats(mod, args, out):
            captured.setdefault("feats", out)

        hooks = [m.register_forward_pre_hook(keep_nhwc_input(captured)) for m in fused.values()]
        hooks.append(model.model[-1].register_forward_hook(keep_feats))
        t0 = time.perf_counter()
        results, val_launches = run_counted(trainer.validate, expect, "validate() of the EMA")
        val_s = time.perf_counter() - t0
        for h in hooks:
            h.remove()
        require(trainer.ema_model is model, "validate() scored another model than the hooked EMA model")
        require(all(0.0 <= v <= 1.0 for v in results.values()), f"EMA val results {results}")

        # each fused bottleneck at the input the EMA's val gave it: the kernel against its plain version on
        # the module's packs, and the module against the plain bottleneck on BN folded from the EMA's weights
        # now (a stale fold fails here)
        checks, fold_err = {}, 0.0
        with torch.inference_mode():
            for name, m in fused.items():
                nhwc = captured[m]
                checks[name] = {k: v for k, v in bottleneck_check(f"EMA {name}", layer_case(m, nhwc)).items()
                                if "args" not in k}
                (w1, b1), (w2, b2) = m.cv1.folded(), m.cv2.folded()
                ref = bottleneck_reference(nhwc, w1.permute(2, 3, 1, 0), b1, w2.permute(2, 3, 1, 0), b2)
                err = (m(nhwc.permute(0, 3, 1, 2)).permute(0, 2, 3, 1) - ref).abs()
                require(bool((err <= 1e-4 + 1e-4 * ref.abs()).all()), f"EMA bottleneck {name} runs stale weights")
                fold_err = max(fold_err, float(err.max()))
            shapes = sorted(c["shape"] for c in checks.values())
            require(shapes == [[TRAIN_BATCH, 20, 20, 64]] * 4 + [[TRAIN_BATCH, 40, 40, 32]] * 2,
                    f"EMA val bottleneck inputs {shapes}")

            # the keep kernel on the first val batch's candidates at the validator's settings
            preds = decode_detections(captured["feats"], model.nc, model.stride)
            _, _, _, valid, offset_boxes = nms_candidates(preds, 0.001, model.nc, multi_label=True,
                                                          pre_nms_topk=VAL_PRE_NMS_TOPK)
            require(valid.shape == (TRAIN_BATCH, VAL_PRE_NMS_TOPK), f"EMA val candidates {tuple(valid.shape)}")
            nms = nms_check(offset_boxes, valid)

        # the card's val of the EMA against the CPU's on the first 4 images
        (Path(tmp) / "val4.txt").write_text("\n".join(sorted(str(p) for p in Path(data["val"]).iterdir())[:4]))
        sub = dict(data, val=str(Path(tmp) / "val4.txt"))
        kw = {"data": sub, "imgsz": TRAIN_IMGSZ, "batch": 4}
        card4 = DetectionValidator(model, dict(kw, device="cuda"))()
        cpu4 = DetectionValidator(copy.deepcopy(model).cpu(), dict(kw, device="cpu"))()
        diff4 = {k: abs(card4[k] - cpu4[k]) for k in card4}
        require(max(diff4.values()) <= VAL_TOL, f"the EMA's val on 4 images: card {card4}, CPU {cpu4}")

        # train_step on 6 further steps, timed with its split
        later = timed_steps(trainer, batches, range(TRAIN_STEPS, TRAIN_STEPS + 6))

        # the profile of 3 steps: busy share, top kernels, launches per step
        prof = profile_steps(trainer, batches, TRAIN_STEPS + 6, top=15)

        # B = 32 if it fits
        b32 = {}
        del batches, trainer, model
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        try:
            t32 = new_trainer(data, TRAIN_IMGSZ, 2 * TRAIN_BATCH, "cuda")
            batches32 = train_batches(data["train"], TRAIN_IMGSZ, 2 * TRAIN_BATCH, dev)
            steps32 = timed_steps(t32, batches32, range(6))
            b32 = dict(ms_per_step=steps32["ms_per_step"][2:],
                       peak_memory_gib=torch.cuda.max_memory_allocated() / 2**30)
            del t32, batches32
        except torch.cuda.OutOfMemoryError as e:
            b32 = {"not_run": f"out of device memory at B = {2 * TRAIN_BATCH}: {str(e)[:200]}"}
        torch.cuda.empty_cache()
        check = train_card_vs_cpu(data)
    emit("train", imgsz=TRAIN_IMGSZ, batch=TRAIN_BATCH, steps=TRAIN_STEPS, generate_s=generate_s,
         optimizer=opt, launches=launches, ms_per_step=steps_ms / TRAIN_STEPS, later_steps=later,
         later_split_ms_mean={n: sum(v) / len(v) for n, v in later["split_ms_by_step"].items()},
         profile=prof,
         peak_memory_gib=peak_gb, loss_items_per_step=losses, optimizer_steps=n_updates,
         ema_val={"results": results, "launches": val_launches, "seconds": val_s,
                  "fused_bottleneck_checks": checks, "fold_max_abs_err": fold_err, "greedy_keep_k2048": nms,
                  "card_vs_cpu_4_images": {"card": card4, "cpu": cpu4, "abs_diff": diff4}},
         batch32=b32, card_vs_cpu=check,
         method="the main path's steps through DetectionTrainer.train_step, CUDA events around all of them; 6 "
                "later steps one by one, CUDA events around each train_step call and its split from the events "
                "train_step records between its parts; the profile over 3 steps by torch.profiler; batches from "
                "the val loader over the train split (no augmentation); the kernels checked on the inputs the "
                "EMA's first val batch gave them")
    return val_launches, checks, nms


def phase_train_loop():
    """YOLO(ckpt).train on the synthetic split (128 train + 32 val PNG at 640 px)
    at TRAIN_BATCH, amp=False, close_mosaic=1, for LOOP_EPOCHS epochs: the
    augmenting loader (mosaic, warp, HSV and flips; the image half on the
    card), the epoch loop and each epoch's EMA val. Counted from 0 just
    before the call and read just after (no launch in the steps, 6 + 1 per
    val batch), per epoch by callbacks; each kernel against its plain version
    on the first val's inputs; augment_batch on the card against the CPU on
    the first batch; YOLO(best.ckpt).val against the metrics of the epoch
    best.ckpt was saved at; a resume from last.ckpt as it stood after 2
    epochs. Readings: seconds per epoch, ms per step with the loader's wait,
    the wait, the split of train_step (upload and augment by CUDA events), the
    busy share over 3 steps, val seconds, the final EMA's mAP50-95."""
    import csv
    import shutil
    import tempfile

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from spectrogram_yolov11_torch import YOLO
    from spectrogram_yolov11_torch.cfg import DEFAULT_CFG_DICT, get_cfg
    from spectrogram_yolov11_torch.data.build import DataLoader
    from spectrogram_yolov11_torch.data.dataset import YOLODataset, check_det_dataset, find_dataset_yaml
    from spectrogram_yolov11_torch.engine.checkpoint import load_checkpoint
    from spectrogram_yolov11_torch.engine.validator import VAL_PRE_NMS_TOPK
    from spectrogram_yolov11_torch.nn.modules.block import Bottleneck
    from spectrogram_yolov11_torch.ops.decode import decode_detections
    from spectrogram_yolov11_torch.ops.device_augment import augment_batch
    from spectrogram_yolov11_torch.ops.nms import nms_candidates
    from spectrogram_yolov11_torch.utils import yaml_load

    counters = launch_counters()
    kw = dict(epochs=LOOP_EPOCHS, batch=TRAIN_BATCH, imgsz=TRAIN_IMGSZ, amp=False, close_mosaic=1, workers=8,
              exist_ok=True)
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        data = check_det_dataset(dict(yaml_load(find_dataset_yaml("spectrogram_synth.yaml")), path=tmp))
        generate_s = time.perf_counter() - t0
        n_val = len(list(Path(data["val"]).iterdir()))
        per_val = {"fused_bottleneck": 6 * (n_val // TRAIN_BATCH), "fused_bottleneck_bf16": 0,
                   "greedy_keep": n_val // TRAIN_BATCH}

        # the first batch the loader gives: augment_batch on the card against the CPU
        ds = YOLODataset(data["train"], imgsz=TRAIN_IMGSZ, max_gt=0, augment=True,
                         hyp=get_cfg(DEFAULT_CFG_DICT, {"mode": "train", **kw}))
        first = next(iter(DataLoader(ds, TRAIN_BATCH, workers=8, shuffle=True, seed=0, drop_last=True)))
        args = [torch.from_numpy(first[k]) for k in ("aug_src", "aug_regions", "aug_pads", "aug_inv", "aug_hsv")]
        card_img = augment_batch(*(a.cuda() for a in args))
        cpu_img = augment_batch(*args)
        aug_unequal = int((card_img.cpu() != cpu_img).sum())
        require(aug_unequal == 0, f"augment_batch on the card differs from the CPU's at {aug_unequal} values")
        serial_ms = {}  # one thread, no training beside it: what a sample costs the host
        for label in ("mosaic", "single_image"):
            if label == "single_image":
                ds.close_mosaic()
            t0 = time.perf_counter()
            for i in range(8):
                ds.get_item(i, np.random.default_rng(i))
            serial_ms[label] = (time.perf_counter() - t0) / 8 * 1e3
        dev_args = [a.cuda() for a in args]
        aug_check = dict(shape=list(card_img.shape), unequal=aug_unequal, host_ms_per_sample_serial=serial_ms,
                         mosaic_samples=int(
            (first["aug_regions"][:, 1:] != 0).any((1, 2)).sum()), ms=cuda_ms(lambda: augment_batch(*dev_args), iters=5))
        del card_img, cpu_img, args, dev_args, first

        # callbacks: per-epoch counts, the kernels' inputs on the first val, the split of epoch 1's steps,
        # the profile of its steps 3-5, last.ckpt after 2 epochs
        len_epoch = 128 // TRAIN_BATCH
        profiled_steps = (3, 4, 5)
        rec = {"counts": [], "split": [], "captured": {}, "hooks": [], "step": 0}
        counts = lambda: {k: c.launches for k, c in counters.items()}  # noqa: E731

        def keep_feats(mod, args, out) -> None:  # returns None: the head's output stays as it is
            rec["captured"].setdefault("feats", out)

        def on_start(t):
            model = t.ema_eval_model()  # the model each validate() scores, made here so it can be hooked
            rec["fused"] = {n: m for n, m in model.named_modules() if isinstance(m, Bottleneck) and m.fusable}
            rec["model"] = model
            rec["hooks"] = [m.register_forward_pre_hook(keep_nhwc_input(rec["captured"])) for m in rec["fused"].values()]
            rec["hooks"].append(model.model[-1].register_forward_hook(keep_feats))

        def on_epoch_start(t):
            if t.epoch == 2:  # last.ckpt as the first 2 epochs left it
                shutil.copy(t.last, Path(tmp) / "last_after_2_epochs.ckpt")
            rec["counts"].append({"epoch": t.epoch, "start": counts()})
            t.split_events = [] if t.epoch == 1 else None

        def on_batch_end(t):
            rec["step"] += 1
            rec["counts"][-1]["steps"] = counts()
            if t.epoch == 1 and rec["step"] - t.epoch * len_epoch == profiled_steps[0] - 1:
                torch.cuda.synchronize()
                rec["prof"] = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
                rec["prof"].start()
            elif rec.get("prof") is not None and rec["step"] - t.epoch * len_epoch == profiled_steps[-1]:
                torch.cuda.synchronize()
                rec["prof"].stop()
                rec["profiled"], rec["prof"] = rec["prof"], None

        def on_fit_epoch_end(t):
            rec["counts"][-1]["val"] = counts()
            if t.split_events:
                marks, t.split_events = t.split_events, None
                steps = [marks[i : i + 7] for i in range(0, len(marks), 7)]
                rec["split"] = [{name: a.elapsed_time(b) for (_, a), (name, b) in zip(s, s[1:])} for s in steps]

        yolo = YOLO(CKPT)
        for event, fn in (("on_train_start", on_start), ("on_train_epoch_start", on_epoch_start),
                          ("on_train_batch_end", on_batch_end), ("on_fit_epoch_end", on_fit_epoch_end)):
            yolo.add_callback(event, fn)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        metrics, launches = run_counted(lambda: yolo.train(data=data, project=tmp, name="loop", **kw),
                                        {k: LOOP_EPOCHS * v for k, v in per_val.items()}, "YOLO.train")
        train_s = time.perf_counter() - t0
        peak_gb = torch.cuda.max_memory_allocated() / 2**30
        for h in rec["hooks"]:
            h.remove()
        trainer = yolo.trainer
        require(trainer.ema_model is rec["model"], "validate() scored another model than the hooked EMA model")
        by_epoch = []
        for c in rec["counts"]:
            steps = {k: c["steps"][k] - c["start"][k] for k in c["start"]}
            val = {k: c["val"][k] - c["steps"][k] for k in c["start"]}
            require(not any(steps.values()) and val == per_val, f"epoch {c['epoch']}: steps {steps}, val {val}")
            by_epoch.append({"epoch": c["epoch"], "steps": steps, "val": val})
        rows = list(csv.DictReader(open(trainer.csv)))
        require(len(rows) == LOOP_EPOCHS and all(np.isfinite([float(v) for v in r.values()]).all() for r in rows),
                f"results.csv {rows}")
        require(all(0.0 <= v <= 1.0 for v in metrics.values()), f"final EMA val {metrics}")

        # each kernel on the first val's inputs, against its plain version
        checks = {}
        with torch.inference_mode():
            for name, m in rec["fused"].items():
                checks[name] = {k: v for k, v in bottleneck_check(f"loop EMA {name}",
                                                                  layer_case(m, rec["captured"][m])).items()
                                if "args" not in k}
            model = rec["model"]
            preds = decode_detections(rec["captured"]["feats"], model.nc, model.stride)
            _, _, _, valid, offset_boxes = nms_candidates(preds, 0.001, model.nc, multi_label=True,
                                                          pre_nms_topk=VAL_PRE_NMS_TOPK)
            nms = nms_check(offset_boxes, valid)
        shapes = sorted(c["shape"] for c in checks.values())
        require(shapes == [[TRAIN_BATCH, 20, 20, 64]] * 4 + [[TRAIN_BATCH, 40, 40, 32]] * 2, f"val inputs {shapes}")

        # best.ckpt (stripped) validates to the metrics of the epoch it was saved at
        best_tree, best_meta = load_checkpoint(trainer.best)
        require(best_tree["ema"] is None and best_tree["opt_state"] is None, "best.ckpt is not stripped")
        best_row = {k: float(v) for k, v in rows[int(best_meta["epoch"])].items()}
        best_val = YOLO(trainer.best).val(data=data, batch=TRAIN_BATCH, imgsz=TRAIN_IMGSZ)
        best_diff = {k: abs(best_val[k] - best_row[k]) for k in best_val}
        require(max(best_diff.values()) <= VAL_TOL, f"best.ckpt validates to {best_val}, its epoch {best_row}")

        # a resume from last.ckpt as it stood after 2 epochs
        saved_tree, saved_meta = load_checkpoint(Path(tmp) / "last_after_2_epochs.ckpt")
        seen = {}
        resumed = YOLO(CKPT)
        resumed.add_callback("on_train_start", lambda t: seen.update(
            start_epoch=t.start_epoch, step=t.state["opt"]["step"], ema_updates=t.state["ema_updates"]))
        resumed_metrics = resumed.train(data=data, project=tmp, name="resumed",
                                        resume=str(Path(tmp) / "last_after_2_epochs.ckpt"), **kw)
        want = dict(start_epoch=2, step=int(saved_tree["opt_state"]["step"]), ema_updates=int(saved_meta["updates"]))
        require(seen == want and saved_meta["epoch"] == 1, f"resume started at {seen}, the checkpoint holds {want}")
        require(len(list(csv.DictReader(open(resumed.trainer.csv)))) == 1, "the resumed run trained another epoch count")

        # readings
        log = trainer.epoch_log
        unprofiled = [s for i, s in enumerate(rec["split"], 1) if i not in profiled_steps]
        split_mean = {k: float(np.mean([s[k] for s in unprofiled])) for k in unprofiled[0]}
        kernels = [e for e in rec["profiled"].events() if e.device_type == torch.autograd.DeviceType.CUDA]
        busy = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
        span = (max(e.time_range.end for e in kernels) - min(e.time_range.start for e in kernels)) / 1e3
    emit("train_loop", epochs=LOOP_EPOCHS, batch=TRAIN_BATCH, imgsz=TRAIN_IMGSZ, generate_s=generate_s,
         train_call_s=train_s, launches=launches, launches_by_epoch=by_epoch, peak_memory_gib=peak_gb,
         epochs_log=log,
         ms_per_step_with_wait=[(e["seconds"] - e["val_s"]) / e["steps"] * 1e3 for e in log],
         loader_wait_ms_per_step=[e["loader_wait_s"] / e["steps"] * 1e3 for e in log],
         val_s=[e["val_s"] for e in log],
         train_step_split_ms_epoch1={"mean_outside_the_profile": split_mean, "by_step": rec["split"]},
         profile_3_steps={"kernel_launches_per_step": len(kernels) / 3, "device_kernel_ms_per_step": busy / 3,
                          "span_ms_per_step": span / 3, "busy_share": busy / span},
         results_csv=rows, final_ema=metrics, augment_card_vs_cpu=aug_check,
         ema_val_checks={"fused_bottleneck": checks, "greedy_keep_k2048": nms},
         best_ckpt={"epoch": int(best_meta["epoch"]), "val": best_val, "abs_diff_to_its_epoch": best_diff},
         resume={"started": seen, "metrics": resumed_metrics},
         method="YOLO(ckpt).train through the augmenting loader; counts from 0 around the call and per epoch by "
                "callbacks; the split from the CUDA events train_step records (epoch 1); the profile over steps "
                "3-5 of epoch 1 (torch.profiler, loader waits included); epochs_log from the trainer's host clock")
    return launches, checks, nms, metrics


def amp_card_vs_cpu(data: dict) -> dict:
    """One accumulation step and one AdamW step (ni 3, 4) of the trained model
    at TRAIN_CHECK px, B = TRAIN_CHECK_BATCH, amp=True, on the card with TF32
    turned on for the process and on this machine's CPU, from the same weights
    and batch, with the card's f32 step beside them: per quantity (loss items,
    grads, params, both moments, BN statistics, their EMA) over all its
    leaves, ||card bf16 - CPU bf16|| within AMP_MULTIPLE times the card's own
    bf16-to-f32 distance ||card bf16 - card f32|| (tests/test_torch_train_amp.py
    says why 3), every state tensor f32."""
    import torch

    batch = train_batches(data["train"], TRAIN_CHECK, TRAIN_CHECK_BATCH, torch.device("cpu"))[0]
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    runs = {}
    try:
        for name, dev, amp in (("card_bf16", "cuda", True), ("cpu_bf16", "cpu", True), ("card_f32", "cuda", False)):
            t = new_trainer(dict(data), TRAIN_CHECK, TRAIN_CHECK_BATCH, dev, amp=amp)
            items, grads = [], None
            for ni, do_step in ((3, False), (4, True)):
                items.append(t.train_step(batch, ni, do_step)[1].cpu())
                if not do_step:
                    grads = [g.cpu().clone() for g in t.state["grad_buf"]]
            st = t.state
            runs[name] = {"items": items, "grads": grads, "params": t.params, "mu": st["opt"]["mu"],
                          "nu": st["opt"]["nu"], "batch_stats": t.stats, "ema_params": st["ema"]["params"],
                          "ema_batch_stats": st["ema"]["batch_stats"]}
            if amp:
                require(t.model.compute_dtype == torch.bfloat16 and all(
                    x.dtype == torch.float32 for k, v in runs[name].items() if k != "items" for x in v),
                    f"{name}: a state tensor is not f32")
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved
    vec = lambda ts: torch.cat([t.detach().float().cpu().flatten() for t in ts])  # noqa: E731
    dist = {}
    for k in runs["card_bf16"]:
        a, b, f = (vec(runs[n][k]) for n in ("card_bf16", "cpu_bf16", "card_f32"))
        n = float(b.norm())
        err, yard = float((a - b).norm()) / n, float((a - f).norm()) / n
        require(err <= AMP_MULTIPLE * yard + 1e-6, f"amp step {k}: card bf16 lies {err} from the CPU's, "
                                                   f"the card's bf16-to-f32 distance is {yard}")
        dist[k] = {"card_bf16_vs_cpu_bf16": err, "card_bf16_vs_card_f32": yard}
    return dict(imgsz=TRAIN_CHECK, batch=TRAIN_CHECK_BATCH, process_tf32=True, multiple=AMP_MULTIPLE,
                relative_l2=dist, items={n: [i.tolist() for i in r["items"]] for n, r in runs.items()})


def phase_train_amp(f32_loop_final: dict):
    """bf16 training, amp=True (JAX's default): the trained model at TRAIN_IMGSZ
    px, B = TRAIN_BATCH, optimizer auto (AdamW), TRAIN_STEPS steps on the
    synthetic split's train images through the val loader (as phase train),
    counted (no kernel launches: the training convs are cuDNN's); 6 later
    steps timed with train_step's split, the profile of 3 steps beside 3 f32
    steps of an f32 trainer, peak memory, B = 32; the card's bf16 step
    against the CPU's at TRAIN_CHECK px with TF32 on. Then
    YOLO(ckpt).train(epochs=AMP_EPOCHS, batch=TRAIN_BATCH, imgsz=TRAIN_IMGSZ,
    close_mosaic=1) at the default amp, counted from 0 around the call and per
    epoch (each EMA val runs a bf16 copy of the EMA: 6 bf16 bottleneck + 1
    NMS launches per val batch, no f32 bottleneck); each kernel against its
    plain version on the inputs the first val gave it (global module hooks,
    which launch nothing); the final EMA's bf16 mAP beside the f32 loop's."""
    import tempfile

    import numpy as np
    import torch

    from spectrogram_yolov11_torch import YOLO
    from spectrogram_yolov11_torch.data.dataset import check_det_dataset, find_dataset_yaml
    from spectrogram_yolov11_torch.engine.checkpoint import load_checkpoint
    from spectrogram_yolov11_torch.engine.validator import VAL_PRE_NMS_TOPK
    from spectrogram_yolov11_torch.nn.modules.block import Bottleneck
    from spectrogram_yolov11_torch.nn.modules.head import Detect
    from spectrogram_yolov11_torch.ops.decode import decode_detections
    from spectrogram_yolov11_torch.ops.nms import nms_candidates
    from spectrogram_yolov11_torch.utils import yaml_load

    dev, bf16 = torch.device("cuda"), torch.bfloat16
    zero = {"fused_bottleneck": 0, "fused_bottleneck_bf16": 0, "greedy_keep": 0}
    counters = launch_counters()
    with tempfile.TemporaryDirectory() as tmp:
        data = check_det_dataset(dict(yaml_load(find_dataset_yaml("spectrogram_synth.yaml")), path=tmp))
        batches = train_batches(data["train"], TRAIN_IMGSZ, TRAIN_BATCH, dev)
        trainer = new_trainer(data, TRAIN_IMGSZ, TRAIN_BATCH, "cuda", amp=True)
        require(trainer.model.compute_dtype == bf16 and trainer.opt.kind == "adamw", "the amp trainer's set-up")

        # the main path: TRAIN_STEPS steps, counts set to 0 just before and read just after
        torch.cuda.reset_peak_memory_stats()

        def steps():
            out, start, end = [], torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for ni in range(TRAIN_STEPS):
                do_step = trainer.step_due(ni)
                out.append((ni, do_step, trainer.train_step(batches[ni % len(batches)], ni, do_step)))
            end.record()
            return out, start, end

        (done, start, end), launches = run_counted(steps, zero, f"{TRAIN_STEPS} amp train steps")
        steps_ms = start.elapsed_time(end)
        peak_gb = torch.cuda.max_memory_allocated() / 2**30
        losses = [[ni, do_step, float(loss), items.tolist()] for ni, do_step, (loss, items) in done]
        require(all(np.isfinite(r[3]).all() and r[2] > 0 for r in losses), f"amp losses {losses}")
        st = trainer.state
        state = (*trainer.params, *trainer.stats, *st["grad_buf"], *st["opt"]["mu"], *st["opt"]["nu"],
                 *st["ema"]["params"], *st["ema"]["batch_stats"])
        require(all(x.dtype == torch.float32 for x in state), "an amp state tensor is not f32")

        # later steps timed with their split, the profile beside an f32 trainer's, in turns
        later = timed_steps(trainer, batches, range(TRAIN_STEPS, TRAIN_STEPS + 6))
        f32 = new_trainer(data, TRAIN_IMGSZ, TRAIN_BATCH, "cuda")
        later_f32 = timed_steps(f32, batches, range(TRAIN_STEPS, TRAIN_STEPS + 6))  # its first steps warm it up
        profile_steps(f32, batches, TRAIN_STEPS + 6, n=1)  # the profiler's own set-up lands here, not in a reading
        prof = profile_steps(trainer, batches, TRAIN_STEPS + 6)
        prof_f32 = profile_steps(f32, batches, TRAIN_STEPS + 7)
        prof_again = profile_steps(trainer, batches, TRAIN_STEPS + 9)
        del f32, batches, trainer
        torch.cuda.empty_cache()

        # B = 32 if it fits
        torch.cuda.reset_peak_memory_stats()
        try:
            t32 = new_trainer(data, TRAIN_IMGSZ, 2 * TRAIN_BATCH, "cuda", amp=True)
            batches32 = train_batches(data["train"], TRAIN_IMGSZ, 2 * TRAIN_BATCH, dev)
            b32 = dict(ms_per_step=timed_steps(t32, batches32, range(6))["ms_per_step"][2:],
                       peak_memory_gib=torch.cuda.max_memory_allocated() / 2**30)
            del t32, batches32
        except torch.cuda.OutOfMemoryError as e:
            b32 = {"not_run": f"out of device memory at B = {2 * TRAIN_BATCH}: {str(e)[:200]}"}
        torch.cuda.empty_cache()
        check = amp_card_vs_cpu(data)

        # YOLO.train at the default amp, counted; global hooks keep what the first val hands the bf16
        # bottlenecks and the head's output
        n_val = len(list(Path(data["val"]).iterdir()))
        per_val = {"fused_bottleneck": 0, "fused_bottleneck_bf16": 6 * (n_val // TRAIN_BATCH),
                   "greedy_keep": n_val // TRAIN_BATCH}
        rec = {"counts": [], "captured": {}, "first_val": True}
        counts = lambda: {k: c.launches for k, c in counters.items()}  # noqa: E731

        def pre(mod, args):  # returns None: the input stays as it is
            if (rec["first_val"] and isinstance(mod, Bottleneck) and mod.fusable and not mod.training
                    and args[0].dtype == bf16):
                rec["captured"].setdefault(mod, args[0].permute(0, 2, 3, 1).contiguous())

        def post(mod, args, out):  # returns None: the output stays as it is
            if rec["first_val"] and isinstance(mod, Detect) and not mod.training and out[0][0].dtype == bf16:
                rec["captured"].setdefault("feats", out)

        def on_epoch_start(t):
            rec["counts"].append({"epoch": t.epoch, "start": counts()})

        def on_batch_end(t):
            rec["counts"][-1]["steps"] = counts()

        def on_fit_epoch_end(t):
            rec["counts"][-1]["val"] = counts()
            rec["first_val"] = False

        yolo = YOLO(CKPT)
        for event, fn in (("on_train_epoch_start", on_epoch_start), ("on_train_batch_end", on_batch_end),
                          ("on_fit_epoch_end", on_fit_epoch_end)):
            yolo.add_callback(event, fn)
        hooks = [torch.nn.modules.module.register_module_forward_pre_hook(pre),
                 torch.nn.modules.module.register_module_forward_hook(post)]
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        try:
            metrics, loop_launches = run_counted(
                lambda: yolo.train(data=data, project=tmp, name="amp", epochs=AMP_EPOCHS, batch=TRAIN_BATCH,
                                   imgsz=TRAIN_IMGSZ, close_mosaic=1, workers=8, exist_ok=True),
                {k: AMP_EPOCHS * v for k, v in per_val.items()}, "YOLO.train at amp=True")
        finally:
            for h in hooks:
                h.remove()
        train_s = time.perf_counter() - t0
        loop_peak_gb = torch.cuda.max_memory_allocated() / 2**30
        tr = yolo.trainer
        require(tr.args.amp is True and yolo.model.compute_dtype == bf16, "YOLO.train did not run at amp=True")
        require(tr.validator.model.dtype == bf16, "the EMA's val did not run a bf16 copy")
        by_epoch = []
        for c in rec["counts"]:
            steps_c = {k: c["steps"][k] - c["start"][k] for k in c["start"]}
            val_c = {k: c["val"][k] - c["steps"][k] for k in c["start"]}
            require(not any(steps_c.values()) and val_c == per_val,
                    f"epoch {c['epoch']}: steps {steps_c}, val {val_c}")
            by_epoch.append({"epoch": c["epoch"], "steps": steps_c, "val": val_c})
        require(all(0.0 <= v <= 1.0 for v in metrics.values()), f"final amp EMA val {metrics}")
        ckpt_amp = load_checkpoint(tr.last)[1]["train_args"]["amp"]
        require(ckpt_amp is True, f"last.ckpt's train_args.amp is {ckpt_amp}")

        # each kernel on the first val's inputs, against its plain version
        cap = rec["captured"]
        checks = {}
        with torch.inference_mode():
            for i, m in enumerate(m for m in cap if m != "feats"):
                d = bottleneck_check(f"amp EMA {i}", layer_case(m, cap[m]))
                checks[f"bottleneck{i}"] = {k: v for k, v in d.items() if "args" not in k}
            preds = decode_detections(cap["feats"], yolo.model.nc, yolo.model.stride)
            _, _, _, valid, offset_boxes = nms_candidates(preds, 0.001, yolo.model.nc, multi_label=True,
                                                          pre_nms_topk=VAL_PRE_NMS_TOPK)
            nms = nms_check(offset_boxes, valid)
        shapes = sorted(c["shape"] for c in checks.values())
        require(shapes == [[TRAIN_BATCH, 20, 20, 64]] * 4 + [[TRAIN_BATCH, 40, 40, 32]] * 2,
                f"amp val inputs {shapes}")
        log = tr.epoch_log
    emit("train_amp", imgsz=TRAIN_IMGSZ, batch=TRAIN_BATCH, steps=TRAIN_STEPS, launches=launches,
         ms_per_step=steps_ms / TRAIN_STEPS, later_steps=later,
         later_split_ms_mean={n: sum(v) / len(v) for n, v in later["split_ms_by_step"].items()},
         f32_later_steps=later_f32,
         f32_later_split_ms_mean={n: sum(v) / len(v) for n, v in later_f32["split_ms_by_step"].items()},
         profile=prof, profile_f32=prof_f32, profile_again=prof_again, peak_memory_gib=peak_gb,
         loss_items_per_step=losses, batch32=b32, card_vs_cpu=check,
         loop={"epochs": AMP_EPOCHS, "train_call_s": train_s, "launches": loop_launches,
               "launches_by_epoch": by_epoch, "epochs_log": log,
               "ms_per_step_with_wait": [(e["seconds"] - e["val_s"]) / e["steps"] * 1e3 for e in log],
               "loader_wait_ms_per_step": [e["loader_wait_s"] / e["steps"] * 1e3 for e in log],
               "val_s": [e["val_s"] for e in log], "peak_memory_gib": loop_peak_gb, "final_ema_bf16": metrics,
               "f32_loop_final_ema": f32_loop_final, "ckpt_train_args_amp": ckpt_amp,
               "ema_val_checks": {"fused_bottleneck_bf16": checks, "greedy_keep_k2048": nms}},
         method="train steps through DetectionTrainer.train_step at amp=True, CUDA events; 6 later steps one by one "
                "with the split train_step records, then 6 of an f32 trainer; the profiles over 3 steps each "
                "(torch.profiler, after a 1-step profile that takes its set-up), amp, f32, amp; YOLO(ckpt).train "
                "at its defaults counted from 0 around the call and per epoch by callbacks; the kernels checked on the first val's inputs (global module hooks)")
    return loop_launches, checks, nms


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
    images_launches, images_checks, nms_images = phase_images()
    serve_launches, serve_checks, nms_serve = phase_serve()
    train_val_launches, train_bottleneck, nms_train = phase_train()
    loop_launches, loop_bottleneck, nms_loop, loop_final = phase_train_loop()
    amp_launches, amp_bottleneck, nms_amp = phase_train_amp(loop_final)

    def per_forward(key, shapes=shapes):
        return sum(shapes[n][key] * shapes[n]["launches_per_forward"] for n in ("layer6", "layer8"))

    def serve_paths(kernel: str, remote_val: int) -> dict:
        return {"serve": sum(v[kernel] for v in serve_launches["serve"].values()),
                "serve_half": sum(v[kernel] for v in serve_launches["serve_half"].values()),
                "remote_predict": serve_launches["remote_predict"][kernel], "remote_val": remote_val}

    fb_ops_bound = TF32_PASSES * per_forward("flops") / PEAK_TF32_FLOPS >= per_forward("bytes") / PEAK_HBM_BYTES
    kernels_line = [
        dict(name="fused_bottleneck", route="cuda", source="spectrogram_yolov11_torch/csrc/fused_bottleneck.cu",
             replaces="spectrogram_yolov11_tpu/ops/pallas_fused_conv.py:67",
             launches=launches["fused_bottleneck"],
             launches_by_path={"pipeline": launches["fused_bottleneck"], "predict": predict_launches["fused_bottleneck"],
                               "val": val_launches["f32"]["fused_bottleneck"],
                               "images": sum(v["fused_bottleneck"] for v in images_launches.values()),
                               "train_ema_val": train_val_launches["fused_bottleneck"],
                               "train_loop": loop_launches["fused_bottleneck"],
                               "train_amp": amp_launches["fused_bottleneck"],
                               **serve_paths("fused_bottleneck", serve_launches["remote_val"]["fused_bottleneck"])},
             max_abs_err=max(d["max_abs_err"] for d in (*bottleneck.values(), *b1_bottleneck.values(),
                                                         *images_checks["fused_bottleneck"].values(),
                                                         *serve_checks["fused_bottleneck"].values(),
                                                         *train_bottleneck.values(), *loop_bottleneck.values())),
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
                               "val_half": val_launches["bf16"]["fused_bottleneck_bf16"],
                               "images_val_half": images_launches["val_bf16"]["fused_bottleneck_bf16"],
                               "train_amp": amp_launches["fused_bottleneck_bf16"],
                               **serve_paths("fused_bottleneck_bf16",
                                             serve_launches["remote_val_half"]["fused_bottleneck_bf16"])},
             max_abs_err=max(d["max_abs_err"] for d in (*half_checks.values(), *b1_half.values(),
                                                         *images_checks["fused_bottleneck_bf16"].values(),
                                                         *amp_bottleneck.values(),
                                                         *serve_checks["fused_bottleneck_bf16"].values())),
             unequal_share_max=max(d["unequal_share"] for d in (*half_checks.values(), *b1_half.values(),
                                                                 *images_checks["fused_bottleneck_bf16"].values(),
                                                                 *amp_bottleneck.values(),
                                                                 *serve_checks["fused_bottleneck_bf16"].values())),
             train_amp_ema_val={"shapes": sorted(d["shape"] for d in amp_bottleneck.values()),
                                "max_abs_err": max(d["max_abs_err"] for d in amp_bottleneck.values()),
                                "tolerance_min": min(d["tolerance"] for d in amp_bottleneck.values())},
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
                               "val": val_launches["f32"]["greedy_keep"], "val_half": val_launches["bf16"]["greedy_keep"],
                               "images": sum(v["greedy_keep"] for v in images_launches.values()),
                               "train_ema_val": train_val_launches["greedy_keep"],
                               "train_loop": loop_launches["greedy_keep"], "train_amp": amp_launches["greedy_keep"],
                               **serve_paths("greedy_keep", serve_launches["remote_val"]["greedy_keep"]
                                             + serve_launches["remote_val_half"]["greedy_keep"])},
             max_abs_err=0.0,
             ms=nms["ms"], plain_ms=nms["plain_ms"], bound_ms=nms["bound_ms"], bound_by=nms["bound_by"],
             library_ms=None, design="IoU bitmask of valid rows + one-warp scan from survivor to survivor",
             scan_steps_mean=nms["scan_steps_mean"],
             predict_k1024={k: nms_k1024[k] for k in ("shape", "ms", "plain_ms", "bound_ms", "bound_by",
                                                      "scan_steps_mean", "mismatches")},
             val_k2048={k: nms_val[k] for k in ("shape", "ms", "device_ms", "plain_ms", "bound_ms", "bound_by",
                                                 "scan_steps_mean", "mismatches")},
             images_val_k2048={k: nms_images[k] for k in ("shape", "ms", "plain_ms", "bound_ms", "bound_by",
                                                         "scan_steps_mean", "mismatches")},
             train_ema_val_k2048={k: nms_train[k] for k in ("shape", "ms", "plain_ms", "bound_ms", "bound_by",
                                                           "scan_steps_mean", "mismatches")},
             train_loop_k2048={k: nms_loop[k] for k in ("shape", "ms", "plain_ms", "bound_ms", "bound_by",
                                                        "scan_steps_mean", "mismatches")},
             train_amp_k2048={k: nms_amp[k] for k in ("shape", "ms", "plain_ms", "bound_ms", "bound_by",
                                                      "scan_steps_mean", "mismatches")},
             remote_val_k2048={k: nms_serve[k] for k in ("shape", "ms", "plain_ms", "bound_ms", "bound_by",
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
