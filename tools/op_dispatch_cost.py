"""Host and card cost of the fused bottleneck's wrapper, of a network forward
and of a B = 1 predict, on one CUDA card.

    python tools/op_dispatch_cost.py [--root DIR] [--reps N]

Imports spectrogram_yolov11_torch from DIR (the checkout that holds this
script by default), so that two trees of the package can be timed in turns
on one card, each in a process of its own. Loads
runs_artifacts/spectrogram_yolo11n.ckpt, keeps the NHWC inputs of its 6 fused
bottlenecks in one forward at 640 px (B = 1 and 32, f32 and bf16), and times:

  wrapper_ms       the 6 calls of fused_bottleneck, as the network makes
                   them, per forward: CUDA events around `reps` rounds, with
                   autograd on, as chip_smoke.py times the kernel
  wrapper_ms_inf   the same under torch.inference_mode, as the pipeline runs
  raw_ms           the 6 launches through ops/fused_conv.py:_run_kernel, the
                   wrapper's launch and checks with nothing around them
  *_host_us        host microseconds per call of the same, the launches
                   queued (perf_counter around the rounds, before the sync)
  forward_ms       engine/exporter.py:build_inference_fn(nms=False), per call
  predict_ms       YOLO(ckpt).predict of one 640 x 640 frame, save=False,
                   the median of `reps` wall-clock calls

and prints them as one JSON line, with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--reps", type=int, default=50)
    a = ap.parse_args()
    root = Path(a.root).resolve()
    sys.path.insert(0, str(root))

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("op_dispatch_cost: no CUDA card", file=sys.stderr)
        return 2
    from spectrogram_yolov11_torch import YOLO
    from spectrogram_yolov11_torch.engine.exporter import build_inference_fn
    from spectrogram_yolov11_torch.engine.pipeline import eval_network, load_model
    from spectrogram_yolov11_torch.ops import fused_conv
    from spectrogram_yolov11_torch.utils import kernels

    kernels.build_all()
    dev = torch.device("cuda")
    ckpt = root / "runs_artifacts" / "spectrogram_yolo11n.ckpt"
    frames = torch.from_numpy(np.random.default_rng(0).integers(0, 255, (32, 640, 640, 3), np.uint8)).to(dev)

    def card_ms(fn) -> float:
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(a.reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / a.reps

    def host_us(fn, calls: int) -> float:
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(a.reps):
            fn()
        t = time.perf_counter() - t0
        torch.cuda.synchronize()
        return t / (a.reps * calls) * 1e6

    out = {"root": str(root)}
    for half in (False, True):
        net = eval_network(load_model(ckpt)[0], half, dev)
        entry, pack_shape = (("fused_bottleneck_bf16", (9, "C", "C")) if half
                             else ("fused_bottleneck_f32", (2, 9, "C", "C")))
        fused = [m for m in net.modules() if getattr(m, "fusable", False)]
        fn = build_inference_fn(net, nms=False)
        for b in (1, 32):
            seen = {}

            def keep(mod, inp):  # returns None: the input stays as it is
                seen.setdefault(mod, inp[0].permute(0, 2, 3, 1).contiguous())

            hooks = [m.register_forward_pre_hook(keep) for m in fused]
            x = frames[:b]
            fn(x)
            for h in hooks:
                h.remove()

            def as_given(w):  # as block.py hands it over: the f32 pack stored (18, C, C), viewed (2, 9, C, C)
                return w if half else w.view(2, 9, *w.shape[1:])

            calls = [(seen[m], as_given(m.w1), m.b1, as_given(m.w2), m.b2) for m in fused]

            def wrapper():
                for c in calls:
                    fused_conv.fused_bottleneck(*c)

            def raw():
                for c in calls:
                    fused_conv._run_kernel(entry, *c, pack_shape)

            def wrapper_inf():
                with torch.inference_mode():
                    wrapper()

            key = f"{'bf16' if half else 'f32'}_b{b}"
            out[key] = {"bottlenecks": len(calls), "shapes": [list(c[0].shape) for c in calls],
                        "wrapper_ms": card_ms(wrapper), "wrapper_ms_inf": card_ms(wrapper_inf), "raw_ms": card_ms(raw),
                        "wrapper_host_us": host_us(wrapper, len(calls)),
                        "wrapper_inf_host_us": host_us(wrapper_inf, len(calls)),
                        "raw_host_us": host_us(raw, len(calls)), "forward_ms": card_ms(lambda: fn(x))}
    model = YOLO(str(ckpt), device="cuda")
    img = frames[0].flip(-1).cpu().numpy()
    times = []
    for i in range(a.reps + 3):
        t0 = time.perf_counter()
        model.predict(img, save=False, verbose=False)
        if i >= 3:
            times.append((time.perf_counter() - t0) * 1e3)
    out["predict_ms"] = statistics.median(times)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    out["card"] = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "unknown"
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
