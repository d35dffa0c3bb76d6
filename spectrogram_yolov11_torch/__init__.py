"""spectrogram_yolov11_torch: the PyTorch/CUDA port of spectrogram_yolov11_tpu.

The port runs the trained spectrogram detector on an NVIDIA H100:
`YOLO("runs_artifacts/spectrogram_yolo11n.ckpt").predict("capture.npy")` takes
IQ captures or uint8 frames through the STFT front end, the on-card letterbox,
the forward, DFL decode and class-offset greedy NMS to `Results`
(`engine.model`, `engine.predictor`); `engine.pipeline.build_pipeline` is the
serving path for frames of one known size. `YOLO(ckpt).val` scores a model on
a dataset and `YOLO(ckpt).train` trains it (`engine.validator`,
`engine.trainer`), the train images augmented on the card. `serve.serve`
runs the KServe-v2 server on the card, and `YOLO("http://host:port/name")`
predicts and validates through it (`nn.autobackend`). Plain tensor code is PyTorch in NCHW; the
two kernels the JAX package wrote in Pallas are hand-written CUDA C++ under
`csrc/`, built with nvcc at first use (`utils.kernels`).

The package imports torch, numpy and the standard library only. Entry points
run on the card unless the caller passes `device="cpu"`.
"""

__version__ = "0.1.0"

from .engine.model import YOLO  # noqa: E402

__all__ = ["YOLO"]
