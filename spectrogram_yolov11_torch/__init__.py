"""spectrogram_yolov11_torch: the PyTorch/CUDA port of spectrogram_yolov11_tpu.

The port runs the trained spectrogram detector on an NVIDIA H100: uint8
letterboxed frames -> forward -> DFL decode -> class-offset greedy NMS
(`engine.pipeline.build_pipeline`). Plain tensor code is PyTorch in NCHW; the
two kernels the JAX package wrote in Pallas are hand-written CUDA C++ under
`csrc/`, built with nvcc at first use (`utils.kernels`).

The package imports torch, numpy and the standard library only. Entry points
run on the card unless the caller passes `device="cpu"`.
"""

__version__ = "0.1.0"
