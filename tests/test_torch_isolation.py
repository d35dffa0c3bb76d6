"""The port stands alone, and runs on the card unless asked for the CPU.

An AST scan shows that no file of spectrogram_yolov11_torch/ nor chip_smoke.py
imports jax, flax, msgpack, yaml, cv2, PIL or the JAX package (the image
readers, data/imageio.py and data/jpeg.py, among them); with no card, the
entry points (the pipeline, predict, val, the trainer and YOLO.train, the
server and the checkpoint AutoBackend) raise for the default device instead
of running on the CPU.
"""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch
from test_torch_train_step import one_torch_thread  # noqa: F401 (autouse: one torch thread in this module)

from spectrogram_yolov11_torch import YOLO
from spectrogram_yolov11_torch.engine.pipeline import build_pipeline
from spectrogram_yolov11_torch.engine.trainer import DetectionTrainer
from spectrogram_yolov11_torch.nn.autobackend import AutoBackend
from spectrogram_yolov11_torch.serve import InferenceServer
from spectrogram_yolov11_torch.utils import resolve_device

ROOT = Path(__file__).resolve().parent.parent
CKPT = ROOT / "runs_artifacts" / "spectrogram_yolo11n.ckpt"
FORBIDDEN = {"jax", "jaxlib", "flax", "msgpack", "yaml", "cv2", "PIL", "spectrogram_yolov11_tpu"}


def _imported_roots(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and isinstance(node.args[0], ast.Constant):
            yield str(node.args[0].value).split(".")[0]


def _port_files():
    files = sorted((ROOT / "spectrogram_yolov11_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 15 and all(f.exists() for f in files)
    assert {"jpeg.py", "imageio.py", "loaders.py", "serve.py", "autobackend.py", "exporter.py"} <= {f.name for f in files}
    return files


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_nothing_of_jax(path):
    bad = set(_imported_roots(path)) & FORBIDDEN
    assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"


def test_default_device_raises_without_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        build_pipeline(CKPT)
    frame = np.zeros((32, 32, 3), np.uint8)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        YOLO(CKPT).predict(frame)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        YOLO(CKPT, device="cuda").predict(frame, device="cuda:0")
    assert len(YOLO(CKPT).predict(frame, device="cpu", imgsz=64)) == 1
    with pytest.raises(RuntimeError, match="no CUDA card"):
        YOLO(CKPT).val(data={"path": str(ROOT), "val": "tests", "names": ["LTE", "RF"]})
    with pytest.raises(RuntimeError, match="no CUDA card"):
        DetectionTrainer(YOLO(CKPT).model, {"data": {"path": str(ROOT), "val": "tests", "names": ["LTE", "RF"]},
                                            "amp": False})
    with pytest.raises(RuntimeError, match="no CUDA card"):
        YOLO(CKPT).train(data={"path": str(ROOT), "val": "tests", "names": ["LTE", "RF"]}, amp=False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        InferenceServer(CKPT)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        AutoBackend(CKPT)
    assert AutoBackend(CKPT, device="cpu").device.type == "cpu"
    with pytest.raises(RuntimeError, match="no CUDA card"):
        resolve_device("cuda:0")
    assert resolve_device("cpu").type == "cpu"
    with pytest.raises(ValueError):
        resolve_device("meta")
