"""The port's configuration and command line against the JAX package's.

- Every key of JAX's cfg/default.yaml (its DEFAULT_CFG_DICT, read here) is
  in the port's DEFAULT_CFG_DICT at JAX's default, but for the one the port
  documents (`mode`), and get_cfg accepts the whole set at JAX's
  values. Each of the 41 keys the port lacked is handled as the cfg module's
  table says: inert, honoured (predict's drawing keys are held to JAX's
  plots in tests/test_torch_plot.py and tests/test_torch_predict.py,
  augment and visualize to JAX's TTA and feature maps in
  tests/test_torch_predict_extras.py),
  `rect=True` warns and is set False as in JAX, or another value than the
  default raises NotImplementedError naming its ROADMAP.md item.
- `yaml_load` reads the port's packaged YAMLs (the two detect model YAMLs
  with their nested flow lists, `scales:` mapping and `None` / `nearest`
  scalars, and the three dataset YAMLs) as yaml.safe_load does, and the
  model YAMLs hold what JAX's do.
- For the README's command lines, the port's entrypoint and JAX's hand the
  same model, task, mode and overrides to the facade (each facade replaced by
  a recorder), `cfg=<yaml>` overrides among them.
"""

import logging
from pathlib import Path

import pytest
import yaml

import spectrogram_yolov11_torch as port_pkg
import spectrogram_yolov11_tpu as jax_pkg
import spectrogram_yolov11_tpu.utils as jax_utils
from spectrogram_yolov11_torch.cfg import DEFAULT_CFG_DICT, NOT_PORTED_KEYS, entrypoint, get_cfg
from spectrogram_yolov11_torch.utils import yaml_load
from spectrogram_yolov11_tpu.cfg import entrypoint as jax_entrypoint

ROOT = Path(__file__).resolve().parent.parent
PORT_CFG = ROOT / "spectrogram_yolov11_torch" / "cfg"
JAX_CFG = ROOT / "spectrogram_yolov11_tpu" / "cfg"
PORT_DEFAULTS = {"mode": "predict"}  # the port's documented difference
# the 41 keys of JAX's default.yaml the port's cfg rejected before, each with its handling
INERT = ("pretrained", "deterministic", "freeze", "bgr", "dropout", "save_hybrid", "dnn", "pose", "kobj",
         "overlap_mask", "mask_ratio", "retina_masks", "copy_paste_mode", "auto_augment", "erasing", "crop_fraction",
         "source", "cfg", "show_boxes", "embed")
HONOURED = ("model", "line_width", "show_conf", "show_labels", "augment", "visualize")
NEW_KEYS = (*INERT, *HONOURED, "rect", *NOT_PORTED_KEYS)
# a non-default value of each key that raises, and the ROADMAP.md item it names
NON_DEFAULT = {"augment": True, "visualize": True, "show": True, "show_labels": False, "show_conf": False,
               "show_boxes": False, "line_width": 2, "save_frames": True, "vid_stride": 2, "stream_buffer": True,
               "format": "onnx", "keras": True, "int8": True, "opset": 17, "simplify": False,
               "dynamic": True, "optimize": True, "workspace": 4.0, "nms": True, "tracker": "bytetrack.yaml"}
ITEM = {**dict.fromkeys(("augment", "visualize", "show", "save_frames", "vid_stride", "stream_buffer"), "item 5"),
        **dict.fromkeys(("format", "keras", "int8", "opset", "simplify", "dynamic", "optimize", "workspace", "nms"),
                        "item 9"), "tracker": "item 12"}
# a non-default value of each inert key, of the type check_cfg holds it to
INERT_VALUE = {"pretrained": False, "deterministic": False, "freeze": [0, 1], "bgr": 0.5, "dropout": 0.1,
               "save_hybrid": True, "dnn": True, "pose": 6.0, "kobj": 2.0, "overlap_mask": False, "mask_ratio": 2,
               "retina_masks": True, "copy_paste_mode": "mixup", "auto_augment": "augmix", "erasing": 0.0,
               "crop_fraction": 0.5, "source": "frames/", "cfg": "custom.yaml", "show_boxes": False, "embed": [10]}


def test_every_jax_key_is_accepted_at_its_default():
    jax_keys = dict(jax_utils.DEFAULT_CFG_DICT)
    assert set(jax_keys) == set(DEFAULT_CFG_DICT)
    assert len(NEW_KEYS) == len(set(NEW_KEYS)) == 41
    for k, v in jax_keys.items():
        assert DEFAULT_CFG_DICT[k] == PORT_DEFAULTS.get(k, v), k
    args = get_cfg(DEFAULT_CFG_DICT, jax_keys)
    assert {k: getattr(args, k) for k in jax_keys} == jax_keys


@pytest.mark.parametrize("key", NEW_KEYS)
def test_each_new_key_is_handled_as_tabled(key, caplog):
    assert key in (PORT_CFG / "__init__.py").read_text().split('"""')[1], f"{key} is not in the cfg module's table"
    assert getattr(get_cfg(DEFAULT_CFG_DICT, {key: DEFAULT_CFG_DICT[key]}), key) == DEFAULT_CFG_DICT[key]
    if key == "rect":  # as JAX's get_cfg: a warning, and False
        with caplog.at_level(logging.WARNING):
            assert get_cfg(DEFAULT_CFG_DICT, {"rect": True}).rect is False
        assert "rect=True is not supported" in caplog.text
    elif key in NOT_PORTED_KEYS:
        with pytest.raises(NotImplementedError, match=rf"{key}=.*ROADMAP.md §1 {ITEM[key]} "):
            get_cfg(DEFAULT_CFG_DICT, {key: NON_DEFAULT[key]})
    elif key in INERT:
        assert getattr(get_cfg(DEFAULT_CFG_DICT, {key: INERT_VALUE[key]}), key) == INERT_VALUE[key]
    elif key == "model":  # carried to the trainer, which builds it when it has no model (test_torch_scratch.py)
        assert get_cfg(DEFAULT_CFG_DICT, {"model": "yolo11n.yaml"}).model == "yolo11n.yaml"
    else:  # predict's drawing keys, carried to Results.plot (test_torch_plot.py, test_torch_predict.py), and
        # augment and visualize, taken by predict (test_torch_predict_extras.py) and read by no other mode
        assert getattr(get_cfg(DEFAULT_CFG_DICT, {key: NON_DEFAULT[key]}), key) == NON_DEFAULT[key]


YAMLS = sorted((PORT_CFG / "models").rglob("*.yaml")) + sorted((PORT_CFG / "datasets").glob("*.yaml"))


@pytest.mark.parametrize("path", YAMLS, ids=lambda p: f"{p.parent.name}/{p.name}")
def test_packaged_yamls_read_as_pyyaml(path):
    assert yaml_load(path) == yaml.safe_load(path.read_text())
    if path.parent.name == "11":  # a model YAML holds what JAX's copy holds
        assert yaml_load(path) == yaml.safe_load((JAX_CFG / "models" / "11" / path.name).read_text())


class _Recorder:
    """Stands in for a facade: keeps what the entrypoint hands it."""

    calls: list = []

    def __init__(self, model, task=None):
        self.task, self.ckpt_data = task or "detect", None
        self.calls.append({"model": str(model), "task": task})

    def __getattr__(self, mode):
        return lambda **kw: self.calls[-1].update(mode=mode, overrides=kw)


README_LINES = [
    "yolo detect train model=spectrogram_yolo11.yaml data=spectrogram_synth.yaml epochs=80",
    "yolo predict model=runs/detect/train/weights/best.ckpt source=waterfall.png",
    "yolo detect val model=runs_artifacts/spectrogram_yolo11n.ckpt data=spectrogram_synth.yaml batch=32 half=True",
    "yolo train model=yolo11n.yaml data=spectrogram_synth.yaml epochs=2 imgsz=320 amp=false device=cpu",
    "yolo val model=yolo11n.yaml",  # no data: JAX's default dataset name, with a warning
    "yolo detect predict model=yolo11n source=frames/ conf=0.3 cfg={cfg}",
]


@pytest.mark.parametrize("line", README_LINES)
def test_command_line_hands_the_facade_what_jax_hands_it(line, tmp_path, monkeypatch):
    cfg = tmp_path / "overrides.yaml"
    cfg.write_text("imgsz: 256\nmax_det: 100\n")
    line = line.format(cfg=cfg)
    monkeypatch.setattr(jax_utils, "enable_compile_cache", lambda: None)  # the JAX CLI's process-wide cache switch
    seen = {}
    for name, pkg, run in (("jax", jax_pkg, jax_entrypoint), ("port", port_pkg, entrypoint)):
        _Recorder.calls = []
        monkeypatch.setattr(pkg, "YOLO", _Recorder)
        run(line)
        seen[name] = _Recorder.calls
    assert seen["port"] == seen["jax"] and len(seen["port"]) == 1 and "mode" in seen["port"][0]


def test_command_line_refusals():
    for line, item in (("yolo settings", "item 12"), ("yolo hub login", "item 12"), ("yolo solutions", "item 12")):
        with pytest.raises(NotImplementedError, match=f"ROADMAP.*{item}"):
            entrypoint(line)
    with pytest.raises(SyntaxError, match="not a valid argument"):
        entrypoint("yolo detect trian model=yolo11n.yaml")
    with pytest.raises(SyntaxError, match="not a valid argument"):
        entrypoint("yolo detect train model=yolo11n.yaml epoch=3")
    with pytest.raises(SyntaxError, match="key=value arguments only"):
        entrypoint("yolo serve train model=yolo11n.yaml")
    assert entrypoint("yolo help") is None
