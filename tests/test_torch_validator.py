"""YOLO(ckpt).val on the port against the JAX package's, on the CPU at 640 px.

The trained checkpoint validates a 4-image PNG split of the synthetic
spectrogram dataset (made by the port's generator with the val seed 10000,
as maybe_generate seeds val) through `spectrogram_yolov11_torch.YOLO(CKPT)
.val(data=..., device="cpu")` and `spectrogram_yolov11_tpu.YOLO(CKPT)
.val(data=...)` on the same files. Tolerances:

- f32: every value of results_dict within 1e-4 (measured here: 2e-7 in
  precision, the others equal), the `metrics/coco_*` keys of save_json=True
  among them; per image, the detections with score >= 0.1 equal in count and
  class, boxes within 1e-2 px of the image's own pixels. Both run at
  plots=True (the default) with save_json=True; the artifacts (confusion
  matrix, curves, JSON rows, chart files) are held to JAX's in
  tests/test_torch_artifacts.py, which reads this module's `runs`.
- bf16 (half=True against JAX's set_dtype(bfloat16) validator): mAP50-95
  within twice JAX's own bf16-to-f32 distance in mAP50-95, measured in the
  test (here: the port lies 1.7e-4 from JAX's bf16, which lies 2.5e-4 from
  JAX's f32).
- NMS at the validator's settings (multi-label, k = 2048, conf 0.001, iou
  0.7, max_det 300): equal outputs to JAX's on the trained model's decoded
  predictions of the split, and on seeded dense candidates with tied scores
  and more than max_det survivors, where the final cut must fall where JAX's
  does.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch
from test_torch_train_step import one_torch_thread  # noqa: F401 (autouse: one torch thread in this module)

import spectrogram_yolov11_torch.engine.validator as port_validator
import spectrogram_yolov11_tpu.engine.validator as jax_validator
import spectrogram_yolov11_tpu.utils.callbacks as jax_callbacks
from spectrogram_yolov11_torch import YOLO
from spectrogram_yolov11_torch.data.augment import letterbox_batch
from spectrogram_yolov11_torch.data.dataset import YOLODataset, check_det_dataset
from spectrogram_yolov11_torch.ops.decode import decode_detections
from spectrogram_yolov11_torch.ops.nms import non_max_suppression
from spectrogram_yolov11_tpu import YOLO as JaxYOLO
from spectrogram_yolov11_tpu.ops.nms import non_max_suppression as jax_nms

CKPT = Path(__file__).resolve().parent.parent / "runs_artifacts" / "spectrogram_yolo11n.ckpt"
VAL_NMS = dict(conf_thres=0.001, iou_thres=0.7, nc=2, multi_label=True, max_det=300, pre_nms_topk=2048)
EVENTS = ["on_val_start", "on_val_batch_start", "on_val_batch_end", "on_val_end"]


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("synth4")
    d = {"path": str(root), "train": "images/train", "val": "images/val", "synthetic": "spectrogram",
         "n_train": 0, "n_val": 4, "gen_imgsz": 640, "seed": 0, "names": {0: "LTE", 1: "RF"}}
    check_det_dataset(d)  # materialises the split with the port's generator
    return d


def _val_recording(module, run):
    """run() with `module._unletterbox_boxes` wrapped to keep each image's detections in its own pixels."""
    dets, inner = [], module._unletterbox_boxes
    mp = pytest.MonkeyPatch()
    mp.setattr(module, "_unletterbox_boxes", lambda *a: dets.append(inner(*a).copy()) or dets[-1])
    try:
        return run(), dets
    finally:
        mp.undo()


@pytest.fixture(scope="module")
def runs(data, tmp_path_factory):
    """results_dict and per-image detections: port and JAX in f32 at plots=True
    with save_json=True (each validator kept), then in bf16 (the JAX validator
    turns its model to bf16 in place, so bf16 comes last)."""
    project = tmp_path_factory.mktemp("val_runs")
    # the JAX facade's logging integrations (TensorBoard through tensorflow) do not touch the results
    # and take ten seconds or more to import: leave them out
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_callbacks, "_INTEGRATIONS", ())
        port, jax_model = YOLO(CKPT, device="cpu"), JaxYOLO(str(CKPT))
    events = []
    for e in EVENTS:
        port.add_callback(e, lambda v, e=e: events.append(e))
    out = {"events": events, "port_model": port, "project": project}
    kw = dict(data=data, batch=4, save_json=True)
    out["port"] = _val_recording(port_validator, lambda: port.val(project=str(project / "port"), **kw))
    out["port_validator"] = port.validator
    out["jax"] = _val_recording(jax_validator, lambda: jax_model.val(plots=True, project=str(project / "jax"), **kw))
    out["jax_validator"] = jax_model.validator
    out["port_half"] = port.val(data=data, batch=4, half=True, plots=False)
    out["jax_half"] = jax_model.val(data=data, batch=4, plots=False, half=True)
    return out


def test_val_f32_matches_jax(runs):
    (ours, dets), (theirs, jdets) = runs["port"], runs["jax"]
    print("port", ours, "\njax ", theirs)
    assert list(ours) == list(theirs)
    for k in ours:
        assert abs(ours[k] - theirs[k]) <= 1e-4, (k, ours[k], theirs[k])
    assert len(dets) == len(jdets) == 4
    for i, (a, b) in enumerate(zip(dets, jdets)):
        a, b = a[a[:, 4] >= 0.1], b[b[:, 4] >= 0.1]
        err = float(np.abs(a[:, :4] - b[:, :4]).max(initial=0.0))
        print(f"image {i}: {len(a)} detections >= 0.1 (JAX {len(b)}), classes {a[:, 5].tolist()}, max box diff {err:.2e} px")
        assert len(a) == len(b) > 0 and np.array_equal(a[:, 5], b[:, 5]) and err <= 1e-2
    assert runs["port_model"].validator.speed.keys() == {"preprocess", "inference", "postprocess"}


def test_val_half_matches_jax_bf16(runs):
    ours, theirs, jax_f32 = runs["port_half"], runs["jax_half"], runs["jax"][0]
    key = "metrics/mAP50-95(B)"
    d_jax, d_port = abs(theirs[key] - jax_f32[key]), abs(ours[key] - theirs[key])
    print(f"bf16 mAP50-95: port {ours[key]:.6f}, JAX {theirs[key]:.6f}, JAX f32 {jax_f32[key]:.6f}; "
          f"port to JAX bf16 {d_port:.2e}, JAX bf16 to f32 {d_jax:.2e}")
    assert list(ours) == list(theirs) and all(np.isfinite(v) for v in ours.values())
    assert d_port <= 2 * d_jax
    assert runs["port_model"].model.dtype == torch.float32  # the bf16 run used its own copy


def test_val_callbacks_fire_in_order(runs):
    one_run = EVENTS[:1] + EVENTS[1:3] + EVENTS[3:]  # one batch of 4
    assert runs["events"] == one_run * 2  # the f32 and the bf16 run


def test_val_refuses_plots_and_save_json(runs, data, tmp_path):
    """plots and save_json are honoured now: plots=True, the default, writes
    the six charts and nothing else, save_json=True the two JSON files too,
    both into one run directory (JAX puts the JSON into the next, val2, as it
    asks get_save_dir twice); plots=False with save_json=False writes nothing.
    Unknown keys and a missing split still raise."""
    port = runs["port_model"]
    charts = {"PR_curve.png", "F1_curve.png", "P_curve.png", "R_curve.png", "confusion_matrix.png",
              "confusion_matrix_normalized.png"}
    assert {p.name for p in (runs["project"] / "port" / "val").iterdir()} == charts | {"predictions.json",
                                                                                     "annotations.json"}
    assert {p.name for p in (runs["project"] / "jax" / "val").iterdir()} == charts
    assert {p.name for p in (runs["project"] / "jax" / "val2").iterdir()} == {"predictions.json", "annotations.json"}
    res = port.val(data=data, batch=4, plots=False, project=str(tmp_path))
    assert not any(tmp_path.iterdir()) and not any(k.startswith("metrics/coco_") for k in res)
    assert res == {k: v for k, v in runs["port"][0].items() if not k.startswith("metrics/coco_")}
    with pytest.raises(SyntaxError, match="not a valid argument"):
        port.val(data=data, confidence=0.3)
    with pytest.raises(KeyError, match="no 'test' split"):  # split picks data[split]; this dataset has no test
        port.val(data=data, split="test")


def test_val_artifacts_equal_jax(runs):
    """The confusion matrix and curves_results of the f32 val equal JAX's, the
    COCO rows agree in count, image, class and box (within 1e-2 px, JAX's
    box tolerance above), and the six charts carry JAX's names and pixel sizes;
    the port's curves hold to the chart yardstick (tests/test_torch_artifacts.py)."""
    from test_torch_artifacts import assert_heatmap_ordered, assert_series_drawn

    from spectrogram_yolov11_torch.data.imageio import imread
    from spectrogram_yolov11_torch.utils import plotting

    ours, theirs = runs["port_validator"], runs["jax_validator"]
    np.testing.assert_array_equal(ours.confusion_matrix.matrix, theirs.confusion_matrix.matrix)
    assert ours.confusion_matrix.matrix.sum() > 0
    oc, tc = ours.metrics.curves_results, theirs.metrics.curves_results
    assert set(oc) == set(tc)
    for k in oc:
        np.testing.assert_allclose(np.asarray(oc[k], np.float64), np.asarray(tc[k], np.float64), rtol=0, atol=1e-4,
                                   err_msg=k)
    for key in ("jdict", "gt_jdict"):
        a, b = getattr(ours, key), getattr(theirs, key)
        assert len(a) == len(b) > 0
        for ra, rb in zip(a, b):
            assert (ra["image_id"], ra["category_id"]) == (rb["image_id"], rb["category_id"])
            assert np.abs(np.subtract(ra["bbox"], rb["bbox"])).max() <= 1e-2
    port_dir, jax_dir = runs["project"] / "port" / "val", runs["project"] / "jax" / "val"
    for f in sorted(jax_dir.glob("*.png")):
        assert imread(port_dir / f.name).shape == imread(f).shape, f.name
    json_dir = runs["project"] / "jax" / "val2"
    for name in ("predictions.json", "annotations.json"):
        assert len(json.loads((port_dir / name).read_text())) == len(json.loads((json_dir / name).read_text()))
    x = np.linspace(0, 1, oc["p_curve"].shape[1])
    chart = plotting.render_mc_curve(x, oc["f1_curve"], ours.names, "F1")
    assert np.array_equal(imread(port_dir / "F1_curve.png"), chart.img)
    series = [(x, oc["f1_curve"][c], plotting.CYCLE[c], 1) for c in range(len(oc["f1_curve"]))]
    assert_series_drawn(chart, series + [(x, oc["f1_curve"].mean(0), plotting.BLUE, 3)])
    chart = plotting.render_confusion_matrix(ours.confusion_matrix.matrix, ours.names, True)
    assert np.array_equal(imread(port_dir / "confusion_matrix_normalized.png"), chart.img)
    assert_heatmap_ordered(chart, ours.confusion_matrix.matrix, True)


def test_val_without_data_scores_the_checkpoints_train_data(runs, data, tmp_path):
    """val() with no data scores the dataset the checkpoint's train_args name,
    as the JAX facade does (its engine/model.py:107-109, :275): a copy of the
    checkpoint whose JSON header carries train_args {"data": <yaml>}, the
    msgpack body byte for byte, validates as val(data=<yaml>). The shipped
    checkpoint names no data, so there val() raises TypeError."""
    yaml_path = tmp_path / "synth4.yaml"
    yaml_path.write_text(f"path: {data['path']}\ntrain: images/train\nval: images/val\nnames:\n  0: LTE\n  1: RF\n")
    blob = CKPT.read_bytes()
    n = int.from_bytes(blob[:8], "little")
    meta = json.loads(blob[8 : 8 + n])
    assert meta["train_args"] == {}
    header = json.dumps({**meta, "train_args": {"data": str(yaml_path)}}).encode()
    trained = tmp_path / "trained.ckpt"
    trained.write_bytes(len(header).to_bytes(8, "little") + header + blob[8 + n :])
    assert trained.read_bytes()[-(len(blob) - 8 - n) :] == blob[8 + n :]
    assert YOLO(trained, device="cpu").val(batch=4, save_json=True, project=str(tmp_path)) == runs["port"][0]
    with pytest.raises(TypeError, match="data="):
        YOLO(CKPT, device="cpu").val(batch=4)


def test_nms_at_val_settings_equals_jax_on_trained_candidates(data, runs):
    """The trained model's decoded predictions of the split at k = 2048: the
    tie order of the multi-label top-k decides which candidates go in."""
    model = runs["port_model"].model
    ds = YOLODataset(check_det_dataset(data)["val"], imgsz=640)
    frames = letterbox_batch([ds.load_image(i) for i in range(len(ds))], 640, torch.device("cpu"), scaleup=False)
    with torch.inference_mode():
        rgb = frames.expand(-1, -1, -1, 3).flip(-1).float() / 255.0
        preds = decode_detections(model(rgb.permute(0, 3, 1, 2)), model.nc, model.stride).numpy()
    out, n = non_max_suppression(torch.from_numpy(preds), **VAL_NMS)
    jout, jn = jax_nms(preds, **VAL_NMS)
    print("detections per image at val settings:", n.tolist())
    np.testing.assert_array_equal(n.numpy(), np.asarray(jn))
    np.testing.assert_array_equal(out.numpy(), np.asarray(jout))


def test_nms_at_val_settings_cuts_at_max_det_as_jax():
    """Dense seeded candidates: boxes on a grid (few overlaps) with scores
    rounded to 1e-2 (many ties), so far more than max_det = 300 boxes survive
    and the tie order decides both the top-k and the final cut."""
    rng = np.random.default_rng(0)
    b, a = 2, 4000
    grid = np.stack(np.meshgrid(np.arange(80), np.arange(50)), -1).reshape(-1, 2)[:a] * 16.0 + 8.0
    xywh = np.concatenate([grid + rng.normal(0, 2, (b, a, 2)), rng.uniform(8, 24, (b, a, 2))], -1)
    scores = np.round(rng.uniform(0, 1, (b, a, 2)), 2)
    preds = np.concatenate([xywh, scores], -1).astype(np.float32)
    out, n = non_max_suppression(torch.from_numpy(preds), **VAL_NMS)
    jout, jn = jax_nms(preds, **VAL_NMS)
    assert n.tolist() == [300, 300]
    np.testing.assert_array_equal(n.numpy(), np.asarray(jn))
    np.testing.assert_array_equal(out.numpy(), np.asarray(jout))


if __name__ == "__main__":  # readings on the full 32-image val split: the port and JAX, f32 and bf16, on the CPU
    import tempfile

    from spectrogram_yolov11_torch.data.dataset import find_dataset_yaml
    from spectrogram_yolov11_torch.utils import yaml_load

    key = "metrics/mAP50-95(B)"
    with tempfile.TemporaryDirectory() as tmp:
        split = check_det_dataset(dict(yaml_load(find_dataset_yaml("spectrogram_synth.yaml")), path=tmp, n_train=0))
        jax_callbacks._INTEGRATIONS = ()
        port, jax_model = YOLO(CKPT, device="cpu"), JaxYOLO(str(CKPT))
        got = {"port f32": port.val(data=split, batch=32, plots=False),
               "port bf16": port.val(data=split, batch=32, half=True, plots=False),
               "JAX f32": jax_model.val(data=split, batch=32, plots=False),
               "JAX bf16": jax_model.val(data=split, batch=32, plots=False, half=True)}
    for name, res in got.items():
        print(f"{name:10s}", "  ".join(f"{k.split('/')[-1]} {v:.6f}" for k, v in res.items()))
    print(f"mAP50-95: port to JAX {abs(got['port f32'][key] - got['JAX f32'][key]):.2e} (f32), "
          f"{abs(got['port bf16'][key] - got['JAX bf16'][key]):.2e} (bf16); "
          f"JAX bf16 to f32 {abs(got['JAX bf16'][key] - got['JAX f32'][key]):.2e}")
