"""YOLO(ckpt).train on the port against the JAX package's, on the CPU.

The trained spectrogram_yolo11n (full width and depth) trains on a small
synthetic spectrogram split that the port's generator writes into a
temporary directory (8 train and 4 val gray PNGs at 64 px). Both facades
train it for 2 epochs at 64 px, B = 2 (4 steps per epoch), SGD, amp=False,
close_mosaic=1 (the second epoch without mosaic), save_period=1, in the
default device-augment mode. A tiny random model was tried first: its
detections' scores lie so close together that weights 1e-5 apart reorder
them, and its mAP on 4 images then jumps by 1e-2 to 2e-1 between two equally
valid runs (the port's validator gives JAX's metrics exactly on JAX's
weights); the trained model's do not.

Both sides must see the same images. JAX's production separable sampler
(bf16 matmuls) misses the exact bilinear by a grey level at a few pixels, and
its exact gather form, _augment_one_separable_gather, does too once it is
jitted into JAX's step: XLA on the CPU fuses its multiplies and adds and
divides by constants as products with their reciprocals (one grey level at
0.02-0.16 % of the values of a small colour dataset's batches; the tiny
model's loss items then lay up to 3.3e-4 relative from the port's, and within
2e-6 when the port trained on those same jitted images). So in JAX's run
augment_batch is monkeypatched to a jax.pure_callback out of the jitted step
that computes the exact images on the host with the port's augment_batch,
which tests/test_torch_device_augment.py holds array-equal to JAX's
_augment_one and _augment_one_separable_gather run op by op (those, run op
by op inside the callback, give the same images and cost 7 s more of
compiling). Nothing in the JAX package changes.

Tolerances, with the values a CPU run measured (CHANGES.md):
- per-epoch loss items of the two results.csv files within 1e-4 relative;
- the final EMA (the weights both facades hold after training) per leaf
  within 1e-4 of the leaf's largest magnitude;
- the val metrics of each epoch within 1e-4.

Checkpoints: the port's last.ckpt and best.ckpt read by JAX's
load_checkpoint: the weights and the EMA equal to the port's trainer's at
the end, the optimizer state accepted by JAX's flat_opt_state, best.ckpt
stripped (no EMA, no optimizer state); the msgpack encoder's bytes equal to
flax's. A JAX-written checkpoint (its epoch-0 checkpoint) resumed by the
port restores weights, EMA, moments (JAX's flat vectors, split in
make_flat_spec's order), step count and EMA updates exactly, and trains on.
On the CPU, one epoch and a resume to two equal two epochs straight within
1e-6 relative, with nbs = batch (an optimizer step every iteration): a
resume starts with last_opt_step = -1 and an empty grad buffer, as JAX's and
the reference's do, so with accumulation the resumed run steps at its first
iteration where the straight run accumulates.
"""

import csv
import shutil
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_train_step import one_torch_thread  # noqa: F401 (autouse: one torch thread in this module)

import spectrogram_yolov11_tpu.ops.device_augment as jax_device_augment
import spectrogram_yolov11_tpu.utils.callbacks as jax_callbacks
from spectrogram_yolov11_torch import YOLO
from spectrogram_yolov11_torch.data.dataset import check_det_dataset
from spectrogram_yolov11_torch.data.imageio import imread
from spectrogram_yolov11_torch.engine.checkpoint import load_checkpoint as port_load_checkpoint
from spectrogram_yolov11_torch.engine.checkpoint import msgpack_pack
from spectrogram_yolov11_torch.engine.trainer import DetectionTrainer
from spectrogram_yolov11_torch.ops.device_augment import augment_batch
from spectrogram_yolov11_torch.utils.jax_compat import state_dict_to_variables
from spectrogram_yolov11_tpu.engine import optim as jopt
from spectrogram_yolov11_tpu.engine.checkpoint import load_checkpoint
from spectrogram_yolov11_tpu.engine.model import YOLO as JaxYOLO

CKPT = Path(__file__).resolve().parent.parent / "runs_artifacts" / "spectrogram_yolo11n.ckpt"
IMGSZ, BATCH, EPOCHS = 64, 2, 2
TRAIN = dict(epochs=EPOCHS, close_mosaic=1, optimizer="SGD", amp=False, imgsz=IMGSZ, batch=BATCH, workers=2,
             save_period=1, plots=False, exist_ok=True, name="run")
ITEMS_RTOL, EMA_FRAC, METRIC_TOL, RESUME_RTOL = 1e-4, 1e-4, 1e-4, 1e-6
LOSS_COLS = ("train/box_loss", "train/cls_loss", "train/dfl_loss")


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = tmp_path_factory.mktemp("train_loop")
    data = {"path": str(root / "data"), "train": "images/train", "val": "images/val", "synthetic": "spectrogram",
            "n_train": 8, "n_val": 4, "gen_imgsz": IMGSZ, "seed": 0, "names": {0: "LTE", 1: "RF"}}
    check_det_dataset(data)
    return root, data, CKPT


def _rows(path: Path) -> list:
    with open(path) as f:
        return [{k: float(v) for k, v in r.items()} for r in csv.DictReader(f)]


def _leaves(tree, pre=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, pre + (k,))
        elif v is not None:
            yield "/".join(pre + (k,)), np.asarray(v)


def _port_train(ckpt, data, project, **kw):
    """YOLO(ckpt).train on the CPU; returns (facade, trainer, the model's
    state and the EMA as flax trees at on_train_end, before the EMA's weights
    are copied onto the model)."""
    yolo, seen = YOLO(ckpt, device="cpu"), {}

    def at_end(t):
        seen["variables"] = state_dict_to_variables(t.model.state_dict())
        ema = state_dict_to_variables(dict(zip(t.param_names, t.state["ema"]["params"])))
        ema["batch_stats"] = state_dict_to_variables(dict(zip(t.stat_names, t.state["ema"]["batch_stats"])))[
            "batch_stats"]
        seen["ema"] = ema

    yolo.add_callback("on_train_end", at_end)
    metrics = yolo.train(data=data, project=str(project), **{**TRAIN, **kw})
    return yolo, metrics, seen


def _exact_augment_batch(src, regions, pads, inv, hsv_r, separable=False):
    """The exact images, computed on the host out of JAX's jitted step."""

    def host(*args):
        return augment_batch(*(torch.from_numpy(np.array(a)) for a in args)).numpy()

    b, s = src.shape[0], src.shape[2]
    return jax.pure_callback(host, jax.ShapeDtypeStruct((b, s, s, 3), jnp.float32), src, regions, pads, inv, hsv_r)


@pytest.fixture(scope="module")
def runs(setup):
    root, data, ckpt = setup
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_callbacks, "_INTEGRATIONS", ())  # the logging integrations touch no result
        mp.setattr(jax_device_augment, "augment_batch", _exact_augment_batch)
        jax_yolo = JaxYOLO(str(ckpt))
        jax_metrics = jax_yolo.train(data=data, project=str(root / "jax"), device="cpu:0", **TRAIN)
    port, port_metrics, seen = _port_train(ckpt, data, root / "port")
    return {"jax": (jax_yolo, jax_metrics, root / "jax" / "run"), "port": (port, port_metrics, root / "port" / "run"),
            "seen": seen}


def test_two_epochs_match_jax(runs):
    jax_yolo, jax_metrics, jax_dir = runs["jax"]
    port, port_metrics, port_dir = runs["port"]
    got, ref = _rows(port_dir / "results.csv"), _rows(jax_dir / "results.csv")
    assert len(got) == len(ref) == EPOCHS and list(got[0]) == list(ref[0])
    items_err = max(abs(g[k] - r[k]) / abs(r[k]) for g, r in zip(got, ref) for k in LOSS_COLS)
    metric_err = max(abs(g[k] - r[k]) for g, r in zip(got, ref) for k in r if k.startswith(("metrics", "fitness")))
    print(f"loss items {[[g[k] for k in LOSS_COLS] for g in got]} (JAX {[[r[k] for k in LOSS_COLS] for r in ref]}), "
          f"worst {items_err:.2e} relative; metrics worst {metric_err:.2e}")
    assert items_err <= ITEMS_RTOL and metric_err <= METRIC_TOL
    assert port_metrics.keys() == jax_metrics.keys()
    assert max(abs(port_metrics[k] - jax_metrics[k]) for k in jax_metrics) <= METRIC_TOL

    ref_ema = dict(_leaves(jax.tree_util.tree_map(np.asarray, jax_yolo.variables)))
    got_ema = dict(_leaves(state_dict_to_variables(port.model.state_dict())))
    assert got_ema.keys() == ref_ema.keys()
    worst, leaf = max((float(np.abs(got_ema[k] - r).max() / np.abs(r).max()), k)
                      for k, r in ref_ema.items() if np.abs(r).max() > 0)
    print(f"final EMA: worst leaf {leaf}, {worst:.2e} of its max")
    assert worst <= EMA_FRAC
    assert not port.model.training and port.predictor is None


def test_checkpoints_load_in_jax(runs):
    port, _, port_dir = runs["port"]
    seen = runs["seen"]
    tree, meta = load_checkpoint(port_dir / "weights" / "last.ckpt")
    assert meta["epoch"] == EPOCHS - 1 and meta["updates"] == port.trainer.state["ema_updates"] > 0
    assert meta["nc"] == 2 and meta["names"] == {0: "LTE", 1: "RF"}
    assert meta["model_yaml"] == load_checkpoint(CKPT)[1]["model_yaml"]
    assert meta["train_args"]["epochs"] == EPOCHS and meta["version"]
    for key in ("variables", "ema"):
        got, want = dict(_leaves(tree[key])), dict(_leaves(seen[key]))
        assert got.keys() == want.keys() and all(np.array_equal(got[k], want[k]) for k in want), key
    opt = jopt.OptState(step=tree["opt_state"]["step"], mu=tree["opt_state"]["mu"], nu=tree["opt_state"]["nu"])
    groups = jopt.param_groups(tree["variables"]["params"])
    flat = jopt.flat_opt_state(jax.tree_util.tree_map(jax.numpy.asarray, opt),
                               jopt.make_flat_spec(tree["variables"]["params"], groups))
    assert flat.mu.shape == flat.nu.shape == (sum(v.size for _, v in _leaves(tree["variables"]["params"])),)
    assert int(flat.step) == port.trainer.state["opt"]["step"] > 0
    assert np.array_equal(np.asarray(flat.mu), np.concatenate(
        [np.asarray(m).ravel() for m in jax.tree_util.tree_leaves(tree["opt_state"]["mu"])]))
    best, best_meta = load_checkpoint(port_dir / "weights" / "best.ckpt")
    assert best["ema"] is None and best["opt_state"] is None and best_meta["best_fitness"] == meta["best_fitness"]
    with open(port_dir / "weights" / "last.ckpt", "rb") as f:
        n = int.from_bytes(f.read(8), "little")
        f.seek(8 + n)
        blob = f.read()
    from flax import serialization

    assert msgpack_pack(port_load_checkpoint(port_dir / "weights" / "last.ckpt")[0]) == blob
    assert serialization.msgpack_serialize(tree) == blob


def test_port_resumes_a_jax_checkpoint(runs, setup):
    root, data, ckpt = setup
    jax_ckpt = runs["jax"][2] / "weights" / "epoch0.ckpt"
    tree, meta = load_checkpoint(jax_ckpt)
    assert tree["opt_state"]["mu"].ndim == 1  # JAX saves its flat vectors
    seen = {}

    def at_start(t):
        seen["params"] = dict(_leaves(state_dict_to_variables(t.model.state_dict())))
        seen["mu"] = dict(_leaves(state_dict_to_variables(dict(zip(t.param_names, t.state["opt"]["mu"])))))
        ema = state_dict_to_variables(dict(zip(t.param_names, t.state["ema"]["params"])))
        ema["batch_stats"] = state_dict_to_variables(dict(zip(t.stat_names, t.state["ema"]["batch_stats"])))[
            "batch_stats"]
        seen["ema"] = dict(_leaves(ema))
        seen["counts"] = (t.start_epoch, t.state["opt"]["step"], t.state["ema_updates"], t.best_fitness)

    yolo = YOLO(ckpt, device="cpu")
    yolo.add_callback("on_train_start", at_start)
    metrics = yolo.train(data=data, project=str(root / "resume_jax"), resume=str(jax_ckpt), **TRAIN)
    assert seen["counts"] == (1, int(tree["opt_state"]["step"]), meta["updates"], meta["best_fitness"])
    assert all(np.array_equal(seen["params"][k], v) for k, v in _leaves(tree["variables"]))
    assert all(np.array_equal(seen["ema"][k], v) for k, v in _leaves(tree["ema"]))
    spec = jopt.make_flat_spec(tree["variables"]["params"], jopt.param_groups(tree["variables"]["params"]))
    mu = dict(_leaves(jax.tree_util.tree_map(np.asarray, jopt.unflatten_tree(tree["opt_state"]["mu"], spec))))
    assert all(np.array_equal(seen["mu"][f"params/{k}"], v) for k, v in mu.items())
    assert len(_rows(root / "resume_jax" / "run" / "results.csv")) == 1 and 0 <= metrics["fitness"] <= 1


def test_resume_equals_a_straight_run(setup):
    root, data, ckpt = setup
    kw = dict(nbs=BATCH)  # an optimizer step every iteration
    straight, straight_metrics, _ = _port_train(ckpt, data, root / "straight", **kw)
    first = root / "straight" / "run" / "weights" / "epoch0.ckpt"
    resumed, resumed_metrics, _ = _port_train(ckpt, data, root / "resumed", resume=str(first), **kw)
    assert resumed.trainer.start_epoch == 1
    a, b = straight.model.state_dict(), resumed.model.state_dict()
    worst = max(float((a[k] - b[k]).abs().max() / a[k].abs().max().clamp_min(1e-30)) for k in a
                if a[k].is_floating_point())
    print(f"resumed against straight: worst {worst:.2e} of the leaf's max")
    assert worst <= RESUME_RTOL
    assert all(abs(resumed_metrics[k] - straight_metrics[k]) <= RESUME_RTOL for k in straight_metrics)
    ref = _rows(root / "straight" / "run" / "results.csv")[-1]
    got = _rows(root / "resumed" / "run" / "results.csv")[-1]
    assert all(abs(got[k] - ref[k]) <= RESUME_RTOL * max(abs(ref[k]), 1e-6) for k in ref)


@pytest.mark.parametrize("kw,what,item", [
    ({"degrees": 10.0}, "device_augment='auto' with degrees", "item 7b"),
    ({"device_augment": False}, "device_augment=False", "item 7b"), ({"mixup": 0.2}, "mixup", "item 7b"),
    ({"multi_scale": True}, "multi_scale", "item 7b"), ({"cache": "disk"}, "cache='disk'", "item 7 ")])
def test_unported_options_raise(setup, kw, what, item, tmp_path):
    """The options that raised until their ROADMAP.md `item` was closed are
    taken now: the trainer builds its train split in host-augment mode for
    the augmentation settings (a sample carries the augmented `img`), and
    with cache='disk' a sample writes its images' .npy sidecars, equal to the
    decoded images. tests/test_torch_host_augment.py holds them to JAX."""
    root, data, ckpt = setup
    if kw.get("cache"):  # the sidecars go beside the images: a copy of the split
        shutil.copytree(data["path"], tmp_path / "data")
        data = dict(data, path=str(tmp_path / "data"))
    trainer = DetectionTrainer(YOLO(ckpt, device="cpu").model, {**TRAIN, **kw, "data": data, "device": "cpu",
                                                                "project": str(root / "refused")})
    ds = trainer.build_dataset()
    sample = ds.get_item(0, np.random.default_rng(0))
    if kw.get("cache"):
        npy = Path(ds.im_files[0]).with_suffix(".npy")
        assert ds.transform.device_mode and np.array_equal(np.load(npy), imread(ds.im_files[0])), what
    else:
        assert not ds.transform.device_mode and sample["img"].shape == (IMGSZ, IMGSZ, 3), what


def test_other_nc_and_yaml_models_raise(setup, tmp_path):
    """Another nc and model YAMLs train now (held to JAX in tests/test_torch_scratch.py): the trainer rebuilds
    the head for the data's nc, grafting the rest. A YAML whose head is not Detect raises, naming item 10."""
    root, data, ckpt = setup
    trainer = DetectionTrainer(YOLO(ckpt, device="cpu").model, {**TRAIN, "data": dict(data, names={0: "a", 1: "b", 2: "c"}),
                                                                "device": "cpu", "project": str(root / "nc")})
    trainer.setup_model()
    assert trainer.model.nc == 3 and trainer.rebuilt["nc"] == (2, 3) and trainer.rebuilt["grafted"] > 400
    seg = tmp_path / "seg.yaml"
    seg.write_text("nc: 2\nbackbone:\n  - [-1, 1, Conv, [16, 3, 2]]\nhead:\n  - [[0], 1, Segment, [nc, 32, 64]]\n")
    for model in (str(seg), "yolo11n-pose.yaml"):
        with pytest.raises(NotImplementedError, match="ROADMAP.*item 10"):
            YOLO(model)
