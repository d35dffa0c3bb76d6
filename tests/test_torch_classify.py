"""The port's classify model, loss, metrics and data against the JAX package's, on the CPU.

- The models: `yolo11n-cls.yaml` (nc 3) and `yolo11-cls-resnet18.yaml`
  (nc 10) build with JAX's leaf paths and shapes through the weight bridge
  (the Classify head's `linear` a flax Dense, transposed; TorchVision's stem,
  stages and downsample BN among them), and a seeded JAX variables tree
  carried across and back equals itself leaf for leaf. Their forward at
  32-64 px, B = 2, in eval and in training (BN on batch statistics): the
  logits within 1e-4 of their max |value|, and in training the moved BN
  statistics within 1e-4 too. The Classify head alone (a list input
  concatenated) and TorchVision alone (its pooled form too) the same;
  resnet50 raises NotImplementedError as JAX's. yolo11n-cls's fused
  bottlenecks are the four of layers 6 and 8 (C = 32, 64).
- classification_loss: the loss and its gradient within 1e-6.
- ClassifyMetrics: results_dict, fitness and keys equal to JAX's, at k = 5
  and k = 3.
- gen_cls_shapes: the JPEG bytes equal JAX's (cv2's), the 3-shape schema
  and a names list with a slash.
- check_cls_dataset on a folder, a bare name and a YAML with `names`:
  the same dict as JAX's.
- ClassificationDataset: the samples' order, and every train sample (same
  Generator) and val sample byte-equal to JAX's at three sizes.
"""

import functools
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_pose import _close, _leaves, _seeded
from test_torch_train_step import one_torch_thread  # noqa: F401 (autouse: one torch thread in this module)

from spectrogram_yolov11_torch.data.dataset import ClassificationDataset, check_cls_dataset
from spectrogram_yolov11_torch.data.synth import gen_cls_shapes
from spectrogram_yolov11_torch.nn.modules import Classify, TorchVision
from spectrogram_yolov11_torch.nn.tasks import ClassificationModel, build_model, yaml_model_load
from spectrogram_yolov11_torch.ops.losses import classification_loss
from spectrogram_yolov11_torch.ops.metrics import ClassifyMetrics
from spectrogram_yolov11_torch.utils.jax_compat import state_dict_to_variables, variables_to_state_dict
from spectrogram_yolov11_tpu.data import dataset as jax_dataset
from spectrogram_yolov11_tpu.data.dataset import ClassificationDataset as JaxClassificationDataset
from spectrogram_yolov11_tpu.data.synth import gen_cls_shapes as jax_gen_cls_shapes
from spectrogram_yolov11_tpu.nn.modules.block import TorchVision as JaxTorchVision
from spectrogram_yolov11_tpu.nn.modules.head import Classify as JaxClassify
from spectrogram_yolov11_tpu.nn.tasks import build_model as jax_build_model
from spectrogram_yolov11_tpu.ops.losses import classification_loss as jax_classification_loss
from spectrogram_yolov11_tpu.ops.metrics import ClassifyMetrics as JaxClassifyMetrics

REL = 1e-4  # of each output's max |value|
MODELS = (("yolo11n-cls.yaml", 3, 64), ("yolo11-cls-resnet18.yaml", 10, 64))


@functools.lru_cache(maxsize=None)
def jax_cls(cfg: str, nc: int) -> tuple:
    """(the model dict at nc, JAX's model, its init's shapes), built once per process (the engine tests take them)."""
    d = {k: v for k, v in yaml_model_load(cfg).items() if k != "yaml_file"}
    d["nc"] = nc
    jm = jax_build_model(dict(d), verbose=False)
    shapes = jax.eval_shape(lambda: jm.graph.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)), train=False))
    return d, jm, shapes


@pytest.fixture(scope="module", params=MODELS, ids=lambda m: m[0].split(".")[0])
def cls_model(request):
    """(JAX model, seeded numpy variables, the port's model carried from them, imgsz)."""
    cfg, nc, imgsz = request.param
    d, jm, shapes = jax_cls(cfg, nc)
    variables = _seeded(shapes)
    return jm, variables, build_model(dict(d), variables=variables), imgsz


def test_builds_as_jax_and_round_trips_the_bridge(cls_model):
    jm, variables, tm, _ = cls_model
    assert isinstance(tm, ClassificationModel) and tm.task == "classify" and tm.stride == (1.0,)
    assert isinstance(tm.model[-1], Classify) and tm.nc == jm.nc
    back, ref = dict(_leaves(state_dict_to_variables(tm.state_dict()))), dict(_leaves(variables))
    assert back.keys() == ref.keys()
    for k, v in ref.items():
        assert back[k].shape == v.shape and np.array_equal(back[k], v), k
    head = f"params/model_{len(tm.model) - 1}"
    assert back[f"{head}/linear/kernel"].shape == (1280, tm.nc) and f"{head}/conv/bn/scale" in back
    if isinstance(tm.model[0], TorchVision):
        assert "params/model_0/layer2_0/downsample_0/kernel" in back and "batch_stats/model_0/layer4_1/bn2/var" in back
        assert tm.bottlenecks() == {"fused": [], "gated": []}
    else:
        assert tm.bottlenecks() == {"fused": [(6, 32), (6, 32), (8, 64), (8, 64)], "gated": []}


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_forward_matches_jax(cls_model, train):
    jm, variables, tm, s = cls_model
    x = np.random.default_rng(1).uniform(0, 1, (2, s, s, 3)).astype(np.float32)
    if train:
        ref, mut = jax.jit(lambda v, a: jm.graph.apply(v, a, train=True, mutable=["batch_stats"]))(
            variables, jnp.asarray(x))
        tm = build_model(dict(tm.yaml), variables=variables).train()
        got = tm(torch.from_numpy(x).permute(0, 3, 1, 2))
        stats = dict(_leaves(state_dict_to_variables(tm.state_dict())["batch_stats"]))
        for k, v in _leaves(jax.tree_util.tree_map(np.asarray, mut["batch_stats"])):
            _close(stats[k], v, k, REL)
    else:
        ref = jax.jit(lambda v, a: jm.apply(v, a, train=False))(variables, jnp.asarray(x))
        with torch.inference_mode():
            got = tm.eval()(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert got.shape == (2, tm.nc)
    _close(got.detach(), ref, "logits", REL)


def _module_pair(jax_module, torch_module, x: list):
    """The JAX module's eval output and the port's on NHWC inputs `x` (the
    module's call takes the list itself when it holds more than one), on the
    JAX module's seeded variables carried across."""
    arg = [jnp.asarray(a) for a in x] if len(x) > 1 else jnp.asarray(x[0])
    v = _seeded(jax.eval_shape(lambda: jax_module.init(jax.random.PRNGKey(0), arg)))
    torch_module.load_state_dict(variables_to_state_dict(v), strict=True)
    ref = jax.jit(jax_module.apply)(v, arg)
    with torch.inference_mode():
        xt = [torch.from_numpy(a).permute(0, 3, 1, 2) for a in x]
        got = torch_module.eval()(xt if len(x) > 1 else xt[0])
    return got, ref


def test_heads_alone_match_jax():
    rng = np.random.default_rng(2)
    x = rng.normal(0, 1, (2, 6, 5, 24)).astype(np.float32)
    # the head on a list of maps, concatenated on channels (JAX's Classify takes the same list)
    got, ref = _module_pair(JaxClassify(24, 7, 3, 2), Classify(24, 7, 3, 2), [x[..., :8], x[..., 8:]])
    _close(got, ref, "Classify", REL)
    img = rng.uniform(0, 1, (2, 40, 40, 3)).astype(np.float32)
    for unwrap, model in ((True, "resnet18"), (False, "resnet34")):
        got, ref = _module_pair(JaxTorchVision(model, unwrap=unwrap), TorchVision(model, unwrap=unwrap), [img])
        assert got.shape == ((2, 512, 2, 2) if unwrap else (2, 512))
        _close(got.permute(0, 2, 3, 1) if unwrap else got, ref, model, REL)
    with pytest.raises(NotImplementedError, match="resnet18/34"):
        TorchVision("resnet50")
    with pytest.raises(NotImplementedError, match="resnet18/34"):
        JaxTorchVision("resnet50").init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)))


def test_classification_loss_matches_jax():
    rng = np.random.default_rng(3)
    logits = rng.normal(0, 3, (16, 10)).astype(np.float32)
    labels = rng.integers(0, 10, 16).astype(np.int32)
    (ref, ref_items), ref_g = jax.value_and_grad(lambda z: jax_classification_loss(z, jnp.asarray(labels)),
                                                 has_aux=True)(jnp.asarray(logits))
    z = torch.from_numpy(logits).requires_grad_(True)
    loss, items = classification_loss(z, torch.from_numpy(labels))
    (g,) = torch.autograd.grad(loss, z)
    loss, items = loss.detach(), items.detach()
    assert items.shape == (1,) and float(items[0]) == float(loss)
    assert abs(float(loss) - float(ref)) <= 1e-6 and abs(float(items[0]) - float(ref_items[0])) <= 1e-6
    assert np.abs(g.numpy() - np.asarray(ref_g)).max() <= 1e-6


@pytest.mark.parametrize("k", [5, 3])
def test_classify_metrics_match_jax(k):
    rng = np.random.default_rng(k)
    targets = rng.integers(0, 6, 40)
    top = np.stack([rng.permutation(6)[:k] for _ in range(40)])
    got, ref = ClassifyMetrics(), JaxClassifyMetrics()
    got.process(targets, top)
    ref.process(targets, top)
    assert got.results_dict == ref.results_dict and got.fitness == ref.fitness and got.keys == ref.keys
    assert got.task == ref.task == "classify" and got.speed == ref.speed


@pytest.fixture(scope="module")
def cls_dirs(tmp_path_factory):
    """The port's and JAX's stand-ins written side by side: (port root, JAX root)."""
    a, b = tmp_path_factory.mktemp("cls_port"), tmp_path_factory.mktemp("cls_jax")
    for root, gen in ((a, gen_cls_shapes), (b, jax_gen_cls_shapes)):
        gen(root, "train", 3, 48)
        gen(root, "val", 2, 40, seed=10_000)
        gen(root, "named", 1, 32, seed=5, names=["a/b", "c", "d", "e"])
    return a, b


def test_gen_cls_shapes_bytes_equal_jax(cls_dirs):
    a, b = cls_dirs
    files = sorted(p.relative_to(a) for p in a.rglob("*.jpg"))
    assert files == sorted(p.relative_to(b) for p in b.rglob("*.jpg")) and len(files) == 9 + 6 + 4
    assert (a / "named" / "a-b" / "00000.jpg").exists()
    for f in files:
        assert (a / f).read_bytes() == (b / f).read_bytes(), f


def test_check_cls_dataset_matches_jax(cls_dirs, tmp_path, monkeypatch):
    a, _ = cls_dirs
    assert check_cls_dataset(a) == jax_dataset.check_cls_dataset(a)
    # a YAML whose train folder is missing: synthesised from its names, by each package into its own copy
    for pkg, fn in (("port", check_cls_dataset), ("jax", jax_dataset.check_cls_dataset)):
        y = tmp_path / pkg / "tiny.yaml"
        y.parent.mkdir()
        y.write_text("path: tiny\ntrain: train\nval: val\nn_per_class: 2\ngen_imgsz: 32\nnames: [x, y]\n")
        out = fn(str(y))
        assert out == {"train": str(tmp_path / pkg / "tiny" / "train"), "val": str(tmp_path / pkg / "tiny" / "val"),
                       "nc": 2, "names": {0: "x", 1: "y"}}
    for f in sorted((tmp_path / "jax" / "tiny").rglob("*.jpg")):
        assert (tmp_path / "port" / "tiny" / f.relative_to(tmp_path / "jax" / "tiny")).read_bytes() == f.read_bytes()
    # a folder without train/: the 3-shape stand-in, 32 + 8 per class (as JAX's; only the port's is written here)
    out = check_cls_dataset(tmp_path / "bare")
    assert out["names"] == {0: "circle", 1: "rectangle", 2: "triangle"} and out["nc"] == 3
    assert len(list(Path(out["train"]).rglob("*.jpg"))) == 96 and len(list(Path(out["val"]).rglob("*.jpg"))) == 24


@pytest.mark.parametrize("augment", [False, True], ids=["val", "train"])
def test_dataset_samples_byte_equal_jax(cls_dirs, augment):
    a, _ = cls_dirs
    for split in ("train", "val"):
        for s in (32, 48, 64):
            got, ref = ClassificationDataset(a / split, s, augment), JaxClassificationDataset(a / split, s, augment)
            assert got.samples == ref.samples and got.names == ref.names and len(got) == len(ref)
            for i in range(len(got)):
                g, r = got.get_item(i, np.random.default_rng(i + 7)), ref.get_item(i, np.random.default_rng(i + 7))
                assert g["img"].shape == (s, s, 3) and g["img"].flags["C_CONTIGUOUS"]
                assert np.array_equal(g["img"], r["img"]) and g["cls"] == r["cls"] and g["cls"].dtype == np.int32
