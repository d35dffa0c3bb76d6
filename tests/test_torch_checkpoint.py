"""The port's checkpoint reader and weight bridge against flax.

The reader (spectrogram_yolov11_torch/engine/checkpoint.py) decodes flax's
msgpack without flax or msgpack; here it must give the same tree as
flax.serialization.msgpack_restore, byte for byte, and the bridge must carry
every leaf of the trained checkpoint into the torch model with none left over.
"""

import json
from pathlib import Path

import msgpack
import numpy as np
import pytest
from flax import serialization

from spectrogram_yolov11_torch.engine.checkpoint import load_checkpoint, msgpack_unpack
from spectrogram_yolov11_torch.nn.tasks import build_model
from spectrogram_yolov11_torch.utils.jax_compat import _torch_name, variables_to_state_dict

CKPT = Path(__file__).resolve().parent.parent / "runs_artifacts" / "spectrogram_yolo11n.ckpt"


def _assert_same_tree(a, b, path="root"):
    assert type(a) is type(b), f"{path}: {type(a)} vs {type(b)}"
    if isinstance(a, dict):
        assert list(a) == list(b), f"{path}: keys differ"
        for k in a:
            _assert_same_tree(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, list):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same_tree(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape, f"{path}: {a.dtype}{a.shape} vs {b.dtype}{b.shape}"
        assert a.tobytes() == b.tobytes(), f"{path}: bytes differ"
    else:
        assert a == b, f"{path}: {a!r} vs {b!r}"


def _walk(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _walk(v)
        else:
            yield v


@pytest.fixture(scope="module")
def ckpt_blob():
    with open(CKPT, "rb") as f:
        n = int.from_bytes(f.read(8), "little")
        meta = json.loads(f.read(n).decode())
        return meta, f.read()


def test_reader_matches_flax_msgpack_restore(ckpt_blob):
    meta, blob = ckpt_blob
    ours = msgpack_unpack(blob)
    ref = serialization.msgpack_restore(blob)
    _assert_same_tree(ours, ref)
    tree, meta2 = load_checkpoint(CKPT)
    assert tree["ema"] is None and meta2["nc"] == 2 and meta2["names"] == {0: "LTE", 1: "RF"}
    assert meta2["model_yaml"] == meta["model_yaml"]


@pytest.mark.parametrize(
    "value",
    [
        {"ints": [0, 127, 128, 255, 65535, 65536, 2**32, 2**63 - 1, -1, -32, -33, -129, -40000, -(2**40)]},
        {"floats": [1.5, -2.25e-30, float(np.float32(3.1))], "none": None, "bools": [True, False]},
        {"s" * 40: "x" * 300, "bin": b"\x00\x01" * 200, "nested": {str(i): [i] * 20 for i in range(20)}},
        {"arr": np.arange(24, dtype=np.int16).reshape(2, 3, 4), "f64": np.linspace(0, 1, 7), "u8": np.zeros(0, np.uint8)},
        {"scalar": np.float32(2.5), "iscalar": np.int64(-7)},
    ],
    ids=["ints", "floats_nil_bool", "str_bin_map16", "ndarray_ext", "npscalar_ext"],
)
def test_reader_decodes_each_msgpack_type(value):
    blob = serialization.msgpack_serialize(value)
    _assert_same_tree(msgpack_unpack(blob), serialization.msgpack_restore(blob))


def test_reader_decodes_float32_and_wide_containers():
    plain = msgpack.packb([1.25, list(range(70000)), {str(i): i for i in range(70000)}], use_single_float=True)
    assert msgpack_unpack(plain) == msgpack.unpackb(plain, strict_map_key=False)


def test_reader_rejects_trailing_bytes():
    with pytest.raises(ValueError, match="trailing"):
        msgpack_unpack(msgpack.packb(1) + b"\x00")


@pytest.mark.parametrize(
    "flax_name,torch_name",
    [("model_6", "model.6"), ("cv3_0_1_0", "cv3.0.1.0"), ("conv_h", "conv_h"), ("bn1", "bn1"), ("m_0", "m.0"), ("cv1", "cv1")],
)
def test_bridge_names(flax_name, torch_name):
    assert _torch_name(flax_name) == torch_name


def test_bridge_uses_every_leaf_strict():
    tree, meta = load_checkpoint(CKPT)
    variables = tree.get("ema") or tree["variables"]
    n_leaves = sum(1 for col in variables.values() for _ in _walk(col))
    assert n_leaves == 421
    sd = variables_to_state_dict(variables)
    n_bookkeeping = sum(k.endswith("num_batches_tracked") for k in sd)
    assert len(sd) - n_bookkeeping == n_leaves
    model = build_model(meta["model_yaml"], nc=meta["nc"])
    assert set(model.state_dict()) == set(sd)
    model.load_state_dict(sd, strict=True)
    # spot-check the layout conversions: HWIO -> OIHW, depthwise, BN stats, bare HCoordAtt conv
    p, s = variables["params"], variables["batch_stats"]
    k = p["model_6"]["m_0"]["m_1"]["cv1"]["conv"]["kernel"]
    assert k.shape == (3, 3, 32, 32)
    np.testing.assert_array_equal(model.model[6].m[0].m[1].cv1.conv.weight.detach().numpy(), k.transpose(3, 2, 0, 1))
    dw = p["model_27"]["cv3_0_0_0"]["conv"]["kernel"]
    assert model.model[27].cv3[0][0][0].conv.weight.shape == (dw.shape[3], 1, 3, 3)
    hca = p["model_14"]["cv1"]["kernel"]
    np.testing.assert_array_equal(model.model[14].cv1.weight.detach().numpy(), hca.transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(model.model[0].bn.running_var.numpy(), s["model_0"]["bn"]["var"])
    assert model.model[0].bn.eps == 1e-3


def test_bridge_rejects_unknown_leaf():
    with pytest.raises(KeyError):
        variables_to_state_dict({"params": {"model_0": {"conv": {"weird": np.zeros(3, np.float32)}}}})
