"""The weight bridge between flax {params, batch_stats} numpy trees and a torch
state dict: `variables_to_state_dict` loads JAX weights into the port, and
`state_dict_to_variables` turns the port's back into flax trees.

This inverts spectrogram_yolov11_tpu/utils/torch_compat.py:translate_key. The
JAX package names its submodules after the torch originals, with list indices
merged into the name (`model_6/m_0/m_1/cv1/conv/kernel`); here each trailing
run of `_<digits>` becomes dotted indices again (`model.6.m.0.m.1.cv1.conv`),
and the reverse bridge merges them back as translate_key does.

Leaves:
  conv `kernel` (kh, kw, cin/g, cout) HWIO -> `weight` (cout, cin/g, kh, kw) OIHW
  conv `bias`                                 -> `bias`
  BN params `scale` / `bias`                  -> `weight` / `bias`
  BN batch_stats `mean` / `var`               -> `running_mean` / `running_var`
Every BN also gets torch's `num_batches_tracked` bookkeeping buffer (0), so the
result loads with `strict=True`.
"""

from __future__ import annotations

from typing import Dict, Iterator, Tuple

import numpy as np
import torch

_PARAM_LEAF = {"kernel": "weight", "bias": "bias", "scale": "weight"}
_STAT_LEAF = {"mean": "running_mean", "var": "running_var"}


def _torch_name(tok: str) -> str:
    """'cv3_0_1_0' -> 'cv3.0.1.0'; 'conv_h' and 'bn1' stay as they are."""
    parts = tok.split("_")
    i = len(parts)
    while i > 1 and parts[i - 1].isdigit():
        i -= 1
    return ".".join(["_".join(parts[:i]), *parts[i:]])


def _leaves(tree: dict, prefix: Tuple[str, ...] = ()) -> Iterator[Tuple[Tuple[str, ...], np.ndarray]]:
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def variables_to_state_dict(variables: dict) -> Dict[str, torch.Tensor]:
    """flax variables {params, batch_stats} -> state dict of the port's model."""
    out: Dict[str, torch.Tensor] = {}
    for path, leaf in _leaves(variables.get("params", {})):
        key = ".".join(_torch_name(t) for t in path[:-1])
        arr = np.asarray(leaf, np.float32)
        if path[-1] == "kernel":
            arr = arr.transpose(3, 2, 0, 1)
        elif path[-1] == "scale":
            out[f"{key}.num_batches_tracked"] = torch.zeros((), dtype=torch.long)
        elif path[-1] != "bias":
            raise KeyError(f"unexpected parameter leaf {'/'.join(path)}")
        out[f"{key}.{_PARAM_LEAF[path[-1]]}"] = torch.tensor(np.ascontiguousarray(arr))
    for path, leaf in _leaves(variables.get("batch_stats", {})):
        if path[-1] not in _STAT_LEAF:
            raise KeyError(f"unexpected batch_stats leaf {'/'.join(path)}")
        key = ".".join(_torch_name(t) for t in path[:-1])
        out[f"{key}.{_STAT_LEAF[path[-1]]}"] = torch.tensor(np.asarray(leaf, np.float32))
    return out


def _flax_path(torch_key: str) -> Tuple[str, ...]:
    """'model.6.m.0.cv1.conv' -> ('model_6', 'm_0', 'cv1', 'conv'): numeric tokens merge into the name before them."""
    out: list = []
    for tok in torch_key.split("."):
        if tok.isdigit() and out:
            out[-1] = f"{out[-1]}_{tok}"
        else:
            out.append(tok)
    return tuple(out)


def state_dict_to_variables(state_dict: Dict[str, torch.Tensor]) -> dict:
    """A state dict of the port's model (or any {name: tensor} keyed by its
    parameter and BN buffer names: grads, optimizer moments) -> flax
    {params, batch_stats} numpy trees, each leaf in its tensor's dtype. 4-D
    `weight` -> `kernel` (HWIO), BN's 1-D `weight` -> `scale`, `bias` ->
    `bias`, `running_mean` / `running_var` -> batch_stats `mean` / `var`;
    `num_batches_tracked` has no flax counterpart and is left out."""
    trees: Dict[str, dict] = {"params": {}, "batch_stats": {}}
    for name, t in state_dict.items():
        key, leaf = name.rsplit(".", 1)
        if leaf == "num_batches_tracked":
            continue
        arr = np.array(t.detach().cpu())  # a copy: the tree does not follow the tensor's later updates
        if leaf == "weight":
            tree, flax_leaf = "params", "kernel" if arr.ndim == 4 else "scale"
            arr = arr.transpose(2, 3, 1, 0) if arr.ndim == 4 else arr
        elif leaf == "bias":
            tree, flax_leaf = "params", "bias"
        elif leaf in ("running_mean", "running_var"):
            tree, flax_leaf = "batch_stats", {"running_mean": "mean", "running_var": "var"}[leaf]
        else:
            raise KeyError(f"unexpected state dict entry {name}")
        node = trees[tree]
        for tok in _flax_path(key):
            node = node.setdefault(tok, {})
        node[flax_leaf] = np.ascontiguousarray(arr)
    return trees
