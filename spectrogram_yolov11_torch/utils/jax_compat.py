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
  dense `kernel` (in, out)                    -> `weight` (out, in) (Linear)
  conv and dense `bias`                       -> `bias`
  BN and LayerNorm params `scale` / `bias`    -> `weight` / `bias`
  BN batch_stats `mean` / `var`               -> `running_mean` / `running_var`
  any other leaf: a bare `self.param` of the fork's modules (GCT `alpha`,
  `gamma`, `beta`; SobelConv `convs_<i>`; ECAAttention and RecycleConv
  `conv`; RecycleConv `trainable_scale`; FGM `alpha`, `beta`; Fusion
  `fusion_weight`; the BiFPN concats' `w`: BARE_PARAMS) -> a parameter of
  the same name and shape
Every BN (every batch_stats `mean`) also gets torch's `num_batches_tracked`
bookkeeping buffer (0), so the result loads with `strict=True`. The reverse
bridge tells a conv's weight from a dense layer's and a norm's by its rank (4,
2, 1), and keeps every other name as a bare leaf.

The optimizer state crosses the same bridge: `opt_state_to_flax` writes the
moments as params-shaped trees (the tree form of JAX's OptState, which its
resume migrates with engine/optim.py:254 flat_opt_state), and
`opt_state_from_flax` reads that form or the flat vectors JAX's trainer
saves, split in the leaf order of engine/optim.py:214 make_flat_spec (the
params tree's leaves with every dict's keys sorted, as jax.tree_util
flattens them).
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Sequence, Tuple

import numpy as np
import torch

_PARAM_LEAF = {"kernel": "weight", "bias": "bias", "scale": "weight"}
_STAT_LEAF = {"mean": "running_mean", "var": "running_var"}
# the fork's bare parameters (nn/modules/fork.py), by leaf name
BARE_PARAMS = frozenset({"alpha", "gamma", "beta", "convs_0", "convs_1", "convs_2", "conv", "trainable_scale",
                         "fusion_weight", "w"})
_KERNEL_TO_TORCH = {4: (3, 2, 0, 1), 2: (1, 0)}  # HWIO -> OIHW; (in, out) -> (out, in)
_KERNEL_TO_FLAX = {4: (2, 3, 1, 0), 2: (1, 0)}


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


def _dotted(key: str, leaf: str) -> str:
    return f"{key}.{leaf}" if key else leaf


def variables_to_state_dict(variables: dict) -> Dict[str, torch.Tensor]:
    """flax variables {params, batch_stats} -> state dict of the port's model."""
    out: Dict[str, torch.Tensor] = {}
    for path, leaf in _leaves(variables.get("params", {})):
        key = ".".join(_torch_name(t) for t in path[:-1])
        arr = np.asarray(leaf, np.float32)
        if path[-1] == "kernel":
            if arr.ndim not in _KERNEL_TO_TORCH:
                raise KeyError(f"unexpected {arr.ndim}-D kernel {'/'.join(path)}")
            arr = arr.transpose(_KERNEL_TO_TORCH[arr.ndim])
        elif path[-1] not in _PARAM_LEAF and path[-1] not in BARE_PARAMS:
            raise KeyError(f"unexpected parameter leaf {'/'.join(path)}")
        out[_dotted(key, _PARAM_LEAF.get(path[-1], path[-1]))] = torch.tensor(np.ascontiguousarray(arr))
    for path, leaf in _leaves(variables.get("batch_stats", {})):
        if path[-1] not in _STAT_LEAF:
            raise KeyError(f"unexpected batch_stats leaf {'/'.join(path)}")
        key = ".".join(_torch_name(t) for t in path[:-1])
        out[_dotted(key, _STAT_LEAF[path[-1]])] = torch.tensor(np.asarray(leaf, np.float32))
        if path[-1] == "mean":
            out[_dotted(key, "num_batches_tracked")] = torch.zeros((), dtype=torch.long)
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
    `weight` -> `kernel` (HWIO), 2-D `weight` -> `kernel` (in, out), a norm's
    1-D `weight` -> `scale`, `bias` -> `bias`, `running_mean` / `running_var`
    -> batch_stats `mean` / `var`, a bare parameter -> a params leaf of its
    name; `num_batches_tracked` has no flax counterpart and is left out."""
    trees: Dict[str, dict] = {"params": {}, "batch_stats": {}}
    for name, t in state_dict.items():
        key, leaf = name.rsplit(".", 1) if "." in name else ("", name)
        if leaf == "num_batches_tracked":
            continue
        arr = t.detach().cpu().numpy().copy()  # a copy: the tree does not follow the tensor's later updates
        if leaf == "weight":
            tree, flax_leaf = "params", "kernel" if arr.ndim in _KERNEL_TO_FLAX else "scale"
            arr = arr.transpose(_KERNEL_TO_FLAX[arr.ndim]) if arr.ndim in _KERNEL_TO_FLAX else arr
        elif leaf in ("running_mean", "running_var"):
            tree, flax_leaf = "batch_stats", {"running_mean": "mean", "running_var": "var"}[leaf]
        elif leaf == "bias" or leaf in BARE_PARAMS:
            tree, flax_leaf = "params", leaf
        else:
            raise KeyError(f"unexpected state dict entry {name}")
        node = trees[tree]
        for tok in _flax_path(key) if key else ():
            node = node.setdefault(tok, {})
        node[flax_leaf] = np.ascontiguousarray(arr)
    return trees


def sorted_leaves(tree: dict, prefix: Tuple[str, ...] = ()) -> Iterator[Tuple[Tuple[str, ...], np.ndarray]]:
    """The tree's leaves in jax.tree_util's order: every dict's keys sorted."""
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from sorted_leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _tree_from_leaves(leaves: Sequence[Tuple[Tuple[str, ...], np.ndarray]]) -> dict:
    tree: dict = {}
    for path, leaf in leaves:
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return tree


def opt_state_to_flax(step: int, names: Sequence[str], mu: Sequence[torch.Tensor],
                      nu: Sequence[torch.Tensor]) -> dict:
    """The optimizer state of the parameters `names` as JAX's OptState in tree
    form: {step int32, mu, nu}, the moments as flax params trees."""
    return {"step": np.asarray(step, np.int32),
            "mu": state_dict_to_variables(dict(zip(names, mu)))["params"],
            "nu": state_dict_to_variables(dict(zip(names, nu)))["params"]}


def opt_state_from_flax(opt_state: dict, names: Sequence[str],
                        params: Sequence[torch.Tensor]) -> Tuple[int, List[torch.Tensor], List[torch.Tensor]]:
    """(step, mu, nu) for the parameters `names` (with their tensors `params`,
    whose shapes give the flat vectors' layout) from JAX's OptState in tree or
    flat form; the moments as f32 tensors shaped as the parameters."""
    template = list(sorted_leaves(state_dict_to_variables(dict(zip(names, params)))["params"]))

    def moments(m) -> List[torch.Tensor]:
        if isinstance(m, np.ndarray):  # flat: make_flat_spec's leaf order
            sizes = [leaf.size for _, leaf in template]
            if m.shape != (sum(sizes),):
                raise ValueError(f"flat optimizer moments of shape {m.shape}, the model has {sum(sizes)} parameters")
            parts = np.split(np.asarray(m, np.float32), np.cumsum(sizes)[:-1])
            m = _tree_from_leaves([(path, p.reshape(leaf.shape)) for (path, leaf), p in zip(template, parts)])
        sd = variables_to_state_dict({"params": m})
        return [sd[n] for n in names]

    return int(opt_state["step"]), moments(opt_state["mu"]), moments(opt_state["nu"])
