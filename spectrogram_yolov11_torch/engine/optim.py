"""The training recipe's optimizer, schedule and EMA, as plain tensor functions.

Counterpart of spectrogram_yolov11_tpu/engine/optim.py: choose_optimizer
(:46), param_groups (:82), lr_at (:98), the global-norm clip at 10 and the
SGD-Nesterov and AdamW rules of apply_updates_flat (:261-291), ema_decay
(:294) and ema_update (:299).

- Three groups: conv kernels (weight decay), BN scales (no decay), biases (no
  decay; their warmup starts at warmup_bias_lr).
- 'auto': SGD (nesterov) when epochs * nb > 10 000, else AdamW at lr0 =
  round(0.002 * 5 / (4 + nc), 6), momentum 0.9 and warmup_bias_lr 0.
- The lr and the momentum come from the iteration `ni` (the trainer passes
  it, as JAX's lr_step): warmup over max(round(warmup_epochs * nb), 100)
  iterations, the main group's lr rising from 0, the biases' falling from
  warmup_bias_lr; then the linear or cosine per-epoch schedule. Adam's bias
  correction counts the optimizer's own steps, and its beta1 is the constant
  `momentum`, with no warmup.
- AdamW's decay is decoupled: p - lr * (m_hat / (sqrt(v_hat) + eps) + wd * p).

The schedule's scalars are computed on the host in float32, as the JAX step
computes them in f32 (exp, cos and pow in double, then rounded to f32: the
correctly rounded f32 value, which XLA gives and numpy's f32 functions do
not always), and reach the card as Python floats, so a step needs no host
sync. The update runs per tensor with torch._foreach_* (a few fused
launches per group on the card) and keeps each tensor's dtype, where the JAX
flat path casts every leaf to f32. torch.optim is not used: its schedules and
its AdamW's order of operations are not the JAX package's.
"""

from __future__ import annotations

import math
from typing import Dict, List, NamedTuple, Sequence, Tuple

import numpy as np
import torch
from torch import nn

GROUPS = ("decay", "bias", "norm")
ADAM_BETA2, ADAM_EPS = 0.999, 1e-8
CLIP_NORM = 10.0
EMA_DECAY, EMA_TAU = 0.9999, 2000.0


class OptConfig(NamedTuple):
    kind: str  # 'sgd' | 'adamw'
    lr0: float
    lrf: float
    momentum: float
    weight_decay: float
    warmup_iters: float
    warmup_bias_lr: float
    warmup_momentum: float
    epochs: int
    nb: int  # batches per epoch
    cos_lr: bool
    clip_norm: float = CLIP_NORM


def choose_optimizer(cfg, nc: int, nb: int) -> OptConfig:
    """The optimizer and its settings from the train args, with JAX's 'auto' rule."""
    kind = str(cfg.optimizer).lower()
    lr0, momentum, warmup_bias_lr = cfg.lr0, cfg.momentum, cfg.warmup_bias_lr
    if kind == "auto":
        if cfg.epochs * nb > 10_000:
            kind = "sgd"
        else:
            kind, lr0, momentum, warmup_bias_lr = "adamw", round(0.002 * 5 / (4 + nc), 6), 0.9, 0.0
    elif kind in {"adam", "adamw", "nadam", "radam", "rmsprop"}:
        kind = "adamw"  # as the JAX package: the Adam family and RMSProp run as AdamW
    else:
        kind = "sgd"
    wi = max(round(cfg.warmup_epochs * nb), 100) if cfg.warmup_epochs > 0 else -1
    return OptConfig(kind=kind, lr0=lr0, lrf=cfg.lrf, momentum=momentum, weight_decay=cfg.weight_decay,
                     warmup_iters=wi, warmup_bias_lr=warmup_bias_lr, warmup_momentum=cfg.warmup_momentum,
                     epochs=cfg.epochs, nb=nb, cos_lr=bool(cfg.cos_lr))


def param_groups(model: nn.Module) -> Dict[str, str]:
    """{parameter name: 'bias' | 'norm' | 'decay'}: every bias, BN scales, every other weight."""
    groups = {}
    for mname, m in model.named_modules():
        for pname, _ in m.named_parameters(recurse=False):
            name = f"{mname}.{pname}" if mname else pname
            groups[name] = "bias" if pname == "bias" else "norm" if isinstance(m, nn.modules.batchnorm._BatchNorm) else "decay"
    return groups


def lr_at(opt: OptConfig, step: int) -> Tuple[float, float, float]:
    """(lr of the main groups, lr of the biases, momentum) at iteration `step`, in float32 as JAX's."""
    f32 = np.float32
    x = f32(step // opt.nb)
    if opt.cos_lr:
        lf = ((f32(1) - f32(math.cos(x * f32(math.pi) / f32(opt.epochs)))) / f32(2)) * f32(opt.lrf - 1) + f32(1)
    else:
        lf = max(f32(1) - x / f32(opt.epochs), f32(0)) * f32(1.0 - opt.lrf) + f32(opt.lrf)
    lr = f32(opt.lr0) * lf
    if opt.warmup_iters > 0 and step < opt.warmup_iters:
        w = min(max(f32(step) / f32(opt.warmup_iters), f32(0)), f32(1))
        wbl = f32(opt.warmup_bias_lr)
        mom = f32(opt.warmup_momentum) + w * f32(opt.momentum - opt.warmup_momentum)  # the difference in double, as JAX's
        return float(w * lr), float(wbl + w * (lr - wbl)), float(mom)
    return float(lr), float(lr), float(f32(opt.momentum))


def clip_grad_norm_(grads: List[torch.Tensor], max_norm: float = CLIP_NORM) -> torch.Tensor:
    """Scale the grads in place by min(1, max_norm / (global norm + 1e-6)), on the card; returns the norm."""
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    torch._foreach_mul_(grads, (max_norm / (norm + 1e-6)).clamp(max=1.0))
    return norm


def sgd_update_(params: List[torch.Tensor], grads: List[torch.Tensor], mu: List[torch.Tensor], lr: float,
                momentum: float, weight_decay: float) -> None:
    """Nesterov SGD with L2 decay, in place: g += wd * p; m = mom * m + g; p -= lr * (g + mom * m).
    `grads` is overwritten."""
    if weight_decay:
        torch._foreach_add_(grads, params, alpha=weight_decay)
    torch._foreach_mul_(mu, momentum)
    torch._foreach_add_(mu, grads)
    torch._foreach_add_(grads, mu, alpha=momentum)
    torch._foreach_add_(params, grads, alpha=-lr)


def adamw_update_(params: List[torch.Tensor], grads: List[torch.Tensor], mu: List[torch.Tensor],
                  nu: List[torch.Tensor], step: int, lr: float, beta1: float, weight_decay: float) -> None:
    """AdamW with decoupled decay, in place, at optimizer step `step` (1-based):
    m = b1 m + (1 - b1) g; v = b2 v + (1 - b2) g^2;
    p -= lr * (m / bc1 / (sqrt(v / bc2) + eps) + wd * p)."""
    f32 = np.float32
    bc1 = float(f32(1) - f32(float(f32(beta1)) ** step))
    bc2 = float(f32(1) - f32(float(f32(ADAM_BETA2)) ** step))
    torch._foreach_mul_(mu, beta1)
    torch._foreach_add_(mu, grads, alpha=1 - beta1)
    torch._foreach_mul_(nu, ADAM_BETA2)
    torch._foreach_addcmul_(nu, grads, grads, value=1 - ADAM_BETA2)
    denom = torch._foreach_div(nu, bc2)
    torch._foreach_sqrt_(denom)
    torch._foreach_add_(denom, ADAM_EPS)
    upd = torch._foreach_div(mu, bc1)
    torch._foreach_div_(upd, denom)
    if weight_decay:
        torch._foreach_add_(upd, params, alpha=weight_decay)
    torch._foreach_add_(params, upd, alpha=-lr)


def ema_decay(updates: int, decay: float = EMA_DECAY, tau: float = EMA_TAU) -> float:
    """The EMA's ramp d = decay * (1 - exp(-updates / tau)), in float32 as JAX's."""
    f32 = np.float32
    return float(f32(decay) * (f32(1) - f32(math.exp(-f32(updates) / f32(tau)))))


def ema_update_(ema: Sequence[torch.Tensor], new: Sequence[torch.Tensor], d: float) -> None:
    """ema = ema * d + new * (1 - d), in place, in the EMA's dtype (f32)."""
    torch._foreach_mul_(list(ema), d)
    torch._foreach_add_(list(ema), [t.to(e.dtype) for t, e in zip(new, ema)], alpha=float(np.float32(1) - np.float32(d)))
