"""Train state + optimizers matching the reference's configs (config/depth.yml:
Adam lr 1e-5, grad-clip 10; config/normal.yml: Adam lr 1e-4 wd 2e-6 amsgrad;
train_*.py:381-386), the port's counterpart of the JAX package's
``train/state.py``.

The JAX package chains optax transforms; ``torch.optim`` computes other
functions, so both chains are written here in torch to optax 0.2.6's
formulas:

- ``clip_by_global_norm(g)``: n = sqrt(sum over tensors of sum(t²)); where
  n >= g every gradient becomes t / n * g (``clip_grad_norm_`` multiplies
  by g / (n + 1e-6) instead).
- ``add_decayed_weights(wd)``: t + wd * p.
- ``adam``/``amsgrad``: mu = (1 - b1) t + b1 mu, nu = (1 - b2) t² + b2 nu,
  each corrected by 1 - b^count; AMSGrad keeps the running maximum of the
  *corrected* second moment (``torch.optim.Adam(amsgrad=True)`` takes the
  maximum of the raw one, which differs from the second step on); update
  -lr * mu_hat / (sqrt(v) + eps), added to the parameter.

The bias corrections are float32 scalars computed on the host from the
count, so a step makes no device-to-host round trip. The moments are lists
of tensors in the order of ``TrainState.names``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn

from ..models.convert import _dpt_mapping
from ..models.dpt import DPTHybrid


def trainable_parameters(net: nn.Module) -> dict:
    """name -> parameter of every tensor the JAX package's Flax tree holds
    and so trains: all but DPT's never-run published tensors (the ImageNet
    classifier and refinenet4's first unit, ``convert``'s '*_drop' kinds).
    DPT's final ViT LayerNorm runs in JAX with its output unused, so it is
    trained on zero gradients (weight decay still moves it)."""
    dropped = set()
    if isinstance(net, DPTHybrid):
        dropped = {f"{key}.{leaf}" for _, key, kind in _dpt_mapping()
                   if isinstance(kind, tuple) for leaf in ("weight", "bias")}
    return {n: p for n, p in net.named_parameters() if n not in dropped}


@dataclasses.dataclass(frozen=True)
class Optimizer:
    """clip_by_global_norm(grad_clip) -> [add_decayed_weights(weight_decay)]
    -> adam or amsgrad(lr), as optax chains them."""

    lr: float
    grad_clip: float = 10.0
    weight_decay: float = 0.0
    amsgrad: bool = False
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8

    def init(self, params: list) -> dict:
        zeros = lambda: [torch.zeros_like(p) for p in params]
        state = {"count": torch.zeros((), dtype=torch.int32), "mu": zeros(), "nu": zeros()}
        if self.amsgrad:
            state["nu_max"] = zeros()
        return state

    def global_norm(self, grads: list) -> torch.Tensor:
        """sqrt of the sum of squares over every tensor. On the card each
        tensor's norm squared (three launches, not two per tensor); on the
        CPU, whose norm kernel sums a tensor's squares one after another in
        float32 (4e-5 off over 2.4M entries), each tensor's ``torch.sum``
        of squares, which sums in a cascade."""
        if grads[0].is_cuda:
            return torch.sqrt(torch.sum(torch.stack(torch._foreach_norm(grads)) ** 2))
        return torch.sqrt(torch.sum(torch.stack([torch.sum(g * g) for g in grads])))

    def step(self, params: list, grads: list, state: dict) -> None:
        """One update of params and state in place from grads (which it
        may overwrite)."""
        g_norm = self.global_norm(grads)
        trigger = g_norm < self.grad_clip
        one = g_norm.new_tensor(1.0)
        torch._foreach_div_(grads, torch.where(trigger, one, g_norm))
        torch._foreach_mul_(grads, torch.where(trigger, one, g_norm.new_tensor(self.grad_clip)))
        if self.weight_decay:
            torch._foreach_add_(grads, torch._foreach_mul(params, self.weight_decay))
        count = int(state["count"]) + 1
        mu, nu = state["mu"], state["nu"]
        torch._foreach_mul_(mu, self.b1)
        torch._foreach_add_(mu, torch._foreach_mul(grads, 1 - self.b1))
        torch._foreach_mul_(grads, grads)
        torch._foreach_mul_(grads, 1 - self.b2)
        torch._foreach_mul_(nu, self.b2)
        torch._foreach_add_(nu, grads)
        f32 = np.float32
        bc1 = float(f32(1) - f32(self.b1) ** np.int32(count))
        bc2 = float(f32(1) - f32(self.b2) ** np.int32(count))
        v = torch._foreach_div(nu, bc2)
        if self.amsgrad:
            torch._foreach_maximum_(state["nu_max"], v)
            v = torch._foreach_sqrt(state["nu_max"])
        else:
            torch._foreach_sqrt_(v)
        torch._foreach_add_(v, self.eps)
        upd = torch._foreach_div(mu, bc1)
        torch._foreach_div_(upd, v)
        torch._foreach_mul_(upd, -self.lr)
        torch._foreach_add_(params, upd)
        state["count"] = torch.tensor(count, dtype=torch.int32)


def depth_optimizer(lr: float = 1e-5, grad_clip: float = 10.0) -> Optimizer:
    return Optimizer(lr=lr, grad_clip=grad_clip)


def normal_optimizer(lr: float = 1e-4, weight_decay: float = 2e-6,
                     grad_clip: float = 10.0) -> Optimizer:
    # torch Adam(amsgrad) + L2-style weight decay
    return Optimizer(lr=lr, grad_clip=grad_clip, weight_decay=weight_decay, amsgrad=True)


@dataclasses.dataclass
class TrainState:
    """step, the module whose trainable tensors are the params, and the
    optimizer state over them (in ``names`` order)."""

    step: int
    net: nn.Module
    opt_state: dict
    tx: Optimizer
    names: list

    @property
    def params(self) -> list:
        tensors = dict(self.net.named_parameters())
        return [tensors[n] for n in self.names]

    def apply_gradients(self) -> None:
        """The optimizer step on the params' .grad (None -> zeros, as JAX
        differentiates tensors the forward pass ignores), then step + 1."""
        params = self.params
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
        with torch.no_grad():
            self.tx.step(params, grads, self.opt_state)
        for p in params:
            p.grad = None
        self.step += 1


def create_train_state(net: nn.Module, tx: Optimizer) -> TrainState:
    names = list(trainable_parameters(net))
    for n, p in net.named_parameters():
        p.requires_grad_(n in names)
    state = TrainState(0, net, {}, tx, names)
    state.opt_state = tx.init(state.params)
    return state
