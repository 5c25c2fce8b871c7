"""Train / eval / predict steps and the train state.

Counterpart of ``deadtrees_tpu.train.steps``. One train step is: forward
in train mode (under the model's autocast) → softmax → compound loss →
backward → (encoder gradients zeroed when frozen) → clip + Adam + cosine
LR, with the reference's semantics:

- softmax before the loss, one-hot target;
- a loss that is not finite skips the update: parameters, BatchNorm
  running statistics and optimizer state stay as they were (torch updates
  the running statistics during the forward, so they are restored); the
  step count still ticks;
- metrics: smp Fscore with and without background, the gradients' global
  norm, and the loss parts;
- ``frozen=True`` (MultiStage) keeps the encoder's BatchNorms on their
  running statistics and zeroes the encoder's gradients;
- ``frozen_bn=True`` runs every BatchNorm on its running statistics while
  all weights, BN affine included, still train;
- ``remat=True`` checkpoints the forward (``torch.utils.checkpoint``): the
  backward recomputes the activations; the recompute's second BatchNorm
  update is undone.

The model computes in its own dtype (bf16 autocast for the flagship);
tensors are channel-first: 'image' (B, C, H, W) float32, 'mask' (B, H, W)
integer, 'distmap' (B, K, H, W) float32.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import torch
from torch import nn

from deadtrees_tpu_torch.losses.functional import class2one_hot
from deadtrees_tpu_torch.losses.metrics import fscore
from deadtrees_tpu_torch.train.loss import CompoundLoss
from deadtrees_tpu_torch.train.optim import Optimizer, encoder_grad_mask, global_norm


@dataclasses.dataclass
class TrainState:
    """Step count, the model (its parameters and BatchNorm buffers) and
    the optimizer (its state)."""

    model: nn.Module
    optimizer: Optimizer
    step: int = 0

    def replace_optimizer(self, optimizer: Optimizer) -> "TrainState":
        """Swap in a fresh optimizer (the MultiStage lr-reduce stage)."""
        self.optimizer = optimizer
        return self


def bn_buffers(model: nn.Module) -> List[torch.Tensor]:
    """Every BatchNorm buffer of ``model`` (running mean, var, count)."""
    return [b for m in model.modules() if isinstance(m, nn.BatchNorm2d) for b in m.buffers()]


def _restore(buffers: List[torch.Tensor], saved: List[torch.Tensor]) -> None:
    with torch.no_grad():
        for b, s in zip(buffers, saved):
            b.copy_(s)


def make_train_step(
    model: nn.Module,
    loss: CompoundLoss,
    *,
    num_classes: int,
    remat: bool = False,
    frozen_bn: bool = False,
):
    """Returns ``train_step(state, batch, epoch, frozen=False) -> (state,
    metrics)``; it updates ``state`` in place. Metrics are 0-d tensors on
    the model's device."""

    def forward(img: torch.Tensor) -> torch.Tensor:
        if remat:
            return torch.utils.checkpoint.checkpoint(model, img, use_reentrant=False)
        return model(img)

    def train_step(
        state: TrainState, batch: Dict[str, torch.Tensor], epoch: int, frozen: bool = False
    ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        if frozen_bn:
            model.eval()
        else:
            model.train(True, encoder_train=not frozen)
        buffers = bn_buffers(model)
        before = [b.clone() for b in buffers]
        model.zero_grad(set_to_none=True)

        logits = forward(batch["image"])
        after_forward = [b.clone() for b in buffers] if remat else None
        y = class2one_hot(batch["mask"], num_classes)
        probs = torch.softmax(logits, dim=1)
        total, parts = loss(probs, y, logits=logits, distmap=batch.get("distmap"), epoch=epoch)
        total.backward()
        if remat:  # the recompute moved the running statistics a second time
            _restore(buffers, after_forward)

        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in model.parameters()]
        if frozen:
            encoder_grad_mask(model, grads)
        with torch.no_grad():
            metrics = {k: v.detach() for k, v in parts.items()}
            metrics["dice"] = fscore(probs.detach(), y, ignore_channels=[0])
            metrics["dice_with_bg"] = fscore(probs.detach(), y)
            metrics["grad_norm"] = global_norm(grads)
        if bool(torch.isfinite(total)):
            state.optimizer.step(grads)
        else:  # NaN/Inf guard: keep the old state
            _restore(buffers, before)
        state.step += 1
        return state, metrics

    return train_step


def make_eval_step(model: nn.Module, loss: CompoundLoss, *, num_classes: int, tta: int = 0):
    """Returns ``eval_step(state, batch, epoch) -> metrics``: the loss
    parts, the Fscores and the unnormalized confusion-matrix counts
    (overall, and over the forest pixels when the batch has 'lu'), for the
    eval loop to sum.

    ``tta`` (0, 4 or 8; any other value raises ``ValueError``): the
    probabilities are the mean over the dihedral views of
    ``infer/tta.py``, and the loss parts that read raw scores get
    ``log(clamp(probs, 1e-7, 1))``, which keeps the argmax and the order."""
    tta_fn = None
    if tta:
        from deadtrees_tpu_torch.infer.tta import make_tta_fn

        def logits_nhwc(x: torch.Tensor) -> torch.Tensor:
            return model(x.permute(0, 3, 1, 2).contiguous()).permute(0, 2, 3, 1)

        tta_fn = make_tta_fn(logits_nhwc, views=tta)

    @torch.no_grad()
    def eval_step(state: TrainState, batch: Dict[str, torch.Tensor], epoch: int):
        model.eval()
        mask = batch["mask"]
        if tta_fn is None:
            logits = model(batch["image"])
            probs = torch.softmax(logits, dim=1)
        else:
            probs = tta_fn(batch["image"].permute(0, 2, 3, 1)).permute(0, 3, 1, 2)
            logits = torch.log(torch.clamp(probs, 1e-7, 1.0))
        y = class2one_hot(mask, num_classes)
        _, parts = loss(probs, y, logits=logits, distmap=batch.get("distmap"), epoch=epoch)
        idx = mask.reshape(-1).long() * num_classes + probs.argmax(1).reshape(-1)
        n2 = num_classes * num_classes
        out = dict(parts)
        out["dice"] = fscore(probs, y, ignore_channels=[0])
        out["dice_with_bg"] = fscore(probs, y)
        out["cm"] = torch.bincount(idx, minlength=n2).reshape(num_classes, num_classes)
        lu = batch.get("lu")
        if lu is not None:
            idx_m = torch.where(lu.reshape(-1) == 1, idx, torch.full_like(idx, n2))
            out["cm_masked"] = torch.bincount(idx_m, minlength=n2 + 1)[:-1].reshape(
                num_classes, num_classes
            )
        return out

    return eval_step


def make_predict_step(model: nn.Module, *, return_probs: bool = True):
    """Inference: images (B, C, H, W) → argmax classes (B, H, W), with the
    probabilities (B, K, H, W) when ``return_probs``; else uint8 classes
    only (argmax of the logits, no softmax)."""

    @torch.no_grad()
    def predict_step(img: torch.Tensor):
        model.eval()
        logits = model(img)
        if not return_probs:
            return logits.argmax(1).to(torch.uint8)
        probs = torch.softmax(logits, dim=1)
        return probs.argmax(1), probs

    return predict_step
