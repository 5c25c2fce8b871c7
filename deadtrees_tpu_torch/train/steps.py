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

The steps are compiled programs (``core.compile_opts.Program``), as the
JAX package jits them; on CUDA they run eagerly unless
``DEADTREES_COMPILE_OPTS`` is set (``by_default=False``: their compiled
form is not yet checked on the card). A train step runs two: the forward
and the loss
(AOTAutograd compiles their backward with them, which ``backward()``
runs), then the update: the gradients' norm, the NaN/Inf guard and the
Adam update. The guard is inside the programs, as JAX's ``_select``: the
forward program keeps the new BatchNorm statistics only where the loss is
finite, the update program the new parameters and Adam state
(``torch.where`` on a device boolean). The epoch goes in as a 0-d device
tensor (the boundary loss's ramp reads it) and ``frozen`` is static: two
entries of the forward program, as in JAX (a frozen step's encoder
gradients are zeroed between the programs, with one foreach op). No step
syncs with the host between its upload and its update; its host time is
three spans keyed by ``state.step`` (``core/trace.py``): ``train.forward``,
``train.backward`` and ``train.update``. The eval step and
the predict step are one program each; the eval step counts its
confusion matrices with a fixed length (``losses.metrics.bin_counts``).

Data parallelism (``mesh`` of several ranks, ``parallel/mesh.py``): each
rank steps on its local slice of the global batch, and the step is the
JAX mesh step's, whose collectives XLA inserts:

- the forward and the loss run inside ``global_batch(mesh)``: the
  train-mode BatchNorms normalize with the global batch's statistics, the
  loss terms and ``fscore`` are the global batch's (``losses/``), so the
  loss parts and the metrics are the same numbers on every rank;
- one all-reduce (mean) of the optimizer's flat ``grad`` buffer between
  ``load_grads`` and the update: the counterpart of the JAX step's single
  gradient psum; ``grad_norm`` is taken after it. Each accumulation
  micro-step reduces its own;
- the NaN/Inf guard is one decision for every rank: the ``finite`` flag is
  all-reduced (minimum) before it guards the BatchNorm statistics and the
  update;
- the eval step's confusion matrices are the global batch's counts.

Only ``all_reduce`` and ``broadcast`` are called. With several ranks the
steps run eagerly (the collectives are not traced into a program); with
one rank, or ``mesh=None``, nothing changes.

The model computes in its own dtype (bf16 autocast for the flagship);
tensors are channel-first: 'image' (B, C, H, W) float32, 'mask' (B, H, W)
integer, 'distmap' (B, K, H, W) float32.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import torch
from torch import nn

from deadtrees_tpu_torch.core import trace
from deadtrees_tpu_torch.core.compile_opts import Program
from deadtrees_tpu_torch.losses.functional import class2one_hot
from deadtrees_tpu_torch.losses.metrics import bin_counts, fscore
from deadtrees_tpu_torch.parallel.mesh import (
    Mesh,
    all_reduce_mean_,
    batch_all,
    batch_sum,
    global_batch,
)
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

    def state_tensors(self) -> List[torch.Tensor]:
        """Parameters, buffers and the optimizer's state: what
        ``parallel.mesh.replicate`` makes rank 0's on every rank."""
        return [*self.model.parameters(), *self.model.buffers(),
                *self.optimizer.state_tensors()]


def bn_buffers(model: nn.Module) -> List[torch.Tensor]:
    """Every BatchNorm buffer of ``model`` (running mean, var, count)."""
    return [b for m in model.modules() if isinstance(m, nn.BatchNorm2d) for b in m.buffers()]


def _restore(buffers: List[torch.Tensor], saved: List[torch.Tensor]) -> None:
    with torch.no_grad():
        for b, s in zip(buffers, saved):
            b.copy_(s)


class EpochTensors:
    """The epoch as a 0-d int32 tensor on ``device``, made once per value:
    a fresh host-to-device copy at every step would wait for the device."""

    def __init__(self, device: torch.device):
        self.device = device
        self._made: Dict[int, torch.Tensor] = {}

    def __call__(self, epoch) -> torch.Tensor:
        if isinstance(epoch, torch.Tensor):
            return epoch
        t = self._made.get(int(epoch))
        if t is None:
            t = torch.tensor(int(epoch), dtype=torch.int32, device=self.device)
            self._made[int(epoch)] = t
        return t


def _device(model: nn.Module) -> torch.device:
    return next(model.parameters()).device


class _Eager:
    """A step function that runs op by op where a :class:`Program` would
    compile it: the data-parallel steps, whose collectives stay eager."""

    by_default = False

    def __init__(self, fn):
        self.fn = fn
        self.compiles: list = []  # as a Program's: none here

    def options(self, device=None):
        return None

    def __call__(self, *args, **kwargs):
        return self.fn(*args, **kwargs)


def step_program(fn, device: torch.device, mesh: Optional[Mesh]):
    """``fn`` as a step program; with several ranks, ``fn`` run eagerly
    inside ``global_batch(mesh)``."""
    if mesh is None or not mesh.distributed:
        return Program(fn, device, by_default=False)

    def in_global_batch(*args, **kwargs):
        with global_batch(mesh):
            return fn(*args, **kwargs)

    return _Eager(in_global_batch)


def make_train_step(
    model: nn.Module,
    loss: CompoundLoss,
    *,
    num_classes: int,
    remat: bool = False,
    frozen_bn: bool = False,
    mesh: Optional[Mesh] = None,
):
    """Returns ``train_step(state, batch, epoch, frozen=False) -> (state,
    metrics)``; it updates ``state`` in place. ``mesh``: the data-parallel
    mesh, ``batch`` then being this rank's slice (module docstring). Metrics are 0-d tensors on
    the model's device. The step runs two programs (module docstring): the
    forward, whose ``frozen`` entries differ in the encoder's BatchNorm
    mode, and the update, with the optimizer as an argument, so that a new
    one (the MultiStage lr-reduce stage) compiles it once more. The
    optimizer gets the gradients in its flat ``grad`` (``load_grads``)
    between the two."""
    device = _device(model)
    buffers = bn_buffers(model)
    norms = [m for m in model.modules() if isinstance(m, nn.BatchNorm2d)]
    params = list(model.parameters())
    epochs = EpochTensors(device)

    def forward(img: torch.Tensor) -> torch.Tensor:
        if remat:
            return torch.utils.checkpoint.checkpoint(model, img, use_reentrant=False)
        return model(img)

    def forward_loss(img, mask, distmap, epoch):
        # the statistics that this forward moves: those of the BatchNorms in
        # train mode (an eval-mode one's are saved for its backward)
        moving = [b for m in norms if m.training for b in m.buffers()]
        before = [b.clone() for b in moving]
        logits = forward(img)
        y = class2one_hot(mask, num_classes)
        probs = torch.softmax(logits, dim=1)
        total, parts = loss(probs, y, logits=logits, distmap=distmap, epoch=epoch)
        with torch.no_grad():
            # NaN/Inf guard, one decision for every rank: the forward's
            # BatchNorm updates stand only when finite
            finite = batch_all(torch.isfinite(total))
            for b, s in zip(moving, before):
                b.copy_(torch.where(finite, b, s))
            metrics = {k: v.detach() for k, v in parts.items()}
            metrics["dice"] = fscore(probs.detach(), y, ignore_channels=[0])
            metrics["dice_with_bg"] = fscore(probs.detach(), y)
        return total, metrics, finite

    @torch.no_grad()
    def update(optimizer, finite):
        # the guard of the parameters and the optimizer state
        grad_norm = global_norm(optimizer.grad)
        optimizer.step(finite=finite)
        return grad_norm

    forward_program = step_program(forward_loss, device, mesh)
    update_program = step_program(update, device, mesh)

    def train_step(
        state: TrainState, batch: Dict[str, torch.Tensor], epoch, frozen: bool = False
    ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        if frozen_bn:
            model.eval()
        else:
            model.train(True, encoder_train=not frozen)
        model.zero_grad(set_to_none=True)
        key = state.step
        with trace.span("train.forward", key=key):
            total, metrics, finite = forward_program(
                batch["image"], batch["mask"], batch.get("distmap"), epochs(epoch))
        # eagerly, the checkpointed forward's recompute in backward moves the
        # running statistics a second time; a compiled program's does not
        restore = remat and forward_program.options() is None
        with trace.span("train.backward", key=key):
            after_forward = [b.clone() for b in buffers] if restore else None
            with global_batch(mesh):  # a checkpointed forward's recompute reduces too
                total.backward()
            if restore:
                _restore(buffers, after_forward)
        with trace.span("train.update", key=key):
            grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
            if frozen:
                encoder_grad_mask(model, grads)
            state.optimizer.load_grads(grads)
            model.zero_grad(set_to_none=True)
            all_reduce_mean_(state.optimizer.grad, mesh)
            metrics["grad_norm"] = update_program(state.optimizer, finite)
        state.step += 1
        return state, metrics

    train_step.programs = (forward_program, update_program)
    return train_step


def make_eval_step(model: nn.Module, loss: CompoundLoss, *, num_classes: int, tta: int = 0,
                   mesh: Optional[Mesh] = None):
    """Returns ``eval_step(state, batch, epoch) -> metrics``: the loss
    parts, the Fscores and the unnormalized confusion-matrix counts
    (overall, and over the forest pixels when the batch has 'lu'), for the
    eval loop to sum; one program. With a ``mesh`` of several ranks,
    ``batch`` is this rank's slice and every number is the global batch's.

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
    device = _device(model)
    epochs = EpochTensors(device)

    def evaluate(image, mask, distmap, lu, epoch):
        if tta_fn is None:
            logits = model(image)
            probs = torch.softmax(logits, dim=1)
        else:
            probs = tta_fn(image.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)
            logits = torch.log(torch.clamp(probs, 1e-7, 1.0))
        y = class2one_hot(mask, num_classes)
        _, parts = loss(probs, y, logits=logits, distmap=distmap, epoch=epoch)
        idx = mask.reshape(-1).long() * num_classes + probs.argmax(1).reshape(-1)
        n2 = num_classes * num_classes
        out = dict(parts)
        out["dice"] = fscore(probs, y, ignore_channels=[0])
        out["dice_with_bg"] = fscore(probs, y)
        out["cm"] = batch_sum(bin_counts(idx, n2)).reshape(num_classes, num_classes)
        if lu is not None:
            idx_m = torch.where(lu.reshape(-1) == 1, idx, torch.full_like(idx, n2))
            out["cm_masked"] = batch_sum(bin_counts(idx_m, n2 + 1))[:-1].reshape(
                num_classes, num_classes)
        return out

    program = step_program(evaluate, device, mesh)

    @torch.no_grad()
    def eval_step(state: TrainState, batch: Dict[str, torch.Tensor], epoch):
        model.eval()
        return program(batch["image"], batch["mask"], batch.get("distmap"), batch.get("lu"),
                       epochs(epoch))

    eval_step.programs = (program,)
    return eval_step


def make_predict_step(model: nn.Module, *, return_probs: bool = True):
    """Inference: images (B, C, H, W) → argmax classes (B, H, W), with the
    probabilities (B, K, H, W) when ``return_probs``; else uint8 classes
    only (argmax of the logits, no softmax). One program (JAX's
    ``predict_step`` / ``predict_step_classes``)."""

    def predict(img: torch.Tensor):
        logits = model(img)
        if not return_probs:
            return logits.argmax(1).to(torch.uint8)
        probs = torch.softmax(logits, dim=1)
        return probs.argmax(1), probs

    program = Program(predict, _device(model), by_default=False)

    @torch.no_grad()
    def predict_step(img: torch.Tensor):
        model.eval()
        return program(img)

    predict_step.programs = (program,)
    return predict_step
