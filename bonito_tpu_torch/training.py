"""
Training loop: the port's counterpart of bonito_tpu's ``training.py`` on
one card.

- ``make_train_step`` builds one optimisation step, bonito_tpu's
  ``make_train_step``: the forward in train mode (BatchNorm on batch
  statistics, every float LSTM through ``ops.lstm.lstm_train``: kernels R
  and S on the card), the default CRF loss from ``forward_tcn`` (kernels
  U, V, Y and Z) or a custom criterion on full scores, the backward, grad
  accumulation over equal microbatches (gradients and losses averaged),
  one global-norm clip, AdamW with the whole update times the schedule's
  scale, then the BatchNorm running-stat updates.
- Mixed precision is explicit casts, as bonito_tpu's ``cast_tree``: the
  batch is cast to bf16 and every layer casts its f32 master parameters to
  its input's dtype where it uses them (BatchNorm's running statistics
  stay f32). ``torch.autocast`` is not used: its lists keep other ops in
  f32 than bonito_tpu does.
- ``Trainer`` runs epochs: per-step CSV losses, ``weights_N.npz`` (and the
  optimiser state every ``save_optim_every`` epochs), validation (the same
  forward in eval mode, the loss, the TCN Viterbi decode through kernels B
  and C, and ``accuracy``), the epoch CSV, and resume.

One process on one device; data-parallel training over several cards is
a later slice.
"""

import math
import sys
import time
from itertools import islice
from pathlib import Path

import numpy as np
import torch

from bonito_tpu_torch import nn
from bonito_tpu_torch.checkpoint import (
    load_optim_state, load_params, params_from_jax, save_checkpoint)
from bonito_tpu_torch.io import CSVLogger
from bonito_tpu_torch.schedule import linear_warmup_cosine_decay
from bonito_tpu_torch.util import accuracy, decode_ref


class ClipGrad:
    """Quantile-adaptive gradient-norm clip: ``factor`` times the
    ``quantile`` of the last ``buffer_size`` norms."""

    def __init__(self, quantile=0.5, factor=2.0, buffer_size=100):
        self.buffer = np.full(buffer_size, fill_value=1e6)
        self.quantile = quantile
        self.factor = factor
        self.i = 0

    def append(self, grad_norm):
        self.buffer[self.i] = grad_norm
        self.i = (self.i + 1) % len(self.buffer)

    def max_norm(self):
        return float(self.factor * np.quantile(self.buffer, self.quantile))

    def update(self, grad_norm):
        if not math.isnan(grad_norm):
            self.append(grad_norm)


def use_tcn(model, criterion):
    """The one gate of the TCN route (``forward_tcn`` + ``loss_tcn``) for
    both the train step and validation: the default criterion of a model
    whose head has a fixed blank."""
    return (criterion is None and hasattr(model, "forward_tcn")
            and model.decode_head() is not None)


def make_optimizer(model, lr, **kwargs):
    """AdamW over the model's parameters as bonito_tpu's default
    ``optax.adamw(lr, weight_decay=0.01, eps=1e-8)``; ``[optim]`` keys
    ``weight_decay``, ``eps``, ``b1``, ``b2`` are honoured. The train step
    sets each group's rate to ``lr`` times the schedule's scale, which
    scales the whole update, decay included, as bonito_tpu does."""
    if kwargs.pop("package", None) or kwargs.pop("symbol", None):
        raise NotImplementedError(
            "[optim] package/symbol: only AdamW is ported; a pluggable "
            "optimiser waits (ROADMAP)")
    if isinstance(lr, (list, tuple)):
        raise NotImplementedError(
            "per-group learning rates need a pluggable optimiser, which is "
            "not ported")
    betas = (kwargs.pop("b1", 0.9), kwargs.pop("b2", 0.999))
    weight_decay = kwargs.pop("weight_decay", 0.01)
    eps = kwargs.pop("eps", 1e-8)
    if kwargs:
        raise NotImplementedError(f"[optim] {sorted(kwargs)} not ported")
    return torch.optim.AdamW(
        [p for p in model.parameters() if p.requires_grad], lr=lr,
        betas=betas, eps=eps, weight_decay=weight_decay)


def make_train_step(model, optimizer, use_amp=True, grad_accum_split=1,
                    criterion=None):
    """One step: ``step(batch, lr_scale, clip_max) -> (losses, grad_norm)``
    with the batch as tensors on the model's device (data [B, T, 1] f32,
    targets, lengths); the losses (averaged over microbatches) and the
    norm before the clip are device scalars. Parameters, optimiser state
    and BatchNorm statistics are updated in place."""
    tcn = use_tcn(model, criterion)
    criterion = criterion or model.loss
    norms = [m for m in model.modules() if isinstance(m, nn.BatchNorm)]
    base_lrs = [group["lr"] for group in optimizer.param_groups]
    params = [p for group in optimizer.param_groups for p in group["params"]]
    dtype = torch.bfloat16 if use_amp else torch.float32

    def forward_loss(data, targets, lengths):
        data = data.to(dtype)
        if tcn:
            moves, blank = model.forward_tcn(data)
            losses = model.loss_tcn(moves, blank, targets, lengths)
        else:
            losses = criterion(model(data), targets, lengths)
        if not isinstance(losses, dict):
            losses = {"loss": losses}
        return losses.get("total_loss", losses["loss"]), losses

    def step(batch, lr_scale, clip_max):
        model.train()
        optimizer.zero_grad(set_to_none=True)
        losses = {}
        try:
            for mb in zip(*(x.chunk(grad_accum_split) for x in batch)):
                total, mb_losses = forward_loss(*mb)
                total.backward()
                for k, v in mb_losses.items():
                    losses[k] = losses.get(k, 0) + v.detach() / grad_accum_split
        finally:
            model.eval()
        if grad_accum_split > 1:
            torch._foreach_div_([p.grad for p in params if p.grad is not None],
                                grad_accum_split)
        grad_norm = clip_and_update(optimizer, base_lrs, lr_scale, clip_max)
        for bn in norms:
            bn.apply_pending()
        return losses, grad_norm

    return step


def clip_and_update(optimizer, base_lrs, lr_scale, clip_max):
    """The update from the gradients in ``.grad``: one global norm over all
    of them, the clip ``min(1, clip_max / (norm + 1e-12))``, then the
    optimiser's step with each group's rate at its base rate times
    ``lr_scale``. Returns the norm before the clip."""
    grads = [p.grad for group in optimizer.param_groups
             for p in group["params"] if p.grad is not None]
    grad_norm = torch.sqrt(sum((g.float() ** 2).sum() for g in grads))
    torch._foreach_mul_(grads, torch.clamp(clip_max / (grad_norm + 1e-12),
                                           max=1.0))
    for group, lr in zip(optimizer.param_groups, base_lrs):
        group["lr"] = lr * lr_scale
    optimizer.step()
    return grad_norm


def load_state(workdir, model, want_optim=False):
    """Resume point of ``workdir``: (epoch, optimiser state or None), with
    the model's weights loaded from ``weights_{epoch}.npz``. With
    ``want_optim`` the epoch is the newest with both weights and an
    optimiser state; else the newest weights. (0, None) when none."""
    workdir = Path(workdir)
    weight_epochs = {
        int(p.stem.split("_")[1]) for p in workdir.glob("weights_*.npz")}
    if want_optim:
        optim_epochs = {
            int(p.stem.split("_")[1]) for p in workdir.glob("optim_*.pt")}
        epoch = max(weight_epochs & optim_epochs, default=None)
    else:
        epoch = max(weight_epochs, default=None)
    if epoch is None:
        return 0, None
    params_from_jax(model, load_params(workdir / f"weights_{epoch}.npz"))
    return epoch, load_optim_state(workdir, epoch) if want_optim else None


class Trainer:
    def __init__(self, model, train_loader, valid_loader, criterion=None,
                 use_amp=True, lr_scheduler_fn=None, restore_optim=False,
                 save_optim_every=10, grad_accum_split=1,
                 quantile_grad_clip=False, chunks_per_epoch=None,
                 batch_size=None):
        self.model = model
        self.train_loader = train_loader
        self.valid_loader = valid_loader
        self.criterion = criterion
        self.use_amp = use_amp
        self.lr_scheduler_fn = lr_scheduler_fn or linear_warmup_cosine_decay()
        self.restore_optim = restore_optim
        self.save_optim_every = save_optim_every
        self.grad_accum_split = grad_accum_split
        self.quantile_clip = ClipGrad() if quantile_grad_clip else None
        self.fixed_clip = 2.0
        self.batch_size = batch_size
        self.chunks_per_epoch = chunks_per_epoch
        self.steps_per_epoch = (
            chunks_per_epoch // batch_size if chunks_per_epoch else None)
        self.optimizer = None
        self._step_fn = None
        self._lr_schedule = None
        self._base_lr = None
        self._sched_step = 0

    @property
    def device(self):
        return next(self.model.parameters()).device

    def get_lr_scale(self, step, epochs, last_epoch):
        if self._lr_schedule is None:
            self._lr_schedule = self.lr_scheduler_fn(
                self.steps_per_epoch, epochs, last_epoch)
        return self._lr_schedule(step)

    def _put_batch(self, batch):
        data, targets, lengths = batch
        data = np.asarray(data, np.float32)
        if data.ndim == 2:
            data = data[..., None]
        return tuple(torch.from_numpy(np.ascontiguousarray(x)).to(self.device)
                     for x in (data, np.asarray(targets, np.int64),
                               np.asarray(lengths, np.int64)))

    def train_one_step(self, batch, lr_scale):
        clip_max = (self.quantile_clip.max_norm()
                    if self.quantile_clip else self.fixed_clip)
        return self._step_fn(self._put_batch(batch), lr_scale, clip_max)

    def train_one_epoch(self, loss_log, epoch, epochs, last_epoch):
        t0 = time.perf_counter()
        chunks = 0
        smoothed_loss = None
        pending = None

        def materialize(record):
            # read after the next step is queued, so the host's wait for
            # the device overlaps that step; the quantile clip of step i+1
            # then sees the norms up to step i-1, as in bonito_tpu
            nonlocal smoothed_loss
            losses, grad_norm, n_chunks, lr_scale = record
            losses = {k: float(v) for k, v in losses.items()}
            grad_norm = float(grad_norm)
            if self.quantile_clip:
                self.quantile_clip.update(grad_norm)
            smoothed_loss = (
                losses["loss"] if smoothed_loss is None
                else 0.01 * losses["loss"] + 0.99 * smoothed_loss)
            loss_log.append({
                "chunks": n_chunks,
                "time": time.perf_counter() - t0,
                "grad_norm": grad_norm,
                "lr": lr_scale * (self._base_lr or 1.0),
                **losses,
            })
            sys.stderr.write(
                f"\r[{n_chunks}/{self.chunks_per_epoch}] epoch {epoch} loss "
                f"{smoothed_loss:.4f} ({time.perf_counter() - t0:.0f} s)")

        # capped at steps_per_epoch so that an unbounded plugin loader
        # still ends its epochs
        for batch in islice(self.train_loader, self.steps_per_epoch):
            lr_scale = self.get_lr_scale(self._sched_step, epochs, last_epoch)
            self._sched_step += 1
            losses, grad_norm = self.train_one_step(batch, lr_scale)
            chunks += batch[0].shape[0]
            if pending is not None:
                materialize(pending)
            pending = (losses, grad_norm, chunks, lr_scale)
        if pending is not None:
            materialize(pending)
        sys.stderr.write("\n")
        return smoothed_loss, time.perf_counter() - t0

    def validate_one_step(self, batch):
        """(sequences, references, accuracies, losses) of one batch: the
        forward in eval mode under no_grad with the train step's numerics
        (bf16 under amp), the loss, the Viterbi decode (on the TCN route
        the kernels B and C), ``accuracy`` with min_coverage 0.5."""
        from bonito_tpu_torch.ops.decode import viterbi_decode_tcn
        model = self.model
        data, targets, lengths = self._put_batch(batch)
        model.eval()
        with torch.no_grad():
            data = data.to(torch.bfloat16 if self.use_amp else torch.float32)
            if use_tcn(model, self.criterion):
                moves, blank = model.forward_tcn(data)
                losses = model.loss_tcn(moves, blank, targets, lengths)
                codes = viterbi_decode_tcn(model.seqdist, moves,
                                           blank)["sequence"]
                seqs = [model.seqdist.path_to_str(p)
                        for p in codes.cpu().numpy()]
            else:
                scores = model(data)
                losses = (self.criterion or model.loss)(scores, targets,
                                                        lengths)
                seqs = model.decode_batch(scores)
        if not isinstance(losses, dict):
            losses = {"loss": losses}
        losses = {k: float(v) for k, v in losses.items()}
        refs = [decode_ref(t[:n], model.alphabet)
                for t, n in zip(np.asarray(batch[1]), np.asarray(batch[2]))]
        n_pre = getattr(model, "n_pre_context_bases", 0)
        n_post = getattr(model, "n_post_context_bases", 0)
        if n_pre or n_post:
            refs = [r[n_pre:len(r) - n_post if n_post else len(r)]
                    for r in refs]
        accs = [accuracy(ref, seq, min_coverage=0.5) if len(seq) else 0.0
                for ref, seq in zip(refs, seqs)]
        return seqs, refs, accs, losses

    def validate_one_epoch(self):
        accs, losses = [], []
        for batch in self.valid_loader:
            _, _, a, loss = self.validate_one_step(batch)
            accs.extend(a)
            losses.append(loss.get("total_loss", loss["loss"]))
        return (float(np.mean(losses)), float(np.mean(accs)),
                float(np.median(accs)))

    def fit(self, workdir, epochs=1, lr=2e-3, **optim_kwargs):
        workdir = Path(workdir)
        workdir.mkdir(parents=True, exist_ok=True)
        if self.steps_per_epoch is None:
            raise ValueError("chunks_per_epoch/batch_size must be set before fit")
        if (self.grad_accum_split > 1 and self.batch_size
                and self.batch_size % self.grad_accum_split):
            raise ValueError(
                f"batch size {self.batch_size} must divide by "
                f"--grad-accum-split {self.grad_accum_split}")
        # the logged 'lr' is the real rate: the schedule's scale x the base
        self._base_lr = lr
        last_epoch, opt_state = load_state(
            workdir, self.model, want_optim=self.restore_optim)
        self.optimizer = make_optimizer(self.model, lr, **optim_kwargs)
        if self.restore_optim and opt_state is not None:
            self.optimizer.load_state_dict(opt_state)
        self._lr_schedule = None
        self._sched_step = 0   # batches run since the resume point
        self._step_fn = make_train_step(
            self.model, self.optimizer, use_amp=self.use_amp,
            grad_accum_split=self.grad_accum_split, criterion=self.criterion)

        # ``epochs`` is the absolute target: resuming from epoch 3 with
        # epochs=5 trains 2 more
        for epoch in range(last_epoch + 1, epochs + 1):
            with CSVLogger(workdir / f"losses_{epoch}.csv") as loss_log:
                train_loss, duration = self.train_one_epoch(
                    loss_log, epoch, epochs, last_epoch)
            save_checkpoint(
                workdir, epoch, self.model,
                self.optimizer.state_dict()
                if epoch % self.save_optim_every == 0 else None)
            val_loss, val_mean, val_median = (
                self.validate_one_epoch() if self.valid_loader is not None
                else (float("nan"),) * 3)
            with CSVLogger(workdir / "training.csv") as log:
                log.append({
                    "time": time.strftime("%Y-%m-%d %H:%M:%S"),
                    "duration": int(duration),
                    "epoch": epoch,
                    "train_loss": train_loss,
                    "validation_loss": val_loss,
                    "validation_mean": val_mean,
                    "validation_median": val_median,
                })
            print(f"[epoch {epoch}] train loss {train_loss:.4f} "
                  f"val loss {val_loss:.4f} val acc mean {val_mean:.2f}% "
                  f"median {val_median:.2f}% ({duration:.0f}s)")
