"""Training loop, the counterpart of ``att_aspp_unet_tpu/train/train_loop.py``:
AdamW (optax's, written out) with a 5 % warmup in epochs then
cosine, global-norm gradient clip 1.0 (per group under the differential
learning rate), early stop after 15 epochs without a better val Dice, best
and last checkpoints with resume from ``last``, and the per-epoch CSV.

Each train step augments the batch on the device (``augment.py``; its CLAHE
is kernel K2 on a card), runs the forward and backward of the train model
(``models/att_aspp_unet_train.py``) and updates the parameters.  The
augmentation parameters are drawn on a CPU generator seeded from (seed,
step), the Dropout masks on a generator of the model's device seeded the
same way, as the JAX package folds the step into its key
(``train_loop.py:124``).  Per-step metrics stay on the device and cross to
the host once per epoch.

A checkpoint is ``torch.save`` of the model's state dict, the optimizer's
moments and the step, with the JAX package's ``.extra.json`` side file; it
is not an Orbax directory.  The layout under ``output_dir`` is the JAX
package's: ``ckpt_main/`` (or ``ckpt_finetune/``) with ``best``, ``last``
and ``metrics.csv``.

Data parallelism (``parallel/mesh.py``): :func:`fit` on several devices runs
one process per device (:func:`fit_rank` on each), as the JAX package's
``fit`` shards the batch over every device the batch size admits.  Each rank
takes its contiguous rows of every global batch; the augmentation parameters
and Dropout masks are drawn for the global batch and sliced, BatchNorm's
statistics and the losses are the global batch's, and the gradients are
summed over the ranks before AdamW, so that a D-rank run computes the
one-process run's steps.  Rank 0 alone writes the files; every rank resumes
from ``last``.
"""

from __future__ import annotations

import contextlib
import csv
import dataclasses
import json
import os
import pickle
import tempfile
import time
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from ..config import Config, ModelConfig, TrainConfig
from ..device import resolve_device
from ..models.att_aspp_unet_train import AttentionASPPUNetTrain
from ..ops.kernels.fused_conv import exact_f32
from ..parallel import mesh
from ..utils.convert import init_variables as seeded_init
from ..utils.convert import jax_variables_to_train_model
from .augment import augment_batch, sample_params
from .data import ArrayDataset, epoch_batches
from .losses import build_criterion, dice_loss, iou_score

CKPT_FORMAT = "att_aspp_unet_tpu_torch.train/1"
B1, B2, EPS = 0.9, 0.999, 1e-8          # optax.adamw's defaults
_f32 = np.float32


def make_lr_schedule(cfg: TrainConfig, steps_per_epoch: int
                     ) -> Callable[[int], float]:
    """The learning rate of update ``k`` (counted from 0): linear from
    0.2 lr to lr over the warmup (``max(1, int(warmup_frac * epochs))``
    epochs; none in finetune), then cosine to 0 over the remaining steps.
    optax's ``join_schedules`` of ``linear_schedule`` and
    ``cosine_decay_schedule``, evaluated in its f32 arithmetic."""
    total = max(cfg.epochs * steps_per_epoch, 1)
    warm = 0 if cfg.stage == "finetune" else max(
        1, int(cfg.warmup_frac * cfg.epochs)) * steps_per_epoch
    lr = cfg.lr

    def cosine(count: int, decay_steps: int) -> float:
        c = _f32(min(count, decay_steps))
        arg = _f32(_f32(np.pi) * c) / _f32(decay_steps)
        decayed = _f32(0.5) * (_f32(1.0) + np.cos(arg))
        return float(_f32(lr) * decayed)

    def schedule(count: int) -> float:
        if warm == 0:
            return cosine(count, total)
        if count < warm:
            frac = _f32(1.0) - _f32(min(max(count, 0), warm)) / _f32(warm)
            return float(_f32(_f32(lr * 0.2 - lr) * frac) + _f32(lr))
        return cosine(count - warm, max(total - warm, 1))

    return schedule


def is_attention_param(name: str) -> bool:
    """The differential learning rate's "att" label (``train_loop.py:68-70``
    on the flax path): a module named ``att`` or any name holding
    ``psi``."""
    return any(k == "att" or "psi" in k for k in name.split("."))


class AdamW:
    """``optax.chain(clip_by_global_norm(clip), adamw(lr * mult, wd))`` per
    parameter group; one group at ``mult`` 1, or, with the differential
    learning rate, the attention parameters at 1 and the backbone at 0.5,
    each clipped by its own global norm (``optax.multi_transform``).  Weight
    decay applies to every parameter, BatchNorm's included.  The update
    order and rounding follow optax: ``mu = (1-b1) g + b1 mu``, ``nu =
    (1-b2) g^2 + b2 nu``, ``u = mu_hat / (sqrt(nu_hat) + eps) + wd p``,
    ``p += -lr(k) u``."""

    def __init__(self, named_params, cfg: TrainConfig, steps_per_epoch: int):
        self.names: List[str] = [n for n, _ in named_params]
        self.params: List[torch.Tensor] = [p for _, p in named_params]
        self.schedule = make_lr_schedule(cfg, steps_per_epoch)
        self.clip = float(cfg.grad_clip)
        self.wd = float(cfg.weight_decay)
        if cfg.differential_lr:
            att = [is_attention_param(n) for n in self.names]
            self.groups = [(1.0, [i for i, a in enumerate(att) if a]),
                           (0.5, [i for i, a in enumerate(att) if not a])]
        else:
            self.groups = [(1.0, list(range(len(self.names))))]
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.count = 0

    @torch.no_grad()
    def step(self, grads: List[torch.Tensor]) -> None:
        lr = self.schedule(self.count)
        k = _f32(self.count + 1)
        bc1 = float(_f32(1.0) - _f32(B1) ** k)
        bc2 = float(_f32(1.0) - _f32(B2) ** k)
        for mult, idx in self.groups:
            if not idx:
                continue
            g = [grads[i] for i in idx]
            p = [self.params[i] for i in idx]
            mu = [self.mu[i] for i in idx]
            nu = [self.nu[i] for i in idx]
            g_norm = torch.linalg.vector_norm(
                torch.stack(torch._foreach_norm(g)))
            factor = torch.where(g_norm < self.clip, 1.0, self.clip / g_norm)
            g = torch._foreach_mul(g, factor)
            torch._foreach_mul_(mu, B1)
            torch._foreach_add_(mu, torch._foreach_mul(g, 1 - B1))
            g2 = torch._foreach_mul(g, g)
            torch._foreach_mul_(g2, 1 - B2)
            torch._foreach_mul_(nu, B2)
            torch._foreach_add_(nu, g2)
            denom = torch._foreach_sqrt(torch._foreach_div(nu, bc2))
            torch._foreach_add_(denom, EPS)
            upd = torch._foreach_div(torch._foreach_div(mu, bc1), denom)
            torch._foreach_add_(upd, torch._foreach_mul(p, self.wd))
            torch._foreach_mul_(upd, -(lr * mult))
            torch._foreach_add_(p, upd)
        self.count += 1

    def state_dict(self) -> Dict[str, Any]:
        return {"count": self.count,
                "mu": dict(zip(self.names, self.mu)),
                "nu": dict(zip(self.names, self.nu))}

    @torch.no_grad()
    def load_state_dict(self, sd: Dict[str, Any]) -> None:
        for key in ("mu", "nu"):
            for t, name in zip(getattr(self, key), self.names):
                t.copy_(sd[key][name])
        self.count = int(sd["count"])


def make_optimizer(cfg: TrainConfig, steps_per_epoch: int,
                   model: torch.nn.Module) -> AdamW:
    return AdamW(list(model.named_parameters()), cfg, steps_per_epoch)


@dataclasses.dataclass
class TrainState:
    model: AttentionASPPUNetTrain
    opt: AdamW

    @property
    def step(self) -> int:
        return self.opt.count


def create_train_state(model_cfg: ModelConfig, train_cfg: TrainConfig,
                       steps_per_epoch: int, device="cuda",
                       init_variables: Optional[dict] = None) -> TrainState:
    """The train model on ``device`` from ``init_variables`` (a JAX-layout
    tree) or, without, from the seeded ``init_variables(cfg, seed)``, and
    its optimizer at step 0."""
    dev = resolve_device(device)
    if init_variables is None:
        init_variables = seeded_init(model_cfg, train_cfg.seed)
    model = jax_variables_to_train_model(init_variables, model_cfg, dev)
    return TrainState(model, make_optimizer(train_cfg, steps_per_epoch,
                                            model))


def _stream_seed(seed: int, step: int, stream: int) -> int:
    return ((int(seed) * 1_000_003 + int(step)) * 2 + stream) % (1 << 63)


def _precision(model: AttentionASPPUNetTrain):
    """f32 training computes in exact f32 (cuDNN's TF32 off), so that a card
    and the CPU agree; bf16 is left to cuDNN."""
    return exact_f32() if model.dtype == torch.float32 else \
        contextlib.nullcontext()


def _to_device(a, dev: torch.device) -> torch.Tensor:
    """A batch (numpy or tensor) on ``dev``; host memory is pinned first, so
    that the copy does not wait for the device."""
    t = a if torch.is_tensor(a) else torch.from_numpy(np.ascontiguousarray(a))
    if dev.type == "cuda" and t.device.type == "cpu":
        return t.pin_memory().to(dev, non_blocking=True)
    return t.to(dev)


@torch.no_grad()
def _metrics(loss, logits, y) -> torch.Tensor:
    """(loss, dice, iou) as one (3,) device tensor."""
    return torch.stack([loss.detach(), 1.0 - dice_loss(logits.detach(), y),
                        iou_score(logits.detach(), y)])


def loss_and_grads(state: TrainState, cfg: Config, x: torch.Tensor,
                   y: torch.Tensor, generator: Optional[torch.Generator] = None):
    """Forward in training mode (BatchNorm's running statistics update) and
    backward of the criterion on an augmented batch: (loss, logits,
    gradients in the order of ``state.opt.params``).  Under a process group
    ``x`` and ``y`` are this rank's rows, the loss is the global batch's and
    so are the gradients returned (summed over the ranks here)."""
    model = state.model
    criterion = build_criterion(cfg.train.loss, cfg.train.stage)
    model.train()
    with _precision(model):
        logits, _ = model(x, generator=generator)
        loss = criterion(logits, y)
        grads = torch.autograd.grad(loss, state.opt.params)
    return loss, logits, mesh.all_reduce_grads(list(grads))


def train_step(state: TrainState, cfg: Config, images_u8, masks_u8,
               aug_params: Optional[Dict[str, torch.Tensor]] = None
               ) -> torch.Tensor:
    """One update on a (B, S, S) uint8 batch (numpy or tensors): draw the
    augmentation of this step (or take ``aug_params``), augment on the
    device, forward and backward in training mode, AdamW.  Returns the
    (loss, dice, iou) of the batch before the update, on the device.

    Under a process group the batch is this rank's rows of the global batch
    (:func:`parallel.mesh.shard_rows`); the parameters are drawn (or given)
    for the global batch and sliced the same way."""
    dev = next(state.model.parameters()).device
    imgs, msks = _to_device(images_u8, dev), _to_device(masks_u8, dev)
    if aug_params is None:
        gen = torch.Generator().manual_seed(
            _stream_seed(cfg.train.seed, state.step, 0))
        B, H, W = imgs.shape
        aug_params = sample_params(gen, B * mesh.group_size(), H, W,
                                   cfg.train.augment)
    aug_params = {k: mesh.shard_rows(v) for k, v in aug_params.items()}
    drop = torch.Generator(device=dev).manual_seed(
        _stream_seed(cfg.train.seed, state.step, 1))
    x, y = augment_batch(imgs, msks, cfg.train.augment, aug_params,
                         train=True)
    loss, logits, grads = loss_and_grads(state, cfg, x, y, drop)
    state.opt.step(grads)
    return _metrics(loss, logits, y)


@torch.no_grad()
def eval_step(state: TrainState, cfg: Config, images_u8, masks_u8
              ) -> torch.Tensor:
    """(loss, dice, iou) of a val batch: the eval tail of the augmentation
    (CLAHE + median-3), the forward with the running statistics.  Under a
    process group, of the global batch whose rows these are."""
    model = state.model
    dev = next(model.parameters()).device
    x, y = augment_batch(_to_device(images_u8, dev),
                         _to_device(masks_u8, dev), cfg.train.augment,
                         train=False)
    model.eval()
    with _precision(model):
        logits, _ = model(x)
    loss = build_criterion(cfg.train.loss, cfg.train.stage)(logits, y)
    return _metrics(loss, logits, y)


def save_checkpoint(path: Path, state: TrainState,
                    extra: Optional[Dict] = None) -> None:
    """Model + optimizer + step in one file (written to a temporary name,
    then renamed); ``extra`` goes to the ``<path>.extra.json`` side file."""
    path = Path(path)
    tmp = path.with_name(path.name + ".tmp")
    torch.save({"format": CKPT_FORMAT, "model": state.model.state_dict(),
                "opt": state.opt.state_dict(), "step": state.step}, tmp)
    os.replace(tmp, path)
    Path(str(path) + ".extra.json").write_text(json.dumps(extra or {}))


def read_checkpoint(path: Path, map_location="cpu") -> Dict[str, Any]:
    """The saved dict of a port checkpoint; raises ValueError for any other
    file."""
    try:
        ck = torch.load(Path(path), map_location=map_location,
                        weights_only=True)
    except (pickle.UnpicklingError, RuntimeError, EOFError) as err:
        raise ValueError(f"{path}: not a checkpoint of this package "
                         f"({type(err).__name__}: {err})") from None
    if not (isinstance(ck, dict) and ck.get("format") == CKPT_FORMAT):
        raise ValueError(f"{path}: not a checkpoint of this package")
    return ck


def load_checkpoint(path: Path, state: TrainState) -> Dict:
    """Restore model, optimizer and step into ``state`` in place; returns the
    side file's ``extra`` dict."""
    dev = next(state.model.parameters()).device
    ck = read_checkpoint(path, map_location=dev)
    state.model.load_state_dict(ck["model"], strict=True)
    state.opt.load_state_dict(ck["opt"])
    side = Path(str(path) + ".extra.json")
    return json.loads(side.read_text()) if side.exists() else {}


def fit(cfg: Config, train_ds: ArrayDataset, val_ds: ArrayDataset,
        output_dir: Path, init_variables: Optional[dict] = None,
        resume: bool = True, device="cuda", devices=None,
        log: Callable[[str], None] = print) -> Dict[str, Any]:
    """Full training run; returns {"best_dice", "best_path", "epochs_run",
    "metrics_csv"}.  With ``resume`` and a ``last`` checkpoint under the
    stage's directory, model, optimizer and epoch are restored and the run
    continues.

    ``devices`` (default: for ``device="cuda"``, every visible card that
    ``make_mesh_for_batch`` admits for the batch size; else ``device``
    alone) lists the data devices.  With more than one, one process per
    device runs :func:`fit_rank` in a process group (NCCL over distinct
    cards, gloo otherwise); ``log`` must then be picklable.  The kernels are
    built before the ranks start, so that they do not compile side by
    side."""
    if devices is None:
        dev = resolve_device(device)
        devices = (mesh.make_mesh_for_batch(cfg.mesh, cfg.train.batch_size)
                   if dev.type == "cuda" and dev.index is None else [dev])
    devices = mesh.resolve_devices(devices)
    if len(devices) == 1:
        return fit_rank(cfg, train_ds, val_ds, output_dir, init_variables,
                        resume, devices[0], log)
    if cfg.train.batch_size % len(devices):
        raise ValueError(f"batch {cfg.train.batch_size} does not split over "
                         f"{len(devices)} devices")
    if any(d.type == "cuda" for d in devices):
        from ..ops.kernels import _build
        _build.build_all()
    with tempfile.TemporaryDirectory(prefix="fit_") as tmp:
        result = Path(tmp) / "result.json"
        mesh.run_ranks(_fit_worker, devices, cfg, train_ds, val_ds,
                       str(output_dir), init_variables, resume, log,
                       str(result))
        return json.loads(result.read_text())


def _fit_worker(rank: int, device: torch.device, cfg: Config, train_ds,
                val_ds, output_dir: str, init_variables, resume: bool, log,
                result: str) -> None:
    out = fit_rank(cfg, train_ds, val_ds, Path(output_dir), init_variables,
                   resume, device, log)
    if rank == 0:
        Path(result).write_text(json.dumps(out))


def fit_rank(cfg: Config, train_ds: ArrayDataset, val_ds: ArrayDataset,
             output_dir: Path, init_variables: Optional[dict] = None,
             resume: bool = True, device="cuda",
             log: Callable[[str], None] = print) -> Dict[str, Any]:
    """The training run of one process on ``device``: the whole of it
    without a process group, this rank's part under one (every rank returns
    the same dict).  Train batches split over the ranks; an eval batch that
    does not split (the ragged last one) runs whole on every rank."""
    tcfg = cfg.train
    primary = mesh.is_primary()
    if not primary:
        log = _no_log
    steps_per_epoch = max(len(train_ds) // tcfg.batch_size, 1)
    state = create_train_state(cfg.model, tcfg, steps_per_epoch, device,
                               init_variables)

    out_dir = Path(output_dir) / ("ckpt_main" if tcfg.stage == "main"
                                  else "ckpt_finetune")
    out_dir.mkdir(parents=True, exist_ok=True)
    best, best_path, noimp = 0.0, out_dir / "best", 0
    last_path = out_dir / "last"
    start_epoch = 1

    if resume and last_path.exists():
        extra = load_checkpoint(last_path, state)
        start_epoch = int(extra.get("epoch", 0)) + 1
        best = float(extra.get("best", 0.0))
        noimp = int(extra.get("noimp", 0))
        log(f"resumed from {last_path} at epoch {start_epoch} "
            f"(best Dice {best:.4f})")

    def val_batch(imgs, msks):
        if len(imgs) % mesh.group_size():
            with mesh.local():
                return eval_step(state, cfg, imgs, msks)
        return eval_step(state, cfg, mesh.shard_rows(imgs),
                         mesh.shard_rows(msks))

    csv_path = out_dir / "metrics.csv"
    epochs_run = start_epoch - 1
    with (open(csv_path, "a" if start_epoch > 1 else "w", newline="")
          if primary else contextlib.nullcontext()) as f:
        writer = csv.writer(f) if primary else None
        if primary and start_epoch == 1:
            writer.writerow(["epoch", "train_loss", "val_loss", "train_dice",
                             "val_dice", "train_iou", "val_iou", "secs"])
        for epoch in range(start_epoch, tcfg.epochs + 1):
            t0 = time.time()
            tr = [train_step(state, cfg, mesh.shard_rows(imgs),
                             mesh.shard_rows(msks)) for imgs, msks in
                  epoch_batches(train_ds, tcfg.batch_size, tcfg.seed, epoch)]
            va = [val_batch(imgs, msks) for imgs, msks in
                  epoch_batches(val_ds, tcfg.batch_size, tcfg.seed, epoch,
                                shuffle=False, drop_last=False)]
            dev = next(state.model.parameters()).device
            zeros = torch.zeros(3, device=dev)
            # rank 0's numbers decide on every rank; the epoch's one
            # crossing to the host
            m = mesh.broadcast_from_primary(torch.cat([
                torch.stack(tr).mean(0).float() if tr else zeros,
                torch.stack(va).mean(0).float() if va else zeros]))
            tr_m, va_m = m[:3].tolist(), m[3:].tolist()
            row = [epoch, tr_m[0], va_m[0], tr_m[1], va_m[1], tr_m[2],
                   va_m[2], round(time.time() - t0, 2)]
            if primary:
                writer.writerow([f"{v:.6f}" if isinstance(v, float) else v
                                 for v in row])
                f.flush()
            val_dice = row[4]
            log(f"epoch {epoch}/{tcfg.epochs}  Dice {val_dice:.4f} | "
                f"IoU {row[6]:.4f} | loss {row[2]:.4f}")
            epochs_run = epoch

            if val_dice > best:
                best, noimp = val_dice, 0
                if primary:
                    save_checkpoint(best_path, state,
                                    {"epoch": epoch, "val_dice": val_dice})
                log(f"best saved → {best_path}")
            else:
                noimp += 1
            if primary:
                save_checkpoint(last_path, state, {"epoch": epoch,
                                                   "best": best,
                                                   "noimp": noimp})
            if noimp >= tcfg.early_stop_patience:
                log("Early stop")
                break

    return {"best_dice": best, "best_path": str(best_path),
            "epochs_run": epochs_run, "metrics_csv": str(csv_path)}


def _no_log(msg: str) -> None:
    pass
