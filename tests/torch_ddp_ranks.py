"""What each rank of the data-parallel training tests runs, and the same code
in one process as their reference (``tests/test_torch_ddp.py``).  Imported
by the spawned ranks, so it imports no JAX."""

import dataclasses
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from att_aspp_unet_tpu_torch.train import train_loop as ttl
from att_aspp_unet_tpu_torch.train.data import ArrayDataset
from att_aspp_unet_tpu_torch.parallel.mesh import shard_rows


def steps(cfg, variables, imgs, msks, n_steps: int = 2) -> dict:
    """``n_steps`` train steps on one fixed global batch, this process
    holding its rows of it: per step the (loss, dice, iou), the gradients
    that AdamW received and the BatchNorm buffers after it; the parameters
    after the last.  An f64 ``compute_dtype`` runs the model, its
    parameters and the optimizer's moments in f64."""
    state = ttl.create_train_state(cfg.model, cfg.train, 1, "cpu", variables)
    if cfg.model.compute_dtype == "float64":
        state.model.double()
        state = ttl.TrainState(state.model, ttl.make_optimizer(
            cfg.train, 1, state.model))
    grads = []
    update = state.opt.step

    def record(g):
        grads.append({n: t.clone() for n, t in zip(state.opt.names, g)})
        update(g)

    state.opt.step = record
    out = {"metrics": [], "buffers": []}
    for _ in range(n_steps):
        m = ttl.train_step(state, cfg, shard_rows(imgs), shard_rows(msks))
        out["metrics"].append(m.double().numpy())
        out["buffers"].append({n: b.clone() for n, b in
                               state.model.named_buffers()})
    out["grads"] = grads
    out["params"] = {n: p.detach().clone() for n, p in
                     state.model.named_parameters()}
    return out


def fit_and_resume(cfg, data: dict, out_dir: Path) -> dict:
    """``fit_rank`` for 2 epochs, then again to 3 (resuming from ``last``);
    how many checkpoints this process wrote, and the two results."""
    saved = []
    save = ttl.save_checkpoint

    def counting_save(path, *a, **k):
        saved.append(str(path))
        save(path, *a, **k)

    train = ArrayDataset(data["train_imgs"], data["train_msks"],
                         data["train_msks"].reshape(len(data["train_msks"]),
                                                    -1).any(1))
    val = ArrayDataset(data["val_imgs"], data["val_msks"],
                       data["val_msks"].reshape(len(data["val_msks"]),
                                                -1).any(1))
    ttl.save_checkpoint = counting_save
    try:
        runs = []
        for epochs in (2, 3):
            c = dataclasses.replace(cfg, train=dataclasses.replace(
                cfg.train, epochs=epochs))
            runs.append(ttl.fit_rank(c, train, val, out_dir, device="cpu",
                                     log=_quiet))
            if dist.is_initialized():
                # the next run reads what rank 0 wrote
                dist.barrier()
    finally:
        ttl.save_checkpoint = save
    return {"saved": saved, "runs": runs}


def _quiet(msg):
    pass


def rank_work(rank: int, device, spec: dict, out_dir: str) -> None:
    """Every case of ``spec`` on this rank; the results to
    ``<out_dir>/rank<r>.pt``."""
    torch.set_num_threads(1)
    res = {name: steps(*case) for name, case in spec["steps"].items()}
    res["fit"] = fit_and_resume(spec["fit_cfg"], spec["fit_data"],
                                Path(out_dir) / "fit")
    torch.save(res, Path(out_dir) / f"rank{rank}.pt")


def fail_on_rank_1(rank: int, device) -> None:
    if rank == 1:
        raise RuntimeError("rank 1 fails")
    torch.distributed.barrier()


def positives(n: int, which, s: int, seed: int):
    """``n`` uint8 images with a bright disc on the rows ``which`` and their
    masks (empty elsewhere)."""
    rng = np.random.default_rng(seed)
    imgs = (rng.random((n, s, s)) * 60).astype(np.uint8)
    msks = np.zeros((n, s, s), np.uint8)
    yy, xx = np.mgrid[:s, :s]
    for i in which:
        cy, cx = rng.integers(s // 3, s - s // 3, 2)
        blob = (yy - cy) ** 2 + (xx - cx) ** 2 <= (s // 5) ** 2
        imgs[i][blob] = 220
        msks[i][blob] = 255
    return imgs, msks
