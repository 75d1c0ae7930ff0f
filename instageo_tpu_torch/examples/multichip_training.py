"""Multi-card training walkthrough: DP, ZeRO-1, tensor parallelism, FSDP.

One process per card (or per CPU rank) under ``torch.distributed.run``:

    python -m torch.distributed.run --standalone --nproc-per-node N \\
        -m instageo_tpu_torch.examples.multichip_training /tmp/instageo_multichip [--device cpu]

Without ``torchrun`` it runs as a world of one. Shows the four placements
of the JAX walkthrough (``examples/multichip_training.py``) and what each
does to the state layout:

1. pure data parallelism (each rank its rows of the batch, the parameters
   replicated, gradients all-reduced);
2. + ZeRO-1 (``tpu.zero1``: the AdamW moments sharded over the data axis,
   ``ZeroRedundancyOptimizer``);
3. + tensor parallelism (``tpu.tp=2``: the transformer's matmuls column /
   row sharded over whole heads on a (data, model) mesh, ``parallel/tp.py``);
   it needs two ranks, and at a world of one it is skipped, said so;
4. FSDP / ZeRO-3 (``tpu.fsdp``: the parameters themselves sharded over
   the data axis, FSDP2 ``DTensor``s, ``parallel/fsdp.py``).

The process group comes from ``parallel/multihost.py``: NCCL on cards, gloo
on the CPU. The model is ``prithvi_eo_tiny`` at 32 px with
``tpu.precision: f32``, at the JAX walkthrough's sizes (a global batch of
two rows per rank, the same batch twice); float32 attention takes the
"xla" route, so no attention kernel launches, and the launch count printed
at the end says so (the head's dropouts run kernel #6 in float32). Per placement it prints the mesh, the loss and how the
qkv weight is placed; ``multichip_results.json`` keeps them with each
step's loss.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Optional, Sequence

import numpy as np

# Runnable from anywhere without installing the package.
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

PLACEMENTS = [
    ("data parallel", {}),
    ("DP + ZeRO-1", {"tpu.zero1": True}),
    ("DP x TP(2) + ZeRO-1", {"tpu.tp": 2, "tpu.zero1": True}),
    ("FSDP (ZeRO-3)", {"tpu.fsdp": True}),
]


def qkv_placement(model) -> str:
    """How block 0's qkv weight lies on this rank: a ``DTensor``'s
    placements, a tensor-parallel shard's shape, or replicated."""
    w = model.prithvi_encoder.blocks[0].attn.qkv.weight
    d = model.prithvi_encoder.embed_dim
    if hasattr(w, "placements"):
        return (f"DTensor {tuple(repr(p) for p in w.placements)} over "
                f"{tuple(w.device_mesh.mesh_dim_names)}, local {tuple(w.to_local().shape)} "
                f"of {tuple(w.shape)}")
    if tuple(w.shape) != (3 * d, d):
        return f"tp shard {tuple(w.shape)} of {(3 * d, d)}"
    return f"replicated {tuple(w.shape)}"


def main(argv: Optional[Sequence[str]] = None) -> None:
    import torch
    import torch.distributed as dist

    from instageo_tpu_torch.configs.config import load_config
    from instageo_tpu_torch.device import resolve_device
    from instageo_tpu_torch.parallel.mesh import mesh_from_config
    from instageo_tpu_torch.parallel.multihost import initialize_multihost, is_main_process
    from instageo_tpu_torch.train.factory import create_model
    from instageo_tpu_torch.train.trainer import Trainer
    from instageo_tpu_torch.utils.telemetry import kernel_launches

    parser = argparse.ArgumentParser()
    parser.add_argument("out_dir", nargs="?", default="/tmp/instageo_multichip")
    parser.add_argument("--device", default="cuda",
                        help="'cuda' (one card per process, NCCL) or 'cpu' (gloo).")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    os.makedirs(args.out_dir, exist_ok=True)
    if "WORLD_SIZE" not in os.environ:  # not under torchrun: a world of one
        rendezvous = os.path.join(args.out_dir, "rendezvous")
        if os.path.exists(rendezvous):
            os.remove(rendezvous)
        initialize_multihost(device.type, init_method=f"file://{rendezvous}",
                             world_size=1, rank=0)
    else:
        initialize_multihost(device.type)
    if device.type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
    n = dist.get_world_size()
    main_process = is_main_process()
    say = print if main_process else (lambda *a, **k: None)
    say(f"devices: {n} x {device.type}")

    rng = np.random.default_rng(0)
    x = rng.normal(size=(n * 2, 6, 1, 32, 32)).astype(np.float32)
    y = rng.integers(0, 2, size=(n * 2, 32, 32)).astype(np.int32)

    results, skipped = {}, {}
    try:
        for title, tpu_overrides in PLACEMENTS:
            tp = int(tpu_overrides.get("tpu.tp", 1))
            if n % tp or n < tp:
                skipped[title] = f"tpu.tp={tp} needs a world of a multiple of {tp} ranks; " \
                                 f"this one has {n}"
                say(f"[{title}] skipped: {skipped[title]}")
                continue
            cfg = load_config("config", overrides={
                "dataloader.img_size": 32,
                "dataloader.bands": [0, 1, 2, 3, 4, 5],
                "model.model_name": "prithvi_eo_tiny",
                "model.load_pretrained_weights": False,
                "train.batch_size": n * 2,
                "train.ignore_index": -1,
                "tpu.precision": "f32",
                "device": device.type,
                **tpu_overrides,
            })
            mesh = mesh_from_config(cfg.get("tpu"))
            model = create_model(cfg, device=device, training=True)
            trainer = Trainer(cfg, model, device=device, mesh=mesh)
            losses: list = []
            metrics = trainer.run_train_epoch(iter([(x, y)] * 2), torch.Generator().manual_seed(0),
                                              n * 2, losses)
            shape = dict(zip(mesh.mesh_dim_names, mesh.shape)) if mesh is not None else {}
            placed = qkv_placement(model)
            say(f"[{title}] mesh={shape} loss={metrics['train_loss']:.4f} "
                f"qkv placement={placed}")
            results[title] = {
                "mesh": {k: int(v) for k, v in shape.items()},
                "mode": trainer.mode,
                "train_loss": float(metrics["train_loss"]),
                "step_losses": [float(v) for v in losses],
                "qkv_placement": placed,
                "optimizer": type(trainer.optimizer).__name__,
            }
            del trainer, model
        launches = kernel_launches()
        say(f"kernel launches (float32 attention takes the xla route; the head's dropouts "
            f"are kernel #6): {json.dumps(launches)}")
        if main_process:
            with open(os.path.join(args.out_dir, "multichip_results.json"), "w") as fh:
                json.dump({"world": n, "device": device.type, "placements": results,
                           "skipped": skipped, "launches": launches}, fh, indent=2)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    say("multichip walkthrough OK")


if __name__ == "__main__":
    main()
