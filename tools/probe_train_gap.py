#!/usr/bin/env python3
"""Where the gradients of a kernel train step and a plain one part, on one
CUDA card.

    python3 tools/probe_train_gap.py [--head torch|fast] [--steps 10 20] [--reps 2]

Builds the crop config's model (Prithvi-V1-100M, T=3, 224 px, 13 classes,
float32 parameters, bf16 compute, random weights from seed 0) with the
chosen head, trains it ``--steps`` steps on one batch of 8 (dropout on,
``chip_smoke.py``'s synthetic batch), and from that state takes one step
(dropout off) with each attention route:

* ``kernel``: the Hopper forward and backward (what ``chip_smoke.py``
  holds against the plain step);
* ``fwd kernel``: the kernel forward, the plain backward;
* ``bwd kernel``: the plain forward, the kernel backward;
* ``plain f32 P``: the plain forward with P left in float32 for the PV
  product, a rounding point the TPU kernel places otherwise; a yardstick
  of how far one rounding choice in the attention moves the gradients.

Prints, for each, ‖g − g_plain‖ / ‖g_plain‖ per parameter: the worst three,
the median, and the first head stage's convolution. Repeats ``--reps``
times from a fresh model: the wgmma backward adds dQ in a run-dependent
order, so the kernel rows vary a little from run to run.

Imports nothing of JAX. Exits non-zero where CUDA is not available.
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _routes(attention, f32p):
    """Route name -> (model attn_impl, {module global: replacement})."""
    return {
        "kernel": ("kernel", {}),
        "fwd kernel": ("kernel", {"flash_attention_bwd": attention.flash_attention_bwd_plain}),
        "bwd kernel": ("kernel", {"flash_attn_fwd_op": attention.flash_attention_fwd_plain}),
        "plain f32 P": ("plain", {"flash_attention_fwd_plain": f32p}),
    }


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--head", choices=("torch", "fast"), default="fast")
    parser.add_argument("--steps", type=int, nargs="+", default=[10, 20])
    parser.add_argument("--reps", type=int, default=2)
    args = parser.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("probe_train_gap: CUDA is not available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import chip_smoke as cs
    from instageo_tpu_torch.models.seg import create_prithvi_seg, train_mode
    from instageo_tpu_torch.ops import attention
    from instageo_tpu_torch.train.trainer import Trainer

    device = torch.device("cuda")
    _, model_kw, train_cfg, data = cs.crop_setup()
    first_conv = "fast_up_0.2.weight" if args.head == "fast" else "segmentation_head.0.2.weight"
    routes = _routes(attention, cs.attention_fwd_plain_f32p)

    def grads_of(model, impl: str, patch: dict, state: dict, xb, yb) -> dict:
        saved = {name: getattr(attention, name) for name in patch}
        try:
            for name, fn in patch.items():
                setattr(attention, name, fn)
            model.load_state_dict(state)
            for blk in model.prithvi_encoder.blocks:
                blk.attn.attn_impl = impl
            train_mode(model, torch.Generator(), dropout_rate=0.0)
            Trainer(train_cfg, model, device=device).train_step(xb, yb, torch.Generator())
            return {n: p.grad.float().clone() for n, p in model.named_parameters()}
        finally:
            for name, fn in saved.items():
                setattr(attention, name, fn)

    for steps in args.steps:
        for rep in range(args.reps):
            model = create_prithvi_seg(**model_kw, head_impl=args.head, dtype=torch.bfloat16,
                                       param_dtype=torch.float32, device=device, seed=0)
            trainer = Trainer(train_cfg, model, device=device)
            x, y = cs._crop_batch(8, model_kw["temporal_step"], model_kw["image_size"],
                                  model_kw["num_classes"], seed=1, data=data)
            xb, yb = trainer.prepare_batch(x, y, 8)
            gen = torch.Generator().manual_seed(0)
            losses = [float(trainer.train_step(xb, yb, gen)) for _ in range(steps)]
            state = {k: v.detach().clone() for k, v in model.state_dict().items()}
            ref = grads_of(model, "plain", {}, state, xb, yb)
            print(f"{args.head} head, {steps} steps (last loss {losses[-1]:.4f}), rep {rep}:",
                  flush=True)
            for name, (impl, patch) in routes.items():
                g = grads_of(model, impl, patch, state, xb, yb)
                rel = {n: ((g[n] - r).norm() / r.norm().clamp_min(1e-30)).item()
                       for n, r in ref.items() if not n.endswith(".2.bias")}
                worst = sorted(rel.items(), key=lambda kv: -kv[1])[:3]
                print(f"  {name:12s} median {float(np.median(list(rel.values()))):.4g}, "
                      f"{first_conv} {rel[first_conv]:.4g}, worst "
                      + ", ".join(f"{n} {v:.4g}" for n, v in worst), flush=True)
            del model, trainer
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
