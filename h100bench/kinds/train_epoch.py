"""Fine-tuning: ``Trainer.run_train_epoch`` over seeded host batches.

The system under test is the program's trainer as its run CLI builds it
(``train/factory.py:create_model(..., training=True)``, then ``Trainer``),
with the configuration's ``steps_per_call`` (CUDA graphs of k steps on one
card) and ``grad_accum``. The inputs are a pool of seeded host batches of
normalised float32 chips and int64 labels (a share of them the ignore
label), drawn on the device and kept in pageable host memory.

Set-up drives the one trainer through its first 1 + 2k steps with the
window's own call and feed, on pool batches that all differ: an epoch of
one batch (step 1, a plain step; then the first moments give the gradient
AdamW got), an epoch of one full group (on a card: k plain steps, then the
group's capture) and an epoch of one more group (on a card: staged into
the group's buffers, seeds and rates from its device slots, and replayed,
as every group of the window is). Each leaf's change since step 0 is read
after the third. The device's cache is then emptied, so that it holds what
the program holds. The window is one epoch whose batch iterator stops at
the first group boundary after ``--seconds``; the epoch's end and
``_finalize`` fall inside it. ``train_chips_per_s``: the chips of every
step of the epoch over the time from its start to its return (the host has
then read the epoch's metrics, so every step is done); ``peak_gib``: the
most device memory the process held (``max_memory_reserved``, which counts
the graphs' private pools) over the window.

Checked (``check.train_numbers``): the 1 + 2k steps' losses, the first
gradient and each leaf's change after the last of them, against the
reference run from the same weights, batches and dropout seeds.
"""

from __future__ import annotations

import gc
import time
from typing import Dict, List, Tuple

import numpy as np
import torch

from h100bench import check
from h100bench.common import derive_seed, make_weights, program_config, reference_module


def _pool(ctx, n_pool: int, batch: int):
    """``n_pool`` host batches (x (B, C, T, S, S) float32 ~ N(0, 1), y
    (B, S, S) int64 uniform over the classes, ``ignore_share`` of the
    pixels the ignore label), drawn on the device."""
    m, dev = ctx.config["model"], ctx.device
    ignore = int(ctx.config["program"]["train"]["ignore_index"])
    gen = torch.Generator(device=dev).manual_seed(derive_seed(ctx.seed, "inputs"))
    shape = (batch, m["in_chans"], m["num_frames"], m["img_size"], m["img_size"])
    pool = []
    for _ in range(n_pool):
        x = torch.randn(shape, generator=gen, device=dev)
        y = torch.randint(0, m["num_classes"], (batch, m["img_size"], m["img_size"]),
                          generator=gen, device=dev)
        drop = torch.rand(y.shape, generator=gen, device=dev) < float(ctx.traffic["ignore_share"])
        y = torch.where(drop, torch.full_like(y, ignore), y)
        pool.append((x.cpu().numpy(), y.cpu().numpy()))
    return pool


def _leaves(model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """Parameters and the BatchNorm running statistics, by state-dict name."""
    out = dict(model.named_parameters())
    out.update({n: b for n, b in model.named_buffers() if n.endswith(("running_mean",
                                                                      "running_var"))})
    return out


def _norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    names = list(tensors)
    if not names:
        return {}
    vals = torch.stack([tensors[n].detach().float().norm() for n in names]).tolist()
    return dict(zip(names, vals))


def check_steps(cfg, device: torch.device, in_chans: int, batch: int) -> Tuple[int, int]:
    """(k, 1 + 2k): the trainer's steps per group for this batch, and the
    steps the check follows."""
    from instageo_tpu_torch.train.factory import steps_per_call

    k = steps_per_call(cfg, device.type, in_chans, batch)
    return k, 1 + 2 * k


def run(ctx) -> Dict:
    tr = ctx.traffic
    batch, n_pool = int(tr["batch"]), int(tr["pool"])
    dev, ev = ctx.device, ctx.events
    ref = reference_module(ctx.config)
    m = ctx.config["model"]
    cfg = program_config(ctx.config, ctx.overrides)
    k, n_check = check_steps(cfg, dev, m["in_chans"], batch)
    if n_pool < n_check:
        raise ValueError(f"a pool of {n_pool} batches: the check's {n_check} steps "
                         f"(1 + 2 x {k}) want batches that all differ")
    pool = _pool(ctx, n_pool, batch)
    ctx.lap("batches")
    gen_seed = derive_seed(ctx.seed, "dropout")
    if ctx.control is not None:   # the reference in the program's place
        quant = "fp8" if ctx.control == "fp8" else None
        side = reference_side(ctx, ref, m, pool, n_check, gen_seed, quant=quant,
                              fault=None if quant else ctx.control)
        prog = {"losses": side["losses"], "grad1": _norms(side["grad1"]),
                "change": {n: t.cpu() for n, t in side["change"].items()}}
        del side
        return finish(ctx, ref, m, pool, n_check, gen_seed, prog, {}, 0, 0)

    # --- set-up: the checked steps, a group captured and one replayed -------
    from instageo_tpu_torch.ops import _build
    from instageo_tpu_torch.train.factory import create_model
    from instageo_tpu_torch.train.trainer import Trainer

    model = create_model(cfg, device=dev, training=True)
    model.load_state_dict(make_weights(ref.param_spec(m), ctx.seed, dev), strict=True)
    trainer = Trainer(cfg, model, device=dev)
    ctx.lap("model and trainer")
    gen = torch.Generator().manual_seed(gen_seed)
    leaves = _leaves(model)
    start = {n: t.detach().clone() for n, t in leaves.items()}
    losses: List[torch.Tensor] = []
    trainer.run_train_epoch([pool[0]], gen, batch, losses)
    b1 = trainer.optimizer.param_groups[0]["betas"][0]
    names = {id(p): n for n, p in model.named_parameters()}
    grad1 = _norms({names[id(p)]: st["exp_avg"] / (1.0 - b1)
                    for p, st in trainer.optimizer.state.items()})
    ctx.lap("step 1")
    trainer.run_train_epoch(pool[1:1 + k], gen, batch, losses)   # plain steps, the capture
    ev.sync()
    ctx.lap(f"{k} plain steps and the capture")
    replays = _build.graph_replays.count
    trainer.run_train_epoch(pool[1 + k:n_check], gen, batch, losses)   # the first replay
    ev.sync()
    ctx.lap("the first replay")
    # Kept on the host until the reference has its gradients.
    change = {n: (t.detach() - start[n]).float().cpu() for n, t in leaves.items()}
    prog = {"losses": [float(x) for x in losses], "grad1": grad1, "change": change}
    ctx.notes.append(f"checked steps: 1, then {k} and {k} (graph replays in the last: "
                     f"{_build.graph_replays.count - replays})")
    del start, losses
    if ctx.seconds <= 0:                       # readings only: no window
        del trainer, model, leaves
        return finish(ctx, ref, m, pool, n_check, gen_seed, prog, {}, 0, 0)
    order = np.random.default_rng(derive_seed(ctx.seed, "order")).permutation(n_pool)
    cursor = [0]

    def take(n: int):
        out = []
        for _ in range(n):
            out.append(pool[int(order[cursor[0] % n_pool])])
            cursor[0] += 1
        return out

    # --- the window ---------------------------------------------------------
    trace = ctx.tracer if ctx.trace else None
    t_a, t_b = tr["trace_steps"] if trace is not None else (0, 0)
    counts = {"steps": 0}

    def feed():
        phase = "before"
        while True:
            if trace is not None and phase == "before" and counts["steps"] >= t_a:
                ev.sync()
                trace.start()
                phase, first = "on", counts["steps"]
            elif phase == "on" and counts["steps"] - first >= t_b:
                trace.stop(chips=batch * (counts["steps"] - first),
                           steps=counts["steps"] - first)
                phase = "after"
            over = time.perf_counter() - t_start >= ctx.seconds
            if over and (trace is None or phase == "after"):
                return
            with torch.profiler.record_function("bench.next_group"):
                group = take(k)
            for b in group:
                counts["steps"] += 1
                yield b

    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()   # the device then holds what the program holds
        torch.cuda.reset_peak_memory_stats()
    t_start = time.perf_counter()
    setup_s = t_start - ctx.t_process
    trainer.run_train_epoch(feed(), gen, batch)
    t_end = time.perf_counter()
    memory_peak = torch.cuda.max_memory_reserved() if dev.type == "cuda" else 0
    steps = counts["steps"]
    metrics = {"train_chips_per_s": batch * steps / (t_end - t_start),
               "peak_gib": memory_peak / 2**30, "setup_s": setup_s}
    ctx.notes.append(f"window: {steps} steps of {batch} chips (k={k}) in "
                     f"{t_end - t_start:.3f} s")
    del trainer, model, leaves
    return finish(ctx, ref, m, pool, n_check, gen_seed, prog, metrics, steps, memory_peak)


def finish(ctx, ref, m, pool, n_check, gen_seed, prog, metrics, steps, memory_peak) -> Dict:
    """Free the program's state, run the reference, judge."""
    gc.collect()
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    ref_side = reference_side(ctx, ref, m, pool, n_check, gen_seed)
    prog_change, ref_change, left_leaves, left = check.moving_change(
        prog["change"], ref_side["change"], ref_side["grad1"])
    ref_grad = {n: v for n, v in _norms(ref_side["grad1"]).items() if n not in left_leaves}
    numbers = check.train_numbers(
        {"losses": prog["losses"], "grad1": prog["grad1"], "change": prog_change},
        {"losses": ref_side["losses"], "grad1": ref_grad, "change": ref_change})
    correct, shown = check.judge(numbers, ctx.limits)
    ctx.notes.append(f"losses: program {prog['losses']}, reference {ref_side['losses']}")
    ctx.notes.append(f"worst leaves: gradient {numbers['_grad_worst']}, change "
                     f"{numbers['_change_worst']}; leaves left out: {left_leaves}; elements "
                     f"of the others left out of the change: {left}")
    return {"metrics": metrics, "attempted": steps, "failed": 0,
            "memory_peak_bytes": memory_peak, "correct": correct, "check": shown,
            "numbers": numbers, "steps": steps}


def reference_side(ctx, ref, m, pool, n_check, gen_seed, quant=None, fault=None) -> Dict:
    """The reference's first ``n_check`` steps from the same weights,
    batches and dropout seeds as the program's: losses, the first gradient
    and each leaf's change after them (tensors, on the device). ``fault``:
    ``"stale_group"`` gives the last group of k steps the batches of the
    group before (a stage that was not refilled); ``"group_unchanged"``
    leaves the state as the last group found it; else as ``train_steps``
    takes it."""
    dev = ctx.device
    ref.exact_float32()
    tr_cfg = dict(ctx.config["program"]["train"])
    params = {n: t.clone() for n, t in make_weights(ref.param_spec(m), ctx.seed, dev).items()}
    start = {n: t.clone() for n, t in params.items() if _compared(n)}
    calls = (len(m["head_kernels"]) + 1) * int(tr_cfg.get("grad_accum", 1))
    seeds = ref.step_seeds(torch.Generator().manual_seed(gen_seed), n_check, calls)
    batches = [(torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev))
               for x, y in pool[:n_check]]
    k = (n_check - 1) // 2
    if fault == "stale_group":   # the last group trains on the batches of the one before
        batches[1 + k:] = batches[1:1 + k]
        fault = None
    elif fault == "group_unchanged":   # the last group leaves the state as it was
        batches, seeds, fault = batches[:1 + k], seeds[:1 + k], None
    out = ref.train_steps(params, m, tr_cfg, batches, seeds, quant=quant, fault=fault)
    for n in start:
        start[n] = params[n] - start[n]
    return {"losses": out["losses"], "grad1": out["grad1"], "change": start}


def _compared(name: str) -> bool:
    return not name.endswith("num_batches_tracked")
