"""The comparisons that decide ``correct``: what the timed path produced,
against the plain reference, each number beside its limit
(``limits/<cell>.json``).

Serving: every kept answer is a map of classes; each pixel's served class
is judged by the gap by which the reference's logit for it lies below the
reference's best logit at that pixel, in units of the reference logits'
spread over the classes (their root mean square about each pixel's mean).
``max_gap`` is the widest such gap over every kept pixel, ``mean_gap`` the
mean over them, ``wrong_share`` the share of them whose gap exceeds the
cell's ``_wrong_gap``.

Training: the first steps' losses, the first step's gradient of each
parameter (as AdamW got it: its first moment after one step ÷ (1 − β1)),
and each leaf's change over the first steps; norms are compared leaf by
leaf, the gap of the two norms against the larger of the reference leaf's
norm and the median leaf's; ``grad_leaf`` and ``change_leaf`` are the
worst leaf's gap, ``change_median`` the median leaf's. Leaves and
elements whose reference gradient is nought (under a thousandth of the
median leaf's: a bias under a BatchNorm, a key's bias under softmax) move
by round-off alone under Adam and are left out (``moving``).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

TINY_GRAD = 1e-3   # a gradient under this share of the median leaf's is nought


SHARE_GAPS = (0.03, 0.05, 0.08, 0.1, 0.12, 0.15)   # shares read for the readings


class GapStats:
    """Running widest and mean gap of served classes, and the share of
    pixels whose gap exceeds ``wrong_gap`` (``wrong_share``: classes that
    are wrong by more than rounding can explain), with the shares over
    ``SHARE_GAPS`` for the readings."""

    def __init__(self, wrong_gap: Optional[float] = None) -> None:
        self.max = 0.0
        self.total = 0.0
        self.pixels = 0
        self.wrong_gap = wrong_gap
        self.over = {t: 0 for t in SHARE_GAPS + ((wrong_gap,) if wrong_gap else ())}

    def add(self, ref_logits: torch.Tensor, served: torch.Tensor) -> None:
        """ref_logits (B, C, H, W) float32; served (B, H, W) classes."""
        spread = (ref_logits - ref_logits.mean(dim=1, keepdim=True)).square().mean().sqrt()
        best = ref_logits.amax(dim=1)
        got = ref_logits.gather(1, served.long().clamp(0, ref_logits.shape[1] - 1)[:, None])[:, 0]
        gap = (best - got) / spread.clamp_min(1e-30)
        bad = (served.long() < 0) | (served.long() >= ref_logits.shape[1])
        gap = torch.where(bad, torch.full_like(gap, float("inf")), gap)
        self.max = max(self.max, float(gap.max()))
        self.total += float(gap.double().sum())
        self.pixels += gap.numel()
        for t in self.over:
            self.over[t] += int((gap > t).sum())

    def numbers(self) -> Dict[str, float]:
        n = max(self.pixels, 1)
        out = {"max_gap": self.max,
               "mean_gap": self.total / self.pixels if self.pixels else float("inf")}
        if self.wrong_gap:
            out["wrong_share"] = self.over[self.wrong_gap] / n if self.pixels else float("inf")
        out.update({f"_share_gt_{t}": c / n for t, c in self.over.items()})
        return out


def leaf_gaps(prog: Dict[str, float], ref: Dict[str, float]) -> Tuple[float, str]:
    """max over the reference's leaves of |‖prog‖ − ‖ref‖| ÷ max(‖ref‖,
    median leaf ‖ref‖), and the worst leaf's name; a leaf missing on the
    program's side, or a NaN, reads infinity."""
    med = _median(list(ref.values()))
    worst, worst_name = 0.0, ""
    for n, r in ref.items():
        if n not in prog:
            return float("inf"), n
        gap = abs(prog[n] - r) / max(r, med, 1e-30)
        if gap != gap:  # NaN
            return float("inf"), n
        if gap > worst:
            worst, worst_name = gap, n
    return worst, worst_name


def _median(values: List[float]) -> float:
    s = sorted(values)
    if not s:
        return 0.0
    mid = len(s) // 2
    return s[mid] if len(s) % 2 else 0.5 * (s[mid - 1] + s[mid])


def train_numbers(prog: Dict, ref: Dict) -> Dict[str, float]:
    """prog and ref: {"losses": [...], "grad1": {leaf: norm},
    "change": {leaf: norm}} (the change over the moving elements only,
    ``moving_change``)."""
    loss = 0.0
    for lp, lr in zip(prog["losses"], ref["losses"]):
        gap = abs(lp - lr) / max(abs(lr), 1e-30)
        loss = max(loss, gap if gap == gap else float("inf"))
    if len(prog["losses"]) != len(ref["losses"]):
        loss = float("inf")
    grad, grad_leaf = leaf_gaps(prog["grad1"], ref["grad1"])
    change, change_leaf = leaf_gaps(prog["change"], ref["change"])
    loss1 = abs(prog["losses"][0] - ref["losses"][0]) / max(abs(ref["losses"][0]), 1e-30)
    return {"loss": loss, "grad_leaf": grad, "change_leaf": change,
            "_loss1": loss1 if loss1 == loss1 else float("inf"),
            "_grad_median": _median_gap(prog["grad1"], ref["grad1"]),
            "change_median": _median_gap(prog["change"], ref["change"]),
            "_grad_worst": grad_leaf, "_change_worst": change_leaf}


def _median_gap(prog: Dict[str, float], ref: Dict[str, float]) -> float:
    med = _median(list(ref.values()))
    return _median([abs(prog.get(n, float("inf")) - r) / max(r, med, 1e-30)
                    for n, r in ref.items()])


def moving(ref_grad1: Dict[str, torch.Tensor]) -> Tuple[List[str], float]:
    """The leaves that count, and the element threshold: a leaf whose
    reference gradient at step 1 has a norm under ``TINY_GRAD`` × the median
    leaf's (a bias under BatchNorm sees none) moves by round-off alone
    under Adam and is left out of both comparisons; within the others, an
    element whose reference gradient is under ``TINY_GRAD`` × the median
    leaf's root-mean-square gradient (a key's bias under softmax) is left
    out of the change."""
    norms = {n: float(g.norm()) for n, g in ref_grad1.items()}
    med = _median(list(norms.values()))
    keep = [n for n, v in norms.items() if v >= TINY_GRAD * med]
    rms = _median([norms[n] / max(g.numel(), 1) ** 0.5 for n, g in ref_grad1.items()])
    return keep, TINY_GRAD * rms


def moving_change(prog_change: Dict[str, torch.Tensor], ref_change: Dict[str, torch.Tensor],
                  ref_grad1: Dict[str, torch.Tensor]):
    """Norms of each counted leaf's change over its moving elements
    (``moving``), on both sides; leaves without a gradient (BatchNorm's
    running statistics) are compared whole. Returns (prog norms, ref
    norms, names of the leaves left out, elements left out)."""
    keep, thresh = moving(ref_grad1)
    kept = set(keep)
    prog_n, ref_n, left = {}, {}, 0
    for name, rc in ref_change.items():
        g = ref_grad1.get(name)
        if g is not None and name not in kept:
            continue
        mask = torch.ones_like(rc, dtype=torch.bool) if g is None else g.abs() >= thresh
        left += int((~mask).sum())
        ref_n[name] = float(rc[mask].norm())
        if name in prog_change:
            prog_n[name] = float(prog_change[name].to(rc.device).float()[mask].norm())
    return prog_n, ref_n, sorted(set(ref_grad1) - kept), left


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> Tuple[bool, Dict]:
    """(correct, {name: {"value", "limit"}}): every number that the
    cell's limits name is at or under its limit. The limits file's keys
    that start with ``_`` are settings, not limits."""
    shown, ok = {}, True
    for name, limit in limits.items():
        if name.startswith("_"):
            continue
        value = numbers.get(name)
        shown[name] = {"value": value, "limit": limit}
        if value is None or not value <= limit:
            ok = False
    return ok, shown
