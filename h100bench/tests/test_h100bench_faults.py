"""A run with the timed path broken underneath comes out not correct: each
fault a cell can have is planted in the program (the harness's look for a
card skipped, everything else as a run does it)."""

import pytest
import torch

from h100bench.tests import tiny


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make(tmp_path_factory.mktemp("bench"))


def _altered_answer(monkeypatch):
    from instageo_tpu_torch.ops import preprocess

    real = preprocess.make_fused_predict_fn

    def make(*args, **kw):
        predict = real(*args, **kw)

        def broken(raw):
            out = predict(raw).clone()
            out[0] = (out[0].long() + 1).remainder(3).to(out.dtype)
            return out
        return broken
    monkeypatch.setattr(preprocess, "make_fused_predict_fn", make)


def _serve_half_batch(monkeypatch):
    from instageo_tpu_torch.ops import preprocess

    real = preprocess.make_fused_predict_fn

    def make(*args, **kw):
        predict = real(*args, **kw)

        def broken(raw):
            half = raw.shape[0] // 2
            out = predict(raw[:half])
            return torch.cat([out, out[:raw.shape[0] - half]])
        return broken
    monkeypatch.setattr(preprocess, "make_fused_predict_fn", make)


def _state_unchanged(monkeypatch):
    monkeypatch.setattr(torch.optim.AdamW, "step", lambda self, closure=None: None)


def _group_unchanged(monkeypatch):
    """The grouped (on a card, replayed) steps leave the state unchanged."""
    from instageo_tpu_torch.train.trainer import Trainer

    monkeypatch.setattr(Trainer, "_train_group_body", lambda self, group: group.losses)


def _train_half_batch(monkeypatch):
    from instageo_tpu_torch.train.trainer import Trainer

    real = Trainer._loss

    def loss(self, logits, labels, teacher_logits=None):
        half = logits.shape[0] // 2
        return real(self, logits[:half], labels[:half])
    monkeypatch.setattr(Trainer, "_loss", loss)


@pytest.mark.parametrize("cell,fault", [
    ("tiny.serve", None),
    ("tiny.serve", _altered_answer),
    ("tiny.serve", _serve_half_batch),
    ("tiny.train", None),
    ("tiny.train", _state_unchanged),
    ("tiny.train", _group_unchanged),
    ("tiny.train", _train_half_batch),
])
def test_fault_makes_the_run_incorrect(root, capsys, monkeypatch, cell, fault):
    if fault is not None:
        fault(monkeypatch)
    rc, line = tiny.run(root, cell, capsys=capsys)
    assert rc == 0
    assert line["correct"] is (fault is None), line["check"]
