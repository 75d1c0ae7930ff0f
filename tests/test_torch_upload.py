"""Raw chips onto the device: ``ops/preprocess.py:raw_to_device`` (from
pageable memory) and ``PinnedStaging`` (two pinned host slots, each sent by
an asynchronous copy on the current stream), which the fused predict takes
on a CUDA device.

Here, on the CPU, the staging object runs with unpinned slots and a fake
event that reports busy or done, so its slot logic is checked without a
card: a slot is never refilled while its event is busy, the host waits and
``upload_slot_waits`` counts it, a batch of another size replaces the pair.
Every path hands on the same int32 values: uint16 0, 1, 32767, 32768 and
65535 among them, from contiguous, sliced and reversed arrays and from CPU
tensors. On the card: ``tests/test_torch_cuda.py``.
"""

import sys
import threading

import numpy as np
import pytest
import torch
from torch import nn

from instageo_tpu_torch.ops import preprocess as pp

CPU = torch.device("cpu")
EDGES = [0, 1, 32767, 32768, 65535]

# Host batches as a decoder or a caller hands them over.
KINDS = {
    "contiguous": lambda r: r,
    "sliced": lambda r: r[:, ::2],
    "reversed": lambda r: r[:, ::-1],
    "cpu_tensor": lambda r: torch.from_numpy(r.astype(np.int32)),
}


def _raw(seed: int = 0, shape=(2, 3, 4, 5)) -> np.ndarray:
    """Seeded uint16 chips with the edge values in bands 0 and 2."""
    raw = np.random.default_rng(seed).integers(0, 1 << 16, shape, dtype=np.uint16)
    raw[0, 0, 1, :] = EDGES
    raw[1, 2, 3, :] = EDGES
    return raw


def _int32(raw) -> torch.Tensor:
    return raw if isinstance(raw, torch.Tensor) else torch.from_numpy(raw.astype(np.int32))


class FakeEvent:
    """A CUDA event's surface: busy from ``record`` until ``synchronize``.
    ``on_wait`` runs when the host waits on it."""

    def __init__(self):
        self.busy = False
        self.on_wait = None
        self.streams = []

    def query(self) -> bool:
        return not self.busy

    def synchronize(self) -> None:
        if self.busy and self.on_wait is not None:
            self.on_wait()
        self.busy = False

    def record(self, stream=None) -> None:
        self.streams.append(stream)
        self.busy = True


def _unpinned(nbytes: int) -> torch.Tensor:
    return torch.empty(nbytes, dtype=torch.uint8)


def _staging() -> pp.PinnedStaging:
    return pp.PinnedStaging(CPU, alloc=_unpinned, event=FakeEvent)


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_raw_to_device_round_trip(kind):
    raw = KINDS[kind](_raw())
    x = pp.raw_to_device(raw, CPU)
    assert x.dtype == torch.int32
    assert torch.equal(x, _int32(raw))
    assert set(EDGES) <= set(x.unique().tolist())


@pytest.mark.parametrize("kind", sorted(KINDS) + ["float32"])
def test_staging_equals_raw_to_device(kind):
    raw = _raw(1)
    raw = raw.astype(np.float32) if kind == "float32" else KINDS[kind](raw)
    x = _staging().upload(raw)
    want = pp.raw_to_device(raw, CPU)
    assert x.dtype == want.dtype and torch.equal(x, want)


class _Recorder(nn.Module):
    """Keeps the model input it is given; answers its band 0 as the
    regression channel."""

    def __init__(self):
        super().__init__()
        self.anchor = nn.Parameter(torch.zeros(1))
        self.seen = None

    def forward(self, x, channels_last=True):
        self.seen = x.clone()
        return x[:, 0, 0][..., None]


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_fused_predict_hands_on_the_raw_values(kind):
    """Mean 0, std 1: the model receives the raw values themselves, as
    float32 (which holds every uint16 exactly)."""
    raw = KINDS[kind](_raw(2))
    model = _Recorder()
    bands = raw.shape[1]
    predict = pp.make_fused_predict_fn(model, [0.0] * bands, [1.0] * bands, is_reg_task=True)
    out = predict(raw)
    want = _int32(raw).float().unsqueeze(2)            # (B, C, T=1, H, W)
    assert torch.equal(model.seen, want)
    assert torch.equal(out, want[:, 0, 0])


def test_slot_is_not_refilled_while_its_copy_runs():
    st = _staging()
    a, b, c = _raw(3), _raw(4), _raw(5)
    st.upload(a)
    st.upload(b)
    host0, ev0 = st.slots[0]
    assert ev0.busy and st.slots[1][1].busy
    seen = []
    ev0.on_wait = lambda: seen.append(host0.numpy().copy())
    waits = pp.upload_slot_waits.count
    x = st.upload(c)
    assert pp.upload_slot_waits.count == waits + 1
    # When the host waited, slot 0 still held a's bytes; then c's.
    assert len(seen) == 1 and np.array_equal(seen[0], a.view(np.uint8).ravel())
    assert np.array_equal(host0.numpy(), c.view(np.uint8).ravel())
    assert torch.equal(x, _int32(c))
    assert ev0.busy and ev0.streams == [None, None]


def test_done_slot_is_refilled_without_a_wait():
    st = _staging()
    st.upload(_raw(6))
    st.upload(_raw(7))
    pair = [host for host, _ in st.slots]
    for _, ev in st.slots:
        ev.busy = False
    waits = pp.upload_slot_waits.count
    c = _raw(8)
    assert torch.equal(st.upload(c), _int32(c))
    assert pp.upload_slot_waits.count == waits
    assert [host for host, _ in st.slots] == pair   # same slots, slot 0 reused
    assert np.array_equal(pair[0].numpy(), c.view(np.uint8).ravel())


def test_batch_of_another_size_replaces_the_pair():
    st = _staging()
    small, big = _raw(9), _raw(10, shape=(4, 3, 4, 5))
    st.upload(small)
    first = list(st.slots)
    st.upload(_raw(11))
    assert [h for h, _ in st.slots] == [h for h, _ in first]
    assert all(ev.busy for _, ev in first)
    x = st.upload(big)
    assert torch.equal(x, _int32(big))
    assert len(st.slots) == pp.PinnedStaging.DEPTH
    assert all(h.numel() == big.nbytes for h, _ in st.slots)
    assert all(h is not old for (h, _), (old, _) in zip(st.slots, first))
    # The old pair's copies were waited for before it was dropped.
    assert not any(ev.busy for _, ev in first)
    st.upload(small)
    assert all(h.numel() == small.nbytes for h, _ in st.slots)


def test_counters_count_the_path_taken():
    """The staging object counts pinned uploads; on a CPU device the fused
    predict and ``raw_to_device`` copy nothing to a card and count neither."""
    pinned, pageable = pp.pinned_uploads.count, pp.pageable_uploads.count
    st = _staging()
    for seed in range(3):
        st.upload(_raw(seed))
    assert pp.pinned_uploads.count == pinned + 3
    predict = pp.make_fused_predict_fn(_Recorder(), [0.0] * 3, [1.0] * 3, is_reg_task=True)
    predict(_raw())
    pp.raw_to_device(_raw(), CPU)
    assert (pp.pinned_uploads.count, pp.pageable_uploads.count) == (pinned + 3, pageable)


def test_threads_sharing_one_staging_get_their_own_batches():
    """16 threads upload distinct batches through one staging object with
    a thread switch forced every microsecond: each gets its own values
    back, and no upload goes uncounted."""
    st = _staging()
    pinned = pp.pinned_uploads.count
    errors, n_threads, n_each = [], 16, 20

    def worker(t):
        try:
            for i in range(n_each):
                raw = _raw(1000 * t + i)
                if not torch.equal(st.upload(raw), _int32(raw)):
                    errors.append((t, i))
        except Exception as e:  # noqa: BLE001 - reported by the assertion below
            errors.append((t, repr(e)))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker, args=(t,)) for t in range(n_threads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(th.is_alive() for th in threads)
    assert errors == []
    assert pp.pinned_uploads.count == pinned + n_threads * n_each


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_a_batch_and_its_coords_share_one_slot(kind):
    """``upload_all``: the raw batch and its (B, T, 2) and (B, 2) float32
    coords in one slot, each at a 16-byte offset in order, one upload
    counted; each arrives as ``raw_to_device`` hands it on."""
    raw = KINDS[kind](_raw(12))
    temporal = np.random.default_rng(1).uniform(0, 2024, (2, 3, 2)).astype(np.float32)
    location = torch.tensor([[25.5, -124.0], [48.75, -67.25]])
    st = _staging()
    pinned = pp.pinned_uploads.count
    got = st.upload_all([raw, temporal, location])
    assert pp.pinned_uploads.count == pinned + 1
    for x, a in zip(got, (raw, temporal, location)):
        want = pp.raw_to_device(a, CPU)
        assert x.dtype == want.dtype and torch.equal(x, want)
    raw_bytes = _int32(raw).numel() * (4 if kind == "cpu_tensor" else 2)
    first = -(-raw_bytes // st.ALIGN) * st.ALIGN
    second = -(-(first + temporal.nbytes) // st.ALIGN) * st.ALIGN
    host = st.slots[0][0]
    assert host.numel() == second + location.numel() * 4
    assert np.array_equal(host[first:first + temporal.nbytes].numpy(),
                          temporal.view(np.uint8).ravel())
