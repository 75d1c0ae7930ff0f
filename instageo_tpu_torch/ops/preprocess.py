"""Device-side input preprocessing and the fused raw-chip predict.

Counterpart of ``instageo_tpu/ops/preprocess.py``: chips cross to the device
as raw integers (uint16 is half the bytes of host-normalised float32), and
band select → constant multiply → per-band normalise → centre crop →
(B, C, T, H, W) runs on the device. The fused predict's phases are the
profiler's ranges ``instageo.serve.upload``, ``instageo.serve.preprocess``
and ``instageo.serve.argmax`` (``utils/telemetry.py:span``); the model
adds ``instageo.model.encoder`` and ``instageo.model.head``.

On a CUDA device the fused predict uploads host batches through
``PinnedStaging``: two pinned host slots, each refilled on the host while
the card works on the batch before, and copied by an asynchronous DMA on
the current stream; a ``_tl`` model's coords travel in the same slot and
DMA as their batch. ``raw_to_device`` is the plain copy from pageable
memory, which CUDA stages through a bounce buffer of its own while the
host waits. Counters: ``pinned_uploads`` (batches sent through the slots,
coords included),
``pageable_uploads`` (host batches ``raw_to_device`` copied to a CUDA
device), ``upload_slot_waits`` (times the host found a slot's last DMA
still running).
"""

from __future__ import annotations

import logging
import threading
from typing import Callable, List, Optional, Sequence, Union

import numpy as np
import torch
from torch import nn

from instageo_tpu_torch.ops._build import HostCounter
from instageo_tpu_torch.utils.telemetry import span

log = logging.getLogger(__name__)

pinned_uploads = HostCounter()     # batches sent through PinnedStaging's slots
pageable_uploads = HostCounter()   # host batches raw_to_device copied to a CUDA device
upload_slot_waits = HostCounter()  # times a slot's last DMA was still running


def _widen(x: torch.Tensor, raw) -> torch.Tensor:
    """uint16 chips travel as their int16 bit pattern (torch's uint16 has
    few device ops) and are widened to int32 on the device."""
    if isinstance(raw, np.ndarray) and raw.dtype == np.uint16:
        return x.to(torch.int32).bitwise_and_(0xFFFF)
    return x


def raw_to_device(raw: Union[np.ndarray, torch.Tensor],
                  device: torch.device) -> torch.Tensor:
    """Raw chips onto ``device`` unconverted, from pageable memory; uint16
    widened to int32 there."""
    if _on_host(raw) and device.type == "cuda":
        pageable_uploads.add()
    if isinstance(raw, torch.Tensor):
        return raw.to(device)
    raw = np.ascontiguousarray(raw)
    bits = raw.view(np.int16) if raw.dtype == np.uint16 else raw
    return _widen(torch.from_numpy(bits).to(device), raw)


def _on_host(raw) -> bool:
    return isinstance(raw, np.ndarray) or (isinstance(raw, torch.Tensor)
                                           and raw.device.type == "cpu")


def _pinned_bytes(nbytes: int) -> torch.Tensor:
    return torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)


class PinnedStaging:
    """Host batches onto a CUDA ``device`` through ``DEPTH`` pinned slots.

    ``upload(raw)`` takes a numpy array or a CPU tensor and returns what
    ``raw_to_device`` returns for it. It copies ``raw`` on the host into the
    next slot, straight from its strides, sends the slot with
    ``non_blocking=True`` on the device's current stream, where the caching
    allocator reuses blocks in stream order as for any copy, and records
    the slot's event after it. A slot whose event has not completed is
    waited for before it is refilled (``upload_slot_waits``): every batch is
    copied from host memory afresh, and none overwrites a batch still in
    flight. The slots hold the byte count of the latest batch; a batch of
    another size replaces the pair, once the old pair's DMAs are done.
    ``upload_all(arrays)`` sends several arrays of one batch (the chips and
    their coords) in one slot and one DMA, each at an ``ALIGN``-byte offset
    in the order given, and counts one upload.

    ``alloc`` (bytes -> uint8 host tensor) and ``event`` (-> an object with
    ``query``, ``synchronize`` and ``record(stream)``) default to pinned
    memory and ``torch.cuda.Event``."""

    DEPTH = 2  # double buffering
    ALIGN = 16  # bytes: every dtype's view of the device buffer lines up

    def __init__(self, device: torch.device, *,
                 alloc: Callable[[int], torch.Tensor] = _pinned_bytes,
                 event: Optional[Callable[[], object]] = None) -> None:
        self.device = device
        self._alloc = alloc
        self._event = event or torch.cuda.Event
        self._lock = threading.Lock()
        self.slots = []   # [(uint8 host tensor, event after its last DMA)]
        self._next = 0

    def upload(self, raw: Union[np.ndarray, torch.Tensor]) -> torch.Tensor:
        return self.upload_all([raw])[0]

    def upload_all(self, arrays: Sequence[Union[np.ndarray, torch.Tensor]]
                   ) -> List[torch.Tensor]:
        sizes = [a.nbytes if isinstance(a, np.ndarray) else a.numel() * a.element_size()
                 for a in arrays]
        offsets, nbytes = [], 0
        for n in sizes:
            nbytes = -(-nbytes // self.ALIGN) * self.ALIGN
            offsets.append(nbytes)
            nbytes += n
        with self._lock:
            if not self.slots or self.slots[0][0].numel() != nbytes:
                for _, done in self.slots:
                    done.synchronize()
                self.slots = []   # the old pair goes before the new is allocated
                self.slots = [(self._alloc(nbytes), self._event()) for _ in range(self.DEPTH)]
                self._next = 0
            host, done = self.slots[self._next]
            self._next = (self._next + 1) % self.DEPTH
            if not done.query():
                upload_slot_waits.add()
                done.synchronize()
            staged = [_fill(host[o:o + n], a) for a, o, n in zip(arrays, offsets, sizes)]
            sent = host.to(self.device, non_blocking=True)
            done.record(_current_stream(self.device))
            out = [_widen(sent[o:o + n].view(st.dtype).view(st.shape), a)
                   for st, a, o, n in zip(staged, arrays, offsets, sizes)]
        pinned_uploads.add()
        return out


def _fill(host: torch.Tensor, raw: Union[np.ndarray, torch.Tensor]) -> torch.Tensor:
    """``raw`` copied from its strides into the uint8 ``host`` of its byte
    count, returned as a tensor of its shape; uint16 as its int16 bits."""
    if isinstance(raw, torch.Tensor):
        staged = host.view(raw.dtype).view(raw.shape)
        staged.copy_(raw)
        return staged
    bits = raw.view(np.int16) if raw.dtype == np.uint16 else raw
    staged = host.numpy().view(bits.dtype).reshape(bits.shape)
    np.copyto(staged, bits)
    return torch.from_numpy(staged)


def _current_stream(device: torch.device):
    """The stream a copy to ``device`` runs on (None off CUDA)."""
    return torch.cuda.current_stream(device) if device.type == "cuda" else None


def preprocess_chips(
    raw: torch.Tensor,
    mean: torch.Tensor,
    std: torch.Tensor,
    temporal_size: int = 1,
    bands: Optional[torch.Tensor] = None,
    constant_multiplier: float = 1.0,
    out_dtype: torch.dtype = torch.float32,
    img_size: Optional[int] = None,
) -> torch.Tensor:
    """(B, T·C_raw, H, W) raw ints -> normalised (B, C, T, H, W).

    ``mean``/``std`` are per-band (C,) tensors on ``raw``'s device; ``bands``
    (an index tensor on the same device) selects from the flattened T·C axis.
    ``img_size`` centre-crops chips larger than the model input.
    """
    x = raw
    if bands is not None:
        x = x.index_select(1, bands)
    h, w = x.shape[-2:]
    if img_size is not None and (h, w) != (img_size, img_size):
        if h < img_size or w < img_size:
            raise ValueError(f"chips {h}x{w} smaller than img_size {img_size}")
        off_h = (h - img_size) // 2
        off_w = (w - img_size) // 2
        x = x[..., off_h:off_h + img_size, off_w:off_w + img_size]
    b, tc, h, w = x.shape
    c = tc // temporal_size
    x = x.float() * constant_multiplier
    x = x.reshape(b, temporal_size, c, h, w)
    x = (x - mean[None, None, :, None, None]) / std[None, None, :, None, None]
    return x.permute(0, 2, 1, 3, 4).to(out_dtype)


def make_fused_predict_fn(model: nn.Module, mean, std, *,
                          temporal_size: int = 1,
                          bands: Optional[Sequence[int]] = None,
                          constant_multiplier: float = 1.0,
                          is_reg_task: bool = False,
                          img_size: Optional[int] = None
                          ) -> Callable[..., torch.Tensor]:
    """``predict(raw, temporal_coords=None, location_coords=None)``: raw
    (B, T·C_raw, H, W) chips -> predictions on the model's device: int8
    argmax classes (B, H, W), or float32 channel 0 for regression.

    A ``_tl`` model takes each chip's coords: ``temporal_coords`` (B, T, 2)
    year and day of year of each frame, ``location_coords`` (B, 2)
    latitude and longitude, as float32. Called without them it adds no
    embedding (``models/prithvi.py``'s ``coords_missing`` counts it), and
    this function logs a warning the first time.

    The normalisation constants and band indices go to the device once,
    here; the model's weights already live there. On a CUDA device the host
    arrays of a call (numpy or CPU tensors: the batch and its coords) go
    through this function's own ``PinnedStaging`` in one upload; an array
    already on the device, and every array on a CPU device, through
    ``raw_to_device``.
    """
    device = next(model.parameters()).device
    mean_t = torch.as_tensor(np.asarray(mean, np.float32), device=device)
    std_t = torch.as_tensor(np.asarray(std, np.float32), device=device)
    bands_t = (None if bands is None
               else torch.as_tensor(list(bands), dtype=torch.long, device=device))
    staging = PinnedStaging(device) if device.type == "cuda" else None
    wants_coords = getattr(model, "uses_coords", False)
    warned = []

    def to_device(arrays: List) -> List:
        staged = ([i for i, a in enumerate(arrays) if a is not None and _on_host(a)]
                  if staging is not None else [])
        out = [a if a is None or i in staged else raw_to_device(a, device)
               for i, a in enumerate(arrays)]
        if staged:
            for i, x in zip(staged, staging.upload_all([arrays[i] for i in staged])):
                out[i] = x
        return out

    @torch.inference_mode()
    def predict(raw, temporal_coords=None, location_coords=None):
        coords = [_coords(temporal_coords, (raw.shape[0], temporal_size, 2), "temporal_coords"),
                  _coords(location_coords, (raw.shape[0], 2), "location_coords")]
        if wants_coords and all(c is None for c in coords) and not warned:
            warned.append(True)
            log.warning("a _tl model's predict was called without coords: no time or "
                        "location embedding is added")
        with span("instageo.serve.upload"):
            x, tc, lc = to_device([raw] + coords)
        with span("instageo.serve.preprocess"):
            x = preprocess_chips(x, mean_t, std_t, temporal_size=temporal_size,
                                 bands=bands_t, constant_multiplier=constant_multiplier,
                                 img_size=img_size)
        if tc is None and lc is None:
            logits = model(x, channels_last=True)
        else:
            logits = model(x, channels_last=True, temporal_coords=tc, location_coords=lc)
        with span("instageo.serve.argmax"):
            if is_reg_task:
                return logits[..., 0].float()
            return logits.argmax(dim=-1).to(torch.int8)

    return predict


def _coords(coords, shape, name: str):
    """``coords`` as float32 (numpy or a tensor where it lies), checked
    against ``shape``; None stays None."""
    if coords is None:
        return None
    if tuple(coords.shape) != tuple(shape):
        raise ValueError(f"{name} of shape {tuple(coords.shape)}; expected {tuple(shape)}")
    if isinstance(coords, torch.Tensor):
        return coords.float()
    return np.ascontiguousarray(coords, dtype=np.float32)
