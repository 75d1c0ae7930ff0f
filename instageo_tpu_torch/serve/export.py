"""Serialized serving artifacts via ``torch.export``.

Counterpart of ``instageo_tpu/serve/export.py``: the serving forward (model
-> argmax class ids, softmax probabilities or the regression map) is
exported as a program that reloads and runs without the model's Python
code. The weights are an argument of the program, not constants in it, so
the artifact stays small and one artifact serves every fine-tune of the
architecture. The batch dimension is symbolic unless ``batch_size`` pins it.

The attention forward is the custom op ``instageo_tpu_torch::flash_attn_fwd``
(``ops/attention.py``): the exported graph holds that op, and running the
artifact runs the port's kernel on a CUDA device (its plain version on the
CPU). ``load_predict`` imports that op's registration, which is kernel code,
and nothing of the port's models. An artifact runs on the device type it was
exported on.
"""

from __future__ import annotations

import json
import os
from typing import Any, Callable, Dict, Optional, Tuple

import torch
from torch import nn

ARTIFACT_VERSION = 1
CUSTOM_OPS = ("instageo_tpu_torch::flash_attn_fwd",)


class _Predict(nn.Module):
    """The serving forward on (state dict, x), the model held outside the
    module tree so that none of its tensors is lifted into the program."""

    def __init__(self, model: nn.Module, is_reg_task: bool, probabilities: bool) -> None:
        super().__init__()
        self._model = (model,)
        self.is_reg_task = is_reg_task
        self.probabilities = probabilities

    def forward(self, state: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
        logits = torch.func.functional_call(self._model[0], state, (x,),
                                            {"channels_last": True}, strict=True)
        if self.is_reg_task:
            return logits[..., 0].float()
        if self.probabilities:
            return torch.softmax(logits.float(), dim=-1)
        return logits.argmax(dim=-1).to(torch.int8)


def export_predict(model: nn.Module, path: str, *, num_bands: int, img_size: int,
                   temporal_dim: int = 1, is_reg_task: bool = False,
                   probabilities: bool = False, batch_size: Optional[int] = None) -> str:
    """Export ``model``'s serving forward to ``path`` (+ ``path.json``) on
    the device its parameters are on.

    The program takes ``(state_dict, x)``: the model's state dict (its
    tensors' names, shapes, dtypes and device) and float32 chips (B,
    ``num_bands``, ``temporal_dim``, ``img_size``, ``img_size``); B is
    symbolic unless ``batch_size`` pins it. The sidecar records the input
    spec, the output kind, the device type and the custom ops the program
    needs."""
    model = model.eval()
    device = next(model.parameters()).device
    state = {k: v.detach() for k, v in model.state_dict().items()}
    example_b = int(batch_size) if batch_size is not None else 2
    x = torch.zeros((example_b, num_bands, temporal_dim, img_size, img_size),
                    dtype=torch.float32, device=device)
    predict = _Predict(model, is_reg_task, probabilities)
    with torch.no_grad():
        # One eager call caches the positional embedding as a tensor on the
        # device, where the program keeps it as a constant.
        predict(state, x)
        batch = (torch.export.Dim("batch", min=1, max=65535) if batch_size is None
                 else None)
        dynamic = ({k: None for k in state}, {0: batch} if batch is not None else None)
        exported = torch.export.export(predict, (state, x), dynamic_shapes=dynamic,
                                       strict=False)
    # The example inputs would carry the weights into the file.
    exported.example_inputs = None
    torch.export.save(exported, path)
    meta = {
        "artifact_version": ARTIFACT_VERSION,
        "input_shape": [None if batch_size is None else int(batch_size),
                        num_bands, temporal_dim, img_size, img_size],
        "input_dtype": "float32",
        "output": ("regression" if is_reg_task
                   else "probabilities" if probabilities else "class_ids"),
        "device": device.type,
        "custom_ops": list(CUSTOM_OPS),
        "torch_version": torch.__version__,
    }
    with open(path + ".json", "w") as f:
        json.dump(meta, f, indent=2)
    return path


def load_predict(path: str) -> Tuple[Callable[[Dict[str, torch.Tensor], Any], torch.Tensor],
                                     Dict]:
    """Reload an exported artifact: ``(predict(state_dict, x), metadata)``.

    ``predict`` moves the state dict's tensors and ``x`` to the artifact's
    device and returns the program's output there. Needs no model code;
    raises when the ``.json`` sidecar is missing (it names the device) or
    the artifact was exported for a device type this process cannot run."""
    from instageo_tpu_torch.ops import attention  # noqa: F401  (registers the ops)

    if not os.path.exists(path + ".json"):
        raise FileNotFoundError(
            f"{path}.json is missing: the sidecar names the device the artifact runs on")
    with open(path + ".json") as f:
        meta = json.load(f)
    device = torch.device(meta["device"])
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{path} was exported on cuda and CUDA is not available here")
    if device.type not in ("cuda", "cpu"):
        raise RuntimeError(f"{path} was exported on {device.type}")
    program = torch.export.load(path).module()

    def predict(state: Dict[str, torch.Tensor], x: Any) -> torch.Tensor:
        state = {k: torch.as_tensor(v).to(device) for k, v in state.items()}
        x = torch.as_tensor(x, dtype=torch.float32).to(device)
        with torch.no_grad():
            return program(state, x)

    return predict, meta
