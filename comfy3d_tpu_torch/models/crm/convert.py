"""`CRM.pth` → the port's `CRMModel`.

Port of `comfy3d_tpu/models/crm/convert.py`. The public checkpoint is
`ConvolutionalReconstructionModel.state_dict()` (`CRM/model/crm/
model.py:23-68`): `unet2.unet.*` (a diffusers `UNet2DModel`),
`unet2.learned_plane`, `sdfMlp`, `rgbMlp`, `weightMlp`, whose names the
port's module carries, plus the renderer's, scheduler's and decoder's
buffers, which hold no parameter and are dropped. Older diffusers releases
spell the attention `query` / `key` / `value` / `proj_attn` (possibly as
1×1 convolutions); those become `to_q` / `to_k` / `to_v` / `to_out.0`.
"""

from __future__ import annotations

import re

_DEPRECATED = {"query": "to_q", "key": "to_k", "value": "to_v",
               "proj_attn": "to_out.0"}
_BUFFERS = ("renderer.", "scheduler.", "decoder.")


def crm_state_dict(sd: dict) -> dict:
    """`CRM.pth`'s state dict → the port's `CRMModel` names (for a strict
    load)."""
    out = {}
    for key, val in sd.items():
        if key.startswith(_BUFFERS):
            continue
        m = re.fullmatch(r"(.*\.attentions\.\d+)\.(\w+)\.(weight|bias)", key)
        if m and m.group(2) in _DEPRECATED:
            key = f"{m.group(1)}.{_DEPRECATED[m.group(2)]}.{m.group(3)}"
            if val.ndim == 4:
                val = val[:, :, 0, 0]
        out[key] = val
    return out
