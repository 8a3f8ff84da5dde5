"""Craftsman's Lightning checkpoint (wyysf/CraftsMan `model.ckpt`) → the
port's `Craftsman`.

Port of `comfy3d_tpu/models/craftsman/convert.py::load_craftsman_ckpt`. The
file's state dict holds three prefixes (systems/shape_diffusion.py:158-167):

  * `shape_model.` — the Michelangelo aligned autoencoder, of which the
    decode path loads: `post_kl`, `transformer.resblocks.{i}` and the geo
    decoder `decoder.{query_proj, cross_attn_decoder, ln_post,
    output_proj}` (the port's `ShapeVAE.geo_decoder`); the encoder is
    skipped;
  * `denoiser_model.` — `SimpleDenoiser`, under its own names
    (`backbone.decoder.{i}.0/1/2` the resblock, skip linear and skip LN);
  * `condition.model.` — the conditional CLIP: `vision_model.*` and
    `visual_projection`; the text tower, `text_projection` and
    `logit_scale` are skipped, as the JAX package's rules skip them.

Each part loads strictly; a prefix with no keys raises.
"""

from __future__ import annotations

import os

from ..loader import load_dir_state_dict

# (prefix in the checkpoint, prefix in the port's `Craftsman`) of the kept
# keys; `shape_model.decoder.` only for the geo decoder's four modules
_KEPT = (
    ("shape_model.post_kl.", "vae.post_kl."),
    ("shape_model.transformer.", "vae.transformer."),
    *((f"shape_model.decoder.{m}.", f"vae.geo_decoder.{m}.")
      for m in ("query_proj", "cross_attn_decoder", "ln_post",
                "output_proj")),
    ("denoiser_model.", "denoiser."),
    ("condition.model.vision_model.", "cond."),
    ("condition.model.visual_projection.", "cond.visual_projection."),
)
_SKIPPED = ("cond.embeddings.position_ids",)


def craftsman_model_state_dict(sd) -> dict:
    """A Craftsman checkpoint's state dict → the port's `Craftsman` state
    dict (`cond.*`, `denoiser.*`, `vae.*`). Raises ValueError when one of
    the three parts has no keys."""
    out = {}
    for key, val in sd.items():
        for src, dst in _KEPT:
            if key.startswith(src):
                name = dst + key[len(src):]
                if name not in _SKIPPED:
                    out[name] = val
                break
    for part in ("vae", "denoiser", "cond"):
        if not any(k.startswith(part + ".") for k in out):
            raise ValueError(f"craftsman ckpt missing {part} weights")
    return out


def find_ckpt(path: str) -> str:
    """`path` itself, or the first `.ckpt` under the directory `path` (the
    HF layout nests it as image-to-shape-diffusion/<variant>/model.ckpt).
    Raises FileNotFoundError when there is none."""
    if not os.path.isdir(path):
        return path
    cands = [os.path.join(root, f) for root, _dirs, files in os.walk(path)
             for f in files if f.endswith(".ckpt")]
    if not cands:
        raise FileNotFoundError(f"no .ckpt under {path!r}")
    return sorted(cands)[0]


def load_craftsman_ckpt(path: str, device, **cfg_overrides):
    """The model.ckpt file, or a directory holding one → `Craftsman` on
    `device`, its config `CraftsmanConfig(**cfg_overrides)`: built on
    `meta`, left empty on `device` and filled by the strict load (the
    module holds no buffers)."""
    import torch

    from .pipeline import Craftsman, CraftsmanConfig
    sd = craftsman_model_state_dict(load_dir_state_dict(find_ckpt(path)))
    with torch.device("meta"):
        model = Craftsman(CraftsmanConfig(**cfg_overrides))
    model = model.to_empty(device=device)
    model.load_state_dict(sd, strict=True)
    return model
