"""CLIP's vision encoder: an image → its projected global embedding.

Port of the vision half of `comfy3d_tpu/models/clip.py`, the half that
Zero123Plus's global conditioning runs (`Zero123Plus/pipeline.py:385-405`:
a CLIP-normalised 224² encode → the projected embedding that rides the
ramping coefficients). It mirrors `transformers`' CLIP: a patch
convolution without bias, a class token and learned positions, pre-LN
blocks of non-causal attention and a quick-GELU (or exact-GELU) MLP,
LayerNorm eps 1e-5, the class token's final LayerNorm and a bias-free
projection.

Submodules carry the names of a `CLIPVisionModelWithProjection` state dict
without its `vision_model.` prefix (`embeddings.{patch_embedding,
class_embedding, position_embedding}`, `pre_layrnorm`,
`encoder.layers.{i}.{self_attn.{q,k,v,out}_proj, layer_norm1, mlp.fc1,
mlp.fc2, layer_norm2}`, `post_layernorm`, `visual_projection`), the names
the JAX package's `clip_rules` reads. Images are NCHW inside the encoder;
the conditioner takes the node layer's [B, H, W, 3].

Not ported, each raising NotImplementedError naming its ROADMAP item: the
text encoder and `make_text_conditioner` (A.6.3, with CLIP weights in the
repository), the penultimate hidden states (`project="penultimate"`) and
`make_vision_hidden_conditioner` (ImageDream, A.6.4), and the camera-
modulated blocks (`modulation_dim > 0`, Craftsman, A.10).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from .common import _attend

CLIP_IMAGE_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_IMAGE_STD = (0.26862954, 0.26130258, 0.27577711)


def _unported(what: str, item: str):
    return NotImplementedError(f"{what} is not ported (ROADMAP {item})")


def quick_gelu(x):
    return x * torch.sigmoid(1.702 * x)


@dataclasses.dataclass(frozen=True)
class CLIPVisionConfig:
    hidden: int = 1024
    layers: int = 24
    heads: int = 16
    mlp_dim: int = 4096
    image_size: int = 224
    patch: int = 14
    projection_dim: int = 768
    eps: float = 1e-5
    act: str = "quick_gelu"      # openai CLIP; open_clip laion2b: "gelu"
    modulation_dim: int = 0      # > 0: Craftsman's camera ModLN (A.10)


class CLIPAttention(nn.Module):
    """HF `CLIPAttention`: biased q/k/v/out projections, non-causal."""

    def __init__(self, hidden: int, heads: int):
        super().__init__()
        self.heads = heads
        self.q_proj = nn.Linear(hidden, hidden)
        self.k_proj = nn.Linear(hidden, hidden)
        self.v_proj = nn.Linear(hidden, hidden)
        self.out_proj = nn.Linear(hidden, hidden)

    def forward(self, x):
        return self.out_proj(_attend(self.q_proj(x), self.k_proj(x),
                                     self.v_proj(x), self.heads))


class CLIPBlock(nn.Module):
    """HF `CLIPEncoderLayer`: pre-LN attention and MLP, each with a
    residual; the MLP's activation is quick-GELU or the exact GELU."""

    def __init__(self, hidden: int, heads: int, mlp_dim: int,
                 eps: float = 1e-5, act: str = "quick_gelu"):
        super().__init__()
        if act not in ("quick_gelu", "gelu"):
            raise ValueError(f"CLIP activation {act!r}")
        self.act = act
        self.layer_norm1 = nn.LayerNorm(hidden, eps=eps)
        self.self_attn = CLIPAttention(hidden, heads)
        self.layer_norm2 = nn.LayerNorm(hidden, eps=eps)
        self.mlp = nn.ModuleDict({"fc1": nn.Linear(hidden, mlp_dim),
                                  "fc2": nn.Linear(mlp_dim, hidden)})

    def forward(self, x):
        x = x + self.self_attn(self.layer_norm1(x))
        h = self.mlp["fc1"](self.layer_norm2(x))
        h = quick_gelu(h) if self.act == "quick_gelu" else F.gelu(h)
        return x + self.mlp["fc2"](h)


class CLIPVisionEmbeddings(nn.Module):
    """Patch embedding, class token and learned positions."""

    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        c = cfg
        self.patch_embedding = nn.Conv2d(3, c.hidden, c.patch,
                                         stride=c.patch, bias=False)
        self.class_embedding = nn.Parameter(torch.zeros(c.hidden))
        self.position_embedding = nn.Embedding(
            (c.image_size // c.patch) ** 2 + 1, c.hidden)

    def forward(self, images):
        x = self.patch_embedding(images).flatten(2).transpose(1, 2)
        b, n, d = x.shape
        x = torch.cat([self.class_embedding.expand(b, 1, d), x], dim=1)
        return x + self.position_embedding.weight[None, :n + 1]


class CLIPVisionEncoder(nn.Module):
    """CLIP-normalised images [B, 3, H, W] → (tokens [B, 1 + N, C], the
    projected embedding [B, P]) with `project=True`, or (tokens, the
    pooled class token [B, C]) with `project=False`."""

    def __init__(self, cfg: CLIPVisionConfig = CLIPVisionConfig()):
        super().__init__()
        if cfg.modulation_dim > 0:
            raise _unported("CLIPVisionConfig.modulation_dim (Craftsman's "
                            "camera-modulated blocks)", "A.10")
        c = self.cfg = cfg
        self.embeddings = CLIPVisionEmbeddings(c)
        self.pre_layrnorm = nn.LayerNorm(c.hidden, eps=c.eps)
        self.encoder = nn.ModuleDict({"layers": nn.ModuleList([
            CLIPBlock(c.hidden, c.heads, c.mlp_dim, c.eps, c.act)
            for _ in range(c.layers)])})
        self.post_layernorm = nn.LayerNorm(c.hidden, eps=c.eps)
        self.visual_projection = nn.Linear(c.hidden, c.projection_dim,
                                           bias=False)

    def forward(self, images, project=True):
        if project == "penultimate":
            raise _unported("CLIP's penultimate hidden states (ImageDream)",
                            "A.6.4")
        x = self.pre_layrnorm(self.embeddings(images))
        for block in self.encoder["layers"]:
            x = block(x)
        pooled = self.post_layernorm(x[:, 0])
        if not project:
            return x, pooled
        return x, self.visual_projection(pooled)


def _clip_normalize(images):
    """images [B, 3, H, W] in [0, 1] → CLIP's normalised range."""
    mean = torch.tensor(CLIP_IMAGE_MEAN, dtype=images.dtype,
                        device=images.device)[:, None, None]
    std = torch.tensor(CLIP_IMAGE_STD, dtype=images.dtype,
                       device=images.device)[:, None, None]
    return (images - mean) / std


def make_vision_conditioner(model: CLIPVisionEncoder):
    """fn(image [B, H, W, 3] or [H, W, 3] in [0, 1]) → the projected image
    embedding [B, P]: resized to the encoder's size (bilinear, antialiased
    when it shrinks, as `jax.image.resize`), CLIP-normalised, encoded.
    Zero123Plus's global-conditioning hook."""
    s = model.cfg.image_size

    def fn(image):
        p = next(model.parameters())
        x = torch.as_tensor(image, dtype=torch.float32, device=p.device)
        if x.ndim == 3:
            x = x[None]
        x = x.permute(0, 3, 1, 2)
        if x.shape[-2:] != (s, s):
            x = F.interpolate(x, size=(s, s), mode="bilinear",
                              align_corners=False, antialias=True)
        return model(_clip_normalize(x))[1]

    return fn


def make_vision_hidden_conditioner(*args, **kwargs):
    """ImageDream's penultimate-hidden-state hook."""
    raise _unported("make_vision_hidden_conditioner (ImageDream)", "A.6.4")


class CLIPTextEncoder:
    """CLIP's causal text encoder."""

    def __init__(self, *args, **kwargs):
        raise _unported("CLIP's text encoder, with CLIP weights in the "
                        "repository", "A.6.3")


def make_text_conditioner(*args, **kwargs):
    """MVDream's prompt hook over CLIP's text encoder."""
    raise _unported("CLIP's text encoder and make_text_conditioner, with "
                    "CLIP weights in the repository", "A.6.3")
