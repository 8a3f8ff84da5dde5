"""CLIP's text and vision encoders.

Port of `comfy3d_tpu/models/clip.py`, both halves that the ported paths
run. The vision encoder is Zero123Plus's global conditioning
(`Zero123Plus/pipeline.py:385-405`: a CLIP-normalised 224² encode → the
projected embedding that rides the ramping coefficients); the text encoder
gives the empty prompt's hidden states that Zero123Plus and MVDream load
as their prompt embedding, and MVDream's prompt hook
(`make_text_conditioner`, token ids from the caller). Both mirror
`transformers`' CLIP: pre-LN blocks of attention (causal for text) and a
quick-GELU (or exact-GELU) MLP, LayerNorm eps 1e-5; the vision encoder has
a patch convolution without bias, a class token and learned positions, the
class token's final LayerNorm and a bias-free projection; the text encoder
token and position embeddings and a final LayerNorm, pooled at the first
EOS token.

Submodules carry the names of a `CLIPVisionModelWithProjection` /
`CLIPTextModel` state dict without its `vision_model.` / `text_model.`
prefix (`embeddings.{patch_embedding, class_embedding,
position_embedding, token_embedding}`, `pre_layrnorm`,
`encoder.layers.{i}.{self_attn.{q,k,v,out}_proj, layer_norm1, mlp.fc1,
mlp.fc2, layer_norm2}`, `post_layernorm`, `visual_projection`,
`final_layer_norm`), the names the JAX package's `clip_rules` reads.
Images are NCHW inside the encoder; the conditioner takes the node
layer's [B, H, W, 3].

ImageDream's image prompt reads the vision encoder's penultimate hidden
states (`project="penultimate"`: the tokens that enter the last layer,
without the post-LayerNorm; `make_vision_hidden_conditioner`).

Not ported, raising NotImplementedError naming its ROADMAP item: the
camera-modulated blocks (`modulation_dim > 0`, Craftsman, A.10).
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
class CLIPTextConfig:
    vocab_size: int = 49408
    hidden: int = 768
    layers: int = 12
    heads: int = 12
    mlp_dim: int = 3072
    max_positions: int = 77
    eps: float = 1e-5
    eos_token_id: int = 49407
    act: str = "quick_gelu"      # SD1.x openai CLIP; SD2.x: "gelu"


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
    """HF `CLIPAttention`: biased q/k/v/out projections; `bias` an additive
    mask (the text encoder's causal one)."""

    def __init__(self, hidden: int, heads: int):
        super().__init__()
        self.heads = heads
        self.q_proj = nn.Linear(hidden, hidden)
        self.k_proj = nn.Linear(hidden, hidden)
        self.v_proj = nn.Linear(hidden, hidden)
        self.out_proj = nn.Linear(hidden, hidden)

    def forward(self, x, bias=None):
        return self.out_proj(_attend(self.q_proj(x), self.k_proj(x),
                                     self.v_proj(x), self.heads, bias))


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

    def forward(self, x, bias=None):
        x = x + self.self_attn(self.layer_norm1(x), bias)
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
    projected embedding [B, P]) with `project=True`, (tokens, the pooled
    class token [B, C]) with `project=False`, or (the tokens that enter the
    last layer, their token 0) with `project="penultimate"` (HF's
    `hidden_states[-2]`; the last layer does not run)."""

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
        x = self.pre_layrnorm(self.embeddings(images))
        layers = self.encoder["layers"]
        if project == "penultimate":
            for block in layers[:-1]:
                x = block(x)
            return x, x[:, 0]
        for block in layers:
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


def _conditioner(model: CLIPVisionEncoder, project, pick: int):
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
        return model(_clip_normalize(x), project=project)[pick]

    return fn


def make_vision_conditioner(model: CLIPVisionEncoder):
    """fn(image [B, H, W, 3] or [H, W, 3] in [0, 1]) → the projected image
    embedding [B, P]: resized to the encoder's size (bilinear, antialiased
    when it shrinks, as `jax.image.resize`), CLIP-normalised, encoded.
    Zero123Plus's global-conditioning hook."""
    return _conditioner(model, True, 1)


def make_vision_hidden_conditioner(model: CLIPVisionEncoder):
    """fn(image [B, H, W, 3] or [H, W, 3] in [0, 1]) → the penultimate
    hidden states [B, 1 + N, C], resized and normalised as
    `make_vision_conditioner` does: ImageDream's image-prompt hook
    (`LGM/mvdream/pipeline_mvdream.py:404-416`), fed to its Resampler."""
    return _conditioner(model, "penultimate", 0)


class CLIPTextEmbeddings(nn.Module):
    """Token embeddings and learned positions."""

    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.token_embedding = nn.Embedding(cfg.vocab_size, cfg.hidden)
        self.position_embedding = nn.Embedding(cfg.max_positions, cfg.hidden)

    def forward(self, input_ids):
        t = input_ids.shape[1]
        return (self.token_embedding(input_ids)
                + self.position_embedding.weight[None, :t])


class CLIPTextEncoder(nn.Module):
    """HF `CLIPTextModel`: token ids [B, T] → (the last hidden states after
    the final LayerNorm [B, T, C], the pooled state at each row's first EOS
    token [B, C])."""

    def __init__(self, cfg: CLIPTextConfig = CLIPTextConfig()):
        super().__init__()
        c = self.cfg = cfg
        self.embeddings = CLIPTextEmbeddings(c)
        self.encoder = nn.ModuleDict({"layers": nn.ModuleList([
            CLIPBlock(c.hidden, c.heads, c.mlp_dim, c.eps, c.act)
            for _ in range(c.layers)])})
        self.final_layer_norm = nn.LayerNorm(c.hidden, eps=c.eps)

    def forward(self, input_ids):
        input_ids = torch.as_tensor(input_ids, dtype=torch.long,
                                    device=self.final_layer_norm.weight.device)
        x = self.embeddings(input_ids)
        t = x.shape[1]
        causal = torch.full((t, t), float("-inf"), dtype=x.dtype,
                            device=x.device).triu(1)
        for block in self.encoder["layers"]:
            x = block(x, causal)
        x = self.final_layer_norm(x)
        eot = (input_ids == self.cfg.eos_token_id).int().argmax(dim=-1)
        return x, x[torch.arange(x.shape[0], device=x.device), eot]


def empty_prompt_ids(max_positions: int = 77, pad_token_id: int = 49407,
                     bos_token_id: int = 49406, eos_token_id: int = 49407):
    """Token ids [1, T] (int64) of the empty prompt "" under CLIPTokenizer
    padding to `max_positions`, computable without the vocab file: [BOS,
    EOS] then pads. SD2-class checkpoints pad with "!" (id 0), SD1.x with
    EOS."""
    ids = torch.full((1, max_positions), pad_token_id, dtype=torch.long)
    ids[0, 0] = bos_token_id
    ids[0, 1] = eos_token_id
    return ids


def make_text_conditioner(model: CLIPTextEncoder):
    """fn(token_ids [B, T]) → the last hidden states [B, T, C]: MVDream's
    prompt hook (the caller tokenizes with the checkpoint's vocab)."""
    def fn(token_ids):
        return model(token_ids)[0]

    return fn
