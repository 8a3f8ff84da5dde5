"""PartCrafter: image → N part meshes in one multi-part denoise.

Port of `comfy3d_tpu/models/partcrafter/pipeline.py` (upstream's
`pipeline_partcrafter.py` and `PartCrafterDiTModel`,
`partcrafter_transformer.py`): TripoSG's DiT block family (`triposg/dit.py`)
with a part axis, TripoSG's latent-set VAE and DINOv2-L conditioning.

  * The DiT takes latents [B, P, N, C] (B the CFG streams, P the parts).
    The time embedding rides as a token before each part's latents, and a
    learned part embedding (`part_embedding`, upstream's name) is added to
    every token, the time token included. Local blocks batch over (B·P),
    each part cross-attending to its stream's context repeated per part;
    global blocks (`global_attn_block_ids`) fold the parts into the token
    axis within each stream, the skips folded alike. Skips are pushed for
    i < mid and popped for i > mid, mid = num_layers // 2.
  * With CFG the parts are embedded 0 … P−1 in each stream, as the JAX
    package does (upstream's int path embeds arange(2P) across streams).
  * Sampling is TripoSG's rectified flow (`triposg.pipeline.flow_sigmas`)
    on one image: v = v_u + g·(v_c − v_u), the conditional stream first and
    the unconditional tokens zeros of the conditional ones.
  * Each part's latents over `scale_factor` go through the VAE's decoder,
    the octree SDF decode (`vecset/vae.py::decode_volume_auto`) and
    marching tets with the weld (`grid_to_mesh`), one part at a time.

`PartCrafterConfig()` takes TripoSG's DiT widths (2,048 wide, 21 blocks, 16
heads, cross-attention 1,024): PartCrafter is fine-tuned from TripoSG and
upstream's transformer config keeps them. Global attention sits in every
other block (0, 2, …, 20) as upstream's published configs alternate them;
32 parts at most and 512 latents a part, as the JAX package's default. The
JAX package's own default DiT (width 1,024, 9 blocks) matches no published
checkpoint (ROADMAP §C.15).

Each stage runs under a `torch.profiler.record_function` span named in
`PARTCRAFTER_STAGES`.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.profiler import record_function

from ... import resolve_device
from ...core.image import resize_images
from ..common import seeded_model
from ..dinov2 import IMAGENET_MEAN, IMAGENET_STD, Dinov2, Dinov2Config
from ..triposg.dit import (DiTBlock, TimestepEmbedding, TripoSGDiTConfig,
                           _sinusoidal)
from ..triposg.pipeline import _init_triposg_, flow_sigmas
from ..triposg.vae import TripoSGVAE, TripoSGVAEConfig
from ..vecset.vae import decode_volume_auto, grid_to_mesh

PARTCRAFTER_STAGES = ("partcrafter.encode_cond", "partcrafter.denoise",
                      "partcrafter.vae_decoder", "partcrafter.decode",
                      "partcrafter.extract")


@dataclasses.dataclass(frozen=True)
class PartCrafterDiTConfig:
    base: TripoSGDiTConfig = TripoSGDiTConfig()
    max_num_parts: int = 32
    global_attn_block_ids: Tuple[int, ...] = tuple(range(0, 21, 2))


class PartCrafterDiT(nn.Module):
    """TripoSG's DiT under upstream's names plus `part_embedding`."""

    def __init__(self, cfg: PartCrafterDiTConfig = PartCrafterDiTConfig()):
        super().__init__()
        self.cfg = cfg
        c = cfg.base
        mid = c.num_layers // 2
        self.part_embedding = nn.Embedding(cfg.max_num_parts, c.width)
        self.time_proj = TimestepEmbedding(c.width)
        self.proj_in = nn.Linear(c.in_channels, c.width)
        self.blocks = nn.ModuleList([DiTBlock(c, skip=i > mid)
                                     for i in range(c.num_layers)])
        self.norm_out = nn.LayerNorm(c.width, eps=1e-5)
        self.proj_out = nn.Linear(c.width, c.in_channels)

    def forward(self, x, t, context, part_ids):
        """x [B, P, N, C] per-part latents; t [B] (flow σ·1000); context
        [B, M, D]; part_ids [P] (int) → velocity [B, P, N, C]."""
        c = self.cfg.base
        b, p, n, _ = x.shape
        w, n1 = c.width, n + 1
        temb = self.time_proj(_sinusoidal(t, w))
        h = torch.cat([temb[:, None, None].expand(b, p, 1, w),
                       self.proj_in(x)], 2)
        h = h + self.part_embedding(part_ids)[None, :, None]
        ctx_local = context.repeat_interleave(p, dim=0)
        glob = set(self.cfg.global_attn_block_ids)
        mid = c.num_layers // 2
        skips = []
        for i, block in enumerate(self.blocks):
            skip = skips.pop() if i > mid else None
            if i in glob:
                shape, ctx = (b, p * n1, w), context
            else:
                shape, ctx = (b * p, n1, w), ctx_local
            h = block(h.reshape(shape), ctx,
                      None if skip is None else skip.reshape(shape)
                      ).reshape(b, p, n1, w)
            if i < mid:
                skips.append(h)
        return self.proj_out(self.norm_out(h)[:, :, -n:])


@dataclasses.dataclass(frozen=True)
class PartCrafterConfig:
    dit: PartCrafterDiTConfig = PartCrafterDiTConfig()
    vae: TripoSGVAEConfig = TripoSGVAEConfig(num_latents=512)
    cond: Dinov2Config = Dinov2Config(hidden=1024, layers=24, heads=16)
    image_size: int = 518
    num_steps: int = 50
    guidance_scale: float = 7.0
    shift: float = 1.0

    @classmethod
    def tiny(cls) -> "PartCrafterConfig":
        """Test-scale config (the JAX package's `tiny()`)."""
        return cls(
            dit=PartCrafterDiTConfig(
                base=TripoSGDiTConfig(width=32, in_channels=8, num_layers=5,
                                      heads=2, cross_attention_dim=32),
                max_num_parts=8, global_attn_block_ids=(1, 3)),
            vae=TripoSGVAEConfig(latent_channels=8, num_latents=16, heads=2,
                                 width_encoder=16, width_decoder=32,
                                 num_layers_encoder=1, num_layers_decoder=1),
            cond=Dinov2Config(hidden=32, layers=1, heads=2, patch=14,
                              pretrain_image_size=28),
            image_size=28, num_steps=3)


class PartCrafter(nn.Module):
    def __init__(self, cfg: PartCrafterConfig = PartCrafterConfig()):
        super().__init__()
        self.cfg = cfg
        self.cond = Dinov2(cfg.cond)
        self.dit = PartCrafterDiT(cfg.dit)
        self.vae = TripoSGVAE(cfg.vae)


def _init_partcrafter_(model: PartCrafter, gen: torch.Generator) -> None:
    """TripoSG's scheme (`triposg.pipeline._init_triposg_`) and the part
    embedding normal with std 0.02."""
    _init_triposg_(model, gen)
    w = model.dit.part_embedding.weight
    with torch.no_grad():
        w.copy_(torch.randn(w.shape, generator=gen, device=gen.device) * 0.02)


def random_model(seed: int, cfg: PartCrafterConfig, device) -> PartCrafter:
    """Weights drawn from `seed` on `device` (`common.seeded_model`)."""
    return seeded_model(lambda: PartCrafter(cfg), _init_partcrafter_, seed,
                        device)


class PartCrafterPipeline:
    def __init__(self, model: PartCrafter):
        self.model = model.eval()
        self.cfg = model.cfg
        # set by the scene loader node; nothing reads it (both packages)
        self.is_scene = False

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device

    @classmethod
    def init_random(cls, seed: int = 0,
                    cfg: PartCrafterConfig = PartCrafterConfig(),
                    device=None) -> "PartCrafterPipeline":
        """Weights drawn from `seed` on `device` (default: the card)."""
        return cls(random_model(seed, cfg, resolve_device(device)))

    @classmethod
    def from_pretrained(cls, path: str, device=None,
                        **cfg_overrides) -> "PartCrafterPipeline":
        """Upstream's directory (`transformer/`, `vae/` and optionally
        `image_encoder_dinov2/`, each with its config.json), loaded strictly
        as float32 on `device` (default: the card)."""
        from .convert import load_partcrafter_dir
        return cls(load_partcrafter_dir(path, resolve_device(device),
                                        **cfg_overrides))

    def _f32(self, x) -> torch.Tensor:
        if not torch.is_tensor(x):
            x = np.array(x, np.float32)
        return torch.as_tensor(x, dtype=torch.float32, device=self.device)

    @torch.no_grad()
    def encode_cond(self, image) -> torch.Tensor:
        """image [1, H, W, 3] or [H, W, 3] in [0, 1] → DINOv2 tokens
        [1, 1 + N, C]. An image whose height is not `image_size` is resized
        to `image_size`² as `jax.image.resize(..., "bilinear")` does (the
        JAX package checks the height alone)."""
        c = self.cfg
        with record_function(PARTCRAFTER_STAGES[0]):
            x = self._f32(image)
            if x.dim() == 3:
                x = x[None]
            s = c.image_size
            if x.shape[1] != s:
                x = resize_images(x, s, s)
            x = (x - self._f32(IMAGENET_MEAN)) / self._f32(IMAGENET_STD)
            return self.model.cond(x.permute(0, 3, 1, 2))

    @torch.no_grad()
    def denoise(self, cond, noise, num_parts: int, num_steps: int,
                guidance_scale: float) -> torch.Tensor:
        """The Euler loop over `flow_sigmas(num_steps, shift)` from `noise`
        [P, N, C] with CFG over [cond, zeros] tokens: → latents [P, N, C]."""
        if noise.shape[0] != num_parts:
            raise ValueError(f"noise for {noise.shape[0]} parts, not "
                             f"{num_parts}")
        dit = self.model.dit
        sig = flow_sigmas(num_steps, self.cfg.shift)
        part_ids = torch.arange(num_parts, device=noise.device)
        ctx2 = torch.cat([cond, torch.zeros_like(cond)])
        x = noise
        with record_function(PARTCRAFTER_STAGES[1]):
            for i in range(num_steps):
                t = float(np.float32(1000.0) * sig[i])
                v_c, v_u = dit(torch.stack([x, x]),
                               torch.full((2,), t, device=x.device), ctx2,
                               part_ids)
                x = x + float(sig[i + 1] - sig[i]) * (
                    v_u + guidance_scale * (v_c - v_u))
        return x

    @torch.no_grad()
    def sample_latents(self, image, num_parts: int = 4, seed: int = 0,
                       num_steps: Optional[int] = None,
                       guidance_scale: Optional[float] = None,
                       draws=None) -> torch.Tensor:
        """image → latents [num_parts, num_latents, latent_channels].
        `draws` (that shape) is the initial noise; without it the noise is
        drawn from a CPU `torch.Generator` seeded with `seed` and moved, so
        a seed gives the same latents on every device."""
        c = self.cfg
        shape = (num_parts, c.vae.num_latents, c.vae.latent_channels)
        if draws is None:
            draws = torch.randn(shape,
                                generator=torch.Generator().manual_seed(seed))
        noise = self._f32(draws)
        if tuple(noise.shape) != shape:
            raise ValueError(f"draws {tuple(noise.shape)}, not {shape}")
        gs = c.guidance_scale if guidance_scale is None else guidance_scale
        return self.denoise(self.encode_cond(image), noise, num_parts,
                            num_steps or c.num_steps, float(gs))

    @torch.no_grad()
    def decode_grid(self, latents, octree_resolution: int = 128,
                    num_chunks: int = 65536) -> torch.Tensor:
        """latents [P, N, C] → SDF logits [P, R+1, R+1, R+1], one part at a
        time: the latents over scale_factor, the VAE's decoder, the octree
        decode."""
        vae = self.model.vae
        grids = []
        for lat in self._f32(latents):
            with record_function(PARTCRAFTER_STAGES[2]):
                decoded = vae(lat[None] / self.cfg.vae.scale_factor)
            with record_function(PARTCRAFTER_STAGES[3]):
                grids.append(decode_volume_auto(
                    vae.query, decoded, octree_resolution=octree_resolution,
                    num_chunks=num_chunks))
        return torch.cat(grids)

    def latents_to_mesh(self, latents, octree_resolution: int = 128,
                        num_chunks: int = 65536) -> List:
        """latents [P, N, C] → one host `Mesh` per part."""
        grids = self.decode_grid(latents, octree_resolution, num_chunks)
        with record_function(PARTCRAFTER_STAGES[4]):
            return [grid_to_mesh(g) for g in grids]

    def __call__(self, image, num_parts: int = 4, seed: int = 0,
                 num_steps: Optional[int] = None,
                 guidance_scale: Optional[float] = None,
                 octree_resolution: int = 128, num_chunks: int = 65536,
                 draws=None) -> List:
        """→ a list of `num_parts` part meshes."""
        latents = self.sample_latents(image, num_parts, seed, num_steps,
                                      guidance_scale, draws=draws)
        return self.latents_to_mesh(latents, octree_resolution, num_chunks)


def merge_parts(meshes: List):
    """The part meshes concatenated into one, each part's vertices a colour
    of a six-colour palette (`get_colored_mesh_composition`'s role);
    empty parts are skipped."""
    from ...core.mesh import Mesh
    palette = np.array([[0.8, 0.3, 0.3], [0.3, 0.8, 0.3], [0.3, 0.3, 0.8],
                        [0.8, 0.8, 0.3], [0.8, 0.3, 0.8], [0.3, 0.8, 0.8]],
                       np.float32)
    vs, fs, vcs = [], [], []
    off = 0
    for i, m in enumerate(meshes):
        if not m.num_vertices:
            continue
        vs.append(np.asarray(m.v))
        fs.append(np.asarray(m.f) + off)
        vcs.append(np.tile(palette[i % len(palette)], (m.num_vertices, 1)))
        off += m.num_vertices
    if not vs:
        return Mesh(v=np.zeros((0, 3), np.float32),
                    f=np.zeros((0, 3), np.int32))
    return Mesh(v=np.concatenate(vs), f=np.concatenate(fs),
                vc=np.concatenate(vcs))
