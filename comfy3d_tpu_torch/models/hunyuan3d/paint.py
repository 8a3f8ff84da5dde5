"""Hunyuan3D paint: mesh + reference image → textured mesh.

Port of `comfy3d_tpu/models/hunyuan3d/paint.py` (the V2 RGB model, and the
2.1 PBR model with `pbr_settings=("albedo", "mr")`):

1. geometry maps of six candidate views (azimuths 0, 90, 180, 270, 0, 180;
   elevations 0, 0, 0, 0, 90, −90; distance 1.45): world-space normals and
   positions, each mapped from [-1, 1] to [0, 1], through the port's mesh
   rasterizer (`ops/rasterize.py`);
2. their VAE latents and the reference image's;
3. the reference ("write") pass of the dual UNet stream, once, on the clean
   reference latents at t = 0 with the learned reference tokens and camera
   label 0: each transformer block records its norm1 output;
4. guided Euler-ancestral steps (v-prediction, trailing spacing) of the
   2.5D multi-view UNet on rows ordered [attribute, view], the input the
   channel concatenation [noisy latent | normal latent | position latent],
   a camera-label class embedding per view; the uncond pass has zero
   prompt tokens and reads no reference, the cond pass the learned tokens
   (per attribute with PBR) and the reference through `attn_refview`;
5. the VAE decode of each row → views, and the cos⁴-weighted back-projection
   bake (`algorithms/color_project.py`) into an albedo, and with PBR a
   metallicRoughness texture on the same UVs.

Departure from the JAX package: the VAE's `encode` already multiplies the
latent mean by `scaling_factor` and `decode` divides by it; the JAX
pipeline multiplies and divides by `vae_scaling` once more (its latents
carry 0.18215², upstream's 0.18215). The port scales once, as upstream
does; the JAX pipeline with `PaintConfig(vae_scaling=1.0)` computes the
same.

The model's state dict is upstream's `UNet2p5DConditionModel` layout —
`unet.*` (with `unet.class_embedding`, `unet.learned_text_clip_{gen,ref}`
and, with PBR, `unet.learned_text_clip_{attr}`) and `unet_dual.*` — with
the `.transformer.` segment of each wrapped block removed, plus `vae.*`.
Each stage runs inside a `torch.profiler.record_function` span named in
`PAINT_STAGES` (the bake's under `color_project.BAKE_SPANS`).
"""

from __future__ import annotations

import dataclasses
import os
import re
from typing import Callable, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.profiler import record_function

from ... import resolve_device
from ...algorithms import color_project
from ...core.camera import Camera
from ...core.image import resize_images
from ...core.mesh import Mesh
from ...ops import rasterize as R
from ..common import init_weights_, seeded_model
from ..diffusion.config import unet_config_from_json, vae_config_from_json
from ..diffusion.schedulers import SchedulerConfig, make_scheduler
from ..diffusion.unet import UNet2DCondition, UNetConfig
from ..diffusion.vae import AutoencoderKL, VAEConfig
from ..loader import load_dir_state_dict, read_json_config

PAINT_STAGES = ("hunyuan3d_paint.render_geometry", "hunyuan3d_paint.encode",
                "hunyuan3d_paint.write_reference", "hunyuan3d_paint.denoise",
                "hunyuan3d_paint.decode", "hunyuan3d_paint.bake_albedo",
                "hunyuan3d_paint.bake_mr")


@dataclasses.dataclass(frozen=True)
class PaintConfig:
    render_size: int = 512
    texture_size: int = 1024
    camera_azims: Tuple[float, ...] = (0., 90., 180., 270., 0., 180.)
    camera_elevs: Tuple[float, ...] = (0., 0., 0., 0., 90., -90.)
    view_weights: Tuple[float, ...] = (1., .1, .5, .1, .05, .05)
    camera_distance: float = 1.45
    bake_exp: float = 4.0
    # the camera-label table: 5 reference labels, then 44 generation labels
    # (`_camera_info` + num_ref_cls)
    num_cls: int = 49
    num_ref_cls: int = 5
    prompt_tokens: int = 77
    prompt_dim: int = 1024
    # Hunyuan3D-2.1 PBR: attribute groups denoised together, each with its
    # learned tokens; () is the V2 RGB model
    pbr_settings: Tuple[str, ...] = ()
    unet: UNetConfig = UNetConfig(in_channels=12, out_channels=4,
                                  cross_attention_dim=1024, mv_views=6)
    vae: VAEConfig = VAEConfig()
    scheduler: SchedulerConfig = SchedulerConfig(
        prediction_type="v_prediction", timestep_spacing="trailing")

    @property
    def num_views(self) -> int:
        return len(self.camera_azims)

    @property
    def vae_factor(self) -> int:
        return 2 ** (len(self.vae.block_out_channels) - 1)


def _camera_info(azims, elevs) -> np.ndarray:
    """Each view's discretised camera label (upstream `pipelines.py:
    209-212`)."""
    div = {-20: 1, 0: 1, 20: 1, -90: 3, 90: 3}
    off = {-20: 0, 0: 12, 20: 24, -90: 36, 90: 40}
    return np.array(
        [(((int(a) // 30) + 9) % 12) // div[int(e)] + off[int(e)]
         for a, e in zip(azims, elevs)], np.int32)


class PaintUNet(UNet2DCondition):
    """The generation stream: the 2.5D UNet with the camera-label embedding
    (`class_embedding`, [num_cls, 4·C0]) and the learned prompt tokens
    (`learned_text_clip_{gen,ref}` and, per PBR attribute,
    `learned_text_clip_{attr}`, each [T, D]), under upstream's names."""

    def __init__(self, cfg: UNetConfig, num_cls: int, prompt_tokens: int,
                 prompt_dim: int, attrs: Tuple[str, ...] = ()):
        super().__init__(cfg)
        self.class_embedding = nn.Embedding(
            num_cls, cfg.block_out_channels[0] * 4)
        for name in ("gen", "ref") + tuple(attrs):
            self.register_parameter(f"learned_text_clip_{name}", nn.Parameter(
                torch.zeros(prompt_tokens, prompt_dim)))

    def tokens(self, name: str) -> torch.Tensor:
        return getattr(self, f"learned_text_clip_{name}")


class Hunyuan3DPaint(nn.Module):
    """`unet` (the 2.5D generation stream: 12 input channels, both extra
    attentions, `num_views` views per group), `unet_dual` (the reference
    stream: the 4-channel UNet without them) and `vae`."""

    def __init__(self, cfg: PaintConfig = PaintConfig()):
        super().__init__()
        self.cfg = cfg
        self.unet = PaintUNet(
            dataclasses.replace(cfg.unet, use_ma=True, use_ra=True,
                                mv_views=cfg.num_views),
            cfg.num_cls, cfg.prompt_tokens, cfg.prompt_dim, cfg.pbr_settings)
        self.unet_dual = UNet2DCondition(dataclasses.replace(
            cfg.unet, in_channels=4, use_ma=False, use_ra=False, mv_views=1))
        self.vae = AutoencoderKL(cfg.vae)


def _init_paint_(model: Hunyuan3DPaint, gen: torch.Generator) -> None:
    """`common.init_weights_` for the linear, conv and norm layers; the
    camera table and the learned tokens normal with std 0.02, as in the JAX
    package."""
    init_weights_(model, gen)
    with torch.no_grad():
        for name, p in model.unet.named_parameters(recurse=False):
            p.copy_(0.02 * torch.randn(p.shape, generator=gen,
                                       device=gen.device))
        w = model.unet.class_embedding.weight
        w.copy_(0.02 * torch.randn(w.shape, generator=gen, device=gen.device))


# upstream's `Basic2p5DTransformerBlock` nests the wrapped block under
# `.transformer.`; the 2.1 modules the port does not carry (the DINO
# conditioning, the material attention, the 2D position embeddings) are
# dropped by name, as the JAX package's converter drops them
_TRANSFORMER_SEGMENT = re.compile(r"(transformer_blocks\.\d+)\.transformer\.")
_DROPPED = re.compile(r"(image_proj_model_dino|attn_dino|attn_mda"
                      r"|pos_embed_2d|position_rope)")


def paint_state_dict_from_checkpoint(sd: Mapping[str, torch.Tensor]) -> dict:
    """An upstream `UNet2p5DConditionModel` state dict → the port's
    `unet.*` / `unet_dual.*` names: the `.transformer.` segment removed,
    the 2.1-only modules dropped, the learned tokens [1, T, D] → [T, D]."""
    out = {}
    for key, val in sd.items():
        if _DROPPED.search(key):
            continue
        key = _TRANSFORMER_SEGMENT.sub(r"\1.", key)
        if ".learned_text_clip_" in key and val.dim() == 3:
            val = val[0]
        out[key] = val
    return out


def _strip(sd: Mapping, prefix: str) -> dict:
    return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}


class Hunyuan3DPaintPipeline:
    def __init__(self, model: Hunyuan3DPaint):
        self.model = model.eval()
        self.cfg = model.cfg
        self.scheduler_name = "EulerAncestralDiscreteScheduler"
        self.delight: Optional[Callable] = None
        self.superres: Optional[Callable] = None

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device

    # -------------------------------------------------------------- #
    @classmethod
    def init_random(cls, seed: int = 0, cfg: PaintConfig = PaintConfig(),
                    device=None) -> "Hunyuan3DPaintPipeline":
        """Weights drawn from `seed` (`_init_paint_`) on `device` (default:
        the card; `common.seeded_model`)."""
        return cls(seeded_model(lambda: Hunyuan3DPaint(cfg), _init_paint_,
                                seed, device))

    @classmethod
    def from_pretrained(cls, model_dir: str, pbr: bool = False,
                        device=None) -> "Hunyuan3DPaintPipeline":
        """An upstream paint directory (`hunyuan3d-paint-v2-0[-turbo]`, or
        with `pbr` `hunyuan3d-paintpbr-v2-1`): `unet/` (config.json and the
        `UNet2p5DConditionModel` weights), `vae/` and `scheduler/`. The
        UNet's weights load strictly after `paint_state_dict_from_checkpoint`
        (`conv_in`'s width, the camera table's size and the token shape are
        read from them), the views are `PaintConfig.camera_azims`; a
        missing `vae/` draws the VAE from seed 0, a missing `scheduler/`
        keeps the default schedule. The model is built on `meta` and takes
        the loaded tensors as its own; floating weights load as float32."""
        unet_dir = os.path.join(model_dir, "unet")
        raw = read_json_config(os.path.join(unet_dir, "config.json"))
        sd = paint_state_dict_from_checkpoint(load_dir_state_dict(unet_dir))
        attrs = ("albedo", "mr") if pbr else ()
        # the wrapper widens conv_in after building the UNet of config.json
        ucfg = unet_config_from_json(
            raw, in_channels=sd["unet.conv_in.weight"].shape[1],
            mv_views=PaintConfig().num_views)
        tokens = sd["unet.learned_text_clip_ref"]
        kw = dict(unet=ucfg, pbr_settings=attrs,
                  prompt_tokens=tokens.shape[0], prompt_dim=tokens.shape[1],
                  num_cls=sd["unet.class_embedding.weight"].shape[0])
        vae_dir = os.path.join(model_dir, "vae")
        vae_sd = None
        if os.path.isdir(vae_dir):
            kw["vae"] = vae_config_from_json(
                read_json_config(os.path.join(vae_dir, "config.json")))
            vae_sd = load_dir_state_dict(vae_dir)
        sched_json = os.path.join(model_dir, "scheduler",
                                  "scheduler_config.json")
        if os.path.exists(sched_json):
            s = read_json_config(sched_json)
            kw["scheduler"] = dataclasses.replace(
                PaintConfig().scheduler,
                prediction_type=s.get("prediction_type", "v_prediction"),
                num_train_timesteps=s.get("num_train_timesteps", 1000),
                beta_start=s.get("beta_start", 0.00085),
                beta_end=s.get("beta_end", 0.012),
                beta_schedule=s.get("beta_schedule", "scaled_linear"))
        rest = [k for k in sd if not k.startswith(("unet.", "unet_dual."))]
        if rest:
            raise ValueError(f"unexpected keys in {unet_dir}: {rest[:6]}")
        with torch.device("meta"):
            model = Hunyuan3DPaint(PaintConfig(**kw))
        model.unet.load_state_dict(_strip(sd, "unet."), strict=True,
                                   assign=True)
        model.unet_dual.load_state_dict(_strip(sd, "unet_dual."),
                                        strict=True, assign=True)
        if vae_sd is not None:
            model.vae.load_state_dict(vae_sd, strict=True, assign=True)
        else:
            model.vae.to_empty(device="cpu")
            init_weights_(model.vae, torch.Generator().manual_seed(0))
        return cls(model.to(resolve_device(device)))

    def set_delight(self, fn):
        """fn(image [1, S, S, 3]) → [1, S, S, 3]: the lighting remover's
        slot, run on the reference image; none by default."""
        self.delight = fn

    def set_superres(self, fn):
        """fn(views [V, S, S, 3]) → [V, S', S', 3]: per-view enhancement
        before the bake (the RealESRGAN slot); views of another size are
        resized back to `render_size` (antialiased bilinear)."""
        self.superres = fn

    # -------------------------------------------------------------- #
    def _f32(self, x) -> torch.Tensor:
        if not torch.is_tensor(x):
            x = np.asarray(x, np.float32)
        return torch.as_tensor(x, dtype=torch.float32, device=self.device)

    def cameras(self) -> Camera:
        """The candidate views at `render_size`, a batch on the device. The
        poses are made on the CPU and copied, so every device sees the same
        bits (the card's sine and cosine may differ from the CPU's by an
        ulp)."""
        c = self.cfg
        cams = Camera.from_orbit(
            np.asarray(c.camera_elevs, np.float32),
            np.asarray(c.camera_azims, np.float32), c.camera_distance,
            width=c.render_size, height=c.render_size, device="cpu")
        return dataclasses.replace(cams, c2w=cams.c2w.to(self.device),
                                   fovy_deg=cams.fovy_deg.to(self.device))

    @torch.no_grad()
    def render_geometry(self, mesh: Mesh):
        """→ (normal maps, position maps), each [V, S, S, 3] in [0, 1] (0
        off the mesh), for the candidate views."""
        s = self.cfg.render_size
        with record_function(PAINT_STAGES[0]):
            if mesh.vn is None:
                mesh = mesh.auto_normal()
            v, vn = self._f32(mesh.v), self._f32(mesh.vn)
            f = torch.as_tensor(np.asarray(mesh.f, np.int32),
                                device=self.device)
            normals, positions = [], []
            for mvp in self.cameras().view_proj:
                rast = R.rasterize(v, f, mvp, s, s)
                hit = rast.mask[..., None] > 0
                for out, attr in ((normals, vn), (positions, v)):
                    img = R.interpolate(attr, rast, f)
                    out.append(torch.where(hit, img * 0.5 + 0.5, 0.0))
            return torch.stack(normals), torch.stack(positions)

    @torch.no_grad()
    def encode(self, images) -> torch.Tensor:
        """images [B, S, S, 3] in [0, 1] → latents [B, 4, S/f, S/f], the
        posterior's mean times the VAE's scaling factor (once)."""
        with record_function(PAINT_STAGES[1]):
            x = self._f32(images).permute(0, 3, 1, 2)
            return self.model.vae.encode(x * 2.0 - 1.0)

    @torch.no_grad()
    def decode(self, latents) -> torch.Tensor:
        """latents [B, 4, h, w] → images [B, S, S, 3] in [0, 1]."""
        with record_function(PAINT_STAGES[4]):
            img = self.model.vae.decode(latents)
            return torch.clamp(img * 0.5 + 0.5, 0.0, 1.0).permute(0, 2, 3, 1)

    @torch.no_grad()
    def write_reference(self, img_lat) -> dict:
        """The dual stream's reference pass on the clean reference latents
        [R, 4, h, w] at t = 0, with `learned_text_clip_ref` and camera
        label 0 → what its blocks wrote (`UNet2DCondition`'s `ref_mode`)."""
        unet = self.model.unet
        n_ref = img_lat.shape[0]
        with record_function(PAINT_STAGES[2]):
            cls_ref = unet.class_embedding(torch.zeros(
                n_ref, dtype=torch.long, device=self.device))
            ctx = unet.tokens("ref")[None].repeat(n_ref, 1, 1)
            _, ref = self.model.unet_dual(
                img_lat, torch.zeros(n_ref, device=self.device), ctx,
                class_emb=cls_ref, ref_mode="write")
        return ref

    @torch.no_grad()
    def conditioning(self):
        """The generation rows' conditioning, rows ordered [attribute,
        view]: (camera embeddings [rows, 4·C0], uncond context (zeros) and
        cond context [rows, T, D]: the learned gen tokens, or each
        attribute's tokens repeated over its views)."""
        c, unet = self.cfg, self.model.unet
        nv, n_attr = c.num_views, max(1, len(c.pbr_settings))
        labels = torch.as_tensor(
            _camera_info(c.camera_azims, c.camera_elevs) + c.num_ref_cls,
            dtype=torch.long, device=self.device)
        cls_gen = unet.class_embedding(labels).repeat(n_attr, 1)
        if c.pbr_settings:
            ctx_c = torch.stack([unet.tokens(a) for a in c.pbr_settings]
                                ).repeat_interleave(nv, dim=0)
        else:
            ctx_c = unet.tokens("gen")[None].repeat(nv, 1, 1)
        return cls_gen, torch.zeros_like(ctx_c), ctx_c

    @torch.no_grad()
    def guided_eps(self, x, t: float, geom, ref, cond,
                   guidance_scale: float) -> torch.Tensor:
        """One guided evaluation: the uncond and the cond pass of the
        generation UNet on [x | geom] at timestep t, mixed by the guidance
        scale. The uncond pass reads no reference (the JAX package computes
        its `attn_refview` on its own tokens and scales it by 0)."""
        cls_gen, ctx_u, ctx_c = cond
        unet = self.model.unet
        inp = torch.cat([x, geom], dim=1)
        tvec = torch.full((x.shape[0],), float(t), device=self.device)
        e_u = unet(inp, tvec, ctx_u, class_emb=cls_gen)
        e_c = unet(inp, tvec, ctx_c, class_emb=cls_gen, ref_mode="read",
                   ref_hidden=ref)
        return e_u + guidance_scale * (e_c - e_u)

    @torch.no_grad()
    def denoise(self, geom_lat, img_lat, num_steps: int,
                guidance_scale: float, seed: int = 0,
                draws: Optional[Mapping[str, object]] = None,
                ref: Optional[dict] = None) -> torch.Tensor:
        """geom_lat [V, 8, h, w] (normal | position latents), img_lat
        [1, 4, h, w] → latents [rows, 4, h, w], rows = attributes × V.
        `ref`, when given, is `write_reference(img_lat)`'s output, and the
        write pass is not run again.

        draws: the noise, NCHW — "latents" (the initial sample) and by
        loop step i "step"[i] (the sampler's). Without it the noise is
        drawn in that order from a CPU `torch.Generator` seeded with `seed`
        and moved to the device, so a seed gives the same views on every
        device."""
        c = self.cfg
        n_attr = max(1, len(c.pbr_settings))
        sched = make_scheduler(self.scheduler_name, c.scheduler, num_steps)
        if ref is None:
            ref = self.write_reference(img_lat)
        cond = self.conditioning()
        geom = geom_lat.repeat(n_attr, 1, 1, 1)
        shape = (geom.shape[0], 4) + tuple(geom.shape[2:])
        gen = None
        if draws is None:
            gen = torch.Generator().manual_seed(seed)
            latents = torch.randn(shape, generator=gen)
        else:
            latents = draws["latents"]
        latents = self._f32(latents) * sched.init_sigma
        aux = sched.init_aux(latents)
        with record_function(PAINT_STAGES[3]):
            for i in range(sched.loop_steps):
                if draws is not None:
                    noise = self._f32(draws["step"][i])
                elif sched.stochastic:
                    noise = torch.randn(shape, generator=gen).to(self.device)
                else:
                    noise = None
                eps = self.guided_eps(sched.scale_model_input(latents, i),
                                      sched.timesteps[i], geom, ref, cond,
                                      guidance_scale)
                latents, aux = sched.step_aux(eps, i, latents, aux, noise)
        return latents

    def paint_views(self, mesh: Mesh, image, num_steps: int = 15,
                    guidance_scale: float = 3.0, seed: int = 0, draws=None):
        """mesh + reference image [S, S, 3] (or [1, S, S, 3]) in [0, 1] →
        views [V, S, S, 3] in [0, 1]; with PBR a dict {attr: views}."""
        c = self.cfg
        s = c.render_size
        image = self._f32(image)
        if image.dim() == 3:
            image = image[None]
        if image.shape[1] != s:
            image = resize_images(image, s, s)
        if self.delight is not None:
            image = self.delight(image)
        normals, positions = self.render_geometry(mesh)
        geom_lat = torch.cat([self.encode(normals), self.encode(positions)],
                             dim=1)
        latents = self.denoise(geom_lat, self.encode(image), num_steps,
                               guidance_scale, seed, draws)
        views = self.decode(latents)
        if not c.pbr_settings:
            return views
        nv = c.num_views
        return {attr: views[i * nv:(i + 1) * nv]
                for i, attr in enumerate(c.pbr_settings)}

    def _bake_one(self, mesh: Mesh, views, info) -> Mesh:
        c = self.cfg
        views = self._f32(views)
        if self.superres is not None:
            views = self._f32(self.superres(views))
            if views.shape[1] != c.render_size:
                views = resize_images(views, c.render_size, c.render_size)
        return color_project.bake_projection(
            mesh, views, self.cameras(), texture_size=c.texture_size,
            cos_power=c.bake_exp, view_weights=c.view_weights,
            device=self.device, info=info)

    def bake(self, mesh: Mesh, views, info: dict | None = None) -> Mesh:
        """Views (or PBR's dict) → the mesh with its albedo (and with PBR
        its metallicRoughness texture, baked on the albedo's UVs) and vertex
        normals. `info`, when given, receives the albedo bake's unwrap."""
        if not self.cfg.pbr_settings:
            with record_function(PAINT_STAGES[5]):
                return self._bake_one(mesh, views, info).auto_normal()
        with record_function(PAINT_STAGES[5]):
            out = self._bake_one(mesh, views["albedo"], info)
        if "mr" in views:
            carrier = Mesh(v=out.v, f=out.f, vt=out.vt, ft=out.ft, vn=out.vn)
            with record_function(PAINT_STAGES[6]):
                carrier = self._bake_one(carrier, views["mr"], None)
            out = dataclasses.replace(out,
                                      metallic_roughness=carrier.albedo)
        return out.auto_normal()

    def __call__(self, mesh: Mesh, image, num_steps: int = 15,
                 guidance_scale: float = 3.0, seed: int = 0, draws=None,
                 info: dict | None = None) -> Mesh:
        """mesh + reference image [S, S, 3] in [0, 1] → the mesh with a
        baked albedo (+ metallicRoughness with PBR), UVs and normals."""
        views = self.paint_views(mesh, image, num_steps, guidance_scale,
                                 seed, draws)
        return self.bake(mesh, views, info)
