"""TripoSR pipeline: image → scene codes → mesh (+ vertex colours) or
orbit renders.

Port of `comfy3d_tpu/models/triposr/pipeline.py`. Weights are either drawn
from a seed (`init_random`; drawn on the target device) or loaded from
the public checkpoint's native torch state dict (`from_pretrained`, strict, no conversion table).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch.profiler import record_function

from ... import resolve_device
from ...core.camera import Camera, get_rays
from ...core.mesh import Mesh
from ...ops import raymarch, tetra, volume
from ..common import init_weights_, seeded_model
from .model import TripoSR, TripoSRConfig

# the profiler spans of `TripoSRPipeline.extract_mesh`, in the order it runs
# them: the density decode, marching tets with the weld, the mesh's copy to
# the host, the vertex colours, the host's vertex normals
EXTRACT_STAGES = ("extract_mesh.decode", "extract_mesh.sweep_weld",
                  "extract_mesh.to_host", "extract_mesh.colors",
                  "extract_mesh.normals")


def _init_params(model: TripoSR, generator: torch.Generator) -> None:
    """Seeded weights in the JAX package's scheme (`common.init_weights_`),
    the triplane tokens normal with std 1/sqrt(C); the ViT's cls token and
    position grid normal with std 0.02 (HF's ViT init), so the grid resize
    sees values."""
    init_weights_(model, generator)
    with torch.no_grad():
        emb = model.image_tokenizer.model.embeddings
        for p in (emb.cls_token, emb.position_embeddings):
            p.copy_(torch.randn(p.shape, generator=generator, device=generator.device) * 0.02)
        tok = model.tokenizer.embeddings
        tok.copy_(torch.randn(tok.shape, generator=generator, device=generator.device)
                  / tok.shape[1] ** 0.5)


class TripoSRPipeline:
    def __init__(self, model: TripoSR):
        self.model = model.eval()
        self.cfg = model.cfg

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device

    # -------------------------------------------------------------- #
    @classmethod
    def init_random(cls, seed: int = 0, cfg: TripoSRConfig = TripoSRConfig(),
                    device=None) -> "TripoSRPipeline":
        """Weights drawn from `seed` on `device` (default: the card;
        `common.seeded_model`)."""
        return cls(seeded_model(lambda: TripoSR(cfg), _init_params, seed,
                                device))

    @classmethod
    def from_pretrained(cls, path: str, cfg: TripoSRConfig = TripoSRConfig(),
                        device=None) -> "TripoSRPipeline":
        """The public TripoSR checkpoint (`model.ckpt`, a torch state dict in
        its native layout), loaded strictly onto `device`."""
        sd = torch.load(path, map_location="cpu", weights_only=True)
        if isinstance(sd, dict) and "state_dict" in sd:
            sd = sd["state_dict"]
        with torch.device("meta"):
            model = TripoSR(cfg)
        model.load_state_dict(sd, strict=True, assign=True)
        return cls(model.to(resolve_device(device)))

    # -------------------------------------------------------------- #
    @torch.no_grad()
    def scene_codes(self, images) -> torch.Tensor:
        """images [B, H, W, 3] or [H, W, 3] in [0, 1] (preprocessed, square;
        numpy or tensor) → triplanes [B, 3, C, 64, 64]. Other sizes are
        resized to the model's with an antialiased bilinear filter, as
        `jax.image.resize` does."""
        x = torch.as_tensor(np.array(images, np.float32)
                            if not torch.is_tensor(images) else images,
                            dtype=torch.float32, device=self.device)
        if x.dim() == 3:
            x = x[None]
        x = x.permute(0, 3, 1, 2)
        s = self.cfg.cond_image_size
        if tuple(x.shape[-2:]) != (s, s):
            x = F.interpolate(x, size=(s, s), mode="bilinear",
                              align_corners=False, antialias=True)
        return self.model(x)

    def field_fn(self, triplanes):
        """(xyz [N, 3], dirs) → (sigma [N], rgb [N, 3]) of one scene."""
        def field(xyz, dirs):
            return self.model.query(triplanes, xyz)
        return field

    @torch.no_grad()
    def render(self, triplanes, cameras: Camera, num_steps: int = 128,
               chunk_rays: int = 65536):
        """Renders of one scene code [3, C, H, W] from `cameras`:
        dict(rgb [..., H, W, 3], alpha, depth)."""
        field = self.field_fn(triplanes)
        origins, dirs = get_rays(cameras)
        shape = origins.shape[:-1]
        o = origins.reshape(-1, 3)
        d = dirs.reshape(-1, 3)
        outs = {"rgb": [], "alpha": [], "depth": []}
        for i in range(0, o.shape[0], chunk_rays):
            out = raymarch.march(field, o[i:i + chunk_rays],
                                 d[i:i + chunk_rays], bound=self.cfg.radius,
                                 num_steps=num_steps)
            for k in outs:
                outs[k].append(out[k])
        return {k: torch.cat(v).reshape(shape + v[0].shape[1:])
                for k, v in outs.items()}

    @torch.no_grad()
    def extract_mesh(self, triplanes, resolution: int = 256,
                     threshold: float = 25.0, max_tris: int = 2_000_000,
                     with_color: bool = True, on_overflow: str = "retry"):
        """Density lattice → marching-tets mesh with uint8-quantized vertex
        colours, on the scene code's device; returns a host `Mesh`.

        The decode is coarse-to-fine when the resolution's 2× chain exists
        (`volume.decode_grid`); a resolution like 256 is bumped by one
        vertex so that it does (the iso surface is unaffected). Each stage
        runs under a `torch.profiler.record_function` span named in
        `EXTRACT_STAGES`, so a profile of one call splits its time."""
        r = int(resolution)
        if volume.hier_plan(r) is None and volume.hier_plan(r + 1):
            r += 1
        radius = self.cfg.radius

        def sigma(pts):
            return self.model.query(triplanes, pts)[0]

        decode, sweep, to_host, colors, normals = EXTRACT_STAGES
        with record_function(decode):
            grid = volume.decode_grid(sigma, r, radius, iso=threshold,
                                      device=triplanes.device)
        with record_function(sweep):
            v, f, nv, nf = tetra.extract_isosurface_device(
                grid, iso=threshold, bounds=(-radius, radius),
                max_tris=max_tris, on_overflow=on_overflow)
            del grid
        with record_function(to_host):
            mesh = Mesh(v=v[:nv].cpu().numpy(), f=f[:nf].cpu().numpy())
        if with_color and nv:
            with record_function(colors):
                cols = volume.query_chunked(
                    lambda pts: self.model.query(triplanes, pts)[1], v[:nv],
                    chunk=262144)
                cols = torch.clamp(torch.round(cols * 255.0), 0, 255).to(
                    torch.uint8)
                mesh.vc = cols.cpu().numpy().astype(np.float32) / 255.0
        with record_function(normals):
            return mesh.auto_normal()
