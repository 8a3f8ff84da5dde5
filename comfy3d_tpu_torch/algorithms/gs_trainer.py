"""3D Gaussian Splatting per-asset optimisation (multi-view → splats).

Port of `comfy3d_tpu/algorithms/gs_trainer.py` (the `Gaussian_Splatting_3D`
node's body). What carries over unchanged:

  * loss = (1-λ_ssim)·L1(masked rgb) + λ_alpha·MSE(alpha vs mask)
           + λ_ssim·(1-MS_SSIM);
  * hand-written Adam with per-group learning rates and the 3DGS
    exponential xyz schedule;
  * densify-and-prune inside a fixed-capacity buffer with an `alive` mask:
    clone (small splats with a high viewspace gradient), split (large ones;
    children's scale /1.6), prune (low opacity / large screen radius / large
    world scale); children go to dead slots and Adam moments are zeroed
    where a slot is reused or split;
  * opacity reset;
  * the viewspace-gradient statistics, from a zero offset added to the
    projected means (`means2d_offset`).

What differs from the JAX module:

  * the batch is a Python loop of `render_arrays` over views (JAX vmaps);
    each view renders through `GSTrainConfig.backend` (the compositor
    kernels on the card, their plain versions on the CPU): "flat", the
    coarse-bin path, or "tile", the per-16-px-tile path whose lists are cut
    at `max_per_tile`; the JAX names map onto them ("pallas" and "auto" →
    "flat", "xla" → "tile"); `chunk` only sets the tile path's rule that
    `max_per_tile` is a positive multiple of it;
  * randomness is explicit: a step takes its `view_idx` and `bgs`, densify
    its two standard-normal noise tensors, and `train` draws all of them
    from one `torch.Generator`;
  * `GSTrainState.step` is a Python int, and the scalar schedule terms
    (learning rate, Adam bias corrections) are computed on the host in
    float32, as the JAX module computes them on the device.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from ..core.camera import Camera
from ..core.gaussian import GaussianSplat, quat_to_rotmat
from ..ops import gs_render, ssim as ssim_ops

PARAMS = ("xyz", "sh", "opacity_raw", "scale_raw", "rot_raw")


@dataclasses.dataclass(frozen=True)
class GSTrainConfig:
    # training (defaults mirror the reference's GSParams)
    iterations: int = 30_000
    batch_size: int = 1
    lambda_ssim: float = 0.2
    lambda_alpha: float = 3.0
    invert_bg_prob: float = 0.5
    # learning rates
    feature_lr: float = 0.0025
    opacity_lr: float = 0.05
    scaling_lr: float = 0.005
    rotation_lr: float = 0.001
    position_lr_init: float = 0.00016
    position_lr_final: float = 0.0000016
    position_lr_delay_mult: float = 0.01
    position_lr_max_steps: int = 30_000
    # densification
    num_pts: int = 5000
    capacity: int = 65536
    percent_dense: float = 0.01
    density_start_iter: int = 500
    density_end_iter: int = 15_000
    densification_interval: int = 100
    opacity_reset_interval: int = 3000
    densify_grad_threshold: float = 0.0002
    prune_min_opacity: float = 0.005
    prune_max_screen_px: float = 20.0
    prune_max_world_scale: float = 0.4   # 0.1 * extent(=4) as in reference
    scene_extent: float = 4.0
    sh_degree: int = 0
    # renderer (see `gs_render.render_arrays`)
    max_per_tile: int = 512
    chunk: int = 16
    backend: str = "auto"

    def __post_init__(self):
        if gs_render.BACKENDS.get(self.backend) == "tile":
            gs_render.check_tile_cap(self.max_per_tile, self.chunk)


def exponential_lr(step, lr_init, lr_final, delay_mult, max_steps) -> float:
    """The 3DGS position LR schedule (log-linear with warm-up delay), in
    float32 with the JAX function's operations."""
    f = np.float32
    t = np.clip(f(step) / f(max_steps), f(0), f(1))
    x = np.clip(f(step) / f(0.01 * max_steps + 1e-8), f(0), f(1))
    delay = f(delay_mult) + f(1 - delay_mult) * np.sin(f(0.5 * np.pi) * x)
    log_lerp = np.exp(np.log(f(lr_init)) * (f(1) - t)
                      + np.log(f(lr_final)) * t)
    return float(delay * log_lerp)


@dataclasses.dataclass(frozen=True)
class GSTrainState:
    params: dict             # xyz, sh, opacity_raw, scale_raw, rot_raw
    alive: torch.Tensor      # [cap] bool
    adam_m: dict
    adam_v: dict
    grad_accum: torch.Tensor  # [cap] viewspace grad-norm accumulator
    denom: torch.Tensor       # [cap]
    max_radii: torch.Tensor   # [cap]
    step: int

    def to_splat(self) -> GaussianSplat:
        p = self.params
        return GaussianSplat(xyz=p["xyz"], sh=p["sh"],
                             opacity_raw=p["opacity_raw"],
                             scale_raw=p["scale_raw"], rot_raw=p["rot_raw"],
                             alive=self.alive)


def init_state(splat: GaussianSplat) -> GSTrainState:
    params = {k: getattr(splat, k).detach() for k in PARAMS}
    cap = splat.num_capacity
    zeros = lambda: torch.zeros(cap, device=splat.device)   # noqa: E731
    return GSTrainState(
        params=params, alive=splat.alive,
        adam_m={k: torch.zeros_like(v) for k, v in params.items()},
        adam_v={k: torch.zeros_like(v) for k, v in params.items()},
        grad_accum=zeros(), denom=zeros(), max_radii=zeros(), step=0)


def _lr_tree(cfg: GSTrainConfig, step: int) -> dict:
    xyz_lr = np.float32(exponential_lr(
        step, cfg.position_lr_init, cfg.position_lr_final,
        cfg.position_lr_delay_mult, cfg.position_lr_max_steps)) \
        * np.float32(cfg.scene_extent)
    return {"xyz": float(xyz_lr), "sh": cfg.feature_lr,
            "opacity_raw": cfg.opacity_lr, "scale_raw": cfg.scaling_lr,
            "rot_raw": cfg.rotation_lr}


_B1, _B2, _EPS = 0.9, 0.999, 1e-15


@torch.no_grad()
def _adam_update(params, grads, m, v, lrs, step: int):
    """Hand-rolled Adam: per-leaf LR, moments owned by the state so densify
    can zero reused slots. Returns (params, m, v), new tensors."""
    f = np.float32
    t = f(step) + f(1)
    bc1 = float(f(1) - f(_B1) ** t)
    bc2 = float(f(1) - f(_B2) ** t)
    new_m = {k: _B1 * m[k] + (1 - _B1) * grads[k] for k in params}
    new_v = {k: _B2 * v[k] + (1 - _B2) * grads[k] * grads[k] for k in params}
    new_p = {k: params[k] - lrs[k] * (new_m[k] / bc1)
             / (torch.sqrt(new_v[k] / bc2) + _EPS) for k in params}
    return new_p, new_m, new_v


def _rows(mask, like):
    return mask.reshape((-1,) + (1,) * (like.dim() - 1))


# ------------------------------------------------------------------ #
# Train step
# ------------------------------------------------------------------ #
def make_train_step(cfg: GSTrainConfig, cameras: Camera,
                    images: torch.Tensor, masks: torch.Tensor):
    """The train step over a fixed reference view set.

    images: [V, H, W, 3] in [0,1]; masks: [V, H, W]; cameras batched [V];
    all on one device. Returns `train_step(state, view_idx, bgs)` →
    (new state, metrics): `view_idx` [B] view indices (a host tensor or a
    sequence of ints), `bgs` [B, 3] background colours.
    """
    height, width = cameras.height, cameras.width
    masked_ref = images * masks[..., None]
    w2c, intr, campos = cameras.w2c, cameras.intrinsics, cameras.campos
    # pytorch_msssim's 5-level default, clamped to what the render size
    # supports (each level halves; a level needs >= the 11px window)
    side = min(height, width)
    levels = max(1, min(5, int(np.log2(max(side // 11, 1))) + 1))

    def loss_fn(params, alive, vs_off, view_idx, bgs):
        splat = GaussianSplat(alive=alive, **params)
        scale, rot, opacity = splat.scale, splat.rotation, splat.opacity
        outs = [gs_render.render_arrays(
            splat.xyz, scale, rot, opacity, splat.colors_toward(campos[i]),
            alive, w2c[i], intr[i], width, height, background=bgs[b],
            max_per_tile=cfg.max_per_tile, chunk=cfg.chunk,
            means2d_offset=vs_off[b], backend=cfg.backend)
            for b, i in enumerate(view_idx)]
        img = torch.stack([o["image"] for o in outs])     # [B, H, W, 3]
        alpha = torch.stack([o["alpha"] for o in outs])
        ref_m = masks[view_idx]
        rendered_masked = img * ref_m[..., None]
        target_masked = masked_ref[view_idx]

        l1 = (rendered_masked - target_masked).abs().mean()
        l_alpha = ((alpha - ref_m) ** 2).mean()
        l_ssim = 1.0 - ssim_ops.ms_ssim(target_masked, rendered_masked,
                                        levels=levels)
        loss = ((1 - cfg.lambda_ssim) * l1 + cfg.lambda_alpha * l_alpha
                + cfg.lambda_ssim * l_ssim)
        radii = torch.stack([o["radii"] for o in outs]).detach()
        return loss, dict(radii=radii, l1=l1, alpha=l_alpha, ssim=l_ssim)

    def train_step(state: GSTrainState, view_idx, bgs):
        view_idx = [int(i) for i in torch.as_tensor(view_idx).tolist()]
        dev = state.alive.device
        bgs = torch.as_tensor(bgs, dtype=torch.float32, device=dev)
        params = {k: p.detach().requires_grad_(True)
                  for k, p in state.params.items()}
        cap = state.alive.shape[0]
        vs_off = [torch.zeros((cap, 2), device=dev, requires_grad=True)
                  for _ in view_idx]
        loss, aux = loss_fn(params, state.alive, vs_off, view_idx, bgs)
        inputs = [params[k] for k in PARAMS] + vs_off
        grads = torch.autograd.grad(loss, inputs, allow_unused=True)
        grads = [torch.zeros_like(x) if g is None else g
                 for x, g in zip(inputs, grads)]
        g_params = dict(zip(PARAMS, grads[:len(PARAMS)]))
        g_vs = torch.stack(grads[len(PARAMS):])           # [B, cap, 2]

        with torch.no_grad():
            new_p, new_m, new_v = _adam_update(
                state.params, g_params, state.adam_m, state.adam_v,
                _lr_tree(cfg, state.step), state.step)
            # keep dead slots frozen
            new_p = {k: torch.where(_rows(state.alive, p), p, state.params[k])
                     for k, p in new_p.items()}
            # densification stats: per-view viewspace grad norms, visibility
            radii = aux["radii"]                          # [B, cap]
            visible = radii > 0
            vs_norm = torch.linalg.vector_norm(g_vs, dim=-1)
            grad_accum = state.grad_accum + (vs_norm * visible).sum(0)
            denom = state.denom + visible.sum(0).to(torch.float32)
            max_radii = torch.maximum(state.max_radii,
                                      (radii * visible).amax(0))
        new_state = dataclasses.replace(
            state, params=new_p, adam_m=new_m, adam_v=new_v,
            grad_accum=grad_accum, denom=denom, max_radii=max_radii,
            step=state.step + 1)
        metrics = {"loss": loss.detach(), "l1": aux["l1"].detach(),
                   "alpha": aux["alpha"].detach(),
                   "ssim": aux["ssim"].detach(),
                   "num_alive": state.alive.sum()}
        return new_state, metrics

    return train_step


# ------------------------------------------------------------------ #
# Densify / prune / opacity reset (all capacity-preserving)
# ------------------------------------------------------------------ #
def make_densify_step(cfg: GSTrainConfig):
    """Returns `densify_and_prune(state, noise1, noise2)`; the noises are
    [cap, 3] standard normal (the split children's offsets before scaling
    and rotation)."""

    @torch.no_grad()
    def densify_and_prune(state: GSTrainState, noise1, noise2):
        p = state.params
        cap = state.alive.shape[0]
        alive = state.alive
        scale = torch.exp(p["scale_raw"])
        opacity = torch.sigmoid(p["opacity_raw"])
        grads = torch.nan_to_num(
            state.grad_accum / torch.clamp_min(state.denom, 1.0))

        max_scale = scale.amax(-1)
        dense_limit = cfg.percent_dense * cfg.scene_extent
        hot = (grads >= cfg.densify_grad_threshold) & alive
        clone_mask = hot & (max_scale <= dense_limit)
        split_mask = hot & (max_scale > dense_limit)

        # prune first → frees slots for children
        prune = alive & ((opacity < cfg.prune_min_opacity)
                         | (state.max_radii > cfg.prune_max_screen_px)
                         | (max_scale > cfg.prune_max_world_scale))
        alive = alive & ~prune
        clone_mask &= alive
        split_mask &= alive

        # split: source slot becomes child 1 (in place), child 2 → free slot
        R = quat_to_rotmat(p["rot_raw"] / torch.clamp_min(
            torch.linalg.vector_norm(p["rot_raw"], dim=-1, keepdim=True),
            1e-12))
        off1 = torch.einsum("nij,nj->ni", R, noise1 * scale)
        off2 = torch.einsum("nij,nj->ni", R, noise2 * scale)
        child_scale_raw = p["scale_raw"] - float(np.log(np.float32(1.6)))

        new_p = dict(p)
        new_p["xyz"] = torch.where(split_mask[:, None], p["xyz"] + off1,
                                   p["xyz"])
        new_p["scale_raw"] = torch.where(split_mask[:, None],
                                         child_scale_raw, p["scale_raw"])

        # candidate queue: clones first, then split-children
        cand_mask = torch.cat([clone_mask, split_mask])    # [2*cap]
        cand = {"xyz": torch.cat([p["xyz"], p["xyz"] + off2]),
                "sh": torch.cat([p["sh"]] * 2),
                "opacity_raw": torch.cat([p["opacity_raw"]] * 2),
                "scale_raw": torch.cat([p["scale_raw"], child_scale_raw]),
                "rot_raw": torch.cat([p["rot_raw"]] * 2)}

        ordinal = torch.cumsum(cand_mask.to(torch.int64), 0) - 1
        free_slots = torch.argsort(alive.to(torch.int32), stable=True)
        num_free = cap - alive.sum()                        # dead-first
        ok = cand_mask & (ordinal < num_free)
        dst = torch.where(ok, free_slots[ordinal.clamp(0, cap - 1)],
                          torch.full_like(ordinal, cap))

        def place(buf, values):
            # write at dst; dst == cap lands in a spare row that is dropped
            ext = torch.cat([buf, buf[:1]])
            ext[dst] = values
            return ext[:cap]

        new_p = {k: place(new_p[k], cand[k]) for k in PARAMS}
        alive = place(alive, torch.ones_like(cand_mask))

        # zero Adam moments at reused slots and split sources
        touched = place(torch.zeros_like(alive), torch.ones_like(cand_mask))
        touched = touched | split_mask

        def clear(mom):
            return torch.where(_rows(touched, mom), torch.zeros_like(mom),
                               mom)

        zeros = torch.zeros_like(state.grad_accum)
        return dataclasses.replace(
            state, params=new_p, alive=alive,
            adam_m={k: clear(v) for k, v in state.adam_m.items()},
            adam_v={k: clear(v) for k, v in state.adam_v.items()},
            grad_accum=zeros, denom=zeros.clone(), max_radii=zeros.clone())

    return densify_and_prune


@torch.no_grad()
def reset_opacity(state: GSTrainState) -> GSTrainState:
    """Clamp opacity to ≤0.01 (the reference's `reset_opacity`)."""
    new_op = torch.clamp_max(torch.sigmoid(state.params["opacity_raw"]),
                             0.01)
    p = dict(state.params)
    p["opacity_raw"] = torch.log(new_op / (1.0 - new_op))
    m = dict(state.adam_m)
    v = dict(state.adam_v)
    m["opacity_raw"] = torch.zeros_like(m["opacity_raw"])
    v["opacity_raw"] = torch.zeros_like(v["opacity_raw"])
    return dataclasses.replace(state, params=p, adam_m=m, adam_v=v)


# ------------------------------------------------------------------ #
# Training loop
# ------------------------------------------------------------------ #
def draw_step_inputs(generator: torch.Generator, nviews: int,
                     batch_size: int, invert_bg_prob: float):
    """(view_idx [B] int64, bgs [B, 3]) for one step, on the generator's
    device: uniform views; black background with `invert_bg_prob`, else
    white."""
    dev = generator.device
    view_idx = torch.randint(0, nviews, (batch_size,), generator=generator,
                             device=dev)
    u = torch.rand((batch_size, 1), generator=generator, device=dev)
    bgs = (u >= invert_bg_prob).to(torch.float32).expand(batch_size, 3)
    return view_idx, bgs


def train(splat: GaussianSplat, cameras: Camera, images, masks,
          cfg: GSTrainConfig = GSTrainConfig(),
          generator: Optional[torch.Generator] = None,
          progress: Optional[Callable[[int, dict], None]] = None
          ) -> GaussianSplat:
    """Run the full optimisation on the splat's device; returns the trained
    splat. Every random draw (views, backgrounds, split noise) comes from
    `generator` (a CPU generator seeded 0 when None). `progress(it,
    metrics)` plays the role of comfy's ProgressBar callback."""
    dev = splat.device
    images = torch.as_tensor(images, dtype=torch.float32, device=dev)
    masks = torch.as_tensor(masks, dtype=torch.float32, device=dev)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    state = init_state(splat)
    step_fn = make_train_step(cfg, cameras, images, masks)
    densify_fn = make_densify_step(cfg)
    nviews = images.shape[0]
    cap = splat.num_capacity

    for it in range(cfg.iterations):
        view_idx, bgs = draw_step_inputs(generator, nviews, cfg.batch_size,
                                         cfg.invert_bg_prob)
        state, metrics = step_fn(state, view_idx.cpu(), bgs)
        in_window = cfg.density_start_iter <= it <= cfg.density_end_iter
        if in_window and it > 0 and it % cfg.densification_interval == 0:
            noise = torch.randn((2, cap, 3), generator=generator,
                                device=generator.device).to(dev)
            state = densify_fn(state, noise[0], noise[1])
        if in_window and it > 0 and it % cfg.opacity_reset_interval == 0:
            state = reset_opacity(state)
        if progress is not None and (it % 50 == 0
                                     or it == cfg.iterations - 1):
            progress(it, {k: float(v) for k, v in metrics.items()})
    return state.to_splat()
