"""Stable-Diffusion-class conditional UNet (NCHW).

Port of `comfy3d_tpu/models/diffusion/unet.py`: a `UNet2DConditionModel`
with (CrossAttn)Down/Mid/Up blocks, GroupNorm-SiLU-Conv resnets, spatial
transformers with self- and cross-attention, and sinusoidal time
embeddings. Submodules carry diffusers' names (`conv_in`,
`time_embedding.linear_{1,2}`, `down_blocks.{i}.{resnets,attentions,
downsamplers}`, `mid_block`, `up_blocks.{i}.{resnets,attentions,
upsamplers}`, `conv_norm_out`, `conv_out`), the layout the JAX package's
`models/diffusion/convert.py::unet_rules` reads; `proj_in`/`proj_out` are
linear (SD2.x's `use_linear_projection`), as in the JAX package.

MVDream's 3D self-attention (`mv_views > 1`) folds the views of each
sample into one token sequence; the cross-attention of a fold reads only
its first view's context, as the JAX package does.

Zero123Plus's reference attention: a call with `ref_mode="write"` returns
(output, written), `written` holding what each spatial transformer's
blocks recorded (their norm1 outputs, a list per transformer) under the
keys `sa_0, sa_1, …` in call order (down blocks, mid, up blocks); a call
with `ref_mode="read"` and that dict as `ref_hidden` appends each entry to
the keys and values of its block's self-attention.

Hunyuan paint's 2.5D blocks (`use_ma`, `use_ra`; upstream's
`Basic2p5DTransformerBlock`): self-attention `attn1` stays per view and
reads no extra keys. Beside it, reading the same norm1 output and adding
to the residual, `attn_refview` cross-attends to the block's entry of
`ref_hidden` (scaled by `ref_scale` on a read; one reference row serves
all the rows of its group) and `attn_multiview` self-attends over the
`mv_views` consecutive rows of each group as one token sequence (scaled by
`mva_scale`). The spatial transformers then do not fold the views. Off a
read, the JAX package runs `attn_refview` on the block's own tokens and
multiplies it by 0; the port skips it, which gives the same result for
finite values.

The arithmetic is the JAX package's: GroupNorm eps 1e-5 in the resnets and
`conv_norm_out`, 1e-6 in the spatial transformers, LayerNorm eps 1e-6, the
feed-forward's GEGLU gated by the tanh GELU (`models/common.py`). Token
sequences are flattened row-major over (H, W) with the channels last.

ImageDream's image prompt (`ip_dim` > 0): the last `ip_dim` tokens of the
context are the Resampler's, and every cross-attention `attn2` reads them
through its own `to_k_ip` / `to_v_ip` (the queries shared) and adds that
attention's output with weight `ip_weight`. CRM's T2I-Adapter
(`adapter_residuals`, one feature map per down block, diffusers'
`down_intrablock_additional_residuals`): added after the first resnet of
each down block.

Not ported: the options of the other UNet families. Each raises
NotImplementedError naming its ROADMAP item: Wonder3D's `cd_joint`, Era3D's
`mv_rowwise` and `pose_hook`, MV-Adapter's `mv_decoupled` (with its
reference branch's `ref_scale`), SDXL's `addition_embed_type` and
per-block `transformer_depth`, and the ControlNet residuals. Reference
attention over MVDream's multi-view fold (`ref_mode` with `mv_views > 1`
and neither 2.5D attention), which no family uses, raises too.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..common import Attention, BasicTransformerBlock, _attend


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    in_channels: int = 4
    out_channels: int = 4
    block_out_channels: Tuple[int, ...] = (320, 640, 1280, 1280)
    layers_per_block: int = 2
    cross_attention_dim: int = 1024
    attention_head_dim: int = 64     # per-head dim; < 0: a head count
    norm_groups: int = 32
    down_block_types: Tuple[str, ...] = (
        "CrossAttnDownBlock2D", "CrossAttnDownBlock2D",
        "CrossAttnDownBlock2D", "DownBlock2D")
    up_block_types: Tuple[str, ...] = (
        "UpBlock2D", "CrossAttnUpBlock2D", "CrossAttnUpBlock2D",
        "CrossAttnUpBlock2D")
    # > 1: MVDream's 3D self-attention over all views of a sample
    mv_views: int = 1
    # ImageDream: the context's last ip_dim tokens through attn2's own
    # to_k_ip / to_v_ip, added with weight ip_weight
    ip_dim: int = 0
    ip_weight: float = 1.0
    # the other families' options (the JAX package's fields); any value
    # but the default raises in `UNet2DCondition`
    cd_joint: bool = False
    mv_rowwise: bool = False
    use_ma: bool = False
    use_ra: bool = False
    mva_scale: float = 1.0
    ref_scale: float = 1.0
    transformer_depth: Tuple[int, ...] | int = 1
    addition_embed_type: str = ""
    addition_time_embed_dim: int = 256
    addition_proj_dim: int = 2816
    mv_decoupled: bool = False
    mv_use_ref: bool = True

    @classmethod
    def sd15(cls) -> "UNetConfig":
        return cls(cross_attention_dim=768, attention_head_dim=-8)

    @classmethod
    def sd21(cls) -> "UNetConfig":
        return cls(cross_attention_dim=1024, attention_head_dim=64)


# config fields of other families → the ROADMAP item that ports them
_UNPORTED_FIELDS = (
    ("cd_joint", "Wonder3D's cross-domain attention", "A.6.6"),
    ("mv_rowwise", "Era3D's row-wise attention", "A.6.6"),
    ("mv_decoupled", "MV-Adapter's decoupled attention", "A.6.6"),
    ("addition_embed_type", "SDXL's added embedding", "A.6.6"),
)


def _unported(what: str, item: str):
    return NotImplementedError(f"{what} is not ported (ROADMAP {item})")


def check_config(cfg: UNetConfig) -> None:
    """Raise for a config field of a family the port does not carry."""
    default = UNetConfig()
    for field, what, item in _UNPORTED_FIELDS:
        if getattr(cfg, field) != getattr(default, field):
            raise _unported(f"UNetConfig.{field} ({what})", item)
    if not isinstance(cfg.transformer_depth, int):
        raise _unported("a per-block transformer_depth (SDXL)", "A.6.6")


def timestep_embedding(t: torch.Tensor, dim: int,
                       max_period: float = 10000.0) -> torch.Tensor:
    """Sinusoidal embedding [B, dim], [cos, sin] (diffusers `Timesteps`
    with flip_sin_to_cos=True, downscale_freq_shift=0)."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period) * torch.arange(
        half, dtype=torch.float32, device=t.device) / half)
    args = t.to(torch.float32)[:, None] * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


class ResnetBlock(nn.Module):
    """diffusers `ResnetBlock2D`: GN-SiLU-conv, + the projected time
    embedding, GN-SiLU-conv, + the (1×1-projected) input."""

    def __init__(self, in_channels: int, out_channels: int, temb_dim: int,
                 norm_groups: int = 32):
        super().__init__()
        self.norm1 = nn.GroupNorm(norm_groups, in_channels, eps=1e-5)
        self.conv1 = nn.Conv2d(in_channels, out_channels, 3, padding=1)
        self.time_emb_proj = nn.Linear(temb_dim, out_channels)
        self.norm2 = nn.GroupNorm(norm_groups, out_channels, eps=1e-5)
        self.conv2 = nn.Conv2d(out_channels, out_channels, 3, padding=1)
        self.conv_shortcut = (nn.Conv2d(in_channels, out_channels, 1)
                              if in_channels != out_channels else None)

    def forward(self, x, temb):
        h = self.conv1(F.silu(self.norm1(x)))
        h = h + self.time_emb_proj(F.silu(temb))[:, :, None, None]
        h = self.conv2(F.silu(self.norm2(h)))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


class IPCrossAttention(Attention):
    """ImageDream's cross-attention (`LGM/mvdream/mv_unet.py:160-246`): the
    context's last `ip_dim` tokens are image-prompt tokens, attended by the
    same queries through `to_k_ip` / `to_v_ip`; that output, times
    `ip_weight`, is added to the text attention's before `to_out`."""

    def __init__(self, query_dim: int, heads: int, dim_head: int,
                 cross_attention_dim: int, ip_dim: int,
                 ip_weight: float = 1.0):
        super().__init__(query_dim, heads, dim_head,
                         cross_attention_dim=cross_attention_dim)
        self.ip_dim, self.ip_weight = ip_dim, ip_weight
        self.to_k_ip = nn.Linear(cross_attention_dim, heads * dim_head,
                                 bias=False)
        self.to_v_ip = nn.Linear(cross_attention_dim, heads * dim_head,
                                 bias=False)

    def forward(self, x, context, mask=None):
        if mask is not None:
            raise ValueError("ImageDream's cross-attention takes no mask")
        ctx, ip = context[:, :-self.ip_dim], context[:, -self.ip_dim:]
        q = self.to_q(x)
        out = _attend(q, self.to_k(ctx), self.to_v(ctx), self.heads)
        out = out + self.ip_weight * _attend(q, self.to_k_ip(ip),
                                             self.to_v_ip(ip), self.heads)
        return self.to_out[0](out)


class Basic2p5DBlock(BasicTransformerBlock):
    """Hunyuan paint's 2.5D transformer block: `BasicTransformerBlock` (its
    attn1 per view, without reference keys) plus `attn_refview` (with
    `use_ra`) and `attn_multiview` (with `use_ma`), both reading norm1's
    output. Upstream nests the wrapped block's layers under `.transformer.`
    in its checkpoints; here they sit beside the two attentions."""

    def __init__(self, dim: int, heads: int, dim_head: int,
                 cross_attention_dim: int, use_ma: bool, use_ra: bool,
                 mva_scale: float = 1.0, ref_scale: float = 1.0):
        super().__init__(dim, heads, dim_head,
                         cross_attention_dim=cross_attention_dim)
        self.mva_scale, self.ref_scale = mva_scale, ref_scale
        self.attn_refview = (Attention(dim, heads, dim_head)
                             if use_ra else None)
        self.attn_multiview = (Attention(dim, heads, dim_head)
                               if use_ma else None)

    def forward(self, x, context=None, ref_mode=None, ref_hidden=None,
                mv_views: int = 1):
        if ref_mode not in (None, "write", "read"):
            raise ValueError(f"ref_mode {ref_mode!r}")
        h = self.norm1(x)
        x = x + self.attn1(h)
        if (self.attn_refview is not None and ref_mode == "read"
                and ref_hidden is not None):
            ref = ref_hidden
            if ref.shape[0] != h.shape[0]:
                # one reference row conditions every row of its group
                ref = ref.repeat_interleave(h.shape[0] // ref.shape[0], 0)
            x = x + self.ref_scale * self.attn_refview(h, context=ref)
        if self.attn_multiview is not None:
            b, t, c = h.shape
            out = self.attn_multiview(h.reshape(b // mv_views,
                                                mv_views * t, c))
            x = x + self.mva_scale * out.reshape(b, t, c)
        x = x + self.attn2(self.norm2(x), context=context)
        x = x + self.ff(self.norm3(x))
        return (x, h) if ref_mode == "write" else x


class SpatialTransformer(nn.Module):
    """diffusers `Transformer2DModel`: GN → linear proj_in → blocks →
    proj_out, + the input. With `mv_views` > 1 the views of each sample
    are one token sequence, and its context is its first view's; with
    Hunyuan's 2.5D attentions (`use_ma`, `use_ra`) the blocks are
    `Basic2p5DBlock`s and the views stay apart."""

    def __init__(self, channels: int, heads: int, dim_head: int,
                 context_dim: int, depth: int = 1, norm_groups: int = 32,
                 use_ma: bool = False, use_ra: bool = False,
                 mva_scale: float = 1.0, ref_scale: float = 1.0,
                 ip_dim: int = 0, ip_weight: float = 1.0):
        super().__init__()
        self.norm = nn.GroupNorm(norm_groups, channels, eps=1e-6)
        self.proj_in = nn.Linear(channels, channels)
        self.is_2p5d = use_ma or use_ra
        if self.is_2p5d:
            blocks = [Basic2p5DBlock(channels, heads, dim_head, context_dim,
                                     use_ma, use_ra, mva_scale, ref_scale)
                      for _ in range(depth)]
        else:
            blocks = [BasicTransformerBlock(channels, heads, dim_head,
                                            cross_attention_dim=context_dim)
                      for _ in range(depth)]
        if ip_dim > 0:
            for block in blocks:
                block.attn2 = IPCrossAttention(channels, heads, dim_head,
                                               context_dim, ip_dim,
                                               ip_weight)
        self.transformer_blocks = nn.ModuleList(blocks)
        self.proj_out = nn.Linear(channels, channels)

    def forward(self, x, context, mv_views: int = 1, ref_mode=None,
                ref_hidden=None):
        """→ the output, or (output, the list of what the blocks wrote)
        with `ref_mode="write"`; `ref_hidden` is such a list."""
        b, c, h, w = x.shape
        hid = self.norm(x).permute(0, 2, 3, 1).reshape(b, h * w, c)
        hid = self.proj_in(hid)
        # the 2.5D blocks take the views apart and fold them themselves
        kw = {"mv_views": mv_views} if self.is_2p5d else {}
        v = 1 if self.is_2p5d else mv_views
        if v > 1:
            hid = hid.reshape(b // v, v * h * w, c)
            context = context.reshape(b // v, v, *context.shape[1:])[:, 0]
        written = []
        for i, block in enumerate(self.transformer_blocks):
            if ref_mode == "write":
                hid, wr = block(hid, context=context, ref_mode=ref_mode, **kw)
                written.append(wr)
            else:
                hid = block(hid, context=context, ref_mode=ref_mode,
                            ref_hidden=None if ref_hidden is None
                            else ref_hidden[i], **kw)
        hid = self.proj_out(hid.reshape(b, h * w, c))
        out = hid.reshape(b, h, w, c).permute(0, 3, 1, 2) + x
        return (out, written) if ref_mode == "write" else out


class Downsample(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.conv = nn.Conv2d(channels, channels, 3, stride=2, padding=1)

    def forward(self, x):
        return self.conv(x)


class Upsample(nn.Module):
    """Nearest 2× (as `jax.image.resize(..., "nearest")`), then a conv."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv = nn.Conv2d(channels, channels, 3, padding=1)

    def forward(self, x):
        return self.conv(F.interpolate(x, scale_factor=2.0, mode="nearest"))


def _block(resnets, attentions=(), resample=None, kind="downsamplers"):
    """A diffusers block: `resnets`, `attentions` and `{down,up}samplers`."""
    return nn.ModuleDict({
        "resnets": nn.ModuleList(resnets),
        "attentions": nn.ModuleList(attentions),
        kind: nn.ModuleList([] if resample is None else [resample])})


class UNet2DCondition(nn.Module):
    def __init__(self, cfg: UNetConfig = UNetConfig()):
        super().__init__()
        check_config(cfg)
        self.cfg = c = cfg
        ch0 = c.block_out_channels[0]
        temb_dim = ch0 * 4
        g = c.norm_groups

        def st(ch):
            heads, dim_head = self._heads(ch)
            return SpatialTransformer(ch, heads, dim_head,
                                      c.cross_attention_dim,
                                      depth=c.transformer_depth,
                                      norm_groups=g, use_ma=c.use_ma,
                                      use_ra=c.use_ra,
                                      mva_scale=c.mva_scale,
                                      ref_scale=c.ref_scale,
                                      ip_dim=c.ip_dim,
                                      ip_weight=c.ip_weight)

        self.time_embedding = nn.ModuleDict({
            "linear_1": nn.Linear(ch0, temb_dim),
            "linear_2": nn.Linear(temb_dim, temb_dim)})
        self.conv_in = nn.Conv2d(c.in_channels, ch0, 3, padding=1)

        skip_ch = [ch0]
        cur = ch0
        down = []
        last = len(c.down_block_types) - 1
        for bi, btype in enumerate(c.down_block_types):
            out_ch = c.block_out_channels[bi]
            cross = btype.startswith("CrossAttnDownBlock")
            resnets, attns = [], []
            for _ in range(c.layers_per_block):
                resnets.append(ResnetBlock(cur, out_ch, temb_dim, g))
                cur = out_ch
                if cross:
                    attns.append(st(out_ch))
                skip_ch.append(cur)
            ds = Downsample(out_ch) if bi < last else None
            if ds is not None:
                skip_ch.append(cur)
            down.append(_block(resnets, attns, ds, "downsamplers"))
        self.down_blocks = nn.ModuleList(down)

        mid_ch = c.block_out_channels[-1]
        self.mid_block = nn.ModuleDict({
            "resnets": nn.ModuleList([
                ResnetBlock(cur, mid_ch, temb_dim, g),
                ResnetBlock(mid_ch, mid_ch, temb_dim, g)]),
            "attentions": nn.ModuleList([st(mid_ch)])})
        cur = mid_ch

        up = []
        rev = list(reversed(c.block_out_channels))
        last = len(c.up_block_types) - 1
        for bi, btype in enumerate(c.up_block_types):
            out_ch = rev[bi]
            cross = btype.startswith("CrossAttnUpBlock")
            resnets, attns = [], []
            for _ in range(c.layers_per_block + 1):
                resnets.append(ResnetBlock(cur + skip_ch.pop(), out_ch,
                                           temb_dim, g))
                cur = out_ch
                if cross:
                    attns.append(st(out_ch))
            us = Upsample(out_ch) if bi < last else None
            up.append(_block(resnets, attns, us, "upsamplers"))
        self.up_blocks = nn.ModuleList(up)

        self.conv_norm_out = nn.GroupNorm(g, ch0, eps=1e-5)
        self.conv_out = nn.Conv2d(ch0, c.out_channels, 3, padding=1)

    def _heads(self, channels: int):
        """(heads, dim_head): `attention_head_dim` < 0 is a head count (SD
        1.5), else the per-head width (SD 2.x)."""
        hd = self.cfg.attention_head_dim
        if hd < 0:
            return -hd, channels // -hd
        return channels // hd, hd

    def forward(self, sample, timesteps, encoder_hidden_states,
                class_emb=None, mv_views: Optional[int] = None,
                ref_mode=None, ref_hidden=None, down_residuals=None,
                mid_residual=None, adapter_residuals=None, pose_hook=None,
                added_text_emb=None, added_time_ids=None,
                intrablock_residuals=None):
        """sample [B, Cin, H, W]; timesteps [B]; context [B, T, D];
        class_emb [B, 4·C0] added to the time embedding (MVDream's camera);
        `mv_views` overrides the config's per call; adapter_residuals, one
        [B, C_i, H_i, W_i] per down block, are added after its first
        resnet. → [B, Cout, H, W], or
        with `ref_mode="write"` (output, written): the norm1 outputs of
        every spatial transformer's blocks, a list under `sa_{k}` for the
        k-th transformer called. `ref_mode="read"` appends `ref_hidden`
        (such a dict) to each block's self-attention keys and values."""
        for name, val, item in (
                ("down_residuals", down_residuals, "A.6.6"),
                ("mid_residual", mid_residual, "A.6.6"),
                ("pose_hook", pose_hook, "A.6.6"),
                ("added_text_emb", added_text_emb, "A.6.6"),
                ("added_time_ids", added_time_ids, "A.6.6"),
                ("intrablock_residuals", intrablock_residuals, "A.6.6")):
            if val is not None:
                raise _unported(f"UNet2DCondition's {name}", item)
        c = self.cfg
        v = c.mv_views if mv_views is None else mv_views
        ctx = encoder_hidden_states
        if ref_mode is not None and v > 1 and not (c.use_ma or c.use_ra):
            raise _unported("reference attention over a multi-view fold "
                            "(ref_mode with mv_views > 1)", "A.6.6")
        written, n_called = {}, [0]

        def attend(attn, h):
            """One spatial transformer, its entry in `written` or
            `ref_hidden` the next `sa_{k}`."""
            key = f"sa_{n_called[0]}"
            n_called[0] += 1
            if ref_mode == "write":
                h, written[key] = attn(h, ctx, v, ref_mode="write")
                return h
            return attn(h, ctx, v, ref_mode=ref_mode,
                        ref_hidden=(ref_hidden or {}).get(key))

        te = self.time_embedding
        temb = timestep_embedding(timesteps, c.block_out_channels[0])
        temb = te["linear_2"](F.silu(te["linear_1"](temb)))
        if class_emb is not None:
            temb = temb + class_emb

        h = self.conv_in(sample)
        skips = [h]
        for bi, block in enumerate(self.down_blocks):
            attns = block["attentions"]
            for li, res in enumerate(block["resnets"]):
                h = res(h, temb)
                if adapter_residuals is not None and li == 0:
                    h = h + adapter_residuals[bi]
                if len(attns):
                    h = attend(attns[li], h)
                skips.append(h)
            for ds in block["downsamplers"]:
                h = ds(h)
                skips.append(h)

        mid = self.mid_block
        h = mid["resnets"][0](h, temb)
        h = attend(mid["attentions"][0], h)
        h = mid["resnets"][1](h, temb)

        for block in self.up_blocks:
            attns = block["attentions"]
            for li, res in enumerate(block["resnets"]):
                h = res(torch.cat([h, skips.pop()], dim=1), temb)
                if len(attns):
                    h = attend(attns[li], h)
            for us in block["upsamplers"]:
                h = us(h)

        out = self.conv_out(F.silu(self.conv_norm_out(h)))
        return (out, written) if ref_mode == "write" else out
