"""Multi-resolution hash-grid positional encoding (Instant-NGP style).

Port of `comfy3d_tpu/ops/hashgrid.py`: a [L, T, F] feature table, one level
per resolution `floor(base · g^l)`; a level whose dense lattice fits the
table is indexed densely (collision-free), the others through the
spiral-prime hash (π = 1, 2654435761, 805459861), and each point blends its
8 corners trilinearly.

The levels are stacked: every corner index carries its level's offset into
the table viewed as [L·T, F], so a call gathers all levels' corners with one
`index_select` (instead of one gather per level), and its gradient is one
`index_add_` into the table (atomic adds on the card, so the gradient's last
bits vary from run to run, as those of the compositor backwards do). The JAX
package multiplies `uint32`s with wrap-around; PyTorch has no such
arithmetic, so the hash is computed in int64, masked to 32 bits after each
product, and only then reduced modulo the table size.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

_PRIMES = (1, 2654435761, 805459861)
_MASK32 = 0xFFFFFFFF


@dataclasses.dataclass(frozen=True)
class HashGridConfig:
    num_levels: int = 16
    features_per_level: int = 2
    log2_table_size: int = 19
    base_resolution: int = 16
    max_resolution: int = 2048

    @property
    def table_size(self) -> int:
        return 1 << self.log2_table_size

    @property
    def output_dim(self) -> int:
        return self.num_levels * self.features_per_level

    def resolutions(self) -> np.ndarray:
        """Per-level resolutions, computed in float64 numpy and floored, as
        the JAX package does (in float32 a level can land one below)."""
        if self.num_levels == 1:
            return np.array([self.base_resolution])
        g = np.exp((np.log(self.max_resolution)
                    - np.log(self.base_resolution)) / (self.num_levels - 1))
        return np.floor(self.base_resolution
                        * g ** np.arange(self.num_levels)).astype(np.int64)

    def dense_levels(self) -> np.ndarray:
        """[L] bool: the levels whose (res+1)³ lattice fits the table."""
        return (self.resolutions() + 1) ** 3 <= self.table_size


def init_params(config: HashGridConfig, generator: torch.Generator,
                scale: float = 1e-4, device=None) -> torch.Tensor:
    """[L, T, F] feature table, uniform ±scale (the Instant-NGP init), drawn
    from `generator` on its device and moved to `device`."""
    u = torch.rand((config.num_levels, config.table_size,
                    config.features_per_level), generator=generator,
                   device=generator.device)
    return (u * (2.0 * scale) - scale).to(device or generator.device)


def _corners(a, combine):
    """Per-axis terms a [N, L, 2, 3] (offset 0 or 1 on each axis) → their
    combination for the 8 corners, [N, L, 8], x-major: corner i·4 + j·2 + k
    has offsets (i, j, k), the JAX package's meshgrid order."""
    x, y, z = a[..., 0], a[..., 1], a[..., 2]
    out = combine(combine(x[..., :, None, None], y[..., None, :, None]),
                  z[..., None, None, :])
    return out.reshape(out.shape[:2] + (8,))


def _run(levels: np.ndarray) -> slice:
    """The levels of a mask as one slice: the resolutions are monotonic, so
    the dense levels are a prefix or a suffix, and so are the others."""
    idx = np.flatnonzero(levels)
    return slice(int(idx[0]), int(idx[-1]) + 1)


def corner_indices(x: torch.Tensor, config: HashGridConfig):
    """x [N, 3] in [0, 1]³ → (rows [N, L, 8] int64 into the [L·T, F]
    table, trilinear weights [N, L, 8]).

    The corner coordinates (clipped to the lattice), their products with
    the hash primes and the 1 − t / t weights are formed per axis ([N, L,
    2, 3]) and combined over the 8 corners once: the same integers as the
    JAX package's `_hash_corner` (dense: (c0·(r+1) + c1)·(r+1) + c2;
    hashed: c0·π1 ⊕ c1·π2 ⊕ c2·π3 mod 2³², mod T) and the same weight
    products, (w_x · w_y) · w_z."""
    dev = x.device
    dense = config.dense_levels()
    res = torch.as_tensor(config.resolutions(), device=dev)
    xl = x.clamp(0.0, 1.0)[:, None, :] * res.float()[:, None]   # [N, L, 3]
    x0 = torch.floor(xl)
    frac = xl - x0
    x0 = x0.long()
    c = torch.stack([x0, torch.minimum(x0 + 1, res[:, None])], -2)
    rows = torch.empty(x.shape[0], config.num_levels, 8, dtype=torch.long,
                       device=dev)
    if dense.any():
        lv = _run(dense)
        r1 = res[lv] + 1
        # (c0·(r+1) + c1)·(r+1) + c2 = c0·(r+1)² + c1·(r+1) + c2, < T
        scale = torch.stack([r1 * r1, r1, torch.ones_like(r1)], -1)
        rows[:, lv] = _corners(c[:, lv] * scale[:, None, :], torch.add)
    if not dense.all():
        lv = _run(~dense)
        h = (c[:, lv] * torch.tensor(_PRIMES, device=dev)) & _MASK32
        # T is a power of two: the remainder is the low bits
        rows[:, lv] = _corners(h, torch.bitwise_xor) \
            & (config.table_size - 1)
    rows += torch.arange(config.num_levels,
                         device=dev)[:, None] * config.table_size
    w = _corners(torch.stack([1.0 - frac, frac], -2), torch.mul)
    return rows, w


def encode(table: torch.Tensor, x: torch.Tensor,
           config: HashGridConfig) -> torch.Tensor:
    """x [N, 3] in [0, 1]³ → [N, L·F] features, level-major; differentiable
    with respect to `table` [L, T, F]."""
    n = x.shape[0]
    rows, w = corner_indices(x, config)
    feats = table.reshape(-1, config.features_per_level).index_select(
        0, rows.reshape(-1)).reshape(n, config.num_levels, 8,
                                     config.features_per_level)
    return (feats * w[..., None]).sum(2).reshape(n, config.output_dim)


def total_variation_loss(table: torch.Tensor, config: HashGridConfig,
                         samples: torch.Tensor) -> torch.Tensor:
    """Stochastic TV regularizer of the encoded field at `samples` [S, 3]
    in [0, 1]³ (the JAX package draws 4,096 uniform ones per call): the
    squared difference to the encoding one finest cell away, summed over
    the three axes, each a mean. The four point sets go through one
    `encode`."""
    eps = torch.eye(3, device=samples.device) * (1.0 / config.max_resolution)
    pts = torch.cat([samples] + [(samples + eps[d]).clamp(0.0, 1.0)
                                 for d in range(3)])
    f0, *fd = encode(table, pts, config).chunk(4)
    tv = 0.0
    for f in fd:
        tv = tv + ((f - f0) ** 2).mean()
    return tv
