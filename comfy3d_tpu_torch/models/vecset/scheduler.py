"""Flow-matching Euler schedule of the vecset families.

Port of `comfy3d_tpu/models/vecset/scheduler.py`: the sigmas are
linspace(0, 1, N) through the static shift map σ' = s·σ / (1 + (s−1)·σ)
with a final 1.0 appended, the model sees t = σ, and the Euler step is
x ← x + (σ_{i+1} − σ_i)·v. Noise sits at σ = 0 in this convention. The
sigmas are computed in float64 numpy and rounded to float32 once, as the
JAX package does.
"""

from __future__ import annotations

import numpy as np


def flow_match_sigmas(num_steps: int, shift: float = 1.0) -> np.ndarray:
    """[num_steps + 1] float32 sigmas (σ_0 = 0 … σ_N = 1).

    σ_{N−1} is already 1, so the last step's dt is 0: the N-th model call
    moves nothing (kept, so the step count matches the JAX package)."""
    s = np.linspace(0.0, 1.0, num_steps, dtype=np.float64)
    s = shift * s / (1.0 + (shift - 1.0) * s)
    return np.concatenate([s, [1.0]]).astype(np.float32)


def flow_match_step(x, velocity, sigma, sigma_next):
    return x + (sigma_next - sigma) * velocity


def add_noise(sample, noise, sigma):
    """σ·noise + (1 − σ)·sample."""
    return sigma * noise + (1.0 - sigma) * sample
