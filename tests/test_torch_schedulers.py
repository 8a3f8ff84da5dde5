"""Port parity, the samplers of the registry beside DDIM (`models/diffusion/
schedulers.py`): each one's tables, `init_sigma`, `scale_model_input`,
`add_noise` and a five-step loop (KDPM2's nine evaluations with their
`aux`) driven by a fixed linear `denoise_fn`, `comfy3d_tpu_torch` against
`comfy3d_tpu`, the stochastic samplers' noise replayed from the JAX
package's `sample_loop` keys (`fold_in(key, i)`)."""

import pytest

# CPU parity tier of the port; kept out of the smoke manifest
pytestmark = [pytest.mark.heavy, pytest.mark.usefixtures("one_torch_thread")]

import jax
import jax.numpy as jnp
import numpy as np
import torch

from comfy3d_tpu.models.diffusion import schedulers as js

from comfy3d_tpu_torch.models.diffusion import schedulers as ts

from tests.test_torch_common import (QUICK_XLA, _np,
                                     one_torch_thread)  # noqa: F401

# against the JAX package: within this share of the largest value
REL = 1e-5
STEPS = 5
SHAPE = (2, 6, 6, 4)             # NHWC, as the JAX package draws its noise
KEY = 7
# (name, scheduler config): ε-prediction with leading spacing and
# v-prediction with trailing spacing (Zero123Plus's) both appear
CASES = [
    ("EulerAncestralDiscreteScheduler",
     dict(prediction_type="v_prediction", timestep_spacing="trailing")),
    ("DDPMScheduler", dict()),
    ("DDIMParallelScheduler",
     dict(prediction_type="v_prediction", timestep_spacing="trailing")),
    ("EulerDiscreteScheduler", dict()),
    ("LCMScheduler",
     dict(prediction_type="v_prediction", timestep_spacing="trailing")),
    ("KDPM2DiscreteScheduler", dict()),
    ("KDPM2AncestralDiscreteScheduler",
     dict(prediction_type="v_prediction", timestep_spacing="trailing")),
]


def _close(out, ref, what=""):
    out, ref = _np(out), np.asarray(ref)
    assert out.shape == ref.shape, (what, out.shape, ref.shape)
    err = np.abs(out - ref).max()
    assert err <= REL * max(np.abs(ref).max(), 1e-30), (what, err)


def nchw(a):
    return torch.as_tensor(np.array(a)).permute(0, 3, 1, 2)


def denoise(x_in, i, t):
    return 0.1 * x_in + 0.05 * i + 1e-4 * t


@pytest.mark.parametrize("name,kw", CASES, ids=[c[0] for c in CASES])
def test_sampler_matches_jax(name, kw):
    jsched = js.make_scheduler(name, js.SchedulerConfig(**kw), STEPS)
    sched = ts.make_scheduler(name, ts.SchedulerConfig(**kw), STEPS)
    assert type(sched).__name__ == type(jsched).__name__
    assert sched.loop_steps == jsched.loop_steps
    np.testing.assert_array_equal(sched.timesteps,
                                  np.asarray(jsched.timesteps))
    for table in ("alphas", "sigmas", "eval_sigmas", "sigmas_interp",
                  "sigmas_down", "sigmas_up"):
        if hasattr(jsched, table):
            np.testing.assert_array_equal(_np(getattr(sched, table)),
                                          np.asarray(getattr(jsched, table)),
                                          err_msg=table)

    rng = np.random.RandomState(0)
    x = rng.randn(*SHAPE).astype(np.float32)
    noise = rng.randn(*SHAPE).astype(np.float32)
    key = jax.random.PRNGKey(KEY)
    n = sched.loop_steps

    def refs(x, noise):
        return (jsched.init_sigma,
                [jsched.scale_model_input(x, i) for i in (0, n - 1)],
                [jsched.add_noise(x, noise, i) for i in (0, n - 1)],
                [jax.random.normal(jax.random.fold_in(key, i), SHAPE)
                 for i in range(n)],
                js.sample_loop(jsched, denoise, x, key=key))

    init_sigma, scaled, noised, draws, ref = jax.jit(
        refs, compiler_options=QUICK_XLA)(x, noise)
    _close(torch.as_tensor(sched.init_sigma), init_sigma, "init_sigma")
    for k, i in enumerate((0, n - 1)):
        _close(sched.scale_model_input(nchw(x), i), nchw(scaled[k]),
               f"scale_model_input {i}")
        _close(sched.add_noise(nchw(x), nchw(noise), i), nchw(noised[k]),
               f"add_noise {i}")

    calls = []

    def replay(i):
        calls.append(i)
        return nchw(draws[i])

    out = ts.sample_loop(sched, denoise, nchw(x), noise=replay)
    _close(out, nchw(ref), "loop")
    assert calls == (list(range(n)) if sched.stochastic else [])
    assert np.abs(_np(out) - np.asarray(nchw(x))).max() > 1e-3

    if name == "DDIMParallelScheduler":
        # ParaDiGMS's batched step: three (output, index, sample) triples
        idx = np.array([0, 2, 4])
        outs = rng.randn(3, *SHAPE).astype(np.float32)
        samples = rng.randn(3, *SHAPE).astype(np.float32)
        jb = jsched.batch_step(jnp.asarray(outs), jnp.asarray(idx),
                               jnp.asarray(samples))
        b = sched.batch_step(torch.as_tensor(outs).permute(0, 1, 4, 2, 3),
                             idx, torch.as_tensor(samples).permute(
                                 0, 1, 4, 2, 3))
        _close(b.permute(0, 1, 3, 4, 2), jb, "batch_step")
