"""JAX's random draws, served to the port's draw hooks.

The port's trainers draw from a `torch.Generator` through a few module
functions (`train.state.batch_indices`, the trainers' `random_crops`,
`models.moe.gumbel_uniform`, `standard_normal`). `JaxDraws` stands in for
them and returns, call by call, what the JAX step draws from its key chain
(`kmsr_tpu/train/{moe,dynamic}.py`, `kmsr_tpu/train/state.py:make_chunk_step`):

* a K-step chunk splits the state key into (rng, k_hr, k_cr) and draws the
  HR batch's indices, then the real-crop batch's;
* a step splits the state key into (rng, k_crop, *forward keys): MoE has
  two forwards (D step, G step), each splitting its key into
  (k_gumbel, k_noise); the dynamic step has one noise key, shared by D and
  G.

So the port's trainer, run with these hooks, sees JAX's draws in JAX's
order.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import torch

from kmsr_tpu.train import single_kernel as jsk


def _torch(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


class JaxDraws:
    def __init__(self, key, n_forward_keys: int):
        self.key = key
        self.n_fwd = n_forward_keys
        self._idx: list = []
        self._fwd: list = []
        self._noise_key = None

    def batch_indices(self, gen, n_pool, batch_size, device):
        if not self._idx:
            rng, k_hr, k_cr = jax.random.split(self.key, 3)
            self.key = rng
            self._idx = [jax.random.randint(k, (batch_size,), 0, n_pool) for k in (k_hr, k_cr)]
        return _torch(self._idx.pop(0)).long()

    def random_crops(self, gen, src, crop):
        keys = jax.random.split(self.key, 2 + self.n_fwd)
        self.key, k_crop = keys[0], keys[1]
        self._fwd = list(keys[2:])
        return _torch(jsk.random_crops(k_crop, jnp.asarray(src.detach().numpy()), crop))

    def gumbel_uniform(self, gen, shape, device):
        k_gumbel, self._noise_key = jax.random.split(self._fwd.pop(0))
        return _torch(jax.random.uniform(k_gumbel, tuple(shape), minval=1e-10, maxval=1.0))

    def standard_normal(self, gen, like):
        key = self._noise_key if self._noise_key is not None else self._fwd.pop(0)
        self._noise_key = None
        return _torch(jax.random.normal(key, tuple(like.shape)))

    def install(self, monkeypatch, *modules):
        """Route the hooks of the port's modules given (those that define or
        import them) to this object."""
        for mod in modules:
            for name in ("batch_indices", "random_crops", "gumbel_uniform",
                         "standard_normal"):
                if hasattr(mod, name):
                    monkeypatch.setattr(mod, name, getattr(self, name))
