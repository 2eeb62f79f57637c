"""Empirical noise pool: loading, validation and injection.

Counterpart of the parts of `kmsr_tpu.data.noise_pool` the factory route
uses: `add_noise_np` (`E_make_train_data.py:65-74` parity: add one random
pool entry) and the pool contract [N, C, h, w] float32 that
`make_train_data.py:60-62` enforces. Pool building (`build_noise_pool`)
comes with the denoise slice (ROADMAP.md).
"""
from __future__ import annotations

import numpy as np


def validate_noise_pool(pool: np.ndarray) -> np.ndarray:
    """The pool as float32, after checking it is [N, C, h, w] with N >= 1."""
    pool = np.asarray(pool, np.float32)
    if pool.ndim != 4:
        raise ValueError(f"noise pool must be [N,C,h,w], got {pool.shape}")
    if pool.shape[0] < 1:
        raise ValueError("noise pool is empty")
    return pool


def load_noise_pool(path: str) -> np.ndarray:
    """Load and validate a noise pool `.npy` ([N, C, h, w])."""
    return validate_noise_pool(np.load(path))


def add_noise_np(
    rng: np.random.Generator, blurred: np.ndarray, pool: np.ndarray
) -> np.ndarray:
    """lr = blurred + one random pool entry (`E_make_train_data.py:65-74`)."""
    idx = rng.integers(0, pool.shape[0])
    return blurred + pool[idx]
